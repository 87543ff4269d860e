"""NN building blocks as plain parameter dictionaries: the dense layer, the
norms, RoPE, GQA attention (chunked online softmax), the dense FFN
variants and the capacity-bounded MoE layer, with the sigmoid and SiLU the
GNNs share.

``*_init(gen, ...) -> params`` draws from a ``torch.Generator`` on its own
device; the apply functions take those dicts. ``lead`` prepends axes to
every leaf: the transformer draws its layers as one stack of ``L``, the
layout of the JAX package's vmapped init.

float32 products stay full float32 on the card: PyTorch leaves TF32 off for
matrix products by default (``torch.backends.cuda.matmul.allow_tf32`` is
False), and the port does not turn it on. MIND calls ``dense`` in float32,
so its scores can be held to the JAX package's float32 results at 1e-5,
and the LM head is a float32 product as there.

The elementwise functions that run in bfloat16 (``sigmoid``, ``silu``,
``gelu``) round every step to bfloat16, the form XLA expands them to on
the CPU, so the two packages agree in bfloat16 and not only in float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import constrain, local_attention, local_decode


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """float32 Normal(0, ``scale``) drawn from ``gen`` on its device (scaled
    in place: a full-width stack of layers is most of the card)."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(float(scale))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None,
               lead: tuple = ()):
    """Normal(0, ``scale``) weights, ``scale`` = 1/sqrt(d_in) by default,
    drawn from ``gen`` on its device."""
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    return {"w": normal(gen, lead + (d_in, d_out), scale)}


def dense(params, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w`` over the last axis, both cast to ``compute_dtype`` first."""
    return torch.matmul(x.to(compute_dtype), params["w"].to(compute_dtype))


def rmsnorm_init(d: int, lead: tuple = ()):
    return {"g": torch.ones(lead + (d,), dtype=torch.float32)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis in float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["g"]).to(x.dtype)


def layernorm_init(d: int, lead: tuple = ()):
    return {"g": torch.ones(lead + (d,), dtype=torch.float32),
            "b": torch.zeros(lead + (d,), dtype=torch.float32)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in float32 (population variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * params["g"] + params["b"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).

    The interleaved layout: the pairs are ``x[..., 0::2]`` and
    ``x[..., 1::2]``, rotated and interleaved back (not the half-split
    layout of other libraries). The angles are float32; a bfloat16 ``x``
    is promoted by the products and the result cast back."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA), memory-efficient online softmax over KV chunks
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    # (B, S, KV, hd) -> (B, S, KV*groups, hd)
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, kv * groups, hd)


def _chunks(n: int, chunk: int, what: str) -> tuple[int, int]:
    """``(count, size)`` of the JAX package's chunking: ``max(n // chunk,
    1)`` chunks of ``n // count``; a length they do not tile raises (the
    reference's reshape fails there too)."""
    count = max(n // chunk, 1)
    size = n // count
    if count * size != n:
        raise ValueError(f"{what} length {n} is not {count} chunks of {size}")
    return count, size


def _decode(q, k, v, kpos, causal: bool, q_offset: int, kv_len: Optional[int],
            softmax=None) -> torch.Tensor:
    """Decode attention (``Sq == 1``) against keys at positions ``kpos``:
    grouped products over the whole cache (KV is not repeated to H
    heads), the masks as ``-inf``, a float32 softmax over the keys
    (``softmax``, default ``torch.softmax`` over the last dim)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.unflatten(2, (kvh, h // kvh))
    s = torch.einsum("bqngd,bknd->bngqk", qg, k).to(torch.float32) * float(1.0 / np.sqrt(hd))
    if kv_len is not None:
        s = s.masked_fill(kpos >= kv_len, -torch.inf)
    if causal:
        s = s.masked_fill(kpos > q_offset, -torch.inf)
    p = torch.softmax(s, dim=-1) if softmax is None else softmax(s)
    out = torch.einsum("bngqk,bknd->bqngd", p.to(q.dtype), v)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    kv_chunk: int = 1024,
    q_chunk: int = 512,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention, as the JAX package's ``attention``.

    Decode (``Sq == 1``): grouped products over the whole cache (KV is not
    repeated to H heads), the masks as ``-inf``, a float32 softmax.

    Prefill: repeated-KV heads and an online softmax over ``kv_chunk`` keys
    inside ``q_chunk`` query blocks, with float32 ``m``/``l``/``acc`` and
    ``p`` cast to the input dtype before the PV product. The KV chunks run
    in order: chunk 0 holds position 0, so ``m`` is finite before a fully
    masked chunk could come. Under ``causal``, a chunk that lies wholly
    after a block's last query is left out: there every score is ``-inf``,
    so its step would keep ``m``, multiply ``l`` and ``acc`` by exactly 1
    and add exactly 0, and leaving it out changes no bit.

    ``q_offset`` is the absolute position of q[0]; ``kv_len`` masks the
    valid cache prefix."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    groups = h // kvh
    scale = float(1.0 / np.sqrt(hd))
    dev = q.device

    if sq == 1:
        if isinstance(q, DTensor):
            # on a mesh each device attends its rows against its block of
            # the cache, the softmax taken across the devices that split the
            # keys (dist.sharding.local_decode)
            return local_decode(_decode, q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len)
        return _decode(q, k, v, torch.arange(sk, device=dev), causal=causal, q_offset=q_offset,
                       kv_len=kv_len)

    if isinstance(q, DTensor):
        # on a mesh each device attends its own batch rows and heads, the
        # repeated KV heads split as q's (dist.sharding.local_attention)
        return local_attention(attention, q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                               causal=causal, q_offset=q_offset, kv_chunk=kv_chunk,
                               q_chunk=q_chunk, kv_len=kv_len)
    n_kv, kv_chunk = _chunks(sk, kv_chunk, "key")
    n_q, q_chunk = _chunks(sq, q_chunk, "query")
    kh = _repeat_kv(k, groups).transpose(1, 2)  # (B, H, Sk, hd)
    vh = _repeat_kv(v, groups).transpose(1, 2)
    qh = q.transpose(1, 2)                      # (B, H, Sq, hd)
    outs = []
    for qi in range(n_q):
        qb = qh[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        qpos = torch.arange(q_lo, q_hi + 1, device=dev)
        m = torch.full((b, h, q_chunk), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=dev)
        for ki in range(n_kv):
            k_lo = ki * kv_chunk
            if causal and k_lo > q_hi:
                break  # this chunk and every later one are wholly masked
            kc = kh[:, :, k_lo:k_lo + kv_chunk]
            vc = vh[:, :, k_lo:k_lo + kv_chunk]
            s = torch.matmul(qb, kc.transpose(-1, -2)).to(torch.float32) * scale
            kpos = torch.arange(k_lo, k_lo + kv_chunk, device=dev)
            if causal and k_lo + kv_chunk - 1 > q_lo:
                s = s.masked_fill(qpos[:, None] < kpos[None, :], -torch.inf)
            if kv_len is not None:
                s = s.masked_fill(kpos >= kv_len, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p.to(q.dtype), vc).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))  # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


def gqa_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             lead: tuple = ()):
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, lead=lead),
        "wk": dense_init(gen, d_model, n_kv * head_dim, lead=lead),
        "wv": dense_init(gen, d_model, n_kv * head_dim, lead=lead),
        "wo": dense_init(gen, n_heads * head_dim, d_model, lead=lead),
    }


# ---------------------------------------------------------------------------
# Activations and FFN variants
# ---------------------------------------------------------------------------
class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``) as the JAX package computes it
    on the CPU, value and gradient. The value: in float32 as
    ``torch.sigmoid`` (to an ulp); in bfloat16 as ``1 / (1 + exp(-x))``
    with every step rounded to bfloat16, the form XLA expands it to there
    (``torch.sigmoid`` rounds once and differs in a third of the values).
    The gradient: ``g * (s * (1 - s))`` in the value's dtype, ``lax.logistic``'s
    own rule (torch's rounds as ``g * (1 - s) * s``, which in bfloat16
    moves NequIP's gradients by percents)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x)) if x.dtype == torch.bfloat16 else torch.sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)`` (``F.silu`` rounds differently)."""
    return x * sigmoid(x)


_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``, whose default is the tanh approximation, step by
    step in ``x``'s dtype as XLA computes it: in bfloat16 this matches the
    JAX package in all but 0.25% of values (tanh's last bit), where
    ``F.gelu(approximate="tanh")``, which rounds once, differs in 43%."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


ACTS = {
    "gelu": gelu,
    "silu": silu,
    "relu2": squared_relu,
    "relu": F.relu,
}


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, lead: tuple = ()):
    p = {
        "wi": dense_init(gen, d_model, d_ff, lead=lead),
        "wo": dense_init(gen, d_ff, d_model, lead=lead),
    }
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, lead=lead)
    return p


def tp(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, F) activation between a column- and a row-parallel product
    in Megatron's layout on a mesh (batch over the data axes, F over
    model), its gradient too; identity off a mesh."""
    return constrain(x, ("pod", "data"), None, "model")


def ffn(params, x: torch.Tensor, act: str = "gelu",
        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    h = ACTS[act](tp(dense(params["wi"], x, compute_dtype)))
    if "wg" in params:
        h = h * tp(dense(params["wg"], x, compute_dtype))
    return dense(params["wo"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Mixture-of-Experts: capacity-bounded scatter dispatch
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, gated: bool,
             lead: tuple = ()):
    e = lead + (n_experts,)
    p = {
        "router": dense_init(gen, d_model, n_experts, scale=0.02, lead=lead),
        "wi": normal(gen, e + (d_model, d_ff), 1.0 / np.sqrt(d_model)),
        "wo": normal(gen, e + (d_ff, d_model), 1.0 / np.sqrt(d_ff)),
    }
    if gated:
        p["wg"] = normal(gen, e + (d_model, d_ff), 1.0 / np.sqrt(d_model))
    return p


def top_k_experts(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest, and among
    equal values the lower index first (``torch.topk`` does not promise an
    order for ties, and on the CPU returns [2, 3] for four equal values
    where ``lax.top_k`` returns [0, 1]); a stable sort keeps it."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(
    params,
    x: torch.Tensor,  # (T, d)
    top_k: int,
    act: str = "silu",
    capacity_factor: float = 1.25,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Top-k token-choice MoE with capacity-bounded scatter dispatch.

    Returns ``(out, aux_loss)``. Each expert takes ``ceil(T*k/E*cf)``
    tokens; picks past that are dropped (GShard semantics), in token order.
    The aux loss is Switch's ``E * sum_e f_e * p_e``. On a mesh (DTensor
    tokens) by ``_moe_on_mesh``."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(params, x, top_k, act, capacity_factor, compute_dtype)
    probs, gate_vals, expert_idx = _moe_route(params, x, top_k)
    return _moe_experts(params, x, probs, gate_vals, expert_idx, act, capacity_factor,
                        compute_dtype)


def _moe_route(params, x: torch.Tensor, top_k: int):
    """The router's probabilities and each token's ``top_k`` experts with
    their renormalised gates."""
    logits = dense(params["router"], x, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_experts(probs, top_k)  # (T, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _moe_experts(params, x: torch.Tensor, probs, gate_vals, expert_idx, act: str,
                 capacity_factor: float, compute_dtype: torch.dtype):
    """The dispatch into the experts' capacity buffer, their products, the
    gated combine and the aux loss."""
    t, d = x.shape
    e, top_k = probs.shape[1], expert_idx.shape[1]
    cap = int(np.ceil(t * top_k / e * capacity_factor))
    flat_e, onehot, ranks = _moe_ranks(expert_idx, e)
    out = _moe_slots(params, x, gate_vals, flat_e, ranks, cap, 0, cap, act, compute_dtype)
    return out.to(x.dtype), _moe_aux(probs, onehot, t * top_k)


def _moe_ranks(expert_idx: torch.Tensor, e: int):
    """Each (token, k) pick's expert, the picks' one-hot rows, and each
    pick's slot within its expert: its rank among the earlier picks of the
    same expert (exact integers, so one flat cumsum gives the JAX
    package's chunked ranks)."""
    flat_e = expert_idx.reshape(-1)  # (T*k,)
    onehot = F.one_hot(flat_e, e)
    ranks = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]
    return flat_e, onehot, ranks


def _moe_slots(params, x: torch.Tensor, gate_vals, flat_e, ranks, cap: int, lo: int,
               width: int, act: str, compute_dtype: torch.dtype) -> torch.Tensor:
    """The picks whose slot lies in ``[lo, lo + width)`` of their expert's
    ``cap`` (all of them with ``lo = 0, width = cap``) through the experts:
    dispatched into an (E, width, d) buffer, multiplied, gated and summed
    into (T, d) per token; every other pick adds 0."""
    t, d = x.shape
    e, top_k = params["wi"].shape[0], gate_vals.shape[1]
    keep = (ranks >= lo) & (ranks < min(lo + width, cap))
    slot = torch.where(keep, flat_e * width + ranks - lo, e * width)  # e*width: sentinel row

    # scatter the picks into an (E*width + 1, d) buffer. Kept picks have
    # distinct slots; only dropped ones share the sentinel row, which is cut
    # off before the products, so the order in which the card resolves
    # duplicate writes (index_put_ does not fix one) cannot reach the output
    xk = torch.repeat_interleave(x, top_k, dim=0)  # (T*k, d)
    buf = x.new_zeros((e * width + 1, d))
    buf[slot] = xk
    buf = buf[: e * width].reshape(e, width, d).to(compute_dtype)

    h = ACTS[act](torch.bmm(buf, params["wi"].to(compute_dtype)))
    if "wg" in params:
        h = h * torch.bmm(buf, params["wg"].to(compute_dtype))
    y = torch.bmm(h, params["wo"].to(compute_dtype))  # (E, width, d)

    y_flat = y.reshape(e * width, d)
    gathered = torch.where(keep[:, None], y_flat[torch.clamp_max(slot, e * width - 1)], 0.0)
    return (gathered * gate_vals.reshape(-1)[:, None].to(gathered.dtype)).reshape(
        t, top_k, d).sum(dim=1)


def _moe_aux(probs, onehot, picks: int):
    """Switch's load-balancing loss ``E * sum_e f_e * p_e``."""
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=0).to(torch.float32) / picks  # each expert's picks
    return probs.shape[1] * torch.sum(me * ce)


def _moe_on_mesh(params, x: DTensor, top_k: int, act: str, capacity_factor: float,
                 compute_dtype: torch.dtype):
    """``moe`` over DTensor tokens, by a local rule. The capacity and each
    pick's slot are counted over all tokens, as on one device, so every
    device takes all tokens (gathered over the mesh) and routes them. The
    experts' work is split, not repeated: the capacity over the batch axes
    ("pod", "data"; each device takes a contiguous block of every expert's
    slots, ``_moe_slots``) and the experts' hidden dim over "model" (the
    tensor-parallel split of ``wi``/``wg`` dim 2 and ``wo`` dim 1). Each
    device's output is then a partial sum over both, reduced to ``x``'s
    placements. The token gather, the router, the slot ranks and the aux
    loss repeat on every device: (T, d) and (T*k, E) work against the
    experts' (E, cap, d) x d_ff."""
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    xr = x.redistribute(mesh, rep)
    router = {"router": {"w": params["router"]["w"].redistribute(mesh, rep)}}
    probs, gate_vals, expert_idx = _moe_route(router, xr, top_k)
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    bdims = [i for i, a in enumerate(names) if a in ("pod", "data")]
    cut = tuple(isinstance(p, Shard) and p.dim == 2 for p in params["wi"].placements)
    want = {"wi": 2, "wg": 2, "wo": 1}
    local = {}
    for k, dim in want.items():
        if k in params:
            w = params[k]
            pl = tuple(Shard(dim) if c else Replicate() for c in cut)
            # each device's slots give the weights a partial gradient over
            # the batch axes
            grad_pl = tuple(Partial() if i in bdims and not c else p
                            for i, (c, p) in enumerate(zip(cut, pl)))
            local[k] = (w.redistribute(mesh, pl) if tuple(w.placements) != pl else w).to_local(
                grad_placements=grad_pl)
    # this device's block of the capacity: its index over the batch axes
    n, idx = 1, 0
    for i in bdims:  # major to minor
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    t = xr.shape[0]
    e = probs.shape[1]
    cap = int(np.ceil(t * top_k / e * capacity_factor))
    width = -(-cap // n)
    # x and the gates get partial gradients over both splits (the aux loss,
    # the same on every device, gives probs a replicated one)
    part = tuple(Partial() if c or i in bdims else Replicate() for i, c in enumerate(cut))
    flat_e, onehot, ranks = _moe_ranks(expert_idx.to_local(), e)
    out = _moe_slots(local, xr.to_local(grad_placements=part),
                     gate_vals.to_local(grad_placements=part), flat_e, ranks, cap, idx * width,
                     width, act, compute_dtype)
    aux = _moe_aux(probs.to_local(), onehot, t * top_k)
    out = DTensor.from_local(out.to(x.dtype), mesh, part, run_check=False)
    return out.redistribute(mesh, x.placements), DTensor.from_local(aux, mesh, rep,
                                                                    run_check=False)
