"""Decoder-only transformer LM (dense and MoE), GQA + RoPE, with KV-cache
serving.

Parameters are the JAX package's tree: ``embed`` (V, d), ``layers`` (each
per-layer leaf stacked on a leading ``L`` axis), ``ln_f`` and
``lm_head``, so ``train.tree``'s flatten order and
``train.checkpoint.restore`` read it as they read the JAX package's. The
layers run in a Python loop over ``L``: the JAX package scans them. Its
``remat`` and ``layer_groups`` become ``torch.utils.checkpoint`` around
each layer or group of layers, and its ``jax.checkpoint`` around each loss
chunk the same around each chunk: they only shape the backward, changing
no value. Its ``constrain`` calls are sharding hints that do nothing on
one device; the port leaves them out.

Entry points:
  init(gen, cfg, device=)                -> params
  forward(params, cfg, tokens)           -> (logits, aux loss)
  loss_fn(params, cfg, batch)            -> scalar loss
  prefill(params, cfg, tokens, max_len)  -> (last logits, KVCache)
  decode_step(params, cfg, cache, token) -> (logits, KVCache)
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import devices
from repro_torch.configs.base import LMConfig
from repro_torch.nn import layers as L
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def _norm_init(cfg: LMConfig, d: int, lead: tuple = ()):
    return L.rmsnorm_init(d, lead) if cfg.norm == "rmsnorm" else L.layernorm_init(d, lead)


def _norm(cfg: LMConfig, p, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def init_layer(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()):
    """One layer's parameters, or with ``lead = (L,)`` a stack of ``L``
    drawn leaf by leaf; weights on ``gen``'s device, norms on the CPU."""
    p = {
        "attn": L.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, lead),
        "ln1": _norm_init(cfg, cfg.d_model, lead),
        "ln2": _norm_init(cfg, cfg.d_model, lead),
    }
    if cfg.moe:
        p["moe"] = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.gated, lead)
    else:
        p["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.gated, lead)
    return p


def init(gen: torch.Generator, cfg: LMConfig,
         device: str | torch.device = devices.DEFAULT_DEVICE):
    """Random parameters drawn from ``gen`` on its own device and placed on
    ``device``: the JAX package's tree, shapes, dtypes (float32) and
    scales, not its bits."""
    dev = devices.resolve(device)
    p = {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), 0.02),
        "layers": init_layer(gen, cfg, (cfg.n_layers,)),
        "ln_f": _norm_init(cfg, cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02),
    }
    return to_device(p, dev)


def to_device(params, device: torch.device):
    return tree_map(lambda t: t.to(device), params)


def layer_params(params, i: int):
    """Layer ``i``'s parameters: a view of row ``i`` of each stacked leaf."""
    return tree_map(lambda a: a[i], params["layers"])


def unbind_layers(params) -> list:
    """Every layer's parameters, from one ``torch.unbind`` of each stacked
    leaf: its backward is one ``stack``, where ``a[i]`` for each layer would
    allocate a zero tensor the size of the whole stacked leaf per layer
    (same gradient values)."""
    rows = [torch.unbind(a, 0) for a in tree_leaves(params["layers"])]
    return [tree_unflatten(params["layers"], [r[i] for r in rows])
            for i in range(len(rows[0]) if rows else 0)]


def _remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd
    records: its intermediates are recomputed in the backward, not kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows in bfloat16. ``F.embedding``, not
    ``embed[ids]``: the same rows, and its backward sums the rows'
    gradients in one order run to run (``embed[ids]``'s ``index_put_``
    does not on the CPU)."""
    ids = tokens.to(params["embed"].device)
    return F.embedding(ids, params["embed"]).to(torch.bfloat16)


def _attn_block(cfg: LMConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """Causal self-attention over ``x``; returns (output, (k, v))."""
    b, s, _ = x.shape
    q = L.dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense(p["wk"], x).reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = L.dense(p["wv"], x).reshape(b, s, cfg.n_kv, cfg.head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, causal=True)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], out), (k, v)


def _ffn_block(cfg: LMConfig, lp, hin: torch.Tensor, capacity_factor: Optional[float]):
    """The layer's FFN or MoE on normed ``hin`` (B, S, d); returns (out,
    aux). ``capacity_factor=None`` calls ``moe`` with its own default, as
    the JAX package's decode step does."""
    if not cfg.moe:
        return L.ffn(lp["ffn"], hin, act=cfg.act), 0.0
    b, s, d = hin.shape
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    out, aux = L.moe(lp["moe"], hin.reshape(b * s, d), top_k=cfg.moe.top_k, act=cfg.act, **kw)
    return out.reshape(b, s, d), aux


def _layer_fwd(cfg: LMConfig, lp, x: torch.Tensor, positions: torch.Tensor):
    h, kv = _attn_block(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), positions)
    x = x + h
    out, aux = _ffn_block(cfg, lp, _norm(cfg, lp["ln2"], x),
                          cfg.moe.capacity_factor if cfg.moe else None)
    return x + out, aux, kv


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _layers_fwd(cfg: LMConfig, lps: list, positions: torch.Tensor, x: torch.Tensor,
                aux: torch.Tensor):
    for lp in lps:
        x, a, _ = _layer_fwd(cfg, lp, x, positions)
        aux = aux + a
    return x, aux


def trunk(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> final hidden states (B, S, d) bf16, aux loss.

    ``cfg.layer_groups > 1`` (dividing ``n_layers``) recomputes each group
    of ``n_layers // layer_groups`` layers in the backward, keeping only
    the groups' inputs; otherwise ``cfg.remat`` does so for each layer."""
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = unbind_layers(params)
    groups = cfg.layer_groups
    grouped = groups > 1 and cfg.n_layers % groups == 0
    per = cfg.n_layers // groups if grouped else 1
    for i in range(0, cfg.n_layers, per):
        run = partial(_layers_fwd, cfg, layers[i:i + per], positions)
        x, aux = _remat(run, x, aux) if grouped or cfg.remat else run(x, aux)
    return _norm(cfg, params["ln_f"], x), aux


def forward(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab) float32, aux loss).
    Materialises the full logits: for small scale and checks."""
    x, aux = trunk(params, cfg, tokens)
    return L.dense(params["lm_head"], x, torch.float32), aux


LOSS_CHUNK = 128  # sequence positions per cross-entropy chunk


def _chunk_nll(head, xc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of one chunk: bfloat16 logits,
    the max subtracted in bfloat16 (no gradient through it), float32
    softmax statistics."""
    logits = L.dense(head, xc, torch.bfloat16)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = (logits - m).to(torch.float32)
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    tgt = shifted.gather(-1, lc[..., None])[..., 0]
    return (lse - tgt).sum()


def loss_fn(params, cfg: LMConfig, batch) -> torch.Tensor:
    """Chunked cross-entropy: the (B, S, vocab) logits are never
    materialised. The head's product and the softmax run per chunk of
    ``LOSS_CHUNK`` positions, each recomputed in the backward rather than
    kept; the chunks' sums are added in order, then ``total / (B*S) +
    0.01 * aux``. A length the chunks do not tile raises, as the JAX
    package's reshape fails."""
    x, aux = trunk(params, cfg, torch.as_tensor(batch["tokens"]))
    b, s, _ = x.shape
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    n_chunks, size = L._chunks(s, LOSS_CHUNK, "sequence")
    total = 0.0
    for i in range(n_chunks):
        cut = slice(i * size, (i + 1) * size)
        total = total + _remat(_chunk_nll, params["lm_head"], x[:, cut], labels[:, cut])
    return total / (b * s) + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode with a KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor   # (L, B, S_max, KV, hd)
    v: torch.Tensor
    length: int       # valid prefix, shared by every row


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = devices.DEFAULT_DEVICE) -> KVCache:
    dev = devices.resolve(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=0)


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: Optional[int] = None):
    """Full-sequence forward; returns (float32 logits at the last position
    (B, vocab), a cache of ``max_len`` positions holding the ``S`` of
    ``tokens``)."""
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    x = _embed(params, tokens)
    cache = init_cache(cfg, b, max_len, device=x.device)
    positions = _positions(b, s, x.device)
    for i in range(cfg.n_layers):
        x, _, (k, v) = _layer_fwd(cfg, layer_params(params, i), x, positions)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = _norm(cfg, params["ln_f"], x[:, -1:])
    logits = L.dense(params["lm_head"], x, torch.float32)[:, 0]
    return logits, dataclasses.replace(cache, length=s)


def decode_step(params, cfg: LMConfig, cache: KVCache, token: torch.Tensor):
    """token (B,) -> (logits (B, vocab) float32, the cache one longer).

    One new token a row at the shared position ``cache.length``, written
    into ``cache``'s tensors in place (the returned cache holds the same
    tensors). Prompts are left-padded, so the pads are attended, as in the
    JAX package. MoE layers run ``moe`` at its default capacity factor over
    ``t = B`` tokens, so picks past an expert's capacity are dropped, as
    there."""
    b = token.shape[0]
    pos = cache.length
    if pos >= cache.k.shape[2]:
        raise ValueError(f"the cache holds {cache.k.shape[2]} positions; it is full")
    x = _embed(params, token[:, None])
    positions = torch.full((b, 1), pos, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        xb = _norm(cfg, lp["ln1"], x)
        q = L.dense(lp["attn"]["wq"], xb).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = L.dense(lp["attn"]["wk"], xb).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        v = L.dense(lp["attn"]["wv"], xb).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        cache.k[i, :, pos] = k[:, 0]
        cache.v[i, :, pos] = v[:, 0]
        out = L.attention(q, cache.k[i], cache.v[i], causal=False, kv_len=pos + 1)
        x = x + L.dense(lp["attn"]["wo"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))
        out, _ = _ffn_block(cfg, lp, _norm(cfg, lp["ln2"], x), None)
        x = x + out
    x = _norm(cfg, params["ln_f"], x)
    logits = L.dense(params["lm_head"], x, torch.float32)[:, 0]
    return logits, dataclasses.replace(cache, length=pos + 1)
