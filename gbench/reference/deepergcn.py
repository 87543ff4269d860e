"""DeeperGCN's forward over a whole graph, written plainly in torch: the
reference that the port's DeeperGCN is held to, by the benchmark's check and
by the port's tests. It imports nothing of the port.

DeeperGCN (Li, Xiong, Thabet, Ghanem, arXiv:2006.07739) as the authors'
``deep_gcns_torch`` builds it for OGB's ogbn-products: GENConv with the
softmax aggregator at a fixed t, in pre-activation residual ("res+")
blocks, with a self loop on every vertex. With eps = 1e-7, for vertex i and
channel c:

    h^0     = x W_enc + b_enc
    GENConv_l(u)_i = (u_i + m_i) W_l + b_l,
      m_ic = sum_{j in N_in(i) + {i}} softmax_j(t q_jc) q_jc,   q_j = ReLU(u_j) + eps
    h^1     = GENConv_0(h^0)
    h^{l+1} = h^l + GENConv_l(ReLU(BN_{l-1}(h^l)))       l = 1 .. L - 1
    logits  = ReLU(BN_{L-1}(h^L)) W_out + b_out

with BatchNorm in eval mode: gamma (h - mean) / sqrt(var + bn_eps) + beta.

Departures from the leaderboard's model (OGB ogbn-products, "DeeperGCN",
``examples/ogb/ogbn_products`` of ``lightaime/deep_gcns_torch``):

- no dropout: inference;
- the logits are compared before the model's ``log_softmax``;
- ``softmax_sg``'s stop-gradient is left out: it changes no forward value;
- the graph's own edges are taken as given (the benchmark's graphs have no
  self loops, which the script's ``add_self_loops`` would otherwise double).

With ``fit_stats`` each BatchNorm's running mean and variance are first
set from the stream it normalises (per channel, over every vertex, rounded
to float32), as a trained model's are fitted to its activations; the norms
then normalise with those rounded values, so the logits are the ones the
fitted model gives.

Everything is computed in the caller's ``dtype`` (float64 for the check,
bfloat16 for the control), one block of whole destination rows at a time
so that it fits: each block gathers its edges' rows with ``index_select``,
takes each row's per-channel maximum with ``scatter_reduce`` and sums with
``index_add_``. TF32 is turned off for float32 products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _blocks(ptr: torch.Tensor, block_items: int) -> list:
    """[(v0, v1)]: whole rows, a block ending at the first row whose edges
    and self loops reach the next multiple of ``block_items``."""
    n = ptr.shape[0] - 1
    items = ptr + torch.arange(n + 1)  # edges and self loops before each row
    marks = torch.arange(block_items, max(int(items[-1]), block_items), block_items)
    cuts = torch.searchsorted(items, marks).tolist()
    bounds = sorted({0, n, *(c for c in cuts if 0 < c < n)})
    return list(zip(bounds[:-1], bounds[1:]))


def _norm_relu(h: torch.Tensor, norm: dict, stats: dict, bn_eps: float) -> torch.Tensor:
    dev, dtype = h.device, h.dtype
    g, b = norm["g"].to(dev, dtype), norm["b"].to(dev, dtype)
    mean, var = stats["mean"].to(dev, dtype), stats["var"].to(dev, dtype)
    return F.relu((h - mean) / torch.sqrt(var + bn_eps) * g + b)


def _moments(h: torch.Tensor) -> dict:
    """Per-channel mean and (biased) variance of ``h``, rounded to float32."""
    var, mean = torch.var_mean(h, 0, correction=0)
    return {"mean": mean.to(torch.float32), "var": var.to(torch.float32)}


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"].to(x.device, x.dtype) + p["b"].to(x.device, x.dtype)


def deepergcn_forward(params: dict, x: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
                      t: float = 0.1, eps: float = 1e-7, bn_eps: float = 1e-5,
                      dtype: torch.dtype = torch.float64,
                      block_items: int = 1 << 20, fit_stats: bool = False) -> torch.Tensor:
    """Logits (N, d_out) in ``dtype``.

    ``params``: ``{"enc": {"w", "b"}, "layers": [{"w", "b"}], "norms":
    [{"g", "b"}], "stats": [{"mean", "var"}], "out": {"w", "b"}}``, weights
    as (d_in, d_out) matrices; ``norms[l]`` and ``stats[l]`` are the
    BatchNorm before layer l + 1 (the last one before the head). ``x`` (N,
    F) features; ``indptr`` (N + 1,) and ``src`` (E,), the in-edges of each
    vertex as a CSR (row i's sources are ``src[indptr[i]:indptr[i + 1]]``).
    With ``fit_stats``, ``params["stats"]`` (a list of ``L`` entries) is
    filled with the moments of each norm's input as the forward reaches it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x.device
    ptr = indptr.to("cpu", torch.int64)
    blocks = [(v0, v1, int(ptr[v0]), int(ptr[v1])) for v0, v1 in _blocks(ptr, block_items)]
    counts = (ptr[1:] - ptr[:-1]).to(dev)

    h = _linear(x.to(dtype), params["enc"])
    layers = params["layers"]
    for i, lp in enumerate(layers):
        if i > 0 and fit_stats:
            params["stats"][i - 1] = _moments(h)
        u = h if i == 0 else _norm_relu(h, params["norms"][i - 1], params["stats"][i - 1], bn_eps)
        q = F.relu(u) + eps
        d = q.shape[1]
        agg = torch.empty_like(u)
        for v0, v1, e0, e1 in blocks:
            k = v1 - v0
            own = torch.arange(k, device=dev)
            rows = torch.cat([own.repeat_interleave(counts[v0:v1]), own])
            cols = torch.cat([src[e0:e1].long(), own + v0])
            qj = q.index_select(0, cols)
            s = t * qj
            top = torch.full((k, d), -torch.inf, dtype=dtype, device=dev).scatter_reduce(
                0, rows[:, None].expand(-1, d), s, "amax", include_self=True)
            p = torch.exp(s - top.index_select(0, rows))
            den = torch.zeros((k, d), dtype=dtype, device=dev).index_add_(0, rows, p)
            num = torch.zeros((k, d), dtype=dtype, device=dev).index_add_(0, rows, p * qj)
            del qj, s, p
            agg[v0:v1] = u[v0:v1] + num / den
        del q, u
        out = _linear(agg, lp)
        del agg
        h = out if i == 0 else h + out
    if fit_stats:
        params["stats"][-1] = _moments(h)
    return _linear(_norm_relu(h, params["norms"][-1], params["stats"][-1], bn_eps),
                   params["out"])
