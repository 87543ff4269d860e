"""PNA's forward over a whole graph, written plainly in torch: the reference
that the port's blocked PNA layer is held to, by the benchmark's check
and by the port's tests. It imports nothing of the port.

Principal Neighbourhood Aggregation (Corso et al., NeurIPS 2020,
arXiv:2004.05718). Each layer, for every edge j -> i of the graph:

    m_ij = [h_i, h_j] @ W_pre
    a_i  = mean, max, min and std of m_ij over i's in-edges
    s_i  = a_i, a_i * log(d_i + 1) / δ, a_i * δ / log(d_i + 1)   (the three scalers)
    h_i' = ReLU(LayerNorm(SiLU([s_i, h_i] @ W_post1) @ W_post2))

and the logits are ``h @ W_out`` after the last layer. δ is the mean of
log(d + 1) over the graph, given by the caller.

Departures from the paper, each the port's model as registered
(``configs/pna.py``):

- towers = 1: one ``pre`` and one ``post`` for all the features;
- no edge features: ``pre`` sees the two endpoint rows only;
- ``pre`` is one linear layer and ``post`` two with SiLU between them,
  none with a bias; LayerNorm and ReLU follow ``post``, with no residual;
- std is sqrt(max(E[m²] − E[m]², 0) + 1e-5);
- a vertex without in-edges aggregates to 0 (its std to sqrt(1e-5)); the
  attenuation divides by log(d + 1) clamped below at 1e-3, and δ is
  clamped below at 1e-3;
- the readout is one linear layer on every vertex (node prediction).

Everything is computed in the caller's ``dtype`` (float64 for the check,
bfloat16 for the control), one block of whole destination rows at a time
so that it fits: each block gathers its edges' rows with ``index_select``,
concatenates, multiplies, and reduces with ``index_add_`` and
``scatter_reduce``. TF32 is turned off for float32 products.
"""
from __future__ import annotations

import torch


def _blocks(ptr: torch.Tensor, block_edges: int) -> list:
    """[(v0, v1)]: whole rows, cut at the first row at or past each
    multiple of ``block_edges`` edges (so a block holds at most
    ``block_edges`` edges and the row that crosses the next multiple)."""
    n, e = ptr.shape[0] - 1, int(ptr[-1])
    marks = torch.arange(block_edges, max(e, block_edges), block_edges, dtype=torch.int64)
    cuts = torch.searchsorted(ptr, marks).tolist()
    bounds = sorted({0, n, *(c for c in cuts if 0 < c < n)})
    return list(zip(bounds[:-1], bounds[1:]))


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def pna_forward(params: dict, x: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
                mean_log_deg: float, aggregators=("mean", "max", "min", "std"),
                scalers=("identity", "amplification", "attenuation"),
                dtype: torch.dtype = torch.float64, block_edges: int = 1 << 22) -> torch.Tensor:
    """Logits (N, d_out) in ``dtype``.

    ``params``: ``{"layers": [{"pre": [{"w"}], "post": [{"w"}, {"w"}],
    "ln": {"g", "b"}}], "out": {"w"}}``, the weights as (d_in, d_out)
    matrices. ``x`` (N, F) features; ``indptr`` (N + 1,) and ``src`` (E,),
    the in-edges of each vertex as a CSR (row i's sources are
    ``src[indptr[i]:indptr[i + 1]]``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x.device
    ptr = indptr.to("cpu", torch.int64)
    n = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).to(dev)
    deg = counts.to(dtype)
    log_deg = torch.log(deg + 1)
    delta = max(float(mean_log_deg), 1e-3)
    amp = (log_deg / delta)[:, None]
    att = (delta / torch.clamp(log_deg, min=1e-3))[:, None]
    blocks = [(v0, v1, int(ptr[v0]), int(ptr[v1])) for v0, v1 in _blocks(ptr, block_edges)]

    def w(p):
        return p["w"].to(dev, dtype)

    h = x.to(dtype)
    for lp in params["layers"]:
        w_pre, (w1, w2) = w(lp["pre"][0]), [w(p) for p in lp["post"]]
        g, b = lp["ln"]["g"].to(dev, dtype), lp["ln"]["b"].to(dev, dtype)
        d = w_pre.shape[1]
        new = torch.empty((n, d), dtype=dtype, device=dev)
        for v0, v1, e0, e1 in blocks:
            rows = torch.arange(v1 - v0, device=dev).repeat_interleave(counts[v0:v1])
            h_dst = h[v0:v1].index_select(0, rows)
            h_src = h.index_select(0, src[e0:e1].long())
            m = torch.cat([h_dst, h_src], dim=1) @ w_pre
            k = v1 - v0
            total = torch.zeros((k, d), dtype=dtype, device=dev).index_add_(0, rows, m)
            squares = torch.zeros((k, d), dtype=dtype, device=dev).index_add_(0, rows, m * m)
            idx = rows[:, None].expand(-1, d)
            zeros = torch.zeros((k, d), dtype=dtype, device=dev)
            agg = {"max": zeros.scatter_reduce(0, idx, m, "amax", include_self=False),
                   "min": zeros.scatter_reduce(0, idx, m, "amin", include_self=False)}
            cnt = torch.clamp(deg[v0:v1], min=1)[:, None]
            agg["mean"] = total / cnt
            var = torch.clamp(squares / cnt - agg["mean"] ** 2, min=0)
            agg["std"] = torch.sqrt(var + 1e-5)
            scale = {"identity": 1, "amplification": amp[v0:v1], "attenuation": att[v0:v1]}
            z = torch.cat([agg[a] * scale[s] for a in aggregators for s in scalers]
                          + [h[v0:v1]], dim=1)
            y = z @ w1
            y = (y * torch.sigmoid(y)) @ w2
            new[v0:v1] = torch.relu(_layernorm(y, g, b))
        h = new
    return h @ w(params["out"])
