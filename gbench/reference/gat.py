"""GAT's forward over a whole graph, written plainly in torch: the reference
that the port's GAT is held to, by the benchmark's check and by the port's
tests. It imports nothing of the port.

Graph Attention Networks (Veličković et al., ICLR 2018, arXiv:1710.10903),
as PyG's ``GATConv`` computes it with a self loop on every vertex. Each
layer, with heads k and channels c:

    z = h @ W                                       (N, H, C), no bias
    e_ij = LeakyReLU(<z_j, a_src> + <z_i, a_dst>)   for j in N_in(i) + {i}, per head
    alpha_ij = softmax over j of e_ij
    o_i = sum_j alpha_ij z_j                        per head
    h_i' = concat_k o_i (mean_k o_i on the last layer) + bias + h_i @ W_skip + b_skip

with ELU after every layer but the last, whose output is the logits.

Departures from the leaderboard's model (OGB ogbn-products, "GAT w/NS",
PyG's ``examples/ogbn_products_gat.py``):

- no dropout: inference;
- the logits are compared before the model's ``log_softmax``;
- the graph's own edges are taken as given (the benchmark's graphs have no
  self loops, which PyG would remove before adding its own).

Everything is computed in the caller's ``dtype`` (float64 for the check,
bfloat16 for the control), one block of whole destination rows at a time
so that it fits: each block gathers its edges' scores and rows with
``index_select``, takes each row's maximum with ``scatter_reduce``, and sums
with ``index_add_``. TF32 is turned off for float32 products.
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


def gat_forward(params: dict, x: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
                negative_slope: float = 0.2, dtype: torch.dtype = torch.float64,
                block_items: int = 1 << 20) -> torch.Tensor:
    """Logits (N, C_last) in ``dtype``.

    ``params``: ``{"layers": [{"lin": {"w"}, "att_src", "att_dst", "bias",
    "skip": {"w", "b"}}]}``, weights as (d_in, d_out) matrices and the
    attention vectors as (H, C). ``x`` (N, F) features; ``indptr`` (N + 1,)
    and ``src`` (E,), the in-edges of each vertex as a CSR (row i's sources
    are ``src[indptr[i]:indptr[i + 1]]``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x.device
    ptr = indptr.to("cpu", torch.int64)
    n = ptr.shape[0] - 1
    blocks = [(v0, v1, int(ptr[v0]), int(ptr[v1])) for v0, v1 in _blocks(ptr, block_items)]
    counts = (ptr[1:] - ptr[:-1]).to(dev)

    h = x.to(dtype)
    layers = params["layers"]
    for i, lp in enumerate(layers):
        last = i == len(layers) - 1
        a_src, a_dst = lp["att_src"].to(dev, dtype), lp["att_dst"].to(dev, dtype)
        heads, c = a_src.shape
        z = h @ lp["lin"]["w"].to(dev, dtype)
        skip = h @ lp["skip"]["w"].to(dev, dtype) + lp["skip"]["b"].to(dev, dtype)
        del h
        s_src = torch.empty((n, heads), dtype=dtype, device=dev)
        s_dst = torch.empty((n, heads), dtype=dtype, device=dev)
        for v0, v1, _, _ in blocks:
            zb = z[v0:v1].view(-1, heads, c)
            s_src[v0:v1] = (zb * a_src).sum(-1)
            s_dst[v0:v1] = (zb * a_dst).sum(-1)
        new = torch.empty((n, c if last else heads * c), dtype=dtype, device=dev)
        for v0, v1, e0, e1 in blocks:
            k = v1 - v0
            own = torch.arange(k, device=dev)
            rows = torch.cat([own.repeat_interleave(counts[v0:v1]), own])
            cols = torch.cat([src[e0:e1].long(), own + v0])
            e = F.leaky_relu(s_src.index_select(0, cols) + s_dst[v0:v1].index_select(0, rows),
                             negative_slope)
            top = torch.full((k, heads), -torch.inf, dtype=dtype, device=dev).scatter_reduce(
                0, rows[:, None].expand(-1, heads), e, "amax", include_self=True)
            p = torch.exp(e - top.index_select(0, rows))
            den = torch.zeros((k, heads), dtype=dtype, device=dev).index_add_(0, rows, p)
            alpha = p / den.index_select(0, rows)
            msg = z.index_select(0, cols).view(-1, heads, c) * alpha[:, :, None]
            o = torch.zeros((k, heads, c), dtype=dtype, device=dev).index_add_(0, rows, msg)
            del msg
            new[v0:v1] = o.mean(1) if last else o.view(k, heads * c)
        del z
        new += lp["bias"].to(dev, dtype)
        new += skip
        del skip
        h = new if last else F.elu(new, inplace=True)
    return h
