"""Plain PyTorch version of the softmax-aggregation kernel.

The wrapper in ``softmax_aggr.py`` takes it for tensors on the CPU; on the
card it is what the kernel is held against. It works one block of whole
destination rows at a time, so that no tensor spans all E edges.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.gat_attend.ref import row_blocks

# items (in-edges and self loops) a block of rows: a longer row is a block alone
BLOCK_ITEMS = 1 << 20
TILE = 1024  # csrc/softmax_aggr.cu's kTile: items of the merged list a warp owns
BATCH = 4    # its kBatch: items a rescale


def aggregate(indptr: torch.Tensor, src: torch.Tensor, u: torch.Tensor, t: float,
              eps: float) -> torch.Tensor:
    """``m`` (n, d): for each row i and channel c, the softmax over j in
    ``N_in(i) + {i}`` of ``t q_jc`` (each less the row's maximum) applied
    to ``q_jc = ReLU(u_jc) + eps``, summed, in ``u``'s dtype. A NaN in
    ``u_jc`` makes channel c of the rows that read row j NaN."""
    n, d = u.shape
    m = u.new_empty((n, d))
    ptr = indptr.to("cpu", torch.int64)
    dev = u.device
    for v0, v1 in row_blocks(ptr, BLOCK_ITEMS):
        e0, e1, k = int(ptr[v0]), int(ptr[v1]), v1 - v0
        counts = (ptr[v0 + 1:v1 + 1] - ptr[v0:v1]).to(dev)
        own = torch.arange(v0, v1, device=dev)
        rows = torch.cat([torch.repeat_interleave(own, counts), own]) - v0
        cols = torch.cat([src[e0:e1].long(), own])
        q = F.relu(u[cols]) + eps
        s = q * t
        top = s.new_full((k, d), -torch.inf).scatter_reduce(
            0, rows[:, None].expand(-1, d), s, "amax", include_self=True)
        p = torch.exp(s - top[rows])
        den = u.new_zeros((k, d)).index_add_(0, rows, p)
        num = u.new_zeros((k, d)).index_add_(0, rows, p * q)
        m[v0:v1] = num / den
    return m


def softmax_aggr_ref(indptr: torch.Tensor, src: torch.Tensor, u: torch.Tensor, t: float,
                     eps: float) -> torch.Tensor:
    """``u + m`` (n, d): GENConv's input row plus its softmax aggregation
    over the row's in-edges and self loop (``aggregate``)."""
    return u + aggregate(indptr, src, u, t, eps)


def error_bound(indptr: torch.Tensor, src: torch.Tensor, u: torch.Tensor, t: float,
                eps: float) -> torch.Tensor:
    """The kernel's error bound against ``softmax_aggr_ref`` in float64,
    shaped as its output (csrc/softmax_aggr.cu): (2 TILE + 10 R + 6 tiles +
    16 + 7 S) · 2^-24 · m + 2^-24 · |u + m|, with R = TILE / BATCH + tiles
    the rescales, tiles the most a row spans and S = t log2(e) max q, in
    float64."""
    deg = indptr[1:] - indptr[:-1]
    tiles = int(deg.max()) // TILE + 2 if deg.numel() else 2
    top = float(u.max()) if u.numel() else 0.0
    scores = t * (max(top, 0.0) + eps) / math.log(2)
    rescales = TILE // BATCH + tiles
    m = aggregate(indptr, src, u.double(), t, eps)
    out = (u.double() + m).abs_()
    return m.mul_((2 * TILE + 10 * rescales + 6 * tiles + 16 + 7 * scores) * 2.0**-24).add_(
        out.mul_(2.0**-24))
