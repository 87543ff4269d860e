"""Plain PyTorch version of the GAT attention kernel.

The wrapper in ``gat_attend.py`` takes it for tensors on the CPU; on the
card it is what the kernel is held against. It works one block of whole
destination rows at a time, so that no tensor spans all E edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# items (in-edges and self loops) a block of rows: a longer row is a block alone
BLOCK_ITEMS = 1 << 22
TILE = 1024  # csrc/gat_attend.cu's kTile: items of the merged list a warp owns


def row_blocks(indptr: torch.Tensor, budget: int) -> list:
    """``[(v0, v1)]``: whole rows, each block at most ``budget`` items
    (a row's in-edges and its self loop), except a row longer than that."""
    ptr = indptr.to("cpu", torch.int64)
    n = ptr.shape[0] - 1
    ends = ptr[1:] + torch.arange(1, n + 1)  # items up to each row's end
    blocks, v0 = [], 0
    while v0 < n:
        done = int(ptr[v0]) + v0
        v1 = int(torch.searchsorted(ends, done + budget, right=True))
        v1 = min(max(v1, v0 + 1), n)
        blocks.append((v0, v1))
        v0 = v1
    return blocks


def gat_attend_ref(indptr: torch.Tensor, src: torch.Tensor, z: torch.Tensor,
                   s_src: torch.Tensor, s_dst: torch.Tensor, negative_slope: float,
                   mean: bool) -> torch.Tensor:
    """For each row i and head k: the softmax over j in ``N_in(i) + {i}``
    of ``LeakyReLU(s_src[j, k] + s_dst[i, k])``, each score less the row's
    maximum, and the weighted sum of ``z[j, k, :]``; the heads concatenated
    ``(n, H·C)`` or averaged ``(n, C)`` when ``mean``.

    ``indptr`` ``(n + 1,)`` and ``src`` ``(E,)`` are the in-CSR; ``z`` is
    ``(n, H·C)``, ``s_src`` and ``s_dst`` ``(n, H)``. The sum is taken as
    ``sum_j p_j z_j / sum_j p_j``, in ``z``'s dtype. A NaN score makes its
    row's head NaN.
    """
    n, width = z.shape
    heads = s_src.shape[1]
    c = width // heads
    out = z.new_empty((n, c) if mean else (n, width))
    ptr = indptr.to("cpu", torch.int64)
    dev = z.device
    for v0, v1 in row_blocks(ptr, BLOCK_ITEMS):
        e0, e1, k = int(ptr[v0]), int(ptr[v1]), v1 - v0
        counts = (ptr[v0 + 1:v1 + 1] - ptr[v0:v1]).to(dev)
        own = torch.arange(v0, v1, device=dev)
        rows = torch.cat([torch.repeat_interleave(own, counts), own]) - v0
        cols = torch.cat([src[e0:e1].long(), own])
        e = F.leaky_relu(s_src[cols] + s_dst[rows + v0], negative_slope)
        top = e.new_full((k, heads), -torch.inf).scatter_reduce(
            0, rows[:, None].expand(-1, heads), e, "amax", include_self=True)
        p = torch.exp(e - top[rows])
        den = e.new_zeros((k, heads)).index_add_(0, rows, p)
        num = z.new_zeros((k, heads, c)).index_add_(
            0, rows, z[cols].view(-1, heads, c) * p[:, :, None])
        o = num / den[:, :, None]
        out[v0:v1] = o.mean(1) if mean else o.view(k, width)
    return out


def error_bound(indptr: torch.Tensor, src: torch.Tensor, z: torch.Tensor,
                s_src: torch.Tensor, s_dst: torch.Tensor, negative_slope: float,
                mean: bool) -> torch.Tensor:
    """The kernel's error bound against this function in float64, shaped as
    its output (csrc/gat_attend.cu): (TILE + the tiles a row spans + 8)
    float32 roundings of the row's sum of p|z|, over a sum of p of at least
    1, plus the rounding of each score's float32 sum s_src + s_dst, which
    moves its weight by 2|e| roundings: (TILE + tiles + 8 + 2 max|e|) ·
    2^-24 · sum_j alpha_j |z_j|, in float64."""
    deg = indptr[1:] - indptr[:-1]
    tiles = int(deg.max()) // TILE + 2 if deg.numel() else 2
    e = float(max(s_src.abs().max(), s_dst.abs().max())) * 2 if z.numel() else 0.0
    mag = gat_attend_ref(indptr, src, z.double().abs_(), s_src.double(), s_dst.double(),
                         negative_slope, mean)
    return mag.mul_((TILE + tiles + 8 + 2 * e) * 2.0**-24)
