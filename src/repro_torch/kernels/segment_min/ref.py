"""Plain PyTorch version of the segment-min kernel.

The wrapper in ``segment_min.py`` takes it for tensors on the CPU; on the
card it is what the kernel is held against.
"""
from __future__ import annotations

import torch


def segment_min_ref(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``(E,)`` float32 messages, ``(E,)`` int32 ids -> ``(n,)`` float32.

    ``out[s]`` is the least message with id ``s``, or +inf for a segment
    with none; a NaN message makes its segment NaN. An id outside ``[0, n)``
    raises.
    """
    out = torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg.long(), data, reduce="amin", include_self=True)


def relax_min_ref(indptr: torch.Tensor, indices: torch.Tensor, weights, dist: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """SSSP's candidates reduced per target, over an out-CSR -> ``(n,)``.

    ``best[v]`` is the least ``dist[u] + weights[e]`` over the out-edges
    ``e`` of the active rows ``u`` (``indptr[u] <= e < indptr[u + 1]``)
    whose target ``indices[e]`` is ``v``, or +inf where there is none;
    weights of 1 where ``weights`` is None. A NaN candidate makes its target
    NaN. The edges of inactive rows are never read.
    """
    n = dist.shape[0]
    rows = torch.nonzero(active).flatten()
    counts = (indptr[rows + 1] - indptr[rows]).long()
    # the active rows' edges, row after row
    starts = indptr[rows].long() - (torch.cumsum(counts, 0) - counts)
    edges = torch.repeat_interleave(starts, counts) + torch.arange(
        int(counts.sum()), device=dist.device)
    cand = dist[torch.repeat_interleave(rows, counts)] + (
        weights[edges] if weights is not None else 1.0)
    best = torch.full((n,), float("inf"), dtype=cand.dtype, device=dist.device)
    return best.scatter_reduce_(0, indices[edges].long(), cand, reduce="amin", include_self=True)


def settle_ref(best: torch.Tensor, dist: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """In place: ``active = best < dist`` and ``dist = minimum(dist, best)``
    (NaN where either is). Returns whether a vertex is active, as a 0-d
    bool tensor."""
    torch.lt(best, dist, out=active)
    torch.minimum(dist, best, out=dist)
    return active.any()
