"""PageRank-Delta written plainly (the GRASP paper's Table III PRD, Ligra's
PageRankDelta without dangling redistribution).

Every vertex starts at ``(1 - damping) / N`` with that as its delta and is
active. An iteration sends ``delta / out_degree`` of each active vertex
along its out-edges; each vertex's new delta is ``damping`` times what it
received, its rank grows by that delta, and it stays active while
``|delta| > epsilon * |rank|``. The loop ends when no vertex is active or
after ``max_iters`` iterations.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 27  # edges a step: bounds the temporaries at scale 25


def pagerank_delta(indptr: torch.Tensor, indices: torch.Tensor, dst: torch.Tensor,
                   damping: float, epsilon: float, max_iters: int,
                   dtype: torch.dtype = torch.float64):
    """``(rank, frontier)``: ranks in ``dtype``, and per iteration
    ``(active vertices, edges out of them)``. ``indices[e]`` is the source
    and ``dst[e]`` the destination of edge ``e``."""
    n = indptr.shape[0] - 1
    dev = indices.device
    out_deg = torch.bincount(indices, minlength=n)
    inv_deg = 1.0 / torch.clamp(out_deg, min=1).to(dtype)
    rank = torch.full((n,), (1.0 - damping) / n, dtype=dtype, device=dev)
    delta = rank.clone()
    active = torch.ones(n, dtype=torch.bool, device=dev)
    frontier = []
    while len(frontier) < max_iters and bool(active.any()):
        frontier.append((int(active.sum()), int(out_deg[active].sum())))
        contrib = torch.where(active, delta, 0.0) * inv_deg
        incoming = torch.zeros(n, dtype=dtype, device=dev)
        for lo in range(0, indices.shape[0], BLOCK):
            src = indices[lo:lo + BLOCK]
            incoming.index_add_(0, dst[lo:lo + BLOCK], contrib.index_select(0, src))
        delta = damping * incoming
        rank = rank + delta
        active = delta.abs() > epsilon * rank.abs()
    return rank, frontier
