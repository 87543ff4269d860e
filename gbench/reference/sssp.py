"""Single-source shortest paths written plainly: Bellman-Ford over a frontier.

The source is at distance 0 and active. An iteration relaxes every out-edge
of the active vertices; a vertex whose distance fell is active in the next.
The loop ends when none is. With integer weights the distances are exact
in ``int64``, and in ``float32`` while they stay below 2**24; in another
dtype each sum is rounded to it.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 27  # edges a step: bounds the temporaries at scale 25


def sssp(indptr: torch.Tensor, indices: torch.Tensor, dst: torch.Tensor,
         weights: torch.Tensor, source: int, dtype: torch.dtype = torch.int64):
    """``(dist, frontier)``: distances in ``dtype`` (the dtype's largest
    value, or ``inf``, where unreachable) and per iteration ``(active
    vertices, edges out of them)``. Edge ``e`` runs from ``indices[e]`` to
    ``dst[e]`` with weight ``weights[e]``."""
    n = indptr.shape[0] - 1
    dev = indices.device
    far = torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")
    out_deg = torch.bincount(indices, minlength=n)
    dist = torch.full((n,), far, dtype=dtype, device=dev)
    dist[source] = 0
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[source] = True
    frontier = []
    while bool(active.any()):
        frontier.append((int(active.sum()), int(out_deg[active].sum())))
        best = torch.full((n,), far, dtype=dtype, device=dev)
        for lo in range(0, indices.shape[0], BLOCK):
            src = indices[lo:lo + BLOCK]
            live = active[src]
            src = src[live]
            cand = dist[src] + weights[lo:lo + BLOCK][live].to(dtype)
            best.scatter_reduce_(0, dst[lo:lo + BLOCK][live].long(), cand, "amin")
        active = best < dist
        dist = torch.minimum(dist, best)
    return dist, frontier
