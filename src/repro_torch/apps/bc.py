"""Betweenness Centrality, Brandes single-root (paper Table III: BC).

Forward: BFS levels with shortest-path counts (sigma). Backward: dependency
accumulation level by level. Dense frontier masks; each level is one pass
of a host loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.apps.engine import sum_reduce
from repro_torch.graph.csr import DeviceCSR


def bc_single_source(g_out: DeviceCSR, source: int, max_levels: int = 64,
                     stats: Optional[dict] = None):
    """Returns (dependency scores delta, sigma, level) for one root, float32,
    float32 and int32 on ``g_out``'s device.

    ``g_out``: out-edge CSR (``dst`` = edge source, ``indices`` = edge
    target — see engine.edge_map_push conventions). The forward loop runs
    while ``frontier.any() & (d < max_levels)``, the backward loop ``depth``
    times, as the JAX package's ``while_loop`` and ``fori_loop``. ``level``
    is exact; ``sigma`` is exact while path counts stay below 2^24 (past
    float32's range it becomes ``inf``, as in the JAX package); ``delta``
    differs only by summation order. ``stats``, when given, receives
    ``iters``, the forward loop's depth.
    """
    n = g_out.num_nodes
    dev = g_out.indices.device
    # widened once: an int32 index is widened on every gather
    src_e, dst_e = g_out.dst.long(), g_out.indices.long()

    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[source] = 0
    sigma = torch.zeros((n,), dtype=torch.float32, device=dev)
    sigma[source] = 1.0
    frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier[source] = True
    depth = 0
    while depth < max_levels and bool(frontier.any()):
        # counts pushed from frontier to unvisited neighbours
        msg = torch.where(frontier[src_e], sigma[src_e], 0.0)
        inc = sum_reduce(msg, dst_e, n)
        frontier = (inc > 0) & (level < 0)
        level = torch.where(frontier, depth + 1, level)
        sigma = sigma + torch.where(frontier, inc, 0.0)
        depth += 1

    # Backward dependency accumulation, deepest level first:
    # delta[v] += sum_{w in succ(v)} sigma[v]/sigma[w] * (1 + delta[w])
    safe_sigma = torch.clamp(sigma, min=1.0)
    delta = torch.zeros((n,), dtype=torch.float32, device=dev)
    for i in range(depth):
        d = depth - i  # current successor level
        on_level = level == d
        coef = torch.where(on_level, (1.0 + delta) / safe_sigma, 0.0)
        # edge (v=src_e -> w=dst_e) contributes when level[v]==d-1, level[w]==d
        msg = torch.where(on_level[dst_e], coef[dst_e], 0.0)
        back = sum_reduce(msg, src_e, n)
        delta = delta + torch.where(level == d - 1, back * sigma, 0.0)
    if stats is not None:
        stats["iters"] = depth
    return delta, sigma, level
