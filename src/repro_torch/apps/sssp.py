"""Single-Source Shortest Path via Bellman-Ford (paper Table III: SSSP).

Push-based (the paper notes SSSP spends its ROI in push iterations): active
sources relax their out-edges; a vertex joins the next frontier when its
distance improved.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.apps.engine import min_reduce
from repro_torch.graph.csr import DeviceCSR, out_degree_sum
from repro_torch.kernels.segment_min.relax import relax_min


def sssp(
    g_out: DeviceCSR,
    source: int,
    max_iters: int = 10_000,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Distances from ``source``, float32 on ``g_out``'s device (``inf``
    where unreachable). ``g_out`` is the out-edge CSR: ``g_out.dst`` =
    pushing source of each edge, ``g_out.indices`` = its target (see
    ``engine.edge_map_push``); weights of 1 where it has none.

    A host loop runs while a vertex is active and ``it < max_iters``, one
    read of the device an iteration. The iterations are Jacobi: each one's
    candidates ``dist[u] + w`` come from the distances the one before left.

    An out-CSR on the card with int32 offsets and targets and float32
    weights (or none) takes the relaxation kernels
    (``kernels/segment_min/relax.py``): one pass over the active rows'
    out-edges into the targets' minima, and one that settles every vertex
    and raises a device flag, which is what the host reads. Any other
    input, and the CPU, builds (E,) candidates with ``where`` and reduces
    them with ``min_reduce`` over the targets. The minimum has no order and
    ``dist + w`` is the same float32 add, so both routes give the JAX
    package's distances bit for bit, in as many iterations.

    ``stats``, when given, receives ``iters`` and ``edges_relaxed``, the
    active rows' out-degrees summed over the iterations (read from the
    device once, after the loop). Under torch.profiler the flag read is an
    ``apps.flag`` span and each iteration an ``apps.iter`` one; the kernels
    run in its ``engine.reduce``, the other route's candidates in
    ``engine.gather`` then their reduction in ``engine.reduce``, as in
    ``engine``'s edge maps (``repro_torch.spans``).
    """
    n = g_out.num_nodes
    dev = g_out.indices.device
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    active = torch.zeros((n,), dtype=torch.bool, device=dev)
    active[source] = True
    relaxed = torch.zeros((1,), dtype=torch.int64, device=dev)
    if (g_out.indices.is_cuda and g_out.indptr.dtype == torch.int32
            and g_out.indices.dtype == torch.int32
            and (g_out.weights is None or g_out.weights.dtype == torch.float32)):
        it = _relax_on_card(g_out, dist, active, relaxed, max_iters)
    else:
        dist, it = _relax_dense(g_out, dist, active, relaxed if stats is not None else None,
                                max_iters)
    if stats is not None:
        stats["iters"] = it
        stats["edges_relaxed"] = int(relaxed)
    return dist


def _relax_on_card(g_out: DeviceCSR, dist: torch.Tensor, active: torch.Tensor,
                   relaxed: torch.Tensor, max_iters: int) -> int:
    """The loop through the relaxation kernels, in place: no (E,) tensor is
    made. Returns the iterations."""
    n = g_out.num_nodes
    keys = torch.full((n,), float("inf"), dtype=torch.float32, device=dist.device).view(
        torch.int32)
    flag = torch.ones((1,), dtype=torch.int32, device=dist.device)
    it = 0
    while it < max_iters:
        with spans.span("apps.flag"):
            if not bool(flag):
                break
        with spans.span("apps.iter"), spans.span("engine.reduce"):
            relax_min(g_out.indptr, g_out.indices, g_out.weights, dist, active, keys, flag,
                      relaxed)
        it += 1
    return it


def _relax_dense(g_out: DeviceCSR, dist: torch.Tensor, active: torch.Tensor,
                 relaxed: Optional[torch.Tensor], max_iters: int) -> tuple[torch.Tensor, int]:
    """The loop over (E,) candidates and ``min_reduce``; adds the active
    rows' out-degrees to ``relaxed`` when given. Returns the distances and
    the iterations."""
    n = g_out.num_nodes
    w = g_out.weights if g_out.weights is not None else torch.ones(
        g_out.indices.shape, dtype=torch.float32, device=dist.device)
    # widened once: an int32 index is widened on every gather
    src_of_edge = g_out.dst.long()
    it = 0
    while it < max_iters:
        with spans.span("apps.flag"):
            if not bool(active.any()):
                break
        with spans.span("apps.iter"):
            if relaxed is not None:
                relaxed += out_degree_sum(g_out.indptr, active)
            with spans.span("engine.gather"):
                cand = torch.where(active[src_of_edge], dist[src_of_edge] + w, float("inf"))
            with spans.span("engine.reduce"):
                best = min_reduce(cand, g_out.indices, n)
            active = best < dist
            dist = torch.minimum(dist, best)
        it += 1
    return dist, it
