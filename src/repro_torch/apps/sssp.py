"""Single-Source Shortest Path via Bellman-Ford (paper Table III: SSSP).

Push-based (the paper notes SSSP spends its ROI in push iterations): active
sources relax their out-edges; a vertex joins the next frontier when its
distance improved.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.apps import engine
from repro_torch.apps.engine import min_reduce
from repro_torch.graph.csr import DeviceCSR


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

    A host loop runs while ``active.any() & (it < max_iters)``, one read of
    the flag an iteration. Each iteration's relaxation is one
    ``min_reduce`` of (E,) float32 candidates over the int32 targets, which
    the engine sends to the segment-min kernel on the card (its plain
    version, ``scatter_reduce_`` amin, on the CPU). The minimum has no
    order and ``dist + w`` is the same float32 add, so the distances equal
    the JAX package's bit for bit.

    ``stats``, when given, receives ``iters`` and ``live_messages``: the
    candidates not +inf summed over the iterations (with finite weights,
    the frontiers' out-edges), as the engine counted them, read once after
    the loop, where the last flag read has already waited for the device;
    None where a reduction did not go through the engine's counting path.
    Under torch.profiler the flag read is an ``apps.flag`` span, each
    iteration an ``apps.iter`` one, and its relaxation ``engine.gather``
    then ``engine.reduce``, as in ``engine``'s edge maps
    (``repro_torch.spans``).
    """
    n = g_out.num_nodes
    dev = g_out.indices.device
    w = g_out.weights if g_out.weights is not None else torch.ones(
        g_out.indices.shape, dtype=torch.float32, device=dev)
    # widened once: an int32 index is widened on every gather
    src_of_edge = g_out.dst.long()
    mark = engine.live_messages(dev) if stats is not None else None

    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    active = torch.zeros((n,), dtype=torch.bool, device=dev)
    active[source] = True
    it = 0
    while it < max_iters:
        with spans.span("apps.flag"):
            if not bool(active.any()):
                break
        with spans.span("apps.iter"):
            with spans.span("engine.gather"):
                cand = torch.where(active[src_of_edge], dist[src_of_edge] + w, float("inf"))
            with spans.span("engine.reduce"):
                best = min_reduce(cand, g_out.indices, n)
            active = best < dist
            dist = torch.minimum(dist, best)
        it += 1
    if stats is not None:
        counted, live = engine.live_messages(dev)
        stats["iters"] = it
        stats["live_messages"] = int(live - mark[1]) if counted - mark[0] == it else None
    return dist
