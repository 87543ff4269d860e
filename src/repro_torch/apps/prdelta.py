"""PageRank-Delta (paper Table III: PRD).

Vertices are active in an iteration only when they have accumulated enough
change in their score — the pull-push Ligra variant the paper selects after
Property-Array merging (Table IV).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.apps.engine import edge_map_pull, sum_reduce
from repro_torch.graph.csr import DeviceCSR


def pagerank_delta(
    g: DeviceCSR,
    damping: float = 0.85,
    epsilon: float = 1e-5,
    max_iters: int = 100,
    gather_impl: str = "hot",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Ranks of ``g``'s vertices, float32 on ``g``'s device. No dangling
    redistribution (unlike ``pagerank``).

    A host loop runs while ``active.any() & (it < max_iters)``, the
    condition of the JAX package's ``while_loop``; reading the flag each
    iteration synchronises with the device. ``stats``, when given,
    receives ``iters``, the number of iterations run. Under torch.profiler
    the flag read is an ``apps.flag`` span and each iteration an
    ``apps.iter`` one (``repro_torch.spans``).
    """
    n = g.num_nodes
    dev = g.indices.device
    out_deg = sum_reduce(torch.ones(g.indices.shape, dtype=torch.float32, device=dev),
                         g.indices, n)
    safe_deg = torch.clamp(out_deg, min=1.0)
    # damping and epsilon are float32 scalars in the JAX package's jitted loop
    f32 = np.float32
    damping32, epsilon32 = float(f32(damping)), float(f32(epsilon))

    rank = torch.full((n,), float((f32(1.0) - f32(damping)) / f32(n)), dtype=torch.float32,
                      device=dev)
    delta = rank
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters:
        with spans.span("apps.flag"):
            if not bool(active.any()):
                break
        with spans.span("apps.iter"):
            contrib = torch.where(active, delta, 0.0) / safe_deg
            incoming = edge_map_pull(g, contrib, reduce_fn=sum_reduce, gather_impl=gather_impl)
            delta = damping32 * incoming
            rank = rank + delta
            active = delta.abs() > epsilon32 * rank.abs()
        it += 1
    if stats is not None:
        stats["iters"] = it
    return rank
