"""PageRank (paper Table III: PR) — iterative pull-based."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.engine import edge_map_pull, sum_reduce
from repro_torch.graph.csr import DeviceCSR


def pagerank(
    g: DeviceCSR,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 100,
    gather_impl: str = "hot",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Ranks of ``g``'s vertices, float32 on ``g``'s device.

    A host loop runs while ``(err > tol*n) & (it < max_iters)``, the
    condition of the JAX package's ``while_loop``; reading ``err`` each
    iteration synchronises with the device. ``stats``, when given, receives
    ``iters``, the number of iterations run.
    """
    n = g.num_nodes
    out_deg = sum_reduce(torch.ones(g.indices.shape, dtype=torch.float32,
                                    device=g.indices.device), g.indices, n)
    safe_deg = torch.clamp(out_deg, min=1.0)
    dangling_mask = out_deg == 0
    # damping and tol are float32 scalars in the JAX package's jitted loop
    f32 = np.float32
    base = float((f32(1.0) - f32(damping)) / f32(n))
    threshold = float(f32(tol) * f32(n))

    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.indices.device)
    err, it = float("inf"), 0
    while err > threshold and it < max_iters:
        contrib = rank / safe_deg
        # dangling mass redistributed uniformly (matches networkx)
        dangling = torch.where(dangling_mask, rank, 0.0).sum()
        incoming = edge_map_pull(g, contrib, reduce_fn=sum_reduce,
                                 gather_impl=gather_impl)
        new_rank = base + damping * (incoming + dangling / n)
        err = float(torch.abs(new_rank - rank).sum())
        rank, it = new_rank, it + 1
    if stats is not None:
        stats["iters"] = it
    return rank
