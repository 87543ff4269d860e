"""Radii Estimation via multiple parallel bit-BFS (paper Table III: Radii).

Runs K simultaneous BFS's from sampled roots using per-vertex K-bit visit
masks (Magnien et al.). A vertex's estimated radius is the last iteration
in which its mask changed — a lower bound on eccentricity.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.apps.engine import or_reduce
from repro_torch.graph.csr import DeviceCSR


def radii_estimate(
    g: DeviceCSR,
    sample_roots,  # (K<=32,) int vertex ids
    max_iters: int = 64,
    stats: Optional[dict] = None,
):
    """Returns (radii int32, visit_mask uint32) on ``g``'s device. ``g`` =
    in-edge CSR (pull traversal).

    The masks are held in int64 (torch has no shifts or reductions for
    uint32 on the CPU) and cast to uint32 on return; bit 31 survives. A
    host loop runs while ``changed & (it < max_iters)``, one read of the
    flag an iteration. ``stats``, when given, receives ``iters``.
    """
    n = g.num_nodes
    dev = g.indices.device
    roots = torch.as_tensor(sample_roots, device=dev).long()
    shifts = torch.arange(roots.shape[0], dtype=torch.int64, device=dev)
    mask = torch.zeros((n,), dtype=torch.int64, device=dev)
    mask[roots] = 1 << shifts

    # widened once: an int32 index is widened on every gather and reduction
    src, dst = g.indices.long(), g.dst.long()

    # Bitwise-OR has no segment primitive; decompose into K bit planes,
    # each reduced with a segment max, then repack. (E,K) -> (N,K).
    def or_pull(mask):
        nbr_bits = (mask[src].unsqueeze(1) >> shifts) & 1
        agg = or_reduce(nbr_bits, dst, n).to(torch.int64)
        return (agg << shifts).sum(dim=1)

    radii = torch.zeros((n,), dtype=torch.int32, device=dev)
    it, changed = 0, True
    while changed and it < max_iters:
        new_mask = mask | or_pull(mask)
        diff = new_mask != mask
        radii = torch.where(diff, it + 1, radii)
        mask = new_mask
        it += 1
        changed = bool(diff.any())
    if stats is not None:
        stats["iters"] = it
    return radii, mask.to(torch.uint32)
