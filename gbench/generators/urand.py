"""GAP's uniform random (Erdos-Renyi) edge generator, on the device:
``edge_factor * 2**scale`` edges, both endpoints uniform over the vertices."""
from __future__ import annotations

import torch


def edges(cfg: dict, gen: torch.Generator, device: torch.device):
    """``(src, dst)``: two int32 tensors of ``edge_factor * 2**scale`` vertex ids."""
    n, m = 1 << cfg["scale"], cfg["edge_factor"] << cfg["scale"]
    src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    return src, dst
