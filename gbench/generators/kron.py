"""Graph500's Kronecker edge generator, on the device.

Each of the ``edge_factor * 2**scale`` edges picks one quadrant of the
adjacency matrix per level, ``scale`` levels deep, with probabilities A, B,
C and 1 - A - B - C (Graph500's ``kronecker_generator.m``: the row bit is
set with probability 1 - (A + B), then the column bit with probability
1 - C / (1 - (A + B)) under a set row bit and 1 - A / (A + B) under a
clear one). The labels are left unpermuted here: ``graphs.make`` permutes
them from the run's seed, as Graph500 does after generating.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 26  # edges drawn at a time: bounds the temporaries to a few hundred MB


def edges(cfg: dict, gen: torch.Generator, device: torch.device):
    """``(src, dst)``: two int32 tensors of ``edge_factor * 2**scale`` vertex ids."""
    scale, m = cfg["scale"], cfg["edge_factor"] << cfg["scale"]
    a, b, c = cfg["A"], cfg["B"], cfg["C"]
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for lo in range(0, m, CHUNK):
        n = min(CHUNK, m - lo)
        s, d = src[lo:lo + n], dst[lo:lo + n]
        for level in range(scale):
            ii = torch.rand(n, generator=gen, device=device) > ab
            thresh = torch.where(ii, c_norm, a_norm)
            jj = torch.rand(n, generator=gen, device=device) > thresh
            s |= ii.to(torch.int32) << level
            d |= jj.to(torch.int32) << level
    return src, dst
