"""The route into the GAT attention kernel: one matrix product gives a
layer's rows, both scores and its skip.

The scores are linear in the rows (``s_src = <z_k, a_src_k>`` with ``z = h
W``), so ``W``'s columns folded with the attention vectors are columns of
the same product: ``h [W | W a_src | W a_dst | W_skip]`` is one SGEMM, and
the kernel reads ``z`` and the scores as views into it, at its row stride.
The product's width is padded to a multiple of 4 floats, so that the views'
rows stay 16-byte aligned for the kernel's loads.
"""
from __future__ import annotations

import torch


def packed_weight(lp: dict) -> torch.Tensor:
    """``[W | W a_src | W a_dst | W_skip | 0]``: (d_in, H·C + 2H + d_skip +
    pad) from a layer's ``lin``, ``att_src``, ``att_dst`` and ``skip``."""
    w = lp["lin"]["w"]
    heads, c = lp["att_src"].shape
    per_head = w.view(w.shape[0], heads, c)
    cols = [w, (per_head * lp["att_src"]).sum(-1), (per_head * lp["att_dst"]).sum(-1),
            lp["skip"]["w"]]
    width = sum(t.shape[1] for t in cols)
    cols.append(w.new_zeros((w.shape[0], -width % 4)))
    return torch.cat(cols, dim=1)


def project(h: torch.Tensor, lp: dict):
    """``(z, s_src, s_dst, skip)`` of one layer: views into ``h @
    packed_weight(lp)``, ``skip`` without its bias."""
    heads, c = lp["att_src"].shape
    width = heads * c
    out = torch.matmul(h, packed_weight(lp))
    d_skip = lp["skip"]["w"].shape[1]
    return (out[:, :width], out[:, width:width + heads], out[:, width + heads:width + 2 * heads],
            out[:, width + 2 * heads:width + 2 * heads + d_skip])
