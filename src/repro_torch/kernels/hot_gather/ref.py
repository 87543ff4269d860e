"""Plain PyTorch versions of the hot-gather kernels (K1 in its two modes, K2).

The wrappers in ``hot_gather.py`` take these for tensors on the CPU; on the
card they are what the kernels are held against.
"""
from __future__ import annotations

from typing import Optional

import torch


def hot_gather_ref(hot: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: ``(H, d)`` hot rows, ``(E,)`` int32 indices -> ``(E, d)``.

    Row ``e`` is ``hot[idx[e]]`` when ``0 <= idx[e] < H`` and zeros
    otherwise (cold, padding or negative indices).
    """
    h = hot.shape[0]
    hit = (idx >= 0) & (idx < h)
    if h == 0:
        return hot.new_zeros((idx.shape[0], hot.shape[1]))
    rows = hot.index_select(0, idx.clamp(0, h - 1))
    return torch.where(hit[:, None], rows, rows.new_zeros(()))


def hot_gather_two_tier_ref(table: torch.Tensor, idx: torch.Tensor, hot_size: int,
                            cold_rank: Optional[torch.Tensor] = None,
                            cold_capacity: int = 0) -> torch.Tensor:
    """K1's two-tier mode: ``(N, d)`` table, ``(E,)`` int32 indices -> ``(E, d)``.

    Row ``e`` is ``table[idx[e]]`` for ``0 <= idx[e] < N``, zeros for a
    negative index and NaN for one ``>= N``. With ``cold_rank`` (the
    inclusive count of indices ``>= hot_size`` up to each position), an
    index ``>= hot_size`` ranked past ``cold_capacity`` gives zeros.
    """
    n, d = table.shape
    keep = idx >= 0
    if cold_rank is not None:
        keep &= (idx < hot_size) | (cold_rank <= cold_capacity)
    if n == 0:
        rows = table.new_zeros((idx.shape[0], d))
    else:
        rows = table.index_select(0, idx.clamp(0, n - 1))
    rows = torch.where((idx >= n)[:, None], float("nan"), rows)
    return torch.where(keep[:, None], rows, rows.new_zeros(()))


def gather_segment_sum_ref(
    hot: torch.Tensor,
    idx: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    tile_e: int,
    seg_per_tile: int,
) -> torch.Tensor:
    """K2: fused hot gather + destination segment-sum -> ``(num_segments, d)`` f32.

    Edge ``e`` lies in tile ``e // tile_e`` and adds its hot row (zeros off
    the hot region) to output row ``seg[e]`` when that row belongs to the
    tile's segment block ``[i*seg_per_tile, (i+1)*seg_per_tile)``; edges
    naming another block are dropped, as in the one-hot product of the TPU
    kernel.
    """
    rows = hot_gather_ref(hot, idx).float()
    tile = torch.arange(idx.shape[0], device=idx.device) // tile_e
    local = seg.long() - tile * seg_per_tile
    keep = (local >= 0) & (local < seg_per_tile)
    out = torch.zeros((num_segments, hot.shape[1]), dtype=torch.float32, device=hot.device)
    return out.index_add_(0, seg[keep], rows[keep])
