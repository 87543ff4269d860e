"""The full GRASP two-tier gather, and the aligned layout of the fused
gather + segment-sum.

On the TPU the hot block sat in VMEM and the cold rows in HBM, so the JAX
package gathers the hot part in its kernel and fixes the cold indices up
in a second, capacity-bounded pass (skew keeps the cold fraction small —
paper Table I: hot vertices cover 81-93% of edges; ``cold_capacity``
bounds that traffic, and callers size it at E on no-skew inputs, paper
Fig. 9). On the card both tiers lie in one device memory and differ only
in their L2 hint, so one launch of K1 reads both (``hot_gather_two_tier``).
The capacity rule needs each cold index's rank in flat order, which a
device-side scan gives, as the JAX package computes it: no host sync.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.hot_gather.hot_gather import (
    hot_gather_segment_sum,
    hot_gather_two_tier,
)


def hot_gather(
    prop: torch.Tensor,        # (N, d) or (N,)
    idx: torch.Tensor,         # (E,) int32
    hot_size: Optional[int] = None,
    cold_capacity: Optional[int] = None,
) -> torch.Tensor:
    """``prop[idx]`` through the hot-region kernel, shaped ``(E, d)`` or ``(E,)``.

    Semantics kept from the JAX package's ``ops.hot_gather``: an index in
    ``[0, N)`` gives its row; a negative index gives a zero row; an index
    ``>= N`` gives a NaN row; cold indices (``>= hot_size``) past the first
    ``cold_capacity``, in flat order, give zero rows. One K1 launch, plus a
    scan of the cold mask when ``cold_capacity < E``; no host sync.
    """
    if prop.dim() not in (1, 2):
        raise ValueError(f"prop must be (N,) or (N, d), got shape {tuple(prop.shape)}")
    table = prop.view(-1, 1) if prop.dim() == 1 else prop
    n = table.shape[0]
    e = idx.shape[0]
    if hot_size is None:
        hot_size = min(n, 1 << 20)
    hot_size = min(hot_size, n)
    if cold_capacity is None:
        cold_capacity = e  # exact by default; plans shrink it via skew
    if cold_capacity < 0:
        raise ValueError(f"cold_capacity must be >= 0, got {cold_capacity}")

    # inclusive rank of each cold index in flat order (the JAX package's pos + 1)
    rank = (torch.cumsum(idx >= hot_size, 0, dtype=torch.int32)
            if cold_capacity < e else None)
    out = hot_gather_two_tier(table, idx, hot_size, rank, cold_capacity)
    return out.view(e) if prop.dim() == 1 else out


def build_aligned_edges(indptr: np.ndarray, indices: np.ndarray,
                        seg_per_tile: int, tile_e: int):
    """Host-side layout pass: pack CSR edges into tiles such that tile i only
    contains destinations [i*seg_per_tile, (i+1)*seg_per_tile), padding with
    idx=-1. Returns (idx_tiles, seg_tiles, num_segments_padded)."""
    n = indptr.shape[0] - 1
    n_pad = (n + seg_per_tile - 1) // seg_per_tile * seg_per_tile
    n_tiles = n_pad // seg_per_tile
    out_idx, out_seg = [], []
    for t in range(n_tiles):
        lo_v, hi_v = t * seg_per_tile, min((t + 1) * seg_per_tile, n)
        sl = slice(indptr[lo_v], indptr[hi_v])
        e_idx = indices[sl]
        e_seg = np.repeat(
            np.arange(lo_v, hi_v), np.diff(indptr[lo_v : hi_v + 1])
        )
        # split oversized tiles into multiple chunks of tile_e
        for off in range(0, max(len(e_idx), 1), tile_e):
            chunk_i = e_idx[off : off + tile_e]
            chunk_s = e_seg[off : off + tile_e]
            pad = tile_e - len(chunk_i)
            out_idx.append(np.pad(chunk_i, (0, pad), constant_values=-1))
            out_seg.append(np.pad(chunk_s, (0, pad), constant_values=lo_v))
    return (
        np.concatenate(out_idx).astype(np.int32),
        np.concatenate(out_seg).astype(np.int32),
        n_pad,
    )


def hot_gather_segsum_aligned(
    hot_table: torch.Tensor,
    idx_tiles: torch.Tensor,
    seg_tiles: torch.Tensor,
    num_segments: int,
    seg_per_tile: int,
    tile_e: int = 2048,
) -> torch.Tensor:
    """Fused hot gather + segment-sum over a pre-aligned edge layout.

    Rows of ``hot_table`` are the hot region: edges whose source lies past
    it contribute nothing (there is no cold fixup on this path). The fused
    path takes one tile per segment block and raises on a layout where an
    oversized vertex range spilled into more tiles; callers with heavy-hub
    tiles use ``hot_gather`` + a segment-sum.
    """
    return hot_gather_segment_sum(
        hot_table, idx_tiles, seg_tiles, num_segments,
        tile_e=tile_e, seg_per_tile=seg_per_tile,
    )
