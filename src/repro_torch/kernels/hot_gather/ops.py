"""The full GRASP two-tier gather: the hot-region kernel plus the bounded
cold fixup, and the aligned layout of the fused gather + segment-sum.

Cold fixup: indices >= hot_size are compacted into a capacity-bounded
buffer (skew guarantees the cold fraction is small — paper Table I: hot
vertices cover 81-93% of edges), gathered from device memory once, and
scattered back. ``cold_capacity`` bounds that traffic; on no-skew inputs
callers size it at E (graceful degradation, paper Fig. 9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.hot_gather.hot_gather import (
    hot_gather_hot_part,
    hot_gather_segment_sum,
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
    ``>= N`` gives a NaN row; cold indices past the first ``cold_capacity``
    give zero rows. The compaction synchronises with the device (its size
    comes from the data).
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

    out = hot_gather_hot_part(table[:hot_size], idx)

    # --- bounded cold fixup: the first cold_capacity cold indices, in order ---
    cold_pos = torch.nonzero(idx >= hot_size).squeeze(1)[:cold_capacity]
    if cold_pos.numel():
        cold_idx = idx[cold_pos]
        rows = table.index_select(0, cold_idx.clamp(max=n - 1))
        rows = torch.where((cold_idx >= n)[:, None], float("nan"), rows)
        out.index_copy_(0, cold_pos, rows)
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
