"""Bindings of the Hopper hot-gather kernels (``csrc/hot_gather.cu``).

``hot_gather_hot_part`` (K1) and ``hot_gather_segment_sum`` (K2) replace
the Pallas kernels of the same names in the JAX package;
``hot_gather_two_tier`` is K1 over the whole table in one launch (hot rows
and cold rows, each with its own L2 hint), the Hopper form of the JAX
package's two-tier ``ops.hot_gather``. On a CUDA tensor each launches its
kernel and adds one to its ``launches`` counter (both K1 entries count on
``hot_gather_hot_part.launches``); on a CPU tensor it computes the plain
version in ``ref.py``; any other device raises. There is no fallback from
the kernel to the plain version.

K1's launch path is kept lean, since at the serving cache's launches the
host's cost per call is most of the time: its entry points and the
current-stream query are resolved once, the checks are those that keep a
bad pointer, type or shape from the kernel, and a tensor on another device
than the current one raises instead of switching devices.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hot_gather import ref

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
INT32_MAX = 2**31 - 1

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("hot_gather")
    # attribute access caches the function object, so its argtypes stick
    # (lib["name"] would make a new one, passing pointers as 32-bit ints)
    for dt in DTYPES.values():
        k1, k2 = getattr(lib, f"hot_gather_{dt}"), getattr(lib, f"gather_segsum_{dt}")
        k1.argtypes = [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32, _vp]
        k2.argtypes = [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp]
        k1.restype = k2.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _entry_points():
    """The library's entry point per (kernel, dtype), and a function from a
    device index to its current stream's handle, resolved once."""
    lib = _lib()
    entries = {(kernel, dtype): getattr(lib, f"{kernel}_{name}")
               for kernel in ("hot_gather", "gather_segsum") for dtype, name in DTYPES.items()}
    return entries, _build.stream_query()


def _on_card(table: torch.Tensor, *index_arrays: torch.Tensor) -> bool:
    """Raise on inputs the kernels do not take. True where a kernel
    launches (CUDA tensors on the current device), False for the CPU's
    plain version."""
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, d), got shape {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported (float32, bfloat16)")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.shape[0] > INT32_MAX or table.shape[1] > INT32_MAX:
        raise ValueError("table dimensions must fit int32")
    for a in index_arrays:
        if a.dim() != 1 or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("index arrays must be contiguous 1-D int32")
    if table.is_cuda:
        dev = table.get_device()
        for a in index_arrays:
            if not a.is_cuda or a.get_device() != dev:
                raise ValueError(f"index array on {a.device}, table on {table.device}")
        if dev != torch.cuda.current_device():
            raise ValueError(f"table on {table.device}, but the current CUDA device is "
                             f"{torch.cuda.current_device()}")
        return True
    for a in index_arrays:
        if a.device != table.device:
            raise ValueError(f"index array on {a.device}, table on {table.device}")
    if not table.is_cpu:
        raise RuntimeError(f"no hot-gather kernel for device {table.device}")
    return False


def _launch_k1(table: torch.Tensor, idx: torch.Tensor, rank: Optional[torch.Tensor],
               h: int, n: int, cap: int, nan_past_n: int) -> torch.Tensor:
    """One K1 launch over checked inputs on the current device -> (E, d)."""
    e, d = idx.shape[0], table.shape[1]
    out = table.new_empty((e, d))
    if e * d == 0:
        return out
    entries, stream = _entry_points()
    rc = entries["hot_gather", table.dtype](
        table.data_ptr(), idx.data_ptr(), None if rank is None else rank.data_ptr(),
        out.data_ptr(), e, d, h, n, cap, nan_past_n, stream(table.get_device()))
    if rc:
        _build.check(_lib(), rc, "hot_gather kernel")
    hot_gather_hot_part.launches += 1
    return out


def hot_gather_hot_part(hot_table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: ``out[e] = hot_table[idx[e]]`` if ``0 <= idx[e] < H``, else zeros.

    ``hot_table`` is the ``(H, d)`` High Reuse Region (f32 or bf16), ``idx``
    the full ``(E,)`` int32 index stream, hot and cold.
    """
    if not _on_card(hot_table, idx):
        return ref.hot_gather_ref(hot_table, idx)
    h = hot_table.shape[0]
    return _launch_k1(hot_table, idx, None, h, h, 0, 0)


hot_gather_hot_part.launches = 0


def hot_gather_two_tier(table: torch.Tensor, idx: torch.Tensor, hot_size: int,
                        cold_rank: Optional[torch.Tensor] = None,
                        cold_capacity: int = 0) -> torch.Tensor:
    """K1 over the whole ``(N, d)`` table in one launch -> ``(E, d)``.

    ``out[e] = table[idx[e]]``: rows ``[0, hot_size)`` are read as hot (L2
    evict_last), rows ``[hot_size, N)`` as cold (L2 evict_first); a
    negative index gives zeros and one ``>= N`` gives NaN. With
    ``cold_rank``, the ``(E,)`` int32 inclusive count of indices
    ``>= hot_size`` up to each position, cold indices ranked past
    ``cold_capacity`` give zeros.
    """
    on_card = _on_card(table, idx) if cold_rank is None else _on_card(table, idx, cold_rank)
    if not 0 <= hot_size <= table.shape[0]:
        raise ValueError(f"hot_size must lie in [0, {table.shape[0]}], got {hot_size}")
    if cold_rank is not None and cold_rank.shape != idx.shape:
        raise ValueError(f"cold_rank has shape {tuple(cold_rank.shape)}, idx {tuple(idx.shape)}")
    if cold_capacity < 0:
        raise ValueError(f"cold_capacity must be >= 0, got {cold_capacity}")
    if not on_card:
        return ref.hot_gather_two_tier_ref(table, idx, hot_size, cold_rank, cold_capacity)
    return _launch_k1(table, idx, cold_rank, hot_size, table.shape[0],
                      min(cold_capacity, INT32_MAX), 1)


def hot_gather_segment_sum(
    hot_table: torch.Tensor,
    idx: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    tile_e: int = 2048,
    seg_per_tile: int = 256,
) -> torch.Tensor:
    """K2: fused hot gather + segment-sum -> ``(num_segments, d)`` float32.

    Requires the aligned layout of ``ops.build_aligned_edges``: tile ``i``
    (``tile_e`` edges) holds only destinations in
    ``[i*seg_per_tile, (i+1)*seg_per_tile)``, one tile per segment block;
    edges naming another block add nothing. Any order of a tile's edges
    gives the sum; the kernel is fastest on tiles sorted by destination
    (padding last), as the layout builds them. The result is deterministic.
    """
    on_card = _on_card(hot_table, idx, seg)
    e = idx.shape[0]
    if seg.shape[0] != e:
        raise ValueError(f"idx has {e} edges, seg has {seg.shape[0]}")
    if e % tile_e:
        raise ValueError(f"E={e} must be divisible by tile_e={tile_e}")
    num_tiles = e // tile_e
    if num_tiles * seg_per_tile != num_segments:
        raise ValueError(
            f"{num_tiles} tiles of {seg_per_tile} segments do not cover "
            f"num_segments={num_segments}: the fused path takes one tile per segment block"
        )
    if not on_card:
        return ref.gather_segment_sum_ref(hot_table, idx, seg, num_segments, tile_e,
                                          seg_per_tile)
    h, d = hot_table.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=hot_table.device)
    if num_tiles * d == 0:
        return out.zero_()
    entries, stream = _entry_points()
    rc = entries["gather_segsum", hot_table.dtype](
        hot_table.data_ptr(), idx.data_ptr(), seg.data_ptr(), out.data_ptr(),
        num_tiles, tile_e, seg_per_tile, d, h, stream(hot_table.get_device()))
    _build.check(_lib(), rc, "gather_segsum kernel")
    hot_gather_segment_sum.launches += 1
    return out


hot_gather_segment_sum.launches = 0
