"""Bindings of the Hopper hot-gather kernels (``csrc/hot_gather.cu``).

``hot_gather_hot_part`` (K1) and ``hot_gather_segment_sum`` (K2) replace
the Pallas kernels of the same names in the JAX package. On a CUDA tensor
each launches its kernel and adds one to its ``launches`` counter; on a CPU
tensor it computes the plain version in ``ref.py``; any other device
raises. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hot_gather import ref

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("hot_gather")
    # attribute access caches the function object, so its argtypes stick
    # (lib["name"] would make a new one, passing pointers as 32-bit ints)
    for dt in DTYPES.values():
        k1, k2 = getattr(lib, f"hot_gather_{dt}"), getattr(lib, f"gather_segsum_{dt}")
        k1.argtypes = [_vp, _vp, _vp, _i64, _i32, _i32, _vp]
        k2.argtypes = [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp]
        k1.restype = k2.restype = ctypes.c_int
    return lib


def _check_inputs(hot: torch.Tensor, *index_arrays: torch.Tensor) -> None:
    if hot.dim() != 2:
        raise ValueError(f"hot table must be (H, d), got shape {tuple(hot.shape)}")
    if hot.dtype not in DTYPES:
        raise TypeError(f"hot table dtype {hot.dtype} not supported (float32, bfloat16)")
    if not hot.is_contiguous():
        raise ValueError("hot table must be contiguous")
    for a in index_arrays:
        if a.dim() != 1 or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("index arrays must be contiguous 1-D int32")
        if a.device != hot.device:
            raise ValueError(f"index array on {a.device}, hot table on {hot.device}")
    if hot.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no hot-gather kernel for device {hot.device}")
    if hot.shape[0] >= 2**31 or hot.shape[1] >= 2**31:
        raise ValueError("hot table dimensions must fit int32")


def hot_gather_hot_part(hot_table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: ``out[e] = hot_table[idx[e]]`` if ``0 <= idx[e] < H``, else zeros.

    ``hot_table`` is the ``(H, d)`` High Reuse Region (f32 or bf16), ``idx``
    the full ``(E,)`` int32 index stream, hot and cold.
    """
    _check_inputs(hot_table, idx)
    if hot_table.device.type == "cpu":
        return ref.hot_gather_ref(hot_table, idx)
    h, d = hot_table.shape
    e = idx.shape[0]
    out = torch.empty((e, d), dtype=hot_table.dtype, device=hot_table.device)
    if e * d == 0:
        return out
    lib = _lib()
    with torch.cuda.device(hot_table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"hot_gather_{DTYPES[hot_table.dtype]}")(
            hot_table.data_ptr(), idx.data_ptr(), out.data_ptr(), e, d, h, stream)
    _build.check(lib, rc, "hot_gather kernel")
    hot_gather_hot_part.launches += 1
    return out


hot_gather_hot_part.launches = 0


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
    ``[i*seg_per_tile, (i+1)*seg_per_tile)``, one tile per segment block.
    """
    _check_inputs(hot_table, idx, seg)
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
    if hot_table.device.type == "cpu":
        return ref.gather_segment_sum_ref(hot_table, idx, seg, num_segments, tile_e,
                                          seg_per_tile)
    h, d = hot_table.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=hot_table.device)
    if num_tiles * d == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(hot_table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"gather_segsum_{DTYPES[hot_table.dtype]}")(
            hot_table.data_ptr(), idx.data_ptr(), seg.data_ptr(), out.data_ptr(),
            num_tiles, tile_e, seg_per_tile, d, h, stream)
    _build.check(lib, rc, "gather_segsum kernel")
    hot_gather_segment_sum.launches += 1
    return out


hot_gather_segment_sum.launches = 0
