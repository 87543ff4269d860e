"""Binding of the GAT attention kernel (``csrc/gat_attend.cu``).

``gat_attend`` computes, for every row of a destination-sorted CSR and every
head, the softmax of the LeakyReLU scores over the row's in-edges and its
self loop and the weighted sum of the neighbours' rows of ``z``. On CUDA
tensors it launches the kernel (a partition, the attention and a merge of
the rows that span tiles, on the current stream, with no host sync) and adds
one to ``gat_attend.launches``; on CPU tensors it computes the plain version
in ``ref.py``; any other device raises. There is no fallback from the kernel
to the plain version: on the card, what the kernel does not take raises.

The kernel's order of summation is fixed by the shapes alone, so a launch
repeats bit for bit; it is not the plain version's, so its bits differ from
it (``csrc/gat_attend.cu`` gives the error bound).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gat_attend import ref

_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
# the kernel's instances: GAT's 4 heads, rows of 129-256 floats (its last
# layer's 188) and of 257-512 (its 512), a multiple of 4
HEADS = 4
MIN_WIDTH, MAX_WIDTH = 129, 512


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its two entry points, and a function from a device index
    to its current stream's handle, resolved once."""
    lib = _build.load("gat_attend")
    size = lib.gat_attend_scratch_bytes
    size.argtypes = [_i64, _i64, _i32, _i32]
    size.restype = _i64
    fn = lib.gat_attend_f32
    fn.argtypes = [_vp, _vp, _i64, _vp, _i64, _vp, _i64, _vp, _i64, _vp, _i64, _i32, _i32,
                   _i32, ctypes.c_float, _i32, _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, size, fn, _build.stream_query()


def _rows_of(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != n or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name} must be ({n}, width) with unit column stride, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")


def gat_attend(indptr: torch.Tensor, src: torch.Tensor, z: torch.Tensor, s_src: torch.Tensor,
               s_dst: torch.Tensor, hot_size: int, negative_slope: float,
               mean: bool) -> torch.Tensor:
    """GAT's attention: ``(n, H·C)`` with the heads concatenated, or ``(n,
    C)`` averaged when ``mean``.

    ``indptr`` ``(n + 1,)`` int32 from 0 to E and ``src`` ``(E,)`` int32 in
    [0, n) are the in-CSR; ``z`` is ``(n, H·C)`` float32, ``s_src`` and
    ``s_dst`` ``(n, H)`` float32, each with unit column stride and any row
    stride (views into one matrix product's output). Rows ``[0,
    hot_size)`` of ``z`` load with an L2 evict_last policy on the card,
    where the kernel takes ``HEADS`` heads and rows of ``MIN_WIDTH`` to
    ``MAX_WIDTH`` floats, a multiple of 4.
    """
    if indptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError(f"indptr and src must be int32, got {indptr.dtype} and {src.dtype}")
    n = indptr.shape[0] - 1
    if indptr.dim() != 1 or n < 0 or src.dim() != 1:
        raise ValueError(f"indptr must be (n + 1,) and src (E,), got {tuple(indptr.shape)}, "
                         f"{tuple(src.shape)}")
    for name, t in (("z", z), ("s_src", s_src), ("s_dst", s_dst)):
        _rows_of(name, t, n)
        if t.device != src.device or indptr.device != src.device:
            raise ValueError(f"{name} on {t.device}, indptr on {indptr.device}, src on "
                             f"{src.device}")
    heads, width = s_src.shape[1], z.shape[1]
    if s_dst.shape[1] != heads or heads < 1 or width % heads != 0:
        raise ValueError(f"s_src and s_dst must be (n, H) with H dividing z's width {width}, "
                         f"got {tuple(s_src.shape)}, {tuple(s_dst.shape)}")
    if z.is_cpu:
        return ref.gat_attend_ref(indptr, src, z, s_src, s_dst, negative_slope, mean)
    if not z.is_cuda:
        raise RuntimeError(f"no GAT attention kernel for device {z.device}")
    dev = z.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"z on {z.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if heads != HEADS or not MIN_WIDTH <= width <= MAX_WIDTH or width % 4:
        raise ValueError(f"the kernel takes {HEADS} heads and rows of {MIN_WIDTH} to "
                         f"{MAX_WIDTH} floats, a multiple of 4, got {heads} heads of width "
                         f"{width}")
    out = torch.empty((n, width // heads if mean else width), dtype=torch.float32,
                      device=z.device)
    if n == 0:
        return out
    lib, size, fn, stream = _entry_points()
    e = src.shape[0]
    indptr, src = indptr.contiguous(), src.contiguous()
    scratch = torch.empty(size(n, e, heads, width), dtype=torch.uint8, device=z.device)
    rc = fn(indptr.data_ptr(), src.data_ptr(), e, z.data_ptr(), z.stride(0), s_src.data_ptr(),
            s_src.stride(0), s_dst.data_ptr(), s_dst.stride(0), out.data_ptr(), n, heads, width,
            max(0, min(int(hot_size), n)), float(negative_slope), int(bool(mean)),
            scratch.data_ptr(), scratch.numel(), stream(dev))
    _build.check(lib, rc, "gat_attend kernel")
    gat_attend.launches += 1
    return out


gat_attend.launches = 0
