"""Binding of the softmax-aggregation kernel (``csrc/softmax_aggr.cu``).

``softmax_aggr`` computes, for every row of a destination-sorted CSR,
GENConv's input row plus its softmax aggregation: per channel, the softmax
of ``t q`` over the row's in-edges and its self loop, applied to ``q =
ReLU(u) + eps``. On CUDA tensors it launches the kernel (a partition, the
aggregation and a merge of the rows that span tiles, on the current stream,
with no host sync) and adds one to ``softmax_aggr.launches``; on CPU tensors
it computes the plain version in ``ref.py``; any other device raises. There
is no fallback from the kernel to the plain version: on the card, what the
kernel does not take raises.

The kernel's order of summation is fixed by the shapes alone, so a launch
repeats bit for bit; it is not the plain version's, so its bits differ from
it (``csrc/softmax_aggr.cu`` gives the error bound).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.softmax_aggr import ref

_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
WIDTH = 128  # the kernel's one instance: DeeperGCN's hidden width, 4 channels a lane


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its two entry points, and a function from a device index
    to its current stream's handle, resolved once."""
    lib = _build.load("softmax_aggr")
    size = lib.softmax_aggr_scratch_bytes
    size.argtypes = [_i64, _i64, _i32]
    size.restype = _i64
    fn = lib.softmax_aggr_f32
    fn.argtypes = [_vp, _vp, _i64, _vp, _vp, _i64, _i32, _i32, ctypes.c_double, ctypes.c_float,
                   _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, size, fn, _build.stream_query()


def softmax_aggr(indptr: torch.Tensor, src: torch.Tensor, u: torch.Tensor, hot_size: int,
                 t: float, eps: float) -> torch.Tensor:
    """``u + m`` (n, d) float32, ``m`` GENConv's softmax aggregation of
    ``ReLU(u) + eps`` over each row's in-edges and self loop.

    ``indptr`` ``(n + 1,)`` int32 from 0 to E and ``src`` ``(E,)`` int32 in
    [0, n) are the in-CSR; ``u`` is ``(n, d)`` float32. Rows ``[0,
    hot_size)`` of ``u`` load with an L2 evict_last policy on the card,
    where the kernel takes rows of ``WIDTH`` floats.
    """
    if indptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError(f"indptr and src must be int32, got {indptr.dtype} and {src.dtype}")
    n = indptr.shape[0] - 1
    if indptr.dim() != 1 or n < 0 or src.dim() != 1:
        raise ValueError(f"indptr must be (n + 1,) and src (E,), got {tuple(indptr.shape)}, "
                         f"{tuple(src.shape)}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    if u.dim() != 2 or u.shape[0] != n:
        raise ValueError(f"u must be ({n}, d), got {tuple(u.shape)}")
    if u.device != src.device or indptr.device != src.device:
        raise ValueError(f"u on {u.device}, indptr on {indptr.device}, src on {src.device}")
    if u.is_cpu:
        return ref.softmax_aggr_ref(indptr, src, u, t, eps)
    if not u.is_cuda:
        raise RuntimeError(f"no softmax aggregation kernel for device {u.device}")
    dev = u.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"u on {u.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if u.shape[1] != WIDTH:
        raise ValueError(f"the kernel takes rows of {WIDTH} floats, got {u.shape[1]}")
    u = u.contiguous()
    if u.data_ptr() % 16:
        raise ValueError("u's rows must be 16-byte aligned")
    out = torch.empty_like(u)
    if n == 0:
        return out
    lib, size, fn, stream = _entry_points()
    e = src.shape[0]
    indptr, src = indptr.contiguous(), src.contiguous()
    scratch = torch.empty(size(n, e, WIDTH), dtype=torch.uint8, device=u.device)
    rc = fn(indptr.data_ptr(), src.data_ptr(), e, u.data_ptr(), out.data_ptr(), n, WIDTH,
            max(0, min(int(hot_size), n)), float(t), float(eps), scratch.data_ptr(),
            scratch.numel(), stream(dev))
    _build.check(lib, rc, "softmax_aggr kernel")
    softmax_aggr.launches += 1
    return out


softmax_aggr.launches = 0
