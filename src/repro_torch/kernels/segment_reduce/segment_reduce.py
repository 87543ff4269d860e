"""Binding of the segment-reduce kernel (``csrc/segment_reduce.cu``).

``segment_stats`` takes float32 messages sorted by row and the rows'
offsets, and gives each row's sum of the messages, sum of their squares,
maximum and minimum, column by column, with a non-finite extreme zeroed:
what PNA's blocked layer aggregates. On a CUDA tensor it launches the
kernel (a partition, the reduction and a two-kernel carry pass, on the
current stream, with no host sync) and adds one to
``segment_stats.launches``; on a CPU tensor it computes the plain version
in ``ref.py``; any other device raises. There is no fallback from the
kernel to the plain version.

The kernel's order of summation is fixed by the shapes alone, so a launch
repeats bit for bit; it is not ``index_add_``'s, so the sums' bits differ
from the plain version's (``csrc/segment_reduce.cu`` gives the error
bound). The extremes are exact.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import ref

_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
MAX_WIDTH = 128  # csrc/segment_reduce.cu: at most 4 columns a lane


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its two entry points, and a function from a device index
    to its current stream's handle, resolved once."""
    lib = _build.load("segment_reduce")
    size = lib.segment_reduce_scratch_bytes
    size.argtypes = [_i64, _i64, _i32]
    size.restype = _i64
    fn = lib.segment_reduce_f32
    fn.argtypes = [_vp, _vp, _i64, _i64, _i32, _vp, _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, size, fn, _build.stream_query()


def segment_stats(m: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``(4, R, d)`` float32: for each row r, over ``m[offsets[r]:offsets[r +
    1]]``, the column sums of ``m`` and of ``m * m`` (0 for an empty row),
    then the column maxima and minima, 0 where not finite.

    ``m`` is ``(E, d)`` float32 and contiguous, ``offsets`` ``(R + 1,)``
    int32 on the same device, non-decreasing from 0 to E. Offsets that do
    not run from 0 to E raise on the CPU; on the card they fail a
    device-side assert, which the next call that waits for the device
    raises (checking here would wait).
    """
    if m.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError(f"m must be float32 and offsets int32, got {m.dtype}, {offsets.dtype}")
    if m.dim() != 2 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"m must be (E, d) and offsets (R + 1,), got {tuple(m.shape)}, "
                         f"{tuple(offsets.shape)}")
    if not m.is_contiguous():
        raise ValueError(f"m must be contiguous, got strides {m.stride()}")
    if offsets.device != m.device:
        raise ValueError(f"offsets on {offsets.device}, m on {m.device}")
    (e, d), r = m.shape, offsets.shape[0] - 1
    if m.is_cpu:
        if int(offsets[0]) != 0 or int(offsets[r]) != e:
            raise ValueError(f"offsets must run from 0 to E = {e}, got {int(offsets[0])} to "
                             f"{int(offsets[r])}")
        return ref.segment_stats_ref(m, offsets)
    if not m.is_cuda:
        raise RuntimeError(f"no segment-reduce kernel for device {m.device}")
    dev = m.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"m on {m.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if d > MAX_WIDTH:
        raise ValueError(f"the kernel takes rows of at most {MAX_WIDTH} floats, got {d}")
    if r == 0 or e == 0 or d == 0:
        return torch.zeros((4, r, d), dtype=torch.float32, device=m.device)
    offsets = offsets.contiguous()
    lib, size, fn, stream = _entry_points()
    out = torch.empty((4, r, d), dtype=torch.float32, device=m.device)
    scratch = torch.empty(size(r, e, d), dtype=torch.uint8, device=m.device)
    rc = fn(m.data_ptr(), offsets.data_ptr(), e, r, d, out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), stream(dev))
    _build.check(lib, rc, "segment_reduce kernel")
    segment_stats.launches += 1
    return out


segment_stats.launches = 0
