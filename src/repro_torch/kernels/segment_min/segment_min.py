"""Binding of the segment-min kernel (``csrc/segment_min.cu``).

``segment_min`` is the minimum of float32 messages per segment id, +inf
for a segment with none. On a CUDA tensor it launches the kernel and adds
one to ``segment_min.launches``; on a CPU tensor it computes the plain
version in ``ref.py``; any other device raises. There is no fallback from
the kernel to the plain version. The ids are int32, as a CSR's targets are.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_min import ref

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its entry point, and a function from a device index to
    its current stream's handle, resolved once."""
    lib = _build.load("segment_min")
    # attribute access caches the function object, so its argtypes stick
    fn = lib.segment_min_f32_i32
    fn.argtypes = [_vp, _vp, _i64, _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, fn, _build.stream_query()


def segment_min(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s] = min(+inf, min{data[e] : seg[e] == s})`` -> ``(n,)`` float32.

    ``data`` is ``(E,)`` float32, ``seg`` ``(E,)`` int32 on the same
    device. A NaN message makes its segment NaN. The result is the
    plain version's bit for bit on inputs without NaN and without both
    signed zeros in one segment. An id outside ``[0, n)`` raises on the CPU;
    on the card a live message's fails a device-side assert, which the next
    call that waits for the device raises (checking here would wait).
    """
    if data.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"data must be float32 and seg int32, got {data.dtype}, {seg.dtype}")
    if data.dim() != 1 or seg.shape != data.shape:
        raise ValueError(f"data and seg must both be (E,), got {tuple(data.shape)}, "
                         f"{tuple(seg.shape)}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if seg.device != data.device:
        raise ValueError(f"seg on {seg.device}, data on {data.device}")
    if data.is_cpu:
        return ref.segment_min_ref(data, seg, n)
    if not data.is_cuda:
        raise RuntimeError(f"no segment-min kernel for device {data.device}")
    dev = data.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"data on {data.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    data, seg = data.contiguous(), seg.contiguous()
    out = torch.full((n,), float("inf"), dtype=torch.float32, device=data.device)
    e = data.shape[0]
    if e == 0:
        return out
    lib, fn, stream = _entry_points()
    rc = fn(data.data_ptr(), seg.data_ptr(), e, out.data_ptr(), n, stream(dev))
    _build.check(lib, rc, "segment_min kernel")
    segment_min.launches += 1
    return out


segment_min.launches = 0
