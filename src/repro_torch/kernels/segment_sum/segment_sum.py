"""Binding of the segment-sum kernel (``csrc/segment_sum.cu``).

``segment_sum`` sums float32 messages that come in a CSR's order over its
rows, 0 for a row with none. On a CUDA tensor it launches the kernel (a
partition, the sum and a two-kernel carry pass, on the current stream,
with no host sync) and adds one to ``segment_sum.launches``; on a CPU
tensor it computes the plain version in ``ref.py``; any other device
raises. There is no fallback from the kernel to the plain version.

The kernel's order of summation is fixed by the shapes alone, so a launch
repeats bit for bit; it is not ``index_add_``'s order, so its bits differ
from the plain version's on the card (``csrc/segment_sum.cu`` gives the
error bound).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum import ref

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
# csrc/segment_sum.cu's kTile (row ends and messages a block owns) and kGroup
# (tiles a block of the carry pass scans); the kernel refuses a scratch
# smaller than these give
TILE, GROUP = 3840, 1024


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its entry point, and a function from a device index to
    its current stream's handle, resolved once."""
    lib = _build.load("segment_sum")
    # attribute access caches the function object, so its argtypes stick
    fn = lib.segment_sum_f32
    fn.argtypes = [_vp, _vp, _i64, _vp, _i64, _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, fn, _build.stream_query()


def segment_sum(data: torch.Tensor, indptr: torch.Tensor, n: int) -> torch.Tensor:
    """``out[r] = sum(data[indptr[r]:indptr[r + 1]])`` -> ``(n,)`` float32.

    ``data`` is ``(E,)`` float32, ``indptr`` ``(n + 1,)`` int32 on the same
    device, non-decreasing from ``indptr[0] = 0`` to ``indptr[n] = E``.
    Offsets that do not end at E raise on the CPU; on the card they fail a
    device-side assert, which the next call that waits for the device
    raises (checking here would wait).
    """
    if data.dtype != torch.float32 or indptr.dtype != torch.int32:
        raise TypeError(f"data must be float32 and indptr int32, got {data.dtype}, "
                        f"{indptr.dtype}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if data.dim() != 1 or indptr.shape != (n + 1,):
        raise ValueError(f"data must be (E,) and indptr (n + 1,) = ({n + 1},), got "
                         f"{tuple(data.shape)}, {tuple(indptr.shape)}")
    if indptr.device != data.device:
        raise ValueError(f"indptr on {indptr.device}, data on {data.device}")
    if data.is_cpu:
        if int(indptr[0]) != 0 or int(indptr[n]) != data.shape[0]:
            raise ValueError(f"indptr must run from 0 to E = {data.shape[0]}, got "
                             f"{int(indptr[0])} to {int(indptr[n])}")
        return ref.segment_sum_ref(data, indptr, n)
    if not data.is_cuda:
        raise RuntimeError(f"no segment-sum kernel for device {data.device}")
    dev = data.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"data on {data.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    e = data.shape[0]
    if n == 0 or e == 0:
        return torch.zeros(n, dtype=torch.float32, device=data.device)
    data, indptr = data.contiguous(), indptr.contiguous()
    lib, fn, stream = _entry_points()
    out = torch.empty(n, dtype=torch.float32, device=data.device)
    # each tile's (row, message) start and its carry, the end's start, and
    # the carry pass's four words a group of tiles
    tiles = -(-(n + e) // TILE)
    scratch = torch.empty(12 * tiles + 8 + 16 * -(-tiles // GROUP), dtype=torch.uint8,
                          device=data.device)
    rc = fn(data.data_ptr(), indptr.data_ptr(), e, out.data_ptr(), n, scratch.data_ptr(),
            scratch.numel(), stream(dev))
    _build.check(lib, rc, "segment_sum kernel")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
