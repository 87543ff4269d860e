"""Binding of the Hopper embedding-bag kernel (``csrc/embedding_bag.cu``).

``hot_bag_hot_part`` (K3) replaces the Pallas kernel of the same name in
the JAX package. On a CUDA tensor it launches the kernel and adds one to
its ``launches`` counter; on a CPU tensor it computes the plain version in
``ref.py``; any other device raises. There is no fallback from the kernel
to the plain version.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ref

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    # attribute access caches the function object, so its argtypes stick
    for dt in DTYPES.values():
        fn = getattr(lib, f"hot_bag_{dt}")
        fn.argtypes = [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp]
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(hot: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> None:
    if hot.dim() != 2:
        raise ValueError(f"hot table must be (H_rows, d), got shape {tuple(hot.shape)}")
    if hot.dtype not in DTYPES:
        raise TypeError(f"hot table dtype {hot.dtype} not supported (float32, bfloat16)")
    if not hot.is_contiguous():
        raise ValueError("hot table must be contiguous")
    if ids.dim() != 2 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (B, H) int32 tensor")
    if mask.shape != ids.shape or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool tensor shaped like ids")
    for name, a in (("ids", ids), ("mask", mask)):
        if a.device != hot.device:
            raise ValueError(f"{name} on {a.device}, hot table on {hot.device}")
    if hot.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no embedding-bag kernel for device {hot.device}")
    if max(hot.shape) >= 2**31 or ids.shape[1] >= 2**31:
        raise ValueError("hot table dimensions and bag length must fit int32")


def hot_bag_hot_part(hot_table: torch.Tensor, ids: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """K3: ``(B, d)`` float32, bag ``b`` the sum of ``hot_table[ids[b, h]]``
    over the positions with ``mask[b, h]`` and ``0 <= ids[b, h] < H_rows``.

    ``hot_table`` is the ``(H_rows, d)`` hot prefix (f32 or bf16), ``ids``
    the ``(B, H)`` int32 bags, hot and cold, ``mask`` their bool mask.
    """
    _check_inputs(hot_table, ids, mask)
    if hot_table.device.type == "cpu":
        return ref.hot_bag_ref(hot_table, ids, mask)
    h, d = hot_table.shape
    b, hlen = ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=hot_table.device)
    if b * d == 0:
        return out
    # 16-byte slices need 16-byte aligned rows: d a multiple of 4 f32 or 8 bf16
    per = 16 // hot_table.element_size()
    vec = int(d % per == 0 and hot_table.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(hot_table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"hot_bag_{DTYPES[hot_table.dtype]}")(
            hot_table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, hlen, d, h, vec, stream)
    _build.check(lib, rc, "hot_bag kernel")
    hot_bag_hot_part.launches += 1
    return out


hot_bag_hot_part.launches = 0
