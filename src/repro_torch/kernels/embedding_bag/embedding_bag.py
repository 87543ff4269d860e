"""Binding of the Hopper embedding-bag kernel (``csrc/embedding_bag.cu``).

``hot_bag_hot_part`` (K3) replaces the Pallas kernel of the same name in
the JAX package; ``hot_bag_two_tier`` is K3 over the whole table in one
launch (hot rows and cold rows, each with its own L2 hint and its own
float32 sum), the Hopper form of the JAX package's ``ops.hot_bag``. On a
CUDA tensor each launches the kernel and adds one to
``hot_bag_hot_part.launches``; on a CPU tensor it computes the plain
version in ``ref.py``; any other device raises. There is no fallback from
the kernel to the plain version.

The launch path is kept lean, as K1's is: the entry points and the
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
from repro_torch.kernels.embedding_bag import ref

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
INT32_MAX = 2**31 - 1

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    # attribute access caches the function object, so its argtypes stick
    for dt in DTYPES.values():
        fn = getattr(lib, f"hot_bag_{dt}")
        fn.argtypes = [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32, _i32, _vp]
        fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _entry_points():
    """The library's entry point per dtype, and a function from a device
    index to its current stream's handle, resolved once."""
    lib = _lib()
    entries = {dtype: getattr(lib, f"hot_bag_{name}") for dtype, name in DTYPES.items()}
    return entries, _build.stream_query()


def _on_card(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
             rank: Optional[torch.Tensor] = None) -> bool:
    """Raise on inputs the kernel does not take. True where the kernel
    launches (CUDA tensors on the current device), False for the CPU's
    plain version."""
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, d), got shape {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported (float32, bfloat16)")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if ids.dim() != 2 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (B, H) int32 tensor")
    if mask.shape != ids.shape or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool tensor shaped like ids")
    if rank is not None and (rank.shape != ids.shape or rank.dtype != torch.int32
                             or not rank.is_contiguous()):
        raise ValueError("cold_rank must be a contiguous int32 tensor shaped like ids")
    if max(table.shape) > INT32_MAX or ids.shape[1] > INT32_MAX:
        raise ValueError("table dimensions and bag length must fit int32")
    others = (ids, mask) if rank is None else (ids, mask, rank)
    for a in others:
        if a.device != table.device:
            raise ValueError(f"ids, mask and ranks on {a.device}, table on {table.device}")
    if table.is_cuda:
        if table.get_device() != torch.cuda.current_device():
            raise ValueError(f"table on {table.device}, but the current CUDA device is "
                             f"{torch.cuda.current_device()}")
        return True
    if not table.is_cpu:
        raise RuntimeError(f"no embedding-bag kernel for device {table.device}")
    return False


def _launch(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
            rank: Optional[torch.Tensor], h: int, v: int, cap: int,
            nan_past_v: int) -> torch.Tensor:
    """One K3 launch over checked inputs on the current device -> (B, d) f32."""
    (b, hlen), d = ids.shape, table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b * d == 0:
        return out
    entries, stream = _entry_points()
    rc = entries[table.dtype](
        table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
        None if rank is None else rank.data_ptr(), out.data_ptr(),
        b, hlen, d, h, v, cap, nan_past_v, stream(table.get_device()))
    if rc:
        _build.check(_lib(), rc, "hot_bag kernel")
    hot_bag_hot_part.launches += 1
    return out


def hot_bag_hot_part(hot_table: torch.Tensor, ids: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """K3: ``(B, d)`` float32, bag ``b`` the sum of ``hot_table[ids[b, h]]``
    over the positions with ``mask[b, h]`` and ``0 <= ids[b, h] < H_rows``.

    ``hot_table`` is the ``(H_rows, d)`` hot prefix (f32 or bf16), ``ids``
    the ``(B, H)`` int32 bags, hot and cold, ``mask`` their bool mask.
    """
    if not _on_card(hot_table, ids, mask):
        return ref.hot_bag_ref(hot_table, ids, mask)
    h = hot_table.shape[0]
    return _launch(hot_table, ids, mask, None, h, h, 0, 0)


hot_bag_hot_part.launches = 0


def hot_bag_two_tier(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                     hot_size: int, cold_rank: Optional[torch.Tensor] = None,
                     cold_capacity: int = 0) -> torch.Tensor:
    """K3 over the whole ``(V, d)`` table in one launch -> ``(B, d)`` float32.

    Bag ``b`` is ``hot_sum + cold_sum``, each summed in float32 one
    position after the other: ``hot_sum`` over the masked-in ids in
    ``[0, hot_size)`` (L2 evict_last), ``cold_sum`` over those in
    ``[hot_size, V)`` (L2 evict_first) plus a NaN for each one ``>= V``. A
    negative or masked-out id adds nothing. With ``cold_rank``, the
    ``(B, H)`` int32 inclusive count of masked-in ids ``>= hot_size`` up to
    each position in flat order, cold ids ranked past ``cold_capacity`` add
    nothing.
    """
    on_card = _on_card(table, ids, mask, cold_rank)
    if not 0 <= hot_size <= table.shape[0]:
        raise ValueError(f"hot_size must lie in [0, {table.shape[0]}], got {hot_size}")
    if cold_capacity < 0:
        raise ValueError(f"cold_capacity must be >= 0, got {cold_capacity}")
    if not on_card:
        return ref.hot_bag_two_tier_ref(table, ids, mask, hot_size, cold_rank, cold_capacity)
    return _launch(table, ids, mask, cold_rank, hot_size, table.shape[0],
                   min(cold_capacity, INT32_MAX), 1)
