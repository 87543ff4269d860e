"""Binding of SSSP's relaxation kernels (``csrc/segment_min.cu``).

``relax_min`` runs one Bellman-Ford iteration over an out-CSR in place: the
active rows' out-edges are relaxed into the targets' keys, then every
vertex is settled. On CUDA tensors it launches the kernels and adds one to
``relax_min.launches``; on CPU tensors it computes the plain version in
``ref.py``; any other device raises. There is no fallback from the kernels
to the plain version.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.graph.csr import out_degree_sum
from repro_torch.kernels import _build
from repro_torch.kernels.segment_min import ref

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
TILE = 3840  # csrc/segment_min.cu's kRelaxTile: row ends + edges a block owns


@lru_cache(maxsize=None)
def _entry_points():
    """The library, its entry point, and a function from a device index to
    its current stream's handle, resolved once."""
    lib = _build.load("segment_min")
    fn = lib.relax_min_f32_i32
    fn.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i64, _vp, _vp, _vp, _i64, _vp]
    fn.restype = ctypes.c_int
    return lib, fn, _build.stream_query()


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, indices on {device}")


def relax_min(indptr: torch.Tensor, indices: torch.Tensor, weights, dist: torch.Tensor,
              active: torch.Tensor, keys: torch.Tensor, flag: torch.Tensor,
              relaxed: torch.Tensor) -> None:
    """One Jacobi iteration of Bellman-Ford over the out-CSR ``(indptr,
    indices, weights)``, in place.

    ``best[v]`` is the least ``dist[u] + weights[e]`` over the out-edges of
    the active rows ``u`` into ``v`` (+inf where none; weights of 1 where
    ``weights`` is None), from ``dist`` as it was on entry; then ``active =
    best < dist`` and ``dist = minimum(dist, best)``, NaN where either is.
    ``flag[0]`` becomes 1 if a vertex is active, else 0, and ``relaxed[0]``
    grows by the out-degrees of the rows that were active.

    ``indptr`` is ``(n + 1,)`` int32 from 0 to E, ``indices`` ``(E,)``
    int32, ``weights`` ``(E,)`` float32 or None, ``dist`` ``(n,)`` float32,
    ``active`` ``(n,)`` bool, ``keys`` ``(n,)`` int32 holding +inf's bits
    (``0x7f800000``), as the call leaves them; ``flag`` one int32,
    ``relaxed`` one int64; all on one device, the updated ones contiguous.
    The distances are the plain version's bit for bit on inputs without NaN
    and without both signed zeros among one target's candidates. On the
    CPU the plain version leaves ``keys`` as they are, and a target outside
    ``[0, n)`` raises; on the card an active row's fails a device-side
    assert, which the next call that waits for the device raises. The
    kernels never read an inactive row's targets or weights.
    """
    if indices.dim() != 1 or dist.dim() != 1:
        raise ValueError(f"indices and dist must be (E,) and (n,), got "
                         f"{tuple(indices.shape)}, {tuple(dist.shape)}")
    e, n, dev = indices.shape[0], dist.shape[0], indices.device
    _check("indices", indices, torch.int32, (e,), dev)
    _check("indptr", indptr, torch.int32, (n + 1,), dev)
    if weights is not None:
        _check("weights", weights, torch.float32, (e,), dev)
    _check("dist", dist, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("keys", keys, torch.int32, (n,), dev)
    _check("flag", flag, torch.int32, (1,), dev)
    _check("relaxed", relaxed, torch.int64, (1,), dev)
    if not all(t.is_contiguous() for t in (dist, active, keys, flag, relaxed)):
        raise ValueError("dist, active, keys, flag and relaxed are updated in place: "
                         "they must be contiguous")
    if dev.type == "cpu":
        best = ref.relax_min_ref(indptr, indices, weights, dist, active)
        relaxed += out_degree_sum(indptr, active)
        flag.fill_(ref.settle_ref(best, dist, active))
        return
    if dev.type != "cuda":
        raise RuntimeError(f"no relaxation kernel for device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"indices on {dev}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    indptr, indices = indptr.contiguous(), indices.contiguous()
    weights = weights.contiguous() if weights is not None else None
    lib, fn, stream = _entry_points()
    # each tile's first (row, edge), and the end's
    scratch = torch.empty(8 * (-(-(n + e) // TILE) + 1), dtype=torch.uint8, device=dev)
    rc = fn(indptr.data_ptr(), indices.data_ptr(),
            weights.data_ptr() if weights is not None else None, dist.data_ptr(), active.data_ptr(),
            keys.data_ptr(), n, e, flag.data_ptr(), relaxed.data_ptr(), scratch.data_ptr(),
            scratch.numel(), stream(dev.index))
    _build.check(lib, rc, "relaxation kernel")
    relax_min.launches += 1


relax_min.launches = 0
