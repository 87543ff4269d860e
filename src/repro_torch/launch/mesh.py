"""Production and debug meshes, as ``torch.distributed`` device meshes.

Functions, not module-level constants: building a mesh needs the default
process group, which the caller initialises
(``torch.distributed.init_process_group`` with its own address, world size
and rank: NCCL on cards, gloo on the CPU, the ``fake`` backend for the
dry-run's 256 or 512 placeholder ranks). Nothing here starts one.

``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"`` (the
tests' gloo ranks and the dry-run's abstract evaluation).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import devices
from repro_torch.dist.sharding import batch_axes


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    if device_type == "cuda":
        devices.resolve("cuda")
    return DeviceMesh(device_type, torch.arange(int(torch.tensor(shape).prod())).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = devices.DEFAULT_DEVICE) -> DeviceMesh:
    """16x16 = 256 devices a pod ``("data", "model")``; ``multi_pod`` adds
    the 2-pod axis, ``("pod", "data", "model")`` over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, multi_pod: bool = False,
                    device_type: str = devices.DEFAULT_DEVICE) -> DeviceMesh:
    """A small mesh for sharding tests (the process group needs at least
    as many ranks)."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def data_axes(mesh: DeviceMesh) -> tuple:
    """The batch-parallel axes of a mesh ("pod" included when present)."""
    return batch_axes(mesh)
