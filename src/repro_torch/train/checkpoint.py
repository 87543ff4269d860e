"""Checkpoints of trees of tensors.

Layout:  <dir>/step_<N>/
           manifest.json      — step, tree structure, each leaf's shape and dtype
           arr_<i>.npy        — one file per leaf, numbered in flatten order
         <dir>/LATEST         — atomic pointer (write tmp + rename)

The layout is the JAX package's, with the manifest in JSON (the JAX package
writes ``manifest.msgpack``). Leaves are numbered in the same flatten order
(``train.tree``), so ``restore`` also reads a checkpoint the JAX package
wrote, from its ``arr_<i>.npy`` files. bfloat16 leaves are stored as their
16-bit patterns (the JAX package's files hold them as 2-byte void).

``save`` snapshots every leaf to host memory first (a device-to-host copy
that waits for the device), then writes on a background thread into
``.tmp_step_N`` and publishes it with a rename; a DTensor leaf is saved
whole (``full_tensor``). In a process group of more than one rank every
rank gathers the leaves (``full_tensor`` is a collective), rank 0 alone
writes, publishes and garbage-collects, and ``save`` returns on every
rank only after the checkpoint is published (a barrier), so no rank
restores from ``LATEST`` while another writes. ``restore(..., shardings=)`` (the JAX package's
elastic restore) distributes each leaf by its ``dist.sharding``
placements on their mesh, whatever mesh wrote it; without ``shardings`` a
DTensor leaf of ``like`` gives its own mesh and placements.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.dist.sharding import map_placed
from repro_torch.train.tree import tree_leaves, tree_unflatten

MANIFEST = "manifest.json"


def _host(x) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype's name."""
    if isinstance(x, torch.Tensor):
        t = (x.full_tensor() if isinstance(x, DTensor) else x).detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), name
        return t.numpy().copy(), name
    a = np.array(x)
    return a, str(a.dtype)


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _writes() -> bool:
    """Whether this process writes the directory: rank 0 of a group, or a
    process with none."""
    return _group_size() == 1 or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any, wait: bool = True) -> threading.Thread:
    """Serialize a tree of tensors (or arrays). Returns the writer thread.
    In a group of more than one rank it waits for the write whatever
    ``wait`` says (see the module's docstring)."""
    host = [_host(x) for x in tree_leaves(tree)]
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")

    def _write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "treedef": repr(tree_unflatten(tree, ["*"] * len(host))),
            "leaves": [{"file": f"arr_{i}.npy", "shape": list(a.shape), "dtype": dtype}
                       for i, (a, dtype) in enumerate(host)],
        }
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    shared = _group_size() > 1
    t = threading.Thread(target=_write if _writes() else (lambda: None), daemon=True)
    t.start()
    if wait or shared:
        t.join()
    if shared:
        dist.barrier()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(ckpt_dir: str, step: Optional[int], like: Any,
            device: str | torch.device | None = None, shardings: Any = None) -> Any:
    """Load step ``step`` (the latest when None) into the structure of
    ``like``, each leaf with the dtype it was saved in. With ``shardings``
    (a tree of ``NamedSharding`` matching ``like``, or one for all) each
    leaf is distributed by its placements on its mesh (elastic restore onto
    another mesh). Otherwise a leaf goes to ``device``, or when that is
    None where ``like``'s leaf is: a DTensor's mesh and placements, a
    tensor's device, the CPU for a leaf that is not a tensor."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    flat_like = tree_leaves(like)
    n_files = sum(n.startswith("arr_") and n.endswith(".npy") for n in os.listdir(d))
    if n_files != len(flat_like):
        raise ValueError(f"checkpoint has {n_files} leaves, restore target has {len(flat_like)}")
    dtypes = [None] * n_files
    if os.path.exists(os.path.join(d, MANIFEST)):
        with open(os.path.join(d, MANIFEST)) as f:
            dtypes = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    flat_shard = [None] * len(flat_like)
    if shardings is not None:
        # NamedSharding leaves: train.tree does not open dataclasses
        flat_shard = tree_leaves(map_placed(lambda _, s: s, like, shardings))
    leaves = []
    for i, (ref, dtype, sh) in enumerate(zip(flat_like, dtypes, flat_shard)):
        a = np.load(os.path.join(d, f"arr_{i}.npy"))
        want = tuple(getattr(ref, "shape", a.shape))
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape}, restore target {want}")
        t = _tensor(a, dtype)
        if sh is not None:
            leaves.append(distribute_tensor(t.to(sh.mesh.device_type), sh.mesh, sh.placements))
        elif device is None and isinstance(ref, DTensor):
            leaves.append(distribute_tensor(t.to(ref.device_mesh.device_type), ref.device_mesh,
                                            ref.placements))
        else:
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            leaves.append(t.to(dev))
    return tree_unflatten(like, leaves)


def retain(ckpt_dir: str, keep: int = 3):
    """Garbage-collect all but the newest ``keep`` checkpoints (on rank 0
    alone in a group of more than one rank)."""
    if not _writes():
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir) if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
