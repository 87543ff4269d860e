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
``.tmp_step_N`` and publishes it with a rename. Restoring onto another
sharding (the JAX package's ``shardings=``) waits for the dist slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import tree_leaves, tree_unflatten

MANIFEST = "manifest.json"


def _host(x) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype's name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), name
        return t.numpy().copy(), name
    a = np.array(x)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any, wait: bool = True) -> threading.Thread:
    """Serialize a tree of tensors (or arrays). Returns the writer thread."""
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

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if wait:
        t.join()
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
            device: str | torch.device | None = None) -> Any:
    """Load step ``step`` (the latest when None) into the structure of
    ``like``. Each leaf goes to ``device``, or when that is None to the
    device of ``like``'s leaf (the CPU for a leaf that is not a tensor),
    with the dtype it was saved in."""
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
    leaves = []
    for i, (ref, dtype) in enumerate(zip(flat_like, dtypes)):
        a = np.load(os.path.join(d, f"arr_{i}.npy"))
        want = tuple(getattr(ref, "shape", a.shape))
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape}, restore target {want}")
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        leaves.append(_tensor(a, dtype).to(dev))
    return tree_unflatten(like, leaves)


def retain(ckpt_dir: str, keep: int = 3):
    """Garbage-collect all but the newest ``keep`` checkpoints."""
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir) if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
