"""The port's mesh side of tests/test_torch_sharding.py and
tests/test_torch_cells.py, run as a subprocess.

    python tests/torch_mesh_worker.py <job> <in.json> <out.json>

It starts torch.distributed's ``fake`` backend at 512 ranks in this
process (no pytest worker's gloo group is touched), builds the production
meshes ``single`` (16 x 16) and ``multi`` (2 x 16 x 16) on the ``"cpu"``
device type, and writes what the job found as JSON. It imports only the
port (no jax, no repro). Jobs:

- ``specs``: every batch spec of ``dist.sharding`` on both meshes;
- ``constrain``: for each case ``{mesh, shape, axes, entries}`` the
  placements ``constrain`` gives a replicated meta DTensor of ``shape``
  under ``axes`` and those ``NamedSharding(mesh, P(*entries))`` gives
  (``entries``: the JAX package's choice), and ``ns(mesh, *axes).spec``;
- ``cells``: for each (arch, shape) of ``all_cells()`` on both meshes, the
  cell's ``donate`` and its argument leaves in JAX's flatten order (global
  shape, dtype, local shard shape), or the error building it raised;
- ``dryrun``: ``launch.dryrun.run_cell`` on the single mesh for the LM
  config ``{"arch", "replace"}`` (the arch's published config with the
  ``replace`` fields changed) at ``{"shape"}`` (an ``LMShape``'s fields),
  registered as the arch ``"<arch>-test"`` and shape ``"test"``; or, given
  a list of ``{"cell": "arch:shape", "mesh", "guard"}``, ``run_cell`` on
  each published cell under ``DTensorGuard(guard)``: a record each.
"""
import dataclasses
import json
import logging
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def flatten(tree, shardings):
    """(leaf, sharding) pairs in JAX's flatten order: dict keys sorted,
    sequences and dataclass fields in order, None holding nothing."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, shardings) for x in flatten(t, s)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in flatten(getattr(tree, f.name), getattr(shardings, f.name))]
    return [(tree, shardings)]


def specs(meshes, _):
    out = {}
    for name, mesh in meshes.items():
        out[name] = {
            "batch_axes": shd.batch_axes(mesh),
            "lm_batch": shd.lm_batch_spec(mesh),
            "gnn_batch": {k: shd.gnn_batch_spec(mesh, k)
                          for k in ("full_graph", "molecule", "minibatch")},
            "recsys_batch": {k: shd.recsys_batch_spec(mesh, k)
                             for k in ("train", "serve", "retrieval")},
        }
    return out


def constrain(meshes, cases):
    out = []
    for c in cases:
        mesh = meshes[c["mesh"]]
        axes = [tuple(a) if isinstance(a, list) else a for a in c["axes"]]
        entries = [tuple(a) if isinstance(a, list) else a for a in c["entries"]]
        x = DTensor.from_local(torch.empty(c["shape"], device="meta"), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
        shd.set_active_mesh(mesh)
        try:
            got = shd.constrain(x, *axes).placements
        finally:
            shd.set_active_mesh(None)
        want = shd.NamedSharding(mesh, shd.P(*entries)).placements
        out.append({"got": repr(tuple(got)), "want": repr(want),
                    "ns": list(shd.ns(mesh, *axes).spec)})
    return out


def cells(meshes, _):
    out = {}
    for name, mesh in meshes.items():
        for arch, shape in steps.all_cells():
            key = f"{name}/{arch}:{shape}"
            try:
                cell = steps.build_cell(arch, shape, mesh)
            except Exception as e:  # noqa: BLE001 -- the reference's failures are compared too
                out[key] = {"error": [type(e).__name__, str(e)]}
                continue
            leaves = [flatten(a, s) for a, s in zip(cell.args, cell.in_shardings)]
            out[key] = {
                "donate": list(cell.donate),
                "args": [[[list(t.shape), str(t.dtype).removeprefix("torch."),
                           list(s.shard_shape(t.shape))] for t, s in arg] for arg in leaves],
            }
    return out


VIEWS = ("aten.view", "aten._unsafe_view")


def merges_a_sharded_dim(x, shape) -> bool:
    """Whether viewing DTensor ``x`` as ``shape`` merges a dim that ``x``
    shards into the dim before it (the flatten that some torch releases'
    view rule refuses: only a merged group's leading dim, dims of one
    aside, may be sharded)."""
    shape = list(shape)
    if -1 in shape:
        rest = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = x.numel() // rest if rest else 0
    sharded = {p.dim for p in x.placements if isinstance(p, Shard)}
    xs, i, j = list(x.shape), 0, 0
    while i < len(xs) and j < len(shape):
        group, pa, pb = [i], xs[i], shape[j]
        while pa != pb:
            if pa < pb and i + 1 < len(xs):
                i += 1
                group.append(i)
                pa *= xs[i]
            elif pb < pa and j + 1 < len(shape):
                j += 1
                pb *= shape[j]
            else:
                return False
        merged = [d for d in group if xs[d] > 1]  # a dim of one merges into nothing
        if any(d in sharded for d in merged[1:]):
            return True
        i, j = i + 1, j + 1
    return False


class DTensorGuard(TorchDispatchMode):
    """Raises when one of ``ops`` (``"aten.index_add"``, ...) receives a
    DTensor: the operations whose DTensor rules a torch release refuses in
    the cells that the port's local rules carry. ``aten.view`` and
    ``aten._unsafe_view`` raise only when they merge a sharded dim into
    the one before it."""

    def __init__(self, ops):
        super().__init__()
        self.ops = set(ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = f"{func.namespace}.{func.overloadpacket.__name__}"
        if name in self.ops and any(issubclass(t, DTensor) for t in types) and (
                name not in VIEWS or merges_a_sharded_dim(args[0], args[1])):
            placed = [(tuple(a.shape), a.placements) for a in tree_leaves(args)
                      if isinstance(a, DTensor)]
            raise RuntimeError(f"guarded: {func} received a DTensor {placed}")
        return func(*args, **(kwargs or {}))  # on to the modes below (the dry-run's counts)


def dryrun(meshes, arg):
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import dryrun as dr

    if isinstance(arg, list):
        out = []
        build, lm_cell = steps.build_cell, steps.lm_cell
        for case in arg:
            arch, shape = case["cell"].split(":")

            def guarded(make, ops=case["guard"]):
                # the guard innermost, inside the dry-run's own modes: a mode
                # above one that leaves DTensors to DTensor never sees them
                def cell(*a, **k):
                    c = make(*a, **k)

                    def step(*args, fn=c.step_fn):
                        with DTensorGuard(ops):
                            return fn(*args)
                    return dataclasses.replace(c, step_fn=step)
                return cell
            steps.build_cell, steps.lm_cell = guarded(build), guarded(lm_cell)
            try:
                out.append(dr.run_cell(arch, shape, meshes[case["mesh"]], case["mesh"]))
            finally:
                steps.build_cell, steps.lm_cell = build, lm_cell
        return out
    cfg = dataclasses.replace(cfgs.get_arch(arg["arch"]), name=arg["arch"] + "-test",
                              **arg["replace"])
    cfgs.register(cfg)
    cfgs.LM_SHAPES["test"] = cfgs.LMShape("test", **arg["shape"])
    return dr.run_cell(cfg.name, "test", meshes["single"], "single")


def main():
    job, src, dst = sys.argv[1:4]
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        meshes = {"single": make_production_mesh(device_type="cpu"),
                  "multi": make_production_mesh(multi_pod=True, device_type="cpu")}
        with open(src) as f:
            arg = json.load(f)
        result = {"specs": specs, "constrain": constrain, "cells": cells, "dryrun": dryrun}[job](meshes, arg)
        with open(dst, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
