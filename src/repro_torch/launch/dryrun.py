"""Multi-pod dry-run: trace every (arch x shape) cell on the production
mesh, count what a device holds, computes and sends, and extract roofline
terms at the H100's rates (``launch/roofline.py``).

Run it as its own process: it starts ``torch.distributed``'s ``fake``
backend at the mesh's world size (256, or 512 for two pods) before it
builds a mesh, as the JAX package's dry-run sets ``XLA_FLAGS`` first:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  --cells lm

It is an abstract evaluation, not a fallback: the arguments are meta
DTensors (global shapes, each device's shard shape as the local block) on
a mesh of ``"cpu"`` device type over the fake group, so no device and no
host memory holds any value; collectives are recorded and not run.

Results land in ``reports/dryrun_torch_<mesh>.json`` (``--out`` to move
them), one record a cell:

- ``bytes_per_device``: the arguments' and outputs' local shard bytes,
  exact, from the cell's shardings (``bytes_kind`` says so: temporaries
  are not tracked);
- ``traced_gflops_per_dev``: the FLOPs of the local operations one device
  runs (``torch.utils.flop_counter``'s formulas over the local blocks that
  DTensor dispatches to, not over the global DTensor operation);
- ``coll_breakdown``: GB a device sends, by collective, through the ring
  factors of ``roofline.collective_bytes``; ``comm_counts``:
  ``CommDebugMode``'s counts;
- the roofline terms and dominant term (``roofline.analyze``); the LM cells
  take their compute and memory terms from ``analytic_lm_terms``, as the
  JAX package's dry-run does;
- ``compile_s``: seconds of tracing.

A full-depth LM cell would take minutes to trace on the host, so an LM
cell is traced at 1 and 2 layers and extrapolated linearly to its depth,
and a training cell traces one microbatch (``B / mb`` rows) and multiplies
by ``mb``, as the JAX package's ``loop_trips`` multiply scan bodies;
``traced`` says what was traced.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import base as cfgs
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import transformer as tfm

ALLOCATION = "none: meta DTensors on a fake process group (abstract evaluation)"
BYTES_KIND = "arguments + outputs, local shards (temporaries not tracked)"

# collective ops as a trace shows them -> (roofline op name, index of the
# group size argument, or None: resolve the group argument)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_reduce": ("all-reduce", None),
    "all_to_all_single": ("all-to-all", None),
}
_C10D = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
         "allreduce_": "all-reduce", "alltoall_base_": "all-to-all",
         "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter"}


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Count(TorchDispatchMode):
    """One device's work: DTensor operations are let through to DTensor's
    dispatch, which runs each as local operations on the local blocks and
    collectives; those are counted here (FLOPs, bytes each operation reads
    and writes, each collective's result bytes and group size). Sharding
    propagation's shape inference (fake tensors) is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.colls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(t.__name__ == "FakeTensor" for t in types):
            return out
        ns, name = func.namespace, func.overloadpacket.__name__
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            op, gi = _FUNCTIONAL[name]
            g = args[gi] if gi is not None else \
                dist.distributed_c10d._resolve_process_group(args[-1]).size()
            self.colls.append((op, _nbytes(out), int(g)))
        elif ns == "c10d" and name in _C10D:
            # the port's own collectives (the GRASP step) run on the
            # default group, the mesh's ranks here
            self.colls.append((_C10D[name], _nbytes(args[0]), dist.get_world_size()))
        elif not func.is_view:
            if func.overloadpacket in flop_registry:
                self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
            self.bytes += _nbytes(list(a for a in args if isinstance(a, torch.Tensor))) \
                + _nbytes(out)
        return out


def _trace(cell) -> dict:
    """Run the cell's step on meta DTensors; what one device did."""
    args = tuple(shd.abstract(a, s) for a, s in zip(cell.args, cell.in_shardings))
    with CommDebugMode() as comm, _Count() as count:
        out = cell.step_fn(*args)
    coll = rl.traced_collective_bytes(count.colls)
    return {"flops": float(count.flops), "bytes": float(count.bytes), "coll": coll,
            "counts": {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()},
            "out_bytes": _local_bytes(out)}


def _total(tree) -> int:
    """The sum of a tree of byte counts (dicts, sequences, dataclasses
    such as the KV cache; None holds nothing)."""
    if isinstance(tree, dict):
        return sum(_total(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_total(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_total(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return tree or 0


def _local_bytes(tree) -> int:
    """Local bytes of every DTensor (or tensor) leaf of a tree."""
    return _total(shd.map_placed(
        lambda x, _: _nbytes(x.to_local() if isinstance(x, DTensor) else x), tree, tree))


def _shard_bytes(tree, shardings) -> int:
    """Each leaf's local shard bytes under its sharding, from shapes."""
    return _total(shd.map_placed(
        lambda t, s: math.prod(s.shard_shape(t.shape)) * t.element_size(), tree, shardings))


def _lm_outputs(cell, cfg, shape) -> int:
    """Local bytes of an LM cell's outputs, from its shardings."""
    if shape.kind == "train":  # new params, new state (as donated in), the loss
        return _shard_bytes(cell.args[0], cell.out_shardings[0]) \
            + _shard_bytes(cell.args[1], cell.out_shardings[1]) + 4
    kv = (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv, cfg.head_dim)
    cache = tfm.KVCache(k=steps_mod.sds(kv, torch.bfloat16), v=steps_mod.sds(kv, torch.bfloat16),
                        length=steps_mod.sds((), torch.int32))
    logits = steps_mod.sds((shape.global_batch, cfg.vocab), torch.float32)
    return _shard_bytes(logits, cell.out_shardings[0]) \
        + _shard_bytes(cache, cell.out_shardings[1])


def _trace_lm(cfg, shape, mesh) -> tuple[dict, str]:
    """An LM cell's counts: traced at 1 and 2 layers (one microbatch of a
    training cell), extrapolated linearly to ``cfg.n_layers`` and
    multiplied by the microbatches."""
    mb = 1
    if shape.kind == "train":
        mb = max(min(cfg.microbatches, shape.global_batch // steps_mod._batch_shards(mesh)), 1)
    one_mb = dataclasses.replace(shape, global_batch=shape.global_batch // mb)
    got = [_trace(steps_mod.lm_cell(
        dataclasses.replace(cfg, n_layers=n, microbatches=1 if shape.kind == "train"
                            else cfg.microbatches), one_mb, mesh)) for n in (1, 2)]

    def scale(a, b):
        return mb * (a + (cfg.n_layers - 1) * (b - a))

    out = {"flops": scale(got[0]["flops"], got[1]["flops"]),
           "bytes": scale(got[0]["bytes"], got[1]["bytes"]),
           "coll": {k: scale(got[0]["coll"][k], got[1]["coll"][k]) for k in got[0]["coll"]},
           "counts": {k: scale(got[0]["counts"].get(k, 0), got[1]["counts"].get(k, 0))
                      for k in set(got[0]["counts"]) | set(got[1]["counts"])}}
    what = (f"layers 1 and 2 extrapolated to {cfg.n_layers}"
            + (f"; 1 of {mb} microbatches ({one_mb.global_batch} rows), x{mb}" if mb > 1 else ""))
    return out, what


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "allocation": ALLOCATION}
    t0 = time.time()
    try:
        cfg = cfgs.get_arch(arch)
        shape = cfgs.SHAPES[cfg.family][shape_name]
        cell = steps_mod.build_cell(arch, shape_name, mesh)
        arg_bytes = sum(_shard_bytes(a, s) for a, s in zip(cell.args, cell.in_shardings))
        analytic = None
        if cfg.family == "lm":
            got, traced = _trace_lm(cfg, shape, mesh)
            out_bytes = _lm_outputs(cell, cfg, shape)
            n_model = mesh.size(mesh.mesh_dim_names.index("model"))
            analytic = rl.analytic_lm_terms(cfg, shape, mesh.size(), n_model=n_model)
        else:
            got, traced = _trace(cell), "the whole step"
            out_bytes = got["out_bytes"]
        bytes_per_dev = arg_bytes + out_bytes
        roof = rl.analyze(arch, shape_name, mesh_name, mesh.size(),
                          {"flops": got["flops"], "bytes accessed": got["bytes"]}, "",
                          model_flops=rl.model_flops_for(cfg, shape),
                          memory_bytes=bytes_per_dev, analytic=analytic,
                          collectives=got["coll"])
        rec.update(status="ok", compile_s=round(time.time() - t0, 1), **roof.row(),
                   bytes_kind=BYTES_KIND, argument_bytes=arg_bytes, output_bytes=out_bytes,
                   traced_gflops_per_dev=got["flops"] / 1e9,
                   traced_gbytes_per_dev=got["bytes"] / 1e9,
                   comm_counts=got["counts"], traced=traced, donate=list(cell.donate))
        print(f"[dryrun] OK  {arch:24s} {shape_name:14s} {mesh_name:6s} "
              f"trace={rec['compile_s']:6.1f}s dominant={roof.dominant:10s} "
              f"bytes/dev={bytes_per_dev / 1e9:.2f}GB flops/dev={roof.hlo_gflops:.1f}G "
              f"coll={roof.coll_gbytes:.2f}GB", flush=True)
    except Exception as e:  # noqa: BLE001 -- report, don't abort the sweep
        rec.update(status="fail", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:],
                   compile_s=round(time.time() - t0, 1))
        print(f"[dryrun] FAIL {arch} {shape_name} {mesh_name}: {rec['error'][:300]}", flush=True)
    return rec


def _start(world: int) -> None:
    """The fake process group at ``world`` ranks (this process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--cells", default="all",
                    help="'all' | family (lm|gnn|recsys) | 'arch:shape[,arch:shape...]'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    cells = steps_mod.all_cells()
    if args.cells != "all":
        if args.cells in ("lm", "gnn", "recsys"):
            cells = [(a, s) for a, s in cells if cfgs.get_arch(a).family == args.cells]
        else:
            want = [tuple(c.split(":")) for c in args.cells.split(",")]
            cells = [c for c in cells if c in want]

    meshes = [m for m in ("single", "multi") if args.mesh in (m, "both")]
    out = args.out or f"reports/dryrun_torch_{args.mesh}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    records = []
    try:
        for mesh_name in meshes:
            multi = mesh_name == "multi"
            _start(512 if multi else 256)
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for arch, shape_name in cells:
                records.append(run_cell(arch, shape_name, mesh, mesh_name))
                with open(out, "w") as f:  # checkpoint after every cell
                    json.dump(records, f, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"[dryrun] {n_ok}/{len(records)} cells traced")
    return 0 if n_ok == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
