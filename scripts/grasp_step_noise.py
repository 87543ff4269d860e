#!/usr/bin/env python3
"""How far the card's atomic sums move a GIN train step's gradients and new
parameters from run to run, at the sizes of chip_smoke.py phase 12.

    python3 scripts/grasp_step_noise.py

``index_add_`` on the card adds in no fixed order, so two runs of one step
on the same inputs differ in the last bits of each segment sum, and a
gradient that is a sum over millions of nodes with heavy cancellation
(GIN's scalar eps) carries that much further. This runs, on one NCCL rank:

- at real size (phase 12 (a): gin-tu, d_feat 100, the cell's spec over the
  lj scale-22 graph), the unpartitioned step (gnn_loss + AdamW) and the
  GRASP step three times each on the same weights;
- at phase 12 (c)'s size (the tw scale-13 graph, 1,024 hot rows), the
  GRASP step three times on the card, with and without deterministic
  algorithms, and once on a gloo rank on the CPU;

and prints, for every pair, each step's loss and the largest leaf max-abs
difference of its summed gradients and its new parameters over the leaf's
largest entry, then each gradient leaf's smallest and largest magnitude.
It prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 3


def compare(name_a, runs_a, name_b, runs_b):
    """Every pair of (loss, gradients, new parameters) runs: the losses and
    the largest leaf max-abs difference over the leaf's largest entry."""
    for i, (la, ga, pa) in enumerate(runs_a):
        for j, (lb, gb, pb) in enumerate(runs_b):
            if runs_a is runs_b and j <= i:
                continue
            gr = cs.leaf_relative(cs.tree_errors(ga, gb), gb)
            pr = cs.leaf_relative(cs.tree_errors(pa, pb), pb)
            print(f"{name_a} {i} vs {name_b} {j}: loss {la!r} vs {lb!r}; gradients "
                  f"{max(gr):.3e} (leaf {int(np.argmax(gr))}), parameters {max(pr):.3e} (leaf "
                  f"{int(np.argmax(pr))})")


def grasp_runs(spec, cfg, d_feat, block, params, device, group, reps):
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make

    opt_init, opt_update = make(OptConfig(name="adamw", lr=1e-3))
    cpu = torch.device("cpu")
    out = []
    for _ in range(reps):
        seen = []
        step = coll.make_grasp_gin_step(spec, cfg, d_feat, cfg.d_out, group,
                                        cs.recording(opt_update, seen), device=device)
        p = gnn.to_device(params, device)
        new, _, m = step(p, opt_init(p), block)
        out.append((float(m["loss"]), gnn.to_device(seen[0], cpu), gnn.to_device(new, cpu)))
    return out


def real_size(dev):
    from repro_torch import convert
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.steps import gnn_loss
    from repro_torch.nn import gnn
    from repro_torch.train.optimizer import OptConfig, make
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.train.tree import tree_leaves

    g = cs.dbg_graph("lj", cs.REAL_SCALE)
    cfg, d_feat, cpu = get_arch("gin-tu"), 100, torch.device("cpu")
    spec = coll.partition_spec_for(g.num_nodes, g.num_edges, 1,
                                   hot_budget_bytes=coll.HOT_REPLICA_BUDGET_BYTES,
                                   elem_bytes=d_feat * 4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((spec.num_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    params = gnn.init(torch.Generator().manual_seed(0), cfg, d_feat, device=dev)
    opt_init, opt_update = make(OptConfig(name="adamw", lr=1e-3))
    ref = {"x": torch.from_numpy(x).to(dev), "src": torch.from_numpy(g.indices).to(dev),
           "dst": torch.from_numpy(g.dst_ids()).to(dev),
           "emask": torch.ones(g.num_edges, dtype=torch.bool, device=dev),
           "labels": torch.from_numpy(labels).to(dev)}
    unpart = []
    for _ in range(REPS):
        loss, grads = value_and_grad(gnn_loss, params, cfg, ref)
        new = opt_update(grads, opt_init(params), params)[0]
        unpart.append((float(loss), gnn.to_device(grads, cpu), gnn.to_device(new, cpu)))
    del ref
    torch.cuda.empty_cache()
    block = convert.grasp_batch_from_numpy(
        coll.grasp_batch(x, labels, coll.grasp_partition(g, spec), spec), 0, dev)
    grasp = grasp_runs(spec, cfg, d_feat, block, params, dev, None, REPS)
    print(f"real size: lj scale {cs.REAL_SCALE}, {g.num_nodes} vertices, {g.num_edges} edges, "
          f"gin-tu, d_feat {d_feat}")
    compare("grasp", grasp, "unpartitioned", unpart)
    compare("unpartitioned", unpart, "unpartitioned", unpart)
    compare("grasp", grasp, "grasp", grasp)
    for i, leaf in enumerate(tree_leaves(unpart[0][1])):
        print(f"gradient leaf {i} {tuple(leaf.shape)}: smallest |g| "
              f"{float(leaf.abs().min()):.3e}, largest {float(leaf.abs().max()):.3e}")


def check_size(dev):
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn

    g = cs.dbg_graph("tw", 13)
    cfg, d_feat = get_arch("gin-tu"), 100
    spec = coll.partition_spec_for(g.num_nodes, g.num_edges, 1, hot=cs.GRASP_CHECK_HOT)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((spec.num_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    batch = coll.grasp_batch(x, labels, coll.grasp_partition(g, spec), spec)
    batch = {k: (v if k == "x_hot" else v[0]) for k, v in batch.items()}
    params = gnn.init(torch.Generator().manual_seed(2), cfg, d_feat, device="cpu")
    on_cpu = grasp_runs(spec, cfg, d_feat, batch, params, torch.device("cpu"),
                        dist.new_group(backend="gloo"), 1)
    card = grasp_runs(spec, cfg, d_feat, batch, params, dev, None, REPS)
    torch.use_deterministic_algorithms(True)
    try:
        card_det = grasp_runs(spec, cfg, d_feat, batch, params, dev, None, REPS)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"check size: tw scale 13, {g.num_nodes} vertices, {g.num_edges} edges, hot "
          f"{spec.hot}, gin-tu, d_feat {d_feat}")
    compare("card", card, "cpu", on_cpu)
    compare("card deterministic", card_det, "cpu", on_cpu)
    compare("card", card, "card", card)


def main() -> int:
    if not torch.cuda.is_available():
        print("grasp_step_noise: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        check_size(dev)
        real_size(dev)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
