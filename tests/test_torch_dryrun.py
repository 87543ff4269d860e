"""repro_torch.launch.dryrun: the abstract evaluation of the cells over the
``fake`` backend, and the collectives it counts through
``launch/roofline.py``.

- The dry-run as its own process on ``gin-tu:molecule``: status "ok" on
  256 devices (the shape of tests/test_system.py's dry-run test), with no
  allocation anywhere.
- ``run_cell`` on a reduced LM train cell (minitron-8b at published width,
  2 layers, 2 microbatches, 32 x 1,024 tokens): its argument bytes a
  device equal the JAX package's shard sizes times the dtypes' bytes, and
  its traced FLOPs a device lie within ``FLOP_BAND`` of
  ``analytic_lm_terms``' ``flops_per_dev``. The band is wide because the
  formula prices other work than runs: its 8·N·tokens counts the
  embedding table as a product (half of N at 2 layers), while the step
  runs the chunked loss's head products three times (forward, recomputed,
  backward) and DTensor computes some weight gradients with a full-width
  operand (PERF.md §6). Measured: 0.615 here, 1.355 for
  minitron-8b's full train_4k cell (torch 2.13; 0.852 on 2.11).
- ``run_cell`` on a reduced MoE train cell (phi3.5-moe at published
  width, 2 layers, 2 microbatches, 32 x 1,024 tokens): its traced FLOPs a
  device within the same ``FLOP_BAND``. The MoE's local rule splits the
  experts' capacity over the batch axes (measured 0.965); when every
  device ran the experts over all tokens, the ratio was 9.853.
- Traced collectives go through ``collective_bytes``' ring factors.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
from jax.sharding import AbstractMesh

from repro.configs import base as j_cfgs
from repro.launch import roofline as j_rl
from repro.launch import steps as j_steps
from repro_torch.launch import roofline as t_rl
from test_torch_sharding import run_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOP_BAND = (0.5, 2.0)


def test_dryrun_subprocess_gin_molecule(tmp_path):
    out = tmp_path / "dry.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
                        "--cells", "gin-tu:molecule", "--out", str(out)],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert len(rec) == 1
    assert rec[0]["status"] == "ok"
    assert rec[0]["devices"] == 256
    assert rec[0]["allocation"].startswith("none")
    assert rec[0]["traced_gflops_per_dev"] > 0 and rec[0]["bytes_per_device"] > 0
    assert sum(rec[0]["comm_counts"].values()) > 0
    assert "1/1 cells traced" in r.stdout


def test_run_cell_on_a_reduced_lm_train_cell(tmp_path):
    arg = {"arch": "minitron-8b", "replace": {"n_layers": 2, "microbatches": 2},
           "shape": {"kind": "train", "seq_len": 1024, "global_batch": 32}}
    rec = run_worker("dryrun", arg, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256
    assert rec["traced"] == ("layers 1 and 2 extrapolated to 2; "
                             "1 of 2 microbatches (16 rows), x2")
    jcfg = dataclasses.replace(j_cfgs.get_arch("minitron-8b"), name="minitron-8b-test",
                               n_layers=2, microbatches=2)
    jshape = j_cfgs.LMShape("test", "train", 1024, 32)
    cell = j_steps._lm_train_cell(jcfg, jshape, AbstractMesh((16, 16), ("data", "model")))
    want = 0
    for a, s in zip(cell.args, cell.in_shardings):
        leaves = jax.tree_util.tree_leaves(a)
        for x, sh in zip(leaves, jax.tree_util.tree_structure(a).flatten_up_to(s)):
            want += int(np.prod(sh.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
    assert rec["argument_bytes"] == want
    analytic = j_rl.analytic_lm_terms(jcfg, jshape, 256, n_model=16)["flops_per_dev"]
    assert abs(rec["hlo_gflops_per_dev"] - analytic / 1e9) <= 1e-3  # the compute term's FLOPs
    ratio = rec["traced_gflops_per_dev"] * 1e9 / analytic
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_run_cell_on_a_reduced_moe_train_cell(tmp_path):
    arch = "phi3.5-moe-42b-a6.6b"
    arg = {"arch": arch, "replace": {"n_layers": 2, "microbatches": 2},
           "shape": {"kind": "train", "seq_len": 1024, "global_batch": 32}}
    rec = run_worker("dryrun", arg, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    jcfg = dataclasses.replace(j_cfgs.get_arch(arch), n_layers=2, microbatches=2)
    analytic = j_rl.analytic_lm_terms(jcfg, j_cfgs.LMShape("test", "train", 1024, 32), 256,
                                      n_model=16)["flops_per_dev"]
    ratio = rec["traced_gflops_per_dev"] * 1e9 / analytic
    print(f"{arch} at 2 layers: traced / analytic FLOPs a device {ratio:.3f}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_traced_collectives_take_the_hlo_factors():
    """The same collectives as traced records and as HLO lines give the
    same bytes, op by op."""
    hlo = "\n".join([
        "  %ag = f32[64,128] all-gather(f32[4,128] %x), replica_groups=[16,16]",
        "  %rs = f32[4,128] reduce-scatter(f32[64,128] %y), replica_groups=[16,16]",
        "  %ar = bf16[1024] all-reduce(bf16[1024] %z), replica_groups=[1,256]",
        "  %a2a = f32[8,8] all-to-all(f32[8,8] %w), replica_groups=[32,8]",
        "  %cp = f32[10] collective-permute(f32[10] %v), replica_groups=[1,2]",
    ])
    records = [("all-gather", 64 * 128 * 4, 16), ("reduce-scatter", 4 * 128 * 4, 16),
               ("all-reduce", 1024 * 2, 256), ("all-to-all", 64 * 4, 8),
               ("collective-permute", 40, 2), ("all-reduce", 4, 1)]
    got = t_rl.traced_collective_bytes(records)
    assert got == t_rl.collective_bytes(hlo, 256) == j_rl.collective_bytes(hlo, 256)
    roof = t_rl.analyze("a", "s", "m", 256, {"flops": 1e12}, "", 1e15, collectives=got)
    assert roof.coll_gbytes == sum(got.values()) / 1e9
