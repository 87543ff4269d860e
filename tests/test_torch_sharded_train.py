"""The port's training on a mesh: the LM train cell, ``Trainer(mesh=,
in_shardings=, out_shardings=)`` and ``checkpoint.restore(shardings=)``,
on the CPU over gloo.

- The reduced minitron's LM train cell on 4 spawned gloo ranks over a
  (2, 2) debug mesh (parameters and moments FSDP- and tensor-sharded as
  ``lm_param_spec`` says, the batch over "data"), 3 steps at 2
  microbatches, against the unsharded ``lm_train_step`` and against the
  JAX package's ``_lm_train_cell(...).step_fn`` on the same converted
  weights and batches, within tests/test_torch_lm_train.py's tolerances
  (loss ``LOSS_ATOL``; parameters and moments ``assert_params_close``),
  and the whole gradients each step hands its optimizer (the cell's
  backward through the shardings' collectives and the local rules)
  against the unsharded step's, each leaf within ``GRAD_REL`` of its
  largest entry: the shards' partial sums add in another order than one
  device's sums. A zero, halved, sign-flipped or one-shard gradient is
  off by at least half of a leaf's largest entry.
- The same cell on one rank over a (1, 1) mesh: every local shard is the
  whole leaf, so the bits of the unsharded step.
- phi3.5-MoE's train cell on the same 4 ranks (the MoE by its local rule:
  all tokens routed on every device, the experts' hidden dim split over
  "model") against the unsharded step, one step: the loss within
  ``LOSS_ATOL`` and every gradient within ``GRAD_REL`` of its leaf's
  largest entry (a MoE is discontinuous: the routed inputs differ in
  bfloat16 roundings, and from the second step on a pick near a router
  tie flips, moving the loss by 3.1e-3).
- ``Trainer`` with a mesh and a cell's shardings: a fit with 2
  microbatches, checkpoints and two injected failures, bit for bit against
  the unsharded fit, its state DTensors with the cell's placements.
- The GIN and PNA train cells on the same 4 ranks (edges sharded over
  both mesh axes, their segment sums and PNA's segment max and min by the
  local rules of ``dist.sharding``) against the unsharded
  ``gnn_train_step``: the loss to tests/test_torch_gnn.py's tolerances
  (GIN 1e-5, PNA 5e-5 relative), and every gradient handed the
  optimizer to test_torch_gnn.py's gradient tolerances (``TOL``).
- The LM prefill and decode cells (reduced minitron, bfloat16 weights)
  on 4 ranks: prefill's last logits and cache, then a decode step into a
  cache sharded on its sequence axis (each device writes the block its
  shard holds, ``dist.sharding.write_at``), against ``tfm.prefill`` and
  ``tfm.decode_step`` within ``SERVE_REL`` of the largest value: the
  row-parallel products' partial sums add in bfloat16 on each device
  before the all-reduce (measured up to 1.4% on the logits); on one
  rank, the same bits.
- The port of tests/test_train_infra.py::test_checkpoint_elastic_reshard:
  restore onto explicit 1-device shardings; also from the JAX package's
  own ``arr_<i>.npy`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gnn as gnn_tests
import torch_dist_worker as workers
from repro.configs import base as j_cfgs
from repro.launch import steps as j_steps
from repro.launch.mesh import make_debug_mesh as j_debug_mesh
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps as t_steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.nn import transformer as t_tfm
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import ft as ft_mod
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import tree_leaves, tree_map
from test_torch_lm_train import (GRAD_REL, LOSS_ATOL, as_jax, assert_params_close, batch,
                                 cfg_pair, jax_params, same_bits)

SHAPE = ("t", "train", 256, 4)
STEPS = 3


@pytest.fixture(scope="module")
def case():
    return make_case("minitron-8b")


def make_case(arch):
    jcfg, tcfg = cfg_pair(arch, microbatches=2)
    jp, _ = jax_params(jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    batches = [batch(jcfg, 4, 256, s) for s in range(STEPS)]
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "host": host, "batches": batches}


@pytest.fixture(scope="module")
def unsharded(case):
    return run_unsharded(case)


def run_unsharded(case):
    """The unsharded step on one thread, as the spawned ranks run (the
    CPU's products block by thread count, which moves their bits)."""
    with workers.recording_grads() as grads:
        opt_init, step = t_steps.lm_train_step(case["tcfg"], t_cfgs.LMShape(*SHAPE),
                                               device="cpu")
    p = convert.lm_params_from_numpy(case["host"], "cpu")
    s = opt_init(p)
    losses = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for b in case["batches"]:
            p, s, m = step(p, s, b)
            losses.append(m["loss"])
    finally:
        torch.set_num_threads(threads)
    return {"losses": losses, "params": p, "opt": s, "grads": grads}


def grad_errors(got, want) -> list:
    """Per leaf: the largest difference over the leaf's largest entry."""
    return [float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True)]


def assert_grads_close(got, want) -> float:
    """Each step's gradients, each leaf within ``GRAD_REL`` of its largest
    entry; returns the largest error."""
    assert len(got) == len(want) > 0
    worst = max(max(grad_errors(g, w)) for g, w in zip(got, want))
    assert worst <= GRAD_REL, worst
    return worst


def spawn_cell(case, mesh_shape, world, tmp_path_factory):
    return workers.spawn(workers.lm_cell_steps, world,
                         str(tmp_path_factory.mktemp(f"cell{world}")), case["tcfg"],
                         t_cfgs.LMShape(*SHAPE), mesh_shape, case["host"], case["batches"])


def test_lm_cell_on_4_ranks_matches_unsharded_and_jax(case, unsharded, tmp_path_factory):
    ranks = spawn_cell(case, (2, 2), 4, tmp_path_factory)
    got = ranks[0]
    for r in ranks[1:]:  # every rank gathers the same whole state
        assert same_bits(r["params"], got["params"])
    assert "Shard(dim=1), Shard(dim=0)" in got["placements"][0]  # embed: vocab/model, d/data
    for a, b in zip(got["losses"], unsharded["losses"]):
        assert abs(float(a) - float(b)) <= LOSS_ATOL
    print(f"largest gradient error {assert_grads_close(got['grads'], unsharded['grads']):.3e} "
          f"of a leaf's largest entry")
    assert_params_close(got["params"], unsharded["params"], lr=1e-3, steps=STEPS)

    # the JAX package's cell on the same weights and batches
    jcfg = case["jcfg"]
    cell = j_steps._lm_train_cell(jcfg, j_cfgs.LMShape(*SHAPE), j_debug_mesh(1, 1))
    jp = case["jp"]
    jo = j_opt.make(j_opt.for_arch(jcfg))[0](jp)
    jstep = jax.jit(cell.step_fn)
    for b, mine in zip(case["batches"], got["losses"]):
        jp, jo, jm = jstep(jp, jo, as_jax(b))
        assert abs(float(mine) - float(jm["loss"])) <= LOSS_ATOL
    assert_params_close(got["params"], jp, lr=1e-3, steps=STEPS)
    assert_params_close(got["opt"]["m"], jo["m"], lr=1e-3, steps=STEPS)
    assert int(got["opt"]["step"]) == STEPS


def test_lm_cell_on_one_rank_keeps_the_bits(case, unsharded, tmp_path_factory):
    got = spawn_cell(case, (1, 1), 1, tmp_path_factory)[0]
    assert all(torch.equal(a, b) for a, b in zip(got["losses"], unsharded["losses"]))
    assert same_bits(got["params"], unsharded["params"])
    assert same_bits(got["opt"], unsharded["opt"])
    assert len(got["grads"]) == STEPS
    assert all(same_bits(g, w) for g, w in zip(got["grads"], unsharded["grads"], strict=True))


def _lm_trainer(case, mesh=None, cell=None, ckpt_dir=None, steps=4):
    tcfg = case["tcfg"]
    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh, in_shardings=cell.in_shardings,
                  out_shardings=(cell.out_shardings[0], cell.out_shardings[1], shd.ns(mesh)))
    return Trainer(lambda p, b: t_tfm.loss_fn(p, tcfg, b),
                   lambda: convert.lm_params_from_numpy(case["host"], "cpu"),
                   t_opt.OptConfig(name="adamw", lr=1e-3),
                   TrainerConfig(num_steps=steps, microbatches=2, log_every=1,
                                 ckpt_dir=ckpt_dir, ckpt_every=2), device="cpu", **kw)


def test_trainer_with_a_mesh_fits_bit_for_bit(case, tmp_path):
    from repro.data import pipeline as j_pipe

    batch_fn = j_pipe.make_batch_fn("lm", case["jcfg"], j_cfgs.LMShape(*SHAPE), seed=5)
    clean = _lm_trainer(case)
    want = clean.fit(batch_fn)
    with workers.gloo_group(str(tmp_path)):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        cell = t_steps._lm_train_cell(case["tcfg"], t_cfgs.LMShape(*SHAPE), mesh)
        tr = _lm_trainer(case, mesh, cell, ckpt_dir=str(tmp_path / "ck"))
        got = tr.fit(batch_fn, injector=ft_mod.FailureInjector(fail_at=(1, 3)))
        assert tr.restarts == 2
        leaves = tree_leaves(got["params"])
        assert all(isinstance(x, torch.distributed.tensor.DTensor) for x in leaves)
        assert [x.placements for x in leaves] == [
            s.placements for s in tree_leaves_sh(cell.in_shardings[0], got["params"])]
        whole = tree_map(lambda x: x.full_tensor(), got)
    assert {h["step"]: h for h in tr.history} == {h["step"]: h for h in clean.history}
    assert same_bits(whole, want)


def tree_leaves_sh(shardings, like):
    return [s for s in tree_leaves(shd.map_placed(lambda _, s: [s], like, shardings))]


def test_trainer_mesh_needs_its_shardings():
    with pytest.raises(ValueError, match="go together"):
        Trainer(lambda p, b: 0, dict, t_opt.OptConfig(), TrainerConfig(), device="cpu",
                mesh=object())


def test_checkpoint_elastic_reshard(tmp_path):
    """Restore onto explicit (1-device) shardings: the elastic path."""
    from torch.distributed.device_mesh import DeviceMesh

    with workers.gloo_group(str(tmp_path)):
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        sh = shd.ns(mesh, "data")
        tree = {"w": torch.arange(8, dtype=torch.float32)}
        ckpt_mod.save(str(tmp_path), 1, tree)
        out = ckpt_mod.restore(str(tmp_path), 1, tree, shardings={"w": sh})
        assert out["w"].placements == sh.placements and out["w"].device_mesh == mesh
        np.testing.assert_array_equal(out["w"].full_tensor().numpy(), np.arange(8))
        # the JAX package's own files, onto one sharding for the whole tree
        j_ckpt.save(str(tmp_path / "j"), 2, {"a": jnp.arange(6.0).reshape(2, 3),
                                             "b": {"c": jnp.ones((4,), jnp.bfloat16)}})
        like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
        got = ckpt_mod.restore(str(tmp_path / "j"), 2, like, shardings=shd.ns(mesh))
        assert got["b"]["c"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["a"].full_tensor().numpy(),
                                      np.arange(6.0).reshape(2, 3))
        # a DTensor tree saves whole and restores into its own placements
        ckpt_mod.save(str(tmp_path / "d"), 3, got)
        back = ckpt_mod.restore(str(tmp_path / "d"), 3, got)
        assert same_bits(tree_map(lambda x: x.full_tensor(), back),
                         tree_map(lambda x: x.full_tensor(), got))


GNN_TOL = {"gin-tu": 1e-5, "pna": 5e-5}
GNN_GRAD_TOL = {"gin-tu": gnn_tests.TOL["gin"], "pna": gnn_tests.TOL["pna"]}


def test_gnn_cells_on_4_ranks_match_unsharded(tmp_path_factory):
    cases, plain = {}, {}
    for arch in GNN_TOL:
        jcfg, jb, tb = gnn_tests.train_batch_pair(arch, "molecule")
        _, tcfg = gnn_tests.cfg_pair(arch)
        jp, tp = gnn_tests.params_pair(jcfg)
        shape = t_cfgs.GNNShape("s", "molecule", 10, 20, d_feat=16, batch_graphs=4)
        cases[arch] = (tcfg, shape, jax.tree_util.tree_map(np.asarray, jp), tb)
        with workers.recording_grads() as grads:
            opt_init, step = t_steps.gnn_train_step(tcfg, shape, device="cpu")
        plain[arch] = step(tp, opt_init(tp), tb) + (grads,)
    ranks = workers.spawn(workers.gnn_cell_steps, 4, str(tmp_path_factory.mktemp("gnn4")),
                          cases, (2, 2))
    for arch, tol in GNN_TOL.items():
        got, (want_p, _, want_m, want_g) = ranks[0][arch], plain[arch]
        assert same_bits(ranks[3][arch]["params"], got["params"])
        assert np.isfinite(float(want_m["loss"]))
        assert abs(float(got["loss"]) - float(want_m["loss"])) <= tol * abs(float(want_m["loss"]))
        g_leaves, w_leaves = tree_leaves(got["grads"]), tree_leaves(want_g[0])
        assert len(g_leaves) == len(w_leaves) and sum(float(w.abs().sum()) for w in w_leaves) > 0
        for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"{arch} grad leaf {i}",
                                       **GNN_GRAD_TOL[arch])
        diffs = [float((a - b).abs().max())
                 for a, b in zip(tree_leaves(got["params"]), tree_leaves(want_p))]
        assert max(diffs) <= 2 * 1e-3, (arch, max(diffs))


SERVE_REL = 5e-2


@pytest.mark.parametrize("world", [1, 4])
def test_lm_serving_cells_match_prefill_and_decode(world, tmp_path):
    _, tcfg = cfg_pair("minitron-8b")
    got = workers.spawn(workers.lm_serving_cells, world, str(tmp_path), tcfg, 4, 256, 248,
                        (1, 1) if world == 1 else (2, 2), 0)[0]
    assert got["decode"][3] == got["want_decode"][3] == 249
    if world == 4:
        assert "Shard(dim=2)" in got["cache_placements"]  # the sequence over "model"
    for name in ("prefill", "decode"):
        for a, b in zip(got[name][:3], got["want_" + name]):
            assert a.shape == b.shape and a.dtype == b.dtype
            if world == 1:
                assert torch.equal(a, b), name
            else:
                err = float((a.float() - b.float()).abs().max())
                assert err <= SERVE_REL * float(b.float().abs().max()), (name, err)


def test_moe_cell_on_4_ranks_matches_unsharded(tmp_path_factory):
    moe = make_case("phi3.5-moe-42b-a6.6b")
    moe["batches"] = moe["batches"][:1]
    want = run_unsharded(moe)
    got = spawn_cell(moe, (2, 2), 4, tmp_path_factory)[0]
    assert abs(float(got["losses"][0]) - float(want["losses"][0])) <= LOSS_ATOL
    print(f"largest gradient error {assert_grads_close(got['grads'], want['grads']):.3e} "
          f"of a leaf's largest entry")
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"]))]
    assert max(diffs) <= 2 * 1e-3

