"""The cells that three local rules of ``dist.sharding`` carry, on 4
spawned gloo ranks over a (2, 2) debug mesh (tests/torch_dist_worker.py),
against the unsharded port:

- MIND's train cell (``LocalTake``: the item table sharded on its rows
  over both mesh axes, a vocab-parallel lookup whose gradient stays
  sharded as the table), 2 steps: the losses within ``LOSS_ATOL`` and
  every gradient handed the optimizer within ``GRAD_REL`` of its leaf's
  largest entry (test_torch_lm_train.py's bounds);
- NequIP's train cell at 78 edges, a count that 4 does not divide
  (``local_edge_map``: geometry, radial nets and messages on each
  device's own edges, the radial weights' gradient a partial sum), one
  step: the loss within test_torch_gnn.py's NequIP bound
  (``TOL["nequip"]``) and every gradient within its NequIP gradient bound
  (``NEQUIP_GRAD_SCALE`` of the leaf's largest entry): the partial sums
  add in another order, and the two bfloat16 products carry a rounding
  flip into the gradients, as between the two packages;
- the decode cell of a reduced minitron with ``n_kv == n_heads`` (4
  heads on 2-way "model", so one query head a KV head: the layout that
  some torch releases refuse to flatten), its cache sharded on its
  sequence over "model" (``local_decode``: the softmax over keys across
  the devices that split them): prefill and one decode step within
  ``SERVE_REL`` of the largest value, as the grouped-head case in
  tests/test_torch_sharded_train.py.
"""
import dataclasses

import jax
import numpy as np
import torch

import test_torch_gnn as gnn_tests
import torch_dist_worker as workers
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import steps as t_steps
from repro_torch.nn import recsys as t_recsys
from repro_torch.train.tree import tree_leaves
from test_torch_lm_train import GRAD_REL, LOSS_ATOL, cfg_pair
from test_torch_sharded_train import SERVE_REL, grad_errors


def _one_thread(fn):
    """``fn()`` on one thread, as the spawned ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def test_mind_train_cell_on_4_ranks_matches_unsharded(tmp_path):
    cfg = t_cfgs.reduced(t_cfgs.get_arch("mind"))  # 1,000 items: 250 rows a device
    shape = t_cfgs.RecsysShape("t", "train", 8)
    rng = np.random.default_rng(23)
    batches = [t_pipe.recsys_batch(rng, cfg, shape) for _ in range(2)]
    params = t_recsys.init(torch.Generator().manual_seed(23), cfg, device="cpu")

    def unsharded():
        with workers.recording_grads() as grads:
            opt_init, step = t_steps.recsys_train_step(cfg, device="cpu")
        p, s, losses = params, opt_init(params), []
        for b in batches:
            p, s, m = step(p, s, b)
            losses.append(m["loss"])
        return losses, grads
    want_losses, want_grads = _one_thread(unsharded)
    got = workers.spawn(workers.recsys_cell_steps, 4, str(tmp_path), cfg, shape, (2, 2), params,
                        batches)[0]
    assert got["placements"] == "(Shard(dim=0), Shard(dim=0))"  # rows over both axes
    for a, b in zip(got["losses"], want_losses, strict=True):
        assert np.isfinite(float(b)) and abs(float(a) - float(b)) <= LOSS_ATOL, (a, b)
    assert len(got["grads"]) == len(want_grads) == 2
    worst = max(max(grad_errors(g, w)) for g, w in zip(got["grads"], want_grads))
    print(f"MIND: largest gradient error {worst:.3e} of a leaf's largest entry")
    assert worst <= GRAD_REL, worst
    assert float(want_grads[0]["items"].abs().sum()) > 0


def test_nequip_train_cell_at_uneven_edges_on_4_ranks_matches_unsharded(tmp_path):
    jcfg, jb, tb = gnn_tests.train_batch_pair("nequip", "molecule")
    _, tcfg = gnn_tests.cfg_pair("nequip")
    jp, tp = gnn_tests.params_pair(jcfg)
    e = 78  # of the batch's 80 edges: 20, 19, 20, 19 a device
    tb = dict(tb, **{k: tb[k][:e] for k in ("src", "dst", "emask")})
    shape = t_cfgs.GNNShape("s", "molecule", 10, 20, d_feat=16, batch_graphs=4)

    def unsharded():
        with workers.recording_grads() as grads:
            opt_init, step = t_steps.gnn_train_step(tcfg, shape, device="cpu")
        return step(tp, opt_init(tp), tb)[2], grads[0]
    want_m, want_g = _one_thread(unsharded)
    got = workers.spawn(workers.gnn_cell_steps, 4, str(tmp_path), {
        "nequip": (tcfg, shape, jax.tree_util.tree_map(np.asarray, jp), tb)}, (2, 2))[0]["nequip"]
    np.testing.assert_allclose(float(got["loss"]), float(want_m["loss"]), **gnn_tests.TOL["nequip"])
    g_leaves, w_leaves = tree_leaves(got["grads"]), tree_leaves(want_g)
    assert len(g_leaves) == len(w_leaves) and sum(float(w.abs().sum()) for w in w_leaves) > 0
    errors = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(g_leaves, w_leaves)]  # a leaf no loss reaches: zeros in both
    print(f"NequIP: largest gradient error {max(errors):.3e} of a leaf's largest entry")
    assert max(errors) <= gnn_tests.NEQUIP_GRAD_SCALE, errors


def test_lm_decode_with_one_query_head_a_kv_head_on_4_ranks(tmp_path):
    _, tcfg = cfg_pair("minitron-8b")
    tcfg = dataclasses.replace(tcfg, n_kv=tcfg.n_heads)
    assert tcfg.n_kv == tcfg.n_heads == 4
    got = workers.spawn(workers.lm_serving_cells, 4, str(tmp_path), tcfg, 4, 256, 248, (2, 2),
                        1)[0]
    assert got["decode"][3] == got["want_decode"][3] == 249
    assert "Shard(dim=2)" in got["cache_placements"]  # the sequence over "model"
    for name in ("prefill", "decode"):
        for a, b in zip(got[name][:3], got["want_" + name]):
            assert a.shape == b.shape and a.dtype == b.dtype
            err = float((a.float() - b.float()).abs().max())
            assert err <= SERVE_REL * float(b.float().abs().max()), (name, err)
