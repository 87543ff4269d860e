"""4-rank checks of the mesh layer on the CPU over gloo (spawned ranks, as
tests/torch_dist_worker.py spawns them, over a (2, 2) debug mesh):

- the hand-written backward rules of ``dist.sharding`` (``LocalRows``,
  ``local_segment_sum``, ``LocalSegmentExtreme``) against the same
  functions unsharded and against JAX's segment max and min;
- ``Trainer(mesh=)`` with checkpoints in one directory and injected
  failures: rank 0 alone writes, every rank restores, and the restarted
  fit keeps the bits of a clean one.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_worker as workers
from repro_torch.configs import base as t_cfgs
from repro_torch.train.tree import tree_map
from test_torch_lm_train import LOSS_ATOL, assert_params_close, same_bits
from test_torch_sharded_train import SHAPE, _lm_trainer, make_case


def test_local_rules_gradients_on_4_ranks(tmp_path):
    """The hand-written backward rules of ``dist.sharding`` on 4 ranks over
    (2, 2), 38 rows split unevenly: ``LocalRows`` (``nn.gnn._rows``),
    ``local_segment_sum`` (``nn.gnn._seg_sum``) and ``LocalSegmentExtreme``
    (``nn.gnn._seg_extreme``, rows drawn from {0, 1, 2} so that most
    segments tie across devices, some at 0, and one segment empty) against
    the same functions unsharded, and the extremes' gradients against
    ``jax.ops.segment_max``/``segment_min``'s: outputs and gradients to
    1e-6 (float32 sums in another order; a tie's share is 1 / count)."""
    from repro_torch.nn import gnn

    rng = np.random.default_rng(22)
    n, e, d = 7, 38, 3
    ids = torch.from_numpy(rng.integers(0, n - 1, e))  # segment n - 1 stays empty
    table = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    x = torch.from_numpy(rng.integers(0, 3, (e, d)).astype(np.float32))
    weights = {k: torch.from_numpy(rng.standard_normal(shape, np.float32))
               for k, shape in (("rows", (e, d)), ("segment_sum", (n, d)),
                                ("segment_max", (n, d)), ("segment_min", (n, d)))}
    plain = {"rows": lambda t: gnn._rows(t, ids),
             "segment_sum": lambda r: gnn._seg_sum(r, ids, n),
             "segment_max": lambda r: gnn._seg_extreme(r, ids, n, "amax"),
             "segment_min": lambda r: gnn._seg_extreme(r, ids, n, "amin")}
    got = workers.spawn(workers.local_rule_grads, 4, str(tmp_path), table, x, ids, weights,
                        (2, 2))[0]
    ties = 0
    for name, fn in plain.items():
        arg = (table if name == "rows" else x).clone().requires_grad_(True)
        want = fn(arg)
        (want * weights[name]).sum().backward()
        out, grad = got[name]
        np.testing.assert_allclose(out.numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(grad.numpy(), arg.grad.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        if name in ("segment_max", "segment_min"):
            hit = (x == want.detach()[ids]).float()
            ties += int((torch.zeros(n, d).index_add_(0, ids, hit) > 1).sum())
            seg = jax.ops.segment_max if name == "segment_max" else jax.ops.segment_min

            def jax_loss(v, seg=seg, w=jnp.asarray(weights[name].numpy())):
                out = seg(v, jnp.asarray(ids.numpy()), num_segments=n)
                return (jnp.where(jnp.isfinite(out), out, 0.0) * w).sum()
            np.testing.assert_allclose(grad.numpy(), np.asarray(jax.grad(jax_loss)(
                jnp.asarray(x.numpy()))), rtol=1e-6, atol=1e-6, err_msg=f"{name} against JAX")
    assert ties > 0


def test_trainer_with_a_mesh_restarts_on_4_ranks(tmp_path):
    """``Trainer(mesh=)`` on 4 ranks over (2, 2) with checkpoints in one
    directory and two injected failures: rank 0 alone writes each
    checkpoint, and every rank restores it; the restarted fit has the
    bits of the clean 4-rank fit, and both are within the LM cell test's
    tolerances of the unsharded fit."""
    from repro_torch.data import pipeline as t_pipe

    case = make_case("minitron-8b")
    shape = t_cfgs.LMShape(*SHAPE)
    clean = _lm_trainer(case)
    want = clean.fit(t_pipe.make_batch_fn("lm", case["tcfg"], shape, seed=5))
    ranks = workers.spawn(workers.lm_trainer_fits, 4, str(tmp_path), case["tcfg"], shape, (2, 2),
                          case["host"], 4, str(tmp_path / "ck"))
    def by_step(history):
        return {h["step"]: h for h in history}

    for r in ranks:
        assert r["restarted"]["restarts"] == 2
        assert by_step(r["restarted"]["history"]) == by_step(r["clean"]["history"]) == by_step(
            ranks[0]["clean"]["history"])
        assert same_bits(r["restarted"]["state"], ranks[0]["clean"]["state"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_2", "step_4"]
    got = ranks[0]["clean"]
    assert [h["step"] for h in got["history"]] == [h["step"] for h in clean.history] == [1, 2, 3, 4]
    for a, b in zip(got["history"], clean.history):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL, (a, b)
    assert_params_close(got["state"]["params"], tree_map(lambda x: x.numpy(), want["params"]),
                        lr=1e-3, steps=4)
