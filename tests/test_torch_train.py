"""repro_torch's training substrate against the JAX package's: checkpoints
(round trip, retention, and restoring what the JAX package wrote), the
fault-tolerant restart loop (bit-exact replay), the straggler watchdog,
the data streams, and ``Trainer.fit`` on the reduced MIND with one and two
microbatches. Losses and parameters are held to 1e-5, the port's MIND
tolerance; streams, checkpoints and restarts exactly."""
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.data import pipeline as j_pipe
from repro.nn import recsys as j_recsys
from repro.train import checkpoint as j_ckpt
from repro.train import ft as j_ft
from repro.train import optimizer as j_opt
from repro.train import trainer as j_trainer
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.nn import recsys as t_recsys
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import ft as ft_mod
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
J_CFG = j_cfgs.reduced(j_cfgs.get_arch("mind"))
T_CFG = t_cfgs.reduced(t_cfgs.get_arch("mind"))
SHAPE = ("t", "train", 64)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def sample_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.tensor([[1.5, -2.0], [3.25, 0.0]], dtype=torch.bfloat16)},
            "e": [None, torch.tensor([True, False, True]), torch.tensor(7, dtype=torch.int32)]}


def assert_same_tensors(got, want):
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_checkpoint_roundtrip(tmp_path):
    tree = sample_tree()
    ckpt_mod.save(str(tmp_path), 7, tree)
    assert ckpt_mod.latest_step(str(tmp_path)) == 7
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_7"]
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5), "d": torch.zeros(2, 2)},
            "e": [None, torch.zeros(3), torch.zeros(())]}
    out = ckpt_mod.restore(str(tmp_path), None, like)
    assert out["e"][0] is None
    assert_same_tensors(out, tree)                 # dtypes as saved, bfloat16 included
    with pytest.raises(ValueError):
        ckpt_mod.restore(str(tmp_path), 7, {"a": torch.zeros(3, 4)})
    with pytest.raises(ValueError):
        ckpt_mod.restore(str(tmp_path), 7, dict(like, a=torch.zeros(4, 3)))
    with pytest.raises(FileNotFoundError):
        ckpt_mod.restore(str(tmp_path / "none"), None, like)


def test_checkpoint_retention(tmp_path):
    tree = {"x": torch.zeros((2,))}
    threads = [ckpt_mod.save(str(tmp_path), s, tree, wait=False) for s in (1, 2, 3, 4, 5)]
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    ckpt_mod.retain(str(tmp_path), keep=2)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_4", "step_5"]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_checkpoint_keeps_the_jax_layout(tmp_path):
    """Same files, numbered in the same flatten order as the JAX package's
    save of the same values; the manifest is JSON."""
    tree = sample_tree()
    jtree = {"a": jnp.asarray(tree["a"].numpy()),
             "b": {"c": jnp.ones((5,), jnp.int32),
                   "d": jnp.asarray(tree["b"]["d"].float().numpy()).astype(jnp.bfloat16)},
             "e": [None, jnp.asarray([True, False, True]), jnp.asarray(7, jnp.int32)]}
    ckpt_mod.save(str(tmp_path / "t"), 3, tree)
    j_ckpt.save(str(tmp_path / "j"), 3, jtree)
    t_dir, j_dir = tmp_path / "t" / "step_3", tmp_path / "j" / "step_3"
    t_files = sorted(n for n in os.listdir(t_dir) if n.endswith(".npy"))
    assert t_files == sorted(n for n in os.listdir(j_dir) if n.endswith(".npy"))
    for name in t_files:
        a, b = np.load(t_dir / name), np.load(j_dir / name)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert "manifest.json" in os.listdir(t_dir)


def test_restore_reads_a_checkpoint_the_jax_package_wrote(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w), "eps": None,
                        "m": jnp.asarray(w).astype(jnp.bfloat16)},
             "step": jnp.asarray(9, jnp.int32), "mask": jnp.asarray([True, False])}
    j_ckpt.save(str(tmp_path), 12, jtree)
    like = {"params": {"w": torch.zeros(4, 3), "eps": None, "m": torch.zeros(4, 3)},
            "step": torch.zeros((), dtype=torch.int32), "mask": torch.zeros(2, dtype=torch.bool)}
    out = ckpt_mod.restore(str(tmp_path), None, like)
    assert ckpt_mod.latest_step(str(tmp_path)) == 12
    assert out["params"]["eps"] is None
    assert torch.equal(out["params"]["w"], torch.from_numpy(w))
    assert out["params"]["m"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["m"], torch.from_numpy(w).to(torch.bfloat16))
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 9
    assert out["mask"].tolist() == [True, False]


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_train_infra.py's checks, and the watchdog
# against the JAX package's)
# ---------------------------------------------------------------------------
def _counter_run(tmp_path, fail_at=()):
    def init_state():
        return {"x": torch.zeros((3,)), "steps_seen": torch.zeros((), dtype=torch.int32)}

    def step_fn(state, step):
        return {"x": state["x"] + step, "steps_seen": state["steps_seen"] + 1}

    return ft_mod.run_with_restarts(
        init_state, step_fn, num_steps=25, ckpt_dir=str(tmp_path), ckpt_every=5,
        injector=ft_mod.FailureInjector(fail_at=fail_at))


def test_ft_restart_bit_exact(tmp_path):
    clean = _counter_run(tmp_path / "clean")
    faulty = _counter_run(tmp_path / "faulty", fail_at=(7, 12, 23))
    assert faulty.restarts == 3 and clean.restarts == 0
    assert torch.equal(clean.state["x"], faulty.state["x"])
    assert torch.equal(faulty.state["x"], torch.full((3,), float(sum(range(25)))))
    assert int(faulty.state["steps_seen"]) == 25
    assert faulty.steps_done == 25


def test_ft_too_many_failures_raises(tmp_path):
    with pytest.raises(ft_mod.InjectedFailure):
        ft_mod.run_with_restarts(
            lambda: {"x": torch.zeros(())}, lambda s, i: s, num_steps=10,
            ckpt_dir=str(tmp_path), injector=ft_mod.FailureInjector(fail_at=tuple(range(10))),
            max_restarts=3)


@pytest.mark.parametrize("slow_steps,hosts", [((10, 13, 16), (2, 2, 2)), ((10, 13), (1, 3)),
                                              ((5, 9, 12, 18), (None,) * 4), ((), ())])
def test_straggler_watchdog_matches_jax(slow_steps, hosts):
    t_wd = ft_mod.StragglerWatchdog(window=8, threshold=2.0)
    j_wd = j_ft.StragglerWatchdog(window=8, threshold=2.0)
    for step in range(20):
        slow = step in slow_steps
        per_host = np.ones(4)
        host = hosts[slow_steps.index(step)] if slow else None
        if host is not None:
            per_host[host] = 5.0
        args = (step, 5.0 if slow else 1.0 + 0.01 * step, None if host is None and slow
                else per_host)
        assert t_wd.record(*args) == j_wd.record(*args)
    assert t_wd.events == j_wd.events
    assert t_wd.decide() == j_wd.decide()
    if slow_steps == (10, 13, 16):
        assert t_wd.decide() == {"action": "evict_host", "host": 2, "then": "elastic_restore"}


# ---------------------------------------------------------------------------
# data streams
# ---------------------------------------------------------------------------
def test_batches_and_make_batch_fn_match_jax():
    t_shape, j_shape = t_cfgs.RecsysShape(*SHAPE), j_cfgs.RecsysShape(*SHAPE)
    t_fn = t_pipe.make_batch_fn("recsys", T_CFG, t_shape, seed=3)
    j_fn = j_pipe.make_batch_fn("recsys", J_CFG, j_shape, seed=3)
    t_it = t_pipe.batches("recsys", T_CFG, t_shape, seed=3)
    j_it = j_pipe.batches("recsys", J_CFG, j_shape, seed=3)
    for step in range(4):
        want = j_fn(step)
        for got in (t_fn(step), next(t_it)):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(next(j_it)["hist"], want["hist"])
    assert not np.array_equal(t_fn(0)["hist"], t_fn(1)["hist"])
    # the "lm" kind (once raising here) draws the JAX package's LM batches
    lm = [t_cfgs.reduced(t_cfgs.get_arch("minitron-8b")),
          j_cfgs.reduced(j_cfgs.get_arch("minitron-8b"))]
    t_lm = t_pipe.make_batch_fn("lm", lm[0], t_cfgs.LMShape("s", "train", 16, 4), seed=3)
    j_lm = j_pipe.make_batch_fn("lm", lm[1], j_cfgs.LMShape("s", "train", 16, 4), seed=3)
    t_lm_it = t_pipe.batches("lm", lm[0], t_cfgs.LMShape("s", "train", 16, 4), seed=3)
    for step in range(2):
        want = j_lm(step)
        for got in (t_lm(step), next(t_lm_it)):
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        t_pipe.make_batch_fn("gnn", T_CFG, t_shape)(0)


def test_prefetcher_keeps_order_and_stops_on_close():
    made = []

    def make(step):
        made.append(step)
        return {"step": step, "thread": threading.current_thread().name}

    pf = t_pipe.Prefetcher(make, depth=2)
    got = [next(pf) for _ in range(6)]
    assert [b["step"] for b in got] == list(range(6))
    assert all(b["thread"] != threading.current_thread().name for b in got)
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(made) <= 6 + 3   # the queue's depth and one batch in hand
    assert iter(pf) is pf


# ---------------------------------------------------------------------------
# Trainer.fit against the JAX package's Trainer on the same batch function
# ---------------------------------------------------------------------------
def _fit_both(microbatches, tmp_path=None, fail_at=(), num_steps=6):
    key = jax.random.PRNGKey(0)
    j_params = jax.tree_util.tree_map(np.asarray, j_recsys.init(key, J_CFG))
    batch_fn = t_pipe.make_batch_fn("recsys", T_CFG, t_cfgs.RecsysShape(*SHAPE), seed=1)
    tcfg = dict(num_steps=num_steps, microbatches=microbatches, log_every=1)
    j_tr = j_trainer.Trainer(
        lambda p, b: j_recsys.loss_fn(p, J_CFG, b), lambda: j_recsys.init(key, J_CFG),
        j_opt.OptConfig(name="adamw", lr=1e-3), j_trainer.TrainerConfig(**tcfg))
    j_state = j_tr.fit(batch_fn)
    ckpt = dict(ckpt_dir=str(tmp_path), ckpt_every=2) if tmp_path is not None else {}
    t_tr = Trainer(
        lambda p, b: t_recsys.loss_fn(p, T_CFG, b),
        lambda: convert.mind_params_from_numpy(j_params, "cpu"),
        t_opt.OptConfig(name="adamw", lr=1e-3), TrainerConfig(**tcfg, **ckpt), device="cpu")
    t_state = t_tr.fit(batch_fn, injector=ft_mod.FailureInjector(fail_at=fail_at))
    return j_tr, j_state, t_tr, t_state


def _history(trainer):
    """The last record of each step (a restart logs replayed steps again)."""
    return {h["step"]: h for h in trainer.history}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_fit_matches_the_jax_trainer(microbatches, capsys):
    j_tr, j_state, t_tr, t_state = _fit_both(microbatches)
    lines = capsys.readouterr().out.splitlines()
    want, got = _history(j_tr), _history(t_tr)
    assert sorted(got) == sorted(want) == list(range(1, 7))
    for step in want:
        assert sorted(got[step]) == sorted(want[step]) == ["gnorm", "loss", "step"]
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(got[step][k], want[step][k], err_msg=f"{k} {step}", **TOL)
    assert want[6]["loss"] < want[1]["loss"]
    # the same "[train] step" lines from both
    pattern = re.compile(r"^\[train\] step +(\d+) gnorm=(\S+) loss=(\S+)$")
    parsed = [pattern.match(line) for line in lines if line.startswith("[train]")]
    assert all(parsed) and len(parsed) == 12
    assert [int(m.group(1)) for m in parsed] == list(range(1, 7)) * 2
    for t_param, j_param in zip(tree_leaves(t_state), jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_allclose(np.asarray(t_param.float()), np.asarray(j_param), **TOL)
    assert int(t_state["opt"]["step"]) == 6


def test_fit_with_checkpoints_and_failures_replays_bit_exact(tmp_path):
    """With ckpt_dir, failures at steps 3 and 5 restart from the latest
    checkpoint (every 2 steps); the history and the final state equal a
    clean run's bit for bit, and still match the JAX package's Trainer."""
    _, _, clean, clean_state = _fit_both(2, tmp_path / "clean")
    j_tr, j_state, t_tr, t_state = _fit_both(2, tmp_path / "faulty", fail_at=(3, 5))
    assert t_tr.restarts == 2 and clean.restarts == 0
    assert _history(t_tr) == _history(clean)
    assert len(t_tr.history) == 6 + 2         # steps 3 and 5 ran again after restoring
    assert_same_tensors(t_state, clean_state)
    for t_param, j_param in zip(tree_leaves(t_state), jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_allclose(np.asarray(t_param.float()), np.asarray(j_param), **TOL)
    assert ckpt_mod.latest_step(str(tmp_path / "faulty")) == 6
