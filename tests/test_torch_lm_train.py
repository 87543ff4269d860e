"""repro_torch's LM training (``nn.transformer.loss_fn``,
``launch.steps.lm_train_step``, the donated optimizer update, ``Trainer``
over the LM) against the JAX package's, on the CPU.

Parameters come from the JAX ``init`` through
``convert.lm_params_from_numpy``; batches from ``pipeline.lm_batch`` on a
numpy seed. Tolerances, measured on the five reduced configs:

- the loss: ``LOSS_ATOL`` = 1e-3 absolute (measured: up to 9.4e-5 on the
  dense configs over six batches of 4 x 256, 1.9e-4 on the MoE configs);
- each gradient leaf: ``GRAD_REL`` = 5e-2 of the leaf's largest entry
  (measured: 9.3e-3 dense, 2.7e-2 MoE). The bfloat16 products round
  differently in 0.005-0.025% of elements (``tests/test_torch_lm.py``),
  and a backward carries those through every layer twice;
- parameters after AdamW steps: Adam moves an element by about ``lr`` a
  step whatever the gradient's size, so where a gradient is near zero a
  rounding can turn its sign: every element within 2 * lr * steps, and at
  most ``FAR_SHARE`` = 1% of elements further apart than 1e-4 (measured:
  0.42% after 3 steps at lr 1e-3, the largest 4.4e-3).

A MoE model is not continuous (``tests/test_torch_lm.py``): the MoE
configs are compared over the batches whose expert picks, recorded at
every MoE call in both packages, are all equal; the test prints how many
batches it left out and requires one compared.

Donation, the restarts and the remat options are held to equal bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.data import pipeline as j_pipe
from repro.launch import steps as j_steps
from repro.launch.mesh import make_debug_mesh
from repro.nn import transformer as j_tfm
from repro.train import optimizer as j_opt
from repro.train import trainer as j_trainer
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import steps as t_steps
from repro_torch.nn import transformer as t_tfm
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import ft as ft_mod
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad
from repro_torch.train.tree import tree_leaves, tree_map
from test_torch_lm import Routing

LM_ARCHS = ["minitron-8b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
            "nemotron-4-340b"]
LOSS_ATOL = 1e-3
GRAD_REL = 5e-2
FAR_SHARE = 0.01
OPTS = {"sgd": t_opt.OptConfig(name="sgd", lr=1e-2),
        "adamw-f32": t_opt.OptConfig(name="adamw", lr=1e-3),
        "adamw-bf16": t_opt.OptConfig(name="adamw", lr=1e-3, moment_dtype="bfloat16"),
        "adafactor": t_opt.OptConfig(name="adafactor", lr=1e-2)}


def cfg_pair(arch, **kw):
    return (dataclasses.replace(j_cfgs.reduced(j_cfgs.get_arch(arch)), **kw),
            dataclasses.replace(t_cfgs.reduced(t_cfgs.get_arch(arch)), **kw))


def jax_params(cfg, seed: int = 0):
    """The JAX package's parameters and the port's copy of them."""
    jp = j_tfm.init(jax.random.PRNGKey(seed), cfg)
    return jp, convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def batch(cfg, b: int, s: int, seed: int):
    return j_pipe.lm_batch(np.random.default_rng(seed), cfg, b, s)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def as_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def leaf_errors(got, want) -> list:
    """Per leaf: the largest difference over the leaf's largest entry."""
    out = []
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        out.append(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)))
    return out


def assert_params_close(got, want, lr: float, steps: int) -> None:
    """The AdamW parameter bound of the module's docstring."""
    diffs = np.concatenate([np.abs(g.float().numpy() - np.asarray(w, np.float32)).ravel()
                            for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want))])
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert np.mean(diffs > 1e-4) <= FAR_SHARE, np.mean(diffs > 1e-4)


def same_bits(got, want) -> bool:
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.uint8) if x.dim() else x, y.view(
            torch.uint8) if y.dim() else y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------
TINY = t_cfgs.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
                       vocab=97, act="silu", gated=True, remat=False, microbatches=1)


def test_chunked_loss_matches_full():
    """tests/test_nn.py::test_chunked_loss_matches_full on the port: 1,024
    positions in 8 chunks against the full log-softmax (< 1e-3)."""
    params = t_tfm.init(torch.Generator().manual_seed(1), TINY, device="cpu")
    rng = np.random.default_rng(1)
    b = {k: torch.from_numpy(rng.integers(0, TINY.vocab, (2, 1024)).astype(np.int32))
         for k in ("tokens", "labels")}
    loss = t_tfm.loss_fn(params, TINY, b)
    logits, aux = t_tfm.forward(params, TINY, b["tokens"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, b["labels"].long()[..., None])[..., 0]
    ref = -ll.mean() + 0.01 * aux
    assert float(torch.abs(loss - ref)) < 1e-3


def test_train_step_reduces_loss():
    """tests/test_nn.py::test_train_step_reduces_loss on the port."""
    params = t_tfm.init(torch.Generator().manual_seed(2), TINY, device="cpu")
    opt_init, opt_update = t_opt.make(t_opt.OptConfig(name="adamw", lr=3e-3))
    opt_state = opt_init(params)
    rng = np.random.default_rng(2)
    b = {k: torch.from_numpy(rng.integers(0, TINY.vocab, (4, 64)).astype(np.int32))
         for k in ("tokens", "labels")}
    losses = []
    for _ in range(8):
        loss, g = value_and_grad(t_tfm.loss_fn, params, TINY, b)
        params, opt_state = opt_update(g, opt_state, params)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_train_step(arch):
    """tests/test_smoke_archs.py::test_lm_smoke_train_step on the port."""
    cfg = t_cfgs.reduced(t_cfgs.get_arch(arch))
    params = t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = as_torch(t_pipe.lm_batch(np.random.default_rng(0), cfg, 4, 64))
    opt_init, opt_update = t_opt.make(t_opt.OptConfig(lr=1e-3))
    loss, grads = value_and_grad(t_tfm.loss_fn, params, cfg, b)
    new_params, _ = opt_update(grads, opt_init(params), params)
    assert np.isfinite(float(loss)) and float(loss) > 0
    for leaf in tree_leaves(new_params):
        assert torch.isfinite(leaf.float()).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    """The loss and every gradient against ``jax.value_and_grad(loss_fn)``:
    dense configs on 2 batches of 4 x 256 (2 loss chunks), MoE configs on
    8 batches of 2 x 32 over those routed alike in both packages."""
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = jax_params(jcfg)
    routing = Routing(monkeypatch)
    # traced here, under the patch: the trace calls this test's recorder
    j_value_and_grad = jax.jit(jax.value_and_grad(j_tfm.loss_fn), static_argnums=1)
    b, s, seeds = (2, 32, range(8)) if jcfg.moe else (4, 256, range(2))
    compared, left_out, worst = 0, 0, 0.0
    for seed in seeds:
        nb = batch(jcfg, b, s, seed)
        jl, jg = j_value_and_grad(jp, jcfg, as_jax(nb))
        tl, tg = value_and_grad(t_tfm.loss_fn, tp, tcfg, as_torch(nb))
        if not routing.agree(b).all():
            left_out += 1
            continue
        compared += 1
        assert abs(float(tl) - float(jl)) <= LOSS_ATOL, (float(tl), float(jl))
        errs = leaf_errors(tg, jg)
        assert max(errs) <= GRAD_REL, errs
        worst = max(worst, max(errs))
    print(f"{arch}: {compared} batches compared, {left_out} left out (routed apart); "
          f"largest gradient error {worst:.3e} of a leaf's largest entry")
    assert compared >= 1
    if not jcfg.moe:
        assert left_out == 0


def test_lengths_the_chunks_do_not_tile_raise():
    """s = 257 is 2 chunks of 128 and one position left over: the JAX
    package's reshape fails, and the port raises."""
    jcfg, tcfg = cfg_pair("starcoder2-7b")
    jp, tp = jax_params(jcfg)
    nb = batch(jcfg, 1, 257, 0)
    with pytest.raises(TypeError):
        j_tfm.loss_fn(jp, jcfg, as_jax(nb))
    with pytest.raises(ValueError, match="not 2 chunks of 128"):
        t_tfm.loss_fn(tp, tcfg, as_torch(nb))


def _indexed_layers(params):
    return [t_tfm.layer_params(params, i)
            for i in range(params["layers"]["ln1"]["g"].shape[0])]


@pytest.mark.parametrize("arch", ["minitron-8b", "phi3.5-moe-42b-a6.6b"])
def test_remat_and_layer_groups_change_no_bit(arch, monkeypatch):
    """``remat`` per layer, ``layer_groups`` of 2 and of 4 layers, and
    neither: the same loss and gradients bit for bit; so are the layers
    taken by ``a[i]`` instead of one ``unbind``."""
    _, cfg = cfg_pair(arch, n_layers=4)
    params = t_tfm.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = as_torch(t_pipe.lm_batch(np.random.default_rng(3), cfg, 2, 256))
    runs = {}
    for name, kw in {"plain": dict(remat=False), "remat": dict(remat=True),
                     "groups of 2": dict(layer_groups=2), "groups of 4": dict(layer_groups=4),
                     "groups that do not divide": dict(layer_groups=3, remat=True)}.items():
        runs[name] = value_and_grad(t_tfm.loss_fn, params, dataclasses.replace(cfg, **kw), b)
    monkeypatch.setattr(t_tfm, "unbind_layers", _indexed_layers)
    runs["indexed"] = value_and_grad(t_tfm.loss_fn, params, dataclasses.replace(
        cfg, remat=False), b)
    want = runs.pop("plain")
    for name, got in runs.items():
        assert torch.equal(got[0], want[0]), name
        assert all(torch.equal(g, w) for g, w in zip(tree_leaves(got[1]), tree_leaves(want[1]))), \
            name


# ---------------------------------------------------------------------------
# the LM train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [1, 2])
def test_lm_train_step_matches_jax_cell(mb):
    """``lm_train_step`` against ``_lm_train_cell(...).step_fn`` on a 1 x 1
    debug mesh, 3 steps from the same weights, the cell's optimizer
    (``for_arch``: AdamW at lr 1e-3) from zeros, on batches of 4 x 256."""
    jcfg, tcfg = cfg_pair("minitron-8b", microbatches=mb)
    shape = ("t", "train", 256, 4)
    cell = j_steps._lm_train_cell(jcfg, j_cfgs.LMShape(*shape), make_debug_mesh(1, 1))
    assert cell.donate == (0, 1)
    jp, tp = jax_params(jcfg)
    jo = j_opt.make(j_opt.for_arch(jcfg))[0](jp)
    opt_init, step = t_steps.lm_train_step(tcfg, t_cfgs.LMShape(*shape), device="cpu")
    to = opt_init(tp)
    jstep = jax.jit(cell.step_fn)
    for s in range(3):
        nb = batch(jcfg, 4, 256, s)
        jp, jo, jm = jstep(jp, jo, as_jax(nb))
        tp, to, tm = step(tp, to, nb)
        assert sorted(tm) == sorted(jm) == ["loss"]
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert int(to["step"]) == int(jo["step"]) == 3
    assert_params_close(tp, jp, lr=1e-3, steps=3)
    assert_params_close(to["m"], jo["m"], lr=1e-3, steps=3)


def test_lm_train_step_microbatches_and_optimizer():
    """The step's microbatch count is ``min(cfg.microbatches,
    global_batch)`` and must divide the batch; nemotron-4-340b trains
    with Adafactor, the others with AdamW."""
    _, cfg = cfg_pair("minitron-8b", microbatches=3)
    with pytest.raises(ValueError, match="3 microbatches do not divide a batch of 4"):
        t_steps.lm_train_step(cfg, t_cfgs.LMShape("t", "train", 64, 4), device="cpu")
    t_steps.lm_train_step(cfg, t_cfgs.LMShape("t", "train", 64, 2), device="cpu")
    _, nemo = cfg_pair("nemotron-4-340b")
    params = t_tfm.init(torch.Generator().manual_seed(0), nemo, device="cpu")
    state = t_steps.lm_train_step(nemo, t_cfgs.LMShape("t", "train", 64, 2),
                                  device="cpu")[0](params)
    assert sorted(state) == ["step", "v"] and "vr" in state["v"]["lm_head"]["w"]


def test_lm_train_step_donates():
    """With ``donate`` the step writes the parameters and state it is given
    and returns those tensors; without, it leaves them as they were. Both
    give the same bits."""
    _, cfg = cfg_pair("starcoder2-7b", microbatches=2)
    shape = t_cfgs.LMShape("t", "train", 128, 4)
    nb = t_pipe.lm_batch(np.random.default_rng(0), cfg, 4, 128)
    params = t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    keep = tree_map(torch.clone, params)
    init, undonated = t_steps.lm_train_step(cfg, shape, device="cpu", donate=False)
    want = undonated(params, init(params), nb)
    assert same_bits(params, keep)
    donated = t_steps.lm_train_step(cfg, shape, device="cpu")[1]
    state = init(params)
    got = donated(params, state, nb)
    assert all(a is b for a, b in zip(tree_leaves(got[0]), tree_leaves(params)))
    assert all(a is b for a, b in zip(tree_leaves(got[1]["m"]), tree_leaves(state["m"])))
    assert not same_bits(params, keep)
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert torch.equal(got[2]["loss"], want[2]["loss"])


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------
def _opt_tree(seed: int):
    """A dict, a list with a None, a scalar, (1, n) and 3-D leaves."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return {"dense": {"w": r(37, 5), "b": r(5)}, "layers": [r(3, 6, 4), None, r(1, 7)],
            "scale": r()}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_donated_update_matches_out_of_place_bits(opt, monkeypatch):
    """Every optimizer: 3 donated updates against 3 out-of-place ones from
    the same state, bit for bit, with the elementwise updates cut into
    slices of 7 elements (rows of 5 and 24 split unevenly) and whole."""
    init, update = t_opt.make(OPTS[opt])
    for slice_elems in (7, t_opt.SLICE):
        monkeypatch.setattr(t_opt, "SLICE", slice_elems)
        params = _opt_tree(0)
        out_p, out_s = params, init(params)
        don_p, don_s = tree_map(torch.clone, params), init(params)
        for s in range(3):
            grads = tree_map(lambda p: p * 0.1 + 0.05 * (s + 1), _opt_tree(s + 1))
            out_p, out_s = update(grads, out_s, out_p)
            ids = [id(t) for t in tree_leaves(don_p)]
            don_p, don_s = update(grads, don_s, don_p, donate=True)
            assert [id(t) for t in tree_leaves(don_p)] == ids
        assert same_bits(don_p, out_p) and same_bits(don_s, out_s), (opt, slice_elems)
        assert same_bits(params, _opt_tree(0))      # the out-of-place updates wrote nothing


def _lm_trainer(cfg, opt_cfg, donate: bool, steps: int = 3, **tcfg):
    return Trainer(lambda p, b: t_tfm.loss_fn(p, cfg, b),
                   lambda: t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                   opt_cfg, TrainerConfig(num_steps=steps, microbatches=2, log_every=1,
                                          donate=donate, **tcfg), device="cpu")


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_donated_fit_matches_undonated_bits(opt):
    """``Trainer.fit`` on a reduced LM, 2 microbatches, donated and not: the
    same history and final state bit for bit, for every optimizer."""
    _, cfg = cfg_pair("minitron-8b")
    batch_fn = t_pipe.make_batch_fn("lm", cfg, t_cfgs.LMShape("t", "train", 128, 4), seed=1)
    runs = {}
    for donate in (True, False):
        tr = _lm_trainer(cfg, OPTS[opt], donate)
        runs[donate] = (tr.fit(batch_fn), tr.history)
    assert runs[True][1] == runs[False][1]
    assert same_bits(runs[True][0], runs[False][0])


def test_donated_fit_with_restart_matches_clean_fit(tmp_path):
    """A donated fit with checkpoints every 2 steps and failures at steps 3
    and 4 restarts twice and ends with a clean fit's history and state bit
    for bit (and its initial parameters are copies: ``init_params``'s
    tensors are never written)."""
    _, cfg = cfg_pair("starcoder2-7b")
    batch_fn = t_pipe.make_batch_fn("lm", cfg, t_cfgs.LMShape("t", "train", 128, 4), seed=2)
    held = t_tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    keep = tree_map(torch.clone, held)
    clean = _lm_trainer(cfg, OPTS["adamw-f32"], True, steps=6)
    clean.init_params = lambda: held
    want = clean.fit(batch_fn)
    assert same_bits(held, keep)
    faulty = _lm_trainer(cfg, OPTS["adamw-f32"], True, steps=6, ckpt_dir=str(tmp_path),
                         ckpt_every=2)
    got = faulty.fit(batch_fn, injector=ft_mod.FailureInjector(fail_at=(3, 4)))
    assert faulty.restarts == 2
    assert {h["step"]: h for h in faulty.history} == {h["step"]: h for h in clean.history}
    assert same_bits(got, want)
    assert ckpt_mod.latest_step(str(tmp_path)) == 6


# ---------------------------------------------------------------------------
# Trainer against the JAX package's
# ---------------------------------------------------------------------------
def _jax_trainer(cfg, steps: int, mb: int, ckpt_dir=None):
    return j_trainer.Trainer(
        lambda p, b: j_tfm.loss_fn(p, cfg, b), lambda: j_tfm.init(jax.random.PRNGKey(0), cfg),
        j_opt.OptConfig(name="adamw", lr=1e-3),
        j_trainer.TrainerConfig(num_steps=steps, microbatches=mb, log_every=1,
                                ckpt_dir=ckpt_dir, ckpt_every=2))


def _port_trainer(cfg, steps: int, mb: int, ckpt_dir=None):
    jp = j_tfm.init(jax.random.PRNGKey(0), cfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    _, tcfg = cfg_pair(cfg.name.removesuffix("-smoke"))
    return Trainer(lambda p, b: t_tfm.loss_fn(p, tcfg, b),
                   lambda: convert.lm_params_from_numpy(host, "cpu"),
                   t_opt.OptConfig(name="adamw", lr=1e-3),
                   TrainerConfig(num_steps=steps, microbatches=mb, log_every=1,
                                 ckpt_dir=ckpt_dir, ckpt_every=2), device="cpu")


@pytest.mark.parametrize("mb", [1, 2])
def test_fit_matches_the_jax_trainer(mb):
    """``Trainer.fit`` on the reduced minitron against the JAX ``Trainer``
    on the same weights and batches: 4 steps, loss and gradient norm each
    step, then the parameters."""
    jcfg, tcfg = cfg_pair("minitron-8b")
    batch_fn = j_pipe.make_batch_fn("lm", jcfg, j_cfgs.LMShape("t", "train", 128, 4), seed=3)
    j_tr, t_tr = _jax_trainer(jcfg, 4, mb), _port_trainer(jcfg, 4, mb)
    j_state, t_state = j_tr.fit(batch_fn), t_tr.fit(batch_fn)
    assert [h["step"] for h in t_tr.history] == [h["step"] for h in j_tr.history] == [1, 2, 3, 4]
    for got, want in zip(t_tr.history, j_tr.history):
        assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL, (got, want)
        assert abs(got["gnorm"] - want["gnorm"]) <= GRAD_REL * want["gnorm"], (got, want)
    assert j_tr.history[-1]["loss"] < j_tr.history[0]["loss"]
    assert_params_close(t_state["params"], j_state["params"], lr=1e-3, steps=4)
    assert int(t_state["opt"]["step"]) == 4


def test_restores_a_jax_written_lm_checkpoint(tmp_path):
    """The JAX ``Trainer`` checkpoints the reduced minitron after 4 steps;
    the port's ``Trainer`` restores it and trains steps 5 and 6 to the JAX
    package's own losses for those steps and to its parameters."""
    jcfg, _ = cfg_pair("minitron-8b")
    batch_fn = j_pipe.make_batch_fn("lm", jcfg, j_cfgs.LMShape("t", "train", 128, 4), seed=4)
    _jax_trainer(jcfg, 4, 1, ckpt_dir=str(tmp_path)).fit(batch_fn)
    assert ckpt_mod.latest_step(str(tmp_path)) == 4
    j_tr = _jax_trainer(jcfg, 6, 1)
    j_state = j_tr.fit(batch_fn)
    t_tr = _port_trainer(jcfg, 6, 1, ckpt_dir=str(tmp_path))
    t_state = t_tr.fit(batch_fn)
    assert [h["step"] for h in t_tr.history] == [5, 6]
    for got, want in zip(t_tr.history, j_tr.history[4:]):
        assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL, (got, want)
    assert_params_close(t_state["params"], j_state["params"], lr=1e-3, steps=6)
    assert int(t_state["opt"]["step"]) == 6 and ckpt_mod.latest_step(str(tmp_path)) == 6
