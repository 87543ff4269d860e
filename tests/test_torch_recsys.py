"""repro_torch's MIND serving functions, configs and data against the JAX
package's, at the reduced MIND. Parameters come from the JAX ``init`` and
reach the port through ``convert.mind_params_from_numpy``; inputs come
from numpy seeds. Scores are held to 1e-5, the reference serving tests'
own tolerance (tests/test_serve.py); ids and lookups are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.data import pipeline as j_pipe
from repro.nn import layers as j_layers
from repro.nn import recsys as j_recsys
from repro.train import optimizer as j_opt
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import steps as t_steps
from repro_torch.nn import layers as t_layers
from repro_torch.nn import recsys as t_recsys
from repro_torch.train.trainer import value_and_grad
from repro_torch.train.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
J_CFG = j_cfgs.reduced(j_cfgs.get_arch("mind"))
T_CFG = t_cfgs.reduced(t_cfgs.get_arch("mind"))


def params_pair(hot_rows=0, seed=0):
    jp = j_recsys.init(jax.random.PRNGKey(seed), J_CFG, hot_rows=hot_rows)
    return jp, convert.mind_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_configs_match():
    for name in ("mind",):
        assert dataclasses.asdict(t_cfgs.get_arch(name)) == dataclasses.asdict(
            j_cfgs.get_arch(name))
    assert dataclasses.asdict(T_CFG) == dataclasses.asdict(J_CFG)
    assert {k: dataclasses.asdict(v) for k, v in t_cfgs.RECSYS_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_cfgs.RECSYS_SHAPES.items()}
    with pytest.raises(TypeError):
        t_cfgs.reduced(object())


@pytest.mark.parametrize("shape", sorted(t_cfgs.RECSYS_SHAPES))
def test_recsys_batch_and_zipf_ids_identical(shape):
    t = t_pipe.recsys_batch(np.random.default_rng(3), T_CFG, t_cfgs.RECSYS_SHAPES[shape])
    j = j_pipe.recsys_batch(np.random.default_rng(3), J_CFG, j_cfgs.RECSYS_SHAPES[shape])
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    for a in (1.1, 1.2, 2.0):
        np.testing.assert_array_equal(
            t_pipe.zipf_ids(np.random.default_rng(7), (64, 5), 1000, a=a),
            j_pipe.zipf_ids(np.random.default_rng(7), (64, 5), 1000, a=a))


def test_init_shapes_and_seeding():
    jp = j_recsys.init(jax.random.PRNGKey(0), J_CFG, hot_rows=100)
    tp = t_recsys.init(torch.Generator().manual_seed(0), T_CFG, hot_rows=100, device="cpu")
    again = t_recsys.init(torch.Generator().manual_seed(0), T_CFG, hot_rows=100, device="cpu")
    for k in ("s_mat", "items_hot", "items_cold"):
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
        assert torch.equal(tp[k], again[k])
    assert [tuple(layer["w"].shape) for layer in tp["mlp"]] == [
        layer["w"].shape for layer in jp["mlp"]]
    dense = t_recsys.init(torch.Generator().manual_seed(0), T_CFG, device="cpu")
    assert tuple(dense["items"].shape) == (T_CFG.n_items, T_CFG.embed_dim)
    # popularity-ordered tables of N(0, 0.05) rows
    assert abs(float(dense["items"].std()) - 0.05) < 0.005


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(j_layers.dense({"w": jnp.asarray(w)}, jnp.asarray(x),
                                     getattr(jnp, dtype)), dtype=np.float32)
    got = t_layers.dense({"w": torch.as_tensor(w)}, torch.as_tensor(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_user_interests_from_emb_and_score_candidates():
    jp, tp = params_pair()
    rng = np.random.default_rng(2)
    b, h, d = 32, J_CFG.hist_len, J_CFG.embed_dim
    e = rng.standard_normal((b, h, d)).astype(np.float32) * 0.05
    hist = rng.integers(0, J_CFG.n_items, (b, h)).astype(np.int32)
    mask = rng.random((b, h)) < 0.9
    mask[0] = False                          # an empty history
    want = j_recsys.user_interests_from_emb(jp, J_CFG, jnp.asarray(e), jnp.asarray(hist),
                                            jnp.asarray(mask))
    got = t_recsys.user_interests_from_emb(tp, T_CFG, torch.as_tensor(e), torch.as_tensor(hist),
                                           torch.as_tensor(mask))
    assert tuple(got.shape) == (b, J_CFG.n_interests, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    cand = rng.standard_normal((b, 20, d)).astype(np.float32)
    np.testing.assert_allclose(
        t_recsys.score_candidates(got, torch.as_tensor(cand)).numpy(),
        np.asarray(j_recsys.score_candidates(want, jnp.asarray(cand))), **TOL)


@pytest.mark.parametrize("t_impl,j_impl", [("plain", "jnp"), ("hot", "pallas_hot")])
def test_serve_scores(t_impl, j_impl):
    jp, tp = params_pair()
    batch = t_pipe.recsys_batch(np.random.default_rng(4), T_CFG, t_cfgs.RECSYS_SHAPES["serve_p99"])
    want = np.asarray(j_recsys.serve_scores(jp, J_CFG, to_jax(batch), impl=j_impl))
    got = t_recsys.serve_scores(tp, T_CFG, batch, impl=t_impl)
    assert tuple(got.shape) == (512, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the hot route reads the same rows: identical to the plain route
    assert torch.equal(got, t_recsys.serve_scores(tp, T_CFG, batch, impl="plain"))


def test_embedding_lookup_rejects_unknown_impl():
    _, tp = params_pair()
    with pytest.raises(ValueError):
        t_recsys.embedding_lookup(tp["items"], torch.zeros((2, 3), dtype=torch.int32), "jnp")


def test_table_lookup_split_overflow_gives_zero_rows():
    """Cold references past cap get a zero row (the reference's code), not
    row 0 of the cold shard."""
    jp, tp = params_pair(hot_rows=100)
    rng = np.random.default_rng(5)
    ids = np.where(rng.random(600) < 0.95, rng.integers(100, 1000, 600),
                   rng.integers(0, 100, 600)).astype(np.int32)
    want = np.asarray(j_recsys.table_lookup(jp, jnp.asarray(ids)))
    got = t_recsys.table_lookup(tp, torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    n_cold, cap = int((ids >= 100).sum()), 256
    zero = ~got.any(axis=1)
    assert zero.sum() == n_cold - cap
    assert (ids[zero] >= 100).all()
    assert not np.array_equal(got[zero][0], tp["items_cold"][0].numpy())


def test_retrieval_scores_hot_split_overflow():
    jp, tp = params_pair(hot_rows=100)
    shape = t_cfgs.RecsysShape("retrieval_small", "retrieval", 1, n_candidates=4000)
    batch = t_pipe.recsys_batch(np.random.default_rng(6), T_CFG, shape)
    assert (batch["candidates"] >= 100).sum() > 2048    # past cap = 2048: zero rows
    want = np.asarray(j_recsys.retrieval_scores(jp, J_CFG, to_jax(batch)))
    got = t_recsys.retrieval_scores(tp, T_CFG, batch)
    assert tuple(got.shape) == (1, 4000)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mind_params_from_numpy_checks_tables():
    jp, _ = params_pair()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["items_hot"] = tree["items"][:10]
    with pytest.raises(ValueError):
        convert.mind_params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# training: label-aware attention, the sampled-softmax loss and its
# gradients against jax.value_and_grad, and one composed AdamW step
# ---------------------------------------------------------------------------


def train_batch(seed=7, b=64, uniform=False):
    """A train batch; ``uniform`` draws the history uniformly (90% of it
    past a 100-row hot split), so the split table's cold references
    overflow their cap (512 history ids: cap 256)."""
    rng = np.random.default_rng(seed)
    batch = t_pipe.recsys_batch(rng, T_CFG, t_cfgs.RecsysShape("t", "train", b))
    if uniform:
        batch["hist"] = rng.integers(0, T_CFG.n_items, batch["hist"].shape).astype(np.int32)
    return batch


def assert_same_tree(got, want, tol=TOL):
    t_leaves, j_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(t_leaves) == len(j_leaves)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        assert tuple(t.shape) == np.shape(j), i
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=f"leaf {i}", **tol)


def test_label_aware_attention_matches_jax():
    rng = np.random.default_rng(8)
    interests = rng.standard_normal((16, 4, 16)).astype(np.float32)
    target = rng.standard_normal((16, 16)).astype(np.float32)
    want = j_recsys.label_aware_attention(jnp.asarray(interests), jnp.asarray(target))
    got = t_recsys.label_aware_attention(torch.as_tensor(interests), torch.as_tensor(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for p in (0.5, 4.0):
        np.testing.assert_allclose(
            t_recsys.label_aware_attention(torch.as_tensor(interests), torch.as_tensor(target),
                                           p).numpy(),
            np.asarray(j_recsys.label_aware_attention(jnp.asarray(interests),
                                                      jnp.asarray(target), p)), **TOL)


@pytest.mark.parametrize("hot_rows,uniform", [(0, False), (100, False), (100, True)],
                         ids=["dense", "split", "split-cold-overflow"])
def test_loss_and_every_gradient_match_jax(hot_rows, uniform):
    jp, tp = params_pair(hot_rows=hot_rows)
    batch = train_batch(uniform=uniform)
    if uniform:
        assert (batch["hist"] >= hot_rows).sum() > 256
    want_loss, want_grads = jax.value_and_grad(j_recsys.loss_fn)(jp, J_CFG, to_jax(batch))
    loss, grads = value_and_grad(t_recsys.loss_fn, tp, T_CFG, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert sorted(grads) == sorted(want_grads)
    assert_same_tree(grads, want_grads)
    table = "items" if hot_rows == 0 else "items_cold"
    assert float(grads[table].abs().sum()) > 0       # the table's gradient is dense
    assert tuple(grads[table].shape) == tuple(tp[table].shape)
    if uniform:
        # overflowing cold references read a zero row, so nothing reaches the cold
        # rows of the history ids past the cap but not in targets or negatives
        flat = batch["hist"].reshape(-1)
        cold = np.nonzero(flat >= hot_rows)[0]
        others = np.concatenate([batch["target"], batch["negatives"], flat[cold[:256]]])
        dropped = np.setdiff1d(flat[cold[256:]], others) - hot_rows
        assert dropped.size > 0 and not grads["items_cold"][dropped].any()


def test_train_step_matches_the_jax_composition():
    """One AdamW (lr 1e-3) step as the JAX package's recsys train cell
    composes it (launch/steps.py: value_and_grad of loss_fn, then
    opt_update), from a mid-training state."""
    jp, tp = params_pair()
    j_init, j_update = j_opt.make(j_opt.OptConfig(name="adamw", lr=1e-3))
    js = j_init(jp)
    for seed in (1, 2):  # two earlier steps of the JAX package
        _, g = jax.value_and_grad(j_recsys.loss_fn)(jp, J_CFG, to_jax(train_batch(seed)))
        jp, js = j_update(g, js, jp)
    tp = convert.mind_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    opt_init, step = t_steps.recsys_train_step(T_CFG, device="cpu")
    assert_same_tree(opt_init(tp), j_init(jp))
    batch = train_batch(3)
    want_loss, g = jax.value_and_grad(j_recsys.loss_fn)(jp, J_CFG, to_jax(batch))
    jp, js = j_update(g, js, jp)
    tp, ts, metrics = step(tp, ts, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), **TOL)
    assert_same_tree(tp, jp)
    assert_same_tree(ts, js)
    assert int(ts["step"]) == 3


def test_hot_route_refuses_autograd_and_plain_trains():
    """K1's launch has no backward: the hot route raises while autograd
    would record a table that requires grad; under no_grad it serves, and
    the plain route trains."""
    _, tp = params_pair()
    batch = train_batch()
    live = dict(tp, items=tp["items"].detach().requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        t_recsys.loss_fn(live, T_CFG, batch, impl="hot")
    with pytest.raises(RuntimeError, match="no backward"):
        t_recsys.user_interests(live, T_CFG, batch["hist"], batch["hist_mask"], impl="hot")
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(t_recsys.loss_fn, tp, T_CFG, batch, "hot")
    with torch.no_grad():
        hot = t_recsys.loss_fn(live, T_CFG, batch, impl="hot")
    np.testing.assert_allclose(float(hot), float(t_recsys.loss_fn(tp, T_CFG, batch)), **TOL)
    opt_init, step = t_steps.recsys_train_step(T_CFG, device="cpu")
    state, losses = opt_init(tp), []
    for _ in range(5):
        tp, state, metrics = step(tp, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def test_mind_interests_and_loss():
    """tests/test_nn.py's MIND check on the port."""
    cfg = T_CFG
    params = t_recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    hist = rng.integers(0, cfg.n_items, (16, cfg.hist_len)).astype(np.int32)
    mask = np.ones_like(hist, bool)
    interests = t_recsys.user_interests(params, cfg, hist, mask)
    assert tuple(interests.shape) == (16, cfg.n_interests, cfg.embed_dim)
    batch = {"hist": hist, "hist_mask": mask,
             "target": rng.integers(0, cfg.n_items, 16).astype(np.int32),
             "negatives": rng.integers(0, cfg.n_items, 32).astype(np.int32)}
    loss, grads = value_and_grad(t_recsys.loss_fn, params, cfg, batch)
    assert np.isfinite(float(loss))
    assert sum(float(g.abs().sum()) for g in tree_leaves(grads)) > 0.0
