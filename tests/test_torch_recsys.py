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
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.nn import layers as t_layers
from repro_torch.nn import recsys as t_recsys

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
