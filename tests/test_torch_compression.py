"""repro_torch.train.compression (int8 gradient compression with error
feedback) against the JAX package's ``train.compression`` on the CPU:
``quantize_int8`` bit for bit on hypothesis seeds, ``ef_compress`` over the
reference's 50-step loop exactly, ``compressed_psum`` on a world-size-1
gloo group exactly against the JAX ``shard_map``, and on 4 gloo ranks
against a numpy evaluation of the same formula (the scales' sum to 1e-6
relative: gloo may add the ranks' scales in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as PSpec

import repro.dist  # noqa: F401  (jax.shard_map on this JAX)
import torch_dist_worker as workers
from repro.train import compression as j_comp
from repro_torch.train import compression as t_comp
from repro_torch.train.tree import tree_leaves


def bits_equal(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t.reshape(-1).view(np.uint8), j.reshape(-1).view(np.uint8))


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_quantize_matches_jax_bit_for_bit(seed):
    """q and the scale equal the JAX package's, including the reference's
    round-trip bound; ``torch.round`` and ``jnp.round`` both round half to
    even (the last entries sit exactly on halves of the scale)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(256) * 10).astype(np.float32)
    x[-3:] = np.float32(np.abs(x).max()) / 127 * np.float32([0.5, 1.5, 2.5])
    q, s = t_comp.quantize_int8(torch.from_numpy(x))
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    bits_equal(q, jq)
    bits_equal(s, js)
    err = (t_comp.dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6
    bits_equal(t_comp.dequantize_int8(q, s), j_comp.dequantize_int8(jq, js))


def test_error_feedback_matches_jax_over_50_steps():
    """tests/test_train_infra.py's loop through both packages: every
    payload, error and running sum equal, and the residual bounded by one
    quantization step, not O(T)."""
    rng = np.random.default_rng(0)
    true = [rng.standard_normal(64).astype(np.float32) for _ in range(50)]
    j_err, t_err = {"g": jnp.zeros((64,))}, t_comp.init_error({"g": torch.zeros(64)})
    j_sent, t_sent = jnp.zeros((64,)), torch.zeros(64)
    for g in true:
        j_payload, j_err = j_comp.ef_compress({"g": jnp.asarray(g)}, j_err)
        t_payload, t_err = t_comp.ef_compress({"g": torch.from_numpy(g)}, t_err)
        for t, j in zip(t_payload["g"], j_payload["g"]):
            bits_equal(t, j)
        bits_equal(t_err["g"], j_err["g"])
        j_sent = j_sent + j_comp.dequantize_int8(*j_payload["g"])
        t_sent = t_sent + t_comp.dequantize_int8(*t_payload["g"])
    bits_equal(t_sent, j_sent)
    assert float((t_sent - torch.from_numpy(np.sum(true, axis=0))).abs().max()) < 0.5


def grad_trees(seed):
    """A parameter-shaped tree (nested dict and list, a scalar leaf) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 4)) * 3).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32)},
                       {"b": np.full(5, 0.37, np.float32)}],
            "eps": np.float32(rng.standard_normal())}


def test_compressed_psum_on_one_rank_matches_shard_map(tmp_path):
    """The reference's shard_map test (its 0.37s are ``layers[1]``) in a
    fuller tree, two rounds with the error carried: the mean and the error
    bit for bit."""
    mesh = jax.make_mesh((1,), ("data",))
    psum = jax.shard_map(lambda g, e: j_comp.compressed_psum(g, e, "data"), mesh=mesh,
                         in_specs=(PSpec(), PSpec()), out_specs=(PSpec(), PSpec()))
    with workers.gloo_group(str(tmp_path)):
        grads = grad_trees(1)
        j_g = jax.tree_util.tree_map(jnp.asarray, grads)
        t_g = jax.tree_util.tree_map(torch.as_tensor, grads)
        j_e, t_e = j_comp.init_error(j_g), t_comp.init_error(t_g)
        for _ in range(2):
            j_mean, j_e = psum(j_g, j_e)
            t_mean, t_e = t_comp.compressed_psum(t_g, t_e)
            for t, j in zip(tree_leaves((t_mean, t_e)), jax.tree_util.tree_leaves((j_mean, j_e))):
                bits_equal(t, j)
        np.testing.assert_allclose(t_mean["layers"][1]["b"].numpy(), 0.37, atol=0.01)


def numpy_compressed_psum(grads_by_rank, errors_by_rank):
    """The reference's formula in numpy float32: per rank q and scale from
    (g + e), the sum of the int payloads times the mean scale over n."""
    n = len(grads_by_rank)
    means, new_errors = [], []
    for g, e in zip(grads_by_rank, errors_by_rank):
        target = (g + e).astype(np.float32)
        s = np.float32(np.abs(target).max()) / np.float32(127) + np.float32(1e-12)
        q = np.clip(np.rint(target / s), -127, 127).astype(np.int8)
        means.append((q.astype(np.int64), s))
        new_errors.append(target - q.astype(np.float32) * s)
    acc = sum(q for q, _ in means)
    ssum = np.float32(sum(s for _, s in means))
    return acc.astype(np.float32) * (ssum / np.float32(n)) / np.float32(n), new_errors


def test_compressed_psum_on_four_ranks_matches_the_formula(tmp_path):
    grads_by_rank = [grad_trees(10 + r) for r in range(4)]
    rounds = 3
    ranks = workers.spawn(workers.compressed_psums, 4, str(tmp_path), grads_by_rank, rounds)
    errors = [jax.tree_util.tree_map(np.zeros_like, g) for g in grads_by_rank]
    for i in range(rounds):
        leaves_g = [jax.tree_util.tree_leaves(g) for g in grads_by_rank]
        leaves_e = [jax.tree_util.tree_leaves(e) for e in errors]
        new_leaves_e = [[] for _ in range(4)]
        for li in range(len(leaves_g[0])):
            mean, new_e = numpy_compressed_psum([np.asarray(lg[li]) for lg in leaves_g],
                                                [np.asarray(le[li]) for le in leaves_e])
            for r in range(4):
                got_mean = tree_leaves(ranks[r][i][0])[li].numpy()
                np.testing.assert_allclose(got_mean, mean, rtol=1e-6, atol=0)
                np.testing.assert_array_equal(tree_leaves(ranks[r][i][1])[li].numpy(), new_e[r])
                new_leaves_e[r].append(new_e[r])
        for r in range(1, 4):  # every rank holds the same mean
            for a, b in zip(tree_leaves(ranks[r][i][0]), tree_leaves(ranks[0][i][0])):
                assert torch.equal(a, b)
        errors = [jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(errors[r]),
                                               new_leaves_e[r]) for r in range(4)]


def test_compressed_psum_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        t_comp.compressed_psum({"w": torch.ones(3)}, {"w": torch.zeros(3)})
