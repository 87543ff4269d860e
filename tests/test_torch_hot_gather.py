"""repro_torch.kernels.hot_gather vs the JAX package's Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them). On the CPU the port's
wrappers compute the plain versions; tests/test_torch_cuda.py holds the
Hopper kernels against those on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generate as j_generate
from repro.kernels.hot_gather import hot_gather as j_kernels
from repro.kernels.hot_gather import ops as j_ops
from repro_torch.kernels.hot_gather import hot_gather as t_kernels
from repro_torch.kernels.hot_gather import ops as t_ops

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def as_np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else \
        x.float().numpy()


def make_inputs(n, d, e, hot, seed=0):
    rng = np.random.default_rng(seed)
    prop = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    idx = np.where(rng.random(e) < 0.85, idx % max(hot, 1), idx).astype(np.int32)
    return prop, idx


def both(prop, idx, dtype):
    jd, td = DTYPES[dtype]
    return (jnp.asarray(prop, dtype=jd), jnp.asarray(idx),
            torch.as_tensor(prop).to(td), torch.as_tensor(idx))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "n,d,e,hot",
    [
        (1000, 8, 4096, 256),
        (5000, 64, 8192, 1024),
        (300, 130, 2048, 300),    # d not lane-aligned; hot == n (all hot)
        (4096, 16, 2048, 64),     # tiny hot region
        (600, 1, 1001, 128),      # one column (PageRank's layout), E not a multiple of 4
        (600, 3, 1001, 128),      # rows of no 16-byte multiple
    ],
)
def test_hot_gather_sweep(n, d, e, hot, dtype):
    prop, idx = make_inputs(n, d, e, hot)
    jp, ji, tp, ti = both(prop, idx, dtype)
    want = j_ops.hot_gather(jp, ji, hot_size=hot)
    got = t_ops.hot_gather(tp, ti, hot_size=hot)
    assert got.dtype == tp.dtype and got.shape == (e, d)
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize(
    "n,d,e,hot,cap,lo",
    [(2048, 32, 4096, 1024, None, 1024),   # all cold (paper Fig. 9 adversarial)
     (1024, 16, 4096, 512, 512, 0),        # capacity >= cold count
     (1024, 16, 4096, 512, 100, 0),        # capacity overflow -> zero rows
     (1024, 16, 4096, 512, 0, 0)],         # no cold capacity at all
)
def test_hot_gather_cold_fixup(n, d, e, hot, cap, lo):
    rng = np.random.default_rng(1)
    prop = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(lo, n, e).astype(np.int32)
    jp, ji, tp, ti = both(prop, idx, "f32")
    want = j_ops.hot_gather(jp, ji, hot_size=hot, cold_capacity=cap)
    np.testing.assert_array_equal(as_np(t_ops.hot_gather(tp, ti, hot_size=hot,
                                                         cold_capacity=cap)), as_np(want))


@pytest.mark.parametrize("cap", [None, 0, 1, 3, 9])
def test_hot_gather_semantics(cap):
    """-1 gives zeros (jnp.take would wrap), >= N gives NaN, cold past the
    capacity gives zeros; a (N,) property gives (E,)."""
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    idx = np.array([-1, 0, 1, 2, 5, 6, 3, 7, -3], dtype=np.int32)
    want = as_np(j_ops.hot_gather(jnp.asarray(table), jnp.asarray(idx), hot_size=2,
                                  cold_capacity=cap))
    got = t_ops.hot_gather(torch.as_tensor(table), torch.as_tensor(idx), hot_size=2,
                           cold_capacity=cap)
    np.testing.assert_array_equal(as_np(got), want)  # NaNs compare equal here
    assert (want[0] == 0).all() and (want[-1] == 0).all()
    assert np.isnan(want[5]).all() == (cap is None or cap >= 3)  # idx 6 is the 3rd cold
    got1 = t_ops.hot_gather(torch.as_tensor(table[:, 1].copy()), torch.as_tensor(idx),
                            hot_size=2, cold_capacity=cap)
    assert got1.shape == (idx.shape[0],)
    np.testing.assert_array_equal(as_np(got1), want[:, 1])


STREAMS = ("mixed", "all_hot", "all_cold", "past_n", "hot_size_0")
CAPS = (None, 0, 1, "middle", "E")


def make_stream(kind, n=600, e=1001, hot=128, seed=5):
    """(idx, hot_size) of one kind: mixed = hot, cold, negative and >= N
    indices (70% hot); all_hot; all_cold; past_n = every index >= N;
    hot_size_0 = the mixed stream with an empty hot region."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, n + 20, e)
    idx = np.where((idx >= 0) & (rng.random(e) < 0.7), idx % hot, idx)
    idx = {"all_hot": rng.integers(0, hot, e), "all_cold": rng.integers(hot, n, e),
           "past_n": rng.integers(n, n + 50, e)}.get(kind, idx)
    return idx.astype(np.int32), 0 if kind == "hot_size_0" else hot


def capacity(cap, idx, hot):
    cold = int((idx >= hot).sum())
    return {"middle": cold // 2, "E": idx.shape[0]}.get(cap, cap)


def jax_hot_gather(prop, idx, hot, cap, jd):
    """The JAX package's ops.hot_gather. Its Pallas hot block cannot be
    empty, so hot = 0 goes through an equal call: one row in front of the
    table that no index names, hot_size 1, and every index >= 0 moved up by
    one (the same cold indices in the same order, >= N still past the end)."""
    if hot == 0:
        prop = np.concatenate([np.zeros_like(prop[:1]), prop])
        idx, hot = np.where(idx >= 0, idx + 1, idx).astype(np.int32), 1
    return as_np(j_ops.hot_gather(jnp.asarray(prop, dtype=jd), jnp.asarray(idx), hot_size=hot,
                                  cold_capacity=cap))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("stream", STREAMS)
def test_two_tier_streams_match_jax(stream, cap):
    """One K1 launch over both tiers (its plain version on the CPU), alone
    and as ops.hot_gather, against the JAX package's kernel + cold fixup,
    bit for bit with NaN in the same places."""
    idx, hot = make_stream(stream)
    cap = capacity(cap, idx, hot)
    prop = np.random.default_rng(6).standard_normal((600, 8)).astype(np.float32)
    want = jax_hot_gather(prop, idx, hot, cap, jnp.float32)
    tp, ti = torch.as_tensor(prop), torch.as_tensor(idx)
    np.testing.assert_array_equal(as_np(t_ops.hot_gather(tp, ti, hot_size=hot,
                                                         cold_capacity=cap)), want)
    c = idx.shape[0] if cap is None else cap
    rank = torch.cumsum(ti >= hot, 0, dtype=torch.int32)
    got = t_kernels.hot_gather_two_tier(tp, ti, hot, rank, c)
    np.testing.assert_array_equal(as_np(got), want)
    if c >= idx.shape[0]:  # no capacity bound: the one launch needs no ranks
        np.testing.assert_array_equal(as_np(t_kernels.hot_gather_two_tier(tp, ti, hot)), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [1, 3, 8, 64])
def test_two_tier_layouts_match_jax(d, dtype):
    """The two-tier route at each of K1's row layouts and both dtypes, for
    every capacity; d = 1 also as a (N,) property, which gives (E,)."""
    idx, hot = make_stream("mixed", seed=7)
    prop = np.random.default_rng(8).standard_normal((600, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    tp, ti = torch.as_tensor(prop).to(td), torch.as_tensor(idx)
    for cap in CAPS:
        cap = capacity(cap, idx, hot)
        want = jax_hot_gather(prop, idx, hot, cap, jd)
        got = t_ops.hot_gather(tp, ti, hot_size=hot, cold_capacity=cap)
        assert got.dtype == td and got.shape == (idx.shape[0], d)
        np.testing.assert_array_equal(as_np(got), want)
        if d == 1:
            flat = t_ops.hot_gather(tp[:, 0].contiguous(), ti, hot_size=hot, cold_capacity=cap)
            assert flat.shape == (idx.shape[0],)
            np.testing.assert_array_equal(as_np(flat), want[:, 0])


def test_two_tier_checks_inputs():
    table = torch.zeros((8, 4))
    idx = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="hot_size"):
        t_kernels.hot_gather_two_tier(table, idx, 9)
    with pytest.raises(ValueError, match="cold_rank"):
        t_kernels.hot_gather_two_tier(table, idx, 4, idx[:8].contiguous(), 1)
    with pytest.raises(ValueError, match="int32"):
        t_kernels.hot_gather_two_tier(table, idx, 4, idx.long(), 1)
    with pytest.raises(ValueError, match="cold_capacity"):
        t_kernels.hot_gather_two_tier(table, idx, 4, idx, -1)
    with pytest.raises(TypeError):
        t_kernels.hot_gather_two_tier(table.double(), idx, 4)


def test_hot_gather_default_hot_size_and_1d_route():
    rng = np.random.default_rng(2)
    prop = rng.standard_normal(5000).astype(np.float32)
    idx = rng.integers(0, 5000, 3000).astype(np.int32)
    want = np.asarray(j_ops.hot_gather(jnp.asarray(prop[:, None]), jnp.asarray(idx)))[:, 0]
    got = t_ops.hot_gather(torch.as_tensor(prop), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), prop[idx])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k1_plain_matches_pallas_hot_part(dtype):
    prop, idx = make_inputs(700, 24, 4096, 200, seed=3)
    idx[::97] = -1
    idx[::89] = 900
    jp, ji, tp, ti = both(prop[:200], idx, dtype)
    want = j_kernels.hot_gather_hot_part(jp, ji, tile_e=2048)
    got = t_kernels.hot_gather_hot_part(tp, ti)
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("kind,args", [("uniform", (9, 6)), ("rmat", (9, 8)),
                                       ("uniform", (10, 3))])
def test_build_aligned_edges_identical(kind, args):
    g = getattr(j_generate, kind)(*args, seed=0)
    for spt, tile_e in ((64, 512), (256, 2048)):
        j = j_ops.build_aligned_edges(g.indptr, g.indices, spt, tile_e)
        t = t_ops.build_aligned_edges(g.indptr, g.indices, spt, tile_e)
        assert j[2] == t[2]
        for a, b in zip(j[:2], t[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,hot_rows", [("f32", None), ("bf16", None), ("f32", 200)])
def test_k2_plain_matches_pallas(dtype, hot_rows):
    g = j_generate.uniform(9, 6, seed=0)
    idx_t, seg_t, n_pad = j_ops.build_aligned_edges(g.indptr, g.indices, 64, 512)
    assert idx_t.shape[0] // 512 * 64 == n_pad  # a layout the reference accepts
    prop = np.random.default_rng(4).standard_normal((g.num_nodes, 32)).astype(np.float32)
    hot = prop[:hot_rows] if hot_rows else prop
    jd, td = DTYPES[dtype]
    want = j_ops.hot_gather_segsum_aligned(jnp.asarray(hot, dtype=jd), jnp.asarray(idx_t),
                                           jnp.asarray(seg_t), n_pad, 64, tile_e=512)
    got = t_ops.hot_gather_segsum_aligned(torch.as_tensor(hot).to(td), torch.as_tensor(idx_t),
                                          torch.as_tensor(seg_t), n_pad, 64, tile_e=512)
    assert got.dtype == torch.float32 and got.shape == (n_pad, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_k2_plain_drops_edges_outside_the_tile_block():
    hot = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    seg = torch.tensor([0, 1, 2, 1], dtype=torch.int32)  # tile 0 owns segs 0..1
    want = j_kernels.hot_gather_segment_sum(jnp.asarray(hot.numpy()), jnp.asarray(idx.numpy()),
                                            jnp.asarray(seg.numpy()), 4, tile_e=2,
                                            seg_per_tile=2)
    got = t_kernels.hot_gather_segment_sum(hot, idx, seg, 4, tile_e=2, seg_per_tile=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k2_rejects_spilled_layouts():
    g = j_generate.rmat(9, 8, seed=0)
    idx_t, seg_t, n_pad = t_ops.build_aligned_edges(g.indptr, g.indices, 64, 256)
    assert idx_t.shape[0] // 256 * 64 != n_pad  # hubs spill into extra tiles
    hot = torch.zeros((g.num_nodes, 4))
    with pytest.raises(ValueError, match="one tile per segment block"):
        t_ops.hot_gather_segsum_aligned(hot, torch.as_tensor(idx_t), torch.as_tensor(seg_t),
                                        n_pad, 64, tile_e=256)
    with pytest.raises(ValueError, match="divisible"):
        t_kernels.hot_gather_segment_sum(hot, torch.as_tensor(idx_t[:-1]),
                                         torch.as_tensor(seg_t[:-1]), n_pad, 256, 64)


def test_wrappers_check_inputs():
    hot = torch.zeros((8, 4))
    idx = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_kernels.hot_gather_hot_part(hot.double(), idx)
    with pytest.raises(ValueError):
        t_kernels.hot_gather_hot_part(hot, idx.long())
    with pytest.raises(ValueError):
        t_kernels.hot_gather_hot_part(hot.t(), idx)
    with pytest.raises(ValueError):
        t_kernels.hot_gather_hot_part(hot[:, 0], idx)
    with pytest.raises(ValueError):
        t_ops.hot_gather(torch.zeros((2, 2, 2)), idx)
    with pytest.raises(ValueError):
        t_ops.hot_gather(hot, idx, cold_capacity=-1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_shuffled_tiles_match_jax(dtype):
    """Any order of a tile's edges gives the sum, as the TPU's one-hot
    product does: each tile's edges (padding included) shuffled within it."""
    g = j_generate.uniform(9, 6, seed=1)
    idx_t, seg_t, n_pad = j_ops.build_aligned_edges(g.indptr, g.indices, 64, 512)
    rng = np.random.default_rng(9)
    perm = np.concatenate([t * 512 + rng.permutation(512) for t in range(idx_t.shape[0] // 512)])
    idx_s, seg_s = idx_t[perm], seg_t[perm]
    assert not np.array_equal(seg_s, seg_t)
    prop = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)
    hot = prop[: g.num_nodes // 2]
    jd, td = DTYPES[dtype]
    want = j_ops.hot_gather_segsum_aligned(jnp.asarray(hot, dtype=jd), jnp.asarray(idx_s),
                                           jnp.asarray(seg_s), n_pad, 64, tile_e=512)
    t_hot = torch.as_tensor(hot).to(td)
    got = t_ops.hot_gather_segsum_aligned(t_hot, torch.as_tensor(idx_s), torch.as_tensor(seg_s),
                                          n_pad, 64, tile_e=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    in_order = t_ops.hot_gather_segsum_aligned(t_hot, torch.as_tensor(idx_t),
                                               torch.as_tensor(seg_t), n_pad, 64, tile_e=512)
    torch.testing.assert_close(got, in_order, rtol=1e-5, atol=1e-5)
