"""repro_torch.kernels.embedding_bag vs the JAX package's (its Pallas kernel
run in interpret mode, as tests/test_kernels.py runs it). On the CPU the
port's K3 wrapper computes its plain version; tests/test_torch_cuda.py
holds the Hopper kernel against that on a card. Tolerance 1e-4, the
reference tests' own for the bag (sums taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as j_plan
from repro.kernels.embedding_bag import embedding_bag as j_kernel
from repro.kernels.embedding_bag import ops as j_ops
from repro.kernels.embedding_bag import ref as j_ref
from repro_torch.core import plan as t_plan
from repro_torch.kernels.embedding_bag import embedding_bag as t_kernel
from repro_torch.kernels.embedding_bag import ops as t_ops
from repro_torch.kernels.embedding_bag import ref as t_ref

SWEEP = [(2000, 16, 512, 8, 256), (5000, 64, 300, 12, 512), (1000, 100, 64, 4, 1000)]
TOL = dict(rtol=1e-4, atol=1e-4)


def make_bags(v, d, b, h, hot, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, h)).astype(np.int32)
    ids = np.where(rng.random((b, h)) < 0.8, ids % hot, ids).astype(np.int32)
    mask = rng.random((b, h)) < 0.9
    return table, ids, mask


def both_bags(table, ids, mask, hot_size, cold_capacity=None):
    want = j_ops.hot_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask),
                         hot_size=hot_size, cold_capacity=cold_capacity)
    got = t_ops.hot_bag(torch.as_tensor(table), torch.as_tensor(ids), torch.as_tensor(mask),
                        hot_size=hot_size, cold_capacity=cold_capacity)
    assert got.dtype == torch.float32 and got.shape == (ids.shape[0], table.shape[1])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("v,d,b,h,hot", SWEEP)
def test_hot_bag_sweep(v, d, b, h, hot):
    table, ids, mask = make_bags(v, d, b, h, hot)
    got, want = both_bags(table, ids, mask, hot)
    np.testing.assert_allclose(got, want, **TOL)
    oracle = t_ref.bag_ref(torch.as_tensor(table), torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_allclose(got, oracle.numpy(), **TOL)


@pytest.mark.parametrize("v,d,b,h,hot", SWEEP)
def test_hot_part_matches_pallas_kernel(v, d, b, h, hot):
    """K3's plain version against the Pallas kernel on the reference's
    own padded inputs (d to 128 lanes, B to the 256-bag tile)."""
    table, ids, mask = make_bags(v, d, b, h, hot, seed=1)
    d_pad, b_pad = -(-d // 128) * 128, -(-b // 256) * 256
    want = j_kernel.hot_bag_hot_part(
        jnp.asarray(np.pad(table[:hot], ((0, 0), (0, d_pad - d)))),
        jnp.asarray(np.pad(ids, ((0, b_pad - b), (0, 0)), constant_values=-1)),
        jnp.asarray(np.pad(mask, ((0, b_pad - b), (0, 0)))))[:b, :d]
    got = t_kernel.hot_bag_hot_part(torch.as_tensor(table[:hot]), torch.as_tensor(ids),
                                    torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hot_part_sums_in_position_order():
    """The plain version adds each bag's positions one after the other in
    float32, the order the CUDA kernel uses: the bit-for-bit contract."""
    table, ids, mask = make_bags(500, 8, 64, 50, 400, seed=2)
    got = t_kernel.hot_bag_hot_part(torch.as_tensor(table), torch.as_tensor(ids),
                                    torch.as_tensor(mask)).numpy()
    want = np.zeros((64, 8), np.float32)
    for pos in range(50):
        hit = mask[:, pos] & (ids[:, pos] < 500)
        want = want + np.where(hit[:, None], table[np.minimum(ids[:, pos], 499)], 0.0)
    np.testing.assert_array_equal(got, want)


def test_hot_part_bf16_adds_exact_upcasts():
    table, ids, mask = make_bags(300, 24, 32, 6, 100, seed=3)
    hot = torch.as_tensor(table[:100]).to(torch.bfloat16)
    got = t_kernel.hot_bag_hot_part(hot, torch.as_tensor(ids), torch.as_tensor(mask))
    want = t_kernel.hot_bag_hot_part(hot.float(), torch.as_tensor(ids), torch.as_tensor(mask))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_hot_bag_all_masked():
    table, ids, _ = make_bags(256, 8, 32, 4, 64, seed=3)
    mask = np.zeros((32, 4), bool)
    got, want = both_bags(table, ids, mask, 64)
    assert float(np.abs(want).max()) == 0.0
    assert float(np.abs(got).max()) == 0.0


@pytest.mark.parametrize("cap", [0, 1, 7, 40])
def test_hot_bag_cold_overflow(cap):
    """Cold pairs past ``cold_capacity`` (flat order) are dropped."""
    table, ids, mask = make_bags(1000, 16, 64, 8, 128, seed=4)
    got, want = both_bags(table, ids, mask, 128, cold_capacity=cap)
    np.testing.assert_allclose(got, want, **TOL)
    full, _ = both_bags(table, ids, mask, 128)
    n_cold = int((mask & (ids >= 128)).sum())
    assert n_cold > 40 and not np.allclose(got, full)


@pytest.mark.parametrize("cap", [None, 3])
def test_hot_bag_negative_and_out_of_range_ids(cap):
    """Negative ids add nothing; a masked-in id >= V adds NaN (jnp.take's
    fill), unless the cold capacity drops it first."""
    v = 40
    table, ids, mask = make_bags(v, 4, 8, 6, 16, seed=5)
    ids[0, 1], ids[1, 2], ids[2, 0] = -1, -30, v
    ids[3, 3], ids[4, 5], ids[5, 0] = v + 7, 2**30, v
    mask[:6] = True
    mask[5, 0] = False                      # masked out: adds nothing
    got, want = both_bags(table, ids, mask, 16, cold_capacity=cap)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **TOL)
    if cap is None:
        assert np.isnan(got[[2, 3, 4]]).all() and not np.isnan(got[[0, 1, 5]]).any()


def test_lookup_ref_matches_jnp_take():
    table = np.arange(24, dtype=np.float32).reshape(8, 3)
    ids = np.array([[-1, -8, -9, 8], [100, 0, 7, 3]], np.int32)
    want = np.asarray(j_ref.lookup_ref(jnp.asarray(table), jnp.asarray(ids)))
    got = t_ref.lookup_ref(torch.as_tensor(table), torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("with_plan", [False, True])
def test_hot_lookup_matches_lookup_ref(with_plan):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((4096, 64)).astype(np.float32)
    ids = rng.integers(0, 4096, 2048).astype(np.int32)
    ids = np.where(rng.random(2048) < 0.7, ids % 300, ids).astype(np.int32)
    plans = (j_plan.make_plan(4096, 256, budget_bytes=512 * 256),
             t_plan.make_plan(4096, 256, budget_bytes=512 * 256)) if with_plan else (None, None)
    want = np.asarray(j_ops.hot_lookup(jnp.asarray(table), jnp.asarray(ids), plan=plans[0]))
    got = t_ops.hot_lookup(torch.as_tensor(table), torch.as_tensor(ids), plan=plans[1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_hot_bag_hot_part_rejects_bad_inputs():
    hot = torch.zeros((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        t_kernel.hot_bag_hot_part(hot, ids.long(), mask)
    with pytest.raises(ValueError):
        t_kernel.hot_bag_hot_part(hot, ids, mask[:, :2])
    with pytest.raises(TypeError):
        t_kernel.hot_bag_hot_part(hot.double(), ids, mask)
    with pytest.raises(ValueError):
        t_kernel.hot_bag_hot_part(hot.t(), ids, mask)


def with_edge_ids(ids, mask, v):
    """Mix in negative ids and masked-in ids >= V."""
    ids, mask = ids.copy(), mask.copy()
    ids[::13, 1] = v + 3
    ids[::17, 2] = -1
    ids[5::29, 0] = 2**30
    mask[::13, 1] = mask[5::29, 0] = True
    return ids, mask


@pytest.mark.parametrize("cap", [None, 0, 1, 7, 40])
@pytest.mark.parametrize("v,d,b,h,hot", SWEEP)
def test_two_tier_matches_jax(v, d, b, h, hot, cap):
    """K3's two-tier plain version, and ops.hot_bag through it, against the
    JAX package's ops.hot_bag (its Pallas hot part plus the compacted cold
    fixup), with negative and >= V ids mixed in."""
    table, ids, mask = make_bags(v, d, b, h, hot, seed=7)
    ids, mask = with_edge_ids(ids, mask, v)
    got, want = both_bags(table, ids, mask, hot, cold_capacity=cap)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **TOL)
    t_table, t_ids, t_mask = (torch.as_tensor(a) for a in (table, ids, mask))
    cold = t_mask & (t_ids >= hot)
    rank = torch.cumsum(cold.view(-1), 0, dtype=torch.int32).view(b, h)
    plain = t_ref.hot_bag_two_tier_ref(t_table, t_ids, t_mask, hot,
                                       None if cap is None else rank, cap or 0)
    assert torch.equal(torch.isnan(plain), torch.from_numpy(np.isnan(got)))
    assert torch.equal(plain.nan_to_num(), torch.from_numpy(got).nan_to_num())


@pytest.mark.parametrize("cap", [None, 7])
def test_two_tier_bf16_matches_jax(cap):
    """A bf16 table of small integers: every partial sum is exact in bf16
    and in f32, so the JAX route (which sums its bf16 rows in bf16) and the
    port (f32) must agree exactly."""
    rng = np.random.default_rng(8)
    v, b, h, hot = 600, 40, 10, 128
    table = rng.integers(-4, 5, (v, 16)).astype(np.float32)
    ids = np.where(rng.random((b, h)) < 0.7, rng.integers(0, hot, (b, h)),
                   rng.integers(0, v, (b, h))).astype(np.int32)
    mask = rng.random((b, h)) < 0.9
    ids, mask = with_edge_ids(ids, mask, v)
    want = np.asarray(j_ops.hot_bag(jnp.asarray(table, dtype=jnp.bfloat16), jnp.asarray(ids),
                                    jnp.asarray(mask), hot_size=hot, cold_capacity=cap),
                      dtype=np.float32)
    got = t_ops.hot_bag(torch.as_tensor(table).to(torch.bfloat16), torch.as_tensor(ids),
                        torch.as_tensor(mask), hot_size=hot, cold_capacity=cap)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got.numpy()), np.nan_to_num(want))


def test_two_tier_sums_hot_then_cold_each_in_history_order():
    """Bag = hot_sum + cold_sum, each taken one position after the other in
    float32: neither one running sum over the bag nor another order."""
    big = np.float32(2.0**25)                       # f32 spacing 4 here
    table = np.array([[1.0], [big], [-big]], np.float32)  # rows 0-1 hot, row 2 cold
    ids = np.array([[0, 2, 0, 0, 1]], np.int32)
    mask = np.ones_like(ids, bool)
    got = t_ops.hot_bag(torch.as_tensor(table), torch.as_tensor(ids), torch.as_tensor(mask),
                        hot_size=2).numpy()[0, 0]

    def running(order):
        acc = np.float32(0)
        for i in order:
            acc = np.float32(acc + table[i, 0])
        return acc

    hot, cold = [i for i in ids[0] if i < 2], [i for i in ids[0] if i >= 2]
    assert got == running(hot) + running(cold) == np.float32(4.0)  # 1+1+1+big -> big+4
    assert running(ids[0]) == 0.0                   # one running sum: 1-big -> -big, ...
    assert running(hot[::-1]) + running(cold) == 0.0   # big+1+1+1 -> big


def test_hot_bag_two_tier_checks_inputs():
    table = torch.zeros((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.ones((2, 3), dtype=torch.bool)
    rank = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="cold_rank"):
        t_kernel.hot_bag_two_tier(table, ids, mask, 4, rank[:, :2].contiguous(), 1)
    with pytest.raises(ValueError, match="cold_rank"):
        t_kernel.hot_bag_two_tier(table, ids, mask, 4, rank.long(), 1)
    for hot_size in (-1, 9):
        with pytest.raises(ValueError, match="hot_size"):
            t_kernel.hot_bag_two_tier(table, ids, mask, hot_size)
    with pytest.raises(ValueError, match="cold_capacity"):
        t_kernel.hot_bag_two_tier(table, ids, mask, 4, rank, -1)
    with pytest.raises(ValueError, match="cold_capacity"):
        t_ops.hot_bag(table, ids, mask, 4, cold_capacity=-1)
    with pytest.raises(ValueError, match="mask"):
        t_kernel.hot_bag_two_tier(table, ids, mask[:, :2], 4)
    with pytest.raises(TypeError):
        t_kernel.hot_bag_two_tier(table.double(), ids, mask, 4)
