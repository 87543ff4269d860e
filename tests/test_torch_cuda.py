"""The port's CUDA kernels on the card, against their plain versions, and
the paths through them (PageRank, the graph apps, MIND) against the CPU.

These tests need an NVIDIA GPU and skip elsewhere. The JAX package is not
installed beside the card, so this file imports only the port and runs
without the repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import apps
from repro_torch.graph import generate
from repro_torch.kernels.hot_gather import hot_gather as kernels
from repro_torch.kernels.hot_gather import ops, ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_inputs(n, d, e, hot, seed=0):
    rng = np.random.default_rng(seed)
    prop = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    idx = np.where(rng.random(e) < 0.85, idx % max(hot, 1), idx).astype(np.int32)
    idx[::31] = -1
    return prop, idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d,e,hot", [(1000, 1, 5000, 256), (1000, 8, 4096, 256),
                                       (300, 130, 2048, 300), (4096, 16, 2048, 0)])
def test_k1_matches_plain(cuda, n, d, e, hot, dtype):
    prop, idx = make_inputs(n, d, e, hot)
    full = torch.as_tensor(prop).to(DTYPES[dtype])
    hot_t, idx_t = full[:hot].contiguous().to(cuda), torch.as_tensor(idx).to(cuda)
    before = kernels.hot_gather_hot_part.launches
    got = kernels.hot_gather_hot_part(hot_t, idx_t)
    torch.cuda.synchronize()
    assert kernels.hot_gather_hot_part.launches == before + 1
    assert torch.equal(got, ref.hot_gather_ref(hot_t, idx_t))
    on_card = ops.hot_gather(full.to(cuda), idx_t, hot_size=hot).cpu()
    on_cpu = ops.hot_gather(full, torch.as_tensor(idx), hot_size=hot)
    assert torch.equal(on_card, on_cpu)


@pytest.mark.cuda
def test_k1_semantics(cuda):
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-1, 0, 1, 2, 5, 6, 3, 7], dtype=torch.int32)
    for cap in (None, 1):
        a = ops.hot_gather(table.to(cuda), idx.to(cuda), hot_size=2, cold_capacity=cap).cpu()
        b = ops.hot_gather(table, idx, hot_size=2, cold_capacity=cap)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def same_bits(a, b):
    """Equal values with NaN in the same places."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(nan=0.0), b.nan_to_num(nan=0.0))


def kernels_launched(fn):
    """Names of the kernels ``fn`` launches, read with torch.profiler. The
    call sits between runs of spin kernels, which are left out: on the card
    the profiler loses a few kernels at the edge of a window."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad()
        fn()
        pad()
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in ev.name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [1, 3, 4, 8, 64, 130, 257])
@pytest.mark.parametrize("e,offset", [(5001, 0), (4099, 1), (0, 0)],
                         ids=["E not a multiple of 4", "idx not 16-byte aligned", "E=0"])
def test_k1_layouts_and_two_tier_match_plain(cuda, d, e, offset, dtype):
    """K1 at each row layout, in its hot-part and two-tier modes (with and
    without cold ranks), bit for bit against the plain versions."""
    n, hot = 1000, 256
    prop, idx = make_inputs(n, d, e + offset, hot)
    idx[::37] = n + 5                                   # >= N
    table = torch.as_tensor(prop).to(DTYPES[dtype]).to(cuda)
    idx_t = torch.as_tensor(idx).to(cuda)[offset:]      # idx[1:]: a view off 16-byte alignment
    assert idx_t.is_contiguous() and (idx_t.data_ptr() % 16 != 0) == (offset == 1)
    rank = torch.cumsum(idx_t >= hot, 0, dtype=torch.int32)
    before = kernels.hot_gather_hot_part.launches
    hot_t = table[:hot]
    got = kernels.hot_gather_hot_part(hot_t, idx_t)
    assert torch.equal(got, ref.hot_gather_ref(hot_t, idx_t))
    for r, cap in ((None, 0), (rank, 0), (rank, 100), (rank, e)):
        got = kernels.hot_gather_two_tier(table, idx_t, hot, r, cap)
        want = ref.hot_gather_two_tier_ref(table, idx_t, hot, r, cap)
        assert got.shape == (e, d) and got.dtype == table.dtype
        assert same_bits(got, want), (r is not None, cap)
    torch.cuda.synchronize()
    assert kernels.hot_gather_hot_part.launches == before + (5 if e else 0)


@pytest.mark.cuda
def test_hot_gather_makes_no_host_sync(cuda):
    """ops.hot_gather is one K1 launch and no host sync at the default
    capacity, and a scan plus that launch, still without a sync, below it."""
    prop, idx = make_inputs(5000, 8, 20000, 1024)
    idx[::53] = 5000
    table, idx_t = torch.as_tensor(prop).to(cuda), torch.as_tensor(idx).to(cuda)
    column = table[:, 0].contiguous()
    ops.hot_gather(table, idx_t, hot_size=1024)          # build and load the kernel
    torch.cuda.synchronize()
    before = kernels.hot_gather_hot_part.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        full = ops.hot_gather(table, idx_t, hot_size=1024)
        capped = ops.hot_gather(table, idx_t, hot_size=1024, cold_capacity=1000)
        flat = ops.hot_gather(column, idx_t, hot_size=1024)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.hot_gather_hot_part.launches == before + 3
    on_card = kernels_launched(lambda: ops.hot_gather(table, idx_t, hot_size=1024))
    assert len(on_card) == 1, on_card
    cpu_t, cpu_i = torch.as_tensor(prop), torch.as_tensor(idx)
    assert same_bits(full.cpu(), ops.hot_gather(cpu_t, cpu_i, hot_size=1024))
    assert same_bits(capped.cpu(), ops.hot_gather(cpu_t, cpu_i, hot_size=1024,
                                                  cold_capacity=1000))
    assert same_bits(flat.cpu(), ops.hot_gather(cpu_t[:, 0].contiguous(), cpu_i,
                                                hot_size=1024))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_k2_matches_plain(cuda, dtype, order):
    """K2 on the layout's sorted tiles and on tiles shuffled within
    themselves: within 1e-5 of the plain version, equal bits over two
    launches."""
    g = generate.uniform(10, 6, seed=0)
    idx_t, seg_t, n_pad = ops.build_aligned_edges(g.indptr, g.indices, 64, 512)
    if order == "shuffled":
        rng = np.random.default_rng(5)
        perm = np.concatenate([t * 512 + rng.permutation(512)
                               for t in range(idx_t.shape[0] // 512)])
        idx_t, seg_t = idx_t[perm], seg_t[perm]
    prop = np.random.default_rng(4).standard_normal((g.num_nodes, 24)).astype(np.float32)
    for d in (24, 8, 3):
        hot = torch.as_tensor(prop[: g.num_nodes // 2, :d]).to(DTYPES[dtype])
        hot = hot.contiguous().to(cuda)
        idx, seg = torch.as_tensor(idx_t).to(cuda), torch.as_tensor(seg_t).to(cuda)
        before = kernels.hot_gather_segment_sum.launches
        got = kernels.hot_gather_segment_sum(hot, idx, seg, n_pad, 512, 64)
        again = kernels.hot_gather_segment_sum(hot, idx, seg, n_pad, 512, 64)
        want = ref.gather_segment_sum_ref(hot, idx, seg, n_pad, 512, 64)
        torch.cuda.synchronize()
        assert kernels.hot_gather_segment_sum.launches == before + 2
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_pagerank_through_k1_matches_cpu(cuda):
    g = generate.rmat(12, 8, seed=3)
    before = kernels.hot_gather_hot_part.launches
    on_card = apps.pagerank(g.device(cuda)).cpu()
    assert kernels.hot_gather_hot_part.launches > before
    on_cpu = apps.pagerank(g.device("cpu"))
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-7)


# --- the graph suite: PageRank-Delta through K1, SSSP, BC, Radii ------------
def suite_graphs():
    """The DBG-ordered ``tw`` graph at scale 13, its weighted out-CSR
    (SSSP) and its out-CSR (BC), as examples/graph_suite_torch.py runs them."""
    from repro_torch.core.reorder import reorder_ranks
    from repro_torch.graph import datasets
    from repro_torch.graph.csr import apply_reorder, transpose

    g = datasets.load("tw", scale=13)
    g = apply_reorder(g, reorder_ranks(g, "dbg"))
    return g, transpose(generate.add_uniform_weights(g, seed=1)), transpose(g)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["prd", "sssp", "bc", "radii"])
def test_graph_apps_on_card_match_cpu(cuda, app):
    """Each new app on the card against the same function on the CPU:
    SSSP, BC's level and sigma, and Radii exact; PRD and BC's delta within
    the summation-order tolerances of the CPU parity tests."""
    g, g_sssp, g_bc = suite_graphs()
    run = {
        "prd": lambda dev: [apps.pagerank_delta(g.device(dev))],
        "sssp": lambda dev: [apps.sssp(g_sssp.device(dev), 0)],
        "bc": lambda dev: list(apps.bc_single_source(g_bc.device(dev), 0)),
        "radii": lambda dev: list(apps.radii_estimate(g.device(dev), torch.arange(8))),
    }[app]
    on_card = [x.cpu() for x in run(cuda)]
    on_cpu = run("cpu")
    for got, want in zip(on_card, on_cpu):
        assert got.dtype == want.dtype and got.shape == want.shape
    if app == "prd":
        torch.testing.assert_close(on_card[0], on_cpu[0], rtol=1e-4, atol=1e-7)
    elif app == "bc":
        assert torch.equal(on_card[2], on_cpu[2]) and torch.equal(on_card[1], on_cpu[1])
        torch.testing.assert_close(on_card[0], on_cpu[0], rtol=1e-5, atol=1e-6)
    else:
        assert all(torch.equal(a, b) for a, b in zip(on_card, on_cpu))


@pytest.mark.cuda
def test_pagerank_delta_launches_k1_once_per_iteration(cuda):
    g = suite_graphs()[0]
    dg = g.device(cuda)
    stats = {}
    before = kernels.hot_gather_hot_part.launches
    apps.pagerank_delta(dg, stats=stats)
    assert kernels.hot_gather_hot_part.launches - before == stats["iters"] >= 1
    before = kernels.hot_gather_hot_part.launches
    apps.pagerank_delta(dg, gather_impl="plain")
    assert kernels.hot_gather_hot_part.launches == before


@pytest.mark.cuda
def test_pagerank_delta_gather_makes_no_host_sync(cuda):
    """PRD's pull (gather through ops.hot_gather, then the segment sum) is
    one K1 launch and no host sync."""
    from repro_torch.apps import engine

    g = suite_graphs()[0]
    dg = g.device(cuda)
    contrib = torch.rand(g.num_nodes, generator=torch.Generator().manual_seed(0)).to(cuda)
    engine.edge_map_pull(dg, contrib)                     # build and load the kernel
    torch.cuda.synchronize()
    before = kernels.hot_gather_hot_part.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pulled = engine.edge_map_pull(dg, contrib, reduce_fn=engine.sum_reduce)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.hot_gather_hot_part.launches == before + 1
    want = engine.edge_map_pull(g.device("cpu"), contrib.cpu(), gather_impl="plain")
    torch.testing.assert_close(pulled.cpu(), want, rtol=1e-5, atol=1e-7)


# --- K3 (hot embedding bag) and the MIND serving path -----------------------
def make_bags(v, d, b, h, hot, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, h)).astype(np.int32)
    ids = np.where(rng.random((b, h)) < 0.8, ids % max(hot, 1), ids).astype(np.int32)
    ids[::7, 0] = -1
    mask = rng.random((b, h)) < 0.9
    return table, ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("v,d,b,h,hot", [(2000, 16, 512, 8, 256), (5000, 64, 300, 12, 512),
                                         (1000, 100, 64, 4, 1000), (600, 1, 70, 50, 300),
                                         (900, 200, 33, 37, 900), (300, 130, 40, 5, 0)])
def test_k3_matches_plain_bit_for_bit(cuda, v, d, b, h, hot, dtype):
    from repro_torch.kernels.embedding_bag import embedding_bag as bag_kernel
    from repro_torch.kernels.embedding_bag import ref as bag_ref

    table, ids, mask = make_bags(v, d, b, h, hot)
    hot_t = torch.as_tensor(table[:hot]).to(DTYPES[dtype]).to(cuda)
    ids_t, mask_t = torch.as_tensor(ids).to(cuda), torch.as_tensor(mask).to(cuda)
    before = bag_kernel.hot_bag_hot_part.launches
    got = bag_kernel.hot_bag_hot_part(hot_t, ids_t, mask_t)
    torch.cuda.synchronize()
    assert bag_kernel.hot_bag_hot_part.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, d)
    assert torch.equal(got, bag_ref.hot_bag_ref(hot_t, ids_t, mask_t))
    none = bag_kernel.hot_bag_hot_part(hot_t, ids_t, torch.zeros_like(mask_t))
    assert float(none.abs().max()) == 0.0


@pytest.mark.cuda
def test_hot_bag_on_card_matches_cpu(cuda):
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    table, ids, mask = make_bags(3000, 64, 256, 50, 512, seed=1)
    ids[3, 4] = 3000                                    # >= V: NaN, as the JAX package
    args = [torch.as_tensor(a) for a in (table, ids, mask)]
    for cap in (None, 100):
        on_card = bag_ops.hot_bag(*[a.to(cuda) for a in args], hot_size=512,
                                  cold_capacity=cap).cpu()
        on_cpu = bag_ops.hot_bag(*args, hot_size=512, cold_capacity=cap)
        assert torch.equal(torch.isnan(on_card), torch.isnan(on_cpu))
        torch.testing.assert_close(on_card.nan_to_num(), on_cpu.nan_to_num(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_mind_serving_on_card_matches_cpu(cuda):
    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.nn import recsys
    from repro_torch.serve import cache, engine, scheduler

    cfg = base.reduced(base.get_arch("mind"))
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = pipeline.recsys_batch(np.random.default_rng(0), cfg, base.RECSYS_SHAPES["serve_p99"])
    on_cpu = recsys.serve_scores(params, cfg, batch)
    card = recsys.to_device(params, cuda)
    before = kernels.hot_gather_hot_part.launches
    for impl in ("plain", "hot"):
        got = recsys.serve_scores(card, cfg, batch, impl=impl).cpu()
        torch.testing.assert_close(got, on_cpu, rtol=1e-5, atol=1e-5)
    assert kernels.hot_gather_hot_part.launches > before
    cc = cache.CacheConfig(budget_bytes=128 * cfg.embed_dim * 4)
    sc = scheduler.SchedulerConfig(max_batch=8, max_queue=64)
    st = engine.StreamConfig(requests=40, qps=1e9, deadline_s=None)
    snaps = [engine.run_recsys_stream(cfg, cc, sc, st, params=params, service_time_s=1e-3,
                                      device=dev) for dev in (cuda, "cpu")]
    assert snaps[0] == snaps[1]


def mixed_bags(v, d, b, h, hot, dtype, cuda, seed=0):
    """Bags with negative and masked-in >= V ids mixed in, on the card."""
    table, ids, mask = make_bags(v, d, b, h, hot, seed)
    ids[::5, h - 1] = v + 3
    ids[1::9, 0] = 2**30
    mask[::5, h - 1] = True
    return (torch.as_tensor(table).to(DTYPES[dtype]).to(cuda), torch.as_tensor(ids).to(cuda),
            torch.as_tensor(mask).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("v,d,b,h,hot", [(2000, 16, 512, 8, 256), (5000, 64, 300, 12, 512),
                                         (1000, 100, 64, 4, 1000), (600, 1, 70, 50, 300),
                                         (900, 200, 33, 37, 900), (300, 130, 40, 5, 0),
                                         (700, 3, 45, 9, 200)])
def test_k3_two_tier_matches_plain_bit_for_bit(cuda, v, d, b, h, hot, dtype):
    """K3's two-tier mode over the whole table, without and with cold ranks
    (the capacity at 0, half the cold pairs and all of them), bit for bit
    against its plain version; vector rows (d = 16, 64, 100, 200 f32) and
    scalar rows (d = 1, 3, 130)."""
    from repro_torch.kernels.embedding_bag import embedding_bag as bag_kernel
    from repro_torch.kernels.embedding_bag import ref as bag_ref

    table, ids, mask = mixed_bags(v, d, b, h, hot, dtype, cuda)
    rank = torch.cumsum((mask & (ids >= hot)).view(-1), 0, dtype=torch.int32).view(b, h)
    n_cold = int(rank[-1, -1])
    before = bag_kernel.hot_bag_hot_part.launches
    for r, cap in ((None, 0), (rank, 0), (rank, n_cold // 2), (rank, n_cold)):
        got = bag_kernel.hot_bag_two_tier(table, ids, mask, hot, r, cap)
        want = bag_ref.hot_bag_two_tier_ref(table, ids, mask, hot, r, cap)
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, d)
        assert same_bits(got, want), (r is not None, cap)
    torch.cuda.synchronize()
    assert bag_kernel.hot_bag_hot_part.launches == before + 4
    assert torch.isnan(got).any() and not torch.isnan(got).all()


@pytest.mark.cuda
def test_hot_bag_makes_no_host_sync(cuda):
    """ops.hot_bag is one K3 launch and no host sync at the default
    capacity, and a scan plus that launch, still without a sync, below it."""
    from repro_torch.kernels.embedding_bag import embedding_bag as bag_kernel
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    table, ids, mask = mixed_bags(3000, 64, 256, 50, 512, "f32", cuda, seed=2)
    bag_ops.hot_bag(table, ids, mask, hot_size=512)    # build and load the kernel
    torch.cuda.synchronize()
    before = bag_kernel.hot_bag_hot_part.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        full = bag_ops.hot_bag(table, ids, mask, hot_size=512)
        capped = bag_ops.hot_bag(table, ids, mask, hot_size=512, cold_capacity=100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bag_kernel.hot_bag_hot_part.launches == before + 2
    on_card = kernels_launched(lambda: bag_ops.hot_bag(table, ids, mask, hot_size=512))
    assert len(on_card) == 1, on_card
    args = [a.cpu() for a in (table, ids, mask)]
    assert same_bits(full.cpu(), bag_ops.hot_bag(*args, hot_size=512))
    assert same_bits(capped.cpu(), bag_ops.hot_bag(*args, hot_size=512, cold_capacity=100))


# --- GNN serving through the GRASP feature cache, and the four GNNs --------
def gnn_engine(cuda_or_cpu, g, feats, cfg, params, hot_fraction=0.5):
    from repro_torch.serve import cache, engine, scheduler

    return engine.GNNServeEngine(
        params, cfg, g, feats,
        cache.CacheConfig(budget_bytes=2048 * feats.shape[1] * 4, hot_fraction=hot_fraction),
        scheduler.SchedulerConfig(max_batch=16, max_queue=256), fanout=(15, 10),
        seeds_per_req=4, clock=scheduler.VirtualClock(), service_model=lambda n: 1e-3,
        device=cuda_or_cpu)


def gin_full_width(d_feat):
    from repro_torch.configs import base
    from repro_torch.nn import gnn

    cfg = base.get_arch("gin-tu")
    return cfg, gnn.init(torch.Generator().manual_seed(0), cfg, d_feat, device="cpu")


@pytest.mark.cuda
def test_gnn_serving_on_card_matches_cpu(cuda):
    """GIN at full width served over the DBG-ordered ``tw`` graph at scale
    13 with d = 100 features, on the card and on the CPU: the same counters
    and latencies (virtual clock), K1 launched on the card for every batch,
    logits within 1e-4 (the card's ``index_add_`` sums in another order)."""
    g = suite_graphs()[0]
    feats = np.random.default_rng(0).standard_normal((g.num_nodes, 100)).astype(np.float32)
    cfg, params = gin_full_width(100)
    seeds = np.random.default_rng(1).integers(0, g.num_nodes, (40, 4))
    results, snaps = [], []
    before = kernels.hot_gather_hot_part.launches
    for dev in (cuda, "cpu"):
        eng = gnn_engine(dev, g, feats, cfg, params)
        reqs = [eng.submit({"seeds": s}) for s in seeds]
        eng.run_until_idle()
        assert all(r.status == "done" for r in reqs)
        results.append(np.stack([r.result for r in reqs]))
        snaps.append(eng.metrics.snapshot())
        if dev is cuda:
            launches = kernels.hot_gather_hot_part.launches - before
    assert snaps[0] == snaps[1]
    assert launches == snaps[0]["counters"]["batches"] == 3
    assert results[0].shape == (40, 4, cfg.d_out) and np.isfinite(results[0]).all()
    np.testing.assert_allclose(results[0], results[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 1433], ids=["d=100 vector rows", "d=1433 scalar rows"])
def test_gnn_cache_reads_pinned_rows_through_k1(cuda, d):
    """K1's hot part as the GNN engine reaches it, at ogb_products' d = 100
    (16-byte rows) and full_graph_sm's d = 1433 (odd: scalar rows): each
    lookup is table[ids] exactly, and K1 on that lookup's ids is its plain
    version bit for bit."""
    from repro_torch.graph import sampler

    g = suite_graphs()[0]
    feats = np.random.default_rng(2).standard_normal((g.num_nodes, d)).astype(np.float32)
    cfg, params = gin_full_width(d)
    eng = gnn_engine(cuda, g, feats, cfg, params)
    assert eng.cache.hot_size > 0
    rng = np.random.default_rng(3)
    for _ in range(3):
        blocks = sampler.sample_blocks(g, rng.integers(0, g.num_nodes, 64), (15, 10), rng)
        before = kernels.hot_gather_hot_part.launches
        rows, stats = eng.cache.lookup(blocks.node_ids)
        assert kernels.hot_gather_hot_part.launches == before + 1 and stats.hot_hits > 0
        assert torch.equal(rows.cpu(), torch.from_numpy(feats[blocks.node_ids]))
        ids = blocks.node_ids
        idx = torch.as_tensor(np.where(ids < eng.cache.hot_size, ids, -1).astype(np.int32))
        hot = eng.cache._hot_block
        got = kernels.hot_gather_hot_part(hot, idx.to(cuda))
        assert torch.equal(got, ref.hot_gather_ref(hot, idx.to(cuda)))
        out = eng.forward_blocks(blocks)
        assert out.shape == (64, cfg.d_out) and np.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gin-tu", "pna", "egnn", "nequip"])
def test_gnn_models_on_card_match_cpu(cuda, arch):
    """Each model's apply at full width on the card against the CPU: GIN
    and PNA on one block graph sampled with minibatch_lg's fanout (15, 10)
    from 256 seeds, EGNN and NequIP on the molecule shape (128 graphs x 30
    nodes). float32 models within 1e-4 (the card's atomic sums); NequIP,
    whose self0 and gate products are bfloat16, within 2e-2 (bfloat16
    products that round the other way on the card). EGNN at random
    full-width weights drives the coordinates past float32's range (the
    JAX package's own EGNN reaches 7.9e22 at its seed 0), so its phi_x
    output layer is scaled by 1e-2 here: coordinates stay near 8, features
    near 80."""
    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.nn import gnn

    cfg = base.get_arch(arch)
    rng = np.random.default_rng(4)
    if arch in ("gin-tu", "pna"):
        shape = dataclasses.replace(base.GNN_SHAPES["minibatch_lg"], batch_nodes=256)
        batch = pipeline.gnn_minibatch(rng, suite_graphs()[0], shape, d_feat=shape.d_feat)
        d_feat = shape.d_feat
    else:
        shape = base.GNN_SHAPES["molecule"]
        batch, d_feat = pipeline.gnn_molecule_batch(rng, shape), shape.d_feat
    params = gnn.init(torch.Generator().manual_seed(0), cfg, d_feat, device="cpu")
    if arch == "egnn":
        for layer in params["layers"]:
            layer["phi_x"][-1]["w"] *= 1e-2
    on_cpu = gnn.apply(params, cfg, batch)
    on_card = gnn.apply(gnn.to_device(params, cuda), cfg, batch)
    on_cpu = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
    on_card = on_card if isinstance(on_card, tuple) else (on_card,)
    tol = 2e-2 if arch == "nequip" else 1e-4
    for got, want in zip(on_card, on_cpu):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mind", "gin-tu", "pna", "egnn", "nequip"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One AdamW train step (launch/steps.py) at the reduced config on the
    card against the CPU: the loss and every new parameter and moment.
    MIND at train shape (dense table), the GNNs at a small molecule batch
    with labels in [0, d_out) for GIN and PNA; float32 within 1e-5 (the
    card's atomic sums), NequIP within 2e-3 (its bfloat16 products)."""
    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.nn import gnn, recsys
    from repro_torch.train.tree import tree_leaves

    cfg = base.reduced(base.get_arch(arch))
    rng = np.random.default_rng(5)
    if arch == "mind":
        batch = pipeline.recsys_batch(rng, cfg, base.RecsysShape("t", "train", 256))
        params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        build, move = (lambda d: steps.recsys_train_step(cfg, device=d)), recsys.to_device
    else:
        shape = base.GNNShape("s", "molecule", 10, 20, d_feat=16, batch_graphs=8)
        batch = pipeline.gnn_molecule_batch(rng, shape)
        if cfg.kind in ("gin", "pna"):
            batch["labels"] = rng.integers(0, cfg.d_out, 8).astype(np.int32)
        params = gnn.init(torch.Generator().manual_seed(0), cfg, 16, device="cpu")
        build, move = (lambda d: steps.gnn_train_step(cfg, shape, device=d)), gnn.to_device
    out = {}
    for d in (torch.device("cpu"), cuda):
        opt_init, step = build(d)
        p = move(params, d)
        out[d.type] = step(p, opt_init(p), batch)
    tol = 2e-3 if arch == "nequip" else 1e-5
    (p_cpu, s_cpu, m_cpu), (p_card, s_card, m_card) = out["cpu"], out["cuda"]
    assert torch.isfinite(m_card["loss"])
    torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"], rtol=tol, atol=tol)
    for got, want in zip(tree_leaves((p_card, s_card)), tree_leaves((p_cpu, s_cpu))):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_trainer_restarts_on_card_bit_exact(cuda, tmp_path):
    """Trainer.fit on the card with checkpoints and two injected failures
    replays a clean run bit for bit under deterministic algorithms (GIN,
    reduced, small molecule batches seeded per step)."""
    import os

    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.nn import gnn
    from repro_torch.train import ft, optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = base.reduced(base.get_arch("gin-tu"))
    shape = base.GNNShape("s", "molecule", 10, 20, d_feat=16, batch_graphs=8)

    def batch_fn(step):
        rng = np.random.default_rng((0, step))
        return dict(pipeline.gnn_molecule_batch(rng, shape),
                    labels=rng.integers(0, cfg.d_out, 8).astype(np.int32))

    def fit(**kw):
        tr = Trainer(lambda p, b: steps.gnn_loss(p, cfg, b),
                     lambda: gnn.init(torch.Generator().manual_seed(0), cfg, 16, device=cuda),
                     optimizer.OptConfig(name="adamw"),
                     TrainerConfig(num_steps=8, log_every=1, **kw), device=cuda)
        return tr, tr.fit(batch_fn, injector=ft.FailureInjector(fail_at=(3, 6)))

    torch.use_deterministic_algorithms(True)
    try:
        clean, clean_state = fit()
        faulty, state = fit(ckpt_dir=str(tmp_path), ckpt_every=2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert faulty.restarts == 2
    assert {h["step"]: h for h in faulty.history} == {h["step"]: h for h in clean.history}
    for a, b in zip(tree_leaves(state), tree_leaves(clean_state)):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A world-size-1 NCCL process group (the default group) for the card,
    and a gloo group of the same rank for the CPU beside it."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def grasp_case(seed=0):
    """A DBG-ordered rmat(8, 6) partitioned for one rank with 64 hot rows and
    the cell's caps (pub_frac 0.25, edge_slack 1.5), GIN reduced, d_feat 16,
    labels in [0, d_out): the spec, this rank's numpy batch and parameters
    on the CPU."""
    from repro_torch.configs import base
    from repro_torch.core.reorder import reorder_ranks
    from repro_torch.dist import collectives as coll
    from repro_torch.graph.csr import apply_reorder
    from repro_torch.nn import gnn

    g = generate.rmat(8, 6, seed=1)
    g = apply_reorder(g, reorder_ranks(g, "dbg"))
    spec = coll.partition_spec_for(g.num_nodes, g.num_edges, 1, hot=64)
    cfg = base.reduced(base.get_arch("gin-tu"))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((spec.num_nodes, 16)).astype(np.float32)
    labels = rng.integers(0, cfg.d_out, spec.num_nodes).astype(np.int32)
    batch = coll.grasp_batch(x, labels, coll.grasp_partition(g, spec), spec)
    batch = {k: (v if k == "x_hot" else v[0]) for k, v in batch.items()}
    return spec, cfg, batch, gnn.init(torch.Generator().manual_seed(seed), cfg, 16, device="cpu")


@pytest.mark.cuda
def test_grasp_step_on_card_matches_cpu(nccl_group):
    """The GRASP GIN step on one NCCL rank against the same step on one gloo
    rank on the CPU, 3 steps: each loss within 1e-5, each step's summed
    gradients within 1e-5 of each leaf's largest entry, and AdamW on the
    card within 1e-5 of the CPU's AdamW of the same gradients."""
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn
    from repro_torch.train import optimizer
    from repro_torch.train.tree import tree_leaves

    spec, cfg, batch, params = grasp_case()
    opt_init, opt_update = optimizer.make(optimizer.OptConfig(name="adamw", lr=1e-3))
    runs = {}
    for label, dev, group in (("cpu", torch.device("cpu"), nccl_group),
                              ("card", torch.device("cuda"), None)):
        grads = []

        def recording(g, s, p):
            grads.append((g, s, p))
            return opt_update(g, s, p)

        step = coll.make_grasp_gin_step(spec, cfg, 16, cfg.d_out, group, recording, device=dev)
        p = gnn.to_device(params, dev)
        s = opt_init(p)
        losses = []
        for _ in range(3):
            p, s, m = step(p, s, batch)
            losses.append(m["loss"])
        runs[label] = (losses, grads, p)
    (l_cpu, g_cpu, _), (l_card, g_card, p_card) = runs["cpu"], runs["card"]
    for a, b in zip(l_card, l_cpu):
        assert torch.isfinite(a)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    for (gd, sd, pd), (gc, _, _) in zip(g_card, g_cpu):
        for a, b in zip(tree_leaves(gd), tree_leaves(gc)):
            assert a.device.type == "cuda"
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())
        want = opt_update(*(gnn.to_device(t, torch.device("cpu")) for t in (gd, sd, pd)))
        got = opt_update(gd, sd, pd)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    assert all(t.device.type == "cuda" for t in tree_leaves(p_card))


@pytest.mark.cuda
def test_grasp_pipelined_equals_sequential_on_card(nccl_group):
    """Both schedules of the GRASP step on the card, 3 steps, bit for bit
    under deterministic algorithms."""
    import os

    from repro_torch.dist import collectives as coll
    from repro_torch.nn import gnn
    from repro_torch.train import optimizer
    from repro_torch.train.tree import tree_leaves

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    spec, cfg, batch, params = grasp_case(seed=1)
    opt_init, opt_update = optimizer.make(optimizer.OptConfig(name="adamw", lr=1e-3))
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for overlap in (False, True):
            step = coll.make_grasp_gin_step(spec, cfg, 16, cfg.d_out, None, opt_update,
                                            overlap=overlap, device="cuda")
            p = gnn.to_device(params, torch.device("cuda"))
            s = opt_init(p)
            losses = []
            for _ in range(3):
                p, s, m = step(p, s, batch)
                losses.append(m["loss"])
            out[overlap] = (losses, p, s)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(tree_leaves(out[False]), tree_leaves(out[True])):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
def test_compressed_psum_on_card_matches_cpu(nccl_group):
    """compressed_psum over the NCCL rank against the gloo rank on the CPU,
    two rounds with the error carried: mean and error bit for bit."""
    from repro_torch.train import compression
    from repro_torch.train.tree import tree_leaves, tree_map

    rng = np.random.default_rng(4)
    grads = {"w": torch.from_numpy((rng.standard_normal((64, 32)) * 3).astype(np.float32)),
             "layers": [{"b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}],
             "eps": torch.tensor(0.37)}
    out = {}
    for label, dev, group in (("cpu", torch.device("cpu"), nccl_group),
                              ("card", torch.device("cuda"), None)):
        g = tree_map(lambda t: t.to(dev), grads)
        err = compression.init_error(g)
        rounds = []
        for _ in range(2):
            mean, err = compression.compressed_psum(g, err, group)
            rounds.append((mean, err))
        out[label] = rounds
    for a, b in zip(tree_leaves(out["card"]), tree_leaves(out["cpu"])):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-8b", "starcoder2-7b", "nemotron-4-340b"])
def test_lm_on_card_matches_cpu(cuda, arch):
    """A reduced dense LM config's forward, prefill (logits and KV cache)
    and 4 decode steps on the card against the CPU on the same weights,
    within tests/test_torch_lm.py's MODEL_TOL (rtol = atol = 2e-2) for
    logits and its CACHE_TOL (rtol 0.06, atol 5e-2) for the cache."""
    from repro_torch.configs import base
    from repro_torch.nn import transformer as tfm

    cfg = base.reduced(base.get_arch(arch))
    params = tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tfm.to_device(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (4, 16)))
    logit_tol, cache_tol = dict(rtol=2e-2, atol=2e-2), dict(rtol=0.06, atol=5e-2)
    torch.testing.assert_close(tfm.forward(card, cfg, tokens.to(cuda))[0].cpu(),
                               tfm.forward(params, cfg, tokens)[0], **logit_tol)
    want, wc = tfm.prefill(params, cfg, tokens[:, :12], max_len=16)
    got, gc = tfm.prefill(card, cfg, tokens[:, :12].to(cuda), max_len=16)
    torch.testing.assert_close(got.cpu(), want, **logit_tol)
    torch.testing.assert_close(gc.k.cpu().float(), wc.k.float(), **cache_tol)
    for t in range(12, 16):
        want, wc = tfm.decode_step(params, cfg, wc, tokens[:, t])
        got, gc = tfm.decode_step(card, cfg, gc, tokens[:, t].to(cuda))
        assert got.device == gc.k.device and gc.length == wc.length == t + 1
        torch.testing.assert_close(got.cpu(), want, **logit_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.25), (2, 0.5)])
def test_moe_on_card_matches_cpu(cuda, top_k, capacity_factor):
    """The MoE layer on equal inputs: the same picks kept and dropped (the
    sentinel row takes every dropped pick's write, so the card's order of
    duplicate writes cannot show), outputs within one bfloat16 product's
    tolerance (1e-2), the aux loss within 1e-6."""
    from repro_torch.nn import layers as L

    params = L.moe_init(torch.Generator().manual_seed(3), 64, 128, 4, True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((48, 64)).astype(np.float32))
    x = x.to(torch.bfloat16)
    want, wa = L.moe(params, x, top_k, capacity_factor=capacity_factor)
    got, ga = L.moe({k: v.to(cuda) if torch.is_tensor(v) else {"w": v["w"].to(cuda)}
                     for k, v in params.items()}, x.to(cuda), top_k,
                    capacity_factor=capacity_factor)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu() == 0, want == 0)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(ga.cpu(), wa, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_lm_train_step_on_card_matches_cpu(cuda):
    """``launch.steps.lm_train_step`` on the reduced minitron cut to 1
    layer, 2 microbatches of 2 x 256 positions, one AdamW step on the card
    against the CPU: the loss within 1e-3 and every gradient leaf within
    5e-2 of its largest entry (tests/test_torch_lm_train.py's bounds
    against the JAX package), every new parameter within 2 lr (Adam moves
    an element by about lr whatever the gradient's size)."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.trainer import batch_to, value_and_grad
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(base.reduced(base.get_arch("minitron-8b")), n_layers=1,
                              microbatches=2)
    shape = base.LMShape("t", "train", 256, 4)
    batch = pipeline.lm_batch(np.random.default_rng(6), cfg, 4, 256)
    params = tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    out = {}
    for d in (torch.device("cpu"), cuda):
        p = tree_map(lambda t: t.to(d, copy=True), params)   # the donated step writes p
        grads = value_and_grad(tfm.loss_fn, p, cfg, batch_to(batch, d))[1]
        opt_init, step = steps.lm_train_step(cfg, shape, device=d)
        out[d.type] = step(p, opt_init(p), batch), grads
    (p_cpu, _, m_cpu), g_cpu = out["cpu"]
    (p_card, _, m_card), g_card = out["cuda"]
    assert torch.isfinite(m_card["loss"])
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-3
    for got, want in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        assert float((got.cpu() - want).abs().max()) <= 5e-2 * float(want.abs().max())
    for got, want in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert float((got.cpu() - want).abs().max()) <= 2 * 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adamw-f32", "adamw-bf16", "adafactor"])
def test_lm_donated_steps_on_card_match_undonated_bits(cuda, opt):
    """On the card, under deterministic algorithms, the reduced
    starcoder2-7b with 2 microbatches: ``lm_train_step`` donated and not
    (its AdamW), and ``Trainer.fit`` donated and not with each optimizer,
    2 steps each: the same losses, parameters and optimizer state bit for
    bit; the donated step's parameters are the tensors it was given."""
    import dataclasses
    import os

    from repro_torch.configs import base
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.nn import transformer as tfm
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves, tree_map

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(base.reduced(base.get_arch("starcoder2-7b")), microbatches=2)
    shape = base.LMShape("t", "train", 128, 4)
    opt_cfg = {"sgd": optimizer.OptConfig(name="sgd", lr=1e-2),
               "adamw-f32": optimizer.OptConfig(lr=1e-3),
               "adamw-bf16": optimizer.OptConfig(lr=1e-3, moment_dtype="bfloat16"),
               "adafactor": optimizer.OptConfig(name="adafactor", lr=1e-2)}[opt]
    batch_fn = pipeline.make_batch_fn("lm", cfg, shape, seed=7)
    params = tfm.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for donate in (True, False):
            opt_init, step = steps.lm_train_step(cfg, shape, device=cuda, donate=donate)
            p = tree_map(torch.clone, params)
            state, ids, losses = opt_init(p), [id(t) for t in tree_leaves(p)], []
            for s in range(2):
                p, state, m = step(p, state, batch_fn(s))
                losses.append(m["loss"])
            tr = Trainer(lambda q, b: tfm.loss_fn(q, cfg, b), lambda: params, opt_cfg,
                         TrainerConfig(num_steps=2, microbatches=2, log_every=1,
                                       donate=donate), device=cuda)
            runs[donate] = (p, state, losses, [id(t) for t in tree_leaves(p)] == ids,
                            tr.fit(batch_fn), tr.history)
    finally:
        torch.use_deterministic_algorithms(False)
    (p_d, s_d, l_d, kept, fit_d, h_d), (p_u, s_u, l_u, _, fit_u, h_u) = runs[True], runs[False]
    assert kept and h_d == h_u
    assert all(torch.equal(a, b) for a, b in zip(l_d, l_u))
    for a, b in zip(tree_leaves((p_d, s_d, fit_d)), tree_leaves((p_u, s_u, fit_u))):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
    # the donated fit copied its initial parameters: the caller's are unchanged
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(tfm.init(torch.Generator().manual_seed(0), cfg,
                                                  device=cuda))))
