"""repro_torch.serve against the JAX package's serving tier, on the CPU.

The cache's host metadata (slot maps, RRPV counters, LRU stamps), its
``LookupStats``, metrics counters and snapshots must equal the JAX
``EmbeddingCache``'s and ``ReferenceEmbeddingCache``'s exactly, and its
rows must equal ``table[ids]``. The scheduler and metrics tests repeat
tests/test_serve.py's on the port's classes. Engine and stream scores are
held to 1e-5 (tests/test_serve.py's tolerance), their counters exactly.
"""
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.core import plan as j_plan
from repro.nn import recsys as j_recsys
from repro.serve import cache as j_cache
from repro.serve import engine as j_engine
from repro.serve import refcache as j_refcache
from repro.serve import scheduler as j_sched
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.core import plan as t_plan
from repro_torch.nn import recsys as t_recsys
from repro_torch.serve import cache as t_cache
from repro_torch.serve import engine as t_engine
from repro_torch.serve import refcache as t_refcache
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics, _EDGES
from repro_torch.serve.scheduler import ContinuousBatcher, SchedulerConfig, VirtualClock

N, D = 512, 8
ROW = D * 4
META = ("_slot_id", "_slot_rrpv", "_slot_ts", "_id_slot")
J_CFG = j_cfgs.reduced(j_cfgs.get_arch("mind"))
T_CFG = t_cfgs.reduced(t_cfgs.get_arch("mind"))


def _table(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def cache_pair(table, rows, hot_fraction=0.5, policy="rrpv", use_kernel=True,
               with_plan=False, reference=False):
    """(JAX cache, port cache) of one geometry, fed the same table."""
    plans = (None, None)
    if with_plan:
        plans = tuple(m.make_plan(table.shape[0], ROW, budget_bytes=rows * ROW // 4)
                      for m in (j_plan, t_plan))
    j_cls = j_refcache.ReferenceEmbeddingCache if reference else j_cache.EmbeddingCache
    t_cls = t_refcache.ReferenceEmbeddingCache if reference else t_cache.EmbeddingCache
    jc = j_cls(table, j_cache.CacheConfig(budget_bytes=rows * ROW, hot_fraction=hot_fraction,
                                          policy=policy, use_kernel=use_kernel, tile_e=128),
               plan=plans[0])
    tc = t_cls(table, t_cache.CacheConfig(budget_bytes=rows * ROW, hot_fraction=hot_fraction,
                                          policy=policy, use_kernel=use_kernel),
               plan=plans[1], device="cpu")
    return jc, tc


def id_stream(seed, batches=10, size=96):
    rng = np.random.default_rng(seed)
    for bi in range(batches):
        if bi == 5:
            yield np.array([], dtype=np.int64)             # empty mid-stream
        elif bi % 3 == 1:
            ids = np.minimum(rng.zipf(1.2, size) - 1, N - 1)
            yield np.concatenate([ids, ids[:7]])           # duplicates
        else:
            yield rng.integers(0, N, size)


def assert_same_state(jc, tc):
    for attr in META:
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr))
    assert (tc._clock, tc._resident) == (jc._clock, jc._resident)
    assert tc.metrics.counters == jc.metrics.counters
    assert tc.metrics.gauges == jc.metrics.gauges
    assert tc.metrics.hit_rate == jc.metrics.hit_rate
    assert tc.snapshot() == jc.snapshot()
    tc.check_consistency()


GEOMETRIES = [(24, 0.25), (32, 0.5), (8, 0.0), (32, 1.0), (96, 0.5)]


@pytest.mark.parametrize("rows,hot_fraction", GEOMETRIES)
@pytest.mark.parametrize("policy", ["rrpv", "lru"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_cache_matches_jax_cache(rows, hot_fraction, policy, with_plan):
    table = _table()
    # the JAX kernel path runs its Pallas kernel in interpret mode: slow, so
    # half the cases take the host gather (both packages alike)
    use_kernel = (rows + with_plan) % 2 == 0
    jc, tc = cache_pair(table, rows, hot_fraction, policy, use_kernel, with_plan)
    assert (tc.hot_size, tc.cold_slots) == (jc.hot_size, jc.cold_slots)
    for ids in id_stream(rows * 10 + 2 * (policy == "lru") + with_plan):
        j_out, j_st = jc.lookup(ids)
        t_out, t_st = tc.lookup(ids)
        assert isinstance(t_out, torch.Tensor) and t_out.device.type == "cpu"
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_out.numpy(), table[np.asarray(ids, np.int64)])
        assert dataclasses.asdict(t_st) == dataclasses.asdict(j_st)
        assert t_st.hit_rate == j_st.hit_rate
    assert_same_state(jc, tc)
    assert torch.equal(tc.cold_rows_device(), torch.tensor(np.asarray(jc.cold_rows_device())))


@pytest.mark.parametrize("policy", ["rrpv", "lru"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_reference_cache_matches_jax_and_vectorized(policy, use_kernel):
    table = _table(seed=1)
    jr, tr = cache_pair(table, 24, 0.25, policy, use_kernel, reference=True)
    _, tv = cache_pair(table, 24, 0.25, policy, use_kernel)
    for ids in id_stream(7, batches=8):
        j_out, j_st = jr.lookup(ids)
        r_out, r_st = tr.lookup(ids)
        v_out, v_st = tv.lookup(ids)
        np.testing.assert_array_equal(r_out.numpy(), np.asarray(j_out))
        assert torch.equal(v_out, r_out)
        assert dataclasses.asdict(r_st) == dataclasses.asdict(j_st) == dataclasses.asdict(v_st)
    assert_same_state(jr, tr)
    for attr in META:
        np.testing.assert_array_equal(getattr(tv, attr), getattr(tr, attr))
    assert tv.metrics.counters == tr.metrics.counters


def test_duplicates_and_zero_cold_slots():
    table = _table()
    for rows, frac, ids in ((32, 0.5, [23] * 5 + [3] * 2),
                            (32, 1.0, [0, 1, 31, 32, 100, 100, N - 1])):
        jc, tc = cache_pair(table, rows, frac)
        for _ in range(2):
            j_out, j_st = jc.lookup(np.array(ids))
            t_out, t_st = tc.lookup(np.array(ids))
            np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
            assert dataclasses.asdict(t_st) == dataclasses.asdict(j_st)
        assert_same_state(jc, tc)
    assert tc.cold_slots == 0 and t_st.bypassed == 4


def test_degree_caps_pinned_region_and_ids_are_checked():
    table = _table()
    degree = np.zeros(N)
    degree[:10] = 100.0
    tc = t_cache.EmbeddingCache(table, t_cache.CacheConfig(budget_bytes=64 * ROW),
                                degree=degree, device="cpu")
    assert tc.hot_size == 10 and tc.capacity == 64 and tc.cold_slots == 54
    for bad in ([N], [-1]):
        with pytest.raises(IndexError):
            tc.lookup(np.array(bad))
    out, st = tc.lookup(np.array([], dtype=np.int64))
    assert tuple(out.shape) == (0, D) and st == t_cache.LookupStats() and tc._clock == 0


def test_jax_snapshot_restores_into_port(tmp_path):
    table = _table(seed=2)
    jc, _ = cache_pair(table, 24, 0.25)
    for ids in id_stream(3, batches=6):
        jc.lookup(ids)
    path = tmp_path / "jax_snap.json"
    jc.save_snapshot(str(path))
    _, tc = cache_pair(table, 24, 0.25)
    assert tc.load_snapshot(str(path))
    for attr in META:
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr))
    assert tc.snapshot() == jc.snapshot()
    assert tc.metrics.counters["snapshot_restores"] == 1
    assert torch.equal(tc.cold_rows_device(), torch.tensor(np.asarray(jc.cold_rows_device())))
    # both go on identically after the warm start
    for ids in id_stream(4, batches=4):
        j_out, _ = jc.lookup(ids)
        t_out, _ = tc.lookup(ids)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    for attr in META:
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr))
    assert not tc.load_snapshot(str(tmp_path / "missing.json"))


def test_corrupt_snapshots_are_refused(tmp_path):
    table = _table(seed=2)
    _, tc = cache_pair(table, 24, 0.25)
    tc.lookup(np.arange(6, 60))
    good = tc.snapshot()
    bad_version = dict(good, version=2)
    bad_sum = json.loads(json.dumps(good))
    bad_sum["state"]["clock"] += 1
    _, other = cache_pair(table, 32, 0.25)
    for bad in (bad_version, bad_sum, "garbage"):
        with pytest.raises(t_cache.SnapshotError):
            tc.restore(bad)
    with pytest.raises(t_cache.SnapshotError):
        other.restore(good)                      # geometry mismatch
    torn = tmp_path / "torn.json"
    torn.write_text(json.dumps(good)[:-20])
    with pytest.raises(t_cache.SnapshotError):
        tc.load_snapshot(str(torn))
    _, fresh = cache_pair(table, 24, 0.25)
    fresh.restore(good)
    assert fresh.snapshot() == good and fresh._resident == tc._resident


# ---------------------------------------------------------------------------
# scheduler and metrics (tests/test_serve.py's, on the port's classes)
# ---------------------------------------------------------------------------
def test_admission_control_rejects_when_full():
    b = ContinuousBatcher(SchedulerConfig(max_batch=2, max_queue=3), VirtualClock())
    reqs = [b.submit({"i": i}) for i in range(5)]
    assert [r.status for r in reqs] == ["queued"] * 3 + ["rejected"] * 2
    assert b.metrics.counters["admitted"] == 3
    assert b.metrics.counters["rejected"] == 2


def test_shed_expired_and_edf_order():
    clock = VirtualClock()
    b = ContinuousBatcher(SchedulerConfig(max_batch=2, max_queue=10), clock)
    late = b.submit("late", deadline_s=0.5)
    soon = b.submit("soon", deadline_s=0.2)
    dead = b.submit("dead", deadline_s=0.05)
    nodl = b.submit("best-effort")
    clock.advance(0.1)
    batch = b.next_batch()
    assert dead.status == "shed"
    assert [r.payload for r in batch] == ["soon", "late"]
    assert late.status == soon.status == "running"
    assert [r.payload for r in b.next_batch()] == ["best-effort"]
    assert nodl.status == "running"
    assert b.metrics.counters["shed"] == 1


def test_latency_accounting_virtual_time():
    clock = VirtualClock()
    b = ContinuousBatcher(SchedulerConfig(max_batch=4, max_queue=8), clock)
    b.submit("x")
    clock.advance(0.25)
    batch = b.next_batch()
    clock.advance(0.1)
    b.complete(batch, ["ok"])
    assert batch[0].result == "ok" and batch[0].status == "done"
    lat = b.metrics.snapshot()["latency"]
    assert lat["queue_wait"]["max_s"] == pytest.approx(0.25)
    assert lat["service"]["max_s"] == pytest.approx(0.1)
    assert lat["e2e"]["max_s"] == pytest.approx(0.35)


def test_concurrent_submit_admits_exactly_max_queue():
    q, threads_n, per_thread = 16, 8, 10
    b = ContinuousBatcher(SchedulerConfig(max_batch=4, max_queue=q), VirtualClock())
    reqs, lock = [], threading.Lock()

    def submitter(k):
        mine = [b.submit({"t": k, "i": i}) for i in range(per_thread)]
        with lock:
            reqs.extend(mine)

    ts = [threading.Thread(target=submitter, args=(k,)) for k in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
        assert not t.is_alive()
    admitted = [r for r in reqs if r.status == "queued"]
    rejected = [r for r in reqs if r.status == "rejected"]
    assert len(admitted) == q == b.depth
    assert len(rejected) == threads_n * per_thread - q
    assert all(r.done.is_set() for r in rejected)
    assert not any(r.done.is_set() for r in admitted)


def test_edf_equal_deadlines_stable_arrival_order():
    b = ContinuousBatcher(SchedulerConfig(max_batch=8, max_queue=16), VirtualClock())
    reqs = [b.submit(i, deadline_s=1.0) for i in range(6)]
    batch = b.next_batch()
    assert [r.payload for r in batch] == list(range(6))
    assert [r.rid for r in batch] == [r.rid for r in reqs]


def test_shed_completed_and_failed_requests_resolve_events():
    clock = VirtualClock()
    b = ContinuousBatcher(SchedulerConfig(max_batch=2, max_queue=8), clock)
    doomed = b.submit("doomed", deadline_s=0.01)
    kept = b.submit("kept", deadline_s=10.0)
    clock.advance(0.1)
    batch = b.next_batch()
    assert doomed.status == "shed" and doomed.wait(0.0) and doomed.finished is not None
    assert not kept.done.is_set()
    b.complete(batch, ["ok"])
    assert kept.done.is_set() and kept.result == "ok"
    reqs = [b.submit(i) for i in range(3)]
    boom = RuntimeError("forward exploded")
    b.fail(b.next_batch(), boom)
    b.fail_all(boom)
    assert all(r.status == "failed" and r.done.is_set() and r.error is boom for r in reqs)
    assert b.metrics.counters["failed"] == 3


def test_histogram_percentiles_overflow_and_json(tmp_path):
    m = ServeMetrics()
    for v in [0.001] * 98 + [0.5] * 2:
        m.observe("e2e", v)
    assert 0.001 <= m.hists["e2e"].percentile(50) <= 0.002
    assert 0.5 <= m.hists["e2e"].percentile(99) <= 1.0
    m.count("misses", 3)
    m.count("hot_hits", 7)
    assert m.hit_rate == pytest.approx(0.7)
    out = tmp_path / "snap.json"
    snap = m.write_json(str(out), extra={"tag": "t"})
    assert json.loads(out.read_text()) == snap and snap["tag"] == "t"
    h = LatencyHistogram()
    for v in [0.001] * 98 + [200.0, 500.0]:
        h.observe(v)
    assert h.percentile(99) == pytest.approx(500.0)
    assert h.percentile(50) <= 0.002
    h2 = LatencyHistogram()
    h2.observe(float(_EDGES[-1]) * 4)
    assert h2.percentile(50) == pytest.approx(float(_EDGES[-1]) * 4)


def test_hit_rate_may_be_negative_as_in_the_reference():
    """Under thrashing a batch's fills displace each other, and the
    displaced references count again as bypasses: cold_hits and hit_rate
    go below zero. The port keeps the reference's counters as they are."""
    table = _table()
    jc, tc = cache_pair(table, 8, 0.25, use_kernel=False)     # hot 2 + cold 6
    ids = np.arange(10, 60)
    j_out, j_st = jc.lookup(ids)
    t_out, t_st = tc.lookup(ids)
    assert dataclasses.asdict(t_st) == dataclasses.asdict(j_st)
    assert t_st.cold_hits < 0 and t_st.hit_rate < 0
    assert tc.metrics.hit_rate == jc.metrics.hit_rate < 0
    np.testing.assert_array_equal(t_out.numpy(), table[ids])


def test_metrics_thread_safe_under_concurrent_mutation():
    m = ServeMetrics()
    n, per = 8, 500

    def hammer(k):
        for i in range(per):
            m.count("hot_hits")
            m.observe("e2e", 0.001 * (k + 1))
            m.gauge("last", float(i))

    ts = [threading.Thread(target=hammer, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
        assert not t.is_alive()
    snap = m.snapshot()
    assert snap["counters"]["hot_hits"] == n * per
    assert snap["latency"]["e2e"]["count"] == n * per
    assert snap["latency"]["e2e"]["max_s"] == pytest.approx(0.008)


# ---------------------------------------------------------------------------
# engine, stream, CLI
# ---------------------------------------------------------------------------
def mind_params():
    jp = j_recsys.init(jax.random.PRNGKey(0), J_CFG)
    return jp, convert.mind_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_recsys_engine_matches_jax_engine_and_dense_scores(use_kernel):
    jp, tp = mind_params()
    rng = np.random.default_rng(0)
    payloads = [{
        "hist": rng.integers(0, J_CFG.n_items, J_CFG.hist_len).astype(np.int32),
        "hist_mask": rng.random(J_CFG.hist_len) < 0.9,
        "candidates": rng.integers(0, J_CFG.n_items, 16).astype(np.int32),
    } for _ in range(5)]
    budget = 64 * J_CFG.embed_dim * 4
    sched = dict(max_batch=4, max_queue=16)
    je = j_engine.RecsysServeEngine(
        jp, J_CFG, j_cache.CacheConfig(budget_bytes=budget, tile_e=128, use_kernel=use_kernel),
        j_sched.SchedulerConfig(**sched), clock=j_sched.VirtualClock(),
        service_model=lambda n: 1e-3)
    te = t_engine.RecsysServeEngine(
        tp, T_CFG, t_cache.CacheConfig(budget_bytes=budget, use_kernel=use_kernel),
        SchedulerConfig(**sched), clock=VirtualClock(), service_model=lambda n: 1e-3,
        device="cpu")
    j_reqs = [je.submit(p) for p in payloads]
    t_reqs = [te.submit(p) for p in payloads]
    je.run_until_idle()
    te.run_until_idle()
    assert all(r.status == "done" for r in t_reqs)
    got = np.stack([r.result for r in t_reqs])
    np.testing.assert_allclose(got, np.stack([r.result for r in j_reqs]), rtol=1e-5, atol=1e-5)
    dense = t_recsys.serve_scores(tp, T_CFG, {k: np.stack([p[k] for p in payloads])
                                              for k in payloads[0]})
    np.testing.assert_allclose(got, dense.numpy(), rtol=1e-5, atol=1e-5)
    assert te.metrics.counters == je.metrics.counters
    assert te.metrics.counters["batches"] == 2          # 4 + 1 (partial, padded)
    assert te.metrics.snapshot()["latency"] == je.metrics.snapshot()["latency"]
    te.warmup(candidates=16)
    assert te.metrics.counters == je.metrics.counters   # warmup touches nothing


@pytest.mark.parametrize("hot_fraction,policy", [(0.5, "rrpv"), (0.0, "rrpv"), (0.0, "lru")])
def test_run_recsys_stream_matches_jax(hot_fraction, policy):
    jp, tp = mind_params()
    stream = dict(requests=48, qps=4000.0, candidates=16, deadline_s=0.004, seed=1)
    sched = dict(max_batch=8, max_queue=16)
    cache = dict(budget_bytes=128 * J_CFG.embed_dim * 4, hot_fraction=hot_fraction,
                 policy=policy)
    want = j_engine.run_recsys_stream(
        J_CFG, j_cache.CacheConfig(**cache, tile_e=128), j_sched.SchedulerConfig(**sched),
        j_engine.StreamConfig(**stream), params=jp, service_time_s=2e-3)
    got = t_engine.run_recsys_stream(
        T_CFG, t_cache.CacheConfig(**cache), SchedulerConfig(**sched),
        t_engine.StreamConfig(**stream), params=tp, service_time_s=2e-3, device="cpu")
    assert got == want
    c = got["counters"]
    assert c["completed"] + c.get("shed", 0) + c.get("rejected", 0) == 48


def test_run_recsys_stream_default_params_on_cpu():
    snap = t_engine.run_recsys_stream(
        T_CFG, t_cache.CacheConfig(budget_bytes=4 << 10), SchedulerConfig(max_batch=4),
        t_engine.StreamConfig(requests=12, qps=1e9, deadline_s=None), service_time_s=1e-3,
        device="cpu")
    assert snap["counters"]["completed"] == 12 and 0.0 < snap["hit_rate"] <= 1.0


# ---------------------------------------------------------------------------
# GNN serving
# ---------------------------------------------------------------------------
def gnn_setup(d=8):
    """rmat(8, 4) in both packages, seeded features and GIN weights."""
    from repro.graph import generate as j_gen
    from repro.nn import gnn as j_gnn
    from repro_torch.graph import generate as t_gen

    jg, tg = j_gen.rmat(8, 4, seed=0), t_gen.rmat(8, 4, seed=0)
    feats = np.random.default_rng(0).standard_normal((jg.num_nodes, d)).astype(np.float32)
    jcfg = j_cfgs.reduced(j_cfgs.get_arch("gin-tu"))
    tcfg = t_cfgs.reduced(t_cfgs.get_arch("gin-tu"))
    jp = j_gnn.init(jax.random.PRNGKey(0), jcfg, d)
    tp = convert.gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (jg, jcfg, jp), (tg, tcfg, tp), feats


def test_gnn_engine_blocks_match_dense_gather():
    """tests/test_serve.py's GNN engine test on the port: GIN over
    cache-gathered features == GIN over densely gathered features, then
    the queued path."""
    from repro_torch.graph import sampler
    from repro_torch.nn import gnn as t_gnn

    _, (g, cfg, params), feats = gnn_setup()
    eng = t_engine.GNNServeEngine(
        params, cfg, g, feats, t_cache.CacheConfig(budget_bytes=64 * 8 * 4),
        SchedulerConfig(max_batch=2, max_queue=8), fanout=(3, 3), seeds_per_req=2,
        clock=VirtualClock(), service_model=lambda n: 1e-3, device="cpu")
    blocks = sampler.sample_blocks(g, np.array([1, 5, 9, 200]), (3, 3),
                                   np.random.default_rng(7))
    got = eng.forward_blocks(blocks)
    x = torch.where(torch.from_numpy(blocks.node_mask)[:, None],
                    torch.from_numpy(feats[blocks.node_ids]), 0.0)
    ref = t_gnn.apply(params, cfg, {"x": x, "src": blocks.src, "dst": blocks.dst,
                                    "emask": blocks.emask})
    np.testing.assert_allclose(got, ref.numpy()[blocks.seeds_local], rtol=1e-5, atol=1e-6)
    # queued path: per-request logits with the right shape
    r1 = eng.submit({"seeds": np.array([0, 1])})
    r2 = eng.submit({"seeds": np.array([2, 3])})
    eng.run_until_idle()
    assert eng.metrics.counters["completed"] == 2
    assert r1.result.shape == r2.result.shape == (2, cfg.d_out)
    assert np.isfinite(r1.result).all()


@pytest.mark.parametrize("hot_fraction,policy,use_kernel", [
    (0.5, "rrpv", True), (0.5, "rrpv", False), (0.0, "rrpv", True), (0.0, "lru", True)])
def test_gnn_engine_matches_jax_engine(monkeypatch, hot_fraction, policy, use_kernel):
    """Same graph, features, weights, cache and requests: the same sampled
    blocks, every counter of the snapshot equal, logits within 1e-5."""
    from repro.graph import sampler as j_sampler
    from repro_torch.graph import sampler as t_sampler

    (jg, jcfg, jp), (tg, tcfg, tp), feats = gnn_setup()
    sampled = {"jax": [], "port": []}
    for key, mod in (("jax", j_sampler), ("port", t_sampler)):
        def recording(*args, _orig=mod.sample_blocks, _out=sampled[key]):
            _out.append(_orig(*args))
            return _out[-1]
        monkeypatch.setattr(mod, "sample_blocks", recording)
    cache = dict(budget_bytes=96 * 8 * 4, hot_fraction=hot_fraction, policy=policy,
                 use_kernel=use_kernel)
    kw = dict(fanout=(4, 3), seeds_per_req=3, service_model=lambda n: 1e-3, seed=5)
    je = j_engine.GNNServeEngine(jp, jcfg, jg, feats, j_cache.CacheConfig(**cache, tile_e=128),
                                 j_sched.SchedulerConfig(max_batch=4, max_queue=32),
                                 clock=j_sched.VirtualClock(), **kw)
    te = t_engine.GNNServeEngine(tp, tcfg, tg, feats, t_cache.CacheConfig(**cache),
                                 SchedulerConfig(max_batch=4, max_queue=32),
                                 clock=VirtualClock(), device="cpu", **kw)
    rng = np.random.default_rng(2)
    seeds = [rng.integers(0, jg.num_nodes, 3) for _ in range(11)]   # 4 + 4 + 3 (padded)
    j_reqs = [je.submit({"seeds": s}) for s in seeds]
    t_reqs = [te.submit({"seeds": s}) for s in seeds]
    je.run_until_idle()
    te.run_until_idle()
    assert all(r.status == "done" for r in t_reqs)
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.result.shape == (3, tcfg.d_out)
        np.testing.assert_allclose(tr.result, jr.result, rtol=1e-5, atol=1e-5)
    assert len(sampled["port"]) == len(sampled["jax"]) == 3
    for jb, tb in zip(sampled["jax"], sampled["port"]):
        for f in dataclasses.fields(jb):
            np.testing.assert_array_equal(getattr(tb, f.name), getattr(jb, f.name))
    assert te.metrics.snapshot() == je.metrics.snapshot()
    assert te.metrics.counters["batches"] == 3
    assert (te.cache.hot_size, te.cache.cold_slots) == (je.cache.hot_size, je.cache.cold_slots)
    assert_same_state(je.cache, te.cache)


def test_gnn_engine_caps_the_pinned_region_at_hot_vertices():
    """degree = the graph's out-degree: a budget that could pin every row
    pins only the hot vertices (out-degree >= average), as the JAX engine."""
    (jg, jcfg, jp), (tg, tcfg, tp), feats = gnn_setup()
    budget = jg.num_nodes * 8 * 4
    je = j_engine.GNNServeEngine(jp, jcfg, jg, feats,
                                 j_cache.CacheConfig(budget_bytes=budget, hot_fraction=1.0,
                                                     tile_e=128), j_sched.SchedulerConfig())
    te = t_engine.GNNServeEngine(tp, tcfg, tg, feats,
                                 t_cache.CacheConfig(budget_bytes=budget, hot_fraction=1.0),
                                 SchedulerConfig(), device="cpu")
    hot = int((tg.out_degree >= tg.out_degree.mean()).sum())
    assert te.cache.hot_size == je.cache.hot_size == hot < tg.num_nodes


def test_launch_serve_cli_recsys(tmp_path):
    from repro.launch import serve as j_cli
    from repro_torch.launch import serve as t_cli

    out = tmp_path / "s.json"
    argv = ["--engine", "recsys", "--requests", "24", "--batch", "4", "--qps", "1e9",
            "--budget-kb", "4", "--deadline-ms", "1e9"]
    snap = t_cli.main(argv + ["--json", str(out), "--device", "cpu"])
    assert snap["counters"]["completed"] == 24
    assert 0.0 < snap["hit_rate"] <= 1.0
    assert json.loads(out.read_text())["counters"] == snap["counters"]
    want = j_cli.main(argv)
    assert snap["counters"] == want["counters"] and snap["config"] == want["config"]
    # --gateway serves (tests/test_torch_gateway.py and, for the LM engine,
    # tests/test_torch_lm_serve.py); the local LM loop counts what it served
    stats = t_cli.main(["--engine", "lm", "--device", "cpu", "--requests", "3", "--batch", "2",
                        "--prefill", "8", "--decode", "2"])
    assert stats["requests"] == 3 and stats["tokens"] == 6
