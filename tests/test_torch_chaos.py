"""repro_torch.chaos and the gateway resilience layers it exists to
validate (tests/test_chaos.py's, on the port's classes), then the port's
fault injection against the JAX package's.

Seeded injection determinism, supervisor recovery from the
silent-pump-death failure mode, the circuit-breaker state machine on a
fake clock, GRASP cache snapshot/restore (corruption and mismatch refused),
idempotency-key dedupe over real loopback sockets, and the client's
defensive Retry-After parse. The serving stack runs over stub engines
(``torch_gateway_stubs``); only the cache tests touch tensors, on the CPU.
Across packages: ``FaultSchedule.decide`` gives the same decisions, and
one seeded single-worker chaos workload gives the same ``InjectionLog``
and the same outcome sequence under either package's gateway.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import chaos as j_chaos
from repro import gateway as j_gw
from repro_torch import chaos as t_chaos
from repro_torch import gateway as t_gw
from repro_torch.chaos import ChaosClient, ChaosEngine, FaultSchedule, FaultSpec
from repro_torch.chaos.inject import InjectedFault
from repro_torch.gateway import (
    CircuitBreaker,
    EnginePump,
    Failed,
    GatewayClient,
    GatewayServer,
    IdempotencyCache,
    PumpSupervisor,
    Timeout,
    Unavailable,
)
from repro_torch.gateway.client import _parse_retry_after
from repro_torch.serve.cache import CacheConfig, EmbeddingCache, SnapshotError
from repro_torch.serve.metrics import ServeMetrics
from torch_gateway_stubs import EchoEngine, ScoreStubEngine, scripted_server

FAST_SUP = dict(check_interval_s=0.002, backoff_s=0.002, backoff_cap_s=0.01)


class ScriptedSchedule(FaultSchedule):
    """Fires exactly the given ``(kind, index)`` pairs — unit tests want
    surgical injection, not probabilistic rates."""

    def __init__(self, fire):
        super().__init__(FaultSpec())
        self._fire = frozenset(fire)

    def decide(self, kind, index):
        if (kind, index) in self._fire:
            self.log.record(kind, index)
            return True
        return False


# ---------------------------------------------------------------------------
# seeded injection: determinism + wrappers
# ---------------------------------------------------------------------------
def test_fault_decisions_are_pure_functions_of_seed():
    spec = FaultSpec(seed=123, forward_error_rate=0.3, pump_crash_rate=0.1)
    a, b = FaultSchedule(spec), FaultSchedule(spec)
    seq_a = [a.decide("forward_error", i) for i in range(200)]
    seq_b = [b.decide("forward_error", i) for i in range(200)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)
    assert a.log.entries() == b.log.entries()
    # the log holds exactly the fired indices
    assert a.log.count("forward_error") == sum(seq_a)
    # kinds draw independent streams: same indices, different decisions
    seq_crash = [a.decide("pump_crash", i) for i in range(200)]
    assert seq_crash != seq_a
    # a different seed moves the fired set
    c = FaultSchedule(FaultSpec(seed=124, forward_error_rate=0.3))
    assert [c.decide("forward_error", i) for i in range(200)] != seq_a


def test_fault_rate_edges():
    always = FaultSchedule(FaultSpec(forward_error_rate=1.0))
    never = FaultSchedule(FaultSpec(forward_error_rate=0.0))
    assert all(always.decide("forward_error", i) for i in range(8))
    assert not any(never.decide("forward_error", i) for i in range(8))
    assert never.log.entries() == []


def test_injection_log_order_and_summary():
    sched = ScriptedSchedule([("conn_reset", 3), ("forward_error", 1),
                              ("forward_error", 0)])
    for i in range(4):
        sched.decide("conn_reset", i)
        sched.decide("forward_error", i)
    assert sched.log.entries() == [("conn_reset", 3), ("forward_error", 0),
                                   ("forward_error", 1)]
    assert sched.log.summary() == {"conn_reset": 1, "forward_error": 2}


def test_chaos_engine_injects_forward_faults_and_passes_through():
    eng = EchoEngine()
    chaos = ChaosEngine(eng, ScriptedSchedule([("forward_error", 1)]))
    assert chaos.forward([1, 2]) == [2, 4]          # call #0: clean
    with pytest.raises(InjectedFault):
        chaos.forward([1])                          # call #1: injected
    assert chaos.forward([3]) == [6]                # call #2: clean again
    # the wrapper presents the full engine surface
    assert chaos.metrics is eng.metrics
    assert chaos.batcher.depth == 0
    assert chaos.batcher.config.max_batch == eng.batcher.config.max_batch


# ---------------------------------------------------------------------------
# supervisor: the silent-pump-death regressions
# ---------------------------------------------------------------------------
def test_supervisor_restarts_pump_killed_by_next_batch():
    """``next_batch`` raising kills the pump thread; under supervision the
    pump must come back and serve everything."""
    eng = EchoEngine()
    chaos = ChaosEngine(eng, ScriptedSchedule([("pump_crash", 0),
                                               ("pump_crash", 2)]))
    pump = EnginePump(chaos, "echo").start()
    with PumpSupervisor(pump, **FAST_SUP) as sup:
        for i in range(6):
            assert pump.call(i, timeout=10.0) == 2 * i
        deadline = time.monotonic() + 5.0
        while sup.restarts < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
    assert pump.crashes == 2
    assert sup.restarts == 2 and sup.deaths == 2
    assert chaos.schedule.log.count("pump_crash") == 2
    assert pump.generation == 3          # initial spawn + two restarts
    assert eng.metrics.counters["completed"] == 6
    pump.close()
    assert sup.healthy                   # two restarts is not a crash loop


def test_supervisor_ignores_never_started_pump_and_close_is_clean():
    """The watchdog must not 'restart' a pump that was never started, and
    ``close()`` on that pump (with the supervisor still watching) must fail
    queued work out, not fight the supervisor."""
    eng = EchoEngine()
    pump = EnginePump(eng, "echo")       # never started
    req = pump.submit(1)
    with PumpSupervisor(pump, **FAST_SUP) as sup:
        time.sleep(0.05)                 # many check intervals
        assert sup.restarts == 0 and sup.deaths == 0 and sup.healthy
        pump.close(timeout=0.5)
        time.sleep(0.05)                 # draining: still not a crash
        assert sup.restarts == 0 and sup.deaths == 0
    assert req.status == "failed" and req.done.is_set()
    assert not pump.running and pump.restart() is False


def test_supervisor_crash_loop_trips_unhealthy():
    eng = EchoEngine()
    # every claim crashes: the engine can never actually serve
    chaos = ChaosEngine(eng, FaultSchedule(FaultSpec(pump_crash_rate=1.0)))
    pump = EnginePump(chaos, "echo").start()
    sup = PumpSupervisor(pump, crash_loop_threshold=3, **FAST_SUP).start()
    try:
        pump.submit(1)                   # non-empty queue => crash fodder
        deadline = time.monotonic() + 5.0
        while sup.healthy and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not sup.healthy, f"never tripped: {sup.stats()}"
        assert sup.restarts > 3
    finally:
        sup.close()
        pump.close(timeout=0.5)


# ---------------------------------------------------------------------------
# circuit breaker state machine (fake clock: fully deterministic)
# ---------------------------------------------------------------------------
def test_breaker_opens_half_opens_and_closes():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                        clock=lambda: now[0])
    br.before(); br.record_failure()
    br.before(); br.record_failure()            # threshold reached
    assert br.state == "open" and br.opened == 1
    with pytest.raises(Unavailable) as ei:
        br.before()                             # still cooling down
    assert 0 < ei.value.retry_after_s <= 1.0
    now[0] = 1.5
    br.before()                                 # cooldown over: probe slot
    assert br.state == "half_open"
    with pytest.raises(Unavailable):
        br.before()                             # one probe at a time
    br.record_success()
    assert br.state == "closed" and br.stats()["streak"] == 0
    assert br.stats()["shed"] == 2


def test_breaker_probe_failure_reopens_and_neutral_releases_slot():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0,
                        clock=lambda: now[0])
    br.before(); br.record_failure()
    assert br.state == "open"
    now[0] = 1.1
    br.before()                                 # probe
    br.record_failure()                         # probe failed: reopen
    assert br.state == "open" and br.opened == 2
    now[0] = 2.3
    br.before()                                 # new probe
    br.record_neutral()                         # backpressure: says nothing
    assert br.state == "half_open"
    br.before()                                 # slot released: probe again
    br.record_success()
    assert br.state == "closed"


def test_breaker_success_resets_streak():
    br = CircuitBreaker(failure_threshold=3)
    for _ in range(2):
        br.before(); br.record_failure()
    br.before(); br.record_success()            # intermittent, not persistent
    br.before(); br.record_failure()
    br.before(); br.record_failure()
    assert br.state == "closed"                 # streak restarted at 0


def test_breaker_bounds_500_tail_on_the_wire():
    eng = ScoreStubEngine()
    orig_forward = eng.forward
    eng.forward = lambda p: (_ for _ in ()).throw(RuntimeError("down"))
    server = GatewayServer(
        {"score": EnginePump(eng, "score")}, supervise=False,
        breaker_config={"failure_threshold": 2, "cooldown_s": 0.2}).start()
    try:
        client = GatewayClient(server.url, timeout_s=5.0, retries=0)
        tail = []
        for _ in range(5):
            with pytest.raises((Failed, Unavailable)) as ei:
                client.score([1, 2], [3, 4], timeout_s=5.0)
            tail.append(ei.type)
        # exactly `threshold` requests paid a 500; the rest shed as 503
        assert tail == [Failed] * 2 + [Unavailable] * 3
        eng.forward = orig_forward
        time.sleep(0.25)                        # cooldown; probe closes it
        assert client.score([1, 2], [3, 4], timeout_s=5.0).shape == (2,)
        assert server.breakers["score"].stats()["state"] == "closed"
        assert eng.executions == 1              # sheds never hit the engine
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# /healthz liveness: a dead pump answers 503
# ---------------------------------------------------------------------------
def _healthz_code(url):
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=5.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_503_when_pump_thread_dead_and_recovers_supervised():
    eng = ScoreStubEngine()
    chaos = ChaosEngine(eng, ScriptedSchedule([("pump_crash", 0)]))
    server = GatewayServer({"score": EnginePump(chaos, "score")},
                           supervise=False).start()
    try:
        code, body = _healthz_code(server.url)
        assert code == 200 and body["status"] == "ok"
        client = GatewayClient(server.url, timeout_s=2.0, retries=0)
        # first request crashes the pump thread; unsupervised => stays dead
        with pytest.raises(Timeout):
            client.score([1], [2], timeout_s=0.3)
        code, body = _healthz_code(server.url)
        assert code == 503 and body["status"] == "unhealthy"
        assert body["engines"]["score"]["running"] is False
        assert body["engines"]["score"]["crashes"] == 1
        # the tolerant client helper reports the same body instead of raising
        assert client.health()["status"] == "unhealthy"
    finally:
        server.stop()

    # same failure under supervision: request served, health stays ok
    eng2 = ScoreStubEngine()
    chaos2 = ChaosEngine(eng2, ScriptedSchedule([("pump_crash", 0)]))
    server2 = GatewayServer({"score": EnginePump(chaos2, "score")},
                            supervisor_config=FAST_SUP).start()
    try:
        client2 = GatewayClient(server2.url, timeout_s=10.0, retries=0)
        assert client2.score([1], [2], timeout_s=10.0).shape == (1,)
        code, body = _healthz_code(server2.url)
        assert code == 200 and body["status"] == "ok"
        assert body["engines"]["score"]["supervisor"]["restarts"] == 1
    finally:
        server2.stop()


# ---------------------------------------------------------------------------
# idempotency dedupe: reset retries must not double-execute
# ---------------------------------------------------------------------------
def test_idempotency_cache_unit():
    cache = IdempotencyCache(maxsize=2)
    role, entry = cache.begin("k1")
    assert role == "primary"
    role2, entry2 = cache.begin("k1")
    assert role2 == "dup" and entry2 is entry and cache.replays == 1
    cache.resolve("k1", entry, 200, {"ok": True}, {})
    assert entry.event.is_set() and entry.response[0] == 200
    # 503 outcomes are dropped: the retry must re-execute
    _, e2 = cache.begin("k2")
    cache.resolve("k2", e2, 503, {"error": "rejected"}, {})
    role3, _ = cache.begin("k2")
    assert role3 == "primary"
    # eviction skips in-flight entries: k1 (resolved) goes, the rest —
    # all still executing — must survive even over the maxsize
    _, e3 = cache.begin("k3")                   # never resolved (in flight)
    cache.begin("k4"); cache.begin("k5")
    assert cache.stats()["entries"] == 4        # k2+k3+k4+k5, k1 evicted
    role_k1, _ = cache.begin("k1")
    assert role_k1 == "primary"                 # evicted: no replay
    role_k3, _ = cache.begin("k3")
    assert role_k3 == "dup"                     # in-flight: still deduped


def test_http_duplicate_key_replays_without_reexecuting():
    eng = ScoreStubEngine()
    server = GatewayServer({"score": EnginePump(eng, "score")},
                           supervise=False, breaker=False).start()
    try:
        data = json.dumps({"hist": [1], "candidates": [2, 3]}).encode()

        def post(key):
            req = urllib.request.Request(
                server.url + "/v1/score", data=data,
                headers={"Content-Type": "application/json",
                         "Idempotency-Key": key})
            with urllib.request.urlopen(req, timeout=5.0) as r:
                return json.loads(r.read())
        first, second = post("same-key"), post("same-key")
        assert first["scores"] == second["scores"] == [0.0, 1.0]
        assert "idempotent_replay" not in first
        assert second["idempotent_replay"] is True
        assert eng.executions == 1              # the whole point
        assert post("other-key")["scores"] == [0.0, 1.0]
        assert eng.executions == 2
    finally:
        server.stop()


def test_post_reset_retry_is_deduped_end_to_end():
    """The double-execution hazard: the server executes, the connection
    dies before the response lands, the client retries — the retry must be
    answered from the dedupe, not executed again."""
    eng = ScoreStubEngine()
    server = GatewayServer({"score": EnginePump(eng, "score")},
                           supervise=False, breaker=False).start()
    try:
        client = ChaosClient(server.url,
                             ScriptedSchedule([("conn_reset", 0)]),
                             reset_mode="post", timeout_s=5.0, retries=2,
                             backoff_s=0.01, backoff_cap_s=0.02)
        scores = client.score([1], [2, 3], timeout_s=5.0)
        assert scores.tolist() == [0.0, 1.0]
        assert client.stats["retries_conn"] == 1
        assert eng.executions == 1              # retried, never re-executed
        assert server.dedupe.stats()["replays"] == 1
    finally:
        server.stop()


def test_pre_reset_retry_reexecutes_safely():
    eng = ScoreStubEngine()
    server = GatewayServer({"score": EnginePump(eng, "score")},
                           supervise=False, breaker=False).start()
    try:
        client = ChaosClient(server.url,
                             ScriptedSchedule([("conn_reset", 0)]),
                             reset_mode="pre", timeout_s=5.0, retries=2,
                             backoff_s=0.01, backoff_cap_s=0.02)
        assert client.score([1], [2], timeout_s=5.0).shape == (1,)
        # the first attempt never reached the server: execute-once via retry
        assert eng.executions == 1
        assert server.dedupe.stats()["replays"] == 0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# client: defensive Retry-After parse
# ---------------------------------------------------------------------------
def test_parse_retry_after_rejects_garbage():
    assert _parse_retry_after("0.25") == 0.25
    assert _parse_retry_after("0") == 0.0
    for bad in (None, "", "never", "nan", "inf", "-1", "1e999"):
        assert _parse_retry_after(bad) is None


def test_client_survives_malformed_retry_after_header():
    srv = scripted_server([
        (503, {"error": "rejected", "detail": "full"},
         {"Retry-After": "soonish"}),
        (200, {"scores": [7.0]}, {}),
    ])
    try:
        client = GatewayClient(f"http://127.0.0.1:{srv.server_address[1]}",
                               retries=2, backoff_s=0.01, backoff_cap_s=0.02)
        assert client.score([1], [2]).tolist() == [7.0]
        assert client.stats["retries_503"] == 1
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# GRASP cache snapshot/restore
# ---------------------------------------------------------------------------
def _small_cache(metrics=None):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 8), np.float32)
    cfg = CacheConfig(budget_bytes=16 * 8 * 4, hot_fraction=0.5, policy="rrpv")
    return EmbeddingCache(table, cfg, metrics=metrics, device="cpu"), table


def _touch(cache, ids):
    rows, stats = cache.lookup(np.asarray(ids, np.int64))
    return rows.numpy(), stats


def test_snapshot_restore_roundtrip_exact_state():
    cache, table = _small_cache()
    _touch(cache, [10, 20, 30, 10, 40, 20])     # populate cold region
    snap = cache.snapshot()
    assert snap["version"] == 1 and snap["checksum"]

    fresh, _ = _small_cache()
    fresh.restore(snap)
    np.testing.assert_array_equal(fresh._slot_id, cache._slot_id)
    np.testing.assert_array_equal(fresh._slot_rrpv, cache._slot_rrpv)
    assert fresh._clock == cache._clock
    # restored rows were warm-filled from the backing table
    rid = int(next(i for i in fresh._slot_id if i >= 0))
    rows, stats = _touch(fresh, [rid])
    assert stats.cold_hits == 1 and stats.misses == 0
    np.testing.assert_allclose(rows[0], table[rid], rtol=1e-6)
    # deterministic replay: the same probe hits identically on both caches
    probe = [10, 20, 55, 30, 60, 40]
    s_orig = _touch(cache, probe)[1]
    twin, _ = _small_cache()
    twin.restore(snap)
    s_twin = _touch(twin, probe)[1]
    assert (s_orig.hot_hits, s_orig.cold_hits, s_orig.misses) == \
        (s_twin.hot_hits, s_twin.cold_hits, s_twin.misses)


def test_snapshot_rejects_corruption_and_mismatch():
    cache, _ = _small_cache()
    _touch(cache, [10, 20])
    snap = cache.snapshot()

    bad = dict(snap, checksum=snap["checksum"] + 1)
    with pytest.raises(SnapshotError, match="checksum"):
        _small_cache()[0].restore(bad)

    tampered = json.loads(json.dumps(snap))
    tampered["state"]["clock"] += 7             # payload edit, stale checksum
    with pytest.raises(SnapshotError, match="checksum"):
        _small_cache()[0].restore(tampered)

    with pytest.raises(SnapshotError, match="version"):
        _small_cache()[0].restore(dict(snap, version=99))

    other = EmbeddingCache(np.zeros((32, 8), np.float32),
                           CacheConfig(budget_bytes=16 * 8 * 4, hot_fraction=0.5),
                           device="cpu")
    with pytest.raises(SnapshotError, match="geometry"):
        other.restore(snap)


def test_snapshot_file_roundtrip_and_missing_file(tmp_path):
    metrics = ServeMetrics()
    cache, _ = _small_cache(metrics=metrics)
    _touch(cache, [10, 20, 30])
    path = str(tmp_path / "cache.json")
    cache.save_snapshot(path)

    fresh, _ = _small_cache(metrics=ServeMetrics())
    assert fresh.load_snapshot(path) is True
    assert fresh.metrics.counters["snapshot_restores"] == 1
    assert fresh.load_snapshot(str(tmp_path / "absent.json")) is False

    with open(path) as f:
        obj = json.load(f)
    obj["state"]["slot_id"] = obj["state"]["slot_id"][::-1]
    with open(path, "w") as f:
        json.dump(obj, f)
    with pytest.raises(SnapshotError):
        _small_cache()[0].load_snapshot(path)


def test_gateway_snapshot_dir_saves_and_restores(tmp_path):
    """The server-level wiring: stop() snapshots, start() warm-restores,
    and a corrupt snapshot means a cold start, never a crash."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((64, 8), np.float32)
    cfg = CacheConfig(budget_bytes=16 * 8 * 4, hot_fraction=0.5)

    class CachedStub(ScoreStubEngine):
        def __init__(self):
            super().__init__()
            self.cache = EmbeddingCache(table, cfg, metrics=self.metrics, device="cpu")

    eng = CachedStub()
    _touch(eng.cache, [10, 20, 30])
    server = GatewayServer({"score": EnginePump(eng, "score")},
                           snapshot_dir=str(tmp_path)).start()
    server.stop()
    path = tmp_path / "score.cache.json"
    assert path.exists()

    eng2 = CachedStub()
    server2 = GatewayServer({"score": EnginePump(eng2, "score")},
                            snapshot_dir=str(tmp_path)).start()
    server2.stop()
    assert eng2.metrics.counters["snapshot_restores"] == 1
    np.testing.assert_array_equal(eng2.cache._slot_id, eng.cache._slot_id)

    with open(path, "w") as f:
        f.write("{not json")
    eng3 = CachedStub()
    server3 = GatewayServer({"score": EnginePump(eng3, "score")},
                            snapshot_dir=str(tmp_path)).start()
    server3.stop()
    assert "snapshot_restores" not in eng3.metrics.counters


# ---------------------------------------------------------------------------
# pump restart semantics under supervision
# ---------------------------------------------------------------------------
def test_restart_supersedes_wedged_generation():
    """A wedged forward cannot be killed, only abandoned: the supervisor
    fails the batch out, a new generation serves, and the unwedged old
    thread's late completion is a no-op."""
    release = threading.Event()
    eng = EchoEngine()
    orig_forward = eng.forward

    def wedge_once(payloads, _done=[]):
        if not _done:
            _done.append(1)
            release.wait(10.0)
        return orig_forward(payloads)

    eng.forward = wedge_once
    pump = EnginePump(eng, "echo").start()
    sup = PumpSupervisor(pump, wedge_timeout_s=0.05, **FAST_SUP).start()
    try:
        with pytest.raises(Failed, match="wedged"):
            pump.call(1, timeout=10.0)          # failed out by the watchdog
        deadline = time.monotonic() + 5.0      # restart follows the fail-out
        while sup.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sup.wedges == 1 and sup.restarts == 1
        assert pump.call(2, timeout=10.0) == 4  # new generation serves
        release.set()                           # old thread unwedges + exits
        time.sleep(0.05)
        assert pump.call(3, timeout=10.0) == 6  # still exactly one pump
        assert eng.metrics.counters["failed"] == 1
    finally:
        release.set()
        sup.close()
        pump.close()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
KINDS = ("forward_error", "latency_spike", "pump_crash", "conn_reset")
RATE_FIELDS = ("forward_error_rate", "latency_spike_rate", "pump_crash_rate", "conn_reset_rate")


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_decisions_match_jax(seed):
    for rate in (0.0, 0.04, 1.0):
        rates = dict.fromkeys(RATE_FIELDS, rate)
        port = FaultSchedule(FaultSpec(seed=seed, **rates))
        ref = j_chaos.FaultSchedule(j_chaos.FaultSpec(seed=seed, **rates))
        for kind in KINDS:
            got = [port.decide(kind, i) for i in range(10_000)]
            assert got == [ref.decide(kind, i) for i in range(10_000)], (rate, kind)
            assert sum(got) == {0.0: 0, 1.0: 10_000}.get(rate, sum(got))
        assert port.log.entries() == ref.log.entries()
        if rate == 0.04:
            assert 0 < port.log.count("pump_crash") < 10_000 * 0.08


# chaos_smoke's determinism schedule: every kind fires within 72 requests
DETERMINISM_SPEC = dict(seed=7, forward_error_rate=0.08, latency_spike_rate=0.05,
                        latency_spike_s=0.005, pump_crash_rate=0.06, conn_reset_rate=0.10)


def _chaos_workload(pkg: str, requests: int = 72):
    """One supervised, breaker-less chaos run of one sequential worker over
    a score stub under ``pkg``'s gateway and chaos layer; returns the
    injection log and each request's outcome."""
    chaos_mod, gw = (j_chaos, j_gw) if pkg == "jax" else (t_chaos, t_gw)
    eng = ScoreStubEngine(pkg=pkg)
    schedule = chaos_mod.FaultSchedule(chaos_mod.FaultSpec(**DETERMINISM_SPEC))
    server = gw.GatewayServer({"score": gw.EnginePump(chaos_mod.ChaosEngine(eng, schedule),
                                                      "score")},
                              supervisor_config=dict(FAST_SUP, wedge_timeout_s=10.0,
                                                     crash_loop_threshold=10_000),
                              breaker=False).start()
    outcomes = []
    try:
        client = chaos_mod.ChaosClient(server.url, schedule, reset_mode="post",
                                       timeout_s=20.0, retries=8, backoff_s=0.002,
                                       backoff_cap_s=0.01)
        rng = np.random.default_rng(3)
        for _ in range(requests):
            hist, cand = rng.integers(0, 100, 4), rng.integers(0, 100, 3)
            try:
                client.score(hist, cand, timeout_s=20.0)
                outcomes.append("done")
            except gw.GatewayError as e:
                outcomes.append(e.kind)
        restarts = server.supervisors["score"].restarts
    finally:
        server.stop()
    return schedule.log.entries(), outcomes, restarts, eng.executions


def test_chaos_workload_replays_identically_across_packages():
    log, outcomes, restarts, executions = _chaos_workload("port")
    want = _chaos_workload("jax")
    assert (log, outcomes, restarts, executions) == want
    kinds = {k for k, _ in log}
    assert kinds == set(KINDS), kinds
    assert restarts == sum(k == "pump_crash" for k, _ in log)
    assert outcomes.count("failed") == sum(k == "forward_error" for k, _ in log)
    assert set(outcomes) == {"done", "failed"}
