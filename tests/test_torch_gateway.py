"""repro_torch.gateway: pump lifecycle, HTTP round-trips, client retry and
backoff (tests/test_gateway.py's, on the port's classes), then the port
against the JAX package's gateway on the CPU.

The pump tests run against stub engines (``torch_gateway_stubs``) so the
concurrency machinery is exercised in isolation; the score round-trip puts
the port's recsys engine behind a loopback socket and checks the served
answers against the dense forward — the cache + pump + HTTP path must move
rows, never values. The cross-package tests send one package's client to
the other's server (bodies and typed errors equal), serve /v1/score from
both gateways over the same MIND weights (1e-5, tests/test_gateway.py's
tolerance; cache counters exactly), warm-restart the port's gateway from a
snapshot the JAX package's gateway wrote on drain, and drive the serve
CLI's ``--gateway`` in a subprocess.
"""
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import gateway as j_gw
from repro.configs import base as j_cfgs
from repro.gateway import breaker as j_breaker
from repro.gateway import client as j_client
from repro.gateway import errors as j_errors
from repro.nn import recsys as j_recsys
from repro.serve import cache as j_cache
from repro.serve import engine as j_engine
from repro.serve import scheduler as j_sched
from repro_torch import convert
from repro_torch.configs import base as cfgs
from repro_torch.gateway import (
    EnginePump,
    Failed,
    GatewayClient,
    GatewayError,
    GatewayServer,
    Rejected,
    Shed,
    Timeout,
)
from repro_torch.gateway import breaker as t_breaker
from repro_torch.gateway import client as t_client
from repro_torch.gateway import errors as t_errors
from repro_torch.nn import recsys as recsys_mod
from repro_torch.serve.cache import CacheConfig
from repro_torch.serve.engine import RecsysServeEngine
from repro_torch.serve.scheduler import SchedulerConfig
from torch_gateway_stubs import (
    EchoEngine,
    GenerateStubEngine,
    ScoreEchoEngine,
    scripted_server,
)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# pump
# ---------------------------------------------------------------------------
def test_pump_concurrent_callers_get_own_results():
    eng = EchoEngine()
    with EnginePump(eng, "echo") as pump:
        results = {}

        def call(i):
            results[i] = pump.call(i, timeout=10.0)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        assert not any(t.is_alive() for t in threads)
        assert results == {i: 2 * i for i in range(16)}
    assert not pump.running
    assert eng.metrics.counters["completed"] == 16


def test_pump_failed_forward_resolves_with_typed_error_and_survives():
    eng = EchoEngine()
    with EnginePump(eng, "echo") as pump:
        eng.boom = True
        with pytest.raises(Failed):
            pump.call(1, timeout=10.0)
        # the pump thread survived the exception and keeps serving
        eng.boom = False
        assert pump.call(2, timeout=10.0) == 4
    assert eng.metrics.counters["failed"] == 1


def test_pump_shed_request_raises_shed():
    eng = EchoEngine()
    pump = EnginePump(eng, "echo")
    req = pump.submit(1, deadline_s=1e-4)   # pump not started yet
    time.sleep(0.01)                        # deadline passes in queue
    pump.start()
    with pytest.raises(Shed):
        pump.result(req, timeout=10.0)
    assert req.done.is_set() and req.status == "shed"
    pump.close()


def test_pump_result_timeout():
    eng = EchoEngine()
    pump = EnginePump(eng, "echo")          # never started: nothing drains
    req = pump.submit(1)
    with pytest.raises(Timeout):
        pump.result(req, timeout=0.05)
    pump.close(timeout=1.0)
    # close() failed the stranded request out instead of leaving it queued
    assert req.status == "failed" and req.done.is_set()


def test_pump_drain_closes_admissions_and_finishes_inflight():
    eng = EchoEngine(delay_s=0.01)
    pump = EnginePump(eng, "echo").start()
    reqs = [pump.submit(i) for i in range(8)]
    assert pump.drain(timeout=30.0)
    assert all(r.status == "done" for r in reqs)
    with pytest.raises(Rejected):
        pump.submit(99)
    pump.close()


def test_pump_rejects_when_queue_full():
    eng = EchoEngine(sched=SchedulerConfig(max_batch=2, max_queue=3))
    pump = EnginePump(eng, "echo")          # not started: queue only fills
    for i in range(3):
        pump.submit(i)
    with pytest.raises(Rejected):
        pump.submit(3)
    assert eng.metrics.counters["rejected"] == 1
    pump.close(timeout=1.0)


# ---------------------------------------------------------------------------
# HTTP server round-trips (loopback sockets)
# ---------------------------------------------------------------------------
def test_server_score_roundtrip_matches_dense_reference():
    cfg = cfgs.reduced(cfgs.get_arch("mind"))
    params = recsys_mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = RecsysServeEngine(
        params, cfg, CacheConfig(budget_bytes=64 * cfg.embed_dim * 4),
        SchedulerConfig(max_batch=4, max_queue=16), device="cpu")
    eng.warmup(candidates=8)
    rng = np.random.default_rng(0)
    hist = rng.integers(0, cfg.n_items, cfg.hist_len)
    cand = rng.integers(0, cfg.n_items, 8)

    with GatewayServer({"score": EnginePump(eng, "score")}) as server:
        client = GatewayClient(server.url, timeout_s=30.0)
        assert client.health()["status"] == "ok"
        scores = client.score(hist.tolist(), cand.tolist(), timeout_s=30.0)
        snap = client.metrics()["score"]
        # malformed requests answer 400 without entering the pump
        with pytest.raises(GatewayError, match="ids must be in"):
            client._request("/v1/score", {"hist": [int(cfg.n_items)],
                                          "candidates": [0]})
        with pytest.raises(GatewayError):
            client._request("/v1/nope", {})

    ref = recsys_mod.serve_scores(params, cfg, {
        "hist": hist[None].astype(np.int32),
        "hist_mask": np.ones((1, cfg.hist_len), bool),
        "candidates": cand[None].astype(np.int32),
    }).numpy()[0]
    np.testing.assert_allclose(scores, ref, rtol=1e-5, atol=1e-5)
    assert snap["counters"]["completed"] == 1
    assert 0.0 < snap["hit_rate"] <= 1.0


def test_server_generate_roundtrip_deterministic():
    # a deterministic stub exercises the route alone; the same test over the
    # port's LMServeEngine is in test_torch_lm_serve.py
    eng = GenerateStubEngine(sched=SchedulerConfig(max_batch=2, max_queue=8), decode=4)
    prompt = [1, 2, 3, 4, 5]
    with GatewayServer({"generate": EnginePump(eng, "generate")}) as server:
        client = GatewayClient(server.url, timeout_s=60.0)
        out1 = client.generate(prompt, timeout_s=60.0)
        out2 = client.generate(prompt, timeout_s=60.0)
    assert len(out1) == 4 and out1 == out2          # greedy => deterministic
    assert eng.metrics.counters["tokens_generated"] == 8
    ref = eng.forward([{"tokens": np.asarray(prompt)}])[0]
    assert out1 == ref.tolist()


def test_server_drain_rejects_new_work():
    eng = EchoEngine()
    server = GatewayServer({"score": EnginePump(eng, "echo")}).start()
    url = server.url
    client = GatewayClient(url, timeout_s=5.0, retries=0)
    server.stop()
    # after stop the listener is gone: the client surfaces a typed/transport
    # error instead of hanging
    with pytest.raises(Exception):
        client._request("/v1/score", {"hist": [0], "candidates": [0]})


# ---------------------------------------------------------------------------
# client retry behaviour against a scripted stub server
# ---------------------------------------------------------------------------
def test_client_retries_transient_503_then_recovers():
    srv = scripted_server([
        (503, {"error": "rejected", "detail": "full"}, {"Retry-After": "0.01"}),
        (503, {"error": "shed", "detail": "late"}, {"Retry-After": "0.01"}),
        (200, {"scores": [3.5]}, {}),
    ])
    try:
        client = GatewayClient(f"http://127.0.0.1:{srv.server_address[1]}",
                               retries=4, backoff_s=0.01, backoff_cap_s=0.05)
        scores = client.score([1], [2])
        assert scores.tolist() == [3.5]
        assert client.stats["retries_503"] == 2
        assert client.stats["recovered"] == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_raises_typed_errors_without_retrying_non_503():
    srv = scripted_server([
        (504, {"error": "timeout", "detail": "budget"}, {}),
        (500, {"error": "failed", "detail": "boom"}, {}),
        (503, {"error": "rejected", "detail": "full"}, {}),
        (503, {"error": "rejected", "detail": "full"}, {}),
    ])
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        client = GatewayClient(url, retries=1, backoff_s=0.01,
                               backoff_cap_s=0.02)
        with pytest.raises(Timeout):
            client.score([1], [2])
        with pytest.raises(Failed):
            client.score([1], [2])
        # retries exhausted on persistent 503 -> typed Rejected, not a hang
        with pytest.raises(Rejected):
            client.score([1], [2])
        assert client.stats["retries_503"] == 1
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
STATUSES = ("rejected", "shed", "unavailable", "timeout", "failed", "error", "done",
            "queued", "bad_request", "")


@pytest.mark.parametrize("status", STATUSES)
def test_error_for_status_matches_jax(status):
    for retry in (None, 0.25):
        got = t_errors.error_for_status(status, "why", retry_after_s=retry)
        want = j_errors.error_for_status(status, "why", retry_after_s=retry)
        assert (type(got).__name__, got.kind, got.http_status, str(got), got.retry_after_s) \
            == (type(want).__name__, want.kind, want.http_status, str(want), want.retry_after_s)
        assert isinstance(got, t_errors.GatewayError)
    blank = t_errors.error_for_status(status)
    assert str(blank) == str(j_errors.error_for_status(status))


def test_parse_retry_after_matches_jax():
    cases = ("0.25", "0", "3", "1e-3", None, "", "never", "nan", "inf", "-1", "1e999",
             " 0.5 ", "0x10")
    for value in cases:
        assert t_client._parse_retry_after(value) == j_client._parse_retry_after(value), value


def test_breaker_stats_match_jax_under_scripted_sequence():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    port = t_breaker.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, half_open_probes=1,
                                    clock=clock)
    ref = j_breaker.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, half_open_probes=1,
                                   clock=clock)
    script = ["before", "failure", "before", "success", "before", "failure", "before",
              "failure", "before", ("t", 0.5), "before", ("t", 1.2), "before", "before",
              "neutral", "before", "failure", ("t", 2.0), "before", ("t", 2.3), "before",
              "success", "before", "failure", "neutral", "before", "failure", "before",
              ("t", 3.4), "before", "before", "success", "success", "before", "neutral"]
    for step in script:
        outcomes = []
        for br, err in ((port, t_errors.Unavailable), (ref, j_errors.Unavailable)):
            if isinstance(step, tuple):
                now[0] = step[1]
                outcomes.append(None)
            elif step == "before":
                try:
                    br.before()
                    outcomes.append("pass")
                except err as e:
                    outcomes.append(("shed", str(e), e.retry_after_s))
            else:
                getattr(br, f"record_{step}")()
                outcomes.append(None)
        assert outcomes[0] == outcomes[1], step
        assert port.stats() == ref.stats(), step
    assert port.stats()["opened"] >= 3 and port.stats()["shed"] >= 3


PKGS = {"port": (t_client.GatewayClient, GatewayServer, EnginePump),
        "jax": (j_client.GatewayClient, j_gw.GatewayServer, j_gw.EnginePump)}


def _wire_exchange(client_pkg: str, server_pkg: str) -> list:
    """One scripted session of ``client_pkg``'s client against
    ``server_pkg``'s server over an echo engine: two scores, the typed
    errors of 400, 404, 500 and 503 (a draining gateway and an open
    breaker on a fixed clock, each with Retry-After), /healthz and
    /metrics. Returns what the client saw, package names left out."""
    client_cls, server_cls, pump_cls = PKGS[client_pkg][0], *PKGS[server_pkg][1:]
    eng = ScoreEchoEngine(pkg=server_pkg)
    server = server_cls({"score": pump_cls(eng, "score")}, supervise=False,
                        breaker_config={"failure_threshold": 2, "cooldown_s": 5.0,
                                        "clock": lambda: 0.0}).start()
    seen = []

    def typed(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 — the record is the point
            return (type(e).__name__, getattr(e, "kind", None), getattr(e, "http_status", None),
                    str(e), getattr(e, "retry_after_s", None))

    try:
        client = client_cls(server.url, timeout_s=10.0, retries=0)
        seen.append(client.score([1, 2, 3], [4, 5, 96], timeout_s=10.0).tolist())
        seen.append(client._request("/v1/score", {"hist": [7, 8, 9, 10, 11], "candidates": [0],
                                                  "hist_mask": [True, False, True, True]}))
        seen.append(typed(lambda: client._request("/v1/score", {"hist": [100],
                                                                "candidates": [0]})))
        seen.append(typed(lambda: client._request("/v1/score", {"hist": [1]})))
        seen.append(typed(lambda: client._request("/v1/nope", {})))
        health = client.health()
        seen.append((health["status"], sorted(health), sorted(health["engines"]["score"])))
        metrics = client.metrics()
        seen.append((sorted(metrics), sorted(metrics["score"]), sorted(metrics["_gateway"]),
                     metrics["score"]["counters"]))
        eng.boom = True
        seen.append(typed(lambda: client.score([1], [2], timeout_s=10.0)))
        seen.append(typed(lambda: client.score([1], [2], timeout_s=10.0)))
        seen.append(typed(lambda: client.score([1], [2], timeout_s=10.0)))   # open: 503
        eng.boom = False
        server._draining = True
        seen.append(typed(lambda: client.score([1], [2], timeout_s=10.0)))   # draining: 503
        seen.append(client.health()["status"])
    finally:
        server.stop()
    return seen


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_wire_matches_across_packages(client_pkg, server_pkg):
    got = _wire_exchange(client_pkg, server_pkg)
    want = _wire_exchange("jax", "jax")
    assert got == want
    assert got == _wire_exchange("port", "port")
    kinds = [s[:3] for s in got if isinstance(s, tuple) and len(s) == 5]
    assert ("GatewayError", "error", 500) in kinds                 # 400 and 404 bodies
    assert ("Failed", "failed", 500) in kinds
    assert ("Unavailable", "unavailable", 503) in kinds
    assert ("Rejected", "rejected", 503) in kinds
    assert [s[4] for s in got if isinstance(s, tuple) and s[:1] == ("Unavailable",)] == [5.0]
    assert [s[4] for s in got if isinstance(s, tuple) and s[:1] == ("Rejected",)] == [0.05]


def mind_pair():
    """Reduced MIND from the JAX init, the port's params converted from it."""
    cfg_j = j_cfgs.reduced(j_cfgs.get_arch("mind"))
    jp = j_recsys.init(jax.random.PRNGKey(0), cfg_j)
    tp = convert.mind_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg_j, jp, cfgs.reduced(cfgs.get_arch("mind")), tp


def mind_engines(budget_rows=64):
    cfg_j, jp, cfg_t, tp = mind_pair()
    budget = budget_rows * cfg_t.embed_dim * 4
    je = j_engine.RecsysServeEngine(jp, cfg_j, j_cache.CacheConfig(budget_bytes=budget,
                                                                   tile_e=128),
                                    j_sched.SchedulerConfig(max_batch=4))
    te = RecsysServeEngine(tp, cfg_t, CacheConfig(budget_bytes=budget),
                           SchedulerConfig(max_batch=4), device="cpu")
    return je, te, cfg_t, tp


def zipf_requests(cfg, n, seed):
    from repro_torch.data.pipeline import zipf_ids

    rng = np.random.default_rng(seed)
    return [(zipf_ids(rng, (cfg.hist_len,), cfg.n_items, a=1.1),
             zipf_ids(rng, (16,), cfg.n_items, a=1.1)) for _ in range(n)]


def test_score_through_both_gateways_matches():
    je, te, cfg, tp = mind_engines()
    je.warmup(candidates=16)
    te.warmup(candidates=16)
    reqs = zipf_requests(cfg, 32, seed=5)
    served = {}
    for name, server in (("jax", j_gw.GatewayServer({"score": j_gw.EnginePump(je, "score")})),
                         ("port", GatewayServer({"score": EnginePump(te, "score")}))):
        with server:
            client = GatewayClient(server.url, timeout_s=30.0)
            served[name] = np.stack([client.score(h, c, timeout_s=30.0) for h, c in reqs])
    np.testing.assert_allclose(served["port"], served["jax"], rtol=1e-5, atol=1e-5)
    dense = recsys_mod.serve_scores(tp, cfg, {
        "hist": np.stack([h for h, _ in reqs]).astype(np.int32),
        "hist_mask": np.ones((len(reqs), cfg.hist_len), bool),
        "candidates": np.stack([c for _, c in reqs]).astype(np.int32)}).numpy()
    np.testing.assert_allclose(served["port"], dense, rtol=1e-5, atol=1e-5)
    keys = ("completed", "hot_hits", "cold_hits", "misses", "batches")
    got = {k: te.metrics.counters.get(k, 0) for k in keys}
    assert got == {k: je.metrics.counters.get(k, 0) for k in keys}
    assert got["completed"] == got["batches"] == 32 and got["misses"] > 0


def test_jax_snapshot_warm_restarts_port_gateway(tmp_path):
    je, te, cfg, _ = mind_engines()
    je.warmup(candidates=16)
    with j_gw.GatewayServer({"score": j_gw.EnginePump(je, "score")},
                            snapshot_dir=str(tmp_path)) as server:
        client = GatewayClient(server.url, timeout_s=30.0)
        for h, c in zipf_requests(cfg, 12, seed=6):
            client.score(h, c, timeout_s=30.0)
    assert (tmp_path / "score.cache.json").exists()       # written on drain
    server = GatewayServer({"score": EnginePump(te, "score")}, snapshot_dir=str(tmp_path))
    server.start()
    try:
        assert te.metrics.counters["snapshot_restores"] == 1
        assert te.cache.snapshot() == je.cache.snapshot()
        for attr in ("_slot_id", "_slot_rrpv", "_slot_ts", "_id_slot"):
            np.testing.assert_array_equal(getattr(te.cache, attr), getattr(je.cache, attr))
        assert torch.equal(te.cache.cold_rows_device(),
                           torch.tensor(np.asarray(je.cache.cold_rows_device())))
        # the restored cache serves on as the JAX cache does from its state
        keys = ("hot_hits", "cold_hits", "misses")
        before = {k: je.metrics.counters.get(k, 0) for k in keys}
        h, c = zipf_requests(cfg, 1, seed=7)[0]
        got = GatewayClient(server.url, timeout_s=30.0).score(h, c, timeout_s=30.0)
        want = je.forward([{"hist": h.astype(np.int32), "hist_mask": np.ones(cfg.hist_len, bool),
                            "candidates": c.astype(np.int32)}])[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert {k: te.metrics.counters.get(k, 0) for k in keys} == {
            k: je.metrics.counters.get(k, 0) - before[k] for k in keys}
        assert te.cache.snapshot() == je.cache.snapshot()
    finally:
        server.stop()


def test_serve_cli_gateway_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine", "recsys",
         "--gateway", "127.0.0.1:0", "--device", "cpu", "--snapshot-dir", str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        deadline = time.monotonic() + 120.0
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"\[gateway\] .* on (http://\S+) ", line)
            url = m.group(1) if m else None
        assert url, "".join(lines)
        assert "(cold start)" in lines[-1] and "cpu" in lines[-1]
        scores = GatewayClient(url, timeout_s=30.0).score([1, 2, 3], [4, 5], timeout_s=30.0)
        assert scores.shape == (2,) and np.isfinite(scores).all()
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10.0)
    assert proc.returncode == 0, "".join(lines) + out
    assert "[gateway] stopped: completed=1" in out
    assert (tmp_path / "score.cache.json").exists()
