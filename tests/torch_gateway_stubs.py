"""Stub engines and a scripted HTTP server for the gateway and chaos tests.

The engines present the serve engines' surface (``.batcher``,
``.metrics``, ``.forward``) without a model, so the pump, supervisor,
breaker, server and client run in isolation. Each is built on one
package's ``serve.{metrics,scheduler}``: ``pkg="port"`` (repro_torch, the
default) or ``pkg="jax"`` (the JAX package), so the cross-package tests
run the same stub under either package's gateway.
"""
import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro.serve import metrics as j_metrics
from repro.serve import scheduler as j_scheduler
from repro_torch.serve import metrics as t_metrics
from repro_torch.serve import scheduler as t_scheduler

SERVE = {"port": (t_metrics, t_scheduler), "jax": (j_metrics, j_scheduler)}


def _batcher(pkg, sched, default):
    metrics, scheduler = SERVE[pkg]
    m = metrics.ServeMetrics()
    return m, scheduler.ContinuousBatcher(sched or scheduler.SchedulerConfig(**default),
                                          metrics=m)


class EchoEngine:
    """Doubles integer payloads."""

    def __init__(self, sched=None, delay_s=0.0, pkg="port"):
        self.metrics, self.batcher = _batcher(pkg, sched, dict(max_batch=4, max_queue=8))
        self.delay_s = delay_s
        self.boom = False

    def forward(self, payloads):
        if self.boom:
            raise RuntimeError("boom")
        if self.delay_s:
            time.sleep(self.delay_s)
        return [p * 2 for p in payloads]


class ScoreStubEngine:
    """Satisfies the /v1/score route's surface (``cfg.n_items``,
    ``cfg.hist_len``) and counts forward executions (the double-execution
    detector). Scores are ``0, 1, ..., C-1``."""

    def __init__(self, sched=None, pkg="port"):
        self.metrics, self.batcher = _batcher(pkg, sched, dict(max_batch=4, max_queue=16))
        self.cfg = types.SimpleNamespace(n_items=100, hist_len=4)
        self.executions = 0

    def forward(self, payloads):
        self.executions += len(payloads)
        return [np.arange(len(p["candidates"]), dtype=np.float32) for p in payloads]


class ScoreEchoEngine(ScoreStubEngine):
    """Scores that carry every bit of a float32 through the wire: each
    candidate over 7 plus the sum of the (masked) history; raises while
    ``boom`` is set."""

    def __init__(self, sched=None, pkg="port"):
        super().__init__(sched, pkg)
        self.boom = False

    def forward(self, payloads):
        if self.boom:
            raise RuntimeError("boom")
        self.executions += len(payloads)
        return [(p["candidates"] / np.float32(7)
                 + np.float32(p["hist"][p["hist_mask"]].sum())).astype(np.float32)
                for p in payloads]


class GenerateStubEngine:
    """A deterministic stand-in for the LM engine behind /v1/generate: the
    continuation of a prompt is ``decode`` ids, each the sum of the last
    three ids mod 97 (greedy decoding is deterministic too)."""

    def __init__(self, sched=None, decode=4, pkg="port"):
        self.metrics, self.batcher = _batcher(pkg, sched, dict(max_batch=2, max_queue=8))
        self.decode = decode

    def forward(self, payloads):
        out = []
        for p in payloads:
            seq = [int(t) for t in p["tokens"]]
            for _ in range(self.decode):
                seq.append(sum(seq[-3:]) % 97)
            out.append(np.asarray(seq[-self.decode:], np.int32))
        self.metrics.count("tokens_generated", self.decode * len(payloads))
        return out


class _ScriptedHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        code, body, headers = (self.server.script.pop(0) if self.server.script
                               else (200, {"scores": [1.0]}, {}))
        payload = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)


def scripted_server(script):
    """A loopback server answering POSTs with ``(code, body, headers)`` from
    ``script`` in order, then 200s. Callers ``shutdown()`` and
    ``server_close()`` it."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _ScriptedHandler)
    srv.daemon_threads = True
    srv.script = list(script)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
