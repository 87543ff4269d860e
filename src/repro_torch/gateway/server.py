"""JSON-RPC serving front-end over ``http.server.ThreadingHTTPServer``.

Stdlib-only by design (no web framework to depend on): one daemon
thread per connection, each handler thread submits into the shared
``EnginePump`` and blocks on its own request's completion event. The
pump's scheduler is the single point of truth for admission control —
the server merely translates its outcomes onto the wire:

  ``POST /v1/generate``  LM prefill+decode   {"tokens": [...]} -> {"tokens": [[...], ...]}
  ``POST /v1/score``     recsys scoring      {"hist": [...], "candidates": [...]} -> {"scores": [...]}
  ``GET  /healthz``      readiness: 200 ok / 503 degraded-draining-unhealthy
  ``GET  /metrics``      per-engine ``ServeMetrics.snapshot()`` + gateway internals

Error mapping (see ``gateway.errors``): admission-control rejects,
deadline sheds, and open circuit breakers answer **503** with a
``Retry-After`` hint — the backpressure signal the client's bounded
exponential backoff keys on; caller-budget expiry answers 504; an engine
fault answers 500. Request bodies may carry ``deadline_ms`` (queue
deadline, defaults to the scheduler's) and ``timeout_s`` (caller wait
budget).

Resilience layers on the request path (each defaults on, each optional):

- **supervision** — a ``PumpSupervisor`` per pump restarts dead/wedged
  pump threads with backoff; ``/healthz`` answers 503 while any pump
  thread is dead or crash-looping (previously a dead pump kept reporting
  healthy while every request timed out);
- **circuit breaker** — per route: ``failure_threshold`` consecutive
  engine 500s open it, requests then shed immediately with 503 +
  Retry-After (= remaining cooldown), a half-open probe closes it on the
  first success;
- **idempotency dedupe** — POSTs carrying an ``Idempotency-Key`` header
  are deduplicated through a bounded LRU: a retry of an already-executed
  request replays the recorded outcome (marked ``"idempotent_replay"``)
  instead of double-executing; a retry racing the original blocks on its
  completion. Retryable outcomes (503) are not pinned — a later retry
  re-executes against hopefully-better conditions;
- **warm-restart snapshots** — with ``snapshot_dir`` set, ``stop()``
  saves each engine's GRASP cache state (``serve.cache.snapshot()``) and
  ``start()`` restores it, so a restarted gateway recovers its pre-crash
  hit rate instead of re-paying cold-start misses. A corrupt/mismatched
  snapshot is discarded (cold start), never trusted.

``stop()`` is the graceful-drain protocol: mark draining (new requests are
rejected with 503), stop the supervisors (shutdown is not a crash), then
``close()`` every pump (stop admissions, finish in-flight batches, join
the pump thread), snapshot the caches, and shut the listener down.
"""
from __future__ import annotations

import collections
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.gateway.breaker import CircuitBreaker
from repro_torch.gateway.errors import Failed, GatewayError, Rejected, Unavailable
from repro_torch.gateway.pump import EnginePump
from repro_torch.gateway.supervisor import PumpSupervisor


class _BadRequest(Exception):
    """Malformed request body — answered with 400, never enters the pump."""


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5 — an open-loop arrival
    # burst would see connection resets before admission control ever runs
    request_queue_size = 1024
    gateway: "GatewayServer"


class _IdemEntry:
    """One in-flight or completed idempotent request."""

    __slots__ = ("event", "response")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.response: Optional[Tuple[int, Dict, Dict]] = None


class IdempotencyCache:
    """Bounded LRU of idempotency-keyed outcomes.

    ``begin`` either registers the caller as the *primary* executor for a
    key or hands back the existing entry (a duplicate: the same logical
    request re-sent after a connection reset). Duplicates wait on the
    primary's completion event and replay its recorded ``(code, body,
    headers)``. Outcomes the client is expected to retry (503) are
    dropped after resolution — pinning a shed under its key would turn
    every retry into a replay of the shed forever.
    """

    def __init__(self, maxsize: int = 512) -> None:
        self.maxsize = int(maxsize)
        self._entries: "collections.OrderedDict[str, _IdemEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.replays = 0             # duplicate requests served from cache

    def begin(self, key: str) -> Tuple[str, _IdemEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.replays += 1
                return "dup", entry
            entry = _IdemEntry()
            self._entries[key] = entry
            while len(self._entries) > self.maxsize:
                # evict the oldest *completed* entry; in-flight entries are
                # skipped (their primaries still need to resolve them)
                for k, e in self._entries.items():
                    if e.event.is_set():
                        del self._entries[k]
                        break
                else:
                    break
            return "primary", entry

    def resolve(self, key: str, entry: _IdemEntry,
                code: int, body: Dict, headers: Dict) -> None:
        entry.response = (code, body, headers)
        entry.event.set()
        if code == 503:              # retryable: the retry must re-execute
            with self._lock:
                if self._entries.get(key) is entry:
                    del self._entries[key]

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._entries), "replays": self.replays}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _HTTPServer

    def log_message(self, fmt, *args):  # quiet: metrics cover observability
        pass

    def _send_json(self, code: int, obj: Dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        gw = self.server.gateway
        if self.path == "/healthz":
            health = gw.health()
            self._send_json(200 if health["status"] == "ok" else 503, health)
        elif self.path == "/metrics":
            self._send_json(200, gw.metrics())
        else:
            self._send_json(404, {"error": "not_found", "detail": self.path})

    def _execute(self, gw: "GatewayServer", route) -> Tuple[int, Dict, Dict]:
        """Run one route; every outcome becomes a (code, body, headers)
        triple so it can be both sent and recorded for idempotent replay."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
            obj = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(obj, dict):
                raise _BadRequest("body must be a JSON object")
            return 200, route(obj), {}
        except _BadRequest as e:
            return 400, {"error": "bad_request", "detail": str(e)}, {}
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            return 400, {"error": "bad_request", "detail": str(e)}, {}
        except GatewayError as e:
            headers = {}
            if e.http_status == 503:
                headers["Retry-After"] = \
                    f"{e.retry_after_s or gw.retry_after_s:.3f}"
            return e.http_status, {"error": e.kind, "detail": str(e)}, headers
        except Exception as e:  # noqa: BLE001 — surface bugs as 500s
            return 500, {"error": "error", "detail": repr(e)}, {}

    def do_POST(self) -> None:
        gw = self.server.gateway
        route = gw.routes.get(self.path)
        if route is None:
            self._send_json(404, {"error": "not_found", "detail": self.path})
            return
        key = self.headers.get("Idempotency-Key")
        entry = None
        if key and gw.dedupe is not None:
            role, entry = gw.dedupe.begin(key)
            if role == "dup":
                # the original may still be executing: wait for its outcome
                if not entry.event.wait(gw.request_timeout_s + 5.0):
                    self._send_json(504, {"error": "timeout",
                                          "detail": "idempotent replay "
                                                    "timed out"})
                    return
                code, body, headers = entry.response
                self._send_json(code, dict(body, idempotent_replay=True),
                                headers)
                return
        code, body, headers = self._execute(gw, route)
        if entry is not None:
            gw.dedupe.resolve(key, entry, code, body, headers)
        self._send_json(code, body, headers)


class GatewayServer:
    """HTTP front-end over named engine pumps.

    ``pumps`` maps route names to pumps: ``"generate"`` mounts
    ``/v1/generate`` (an engine whose forward maps ``{"tokens": ...}``
    payloads to token ids; the LM engine joins with its slice of the
    port), ``"score"`` mounts ``/v1/score`` (a ``RecsysServeEngine``). ``port=0`` binds an ephemeral
    port — read it back from ``.address``/``.url`` (loopback tests).

    ``supervise``/``breaker``/``dedupe_size``/``snapshot_dir`` switch the
    resilience layers described in the module docstring;
    ``supervisor_config``/``breaker_config`` are kwargs forwarded to
    ``PumpSupervisor``/``CircuitBreaker``.
    """

    def __init__(
        self,
        pumps: Dict[str, EnginePump],
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        retry_after_s: float = 0.05,
        supervise: bool = True,
        supervisor_config: Optional[Dict] = None,
        breaker: bool = True,
        breaker_config: Optional[Dict] = None,
        dedupe_size: int = 512,
        snapshot_dir: Optional[str] = None,
    ) -> None:
        self.pumps = dict(pumps)
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(retry_after_s)
        self.snapshot_dir = snapshot_dir
        self.routes = {}
        if "generate" in self.pumps:
            self.routes["/v1/generate"] = self._generate
        if "score" in self.pumps:
            self.routes["/v1/score"] = self._score
        self.supervisors: Dict[str, PumpSupervisor] = {}
        if supervise:
            self.supervisors = {
                name: PumpSupervisor(pump, **(supervisor_config or {}))
                for name, pump in self.pumps.items()}
        self.breakers: Dict[str, CircuitBreaker] = {}
        if breaker:
            self.breakers = {name: CircuitBreaker(**(breaker_config or {}))
                             for name in self.pumps}
        self.dedupe = IdempotencyCache(dedupe_size) if dedupe_size else None
        self._draining = False
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.gateway = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-http", daemon=True)

    # -- lifecycle -------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def _snapshot_path(self, name: str) -> Optional[str]:
        if self.snapshot_dir is None:
            return None
        return os.path.join(self.snapshot_dir, f"{name}.cache.json")

    def _restore_snapshots(self) -> None:
        """Warm-start every engine that exposes a GRASP cache; a missing
        file is a silent cold start, a corrupt/mismatched one is discarded
        with the cold start noted in the engine's metrics."""
        from repro_torch.serve.cache import SnapshotError

        for name, pump in self.pumps.items():
            path = self._snapshot_path(name)
            cache = getattr(pump.engine, "cache", None)
            if path is None or cache is None:
                continue
            try:
                cache.load_snapshot(path)
            except SnapshotError:
                pump.engine.metrics.count("snapshot_rejected")

    def _save_snapshots(self) -> None:
        for name, pump in self.pumps.items():
            path = self._snapshot_path(name)
            cache = getattr(pump.engine, "cache", None)
            if path is None or cache is None:
                continue
            os.makedirs(self.snapshot_dir, exist_ok=True)
            cache.save_snapshot(path)

    def start(self) -> "GatewayServer":
        self._restore_snapshots()
        for pump in self.pumps.values():
            pump.start()
        for sup in self.supervisors.values():
            sup.start()
        self._thread.start()
        return self

    def stop(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain: reject new work, finish in-flight, snapshot the
        caches, shut down."""
        self._draining = True
        for sup in self.supervisors.values():
            sup.close()              # stand down first: shutdown != crash
        for pump in self.pumps.values():
            pump.close(drain_timeout_s)
        self._save_snapshots()
        if self._thread.ident is not None:   # shutdown() blocks forever if
            self._httpd.shutdown()           # serve_forever never started
            self._thread.join(5.0)
        self._httpd.server_close()

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection ---------------------------------------------------
    def health(self) -> Dict:
        """Readiness view: ``status == "ok"`` iff every started pump thread
        is alive and no supervisor is in a crash loop. The /healthz route
        maps any other status to HTTP 503."""
        engines = {}
        ready = True
        for name, pump in self.pumps.items():
            sup = self.supervisors.get(name)
            alive = pump.running
            dead = pump.started and not alive and not pump.draining
            crash_looping = sup is not None and not sup.healthy
            if dead or crash_looping:
                ready = False
            engines[name] = {
                "depth": pump.engine.batcher.depth,
                "draining": pump.draining,
                "running": alive,
                "alive": alive,
                "generation": pump.generation,
                "crashes": pump.crashes,
                "supervisor": sup.stats() if sup is not None else None,
            }
        status = ("draining" if self._draining
                  else "ok" if ready else "unhealthy")
        return {
            "status": status,
            "ready": status == "ok",
            "engines": engines,
            "breakers": {n: b.stats() for n, b in self.breakers.items()},
        }

    def metrics(self) -> Dict:
        out = {name: pump.engine.metrics.snapshot()
               for name, pump in self.pumps.items()}
        out["_gateway"] = {
            "dedupe": self.dedupe.stats() if self.dedupe else None,
            "breakers": {n: b.stats() for n, b in self.breakers.items()},
            "supervisors": {n: s.stats() for n, s in self.supervisors.items()},
        }
        return out

    # -- routes ----------------------------------------------------------
    def _budgets(self, obj: Dict) -> Tuple[Optional[float], float]:
        deadline_ms = obj.get("deadline_ms")
        deadline_s = None if deadline_ms is None else float(deadline_ms) / 1e3
        return deadline_s, float(obj.get("timeout_s", self.request_timeout_s))

    def _call(self, name: str, payload: Dict, obj: Dict):
        if self._draining:
            raise Rejected("gateway draining")
        pump = self.pumps[name]
        sup = self.supervisors.get(name)
        if sup is not None and not sup.healthy:
            raise Unavailable(f"{name}: pump crash-looping, shedding")
        deadline_s, timeout_s = self._budgets(obj)
        br = self.breakers.get(name)
        if br is not None:
            br.before()
        try:
            out = pump.call(payload, deadline_s=deadline_s, timeout=timeout_s)
        except Failed:
            if br is not None:
                br.record_failure()
            raise
        except GatewayError:             # backpressure/timeout: the scheduler
            if br is not None:           # doing its job, not an engine fault
                br.record_neutral()
            raise
        except Exception:
            if br is not None:
                br.record_failure()
            raise
        if br is not None:
            br.record_success()
        return out

    def _score(self, obj: Dict) -> Dict:
        cfg = self.pumps["score"].engine.cfg
        hist = np.asarray(obj.get("hist", []), dtype=np.int64).ravel()
        cand = np.asarray(obj.get("candidates", []), dtype=np.int64).ravel()
        if hist.size == 0 or cand.size == 0:
            raise _BadRequest("'hist' and 'candidates' are required")
        for name, ids in (("hist", hist), ("candidates", cand)):
            if ids.min() < 0 or ids.max() >= cfg.n_items:
                raise _BadRequest(
                    f"'{name}' ids must be in [0, {cfg.n_items})")
        h = hist[-cfg.hist_len:]
        full = np.zeros(cfg.hist_len, np.int32)
        mask = np.zeros(cfg.hist_len, bool)
        full[: h.size] = h
        mask[: h.size] = True
        if "hist_mask" in obj:
            m = np.asarray(obj["hist_mask"], dtype=bool).ravel()[-cfg.hist_len:]
            mask[: m.size] &= m[: m.size]
        payload = {"hist": full, "hist_mask": mask,
                   "candidates": cand.astype(np.int32)}
        scores = self._call("score", payload, obj)
        return {"scores": np.asarray(scores, np.float64).tolist()}

    def _generate(self, obj: Dict) -> Dict:
        toks = obj.get("tokens")
        if not toks or not isinstance(toks, list):
            raise _BadRequest("'tokens' must be a non-empty list of ids")
        payload = {"tokens": np.asarray(toks, np.int32)}
        out = self._call("generate", payload, obj)
        return {"tokens": np.asarray(out, np.int64).tolist()}
