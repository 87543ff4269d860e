"""urllib-based gateway client: typed errors, per-request timeouts, and
bounded exponential-backoff retries on 503.

503 is the gateway's backpressure signal (admission-control reject,
deadline shed, or an open circuit breaker — all transient by
construction: load moves, deadlines reset on re-entry, breakers cool
down), so the client absorbs up to ``retries`` of them with
``backoff_s * factor**attempt`` sleeps capped at ``backoff_cap_s``, then
raises the typed error from the *last* response (``Rejected``, ``Shed``
or ``Unavailable`` from ``gateway.errors``). 504 and socket-level
timeouts raise ``Timeout`` immediately; 500 raises ``Failed`` immediately
— retrying a crashed batch only re-crashes it. A malformed ``Retry-After``
header is ignored (computed backoff applies), never a crash.

Every POST carries a client-generated ``Idempotency-Key`` header, held
constant across that logical request's retries: a retry after a
connection reset may re-send a request the server already executed, and
the key lets the server-side dedupe LRU replay the recorded outcome
instead of double-executing ``/v1/generate``.

``stats`` counts attempts/retries/recoveries (thread-safe), which is how
the chaos runs assert that transient 503s actually recover. The
single-attempt transport lives in the ``_open`` hook so chaos tooling
(``repro_torch.chaos.ChaosClient``) can inject connection resets underneath
the retry loop.
"""
from __future__ import annotations

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.gateway.errors import GatewayError, Timeout, error_for_status


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Defensive Retry-After parse: seconds as float, else None (callers
    fall back to the computed backoff). The header reaches us from the
    network — a malformed value must never crash the retry loop."""
    if not value:
        return None
    try:
        parsed = float(value)
    except (TypeError, ValueError):
        return None
    return parsed if parsed >= 0.0 and np.isfinite(parsed) else None


class GatewayClient:
    def __init__(
        self,
        base_url: str,
        timeout_s: float = 30.0,
        retries: int = 5,
        backoff_s: float = 0.05,
        backoff_factor: float = 2.0,
        backoff_cap_s: float = 2.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap_s = float(backoff_cap_s)
        self.stats = {"attempts": 0, "retries_503": 0, "retries_conn": 0,
                      "recovered": 0}
        self._lock = threading.Lock()

    # -- wire ------------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.stats[name] += n

    def _backoff(self, attempt: int) -> float:
        return min(self.backoff_cap_s,
                   self.backoff_s * self.backoff_factor ** attempt)

    def _open(self, req: urllib.request.Request, timeout: float) -> Dict:
        """One transport attempt: send, read, parse. Overridable hook —
        ``repro_torch.chaos.ChaosClient`` injects connection resets here."""
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def _request(self, path: str, obj: Optional[Dict] = None,
                 timeout_s: Optional[float] = None,
                 retry: bool = True, raise_for_status: bool = True) -> Dict:
        url = self.base_url + path
        data = None if obj is None else json.dumps(obj).encode()
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        max_attempts = (self.retries if retry else 0) + 1
        last_err: Optional[GatewayError] = None
        headers = {"Content-Type": "application/json"}
        if data is not None:
            # one key per *logical* request, constant across its retries:
            # the server's dedupe LRU replays instead of re-executing
            headers["Idempotency-Key"] = uuid.uuid4().hex
        for attempt in range(max_attempts):
            self._count("attempts")
            req = urllib.request.Request(
                url, data=data, headers=headers,
                method="POST" if data is not None else "GET")
            try:
                out = self._open(req, timeout)
                if attempt > 0:
                    self._count("recovered")
                return out
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except (json.JSONDecodeError, ValueError):
                    body = {}
                if not raise_for_status:
                    return body      # status report, not an error (healthz)
                last_err = error_for_status(
                    body.get("error", "error"),
                    body.get("detail", f"HTTP {e.code} from {path}"),
                    retry_after_s=_parse_retry_after(
                        e.headers.get("Retry-After")))
                if e.code != 503 or attempt + 1 >= max_attempts:
                    raise last_err from None
                self._count("retries_503")
                wait = last_err.retry_after_s or 0.0
                time.sleep(max(wait, self._backoff(attempt)))
            except (socket.timeout, TimeoutError) as e:
                raise Timeout(f"{path}: no response within {timeout}s") from e
            except (ConnectionError, http.client.RemoteDisconnected,
                    urllib.error.URLError) as e:
                if isinstance(e, urllib.error.URLError):
                    if isinstance(e.reason, (socket.timeout, TimeoutError)):
                        raise Timeout(
                            f"{path}: no response within {timeout}s") from e
                    if not isinstance(e.reason, (ConnectionError, OSError)):
                        raise
                # transient transport fault (reset/refused mid-burst):
                # retryable with the same backoff as a 503
                last_err = GatewayError(f"{path}: connection error: {e}")
                if attempt + 1 >= max_attempts:
                    raise last_err from e
                self._count("retries_conn")
                time.sleep(self._backoff(attempt))
        raise last_err  # unreachable: loop either returned or raised

    def _socket_timeout(self, timeout_s: Optional[float]) -> Optional[float]:
        """Socket timeout = server wait budget + margin, so the server's own
        504 (typed, with the request id) wins the race against the socket."""
        return None if timeout_s is None else float(timeout_s) + 2.0

    # -- API -------------------------------------------------------------
    def score(self, hist: Sequence[int], candidates: Sequence[int],
              hist_mask: Optional[Sequence[bool]] = None,
              deadline_ms: Optional[float] = None,
              timeout_s: Optional[float] = None) -> np.ndarray:
        """Score ``candidates`` against a user ``hist``; returns (C,)."""
        obj: Dict = {"hist": np.asarray(hist).tolist(),
                     "candidates": np.asarray(candidates).tolist()}
        if hist_mask is not None:
            obj["hist_mask"] = np.asarray(hist_mask, bool).tolist()
        if deadline_ms is not None:
            obj["deadline_ms"] = float(deadline_ms)
        if timeout_s is not None:
            obj["timeout_s"] = float(timeout_s)
        out = self._request("/v1/score", obj,
                            timeout_s=self._socket_timeout(timeout_s))
        return np.asarray(out["scores"], np.float32)

    def generate(self, tokens: Sequence[int],
                 deadline_ms: Optional[float] = None,
                 timeout_s: Optional[float] = None) -> List[int]:
        """Greedy continuation of a prompt; returns the decoded ids."""
        obj: Dict = {"tokens": np.asarray(tokens).tolist()}
        if deadline_ms is not None:
            obj["deadline_ms"] = float(deadline_ms)
        if timeout_s is not None:
            obj["timeout_s"] = float(timeout_s)
        out = self._request("/v1/generate", obj,
                            timeout_s=self._socket_timeout(timeout_s))
        return list(out["tokens"])

    def health(self) -> Dict:
        """Readiness probe. Unlike the serving routes, a non-2xx here is a
        *report*, not an error: a degraded gateway answers 503 with the
        same JSON body, which callers want to inspect, not catch."""
        return self._request("/healthz", retry=False, raise_for_status=False)

    def metrics(self) -> Dict:
        return self._request("/metrics", retry=False)
