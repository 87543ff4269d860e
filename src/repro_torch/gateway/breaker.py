"""Per-route circuit breaker: shed a persistently failing engine fast.

A single engine fault is absorbed by the pump (batch fails, loop
continues) and a dying pump thread is restarted by the supervisor — but
when the engine fails *persistently* (bad weights, poisoned jit cache,
chaos schedule with a high fault rate), every request still pays a full
queue + forward round-trip just to collect a 500, and the supervisor
burns restart budget on an engine that cannot serve. The breaker cuts
that path at the route level with the classic three states:

  closed     normal serving; ``failure_threshold`` *consecutive* route
             failures (engine 500s) trip it open. Any success resets the
             streak — intermittent faults never open the breaker.
  open       requests are shed immediately with ``Unavailable`` (503 +
             Retry-After = remaining cooldown) — no queue entry, no
             forward. After ``cooldown_s`` the next request is let
             through as a probe (-> half-open).
  half_open  up to ``half_open_probes`` concurrent probes run the real
             path; one success closes the breaker (streak reset), one
             failure reopens it for another full cooldown.

Only *engine* failures count: ``Failed`` (forward raised) and unexpected
handler errors. Backpressure outcomes — ``Rejected``/``Shed``/``Timeout``
— are the scheduler doing its job and must not open the breaker.

The clock is injectable for deterministic tests. Thread-safe: handler
threads race on ``before``/``record``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from repro_torch.gateway.errors import Unavailable


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 1.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.clock = clock
        self.state = "closed"
        self.opened = 0               # total open transitions
        self.shed = 0                 # requests refused while open
        self._streak = 0              # consecutive failures while closed
        self._opened_at = 0.0
        self._probes = 0              # in-flight half-open probes
        self._lock = threading.Lock()

    def before(self) -> None:
        """Gate one request; raises ``Unavailable`` when open (and not yet
        due for a probe). Callers MUST follow with ``record_success`` or
        ``record_failure`` so half-open probe slots are released."""
        with self._lock:
            if self.state == "open":
                remaining = self._opened_at + self.cooldown_s - self.clock()
                if remaining > 0:
                    self.shed += 1
                    raise Unavailable(
                        f"circuit open ({self._streak} consecutive failures); "
                        f"retry in {remaining:.3f}s",
                        retry_after_s=max(remaining, 1e-3))
                self.state = "half_open"
                self._probes = 0
            if self.state == "half_open":
                if self._probes >= self.half_open_probes:
                    remaining = self._opened_at + self.cooldown_s - self.clock()
                    self.shed += 1
                    raise Unavailable(
                        "circuit half-open, probe already in flight",
                        retry_after_s=max(remaining, self.cooldown_s / 2))
                self._probes += 1

    def record_success(self) -> None:
        with self._lock:
            if self.state == "half_open":
                self._probes = max(0, self._probes - 1)
            self.state = "closed"
            self._streak = 0

    def record_neutral(self) -> None:
        """Outcome that says nothing about engine health (reject/shed/
        timeout): release a half-open probe slot without closing or
        reopening — the next request probes again."""
        with self._lock:
            if self.state == "half_open":
                self._probes = max(0, self._probes - 1)

    def record_failure(self) -> None:
        with self._lock:
            if self.state == "half_open":
                # the probe failed: the engine is still down — reopen
                self._probes = max(0, self._probes - 1)
                self._open()
                return
            self._streak += 1
            if self.state == "closed" and self._streak >= self.failure_threshold:
                self._open()

    def _open(self) -> None:   # caller holds the lock
        self.state = "open"
        self.opened += 1
        self._opened_at = self.clock()

    def stats(self) -> Dict:
        with self._lock:
            return {"state": self.state, "opened": self.opened,
                    "shed": self.shed, "streak": self._streak}
