"""Seeded fault injection for the serve/gateway stack.

Chaos only earns its keep when a failure is *reproducible*: an assertion
that "the supervisor restarted every injected crash" is meaningless if
the injected crash count varies run to run. So every injection decision
here is a **pure function of (seed, fault kind, call index)** — no shared
RNG stream whose draw order would depend on thread interleaving. Two runs
of the same schedule over the same workload therefore produce identical
``InjectionLog``\\ s (the determinism check of ``chip_smoke.py``'s phase 13),
and a specific failure can be replayed by seed alone.

Fault surfaces, one per layer the gateway must survive:

  ``forward_error``   ``ChaosEngine.forward`` raises ``InjectedFault``
                      — absorbed by the pump (batch fails, 500 on the
                      wire, breaker fodder).
  ``latency_spike``   ``ChaosEngine.forward`` sleeps ``latency_spike_s``
                      first — exercises deadlines/sheds and the wedge
                      watchdog margin.
  ``pump_crash``      the wrapped batcher's ``next_batch`` raises —
                      escapes the pump's forward try/except and KILLS the
                      pump thread; only the supervisor brings it back.
                      Decided per *non-empty claim attempt* (idle polls
                      don't consume indices), so crash counts don't
                      depend on how long the pump idled.
  ``conn_reset``      ``ChaosClient`` raises ``ConnectionResetError`` at
                      the transport hook — ``pre`` mode drops the request
                      before it is sent (pure transport fault), ``post``
                      mode sends it, discards the response, then resets —
                      the double-execution hazard the idempotency-key
                      dedupe exists for. Decided per POST attempt.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.gateway.client import GatewayClient


class InjectedFault(RuntimeError):
    """A fault raised on purpose by the chaos layer."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-kind injection rates (probability per decision point) + seed."""

    seed: int = 0
    forward_error_rate: float = 0.0
    latency_spike_rate: float = 0.0
    latency_spike_s: float = 0.05
    pump_crash_rate: float = 0.0
    conn_reset_rate: float = 0.0


# stable kind ids — part of the decision function, do not renumber
_KIND_ID = {"forward_error": 0, "latency_spike": 1,
            "pump_crash": 2, "conn_reset": 3}
_RATE_FIELD = {"forward_error": "forward_error_rate",
               "latency_spike": "latency_spike_rate",
               "pump_crash": "pump_crash_rate",
               "conn_reset": "conn_reset_rate"}


class InjectionLog:
    """Thread-safe ordered record of fired injections.

    Entries are ``(kind, index)``; ordering is normalized per kind (each
    kind's indices are strictly increasing by construction), so two runs
    of the same schedule compare equal with a plain ``==`` on
    ``entries()`` regardless of cross-kind thread interleaving.
    """

    def __init__(self) -> None:
        self._events: List[Tuple[str, int]] = []
        self._lock = threading.Lock()

    def record(self, kind: str, index: int) -> None:
        with self._lock:
            self._events.append((kind, index))

    def entries(self) -> List[Tuple[str, int]]:
        with self._lock:
            return sorted(self._events)

    def count(self, kind: str) -> int:
        with self._lock:
            return sum(1 for k, _ in self._events if k == kind)

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for k, _ in self._events:
                out[k] = out.get(k, 0) + 1
            return out


class FaultSchedule:
    """Pure-function fault decisions + the log of what actually fired."""

    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.log = InjectionLog()

    def decide(self, kind: str, index: int) -> bool:
        """Would-fire decision for the ``index``-th event of ``kind`` —
        stateless and thread-safe; fired decisions land in ``log``."""
        rate = getattr(self.spec, _RATE_FIELD[kind])
        if rate <= 0.0:
            return False
        draw = np.random.default_rng(
            [self.spec.seed, _KIND_ID[kind], index]).random()
        if draw >= rate:
            return False
        self.log.record(kind, index)
        return True


class _ChaosBatcher:
    """Batcher proxy that turns scheduled ``pump_crash`` decisions into a
    raising ``next_batch`` — the exact silent-pump-death failure mode."""

    def __init__(self, inner, schedule: FaultSchedule) -> None:
        self._inner = inner
        self._schedule = schedule
        self._claims = itertools.count()

    def next_batch(self):
        # only non-empty claims consume decision indices: an idle pump
        # polling an empty queue must not advance the fault schedule
        if self._inner.depth > 0:
            i = next(self._claims)
            if self._schedule.decide("pump_crash", i):
                raise InjectedFault(f"chaos: pump crash (claim #{i})")
        return self._inner.next_batch()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosEngine:
    """Engine wrapper injecting forward faults per the schedule.

    Presents the full ``_EngineBase`` surface of the wrapped engine
    (``batcher`` is proxied for crash injection, everything else passes
    through), so it drops into ``EnginePump``/``GatewayServer`` unchanged.
    """

    def __init__(self, engine, schedule: FaultSchedule) -> None:
        self._engine = engine
        self.schedule = schedule
        self.batcher = _ChaosBatcher(engine.batcher, schedule)
        self._forwards = itertools.count()

    def forward(self, payloads):
        i = next(self._forwards)
        if self.schedule.decide("latency_spike", i):
            time.sleep(self.schedule.spec.latency_spike_s)
        if self.schedule.decide("forward_error", i):
            raise InjectedFault(f"chaos: forward error (call #{i})")
        return self._engine.forward(payloads)

    def __getattr__(self, name):
        return getattr(self._engine, name)


class ChaosClient(GatewayClient):
    """Gateway client injecting connection resets at the transport hook.

    ``reset_mode="pre"`` resets before the request is sent (server never
    sees it — the retry is safe); ``"post"`` sends the request, lets the
    server execute it, then resets before the response is consumed — the
    retry *re-sends an already-executed request*, which is only safe
    because the client attaches an idempotency key and the server dedupes
    on it. Resets are decided per POST attempt index; GETs pass through
    untouched (health polls must not perturb the schedule).
    """

    def __init__(self, base_url: str, schedule: FaultSchedule,
                 reset_mode: str = "post", **kw) -> None:
        super().__init__(base_url, **kw)
        if reset_mode not in ("pre", "post"):
            raise ValueError(f"reset_mode {reset_mode!r}")
        self.schedule = schedule
        self.reset_mode = reset_mode
        self._posts = itertools.count()

    def _open(self, req, timeout):
        if req.data is None:
            return super()._open(req, timeout)
        i = next(self._posts)
        if not self.schedule.decide("conn_reset", i):
            return super()._open(req, timeout)
        if self.reset_mode == "pre":
            raise ConnectionResetError(f"chaos: reset before send (#{i})")
        super()._open(req, timeout)   # server executed; response discarded
        raise ConnectionResetError(f"chaos: reset before response (#{i})")
