"""Continuous-batching request scheduler: admission control, deadlines,
shed-load degradation.

The batcher owns a bounded FIFO of pending requests. ``submit`` applies
admission control (reject immediately once ``max_queue`` is exceeded —
backpressure to the caller instead of unbounded queueing); ``next_batch``
sheds queued requests whose deadline already passed (they would miss it
anyway — executing them only drags down everyone behind), then picks up to
``max_batch`` requests, earliest-deadline-first. Because requests join the
next batch as soon as the previous one retires, a new arrival never waits
for a full batch to drain — continuous batching.

Together the three mechanisms bound the tail: a request that is *served*
waited at most its deadline in queue, so e2e latency is bounded by
``deadline + one batch service time`` no matter how far the offered load
exceeds the budget — overload degrades throughput (sheds), not p99.

Every ``Request`` carries a completion event that is set exactly once,
when it reaches a terminal status (done / shed / rejected / failed) — a
caller on another thread blocks on ``Request.wait`` instead of polling, and a
request can never hang: rejects resolve synchronously in ``submit``, sheds
resolve in ``next_batch``, and a batch whose forward raises is resolved
with a typed error via ``fail``.

The clock is injectable so tests and the smoke benchmark can drive a
virtual timeline deterministically (see ``VirtualClock``).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, List, Optional

from repro_torch.serve.metrics import ServeMetrics


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 32          # continuous-batch width
    max_queue: int = 256         # admission-control bound on queued requests
    default_deadline_s: Optional[float] = None  # per-request unless overridden


@dataclasses.dataclass
class Request:
    rid: int
    payload: Any
    arrival: float
    deadline: Optional[float]    # absolute time; None = best-effort
    status: str = "queued"       # queued | running | done | shed | rejected | failed
    started: Optional[float] = None
    finished: Optional[float] = None
    result: Any = None
    error: Optional[BaseException] = None   # set when status == "failed"
    # completion event: set exactly once, when the request reaches a
    # terminal status (done/shed/rejected/failed). Callers on other
    # threads block on this instead of polling ``status``.
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    TERMINAL = frozenset({"done", "shed", "rejected", "failed"})

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request resolves; True iff it did in time."""
        return self.done.wait(timeout)

    @property
    def resolved(self) -> bool:
        return self.done.is_set()


class VirtualClock:
    """Deterministic manual clock for tests/benchmarks (seconds)."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        self._now = max(self._now, float(t))
        return self._now


class ContinuousBatcher:
    """Thread-safe bounded queue with EDF batching and load shedding."""

    def __init__(
        self,
        config: SchedulerConfig,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[ServeMetrics] = None,
    ) -> None:
        self.config = config
        self.clock = clock
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._pending: List[Request] = []
        self._lock = threading.Lock()
        self._rid = itertools.count()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def submit(self, payload: Any,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request; sets ``status='rejected'`` when the queue is
        full (the admission-control path — caller sees it synchronously)."""
        now = self.clock()
        rel = deadline_s if deadline_s is not None else self.config.default_deadline_s
        req = Request(
            rid=next(self._rid),
            payload=payload,
            arrival=now,
            deadline=(now + rel) if rel is not None else None,
        )
        with self._lock:
            if len(self._pending) >= self.config.max_queue:
                req.status = "rejected"
                req.done.set()
                self.metrics.count("rejected")
                return req
            self._pending.append(req)
        self.metrics.count("admitted")
        return req

    def next_batch(self) -> List[Request]:
        """Shed expired requests, then claim up to ``max_batch`` (EDF)."""
        now = self.clock()
        shed: List[Request] = []
        with self._lock:
            keep = []
            for r in self._pending:
                if r.deadline is not None and now > r.deadline:
                    r.status = "shed"
                    r.finished = now
                    shed.append(r)
                else:
                    keep.append(r)
            # EDF; ties broken by arrival, then rid (= submission order), so
            # equal-deadline requests batch in a stable FIFO order
            keep.sort(key=lambda r: (r.deadline if r.deadline is not None
                                     else float("inf"), r.arrival, r.rid))
            batch = keep[: self.config.max_batch]
            self._pending = keep[self.config.max_batch:]
            for r in batch:
                r.status = "running"
                r.started = now
        for r in shed:
            r.done.set()
            self.metrics.count("shed")
        for r in batch:
            self.metrics.observe("queue_wait", now - r.arrival)
        if batch:
            self.metrics.count("batches")
            self.metrics.gauge("last_batch_size", len(batch))
        return batch

    def complete(self, batch: List[Request], results: List[Any]) -> None:
        """Attach results and record service/e2e latency for the batch.

        Requests already at a terminal status are skipped: a supervisor may
        have failed out a wedged batch while its (stuck) forward was still
        running — when that forward finally returns, its completion must
        not overwrite the terminal outcome callers already saw.
        """
        now = self.clock()
        fresh: List[Request] = []
        with self._lock:
            for r, res in zip(batch, results):
                if r.status in Request.TERMINAL:
                    continue
                r.status = "done"
                r.finished = now
                r.result = res
                fresh.append(r)
        for r in fresh:
            r.done.set()
            self.metrics.count("completed")
            self.metrics.observe("service", now - (r.started or now))
            self.metrics.observe("e2e", now - r.arrival)

    def fail(self, batch: List[Request], exc: BaseException) -> None:
        """Resolve a claimed batch whose forward raised: callers must never
        hang on a crashed batch, they get a typed error instead. Idempotent
        per request (terminal statuses are left untouched)."""
        now = self.clock()
        fresh: List[Request] = []
        with self._lock:
            for r in batch:
                if r.status in Request.TERMINAL:
                    continue
                r.status = "failed"
                r.finished = now
                r.error = exc
                fresh.append(r)
        for r in fresh:
            r.done.set()
            self.metrics.count("failed")

    def fail_all(self, exc: BaseException) -> List[Request]:
        """Fail every *queued* (unclaimed) request in one step — the
        shutdown last resort for when the claim path itself is broken
        (a ``next_batch`` that raises): callers must unblock even when
        batching can't run. Returns the requests that were failed out."""
        with self._lock:
            pending, self._pending = self._pending, []
        self.fail(pending, exc)
        return pending
