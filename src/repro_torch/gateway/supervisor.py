"""Pump supervision: liveness watchdog, restart-with-backoff, crash-loop
containment.

The pump absorbs *forward* faults (a raising forward fails its batch and
the loop continues) but not faults in the loop itself: a ``next_batch``
that raises kills the thread, and a forward that never returns wedges it.
Either way the queue stops draining while ``/healthz`` — without this
module — keeps reporting healthy. ``PumpSupervisor`` closes that gap:

- **heartbeat**: every pump loop iteration stamps ``pump.last_beat``; the
  watchdog thread samples it every ``check_interval_s``.
- **dead pump** (thread not alive, pump started, not closed): any claimed
  in-flight batch is failed out so its callers unblock with a typed 500,
  then the pump is restarted (``pump.restart()`` — fresh thread, bumped
  generation) after an exponential backoff ``backoff_s * factor^k``
  capped at ``backoff_cap_s``, where ``k`` counts restarts inside the
  current crash window.
- **wedged pump** (alive but one batch in flight longer than
  ``wedge_timeout_s``): the batch is failed out and a new generation is
  spawned; the wedged thread exits on its own if it ever unwedges
  (late ``complete``/``fail`` calls are no-ops on terminal requests).
- **crash loop**: more than ``crash_loop_threshold`` restarts within
  ``crash_loop_window_s`` trips the supervisor into ``healthy == False``.
  Restarts continue at the capped backoff (the engine may yet recover),
  but the gateway surfaces the state as 503 on ``/healthz`` readiness and
  sheds the route via ``Unavailable`` — a persistently dying engine must
  fail fast for callers, not burn pump restarts per request.

The supervisor never touches a pump that was never started and stands
down as soon as the pump is draining/closed (shutdown is not a crash).

A wedge timeout must exceed the first forward's set-up: build the
kernels and warm the engine up before the supervisor starts watching
(the serve CLI does), or an ``nvcc`` build or the card's first
allocations can be taken for a wedge. An abandoned generation that is
still inside a forward on the card shares the default stream with its
successor, which serialises the two (``gateway.pump``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.gateway.errors import Failed
from repro_torch.gateway.pump import EnginePump


class PumpSupervisor:
    """Watchdog thread over one ``EnginePump``."""

    def __init__(
        self,
        pump: EnginePump,
        check_interval_s: float = 0.01,
        wedge_timeout_s: float = 30.0,
        backoff_s: float = 0.02,
        backoff_factor: float = 2.0,
        backoff_cap_s: float = 1.0,
        crash_loop_threshold: int = 5,
        crash_loop_window_s: float = 30.0,
    ) -> None:
        self.pump = pump
        self.check_interval_s = float(check_interval_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap_s = float(backoff_cap_s)
        self.crash_loop_threshold = int(crash_loop_threshold)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.restarts = 0             # total successful pump restarts
        self.deaths = 0               # dead-thread detections
        self.wedges = 0               # wedged-batch takeovers
        self.last_error: Optional[str] = None
        self._restart_times: List[float] = []   # for the crash-loop window
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics = getattr(pump.engine, "metrics", None)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "PumpSupervisor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, name=f"supervisor-{self.pump.name}",
                daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "PumpSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- state -----------------------------------------------------------
    @property
    def healthy(self) -> bool:
        """False once the pump is crash-looping (restart budget exceeded
        inside the window). Recovers automatically when the window drains."""
        now = time.monotonic()
        recent = [t for t in self._restart_times
                  if now - t <= self.crash_loop_window_s]
        return len(recent) <= self.crash_loop_threshold

    def stats(self) -> Dict:
        return {
            "restarts": self.restarts,
            "deaths": self.deaths,
            "wedges": self.wedges,
            "healthy": self.healthy,
            "last_error": self.last_error,
        }

    # -- watchdog --------------------------------------------------------
    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.count(name)

    def _fail_out_inflight(self, why: str) -> None:
        batch = list(self.pump._inflight)
        if batch:
            self.pump.engine.batcher.fail(
                batch, Failed(f"{self.pump.name}: {why}"))

    def _backoff(self) -> float:
        k = len(self._restart_times)
        return min(self.backoff_cap_s, self.backoff_s * self.backoff_factor ** k)

    def _restart(self, why: str) -> None:
        self.last_error = why
        now = time.monotonic()
        self._restart_times = [t for t in self._restart_times
                               if now - t <= self.crash_loop_window_s]
        # exponential backoff before the respawn; interruptible by close()
        if self._stop.wait(self._backoff()):
            return
        if self.pump.restart():
            self.restarts += 1
            self._restart_times.append(time.monotonic())
            self._count("pump_restarts")
            if not self.healthy:
                self._count("pump_crash_loops")

    def _watch(self) -> None:
        pump = self.pump
        while not self._stop.wait(self.check_interval_s):
            if not pump.started or pump.draining:
                continue   # never-started pumps and shutdowns are not crashes
            if not pump.running:
                self.deaths += 1
                self._count("pump_deaths")
                cause = repr(pump.crash) if pump.crash else "thread died"
                # a death inside next_batch leaves the batch unclaimed, but a
                # thread killed mid-forward would strand its claimed batch
                self._fail_out_inflight(f"pump died ({cause})")
                self._restart(cause)
            elif pump.busy_for_s > self.wedge_timeout_s:
                self.wedges += 1
                self._count("pump_wedges")
                self._fail_out_inflight(
                    f"batch wedged > {self.wedge_timeout_s}s")
                self._restart(f"wedged > {self.wedge_timeout_s}s")
