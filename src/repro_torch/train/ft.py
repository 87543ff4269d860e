"""Fault tolerance: restartable step loop, failure injection, straggler
watchdog.

On a real multi-host deployment each restart re-initializes the
distributed runtime with the surviving hosts and restores from the latest
checkpoint; here the same control flow is exercised in-process (the tests
inject failures and assert bit-exact recovery), and the watchdog implements
the detection/decision layer that a cluster scheduler would consume. Host
code, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt_mod


class InjectedFailure(RuntimeError):
    """Stands in for a worker loss / preemption."""


@dataclasses.dataclass
class FailureInjector:
    """Raises at the configured global steps (once each)."""

    fail_at: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Per-step timing outlier detection + rebalance decision.

    A step slower than ``threshold`` x the trailing-median flags a
    straggler; ``decide`` reports which logical host to evict/replace and
    how to re-shard (the action a cluster controller would take).
    """

    window: int = 16
    threshold: float = 2.5
    _times: List[float] = dataclasses.field(default_factory=list)
    events: List[Dict] = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float,
               per_host_seconds: Optional[np.ndarray] = None) -> bool:
        self._times.append(seconds)
        hist = self._times[-self.window:]
        med = float(np.median(hist))
        is_straggler = len(hist) >= 4 and seconds > self.threshold * med
        if is_straggler:
            host = None
            if per_host_seconds is not None:
                host = int(np.argmax(per_host_seconds))
            self.events.append({"step": step, "seconds": seconds, "median": med, "host": host})
        return is_straggler

    def decide(self) -> Optional[Dict]:
        """Rebalance decision: evict the host implicated in >=3 events."""
        if not self.events:
            return None
        hosts = [e["host"] for e in self.events if e["host"] is not None]
        if not hosts:
            return {"action": "checkpoint_and_restart"}
        vals, counts = np.unique(hosts, return_counts=True)
        worst = int(vals[np.argmax(counts)])
        if counts.max() >= 3:
            return {"action": "evict_host", "host": worst, "then": "elastic_restore"}
        return {"action": "monitor"}


@dataclasses.dataclass
class RunResult:
    state: Dict
    steps_done: int
    restarts: int
    straggler_events: List[Dict]


def run_with_restarts(
    init_state: Callable[[], Dict],
    step_fn: Callable[[Dict, int], Dict],
    num_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    injector: Optional[FailureInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    max_restarts: int = 10,
) -> RunResult:
    """The production loop: step, checkpoint, restart on failure.

    ``step_fn(state, step) -> state`` must be deterministic given (state,
    step) — the data pipeline is seeded per step (data/pipeline.batches), so
    recovery is bit-exact, which the tests assert. A restart restores into
    a fresh ``init_state()``, on its devices.
    """
    watchdog = watchdog or StragglerWatchdog()
    restarts = 0
    while True:
        try:
            start = ckpt_mod.latest_step(ckpt_dir)
            if start is None:
                state, start = init_state(), 0
            else:
                state = ckpt_mod.restore(ckpt_dir, start, init_state())
            for step in range(start, num_steps):
                if injector is not None:
                    injector.check(step)
                t0 = time.time()
                state = step_fn(state, step)
                watchdog.record(step, time.time() - t0)
                if (step + 1) % ckpt_every == 0 or step + 1 == num_steps:
                    # save copies every leaf to the host before it returns,
                    # so a donated next step cannot change what is written
                    ckpt_mod.save(ckpt_dir, step + 1, state)
                    ckpt_mod.retain(ckpt_dir, keep=3)
            return RunResult(state, num_steps, restarts, watchdog.events)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
