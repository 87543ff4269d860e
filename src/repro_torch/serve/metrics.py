"""Serving metrics: counters, latency histograms, JSON snapshot emitter.

Everything here is host-side and allocation-free on the hot path: latencies
land in fixed log-spaced buckets (no per-sample storage), counters are a
plain dict. ``snapshot()`` returns the JSON-ready view that
``engine.run_recsys_stream`` and the serve CLI report; percentile estimates
are read back from the bucket *upper* edges, capped at the exact tracked
``max`` (conservative; worst-case relative error = the sqrt(2) bucket
ratio, ~41%). A percentile that falls in the open-ended overflow bucket
reports the exact ``max`` — there is no finite upper edge to read back.
``max_s``/``mean_s`` are tracked exactly — bound checks should use those,
percentiles are for reporting shape.

``ServeMetrics`` is thread-safe: one instance is shared between the
thread that drives the engine, threads that read the snapshot, and
whatever thread drives the cache. A single lock guards the dict/ndarray
mutations; ``LatencyHistogram`` itself stays lock-free (always mutate it
through a ``ServeMetrics``, or from a single thread).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Optional

import numpy as np

# sqrt(2)-spaced bucket upper edges from 1us to ~91s (55 buckets); the last
# bucket is open-ended. Serving latencies (us..s) sit mid-range.
_N_BUCKETS = 55
_EDGES = 1e-6 * (2.0 ** (np.arange(_N_BUCKETS) / 2.0))


class LatencyHistogram:
    """Fixed log-bucket latency histogram with percentile readback."""

    def __init__(self) -> None:
        self.counts = np.zeros(_N_BUCKETS + 1, np.int64)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        i = int(np.searchsorted(_EDGES, seconds))
        self.counts[i] += 1
        self.total += 1
        self.sum += seconds
        self.max = max(self.max, seconds)

    def percentile(self, p: float) -> float:
        """Upper-edge estimate of the p-th percentile (p in [0, 100])."""
        if self.total == 0:
            return 0.0
        rank = np.ceil(self.total * p / 100.0)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, max(rank, 1)))
        if i >= _N_BUCKETS:
            # open-ended overflow bucket: no finite upper edge to report —
            # fall back to the exact tracked max
            return float(self.max)
        return float(min(_EDGES[i], self.max))

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": int(self.total),
            "mean_s": self.mean,
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "max_s": float(self.max),
        }


class ServeMetrics:
    """Counters + named latency histograms for one serving engine.

    Counter names used by the subsystem (all monotonically increasing):
      cache: ``hot_hits`` ``cold_hits`` ``misses`` ``bypassed``
      scheduler: ``admitted`` ``rejected`` ``shed`` ``completed``
      ``failed`` ``batches``
    Histograms: ``queue_wait`` ``service`` ``e2e`` (seconds).
    """

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}
        self.hists: Dict[str, LatencyHistogram] = {}
        self.gauges: Dict[str, float] = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = LatencyHistogram()
            h.observe(seconds)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    # -- derived cache figures ------------------------------------------
    @property
    def hit_rate(self) -> float:
        """(hot + cold hits) / all cache references."""
        with self._lock:
            return self._hit_rate_locked()

    def _hit_rate_locked(self) -> float:
        hits = self.counters.get("hot_hits", 0) + self.counters.get("cold_hits", 0)
        total = hits + self.counters.get("misses", 0)
        return hits / total if total else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hit_rate": self._hit_rate_locked(),
                "latency": {k: h.summary() for k, h in self.hists.items()},
            }

    def write_json(self, path: str, extra: Optional[Dict] = None) -> Dict:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        return snap
