"""repro_torch.serve — GRASP-managed embedding cache + continuous-batching
inference subsystem.

``cache`` (two-region GRASP embedding cache, hot rows read by K1 on the
device), ``scheduler`` (continuous batching, admission control, deadlines,
shed load), ``metrics`` (hit/latency accounting + JSON snapshots) and
``engine`` (the MIND and GNN serving engines, and MIND's stream loop).
"""
from repro_torch.serve.cache import (
    CacheConfig,
    EmbeddingCache,
    LookupStats,
    SnapshotError,
)
from repro_torch.serve.engine import GNNServeEngine, RecsysServeEngine
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.refcache import ReferenceEmbeddingCache
from repro_torch.serve.scheduler import (
    ContinuousBatcher,
    Request,
    SchedulerConfig,
    VirtualClock,
)

__all__ = [
    "CacheConfig",
    "EmbeddingCache",
    "GNNServeEngine",
    "RecsysServeEngine",
    "LookupStats",
    "ReferenceEmbeddingCache",
    "SnapshotError",
    "LatencyHistogram",
    "ServeMetrics",
    "ContinuousBatcher",
    "Request",
    "SchedulerConfig",
    "VirtualClock",
]
