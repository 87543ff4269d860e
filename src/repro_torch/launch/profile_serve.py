"""Where a MIND serving batch's time goes, on the host and on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Serves the measured stream of chip_smoke.py's phase 8 (MIND at full
width, 8,192 requests all queued at t = 0, batches of 512, a 128 MiB GRASP
cache with half of it pinned) three times on the card, each through a
fresh engine built and loaded outside the measured window: once untraced
for the wall time, once under ``cProfile`` for the host functions of the
cache and the engine, and once under ``torch.profiler`` for the device
time of each kernel and copy. The device idle share is taken from the
traced run alone: 1 - its device-busy time / its own wall time. Prints
per-batch times. Needs one NVIDIA GPU; exits non-zero without one.
"""
from __future__ import annotations

import cProfile
import os
import pstats
import subprocess
import sys
import time

# the measured run of chip_smoke.py's phase 8
REQUESTS, MAX_BATCH, CACHE_BYTES = 8192, 512, 128 << 20

# host functions of the serving path, reported per batch
HOST = ("lookup", "_select_victims_rrpv", "_apply_inserts", "_fill_rows", "_promote",
        "_gather_hot", "_routed", "forward", "unique")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.nn import recsys
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import RecsysServeEngine, StreamConfig, stream_payloads
    from repro_torch.serve.scheduler import SchedulerConfig, VirtualClock

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    cfg = get_arch("mind")
    # the table stays on the host (the cache's backing store); the engine
    # moves the rest of the parameters to the card
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    payloads = stream_payloads(cfg, StreamConfig(requests=REQUESTS, candidates=64,
                                                 zipf_a=1.1, seed=0))

    def loaded_engine():
        engine = RecsysServeEngine(
            params, cfg, CacheConfig(CACHE_BYTES, 0.5, "rrpv"),
            SchedulerConfig(max_batch=MAX_BATCH, max_queue=REQUESTS),
            clock=VirtualClock(), device="cuda")
        for p in payloads:
            engine.submit(p)
        torch.cuda.synchronize()
        return engine

    loaded_engine().run_until_idle()  # warm-up: library handles, allocator pools
    engine = loaded_engine()
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    snap = engine.metrics.snapshot()
    batches = snap["counters"]["batches"]
    print(f"MIND stream: {snap['counters']['completed']} requests in {batches} batches, "
          f"hit rate {snap['hit_rate']:.6f}; untraced wall {wall:.1f} ms "
          f"({wall / batches:.3f} ms per batch)")

    engine = loaded_engine()
    prof = cProfile.Profile()
    prof.enable()
    engine.run_until_idle()
    prof.disable()
    stats = pstats.Stats(prof)
    print("host, cProfile run, ms per batch (cumulative, callees included):")
    for (path, _, name), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][3]):
        if name in HOST and ("repro_torch" in path or name == "unique"):
            print(f"  {row[3] * 1e3 / batches:9.3f} ms  {row[1] / batches:6.1f} calls  "
                  f"{os.path.basename(path)}:{name}")
    print("host, cProfile run, the 12 largest self times, ms per batch:")
    for (path, _, name), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]:
        print(f"  {row[2] * 1e3 / batches:9.3f} ms  {row[1] / batches:6.1f} calls  "
              f"{os.path.basename(path)}:{name[:70]}")

    engine = loaded_engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in trace.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"traced run: wall {traced:.1f} ms ({traced / batches:.3f} ms per batch), device "
          f"busy {busy:.3f} ms ({busy / batches:.4f} ms per batch), idle share "
          f"{1 - busy / traced:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / batches
        if ms >= 0.001:
            print(f"  {ms:9.4f} ms/batch {e.count / batches:6.1f} calls/batch  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
