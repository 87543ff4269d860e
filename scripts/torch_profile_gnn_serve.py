#!/usr/bin/env python3
"""Where a GNN serving batch's time goes, on the host and on the GPU.

    python3 scripts/torch_profile_gnn_serve.py

Serves the stream of chip_smoke.py's phase 10 (GIN at full width over the
DBG-ordered ``lj`` graph at ``chip_smoke.REAL_SCALE`` with d = 100
features, 8,192 requests of 4 seeds all queued at once, batches of 1,024
seeds sampled with fanout (15, 10), a 256 MiB GRASP cache with half of it
pinned) three times on the card, each through a fresh engine built and
loaded outside the measured window: once untraced for the wall time, once
under ``cProfile`` for the host functions of the sampler, the cache and
the engine, and once under ``torch.profiler`` for the device time of each
kernel and copy, in a window padded by ``chip_smoke.spin_pad``. The device
idle share is taken from the traced run alone: 1 - its device-busy time /
its own wall time. Prints per-batch times. Needs one NVIDIA GPU; exits
non-zero without one.
"""
from __future__ import annotations

import cProfile
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# host functions of the serving path, reported per batch
HOST = ("sample_blocks", "lookup", "_select_victims_rrpv", "_apply_inserts", "_fill_rows",
        "_promote", "_gather_hot", "forward", "forward_blocks", "apply", "gin_apply",
        "next_batch", "complete", "unique")


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_gnn_serve: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (
        GNN_CACHE_BYTES,
        GNN_D_FEAT,
        GNN_FANOUT,
        GNN_MAX_BATCH,
        GNN_REQUESTS,
        GNN_SEEDS_PER_REQ,
        REAL_SCALE,
        dbg_graph,
        spin_pad,
    )
    from repro_torch.configs.base import get_arch
    from repro_torch.nn import gnn
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import GNNServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig, VirtualClock

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    g2 = dbg_graph("lj", REAL_SCALE)
    n = g2.num_nodes
    print(f"lj scale {REAL_SCALE}: {n} vertices, {g2.num_edges} edges")
    cfg = get_arch("gin-tu")
    # the same features, parameters and seeds as chip_smoke.py's phase 10
    feats = np.random.default_rng(0).standard_normal((n, GNN_D_FEAT), dtype=np.float32)
    params = gnn.init(torch.Generator().manual_seed(0), cfg, GNN_D_FEAT, device="cuda")
    seeds = np.random.default_rng(1).integers(0, n, (GNN_REQUESTS, GNN_SEEDS_PER_REQ))

    def loaded_engine():
        engine = GNNServeEngine(
            params, cfg, g2, feats, CacheConfig(GNN_CACHE_BYTES, 0.5, "rrpv"),
            SchedulerConfig(max_batch=GNN_MAX_BATCH, max_queue=GNN_REQUESTS),
            fanout=GNN_FANOUT, seeds_per_req=GNN_SEEDS_PER_REQ, clock=VirtualClock(),
            device="cuda")
        for s in seeds:
            engine.submit({"seeds": s})
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
    print(f"GNN stream: {snap['counters']['completed']} requests in {batches} batches, "
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
    print("host, cProfile run, the 15 largest self times, ms per batch:")
    for (path, _, name), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]:
        print(f"  {row[2] * 1e3 / batches:9.3f} ms  {row[1] / batches:6.1f} calls  "
              f"{os.path.basename(path)}:{name[:70]}")

    engine = loaded_engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        spin_pad()
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
        spin_pad()
    kernels = [e for e in trace.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key]
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
