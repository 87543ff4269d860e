#!/usr/bin/env python3
"""Where a PageRank iteration's time goes on the GPU, by kernel.

    python3 scripts/torch_profile_pagerank.py

Builds ``lj`` at ``chip_smoke.REAL_SCALE`` (the graph of chip_smoke.py's
real-size phase), DBG-reorders it, and runs PageRank on the card per gather
route (``hot``: K1 + cold fixup; ``plain``: ``index_select``): once
untraced for the wall time per iteration, once under ``torch.profiler``
for the device time of each kernel. The device idle share is taken from
the traced run alone: 1 - its device-busy time / its own wall time.
Prints, per route, those numbers and the kernels in order of device time.
Needs one NVIDIA GPU; exits non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ITERS = 10


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_pagerank: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import REAL_SCALE
    from repro_torch import apps
    from repro_torch.core.reorder import reorder_ranks
    from repro_torch.graph import datasets
    from repro_torch.graph.csr import apply_reorder

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    g = datasets.load("lj", scale=REAL_SCALE)
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))
    dg = g2.device("cuda")
    print(f"lj scale {REAL_SCALE}: {g2.num_nodes} vertices, {g2.num_edges} edges, "
          f"{ITERS} iterations per run")

    for impl in ("hot", "plain"):
        apps.pagerank(dg, tol=0.0, max_iters=2, gather_impl=impl)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apps.pagerank(dg, tol=0.0, max_iters=ITERS, gather_impl=impl)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ITERS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apps.pagerank(dg, tol=0.0, max_iters=ITERS, gather_impl=impl)
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3 / ITERS
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ITERS
        print(f"[{impl}] wall {wall:.4f} ms/iteration untraced; traced run: wall "
              f"{traced_wall:.4f} ms/iteration, device busy {busy:.4f} ms/iteration, "
              f"idle share {1 - busy / traced_wall:.4f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
            ms = e.self_device_time_total / 1e3 / ITERS
            if ms >= 0.001:
                print(f"[{impl}]   {ms:9.4f} ms/it {e.count / ITERS:6.1f} calls/it  "
                      f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
