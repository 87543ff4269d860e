#!/usr/bin/env python3
"""Where a real-size run of each graph app's time goes on the GPU, by kernel.

    python3 scripts/torch_profile_graph_suite.py

Builds ``lj`` at ``chip_smoke.REAL_SCALE`` (the graph of chip_smoke.py's
phases 5 and 9c), DBG-reorders it, builds its weighted out-CSR, and runs
on the card, as chip_smoke.py's phase 9c does: PageRank-Delta through K1
(``hot``) and through ``index_select`` (``plain``), SSSP from vertex 0,
BC from vertex 0 and Radii from roots 0..7. Each app runs once untraced
for its wall time and once under ``torch.profiler`` for the device time of
each kernel, in a window padded by ``chip_smoke.spin_pad`` (the
profiler on the card loses a few kernels at a window's edge); the device
idle share is taken from the traced run alone: 1 - its device-busy time /
its own wall time. Prints, per app, those numbers, the iteration count and
the kernels in order of device time, with the number of launches the
profiler saw (a check that it dropped none: PRD through K1 launches K1
once an iteration). Needs one NVIDIA GPU; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_graph_suite: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import REAL_SCALE, dbg_graph, spin_pad
    from repro_torch import apps
    from repro_torch.graph.csr import transpose
    from repro_torch.graph.generate import add_uniform_weights

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    g2 = dbg_graph("lj", REAL_SCALE)
    dg = g2.device("cuda")
    d_out = transpose(add_uniform_weights(g2, seed=1)).device("cuda")
    d_hops = dataclasses.replace(d_out, weights=None)
    print(f"lj scale {REAL_SCALE}: {g2.num_nodes} vertices, {g2.num_edges} edges")

    runs = {
        "prd hot": lambda st: apps.pagerank_delta(dg, gather_impl="hot", stats=st),
        "prd plain": lambda st: apps.pagerank_delta(dg, gather_impl="plain", stats=st),
        "sssp": lambda st: apps.sssp(d_out, 0, stats=st),
        "bc": lambda st: apps.bc_single_source(d_hops, 0, stats=st),
        "radii": lambda st: apps.radii_estimate(dg, torch.arange(8), stats=st),
    }
    for name, fn in runs.items():
        fn({})  # warm-up
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(stats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        iters = max(stats["iters"], 1)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spin_pad()
            t0 = time.perf_counter()
            fn({})
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3
            spin_pad()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[{name}] {stats['iters']} iterations; wall {wall:.4f} ms untraced "
              f"({wall / iters:.4f} ms/iteration); traced run: wall {traced_wall:.4f} ms, device "
              f"busy {busy:.4f} ms ({busy / iters:.4f} ms/iteration), idle share "
              f"{1 - busy / traced_wall:.4f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
            ms = e.self_device_time_total / 1e3
            if ms >= 0.001:
                print(f"[{name}]   {ms / iters:9.4f} ms/it {e.count / iters:6.1f} calls/it  "
                      f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
