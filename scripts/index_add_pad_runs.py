#!/usr/bin/env python3
"""What the GRASP step's padded edge slots cost ``index_add_`` on the card.

    python3 scripts/index_add_pad_runs.py

The GRASP partition (``dist.collectives.grasp_partition``) sizes each
rank's edge table at ``edge_slack`` times its share of the edges and fills
the rest with pad edges to local row 0, masked to zero; every layer's
segment sum (``index_add_``) still adds them, forward (over ``edst``) and
backward (over ``esrc``). At the cell's defaults on one rank that is a run
of half as many pads as real edges, all into one row.

For d = 64 and 100 float32 columns this times ``index_add_`` of E real
edges (destinations sorted, as the partition keeps them) with R pads to
row 0 appended: the default kernel (atomics) at the real size of chip_smoke
phase 12 (57,231,455 edges, R = 0 and 28,615,728), and under
``torch.use_deterministic_algorithms`` (a sort and a serial pass over each
run of one index) on smaller runs. CUDA event ms, one warm-up each; it
prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

REAL_E, REAL_PADS, ROWS = 57_231_455, 28_615_728, 4_194_304


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def timed_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def case(e: int, pads: int, d: int, deterministic: bool, reps: int) -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    dst = torch.randint(0, ROWS, (e,), generator=gen, device="cuda").sort().values
    idx = torch.cat([dst, torch.zeros(pads, dtype=dst.dtype, device="cuda")])
    src = torch.randn((e + pads, d), generator=gen, device="cuda")
    out = torch.zeros((ROWS, d), device="cuda")
    torch.use_deterministic_algorithms(deterministic)
    try:
        return timed_ms(lambda: out.index_add_(0, idx, src), reps)
    finally:
        torch.use_deterministic_algorithms(False)


def main() -> int:
    if not torch.cuda.is_available():
        print("index_add_pad_runs: CUDA is not available", file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(card_line())
    for d in (64, 100):
        for pads in (0, REAL_PADS):
            ms = case(REAL_E, pads, d, False, reps=5)
            print(f"index_add_ default, d {d}: {REAL_E} edges + {pads} pads to row 0: {ms:.3f} ms")
        for e, pads in ((4_000_000, 0), (4_000_000, 250_000), (4_000_000, 1_000_000)):
            t0 = time.perf_counter()
            det = case(e, pads, d, True, reps=1)
            plain = case(e, pads, d, False, reps=5)
            print(f"index_add_ d {d}: {e} edges + {pads} pads to row 0: deterministic {det:.3f} "
                  f"ms, default {plain:.3f} ms ({time.perf_counter() - t0:.1f} s)")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
