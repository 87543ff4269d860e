#!/usr/bin/env python3
"""Time DeeperGCN's softmax aggregation on the card at the kron21.deepergcn shape.

    python3 scripts/softmax_aggr_times.py [--scale 21] [--reps 20]

It makes the cell's graph on the card (``gbench/graphs.py``, a fixed seed)
and a layer's input u, (N, 128) float32 drawn N(0, 1), then times one
layer's ``softmax_aggr`` call (``kernels/softmax_aggr``, rows below
``make_plan(N, 512).hot_size`` hot) with CUDA events over ``--reps`` calls,
its kernels' device time under torch.profiler, and the plain version
(``ref.softmax_aggr_ref``) once. It holds the kernel's output against the
plain version in float64 within ``ref.error_bound`` and two launches bit
for bit. It prints the card line and one JSON line: event ms and device ms
a call, the byte bound (4(N + 1) + 4E + 4·128·N read, 4·128·N written, at
3.35e12 B/s), the exponentials' bound ((N + E)·128 at 16 a clock an SM,
132 SMs, 1.98 GHz), the plain ms, the hot rows and their share of the row
reads (in-edges and self loops), and the bound's worst use. ``--device cpu
--scale 10`` rehearses the flow on the CPU, timed by the host clock.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from gbench.peaks import HBM_BYTES_PER_S  # noqa: E402

SEED = 2**31 + 7
SFU_PER_S = 132 * 16 * 1.98e9  # H100 SXM: 16 ex2 a clock an SM, at its 1.98 GHz boost
WIDTH = 128


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from gbench import graphs, spec
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels.softmax_aggr import ref
    from repro_torch.kernels.softmax_aggr.softmax_aggr import softmax_aggr

    dev = torch.device(args.device)
    on_gpu = dev.type == "cuda"
    if on_gpu:
        if not torch.cuda.is_available():
            print("softmax_aggr_times: CUDA is not available", file=sys.stderr)
            return 1
        print(card_line(), flush=True)
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    mix = spec.traffic("deepergcn")
    t, eps = mix["t"], mix["eps"]
    cfg = {**spec.config(spec.benchmark(), "kron21_deepergcn"), "scale": args.scale}
    g = graphs.make(cfg, SEED, dev, weighted=False)
    n, e = g.num_nodes, g.num_edges
    hot = make_plan(n, 4 * WIDTH).hot_size
    u = torch.randn(n, WIDTH, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)

    def call():
        return softmax_aggr(g.indptr, g.indices, u, hot, t, eps)

    first = call()  # build and warm
    sync()
    if on_gpu:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / args.reps
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            sync()
        device_ms = sum(ev.device_time_total for ev in prof.key_averages()
                        if "softmax_aggr_" in ev.key) / 1e3 / args.reps
    else:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            call()
        event_ms, device_ms = 1e3 * (time.perf_counter() - t0) / args.reps, None
    again = call()
    sync()
    repeats = bool(torch.equal(first, again))
    t0 = time.perf_counter()
    plain = ref.softmax_aggr_ref(g.indptr, g.indices, u, t, eps)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    del plain
    want = ref.softmax_aggr_ref(g.indptr, g.indices, u.double(), t, eps)
    err = (first.double() - want).abs_()
    del want
    bound = ref.error_bound(g.indptr, g.indices, u, t, eps)
    worst = float((err / bound).max())
    share = (int((g.indices < hot).sum()) + hot) / (e + n)
    least = 4 * (n + 1) + 4 * e + 4 * WIDTH * n + 4 * WIDTH * n
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu", "scale": args.scale,
        "N": n, "E": e, "reps": args.reps, "event_ms": event_ms, "device_ms": device_ms,
        "bytes_bound_ms": 1e3 * least / HBM_BYTES_PER_S,
        "exp_bound_ms": 1e3 * (n + e) * WIDTH / SFU_PER_S, "plain_ms": plain_ms,
        "hot_rows": hot, "hot_share_of_row_reads": share, "bound_worst_use": worst,
        "bit_identical_relaunch": repeats}), flush=True)
    return 0 if worst <= 1 and repeats else 1


if __name__ == "__main__":
    sys.exit(main())
