#!/usr/bin/env python3
"""Time the segment-min kernel on the card at the SSSP cells' shapes.

    python3 scripts/segment_min_times.py [--scale 25] [--configs kron25,urand25]

For each configuration it makes the benchmark's weighted graph on the card
(``gbench/graphs.py``, a fixed seed), runs SSSP from the cells' first
source as ``repro_torch.apps.sssp`` does, and at every iteration reduces
the same candidates three ways, in turns whose order flips each iteration:
the kernel (``kernels/segment_min``, int32 targets), its plain version
(``ref.segment_min_ref``: ``scatter_reduce_`` amin, widening the targets
on each call) and the library call the port made before it
(``scatter_reduce_`` amin over int64 targets widened once). Each is timed
with CUDA events, and the kernel's result is held bit for bit against the
library's. It prints the card line and one JSON line a configuration: the
iterations, the live messages (candidates not +inf) and their share of E,
ms an iteration of each way, the kernel's bound (the messages read once,
the live messages' int32 targets, ``out`` written once, at 3.35e12 B/s)
and the live messages per second of the kernel's time. ``--device cpu
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def timer(dev):
    """A function that runs ``fn`` once and returns (its result, ms)."""
    import torch

    if dev.type != "cuda":
        def run(fn):
            t = time.perf_counter()
            out = fn()
            return out, 1e3 * (time.perf_counter() - t)
        return run

    def run(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    return run


def one_config(name: str, scale: int, dev) -> dict:
    import torch

    from gbench import graphs, spec
    from gbench.apps import sssp as sssp_app
    from repro_torch.kernels.segment_min import ref
    from repro_torch.kernels.segment_min import segment_min as kernel

    bench = spec.benchmark()
    cfg = {**spec.config(bench, name), "scale": scale}
    g = graphs.make(cfg, SEED, dev, weighted=True)
    source = sssp_app.pick_sources(g, 1, spec.traffic("sssp")["source_seed"])[0]
    n, e = g.num_nodes, g.num_edges
    src_of_edge, tgt, tgt64 = g.dst.long(), g.indices, g.indices.long()
    run = timer(dev)
    ways = {
        "kernel": lambda c: kernel.segment_min(c, tgt, n),
        "plain": lambda c: ref.segment_min_ref(c, tgt, n),
        "library": lambda c: torch.full((n,), float("inf"), device=dev).scatter_reduce_(
            0, tgt64, c, "amin", include_self=True),
    }
    ms = {k: 0.0 for k in ways}
    run(lambda: ways["kernel"](torch.full((e,), float("inf"), device=dev)))  # build and warm
    dist = torch.full((n,), float("inf"), device=dev)
    dist[source] = 0.0
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[source] = True
    iters, live, mismatched = 0, 0, 0
    while bool(active.any()):
        cand = torch.where(active[src_of_edge], dist[src_of_edge] + g.weights, float("inf"))
        live += int((cand != float("inf")).sum())
        results = {}
        for way in (list(ways) if iters % 2 == 0 else list(reversed(ways))):
            results[way], t = run(lambda: ways[way](cand))
            ms[way] += t
        best = results["kernel"]
        mismatched += int(not torch.equal(best.view(torch.int32),
                                          results["library"].view(torch.int32)))
        del results, cand
        active = best < dist
        dist = torch.minimum(dist, best)
        iters += 1
    bound_bytes = 4 * e * iters + 4 * live + 4 * n * iters
    return {"config": name, "scale": scale, "N": n, "E": e, "source": source, "iters": iters,
            "live_messages": live,
            "live_share": live / (e * iters),
            "iterations_not_bit_identical": mismatched,
            **{f"{k}_ms_per_iter": v / iters for k, v in ms.items()},
            "bound_ms_per_iter": 1e3 * bound_bytes / HBM_BYTES_PER_S / iters,
            "live_messages_per_kernel_s": live / (ms["kernel"] / 1e3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=25)
    ap.add_argument("--configs", default="kron25,urand25")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("segment_min_times: CUDA is not available", file=sys.stderr)
            return 1
        print(card_line(), flush=True)
    for name in args.configs.split(","):
        print(json.dumps(one_config(name, args.scale, dev)), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
