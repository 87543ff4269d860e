#!/usr/bin/env python3
"""Time SSSP's relaxation on the card at the SSSP cells' shapes.

    python3 scripts/relax_times.py [--scale 25] [--configs kron25,urand25]

For each configuration it makes the benchmark's weighted graph on the card
(``gbench/graphs.py``, a fixed seed) and runs SSSP from the cells' first
source. At every iteration it runs the same step three ways, in turns
whose order flips each iteration: the relaxation kernels
(``kernels/segment_min/relax.py``, from the iteration's state, restored
before each run outside the timed span), their plain version
(``ref.relax_min_ref`` and ``ref.settle_ref``) and the chain the port ran
before them (``dist`` and ``active`` gathered over every edge through int64
sources, the add, ``where``, the segment-min kernel, then the compare and
the minimum). Each is timed with CUDA events, and the three results are
held bit for bit. It prints the card line and one JSON line a
configuration: the iterations, the edges out of active rows (F) and the
active rows (A) summed over them, ms an iteration of each way, and the
relaxation's bound: 8 B an edge out of an active row (target and weight),
8 B an active row (its offsets) and 9 B a vertex (8·F + 8·A + 9N bytes an
iteration at 3.35e12 B/s). ``--device cpu --scale 10`` rehearses the flow
on the CPU, timed by the host clock.
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
    from repro_torch.graph.csr import out_degree_sum
    from repro_torch.kernels.segment_min import ref
    from repro_torch.kernels.segment_min.relax import relax_min
    from repro_torch.kernels.segment_min.segment_min import segment_min

    cfg = {**spec.config(spec.benchmark(), name), "scale": scale}
    g = graphs.make(cfg, SEED, dev, weighted=True)
    source = sssp_app.pick_sources(g, 1, spec.traffic("sssp")["source_seed"])[0]
    n, e, w = g.num_nodes, g.num_edges, g.weights
    src_of_edge = g.dst.long()
    inf = float("inf")
    run = timer(dev)
    keys = torch.full((n,), inf, device=dev).view(torch.int32)
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    relaxed = torch.zeros(1, dtype=torch.int64, device=dev)
    d_t = torch.empty(n, device=dev)
    a_t = torch.empty(n, dtype=torch.bool, device=dev)

    def kernels(d0, a0):
        d_t.copy_(d0)
        a_t.copy_(a0)
        _, ms = run(lambda: relax_min(g.indptr, g.indices, w, d_t, a_t, keys, flag, relaxed))
        return (d_t.clone(), a_t.clone()), ms

    def plain(d0, a0):
        def step():
            d, a = d0.clone(), a0.clone()
            ref.settle_ref(ref.relax_min_ref(g.indptr, g.indices, w, d, a), d, a)
            return d, a
        return run(step)

    def chain(d0, a0):
        def step():
            cand = torch.where(a0[src_of_edge], d0[src_of_edge] + w, inf)
            best = segment_min(cand, g.indices, n)
            return torch.minimum(d0, best), best < d0
        return run(step)

    ways = {"kernel": kernels, "plain": plain, "chain": chain}
    ms = {k: 0.0 for k in ways}
    dist = torch.full((n,), inf, device=dev)
    dist[source] = 0.0
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[source] = True
    kernels(dist, active)  # build and warm
    iters = edges = rows = mismatched = 0
    while bool(active.any()):
        edges += int(out_degree_sum(g.indptr, active))
        rows += int(active.sum())
        results = {}
        for way in (list(ways) if iters % 2 == 0 else list(reversed(ways))):
            results[way], t = ways[way](dist, active)
            ms[way] += t
        (dist, active), want = results["kernel"], results["chain"]
        mismatched += int(not all(
            torch.equal(dist.view(torch.int32), r[0].view(torch.int32))
            and torch.equal(active, r[1]) for r in (want, results["plain"])))
        del results, want
        iters += 1
    bound_bytes = 8 * edges + 8 * rows + 9 * n * iters
    return {"config": name, "scale": scale, "N": n, "E": e, "source": source, "iters": iters,
            "frontier_edges": edges, "frontier_rows": rows,
            "frontier_share": edges / (e * iters),
            "iterations_not_bit_identical": mismatched,
            **{f"{k}_ms_per_iter": v / iters for k, v in ms.items()},
            "bound_ms_per_iter": 1e3 * bound_bytes / HBM_BYTES_PER_S / iters}


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
            print("relax_times: CUDA is not available", file=sys.stderr)
            return 1
        print(card_line(), flush=True)
    for name in args.configs.split(","):
        print(json.dumps(one_config(name, args.scale, dev)), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
