"""The paper's full application suite (Table III) on one dataset through
``repro_torch``, with and without skew-aware reordering + GRASP. PageRank
and PageRank-Delta gather through the hot-gather kernel on the card.

    PYTHONPATH=src python examples/graph_suite_torch.py [--dataset tw] [--scale 13]
    PYTHONPATH=src python examples/graph_suite_torch.py --device cpu   # plain versions
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import torch

from repro_torch import apps, devices
from repro_torch.core import cachesim
from repro_torch.core.reorder import reorder_ranks
from repro_torch.graph import datasets, traces
from repro_torch.graph.csr import apply_reorder, transpose
from repro_torch.graph.generate import add_uniform_weights

APPS = ("pr", "prd", "sssp", "bc", "radii")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_apps(g, label: str, device):
    """Run the five apps over ``g`` on ``device``: SSSP from vertex 0 over
    the weighted out-CSR, BC from vertex 0 over the out-CSR, Radii from
    roots 0..7. Returns (outputs, seconds, iterations), each keyed by app."""
    dev = devices.resolve(device)
    dg = g.device(dev)
    out_csr = transpose(add_uniform_weights(g, seed=1)).device(dev)
    bc_csr = transpose(g).device(dev)
    roots = torch.arange(8, dtype=torch.int32)
    outs, secs, iters = {}, {}, {}
    for name, fn in [
        ("pr", lambda st: apps.pagerank(dg, stats=st)),
        ("prd", lambda st: apps.pagerank_delta(dg, stats=st)),
        ("sssp", lambda st: apps.sssp(out_csr, 0, stats=st)),
        ("bc", lambda st: apps.bc_single_source(bc_csr, 0, stats=st)),
        ("radii", lambda st: apps.radii_estimate(dg, roots, stats=st)),
    ]:
        st = {}
        _sync(dev)
        t0 = time.perf_counter()
        outs[name] = fn(st)
        _sync(dev)
        secs[name] = time.perf_counter() - t0
        iters[name] = st["iters"]
    print(f"  [{label}] " + "  ".join(
        f"{k}={v * 1e3:.1f}ms/{iters[k]}it" for k, v in secs.items()))
    return outs, secs, iters


def main(dataset: str = "tw", scale: int = 13, device="cuda"):
    dev = devices.resolve(device)
    g = datasets.load(dataset, scale=scale)
    print(f"dataset {dataset}: {g.num_nodes} vertices {g.num_edges} edges, on {dev}")
    print("application runtimes (ms / iterations, after a device sync):")
    orig = run_apps(g, "original order", dev)
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))
    dbg = run_apps(g2, "DBG reordered", dev)

    print("LLC policy comparison per app (DBG + GRASP vs RRIP):")
    llc = datasets.scaled_llc_bytes(dataset, g2, elem_bytes=16)
    pm = cachesim.PerfModel()
    results, speedups = {}, {}
    for app in APPS:
        tr, _ = traces.generate_trace(g2, app, llc, max_records=600_000)
        rrip = cachesim.simulate(tr, "rrip", llc)
        grasp = cachesim.simulate(tr, "grasp", llc)
        results[app] = {"rrip": rrip, "grasp": grasp}
        speedups[app] = pm.speedup(rrip, grasp)
        print(f"  {app:6s} miss {rrip.miss_rate:.3f} -> {grasp.miss_rate:.3f} "
              f"speedup {speedups[app] - 1:+.1%}")
    return dict(graphs={"original": g, "dbg": g2},
                outputs={"original": orig[0], "dbg": dbg[0]},
                seconds={"original": orig[1], "dbg": dbg[1]},
                iters={"original": orig[2], "dbg": dbg[2]},
                results=results, speedups=speedups, llc_bytes=llc)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tw")
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--device", default=devices.DEFAULT_DEVICE)
    args = ap.parse_args()
    main(args.dataset, args.scale, args.device)
