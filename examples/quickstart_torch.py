"""Quickstart on PyTorch/CUDA: the paper's pipeline through ``repro_torch``.

Generate a power-law graph, apply DBG reordering, run PageRank through the
vertex-centric engine (its per-edge gather through the GRASP hot-gather
kernel), and compare LLC policies on the resulting access trace.

    PYTHONPATH=src python examples/quickstart_torch.py          # on the card
    PYTHONPATH=src python examples/quickstart_torch.py cpu      # plain versions
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import apps
from repro_torch.core import cachesim, make_plan
from repro_torch.core.reorder import reorder_ranks
from repro_torch.graph import datasets, traces
from repro_torch.graph.csr import apply_reorder


def main(device="cuda"):
    # 1. a scaled stand-in for the paper's Twitter dataset
    g = datasets.load("tw", scale=13)
    print(f"graph: {g.num_nodes} vertices, {g.num_edges} edges")

    # 2. skew-aware reordering (DBG) — hot vertices become a prefix
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))

    # 3. run PageRank through the engine (per-edge gather: hot-gather kernel)
    dg = g2.device(device)
    pr = apps.pagerank(dg).cpu().numpy()
    print(f"pagerank: sum={pr.sum():.4f}, top vertex rank={pr.max():.2e}")

    # 4. GRASP: LLC trace of the iteration + policy comparison
    llc = datasets.scaled_llc_bytes("tw", g2, elem_bytes=16)
    tr, plan = traces.generate_trace(g2, "pr", llc)
    print(f"LLC={llc//1024}KB  hot region={plan.hot_size} vertices  "
          f"trace={tr.length} accesses")
    results = {}
    for policy in ("lru", "rrip", "grasp", "opt"):
        r = cachesim.simulate(tr, policy, llc)
        results[policy] = r
        print(f"  {policy:6s} miss rate {r.miss_rate:.3f}")
    pm = cachesim.PerfModel()
    speedup = pm.speedup(results['rrip'], results['grasp'])
    print(f"GRASP speed-up over RRIP (proxy): {speedup-1:+.1%}")

    # 5. the same gather through the hot-gather kernel
    from repro_torch.kernels.hot_gather import ops as hg

    prop = torch.as_tensor(np.random.default_rng(0).random((g2.num_nodes, 8)),
                           dtype=torch.float32).to(dg.indices.device)
    kplan = make_plan(g2.num_nodes, 8 * 4, budget_bytes=llc)
    out = hg.hot_gather(prop, dg.indices, hot_size=kplan.hot_size)
    ref = prop.index_select(0, dg.indices)
    err = float((out - ref).abs().max())
    print(f"hot_gather kernel max err vs reference: {err:.2e}")
    return dict(pagerank=pr, results=results, speedup=speedup, gather_err=err,
                trace_length=tr.length)


if __name__ == "__main__":
    main(*sys.argv[1:2])
