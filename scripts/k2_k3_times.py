#!/usr/bin/env python3
"""Time K2 (fused gather + segment-sum) and K3 (hot embedding bag) of one
tree of the port on the card.

    python3 scripts/k2_k3_times.py [--root DIR]

``DIR`` (default: this checkout) is the root of a tree of the port, for
instance an earlier commit unpacked with ``git archive`` under ``build/``;
its kernels are built from its own sources, so two trees can be compared in
one run on one card, in turns. The inputs are made from fixed seeds, the
same for every tree, at ``chip_smoke.py``'s shapes: K2 at the aligned pull
sum (``uniform`` scale 20, degree 6, d = 8 f32), K3 at MIND's
``serve_bulk`` (262,144 Zipf-1.1 bags of 50 over the 2^21 x 64 f32 item
table, the L2-sized hot prefix). For each kernel entry the tree has (K3's
two-tier mode only where it exists) and for the route ``ops.hot_bag`` it
prints event-timed ms, device ms by torch.profiler and host microseconds
per call, then one JSON line with all of them and the card line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (the timing helpers; it imports no part of the port)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="root of the tree of the port to time")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_k3_times: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import RECSYS_SHAPES, get_arch
    from repro_torch.core.plan import default_budget_bytes, entries_for_budget
    from repro_torch.data.pipeline import zipf_ids
    from repro_torch.graph import generate
    from repro_torch.kernels.embedding_bag import embedding_bag as k3
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.hot_gather import hot_gather as k1k2
    from repro_torch.kernels.hot_gather import ops as gather_ops
    from repro_torch.nn import recsys

    import repro_torch
    if not repro_torch.__file__.startswith(root):
        raise SystemExit(f"imported {repro_torch.__file__}, not the tree under {root}")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"tree {root}; {card}")
    res = {"root": root, "card": card}

    def entry(name, fn, reps=20, calls=200):
        t = chip_smoke.timed("", fn, reps, calls)
        res[name] = t
        print(f"{name}: {t['ms']:.4f} ms (device {chip_smoke.fmt_ms(t['device_ms'])}, host "
              f"{t['host_us']:.2f} us/call)")

    tile_e, spt, d = 2048, 256, 8
    g = generate.uniform(20, 6, seed=0)
    idx_np, seg_np, n_pad = gather_ops.build_aligned_edges(g.indptr, g.indices, spt, tile_e)
    idx, seg = torch.as_tensor(idx_np).to(dev), torch.as_tensor(seg_np).to(dev)
    prop = torch.as_tensor(np.random.default_rng(1).standard_normal((g.num_nodes, d)),
                           dtype=torch.float32).to(dev)
    entry("k2", lambda: k1k2.hot_gather_segment_sum(prop, idx, seg, n_pad, tile_e, spt))

    cfg = get_arch("mind")
    items = recsys.init(torch.Generator().manual_seed(0), cfg, device=dev)["items"]
    hot_size = entries_for_budget(default_budget_bytes(), cfg.embed_dim * 4,
                                  max_entries=cfg.n_items)
    rng = np.random.default_rng(2)
    shape = (RECSYS_SHAPES["serve_bulk"].batch, cfg.hist_len)
    ids = torch.as_tensor(zipf_ids(rng, shape, cfg.n_items, a=1.1)).to(dev)
    mask = torch.as_tensor(rng.random(shape) < 0.9).to(dev)
    hot = items[:hot_size]
    entry("k3_hot_part", lambda: k3.hot_bag_hot_part(hot, ids, mask))
    if hasattr(k3, "hot_bag_two_tier"):
        entry("k3_two_tier", lambda: k3.hot_bag_two_tier(items, ids, mask, hot_size))
    entry("op_hot_bag", lambda: bag_ops.hot_bag(items, ids, mask, hot_size=hot_size),
          reps=10, calls=20)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
