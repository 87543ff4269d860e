"""Serving CLI — a thin front-end over ``repro_torch.serve.engine``.

    # MIND candidate scoring through the GRASP embedding cache on a
    # zipf-skewed stream with deadlines + shed load, on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine recsys \\
        --requests 256 --qps 2000 --budget-kb 256 --json /tmp/serve.json

    # the same on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --engine recsys --device cpu

The flags are the JAX package's. ``--smoke`` is on whatever the command
line says (``store_true`` with ``default=True``, as there), so this CLI
always serves the reduced MIND; full width is reached through
``serve.engine.run_recsys_stream``. ``--engine lm`` and ``--gateway`` wait
for later slices of the port (ROADMAP.md, "Modules to port") and raise.

All real logic lives in ``repro_torch.serve``; this module only parses
flags and prints/emits the metrics snapshot.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", choices=("lm", "recsys"), default="lm")
    ap.add_argument("--gateway", default=None, metavar="HOST:PORT",
                    help="serve over the RPC front-end instead of running a "
                         "local loop (not ported yet)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="gateway mode: save the GRASP cache state here on "
                         "drain and warm-restore it on startup")
    ap.add_argument("--no-supervise", action="store_true",
                    help="gateway mode: disable the pump supervisor")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    # lm flags
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    # recsys flags
    ap.add_argument("--qps", type=float, default=2000.0)
    ap.add_argument("--budget-kb", type=int, default=256,
                    help="device cache budget for the embedding cache")
    ap.add_argument("--hot-frac", type=float, default=0.5,
                    help="share of the budget pinned (0 = unpinned baseline)")
    ap.add_argument("--policy", choices=("rrpv", "lru"), default="rrpv")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="queue deadline; the local recsys loop defaults to 50ms")
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--candidates", type=int, default=32)
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--json", default=None, help="write metrics snapshot here")
    ap.add_argument("--device", default="cuda",
                    help="device of the cache's blocks and the forward (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.gateway:
        raise NotImplementedError(
            "--gateway: the gateway is not ported yet (ROADMAP.md, modules to port: "
            "gateway + chaos)")
    if args.engine == "lm":
        raise NotImplementedError(
            "--engine lm: the LM stack is not ported yet (ROADMAP.md, modules to port: "
            "the LM/train/launch stack)")

    from repro_torch.configs import base as cfgs
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import StreamConfig, run_recsys_stream
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = cfgs.get_arch("mind")
    if args.smoke:
        cfg = cfgs.reduced(cfg)
    deadline_ms = 50.0 if args.deadline_ms is None else args.deadline_ms
    snap = run_recsys_stream(
        cfg,
        CacheConfig(budget_bytes=args.budget_kb << 10,
                    hot_fraction=args.hot_frac, policy=args.policy),
        SchedulerConfig(max_batch=args.batch, max_queue=args.max_queue,
                        default_deadline_s=deadline_ms / 1e3),
        StreamConfig(requests=args.requests, qps=args.qps,
                     candidates=args.candidates, zipf_a=args.zipf_a,
                     deadline_s=deadline_ms / 1e3),
        device=args.device,
    )
    c, lat = snap["counters"], snap["latency"]
    e2e = lat.get("e2e", {})
    print(f"[serve:recsys] {c.get('completed', 0)}/{snap['config']['requests']}"
          f" served, shed={c.get('shed', 0)} rejected={c.get('rejected', 0)}; "
          f"cache hit={snap['hit_rate']:.1%} "
          f"(hot={c.get('hot_hits', 0)} cold={c.get('cold_hits', 0)} "
          f"miss={c.get('misses', 0)}); "
          f"e2e p50={e2e.get('p50_s', 0)*1e3:.1f}ms "
          f"p99={e2e.get('p99_s', 0)*1e3:.1f}ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    return snap


if __name__ == "__main__":
    main()
