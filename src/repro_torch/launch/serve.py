"""Serving CLI — a thin front-end over ``repro_torch.serve.engine``.

    # MIND candidate scoring through the GRASP embedding cache on a
    # zipf-skewed stream with deadlines + shed load, on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine recsys \\
        --requests 256 --qps 2000 --budget-kb 256 --json /tmp/serve.json

    # the same on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --engine recsys --device cpu

    # put the engine behind the repro_torch.gateway RPC front-end (serves
    # until Ctrl-C, then drains gracefully); --device cpu off the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine recsys \
        --gateway 127.0.0.1:8077
    curl -s -XPOST localhost:8077/v1/score \
        -d '{"hist": [1,2,3], "candidates": [4,5]}'

The flags are the JAX package's. ``--smoke`` is on whatever the command
line says (``store_true`` with ``default=True``, as there), so this CLI
always serves the reduced MIND; full width is reached through
``serve.engine.run_recsys_stream`` and ``serve.engine.RecsysServeEngine``.
``--engine lm`` waits for the LM slice of the port (ROADMAP.md, "Modules
to port") and raises, with or without ``--gateway``.

All real logic lives in ``repro_torch.serve``/``repro_torch.gateway``; this
module only parses flags and prints/emits the metrics snapshot.
"""
from __future__ import annotations

import argparse
import json


def _run_gateway(args):
    """Build the recsys engine on ``--device``, wrap it in a pump, and
    serve until interrupted; Ctrl-C triggers the graceful drain protocol.

    On the card the kernels are built and the forward warmed up before the
    server (and its supervisor) starts, so neither an ``nvcc`` build nor
    the first allocations can be taken for a wedged pump."""
    import torch

    from repro_torch import devices
    from repro_torch.configs import base as cfgs
    from repro_torch.gateway import EnginePump, GatewayServer
    from repro_torch.nn import recsys as recsys_mod
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import RecsysServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig

    dev = devices.resolve(args.device)
    host, _, port = args.gateway.rpartition(":")
    # best-effort unless a deadline was asked for explicitly
    deadline_s = None if args.deadline_ms is None else args.deadline_ms / 1e3
    sched = SchedulerConfig(max_batch=args.batch, max_queue=args.max_queue,
                            default_deadline_s=deadline_s)
    cfg = cfgs.get_arch("mind")
    if args.smoke:
        cfg = cfgs.reduced(cfg)
    params = recsys_mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    engine = RecsysServeEngine(
        params, cfg,
        CacheConfig(budget_bytes=args.budget_kb << 10,
                    hot_fraction=args.hot_frac, policy=args.policy),
        sched, device=dev)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.load("hot_gather")
    engine.warmup(candidates=args.candidates)

    server = GatewayServer({"score": EnginePump(engine, "score")},
                           host=host or "127.0.0.1", port=int(port),
                           supervise=not args.no_supervise,
                           snapshot_dir=args.snapshot_dir).start()
    warm = ""
    if args.snapshot_dir:
        warm = (" (warm cache restore)" if engine.metrics.counters.get(
            "snapshot_restores") else " (cold start)")
    print(f"[gateway] {args.engine} engine on {server.url} "
          f"(/v1/score, /healthz, /metrics; {dev}){warm} — Ctrl-C to drain and stop",
          flush=True)
    try:
        while True:
            server._thread.join(3600.0)
    except KeyboardInterrupt:
        print("[gateway] draining...", flush=True)
        server.stop()
        snap = engine.metrics.snapshot()
        c = snap["counters"]
        print(f"[gateway] stopped: completed={c.get('completed', 0)} "
              f"shed={c.get('shed', 0)} rejected={c.get('rejected', 0)}", flush=True)
        return snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", choices=("lm", "recsys"), default="lm")
    ap.add_argument("--gateway", default=None, metavar="HOST:PORT",
                    help="serve over the repro_torch.gateway RPC front-end "
                         "instead of running a local loop")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="gateway mode: save the GRASP cache state here on "
                         "drain and warm-restore it on startup")
    ap.add_argument("--no-supervise", action="store_true",
                    help="gateway mode: disable the pump supervisor "
                         "(dead pump threads then stay dead)")
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
                    help="queue deadline; the local recsys loop defaults to "
                         "50ms, gateway mode to best-effort")
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--candidates", type=int, default=32)
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--json", default=None, help="write metrics snapshot here")
    ap.add_argument("--device", default="cuda",
                    help="device of the cache's blocks and the forward (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.engine == "lm":
        raise NotImplementedError(
            "--engine lm: the LM stack is not ported yet (ROADMAP.md, modules to port: "
            "the LM/train/launch stack)")
    if args.gateway:
        return _run_gateway(args)

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
