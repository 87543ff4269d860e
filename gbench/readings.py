#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, many seeds in
one process (the benchmark's own runs never run this).

    python3 gbench/readings.py --workload kron25.prd --seeds 1,2,3 --seconds 3
    python3 gbench/readings.py --workload kron25.prd --seeds 4,5,6 --seconds 3 --control bfloat16

Each seed is one run of ``run.run_cell`` with a short window: set-up from
the seed, trials back to back, the sampled trials compared with the
reference. Without ``--control`` the trials are the program's (the lower
readings); with it, the plain reference computed in that dtype stands in
the program's place (``bfloat16``: the control, the upper readings;
``float32``: a witness of what float32 arithmetic alone reads). Prints one
JSON line a seed with the compared numbers. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None, help="a torch dtype, e.g. bfloat16")
    args = ap.parse_args(argv)

    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(run.card_line(), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False, t0=time.perf_counter(),
                           control=args.control, log=lambda s: print(s, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.control or "repro_torch",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "gteps": res["metrics"].get("gteps", {}).get("value")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
