#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 gbench/run.py --workload kron25.prd --seed 7 --seconds 10 --trace 0

Set-up makes the cell's graph on the device from the configuration and the
seed, hands it to ``repro_torch`` and warms the app up with one
iteration-capped trial. The window then runs whole trials of the app back
to back, each ending in a synchronise, until ``--seconds`` have passed; the
trial in flight then is finished and counted. After the window, a sample of
the trials drawn from the seed (one of the first three, and the last) is
compared with the plain reference, each compared number against its limit
in ``gbench/limits/<cell>.json``.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics:
``gteps`` (directed edges of the graph times trials completed, over the
window's wall time), ``peak_gib`` (the allocator's peak over the window)
and ``setup_s`` (process start to the window's start). With ``--trace 1``
the window runs under torch.profiler and the metrics are the cell's
per-layer metrics, read by ``gbench/metrics/<name>.py``.

The last line of standard output is the result as one JSON object; the
compared numbers and their limits are also the last lines of standard
error. Exits non-zero without a result where there is no GPU, where the
cell asks for more GPUs than there are, or where JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "cache"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
K1_HOT_ROWS = 1 << 20  # K1's default hot tier (repro_torch/kernels/hot_gather/ops.py)
SAMPLE_FROM = 3  # one checked trial is drawn from the first three; the last is always checked


def set_environment() -> None:
    """Before torch loads: every kernel cache at a fixed path in the
    checkout, and an allocator that grows its segments (the graph's sorts
    leave large free blocks that would otherwise fragment)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"
    return out[0] if out else "nvidia-smi printed nothing"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0, overrides: dict | None = None, control: str | None = None,
             log=print) -> dict:
    """One run of cell ``workload``: returns the result's JSON object.

    ``overrides`` replaces keys of the configuration (the tests' small
    scales); ``control``, a torch dtype's name, puts the plain reference
    computed in that dtype in the program's place (``"bfloat16"``: the
    check's control).
    """
    import torch

    from gbench import graphs, spec
    from gbench import trace as tr
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg = {**spec.config(bench, cell["config"]), **(overrides or {})}
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    app_mod = spec.module("apps", traffic["app"])

    t = time.perf_counter()
    graph = graphs.make(cfg, seed, dev, weighted=app_mod.WEIGHTED)
    sync()
    make_s = time.perf_counter() - t
    n, e = graph.num_nodes, graph.num_edges
    hot = min(n, K1_HOT_ROWS)
    distinct_rows = int(((graph.indptr[1:] - graph.indptr[:-1]) > 0).sum())
    hot_share = int((graph.indices < hot).sum()) / e
    log(f"graph {cell['config']} (scale {cfg['scale']}) seed {seed}: N {n}, E {e} directed, "
        f"E/(32N) {e / (32 * n):.6f}, vertices with edges {distinct_rows}, made in "
        f"{make_s:.3f} s")
    log(f"K1 hot tier: rows [0, {hot}), share of gathers in it {hot_share:.6f}")
    if on_gpu:
        torch.cuda.empty_cache()

    app = app_mod.App(graph, traffic, dev)
    t = time.perf_counter()
    app.warm_up()
    sync()
    log(f"app: {app.describe()}; warm-up {time.perf_counter() - t:.3f} s")
    trial_fn = app.trial
    if control:
        trial_fn = lambda k, stats: app.control(k, getattr(torch, control))  # noqa: E731

    sample = random.Random(seed).randrange(SAMPLE_FROM)
    kept, iters = {}, []
    launches = hot_gather_hot_part.launches
    profiler = tr.profiler(on_gpu) if trace else contextlib.nullcontext()
    pad = tr.spin_pad if trace and on_gpu else (lambda: None)
    with profiler as prof:
        pad()
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        k = 0
        while True:
            stats = {}
            with torch.profiler.record_function(f"{tr.TRIAL_SPAN}{k}"):
                answer = trial_fn(k, stats)
                sync()
            end = time.perf_counter()
            iters.append(stats.get("iters", 0))
            last = end - start >= seconds
            if k == sample or last:
                kept[k] = answer.to("cpu")
            del answer
            k += 1
            if last:
                break
        window_s = end - start
        pad()
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    launches = hot_gather_hot_part.launches - launches
    log(f"window: {k} trials in {window_s:.6f} s, iterations per trial {iters}, "
        f"K1 launches {launches}")
    if forbidden_modules():
        raise SystemExit(f"loaded in the run: {', '.join(forbidden_modules())}")
    if on_gpu:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    refs = app.references(sorted(kept))
    numbers = {i: app.compare(kept[i], refs[i]) for i in sorted(kept)}
    log(f"reference: trials {sorted(kept)} in {time.perf_counter() - t:.3f} s")
    checks = {name: {"value": max(numbers[i][name] for i in numbers), "limit": limit}
              for name, limit in limits.items()}
    failed = sum(any(v[name] > limits[name] for name in limits) for v in numbers.values())
    correct = failed == 0 and all(set(v) == set(limits) for v in numbers.values())

    device_info = {"platform": "gpu" if on_gpu else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_gpu else dev.type,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": k, "failed": failed}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        trace_ = tr.reduce(tr.chrome_events(prof))
        reading = tr.Reading(trace=trace_, iters=iters,
                             checked={i: refs[i][1] for i in kept}, num_nodes=n, num_edges=e,
                             distinct_rows=distinct_rows, edge_bytes=app_mod.EDGE_BYTES)
        values = {m["name"]: spec.module("metrics", m["name"]).read(reading)
                  for m in spec.per_layer(bench, workload)}
        device_info.update(busy_s=trace_.busy_s, window_s=trace_.window_s)
        breakdown = {"device_ops": trace_.device_ops(), "idle_gaps": trace_.idle_gaps[:10]}
    else:
        measured = {"gteps": e * k / window_s / 1e9, "peak_gib": peak / 2**30,
                    "setup_s": setup_s}
        values = {m["name"]: measured[m["name"]] for m in spec.end_to_end(bench, workload)}
    result["metrics"] = {name: {"value": v, "unit": units[name]}
                         for name, v in values.items() if v is not None}
    result["device"] = device_info
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    import torch

    from gbench import spec

    t_imports = time.perf_counter() - T0

    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available():
        print("gbench: CUDA is not available; the benchmark runs only on a GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"gbench: {args.workload} needs {chips} GPUs, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")  # the CUDA context
    print(f"set-up: interpreter and imports {t_imports:.3f} s, CUDA context "
          f"{time.perf_counter() - T0 - t_imports:.3f} s", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      log=lambda s: print(s, flush=True))
    print(card_line(), flush=True)
    found = forbidden_modules()
    if found:
        print(f"gbench: loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
