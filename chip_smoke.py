#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build the kernels from src/repro_torch/csrc/ with nvcc and print the
     card's name and power limit;
  2. K1 (hot gather) against its plain version on the card, bit for bit:
     the quickstart's PageRank (N,) f32 and step-5 (N, 8) f32, (N, 130)
     bf16, PageRank's (N,) f32 on the real-size graph, and the -1 / >= N /
     cold-overflow / 1-D semantics;
  3. K2 (fused gather + segment-sum) against its plain version
     (rtol = atol = 1e-5: the summation order differs), and its own path,
     the aligned pull sum, against the engine's pull;
  4. the quickstart pipeline (examples/quickstart_torch.main("cuda")) with
     PageRank through K1 and the paper's orderings;
  5. PageRank at real size (``lj`` at scale 22: 4.19M vertices) through K1
     against PageRank with the plain gather on the card, six runs of each.
Each path that reaches a kernel is driven with the kernel's launch count
set to 0 just before it and read just after. The kernels' times are taken
at each path's own shapes, weighted by its launches.
Then one JSON line of per-kernel numbers, the card line again, and the
final {"ok": true, ...} line. It exits non-zero, printing no result, when
CUDA is unavailable or the repository's sources are missing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
REAL_SCALE = 22               # lj: 4.19M vertices vs LiveJournal's 5M (paper Table V)
PR_ITERS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, what bounds it) on the H100 at its published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    """Equal values with NaN in the same places."""
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def dbg_graph(name: str, scale: int):
    from repro_torch.core.reorder import reorder_ranks
    from repro_torch.graph import datasets
    from repro_torch.graph.csr import apply_reorder

    g = datasets.load(name, scale=scale)
    return apply_reorder(g, reorder_ranks(g, "dbg"))


def check_k1(dev, qs_graph, real_graph) -> tuple[dict, dict]:
    """Hold K1 against its plain version, bit for bit, at each path's shapes.

    Returns the launch mix of each path that reaches K1, as
    ``{path: [(prop (N, d) on the card, hot_size, idx), ...]}``, and
    each path's largest error against the plain version."""
    import numpy as np
    import torch

    from repro_torch.core import make_plan
    from repro_torch.graph import datasets
    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    rng = np.random.default_rng(0)
    qs_idx = torch.as_tensor(qs_graph.indices).to(dev)
    n = qs_graph.num_nodes
    llc = datasets.scaled_llc_bytes("tw", qs_graph, elem_bytes=16)
    qs_hot = make_plan(n, 8 * 4, budget_bytes=llc).hot_size
    real_idx = torch.as_tensor(real_graph.indices).to(dev)
    real_n = real_graph.num_nodes
    # PageRank's gather takes ops.hot_gather's default hot region, min(N, 2^20)
    cases = {
        "quickstart": [
            ("quickstart pagerank (N,) f32",
             torch.as_tensor(rng.random((n, 1)), dtype=torch.float32), min(n, 1 << 20), qs_idx),
            ("quickstart step 5 (N,8) f32",
             torch.as_tensor(rng.random((n, 8)), dtype=torch.float32), qs_hot, qs_idx),
        ],
        "real-size pagerank": [
            ("real-size pagerank (N,) f32",
             torch.as_tensor(rng.random((real_n, 1)), dtype=torch.float32),
             min(real_n, 1 << 20), real_idx),
        ],
        None: [
            ("(N,130) bf16", torch.as_tensor(rng.standard_normal((n, 130)),
                                             dtype=torch.bfloat16), n // 4, qs_idx),
        ],
    }
    mixes, errs = {}, {}
    for path, path_cases in cases.items():
        errs[path] = 0.0
        for label, prop, h, idx in path_cases:
            prop = prop.to(dev)
            hot = prop[:h].contiguous()
            out = hot_gather_hot_part(hot, idx)
            plain = ref.hot_gather_ref(hot, idx)
            torch.cuda.synchronize()
            errs[path] = max(errs[path], float((out.float() - plain.float()).abs().max()))
            if not torch.equal(out, plain):
                fail(f"K1 {label}: differs from its plain version")
            print(f"K1 {label}: H={h} d={hot.shape[1]} E={idx.shape[0]} bit-identical")
            if path is not None:
                mixes.setdefault(path, []).append((prop, h, idx))

    # semantics probed on the JAX package: -1 -> zeros, >= N -> NaN,
    # cold past cold_capacity -> zeros; (N,) props give (E,)
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-1, 0, 1, 2, 5, 6, 3, 7], dtype=torch.int32)
    nan = float("nan")
    expect = {
        None: [[0, 0], [0, 1], [2, 3], [4, 5], [10, 11], [nan, nan], [6, 7], [nan, nan]],
        1: [[0, 0], [0, 1], [2, 3], [4, 5], [0, 0], [0, 0], [0, 0], [0, 0]],
    }
    for cap, rows in expect.items():
        want = torch.tensor(rows, dtype=torch.float32)
        got = ops.hot_gather(table.to(dev), idx.to(dev), hot_size=2, cold_capacity=cap).cpu()
        if not same_bits(got, want):
            fail(f"K1 semantics, cold_capacity={cap}: {got.tolist()}")
        got1 = ops.hot_gather(table[:, 1].contiguous().to(dev), idx.to(dev), hot_size=2,
                              cold_capacity=cap).cpu()
        if got1.shape != (8,) or not same_bits(got1, want[:, 1]):
            fail(f"K1 1-D semantics, cold_capacity={cap}: {got1.tolist()}")
    print("K1 semantics (-1, >= N, cold overflow, 1-D): as the JAX package")
    return mixes, errs


def k1_numbers(path: str, mix: list, counts: list[int], err: float) -> dict:
    """K1's numbers on one path: per-launch times and bound, each the mean
    over the path's launches, which run ``counts[i]`` times at ``mix[i]``."""
    import torch

    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    total = sum(counts)
    res = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, op_ms=0.0)
    nbytes, shapes = 0.0, []
    for (prop, h, idx), k in zip(mix, counts):
        hot, w = prop[:h].contiguous(), k / total
        e, d, s = idx.shape[0], prop.shape[1], prop.element_size()
        hits = idx[(idx >= 0) & (idx < h)]
        nbytes += w * (e * 4 + e * d * s + torch.unique(hits).numel() * d * s)
        res["ms"] += w * time_ms(lambda: hot_gather_hot_part(hot, idx))
        res["plain_ms"] += w * time_ms(lambda: ref.hot_gather_ref(hot, idx))
        res["library_ms"] += w * time_ms(lambda: torch.index_select(prop, 0, idx))
        res["op_ms"] += w * time_ms(lambda: ops.hot_gather(prop, idx, hot_size=h))
        shapes.append(f"{k} x hot ({h}, {d}) of N={prop.shape[0]} {str(prop.dtype)[6:]}, "
                      f"E={e}, {hits.numel() / e:.4f} of edges hot")
    res["bound_ms"], res["bound_by"] = bound(nbytes)
    res.update(max_abs_err=err, launches=total, shape="; ".join(shapes))
    print(f"K1 timing on {path} ({res['shape']}), per launch: kernel {res['ms']:.4f} ms, "
          f"plain {res['plain_ms']:.4f} ms, index_select of the full table "
          f"{res['library_ms']:.4f} ms, ops.hot_gather (K1 + cold fixup) {res['op_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.4f} ms")
    return res


def check_k2(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.apps.engine import edge_map_pull
    from repro_torch.graph import generate
    from repro_torch.kernels.hot_gather import ops, ref
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_segment_sum

    tile_e, spt, d = 2048, 256, 8
    g = generate.uniform(20, 6, seed=0)
    idx_np, seg_np, n_pad = ops.build_aligned_edges(g.indptr, g.indices, spt, tile_e)
    if idx_np.shape[0] // tile_e * spt != n_pad:
        fail("K2: the uniform graph's layout spills tiles (the reference would reject it)")
    idx, seg = torch.as_tensor(idx_np).to(dev), torch.as_tensor(seg_np).to(dev)
    rng = np.random.default_rng(1)
    prop = torch.as_tensor(rng.standard_normal((g.num_nodes, d)), dtype=torch.float32).to(dev)
    err = 0.0
    for label, hot in (("f32 all hot", prop), ("bf16 hot half", prop[: g.num_nodes // 2]
                                                 .to(torch.bfloat16).contiguous())):
        out = hot_gather_segment_sum(hot, idx, seg, n_pad, tile_e, spt)
        plain = ref.gather_segment_sum_ref(hot, idx, seg, n_pad, tile_e, spt)
        torch.cuda.synchronize()
        if not torch.allclose(out, plain, rtol=1e-5, atol=1e-5):
            fail(f"K2 {label}: differs from its plain version")
        err = max(err, float((out - plain).abs().max()))
        print(f"K2 {label}: {n_pad} segments, {idx.shape[0] // tile_e} tiles, "
              f"max abs err {err:.3e}")

    # K2's own path: the aligned pull sum, held against the engine's pull
    dg = g.device(dev)
    hot_gather_segment_sum.launches = 0
    fused = ops.hot_gather_segsum_aligned(prop, idx, seg, n_pad, spt, tile_e=tile_e)
    launches = hot_gather_segment_sum.launches
    pulled = edge_map_pull(dg, prop, gather_impl="plain")
    if not torch.allclose(fused[: g.num_nodes], pulled, rtol=1e-5, atol=1e-5):
        fail("K2 path: the aligned pull sum differs from edge_map_pull")
    if launches < 1:
        fail("K2 path: the aligned pull sum did not launch K2")
    print(f"K2 path (aligned pull sum) matches edge_map_pull, launches {launches}")

    hits = idx[idx >= 0]
    e = idx.shape[0]
    bound_ms, bound_by = bound(e * 8 + torch.unique(hits).numel() * d * 4 + n_pad * d * 4,
                               hits.numel() * d)
    adj = torch.sparse_coo_tensor(
        torch.stack([seg[idx >= 0].long(), hits.long()]),
        torch.ones(hits.numel(), device=dev), (n_pad, g.num_nodes)).coalesce().to_sparse_csr()
    res = dict(
        ms=time_ms(lambda: hot_gather_segment_sum(prop, idx, seg, n_pad, tile_e, spt)),
        plain_ms=time_ms(lambda: ref.gather_segment_sum_ref(prop, idx, seg, n_pad, tile_e, spt)),
        library_ms=time_ms(lambda: torch.sparse.mm(adj, prop)),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, launches=launches,
        shape=f"uniform scale 20 degree 6, hot ({g.num_nodes}, {d}) f32, E={e} padded",
    )
    print(f"K2 timing at {res['shape']}: kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, torch.sparse.mm {res['library_ms']:.4f} ms, "
          f"bound {bound_ms:.4f} ms")
    return res


def run_quickstart(dev) -> int:
    import numpy as np

    import quickstart_torch
    from repro_torch import apps
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    hot_gather_hot_part.launches = 0
    out = quickstart_torch.main(str(dev))
    launches = hot_gather_hot_part.launches
    r = out["results"]
    pr = out["pagerank"]
    print(f"quickstart: K1 launches {launches}")
    if launches < 1:
        fail("quickstart: PageRank did not go through K1")
    if not (r["grasp"].misses < r["rrip"].misses < r["lru"].misses):
        fail("quickstart: GRASP < RRIP < LRU misses does not hold")
    if not r["opt"].misses < r["grasp"].misses:
        fail("quickstart: OPT < GRASP misses does not hold")
    if not out["speedup"] > 1.0:
        fail(f"quickstart: speed-up proxy {out['speedup']} <= 1")
    if out["gather_err"] != 0.0:
        fail(f"quickstart: hot_gather differs from index_select by {out['gather_err']}")
    g2 = dbg_graph("tw", 13)
    cpu = apps.pagerank(g2.device("cpu")).numpy()
    if pr.shape != (g2.num_nodes,) or not np.isfinite(pr).all() or abs(pr.sum() - 1) > 1e-3:
        fail("quickstart: PageRank is not a finite distribution of the expected shape")
    if not np.allclose(pr, cpu, rtol=1e-5, atol=1e-7):
        fail(f"quickstart: PageRank on the card differs from the CPU run by "
             f"{np.abs(pr - cpu).max():.3e}")
    print(f"quickstart: orderings hold, speed-up proxy {out['speedup']:.4f}, PageRank "
          f"matches the CPU run (max abs diff {np.abs(pr - cpu).max():.3e})")
    return launches


def run_real_pagerank(dev, g2) -> int:
    """PageRank at real size through K1 against the plain gather, in turns
    hot, plain, plain, hot, three times over. Returns K1's launches in one
    run through K1."""
    import statistics

    import torch

    from repro_torch import apps
    from repro_torch.kernels.hot_gather.hot_gather import hot_gather_hot_part

    base = torch.cuda.memory_allocated(dev)  # earlier phases' tensors, not counted
    dg = g2.device(dev)
    apps.pagerank(dg, tol=0.0, max_iters=1)  # warm-up of both routes
    apps.pagerank(dg, tol=0.0, max_iters=1, gather_impl="plain")
    runs = {"hot": [], "plain": []}
    launches = {"hot": set(), "plain": set()}
    ranks = {}
    for impl in ("hot", "plain", "plain", "hot") * 3:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        hot_gather_hot_part.launches = 0
        t0 = time.perf_counter()
        ranks[impl] = apps.pagerank(dg, tol=0.0, max_iters=PR_ITERS, gather_impl=impl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PR_ITERS
        launches[impl].add(hot_gather_hot_part.launches)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        runs[impl].append(ms)
        print(f"pagerank real size, {impl} gather: {ms:.4f} ms/iteration, peak device "
              f"memory of the graph and PageRank {peak:.3f} GiB, K1 launches "
              f"{hot_gather_hot_part.launches}")
    for impl, ms in runs.items():
        print(f"pagerank real size, {impl} gather over {len(ms)} runs: ms/iteration min "
              f"{min(ms):.4f} median {statistics.median(ms):.4f} max {max(ms):.4f}")
    if launches["plain"] != {0}:
        fail(f"real-size PageRank with the plain gather launched K1: {launches['plain']}")
    if len(launches["hot"]) != 1 or min(launches["hot"]) < 1:
        fail(f"real-size PageRank did not go through K1 once per run alike: {launches['hot']}")
    hot, plain = ranks["hot"], ranks["plain"]
    diff = float((hot - plain).abs().max())
    rel = float(((hot - plain).abs() / plain.abs().clamp(min=1e-30)).max())
    total = float(hot.sum())
    if not torch.isfinite(hot).all() or abs(total - 1) > 1e-3:
        fail(f"real-size PageRank is not a finite distribution (sum {total})")
    if diff > 1e-6 or rel > 1e-4:
        fail(f"real-size PageRank through K1 differs from the plain gather: abs {diff:.3e} "
             f"rel {rel:.3e}")
    print(f"pagerank real size: {g2.num_nodes} vertices, {g2.num_edges} edges, {PR_ITERS} "
          f"iterations; K1 vs plain gather max abs diff {diff:.3e}, max rel diff {rel:.3e}")
    return launches["hot"].pop()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.build("hot_gather")
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    t0 = time.perf_counter()
    qs_graph = dbg_graph("tw", 13)
    real_graph = dbg_graph("lj", REAL_SCALE)
    print(f"graphs: lj scale {REAL_SCALE} has {real_graph.num_nodes} vertices, "
          f"{real_graph.num_edges} edges ({time.perf_counter() - t0:.1f} s on the host)")

    k1_mix, k1_err = check_k1(dev, qs_graph, real_graph)
    k2 = check_k2(dev)
    qs_launches = run_quickstart(dev)
    real_launches = run_real_pagerank(dev, real_graph)

    # the quickstart launches K1 once per PageRank iteration, then once in step 5
    k1_qs = k1_numbers("quickstart", k1_mix["quickstart"], [qs_launches - 1, 1],
                       k1_err["quickstart"])
    k1_real = k1_numbers("real-size pagerank", k1_mix["real-size pagerank"], [real_launches],
                         k1_err["real-size pagerank"])
    source = "src/repro_torch/csrc/hot_gather.cu"
    k1_tpu = "src/repro/kernels/hot_gather/hot_gather.py:26"
    kernels = [
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="quickstart", **k1_qs),
        dict(name="hot_gather", route="cuda", source=source, replaces=k1_tpu,
             path="real-size pagerank", **k1_real),
        dict(name="gather_segsum", route="cuda", source=source,
             replaces="src/repro/kernels/hot_gather/hot_gather.py:58",
             path="aligned pull sum", **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
