#!/usr/bin/env python3
"""Time layouts of K3's inner loop against K3 itself at MIND's serve_bulk.

    python3 scripts/k3_layouts.py

Builds ``scripts/k3_layouts.cu`` (layouts of the hot embedding bag at
d = 64 f32: lanes a bag, slices a lane, row loads issued before their adds,
branches or predicated loads, a register cap, how the L2 policy is given;
and the earlier kernel) with the
flags of ``repro_torch.kernels._build`` plus ``-Xptxas -v``, and times each
against K3 itself (``hot_bag_hot_part`` and ``hot_bag_two_tier`` of
``src/repro_torch/csrc/embedding_bag.cu``) on ``chip_smoke.py``'s
``serve_bulk`` bags: 262,144 Zipf-1.1 histories of 50 with a 0.9 mask
over the 2^21 x 64 f32 MIND item table, the L2-sized hot prefix. Every
layout's output is held bit for bit against K3's plain version in the same
mode (the earlier kernel only in the hot-part mode). Each time is the mean per
launch over 20 launches, device time by torch.profiler and CUDA-event time,
in two rounds, the second in reverse order. Prints the card line, ptxas's
registers and spills, and one line per layout, mode and round. Needs one
NVIDIA GPU; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# variant of k3_layouts.cu's run(): lanes a bag x slices a lane, loads in flight
VARIANTS = {
    0: "earlier K3 (16 lanes, 1 position at a time, hot part only)",
    1: "16 lanes, 1 in flight, branches",
    2: "16 lanes, 2 in flight, branches",
    3: "16 lanes, 4 in flight, branches",
    4: "16 lanes, 8 in flight, branches (as K3)",
    5: "16 lanes, 2 in flight, predicated",
    6: "16 lanes, 4 in flight, predicated",
    7: "16 lanes, 8 in flight, predicated",
    8: "16 lanes, 4 in flight, predicated, >= 6 blocks/SM",
    9: "16 lanes, 8 in flight, branches, >= 4 blocks/SM",
    10: "8 lanes x 2 slices, 2 in flight, predicated",
    11: "8 lanes x 2 slices, 4 in flight, predicated",
    12: "4 lanes x 4 slices, 2 in flight, predicated",
    13: "4 lanes x 4 slices, 1 in flight, predicated",
    14: "16 lanes, 1 in flight, branches, evict_last for every row",
    15: "16 lanes, 1 in flight, branches, no L2 hint",
    16: "16 lanes, 8 in flight, branches, evict_last for every row",
    17: "16 lanes, 8 in flight, branches, no L2 hint",
    18: "16 lanes, 8 in flight, predicated hot and cold loads, one policy each",
    19: "16 lanes, 4 in flight, predicated hot and cold loads, one policy each",
    20: "16 lanes, 2 in flight, predicated hot and cold loads, one policy each",
    21: "4 lanes x 4 slices, 1 in flight, predicated hot and cold loads, one policy each",
    22: "8 lanes x 2 slices, 2 in flight, predicated hot and cold loads, one policy each",
    23: "16 lanes, run-time loop, no branches, unroll 1",
    24: "16 lanes, run-time loop, no branches, unroll 2",
    25: "16 lanes, run-time loop, no branches, unroll 4",
    26: "16 lanes, run-time loop, no branches, unroll 8",
    27: "16 lanes, run-time loop, no branches, unroll 4, >= 8 blocks/SM",
    28: "16 lanes, run-time loop, no branches, unroll 8, >= 8 blocks/SM",
    29: "lean: 16 lanes, unroll 2",
    30: "lean: 16 lanes, unroll 4",
    31: "lean: 16 lanes, unroll 8",
    32: "lean: 16 lanes, unroll 4, >= 8 blocks/SM",
    33: "lean: 8 lanes x 2 slices, unroll 2",
    34: "lean: 8 lanes x 2 slices, unroll 4",
    35: "lean: 8 lanes x 2 slices, unroll 4, >= 6 blocks/SM",
    36: "lean: 4 lanes x 4 slices, unroll 2",
    37: "lean2: 16 lanes, unroll 1",
    38: "lean2: 16 lanes, unroll 2",
    39: "lean2: 16 lanes, unroll 4",
    40: "lean2: 16 lanes, unroll 2, >= 6 blocks/SM",
    41: "lean2: 16 lanes, unroll 4, >= 8 blocks/SM",
    42: "lean2: 8 lanes x 2 slices, unroll 2",
    43: "lean2: 8 lanes x 2 slices, unroll 1",
    44: "lean: 16 lanes, unroll 2, cold rows evict_last",
    45: "lean: 16 lanes, unroll 2, cold rows evict_normal",
    46: "lean: 16 lanes, unroll 1, cold rows evict_last",
    47: "lean: 16 lanes, unroll 4, cold rows evict_last",
    48: "lean: 8 lanes x 2 slices, unroll 2, cold rows evict_last",
}


def build():
    from repro_torch.kernels import _build

    src = os.path.join(ROOT, "scripts", "k3_layouts.cu")
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD / "libk3_layouts.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}")
    for line in proc.stdout.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    so.run.restype = ctypes.c_int
    return so


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs.base import RECSYS_SHAPES, get_arch
    from repro_torch.core.plan import default_budget_bytes, entries_for_budget
    from repro_torch.data.pipeline import zipf_ids
    from repro_torch.kernels.embedding_bag import embedding_bag as k3
    from repro_torch.kernels.embedding_bag import ref
    from repro_torch.nn import recsys

    if not torch.cuda.is_available():
        print("k3_layouts: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    so = build()
    dev = torch.device("cuda", 0)
    cfg = get_arch("mind")
    items = recsys.init(torch.Generator().manual_seed(0), cfg, device=dev)["items"]
    v = items.shape[0]
    hot_size = entries_for_budget(default_budget_bytes(), cfg.embed_dim * 4, max_entries=v)
    rng = np.random.default_rng(2)
    shape = (RECSYS_SHAPES["serve_bulk"].batch, cfg.hist_len)
    ids = torch.as_tensor(zipf_ids(rng, shape, cfg.n_items, a=1.1)).to(dev)
    mask = torch.as_tensor(rng.random(shape) < 0.9).to(dev)
    b, hlen = shape
    stream = torch.cuda.current_stream().cuda_stream
    modes = {  # mode: (table, H, V, nan_past_v, K3's launch, its plain version)
        "hot part": (items[:hot_size], hot_size, hot_size, 0,
                     lambda: k3.hot_bag_hot_part(items[:hot_size], ids, mask),
                     ref.hot_bag_ref(items[:hot_size], ids, mask)),
        "two-tier": (items, hot_size, v, 1,
                     lambda: k3.hot_bag_two_tier(items, ids, mask, hot_size),
                     ref.hot_bag_two_tier_ref(items, ids, mask, hot_size)),
    }
    runs = {}
    for mode, (table, h, n, nan, landed, plain) in modes.items():
        if not chip_smoke.same_bits(landed(), plain):
            raise SystemExit(f"K3 {mode}: differs from its plain version")
        runs[mode, "K3 (embedding_bag.cu)"] = landed
        for var, label in VARIANTS.items():
            if var == 0 and mode != "hot part":
                continue
            out = torch.empty((b, cfg.embed_dim), dtype=torch.float32, device=dev)

            def fn(var=var, table=table, h=h, n=n, nan=nan, out=out):
                rc = so.run(var, table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                            out.data_ptr(), b, hlen, h, n, nan, stream)
                if rc:
                    raise SystemExit(f"variant {var}: CUDA error {rc}")
                return out

            fn()
            torch.cuda.synchronize()
            if not chip_smoke.same_bits(out, plain):
                raise SystemExit(f"variant {var} ({label}), {mode}: differs from K3's plain "
                                 f"version by {float((out - plain).nan_to_num().abs().max())}")
            runs[mode, label] = fn
        del plain
    print(f"all layouts bit-identical to K3's plain versions; serve_bulk {b} x {hlen}, "
          f"hot {hot_size} of {v} rows")
    order = list(runs)
    for rnd, keys in enumerate((order, order[::-1]), 1):
        for mode, label in keys:
            fn = runs[mode, label]
            dev_ms = chip_smoke.device_ms(fn)
            print(f"round {rnd} | {mode} | {label} | device "
                  f"{chip_smoke.fmt_ms(dev_ms)} | event {chip_smoke.time_ms(fn):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
