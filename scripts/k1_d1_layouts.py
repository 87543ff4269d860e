#!/usr/bin/env python3
"""Time layouts of K1's d = 1 body against K1 itself.

    python3 scripts/k1_d1_layouts.py

Builds ``scripts/k1_d1_layouts.cu`` (eight layouts of the d = 1 gather,
f32) with the flags of ``repro_torch.kernels._build`` plus ``-Xptxas -v``,
and times each against K1 itself (``hot_gather_hot_part`` and
``hot_gather_two_tier`` of ``src/repro_torch/csrc/hot_gather.cu``) on
PageRank's gather: the DBG-reordered ``lj`` graph at
``chip_smoke.REAL_SCALE`` and the quickstart's ``tw`` at scale 13, with
the default hot region of min(N, 2^20) rows, in the hot-part mode (zeros
outside [0, H)) and the two-tier mode (the whole table). Every layout's
output is held bit for bit against K1's. Each time is the mean per launch
over 20 launches: the device time read with torch.profiler and the
CUDA-event time, in two rounds, the second in reverse order. Prints the
card line, ptxas's registers and spills, and one line per layout, mode,
graph and round, with the bound of chip_smoke.py's K1 entries.
Needs one NVIDIA GPU; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

LAYOUTS = {
    0: "grid-stride, 32 blocks/SM (earlier)",
    1: "1 edge a thread, one pass (as K1)",
    2: "2 edges a thread, interleaved",
    3: "4 edges a thread, interleaved",
    4: "8 edges a thread, interleaved",
    5: "4 consecutive, 16-byte idx/out",
    6: "8 consecutive, 2x16-byte idx/out",
    7: "1 edge a thread, no L2 hint",
}
NAN_BITS = 0x7FC00000


def build():
    from repro_torch.kernels import _build

    src = os.path.join(ROOT, "scripts", "k1_d1_layouts.cu")
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD / "libk1_d1_layouts.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}")
    for line in proc.stdout.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_void_p]
    so.run.restype = ctypes.c_int
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_d1_layouts: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.hot_gather.hot_gather import (
        hot_gather_hot_part,
        hot_gather_two_tier,
    )

    print(cs.card_line())
    so = build()
    dev = torch.device("cuda", 0)
    for label, name, scale in (("real-size pagerank", "lj", cs.REAL_SCALE),
                               ("quickstart", "tw", 13)):
        g = cs.dbg_graph(name, scale)
        idx = torch.as_tensor(g.indices).to(dev)
        n, e = g.num_nodes, idx.shape[0]
        h = min(n, 1 << 20)
        prop = torch.rand((n, 1), generator=torch.Generator().manual_seed(0)).to(dev)
        hot = prop[:h].contiguous()
        hits, rows = idx[(idx >= 0) & (idx < h)], idx[(idx >= 0) & (idx < n)]
        print(f"{label}: N={n} E={e} H={h}, {hits.numel() / e:.4f} of edges hot")
        modes = {
            "hot part": (hot, h, 0, lambda: hot_gather_hot_part(hot, idx), hits),
            "two-tier": (prop, n, NAN_BITS, lambda: hot_gather_two_tier(prop, idx, h), rows),
        }
        for mode, (table, n_rows, past, k1, used) in modes.items():
            bound_ms = cs.bound(e * 4 + e * 4 + torch.unique(used).numel() * 4)[0]
            want = k1()
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(v, out=out, table=table, n_rows=n_rows, past=past, stream=stream):
                rc = so.run(v, table.data_ptr(), idx.data_ptr(), out.data_ptr(), e, h, n_rows,
                            past, stream)
                if rc:
                    raise SystemExit(f"layout {v}: CUDA error {rc}")

            for v in LAYOUTS:
                out.zero_()
                launch(v)
                torch.cuda.synchronize()
                if not cs.same_bits(out, want):
                    raise SystemExit(f"{label} {mode}: layout {v} differs from K1")
            fns = {"K1 (hot_gather.cu)": k1}
            fns.update({LAYOUTS[v]: (lambda v=v: launch(v)) for v in LAYOUTS})
            for rnd, order in enumerate((list(fns), list(reversed(fns))), 1):
                for key in order:
                    dms = cs.device_ms(fns[key])
                    ems = cs.time_ms(fns[key])
                    dtxt = "not measured" if dms is None else f"{dms:.4f}"
                    print(f"{label} | {mode} | round {rnd} | {key:36s} | device ms {dtxt} | "
                          f"event ms {ems:.4f} | bound ms {bound_ms:.4f}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
