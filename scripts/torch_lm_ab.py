"""Time the port's single-device LM paths of several trees on one card, in
turns, so that two versions are compared within one machine's run:

    python3 scripts/torch_lm_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout. Each runs in a process of its
own, in the order given, with that tree's ``src/`` and ``chip_smoke.py``:

- ``chip_smoke.lm_serve_full`` (phase 14 (a): minitron-8b served at its
  published width and depth; it prints decode and prefill ms by CUDA
  events and the device time of a decode step);
- ``chip_smoke.lm_train_full`` (phase 15 (a): the minitron-8b train step
  at 4 of 32 layers, 8 x 4,096 tokens; ms a step by CUDA events);
- ``tfm.decode_step`` on held bfloat16 weights (minitron-8b at full depth,
  batch 4, caches of 32,768 positions drawn from a seeded generator and
  filled to 32,000, as phase 16 (b)): ms a step by CUDA events, one
  warm-up then 5 steps.

The card's name and power limit are printed before and after. Each tree
builds nothing (these paths launch no kernel of the port).
"""
import os
import subprocess
import sys
import time

RUN = r'''
import os, statistics, sys
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as c
from repro_torch.configs.base import get_arch
from repro_torch.nn import transformer as tfm
from repro_torch.train.tree import tree_map

dev = torch.device("cuda", 0)
torch.empty(0, device=dev)  # the card's context, before its memory stats are read
print("tree", root, flush=True)
c.phase("14a", c.lm_serve_full, dev)
torch.cuda.empty_cache()
c.phase("15a", c.lm_train_full, dev)
torch.cuda.empty_cache()
cfg = get_arch("minitron-8b")
params = tree_map(lambda t: t.to(torch.bfloat16),
                  tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
torch.cuda.empty_cache()
gen = torch.Generator(device=dev).manual_seed(16)
kv = (cfg.n_layers, 4, 32768, cfg.n_kv, cfg.head_dim)
cache = tfm.KVCache(k=torch.randn(kv, generator=gen, dtype=torch.bfloat16, device=dev),
                    v=torch.randn(kv, generator=gen, dtype=torch.bfloat16, device=dev),
                    length=32000)
tok = torch.arange(4, device=dev, dtype=torch.int32) * 1000
ms = []
for i in range(6):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, cache = tfm.decode_step(params, cfg, cache, tok)
    end.record()
    torch.cuda.synchronize()
    if i:
        ms.append(start.elapsed_time(end))
print(f"decode on held bf16 weights, batch 4, 32k cache: ms {[round(x, 3) for x in ms]} "
      f"median {statistics.median(ms):.3f}", flush=True)
'''


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for root in argv:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(root)], env=env,
                           cwd=os.path.abspath(root))
        print(f"tree {root}: exit {r.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
        if r.returncode:
            return r.returncode
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
