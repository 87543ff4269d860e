"""Trace-driven set-associative LLC simulator.

The simulator is a strict per-record scan over the access trace: a
sequential loop on the host over numpy arrays, one policy step per record
(see ``policies`` for why records cannot be split by set). It never touches
the card, on any machine.

Outputs per run: hits/misses, and hit/miss counts split by GRASP Reuse
Hint — the latter reproduces the paper's Fig. 2 style access/miss
classification and validates that wins come from the Property Array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policies import INF, CacheCfg, get_policy


@dataclasses.dataclass(frozen=True)
class Trace:
    """One application ROI's LLC access stream (host numpy arrays)."""

    line: np.ndarray    # (T,) int64 cache-line ids (global)
    hint: np.ndarray    # (T,) int8 GRASP 2-bit Reuse Hint
    pc: np.ndarray      # (T,) int32 synthetic PC signature
    region: np.ndarray  # (T,) int32 16KB-region signature (SHiP-MEM)
    nxt: np.ndarray     # (T,) int64 next access time of the same line (INF if none)

    @property
    def length(self) -> int:
        return int(self.line.shape[0])


def compute_next_use(line: np.ndarray) -> np.ndarray:
    """Vectorized next-occurrence times (Belady preprocessing)."""
    t = line.shape[0]
    order = np.lexsort((np.arange(t), line))
    sorted_line = line[order]
    nxt = np.full(t, INF, dtype=np.int64)
    same = sorted_line[1:] == sorted_line[:-1]
    nxt[order[:-1][same]] = order[1:][same]
    return nxt


def finalize_trace(line, hint, pc, region_bytes_shift: int = 14, line_bytes: int = 64) -> Trace:
    line = np.asarray(line, dtype=np.int64)
    region = (line * line_bytes) >> region_bytes_shift
    return Trace(
        line=line,
        hint=np.asarray(hint, dtype=np.int8),
        pc=np.asarray(pc, dtype=np.int32),
        region=region.astype(np.int32),
        nxt=compute_next_use(line),
    )


@dataclasses.dataclass(frozen=True)
class SimResult:
    policy: str
    accesses: int
    hits: int
    hits_by_hint: np.ndarray   # (4,)
    accesses_by_hint: np.ndarray

    @property
    def misses(self) -> int:
        return self.accesses - self.hits

    @property
    def miss_rate(self) -> float:
        return self.misses / max(self.accesses, 1)

    def misses_by_hint(self) -> np.ndarray:
        return self.accesses_by_hint - self.hits_by_hint


def simulate(trace: Trace, policy: str, llc_bytes: int, ways: int = 16,
             line_bytes: int = 64) -> SimResult:
    """Run one policy over one trace. LLC geometry from byte size."""
    init_fn, step_fn = get_policy(policy)
    lines = llc_bytes // line_bytes
    num_sets = max(lines // ways, 1)
    if num_sets & (num_sets - 1):
        raise ValueError(f"num_sets={num_sets} must be a power of two")
    cfg = CacheCfg(num_sets=num_sets, ways=ways,
                   n_pcs=int(trace.pc.max()) + 1,
                   n_regions=int(trace.region.max()) + 1)
    state = init_fn(cfg)

    line = trace.line.astype(np.int32).tolist()
    hint = trace.hint.astype(np.int32).tolist()
    pc = trace.pc.tolist()
    region = trace.region.tolist()
    nxt = np.minimum(trace.nxt, INF).astype(np.int32).tolist()
    hits = [0, 0, 0, 0]
    for t in range(trace.length):
        h = hint[t]
        if step_fn(cfg, state, line[t], h, pc[t], region[t], nxt[t], t):
            hits[h] += 1

    hits_by_hint = np.asarray(hits, dtype=np.int32)
    return SimResult(
        policy=policy,
        accesses=trace.length,
        hits=int(hits_by_hint.sum()),
        hits_by_hint=hits_by_hint,
        accesses_by_hint=np.bincount(trace.hint, minlength=4).astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Speed-up proxy model (paper reports wall-clock speed-ups from a cycle
# simulator; we map miss-rate deltas through a memory-latency model).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PerfModel:
    """t = t_compute + accesses*(hit*L_llc + miss*L_mem).

    ``mem_fraction`` calibrates how memory-bound the app is at the baseline
    (graph analytics: ~0.7-0.8 of time in memory stalls; this reproduces
    the paper's ~6.4% miss reduction -> ~5.2% speed-up ratio).
    """

    llc_hit_cycles: float = 30.0
    mem_cycles: float = 200.0
    mem_fraction: float = 0.75

    def runtime(self, base: SimResult, res: SimResult) -> float:
        def mem_time(r: SimResult) -> float:
            return r.hits * self.llc_hit_cycles + r.misses * self.mem_cycles

        base_mem = mem_time(base)
        compute = base_mem * (1.0 - self.mem_fraction) / self.mem_fraction
        return compute + mem_time(res)

    def speedup(self, base: SimResult, res: SimResult) -> float:
        return self.runtime(base, base) / self.runtime(base, res)
