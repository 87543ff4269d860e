"""The traced window: torch.profiler (CUPTI) over whole trials, reduced to
what the per-layer metrics read.

The profiler on the card loses a few kernels at the edges of a window, so
the window is padded on both sides with spin kernels (``torch.cuda._sleep``)
that the reduction leaves out. Each trial runs inside a
``record_function("gbench.trial.<k>")`` span of the benchmark's own; the
traced window runs from the first trial span's start to the last one's end,
and a device operation belongs to the trial whose span holds its start.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict

TRIAL_SPAN = "gbench.trial."
SPIN = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 100  # a kernel's name in the breakdown is cut to this many characters


def spin_pad() -> None:
    """Eight spin kernels and a synchronise."""
    import torch

    for _ in range(8):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def profiler(on_gpu: bool):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_gpu else []))


def chrome_events(prof) -> list[dict]:
    """The profiler's events as chrome-trace dicts (a file in ``TMPDIR``, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


@dataclasses.dataclass
class Op:
    name: str
    start: float  # seconds, on the trace's clock
    dur: float
    trial: int


@dataclasses.dataclass
class Trace:
    ops: list[Op]               # device operations in the window, spin kernels left out
    window_s: float
    busy_s: float               # time in which some device operation ran
    trial_busy_s: dict          # trial -> its busy seconds
    idle_gaps: list             # [(what the host was doing, seconds)], longest first

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for op in self.ops:
            total[op.name[:NAME_CHARS]] += op.dur
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

    def matching(self, pattern: str) -> list[Op]:
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op.name)]


def _busy(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy


class _HostStack:
    """The innermost host event in flight at increasing times, on one thread."""

    def __init__(self, events: list[dict]):
        self.events = sorted(events, key=lambda ev: (ev["ts"], -ev["dur"]))
        self.i, self.stack = 0, []

    def at(self, t: float) -> str:
        while self.i < len(self.events) and self.events[self.i]["ts"] <= t:
            ev = self.events[self.i]
            while self.stack and self.stack[-1]["ts"] + self.stack[-1]["dur"] <= ev["ts"]:
                self.stack.pop()
            self.stack.append(ev)
            self.i += 1
        while self.stack and self.stack[-1]["ts"] + self.stack[-1]["dur"] < t:
            self.stack.pop()
        names = [ev["name"] for ev in self.stack]
        return " > ".join(names[-2:]) if names else "python between ops"


def reduce(events: list[dict]) -> Trace:
    """Reduce a chrome trace of trials to a ``Trace``; raises if it holds no trial span."""
    spans = sorted((ev for ev in events if ev.get("ph") == "X"
                    and ev.get("cat") == "user_annotation"
                    and ev.get("name", "").startswith(TRIAL_SPAN)), key=lambda ev: ev["ts"])
    if not spans:
        raise RuntimeError("the trace holds no trial span")
    starts = [ev["ts"] for ev in spans]
    trial_of = [int(ev["name"][len(TRIAL_SPAN):]) for ev in spans]
    lo, hi = spans[0]["ts"], max(ev["ts"] + ev["dur"] for ev in spans)

    ops = []
    for ev in events:
        if (ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS
                or SPIN in ev.get("name", "") or not lo <= ev["ts"] <= hi):
            continue
        j = bisect.bisect_right(starts, ev["ts"]) - 1
        ops.append(Op(ev["name"], ev["ts"] * 1e-6, ev["dur"] * 1e-6, trial_of[j]))
    ops.sort(key=lambda op: op.start)
    by_trial = defaultdict(list)
    for op in ops:
        by_trial[op.trial].append((op.start, op.start + op.dur))

    host_tid = spans[0]["tid"]
    stack = _HostStack([ev for ev in events if ev.get("ph") == "X" and ev.get("tid") == host_tid
                        and ev.get("cat") in HOST_CATS])
    gaps, reach = defaultdict(float), lo * 1e-6
    for op in ops + [Op("end", hi * 1e-6, 0.0, -1)]:
        if op.start > reach:
            gaps[stack.at((reach + op.start) / 2 * 1e6)] += op.start - reach
        reach = max(reach, op.start + op.dur)
    return Trace(
        ops=ops,
        window_s=(hi - lo) * 1e-6,
        busy_s=_busy([(op.start, op.start + op.dur) for op in ops]),
        trial_busy_s={k: _busy(v) for k, v in by_trial.items()},
        idle_gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1]),
    )


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads: the trace, the program's counts and
    the benchmark's own counts of the graph and of the work."""

    trace: Trace
    iters: list[int]     # iterations of each traced trial (the apps' ``stats``)
    checked: dict        # checked trial -> the reference's [(active vertices, their edges)]
    num_nodes: int
    num_edges: int
    distinct_rows: int   # vertices that some edge reads (nonzero degree)
    edge_bytes: int      # the app's ``EDGE_BYTES``
