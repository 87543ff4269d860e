"""LLC access-trace generation from graph-application iterations.

Models the paper's Sec. II-C access anatomy for one pull (or push) ROI
iteration: for every active destination vertex the engine streams the
Vertex Array entry, touches the destination's Property element, then for
each in-edge streams the Edge Array entry and gathers the source vertex's
Property element. An L1-filter drops consecutive same-line accesses per
instruction stream (the paper notes the streaming arrays' spatial locality
is filtered by L1-D, leaving streaming/irregular patterns at the LLC).

Synthetic PC signatures (paper's Hawkeye/Leeway analysis hinges on the same
PC touching hot and cold vertices alike):
  pc 0 = source-property gather   (the irregular hot path)
  pc 1 = Edge Array stream
  pc 2 = Vertex Array stream
  pc 3 = destination-property access
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.plan import GraspPlan, make_plan
from repro_torch.core.regions import DEFAULT
from repro_torch.graph.csr import CSR, transpose
from repro_torch.core.cachesim import Trace, finalize_trace

LINE = 64


@dataclasses.dataclass(frozen=True)
class AppTraceSpec:
    """Trace-shape parameters per paper application (Tables III & IV)."""

    name: str
    direction: str          # dominant ROI direction (paper Sec. IV-C)
    active_fraction: float  # fraction of vertices active in the ROI iteration
    elem_bytes: int         # Property element size after array merging
    num_prop_arrays: int    # arrays GRASP must track (paper: at most two)


APPS = {
    "pr": AppTraceSpec("pr", "pull", 1.0, 16, 1),      # merged rank pair
    "prd": AppTraceSpec("prd", "pull", 0.45, 16, 1),   # delta-active subset
    "sssp": AppTraceSpec("sssp", "push", 0.35, 8, 1),  # Bellman-Ford push
    "bc": AppTraceSpec("bc", "pull", 0.6, 16, 2),      # BFS kernel + sigma
    "radii": AppTraceSpec("radii", "pull", 1.0, 8, 2), # 64-bit visit masks
}


def _l1_filter(line: np.ndarray, pc: np.ndarray) -> np.ndarray:
    """Keep mask dropping consecutive same-line accesses per PC stream."""
    keep = np.ones(line.shape[0], dtype=bool)
    for p in np.unique(pc):
        pos = np.nonzero(pc == p)[0]
        if pos.size > 1:
            keep[pos[1:]] = line[pos[1:]] != line[pos[:-1]]
    return keep


def generate_trace(
    g: CSR,
    app: str,
    llc_bytes: int,
    plan: Optional[GraspPlan] = None,
    seed: int = 0,
    hints_enabled: bool = True,
    max_records: int = 6_000_000,
) -> tuple[Trace, GraspPlan]:
    """Build the LLC trace of one ROI iteration of ``app`` over ``g``.

    ``g`` must already be reordered by the technique under test (the trace
    simply reflects whatever vertex placement it is given). Returns the
    trace and the GraspPlan used for hint classification.
    """
    spec = APPS[app]
    work = g if spec.direction == "pull" else transpose(g)
    n = work.num_nodes
    indptr, indices = work.indptr, work.indices

    if plan is None:
        plan = make_plan(n, spec.elem_bytes, budget_bytes=llc_bytes,
                         num_arrays=spec.num_prop_arrays)

    rng = np.random.default_rng(seed)
    if spec.active_fraction >= 1.0:
        act = np.arange(n, dtype=np.int64)
    else:
        mask = rng.random(n) < spec.active_fraction
        act = np.nonzero(mask)[0]

    deg = (indptr[act + 1] - indptr[act]).astype(np.int64)
    rec_per = 2 + 2 * deg
    if rec_per.sum() > max_records:  # cap ROI length, keep traversal prefix
        cut = np.searchsorted(np.cumsum(rec_per), max_records)
        act, deg, rec_per = act[:cut], deg[:cut], rec_per[:cut]
    total = int(rec_per.sum())
    starts = np.cumsum(rec_per) - rec_per

    prop_bytes = n * spec.elem_bytes
    edge_base = ((prop_bytes + LINE - 1) // LINE) * LINE
    vert_base = edge_base + ((work.num_edges * 4 + LINE - 1) // LINE) * LINE

    line = np.empty(total, dtype=np.int64)
    pc = np.empty(total, dtype=np.int8)

    # vertex-array + destination-property records at each row start
    line[starts] = (vert_base + act * 4) // LINE
    pc[starts] = 2
    line[starts + 1] = (act * spec.elem_bytes) // LINE
    pc[starts + 1] = 3

    # per-edge records
    row = np.repeat(np.arange(act.shape[0]), deg)
    k = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(deg) - deg, deg
    )
    edge_global = np.repeat(indptr[act], deg) + k
    src = indices[edge_global].astype(np.int64)
    slot = starts[row] + 2 + 2 * k
    line[slot] = (edge_base + edge_global * 4) // LINE
    pc[slot] = 1
    line[slot + 1] = (src * spec.elem_bytes) // LINE
    pc[slot + 1] = 0

    keep = _l1_filter(line, pc)
    line, pc = line[keep], pc[keep]

    # GRASP hints: range classification of property addresses; everything
    # else in a graph app is Low-Reuse (paper Sec. III-B). hints_enabled
    # False models the "ABRs not set" default (non-graph application).
    if hints_enabled:
        byte_addr = line * LINE
        hint = plan.regions().classify(byte_addr)
        hint = np.where((pc == 1) | (pc == 2), np.int8(2), hint)
    else:
        hint = np.full(line.shape[0], DEFAULT, dtype=np.int8)

    return finalize_trace(line, hint, pc), plan
