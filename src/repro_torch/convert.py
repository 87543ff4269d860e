"""Carry the reference's state across: this system has no weights; its
state is the graph, the plan and the trace. Each builder takes the JAX
package's numpy fields (or any arrays of the same values) and returns the
port's object, with the dtypes the port's code expects."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cachesim import Trace
from repro_torch.core.plan import GraspPlan
from repro_torch.graph.csr import CSR


def csr_from_numpy(indptr, indices, num_nodes: int,
                   weights: Optional[np.ndarray] = None) -> CSR:
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    if indptr.shape != (num_nodes + 1,) or indptr[-1] != indices.shape[0]:
        raise ValueError("indptr must have num_nodes + 1 entries ending at len(indices)")
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
        if weights.shape != indices.shape:
            raise ValueError("weights must align with indices")
    return CSR(indptr=indptr, indices=indices, num_nodes=int(num_nodes), weights=weights)


def plan_from_fields(**fields) -> GraspPlan:
    """``GraspPlan`` from the reference plan's fields (``dataclasses.asdict``)."""
    return GraspPlan(**{k: int(v) for k, v in fields.items()})


def trace_from_numpy(line, hint, pc, region, nxt) -> Trace:
    arrays = dict(
        line=np.asarray(line, dtype=np.int64),
        hint=np.asarray(hint, dtype=np.int8),
        pc=np.asarray(pc, dtype=np.int32),
        region=np.asarray(region, dtype=np.int32),
        nxt=np.asarray(nxt, dtype=np.int64),
    )
    if len({a.shape for a in arrays.values()}) != 1:
        raise ValueError("trace arrays must share one length")
    return Trace(**arrays)
