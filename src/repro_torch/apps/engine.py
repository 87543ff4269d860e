"""Ligra-like vertex-centric engine (paper Sec. II-B, IV-A).

Pull-based: every active destination gathers its in-neighbours' properties
and reduces them. Push-based: every active source scatters its property to
its out-neighbours. Both are expressed as edge-parallel segment reductions
over the COO-ordered edge list — the layer the ``hot_gather`` kernel plugs
into.

Direction switching (Ligra's push/pull heuristic) selects pull when the
active frontier covers more than ``switch_fraction`` of edges.

Reductions: ``sum_reduce`` is ``index_add_``. In ``edge_map_pull`` with
``reduce_fn=sum_reduce``, (E,) float32 messages on the card are summed
instead by the hand-written segment-sum kernel (``kernels/segment_sum``) over
the in-CSR's rows: only there are the ids known to be ``g.dst``, sorted, with
``g.indptr`` as their offsets. It makes no atomic and repeats bit for bit,
but sums in another order than ``index_add_``. On the CPU, and for (E, d)
messages, the pull keeps ``index_add_``; so do ``sum_reduce``'s other
callers, whose ids are not sorted: the out-degree sums of PageRank and
PageRank-Delta over ``g.indices`` and both of BC's sums.

``min_reduce`` sends (E,) float32 messages with int32 ids to the segment-min
kernel (``kernels/segment_min``; its plain version on the CPU), and every
other input, int64 ids included, to ``scatter_reduce_``, as ``max_reduce``
and ``or_reduce`` are. A minimum has no order, so either route gives the
reference's bits.

Under torch.profiler each edge map opens two spans (``repro_torch.spans``):
``engine.gather`` around producing the messages and ``engine.reduce``
around their reduction, so a kernel is put down to the layer that launched
it whatever its name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import spans
from repro_torch.graph.csr import DeviceCSR
from repro_torch.kernels.hot_gather import ops as hot_ops
from repro_torch.kernels.segment_min.segment_min import segment_min
from repro_torch.kernels.segment_sum.segment_sum import segment_sum

Reducer = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def sum_reduce(data, seg, n):
    return data.new_zeros((n,) + tuple(data.shape[1:])).index_add_(0, seg, data)


def _scatter_reduce(data, seg, n, reduce: str, empty):
    """Segment min/max; segments with no element hold ``empty``."""
    out = torch.full((n,) + tuple(data.shape[1:]), empty, dtype=data.dtype, device=data.device)
    index = seg.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, reduce=reduce, include_self=True)


def _extreme(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def min_reduce(data, seg, n):
    # empty segments: +inf (floats) or the dtype's max, as jax.ops.segment_min;
    # (E,) float32 messages with int32 ids go to the segment-min kernel, which
    # skips the +inf ones
    if data.dtype == torch.float32 and data.dim() == 1 and seg.dtype == torch.int32:
        return segment_min(data, seg, n)
    return _scatter_reduce(data, seg, n, "amin", _extreme(data.dtype, high=True))


def max_reduce(data, seg, n):
    # empty segments: -inf (floats) or the dtype's min, as jax.ops.segment_max
    return _scatter_reduce(data, seg, n, "amax", _extreme(data.dtype, high=False))


def or_reduce(data, seg, n):
    # segment max of the values cast to uint32 (empty segments: 0); computed
    # in int64 because scatter_reduce has no uint32 kernel
    wide = data.to(torch.int64) & 0xFFFFFFFF
    return _scatter_reduce(wide, seg, n, "amax", 0).to(torch.uint32)


def gather_src(g: DeviceCSR, prop: torch.Tensor, gather_impl: str = "hot") -> torch.Tensor:
    """prop[src] for every edge — THE hot path the paper targets.

    ``gather_impl='hot'`` routes through the hot-region kernel
    (``repro_torch.kernels.hot_gather.ops.hot_gather``: one two-tier K1
    launch over hot and cold rows); 'plain' is one ``index_select``.
    ``prop`` may be ``(N,)`` or ``(N, d)``.
    """
    if gather_impl == "plain":
        return prop.index_select(0, g.indices)
    if gather_impl == "hot":
        return hot_ops.hot_gather(prop, g.indices)
    raise ValueError(gather_impl)


def edge_map_pull(
    g: DeviceCSR,
    prop: torch.Tensor,
    active_dst: Optional[torch.Tensor] = None,
    edge_fn: Optional[Callable] = None,
    reduce_fn: Reducer = sum_reduce,
    identity: float = 0.0,
    gather_impl: str = "hot",
) -> torch.Tensor:
    """For each vertex v: reduce(edge_fn(prop[src]) for src in in_nbrs(v)).

    ``active_dst`` masks destinations (inactive vertices receive
    ``identity``). Messages into inactive vertices are replaced by the
    identity before the reduction, matching Ligra's edgeMap semantics.
    With ``sum_reduce``, (E,) float32 messages on the card are summed over
    ``g``'s rows by the segment-sum kernel (``g.indptr`` must be int32).
    """
    with spans.span("engine.gather"):
        msgs = gather_src(g, prop, gather_impl)
        if edge_fn is not None:
            msgs = edge_fn(msgs, g)
        if active_dst is not None:
            mask = active_dst[g.dst]
            shape = (-1,) + (1,) * (msgs.dim() - 1)
            msgs = torch.where(mask.reshape(shape), msgs, identity)
    with spans.span("engine.reduce"):
        if (reduce_fn is sum_reduce and msgs.is_cuda and msgs.dtype == torch.float32
                and msgs.dim() == 1):
            return segment_sum(msgs, g.indptr, g.num_nodes)
        return reduce_fn(msgs, g.dst, g.num_nodes)


def edge_map_push(
    g: DeviceCSR,
    prop: torch.Tensor,
    active_src: Optional[torch.Tensor] = None,
    edge_fn: Optional[Callable] = None,
    reduce_fn: Reducer = min_reduce,
    identity: float = float("inf"),
) -> torch.Tensor:
    """Push along out-edges. ``g`` must be the out-edge CSR (``transpose``):
    for an out-CSR, ``indices`` = destination of each out-edge and ``dst`` =
    the pushing source. Messages flow source -> destination. The source
    gather is a plain ``index_select``, as in the JAX package."""
    with spans.span("engine.gather"):
        msgs = prop.index_select(0, g.dst)
        if edge_fn is not None:
            msgs = edge_fn(msgs, g)
        if active_src is not None:
            mask = active_src[g.dst]
            shape = (-1,) + (1,) * (msgs.dim() - 1)
            msgs = torch.where(mask.reshape(shape), msgs, identity)
    with spans.span("engine.reduce"):
        return reduce_fn(msgs, g.indices, g.num_nodes)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    switch_fraction: float = 0.05  # Ligra's |frontier edges| / |E| threshold
    gather_impl: str = "hot"


def choose_direction(g: DeviceCSR, active: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """True -> pull (dense frontier), False -> push (sparse frontier)."""
    deg = torch.diff(g.indptr)
    frontier_edges = torch.where(active, deg, 0).sum()
    return frontier_edges > cfg.switch_fraction * g.indices.shape[0]
