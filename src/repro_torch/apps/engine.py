"""Ligra-like vertex-centric engine (paper Sec. II-B, IV-A).

Pull-based: every active destination gathers its in-neighbours' properties
and reduces them. Push-based: every active source scatters its property to
its out-neighbours. Both are expressed as edge-parallel segment reductions
over the COO-ordered edge list — the layer the ``hot_gather`` kernel plugs
into.

Direction switching (Ligra's push/pull heuristic) selects pull when the
active frontier covers more than ``switch_fraction`` of edges.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.graph.csr import DeviceCSR
from repro_torch.kernels.hot_gather import ops as hot_ops

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
    # empty segments: +inf (floats) or the dtype's max, as jax.ops.segment_min
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

    ``gather_impl='hot'`` routes through the two-tier hot-region kernel
    (``repro_torch.kernels.hot_gather``, K1 plus the cold fixup); 'plain' is
    one ``index_select``. ``prop`` may be ``(N,)`` or ``(N, d)``.
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
    """
    msgs = gather_src(g, prop, gather_impl)
    if edge_fn is not None:
        msgs = edge_fn(msgs, g)
    if active_dst is not None:
        mask = active_dst[g.dst]
        shape = (-1,) + (1,) * (msgs.dim() - 1)
        msgs = torch.where(mask.reshape(shape), msgs, identity)
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
    msgs = prop.index_select(0, g.dst)
    if edge_fn is not None:
        msgs = edge_fn(msgs, g)
    if active_src is not None:
        mask = active_src[g.dst]
        shape = (-1,) + (1,) * (msgs.dim() - 1)
        msgs = torch.where(mask.reshape(shape), msgs, identity)
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
