"""Make a cell's graph on the device: GAP's recipe, then DBG.

The edge multiset comes from the configuration alone (its generator, drawn
from ``dataset_seed``), so every run's seed gets the same graph and the
same work: the seed draws the vertex labels (Graph500 permutes them at
random after generating), and so the order the work is laid out in. From
the generated pairs:

1. self-loops are dropped and each undirected edge is kept once (GAP's
   symmetrised, deduplicated graphs);
2. where the configuration asks for weights, each undirected edge draws one
   integer weight in ``[low, high]`` from ``dataset_seed``, the same in both
   directions (GAP's weighting of its synthetic graphs);
3. the labels are permuted from ``seed``;
4. the vertices are renumbered by Degree-Based Grouping (the GRASP paper,
   Sec. IV-B): ``dbg_rank`` is a copy of the rule, made offline as the
   paper makes it;
5. both directions of every edge are sorted into an in-edge CSR of int32
   arrays. The graph is symmetric, so it is its own out-edge CSR too.

All of it runs in torch on ``device`` from ``torch.Generator``s on that
device, in a few large calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gbench import spec


@dataclasses.dataclass
class Graph:
    num_nodes: int
    indptr: torch.Tensor            # (N + 1,) int32
    indices: torch.Tensor           # (E,) int32: source of each edge, rows by destination
    dst: torch.Tensor               # (E,) int32: destination of each edge
    weights: Optional[torch.Tensor]  # (E,) float32 or None
    final_of_orig: torch.Tensor     # (N,) int64: the id a generated vertex ends up with

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def dbg_rank(degree: torch.Tensor, num_groups: int = 8) -> torch.Tensor:
    """``rank[old] = new`` by Degree-Based Grouping: group k holds the
    degrees in ``[avg * 2**(num_groups - 2 - k), avg * 2**(num_groups - 1 - k))``
    (the first group everything above, the last everything below), groups
    hottest first, the old order kept inside a group."""
    deg = degree.to(torch.float64)
    avg = max(float(deg.mean()), 1e-9)
    level = torch.floor(torch.log2(torch.clamp(deg / avg, min=1e-9))).to(torch.int64)
    group = torch.clamp((num_groups - 2) - level, 0, num_groups - 1)
    order = torch.sort(group, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def undirected(src: torch.Tensor, dst: torch.Tensor, scale: int) -> torch.Tensor:
    """The distinct undirected non-loop edges as sorted int64 keys ``lo << scale | hi``."""
    lo, hi = torch.minimum(src, dst).long(), torch.maximum(src, dst).long()
    keep = lo != hi
    key = (lo[keep] << scale) | hi[keep]
    del lo, hi, keep
    return torch.unique_consecutive(torch.sort(key).values)


def make(cfg: dict, seed: int, device: torch.device, weighted: bool) -> Graph:
    """The graph of configuration ``cfg`` under run seed ``seed``, with
    weights where ``weighted`` (``cfg["weights"]`` gives their range)."""
    scale = cfg["scale"]
    n, mask = 1 << scale, (1 << scale) - 1
    data_gen = torch.Generator(device=device).manual_seed(cfg["dataset_seed"])
    src, dst = spec.module("generators", cfg["generator"]).edges(cfg, data_gen, device)
    key = undirected(src, dst, scale)
    del src, dst
    lo, hi = key >> scale, key & mask
    del key
    w = None
    if weighted:
        low, high = cfg["weights"]["low"], cfg["weights"]["high"]
        w = torch.randint(low, high + 1, lo.shape, generator=data_gen, device=device,
                          dtype=torch.int32).to(torch.float32)
    degree = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)

    run_gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(n, generator=run_gen, device=device)  # generated id -> label
    deg_by_label = torch.empty_like(degree)
    deg_by_label[perm] = degree
    final_of_orig = dbg_rank(deg_by_label, cfg["dbg_groups"])[perm]
    del perm, deg_by_label, degree

    lo, hi = final_of_orig[lo], final_of_orig[hi]
    # both directions, keyed destination-major: rows of the in-edge CSR
    key = torch.cat([(hi << scale) | lo, (lo << scale) | hi])
    del lo, hi
    key, order = torch.sort(key)
    weights = None if w is None else torch.cat([w, w])[order]
    del order, w
    indices = (key & mask).to(torch.int32)
    dst_ids = (key >> scale).to(torch.int32)
    del key
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(dst_ids, minlength=n), 0)
    return Graph(num_nodes=n, indptr=indptr.to(torch.int32), indices=indices, dst=dst_ids,
                 weights=weights, final_of_orig=final_of_orig)
