"""Skew-aware vertex reordering (paper Sec. II-E, IV-B).

Every technique returns ``rank`` with ``rank[old_id] = new_id`` such that
hotter vertices receive smaller new ids — after reordering the hottest
vertices occupy a contiguous *prefix* of the Property Array, which is what
GRASP's range-test classification relies on (paper Fig. 3(a)).

Implemented techniques (paper Sec. IV-B):
  - ``sort``     full degree-descending sort.
  - ``hubsort``  HubSort [Zhang et al.]: sorts only hot vertices into the
                 prefix; cold vertices keep their relative order.
  - ``dbg``      Degree-Based Grouping [Faldu et al.]: coarse degree
                 buckets, hottest bucket first, original order preserved
                 within each bucket (structure-preserving).
  - ``gorder_lite`` a BFS locality ordering followed by a DBG pass — the
                 paper's recipe for making Gorder GRASP-compatible
                 (Sec. V-C applies DBG *after* Gorder).
  - ``identity`` no reordering (baseline).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSR
from repro_torch.core.hotset import hot_mask, reuse_degree


def identity_order(degree: np.ndarray) -> np.ndarray:
    return np.arange(degree.shape[0], dtype=np.int64)


def sort_order(degree: np.ndarray) -> np.ndarray:
    """Descending-degree sort (stable so equal degrees keep structure)."""
    new_of_old = np.argsort(-degree, kind="stable")
    rank = np.empty_like(new_of_old)
    rank[new_of_old] = np.arange(degree.shape[0], dtype=np.int64)
    return rank


def hubsort_order(degree: np.ndarray) -> np.ndarray:
    n = degree.shape[0]
    hot = hot_mask(degree)
    hot_ids = np.nonzero(hot)[0]
    cold_ids = np.nonzero(~hot)[0]
    hot_sorted = hot_ids[np.argsort(-degree[hot_ids], kind="stable")]
    order = np.concatenate([hot_sorted, cold_ids])  # cold keeps orig order
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    return rank


def dbg_order(degree: np.ndarray, num_groups: int = 8) -> np.ndarray:
    """Degree-Based Grouping: log2-spaced degree buckets around the mean.

    Group boundary k holds vertices with degree in [avg * 2^(k-1), avg * 2^k);
    groups are laid out hottest-first; *within* a group the original vertex
    order is preserved, retaining community structure.
    """
    n = degree.shape[0]
    avg = max(degree.mean(), 1e-9)
    # group 0 = hottest (degree >= avg * 2^(num_groups-2)) ... last = coldest
    ratio = degree / avg
    with np.errstate(divide="ignore"):
        level = np.floor(np.log2(np.maximum(ratio, 1e-9))).astype(np.int64)
    # level >= 0 means degree >= avg (hot); clamp into num_groups buckets
    group = np.clip((num_groups - 2) - level, 0, num_groups - 1)
    order = np.argsort(group, kind="stable")  # stable keeps in-group order
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    return rank


def _bfs_order(g: CSR) -> np.ndarray:
    """Locality ordering: BFS from the highest-degree vertex (per component)."""
    n = g.num_nodes
    # BFS over the union of in/out adjacency so direction doesn't matter.
    deg = g.in_degree + g.out_degree
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    indptr, indices = g.indptr, g.indices
    dst = g.dst_ids()
    # out-adjacency built once (src -> list of dst) for forward traversal
    out_order = np.argsort(indices, kind="stable")
    out_dst = dst[out_order]
    out_counts = np.bincount(indices, minlength=n)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_counts, out=out_indptr[1:])
    seeds = np.argsort(-deg, kind="stable")
    si = 0
    while pos < n:
        while si < n and visited[seeds[si]]:
            si += 1
        frontier = np.array([seeds[si]], dtype=np.int64)
        visited[seeds[si]] = True
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            nbrs = []
            for v in frontier:
                nbrs.append(indices[indptr[v] : indptr[v + 1]])
                nbrs.append(out_dst[out_indptr[v] : out_indptr[v + 1]])
            if nbrs:
                cand = np.unique(np.concatenate(nbrs))
                cand = cand[~visited[cand]]
            else:
                cand = np.empty(0, dtype=np.int64)
            visited[cand] = True
            frontier = cand
    return order


def gorder_lite_order(g: CSR, degree: np.ndarray) -> np.ndarray:
    """BFS locality order + DBG pass (paper Sec. V-C Gorder+DBG recipe)."""
    bfs = _bfs_order(g)  # new -> old
    rank_bfs = np.empty_like(bfs)
    rank_bfs[bfs] = np.arange(g.num_nodes, dtype=np.int64)
    # DBG applied in BFS order: stable sort by degree bucket of the
    # BFS-reordered vertices, keeping BFS order within buckets.
    deg_in_bfs_order = degree[bfs]
    rank_dbg = dbg_order(deg_in_bfs_order)
    # old v -> bfs slot rank_bfs[v] -> final slot rank_dbg[rank_bfs[v]]
    return rank_dbg[rank_bfs]


def reorder_ranks(g: CSR, technique: str, direction: str = "pull") -> np.ndarray:
    """rank[old_id] = new_id for the requested technique."""
    degree = reuse_degree(g, direction)
    if technique == "identity":
        return identity_order(degree)
    if technique == "sort":
        return sort_order(degree)
    if technique == "hubsort":
        return hubsort_order(degree)
    if technique == "dbg":
        return dbg_order(degree)
    if technique == "gorder_lite":
        return gorder_lite_order(g, degree)
    raise ValueError(f"unknown reordering technique {technique!r}")


TECHNIQUES = ("identity", "sort", "hubsort", "dbg", "gorder_lite")


def reorder_cost_model(technique: str, num_nodes: int, num_edges: int) -> float:
    """Relative reordering cost in 'edge traversals' (paper Fig. 10(a)).

    Skew-aware techniques are O(N log N) or O(N); Gorder is orders of
    magnitude costlier (paper: avg −85.4% net speed-up). Used by the
    benchmark that reproduces Fig. 10(a) net speed-ups.
    """
    n, m = float(num_nodes), float(num_edges)
    return {
        "identity": 0.0,
        "sort": 2.0 * n * np.log2(max(n, 2)) / m,        # full sort
        "hubsort": 0.5 * n * np.log2(max(n, 2)) / m,     # sorts hot only
        "dbg": 2.0 * n / m,                              # linear pass
        "gorder_lite": 400.0,                            # Gorder: >>runtime
    }[technique]
