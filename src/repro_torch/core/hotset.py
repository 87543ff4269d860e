"""Hot-vertex identification (paper Sec. II-A, Table I).

A vertex is *hot* when its degree is >= the average degree. For pull-based
computation reuse of Property[v] is proportional to v's **out**-degree; for
push-based it is the **in**-degree (paper Sec. II-C).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSR


@dataclasses.dataclass(frozen=True)
class SkewStats:
    """Reproduces a column of the paper's Table I."""

    hot_fraction: float       # % of vertices classified hot
    edge_coverage: float      # % of edges connected to hot vertices
    num_hot: int
    avg_degree: float


def hot_mask(degree: np.ndarray) -> np.ndarray:
    """Boolean mask: degree >= average degree (the paper's definition)."""
    avg = degree.mean()
    return degree >= avg


def skew_stats(degree: np.ndarray) -> SkewStats:
    mask = hot_mask(degree)
    total_edges = degree.sum()
    cov = float(degree[mask].sum() / max(total_edges, 1))
    return SkewStats(
        hot_fraction=float(mask.mean()),
        edge_coverage=cov,
        num_hot=int(mask.sum()),
        avg_degree=float(degree.mean()),
    )


def reuse_degree(g: CSR, direction: str = "pull") -> np.ndarray:
    """Degree that predicts Property-array reuse for a traversal direction."""
    if direction == "pull":
        return g.out_degree
    if direction == "push":
        return g.in_degree
    raise ValueError(f"unknown direction {direction!r}")
