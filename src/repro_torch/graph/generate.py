"""Synthetic graph generators.

The paper evaluates on large natural (power-law) graphs. We generate scaled
RMAT graphs (Chakrabarti et al., SDM'04 — the paper's ``kr``/``uni``
citations) that preserve the skew statistics the paper depends on
(Table I: 9–26% hot vertices covering 81–93% of edges). Randomness is
``np.random.default_rng(seed)``, so a seed gives the same graph as the JAX
package's generator.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSR, from_edges


def rmat(
    scale: int,
    avg_degree: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> CSR:
    """Graph500-style RMAT generator, fully vectorized.

    ``scale`` = log2(num_nodes); default (a,b,c,d) are the Graph500
    parameters yielding a high-skew power-law degree distribution.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for bit in range(scale):
        go_right_src = rng.random(m) > ab  # choose bottom half for src bit
        p_dst = np.where(go_right_src, c_norm, a_norm)
        go_right_dst = rng.random(m) > (1.0 - p_dst)  # bottom half for dst
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    # permute vertex labels so degree is NOT correlated with vertex id —
    # this mirrors real datasets where hot vertices are scattered in the id
    # space (the paper's "lack of spatial locality" problem).
    perm = rng.permutation(n)
    return from_edges(perm[src], perm[dst], n)


def uniform(scale: int, avg_degree: int, seed: int = 0) -> CSR:
    """Uniform-random (no-skew) graph — the paper's adversarial ``uni``."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return from_edges(src, dst, n)


def add_uniform_weights(g: CSR, seed: int = 0, low: float = 1.0, high: float = 64.0) -> CSR:
    rng = np.random.default_rng(seed)
    w = rng.uniform(low, high, g.num_edges).astype(np.float32)
    return CSR(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes, weights=w)


def two_level_example() -> CSR:
    """The paper's Fig. 1 example graph (6 vertices), for unit tests."""
    # edges (src -> dst) as drawn: P2 and P5 are the high out-degree hubs.
    edges = [
        (2, 1), (5, 1), (0, 1),
        (2, 3), (5, 3), (4, 3),
        (1, 0), (2, 0),
        (5, 4), (2, 4),
        (3, 5), (0, 5),
        (5, 2),
    ]
    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])
    return from_edges(src, dst, 6)
