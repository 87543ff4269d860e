"""Scaled stand-ins for the paper's graph datasets (paper Table V).

Real datasets span 68M–2.1B edges; each dataset is represented by an
RMAT/uniform graph whose *skew statistics* (hot-vertex fraction, edge
coverage — paper Table I) match the original's regime. ``load(name,
scale=...)`` raises the scale toward the original's size (``lj`` at scale
22 has 4.2M vertices against LiveJournal's 5M). The LLC size used by the
simulator is scaled by the same footprint ratio (see ``scaled_llc_bytes``),
keeping the paper's "hot footprint exceeds LLC" operating point.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

from repro_torch.graph.csr import CSR
from repro_torch.graph import generate

# Paper Table V originals, for footprint-ratio scaling.
PAPER_DATASETS = {
    "lj": dict(vertices=5_000_000, avg_degree=14),
    "pl": dict(vertices=43_000_000, avg_degree=15),
    "tw": dict(vertices=62_000_000, avg_degree=24),
    "kr": dict(vertices=67_000_000, avg_degree=20),
    "sd": dict(vertices=95_000_000, avg_degree=20),
    "fr": dict(vertices=64_000_000, avg_degree=33),
    "uni": dict(vertices=50_000_000, avg_degree=20),
}

PAPER_LLC_BYTES = 16 * 1024 * 1024  # simulated system, paper Table VI


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str        # rmat | rmat_mild | uniform
    scale: int       # log2 num vertices (scaled-down)
    avg_degree: int
    seed: int


# Scaled specs: high-skew five + low-skew fr + no-skew uni.
SPECS = {
    "lj": DatasetSpec("lj", "rmat", 15, 14, 1),
    "pl": DatasetSpec("pl", "rmat", 16, 15, 2),
    "tw": DatasetSpec("tw", "rmat", 16, 24, 3),
    "kr": DatasetSpec("kr", "rmat", 16, 20, 4),
    "sd": DatasetSpec("sd", "rmat", 16, 20, 5),
    "fr": DatasetSpec("fr", "rmat_mild", 16, 24, 6),   # low skew
    "uni": DatasetSpec("uni", "uniform", 16, 20, 7),   # no skew
}

HIGH_SKEW = ("lj", "pl", "tw", "kr", "sd")
ADVERSARIAL = ("fr", "uni")


@lru_cache(maxsize=None)
def load(name: str, scale: int | None = None) -> CSR:
    spec = SPECS[name]
    s = spec.scale if scale is None else scale
    if spec.kind == "rmat":
        return generate.rmat(s, spec.avg_degree, seed=spec.seed)
    if spec.kind == "rmat_mild":
        # milder RMAT parameters -> low skew (friendster-like)
        return generate.rmat(s, spec.avg_degree, a=0.45, b=0.22, c=0.22, seed=spec.seed)
    if spec.kind == "uniform":
        return generate.uniform(s, spec.avg_degree, seed=spec.seed)
    raise ValueError(spec.kind)


def scaled_llc_bytes(name: str, g: CSR, elem_bytes: int = 8) -> int:
    """Scale the 16MB paper LLC by the property-footprint ratio.

    paper_footprint / 16MB == our_footprint / our_llc, so the thrash regime
    (property array >> LLC, hot region ~ LLC) is preserved.
    """
    paper = PAPER_DATASETS[name]
    paper_footprint = paper["vertices"] * elem_bytes
    ratio = paper_footprint / PAPER_LLC_BYTES
    ours = int(g.num_nodes * elem_bytes / ratio)
    # round down to a power of two >= 16KB so set count stays a power of 2
    size = 16 * 1024
    while size * 2 <= ours:
        size *= 2
    return size
