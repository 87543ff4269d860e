"""Config system: architectures x input shapes.

``ARCHS`` maps arch id -> config; ``RECSYS_SHAPES`` maps shape id ->
``RecsysShape``. ``reduced()`` produces the CPU-smoke-test variant of an
arch. This slice of the port carries the recsys family only (MIND); the
LM and GNN configs join with their slices.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 2_097_152   # 2^21: row-shardable across 512 chips
    hist_len: int = 50
    n_negatives: int = 4096
    d_hidden: int = 256
    grasp: bool = True   # popularity-ordered table + hot-prefix replication

    @property
    def family(self) -> str:
        return "recsys"


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str        # train | serve | retrieval
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", "train", 65536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
}

SHAPES = {"recsys": RECSYS_SHAPES}


# ---------------------------------------------------------------------------
# Registry (populated by per-arch modules via register())
# ---------------------------------------------------------------------------
ARCHS: dict = {}


def register(cfg):
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str):
    if not ARCHS:
        load_all()
    return ARCHS[name]


def all_archs():
    if not ARCHS:
        load_all()
    return dict(ARCHS)


def load_all():
    """Import every per-arch config module (side-effect: register())."""
    from repro_torch.configs import mind  # noqa: F401


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------
def reduced(cfg):
    """Small same-family variant: tiny tables, short histories."""
    if isinstance(cfg, RecsysConfig):
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-smoke",
            embed_dim=16,
            n_items=1000,
            hist_len=8,
            n_negatives=32,
            d_hidden=32,
        )
    raise TypeError(type(cfg))
