"""Config system: architectures x input shapes.

``ARCHS`` maps arch id -> config; ``SHAPES[family]`` maps shape id ->
shape spec (``GNN_SHAPES``, ``RECSYS_SHAPES``). ``reduced()`` produces the
CPU-smoke-test variant of an arch. The port carries the GNN (GIN, PNA,
EGNN, NequIP) and recsys (MIND) families; the LM configs join with their
slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str            # egnn | nequip | gin | pna
    n_layers: int
    d_hidden: int
    d_out: int = 16
    # nequip extras
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    # pna extras
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    # gin
    eps_learnable: bool = True
    # GRASP: apply DBG reordering + hot/cold sharded exchange
    grasp: bool = True

    @property
    def family(self) -> str:
        return "gnn"


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
class GNNShape:
    name: str
    kind: str        # full_graph | minibatch | molecule
    n_nodes: int
    n_edges: int
    d_feat: int = 64
    batch_nodes: int = 0     # minibatch
    fanout: tuple = ()       # minibatch
    batch_graphs: int = 0    # molecule


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str        # train | serve | retrieval
    batch: int
    n_candidates: int = 0


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full_graph", 2708, 10556, d_feat=1433),
    "minibatch_lg": GNNShape(
        "minibatch_lg", "minibatch", 232_965, 114_615_892,
        d_feat=602, batch_nodes=1024, fanout=(15, 10),
    ),
    "ogb_products": GNNShape("ogb_products", "full_graph", 2_449_029, 61_859_140, d_feat=100),
    "molecule": GNNShape("molecule", "molecule", 30, 64, d_feat=16, batch_graphs=128),
}

RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", "train", 65536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
}

SHAPES = {"gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


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
    from repro_torch.configs import (  # noqa: F401
        egnn,
        nequip,
        gin_tu,
        pna,
        mind,
    )


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------
def reduced(cfg):
    """Small same-family variant: few layers/width, tiny tables, short
    histories."""
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(
            cfg, name=cfg.name + "-smoke", n_layers=2, d_hidden=16, n_rbf=4
        )
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
