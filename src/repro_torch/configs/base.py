"""Config system: architectures x input shapes.

``ARCHS`` maps arch id -> config; ``SHAPES[family]`` maps shape id ->
shape spec (``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``).
``reduced()`` produces the CPU-smoke-test variant of an arch. The port
carries the JAX package's three families: the LMs (minitron-8b,
starcoder2-7b, phi3.5-moe-42b-a6.6b, moonshot-v1-16b-a3b,
nemotron-4-340b), the GNNs (GIN, PNA, EGNN, NequIP) and recsys (MIND).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    act: str = "silu"          # ffn activation
    gated: bool = True         # GLU-style ffn
    moe: Optional[MoECfg] = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    remat: bool = True
    optimizer: str = "adamw"   # nemotron-340b uses adafactor (memory)
    microbatches: int = 8      # gradient-accumulation splits of global batch
    seq_shard: bool = False    # Megatron-SP activation sharding over model
    layer_groups: int = 1      # >1: sqrt-L nested-group remat (340B class)
    # GRASP tie-in: Zipf-ordered vocab embedding with hot-prefix replication
    # (read nowhere in either package's code)
    grasp_vocab: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def family(self) -> str:
        return "lm"

    def param_count(self) -> int:
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        ff_mats = 3 if self.gated else 2
        if self.moe:
            ff = self.moe.n_experts * ff_mats * d * self.d_ff + d * self.moe.n_experts
        else:
            ff = ff_mats * d * self.d_ff
        return l * (attn + ff + 2 * d) + 2 * self.vocab * d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        ff_mats = 3 if self.gated else 2
        ff = self.moe.top_k * ff_mats * d * self.d_ff + d * self.moe.n_experts
        return l * (attn + ff + 2 * d) + 2 * self.vocab * d


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
class LMShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


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


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    "long_500k": LMShape("long_500k", "decode", 524288, 1),
}

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

SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


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
        moonshot_v1_16b_a3b,
        phi35_moe_42b_a6_6b,
        minitron_8b,
        starcoder2_7b,
        nemotron4_340b,
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
    """Small same-family variant: few layers/width, tiny vocab/tables, short
    histories."""
    if isinstance(cfg, LMConfig):
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv=max(1, min(cfg.n_kv, 2)),
            d_ff=128,
            vocab=512,
            moe=MoECfg(4, min(cfg.moe.top_k, 2)) if cfg.moe else None,
            remat=False,
            microbatches=1,
            seq_shard=False,
        )
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
