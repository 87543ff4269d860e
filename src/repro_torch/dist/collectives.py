"""GRASP-aware graph partitioning and the distributed GIN exchange, over
``torch.distributed``.

The layout lifts the paper's Table I skew property to the partition tier.
After DBG reordering the hot vertices are a prefix of the id space and
cover the large majority of edge *sources*, so each rank keeps a
three-region feature table:

    [0, hot)                        replicated hot prefix (every rank)
    [hot, hot + cold_per_dev)       this rank's own cold slice
    [hot + cold_per_dev, table_len) halo: published remote-cold rows,
                                    P contiguous per-owner blocks of c_pub

Edges live on the rank that owns their destination (pull-based
aggregation), so only cold remote *sources* ever cross between ranks. Per
layer the exchange is two all_gathers (own-hot slices -> the full hot
table, each owner's published cold rows -> the halo), or one fused
all_gather in the pipelined schedule.

The JAX package's ``shard_map`` over a mesh becomes a process group that
the caller initialises (NCCL on cards, gloo on the CPU; world size 1 is a
group too). Each rank holds its own block of the sharded batch entries and
the replicated ``x_hot``; ``torch.distributed.get_rank(group)`` is the
mesh's row-major device index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import devices
from repro_torch.core import plan as plan_mod
from repro_torch.launch.steps import take_along_last
from repro_torch.nn import gnn as gnn_mod
from repro_torch.nn import layers as L
from repro_torch.train.trainer import batch_to, value_and_grad
from repro_torch.train.tree import tree_leaves

# The JAX package's per-device budget for the replicated hot prefix, kept
# so that both packages partition a graph alike. On an H100 80GB HBM3 it is
# 0.0789% of the card's memory (torch.cuda.get_device_properties(0)
# .total_memory = 85,017,493,504 bytes, printed by chip_smoke.py phase 12).
HOT_REPLICA_BUDGET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class GraspPartitionSpec:
    """Static shapes of a GRASP partition over `num_devices` ranks.

    `num_nodes` is the padded node count (hot + num_devices*cold_per_dev);
    `n_own` nodes live on each rank (its hot slice + its cold slice);
    `c_pub` bounds how many cold rows any owner publishes into the halo;
    `e_loc` bounds the per-rank edge table; `table_len` is the local
    gather-table length hot + cold_per_dev + num_devices*c_pub.
    """
    num_devices: int
    num_nodes: int
    hot: int
    hot_per_dev: int
    cold_per_dev: int
    n_own: int
    c_pub: int
    e_loc: int
    table_len: int
    pub_frac: float
    edge_slack: float


def partition_spec_for(num_nodes: int, num_edges: int, num_devices: int,
                       hot: Optional[int] = None, pub_frac: float = 0.25,
                       edge_slack: float = 1.5,
                       hot_budget_bytes: Optional[int] = None,
                       elem_bytes: int = 4) -> GraspPartitionSpec:
    """Size the static buffers for a `num_devices`-way GRASP partition.

    `hot` may be given directly (tests / ablations) or derived from a
    per-device memory budget: with `hot=None`, the replicated hot prefix is
    sized as `entries_for_budget(hot_budget_bytes, elem_bytes)` — the bytes
    each rank can afford to spend on the replica, divided by the feature
    row size (`HOT_REPLICA_BUDGET_BYTES` when unspecified).

    `hot` is rounded down to a multiple of `num_devices`; the cold remainder
    is padded up so every rank owns exactly `cold_per_dev` cold nodes.
    `pub_frac` scales the halo capacity (1.0 => any cold row may be
    published); `edge_slack` scales the per-rank edge budget relative to
    a perfectly balanced split.
    """
    if num_devices < 1:
        raise ValueError("need at least one device")
    if hot is None:
        budget = (HOT_REPLICA_BUDGET_BYTES if hot_budget_bytes is None
                  else hot_budget_bytes)
        hot = plan_mod.entries_for_budget(budget, elem_bytes,
                                          max_entries=num_nodes)
    hot = int(max(0, min(hot, num_nodes)))
    hot -= hot % num_devices
    hot_per_dev = hot // num_devices
    cold = num_nodes - hot
    cold_per_dev = -(-cold // num_devices)  # ceil; 0 iff everything is hot
    padded = hot + num_devices * cold_per_dev
    if cold_per_dev > 0:
        c_pub = int(min(cold_per_dev, max(1, math.ceil(pub_frac * cold_per_dev))))
    else:
        c_pub = 0
    e_loc = max(1, math.ceil(edge_slack * num_edges / num_devices))
    return GraspPartitionSpec(
        num_devices=num_devices,
        num_nodes=padded,
        hot=hot,
        hot_per_dev=hot_per_dev,
        cold_per_dev=cold_per_dev,
        n_own=hot_per_dev + cold_per_dev,
        c_pub=c_pub,
        e_loc=e_loc,
        table_len=hot + cold_per_dev + num_devices * c_pub,
        pub_frac=float(pub_frac),
        edge_slack=float(edge_slack),
    )


def grasp_partition(g, spec: GraspPartitionSpec) -> Dict[str, np.ndarray]:
    """Build per-rank edge tables addressing the three-region layout (host
    numpy over the port's ``CSR``).

    Returns `esrc`/`edst`/`emask` of shape (P, e_loc) — local table indices
    and a validity mask, edges kept in CSR (dst-sorted) order so the
    distributed segment sum reduces in the same order as the unpartitioned
    model — plus `pub` (P, c_pub) of published *global* cold ids (0 = empty
    slot; id 0 is always hot or owned, never published), `dropped` (edges
    lost to halo/edge-budget overflow) and `total_edges`.
    """
    P = spec.num_devices
    hot, hpd, cpd = spec.hot, spec.hot_per_dev, spec.cold_per_dev
    src = np.asarray(g.indices, dtype=np.int64)
    dst = np.asarray(g.dst_ids(), dtype=np.int64)
    if g.num_nodes > spec.num_nodes:
        raise ValueError("spec was sized for a smaller graph")

    hpd_ = max(hpd, 1)  # avoid 0-division in unselected np.where branches
    cpd_ = max(cpd, 1)
    owner = np.where(dst < hot, dst // hpd_, (dst - hot) // cpd_)
    dst_local = np.where(dst < hot, dst - owner * hpd,
                         hpd + (dst - hot) - owner * cpd)
    src_owner = np.where(src < hot, -1, (src - hot) // cpd_)  # -1: hot (free)
    remote = src_owner != np.where(src < hot, -1, owner)
    remote &= src_owner >= 0

    # publish lists: per owner, the unique cold ids some other rank needs
    pub = np.zeros((P, spec.c_pub), np.int32)
    halo_slot = np.full(spec.num_nodes, -1, np.int64)
    for q in range(P):
        ids = np.unique(src[remote & (src_owner == q)])
        n_q = min(ids.size, spec.c_pub)
        pub[q, :n_q] = ids[:n_q]
        halo_slot[ids[:n_q]] = hot + cpd + q * spec.c_pub + np.arange(n_q)

    own_local = hot + (src - hot) - src_owner * cpd  # valid when src is cold
    esrc_val = np.where(src < hot, src,
                        np.where(src_owner == owner, own_local,
                                 halo_slot[src]))
    addressable = esrc_val >= 0  # -1: remote-cold src beyond halo capacity

    esrc = np.zeros((P, spec.e_loc), np.int32)
    edst = np.zeros((P, spec.e_loc), np.int32)
    emask = np.zeros((P, spec.e_loc), bool)
    for p in range(P):
        sel = np.nonzero(addressable & (owner == p))[0]  # keeps CSR order
        k = min(sel.size, spec.e_loc)
        esrc[p, :k] = esrc_val[sel[:k]]
        edst[p, :k] = dst_local[sel[:k]]
        emask[p, :k] = True
    return {
        "esrc": esrc,
        "edst": edst,
        "emask": emask,
        "pub": pub,
        "dropped": int(g.num_edges - int(emask.sum())),
        "total_edges": int(g.num_edges),
    }


def grasp_batch(x, labels, part: Dict[str, np.ndarray],
                spec: GraspPartitionSpec) -> Dict[str, np.ndarray]:
    """The step's batch in the JAX package's layout, from node features
    ``x`` (num_nodes, d) and ``labels`` (num_nodes,) in global id order over
    the spec's padded node count, and a ``grasp_partition``:

      x_hot  (hot, d)              replicated hot features
      x_cold (P, cold_per_dev, d)  each rank's own cold features
      esrc/edst/emask (P, e_loc)   local edge tables
      pub    (P, c_pub)            published global cold ids
      labels (P, n_own)            labels in own-table order [hot | cold]

    Rank p's block is row p of every entry but ``x_hot``
    (``convert.grasp_batch_from_numpy``)."""
    x, labels = np.asarray(x), np.asarray(labels)
    if x.ndim != 2 or x.shape[0] != spec.num_nodes or labels.shape != (spec.num_nodes,):
        raise ValueError(f"x and labels need {spec.num_nodes} rows (the spec's padded count), "
                         f"got {x.shape} and {labels.shape}")
    P, hot, hpd, cpd = spec.num_devices, spec.hot, spec.hot_per_dev, spec.cold_per_dev
    own = np.stack([np.concatenate([np.arange(p * hpd, (p + 1) * hpd),
                                    hot + np.arange(p * cpd, (p + 1) * cpd)])
                    for p in range(P)])
    return {"x_hot": x[:hot], "x_cold": x[hot:].reshape(P, cpd, x.shape[1]),
            "esrc": part["esrc"], "edst": part["edst"], "emask": part["emask"],
            "pub": part["pub"], "labels": labels[own]}


def require_group(group=None) -> int:
    """The world size of ``group`` (the default group when None); raises
    when no process group is initialised: the GRASP step and the compressed
    all-reduce never fall back to one rank's unpartitioned work."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group first (NCCL on cards, gloo on the CPU; "
            "world size 1 is a group too)")
    return dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    """``lax.all_gather(x, axes, axis=0, tiled=True)``: every rank's ``x``
    stacked along dim 0 in rank order. Its backward is JAX's transpose of
    the tiled gather, ``psum_scatter``: rank r gets the sum over the ranks
    of block r of their cotangents. It is an all_to_all of the blocks and
    a sum in rank order rather than ``reduce_scatter_tensor``, whose order
    of summation may follow an element's place in the buffer (NCCL splits
    a buffer over channels, each its own ring): the pipelined schedule's
    fused buffer and the sequential schedule's two buffers then round the
    same sums alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        blocks = g.new_empty((world, g.shape[0] // world) + tuple(g.shape[1:]))
        dist.all_to_all_single(blocks, g.contiguous(), group=ctx.group)
        out = blocks[0].clone()
        for q in range(1, world):
            out += blocks[q]
        return out, None


class _Split(torch.autograd.Function):
    """``(h[:hpd], h[hpd:], h[hpd:][pub_local])``: the rows of a layer's
    output that the next layer's table takes, its own hot slice, its own
    cold slice and its published cold rows. One node with one backward,
    which adds the three cotangents in a fixed order: autograd would add
    them into ``h`` in the order its nodes run, which differs between the
    schedules, and so would round differently."""

    @staticmethod
    def forward(ctx, h, hpd, pub_local):
        ctx.save_for_backward(pub_local)
        ctx.hpd = hpd
        cold = h[hpd:]
        return h[:hpd], cold, cold.index_select(0, pub_local)

    @staticmethod
    def backward(ctx, g_hot, g_cold, g_pub):
        (pub_local,) = ctx.saved_tensors
        gh = torch.cat([g_hot, g_cold])
        gh[ctx.hpd:].index_add_(0, pub_local, g_pub)
        return gh, None, None


class _GatherSum(torch.autograd.Function):
    """``segment_sum(where(emask, table[esrc], 0), edst, n)``: one layer's
    message gather, mask and destination sum, as the JAX step writes them
    (``jnp.take``, ``jnp.where``, ``jax.ops.segment_sum``), with the
    arithmetic of autograd through ``index_select``, ``masked_fill`` and
    ``index_add_``. The mask is applied in place, forward and backward, so
    one (E, d) tensor lives at a time: at the real size one is 22-34 GB."""

    @staticmethod
    def forward(ctx, table, esrc, edst, masked_out, n):
        ctx.save_for_backward(esrc, edst, masked_out)
        ctx.rows = table.shape[0]
        msg = table.index_select(0, esrc)
        msg.masked_fill_(masked_out, 0.0)
        return msg.new_zeros((n, msg.shape[1])).index_add_(0, edst, msg)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        esrc, edst, masked_out = ctx.saved_tensors
        gm = g.index_select(0, edst)
        gm.masked_fill_(masked_out, 0.0)
        return gm.new_zeros((ctx.rows, gm.shape[1])).index_add_(0, esrc, gm), None, None, None, None


def make_grasp_gin_step(spec: GraspPartitionSpec, cfg, d_feat: int, n_classes: int,
                        group, opt_update, overlap: bool = True,
                        device: str | torch.device = devices.DEFAULT_DEVICE):
    """A GIN train step over a GRASP-partitioned graph, one rank's share.

    ``group`` is the caller's initialised process group (None: the default
    group) of ``spec.num_devices`` ranks; ``device`` is where this rank
    computes. ``step(params, opt_state, batch)`` takes this rank's block
    (``convert.grasp_batch_from_numpy``):

      x_hot  (hot, d_feat)            replicated hot features
      x_cold (cold_per_dev, d_feat)   own cold features
      esrc/edst/emask (e_loc,)        local edge tables from `grasp_partition`
      pub    (c_pub,)                 published global cold ids
      labels (n_own,)                 labels in own-table order [hot | cold]

    and yields ``(new_params, new_opt_state, {"loss": global_mean_nll})``
    on every rank, the gradients and the loss summed over the ranks
    (``all_reduce``, the JAX step's ``psum``) before ``opt_update``. The
    loss matches the unpartitioned ``gin_apply`` loss (same per-destination
    edge order, float32 compute). ``n_classes`` is the cell's label count,
    kept from the JAX signature: as there, labels are read against
    ``cfg.d_out`` logits, and one past them gives a NaN loss
    (``take_along_last``).

    ``overlap=True`` (the default) runs the pipelined exchange: layer 0's
    hot table is ``x_hot`` itself (already replicated) and only the halo
    prologue is gathered; each later layer's hot and halo rows travel in
    ONE fused all_gather of [own hot slice | published cold rows], issued
    right after the layer's ``h``. ``overlap=False`` gathers each region
    per layer. Both move the same rows into the same tables, so they give
    the same bits. The collectives are issued synchronously.
    """
    if cfg.kind != "gin":
        raise ValueError(f"grasp exchange step only supports gin, got {cfg.kind!r}")
    world = require_group(group)
    if world != spec.num_devices:
        raise ValueError(f"the process group has {world} ranks, spec wants {spec.num_devices}")
    dev = devices.resolve(device)
    hot, hpd, cpd, c_pub, P = (spec.hot, spec.hot_per_dev, spec.cold_per_dev, spec.c_pub,
                               spec.num_devices)
    shapes = {"x_hot": (hot, d_feat), "x_cold": (cpd, d_feat), "esrc": (spec.e_loc,),
              "edst": (spec.e_loc,), "emask": (spec.e_loc,), "pub": (c_pub,),
              "labels": (spec.n_own,)}

    def gather(x):
        return _AllGather.apply(x, group)

    def exchange(h, pub_local):
        """The next layer's [hot table, own cold slice, halo] from ``h``:
        one fused all_gather of [own hot slice | published cold rows], or
        one all_gather a region."""
        hot_own, own_cold, published = _Split.apply(h, hpd, pub_local)
        if not c_pub:
            return gather(hot_own), own_cold, None
        if not overlap:
            return gather(hot_own), own_cold, gather(published)
        g = gather(torch.cat([hot_own, published])).reshape(P, hpd + c_pub, h.shape[1])
        return g[:, :hpd].reshape(P * hpd, -1), own_cold, g[:, hpd:].reshape(P * c_pub, -1)

    def local_loss(params, b, rank):
        # own table order is [own hot slice | own cold slice]
        h = torch.cat([b["x_hot"][rank * hpd:(rank + 1) * hpd], b["x_cold"]])
        # this rank's publish list: global ids -> positions in its own cold
        # slice (empty slots clip to row 0, which no edge addresses through
        # the halo)
        pub_local = (b["pub"].long() - (hot + rank * cpd)).clamp(0, max(cpd - 1, 0))
        edges = (b["esrc"], b["edst"], ~b["emask"][:, None], spec.n_own)
        layers = params["layers"]
        if overlap:
            # prologue: layer 0's hot table is x_hot itself, so only the
            # halo needs a collective before layer 0
            halo = gather(b["x_cold"].index_select(0, pub_local)) if c_pub else None
            tables = (b["x_hot"], b["x_cold"], halo)
        for li, lp in enumerate(layers):
            if not overlap:
                tables = exchange(h, pub_local)
            agg = _GatherSum.apply(torch.cat([t for t in tables if t is not None]), *edges)
            eps = lp["eps"] if lp["eps"] is not None else 0.0
            h = gnn_mod._mlp(lp["mlp"], (1.0 + eps) * h + agg)
            h = F.relu(L.layernorm(lp["ln"], h))
            if overlap and li + 1 < len(layers):
                tables = exchange(h, pub_local)  # issued a whole layer before its use
        logits = L.dense(params["out"], h, torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        return -take_along_last(logp, b["labels"]).sum() / spec.num_nodes  # global mean after the sum

    def step(params, opt_state, batch):
        require_group(group)
        rank = dist.get_rank(group)
        b = batch_to(batch, dev)
        for k, want in shapes.items():
            if tuple(b[k].shape) != want:
                raise ValueError(f"batch[{k!r}] has shape {tuple(b[k].shape)}, this rank's "
                                 f"block needs {want}")
        lval, grads = value_and_grad(local_loss, params, b, rank)
        for g in tree_leaves(grads):
            dist.all_reduce(g, group=group)
        dist.all_reduce(lval, group=group)
        new_params, new_opt = opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": lval}

    return step
