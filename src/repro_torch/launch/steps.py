"""Step builders and abstract input specs for every (arch x shape) cell,
composed as the JAX package's ``launch/steps.py`` composes them: the loss
and its gradients (``trainer.value_and_grad``, or ``trainer.grad_sum``
over the LM's microbatches), then the optimizer (AdamW at lr 1e-3, or the
LM's ``for_arch`` choice).

``build_cell(arch_name, shape_name, mesh)`` returns a :class:`Cell`: the
step, abstract arguments (meta tensors of the global shapes, from the
port's own ``init`` on ``device="meta"``: ``jax.eval_shape``'s
counterpart, nothing allocated) and in/out shardings (``dist.sharding``'s
``NamedSharding`` trees, broadcast onto the value trees as the JAX package
broadcasts them). The step takes its arguments as DTensors placed by
``in_shardings`` (``place`` for real values, ``abstract`` for meta ones)
and runs with ``mesh`` active (``constrain``) and plain tensors it makes
itself read as replicated. ``all_cells()`` lists every (arch, shape).

The single-device builders (``lm_train_step``, ``gnn_train_step``,
``recsys_train_step``) return ``(opt_init, step)`` with ``step(params,
opt_state, batch) -> (new_params, new_state, {"loss": loss})``; the batch
goes to the builder's device. ``gin`` with ``grasp`` on ``ogb_products``
builds the GRASP-partitioned step instead (``dist.collectives``: hot rows
replicated, cold rows owned, a halo exchange) over an initialised process
group, and also returns the partition's spec.

``gnn_loss`` reproduces the JAX package's loss exactly, including a state
of it: GIN and PNA have ``cfg.d_out = 16`` logits, while the GNN batch
makers draw labels from 47 classes by default (ogbn-products' count,
``N_CLASSES``). ``jnp.take_along_axis`` gives NaN for a label past the
logits, and such rows get no gradient, so the loss on those batches is NaN
while its gradients are finite. The port keeps that; callers that want a
finite loss draw labels in ``[0, cfg.d_out)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import devices
from repro_torch.configs import base as cfgs
from repro_torch.configs.base import GNNConfig, GNNShape, LMConfig, LMShape, RecsysConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import NamedSharding
from repro_torch.kernels.embedding_bag.ref import lookup_ref
from repro_torch.nn import gnn as gnn_mod
from repro_torch.nn import recsys as recsys_mod
from repro_torch.nn import transformer as tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.tree import tree_map
from repro_torch.train.trainer import batch_to, grad_sum, split, value_and_grad

N_CLASSES = 47  # ogbn-products label count


def take_along_last(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]``: a
    label in ``[-C, 0)`` counts from the end, one outside ``[-C, C)`` gives
    NaN (and no gradient)."""
    if labels.is_floating_point():
        raise TypeError("class labels must be integers")
    c = logp.shape[-1]
    lab = labels.long()
    lab = torch.where(lab < 0, lab + c, lab)
    ok = (lab >= 0) & (lab < c)
    ll = logp.gather(-1, lab.clamp(0, c - 1)[..., None])[..., 0]
    return torch.where(ok, ll, ll.new_full((), float("nan")))


def _segment_sum(x: torch.Tensor, ids, n: int) -> torch.Tensor:
    return gnn_mod._seg_sum(x, torch.as_tensor(ids, device=x.device).long(), n)


def gnn_loss(params, cfg: GNNConfig, batch: Dict) -> torch.Tensor:
    """The GNN cells' loss: node classification on the seed nodes of a
    minibatch, graph classification (segment-sum readout) on a molecule
    batch, over every node of a full graph (GIN, PNA); energy regression
    (EGNN, NequIP)."""
    if cfg.kind in ("gin", "pna"):
        logits = gnn_mod.apply(params, cfg, batch)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        if "seeds" in batch:  # minibatch: loss on seed nodes only
            logits = lookup_ref(logits, torch.as_tensor(batch["seeds"], device=logits.device))
        elif "graph_id" in batch:  # molecule: graph classification readout
            logits = _segment_sum(logits, batch["graph_id"], labels.shape[0])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -take_along_last(logp, labels).mean()
    if cfg.kind == "egnn":
        h, _ = gnn_mod.apply(params, cfg, batch)
        return energy_loss(h.sum(dim=-1), batch)
    if cfg.kind == "nequip":
        return energy_loss(gnn_mod.apply(params, cfg, batch), batch)
    raise ValueError(cfg.kind)


def energy_loss(energy: torch.Tensor, batch: Dict) -> torch.Tensor:
    if "graph_id" in batch:  # molecule: per-graph energy regression
        labels = torch.as_tensor(batch["labels"], device=energy.device)
        e_graph = _segment_sum(energy, batch["graph_id"], labels.shape[0])
        return torch.mean((e_graph - labels) ** 2)
    return torch.mean(energy**2) * 1e-3  # full-graph: bounded synthetic target


def _batch_shards(mesh) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in shd.batch_axes(mesh))


def lm_train_step(cfg: LMConfig, shape: LMShape,
                  device: str | torch.device = devices.DEFAULT_DEVICE, donate: bool = True,
                  mesh=None):
    """The LM cell's step (the JAX package's ``_lm_train_cell``): the
    optimizer ``for_arch(cfg)`` picks (Adafactor for nemotron-4-340b), and
    gradients accumulated over ``mb = min(cfg.microbatches,
    shape.global_batch // batch shards)`` microbatches of the batch's
    leading axis, so that each microbatch still covers every batch shard:
    float32 zeros plus each microbatch's gradient in order, divided by
    ``mb``; the loss is the running sum of the microbatches' losses over
    ``mb``. With ``donate`` (the cell's ``donate=(0, 1)``) the step
    consumes the parameters and optimizer state it is given.

    Without ``mesh`` (one device) the batch goes to ``device``. With
    ``mesh`` (the cell) the batch arrives as DTensors placed by the cell,
    and each leaf's ``(mb, B / mb, ...)`` split is constrained to the batch
    axes on its second dimension, as the JAX cell constrains it (a plain
    reshape of a batch-sharded leaf would shard the microbatch axis).
    Returns ``(opt_init, step)``."""
    opt_init, opt_update = opt_mod.make(opt_mod.for_arch(cfg))
    shards = 1 if mesh is None else _batch_shards(mesh)
    baxes = () if mesh is None else shd.batch_axes(mesh)
    dev = devices.resolve(device) if mesh is None else None
    mb = max(min(cfg.microbatches, shape.global_batch // shards), 1)
    if shape.global_batch % mb:
        raise ValueError(f"{mb} microbatches do not divide a batch of {shape.global_batch}")

    def loss(params, batch):
        return tfm.loss_fn(params, cfg, batch)

    def step(params, opt_state, batch):
        if dev is not None:
            batch = batch_to(batch, dev)
        if mb == 1:
            loss_value, grads = value_and_grad(loss, params, batch)
        else:
            losses, grads = grad_sum(loss, params, split(batch, mb, baxes))
            grads = tree_map(lambda g: g.div_(mb), grads)
            lsum = 0.0
            for part in losses:
                lsum = lsum + part
            loss_value = lsum / mb
        new_params, new_state = opt_update(grads, opt_state, params, donate=donate)
        return new_params, new_state, {"loss": loss_value}

    return opt_init, step


def _adamw():
    return opt_mod.make(opt_mod.OptConfig(name="adamw", lr=1e-3))


def gnn_train_step(cfg: GNNConfig, shape: GNNShape,
                   device: str | torch.device = devices.DEFAULT_DEVICE):
    """The GNN cell's step (the JAX package's ``_gnn_train_cell``).

    For ``gin`` with ``grasp`` on ``ogb_products`` it is the GRASP cell
    (``_gnn_grasp_cell``): the spec from ``partition_spec_for(shape.n_nodes,
    shape.n_edges, world size)`` with the hot prefix sized from
    ``HOT_REPLICA_BUDGET_BYTES`` at ``shape.d_feat`` float32 features, and
    ``make_grasp_gin_step`` over the default process group, which the
    caller initialises (the JAX cell's mesh): without one this raises. It
    returns ``(opt_init, step, spec)``; partition the graph with the spec
    (``grasp_partition``, ``grasp_batch``) and give ``step`` this rank's
    block (``convert.grasp_batch_from_numpy``)."""
    dev = devices.resolve(device)
    opt_init, opt_update = _adamw()
    if cfg.kind == "gin" and cfg.grasp and shape.name == "ogb_products":
        from repro_torch.dist import collectives as coll  # which imports this module

        spec = coll.partition_spec_for(
            shape.n_nodes, shape.n_edges, coll.require_group(),
            hot_budget_bytes=coll.HOT_REPLICA_BUDGET_BYTES, elem_bytes=shape.d_feat * 4)
        step = coll.make_grasp_gin_step(spec, cfg, shape.d_feat, N_CLASSES, None, opt_update,
                                        device=dev)
        return opt_init, step, spec

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(gnn_loss, params, cfg, batch_to(batch, dev))
        new_params, new_state = opt_update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return opt_init, step


def recsys_train_step(cfg: RecsysConfig, device: str | torch.device = devices.DEFAULT_DEVICE):
    """MIND's train step (the train branch of the JAX package's
    ``_recsys_cell``): the sampled-softmax loss over the dense table, read
    by the plain route."""
    dev = devices.resolve(device)
    opt_init, opt_update = _adamw()

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(recsys_mod.loss_fn, params, cfg, batch_to(batch, dev))
        new_params, new_state = opt_update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return opt_init, step


# ---------------------------------------------------------------------------
# Cells: abstract arguments and shardings on a mesh
# ---------------------------------------------------------------------------
F32, BF16, I32, BOOL = torch.float32, torch.bfloat16, torch.int32, torch.bool


def sds(shape, dtype) -> torch.Tensor:
    """An abstract argument: a meta tensor (shape and dtype, no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_fn: Callable
    args: Tuple[Any, ...]          # abstract (meta tensor) trees
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    notes: str = ""
    donate: Tuple[int, ...] = ()


class _OnMeta(TorchDispatchMode):
    """Every factory's output on the meta device, random draws included
    (their generator dropped), so ``init`` gives shapes and dtypes and
    allocates nothing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs or "generator" in kwargs:
            kwargs["device"] = torch.device("meta")
            kwargs.pop("pin_memory", None)
            if "generator" in kwargs:
                kwargs["generator"] = None
        return func(*args, **kwargs)


def _abstract_init(init, *args, **kwargs):
    with _OnMeta():
        return init(torch.Generator(), *args, device="meta", **kwargs)


def _named(mesh, spec_tree, value_tree):
    """PartitionSpec tree -> NamedSharding tree matching the value tree."""
    return _broadcast_like(shd.map_specs(lambda spec: shd.ns(mesh, *spec), spec_tree),
                           value_tree)


def _broadcast_like(spec_tree, value_tree):
    """Specs may be shallower than values (e.g. one spec for a whole
    subtree); keys of the value tree that the spec tree lacks raise
    ``KeyError``, as the JAX package's broadcast does."""
    if isinstance(spec_tree, NamedSharding):
        return tree_map(lambda _: spec_tree, value_tree)
    if isinstance(spec_tree, dict):
        return {k: _broadcast_like(spec_tree[k], value_tree[k]) for k in value_tree}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_broadcast_like(s, v) for s, v in zip(spec_tree, value_tree))
    return spec_tree


def _on_mesh(mesh, fn: Callable, out_shardings) -> Callable:
    """``fn`` run with ``mesh`` active (``constrain``) and plain tensors
    it makes itself (positions, masks) read as replicated; its results
    redistributed to ``out_shardings``, as the JAX cell's jit places
    them."""
    def run(*args):
        with shd.on_mesh(mesh):
            return shd.redistribute(fn(*args), out_shardings)
    return run


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_abstract_params(cfg: LMConfig, dtype: Optional[torch.dtype] = None):
    p = _abstract_init(tfm.init, cfg)
    if dtype is not None:  # serving checkpoints are bf16
        p = tree_map(lambda t: t.to(dtype) if t.dtype == F32 else t, p)
    return p


def _serving_fsdp(cfg: LMConfig, mesh) -> bool:
    """Serving wants TP-only weights (no per-layer data-axis re-gather),
    unless the bf16 weights do not fit a device's memory at TP-only
    sharding (nemotron-340b keeps 2D sharding)."""
    tp_bytes = cfg.param_count() * 2 / mesh.size(mesh.mesh_dim_names.index("model"))
    return tp_bytes > 8e9


def _lm_train_cell(cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    opt_cfg = opt_mod.for_arch(cfg)
    opt_init, step = lm_train_step(cfg, shape, mesh=mesh)
    a_params = _lm_abstract_params(cfg)
    a_opt = opt_init(a_params)
    a_batch = {"tokens": sds((shape.global_batch, shape.seq_len), I32),
               "labels": sds((shape.global_batch, shape.seq_len), I32)}
    pspec = shd.lm_param_spec(cfg)
    p_shard = _named(mesh, pspec, a_params)
    o_shard = _named(mesh, shd.opt_state_spec(pspec, opt_cfg.name), a_opt)
    b_shard = _named(mesh, shd.lm_batch_spec(mesh), a_batch)
    out = (p_shard, o_shard, {"loss": shd.ns(mesh)})
    return Cell(arch=cfg.name, shape=shape.name, step_fn=_on_mesh(mesh, step, out),
                args=(a_params, a_opt, a_batch),
                in_shardings=(p_shard, o_shard, b_shard), out_shardings=out, donate=(0, 1))


def _lm_prefill_cell(cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    def prefill_step(params, tokens):
        return tfm.prefill(params, cfg, tokens)

    a_params = _lm_abstract_params(cfg, dtype=BF16)
    a_tokens = sds((shape.global_batch, shape.seq_len), I32)
    # serving: no optimizer state, so weights fit TP-only
    pspec = shd.lm_param_spec(cfg, fsdp=_serving_fsdp(cfg, mesh))
    b = shd.batch_axes(mesh)
    p_shard = _named(mesh, pspec, a_params)
    # output cache: batch over data axes, sequence over model
    cache_shard = tfm.KVCache(k=shd.ns(mesh, None, b, "model", None, None),
                              v=shd.ns(mesh, None, b, "model", None, None),
                              length=shd.ns(mesh))
    out = (shd.ns(mesh, b, None), cache_shard)
    return Cell(arch=cfg.name, shape=shape.name, step_fn=_on_mesh(mesh, prefill_step, out),
                args=(a_params, a_tokens),
                in_shardings=(p_shard, shd.ns(mesh, b, None)), out_shardings=out)


def _lm_decode_cell(cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    """decode_32k: the KV cache sharded on batch over the data axes and on
    sequence over model. long_500k (batch 1): the KV cache sharded on
    *sequence* across every axis (flash-decoding style). The cache's
    ``length`` is a 0-d int32 tensor, as in the JAX cell; a meta one (the
    dry-run) stands for a full cache, ``seq_len - 1`` positions."""
    long_context = shape.global_batch == 1

    def decode_step(params, cache, token):
        length = cache.length
        if isinstance(length, torch.Tensor):
            length = shape.seq_len - 1 if length.is_meta else int(length)
        return tfm.decode_step(params, cfg, dataclasses.replace(cache, length=length), token)

    a_params = _lm_abstract_params(cfg, dtype=BF16)
    kv = (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv, cfg.head_dim)
    a_cache = tfm.KVCache(k=sds(kv, BF16), v=sds(kv, BF16), length=sds((), I32))
    a_token = sds((shape.global_batch,), I32)
    pspec = shd.lm_param_spec(cfg, fsdp=_serving_fsdp(cfg, mesh))
    p_shard = _named(mesh, pspec, a_params)
    b = shd.batch_axes(mesh)
    if long_context:
        kv_spec = shd.ns(mesh, None, None, tuple(mesh.mesh_dim_names), None, None)
        tok_spec = shd.ns(mesh)
    else:
        kv_spec = shd.ns(mesh, None, b, "model", None, None)
        tok_spec = shd.ns(mesh, b)
    cache_shard = tfm.KVCache(k=kv_spec, v=kv_spec, length=shd.ns(mesh))
    out = (shd.ns(mesh, b if not long_context else None, None), cache_shard)
    return Cell(arch=cfg.name, shape=shape.name, step_fn=_on_mesh(mesh, decode_step, out),
                args=(a_params, a_cache, a_token),
                in_shardings=(p_shard, cache_shard, tok_spec), out_shardings=out,
                notes="flash-decoding seq-sharded KV" if long_context else "",
                donate=(1,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _pad_to(n: int, mult: int = 512) -> int:
    """Shardability padding: edge/candidate streams are padded to a multiple
    of the largest mesh size (512); emask/sentinel entries absorb the pad."""
    return (n + mult - 1) // mult * mult


def _gnn_batch_abstract(cfg: GNNConfig, shape: GNNShape) -> dict:
    if shape.kind == "full_graph":
        n, e = shape.n_nodes, _pad_to(shape.n_edges)
        return {"x": sds((n, shape.d_feat), F32), "src": sds((e,), I32), "dst": sds((e,), I32),
                "emask": sds((e,), BOOL), "labels": sds((n,), I32),
                "coords": sds((n, 3), F32), "species": sds((n,), I32)}
    if shape.kind == "minibatch":
        from repro_torch.graph.sampler import subgraph_shape

        n_sub, e_sub = subgraph_shape(shape.batch_nodes, tuple(shape.fanout))
        return {"x": sds((n_sub, shape.d_feat), F32), "src": sds((e_sub,), I32),
                "dst": sds((e_sub,), I32), "emask": sds((e_sub,), BOOL),
                "labels": sds((shape.batch_nodes,), I32), "seeds": sds((shape.batch_nodes,), I32),
                "coords": sds((n_sub, 3), F32), "species": sds((n_sub,), I32)}
    if shape.kind == "molecule":
        nn_, ee = shape.batch_graphs * shape.n_nodes, shape.batch_graphs * shape.n_edges
        return {"x": sds((nn_, shape.d_feat), F32), "src": sds((ee,), I32),
                "dst": sds((ee,), I32), "emask": sds((ee,), BOOL),
                "coords": sds((nn_, 3), F32), "species": sds((nn_,), I32),
                "graph_id": sds((nn_,), I32),
                # gin/pna: graph classification (int); egnn/nequip: energy (f32)
                "labels": sds((shape.batch_graphs,), I32 if cfg.kind in ("gin", "pna") else F32)}
    raise ValueError(shape.kind)


def _gnn_grasp_cell(cfg: GNNConfig, shape: GNNShape, mesh) -> Cell:
    """GRASP-sharded full-graph GIN (``dist.collectives``): hot prefix
    replicated, cold partitioned, a bounded halo exchange a layer. The
    batch's leading ``p_dev`` axis is sharded over every mesh axis, so each
    device's block is what ``convert.grasp_batch_from_numpy(batch, rank)``
    gives; the step runs on the local blocks (the JAX cell's
    ``shard_map``), built at its first call on the blocks' device over the
    default process group, which must have ``mesh.size()`` ranks."""
    from repro_torch.dist import collectives as coll  # which imports this module

    opt_init, opt_update = _adamw()
    spec = coll.partition_spec_for(shape.n_nodes, shape.n_edges, mesh.size(),
                                   hot_budget_bytes=coll.HOT_REPLICA_BUDGET_BYTES,
                                   elem_bytes=shape.d_feat * 4)
    a_params = _abstract_init(gnn_mod.init, cfg, shape.d_feat)
    a_opt = opt_init(a_params)
    p_dev = spec.num_devices
    a_batch = {
        "x_hot": sds((spec.hot, shape.d_feat), F32),
        "x_cold": sds((p_dev, spec.cold_per_dev, shape.d_feat), F32),
        "esrc": sds((p_dev, spec.e_loc), I32),
        "edst": sds((p_dev, spec.e_loc), I32),
        "emask": sds((p_dev, spec.e_loc), BOOL),
        "pub": sds((p_dev, spec.c_pub), I32),
        "labels": sds((p_dev, spec.n_own), I32),
    }
    every = tuple(mesh.mesh_dim_names)
    p_shard = tree_map(lambda _: shd.ns(mesh), a_params)
    o_shard = tree_map(lambda _: shd.ns(mesh), a_opt)
    b_shard = {k: shd.ns(mesh) if k == "x_hot" else shd.ns(mesh, every) for k in a_batch}
    built = {}

    def step(params, opt_state, batch):
        local = {k: v.to_local() if k == "x_hot" else v.to_local()[0] for k, v in batch.items()}
        dev = local["x_hot"].device
        if dev not in built:
            built[dev] = coll.make_grasp_gin_step(spec, cfg, shape.d_feat, N_CLASSES, None,
                                                  opt_update, device=dev)
        p, s, m = built[dev](shd.to_local(params), shd.to_local(opt_state), local)
        return shd.from_local(p, p_shard), shd.from_local(s, o_shard), \
            shd.from_local(m, {"loss": shd.ns(mesh)})

    return Cell(arch=cfg.name, shape=shape.name, step_fn=step,
                args=(a_params, a_opt, a_batch),
                in_shardings=(p_shard, o_shard, b_shard),
                out_shardings=(p_shard, o_shard, {"loss": shd.ns(mesh)}),
                donate=(0, 1),
                notes=f"grasp exchange hot={spec.hot} c_pub={spec.c_pub}")


def _gnn_train_cell(cfg: GNNConfig, shape: GNNShape, mesh) -> Cell:
    if cfg.kind == "gin" and cfg.grasp and shape.name == "ogb_products":
        return _gnn_grasp_cell(cfg, shape, mesh)
    opt_init, opt_update = _adamw()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(gnn_loss, params, cfg, batch)
        new_params, new_state = opt_update(grads, opt_state, params, donate=True)
        return new_params, new_state, {"loss": loss}

    a_params = _abstract_init(gnn_mod.init, cfg, shape.d_feat)
    a_batch = _gnn_batch_abstract(cfg, shape)
    a_opt = opt_init(a_params)
    p_shard = tree_map(lambda _: shd.ns(mesh), a_params)
    o_shard = tree_map(lambda _: shd.ns(mesh), a_opt)
    bspec = shd.gnn_batch_spec(mesh, shape.kind)
    b_shard = {k: shd.ns(mesh, *bspec[k]) if k in bspec else shd.ns(mesh) for k in a_batch}
    out = (p_shard, o_shard, {"loss": shd.ns(mesh)})
    return Cell(arch=cfg.name, shape=shape.name, step_fn=_on_mesh(mesh, train_step, out),
                args=(a_params, a_opt, a_batch),
                in_shardings=(p_shard, o_shard, b_shard), out_shardings=out, donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def grasp_hot_rows(cfg: RecsysConfig, mesh) -> int:
    """GRASP plan for the item table: hot prefix sized by the per-device
    fast-memory budget (replication cost) and shardability of the tail."""
    if not cfg.grasp:
        return 0
    from repro_torch.core import plan as plan_mod

    budget_rows = plan_mod.entries_for_budget(64 << 20, cfg.embed_dim * 4)  # 64MB replica budget
    hot = 1 << (budget_rows.bit_length() - 1)
    # cold remainder must shard over 512 devices
    while hot > 0 and (cfg.n_items - hot) % 512 != 0:
        hot //= 2
    return hot


def _recsys_cell(cfg: RecsysConfig, shape, mesh) -> Cell:
    opt_init, opt_update = _adamw()
    # the GRASP hot/cold layout on the retrieval cell only, as in the JAX
    # package (its perf log: it wins only for retrieval-style scoring)
    hot_rows = grasp_hot_rows(cfg, mesh) if shape.kind == "retrieval" else 0
    a_params = _abstract_init(recsys_mod.init, cfg, hot_rows=hot_rows)
    pspec = shd.recsys_param_spec(cfg, grasp=hot_rows > 0)
    p_shard = _named(mesh, pspec, a_params)
    b = shd.batch_axes(mesh)
    hl = cfg.hist_len

    if shape.kind == "train":
        def step(params, opt_state, batch):
            loss, grads = value_and_grad(recsys_mod.loss_fn, params, cfg, batch)
            new_params, new_state = opt_update(grads, opt_state, params, donate=True)
            return new_params, new_state, {"loss": loss}

        a_opt = opt_init(a_params)
        o_shard = _named(mesh, shd.opt_state_spec(pspec, "adamw"), a_opt)
        a_batch = {"hist": sds((shape.batch, hl), I32), "hist_mask": sds((shape.batch, hl), BOOL),
                   "target": sds((shape.batch,), I32), "negatives": sds((cfg.n_negatives,), I32)}
        b_shard = _named(mesh, shd.recsys_batch_spec(mesh, "train"), a_batch)
        out = (p_shard, o_shard, {"loss": shd.ns(mesh)})
        return Cell(cfg.name, shape.name, _on_mesh(mesh, step, out), (a_params, a_opt, a_batch),
                    (p_shard, o_shard, b_shard), out, donate=(0, 1))

    if shape.kind == "serve":
        def step(params, batch):
            return recsys_mod.serve_scores(params, cfg, batch)

        a_batch = {"hist": sds((shape.batch, hl), I32), "hist_mask": sds((shape.batch, hl), BOOL),
                   "candidates": sds((shape.batch, 64), I32)}
        b_shard = _named(mesh, shd.recsys_batch_spec(mesh, "serve"), a_batch)
        out = shd.ns(mesh, b, None)
        return Cell(cfg.name, shape.name, _on_mesh(mesh, step, out), (a_params, a_batch),
                    (p_shard, b_shard), out)

    if shape.kind == "retrieval":
        def step(params, batch):
            return recsys_mod.retrieval_scores(params, cfg, batch)

        a_batch = {"hist": sds((1, hl), I32), "hist_mask": sds((1, hl), BOOL),
                   "candidates": sds((_pad_to(shape.n_candidates),), I32)}
        b_shard = _named(mesh, shd.recsys_batch_spec(mesh, "retrieval"), a_batch)
        out = shd.ns(mesh, None, tuple(mesh.mesh_dim_names))
        return Cell(cfg.name, shape.name, _on_mesh(mesh, step, out), (a_params, a_batch),
                    (p_shard, b_shard), out)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def lm_cell(cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    """The LM cell of ``shape``'s kind (train, prefill or decode)."""
    builders = {"train": _lm_train_cell, "prefill": _lm_prefill_cell, "decode": _lm_decode_cell}
    if shape.kind not in builders:
        raise ValueError((cfg.name, shape.name))
    return builders[shape.kind](cfg, shape, mesh)


def build_cell(arch_name: str, shape_name: str, mesh) -> Cell:
    cfg = cfgs.get_arch(arch_name)
    shape = cfgs.SHAPES[cfg.family][shape_name]
    if cfg.family == "lm":
        return lm_cell(cfg, shape, mesh)
    if cfg.family == "gnn":
        return _gnn_train_cell(cfg, shape, mesh)
    if cfg.family == "recsys":
        return _recsys_cell(cfg, shape, mesh)
    raise ValueError((arch_name, shape_name))


def all_cells() -> list[tuple[str, str]]:
    return [(name, shape_name) for name, cfg in cfgs.all_archs().items()
            for shape_name in cfgs.SHAPES[cfg.family]]
