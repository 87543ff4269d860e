"""Train steps of the GNN and recsys cells, composed as the JAX package's
``launch/steps.py`` composes them: the loss and its gradients
(``trainer.value_and_grad``), then AdamW at lr 1e-3.

Each builder returns ``(opt_init, step)`` with ``step(params, opt_state,
batch) -> (new_params, new_state, {"loss": loss})``; the batch goes to the
builder's device. ``gin`` with ``grasp`` on ``ogb_products`` builds the
GRASP-partitioned step instead (``dist.collectives``: hot rows replicated,
cold rows owned, a halo exchange) over an initialised process group, and
also returns the partition's spec. Only what training needs is here: the
abstract cells, shardings and ``dryrun`` stay with the LM stack.

``gnn_loss`` reproduces the JAX package's loss exactly, including a state
of it: GIN and PNA have ``cfg.d_out = 16`` logits, while the GNN batch
makers draw labels from 47 classes by default (ogbn-products' count,
``N_CLASSES``). ``jnp.take_along_axis`` gives NaN for a label past the
logits, and such rows get no gradient, so the loss on those batches is NaN
while its gradients are finite. The port keeps that; callers that want a
finite loss draw labels in ``[0, cfg.d_out)``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import devices
from repro_torch.configs.base import GNNConfig, GNNShape, RecsysConfig
from repro_torch.kernels.embedding_bag.ref import lookup_ref
from repro_torch.nn import gnn as gnn_mod
from repro_torch.nn import recsys as recsys_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import batch_to, value_and_grad

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
    ids = torch.as_tensor(ids, device=x.device).long()
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ids, x)


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
