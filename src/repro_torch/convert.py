"""Carry the reference's state across: the graph, the plan and the trace
of the graph pipeline, MIND's parameters, the GNNs' parameters, the LMs'
parameters, the optimizers' state and a rank's block of the GRASP step's
batch. Each
function takes the JAX package's numpy fields (or any arrays of the same
values) and returns the port's object, with the dtypes the port's code
expects."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import devices

from repro_torch.core.cachesim import Trace
from repro_torch.core.plan import GraspPlan
from repro_torch.graph.csr import CSR
from repro_torch.train.tree import tree_map


def csr_from_numpy(indptr, indices, num_nodes: int,
                   weights: Optional[np.ndarray] = None) -> CSR:
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    if indptr.shape != (num_nodes + 1,) or indptr[-1] != indices.shape[0]:
        raise ValueError("indptr must have num_nodes + 1 entries ending at len(indices)")
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
        if weights.shape != indices.shape:
            raise ValueError("weights must align with indices")
    return CSR(indptr=indptr, indices=indices, num_nodes=int(num_nodes), weights=weights)


def plan_from_fields(**fields) -> GraspPlan:
    """``GraspPlan`` from the reference plan's fields (``dataclasses.asdict``)."""
    return GraspPlan(**{k: int(v) for k, v in fields.items()})


def trace_from_numpy(line, hint, pc, region, nxt) -> Trace:
    arrays = dict(
        line=np.asarray(line, dtype=np.int64),
        hint=np.asarray(hint, dtype=np.int8),
        pc=np.asarray(pc, dtype=np.int32),
        region=np.asarray(region, dtype=np.int32),
        nxt=np.asarray(nxt, dtype=np.int64),
    )
    if len({a.shape for a in arrays.values()}) != 1:
        raise ValueError("trace arrays must share one length")
    return Trace(**arrays)


def mind_params_from_numpy(params: Dict, device: str | torch.device = devices.DEFAULT_DEVICE
                           ) -> Dict:
    """MIND parameters from the JAX ``nn.recsys.init`` pytree as numpy arrays
    (``s_mat``, ``mlp[i]["w"]``, and ``items`` or ``items_hot`` +
    ``items_cold``) -> the port's dict of float32 tensors on ``device``."""
    dev = devices.resolve(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    out = {"s_mat": tensor(params["s_mat"]),
           "mlp": [{"w": tensor(layer["w"])} for layer in params["mlp"]]}
    tables = [k for k in ("items", "items_hot", "items_cold") if k in params]
    if tables not in (["items"], ["items_hot", "items_cold"]):
        raise ValueError(f"expected items or items_hot + items_cold, got {tables}")
    for k in tables:
        out[k] = tensor(params[k])
    return out


def gnn_params_from_numpy(params, device: str | torch.device = devices.DEFAULT_DEVICE):
    """GNN parameters from the JAX ``nn.gnn.init`` pytree as numpy arrays
    (nested dicts and lists) -> the same tree of tensors on ``device``, each
    with its array's dtype; ``None`` entries (GIN's ``eps`` when it is not
    learnable, NequIP's ``r02``/``r22`` when ``l_max < 2``) stay ``None``."""
    dev = devices.resolve(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), params)


def _tensor_of(a, dev: torch.device) -> torch.Tensor:
    """A tensor of ``a``'s dtype; bfloat16 arrays (numpy's extension dtype,
    which torch does not read) go across as their 16-bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def lm_params_from_numpy(params, device: str | torch.device = devices.DEFAULT_DEVICE):
    """LM parameters from the JAX ``nn.transformer.init`` pytree as numpy
    arrays (``embed``, ``layers`` stacked on a leading layer axis, ``ln_f``,
    ``lm_head``) -> the same tree of tensors on ``device``, leaf for leaf,
    each with its array's dtype."""
    dev = devices.resolve(device)
    return tree_map(lambda a: _tensor_of(a, dev), params)


def opt_state_from_numpy(state, device: str | torch.device = devices.DEFAULT_DEVICE):
    """An optimizer state of the JAX package's ``train.optimizer`` (SGD's
    ``mu``, AdamW's ``m``/``v``, Adafactor's ``vr``/``vc``/``v`` trees and
    the int32 ``step``) as numpy arrays -> the port's state, the same tree
    of tensors on ``device`` with each array's dtype (bfloat16 moments
    included); ``None`` entries stay ``None``."""
    dev = devices.resolve(device)
    return tree_map(lambda a: _tensor_of(a, dev), state)


def grasp_batch_from_numpy(batch: Dict, rank: int,
                           device: str | torch.device = devices.DEFAULT_DEVICE) -> Dict:
    """Rank ``rank``'s block of a GRASP step's batch in the JAX package's
    layout (``dist.collectives.grasp_batch``: ``x_hot`` replicated, every
    other entry with a leading (P, ...) rank axis) -> tensors on ``device``:
    ``x_hot`` whole and row ``rank`` of the others, each with its array's
    dtype."""
    dev = devices.resolve(device)
    P = np.shape(batch["x_cold"])[0]
    if not 0 <= rank < P:
        raise ValueError(f"rank {rank} outside the batch's {P} blocks")
    return {k: torch.as_tensor(np.asarray(v if k == "x_hot" else v[rank]), device=dev)
            for k, v in batch.items()}
