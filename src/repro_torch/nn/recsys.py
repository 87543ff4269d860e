"""MIND: Multi-Interest Network with Dynamic routing (Li et al., CIKM'19).

Pipeline: item-embedding lookup over the user's behaviour history, capsule
dynamic routing into ``n_interests`` interest capsules, label-aware
attention and a sampled-softmax loss for training; serving scores
candidates against the interests with a max-over-interests reduction.

GRASP tie-in: item popularity is Zipfian — with the table rows ordered by
popularity (the recsys analogue of DBG reordering), the leading rows form
the High Reuse Region. ``impl="hot"`` reads the history through the
hot-gather kernel (K1), whose hot-row loads carry an L2 ``evict_last``
hint; ``init(..., hot_rows=...)`` splits the table at the same boundary.

Parameters are a plain dict of tensors (``s_mat``, ``mlp[i]["w"]`` and
``items``, or ``items_hot`` + ``items_cold``); the functions compute on the
device the parameters lie on. Batches may hold numpy arrays or tensors.

Training differentiates the plain route only (``impl="plain"``, the JAX
package's ``impl="jnp"``): the table's gradient is dense, as
``jax.value_and_grad`` gives it. K1's launch has no backward (nor has the
JAX package's ``pallas_call``), so ``user_interests`` and ``loss_fn`` raise
on ``impl="hot"`` while autograd would record a table that requires grad.

Routing logits are ``sin(id * (1 + k))`` in float32, as in the JAX
package. The products are exact in float32 (ids < 2^21, k < 4), but the
arguments reach 8.4e6 rad, where the card's ``sinf`` and the CPU's ``sin``
differ by a few ulps; that difference, carried through three softmax
rounds, stays far below the 1e-5 the scores are held to.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import devices
from repro_torch.configs.base import RecsysConfig
from repro_torch.dist.sharding import LocalTake
from repro_torch.kernels.embedding_bag.ref import lookup_ref
from repro_torch.nn import layers as L


def init(gen: torch.Generator, cfg: RecsysConfig, hot_rows: int = 0,
         device: str | torch.device = devices.DEFAULT_DEVICE) -> Dict:
    """Random MIND parameters drawn from ``gen`` (on its own device, so one
    seed gives the same parameters on every device), placed on ``device``.

    ``hot_rows > 0`` splits the popularity-ordered table at the GRASP
    High-Reuse boundary: ``items_hot`` + ``items_cold``. The range test
    ``id < hot_rows`` is the paper's ABR classification.
    """
    dev = devices.resolve(device)
    d = cfg.embed_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)

    p = {
        # shared bilinear map S for capsule routing (B2I variant)
        "s_mat": normal(d, d) / np.sqrt(d),
        "mlp": [L.dense_init(gen, d, cfg.d_hidden), L.dense_init(gen, cfg.d_hidden, d)],
    }
    if hot_rows > 0:
        p["items_hot"] = normal(hot_rows, d) * 0.05
        p["items_cold"] = normal(cfg.n_items - hot_rows, d) * 0.05
    else:
        p["items"] = normal(cfg.n_items, d) * 0.05
    return to_device(p, dev)


def to_device(params: Dict, device: torch.device) -> Dict:
    """The parameter dict with every tensor on ``device``."""
    out = {k: v.to(device) for k, v in params.items() if k != "mlp"}
    out["mlp"] = [{"w": layer["w"].to(device)} for layer in params["mlp"]]
    return out


COLD_FRACTION = 0.5  # bounded cold-path capacity (Zipf: ~8% of lookups
                     # miss a 2^18-row hot prefix; 0.5 is a safety margin)


def _device_of(params: Dict) -> torch.device:
    return params["s_mat"].device


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``lookup_ref(table, ids)``; a DTensor table (the row-sharded table of
    a cell on a mesh) by ``dist.sharding.LocalTake``."""
    if isinstance(table, DTensor):
        return LocalTake.apply(table, ids)
    return lookup_ref(table, ids)


def table_lookup(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """GRASP-classified lookup: ``ids.shape + (d,)`` rows.

    With a dense ``items`` table this is ``jnp.take``'s lookup. With a
    split table, hot ids read ``items_hot`` (negative ids read its row 0)
    and the first ``cap = max(int(n * COLD_FRACTION) // 256 * 256, 256)``
    cold references of the ``n`` ids, in order, read ``items_cold``. Cold
    references past ``cap`` get a zero row, as the JAX package's bounded
    compaction gives them (graceful degradation, like MoE token dropping).
    Each reference's rank among the cold ones is a running count, so the
    shapes never depend on the data: nothing waits for the device, and a
    step over sharded ids (a cell on a mesh) traces as it runs.
    """
    if "items_hot" not in params:
        return _take(params["items"], ids)
    h, d = params["items_hot"].shape
    shape = tuple(ids.shape)
    flat = ids.reshape(-1)
    n = flat.shape[0]
    cap = max(int(n * COLD_FRACTION) // 256 * 256, 256)

    hot = params["items_hot"].index_select(0, flat.clamp(0, h - 1))
    cold = flat >= h
    out = torch.where(cold[:, None], 0.0, hot)
    if params["items_cold"].shape[0]:
        kept = cold & (torch.cumsum(cold.to(torch.int32), 0) <= cap)
        rows = lookup_ref(params["items_cold"], torch.where(kept, flat - h, 0))
        out = torch.where(kept[:, None], rows, out)
    return out.reshape(shape + (d,))


def _squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def embedding_lookup(table, ids: torch.Tensor, impl: str = "plain", plan=None) -> torch.Tensor:
    """(B, H) ids -> (B, H, d). ``impl='hot'`` reads through the two-tier
    hot gather (K1) with the ``GraspPlan`` hot prefix (default: the rows
    that fit the card's L2)."""
    if impl == "plain":
        return table_lookup(table, ids) if isinstance(table, dict) else lookup_ref(table, ids)
    if impl == "hot":
        from repro_torch.kernels.embedding_bag import ops as bag_ops

        b, h = ids.shape
        out = bag_ops.hot_lookup(table, ids.reshape(-1).to(torch.int32), plan=plan)
        return out.reshape(b, h, -1)
    raise ValueError(impl)


def user_interests(params: Dict, cfg: RecsysConfig, hist, hist_mask,
                   impl: str = "plain", plan=None) -> torch.Tensor:
    """hist (B, H) item ids -> interest capsules (B, K, d).

    Dynamic routing (capsule_iters rounds) with fixed routing-logit init
    derived from item ids (deterministic, matches MIND's B2I)."""
    dev = _device_of(params)
    hist, hist_mask = _as_tensor(hist, dev), _as_tensor(hist_mask, dev)
    if impl != "plain" and torch.is_grad_enabled() and any(
            params[k].requires_grad for k in ("items", "items_hot", "items_cold") if k in params):
        raise RuntimeError(
            f"impl={impl!r} reads the item table through a kernel with no backward; "
            "train with impl='plain', or run under torch.no_grad()")
    if impl == "plain":
        e = table_lookup(params, hist)                              # (B, H, d)
    else:
        e = embedding_lookup(params["items"], hist, impl, plan)
    return user_interests_from_emb(params, cfg, e, hist, hist_mask)


def user_interests_from_emb(params: Dict, cfg: RecsysConfig, e: torch.Tensor,
                            hist: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
    """Routing from pre-gathered history embeddings ``e`` (B, H, d).

    The serving tier (``repro_torch.serve``) gathers ``e`` through its
    GRASP-managed embedding cache and hands it here, so the capsule math is
    shared between the parameter-table and cache-fed paths."""
    k = cfg.n_interests
    e = torch.where(hist_mask[..., None], e, e.new_zeros(()))
    eh = torch.einsum("bhd,de->bhe", e, params["s_mat"])              # bilinear map

    # deterministic routing-logit init (hash of item id x capsule)
    caps = 1.0 + torch.arange(k, dtype=torch.float32, device=e.device)
    logits = torch.sin(hist[..., None].to(torch.float32) * caps)       # (B, H, K)

    interests = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=-1)                              # (B, H, K)
        w = torch.where(hist_mask[..., None], w, w.new_zeros(()))
        z = torch.einsum("bhk,bhd->bkd", w, eh)
        interests = _squash(z)                                         # (B, K, d)
        logits = logits + torch.einsum("bkd,bhd->bhk", interests, eh)

    # per-interest MLP refinement
    h = L.dense(params["mlp"][0], interests, torch.float32)
    h = torch.relu(h)
    return interests + L.dense(params["mlp"][1], h, torch.float32)


def score_candidates(interests: torch.Tensor, cand_emb: torch.Tensor) -> torch.Tensor:
    """(B, K, d) interests x (B, C, d) candidates -> (B, C) max-over-interest
    scores (MIND serving reduction)."""
    scores = torch.einsum("bkd,bcd->bkc", interests, cand_emb)
    return scores.amax(dim=1)


def label_aware_attention(interests: torch.Tensor, target_emb: torch.Tensor,
                          p: float = 2.0) -> torch.Tensor:
    """MIND label-aware attention: the target (B, d) attends over the
    interests (B, K, d) with a softmax of ``p`` x the dot products."""
    scores = torch.einsum("bkd,bd->bk", interests, target_emb)
    w = torch.softmax(scores * p, dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def loss_fn(params: Dict, cfg: RecsysConfig, batch: Dict, impl: str = "plain",
            plan=None) -> torch.Tensor:
    """Sampled softmax: target vs shared negatives.

    batch: hist (B,H) int32, hist_mask (B,H) bool, target (B,) int32,
           negatives (Neg,) int32.
    """
    dev = _device_of(params)
    interests = user_interests(params, cfg, batch["hist"], batch["hist_mask"], impl, plan)
    tgt = table_lookup(params, _as_tensor(batch["target"], dev))      # (B, d)
    user = label_aware_attention(interests, tgt)                      # (B, d)
    neg = table_lookup(params, _as_tensor(batch["negatives"], dev))   # (Neg, d)
    pos_logit = torch.sum(user * tgt, dim=-1, keepdim=True)           # (B, 1)
    neg_logit = user @ neg.T                                          # (B, Neg)
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[:, 0].mean()


def serve_scores(params: Dict, cfg: RecsysConfig, batch: Dict, impl: str = "plain",
                 plan=None) -> torch.Tensor:
    """Online inference: score each request's candidate set.

    batch: hist (B,H), hist_mask (B,H), candidates (B, C) int32.
    Max-over-interests scoring (MIND serving)."""
    interests = user_interests(params, cfg, batch["hist"], batch["hist_mask"], impl, plan)
    cand = table_lookup(params, _as_tensor(batch["candidates"], _device_of(params)))
    return score_candidates(interests, cand)                          # (B, C)


def retrieval_scores(params: Dict, cfg: RecsysConfig, batch: Dict, impl: str = "plain",
                     plan=None) -> torch.Tensor:
    """One query against n_candidates (batched dot, no loop): the
    ``retrieval_cand`` shape. candidates (C,) int32 (C ~ 1e6)."""
    interests = user_interests(params, cfg, batch["hist"], batch["hist_mask"],
                               impl, plan)                            # (1, K, d)
    cand = table_lookup(params, _as_tensor(batch["candidates"], _device_of(params)))  # (C, d)
    scores = torch.einsum("bkd,cd->bkc", interests, cand)
    return scores.amax(dim=1)                                         # (1, C)
