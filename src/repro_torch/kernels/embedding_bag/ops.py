"""Hot-cached embedding lookup and bag with the bounded cold fixup.

``hot_lookup`` reads rows through the two-tier hot gather (K1 plus its
cold fixup); ``hot_bag`` sums bags through K3 over the hot prefix, then
compacts the masked cold (id, bag) pairs, gathers their rows from the full
table once and adds them to their bags.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import GraspPlan
from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_hot_part
from repro_torch.kernels.embedding_bag.ref import lookup_ref
from repro_torch.kernels.hot_gather.ops import hot_gather


def hot_lookup(table: torch.Tensor, ids: torch.Tensor,
               plan: Optional[GraspPlan] = None) -> torch.Tensor:
    """``(V, d)`` x ``(B,)`` int32 -> ``(B, d)``: the hot prefix through K1,
    cold rows by the bounded fixup (``hot_gather``'s semantics).

    The hot prefix is ``plan.hot_size`` rows, or by default the rows that
    fit the card's L2 (``core.plan.default_budget_bytes``).
    """
    if plan is not None:
        hot_size = plan.hot_size
    else:
        hot_size = plan_mod.entries_for_budget(
            plan_mod.default_budget_bytes(), table.shape[1] * table.element_size(),
            max_entries=table.shape[0])
    return hot_gather(table, ids, hot_size=hot_size)


def hot_bag(
    table: torch.Tensor,       # (V, d)
    ids: torch.Tensor,         # (B, H) int32
    mask: torch.Tensor,        # (B, H) bool
    hot_size: int,
    cold_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Fused EmbeddingBag(sum) -> ``(B, d)`` float32: K3 sums the hot rows;
    the masked cold pairs (``id >= hot_size``), the first ``cold_capacity``
    of them in flat order, are gathered once and added to their bags.

    As in the JAX package: negative ids add nothing, a masked-in id at or
    above ``V`` adds a NaN row, and cold pairs past ``cold_capacity``
    (default ``B*H``) are dropped. The compaction synchronises with the
    device (its size comes from the data).
    """
    v, d = table.shape
    b, hlen = ids.shape
    hot_size = min(hot_size, v)
    if cold_capacity is None:
        cold_capacity = b * hlen
    if cold_capacity < 0:
        raise ValueError(f"cold_capacity must be >= 0, got {cold_capacity}")

    out = hot_bag_hot_part(table[:hot_size], ids, mask)

    # cold fixup: the first cold_capacity masked cold pairs, in flat order
    flat_ids = ids.reshape(-1)
    cold = mask.reshape(-1) & (flat_ids >= hot_size)
    cold_pos = torch.nonzero(cold).squeeze(1)[:cold_capacity]
    if cold_pos.numel():
        rows = lookup_ref(table, flat_ids[cold_pos]).float()
        fix = torch.zeros_like(out).index_add_(0, cold_pos // hlen, rows)
        out = out + fix
    return out
