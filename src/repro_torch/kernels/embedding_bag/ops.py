"""Hot-cached embedding lookup and bag with the bounded cold fixup.

``hot_lookup`` reads rows through the two-tier hot gather (K1 over the whole
table); ``hot_bag`` sums bags through K3's two-tier mode, hot and cold rows
in one launch, the JAX package's cold fixup (compact the masked cold pairs,
gather, segment-sum) folded into the kernel as a second sum per bag.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import GraspPlan
from repro_torch.kernels.embedding_bag.embedding_bag import hot_bag_two_tier
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
    """Fused EmbeddingBag(sum) -> ``(B, d)`` float32: one K3 launch over the
    whole table, bag ``b`` the sum of its hot rows (``id < hot_size``) plus
    the sum of its masked cold rows, of which only the first
    ``cold_capacity`` in flat order count.

    As in the JAX package: negative ids add nothing, a masked-in id at or
    above ``V`` adds a NaN row, and cold pairs past ``cold_capacity``
    (default ``B*H``) are dropped. Below ``B*H`` a device-side scan ranks
    the cold pairs; there is no host sync.
    """
    v = table.shape[0]
    b, hlen = ids.shape
    hot_size = min(hot_size, v)
    if cold_capacity is None:
        cold_capacity = b * hlen
    if cold_capacity < 0:
        raise ValueError(f"cold_capacity must be >= 0, got {cold_capacity}")
    # inclusive rank of each cold pair in flat order (the JAX package's pos + 1)
    rank = (torch.cumsum((mask & (ids >= hot_size)).view(-1), 0, dtype=torch.int32)
            .view(b, hlen) if cold_capacity < b * hlen else None)
    return hot_bag_two_tier(table, ids, mask, hot_size, rank, cold_capacity)
