"""Plain PyTorch versions for the hot-cached embedding bag.

``lookup_ref`` and ``bag_ref`` are the oracles of the whole operation;
``hot_bag_ref`` and ``hot_bag_two_tier_ref`` are K3's plain versions in its
two modes, which the wrappers in ``embedding_bag.py`` take for tensors on
the CPU and which the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def lookup_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(V, d)`` table, ids of any shape -> ``ids.shape + (d,)``.

    ``jnp.take(table, ids, axis=0)`` as the JAX package computes it: an id
    in ``[-V, 0)`` counts from the end, and an id outside ``[-V, V)``
    gives a NaN row.
    """
    v = table.shape[0]
    wrapped = torch.where(ids < 0, ids + v, ids)
    ok = (wrapped >= 0) & (wrapped < v)
    flat = wrapped.reshape(-1).clamp(0, max(v - 1, 0))
    rows = table.index_select(0, flat).reshape(tuple(ids.shape) + tuple(table.shape[1:]))
    return torch.where(ok.reshape(tuple(ids.shape) + (1,) * (table.dim() - 1)), rows,
                       rows.new_full((), float("nan")))


def bag_ref(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag(sum): ``(V, d)`` table, ``(B, H)`` ids + mask -> ``(B, d)``."""
    rows = lookup_ref(table, ids)                        # (B, H, d)
    return torch.where(mask[..., None], rows, rows.new_zeros(())).sum(dim=1)


def hot_bag_ref(hot: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K3: ``(H_rows, d)`` hot rows, ``(B, H)`` int32 ids and bool mask ->
    ``(B, d)`` float32.

    Bag ``b`` sums ``hot[ids[b, h]]`` over the positions ``h`` with
    ``mask[b, h]`` and ``0 <= ids[b, h] < H_rows``, one position after the
    other in float32, as the kernel does, so the two agree bit for bit.
    """
    hr, d = hot.shape
    b, hlen = ids.shape
    acc = torch.zeros((b, d), dtype=torch.float32, device=hot.device)
    if hr == 0:
        return acc
    hit = mask & (ids >= 0) & (ids < hr)
    safe = ids.clamp(0, hr - 1)
    for h in range(hlen):
        rows = hot.index_select(0, safe[:, h]).float()
        acc = acc + torch.where(hit[:, h, None], rows, rows.new_zeros(()))
    return acc


def hot_bag_two_tier_ref(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                         hot_size: int, cold_rank: Optional[torch.Tensor] = None,
                         cold_capacity: int = 0) -> torch.Tensor:
    """K3's two-tier mode: ``(V, d)`` table, ``(B, H)`` int32 ids and bool
    mask -> ``(B, d)`` float32.

    Bag ``b`` is ``hot_sum + cold_sum``, the two float32 sums taken one
    position after the other, as the kernel does, so the two agree bit for
    bit: ``hot_sum`` adds ``table[id]`` for the masked-in ids in
    ``[0, hot_size)``, ``cold_sum`` for those in ``[hot_size, V)`` and a NaN
    for each one ``>= V``. Negative and masked-out ids add nothing; with
    ``cold_rank`` (the inclusive count of masked-in ids ``>= hot_size`` up to
    each position in flat order), cold ids ranked past ``cold_capacity`` add
    nothing.
    """
    v, d = table.shape
    b, hlen = ids.shape
    live = mask & (ids >= 0)
    hot = live & (ids < hot_size)
    cold = live & (ids >= hot_size)
    if cold_rank is not None:
        cold &= cold_rank <= cold_capacity
    past = ids >= v
    safe = ids.clamp(0, max(v - 1, 0))
    hot_sum = torch.zeros((b, d), dtype=torch.float32, device=table.device)
    cold_sum = torch.zeros_like(hot_sum)
    for h in range(hlen):
        rows = (table.index_select(0, safe[:, h]).float() if v
                else hot_sum.new_zeros((b, d)))
        hot_sum = hot_sum + torch.where(hot[:, h, None], rows, rows.new_zeros(()))
        rows = torch.where(past[:, h, None], float("nan"), rows)
        cold_sum = cold_sum + torch.where(cold[:, h, None], rows, rows.new_zeros(()))
    return hot_sum + cold_sum
