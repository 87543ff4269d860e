"""Plain PyTorch version of the segment-reduce kernel, and the float64
check the kernel is held to on the card.

The wrapper in ``segment_reduce.py`` takes ``segment_stats_ref`` for
tensors on the CPU: the four calls PNA's blocked layer makes there, two
``index_add_`` and two ``torch.segment_reduce``.
"""
from __future__ import annotations

import math

import torch

# csrc/segment_reduce.cu's kStage (floats of messages a tile stages),
# kMaxItems (items of the merged list a tile owns) and kWarps
STAGE, MAX_ITEMS, WARPS = 16384, 2048, 8
U = 2.0 ** -24  # float32's unit roundoff
CHECK_EDGES = 1 << 22  # messages a chunk of the float64 check


def row_ids(offsets: torch.Tensor) -> torch.Tensor:
    """The row of each message of a CSR with ``offsets``, as int64."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(counts.shape[0], device=offsets.device), counts)


def extreme(m: torch.Tensor, offsets: torch.Tensor, reduce: str) -> torch.Tensor:
    """Each row's ``"max"`` or ``"min"`` of ``m`` by ``torch.segment_reduce``,
    0 where it is not finite (an empty row reduces to -inf/+inf)."""
    out = torch.segment_reduce(m, reduce, offsets=offsets, axis=0, unsafe=True)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_stats_ref(m: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``(E, d)`` messages sorted by row, ``(R + 1,)`` offsets -> ``(4, R,
    d)``: the rows' sums of ``m`` and of ``m * m`` (``index_add_`` into a
    zero base), and their maxima and minima (``extreme``)."""
    seg = row_ids(offsets)
    rows = (offsets.shape[0] - 1, m.shape[1])
    return torch.stack([m.new_zeros(rows).index_add_(0, seg, m),
                        m.new_zeros(rows).index_add_(0, seg, m * m),
                        extreme(m, offsets, "max"), extreme(m, offsets, "min")])


def tile_items(d: int) -> int:
    """Items of the merged list (row ends and messages) a tile of the kernel owns."""
    return min(STAGE // d, MAX_ITEMS)


def check(got: torch.Tensor, m: torch.Tensor, offsets: torch.Tensor) -> tuple[bool, float]:
    """Hold the kernel's ``(4, R, d)`` statistics of ``m`` to float64:
    (every sum and sum of squares within the kernel's error bound and every
    extreme equal to ``extreme``'s, NaN where it has NaN; the largest error
    over its bound). The bound (csrc/segment_reduce.cu) is (ceil(items / 8)
    + 25 + (length + 1) / items) float32 roundings of the row's sum of
    magnitudes, or of squares, for ``items = tile_items(d)``. Works on
    ``m``'s device, ``CHECK_EDGES`` messages at a time."""
    r, d = offsets.shape[0] - 1, m.shape[1]
    dev = m.device
    exact = torch.zeros((3, r, d), dtype=torch.float64, device=dev)  # sum, sum of squares, |m|
    seg = row_ids(offsets)
    for e0 in range(0, m.shape[0], CHECK_EDGES):
        x = m[e0:e0 + CHECK_EDGES].double()
        ids = seg[e0:e0 + CHECK_EDGES]
        exact[0].index_add_(0, ids, x)
        exact[2].index_add_(0, ids, x.abs())
        exact[1].index_add_(0, ids, x.mul_(x))
        del x
    items = tile_items(d)
    lengths = (offsets[1:] - offsets[:-1]).double()[:, None]
    roundings = math.ceil(items / WARPS) + 25 + (lengths + 1) / items
    worst, ok = 0.0, True
    for p, mag in ((0, exact[2]), (1, exact[1])):
        limit = roundings * U * mag
        err = (got[p].double() - exact[p]).abs()
        nan = torch.isnan(exact[p])
        ok = ok and torch.equal(torch.isnan(got[p]), nan)
        fin = torch.isfinite(exact[p])
        ok = ok and bool((err[fin] <= limit[fin]).all())
        ok = ok and torch.equal(got[p][~fin & ~nan], exact[p][~fin & ~nan].float())
        if bool(fin.any()):
            worst = max(worst, float((err[fin] / limit[fin].clamp(min=1e-300)).max()))
    del exact, seg
    for p, reduce in ((2, "max"), (3, "min")):
        ok = ok and torch.equal(got[p], extreme(m, offsets, reduce))
    return ok, worst
