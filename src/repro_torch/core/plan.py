"""GraspPlan — the residency plan (GPU counterpart of the paper's ABRs).

``GraspPlan`` carries the information the paper's ABRs + classification
logic provide, resolved at plan time:

  * ``hot_size``       number of leading Property-Array elements (after
                       skew-aware reordering) that fit the budget — the High
                       Reuse Region.
  * ``moderate_size``  the next budget's worth — the Moderate Reuse Region.
  * element geometry   so byte bounds can be recovered for the LLC
                       simulator / trace generator.

On Hopper the High Reuse Region is the part of the Property Array that the
hot-gather kernel loads with an L2 ``evict_last`` hint, so the default
budget is the card's L2 capacity: the paper sizes the High Reuse Region to
the LLC.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.regions import GraspRegions, make_regions

# NVIDIA H100 L2 capacity (Hopper architecture white paper), used when no
# card is present to ask.
H100_L2_BYTES = 50 * 1024 * 1024


def default_budget_bytes() -> int:
    """L2 capacity of the current CUDA device, or the H100's without a card."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return int(props.L2_cache_size)
    return H100_L2_BYTES


def entries_for_budget(
    budget_bytes: int,
    elem_bytes: int,
    align: int = 1,
    max_entries: Optional[int] = None,
) -> int:
    """How many ``elem_bytes``-sized rows fit a fast-memory byte budget.

    ``align`` rounds down to a multiple (tile-aligned hot blocks);
    ``max_entries`` clamps to the table length.
    """
    n = max(int(budget_bytes), 0) // max(int(elem_bytes), 1)
    if max_entries is not None:
        n = min(n, int(max_entries))
    if align > 1:
        n -= n % align
    return int(n)


@dataclasses.dataclass(frozen=True)
class GraspPlan:
    num_elems: int          # Property Array length (vertices / table rows)
    elem_bytes: int         # bytes per element (after array merging)
    hot_size: int           # elements in the High Reuse Region
    moderate_size: int      # elements in the Moderate Reuse Region
    budget_bytes: int       # fast-memory budget backing hot_size
    num_arrays: int = 1     # Property Arrays sharing the budget

    @property
    def enabled(self) -> bool:
        return self.hot_size > 0

    @property
    def cold_size(self) -> int:
        return self.num_elems - self.hot_size

    def regions(self) -> GraspRegions:
        """Byte-granular region view for the LLC simulator.

        The High Reuse Region covers exactly ``hot_size`` elements, which
        already embodies the paper's LLC_size / num_arrays division.
        """
        return make_regions(
            [(0, self.num_elems * self.elem_bytes)],
            llc_bytes=max(self.hot_size * self.elem_bytes, 1),
        )

    def classify_elem(self, idx: np.ndarray) -> np.ndarray:
        """0=hot, 1=moderate, 2=cold for element indices (range test)."""
        idx = np.asarray(idx)
        return np.where(
            idx < self.hot_size,
            0,
            np.where(idx < self.hot_size + self.moderate_size, 1, 2),
        ).astype(np.int8)


def make_plan(
    num_elems: int,
    elem_bytes: int,
    budget_bytes: Optional[int] = None,
    num_arrays: int = 1,
    align: int = 1,
) -> GraspPlan:
    """Size the High/Moderate regions from a byte budget.

    ``budget_bytes`` defaults to :func:`default_budget_bytes` (the L2).
    ``align`` rounds hot_size down to a multiple. On no-skew inputs the plan
    is identical — robustness comes from the *policies* staying flexible,
    not from disabling the plan (paper Sec. V-B).
    """
    if budget_bytes is None:
        budget_bytes = default_budget_bytes()
    per_array = budget_bytes // max(num_arrays, 1)
    hot = entries_for_budget(per_array, elem_bytes, align=align,
                             max_entries=num_elems)
    mod = min(per_array // elem_bytes, num_elems - hot)
    return GraspPlan(
        num_elems=int(num_elems),
        elem_bytes=int(elem_bytes),
        hot_size=int(hot),
        moderate_size=int(mod),
        budget_bytes=int(budget_bytes),
        num_arrays=int(num_arrays),
    )
