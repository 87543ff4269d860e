"""GRASP software-hardware interface + classification logic (paper Sec. III-A/B).

An :class:`ABR` (Address Bound Registers) pair delimits one Property Array.
GRASP labels the first LLC-sized chunk the *High Reuse Region*, the next
LLC-sized chunk the *Moderate Reuse Region*; everything else in the array is
*Low-Reuse* and any address outside all registered arrays is *Default*
(domain-specialized management disabled). When an application registers K
Property Arrays, each array's region budget is LLC_size / K (paper: "GRASP
divides LLC-size by the number of Property Arrays").

Classification is a pure range test — evaluated here both as a host-side
numpy function (for trace generation) and a torch function on a tensor's
own device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# 2-bit Reuse Hint encoding (paper Fig. 4)
HIGH, MODERATE, LOW, DEFAULT = np.int8(0), np.int8(1), np.int8(2), np.int8(3)


@dataclasses.dataclass(frozen=True)
class ABR:
    """One Property Array's bounds (virtual-address analogue: byte offsets)."""

    start: int  # inclusive
    end: int    # exclusive


@dataclasses.dataclass(frozen=True)
class GraspRegions:
    """Derived High/Moderate region bounds for a set of Property Arrays."""

    abrs: tuple[ABR, ...]
    llc_bytes: int

    @property
    def region_bytes(self) -> int:
        return self.llc_bytes // max(len(self.abrs), 1)

    def bounds(self, i: int) -> tuple[int, int, int, int]:
        """(high_lo, high_hi, mod_hi, array_hi) byte offsets of array i."""
        a = self.abrs[i]
        rb = self.region_bytes
        high_hi = min(a.start + rb, a.end)
        mod_hi = min(high_hi + rb, a.end)
        return a.start, high_hi, mod_hi, a.end

    def classify(self, addr: np.ndarray) -> np.ndarray:
        """Vectorized host-side classification of byte addresses -> hints."""
        addr = np.asarray(addr)
        hint = np.full(addr.shape, DEFAULT, dtype=np.int8)
        for i in range(len(self.abrs)):
            lo, high_hi, mod_hi, hi = self.bounds(i)
            inside = (addr >= lo) & (addr < hi)
            hint = np.where(inside & (addr < high_hi), HIGH, hint)
            hint = np.where(inside & (addr >= high_hi) & (addr < mod_hi), MODERATE, hint)
            hint = np.where(inside & (addr >= mod_hi), LOW, hint)
        return hint

    def classify_tensor(self, addr: torch.Tensor) -> torch.Tensor:
        """:meth:`classify` on a tensor, computed on the tensor's device."""
        hint = torch.full(addr.shape, int(DEFAULT), dtype=torch.int8, device=addr.device)
        for i in range(len(self.abrs)):
            lo, high_hi, mod_hi, hi = self.bounds(i)
            inside = (addr >= lo) & (addr < hi)
            hint = torch.where(inside & (addr < high_hi), int(HIGH), hint)
            hint = torch.where(
                inside & (addr >= high_hi) & (addr < mod_hi), int(MODERATE), hint
            )
            hint = torch.where(inside & (addr >= mod_hi), int(LOW), hint)
        return hint


def make_regions(array_bounds: Sequence[tuple[int, int]], llc_bytes: int) -> GraspRegions:
    return GraspRegions(
        abrs=tuple(ABR(lo, hi) for lo, hi in array_bounds),
        llc_bytes=int(llc_bytes),
    )
