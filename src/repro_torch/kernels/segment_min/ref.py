"""Plain PyTorch version of the segment-min kernel.

The wrapper in ``segment_min.py`` takes it for tensors on the CPU; on the
card it is what the kernel is held against.
"""
from __future__ import annotations

import torch


def segment_min_ref(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``(E,)`` float32 messages, ``(E,)`` int32 ids -> ``(n,)`` float32.

    ``out[s]`` is the least message with id ``s``, or +inf for a segment
    with none; a NaN message makes its segment NaN. An id outside ``[0, n)``
    raises.
    """
    out = torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg.long(), data, reduce="amin", include_self=True)
