"""Plain PyTorch version of the segment-sum kernel.

The wrapper in ``segment_sum.py`` takes it for tensors on the CPU; on the
card it is what the kernel is held against.
"""
from __future__ import annotations

import torch


def row_ids(indptr: torch.Tensor, n: int) -> torch.Tensor:
    """The row of each position of a CSR with offsets ``indptr``: the
    ``dst`` of a ``DeviceCSR``, as int64."""
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), counts)


def segment_sum_ref(data: torch.Tensor, indptr: torch.Tensor, n: int) -> torch.Tensor:
    """``(E,)`` float32 messages in CSR order, ``(n + 1,)`` offsets ->
    ``(n,)`` float32: ``index_add_`` of the messages into a zero base at
    their rows' ids, which on the CPU gives the bits of ``index_add_`` over
    the CSR's ``dst``. A row with no messages holds 0."""
    return data.new_zeros(n).index_add_(0, row_ids(indptr, n), data)
