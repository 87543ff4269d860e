"""Compressed Sparse Row graph representation.

The CSR encodes *in-edges* for pull-based computation (paper Sec. II-B):
``indptr[v] : indptr[v+1]`` is the slice of ``indices`` holding the source
vertex ids of v's in-edges. For push-based computation the same structure
encodes out-edges (sources become destinations); :func:`transpose` converts
between the two.

Arrays are plain numpy on the host; :meth:`CSR.device` returns a
:class:`DeviceCSR` of torch tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import devices


@dataclasses.dataclass(frozen=True)
class CSR:
    """In-edge CSR. ``indices[indptr[v]:indptr[v+1]]`` = in-neighbours of v."""

    indptr: np.ndarray   # (num_nodes + 1,) int64
    indices: np.ndarray  # (num_edges,) int32 — source vertex of each in-edge
    num_nodes: int
    weights: Optional[np.ndarray] = None  # (num_edges,) float32, optional

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def in_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_nodes).astype(np.int64)

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)

    def dst_ids(self) -> np.ndarray:
        """Destination vertex id of every edge, aligned with ``indices``."""
        return np.repeat(
            np.arange(self.num_nodes, dtype=np.int32), np.diff(self.indptr)
        )

    def device(self, device: str | torch.device = devices.DEFAULT_DEVICE) -> "DeviceCSR":
        dev = devices.resolve(device)

        def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        return DeviceCSR(
            indptr=put(self.indptr, torch.int32),
            indices=put(self.indices, torch.int32),
            dst=put(self.dst_ids(), torch.int32),
            weights=(
                put(self.weights, torch.float32) if self.weights is not None else None
            ),
            num_nodes=self.num_nodes,
        )


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Edge-list view for device segment ops (COO with CSR ordering)."""

    indptr: torch.Tensor   # (num_nodes + 1,) int32
    indices: torch.Tensor  # (num_edges,) int32 — source of each edge
    dst: torch.Tensor      # (num_edges,) int32 — destination of each edge (same order)
    weights: Optional[torch.Tensor]
    num_nodes: int


def out_degree_sum(indptr: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The edges out of the active rows of a CSR, as a 0-d int64 tensor (no
    host read: the mask is applied with ``where``)."""
    return torch.where(active, indptr[1:] - indptr[:-1], 0).sum(dtype=torch.int64)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
) -> CSR:
    """Build an in-edge CSR from (src, dst) edge endpoints."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = (src != dst)  # drop self loops
    src, dst = src[keep], dst[keep]
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)[keep]
    if dedup:
        key = dst * num_nodes + src
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
        if weights is not None:
            weights = weights[uniq]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if weights is not None:
        weights = weights[order]
    counts = np.bincount(dst, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=src.astype(np.int32),
        num_nodes=num_nodes,
        weights=weights,
    )


def transpose(g: CSR) -> CSR:
    """Swap edge direction (in-edge CSR <-> out-edge CSR)."""
    return from_edges(g.dst_ids(), g.indices, g.num_nodes, g.weights, dedup=False)


def symmetrize(g: CSR) -> CSR:
    src, dst = g.indices, g.dst_ids()
    return from_edges(
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        g.num_nodes,
        dedup=True,
    )


def apply_reorder(g: CSR, rank: np.ndarray) -> CSR:
    """Renumber vertices: old vertex v becomes new vertex ``rank[v]``.

    ``rank`` must be a permutation of 0..N-1. Property arrays indexed by new
    vertex id must be built as ``prop_new[rank] = prop_old`` by the caller.
    """
    rank = np.asarray(rank, dtype=np.int64)
    assert rank.shape[0] == g.num_nodes
    new_src = rank[g.indices]
    new_dst = rank[g.dst_ids()]
    return from_edges(new_src, new_dst, g.num_nodes, g.weights, dedup=False)
