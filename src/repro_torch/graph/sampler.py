"""Fanout neighbour sampler (GraphSAGE-style) for ``minibatch_lg``.

Host-side numpy sampling producing fixed-shape (padded + masked) subgraph
arrays: seeds (B,), per-level sampled neighbours with fanouts (15, 10).
Local node ids: [seeds | level-1 | level-2] so the edge arrays have one
shape per fanout spec. The same ``numpy.random.Generator`` state gives the
JAX package's blocks bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSR


@dataclasses.dataclass(frozen=True)
class SampledBlocks:
    node_ids: np.ndarray   # (n_sub,) global ids (padded with 0)
    node_mask: np.ndarray  # (n_sub,) valid
    src: np.ndarray        # (E_sub,) local ids
    dst: np.ndarray        # (E_sub,) local ids
    emask: np.ndarray      # (E_sub,)
    seeds_local: np.ndarray  # (B,) local ids of the seed nodes (= arange(B))

    @property
    def n_sub(self) -> int:
        return int(self.node_ids.shape[0])


def subgraph_shape(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """(n_sub, e_sub) static shapes for a fanout spec."""
    n = batch_nodes
    total_nodes, total_edges, width = n, 0, n
    for f in fanout:
        width *= f
        total_nodes += width
        total_edges += width
    return total_nodes, total_edges


def sample_blocks(g: CSR, seeds: np.ndarray, fanout: tuple[int, ...],
                  rng: np.random.Generator) -> SampledBlocks:
    """Uniform neighbour sampling, fixed fanout with padding (repeat-sample
    when degree < fanout, mask when degree == 0)."""
    indptr, indices = g.indptr, g.indices
    frontier = seeds.astype(np.int64)
    frontier_mask = np.ones_like(frontier, dtype=bool)
    all_nodes = [frontier]
    all_masks = [frontier_mask]
    srcs, dsts, emasks = [], [], []
    offset = 0  # local id offset of the current frontier

    for f in fanout:
        deg = indptr[frontier + 1] - indptr[frontier]
        # sample f neighbours per frontier node (with replacement)
        r = rng.integers(0, 2**31 - 1, size=(frontier.shape[0], f))
        has_nbr = (deg > 0) & frontier_mask
        pick = np.where(
            has_nbr[:, None], indptr[frontier][:, None] + r % np.maximum(deg, 1)[:, None], 0
        )
        nbr = np.where(has_nbr[:, None], indices[pick], 0).reshape(-1)
        nbr_mask = np.repeat(has_nbr, f)
        # edges: sampled neighbour (src, local) -> frontier node (dst, local)
        next_offset = offset + frontier.shape[0]
        src_local = next_offset + np.arange(nbr.shape[0])
        dst_local = offset + np.repeat(np.arange(frontier.shape[0]), f)
        srcs.append(src_local)
        dsts.append(dst_local)
        emasks.append(nbr_mask)
        all_nodes.append(nbr)
        all_masks.append(nbr_mask)
        frontier = nbr
        frontier_mask = nbr_mask
        offset = next_offset

    return SampledBlocks(
        node_ids=np.concatenate(all_nodes).astype(np.int32),
        node_mask=np.concatenate(all_masks),
        src=np.concatenate(srcs).astype(np.int32),
        dst=np.concatenate(dsts).astype(np.int32),
        emask=np.concatenate(emasks),
        seeds_local=np.arange(seeds.shape[0], dtype=np.int32),
    )
