"""Synthetic, seeded LM, recsys and GNN batches (numpy, host side).

Token ids and recsys item ids are Zipf-distributed: the skew GRASP
exploits. GNN batches
come from RMAT graphs (a full graph), random small molecules, or the
fanout sampler (a minibatch). The same ``numpy.random.Generator`` state
gives the same arrays as the JAX package's pipeline, so both packages can
be fed one stream. The streams (``batches``, ``make_batch_fn``) seed each
step with ``(seed, step)``, so fault-tolerant restarts replay; the
``Prefetcher`` draws them on a background thread (double buffering).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import GNNShape, LMConfig, RecsysConfig, RecsysShape
from repro_torch.graph import generate, sampler


def zipf_ids(rng: np.random.Generator, shape, vocab: int, a: float = 1.2) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) — id 0 is the hottest (the
    popularity-ordered layout the GRASP plan expects)."""
    raw = rng.zipf(a, size=shape)
    return np.minimum(raw - 1, vocab - 1).astype(np.int32)


def lm_batch(rng: np.random.Generator, cfg: LMConfig, batch: int, seq: int) -> Dict:
    """Zipf tokens (B, S) and their next tokens as labels."""
    tokens = zipf_ids(rng, (batch, seq + 1), cfg.vocab)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].astype(np.int32)}


def recsys_batch(rng: np.random.Generator, cfg: RecsysConfig, shape: RecsysShape) -> Dict:
    """One batch of ``shape``: Zipf histories with a 0.9 keep mask, and
    per kind the training targets and negatives or the candidates to
    score (drawn uniformly, not Zipf)."""
    b = shape.batch
    hist = zipf_ids(rng, (b, cfg.hist_len), cfg.n_items)
    hist_mask = rng.random((b, cfg.hist_len)) < 0.9
    out = {"hist": hist, "hist_mask": hist_mask}
    if shape.kind == "train":
        out["target"] = zipf_ids(rng, (b,), cfg.n_items)
        out["negatives"] = rng.integers(0, cfg.n_items, cfg.n_negatives).astype(np.int32)
    elif shape.kind == "serve":
        out["candidates"] = rng.integers(0, cfg.n_items, (b, 64)).astype(np.int32)
    elif shape.kind == "retrieval":
        out["candidates"] = rng.integers(0, cfg.n_items, shape.n_candidates).astype(np.int32)
    return out


def gnn_full_graph_batch(rng: np.random.Generator, shape: GNNShape,
                         n_classes: int = 47, scale_override: Optional[int] = None) -> Dict:
    """Synthetic stand-in with the requested node/edge counts (RMAT skew).
    ``scale_override`` shrinks for smoke tests."""
    if scale_override is not None:
        n = 1 << scale_override
        e = n * max(shape.n_edges // max(shape.n_nodes, 1), 2)
    else:
        n, e = shape.n_nodes, shape.n_edges
    g = generate.rmat(int(np.ceil(np.log2(n))), max(e // (1 << int(np.ceil(np.log2(n)))), 1),
                      seed=int(rng.integers(0, 2**31)))
    nn_, ee = g.num_nodes, g.num_edges
    pad = (-ee) % 512  # shardability padding, as the JAX package pads
    src = np.pad(g.indices.astype(np.int32), (0, pad))
    dst = np.pad(g.dst_ids().astype(np.int32), (0, pad))
    emask = np.pad(np.ones(ee, bool), (0, pad))
    ee += pad
    return {
        "x": rng.standard_normal((nn_, shape.d_feat)).astype(np.float32),
        "src": src,
        "dst": dst,
        "emask": emask,
        "labels": rng.integers(0, n_classes, nn_).astype(np.int32),
        "coords": rng.standard_normal((nn_, 3)).astype(np.float32),
        "species": rng.integers(0, 8, nn_).astype(np.int32),
    }


def gnn_molecule_batch(rng: np.random.Generator, shape: GNNShape) -> Dict:
    """Batched small molecules, flattened with graph_id segments."""
    bg, n, e = shape.batch_graphs, shape.n_nodes, shape.n_edges
    nn_ = bg * n
    coords = rng.standard_normal((nn_, 3)).astype(np.float32) * 2.0
    src = np.concatenate([rng.integers(0, n, e) + i * n for i in range(bg)])
    dst = np.concatenate([rng.integers(0, n, e) + i * n for i in range(bg)])
    keep = src != dst
    return {
        "x": rng.standard_normal((nn_, shape.d_feat)).astype(np.float32),
        "src": src.astype(np.int32),
        "dst": dst.astype(np.int32),
        "emask": keep,
        "coords": coords,
        "species": rng.integers(0, 8, nn_).astype(np.int32),
        "graph_id": np.repeat(np.arange(bg), n).astype(np.int32),
        "labels": rng.standard_normal(bg).astype(np.float32),
    }


def gnn_minibatch(rng: np.random.Generator, g, shape: GNNShape, d_feat: int,
                  n_classes: int = 47) -> Dict:
    """Uniform seeds expanded by the fanout sampler into one block graph."""
    seeds = rng.integers(0, g.num_nodes, shape.batch_nodes)
    blocks = sampler.sample_blocks(g, seeds, tuple(shape.fanout), rng)
    return {
        "x": rng.standard_normal((blocks.n_sub, d_feat)).astype(np.float32),
        "src": blocks.src,
        "dst": blocks.dst,
        "emask": blocks.emask,
        "labels": rng.integers(0, n_classes, shape.batch_nodes).astype(np.int32),
        "seeds": blocks.seeds_local,
        "coords": rng.standard_normal((blocks.n_sub, 3)).astype(np.float32),
        "species": rng.integers(0, 8, blocks.n_sub).astype(np.int32),
    }


class Prefetcher:
    """Background-thread double buffering around a batch function."""

    def __init__(self, make_batch: Callable[[int], Dict], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._make = make_batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def __iter__(self) -> Iterator[Dict]:
        return self

    def close(self):
        self._stop.set()


def _batch(kind: str, rng: np.random.Generator, cfg, shape) -> Dict:
    if kind == "lm":
        return lm_batch(rng, cfg, shape.global_batch, shape.seq_len)
    if kind == "recsys":
        return recsys_batch(rng, cfg, shape)
    raise ValueError(kind)


def batches(kind: str, cfg, shape, seed: int = 0) -> Iterator[Dict]:
    """Deterministic batch stream (seeded per step — FT restarts replay)."""
    step = 0
    while True:
        yield _batch(kind, np.random.default_rng((seed, step)), cfg, shape)
        step += 1


def make_batch_fn(kind: str, cfg, shape, seed: int = 0) -> Callable[[int], Dict]:
    """Deterministic step->batch function (FT restarts replay bit-exact)."""
    def fn(step: int) -> Dict:
        return _batch(kind, np.random.default_rng((seed, step)), cfg, shape)

    return fn
