"""Synthetic, seeded recsys batches (numpy, host side).

Recsys item ids are Zipf-distributed: the skew GRASP exploits. The same
``numpy.random.Generator`` state gives the same ids as the JAX package's
pipeline, so both packages can be fed one stream.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import RecsysConfig, RecsysShape


def zipf_ids(rng: np.random.Generator, shape, vocab: int, a: float = 1.2) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) — id 0 is the hottest (the
    popularity-ordered layout the GRASP plan expects)."""
    raw = rng.zipf(a, size=shape)
    return np.minimum(raw - 1, vocab - 1).astype(np.int32)


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
