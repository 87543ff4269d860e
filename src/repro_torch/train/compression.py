"""Gradient compression for the data-parallel all-reduce.

int8 per-tensor quantization with error feedback (EF-SGD, Karimireddy et
al. 2019): the quantization residual is carried into the next step, so the
compressed optimizer matches the exact one to first order. The JAX
package's functions over trees of tensors (``train.tree``, leaves in JAX's
order); ``torch.round`` rounds half to even as ``jnp.round`` does, and the
scale ``max|x| / 127 + 1e-12`` stays in float32. ``compressed_psum`` runs
over a ``torch.distributed`` process group that the caller initialised,
where the JAX package's runs inside ``shard_map`` over a mesh axis.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import require_group
from repro_torch.train.tree import flatten_up_to, tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads, error):
    """(grads + carried error) -> (quantized payloads, new error): the
    payload tree holds a ``(q, scale)`` pair where ``grads`` holds a leaf."""
    payloads, new_err = [], []
    for g, e in zip(tree_leaves(grads), flatten_up_to(grads, error)):
        target = g.to(torch.float32) + e
        q, s = quantize_int8(target)
        payloads.append((q, s))
        new_err.append(target - dequantize_int8(q, s))
    return tree_unflatten(grads, payloads), tree_unflatten(grads, new_err)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_psum(grads, error, group=None):
    """All-reduce int8-quantized gradients with error feedback over
    ``group`` (the default process group when None). Returns (mean grads
    f32, new error)."""
    require_group(group)
    payloads, new_err = ef_compress(grads, error)
    pairs = flatten_up_to(grads, payloads)
    if not pairs:
        return tree_unflatten(grads, []), new_err
    n = torch.ones((), device=pairs[0][1].device)
    dist.all_reduce(n, group=group)

    def reduce_one(q, s):
        # the sum of the ranks' int8 payloads (accumulated in int32) and of
        # their scales; each rank used its own scale, approximated here by
        # the mean scale (error feedback absorbs the residual)
        acc = q.to(torch.int32)
        dist.all_reduce(acc, group=group)
        ssum = s.clone()
        dist.all_reduce(ssum, group=group)
        return acc.to(torch.float32) * (ssum / n) / n

    return tree_unflatten(grads, [reduce_one(q, s) for q, s in pairs]), new_err
