"""Dense layer and layer norm as plain parameter dictionaries:
``dense_init(gen, ...) -> {"w": (d_in, d_out)}`` and ``dense(params, x,
compute_dtype)``; ``layernorm_init(d) -> {"g", "b"}`` and
``layernorm(params, x)``.

float32 products stay full float32 on the card: PyTorch leaves TF32 off for
matrix products by default (``torch.backends.cuda.matmul.allow_tf32`` is
False), and the port does not turn it on. MIND calls ``dense`` in float32,
so its scores can be held to the JAX package's float32 results at 1e-5.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None):
    """Normal(0, ``scale``) weights, ``scale`` = 1/sqrt(d_in) by default,
    drawn from ``gen`` on its device."""
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return {"w": w * scale}


def dense(params, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w`` over the last axis, both cast to ``compute_dtype`` first."""
    return torch.matmul(x.to(compute_dtype), params["w"].to(compute_dtype))


def layernorm_init(d: int):
    return {"g": torch.ones((d,), dtype=torch.float32),
            "b": torch.zeros((d,), dtype=torch.float32)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in float32 (population variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * params["g"] + params["b"]).to(x.dtype)
