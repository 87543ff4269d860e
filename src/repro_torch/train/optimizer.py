"""Optimizers: SGD (+momentum), AdamW (optional bf16 moments), Adafactor.

The JAX package's own optimizers, with its API and state layout:
``make(cfg) -> (init, update)`` with

  init(params) -> state
  update(grads, state, params) -> (new_params, new_state)

over trees of tensors (``train.tree``; ``None`` leaves stay ``None`` in the
state and are skipped). SGD's state is ``{"mu", "step"}``, AdamW's
``{"m", "v", "step"}``, Adafactor's ``{"v", "step"}`` with ``{"vr", "vc"}``
(factored matrices) or ``{"v"}`` a parameter; ``step`` is an int32 scalar
tensor on the parameters' device. Every update is out of place, so a
caller's tensors are never changed, and runs under ``torch.no_grad()``.

``torch.optim`` is not used: its AdamW applies the weight decay before the
Adam step (another rounding), its state is laid out differently and its
Adafactor is another algorithm. The arithmetic here follows the JAX
package's expression by expression, in float32: bias corrections and
Adafactor's decay come from the float32 step, Python constants enter as
float32, and the global norm adds the leaves' sums in flatten order.

Adafactor (Shazeer & Stern 2018) factors the second moment of matrices into
row/col statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.train.tree import flatten_up_to, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # sgd | adamw | adafactor
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves Adam state memory
    momentum: float = 0.9          # sgd
    factored_eps: float = 1e-30    # adafactor


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in flatten order."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm). A leaf comes back
    in its dtype promoted with float32, as the JAX package's product with a
    float32 scalar gives it."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, torch.float32)) * scale,
                    grads), gnorm


def _first_device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_first_device(params))


def make(cfg: OptConfig):
    if cfg.name == "sgd":
        return _make_sgd(cfg)
    if cfg.name == "adamw":
        return _make_adamw(cfg)
    if cfg.name == "adafactor":
        return _make_adafactor(cfg)
    raise ValueError(cfg.name)


def _make_sgd(cfg: OptConfig):
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        mu = tree_map(lambda m, g: cfg.momentum * m + g, state["mu"], grads)
        new_params = tree_map(lambda p, m: p - cfg.lr * m, params, mu)
        return new_params, {"mu": mu, "step": state["step"] + 1}

    return init, update


def _make_adamw(cfg: OptConfig):
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        return {"m": tree_map(z, params), "v": tree_map(z, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            gf = g.float()
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
            return p - cfg.lr * delta, m32.to(mdt), v32.to(mdt)

        flat = [upd(*leaves) for leaves in zip(*(tree_leaves(t) for t in (
            params, grads, state["m"], state["v"])))]
        new_params, m, v = (tree_unflatten(params, [o[i] for o in flat]) for i in range(3))
        return new_params, {"m": m, "v": v, "step": step}

    return init, update


def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _make_adafactor(cfg: OptConfig):
    def init(params):
        def z(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return {"v": tree_map(z, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        decay = 1.0 - step.to(torch.float32) ** -0.8

        def upd(p, g, v):
            gf = g.float()
            g2 = gf * gf + cfg.factored_eps
            if _factored(p):
                vr = decay * v["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * v["vc"] + (1 - decay) * g2.mean(dim=-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None], min=1e-30))
                pre = gf * torch.rsqrt(denom + cfg.factored_eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv_ = decay * v["v"] + (1 - decay) * g2
                pre = gf * torch.rsqrt(nv_ + cfg.factored_eps)
                nv = {"v": nv_}
            # update clipping (RMS <= 1) per Adafactor
            rms = torch.sqrt(torch.mean(pre * pre) + 1e-30)
            pre = pre / torch.clamp(rms, min=1.0)
            return p - cfg.lr * (pre + cfg.weight_decay * p), nv

        outs = [upd(p, g, v) for p, g, v in zip(
            tree_leaves(params), tree_leaves(grads), flatten_up_to(params, state["v"]))]
        new_params = tree_unflatten(params, [o[0] for o in outs])
        new_v = tree_unflatten(params, [o[1] for o in outs])
        return new_params, {"v": new_v, "step": step}

    return init, update


def for_arch(arch_cfg, lr: float = 1e-3) -> OptConfig:
    name = getattr(arch_cfg, "optimizer", "adamw")
    # bf16 moments for multi-billion-param models (memory budget)
    big = getattr(arch_cfg, "param_count", lambda: 0)() > 8e9
    return OptConfig(name=name, lr=lr, moment_dtype="bfloat16" if big else "float32")
