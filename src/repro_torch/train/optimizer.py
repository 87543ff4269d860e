"""Optimizers: SGD (+momentum), AdamW (optional bf16 moments), Adafactor.

The JAX package's own optimizers, with its API and state layout:
``make(cfg) -> (init, update)`` with

  init(params) -> state
  update(grads, state, params) -> (new_params, new_state)

over trees of tensors (``train.tree``; ``None`` leaves stay ``None`` in the
state and are skipped). SGD's state is ``{"mu", "step"}``, AdamW's
``{"m", "v", "step"}``, Adafactor's ``{"v", "step"}`` with ``{"vr", "vc"}``
(factored matrices) or ``{"v"}`` a parameter; ``step`` is an int32 scalar
tensor on the parameters' device. Every update runs under
``torch.no_grad()``.

``update(..., donate=False)`` is out of place: the caller's tensors are
never changed. ``update(..., donate=True)`` is the JAX package's donated
step (``donate_argnums``): it consumes ``params`` and ``state``, writing
each leaf's new value into the leaf's own tensor, and returns those
tensors. Both compute every leaf with the same expression; the donated
update applies it to one leaf at a time (SGD's and AdamW's elementwise
expressions a slice of at most ``SLICE`` elements at a time) and
``copy_``s the result in, so its temporaries are a slice's or a leaf's,
not a whole tree's, and its values are the out-of-place update's bit for
bit. The clipped gradient is computed per leaf inside the expression
(``clipped``) rather than as a second tree.

On DTensor leaves (a cell's or ``Trainer``'s state on a mesh) the update
keeps each leaf's placements: an elementwise update (SGD's, AdamW's) runs
the same expression on every device's local block (``to_local()``, the
gradient and moments already in the parameter's placements), so the
donated update slices and writes local rows; Adafactor's factored
statistics and RMS clip span the whole leaf, so its update runs on the
DTensors themselves. The global norm reduces each leaf's partial sum of
squares over the mesh (``full_tensor``) before adding the leaves.

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
from torch.distributed.tensor import DTensor

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


SLICE = 1 << 26  # elements of a donated elementwise update at a time (256 MiB of float32)


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in flatten order."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(_plain(torch.sum(g.float() ** 2)) for g in leaves))


def _plain(x):
    """A DTensor's whole value as a plain tensor (partial sums reduced over
    the mesh); other values as they are."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def clip_scale(grads: Any, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / norm), norm) of the gradients' global norm."""
    gnorm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0), gnorm


def clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf scaled by ``clip_scale``'s factor, in its dtype promoted
    with float32, as the JAX package's product with a float32 scalar
    gives it."""
    return g.to(torch.promote_types(g.dtype, torch.float32)) * scale


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    scale, gnorm = clip_scale(grads, max_norm)
    return tree_map(lambda g: clipped(g, scale), grads), gnorm


def _first_device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_first_device(params))


def _apply(upd, outs: tuple, ins: tuple, donate: bool, elementwise: bool = True):
    """``upd(*ins)`` for one leaf: returned, or with ``donate`` copied into
    the tensors ``outs`` (and ``outs`` returned). An ``elementwise`` update
    is computed over slices of the leading axis of at most ``SLICE``
    elements, which gives each element the same arithmetic. On DTensors an
    elementwise update runs on the local blocks, any other on the
    DTensors, its results moved to the placements of ``outs``."""
    lead = outs[0]
    if isinstance(lead, DTensor):
        mesh, pl = lead.device_mesh, tuple(lead.placements)
        # the gradient (and moments) in the parameter's placements;
        # Adafactor's row/column statistics keep their own
        ins = tuple(x.redistribute(mesh, pl) if x.shape == lead.shape
                    and tuple(x.placements) != pl else x for x in ins)
        if not elementwise:
            new = [n.redistribute(o.device_mesh, o.placements)
                   if tuple(n.placements) != tuple(o.placements) else n
                   for n, o in zip(upd(*ins), outs)]
            if not donate:
                return tuple(new)
            for dst, n in zip(outs, new):
                dst.copy_(n)
            return outs
        got = _apply(upd, tuple(o.to_local() for o in outs), tuple(x.to_local() for x in ins),
                     donate, elementwise)
        if donate:
            return outs
        return tuple(DTensor.from_local(g, o.device_mesh, o.placements, run_check=False,
                                        shape=o.shape, stride=o.stride())
                     for g, o in zip(got, outs))
    if not donate:
        return upd(*ins)
    rows = lead.shape[0] if lead.dim() else 1
    per = max(1, SLICE // max(lead[0].numel(), 1)) if lead.dim() and elementwise else rows
    for r in range(0, rows, per):
        part = [t[r:r + per] for t in ins] if per < rows else ins
        for dst, new in zip(outs, upd(*part)):
            (dst[r:r + per] if per < rows else dst).copy_(new)
    return outs


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
    def update(grads, state, params, donate: bool = False):
        scale, _ = clip_scale(grads, cfg.grad_clip)

        def upd(p, g, m):
            mu = cfg.momentum * m + clipped(g, scale)
            return p - cfg.lr * mu, mu

        outs = [_apply(upd, (p, m), (p, g, m), donate) for p, g, m in zip(
            *(tree_leaves(t) for t in (params, grads, state["mu"])))]
        new_params, mu = (tree_unflatten(params, [o[i] for o in outs]) for i in range(2))
        return new_params, {"mu": mu, "step": state["step"] + 1}

    return init, update


def _make_adamw(cfg: OptConfig):
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=mdt, memory_format=torch.contiguous_format)

        return {"m": tree_map(z, params), "v": tree_map(z, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, donate: bool = False):
        scale, _ = clip_scale(grads, cfg.grad_clip)
        step = state["step"] + 1
        bc1 = 1.0 - cfg.b1 ** _plain(step).to(torch.float32)
        bc2 = 1.0 - cfg.b2 ** _plain(step).to(torch.float32)

        def upd(p, g, m, v):
            gf = clipped(g, scale).float()
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
            return p - cfg.lr * delta, m32.to(mdt), v32.to(mdt)

        outs = [_apply(upd, (p, m, v), (p, g, m, v), donate) for p, g, m, v in zip(
            *(tree_leaves(t) for t in (params, grads, state["m"], state["v"])))]
        new_params, m, v = (tree_unflatten(params, [o[i] for o in outs]) for i in range(3))
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
    def update(grads, state, params, donate: bool = False):
        scale, _ = clip_scale(grads, cfg.grad_clip)
        step = state["step"] + 1
        decay = 1.0 - _plain(step).to(torch.float32) ** -0.8

        def upd(p, g, *v):
            gf = clipped(g, scale).float()
            g2 = gf * gf + cfg.factored_eps
            if _factored(p):
                vr = decay * v[0] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * v[1] + (1 - decay) * g2.mean(dim=-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None], min=1e-30))
                pre = gf * torch.rsqrt(denom + cfg.factored_eps)
                nv = (vr, vc)
            else:
                nv = (decay * v[0] + (1 - decay) * g2,)
                pre = gf * torch.rsqrt(nv[0] + cfg.factored_eps)
            # update clipping (RMS <= 1) per Adafactor
            rms = torch.sqrt(torch.mean(pre * pre) + 1e-30)
            pre = pre / torch.clamp(rms, min=1.0)
            return (p - cfg.lr * (pre + cfg.weight_decay * p),) + nv

        outs = []
        for p, g, v in zip(tree_leaves(params), tree_leaves(grads),
                           flatten_up_to(params, state["v"])):
            keys = ("vr", "vc") if _factored(p) else ("v",)
            vs = tuple(v[k] for k in keys)
            # the factored statistics and the RMS clip span the whole leaf
            o = _apply(upd, (p,) + vs, (p, g) + vs, donate, elementwise=False)
            outs.append((o[0], dict(zip(keys, o[1:]))))
        new_params = tree_unflatten(params, [o[0] for o in outs])
        new_v = tree_unflatten(params, [o[1] for o in outs])
        return new_params, {"v": new_v, "step": step}

    return init, update


def for_arch(arch_cfg, lr: float = 1e-3) -> OptConfig:
    name = getattr(arch_cfg, "optimizer", "adamw")
    # bf16 moments for multi-billion-param models (memory budget)
    big = getattr(arch_cfg, "param_count", lambda: 0)() > 8e9
    return OptConfig(name=name, lr=lr, moment_dtype="bfloat16" if big else "float32")
