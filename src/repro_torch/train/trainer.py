"""The training loop: the step (loss and gradients by torch.autograd, the
optimizer's update, the gradient norm), gradient accumulation over
microbatches, metrics, and the checkpointed fault-tolerant loop.

``Trainer`` takes any ``loss_fn(params, batch)`` and ``init_params()`` over
trees of tensors (``train.tree``), as the JAX package's does. It runs on
``device`` ("cuda" unless the caller asks for the CPU); batches are moved
there with ``torch.as_tensor``. ``TrainerConfig.donate`` (on by default,
as in the JAX package) makes each step consume the parameters and
optimizer state it is given and update them in place (``optimizer``'s
donated update); ``init_state`` then copies what ``init_params()``
returns, so the caller's tensors are never written.

With ``mesh=`` and ``in_shardings=(params, opt_state, batch)`` (trees of
``dist.sharding.NamedSharding``, as a cell gives them; ``out_shardings``
likewise for ``(params, opt_state, metrics)``) the state lives as
DTensors: ``init_state`` distributes the parameters and the optimizer's
state by ``in_shardings``, batches are distributed by the batch's
placements, the step runs with the mesh active, each gradient is moved to
its parameter's placements (a product over a sharded dimension leaves it
``Partial``) before the update, and results are redistributed to
``out_shardings``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import devices
from repro_torch.dist import sharding as shd
from repro_torch.train import ft as ft_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn: Callable, params: Any, *args):
    """``jax.value_and_grad(loss_fn)(params, *args)`` by torch.autograd: the
    loss (detached) and the tree of gradients of ``params``, zeros where
    the loss does not reach a leaf, as JAX gives them. The caller's
    tensors are left as they are (the loss sees detached aliases)."""
    flat = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(tree_unflatten(params, live), *args)
        got = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p) for p, g in zip(live, got)]
    return loss.detach(), tree_unflatten(params, grads)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements: a DTensor gradient that
    arrives ``Partial`` (or otherwise placed) is reduce-scattered or
    redistributed; a plain one is returned as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def grad_sum(loss_fn: Callable, params: Any, parts: list):
    """Each part's loss and the float32 sum of the parts' gradients of
    ``params``: the JAX package's accumulation (float32 zeros, then each
    part's gradient added in part order), done leaf by leaf as the backward
    produces each leaf's gradient, so no second whole gradient tree is
    alive. Returns (losses, sums); the caller's tensors are left as they
    are."""
    flat = tree_leaves(params)
    sums = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
            for p in flat]
    losses = []
    for part in parts:
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in flat]
            for acc, p in zip(sums, live):
                p.register_post_accumulate_grad_hook(functools.partial(_add_grad, acc))
            loss = loss_fn(tree_unflatten(params, live), part)
            loss.backward(inputs=live)
        losses.append(loss.detach())
    return losses, tree_unflatten(params, sums)


def _add_grad(acc: torch.Tensor, p: torch.Tensor) -> None:
    acc.add_(_like(p.grad, acc))
    p.grad = None


def split(batch: Any, mb: int, batch_axes: tuple = ()) -> list:
    """Every batch leaf split along its leading axis into ``mb`` parts. The
    ``(mb, B / mb, ...)`` view is constrained to ``batch_axes`` on its
    second dimension (``dist.sharding.constrain``: identity off a mesh), so
    each part stays sharded as the batch was."""
    def view(x):
        x = shd.unflatten(x, 0, (mb, x.shape[0] // mb))
        return shd.constrain(x, None, batch_axes, *(None,) * (x.dim() - 2))
    parts = tree_map(view, batch)
    return [tree_map(lambda x: x[i], parts) for i in range(mb)]


def batch_to(batch: Any, device: torch.device) -> Any:
    """The batch (a tree of arrays or tensors) as tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), batch)


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    microbatches: int = 1          # gradient accumulation
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    donate: bool = True


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,          # (params, batch) -> scalar loss
        init_params: Callable[[], Any],
        opt_cfg: opt_mod.OptConfig,
        tcfg: TrainerConfig,
        device: str | torch.device = devices.DEFAULT_DEVICE,
        mesh=None,
        in_shardings=None,
        out_shardings=None,
    ):
        if (mesh is None) != (in_shardings is None):
            raise ValueError("mesh and in_shardings go together")
        self.device = devices.resolve(device)
        self.mesh = mesh
        self.in_shardings = in_shardings
        self.out_shardings = out_shardings
        self.loss_fn = loss_fn
        self.init_params = init_params
        self.opt_init, self.opt_update = opt_mod.make(opt_cfg)
        self.tcfg = tcfg
        self.watchdog = ft_mod.StragglerWatchdog()
        self.history: list = []
        self.restarts = 0           # of the last checkpointed fit

    def step(self, params, opt_state, batch):
        """One step: (new params, new optimizer state, {"loss", "gnorm"}).
        With ``microbatches`` > 1 every batch leaf is split along its
        leading axis, the gradients summed in float32 (``grad_sum``) and
        averaged, and the loss is the microbatches' mean. With ``donate``
        the step consumes ``params`` and ``opt_state``."""
        if self.mesh is None:
            return self._step(params, opt_state, batch)
        with shd.on_mesh(self.mesh):
            out = self._step(params, opt_state, batch)
        return out if self.out_shardings is None else shd.redistribute(out, self.out_shardings)

    def _step(self, params, opt_state, batch):
        mb = self.tcfg.microbatches
        if mb > 1:
            axes = () if self.mesh is None else shd.batch_axes(self.mesh)
            losses, grads = grad_sum(self.loss_fn, params, split(batch, mb, axes))
            grads = tree_map(lambda g: g.div_(mb), grads)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(self.loss_fn, params, batch)
        new_params, new_opt = self.opt_update(grads, opt_state, params, donate=self.tcfg.donate)
        return new_params, new_opt, {"loss": loss, "gnorm": opt_mod.global_norm(grads)}

    def init_state(self) -> Dict:
        """Parameters on the device and the optimizer's state; with
        ``donate`` the parameters are copies, since the steps write them."""
        copy = self.tcfg.donate
        params = tree_map(lambda t: t.to(self.device, copy=copy), self.init_params())
        if self.mesh is None:
            return {"params": params, "opt": self.opt_init(params)}
        params = shd.place(params, self.in_shardings[0])
        return {"params": params, "opt": shd.place(self.opt_init(params), self.in_shardings[1])}

    def to_device(self, batch) -> Any:
        if self.mesh is not None:
            return shd.place(batch_to(batch, self.device), self.in_shardings[2])
        return batch_to(batch, self.device)

    def fit(self, batch_fn: Callable[[int], Dict],
            injector: Optional[ft_mod.FailureInjector] = None) -> Dict:
        """Run with the fault-tolerant restart loop when ckpt_dir is set.

        ``batch_fn(step) -> batch`` must be deterministic in ``step`` (the
        pipeline seeds per step) so restarts replay identical data."""
        tcfg = self.tcfg

        def step_fn(state, step):
            b = self.to_device(batch_fn(step))
            params, opt, metrics = self.step(state["params"], state["opt"], b)
            if (step + 1) % tcfg.log_every == 0 or step == 0:
                # keys sorted, as the JAX package's jitted step returns them
                m = {k: float(metrics[k]) for k in sorted(metrics)}
                self.history.append({"step": step + 1, **m})
                print(f"[train] step {step+1:5d} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            return {"params": params, "opt": opt}

        if tcfg.ckpt_dir:
            res = ft_mod.run_with_restarts(
                self.init_state, step_fn, tcfg.num_steps, tcfg.ckpt_dir,
                ckpt_every=tcfg.ckpt_every, injector=injector, watchdog=self.watchdog,
            )
            self.restarts = res.restarts
            return res.state
        state = self.init_state()
        for s in range(tcfg.num_steps):
            state = step_fn(state, s)
        return state
