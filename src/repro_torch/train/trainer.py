"""The training loop: the step (loss and gradients by torch.autograd, the
optimizer's update, the gradient norm), gradient accumulation over
microbatches, metrics, and the checkpointed fault-tolerant loop.

``Trainer`` takes any ``loss_fn(params, batch)`` and ``init_params()`` over
trees of tensors (``train.tree``), as the JAX package's does. It runs on
``device`` ("cuda" unless the caller asks for the CPU); batches are moved
there with ``torch.as_tensor``. The JAX package's ``donate`` option and
its mesh and shardings have no counterpart here: updates are out of place,
and sharded training waits for the dist slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import devices
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
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, got)]
    return loss.detach(), tree_unflatten(params, grads)


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


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,          # (params, batch) -> scalar loss
        init_params: Callable[[], Any],
        opt_cfg: opt_mod.OptConfig,
        tcfg: TrainerConfig,
        device: str | torch.device = devices.DEFAULT_DEVICE,
    ):
        self.device = devices.resolve(device)
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
        leading axis, the gradients summed in float32 and averaged, and the
        loss is the microbatches' mean."""
        mb = self.tcfg.microbatches
        if mb > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses = []
            for i in range(mb):
                part = tree_map(lambda x: x.reshape((mb, -1) + tuple(x.shape[1:]))[i], batch)
                loss, g = value_and_grad(self.loss_fn, params, part)
                acc = tree_map(torch.add, acc, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / mb, acc)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(self.loss_fn, params, batch)
        new_params, new_opt = self.opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "gnorm": opt_mod.global_norm(grads)}

    def init_state(self) -> Dict:
        params = tree_map(lambda t: t.to(self.device), self.init_params())
        return {"params": params, "opt": self.opt_init(params)}

    def to_device(self, batch) -> Any:
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
