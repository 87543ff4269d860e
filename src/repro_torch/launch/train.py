"""End-to-end LM training from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --smoke \
        --steps 50 --ckpt /tmp/ckpt

``--smoke`` swaps in the reduced config; without it the full config is
used (at full depth no LM's parameters, gradients and moments fit one
card). It trains on ``--device``, the card unless ``--device cpu`` is
given, and raises where there is none. Parameters are drawn from seed 0 on
that device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import devices
from repro_torch.configs import base as cfgs
from repro_torch.data import pipeline
from repro_torch.nn import transformer as tfm
from repro_torch.train import ft as ft_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--device", default="cuda", help="device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    dev = devices.resolve(args.device)
    cfg = cfgs.get_arch(args.arch)
    if cfg.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for others")
    if args.smoke:
        cfg = cfgs.reduced(cfg)
    shape = cfgs.LMShape("cli", "train", args.seq, args.batch)

    def loss(params, batch):
        return tfm.loss_fn(params, cfg, batch)

    def init_params():
        return tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    trainer = Trainer(
        loss_fn=loss,
        init_params=init_params,
        opt_cfg=opt_mod.OptConfig(name="adamw", lr=args.lr),
        tcfg=TrainerConfig(
            num_steps=args.steps,
            ckpt_dir=args.ckpt,
            ckpt_every=max(args.steps // 5, 1),
            log_every=max(args.steps // 20, 1),
        ),
        device=dev,
    )
    batch_fn = pipeline.make_batch_fn("lm", cfg, shape, seed=0)
    injector = ft_mod.FailureInjector(fail_at=tuple(args.fail_at))
    state = trainer.fit(batch_fn, injector=injector if args.fail_at else None)
    losses = [h["loss"] for h in trainer.history]
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    if trainer.watchdog.events:
        print(f"[train] straggler events: {trainer.watchdog.events}")
    return state


if __name__ == "__main__":
    main()
