"""End-to-end LM training through ``repro_torch``: examples/train_lm.py's
small minitron-family model (5.0M parameters, named minitron-10m there)
for a few hundred steps with checkpointing and an injected failure (the
restart is automatic and bit-exact).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses
import tempfile

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
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="device to train on (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    # a small member of the minitron family (squared-ReLU, GQA)
    cfg = dataclasses.replace(
        cfgs.reduced(cfgs.get_arch("minitron-8b")),
        name="minitron-10m", n_layers=4, d_model=256, n_heads=8, n_kv=4,
        d_ff=1024, vocab=4096,
    )
    n_params = cfg.param_count()
    print(f"[example] training {cfg.name}: {n_params/1e6:.1f}M params on {dev}")

    shape = cfgs.LMShape("ex", "train", seq_len=128, global_batch=16)
    ckpt = tempfile.mkdtemp(prefix="repro_lm_ckpt_")

    trainer = Trainer(
        loss_fn=lambda p, b: tfm.loss_fn(p, cfg, b),
        init_params=lambda: tfm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                                     device=dev),
        opt_cfg=opt_mod.OptConfig(name="adamw", lr=3e-4),
        tcfg=TrainerConfig(num_steps=args.steps, ckpt_dir=ckpt,
                           ckpt_every=50, log_every=20),
        device=dev,
    )
    injector = ft_mod.FailureInjector(fail_at=(args.fail_at,))
    print(f"[example] failure injected at step {args.fail_at}; "
          f"checkpoints in {ckpt}")
    trainer.fit(pipeline.make_batch_fn("lm", cfg, shape, seed=0),
                injector=injector)
    losses = [h["loss"] for h in trainer.history]
    print(f"[example] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {args.steps} steps ({trainer.restarts} restart)")
    assert losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    main()
