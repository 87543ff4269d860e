"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679]."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8,
    d_ff=16384, vocab=256000,
    act="relu2", gated=False,   # nemotron family: squared-ReLU, no GLU
    grasp_vocab=True,
))
