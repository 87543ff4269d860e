"""Nemotron-4-340B [arXiv:2402.16819] — squared-ReLU, GQA kv=8.

Optimizer defaults to adafactor: Adam fp32 moments for 340B params do not
fit 16GB/chip HBM on a 256-chip pod (see DESIGN.md memory budget)."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="nemotron-4-340b",
    n_layers=96, d_model=18432, n_heads=96, n_kv=8,
    d_ff=73728, vocab=256000,
    act="relu2", gated=False,
    optimizer="adafactor",
    microbatches=16,    # best measured config (EXPERIMENTS §Perf journey)
    seq_shard=True,     # activation stash sharded over model
    grasp_vocab=True,
))
