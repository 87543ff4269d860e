"""Phi-3.5-MoE-instruct (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import LMConfig, MoECfg, register

CONFIG = register(LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8,
    d_ff=6400, vocab=32064,
    act="silu", gated=True,
    moe=MoECfg(n_experts=16, top_k=2),
    norm="layernorm",
    grasp_vocab=True,
))
