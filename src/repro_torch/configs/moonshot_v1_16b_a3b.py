"""Moonlight-16B-A3B (Kimi/Moonshot) [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import LMConfig, MoECfg, register

CONFIG = register(LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16,
    d_ff=1408, vocab=163840,
    act="silu", gated=True,
    moe=MoECfg(n_experts=64, top_k=6),
    grasp_vocab=True,
))
