"""StarCoder2-7B [arXiv:2402.19173] — GQA kv=4, RoPE, GELU FFN."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4,
    d_ff=18432, vocab=49152,
    act="gelu", gated=False,
    norm="layernorm",
    grasp_vocab=True,
))
