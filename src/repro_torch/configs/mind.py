"""MIND [arXiv:1904.08030] — multi-interest retrieval, capsule routing."""
from repro_torch.configs.base import RecsysConfig, register

CONFIG = register(RecsysConfig(
    name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
))
