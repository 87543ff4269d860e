"""GIN [arXiv:1810.00826] — 5 layers, d=64, sum aggregator, learnable eps."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64, eps_learnable=True,
))
