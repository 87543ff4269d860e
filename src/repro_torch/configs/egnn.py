"""EGNN [arXiv:2102.09844] — E(n)-equivariant, 4 layers, d=64."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(name="egnn", kind="egnn", n_layers=4, d_hidden=64))
