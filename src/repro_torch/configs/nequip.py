"""NequIP [arXiv:2101.03164] — O(3)-equivariant interatomic potential.

5 layers, d=32, l_max=2, 8 Bessel RBFs, 5A cutoff. Implemented as
NequIP-lite (restricted tensor-product path set — DESIGN.md)."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    name="nequip", kind="nequip", n_layers=5, d_hidden=32,
    l_max=2, n_rbf=8, cutoff=5.0,
))
