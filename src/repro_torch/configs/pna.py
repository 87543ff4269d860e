"""PNA [arXiv:2004.05718] — 4 layers, d=75, mean/max/min/std x id/amp/atten."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    name="pna", kind="pna", n_layers=4, d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
))
