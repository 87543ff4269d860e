"""Hot-cached embedding bag: K3 (masked hot-row bag sum) and the lookup
through K1."""
