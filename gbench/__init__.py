"""The benchmark of ``repro_torch`` on graph analytics (see README.md)."""
