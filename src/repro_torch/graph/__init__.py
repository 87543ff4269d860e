"""Graphs: CSR, synthetic generators, scaled datasets, LLC traces."""
