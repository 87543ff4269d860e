"""Graphs: CSR, synthetic generators, scaled datasets, LLC traces, the
fanout neighbour sampler."""
