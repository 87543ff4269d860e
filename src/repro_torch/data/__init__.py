"""Synthetic, seeded input data (``pipeline``)."""
