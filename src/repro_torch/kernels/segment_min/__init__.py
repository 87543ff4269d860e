"""Segment minimum of float32 messages, and SSSP's relaxation over an
out-CSR, on the card."""
