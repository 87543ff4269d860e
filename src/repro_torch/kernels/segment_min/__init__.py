"""Segment minimum of float32 messages: SSSP's relaxation on the card."""
