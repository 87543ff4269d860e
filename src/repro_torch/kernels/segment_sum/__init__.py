"""Segment sum of float32 messages over CSR rows: the pull sum of
PageRank-Delta and PageRank on the card."""
