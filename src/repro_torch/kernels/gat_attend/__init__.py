"""GAT's attention over a destination-sorted CSR on the card: the
per-head edge softmax and its weighted sum of neighbour rows in one pass."""
