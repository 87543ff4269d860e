"""DeeperGCN's softmax aggregation over a destination-sorted CSR on the
card: GENConv's per-channel softmax over each row's in-edges and self loop,
and its weighted sum, in one pass."""
