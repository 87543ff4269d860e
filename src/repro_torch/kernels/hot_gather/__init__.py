"""GRASP hot-region gather: K1 (gather) and K2 (fused gather + segment-sum)."""
