"""K1's share of its roofline, in percent: the least time its bytes take at
the HBM peak over its measured device time, a launch.

K1 (``csrc/hot_gather.cu``) gathers one float32 a row (d = 1) for each of
the E edges. The least bytes a launch moves: 4E of int32 indices read, 4E
of float32 output written, and 4 bytes of each distinct row the indices
reference, read once (counted at set-up; chip_smoke's ``op_bound_ms``
counts the same). The time is the traced kernels' total over their count.
"""
from gbench.peaks import HBM_BYTES_PER_S

KERNELS = r"gather_col_kernel|gather_rows_kernel|gather_scalar_kernel"


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops:
        return None
    e = r.num_edges
    least_s = (4 * e + 4 * e + 4 * r.distinct_rows) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(op.dur for op in ops) / len(ops))
