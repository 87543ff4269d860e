"""The segment-sum kernel's share of its roofline, in percent: the least
time its bytes take at the HBM peak over its measured device time, a launch.

The kernel (``csrc/segment_sum.cu``; every kernel of a launch is named
``segment_sum_...``) sums the E float32 messages of an iteration over the
in-CSR's N rows. The least bytes a launch moves: 4E of messages read, the
4(N + 1) int32 offsets read and 4N of sums written, each once. The time is
the traced kernels' total over the iterations the apps counted
(``stats["iters"]``): the pull launches it once an iteration. None where no
kernel of that name ran, as in a program without it.
"""
from gbench.peaks import HBM_BYTES_PER_S

KERNELS = r"segment_sum_"


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not sum(r.iters):
        return None
    least_s = (4 * r.num_edges + 4 * (r.num_nodes + 1) + 4 * r.num_nodes) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(op.dur for op in ops) / sum(r.iters))
