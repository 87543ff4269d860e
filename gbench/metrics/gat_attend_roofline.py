"""The GAT attention kernel's share of its roofline, in percent: the least
time its bytes take at the HBM peak over its device time, a trial.

Layer l of a trial reads, through ``gat_attend`` (a partition, the
attention and a merge kernel), the CSR's N + 1 offsets and E ids, each
vertex's H source and H destination scores, and the layer's rows of z,
w_l floats each, and writes each vertex's output, o_l floats. Each row is
counted once, not once per in-edge, so L2 reuse cannot push the share past
100%:

    sum over layers of (4(N + 1) + 4E + 8HN + 4·w_l·N + 4·o_l·N)

with w = H·C_l (512, 512, 188) and o = the output width (512, 512, 47).
The time is the traced ``gat_attend`` kernels' total over the trials
traced. The model's sizes are read from the ``gat`` mix.
"""
from gbench import spec
from gbench.peaks import HBM_BYTES_PER_S

KERNELS = r"gat_attend_"


def least_bytes(model: dict, num_nodes: int, num_edges: int) -> int:
    h, n, total = model["heads"], num_nodes, 0
    for i in range(model["n_layers"]):
        last = i == model["n_layers"] - 1
        c = model["d_out"] if last else model["d_head"]
        w, o = h * c, c if last else h * c
        total += 4 * (n + 1) + 4 * num_edges + 8 * h * n + 4 * w * n + 4 * o * n
    return total


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    least_s = least_bytes(spec.traffic("gat"), r.num_nodes, r.num_edges) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(op.dur for op in ops) / len(r.iters))
