"""DeeperGCN's aggregation share of its roofline, in percent: the least time
its bytes take at the HBM peak over the aggregation kernels' device time, a
trial.

Each of a trial's layers reads the CSR's N + 1 offsets and E ids and the
layer's input rows, d floats each, and writes each vertex's output row, d
floats. Each row is counted once, not once per in-edge, so L2 reuse cannot
push the share past 100%, and the count is the same least work whatever
implements the layer:

    n_layers · (4(N + 1) + 4E + 4·d·N + 4·d·N)

(33.74 GB a trial at kron21, d = 128, 14 layers: 10.07 ms). The time is the
traced ``softmax_aggr_`` kernels' total over the trials traced. The model's
sizes are read from the ``deepergcn`` mix.
"""
from gbench import spec
from gbench.peaks import HBM_BYTES_PER_S

KERNELS = r"softmax_aggr_"


def least_bytes(model: dict, num_nodes: int, num_edges: int) -> int:
    n, d = num_nodes, model["d_hidden"]
    return model["n_layers"] * (4 * (n + 1) + 4 * num_edges + 4 * d * n + 4 * d * n)


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    least_s = least_bytes(spec.traffic("deepergcn"), r.num_nodes, r.num_edges) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(op.dur for op in ops) / len(r.iters))
