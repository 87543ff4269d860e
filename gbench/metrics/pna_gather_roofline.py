"""K1's share of its roofline on PNA's rows, in percent: the least time its
bytes take at the HBM peak over its device time, a trial.

Each layer l of a trial gathers, through K1, the source row of width d_l
(the layer's input: ``d_feat``, then ``d_hidden``) of every one of the E
edges. The least bytes of a layer's launches: 4E of int32 indices read,
4·d_l·E of float32 rows written, and 4·d_l bytes of each distinct row the
indices reference, read once (R rows: the vertices with edges, counted at
set-up). So a trial's least bytes are

    sum over layers of (4E + 4·d_l·E + 4·d_l·R).

The time is the traced K1 kernels' total over the trials traced. The
model's sizes are read from the ``pna`` mix.
"""
from gbench import spec
from gbench.peaks import HBM_BYTES_PER_S

KERNELS = r"gather_col_kernel|gather_rows_kernel|gather_scalar_kernel"


def least_bytes(model: dict, num_edges: int, distinct_rows: int) -> int:
    widths = [model["d_feat"]] + [model["d_hidden"]] * (model["n_layers"] - 1)
    return sum(4 * num_edges + 4 * d * num_edges + 4 * d * distinct_rows for d in widths)


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    least_s = least_bytes(spec.traffic("pna"), r.num_edges, r.distinct_rows) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(op.dur for op in ops) / len(r.iters))
