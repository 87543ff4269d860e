"""PNA's dense layers' share of the float32 peak, in percent: the FLOPs of
a trial's matrix products at the H100's float32 peak (outside the tensor
cores: the port keeps TF32 off) over the GEMM kernels' device time a
trial.

Each layer l, of input width d_l (``d_feat``, then ``d_hidden`` = d), runs
``pre`` on every edge's [h_dst, h_src] (2·d_l → d), then on every vertex
the two layers of ``post`` ((12d + d_l) → d → d, 12 = aggregators ×
scalers); the head maps d → ``d_out`` on every vertex:

    sum over layers of (2E·2d_l·d + 2N·(12d + d_l)·d + 2N·d·d) + 2N·d·d_out.

The model's sizes are read from the ``pna`` mix.
"""
from gbench import spec
from gbench.peaks import FP32_FLOPS

# cuBLAS's float32 kernels (sgemm, xmma/cutlass gemm) and split-K's reduction
KERNELS = r"(?i)gemm|splitKreduce"


def trial_flops(model: dict, num_nodes: int, num_edges: int) -> int:
    d = model["d_hidden"]
    n_agg = len(model["aggregators"]) * len(model["scalers"])
    widths = [model["d_feat"]] + [d] * (model["n_layers"] - 1)
    layers = sum(2 * num_edges * 2 * dl * d + 2 * num_nodes * (n_agg * d + dl) * d
                 + 2 * num_nodes * d * d for dl in widths)
    return layers + 2 * num_nodes * d * model["d_out"]


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    flops = trial_flops(spec.traffic("pna"), r.num_nodes, r.num_edges) * len(r.iters)
    return 100.0 * flops / FP32_FLOPS / sum(op.dur for op in ops)
