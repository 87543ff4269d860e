"""GAT's matrix products' share of the float32 peak, in percent: the FLOPs
of a trial's products at the H100's float32 peak (outside the tensor
cores: the port keeps TF32 off) over the GEMM kernels' device time a
trial.

Layer l, of input width d_l (``d_feat``, then H·C), maps every vertex to
its rows z (H·C_l wide) and its skip (the layer's output width s_l):

    sum over layers of 2N·d_l·(H·C_l + s_l)

The scores' columns, which the port folds into the same product, are not
counted. The model's sizes are read from the ``gat`` mix.
"""
from gbench import spec
from gbench.peaks import FP32_FLOPS

# cuBLAS's float32 kernels (sgemm, xmma/cutlass gemm) and split-K's reduction
KERNELS = r"(?i)gemm|splitKreduce"


def trial_flops(model: dict, num_nodes: int) -> int:
    h, d_in, total = model["heads"], model["d_feat"], 0
    for i in range(model["n_layers"]):
        last = i == model["n_layers"] - 1
        c = model["d_out"] if last else model["d_head"]
        out = c if last else h * c
        total += 2 * num_nodes * d_in * (h * c + out)
        d_in = out
    return total


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    flops = trial_flops(spec.traffic("gat"), r.num_nodes) * len(r.iters)
    return 100.0 * flops / FP32_FLOPS / sum(op.dur for op in ops)
