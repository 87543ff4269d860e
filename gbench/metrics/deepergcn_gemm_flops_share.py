"""DeeperGCN's matrix products' share of the float32 peak, in percent: the
FLOPs of a trial's products at the H100's float32 peak (outside the tensor
cores: the port keeps TF32 off) over the GEMM kernels' device time a trial.

The encoder maps every vertex's d_feat features to d, each of the n_layers
layers its d-wide row to d, and the head d to d_out:

    2N·(d_feat·d + n_layers·d·d + d·d_out)

(1.041e12 a trial at kron21: 100, 128, 14 layers, 47). The model's sizes
are read from the ``deepergcn`` mix.
"""
from gbench import spec
from gbench.peaks import FP32_FLOPS

# cuBLAS's float32 kernels (sgemm, xmma/cutlass gemm) and split-K's reduction
KERNELS = r"(?i)gemm|splitKreduce"


def trial_flops(model: dict, num_nodes: int) -> int:
    d = model["d_hidden"]
    return 2 * num_nodes * (model["d_feat"] * d + model["n_layers"] * d * d + d * model["d_out"])


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not r.iters:
        return None
    flops = trial_flops(spec.traffic("deepergcn"), r.num_nodes) * len(r.iters)
    return 100.0 * flops / FP32_FLOPS / sum(op.dur for op in ops)
