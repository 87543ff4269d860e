"""Device milliseconds a layer in PNA's aggregation: the kernels that
compute the four statistics of each block's messages (the sums of the
messages and of their squares by ``index_add_``, their maximum and minimum
by ``torch.segment_reduce`` over the block's CSR offsets, or by
``scatter_reduce``), over the layers the trials ran (``stats["iters"]``)."""

# index_add_: indexFuncSmallIndex / indexFuncLargeIndex; segment_reduce:
# segment_reduce_forward_kernel; scatter_reduce: the scatter-like
# instances of _scatter_gather_elementwise_kernel (names of torch 2.11's
# CUDA kernels; a gather-like instance of that kernel is index_select's)
KERNELS = (r"indexFunc(Small|Large)Index|segment_reduce"
           r"|_scatter_gather_internal_kernel<true")


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not sum(r.iters):
        return None
    return 1e3 * sum(op.dur for op in ops) / sum(r.iters)
