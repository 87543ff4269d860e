"""Device milliseconds an iteration in the engine's reductions
(``apps/engine.py``: ``sum_reduce`` is ``index_add_``, ``min_reduce``
``scatter_reduce_`` amin), over every traced trial: their kernels' time
over the iterations the apps counted (``stats["iters"]``). PageRank-Delta's
one-off out-degree sum is an ``index_add_`` too and is counted."""

# index_add_: indexFuncSmallIndex / indexFuncLargeIndex; scatter_reduce_:
# _scatter_gather_elementwise_kernel (names of torch 2.11's CUDA kernels)
KERNELS = r"indexFunc(Small|Large)Index|_scatter_gather_elementwise_kernel"


def read(r):
    ops = r.trace.matching(KERNELS)
    if not ops or not sum(r.iters):
        return None
    return 1e3 * sum(op.dur for op in ops) / sum(r.iters)
