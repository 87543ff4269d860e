"""Distributed subsystem: the GRASP-partitioned GIN train step over
``torch.distributed`` (``dist.collectives``): the hot prefix replicated on
every rank, cold rows owned by their destination's rank, and a bounded
halo exchange of the cold remote sources (paper Table I lifted to the
partition tier).

The caller owns the process group (``torch.distributed.init_process_group``
with its own address, world size and rank: NCCL on cards, gloo on the
CPU); nothing here starts one.
"""
