"""Distributed subsystem: the sharding vocabulary and the GRASP-aware
collectives.

``dist.sharding`` is the JAX package's ``PartitionSpec`` vocabulary as
DTensor placements on a ``torch.distributed`` device mesh (``ns``,
``constrain``, the LM, GNN and recsys specs, and the local rules DTensor
lacks), used by the launch layer's cells, ``Trainer(mesh=)`` and
``checkpoint.restore(shardings=)``. ``dist.collectives`` is the
GRASP-partitioned GIN train step: the hot prefix replicated on every rank,
cold rows owned by their destination's rank, and a bounded halo exchange
of the cold remote sources (paper Table I lifted to the partition tier).

The caller owns the process group (``torch.distributed.init_process_group``
with its own address, world size and rank: NCCL on cards, gloo on the
CPU, the ``fake`` backend for the dry-run); nothing here starts one.
"""
