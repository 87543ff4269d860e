"""Hand-written Hopper kernels: ``<name>/{<name>.py, ops.py, ref.py}`` with
their CUDA sources in ``csrc/<name>.cu`` (built by ``_build``)."""
