"""repro_torch — the GRASP reproduction on PyTorch and CUDA for NVIDIA Hopper.

The package mirrors ``repro`` module for module (``graph``, ``core``,
``kernels``, ``apps``). Host-side graph, trace and simulator code is numpy;
device code is PyTorch, and the hot per-edge gather runs through
hand-written CUDA kernels built for ``sm_90a`` (``csrc/``).

Entry points that put data on a device take an explicit ``device``
argument that defaults to ``"cuda"``; the CPU is used only when the caller
asks for it.
"""
