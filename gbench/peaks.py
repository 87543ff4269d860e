"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, at
its 700 W limit). Copied from ``repro_torch/launch/roofline.py`` and
``chip_smoke.py`` so that a change to the program cannot move them."""

HBM_BYTES_PER_S = 3.35e12  # HBM3
FP32_FLOPS = 67e12         # float32 outside the tensor cores
