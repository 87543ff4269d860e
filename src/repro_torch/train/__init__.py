"""Training: parameter trees (``tree``), optimizers (``optimizer``),
checkpoints (``checkpoint``), the fault-tolerant restart loop (``ft``) and
the training loop (``trainer``)."""
