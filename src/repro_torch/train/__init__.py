"""Training: parameter trees (``tree``), optimizers (``optimizer``),
checkpoints (``checkpoint``), the fault-tolerant restart loop (``ft``), the
training loop (``trainer``) and int8 gradient compression with error
feedback (``compression``)."""
