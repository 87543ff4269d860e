"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card is
    present. There is no silent move to the CPU: callers ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
