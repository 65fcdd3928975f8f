"""Where the package's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means CUDA. A CUDA device without a usable card raises; nothing
    moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
