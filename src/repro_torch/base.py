"""What every part of the port shares: the device rule."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a concrete torch device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card by "
                "default; pass device='cpu' to run the plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    return dev
