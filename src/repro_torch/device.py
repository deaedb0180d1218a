"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points default to device='cuda', but CUDA is "
            "not available; pass device='cpu' to run the plain PyTorch path")
    return dev
