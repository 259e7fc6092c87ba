"""Where an entry point runs."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The caller's device, or the card when none is given. Without a
    card and without an explicit device this raises: nothing falls back
    to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")
