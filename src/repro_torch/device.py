"""Device rule of the port.

Every entry point takes ``device=None``, which means the CUDA card.
Without a card that default raises and names ``device="cpu"``: the port
never falls back to the CPU on its own.  The CPU is always an explicit
choice of the caller (the tests make it).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising without a card); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
