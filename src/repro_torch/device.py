"""Where an entry point of the port runs.

Entry points default to the card and never continue on the CPU unless the
caller asks for it; :func:`resolve_device` is the one place that rule is
enforced.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; "cuda" without a card raises.

    Entry points default to the card and never continue on the CPU unless
    the caller asks for it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device
