"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The requested device, refusing "cuda" when no card is present (the
    port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but torch finds "
                           "no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return device
