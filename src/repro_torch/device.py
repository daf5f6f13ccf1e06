"""Where the port's public entry points put their tensors."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_generator"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no quiet CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; "
                           "pass device='cpu' to run its plain versions")
    return device


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Raise unless ``gen`` draws on ``device``'s type (torch cannot draw
    CUDA tensors from a CPU generator, nor the reverse)."""
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device} cannot draw parameters "
                         f"on {device}: pass a generator on that device")
