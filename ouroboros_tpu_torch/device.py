"""Device choice for the port's entry points.

The port runs on the CUDA card by default.  There is no silent fallback:
without a card, `default_device()` raises, and only an explicit
`device="cpu"` runs the plain PyTorch versions on the host.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions on the host")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for, but none is present")
    return dev


def device_kind(device=None) -> str:
    """Name of the device the port runs on (the card's marketing name)."""
    dev = resolve(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def stage(arrays, device: torch.device) -> list:
    """Host numpy arrays -> tensors on `device`, in order."""
    return [torch.from_numpy(a).to(device) for a in arrays]
