"""Device resolution for the PyTorch/CUDA port.

Every entry point of the port takes an explicit ``device``. The default is
the CUDA card; when no card is present the entry point raises instead of
running on the CPU behind the caller's back. The CPU is used only when the
caller asks for it by name (the CPU tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "NoCudaDeviceError", "resolve_device"]

DEFAULT_DEVICE = "cuda"


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was requested (explicitly or by default) but
    ``torch.cuda.is_available()`` is False."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"``. Raises
    ``NoCudaDeviceError`` for a CUDA device when no card is present and
    ``ValueError`` for any type other than ``cuda`` and ``cpu``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False — pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev
