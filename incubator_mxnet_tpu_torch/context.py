"""Device rules of the PyTorch/CUDA port: ``resolve_device`` for the entry
points that take a ``device``, and the MXNet-style ``Context`` that the
``nd`` API places arrays by.

Every entry point takes an explicit device. The default is the CUDA card;
when no card is present the entry point raises instead of running on the
CPU behind the caller's back. The CPU is used only when the caller asks for
it by name (the CPU tests do): ``device="cpu"``, ``ctx=mx.cpu()`` or
``with mx.cpu():``.

``Context`` is the counterpart of ``incubator_mxnet_tpu/context.py``: a
with-scoped current device plus explicit placement. ``gpu(i)`` and
``tpu(i)`` both name CUDA card ``i`` (the reference keeps ``gpu`` as the
alias of its accelerator); unlike the reference, an accelerator context
never stands for the CPU when no accelerator is present. Under a world
of processes (``LOCAL_RANK`` set, as ``tools/launch.py`` and
``torch.distributed`` launchers set it), ``gpu(i)`` is this process's
``i``-th device (:func:`local_devices`), as the reference's contexts name
the process's local devices.
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "NoCudaDeviceError", "resolve_device",
           "Context", "cpu", "gpu", "tpu", "device", "current_context",
           "num_gpus", "num_tpus", "local_devices"]

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


_context_stack = threading.local()


class Context:
    """A device context: ``Context('gpu', 0)`` or ``Context('cpu')``.

    As a context manager it sets the device new arrays are made on, as
    ``with mx.Context(...)`` does in the reference. ``'gpu'`` and ``'tpu'``
    both name a CUDA card and compare equal; ``'cpu_pinned'`` and
    ``'cpu_shared'`` name the CPU."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2, "cpu_pinned": 3,
                   "cpu_shared": 5}

    def __init__(self, device_type: str = "cpu", device_id: int = 0) -> None:
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        device_type = device_type.lower()
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        if device_type == "tpu":        # the accelerator is the CUDA card
            device_type = "gpu"
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``; raises ``NoCudaDeviceError`` for a GPU
        context when no card is present."""
        if self.device_type == "gpu":
            devs = local_devices()
            if self.device_id >= len(devs):
                raise ValueError(
                    f"gpu({self.device_id}): this process has "
                    f"{len(devs)} local device(s) {[str(d) for d in devs]}")
            return devs[self.device_id]
        return torch.device("cpu")

    @classmethod
    def from_torch(cls, dev: torch.device) -> "Context":
        """The context of a tensor's device: ``gpu(i)`` or ``cpu(0)``."""
        if dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
                devs = local_devices()
                if torch.device("cuda", index) in devs:
                    return cls("gpu", devs.index(torch.device("cuda", index)))
            return cls("gpu", index)
        return cls("cpu", 0)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self) -> "Context":
        stack = getattr(_context_stack, "stack", None)
        if stack is None:
            stack = _context_stack.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _context_stack.stack.pop()

    @classmethod
    def default_ctx(cls) -> "Context":
        """The innermost ``with`` context, else ``gpu(0)``: the card, never
        a silent CPU."""
        stack = getattr(_context_stack, "stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The reference's accelerator name: CUDA card ``device_id`` here."""
    return Context("gpu", device_id)


def device(device_type: str = "cpu", device_id: int = 0) -> Context:
    return Context(device_type, device_id)


def current_context() -> Context:
    return Context.default_ctx()


def local_devices():
    """This process's CUDA devices: every card, or, under a world of
    processes (``LOCAL_RANK`` set), the one card ``LOCAL_RANK`` modulo the
    card count (so ranks beyond the cards share them). Raises
    ``NoCudaDeviceError`` when no card is present."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False — pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", int(local) % n)]


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


num_tpus = num_gpus
