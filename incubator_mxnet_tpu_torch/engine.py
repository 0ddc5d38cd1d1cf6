"""Execution-engine control surface.

Counterpart of ``incubator_mxnet_tpu/engine.py``. PyTorch already queues
every CUDA op on a stream in order, so the "engine" is a control API:
waiting (``waitall``/``wait_for_all``), a deterministic serial mode
(``naive_engine``: the device is synchronized after every ``nd`` op), and
the bulk-size knob. ``set_bulk_size(N)`` and ``bulk(N)`` chunk the fused
trainer step (``optimizer/fused.py``) into ceil(T/N) launches over T
tensors; 0 turns the fused step off; unset is one launch a step.
"""
from __future__ import annotations

import contextlib
import os

from .base import env

__all__ = ["set_engine_type", "engine_type", "wait_for_all", "waitall",
           "naive_engine", "bulk", "set_bulk_size", "bulk_size",
           "host_engine"]


def engine_type() -> str:
    """'async' (default) or 'naive' (synchronize after each op)."""
    return env.get("ENGINE_TYPE")


def set_engine_type(kind: str) -> None:
    if kind not in ("async", "naive"):
        raise ValueError("engine type must be 'async' or 'naive'")
    os.environ["MXTPU_ENGINE_TYPE"] = kind


@contextlib.contextmanager
def naive_engine():
    """Scope forcing serial execution: every ``nd`` op waits for its
    device (a debugging aid; ref: NaiveEngine)."""
    prev = os.environ.get("MXTPU_ENGINE_TYPE")
    os.environ["MXTPU_ENGINE_TYPE"] = "naive"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MXTPU_ENGINE_TYPE", None)
        else:
            os.environ["MXTPU_ENGINE_TYPE"] = prev


def waitall() -> None:
    """Block until all queued device work is done (ref: mx.nd.waitall)."""
    from .ndarray.ndarray import waitall as _waitall
    _waitall()


wait_for_all = waitall

_bulk_size = None


def bulk_size():
    """Current bulk size (None = unset)."""
    return _bulk_size


def set_bulk_size(size: int):
    """Set the bulk size; returns the old value (ref:
    Engine::set_bulk_size)."""
    global _bulk_size
    old, _bulk_size = _bulk_size, size
    return old


@contextlib.contextmanager
def bulk(size: int):
    """(ref: mx.engine.bulk context manager)"""
    old = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(old)


def host_engine(num_workers: int = 4):
    """The reference's native host-task engine (``native/``) is not ported
    (``ROADMAP.md`` A12)."""
    raise NotImplementedError(
        "engine.host_engine: the native host engine is ROADMAP.md A12")
