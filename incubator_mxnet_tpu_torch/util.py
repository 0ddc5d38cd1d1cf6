"""Small general utilities (ref: python/mxnet/util.py).

Counterpart of ``incubator_mxnet_tpu/util.py``. Its ``parse_xla_opts``
(XLA compiler flags for ``jax.jit``) has no counterpart: nothing in the
port compiles through XLA."""
from __future__ import annotations

import functools
import os

__all__ = ["makedirs", "use_np_shape"]


def makedirs(d):
    """Create a directory and its parents if missing (ref: util.py:23)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def use_np_shape(func):
    """The reference's opt-in to numpy shape semantics (zero-size shapes),
    which PyTorch always has: a decorator that changes nothing."""
    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        return func(*args, **kwargs)
    return wrapped
