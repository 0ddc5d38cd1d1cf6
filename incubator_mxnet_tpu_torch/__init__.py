"""PyTorch/CUDA port of incubator_mxnet_tpu, for the NVIDIA H100.

The JAX package beside it is the reference this port is held against.
Typical use, as with the reference::

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, autograd

    x = nd.array([[1.0, 2.0]]); x.attach_grad()
    with autograd.record():
        y = nd.softmax(x * 2)
    y.backward()

The port covers so far: Gluon (blocks, layers, losses, ``Trainer``,
``optimizer``, ``lr_scheduler``) with the ResNet model zoo and its fused
conv kernels, and the one-card functional train step
``parallel.dp.make_train_step`` (slice 4); the imperative ``nd`` +
``autograd`` API with ``random``, ``initializer`` and the ``nd`` update ops
(slice 3); generative LM serving (``serving.InferenceEngine``) and
single-device LM training (``models.transformer``) (slices 1 and 2). Its
hand-written CUDA kernels live in ``ops/cuda/csrc``. Arrays and entry points run on the CUDA card
unless the caller asks for the CPU (``ctx=mx.cpu()``, ``with mx.cpu():`` or
``device="cpu"``); without a card, the default raises.
"""
from __future__ import annotations

from . import base
from .base import MXTPUError
from .context import (DEFAULT_DEVICE, Context, NoCudaDeviceError, cpu,
                      current_context, device, gpu, num_gpus, num_tpus,
                      resolve_device, tpu)
from . import context
from . import ndarray
from . import ndarray as nd
from .ndarray.ndarray import NDArray
from . import autograd
from . import random
from . import engine
from . import initializer
from .initializer import init
from . import name
from . import lr_scheduler
from . import optimizer
from . import gluon

__all__ = ["DEFAULT_DEVICE", "NoCudaDeviceError", "resolve_device",
           "MXTPUError", "Context", "cpu", "gpu", "tpu", "device",
           "current_context", "num_gpus", "num_tpus", "NDArray", "base",
           "context", "ndarray", "nd", "autograd", "random", "engine",
           "initializer", "init", "name", "lr_scheduler", "optimizer",
           "gluon"]
