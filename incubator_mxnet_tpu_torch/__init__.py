"""PyTorch/CUDA port of incubator_mxnet_tpu, for the NVIDIA H100.

The JAX package beside it is the reference this port is held against.
Typical use, as with the reference::

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, autograd

    x = nd.array([[1.0, 2.0]]); x.attach_grad()
    with autograd.record():
        y = nd.softmax(x * 2)
    y.backward()

The port covers so far: the parameter-server half of the distributed
slice (``parallel.embedding``'s sharded tables on the row-sparse update
kernel, ``gluon.nn.ShardedEmbedding``, ``models.sparse_recommenders``,
``kvstore`` with the async parameter server, ``Trainer``'s distributed
stores and ``fault``) (slice 29); sparse storage (``nd.sparse``),
``nd.linalg``, the
fused trainer step (``optimizer.fused``) on its multi-tensor kernels, and
the small ``contrib`` and ``gluon.contrib`` modules, ``util``, ``log``,
``misc`` and ``libinfo`` (slice 27); the rest of vision and input (``image``'s
detection iterator and augmenters, ``input_service`` with ``elastic``'s
``GroupView`` and ``shard_batch``, the AlexNet, DenseNet, SqueezeNet,
Inception V3 and MobileNet zoo families, ``contrib.text``,
``gluon.contrib.data`` and ``rnn``'s ``BucketSentenceIter``) (slice 26);
the image input path (``io``, ``recordio``,
``image``, ``nd.image``, ``gluon.data``; the native RecordIO pipeline of
``native/`` built by ``_native``) (slice 25); int8 inference (``contrib.quantization``,
``ops.quantization``, ``nd.contrib.quantize*``, ``load_model(quantize=)``)
on its int8 tensor-core kernels, and the HTTP front end
``tools.serve`` (slice 23); runtime-compiled CUDA kernels (``rtc``: NVRTC
and the driver API), custom operators (``operator``, ``nd.Custom``),
``test_utils`` and ``registry`` (slice 7); SSD detection (``models.ssd``,
``nd.contrib``) with its matcher and NMS kernels (slice 6); the fused
RNN (``nd.RNN``, ``gluon.rnn``) with the word LM ``models.RNNModel`` and
its LSTM kernels, and ``metric`` (slice 5);
Gluon (blocks, layers, losses, ``Trainer``,
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
from . import metric
from . import optimizer
from . import gluon
from . import rtc
from . import operator
from .operator import CustomOp, CustomOpProp, register as register_op
from . import test_utils
from . import registry
from . import contrib
from . import io
from . import recordio
from . import image
from . import rnn
from . import elastic
from . import input_service
from . import util
from . import libinfo
from .libinfo import __version__
from . import log
from . import misc
from . import kvstore
from . import fault
from . import kvstore_server

__all__ = ["DEFAULT_DEVICE", "NoCudaDeviceError", "resolve_device",
           "MXTPUError", "Context", "cpu", "gpu", "tpu", "device",
           "current_context", "num_gpus", "num_tpus", "NDArray", "base",
           "context", "ndarray", "nd", "autograd", "random", "engine",
           "initializer", "init", "name", "lr_scheduler", "metric",
           "optimizer", "gluon", "rtc", "operator", "CustomOp",
           "CustomOpProp", "register_op", "test_utils", "registry",
           "contrib", "io", "recordio", "image", "rnn", "elastic",
           "input_service", "util", "libinfo", "log", "misc", "kvstore",
           "fault"]
