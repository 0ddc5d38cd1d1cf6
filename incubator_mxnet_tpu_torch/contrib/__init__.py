"""Contrib namespace (ref: python/mxnet/contrib/).

Counterpart of ``incubator_mxnet_tpu/contrib/``: ``quantization``,
``text``, ``autograd`` (the pre-1.0 API), ``io`` (``DataLoaderIter``),
``ndarray`` (the ``nd.contrib`` ops) and ``tensorboard``
(``LogMetricsCallback``). Not ported: ``svrg_optimization``, which
subclasses ``module.Module``, and ``symbol`` and ``onnx``, which need the
symbolic API (ROADMAP.md A11)."""
from . import quantization
from . import text
from . import autograd
from . import io
from . import ndarray
from . import tensorboard

__all__ = ["quantization", "text", "autograd", "io", "ndarray",
           "tensorboard"]
