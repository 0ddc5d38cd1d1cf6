"""NDArray API (``mx.nd``): eager tensors, the operator namespace and the
optimizer update ops.

Counterpart of ``incubator_mxnet_tpu/ndarray/``, with ``contrib`` (control
flow, the detection and vision ops), ``image``, ``sparse`` (row-sparse and
CSR storage) and ``linalg`` (batched dense linear algebra)."""
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray, _wrap, _as_nd  # noqa: F401
from .ops import *  # noqa: F401,F403
from . import ops  # noqa: F401
from .. import random  # mx.nd.random.* mirrors mx.random.*
from .optimizer_ops import *  # noqa: F401,F403
from . import contrib  # noqa: F401
from . import image  # noqa: F401
from . import linalg  # noqa: F401
from . import sparse  # noqa: F401


def __getattr__(name):
    # fall through to the op namespace for names registered there
    if hasattr(ops, name):
        return getattr(ops, name)
    raise AttributeError(f"module 'ndarray' has no attribute {name!r}")
