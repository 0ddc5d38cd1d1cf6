"""mx.contrib.ndarray: the ``nd.contrib`` op namespace under its other
name (ref: python/mxnet/contrib/ndarray.py, where the generated _contrib_*
op wrappers attach). Counterpart of
``incubator_mxnet_tpu/contrib/ndarray.py``."""
from ..ndarray.contrib import *  # noqa: F401,F403
from ..ndarray import contrib as _c


def __getattr__(name):
    return getattr(_c, name)
