"""Contrib datasets and samplers (ref: python/mxnet/gluon/contrib/data/).

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/data/``."""
from .sampler import IntervalSampler  # noqa: F401
from . import text  # noqa: F401
from .text import WikiText2, WikiText103  # noqa: F401
