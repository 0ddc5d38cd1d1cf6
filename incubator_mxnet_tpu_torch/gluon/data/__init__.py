"""Gluon data API (ref: python/mxnet/gluon/data/).

Counterpart of ``incubator_mxnet_tpu/gluon/data/`` (the contrib datasets
and samplers are ``gluon.contrib.data``)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
