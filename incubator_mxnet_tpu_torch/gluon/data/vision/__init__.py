"""Vision data API (ref: python/mxnet/gluon/data/vision/)."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
