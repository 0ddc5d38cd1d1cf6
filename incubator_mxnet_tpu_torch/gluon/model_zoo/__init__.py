"""Model zoo (ref: python/mxnet/gluon/model_zoo/)."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
