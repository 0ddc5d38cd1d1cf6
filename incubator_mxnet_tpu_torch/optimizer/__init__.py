"""Optimizer API (ref: python/mxnet/optimizer/). The fused whole-step
executor of the reference (``optimizer/fused.py``) is ROADMAP.md A5."""
from .optimizer import *  # noqa: F401,F403
from . import optimizer  # noqa: F401
from .optimizer import Optimizer, Updater, get_updater, create, register  # noqa: F401
