"""Optimizer API (ref: python/mxnet/optimizer/): the optimizers, the
``Updater`` and the fused whole-step executor (``fused``, one
``multi_tensor_update`` launch a step on the card)."""
from .optimizer import *  # noqa: F401,F403
from . import optimizer  # noqa: F401
from .optimizer import Optimizer, Updater, get_updater, create, register  # noqa: F401
from . import fused  # noqa: F401
