"""Gluon: the imperative/hybrid model API (ref: python/mxnet/gluon/).

Counterpart of ``incubator_mxnet_tpu/gluon/``. Not ported yet: ``rnn``
(ROADMAP.md A7), ``data`` (A6) and ``contrib``."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
