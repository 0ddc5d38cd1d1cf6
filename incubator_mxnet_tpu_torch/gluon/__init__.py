"""Gluon: the imperative/hybrid model API (ref: python/mxnet/gluon/).

Counterpart of ``incubator_mxnet_tpu/gluon/``. Of ``contrib`` the port
has ``contrib.data``."""
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
from . import data  # noqa: F401
from . import contrib  # noqa: F401
