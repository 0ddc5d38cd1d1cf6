"""Gluon neural-network layers (ref: python/mxnet/gluon/nn/)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
