"""Gluon RNN API (ref: python/mxnet/gluon/rnn/): the fused layers ``RNN``,
``LSTM`` and ``GRU``, and the recurrent cells with ``unroll``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
