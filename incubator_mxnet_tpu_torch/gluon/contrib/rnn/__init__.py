"""Contrib recurrent cells (ref: python/mxnet/gluon/contrib/rnn/)."""
from .rnn_cell import VariationalDropoutCell, LSTMPCell  # noqa: F401
from .conv_rnn_cell import (  # noqa: F401
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)

__all__ = ["VariationalDropoutCell", "LSTMPCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]
