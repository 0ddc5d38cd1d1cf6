"""Convolutional recurrent cells: ConvRNN, ConvLSTM and ConvGRU in 1, 2
and 3 dimensions.

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``
(ref: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py:37 _BaseConvRNNCell
and the nine Conv{1,2,3}D{RNN,LSTM,GRU}Cell classes; Shi et al. 2015 for
ConvLSTM). Each step is two ``nd.Convolution`` calls (i2h over the input,
h2h "same"-padded over the state). The layout is NC + spatial (the
reference's default ``conv_layout``).
"""
from __future__ import annotations

from ...rnn.rnn_cell import RecurrentCell


def _tuple(x, dims):
    return (x,) * dims if isinstance(x, int) else tuple(x)


def _conv_out_size(dimensions, kernel, pad, dilate):
    return tuple(
        int(x + 2 * p - d * (k - 1) - 1) + 1 if x else 0
        for x, k, p, d in zip(dimensions, kernel, pad, dilate))


class _BaseConvRNNCell(RecurrentCell):
    """Shared conv-cell machinery (ref: conv_rnn_cell.py:37)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not conv_layout.startswith("NC"):
            raise ValueError(
                f"only channel-first conv_layout supported, got {conv_layout}")
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)  # (C, *spatial), no batch
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._i2h_dilate = _tuple(i2h_dilate, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                f"h2h_kernel must be odd so the state keeps its spatial "
                f"size, got {self._h2h_kernel}")
        self._h2h_dilate = _tuple(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2
                              for d, k in zip(self._h2h_dilate,
                                              self._h2h_kernel))
        self._stride = (1,) * dims

        in_channels = self._input_shape[0]
        spatial = self._input_shape[1:]
        total_out = hidden_channels * self._num_gates
        self._state_shape = ((hidden_channels,) +
                             _conv_out_size(spatial, self._i2h_kernel,
                                            self._i2h_pad, self._i2h_dilate))
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(total_out, in_channels) + self._i2h_kernel,
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(total_out, hidden_channels) + self._h2h_kernel,
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(total_out,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(total_out,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}
                for _ in range(self._num_states)]

    def infer_shape(self, inputs, states, *args):
        self.i2h_weight.shape = (
            (self._hidden_channels * self._num_gates, inputs.shape[1]) +
            self._i2h_kernel)

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        i2h = F.Convolution(
            inputs, i2h_weight, i2h_bias,
            kernel=self._i2h_kernel, stride=self._stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            num_filter=self._hidden_channels * self._num_gates)
        h2h = F.Convolution(
            states[0], h2h_weight, h2h_bias,
            kernel=self._h2h_kernel, stride=self._stride,
            pad=self._h2h_pad, dilate=self._h2h_dilate,
            num_filter=self._hidden_channels * self._num_gates)
        return i2h, h2h

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_shape} -> "
                f"{self._hidden_channels}, i2h_kernel={self._i2h_kernel})")


class _ConvRNNCell(_BaseConvRNNCell):
    _gate_names = ("",)
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    _gate_names = ("_i", "_f", "_c", "_o")
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        sg = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(sg[0])
        forget_gate = F.sigmoid(sg[1])
        in_transform = self._get_activation(F, sg[2], self._activation)
        out_gate = F.sigmoid(sg[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _gate_names = ("_r", "_z", "_o")
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = self._get_activation(F, i2h_n + reset_gate * h2h_n,
                                          self._activation)
        next_h = ((1.0 - update_gate) * next_h_tmp +
                  update_gate * states[0])
        return next_h, [next_h]


def _make(base, dims, name, layout, doc_ref):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=layout, activation="tanh", prefix=None,
                 params=None):
        base.__init__(self, input_shape=input_shape,
                      hidden_channels=hidden_channels,
                      i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                      i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                      h2h_dilate=h2h_dilate,
                      i2h_weight_initializer=i2h_weight_initializer,
                      h2h_weight_initializer=h2h_weight_initializer,
                      i2h_bias_initializer=i2h_bias_initializer,
                      h2h_bias_initializer=h2h_bias_initializer,
                      dims=dims, conv_layout=conv_layout,
                      activation=activation, prefix=prefix, params=params)
    cls = type(name, (base,), {
        "__init__": __init__,
        "__doc__": f"{dims}D convolutional cell (ref: {doc_ref}).",
    })
    return cls


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell", "NCW",
                      "conv_rnn_cell.py:218 Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell", "NCHW",
                      "conv_rnn_cell.py:285 Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell", "NCDHW",
                      "conv_rnn_cell.py:352 Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell", "NCW",
                       "conv_rnn_cell.py:473 Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell", "NCHW",
                       "conv_rnn_cell.py:550 Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell", "NCDHW",
                       "conv_rnn_cell.py:627 Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell", "NCW",
                      "conv_rnn_cell.py:762 Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell", "NCHW",
                      "conv_rnn_cell.py:834 Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell", "NCDHW",
                      "conv_rnn_cell.py:906 Conv3DGRUCell")
