"""Fused recurrent layers.

Counterpart of ``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`` (ref:
python/mxnet/gluon/rnn/rnn_layer.py — RNN, LSTM, GRU with num_layers,
bidirectional and dropout). The whole (layers x directions x time)
recurrence is one ``invoke`` of ``ops.rnn.rnn_core``: per (layer,
direction) one batched input projection, then the time loop, which for
LSTM runs the fused LSTM kernels (``ops/cuda/lstm.py``) as one
``torch.autograd.Function`` per sequence. ``invoke`` runs it in the grad
mode of the caller's route (``autograd.record()``, or the functional
trace of ``parallel.dp``), so the Function lands on PyTorch's tape in both.
Parameter names (``l0_i2h_weight`` ...) are the reference's, so weights
cross by name.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ...ndarray.ndarray import NDArray, invoke, zeros as nd_zeros
from ...ops.rnn import rnn_core

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """(ref: rnn_layer.py:_RNNLayer)"""

    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode,
                 activation="tanh", prefix=None, params=None):
        # _alias (used for auto-prefixing in Block.__init__) needs _mode
        self._mode = mode
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC', 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._activation = activation
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in self._dirs():
                    name = f"{j}{i}"
                    setattr(self, f"{name}_i2h_weight", self.params.get(
                        f"{name}_i2h_weight", shape=(ng * nh, ni),
                        init=i2h_weight_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}_h2h_weight", self.params.get(
                        f"{name}_h2h_weight", shape=(ng * nh, nh),
                        init=h2h_weight_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}_i2h_bias", self.params.get(
                        f"{name}_i2h_bias", shape=(ng * nh,),
                        init=i2h_bias_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}_h2h_bias", self.params.get(
                        f"{name}_h2h_bias", shape=(ng * nh,),
                        init=h2h_bias_initializer, allow_deferred_init=True))
                ni = nh * self._dir

    def _dirs(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def state_info(self, batch_size=0):
        info = {"shape": (self._num_layers * self._dir, batch_size,
                          self._hidden_size), "__layout__": "LNC"}
        return [info] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=nd_zeros, **kwargs):
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            info.update(kwargs)
            states.append(func(shape, **info))
        return states

    def infer_shape(self, inputs, *args):
        ni = inputs.shape[2]
        for i in range(self._num_layers):
            for j in self._dirs():
                p = getattr(self, f"{j}{i}_i2h_weight")
                p.shape = (self._gates * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def _alias(self):
        return self._mode

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers})")

    def forward(self, inputs, states=None):
        """Run the fused recurrence (ref: rnn_layer.py forward -> fused
        RNN op)."""
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, NDArray):
            states = [states]
        param_nds = [getattr(self, f"{j}{i}_{part}").data()
                     for i in range(self._num_layers) for j in self._dirs()
                     for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                                  "h2h_bias")]

        mode, layout = self._mode, self._layout
        num_layers, ndir = self._num_layers, self._dir
        dropout = self._dropout
        from ... import autograd as _ag
        from ... import random as _random
        training = _ag.is_training()
        gen = (_random.generator(inputs.context)
               if (dropout > 0 and training) else None)
        n_state = 2 if mode == "lstm" else 1

        def fused(x, *flat):
            h0_all = flat[0]
            c0_all = flat[1] if mode == "lstm" else torch.zeros_like(h0_all)
            params_flat = flat[n_state:]
            if layout == "NTC":
                x = x.transpose(0, 1)
            # param order per (layer, dir) is i2h_w, h2h_w, i2h_b, h2h_b
            layer_params = [[tuple(params_flat[4 * k:4 * k + 4])
                             for k in range(li * ndir, (li + 1) * ndir)]
                            for li in range(num_layers)]
            cur, h_n, c_n = rnn_core(x, layer_params, h0_all, c0_all, mode,
                                     dropout=dropout, training=training,
                                     generator=gen)
            if layout == "NTC":
                cur = cur.transpose(0, 1)
            return (cur, h_n, c_n) if mode == "lstm" else (cur, h_n)

        results = invoke(fused, [inputs] + list(states) + param_nds,
                         f"RNN:{mode}", n_out=1 + n_state)
        outputs, out_states = results[0], list(results[1:])
        if skip_states:
            return outputs
        return outputs, out_states

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        return self.forward(inputs, states)


class RNN(_RNNLayer):
    """(ref: rnn_layer.py:RNN)"""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer,
                         "rnn_relu" if activation == "relu" else "rnn_tanh",
                         activation, **kwargs)


class LSTM(_RNNLayer):
    """(ref: rnn_layer.py:LSTM)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """(ref: rnn_layer.py:GRU)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
