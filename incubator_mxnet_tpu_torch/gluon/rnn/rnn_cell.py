"""Recurrent cells.

Counterpart of ``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`` (ref:
python/mxnet/gluon/rnn/rnn_cell.py — RecurrentCell, RNNCell, LSTMCell,
GRUCell, SequentialRNNCell, DropoutCell, ModifierCell, ZoneoutCell,
ResidualCell, BidirectionalCell; unroll), over the port's ``nd`` ops. A
cell steps with plain ops (one ``FullyConnected`` per side and the gate
math); the fused LSTM kernels serve the ``LSTM`` layer.
"""
from __future__ import annotations

from ..block import HybridBlock
from ...ndarray.ndarray import NDArray, zeros as nd_zeros

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell", "HybridRecurrentCell"]


class RecurrentCell(HybridBlock):
    """(ref: rnn_cell.py:RecurrentCell)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd_zeros, **kwargs):
        """(ref: rnn_cell.py begin_state)"""
        assert not self._modified, \
            ("After applying modifier cells the base cell cannot be "
             "called directly.")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape")
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """(ref: rnn_cell.py unroll)"""
        from ... import ndarray as nd
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if isinstance(inputs, NDArray):
            batch_size = inputs.shape[batch_axis]
            seq = nd.split(inputs, length, axis=axis, squeeze_axis=True) \
                if length > 1 else [inputs.squeeze(axis)]
        else:
            batch_size = inputs[0].shape[0]
            seq = inputs
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
        if valid_length is not None:
            outputs = [nd.where(nd.broadcast_lesser(
                nd.full((batch_size, 1), i), valid_length.reshape((-1, 1))),
                o, o.zeros_like()) for i, o in enumerate(outputs)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        params = {k: v.data() for k, v in self._reg_params.items()}
        from ..block import _nd_mod_proxy
        return self.hybrid_forward(_nd_mod_proxy, inputs, states, **params)


HybridRecurrentCell = RecurrentCell


class RNNCell(RecurrentCell):
    """Elman RNN cell (ref: rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, inputs, states, *args):
        self.i2h_weight.shape = (self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """(ref: rnn_cell.py:LSTMCell) gate order i,f,g,o matching the reference's
    fused RNN weight layout (src/operator/rnn-inl.h)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, inputs, states, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slice_gates[0])
        forget_gate = F.sigmoid(slice_gates[1])
        in_transform = F.tanh(slice_gates[2])
        out_gate = F.sigmoid(slice_gates[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    """(ref: rnn_cell.py:GRUCell) gate order r,z,n."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(3 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(3 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(3 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(3 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, inputs, states, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells (ref: rnn_cell.py:SequentialRNNCell)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=nd_zeros, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), batch_size, func,
                                  **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size, func, **kwargs):
    return sum([c.begin_state(batch_size, func, **kwargs) for c in cells], [])


class DropoutCell(RecurrentCell):
    """(ref: rnn_cell.py:DropoutCell)"""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(RecurrentCell):
    """(ref: rnn_cell.py:ModifierCell)"""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd_zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """(ref: rnn_cell.py:ZoneoutCell)"""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        from ... import autograd as _ag

        def mask(p, like):
            return F.Dropout(like.ones_like(), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = next_output.zeros_like()
        if _ag.is_training():
            output = (F.where(mask(self.zoneout_outputs, next_output),
                              next_output, prev_output)
                      if self.zoneout_outputs > 0.0 else next_output)
            new_states = ([F.where(mask(self.zoneout_states, ns), ns, s)
                           for ns, s in zip(next_states, states)]
                          if self.zoneout_states > 0.0 else next_states)
        else:
            output, new_states = next_output, next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """(ref: rnn_cell.py:ResidualCell)"""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(RecurrentCell):
    """(ref: rnn_cell.py:BidirectionalCell)"""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=nd_zeros, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), batch_size, func,
                                  **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if isinstance(inputs, NDArray):
            batch_size = inputs.shape[batch_axis]
            seq = nd.split(inputs, length, axis=axis, squeeze_axis=True) \
                if length > 1 else [inputs.squeeze(axis)]
        else:
            batch_size = inputs[0].shape[0]
            seq = list(inputs)
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout, merge_outputs=False,
            valid_length=valid_length)
        rev_seq = list(reversed(seq))
        r_outputs, r_states = r_cell.unroll(
            length, rev_seq, begin_state[n_l:], layout, merge_outputs=False,
            valid_length=valid_length)
        r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
