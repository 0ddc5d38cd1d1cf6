"""Contrib RNN cells: variational dropout and the projected LSTM.

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py`` (ref:
python/mxnet/gluon/contrib/rnn/rnn_cell.py:26 VariationalDropoutCell,
:197 LSTMPCell), over the port's ``nd`` ops: a variational mask is an
ordinary dropout sample kept for every step of an unroll.
"""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, RecurrentCell, HybridRecurrentCell


class VariationalDropoutCell(ModifierCell):
    """Applies Gal & Ghahramani (2016) variational dropout: one dropout
    mask per sequence, reused at every time step, on inputs / states /
    outputs (ref: contrib/rnn/rnn_cell.py:26).
    """

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(F.ones_like(states[0]),
                                              p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(F.ones_like(inputs),
                                              p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(F.ones_like(output),
                                               p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            states = list(states)
            # mask only the recurrent hidden state (ref masks states[0])
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        output, states = cell(inputs, states)
        self._initialize_output_mask(F, output)
        if self.drop_outputs:
            output = output * self.drop_outputs_mask
        return output, states

    def __repr__(self):
        return (f"VariationalDropoutCell(p_in={self.drop_inputs}, "
                f"p_state={self.drop_states}, p_out={self.drop_outputs}, "
                f"base={self.base_cell!r})")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        # one fresh set of masks per unroll (reference behavior)
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a linear projection of the hidden state (ref:
    contrib/rnn/rnn_cell.py:197 LSTMPCell; Sak et al. 2014,
    arxiv 1402.1128). States: [projected r (B, P), cell c (B, H)].
    """

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, inputs, states, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        r_prev, c_prev = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(r_prev, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slice_gates[0])
        forget_gate = F.sigmoid(slice_gates[1])
        in_transform = F.tanh(slice_gates[2])
        out_gate = F.sigmoid(slice_gates[3])
        next_c = forget_gate * c_prev + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
