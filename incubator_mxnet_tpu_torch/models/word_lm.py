"""The word-level LSTM language model of MXNet's
``example/gluon/word_language_model`` (Embedding -> Dropout -> LSTM stack ->
Dropout -> (tied) Dense decoder).

Counterpart of ``incubator_mxnet_tpu/models/word_lm.py``. The LSTM stack is
the gluon ``rnn.LSTM`` layer, whose time loop runs the fused LSTM kernels
(``ops/cuda/lstm.py``). The bucketing symbol factory ``lm_sym_gen`` builds
a symbolic graph, and the symbolic API is ``ROADMAP.md`` A11, so it raises.
"""
from __future__ import annotations

from typing import List

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["RNNModel", "lm_sym_gen", "default_buckets"]


class RNNModel(HybridBlock):
    """Embedding -> Dropout -> LSTM/GRU stack -> (tied) decoder.
    (ref: example/gluon/word_language_model/model.py RNNModel)"""

    def __init__(self, mode: str = "lstm", vocab_size: int = 10000,
                 num_embed: int = 200, num_hidden: int = 200,
                 num_layers: int = 2, dropout: float = 0.5,
                 tie_weights: bool = False, **kwargs):
        super().__init__(**kwargs)
        self._mode = mode
        self.num_hidden = num_hidden
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed,
                                        weight_initializer=None)
            layer = {"lstm": rnn.LSTM, "gru": rnn.GRU}.get(mode, rnn.RNN)
            self.rnn = layer(num_hidden, num_layers, dropout=dropout,
                             input_size=num_embed)
            if tie_weights:
                assert num_embed == num_hidden, \
                    "tied decoder needs num_embed == num_hidden"
                # the decoder's weight IS the encoder's parameter
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=num_hidden,
                                        params=self.encoder.params)
            else:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=num_hidden)

    def forward(self, inputs, state=None):
        """inputs (T, B) int tokens; returns (logits (T, B, V), state)."""
        emb = self.drop(self.encoder(inputs))
        if state is None:
            state = self.begin_state(batch_size=inputs.shape[1])
        output, state = self.rnn(emb, state)
        output = self.drop(output)
        return self.decoder(output), state

    def begin_state(self, batch_size: int, **kwargs):
        return self.rnn.begin_state(batch_size=batch_size, **kwargs)


def default_buckets() -> List[int]:
    """ref: example/rnn/bucketing/lstm_bucketing.py buckets"""
    return [10, 20, 30, 40, 50, 60]


def lm_sym_gen(vocab_size: int, num_embed: int, num_hidden: int,
               num_layers: int = 1):
    """The reference's bucketing symbol factory (for BucketingModule)
    builds symbols, which the port does not have yet."""
    raise NotImplementedError(
        "lm_sym_gen: the bucketing symbol factory needs the symbolic API "
        "(symbol, BucketingModule), ROADMAP.md A11")
