"""Legacy RNN namespace (``mx.rnn``; ref: python/mxnet/rnn/).

Counterpart of ``incubator_mxnet_tpu/rnn/``. The port has the bucketing
sentence iterator (``io``: ``BucketSentenceIter``, ``encode_sentences``).
The symbolic cells of ``rnn_cell.py`` and the checkpoint helpers of
``rnn.py`` build Symbol graphs, which are ROADMAP.md A11; their names
raise."""
from .io import BucketSentenceIter, encode_sentences  # noqa: F401

_NOT_PORTED = ("rnn_cell", "RNNParams", "BaseRNNCell", "RNNCell",
               "LSTMCell", "GRUCell", "FusedRNNCell", "SequentialRNNCell",
               "BidirectionalCell", "DropoutCell", "ModifierCell",
               "ZoneoutCell", "ResidualCell", "save_rnn_checkpoint",
               "load_rnn_checkpoint", "do_rnn_checkpoint")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"rnn.{name}: the symbolic RNN cells are ROADMAP.md A11 (symbolic "
            "and the long tail), not ported yet; gluon.rnn has the cells")
    raise AttributeError(f"module 'rnn' has no attribute {name!r}")
