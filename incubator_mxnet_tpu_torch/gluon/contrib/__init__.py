"""Gluon contrib (ref: python/mxnet/gluon/contrib/).

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/``: ``nn``
(``Concurrent``, ``HybridConcurrent``, ``Identity``, ``SparseEmbedding``,
``SyncBatchNorm``, ``PixelShuffle2D``), ``rnn`` (``VariationalDropoutCell``,
``LSTMPCell`` and the nine convolutional cells) and ``data``
(``IntervalSampler``, ``WikiText2``, ``WikiText103``)."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
