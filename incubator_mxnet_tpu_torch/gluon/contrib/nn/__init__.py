"""Contrib layers (ref: python/mxnet/gluon/contrib/nn/basic_layers.py —
Concurrent, HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm,
PixelShuffle2D)."""
from .basic_layers import *  # noqa: F401,F403
