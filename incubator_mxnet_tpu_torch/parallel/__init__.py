"""Parallel-layer helpers of the PyTorch port: plain attention, the
single-device MoE FFN, and the one-card functional train step (``dp``)."""
from .moe import moe_layer_dense, top1_gating
from .ring_attention import attention_reference

__all__ = ["attention_reference", "moe_layer_dense", "top1_gating"]
