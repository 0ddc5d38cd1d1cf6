"""Hand-written CUDA kernels of the port (sources under ``csrc/``), each
beside its plain PyTorch version. ``launch_counts()`` reads the launch
count of every kernel wrapper. The differentiable row ops are
``layer_norm.layer_norm`` and ``softmax.softmax`` (modules of the same
names as the functions, so the functions are not re-exported here)."""
from .common import launch_counts, reset_launch_counts
from .flash_attention import (decode_attention, decode_attention_reference,
                              flash_decode_step, flash_decode_step_paged,
                              paged_decode_attention,
                              paged_decode_attention_reference)
from . import layer_norm, softmax

__all__ = ["decode_attention", "decode_attention_reference",
           "flash_decode_step", "flash_decode_step_paged", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_reference",
           "reset_launch_counts", "layer_norm", "softmax"]
