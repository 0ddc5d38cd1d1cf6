"""Hand-written CUDA kernels of the port (sources under ``csrc/``), each
beside its plain PyTorch version."""
from .flash_attention import (decode_attention, decode_attention_reference,
                              flash_decode_step, flash_decode_step_paged,
                              launch_counts, paged_decode_attention,
                              paged_decode_attention_reference,
                              reset_launch_counts)

__all__ = ["decode_attention", "decode_attention_reference",
           "flash_decode_step", "flash_decode_step_paged", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_reference",
           "reset_launch_counts"]
