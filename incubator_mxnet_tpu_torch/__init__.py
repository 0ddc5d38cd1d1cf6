"""PyTorch/CUDA port of incubator_mxnet_tpu, for the NVIDIA H100.

The JAX package beside it is the reference this port is held against. So far
the port covers generative LM serving: ``serving.InferenceEngine`` with
``load_model(name, generate={...})`` over ``models.transformer``, whose
decode-step attention runs through the hand-written CUDA kernels in
``ops/cuda/csrc``. Entry points run on the CUDA card unless the caller asks
for ``device="cpu"``.
"""
from __future__ import annotations

from .context import DEFAULT_DEVICE, NoCudaDeviceError, resolve_device

__all__ = ["DEFAULT_DEVICE", "NoCudaDeviceError", "resolve_device"]
