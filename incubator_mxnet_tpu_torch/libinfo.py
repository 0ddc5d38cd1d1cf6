"""Library information (ref: python/mxnet/libinfo.py).

Counterpart of ``incubator_mxnet_tpu/libinfo.py``: the API level, where
the native host library is, and the port's own build features. Nothing
here builds anything: ``features()`` reports what is there.
"""
from __future__ import annotations

import os

__version__ = "1.5.0"

__all__ = ["__version__", "find_lib_path", "features"]


def find_lib_path():
    """Paths of the native host library the port builds from ``native/``
    (``_native``: ``build/native_torch/libmxtpu.so``), or
    ``MXTPU_LIBRARY_PATH``, those that exist (ref: libinfo.py
    find_lib_path, which finds libmxnet.so)."""
    from . import _native
    candidates = [_native.LIB_PATH]
    env = os.environ.get("MXTPU_LIBRARY_PATH")
    if env:
        candidates.insert(0, env)
    return [os.path.abspath(p) for p in candidates if os.path.exists(p)]


def features():
    """The port's build features (ref: the USE_* flags of MXNet 1.5's
    Makefile, ``mxnet.runtime`` later): whether PyTorch sees a CUDA card
    and its CUDA version, the kernel sources of ``ops/cuda/csrc`` and
    whether their library is built, and whether the native host library
    is built."""
    import torch
    from .ops.cuda import common
    built = sorted(common.BUILD_DIR.glob("mxtpu_torch_kernels*.so"))
    return {
        "CUDA": torch.cuda.is_available(),
        "CUDA_VERSION": torch.version.cuda,
        "KERNEL_SOURCES": [s.name for s in common.SOURCES],
        "KERNELS_BUILT": bool(built),
        "NATIVE_HOST_RUNTIME": bool(find_lib_path()),
        "INT8": True,
        "DIST": False,
    }
