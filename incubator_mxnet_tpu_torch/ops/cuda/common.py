"""Shared helpers for the port's CUDA kernels: the masking constant, block
picking, the kernel builder, and the launch counts of every kernel wrapper.

The builder compiles every source under ``csrc/`` in ONE
``torch.utils.cpp_extension.load`` call, at first use, into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
for ``sm_90a``. No source includes a PyTorch header: the binding file
exports plain C functions that :func:`kernel_library` loads with ctypes, so
the build takes seconds rather than minutes. Importing this module builds
nothing and needs no CUDA toolkit.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from pathlib import Path

import torch

__all__ = ["NEG_INF", "pick_block", "pick_row_block", "kernel_library", "check_launch",
           "current_stream_handle", "counted_kernel", "launch_counts",
           "sm90_launch_counts", "x3_launch_counts", "reset_launch_counts",
           "recording_launches", "add_launch_counts", "sm_count",
           "ticket_buffer", "BUILD_DIR", "CUDA_FLAGS", "SOURCES"]

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "decode_attention.cu", CSRC / "flash_attention.cu",
           CSRC / "flash_attention_sm90.cu", CSRC / "layer_norm.cu",
           CSRC / "softmax.cu", CSRC / "conv_fused.cu",
           CSRC / "conv_fused_sm90.cu", CSRC / "lstm.cu",
           CSRC / "detection.cu", CSRC / "quantized.cu",
           CSRC / "multi_tensor.cu", CSRC / "bindings.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# every exported function returns a cudaError_t as int
_SIGNATURES = {
    "mxt_flash_decode_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _P],
    "mxt_flash_decode_step_paged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _P],
    "mxt_decode_split": [_I, _I] + [_P] * 8 + [_I] * 9 + [_F, _P],
    "mxt_flash_fwd": [_P, _P, _P, _P, _P] + [_I] * 9 + [_F, _P],
    "mxt_flash_fwd_sm90": [_P] * 5 + [_I] * 7 + [_F, _P],
    "mxt_flash_bwd_dq": [_P] * 7 + [_I] * 9 + [_F, _P],
    "mxt_flash_bwd_dkv": [_P] * 8 + [_I] * 9 + [_F, _P],
    "mxt_flash_bwd_dq_sm90": [_P] * 7 + [_I] * 7 + [_F, _P],
    "mxt_flash_bwd_dkv_sm90": [_P] * 8 + [_I] * 7 + [_F, _P],
    "mxt_layer_norm_fwd": [_P] * 6 + [_I] * 3 + [_F, _P],
    "mxt_layer_norm_fwd_vec": [_P] * 6 + [_I] * 5 + [_F, _P],
    "mxt_layer_norm_bwd": [_P] * 8 + [_I] * 4 + [_P],
    "mxt_layer_norm_bwd_onepass": [_P] * 10 + [_I] * 5 + [_P],
    "mxt_softmax_fwd": [_P, _P, _I, _I, _I, _P],
    "mxt_conv_fused_fwd": [_I, _I] + [_P] * 7 + [_L] * 3 + [_P] * 4
                          + [_I] * 5 + [_P],
    "mxt_conv_fused_dgrad": [_I, _I] + [_P] * 5 + [_L] * 3 + [_P] * 6
                            + [_I, _I, _P, _P] + [_I] * 5 + [_P],
    "mxt_conv_fused_wgrad": [_I, _I] + [_P] * 8 + [_I] * 7 + [_P],
    "mxt_conv_fused_dual_dgrad": [_I] + ([_P] * 4 + [_L] * 2) * 2
                                 + [_P] + [_I] * 4 + [_P],
    "mxt_conv_fused_dual_wgrad": [_I] + [_P] * 8 + [_I] * 6 + [_P],
    "mxt_conv_fused_sm90_fwd": [_P] * 7 + [_L] * 2 + [_P] * 4 + [_I] * 4
                               + [_P],
    "mxt_conv_fused_sm90_dual_dgrad": ([_P] * 4 + [_L] * 2 + [_P]) * 2
                                      + [_P] + [_I] * 5 + [_P],
    "mxt_conv_fused_sm90_dual_wgrad": [_P] * 4 + [_I] * 7 + [_P],
    "mxt_conv_fused_sm90_bwd_dgrad": [_P] * 5 + [_L] * 2 + [_P] * 7
                                     + [_I] * 2 + [_P] * 3 + [_I] * 4 + [_P],
    "mxt_conv_fused_sm90_conv3": [_P] * 4 + [_L] * 3 + [_P] * 2 + [_I] * 6
                                 + [_P],
    "mxt_conv_fused_sm90_conv3_bwd": [_P] * 4 + [_L] * 3 + [_P] * 8
                                     + [_I] * 8 + [_P],
    "mxt_conv_fused_sm90_split3": [_I, _P, _P],
    "mxt_conv_fused_sm90_fwd_x3": [_P] * 11 + [_I] * 3 + [_P],
    "mxt_conv_fused_sm90_conv3_x3": [_P] * 6 + [_I] * 5 + [_P],
    "mxt_conv_fused_sm90_dual_dgrad_x3": [_P] * 11 + [_I] * 4 + [_P],
    "mxt_conv_fused_sm90_bwd_dgrad_x3": [_P] * 12 + [_I] * 2 + [_P] * 3
                                        + [_I] * 3 + [_P],
    "mxt_conv_fused_sm90_dual_wgrad_x3": [_P] * 4 + [_I] * 6 + [_P],
    "mxt_conv_fused_sm90_conv3_bwd_x3": [_P] * 12 + [_I] * 7 + [_P],
    "mxt_lstm_fwd": [_I, _I, _I] + [_P] * 8 + [_I, _I, _P],
    "mxt_lstm_fwd_sm90": [_I, _I, _I] + [_P] * 8 + [_I] * 4 + [_P],
    "mxt_lstm_bwd": [_I, _I] + [_P] * 9 + [_I, _I, _P],
    "mxt_lstm_bwd_sm90": [_I, _I] + [_P] * 10 + [_I] * 4 + [_P],
    "mxt_multibox_match": [_P, _P, _I, _I, _I] + [_F] * 5 + [_I] + [_P] * 5,
    "mxt_nms_keep": [_P, _P, _P, _I, _I, _F, _I, _I, _P, _P, _P],
    "mxt_multibox_match_cluster": [_P, _P] + [_I] * 5 + [_F] * 5
                                  + [_P] * 5,
    "mxt_nms_keep_cluster": [_P, _P, _P, _L, _L, _L] + [_I] * 4
                            + [_F, _I, _P, _P, _P],
    "mxt_qmma_s8": [_I, _I] + [_P] * 4 + [_I] * 16 + [_I, _F, _F, _I, _P],
    "mxt_qtma_s8": [_I, _I] + [_P] * 6 + [_I, _F, _F, _I, _P],
    "mxt_multi_tensor_update": [_I, _P, _I, _I, _P, _P],
    "mxt_multi_tensor_all_finite": [_P, _I, _I, _P, _P, _P, _P],
    "mxt_row_sparse_update": [_I, _P, _P, _I, _L, _I, _P, _P],
}

_lib = None
_lib_lock = threading.Lock()
_KERNELS = []      # every kernel wrapper, in registration order


_COUNTS = ("launches", "sm90_launches", "x3_launches")

# while a graph is captured, the counts its body makes go to the capture's
# record (recording_launches) and not to the shared counts: on the
# capturing thread, and on the stream under capture (the autograd engine
# runs a captured backward's wrappers on a thread of its own)
_CAPTURING = threading.local()
_STREAM_RECORDS = {}


def _capture_record():
    rec = getattr(_CAPTURING, "record", None)
    if rec is None and _STREAM_RECORDS \
            and torch.cuda.is_current_stream_capturing():
        rec = _STREAM_RECORDS.get(torch.cuda.current_stream().cuda_stream)
    return rec


class _Count:
    """One of a counted kernel's counts (``_COUNTS``): the shared count,
    or, while a graph is captured, the capture's own (see
    :func:`recording_launches`)."""

    def __set_name__(self, owner, name):
        self.i = _COUNTS.index(name)

    def __get__(self, kern, owner=None):
        if kern is None:
            return self
        rec = _capture_record()
        if rec is not None:
            return rec.get(kern.__name__, (0, 0, 0))[self.i]
        return kern._counts[self.i]

    def __set__(self, kern, value):
        rec = _capture_record()
        if rec is None:
            kern._counts[self.i] = value
            return
        counts = list(rec.get(kern.__name__, (0, 0, 0)))
        counts[self.i] = value
        rec[kern.__name__] = tuple(counts)


class _CountedKernel:
    """A kernel wrapper with its launch counts (``counted_kernel``)."""

    launches = _Count()
    sm90_launches = _Count()
    x3_launches = _Count()

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._counts = [0, 0, 0]

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    def __repr__(self):
        return f"<counted kernel {self.__name__}>"


def counted_kernel(fn):
    """Register a kernel wrapper for :func:`launch_counts`. The wrapper
    bumps ``fn.launches`` itself, right after a launch succeeds, and
    nowhere else; a wrapper with a Hopper route (``csrc/*_sm90.cu``) also
    bumps ``fn.sm90_launches`` when the call took that route, and
    ``fn.x3_launches`` as well when that route was the float32 one with
    every operand in three bf16 pieces (``mm_fused``, ``conv3_fused``,
    ``dgrad_epilogue``, ``mm_fused_bwd``, ``conv3_fused_bwd``, and the
    float32 ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``). Counts
    made while a graph is captured are the capture's
    (:func:`recording_launches`)."""
    kern = _CountedKernel(fn)
    _KERNELS.append(kern)
    return kern


def launch_counts():
    """{kernel wrapper name: launches so far}, for every kernel."""
    return {f.__name__: f._counts[0] for f in _KERNELS}


def sm90_launch_counts():
    """{kernel wrapper name: launches on its Hopper route so far}."""
    return {f.__name__: f._counts[1] for f in _KERNELS}


def x3_launch_counts():
    """{kernel wrapper name: launches on its three-piece float32 route so
    far}."""
    return {f.__name__: f._counts[2] for f in _KERNELS}


def reset_launch_counts() -> None:
    for f in _KERNELS:
        f._counts[:] = [0, 0, 0]


@contextlib.contextmanager
def recording_launches(stream=None):
    """Within: the counts that kernel wrappers make on this thread, and on
    ``stream`` while it is capturing, go into the yielded dict ({name:
    (launches, sm90_launches, x3_launches)}) and leave the shared counts
    alone. A graph's capture launches nothing, so its wrappers' counts are
    recorded so, and every replay adds them (:func:`add_launch_counts`);
    counts made meanwhile on other threads and streams (an eager call, a
    replay) stay shared."""
    rec = {}
    outer = getattr(_CAPTURING, "record", None)
    key = stream.cuda_stream if stream is not None else None
    _CAPTURING.record = rec
    if key is not None:
        _STREAM_RECORDS[key] = rec
    try:
        yield rec
    finally:
        _CAPTURING.record = outer
        if key is not None:
            _STREAM_RECORDS.pop(key, None)
        for name in [n for n, c in rec.items() if not any(c)]:
            del rec[name]


_ADD_LOCK = threading.Lock()


def add_launch_counts(delta, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`recording_launches` record) to
    the wrappers' shared counts: a CUDA graph's replay launches what its
    capture recorded, though no wrapper runs."""
    with _ADD_LOCK:
        for f in _KERNELS:
            gained = delta.get(f.__name__)
            if gained:
                for i, g in enumerate(gained):
                    f._counts[i] += times * g


def pick_block(dim: int, preferred: int) -> int:
    """Largest power-of-two block <= preferred that divides dim (>=1)."""
    b = preferred
    while b > 1 and dim % b != 0:
        b //= 2
    return max(b, 1)


# the reference's row-kernel budget (VMEM_BLOCK_BUDGET): its row kernels
# (layer norm, softmax) take a shape only when a block of at least 8 rows
# of d float32 values fits 2 MB
_ROW_BLOCK_BUDGET = 2 * 1024 * 1024


def pick_row_block(n_rows: int, d: int, preferred: int = 512) -> int:
    """The reference's row-block rule (``ops/pallas/common.py``
    ``pick_row_block``), kept because it decides which shapes the row
    kernels take: 0 means the reference computes the row op inline. The
    CUDA kernels tile rows their own way and use no block size."""
    max_rows = (_ROW_BLOCK_BUDGET // (4 * max(d, 1))) // 8 * 8
    if max_rows < 8:
        return 0
    block = pick_block(n_rows, min(preferred, int(max_rows)))
    return block if block % 8 == 0 else 0


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel library, built on the first call (and found in
    ``build/torch_kernels/`` unchanged on later processes: ``load`` rebuilds
    only when a source or flag changed)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from torch.utils.cpp_extension import load
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(name="mxtpu_torch_kernels",
                        sources=[str(s) for s in SOURCES],
                        build_directory=str(BUILD_DIR),
                        extra_cuda_cflags=CUDA_FLAGS,
                        is_python_module=False, verbose=False)
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mxt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = _lib.mxt_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}: {msg})")


def current_stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


_SM_COUNTS = {}


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, queried once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _SM_COUNTS.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = n
    return n


_TICKETS = {}


def ticket_buffer(owner: str, t: torch.Tensor, stream: int, n: int):
    """(n,) int32 zeros for the last-block tickets of ``owner``'s kernels,
    one buffer per owner, device and stream (each launch leaves it zero).
    A CUDA graph keeps the buffer of the stream it was captured on, so two
    replays of such graphs must not overlap."""
    key = (owner, t.device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=t.device)
        _TICKETS[key] = buf
    return buf
