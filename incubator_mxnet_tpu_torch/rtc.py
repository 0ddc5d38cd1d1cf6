"""Runtime kernel compilation: a user's CUDA C++ source compiled with NVRTC
and launched on NDArrays.

Counterpart of ``incubator_mxnet_tpu/rtc.py``, with MXNet's API
(``python/mxnet/rtc.py``): the reference compiles Pallas source in a
namespace of its own (``PallasModule``) and names it ``CudaModule`` too;
here ``CudaModule`` is MXNet's, and ``PallasModule`` raises. Example::

    src = r'''
    __global__ void axpy(const float *x, const float *y, float *out, int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) out[i] = 2.0f * x[i] + y[i];
    }
    '''
    mod = rtc.CudaModule(src, exports=["axpy"])
    k = mod.get_kernel("axpy", "const float *x, const float *y, "
                       "float *out, int n")
    k.launch([x, y, out, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
             (256, 1, 1))
    # or the reference's call form: allocate the output, launch, return it
    axpy = mod.get_kernel("axpy", "const float *x, const float *y, "
                          "float *out, int n", out_like=0,
                          grid_dims=lambda x, y, n: ((n + 255) // 256,),
                          block_dims=(256,))
    z = axpy(x, y, n)

* ``CudaModule(source, options=(), exports=())`` compiles at once, for
  the card's architecture (``sm_90a`` on an H100), to a CUBIN; each
  export is a name expression (``"axpy"``, ``"fwd<float>"``), so kernels
  need not be ``extern "C"``. Without a card it raises
  ``NoCudaDeviceError``; a compile error carries NVRTC's log.
* ``get_kernel(name, signature)`` parses MXNet's C signature (``float``,
  ``double``, ``__half``, ``uint8_t``, ``int``/``int32_t``,
  ``int8_t``/``char``, ``int64_t``; a pointer is an NDArray argument,
  ``const`` marks one the kernel only reads).
* ``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  checks the arguments' count, each array's type and device, and that
  each scalar is a number, then launches on PyTorch's current stream and
  returns without synchronising. The kernel writes the arrays' buffers in
  place, as MXNet's does (a view of a written array sees the write), so a
  written array must be contiguous; an array it only reads is made
  contiguous when it is not.
* The call form (``out_like``/``out_shape``/``out_dtype``, ``grid_dims``,
  ``block_dims``) gives a callable over every argument but the one
  non-``const`` pointer, which it allocates (uninitialised: the kernel
  writes it all) and returns. Its result takes no gradient.

Every launch is counted by ``ops.cuda.nvrtc.rtc_launch`` (in
``ops.cuda.launch_counts()``) and by its ``CudaKernel.launches``.
"""
from __future__ import annotations

import ctypes
import numbers
import re
import sys
import time
from typing import NamedTuple, Optional, Sequence

import numpy as _np
import torch

from .context import Context, resolve_device
from .ndarray.ndarray import NDArray, _wrap, to_torch_dtype
from .ops.cuda import nvrtc as _nvrtc

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature",
           "pack_arguments"]

# MXNet's C type map (python/mxnet/rtc.py _DTYPE_CPP_TO_NP)
_CPP_TYPES = {"float": _np.float32, "double": _np.float64,
              "__half": _np.float16, "uint8_t": _np.uint8, "int": _np.int32,
              "int32_t": _np.int32, "int8_t": _np.int8, "char": _np.int8,
              "int64_t": _np.int64}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


class ArgSpec(NamedTuple):
    """One kernel argument: ``is_ndarray`` for a pointer, ``is_const`` when
    the kernel only reads it, its numpy type and its (optional) name."""
    is_const: bool
    is_ndarray: bool
    dtype: _np.dtype
    name: str


def parse_signature(signature: str) -> list:
    """MXNet's C signature string, e.g. ``"const float *x, float *y, int
    n"``, as a list of :class:`ArgSpec`. Raises ``ValueError`` for a
    malformed argument and ``TypeError`` for a type outside the map."""
    specs = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(f"Invalid function prototype {arg!r}. Must be "
                             "in the form of '(const) type (*) (name)'")
        if m.group(2) not in _CPP_TYPES:
            raise TypeError(f"Unsupported kernel argument type {arg!r}. "
                            f"Supported types are: {', '.join(_CPP_TYPES)}.")
        specs.append(ArgSpec(bool(m.group(1)), bool(m.group(3)),
                             _np.dtype(_CPP_TYPES[m.group(2)]),
                             m.group(4) or ""))
    return specs


def _dims(dims, what: str) -> tuple:
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise ValueError(f"{what} must be 1 to 3 positive integers, got "
                         f"{dims}")
    return dims + (1,) * (3 - len(dims))


def pack_arguments(specs, args, device: torch.device, kernel: str = ""):
    """Check ``args`` against ``specs`` for a launch on ``device`` and pack
    them: (the ``void*[]`` of pointers to each argument's value, the
    objects those values live in, to be kept alive through the launch).
    A pointer's value is the array's device address; a scalar's is a
    numpy scalar of exactly its C type's width."""
    if len(args) != len(specs):
        raise ValueError(f"CudaKernel({kernel}) expects {len(specs)} "
                         f"arguments but got {len(args)}")
    values, tensors = [], []
    for i, (arg, spec) in enumerate(zip(args, specs)):
        if spec.is_ndarray:
            if not isinstance(arg, NDArray):
                raise TypeError(f"CudaKernel({kernel}): argument {i} is "
                                f"expected to be an NDArray, got "
                                f"{type(arg).__name__}")
            if arg.dtype != spec.dtype:
                raise TypeError(f"CudaKernel({kernel}): argument {i} is "
                                f"expected to be {spec.dtype}, got "
                                f"{arg.dtype}")
            t = arg._data
            if t.device != device:
                raise ValueError(f"CudaKernel({kernel}): argument {i} is on "
                                 f"{arg.context}, the launch on "
                                 f"{Context.from_torch(device)}")
            if not t.is_contiguous():
                if not spec.is_const:
                    raise ValueError(
                        f"CudaKernel({kernel}): argument {i} is written by "
                        "the kernel and is not contiguous")
                t = t.contiguous()
            tensors.append(t)
            values.append(ctypes.c_void_p(t.data_ptr()))
        else:
            if isinstance(arg, (bool, _np.bool_)) or not isinstance(
                    arg, (numbers.Real, _np.number)):
                raise TypeError(f"CudaKernel({kernel}): argument {i} is "
                                f"expected to be a number, got "
                                f"{type(arg).__name__}")
            if spec.dtype.kind in "iu" and not float(arg).is_integer():
                raise TypeError(f"CudaKernel({kernel}): argument {i} is an "
                                f"integer ({spec.dtype}), got {arg!r}")
            values.append(_np.array(arg, dtype=spec.dtype))
    ptrs = [ctypes.c_void_p(v.ctypes.data) if isinstance(v, _np.ndarray)
            else ctypes.c_void_p(ctypes.addressof(v)) for v in values]
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (values, tensors)


def _card(ctx) -> torch.device:
    """The CUDA device of a launch context (``mx.gpu(i)``)."""
    if not isinstance(ctx, Context) or ctx.device_type != "gpu":
        raise ValueError(f"a CUDA kernel is launched on a GPU context, got "
                         f"{ctx}")
    return ctx.torch_device


class CudaModule:
    """CUDA C++ source compiled with NVRTC for the card (ref:
    python/mxnet/rtc.py CudaModule). ``compile_ms`` is the NVRTC time."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._exports = tuple(exports)
        self._modules = {}          # device ordinal -> CUmodule
        self._functions = {}        # (ordinal, export) -> CUfunction
        dev = resolve_device("cuda")
        t0 = time.perf_counter()
        self._cubin, self._lowered, self.log = _nvrtc.compile_cubin(
            source, self._exports, tuple(options), _nvrtc.card_arch(dev))
        self.compile_ms = (time.perf_counter() - t0) * 1e3

    def get_kernel(self, name: str, signature: str,
                   out_like: Optional[int] = None, out_shape=None,
                   out_dtype="float32", grid_dims=None, block_dims=None,
                   shared_mem: int = 0):
        """The :class:`CudaKernel` of export ``name`` with its C
        ``signature``; with any of the call-form arguments, a callable that
        allocates the output and launches (see the module's docstring)."""
        if name not in self._exports:
            raise ValueError(f"kernel {name!r} is not among the module's "
                             f"exports {list(self._exports)}")
        kernel = CudaKernel(self, name, signature)
        if out_like is None and out_shape is None and grid_dims is None \
                and block_dims is None:
            return kernel
        return _CallForm(kernel, out_like, out_shape, out_dtype, grid_dims,
                         block_dims, shared_mem)

    def _function(self, ordinal: int, name: str) -> int:
        key = (ordinal, name)
        if key not in self._functions:
            if ordinal not in self._modules:
                self._modules[ordinal] = _nvrtc.load_module(self._cubin,
                                                            ordinal)
            self._functions[key] = _nvrtc.get_function(
                self._modules[ordinal], self._lowered[name], ordinal)
        return self._functions[key]

    def __del__(self):
        if sys.is_finalizing():     # the driver may be torn down already
            return
        for ordinal, module in self._modules.items():
            _nvrtc.unload_module(module, ordinal)


class CudaKernel:
    """One kernel of a :class:`CudaModule` (ref: python/mxnet/rtc.py
    CudaKernel). ``launches`` counts its launches."""

    def __init__(self, module: CudaModule, name: str, signature: str):
        self._module = module
        self.name = name
        self.signature = parse_signature(signature)
        self.launches = 0

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem: int = 0
               ) -> None:
        """Launch on ``ctx`` (``mx.gpu(i)``) with ``grid_dims`` and
        ``block_dims`` (up to three each) and ``shared_mem`` bytes of
        dynamic shared memory, on PyTorch's current stream."""
        dev = _card(ctx)
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                           "block_dims")
        # `storage` keeps what `params` points at alive through the launch
        params, storage = pack_arguments(self.signature, list(args), dev,
                                         self.name)
        fn = self._module._function(dev.index, self.name)
        _nvrtc.rtc_launch(fn, dev.index, grid, block, int(shared_mem),
                          torch.cuda.current_stream(dev).cuda_stream, params)
        self.launches += 1


class _CallForm:
    """The reference's call form: ``kernel(*args)`` with the output slot
    filled by a new array, which is returned."""

    def __init__(self, kernel: CudaKernel, out_like, out_shape, out_dtype,
                 grid_dims, block_dims, shared_mem):
        outs = [i for i, s in enumerate(kernel.signature)
                if s.is_ndarray and not s.is_const]
        if len(outs) != 1:
            raise ValueError(f"the call form needs exactly one non-const "
                             f"pointer in the signature, got {len(outs)}")
        if out_like is None and out_shape is None:
            raise ValueError("need out_like or out_shape")
        if grid_dims is None or block_dims is None:
            raise ValueError("the call form needs grid_dims and block_dims")
        self.kernel = kernel
        self._slot = outs[0]
        self._out_like, self._out_shape = out_like, out_shape
        self._out_dtype = out_dtype
        self._grid, self._block = grid_dims, block_dims
        self._shared = shared_mem

    def __call__(self, *args):
        args = list(args)
        arrays = [a for a in args if isinstance(a, NDArray)]
        if not arrays:
            raise ValueError("the call form needs at least one NDArray "
                             "argument")
        if self._out_like is not None:
            ref = args[self._out_like]
            shape, dtype = ref.shape, ref._data.dtype
        else:
            shape, dtype = tuple(self._out_shape), to_torch_dtype(
                self._out_dtype)
        dev = arrays[0]._data.device
        out = _wrap(torch.empty(shape, dtype=dtype, device=dev))
        full = args[:self._slot] + [out] + args[self._slot:]
        grid = self._grid(*args) if callable(self._grid) else self._grid
        block = self._block(*args) if callable(self._block) else self._block
        self.kernel.launch(full, Context.from_torch(dev), grid, block,
                           self._shared)
        return out


class PallasModule:
    """The JAX package's Pallas source module: not available in the port,
    whose runtime kernels are CUDA C++ (:class:`CudaModule`)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "rtc.PallasModule compiles Pallas source, which runs only in "
            "the JAX package's rtc module; the port compiles "
            "CUDA C++ with rtc.CudaModule(source, options, exports)")
