"""NVRTC and the CUDA driver API through ctypes: a user's CUDA C++ source
compiled at runtime to a CUBIN for the card, loaded as a module, and its
kernels launched on PyTorch's current stream.

This is the launcher behind ``rtc.CudaModule`` (MXNet's
``python/mxnet/rtc.py``, ``src/common/rtc.cc``), the counterpart of the
JAX package's runtime kernel path (``rtc.py`` ``_Kernel.__call__``, which
reaches ``pl.pallas_call``, and ``PallasModule``). It is not a fixed
kernel: what it launches is the user's, and what bounds it is the user's
kernel; the launcher adds host time only (argument packing and one
``cuLaunchKernel``).

* **Compile.** ``nvrtcCreateProgram``, one ``nvrtcAddNameExpression`` per
  export (so a kernel need not be ``extern "C"``; a template instance such
  as ``"fwd<float>"`` works), ``nvrtcCompileProgram`` for the card's own
  architecture (``sm_90a`` on an H100) with the CUDA headers on the
  include path, then ``nvrtcGetCUBIN``: a CUBIN, never PTX, since PTX from
  an NVRTC newer than the driver does not load. A failed compile raises
  :class:`NvrtcCompileError` carrying NVRTC's log.
* **Load.** ``cuModuleLoadData`` per device, in the device's primary
  context (PyTorch's), then ``cuModuleGetFunction`` by lowered name.
* **Launch.** ``cuLaunchKernel`` on the stream it is given, never
  synchronising. PyTorch runs a backward on its own device thread, where
  no context may be current: the device's primary context is then made
  current (retained, never created). Dynamic shared memory above 48 KB is
  first allowed with ``cuFuncSetAttribute``. A refused launch raises
  :class:`CudaDriverError` with ``cuGetErrorString``'s text; a fault in the
  kernel shows at the next synchronise.

NVRTC is looked for under ``$CUDA_HOME/lib64``, ``/usr/local/cuda/lib64``,
the ``nvidia/cuda_nvrtc/lib`` wheel beside PyTorch and PyTorch's own
``lib``, then by soname; its ``libnvrtc-builtins`` is loaded from the same
directory first, because NVRTC opens it by soname. Nothing is loaded when
this module is imported, and nothing falls back: without a card, NVRTC or
the driver, the caller gets an error.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from .common import counted_kernel

__all__ = ["NvrtcNotFoundError", "NvrtcCompileError", "CudaDriverError",
           "nvrtc_search_dirs", "nvrtc_version", "driver_version",
           "card_arch", "compile_cubin", "load_module", "unload_module",
           "get_function", "rtc_launch", "MAX_STATIC_SHARED"]

MAX_STATIC_SHARED = 48 * 1024   # dynamic shared memory above needs opt-in
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_SONAMES = ("libnvrtc.so.12", "libnvrtc.so")   # tried after the directories
_P = ctypes.c_void_p
_lock = threading.Lock()
_nvrtc_lib = None
_nvrtc_path = None
_driver_lib = None
_primary: Dict[int, int] = {}   # device ordinal -> retained primary context


class NvrtcNotFoundError(RuntimeError):
    """No NVRTC library could be loaded; the message lists where it was
    looked for."""


class NvrtcCompileError(RuntimeError):
    """NVRTC refused the source; the message carries its log."""


class CudaDriverError(RuntimeError):
    """A CUDA driver API call failed; the message carries its error
    string."""


# ---------------------------------------------------------------- NVRTC
def nvrtc_search_dirs() -> List[Path]:
    """Directories searched for ``libnvrtc.so*``, in order."""
    dirs = [Path(os.environ[v]) / "lib64" for v in ("CUDA_HOME", "CUDA_PATH")
            if os.environ.get(v)]
    dirs.append(Path("/usr/local/cuda/lib64"))
    dirs += [Path(p) / "nvidia" / "cuda_nvrtc" / "lib" for p in sys.path
             if p and Path(p, "nvidia").is_dir()]
    dirs.append(Path(torch.__file__).resolve().parent / "lib")
    seen, out = set(), []
    for d in dirs:
        if d not in seen:
            seen.add(d)
            out.append(d)
    return out


def _nvrtc_candidates(d: Path) -> List[Path]:
    libs = [p for p in d.glob("libnvrtc*.so*")
            if "builtins" not in p.name and "alt" not in p.name]
    return sorted(libs, key=lambda p: (len(p.name), p.name))


def _open_nvrtc(path: Path) -> ctypes.CDLL:
    builtins = sorted(path.parent.glob("libnvrtc-builtins*.so*"),
                      key=lambda p: (len(p.name), p.name))
    if builtins:
        ctypes.CDLL(str(builtins[0]), mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)


def _nvrtc() -> ctypes.CDLL:
    global _nvrtc_lib, _nvrtc_path
    with _lock:
        if _nvrtc_lib is not None:
            return _nvrtc_lib
        tried = []
        lib = None
        for d in nvrtc_search_dirs():
            for cand in _nvrtc_candidates(d) if d.is_dir() else []:
                try:
                    lib, _nvrtc_path = _open_nvrtc(cand), cand
                    break
                except OSError as e:
                    tried.append(f"{cand} ({e})")
            else:
                tried.append(str(d))
                continue
            break
        if lib is None:
            for soname in _SONAMES:
                try:
                    lib, _nvrtc_path = ctypes.CDLL(soname), Path(soname)
                    break
                except OSError:
                    tried.append(soname)
        if lib is None:
            raise NvrtcNotFoundError(
                "rtc: no NVRTC library (libnvrtc.so*) found; searched "
                + ", ".join(tried)
                + ". Install the CUDA toolkit or set CUDA_HOME.")
        for fn, args in {
                "nvrtcVersion": [_P, _P],
                "nvrtcCreateProgram": [_P, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int, _P, _P],
                "nvrtcAddNameExpression": [_P, ctypes.c_char_p],
                "nvrtcCompileProgram": [_P, ctypes.c_int, _P],
                "nvrtcGetProgramLogSize": [_P, _P],
                "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
                "nvrtcGetCUBINSize": [_P, _P],
                "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
                "nvrtcGetLoweredName": [_P, ctypes.c_char_p, _P],
                "nvrtcDestroyProgram": [_P]}.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _nvrtc_lib = lib
        return lib


def _nvrtc_check(code: int, what: str) -> None:
    if code != 0:
        msg = _nvrtc().nvrtcGetErrorString(code).decode()
        raise NvrtcCompileError(f"rtc: {what} failed ({code}: {msg})")


def nvrtc_version() -> Tuple[int, int, str]:
    """(major, minor, path) of the NVRTC library in use."""
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)),
                 "nvrtcVersion")
    return major.value, minor.value, str(_nvrtc_path)


def _include_dirs() -> List[str]:
    """CUDA header directories (``cuda_fp16.h`` and kin) that exist."""
    lib_dir = _nvrtc_path.parent if _nvrtc_path is not None else None
    cands = [Path(os.environ[v]) / "include" for v in ("CUDA_HOME",
                                                       "CUDA_PATH")
             if os.environ.get(v)]
    if lib_dir is not None:
        cands += [lib_dir.parent / "include",
                  lib_dir.parent.parent / "cuda_runtime" / "include"]
    cands.append(Path("/usr/local/cuda/include"))
    out = []
    for c in cands:
        if (c / "cuda_fp16.h").is_file() and str(c) not in out:
            out.append(str(c))
    return out


def card_arch(device: torch.device) -> str:
    """The card's real architecture for NVRTC: ``sm_90a`` on an H100 (the
    ``a`` target, which the architecture-specific instructions need)."""
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}{'a' if major >= 9 else ''}"


def compile_cubin(source: str, name_expressions: Sequence[str],
                  options: Sequence[str], arch: str
                  ) -> Tuple[bytes, Dict[str, str], str]:
    """Compile ``source`` with NVRTC for ``arch``: (CUBIN, {name expression:
    lowered name}, compile log). The user's ``options`` come after the
    defaults; an ``--gpu-architecture``/``-arch`` among them replaces
    ``arch``."""
    lib = _nvrtc()
    opts = list(options)
    if not any(o.startswith(("--gpu-architecture", "-arch")) for o in opts):
        opts.insert(0, f"--gpu-architecture={arch}")
    opts = [f"-I{d}" for d in _include_dirs()] + opts
    prog = ctypes.c_void_p()
    _nvrtc_check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        b"rtc.cu", 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for name in name_expressions:
            _nvrtc_check(lib.nvrtcAddNameExpression(prog, name.encode()),
                         f"nvrtcAddNameExpression({name!r})")
        raw = [o.encode() for o in opts]
        arr = (ctypes.c_char_p * len(raw))(*raw)
        code = lib.nvrtcCompileProgram(prog, len(raw), arr)
        size = ctypes.c_size_t()
        _nvrtc_check(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        if code != 0:
            msg = lib.nvrtcGetErrorString(code).decode()
            raise NvrtcCompileError(
                f"rtc: NVRTC could not compile the source ({msg}); options "
                f"{opts}; log:\n{log}")
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in name_expressions:
            low = ctypes.c_char_p()
            _nvrtc_check(lib.nvrtcGetLoweredName(prog, name.encode(),
                                                 ctypes.byref(low)),
                         f"nvrtcGetLoweredName({name!r})")
            lowered[name] = low.value.decode()
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    return cubin.raw, lowered, log


# ----------------------------------------------------------- the driver
def _driver() -> ctypes.CDLL:
    global _driver_lib
    with _lock:
        if _driver_lib is not None:
            return _driver_lib
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise CudaDriverError(f"rtc: the CUDA driver (libcuda.so.1) "
                                  f"could not be loaded: {e}") from None
        U = ctypes.c_uint
        for fn, args in {
                "cuInit": [U], "cuDriverGetVersion": [_P],
                "cuDeviceGet": [_P, ctypes.c_int],
                "cuDevicePrimaryCtxRetain": [_P, ctypes.c_int],
                "cuCtxGetCurrent": [_P], "cuCtxSetCurrent": [_P],
                "cuCtxPushCurrent_v2": [_P], "cuCtxPopCurrent_v2": [_P],
                "cuModuleLoadData": [_P, ctypes.c_char_p],
                "cuModuleGetFunction": [_P, _P, ctypes.c_char_p],
                "cuModuleUnload": [_P],
                "cuFuncSetAttribute": [_P, ctypes.c_int, ctypes.c_int],
                "cuLaunchKernel": [_P, U, U, U, U, U, U, U, _P, _P, _P],
                "cuGetErrorString": [ctypes.c_int, _P]}.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _driver_lib = lib
        _check(lib.cuInit(0), "cuInit")
        return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        s = ctypes.c_char_p()
        _driver_lib.cuGetErrorString(code, ctypes.byref(s))
        text = s.value.decode() if s.value else "unknown error"
        raise CudaDriverError(f"rtc: {what} failed (CUDA error {code}: "
                              f"{text})")


def driver_version() -> int:
    """The driver's CUDA version, e.g. 12080."""
    v = ctypes.c_int()
    _check(_driver().cuDriverGetVersion(ctypes.byref(v)),
           "cuDriverGetVersion")
    return v.value


def _primary_context(ordinal: int) -> int:
    lib = _driver()
    with _lock:
        if ordinal not in _primary:
            dev, ctx = ctypes.c_int(), ctypes.c_void_p()
            _check(lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                   "cuDeviceGet")
            _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                   "cuDevicePrimaryCtxRetain")
            _primary[ordinal] = ctx.value
        return _primary[ordinal]


@contextlib.contextmanager
def _in_context(ordinal: int):
    """Run driver calls in card ``ordinal``'s primary context: as is when it
    is current, made current when none is (a backward's device thread),
    pushed and popped when another card's is."""
    lib = _driver()
    primary = _primary_context(ordinal)
    cur = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value == primary:
        yield
    elif cur.value is None:
        _check(lib.cuCtxSetCurrent(primary), "cuCtxSetCurrent")
        yield
    else:
        _check(lib.cuCtxPushCurrent_v2(primary), "cuCtxPushCurrent")
        try:
            yield
        finally:
            _check(lib.cuCtxPopCurrent_v2(ctypes.byref(cur)),
                   "cuCtxPopCurrent")


def load_module(cubin: bytes, ordinal: int) -> int:
    """Load a CUBIN into card ``ordinal``'s primary context: the CUmodule."""
    lib = _driver()
    mod = ctypes.c_void_p()
    with _in_context(ordinal):
        _check(lib.cuModuleLoadData(ctypes.byref(mod), cubin),
               "cuModuleLoadData")
    return mod.value


def unload_module(module: int, ordinal: int) -> None:
    lib = _driver()
    with _in_context(ordinal):
        _check(lib.cuModuleUnload(module), "cuModuleUnload")


def get_function(module: int, lowered_name: str, ordinal: int) -> int:
    """The CUfunction of ``lowered_name`` in a loaded module."""
    lib = _driver()
    fn = ctypes.c_void_p()
    with _in_context(ordinal):
        _check(lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                       lowered_name.encode()),
               f"cuModuleGetFunction({lowered_name!r})")
    return fn.value


@counted_kernel
def rtc_launch(function: int, ordinal: int, grid: Tuple[int, int, int],
               block: Tuple[int, int, int], shared_mem: int, stream: int,
               params) -> None:
    """``cuLaunchKernel`` of a user kernel on card ``ordinal``'s ``stream``;
    ``params`` is the ``void*[]`` of pointers to each argument's storage,
    kept alive by the caller. Counts every user kernel's launch."""
    lib = _driver()
    with _in_context(ordinal):
        if shared_mem > MAX_STATIC_SHARED:
            _check(lib.cuFuncSetAttribute(
                function, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                shared_mem), "cuFuncSetAttribute(max dynamic shared)")
        _check(lib.cuLaunchKernel(function, *grid, *block, shared_mem,
                                  stream, params, None), "cuLaunchKernel")
    rtc_launch.launches += 1
