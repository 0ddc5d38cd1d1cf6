"""ctypes binding to ``libmxtpu.so``, the repository's native host runtime.

Counterpart of ``incubator_mxnet_tpu/_native.py``: RecordIO reader and
writer, record offsets, the JPEG/PNG codec, bilinear resize, the pooled
host allocator ``HostPool`` and the threaded image-record batch pipeline
``ImageRecordPipeline`` (sources under ``native/src``).

The port builds the same sources, unchanged, into a directory of its own
at first use::

    make -C native BUILD=<repo>/build/native_torch

and loads ``build/native_torch/libmxtpu.so`` from there; it never loads
``native/build/libmxtpu.so``. The build runs under an exclusive file lock
(``fcntl.flock`` on ``build/native_torch/.build.lock``), so processes that
reach their first use at once (test workers, decode workers) build once
and the others wait, then find ``make`` with nothing to do.

If the build or the load fails (no C++ toolchain, no ``jpeglib.h`` or
``png.h``, a library missing a symbol), :func:`available` returns False
and :func:`load_error` returns what went wrong (the tail of ``make``'s
output, or the loader's message); callers then take their pure-Python
routes, as the reference's do. ``MXTPU_NO_NATIVE=1`` turns the library
off without trying.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["lib", "available", "load_error", "build_seconds", "LIB_PATH",
           "BUILD_DIR", "check_call", "NativeRecordWriter",
           "NativeRecordReader", "list_record_offsets", "imdecode",
           "imencode_jpeg", "imresize", "HostPool", "ImageRecordPipeline"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libmxtpu.so")
_BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
lib = None
_error: Optional[str] = None
_build_s: Optional[float] = None


class MXTPipelineConfig(ctypes.Structure):
    _fields_ = [
        ("rec_path", ctypes.c_char_p),
        ("batch_size", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("label_width", ctypes.c_int),
        ("shuffle", ctypes.c_int),
        ("seed", ctypes.c_uint64),
        ("num_workers", ctypes.c_int),
        ("rand_crop", ctypes.c_int),
        ("rand_mirror", ctypes.c_int),
        ("resize_shorter", ctypes.c_int),
        ("mean", ctypes.c_float * 4),
        ("std_", ctypes.c_float * 4),
        ("scale", ctypes.c_float),
        ("ring_depth", ctypes.c_int),
        ("emit_uint8", ctypes.c_int),
    ]


def _build() -> None:
    """``make`` the library into :data:`BUILD_DIR` under the file lock;
    raises ``RuntimeError`` with the tail of the output on failure."""
    import fcntl
    if not os.path.isdir(_NATIVE_DIR):
        raise RuntimeError(f"no native sources at {_NATIVE_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"BUILD={BUILD_DIR}"],
                capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"make could not run: {e}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if r.returncode != 0 or not os.path.exists(LIB_PATH):
        tail = (r.stdout + r.stderr).strip().splitlines()[-12:]
        raise RuntimeError(f"make -C native BUILD={BUILD_DIR} failed "
                           f"(exit {r.returncode}): " + " | ".join(tail))


def _declare(l):
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    l.MXTGetLastError.restype = ctypes.c_char_p
    l.MXTRecordIOWriterCreate.argtypes = [ctypes.c_char_p, vpp]
    l.MXTRecordIOWriterWrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64]
    l.MXTRecordIOWriterTell.argtypes = [ctypes.c_void_p, u64p]
    l.MXTRecordIOWriterClose.argtypes = [ctypes.c_void_p]
    l.MXTRecordIOReaderCreate.argtypes = [ctypes.c_char_p, vpp]
    l.MXTRecordIOReaderRead.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), u64p]
    l.MXTRecordIOReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    l.MXTRecordIOReaderTell.argtypes = [ctypes.c_void_p, u64p]
    l.MXTRecordIOReaderClose.argtypes = [ctypes.c_void_p]
    l.MXTRecordIOListOffsets.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(u64p), u64p]
    l.MXTFreeU64.argtypes = [u64p]
    l.MXTImageDecode.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                 ctypes.POINTER(u8p), ip, ip, ip]
    l.MXTImageEncodeJPEG.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(u8p), u64p]
    l.MXTImageResizeBilinear.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, u8p, ctypes.c_int,
                                         ctypes.c_int]
    l.MXTFreeU8.argtypes = [u8p]
    l.MXTPoolCreate.argtypes = [ctypes.c_uint64, vpp]
    l.MXTPoolAlloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64, vpp]
    l.MXTPoolFree.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    l.MXTPoolStats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
    l.MXTPoolDestroy.argtypes = [ctypes.c_void_p]
    l.MXTPipelineCreate.argtypes = [ctypes.POINTER(MXTPipelineConfig), vpp]
    l.MXTPipelineNumSamples.argtypes = [ctypes.c_void_p, u64p]
    l.MXTPipelineNext.argtypes = [ctypes.c_void_p, f32p, f32p, ip, ip]
    l.MXTPipelineNextU8.argtypes = [ctypes.c_void_p, u8p, f32p, ip, ip]
    l.MXTPipelineReset.argtypes = [ctypes.c_void_p]
    l.MXTPipelineDestroy.argtypes = [ctypes.c_void_p]
    return l


def _load():
    """The library, built and loaded at the first call; None (and the
    error kept) when that failed."""
    global lib, _error, _build_s
    if lib is not None or _error is not None:
        return lib
    with _lock:
        if lib is not None or _error is not None:
            return lib
        if os.environ.get("MXTPU_NO_NATIVE", "0") == "1":
            _error = "turned off by MXTPU_NO_NATIVE=1"
            return None
        t0 = time.perf_counter()
        try:
            _build()
            lib = _declare(ctypes.CDLL(LIB_PATH))
        except (RuntimeError, OSError, AttributeError) as e:
            _error = f"{type(e).__name__}: {e}"
            lib = None
        _build_s = time.perf_counter() - t0
    return lib


def available() -> bool:
    """Whether ``libmxtpu.so`` built and loaded (built at the first call)."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is unavailable, or None when it loaded (or was not
    tried yet)."""
    return _error


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`available` call spent building and
    loading, None before it."""
    return _build_s


def check_call(ret: int) -> None:
    """(ref: python/mxnet/base.py check_call)"""
    if ret != 0:
        raise RuntimeError(lib.MXTGetLastError().decode("utf-8", "replace"))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRecordWriter:
    def __init__(self, path: str):
        self._h = ctypes.c_void_p()
        check_call(lib.MXTRecordIOWriterCreate(path.encode(),
                                               ctypes.byref(self._h)))

    def write(self, buf: bytes) -> None:
        check_call(lib.MXTRecordIOWriterWrite(self._h, buf, len(buf)))

    def tell(self) -> int:
        out = ctypes.c_uint64()
        check_call(lib.MXTRecordIOWriterTell(self._h, ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        if self._h:
            check_call(lib.MXTRecordIOWriterClose(self._h))
            self._h = ctypes.c_void_p()


class NativeRecordReader:
    def __init__(self, path: str):
        self._h = ctypes.c_void_p()
        check_call(lib.MXTRecordIOReaderCreate(path.encode(),
                                               ctypes.byref(self._h)))

    def read(self) -> Optional[bytes]:
        data = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_uint64()
        check_call(lib.MXTRecordIOReaderRead(self._h, ctypes.byref(data),
                                             ctypes.byref(size)))
        if not data:
            return None
        return ctypes.string_at(data, size.value)

    def seek(self, pos: int) -> None:
        check_call(lib.MXTRecordIOReaderSeek(self._h, pos))

    def tell(self) -> int:
        out = ctypes.c_uint64()
        check_call(lib.MXTRecordIOReaderTell(self._h, ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        if self._h:
            check_call(lib.MXTRecordIOReaderClose(self._h))
            self._h = ctypes.c_void_p()


def list_record_offsets(path: str) -> np.ndarray:
    arr = ctypes.POINTER(ctypes.c_uint64)()
    n = ctypes.c_uint64()
    check_call(lib.MXTRecordIOListOffsets(path.encode(), ctypes.byref(arr),
                                          ctypes.byref(n)))
    out = np.ctypeslib.as_array(arr, shape=(n.value,)).copy()
    lib.MXTFreeU64(arr)
    return out


def imdecode(buf: bytes, to_rgb: bool = True) -> np.ndarray:
    """Decode JPEG/PNG bytes to an HWC uint8 array (RGB with ``to_rgb``,
    else the file's own channels)."""
    src = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check_call(lib.MXTImageDecode(src, len(buf), 1 if to_rgb else 0,
                                  ctypes.byref(out), ctypes.byref(h),
                                  ctypes.byref(w), ctypes.byref(c)))
    arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, c.value)).copy()
    lib.MXTFreeU8(out)
    return arr


def imencode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """JPEG bytes of an HW or HWC (1 or 3 channels) uint8 image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    check_call(lib.MXTImageEncodeJPEG(_u8(img), h, w, c, quality,
                                      ctypes.byref(out), ctypes.byref(n)))
    res = ctypes.string_at(out, n.value)
    lib.MXTFreeU8(out)
    return res


def imresize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of an HW or HWC uint8 image (``native/src/image.cc``,
    the pipeline's own resize)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    sh, sw, c = img.shape
    dst = np.empty((h, w, c), dtype=np.uint8)
    check_call(lib.MXTImageResizeBilinear(_u8(img), sh, sw, c, _u8(dst), h, w))
    return dst[:, :, 0] if squeeze else dst


class HostPool:
    """Pooled host staging allocator (``native/src/pool.cc``)."""

    def __init__(self, reserve: int = 0):
        self._h = ctypes.c_void_p()
        check_call(lib.MXTPoolCreate(reserve, ctypes.byref(self._h)))

    def alloc(self, size: int) -> int:
        out = ctypes.c_void_p()
        check_call(lib.MXTPoolAlloc(self._h, size, ctypes.byref(out)))
        return out.value

    def free(self, ptr: int) -> None:
        check_call(lib.MXTPoolFree(self._h, ctypes.c_void_p(ptr)))

    def stats(self) -> dict:
        cached, in_use, total = (ctypes.c_uint64() for _ in range(3))
        check_call(lib.MXTPoolStats(self._h, ctypes.byref(cached),
                                    ctypes.byref(in_use), ctypes.byref(total)))
        return {"cached": cached.value, "in_use": in_use.value,
                "total": total.value}

    def destroy(self) -> None:
        if self._h:
            check_call(lib.MXTPoolDestroy(self._h))
            self._h = ctypes.c_void_p()


class ImageRecordPipeline:
    """Threaded native batch pipeline over a .rec file
    (``native/src/pipeline.cc``; ref src/io/iter_image_recordio_2.cc).
    Each sample's augmentation is seeded by (seed, sample, epoch), so a
    batch does not depend on the number of workers."""

    def __init__(self, rec_path, batch_size, data_shape, label_width=1,
                 shuffle=False, seed=0, num_workers=4, rand_crop=False,
                 rand_mirror=False, resize=0, mean=None, std=None, scale=1.0,
                 ring_depth=3, emit_uint8=False):
        c, h, w = data_shape
        cfg = MXTPipelineConfig()
        cfg.rec_path = rec_path.encode()
        cfg.batch_size = batch_size
        cfg.channels, cfg.height, cfg.width = c, h, w
        cfg.label_width = label_width
        cfg.shuffle = 1 if shuffle else 0
        cfg.seed = seed
        cfg.num_workers = num_workers
        cfg.rand_crop = 1 if rand_crop else 0
        cfg.rand_mirror = 1 if rand_mirror else 0
        cfg.resize_shorter = resize
        m = list(mean) if mean is not None else [0.0] * 4
        sd = list(std) if std is not None else [1.0] * 4
        for i in range(4):
            cfg.mean[i] = m[i] if i < len(m) else 0.0
            cfg.std_[i] = sd[i] if i < len(sd) else 1.0
        cfg.scale = scale
        cfg.ring_depth = ring_depth
        cfg.emit_uint8 = 1 if emit_uint8 else 0
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.emit_uint8 = emit_uint8
        self._h = ctypes.c_void_p()
        check_call(lib.MXTPipelineCreate(ctypes.byref(cfg),
                                         ctypes.byref(self._h)))
        n = ctypes.c_uint64()
        check_call(lib.MXTPipelineNumSamples(self._h, ctypes.byref(n)))
        self.num_samples = n.value

    def next_batch(self):
        """(data, label (N, label_width) float32, pad), or None at the end
        of the epoch. data is NCHW float32, or NHWC uint8 with
        ``emit_uint8`` (raw pixels, normalised on the device)."""
        c, h, w = self.data_shape
        label = np.empty((self.batch_size, self.label_width), np.float32)
        pad, eof = ctypes.c_int(), ctypes.c_int()
        if self.emit_uint8:
            data = np.empty((self.batch_size, h, w, c), np.uint8)
            check_call(lib.MXTPipelineNextU8(self._h, _u8(data), _f32(label),
                                             ctypes.byref(pad),
                                             ctypes.byref(eof)))
        else:
            data = np.empty((self.batch_size, c, h, w), np.float32)
            check_call(lib.MXTPipelineNext(self._h, _f32(data), _f32(label),
                                           ctypes.byref(pad),
                                           ctypes.byref(eof)))
        if eof.value:
            return None
        return data, label, pad.value

    def reset(self) -> None:
        check_call(lib.MXTPipelineReset(self._h))

    def close(self) -> None:
        if self._h:
            check_call(lib.MXTPipelineDestroy(self._h))
            self._h = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
