"""RecordIO: the record-packed binary dataset format.

Counterpart of ``incubator_mxnet_tpu/recordio.py`` (ref:
python/mxnet/recordio.py — MXRecordIO, MXIndexedRecordIO, IRHeader,
pack/unpack, pack_img/unpack_img). The on-disk framing is the
reference's: magic word ``0xced7230a``, a length word whose upper 3 bits
mark multi-part continuation, 4-byte alignment padding; files written by
either package read in the other.

Reading and writing go through the native library (``_native``) when it
built, else through Python file objects, with the same bytes on disk.
``pack_img`` / ``unpack_img`` encode and decode with the native codec
(JPEG encode, JPEG and PNG decode) and take PIL only where the native
library is unavailable or the format is one it lacks (PNG encode, other
image formats), as ``image.imdecode`` does.
"""
from __future__ import annotations

import io as _io
import logging
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as _np

_LOG = logging.getLogger(__name__)

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "RecordIO", "IndexedRecordIO",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29
_LFLAG_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential record reader/writer (ref: recordio.py:MXRecordIO).

    A read-only open salvages a torn tail: a partial final record (a
    killed writer's torn write, even one cutting the magic word) ends the
    stream after every intact record, with one warning naming its byte
    offset. ``MXTPU_IO_TOLERATE_TAIL=0`` makes it an error. Invalid magic
    mid-file is corruption and always raises an ``IOError`` that carries
    ``mxtpu_uri`` and ``mxtpu_offset``."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        from . import _native
        self._native_h = None
        self._tol_tail = (self.flag == "r" and os.environ.get(
            "MXTPU_IO_TOLERATE_TAIL", "1") == "1")
        self._tail_warned = False
        if self.flag not in ("w", "r"):
            raise ValueError("Invalid flag %s" % self.flag)
        self.writable = self.flag == "w"
        if _native.available():
            cls = (_native.NativeRecordWriter if self.writable
                   else _native.NativeRecordReader)
            self._native_h = cls(self.uri)
            self.handle = None
        else:
            self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._native_h is not None:
                self._native_h.close()
                self._native_h = None
            else:
                self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["_native_h"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if not self.is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        if self._native_h is not None:
            return self._native_h.tell()
        return self.handle.tell()

    def write(self, buf: bytes):
        """Write one record (ref: recordio.py write). A payload holding the
        magic word at a 4-byte-aligned offset is split into continuation
        parts, as dmlc's writer does."""
        assert self.writable
        buf = bytes(buf)
        if self._native_h is not None:
            self._native_h.write(buf)
            return
        magic_bytes = struct.pack("<I", _MAGIC)
        n = len(buf)
        part_start = 0
        split = False
        limit = n & ~3
        i = buf.find(magic_bytes)
        while i != -1 and i + 4 <= limit:
            if i % 4 == 0:
                cflag = 2 if split else 1
                self.handle.write(struct.pack(
                    "<II", _MAGIC, (cflag << _LFLAG_BITS) | (i - part_start)))
                self.handle.write(buf[part_start:i])
                part_start = i + 4
                split = True
                i = buf.find(magic_bytes, i + 4)
            else:
                i = buf.find(magic_bytes, i + 1)
        cflag = 3 if split else 0
        tail = n - part_start
        self.handle.write(struct.pack("<II", _MAGIC,
                                      (cflag << _LFLAG_BITS) | tail))
        self.handle.write(buf[part_start:])
        pad = (-tail) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        """Read one record, joining continuation parts (ref: recordio.py
        read); None at the end of the file."""
        assert not self.writable
        if self._native_h is not None:
            start = self._native_h.tell()
            try:
                return self._native_h.read()
            except RuntimeError as e:
                if self._tol_tail and "truncated RecordIO" in str(e):
                    self._torn_tail(start)
                    return None
                self._corrupt(str(e), offset=start, cause=e)
        start = self.handle.tell()
        parts = []
        while True:
            header = self.handle.read(8)
            if len(header) == 0 and not parts:
                return None
            if len(header) < 8:
                if self._tol_tail:
                    self._torn_tail(start)
                    return None
                self._corrupt("truncated header", offset=start)
            magic, lword = struct.unpack("<II", header)
            if magic != _MAGIC:
                self._corrupt(f"invalid magic {magic:#x}", offset=start)
            cflag = lword >> _LFLAG_BITS
            length = lword & _LFLAG_MASK
            buf = self.handle.read(length)
            if len(buf) < length:
                if self._tol_tail:
                    self._torn_tail(start)
                    return None
                self._corrupt("truncated payload", offset=start)
            pad = (-length) % 4
            if pad:
                self.handle.read(pad)
            parts.append(buf)
            if cflag in (0, 3):
                break
            parts.append(struct.pack("<I", _MAGIC))
        return b"".join(parts)

    def _torn_tail(self, offset: int):
        if not self._tail_warned:
            self._tail_warned = True
            _LOG.warning(
                "RecordIO %s: torn final record at byte %d (partial "
                "write by a killed writer?) — salvaged all intact "
                "records before it. Set MXTPU_IO_TOLERATE_TAIL=0 to "
                "make this an error.", self.uri, offset)

    def _corrupt(self, why: str, offset: Optional[int] = None, cause=None):
        err = IOError(f"corrupt RecordIO file {self.uri}: {why}"
                      + (f" @ byte {offset}" if offset is not None else ""))
        err.mxtpu_uri = self.uri
        err.mxtpu_offset = offset
        raise err from cause


class MXIndexedRecordIO(MXRecordIO):
    """Record file with a ``.idx`` side file for random access
    (ref: recordio.py:MXIndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        if self._native_h is not None:
            self._native_h.seek(self.idx[idx])
        else:
            self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


RecordIO = MXRecordIO
IndexedRecordIO = MXIndexedRecordIO


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """(ref: recordio.py pack) header + payload; several labels set
    ``flag`` to their count and go before the payload."""
    header = IRHeader(*header)
    if isinstance(header.label, (tuple, list, _np.ndarray)):
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s: bytes):
    """(ref: recordio.py unpack)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _pil_encode(arr: _np.ndarray, quality: int, fmt: str) -> bytes:
    from PIL import Image
    im = Image.fromarray(arr)
    if fmt == "JPEG" and im.mode not in ("RGB", "L"):
        im = im.convert("RGB")
    buf = _io.BytesIO()
    im.save(buf, format=fmt, quality=quality)
    return buf.getvalue()


def pack_img(header: IRHeader, img: _np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """(ref: recordio.py pack_img) The header and the image encoded as JPEG
    (``.jpg``/``.jpeg``, by the native codec) or PNG (by PIL)."""
    from . import _native
    arr = _np.asarray(img)
    if arr.dtype != _np.uint8:
        arr = _np.clip(arr, 0, 255).astype(_np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    jpeg = img_fmt.lower() in (".jpg", ".jpeg")
    if jpeg and (arr.ndim == 2 or arr.shape[2] == 3) and _native.available():
        return pack(header, _native.imencode_jpeg(arr, quality))
    return pack(header, _pil_encode(arr, quality, "JPEG" if jpeg else "PNG"))


def _to_gray(rgb: _np.ndarray) -> _np.ndarray:
    """PIL's RGB -> L conversion (ITU-R 601-2 luma, its fixed-point
    rounding), so ``iscolor=0`` gives the reference's pixels."""
    r, g, b = (rgb[..., i].astype(_np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        _np.uint8)


def _decode(img_bytes: bytes, iscolor: int) -> _np.ndarray:
    """HWC (or HW for one channel) uint8 pixels, as PIL's ``asarray``
    gives them after the reference's conversions: ``iscolor`` 1 RGB, 0
    gray, -1 the file's own channels."""
    from . import _native
    if _native.available():
        try:
            arr = _native.imdecode(bytes(img_bytes), to_rgb=iscolor != -1)
        except RuntimeError:
            arr = None          # a format the native codec lacks
        if arr is not None:
            if iscolor == 0:
                return _to_gray(arr)
            return arr[:, :, 0] if arr.shape[2] == 1 else arr
    from PIL import Image
    im = Image.open(_io.BytesIO(bytes(img_bytes)))
    if iscolor == 0:
        im = im.convert("L")
    elif im.mode != "RGB" and iscolor == 1:
        im = im.convert("RGB")
    return _np.asarray(im)


def unpack_img(s: bytes, iscolor: int = 1):
    """(ref: recordio.py unpack_img) (header, HWC uint8 image)."""
    header, img_bytes = unpack(s)
    return header, _decode(img_bytes, iscolor)
