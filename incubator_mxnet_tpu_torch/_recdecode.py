"""Standalone decode worker behind ``ImageRecordIter(preprocess_procs=N)``
when the native library is unavailable.

Counterpart of ``incubator_mxnet_tpu/_recdecode.py``. Runs as a script
(``python _recdecode.py``): reads a JSON config line on stdin, then task
lines ``slot:idx,idx,...``; decodes (PIL) and augments each record into
the named shared-memory slot as uint8 HWC and replies ``slot:count:nskip``
on stdout (nskip: corrupt records skipped and back-filled). Plain
subprocesses and pipes, not ``multiprocessing``: spawn re-imports the
parent's ``__main__``, and fork would copy the parent's CUDA context. The
parent sets ``CUDA_VISIBLE_DEVICES=""``, and the worker imports no module
of the package (the chaos module only when an ``io.*`` point is armed).

(ref: python/mxnet/gluon/data/dataloader.py:26-104, the same role over a
subprocess transport.)
"""
from __future__ import annotations

# FIRST, before any stdlib import that is not interpreter-preloaded:
# running as a script puts THIS package directory at sys.path[0], where
# operator.py / random.py / io.py shadow the stdlib modules of the same
# name (json -> re -> enum -> `from operator import or_` crashes). Only
# sys/os are safe to import here (always preloaded at startup).
import os as _os
import sys as _sys
_pkg_dir = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:] = [p for p in _sys.path
                if _os.path.abspath(p or _os.getcwd()) != _pkg_dir]

import json
import sys

import numpy as np


def _load_chaos():
    """The io.* chaos points (record_corrupt / decode_stall / worker_kill)
    only when the armed spec mentions them: importing the chaos module
    pulls the whole package, and this worker's startup must stay light
    (no package imports) in the common un-armed case."""
    spec = _os.environ.get("MXTPU_CHAOS", "")
    if "io." not in spec:
        return None
    try:
        from incubator_mxnet_tpu_torch import chaos
        return chaos
    except Exception:
        return None


def _read_record_at(handle, offset):
    import struct
    _MAGIC = 0xced7230a
    _LFLAG_BITS = 29
    _LFLAG_MASK = (1 << _LFLAG_BITS) - 1
    handle.seek(offset)
    parts = []
    while True:
        magic, lword = struct.unpack("<II", handle.read(8))
        assert magic == _MAGIC
        cflag = lword >> _LFLAG_BITS
        length = lword & _LFLAG_MASK
        buf = handle.read(length)
        pad = (-length) % 4
        if pad:
            handle.read(pad)
        parts.append(buf)
        if cflag in (0, 3):
            return b"".join(parts)
        parts.append(struct.pack("<I", _MAGIC))


def _resize_np(img, w, h):
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def _unpack_img(raw):
    import io as _io
    import struct
    from PIL import Image
    fmt = "IfQQ"
    size = struct.calcsize(fmt)
    flag, label, _id, _id2 = struct.unpack(fmt, raw[:size])
    payload = raw[size:]
    if flag > 0:
        label = np.frombuffer(payload[:flag * 4], dtype=np.float32)
        payload = payload[flag * 4:]
    im = Image.open(_io.BytesIO(payload))
    if im.mode != "RGB":
        im = im.convert("RGB")
    return label, np.asarray(im)


def main():
    from multiprocessing import shared_memory

    cfg = json.loads(sys.stdin.readline())
    c, h, w = cfg["shape"]
    label_width = cfg["label_width"]
    resize = cfg["resize"]
    rand_crop = cfg["rand_crop"]
    rand_mirror = cfg["rand_mirror"]
    rng = np.random.RandomState(cfg["seed"])
    offsets = cfg["offsets"]
    shms = [shared_memory.SharedMemory(name=n) for n in cfg["shm_names"]]
    # the PARENT owns these segments; detach them from this process's
    # resource tracker or it tries (and fails) to unlink them at exit
    try:
        from multiprocessing import resource_tracker
        for sh in shms:
            resource_tracker.unregister(sh._name, "shared_memory")
    except Exception:
        pass
    handle = open(cfg["rec_path"], "rb")
    out = sys.stdout
    chaos = _load_chaos()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            slot_s, idx_s = line.split(":", 1)
            slot = int(slot_s)
            indices = [int(x) for x in idx_s.split(",")]
            bs = len(indices)
            if chaos is not None:
                if chaos.should_fail("io.worker_kill"):
                    _os._exit(17)
                if chaos.should_fail("io.decode_stall"):
                    import time as _t
                    _t.sleep(float(_os.environ.get("MXTPU_IO_STALL_S",
                                                   "0.05")))
            img_view = np.ndarray((bs, h, w, c), np.uint8,
                                  buffer=shms[slot].buf)
            lab_view = np.ndarray((bs, label_width), np.float32,
                                  buffer=shms[slot].buf,
                                  offset=bs * h * w * c)
            bad, good = [], None
            for j, idx in enumerate(indices):
                try:
                    if (chaos is not None
                            and chaos.should_fail("io.record_corrupt")):
                        raise IOError("chaos: injected record corruption")
                    raw = _read_record_at(handle, offsets[idx])
                    label, img = _unpack_img(raw)
                except Exception:
                    # corrupt record: quarantine (counted in the reply's
                    # third field) and backfill after the loop so batch
                    # shapes never change
                    bad.append(j)
                    continue
                if resize > 0 and min(img.shape[:2]) != resize:
                    r = resize / min(img.shape[:2])
                    nh = max(h, int(img.shape[0] * r + 0.5))
                    nw = max(w, int(img.shape[1] * r + 0.5))
                    img = _resize_np(img, nw, nh)
                if img.shape[0] < h or img.shape[1] < w:
                    img = _resize_np(img, w, h)
                if img.shape[0] > h or img.shape[1] > w:
                    if rand_crop:
                        y0 = rng.randint(0, img.shape[0] - h + 1)
                        x0 = rng.randint(0, img.shape[1] - w + 1)
                    else:
                        y0 = (img.shape[0] - h) // 2
                        x0 = (img.shape[1] - w) // 2
                    img = img[y0:y0 + h, x0:x0 + w]
                if rand_mirror and rng.rand() < 0.5:
                    img = img[:, ::-1]
                img_view[j] = img[:, :, :c]
                lab = np.atleast_1d(np.asarray(label, np.float32))
                row = np.zeros(label_width, np.float32)
                row[:min(len(lab), label_width)] = lab[:label_width]
                lab_view[j] = row
                if good is None:
                    good = j
            for j in bad:
                if good is not None:
                    img_view[j] = img_view[good]
                    lab_view[j] = lab_view[good]
                else:
                    img_view[j] = 0
                    lab_view[j] = 0
            out.write(f"{slot}:{bs}:{len(bad)}\n")
            out.flush()
    except (BrokenPipeError, KeyboardInterrupt):
        pass
    finally:
        handle.close()
        for sh in shms:
            sh.close()


if __name__ == "__main__":
    main()
