"""The port's native host runtime and RecordIO against the JAX package.

``incubator_mxnet_tpu_torch._native`` builds ``native/``'s sources into
``build/native_torch/`` under a file lock and binds them; its
``recordio`` writes and reads the reference's framing. Held here: the
build and its lock, record round trips through the native and the
Python route (the same bytes on disk), files written by either package
read by the other bit for bit, offsets, the torn-tail salvage,
``pack``/``unpack`` and ``pack_img``/``unpack_img`` (the native codec
against the reference's PIL, bit for bit), and the native pipeline.
Every comparison is exact (tolerance 0) unless an assertion says
otherwise.
"""
import logging
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import incubator_mxnet_tpu.recordio as jrec
from incubator_mxnet_tpu import _native as jnat
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _native as tnat
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.io import _scan_record_offsets

_MAGIC_BYTES = struct.pack("<I", 0xced7230a)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payloads():
    return [b"hello world", b"", b"x" * 1000,
            b"abcd" + _MAGIC_BYTES + b"efgh",      # aligned magic: parts
            _MAGIC_BYTES * 3,
            b"a" + _MAGIC_BYTES,                   # unaligned: no split
            np.random.RandomState(0).bytes(4096)]


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(tnat, "available", lambda: False)
    else:
        assert tnat.available(), tnat.load_error()
    return request.param


def _read_all(reader):
    got = []
    while True:
        rec = reader.read()
        if rec is None:
            return got
        got.append(rec)


# ----------------------------------------------------------------- the build
def test_native_builds_into_its_own_directory():
    assert tnat.available(), tnat.load_error()
    assert tnat.load_error() is None
    assert tnat.LIB_PATH == os.path.join(REPO, "build", "native_torch",
                                         "libmxtpu.so")
    assert tnat.lib._name == tnat.LIB_PATH
    assert os.path.join("native", "build") not in tnat.lib._name
    assert tnat.build_seconds() is not None


_BUILD = """
import sys
from incubator_mxnet_tpu_torch import _native as n
n.BUILD_DIR = sys.argv[1]
n.LIB_PATH = sys.argv[1] + "/libmxtpu.so"
n._build()
print("built")
"""

# a stand-in for make: logs its start and end, holds 0.3 s, writes the
# library into BUILD=...
_FAKE_MAKE = """#!/bin/sh
build=""
for a in "$@"; do case "$a" in BUILD=*) build="${a#BUILD=}";; esac; done
echo "start $$ $(date +%s.%N)" >> "$build/make.log"
sleep 0.3
touch "$build/libmxtpu.so"
echo "end $$ $(date +%s.%N)" >> "$build/make.log"
"""


def test_concurrent_builds_take_turns_under_the_lock(tmp_path):
    """Three processes reach their first build at once (as test workers
    do): the file lock runs their ``make`` calls one after another, and
    each finds the library."""
    bindir, build = tmp_path / "bin", tmp_path / "b"
    bindir.mkdir()
    make = bindir / "make"
    make.write_text(_FAKE_MAKE)
    make.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.strip() == "built" for o, _ in outs)
    events = [line.split() for line in
              (build / "make.log").read_text().splitlines()]
    assert [e[0] for e in events] == ["start", "end"] * 3
    for start, end in zip(events[::2], events[1::2]):
        assert start[1] == end[1]            # one make at a time
    assert (build / ".build.lock").exists()


def test_failed_build_leaves_the_library_off_with_its_error(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(tnat, "lib", None)
    monkeypatch.setattr(tnat, "_error", None)
    monkeypatch.setattr(tnat, "_NATIVE_DIR", str(tmp_path / "nowhere"))
    assert not tnat.available()
    assert "no native sources" in tnat.load_error()
    monkeypatch.setattr(tnat, "_error", None)
    monkeypatch.setenv("MXTPU_NO_NATIVE", "1")
    assert not tnat.available()
    assert "MXTPU_NO_NATIVE" in tnat.load_error()


# ------------------------------------------------------------------ records
def test_round_trip_on_both_routes(tmp_path, route):
    path = str(tmp_path / "t.rec")
    w = trec.MXRecordIO(path, "w")
    assert (w._native_h is not None) == (route == "native")
    for p in _payloads():
        w.write(p)
    w.close()
    r = trec.MXRecordIO(path, "r")
    assert _read_all(r) == _payloads()
    r.close()


def test_both_routes_write_the_same_bytes(tmp_path, monkeypatch):
    paths = {}
    for kind in ("native", "python"):
        if kind == "python":
            monkeypatch.setattr(tnat, "available", lambda: False)
        paths[kind] = str(tmp_path / f"{kind}.rec")
        w = trec.MXRecordIO(paths[kind], "w")
        for p in _payloads():
            w.write(p)
        w.close()
    with open(paths["native"], "rb") as a, open(paths["python"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_between_packages(tmp_path, route, writer):
    """A file of either package reads in the other, record for record;
    the indexed form keeps the same keys and offsets."""
    path, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = (trec if writer == "port" else jrec).MXIndexedRecordIO(idx, path,
                                                              "w")
    for i, p in enumerate(_payloads()):
        w.write_idx(i, p)
    w.close()
    reader_mod = jrec if writer == "port" else trec
    r = reader_mod.MXIndexedRecordIO(idx, path, "r")
    assert r.keys == list(range(len(_payloads())))
    for i in reversed(range(len(_payloads()))):
        assert r.read_idx(i) == _payloads()[i]
    r.close()
    seq = trec.MXRecordIO(path, "r")
    assert _read_all(seq) == _payloads()


def test_record_offsets_agree(tmp_path):
    path = str(tmp_path / "t.rec")
    w = tnat.NativeRecordWriter(path)
    want = []
    for p in _payloads():
        want.append(w.tell())
        w.write(p)
    w.close()
    assert list(tnat.list_record_offsets(path)) == want
    assert _scan_record_offsets(path) == want
    if jnat.available():
        assert list(jnat.list_record_offsets(path)) == want


# ------------------------------------------------------------ the torn tail
N, SIZE = 5, 16
FRAME = 8 + SIZE
LAST = (N - 1) * FRAME


def _torn_copy(tmp_path, cut):
    src = tmp_path / "whole.rec"
    w = trec.MXRecordIO(str(src), "w")
    payloads = [bytes([i]) * SIZE for i in range(N)]
    for p in payloads:
        w.write(p)
    w.close()
    data = src.read_bytes()
    assert len(data) == N * FRAME
    torn = tmp_path / f"torn-{cut}.rec"
    torn.write_bytes(data[:cut])
    return str(torn), payloads


@pytest.mark.parametrize("cut", [LAST + 2, LAST + 5, LAST + 8 + 3],
                         ids=["mid-magic", "mid-header", "mid-payload"])
def test_torn_tail_salvages_intact_records_with_one_warning(
        tmp_path, route, cut, caplog):
    path, payloads = _torn_copy(tmp_path, cut)
    with caplog.at_level(logging.WARNING,
                         logger="incubator_mxnet_tpu_torch.recordio"):
        r = trec.MXRecordIO(path, "r")
        assert _read_all(r) == payloads[:-1]
        assert r.read() is None
    warns = [m for m in caplog.messages if "torn final record" in m]
    assert len(warns) == 1 and f"byte {LAST}" in warns[0]
    assert _scan_record_offsets(path) == [i * FRAME for i in range(N - 1)]


def test_clean_end_never_warns(tmp_path, route, caplog):
    path, payloads = _torn_copy(tmp_path, N * FRAME)
    with caplog.at_level(logging.WARNING):
        assert _read_all(trec.MXRecordIO(path, "r")) == payloads
    assert not [m for m in caplog.messages if "torn" in m]


def test_strict_mode_raises_an_attributed_error(tmp_path, route,
                                                monkeypatch):
    monkeypatch.setenv("MXTPU_IO_TOLERATE_TAIL", "0")
    path, _ = _torn_copy(tmp_path, LAST + 8 + 3)
    r = trec.MXRecordIO(path, "r")
    with pytest.raises(IOError) as ei:
        _read_all(r)
    assert ei.value.mxtpu_uri == path and ei.value.mxtpu_offset == LAST


def test_invalid_magic_mid_file_raises_even_when_tolerant(tmp_path, route):
    path, _ = _torn_copy(tmp_path, N * FRAME)
    data = bytearray(open(path, "rb").read())
    data[2 * FRAME] ^= 0xFF
    open(path, "wb").write(bytes(data))
    r = trec.MXRecordIO(path, "r")
    assert r.read() is not None and r.read() is not None
    with pytest.raises(IOError) as ei:
        r.read()
    assert ei.value.mxtpu_offset == 2 * FRAME


def test_bad_flag_raises():
    with pytest.raises(ValueError):
        trec.MXRecordIO("/nonexistent", "a")


# -------------------------------------------------------- headers and images
@pytest.mark.parametrize("label", [3.0, [1.0, 2.5], np.arange(5.0)])
def test_pack_unpack_match_the_reference(label):
    h = trec.IRHeader(0, label, 7, 9)
    packed = trec.pack(h, b"payload")
    assert packed == jrec.pack(jrec.IRHeader(0, label, 7, 9), b"payload")
    th, tb = trec.unpack(packed)
    jh, jb = jrec.unpack(packed)
    assert tb == jb == b"payload"
    assert th.flag == jh.flag and th.id == jh.id == 7 and th.id2 == 9
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


def _image(h=37, w=53, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(
        np.uint8)


@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".jpg", 95),
                                         (".png", 95)])
def test_pack_img_decodes_as_the_reference_decodes(fmt, quality):
    """The port encodes JPEG with the native codec, the reference with
    PIL; each package's ``unpack_img`` of either package's record gives
    the same pixels (libjpeg's decode both ways); PNG is lossless."""
    img = _image()
    header = trec.IRHeader(0, 4.0, 1, 0)
    mine = trec.pack_img(header, img, quality=quality, img_fmt=fmt)
    theirs = jrec.pack_img(jrec.IRHeader(0, 4.0, 1, 0), img,
                           quality=quality, img_fmt=fmt)
    for rec in (mine, theirs):
        th, timg = trec.unpack_img(rec)
        jh, jimg = jrec.unpack_img(rec)
        assert th.label == jh.label == 4.0
        assert timg.shape == jimg.shape == img.shape
        np.testing.assert_array_equal(timg, jimg)
    if fmt == ".png":
        np.testing.assert_array_equal(trec.unpack_img(mine)[1], img)


@pytest.mark.parametrize("iscolor", [0, 1, -1])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_unpack_img_color_modes_match_the_reference(iscolor, channels):
    img = _image(c=channels)
    if channels == 1:
        img = img[:, :, 0]
    fmt = ".png" if channels == 4 else ".jpg"
    rec = jrec.pack_img(jrec.IRHeader(0, 1.0, 0, 0), img, quality=92,
                        img_fmt=fmt)
    t = trec.unpack_img(rec, iscolor)[1]
    j = jrec.unpack_img(rec, iscolor)[1]
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_without_the_native_library_images_go_through_pil(monkeypatch):
    monkeypatch.setattr(tnat, "available", lambda: False)
    img = _image()
    rec = trec.pack_img(trec.IRHeader(0, 2.0, 0, 0), img, quality=90)
    assert rec == jrec.pack_img(jrec.IRHeader(0, 2.0, 0, 0), img,
                                quality=90)
    np.testing.assert_array_equal(trec.unpack_img(rec)[1],
                                  jrec.unpack_img(rec)[1])


def test_codec_resize_and_pool():
    yy, xx = np.mgrid[0:37, 0:53]
    img = np.stack([(yy * 5) % 256, (xx * 4) % 256, (yy + xx) % 256],
                   axis=-1).astype(np.uint8)
    dec = tnat.imdecode(tnat.imencode_jpeg(img, quality=95))
    assert dec.shape == img.shape
    assert np.abs(dec.astype(np.int32) - img).mean() < 20    # lossy JPEG
    half = np.zeros((10, 10, 3), np.uint8)
    half[:, 5:] = 255
    out = tnat.imresize(half, 20, 20)
    assert out.shape == (20, 20, 3)
    assert out[:, :8].mean() < 30 and out[:, 12:].mean() > 225
    if jnat.available():
        np.testing.assert_array_equal(out, jnat.imresize(half, 20, 20))
    pool = tnat.HostPool()
    a = pool.alloc(1000)
    assert pool.stats() == {"cached": 0, "in_use": 1024, "total": 1024}
    pool.free(a)
    assert pool.alloc(600) == a
    with pytest.raises(RuntimeError):
        pool.free(123456)
    pool.destroy()


# --------------------------------------------------------- the pipeline
def _write_img_rec(path, n, label_width=1, size=32):
    rs = np.random.RandomState(42)
    w = trec.MXRecordIO(path, "w")
    labels = []
    for i in range(n):
        img = (rs.rand(size, size, 3) * 255).astype(np.uint8)
        lab = float(i) if label_width == 1 else [float(i), i * 0.5]
        w.write(trec.pack_img(trec.IRHeader(0, lab, i, 0), img, quality=95))
        labels.append(np.atleast_1d(lab))
    w.close()
    return np.array(labels, np.float32)


def _drain(pipe):
    out = []
    while True:
        b = pipe.next_batch()
        if b is None:
            return out
        out.append(b)


def test_pipeline_pads_wraps_and_resets(tmp_path):
    path = str(tmp_path / "img.rec")
    labels = _write_img_rec(path, 10)
    pipe = tnat.ImageRecordPipeline(path, batch_size=4,
                                    data_shape=(3, 32, 32), num_workers=2)
    assert pipe.num_samples == 10
    got = _drain(pipe)
    assert [b[2] for b in got] == [0, 0, 2]
    seen = np.concatenate([b[1][:, 0] for b in got])
    np.testing.assert_array_equal(seen, np.r_[labels[:, 0], labels[:2, 0]])
    pipe.reset()
    pipe.next_batch()
    pipe.reset()               # mid-epoch
    assert len(_drain(pipe)) == 3
    pipe.close()


@pytest.mark.parametrize("emit_uint8", [False, True])
def test_pipeline_equals_the_reference_for_any_worker_count(tmp_path,
                                                            emit_uint8):
    """Each sample's augmentation is seeded by (seed, sample, epoch): the
    port's pipeline at 3 workers equals the reference's at 1, bit for
    bit, two epochs, with shuffle, crop, mirror, resize and
    normalisation."""
    if not jnat.available():
        pytest.skip("the reference's native library did not build")
    path = str(tmp_path / "img.rec")
    _write_img_rec(path, 12, label_width=2, size=40)
    kw = dict(batch_size=5, data_shape=(3, 32, 32), label_width=2,
              shuffle=True, seed=7, rand_crop=True, rand_mirror=True,
              resize=36, mean=[120.0, 110.0, 100.0], std=[60.0, 58.0, 57.0],
              emit_uint8=emit_uint8)
    t = tnat.ImageRecordPipeline(path, num_workers=3, **kw)
    j = jnat.ImageRecordPipeline(path, num_workers=1, **kw)
    for _ in range(2):
        tb, jb = _drain(t), _drain(j)
        assert len(tb) == len(jb) == 3
        for (tx, tl, tp), (jx, jl, jp) in zip(tb, jb):
            assert tx.dtype == (np.uint8 if emit_uint8 else np.float32)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp
        t.reset()
        j.reset()
    t.close()
    j.close()


def test_port_package_exports():
    assert tmx.recordio is trec
    assert trec.RecordIO is trec.MXRecordIO
