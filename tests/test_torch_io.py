"""The port's ``io`` against the JAX package's, on the CPU.

``NDArrayIter`` (pad, discard, roll-over, shuffle), ``CSVIter``,
``ResizeIter``, ``PrefetchingIter``; ``ImageRecordIter`` on its three
routes against the reference's same route (the native pipeline in
float32 and uint8, the process pool of ``_recdecode.py`` workers, the
in-process Python route), and ``DevicePrefetcher`` with ``device="cpu"``:
order, reset, close, a source error, the ``pipeline.stall`` chaos point.
Every comparison is exact (tolerance 0) unless an assertion says
otherwise: both packages decode with the same libjpeg or PIL and
normalise in float32 the same way.
"""
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import _native as jnat
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _native as tnat
from incubator_mxnet_tpu_torch import chaos, telemetry
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch.recordio import IRHeader, MXRecordIO, pack_img


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _data(n=24, d=4, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, d).astype(np.float32), rs.rand(n).astype(np.float32)


def _np(batch):
    return [a.asnumpy() for a in batch.data] + [a.asnumpy()
                                               for a in batch.label]


# --------------------------------------------------------- in-memory iters
@pytest.mark.parametrize("handle,pads,n", [("pad", [0, 0, 2], 3),
                                           ("discard", [0, 0], 2)])
def test_ndarray_iter_last_batch_matches_the_reference(handle, pads, n):
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.float32)
    t = list(tio.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle))
    j = list(jmx.io.NDArrayIter(x, y, batch_size=4,
                                last_batch_handle=handle))
    assert len(t) == len(j) == n
    assert [b.pad for b in t] == [b.pad for b in j] == pads
    for a, b in zip(t, j):
        for u, v in zip(_np(a), _np(b)):
            np.testing.assert_array_equal(u, v)


def test_ndarray_iter_shuffle_and_roll_over():
    x = np.arange(12, dtype=np.float32).reshape(12, 1)
    np.random.seed(3)
    t = [b.data[0].asnumpy() for b in tio.NDArrayIter(
        x, np.zeros(12, np.float32), batch_size=4, shuffle=True)]
    np.random.seed(3)
    j = [b.data[0].asnumpy() for b in jmx.io.NDArrayIter(
        x, np.zeros(12, np.float32), batch_size=4, shuffle=True)]
    assert sorted(np.concatenate(t).ravel()) == list(range(12))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    its = [m.NDArrayIter(np.arange(10, dtype=np.float32), batch_size=4,
                         last_batch_handle="roll_over")
           for m in (tio, jmx.io)]
    for it in its:
        assert [b.data[0].shape for b in it] == [(4,), (4,), (2,)]
        it.cursor = 6               # stopped mid-epoch
        it.reset()
    assert its[0].cursor == its[1].cursor == -2
    assert its[0].provide_data[0].shape == (4,)


def test_csv_and_resize_iters(tmp_path):
    data = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    labels = np.arange(8, dtype=np.float32)
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, labels, delimiter=",")
    t = next(iter(tio.CSVIter(data_csv=str(dpath), data_shape=(3,),
                              label_csv=str(lpath), batch_size=4)))
    j = next(iter(jmx.io.CSVIter(data_csv=str(dpath), data_shape=(3,),
                                 label_csv=str(lpath), batch_size=4)))
    for u, v in zip(_np(t), _np(j)):
        np.testing.assert_array_equal(u, v)
    base = tio.NDArrayIter(np.zeros((8, 2), np.float32),
                           np.zeros(8, np.float32), batch_size=2)
    assert len(list(tio.ResizeIter(base, size=2))) == 2
    longer = tio.ResizeIter(base, size=7)      # wraps past the epoch
    assert len(list(longer)) == 7


def test_mnist_iter_is_the_references_synthetic_set():
    t = tio.MNISTIter(batch_size=64, shuffle=False)
    j = jmx.io.MNISTIter(batch_size=64, shuffle=False)
    for _ in range(2):
        for u, v in zip(_np(t.next()), _np(j.next())):
            np.testing.assert_array_equal(u, v)


def test_prefetching_iter_lifecycle():
    xs, ys = _data(16)
    before = threading.active_count()
    it = tio.PrefetchingIter(tio.NDArrayIter(xs, ys, batch_size=4))
    first = next(it).data[0].asnumpy()
    next(it)
    it.reset()
    batches = [b.data[0].asnumpy() for b in it]
    assert len(batches) == 4
    np.testing.assert_array_equal(batches[0], first)
    it.close()
    assert threading.active_count() == before
    assert it.iter_next() is False


def test_prefetching_iter_runs_sources_on_its_makers_context():
    """The worker thread makes arrays on the context current where the
    iterator was made (here the CPU; a thread's own default is the
    card)."""
    class Fresh(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.provide_data = [tio.DataDesc("data", (2,))]
            self.provide_label = [tio.DataDesc("lbl", (2,))]

        def next(self):
            return tio.DataBatch([tmx.nd.array([1.0, 2.0])],
                                 [tmx.nd.array([0.0, 1.0])])
    with tio.PrefetchingIter(Fresh()) as it:
        assert next(it).data[0].context == tmx.cpu()


def test_prefetching_iter_source_error_is_attributed():
    class Boom(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.provide_data = [tio.DataDesc("data", (2, 2))]
            self.provide_label = [tio.DataDesc("lbl", (2,))]

        def next(self):
            err = IOError("bad record")
            err.mxtpu_uri, err.mxtpu_offset = "x.rec", 48
            raise err
    with tio.PrefetchingIter(Boom()) as it:
        with pytest.raises(RuntimeError, match=r"worker 0 failed.*x.rec @ "
                                               r"byte 48"):
            next(it)


def test_libsvm_iter_names_the_sparse_slice(tmp_path):
    """The sparse slice is ported: LibSVMIter yields CSR batches
    (tests/test_torch_sparse.py holds it against the reference); a file
    that is not there raises."""
    with pytest.raises(FileNotFoundError):
        tio.LibSVMIter(str(tmp_path / "x.libsvm"), (10,))
    path = tmp_path / "y.libsvm"
    path.write_text("1 3:2.5\n0 0:1.0\n")
    batch = next(iter(tio.LibSVMIter(str(path), (10,), batch_size=2)))
    assert batch.data[0].stype == "csr" and batch.data[0].shape == (2, 10)


# ----------------------------------------------------------- ImageRecordIter
def _write_rec(path, n=20, size=40, fmt=".jpg", label_width=1, seed=6):
    rs = np.random.RandomState(seed)
    w = MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 255, (size, size, 3), dtype=np.uint8)
        lab = float(i % 7) if label_width == 1 else [float(i), i * 0.5]
        w.write(pack_img(IRHeader(0, lab, i, 0), img, quality=90,
                         img_fmt=fmt))
    w.close()
    return path


def _epoch(it):
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    it.reset()
    return out


def _assert_epochs_equal(t, j, dtype):
    assert len(t) == len(j) > 0
    for (tx, ty, tp), (jx, jy, jp) in zip(t, j):
        assert tx.dtype == jx.dtype == dtype
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tp == jp


AUG = dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
           mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0, std_g=57.0,
           std_b=57.5, seed=11)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_image_record_iter_native_route_equals_the_reference(tmp_path,
                                                             dtype):
    """Two epochs, shuffled, cropped, mirrored, resized and normalised:
    the port at 2 threads equals the reference at 4, bit for bit."""
    if not jnat.available():
        pytest.skip("the reference's native library did not build")
    path = _write_rec(str(tmp_path / "a.rec"), label_width=2)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=6,
              label_width=2, dtype=dtype, **AUG)
    t = tio.ImageRecordIter(preprocess_threads=2, **kw)
    j = jmx.io.ImageRecordIter(preprocess_threads=4, **kw)
    assert t.route == "native"
    want = np.uint8 if dtype == "uint8" else np.float32
    for _ in range(2):
        _assert_epochs_equal(_epoch(t), _epoch(j), want)
    assert t.provide_data[0].shape == j.provide_data[0].shape
    assert t.provide_data[0].dtype == j.provide_data[0].dtype
    t.close()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_image_record_iter_process_route_equals_the_reference(
        tmp_path, monkeypatch, dtype):
    """Without the native library both packages decode with PIL in 2
    ``_recdecode.py`` processes, each seeded seed + 13 i: the batches,
    pads and a mid-epoch reset agree exactly."""
    path = _write_rec(str(tmp_path / "p.rec"), n=10, size=36, fmt=".png")
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(jnat, "available", lambda: False)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              preprocess_procs=2, dtype=dtype, rand_crop=True,
              rand_mirror=True, seed=5)
    t = tio.ImageRecordIter(**kw)
    j = jmx.io.ImageRecordIter(**kw)
    assert t.route == "procs" and t._procs is not None
    want = np.uint8 if dtype == "uint8" else np.float32
    te, je = _epoch(t), _epoch(j)
    _assert_epochs_equal(te, je, want)
    assert [p for _, _, p in te] == [0, 0, 2]
    t.next()
    t.reset()                       # must not hang
    assert [b.pad for b in t] == [0, 0, 2]
    t.close()
    j.close()


def test_image_record_iter_python_route_equals_the_reference(tmp_path,
                                                             monkeypatch):
    path = _write_rec(str(tmp_path / "q.rec"), n=10, size=36)
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(jnat, "available", lambda: False)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              **AUG)
    t = tio.ImageRecordIter(**kw)
    j = jmx.io.ImageRecordIter(**kw)
    assert t.route == "python"
    _assert_epochs_equal(_epoch(t), _epoch(j), np.float32)


def test_native_and_python_routes_agree_on_labels_and_pads(tmp_path,
                                                           monkeypatch):
    path = _write_rec(str(tmp_path / "l.rec"), n=10, size=32,
                      label_width=2)

    def collect():
        it = tio.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                                 batch_size=4, label_width=2)
        return it.route, [(b.label[0].shape, b.pad) for b in it]
    native = collect()
    monkeypatch.setattr(tnat, "available", lambda: False)
    fallback = collect()
    assert native[0] == "native" and fallback[0] == "python"
    assert native[1] == fallback[1] == [((4, 2), 0), ((4, 2), 0),
                                        ((4, 2), 2)]


# ------------------------------------------------------- DevicePrefetcher
def test_prefetcher_in_order_and_bit_identical():
    xs, ys = _data()
    sync = [_np(b) for b in tio.NDArrayIter(xs, ys, batch_size=4)]
    with tio.DevicePrefetcher(tio.NDArrayIter(xs, ys, batch_size=4),
                              depth=3, device="cpu") as pf:
        assert pf.device.type == "cpu"
        pre = [_np(b) for b in pf]
    assert len(pre) == len(sync) == 6
    for a, b in zip(sync, pre):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def test_prefetcher_reset_discards_stale_batches():
    xs, ys = _data(n=32)
    pf = tio.DevicePrefetcher(tio.NDArrayIter(xs, ys, batch_size=4),
                              depth=4, device="cpu")
    first = next(pf).data[0].asnumpy()
    next(pf)
    pf.reset()
    again = [b.data[0].asnumpy() for b in pf]
    assert len(again) == 8
    np.testing.assert_array_equal(again[0], first)
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.reset()


def test_prefetcher_close_joins_its_thread():
    xs, ys = _data(n=16)
    before = threading.active_count()
    pf = tio.DevicePrefetcher(tio.NDArrayIter(xs, ys, batch_size=4),
                              depth=2, device="cpu")
    next(pf)
    pf.close()
    pf.close()
    assert threading.active_count() == before


def test_prefetcher_raises_the_source_error():
    def bad_source():
        yield [tmx.nd.array([1.0])]
        raise ValueError("decode failed")
    pf = tio.DevicePrefetcher(bad_source(), depth=2, device="cpu")
    assert next(pf)[0].asnumpy()[0] == 1.0
    with pytest.raises(ValueError, match="decode failed"):
        next(pf)
    pf.close()


def test_prefetcher_moves_numpy_and_tensor_leaves():
    import torch
    src = [(np.arange(3.0), torch.ones(2), "meta")]
    with tio.DevicePrefetcher(src, device="cpu") as pf:
        a, b, c = next(pf)
    assert isinstance(a, tmx.nd.NDArray) and a.dtype == np.float32
    assert isinstance(b, torch.Tensor) and c == "meta"


def test_prefetcher_chaos_stall_degrades_to_blocking():
    xs, ys = _data()
    sync = [b.data[0].asnumpy() for b in tio.NDArrayIter(xs, ys,
                                                         batch_size=4)]
    stall = telemetry.counter(tio.STALL_COUNTER)
    before = stall.value()
    chaos.arm("pipeline.stall", prob=1.0, seed=3)
    try:
        with tio.DevicePrefetcher(tio.NDArrayIter(xs, ys, batch_size=4),
                                  depth=2, device="cpu") as pf:
            pre = [b.data[0].asnumpy() for b in pf]
    finally:
        chaos.disarm("pipeline.stall")
    assert len(pre) == len(sync)
    for a, b in zip(sync, pre):
        np.testing.assert_array_equal(a, b)
    assert stall.value() > before
    assert telemetry.gauge(tio.DEPTH_GAUGE).value() >= 0


def test_prefetcher_default_device_is_the_current_context():
    xs, ys = _data(n=8)
    with tio.DevicePrefetcher(tio.NDArrayIter(xs, ys, batch_size=4)) as pf:
        assert pf.device.type == "cpu"          # inside with tmx.cpu()


def test_mesh_placement_names_the_distributed_slice():
    # with no mesh current a sharded placement is the whole batch (the
    # reference's rule); tests/test_torch_mesh_train.py holds the blocks
    # each rank of a mesh gets
    with tio.DevicePrefetcher([], sharded=True, device="cpu") as pf:
        assert pf.device.type == "cpu"
    out = tio.device_transfer(np.arange(4, dtype=np.float32), sharded=True)
    np.testing.assert_array_equal(out.asnumpy(), np.arange(4))


def test_dataloader_device_prefetch_composes():
    from incubator_mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    xs, ys = _data(n=20)
    ds = ArrayDataset(tmx.nd.array(xs), tmx.nd.array(ys))
    plain = [[a.asnumpy() for a in b] for b in DataLoader(ds, batch_size=4)]
    pref = [[a.asnumpy() for a in b]
            for b in DataLoader(ds, batch_size=4, device_prefetch=2)]
    assert len(plain) == len(pref) == 5
    for p, q in zip(plain, pref):
        for a, b in zip(p, q):
            np.testing.assert_array_equal(a, b)
