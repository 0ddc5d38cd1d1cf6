"""The port's ``gluon.data`` against the JAX package's, on the CPU.

Datasets (``ArrayDataset``, ``SimpleDataset``, the lazy transforms,
``RecordFileDataset``), the samplers (numpy's seeded order, every
``last_batch`` mode), ``DataLoader`` in this process, on a producer
thread and on 2 process workers (every batch once and in order, equal to
the reference's; the workers report that they did not initialise CUDA),
the vision transforms with seeded ``random`` and numpy, and the vision
datasets on files this file writes (MNIST idx, CIFAR binaries, a record
pack, an image folder) and on the seeded synthetic sets. Exact
(tolerance 0) unless an assertion says otherwise.
"""
import gzip
import os
import random
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.recordio import (IRHeader, MXIndexedRecordIO,
                                                pack, pack_img)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _leaves(batch):
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _leaves(b)]
    return [batch.asnumpy() if hasattr(batch, "asnumpy") else
            np.asarray(batch)]


def _same_batches(t, j):
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb)
        for u, v in zip(la, lb):
            assert u.shape == v.shape and u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def _arrays(n=37, seed=5):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 4).astype(np.float32), \
        rs.randint(0, 3, (n,)).astype(np.float32)


# ------------------------------------------------------------- datasets
def test_datasets_and_lazy_transforms():
    x, y = _arrays(10)
    t = tgluon.data.ArrayDataset(tmx.nd.array(x), tmx.nd.array(y))
    j = jgluon.data.ArrayDataset(jmx.nd.array(x), jmx.nd.array(y))
    assert len(t) == len(j) == 10
    np.testing.assert_array_equal(t[3][0].asnumpy(), j[3][0].asnumpy())
    assert t[3][1] == j[3][1]            # a 1-D NDArray kept as numpy
    tf = t.transform_first(lambda a: a * 2)
    np.testing.assert_array_equal(tf[2][0].asnumpy(), x[2] * 2)
    assert tf[2][1] == y[2]
    eager = t.transform(lambda a, b: (a + 1, b), lazy=False)
    assert isinstance(eager, tgluon.data.SimpleDataset)
    np.testing.assert_array_equal(eager[0][0].asnumpy(), x[0] + 1)
    assert len(t.filter(lambda s: s[1] > 0)) == \
        len(j.filter(lambda s: s[1] > 0))
    assert len(t.take(4)) == 4 and len(t.shard(3, 1)) == 3
    with pytest.raises(AssertionError):
        tgluon.data.ArrayDataset(x, y[:4])


def test_record_file_dataset_reads_the_reference_file(tmp_path):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        w.write_idx(i, jmx.recordio.pack(jmx.recordio.IRHeader(0, i, i, 0),
                                         bytes([i]) * (i + 1)))
    w.close()
    t = tgluon.data.RecordFileDataset(rec)
    j = jgluon.data.RecordFileDataset(rec)
    assert len(t) == len(j) == 6
    assert [t[i] for i in range(6)] == [j[i] for i in range(6)]


# ------------------------------------------------------------- samplers
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_the_reference(last):
    for mod in (tgluon.data, jgluon.data):
        assert list(mod.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    np.random.seed(2)
    t = list(tgluon.data.RandomSampler(9))
    np.random.seed(2)
    assert t == list(jgluon.data.RandomSampler(9))
    tb = tgluon.data.BatchSampler(tgluon.data.SequentialSampler(10), 4, last)
    jb = jgluon.data.BatchSampler(jgluon.data.SequentialSampler(10), 4, last)
    for _ in range(2):                 # rollover carries into the next pass
        assert len(tb) == len(jb)
        assert list(tb) == list(jb)
    with pytest.raises(ValueError):
        list(tgluon.data.BatchSampler([1, 2, 3], 2, "bogus"))


# ------------------------------------------------------------ DataLoader
@pytest.mark.parametrize("mode", ["inline", "thread", "process"])
def test_dataloader_matches_the_reference(mode):
    """Every batch once and in order, equal to the reference's loader in
    its own process; the port's process workers never initialise CUDA."""
    x, y = _arrays()
    kw = dict(batch_size=8, shuffle=True, last_batch="keep")
    if mode != "inline":
        kw.update(num_workers=2, thread_pool=mode == "thread")
    np.random.seed(4)
    tl = tgluon.data.DataLoader(
        tgluon.data.ArrayDataset(tmx.nd.array(x), tmx.nd.array(y)), **kw)
    t = list(tl)
    np.random.seed(4)
    j = list(jgluon.data.DataLoader(
        jgluon.data.ArrayDataset(jmx.nd.array(x), jmx.nd.array(y)),
        batch_size=8, shuffle=True, last_batch="keep"))
    _same_batches(t, j)
    assert len(t) == len(tl) == 5
    assert all(b[0].context == tmx.cpu() for b in t)
    if mode == "process":
        assert len(tl.worker_reports) == 2
        for r in tl.worker_reports:
            assert r["cuda_initialized"] is False
            assert r["cuda_visible_devices"] == ""


def test_dataloader_batchify_and_argument_rules():
    samples = [(np.full((2,), i, np.float32), i) for i in range(6)]
    t = list(tgluon.data.DataLoader(tgluon.data.SimpleDataset(samples),
                                    batch_size=4, last_batch="discard"))
    j = list(jgluon.data.DataLoader(jgluon.data.SimpleDataset(samples),
                                    batch_size=4, last_batch="discard"))
    _same_batches(t, j)
    b = tgluon.data.default_batchify_fn([tmx.nd.array([1.0, 2.0])] * 3)
    assert b.shape == (3, 2)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(samples)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(samples, batch_size=2, shuffle=True,
                               sampler=[0, 1])
    bs = tgluon.data.BatchSampler(tgluon.data.SequentialSampler(6), 3)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(samples, batch_size=2, batch_sampler=bs)


def test_dataloader_thread_pool_raises_the_dataset_error():
    class Bad(tgluon.data.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"sample {i}")
    with pytest.raises(KeyError, match="sample 0"):
        list(tgluon.data.DataLoader(Bad(), batch_size=2, num_workers=1))


# ------------------------------------------------------------ transforms
def _hwc(h=40, w=44, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _run(mod, build, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    ndm = tmx.nd if mod is tgluon else jmx.nd
    return build(mod.data.vision.transforms)(ndm.array(img, dtype="uint8"))


TRANSFORMS = {
    "to_tensor_normalize": (lambda T: T.Compose([
        T.ToTensor(), T.Normalize((0.485, 0.456, 0.406),
                                  (0.229, 0.224, 0.225))]), 1e-6),
    "cast": (lambda T: T.Cast("float16"), 0),
    "resize": (lambda T: T.Resize((24, 20)), 1),
    "center_crop": (lambda T: T.CenterCrop(30), 0),
    "random_resized_crop": (lambda T: T.RandomResizedCrop(24), 1),
    "flips": (lambda T: T.Compose([T.RandomFlipLeftRight(),
                                   T.RandomFlipTopBottom()]), 0),
    "color_jitter": (lambda T: T.RandomColorJitter(0.3, 0.3, 0.3, 0.1),
                     1e-4),
    "lighting": (lambda T: T.RandomLighting(0.1), 1e-4),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_the_reference(name):
    """Seeded draws: equal to the reference's; a resize within 1 uint8
    level, float32 arithmetic within the stated absolute tolerance."""
    build, tol = TRANSFORMS[name]
    for seed in range(4):
        t = _run(tgluon, build, _hwc(), seed).asnumpy()
        j = _run(jgluon, build, _hwc(), seed).asnumpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        assert np.max(np.abs(t.astype(np.float64) - j)) <= tol, name


def test_transforms_batch_and_pickle():
    import pickle
    T = tgluon.data.vision.transforms
    chain = T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)])
    x = tmx.nd.array(np.stack([_hwc(8, 8), _hwc(8, 8, 1)]), dtype="uint8")
    out = pickle.loads(pickle.dumps(chain))(x)
    assert out.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(out.asnumpy(),
                               (x.asnumpy().transpose(0, 3, 1, 2) / 255.0
                                - 0.5) / 0.25, rtol=0, atol=1e-6)


# --------------------------------------------------------- vision datasets
def _write_mnist(root, n=12):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, (n,)).astype(np.uint8)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(root, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, label_bytes, n=5):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(4)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rec = rs.randint(0, 256, (n, label_bytes + 3072)).astype(np.uint8)
        rec[:, :label_bytes] %= 10
        (open(os.path.join(root, name), "wb")).write(rec.tobytes())


def _same_samples(t, j, idxs=(0, 1, 4)):
    assert len(t) == len(j)
    for i in idxs:
        (ta, tb), (ja, jb) = t[i], j[i]
        np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
        np.testing.assert_array_equal(np.asarray(tb), np.asarray(jb))
        assert ta.context == tmx.cpu()


def test_mnist_and_cifar_from_files(tmp_path):
    _write_mnist(str(tmp_path / "mnist"))
    _same_samples(tgluon.data.vision.MNIST(root=str(tmp_path / "mnist")),
                  jgluon.data.vision.MNIST(root=str(tmp_path / "mnist")))
    for cls, lb in (("CIFAR10", 1), ("CIFAR100", 2)):
        root = str(tmp_path / cls)
        _write_cifar(root, lb)
        for train in (True, False):
            _same_samples(getattr(tgluon.data.vision, cls)(root=root,
                                                          train=train),
                          getattr(jgluon.data.vision, cls)(root=root,
                                                          train=train))


def test_synthetic_sets_are_the_references(tmp_path):
    for cls in ("MNIST", "FashionMNIST", "CIFAR10"):
        kw = dict(root=str(tmp_path / "none"), synthetic_size=64)
        t = getattr(tgluon.data.vision, cls)(**kw)
        j = getattr(jgluon.data.vision, cls)(**kw)
        _same_samples(t, j, idxs=(0, 17, 63))
    tf = tgluon.data.vision.MNIST(
        root=str(tmp_path / "none"), synthetic_size=8,
        transform=lambda x, y: (x.astype("float32") / 255, y + 1))
    assert tf[0][0].dtype == np.float32


def test_image_record_and_folder_datasets(tmp_path):
    rec, idx = str(tmp_path / "v.rec"), str(tmp_path / "v.idx")
    w = MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, pack_img(IRHeader(0, float(i), i, 0), _hwc(20, 24, i),
                                quality=90))
    w.close()
    _same_samples(tgluon.data.vision.ImageRecordDataset(rec),
                  jgluon.data.vision.ImageRecordDataset(rec))
    T = tgluon.data.vision.transforms
    ds = tgluon.data.vision.ImageRecordDataset(rec).transform_first(
        T.ToTensor())
    assert ds[2][0].shape == (3, 20, 24)
    root = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir(parents=True)
        from PIL import Image
        Image.fromarray(_hwc(10, 12, c)).save(root / cls / "a.png")
        np.save(root / cls / "b.npy", _hwc(6, 6, c))
        (root / cls / "skip.txt").write_text("not an image")
    t = tgluon.data.vision.ImageFolderDataset(str(root))
    j = jgluon.data.vision.ImageFolderDataset(str(root))
    assert t.synsets == j.synsets == ["cat", "dog"]
    _same_samples(t, j, idxs=range(4))


def test_raw_records_through_process_workers(tmp_path):
    """The raw-pixel records of the card's input lane (a record file of
    ``recordio.pack`` images), through a picklable transform on 2 process
    workers, equal to the same loader in this process."""
    import chip_smoke
    rec = str(tmp_path / "raw.rec")
    w = MXIndexedRecordIO(str(tmp_path / "raw.idx"), rec, "w")
    imgs = [_hwc(256, 256, i) for i in range(6)]
    for i, img in enumerate(imgs):
        w.write_idx(i, pack(IRHeader(0, float(i), i, 0), img.tobytes()))
    w.close()
    ds = tgluon.data.RecordFileDataset(rec).transform(
        chip_smoke._RawImage((256, 256, 3)))
    outs = [list(tgluon.data.DataLoader(ds, batch_size=4, num_workers=n,
                                        thread_pool=False))
            for n in (0, 2)]
    _same_batches(*outs)
    np.testing.assert_array_equal(outs[1][0][0].asnumpy()[3], imgs[3])
    np.testing.assert_array_equal(outs[1][1][1].asnumpy(), [4.0, 5.0])
