"""The port's ``image.detection`` against the JAX package's, on the CPU.

Each ``Det*Aug`` on the same float32 image and label from the same
``RandomState`` seed: crops, pads, flips and the random selection exact
(they are numpy in both packages), a borrowed resize within 1e-4 on a
0..255 scale (PyTorch's antialiased bilinear against
``jax.image.resize(..., "linear")``, as ``tests/test_torch_image.py``
holds ``imresize``; measured 4.6e-5 here); ``CreateDetAugmenter``'s list
(classes and settings) equal; ``ImageDetIter`` over a ``.rec`` this file
writes (JPEG q 90 through the port's ``recordio.pack_img``), and over an
``imglist``: labels exact, data within the same 1e-4, shuffled order and
padding equal, over two epochs; two SGD steps of the toy SSD of
``tests/test_torch_ssd_train.py``, each package fed by its own iterator,
losses within 1e-4 relative and every parameter within 1e-4 of
max(1, its largest entry).

The reference's departures from MXNet that this module meets are pinned
here: the crop's coverage rule and the label header rule follow the
reference; ``mean=True`` / ``std=True`` follow MXNet.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.image import detection as jdet
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.image import detection as tdet
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.parallel import dp as tdp

from test_torch_ssd_train import (_close, _functional_state,
                                  _j_value_and_grad, _t_sgd_step, _toys)

RESIZE_TOL = 1e-4       # on a 0..255 scale, as tests/test_torch_image.py


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "multibox_target,nms")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _scene(rs, h, w, n, classes=20):
    img = rs.randint(0, 256, (h, w, 3)).astype(np.float32)
    lab = np.full((6, 5), -1.0, np.float32)
    for i in range(n):
        x1, y1 = rs.uniform(0, 0.6, 2)
        lab[i] = [rs.randint(classes), x1, y1, min(x1 + rs.uniform(0.1, 0.4), 1),
                  min(y1 + rs.uniform(0.1, 0.4), 1)]
    return img, lab


def _write_rec(path, n=10, seed=0, header=True, classes=20):
    """VOC-like records: JPEG q 90, 37 x 50 and 50 x 37, 1-3 boxes over
    ``classes`` classes, labels in the ``[2, 5, boxes...]`` header form."""
    rs = np.random.RandomState(seed)
    w = trec.MXRecordIO(str(path), "w")
    for i in range(n):
        h, wd = (50, 37) if i % 2 else (37, 50)
        img = rs.randint(0, 256, (h, wd, 3)).astype(np.uint8)
        _, lab = _scene(rs, h, wd, rs.randint(1, 4), classes)
        flat = lab[lab[:, 0] >= 0].reshape(-1)
        if header:
            flat = np.concatenate([[2, 5], flat]).astype(np.float32)
        w.write(trec.pack_img(trec.IRHeader(0, flat, i, 0), img,
                              quality=90, img_fmt=".jpg"))
    w.close()
    return str(path)


def _aug_pair(make):
    """The same augmenter built in both packages, each on its own
    ``RandomState(7)``."""
    return (make(jdet, np.random.RandomState(7)),
            make(tdet, np.random.RandomState(7)))


AUGS = {
    "flip": lambda m, rng: m.DetHorizontalFlipAug(0.5, rng=rng),
    "crop": lambda m, rng: m.DetRandomCropAug(
        min_object_covered=0.1, area_range=(0.3, 1.0), rng=rng),
    "pad": lambda m, rng: m.DetRandomPadAug(area_range=(1.0, 3.0), rng=rng),
    "select": lambda m, rng: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0, rng=rng),
         m.DetRandomPadAug(area_range=(1.0, 2.0), rng=rng)], 0.3, rng=rng),
    "cast": lambda m, rng: m.DetBorrowAug(
        (jmx if m is jdet else tmx).image.CastAug()),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_det_augmenter_matches_the_reference_bit_for_bit(name):
    ja, ta = _aug_pair(AUGS[name])
    rs = np.random.RandomState(1)
    for _ in range(12):
        img, lab = _scene(rs, 37, 50, rs.randint(0, 4))
        ji, jl = ja(img.copy(), lab.copy())
        ti, tl = ta(img.copy(), lab.copy())
        ji, ti = np.asarray(ji), np.asarray(ti)
        assert ti.shape == ji.shape and ti.dtype == ji.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    assert ta.dumps() == ja.dumps()


def test_borrowed_resize_within_the_resize_tolerance():
    ja, ta = _aug_pair(lambda m, rng: m.DetBorrowAug(
        (jmx if m is jdet else tmx).image.ForceResizeAug((32, 24))))
    img, lab = _scene(np.random.RandomState(2), 37, 50, 2)
    ji, jl = ja(img, lab)
    ti, tl = ta(img, lab)
    assert ti.shape == ji.shape == (24, 32, 3) and ti.dtype == np.float32
    assert np.abs(ti - ji).max() <= RESIZE_TOL * 255
    np.testing.assert_array_equal(tl, jl)


CREATE_CASES = [
    dict(),
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True),
    dict(rand_crop=1, brightness=0.2, contrast=0.1, saturation=0.3,
         mean=(1.0, 2.0, 3.0), std=(2.0, 2.0, 2.0)),
    dict(rand_pad=1, area_range=(0.5, 2.0), pad_val=(0, 0, 0)),
]


@pytest.mark.parametrize("kw", CREATE_CASES)
def test_create_det_augmenter_lists_the_reference_augmenters(kw):
    jl = jdet.CreateDetAugmenter((3, 32, 32), **kw)
    tl = tdet.CreateDetAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    for j, t in zip(jl, tl):
        jd, td = j.dumps(), t.dumps()
        assert td[0] == jd[0]
        assert str(td[1]) == str(jd[1])


def test_mean_and_std_true_are_the_imagenet_statistics_as_in_mxnet():
    """MXNet's ``CreateDetAugmenter`` reads ``mean=True`` / ``std=True`` as
    the ImageNet statistics, as ``CreateAugmenter`` does in both
    packages. The reference's takes True as the number 1; the port
    follows MXNet."""
    img = np.full((4, 4, 3), 200.0, np.float32)
    lab = np.full((2, 5), -1.0, np.float32)
    out = img
    for aug in tdet.CreateDetAugmenter((3, 4, 4), mean=True, std=True):
        out, _ = aug(out, lab)
    want = (200.0 - np.array([123.68, 116.28, 103.53], np.float32)) / \
        np.array([58.395, 57.12, 57.375], np.float32)
    np.testing.assert_allclose(out[0, 0], want, rtol=1e-6)
    jout = img
    for aug in jdet.CreateDetAugmenter((3, 4, 4), mean=True, std=True):
        jout, _ = aug(jout, lab)
    np.testing.assert_array_equal(np.asarray(jout)[0, 0], 199.0)


def test_crop_coverage_rule_follows_the_reference():
    """The reference accepts a crop when the object it covers most keeps
    at least ``min_object_covered`` of its area; MXNet requires every
    object the crop touches to keep more than that. The port follows
    the reference (so seeded crops agree): a crop holding one box whole
    and a sliver of another is accepted."""
    lab = np.full((3, 5), -1.0, np.float32)
    lab[0] = [1, 0.1, 0.1, 0.3, 0.3]        # inside the crop
    lab[1] = [2, 0.45, 0.1, 0.9, 0.3]       # a tenth of it inside
    for mod in (jdet, tdet):
        aug = mod.DetRandomCropAug(min_object_covered=0.5,
                                   min_eject_coverage=0.05)
        assert aug._max_coverage(lab, 0.0, 0.0, 0.5, 0.5) == pytest.approx(
            1.0)
        out = aug._crop_labels(lab, 0.0, 0.0, 0.5, 0.5)
        assert (out[:, 0] >= 0).sum() == 2


def test_label_header_rule_follows_the_reference():
    """``ImageDetIter`` takes flat boxes, (N, 5) rows, or the header form
    ``[2, 5, boxes...]``; MXNet also reads wider headers
    (``[4, 5, w, h, boxes...]``), which both packages refuse."""
    img = np.zeros((8, 8, 3), np.uint8)
    box = [1, 0.1, 0.2, 0.5, 0.6]
    for label in (box, [box], [2, 5] + box + box):
        rows = []
        for mod in (jdet, tdet):
            it = mod.ImageDetIter(1, (3, 8, 8), imglist=[(label, img)],
                                  max_objs=3)
            rows.append(it._samples[0][0])
        np.testing.assert_array_equal(rows[0], rows[1])
        np.testing.assert_array_equal(rows[1][0], np.float32(box))
    for mod in (jdet, tdet):
        with pytest.raises(ValueError, match="multiple of 5"):
            mod.ImageDetIter(1, (3, 8, 8), max_objs=3,
                             imglist=[([4, 5, 8, 8] + box, img)])


def _iters(path=None, imglist=None, batch=4, shape=(3, 32, 32), **kw):
    out = []
    for mod in (jdet, tdet):
        rng = np.random.RandomState(5)
        augs = mod.CreateDetAugmenter(shape, rng=rng, **kw)
        out.append(mod.ImageDetIter(batch, shape, path_imgrec=path,
                                    imglist=imglist, max_objs=4,
                                    shuffle=True, seed=3, aug_list=augs))
    return out


def _same_batches(ji, ti, n):
    for _ in range(n):
        jb, tb = ji.next(), ti.next()
        jd, td = jb.data[0].asnumpy(), tb.data[0].asnumpy()
        assert td.shape == jd.shape and td.dtype == jd.dtype == np.float32
        assert np.abs(td - jd).max() <= RESIZE_TOL * 255
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
        assert tb.pad == jb.pad and ti.getpad() == ji.getpad()
        assert tb.data[0].context == tmx.cpu()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
         mean=(123.68, 116.28, 103.53), std=(58.395, 57.12, 57.375))])
def test_image_det_iter_over_a_rec_matches_the_reference(tmp_path, kw):
    path = _write_rec(tmp_path / "det.rec")
    ji, ti = _iters(path, **kw)
    assert ti.provide_data[0].shape == ji.provide_data[0].shape
    assert ti.provide_label[0].shape == ji.provide_label[0].shape == \
        (4, 4, 5)
    for _ in range(2):                      # two epochs, the last padded
        _same_batches(ji, ti, 3)
        with pytest.raises(StopIteration):
            ti.next()
        ji.reset()
        ti.reset()
    lab = ti.next().label[0].asnumpy()
    real = lab[lab[:, :, 0] >= 0]
    assert len(real) and (real[:, 1:] >= 0).all() and \
        (real[:, 1:] <= 1).all()
    assert (lab[lab[:, :, 0] < 0] == -1).all()


def test_image_det_iter_over_an_imglist_matches_the_reference():
    rs = np.random.RandomState(4)
    imglist = []
    for i in range(6):
        img, lab = _scene(rs, 40, 30, 1 + i % 3)
        imglist.append((lab[lab[:, 0] >= 0], img.astype(np.uint8)))
    ji, ti = _iters(imglist=imglist, rand_mirror=True)
    _same_batches(ji, ti, 2)


def test_ssd_toy_trains_two_steps_on_each_packages_iterator(tmp_path):
    """Two of bench.py's SGD steps on the toy SSD, each package fed by its
    own ``ImageDetIter`` over the same records."""
    path = _write_rec(tmp_path / "toy.rec", n=8, seed=2, classes=2)
    ji, ti = _iters(path, batch=2, shape=(3, 48, 48), rand_mirror=True,
                    rand_crop=0.5, mean=(123.68, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375))
    jnet, tnet = _toys(np.zeros((1, 3, 48, 48), np.float32))
    jgrad = _j_value_and_grad(jnet)
    jp, ja, jnames = _functional_state(jnet, True)
    tp, ta, tnames = _functional_state(tnet, False)
    jo, to = jdp._sgd_init(jp, 0.9), tdp._sgd_init(tp, 0.9)
    for _ in range(2):
        jb, tb = ji.next(), ti.next()
        (jl, _), jg = jgrad(jp, ja, jnp.asarray(jb.data[0].asnumpy()),
                            jnp.asarray(jb.label[0].asnumpy()))
        jp, jo = jdp._sgd_update(jp, jg, jo, jnp.asarray(0.05, jnp.float32),
                                 0.0, 0.9)
        tp, to, tl = _t_sgd_step(tnet, tp, ta, to, tb.data[0]._data,
                                 tb.label[0]._data, 0.05)
        assert np.isfinite(tl) and abs(tl - float(jl)) <= 1e-4 * abs(
            float(jl)), (tl, float(jl))
    for struct, jname in jnames.items():
        if jname in jp:
            _close(tp[tnames[struct]].numpy(), np.asarray(jp[jname]), 1e-4,
                   struct, floor=1.0)
    assert isinstance(tb.data[0]._data, torch.Tensor)
