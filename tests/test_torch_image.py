"""The port's ``image`` and ``nd.image`` against the JAX package's, on
the CPU.

``imdecode`` / ``imread`` (exact: the same libjpeg decode), ``imresize``
(PyTorch's antialiased bilinear against ``jax.image.resize(...,
"linear")``: uint8 within 1 level, which this file measures at most 1 on
a few pixels in a thousand; float32 within 1e-4 on a 0..255 scale,
measured 4.6e-5; nearest exact), the crops, ``color_normalize``,
``copyMakeBorder``, the augmenters with seeded ``random`` and numpy
(one uint8 level of a resize carried through the chain, else exact),
``ImageIter``; the
deterministic ``nd.image`` ops exactly (``adjust_lighting`` and the
jitters' bodies at a fixed factor within 1e-5), the random ones by what
they compute; ``random_crop_flip``: the centre crop equals the
reference's, and each random output is its input's crop at the offsets
drawn, mirrored where drawn.
"""
import random

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimg
from incubator_mxnet_tpu.ndarray import image as jndi
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import image as timg
from incubator_mxnet_tpu_torch.ndarray import image as tndi
from incubator_mxnet_tpu_torch.recordio import (IRHeader, MXIndexedRecordIO,
                                                pack_img)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _img(h=37, w=53, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(
        np.uint8)


def _pair(a, dtype=None):
    return (tmx.nd.array(a, dtype=dtype or a.dtype),
            jmx.nd.array(a, dtype=dtype or a.dtype))


def _eq(t, j):
    t, j = t.asnumpy(), j.asnumpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def _close(t, j, rtol=1e-5):
    t, j = np.asarray(t.asnumpy(), np.float64), np.asarray(j.asnumpy(),
                                                            np.float64)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= rtol * max(np.max(np.abs(j)), 1.0)


# ------------------------------------------------------------ decode, resize
@pytest.mark.parametrize("fmt,flag", [(".jpg", 1), (".png", 1), (".jpg", 0),
                                      (".png", 0)])
def test_imdecode_and_imread_match_the_reference(tmp_path, fmt, flag):
    from incubator_mxnet_tpu_torch.recordio import unpack
    payload = unpack(pack_img(IRHeader(0, 0, 0, 0), _img(), quality=90,
                              img_fmt=fmt))[1]
    t, j = timg.imdecode(payload, flag), jimg.imdecode(payload, flag)
    assert t.shape[2] == (3 if flag else 1)
    _eq(t, j)
    path = tmp_path / f"a{fmt}"
    path.write_bytes(payload)
    _eq(timg.imread(str(path), flag), jimg.imread(str(path), flag))


SIZES = [(37, 53, 20, 30), (20, 30, 37, 53), (64, 64, 32, 48),
         (10, 10, 10, 10), (7, 9, 64, 3)]


@pytest.mark.parametrize("h,w,nh,nw", SIZES)
def test_imresize_matches_jax_image_resize(h, w, nh, nw):
    img = _img(h, w)
    t, j = _pair(img)
    tu = timg.imresize(t, nw, nh).asnumpy().astype(np.int32)
    ju = jimg.imresize(j, nw, nh).asnumpy().astype(np.int32)
    assert tu.shape == ju.shape == (nh, nw, 3)
    diff = np.abs(tu - ju)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    tf, jf = _pair(img.astype(np.float32))
    tr, jr = timg.imresize(tf, nw, nh), jimg.imresize(jf, nw, nh)
    assert tr.dtype == np.float32
    assert np.max(np.abs(tr.asnumpy() - jr.asnumpy())) <= 1e-4 * 255
    _eq(timg.imresize(t, nw, nh, interp=0), jimg.imresize(j, nw, nh,
                                                          interp=0))


def test_resize_short_and_crops_match_the_reference():
    t, j = _pair(_img(40, 60))
    assert timg.resize_short(t, 20).shape == jimg.resize_short(j, 20).shape \
        == (20, 30, 3)
    _eq(timg.fixed_crop(t, 3, 5, 20, 10), jimg.fixed_crop(j, 3, 5, 20, 10))
    tc, tb = timg.center_crop(t, (24, 16))
    jc, jb = jimg.center_crop(j, (24, 16))
    assert tb == jb
    _eq(tc, jc)
    for seed in range(3):
        random.seed(seed)
        tr, tb = timg.random_crop(t, (24, 16))
        random.seed(seed)
        jr, jb = jimg.random_crop(j, (24, 16))
        assert tb == jb
        _eq(tr, jr)
        random.seed(seed)
        ts, tb = timg.random_size_crop(t, (20, 20), 0.3, (0.75, 1.33))
        random.seed(seed)
        js, jb = jimg.random_size_crop(j, (20, 20), 0.3, (0.75, 1.33))
        assert tb == jb and ts.shape == js.shape == (20, 20, 3)
        assert np.max(np.abs(ts.asnumpy().astype(int)
                             - js.asnumpy().astype(int))) <= 1


def test_color_normalize_scale_down_and_border():
    t, j = _pair(_img(8, 9))
    mean, std = np.array([120.0, 110.0, 100.0]), np.array([58.0, 57.0, 57.5])
    _close(timg.color_normalize(t, mean, std),
           jimg.color_normalize(j, mean, std))
    assert timg.scale_down((640, 480), (720, 540)) == \
        jimg.scale_down((640, 480), (720, 540))
    for kind in (0, 1):
        _eq(timg.copyMakeBorder(t, 1, 2, 3, 4, kind, 7.0),
            jimg.copyMakeBorder(j, 1, 2, 3, 4, kind, 7.0))


# --------------------------------------------------------------- augmenters
# each chain with its tolerance: a resize may differ by one uint8 level
# (over the std 57.12 after the normalisation; through three factors of
# at most 1.3 and the lighting in the jitter chain), else float32 noise
AUG_KW = [(dict(resize=40, rand_crop=True, rand_mirror=True, mean=True,
                std=True), 1.0 / 57.12 + 1e-4),
          (dict(rand_crop=True, rand_resize=True, brightness=0.3,
                contrast=0.3, saturation=0.3, hue=0.1, pca_noise=0.1,
                rand_gray=0.5), 2.0),
          (dict(rand_crop=True, rand_mirror=True), 0.0)]


@pytest.mark.parametrize("kw,tol", AUG_KW, ids=["crop", "jitter", "centre"])
def test_create_augmenter_chains_match_the_reference(kw, tol):
    img = _img(48, 56)
    for seed in range(3):
        outs = []
        for mod in (timg, jimg):
            random.seed(seed)
            np.random.seed(seed)
            src = (tmx if mod is timg else jmx).nd.array(img, dtype="uint8")
            for aug in mod.CreateAugmenter((3, 32, 32), **kw):
                src = aug(src)
            outs.append(src)
        assert outs[0].shape == outs[1].shape == (32, 32, 3)
        diff = np.abs(outs[0].asnumpy() - outs[1].asnumpy())
        assert diff.max() <= tol


def test_augmenter_dumps():
    aug = timg.ResizeAug(32)
    assert aug.dumps() == jimg.ResizeAug(32).dumps()


def test_image_iter_over_a_record_file(tmp_path):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = MXIndexedRecordIO(idx, rec, "w")
    for i in range(10):
        w.write_idx(i, pack_img(IRHeader(0, float(i), i, 0),
                                _img(36, 40, seed=i), img_fmt=".png"))
    w.close()
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
              path_imgidx=idx, rand_crop=True, rand_mirror=True,
              shuffle=True)
    outs = []
    for mod in (timg, jimg):
        random.seed(1)
        np.random.seed(1)
        it = mod.ImageIter(**kw)
        outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for b in (it.next(), it.next())])
    for (tx, ty), (jx, jy) in zip(*outs):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


# ----------------------------------------------------------------- nd.image
def test_nd_image_deterministic_ops_match_the_reference():
    img = _img(6, 7)
    for arr in (img, np.stack([img, img[::-1]])):
        t, j = _pair(arr)
        _eq(tndi.to_tensor(t), jndi.to_tensor(j))
        _eq(tndi.flip_left_right(t), jndi.flip_left_right(j))
        _eq(tndi.flip_top_bottom(t), jndi.flip_top_bottom(j))
        tt, jt = tndi.to_tensor(t), jndi.to_tensor(j)
        _eq(tndi.normalize(tt, (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)),
            jndi.normalize(jt, (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)))
        _eq(tndi.normalize(tt, 0.5, 2.0), jndi.normalize(jt, 0.5, 2.0))
        tf, jf = _pair(arr.astype(np.float32))
        _close(tndi.adjust_lighting(tf, [0.1, -0.2, 0.3]),
               jndi.adjust_lighting(jf, [0.1, -0.2, 0.3]))
        for fn in ("_brightness", "_contrast", "_saturation", "_hue"):
            got = getattr(tndi, fn)(tf._data, 0.3).numpy()
            want = np.asarray(getattr(jndi, fn)(jf._data, 0.3))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255,
                                       err_msg=fn)


def test_nd_image_random_ops_compute_what_they_draw():
    tmx.random.seed(5)
    img = _img(5, 6).astype(np.float32)
    x = tmx.nd.array(img)
    flips = set()
    for _ in range(20):
        out = tndi.random_flip_left_right(x).asnumpy()
        assert (out == img).all() or (out == img[:, ::-1]).all()
        flips.add(bool((out == img).all()))
    assert flips == {True, False}
    b = tndi.random_brightness(x, 0.5, 1.5).asnumpy()
    ratio = b[img > 0] / img[img > 0]
    assert np.allclose(ratio, ratio[0], rtol=1e-5) and 0.5 <= ratio[0] <= 1.5
    light = tndi.random_lighting(x, 0.1).asnumpy() - img
    assert np.allclose(light, light[0, 0], atol=1e-4)     # one shift a pixel
    for out in (tndi.random_contrast(x, 0.5, 1.5),
                tndi.random_saturation(x, 0.5, 1.5),
                tndi.random_hue(x, -0.1, 0.1),
                tndi.random_color_jitter(x, 0.2, 0.2, 0.2, 0.05)):
        assert out.shape == x.shape and out.dtype == np.float32
        assert np.isfinite(out.asnumpy()).all()
    tmx.random.seed(5)
    again = tndi.random_flip_left_right(x).asnumpy()
    tmx.random.seed(5)
    np.testing.assert_array_equal(again,
                                  tndi.random_flip_left_right(x).asnumpy())


# --------------------------------------------------------- random_crop_flip
def test_random_crop_flip_centre_equals_the_reference():
    import jax
    x = np.random.RandomState(0).randint(0, 256, (3, 12, 10, 3)).astype(
        np.uint8)
    want = np.asarray(jimg.random_crop_flip(
        jax.numpy.asarray(x), (7, 5), jax.random.PRNGKey(0),
        rand_crop=False, rand_mirror=False))
    got = timg.random_crop_flip(torch.from_numpy(x), (7, 5), None,
                                rand_crop=False, rand_mirror=False)
    np.testing.assert_array_equal(got.numpy(), want)
    nd_got = timg.random_crop_flip(tmx.nd.array(x, dtype="uint8"), (7, 5),
                                   rand_crop=False, rand_mirror=False)
    assert isinstance(nd_got, tmx.nd.NDArray)
    np.testing.assert_array_equal(nd_got.asnumpy(), want)


def test_random_crop_flip_takes_the_crops_it_draws():
    B, H, W, C, th, tw = 16, 12, 10, 3, 7, 5
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (B, H, W, C)).astype(np.uint8))
    g = torch.Generator()
    g.manual_seed(7)
    state = g.get_state()
    out = timg.random_crop_flip(x, (th, tw), g)
    assert out.shape == (B, th, tw, C) and out.dtype == torch.uint8
    g.set_state(state)
    oh = torch.randint(0, H - th + 1, (B,), generator=g)
    ow = torch.randint(0, W - tw + 1, (B,), generator=g)
    flip = torch.rand((B,), generator=g) < 0.5
    assert 0 < int(flip.sum()) < B
    for b in range(B):
        crop = x[b, oh[b]:oh[b] + th, ow[b]:ow[b] + tw]
        if flip[b]:
            crop = crop.flip(1)
        assert torch.equal(out[b], crop), b
    g.set_state(state)
    assert torch.equal(timg.random_crop_flip(x, (th, tw), g), out)
    with pytest.raises(ValueError, match="larger than input"):
        timg.random_crop_flip(x, (H + 1, tw), g)
    with pytest.raises(TypeError):
        timg.random_crop_flip(x, (th, tw), 3)


def test_detection_input_names_its_roadmap_item():
    """The detection input (ROADMAP.md A6) is ported: its names resolve
    to ``image.detection``'s, as in the reference."""
    from incubator_mxnet_tpu_torch.image import detection as tdet
    for name in ("ImageDetIter", "CreateDetAugmenter"):
        assert getattr(timg, name) is getattr(tdet, name)
        assert hasattr(jimg, name)
    assert timg.detection is tdet
    with pytest.raises(AttributeError):
        timg.no_such_thing
