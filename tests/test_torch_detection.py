"""The port's detection ops (``incubator_mxnet_tpu_torch/ops/detection.py``)
and the plain twins of its B9 kernels (``ops/cuda/detection.py``) against
the JAX package, on the CPU.

The twins are held against the Pallas kernels of
``incubator_mxnet_tpu/ops/pallas/detection.py`` run in interpret mode
(``MXTPU_PALLAS=multibox_target,nms``, as ``tests/test_pallas_kernels.py``
runs them), and every function of ``ops/detection.py`` against the
reference's. The same numpy inputs from a seed go to both. Tolerances:
``anchor_gt``, ``cls_target``, ``box_mask``, the NMS keep mask and the
surviving ids exact; ``anchor_iou`` and boxes within 1e-6; ``loc_t`` and
the encoded targets within 1e-5 (a log, and the reference's jitted
arithmetic may round differently). The kernels themselves run on the card
only (``chip_smoke.py`` phases 20-22).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.ops import detection as jdet
from incubator_mxnet_tpu.ops.pallas import detection as pallas_det
from incubator_mxnet_tpu_torch.ops import detection as tdet
from incubator_mxnet_tpu_torch.ops.cuda import detection as kdet

VAR = (0.1, 0.1, 0.2, 0.2)


@pytest.fixture(autouse=True)
def _pallas_on(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "multibox_target,nms")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _ssd_case(B=2, N=64, M=4, C=5, seed=0, fill=None, dup=False):
    """Anchors (1, N, 4), labels (B, M, 5) with a random number of objects
    per row (``fill`` rows when given), logits (B, C+1, N). ``dup`` copies
    the first anchor and the first label over others, forcing ties."""
    rs = np.random.RandomState(seed)
    anchor = np.sort(rs.rand(1, N, 4).astype(np.float32), axis=-1)
    lab = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        for m in range(fill if fill is not None else rs.randint(1, M + 1)):
            x0, y0 = rs.rand(2) * 0.5
            w, h = 0.15 + rs.rand(2) * 0.3
            lab[b, m] = [rs.randint(C), x0, y0, x0 + w, y0 + h]
    if dup:
        anchor[0, 1::3] = anchor[0, 0]
        lab[:, 1:, 1:] = np.where(lab[:, 1:, :1] >= 0, lab[:, :1, 1:],
                                  lab[:, 1:, 1:])
        anchor[0, 2] = lab[0, 0, 1:]
    logits = rs.randn(B, C + 1, N).astype(np.float32)
    return anchor, lab, logits


# ------------------------------------------------------------ the twins
MATCH_CASES = {
    "basic": dict(B=2, N=64, M=4),
    "basic_thr_0.7": dict(B=2, N=64, M=4, thr=0.7),
    "single_label": dict(B=2, N=64, M=1),
    "unaligned_61": dict(B=2, N=61, M=4),
    "full_rows": dict(B=3, N=40, M=8, fill=8),
    "ties": dict(B=2, N=48, M=5, fill=5, dup=True),
    "ties_thr_0.7": dict(B=2, N=48, M=5, fill=5, dup=True, thr=0.7),
    "labels_outnumber_anchors": dict(B=2, N=6, M=9, fill=9),
    "ssd512_anchor_count": dict(B=1, N=5630, M=2, fill=2),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_twin_equals_pallas_kernel(case):
    shape = dict(MATCH_CASES[case])
    thr = shape.pop("thr", 0.5)
    anchor, lab, _ = _ssd_case(**shape)
    if case.startswith("basic"):
        lab[1] = -1.0                                   # an all-padding row
    agt, aiou, loc = pallas_det.multibox_match(
        jnp.asarray(anchor[0]), jnp.asarray(lab), thr, VAR)
    tg, ti, tl = kdet.multibox_match_reference(_t(anchor[0]), _t(lab), thr,
                                               VAR)
    assert tg.dtype == torch.int32
    np.testing.assert_array_equal(_np(tg), np.asarray(agt))
    np.testing.assert_allclose(_np(ti), np.asarray(aiou), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tl), np.asarray(loc), rtol=1e-5,
                               atol=1e-5)
    if case.startswith("basic"):
        assert (_np(tg)[1] == -1).all()


def test_match_twin_equals_the_reference_match_and_encoding():
    """The twin is ``_match_anchors`` and ``_encode_loc`` of the reference,
    row by row (the XLA path of ``multibox_target``)."""
    anchor, lab, _ = _ssd_case(B=2, N=32, M=3, seed=7, dup=True)
    tg, ti, tl = kdet.multibox_match_reference(_t(anchor[0]), _t(lab), 0.5,
                                               VAR)
    anc = jnp.asarray(anchor[0])
    for b in range(2):
        lb = jnp.asarray(lab[b])
        valid = lb[:, 0] >= 0
        iou_t = jdet.box_iou(lb[:, 1:5], anc) * valid[:, None]
        agt, aiou = jdet._match_anchors(iou_t, valid, 0.5)
        loc = jdet._encode_loc(anc, lb[jnp.maximum(agt, 0)][:, 1:5], VAR)
        loc = jnp.where((agt >= 0)[:, None], loc, 0.0)
        np.testing.assert_array_equal(_np(tg[b]), np.asarray(agt))
        np.testing.assert_allclose(_np(ti[b]), np.asarray(aiou), atol=1e-6)
        np.testing.assert_allclose(_np(tl[b]), np.asarray(loc), rtol=1e-5,
                                   atol=1e-5)
        # the port's own helpers, one row at a time
        valid_t = _t(lab[b])[:, 0] >= 0
        iou_p = tdet.box_iou(_t(lab[b])[:, 1:5], _t(anchor[0])) \
            * valid_t[:, None]
        pg, pi = tdet._match_anchors(iou_p, valid_t, 0.5)
        np.testing.assert_array_equal(_np(pg), _np(tg[b]))
        np.testing.assert_array_equal(_np(pi), _np(ti[b]))


def _nms_case(B, k, seed, ties=False, pad=0):
    rs = np.random.RandomState(seed)
    xy = rs.rand(B, k, 2).astype(np.float32) * 0.7
    wh = 0.1 + rs.rand(B, k, 2).astype(np.float32) * 0.3
    boxes = np.concatenate([xy, xy + wh], -1)
    ids = rs.randint(0, 3, (B, k)).astype(np.float32)
    valid = rs.rand(B, k) > 0.1
    if ties:
        boxes[:, 1::4] = boxes[:, 0:1]                 # duplicates: IoU 1
    if pad:
        boxes[:, -pad:] = 0.0
        ids[:, -pad:] = -1.0
        valid[:, -pad:] = False
    return boxes, ids, valid


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k,ties,pad", [(8, False, 0), (37, True, 5),
                                        (64, False, 0), (100, True, 9)])
def test_nms_twin_equals_pallas_kernel(k, ties, pad, force):
    boxes, ids, valid = _nms_case(2, k, seed=k, ties=ties, pad=pad)
    want = pallas_det.nms_keep(jnp.asarray(boxes), jnp.asarray(ids),
                               jnp.asarray(valid), 0.45, force)
    got = kdet.nms_keep_reference(_t(boxes), _t(ids), _t(valid), 0.45,
                                  force)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_twins_take_no_gradient():
    anchor, lab, _ = _ssd_case(B=1, N=16, M=2)
    a = _t(anchor[0]).requires_grad_(True)
    out = kdet.multibox_match_reference(a, _t(lab), 0.5, VAR)
    assert not any(t.requires_grad for t in out)
    boxes, ids, valid = _nms_case(1, 8, seed=1)
    b = _t(boxes).requires_grad_(True)
    assert not kdet.nms_keep_reference(b, _t(ids), _t(valid), 0.5,
                                       False).requires_grad


def test_kernel_wrappers_refuse_cpu_tensors():
    anchor, lab, _ = _ssd_case(B=1, N=16, M=2)
    with pytest.raises(ValueError, match="CUDA"):
        kdet.multibox_match(_t(anchor[0]), _t(lab), 0.5, VAR)
    boxes, ids, valid = _nms_case(1, 8, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        kdet.nms_keep(_t(boxes), _t(ids), _t(valid), 0.5, False)
    assert kdet.multibox_match.launches == 0
    assert kdet.nms_keep.launches == 0
    with pytest.raises(ValueError, match="at least one"):
        kdet.multibox_match_reference(_t(anchor[0]), _t(lab[:, :0]), 0.5,
                                      VAR)


# ------------------------------------------------------ multibox_target
TARGET_CASES = {
    "no_mining": (dict(), dict()),
    "mining": (dict(), dict(negative_mining_ratio=3.0,
                            minimum_negative_samples=2)),
    "single_label": (dict(M=1), dict(negative_mining_ratio=3.0)),
    "all_padding_row": (dict(), dict(negative_mining_ratio=3.0)),
    "unaligned_61": (dict(N=61), dict(negative_mining_ratio=3.0)),
    "ties": (dict(N=48, M=5, fill=5, dup=True),
             dict(negative_mining_ratio=3.0, overlap_threshold=0.3)),
    "ssd512_anchor_count": (dict(B=1, N=5630, M=2, fill=2),
                            dict(negative_mining_ratio=3.0)),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_matches_reference(case):
    shape, kw = TARGET_CASES[case]
    anchor, lab, logits = _ssd_case(**shape)
    if case == "all_padding_row":
        lab[0] = -1.0
    want = jdet.multibox_target(jnp.asarray(anchor), jnp.asarray(lab),
                                jnp.asarray(logits), **kw)
    got = tdet.multibox_target(_t(anchor), _t(lab), _t(logits), **kw)
    names = ("box_target", "box_mask", "cls_target")
    for g, w, name in zip(got, want, names):
        assert g.dtype == torch.float32, name
        assert tuple(g.shape) == tuple(w.shape), name
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    if case == "all_padding_row":
        assert _np(got[1])[0].sum() == 0.0


def test_multibox_target_takes_no_gradient():
    anchor, lab, logits = _ssd_case()
    lg = _t(logits).requires_grad_(True)
    with torch.enable_grad():
        out = tdet.multibox_target(_t(anchor), _t(lab), lg,
                                   negative_mining_ratio=3.0)
    assert not any(t.requires_grad for t in out)


# ---------------------------------------------- detection and box_nms
def _det_inputs(B=2, C=4, N=30, seed=3):
    anchor, _, _ = _ssd_case(N=N)
    rs = np.random.RandomState(seed)
    cls_prob = np.asarray(jax.nn.softmax(
        jnp.asarray(rs.randn(B, C + 1, N).astype(np.float32)), axis=1))
    loc_pred = rs.randn(B, N * 4).astype(np.float32) * 0.1
    return anchor, cls_prob, loc_pred


def _assert_detections(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])     # ids
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("topk,force", [(20, False), (10, True),
                                        (-1, False), (-1, True)])
def test_multibox_detection_matches_reference(topk, force):
    anchor, cls_prob, loc_pred = _det_inputs()
    want = jdet.multibox_detection(jnp.asarray(cls_prob),
                                   jnp.asarray(loc_pred),
                                   jnp.asarray(anchor), nms_topk=topk,
                                   force_suppress=force)
    got = tdet.multibox_detection(_t(cls_prob), _t(loc_pred), _t(anchor),
                                  nms_topk=topk, force_suppress=force)
    _assert_detections(got, want)


def test_multibox_detection_without_nms_and_unclipped():
    anchor, cls_prob, loc_pred = _det_inputs(seed=5)
    kw = dict(nms_threshold=0.0, clip=False, threshold=0.3)
    want = jdet.multibox_detection(jnp.asarray(cls_prob),
                                   jnp.asarray(loc_pred),
                                   jnp.asarray(anchor), **kw)
    got = tdet.multibox_detection(_t(cls_prob), _t(loc_pred), _t(anchor),
                                  **kw)
    _assert_detections(got, want)


@pytest.mark.parametrize("id_index,topk,force", [(-1, 9, False),
                                                 (0, 9, False),
                                                 (0, -1, True)])
def test_box_nms_matches_reference(id_index, topk, force):
    rs = np.random.RandomState(4)
    data = rs.rand(2, 3, 25, 6).astype(np.float32)
    data[..., 0] = rs.randint(0, 3, data.shape[:-1])
    kw = dict(overlap_thresh=0.45, valid_thresh=0.1, topk=topk,
              coord_start=2, score_index=1, id_index=id_index,
              force_suppress=force)
    want = jdet.box_nms(jnp.asarray(data), **kw)
    got = tdet.box_nms(_t(data), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------- the other functions
@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5)),
    dict(sizes=(0.37, 0.447), ratios=(1, 2, 0.5, 3, 1 / 3), clip=True),
    dict(sizes=(0.2,), ratios=(1.0,), steps=(0.3, 0.2), offsets=(0.2, 0.7)),
])
def test_multibox_prior_matches_reference(kw):
    for h, w in ((4, 4), (3, 5)):
        want = jdet.multibox_prior(h, w, **kw)
        got = tdet.multibox_prior(h, w, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_reference(fmt):
    rs = np.random.RandomState(2)
    lhs = rs.rand(2, 5, 4).astype(np.float32)
    rhs = rs.rand(2, 7, 4).astype(np.float32)
    if fmt == "corner":
        lhs[..., 2:] += lhs[..., :2]
        rhs[..., 2:] += rhs[..., :2]
    want = jdet.box_iou(jnp.asarray(lhs), jnp.asarray(rhs), fmt=fmt)
    got = tdet.box_iou(_t(lhs), _t(rhs), fmt=fmt)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_encode_and_decode_loc_match_reference():
    anchor, lab, _ = _ssd_case(B=1, N=20, M=20, fill=20)
    gt = lab[0, :, 1:5]
    want = jdet._encode_loc(jnp.asarray(anchor[0]), jnp.asarray(gt), VAR)
    got = tdet._encode_loc(_t(anchor[0]), _t(gt), VAR)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for clip in (True, False):
        boxes = jdet._decode_loc(jnp.asarray(anchor[0]), want, VAR, clip)
        back = tdet._decode_loc(_t(anchor[0]), got, VAR, clip)
        np.testing.assert_allclose(_np(back), np.asarray(boxes), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_np(back), gt, rtol=1e-5, atol=1e-5)


def test_nms_loop_matches_reference():
    boxes, ids, valid = _nms_case(1, 30, seed=8, ties=True)
    scores = np.sort(np.random.RandomState(0).rand(30))[::-1].astype(
        np.float32)
    for topk in (12, -1):
        want = jdet._nms_loop(jnp.asarray(boxes[0]), jnp.asarray(ids[0]),
                              jnp.asarray(scores), jnp.asarray(valid[0]),
                              0.5, False, topk)
        got = tdet._nms_loop(_t(boxes[0]), _t(ids[0]), _t(scores.copy()),
                             _t(valid[0]), 0.5, False, topk)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_roi_align_matches_reference():
    rs = np.random.RandomState(3)
    data = rs.rand(2, 3, 12, 10).astype(np.float32)
    rois = np.array([[0, 1.0, 1.5, 7.0, 9.0], [1, 0.0, 0.0, 9.5, 11.5],
                     [1, 3.2, 2.1, 4.0, 3.0]], np.float32)
    for sr in (-1, 3):
        want = jdet.roi_align(jnp.asarray(data), jnp.asarray(rois), (3, 2),
                              0.5, sr)
        got = tdet.roi_align(_t(data), _t(rois), (3, 2), 0.5, sr)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("hw", [(7, 9), (3, 3), (1, 4)])
def test_bilinear_resize2d_matches_reference(hw):
    data = np.random.RandomState(5).rand(2, 3, 5, 6).astype(np.float32)
    want = jdet.bilinear_resize2d(jnp.asarray(data), *hw)
    got = tdet.bilinear_resize2d(_t(data), *hw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("out", [(2, 3), (5, 4), (1, 1)])
def test_adaptive_avg_pool2d_matches_reference(out):
    data = np.random.RandomState(6).rand(2, 3, 7, 9).astype(np.float32)
    want = jdet.adaptive_avg_pool2d(jnp.asarray(data), out)
    got = tdet.adaptive_avg_pool2d(_t(data), out)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
