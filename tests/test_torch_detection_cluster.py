"""The cluster kernels' algorithms (``ops/cuda/detection.py``
``multibox_match_split`` and ``nms_keep_blocked``, plain models of
``match_cluster_kernel`` and ``nms_cluster_kernel`` in ``detection.cu``)
against the plain twins and the Pallas kernels of
``incubator_mxnet_tpu/ops/pallas/detection.py`` in interpret mode, on the
CPU, and the kernels' plans against the source.

Tolerances: against the twins, every output equal (the models compute the
same IoU and encoding); against the Pallas kernels, ``anchor_gt`` and
``keep`` exact, ``anchor_iou`` within 1e-6 and ``loc_t`` within 1e-5 (a
log, and the reference's jitted arithmetic may round differently). The
kernels themselves run on the card only (``chip_smoke.py`` phase 20).
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.ops.pallas import detection as pallas_det
from incubator_mxnet_tpu_torch.ops.cuda import detection as kdet
from test_torch_detection import MATCH_CASES, VAR, _nms_case, _ssd_case

SPLITS = (1, 2, 3, 4, 8)
SOURCE = (Path(kdet.__file__).resolve().parent / "csrc"
          / "detection.cu").read_text()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(autouse=True)
def _pallas_on(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "multibox_target,nms")


def _match_inputs(case):
    shape = dict(MATCH_CASES[case])
    thr = shape.pop("thr", 0.5)
    anchor, lab, _ = _ssd_case(**shape)
    if case.startswith("basic"):
        lab[1] = -1.0                                   # an all-padding row
    return anchor[0], lab, thr


@functools.lru_cache(maxsize=None)
def _pallas_match(case):
    anchor, lab, thr = _match_inputs(case)
    return tuple(np.asarray(x) for x in pallas_det.multibox_match(
        jnp.asarray(anchor), jnp.asarray(lab), thr, VAR))


def _assert_match(got, want, pallas=None):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_np(g), _np(w))
    if pallas is not None:
        np.testing.assert_array_equal(_np(got[0]), pallas[0])
        np.testing.assert_allclose(_np(got[1]), pallas[1], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(got[2]), pallas[2], rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------ the S-way split matcher
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_split_matcher_equals_twin_and_pallas_kernel(case, split):
    anchor, lab, thr = _match_inputs(case)
    got = kdet.multibox_match_split(_t(anchor), _t(lab), thr, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor), _t(lab), thr, VAR)
    _assert_match(got, want, _pallas_match(case))


def _boxes_case(N, M):
    """Anchors far from one another and from the labels' boxes (IoU 0),
    labels (1, M, 5) with M distinct boxes."""
    anchor = np.zeros((N, 4), np.float32)
    for a in range(N):
        anchor[a] = [2.0 + a, 2.0, 2.5 + a, 2.5]
    lab = np.full((1, M, 5), -1.0, np.float32)
    for g in range(M):
        lab[0, g] = [g % 3, 0.1 * g, 0.0, 0.1 * g + 0.3, 0.4]
    return anchor, lab


@pytest.mark.parametrize("split", SPLITS)
def test_split_matcher_tie_across_slices_takes_the_smaller_flat_index(split):
    """Labels A, B, C, each IoU 1 with an anchor: A with anchor 9 (the last
    slice), B with anchor 1 (the first), C with anchors 2 and 8 (two
    slices). g N + a puts label A first although its anchor lies in a
    later slice; C's tie goes to anchor 2, and anchor 8 takes C in stage
    2."""
    anchor, lab = _boxes_case(N=10, M=3)
    lab[0, :, 1:] = [[0.0, 0.0, 0.25, 0.25], [0.0, 0.5, 0.25, 0.75],
                     [0.5, 0.5, 0.75, 0.75]]
    anchor[9], anchor[1] = lab[0, 0, 1:], lab[0, 1, 1:]
    anchor[2] = anchor[8] = lab[0, 2, 1:]
    got = kdet.multibox_match_split(_t(anchor), _t(lab), 0.5, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor), _t(lab), 0.5, VAR)
    _assert_match(got, want)
    agt = _np(got[0])[0]
    assert agt.tolist() == [-1, 1, 2, -1, -1, -1, -1, -1, 2, 0]
    pallas = pallas_det.multibox_match(jnp.asarray(anchor),
                                       jnp.asarray(lab), 0.5, VAR)
    np.testing.assert_array_equal(agt, np.asarray(pallas[0])[0])


@pytest.mark.parametrize("split", SPLITS)
def test_split_matcher_equal_ious_in_two_slices(split):
    """Two anchors in different slices with the same IoU (1/3, exact in
    binary) to one label: the smaller anchor index wins the round,
    whichever slice reports first."""
    anchor, lab = _boxes_case(N=16, M=1)
    lab[0, 0] = [1, 0.25, 0.25, 0.75, 0.75]
    anchor[3] = [0.0, 0.25, 0.5, 0.75]               # shifted left
    anchor[12] = [0.5, 0.25, 1.0, 0.75]              # shifted right
    got = kdet.multibox_match_split(_t(anchor), _t(lab), 0.9, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor), _t(lab), 0.9, VAR)
    _assert_match(got, want)
    assert _np(got[0])[0].tolist() == [-1] * 3 + [0] + [-1] * 12
    assert _np(got[1])[0, 3] == 1.0
    assert _np(got[1])[0, 12] == np.float32(0.125) / np.float32(0.375)


@pytest.mark.parametrize("split", SPLITS)
def test_split_matcher_stops_at_a_round_that_commits_nothing(split):
    """No label overlaps any anchor: the first round commits nothing and
    ends the loop; every anchor is unmatched with IoU 0."""
    anchor, lab = _boxes_case(N=12, M=4)
    got = kdet.multibox_match_split(_t(anchor), _t(lab), 0.5, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor), _t(lab), 0.5, VAR)
    _assert_match(got, want)
    assert (_np(got[0]) == -1).all() and (_np(got[1]) == 0).all()


@pytest.mark.parametrize("split", SPLITS)
def test_split_matcher_walk_stops_at_a_stale_label(split):
    """Boxes on one row, so the IoU is the intervals': labels L0 [0, 4],
    L1 [1.5, 5.5], L2 [7.5, 9.5]; anchors A [0, 4] (index 2) and Q [4, 8]
    (index 9). L0 and L1 both best at A (1 and 0.45), L2 at Q (0.09). L0
    takes A and makes L1 stale; L2's 0.09 is below L1's old 0.45, so the
    walk stops: after the rescan L1 takes Q (0.23), and L2 goes
    unmatched. A walk that went on would have given Q to L2."""
    anchor, lab = _boxes_case(N=12, M=3)
    lab[0, :, 1:] = [[0.0, 0.0, 4.0, 1.0], [1.5, 0.0, 5.5, 1.0],
                     [7.5, 0.0, 9.5, 1.0]]
    anchor[2] = [0.0, 0.0, 4.0, 1.0]
    anchor[9] = [4.0, 0.0, 8.0, 1.0]
    got = kdet.multibox_match_split(_t(anchor), _t(lab), 0.5, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor), _t(lab), 0.5, VAR)
    _assert_match(got, want)
    assert _np(got[0])[0].tolist() == [-1, -1, 0] + [-1] * 6 + [1, -1, -1]


@pytest.mark.parametrize("split", SPLITS)
def test_split_matcher_rescans_only_the_owning_slice(split):
    """Many labels share one best anchor (duplicate label boxes): each round
    takes it from the owner's candidates, and the next best of every other
    label comes from the owner's rescan; all ten rounds commit."""
    anchor, lab, _ = _ssd_case(B=2, N=40, M=10, fill=10, dup=True, seed=3)
    got = kdet.multibox_match_split(_t(anchor[0]), _t(lab), 0.5, VAR, split)
    want = kdet.multibox_match_reference(_t(anchor[0]), _t(lab), 0.5, VAR)
    _assert_match(got, want)
    assert ((_np(got[1]) == 1.0).sum(axis=1) == 10).all()


# ---------------------------------------------- the word-blocked sweep
NMS_CASES = [(8, False, 0), (37, True, 5), (63, False, 3), (64, True, 0),
             (65, True, 7), (100, True, 9), (127, False, 0),
             (129, True, 16), (200, False, 25)]


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k,ties,pad", NMS_CASES)
def test_blocked_sweep_equals_twin_and_pallas_kernel(k, ties, pad, force):
    boxes, ids, valid = _nms_case(2, k, seed=k + 1, ties=ties, pad=pad)
    got = kdet.nms_keep_blocked(_t(boxes), _t(ids), _t(valid), 0.45, force)
    want = kdet.nms_keep_reference(_t(boxes), _t(ids), _t(valid), 0.45,
                                   force)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), _np(want))
    pallas = pallas_det.nms_keep(jnp.asarray(boxes), jnp.asarray(ids),
                                 jnp.asarray(valid), 0.45, force)
    np.testing.assert_array_equal(_np(got), np.asarray(pallas))


def _edge_case(k):
    """Boxes that overlap nothing, then duplicates across the word edges:
    rows 62, 63 -> 64 (63 is suppressed by 62, so 64 is suppressed by 62,
    not 63); 64 -> 127 and 128 (a kept first row of a word suppresses the
    last row of its word and the first of the next); 31 -> 32 (the halves
    of a word); 95 not valid with a duplicate at 96 (kept: an invalid row
    never suppresses); ids 0 and 1 alternate on rows 140..143, duplicates."""
    boxes = np.zeros((1, k, 4), np.float32)
    for i in range(k):
        boxes[0, i] = [i * 1.0, 0.0, i + 0.5, 0.5]
    ids = np.zeros((1, k), np.float32)
    valid = np.ones((1, k), bool)
    for dup in ((62, 63, 64), (64, 127, 128), (31, 32), (95, 96),
                (140, 141, 142, 143)):
        for j in dup[1:]:
            if j < k:
                boxes[0, j] = boxes[0, dup[0]]
    valid[0, 95] = False
    ids[0, 140:144] = [0, 1, 0, 1][:max(0, k - 140)]
    return boxes, ids, valid


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k", [97, 129, 150])
def test_blocked_sweep_at_word_edges(k, force):
    boxes, ids, valid = _edge_case(k)
    got = _np(kdet.nms_keep_blocked(_t(boxes), _t(ids), _t(valid), 0.5,
                                    force))[0]
    want = kdet.nms_keep_reference(_t(boxes), _t(ids), _t(valid), 0.5,
                                   force)
    np.testing.assert_array_equal(got, _np(want)[0])
    pallas = pallas_det.nms_keep(jnp.asarray(boxes), jnp.asarray(ids),
                                 jnp.asarray(valid), 0.5, force)
    np.testing.assert_array_equal(got, np.asarray(pallas)[0])
    assert got[62] and not got[63] and not got[64]
    assert got[31] and not got[32] and not got[95] and got[96]
    if k > 128:
        assert not got[127] and not got[128]
    if k > 143:
        assert got[140] and got[141] != force
        assert not got[142] and not got[143]


# ------------------------------------------------------------ the plans
def _source_int(name):
    m = re.search(rf"constexpr \w+ {name} = ([\d *]+);", SOURCE)
    return eval(m.group(1))      # a product of literals


def test_plans_follow_the_source():
    assert kdet._SMEM_BUDGET == _source_int("kSmemBudget") == 226 * 1024
    assert kdet._MAX_SPLIT == _source_int("kMaxSplit") == 8
    assert _source_int("kLabelInts") == 10
    assert ("const size_t s = (size_t)chunk * 20 + (size_t)M * (20 + 4 * "
            "kLabelInts);") in SOURCE
    assert "return mode == 2 ? s + (size_t)chunk * M * 4 : s;" in SOURCE
    assert "if (mode >= 1) s += (size_t)k * 24;" in SOURCE
    assert "if (mode == 2) s += (size_t)k * W * 8;" in SOURCE


@pytest.mark.parametrize("batch,split", [(1, 8), (4, 8), (8, 8), (16, 8),
                                         (20, 4), (32, 4), (40, 2), (66, 2),
                                         (67, 1), (500, 1)])
def test_cluster_split_fills_an_h100(batch, split):
    assert kdet.cluster_split(batch, 132) == split


def test_match_plan_keeps_the_lane_slices_in_shared_memory():
    # the SSD lane, 32 labels an image, the Gluon step: slice kept
    assert kdet.match_plan(32, 5630, 1, 132) == (4, 1408, 2, 33852)
    split, chunk, mode, smem = kdet.match_plan(32, 5630, 32, 132)
    assert (split, chunk, mode) == (4, 1408, 2)
    assert smem == 1408 * 20 + 32 * 60 + 1408 * 32 * 4 <= 226 * 1024
    assert kdet.match_plan(4, 5630, 1, 132)[:3] == (8, 704, 2)
    # the slice does not fit: recomputed; the labels do not: scratch
    assert kdet.match_plan(32, 5630, 100, 132)[2] == 1
    assert kdet.match_plan(2, 20, 17500, 132) == (8, 3, 0, 0)
    assert kdet.match_plan(2, 20000, 4, 132)[:3] == (8, 2500, 2)


def test_nms_plan_keeps_the_eval_point_mask_in_shared_memory():
    split, W, mode, smem = kdet.nms_plan(32, 400, 132)
    assert (split, W, mode) == (4, 7, 2)
    assert 400 * 7 * 8 == 22400 and smem == 56 + 400 * 24 + 22400
    assert kdet.nms_plan(32, 1024, 132)[2] == 2
    assert kdet.nms_plan(32, 5630, 132)[2] == 1
    assert kdet.nms_plan(1, 200000, 132)[2] == 0
    with pytest.raises(ValueError, match="removed set"):
        kdet.nms_plan(1, 2 ** 22, 132)


# ----------------------------------------------------- the wrappers
def test_both_routes_refuse_cpu_tensors_and_unknown_routes():
    anchor, lab, _ = _ssd_case(B=1, N=16, M=2)
    boxes, ids, valid = _nms_case(1, 8, seed=1)
    for route in (None, "simple"):
        with pytest.raises(ValueError, match="CUDA"):
            kdet.multibox_match(_t(anchor[0]), _t(lab), 0.5, VAR,
                                _route=route)
        with pytest.raises(ValueError, match="CUDA"):
            kdet.nms_keep(_t(boxes), _t(ids), _t(valid), 0.5, False,
                          _route=route)
    with pytest.raises(ValueError, match="_route"):
        kdet.multibox_match(_t(anchor[0]), _t(lab), 0.5, VAR, _route="old")
    with pytest.raises(ValueError, match="_route"):
        kdet.nms_keep(_t(boxes), _t(ids), _t(valid), 0.5, False,
                      _route="old")
    assert kdet.multibox_match.launches == kdet.nms_keep.launches == 0
    assert kdet.multibox_match.sm90_launches == 0
    assert kdet.nms_keep.sm90_launches == 0


def test_sass_check_names_the_cluster_kernels():
    """``chip_smoke._det_kernel_name`` reads the template argument of the
    cluster kernels from their mangled names (as ptxas printed them for an
    H100 build) and names no other kernel of detection.cu."""
    import chip_smoke
    pre = "_ZN38_GLOBAL__N__b6709f3d_6_det_cu_8cd7114e"
    names = {pre + "20match_cluster_kernelILb1EEEvNS_16ClusterMatchArgsE":
             "match_cluster_kernel<1>",
             pre + "18nms_cluster_kernelILi2EEEvNS_14ClusterNmsArgsE":
             "nms_cluster_kernel<2>",
             "_ZN12_GLOBAL__N_120match_cluster_kernelILb0EEEvNS_16Cluster"
             "MatchArgsE": "match_cluster_kernel<0>",
             "_ZN12_GLOBAL__N_121multibox_match_kernelENS_9MatchArgsE": None,
             "_ZN12_GLOBAL__N_115nms_mask_kernelEPKfS1_iifiPy": None}
    for mangled, want in names.items():
        assert chip_smoke._det_kernel_name(mangled) == want
