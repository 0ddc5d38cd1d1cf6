"""The port's ``nd.contrib`` vision ops against the JAX package's, on the
CPU: ``ROIAlign``, ``BilinearResize2D``, ``AdaptiveAvgPooling2D``,
``DeformableConvolution``, ``PSROIPooling`` and ``Proposal``, one case
each, with the harness and tolerances of ``test_torch_contrib.py`` (values
1e-5, relative above 1; gradients of sum(out * w) under
``autograd.record()`` 1e-4)."""
import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from test_torch_contrib import _assert_close, _f, _run


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "nms")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


IMG = _f(2, 3, 10, 12, seed=9, lo=0, hi=1)
ROIS = np.array([[0, 1.0, 1.5, 7.0, 9.0], [1, 0.0, 0.0, 9.5, 11.5]],
                np.float32)
PS_X = _f(1, 2 * 3 * 3, 8, 8, seed=10)
PS_ROIS = np.array([[0, 0.6, 1.2, 5.4, 6.7], [0, 2.0, 0.0, 7.2, 3.3]],
                   np.float32)
# Proposal: 2 scales x 1 ratio = 2 anchors per pixel, a 4 x 4 map
PR_CLS = _f(1, 4, 4, 4, seed=11, lo=0, hi=1)
PR_BOX = _f(1, 8, 4, 4, seed=12) * 0.2
PR_INFO = np.array([[64.0, 64.0, 1.0]], np.float32)

# name -> (inputs, fn(nd, *arrays), differentiable)
CASES = {
    "ROIAlign": ([IMG, ROIS], lambda nd, d, r: nd.contrib.ROIAlign(
        d, r, (3, 2), 0.5), True),
    "BilinearResize2D": ([IMG], lambda nd, d: nd.contrib.BilinearResize2D(
        d, 7, 5), True),
    "AdaptiveAvgPooling2D": ([IMG], lambda nd, d:
                             nd.contrib.AdaptiveAvgPooling2D(d, (4, 5)),
                             True),
    "AdaptiveAvgPooling2D_int": ([IMG], lambda nd, d:
                                 nd.contrib.AdaptiveAvgPooling2D(d, 3),
                                 True),
    "DeformableConvolution": (
        [_f(2, 4, 6, 6), _f(2, 2 * 2 * 9, 4, 4, seed=1) * 0.7,
         _f(3, 4, 3, 3, seed=2), _f(3, seed=3)],
        lambda nd, x, o, w, b: nd.contrib.DeformableConvolution(
            x, o, w, b, kernel=(3, 3), num_filter=3,
            num_deformable_group=2), True),
    "PSROIPooling": ([PS_X, PS_ROIS], lambda nd, x, r:
                     nd.contrib.PSROIPooling(x, r, output_dim=2,
                                             pooled_size=3,
                                             spatial_scale=1.0), True),
    "Proposal": ([PR_CLS, PR_BOX, PR_INFO], lambda nd, c, b, i:
                 nd.contrib.Proposal(c, b, i, feature_stride=16,
                                     scales=(2, 4), ratios=(1,),
                                     rpn_pre_nms_top_n=20,
                                     rpn_post_nms_top_n=6, threshold=0.5,
                                     rpn_min_size=4, output_score=True),
                 False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_contrib_vision_op_matches_jax(name):
    inputs, fn, grad = CASES[name]
    jouts, jgrads = _run(jmx, inputs, fn, grad)
    touts, tgrads = _run(tmx, inputs, fn, grad)
    assert len(touts) == len(jouts)
    for (t, tdt), (j, jdt) in zip(touts, jouts):
        assert tdt == jdt, (tdt, jdt)
        _assert_close(t, j, 1e-5)
    assert len(tgrads) == len(jgrads)
    for t, j in zip(tgrads, jgrads):
        _assert_close(t, j, 1e-4)
