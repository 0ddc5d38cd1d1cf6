"""int8 quantization in the port (``ops/quantization.py``,
``contrib/quantization.py``, ``nd.contrib.quantize*``,
``quantize_vision_net``) against the JAX package on the CPU.

The same seeded numpy inputs go through both packages' functions, the JAX
side under ``jax.default_matmul_precision("highest")``. Tolerances:
int32 products (``quantized_conv``, ``quantized_fully_connected``) and
int8 codes exactly equal (measured: no code differs in any case here, so
the mismatch share allowed is 0); float outputs (dequantized values,
ranges) equal bit for bit where the arithmetic is elementwise float32 on
both sides, else within 1e-6 relative. Converted nets: calibrated
thresholds within 1e-5 relative (the float32 forwards that the collectors
watch differ by ulps between XLA and PyTorch), outputs within 1e-5 of the
largest; handed the JAX net's thresholds, the port's converted net gives
the JAX net's outputs bit for bit. On the CPU the int8 products run on the
kernels' plain twins (float64 products rounded to int32), which are also
held here against a direct int64 loop.

Then a port of every test of the reference's ``tests/test_quantization.py``
on the port's API (its ``test_quantize_resnet_zoo_bottleneck``, a slow test
there, is small enough here to run in tier 1).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.ops import quantization as jqop
from incubator_mxnet_tpu.test_utils import quant_chain_net as j_chain_net

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import gluon, telemetry
from incubator_mxnet_tpu_torch.contrib.quantization import (
    QuantizedChain, QuantizedConv2D, QuantizedDense, _get_optimal_threshold,
    fold_batchnorm, get_thresholds, quantize_net)
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.ops import quantization as qop
from incubator_mxnet_tpu_torch.ops.cuda import quantized as qk
from incubator_mxnet_tpu_torch.test_utils import (
    copy_params as _copy_params, quant_chain_net as _conv_chain_net)

THRESH_RTOL = 1e-5      # calibrated thresholds (float forwards differ by ulps)
OUT_TOL = 1e-5          # converted nets' outputs, relative to the largest


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(v):
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else v)


def _hi():
    return jax.default_matmul_precision("highest")


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------ the ops against JAX
def _codes_equal(a, b):
    a, b = _n(a), _n(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    mismatch = float((a != b).mean()) if a.size else 0.0
    assert mismatch == 0.0, f"{mismatch:.2%} of the codes differ"


def _range_equal(j, t):
    assert np.float32(np.asarray(j)) == np.float32(_n(t))


@pytest.mark.parametrize("rng_range", [(-2.0, 2.0), (-0.3, 1.7),
                                       (0.0, 0.0), (-1e-30, 1e-30)])
def test_quantize_and_dequantize_match_jax(rng_range):
    x = (_rng(0).standard_normal((64, 33)) * 1.5).astype(np.float32)
    jq_, jmn, jmx_ = jqop.quantize(jnp.asarray(x), *rng_range)
    tq, tmn, tmx_ = qop.quantize(_t(x), *rng_range)
    _codes_equal(jq_, tq)
    _range_equal(jmn, tmn)
    _range_equal(jmx_, tmx_)
    jd = jqop.dequantize(jq_, jmn, jmx_)
    td = qop.dequantize(tq, tmn, tmx_)
    assert np.array_equal(np.asarray(jd), _n(td))


def test_quantize_v2_dynamic_ranges_match_jax():
    x = (_rng(1).standard_normal((17, 40)) * 3).astype(np.float32)
    jq_, jmn, jmx_ = jqop.quantize_v2(jnp.asarray(x))
    tq, tmn, tmx_ = qop.quantize_v2(_t(x))
    assert isinstance(tmn, torch.Tensor) and tmn.dim() == 0   # on device
    _codes_equal(jq_, tq)
    _range_equal(jmn, tmn)
    _range_equal(jmx_, tmx_)
    assert np.array_equal(np.asarray(jqop.dequantize(jq_, jmn, jmx_)),
                          _n(qop.dequantize(tq, tmn, tmx_)))


@pytest.mark.parametrize("calib", [None, (-0.5, 0.5), (-3e-4, 2e-4),
                                   (0.0, 0.0)])
def test_requantize_and_dequantize_int32_match_jax(calib):
    rng = _rng(2)
    y32 = rng.integers(-(1 << 22), 1 << 22, (31, 29)).astype(np.int32)
    rng_range = (-7.3, 7.3)
    args = () if calib is None else calib
    jq_, jmn, jmx_ = jqop.requantize(jnp.asarray(y32), *rng_range, *args)
    tq, tmn, tmx_ = qop.requantize(_t(y32), *rng_range, *args)
    _codes_equal(jq_, tq)
    _range_equal(jmn, tmn)
    _range_equal(jmx_, tmx_)
    jd = jqop.dequantize_int32(jnp.asarray(y32), *rng_range)
    td = qop.dequantize_int32(_t(y32), *rng_range)
    assert np.array_equal(np.asarray(jd), _n(td))


@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_fully_connected_int32_exact(with_bias):
    rng = _rng(3)
    x = rng.standard_normal((9, 147)).astype(np.float32)
    w = rng.standard_normal((33, 147)).astype(np.float32)
    with _hi():
        jxq, a0, a1 = jqop.quantize_v2(jnp.asarray(x))
        jwq, b0, b1 = jqop.quantize_v2(jnp.asarray(w))
        kw = {}
        if with_bias:
            bq = rng.integers(-127, 128, 33).astype(np.int8)
            kw = dict(bias_q=jnp.asarray(bq), min_b=-0.2, max_b=0.2)
        jy, jo0, jo1 = jqop.quantized_fully_connected(jxq, jwq, a0, a1, b0,
                                                      b1, **kw)
    txq, c0, c1 = qop.quantize_v2(_t(x))
    twq, d0, d1 = qop.quantize_v2(_t(w))
    if with_bias:
        kw = dict(bias_q=_t(bq), min_b=-0.2, max_b=0.2)
    ty, to0, to1 = qop.quantized_fully_connected(txq, twq, c0, c1, d0, d1,
                                                 **kw)
    assert ty.dtype == torch.int32
    assert np.array_equal(np.asarray(jy), _n(ty))
    _range_equal(jo0, to0)
    _range_equal(jo1, to1)


CONV_CASES = [  # x shape, w shape, stride, pad, dilate, groups
    ((2, 3, 17, 15), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ((2, 16, 9, 9), (12, 16, 1, 1), (1, 1), (0, 0), (1, 1), 1),
    ((2, 8, 11, 10), (6, 4, 3, 3), (2, 1), (1, 2), (2, 2), 2),
    ((1, 5, 6, 7), (4, 5, 3, 2), (1, 2), (0, 1), (1, 1), 1),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_quantized_conv_int32_exact(case):
    xs, ws, st, pd, dl, gr = case
    rng = _rng(4)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    with _hi():
        jxq, a0, a1 = jqop.quantize(jnp.asarray(x), -2.5, 2.5)
        jwq, b0, b1 = jqop.quantize_v2(jnp.asarray(w))
        jy, jo0, jo1 = jqop.quantized_conv(jxq, jwq, a0, a1, b0, b1,
                                           stride=st, pad=pd, dilate=dl,
                                           groups=gr)
    txq, c0, c1 = qop.quantize(_t(x), -2.5, 2.5)
    twq, d0, d1 = qop.quantize_v2(_t(w))
    ty, to0, to1 = qop.quantized_conv(txq, twq, c0, c1, d0, d1, stride=st,
                                      pad=pd, dilate=dl, groups=gr)
    _codes_equal(jxq, txq)
    assert ty.dtype == torch.int32
    assert np.array_equal(np.asarray(jy), _n(ty))
    _range_equal(jo1, to1)


@pytest.mark.parametrize("kind", [("max", (3, 3), (2, 2), (1, 1), False),
                                  ("avg", (2, 2), (2, 2), (0, 0), False),
                                  ("avg", (3, 3), (1, 1), (1, 1), False),
                                  ("max", (2, 2), None, (0, 0), True),
                                  ("avg", (2, 2), None, (0, 0), True)])
def test_quantized_pooling_flatten_concat_match_jax(kind):
    pool_type, k, s, p, glob = kind
    q = _rng(5).integers(-127, 128, (2, 3, 9, 8)).astype(np.int8)
    jo = jqop.quantized_pooling(jnp.asarray(q), -1.0, 1.0, kernel=k,
                                pool_type=pool_type, stride=s, pad=p,
                                global_pool=glob)[0]
    to = qop.quantized_pooling(_t(q), -1.0, 1.0, kernel=k,
                               pool_type=pool_type, stride=s, pad=p,
                               global_pool=glob)[0]
    _codes_equal(jo, to)
    _codes_equal(jqop.quantized_flatten(jo, -1.0, 1.0)[0],
                 qop.quantized_flatten(to, -1.0, 1.0)[0])
    jc, jm0, jm1 = jqop.quantized_concat([jo, jo], [-1.0, -3.0], [1.0, 2.5])
    tc, tm0, tm1 = qop.quantized_concat([to, to], [-1.0, -3.0], [1.0, 2.5])
    _codes_equal(jc, tc)
    _range_equal(jm1, tm1)


def test_fused_epilogue_equals_unfused_ops():
    """The chain member's fused op (one kernel epilogue: int32 bias, ReLU,
    requantize) gives the unfused ops' codes: product, bias add, relu,
    ``requantize`` to the calibrated range."""
    rng = _rng(6)
    xq = _t(rng.integers(-127, 128, (2, 6, 8, 8)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (10, 6, 3, 3)).astype(np.int8))
    b32 = _t(rng.integers(-20000, 20000, 10).astype(np.int32))
    for cal in (0.7, 3.9e-3, 0.0):
        got, mn, mx_ = qop.quantized_conv_requantize(
            xq, wq, -1.3, 1.3, -0.8, 0.8, -cal, cal, b32, relu=True,
            pad=(1, 1))
        y32, o0, o1 = qop.quantized_conv(xq, wq, -1.3, 1.3, -0.8, 0.8,
                                         pad=(1, 1))
        y32 = torch.clamp_min(y32 + b32.reshape(1, -1, 1, 1), 0)
        want = qop.requantize(y32, o0, o1, -cal, cal)[0]
        assert torch.equal(got, want), cal
    w2 = _t(rng.integers(-127, 128, (10, 384)).astype(np.int8))
    g = qop.quantized_fully_connected_requantize(
        xq.reshape(2, -1), w2, -1.0, 1.0, -0.5, 0.5, -0.9, 0.9)[0]
    y32, o0, o1 = qop.quantized_fully_connected(
        xq.reshape(2, -1), w2, -1.0, 1.0, -0.5, 0.5)
    assert torch.equal(g, qop.requantize(y32, o0, o1, -0.9, 0.9)[0])


def test_nd_contrib_quantization_ops_match_jax():
    x = _rng(7).standard_normal((6, 5)).astype(np.float32)
    jn = jnp.asarray(x)          # the reference's ops take jax arrays
    tn = tmx.nd.array(x)
    jr = jmx.nd.contrib.quantize(jn, -1.0, 1.0)
    tr = tmx.nd.contrib.quantize(tn, -1.0, 1.0)
    assert isinstance(tr[0], tmx.nd.NDArray)
    _codes_equal(np.asarray(jr[0]), tr[0].asnumpy())
    jv = jmx.nd.contrib.quantize_v2(jn)
    tv = tmx.nd.contrib.quantize_v2(tn)
    _codes_equal(np.asarray(jv[0]), tv[0].asnumpy())
    assert np.array_equal(
        np.asarray(jmx.nd.contrib.dequantize(*jv)),
        tmx.nd.contrib.dequantize(*tv).asnumpy())
    for name in ("requantize", "quantized_concat", "quantized_conv",
                 "quantized_flatten", "quantized_fully_connected",
                 "quantized_pooling"):
        assert callable(getattr(tmx.nd.contrib, name))


# ------------------------------------------ the kernels' twins vs int64
def _conv_int64(x, w, stride, pad, dilate, groups):
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    ho, wo = qk.conv_out_hw(h, wd, (kh, kw), stride, pad, dilate)
    xp = np.zeros((n, c, h + 2 * pad[0], wd + 2 * pad[1]), np.int64)
    xp[:, :, pad[0]:pad[0] + h, pad[1]:pad[1] + wd] = x
    y = np.zeros((n, o, ho, wo), np.int64)
    og = o // groups
    for oc in range(o):
        g = oc // og
        for r in range(kh):
            for t in range(kw):
                patch = xp[:, g * cg:(g + 1) * cg,
                           r * dilate[0]:r * dilate[0] + stride[0] * ho:
                           stride[0],
                           t * dilate[1]:t * dilate[1] + stride[1] * wo:
                           stride[1]]
                y[:, oc] += np.einsum("nchw,c->nhw", patch,
                                      w[oc, :, r, t].astype(np.int64))
    return y


@pytest.mark.parametrize("case", CONV_CASES)
def test_kernel_twins_against_int64_loop(case):
    xs, ws, st, pd, dl, gr = case
    rng = _rng(8)
    x = rng.integers(-127, 128, xs).astype(np.int8)
    w = rng.integers(-127, 128, ws).astype(np.int8)
    got = qk.qconv_s8_reference(_t(x), _t(w), st, pd, dl, gr)
    assert np.array_equal(_n(got), _conv_int64(x, w, st, pd, dl, gr))
    a = rng.integers(-127, 128, (5, 147)).astype(np.int8)
    b = rng.integers(-127, 128, (9, 147)).astype(np.int8)
    assert np.array_equal(_n(qk.qgemm_s8_reference(_t(a), _t(b))),
                          a.astype(np.int64) @ b.astype(np.int64).T)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 4, 5, 5), dtype=torch.int8)
    w = torch.zeros((2, 4, 3, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        qk.qconv_s8(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        qk.qgemm_s8(x.reshape(1, -1),
                    torch.zeros((3, 100), dtype=torch.int8))
    assert qk.qconv_s8.launches == 0 and qk.qgemm_s8.launches == 0


def test_requant_epilogue_scales_in_float32():
    """``step`` and ``127 / cal`` are float32 values computed as the
    reference's weak-typed scalars are, not Python float64 arithmetic."""
    epi = qop.requant_epilogue(-3.3e-3, 3.3e-3, -0.77, 0.77)
    step = np.float32(3.3e-3) / np.float32(2147483647.0)
    assert epi.step == float(step)
    assert epi.s127 == float(np.float32(127.0) / np.float32(0.77))
    assert epi.s127 != 127.0 / 0.77
    assert qop.requant_epilogue(-1.0, 1.0, 0.0, 0.0).zero
    with pytest.raises(TypeError):
        qop.requant_epilogue(torch.tensor(-1.0), 1.0, -1.0, 1.0)


# --------------------------------------------- converted nets against JAX
def _arrays(jnet):
    return {k: np.asarray(p.data().asnumpy()) for k, p in
            jnet._collect_params_with_prefix().items()}


def _carry(jnet, tnet):
    params_from_jax(tnet, _arrays(jnet), ctx=tmx.cpu())


def _mlp_make(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"))
    net.add(mx.gluon.nn.Dense(10))
    return net


def _port_net(kind, seed, arrays):
    """A port net of ``kind`` holding ``arrays`` (a JAX net's)."""
    if kind == "chain":
        tnet, _ = _conv_chain_net(seed=seed)
    else:
        with tmx.name.NameManager():
            tnet = _mlp_make(tmx)
        tnet.initialize()
    params_from_jax(tnet, arrays, ctx=tmx.cpu())
    return tnet


def _pair(kind, seed):
    """(jax net, port net, x, the JAX net's arrays) with the JAX net's
    parameters in both."""
    if kind == "chain":
        with _hi():
            jnet, jx = j_chain_net(seed=seed)
        x = jx.asnumpy()
    else:
        x = _rng(seed).standard_normal((8, 16)).astype(np.float32)
        with jmx.name.NameManager():
            jnet = _mlp_make(jmx)
        jnet.initialize()
        with _hi():
            jnet(jmx.nd.array(x))
    arrays = _arrays(jnet)
    return jnet, _port_net(kind, seed, arrays), x, arrays


def _counts(qp, fn):
    c0 = qp.op_counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(qp.op_counts(), c0))


def _kinds(net):
    return [type(c).__name__ for c in net._children.values()]


@pytest.mark.parametrize("kind", ["mlp", "chain"])
@pytest.mark.parametrize("mode,fuse", [("none", False), ("naive", True),
                                       ("naive", False), ("entropy", True),
                                       ("entropy", False)])
def test_quantize_net_matches_jax(kind, mode, fuse):
    jnet, tnet, x, arrays = _pair(kind, seed=11)
    calib_j = [jmx.nd.array(x)] if mode != "none" else None
    calib_t = [tmx.nd.array(x)] if mode != "none" else None
    with _hi():
        qj = jq.quantize_net(jnet, calib_data=calib_j, calib_mode=mode,
                             fuse=fuse)
        jo, jc = _counts(jqop, lambda: qj(jmx.nd.array(x)).asnumpy())
    qt = quantize_net(tnet, calib_data=calib_t, calib_mode=mode, fuse=fuse)
    to, tc = _counts(qop, lambda: qt(tmx.nd.array(x)).asnumpy())
    assert _kinds(qt) == _kinds(qj)
    for cj, ct in zip(qj._children.values(), qt._children.values()):
        if isinstance(ct, QuantizedChain):
            assert [type(s).__name__ for s in ct._stages] == \
                [type(s).__name__ for s in cj._stages]
    assert tc == jc
    thj, tht = jq.get_thresholds(qj), get_thresholds(qt)
    assert sorted(thj) == sorted(tht)
    for path in thj:
        for k in ("in", "out"):
            np.testing.assert_allclose(tht[path][k], thj[path][k],
                                       rtol=THRESH_RTOL)
    scale = np.abs(jo).max()
    assert np.abs(to - jo).max() <= OUT_TOL * scale
    if mode != "none":
        # handed the JAX thresholds, the port's net is the JAX net's bit
        # for bit (integer products exact, float32 steps the same)
        qt2 = quantize_net(_port_net(kind, 11, arrays), thresholds=thj,
                           fuse=fuse)
        assert np.array_equal(qt2(tmx.nd.array(x)).asnumpy(), jo)


def _tiny_resnet(mx):
    from importlib import import_module
    resnet = import_module(mx.__name__ + ".gluon.model_zoo.vision.resnet")
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, thumbnail=True)


def test_quantize_vision_net_tiny_resnet_matches_jax():
    """A tiny bottleneck ResNet (the reference test's), its BN statistics
    moved by seeded training forwards in JAX and carried with the weights:
    ``quantize_vision_net`` gives the same chains, thresholds within
    ``THRESH_RTOL`` and outputs within ``OUT_TOL`` of JAX's; handed JAX's
    thresholds, outputs within 1e-6 of the largest (the residual adds and
    the global average pool stay float32, where XLA and PyTorch may round
    differently)."""
    from incubator_mxnet_tpu.gluon.model_zoo.vision import (
        quantize_vision_net as jqvn)
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        quantize_vision_net)
    rng = _rng(4)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with jmx.name.NameManager():
        jnet = _tiny_resnet(jmx)
    jnet.initialize(jmx.init.Xavier())
    with _hi(), jmx.autograd.record(train_mode=True):
        for _ in range(2):
            jnet(jmx.nd.array((rng.standard_normal((2, 3, 16, 16)) * 2)
                              .astype(np.float32)))
    with tmx.name.NameManager():
        tnet = _tiny_resnet(tmx)
    tnet.initialize()
    _carry(jnet, tnet)
    with tmx.name.NameManager():
        tnet2 = _tiny_resnet(tmx)
    tnet2.initialize()
    _carry(jnet, tnet2)
    with _hi(), jmx.autograd.pause(train_mode=False):
        qj = jqvn(jnet, calib_data=[jmx.nd.array(x)], calib_mode="naive")
        jo = qj(jmx.nd.array(x)).asnumpy()
    with tmx.autograd.pause(train_mode=False):
        qt = quantize_vision_net(tnet, calib_data=[tmx.nd.array(x)],
                                 calib_mode="naive")
        to = qt(tmx.nd.array(x)).asnumpy()
        qt2 = quantize_vision_net(tnet2, thresholds=jq.get_thresholds(qj))
        to2 = qt2(tmx.nd.array(x)).asnumpy()
    for key in ("1", "2"):
        blk = next(iter(qt.features._children[key]._children.values()))
        assert _kinds(blk.body) == ["QuantizedChain"]
        assert _kinds(blk.downsample) == ["QuantizedConv2D",
                                          "_FoldedIdentity"]
    thj, tht = jq.get_thresholds(qj), get_thresholds(qt)
    for path in thj:
        for k in ("in", "out"):
            np.testing.assert_allclose(tht[path][k], thj[path][k],
                                       rtol=THRESH_RTOL)
    scale = np.abs(jo).max()
    assert np.abs(to - jo).max() <= OUT_TOL * scale
    assert np.abs(to2 - jo).max() <= 1e-6 * scale


# ------------------------------ the reference's tests, on the port's API
def test_quantize_dequantize_roundtrip():
    x = _t(_rng(0).standard_normal((32, 16)).astype(np.float32))
    q, mn, mx_ = qop.quantize_v2(x)
    assert q.dtype == torch.int8
    back = qop.dequantize(q, mn, mx_)
    step = float(mx_) / 127.0
    np.testing.assert_allclose(_n(back), _n(x), atol=step / 2 + 1e-6)


def test_quantize_respects_calib_range():
    q, mn, mx_ = qop.quantize(torch.tensor([[-10.0, 0.5, 3.0]]), -2.0, 2.0)
    assert int(q[0, 0]) == -127 and int(q[0, 2]) == 127


def test_quantized_fully_connected_close_to_fp32():
    rng = _rng(1)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    xq, mnx, mxx = qop.quantize_v2(_t(x))
    wq, mnw, mxw = qop.quantize_v2(_t(w))
    y32, mno, mxo = qop.quantized_fully_connected(xq, wq, mnx, mxx, mnw, mxw)
    y = _n(y32).astype(np.float64) * (float(mxo) / qop.INT32_RANGE)
    ref = x @ w.T
    assert np.abs(y - ref).max() / np.abs(ref).max() < 0.05


def test_quantized_conv_close_to_fp32():
    rng = _rng(2)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    xq, mnx, mxx = qop.quantize_v2(_t(x))
    wq, mnw, mxw = qop.quantize_v2(_t(w))
    y32, mno, mxo = qop.quantized_conv(xq, wq, mnx, mxx, mnw, mxw,
                                       stride=(1, 1), pad=(1, 1))
    y = _n(y32).astype(np.float64) * (float(mxo) / qop.INT32_RANGE)
    ref = torch.nn.functional.conv2d(_t(x).double(), _t(w).double(),
                                     padding=1).numpy()
    assert np.abs(y - ref).max() / np.abs(ref).max() < 0.05


def test_quantized_pooling_and_flatten():
    x = _t(_rng(3).integers(-127, 127, (1, 2, 4, 4)).astype(np.int8))
    out, mn, mx_ = qop.quantized_pooling(x, -1.0, 1.0, kernel=(2, 2))
    assert tuple(out.shape) == (1, 2, 2, 2) and out.dtype == torch.int8
    f, _, _ = qop.quantized_flatten(out, mn, mx_)
    assert tuple(f.shape) == (1, 8)


def test_quantized_concat_rescales():
    a = torch.full((1, 2), 127, dtype=torch.int8)
    b = torch.full((1, 2), 127, dtype=torch.int8)
    out, mn, mx_ = qop.quantized_concat([a, b], [-1.0, -2.0], [1.0, 2.0])
    assert float(mx_) == 2.0
    assert abs(int(out[0, 0]) - 64) <= 1
    assert int(out[0, 2]) == 127


def test_requantize_with_and_without_calib():
    x32 = torch.tensor([[1 << 20, -(1 << 21)]], dtype=torch.int32)
    q, mn, mx_ = qop.requantize(x32, -1000.0, 1000.0)
    assert q.dtype == torch.int8
    assert int(q[0, 1]) == -127
    q2, mn2, mx2 = qop.requantize(x32, -1000.0, 1000.0,
                                  min_calib_range=-0.001,
                                  max_calib_range=0.001)
    assert float(mx2) == pytest.approx(0.001)


def test_get_optimal_threshold_reasonable():
    arr = _rng(4).standard_normal(20000)
    th = _get_optimal_threshold(arr)
    assert 1.0 < th <= float(np.abs(arr).max()) + 1e-6
    assert th == jq._get_optimal_threshold(arr)     # the reference's value


def _mlp(seed):
    """The reference test's MLP. Its weights are seeded too (the
    reference's come from the global generator, so from the tests run
    before): under entropy calibration on these 8 rows, 3 of 30 seeds
    read above the 0.1 tolerance (the calibration's arithmetic is the
    reference's; handed the same thresholds, the nets agree bit for
    bit)."""
    rng = _rng(seed)
    tmx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"))
    net.add(gluon.nn.Dense(10))
    net.initialize()
    x = tmx.nd.array(rng.standard_normal((8, 16)).astype(np.float32))
    return net, x


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_net_mlp(calib_mode):
    net, x = _mlp(5)
    ref = net(x).asnumpy()
    calib = [x] if calib_mode != "none" else None
    qnet = quantize_net(net, calib_data=calib, calib_mode=calib_mode)
    kinds = [type(c) for c in qnet._children.values()]
    if calib_mode == "none":
        assert all(k is QuantizedDense for k in kinds), kinds
    else:
        assert kinds == [QuantizedChain], kinds
    out = qnet(x).asnumpy()
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.1


@pytest.mark.parametrize("calib_mode", ["naive", "entropy"])
def test_quantize_net_mlp_unfused(calib_mode):
    net, x = _mlp(5)
    ref = net(x).asnumpy()
    qnet = quantize_net(net, calib_data=[x], calib_mode=calib_mode,
                        fuse=False)
    kinds = [type(c) for c in qnet._children.values()]
    assert all(k is QuantizedDense for k in kinds), kinds
    out = qnet(x).asnumpy()
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.1


def test_quantize_all_zero_input_gives_zeros():
    q, mn, mx_ = qop.quantize_v2(torch.zeros((4, 4)))
    assert bool((q == 0).all())
    assert bool(torch.isfinite(qop.dequantize(q, mn, mx_)).all())


def test_quantize_net_after_hybridize():
    rng = _rng(7)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"))
    net.add(gluon.nn.Dense(4))
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(rng.standard_normal((4, 8)).astype(np.float32))
    ref = net(x).asnumpy()
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    assert [type(c) for c in qnet._children.values()] == [QuantizedChain]
    out = qnet(x).asnumpy()
    rel = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)
    assert 0 < rel < 0.1, rel


def test_quantize_net_conv_and_exclude():
    rng = _rng(6)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, kernel_size=3, padding=1, activation="relu"))
    net.add(gluon.nn.Flatten())
    net.add(gluon.nn.Dense(10))
    net.initialize()
    x = tmx.nd.array(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    ref = net(x).asnumpy()
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive",
                        exclude=["2"])
    kinds = {name: type(c).__name__ for name, c in qnet._children.items()}
    assert kinds["0"] == "QuantizedConv2D"
    assert kinds["2"] == "Dense"
    out = qnet(x).asnumpy()
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.15


def test_fused_chain_structure_and_boundary_counts():
    net, x = _conv_chain_net()
    ref = net(x).asnumpy()
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    assert [type(c) for c in qnet._children.values()] == [QuantizedChain]
    chain = next(iter(qnet._children.values()))
    stage_kinds = [type(s).__name__ for s in chain._stages]
    assert "QuantizedPooling" in stage_kinds
    assert stage_kinds.count("QuantizedConv2D") == 2
    assert stage_kinds.count("QuantizedDense") == 2
    out, (dq, ddeq, dre) = _counts(qop, lambda: qnet(x).asnumpy())
    assert (dq, ddeq) == (1, 1), (dq, ddeq)
    assert dre == 4, dre
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.1


def test_unfused_counts_show_interior_pairs():
    net, x = _conv_chain_net(seed=1)
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive", fuse=False)
    _, counts = _counts(qop, lambda: qnet(x))
    assert counts == (4, 4, 0), counts


def test_fused_vs_unfused_close():
    net, x = _conv_chain_net(seed=2)
    twin, _ = _conv_chain_net(seed=3)
    _copy_params(net, twin)
    qf = quantize_net(net, calib_data=[x], calib_mode="naive")
    qu = quantize_net(twin, calib_data=[x], calib_mode="naive", fuse=False)
    a, b = qf(x).asnumpy(), qu(x).asnumpy()
    assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 0.1


def test_fused_chain_hybridize_bit_identical():
    net, x = _conv_chain_net(seed=4)
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    eager = qnet(x).asnumpy()
    qnet.hybridize()
    assert np.array_equal(eager, qnet(x).asnumpy())


def test_int8_weights_are_registered_params():
    net, x = _conv_chain_net(seed=5)
    fp32_bytes = sum(int(np.prod(p.shape)) * 4
                     for p in net.collect_params().values())
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    params = qnet.collect_params()
    qweights = {n: p for n, p in params.items() if "qweight" in n}
    assert len(qweights) == 4
    assert all(str(p.data().dtype) == "int8" for p in qweights.values())
    assert all(p.grad_req == "null" for p in qweights.values())
    q_bytes = sum(p.data()._data.nbytes for p in params.values())
    assert q_bytes < 0.35 * fp32_bytes, (q_bytes, fp32_bytes)


def test_threshold_save_load_roundtrip():
    netA, x = _conv_chain_net(seed=6)
    netB, _ = _conv_chain_net(seed=7)
    _copy_params(netA, netB)
    qa = quantize_net(netA, calib_data=[x], calib_mode="entropy")
    saved = json.loads(json.dumps(get_thresholds(qa)))
    qb = quantize_net(netB, thresholds=saved)
    assert np.array_equal(qa(x).asnumpy(), qb(x).asnumpy())
    assert get_thresholds(qb) == saved


def test_thresholds_published_to_telemetry():
    net, x = _conv_chain_net(seed=8)
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    g = telemetry.gauge("mxtpu_quant_threshold")
    for path, v in get_thresholds(qnet).items():
        assert g.value(layer=path, kind="in") == pytest.approx(v["in"])
        assert g.value(layer=path, kind="out") == pytest.approx(v["out"])


def test_quantize_zero_threshold_nonzero_input_gives_zeros():
    q, mn, mx_ = qop.quantize(torch.tensor([[1.0, -2.0, 1e-15]]), 0.0, 0.0)
    assert bool((q == 0).all())
    assert bool((qop.dequantize(q, mn, mx_) == 0.0).all())


def test_requantize_zero_calib_range_gives_zeros():
    x32 = torch.tensor([[1 << 20, -(1 << 21)]], dtype=torch.int32)
    q, _, _ = qop.requantize(x32, -1000.0, 1000.0, min_calib_range=0.0,
                             max_calib_range=0.0)
    assert bool((q == 0).all())
    q2, _, _ = qop.requantize(torch.zeros((2, 2), dtype=torch.int32),
                              -1.0, 1.0)
    assert bool((q2 == 0).all())


@pytest.mark.parametrize("calib_mode,fuse", [("naive", True),
                                             ("naive", False),
                                             ("entropy", True),
                                             ("none", False)])
def test_quantize_net_all_zero_calibration_composition(calib_mode, fuse):
    net, x = _conv_chain_net(seed=9)
    xz = tmx.nd.zeros(x.shape)
    calib = [xz] if calib_mode != "none" else None
    qnet = quantize_net(net, calib_data=calib, calib_mode=calib_mode,
                        fuse=fuse)
    for probe in (xz, x):
        assert np.isfinite(qnet(probe).asnumpy()).all(), (calib_mode, fuse)


def test_kl_threshold_deterministic():
    rng = np.random.default_rng(int(os.environ.get("MXTPU_TEST_SEED", 0)))
    arr = rng.standard_normal(30000).astype(np.float32)
    t1 = _get_optimal_threshold(arr)
    assert t1 == _get_optimal_threshold(arr.copy())
    assert 0 < t1 <= float(np.abs(arr).max()) + 1e-12


def test_kl_threshold_env_knobs(monkeypatch):
    arr = _rng(1).standard_normal(20000)
    coarse = _get_optimal_threshold(arr, num_bins=513)
    fine = _get_optimal_threshold(arr)
    assert np.isfinite(coarse) and np.isfinite(fine) and coarse > 0
    monkeypatch.setenv("MXTPU_QUANT_SWEEP", "8")
    t8 = _get_optimal_threshold(arr)
    assert _get_optimal_threshold(arr) == t8


def test_kl_beats_naive_on_heavy_tails():
    rng = _rng(2)
    arr = rng.lognormal(0.0, 1.5, 40000) * np.sign(
        rng.standard_normal(40000))
    th = _get_optimal_threshold(arr)
    assert th == _get_optimal_threshold(arr.copy())
    naive = float(np.abs(arr).max())
    assert th < 0.5 * naive, (th, naive)
    bulk = arr[np.abs(arr) <= th]
    assert len(bulk) >= 0.99 * len(arr)

    def mse(vals, t):
        q = np.clip(np.round(vals * (127 / t)), -127, 127) * (t / 127)
        return float(((q - vals) ** 2).mean())
    assert mse(bulk, th) < 0.25 * mse(bulk, naive)


def _nontrivial_bn_stats(net, rng):
    for name, p in net.collect_params().items():
        if "running_mean" in name:
            p.set_data(tmx.nd.array(
                (rng.standard_normal(p.shape[0]) * 0.1).astype(np.float32)))
        elif "running_var" in name:
            p.set_data(tmx.nd.array(
                (1.0 + rng.random(p.shape[0])).astype(np.float32)))
        elif name.endswith("gamma"):
            p.set_data(tmx.nd.array(
                (0.5 + rng.random(p.shape[0])).astype(np.float32)))
        elif name.endswith("beta"):
            p.set_data(tmx.nd.array(
                (rng.standard_normal(p.shape[0]) * 0.2).astype(np.float32)))


def test_fold_batchnorm_parity():
    rng = _rng(3)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, kernel_size=3, padding=1, use_bias=False))
    net.add(gluon.nn.BatchNorm())
    net.add(gluon.nn.Activation("relu"))
    net.add(gluon.nn.Conv2D(4, kernel_size=3, padding=1))  # with bias
    net.add(gluon.nn.BatchNorm())
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    net(x)
    _nontrivial_bn_stats(net, rng)
    ref = net(x).asnumpy()
    fold_batchnorm(net)
    assert _kinds(net) == ["Conv2D", "_FoldedIdentity", "Activation",
                           "Conv2D", "_FoldedIdentity"]
    np.testing.assert_allclose(net(x).asnumpy(), ref, atol=2e-5, rtol=1e-4)
    qnet = quantize_net(net, calib_data=[x], calib_mode="naive")
    assert [type(c) for c in qnet._children.values()] == [QuantizedChain]
    rel = np.abs(qnet(x).asnumpy() - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.1, rel


def test_quantize_resnet_zoo_bottleneck():
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        quantize_vision_net)
    rng = _rng(4)
    net = _tiny_resnet(tmx)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    with autograd.pause(train_mode=False):
        net(x)
    with autograd.record(train_mode=True):
        for _ in range(3):
            net(tmx.nd.array((rng.standard_normal((2, 3, 16, 16)) * 2)
                             .astype(np.float32)))
    with autograd.pause(train_mode=False):
        ref = net(x).asnumpy()
        qnet = quantize_vision_net(net, calib_data=[x], calib_mode="naive")
        for key in ("1", "2"):
            stage = qnet.features._children[key]
            blk = next(iter(stage._children.values()))
            assert [type(c) for c in blk.body._children.values()] == \
                [QuantizedChain], key
        out = qnet(x).asnumpy()
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.15
    assert (out.argmax(1) == ref.argmax(1)).all()
    assert isinstance(qnet.output, QuantizedDense)
    assert isinstance(qnet.features._children["0"], QuantizedConv2D)
