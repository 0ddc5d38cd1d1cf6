"""The Hopper route of the port's int8 products (``ops/cuda/csrc/
quantized.cu``, ``qtma_kernel``) and the channels-last int8 chain, on the
CPU.

The kernels need the card, so these tests hold what surrounds them:

* the plan (``qconv_plan``, ``qgemm_plan``: route, tile, rows, stages,
  splits) against the source's ``kQ*`` constants and shared-memory
  formula; every conv and GEMM shape of ResNet-50 and the serve-bench MLP
  at buckets 1..32 fits 227 KB, and the plan sends to the first design
  exactly the shapes the TMA boxes cannot read (C / groups not a multiple
  of 16, groups > 1, a stride with a kernel wider than 1 or a pad);
* a plain-PyTorch emulation of the route's decomposition — channels-last
  A read as 4-D boxes of whole output rows with every out-of-range
  coordinate 0 (the halo), a tap-major B, 128-byte slices of K, the K
  stages cut into splits whose int32 partials are summed in a shuffled
  order, the epilogue on the sum — equal to the twins
  (``qconv_s8_reference``, ``qgemm_s8_reference``) bit for bit;
* a converted tiny ResNet gives the same codes and outputs with its codes
  carried channels-last as without, and still matches the JAX reference
  within ``test_torch_quantization.py``'s tolerance; its conv ``qweight``
  is channels-last and stays so through ``_StaticForward``'s copies;
* both routes refuse CPU tensors.

Inputs come from numpy with a seed. Integer results are compared exactly.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import quantization as jq

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.contrib.quantization import get_thresholds
from incubator_mxnet_tpu_torch.gluon.block import _StaticForward
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.ops import quantization as qop
from incubator_mxnet_tpu_torch.ops.cuda import quantized as qk

SRC = (Path(qk.__file__).resolve().parent / "csrc" / "quantized.cu"
       ).read_text()
CONSTS = {n: int(eval(v, {})) for n, v in       # "200 * 1024" and the like
          re.findall(r"constexpr int (kQ\w+) = ([\d *]+);", SRC)}
OUT_TOL = 1e-5          # test_torch_quantization.py's, for converted nets
BUCKETS = (1, 2, 4, 8, 16, 32)
# chip_smoke.py's QCONV_TAILS: (x shape, w shape, stride, pad, dilation,
# groups), and the reason the plan gives for each
TAILS = (((3, 3, 31, 29), (16, 3, 3, 3), (2, 2), (1, 1), (1, 1), 1, "C 3"),
         ((2, 5, 17, 15), (24, 5, 5, 3), (1, 2), (2, 1), (1, 1), 1, "C 5"),
         ((2, 40, 23, 21), (48, 40, 3, 3), (1, 1), (2, 2), (2, 2), 1,
          "C 40"),
         ((4, 64, 14, 14), (96, 32, 3, 3), (2, 2), (1, 1), (1, 1), 2,
          "groups 2"),
         ((1, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1, "C 3"))
# shapes on the Hopper route off ResNet-50's: C and O not multiples of the
# tile, odd H and W, pad 2 dilation 2, a stride-2 1x1 on odd H, a 5x5 with
# no pad, tiny images
EDGE = (((3, 48, 9, 11), (40, 48, 3, 3), (1, 1), (1, 1), (1, 1)),
        ((2, 32, 13, 7), (24, 32, 3, 3), (1, 1), (2, 2), (2, 2)),
        ((1, 160, 15, 9), (200, 160, 1, 1), (2, 2), (0, 0), (1, 1)),
        ((5, 16, 3, 3), (16, 16, 3, 3), (1, 1), (1, 1), (1, 1)),
        ((1, 256, 5, 5), (100, 256, 5, 5), (1, 1), (0, 0), (1, 1)))


def resnet50_convs(n):
    """(x shape, w shape, stride, pad) of the int8 ResNet-50's 53 convs at
    batch n, in forward order (resnet50_v1, 224 x 224: the stem, then each
    bottleneck's 1x1 (strided at a stage's first block), 3x3, 1x1 and the
    first block's projection)."""
    out = [((n, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3))]
    cin, h = 64, 56
    for st, (mid, outc, blocks) in enumerate(
            [(64, 256, 3), (128, 512, 4), (256, 1024, 6), (512, 2048, 3)]):
        for b in range(blocks):
            s = 2 if b == 0 and st > 0 else 1
            hi = h * s
            out.append(((n, cin, hi, hi), (mid, cin, 1, 1), (s, s), (0, 0)))
            out.append(((n, mid, h, h), (mid, mid, 3, 3), (1, 1), (1, 1)))
            out.append(((n, mid, h, h), (outc, mid, 1, 1), (1, 1), (0, 0)))
            if b == 0:
                out.append(((n, cin, hi, hi), (outc, cin, 1, 1), (s, s),
                            (0, 0)))
            cin = outc
        h //= 2
    return out


def _gemms(n):
    """(n, K, units) of the int8 ResNet-50's head and the MLP's layers."""
    return [(n, 2048, 1000), (n, 256, 256), (n, 256, 64)]


# ------------------------------------------------------------- the plan
def test_plan_constants_match_the_source():
    assert CONSTS["kQBM"] == qk._BM == 64
    assert CONSTS["kQBK"] == qk._BK == 128
    assert CONSTS["kQSmemBudget"] == qk._SMEM_BUDGET
    assert CONSTS["kQMaxStages"] == qk._MAX_STAGES
    assert CONSTS["kQPad"] == qk._PAD
    assert CONSTS["kQMaxBox"] == qk._MAX_BOX
    assert CONSTS["kQThreads"] == 256 and CONSTS["kQConsumers"] == 128
    assert CONSTS["kQBlocksPerSM"] == qk._BLOCKS_PER_SM == 2
    flat = re.sub(r"\s+", " ", SRC)
    for line in ("static constexpr int kStage = kA + kB;",
                 "static constexpr int kA = kQBM * kQBK;",
                 "static constexpr int kB = BN * kQBK;",
                 "static constexpr int kStages = (kQSmemBudget - kStaging) "
                 "/ kStage < kQMaxStages ? (kQSmemBudget - kStaging) / "
                 "kStage : kQMaxStages;",
                 "static constexpr int kSmem = kStages * kStage + kStaging + "
                 "1024;",
                 "static constexpr int kStaging = (kRowMajor > kColMajor ? "
                 "kRowMajor : kColMajor) * 4;"):
        assert line in flat, line
    for bn in (32, 64, 128):
        stages, smem = qk._tma_smem(bn)
        stage = 64 * 128 + bn * 128
        staging = max(64 * (bn + 4), bn * (64 + 4)) * 4
        assert stages == min(6, (108 * 1024 - staging) // stage) >= 3
        assert smem == stages * stage + staging + 1024
        assert 2 * (smem + 1024) <= qk.SMEM_LIMIT     # two blocks an SM


@pytest.mark.parametrize("bucket", BUCKETS)
def test_plan_covers_the_lanes(bucket):
    """Every ResNet-50 conv and every GEMM of its head and of the MLP at
    this bucket: on the Hopper route but the stem (C 3), under 227 KB, a
    tile of at most 64 rows of whole output rows, every split at least
    two stages deep or the only one."""
    convs = resnet50_convs(bucket)
    assert len(convs) == 53
    for i, (xs, ws, st, pd) in enumerate(convs):
        plan = qk.qconv_plan(xs, ws, st, pd)
        if i == 0:
            assert plan.route == "simple" and "C 3" in plan.why
            continue
        assert plan.route == "tma", (xs, ws, plan)
        ho, wo = qk.conv_out_hw(xs[2], xs[3], ws[2:], st, pd, (1, 1))
        assert plan.rows == plan.nb * plan.hb * wo <= 64
        assert plan.nb == 1 or plan.hb == ho
        assert plan.m_tiles == math.ceil(xs[0] / plan.nb) * math.ceil(
            ho / plan.hb)
        assert plan.nk == ws[2] * ws[3] * math.ceil(ws[1] / 128)
        assert plan.smem <= qk.SMEM_LIMIT
        tiles = plan.m_tiles * plan.n_tiles
        assert plan.splits == 1 or (tiles * plan.splits <= 264 and
                                    plan.nk // plan.splits >= 2)
        assert plan.blocks == min(264, tiles * plan.splits)
    for n, k, units in _gemms(bucket):
        plan = qk.qgemm_plan(n, k, units)
        assert plan.route == "tma" and plan.rows == 64
        assert plan.bn == (32 if n <= 32 else 64 if n <= 64 else 128)
        assert plan.smem <= qk.SMEM_LIMIT
    # the deep stages and batch 1 split K; the head at bucket 32 too
    assert qk.qconv_plan((bucket, 512, 7, 7), (512, 512, 3, 3), (1, 1),
                         (1, 1)).splits > 1
    assert qk.qgemm_plan(bucket, 2048, 1000).splits > 1


def test_plan_routes_the_tails_by_shape():
    for xs, ws, st, pd, dl, gr, why in TAILS:
        plan = qk.qconv_plan(xs, ws, st, pd, dl, gr)
        assert plan.route == "simple" and why in plan.why, (xs, plan)
    for xs, ws, st, pd, dl in EDGE:
        assert qk.qconv_plan(xs, ws, st, pd, dl).route == "tma"
    assert qk.qconv_plan((1, 16, 3, 66), (16, 16, 1, 1)).route == "simple"
    assert qk.qconv_plan((1, 16, 9, 9), (16, 16, 3, 3), (2, 2),
                         (1, 1)).route == "simple"
    assert qk.qgemm_plan(7, 147, 33).route == "simple"
    assert qk.qgemm_plan(17, 100, 65).route == "simple"
    assert qk.qgemm_plan(1, 2048, 1000).route == "tma"


# ---------------------------------------------- the route, emulated
def _split_sum(parts, rng):
    """Int32 partials summed in a shuffled order (exact and associative:
    the order never shows)."""
    total = torch.zeros_like(parts[0])
    for i in rng.permutation(len(parts)):
        total = total + parts[i]
    assert total.abs().max() < 2 ** 31
    return total


def _split_of(nk, splits):
    """Stage kb's split: the kernel's kb0 = nk s / splits."""
    return [max(s for s in range(splits) if nk * s // splits <= kb)
            for kb in range(nk)]


def emulate_qconv(x, w, stride, pad, dilate, epi, plan, rng):
    """What ``qtma_kernel<BN, epi, false>`` computes for x (N, C, H, W) and
    w (O, C, kh, kw) int8 under ``plan``, from the memory it reads: x
    channels-last (N, H, W, C), w tap-major (O, kh kw, C)."""
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    ho, wo = qk.conv_out_hw(h, wd, (kh, kw), stride, pad, dilate)
    xcl = x.permute(0, 2, 3, 1).to(torch.float64)
    cs = math.ceil(c / 128)
    wt = torch.zeros(o, kh * kw, cs * 128, dtype=torch.float64)
    wt[:, :, :c] = w.permute(0, 2, 3, 1).reshape(o, kh * kw, c).double()
    bn, hb, nb = plan.bn, plan.hb, plan.nb
    ht, it, nt = math.ceil(ho / hb), math.ceil(n / nb), plan.n_tiles
    btile = torch.zeros(nt * bn, kh * kw, cs * 128, dtype=torch.float64)
    btile[:o] = wt
    btile = btile.reshape(nt, bn, kh * kw, cs * 128)
    strided = tuple(stride) != (1, 1)
    mt = torch.arange(it * ht)
    ni = (mt // ht)[:, None] * nb + torch.arange(nb)           # (mt, nb)
    hrow = (mt % ht)[:, None] * hb + torch.arange(hb)          # (mt, hb)
    wcol = torch.arange(wo)
    nk = kh * kw * cs
    owner = _split_of(nk, plan.splits)
    parts = [torch.zeros(it * ht, nt, plan.rows, bn, dtype=torch.float64)
             for _ in range(plan.splits)]
    for kb in range(nk):
        tap, c0 = kb // cs, (kb % cs) * 128
        r, s = tap // kw, tap % kw
        if strided:        # the map of doubled strides: (wo, ho) < (Wo, Ho)
            hi, wi = hrow * stride[0], wcol * stride[1]
            hok, wok = hrow < ho, wcol < wo
        else:
            hi, wi = hrow + r * dilate[0] - pad[0], wcol + s * dilate[1] - pad[1]
            hok, wok = (hi >= 0) & (hi < h), (wi >= 0) & (wi < wd)
        ok = ((ni < n)[:, :, None, None] & hok[:, None, :, None]
              & wok[None, None, None, :])
        box = xcl[ni.clamp(0, n - 1)[:, :, None, None],
                  hi.clamp(0, h - 1)[:, None, :, None],
                  wi.clamp(0, wd - 1)[None, None, None, :]]
        box = box * ok[..., None]
        a = torch.zeros(*box.shape[:-1], 128, dtype=torch.float64)
        a[..., :min(128, c - c0)] = box[..., c0:c0 + 128]
        a = a.reshape(it * ht, plan.rows, 128)     # row = w + Wo (h + hb n)
        b = btile[:, :, tap, c0:c0 + 128]
        parts[owner[kb]] += torch.einsum("mrk,jbk->mjrb", a, b)
    acc = _split_sum([p.round().to(torch.int64) for p in parts], rng)
    acc = acc.reshape(it, ht, nt, nb, hb, wo, bn).permute(0, 3, 1, 4, 5, 2, 6)
    acc = acc.reshape(it * nb, ht * hb, wo, nt * bn)[:n, :ho, :, :o]
    acc = acc.permute(0, 3, 1, 2).to(torch.int32)
    return qk.requantize_reference(acc, epi, 1)


def emulate_qgemm(x, w, epi, plan, rng):
    """What ``qtma_kernel<BN, epi, true>`` computes: the units (w's rows)
    are the tiles' rows (64 a tile), the batch (x's rows) their columns, K
    in 128-byte stages cut into splits; y (N, units) is the tile
    transposed."""
    n, k = x.shape
    units = w.shape[0]
    mt, nt, bn, rows = plan.m_tiles, plan.n_tiles, plan.bn, plan.rows
    kp = plan.nk * 128
    a = torch.zeros(mt * rows, kp, dtype=torch.float64)
    a[:units, :k] = w.double()
    b = torch.zeros(nt * bn, kp, dtype=torch.float64)
    b[:n, :k] = x.double()
    a, b = a.reshape(mt, rows, kp), b.reshape(nt, bn, kp)
    owner = _split_of(plan.nk, plan.splits)
    parts = [torch.zeros(mt, nt, rows, bn, dtype=torch.float64)
             for _ in range(plan.splits)]
    for kb in range(plan.nk):
        sl = slice(kb * 128, (kb + 1) * 128)
        parts[owner[kb]] += torch.einsum("mrk,jbk->mjrb", a[:, :, sl],
                                         b[:, :, sl])
    acc = _split_sum([p.round().to(torch.int64) for p in parts], rng)
    acc = acc.permute(1, 3, 0, 2).reshape(nt * bn, mt * rows)[:n, :units]
    return qk.requantize_reference(acc.to(torch.int32), epi, 1)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _epilogues(rng, o):
    bias = torch.from_numpy(rng.integers(-40000, 40000, (o,))
                            .astype(np.int32))
    return (None, qk.Requant(bias, True, 3.1e-5, 141.1, False),
            qk.Requant(None, False, 2.7e-6, 97.3, False))


def _lane_cases():
    """ResNet-50's conv shapes at batch 1 and 2 (but the stem), ``EDGE``,
    and the tails whose geometry the route's boxes take (stride 1, or a
    1x1 with no pad; groups 1), whatever their C."""
    seen = {}
    for n in (1, 2):
        for xs, ws, st, pd in resnet50_convs(n)[1:]:
            seen[(xs, ws, st, pd, (1, 1))] = None
    tails = [t[:5] for t in TAILS if t[5] == 1 and (
        t[2] == (1, 1) or (t[1][2:], t[3]) == ((1, 1), (0, 0)))]
    assert len(tails) == 1            # C 40, pad 2, dilation 2
    return list(seen) + list(EDGE) + tails


@pytest.mark.parametrize("case", _lane_cases(), ids=lambda c: "x".join(
    map(str, c[0])) + "_w" + "x".join(map(str, c[1])) + f"_s{c[2][0]}")
def test_emulated_route_equals_the_twin(case):
    xs, ws, st, pd, dl = case
    rng = np.random.default_rng(sum(xs) + 7 * sum(ws))
    x, w = _codes(rng, xs), _codes(rng, ws)
    # the boxes of the plan (a tail's C rounded up to 16 for the plan only:
    # TMA's 16-byte strides are all that keeps it off the route)
    c16 = -(-ws[1] // 16) * 16
    plan = qk.qconv_plan(xs[:1] + (c16,) + xs[2:], (ws[0], c16) + ws[2:],
                         st, pd, dl)
    assert plan.route == "tma"
    for epi in _epilogues(rng, ws[0]):
        want = qk.qconv_s8_reference(x, w, st, pd, dl, 1, epi)
        got = emulate_qconv(x, w, st, pd, dl, epi, plan, rng)
        assert torch.equal(got, want), (case, epi is not None)


@pytest.mark.parametrize("splits", [None, 1, 3, 16])
@pytest.mark.parametrize("n,k,units", [(32, 2048, 1000), (1, 2048, 1000),
                                       (32, 256, 256), (2, 256, 64),
                                       (200, 512, 130)])
def test_emulated_swapped_gemm_equals_the_twin(n, k, units, splits):
    rng = np.random.default_rng(n + k + units)
    x, w = _codes(rng, (n, k)), _codes(rng, (units, k))
    plan = qk.qgemm_plan(n, k, units)
    if splits is not None:
        plan = plan._replace(splits=min(splits, plan.nk))
    for epi in _epilogues(rng, units)[:2]:
        want = qk.qgemm_s8_reference(x, w, epi)
        assert torch.equal(emulate_qgemm(x, w, epi, plan, rng), want)


# ------------------------------------------- the channels-last int8 chain
def _tiny_resnet(mx):
    from importlib import import_module
    resnet = import_module(mx.__name__ + ".gluon.model_zoo.vision.resnet")
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, thumbnail=True)


@pytest.fixture(scope="module")
def tiny_pair():
    """A tiny bottleneck ResNet (channels 16..64, so its convs are on the
    Hopper plan) in JAX, its BN statistics moved by seeded training
    forwards, its parameters carried into the port; the converted JAX net
    and its output; the input."""
    from incubator_mxnet_tpu.gluon.model_zoo.vision import (
        quantize_vision_net as jqvn)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with jmx.name.NameManager():
        jnet = _tiny_resnet(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.record(train_mode=True):
        for _ in range(2):
            jnet(jmx.nd.array((rng.standard_normal((2, 3, 16, 16)) * 2)
                              .astype(np.float32)))
    arrays = {k: np.asarray(p.data().asnumpy()) for k, p in
              jnet._collect_params_with_prefix().items()}
    with jmx.autograd.pause(train_mode=False):
        qj = jqvn(jnet, calib_data=[jmx.nd.array(x)], calib_mode="naive")
        jo = qj(jmx.nd.array(x)).asnumpy()
    return arrays, jq.get_thresholds(qj), jo, x


def _converted(arrays, thresholds):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        quantize_vision_net)
    with tmx.cpu():
        with tmx.name.NameManager():
            net = _tiny_resnet(tmx)
        net.initialize()
        params_from_jax(net, arrays, ctx=tmx.cpu())
        return quantize_vision_net(net, thresholds=thresholds)


def _run_recording(net, x):
    """The net's output and every int8 product's operands and result, in
    order, through ``ops.quantization``."""
    seen = []
    conv, gemm = qop._conv, qop._gemm

    def rec_conv(xq, wq, *args):
        y = conv(xq, wq, *args)
        seen.append((xq, wq, y))
        return y

    def rec_gemm(xq, wq, epi=None):
        y = gemm(xq, wq, epi)
        seen.append((xq, wq, y))
        return y
    qop._conv, qop._gemm = rec_conv, rec_gemm
    try:
        with tmx.cpu(), tmx.autograd.pause(train_mode=False):
            out = net(tmx.nd.array(x)).asnumpy()
    finally:
        qop._conv, qop._gemm = conv, gemm
    return out, seen


def test_channels_last_chain_same_codes_and_outputs(tiny_pair, monkeypatch):
    arrays, th, jo, x = tiny_pair
    net = _converted(arrays, th)
    out_cl, seen_cl = _run_recording(net, x)
    quantize = qop.quantize

    def nchw_quantize(*args, **kwargs):        # codes left NCHW-contiguous
        q, lo, hi = quantize(*args, **kwargs)
        return q.contiguous(), lo, hi
    monkeypatch.setattr(qop, "quantize", nchw_quantize)
    out_plain, seen_plain = _run_recording(net, x)
    assert len(seen_cl) == len(seen_plain) == 10     # 9 convs, the head
    convs = [s for s in seen_cl if s[0].dim() == 4]
    assert all(xq.is_contiguous(memory_format=torch.channels_last)
               and not xq.is_contiguous() for xq, _, _ in convs)
    assert any(xq.is_contiguous() for xq, _, _ in seen_plain
               if xq.dim() == 4)
    for (a, b, c), (a2, b2, c2) in zip(seen_cl, seen_plain):
        assert torch.equal(a, a2) and torch.equal(b, b2)
        assert torch.equal(c, c2)
    assert np.array_equal(out_cl, out_plain)
    scale = np.abs(jo).max()
    assert np.abs(out_cl - jo).max() <= OUT_TOL * scale


def test_qweight_channels_last_through_static_copies(tiny_pair):
    arrays, th, _, _ = tiny_pair
    net = _converted(arrays, th)
    params = list(net.collect_params().values())
    conv_w = [p for p in params if p.name.endswith("qweight")
              and p.data()._data.dim() == 4]
    assert len(conv_w) == 9
    for p in conv_w:
        t = p.data()._data
        assert t.dtype == torch.int8
        assert t.is_contiguous(memory_format=torch.channels_last)
        assert t.shape[2:] == (1, 1) or not t.is_contiguous()
    state = _StaticForward(net, params, device="cpu")
    for p, s in zip(params, state.static):
        if p in conv_w:
            assert s.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(s, p.data()._data)
    for p in conv_w:                  # a new weight version, copied in
        p.data()._data.add_(0)
    state.refresh()
    assert all(s.is_contiguous(memory_format=torch.channels_last)
               for p, s in zip(params, state.static) if p in conv_w)
    assert sorted(get_thresholds(net)) == sorted(th)


# ------------------------------------------------------------ the wrappers
@pytest.mark.parametrize("route", [None, "simple"])
def test_both_routes_refuse_cpu_tensors(route):
    x = torch.zeros((1, 16, 5, 5), dtype=torch.int8)
    w = torch.zeros((16, 16, 3, 3), dtype=torch.int8)
    assert qk.qconv_plan(x.shape, w.shape, (1, 1), (1, 1)).route == "tma"
    launches = (qk.qconv_s8.launches, qk.qgemm_s8.launches)
    with pytest.raises(ValueError, match="CUDA"):
        qk.qconv_s8(x, w, (1, 1), (1, 1), _route=route)
    with pytest.raises(ValueError, match="CUDA"):
        qk.qconv_s8(x.contiguous(memory_format=torch.channels_last), w,
                    _route=route)
    with pytest.raises(ValueError, match="CUDA"):
        qk.qgemm_s8(torch.zeros((2, 32), dtype=torch.int8),
                    torch.zeros((8, 32), dtype=torch.int8), _route=route)
    assert (qk.qconv_s8.launches, qk.qgemm_s8.launches) == launches
    assert qk.layout_copies() == {"x": 0, "w": 0}
