"""The route choice and the tile plan of the Hopper kernels of
``mm_fused``, ``mm_fused_bwd``, ``conv3_fused``, ``conv3_fused_bwd`` and
``dgrad_epilogue`` (``ops/cuda/csrc/conv_fused_sm90.cu``), on the CPU.

The kernels themselves build and run only on the card (``chip_smoke.py``
phase 13 holds them against their twins there). What the CPU can check is
the Python that decides, before every launch, which route a call takes and
how the launch is tiled: every ResNet-50 stage-2/3/4 shape of the lane at
batch 128 takes the Hopper route in bf16; in float32 all five take the
three-piece route ("sm90x3": ``cf90_fwd_x3_kernel``,
``cf90_conv3_x3_kernel``, the ``*_x3`` dual dgrad and wgrad,
``cf90_bwd_dgrad_x3_kernel`` with the wgrad's one set, and
``cf90_conv3_dgrad_x3_kernel`` with ``cf90_conv3_wgrad_x3_kernel``) at
every stage-2/3/4 shape at batch 16 and 128; every shape of the card's
sweep takes the route the plan says;
each tile plan fits the shared memory of a block; the dW row splits cover
the rows exactly once in a fixed order; and the wrappers still refuse CPU
tensors. Shapes at the
lane's sizes are meta tensors: they carry shapes, strides and a 16-byte
aligned (zero) address, and no data."""
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as tcf

SRC = (Path(tcf.__file__).resolve().parent / "csrc" / "conv_fused_sm90.cu")
BF16, F32 = torch.bfloat16, torch.float32


def _act(m, k, dt, device="meta"):
    return torch.empty((m, k), dtype=dt, device=device)


def _vec(n, device="meta"):
    return torch.empty((n,), dtype=F32, device=device)


def _w1x1(k, n, dt, device="meta"):
    """The gluon (O, 1, 1, I) weight viewed as (K, N), as the lane passes
    it (``_fused_resnet._w1x1``)."""
    return torch.empty((n, 1, 1, k), dtype=dt, device=device).reshape(
        n, k).t()


def _lane_forms(stage, dt):
    """(case, route of mm_fused or dgrad_epilogue) of every 1x1 form the
    fused stage runs at one ResNet-50 stage, batch 128."""
    M, mid, c4, _, cin = chip_smoke.RESNET_STAGES[stage]
    xs, x, y2 = _act(M, cin, dt), _act(M, c4, dt), _act(M, mid, dt)
    wc1, wd = _w1x1(cin, mid, dt), _w1x1(cin, c4, dt)
    w, w3 = _w1x1(c4, mid, dt), _w1x1(mid, c4, dt)
    entry_vecs = (_vec(c4), _vec(c4), _vec(c4), _vec(c4))
    acts = (_act(M, mid, dt), _act(M, mid, dt), _act(M, c4, dt),
            _act(M, c4, dt))
    gcs = (torch.empty((3, mid), device="meta"),
           torch.empty((3, c4), device="meta"))
    return {
        "block 0 conv1": tcf.mm_fused_route(xs, wc1),
        "projection": tcf.mm_fused_route(xs, wd),
        "entry": tcf.mm_fused_route(x, w, _act(M, c4, dt), entry_vecs),
        "expand": tcf.mm_fused_route(y2, w3, None, (_vec(mid), _vec(mid))),
        "dual dgrad": tcf.dgrad_epilogue_route(xs, wc1, wd, acts, gcs),
    }


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_resnet_lane_shapes_take_the_sm90_route_in_bf16(stage):
    routes = _lane_forms(stage, BF16)
    assert routes == {case: "sm90" for case in routes}


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_float32_never_takes_the_sm90_route(stage):
    """float32 never takes the bf16 Hopper route: the 1x1 forwards and the
    dual dgrad take the three-piece route."""
    routes = _lane_forms(stage, F32)
    assert routes == {case: "sm90x3" for case in routes}


@pytest.mark.parametrize("mkn", chip_smoke.CONV_MM_SWEEP)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_mm_route(mkn, dt):
    """The card's sweep shapes: K and N are multiples of 8, so bf16 takes
    the Hopper route in every form and float32 the three-piece one."""
    m, k, n = mkn
    x, w = _act(m, k, dt), _w1x1(k, n, dt)
    want = "sm90" if dt == BF16 else "sm90x3"
    assert tcf.mm_fused_route(x, w) == want
    assert tcf.mm_fused_route(x, w, _act(m, k, dt),
                              (_vec(k),) * 4) == want


@pytest.mark.parametrize("shape", chip_smoke.CONV_DUAL_SWEEP)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_dual_route(shape, dt):
    m, k, na, nb = shape
    acts = (_act(m, na, dt), _act(m, na, dt), _act(m, nb, dt),
            _act(m, nb, dt))
    gcs = (torch.empty((3, na), device="meta"),
           torch.empty((3, nb), device="meta"))
    got = tcf.dgrad_epilogue_route(_act(m, k, dt), _w1x1(k, na, dt),
                                   _w1x1(k, nb, dt), acts, gcs)
    assert got == ("sm90" if dt == BF16 else "sm90x3")


def test_shapes_the_tma_cannot_read_take_the_simt_route():
    """K or N not a multiple of 8, a misaligned base, a weight with no unit
    stride, misaligned coefficients, mixed weight layouts, no rows."""
    x, w = _act(256, 64, BF16, "cpu"), _w1x1(64, 32, BF16, "cpu")
    assert tcf.mm_fused_route(x, w) == "sm90"
    assert tcf.mm_fused_route(_act(256, 60, BF16), _w1x1(60, 32, BF16)) \
        == "simt"
    assert tcf.mm_fused_route(_act(256, 64, BF16), _w1x1(64, 36, BF16)) \
        == "simt"
    base = torch.empty((257 * 64,), dtype=BF16)
    assert tcf.mm_fused_route(base[1:1 + 256 * 64].reshape(256, 64), w) \
        == "simt"
    strided = torch.empty((64, 64), dtype=BF16)[:, ::2]
    assert tcf.mm_fused_route(x, strided) == "simt"
    a = torch.empty((65,), dtype=F32)[1:]
    assert tcf.mm_fused_route(x, w, None, (a, a)) == "simt"
    assert tcf.mm_fused_route(x, w, None, (_vec(64, "cpu"),) * 2) == "sm90"
    wk = torch.empty((64, 32), dtype=BF16)          # N contiguous: MN-major
    assert tcf.mm_fused_route(x, wk) == "sm90"
    acts = (_act(256, 32, BF16),) * 4
    assert tcf.dgrad_epilogue_route(x, w, wk, acts) == "simt"
    assert tcf.dgrad_epilogue_route(x, w, w, acts) == "sm90"
    assert tcf.dgrad_epilogue_route(_act(0, 64, BF16), w, w, acts) == "simt"


@pytest.mark.parametrize("n_raw", [1, 2])
@pytest.mark.parametrize("bn", [64, 128, 256])
def test_every_plan_fits_a_block(bn, n_raw):
    plan = tcf.sm90_plan(bn, n_raw)
    assert plan["bn"] % 8 == 0 and plan["bn"] <= 256
    assert 3 <= plan["stages"] <= 4
    assert plan["smem_bytes"] <= tcf.SM90_SMEM_LIMIT
    # the epilogue's bf16 staging tile and its column sums reuse the ring
    assert 128 * bn * 2 + 2 * 2 * 256 * 4 <= plan["stages"] \
        * plan["stage_bytes"]


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_lane_widths_plan_a_legal_tile(stage):
    M, mid, c4, _, cin = chip_smoke.RESNET_STAGES[stage]
    for width in (mid, c4, cin):
        bn = tcf.sm90_bn(width)
        assert bn in (64, 128, 256) and (bn >= width or bn == 256)
        for n_raw in (1, 2):
            assert tcf.sm90_plan(bn, n_raw)["smem_bytes"] \
                <= tcf.SM90_SMEM_LIMIT


def test_python_plan_mirrors_the_kernel_source():
    """conv_fused_sm90.cu's tile constants and its stage rule are the ones
    ``sm90_plan`` reproduces."""
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert consts["kBM"].split()[0] == str(tcf.SM90_BM)
    assert consts["kBK"].split()[0] == str(tcf.SM90_BK)
    assert eval(consts["kStageBudget"]) == tcf._SM90_STAGE_BUDGET
    assert "kStage = kCoef + 1024" in src
    assert "kSmem = kStages * kStage + 1024" in src
    for bn in (64, 128, 256):
        for n_raw in (1, 2):
            stage = n_raw * 2 * 64 * 128 + bn * 64 * 2 + 1024
            stages = min(4, tcf._SM90_STAGE_BUDGET // stage)
            assert tcf.sm90_plan(bn, n_raw) == {
                "bn": bn, "stages": stages, "stage_bytes": stage,
                "smem_bytes": stages * stage + 1024}


_SPLIT_SHAPES = [(1, 8, 8, 8), (63, 8, 24, 16), (64, 8, 8, 8),
                 (65, 72, 40, 40), (300, 72, 40, 40), (1000, 64, 256, 128)] \
    + [(M, mid, c4, cin) for M, mid, c4, _, cin
       in chip_smoke.RESNET_STAGES.values()] \
    + [(M, n, 0, k) for M, mid, c4, _, _ in chip_smoke.RESNET_STAGES.values()
       for n, k in ((c4, mid), (mid, c4))]   # mm_fused_bwd's one-set wgrad


@pytest.mark.parametrize("m,na,nb,k", _SPLIT_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_wgrad_splits_cover_the_rows_once_in_a_fixed_order(m, na, nb, k,
                                                            sms):
    splits, chunk = tcf.sm90_wgrad_split(m, na, nb, k, sms)
    assert chunk % tcf.SM90_BK == 0 and 1 <= splits <= 65535
    rows = [r for s in range(splits)
            for r in range(s * chunk, min(m, (s + 1) * chunk))]
    assert rows == list(range(m))
    assert (splits - 1) * chunk < m <= splits * chunk
    assert tcf.sm90_wgrad_split(m, na, nb, k, sms) == (splits, chunk)


def test_stage3_dual_wgrad_fills_the_card():
    """At stage 3 the (1280 x 512) dW is 20 tiles of 128 x 256: six splits
    put 120 blocks on the 132 SMs in one wave."""
    M, mid, c4, _, cin = chip_smoke.RESNET_STAGES[3]
    assert tcf.sm90_wgrad_split(M, mid, c4, cin, 132) == (6, 4224)


@pytest.mark.parametrize("kernel", ["mm_fused", "dgrad_epilogue"])
@pytest.mark.parametrize("route", [None, "simt"])
def test_bf16_wrappers_refuse_cpu_tensors_on_either_route(kernel, route):
    x = torch.randn(256, 64).to(BF16)
    w = _w1x1(64, 32, BF16, "cpu").normal_()
    g = torch.randn(256, 32).to(BF16)
    gc = torch.randn(3, 32)
    call = {"mm_fused": lambda: tcf.mm_fused(x, w, _route=route),
            "dgrad_epilogue": lambda: tcf.dgrad_epilogue(
                w, w, x, g, g, gc, g, g, gc, _route=route)}[kernel]
    assert tcf.mm_fused_route(x, w) == "sm90"
    fn = getattr(tcf, kernel)
    before = (fn.launches, fn.sm90_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert (fn.launches, fn.sm90_launches) == before


def test_reset_clears_the_sm90_counts():
    tcf.mm_fused.sm90_launches += 3
    assert common.sm90_launch_counts()["mm_fused"] >= 3
    common.reset_launch_counts()
    assert set(common.sm90_launch_counts().values()) == {0}
    assert set(common.launch_counts().values()) == {0}


def test_the_library_builds_the_sm90_source():
    assert SRC in common.SOURCES
    assert SRC.with_name("sm90_gemm.cuh").exists()
    for fn in ("mxt_conv_fused_sm90_fwd", "mxt_conv_fused_sm90_dual_dgrad",
               "mxt_conv_fused_sm90_dual_wgrad", "mxt_conv_fused_sm90_bwd_dgrad",
               "mxt_conv_fused_sm90_conv3", "mxt_conv_fused_sm90_conv3_bwd"):
        assert fn in common._SIGNATURES
        assert fn in SRC.with_name("bindings.cpp").read_text()


# ------------------------------------------ mm_fused_bwd and conv3_fused
def _w3x3(c, n, dt, device="meta"):
    """The gluon (O, 3, 3, I) weight viewed as (9, C, N), as the lane
    passes it (``_fused_resnet._w3x3``)."""
    return torch.empty((n, 3, 3, c), dtype=dt, device=device).permute(
        1, 2, 3, 0).reshape(9, c, n)


def _bwd_conv3_lane_forms(stage, dt):
    """(case, route) of every mm_fused_bwd and conv3_fused form the fused
    stage runs at one ResNet-50 stage, batch 128: the expand form (every
    block's conv3 backward: G on load, a and b, mask z, x its partner), the
    entry form (a middle block's conv1 backward: G on load, dsc, mask x,
    one or two partners) and the 3x3 forward."""
    M, mid, c4, _, _ = chip_smoke.RESNET_STAGES[stage]
    y2, x_in = _act(M, mid, dt), _act(M, c4, dt)
    gc_mid = torch.empty((3, mid), device="meta")
    gc_c4 = torch.empty((3, c4), device="meta")
    expand = tcf.mm_fused_bwd_route(
        y2, _w1x1(mid, c4, dt), (_act(M, c4, dt), _act(M, c4, dt), y2),
        (_vec(mid), _vec(mid), gc_c4))
    entry = {p: tcf.mm_fused_bwd_route(
        x_in, _w1x1(c4, mid, dt),
        (_act(M, mid, dt), _act(M, mid, dt), _act(M, c4, dt))
        + tuple(_act(M, c4, dt) for _ in range(p)), (gc_mid,))
        for p in (1, 2)}
    conv3 = tcf.conv3_fused_route(_act(M, mid, dt), _w3x3(mid, mid, dt),
                                  (_vec(mid), _vec(mid)))
    return {"expand": expand, "entry 1 partner": entry[1],
            "entry 2 partners": entry[2], "3x3": conv3}


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_lane_backward_and_3x3_forms_take_the_sm90_route_in_bf16(stage):
    routes = _bwd_conv3_lane_forms(stage, BF16)
    assert routes == {case: "sm90" for case in routes}


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_float32_backward_and_3x3_forms_never_take_the_sm90_route(stage):
    """float32 never takes the bf16 Hopper route: the 1x1 backwards and
    the 3x3 forward take the three-piece route."""
    routes = _bwd_conv3_lane_forms(stage, F32)
    assert routes == {case: "sm90x3" for case in routes}


@pytest.mark.parametrize("mkn", chip_smoke.CONV_MM_SWEEP)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_bwd_route(mkn, dt):
    """Every form of the card's mm_fused_bwd sweep: G direct or on load,
    masks, dsc, partners, the expand form; bf16 on the Hopper kernels,
    float32 on the three-piece ones."""
    m, k, n = mkn
    x, w = _act(m, k, dt), _w1x1(k, n, dt)
    want = "sm90" if dt == BF16 else "sm90x3"
    g, dsc = _act(m, n, dt), _act(m, k, dt)
    gc = torch.empty((3, n), device="meta")
    assert tcf.mm_fused_bwd_route(x, w, (g, None, None, None, x),
                                  (_vec(k), _vec(k), None)) == want
    assert tcf.mm_fused_bwd_route(x, w, (None, g, g, dsc, x, dsc),
                                  (None, None, gc)) == want
    assert tcf.mm_fused_bwd_route(x, w, (None, g, g, None, x),
                                  (_vec(k), _vec(k), gc)) == want


@pytest.mark.parametrize("bhwcn", [(1, 7, 16, 32), (3, 7, 32, 48),
                                   (2, 9, 72, 64), (3, 14, 72, 136),
                                   (2, 28, 64, 64)])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_conv3_route(bhwcn, dt):
    """The card's 3x3 sweep with the gluon weight view (a K-major B), the
    one layout the bf16 Hopper kernel is built for; a contiguous (9, C, N)
    weight takes the SIMT kernel in bf16 and the three-piece kernel in
    float32 (the split kernel copies either layout's pieces out)."""
    B, hw, c, n = bhwcn
    x2 = _act(B * hw * hw, c, dt)
    want = "sm90" if dt == BF16 else "sm90x3"
    vecs = (_vec(c), _vec(c))
    assert tcf.conv3_fused_route(x2, _w3x3(c, n, dt), vecs) == want
    assert tcf.conv3_fused_route(
        x2, torch.empty((9, c, n), dtype=dt, device="meta"), vecs) == (
        "simt" if dt == BF16 else "sm90x3")


def test_bwd_and_conv3_shapes_the_tma_cannot_read_take_the_simt_route():
    """K, N or C not a multiple of 8, no rows, a misaligned activation or
    vector, a weight with no unit stride or in the layout the kernels are
    not built for (not the gluon view's), a 3x3 weight whose taps are not
    one (9 C, N) matrix."""
    x, w = _act(256, 64, BF16), _w1x1(64, 32, BF16)
    assert tcf.mm_fused_bwd_route(x, w) == "sm90"
    assert tcf.mm_fused_bwd_route(_act(256, 60, BF16),
                                  _w1x1(60, 32, BF16)) == "simt"
    assert tcf.mm_fused_bwd_route(x, _w1x1(64, 36, BF16)) == "simt"
    assert tcf.mm_fused_bwd_route(_act(0, 64, BF16), w) == "simt"
    base = torch.empty((257 * 64,), dtype=BF16)
    odd = base[1:1 + 256 * 64].reshape(256, 64)
    assert tcf.mm_fused_bwd_route(x, w, (None, None, None, odd)) == "simt"
    a = torch.empty((65,), dtype=F32)[1:]
    assert tcf.mm_fused_bwd_route(x, w, (), (a, a, None)) == "simt"
    strided = torch.empty((64, 64), dtype=BF16)[:, ::2]
    assert tcf.mm_fused_bwd_route(x, strided) == "simt"
    assert tcf.mm_fused_bwd_route(x, torch.empty((64, 32), dtype=BF16)) \
        == "simt"
    x2 = _act(2 * 49, 16, BF16)
    assert tcf.conv3_fused_route(x2, _w3x3(16, 32, BF16)) == "sm90"
    assert tcf.conv3_fused_route(_act(2 * 49, 12, BF16),
                                 _w3x3(12, 32, BF16)) == "simt"
    assert tcf.conv3_fused_route(x2, _w3x3(16, 36, BF16)) == "simt"
    assert tcf.conv3_fused_route(_act(0, 16, BF16),
                                 _w3x3(16, 32, BF16)) == "simt"
    # (3, 3, N, C) permuted to (9, C, N): the tap stride is not C times
    # the channel stride
    taps = torch.empty((3, 3, 32, 16), dtype=BF16).permute(
        0, 1, 3, 2).reshape(9, 16, 32)
    assert tcf.conv3_fused_route(x2, taps) == "simt"
    wide = torch.empty((9, 16, 64), dtype=BF16)[:, :, ::2]
    assert tcf.conv3_fused_route(x2, wide) == "simt"
    assert tcf.conv3_fused_route(x2, _w3x3(16, 32, BF16), (a[:16], a[:16])) \
        == "simt"
    # float32 takes the three-piece kernel, under the same shape rules
    assert tcf.conv3_fused_route(x2.float(), _w3x3(16, 32, F32)) == "sm90x3"


# the raw A operands a stage of each Hopper kernel holds: its Plan<BN, n>
_KERNEL_PLANS = {"cf90_fwd_kernel": "REGA ? 2 : 1",
                 "cf90_dual_dgrad_kernel": "2",
                 "cf90_dual_wgrad_kernel": "1",
                 "cf90_bwd_dgrad_kernel": "2, kBwdStage",
                 "cf90_conv3_kernel": "1",
                 "cf90_conv3_dgrad_kernel": "2, kBwdStage",
                 "cf90_conv3_wgrad_kernel": "1"}
# the backward dgrad's static shared memory: its barriers and the column
# sums of two epilogue chunks, red[2][8][3][64] float32
_BWD_STATIC = 2 * 8 * 8 + 2 * 8 * 3 * 64 * 4


def test_new_kernels_plans_mirror_the_source_and_fit():
    """Each kernel's ``Plan<BN, ...>`` in conv_fused_sm90.cu is the one
    listed here; the backward dgrad's minimum stage is
    ``SM90_BWD_STAGE`` (four 128 x 64 epilogue tiles and a and b); every
    plan of the new kernels fits a block's shared memory with the static
    arrays, and the 3x3 kernel's epilogue staging fits its ring."""
    src = SRC.read_text()
    for kernel, args in _KERNEL_PLANS.items():
        body = src[src.index(f"\n{kernel}("):]
        assert re.search(r"using P = Plan<BN, ([^>]+)>;", body).group(1) \
            == args
    assert "constexpr int kBwdStage = 4 * kA + 1024;" in src
    assert "__shared__ float red[2][8][3][64];" in src
    assert tcf.SM90_BWD_STAGE == 4 * 2 * 64 * 128 + 1024
    for bn in (64, 128, 256):
        dgrad = tcf.sm90_plan(bn, 2, tcf.SM90_BWD_STAGE)
        conv3 = tcf.sm90_plan(bn, 1)
        assert dgrad["stage_bytes"] == max(
            tcf.SM90_BWD_STAGE, tcf.sm90_plan(bn, 2)["stage_bytes"])
        assert dgrad["smem_bytes"] + _BWD_STATIC <= tcf.SM90_SMEM_LIMIT
        assert conv3["smem_bytes"] <= tcf.SM90_SMEM_LIMIT
        for plan in (dgrad, conv3):
            assert 3 <= plan["stages"] <= 4
        assert 128 * bn * 2 + 2 * 2 * 256 * 4 <= conv3["stages"] \
            * conv3["stage_bytes"]


@pytest.mark.parametrize("kernel", ["mm_fused_bwd", "conv3_fused"])
@pytest.mark.parametrize("route", [None, "simt"])
def test_bwd_and_conv3_wrappers_refuse_cpu_tensors(kernel, route):
    x = torch.randn(98, 16).to(BF16)
    w = _w1x1(16, 32, BF16, "cpu").normal_()
    w9 = _w3x3(16, 32, BF16, "cpu").normal_()
    g = torch.randn(98, 32).to(BF16)
    a, b = torch.ones(16), torch.zeros(16)
    call = {"mm_fused_bwd": lambda: tcf.mm_fused_bwd(w, x, g=g,
                                                     _route=route),
            "conv3_fused": lambda: tcf.conv3_fused(x, w9, a, b, (2, 7, 7),
                                                   _route=route)}[kernel]
    fn = getattr(tcf, kernel)
    before = (fn.launches, fn.sm90_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert (fn.launches, fn.sm90_launches) == before


# ------------------------------------------------------ conv3_fused_bwd
def _conv3_bwd_route(M, c, n, dt, w9=None, x2=None, acts=None, vecs=None):
    x2 = _act(M, c, dt) if x2 is None else x2
    w9 = _w3x3(c, n, dt) if w9 is None else w9
    acts = (_act(M, n, dt), _act(M, n, dt)) if acts is None else acts
    vecs = ((_vec(c), _vec(c), torch.empty((3, n), device="meta"))
            if vecs is None else vecs)
    return tcf.conv3_fused_bwd_route(x2, w9, acts, vecs)


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_lane_conv3_bwd_takes_the_sm90_route_in_bf16_only(stage, dt):
    """Every one of the lane's 13 conv3_fused_bwd launches (a middle or
    first block's 3x3 at stages 2-4, batch 128, the gluon weight's view,
    G on load) takes the bf16 Hopper kernels in bf16 only, and in float32
    the three-piece kernels."""
    M, mid, _, _, _ = chip_smoke.RESNET_STAGES[stage]
    assert _conv3_bwd_route(M, mid, mid, dt) == (
        "sm90" if dt == BF16 else "sm90x3")


@pytest.mark.parametrize("bhwcn", [(1, 7, 16, 32), (3, 7, 32, 48),
                                   (1, 14, 32, 64), (2, 14, 64, 32),
                                   (1, 28, 16, 16), (2, 28, 64, 64),
                                   (2, 9, 72, 64), (3, 14, 72, 136)])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_conv3_bwd_route(bhwcn, dt):
    """The card's 3x3 sweep (phase 13) with the gluon weight view: bf16 on
    the Hopper kernels, float32 on the three-piece ones; a contiguous
    (9, C, N) weight takes the SIMT kernels in bf16 and the three-piece
    ones in float32 (the split kernel copies either layout's pieces
    out)."""
    B, hw, c, n = bhwcn
    M = B * hw * hw
    assert _conv3_bwd_route(M, c, n, dt) == (
        "sm90" if dt == BF16 else "sm90x3")
    assert _conv3_bwd_route(
        M, c, n, dt, w9=torch.empty((9, c, n), dtype=dt, device="meta")) \
        == ("simt" if dt == BF16 else "sm90x3")


def test_conv3_bwd_shapes_the_tma_cannot_read_take_the_simt_route():
    """C or N not a multiple of 8, no rows, a misaligned activation or
    vector, a weight whose taps are not the gluon view's MN-major B."""
    assert _conv3_bwd_route(98, 16, 32, BF16) == "sm90"
    assert _conv3_bwd_route(98, 12, 32, BF16) == "simt"
    assert _conv3_bwd_route(98, 16, 36, BF16) == "simt"
    assert _conv3_bwd_route(0, 16, 32, BF16) == "simt"
    base = torch.empty((99 * 32,), dtype=BF16)
    odd = base[1:1 + 98 * 32].reshape(98, 32)
    assert _conv3_bwd_route(98, 16, 32, BF16, acts=(odd, odd)) == "simt"
    a = torch.empty((17,), dtype=F32)[1:]
    gc = torch.empty((3, 32), device="meta")
    assert _conv3_bwd_route(98, 16, 32, BF16, vecs=(a, a, gc)) == "simt"
    taps = torch.empty((3, 3, 32, 16), dtype=BF16).permute(
        0, 1, 3, 2).reshape(9, 16, 32)
    assert _conv3_bwd_route(98, 16, 32, BF16, w9=taps) == "simt"
    wide = torch.empty((9, 16, 64), dtype=BF16)[:, :, ::2]
    assert _conv3_bwd_route(98, 16, 32, BF16, w9=wide) == "simt"


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_conv3_wgrad_split_fills_the_card(stage):
    """The 3x3 wgrad's output tiles are (N / 128) x 9 taps x (C / bn); the
    split puts at least 120 blocks on 132 SMs at every stage (stage 3's 18
    tiles in 7 splits of 3584 rows) and covers the rows once."""
    M, mid, _, _, _ = chip_smoke.RESNET_STAGES[stage]
    splits, chunk = tcf.sm90_wgrad_split(M, mid, 0, mid, 132, 9)
    tiles = -(-mid // 128) * 9 * -(-mid // tcf.sm90_bn(mid))
    assert tiles * splits >= 120
    assert (splits - 1) * chunk < M <= splits * chunk
    assert chunk % tcf.SM90_BK == 0
    if stage == 3:
        assert (tiles, splits, chunk) == (18, 7, 3584)
    # one tap a column tile: the 1x1 form's split is unchanged by taps=1
    assert tcf.sm90_wgrad_split(M, mid, 0, mid, 132) \
        == tcf.sm90_wgrad_split(M, mid, 0, mid, 132, 1)


def test_conv3_bwd_kernels_plans_fit_a_block():
    """The 3x3 dgrad runs mm_fused_bwd's dgrad tile (its plan and static
    column sums) over nine taps; its wgrad the one-operand plan; both fit
    a block's shared memory at every tile width."""
    src = SRC.read_text()
    body = src[src.index("\nbwd_dgrad_tile("):]
    assert "__shared__ float red[2][8][3][64];" in body
    assert "cf90_conv3_dgrad_kernel<BN>>(\n      Plan<BN, 2, kBwdStage>::kSmem" \
        in src
    assert "launch<cf90_conv3_wgrad_kernel<BN>>(Plan<BN, 1>::kSmem" in src
    for bn in (64, 128, 256):
        dgrad = tcf.sm90_plan(bn, 2, tcf.SM90_BWD_STAGE)
        wgrad = tcf.sm90_plan(bn, 1)
        assert dgrad["smem_bytes"] + _BWD_STATIC <= tcf.SM90_SMEM_LIMIT
        assert wgrad["smem_bytes"] <= tcf.SM90_SMEM_LIMIT
        assert 3 <= dgrad["stages"] <= 4 and 3 <= wgrad["stages"] <= 4


@pytest.mark.parametrize("route", [None, "simt"])
def test_conv3_bwd_wrapper_refuses_cpu_tensors_on_either_route(route):
    x = torch.randn(98, 16).to(BF16)
    w9 = _w3x3(16, 32, BF16, "cpu").normal_()
    g = torch.randn(98, 32).to(BF16)
    a, b, gc = torch.ones(16), torch.zeros(16), torch.randn(3, 32)
    assert _conv3_bwd_route(98, 16, 32, BF16, w9=w9, x2=x,
                            acts=(g, g), vecs=(a, b, gc)) == "sm90"
    fn = tcf.conv3_fused_bwd
    before = (fn.launches, fn.sm90_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(w9, x, a, b, g, g, gc, (2, 7, 7), _route=route)
    assert (fn.launches, fn.sm90_launches) == before


# ---------------------------------- the float32 route (three bf16 pieces)
def _x3_lane_routes(stage, batch):
    """{form: route} of every float32 conv form of one ResNet-50 stage's
    fused blocks at ``batch``: conv3_fused, the dual dgrad and the 1x1
    backwards (expand and entry), which take the three-piece route, and
    the other two forms."""
    _, mid, c4, hw, cin = chip_smoke.RESNET_STAGES[stage]
    M = batch * hw * hw
    xs, x, y2 = _act(M, cin, F32), _act(M, c4, F32), _act(M, mid, F32)
    wc1, wd = _w1x1(cin, mid, F32), _w1x1(cin, c4, F32)
    acts = (_act(M, mid, F32), _act(M, mid, F32), _act(M, c4, F32),
            _act(M, c4, F32))
    gcs = (torch.empty((3, mid), device="meta"),
           torch.empty((3, c4), device="meta"))
    return {
        "3x3": tcf.conv3_fused_route(_act(M, mid, F32), _w3x3(mid, mid, F32),
                                     (_vec(mid), _vec(mid))),
        "dual dgrad": tcf.dgrad_epilogue_route(xs, wc1, wd, acts, gcs),
        "entry": tcf.mm_fused_route(x, _w1x1(c4, mid, F32), _act(M, c4, F32),
                                    (_vec(c4),) * 4),
        "expand bwd": tcf.mm_fused_bwd_route(
            y2, _w1x1(mid, c4, F32), (_act(M, c4, F32),) * 2 + (y2,),
            (_vec(mid), _vec(mid), gcs[1])),
        "entry bwd": tcf.mm_fused_bwd_route(
            x, _w1x1(c4, mid, F32), acts[:2] + (_act(M, c4, F32),) * 2,
            (gcs[0],)),
        "3x3 bwd": _conv3_bwd_route(M, mid, mid, F32),
    }


@pytest.mark.parametrize("batch", [16, 128])
@pytest.mark.parametrize("stage", [2, 3, 4])
def test_float32_conv3_and_dual_dgrad_take_the_x3_route(stage, batch):
    """At every stage-2/3/4 shape at batch 16 (the float32 truth phase's)
    and 128 (the lane's), every float32 form takes the three-piece
    kernels: mm_fused, conv3_fused, dgrad_epilogue, mm_fused_bwd and
    conv3_fused_bwd."""
    routes = _x3_lane_routes(stage, batch)
    assert routes == {"3x3": "sm90x3", "dual dgrad": "sm90x3",
                      "entry": "sm90x3", "expand bwd": "sm90x3",
                      "entry bwd": "sm90x3", "3x3 bwd": "sm90x3"}


def test_float32_shapes_the_x3_route_cannot_take_take_simt():
    """C, N or K not a multiple of 8, no rows, a misaligned activation or
    vector, a weight with no unit stride, 3x3 taps that are not one
    (9 C, N) matrix, mixed types."""
    x2, w9 = _act(98, 16, F32), _w3x3(16, 32, F32)
    assert tcf.conv3_fused_route(x2, w9) == "sm90x3"
    assert tcf.conv3_fused_route(_act(98, 12, F32), _w3x3(12, 32, F32)) \
        == "simt"
    assert tcf.conv3_fused_route(x2, _w3x3(16, 36, F32)) == "simt"
    assert tcf.conv3_fused_route(_act(0, 16, F32), w9) == "simt"
    base = torch.empty((99 * 16,), dtype=F32)
    assert tcf.conv3_fused_route(base[1:1 + 98 * 16].reshape(98, 16), w9) \
        == "simt"
    a = torch.empty((17,), dtype=F32)[1:]
    assert tcf.conv3_fused_route(x2, w9, (a, a)) == "simt"
    taps = torch.empty((3, 3, 32, 16), dtype=F32).permute(
        0, 1, 3, 2).reshape(9, 16, 32)
    assert tcf.conv3_fused_route(x2, taps) == "simt"
    wide = torch.empty((9, 16, 64), dtype=F32)[:, :, ::2]
    assert tcf.conv3_fused_route(x2, wide) == "simt"
    assert tcf.conv3_fused_route(x2, w9.to(BF16)) == "simt"
    x, w = _act(256, 64, F32), _w1x1(64, 32, F32)
    acts = (_act(256, 32, F32),) * 4
    assert tcf.dgrad_epilogue_route(x, w, w, acts) == "sm90x3"
    # the two weights need not share a layout: each is split on its own
    assert tcf.dgrad_epilogue_route(
        x, w, torch.empty((64, 32), dtype=F32), acts) == "sm90x3"
    assert tcf.dgrad_epilogue_route(_act(256, 60, F32), _w1x1(60, 32, F32),
                                    _w1x1(60, 32, F32), acts) == "simt"
    assert tcf.dgrad_epilogue_route(x, _w1x1(64, 36, F32), w, acts) == "simt"
    assert tcf.dgrad_epilogue_route(_act(0, 64, F32), w, w, acts) == "simt"
    odd = torch.empty((257 * 32,), dtype=F32)[1:1 + 256 * 32].reshape(256, 32)
    assert tcf.dgrad_epilogue_route(x, w, w, (odd,) + acts[1:]) == "simt"
    strided = torch.empty((64, 64), dtype=F32)[:, ::2]
    assert tcf.dgrad_epilogue_route(x, strided, w, acts) == "simt"
    assert tcf.dgrad_epilogue_route(x, w, w, acts, (a, a)) == "simt"
    # mm_fused_bwd: either weight layout is split; the same shape rules
    assert tcf.mm_fused_bwd_route(x, w, acts) == "sm90x3"
    assert tcf.mm_fused_bwd_route(
        x, torch.empty((64, 32), dtype=F32), acts) == "sm90x3"
    assert tcf.mm_fused_bwd_route(_act(256, 60, F32),
                                  _w1x1(60, 32, F32)) == "simt"
    assert tcf.mm_fused_bwd_route(x, _w1x1(64, 36, F32)) == "simt"
    assert tcf.mm_fused_bwd_route(_act(0, 64, F32), w) == "simt"
    assert tcf.mm_fused_bwd_route(x, w, (odd,)) == "simt"
    assert tcf.mm_fused_bwd_route(x, strided) == "simt"
    assert tcf.mm_fused_bwd_route(x, w, (), (a, a, None)) == "simt"
    assert tcf.mm_fused_bwd_route(x, w.to(BF16)) == "simt"
    # mm_fused: either weight layout is split; x and sc as the TMA reads
    # them, the coefficient vectors 16-byte aligned
    sc = _act(256, 64, F32)
    assert tcf.mm_fused_route(x, w) == "sm90x3"
    assert tcf.mm_fused_route(x, torch.empty((64, 32), dtype=F32), sc,
                              (_vec(64),) * 4) == "sm90x3"
    assert tcf.mm_fused_route(_act(256, 60, F32),
                              _w1x1(60, 32, F32)) == "simt"
    assert tcf.mm_fused_route(x, _w1x1(64, 36, F32)) == "simt"
    assert tcf.mm_fused_route(_act(0, 64, F32), w) == "simt"
    odd_k = torch.empty((257 * 64,), dtype=F32)[1:1 + 256 * 64].reshape(
        256, 64)
    assert tcf.mm_fused_route(odd_k, w) == "simt"
    assert tcf.mm_fused_route(x, w, odd_k) == "simt"
    assert tcf.mm_fused_route(x, strided) == "simt"
    assert tcf.mm_fused_route(x, w, sc, (a, a, None, None)) == "simt"
    assert tcf.mm_fused_route(x, w.to(BF16)) == "simt"
    # conv3_fused_bwd: either weight layout is split; x2, dzn and yout as
    # the TMA reads them, a, b and gcoef 16-byte aligned, one (9 C, N)
    # matrix of taps
    assert _conv3_bwd_route(98, 16, 32, F32) == "sm90x3"
    assert _conv3_bwd_route(98, 16, 32, F32, w9=torch.empty(
        (9, 16, 32), dtype=F32)) == "sm90x3"
    assert _conv3_bwd_route(98, 12, 32, F32) == "simt"
    assert _conv3_bwd_route(98, 16, 36, F32) == "simt"
    assert _conv3_bwd_route(0, 16, 32, F32) == "simt"
    odd_n = torch.empty((99 * 32,), dtype=F32)[1:1 + 98 * 32].reshape(98, 32)
    assert _conv3_bwd_route(98, 16, 32, F32, acts=(odd_n, odd_n)) == "simt"
    assert _conv3_bwd_route(98, 16, 32, F32,
                            x2=base[1:1 + 98 * 16].reshape(98, 16)) == "simt"
    gc = torch.empty((3, 32), device="meta")
    assert _conv3_bwd_route(98, 16, 32, F32, vecs=(a, a, gc)) == "simt"
    assert _conv3_bwd_route(98, 16, 32, F32, w9=taps) == "simt"
    assert _conv3_bwd_route(98, 16, 32, F32, w9=wide) == "simt"
    assert _conv3_bwd_route(98, 16, 32, F32, w9=w9.to(BF16)) == "simt"
    assert _conv3_bwd_route(98, 16, 32, F32, x2=x2.to(BF16)) == "simt"


@pytest.mark.parametrize("kernel", ["mm_fused", "conv3_fused",
                                    "dgrad_epilogue", "mm_fused_bwd",
                                    "conv3_fused_bwd"])
@pytest.mark.parametrize("route", [None, "simt"])
def test_float32_wrappers_refuse_cpu_tensors_on_either_route(kernel, route):
    x = torch.randn(98, 16)
    w9 = _w3x3(16, 32, F32, "cpu").normal_()
    w = _w1x1(16, 32, F32, "cpu").normal_()
    g, gc = torch.randn(98, 32), torch.randn(3, 32)
    a, b = torch.ones(16), torch.zeros(16)
    call = {"mm_fused": lambda: tcf.mm_fused(
                x, w, a=a, b=b, sc=x, asc=a, bsc=b, emit_xhat=True,
                _route=route),
            "conv3_fused": lambda: tcf.conv3_fused(x, w9, a, b, (2, 7, 7),
                                                   _route=route),
            "dgrad_epilogue": lambda: tcf.dgrad_epilogue(
                w, w, x, g, g, gc, g, g, gc, _route=route),
            "mm_fused_bwd": lambda: tcf.mm_fused_bwd(
                w, x, dzn=g, yout=g, gcoef=gc, a=a, b=b, out_mask="z",
                partners=(x,), _route=route),
            "conv3_fused_bwd": lambda: tcf.conv3_fused_bwd(
                w9, x, a, b, g, g, gc, (2, 7, 7), _route=route)}[kernel]
    assert tcf.mm_fused_route(x, w, x, (a, b, a, b)) == "sm90x3"
    assert tcf.conv3_fused_route(x, w9, (a, b)) == "sm90x3"
    assert tcf.dgrad_epilogue_route(x, w, w, (g,) * 4, (gc, gc)) == "sm90x3"
    assert tcf.mm_fused_bwd_route(x, w, (g, g, x), (a, b, gc)) == "sm90x3"
    assert tcf.conv3_fused_bwd_route(x, w9, (g, g), (a, b, gc)) == "sm90x3"
    fn = getattr(tcf, kernel)
    before = (fn.launches, fn.sm90_launches, fn.x3_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert (fn.launches, fn.sm90_launches, fn.x3_launches) == before


def test_reset_clears_the_x3_counts():
    tcf.conv3_fused.x3_launches += 2
    assert common.x3_launch_counts()["conv3_fused"] >= 2
    common.reset_launch_counts()
    assert set(common.x3_launch_counts().values()) == {0}


def test_the_library_exports_the_x3_entry_points():
    """Each float32-route entry point is in bindings.cpp with as many
    parameters as its ctypes signature."""
    bindings = SRC.with_name("bindings.cpp").read_text()
    for fn in ("mxt_conv_fused_sm90_split3", "mxt_conv_fused_sm90_fwd_x3",
               "mxt_conv_fused_sm90_conv3_x3",
               "mxt_conv_fused_sm90_dual_dgrad_x3",
               "mxt_conv_fused_sm90_bwd_dgrad_x3",
               "mxt_conv_fused_sm90_dual_wgrad_x3",
               "mxt_conv_fused_sm90_conv3_bwd_x3"):
        params = re.search(rf"int {fn}\(([^)]*)\)", bindings).group(1)
        assert len(params.split(",")) == len(common._SIGNATURES[fn])


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_x3_wgrad_split_covers_the_rows_and_fills_the_card(stage):
    """The float32 route's dual wgrad (128 x 128 tiles, six products a
    row): its split covers the rows once and, at the lane's shapes, puts
    at least 120 blocks on the 132 SMs."""
    M, mid, c4, _, cin = chip_smoke.RESNET_STAGES[stage]
    splits, chunk = tcf.sm90_wgrad_split(M, mid, c4, cin, 132, x3=True)
    tiles = (-(-mid // 128) - (-c4 // 128)) * -(-cin // tcf.SM90_X3_BN)
    assert chunk % tcf.SM90_BK == 0 and (splits - 1) * chunk < M \
        <= splits * chunk
    assert tiles * splits >= 120
    if stage == 3:
        assert (tiles, splits, chunk) == (40, 3, 8384)


@pytest.mark.parametrize("kernel", ["mm_fused", "conv3_fused",
                                    "dgrad_epilogue", "mm_fused_bwd",
                                    "conv3_fused_bwd"])
def test_float32_rows_past_the_x3_grid_take_simt(kernel):
    """The three-piece kernels put their 128-row tiles on gridDim.y, so at
    most 65535 of them: one more row takes the SIMT kernels, decided
    before the launch."""
    limit = tcf.SM90_X3_MAX_ROWS
    assert limit == 65535 * 128
    c, n = 64, 64
    if kernel == "mm_fused":
        def route(m):
            return tcf.mm_fused_route(_act(m, c, F32), _w1x1(c, n, F32),
                                      _act(m, c, F32))
    elif kernel == "conv3_fused":
        def route(m):
            return tcf.conv3_fused_route(_act(m, c, F32), _w3x3(c, n, F32))
    elif kernel == "conv3_fused_bwd":
        def route(m):
            return _conv3_bwd_route(m, c, n, F32)
    elif kernel == "mm_fused_bwd":
        def route(m):
            return tcf.mm_fused_bwd_route(
                _act(m, c, F32), _w1x1(c, n, F32), (_act(m, n, F32),) * 2)
    else:
        def route(m):
            return tcf.dgrad_epilogue_route(
                _act(m, c, F32), _w1x1(c, n, F32), _w1x1(c, n, F32),
                (_act(m, n, F32),) * 4)
    assert route(limit) == "sm90x3"
    assert route(limit + 1) == "simt"


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_x3_conv3_wgrad_split_covers_the_rows_and_fills_the_card(stage):
    """The float32 3x3 wgrad (128 x 128 tiles, one tap a column tile, six
    products a row): its split covers the rows once and, at the lane's
    shapes, puts at least 120 blocks on the 132 SMs."""
    M, mid, _, _, _ = chip_smoke.RESNET_STAGES[stage]
    splits, chunk = tcf.sm90_wgrad_split(M, mid, 0, mid, 132, 9, x3=True)
    tiles = -(-mid // 128) * 9 * -(-mid // tcf.SM90_X3_BN)
    assert chunk % tcf.SM90_BK == 0 and (splits - 1) * chunk < M \
        <= splits * chunk
    assert tiles * splits >= 120
    if stage == 3:
        assert (tiles, splits, chunk) == (36, 11, 2304)
