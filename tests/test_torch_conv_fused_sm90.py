"""The route choice and the tile plan of the Hopper kernels of
``mm_fused`` and ``dgrad_epilogue`` (``ops/cuda/csrc/conv_fused_sm90.cu``),
on the CPU.

The kernels themselves build and run only on the card (``chip_smoke.py``
phase 13 holds them against their twins there). What the CPU can check is
the Python that decides, before every launch, which route a call takes and
how the launch is tiled: every ResNet-50 stage-2/3/4 shape of the lane at
batch 128 takes the Hopper route in bf16 and never in float32; every shape
of the card's sweep takes the route the plan says; each tile plan fits the
shared memory of a block; the dW row splits cover the rows exactly once in
a fixed order; and the wrappers still refuse CPU tensors. Shapes at the
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
    routes = _lane_forms(stage, F32)
    assert routes == {case: "simt" for case in routes}


@pytest.mark.parametrize("mkn", chip_smoke.CONV_MM_SWEEP)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_sweep_shapes_take_the_planned_mm_route(mkn, dt):
    """The card's sweep shapes: K and N are multiples of 8, so bf16 takes
    the Hopper route in every form and float32 the SIMT one."""
    m, k, n = mkn
    x, w = _act(m, k, dt), _w1x1(k, n, dt)
    want = "sm90" if dt == BF16 else "simt"
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
    assert got == ("sm90" if dt == BF16 else "simt")


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
       in chip_smoke.RESNET_STAGES.values()]


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
               "mxt_conv_fused_sm90_dual_wgrad"):
        assert fn in common._SIGNATURES
        assert fn in SRC.with_name("bindings.cpp").read_text()
