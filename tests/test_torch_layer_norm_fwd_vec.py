"""The vector layer-norm forward of ``ops/cuda/csrc/layer_norm.cu``
(``ln_fwd_vec_kernel``) without a kernel, on the CPU: its grid and vector
plan against the source's constants, a plain-PyTorch emulation of its
order of operations against the JAX package's Pallas ``_run_fwd`` in
interpret mode, and the wrapper's route argument.

The emulation follows the kernel lane by lane: lane l holds the 16-byte
chunks at columns kE (l + 32 j) .. kE (l + 32 j) + kE - 1 (kE 4 float32 or
8 bf16 values), sums them in that order in float32, the warp sums the
lanes by the xor butterfly of ``rows::warp_sum``, then the squared
deviations from the registers the same way, rstd = rsqrt(var + eps), and
y = v rstd gamma + beta. Tolerances: float32 1e-5, bf16 2e-2 scaled by the
magnitude where it exceeds 1 (one bf16 ulp at |y| in [2, 4) is 0.0156);
mu and rstd are float32 in both types and held to 1e-5.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as tln

jln = importlib.import_module("incubator_mxnet_tpu.ops.pallas.layer_norm")
jcommon = importlib.import_module("incubator_mxnet_tpu.ops.pallas.common")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WIDTHS = (64, 66, 100, 768, 1024)
# the kernel's chunks a lane: the smallest instantiated count covering the
# row (fwd_vec)
CHUNKS = {4: (1, 2, 3, 4, 6, 8), 2: (1, 2, 3, 4)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layer_norm_cu():
    """layer_norm.cu's source and its constants."""
    csrc = Path(tln.__file__).resolve().parent / "csrc"
    src = (csrc / "layer_norm.cu").read_text()
    rows = (csrc / "rows.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k(?:Fwd|Bwd)\w+) = (\d+);", src)}
    consts["kWarpRowMaxD"] = int(re.search(
        r"constexpr int kWarpRowMaxD = (\d+);", rows).group(1))
    return src, consts


def _chunks(d, esz):
    per = 16 // esz
    return next(k for k in CHUNKS[esz] if k * 32 * per >= d)


def _warp_sum(s):
    """``rows::warp_sum`` on (rows, 32) float32 lane values: v += shfl_xor
    (v, off) for off 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = (s + s[:, lanes ^ off]).astype(np.float32)
    return s[:, 0]


def emulate_vec_kernel(x2, gamma, beta, eps=1e-5):
    """``ln_fwd_vec_kernel``'s arithmetic on x2 (n, d) float32 or bf16:
    (y in x2's type, mu (n, 1), rstd (n, 1) float32)."""
    n, d = x2.shape
    esz = x2.element_size()
    k_e = 16 // esz
    k_v = _chunks(d, esz)
    lane = np.arange(32)[:, None, None]
    j = np.arange(k_v)[None, :, None]
    e = np.arange(k_e)[None, None, :]
    cols = (k_e * (lane + 32 * j) + e).reshape(32, k_v * k_e)
    valid = cols < d
    xf = x2.float().numpy()
    xv = np.where(valid, xf[:, np.minimum(cols, d - 1)], 0).astype(
        np.float32)                                   # (n, 32, kC)
    g = np.where(valid, gamma.float().numpy()[np.minimum(cols, d - 1)], 0)
    b = np.where(valid, beta.float().numpy()[np.minimum(cols, d - 1)], 0)
    s = np.zeros((n, 32), np.float32)
    for k in range(cols.shape[1]):
        s = (s + xv[:, :, k]).astype(np.float32)
    m = (_warp_sum(s) / np.float32(d)).astype(np.float32)
    v = np.where(valid, xv - m[:, None, None], 0).astype(np.float32)
    q = np.zeros((n, 32), np.float32)
    for k in range(cols.shape[1]):
        q = (q + v[:, :, k] * v[:, :, k]).astype(np.float32)
    var = (_warp_sum(q) / np.float32(d) + np.float32(eps)).astype(
        np.float32)
    rs = (1.0 / np.sqrt(var.astype(np.float64))).astype(np.float32)
    out = ((v * rs[:, None, None]).astype(np.float32) * g).astype(
        np.float32) + b
    y = np.zeros((n, d), np.float32)
    y[:, cols[valid]] = out[:, valid].astype(np.float32)
    return (torch.from_numpy(y).to(x2.dtype),
            torch.from_numpy(m[:, None]), torch.from_numpy(rs[:, None]))


def _jax_run_fwd(x, g, b, dt):
    n, d = x.shape
    block = jcommon.pick_row_block(n, d, 256)
    assert block
    with jax.default_matmul_precision("highest"):
        y, mu, rstd = jln._run_fwd(jnp.asarray(x, JDT[dt]),
                                   jnp.asarray(g, jnp.float32),
                                   jnp.asarray(b, jnp.float32), 1e-5, block)
    return (np.asarray(jnp.asarray(y, jnp.float32)), np.asarray(mu),
            np.asarray(rstd))


def _close(got, want, atol, scaled=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    lim = atol * np.maximum(1.0, np.abs(want)) if scaled else atol
    assert np.all(np.abs(got - want) <= lim), np.max(np.abs(got - want))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_emulation_matches_pallas_run_fwd(d, dt):
    """The vector kernel's order of operations against the Pallas
    ``_run_fwd`` in interpret mode and against the plain twin, at d 64, 66
    and 100 (rows not a multiple of 16 bytes: scalar accesses, the tail
    masked), 768 and 1024, with rows offset by 3 so the mean is not 0."""
    n = 16
    x = _rand((n, d), 1) * 2.0 + 3.0
    g, b = _rand((d,), 2), _rand((d,), 3)
    tx = torch.from_numpy(x).to(TDT[dt])
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    y, mu, rstd = emulate_vec_kernel(tx, tg, tb)
    jy, jmu, jrstd = _jax_run_fwd(tx.float().numpy(), g, b, dt)
    assert y.dtype == TDT[dt] and tuple(y.shape) == (n, d)
    _close(y.float().numpy(), jy, TOL[dt], dt == "bfloat16")
    _close(mu.numpy(), jmu, 1e-5)
    _close(rstd.numpy(), jrstd, 1e-5)
    ry, rmu, rrstd = tln.layer_norm_reference(tx, tg, tb)
    _close(y.float().numpy(), ry.float().numpy(), TOL[dt], dt == "bfloat16")
    _close(mu.numpy(), rmu.numpy(), 1e-5)
    _close(rstd.numpy(), rrstd.numpy(), 1e-5)


def test_emulation_masks_the_padded_columns():
    """Columns past d hold zeros that enter neither sum: a row whose padded
    lanes would carry -mu gives the same mean and variance as the twin at
    d 66, where 62 of a bf16 row's 128 lane slots and 62 of a float32
    row's 128 are padding."""
    x = torch.from_numpy(_rand((8, 66), 5) + 10.0)
    g, b = torch.ones(66), torch.zeros(66)
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        _, mu, rstd = emulate_vec_kernel(xt, g, b)
        _, rmu, rrstd = tln.layer_norm_reference(xt, g, b)
        _close(mu.numpy(), rmu.numpy(), 1e-5)
        _close(rstd.numpy(), rrstd.numpy(), 1e-4)


def test_plan_mirrors_the_kernel_source():
    """The vector forward as layer_norm.cu lays it out: the route cut at
    rows.cuh's warp-row bound (1024), blocks of ``kFwdWarps`` (8) warps,
    16-byte chunks (4 float32 or 8 bf16 values a lane, the smallest of 1,
    2, 3, 4 (6, 8 for float32) chunks covering the row), blocks an SM
    from the values a lane holds (four up to 8, two up to 24, one above,
    as the launch bound asks), vector accesses only where x, y, gamma and
    beta start on 16 bytes and a row is a multiple of 16 bytes; the plan
    covers every row once."""
    src, c = _layer_norm_cu()
    assert c["kFwdWarps"] == tln.FWD_WARPS == 8
    assert c["kBwdVecBytes"] == tln.BWD_VEC_BYTES == 16
    assert c["kBwdTwoBlockValues"] == tln.BWD_TWO_BLOCK_VALUES == 24
    assert c["kWarpRowMaxD"] == tln.ONEPASS_MAX_D == 1024
    assert ("return kC <= 8 ? 4 : kC <= kBwdTwoBlockValues ? 2 : 1;"
            in src)
    assert ("__launch_bounds__(32 * kFwdWarps, fwd_blocks_per_sm<T, kV>())"
            in src)
    assert "ln_fwd_vec_kernel<T, kV><<<blocks, 32 * kFwdWarps, 0, st>>>" \
        in src
    assert re.search(r"const int vec = aligned\(x\) && aligned\(y\) && "
                     r"aligned\(gamma\) &&\s+aligned\(beta\) && "
                     r"\(d \* esz\) % kBwdVecBytes == 0;", src)
    for k in (1, 2, 3, 4, 6, 8):
        assert f"fwd_vec_launch<T, {k}>(a, blocks, st)" in src
    assert tln.layer_norm_fwd_route(1024) == "vec"
    assert tln.layer_norm_fwd_route(1025) == "block"
    for esz in (4, 2):
        per = 16 // esz
        for d in (1, 64, 66, 100, 255, 256, 257, 512, 640, 768, 769, 1000,
                  1024):
            values = _chunks(d, esz) * per
            want = 4 if values <= 8 else 2 if values <= 24 else 1
            assert tln.layer_norm_fwd_blocks_per_sm(d, esz) == want
    # scalar accesses at the sweep's narrow widths where a row is not a
    # multiple of 16 bytes: d 66 in both types, d 100 in bf16
    vec = {(d, esz): d * esz % 16 == 0 for d in WIDTHS for esz in (4, 2)}
    assert [k for k, v in vec.items() if not v] == [(66, 4), (66, 2),
                                                    (100, 2)]
    assert tln.layer_norm_fwd_plan(16384, 768, 2) == (63, 261)
    assert tln.layer_norm_fwd_plan(16384, 768, 4) == (63, 261)
    assert tln.layer_norm_fwd_plan(16384, 1024, 4) == (125, 132)
    assert tln.layer_norm_fwd_plan(16384, 64, 2) == (32, 512)
    for n in (1, 8, 63, 64, 1000, 16384, 196608):
        for d, esz in ((64, 2), (768, 4), (768, 2), (1024, 4), (1024, 2)):
            rows, blocks = tln.layer_norm_fwd_plan(n, d, esz, sms=132)
            assert (blocks - 1) * rows < n <= blocks * rows
            assert blocks <= tln.layer_norm_fwd_blocks_per_sm(d, esz) * 132
            seen = [r for bl in range(blocks) for w in range(tln.FWD_WARPS)
                    for r in range(bl * rows + w, min(n, (bl + 1) * rows),
                                   tln.FWD_WARPS)]
            assert sorted(seen) == list(range(n))


def test_route_argument_and_cpu_refusal():
    """``_route`` takes only None and "warp"; a CPU tensor is refused on
    both routes, with nothing counted."""
    common.reset_launch_counts()
    x = torch.zeros((8, 64))
    v = torch.ones(64)
    for route in (None, "warp"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tln.layer_norm_fwd(x, v, v, _route=route)
    for bad in ("vec", "block", "twopass", ""):
        with pytest.raises(ValueError, match="_route"):
            tln.layer_norm_fwd(x, v, v, _route=bad)
    assert common.launch_counts()["layer_norm_fwd"] == 0
    assert common.sm90_launch_counts()["layer_norm_fwd"] == 0
