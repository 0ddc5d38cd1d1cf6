"""The port's fused conv + BN + ReLU twins (``ops/cuda/conv_fused.py``)
against the JAX package's Pallas kernels, on the CPU.

The JAX functions run their Pallas kernels in interpret mode with
``MXTPU_FUSED_IMPL=pallas`` and ``MXTPU_FUSED_CONV3=pallas``, as
``tests/test_fused_resnet.py`` runs them; the port runs the plain twins of
its CUDA kernels, which is what a CPU tensor takes. Inputs are made with
numpy from a seed and handed to both; the JAX side runs under
``jax.default_matmul_precision("highest")``. Each output is compared as
max |port - jax| / max(1, max |jax|): 1e-4 in float32 (sums over up to
1024 products in another order), 2e-2 in bfloat16 (a one-ulp flip of a
rounded output is 2^-8 of its magnitude). The option matrix is the one the
card's smoke check sweeps: every load form, stats, the x^ output, bias, G
direct or from the BN affine, each mask, 0-2 partners, dsc, 3x3 maps of 7,
14 and 28 with one and several images, and the dual dgrad. Last, the
Hopper 3x3 kernel's tap decomposition, emulated in plain PyTorch, is held
to the twin and to the JAX function."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as tcf

jcf = importlib.import_module("incubator_mxnet_tpu.ops.pallas.conv_fused")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_IMPL", "pallas")
    monkeypatch.setenv("MXTPU_FUSED_CONV3", "pallas")


class _Inputs:
    """numpy arrays from a seed, handed to both packages in one type."""

    def __init__(self, seed, dt):
        self.rs = np.random.RandomState(seed)
        self.dt = dt

    def act(self, *shape):
        a = self.rs.randn(*shape).astype(np.float32)
        return (torch.from_numpy(a).to(TDT[self.dt]),
                jnp.asarray(a, JDT[self.dt]))

    def vec(self, n, positive=False):
        a = self.rs.randn(n).astype(np.float32)
        if positive:
            a = np.abs(a) + 0.5
        return torch.from_numpy(a), jnp.asarray(a)


def _check(port_outs, jax_outs, dt):
    assert len(port_outs) == len(jax_outs)
    for p, j in zip(port_outs, jax_outs):
        want = np.asarray(jnp.asarray(j, jnp.float32))
        got = p.detach().float().numpy()
        assert got.shape == want.shape
        err = np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))
        assert err <= TOL[dt], err


MM_FORMS = ["plain", "bnrelu", "entry"]
MM_OPTS = ["bias", "emit_xhat", "no_stats"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", MM_FORMS)
@pytest.mark.parametrize("opt", MM_OPTS)
def test_mm_fused_twin_matches_pallas(dt, form, opt):
    M, K, N = 64, 16, 24
    r = _Inputs(10, dt)
    x, jx = r.act(M, K)
    w, jw = r.act(K, N)
    kw, jkw = {}, {}
    if form != "plain":
        (a, ja), (b, jb) = r.vec(K, True), r.vec(K)
        kw.update(a=a, b=b)
        jkw.update(a=ja, b=jb)
    if form == "entry":
        sc, jsc = r.act(M, K)
        (asc, jasc), (bsc, jbsc) = r.vec(K), r.vec(K)
        kw.update(sc=sc, asc=asc, bsc=bsc)
        jkw.update(sc=jsc, asc=jasc, bsc=jbsc)
    if opt == "bias":
        bias, jbias = r.vec(N)
        kw["bias"], jkw["bias"] = bias, jbias
    elif opt == "emit_xhat":
        kw["emit_xhat"] = jkw["emit_xhat"] = True
    else:
        kw["stats"] = jkw["stats"] = False
    out = tcf.mm_fused_reference(x, w, **kw)
    with jax.default_matmul_precision("highest"):
        jout = jcf.mm_fused(jx, jw, block_m=16, **jkw)
    _check(out, jout, dt)


MMB_CASES = {
    "direct_bnrelu_mask_z_1_partner": dict(g=True, ab=True, mask="z",
                                           partners=1),
    "bn_dsc_mask_x_2_partners": dict(g=False, dsc=True, mask="x",
                                     partners=2),
    "bn_plain_no_mask": dict(g=False, mask="none", partners=0),
    "direct_bnrelu_no_mask": dict(g=True, ab=True, mask="none", partners=0),
    # the lane's expand form (every block's conv3 backward): G on load,
    # x^ = relu(a x + b), masked on z, x its own partner
    "bn_bnrelu_mask_z_partner_x": dict(g=False, ab=True, mask="z",
                                       partners=1, partner_x=True),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MMB_CASES))
def test_mm_fused_bwd_twin_matches_pallas(dt, case):
    spec = MMB_CASES[case]
    M, K, N = 64, 16, 24
    r = _Inputs(11, dt)
    x, jx = r.act(M, K)
    w, jw = r.act(K, N)
    kw = {"out_mask": spec["mask"]}
    jkw = {"out_mask": spec["mask"]}
    if spec["g"]:
        g, jg = r.act(M, N)
        kw["g"], jkw["g"] = g, jg
    else:
        dzn, jdzn = r.act(M, N)
        yout, jyout = r.act(M, N)
        gc = r.rs.randn(3, N).astype(np.float32)
        kw.update(dzn=dzn, yout=yout, gcoef=torch.from_numpy(gc))
        jkw.update(dzn=jdzn, yout=jyout, gcoef=jnp.asarray(gc))
    if spec.get("ab"):
        (a, ja), (b, jb) = r.vec(K, True), r.vec(K)
        kw.update(a=a, b=b)
        jkw.update(a=ja, b=jb)
    if spec.get("dsc"):
        dsc, jdsc = r.act(M, K)
        kw["dsc"], jkw["dsc"] = dsc, jdsc
    parts = ([(x, jx)] if spec.get("partner_x")
             else [r.act(M, K) for _ in range(spec["partners"])])
    kw["partners"] = tuple(p for p, _ in parts)
    jkw["partners"] = tuple(j for _, j in parts)
    out = tcf.mm_fused_bwd_reference(w, x, **kw)
    with jax.default_matmul_precision("highest"):
        jout = jcf.mm_fused_bwd(jw, jx, block_m=16, **jkw)
    _check(out, jout, dt)


# (B, H = W, images per Pallas grid step): a step's rows must be a multiple
# of 8 for the reference to take its kernel rather than its XLA twin
C3_SHAPES = [(8, 7, 8), (2, 14, 2), (1, 28, 1), (2, 28, 1)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", C3_SHAPES)
def test_conv3_fused_twin_matches_pallas(dt, bh):
    B, H, nb = bh
    C, N = 8, 16
    r = _Inputs(12 + H, dt)
    x2, jx2 = r.act(B * H * H, C)
    w9, jw9 = r.act(9, C, N)
    (a, ja), (b, jb) = r.vec(C, True), r.vec(C)
    with jax.default_matmul_precision("highest"):
        jout = jcf.conv3_fused(jx2, jw9, ja, jb, (B, H, H), True,
                               block_b=nb)
    _check(tcf.conv3_fused_reference(x2, w9, a, b, (B, H, H), True), jout,
           dt)
    # stats=False: the reference's Pallas path raises here (its kernel
    # always takes a stats output; ROADMAP.md C), its XLA twin returns
    # (y,); the port returns (y,), the Pallas y
    _check(tcf.conv3_fused_reference(x2, w9, a, b, (B, H, H), False),
           jout[:1], dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", C3_SHAPES)
def test_conv3_fused_bwd_twin_matches_pallas(dt, bh):
    B, H, nb = bh
    C, N = 8, 16
    r = _Inputs(13 + H, dt)
    M = B * H * H
    x2, jx2 = r.act(M, C)
    w9, jw9 = r.act(9, C, N)
    (a, ja), (b, jb) = r.vec(C, True), r.vec(C)
    dzn, jdzn = r.act(M, N)
    yout, jyout = r.act(M, N)
    gc = r.rs.randn(3, N).astype(np.float32)
    out = tcf.conv3_fused_bwd_reference(w9, x2, a, b, dzn, yout,
                                        torch.from_numpy(gc), (B, H, H))
    with jax.default_matmul_precision("highest"):
        jout = jcf.conv3_fused_bwd(jw9, jx2, ja, jb, jdzn, jyout,
                                   jnp.asarray(gc), (B, H, H), block_b=nb)
    _check(out, jout, dt)


def _dual_inputs(seed, dt, M, K, NA, NB):
    r = _Inputs(seed, dt)
    port, jx = [], []
    for shape in [(K, NA), (K, NB), (M, K)]:
        t, j = r.act(*shape)
        port.append(t)
        jx.append(j)
    for n in (NA, NB):
        for shape in [(M, n), (M, n)]:
            t, j = r.act(*shape)
            port.append(t)
            jx.append(j)
        gc = r.rs.randn(3, n).astype(np.float32)
        port.append(torch.from_numpy(gc))
        jx.append(jnp.asarray(gc))
    # (w_a, w_b, x, dzn_a, yout_a, gc_a, dzn_b, yout_b, gc_b)
    return port, jx


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mk", [(64, 16, 8, 24), (96, 24, 16, 64)])
def test_dgrad_epilogue_twin_matches_pallas(dt, mk):
    M, K, NA, NB = mk
    port, jx = _dual_inputs(15 + K, dt, M, K, NA, NB)
    out = tcf.dgrad_epilogue_reference(*port)
    with jax.default_matmul_precision("highest"):
        jout = jcf.dgrad_epilogue(*jx, block_m=16)
    _check(out, jout, dt)


def test_dgrad_epilogue_equals_two_dgrads_and_an_add():
    """In float32 the dual dgrad is the two ``mm_fused_bwd`` dgrads of the
    junction's consumers plus their sum, and its dW are theirs."""
    port, _ = _dual_inputs(16, "float32", 64, 16, 8, 24)
    wa, wb, x, dzn_a, ya, gca, dzn_b, yb, gcb = port
    dx, dwa, dwb = tcf.dgrad_epilogue_reference(*port)
    dxa, dwa2, _ = tcf.mm_fused_bwd_reference(wa, x, dzn=dzn_a, yout=ya,
                                              gcoef=gca)
    dxb, dwb2, _ = tcf.mm_fused_bwd_reference(wb, x, dzn=dzn_b, yout=yb,
                                              gcoef=gcb)
    torch.testing.assert_close(dx, dxa + dxb, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dwa, dwa2, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dwb, dwb2, rtol=1e-6, atol=1e-5)


def test_reference_conv3_without_stats_fault():
    """The reference's Pallas ``conv3_fused(..., stats=False)`` fails (its
    kernel is written for a stats output the call does not make); the
    port's twin and kernel return (y,), as the reference's XLA twin does."""
    r = _Inputs(20, "float32")
    x2, jx2 = r.act(8 * 7 * 7, 8)
    w9, jw9 = r.act(9, 8, 16)
    (a, ja), (b, jb) = r.vec(8, True), r.vec(8)
    with pytest.raises(TypeError):
        jcf.conv3_fused(jx2, jw9, ja, jb, (8, 7, 7), False, block_b=8)
    out = tcf.conv3_fused_reference(x2, w9, a, b, (8, 7, 7), False)
    assert len(out) == 1
    with jax.default_matmul_precision("highest"):
        _check(out, jcf._conv3_fused_xla(jx2, jw9, ja, jb, (8, 7, 7), False),
               "float32")


def test_twins_take_gluon_weight_views():
    """The 1x1 and 3x3 weights reach the twins as views of the gluon
    layouts (O, 1, 1, I) and (O, 3, 3, I), as the fused stage passes
    them: the same values as contiguous copies."""
    rs = np.random.RandomState(14)
    wg = torch.from_numpy(rs.randn(24, 1, 1, 16).astype(np.float32))
    x = torch.from_numpy(rs.randn(32, 16).astype(np.float32))
    w = wg.reshape(24, 16).t()
    assert not w.is_contiguous()
    for got, want in zip(tcf.mm_fused_reference(x, w),
                         tcf.mm_fused_reference(x, w.contiguous())):
        torch.testing.assert_close(got, want)
    w3 = torch.from_numpy(rs.randn(16, 3, 3, 8).astype(np.float32))
    w9 = w3.permute(1, 2, 3, 0).reshape(9, 8, 16)
    assert w9.data_ptr() == w3.data_ptr()       # a view, no copy
    x2 = torch.from_numpy(rs.randn(2 * 7 * 7, 8).astype(np.float32))
    a, b = torch.ones(8), torch.zeros(8)
    for got, want in zip(
            tcf.conv3_fused_reference(x2, w9, a, b, (2, 7, 7)),
            tcf.conv3_fused_reference(x2, w9.contiguous(), a, b,
                                      (2, 7, 7))):
        torch.testing.assert_close(got, want)


def test_zero_padding_belongs_to_xhat():
    """Out-of-range taps contribute 0 after the load transform: with a = 0
    and b = 1, x^ is 1 inside the map and 0 in the halo, so a 3x3 all-ones
    weight counts the in-range taps of each output pixel."""
    H = 5
    x2 = torch.randn(H * H, 1)
    w9 = torch.ones(9, 1, 1)
    y, _ = tcf.conv3_fused_reference(x2, w9, torch.zeros(1), torch.ones(1),
                                     (1, H, H))
    counts = torch.full((H, H), 9.0)
    counts[0, :] -= 3
    counts[-1, :] -= 3
    counts[:, 0] -= 3
    counts[:, -1] -= 3
    counts[0, 0] = counts[0, -1] = counts[-1, 0] = counts[-1, -1] = 4.0
    torch.testing.assert_close(y.reshape(H, H), counts)


@pytest.mark.parametrize("kernel", ["mm_fused", "mm_fused_bwd",
                                    "conv3_fused", "conv3_fused_bwd",
                                    "dgrad_epilogue"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    x = torch.randn(98, 8)
    w = torch.randn(8, 16)
    w9 = torch.randn(9, 8, 16)
    a, b = torch.ones(8), torch.zeros(8)
    g = torch.randn(98, 16)
    gc = torch.randn(3, 16)
    calls = {
        "mm_fused": lambda: tcf.mm_fused(x, w),
        "mm_fused_bwd": lambda: tcf.mm_fused_bwd(w, x, g=g),
        "conv3_fused": lambda: tcf.conv3_fused(x, w9, a, b, (2, 7, 7)),
        "conv3_fused_bwd": lambda: tcf.conv3_fused_bwd(w9, x, a, b, g, g, gc,
                                                       (2, 7, 7)),
        "dgrad_epilogue": lambda: tcf.dgrad_epilogue(w, w, x, g, g, gc, g,
                                                     g, gc),
    }
    before = getattr(tcf, kernel).launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[kernel]()
    assert getattr(tcf, kernel).launches == before


# ------------------------------- the 3x3 kernel's decomposition, emulated
def conv3_by_taps(x2, w9, a, b, bhw):
    """conv3_fused as ``cf90_conv3_kernel`` computes it: per 128-row tile,
    for each tap (r, s) and 64-channel slice, the tile's rows shifted by
    (r - 1) W + (s - 1) flat rows (rows outside [0, M) read 0), x^ =
    relu(a x + b) in float32 rounded to the input type, then zero where the
    tapped pixel lies outside its row's image and for channels >= C; B is
    the (9 C, N) weight's rows tap C + c0 .. + 63 (a slice past C reads the
    next tap's rows; past 9 C, 0). float32 sums, y rounded once, the stats
    over the rounded y."""
    B, H, W = bhw
    M, C = x2.shape
    N = w9.shape[2]
    w2 = torch.cat([w9.reshape(9 * C, N).float(), torch.zeros(64, N)])
    af, bf = a.float(), b.float()
    y = torch.empty((M, N), dtype=x2.dtype)
    for m0 in range(0, M, 128):
        m = torch.arange(m0, m0 + 128)
        hh, ww = (m // W) % H, m % W
        acc = torch.zeros((128, N))
        for tap in range(9):
            dr, ds = tap // 3 - 1, tap % 3 - 1
            src = m + dr * W + ds
            inside = ((hh + dr >= 0) & (hh + dr < H) & (ww + ds >= 0)
                      & (ww + ds < W))
            for c0 in range(0, C, 64):
                cols = torch.arange(c0, c0 + 64)
                raw = torch.zeros((128, 64))
                ok = (src >= 0) & (src < M)
                cv = cols < C
                raw[ok.nonzero()[:, 0][:, None], cv.nonzero()[:, 0]] = \
                    x2[src[ok]][:, cols[cv]].float()
                ca = torch.zeros(64)
                cb = torch.zeros(64)
                ca[cv], cb[cv] = af[cols[cv]], bf[cols[cv]]
                xh = torch.clamp(raw * ca + cb, min=0.0).to(x2.dtype).float()
                xh = xh * inside[:, None] * cv[None, :]
                acc += xh @ w2[tap * C + c0:tap * C + c0 + 64]
        rows = min(128, M - m0)
        y[m0:m0 + rows] = acc[:rows].to(x2.dtype)
    yf = y.float()
    return y, torch.stack([yf.sum(0), (yf * yf).sum(0)])


# (B, H = W, C, N): H W never a multiple of 128, so tiles straddle image
# rows and images; C 72 and 40 leave a channel tail inside a 64-slice
_TAP_SHAPES = [(2, 9, 72, 16), (3, 7, 40, 24), (1, 14, 24, 8),
               (2, 5, 8, 16)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _TAP_SHAPES)
def test_conv3_tap_decomposition_matches_the_twin_and_jax(dt, shape):
    """The Hopper 3x3 kernel's nine shifted flat-row products with the
    border and channel masks after the transform equal the port's twin and
    the JAX ``_conv3_fused_xla``: 1e-4 in float32 (another summation
    order), 2e-2 in bf16 (a one-ulp flip of a rounded y), each over
    max(1, the reference's largest entry)."""
    B, H, C, N = shape
    rs = np.random.RandomState(30 + C)
    M = B * H * H
    tdt, jdt = TDT[dt], JDT[dt]
    x_np = rs.randn(M, C).astype(np.float32)
    w_np = rs.randn(N, 3, 3, C).astype(np.float32)   # gluon (O, 3, 3, I)
    a_np = np.abs(rs.randn(C)).astype(np.float32) + 0.5
    b_np = rs.randn(C).astype(np.float32)
    x2 = torch.from_numpy(x_np).to(tdt)
    w9 = torch.from_numpy(w_np).to(tdt).permute(1, 2, 3, 0).reshape(9, C, N)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    got = conv3_by_taps(x2, w9, a, b, (B, H, H))
    twin = tcf.conv3_fused_reference(x2, w9, a, b, (B, H, H))
    w9_np = np.ascontiguousarray(w9.float().numpy())
    with jax.default_matmul_precision("highest"):
        ref = jcf._conv3_fused_xla(
            jnp.asarray(x_np, jdt), jnp.asarray(w9_np, jdt),
            jnp.asarray(a_np), jnp.asarray(b_np), (B, H, H), True)
    tol = TOL[dt]
    for want in (twin, tuple(torch.from_numpy(np.array(
            jnp.asarray(r, jnp.float32))) for r in ref)):
        for g, r in zip(got, want):
            r = r.float()
            err = (g.float() - r).abs().max() / max(1.0, r.abs().max())
            assert err <= tol, err


# --------------------- the 3x3 backward kernels' decomposition, emulated
def conv3_bwd_by_taps(w9, x2, a, b, dzn, yout, gcoef, bhw):
    """conv3_fused_bwd as ``cf90_conv3_dgrad_kernel`` and
    ``cf90_conv3_wgrad_kernel`` compute it. Dgrad: for each tap (r, s), G's
    rows m + (1 - r) W + (1 - s) (rows outside [0, M) read 0) transformed
    on load, G = (dzn g0 - g1) - yout g2 rounded to the input type, then
    zeroed where the tapped pixel (h + 1 - r, w + 1 - s) lies outside its
    row's image, times W[r, s]^T, summed in float32; dz masked on
    a x + b > 0 and rounded once; the partials over the rounded dz. Wgrad:
    the unshifted G (the dgrad's centre tap writes it) with its rows zeroed
    where the forward's tapped pixel (h + r - 1, w + s - 1) leaves the
    image, against x^ = relu(a x + b) at rows m + (r - 1) W + (s - 1)."""
    B, H, W = bhw
    M, C = x2.shape
    N = w9.shape[2]
    gc = gcoef.float()
    m = torch.arange(M)
    hh, ww = (m // W) % H, m % W

    def rows(t, src):
        ok = (src >= 0) & (src < M)
        out = torch.zeros((M, t.shape[1]))
        out[ok] = t[src[ok]].float()
        return out

    def inside(dr, ds):
        return ((hh + dr >= 0) & (hh + dr < H) & (ww + ds >= 0)
                & (ww + ds < W))[:, None]

    z = x2.float() * a.float() + b.float()
    xh = torch.clamp(z, min=0.0).to(x2.dtype)
    g = None
    dxh = torch.zeros((M, C))
    dw = torch.zeros((9, C, N))
    for tap in range(9):
        r, s = tap // 3, tap % 3
        src = m + (1 - r) * W + (1 - s)
        gs = ((rows(dzn, src) * gc[0] - gc[1]) - rows(yout, src) * gc[2]
              ).to(dzn.dtype).float() * inside(1 - r, 1 - s)
        if tap == 4:
            g = gs
        dxh += gs @ w9[tap].float().t()
    for tap in range(9):
        r, s = tap // 3, tap % 3
        xs = rows(xh, m + (r - 1) * W + (s - 1))
        dw[tap] = xs.t() @ (g * inside(r - 1, s - 1))
    dz = torch.where(z > 0.0, dxh, torch.zeros(())).to(x2.dtype)
    dzf = dz.float()
    return dz, dw, torch.stack([dzf.sum(0), (dzf * x2.float()).sum(0)])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _TAP_SHAPES)
def test_conv3_bwd_tap_decomposition_matches_the_twin_and_jax(dt, shape):
    """The Hopper 3x3 backward's mirrored shifted products (halo masked
    after G's transform) and its shifted wgrad (halo masked on G's rows)
    equal the port's twin and the JAX ``_conv3_fused_bwd_xla``: 1e-4 in
    float32, 2e-2 in bf16, each over max(1, the reference's largest
    entry)."""
    B, H, C, N = shape
    rs = np.random.RandomState(40 + C)
    M = B * H * H
    tdt, jdt = TDT[dt], JDT[dt]
    x_np = rs.randn(M, C).astype(np.float32)
    w_np = rs.randn(N, 3, 3, C).astype(np.float32)   # gluon (O, 3, 3, I)
    a_np = np.abs(rs.randn(C)).astype(np.float32) + 0.5
    b_np = rs.randn(C).astype(np.float32)
    dzn_np = rs.randn(M, N).astype(np.float32)
    yout_np = rs.randn(M, N).astype(np.float32)
    gc_np = rs.randn(3, N).astype(np.float32)
    x2 = torch.from_numpy(x_np).to(tdt)
    w9 = torch.from_numpy(w_np).to(tdt).permute(1, 2, 3, 0).reshape(9, C, N)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    dzn = torch.from_numpy(dzn_np).to(tdt)
    yout = torch.from_numpy(yout_np).to(tdt)
    gc = torch.from_numpy(gc_np)
    got = conv3_bwd_by_taps(w9, x2, a, b, dzn, yout, gc, (B, H, H))
    twin = tcf.conv3_fused_bwd_reference(w9, x2, a, b, dzn, yout, gc,
                                         (B, H, H))
    w9_np = np.ascontiguousarray(w9.float().numpy())
    with jax.default_matmul_precision("highest"):
        ref = jcf._conv3_fused_bwd_xla(
            jnp.asarray(w9_np, jdt), jnp.asarray(x_np, jdt),
            jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(dzn_np, jdt),
            jnp.asarray(yout_np, jdt), jnp.asarray(gc_np), (B, H, H))
    tol = TOL[dt]
    for want in (twin, tuple(torch.from_numpy(np.array(
            jnp.asarray(r, jnp.float32))) for r in ref)):
        for g, r in zip(got, want):
            r = r.float()
            err = (g.float() - r).abs().max() / max(1.0, r.abs().max())
            assert err <= tol, err
