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
14 and 28 with one and several images, and the dual dgrad."""
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
    parts = [r.act(M, K) for _ in range(spec["partners"])]
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
