"""The port's fused LSTM (``ops/cuda/lstm.py``) against the JAX package's
Pallas LSTM (``ops/pallas/lstm.py``), on the CPU.

The port runs the plain twins of its CUDA kernels (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, with
``MXTPU_PALLAS=lstm_cell,lstm_scan`` for the scan-level VJP, under
``jax.default_matmul_precision("highest")``. Inputs come from numpy with a
seed. Types: float32; bfloat16 throughout (c carried in bf16); and the
word LM's two mixes under bf16 compute, both with float32 carries and a
bf16 W_hh: layer 1's bf16 x_proj, and layer 2's float32 x_proj (float32 x
times a bf16 W_ih) beside a bf16 b_hh.
Tolerances, each output as max |port - jax| over max(1, max |jax|): 1e-5
in float32, 2e-2 when bf16 is involved (a one-ulp flip of a rounded value
is 2^-8 of its magnitude, and a flipped carry feeds the next steps).
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops.cuda import lstm as tl

jl = importlib.import_module("incubator_mxnet_tpu.ops.pallas.lstm")

# (x_proj type, W_hh and b_hh type, carry type)
TYPES = {"f32": ("float32", "float32", "float32"),
         "bf16": ("bfloat16", "bfloat16", "bfloat16"),
         "bf16_f32carry": ("bfloat16", "bfloat16", "float32"),
         "f32_bf16w": ("float32", "bfloat16", "float32")}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(types):
    return 1e-5 if types == "f32" else 2e-2


@pytest.fixture(autouse=True)
def _pallas_lstm(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "lstm_cell,lstm_scan")


class _In:
    """numpy arrays from a seed, handed to both packages in one type."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)

    def __call__(self, dt, *shape, scale=1.0):
        a = (self.rs.randn(*shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(TDT[dt]), jnp.asarray(a, JDT[dt])


def _err(t, j):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape, (t.shape, j.shape)
    return np.max(np.abs(t - j)) / max(1.0, np.max(np.abs(j)))


def _step_inputs(seed, types, N, H):
    od, wd, sd = TYPES[types]
    rnd = _In(seed)
    xp = rnd(od, N, 4 * H)
    h, c = rnd(sd, N, H, scale=0.5), rnd(sd, N, H)
    w = rnd(wd, 4 * H, H, scale=H ** -0.5)
    b = rnd(wd, 4 * H, scale=0.1)
    return xp, h, c, w, b


def _jax_layout(N, H, xp, w, b):
    """The packed operands in the reference kernel's (4, N, H), (4, H, H)
    and (4, 1, H) layouts."""
    return (jnp.transpose(xp.reshape(N, 4, H), (1, 0, 2)),
            jnp.transpose(w.reshape(4, H, H), (0, 2, 1)), b.reshape(4, 1, H))


def _gates4(g, N, H):
    """The port's (N, 4H) residual in the reference's (4, N, H)."""
    return g.reshape(N, 4, H).permute(1, 0, 2)


@pytest.mark.parametrize("types", list(TYPES))
@pytest.mark.parametrize("N,H", [(8, 16), (16, 24)])
@pytest.mark.parametrize("with_gates", [True, False])
def test_forward_twin_matches_run_fwd(types, N, H, with_gates):
    xp, h, c, w, b = _step_inputs(1, types, N, H)
    th1, tc1, tg = tl.lstm_fwd_reference(xp[0], h[0], c[0], w[0], b[0],
                                         with_gates)
    xp4, w4, b4 = _jax_layout(N, H, xp[1], w[1], b[1])
    with jax.default_matmul_precision("highest"):
        jh1, jc1, jg = jl._run_fwd(xp4, h[1], c[1], w4, b4, with_gates)
    tol = _tol(types)
    assert th1.dtype == h[0].dtype and tc1.dtype == c[0].dtype
    assert _err(th1, jh1) <= tol and _err(tc1, jc1) <= tol
    if with_gates:
        assert tg.dtype == torch.float32
        assert _err(_gates4(tg, N, H), jg) <= tol
    else:
        assert tg is None and jg is None


@pytest.mark.parametrize("types", list(TYPES))
@pytest.mark.parametrize("N,H", [(8, 20), (16, 24)])
def test_backward_twin_matches_run_bwd(types, N, H):
    xp, h, c, w, b = _step_inputs(2, types, N, H)
    _, c1, g = tl.lstm_fwd_reference(xp[0], h[0], c[0], w[0], b[0])
    sd = TYPES[types][2]
    rnd = _In(3)
    dh1, dc1 = rnd(sd, N, H), rnd(sd, N, H)
    tdx, tdh, tdc = tl.lstm_bwd_reference(g, c[0], c1, w[0], dh1[0],
                                          dc1[0])
    _, w4, _ = _jax_layout(N, H, xp[1], w[1], b[1])
    g4 = jnp.asarray(_gates4(g, N, H).numpy())
    jc1 = jnp.asarray(c1.float().numpy(), JDT[sd])
    with jax.default_matmul_precision("highest"):
        jdx, jdh, jdc = jl._run_bwd(g4, c[1], jc1, w4, dh1[1], dc1[1])
    tol = _tol(types)
    assert tdx.dtype == torch.float32 and tdh.dtype == dh1[0].dtype
    assert _err(_gates4(tdx, N, H), jdx) <= tol
    assert _err(tdh, jdh) <= tol and _err(tdc, jdc) <= tol


def _scan_case(seed, types, T, N, H):
    od, wd, sd = TYPES[types]
    rnd = _In(seed)
    ins = [rnd(od, T, N, 4 * H), rnd(sd, N, H, scale=0.5), rnd(sd, N, H),
           rnd(wd, 4 * H, H, scale=H ** -0.5), rnd(wd, 4 * H, scale=0.1)]
    cts = [rnd(sd, T, N, H), rnd(sd, N, H), rnd(sd, N, H)]
    return ins, cts


@pytest.mark.parametrize("types,reverse,N,H", [
    (types, reverse, N, H) for types in TYPES
    for reverse, N, H in ((False, 8, 16), (True, 16, 20))]
    + [("bf16_f32carry", False, 8, 24)])
def test_scan_forward_and_vjp_match_jax(types, reverse, N, H):
    ins, cts = _scan_case(4, types, 6, N, H)
    with jax.default_matmul_precision("highest"):
        jout, vjp = jax.vjp(lambda *a: jl.lstm_scan(*a, reverse=reverse),
                            *[j for _, j in ins])
        jgrads = vjp(tuple(j for _, j in cts))
    leaves = [t.clone().requires_grad_(True) for t, _ in ins]
    tout = tl.lstm_scan(*leaves, reverse=reverse)
    tgrads = torch.autograd.grad(tout, leaves, [t for t, _ in cts])
    tol = _tol(types)
    for t, j in zip(tout, jout):
        assert t.dtype == ins[1][0].dtype
        assert _err(t, j) <= tol
    for leaf, t, j in zip(leaves, tgrads, jgrads):
        assert t.dtype == leaf.dtype
        assert _err(t, j) <= tol
    # without a gradient the residual-free forward gives the same values
    with torch.no_grad():
        plain = tl.lstm_scan(*[t for t, _ in ins], reverse=reverse)
    for a, b in zip(plain, tout):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("types,N,H", [("f32", 8, 16), ("bf16", 16, 20),
                                       ("bf16_f32carry", 8, 24),
                                       ("f32_bf16w", 16, 20)])
def test_cell_forward_and_vjp_match_jax(types, N, H):
    od, wd, sd = TYPES[types]
    rnd = _In(5)
    ins = [rnd(od, 4, N, H), rnd(sd, N, H, scale=0.5), rnd(sd, N, H),
           rnd(wd, 4, H, H, scale=H ** -0.5), rnd(wd, 4, 1, H, scale=0.1)]
    cts = [rnd(sd, N, H), rnd(sd, N, H)]
    with jax.default_matmul_precision("highest"):
        jout, vjp = jax.vjp(jl.lstm_cell, *[j for _, j in ins])
        jgrads = vjp(tuple(j for _, j in cts))
    leaves = [t.clone().requires_grad_(True) for t, _ in ins]
    tout = tl.lstm_cell(*leaves)
    tgrads = torch.autograd.grad(tout, leaves, [t for t, _ in cts])
    tol = _tol(types)
    for t, j in zip(tout, jout):
        assert _err(t, j) <= tol
    for leaf, t, j in zip(leaves, tgrads, jgrads):
        assert t.dtype == leaf.dtype
        assert _err(t, j) <= tol
    with torch.no_grad():
        plain = tl.lstm_cell(*[t for t, _ in ins])
    for a, b in zip(plain, tout):
        assert torch.equal(a, b.detach())


def test_viability_rule_is_the_reference_rule():
    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16)]
    n_true = 0
    for n in (1, 5, 8, 12, 16, 64, 128, 200, 256, 1000):
        for h in (16, 20, 211, 650, 800, 900, 1030, 2048):
            for tdt, jdt in pairs:
                want = jl.lstm_cell_viable(n, h, jdt)
                assert tl.lstm_cell_viable(n, h, tdt) == want, (n, h, tdt)
                n_true += want
    assert 0 < n_true < 240
    # the word LM's lane takes the kernel
    assert tl.lstm_cell_viable(128, 650, torch.bfloat16)


def test_kernel_wrappers_take_cuda_tensors_only():
    xp, h, c, w, b = (t for t, _ in _step_inputs(6, "f32", 8, 16))
    for fn in (tl.lstm_fwd, tl.lstm_fwd_gates):
        with pytest.raises(ValueError, match="CUDA"):
            fn(xp, h, c, w, b)
    g = torch.zeros(8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tl.lstm_bwd(g, c, c, w, h, c)


# ------------------------------------- the tensor-core backward (bf16 W)
def test_backward_route_is_chosen_by_the_weight_type():
    """Every W_hh type takes the tensor-core kernels with either carry type:
    a bf16 W_hh as one piece, a float32 W_hh as three (the SIMT kernel only
    behind ``_route="simt"``)."""
    for types in ("bf16", "bf16_f32carry", "f32"):
        _, _, _, w, _ = _step_inputs(7, types, 8, 16)
        assert tl.lstm_bwd_route(w[0]) == "sm90"
    assert tl.lstm_bwd_route(torch.empty((2600, 650), dtype=torch.float32,
                                         device="meta")) == "sm90"
    # the word LM's lane: bf16 operands, float32 carries
    assert tl.lstm_bwd_route(torch.empty((2600, 650), dtype=torch.bfloat16,
                                         device="meta")) == "sm90"


def test_forward_route_is_chosen_by_the_weight_type():
    """Every W_hh type takes the tensor-core forward, with either carry
    type and either x_proj type: a bf16 W as one piece, a float32 W as
    three; the backward's rule is the forward's."""
    for types in TYPES:
        _, _, _, w, _ = _step_inputs(7, types, 8, 16)
        assert tl.lstm_fwd_route(w[0]) == "sm90"
        assert tl.lstm_bwd_route(w[0]) == tl.lstm_fwd_route(w[0])
    # the word LM's lane, both layers: a bf16 W_hh
    assert tl.lstm_fwd_route(torch.empty((2600, 650), dtype=torch.bfloat16,
                                         device="meta")) == "sm90"
    # the scan and the cell make W's copy only for the tensor-core route on
    # the card: a CPU W (the twins) gets none
    assert tl._tc_weight(torch.zeros(64, 16, dtype=torch.bfloat16)) is None


def test_tensor_core_plan_mirrors_the_kernel_source():
    """lstm.cu's reduction stage is the one ``lstm_tc_plan`` pads to; the
    product's launch, read from the source (32 x 64 of dh and one gate a
    block, the four gates a cluster, a three-stage ring of the three dz
    pieces' and a bf16 W's tiles), fits a block's 48 KB and fills the card
    at the lane (at least 128 blocks)."""
    from pathlib import Path
    import re
    src = (Path(tl.__file__).resolve().parent / "csrc" / "lstm.cu"
           ).read_text()
    consts = dict(re.findall(r"constexpr int (kT\w+) = ([^;]+);", src))
    tm, tn, tk, stages = (int(consts[k]) for k in ("kTM", "kTN", "kTK",
                                                    "kTStages"))
    assert tk == tl.TC_TK
    assert consts["kTLdA"] == "kTK + 8" and consts["kTLdB"] == "kTN + 8"
    assert "__cluster_dims__(1, 1, 4)" in src
    assert ("constexpr int kA = kTM * kTLdA;" in src
            and "constexpr int kB = kTK * kTLdB;" in src
            and "__nv_bfloat16* Bs = smem + kTStages * 3 * kA;" in src)
    assert ("grid((a.H + kTN - 1) / kTN, (a.N + kTM - 1) / kTM, 4)"
            in src)
    smem = stages * (3 * tm * (tk + 8) + tk * (tn + 8)) * 2
    assert smem <= 48 * 1024
    for h in (16, 20, 211, 650, 1030):
        hk, hm = tl.lstm_tc_plan(h)
        assert hk % tk == 0 and h <= hk < h + tk
        assert hm % 8 == 0 and h <= hm < h + 8
    n, h = 128, 650
    grid = (-(-h // tn), -(-n // tm), 4)
    assert grid == (11, 4, 4) and grid[0] * grid[1] * grid[2] >= 128
    assert tl.lstm_tc_plan(h) == (672, 656)


def _lstm_cu():
    """lstm.cu's source and its tensor-core forward's constants."""
    from pathlib import Path
    import re
    src = (Path(tl.__file__).resolve().parent / "csrc" / "lstm.cu"
           ).read_text()
    return src, {k: int(v) for k, v in
                 re.findall(r"constexpr int (kFT\w+) = (\d+);", src)}


def test_tensor_core_forward_plan_mirrors_the_kernel_source():
    """The tensor-core forward as lstm.cu lays it out: a 32 x 16 tile with
    all four gates (four warps, 16 rows x 2 gates each), a cluster of two
    blocks splitting the stages of m, a three-stage ring of h's three pieces
    and W's 64-row tile in static shared memory (within 48 KB, the float32
    partial aliased on it), the epilogue's (n, j) dealt to the threads; a
    float32 W's three pieces in the ring too (67.5 KB of dynamic shared
    memory, three blocks an SM). At the lane (N 128, H 650) it runs 328
    blocks, one wave on the H100's 132 SMs at five blocks an SM (three
    with a float32 W), every block a chain of 10 or 11 of the 21 stages;
    W's copy holds every row a column tile reads."""
    src, consts = _lstm_cu()
    tm, tj, tk, split, stages, threads = (consts[k] for k in (
        "kFTM", "kFTJ", "kFTK", "kFTSplit", "kFTStages", "kFTThreads"))
    assert tk == tl.TC_TK and threads == 128 and stages == 3
    assert "constexpr int kFTLd = kFTK + 8;" in src
    assert "__cluster_dims__(1, 1, kFTSplit)" in src
    assert ("grid((a.H + kFTJ - 1) / kFTJ, (a.N + kFTM - 1) / kFTM, "
            "kFTSplit)" in src)
    assert ("return kFTStages * (P * kFTM + PW * 4 * kFTJ) * kFTLd * 2;"
            in src)
    assert "extern __shared__ __align__(16) __nv_bfloat16 smem[];" in src
    assert tm % split == 0
    ld = tk + 8
    for pieces in (3, 1):             # h's pieces, a bf16 W: static limit
        smem = stages * (pieces * tm * ld + 4 * tj * ld) * 2
        assert tm * 4 * tj * 4 <= smem <= 48 * 1024
    # a float32 W's three pieces: 67.5 KB a block, three blocks an SM
    smem = stages * (3 * tm * ld + 3 * 4 * tj * ld) * 2
    assert smem == 69120 and 227 * 1024 // smem == 3
    n, h = 128, 650
    hk, hm = tl.lstm_tc_plan(h)
    grid = (-(-h // tj), -(-n // tm), split)
    assert grid == (41, 4, 2)
    blocks = grid[0] * grid[1] * grid[2]
    assert 2 * 132 < blocks <= 3 * 132
    nk = -(-hm // tk)
    chains = [(r + 1) * nk // split - r * nk // split for r in range(split)]
    assert nk == 21 and sum(chains) == nk and chains == [10, 11]
    for h in (16, 20, 211, 650, 1030):
        hk, hm = tl.lstm_tc_plan(h)
        assert -(-h // tj) * tj <= hk             # every tile's W rows


@pytest.mark.parametrize("H", [16, 20, 211])
def test_weight_copy_is_w_padded_with_zeros(H):
    w = torch.randn(4 * H, H).to(torch.bfloat16)
    wp = tl.lstm_tc_weight(w)
    assert wp.shape == (4, *tl.lstm_tc_plan(H)) and wp.dtype == w.dtype
    assert torch.equal(wp[:, :H, :H], w.reshape(4, H, H))
    assert not wp[:, H:].any() and not wp[:, :, H:].any()


def _split3(dz):
    """dz (float32) as three bf16 pieces, as lstm_bwd_dz_kernel splits it."""
    hi = dz.to(torch.bfloat16)
    r1 = dz - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_three_bf16_pieces_hold_a_float32_exactly():
    rs = np.random.RandomState(11)
    dz = torch.from_numpy(np.concatenate([
        rs.randn(4096).astype(np.float32),
        (rs.randn(4096) * 1e-30).astype(np.float32),
        (rs.randn(4096) * 1e30).astype(np.float32),
        rs.rand(4096).astype(np.float32)]))
    hi, mid, lo = _split3(dz)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), dz)


def _split2(dz):
    """dz as two bf16 pieces, hi + mid: the split that drops lo."""
    return _split3(dz)[:2]


# dh of the split product against the reference's float32 product, over
# dh's largest entry: at this test's shapes three pieces read 0.85e-7 and
# 3.2e-7 (float32's own rounding), two pieces 2.0e-6 and 2.7e-6
SPLIT_PRODUCT_TOL = 1e-6


@pytest.mark.parametrize("N,H", [(8, 20), (16, 211)])
def test_split_product_matches_run_bwd_in_float32(N, H):
    """The tensor-core route's arithmetic in plain PyTorch (dz from the
    twin, split in three bf16 pieces, each gate's pieces times W's padded
    copy, the four gates' float32 partials summed in order) against the
    Pallas ``_run_bwd`` with a bf16 W and float32 carries: dh within
    ``SPLIT_PRODUCT_TOL`` of its largest entry, as the float32 product it
    keeps; a two-piece split, the control, reads above that limit."""
    xp, h, c, w, b = _step_inputs(9, "bf16_f32carry", N, H)
    _, c1, g = tl.lstm_fwd_reference(xp[0], h[0], c[0], w[0], b[0])
    rnd = _In(10)
    dh1, dc1 = rnd("float32", N, H), rnd("float32", N, H)
    dz, _, _ = tl.lstm_bwd_reference(g, c[0], c1, w[0], dh1[0], dc1[0])
    wp = tl.lstm_tc_weight(w[0]).float()
    hk = wp.shape[1]
    dzp = torch.zeros((N, 4, hk))
    dzp[:, :, :H] = dz.reshape(N, 4, H)

    def split_product(split):
        dh = 0.0
        for k in range(4):
            part = sum(p.float() @ wp[k] for p in split(dzp[:, k]))
            dh = dh + part[:, :H]
        return dh
    _, w4, _ = _jax_layout(N, H, xp[1], w[1], b[1])
    g4 = jnp.asarray(_gates4(g, N, H).numpy())
    with jax.default_matmul_precision("highest"):
        _, jdh, _ = jl._run_bwd(g4, c[1], jnp.asarray(c1.numpy()), w4,
                                dh1[1], dc1[1])
    jdh = np.asarray(jdh, np.float64)

    def err(dh):
        return np.max(np.abs(dh.double().numpy() - jdh)) / np.max(
            np.abs(jdh))
    assert err(split_product(_split3)) <= SPLIT_PRODUCT_TOL
    assert err(split_product(_split2)) > SPLIT_PRODUCT_TOL


# the gates residual of the forward's split product against the
# reference's float32 forward, absolute: at this test's shapes three pieces
# read 1.3e-7 and 5.8e-7 (float32's own rounding, on both sides), two
# pieces 3.3e-6 and 4.4e-6
FWD_SPLIT_PRODUCT_TOL = 1e-6


def _fwd_split_product(h, wps, H, split, n_split, stage, pairs=None):
    """The tensor-core forward's product h W_k^T for the four gates, in
    lstm_fwd_tc_kernel's order of float32 sums: h padded to W's copy's
    width and split in bf16 pieces; for each ``stage``-deep stage of m, the
    products of h's pieces and W's pieces ``wps`` (float32 copies of the
    padded (4, Hk, Hm) pieces; ``pairs`` the (h piece, W piece) products,
    default every h piece with W's one) in a fresh float32 partial added
    to its block's sum; the stages dealt to the cluster's ``n_split``
    blocks in order and their sums added in rank order. (Within a stage
    the tensor cores' own order of adds is not emulated.) Returns (N, 4H)
    float32 in the packed column order."""
    N = h.shape[0]
    hk, hm = wps[0].shape[1:]
    hp = torch.zeros((N, hm))
    hp[:, :H] = h
    pieces = [p.float() for p in split(hp)]
    if pairs is None:
        pairs = [(q, 0) for q in range(len(pieces))]
    nk = -(-hm // stage)
    out = []
    for k in range(4):
        total = None
        for r in range(n_split):
            acc = torch.zeros((N, hk))
            for s in range(r * nk // n_split, (r + 1) * nk // n_split):
                m = slice(s * stage, (s + 1) * stage)
                acc = acc + sum(pieces[q][:, m] @ wps[w][k][:, m].t()
                                for q, w in pairs)
            total = acc if total is None else total + acc
        out.append(total[:, :H])
    return torch.cat(out, dim=1)


def _fwd_gates(xpf, bf, product, H):
    """The gates residual from z = (xp + product) + b."""
    z = (xpf + product) + bf
    return torch.cat([torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H]),
                      torch.tanh(z[:, 2 * H:3 * H]),
                      torch.sigmoid(z[:, 3 * H:])], dim=1)


@pytest.mark.parametrize("types,N,H", [("bf16_f32carry", 8, 20),
                                       ("f32_bf16w", 16, 211)])
def test_split_product_matches_run_fwd_in_float32(types, N, H):
    """The tensor-core forward's arithmetic in plain PyTorch (h in three
    bf16 pieces, each gate's pieces times W's padded copy a 32-deep stage
    at a time into a fresh float32 partial, the sums of the cluster's
    ``kFTSplit`` blocks, read from lstm.cu, in rank order, then z = (xp +
    product) + b and the activations) against the
    Pallas ``_run_fwd`` with a bf16 W and float32 carries: the gates
    residual within ``FWD_SPLIT_PRODUCT_TOL``, as the float32 product it
    keeps; a two-piece split, the control, reads above that limit."""
    xp, h, c, w, b = _step_inputs(12, types, N, H)
    wp = tl.lstm_tc_weight(w[0]).float()
    xpf, bf = xp[0].float(), b[0].float()
    consts = _lstm_cu()[1]

    def gates(split):
        return _fwd_gates(xpf, bf, _fwd_split_product(
            h[0], [wp], H, split, consts["kFTSplit"], consts["kFTK"]), H)
    xp4, w4, b4 = _jax_layout(N, H, xp[1], w[1], b[1])
    with jax.default_matmul_precision("highest"):
        _, _, jg = jl._run_fwd(xp4, h[1], c[1], w4, b4, True)
    jg = np.asarray(jg, np.float64)

    def err(g):
        return np.max(np.abs(_gates4(g, N, H).double().numpy() - jg))
    assert err(gates(_split3)) <= FWD_SPLIT_PRODUCT_TOL
    assert err(gates(_split2)) > FWD_SPLIT_PRODUCT_TOL


@pytest.mark.parametrize("route", [None, "simt"])
@pytest.mark.parametrize("name", ["lstm_fwd", "lstm_fwd_gates"])
def test_forward_wrappers_refuse_cpu_tensors_on_either_route(name, route):
    xp, h, c, w, b = (t for t, _ in _step_inputs(6, "bf16_f32carry", 8, 16))
    assert tl.lstm_fwd_route(w) == "sm90"
    fn = getattr(tl, name)
    before = (fn.launches, fn.sm90_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fn(xp, h, c, w, b, w_packed=tl.lstm_tc_weight(w), _route=route)
    assert (fn.launches, fn.sm90_launches) == before


@pytest.mark.parametrize("route", [None, "simt"])
def test_backward_wrapper_refuses_cpu_tensors_on_either_route(route):
    xp, h, c, w, b = (t for t, _ in _step_inputs(6, "bf16_f32carry", 8, 16))
    assert tl.lstm_bwd_route(w) == "sm90"
    g = torch.zeros(8, 64)
    before = (tl.lstm_bwd.launches, tl.lstm_bwd.sm90_launches)
    with pytest.raises(ValueError, match="CUDA"):
        tl.lstm_bwd(g, c, c, w, h, c, w_packed=tl.lstm_tc_weight(w),
                    _route=route)
    assert (tl.lstm_bwd.launches, tl.lstm_bwd.sm90_launches) == before


@pytest.mark.parametrize("H", [16, 20, 211])
def test_float32_weight_copy_is_three_exact_pieces(H):
    """A float32 W's copy: (3, 4, Hk, Hm) bf16 pieces whose float32 sum
    hi + mid + lo is W exactly, zeros past H (for magnitudes above about
    2^-100: below it lo falls among the denormals and loses bits)."""
    rs = np.random.RandomState(H)
    w = torch.from_numpy(np.concatenate([
        rs.randn(2 * H, H) * H ** -0.5, rs.randn(H, H) * 1e-20,
        rs.randn(H, H) * 1e30]).astype(np.float32))
    wp = tl.lstm_tc_weight(w)
    assert wp.shape == (3, 4, *tl.lstm_tc_plan(H))
    assert wp.dtype == torch.bfloat16
    hi, mid, lo = (p.float() for p in wp)
    assert torch.equal(((hi + mid) + lo)[:, :H, :H], w.reshape(4, H, H))
    assert not wp[:, :, H:].any() and not wp[:, :, :, H:].any()
    for p, q in zip(wp, _split3(w.reshape(4, H, H))):
        assert torch.equal(p[:, :H, :H], q)


# the six products of three h pieces and three W pieces whose orders sum
# to at most two, as lstm_fwd_tc_kernel runs them with a float32 W; the
# control keeps only hi.hi, hi.mid and mid.hi
SIX_PRODUCTS = [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
THREE_PRODUCTS = [(0, 1), (1, 0), (0, 0)]


# the float32-W forms of the tensor-core forward: (xp and b type, carry
# type); a bf16 h is one bf16 piece, so only the products of its piece
# (hi.lo, hi.mid, hi.hi) run
F32W_FORMS = {"f32": ("float32", "float32"),
              "bf16xp": ("bfloat16", "float32"),
              "bf16carry": ("float32", "bfloat16"),
              "bf16xp_bf16carry": ("bfloat16", "bfloat16")}


def _f32w_inputs(seed, form, N, H):
    od, sd = F32W_FORMS[form]
    rnd = _In(seed)
    xp = rnd(od, N, 4 * H)
    h, c = rnd(sd, N, H, scale=0.5), rnd(sd, N, H)
    w = rnd("float32", 4 * H, H, scale=H ** -0.5)
    b = rnd(od, 4 * H, scale=0.1)
    return xp, h, c, w, b


@pytest.mark.parametrize("form", list(F32W_FORMS))
@pytest.mark.parametrize("N,H", [(8, 20), (16, 211)])
def test_six_product_forward_matches_run_fwd_with_a_float32_weight(N, H,
                                                                   form):
    """The tensor-core forward's arithmetic with a float32 W in plain
    PyTorch (W in three bf16 pieces, h in three with float32 carries and
    in one with bf16 carries, the products of piece orders summing to at
    most two (six, or three of a bf16 h) a 32-deep stage into a fresh
    float32 partial, the cluster's sums in rank order, then z = (xp +
    product) + b) against the Pallas ``_run_fwd`` with a float32 W, in
    every float32-W form of xp's and the carries' types: the gates
    residual within ``FWD_SPLIT_PRODUCT_TOL``; the control without W's lo
    piece's products (hi.hi, hi.mid, mid.hi) reads above that limit."""
    xp, h, c, w, b = _f32w_inputs(13, form, N, H)
    wps = [p.float() for p in tl.lstm_tc_weight(w[0])]
    consts = _lstm_cu()[1]
    if h[0].dtype == torch.float32:
        split, n_h = _split3, 3
    else:
        split, n_h = (lambda v: [v.to(torch.bfloat16)]), 1

    def gates(pairs):
        return _fwd_gates(xp[0].float(), b[0].float(), _fwd_split_product(
            h[0].float(), wps, H, split, consts["kFTSplit"], consts["kFTK"],
            [(q, r) for q, r in pairs if q < n_h]), H)
    xp4, w4, b4 = _jax_layout(N, H, xp[1], w[1], b[1])
    with jax.default_matmul_precision("highest"):
        _, _, jg = jl._run_fwd(xp4, h[1], c[1], w4, b4, True)
    jg = np.asarray(jg, np.float64)

    def err(g):
        return np.max(np.abs(_gates4(g, N, H).double().numpy() - jg))
    assert err(gates(SIX_PRODUCTS)) <= FWD_SPLIT_PRODUCT_TOL
    assert err(gates(THREE_PRODUCTS)) > FWD_SPLIT_PRODUCT_TOL


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scan_hands_the_backward_the_plain_weight(monkeypatch, dt):
    """The scan and the cell make W's copy once, and their backward steps
    read that same copy: with a float32 W its (3, 4, Hk, Hm) three pieces,
    with a bf16 W its one (4, Hk, Hm) piece; W itself stays the product's
    operand for dW. (On the CPU the twins ignore the copy; here it is made
    on the CPU too, and each backward step's ``w_packed`` is recorded.)"""
    made, seen = [], []

    def tc_weight(w):
        made.append(tl.lstm_tc_weight(w))
        return made[-1]
    step_bwd = tl._step_bwd

    def recording(*args, out=None, w_packed=None):
        seen.append(w_packed)
        return step_bwd(*args, out=out, w_packed=w_packed)
    monkeypatch.setattr(tl, "_tc_weight", tc_weight)
    monkeypatch.setattr(tl, "_step_bwd", recording)
    N, H, T = 8, 16, 3
    rnd = _In(21)
    w = rnd("float32", 4 * H, H, scale=0.25)[0].to(dt).requires_grad_(True)
    xs = rnd("float32", T, N, 4 * H)[0].to(dt).requires_grad_(True)
    h0, c0 = rnd("float32", N, H)[0], rnd("float32", N, H)[0]
    b = rnd("float32", 4 * H)[0].to(dt)
    ys, _, _ = tl.lstm_scan(xs, h0, c0, w, b)
    ys.float().sum().backward()
    w4 = w.detach().reshape(4, H, H).transpose(1, 2).contiguous()
    h1, c1 = tl.lstm_cell(xs[0].detach().reshape(N, 4, H).permute(1, 0, 2),
                          h0.requires_grad_(True), c0, w4,
                          b.reshape(4, 1, H))
    (h1.float().sum() + c1.float().sum()).backward()
    assert len(made) == 2 and len(seen) == T + 1
    shape = ((3,) if dt == torch.float32 else ()) + (4, *tl.lstm_tc_plan(H))
    for wp in made:
        assert wp.shape == shape and wp.dtype == torch.bfloat16
    assert all(s is made[0] for s in seen[:T]) and seen[T] is made[1]
    assert w.grad is not None and w.grad.dtype == dt


def test_tensor_core_backward_shared_memory_mirrors_the_source():
    """The backward's ring in dynamic shared memory, as lstm.cu sizes it
    (``bwd_tc_smem_bytes``): three stages of dz's three pieces' 32 x 32
    tiles and W's PW pieces' 32 x 64 tiles, 36 KB with a bf16 W and 63 KB
    with a float32 W's three pieces, above the 48 KB static limit, so the
    launch sets the opt-in; the float32 partial (32 x 64) reuses the ring;
    at 63 KB three blocks fit an SM, so the lane's 176 blocks stay one wave
    on 132 SMs."""
    import re
    src = _lstm_cu()[0]
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kT(?:M|N|K|Stages)) = (\d+);", src)}
    tm, tn, tk, stages = (consts[k] for k in ("kTM", "kTN", "kTK",
                                              "kTStages"))
    assert ("return kTStages * (3 * kTM * kTLdA + PW * kTK * kTLdB) * 2;"
            in src)
    assert "constexpr int smem = bwd_tc_smem_bytes(PW);" in src
    assert ("lstm_bwd_tc_kernel<Ts, PW>, cudaFuncAttributeMaxDynamicShared"
            "MemorySize," in src)
    assert "lstm_bwd_tc_kernel<Ts, PW><<<grid, kTThreads, smem, st>>>(a);" \
        in src
    assert "return w_pieces == 3 ? bwd_tc_dispatch<3>(state_dtype, a, st)" \
        in src

    def smem(pw):
        return stages * (3 * tm * (tk + 8) + pw * tk * (tn + 8)) * 2
    assert smem(1) == 36864 <= 48 * 1024 < smem(3) == 64512
    assert tm * tn * 4 <= smem(1)
    assert 227 * 1024 // smem(3) == 3
    grid = (-(-650 // tn), -(-128 // tm), 4)
    assert grid[0] * grid[1] * grid[2] == 176 <= 3 * 132


# W's hi piece alone against dz's three pieces: the control of the
# float32-W backward's product (W rounded to bf16)
W_HI_PRODUCTS = [(0, 0), (1, 0), (2, 0)]


def _bwd_split_product(dz, wps, H, pairs, stage):
    """The tensor-core backward's product dh = sum_k dz_k W_k in
    lstm_bwd_tc_kernel's order of float32 sums: dz padded to W's copy's
    Hk and split in three bf16 pieces; for each gate and each ``stage``-deep
    stage of j, the products ``pairs`` ((dz piece, W piece)) in a fresh
    float32 partial added to the gate block's sum; the four gates' sums
    added in gate order. (Within a stage the tensor cores' own order of
    adds is not emulated.)"""
    N = dz.shape[0]
    hk = wps[0].shape[1]
    dzp = torch.zeros((N, 4, hk))
    dzp[:, :, :H] = dz.reshape(N, 4, H)
    pieces = [p.float() for p in _split3(dzp)]
    dh = None
    for k in range(4):
        acc = torch.zeros((N, wps[0].shape[2]))
        for j0 in range(0, hk, stage):
            j = slice(j0, j0 + stage)
            acc = acc + sum(pieces[q][:, k, j] @ wps[r][k][j]
                            for q, r in pairs)
        dh = acc if dh is None else dh + acc
    return dh[:, :H]


@pytest.mark.parametrize("form", list(F32W_FORMS))
@pytest.mark.parametrize("N,H", [(8, 20), (16, 211)])
def test_six_product_backward_matches_run_bwd_with_a_float32_weight(N, H,
                                                                    form):
    """The tensor-core backward's arithmetic with a float32 W in plain
    PyTorch (dz from the twin in three bf16 pieces, W's copy in three, the
    six products of piece orders summing to at most two a 32-deep stage
    into a fresh float32 partial, the gates' sums in order) against the
    Pallas ``_run_bwd`` with a float32 W, in every float32-W form: dh
    before its rounding to the carries' type (the Pallas kernel is handed
    bf16 carries' values in float32, which it widens to anyway) within
    ``SPLIT_PRODUCT_TOL`` of its largest entry; the control with W's hi
    piece only (three products) reads above that limit."""
    xp, h, c, w, b = _f32w_inputs(14, form, N, H)
    sd = F32W_FORMS[form][1]
    _, c1, g = tl.lstm_fwd_reference(xp[0], h[0], c[0], w[0], b[0])
    rnd = _In(15)
    dh1, dc1 = rnd(sd, N, H), rnd(sd, N, H)
    dz, _, _ = tl.lstm_bwd_reference(g, c[0], c1, w[0], dh1[0], dc1[0])
    wps = [p.float() for p in tl.lstm_tc_weight(w[0])]
    import re
    stage = int(re.search(r"constexpr int kTK = (\d+);", _lstm_cu()[0])
                .group(1))
    _, w4, _ = _jax_layout(N, H, xp[1], w[1], b[1])
    g4 = jnp.asarray(_gates4(g, N, H).numpy())

    def f32(t):
        return jnp.asarray(t.float().numpy())
    with jax.default_matmul_precision("highest"):
        _, jdh, _ = jl._run_bwd(g4, f32(c[0]), f32(c1), w4, f32(dh1[0]),
                                f32(dc1[0]))
    jdh = np.asarray(jdh, np.float64)
    assert jdh.dtype == np.float64 and np.isfinite(jdh).all()

    def err(pairs):
        dh = _bwd_split_product(dz, wps, H, pairs, stage)
        return np.max(np.abs(dh.double().numpy() - jdh)) / np.max(
            np.abs(jdh))
    assert err(SIX_PRODUCTS) <= SPLIT_PRODUCT_TOL
    assert err(W_HI_PRODUCTS) > SPLIT_PRODUCT_TOL
