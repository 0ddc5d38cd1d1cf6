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
    """A bf16 W_hh takes the tensor-core kernels with either carry type (the
    route reads W's type only); a float32 W_hh the SIMT kernel."""
    for types in ("bf16", "bf16_f32carry", "f32"):
        _, _, _, w, _ = _step_inputs(7, types, 8, 16)
        want = "sm90" if TYPES[types][1] == "bfloat16" else "simt"
        assert tl.lstm_bwd_route(w[0]) == want
    # the word LM's lane: bf16 operands, float32 carries
    assert tl.lstm_bwd_route(torch.empty((2600, 650), dtype=torch.bfloat16,
                                         device="meta")) == "sm90"


def test_forward_route_is_chosen_by_the_weight_type():
    """A bf16 W_hh takes the tensor-core forward with either carry type and
    either x_proj type (the route reads W's type only); a float32 W_hh the
    FMA kernel."""
    for types in TYPES:
        _, _, _, w, _ = _step_inputs(7, types, 8, 16)
        want = "sm90" if TYPES[types][1] == "bfloat16" else "simt"
        assert tl.lstm_fwd_route(w[0]) == want
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
    pieces' and W's tiles in static shared memory), fits a block's 48 KB
    and fills the card at the lane (at least 128 blocks)."""
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
    assert ("As[kTStages][3][kTM * kTLdA]" in src
            and "Bs[kTStages][kTK * kTLdB]" in src)
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
    partial aliased on it), the epilogue's (n, j) dealt to the threads. At
    the lane (N 128, H 650) it runs 328 blocks, one wave on the H100's 132
    SMs at five blocks an SM, every block a chain of 10 or 11 of the 21
    stages; W's copy holds every row a column tile reads."""
    src, consts = _lstm_cu()
    tm, tj, tk, split, stages, threads = (consts[k] for k in (
        "kFTM", "kFTJ", "kFTK", "kFTSplit", "kFTStages", "kFTThreads"))
    assert tk == tl.TC_TK and threads == 128 and stages == 3
    assert "constexpr int kFTLd = kFTK + 8;" in src
    assert "__cluster_dims__(1, 1, kFTSplit)" in src
    assert ("grid((a.H + kFTJ - 1) / kFTJ, (a.N + kFTM - 1) / kFTM, "
            "kFTSplit)" in src)
    assert "smem[kFTStages * (P * kA + kB)]" in src
    assert tm % split == 0
    ld = tk + 8
    for pieces in (3, 1):
        smem = stages * (pieces * tm * ld + 4 * tj * ld) * 2
        assert tm * 4 * tj * 4 <= smem <= 48 * 1024
    n, h = 128, 650
    hk, hm = tl.lstm_tc_plan(h)
    grid = (-(-h // tj), -(-n // tm), split)
    assert grid == (41, 4, 2)
    blocks = grid[0] * grid[1] * grid[2]
    assert 2 * 132 < blocks <= 5 * 132
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


def _fwd_split_product(h, wp, H, split, n_split, stage):
    """The tensor-core forward's product h W_k^T for the four gates, in
    lstm_fwd_tc_kernel's order of float32 sums: h padded to W's copy's
    width and split in bf16 pieces; for each ``stage``-deep stage of m, the
    pieces times W's padded rows in a fresh float32 partial added to its
    block's sum; the stages dealt to the cluster's ``n_split`` blocks in
    order and their sums added in rank order. (Within a stage the tensor
    cores' own order of adds is not emulated.) Returns (N, 4H) float32 in
    the packed column order."""
    N = h.shape[0]
    hm = wp.shape[2]
    hp = torch.zeros((N, hm))
    hp[:, :H] = h
    pieces = [p.float() for p in split(hp)]
    nk = -(-hm // stage)
    out = []
    for k in range(4):
        total = None
        for r in range(n_split):
            acc = torch.zeros((N, wp.shape[1]))
            for s in range(r * nk // n_split, (r + 1) * nk // n_split):
                m = slice(s * stage, (s + 1) * stage)
                acc = acc + sum(p[:, m] @ wp[k][:, m].t() for p in pieces)
            total = acc if total is None else total + acc
        out.append(total[:, :H])
    return torch.cat(out, dim=1)


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
        z = (xpf + _fwd_split_product(h[0], wp, H, split, consts["kFTSplit"],
                                      consts["kFTK"])) + bf
        return torch.cat([torch.sigmoid(z[:, :H]),
                          torch.sigmoid(z[:, H:2 * H]),
                          torch.tanh(z[:, 2 * H:3 * H]),
                          torch.sigmoid(z[:, 3 * H:])], dim=1)
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
