"""The fused LSTM cell: its CUDA kernels, their plain PyTorch twins, and the
differentiable scan and cell built on them.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/lstm.py``:

* ``lstm_fwd`` / ``lstm_fwd_gates`` and their twin ``lstm_fwd_reference``
  — one step, z_k = xp_k + h @ W_k^T + b_k for the gates i, f, g, o, then
  c' = f c + i g and h' = o tanh(c'); ``lstm_fwd_gates`` also writes the
  float32 post-activation gates residual, ``lstm_fwd`` writes none (the
  reference's ``_run_fwd`` with and without ``with_gates``). The two are
  counted apart, so a run shows its training and its inference launches.
  Both take the tensor-core kernel (:func:`lstm_fwd_route`; counted in
  ``sm90_launches`` beside ``launches``): a float32 h is split exactly
  into three bf16 pieces, and so is a float32 W, so the product stays
  float32's. It reads W only as the zero-padded copy :func:`lstm_tc_weight`
  makes (a bf16 W's values, or a float32 W's three pieces), passed as
  ``w_packed``; ``_route="simt"`` forces the FMA kernel, the yardstick;
* ``lstm_bwd`` / ``lstm_bwd_reference`` — the step's backward: from
  (gates, c, c', W, dh', dc') the four dz, dxp = dz in float32,
  dh = dz @ W and dc = dct f (the reference's ``_run_bwd``). It takes the
  tensor-core kernels (:func:`lstm_bwd_route`) with W_hh in bf16 or
  float32: dz split into three bf16 pieces, times the same copy of W the
  forward reads (a float32 W's three pieces: six products a stage);
  ``_route="simt"`` forces the SIMT kernel, the yardstick;
* ``lstm_scan`` — the whole sequence as one ``torch.autograd.Function``
  (the reference's scan-level custom VJP ``_lstm_scan_fused``): the forward
  makes W's copy once, checks the sequence's tensors once and launches the
  forward kernel T times on pointers into them, with the residual only when
  a gradient is needed; the residuals are (ys, c's, gates, W's copy), the h
  and c histories being the outputs shifted one step; the backward loops
  in reverse over the backward kernel and forms dW_hh and db_hh as ONE
  float32 product over the stacked (T N) rows, cast to the weight's type;
* ``lstm_cell`` — one step with its own VJP (the reference's per-cell
  custom VJP), in the reference's (4, N, H) / (4, H, H) layouts; W's copy
  is made once a step, for the forward and the backward;
* ``lstm_cell_viable`` — the reference's rule for which shapes go to its
  kernel (the others run its plain jnp cell, ``ops/rnn.py``), kept so that
  the port rounds as the reference does at every shape.

The kernels take the packed layouts: xp (N, 4H) (one step of
x @ W_ih^T + b_ih), w (4H, H) (W_hh), b (4H,), gates and dxp (N, 4H)
float32. xp and b share one type, W has its own, and the carries h, c (and
their cotangents) another, each float32 or bfloat16: the word LM under
bf16 compute carries float32 states, projects layer 1 in bf16 and layer 2
in float32 (float32 x times a bf16 W_ih), with a bf16 W_hh in both, as the
reference does. The gate math runs in float32; h' and c' are rounded to
the carries' type, dh and dc to the cotangents'. CUDA tensors go through
the kernels, CPU tensors through the twins; a kernel wrapper given
anything else raises. The tensor-core routes use thread-block clusters and
run only on a Hopper card.
"""
from __future__ import annotations

import torch

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, pick_block)

__all__ = ["lstm_fwd", "lstm_fwd_gates", "lstm_bwd", "lstm_fwd_reference",
           "lstm_bwd_reference", "lstm_scan", "lstm_cell",
           "lstm_cell_viable", "lstm_fwd_route", "lstm_bwd_route",
           "lstm_tc_weight", "lstm_tc_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core backward's reduction stage (lstm.cu kTK): W's copy and
# the dz pieces are padded to a multiple of it along j
TC_TK = 32

# ---------------------------------------------------- the reference's rule
_LSTM_VMEM_BUDGET = 14 * 1024 * 1024


def _pad8(d: int) -> int:
    return -(-d // 8) * 8


def _pad128(d: int) -> int:
    return -(-d // 128) * 128


def _cell_block_rows(n: int, h: int) -> int:
    """The reference's row block of its cell kernel (weights plus per-row
    activations within its 14 MB budget, with the TPU's padded tilings);
    0 means it runs the plain cell."""
    w_bytes = 4 * _pad8(h) * _pad128(h) * 4
    budget = _LSTM_VMEM_BUDGET - w_bytes
    if budget <= 0:
        return 0
    per_row = 16 * _pad128(h) * 4
    max_rows = budget // per_row // 8 * 8
    if max_rows < 8:
        return 0
    pow2 = 1 << (int(max_rows).bit_length() - 1)
    block = pick_block(n, min(256, pow2))
    return block if block % 8 == 0 else 0


def lstm_cell_viable(n: int, h: int, dtype) -> bool:
    """Does the reference send a batch of ``n`` rows, hidden size ``h`` and
    type ``dtype`` (a torch dtype) to its kernel? The CUDA kernels take any
    shape; this rule only keeps the port's rounding equal to the
    reference's."""
    if n % 8 != 0 or dtype not in _DTYPE_CODE:
        return False
    return _cell_block_rows(n, h) > 0


# ------------------------------------------------------------------ twins
def lstm_fwd_reference(xp, h, c, w, b, with_gates: bool = True):
    """Plain twin of the forward kernels (``_fwd_kernel``). Returns (h',
    c', gates (N, 4H) float32 or None)."""
    H = h.shape[1]
    z = (xp.float() + torch.matmul(h.float(), w.float().t())) + b.float()
    i = torch.sigmoid(z[:, :H])
    f = torch.sigmoid(z[:, H:2 * H])
    g = torch.tanh(z[:, 2 * H:3 * H])
    o = torch.sigmoid(z[:, 3 * H:])
    c1 = f * c.float() + i * g
    h1 = (o * torch.tanh(c1)).to(h.dtype)
    gates = torch.cat([i, f, g, o], dim=1) if with_gates else None
    return h1, c1.to(c.dtype), gates


def lstm_bwd_reference(gates, c, c1, w, dh1, dc1):
    """Plain twin of the backward kernel (``_bwd_kernel``). Returns (dxp
    (N, 4H) float32, dh like dh1, dc like dc1)."""
    H = c.shape[1]
    i, f = gates[:, :H], gates[:, H:2 * H]
    g, o = gates[:, 2 * H:3 * H], gates[:, 3 * H:]
    cf, dh1f, dc1f = c.float(), dh1.float(), dc1.float()
    tc = torch.tanh(c1.float())
    do = dh1f * tc
    dct = dc1f + dh1f * o * (1.0 - tc * tc)
    dz = torch.cat([dct * g * i * (1.0 - i), dct * cf * f * (1.0 - f),
                    dct * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
    dh = torch.matmul(dz, w.float())
    return dz, dh.to(dh1.dtype), (dct * f).to(dc1.dtype)


# ------------------------------------------------------------- wrappers
def _check(name, ref, *ops):
    """Every operand a contiguous CUDA tensor on ref's device; ``ops`` are
    (tensor, shape, dtype)."""
    if not ref.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{ref.device}")
    for t, shape, dtype in ops:
        if dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: dtype {dtype} not supported (float32 "
                            "or bfloat16)")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
                or t.device != ref.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {tuple(shape)} {dtype} "
                f"tensor on {ref.device}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")


def _launch(kern, sm90, fn, args):
    """One launch through the C entry point ``fn``; counts it on ``kern``
    (and on its Hopper route when ``sm90``)."""
    check_launch(fn(*args), kern.__name__)
    kern.launches += 1
    if sm90:
        kern.sm90_launches += 1


def lstm_fwd_route(w) -> str:
    """"sm90": :func:`lstm_fwd` and :func:`lstm_fwd_gates` take the
    tensor-core kernel with W_hh in bf16 or float32, either carry type and
    either operand type (the FMA kernel only when ``_route="simt"`` forces
    it)."""
    return "sm90"


def lstm_bwd_route(w) -> str:
    """"sm90": :func:`lstm_bwd` takes the tensor-core kernels with W_hh in
    bf16 (one piece) or float32 (three pieces) and either carry type (the
    SIMT kernel only when ``_route="simt"`` forces it)."""
    return "sm90"


def lstm_tc_plan(h: int) -> tuple[int, int]:
    """The tensor-core kernels' padded sizes at hidden size ``h``: (hk, hm),
    W's copy being (4, hk, hm) a piece and the dz pieces' scratch (3, N, 4,
    hk)."""
    return -(-h // TC_TK) * TC_TK, -(-h // 8) * 8


def _bf16_pieces(v):
    """A float32 tensor as its three bf16 pieces hi, mid, lo, stacked:
    hi + mid + lo == v exactly (each residual is exact in float32, and lo
    holds what is left)."""
    hi = v.to(torch.bfloat16)
    r1 = v - hi.float()
    mid = r1.to(torch.bfloat16)
    return torch.stack([hi, mid, (r1 - mid.float()).to(torch.bfloat16)])


def lstm_tc_weight(w):
    """W_hh (4H, H) as the tensor-core kernels read it: (4, Hk, Hm) with
    [k, j, m] = W[k H + j, m] for a bf16 W, and (3, 4, Hk, Hm) bf16 with
    W's hi, mid and lo pieces for a float32 W; zeros past H, every row
    16-byte aligned (16-byte ``cp.async``). The forward reduces along m,
    the backward along j. A copy of W, made once per sequence (once a step
    by the cell) and read both ways."""
    hid = w.shape[1]
    w4 = w.reshape(4, hid, hid)
    if w.dtype == torch.float32:
        wp = w.new_zeros((3, 4, *lstm_tc_plan(hid)), dtype=torch.bfloat16)
        wp[:, :, :hid, :hid] = _bf16_pieces(w4)
        return wp
    wp = w.new_zeros((4, *lstm_tc_plan(hid)))
    wp[:, :hid, :hid] = w4
    return wp


def _tc_weight(w):
    """W's copy for the kernels on the card, both ways, else None (a CPU
    W: the twins read W itself)."""
    return lstm_tc_weight(w) if w.is_cuda else None


def _fwd_entry(sm90, dt, wdt, st, n, hid, wp, stream):
    """The forward's C entry point and the arguments around the eight
    tensor pointers (xp, h, c, W or its copy, b, h', c', gates)."""
    lib = kernel_library()
    if sm90:
        hk, hm = wp.shape[-2:]
        pieces = 3 if wp.dim() == 4 else 1
        return (lib.mxt_lstm_fwd_sm90,
                (_DTYPE_CODE[dt], _DTYPE_CODE[st], pieces),
                (n, hid, hk, hm, stream))
    return (lib.mxt_lstm_fwd,
            (_DTYPE_CODE[dt], _DTYPE_CODE[wdt], _DTYPE_CODE[st]),
            (n, hid, stream))


def _check_route(name, ref, w, hid, w_packed, route, rule):
    """Is the call on the tensor-core route (``rule``, the wrapper's route
    function, decides by W's type, unless ``route`` forces "simt")?
    Checks ``w_packed`` there: the copy :func:`lstm_tc_weight` makes of
    W."""
    if route not in (None, "simt"):
        raise ValueError(f"{name}: _route {route!r}")
    sm90 = (route or rule(w)) == "sm90"
    if sm90:
        if w_packed is None:
            raise ValueError(f"{name}: the tensor-core route reads W's "
                             "copy: pass w_packed=lstm_tc_weight(w)")
        pieces = (3,) if w.dtype == torch.float32 else ()
        _check(name, ref, (w_packed, (*pieces, 4, *lstm_tc_plan(hid)),
                           torch.bfloat16))
    return sm90


def _launch_fwd(kern, with_gates, xp, h, c, w, b, out, w_packed, route):
    name = kern.__name__
    n, hid = h.shape
    dt, st = xp.dtype, h.dtype
    _check(name, h, (xp, (n, 4 * hid), dt), (h, (n, hid), st),
           (c, (n, hid), st), (w, (4 * hid, hid), w.dtype),
           (b, (4 * hid,), dt))
    sm90 = _check_route(name, h, w, hid, w_packed, route, lstm_fwd_route)
    if out is None:
        out = (torch.empty_like(h), torch.empty_like(c),
               torch.empty((n, 4 * hid), dtype=torch.float32,
                           device=h.device) if with_gates else None)
    h1, c1, gates = out
    _check(name, h, (h1, (n, hid), st), (c1, (n, hid), st),
           *([(gates, (n, 4 * hid), torch.float32)] if with_gates else []))
    fn, head, tail = _fwd_entry(sm90, dt, w.dtype, st, n, hid, w_packed,
                                current_stream_handle(h))
    ptrs = (xp.data_ptr(), h.data_ptr(), c.data_ptr(),
            (w_packed if sm90 else w).data_ptr(), b.data_ptr(),
            h1.data_ptr(), c1.data_ptr(),
            gates.data_ptr() if with_gates else None)
    _launch(kern, sm90, fn, head + ptrs + tail)
    return h1, c1, gates


@counted_kernel
def lstm_fwd(xp, h, c, w, b, out=None, w_packed=None, _route=None):
    """CUDA kernel of one LSTM step without the gates residual (replaces
    the Pallas ``_run_fwd(with_gates=False)``). ``out`` optionally gives
    (h', c', None) to write into. The route is :func:`lstm_fwd_route`'s;
    the tensor-core route needs ``w_packed``, W's copy from
    :func:`lstm_tc_weight`, which a caller makes once for all the steps it
    runs with one W. ``_route="simt"`` forces the FMA kernel. Returns (h',
    c', None)."""
    return _launch_fwd(lstm_fwd, False, xp, h, c, w, b, out, w_packed,
                       _route)


@counted_kernel
def lstm_fwd_gates(xp, h, c, w, b, out=None, w_packed=None, _route=None):
    """CUDA kernel of one LSTM step with the float32 gates residual
    (replaces the Pallas ``_run_fwd(with_gates=True)``). ``out``
    optionally gives (h', c', gates) to write into; ``w_packed`` and
    ``_route`` as for :func:`lstm_fwd`. Returns (h', c', gates)."""
    return _launch_fwd(lstm_fwd_gates, True, xp, h, c, w, b, out, w_packed,
                       _route)


@counted_kernel
def lstm_bwd(gates, c, c1, w, dh1, dc1, out=None, w_packed=None,
             _route=None):
    """CUDA kernels of one LSTM step's backward (replace the Pallas
    ``_run_bwd``). ``out`` optionally gives the (N, 4H) float32 dxp to
    write into. The route is :func:`lstm_bwd_route`'s; the tensor-core
    route needs ``w_packed``, W's copy from :func:`lstm_tc_weight`, which
    a caller makes once for all the steps it runs with one W.
    With a float32 W, ``w_packed`` is its (3, 4, Hk, Hm) three-piece copy.
    ``_route="simt"`` forces the SIMT kernel. Returns (dxp, dh, dc)."""
    n, hid = c.shape
    st = c.dtype
    _check("lstm_bwd", c, (gates, (n, 4 * hid), torch.float32),
           (c, (n, hid), st), (c1, (n, hid), st),
           (w, (4 * hid, hid), w.dtype), (dh1, (n, hid), st),
           (dc1, (n, hid), st))
    sm90 = _check_route("lstm_bwd", c, w, hid, w_packed, _route,
                        lstm_bwd_route)
    dxp = out if out is not None else torch.empty(
        (n, 4 * hid), dtype=torch.float32, device=c.device)
    _check("lstm_bwd", c, (dxp, (n, 4 * hid), torch.float32))
    dh, dc = torch.empty_like(dh1), torch.empty_like(dc1)
    lib = kernel_library()
    if sm90:
        hk, hm = w_packed.shape[-2:]
        dzs = torch.empty((3, n, 4, hk), dtype=torch.bfloat16,
                          device=c.device)
        fn, args = lib.mxt_lstm_bwd_sm90, (
            _DTYPE_CODE[st], 3 if w_packed.dim() == 4 else 1,
            gates.data_ptr(), c.data_ptr(), c1.data_ptr(),
            w_packed.data_ptr(), dh1.data_ptr(), dc1.data_ptr(),
            dxp.data_ptr(), dh.data_ptr(), dc.data_ptr(), dzs.data_ptr(), n,
            hid, hk, hm, current_stream_handle(c))
    else:
        fn, args = lib.mxt_lstm_bwd, (
            _DTYPE_CODE[w.dtype], _DTYPE_CODE[st], gates.data_ptr(),
            c.data_ptr(), c1.data_ptr(),
            w.data_ptr(), dh1.data_ptr(), dc1.data_ptr(), dxp.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), n, hid, current_stream_handle(c))
    _launch(lstm_bwd, sm90, fn, args)
    return dxp, dh, dc


def _twin_fwd(xp, h, c, w, b, with_gates, out=None):
    """One step on the twin, written into ``out`` when given."""
    res = lstm_fwd_reference(xp, h, c, w, b, with_gates)
    if out is None:
        return res
    for dst, src in zip(out, res):
        if dst is not None:
            dst.copy_(src)
    return out


def _twin_bwd(gates, c, c1, w, dh1, dc1, out=None):
    """One backward step on the twin, written into ``out`` when given."""
    dxp, dh, dc = lstm_bwd_reference(gates, c, c1, w, dh1, dc1)
    if out is not None:
        out.copy_(dxp)
        dxp = out
    return dxp, dh, dc


def _step_fwd(xp, h, c, w, b, with_gates, out=None, w_packed=None):
    """One step: the kernel on the card (``w_packed`` from
    :func:`_tc_weight`), the twin on the CPU."""
    if h.is_cuda:
        kern = lstm_fwd_gates if with_gates else lstm_fwd
        return kern(xp, h, c, w, b, out=out, w_packed=w_packed)
    return _twin_fwd(xp, h, c, w, b, with_gates, out)


def _step_bwd(gates, c, c1, w, dh1, dc1, out=None, w_packed=None):
    """One backward step: the kernels on the card (``w_packed`` from
    :func:`_tc_weight`), the twin on the CPU."""
    if c.is_cuda:
        return lstm_bwd(gates, c, c1, w, dh1, dc1, out=out,
                        w_packed=w_packed)
    return _twin_bwd(gates, c, c1, w, dh1, dc1, out)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _operands(xp, b):
    """xp and b in one type, as the kernels take them: when their types
    differ, both widened to float32, which is exact (the reference widens
    each operand to float32 inside its kernel). W keeps its own type, so a
    bf16 W_hh under a float32 x_proj (the word LM's layer 2) still takes
    the tensor-core routes."""
    if xp.dtype == b.dtype:
        return xp, b
    return xp.float(), b.float()


# ------------------------------------------------------------ the scan
def _twin_steps(x_proj, h0, c0, w, b, wp, outs, order):
    """The scan's forward steps on the twin, each written into its slice
    of ``outs`` (ys, c's, gates or None). ``wp`` is the kernels' and unused
    here."""
    ys, c1s, gs = outs
    h, c = h0, c0
    for t in order:
        _twin_fwd(x_proj[t], h, c, w, b, gs is not None,
                  out=(ys[t], c1s[t], None if gs is None else gs[t]))
        h, c = ys[t], c1s[t]


def _kernel_steps(x_proj, h0, c0, w, b, wp, outs, order):
    """The scan's forward steps on the card: the sequence's tensors are
    checked once (x_proj, h0, c0, W, b, W's copy ``wp`` on the tensor-core
    route, and the ys, c's and gates buffers ``outs``), then each step is
    one launch on pointers offset into them, with no per-step views or
    checks."""
    ys, c1s, gs = outs
    T, N, H = ys.shape
    kern = lstm_fwd_gates if gs is not None else lstm_fwd
    name = kern.__name__
    dt, st = x_proj.dtype, h0.dtype
    _check(name, h0, (x_proj, (T, N, 4 * H), dt), (h0, (N, H), st),
           (c0, (N, H), st), (w, (4 * H, H), w.dtype), (b, (4 * H,), dt),
           (ys, (T, N, H), st), (c1s, (T, N, H), st),
           *([] if gs is None else [(gs, (T, N, 4 * H), torch.float32)]))
    sm90 = _check_route(name, h0, w, H, wp, None, lstm_fwd_route)
    fn, head, tail = _fwd_entry(sm90, dt, w.dtype, st, N, H, wp,
                                current_stream_handle(h0))
    xs, ss, gz = (N * 4 * H * x_proj.element_size(),
                  N * H * ys.element_size(), N * 4 * H * 4)
    xp0, y0, c0p = x_proj.data_ptr(), ys.data_ptr(), c1s.data_ptr()
    g0 = None if gs is None else gs.data_ptr()
    wb = ((wp if sm90 else w).data_ptr(), b.data_ptr())
    h, c = h0.data_ptr(), c0.data_ptr()
    for t in order:
        y, cc = y0 + t * ss, c0p + t * ss
        args = (xp0 + t * xs, h, c) + wb + (
            y, cc, None if g0 is None else g0 + t * gz)
        _launch(kern, sm90, fn, head + args + tail)
        h, c = y, cc


def _scan_forward(x_proj, h0, c0, w, b, reverse, with_gates, wp=None):
    """The forward loop over the caller's operands (xp and b widened by
    ``_operands``; ``wp`` W's copy from :func:`_tc_weight`): ys (T, N, H),
    c's (T, N, H) and, with the residual, the gates (T, N, 4H) float32,
    each step written in place, by :func:`_kernel_steps` on the card and
    :func:`_twin_steps` on the CPU."""
    x_proj, b = _operands(x_proj, b)
    T, N, _ = x_proj.shape
    H = h0.shape[1]
    ys = torch.empty((T, N, H), dtype=h0.dtype, device=h0.device)
    c1s = torch.empty((T, N, H), dtype=c0.dtype, device=c0.device)
    gs = (torch.empty((T, N, 4 * H), dtype=torch.float32, device=h0.device)
          if with_gates else None)
    order = range(T - 1, -1, -1) if reverse else range(T)
    steps = _kernel_steps if h0.is_cuda else _twin_steps
    steps(x_proj, h0, c0, w, b, wp, (ys, c1s, gs), order)
    return ys, c1s, gs


class _LSTMScan(torch.autograd.Function):
    """The reference's ``_lstm_scan_fwd`` / ``_lstm_scan_bwd``, given the
    caller's operands: the forward widens xp and b (``_scan_forward``) and
    makes W's copy once for both loops (a float32 W's three pieces, or a
    bf16 W's one); the backward multiplies by W_hh as the caller passed
    it, so a bf16 W_hh under float32 operands stays in bf16."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, w, b, reverse):
        wp = _tc_weight(w)                  # once for the T steps
        ys, c1s, gs = _scan_forward(x_proj, h0, c0, w, b, reverse, True, wp)
        ctx.reverse = reverse
        ctx.b_dtype = b.dtype
        ctx.save_for_backward(ys, c1s, gs, h0, c0, w, wp)
        last = 0 if reverse else ys.shape[0] - 1
        return ys, ys[last].clone(), c1s[last].clone()

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, c1s, gs, h0, c0, w, wp = ctx.saved_tensors
        T, N, H = ys.shape
        rev = ctx.reverse
        dzs = torch.empty((T, N, 4 * H), dtype=torch.float32,
                          device=ys.device)
        dh, dc = dhT.contiguous(), dcT.contiguous()
        for t in (range(T) if rev else range(T - 1, -1, -1)):
            prev = t + 1 if rev else t - 1
            c_t = c0 if prev in (-1, T) else c1s[prev]
            # the step's output cotangent joins the carry's, in its type
            _, dh, dc = _step_bwd(gs[t], c_t, c1s[t], w,
                                  (dh + dys[t]).to(dh.dtype), dc,
                                  out=dzs[t], w_packed=wp)
        hs = (torch.cat([ys[1:], h0[None]]) if rev
              else torch.cat([h0[None], ys[:-1]]))
        dz2 = dzs.reshape(T * N, 4 * H)
        # dW_hh and db_hh as ONE float32 contraction over the T N rows
        dw = torch.matmul(dz2.t(), hs.reshape(T * N, H).float())
        db = dz2.sum(dim=0)
        return (dzs.to(ys.dtype), dh, dc, dw.to(w.dtype),
                db.to(ctx.b_dtype), None)


def lstm_scan(x_proj, h0, c0, w_hh, b_hh, reverse: bool = False):
    """Scan the fused cell over a pre-projected sequence.

    x_proj (T, N, 4H) = x @ W_ih^T + b_ih (gate order i, f, g, o), h0/c0
    (N, H), w_hh (4H, H), b_hh (4H,), in the reference's packed layout.
    ``reverse`` runs t = T-1 .. 0 (the second direction). Returns (ys
    (T, N, H), hT, cT). Differentiable when a gradient is needed; else the
    forward kernel runs without the residual."""
    args = [t.contiguous() for t in (x_proj, h0, c0, w_hh, b_hh)]
    if _needs_grad(*args):
        return _LSTMScan.apply(*args, bool(reverse))
    ys, c1s, _ = _scan_forward(*args, reverse, False, _tc_weight(args[3]))
    last = 0 if reverse else ys.shape[0] - 1
    return ys, ys[last], c1s[last]


# ------------------------------------------------------------- the cell
def _cell_layout(xp4, w4, b4):
    """The reference's (4, N, H) / (4, H, H) / (4, 1, H) operands in the
    kernels' packed layouts (copies: the cell is off the main path)."""
    _, N, H = xp4.shape
    xp, b = _operands(xp4, b4)
    return (xp.permute(1, 0, 2).reshape(N, 4 * H).contiguous(),
            w4.transpose(1, 2).reshape(4 * H, H).contiguous(),
            b.reshape(4 * H).contiguous())


class _LSTMCell(torch.autograd.Function):
    """The reference's per-cell VJP (``_cell_fwd`` / ``_cell_bwd``)."""

    @staticmethod
    def forward(ctx, xp4, h, c, w4, b4):
        xp, w, b = _cell_layout(xp4, w4, b4)
        h, c = h.contiguous(), c.contiguous()
        wp = _tc_weight(w)                  # once for the step both ways
        h1, c1, gates = _step_fwd(xp, h, c, w, b, True, w_packed=wp)
        ctx.save_for_backward(gates, c, c1, h, w, wp)
        ctx.b_dtype = b4.dtype
        return h1, c1

    @staticmethod
    def backward(ctx, dh1, dc1):
        gates, c, c1, h, w, wp = ctx.saved_tensors
        N, H = h.shape
        dxp, dh, dc = _step_bwd(gates, c, c1, w, dh1.contiguous(),
                                dc1.contiguous(), w_packed=wp)
        # per-step weight gradients in float32, cast to w's type
        dw4 = torch.matmul(dxp.t(), h.float()).reshape(4, H, H)
        db4 = dxp.sum(dim=0).reshape(4, 1, H)
        return (dxp.reshape(N, 4, H).permute(1, 0, 2).to(h.dtype), dh, dc,
                dw4.transpose(1, 2).to(w.dtype),
                db4.to(w.dtype).to(ctx.b_dtype))


def lstm_cell(xp4, h, c, w4, b4):
    """One fused LSTM step in the reference's layouts: xp4 (4, N, H)
    pre-projected inputs (b_ih folded in), h/c (N, H), w4 (4, H, H) with
    z_k = h @ w4[k], b4 (4, 1, H). Returns (h', c')."""
    if _needs_grad(xp4, h, c, w4, b4):
        return _LSTMCell.apply(xp4, h, c, w4, b4)
    xp, w, b = _cell_layout(xp4, w4, b4)
    h1, c1, _ = _step_fwd(xp, h.contiguous(), c.contiguous(), w, b, False,
                          w_packed=_tc_weight(w))
    return h1, c1
