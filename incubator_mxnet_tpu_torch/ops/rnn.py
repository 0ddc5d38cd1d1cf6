"""The fused multi-layer RNN over a packed parameter vector.

Counterpart of ``incubator_mxnet_tpu/ops/rnn.py``. The packed layout is the
reference's (cuDNN's): all weights, layer-major and direction-minor, w_ih
then w_hh, followed by all biases, b_ih then b_hh; gate order i, f, g, o
for LSTM and r, z, n for GRU. Each (layer, direction) projects its whole
input sequence in ONE ``torch.matmul``; the time loop then runs the fused
LSTM kernels (``ops/cuda/lstm.py`` ``lstm_scan``: on the CPU their twins)
where the reference's rule sends the shape to its kernel, and the plain
step below otherwise (GRU, the Elman RNNs, and LSTM shapes the rule
refuses, as the reference runs its jnp cell there). Inter-layer dropout is
inverted dropout drawn from the port's generator on the device.
"""
from __future__ import annotations

import torch

from . import matmul_promoted
from . import nn as _nn
from .cuda.lstm import lstm_cell_viable, lstm_scan

__all__ = ["rnn_packed_param_size", "rnn", "rnn_core", "unpack_rnn_params"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_packed_param_size(mode: str, input_size: int, state_size: int,
                          num_layers: int, bidirectional: bool = False) -> int:
    """Total flat parameter count (ref: rnn-inl.h GetRnnParamSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    ni = input_size
    for _ in range(num_layers):
        for _ in range(d):
            size += g * state_size * ni + g * state_size * state_size
            size += 2 * g * state_size
        ni = state_size * d
    return size


def unpack_rnn_params(params, mode: str, input_size: int, state_size: int,
                      num_layers: int, bidirectional: bool = False):
    """Flat vector -> per-(layer, direction) (w_ih, w_hh, b_ih, b_hh)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    weights, biases = [], []
    off = 0
    ni = input_size
    for _ in range(num_layers):
        layer_w = []
        for _ in range(d):
            w_ih = params[off:off + g * h * ni].reshape(g * h, ni)
            off += g * h * ni
            w_hh = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            layer_w.append((w_ih, w_hh))
        weights.append(layer_w)
        ni = h * d
    for _ in range(num_layers):
        layer_b = []
        for _ in range(d):
            b_ih = params[off:off + g * h]
            off += g * h
            b_hh = params[off:off + g * h]
            off += g * h
            layer_b.append((b_ih, b_hh))
        biases.append(layer_b)
    return [[w + b for w, b in zip(lw, lb)]
            for lw, lb in zip(weights, biases)]


def _step_fn(mode: str):
    """The plain step (the reference's jnp cell), in the compute type."""
    if mode == "lstm":
        def step(x_proj, h, c, w_hh, b_hh):
            gates = x_proj + matmul_promoted(h, w_hh.t()) + b_hh
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g
            h = o * torch.tanh(c)
            return h, c
        return step
    if mode == "gru":
        def step(x_proj, h, c, w_hh, b_hh):
            hp = matmul_promoted(h, w_hh.t()) + b_hh
            xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
            hr, hz, hn = torch.chunk(hp, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            return (1 - z) * n + z * h, c
        return step
    act = torch.tanh if mode == "rnn_tanh" else torch.relu

    def step(x_proj, h, c, w_hh, b_hh):
        return act(x_proj + matmul_promoted(h, w_hh.t()) + b_hh), c
    return step


def _use_fused_lstm_cell(mode: str, n: int, h: int, dtype) -> bool:
    """The fused LSTM kernels run where the reference runs its Pallas cell:
    LSTM at a shape its rule takes (``lstm_cell_viable``)."""
    return mode == "lstm" and lstm_cell_viable(n, h, dtype)


def _scan_direction(x_tnc, h0, c0, w_ih, w_hh, b_ih, b_hh, step,
                    reverse=False, fused_cell=False):
    # the input-side gate product for the WHOLE sequence is one batched
    # matmul on both paths
    x_proj = matmul_promoted(x_tnc, w_ih.t()) + b_ih
    if fused_cell:
        return lstm_scan(x_proj, h0, c0, w_hh, b_hh, reverse=reverse)
    T = x_proj.shape[0]
    h, c = h0, c0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = step(x_proj[t], h, c, w_hh, b_hh)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn_core(x_tnc, layer_params, h0_all, c0_all, mode: str,
             dropout: float = 0.0, training: bool = False, generator=None):
    """The multi-layer, multi-direction recurrence shared by nd.RNN and
    gluon's rnn_layer.

    layer_params: per-layer list of per-direction (w_ih, w_hh, b_ih, b_hh);
    h0_all/c0_all: (L*D, N, H). Returns (output_tnc, h_n, c_n) stacked over
    layer*direction; inverted dropout between layers, its mask drawn from
    ``generator`` (a ``torch.Generator`` on x's device; None, no dropout).
    """
    step = _step_fn(mode)
    num_layers = len(layer_params)
    d = len(layer_params[0])
    fused_cell = _use_fused_lstm_cell(
        mode, x_tnc.shape[1], h0_all.shape[-1], x_tnc.dtype)
    x = x_tnc
    h_out, c_out = [], []
    for li, layer in enumerate(layer_params):
        outs = []
        for di, (w_ih, w_hh, b_ih, b_hh) in enumerate(layer):
            sidx = li * d + di
            ys, hT, cT = _scan_direction(
                x, h0_all[sidx], c0_all[sidx], w_ih, w_hh, b_ih, b_hh,
                step, reverse=(di == 1), fused_cell=fused_cell)
            outs.append(ys)
            h_out.append(hT)
            c_out.append(cT)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if (dropout > 0.0 and training and li < num_layers - 1
                and generator is not None):
            x = _nn.dropout(x, generator, dropout)
    return x, torch.stack(h_out), torch.stack(c_out)


def rnn(data, parameters, state, state_cell=None, *, mode: str = "lstm",
        state_size: int, num_layers: int = 1, bidirectional: bool = False,
        p: float = 0.0, state_outputs: bool = False, training: bool = False,
        generator=None):
    """Fused RNN forward (ref: rnn-inl.h RNNOp::Forward).

    data: (T, N, C); state/state_cell: (L*D, N, H); parameters: flat vector.
    Returns output (T, N, H*D), or (output, h_n[, c_n]) if state_outputs.
    """
    T, N, C = data.shape
    layers = unpack_rnn_params(parameters, mode, C, state_size, num_layers,
                               bidirectional)
    c0_all = state_cell if state_cell is not None else torch.zeros_like(state)
    x, h_n, c_n = rnn_core(data, layers, state, c0_all, mode, dropout=p,
                           training=training, generator=generator)
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, h_n, c_n
    return x, h_n
