"""The port's fused RNN (``ops/rnn.py``, ``nd.RNN``), the gluon ``rnn``
layers and cells, and ``metric.py`` against the JAX package, on the CPU.

Inputs and weights come from numpy with a seed; gluon weights cross by
name with ``params_from_jax``. The JAX side runs under
``jax.default_matmul_precision("highest")`` with its Pallas LSTM in
interpret mode (``MXTPU_PALLAS=lstm_cell,lstm_scan``); the port runs the
plain twins of its LSTM kernels where the reference's rule takes the shape
(batch a multiple of 8) and the plain cell elsewhere, as the reference
does. Tolerance: max |port - jax| over max(1, max |jax|) within 1e-5
(float32). Dropout and zoneout streams differ between the packages, so
their parity cases run at rate 0 and separate tests hold the port's masks
to their rate and scale.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops import rnn as jrnn
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.ops import rnn as trnn

TOL = 1e-5
MODES = ["lstm", "gru", "rnn_relu", "rnn_tanh"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "lstm_cell,lstm_scan")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _err(t, j):
    t = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(
        t.detach() if torch.is_tensor(t) else t)
    j = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    return np.max(np.abs(t.astype(np.float64) - j)) / max(1.0,
                                                          np.max(np.abs(j)))


def _cross(jblock, tblock):
    params_from_jax(tblock, {k: p.data().asnumpy() for k, p in
                             jblock._collect_params_with_prefix().items()})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir,N", [(1, False, 8), (2, True, 5),
                                            (2, False, 8)])
def test_fused_rnn_op_matches_jax(mode, layers, bidir, N):
    T, C, H = 5, 6, 16
    size = trnn.rnn_packed_param_size(mode, C, H, layers, bidir)
    assert size == jrnn.rnn_packed_param_size(mode, C, H, layers, bidir)
    rs = np.random.RandomState(0)
    d = 2 if bidir else 1
    x = rs.randn(T, N, C).astype(np.float32)
    params = (rs.randn(size) * 0.3).astype(np.float32)
    h0 = rs.randn(layers * d, N, H).astype(np.float32) * 0.5
    c0 = rs.randn(layers * d, N, H).astype(np.float32) * 0.5
    kw = dict(mode=mode, state_size=H, num_layers=layers,
              bidirectional=bidir, state_outputs=True)
    cell = c0 if mode == "lstm" else None
    jout = jrnn.rnn(jnp.asarray(x), jnp.asarray(params), jnp.asarray(h0),
                    None if cell is None else jnp.asarray(cell), **kw)
    tout = trnn.rnn(torch.from_numpy(x), torch.from_numpy(params),
                    torch.from_numpy(h0),
                    None if cell is None else torch.from_numpy(cell), **kw)
    assert len(tout) == len(jout) == (3 if mode == "lstm" else 2)
    for t, j in zip(tout, jout):
        assert _err(t, j) <= TOL
    # nd.RNN, the same op through invoke, without the states
    jo = jmx.nd.RNN(jmx.nd.array(x), jmx.nd.array(params),
                    jmx.nd.array(h0), mode=mode, state_size=H,
                    num_layers=layers, bidirectional=bidir)
    to = tmx.nd.RNN(tmx.nd.array(x), tmx.nd.array(params),
                    tmx.nd.array(h0), mode=mode, state_size=H,
                    num_layers=layers, bidirectional=bidir)
    assert _err(to, jo) <= TOL


def test_nd_rnn_keyword_checks_and_gradient():
    x = tmx.nd.ones((3, 8, 4))
    with pytest.raises(ValueError, match="state_size"):
        tmx.nd.RNN(x, x, x)
    with pytest.raises(tmx.base.MXTPUError, match="unknown argument"):
        tmx.nd.RNN(x, x, x, state_size=4, foo=1)
    # through autograd.record(), the packed vector gets the gradient of
    # both packages
    rs = np.random.RandomState(1)
    T, N, C, H = 4, 8, 5, 8
    size = trnn.rnn_packed_param_size("lstm", C, H, 1)
    xs = rs.randn(T, N, C).astype(np.float32)
    ps = (rs.randn(size) * 0.3).astype(np.float32)
    h0 = np.zeros((1, N, H), np.float32)
    grads = []
    for mx in (jmx, tmx):
        p = mx.nd.array(ps)
        p.attach_grad()
        with mx.autograd.record():
            out = mx.nd.RNN(mx.nd.array(xs), p, mx.nd.array(h0),
                            mx.nd.array(h0), state_size=H, mode="lstm")
            loss = (out * out).sum()
        loss.backward()
        grads.append(p.grad.asnumpy())
    assert _err(grads[1], grads[0]) <= TOL


@pytest.mark.parametrize("layer,layers,layout,bidir,N", [
    ("LSTM", 2, "TNC", False, 8), ("LSTM", 1, "NTC", True, 8),
    ("LSTM", 1, "TNC", False, 5), ("GRU", 1, "NTC", False, 8),
    ("RNN", 1, "TNC", True, 5)])
def test_gluon_layers_match_jax(layer, layers, layout, bidir, N):
    T, C, H = 4, 7, 12
    rs = np.random.RandomState(2)
    x = rs.randn(*((T, N, C) if layout == "TNC" else (N, T, C))
                 ).astype(np.float32)
    nets = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            net = getattr(mx.gluon.rnn, layer)(H, num_layers=layers,
                                               layout=layout,
                                               bidirectional=bidir)
        nets.append(net)
    jnet, tnet = nets
    jnet.initialize(jmx.init.Xavier())
    jout = jnet(jmx.nd.array(x))            # deferred shapes resolve
    tnet.initialize()
    _cross(jnet, tnet)
    assert sorted(tnet.collect_params()) == sorted(jnet.collect_params())
    tout = tnet(tmx.nd.array(x))
    assert _err(tout, jout) <= TOL
    # explicit states, returned states, and the gradient under record()
    res = []
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        states = net.begin_state(N)
        with mx.autograd.record():
            out, new_states = net(mx.nd.array(x), states)
            loss = (out * out).sum() + sum((s * s).sum() for s in new_states)
        loss.backward()
        res.append((out, new_states, {
            k: p.grad() for k, p in net.collect_params().items()}))
    (jo, js, jg), (to, ts, tg) = res
    assert _err(to, jo) <= TOL
    assert len(ts) == len(js) == (2 if layer == "LSTM" else 1)
    for t, j in zip(ts, js):
        assert _err(t, j) <= TOL
    for k in jg:
        assert _err(tg[k], jg[k]) <= TOL, k


def _cells(mx, kind, H):
    r = mx.gluon.rnn
    with mx.name.NameManager():
        if kind == "rnn":
            return r.RNNCell(H)
        if kind == "lstm":
            return r.LSTMCell(H)
        if kind == "gru":
            return r.GRUCell(H)
        if kind == "sequential":
            seq = r.SequentialRNNCell()
            seq.add(r.LSTMCell(H))
            seq.add(r.DropoutCell(0.0))
            seq.add(r.ResidualCell(r.GRUCell(H)))
            return seq
        if kind == "zoneout":
            return r.ZoneoutCell(r.LSTMCell(H), zoneout_outputs=0.0,
                                 zoneout_states=0.0)
        if kind == "bidirectional":
            return r.BidirectionalCell(r.LSTMCell(H), r.GRUCell(H))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "zoneout", "bidirectional"])
def test_cell_unroll_matches_jax(kind):
    T, N, C, H = 4, 3, 6, 6
    rs = np.random.RandomState(3)
    x = rs.randn(N, T, C).astype(np.float32)
    valid = np.array([4, 2, 3], np.float32)
    jcell, tcell = _cells(jmx, kind, H), _cells(tmx, kind, H)
    jcell.initialize(jmx.init.Xavier())
    jout = jcell.unroll(T, jmx.nd.array(x), layout="NTC",
                        merge_outputs=True)
    tcell.initialize()
    _cross(jcell, tcell)
    res = []
    for mx, cell in ((jmx, jcell), (tmx, tcell)):
        cell.reset()
        with mx.autograd.train_mode():
            out, states = cell.unroll(T, mx.nd.array(x), layout="NTC",
                                      merge_outputs=True,
                                      valid_length=mx.nd.array(valid))
        res.append((out, states))
    (jo, js), (to, ts) = res
    assert _err(to, jo) <= TOL
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert _err(t, j) <= TOL
    tcell.reset()
    tout = tcell.unroll(T, tmx.nd.array(x), layout="NTC",
                        merge_outputs=True)
    assert _err(tout[0], jout[0]) <= TOL


def test_cells_step_and_modifiers_raise_as_the_reference():
    r = tmx.gluon.rnn
    base = r.LSTMCell(4)
    r.ZoneoutCell(base, 0.5)
    with pytest.raises(AssertionError, match="already modified"):
        r.ResidualCell(base)
    with pytest.raises(AssertionError):
        base.begin_state(2)
    bi = r.BidirectionalCell(r.LSTMCell(4), r.LSTMCell(4))
    with pytest.raises(NotImplementedError, match="unroll"):
        bi(tmx.nd.ones((2, 3)), bi.begin_state(2))
    with pytest.raises(AssertionError, match="zoneout"):
        r.ZoneoutCell(bi)


def test_dropout_masks_keep_their_rate_and_scale(monkeypatch):
    """The streams differ from the reference's, so the masks are held to
    their distribution: inverted dropout keeps 1 - p of the entries, each
    scaled by 1 / (1 - p)."""
    p = 0.3
    tmx.random.seed(0)
    x = tmx.nd.ones((64, 8, 32))
    # the fused layers' inter-layer dropout
    gen = tmx.random.generator(tmx.cpu())
    params = [torch.randn(4 * 32, 32) * 0.1, torch.randn(4 * 32, 32) * 0.1,
              torch.zeros(4 * 32), torch.zeros(4 * 32)]
    layer_params = [[tuple(params)], [tuple(params)]]
    zeros = torch.zeros(2, 8, 32)
    seen = []
    scan = trnn._scan_direction

    def spy(x, *a, **k):
        seen.append(x)
        return scan(x, *a, **k)
    monkeypatch.setattr(trnn, "_scan_direction", spy)
    trnn.rnn_core(torch.ones(64, 8, 32), layer_params, zeros, zeros,
                  "lstm", dropout=p, training=True, generator=gen)
    ys = trnn.rnn_core(torch.ones(64, 8, 32), [[tuple(params)]], zeros[:1],
                       zeros[:1], "lstm")[0]
    dropped = seen[1]                     # the second layer's input
    keep = dropped != 0
    assert abs(keep.float().mean().item() - (1 - p)) < 0.02
    torch.testing.assert_close(dropped[keep], (ys / (1 - p))[keep])
    # DropoutCell and ZoneoutCell under training
    cell = tmx.gluon.rnn.DropoutCell(p)
    with tmx.autograd.train_mode():
        out, _ = cell(x, [])
    kept = out.asnumpy() != 0
    assert abs(kept.mean() - (1 - p)) < 0.02
    np.testing.assert_allclose(out.asnumpy()[kept], 1 / (1 - p), rtol=1e-6)
    zc = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.RNNCell(32), p, p)
    zc.initialize(tmx.init.One())
    xs = tmx.nd.ones((64, 32))
    st = zc.begin_state(64)
    with tmx.autograd.train_mode():
        o, s = zc(xs, st)
    new, _ = zc.base_cell(xs, st)
    o, new = o.asnumpy(), new.asnumpy()
    moved = np.isclose(o, new)
    assert abs(moved.mean() - (1 - p)) < 0.03
    np.testing.assert_array_equal(o[~moved], 0.0)   # the zero prev output


# ------------------------------------------------------------ metrics
def _metric_inputs(rs):
    probs = rs.rand(12, 5).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    labels = rs.randint(0, 5, 12).astype(np.float32)
    binary = rs.randint(0, 2, 12).astype(np.float32)
    reg_l = rs.randn(12).astype(np.float32)
    reg_p = (reg_l + rs.randn(12) * 0.3).astype(np.float32)
    return probs, labels, binary, reg_l, reg_p


METRICS = [
    ("acc", {}, "cls"), ("top_k_accuracy", {"top_k": 3}, "cls"),
    ("f1", {}, "bin"), ("f1", {"average": "micro"}, "bin"),
    ("mcc", {}, "bin"), ("mcc", {"average": "micro"}, "bin"),
    ("perplexity", {}, "cls"), ("perplexity", {"ignore_label": 2}, "cls"),
    ("mae", {}, "reg"), ("mse", {}, "reg"), ("rmse", {}, "reg"),
    ("ce", {}, "cls"), ("nll_loss", {}, "cls"), ("pearsonr", {}, "reg"),
    ("loss", {}, "loss")]


@pytest.mark.parametrize("name,kw,kind", METRICS)
@pytest.mark.parametrize("arrays", [False, True])
def test_metrics_match_jax(name, kw, kind, arrays):
    rs = np.random.RandomState(4)
    batches = [_metric_inputs(rs) for _ in range(3)]
    vals = []
    for mx in (jmx, tmx):
        m = mx.metric.create(name, **kw)
        for probs, labels, binary, reg_l, reg_p in batches:
            label, pred = {
                "cls": (labels, probs),
                "bin": (binary, np.stack([1 - reg_p.clip(0, 1),
                                          reg_p.clip(0, 1)], 1)),
                "reg": (reg_l, reg_p), "loss": (None, reg_p)}[kind]
            wrap = mx.nd.array if arrays else (lambda a: a)
            m.update([None if label is None else wrap(label)], [wrap(pred)])
        vals.append(m.get())
    (jn, jv), (tn, tv) = vals
    assert tn == jn
    assert np.isclose(tv, jv, rtol=1e-5, atol=1e-6), (tv, jv)


def test_metric_registry_composite_and_custom():
    comp = tmx.metric.create(["acc", "perplexity"])
    assert isinstance(comp, tmx.metric.CompositeEvalMetric)
    probs = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)
    comp.update([np.array([0, 0])], [probs])
    names, values = comp.get()
    assert names == ["accuracy", "perplexity"]
    assert values[0] == 0.5
    assert np.isclose(values[1], np.exp(-(np.log(0.9) + np.log(0.2)) / 2))
    cm = tmx.metric.np(lambda l, p: float((l == p.argmax(1)).mean()))
    cm.update([np.array([0, 1])], [probs])
    assert cm.get()[1] == 1.0
    nan = tmx.metric.MAE()
    nan.update([np.array([np.nan])], [np.array([1.0])])
    nan.update([np.array([2.0])], [np.array([1.0])])
    assert nan.get()[1] == 1.0 and nan.num_nan == 1
    assert tmx.metric.create("acc").get_config()["metric"] == "Accuracy"
