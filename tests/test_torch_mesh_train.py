"""The mesh train steps of the port (``models/transformer.py`` and
``parallel/dp.py`` on a mesh) and the pieces around them, against the
JAX package and the port's own single-device steps, on the CPU.

The five paths of ``__graft_entry__.dryrun_multichip`` run at small size
in one gloo world of 8 CPU processes (``parallel.world.LocalWorld``, one
torch thread a rank, a ``FileStore`` in a temporary directory, every call
under its own timeout), each on the JAX mesh shape of 8 devices:

* ``dp-tp-sp``: the LM of ``test_parallel.py::test_transformer_train_
  step_5d`` (vocab 32, d 16, 2 heads, 2 layers, 2 experts) on (data 2,
  tensor 2, seq 2), ring attention over seq;
* ``dp-tp-ulysses``: the same mesh with Ulysses (4 heads, d 32: the port
  splits heads over tensor before seq, so heads / tensor must divide by
  seq);
* ``dp-fsdp-ep``: (data 2, fsdp 2, expert 2) with the MoE layer split over
  expert;
* ``resnet50-dp-fsdp``: ResNet-50 (NHWC) at 32 x 32, batch 8, on (data 4,
  fsdp 2) with every parameter split on dim 0 over fsdp;
* ``pipe-transformer``: gpipe over 8 pre-LN transformer stages (d 32, 4
  heads, T 8, 8 microbatches of 2).

Weights cross as numpy arrays: the JAX step's initial parameters go to
every rank (``shard_params``) and to the port's single-device step; a
rank's updated parameters are gathered whole (``gather_params``). The JAX
side runs under ``jax.default_matmul_precision("highest")``.

Tolerances: the LM paths' first-step loss rtol 1e-5 and parameters atol
1e-5 (Adam's first step moves each weight by about lr = 1e-3, so this
holds the gradient's sign everywhere it is not float noise); for
``dp-fsdp-ep`` the single-device step is compared at capacity factor 2
(no token dropped: routing each expert index's chunk and routing the whole
batch are then the same function; at the reference's 1.25 they drop
different tokens), and with the balancing loss left out (the mesh takes
the mean of each chunk's, the reference's rule, which is not the whole
batch's). ResNet-50: loss rtol 1e-4, running statistics atol 1e-3, the
SGD update within three times the port's own single-device spread from
JAX (the test's docstring says why), the pre-BN conv biases within
1e-5. The pipeline against the sequential run at the dry run's own
tolerances (loss 1e-5 + 1e-4 relative, gradients rtol 5e-4 / atol 1e-6)
and against the JAX gpipe at 1e-5. The LM paths' loss falls over 3
steps; ResNet-50's and the pipeline's after one step.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet50_v1
from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu.parallel.pipeline import gpipe as jgpipe
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import context as tctx
from incubator_mxnet_tpu_torch.models import transformer as tt
from incubator_mxnet_tpu_torch.parallel import dp as tdp

import _torch_mesh_ranks as R
from test_torch_mesh import FULL, _World

LM = dict(vocab_size=32, d_model=16, n_heads=2, d_ff=32, n_layers=2,
          max_len=32, n_experts=2, use_ring_attention=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(8, tmp_path_factory.mktemp("mesh_train_world"))
    yield w
    w.close()


def _jmesh(shape, names=FULL):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 32, (4, 16)).astype(np.int32),
            rng.integers(0, 32, (4, 16)).astype(np.int32))


def _jax_lm(shape, kw):
    """(the JAX mesh step, its parameters and Adam state, the parameters
    as numpy arrays)."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    step, params, opt = jt.make_transformer_train_step(cfg,
                                                       mesh=_jmesh(shape))
    return step, params, opt, _np_tree(params)


def _jax_lm_step(step, params, opt, tok, lab):
    with jax.default_matmul_precision("highest"):
        p1, _, loss = step(params, opt, jnp.asarray(tok), jnp.asarray(lab))
    return _np_tree(p1), float(loss)


def _single_lm(kw, p0, tok, lab, aux_weight=1e-2):
    cfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    step, _, opt = tt.make_transformer_train_step(cfg, device="cpu",
                                                  aux_weight=aux_weight)
    p1, _, loss = step(tt.params_from_jax(p0, cfg, device="cpu"), opt,
                       torch.as_tensor(tok), torch.as_tensor(lab))
    return tt._tree_map(lambda t: t.numpy(), p1), float(loss)


def _assert_lm_close(got, want, atol=1e-5):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("path,shape,extra", [
    ("dp-tp-sp", (2, 1, 2, 1, 1, 2), {}),
    ("dp-tp-ulysses", (2, 1, 2, 1, 1, 2),
     dict(d_model=32, n_heads=4, sequence_parallel_mode="ulysses")),
    ("dp-fsdp-ep", (2, 2, 1, 1, 2, 1), {}),
])
def test_lm_mesh_step_matches_jax_and_single_device(world, path, shape,
                                                    extra):
    kw = dict(LM, **extra)
    tok, lab = _lm_batch()
    jstep, jparams, jopt, p0 = _jax_lm(shape, kw)
    world.start(R.lm_steps, shape, kw, p0, tok, lab, 3)
    jp1, jloss = _jax_lm_step(jstep, jparams, jopt, tok, lab)
    res = world.wait()
    losses, gathered = res[0]
    assert all(r == losses for r in res[1:])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], jloss, rtol=1e-5)
    _assert_lm_close(gathered, jp1)
    aux_weight = 1e-2
    if shape[4] > 1:
        # no token dropped and no balancing loss (a mean over the expert
        # chunks of each chunk's, as in the reference): routing each
        # chunk and routing the whole batch are then the same function
        kw = dict(kw, capacity_factor=float(kw["n_experts"]))
        aux_weight = 0.0
        (losses, gathered), *_ = world.run(R.lm_steps, shape, kw, p0, tok,
                                           lab, 1, 1e-3, aux_weight)
    sp1, sloss = _single_lm(kw, p0, tok, lab, aux_weight)
    np.testing.assert_allclose(losses[0], sloss, rtol=1e-5)
    _assert_lm_close(gathered, sp1)


@pytest.fixture(scope="module")
def resnet_case():
    rng = np.random.default_rng(0)
    x = rng.random((8, 3, 32, 32), np.float32)
    y = rng.integers(0, 1000, (8,)).astype(np.int32)
    net = resnet50_v1(layout="NHWC")
    net.initialize()
    net(jmx.nd.array(x[:1]))
    names = {k: p.name for k, p in net._collect_params_with_prefix().items()}
    p0 = {k: np.asarray(net.collect_params()[n].data().asnumpy())
          for k, n in names.items()}

    def jax_step():
        with jax.default_matmul_precision("highest"):
            step, p, a, s = jdp.make_train_step(
                net, jgluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                learning_rate=0.05, momentum=0.9, mesh=_jmesh((4, 2), (
                    "data", "fsdp")), data_axes=("data",),
                param_spec=JP("fsdp"))
            p, a, _, loss = step(p, a, s, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0),
                                 jnp.asarray(0.05, jnp.float32))
        p, a = _np_tree(p), _np_tree(a)
        return ({k: p[n] for k, n in names.items() if n in p},
                {k: a[n] for k, n in names.items() if n in a}, float(loss))

    return x, y, p0, jax_step


def _pre_bn_bias(k, p0):
    """A conv's bias (a BatchNorm follows every conv of ResNet v1): its
    gradient is float noise on both sides."""
    w = k[:-len("bias")] + "weight"
    return k.endswith("bias") and w in p0 and p0[w].ndim == 4


def _update_spread(got, want, p0):
    """(relative L2 of the whole update got - want, the largest leaf's),
    over every parameter but the pre-BN conv biases."""
    keys = [k for k in want if not _pre_bn_bias(k, p0)]
    d = {k: (p0[k] - got[k]) - (p0[k] - want[k]) for k in keys}
    u = {k: p0[k] - want[k] for k in keys}
    whole = (sum(float(np.sum(d[k] ** 2)) for k in keys)
             / sum(float(np.sum(u[k] ** 2)) for k in keys)) ** 0.5
    leaf = max(float(np.linalg.norm(d[k]) / max(np.linalg.norm(u[k]), 1e-12))
               for k in keys)
    return whole, leaf


def test_resnet50_dp_fsdp_matches_jax_and_single_device(world, resnet_case):
    """ResNet-50 at 32 x 32 is chaotic in float32 (BatchNorm over 8
    values a channel in the last stage): any two summation orders move the
    first SGD step's update by a few percent. So the update is held to
    three times the spread between the port's single-device step and the
    JAX mesh step measured here (about 2% whole-net; a wrong gradient
    scale or an unsynchronised BatchNorm is off by 50% or more), the
    pre-BN conv biases within 1e-5, and the loss and the running
    statistics, which are not chaotic, tightly."""
    x, y, p0, jax_step = resnet_case
    world.start(R.resnet_step, (4, 2), p0, x, y, 0.05, 0.9, 2, timeout=300)
    jp, ja, jloss = jax_step()
    with tmx.cpu():
        net = R._resnet50(p0, 32)
        step, p, a, s = tdp.make_train_step(
            net, tgluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            learning_rate=0.05, momentum=0.9)
        p, a, _, sloss = step(p, a, s, torch.as_tensor(x),
                              torch.as_tensor(y))
        single = R.by_structure(net, p)
    spread = _update_spread(single, jp, p0)
    res = world.wait()
    losses, whole, aux = res[0]
    assert all(r == losses for r in res[1:])
    # one step on the fixed batch lowers its loss (at lr 0.05 and momentum
    # 0.9 later steps overshoot on this random net, as the reference's)
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    loss = losses[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(loss, float(sloss), rtol=1e-4)
    for k, w in ja.items():
        np.testing.assert_allclose(aux[k], w, rtol=0, atol=1e-3, err_msg=k)
    for want in (jp, single):
        got = _update_spread(whole, want, p0)
        assert got[0] <= 3 * spread[0] and got[1] <= 3 * spread[1], \
            (got, spread)
        for k in want:
            if _pre_bn_bias(k, p0):
                np.testing.assert_allclose(whole[k], want[k], rtol=0,
                                           atol=1e-5, err_msg=k)


def _pipe_case(n=8, d=32, heads=4, T=8):
    k = jax.random.split(jax.random.PRNGKey(0), 9)

    def w(key, shape):
        return np.asarray(jax.random.normal(key, (n,) + shape) * 0.05)

    st = {"ln1_g": np.ones((n, d), np.float32),
          "ln1_b": np.zeros((n, d), np.float32),
          "wq": w(k[0], (d, d)), "wk": w(k[1], (d, d)),
          "wv": w(k[2], (d, d)), "wo": w(k[3], (d, d)),
          "ln2_g": np.ones((n, d), np.float32),
          "ln2_b": np.zeros((n, d), np.float32),
          "w1": w(k[4], (d, 2 * d)), "b1": np.zeros((n, 2 * d), np.float32),
          "w2": w(k[5], (2 * d, d)), "b2": np.zeros((n, d), np.float32)}
    x = np.asarray(jax.random.normal(k[6], (2 * n, T, d)) * 0.5)
    y = np.asarray(jax.random.normal(k[7], (2 * n, T, d)) * 0.5)
    return st, x, y


def _jax_block(p, a, n_heads):
    mb, T, d = a.shape
    hd = d // n_heads

    def ln(a, g, b):
        mu = a.mean(-1, keepdims=True)
        var = ((a - mu) ** 2).mean(-1, keepdims=True)
        return (a - mu) / jnp.sqrt(var + 1e-5) * g + b

    h = ln(a, p["ln1_g"], p["ln1_b"])
    q, k_, v = ((h @ p[w]).reshape(mb, T, n_heads, hd)
                for w in ("wq", "wk", "wv"))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k_) / np.sqrt(hd)
    s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)
    a = a + ctx.reshape(mb, T, d) @ p["wo"]
    h = ln(a, p["ln2_g"], p["ln2_b"])
    return a + jax.nn.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def test_pipe_transformer_matches_sequential_and_jax(world):
    n, heads = 8, 4
    st, x, y = _pipe_case(n, heads=heads)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("pipe",))

    def loss(sp):
        out = jgpipe(lambda p, a: _jax_block(p, a, heads), sp, x, n,
                     mesh=mesh)
        return jnp.mean((out - y) ** 2)

    world.start(R.pipe_transformer, n, st, x, y, heads)
    with jax.default_matmul_precision("highest"):
        jl, jg = jax.jit(jax.value_and_grad(loss))(st)
    for pl, pg, sl, sg, post in world.wait():
        assert np.isfinite(pl) and abs(pl - sl) <= 1e-5 + 1e-4 * abs(sl)
        for k in st:
            np.testing.assert_allclose(pg[k], sg[k], rtol=5e-4, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(pg[k], np.asarray(jg[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
        assert post < pl


def _mlp_params(hidden, n_out, din, seed=0):
    rs = np.random.RandomState(seed)
    return {"0.weight": (rs.randn(hidden, din) * 0.3).astype(np.float32),
            "0.bias": np.zeros(hidden, np.float32),
            "1.weight": (rs.randn(n_out, hidden) * 0.3).astype(np.float32),
            "1.bias": np.zeros(n_out, np.float32)}


def test_train_step_unroll_on_mesh(world):
    rs = np.random.RandomState(1)
    X = rs.rand(2, 16, 8).astype(np.float32)
    Y = rs.randint(0, 3, (2, 16)).astype(np.int32)
    p0 = _mlp_params(8, 3, 8)
    res = world.run(R.mlp_unroll, (8,), p0, X, Y)
    p_unrolled, loss, p_stepped, losses = res[0]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-6)
    for k in p_stepped:
        np.testing.assert_allclose(p_unrolled[k], p_stepped[k], rtol=1e-6,
                                   atol=1e-7)
    # two single-device steps from the same weights
    with tmx.cpu():
        net = R._mlp(p0, 8, 3, 8)
        step, p, a, s = tdp.make_train_step(
            net, tgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            learning_rate=0.1)
        for i in range(2):
            p, a, s, _ = step(p, a, s, torch.as_tensor(X[i]),
                              torch.as_tensor(Y[i]))
        single = R.by_structure(net, p)
    for k in single:
        np.testing.assert_allclose(p_unrolled[k], single[k], rtol=1e-5,
                                   atol=1e-6)


def test_data_parallel_trainer_on_the_mesh(world):
    rs = np.random.RandomState(2)
    x = rs.rand(8, 8).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.float32)
    p0 = _mlp_params(16, 4, 8, seed=3)
    res = world.run(R.dp_trainer, p0, x, y, 6)
    losses, params = res[0]
    assert all(r[0] == losses for r in res)
    assert losses[-1] < losses[0]
    with tmx.cpu():
        net = R._mlp(p0, 16, 4, 8)
        tr = tdp.DataParallelTrainer(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                                     "sgd", {"learning_rate": 0.1})
        xs, ys = tmx.nd.array(x), tmx.nd.array(y)
        single = [float(tr.step(xs, ys).asscalar()) for _ in range(6)]
        tr.sync_to_net()
        sp = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    np.testing.assert_allclose(losses, single, rtol=1e-5)
    for k in sp:
        np.testing.assert_allclose(params[k], sp[k], rtol=1e-5, atol=1e-6)


def test_sync_batch_norm_across_ranks_is_one_rank_on_the_whole_batch(world):
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon.contrib import nn as cnn
    rs = np.random.RandomState(4)
    x = rs.randn(8, 3, 4, 4).astype(np.float32) * 2 + 1
    w = rs.randn(8, 3, 4, 4).astype(np.float32)
    with tmx.cpu():
        bn = cnn.SyncBatchNorm(in_channels=3)
        bn.initialize()
        xs = tmx.nd.array(x)
        xs.attach_grad()
        with autograd.record():
            yv = bn(xs)
            loss = (yv * tmx.nd.array(w)).sum()
        loss.backward()
        want = (yv.asnumpy(), bn.running_mean.data().asnumpy(),
                bn.running_var.data().asnumpy(), xs.grad.asnumpy())
    for r, (y, mm, mv, gx) in enumerate(world.run(R.sync_bn, (2, 4), x, w)):
        d = r // 4
        np.testing.assert_allclose(y, want[0][4 * d:4 * d + 4], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(mm, want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mv, want[2], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gx, want[3][4 * d:4 * d + 4], rtol=1e-4,
                                   atol=1e-5)


def test_sharded_device_prefetcher(world):
    rs = np.random.RandomState(5)
    xs = rs.rand(16, 3).astype(np.float32)
    ys = np.arange(16).astype(np.float32)
    for r, (got, one, whole, uneven) in enumerate(
            world.run(R.prefetch, (4, 2), xs, ys, 8)):
        d = r // 2
        assert len(got) == 2
        for b, (bx, by) in enumerate(got):
            rows = slice(8 * b + 2 * d, 8 * b + 2 * d + 2)
            np.testing.assert_array_equal(bx, xs[rows])
            np.testing.assert_array_equal(by, ys[rows])
        np.testing.assert_array_equal(one, xs[2 * d:2 * d + 2])
        np.testing.assert_array_equal(whole, xs[:8])
        np.testing.assert_array_equal(uneven, xs[:3])


def test_context_names_this_process_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tctx.local_devices() == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert tmx.gpu(1).torch_device == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tctx.local_devices() == [torch.device("cuda", 1)]
    assert tmx.gpu(0).torch_device == torch.device("cuda", 1)
    assert tmx.Context.from_torch(torch.device("cuda", 1)) == tmx.gpu(0)
    with pytest.raises(ValueError, match="local device"):
        tmx.gpu(1).torch_device
    assert tmx.cpu(0).torch_device == torch.device("cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_runs_a_script_as_a_world(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent(f"""
        import os, torch
        from incubator_mxnet_tpu_torch.parallel import collectives as C
        from incubator_mxnet_tpu_torch.parallel import mesh as M
        M.create_mesh(M.MeshConfig(data=-1), backend="gloo", device="cpu")
        rank = int(os.environ["MXTPU_WORKER_RANK"])
        s = C.psum(torch.tensor([float(rank + 1)]), "data")
        open(os.path.join({str(tmp_path)!r}, f"out{{rank}}"), "w").write(
            f"{{os.environ['MXTPU_NUM_WORKERS']}} {{int(s.item())}}")
    """))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-m",
                    "incubator_mxnet_tpu_torch.tools.launch", "-n", "2",
                    "--coordinator", f"127.0.0.1:{_free_port()}",
                    sys.executable, str(script)], env=env, check=True,
                   timeout=120)
    for r in range(2):
        assert (tmp_path / f"out{r}").read_text() == "2 3"
