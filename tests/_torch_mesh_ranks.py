"""Rank-side bodies of the mesh tests (``test_torch_mesh.py``,
``test_torch_mesh_train.py``). They run inside the ranks of a
``parallel.world.LocalWorld`` and import no JAX, so a rank process loads
torch and the port only. Each takes its rank first and returns plain
numpy values (or None)."""
import numpy as np
import torch

from incubator_mxnet_tpu_torch.parallel import mesh as M

FULL_AXES = M.FULL_AXES


def _t(a, requires_grad=False):
    t = torch.as_tensor(np.asarray(a)).clone()
    return t.requires_grad_(True) if requires_grad else t


def _np(t):
    return t.detach().float().cpu().numpy().copy()


_MESHES = {}


def _mesh(shape, names=None):
    """The mesh of ``shape`` (and axis names) on this world, made once a
    rank process and made current."""
    key = (tuple(shape), tuple(names or FULL_AXES[:len(shape)]))
    if key not in _MESHES:
        _MESHES[key] = M.create_mesh(shape=shape, axis_names=key[1],
                                     backend="gloo", device="cpu")
    M.set_mesh(_MESHES[key])
    return _MESHES[key]


def lm_steps(rank, shape, cfg_kw, np_params, tokens, labels, steps,
             lr=1e-3, aux_weight=1e-2):
    """``steps`` mesh train steps of the LM from whole numpy weights;
    returns (losses, the gathered parameters after step 1) on rank 0."""
    from incubator_mxnet_tpu_torch.models import transformer as tt
    mesh = _mesh(shape)
    cfg = tt.TransformerConfig(**cfg_kw)
    step, _, opt = tt.make_transformer_train_step(
        cfg, mesh=mesh, learning_rate=lr, aux_weight=aux_weight)
    specs = tt.param_specs(cfg)
    params = tt.shard_params(tt.params_from_jax(np_params, cfg,
                                                device="cpu"), specs, mesh)
    tok, lab = torch.as_tensor(tokens), torch.as_tensor(labels)
    losses, first = [], None
    for i in range(steps):
        params, opt, loss = step(params, opt, tok, lab)
        losses.append(float(loss))
        if i == 0:
            first = tt.gather_params(params, specs, mesh)
    if rank:
        return losses
    return losses, tt._tree_map(_np, first)


def gpipe_toy(rank, n, stacked, x):
    """The reference's test_gpipe_matches_sequential body: tanh stages."""
    from incubator_mxnet_tpu_torch.parallel.pipeline import gpipe
    mesh = _mesh((n,), ("pipe",))

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def loss(w, b, xx):
        out = gpipe(stage_fn, {"w": w, "b": b}, xx, n_micro=n, mesh=mesh)
        return (out ** 2).sum(), out

    ws = [_t(stacked["w"], True), _t(stacked["b"], True), _t(x, True)]
    val, out = loss(*ws)
    gs = torch.autograd.grad(val, ws)
    return _np(out), [_np(g) for g in gs]


def _resnet50(np_params, hw):
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
    with tmx.cpu():
        net = resnet50_v1(layout="NHWC")
        net.initialize()
        net(tmx.nd.array(np.zeros((1, 3, hw, hw), np.float32)))
        params_from_jax(net, np_params)
    return net


def resnet_step(rank, shape, np_params, x, y, lr=0.05, momentum=0.9,
                steps=1):
    """``steps`` ResNet-50 SGD steps over a (data, fsdp) mesh with every
    parameter and momentum split on dim 0 over fsdp; rank 0 returns (the
    losses, the gathered parameters and the BN running statistics after
    the first step)."""
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.parallel import dp
    from incubator_mxnet_tpu_torch.parallel.mesh import P
    mesh = _mesh(shape, ("data", "fsdp"))
    net = _resnet50(np_params, x.shape[-1])
    step, p, aux, st = dp.make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=lr, momentum=momentum, mesh=mesh, data_axes=("data",),
        param_spec=P("fsdp"))
    losses = []
    for i in range(steps):
        p, aux, st, loss = step(p, aux, st, torch.as_tensor(x),
                                torch.as_tensor(y))
        losses.append(float(loss))
        if i == 0:
            whole = {n: M._gather_blocks(v, P("fsdp"), mesh)
                     for n, v in p.items()}
            first = (by_structure(net, whole), by_structure(net, aux))
    return losses if rank else (losses,) + first


def by_structure(net, values):
    """{parameter name: tensor} -> {structural name: numpy array} (the
    names of ``_collect_params_with_prefix``, the same in every process)."""
    return {k: _np(values[p.name])
            for k, p in net._collect_params_with_prefix().items()
            if p.name in values}


def mesh_layout(rank, shape, names):
    """Coordinates, blocks and groups of a mesh, as plain values."""
    mesh = _mesh(shape, names)
    x = torch.arange(int(np.prod([8, 4]))).reshape(8, 4)
    out = {"coords": mesh.coords, "rank": mesh.rank,
           "block": M.shard(x, M.P(names[0], names[1]), mesh).tolist(),
           "rows": M.shard(x, M.P((names[0], names[1])), mesh).tolist(),
           "data_spec": M.data_sharding(8, mesh),
           "uneven": M.data_sharding(3, mesh),
           "group": {a: mesh.group(a)[1] for a in names},
           "replicate": M.replicate(x, mesh).tolist(),
           "remesh": M.remesh(range(mesh.size), like=mesh).shape}
    return out


def attention(rank, kind, shape, names, q, k, v, causal, axis="seq"):
    """Global (B, T, H, D) q, k, v through ``kind`` ("ring", "ring_flash",
    "ulysses") on a mesh; returns (out, dq, dk, dv) of sum(out ** 2)."""
    from incubator_mxnet_tpu_torch.parallel import ring_attention as ra
    from incubator_mxnet_tpu_torch.parallel import ulysses as ul
    mesh = _mesh(shape, names)
    fn = {"ring": ra.ring_attention_sharded,
          "ring_flash": ra.ring_flash_attention_sharded,
          "ulysses": ul.ulysses_attention_sharded}[kind]
    ts = [_t(a, True) for a in (q, k, v)]
    out = fn(*ts, mesh=mesh, axis_name=axis, causal=causal)
    gs = torch.autograd.grad((out ** 2).sum(), ts)
    return [_np(out)] + [_np(g) for g in gs]


def ulysses_heads(rank, shape, names, q):
    from incubator_mxnet_tpu_torch.parallel import ulysses as ul
    mesh = _mesh(shape, names)
    try:
        ul.ulysses_attention_sharded(_t(q), _t(q), _t(q), mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def moe(rank, shape, x, gw, w1, b1, w2, b2, cf):
    """moe_layer_sharded: (y, aux, d(mean(y^2) + 0.01 aux)/d(x, w1))."""
    from incubator_mxnet_tpu_torch.parallel import moe as tm
    mesh = _mesh(shape)
    xs, w1s = _t(x, True), _t(w1, True)
    y, aux = tm.moe_layer_sharded(xs, _t(gw), w1s, _t(b1), _t(w2), _t(b2),
                                  mesh=mesh, capacity_factor=cf)
    gx, gw1 = torch.autograd.grad((y ** 2).mean() + 0.01 * aux, [xs, w1s])
    return _np(y), float(aux), _np(gx), _np(gw1)


def collective_grad(rank, op, n, x, w):
    """x (global) through shard_map(op over "seq") on a ("seq",) mesh of
    n; returns (out, d sum(out * w) / dx) on every rank."""
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    mesh = _mesh((n,), ("seq",))
    body = {
        "psum": (lambda a: C.psum(a, "seq"), M.P()),
        "pmean": (lambda a: C.pmean(a, "seq"), M.P()),
        "all_gather": (lambda a: C.all_gather(a, "seq", 0), M.P()),
        "all_gather_1": (lambda a: C.all_gather(a, "seq", 1), M.P()),
        "all_gather_stack": (lambda a: C.all_gather(a, "seq", 0,
                                                    tiled=False), M.P()),
        "reduce_scatter": (lambda a: C.reduce_scatter(a, "seq", 0),
                           M.P("seq")),
        "ppermute": (lambda a: C.ppermute(
            a, "seq", [(i, (i + 1) % n) for i in range(n)]), M.P("seq")),
        "ppermute_partial": (lambda a: C.ppermute(
            a, "seq", [(i, i + 1) for i in range(n - 1)]), M.P("seq")),
        "all_to_all": (lambda a: C.all_to_all(a, "seq", 1, 0),
                       M.P("seq")),
    }
    fn, out_spec = body[op]
    xs = _t(x, True)
    out = M.shard_map(lambda a: fn(a.tanh()), mesh, (M.P("seq"),),
                      out_spec)(xs)
    (g,) = torch.autograd.grad((out * _t(w)).sum(), [xs])
    return _np(out), _np(g)


def _ln(a, g, b):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    return (a - mu) / torch.sqrt(var + 1e-5) * g + b


def block_fn(p, a, n_heads):
    """The dry run's pipeline stage: a pre-LN causal attention block with
    a GELU MLP, (mb, T, d) -> (mb, T, d)."""
    mb, T, d = a.shape
    hd = d // n_heads
    h = _ln(a, p["ln1_g"], p["ln1_b"])
    q, k, v = ((h @ p[w]).reshape(mb, T, n_heads, hd)
               for w in ("wq", "wk", "wv"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    a = a + ctx.reshape(mb, T, d) @ p["wo"]
    h = _ln(a, p["ln2_g"], p["ln2_b"])
    return a + torch.nn.functional.gelu(h @ p["w1"] + p["b1"],
                                        approximate="tanh") @ p["w2"] \
        + p["b2"]


def pipe_transformer(rank, n, stacked, x, y, n_heads, lr=0.1):
    """gpipe over ``n`` transformer stages against the same stacked
    parameters applied in sequence: (pipeline loss, its grads, sequential
    loss, its grads, the pipeline loss after one SGD step)."""
    from incubator_mxnet_tpu_torch.parallel.pipeline import gpipe
    mesh = _mesh((n,), ("pipe",))
    xs, ys = _t(x), _t(y)
    names = sorted(stacked)

    def fn(p, a):
        return block_fn(p, a, n_heads)

    def pipe_loss(ws):
        out = gpipe(fn, dict(zip(names, ws)), xs, n, mesh=mesh)
        return ((out - ys) ** 2).mean()

    def seq_loss(ws):
        a = xs
        for i in range(n):
            a = fn({k: w[i] for k, w in zip(names, ws)}, a)
        return ((a - ys) ** 2).mean()

    out = []
    for loss_fn in (pipe_loss, seq_loss):
        ws = [_t(stacked[k], True) for k in names]
        val = loss_fn(ws)
        gs = torch.autograd.grad(val, ws)
        out += [float(val), {k: _np(g) for k, g in zip(names, gs)}]
    ws = [_t(stacked[k]) - lr * _t(out[1][k]) for k in names]
    out.append(float(pipe_loss(ws)))
    return out


def _mlp(np_params, hidden, n_out, din):
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
    with tmx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(hidden, activation="relu"), nn.Dense(n_out))
        net.initialize()
        net(tmx.nd.array(np.zeros((1, din), np.float32)))
        params_from_jax(net, np_params)
    return net


def mlp_unroll(rank, shape, np_params, X, Y, lr=0.1):
    """make_train_step(unroll_steps=2) on a data mesh against two mesh
    steps one at a time; rank 0 returns (unrolled params, stepped
    params, the unrolled loss, the two single losses)."""
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.parallel import dp
    mesh = _mesh(shape, ("data",))
    out = []
    for unroll in (2, 1):
        net = _mlp(np_params, 8, 3, X.shape[-1])
        step, p, aux, st = dp.make_train_step(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            learning_rate=lr, mesh=mesh, unroll_steps=unroll)
        if unroll == 2:
            p, aux, st, loss = step(p, aux, st, _t(X), _t(Y))
            losses = float(loss)
        else:
            losses = []
            for i in range(2):
                p, aux, st, loss = step(p, aux, st, _t(X[i]), _t(Y[i]))
                losses.append(float(loss))
        out += [by_structure(net, p), losses]
    return out if rank == 0 else None


def dp_trainer(rank, np_params, x, y, steps, lr=0.1):
    """DataParallelTrainer on create_mesh(MeshConfig(data=-1)): the losses
    and the net's parameters after ``sync_to_net``."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.parallel.dp import DataParallelTrainer
    if ("dp_trainer",) not in _MESHES:
        _MESHES[("dp_trainer",)] = M.create_mesh(
            M.MeshConfig(data=-1), backend="gloo", device="cpu")
    M.set_mesh(_MESHES[("dp_trainer",)])
    net = _mlp(np_params, 16, 4, x.shape[-1])
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": lr})
    with tmx.cpu():
        xs, ys = tmx.nd.array(x), tmx.nd.array(y)
        losses = [float(tr.step(xs, ys).asscalar()) for _ in range(steps)]
        tr.sync_to_net()
        params = {k: p.data().asnumpy() for k, p in
                  net._collect_params_with_prefix().items()}
    M.set_mesh(None)
    return losses, params


def sync_bn(rank, shape, x, w):
    """SyncBatchNorm over the data axis on this rank's block of x: (y
    block, moving mean, moving var, d sum(y * w) / dx block)."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon.contrib import nn as cnn
    mesh = _mesh(shape, ("data", "seq"))
    blk = M.shard(torch.as_tensor(x), M.P("data"), mesh).numpy()
    wb = M.shard(torch.as_tensor(w), M.P("data"), mesh).numpy()
    with tmx.cpu():
        bn = cnn.SyncBatchNorm(in_channels=x.shape[1])
        bn.initialize()
        xs = tmx.nd.array(blk)
        xs.attach_grad()
        with autograd.record():
            y = bn(xs)
            loss = (y * tmx.nd.array(wb)).sum()
        loss.backward()
        return (y.asnumpy(), bn.running_mean.data().asnumpy(),
                bn.running_var.data().asnumpy(), xs.grad.asnumpy())


def prefetch(rank, shape, xs, ys, batch):
    """A DevicePrefetcher over an NDArrayIter on a data mesh: each rank's
    batches, and device_transfer's block of the first one."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import io as tio
    _mesh(shape, ("data", "seq"))
    got = []
    with tmx.cpu():
        it = tio.NDArrayIter(xs, ys, batch_size=batch)
        with tio.DevicePrefetcher(it) as pf:
            for b in pf:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        one = tio.device_transfer(xs[:batch]).asnumpy()
        whole = tio.device_transfer(xs[:batch], sharded=False).asnumpy()
        uneven = tio.device_transfer(xs[:3]).asnumpy()
    return got, one, whole, uneven


def megatron_mlp(rank, shape, x, w1, b1, w2, b2):
    """tp.ColumnParallelDense(relu) then tp.RowParallelDense over the
    tensor axis, each rank holding its slice of the whole weights: (y,
    dx, the column weight's grad, the row weight's grad, the row bias's
    grad) of sum(y ** 2)."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.parallel import tp
    mesh = _mesh(shape, ("data", "tensor"))
    t = mesh.coords["tensor"]
    h = w1.shape[0] // mesh.shape["tensor"]
    with tmx.cpu():
        col = tp.ColumnParallelDense(w1.shape[0], activation="relu",
                                     in_units=w1.shape[1])
        row = tp.RowParallelDense(w2.shape[0], in_units=w2.shape[1])
        col.initialize()
        row.initialize()
        col.weight.set_data(tmx.nd.array(w1[t * h:(t + 1) * h]))
        col.bias.set_data(tmx.nd.array(b1[t * h:(t + 1) * h]))
        row.weight.set_data(tmx.nd.array(w2[:, t * h:(t + 1) * h]))
        row.bias.set_data(tmx.nd.array(b2))
        xs = tmx.nd.array(x)
        xs.attach_grad()
        with autograd.record():
            y = row(col(xs))
            loss = (y * y).sum()
        loss.backward()
        return (y.asnumpy(), xs.grad.asnumpy(), col.weight.grad().asnumpy(),
                row.weight.grad().asnumpy(), row.bias.grad().asnumpy())
