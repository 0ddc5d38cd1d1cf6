"""Rank-side bodies of the sharded-embedding and store tests
(``test_torch_sharded_embedding.py``, ``test_torch_kvstore.py``). They run
inside the ranks of a ``parallel.world.LocalWorld`` on the CPU and import
no JAX. Each takes its rank first and returns plain numpy values (or
None)."""
import os

import numpy as np
import torch

from incubator_mxnet_tpu_torch.parallel import mesh as M

_MESHES = {}


def _mesh(n):
    """The one-axis ('data',) mesh over the world's ranks, made once a rank
    process and made current."""
    if n not in _MESHES:
        _MESHES[n] = M.create_mesh(shape=(n,), axis_names=("data",),
                                   backend="gloo", device="cpu")
    M.set_mesh(_MESHES[n])
    return _MESHES[n]


def _local_rows(table, n, rank):
    rps = -(-table.shape[0] // n)
    out = np.zeros((rps,) + table.shape[1:], table.dtype)
    part = table[rank * rps:(rank + 1) * rps]
    out[:len(part)] = part
    return torch.as_tensor(out)


def _block(x, n, rank):
    b = x.shape[0] // n
    return torch.as_tensor(np.ascontiguousarray(x[rank * b:(rank + 1) * b]))


def shard_gather(rank, table, ids, dedup=True):
    """``_shard_gather`` on this rank's rows of ``table`` and block of
    ``ids``: (rows of the block, ids, unique ids)."""
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    n = torch.distributed.get_world_size()
    mesh = _mesh(n)
    out, tot, cnt = E._shard_gather(_local_rows(table, n, rank),
                                    _block(ids, n, rank), "data", n, dedup,
                                    mesh)
    return out.numpy(), int(tot[0]), int(cnt[0])


def eager_forward(rank, rows, dim, ids, key):
    """A ``ShardedEmbedding`` born sharded on the mesh
    (``initialize_table``), looked up eagerly with the same ``ids`` on
    every rank: its rows and its shard's shape."""
    import incubator_mxnet_tpu_torch as mx
    n = torch.distributed.get_world_size()
    _mesh(n)
    with mx.cpu(), mx.name.NameManager():
        se = mx.gluon.nn.ShardedEmbedding(rows, dim)
        w = se.initialize_table(key=key)
        out = se(mx.nd.array(ids))
    return out.asnumpy(), w.shape


def shard_update_sgd(rank, table, ids, gout, lr, hoist):
    """One routed row update by SGD at ``lr`` (``_shard_update``, or the
    gather's plan through ``_shard_update_hoisted``); this rank's rows
    after it."""
    from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    from incubator_mxnet_tpu_torch.optimizer import optimizer as O
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    n = torch.distributed.get_world_size()
    mesh = _mesh(n)
    t = _local_rows(table, n, rank)
    opt = O.SGD(learning_rate=lr)
    opt._update_count(0)
    h = opt.fused_hypers(0)

    def update(w, st, row_ids, g_rows):
        mt.update_rows("sgd", opt.tensor_step, w, st, row_ids, g_rows, h,
                       opt.multi_tensor_hypers(h))
    ids_l, g_l = _block(ids, n, rank), _block(gout, n, rank)
    if hoist:
        res = E._shard_gather(t, ids_l, "data", n, True, mesh,
                              with_plan=True)
        E._shard_update_hoisted(t, None, g_l, update, *res[3:], "data", n,
                                mesh)
    else:
        E._shard_update(t, None, ids_l, g_l, update, "data", n, True, mesh)
    return t.numpy()


def _build(kind, arrays, cfg):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
    from incubator_mxnet_tpu_torch.models import sparse_recommenders as sr
    with mx.cpu(), mx.name.NameManager():
        net = (sr.DLRM(**cfg) if kind == "dlrm"
               else sr.ShardedFactorizationMachine(**cfg))
        net.initialize()
        params_from_jax(net, arrays)
    return net


def train_steps(rank, kind, arrays, cfg, inputs, y, opt, opt_params, steps,
                hoist=True, lrs=None):
    """``steps`` of ``make_sharded_train_step`` on the ('data',) mesh of
    the world from the numpy parameters ``arrays`` (structural names).
    Returns on every rank (losses, the gathered logical tables and the dense
    parameters by structural name, sorts and route recomputes a step, the
    sort gauge, the update routes (rows and tower), step builds, densifies,
    the last step's dedup ratio)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, telemetry as tel
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    n = torch.distributed.get_world_size()
    mesh = _mesh(n)
    os.environ["MXTPU_EMBED_HOIST"] = "1" if hoist else "0"
    try:
        net = _build(kind, arrays, cfg)
        names = {p.name: k for k, p in
                 net._collect_params_with_prefix().items()}
        c0 = tel.gauge("sharded_step_compiles").value()
        step, state = E.make_sharded_train_step(
            net, gluon.loss.SigmoidBinaryCrossEntropyLoss(), optimizer=opt,
            optimizer_params=opt_params, mesh=mesh)
        s0 = tel.counter(E.SORTS_COUNTER).value()
        r0 = tel.counter(E.ROUTE_RECOMPUTE_COUNTER).value()
        d0 = tel.counter(E.DENSIFY_COUNTER).value()
        xs = [torch.as_tensor(x) for x in inputs]
        losses, stats = [], None
        for i in range(steps):
            if lrs is not None:
                step.optimizer.set_learning_rate(lrs[i])
            state, loss, stats = step(state, *xs, torch.as_tensor(y))
            losses.append(float(loss))
        out = {
            "losses": losses,
            "tables": {names[t]: state.table(t).numpy()
                       for t in state.tables},
            "dense": {names[d]: v.detach().numpy()
                      for d, v in state.dense.items()},
            "sorts": (tel.counter(E.SORTS_COUNTER).value() - s0) / steps,
            "recomputes": (tel.counter(E.ROUTE_RECOMPUTE_COUNTER).value()
                           - r0) / steps,
            "gauge": tel.gauge(E.SORTS_GAUGE).value(),
            "routes": dict(step.routes),
            "dense_routes": dict(step.dense_routes),
            "builds": tel.gauge("sharded_step_compiles").value() - c0,
            "densify": tel.counter(E.DENSIFY_COUNTER).value() - d0,
            "ratio": E.note_dedup_stats(stats)}
        return out
    finally:
        os.environ.pop("MXTPU_EMBED_HOIST", None)


def train_steps_kw(rank, args, kw):
    """``train_steps`` with keyword arguments."""
    return train_steps(rank, *args, **kw)


def save_table(rank, root, table, logical, shard_rows):
    """This rank's rows of ``table`` saved through a collective
    ``CheckpointManager.save`` with ``table_writer``; rank 0 returns
    ``verify``."""
    from incubator_mxnet_tpu_torch.fault import CheckpointManager
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    n = torch.distributed.get_world_size()
    _mesh(n)
    import incubator_mxnet_tpu_torch as mx
    t = _local_rows(table, n, rank)
    mgr = CheckpointManager(root, keep=2)
    with mx.cpu():
        mgr.save(7, writers=[E.table_writer("embed", t, logical_rows=logical,
                                            shard_rows=shard_rows)])
    return mgr.verify(7) if rank == 0 else None


def trainer_dist_step(rank, kind, w, b, x, y, lr, update_on_kvstore):
    """One ``Trainer(kvstore=kind)`` step of a Dense(4) net on this rank's
    half of the batch (the gradients summed over the world by the store);
    the weights after it."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    n = torch.distributed.get_world_size()
    with mx.cpu():
        with mx.name.NameManager():
            net = gluon.nn.Dense(w.shape[0], in_units=w.shape[1])
        net.initialize()
        net.weight.set_data(nd.array(w))
        net.bias.set_data(nd.array(b))
        kv = mx.kvstore.create(kind)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": lr, "momentum": 0.9},
                           kvstore=kv, update_on_kvstore=update_on_kvstore)
        xb, yb = _block(x, n, rank), _block(y, n, rank)
        for _ in range(2):
            with autograd.record():
                loss = ((net(nd.array(xb.numpy())) - nd.array(yb.numpy()))
                        ** 2).sum()
            loss.backward()
            tr.step(x.shape[0])
        out = (net.weight.data().asnumpy(), net.bias.data().asnumpy(),
               tr._update_on_kvstore, kv.rank, kv.num_workers)
        kv.close()
        return out


def kv_push_pull(rank, kind):
    """Every rank pushes rank + 1; the pulled sum."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    with mx.cpu():
        kv = mx.kvstore.create(kind)
        kv.init("w", nd.zeros((4,)))
        kv.push("w", nd.ones((4,)) * (rank + 1))
        kv.barrier()
        out = nd.zeros((4,))
        kv.pull("w", out=out)
        snaps = kv.telemetry_allgather()
        return out.asnumpy(), len(snaps)


class World:
    """A ``LocalWorld`` of n CPU ranks, remade if a failed call stopped
    it (the test side)."""

    def __init__(self, n, root):
        self.n, self.root, self.w, self.k = n, str(root), None, 0

    def _live(self):
        from incubator_mxnet_tpu_torch.parallel.world import LocalWorld
        if self.w is None or self.w.closed:
            self.k += 1
            self.w = LocalWorld(self.n, os.path.join(self.root, f"w{self.k}"))
        return self.w

    def start(self, fn, *args, timeout=120):
        """Send the call and return; the JAX side runs meanwhile."""
        self._live().start(fn, *args, timeout=timeout)

    def wait(self):
        return self.w.wait()

    def run(self, fn, *args, timeout=120):
        return self._live().run(fn, *args, timeout=timeout)

    def close(self):
        if self.w is not None:
            self.w.close()


def crash_saves(rank, root, table, logical):
    """A good collective save at step 7, then saves that fail: rank 3's
    writer dying after its first file (step 8), and rank 0 killed by the
    ``ckpt.save`` chaos point at each of its stages (steps 10-15). Returns
    on rank 0 [(step, raised, latest(), verify(latest()), tmp residue)]."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import chaos
    from incubator_mxnet_tpu_torch.fault import CheckpointManager
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    n = torch.distributed.get_world_size()
    _mesh(n)
    t = _local_rows(table, n, rank)
    mgr = CheckpointManager(root, keep=3)
    out = []

    def dying(tmp):
        if rank == 3:
            np.save(os.path.join(tmp, "embed.table.3.0.npy"), t[:1].numpy())
            raise OSError("rank 3: disk gone mid-shard")
    dying.collective = True

    def attempt(step, writers):
        try:
            with mx.cpu():
                mgr.save(step, writers=writers)
            raised = False
        except (OSError, chaos.ChaosError):
            raised = True
        if rank == 0:
            latest = mgr.latest()
            out.append((step, raised, latest, mgr.verify(latest),
                        [d for d in os.listdir(root)
                         if d.startswith(".tmp")]))
    writer = E.table_writer("embed", t, logical_rows=logical, shard_rows=8)
    attempt(7, [writer])
    attempt(8, [dying])
    for k in range(6):
        if rank == 0:
            chaos.arm("ckpt.save", prob=1.0, skip=k, times=1)
        attempt(10 + k, [writer])
        chaos.disarm("ckpt.save")
    return out if rank == 0 else None
