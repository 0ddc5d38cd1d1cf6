"""``chip_smoke.py`` phase 33, the sparse recommender path: the sharded
embedding engine (``parallel/embedding.py``) on the ``row_sparse_update``
kernel, the stores and the table checkpoints, on one card.

    python3 tools/chip_phases.py 33

* (a) DLRM at ``bench.py``'s ``bench_dlrm`` lane, full width: one
  100,000,000-row table (dim 8, float32, 3.2 GB; SGD keeps no state), 26
  sparse ids and 13 dense features a sample, batch 4,096, bottom (64,),
  top (64, 1), SGD at lr 0.01, ``SigmoidBinaryCrossEntropyLoss``; ids 80/20
  over a 4,096-row hot set; the batches pinned in host memory (the
  reference's ``BENCH_DLRM_INGEST=0`` route). The table is born on the card
  (``ShardedEmbedding.initialize_table``). 1 warm-up step, then 5 timed
  steps with the launch counts set to 0 just before them and read just
  after: one ``row_sparse_update`` launch a step, all on the kernel route
  (``step.routes``), and one ``multi_tensor_update`` a step for the tower
  (``step.dense_routes``), no densify, one sort a step; step ms, samples/s, the
  dedup ratio, peak memory, and a profiled window of two steps
  (``kernel_breakdown``: busy, idle, top operations). Then one more step
  with its update's inputs captured: the kernel's result against the twin
  on the step's own (ids, g_rows) from the same table, bit for bit, and the
  kernel's device ms at that shape beside the twin's, ``index_add_``'s and
  the byte bound at the step's unique-row count (each unique id and its
  row's bytes once). Then the whole step at
  1,000,000 rows on the card against the same step on the CPU (the
  twins), from the same weights and batches: losses and touched rows
  within rtol 1e-5 / atol 1e-6 (the tower's products and the row sums
  summing in other orders).
* (b) the sharded FM at ``bench_sparse_fm``'s width (``BASELINE.json``
  config #5): 1,000,000 features, factor 16, 39 active, batch 8,192, Adam
  at lr 1e-3: two ``row_sparse_update`` launches a step (the factor and
  linear tables) on the adam kind and one ``multi_tensor_update`` (the
  bias); the factor table's update against the
  twin bit for bit (weights and both moments), and its times.
* (c) the sharded path: 8 gloo ranks sharing the card (NCCL refuses two
  ranks on one card; the collectives stage through pinned host memory),
  the same DLRM at 100M rows, 12,500,000 rows a rank, global batch 4,096:
  3 steps against one card's 3 steps from the same weights and batches
  (losses and touched rows within rtol 1e-5 / atol 1e-6), one
  ``row_sparse_update`` and one ``multi_tensor_update`` launch a rank a
  step, the collectives a step (3 all-to-alls, the dense
  gradients' and the loss's all-reduces) and their share of each rank's
  wall; then a checkpoint through ``CheckpointManager`` + ``table_writer``
  (every rank its shard; ``verify()``), restored onto the card
  (``load_table(mesh=None)``) bit for bit against the ranks' shards
  (sha256 a shard), its seconds and GB; one ``Trainer(kvstore=
  "dist_sync")`` step of a small dense block on the card against one
  process's step on the whole batch (rtol / atol 1e-5); and one
  ``dist_async`` push/pull round through the rank-0 server.

The rank bodies are this module's functions (a rank imports it, never
``chip_smoke.py``); :func:`embed_phase` drives them and returns the
phase's record. The sizes are arguments, so the phase rehearses on the CPU
at a small size (``embed_phase(..., device="cpu", small=True)``), where
the kernel's checks are left out.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import socket
import tempfile
import time

import numpy as np
import torch

SEED = 0
DLRM = dict(rows=100_000_000, dim=8, K=26, n_dense=13, batch=4096,
            hot=4096, lr=0.01)
FM = dict(features=1_000_000, factor=16, active=39, batch=8192, lr=1e-3)
SMALL_DLRM = dict(rows=20_000, dim=8, K=26, n_dense=13, batch=64, hot=64,
                  lr=0.01)
SMALL_FM = dict(features=5_000, factor=16, active=39, batch=64, lr=1e-3)
SUBSET_ROWS = 1_000_000
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# the Trainer step: 8 ranks' gradients summed in another order than one
# process's whole batch
TRAINER_TOL = dict(rtol=1e-5, atol=1e-5)
RANKS = 8
ROW_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/multi_tensor.cu"
ROW_REPLACES = "incubator_mxnet_tpu/optimizer/fused.py:54"


def _batches(cfg, n, seed):
    """``n`` DLRM batches (ids, dense, labels) as pinned host tensors:
    ``bench_dlrm``'s 80/20 hot-set skew."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        bs, K = cfg["batch"], cfg["K"]
        hot = rs.randint(0, min(cfg["hot"], cfg["rows"]), (bs, K))
        cold = rs.randint(0, cfg["rows"], (bs, K))
        ids = np.where(rs.rand(bs, K) < 0.8, hot, cold).astype(np.int64)
        xd = rs.rand(bs, cfg["n_dense"]).astype(np.float32)
        y = (rs.rand(bs) < 0.5).astype(np.float32).reshape(bs, 1)
        out.append(tuple(_pinned(torch.as_tensor(a)) for a in (ids, xd, y)))
    return out


def _pinned(t):
    return t.pin_memory() if torch.cuda.is_available() else t


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _dlrm_net(cfg, dev, dense=None, mesh=None, rows=None, table=None):
    """The DLRM on ``dev``: its table born on the device
    (``initialize_table``, seeded), or ``table`` (the whole one, any
    device); its tower from ``dense`` ({structural name: numpy}) or
    Xavier from the seed. Returns (net, the tower's values by structural
    name)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models.sparse_recommenders import DLRM as D
    rows = rows or cfg["rows"]
    ctx = mx.gpu(0) if torch.device(dev).type == "cuda" else mx.cpu()
    with ctx, mx.name.NameManager():
        net = D(rows, embed_dim=cfg["dim"], num_dense=cfg["n_dense"],
                bottom_units=(64,), top_units=(64, 1))
        if table is None:
            net.embed.initialize_table(mesh=mesh, key=SEED + 1, device=dev)
        else:
            net.embed.weight._shape = tuple(table.shape)
            net.embed.weight._init_impl(mx.nd.from_torch(table.to(dev)),
                                        None)
        mx.random.seed(SEED + 2)
        net.initialize(mx.init.Xavier())
        params = net._collect_params_with_prefix()
        if dense is None:
            # one forward resolves the tower's deferred shapes
            with mx.autograd.pause():
                net(mx.nd.from_torch(torch.zeros(
                    (2, cfg["K"]), dtype=torch.int64, device=dev)),
                    mx.nd.from_torch(torch.zeros((2, cfg["n_dense"]),
                                                 device=dev)))
        else:
            for k, p in params.items():
                if k in dense:
                    p.set_data(mx.nd.from_torch(torch.as_tensor(
                        dense[k]).to(dev)))
        tower = {k: p.data()._data.detach().cpu().numpy().copy()
                 for k, p in params.items() if k != "embed.weight"}
    return net, tower


def _step_for(net, cfg, opt, lr, mesh=None):
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    return E.make_sharded_train_step(
        net, gluon.loss.SigmoidBinaryCrossEntropyLoss(), optimizer=opt,
        optimizer_params={"learning_rate": lr}, mesh=mesh)


@contextlib.contextmanager
def _captured_updates(store):
    """Within: each ``update_rows`` call of the step records clones of its
    table, state and inputs (before the update) into ``store``."""
    from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    orig = mt.update_rows

    def spy(kind, tensor_step, w, state, ids, g_rows, h, packed, ok=None):
        leaves = [None if s is None else s.clone()
                  for s in mt._leaves(state)]
        store.append(dict(kind=kind, tensor_step=tensor_step, w=w,
                          state=state, w0=w.clone(), state0=leaves,
                          ids=ids.clone(), g=g_rows.clone(), h=h,
                          packed=packed))
        return orig(kind, tensor_step, w, state, ids, g_rows, h, packed, ok)
    mt.update_rows = spy
    try:
        yield store
    finally:
        mt.update_rows = orig


def _kernel_check(cap, label, log):
    """One captured update: the kernel's result against the twin's on the
    same (table, state, ids, g_rows), bit for bit; the kernel's device and
    event ms at that shape, the twin's, the library call's (SGD:
    ``index_add_``) and the byte bound at the unique-row count."""
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    kind, ts, h, packed = cap["kind"], cap["tensor_step"], cap["h"], \
        cap["packed"]
    ids, g = cap["ids"], cap["g"]
    rows, width = cap["w"].shape[0], cap["w"][0].numel()
    tw = cap["w0"]
    leaves0 = cap["state0"]

    def rebuild(leaves):
        if not leaves or leaves == [None]:
            return None
        return tuple(leaves) if len(leaves) > 1 else leaves[0]
    twin_state = rebuild(leaves0)
    mt.row_sparse_update_reference(ts, tw, twin_state, ids, g, h)
    torch.cuda.synchronize()
    got = [cap["w"]] + [s for s in mt._leaves(cap["state"]) if s is not None]
    want = [tw] + [s for s in mt._leaves(twin_state) if s is not None]
    same = all(torch.equal(cs._bits(a), cs._bits(b))
               for a, b in zip(got, want))
    err = cs._max_abs_err(got, want)
    if not same:
        raise AssertionError(f"{label}: row_sparse_update against its "
                             f"twin on the step's rows: worst {err}")
    valid = ids < rows
    u = int(valid.sum())
    st = [s for s in mt._leaves(cap["state"]) if s is not None]
    s0 = st[0] if st else None
    s1 = st[1] if len(st) > 1 else None

    def kern():
        mt.row_sparse_update(kind, cap["w"], s0, s1, ids, g, packed)
    device_ms, _ = cs._kernel_ms(kern, "row_sparse_update")
    event_ms = cs.time_ms(kern, iters=20, warmup=2)
    plain_ms = cs.time_ms(lambda: mt.row_sparse_update_reference(
        ts, tw, twin_state, ids, g, h), iters=5, warmup=1)
    library_ms = None
    if kind == "sgd":
        vi, vg = ids[:u].contiguous(), g[:u].contiguous()
        lw = cap["w"]
        library_ms = cs.time_ms(lambda: lw.index_add_(0, vi, vg,
                                                       alpha=-h["lr"]),
                                iters=20, warmup=2)
    # bytes once: for each unique row its id, its weight, its gradient and
    # its states read and the weight and states written (the padding ids
    # past the unique ones are work of the launch, not of the update)
    per_row = {"sgd": 3, "adam": 7, "adamw": 7}[kind] * width * 4
    bound_ms = u * (8 + per_row) / cs.HBM_BYTES_PER_S * 1e3
    out = {"kind": kind, "ids": int(ids.numel()), "unique_rows": u,
           "width": width, "table_rows": rows, "equal_to_twin": True,
           "max_abs_err": err, "device_ms": device_ms, "event_ms": event_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": "bytes"}
    log(f"{label}: row_sparse_update on the step's rows {json.dumps(out)}")
    return out


def _timed(step, state, batches, dev, steps):
    """``steps`` steps on the batches in turn, launch counts from zero:
    (state, losses, step ms, launches, stats of the last)."""
    from incubator_mxnet_tpu_torch.ops.cuda import common
    losses, ms, stats = [], [], None
    if torch.device(dev).type == "cuda":
        common.reset_launch_counts()
    for i in range(steps):
        b = [t.to(dev, non_blocking=True) for t in batches[i % len(batches)]]
        _sync(dev)
        t0 = time.perf_counter()
        state, loss, stats = step(state, *b)
        lv = float(loss)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lv)
    launches = ({k: v for k, v in common.launch_counts().items() if v}
                if torch.device(dev).type == "cuda" else {})
    return state, losses, ms, launches, stats


def dlrm_one_card(log, cfg, dev):
    """(a): the record, and what (c) compares with (the tower's first
    values and the batches)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import telemetry as tel
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net, tower = _dlrm_net(cfg, dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    step, state = _step_for(net, cfg, "sgd", cfg["lr"])
    batches = _batches(cfg, 6, SEED + 3)
    d0 = tel.counter(E.DENSIFY_COUNTER).value()
    state, warm, warm_ms, _, _ = _timed(step, state, batches[:1], dev, 1)
    state, losses, ms, launches, stats = _timed(step, state, batches[1:],
                                                dev, 5)
    routes, dense_routes = dict(step.routes), dict(step.dense_routes)
    ratio = E.note_dedup_stats(stats)
    sorts = step.plan_sorts_per_step()
    table = next(iter(state.tables.values()))
    rec = {"rows": cfg["rows"], "table_gb": table.numel() * 4 / 1e9,
           "build_s": build_s,
        "warmup_ms": warm_ms[0], "step_ms": ms,
        "samples_s": cfg["batch"] / (np.median(ms) / 1e3),
        "losses": warm + losses, "dedup_ratio": ratio,
        "sorts_per_step": sorts,
        "densify": tel.counter(E.DENSIFY_COUNTER).value() - d0,
        "routes": routes, "dense_routes": dense_routes,
        "launches": launches}
    if cuda:
        want = {"row_sparse_update": 5, "multi_tensor_update": 5}
        if launches != want or routes["kernel"] != 6 \
                or dense_routes["kernel"] != 6:
            raise AssertionError(f"DLRM: launches {launches}, routes "
                                 f"{routes}, tower {dense_routes}; one "
                                 f"row_sparse_update and one "
                                 f"multi_tensor_update a step on the kernel "
                                 f"routes wanted")
    if rec["densify"] or sorts != 1 or not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"DLRM: {rec}")
    if cuda:
        import chip_smoke as cs
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        b = [t.to(dev) for t in batches[0]]

        def one():
            step(state, *b)
        rec["breakdown"] = cs.kernel_breakdown(
            "phase 33 DLRM 100M", one, ("row_sparse_update",
                                        "multi_tensor_update", "sort",
                                        "index"))
        caps = []
        with _captured_updates(caps):
            step(state, *b)
        rec["kernel"] = _kernel_check(caps[0], "DLRM 100M", log)
        del caps
    log(f"phase 33 (a) DLRM {cfg['rows']:,} rows one card: "
        f"{json.dumps({k: v for k, v in rec.items() if k != 'breakdown'})}")
    del state, step, net
    return rec, tower


def _touched_rows(table, ids):
    idx = torch.as_tensor(ids, device=table.device)
    return table.index_select(0, idx).detach().cpu().numpy()


def dlrm_card_vs_cpu(log, cfg, dev):
    """(a)'s step at 1,000,000 rows on the card against the CPU, from the
    same weights (the table made on the CPU) and batches: 2 steps."""
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    sub = dict(cfg, rows=min(SUBSET_ROWS, cfg["rows"]))
    table = E.init_table(sub["rows"], sub["dim"], mesh=None, key=SEED + 1,
                         device="cpu")
    batches = _batches(sub, 2, SEED + 4)
    touched = np.unique(np.concatenate([b[0].numpy().ravel()
                                        for b in batches]))
    out = {}
    dense = None
    for where in (dev, "cpu"):
        net, tower = _dlrm_net(sub, where, dense=dense, table=table.clone())
        dense = dense or tower
        step, state = _step_for(net, sub, "sgd", sub["lr"])
        state, losses, _, _, _ = _timed(step, state, batches, where, 2)
        name = next(iter(state.tables))
        out[where] = (losses, _touched_rows(state.tables[name], touched),
                      (dict(step.routes), dict(step.dense_routes)))
    (lc, rc, routes_c), (lh, rh, routes_h) = out[dev], out["cpu"]
    err = float(np.abs(rc - rh).max())
    rec = {"rows": sub["rows"], "losses_card": lc, "losses_cpu": lh,
           "touched_rows": int(touched.size), "max_abs_err_rows": err,
           "routes_card": routes_c[0], "routes_cpu": routes_h[0],
           "dense_routes_card": routes_c[1], "dense_routes_cpu": routes_h[1]}
    np.testing.assert_allclose(lc, lh, **STEP_TOL)
    np.testing.assert_allclose(rc, rh, **STEP_TOL)
    log(f"phase 33 (a) DLRM {sub['rows']:,} rows, card against CPU: "
        f"{json.dumps(rec)}")
    return rec


def fm_one_card(log, cfg, dev):
    """(b): the sharded FM, Adam: two kernel launches a step."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.models.sparse_recommenders import \
        ShardedFactorizationMachine
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    cuda = torch.device(dev).type == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    with ctx, mx.name.NameManager():
        net = ShardedFactorizationMachine(cfg["features"], cfg["factor"])
        net.v.initialize_table(key=SEED + 5, device=dev)
        net.w.initialize_table(key=SEED + 6, device=dev)
        net.initialize()
    rs = np.random.RandomState(SEED + 7)
    bs, K = cfg["batch"], cfg["active"]
    batch = (_pinned(torch.as_tensor(rs.randint(1, cfg["features"],
                                                (bs, K)).astype(np.int64))),
             _pinned(torch.as_tensor(rs.rand(bs, K).astype(np.float32))),
             _pinned(torch.as_tensor((rs.rand(bs) < 0.5).astype(
                 np.float32).reshape(bs, 1))))
    step, state = E.make_sharded_train_step(
        net, gluon.loss.SigmoidBinaryCrossEntropyLoss(), optimizer="adam",
        optimizer_params={"learning_rate": cfg["lr"]})
    state, warm, _, _, _ = _timed(step, state, [batch], dev, 1)
    state, losses, ms, launches, stats = _timed(step, state, [batch], dev,
                                                5)
    rec = {"features": cfg["features"], "factor": cfg["factor"],
           "step_ms": ms, "samples_s": bs / (np.median(ms) / 1e3),
           "losses": warm + losses, "dedup_ratio": E.note_dedup_stats(stats),
           "sorts_per_step": step.plan_sorts_per_step(),
           "routes": dict(step.routes),
           "dense_routes": dict(step.dense_routes), "launches": launches}
    if cuda and (launches != {"row_sparse_update": 10,
                              "multi_tensor_update": 5}
                 or rec["routes"]["kernel"] != 12
                 or rec["dense_routes"]["kernel"] != 6):
        raise AssertionError(f"FM: launches {launches}, routes "
                             f"{rec['routes']}, tower {rec['dense_routes']}; "
                             f"two row updates and one tower update a step "
                             f"wanted")
    if not (all(np.isfinite(rec["losses"])) and losses[-1] < warm[0]):
        raise AssertionError(f"FM: losses {rec['losses']}")
    if cuda:
        caps = []
        b = [t.to(dev) for t in batch]
        with _captured_updates(caps):
            step(state, *b)
        v = [c for c in caps if c["w"].shape[1] == cfg["factor"]][0]
        rec["kernel"] = _kernel_check(v, "FM factor table", log)
        del caps
    log(f"phase 33 (b) sharded FM: {json.dumps(rec)}")
    return rec


# ------------------------------------------------------------ the ranks
def _rank_mesh(dev):
    from incubator_mxnet_tpu_torch.parallel import mesh as M
    m = M.get_mesh()
    if m is None:
        m = M.create_mesh(shape=(torch.distributed.get_world_size(),),
                          axis_names=("data",), backend="gloo", device=dev)
    return m


_RANK = {}


def rank_dlrm(rank, cfg, dev, dense, batches, touched):
    """(c) on a rank: this rank's 1/8 of the table from the same seed,
    the tower from ``dense``, 3 steps on the global batches. Returns the
    losses, step ms, seconds and calls in collectives, this rank's kernel
    launches and routes, and its rows of ``touched`` (id, row)."""
    from incubator_mxnet_tpu_torch.ops.cuda import common
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    mesh = _rank_mesh(dev)
    if torch.device(dev).type == "cuda":
        common.kernel_library()
    net, _ = _dlrm_net(cfg, dev, dense=dense, mesh=mesh)
    step, state = _step_for(net, cfg, "sgd", cfg["lr"], mesh=mesh)
    bs = [tuple(torch.as_tensor(a) for a in b) for b in batches]
    losses, ms, comm, calls = [], [], [], []
    if torch.device(dev).type == "cuda":
        common.reset_launch_counts()
    for b in bs:
        _sync(dev)
        t0 = time.perf_counter()
        with C.timing() as cs_:
            state, loss, _ = step(state, *b)
            lv = float(loss)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append(cs_[0])
        calls.append(cs_[1])
        losses.append(lv)
    launches = ({k: v for k, v in common.launch_counts().items() if v}
                if torch.device(dev).type == "cuda" else {})
    name = next(iter(state.tables))
    local = state.tables[name]
    rps = local.shape[0]
    lo = mesh.axis_index("data") * rps
    mine = touched[(touched >= lo) & (touched < lo + rps)]
    rows = local.index_select(0, torch.as_tensor(mine - lo, device=local.device))
    _RANK["state"], _RANK["name"] = state, name
    return {"losses": losses, "step_ms": ms, "comm_s": comm,
            "collectives": calls, "launches": launches,
            "routes": dict(step.routes),
            "dense_routes": dict(step.dense_routes), "ids": mine,
            "rows": rows.cpu().numpy(), "rows_per_rank": rps}


def rank_checkpoint(rank, root, logical):
    """(c)'s checkpoint on a rank: this rank's shard through a collective
    ``CheckpointManager.save`` with ``table_writer``; (seconds, sha256 of
    the shard's bytes, verify on rank 0)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.fault import CheckpointManager
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    state, name = _RANK["state"], _RANK["name"]
    local = state.tables[name]
    digest = hashlib.sha256(local.cpu().numpy().tobytes()).hexdigest()
    mgr = CheckpointManager(root, keep=1)
    ctx = mx.gpu(0) if local.is_cuda else mx.cpu()
    t0 = time.perf_counter()
    with ctx:
        mgr.save(3, writers=[E.table_writer(name, local,
                                            logical_rows=logical)])
    save_s = time.perf_counter() - t0
    ok = None
    if rank == 0:
        t0 = time.perf_counter()
        ok = mgr.verify(3)
        save_s = (save_s, time.perf_counter() - t0)
    _RANK.clear()
    return save_s, digest, ok, name


def rank_trainer(rank, dev, w, b, x, y, lr):
    """One ``Trainer(kvstore="dist_sync")`` step (SGD momentum 0.9) of a
    Dense net with parameters on ``dev``, on this rank's block of the
    batch; the weights after it."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    n = torch.distributed.get_world_size()
    ctx = mx.gpu(0) if torch.device(dev).type == "cuda" else mx.cpu()
    with ctx:
        with mx.name.NameManager():
            net = gluon.nn.Dense(w.shape[0], in_units=w.shape[1])
        net.initialize()
        net.weight.set_data(nd.array(w))
        net.bias.set_data(nd.array(b))
        kv = mx.kvstore.create("dist_sync")
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": lr, "momentum": 0.9},
                           kvstore=kv)
        k = x.shape[0] // n
        xb, yb = x[rank * k:(rank + 1) * k], y[rank * k:(rank + 1) * k]
        with autograd.record():
            loss = ((net(nd.array(xb)) - nd.array(yb)) ** 2).sum()
        loss.backward()
        tr.step(x.shape[0])
        return (net.weight.data().asnumpy(), net.bias.data().asnumpy(),
                str(net.weight.data()._data.device), tr._update_on_kvstore)


def rank_async_round(rank, addr, dev):
    """One ``dist_async`` round: every rank pushes ones, the rank-0 server
    applies SGD at lr 1 on arrival; each rank pulls after a barrier."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.optimizer import SGD
    n = torch.distributed.get_world_size()
    os.environ.update(MXTPU_NUM_WORKERS=str(n), MXTPU_WORKER_RANK=str(rank),
                      MXTPU_PS_ADDR=addr)
    ctx = mx.gpu(0) if torch.device(dev).type == "cuda" else mx.cpu()
    try:
        with ctx:
            kv = mx.kvstore.create("dist_async")
            kv.init("w", nd.zeros((4,)))
            if rank == 0:
                kv.set_optimizer(SGD(learning_rate=1.0))
            kv.barrier()
            kv.push("w", nd.ones((4,)))
            kv.barrier()
            out = nd.zeros((4,))
            kv.pull("w", out=out)
            dead = kv.num_dead_node
            kv.barrier()
            view = kv.group_view()
            kv.barrier()
            kv.close()
        return out.asnumpy(), dead, view[1]
    finally:
        for k in ("MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK", "MXTPU_PS_ADDR"):
            os.environ.pop(k, None)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dir_gb(d):
    return sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d)) / 1e9


def sharded_phase(log, cfg, dev, tower, ranks=RANKS):
    """(c): the 8-rank world on the card against one card."""
    from incubator_mxnet_tpu_torch.parallel import embedding as E
    from incubator_mxnet_tpu_torch.parallel.world import LocalWorld
    batches = [tuple(t.numpy() for t in b)
               for b in _batches(cfg, 3, SEED + 8)]
    touched = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    # one card, the same weights and batches
    net, _ = _dlrm_net(cfg, dev, dense=tower)
    step, state = _step_for(net, cfg, "sgd", cfg["lr"])
    state, one_losses, one_ms, _, _ = _timed(
        step, state, [tuple(_pinned(torch.as_tensor(a)) for a in b)
                      for b in batches], dev, 3)
    name = next(iter(state.tables))
    one_rows = _touched_rows(state.tables[name], touched)
    del state, step, net
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    rec = {"ranks": ranks, "one_card_losses": one_losses,
           "one_card_step_ms": one_ms}
    root = tempfile.mkdtemp(prefix="embed_phase_")
    try:
        t0 = time.perf_counter()
        with LocalWorld(ranks, os.path.join(root, "gloo"), backend="gloo",
                        device=dev, timeout=180) as world:
            world.wait()
            rec["world_start_s"] = time.perf_counter() - t0
            res = world.run(rank_dlrm, cfg, dev, tower, batches, touched,
                            timeout=300)
            losses = res[0]["losses"]
            if any(r["losses"] != losses for r in res):
                raise AssertionError("sharded DLRM: ranks disagree on the "
                                     "loss")
            got = np.zeros_like(one_rows)
            pos = {int(i): j for j, i in enumerate(touched)}
            for r in res:
                for i, row in zip(r["ids"], r["rows"]):
                    got[pos[int(i)]] = row
            np.testing.assert_allclose(losses, one_losses, **STEP_TOL)
            np.testing.assert_allclose(got, one_rows, **STEP_TOL)
            cuda = torch.device(dev).type == "cuda"
            for r in res:
                if cuda and (r["launches"] != {"row_sparse_update": 3,
                                               "multi_tensor_update": 3}
                             or r["routes"]["kernel"] != 3
                             or r["dense_routes"]["kernel"] != 3):
                    raise AssertionError(
                        f"sharded DLRM: a rank launched {r['launches']} "
                        f"({r['routes']}, tower {r['dense_routes']}), one "
                        f"of each a step wanted")
            rec.update({
                "losses": losses,
                "max_abs_err_rows": float(np.abs(got - one_rows).max()),
                "touched_rows": int(touched.size),
                "rows_per_rank": res[0]["rows_per_rank"],
                "step_ms": [r["step_ms"] for r in res],
                "comm_share": [[c * 1e3 / m for c, m in
                                zip(r["comm_s"], r["step_ms"])]
                               for r in res],
                "collectives_per_step": res[0]["collectives"],
                "launches_per_rank": [r["launches"] for r in res],
                "routes": res[0]["routes"],
                "dense_routes": res[0]["dense_routes"]})
            log(f"phase 33 (c) sharded DLRM on {ranks} ranks: "
                f"{json.dumps({k: v for k, v in rec.items()})}")
            ck = os.path.join(root, "ckpt")
            saved = world.run(rank_checkpoint, ck, cfg["rows"], timeout=300)
            (save_s, verify_s), _, ok, tname = saved[0]
            if ok is not True:
                raise AssertionError("the table checkpoint fails verify()")
            step_dir = os.path.join(ck, "step-3")
            gb = _dir_gb(step_dir)
            t0 = time.perf_counter()
            whole, _ = E.load_table(step_dir, tname, mesh=None, device=dev)
            _sync(dev)
            load_s = time.perf_counter() - t0
            rps = whole.shape[0] // ranks if whole.shape[0] % ranks == 0 \
                else -(-whole.shape[0] // ranks)
            padded = torch.zeros((rps * ranks,) + tuple(whole.shape[1:]),
                                 dtype=whole.dtype)
            padded[:whole.shape[0]] = whole.cpu()
            del whole
            same = [hashlib.sha256(padded[r * rps:(r + 1) * rps].numpy()
                                   .tobytes()).hexdigest() == saved[r][1]
                    for r in range(ranks)]
            del padded
            if not all(same):
                raise AssertionError(f"restored shards against the ranks': "
                                     f"{same}")
            rec["checkpoint"] = {"save_s": save_s, "verify_s": verify_s,
                                 "gb_written": gb, "load_s": load_s,
                                 "restored_bitwise": True,
                                 "ranks_written": ranks}
            log(f"phase 33 (c) table checkpoint: {json.dumps(rec['checkpoint'])}")
            rs = np.random.RandomState(SEED + 9)
            w, b = (rs.randn(16, 32).astype(np.float32),
                    rs.randn(16).astype(np.float32))
            x, y = (rs.randn(64, 32).astype(np.float32),
                    rs.randn(64, 16).astype(np.float32))
            tr = world.run(rank_trainer, dev, w, b, x, y, 0.01)
            want_w, want_b = _one_process_trainer(dev, w, b, x, y, 0.01)
            for gw, gb_, where, uok in tr:
                np.testing.assert_allclose(gw, want_w, **TRAINER_TOL)
                np.testing.assert_allclose(gb_, want_b, **TRAINER_TOL)
            rec["trainer_dist_sync"] = {
                "device": tr[0][2], "update_on_kvstore": tr[0][3],
                "max_abs_err": float(max(np.abs(t[0] - want_w).max()
                                         for t in tr))}
            addr = f"127.0.0.1:{_free_port()}"
            rounds = world.run(rank_async_round, addr, dev, timeout=120)
            for out, dead, live in rounds:
                np.testing.assert_array_equal(out, -float(ranks))
            rec["dist_async"] = {"pulled": float(rounds[0][0][0]),
                                 "dead": rounds[0][1],
                                 "view": list(rounds[0][2])}
            log(f"phase 33 (c) stores: "
                f"{json.dumps({k: rec[k] for k in ('trainer_dist_sync', 'dist_async')})}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


def _one_process_trainer(dev, w, b, x, y, lr):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    ctx = mx.gpu(0) if torch.device(dev).type == "cuda" else mx.cpu()
    with ctx:
        with mx.name.NameManager():
            net = gluon.nn.Dense(w.shape[0], in_units=w.shape[1])
        net.initialize()
        net.weight.set_data(nd.array(w))
        net.bias.set_data(nd.array(b))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": lr, "momentum": 0.9})
        with autograd.record():
            loss = ((net(nd.array(x)) - nd.array(y)) ** 2).sum()
        loss.backward()
        tr.step(x.shape[0])
        return net.weight.data().asnumpy(), net.bias.data().asnumpy()


# ---------------------------------------------------------------- phase
def embed_phase(log, records=None, device="cuda:0", small=False,
                budget_s=150.0):
    """Phase 33 (the module's note). ``records``, the kernels line's,
    gets ``row_sparse_update``'s and ``multi_tensor_update``'s launches on
    this path and the row kernel's times at DLRM's and FM's shapes (a
    record of its own when phase 31 did not run first). ``small`` runs the
    small sizes (a rehearsal on the CPU)."""
    t_start = time.perf_counter()
    device = str(torch.device(device))
    if device == "cuda":
        device = "cuda:0"          # the ranks' mesh names its card
    dcfg = SMALL_DLRM if small else DLRM
    fcfg = SMALL_FM if small else FM
    rec = {}
    rec["dlrm"], tower = dlrm_one_card(log, dcfg, device)
    rec["dlrm_card_vs_cpu"] = dlrm_card_vs_cpu(log, dcfg, device)
    rec["fm"] = fm_one_card(log, fcfg, device)
    rec["sharded"] = sharded_phase(log, dcfg, device, tower)
    rec["seconds"] = time.perf_counter() - t_start
    if records is not None and torch.device(device).type == "cuda":
        _row_record(records, rec)
    if rec["seconds"] > budget_s:
        log(f"phase 33 took {rec['seconds']:.1f} s, over its "
            f"{budget_s:.0f} s budget")
    return rec


def _row_record(records, rec):
    """The kernels line's records with this path's launches (the one-card
    runs, counted from zero just before each): ``row_sparse_update``'s,
    with its times at DLRM's and FM's shapes beside phase 31's, and
    ``multi_tensor_update``'s (the towers' updates). Run alone, without
    phase 31, the row kernel's record is made from DLRM's numbers."""
    d, f = rec["dlrm"]["kernel"], rec["fm"]["kernel"]
    main = (rec["dlrm"]["launches"]["row_sparse_update"]
            + rec["fm"]["launches"]["row_sparse_update"])
    r = records.get("row_sparse_update")
    if r is None:
        r = records["row_sparse_update"] = {
            "name": "row_sparse_update", "route": "cuda",
            "source": ROW_SOURCE, "replaces": ROW_REPLACES, "launches": 0,
            "max_abs_err": d["max_abs_err"], "ms": d["device_ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": "bytes", "library_ms": d["library_ms"],
            "ms_measured_at": "phase 33, DLRM 100M"}
    r["launches"] += main
    r.setdefault("launches_by_phase", {})["33"] = main
    r["max_abs_err"] = max(r["max_abs_err"], d["max_abs_err"],
                           f["max_abs_err"])
    r["dlrm_100m"] = {k: d[k] for k in ("device_ms", "event_ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "unique_rows", "ids")}
    r["fm_1m_adam"] = {k: f[k] for k in ("device_ms", "event_ms",
                                         "plain_ms", "bound_ms",
                                         "unique_rows", "ids")}
    r["mesh_launches"] = {"ranks": rec["sharded"]["ranks"],
                          "per_rank": rec["sharded"]["launches_per_rank"]}
    tower = (rec["dlrm"]["launches"]["multi_tensor_update"]
             + rec["fm"]["launches"]["multi_tensor_update"])
    m = records.get("multi_tensor_update")
    if m is None:
        m = records["multi_tensor_update"] = {"name": "multi_tensor_update",
                                              "launches": 0}
    m["launches"] += tower
    m.setdefault("launches_by_phase", {})["33"] = tower
