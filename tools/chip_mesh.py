"""``chip_smoke.py`` phase 32, the mesh: the five paths of the reference's
multi-device dry run (``__graft_entry__.dryrun_multichip``) as a gloo
world of 8 rank processes on one card, and a 1-rank NCCL world.

    python3 tools/chip_phases.py 32

NCCL refuses two ranks on one card ("Duplicate GPU detected"), so the 8
ranks form a gloo world: every rank computes on ``cuda:0`` and its
collectives stage CUDA tensors through pinned host buffers
(``parallel.mesh.Mesh.staged``). In it, at ``_factor3(8) = (2, 2, 2)``:

* the ring on the flash kernels against the plain ring at the full-width
  step's local shapes, float32 and bf16, output and gradients;
* ``dp-tp-sp`` at the bench LM's full width (d 768, 12 heads, d_ff 3072,
  12 layers, vocab 32768, causal, bf16 weights; ``bench.py``'s LM) on
  (data 2, tensor 2, seq 2), T 512, a global batch of 8, 3 timed steps
  and 2 profiled ones on one batch: the loss finite and falling, step 1's
  loss, gathered parameters and Adam's first moments against the
  single-device step from the same weights, each rank's flash launches a
  step (12 * (seq rank + 1) of each kernel, every one on the route
  ``flash_train_route`` gives the step's type, as the wrappers count
  them: wgmma in the bf16 first step, mma in the float32 ones after it),
  step ms, the share of each rank's wall spent inside collectives (its
  waits for its peers, for its own and the other ranks' queued device
  work, and the host staging included), and each rank's device time in
  the last profiled step over the last timed step's wall;
* ``dp-tp-ulysses`` and ``dp-fsdp-ep`` at the dry run's sizes (d 384, 12
  heads, vocab 512, float32; T 2048 over seq 2 with 1 layer, and T 256
  with 2 layers and 2 experts over (data 2, fsdp 2, expert 2));
* ``resnet50-dp-fsdp``: ResNet-50 NHWC at 64 x 64, batch 8, over (data 4,
  fsdp 2) with every parameter split on dim 0 over fsdp;
* ``pipe-transformer``: gpipe over 8 pre-LN transformer stages (d 256, 4
  heads, T 16, 8 microbatches of 2), loss and gradients held against the
  sequential run at the dry run's tolerances, then one SGD step lowers
  the loss.

The 1-rank NCCL world runs the same LM at depth 2 on the trivial mesh (and
an NCCL all-reduce of its loss) against the single-device step: loss,
parameters and Adam's first moments. Every axis of that mesh has one
rank, so no collective of ``parallel/collectives.py`` runs on NCCL there;
the loss's all-reduce is its one NCCL call.

The rank bodies are this module's functions (a rank imports it, never
``chip_smoke.py``); :func:`mesh_phase` drives them and returns the phase's
record.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

FULL_WIDTH = dict(vocab_size=32768, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=512, causal=True)
LR = 1e-3
_MESHES = {}


def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from incubator_mxnet_tpu_torch.ops.cuda import common
    common.kernel_library()


def _mesh(shape, names=None, backend="gloo"):
    from incubator_mxnet_tpu_torch.parallel import mesh as M
    key = (tuple(shape), names, backend)
    if key not in _MESHES:
        _MESHES[key] = M.create_mesh(shape=shape, axis_names=names,
                                     backend=backend, device="cuda:0")
    M.set_mesh(_MESHES[key])
    return _MESHES[key]


def _batch(vocab, B, T, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.as_tensor(rs.randint(0, vocab, (B, T)).astype(np.int64)),
            torch.as_tensor(rs.randint(0, vocab, (B, T)).astype(np.int64)))


def _flash_counts():
    """{flash training kernel: [launches, on the wgmma route (bf16), on
    the mma route (float32)]} since the counts were reset: the wrappers'
    ``sm90_launches`` count both Hopper routes, their ``x3_launches`` the
    mma one."""
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    out = {}
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        k = getattr(fa, n)
        out[n] = [k.launches, k.sm90_launches - k.x3_launches,
                  k.x3_launches]
    return out


def _timed_step(step, params, opt, tok, lab):
    """One step: (params, opt, loss, wall ms, seconds in collectives,
    flash launches)."""
    from incubator_mxnet_tpu_torch.ops.cuda import common
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    common.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with C.timing() as comm:
        params, opt, loss = step(params, opt, tok, lab)
        lv = float(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return params, opt, lv, wall * 1e3, comm[0], _flash_counts()


def _single_steps(cfg, tok, lab, steps=2, seed=0):
    """The single-device step from the same seed, ``steps`` times: (the
    losses, the parameters and Adam's first moment after step 1)."""
    from incubator_mxnet_tpu_torch.models import transformer as tt
    step, params, opt = tt.make_transformer_train_step(
        cfg, learning_rate=LR, seed=seed, device="cuda:0")
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, tok.cuda(), lab.cuda())
        losses.append(float(loss))
        if i == 0:
            first = (params, opt["m"])
    return losses, first[0], first[1]


def _tree_diff(got, want):
    """(largest |got - want|, share of entries apart by more than 1e-5)
    over two parameter trees."""
    from incubator_mxnet_tpu_torch.models import transformer as tt
    worst, apart, n = 0.0, 0, 0
    for a, b in zip(tt._tree_leaves(got), tt._tree_leaves(want)):
        d = (a.float() - b.float()).abs()
        worst = max(worst, d.max().item())
        apart += int((d > 1e-5).sum().item())
        n += d.numel()
    return worst, apart / n


def _tree_cos(got, want):
    """(the smallest cosine between a leaf of ``got`` and of ``want``, the
    largest |norm ratio - 1|): a gradient's direction and scale."""
    from incubator_mxnet_tpu_torch.models import transformer as tt
    cos, scale = 1.0, 0.0
    for a, b in zip(tt._tree_leaves(got), tt._tree_leaves(want)):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        na, nb = a.norm().item(), b.norm().item()
        if nb == 0.0:
            continue
        cos = min(cos, (a @ b).item() / max(na * nb, 1e-300))
        scale = max(scale, abs(na / nb - 1.0))
    return cos, scale


def lm_full_width(rank, steps=3, T=512, batch=8):
    """dp-tp-sp at the bench LM's full width (module note)."""
    _setup()
    from incubator_mxnet_tpu_torch.models import transformer as tt
    mesh = _mesh((2, 1, 2, 1, 1, 2))
    cfg = tt.TransformerConfig(dtype=torch.bfloat16, **FULL_WIDTH)
    step, params, opt = tt.make_transformer_train_step(
        cfg, mesh=mesh, learning_rate=LR, seed=0)
    tok, lab = _batch(cfg.vocab_size, batch, T)
    out = {"rank": rank, "coords": mesh.coords, "losses": [],
           "step_ms": [], "comm_s": [], "launches": [], "dtype": []}
    for i in range(steps):
        out["dtype"].append(str(params["layers"][0]["wq"].dtype))
        params, opt, lv, ms, comm, counts = _timed_step(step, params, opt,
                                                        tok, lab)
        out["losses"].append(lv)
        out["step_ms"].append(ms)
        out["comm_s"].append(comm)
        out["launches"].append(counts)
        if i == 0:
            specs = tt.param_specs(cfg)
            whole = tt.gather_params(params, specs, mesh)
            m1 = tt.gather_params(opt["m"], specs, mesh)
            if rank == 0:
                slosses, sp, sm = _single_steps(cfg, tok, lab)
                worst, apart = _tree_diff(whole, sp)
                cos, scale = _tree_cos(m1, sm)
                out["single"] = {"losses": slosses, "max_abs_param": worst,
                                 "share_apart": apart, "min_cos_m": cos,
                                 "max_norm_ratio_off": scale}
                del sp, sm
            del whole, m1
            torch.cuda.empty_cache()
    out["profiled"] = _profiled_steps(step, params, opt, tok, lab, out)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _profiled_steps(step, params, opt, tok, lab, out):
    """Two more steps under torch.profiler, the first its warm-up (CUPTI's
    tracer starts there and its records are dropped), each step's type,
    loss and flash launches appended to ``out``'s lists: {"device_busy_ms":
    this process's device time in the second step (its kernels and
    copies; None if the tracer delivered no device event), "copy_ms": the
    copies' part of it, "wall_ms": the second step's wall}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from incubator_mxnet_tpu_torch.ops.cuda import common
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            out["dtype"].append(str(params["layers"][0]["wq"].dtype))
            common.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, tok, lab)
            out["losses"].append(float(loss))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["launches"].append(_flash_counts())
            prof.step()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation
           and e.count and e.self_device_time_total > 0]
    if not dev:
        return {"device_busy_ms": None, "copy_ms": None,
                "wall_ms": wall * 1e3}
    return {"device_busy_ms": sum(e.self_device_time_total
                                  for e in dev) / 1e3,
            "copy_ms": sum(e.self_device_time_total for e in dev
                           if e.key.startswith(("Memcpy", "Memset"))) / 1e3,
            "wall_ms": wall * 1e3}


# |kernel - plain| over the plain tensor's largest entry, output and grads
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def ring_kernel_check(rank, B=4, T=256, H=6, D=64):
    """The ring on the flash kernels against the plain ring on the same
    inputs, at the full-width step's local shapes (B 4, T 256 a seq rank,
    6 heads of 64), causal, float32 and bf16: the largest |kernel - plain|
    of the output and of dq, dk, dv over the plain tensor's largest entry
    (within ``RING_TOL``)."""
    _setup()
    from incubator_mxnet_tpu_torch.parallel import ring_attention as ra
    mesh = _mesh((2, 1, 2, 1, 1, 2))
    g = torch.Generator(device="cuda:0").manual_seed(7 + rank)
    out = {}
    for dt, tol in RING_TOL.items():
        q, k, v, do = (torch.randn(B, T, H, D, device="cuda:0",
                                   generator=g).to(dt) for _ in range(4))
        res = []
        for fn in (ra.make_ring_flash_attention("seq", True, mesh=mesh),
                   lambda a, b, c: ra.ring_attention(
                       a.float(), b.float(), c.float(), "seq", True,
                       mesh=mesh).to(dt)):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*ins)
            res.append([o] + list(torch.autograd.grad(o, ins, do)))
        errs = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item() for a, b in zip(*res)]
        if max(errs) > tol:
            raise AssertionError(f"ring flash {dt}: |kernel - plain| "
                                 f"{errs}")
        out[str(dt)] = errs
    return out


def lm_dryrun(rank, mode):
    """dp-tp-ulysses or dp-fsdp-ep at the dry run's sizes: (loss, the
    flash launches of the step)."""
    _setup()
    from incubator_mxnet_tpu_torch.models import transformer as tt
    sp = mode == "ulysses"
    shape = (2, 1, 2, 1, 1, 2) if sp else (2, 2, 1, 1, 2, 1)
    mesh = _mesh(shape)
    cfg = tt.TransformerConfig(
        vocab_size=512, d_model=384, n_heads=12, d_ff=768,
        n_layers=1 if sp else 2, max_len=2048, n_experts=2,
        dtype=torch.float32, causal=True,
        sequence_parallel_mode="ulysses" if sp else "ring")
    B, T = (2, 2048) if sp else (16, 256)
    step, params, opt = tt.make_transformer_train_step(cfg, mesh=mesh,
                                                       seed=0)
    tok, lab = _batch(cfg.vocab_size, B, T, seed=1)
    _, _, lv, ms, comm, counts = _timed_step(step, params, opt, tok, lab)
    if not np.isfinite(lv):
        raise AssertionError(f"{mode}: loss {lv}")
    return {"loss": lv, "step_ms": ms, "comm_s": comm, "launches": counts,
            "coords": mesh.coords}


def resnet_dp_fsdp(rank, hw=64, batch=8):
    """ResNet-50 over (data 4, fsdp 2), every parameter split on dim 0
    over fsdp: (loss, step ms, seconds in collectives)."""
    _setup()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    from incubator_mxnet_tpu_torch.parallel import dp
    from incubator_mxnet_tpu_torch.parallel.mesh import P
    mesh = _mesh((4, 2), ("data", "fsdp"))
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(batch, 3, hw, hw).astype(np.float32))
    y = torch.as_tensor(rs.randint(0, 1000, (batch,)).astype(np.int32))
    mx.random.seed(0)
    with mx.gpu(0):
        net = resnet50_v1(layout="NHWC")
        net.initialize()
        net(mx.nd.array(x[:1].numpy()))
    step, p, aux, st = dp.make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.05, momentum=0.9, mesh=mesh, data_axes=("data",),
        param_spec=P("fsdp"))
    losses, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with C.timing() as comm:
            p, aux, st, loss = step(p, aux, st, x, y)
            losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet50-dp-fsdp: losses {losses}")
    return {"losses": losses, "step_ms": ms, "comm_s": comm[0]}


def _pipe_case(n, d, T):
    g = torch.Generator().manual_seed(0)

    def w(*shape):
        return torch.randn((n,) + shape, generator=g) * 0.05

    st = {"ln1_g": torch.ones(n, d), "ln1_b": torch.zeros(n, d),
          "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
          "ln2_g": torch.ones(n, d), "ln2_b": torch.zeros(n, d),
          "w1": w(d, 2 * d), "b1": torch.zeros(n, 2 * d),
          "w2": w(2 * d, d), "b2": torch.zeros(n, d)}
    x = torch.randn(2 * n, T, d, generator=g) * 0.5
    y = torch.randn(2 * n, T, d, generator=g) * 0.5
    return st, x, y


def _ln(a, g, b):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    return (a - mu) / torch.sqrt(var + 1e-5) * g + b


def _block(p, a, n_heads):
    """The dry run's stage: pre-LN causal attention and a GELU MLP."""
    mb, T, d = a.shape
    hd = d // n_heads
    h = _ln(a, p["ln1_g"], p["ln1_b"])
    q, k, v = ((h @ p[w]).reshape(mb, T, n_heads, hd)
               for w in ("wq", "wk", "wv"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    a = a + ctx.reshape(mb, T, d) @ p["wo"]
    h = _ln(a, p["ln2_g"], p["ln2_b"])
    return a + torch.nn.functional.gelu(h @ p["w1"] + p["b1"],
                                        approximate="tanh") @ p["w2"] \
        + p["b2"]


def pipe_transformer(rank, n=8, d=256, heads=4, T=16):
    """gpipe against the sequential run (the dry run's checks)."""
    _setup()
    from incubator_mxnet_tpu_torch.parallel.pipeline import gpipe
    mesh = _mesh((n,), ("pipe",))
    st, x, y = _pipe_case(n, d, T)
    x, y = x.cuda(), y.cuda()
    names = sorted(st)

    def pipe_loss(ws):
        out = gpipe(lambda p, a: _block(p, a, heads), dict(zip(names, ws)),
                    x, n, mesh=mesh)
        return ((out - y) ** 2).mean()

    def seq_loss(ws):
        a = x
        for i in range(n):
            a = _block({k: w[i] for k, w in zip(names, ws)}, a, heads)
        return ((a - y) ** 2).mean()

    res = []
    for fn in (pipe_loss, seq_loss):
        ws = [st[k].cuda().requires_grad_(True) for k in names]
        val = fn(ws)
        res.append((float(val), torch.autograd.grad(val, ws)))
    (pl, pg), (sl, sg) = res
    if not (np.isfinite(pl) and abs(pl - sl) <= 1e-5 + 1e-4 * abs(sl)):
        raise AssertionError(f"pipeline loss {pl} vs sequential {sl}")
    worst = 0.0
    for k, a, b in zip(names, pg, sg):
        err = ((a - b).abs() - 5e-4 * b.abs()).max().item()
        worst = max(worst, (a - b).abs().max().item())
        if err > 1e-6:
            raise AssertionError(f"pipeline grad {k} off by {err}")
    post = float(pipe_loss([st[k].cuda() - 0.1 * g
                            for k, g in zip(names, pg)]))
    if not post < pl:
        raise AssertionError(f"pipeline step did not lower the loss: "
                             f"{pl} -> {post}")
    return {"loss": pl, "sequential": sl, "post_step": post,
            "max_grad_diff": worst}


def nccl_trivial(rank, T=512, batch=8, layers=2):
    """The LM mesh step at depth 2 on the 1-rank NCCL world's trivial
    mesh, its loss all-reduced over NCCL, against the single-device
    step."""
    _setup()
    import torch.distributed as dist
    from incubator_mxnet_tpu_torch.models import transformer as tt
    mesh = _mesh((1,) * 6, backend="nccl")
    cfg = tt.TransformerConfig(dtype=torch.bfloat16,
                               **dict(FULL_WIDTH, n_layers=layers))
    step, params, opt = tt.make_transformer_train_step(
        cfg, mesh=mesh, learning_rate=LR, seed=0)
    tok, lab = _batch(cfg.vocab_size, batch, T)
    params, opt, lv, ms, comm, counts = _timed_step(step, params, opt, tok,
                                                    lab)
    red = torch.tensor([lv], device="cuda:0")
    dist.all_reduce(red)
    torch.cuda.synchronize()
    (sloss,), sp, sm = _single_steps(cfg, tok, lab, steps=1)
    worst, apart = _tree_diff(params, sp)
    cos, scale = _tree_cos(opt["m"], sm)
    return {"backend": dist.get_backend(), "loss": lv,
            "nccl_all_reduce": red.item(), "single_loss": sloss,
            "max_abs_param": worst, "share_apart": apart, "min_cos_m": cos,
            "max_norm_ratio_off": scale, "step_ms": ms, "launches": counts}


# ---------------------------------------------------------------- the phase
def _check_launches(r, n_layers):
    """Each step's flash launches on this rank: 12 * (seq rank + 1) of
    each kernel, every one on the Hopper route that ``flash_train_route``
    gives the step's type (wgmma for bf16, mma for float32). Returns
    (the launches a step, {route: this rank's launches of each kernel on
    it over the run})."""
    from incubator_mxnet_tpu_torch.ops.cuda.flash_attention import \
        flash_train_route
    want = n_layers * (r["coords"]["seq"] + 1)
    by_route = {"wgmma": {"steps": 0}, "mma": {"steps": 0}}
    for i, (counts, dt) in enumerate(zip(r["launches"], r["dtype"])):
        for name, (n, wgmma, mma) in counts.items():
            route = flash_train_route(getattr(torch, dt.split(".")[-1]),
                                      name)
            on = {"wgmma": wgmma, "mma": mma}
            if n != want or on[route] != n:
                raise AssertionError(
                    f"rank {r['rank']} step {i + 1} ({dt}): {name} launched "
                    f"{n} ({on} by route), want {want} on {route}")
            for k, v in on.items():
                by_route[k][name] = by_route[k].get(name, 0) + v
        for k in by_route:
            by_route[k]["steps"] += any(c[1 if k == "wgmma" else 2]
                                        for c in counts.values())
    return want, by_route


def mesh_phase(log, records=None, budget_s=120.0):
    """Phase 32 (the module's note). ``log`` prints a line; ``records``,
    the kernels line's records, get the flash rows' mesh launches."""
    from incubator_mxnet_tpu_torch.parallel.world import LocalWorld
    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mesh_phase_")
    rec = {}
    try:
        t0 = time.perf_counter()
        with LocalWorld(8, os.path.join(root, "gloo"), backend="gloo",
                        device="cuda:0", timeout=180) as world:
            world.wait()                     # the ranks have joined
            rec["world_start_s"] = time.perf_counter() - t0
            errs = world.run(ring_kernel_check, timeout=180)
            rec["ring_kernel_vs_plain"] = {
                dt: [max(e[dt][i] for e in errs) for i in range(4)]
                for dt in errs[0]}
            log(f"mesh ring on the flash kernels against the plain ring "
                f"(relative, max over ranks; out, dq, dk, dv): "
                f"{rec['ring_kernel_vs_plain']}")
            full = world.run(lm_full_width, timeout=300)
            rec["dp-tp-sp"] = _full_record(full, log)
            for mode, tag in (("ulysses", "dp-tp-ulysses"),
                              ("fsdp-ep", "dp-fsdp-ep")):
                res = world.run(lm_dryrun, mode, timeout=180)
                rec[tag] = {"loss": res[0]["loss"],
                            "step_ms": [r["step_ms"] for r in res],
                            "comm_share": [r["comm_s"] * 1e3 / r["step_ms"]
                                           for r in res],
                            "flash_launches": [
                                r["launches"]["flash_fwd"][0] for r in res]}
                log(f"mesh {tag}: {rec[tag]}")
            res = world.run(resnet_dp_fsdp, timeout=180)
            rec["resnet50-dp-fsdp"] = {
                "losses": res[0]["losses"],
                "step_ms": [r["step_ms"][-1] for r in res],
                "comm_share": [r["comm_s"] * 1e3 / r["step_ms"][-1]
                               for r in res]}
            log(f"mesh resnet50-dp-fsdp: {rec['resnet50-dp-fsdp']}")
            res = world.run(pipe_transformer, timeout=180)
            rec["pipe-transformer"] = res[0]
            log(f"mesh pipe-transformer: {res[0]}")
        t0 = time.perf_counter()
        with LocalWorld(1, os.path.join(root, "nccl"), backend="nccl",
                        device="cuda:0", timeout=180) as world:
            (nc,) = world.run(nccl_trivial, timeout=180)
        nc["world_s"] = time.perf_counter() - t0
        # as the full-width step's checks (_full_record): the loss within
        # 5e-3, Adam's first moments (0.1 g) the single-device step's in
        # direction and scale; the 2 lr bound on the parameters only
        # catches a runaway or non-finite update
        if not (np.isfinite(nc["loss"]) and nc["backend"] == "nccl"
                and abs(nc["loss"] - nc["single_loss"])
                <= 5e-3 * abs(nc["single_loss"])
                and nc["max_abs_param"] <= 2 * LR + 1e-5
                and nc["min_cos_m"] >= 0.99
                and nc["max_norm_ratio_off"] <= 0.02):
            raise AssertionError(f"1-rank NCCL world: {nc}")
        rec["nccl-1-rank"] = nc
        log(f"mesh 1-rank NCCL world: {nc}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    if records is not None:
        _launch_records(records, rec["dp-tp-sp"])
    if rec["seconds"] > budget_s:
        log(f"mesh phase took {rec['seconds']:.1f} s, over its "
            f"{budget_s:.0f} s budget")
    return rec


def _full_record(full, log):
    """Checks and the record of the full-width dp-tp-sp run."""
    n_layers = FULL_WIDTH["n_layers"]
    losses = full[0]["losses"]
    if any(r["losses"] != losses for r in full):
        raise AssertionError("dp-tp-sp: ranks disagree on the loss")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"dp-tp-sp: losses {losses}")
    single = full[0]["single"]
    # bf16 step 1 against the single-device step from the same weights:
    # the loss before and after it within the bf16 parity tolerance
    # (5e-3); the first moments (0.1 g) point the same way (cosine >= 0.99
    # a leaf) at the same scale (norms within 2%), which a gradient summed
    # over the wrong ranks would miss by a factor of 2. Adam's first step
    # moves each weight by about lr whatever the gradient, so the 2 lr
    # bound on the parameters only catches a runaway or non-finite update
    if any(abs(a - b) > 5e-3 * abs(b)
           for a, b in zip(losses[:2], single["losses"])) or \
            single["max_abs_param"] > 2 * LR + 1e-5 or \
            single["min_cos_m"] < 0.99 or \
            single["max_norm_ratio_off"] > 0.02:
        raise AssertionError(f"dp-tp-sp step 1 against one device: "
                             f"{single} (mesh losses {losses})")
    per_rank = {}
    for r in full:
        want, by_route = _check_launches(r, n_layers)
        prof = r["profiled"]
        busy = prof["device_busy_ms"]
        per_rank[r["rank"]] = {
            "seq": r["coords"]["seq"], "launches_per_step": want,
            "launches_by_route": by_route,
            "step_ms": r["step_ms"],
            "comm_share": [c * 1e3 / ms for c, ms in
                           zip(r["comm_s"], r["step_ms"])],
            "profiled_step": prof,
            # this rank's device time in the profiled step over the last
            # unprofiled step's wall (both float32 steps)
            "device_busy_share": (None if busy is None
                                  else busy / r["step_ms"][-1]),
            "peak_gb": r["peak_gb"]}
    busy = [r["profiled"]["device_busy_ms"] for r in full]
    rec = {"losses": losses, "single_step": single,
           "dtype_by_step": full[0]["dtype"], "ranks": per_rank,
           # the ranks' device time summed over one rank's wall: the card
           # is one, so above 1 would mean a time-sliced kernel's record
           # holds the others' time too
           "card_busy_share_summed": (
               None if None in busy
               else sum(busy) / max(r["step_ms"][-1] for r in full))}
    log(f"mesh dp-tp-sp full width: {rec}")
    return rec


def _launch_records(records, full):
    """The flash rows' launches in the mesh run, as counted on its route:
    each rank's, by seq rank (the mma rows for the float32 kernels, the
    wgmma rows for the bf16 ones, whose backward row is the pair)."""
    rows = {"flash_fwd": ("mma", ("flash_fwd",)),
            "flash_bwd_dq": ("mma", ("flash_bwd_dq",)),
            "flash_bwd_dkv": ("mma", ("flash_bwd_dkv",)),
            "flash_fwd/wgmma": ("wgmma", ("flash_fwd",)),
            "flash_bwd_pair/wgmma": ("wgmma", ("flash_bwd_dq",
                                               "flash_bwd_dkv"))}
    ranks = full["ranks"]
    for row, (route, kernels) in rows.items():
        if row not in records:
            continue
        by_seq = {}
        for r in ranks.values():
            got = sum(r["launches_by_route"][route].get(k, 0)
                      for k in kernels)
            by_seq.setdefault(r["seq"], set()).add(got)
        steps = {r["launches_by_route"][route]["steps"]
                 for r in ranks.values()}
        records[row]["mesh_launches"] = {
            "route": route, "ranks": len(ranks), "steps": sorted(steps),
            "per_rank_by_seq_rank": [sorted(by_seq[s])
                                     for s in sorted(by_seq)]}
