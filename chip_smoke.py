"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four main paths on the card and holds every CUDA kernel
of them against its plain PyTorch version:

* generative LM serving through ``InferenceEngine.load_model(generate=...)``
  at full width (d_model 768, 12 heads, 12 layers, d_ff 3072, vocab 32768,
  cache 512, page 64, 8 slots, bf16, random weights from a seed);
* single-device LM training through ``make_transformer_train_step`` at the
  same width (batch 32, T 512, bf16 init, causal; the reference's Adam
  promotes the parameters to float32 after the first step);
* the imperative ``nd`` + ``autograd`` API: a user loop over the same LM
  written with ``nd`` ops (``models/nd_lm.py``), float32, stepped with
  ``nd.adam_update``;
* Gluon ResNet-50 v1 training at bench.py's lane (NHWC, batch 128,
  224 x 224, bf16 compute on float32 masters, SGD momentum 0.9) through
  ``parallel.dp.make_train_step``, with the fused conv + BN + ReLU stages
  (``MXTPU_FUSED_RESNET=1``) and without them.

Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of the kernels from ``incubator_mxnet_tpu_torch/ops/cuda/csrc``;
3. the decode kernels against their plain versions at the serving shapes
   with ragged lengths, in float32 (atol 2e-5) and bf16 (atol 2e-2), and
   their time beside the plain version's, one PyTorch library call's
   (where one computes the same function) and the least time the card
   could take (bytes the call must move at 3.35 TB/s, or its flops at the
   peak rate of the input type, whichever is larger);
4. serving: ~16 prompts of 8..200 tokens on the paged engine (some share a
   64-token prefix, one is sampled), then a short pass on the contiguous
   engine; every request must finish with its token budget, every page must
   come back, and each kernel must have been launched by the run (launch
   counters are reset right before each run and read right after); then a
   torch.profiler breakdown of decode steps (busy and wall time from one
   profiled window; device idle share, the attention kernel's time);
5. one full-width float32 decode step (paged and contiguous) with the
   kernels against the same step with the plain attention (atol 1e-3);
6. the training kernels (flash forward, dq, dk/dv) against their plain
   twins, in float32 (atol 1e-4 forward, 1e-3 gradients) and bf16 (2e-2,
   5e-2), in the packed and head-major layouts: first a sweep of small
   shapes (head dims 32/64/128, a tail tile, sq != sk, causal and not),
   then at B 32, H 12, T 512, d 64, causal, with their times, SDPA's and
   the bounds as in phase 3 (and the backward pair's minimal bound);
7. training: 2 warm-up steps, then 5 timed steps with the launch counters
   reset before them; the loss must be finite and fall, and each training
   kernel must be launched 12 times per step; then a torch.profiler
   breakdown of two more steps, with busy and wall time from the same
   profiled window;
8. the head-major route: a 2-layer step at d_model 576, 9 heads (packed
   rows not a multiple of 128) must launch the same kernels;
9. one full-width float32 loss-and-gradient pass with the kernels against
   the same pass with plain attention (loss rtol 1e-4, every gradient
   leaf within 1e-3 of its largest entry);
10. the row kernels (layer-norm forward and backward, softmax) against
   their twins in float32 (atol 1e-5 forward, 1e-4 gradients) and bf16
   (2e-2, 5e-2, scaled by the magnitude above 1) over d 64..32768, the
   inline route (rows not a multiple of 8: nothing launched), then at the
   slice's shapes (LN (16384, 768); softmax (196608, 512), the scores of
   B 32, H 12, T 512) with times beside the twin, the library call and
   the byte bound;
11. the nd loop at bench.py's width (d 768, 12 heads, d_ff 3072, 12
   layers, vocab 32768, T 512, batch 32, float32): 2 warm-up and 5 timed
   steps; the loss must be finite and fall, and each step must launch the
   LN kernels 25 times each and the softmax kernel 12 times; then a
   profiled window of two steps (busy, idle, the row kernels' share);
12. at the same width, the nd loop's loss and gradients against the
   functional ``transformer_loss_and_grads`` with plain attention (loss
   rtol 1e-4, every gradient leaf within 1e-3 of its largest entry);
13. the fused-conv kernels (``mm_fused``, ``mm_fused_bwd``,
   ``conv3_fused``, ``conv3_fused_bwd``, ``dgrad_epilogue``) against their
   twins in float32 (1e-4) and bf16 (2e-2), errors over max(1, the twin's
   largest entry): a sweep of every load form, stats on and off, the x^
   output, bias, G direct and from batch norm, each mask, 0-2 partners,
   dsc, 3x3 at 7/14/28 with 1-3 images, the dual dgrad; then at the
   ResNet-50 lane's shapes, every conv form of each stage (2-4): block 0's
   conv1 and projection and their dual dgrad, a middle block's entry-form
   conv1, 3x3 and expand conv3, forward and backward, with times beside
   the twin's, the library product's (``torch.matmul``, channels-last
   ``F.conv2d``) and the bound from the reference's cost counts;
14. ResNet-50 v1 training at bench.py's lane with ``MXTPU_FUSED_RESNET=1``
   and ``MXTPU_BN_IMPL=plain``: 2 warm-up and 5 timed steps; finite,
   falling loss; per step 29 ``mm_fused``, 13 ``conv3_fused``, 23
   ``mm_fused_bwd``, 13 ``conv3_fused_bwd`` and 3 ``dgrad_epilogue``
   launches; img/s, peak memory, and a profiled window of two steps;
15. the same step on the per-block path (``MXTPU_FUSED_RESNET=0``: PyTorch
   convolutions and batch norm), run as phase 14 runs it: its img/s, no
   fused-conv launch, and a profiled window of two steps;
16. float32 at 224 x 224, batch 16: each fused stage against the per-block
   path (forward, dx and every non-bias parameter gradient; see
   ``resnet_truth_phase``), beside two control readings: the same fused
   stage on the plain twins, and the kernels' stage against the twins';
   then the whole net's first-step loss, fused against per-block (rtol
   1e-3).

Any failure raises, so the exit code is not 0. The last three lines of
standard output are the kernels' JSON record, the card line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- kernels
def kernel_checks(fa):
    """Phase 3: parity and timing of both kernels at the serving shapes."""
    S, H, d, C, P = 8, 12, 64, 512, 64
    n_pages, max_pages = S * C // P, C // P
    lengths_list = [8, 64, 65, 129, 200, 264, 333, 512]   # ragged
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    bt = torch.randperm(n_pages, generator=g, device="cuda").reshape(
        S, max_pages).to(torch.int32)
    for s, n in enumerate(lengths_list):       # dead pages -> trash page
        bt[s, -(-n // P):] = n_pages
    records = {}
    for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dt)
        q = rnd(S, H, d)
        kc, vc = rnd(S, H, C, d), rnd(S, H, C, d)
        kp, vp = rnd(n_pages + 1, H, P, d), rnd(n_pages + 1, H, P, d)
        kp[n_pages] = 1e4
        vp[n_pages] = -1e4                     # finite garbage, never read
        cases = {
            "flash_decode_step": (
                lambda k, v: fa.flash_decode_step(q, k, v, lengths,
                                                  block_k=P),
                lambda k, v: fa.decode_attention_reference(q, k, v, lengths,
                                                           block_k=P),
                (kc, vc)),
            "flash_decode_step_paged": (
                lambda k, v: fa.flash_decode_step_paged(q, k, v, bt,
                                                        lengths),
                lambda k, v: fa.paged_decode_attention_reference(
                    q, k, v, bt, lengths),
                (kp, vp)),
        }
        for name, (kern, plain, (k, v)) in cases.items():
            out = kern(k, v)
            torch.cuda.synchronize()
            ref = plain(k, v)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or err > atol:
                raise AssertionError(f"{name} {dt}: max |kernel - plain| "
                                     f"{err} > {atol}")
            log(f"parity {name} {str(dt)[6:]}: max_abs_err {err:.3g} "
                f"(atol {atol})")
            if dt != torch.bfloat16:
                continue
            # timing at the served type; K/V rotate through enough copies
            # to exceed the 50 MB L2, as 12 layers' caches do when serving
            n_rot = max(2, -(-120_000_000 // (2 * k.nbytes)))
            rot = [(k.clone(), v.clone()) for _ in range(n_rot)]
            it = iter(range(1 << 30))

            def run(f):
                kk, vv = rot[next(it) % n_rot]
                return f(kk, vv)
            ms = time_ms(lambda: run(kern))
            plain_ms = time_ms(lambda: run(plain), iters=10, warmup=2)
            library_ms = None
            if name == "flash_decode_step":
                mask = (torch.arange(C, device="cuda")[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                library_ms = time_ms(lambda: run(
                    lambda kk, vv: sdpa(q[:, :, None], kk, vv,
                                        attn_mask=mask)))
            esz = q.element_size()
            kv_bytes = 2 * sum(lengths_list) * H * d * esz
            idx_bytes = lengths.nbytes + (bt.nbytes if "paged" in name
                                          else 0)
            moved = kv_bytes + 2 * q.nbytes + idx_bytes
            flops = 4 * sum(lengths_list) * H * d
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dt] * 1e3
            records[name] = {
                "name": name, "route": "cuda",
                "source": "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
                          "decode_attention.cu",
                "replaces": ("incubator_mxnet_tpu/ops/pallas/"
                             "flash_attention.py:1417" if "paged" not in name
                             else "incubator_mxnet_tpu/ops/pallas/"
                                  "flash_attention.py:1559"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
            }
            log(f"time {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms} ms, bound {max(t_bytes, t_ops):.4f} "
                f"ms ({moved / 1e6:.2f} MB at 3.35 TB/s)")
            del rot
    return records


# ---------------------------------------------------------------- serving
def _consume(fut, stamps):
    for _ in fut.stream(timeout=300.0):
        stamps.append(time.perf_counter())


def open_engine(serving, params, cfg, gen_kw, warm_prompt):
    """A fresh engine with the model loaded and warmed by one short
    request (first-call set-up stays out of the measured run)."""
    eng = serving.InferenceEngine(device="cuda")
    try:
        ep = eng.load_model("lm", generate={"params": params, "cfg": cfg,
                                            **gen_kw})
        ep.generate(warm_prompt, max_new_tokens=4, timeout=300.0)
        torch.cuda.synchronize()
        return eng, ep
    except BaseException:
        eng.close()
        raise


def drive(ep, prompts, max_new, sampled=()):
    futs, stamps, threads = [], [], []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        kw = ({"temperature": 0.8, "top_k": 50, "seed": 1}
              if i in sampled else {})
        f = ep.submit(p, max_new_tokens=max_new, **kw)
        st = []
        th = threading.Thread(target=_consume, args=(f, st), daemon=True)
        th.start()
        futs.append(f)
        stamps.append(st)
        threads.append(th)
        if i == 0:                        # first token: its prefix
            deadline = time.monotonic() + 300.0   # pages are published
            while not st and not f.done():
                if time.monotonic() > deadline:
                    raise AssertionError("no first token in 300 s")
                time.sleep(0.001)
    for th in threads:
        th.join(timeout=300.0)
        if th.is_alive():
            raise AssertionError("a generation did not finish in 300 s")
    wall = time.perf_counter() - t0
    outs = [f.result(1.0) for f in futs]
    for o in outs:
        if len(o) != max_new:
            raise AssertionError(f"a request emitted {len(o)} of its "
                                 f"{max_new}-token budget")
    return futs, stamps, outs, wall


def wait_pages_free(ep, timeout=30.0):
    deadline = time.monotonic() + timeout
    while (ep.slots_in_use or ep.pool.in_use() or ep.pool.reserved) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    if ep.slots_in_use or ep.pool.in_use() or ep.pool.reserved:
        raise AssertionError(
            f"leak: {ep.slots_in_use} slots, {ep.pool.in_use()} pages, "
            f"{ep.pool.reserved} reserved after all requests finished")


def serving_phase(serving, tt, fa, records):
    cfg = tt.TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                               d_ff=3072, n_layers=12, max_len=512,
                               dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = tt.init_transformer_params(g, cfg, device="cuda")
    rng = np.random.RandomState(SEED)
    # 16 prompts of 8..200 tokens; every third one (the first included)
    # starts with the same 64-token prefix, one page of the pool
    prefix = rng.randint(0, cfg.vocab_size, 64)
    prompts = []
    for i in range(16):
        if i % 3 == 0:
            tail = rng.randint(0, cfg.vocab_size, rng.randint(8, 137))
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rng.randint(0, cfg.vocab_size,
                                       rng.randint(8, 201)).astype(np.int32))
    max_new = 48
    warm = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)

    # paged engine: the default
    eng, ep = open_engine(serving, params, cfg, {}, warm)
    try:
        hits0 = eng.stats()["lm"]["prefix_hits"]
        fa.reset_launch_counts()
        futs, stamps, outs, wall = drive(ep, prompts, max_new, sampled={5})
        paged_launches = fa.launch_counts()
        wait_pages_free(ep)
        st = eng.stats()["lm"]
        breakdown = decode_breakdown(ep.model)
    finally:
        eng.close()
    for o in outs:
        if not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError("token id out of vocabulary")
    if st["prefix_hits"] - hits0 < 1:
        raise AssertionError("the shared prefix never hit the prefix cache")
    ttft = [s[0] - f.t_submit for f, s in zip(futs, stamps)]
    itl = [b - a for s in stamps for a, b in zip(s, s[1:])]
    n_tok = sum(len(o) for o in outs)
    log(f"serve paged: {len(prompts)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tok/s; TTFT p50 "
        f"{np.median(ttft) * 1e3:.2f} ms, ITL p50 "
        f"{np.median(itl) * 1e3:.2f} ms; prefix hits "
        f"{st['prefix_hits'] - hits0}; launches {paged_launches}")
    if paged_launches["flash_decode_step_paged"] < 1:
        raise AssertionError("paged serving never launched its kernel")

    # contiguous engine: a short pass
    short = prompts[1:5]
    eng, ep = open_engine(serving, params, cfg, {"paged": 0}, warm)
    try:
        fa.reset_launch_counts()
        _, _, outs_c, wall_c = drive(ep, short, 16)
        contig_launches = fa.launch_counts()
    finally:
        eng.close()
    log(f"serve contiguous: {len(short)} requests, "
        f"{sum(map(len, outs_c))} tokens in {wall_c:.3f} s; launches "
        f"{contig_launches}")
    if contig_launches["flash_decode_step"] < 1:
        raise AssertionError("contiguous serving never launched its kernel")
    records["flash_decode_step_paged"]["launches"] = \
        paged_launches["flash_decode_step_paged"]
    records["flash_decode_step"]["launches"] = \
        contig_launches["flash_decode_step"]
    return {"tok_s": n_tok / wall, "ttft_p50_ms": np.median(ttft) * 1e3,
            "itl_p50_ms": np.median(itl) * 1e3, **breakdown}


def decode_breakdown(model, steps: int = 10):
    """Device time torch.profiler records for ``steps`` full-width decode
    steps (8 live slots, lengths 50..200, greedy) against the wall time of
    the same steps, both taken in one profiled window: the device's busy
    and idle shares, and the attention kernel's time. The wall time of as
    many unprofiled steps is kept beside it (``step_wall_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    S = model.slots
    bts = np.full((S, model.max_pages), model.trash_page, np.int32)
    for s in range(S):
        bts[s, :4] = np.arange(4 * s, 4 * s + 4)
    pos = np.array([50, 100, 150, 200, 60, 70, 80, 90][:S])
    tok = np.arange(S)
    z, zi = np.zeros(S, np.float32), np.zeros(S, np.int64)

    def step():
        model.decode(tok, pos, z, zi, z, zi, block_tables=bts)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    attn_ms = sum(e.self_device_time_total for e in dev
                  if "decode_attn_kernel" in e.key) / steps / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if busy_ms > prof_wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {prof_wall_ms} ms")
    out = {"step_wall_ms": wall_ms, "profiled_step_wall_ms": prof_wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / prof_wall_ms,
           "attention_kernel_ms": attn_ms}
    log(f"decode step breakdown: {json.dumps(out)} (busy over the "
        f"unprofiled steps' wall, the former reading: idle "
        f"{1 - busy_ms / wall_ms:.4f})")
    return out


# ---------------------------------------------------- full-width f32 step
def f32_step_phase(tt, fa):
    cfg = tt.TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                               d_ff=3072, n_layers=12, max_len=512,
                               dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = tt.init_transformer_params(g, cfg, device="cuda")
    rng = np.random.RandomState(SEED + 1)
    S, P = 4, 64
    lens = [17, 64, 130, 300]
    dev = "cuda"
    with torch.inference_mode():
        paged = tt.init_paged_kv_cache(cfg, S * 8, P, device=dev)
        cont = tt.init_kv_cache(cfg, S, 512, device=dev)
        bts = torch.full((S, 8), S * 8, dtype=torch.int32, device=dev)
        perm = torch.randperm(S * 8, generator=g, device=dev).reshape(S, 8)
        toks = []
        for s, n in enumerate(lens):
            need = -(-(n + 1) // P)           # prompt + the decoded token
            bts[s, :need] = perm[s, :need].int()
            p = torch.tensor(rng.randint(0, cfg.vocab_size, (1, n)),
                             device=dev)
            _, logits = tt.transformer_prefill_paged(params, p, cfg, paged,
                                                     bts[s], 0, n)
            tt.transformer_prefill(params, p, cfg, cont, s, n)
            toks.append(int(logits.argmax()))
        tok = torch.tensor(toks, device=dev)
        pos = torch.tensor(lens, device=dev)
        results = {}
        for name, step, cache, attn, plain in (
                ("paged", lambda c: tt.transformer_decode_step_paged(
                    params, tok, pos, c, bts, cfg)[1], paged,
                 "paged_decode_attention",
                 fa.paged_decode_attention_reference),
                ("contiguous", lambda c: tt.transformer_decode_step(
                    params, tok, pos, c, cfg, block_k=P)[1], cont,
                 "decode_attention", fa.decode_attention_reference)):
            kern_logits = step({k: v.clone() for k, v in cache.items()})
            real = getattr(tt, attn)
            setattr(tt, attn, plain)           # the same step, plain attn
            try:
                plain_logits = step({k: v.clone() for k, v in
                                     cache.items()})
            finally:
                setattr(tt, attn, real)
            torch.cuda.synchronize()
            if kern_logits.shape != (S, cfg.vocab_size) or \
                    not torch.isfinite(kern_logits).all():
                raise AssertionError(f"{name}: bad logits")
            err = (kern_logits - plain_logits).abs().max().item()
            log(f"f32 full-width decode step ({name}): max |kernel - "
                f"plain| logits {err:.3g} (atol 1e-3)")
            if err > 1e-3:
                raise AssertionError(f"{name} decode step logits differ "
                                     f"by {err}")
            results[name] = err
    return results


# ------------------------------------------------------ training kernels
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# (forward atol, gradient atol) per input type
TRAIN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 5e-2)}


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def train_kernel_sweep(fa, g):
    """Phase 6, first part: every training kernel against its plain twin
    on the shapes the main path does not reach at full width: head dims
    32, 64 and 128; T 200 (a tail tile of 8 rows), sq 96 / sk 160 and
    sq 160 / sk 96 (key tiles no query row reaches under the top-left
    causal mask); causal and not; both layouts and both types; B 2, H 4.
    Tolerances as at the training shapes. Returns the worst error per
    kernel and type."""
    B, H = 2, 4
    worst = {}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = TRAIN_TOL[dt]
        for d in (32, 64, 128):
            for sq, sk in ((200, 200), (96, 160), (160, 96)):
                def rnd(t):
                    return torch.randn((B, H, t, d), generator=g,
                                       device="cuda").to(dt)
                hm = [rnd(sq), rnd(sk), rnd(sk), rnd(sq)]
                for causal in (True, False):
                    for n_heads in (H, None):
                        if n_heads:
                            q, k, v, do = (x.transpose(1, 2).reshape(
                                B, x.shape[2], H * d).contiguous()
                                for x in hm)
                        else:
                            q, k, v, do = hm
                        kw = dict(causal=causal, n_heads=n_heads)
                        out, lse = fa.flash_fwd(q, k, v, **kw)
                        ref_out, ref_lse = fa.flash_forward_reference(
                            q, k, v, **kw)
                        prod = do.float() * ref_out.float()
                        delta = (prod.view(B, sq, H, d).sum(-1) if n_heads
                                 else prod.sum(-1))
                        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta,
                                             **kw)
                        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse,
                                                  delta, **kw)
                        rq, rk, rv = fa.flash_backward_reference(
                            q, k, v, do, ref_lse, delta, **kw)
                        errs = {"flash_fwd": max(_max_err(out, ref_out),
                                                 _max_err(lse, ref_lse)),
                                "flash_bwd_dq": _max_err(dq, rq),
                                "flash_bwd_dkv": max(_max_err(dk, rk),
                                                     _max_err(dv, rv))}
                        finite = all(torch.isfinite(t).all() for t in
                                     (out, lse, dq, dk, dv))
                        for name, err in errs.items():
                            atol = atol_f if name == "flash_fwd" else atol_b
                            if not finite or err > atol:
                                raise AssertionError(
                                    f"{name} {dt} d {d} sq {sq} sk {sk} "
                                    f"causal {causal} "
                                    f"{'packed' if n_heads else 'head-major'}"
                                    f": max |kernel - plain| {err} > {atol}")
                            key = f"{name} {str(dt)[6:]}"
                            worst[key] = max(worst.get(key, 0.0), err)
                        n_cases += 1
    log(f"shape sweep: {n_cases} cases (d 32/64/128; T 200, sq 96 sk 160, "
        f"sq 160 sk 96; causal and not; both layouts and types) within "
        f"tolerance; worst max_abs_err {json.dumps(worst)}")
    return worst


def train_kernel_checks(fa):
    """Phase 6: parity and timing of the training kernels. Returns the
    JSON records (float32, packed: the timed training steps' type and
    layout) and a log of every timing."""
    B, H, T, d = 32, 12, 512, 64
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records, timings = {}, {}
    timings["sweep"] = train_kernel_sweep(fa, g)
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = TRAIN_TOL[dt]
        hm = [torch.randn((B, H, T, d), generator=g, device="cuda").to(dt)
              for _ in range(4)]
        for n_heads in (H, None):
            layout = "packed" if n_heads else "head-major"
            if n_heads:
                q, k, v, do = (x.transpose(1, 2).reshape(B, T, H * d)
                               .contiguous() for x in hm)
            else:
                q, k, v, do = hm
            kw = dict(causal=True, n_heads=n_heads)
            out, lse = fa.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_forward_reference(q, k, v, **kw)
            prod = do.float() * ref_out.float()
            delta = (prod.view(B, T, H, d).sum(-1) if n_heads
                     else prod.sum(-1))
            dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, **kw)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, **kw)
            torch.cuda.synchronize()
            rq, rk, rv = fa.flash_backward_reference(q, k, v, do, ref_lse,
                                                     delta, **kw)
            errs = {"flash_fwd": max(_max_err(out, ref_out),
                                     _max_err(lse, ref_lse)),
                    "flash_bwd_dq": _max_err(dq, rq),
                    "flash_bwd_dkv": max(_max_err(dk, rk),
                                         _max_err(dv, rv))}
            for name, err in errs.items():
                atol = atol_f if name == "flash_fwd" else atol_b
                finite = all(torch.isfinite(t).all() for t in
                             (out, lse, dq, dk, dv))
                if not finite or err > atol:
                    raise AssertionError(f"{name} {dt} {layout}: max "
                                         f"|kernel - plain| {err} > {atol}")
                log(f"parity {name} {str(dt)[6:]} {layout}: max_abs_err "
                    f"{err:.3g} (atol {atol})")
            if not n_heads:
                continue
            # timing in the main path's layout; every operand exceeds L2
            runs = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                              lambda: fa.flash_forward_reference(q, k, v,
                                                                 **kw)),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(
                    q, k, v, do, lse, delta, **kw), None),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(
                    q, k, v, do, lse, delta, **kw), None),
            }
            # one plain twin computes dq, dk and dv together
            bwd_plain_ms = time_ms(lambda: fa.flash_backward_reference(
                q, k, v, do, lse, delta, **kw), iters=3, warmup=1)
            qr, kr, vr = (x.detach().requires_grad_(True) for x in hm[:3])
            sdpa_fwd_ms = time_ms(lambda: sdpa(qr, kr, vr, is_causal=True))
            o = sdpa(qr, kr, vr, is_causal=True)
            sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
                o, (qr, kr, vr), hm[3], retain_graph=True))
            del o, qr, kr, vr
            esz = q.element_size()
            x_bytes = B * H * T * d * esz
            row_bytes = B * H * T * 4
            pairs = B * H * T * (T + 1) // 2      # causal (row, col) pairs
            work = {"flash_fwd": (4 * x_bytes + row_bytes, 4 * d * pairs),
                    "flash_bwd_dq": (5 * x_bytes + 2 * row_bytes,
                                     6 * d * pairs),
                    "flash_bwd_dkv": (6 * x_bytes + 2 * row_bytes,
                                      8 * d * pairs)}
            for name, (kern, plain) in runs.items():
                ms = time_ms(kern, iters=20)
                plain_ms = (time_ms(plain, iters=3, warmup=1) if plain
                            else bwd_plain_ms)
                moved, flops = work[name]
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dt] * 1e3
                rec = {
                    "name": name, "route": "cuda",
                    "source": "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
                              "flash_attention.cu",
                    "replaces": {
                        "flash_fwd": "incubator_mxnet_tpu/ops/pallas/"
                                     "flash_attention.py:699",
                        "flash_bwd_dq": "incubator_mxnet_tpu/ops/pallas/"
                                        "flash_attention.py:911",
                        "flash_bwd_dkv": "incubator_mxnet_tpu/ops/pallas/"
                                         "flash_attention.py:911"}[name],
                    "launches": 0, "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": sdpa_fwd_ms if name == "flash_fwd"
                    else None,
                }
                timings[f"{name} {str(dt)[6:]}"] = rec
                if dt == torch.float32:
                    records[name] = rec
                log(f"time {name} {str(dt)[6:]}: {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
            # the per-kernel bounds above count the two-pass recompute of
            # s and dP; the function the pair replaces needs 10 d flops per
            # causal pair and moves q, k, v, dO, lse, delta in and dq, dk,
            # dv out once
            t_bytes = (7 * x_bytes + 2 * row_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = 10 * d * pairs / PEAK_FLOPS[dt] * 1e3
            pair_ms = sum(timings[f"{n} {str(dt)[6:]}"]["ms"]
                          for n in ("flash_bwd_dq", "flash_bwd_dkv"))
            timings[f"flash_bwd_pair {str(dt)[6:]}"] = {
                "ms": pair_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": sdpa_bwd_ms}
            log(f"time flash_bwd_pair {str(dt)[6:]}: {pair_ms:.4f} ms, "
                f"minimal bound {max(t_bytes, t_ops):.4f} ms, SDPA backward "
                f"{sdpa_bwd_ms:.4f} ms")
            log(f"time sdpa causal {str(dt)[6:]}: forward {sdpa_fwd_ms:.4f}"
                f" ms, backward {sdpa_bwd_ms:.4f} ms")
            timings[f"sdpa {str(dt)[6:]}"] = {"fwd_ms": sdpa_fwd_ms,
                                              "bwd_ms": sdpa_bwd_ms}
    return records, timings


# --------------------------------------------------------------- training
def _train_cfg(tt, dtype, d_model=768, n_heads=12, n_layers=12):
    return tt.TransformerConfig(vocab_size=32768, d_model=d_model,
                                n_heads=n_heads, d_ff=4 * d_model,
                                n_layers=n_layers, max_len=512, dtype=dtype,
                                causal=True)


def _batch(rs, cfg, batch, seq=512):
    return tuple(torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                             (batch, seq))).cuda()
                 for _ in range(2))


def train_phase(tt, fa, records, steps=5):
    """Phase 7: full-width training (bench.py's configuration)."""
    cfg = _train_cfg(tt, torch.bfloat16)
    B, T = 32, 512
    step, params, opt = tt.make_transformer_train_step(cfg, seed=SEED,
                                                       device="cuda")
    tokens, labels = _batch(np.random.RandomState(0), cfg, B, T)
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launch_counts()
    losses = [float(x) for x in losses]
    timed_dtype = str(params["layers"][0]["wq"].dtype)[6:]
    log(f"train: losses {[round(x, 4) for x in losses]}; {steps} timed "
        f"steps in {wall:.3f} s = {wall / steps * 1e3:.1f} ms/step, "
        f"{B * T * steps / wall:.0f} tok/s; timed steps ran in "
        f"{timed_dtype}; launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    for name in TRAIN_KERNELS:
        if launches[name] != cfg.n_layers * steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} steps, not "
                                 f"{cfg.n_layers * steps}")
        records[name]["launches"] = launches[name]
    step_ms = wall / steps * 1e3
    breakdown = train_breakdown(step, params, opt, tokens, labels)
    return {"step_ms": step_ms, "tok_s": B * T * steps / wall,
            "timed_dtype": timed_dtype, "loss_first": losses[0],
            "loss_last": losses[-1], **breakdown}


def train_breakdown(step, params, opt, tokens, labels, steps: int = 2):
    """Device time torch.profiler records for ``steps`` training steps
    against the wall time of the same steps, both taken in one profiled
    window: busy and idle shares, the attention kernels' share, and the
    top device ops (all per step)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, opt, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    attn_ms = sum(e.self_device_time_total for e in dev
                  if any(f"{n}_kernel" in e.key for n in TRAIN_KERNELS)
                  ) / steps / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if busy_ms > wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {wall_ms} ms")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    out = {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "attention_kernels_ms": attn_ms,
           "attention_share_of_busy": attn_ms / busy_ms,
           "top_device_ops": [[e.key[:60],
                               e.self_device_time_total / steps / 1e3]
                              for e in top]}
    log(f"train step breakdown: {json.dumps(out)}")
    return out


def headmajor_phase(tt, fa, steps=2):
    """Phase 8: d_model 576 / 9 heads takes the head-major route; the
    same kernels must launch through ``flash_attention``."""
    cfg = _train_cfg(tt, torch.bfloat16, d_model=576, n_heads=9,
                     n_layers=2)
    B = 8
    if fa.flash_attention_packed_viable(512, cfg.d_model, cfg.n_heads, B):
        raise AssertionError("d_model 576 should not take the packed route")
    step, params, opt = tt.make_transformer_train_step(cfg, seed=SEED,
                                                       device="cuda")
    tokens, labels = _batch(np.random.RandomState(1), cfg, B)
    fa.reset_launch_counts()
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    launches = fa.launch_counts()
    log(f"head-major step (d_model 576, 9 heads): losses {losses}; "
        f"launches {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"head-major loss not finite: {losses}")
    for name in TRAIN_KERNELS:
        if launches[name] != cfg.n_layers * steps:
            raise AssertionError(f"head-major route: {name} launched "
                                 f"{launches[name]} times")
    return launches


def f32_train_step_phase(tt, fa):
    """Phase 9: the full-width float32 loss and gradients with the kernels
    against the same pass with plain attention."""
    cfg = _train_cfg(tt, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    params = tt.init_transformer_params(g, cfg, device="cuda")
    tokens, labels = _batch(np.random.RandomState(SEED + 2), cfg, 32)
    loss_k, grads_k = tt.transformer_loss_and_grads(params, tokens, labels,
                                                    cfg)

    def plain_packed(q, k, v, n_heads, causal=False, scale=None):
        B, T, HD = q.shape
        d = HD // n_heads

        def hm(t):
            return t.view(B, T, n_heads, d).transpose(1, 2)
        o = fa.mha_reference(hm(q), hm(k), hm(v), causal=causal,
                             scale=scale)
        return o.transpose(1, 2).reshape(B, T, HD)

    real = tt.flash_attention_packed
    tt.flash_attention_packed = plain_packed      # the same pass, plain
    try:
        loss_p, grads_p = tt.transformer_loss_and_grads(params, tokens,
                                                        labels, cfg)
    finally:
        tt.flash_attention_packed = real
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    leaves_k = tt._tree_leaves(grads_k)
    leaves_p = tt._tree_leaves(grads_p)
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(leaves_k, leaves_p))
    log(f"f32 full-width train pass: loss kernels {loss_k.item():.6f} "
        f"plain {loss_p.item():.6f} (rel {loss_err:.3g}, rtol 1e-4); "
        f"worst gradient leaf max|kernel - plain| / max|plain| {worst:.3g}"
        f" (1e-3) over {len(leaves_p)} leaves")
    if not np.isfinite(loss_k.item()) or loss_err > 1e-4 or worst > 1e-3:
        raise AssertionError("f32 train pass: kernels and plain attention "
                             f"disagree (loss {loss_err}, grads {worst})")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst}


# ------------------------------------------------------ row kernels (nd)
ROW_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "softmax_fwd")
# (forward atol, gradient atol) per input type. bf16 errors are scaled by
# the magnitude where it exceeds 1 (one bf16 ulp at |y| in [16, 32) is
# 0.125); the dgamma / dbeta column sums are held relative to their
# largest entry (sums of up to 16,384 rows)
ROW_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}
ROW_REPLACES = {
    "layer_norm_fwd": "incubator_mxnet_tpu/ops/pallas/layer_norm.py:59",
    "layer_norm_bwd": "incubator_mxnet_tpu/ops/pallas/layer_norm.py:92",
    "softmax_fwd": "incubator_mxnet_tpu/ops/pallas/softmax.py:26"}
ROW_SOURCES = {
    "layer_norm_fwd": "incubator_mxnet_tpu_torch/ops/cuda/csrc/layer_norm.cu",
    "layer_norm_bwd": "incubator_mxnet_tpu_torch/ops/cuda/csrc/layer_norm.cu",
    "softmax_fwd": "incubator_mxnet_tpu_torch/ops/cuda/csrc/softmax.cu"}


def _rel_err(a, b):
    return _max_err(a, b) / max(1.0, b.abs().max().item())


def _row_err(a, b):
    """max |a - b|, scaled by max(1, |b|) elementwise for bf16."""
    d = (a.float() - b.float()).abs()
    if a.dtype == torch.bfloat16:
        d = d / b.float().abs().clamp(min=1.0)
    return d.max().item()


def row_kernel_errors(ln, sm, n, d, dt, g):
    """Every row kernel against its twin on one (n, d) input: {kernel:
    error}, the LN backward's column sums relative to their largest
    entry."""
    x = torch.randn((n, d), generator=g, device="cuda").to(dt)
    gam = torch.randn((d,), generator=g, device="cuda")
    bet = torch.randn((d,), generator=g, device="cuda")
    dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
    y, mu, rstd = ln.layer_norm_fwd(x, gam, bet)
    ry, rmu, rrstd = ln.layer_norm_reference(x, gam, bet)
    dx, dg, db = ln.layer_norm_bwd(x, gam, rmu, rrstd, dy)
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, gam, rmu, rrstd, dy)
    p = sm.softmax_fwd(x)
    rp = sm.softmax_reference(x)
    torch.cuda.synchronize()
    outs = (y, mu, rstd, dx, dg, db, p)
    if not all(torch.isfinite(t).all() for t in outs):
        raise AssertionError(f"row kernels {dt} n {n} d {d}: non-finite "
                             "output")
    return {"layer_norm_fwd": max(_row_err(y, ry), _max_err(mu, rmu),
                                  _rel_err(rstd, rrstd)),
            "layer_norm_bwd": max(_row_err(dx, rdx),
                                  _rel_err(dg.sum(0), rdg.sum(0)),
                                  _rel_err(db.sum(0), rdb.sum(0))),
            "softmax_fwd": _row_err(p, rp)}


def row_kernel_checks(ln, sm, common):
    """Phase 10: the layer-norm and softmax kernels against their twins,
    first over a sweep of widths (d 64 .. 32768) and on the inline route
    (rows not a multiple of 8: no launch, the plain formula), then at the
    slice's shapes (LN (16384, 768), softmax (196608, 512): B 32, H 12,
    T 512 attention scores) with times beside the twin, the library call
    and the byte bound. Returns the JSON records (float32) and a log."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, timings = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = ROW_TOL[dt]
        for d in (64, 512, 768, 1024, 4096, 32768):
            n = 64 if d <= 4096 else 16
            errs = row_kernel_errors(ln, sm, n, d, dt, g)
            for name, err in errs.items():
                atol = atol_b if name == "layer_norm_bwd" else atol_f
                if err > atol:
                    raise AssertionError(f"{name} {dt} n {n} d {d}: max "
                                         f"|kernel - plain| {err} > {atol}")
                key = f"{name} {str(dt)[6:]}"
                worst[key] = max(worst.get(key, 0.0), err)
        # the inline route: 12 rows, not a multiple of 8
        common.reset_launch_counts()
        x = torch.randn((3, 4, 96), generator=g, device="cuda").to(dt)
        gam = torch.randn((96,), generator=g, device="cuda").to(dt)
        bet = torch.randn((96,), generator=g, device="cuda").to(dt)
        y = ln.layer_norm(x, gam, bet)
        p = sm.softmax(x)
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        ry = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) \
            * gam + bet
        counts = common.launch_counts()
        if any(counts[k] for k in ROW_KERNELS):
            raise AssertionError(f"the inline route launched {counts}")
        err = max(_max_err(y, ry), _max_err(p, torch.softmax(x, -1)))
        if err > atol_f:
            raise AssertionError(f"inline route {dt}: {err} > {atol_f}")
    log(f"row kernel sweep: d 64/512/768/1024/4096/32768, f32 and bf16, "
        f"within tolerance; inline route (12 rows) launched nothing; "
        f"worst {json.dumps(worst)}")
    timings["sweep"] = worst

    records = {}
    F = torch.nn.functional
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = ROW_TOL[dt]
        esz = torch.empty((), dtype=dt).element_size()
        n, d = 16384, 768
        e_ln = row_kernel_errors(ln, sm, n, d, dt, g)
        ns, ds = 196608, 512
        e_sm = row_kernel_errors(ln, sm, ns, ds, dt, g)
        errs = {"layer_norm_fwd": e_ln["layer_norm_fwd"],
                "layer_norm_bwd": e_ln["layer_norm_bwd"],
                "softmax_fwd": e_sm["softmax_fwd"]}
        for name, err in errs.items():
            atol = atol_b if name == "layer_norm_bwd" else atol_f
            if err > atol:
                raise AssertionError(f"{name} {dt} at the slice's shape: "
                                     f"{err} > {atol}")
            log(f"parity {name} {str(dt)[6:]}: max_abs_err {err:.3g} "
                f"(atol {atol})")
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        bet = torch.randn((d,), generator=g, device="cuda")
        dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
        _, mu, rstd = ln.layer_norm_fwd(x, gam, bet)
        s = torch.randn((ns, ds), generator=g, device="cuda").to(dt)
        xr = x.detach().requires_grad_(True)
        gr = gam.to(dt).requires_grad_(True)
        br = bet.to(dt).requires_grad_(True)
        y_lib = F.layer_norm(xr, (d,), gr, br, 1e-5)
        runs = {
            "layer_norm_fwd": (
                lambda: ln.layer_norm_fwd(x, gam, bet),
                lambda: ln.layer_norm_reference(x, gam, bet),
                lambda: F.layer_norm(x, (d,), gam.to(dt), bet.to(dt), 1e-5),
                2 * n * d * esz + 2 * d * 4 + 2 * n * 4, 8 * n * d),
            "layer_norm_bwd": (
                lambda: ln.layer_norm_bwd(x, gam, mu, rstd, dy),
                lambda: ln.layer_norm_backward_reference(x, gam, mu, rstd,
                                                         dy),
                lambda: torch.autograd.grad(y_lib, (xr, gr, br), dy,
                                            retain_graph=True),
                3 * n * d * esz + d * 4 + 2 * n * 4 + 2 * d * 4, 12 * n * d),
            "softmax_fwd": (
                lambda: sm.softmax_fwd(s),
                lambda: sm.softmax_reference(s),
                lambda: torch.softmax(s, -1),
                2 * ns * ds * esz, 5 * ns * ds),
        }
        for name, (kern, plain, lib, moved, flops) in runs.items():
            ms = time_ms(kern)
            plain_ms = time_ms(plain, iters=10, warmup=2)
            library_ms = time_ms(lib)
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
            rec = {"name": name, "route": "cuda",
                   "source": ROW_SOURCES[name],
                   "replaces": ROW_REPLACES[name], "launches": 0,
                   "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": library_ms}
            timings[f"{name} {str(dt)[6:]}"] = rec
            if dt == torch.float32:
                records[name] = rec
            log(f"time {name} {str(dt)[6:]}: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB at 3.35 "
                f"TB/s)")
        del x, dy, s, xr, gr, br, y_lib
    return records, timings


# ------------------------------------------------------ the nd slice
ND_CFG = dict(vocab_size=32768, d_model=768, n_heads=12, d_ff=3072,
              n_layers=12, max_len=512)


def _nd_lm_setup(tt, seed, B=32, T=512):
    """Full-width f32 parameters (the functional layout, random from a
    seed), their nd copy on the card, and one batch."""
    cfg = tt.TransformerConfig(dtype=torch.float32, causal=True,
                               use_flash_attention=False, **ND_CFG)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = tt.init_transformer_params(g, cfg, device="cuda")
    tree = tt._tree_map(lambda t: t.cpu().numpy(), params)
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return cfg, params, tree, tokens, labels


def nd_train_phase(tt, nd_lm, mx, common, records, steps=5):
    """Phase 11: an nd + autograd user loop over the LM at bench.py's
    width (d 768, 12 heads, d_ff 3072, 12 layers, vocab 32768, T 512,
    batch 32, float32): 2 warm-up and 5 timed Adam steps through
    nd.adam_update; the loss must be finite and fall and every step must
    launch the layer-norm kernels 25 times each and the softmax kernel 12
    times; then a profiled window of two steps."""
    cfg, _, tree, tokens, labels = _nd_lm_setup(tt, SEED + 3)
    ctx = mx.gpu(0)
    params = nd_lm.params_to_nd(tree, ctx=ctx)
    del tree
    tok = mx.nd.array(tokens, ctx=ctx)
    lab = mx.nd.array(labels, ctx=ctx)
    mask = nd_lm.causal_mask(tokens.shape[1], ctx=ctx)
    states, losses = {}, []

    def step(i):
        loss, _ = nd_lm.nd_lm_train_step(params, states, i, tok, lab,
                                         cfg.n_heads, mask)
        return loss

    torch.cuda.reset_peak_memory_stats()
    for i in (1, 2):
        losses.append(step(i))
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(3, 3 + steps):
        losses.append(step(i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    losses = [float(x.asscalar()) for x in losses]
    B, T = tokens.shape
    log(f"nd train: losses {[round(x, 4) for x in losses]}; {steps} timed "
        f"steps in {wall:.3f} s = {wall / steps * 1e3:.1f} ms/step, "
        f"{B * T * steps / wall:.0f} tok/s; launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"nd loss not finite and falling: {losses}")
    per_step = {"layer_norm_fwd": 2 * cfg.n_layers + 1,
                "layer_norm_bwd": 2 * cfg.n_layers + 1,
                "softmax_fwd": cfg.n_layers}
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} nd steps, not {n * steps}")
        records[name]["launches"] = launches[name]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    breakdown = nd_breakdown(lambda: step(99))
    return {"step_ms": wall / steps * 1e3, "tok_s": B * T * steps / wall,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, **breakdown}


def nd_breakdown(step, steps: int = 2):
    """Busy and wall time of ``steps`` nd steps from one profiled window:
    idle share, the row kernels' share of busy time, and the top device
    ops (all per step)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    names = ("ln_fwd_warp_kernel", "ln_fwd_block_kernel", "ln_bwd_kernel",
             "softmax_warp_kernel", "softmax_block_kernel")
    row = {n: sum(e.self_device_time_total for e in dev if n in e.key)
           / steps / 1e3 for n in names}
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if busy_ms > wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {wall_ms} ms")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    row_ms = sum(row.values())
    out = {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "row_kernels_ms": row_ms,
           "row_kernels_share_of_busy": row_ms / busy_ms,
           "row_kernel_ms": {k: v for k, v in row.items() if v},
           "top_device_ops": [[e.key[:60],
                               e.self_device_time_total / steps / 1e3]
                              for e in top]}
    log(f"nd step breakdown: {json.dumps(out)}")
    return out


def nd_truth_phase(tt, nd_lm, mx):
    """Phase 12: at full width, the nd loop's float32 loss and gradients
    against the functional transformer_loss_and_grads with plain
    attention, on the same parameters and batch (loss rtol 1e-4, every
    gradient leaf within 1e-3 of its largest entry)."""
    cfg, params, tree, tokens, labels = _nd_lm_setup(tt, SEED + 4)
    ctx = mx.gpu(0)
    nd_params = nd_lm.params_to_nd(tree, ctx=ctx)
    del tree
    T = tokens.shape[1]
    with mx.autograd.record():
        loss = nd_lm.nd_lm_loss(nd_params, mx.nd.array(tokens, ctx=ctx),
                                mx.nd.array(labels, ctx=ctx), cfg.n_heads,
                                nd_lm.causal_mask(T, ctx=ctx))
    loss.backward()
    loss_nd = float(loss.asscalar())
    grads_nd = nd_lm.grads_to_tree(nd_params)
    del nd_params, loss
    torch.cuda.empty_cache()
    loss_f, grads_f = tt.transformer_loss_and_grads(
        params, torch.from_numpy(tokens).cuda(),
        torch.from_numpy(labels).cuda(), cfg)
    torch.cuda.synchronize()
    loss_err = abs(loss_nd - loss_f.item()) / abs(loss_f.item())
    worst = 0.0
    for name, g in grads_nd.items():
        ref = nd_lm._get(grads_f, name).float().cpu().numpy()
        worst = max(worst, float(np.abs(g - ref).max()
                                 / max(np.abs(ref).max(), 1e-30)))
    log(f"f32 full-width nd pass vs functional: loss nd {loss_nd:.6f} "
        f"functional {loss_f.item():.6f} (rel {loss_err:.3g}, rtol 1e-4); "
        f"worst gradient leaf max|nd - functional| / max|functional| "
        f"{worst:.3g} (1e-3) over {len(grads_nd)} leaves")
    if not np.isfinite(loss_nd) or loss_err > 1e-4 or worst > 1e-3:
        raise AssertionError("nd loop and functional model disagree "
                             f"(loss {loss_err}, grads {worst})")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst}


# ------------------------------------------------ fused ResNet kernels
CONV_KERNELS = ("mm_fused", "mm_fused_bwd", "conv3_fused",
                "conv3_fused_bwd", "dgrad_epilogue")
CONV_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/conv_fused.cu"
CONV_REPLACES = {
    "mm_fused": "incubator_mxnet_tpu/ops/pallas/conv_fused.py:148",
    "mm_fused_bwd": "incubator_mxnet_tpu/ops/pallas/conv_fused.py:344",
    "conv3_fused": "incubator_mxnet_tpu/ops/pallas/conv_fused.py:634",
    "conv3_fused_bwd": "incubator_mxnet_tpu/ops/pallas/conv_fused.py:742",
    "dgrad_epilogue": "incubator_mxnet_tpu/ops/pallas/conv_fused.py:505"}
# error = max |kernel - twin| / max(1, max |twin|) per output
CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# ResNet-50 at batch 128, 224 x 224, NHWC: (M rows, mid, 4 * mid, H, the
# stage's input channels)
RESNET_STAGES = {2: (128 * 28 * 28, 128, 512, 28, 256),
                 3: (128 * 14 * 14, 256, 1024, 14, 512),
                 4: (128 * 7 * 7, 512, 2048, 7, 1024)}
# the case of each kernel whose stage-3 bf16 reading goes into the JSON line
CONV_RECORD_CASE = {"mm_fused": "entry", "mm_fused_bwd": "entry",
                    "conv3_fused": "3x3", "conv3_fused_bwd": "3x3",
                    "dgrad_epilogue": "block 0"}


def _scaled_err(outs, refs):
    return max(_max_err(o, r) / max(1.0, r.float().abs().max().item())
               for o, r in zip(outs, refs))


def _conv_cases(cf, g, dt):
    """The phase-13 sweep for one type: (kernel, case name, kernel call,
    twin call) over every option of the four kernels."""
    def rnd(*shape, f32=False):
        t = torch.randn(shape, generator=g, device="cuda")
        return t if f32 else t.to(dt)
    cases = []
    for M, K, N in ((64, 16, 24), (300, 40, 72), (1000, 128, 256)):
        x, sc = rnd(M, K), rnd(M, K)
        w = rnd(N, 1, 1, K).reshape(N, K).t()          # gluon layout view
        a, b = rnd(K, f32=True).abs() + 0.5, rnd(K, f32=True)
        asc, bsc, bias = (rnd(K, f32=True), rnd(K, f32=True),
                          rnd(N, f32=True))
        forms = {"plain": {}, "bnrelu": dict(a=a, b=b),
                 "entry": dict(a=a, b=b, sc=sc, asc=asc, bsc=bsc)}
        for form, kw in forms.items():
            for opt in (dict(bias=bias), dict(emit_xhat=True),
                        dict(stats=False)):
                args = {**kw, **opt}
                cases.append(("mm_fused", f"{M}x{K}x{N} {form} "
                              f"{sorted(opt)}",
                              lambda args=args, x=x, w=w: cf.mm_fused(
                                  x, w, **args),
                              lambda args=args, x=x, w=w:
                              cf.mm_fused_reference(x, w, **args)))
        gg, dzn, yout = rnd(M, N), rnd(M, N), rnd(M, N)
        gc, dsc, p1 = rnd(3, N, f32=True), rnd(M, K), rnd(M, K)
        bwd = {"direct mask z 1 partner": dict(g=gg, a=a, b=b,
                                               out_mask="z", partners=(x,)),
               "bn mask x dsc 2 partners": dict(
                   dzn=dzn, yout=yout, gcoef=gc, dsc=dsc, out_mask="x",
                   partners=(x, p1)),
               "bn no mask": dict(dzn=dzn, yout=yout, gcoef=gc),
               "direct bnrelu x no mask": dict(g=gg, a=a, b=b)}
        for name, kw in bwd.items():
            cases.append(("mm_fused_bwd", f"{M}x{K}x{N} {name}",
                          lambda kw=kw, x=x, w=w: cf.mm_fused_bwd(w, x, **kw),
                          lambda kw=kw, x=x, w=w: cf.mm_fused_bwd_reference(
                              w, x, **kw)))
    for M, K, NA, NB in ((64, 16, 8, 24), (300, 40, 72, 40),
                         (1000, 128, 64, 256)):
        x = rnd(M, K)
        wa = rnd(NA, 1, 1, K).reshape(NA, K).t()
        wb = rnd(NB, 1, 1, K).reshape(NB, K).t()
        ops = (wa, wb, x, rnd(M, NA), rnd(M, NA), rnd(3, NA, f32=True),
               rnd(M, NB), rnd(M, NB), rnd(3, NB, f32=True))
        cases.append(("dgrad_epilogue", f"{M}x{K}x{NA}+{NB}",
                      lambda ops=ops: cf.dgrad_epilogue(*ops),
                      lambda ops=ops: cf.dgrad_epilogue_reference(*ops)))
    for B, HW, C, N in ((1, 7, 16, 32), (3, 7, 32, 48), (1, 14, 32, 64),
                        (2, 14, 64, 32), (1, 28, 16, 16), (2, 28, 64, 64)):
        bhw = (B, HW, HW)
        M = B * HW * HW
        x2 = rnd(M, C)
        w9 = rnd(N, 3, 3, C).permute(1, 2, 3, 0).reshape(9, C, N)
        a, b = rnd(C, f32=True).abs() + 0.5, rnd(C, f32=True)
        dzn, yout, gc = rnd(M, N), rnd(M, N), rnd(3, N, f32=True)
        tag = f"B{B} {HW}x{HW} C{C} N{N}"
        for stats in (True, False):
            cases.append(("conv3_fused", f"{tag} stats {stats}",
                          lambda x2=x2, w9=w9, a=a, b=b, bhw=bhw, st=stats:
                          cf.conv3_fused(x2, w9, a, b, bhw, st),
                          lambda x2=x2, w9=w9, a=a, b=b, bhw=bhw, st=stats:
                          cf.conv3_fused_reference(x2, w9, a, b, bhw, st)))
        cases.append(("conv3_fused_bwd", tag,
                      lambda x2=x2, w9=w9, a=a, b=b, d=dzn, y=yout, c=gc,
                      bhw=bhw: cf.conv3_fused_bwd(w9, x2, a, b, d, y, c, bhw),
                      lambda x2=x2, w9=w9, a=a, b=b, d=dzn, y=yout, c=gc,
                      bhw=bhw: cf.conv3_fused_bwd_reference(
                          w9, x2, a, b, d, y, c, bhw)))
    return cases


def _stage_runs(cf, g, stage, dt):
    """Phase 13 at one stage of the ResNet-50 lane: every form of conv the
    fused stage runs there, on operands from the generator, as a list of
    (kernel, case, kernel call, twin call, library call, bytes, flops).
    The cases: block 0's conv1 and projection (plain load, K = the stage's
    input channels, at the strided resolution) and their backward, the dual
    dgrad, beside the two single dgrads it replaces; a middle block's conv1 (entry form, K = 4 mid -> N = mid; its
    backward masked on x with dsc and a partner), its 3x3, and its conv3
    (expand, K = mid -> N = 4 mid; its backward masked on z with one
    partner). Bytes and flops are the reference's CostEstimate counts
    (conv_fused.py:210-212, :415-417, :676-678, :787-789); for the dual
    dgrad, its inputs and outputs once and 4 M K (N_a + N_b) flops."""
    F = torch.nn.functional
    M, mid, c4, hw, cin = RESNET_STAGES[stage]
    bhw = (128, hw, hw)

    def rnd(*shape, f32=False):
        t = torch.randn(shape, generator=g, device="cuda")
        return t if f32 else t.to(dt)

    def w1(k, n):                    # a gluon (O, 1, 1, I) weight, viewed
        return rnd(n, 1, 1, k).reshape(n, k).t()

    def vecs(n):
        return rnd(n, f32=True).abs() + 0.5, rnd(n, f32=True)

    esz = torch.empty((), dtype=dt).element_size()
    runs = []

    def mm(case, x, w, **kw):
        K, N = w.shape
        runs.append(("mm_fused", case,
                     lambda: cf.mm_fused(x, w, **kw),
                     lambda: cf.mm_fused_reference(x, w, **kw),
                     lambda: torch.matmul(x, w),
                     (M * K + K * N + M * N) * esz, 2 * M * K * N))

    def mmb(case, w, x, **kw):
        K, N = w.shape
        gm = rnd(M, N)
        runs.append(("mm_fused_bwd", case,
                     lambda: cf.mm_fused_bwd(w, x, **kw),
                     lambda: cf.mm_fused_bwd_reference(w, x, **kw),
                     lambda: (torch.matmul(gm, w.t()), torch.matmul(x.t(), gm)),
                     (2 * M * K + 2 * M * N) * esz + 4 * K * N,
                     4 * M * K * N))

    # block 0: conv1 and projection off the strided input, the dual dgrad
    xs = rnd(M, cin)
    wc1, wd = w1(cin, mid), w1(cin, c4)
    mm("block 0 conv1", xs, wc1, bias=rnd(mid, f32=True))
    mm("projection", xs, wd)
    dual = (wc1, wd, xs, rnd(M, mid), rnd(M, mid),
            rnd(3, mid, f32=True) * 0.1, rnd(M, c4), rnd(M, c4),
            rnd(3, c4, f32=True) * 0.1)
    gab = torch.cat([dual[3], dual[6]], 1)
    wab = torch.cat([wc1, wd], 1)
    runs.append(("dgrad_epilogue", "block 0",
                 lambda: cf.dgrad_epilogue(*dual),
                 lambda: cf.dgrad_epilogue_reference(*dual),
                 lambda: (torch.matmul(gab, wab.t()),
                          torch.matmul(xs.t(), gab)),
                 (2 * M * (mid + c4) + 2 * M * cin + cin * (mid + c4)) * esz
                 + 4 * cin * (mid + c4), 4 * M * cin * (mid + c4)))
    # the two single dgrads the dual one replaces (mask none), for its time
    mmb("block 0 conv1", wc1, xs, dzn=dual[3], yout=dual[4], gcoef=dual[5])
    mmb("projection", wd, xs, dzn=dual[6], yout=dual[7], gcoef=dual[8])
    # a middle block: the entry-form conv1, the 3x3, the expand conv3
    x, sc = rnd(M, c4), rnd(M, c4)
    a, b = vecs(c4)
    w = w1(c4, mid)
    mm("entry", x, w, a=a, b=b, sc=sc, asc=rnd(c4, f32=True),
       bsc=rnd(c4, f32=True), bias=rnd(mid, f32=True), emit_xhat=True)
    mmb("entry", w, x, dzn=rnd(M, mid), yout=rnd(M, mid),
        gcoef=rnd(3, mid, f32=True) * 0.1, dsc=sc, out_mask="x",
        partners=(rnd(M, c4),))
    x2 = rnd(M, mid)
    w9 = rnd(mid, 3, 3, mid).permute(1, 2, 3, 0).reshape(9, mid, mid)
    a2, b2 = vecs(mid)
    dzn2, yout2, gc2 = rnd(M, mid), rnd(M, mid), rnd(3, mid, f32=True) * 0.1
    xc = x2.reshape(bhw + (mid,)).permute(0, 3, 1, 2)        # channels-last
    wc = w9.reshape(3, 3, mid, mid).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xr = xc.detach().requires_grad_(True)
    wr = wc.detach().requires_grad_(True)
    yc = F.conv2d(xr, wr, padding=1)
    gcl = dzn2.reshape(bhw + (mid,)).permute(0, 3, 1, 2)
    N = mid
    runs.append(("conv3_fused", "3x3",
                 lambda: cf.conv3_fused(x2, w9, a2, b2, bhw),
                 lambda: cf.conv3_fused_reference(x2, w9, a2, b2, bhw),
                 lambda: F.conv2d(xc, wc, padding=1),
                 (M * (N + N) + 9 * N * N) * esz, 18 * M * N * N))
    runs.append(("conv3_fused_bwd", "3x3",
                 lambda: cf.conv3_fused_bwd(w9, x2, a2, b2, dzn2, yout2, gc2,
                                            bhw),
                 lambda: cf.conv3_fused_bwd_reference(w9, x2, a2, b2, dzn2,
                                                      yout2, gc2, bhw),
                 lambda: torch.autograd.grad(yc, (xr, wr), gcl,
                                             retain_graph=True),
                 M * (2 * N + 2 * N) * esz + 4 * 9 * N * N, 36 * M * N * N))
    y2 = rnd(M, mid)
    w3 = w1(mid, c4)
    mm("expand", y2, w3, a=a2, b=b2, bias=rnd(c4, f32=True))
    mmb("expand", w3, y2, dzn=rnd(M, c4), yout=rnd(M, c4),
        gcoef=rnd(3, c4, f32=True) * 0.1, a=a2, b=b2, out_mask="z",
        partners=(y2,))
    return runs


def conv_kernel_checks(cf, common):
    """Phase 13: the five fused-conv kernels against their twins over the
    option sweep in float32 and bf16, then at the ResNet-50 lane's shapes,
    every conv form of each stage (2, 3, 4) in both types, with times (CUDA
    events) in bf16 at every stage and in float32 at stage 3, beside the
    twin's, the library product's and the bound. Returns the JSON records
    (bf16, stage 3) and a log of every timing."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for name, case, kern, plain in _conv_cases(cf, g, dt):
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = _scaled_err(out, ref)
            if not all(torch.isfinite(t).all() for t in out) \
                    or err > CONV_TOL[dt]:
                raise AssertionError(f"{name} {dt} {case}: max |kernel - "
                                     f"plain| {err} > {CONV_TOL[dt]}")
            key = f"{name} {str(dt)[6:]}"
            worst[key] = max(worst.get(key, 0.0), err)
            n_cases += 1
    log(f"fused-conv sweep: {n_cases} cases (every load form, stats, "
        f"x^ output, bias, G direct and from BN, masks none/x/z, 0-2 "
        f"partners, dsc, 3x3 at 7/14/28 with 1-3 images, dual dgrad) "
        f"within tolerance;"
        f" worst {json.dumps(worst)}")
    timings = {"sweep": worst}
    records = {}
    for stage in (2, 3, 4):
        for dt in (torch.float32, torch.bfloat16):
            runs = _stage_runs(cf, g, stage, dt)
            for name, case, kern, plain, lib, moved, flops in runs:
                out, ref = kern(), plain()
                torch.cuda.synchronize()
                err = _scaled_err(out, ref)
                if not all(torch.isfinite(t).all() for t in out) \
                        or err > CONV_TOL[dt]:
                    raise AssertionError(f"{name} {case} {dt} stage {stage}:"
                                         f" max |kernel - plain| {err}")
                del out, ref
                tag = f"{name} {case} {str(dt)[6:]} stage {stage}"
                if dt == torch.float32 and stage != 3:
                    log(f"parity {tag}: err {err:.3g}")
                    continue
                ms = time_ms(kern, iters=10, warmup=2)
                plain_ms = time_ms(plain, iters=3, warmup=1)
                library_ms = time_ms(lib, iters=10, warmup=2)
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dt] * 1e3
                rec = {"name": name, "route": "cuda", "source": CONV_SOURCE,
                       "replaces": CONV_REPLACES[name], "launches": 0,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "library_ms": library_ms}
                timings[tag] = rec
                if dt == torch.bfloat16 and stage == 3 \
                        and case == CONV_RECORD_CASE[name]:
                    records[name] = rec
                log(f"time {tag}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {library_ms:.4f} ms, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
                    f"err {err:.3g}")
            del runs
            torch.cuda.empty_cache()
    return records, timings


# ------------------------------------------------------ ResNet-50 lane
RESNET_BATCH = 128


def _resnet_setup(mx, gluon, vision, seed, batch, dtype=None):
    """ResNet-50 v1, NHWC, on the card, default init, deferred shapes
    resolved by one forward; a batch from the seed; the functional SGD
    step of bench.py's lane (lr 0.01, momentum 0.9)."""
    from incubator_mxnet_tpu_torch.parallel.dp import make_train_step
    rs = np.random.RandomState(seed)
    x_np = rs.rand(batch, 3, 224, 224).astype(np.float32)
    y_np = rs.randint(0, 1000, (batch,)).astype(np.int32)
    mx.random.seed(seed)
    with mx.gpu(0):
        net = vision.resnet50_v1(layout="NHWC")
        net.initialize()
        net(mx.nd.array(x_np[:1]))
    step, params, aux, opt = make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.01, momentum=0.9, compute_dtype=dtype)
    return (net, step, params, aux, opt, torch.from_numpy(x_np).cuda(),
            torch.from_numpy(y_np).cuda())


def resnet_train_phase(mx, gluon, vision, common, records, steps=5):
    """Phase 14: ResNet-50 v1 training at bench.py's lane (NHWC, batch 128,
    224 x 224, bf16 compute on float32 masters, SGD momentum 0.9, lr 0.01,
    MXTPU_FUSED_RESNET=1, MXTPU_BN_IMPL=plain): 2 warm-up and 5 timed
    steps; finite falling loss, the fused kernels' launches per step, then
    a profiled window of two steps."""
    import os
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    os.environ["MXTPU_BN_IMPL"] = "plain"
    torch.cuda.reset_peak_memory_stats()
    _, step, params, aux, opt, x, y = _resnet_setup(
        mx, gluon, vision, SEED + 5, RESNET_BATCH, torch.bfloat16)
    losses = []
    for _ in range(2):
        params, aux, opt, loss = step(params, aux, opt, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, aux, opt, loss = step(params, aux, opt, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    img_s = RESNET_BATCH * steps / wall
    log(f"resnet50 fused train: losses {[round(v, 4) for v in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {img_s:.1f} img/s; peak {peak_gb:.2f} GB; launches "
        f"{launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"resnet loss not finite and falling: {losses}")
    # stages 2-4 hold 4 + 6 + 3 blocks: a 1x1 conv1, a 3x3 and a 1x1 conv3
    # each, plus block 0's projection; block 0's conv1 and projection
    # dgrads are one dual dgrad
    per_step = {"mm_fused": 29, "conv3_fused": 13, "mm_fused_bwd": 23,
                "conv3_fused_bwd": 13, "dgrad_epilogue": 3}
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} resnet steps, not {n * steps}")
        records[name]["launches"] = launches[name]
    breakdown = resnet_breakdown(lambda: step(params, aux, opt, x, y))
    return {"step_ms": wall / steps * 1e3, "img_s": img_s,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, "launches_per_step": per_step,
            **breakdown}


def resnet_breakdown(step, steps: int = 2):
    """Busy and wall time of ``steps`` ResNet steps from one profiled
    window: idle share, the fused-conv kernels' share, top device ops."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    names = ("cf_fwd_kernel", "cf_dgrad_kernel", "cf_wgrad_kernel")
    conv = {n: sum(e.self_device_time_total for e in dev if n in e.key)
            / steps / 1e3 for n in names}
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if busy_ms > wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {wall_ms} ms")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    conv_ms = sum(conv.values())
    out = {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "fused_conv_kernels_ms": conv_ms,
           "fused_conv_share_of_busy": conv_ms / busy_ms,
           "fused_conv_kernel_ms": conv,
           "top_device_ops": [[e.key[:60],
                               e.self_device_time_total / steps / 1e3]
                              for e in top]}
    log(f"resnet step breakdown: {json.dumps(out)}")
    return out


def resnet_perblock_phase(mx, gluon, vision, common, steps=5):
    """Phase 15: the same step with MXTPU_FUSED_RESNET=0 (the per-block
    path: PyTorch convolutions and batch norm), as phase 14 runs it: 2
    warm-up and 5 timed steps, no fused-conv launch, then a profiled
    window of two steps."""
    import os
    os.environ["MXTPU_FUSED_RESNET"] = "0"
    torch.cuda.reset_peak_memory_stats()
    _, step, params, aux, opt, x, y = _resnet_setup(
        mx, gluon, vision, SEED + 5, RESNET_BATCH, torch.bfloat16)
    losses = []
    for _ in range(2):
        params, aux, opt, loss = step(params, aux, opt, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, aux, opt, loss = step(params, aux, opt, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches[n] for n in CONV_KERNELS):
        raise AssertionError(f"the per-block path launched {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"per-block resnet loss not finite and "
                             f"falling: {losses}")
    img_s = RESNET_BATCH * steps / wall
    log(f"resnet50 per-block train: losses {[round(v, 4) for v in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {img_s:.1f} img/s; peak {peak_gb:.2f} GB")
    breakdown = resnet_breakdown(lambda: step(params, aux, opt, x, y))
    return {"step_ms": wall / steps * 1e3, "img_s": img_s,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb,
            **{k: v for k, v in breakdown.items()
               if not k.startswith("fused_conv")}}


def _stage_grads(blocks, stride, xin, ct, path, mx):
    """One stage, forward and gradients (dx and every parameter), on the
    same leaves, through ``path``: "kernels" (the fused stage as the lane
    runs it), "twins" (the same fused stage on the kernels' plain twins) or
    "per-block"."""
    from incubator_mxnet_tpu_torch.autograd import _IN_TRACE
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        _fused_resnet as fr
    from incubator_mxnet_tpu_torch.gluon.parameter import \
        parameter_substitution
    from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as cf
    pobjs, aux_objs = [], []
    for blk in blocks:
        bns = [blk.body[1], blk.body[4], blk.body[7]]
        convs = [blk.body[0], blk.body[3], blk.body[6]]
        if blk.downsample is not None:
            bns.append(blk.downsample[1])
            convs.append(blk.downsample[0])
        for layer in convs:
            pobjs += [p for p in (layer.weight, layer.bias) if p is not None]
        for bn in bns:
            pobjs += [bn.gamma, bn.beta]
            aux_objs += [bn.running_mean, bn.running_var]
    leaves = [p.data()._data.detach().clone().requires_grad_(True)
              for p in pobjs]
    x = xin.detach().clone().requires_grad_(True)
    mapping = {id(p): mx.nd.from_torch(t) for p, t in zip(pobjs, leaves)}
    mapping.update({id(p): mx.nd.from_torch(p.data()._data.clone())
                    for p in aux_objs})
    real_ops = fr._ops
    if path == "twins":
        fr._ops = lambda _t: (
            cf.mm_fused_reference, cf.mm_fused_bwd_reference,
            cf.conv3_fused_reference, cf.conv3_fused_bwd_reference,
            cf.dgrad_epilogue_reference)
    try:
        with parameter_substitution(mapping):
            y = _stage_forward(blocks, stride, x, path, mx, fr, _IN_TRACE)
        grads = torch.autograd.grad(y, [x] + leaves, ct)
    finally:
        fr._ops = real_ops
    names = [p.name for p in pobjs]
    return y.detach(), grads[0], dict(zip(names, grads[1:]))


def _stage_forward(blocks, stride, x, path, mx, fr, in_trace):
    if path != "per-block":
        return fr.fused_stage(stride, x, fr.stage_params_from_blocks(
            blocks))[0]
    in_trace.active = True
    try:
        with mx.autograd.pause(train_mode=True):
            t = mx.nd.from_torch(x)
            for blk in blocks:
                t = blk(t)
        return t._data
    finally:
        in_trace.active = False


def _grad_errs(a, b):
    """Two ``_stage_grads`` results compared: (dx, worst non-bias parameter
    gradient) as max |a - b| over b's largest entry, then the same pair as
    the relative L2 error |a - b| / |b|."""
    def rel(u, v):
        return (u - v).abs().max().item() / (v.abs().max().item() + 1e-12)

    def rel2(u, v):
        return ((u - v).norm() / (v.norm() + 1e-30)).item()
    # a bias before BN has no gradient: both sides are noise there
    keys = [k for k in b[2] if not k.endswith("_bias")]
    return (rel(a[1], b[1]), max(rel(a[2][k], b[2][k]) for k in keys),
            rel2(a[1], b[1]), max(rel2(a[2][k], b[2][k]) for k in keys))


def resnet_truth_phase(mx, gluon, vision, common):
    """Phase 16: in float32 at 224 x 224, batch 16: each fused stage (2, 3,
    4) against the same stage on the per-block path, then the whole net's
    first-step loss fused against per-block (rtol 1e-3).

    The forward is held to tests/test_fused_resnet.py:402's tolerance
    (rtol = atol = 1e-3). Its gradient tolerances (:406-414: dx within
    1e-3 and every non-bias parameter gradient within 5e-3 of its largest
    entry) assume a well-conditioned stage; at this size in float32 the
    per-block path's own gradients move by 2-11% of their largest entry
    when the input moves by 1e-6 of itself, and stage 2's by 0.5-0.6% in
    relative L2 (ReLU masks flip; measured on the card). So the gradients are held,
    both as max-abs error over the largest entry and as relative L2 error,
    to the larger of the reference's numbers and three times the spread
    that the same run measures (per-block at x against per-block at
    x (1 + 1e-6 e)).

    Two control readings stand beside them: the same fused stage run on
    the kernels' plain twins against the per-block path (what the fused
    algorithm itself gives, with no kernel in it), and the kernels' stage
    against the twins' (what the kernels alone add); the latter's forward
    is held to rtol = atol = 1e-3 too."""
    import os
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    net, step, params, aux, opt, x, y = _resnet_setup(
        mx, gluon, vision, SEED + 6, 16)
    feats = list(net.features._children.values())
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out = {}
    shapes = {5: (16, 56, 56, 256), 6: (16, 28, 28, 512),
              7: (16, 14, 14, 1024)}
    for idx, shape in shapes.items():
        blocks = list(feats[idx]._children.values())
        xin = torch.rand(shape, generator=g, device="cuda")
        xp = xin * (1 + 1e-6 * torch.randn(shape, generator=g,
                                           device="cuda"))
        oshape = (shape[0], shape[1] // 2, shape[2] // 2,
                  blocks[0].body[6].weight.shape[0])
        ct = torch.randn(oshape, generator=g, device="cuda")
        common.reset_launch_counts()
        fused = _stage_grads(blocks, 2, xin, ct, "kernels", mx)
        counts = common.launch_counts()
        if counts["conv3_fused_bwd"] != len(blocks) \
                or counts["dgrad_epilogue"] != 1:
            raise AssertionError(f"the fused stage did not run its kernels: "
                                 f"{counts}")
        common.reset_launch_counts()
        twin = _stage_grads(blocks, 2, xin, ct, "twins", mx)
        if any(common.launch_counts()[n] for n in CONV_KERNELS):
            raise AssertionError("the twins' stage launched a kernel")
        ref = _stage_grads(blocks, 2, xin, ct, "per-block", mx)
        moved = _stage_grads(blocks, 2, xp, ct, "per-block", mx)
        torch.cuda.synchronize()
        y_ok = bool(((fused[0] - ref[0]).abs()
                     <= 1e-3 + 1e-3 * ref[0].abs()).all())
        y_err = (fused[0] - ref[0]).abs().max().item()
        dx_err, p_err, dx_l2, p_l2 = _grad_errs(fused, ref)
        dx_spread, p_spread, dx_l2_spread, p_l2_spread = _grad_errs(moved,
                                                                    ref)
        dx_tol = max(1e-3, 3 * dx_spread)
        p_tol = max(5e-3, 3 * p_spread)
        dx_l2_tol = max(1e-3, 3 * dx_l2_spread)
        p_l2_tol = max(5e-3, 3 * p_l2_spread)
        stage = idx - 3
        tw_dx_err, tw_p_err, tw_dx_l2, tw_p_l2 = _grad_errs(twin, ref)
        kt_dx_err, kt_p_err, kt_dx_l2, kt_p_l2 = _grad_errs(fused, twin)
        kt_y_ok = bool(((fused[0] - twin[0]).abs()
                        <= 1e-3 + 1e-3 * twin[0].abs()).all())
        log(f"f32 stage {stage} control, twins' stage vs per-block: dx L2 "
            f"{tw_dx_l2:.3g}, max {tw_dx_err:.3g} of max; worst parameter "
            f"gradient L2 {tw_p_l2:.3g}, max {tw_p_err:.3g} of max. "
            f"Kernels' stage vs twins': y max err "
            f"{(fused[0] - twin[0]).abs().max().item():.3g}; dx L2 "
            f"{kt_dx_l2:.3g}, max {kt_dx_err:.3g} of max; worst parameter "
            f"gradient L2 {kt_p_l2:.3g}, max {kt_p_err:.3g} of max")
        if not kt_y_ok:
            raise AssertionError(f"stage {stage}: the kernels' and the "
                                 "twins' fused forward disagree")
        log(f"f32 stage {stage} fused vs per-block: y max err {y_err:.3g} "
            f"(rtol = atol = 1e-3); dx L2 {dx_l2:.3g} (spread "
            f"{dx_l2_spread:.3g}, tol {dx_l2_tol:.3g}), max {dx_err:.3g} of "
            f"max (spread {dx_spread:.3g}, tol {dx_tol:.3g}); worst "
            f"parameter gradient L2 {p_l2:.3g} (spread {p_l2_spread:.3g}, "
            f"tol {p_l2_tol:.3g}), max {p_err:.3g} of max (spread "
            f"{p_spread:.3g}, tol {p_tol:.3g})")
        if not y_ok or dx_err > dx_tol or p_err > p_tol \
                or dx_l2 > dx_l2_tol or p_l2 > p_l2_tol:
            raise AssertionError(f"stage {stage}: fused and per-block "
                                 "disagree")
        out[f"stage{stage}"] = {"y_err": y_err, "dx_l2": dx_l2,
                                "dx_l2_spread": dx_l2_spread,
                                "param_l2": p_l2,
                                "param_l2_spread": p_l2_spread,
                                "dx_err": dx_err, "dx_spread": dx_spread,
                                "param_err": p_err,
                                "param_spread": p_spread,
                                "twins_vs_perblock": {
                                    "dx_l2": tw_dx_l2, "param_l2": tw_p_l2,
                                    "dx_err": tw_dx_err,
                                    "param_err": tw_p_err},
                                "kernels_vs_twins": {
                                    "dx_l2": kt_dx_l2, "param_l2": kt_p_l2,
                                    "dx_err": kt_dx_err,
                                    "param_err": kt_p_err}}
    _, _, _, loss_f = step(params, aux, opt, x, y)
    os.environ["MXTPU_FUSED_RESNET"] = "0"
    _, _, _, loss_p = step(params, aux, opt, x, y)
    rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    log(f"f32 resnet50 first-step loss: fused {float(loss_f):.6f} per-block "
        f"{float(loss_p):.6f} (rel {rel:.3g}, rtol 1e-3)")
    if not np.isfinite(float(loss_f)) or rel > 1e-3:
        raise AssertionError("whole-net loss: fused and per-block disagree")
    out["loss_rel"] = rel
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.models import nd_lm
    from incubator_mxnet_tpu_torch.models import transformer as tt
    from incubator_mxnet_tpu_torch.ops.cuda import common
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    from incubator_mxnet_tpu_torch.ops.cuda import softmax as sm
    from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as cf
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    common.kernel_library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"({common.BUILD_DIR})")

    records = kernel_checks(fa)
    serve = serving_phase(serving, tt, fa, records)
    f32_step_phase(tt, fa)
    train_records, timings = train_kernel_checks(fa)
    records.update(train_records)
    torch.cuda.empty_cache()
    train = train_phase(tt, fa, records)
    torch.cuda.empty_cache()
    headmajor_phase(tt, fa)
    torch.cuda.empty_cache()
    f32_train = f32_train_step_phase(tt, fa)
    torch.cuda.empty_cache()
    row_records, row_timings = row_kernel_checks(ln, sm, common)
    records.update(row_records)
    torch.cuda.empty_cache()
    nd_train = nd_train_phase(tt, nd_lm, mx, common, records)
    torch.cuda.empty_cache()
    nd_truth = nd_truth_phase(tt, nd_lm, mx)
    torch.cuda.empty_cache()
    conv_records, conv_timings = conv_kernel_checks(cf, common)
    records.update(conv_records)
    torch.cuda.empty_cache()
    resnet = resnet_train_phase(mx, gluon, vision, common, records)
    torch.cuda.empty_cache()
    perblock = resnet_perblock_phase(mx, gluon, vision, common)
    torch.cuda.empty_cache()
    resnet_truth = resnet_truth_phase(mx, gluon, vision, common)

    log(f"serving {json.dumps(serve)}")
    log(f"training {json.dumps(train)}")
    log(f"training kernel timings {json.dumps(timings)}")
    log(f"f32 training pass {json.dumps(f32_train)}")
    log(f"row kernel timings {json.dumps(row_timings)}")
    log(f"nd training {json.dumps(nd_train)}")
    log(f"nd full-width truth {json.dumps(nd_truth)}")
    log(f"fused-conv kernel timings {json.dumps(conv_timings)}")
    log(f"resnet50 fused {json.dumps(resnet)}")
    log(f"resnet50 per-block {json.dumps(perblock)}")
    log(f"resnet50 f32 truth {json.dumps(resnet_truth)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[n] for n in (
        "flash_decode_step", "flash_decode_step_paged") + TRAIN_KERNELS
        + ROW_KERNELS + CONV_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
