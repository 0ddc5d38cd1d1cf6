"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — generative LM serving through
``InferenceEngine.load_model(generate=...)`` at full width (d_model 768,
12 heads, 12 layers, d_ff 3072, vocab 32768, cache 512, page 64, 8 slots,
bf16, random weights from a seed) — and holds every CUDA kernel of that
path against its plain PyTorch version on the card:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of the kernels from ``incubator_mxnet_tpu_torch/ops/cuda/csrc``;
3. each kernel against its plain version at the serving shapes with ragged
   lengths, in float32 (atol 2e-5) and bf16 (atol 2e-2), and its time beside
   the plain version's, one PyTorch library call's (where one computes the
   same function) and the least time the card could take (bytes the call
   must move at 3.35 TB/s, or its flops at the peak rate, whichever is
   larger);
4. serving: ~16 prompts of 8..200 tokens on the paged engine (some share a
   64-token prefix, one is sampled), then a short pass on the contiguous
   engine; every request must finish with its token budget, every page must
   come back, and each kernel must have been launched by the run (launch
   counters are reset right before each run and read right after); then a
   torch.profiler breakdown of one decode step (wall time, device busy and
   idle shares, the attention kernel's share);
5. one full-width float32 decode step (paged and contiguous) with the
   kernels against the same step with the plain attention (atol 1e-3).

Any failure raises, so the exit code is not 0. The last two lines of
standard output are the kernels' JSON record and
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
    """Wall time of one full-width decode step (8 live slots, lengths
    50..200, greedy) against the device time torch.profiler records for
    it: the device's busy and idle shares, and the attention kernel's."""
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
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    attn_ms = sum(e.self_device_time_total for e in dev
                  if "decode_attn_kernel" in e.key) / steps / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    out = {"step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "attention_kernel_ms": attn_ms}
    log(f"decode step breakdown: {json.dumps(out)}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.models import transformer as tt
    from incubator_mxnet_tpu_torch.ops.cuda import common
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

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

    log(f"serving {json.dumps(serve)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records["flash_decode_step"],
                                  records["flash_decode_step_paged"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
