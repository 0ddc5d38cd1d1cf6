"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's seven main paths on the card and holds every CUDA kernel
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
  (``MXTPU_FUSED_RESNET=1``) and without them;
* the word-level LSTM LM (``models.RNNModel``) at bench.py's lane (2 x 650
  LSTM, vocab 33278, bptt 35, batch 128, dropout 0.5, bf16 compute on
  float32 masters, SGD lr 1.0) through ``parallel.dp.make_train_step``,
  its eval forward, and one ``Trainer`` + ``autograd.record()`` step;
* SSD-512 detection training (``models.ssd.ssd_512_resnet50_v1``, 20
  classes, NCHW, batch 32, 512 x 512, 5630 anchors, bf16 compute on
  float32 masters, SGD momentum 0.9, lr 0.004) with bench.py's step built
  from ``parallel.dp.functional_call`` and ``ops.detection
  .multibox_target``, its detection eval point
  (``multibox_detection(..., nms_topk=400)``), and one ``Trainer`` +
  ``autograd.record()`` step through ``SSD.targets``;
* the user-extension path: CUDA C++ kernels compiled at runtime with
  NVRTC (``rtc.CudaModule``) and launched on NDArrays, wrapped in a custom
  operator (``operator.CustomOp``, ``nd.Custom``) that trains
  ``examples/train_mnist.py``'s MLP (784-128-64-10, batch 64, SGD lr 0.1,
  momentum 0.9) under ``autograd`` through ``gluon.Trainer``, and
  ``test_utils.check_consistency`` of that op.

Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of the kernels from ``incubator_mxnet_tpu_torch/ops/cuda/csrc``;
3. the decode kernels: the split kernels as built (registers, stack,
   local bytes and bulk-copy count of each, none without UBLKCP or with
   local bytes); against their plain versions in float32 (atol 2e-5) and
   bf16 (atol 2e-2) on both routes (the split kernels, and the old
   one-block-a-cell kernel, ``_route="simple"``):
   a sweep (3 heads, d 32/64/128, page 16/64, lengths 0, 1, every tile
   and page boundary -1/0/+1 and full, a scrambled block table whose dead
   entries point at a trash page of garbage, garbage past each length in
   the contiguous cache), a 4096-long cache (runs of several tiles a
   split) and the serving shapes with ragged lengths; two calls bitwise
   equal; then in bf16 at the serving lane with
   ragged lengths (8..512) and with every slot full, each route's device
   ms (torch.profiler), graph ms (a CUDA graph of 20 calls), event ms and
   host µs taken in turns over two rounds, K/V rotated through copies
   beyond the 50 MB L2, beside the plain version's, masked SDPA's (for the
   contiguous kernel) and the least time the card could take (bytes the
   call must move at 3.35 TB/s, or its flops at the peak rate of the input
   type, whichever is larger);
4. serving: ~16 prompts of 8..200 tokens on the paged engine (some share a
   64-token prefix, one is sampled), its steps captured as CUDA graphs at
   load (``len(buckets) + 1``, counted in ``mxtpu_serve_compiles_total``
   and ``mxtpu_serve_gen_traces_total``, which traffic must not move) and
   the eager yardstick (``_GenerativeModel(_capture=False)``) in turns,
   two rounds each, their token streams equal; then a short pass on the
   contiguous engine, captured and eager, streams equal; every request
   must finish with its token budget, every page must come back, and the
   decode kernel must have launched 12 times a decode step (counted
   through graph replays; launch counters are reset right before each
   run and read right after), every launch on the split route; then a
   torch.profiler breakdown of decode steps of each paged engine (busy
   time from a profiled window, the idle share over the unprofiled
   steps' wall, the profiled window's beside it; the attention kernels'
   time);
5. one full-width float32 decode step (paged and contiguous) with the
   kernels against the same step with the plain attention (atol 1e-3);
6. the training kernels (flash forward, dq, dk/dv): the float32 route's
   kernels as built (registers, stack, local bytes and HMMA count of each,
   none without HMMA or with local bytes) and the bf16 Hopper kernels at
   d 32/64/128 (``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
   ``flash_bwd_dkv_wgmma_kernel``: HGMMA, no local bytes or stack);
   against their plain twins, in float32 (atol 1e-4 forward, 1e-3
   gradients; on the split-bf16 ``mma.sync`` route and on the FMA route)
   and bf16 (2e-2, 5e-2; forward and backward on their ``wgmma`` route and
   on the WMMA kernels, ``_route="wmma"``; the ``wgmma`` backward's two
   calls bitwise equal), in the packed and head-major layouts: first a
   sweep of small shapes (head dims 32/64/128, a tail tile, sq != sk,
   causal and not; bf16 also T 512 and sq 1 / sk 7); then the product
   check, each float32 kernel against the float64 function on both routes
   (B 2, H 12, T 512, d 64, packed, causal), the split route no worse than
   the FMA route; then at B 32, H 12, T 512, d 64, causal, with their
   times (float32: the split route, the FMA route and SDPA in turns, two
   rounds, and each kernel's time replayed from a CUDA graph), SDPA's
   float32 kernels, and the bounds as in phase 3 (float32: six bf16
   products on the tensor cores, the FMA bound beside it; and the backward
   pair's minimal bound); the bf16 records: the forward's ``wgmma``
   kernel, the WMMA kernel and SDPA, then the backward pair on ``wgmma``,
   the WMMA pair and SDPA's backward, each in turns (device, graph, event
   ms, host µs);
7. training: 2 warm-up steps (the first in bf16: its 12 flash forward, 12
   dq and 12 dk/dv launches all on the ``wgmma`` route), then 5 timed
   steps with the
   launch counters reset before them; the loss must be finite and fall,
   and each training kernel must be launched 12 times per step, every
   launch of the float32 timed steps on the split route; then a
   torch.profiler breakdown of two more steps, with busy and wall time
   from the same profiled window;
8. the head-major route: a 2-layer step at d_model 576, 9 heads (packed
   rows not a multiple of 128) must launch the same kernels, every bf16
   flash launch on the ``wgmma`` route;
9. one full-width float32 loss-and-gradient pass with the kernels against
   the same pass with plain attention (loss rtol 1e-4, every gradient
   leaf within 1e-3 of its largest entry);
10. the row kernels (layer-norm forward and backward, softmax) against
   their twins in float32 (atol 1e-5 forward, 1e-4 gradients) and bf16
   (2e-2, 5e-2, scaled by the magnitude above 1) over d 64..32768 (the LN
   backward's one-pass route up to d 1024, forced onto the two-pass
   kernel too, and the two-pass route above; scalar loads at d 66 and
   100; 4096 rows at d 768 and 1000, several groups of blocks), the
   inline route (rows not a multiple of 8: nothing launched), the
   vector forward (up to d 1024, and the first design forced,
   ``_route="warp"``, beside it) and the one-pass backward as built
   (registers, stack, local bytes, 16-byte loads), the forward's y, mu
   and rstd and the backward's dx, dgamma and dbeta bitwise equal over
   two calls and a CUDA-graph replay; then the LN forward at (16384,
   768), both types: the vector kernel, the first design and
   ``F.layer_norm`` in turns (device, graph, event ms, host µs), x
   rotated through copies beyond the 50 MB L2; the LN backward at
   (16384, 768), both types:
   the one-pass and two-pass kernels' device, graph and event ms and host
   µs in turns, x and dy rotated through copies beyond the 50 MB L2; then
   at the slice's shapes (LN (16384, 768); softmax (196608, 512), the
   scores of B 32, H 12, T 512) with times beside the twin, the library
   call and the byte bound;
11. the nd loop at bench.py's width (d 768, 12 heads, d_ff 3072, 12
   layers, vocab 32768, T 512, batch 32, float32): 2 warm-up and 5 timed
   steps; the loss must be finite and fall, and each step must launch the
   LN kernels 25 times each (every forward on the vector route, every
   backward on the one-pass route) and the softmax kernel 12 times; then a profiled window of two steps
   (busy, idle, the row kernels' share), and one profiled layer-norm
   backward at the lane's (16384, 768): the one-pass kernel alone, no
   column-sum launch after it;
12. at the same width, the nd loop's loss and gradients against the
   functional ``transformer_loss_and_grads`` with plain attention (loss
   rtol 1e-4, every gradient leaf within 1e-3 of its largest entry);
13. the Hopper kernels of conv_fused_sm90.cu as built: registers, stack,
   shared and local bytes and HGMMA count of each (``cuobjdump``), none
   without HGMMA or with local bytes; the fused-conv kernels (``mm_fused``, ``mm_fused_bwd``,
   ``conv3_fused``, ``conv3_fused_bwd``, ``dgrad_epilogue``) against their
   twins in float32 (1e-4) and bf16 (2e-2), errors over max(1, the twin's
   largest entry): a sweep of every load form, stats on and off, the x^
   output, bias, G direct and from batch norm, each mask, 0-2 partners,
   dsc, the expand form, 3x3 at 7/9/14/28 with 1-3 images and C up to 72,
   the dual dgrad; then at the ResNet-50 lane's shapes, every conv form of
   each stage (2-4): block 0's conv1 and projection and their dual dgrad,
   a middle block's entry-form conv1, 3x3 and expand conv3, forward and
   backward, with times beside the twin's, the library product's
   (``torch.matmul``, channels-last ``F.conv2d`` and its autograd) and the
   bound; all five in bf16 on their Hopper route and in float32 on the
   three-piece route (every 1x1 form of mm_fused and mm_fused_bwd and the
   3x3 backward at stages 2-4, two calls bitwise equal), each also forced
   onto its SIMT kernel and timed beside it in the same call (the float32
   3x3 backward at stages 2-4, the other float32 forms at stage 3);
14. ResNet-50 v1 training at bench.py's lane with ``MXTPU_FUSED_RESNET=1``
   and ``MXTPU_BN_IMPL=plain`` through ``make_train_step``'s captured
   step (one CUDA graph, replayed): 2 warm-up and 5 timed steps; finite,
   falling loss; per step 29 ``mm_fused``, 13 ``conv3_fused``, 23
   ``mm_fused_bwd``, 13 ``conv3_fused_bwd`` and 3 ``dgrad_epilogue``
   launches, counted through the replays, all on the Hopper route; the
   eager yardstick (``_capture=False``) and the captured step in turns,
   three runs of 5 steps each, the same launches in every run; img/s and
   peak memory of each; one step of each from the same state (loss and
   parameter updates); a profiled window of two steps of each (busy, the
   idle share over the unprofiled wall, top ops, the records kept); then
   the rematerialisation policies "nothing" and "dots" against none, a
   fresh captured step each: the first call's peak memory (lower under
   "nothing") and a replay from the same state;
15. the same step on the per-block path (``MXTPU_FUSED_RESNET=0``: PyTorch
   convolutions and batch norm), run as phase 14 runs it: its img/s, no
   fused-conv launch, and a profiled window of two steps; then
   ``resnet50_v1``'s inference forward at batch 32, eager and after
   ``hybridize()`` (one captured graph, replayed): outputs within 1e-5
   of the largest entry, one cache entry, both times;
16. float32 at 224 x 224, batch 16: each fused stage against the per-block
   path (forward, dx and every non-bias parameter gradient; see
   ``resnet_truth_phase``), beside two control readings: the same fused
   stage on the plain twins, and the kernels' stage against the twins';
   every float32 mm_fused, conv3_fused, dgrad_epilogue, mm_fused_bwd and
   conv3_fused_bwd launch (29, 13, 3, 23 and 13 over the stages) on the
   three-piece route;
   then the whole
   net's first-step loss, fused against per-block (rtol 1e-3);
17. the LSTM kernels (``lstm_fwd_gates``, ``lstm_fwd``, ``lstm_bwd``)
   against their twins, forward within 1e-4 in float32 and 2e-2 with bf16
   (over max(1, the largest entry)), backward within 1e-3 / 2e-2 of the
   largest entry: H 16, 20, 64, 211, 650, 1030 by N 5, 8, 64, 128, 256,
   in four type forms (float32 carries with a bf16 W_hh and bf16 xp and
   b, as the word LM's layer 1 runs, or float32 xp and b, as its layer 2
   runs; bf16 throughout, c carried in bf16; float32), every forward on
   its tensor-core route (a float32 W in three bf16 pieces, six products
   a stage) and again on the FMA kernel, the backward on its tensor-core
   route (a float32 W in three pieces too) and again on the SIMT kernel,
   the whole ``lstm_scan`` forward + backward in both
   directions against the CPU twins; the forward's gates residual against
   a float64 twin within 1e-6 (absolute) beside the FMA kernel's reading
   and, with float32 carries, a control's (a two-piece split of h with a
   bf16 W, three products with a float32 W), which must read above the
   limit at the lane, where the float32-W route must also read no worse
   than the FMA kernel; with float32 carries, the tensor-core backward's
   dh against the float64 product of its own dxp (dz) and W within 1e-6
   of the largest entry, beside the SIMT kernel's reading and a control's
   (a two-piece split of dz with a bf16 W, which must read above the
   limit at the lane; W's hi piece alone with a float32 W, which must
   read above it everywhere); the tensor-core kernels as built
   (registers, stack and local bytes, HMMA count; every float32-W forward
   and backward among them); then at the lane (N 128, H 650) with times
   beside the twin's, the FMA / SIMT kernel's in the same call (in
   turns), device ms and host µs, cuDNN's whole-sequence LSTM per step
   (the median of three tries) and the bound (with a float32 W six bf16
   products, the FMA bound beside it), the lane's backward error (at most
   1e-3 with float32 carries), and one scan forward (event and host time)
   and forward + backward over T 35; the all-float32 backward's device,
   graph and event ms and host µs beside the SIMT kernel's, in turns
   (:func:`_in_turns`); then the all-float32 forward's the same way beside
   the FMA kernel's;
18. the word LM at bench.py's lane through the captured step (its
   dropout drawn from the generator each graph registers): 2 warm-up and
   5 timed steps; finite, falling loss; per step exactly 70
   ``lstm_fwd_gates`` and 70 ``lstm_bwd`` launches, counted through the
   replays, every one on the tensor-core route; tok/s and peak memory;
   the eager yardstick and the captured step in turns (three runs each);
   two replays after the same seed equal, a third without it not; with
   dropout 0 a replay and an eager step from the same state; a profiled
   window of two steps; then, after phase 16's spread is known, every
   pair of steps from the same state of phases 14 and 18 (captured and
   eager, remat and none) held to it (loss within rtol 1e-3, each
   parameter update within the spread of phase 16's per-block
   gradients); then two eval forwards,
   each 70 ``lstm_fwd`` launches and no other: the user's ``net(x)`` on
   the net's own float32 parameters (the tensor-core route, W in three
   bf16 pieces) and the trained
   parameters cast to bf16 (the tensor-core route), each timed;
19. the same model in float32 (dropout 0): one loss-and-gradient pass with
   the kernels against the same pass on the twins (loss rtol 1e-4, every
   gradient leaf within 1e-3 of its largest entry; the twins' pass
   launches no kernel), then one ``Trainer`` + ``autograd.record()`` step,
   which must launch the same kernels and give the same loss (a float32
   W_hh: every forward and every backward on the tensor-core route, W in
   three pieces);
20. the detection kernels (``multibox_match``, ``nms_keep``) against their
   twins on the card, on both routes (the cluster kernels, and the first
   design behind ``_route="simple"``): the matcher over N 20, 61, 5630 x
   M 1, 8, 32, 100 x B 1, 32 at thresholds 0.5 and 0.7 (all-padding and
   one-object rows, zero-area and duplicate anchors, repeated label
   boxes), plus N 20000, label state beyond shared memory (M 17500) and
   one block an image (B 80); NMS over k 8, 100, 400, 1024, 5630 x B 1,
   32 with force_suppress on and off (duplicate boxes, padding rows) and
   the eval point's leading 400 rows of wider rows. anchor_gt, anchor_iou
   and keep exact, loc_t within rtol 1e-6; the cluster kernels as built
   (registers, stack, local bytes, REDUX count; none with local bytes);
   then both routes' device, graph and event ms and host µs in turns at
   match (32, 5630, 1), (32, 5630, 32), (4, 5630, 1) and NMS (32, 400),
   (32, 5630), beside the twin's and the bound (no single PyTorch call
   computes either);
21. SSD-512 at bench.py's lane: 2 warm-up and 5 timed steps; finite,
   falling loss; exactly one ``multibox_match`` launch per step, every one
   on the cluster route, and no other kernel of the port (the SSD walks
   the backbone's children, so the fused ResNet stages are not on this
   lane); img/s, peak memory and a profiled window of two steps; then the
   eval point, one ``nms_keep`` launch on the cluster route, with the
   target assignment and the detection each timed beside its twin; then
   a ``Trainer`` + ``record()`` step at batch 4 (one cluster launch);
22. at the same width in float32, batch 8, cuDNN deterministic: the
   targets and the detections from the kernels equal the twins' exactly,
   and so do one step's loss and gradients (tolerance 0); then
   ``net.detect`` eager and hybridized (the forward captured, its anchors
   included): heads within 1e-5, detections equal where the heads are
   bitwise, one entry, one ``nms_keep`` launch, both times;
23. the rtc user kernels (this file's ``AXPY_SRC`` and ``SOFTMAX_SRC``,
   MXNet's custom_softmax_rtc.py pair) compiled with NVRTC to ``sm_90a``
   CUBINs, each module's compile time; the axpy at n 2^26 through
   ``launch`` and the call form against 2x + y (exact); the softmax
   forward (within 1e-6) and backward (exact) against their twins at the
   MLP's (64, 10) and the word LM's decoder (4480, 33278), with times
   beside the twin's, ``torch.add``'s / ``torch.softmax``'s /
   ``torch.scatter_add``'s and the byte bound; the host cost of one
   launch beside ``torch.add``'s dispatch; a launch with 100 KB of
   dynamic shared memory, and the errors of a refused launch (the
   driver's words), a compile error (NVRTC's log) and a strided output
   array; then the MLP for 20 steps with
   the rtc custom softmax as its head: finite, falling loss, exactly one
   forward and one backward rtc launch a step and no other kernel, a
   second run of the same 20 steps from the same weights with the
   twin-bodied op (first step's loss and gradients within rtol 1e-5,
   weights after 20 steps within rtol 1e-4), a profiled window of two
   steps, and ``check_consistency`` of the op across cpu and gpu(0).

Any failure raises, so the exit code is not 0. The last three lines of
standard output are the kernels' JSON record, the card line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import functools
import json
import re
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
DECODE_KERNELS = ("flash_decode_step", "flash_decode_step_paged")
DECODE_REPLACES = {
    "flash_decode_step":
        "incubator_mxnet_tpu/ops/pallas/flash_attention.py:1417",
    "flash_decode_step_paged":
        "incubator_mxnet_tpu/ops/pallas/flash_attention.py:1559"}
# the serving lane's geometry and two length sets: the ragged one of a
# serving run and every slot full
DECODE_LANE = dict(H=12, d=64, C=512, P=64)
DECODE_SHAPES = {"ragged": [8, 64, 65, 129, 200, 264, 333, 512],
                 "full": [512] * 8}
# the routes timed in turns: the split kernels (the route the model takes)
# and the old one-block-a-cell kernel (private ``_route="simple"``)
DECODE_ROUTES = (None, "simple")


def decode_inputs(g, dt, lengths_list, H=12, d=64, C=512, P=64):
    """Operands of both decode kernels for ``len(lengths_list)`` slots: q, a
    contiguous cache (S, H, C, d) whose positions at or past each slot's
    length hold large finite garbage, and a page pool (S * C / P + 1, H, P,
    d) addressed through a scrambled block table whose dead entries point
    at the last page, a trash page of garbage. Nothing past a slot's
    length may reach its output."""
    S, max_pages = len(lengths_list), C // P
    n_pages = S * max_pages

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    bt = torch.randperm(n_pages, generator=g, device="cuda").reshape(
        S, max_pages).to(torch.int32)
    q = rnd(S, H, d)
    kc, vc = rnd(S, H, C, d), rnd(S, H, C, d)
    kp, vp = rnd(n_pages + 1, H, P, d), rnd(n_pages + 1, H, P, d)
    for s, n in enumerate(lengths_list):
        bt[s, -(-n // P):] = n_pages
        kc[s, :, n:] = 1e4
        vc[s, :, n:] = -1e4
    kp[n_pages] = 1e4
    vp[n_pages] = -1e4
    return {"q": q, "kc": kc, "vc": vc, "kp": kp, "vp": vp, "P": P,
            "bt": bt, "lengths": torch.tensor(lengths_list,
                                              dtype=torch.int32,
                                              device="cuda")}


def decode_calls(fa, x, route=None):
    """{kernel: (kernel call (k, v), plain twin (k, v), (k, v))} on the
    operands ``x`` of :func:`decode_inputs`, the kernels on ``route``."""
    kw = {} if route is None else {"_route": route}
    q, lengths, bt, P = x["q"], x["lengths"], x["bt"], x["P"]
    return {
        "flash_decode_step": (
            lambda k, v: fa.flash_decode_step(q, k, v, lengths, block_k=P,
                                              **kw),
            lambda k, v: fa.decode_attention_reference(q, k, v, lengths,
                                                       block_k=P),
            (x["kc"], x["vc"])),
        "flash_decode_step_paged": (
            lambda k, v: fa.flash_decode_step_paged(q, k, v, bt, lengths,
                                                    **kw),
            lambda k, v: fa.paged_decode_attention_reference(
                q, k, v, bt, lengths),
            (x["kp"], x["vp"])),
    }


def decode_parity(fa, x, atol, tag, routes=DECODE_ROUTES):
    """Each kernel on each route against its plain twin; the largest
    error of each kernel over the routes."""
    errs = {}
    for route in routes:
        for name, (kern, plain, (k, v)) in decode_calls(fa, x,
                                                          route).items():
            out = kern(k, v)
            torch.cuda.synchronize()
            err = (out.float() - plain(k, v).float()).abs().max().item()
            if not torch.isfinite(out).all() or err > atol:
                raise AssertionError(
                    f"{name} ({route or 'split'}) {tag}: max |kernel - "
                    f"plain| {err} > {atol}")
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


class _Rotation:
    """Copies of K/V that together exceed the 50 MB L2 (as 12 layers'
    caches do when serving); each call reads the next copy, so no reading
    finds its operands in L2, a graph replay included."""

    def __init__(self, k, v, min_bytes=120_000_000):
        n = max(2, -(-min_bytes // (2 * k.nbytes)))
        self.kv = [(k.clone(), v.clone()) for _ in range(n)]
        self.i = 0

    def __call__(self, f):
        kk, vv = self.kv[self.i % len(self.kv)]
        self.i += 1
        return f(kk, vv)


def decode_timings(fa, shape, routes=DECODE_ROUTES, rounds=2):
    """bf16 times of both kernels at the serving lane with the length set
    ``shape``: each route's device ms (torch.profiler, every kernel of a
    call, launches from the wrapper's counter), graph ms (a CUDA graph of
    20 calls, each on the next K/V copy), event ms (a loop of wrapper
    calls between CUDA events) and host µs, taken in turns over
    ``rounds`` rounds (the route order reversed every other round) and
    averaged; beside them the plain twin's and masked SDPA's event ms and
    the byte bound. Returns {kernel: record}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    lens = DECODE_SHAPES[shape]
    x = decode_inputs(g, torch.bfloat16, lens, **DECODE_LANE)
    H, d, C = DECODE_LANE["H"], DECODE_LANE["d"], DECODE_LANE["C"]
    out = {}
    for name in DECODE_KERNELS:
        calls = {r: decode_calls(fa, x, r)[name] for r in routes}
        _, plain, (k, v) = calls[routes[0]]
        rot = _Rotation(k, v)
        turns = _in_turns({r or "split": (lambda kern=calls[r][0]: rot(kern))
                           for r in routes}, getattr(fa, name), rounds)
        plain_ms = time_ms(lambda: rot(plain), iters=10, warmup=2)
        library_ms = None
        if name == "flash_decode_step":
            mask = (torch.arange(C, device="cuda")[None, :]
                    < x["lengths"][:, None].long())[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            q4 = x["q"][:, :, None]
            library_ms = time_ms(lambda: rot(
                lambda kk, vv: sdpa(q4, kk, vv, attn_mask=mask)))
        esz = x["q"].element_size()
        idx_bytes = x["lengths"].nbytes + (x["bt"].nbytes if "paged" in name
                                           else 0)
        moved = 2 * sum(lens) * H * d * esz + 2 * x["q"].nbytes + idx_bytes
        flops = 4 * sum(lens) * H * d
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        rec = {"shape": shape, "mb": moved / 1e6,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "plain_ms": plain_ms, "library_ms": library_ms,
               "kernels": {t: r.pop("kernels") for t, r in turns.items()}}
        for t, r in turns.items():
            rec.update({f"{t}_{key}": val for key, val in r.items()})
        out[name] = rec
        log(f"time {name} bf16 {shape} ({moved / 1e6:.2f} MB, bound "
            f"{rec['bound_ms']:.5f} ms): {_turns_line(turns)}; plain "
            f"{plain_ms:.4f} ms, library {library_ms} ms")
        del rot
    return out


def _decode_split_kernel_name(mangled):
    """``decode_split_kernel<bf16,1>`` (the type, paged or not) from a
    mangled name, or None for another kernel of decode_attention.cu."""
    m = re.search(r"(decode_split_kernel)I(f|13__nv_bfloat16)Lb([01])E",
                  mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}," \
           f"{m.group(3)}>"


def decode_sass_check(common):
    """decode_attention.cu's split kernels as built (float32 and bf16,
    contiguous and paged), each with bulk copies (UBLKCP) and no local
    bytes."""
    kernels = _sass_kernels(common, "decode_attention*.o",
                            _decode_split_kernel_name, "UBLKCP")
    if len(kernels) != 4:
        raise AssertionError(f"expected 4 split decode kernels, found "
                             f"{sorted(kernels)}")
    return kernels


def _sweep_lengths(span, *bounds):
    """0, 1, each boundary -1/0/+1 and the full span, within [0, span]."""
    lens = {0, 1, span - 1, span}
    for b in bounds:
        lens.update((b - 1, b, b + 1))
    return sorted(n for n in lens if 0 <= n <= span)


def kernel_checks(fa, common):
    """Phase 3: both decode kernels as built, against their plain twins on
    every route over a sweep and at the serving lane, two calls bitwise
    equal, and their times at the lane (ragged and full lengths)."""
    decode_sass_check(common)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tname = str(dt)[6:]
        esz = torch.tensor([], dtype=dt).element_size()
        # the sweep: 3 heads, d 32/64/128, page 16/64 (the contiguous
        # cache as long as 8 pages), lengths at the tile and page
        # boundaries of the split plan
        n_cases = 0
        for d in (32, 64, 128):
            for P in (16, 64):
                C = 8 * P
                rows = {fa.decode_split_plan(1, pl, n, d, esz)[0]
                        for pl, n in ((P, 8), (C, 1))}     # paged, contig
                lens = _sweep_lengths(C, P, 2 * P, *rows, *(2 * r for r in
                                                             rows))
                x = decode_inputs(g, dt, lens, H=3, d=d, C=C, P=P)
                decode_parity(fa, x, atol, f"{tname} d {d} page {P}")
                n_cases += 1
        # long caches: runs of several tiles a split, and their combine
        lens = _sweep_lengths(4096, 64, 256, 1000)
        x = decode_inputs(g, dt, lens, H=12, d=64, C=4096, P=64)
        long_errs = decode_parity(fa, x, atol, f"{tname} C 4096")
        plan = fa.decode_split_plan(len(lens) * 12, 64, 64, 64, esz)
        log(f"parity sweep {tname}: {n_cases} geometries (d 32/64/128, "
            f"page 16/64) and C 4096 (plan {plan[:3]}: rows, tiles a "
            f"split, splits) on routes {DECODE_ROUTES}: within {atol}, "
            f"C 4096 {long_errs}")
        # the serving lane with its ragged lengths
        x = decode_inputs(g, dt, DECODE_SHAPES["ragged"], **DECODE_LANE)
        lane = {r: decode_parity(fa, x, atol, f"{tname} lane", (r,))
                for r in DECODE_ROUTES}
        for name, (kern, _, (k, v)) in decode_calls(fa, x).items():
            if not torch.equal(kern(k, v), kern(k, v)):
                raise AssertionError(f"{name} {tname}: two calls differ")
        errs[dt] = lane
        log(f"parity lane {tname}: {json.dumps(lane)} (atol {atol}); two "
            f"calls bitwise equal")
    timings = {shape: decode_timings(fa, shape) for shape in DECODE_SHAPES}
    records = {}
    for name in DECODE_KERNELS:
        t = timings["ragged"][name]
        records[name] = {
            "name": name, "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/ops/cuda/csrc/"
                      "decode_attention.cu",
            "replaces": DECODE_REPLACES[name], "launches": 0,
            "max_abs_err": errs[torch.bfloat16][None][name],
            "ms": t["split_event_ms"], "device_ms": t["split_device_ms"],
            "graph_ms": t["split_graph_ms"], "host_us": t["split_host_us"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
    return records, timings


# ---------------------------------------------------------------- serving
def _consume(fut, stamps):
    for _ in fut.stream(timeout=300.0):
        stamps.append(time.perf_counter())


def open_engine(serving, params, cfg, gen_kw, warm_prompt, capture=True):
    """A fresh engine with the model loaded and warmed by one short
    request (first-call set-up stays out of the measured run): its steps
    captured as CUDA graphs at load, or, with ``capture`` False, the eager
    yardstick (``_GenerativeModel(_capture=False)``, the private argument
    no user passes)."""
    model_cls = serving._GenerativeModel
    if not capture:
        serving._GenerativeModel = functools.partial(model_cls,
                                                     _capture=False)
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
    finally:
        serving._GenerativeModel = model_cls


def _count_decode_steps(model):
    """Counts the model's decode steps from here on (the token loop looks
    ``model.decode`` up at every step): a one-element list."""
    steps, real = [0], model.decode

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)
    model.decode = counted
    return steps


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


def serve_run(serving, fa, common, params, cfg, prompts, max_new, warm,
              gen_kw, capture, breakdown=False):
    """One engine (captured steps, or the eager yardstick) over
    ``prompts``, request 5 sampled: its streams, tok/s, TTFT and ITL p50,
    prefix hits, decode steps and decode-kernel launches (each on the
    split route, 12 a decode step, counted through graph replays), and,
    with ``breakdown``, :func:`decode_breakdown` of its model. Checks
    that a captured engine's load counted ``len(buckets) + 1`` compiles
    and traces (an eager one none) and that traffic moved neither."""
    counter = serving._telemetry.counter
    compiles = counter("mxtpu_serve_compiles_total")
    traces = counter("mxtpu_serve_gen_traces_total")
    c0, t0 = compiles.value(model="lm"), traces.value(model="lm")
    eng, ep = open_engine(serving, params, cfg, gen_kw, warm, capture)
    label = ("captured" if capture else "eager") + (
        " contiguous" if ep.model.paged is False else "")
    kernel = ("flash_decode_step_paged" if ep.model.paged
              else "flash_decode_step")
    try:
        c1, t1 = compiles.value(model="lm"), traces.value(model="lm")
        want = len(ep.buckets) + 1 if capture else 0
        if (c1 - c0, t1 - t0) != (want, want):
            raise AssertionError(f"serve {label}: load counted {c1 - c0} "
                                 f"compiles and {t1 - t0} traces, not "
                                 f"{want}")
        hits0 = eng.stats()["lm"].get("prefix_hits", 0)
        steps = _count_decode_steps(ep.model)
        fa.reset_launch_counts()
        futs, stamps, outs, wall = drive(ep, prompts, max_new, sampled={5})
        launches = fa.launch_counts()[kernel]
        split = common.sm90_launch_counts()[kernel]
        n_steps = steps[0]
        if ep.pool is not None:
            wait_pages_free(ep)
        hits = eng.stats()["lm"].get("prefix_hits", 0) - hits0
        if (compiles.value(model="lm"), traces.value(model="lm")) != (c1,
                                                                     t1):
            raise AssertionError(f"serve {label}: traffic moved the "
                                 "compile or trace counter")
        bd = decode_breakdown(ep.model) if breakdown else {}
    finally:
        eng.close()
    for o in outs:
        if not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError("token id out of vocabulary")
    per_step = cfg.n_layers
    if launches != per_step * n_steps or split != launches:
        raise AssertionError(
            f"serve {label}: {launches} {kernel} launches ({split} on the "
            f"split route) in {n_steps} decode steps, not "
            f"{per_step} a step, all split")
    ttft = [s[0] - f.t_submit for f, s in zip(futs, stamps)]
    itl = [b - a for s in stamps for a, b in zip(s, s[1:])]
    n_tok = sum(len(o) for o in outs)
    res = {"tok_s": n_tok / wall, "ttft_p50_ms": np.median(ttft) * 1e3,
           "itl_p50_ms": np.median(itl) * 1e3, "prefix_hits": hits,
           "decode_steps": n_steps, "launches": launches,
           "compiles_at_load": c1 - c0, **bd}
    log(f"serve {label}: {len(prompts)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {res['tok_s']:.1f} tok/s; TTFT p50 "
        f"{res['ttft_p50_ms']:.2f} ms, ITL p50 {res['itl_p50_ms']:.2f} ms; "
        f"prefix hits {hits}; {n_steps} decode steps, {launches} {kernel} "
        f"launches (all split); compiles at load {c1 - c0}"
        + (f"; step wall {bd['step_wall_ms']:.3f} ms, busy "
           f"{_ms(bd['device_busy_ms'])} ms, idle "
           f"{_ms(bd['device_idle_share'])}" if bd else ""))
    return outs, res


def serving_phase(serving, tt, fa, common, records):
    """Phase 4: the full-width LM served by the paged engine (the default)
    with its steps captured as CUDA graphs and by the eager yardstick, in
    turns, two rounds each (captured, eager, eager, captured) on the same
    16 prompts: every engine's streams equal (request 5 sampled), the
    captured engine's load counting ``len(buckets) + 1`` compiles, the
    decode kernel 12 launches a decode step on the split route, the
    decode breakdown of both; then the contiguous engine's short pass,
    captured and eager, streams equal."""
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

    runs = {"captured": [], "eager": []}
    streams = {}
    for i, capture in enumerate((True, False, False, True)):
        label = "captured" if capture else "eager"
        outs, res = serve_run(serving, fa, common, params, cfg, prompts,
                              max_new, warm, {}, capture,
                              breakdown=i >= 2)
        runs[label].append(res)
        streams.setdefault(label, outs)
        if outs != streams["captured"]:
            raise AssertionError(f"serve {label} round {i}: token streams "
                                 "differ from the captured engine's")
        if res["prefix_hits"] < 1:
            raise AssertionError("the shared prefix never hit the prefix "
                                 "cache")

    # contiguous engine: a short pass, captured and eager
    short = prompts[1:5]
    contig = {}
    for capture in (True, False):
        outs, res = serve_run(serving, fa, common, params, cfg, short, 16,
                              warm, {"paged": 0}, capture)
        contig["captured" if capture else "eager"] = (outs, res)
    if contig["captured"][0] != contig["eager"][0]:
        raise AssertionError("serve contiguous: captured and eager streams "
                             "differ")
    records["flash_decode_step_paged"]["launches"] = \
        runs["captured"][0]["launches"]
    records["flash_decode_step"]["launches"] = \
        contig["captured"][1]["launches"]

    def mean(label, key):
        vals = [r[key] for r in runs[label] if r.get(key) is not None]
        return sum(vals) / len(vals) if vals else None
    keys = ("tok_s", "ttft_p50_ms", "itl_p50_ms")
    out = {k: mean("captured", k) for k in keys}
    out.update({f"eager_{k}": mean("eager", k) for k in keys})
    for label, prefix in (("captured", ""), ("eager", "eager_")):
        out.update({prefix + k: v for k, v in runs[label][-1].items()
                    if k not in keys})
    out["rounds"] = runs
    log(f"serve paged, captured vs eager in turns (means of two rounds): "
        f"tok/s {out['tok_s']:.1f} vs {out['eager_tok_s']:.1f}; TTFT p50 "
        f"{out['ttft_p50_ms']:.2f} vs {out['eager_ttft_p50_ms']:.2f} ms; "
        f"ITL p50 {out['itl_p50_ms']:.2f} vs {out['eager_itl_p50_ms']:.2f}"
        f" ms; streams equal (request 5 sampled), contiguous too")
    return out


# the CPU side's records of a kernel launch, and of a CUDA graph's replay
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_GRAPH_CALLS = ("cudaGraphLaunch",)


def _device_events(window, tries: int = 3, calls=None):
    """Run ``window()`` under torch.profiler until the tracer delivers
    device events, up to ``tries`` windows (on the card a window has come
    back without any, and once three in a row). Returns (the window's
    CUDA kernel events, or None if no window had any; ``window()``'s value
    from the last window). ``calls``, a dict, receives the window's counts
    of kernel launch calls and graph replays on the CPU side."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            value = window()
        events = prof.key_averages()
        dev = [e for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.count
               and e.self_device_time_total > 0]
        if calls is not None:
            calls["launch"] = sum(e.count for e in events
                                  if e.key in _LAUNCH_CALLS)
            calls["graph"] = sum(e.count for e in events
                                 if e.key in _GRAPH_CALLS)
        if dev:
            return dev, value
        log(f"the profiler delivered no device event (window {attempt + 1}"
            f" of {tries})")
    return None, value


def decode_breakdown(model, steps: int = 10):
    """Device time torch.profiler records for ``steps`` full-width decode
    steps (8 live slots, lengths 50..200, greedy) against the wall time of
    the same steps: the device's busy time and idle share, and the
    attention kernel's time (None, not measured, if the profiler delivers
    no device event). The wall time of as many
    unprofiled steps is the wall the idle share is read over
    (``device_idle_share``); the profiled window's share stands beside it
    (``profiled_window_idle_share``)."""
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

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3
    dev, prof_wall_ms = _device_events(window)
    if dev is None:
        out = {"step_wall_ms": wall_ms, "profiled_step_wall_ms":
               prof_wall_ms, "device_busy_ms": None,
               "device_idle_share": None,
               "profiled_window_idle_share": None,
               "attention_kernel_ms": None}
        log(f"decode step breakdown: device time not measured "
            f"{json.dumps(out)}")
        return out
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    attn_ms = sum(e.self_device_time_total for e in dev
                  if re.search(r"decode_(split|combine|attn)_kernel", e.key)
                  ) / steps / 1e3
    if busy_ms > prof_wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {prof_wall_ms} ms")
    out = {"step_wall_ms": wall_ms, "profiled_step_wall_ms": prof_wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "profiled_window_idle_share": 1 - busy_ms / prof_wall_ms,
           "attention_kernel_ms": attn_ms}
    log(f"decode step breakdown: {json.dumps(out)} (device_idle_share: "
        f"busy over the unprofiled steps' wall; the profiled window, which "
        f"the profiler stretches, beside it)")
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
# the JSON line's records of phase 6: the float32 kernels (the timed
# steps' type), then the bf16 Hopper kernels: the forward, the backward
# pair (dq, then dk/dv)
TRAIN_RECORDS = TRAIN_KERNELS + ("flash_fwd/wgmma", "flash_bwd_pair/wgmma")
FLASH_SM90_SOURCE = ("incubator_mxnet_tpu_torch/ops/cuda/csrc/"
                     "flash_attention_sm90.cu")
# (forward atol, gradient atol) per input type
TRAIN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 5e-2)}


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def train_kernel_sweep(fa, g):
    """Phase 6, first part: every training kernel against its plain twin
    on the shapes the main path does not reach at full width: head dims
    32, 64 and 128; T 200 (a tail tile of 8 rows), sq 96 / sk 160 and
    sq 160 / sk 96 (key tiles no query row reaches under the top-left
    causal mask), and in bf16 also T 512 and sq 1 / sk 7; causal and not;
    both layouts and both types; B 2, H 4; float32 on its split-bf16 route
    and on the FMA route, bf16 on its Hopper route (every kernel checked
    by its ``sm90_launches``; the backward's two calls bitwise equal) and
    on the WMMA kernels. Tolerances as at the training shapes. Returns the
    worst error per kernel, type and route."""
    B, H = 2, 4
    worst = {}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = TRAIN_TOL[dt]
        routes = (None, "fma") if dt == torch.float32 else (None, "wmma")
        shapes = ((200, 200), (96, 160), (160, 96)) + (
            ((512, 512), (1, 7)) if dt == torch.bfloat16 else ())
        for d in (32, 64, 128):
            for sq, sk in shapes:
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
                        lay = "packed" if n_heads else "head-major"
                        ref_out, ref_lse = fa.flash_forward_reference(
                            q, k, v, **kw)
                        prod = do.float() * ref_out.float()
                        delta = (prod.view(B, sq, H, d).sum(-1) if n_heads
                                 else prod.sum(-1))
                        rq, rk, rv = fa.flash_backward_reference(
                            q, k, v, do, ref_lse, delta, **kw)
                        for route in routes:
                            rkw = dict(kw, _route=route)
                            before = [getattr(fa, n).sm90_launches
                                      for n in TRAIN_KERNELS]
                            out, lse = fa.flash_fwd(q, k, v, **rkw)
                            dq = fa.flash_bwd_dq(q, k, v, do, ref_lse,
                                                 delta, **rkw)
                            dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse,
                                                      delta, **rkw)
                            for n, b0 in zip(TRAIN_KERNELS, before):
                                if getattr(fa, n).sm90_launches - b0 != (
                                        route is None):
                                    raise AssertionError(
                                        f"{n} {dt} route {route}: not on "
                                        f"the route asked for")
                            if dt == torch.bfloat16 and route is None:
                                _bitwise_repeats(
                                    lambda rkw=rkw: (
                                        fa.flash_bwd_dq(q, k, v, do, ref_lse,
                                                        delta, **rkw),
                                        *fa.flash_bwd_dkv(q, k, v, do,
                                                          ref_lse, delta,
                                                          **rkw)),
                                    f"bf16 backward d {d} sq {sq} sk {sk} "
                                    f"causal {causal} {lay}")
                            errs = {"flash_fwd": max(_max_err(out, ref_out),
                                                     _max_err(lse, ref_lse)),
                                    "flash_bwd_dq": _max_err(dq, rq),
                                    "flash_bwd_dkv": max(_max_err(dk, rk),
                                                         _max_err(dv, rv))}
                            outs = [out, lse, dq, dk, dv]
                            finite = all(torch.isfinite(t.float()).all()
                                         for t in outs)
                            for name, err in errs.items():
                                atol = (atol_f if name == "flash_fwd"
                                        else atol_b)
                                if not finite or err > atol:
                                    raise AssertionError(
                                        f"{name} {dt} route {route} d {d} "
                                        f"sq {sq} sk {sk} causal {causal} "
                                        f"{lay}: max |kernel - plain| "
                                        f"{err} > {atol}")
                                key = (f"{name} {str(dt)[6:]}"
                                       f"{' ' + route if route else ''}")
                                worst[key] = max(worst.get(key, 0.0), err)
                            n_cases += 1
    log(f"shape sweep: {n_cases} cases (d 32/64/128; T 200, sq 96 sk 160, "
        f"sq 160 sk 96, bf16 also T 512 and sq 1 sk 7; causal and not; both "
        f"layouts and types; float32 on both routes, bf16 on the wgmma and "
        f"the WMMA kernels, the wgmma backward's two calls bitwise equal) "
        f"within tolerance; worst max_abs_err {json.dumps(worst)}")
    return worst



def _flash_mma_kernel_name(mangled):
    """``flash_fwd_mma_kernel<64>`` (the head dim) from a mangled name, or
    None for a kernel of flash_attention.cu off the float32 route."""
    m = re.search(r"(flash_\w+?_mma_kernel)ILi(\d+)EE", mangled)
    return None if m is None else f"{m.group(1)}<{m.group(2)}>"


def _flash_wgmma_kernel_name(mangled):
    """``flash_bwd_dq_wgmma_kernel<64>`` (the head dim) from a mangled name,
    or None for another kernel."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)EE",
                  mangled)
    return None if m is None else f"{m.group(1)}<{m.group(2)}>"


def flash_sass_check(common):
    """flash_attention.cu's float32-route kernels as built (forward, dq and
    dk/dv at d 32, 64 and 128), each with HMMA (``mma.sync``) and no local
    bytes; and flash_attention_sm90.cu's bf16 forward, dq and dk/dv at d
    32, 64 and 128, each with HGMMA (``wgmma``), no local bytes and no
    stack (no spills)."""
    kernels = _sass_kernels(common, "flash_attention.*o",
                            _flash_mma_kernel_name, "HMMA")
    if len(kernels) != 9:
        raise AssertionError(f"expected 9 float32-route flash kernels, "
                             f"found {sorted(kernels)}")
    wgmma = _sass_kernels(common, "flash_attention_sm90*.o",
                          _flash_wgmma_kernel_name, "HGMMA", no_stack=True)
    if len(wgmma) != 9:
        raise AssertionError(f"expected 9 bf16 wgmma flash kernels, found "
                             f"{sorted(wgmma)}")
    kernels.update(wgmma)
    return kernels


def _flash_f64(q, k, v, n_heads, scale):
    """Packed (B, T, H d) float32 q, k, v as float64 head-major tensors,
    the query scaled in float32 first as the packed kernels do, and the
    causal float64 scores."""
    B, T, HD = q.shape

    def hm(t):
        return t.view(B, T, n_heads, HD // n_heads).transpose(1, 2).double()

    qs = hm(q * torch.tensor(scale, dtype=q.dtype, device=q.device))
    kh, vh = hm(k), hm(v)
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = (qs @ kh.transpose(-1, -2)).masked_fill(~keep, -1e30)
    return qs, kh, vh, hm, s


def _packed64(t):
    B, H, T, d = t.shape
    return t.transpose(1, 2).reshape(B, T, H * d)


def flash_product_check(fa, g, device="cuda"):
    """Phase 6: each float32 kernel's max absolute error against the same
    function in float64 at its rounding points (the packed query scaled in
    float32; P and dS rounded to float32 before their products) on a slice
    of the lane (B 2, H 12, T 512, d 64, packed, causal), on the split-bf16
    route and the FMA route in turns, from the same inputs (the backward
    from the float64 lse and delta, rounded to float32). The split route
    must read no worse than the FMA route."""
    B, H, T, d = 2, 12, 512, 64
    scale = 1.0 / d ** 0.5
    q, k, v, do = (torch.randn((B, T, H * d), generator=g, device=device)
                   for _ in range(4))
    qs, kh, vh, hm, s = _flash_f64(q, k, v, H, scale)
    out64 = _packed64(torch.softmax(s, -1) @ vh)
    lse64 = torch.logsumexp(s, -1).transpose(1, 2)
    lse = lse64.float().contiguous()
    delta = (do.double() * out64).view(B, T, H, d).sum(-1).float()
    gh = hm(do)
    p = torch.exp(s - lse.transpose(1, 2).double()[..., None])
    ds = (p * (gh @ vh.transpose(-1, -2)
               - delta.transpose(1, 2).double()[..., None])).float().double()
    dq64 = _packed64(ds @ kh) * scale
    dk64 = _packed64(ds.transpose(-1, -2) @ qs)
    dv64 = _packed64(p.float().double().transpose(-1, -2) @ gh)
    del qs, kh, vh, s, p, ds, gh
    kw = dict(causal=True, n_heads=H)
    errs = {}
    for route in (None, "fma"):
        tag = "split" if route is None else "fma"
        out, lse_k = fa.flash_fwd(q, k, v, _route=route, **kw)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, _route=route, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, _route=route,
                                  **kw)
        errs[tag] = {
            "flash_fwd": max(_max_err(out, out64), _max_err(lse_k, lse64)),
            "flash_bwd_dq": _max_err(dq, dq64),
            "flash_bwd_dkv": max(_max_err(dk, dk64), _max_err(dv, dv64))}
    log(f"product check (B 2, H 12, T 512, d 64, packed, causal; max "
        f"|kernel - float64|): {json.dumps(errs)}")
    for name in TRAIN_KERNELS:
        if not errs["split"][name] <= errs["fma"][name]:
            raise AssertionError(
                f"{name}: the split route's error against float64 "
                f"{errs['split'][name]} exceeds the FMA route's "
                f"{errs['fma'][name]}")
    return errs


def _sdpa_backend(q, k, v):
    """The SDPA backend PyTorch picks for these causal inputs, and the
    backends enabled."""
    from torch.nn.attention import SDPBackend
    be = torch.backends.cuda
    return {"chosen": SDPBackend(torch._fused_sdp_choice(
                q, k, v, is_causal=True)).name,
            "enabled": {"flash": be.flash_sdp_enabled(),
                        "mem_efficient": be.mem_efficient_sdp_enabled(),
                        "math": be.math_sdp_enabled(),
                        "cudnn": be.cudnn_sdp_enabled()}}


def train_kernel_checks(fa, common):
    """Phase 6: parity and timing of the training kernels. Returns the
    JSON records (float32, packed: the timed training steps' type and
    layout) and a log of every timing. In float32 the split-bf16 route,
    the FMA route and SDPA are timed in turns in this call; the records
    carry the six-product bound (a float32 operand in three bf16 pieces,
    six bf16 products) with the FMA bound beside it."""
    B, H, T, d = 32, 12, 512, 64
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records, timings = {}, {}
    timings["sass"] = flash_sass_check(common)
    timings["sweep"] = train_kernel_sweep(fa, g)
    timings["products"] = flash_product_check(fa, g)
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
            # timing in the main path's layout; every operand exceeds L2.
            # float32: the split route, the FMA route and SDPA in turns
            routes = (None, "fma") if dt == torch.float32 else (None,)
            calls = {}
            for route in routes:
                rkw = dict(kw, _route=route)
                calls[("flash_fwd", route)] = (
                    lambda rkw=rkw: fa.flash_fwd(q, k, v, **rkw))
                calls[("flash_bwd_dq", route)] = (
                    lambda rkw=rkw: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    **rkw))
                calls[("flash_bwd_dkv", route)] = (
                    lambda rkw=rkw: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                     delta, **rkw))
            qr, kr, vr = (x.detach().requires_grad_(True) for x in hm[:3])
            o = sdpa(qr, kr, vr, is_causal=True)
            calls[("sdpa_fwd", None)] = lambda: sdpa(qr, kr, vr,
                                                     is_causal=True)
            calls[("sdpa_bwd", None)] = lambda: torch.autograd.grad(
                o, (qr, kr, vr), hm[3], retain_graph=True)
            readings = {key: [] for key in calls}
            for _ in range(2):
                for key, fn in calls.items():
                    readings[key].append(time_ms(fn, iters=20))
            ev = {key: sum(r) / len(r) for key, r in readings.items()}
            sdpa_fwd_ms = ev[("sdpa_fwd", None)]
            sdpa_bwd_ms = ev[("sdpa_bwd", None)]
            del o, qr, kr, vr
            if dt == torch.float32:
                timings["sdpa_backend float32"] = _sdpa_backend(*hm[:3])
                log("SDPA float32: "
                    + json.dumps(timings["sdpa_backend float32"]))
            # one plain twin computes dq, dk and dv together
            plain = {"flash_fwd": time_ms(lambda: fa.flash_forward_reference(
                q, k, v, **kw), iters=3, warmup=1)}
            plain["flash_bwd_dq"] = plain["flash_bwd_dkv"] = time_ms(
                lambda: fa.flash_backward_reference(q, k, v, do, lse, delta,
                                                    **kw), iters=3, warmup=1)
            esz = q.element_size()
            x_bytes = B * H * T * d * esz
            row_bytes = B * H * T * 4
            pairs = B * H * T * (T + 1) // 2      # causal (row, col) pairs
            work = {"flash_fwd": (4 * x_bytes + row_bytes, 4 * d * pairs),
                    "flash_bwd_dq": (5 * x_bytes + 2 * row_bytes,
                                     6 * d * pairs),
                    "flash_bwd_dkv": (6 * x_bytes + 2 * row_bytes,
                                      8 * d * pairs)}
            # a float32 operand split in three bf16 pieces: six bf16
            # products on the tensor cores
            pieces = 6 if dt == torch.float32 else 1
            for name in TRAIN_KERNELS:
                moved, flops = work[name]
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = pieces * flops / PEAK_FLOPS[torch.bfloat16] * 1e3
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
                    "launches": 0, "max_abs_err": errs[name],
                    "ms": ev[(name, None)],
                    "graph_ms": graph_ms(calls[(name, None)]),
                    "plain_ms": plain[name],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": sdpa_fwd_ms if name == "flash_fwd"
                    else None,
                    "kernel_route": fa.flash_train_route(dt),
                }
                if dt == torch.float32:
                    t_fma = flops / PEAK_FLOPS[torch.float32] * 1e3
                    rec.update(
                        fma_ms=ev[(name, "fma")],
                        fma_graph_ms=graph_ms(calls[(name, "fma")]),
                        fma_bound_ms=max(t_bytes, t_fma),
                        product_err=timings["products"]["split"][name],
                        fma_product_err=timings["products"]["fma"][name])
                    records[name] = rec
                timings[f"{name} {str(dt)[6:]}"] = rec
                log(f"time {name} {str(dt)[6:]}: {rec['ms']:.4f} ms event "
                    f"(two rounds {readings[(name, None)]}), graph "
                    f"{rec['graph_ms']} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                    + (f"; FMA route {rec['fma_ms']:.4f} ms event (two "
                       f"rounds {readings[(name, 'fma')]}), graph "
                       f"{rec['fma_graph_ms']} ms, FMA bound "
                       f"{rec['fma_bound_ms']:.4f} ms"
                       if dt == torch.float32 else ""))
            # the per-kernel bounds above count the two-pass recompute of
            # s and dP; the function the pair replaces needs 10 d flops per
            # causal pair and moves q, k, v, dO, lse, delta in and dq, dk,
            # dv out once
            t_bytes = (7 * x_bytes + 2 * row_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = pieces * 10 * d * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
            pair = {"ms": sum(ev[(n, None)] for n in TRAIN_KERNELS[1:]),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": sdpa_bwd_ms}
            if dt == torch.float32:
                pair["fma_ms"] = sum(ev[(n, "fma")]
                                     for n in TRAIN_KERNELS[1:])
                pair["fma_bound_ms"] = max(
                    t_bytes, 10 * d * pairs / PEAK_FLOPS[dt] * 1e3)
            timings[f"flash_bwd_pair {str(dt)[6:]}"] = pair
            log(f"time flash_bwd_pair {str(dt)[6:]}: {json.dumps(pair)}")
            log(f"time sdpa causal {str(dt)[6:]}: forward {sdpa_fwd_ms:.4f}"
                f" ms, backward {sdpa_bwd_ms:.4f} ms (two rounds each "
                f"{readings[('sdpa_fwd', None)]}, "
                f"{readings[('sdpa_bwd', None)]})")
            timings[f"sdpa {str(dt)[6:]}"] = {"fwd_ms": sdpa_fwd_ms,
                                              "bwd_ms": sdpa_bwd_ms}
            if dt == torch.bfloat16:
                records["flash_fwd/wgmma"] = bf16_forward_record(
                    fa, q, k, v, hm, kw, errs["flash_fwd"],
                    plain["flash_fwd"], work["flash_fwd"])
                records["flash_bwd_pair/wgmma"] = bf16_backward_record(
                    fa, (q, k, v, do, lse, delta), hm, kw,
                    max(errs["flash_bwd_dq"], errs["flash_bwd_dkv"]),
                    plain["flash_bwd_dq"],
                    (7 * x_bytes + 2 * row_bytes, 10 * d * pairs))
    return records, timings


def bf16_forward_record(fa, q, k, v, hm, kw, err, plain_ms, work):
    """Phase 6: the bf16 forward's JSON record at the lane (packed, causal):
    its Hopper kernel, the old WMMA kernel (``_route="wmma"``) and SDPA on
    the same values (head-major, its own layout) in turns (``_in_turns``:
    device, graph and event ms and host µs, two rounds), beside the twin's
    ms and the bound (q, k, v, out once and lse, or the causal products at
    the bf16 peak)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = _in_turns(
        {"wgmma": lambda: fa.flash_fwd(q, k, v, **kw),
         "wmma": lambda: fa.flash_fwd(q, k, v, _route="wmma", **kw),
         "sdpa": lambda: sdpa(*hm[:3], is_causal=True)},
        {"wgmma": fa.flash_fwd, "wmma": fa.flash_fwd, "sdpa": None})
    log(f"turns flash_fwd bf16 packed: {_turns_line(turns)}")
    return _wgmma_record("flash_fwd/wgmma", ":699", turns, err, plain_ms,
                         work)


def bf16_backward_record(fa, args, hm, kw, err, plain_ms, work):
    """Phase 6: the bf16 backward pair's JSON record at the lane (packed,
    causal): dq then dk/dv on the Hopper kernels, on the old WMMA kernels
    (``_route="wmma"``), and SDPA's backward on the same values
    (``torch.autograd.grad`` through ``scaled_dot_product_attention``,
    head-major, its output kept from one forward) in turns (``_in_turns``:
    device, graph and event ms and host µs, two rounds), beside the twin's
    ms and the bound (q, k, v, dout, lse and delta read once and dq, dk and
    dv written once, or 10 d flops a causal pair at the bf16 peak)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr, kr, vr = (x.detach().requires_grad_(True) for x in hm[:3])
    o = sdpa(qr, kr, vr, is_causal=True)

    def pair(route=None):
        return (fa.flash_bwd_dq(*args, _route=route, **kw),
                *fa.flash_bwd_dkv(*args, _route=route, **kw))
    turns = _in_turns(
        {"wgmma": pair, "wmma": lambda: pair("wmma"),
         "sdpa": lambda: torch.autograd.grad(o, (qr, kr, vr), hm[3],
                                             retain_graph=True)},
        {"wgmma": fa.flash_bwd_dq, "wmma": fa.flash_bwd_dq, "sdpa": None})
    log(f"turns flash_bwd_pair bf16 packed: {_turns_line(turns)}")
    return _wgmma_record("flash_bwd_pair/wgmma", ":911", turns, err,
                         plain_ms, work)


def _wgmma_record(name, line, turns, err, plain_ms, work):
    """The JSON record of a bf16 Hopper flash kernel from its turns
    (``_in_turns``: "wgmma", the WMMA kernel "wmma" as ``earlier_*``, SDPA
    as ``library_*``), ``line`` its Pallas kernel's line, ``work`` (bytes,
    flops) its bound."""
    new, old, lib = turns["wgmma"], turns["wmma"], turns["sdpa"]
    moved, flops = work
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    rec = {"name": name, "route": "cuda", "source": FLASH_SM90_SOURCE,
           "replaces": "incubator_mxnet_tpu/ops/pallas/flash_attention.py"
                       + line,
           "launches": 0, "max_abs_err": err, "ms": new["event_ms"],
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib["event_ms"], "kernel_route": "wgmma",
           "device_ms": new["device_ms"],
           "device_kernels_ms": new["kernels"], "graph_ms": new["graph_ms"],
           "host_us": new["host_us"],
           "earlier_ms": old["event_ms"], "earlier_device_ms": old[
               "device_ms"], "earlier_device_kernels_ms": old["kernels"],
           "earlier_graph_ms": old["graph_ms"],
           "earlier_host_us": old["host_us"],
           "library_device_ms": lib["device_ms"],
           "library_graph_ms": lib["graph_ms"],
           "library_host_us": lib["host_us"],
           "library_kernels_ms": lib["kernels"],
           "rounds": {label: {key: val for key, val in r.items()
                              if key.endswith("_rounds")}
                      for label, r in turns.items()}}
    log(f"record {name}: {json.dumps(rec)}")
    return rec


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
    fa.reset_launch_counts()
    bf16_steps = _bf16_flash_steps(fa, params, lambda p, o: step(
        p, o, tokens, labels), opt, 2, cfg.n_layers, "train", losses)
    params, opt = bf16_steps.pop("state")
    got = bf16_steps["launches"]
    records["flash_fwd/wgmma"]["launches"] = got["flash_fwd"]
    records["flash_bwd_pair/wgmma"]["launches"] = (got["flash_bwd_dq"]
                                                   + got["flash_bwd_dkv"])
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
    split = {n: getattr(fa, n).sm90_launches for n in TRAIN_KERNELS}
    for name in TRAIN_KERNELS:
        if launches[name] != cfg.n_layers * steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} steps, not "
                                 f"{cfg.n_layers * steps}")
        # the timed steps run float32 attention: all on the split route
        # (bf16 would take the wgmma kernels, counted there too)
        if split[name] != launches[name]:
            raise AssertionError(f"{name}: {split[name]} of "
                                 f"{launches[name]} launches on the "
                                 f"{timed_dtype} route")
        records[name]["launches"] = launches[name]
    step_ms = wall / steps * 1e3
    # both routes' kernels: flash_fwd_kernel, flash_fwd_mma_kernel, ...
    breakdown = kernel_breakdown(
        "train", lambda: step(params, opt, tokens, labels),
        [f"{n}_" for n in TRAIN_KERNELS])
    return {"step_ms": step_ms, "tok_s": B * T * steps / wall,
            "timed_dtype": timed_dtype, "loss_first": losses[0],
            "loss_last": losses[-1], "bf16_flash": bf16_steps,
            **breakdown}


def _bf16_flash_steps(fa, params, step, opt, steps, n_layers, label,
                      losses):
    """``steps`` LM steps, each checked for its flash launches: ``n_layers``
    a step of each training kernel (forward, dq, dk/dv), and in a step
    whose parameters are bf16 (before Adam's float32 lr_t promotes them)
    every one on the Hopper kernels (``sm90_launches``; bf16's only Hopper
    route is the wgmma kernels). Returns {"launches": {kernel: the bf16
    steps' launches}, "steps": how many steps ran in bf16, "state":
    (params, opt)}; at least one must."""
    got = {"launches": dict.fromkeys(TRAIN_KERNELS, 0), "steps": 0}
    for _ in range(steps):
        bf16 = params["layers"][0]["wq"].dtype == torch.bfloat16
        before = {n: (getattr(fa, n).launches, getattr(fa, n).sm90_launches)
                  for n in TRAIN_KERNELS}
        params, opt, loss = step(params, opt)
        losses.append(loss)
        for name in TRAIN_KERNELS:
            n = getattr(fa, name).launches - before[name][0]
            sm90 = getattr(fa, name).sm90_launches - before[name][1]
            if n != n_layers:
                raise AssertionError(f"{label}: {n} {name} launches in a "
                                     f"step, not {n_layers}")
            if bf16 and sm90 != n:
                raise AssertionError(f"{label}: {sm90} of {n} bf16 {name} "
                                     "launches on the wgmma route")
            if bf16:
                got["launches"][name] += n
        got["steps"] += bf16
    if not got["steps"]:
        raise AssertionError(f"{label}: no step ran in bf16")
    log(f"{label}: bf16 flash launches {json.dumps(got['launches'])} in "
        f"{got['steps']} bf16 step(s), all on the wgmma route")
    got["state"] = (params, opt)
    return got


def kernel_breakdown(label, step, kernel_names, steps: int = 2,
                     counted=None):
    """Device time torch.profiler records for ``steps`` calls of ``step``
    against the wall time of ``steps`` unprofiled calls, taken just before:
    busy time and the idle share over that unprofiled wall
    (``device_idle_share``; the profiled window's own share, which the
    profiler stretches, beside it as ``profiled_window_idle_share``), the
    time and share of busy of the kernels whose names contain one of
    ``kernel_names``, and the top device ops (all per step; None, not
    measured, if the profiler delivers no device event). A window can lose
    records, so it logs the share it kept: of the kernel records against
    the CPU side's launch calls where no graph was replayed, and, for
    ``counted`` ({kernel name: its wrapper, whose launch counter also
    moves at a graph's replay}), of those kernels' records against their
    wrappers' launches in the window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    unprof_ms = (time.perf_counter() - t0) / steps * 1e3
    counted = counted or {}
    launched = {}

    def window():
        before = {k: w.launches for k, w in counted.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        launched.update({k: w.launches - before[k]
                         for k, w in counted.items()})
        return (time.perf_counter() - t0) / steps * 1e3
    calls = {}
    dev, wall_ms = _device_events(window, calls=calls)
    if dev is None:
        out = dict.fromkeys(("device_busy_ms", "device_idle_share",
                             "profiled_window_idle_share", "kernels_ms",
                             "kernels_share_of_busy", "kernel_ms",
                             "top_device_ops", "records_kept"))
        out["profiled_step_wall_ms"] = wall_ms
        out["step_wall_ms"] = unprof_ms
        log(f"{label} step breakdown: device time not measured "
            f"{json.dumps(out)}")
        return out
    busy_ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
    per = {n: sum(e.self_device_time_total for e in dev if n in e.key)
           / steps / 1e3 for n in kernel_names}
    if busy_ms > wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms exceeds the "
                             f"profiled step's wall time {wall_ms} ms")
    kernel_records = sum(e.count for e in dev
                         if not e.key.startswith(("Memcpy", "Memset")))
    kept = {"kernels_vs_launch_calls":
            (kernel_records / calls["launch"]
             if calls.get("launch") and not calls.get("graph") else None),
            "counted_kernels": None}
    if launched and sum(launched.values()):
        kept["counted_kernels"] = sum(
            e.count for e in dev for k in counted
            if k in e.key) / sum(launched.values())
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    kern_ms = sum(per.values())
    out = {"step_wall_ms": unprof_ms, "profiled_step_wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / unprof_ms,
           "profiled_window_idle_share": 1 - busy_ms / wall_ms,
           "kernels_ms": kern_ms, "kernels_share_of_busy": kern_ms / busy_ms,
           "kernel_ms": {k: v for k, v in per.items() if v},
           "records_kept": kept,
           "top_device_ops": [[e.key[:60],
                               e.self_device_time_total / steps / 1e3]
                              for e in top]}
    log(f"{label} step breakdown: {json.dumps(out)} (device_idle_share "
        f"over the unprofiled wall; records kept {json.dumps(kept)})")
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
    _bf16_flash_steps(fa, params, lambda p, o: step(p, o, tokens, labels),
                      opt, steps, cfg.n_layers, "head-major step", losses)
    losses = [float(x) for x in losses]
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


def _ln_bwd_routes(ln, d):
    """The LN backward's routes to hold at width d: its own (the one-pass
    kernel up to 1024 columns) and, where that is the one-pass kernel, the
    two-pass kernel forced (``_route="twopass"``)."""
    return ((None, "twopass") if ln.layer_norm_bwd_route(d) == "onepass"
            else (None,))


def row_kernel_errors(ln, sm, n, d, dt, g):
    """Every row kernel against its twin on one (n, d) input: {kernel:
    error}, the LN forward on its own route and the first design forced
    (``_route="warp"``; the route taken checked: the vector kernel counts
    in ``sm90_launches``), the LN backward's dgamma and dbeta relative to
    their largest entry, on each of its routes (the route taken checked:
    the one-pass kernel counts in ``sm90_launches``); with
    ``"column_sums_equal"``,
    whether the one-pass kernel's dgamma and dbeta equal the twin's bit
    for bit (the twin sums in the kernel's order), None on the two-pass
    route."""
    x = torch.randn((n, d), generator=g, device="cuda").to(dt)
    gam = torch.randn((d,), generator=g, device="cuda")
    bet = torch.randn((d,), generator=g, device="cuda")
    dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
    ry, rmu, rrstd = ln.layer_norm_reference(x, gam, bet)
    fwd_err = 0.0
    for route in (None, "warp"):
        before = ln.layer_norm_fwd.sm90_launches
        y, mu, rstd = ln.layer_norm_fwd(x, gam, bet, _route=route)
        vec = ln.layer_norm_fwd.sm90_launches > before
        if vec != (route is None and d <= ln.ONEPASS_MAX_D):
            raise AssertionError(f"layer_norm_fwd d {d} _route {route}: "
                                 f"vector kernel launched: {vec}")
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (y, mu, rstd)):
            raise AssertionError(f"layer_norm_fwd {dt} n {n} d {d} "
                                 f"_route {route}: non-finite output")
        fwd_err = max(fwd_err, _row_err(y, ry), _max_err(mu, rmu),
                      _rel_err(rstd, rrstd))
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, gam, rmu, rrstd, dy)
    bwd_err, equal = 0.0, None
    for route in _ln_bwd_routes(ln, d):
        before = ln.layer_norm_bwd.sm90_launches
        dx, dg, db = ln.layer_norm_bwd(x, gam, rmu, rrstd, dy, _route=route)
        onepass = ln.layer_norm_bwd.sm90_launches > before
        if onepass != (route is None and d <= ln.ONEPASS_MAX_D):
            raise AssertionError(f"layer_norm_bwd d {d} _route {route}: "
                                 f"one-pass kernel launched: {onepass}")
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (dx, dg, db)) \
                or dg.shape != (d,) or db.shape != (d,):
            raise AssertionError(f"layer_norm_bwd {dt} n {n} d {d} "
                                 f"_route {route}: non-finite or misshapen")
        bwd_err = max(bwd_err, _row_err(dx, rdx), _rel_err(dg, rdg),
                      _rel_err(db, rdb))
        if onepass:
            equal = bool(torch.equal(dg, rdg) and torch.equal(db, rdb))
    p = sm.softmax_fwd(x)
    rp = sm.softmax_reference(x)
    torch.cuda.synchronize()
    if not torch.isfinite(p).all():
        raise AssertionError(f"softmax_fwd {dt} n {n} d {d}: non-finite "
                             "output")
    return {"layer_norm_fwd": fwd_err,
            "layer_norm_bwd": bwd_err,
            "softmax_fwd": _row_err(p, rp),
            "column_sums_equal": equal}


def ln_bwd_repeats(ln, n=16384, d=768):
    """The one-pass LN backward's dgamma and dbeta from two calls and from
    a CUDA-graph replay of a third, in float32 and bf16: bit for bit the
    same (fixed summation orders, no float atomics; the tickets are zero
    again after every launch)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        _, mu, rstd = ln.layer_norm_fwd(x, gam, gam)
        first = ln.layer_norm_bwd(x, gam, mu, rstd, dy)
        second = ln.layer_norm_bwd(x, gam, mu, rstd, dy)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ln.layer_norm_bwd(x, gam, mu, rstd, dy)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = ln.layer_norm_bwd(x, gam, mu, rstd, dy)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        for name, outs in (("second call", second), ("graph replay",
                                                      replayed)):
            if not all(torch.equal(a, b) for a, b in zip(first, outs)):
                raise AssertionError(f"layer_norm_bwd {dt}: the {name}'s "
                                     "dx, dgamma or dbeta differ")
        del graph
    log(f"layer_norm_bwd ({n}, {d}) float32 and bf16: two calls and a "
        f"CUDA-graph replay bitwise equal (dx, dgamma, dbeta)")


def ln_sass_check(common):
    """layer_norm.cu's vector forward and one-pass backward as built: each
    instantiation with 16-byte vector loads (LDG.E.128) and no local
    (spill) bytes, both kernels present."""
    def name_of(mangled):
        m = re.search(r"(ln_fwd_vec_kernel|ln_bwd_onepass_kernel)"
                      r"I(f|13__nv_bfloat16)Li(\d+)E", mangled)
        return (None if m is None else
                f"{m.group(1)}<{_LSTM_TARGS[m.group(2)]},{m.group(3)}>")
    kernels = _sass_kernels(common, "layer_norm*.o", name_of, "LDG.E.128")
    for name in ("ln_fwd_vec_kernel", "ln_bwd_onepass_kernel"):
        if not any(k.startswith(name + "<") for k in kernels):
            raise AssertionError(f"{name} is not in the build: "
                                 f"{sorted(kernels)}")
    return kernels


def ln_fwd_repeats(ln, n=16384, d=768):
    """The vector LN forward's y, mu and rstd from two calls and from a
    CUDA-graph replay of a third, in float32 and bf16: bit for bit the
    same."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        bet = torch.randn((d,), generator=g, device="cuda")
        before = ln.layer_norm_fwd.sm90_launches
        first = ln.layer_norm_fwd(x, gam, bet)
        second = ln.layer_norm_fwd(x, gam, bet)
        if ln.layer_norm_fwd.sm90_launches - before != 2:
            raise AssertionError("layer_norm_fwd left the vector route")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ln.layer_norm_fwd(x, gam, bet)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = ln.layer_norm_fwd(x, gam, bet)
        graph.replay()
        torch.cuda.synchronize()
        for name, outs in (("second call", second),
                           ("graph replay", replayed)):
            if not all(torch.equal(a, b) for a, b in zip(first, outs)):
                raise AssertionError(f"layer_norm_fwd {dt}: the {name}'s "
                                     "y, mu or rstd differ")
        del graph
    log(f"layer_norm_fwd ({n}, {d}) float32 and bf16: two calls and a "
        f"CUDA-graph replay bitwise equal (y, mu, rstd)")


LN_LANE = (16384, 768)         # the nd lane's rows: B 32 x T 512, d_model


def ln_bwd_timings(ln, routes, rounds: int = 2, shape=LN_LANE,
                   dtypes=(torch.float32, torch.bfloat16)):
    """The LN backward at ``shape`` (the nd lane's (16384, 768)) in each of
    ``dtypes``: each route's device, graph and event ms and host µs in turns
    (:func:`_in_turns`), x and dy rotated through copies beyond the 50 MB
    L2, beside the byte bound (x, dy and dx once, gamma, mu, rstd, dgamma
    and dbeta). ``routes`` maps a label to the wrapper's ``_route`` (None:
    its own rule). A call is what ``_LayerNorm.backward`` launches: dx and
    the whole dgamma and dbeta (on the two-pass route its column partials'
    sums too). Returns {dtype: {"bound_ms", "mb", label: record}}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n, d = shape
    out = {}
    for dt in dtypes:
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        _, mu, rstd = ln.layer_norm_reference(x, gam, gam)
        rot = _Rotation(x, dy)

        def call(route):
            kw = {} if route is None else {"_route": route}

            def one(xx, dd):
                return ln.layer_norm_bwd(xx, gam, mu, rstd, dd, **kw)
            return lambda: rot(one)
        res = _in_turns({label: call(r) for label, r in routes.items()},
                        ln.layer_norm_bwd, rounds)
        moved = 3 * n * d * x.element_size() + d * 4 + 2 * n * 4 + 2 * d * 4
        rec = {"mb": moved / 1e6, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               **res}
        out[str(dt)[6:]] = rec
        log(f"time layer_norm_bwd {str(dt)[6:]} ({n}, {d}) ({moved / 1e6:.1f}"
            f" MB, bound {rec['bound_ms']:.4f} ms): {_turns_line(res)}")
        del rot, x, dy
    return out


def ln_fwd_timings(ln, rounds: int = 2, shape=LN_LANE):
    """The LN forward at ``shape`` (the nd lane's (16384, 768)) in float32
    and bf16: the vector kernel (its own route), the first design
    (``_route="warp"``) and ``F.layer_norm`` (gamma and beta in x's type),
    device, graph and event ms and host µs in turns (:func:`_in_turns`), x
    rotated through copies beyond the 50 MB L2, beside the byte bound (x
    and y once, gamma, beta, mu and rstd). Returns {dtype: {"bound_ms",
    "mb", "vec"|"warp"|"library": record}}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    F = torch.nn.functional
    n, d = shape
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        bet = torch.randn((d,), generator=g, device="cuda")
        gl, bl = gam.to(dt), bet.to(dt)
        rot = _Rotation(x, x)

        def call(route):
            return lambda: rot(lambda xx, _: ln.layer_norm_fwd(
                xx, gam, bet, _route=route))
        res = _in_turns(
            {"vec": call(None), "warp": call("warp"),
             "library": lambda: rot(lambda xx, _: F.layer_norm(
                 xx, (d,), gl, bl, 1e-5))},
            {"vec": ln.layer_norm_fwd, "warp": ln.layer_norm_fwd,
             "library": None}, rounds)
        moved = 2 * n * d * x.element_size() + 2 * d * 4 + 2 * n * 4
        rec = {"mb": moved / 1e6, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               **res}
        out[str(dt)[6:]] = rec
        log(f"time layer_norm_fwd {str(dt)[6:]} ({n}, {d}) "
            f"({moved / 1e6:.1f} MB, bound {rec['bound_ms']:.4f} ms): "
            f"{_turns_line(res)}")
        del rot, x
    return out


def row_kernel_checks(ln, sm, common):
    """Phase 10: the layer-norm and softmax kernels against their twins,
    first over a sweep of widths (d 64 .. 32768, the LN forward and
    backward on both of their routes up to 1024 columns, scalar loads at
    d 66 and 100, 4096 rows at d 768, 1000 and 1024 for a many-block
    grid) and on the inline route (rows not a multiple of 8: no launch,
    the plain formula), the vector LN forward and the one-pass LN backward
    as built, their bitwise repeats; then at the slice's shapes (LN
    (16384, 768), softmax (196608, 512): B 32, H 12, T 512 attention
    scores) with times beside the twin, the library call and the byte
    bound, the LN forward's vector kernel, first design and library call
    timed in turns (:func:`ln_fwd_timings`), the LN backward's one-pass
    and two-pass kernels (:func:`ln_bwd_timings`), there and in bf16 at
    d 1024 (one block an SM). Returns the JSON records (float32) and a
    log."""
    timings = {"ln_sass": ln_sass_check(common)}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, equal = {}, {}
    widths = (64, 66, 100, 512, 768, 1000, 1024, 4096, 32768)
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = ROW_TOL[dt]
        for d in widths:
            for n in ((64, 4096) if d in (768, 1000, 1024) else
                      (64,) if d <= 4096 else (16,)):
                errs = row_kernel_errors(ln, sm, n, d, dt, g)
                equal[f"{str(dt)[6:]} n {n} d {d}"] = errs.pop(
                    "column_sums_equal")
                for name, err in errs.items():
                    atol = atol_b if name == "layer_norm_bwd" else atol_f
                    if err > atol:
                        raise AssertionError(
                            f"{name} {dt} n {n} d {d}: max |kernel - plain| "
                            f"{err} > {atol}")
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
    log(f"row kernel sweep: d {'/'.join(map(str, widths))}, f32 and bf16, "
        f"the LN backward on both routes up to d 1024, within tolerance; "
        f"inline route (12 rows) launched nothing; worst "
        f"{json.dumps(worst)}; one-pass dgamma/dbeta bitwise equal to the "
        f"twin's: {json.dumps(equal)}")
    timings["sweep"] = worst
    timings["sweep_column_sums_equal"] = equal
    ln_fwd_repeats(ln)
    fwd_times = ln_fwd_timings(ln)
    timings["layer_norm_fwd turns"] = fwd_times
    ln_bwd_repeats(ln)
    ln_times = ln_bwd_timings(ln, {"onepass": None, "twopass": "twopass"})
    timings["layer_norm_bwd turns"] = ln_times
    # bf16 rows above 768: the one-pass grid at one block an SM, as the
    # kernel's launch bound there asks
    timings["layer_norm_bwd turns d 1024"] = ln_bwd_timings(
        ln, {"onepass": None, "twopass": "twopass"},
        shape=(LN_LANE[0], 1024), dtypes=(torch.bfloat16,))

    records = {}
    F = torch.nn.functional
    for dt in (torch.float32, torch.bfloat16):
        atol_f, atol_b = ROW_TOL[dt]
        esz = torch.empty((), dtype=dt).element_size()
        n, d = LN_LANE
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
                   "bound_by": ("bytes" if t_bytes >= t_ops
                                else "operations"),
                   "library_ms": library_ms}
            if name == "layer_norm_fwd":
                new_, old_ = (fwd_times[str(dt)[6:]][k]
                              for k in ("vec", "warp"))
                rec.update(device_ms=new_["device_ms"],
                           graph_ms=new_["graph_ms"],
                           event_ms_rotated=new_["event_ms"],
                           host_us=new_["host_us"],
                           earlier_device_ms=old_["device_ms"],
                           earlier_graph_ms=old_["graph_ms"],
                           earlier_event_ms_rotated=old_["event_ms"],
                           earlier_host_us=old_["host_us"],
                           library_device_ms=fwd_times[str(dt)[6:]][
                               "library"]["device_ms"])
            if name == "layer_norm_bwd":
                one = ln_times[str(dt)[6:]]["onepass"]
                two = ln_times[str(dt)[6:]]["twopass"]
                rec.update(device_ms=one["device_ms"],
                           graph_ms=one["graph_ms"],
                           event_ms_rotated=one["event_ms"],
                           host_us=one["host_us"],
                           earlier_device_ms=two["device_ms"],
                           earlier_graph_ms=two["graph_ms"],
                           earlier_event_ms_rotated=two["event_ms"],
                           earlier_host_us=two["host_us"])
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
    onepass = common.sm90_launch_counts()["layer_norm_bwd"]
    if onepass != launches["layer_norm_bwd"]:
        raise AssertionError(f"layer_norm_bwd took the one-pass route "
                             f"{onepass} of {launches['layer_norm_bwd']} "
                             "times in the nd steps")
    vec = common.sm90_launch_counts()["layer_norm_fwd"]
    if vec != launches["layer_norm_fwd"]:
        raise AssertionError(f"layer_norm_fwd took the vector route {vec} "
                             f"of {launches['layer_norm_fwd']} times in "
                             "the nd steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    breakdown = kernel_breakdown(
        "nd", lambda: step(99),
        ("ln_fwd_vec_kernel", "ln_fwd_warp_kernel", "ln_fwd_block_kernel",
         "ln_bwd_kernel",
         "ln_bwd_onepass_kernel", "softmax_warp_kernel",
         "softmax_block_kernel"))
    return {"step_ms": wall / steps * 1e3, "tok_s": B * T * steps / wall,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb,
            "layer_norm_bwd_onepass_per_step": onepass // steps,
            "layer_norm_fwd_vec_per_step": vec // steps,
            "layer_norm_backward_kernels": ln_backward_kernels(
                B * T, cfg.d_model),
            **breakdown}


def ln_backward_kernels(n, d):
    """The device kernels one autograd backward of ``layer_norm`` launches
    at the nd lane's (n, d) in float32, from torch.profiler over ten
    backward calls: the one-pass kernel alone, with no column-sum
    (``reduce_kernel``) launch after it. Returns {kernel: launches a call,
    as the window recorded them}, or None when the profiler delivered no
    device event."""
    from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    x = torch.randn((n, d), generator=g, device="cuda", requires_grad=True)
    gam = torch.randn((d,), generator=g, device="cuda", requires_grad=True)
    bet = torch.randn((d,), generator=g, device="cuda", requires_grad=True)
    dy = torch.randn((n, d), generator=g, device="cuda")
    y = ln.layer_norm(x, gam, bet)
    torch.autograd.grad(y, (x, gam, bet), dy, retain_graph=True)
    torch.cuda.synchronize()

    calls = 10

    def window():
        for _ in range(calls):
            torch.autograd.grad(y, (x, gam, bet), dy, retain_graph=True)
        torch.cuda.synchronize()
    dev, _ = _device_events(window)
    if dev is None:
        log("layer_norm backward's kernels: not measured (no device event)")
        return None
    kernels = {e.key[:60]: e.count / calls for e in dev
               if not e.key.startswith(("Memset", "Memcpy"))}
    log(f"one layer_norm autograd backward ({n}, {d}) float32 launches "
        f"{json.dumps(kernels)}")
    if len(kernels) != 1 or "ln_bwd_onepass_kernel" not in next(
            iter(kernels)):
        raise AssertionError(f"the layer_norm backward launched {kernels}, "
                             "not the one-pass kernel alone")
    return kernels


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
CONV_SM90_SOURCE = ("incubator_mxnet_tpu_torch/ops/cuda/csrc/"
                    "conv_fused_sm90.cu")
# the JSON line's names of the phase-13/14 kernels, in its order: every
# bf16 route is the Hopper kernels of conv_fused_sm90.cu, and so is every
# float32 route (three bf16 pieces a float32 operand, six wgmma products a
# stage: "sm90x3"; phase 16 launches them)
CONV_X3_KERNELS = ("mm_fused", "conv3_fused", "dgrad_epilogue",
                   "mm_fused_bwd", "conv3_fused_bwd")
CONV_RECORDS = tuple(f"{n}/sm90" for n in CONV_KERNELS) + tuple(
    f"{n}/sm90x3" for n in CONV_X3_KERNELS)
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
# the phase-13 sweep's 1x1 shapes: (M, K, N) for mm_fused and mm_fused_bwd,
# (M, K, N_a, N_b) for dgrad_epilogue
CONV_MM_SWEEP = ((64, 16, 24), (300, 40, 72), (1000, 128, 256))
CONV_DUAL_SWEEP = ((64, 16, 8, 24), (300, 40, 72, 40), (1000, 128, 64, 256))
# the case of each kernel whose stage-3 bf16 reading goes into the JSON line
CONV_RECORD_CASE = {"mm_fused": "entry", "mm_fused_bwd": "entry",
                    "conv3_fused": "3x3", "conv3_fused_bwd": "3x3",
                    "dgrad_epilogue": "block 0"}


def _scaled_err(outs, refs):
    return max(_max_err(o, r) / max(1.0, r.float().abs().max().item())
               for o, r in zip(outs, refs))


def _conv_cases(cf, g, dt):
    """The phase-13 sweep for one type: (kernel, case name, kernel call,
    twin call, route the plan gives, call forced onto the SIMT kernel)
    over every option of the five kernels."""
    def rnd(*shape, f32=False):
        t = torch.randn(shape, generator=g, device="cuda")
        return t if f32 else t.to(dt)
    cases = []
    for M, K, N in CONV_MM_SWEEP:
        x, sc = rnd(M, K), rnd(M, K)
        w = rnd(N, 1, 1, K).reshape(N, K).t()          # gluon layout view
        a, b = rnd(K, f32=True).abs() + 0.5, rnd(K, f32=True)
        asc, bsc, bias = (rnd(K, f32=True), rnd(K, f32=True),
                          rnd(N, f32=True))
        forms = {"plain": {}, "bnrelu": dict(a=a, b=b),
                 "entry": dict(a=a, b=b, sc=sc, asc=asc, bsc=bsc)}
        for form, kw in forms.items():
            route = cf.mm_fused_route(x, w, kw.get("sc"), (
                kw.get("a"), kw.get("b"), kw.get("asc"), kw.get("bsc")))
            for opt in (dict(bias=bias), dict(emit_xhat=True),
                        dict(stats=False)):
                args = {**kw, **opt}
                cases.append(("mm_fused", f"{M}x{K}x{N} {form} "
                              f"{sorted(opt)}",
                              lambda args=args, x=x, w=w: cf.mm_fused(
                                  x, w, **args),
                              lambda args=args, x=x, w=w:
                              cf.mm_fused_reference(x, w, **args), route,
                              lambda args=args, x=x, w=w: cf.mm_fused(
                                  x, w, _route="simt", **args)))
        # the weight as a contiguous (K, N) tensor: the other stride-1
        # layout, an MN-major B on the Hopper route
        wkn = w.contiguous()
        for form, opt in (("plain", dict(bias=bias)),
                          ("entry", dict(emit_xhat=True))):
            args = {**forms[form], **opt}
            route = cf.mm_fused_route(x, wkn, args.get("sc"), (
                args.get("a"), args.get("b"), args.get("asc"),
                args.get("bsc")))
            cases.append(("mm_fused", f"{M}x{K}x{N} {form} {sorted(opt)} "
                          f"w (K, N)",
                          lambda args=args, x=x, w=wkn: cf.mm_fused(
                              x, w, **args),
                          lambda args=args, x=x, w=wkn:
                          cf.mm_fused_reference(x, w, **args), route,
                          lambda args=args, x=x, w=wkn: cf.mm_fused(
                              x, w, _route="simt", **args)))
        gg, dzn, yout = rnd(M, N), rnd(M, N), rnd(M, N)
        gc, dsc, p1 = rnd(3, N, f32=True), rnd(M, K), rnd(M, K)
        bwd = {"direct mask z 1 partner": dict(g=gg, a=a, b=b,
                                               out_mask="z", partners=(x,)),
               "bn mask x dsc 2 partners": dict(
                   dzn=dzn, yout=yout, gcoef=gc, dsc=dsc, out_mask="x",
                   partners=(x, p1)),
               "bn no mask": dict(dzn=dzn, yout=yout, gcoef=gc),
               "direct bnrelu x no mask": dict(g=gg, a=a, b=b),
               # the lane's expand form: G on load, x^ = relu(a x + b),
               # masked on z, x its own partner
               "expand bn bnrelu mask z partner x": dict(
                   dzn=dzn, yout=yout, gcoef=gc, a=a, b=b, out_mask="z",
                   partners=(x,))}
        for name, kw in bwd.items():
            route = cf.mm_fused_bwd_route(
                x, w, (kw.get("g"), kw.get("dzn"), kw.get("yout"),
                       kw.get("dsc")) + kw.get("partners", ()),
                (kw.get("a"), kw.get("b"), kw.get("gcoef")))
            cases.append(("mm_fused_bwd", f"{M}x{K}x{N} {name}",
                          lambda kw=kw, x=x, w=w: cf.mm_fused_bwd(w, x, **kw),
                          lambda kw=kw, x=x, w=w: cf.mm_fused_bwd_reference(
                              w, x, **kw), route,
                          lambda kw=kw, x=x, w=w: cf.mm_fused_bwd(
                              w, x, _route="simt", **kw)))
    for M, K, NA, NB in CONV_DUAL_SWEEP:
        x = rnd(M, K)
        wa = rnd(NA, 1, 1, K).reshape(NA, K).t()
        wb = rnd(NB, 1, 1, K).reshape(NB, K).t()
        ops = (wa, wb, x, rnd(M, NA), rnd(M, NA), rnd(3, NA, f32=True),
               rnd(M, NB), rnd(M, NB), rnd(3, NB, f32=True))
        # gluon views, then contiguous (K, N) weights (K-major B)
        for ops in (ops, (wa.contiguous(), wb.contiguous()) + ops[2:]):
            tag = "" if ops[0].stride(0) == 1 else " w (K, N)"
            cases.append(("dgrad_epilogue", f"{M}x{K}x{NA}+{NB}{tag}",
                          lambda ops=ops: cf.dgrad_epilogue(*ops),
                          lambda ops=ops: cf.dgrad_epilogue_reference(*ops),
                          cf.dgrad_epilogue_route(
                              x, ops[0], ops[1], ops[3:5] + ops[6:8],
                              (ops[5], ops[8])),
                          lambda ops=ops: cf.dgrad_epilogue(
                              *ops, _route="simt")))
    # 3x3 maps of 7, 9, 14 and 28 with 1-3 images: 128-row tiles straddle
    # image rows and images; C 72 leaves an 8-channel tail slice, N 136 a
    # partial column tile
    for B, HW, C, N in ((1, 7, 16, 32), (3, 7, 32, 48), (1, 14, 32, 64),
                        (2, 14, 64, 32), (1, 28, 16, 16), (2, 28, 64, 64),
                        (2, 9, 72, 64), (3, 14, 72, 136)):
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
                          cf.conv3_fused_reference(x2, w9, a, b, bhw, st),
                          cf.conv3_fused_route(x2, w9, (a, b)),
                          lambda x2=x2, w9=w9, a=a, b=b, bhw=bhw, st=stats:
                          cf.conv3_fused(x2, w9, a, b, bhw, st,
                                         _route="simt")))
        cases.append(("conv3_fused_bwd", tag,
                      lambda x2=x2, w9=w9, a=a, b=b, d=dzn, y=yout, c=gc,
                      bhw=bhw: cf.conv3_fused_bwd(w9, x2, a, b, d, y, c, bhw),
                      lambda x2=x2, w9=w9, a=a, b=b, d=dzn, y=yout, c=gc,
                      bhw=bhw: cf.conv3_fused_bwd_reference(
                          w9, x2, a, b, d, y, c, bhw),
                      cf.conv3_fused_bwd_route(x2, w9, (dzn, yout),
                                               (a, b, gc)),
                      lambda x2=x2, w9=w9, a=a, b=b, d=dzn, y=yout, c=gc,
                      bhw=bhw: cf.conv3_fused_bwd(w9, x2, a, b, d, y, c, bhw,
                                                  _route="simt")))
    return cases


def _stage_runs(cf, g, stage, dt):
    """Phase 13 at one stage of the ResNet-50 lane: every form of conv the
    fused stage runs there, on operands from the generator, as a list of
    (kernel, case, kernel call, the call forced onto the SIMT kernel, twin
    call, library call, bytes, full bytes, flops).
    The cases: block 0's conv1 and projection (plain load, K = the stage's
    input channels, at the strided resolution) and their backward, the dual
    dgrad, beside the two single dgrads it replaces; a middle block's conv1 (entry form, K = 4 mid -> N = mid; its
    backward masked on x with dsc and a partner), its 3x3, and its conv3
    (expand, K = mid -> N = 4 mid; its backward masked on z with one
    partner). Bytes and flops are the reference's CostEstimate counts
    (conv_fused.py:210-212, :415-417, :676-678, :787-789); for the dual
    dgrad, its inputs and outputs once and 4 M K (N_a + N_b) flops. Full
    bytes count every input read once and every output written once (for
    mm_fused also sc, x^, the vectors and the stats; for mm_fused_bwd also
    dsc, the partners other than x, the vectors and the partials; for
    conv3_fused the vectors and the stats, all of which the reference's
    count leaves out); elsewhere they equal the bytes."""
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
        moved = (M * K + K * N + M * N) * esz
        acts = 1 + ("sc" in kw) + bool(kw.get("emit_xhat"))
        vecs = sum(kw.get(v) is not None for v in ("a", "b", "asc", "bsc"))
        full = ((acts * M * K + K * N + M * N) * esz
                + 4 * (vecs * K + ("bias" in kw) * N + 2 * N))
        runs.append(("mm_fused", case,
                     lambda: cf.mm_fused(x, w, **kw),
                     lambda: cf.mm_fused(x, w, _route="simt", **kw),
                     lambda: cf.mm_fused_reference(x, w, **kw),
                     lambda: torch.matmul(x, w), moved, full,
                     2 * M * K * N))

    def mmb(case, w, x, **kw):
        K, N = w.shape
        gm = rnd(M, N)
        moved = (2 * M * K + 2 * M * N) * esz + 4 * K * N
        # every distinct input once (G's operands, x, dsc, the partners
        # that are not x, w, the vectors) and every output once (dz, dW,
        # the partials)
        parts = kw.get("partners", ())
        acts_k = 1 + ("dsc" in kw) + sum(p is not x for p in parts)
        acts_n = 1 if "g" in kw else 2
        full = ((acts_k * M * K + acts_n * M * N + M * K + K * N) * esz
                + 4 * (K * N + (1 + len(parts)) * K + 2 * K * ("a" in kw)
                       + 3 * N * ("gcoef" in kw)))
        runs.append(("mm_fused_bwd", case,
                     lambda: cf.mm_fused_bwd(w, x, **kw),
                     lambda: cf.mm_fused_bwd(w, x, _route="simt", **kw),
                     lambda: cf.mm_fused_bwd_reference(w, x, **kw),
                     lambda: (torch.matmul(gm, w.t()), torch.matmul(x.t(), gm)),
                     moved, full, 4 * M * K * N))

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
    moved = ((2 * M * (mid + c4) + 2 * M * cin + cin * (mid + c4)) * esz
             + 4 * cin * (mid + c4))
    runs.append(("dgrad_epilogue", "block 0",
                 lambda: cf.dgrad_epilogue(*dual),
                 lambda: cf.dgrad_epilogue(*dual, _route="simt"),
                 lambda: cf.dgrad_epilogue_reference(*dual),
                 lambda: (torch.matmul(gab, wab.t()),
                          torch.matmul(xs.t(), gab)),
                 moved, moved + 4 * 3 * (mid + c4),
                 4 * M * cin * (mid + c4)))
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
    moved = (M * (N + N) + 9 * N * N) * esz
    runs.append(("conv3_fused", "3x3",
                 lambda: cf.conv3_fused(x2, w9, a2, b2, bhw),
                 lambda: cf.conv3_fused(x2, w9, a2, b2, bhw, _route="simt"),
                 lambda: cf.conv3_fused_reference(x2, w9, a2, b2, bhw),
                 lambda: F.conv2d(xc, wc, padding=1), moved,
                 moved + 4 * (2 * N + 2 * N), 18 * M * N * N))
    moved = M * (2 * N + 2 * N) * esz + 4 * 9 * N * N
    runs.append(("conv3_fused_bwd", "3x3",
                 lambda: cf.conv3_fused_bwd(w9, x2, a2, b2, dzn2, yout2, gc2,
                                            bhw),
                 lambda: cf.conv3_fused_bwd(w9, x2, a2, b2, dzn2, yout2, gc2,
                                            bhw, _route="simt"),
                 lambda: cf.conv3_fused_bwd_reference(w9, x2, a2, b2, dzn2,
                                                      yout2, gc2, bhw),
                 lambda: torch.autograd.grad(yc, (xr, wr), gcl,
                                             retain_graph=True),
                 moved, moved, 36 * M * N * N))
    y2 = rnd(M, mid)
    w3 = w1(mid, c4)
    mm("expand", y2, w3, a=a2, b=b2, bias=rnd(c4, f32=True))
    mmb("expand", w3, y2, dzn=rnd(M, c4), yout=rnd(M, c4),
        gcoef=rnd(3, c4, f32=True) * 0.1, a=a2, b=b2, out_mask="z",
        partners=(y2,))
    return runs


def device_ms(fn, wrapper, calls: int = 5, tries: int = 3,
              with_graph: bool = False):
    """Device time of one ``fn()``, a call of the kernel wrapper
    ``wrapper``, from torch.profiler: every kernel the call launches (the
    partial sums' reduction included), over ``calls`` calls after a
    warm-up; and {kernel name: ms} for each of them. Each kernel's time a
    call is its mean duration over the records the window kept, times its
    launches a call, which the wrapper's own launch counter gives over the
    window (each kernel of a wrapper launch runs once; a kernel recorded
    more often than that is taken at its recorded count; with ``wrapper``
    None, a library call, each kernel is taken at its recorded count,
    once a call at least). A window can
    lose records (on an H100 it kept 4 of 5 of the fused-conv kernels', 2
    of 5 of the LSTM forward's, window after window), so neither its total
    over ``calls`` nor its count says how often a kernel ran; and a window
    has read half the time of the same call replayed from a CUDA graph.
    So a window is profiled again, up to ``tries`` windows in all, when
    the tracer delivered no device event or when its sum reads under half
    of :func:`graph_ms` of the same call (taken after the first window
    that delivered events, for a kernel wrapper's call or ``with_graph``);
    after that the time is not measured: (None, {}). ``with_graph`` adds
    the graph time to the result."""
    fn()
    torch.cuda.synchronize()

    name = "the library call" if wrapper is None else wrapper.__name__

    def window():
        before = 0 if wrapper is None else wrapper.launches
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return 1 if wrapper is None else (wrapper.launches - before) / calls
    graph, timed = None, False
    result = None, {}
    for attempt in range(tries):
        dev, per_call = _device_events(window, 1)
        if dev is None:
            continue
        if per_call < 1 or per_call != int(per_call):
            raise AssertionError(f"device_ms: {name} launched {per_call} "
                                 "times a call")
        per, lost = {}, {}
        for e in dev:
            key = e.key.replace("void (anonymous namespace)::", "")[:40]
            runs = max(per_call, e.count / calls)
            per[key] = per.get(key, 0.0) + (
                e.self_device_time_total / e.count * runs / 1e3)
            if e.count < runs * calls:
                lost[key] = f"{e.count} of {round(runs * calls)}"
        if lost:
            log(f"device_ms: the window kept {lost} records of {name}'s "
                f"{calls} calls; each kernel's mean duration stands for its "
                "lost ones")
        total = sum(per.values())
        if not timed and (wrapper is not None or with_graph):
            graph, timed = graph_ms(fn), True
        if graph is not None and total < graph / 2:
            log(f"device_ms: {name}'s window {attempt + 1} of {tries} read "
                f"{total:.4f} ms, under half the graph time {graph:.4f} ms")
            continue
        result = total, per
        break
    else:
        log(f"device_ms: {name}'s device time not measured")
    if with_graph:
        if not timed:
            graph = graph_ms(fn)
        return (*result, graph)
    return result


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def graph_ms(fn, replays: int = 20):
    """Time of one ``fn()`` with no host work between the kernels: ``fn``
    captured ``replays`` times into one CUDA graph, the graph replayed
    between CUDA events. A cross-check of :func:`device_ms` that does not
    go through the profiler. None if the call cannot be captured. The
    call is warmed and captured on the port's capture stream (one a
    device: what cuBLAS and the wrappers make once a stream is made
    once), and only this thread is held to the capture's rules, so an
    autograd call, whose backward runs on the engine's thread, can be
    captured too (a failed capture keeps its memory pool for the rest of
    the process)."""
    from incubator_mxnet_tpu_torch.cuda_graph import capture_stream
    side = capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            for _ in range(replays):
                fn()
    except Exception as err:            # noqa: BLE001 (an autograd call)
        log(f"graph_ms: the call could not be captured: {err}")
        torch.cuda.synchronize()
        return None
    ms = time_ms(graph.replay, iters=5, warmup=1) / replays
    del graph
    return ms


def host_us(fn, calls: int = 20) -> float:
    """Host time of one ``fn()`` (the wrapper's checks, allocations, tensor
    maps and launches), with no synchronisation inside the window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def _in_turns(calls, wrapper, rounds: int = 2):
    """Device ms (:func:`device_ms`), graph ms, event ms and host µs of
    each ``calls[label]()``, a call of the kernel wrapper ``wrapper`` (or
    of ``wrapper[label]``, None for a library call, when it is a dict),
    taken in turns over ``rounds`` rounds (the order reversed every other
    round) and averaged. Returns {label: {key: mean, key + "_rounds":
    readings, "kernels": the last device split}}."""
    keys = ("device_ms", "graph_ms", "event_ms", "host_us")
    reads = {label: {k: [] for k in keys} for label in calls}
    kernels = {}
    labels = list(calls)
    for i in range(rounds):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            fn = calls[label]
            dev, kernels[label], graph = device_ms(
                fn, wrapper[label] if isinstance(wrapper, dict) else wrapper,
                with_graph=True)
            got = reads[label]
            got["device_ms"].append(dev)
            got["graph_ms"].append(graph)
            got["event_ms"].append(time_ms(fn))
            got["host_us"].append(host_us(fn))
    out = {}
    for label, got in reads.items():
        rec = {"kernels": kernels[label]}
        for k, vals in got.items():
            seen = [v for v in vals if v is not None]
            rec[k] = sum(seen) / len(seen) if seen else None
            rec[k + "_rounds"] = vals
        out[label] = rec
    return out


def _turns_line(res):
    """One log line's worth of :func:`_in_turns`' means."""
    return "; ".join(
        f"{label} device {_ms(r['device_ms'])} graph {_ms(r['graph_ms'])} "
        f"event {r['event_ms']:.4f} ms host {r['host_us']:.1f} us"
        for label, r in res.items())


def _conv_route(name, dt):
    """The route the plan gives a conv form of the ResNet-50 lane's
    stages: every bf16 form the Hopper kernels, every float32 form the
    three-piece kernels."""
    if dt == torch.bfloat16:
        return "sm90"
    return "sm90x3" if name in CONV_X3_KERNELS else "simt"


def _route_taken(cf, name, call, expect):
    """Run ``call`` and check that it took ``expect``'s route ("sm90x3":
    the float32 three-piece kernels, counted in ``x3_launches``)."""
    k = getattr(cf, name)
    before = (k.sm90_launches, k.x3_launches)
    out = call()
    took = ("sm90x3" if k.x3_launches > before[1]
            else "sm90" if k.sm90_launches > before[0] else "simt")
    if took != expect:
        raise AssertionError(f"{name} took the {took} route, the plan says "
                             f"{expect}")
    return out


def _sm90_kernel_name(mangled):
    """``cf90_fwd_kernel<64,1,1>`` (or ``cf90_dual_dgrad_x3_kernel``, a
    kernel with no template arguments) from a mangled name, or None for a kernel
    that is not one of conv_fused_sm90.cu's wgmma kernels (the float32
    route's piece split, ``cf90_split3_kernel``, has no product)."""
    m = re.search(r"(cf90_\w+?_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if m is None or m.group(1) == "cf90_split3_kernel":
        return None
    if m.group(2) is None:
        return m.group(1)
    args = ",".join(re.findall(r"\d+", m.group(2)))
    return f"{m.group(1)}<{args}>"


# a substitution (S_, S0_, ...) repeats the one class type, bf16
_LSTM_TARGS = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "0",
               "Lb1E": "1", "Li1E": "1", "Li3E": "3"}


def _lstm_tc_kernel_name(mangled):
    """``lstm_bwd_tc_kernel<float,3>`` (the carries' type, W's pieces) or
    ``lstm_fwd_tc_kernel<bf16,float,1,3>`` (xp's and the carries' types, the
    residual, W's pieces) from a mangled name (a substitution repeating the
    bf16 type), or None for another kernel of lstm.cu."""
    m = re.search(r"(lstm_(?:fwd|bwd)_tc_kernel)I((?:f|13__nv_bfloat16|"
                  r"S\d*_|Lb[01]E|Li[13]E)+)E", mangled)
    if m is None:
        return None
    args = re.findall(r"f|13__nv_bfloat16|S\d*_|Lb[01]E|Li[13]E", m.group(2))
    return f"{m.group(1)}<{','.join(_LSTM_TARGS.get(a, 'bf16') for a in args)}>"


def _sass_kernels(common, pattern, name_of, instr, no_stack=False):
    """The kernels of the library build's object ``pattern`` that
    ``name_of`` names: registers at launch, stack, static shared and local
    (spill) bytes (``cuobjdump -res-usage``) and the count of ``instr``
    instructions (``cuobjdump -sass``). Fails if a kernel has no ``instr``
    or any local bytes (or, with ``no_stack``, any stack). Returns
    {kernel: counts}."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = f"{CUDA_HOME or '/usr/local/cuda'}/bin/cuobjdump"
    objs = sorted(common.BUILD_DIR.glob(pattern))
    if not objs:
        raise AssertionError(f"no {pattern} object in {common.BUILD_DIR}")

    def dump(flag):
        return subprocess.run([tool, flag, str(objs[0])], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout

    key = instr.lower()
    kernels, name = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = name_of(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                      line)
        if m and name:
            kernels[name] = dict(zip(("reg", "stack", "shared", "local"),
                                     map(int, m.groups())), **{key: 0})
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = name_of(m.group(1))
        elif name in kernels and re.search(rf"\b{instr}\b", line):
            kernels[name][key] += 1
    if not kernels or any(k[key] == 0 or k["local"]
                          or (no_stack and k["stack"])
                          for k in kernels.values()):
        raise AssertionError(f"kernels without {instr} or with local "
                             f"(spill) bytes{' or stack' * no_stack}: "
                             f"{kernels}")
    log(f"{objs[0].name} as built: {len(kernels)} kernels, registers "
        f"{sorted({k['reg'] for k in kernels.values()})}, local bytes "
        f"{sorted({k['local'] for k in kernels.values()})}, stack "
        f"{sorted({k['stack'] for k in kernels.values()})}; "
        f"{json.dumps(kernels)}")
    return kernels


def sm90_sass_check(common):
    """The Hopper kernels of conv_fused_sm90.cu as built, each with HGMMA
    and no local bytes, the float32 route's eight among them (the forward
    in its plain/bnrelu and entry forms, the 3x3 backward's dgrad and
    wgrad); and its piece split,
    ``cf90_split3_kernel``, with stores and no local bytes (it picks its
    operand from the launch's descriptor by static indices)."""
    kernels = _sass_kernels(common, "conv_fused_sm90*.o", _sm90_kernel_name,
                            "HGMMA")
    x3 = {"cf90_fwd_x3_kernel<0>", "cf90_fwd_x3_kernel<1>",
          "cf90_conv3_x3_kernel", "cf90_dual_dgrad_x3_kernel",
          "cf90_dual_wgrad_x3_kernel", "cf90_bwd_dgrad_x3_kernel",
          "cf90_conv3_dgrad_x3_kernel", "cf90_conv3_wgrad_x3_kernel"}
    if not x3 <= set(kernels):
        raise AssertionError(f"the float32 route's kernels are not all in "
                             f"the build: {sorted(kernels)}")
    kernels.update(_sass_kernels(
        common, "conv_fused_sm90*.o",
        lambda m: "cf90_split3_kernel" if "cf90_split3_kernel" in m else None,
        "STG"))
    return kernels


def lstm_sass_check(common):
    """lstm.cu's tensor-core forward and backward (every instantiation, a
    float32 W's three pieces included) as built, each with HMMA
    (``mma.sync``), no local bytes and no stack."""
    kernels = _sass_kernels(common, "lstm*.o", _lstm_tc_kernel_name, "HMMA",
                            no_stack=True)
    for kind, n in (("fwd", 8), ("bwd", 2)):
        if sum(k.startswith(f"lstm_{kind}_tc_kernel") and k.endswith(",3>")
               for k in kernels) != n:
            raise AssertionError(f"not every float32-W {kind} kernel in the "
                                 f"build: {sorted(kernels)}")
    return kernels


# the float32-route kernels whose calls are held to two equal calls
_X3_REPEATED = ("mm_fused", "dgrad_epilogue", "mm_fused_bwd",
                "conv3_fused_bwd")


def _bitwise_repeats(kern, tag):
    """Two calls of a kernel with no atomics anywhere (the float32 route's,
    the bf16 flash backward) give equal outputs bit for bit."""
    first = kern()
    second = kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{tag}: two calls differ")


def conv_kernel_checks(cf, common):
    """Phase 13: the five fused-conv kernels against their twins over the
    option sweep in float32 and bf16, then at the ResNet-50 lane's shapes,
    every conv form of each stage (2, 3, 4) in both types. Each call takes
    the route the plan gives (``_conv_route``): every bf16 form the Hopper
    kernels (conv_fused_sm90.cu), every float32 form that file's
    three-piece kernels ("sm90x3"); every call is held to the twin again
    forced onto its SIMT kernel (the private ``_route="simt"``).
    Times in bf16 at every stage and in float32 at stage 3 (the 3x3
    backward at stages 2-4): CUDA events
    over a loop of wrapper calls, beside the twin's, the library call's
    and the bound. On the bf16 route, in turns with the SIMT kernel (new,
    old, new, old), plus torch.profiler's device time of one call, the
    wrapper's host µs and, for the records, the time of one call replayed
    from a CUDA graph; on the float32 three-piece route, device, graph and
    event ms and host µs of it and of the SIMT kernel in turns
    (``_in_turns``), the bound from six bf16 products (the FMA bound
    beside it), and two calls bitwise equal. Returns the JSON records (bf16
    and the float32 three-piece route, stage 3, each kernel's
    ``CONV_RECORD_CASE``) and a log of every timing."""
    sass = sm90_sass_check(common)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {}
    n_cases = 0

    def held(tag, out, ref, dt):
        torch.cuda.synchronize()
        err = _scaled_err(out, ref)
        if not all(torch.isfinite(t).all() for t in out) \
                or err > CONV_TOL[dt]:
            raise AssertionError(f"{tag}: max |kernel - plain| {err} > "
                                 f"{CONV_TOL[dt]}")
        return err

    for dt in (torch.float32, torch.bfloat16):
        for name, case, kern, plain, route, old in _conv_cases(cf, g, dt):
            ref = plain()
            err = held(f"{name} {dt} {case}", _route_taken(
                cf, name, kern, route), ref, dt)
            key = f"{name} {str(dt)[6:]} {route}"
            worst[key] = max(worst.get(key, 0.0), err)
            if route != "simt":
                err = held(f"{name} {dt} {case} simt", _route_taken(
                    cf, name, old, "simt"), ref, dt)
                key = f"{name} {str(dt)[6:]} simt"
                worst[key] = max(worst.get(key, 0.0), err)
            if route == "sm90x3" and name in _X3_REPEATED:
                _bitwise_repeats(kern, f"{name} {case}")
            n_cases += 1
    log(f"fused-conv sweep: {n_cases} cases (every load form, stats, "
        f"x^ output, bias, G direct and from BN, masks none/x/z, 0-2 "
        f"partners, dsc, the expand form, 3x3 at 7/9/14/28 with 1-3 images "
        f"and C 16-72, dual dgrad; all five in bf16 on the sm90 route and "
        f"in float32 on the sm90x3 route, each again on the simt one) "
        f"within "
        f"tolerance; worst "
        f"{json.dumps(worst)}")
    timings = {"sass": sass, "sweep": worst}
    records = {}
    for stage in (2, 3, 4):
        for dt in (torch.float32, torch.bfloat16):
            runs = _stage_runs(cf, g, stage, dt)
            for name, case, kern, old, plain, lib, moved, full, flops \
                    in runs:
                tag = f"{name} {case} {str(dt)[6:]} stage {stage}"
                route = _conv_route(name, dt)
                ref = plain()
                err = held(tag, _route_taken(cf, name, kern, route), ref, dt)
                if route != "simt":
                    held(f"{tag} simt", _route_taken(cf, name, old, "simt"),
                         ref, dt)
                del ref
                if route == "sm90x3" and name in _X3_REPEATED:
                    _bitwise_repeats(kern, tag)
                if dt == torch.float32 and stage != 3 \
                        and name != "conv3_fused_bwd":
                    log(f"parity {tag} ({route}): err {err:.3g}")
                    continue
                rec = {"name": name, "route": "cuda", "source": CONV_SOURCE,
                       "replaces": CONV_REPLACES[name], "launches": 0,
                       "max_abs_err": err}
                t_bytes = full / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dt] * 1e3
                if route == "sm90":
                    ms1 = time_ms(kern, iters=10, warmup=2)
                    old1 = time_ms(old, iters=3, warmup=1)
                    ms2 = time_ms(kern, iters=10, warmup=2)
                    old2 = time_ms(old, iters=3, warmup=1)
                    ms, earlier = (ms1 + ms2) / 2, (old1 + old2) / 2
                    dev_ms, by_kernel = device_ms(kern, getattr(cf, name))
                    rec.update(name=f"{name}/sm90", source=CONV_SM90_SOURCE,
                               earlier_ms=earlier, device_ms=dev_ms,
                               device_kernels_ms=by_kernel,
                               host_us=host_us(kern))
                    if stage == 3 and case == CONV_RECORD_CASE[name]:
                        rec["graph_ms"] = graph_ms(kern)
                elif route == "sm90x3":
                    # the three-piece kernels and the SIMT ones in turns;
                    # the bound counts the six bf16 products
                    turns = _in_turns({"sm90x3": kern, "simt": old},
                                      getattr(cf, name))
                    new, simt = turns["sm90x3"], turns["simt"]
                    ms = new["event_ms"]
                    fma_ops = t_ops
                    t_ops = 6 * flops / PEAK_FLOPS[torch.bfloat16] * 1e3
                    rec.update(
                        name=f"{name}/sm90x3", source=CONV_SM90_SOURCE,
                        device_ms=new["device_ms"],
                        device_kernels_ms=new["kernels"],
                        graph_ms=new["graph_ms"], host_us=new["host_us"],
                        earlier_ms=simt["event_ms"],
                        earlier_device_ms=simt["device_ms"],
                        earlier_graph_ms=simt["graph_ms"],
                        earlier_host_us=simt["host_us"],
                        earlier_device_kernels_ms=simt["kernels"],
                        rounds={k: v for k, v in new.items()
                                if k.endswith("_rounds")},
                        earlier_rounds={k: v for k, v in simt.items()
                                        if k.endswith("_rounds")},
                        fma_bound_ms=max(t_bytes, fma_ops))
                    log(f"turns {tag}: {_turns_line(turns)}")
                else:
                    ms = time_ms(kern, iters=10, warmup=2)
                plain_ms = time_ms(plain, iters=3, warmup=1)
                library_ms = time_ms(lib, iters=10, warmup=2)
                rec.update(ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations",
                           counted_bound_ms=max(
                               moved / HBM_BYTES_PER_S * 1e3, t_ops),
                           library_ms=library_ms)
                timings[tag] = rec
                if stage == 3 and (route == "sm90x3"
                                   or dt == torch.bfloat16) \
                        and case == CONV_RECORD_CASE[name]:
                    records[rec["name"]] = rec
                extra = (f"; earlier (simt) {rec['earlier_ms']:.4f} ms, "
                         f"device {_ms(rec['device_ms'])} ms "
                         f"{json.dumps(rec['device_kernels_ms'])}, host "
                         f"{rec['host_us']:.1f} us, graph "
                         f"{rec.get('graph_ms', 'not measured')} ms"
                         if route != "simt" else "")
                log(f"time {tag}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {library_ms:.4f} ms, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; counted "
                    f"{rec['counted_bound_ms']:.4f}){extra}; err {err:.3g}")
            del runs
            torch.cuda.empty_cache()
    return records, timings


# ------------------------------------------------------ ResNet-50 lane
RESNET_BATCH = 128


def _resnet_setup(mx, gluon, vision, seed, batch, dtype=None, **kw):
    """ResNet-50 v1, NHWC, on the card, default init, deferred shapes
    resolved by one forward; a batch from the seed; the functional SGD
    step of bench.py's lane (lr 0.01, momentum 0.9; ``kw`` to
    ``make_train_step``)."""
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
        learning_rate=0.01, momentum=0.9, compute_dtype=dtype, **kw)
    return (net, step, params, aux, opt, torch.from_numpy(x_np).cuda(),
            torch.from_numpy(y_np).cuda())


# --------------------------------------------- captured and eager steps
def _clone(tree):
    from incubator_mxnet_tpu_torch.parallel.dp import _clone
    return _clone(tree)


def _timed_steps(step, state, x, y, steps):
    """``steps`` calls of a ``make_train_step`` step from ``state``
    (params, aux, opt_state; each call's outputs passed to the next), host
    clock between synchronisations: (ms a step, the last state, the
    losses)."""
    p, a, s = state
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        p, a, s, loss = step(p, a, s, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, (p, a, s), losses


def _one_step_from(step, state, x, y):
    """One call of ``step`` from a copy of ``state``: (the loss, {name:
    the parameter's update, new minus old})."""
    p, a, s = (_clone(t) for t in state)
    new, _, _, loss = step(p, a, s, x, y)
    torch.cuda.synchronize()
    return loss.clone(), {n: new[n] - state[0][n] for n in state[0]}


def _update_err(got, want):
    """The largest difference of two updates over the largest entry of
    ``want``, the worst leaf."""
    return max(float((got[n] - want[n]).abs().max())
               / max(float(want[n].abs().max()), 1e-30) for n in want)


def _agreement(label, a, b):
    """Two steps from the same state, (loss, update) each: the loss's
    relative difference, the updates' worst leaf and whether both are
    equal bit for bit."""
    (la, ua), (lb, ub) = a, b
    out = {"loss_a": float(la), "loss_b": float(lb),
           "loss_rel": abs(float(la) - float(lb)) / abs(float(lb)),
           "update_err": _update_err(ua, ub),
           "bitwise": bool(torch.equal(la, lb)) and all(
               torch.equal(ua[n], ub[n]) for n in ub)}
    log(f"{label}: {json.dumps(out)}")
    return out


def _turns(kinds, x, y, steps, repeats, check):
    """Time ``steps`` steps of each of ``kinds`` ({label: [step,
    state]}) in turns, ``repeats`` times each, the order reversed every
    other round (a b b a a b ...); ``check(label)`` after each run, with
    the launch counts reset before it. Returns {label: [ms a step]}."""
    from incubator_mxnet_tpu_torch.ops.cuda import common
    reads = {label: [] for label in kinds}
    labels = list(kinds)
    for i in range(repeats):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            common.reset_launch_counts()
            step, state = kinds[label]
            ms, kinds[label][1], _ = _timed_steps(step, state, x, y, steps)
            check(label)
            reads[label].append(ms)
    return reads


# the fused-conv kernels of a bf16 step and their wrappers (each kernel
# runs once a wrapper launch): the records a profiled window must keep
def _conv_counted(cf):
    return {"cf90_fwd_kernel": cf.mm_fused,
            "cf90_conv3_kernel": cf.conv3_fused,
            "cf90_bwd_dgrad_kernel": cf.mm_fused_bwd,
            "cf90_conv3_dgrad_kernel": cf.conv3_fused_bwd,
            "cf90_dual_dgrad_kernel": cf.dgrad_epilogue}


RESNET_REPEATS = 3
RESNET_KERNEL_NAMES = (
    "cf_fwd_kernel", "cf_dgrad_kernel", "cf_wgrad_kernel",
    "cf90_fwd_kernel", "cf90_dual_dgrad_kernel", "cf90_dual_wgrad_kernel",
    "cf90_bwd_dgrad_kernel", "cf90_conv3_kernel", "cf90_conv3_dgrad_kernel",
    "cf90_conv3_wgrad_kernel")


def resnet_train_phase(mx, gluon, vision, common, records, steps=5):
    """Phase 14: ResNet-50 v1 training at bench.py's lane (NHWC, batch 128,
    224 x 224, bf16 compute on float32 masters, SGD momentum 0.9, lr 0.01,
    MXTPU_FUSED_RESNET=1, MXTPU_BN_IMPL=plain) through the captured step
    (``make_train_step``: the first call a real step, eager on the capture
    stream, then the capture; later calls replay it): 2 warm-up and 5
    timed steps, the fused kernels' launches a step counted through the
    replays, finite falling loss; then the eager yardstick
    (``_capture=False``) from the same net, and both timed in turns, three
    runs of 5 steps each; one step of each from the same state (loss and
    parameter updates, held after phase 16 to its spread); peak memory of
    each; a profiled window of two steps of each (busy, the idle share
    over the unprofiled wall, top ops, the records kept); then the
    rematerialisation policies "nothing" and "dots" against none: a fresh
    captured step each, its first call's peak memory (under "nothing"
    below none's) and a replay from the same state as the others."""
    import gc
    import os
    from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as cf
    from incubator_mxnet_tpu_torch.parallel.dp import make_train_step
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    os.environ["MXTPU_BN_IMPL"] = "plain"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"resnet50 phase start: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
        f"reserved")
    net, step, params, aux, opt, x, y = _resnet_setup(
        mx, gluon, vision, SEED + 5, RESNET_BATCH, torch.bfloat16)

    def build(**kw):
        return make_train_step(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            learning_rate=0.01, momentum=0.9, compute_dtype=torch.bfloat16,
            **kw)
    first_ms, state, losses = _timed_steps(step, (params, aux, opt), x, y, 1)
    _, state, more = _timed_steps(step, state, x, y, 1)
    losses += more
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    common.reset_launch_counts()
    ms, state, more = _timed_steps(step, state, x, y, steps)
    losses += more
    launches = common.launch_counts()
    sm90 = common.sm90_launch_counts()
    losses = [float(v) for v in losses]
    log(f"resnet50 fused train, captured: first call (eager on the capture "
        f"stream, then the capture) {first_ms:.1f} ms; losses "
        f"{[round(v, 4) for v in losses]}; {steps} timed steps "
        f"{ms:.2f} ms/step; peak {peak_gb:.2f} GB allocated, "
        f"{reserved_gb:.2f} GB reserved; launches {launches}; on the sm90 "
        f"route {sm90}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"resnet loss not finite and falling: {losses}")
    # stages 2-4 hold 4 + 6 + 3 blocks: a 1x1 conv1, a 3x3 and a 1x1 conv3
    # each, plus block 0's projection; block 0's conv1 and projection
    # dgrads are one dual dgrad. Every bf16 launch of the five takes the
    # Hopper route, and a replay counts what its capture launched.
    per_step = {"mm_fused": 29, "conv3_fused": 13, "mm_fused_bwd": 23,
                "conv3_fused_bwd": 13, "dgrad_epilogue": 3}

    def check(label, got=None, got90=None):
        got = got or common.launch_counts()
        got90 = got90 or common.sm90_launch_counts()
        for name, n in per_step.items():
            if got[name] != n * steps or got90[name] != n * steps:
                raise AssertionError(
                    f"{label}: {name} launched {got[name]} times ("
                    f"{got90[name]} on the sm90 route) in {steps} resnet "
                    f"steps, not {n * steps}")
    check("captured", launches, sm90)
    for name in per_step:
        records[f"{name}/sm90"]["launches"] = sm90[name]
    # the eager yardstick, from the same net; its cached blocks are its own
    estep, *estate = build(_capture=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, estate, _ = _timed_steps(estep, tuple(estate), x, y, 2)
    eager_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kinds = {"captured": [step, state], "eager": [estep, estate]}
    reads = _turns(kinds, x, y, steps, RESNET_REPEATS, check)
    cap_ms = sum(reads["captured"]) / len(reads["captured"])
    eager_ms = sum(reads["eager"]) / len(reads["eager"])
    log(f"resnet50 fused train in turns ({steps} steps a run): captured "
        f"{reads['captured']} ms/step, eager {reads['eager']}; means "
        f"{cap_ms:.2f} and {eager_ms:.2f} ms ({RESNET_BATCH * 1e3 / cap_ms:.1f}"
        f" and {RESNET_BATCH * 1e3 / eager_ms:.1f} img/s); peak "
        f"{peak_gb:.2f} GB captured, {eager_peak_gb:.2f} GB eager")
    snap = tuple(_clone(t) for t in kinds["captured"][1])
    agree = _agreement("resnet50 captured vs eager step, same state",
                       _one_step_from(step, snap, x, y),
                       _one_step_from(estep, snap, x, y))
    counted = _conv_counted(cf)
    breakdown = kernel_breakdown(
        "resnet fused (captured)",
        lambda: step(*kinds["captured"][1], x, y), RESNET_KERNEL_NAMES,
        counted=counted)
    eager_breakdown = kernel_breakdown(
        "resnet fused (eager yardstick)",
        lambda: estep(*kinds["eager"][1], x, y), RESNET_KERNEL_NAMES,
        counted=counted)
    del step, estep, state, estate, kinds, params, aux, opt
    # the rematerialisation policies, each a fresh captured step whose
    # first call runs from the same state
    remat = {}
    for policy in (None, "nothing", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rstep, *_ = build(remat=policy)
        first = _one_step_from(rstep, snap, x, y)
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.memory_reserved() / 1e9
        replay = _one_step_from(rstep, snap, x, y)
        remat[str(policy)] = {"peak_memory_gb": peak, "loss": float(first[0]),
                              "replay": replay}
        del rstep
        log(f"resnet50 remat={policy}: first call's peak {peak:.2f} GB "
            f"({reserved:.2f} GB reserved), loss {float(first[0]):.6f}, "
            f"replay loss {float(replay[0]):.6f}")
    for policy in ("nothing", "dots"):
        remat[policy]["vs_none"] = _agreement(
            f"resnet50 remat={policy} vs none, replays from the same state",
            remat[policy].pop("replay"), remat["None"]["replay"])
    remat["None"].pop("replay")
    gc.collect()
    torch.cuda.empty_cache()
    if not remat["nothing"]["peak_memory_gb"] < remat["None"]["peak_memory_gb"]:
        raise AssertionError(f"remat='nothing' did not lower the peak: "
                             f"{remat}")
    return {"step_ms": cap_ms, "img_s": RESNET_BATCH * 1e3 / cap_ms,
            "step_ms_runs": reads["captured"],
            "eager_step_ms": eager_ms,
            "eager_img_s": RESNET_BATCH * 1e3 / eager_ms,
            "eager_step_ms_runs": reads["eager"],
            "first_call_ms": first_ms,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, "reserved_memory_gb": reserved_gb,
            "eager_peak_memory_gb": eager_peak_gb,
            "launches_per_step": per_step,
            "sm90_launches_per_step": per_step,
            "captured_vs_eager": agree, "remat": remat,
            "eager_breakdown": eager_breakdown, **breakdown}


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
    breakdown = kernel_breakdown(
        "resnet per-block", lambda: step(params, aux, opt, x, y), ())
    return {"step_ms": wall / steps * 1e3, "img_s": img_s,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, **breakdown}


HYBRID_BATCH = 32


def resnet_hybrid_forward(mx, vision, common):
    """Phase 15, last: ``resnet50_v1`` (NHWC, batch 32, 224 x 224, float32,
    inference) called as a user would, first not hybridized, then after
    ``hybridize()``: its first call runs the forward eagerly on the capture
    stream and captures it, later calls replay the graph. The replay's
    output against the eager one (within 1e-5 of the largest entry, and
    whether equal bit for bit), one cache entry, and both forwards' times
    (CUDA events over 10 calls, and the host clock)."""
    rs = np.random.RandomState(SEED + 9)
    x_np = rs.rand(HYBRID_BATCH, 3, 224, 224).astype(np.float32)
    mx.random.seed(SEED + 9)
    with mx.gpu(0):
        net = vision.resnet50_v1(layout="NHWC")
        net.initialize()
        x = mx.nd.array(x_np)
        eager = net(x)._data.clone()
        eager_ms = time_ms(lambda: net(x), iters=10, warmup=2)
        eager_host = host_us(lambda: net(x), calls=10) / 1e3
        net.hybridize()
        common.reset_launch_counts()
        t0 = time.perf_counter()
        net(x)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        out = net(x)._data
        torch.cuda.synchronize()
        hyb_ms = time_ms(lambda: net(x), iters=10, warmup=2)
        hyb_host = host_us(lambda: net(x), calls=10) / 1e3
    err = float((out - eager).abs().max()) / float(eager.abs().max())
    res = {"eager_ms": eager_ms, "eager_host_ms": eager_host,
           "captured_ms": hyb_ms, "captured_host_ms": hyb_host,
           "first_call_ms": first_ms, "max_err": err,
           "bitwise": bool(torch.equal(out, eager)),
           "entries": len(net._static.entries),
           "launches": {k: v for k, v in common.launch_counts().items()
                        if v}}
    log(f"resnet50 hybridized inference forward, batch {HYBRID_BATCH}: "
        f"{json.dumps(res)}")
    if res["entries"] != 1 or err > 1e-5 or tuple(out.shape) != (
            HYBRID_BATCH, 1000) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"hybridized forward: {res}")
    return res


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


def resnet_truth_phase(mx, gluon, vision, common, records):
    """Phase 16: in float32 at 224 x 224, batch 16: each fused stage (2, 3,
    4) against the same stage on the per-block path, then the whole net's
    first-step loss fused against per-block (rtol 1e-3). Every float32
    mm_fused (two a block and block 0's projection), conv3_fused (one a
    block), dgrad_epilogue (one a stage), mm_fused_bwd (two a block but
    block 0's one) and conv3_fused_bwd (one a block) launch of the fused
    stages takes the three-piece route ("sm90x3"); their counts over the
    three stages (29, 13, 3, 23, 13) are the records' launches.

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
    from incubator_mxnet_tpu_torch.parallel.dp import make_train_step
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    net, step, params, aux, opt, x, y = _resnet_setup(
        mx, gluon, vision, SEED + 6, 16, donate=False)
    feats = list(net.features._children.values())
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out = {}
    x3_total = dict.fromkeys(CONV_X3_KERNELS, 0)
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
        x3 = common.x3_launch_counts()
        if counts["conv3_fused_bwd"] != len(blocks) \
                or counts["dgrad_epilogue"] != 1:
            raise AssertionError(f"the fused stage did not run its kernels: "
                                 f"{counts}")
        if not x3["mm_fused"] == counts["mm_fused"] == 2 * len(blocks) + 1 \
                or not x3["conv3_fused"] == counts["conv3_fused"] \
                == len(blocks) or x3["dgrad_epilogue"] != 1 \
                or not x3["mm_fused_bwd"] == counts["mm_fused_bwd"] \
                == 2 * len(blocks) - 1 \
                or x3["conv3_fused_bwd"] != counts["conv3_fused_bwd"]:
            raise AssertionError(f"float32 mm_fused / conv3_fused / "
                                 f"dgrad_epilogue / mm_fused_bwd / "
                                 f"conv3_fused_bwd launches off the sm90x3 "
                                 f"route: {x3} of {counts}")
        for name in CONV_X3_KERNELS:
            x3_total[name] += x3[name]
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
    # the step traced the fused path when it was built; the per-block
    # path is another step, from the same state
    os.environ["MXTPU_FUSED_RESNET"] = "0"
    step_p, *_ = make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.01, momentum=0.9, donate=False)
    _, _, _, loss_p = step_p(params, aux, opt, x, y)
    rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    log(f"f32 resnet50 first-step loss: fused {float(loss_f):.6f} per-block "
        f"{float(loss_p):.6f} (rel {rel:.3g}, rtol 1e-3)")
    if not np.isfinite(float(loss_f)) or rel > 1e-3:
        raise AssertionError("whole-net loss: fused and per-block disagree")
    out["loss_rel"] = rel
    out["sm90x3_launches"] = x3_total
    for name, n in x3_total.items():
        records[f"{name}/sm90x3"]["launches"] = n
    return out


# --------------------------------------------------- the LSTM kernels (B8)
LSTM_KERNELS = ("lstm_fwd_gates", "lstm_fwd", "lstm_bwd")
# the JSON line's names: with a bf16 W (the lane's) each takes its
# tensor-core kernel; a user's eval forward on the net's own float32
# parameters takes the tensor-core forward with W in three pieces, and the
# float32 truth pass (phase 19) the tensor-core backward so
LSTM_RECORDS = ("lstm_fwd_gates/sm90", "lstm_fwd/sm90", "lstm_bwd/sm90",
                "lstm_fwd/sm90_f32w", "lstm_bwd/sm90_f32w")
LSTM_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/lstm.cu"
_LSTM_PY = "incubator_mxnet_tpu/ops/pallas/lstm.py"
LSTM_REPLACES = {"lstm_fwd_gates": f"{_LSTM_PY}:151",
                 "lstm_fwd": f"{_LSTM_PY}:151", "lstm_bwd": f"{_LSTM_PY}:180"}
# (xp and b type, W type, carry type): the word LM under bf16 compute
# carries float32 states with a bf16 W_hh, its layer 1 projected in bf16
# and its layer 2 in float32; bf16 carries (c rounded to bf16 each step)
# and all-float32 are the other two forms
LSTM_TYPES = ((torch.bfloat16, torch.bfloat16, torch.float32),
              (torch.float32, torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32, torch.float32))
# the other float32-W forms the tensor-core forward takes (xp and b in
# bf16, or bf16 carries, or both: a float32 W read in three pieces times
# one bf16 piece of a bf16 h), held in the sweep beside the four above
LSTM_F32W_MIXED_TYPES = ((torch.bfloat16, torch.float32, torch.float32),
                         (torch.float32, torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32, torch.bfloat16))
# forward outputs: max error over max(1, the twin's largest entry), so a
# bf16 ulp of a large c counts as at 1; backward outputs: max error over
# the largest entry
LSTM_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
LM_T, LM_N, LM_H, LM_VOCAB = 35, 128, 650, 33278      # bench.py:500-520
# the lane's backward error with float32 carries: float32's bound, which the
# split-bf16 product must keep
LSTM_LANE_BWD_TOL = 1e-3
# dh against the float64 product of the kernel's own dz (its dxp output)
# and W, over dh's largest entry, with float32 carries: with a bf16 W the
# tensor-core route read 0.5e-7-2.9e-7 over this phase's sweep on an H100,
# a two-piece split 2.2e-6-4.3e-6, and the SIMT kernel's sequential float32
# sums 1.2e-7-2.5e-6 (growing with H); with a float32 W the six-product
# route must stay within it too, and W's hi piece alone (three products)
# must read above it
LSTM_PRODUCT_TOL = 1e-6
# the forward's gates residual against a float64 twin on the same inputs,
# absolute: with a bf16 W the tensor-core route read 0.8e-7-4.7e-7 over
# this phase's sweep on an H100 and 3.4e-7 at the lane, the FMA kernel up
# to 2.7e-6, a two-piece split of a float32 h 2.1e-6-7.3e-6; with a
# float32 W the six-product route must stay within it too, and at the lane
# no further than the FMA kernel, while three products (hi.hi, hi.mid,
# mid.hi) must read above it
LSTM_FWD_PRODUCT_TOL = 1e-6


def _rnd(g, dt, *shape, sc=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * sc).to(dt)


def _lstm_operands(g, od, wd, sd, N, H):
    """One step's operands: xp, h, c, w, b, dh', dc'."""
    return (_rnd(g, od, N, 4 * H), _rnd(g, sd, N, H, sc=0.5),
            _rnd(g, sd, N, H), _rnd(g, wd, 4 * H, H, sc=H ** -0.5),
            _rnd(g, od, 4 * H, sc=0.1), _rnd(g, sd, N, H), _rnd(g, sd, N, H))


def _product_err(dxp, w, dh, pieces=None):
    """dh against the float64 product of dz (``dxp``) and W, over its
    largest entry; with ``pieces`` 2, the reading of a dh that a two-piece
    split of dz (hi + mid, lo dropped) would give, and with ``pieces``
    "w_hi" that of W's hi piece alone times dz's three (three products),
    in exact arithmetic."""
    exact = dxp.double() @ w.double()
    if pieces == 2:
        hi = dxp.to(torch.bfloat16)
        mid = (dxp - hi.float()).to(torch.bfloat16)
        dh = ((hi.double() + mid.double()) @ w.double()).float()
    elif pieces == "w_hi":
        dh = (dxp.double() @ w.to(torch.bfloat16).double()).float()
    return ((dh.double() - exact).abs().max() / exact.abs().max()).item()


def _pieces64(v):
    """A float32 tensor's three bf16 pieces hi, mid, lo, in float64."""
    hi = v.float().to(torch.bfloat16)
    r1 = v.float() - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return [t.double() for t in (hi, mid, lo)]


def _gates64(xp, h, w, b, pieces=None):
    """The forward's gates in float64 from the same inputs; with ``pieces``
    2, h as its hi + mid bf16 pieces (lo dropped); with ``pieces``
    "three_product", h and W each in three pieces and only hi.hi, hi.mid
    and mid.hi multiplied."""
    H = h.shape[1]
    if pieces == "three_product":
        hp, wp = _pieces64(h), _pieces64(w)
        prod = sum(hp[q] @ wp[r].t() for q, r in ((0, 0), (0, 1), (1, 0)))
    else:
        hd = h.double()
        if pieces == 2:
            hi, mid, _ = _pieces64(h)
            hd = hi + mid
        prod = hd @ w.double().t()
    z = xp.double() + prod + b.double()
    return torch.cat([torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H]),
                      torch.tanh(z[:, 2 * H:3 * H]),
                      torch.sigmoid(z[:, 3 * H:])], dim=1)


def _fwd_product_err(xp, h, w, b, gates=None, pieces=None):
    """A gates residual against the float64 twin's, absolute; with
    ``pieces`` 2 or "three_product", the reading that split (see
    :func:`_gates64`) would give in exact arithmetic."""
    if pieces is not None:
        gates = _gates64(xp, h, w, b, pieces=pieces)
    return (gates.double() - _gates64(xp, h, w, b)).abs().max().item()


def _lstm_errs(lt, ops):
    """The kernels against their twins on the same operands: each wrapper
    on the route its rule gives (checked taken), the forward also forced
    onto the FMA kernel and the backward onto the SIMT kernel. Returns
    {"fwd", "fwd_simt", "bwd", "bwd_simt": errors, "fwd_product",
    "bwd_product": readings or None}: the forward's gates residual against
    the float64 twin (tensor-core route, FMA kernel and, with float32
    carries, the control: a two-piece split of h with a bf16 W, three
    products with a float32 W), and with float32 carries the backward's dh
    against the float64 product of its own dz (:func:`_product_err`; the
    control: a two-piece split of dz with a bf16 W, W's hi piece alone
    with a float32 W)."""
    xp, h, c, w, b, dh1, dc1 = ops
    route = lt.lstm_fwd_route(w)
    bwd_route = lt.lstm_bwd_route(w)
    wp = lt.lstm_tc_weight(w)
    ref = lt.lstm_fwd_reference(xp, h, c, w, b, True)
    kg = _route_taken(lt, "lstm_fwd_gates", lambda: lt.lstm_fwd_gates(
        xp, h, c, w, b, w_packed=wp), route)
    k0 = _route_taken(lt, "lstm_fwd", lambda: lt.lstm_fwd(
        xp, h, c, w, b, w_packed=wp), route)
    fs = lt.lstm_fwd_gates(xp, h, c, w, b, _route="simt")
    rb = lt.lstm_bwd_reference(ref[2], c, ref[1], w, dh1, dc1)
    kb = _route_taken(lt, "lstm_bwd", lambda: lt.lstm_bwd(
        ref[2], c, ref[1], w, dh1, dc1, w_packed=wp), bwd_route)
    ks = lt.lstm_bwd(ref[2], c, ref[1], w, dh1, dc1, _route="simt")
    torch.cuda.synchronize()
    outs = [t for t in kg + k0 + kb + fs + ks if t is not None]
    if not all(torch.isfinite(t).all() for t in outs):
        raise AssertionError("an LSTM kernel gave a non-finite value")

    def bwd_err(k):
        return max(_max_err(a, r) / max(r.float().abs().max().item(), 1e-30)
                   for a, r in zip(k, rb))
    f32 = dh1.dtype == torch.float32
    fwd_product = {"tensor_core": _fwd_product_err(xp, h, w, b, kg[2]),
                   "fma": _fwd_product_err(xp, h, w, b, fs[2])}
    if f32 and w.dtype == torch.float32:
        fwd_product["three_product"] = _fwd_product_err(
            xp, h, w, b, pieces="three_product")
    elif f32:
        fwd_product["two_piece"] = _fwd_product_err(xp, h, w, b, pieces=2)
    bwd_product = None
    if f32:
        control = (("w_hi", "w_hi") if w.dtype == torch.float32
                   else ("two_piece", 2))
        bwd_product = {
            "tensor_core": _product_err(kb[0], w, kb[1]),
            "simt": _product_err(ks[0], w, ks[1]),
            control[0]: _product_err(kb[0], w, kb[1], pieces=control[1]),
            "tensor_core_vs_simt": (_max_err(kb[1], ks[1]) / max(
                ks[1].abs().max().item(), 1e-30))}
    return {"fwd": _scaled_err(kg + k0[:2], ref + ref[:2]),
            "fwd_simt": _scaled_err(fs, ref),
            "bwd": bwd_err(kb), "bwd_simt": bwd_err(ks),
            "fwd_product": fwd_product, "bwd_product": bwd_product}


def _lstm_scan_errs(lt, g, od, wd, sd, T, N, H, reverse):
    """lstm_scan forward + backward on the card (kernels) against the same
    on the CPU (twins)."""
    ins = [_rnd(g, od, T, N, 4 * H), _rnd(g, sd, N, H, sc=0.5),
           _rnd(g, sd, N, H), _rnd(g, wd, 4 * H, H, sc=H ** -0.5),
           _rnd(g, od, 4 * H, sc=0.1)]
    cts = [_rnd(g, sd, T, N, H), _rnd(g, sd, N, H), _rnd(g, sd, N, H)]
    res = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_(True) for t in ins]
        out = lt.lstm_scan(*leaves, reverse=reverse)
        grads = torch.autograd.grad(out, leaves, [t.to(dev) for t in cts])
        res.append([t.detach().cpu() for t in out + grads])
    fwd = _scaled_err(res[0][:3], res[1][:3])
    bwd = max(_max_err(a, b) / max(b.float().abs().max().item(), 1e-30)
              for a, b in zip(res[0][3:], res[1][3:]))
    return fwd, bwd


def _lstm_bytes_flops(od, wd, sd, N, H, kernel, route="sm90"):
    """What the kernel must move (inputs read once, outputs written once)
    and its product's flops, with the type the product runs in. On the
    tensor-core routes a float32 operand is three bf16 pieces: the
    backward's dz always, the forward's h with float32 carries, and W
    when float32, where a stage runs the six products of two three-piece
    operands (three of one; one of two bf16 operands). On the FMA / SIMT
    route (``route`` "simt") the product is float32's."""
    eo, ew, es = (torch.empty((), dtype=t).element_size()
                  for t in (od, wd, sd))
    flops = 2 * N * H * 4 * H
    if kernel == "lstm_bwd":
        moved = (N * 4 * H * 4 + 4 * N * H * es + 4 * H * H * ew
                 + N * 4 * H * 4 + 2 * N * H * es)
        pieces = 6 if wd == torch.float32 else 3
    else:
        gates = N * 4 * H * 4 if kernel == "lstm_fwd_gates" else 0
        moved = (N * 4 * H * eo + 2 * N * H * es + 4 * H * H * ew
                 + 4 * H * eo + 2 * N * H * es + gates)
        pieces = {(3, 3): 6, (3, 1): 3, (1, 3): 3, (1, 1): 1}[
            (3 if sd == torch.float32 else 1, 3 if wd == torch.float32 else 1)]
    if route == "sm90":
        return moved, pieces * flops, torch.bfloat16
    return moved, flops, torch.float32


def _lstm_tag(od, wd, sd):
    return (f"{str(od)[6:]} ops {str(wd)[6:]} W {str(sd)[6:]} carries")


def lstm_f32_fwd_timings(lt, rounds: int = 2):
    """The all-float32 forward at the lane (N 128, H 650): ``lstm_fwd``
    and ``lstm_fwd_gates`` on the route W's type gives them (with W's copy
    where that route reads one) and forced onto the FMA kernel
    (``_route="simt"``), in turns (:func:`_in_turns`). W stays in L2, as it
    does from one step of the scan to the next."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    f32 = torch.float32
    xp, h, c, w, b, _, _ = _lstm_operands(g, f32, f32, f32, LM_N, LM_H)
    route = lt.lstm_fwd_route(w)
    wp = lt.lstm_tc_weight(w) if route == "sm90" else None
    out = {}
    for name in ("lstm_fwd", "lstm_fwd_gates"):
        kern = getattr(lt, name)
        res = _in_turns({
            route: lambda: kern(xp, h, c, w, b, w_packed=wp),
            "fma": lambda: kern(xp, h, c, w, b, _route="simt")}, kern,
            rounds)
        out[name] = res
        log(f"time {name} all-float32 N {LM_N} H {LM_H} (route {route}): "
            f"{_turns_line(res)}")
    return out


def lstm_kernel_checks(lt, common):
    """Phase 17: the B8 kernels against their twins: a sweep of H 16, 20,
    64, 211 (prime), 650, 1030 and N 5, 8, 64, 128, 256 in each type form
    (``LSTM_TYPES`` and the mixed float32-W forms
    ``LSTM_F32W_MIXED_TYPES``; with and without the residual; bf16
    carries round c to bf16; every forward on its tensor-core route, W in
    three pieces when float32, and again on the FMA kernel; the backward on
    its tensor-core route, W in three pieces when float32, and again on the
    SIMT kernel), the product checks (the forward's gates and the
    backward's dh against float64), the whole scan forward + backward in
    both directions against the CPU twins, the tensor-core kernels as
    built, then the lane's shape (N 128, H 650) with times beside the
    twin's, the bound, cuDNN's whole-sequence LSTM per step as the library
    yardstick, and for the tensor-core routes the FMA / SIMT kernel's time
    in the same call (in turns), the device time, the time of one call
    replayed from a CUDA graph and the host µs (the all-float32 backward's
    four readings beside the SIMT kernel's by :func:`_in_turns`), and the
    all-float32 forward's device, graph, event and host times beside the
    FMA kernel's in turns (:func:`lstm_f32_fwd_timings`). Returns the JSON
    records (the lane's layer-1 form, and the all-float32 form's
    ``lstm_fwd``, a user's eval, and ``lstm_bwd``, phase 19's) and a log
    of every timing."""
    sass = lstm_sass_check(common)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, n_cases = {}, 0
    products = {}                       # the product readings' range

    def note(kind, readings):
        for k, v in (readings or {}).items():
            lo, hi = products.get(f"{kind} {k}", (v, v))
            products[f"{kind} {k}"] = (min(lo, v), max(hi, v))

    def check_products(where, e, lane=False, f32w=False):
        fp, bp = e["fwd_product"], e["bwd_product"]
        bctl = None if bp is None else bp.get("two_piece", bp.get("w_hi"))
        control = fp.get("two_piece", fp.get("three_product"))
        if fp["tensor_core"] > LSTM_FWD_PRODUCT_TOL or (
                lane and control is not None
                and control <= LSTM_FWD_PRODUCT_TOL) or (
                lane and f32w and fp["tensor_core"] > fp["fma"]):
            raise AssertionError(f"the forward's tensor-core product {where}: "
                                 f"{json.dumps(fp)} (limit "
                                 f"{LSTM_FWD_PRODUCT_TOL})")
        if bp is not None and (bp["tensor_core"] > LSTM_PRODUCT_TOL or (
                (lane or f32w) and bctl <= LSTM_PRODUCT_TOL)):
            raise AssertionError(f"lstm_bwd's tensor-core product {where}: "
                                 f"{json.dumps(bp)} (limit "
                                 f"{LSTM_PRODUCT_TOL})")
        note("fwd", fp)
        note("bwd", bp)

    for od, wd, sd in LSTM_TYPES + LSTM_F32W_MIXED_TYPES:
        tol_f, tol_b = LSTM_TOL[torch.bfloat16 if torch.bfloat16 in (
            od, wd, sd) else torch.float32]
        key = _lstm_tag(od, wd, sd)
        for H in (16, 20, 64, 211, 650, 1030):
            for N in (5, 8, 64, 128, 256):
                e = _lstm_errs(lt, _lstm_operands(g, od, wd, sd, N, H))
                if e["fwd"] > tol_f or (e["fwd_simt"] or 0.0) > tol_f \
                        or e["bwd"] > tol_b or (e["bwd_simt"] or 0.0) > tol_b:
                    raise AssertionError(f"LSTM kernels {key} N {N} H {H}: "
                                         f"{json.dumps(e)}")
                check_products(f"{key} N {N} H {H}", e,
                               f32w=wd == torch.float32)
                for k in ("fwd", "fwd_simt", "bwd", "bwd_simt"):
                    if e[k] is not None:
                        worst[f"{key} {k}"] = max(
                            worst.get(f"{key} {k}", 0.0), e[k])
                n_cases += 1
        for reverse in (False, True):
            fwd, bwd = _lstm_scan_errs(lt, g, od, wd, sd, 6, 16, 211, reverse)
            if fwd > tol_f or bwd > tol_b:
                raise AssertionError(f"lstm_scan {key} reverse {reverse}: "
                                     f"forward {fwd}, backward {bwd}")
            worst[key + " scan"] = max(worst.get(key + " scan", 0.0), fwd,
                                       bwd)
    log(f"LSTM kernel sweep: {n_cases} shapes x 3 kernels (and the FMA "
        f"forward and the SIMT backward) and the scan in both directions "
        f"within tolerance; worst {json.dumps(worst)}")
    log(f"LSTM products, (least, most) over the sweep: the forward's gates "
        f"residual against float64, absolute (tensor-core route at most "
        f"{LSTM_FWD_PRODUCT_TOL}); with float32 carries the "
        f"backward's dh against the float64 product of its dz, over the "
        f"largest entry (tensor-core route at most {LSTM_PRODUCT_TOL}): "
        f"{json.dumps(products)}")
    timings = {"sass": sass, "sweep": worst, "sweep_products": products}
    records = {}
    N, H, T = LM_N, LM_H, LM_T
    for od, wd, sd in LSTM_TYPES:
        tag = _lstm_tag(od, wd, sd)
        xp, h, c, w, b, dh1, dc1 = _lstm_operands(g, od, wd, sd, N, H)
        e = _lstm_errs(lt, (xp, h, c, w, b, dh1, dc1))
        routes = {"lstm_fwd_gates": lt.lstm_fwd_route(w),
                  "lstm_fwd": lt.lstm_fwd_route(w),
                  "lstm_bwd": lt.lstm_bwd_route(w)}
        if sd == torch.float32:
            log(f"lane errors ({tag}): forward {e['fwd']:.3g}, FMA "
                f"{e['fwd_simt']:.3g}; backward {e['bwd']:.3g} (at most "
                f"{LSTM_LANE_BWD_TOL}, float32's bound), SIMT "
                f"{e['bwd_simt']}")
            log(f"lane products ({tag}): forward gates against float64 "
                f"{json.dumps(e['fwd_product'])} (tensor-core at most "
                f"{LSTM_FWD_PRODUCT_TOL}, the control above it); backward "
                f"dh {json.dumps(e['bwd_product'])} (tensor-core at most "
                f"{LSTM_PRODUCT_TOL}, the control above it)")
            if e["bwd"] > LSTM_LANE_BWD_TOL:
                raise AssertionError(f"lstm_bwd at the lane: {json.dumps(e)}")
            check_products(f"at the lane {tag}", e, lane=True,
                           f32w=wd == torch.float32)
        gates = lt.lstm_fwd_gates(xp, h, c, w, b, _route="simt")[2]
        # the tensor-core routes read W's padded copy, which the scan makes
        # once a sequence (its time is logged apart)
        wp = lt.lstm_tc_weight(w)
        runs = {
            "lstm_fwd_gates": (
                lambda: lt.lstm_fwd_gates(xp, h, c, w, b, w_packed=wp),
                lambda: lt.lstm_fwd_gates(xp, h, c, w, b, _route="simt"),
                lambda: lt.lstm_fwd_reference(xp, h, c, w, b, True)),
            "lstm_fwd": (
                lambda: lt.lstm_fwd(xp, h, c, w, b, w_packed=wp),
                lambda: lt.lstm_fwd(xp, h, c, w, b, _route="simt"),
                lambda: lt.lstm_fwd_reference(xp, h, c, w, b, False)),
            "lstm_bwd": (
                lambda: lt.lstm_bwd(gates, c, c, w, dh1, dc1, w_packed=wp),
                lambda: lt.lstm_bwd(gates, c, c, w, dh1, dc1, _route="simt"),
                lambda: lt.lstm_bwd_reference(gates, c, c, w, dh1, dc1))}
        lib = _cudnn_lstm_per_step(od, T, N, H)
        for name, (kern, old, plain) in runs.items():
            tc = routes[name] == "sm90"
            moved, flops, prod = _lstm_bytes_flops(od, wd, sd, N, H, name,
                                                   routes[name])
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[prod] * 1e3
            err = e["bwd"] if name == "lstm_bwd" else e["fwd"]
            rec = {"name": name, "route": "cuda", "source": LSTM_SOURCE,
                   "replaces": LSTM_REPLACES[name], "launches": 0,
                   "max_abs_err": err,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": ("bytes" if t_bytes >= t_ops
                                else "operations"),
                   "library_ms": lib[name]}
            if tc and wd == torch.float32:
                _, fma_flops, _ = _lstm_bytes_flops(od, wd, sd, N, H, name,
                                                    "simt")
                rec["fma_bound_ms"] = max(
                    t_bytes, fma_flops / PEAK_FLOPS[torch.float32] * 1e3)
            if tc and wd == torch.float32 and name == "lstm_bwd":
                # the float32-W backward and the SIMT kernel in turns,
                # device, graph, event and host readings of both
                turns = _in_turns({"sm90": kern, "simt": old}, lt.lstm_bwd)
                new, simt = turns["sm90"], turns["simt"]
                ms = new["event_ms"]
                log(f"turns lstm_bwd {tag} N {N} H {H}: "
                    f"{_turns_line(turns)}")
                rec.update(name="lstm_bwd/sm90_f32w",
                           earlier_ms=simt["event_ms"],
                           earlier_device_ms=simt["device_ms"],
                           earlier_graph_ms=simt["graph_ms"],
                           earlier_host_us=simt["host_us"],
                           earlier_device_kernels_ms=simt["kernels"],
                           earlier_max_abs_err=e["bwd_simt"],
                           product_err=e["bwd_product"],
                           device_ms=new["device_ms"],
                           device_kernels_ms=new["kernels"],
                           host_us=new["host_us"], graph_ms=new["graph_ms"],
                           rounds={k: v for k, v in new.items()
                                   if k.endswith("_rounds")},
                           earlier_rounds={k: v for k, v in simt.items()
                                           if k.endswith("_rounds")},
                           weight_copy_ms=time_ms(
                               lambda: lt.lstm_tc_weight(w), iters=20))
            elif tc:
                # the tensor-core kernel and the FMA / SIMT one in turns
                ms1, old1 = time_ms(kern, iters=50), time_ms(old, iters=50)
                ms2, old2 = time_ms(kern, iters=50), time_ms(old, iters=50)
                ms = (ms1 + ms2) / 2
                dev_ms, by_kernel = device_ms(kern, getattr(lt, name))
                rec.update(name=f"{name}/sm90" + (
                               "_f32w" if wd == torch.float32 else ""),
                           earlier_ms=(old1 + old2) / 2,
                           earlier_max_abs_err=e[
                               "bwd_simt" if name == "lstm_bwd"
                               else "fwd_simt"],
                           product_err=e[
                               "bwd_product" if name == "lstm_bwd"
                               else "fwd_product"],
                           device_ms=dev_ms, device_kernels_ms=by_kernel,
                           host_us=host_us(kern), graph_ms=graph_ms(kern),
                           weight_copy_ms=time_ms(
                               lambda: lt.lstm_tc_weight(w), iters=20))
            else:
                ms = time_ms(kern, iters=50)
            rec.update(ms=ms, plain_ms=time_ms(plain, iters=20))
            timings[f"{name} {tag}"] = rec
            if (od, wd, sd) == LSTM_TYPES[0]:
                records[rec["name"]] = rec
            elif (od, wd, sd) == LSTM_TYPES[3] and name in ("lstm_fwd",
                                                            "lstm_bwd"):
                records[rec["name"]] = rec
            extra = (f"; FMA/SIMT {rec['earlier_ms']:.4f} ms, device "
                     f"{_ms(rec['device_ms'])} ms "
                     f"{json.dumps(rec['device_kernels_ms'])}, graph "
                     f"{rec['graph_ms']} ms, host "
                     f"{rec['host_us']:.1f} us, W copy (once a sequence) "
                     f"{rec['weight_copy_ms']:.4f} ms"
                     if "device_ms" in rec else "")
            log(f"time {rec['name']} {tag} N {N} H {H}: {ms:.4f} ms, plain "
                f"{rec['plain_ms']:.4f} ms, cuDNN per step (median) "
                f"{lib[name]:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}){extra}")
        timings[f"lstm_scan T {T} {tag}"] = _scan_time(lt, g, od, wd, sd, T,
                                                       N, H)
        torch.cuda.empty_cache()
    timings["all-float32 forward turns"] = lstm_f32_fwd_timings(lt)
    return records, timings


def _cudnn_lstm_per_step(dt, T, N, H, tries: int = 3):
    """cuDNN's whole-sequence LSTM (``torch.nn.LSTM``, all in ``dt``) at the
    same T, N, H, per step: inference forward (beside ``lstm_fwd``),
    training forward (beside ``lstm_fwd_gates``) and the backward (forward
    + backward less the training forward, beside ``lstm_bwd``), each the
    median of ``tries`` tries, whose spread is logged (one reading moved
    2.5x between calls). It also computes the input projection (forward)
    and its gradients (backward: dx and dW_ih, which ``lstm_bwd`` leaves to
    the scan's one product), which the B8 kernels do not. A yardstick of
    this phase only; the port never calls it."""
    net = torch.nn.LSTM(H, H).to(device="cuda", dtype=dt)
    x = torch.randn(T, N, H, device="cuda", dtype=dt, requires_grad=True)
    gy = torch.randn(T, N, H, device="cuda", dtype=dt)

    def infer():
        with torch.no_grad():
            net(x)

    def train_fwd():
        net(x)

    def train_step():
        y, _ = net(x)
        y.backward(gy)

    reads = {"lstm_fwd": [], "lstm_fwd_gates": [], "lstm_bwd": []}
    for _ in range(tries):
        f_inf = time_ms(infer, iters=10, warmup=2) / T
        f_tr = time_ms(train_fwd, iters=10, warmup=2) / T
        both = time_ms(train_step, iters=10, warmup=2) / T
        reads["lstm_fwd"].append(f_inf)
        reads["lstm_fwd_gates"].append(f_tr)
        reads["lstm_bwd"].append(both - f_tr)
    log(f"cuDNN LSTM {str(dt)[6:]} T {T} N {N} H {H} per step, {tries} "
        f"tries (min, median, max ms): " + json.dumps(
            {k: [min(v), float(np.median(v)), max(v)]
             for k, v in reads.items()}))
    return {k: float(np.median(v)) for k, v in reads.items()}


def _scan_time(lt, g, od, wd, sd, T, N, H):
    """One lstm_scan forward (no gradient) and one forward + backward over
    T steps (CUDA events), and the forward's host time (no
    synchronisation: when it exceeds the event time the host sets the
    pace)."""
    leaves = [t.requires_grad_(True) for t in (
        _rnd(g, od, T, N, 4 * H), _rnd(g, sd, N, H), _rnd(g, sd, N, H),
        _rnd(g, wd, 4 * H, H, sc=H ** -0.5), _rnd(g, od, 4 * H))]
    gy = _rnd(g, sd, T, N, H)

    def fwd():
        with torch.no_grad():
            lt.lstm_scan(*leaves)

    def fwd_bwd():
        ys, _, _ = lt.lstm_scan(*leaves)
        torch.autograd.grad(ys, leaves, gy)

    out = {"forward_ms": time_ms(fwd, iters=5, warmup=1),
           "forward_host_ms": host_us(fwd, calls=5) / 1e3,
           "forward_backward_ms": time_ms(fwd_bwd, iters=5, warmup=1)}
    log(f"lstm_scan T {T} N {N} H {H} {_lstm_tag(od, wd, sd)}: "
        f"{json.dumps(out)}")
    return out


# ------------------------------------------------------ the word-LM lane
def _word_lm(mx, seed, dropout, dtype=None, **kw):
    """bench.py's lane (bench.py:500-520): RNNModel lstm, vocab 33278,
    embed = hidden 650, 2 layers, Xavier, on the card; a (T 35, batch 128)
    token batch from the seed; the functional SGD step at lr 1.0 (``kw``
    to ``make_train_step``)."""
    from incubator_mxnet_tpu_torch.models.word_lm import RNNModel
    from incubator_mxnet_tpu_torch.parallel.dp import make_train_step
    rs = np.random.RandomState(seed)
    x_np = rs.randint(0, LM_VOCAB, (LM_T, LM_N)).astype(np.int32)
    y_np = rs.randint(0, LM_VOCAB, (LM_T, LM_N)).astype(np.int32)
    mx.random.seed(seed)
    with mx.gpu(0):
        net = RNNModel(mode="lstm", vocab_size=LM_VOCAB, num_embed=LM_H,
                       num_hidden=LM_H, num_layers=2, dropout=dropout)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(x_np))
    step, params, aux, opt = make_train_step(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=1.0, compute_dtype=dtype, **kw)
    return (net, step, params, aux, opt, torch.from_numpy(x_np).cuda(),
            torch.from_numpy(y_np).cuda())


def _lm_yardstick(mx, net, dtype):
    from incubator_mxnet_tpu_torch.parallel.dp import make_train_step
    return make_train_step(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=1.0, compute_dtype=dtype, _capture=False)


def word_lm_train_phase(mx, common, records, steps=5):
    """Phase 18: the word LM at bench.py's lane (2 x 650 LSTM, vocab 33278,
    bptt 35, batch 128, dropout 0.5, bf16 compute on float32 masters, SGD
    lr 1.0), one update per call, through the captured step (the dropout
    masks drawn from the device's generator, which each graph registers):
    2 warm-up and 5 timed steps; finite, falling loss; exactly 70
    ``lstm_fwd_gates`` and 70 ``lstm_bwd`` launches per step (2 layers x
    35 steps), counted through the replays, all on the tensor-core routes
    (bf16 W_hh in both layers), and no ``lstm_fwd``; the eager yardstick
    (``_capture=False``) and the captured step timed in turns, three runs
    of 5 steps each; two replays from the same state after the same seed
    give the same loss, a third without the re-seed another; with dropout
    0, one replay and one eager step from the same state (loss and
    parameter updates, held after phase 16 to its spread); then a profiled
    window of two steps; then two eval forwards (no autograd, no grad,
    dropout off), each 70 ``lstm_fwd`` launches and nothing else of B8,
    all on the tensor-core route: a user's ``net(x)`` on the net's own
    float32 parameters (a float32 W_hh in three bf16 pieces), and the
    trained parameters cast to bf16; each timed, with its B8 forward's
    device time."""
    import gc
    from incubator_mxnet_tpu_torch.ops.cuda import lstm as lt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, step, params, aux, opt, x, y = _word_lm(mx, SEED + 7, 0.5,
                                                 torch.bfloat16)
    first_ms, state, losses = _timed_steps(step, (params, aux, opt), x, y, 1)
    _, state, more = _timed_steps(step, state, x, y, 1)
    losses += more
    common.reset_launch_counts()
    wall, state, more = _timed_steps(step, state, x, y, steps)
    losses += more
    launches = common.launch_counts()
    sm90 = common.sm90_launch_counts()
    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"word LM train, captured: first call {first_ms:.1f} ms; losses "
        f"{[round(v, 4) for v in losses]}; {steps} timed steps "
        f"{wall:.2f} ms/step; peak {peak_gb:.2f} GB; launches {launches}; "
        f"on the tensor-core routes: lstm_fwd_gates "
        f"{sm90['lstm_fwd_gates']}, lstm_bwd {sm90['lstm_bwd']}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"word LM loss not finite and falling: "
                             f"{losses}")
    per_step = {"lstm_fwd_gates": 70, "lstm_bwd": 70, "lstm_fwd": 0}

    def check(label, got=None, got90=None):
        got = got or common.launch_counts()
        got90 = got90 or common.sm90_launch_counts()
        for name, n in per_step.items():
            if got[name] != n * steps:
                raise AssertionError(f"{label}: {name} launched {got[name]} "
                                     f"times in {steps} word-LM steps, not "
                                     f"{n * steps}")
        # bf16 W_hh: every forward and backward step on the tensor cores
        for name in ("lstm_fwd_gates", "lstm_bwd"):
            if got90[name] != 70 * steps:
                raise AssertionError(f"{label}: {name} took the tensor-core "
                                     f"route {got90[name]} times in {steps} "
                                     f"word-LM steps, not {70 * steps}")
    check("captured", launches, sm90)
    records["lstm_fwd_gates/sm90"]["launches"] = sm90["lstm_fwd_gates"]
    records["lstm_bwd/sm90"]["launches"] = sm90["lstm_bwd"]
    estep, *estate = _lm_yardstick(mx, net, torch.bfloat16)
    _, estate, _ = _timed_steps(estep, tuple(estate), x, y, 2)
    kinds = {"captured": [step, state], "eager": [estep, estate]}
    reads = _turns(kinds, x, y, steps, RESNET_REPEATS, check)
    cap_ms = sum(reads["captured"]) / len(reads["captured"])
    eager_ms = sum(reads["eager"]) / len(reads["eager"])
    tok_s = LM_T * LM_N * 1e3 / cap_ms
    log(f"word LM train in turns ({steps} steps a run): captured "
        f"{reads['captured']} ms/step, eager {reads['eager']}; means "
        f"{cap_ms:.2f} and {eager_ms:.2f} ms ({tok_s:.0f} and "
        f"{LM_T * LM_N * 1e3 / eager_ms:.0f} tok/s)")
    # the registered generator: a re-seed reaches the replays
    snap = tuple(_clone(t) for t in kinds["captured"][1])
    seeded = []
    for reseed in (True, True, False):
        if reseed:
            mx.random.seed(SEED + 70)
        seeded.append(_one_step_from(step, snap, x, y)[0])
    log(f"word LM replays from one state: seed, replay {float(seeded[0])}; "
        f"seed, replay {float(seeded[1])}; replay {float(seeded[2])}")
    if not torch.equal(seeded[0], seeded[1]) \
            or torch.equal(seeded[1], seeded[2]):
        raise AssertionError(f"word LM dropout draws under replay: "
                             f"{[float(v) for v in seeded]}")
    breakdown = kernel_breakdown(
        "word LM (captured)", lambda: step(*kinds["captured"][1], x, y),
        ("lstm_fwd_kernel", "lstm_fwd_tc_kernel", "lstm_bwd_kernel",
         "lstm_bwd_dz_kernel", "lstm_bwd_tc_kernel"),
        counted={"lstm_fwd_tc_kernel": lt.lstm_fwd_gates,
                 "lstm_bwd_tc_kernel": lt.lstm_bwd,
                 "lstm_bwd_dz_kernel": lt.lstm_bwd})
    params = kinds["captured"][1][0]
    aux = kinds["captured"][1][1]
    del estep, estate, kinds
    # dropout 0: a replay against an eager step from the same state (the
    # first call runs eagerly, then captures)
    znet, zstep, zp, za, zo, _, _ = _word_lm(mx, SEED + 7, 0.0,
                                             torch.bfloat16)
    zeager, *_ = _lm_yardstick(mx, znet, torch.bfloat16)
    zsnap = tuple(_clone(t) for t in (zp, za, zo))
    _one_step_from(zstep, zsnap, x, y)
    zero = _agreement("word LM dropout 0: captured replay vs eager step, "
                      "same state", _one_step_from(zstep, zsnap, x, y),
                      _one_step_from(zeager, zsnap, x, y))
    del znet, zstep, zeager, zsnap, zp, za, zo
    gc.collect()
    torch.cuda.empty_cache()
    # the eval forwards: recording off, no gradient, dropout off. A user's
    # net(x) runs the net's own float32 parameters, so its float32 W_hh
    # goes to the tensor-core kernel in three pieces; the trained
    # parameters cast to bf16 (the lane's compute type, float32 states)
    # take it as one
    from incubator_mxnet_tpu_torch.parallel.dp import functional_call
    xs = mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0))
    bf16 = {n: v.to(torch.bfloat16) if v.is_floating_point() else v
            for n, v in {**params, **aux}.items()}

    def eval_user():
        with torch.no_grad():
            return net(xs)[0]._data

    def eval_bf16():
        with torch.no_grad():
            return functional_call(net, bf16, x, training=False)[0]
    evals = {}
    for label, fn, on_sm90 in (("user_float32", eval_user, 70),
                               ("bf16", eval_bf16, 70)):
        common.reset_launch_counts()
        logits = fn()
        torch.cuda.synchronize()
        ev = common.launch_counts()
        ev_sm90 = common.sm90_launch_counts()["lstm_fwd"]
        log(f"word LM eval forward ({label}): logits {tuple(logits.shape)}; "
            f"launches {ev}; lstm_fwd on the tensor-core route {ev_sm90}")
        if ev["lstm_fwd"] != 70 or ev_sm90 != on_sm90 \
                or ev["lstm_fwd_gates"] or ev["lstm_bwd"] \
                or not bool(torch.isfinite(logits).all()) \
                or tuple(logits.shape) != (LM_T, LM_N, LM_VOCAB):
            raise AssertionError(f"eval forward ({label}): launches {ev}, "
                                 f"on the tensor-core route {ev_sm90}")
        del logits
        evals[label] = {
            "lstm_fwd_launches": ev["lstm_fwd"], "sm90_launches": ev_sm90,
            "ms": time_ms(fn, iters=5, warmup=1),
            **kernel_breakdown(f"word LM eval forward ({label})", fn,
                               ("lstm_fwd_kernel", "lstm_fwd_tc_kernel"))}
    records["lstm_fwd/sm90_f32w"]["launches"] = (
        evals["user_float32"]["sm90_launches"])
    records["lstm_fwd/sm90"]["launches"] = evals["bf16"]["sm90_launches"]
    return {"step_ms": cap_ms, "tok_s": tok_s,
            "step_ms_runs": reads["captured"], "eager_step_ms": eager_ms,
            "eager_tok_s": LM_T * LM_N * 1e3 / eager_ms,
            "eager_step_ms_runs": reads["eager"], "first_call_ms": first_ms,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, "launches_per_step": per_step,
            "sm90_launches_per_step": {"lstm_fwd_gates": 70,
                                       "lstm_bwd": 70},
            "reseeded_replays_loss": [float(v) for v in seeded],
            "dropout0_captured_vs_eager": zero,
            "eval_forward": evals, **breakdown}


def agreement_check(resnet, resnet_truth, word_lm):
    """Captured against eager steps, and remat against none, from the same
    state (phases 14 and 18): each loss within phase 16's whole-net loss
    tolerance (rtol 1e-3) and each parameter update within the spread
    phase 16 measured on the per-block path's own gradients (the largest
    over its stages; it is 0 when every kernel is deterministic, and the
    readings are then equal bit for bit)."""
    spread = max(v["param_spread"] for k, v in resnet_truth.items()
                 if k.startswith("stage"))
    pairs = {"resnet captured vs eager": resnet["captured_vs_eager"],
             "resnet remat=nothing vs none":
             resnet["remat"]["nothing"]["vs_none"],
             "resnet remat=dots vs none": resnet["remat"]["dots"]["vs_none"],
             "word LM dropout 0 captured vs eager":
             word_lm["dropout0_captured_vs_eager"]}
    log(f"agreement against phase 16's parameter-gradient spread "
        f"{spread:.3g}: " + "; ".join(
            f"{k}: loss {v['loss_rel']:.3g}, update {v['update_err']:.3g}"
            f"{' (bitwise)' if v['bitwise'] else ''}"
            for k, v in pairs.items()))
    for k, v in pairs.items():
        if v["loss_rel"] > 1e-3 or v["update_err"] > spread:
            raise AssertionError(f"{k}: {v} (spread {spread})")
    return {"param_spread": spread, **pairs}


def _lm_loss_and_grads(net, params, x, y, mx):
    from incubator_mxnet_tpu_torch.parallel.dp import _forward_loss
    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in params.items()}
    with torch.enable_grad():
        loss = _forward_loss(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             leaves, x, y, None)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def word_lm_truth_phase(mx, lt, common, records):
    """Phase 19: at the lane's width in float32 (dropout 0), one
    loss-and-gradient pass with the kernels against the same pass on the
    twins (loss rtol 1e-4, every gradient leaf within 1e-3 of its largest
    entry), its 70 ``lstm_fwd_gates`` and 70 ``lstm_bwd`` launches all on
    the tensor-core routes with W in three pieces (the float32-W
    backward's record takes its launches from here); then one Trainer +
    autograd.record() step, the reference's imperative route, which must
    launch the same kernels and give the same loss."""
    net, _, params, _, _, x, y = _word_lm(mx, SEED + 8, 0.0)
    common.reset_launch_counts()
    loss_k, grads_k = _lm_loss_and_grads(net, params, x, y, mx)
    torch.cuda.synchronize()
    launches = common.launch_counts()
    sm90 = common.sm90_launch_counts()
    # a float32 W: the forward and the backward on the tensor cores
    if launches["lstm_fwd_gates"] != 70 or launches["lstm_bwd"] != 70 \
            or sm90["lstm_fwd_gates"] != 70 or sm90["lstm_bwd"] != 70:
        raise AssertionError(f"f32 pass launches {launches}, on the "
                             f"tensor-core routes {sm90}")
    records["lstm_bwd/sm90_f32w"]["launches"] = sm90["lstm_bwd"]
    # the twins in the kernels' place: the scan's forward steps (and the
    # cell's, off this path) and its backward steps
    steps = (lt._kernel_steps, lt._step_fwd, lt._step_bwd)

    def twin_fwd(*args, out=None, w_packed=None):
        return lt._twin_fwd(*args, out=out)      # the twin reads W itself

    def twin_bwd(*args, out=None, w_packed=None):
        return lt._twin_bwd(*args, out=out)
    lt._kernel_steps, lt._step_fwd, lt._step_bwd = (lt._twin_steps,
                                                    twin_fwd, twin_bwd)
    common.reset_launch_counts()
    try:
        loss_t, grads_t = _lm_loss_and_grads(net, params, x, y, mx)
    finally:
        lt._kernel_steps, lt._step_fwd, lt._step_bwd = steps
    torch.cuda.synchronize()
    if any(common.launch_counts().values()):
        raise AssertionError(f"the twins' pass launched kernels: "
                             f"{common.launch_counts()}")
    loss_err = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
    worst = max((grads_k[n] - grads_t[n]).abs().max().item()
                / max(grads_t[n].abs().max().item(), 1e-30)
                for n in grads_t)
    log(f"f32 word LM pass, kernels vs twins: loss {loss_k.item():.6f} vs "
        f"{loss_t.item():.6f} (rel {loss_err:.3g}, rtol 1e-4); worst "
        f"gradient leaf {worst:.3g} (1e-3) over {len(grads_t)} leaves")
    if not np.isfinite(loss_k.item()) or loss_err > 1e-4 or worst > 1e-3:
        raise AssertionError(f"word LM kernels vs twins: loss {loss_err}, "
                             f"gradients {worst}")
    # the imperative route on the same parameters
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xt = mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0))
    yt = mx.nd.array(y.cpu().numpy(), ctx=mx.gpu(0))
    common.reset_launch_counts()
    with mx.autograd.record():
        out, _ = net(xt)
        loss = loss_fn(out, yt)
    loss.backward()
    trainer.step(LM_T * LM_N)
    torch.cuda.synchronize()
    rec = common.launch_counts()
    loss_rec = float(loss.mean().asscalar())
    rec_err = abs(loss_rec - loss_k.item()) / abs(loss_k.item())
    log(f"word LM Trainer + record() step: loss {loss_rec:.6f} (rel "
        f"{rec_err:.3g} to the functional pass); launches {rec}")
    if rec["lstm_fwd_gates"] != 70 or rec["lstm_bwd"] != 70 \
            or rec["lstm_fwd"] or rec_err > 1e-4:
        raise AssertionError(f"record() step: launches {rec}, loss {rec_err}")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst,
            "record_loss_rel_err": rec_err}


# ----------------------------------------------- the detection kernels (B9)
DET_KERNELS = ("multibox_match", "nms_keep")
DET_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/detection.cu"
_DET_PY = "incubator_mxnet_tpu/ops/pallas/detection.py"
DET_REPLACES = {"multibox_match": f"{_DET_PY}:143",
                "nms_keep": f"{_DET_PY}:228"}
DET_VAR = (0.1, 0.1, 0.2, 0.2)
# one corner IoU: 4 min/max, 2 subtractions and 2 clamps for the overlap,
# 1 product, 2 x (2 subtractions + 1 product) for the areas, 1 add, 1
# subtraction, 1 compare, 1 divide; one loc encoding: ~24 (4 differences,
# 4 sums, 4 halvings, 2 eps adds, 6 divides, 2 clamps, 2 logs)
IOU_FLOPS, ENCODE_FLOPS = 19, 24
# SSD-512's anchors: 32²·4 + 16²·4 + (8² + 4² + 2² + 1)·6
SSD_ANCHORS = 5630


def _match_case(rs, B, N, M):
    """Anchors (N, 4) with some zero-area ones and duplicates; labels
    (B, M, 5): row 0 all padding (B > 1), row 1 one object, the rest a
    random count, with repeated boxes; some anchors equal a label's box
    (IoU exactly 1), so both rounds and stage 2 meet ties."""
    anc = np.sort(rs.rand(N, 4).astype(np.float32), axis=-1)
    anc[::17, 2:] = anc[::17, :2]                     # zero area
    anc[1::5] = anc[0]                                # duplicates
    lab = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        n = 0 if (b == 0 and B > 1) else 1 if b == 1 else rs.randint(1, M + 1)
        for m in range(n):
            x0, y0 = rs.rand(2) * 0.5
            w, h = 0.15 + rs.rand(2) * 0.3
            lab[b, m] = [rs.randint(20), x0, y0, x0 + w, y0 + h]
        if n > 2:
            lab[b, 2, 1:] = lab[b, 0, 1:]              # two labels, one box
        if n:
            anc[(7 * b + 3) % N] = lab[b, 0, 1:]
    return (torch.from_numpy(anc).cuda(), torch.from_numpy(lab).cuda())


def _nms_case(rs, B, k):
    """Score-ordered candidates with duplicate boxes (IoU 1), three class
    ids and the ragged tail of padding rows (id -1, not valid)."""
    xy = rs.rand(B, k, 2).astype(np.float32) * 0.7
    wh = 0.05 + rs.rand(B, k, 2).astype(np.float32) * 0.3
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 1::4] = boxes[:, 0:1]
    ids = rs.randint(0, 3, (B, k)).astype(np.float32)
    valid = rs.rand(B, k) > 0.1
    pad = k // 8
    if pad:
        boxes[:, -pad:] = 0.0
        ids[:, -pad:] = -1.0
        valid[:, -pad:] = False
    return tuple(torch.from_numpy(a).cuda() for a in (boxes, ids, valid))


def _match_errs(kd, anc, lab, thr, route=None):
    """Kernel (on ``route``) against twin on the card: anchor_gt and
    anchor_iou must be equal, loc_t within rtol 1e-6 (logf is not correctly
    rounded). Returns loc_t's largest relative and absolute errors."""
    out = kd.multibox_match(anc, lab, thr, DET_VAR, _route=route)
    ref = kd.multibox_match_reference(anc, lab, thr, DET_VAR)
    torch.cuda.synchronize()
    if not torch.equal(out[0], ref[0]) or not torch.equal(out[1], ref[1]):
        bad = (out[0] != ref[0]).sum().item()
        raise AssertionError(f"multibox_match {route or 'cluster'} "
                             f"{tuple(lab.shape)} N {anc.shape[0]} thr "
                             f"{thr}: {bad} anchor_gt and "
                             f"{(out[1] != ref[1]).sum().item()} anchor_iou "
                             "entries differ from the twin")
    err = ((out[2] - ref[2]).abs() / ref[2].abs().clamp_min(1e-30))
    err = torch.where(out[2] == ref[2], torch.zeros_like(err), err)
    err = err.max().item()
    if err > 1e-6:
        raise AssertionError(f"multibox_match {route or 'cluster'} "
                             f"{tuple(lab.shape)} N {anc.shape[0]} thr "
                             f"{thr}: loc_t rel err {err}")
    return err, _max_err(out[2], ref[2])


def _nms_equal(kd, boxes, ids, valid, force, route=None):
    out = kd.nms_keep(boxes, ids, valid, 0.45, force, _route=route)
    ref = kd.nms_keep_reference(boxes, ids, valid, 0.45, force)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"nms_keep {route or 'cluster'} "
                             f"{tuple(ids.shape)} force {force}: "
                             f"{(out != ref).sum().item()} keep entries "
                             "differ")


def _det_kernel_name(mangled):
    """``match_cluster_kernel<1>`` (slice kept) or ``nms_cluster_kernel<2>``
    (the mode) from a mangled name, or None for another kernel of
    detection.cu."""
    m = re.search(r"(match_cluster_kernel|nms_cluster_kernel)IL[bi](\d)EE",
                  mangled)
    return None if m is None else f"{m.group(1)}<{m.group(2)}>"


def det_sass_check(common):
    """The cluster kernels of detection.cu as built (both matcher and all
    three NMS instantiations), each with warp reductions (REDUX: the
    matcher's picks, NMS's propagation) and no local bytes."""
    kernels = _sass_kernels(common, "detection*.o", _det_kernel_name,
                            "REDUX")
    if len(kernels) != 5:
        raise AssertionError(f"expected 5 cluster kernels, found "
                             f"{sorted(kernels)}")
    return kernels


def detection_kernel_checks(kd, common):
    """Phase 20: the B9 kernels against their twins on the card, on both
    routes (the cluster kernels and the first design, ``_route="simple"``).
    The matcher over N 20, 61 (unaligned), 5630 x M 1, 8, 32, 100 x B 1, 32
    at thresholds 0.5 and 0.7, plus N 20000, label state beyond shared
    memory (M 17500) and a batch of one block an image (B 80); NMS over
    k 8, 100, 400, 1024, 5630 x B 1, 32,
    force_suppress on and off, and the eval point's form (the leading 400
    rows of wider rows, read in place). anchor_gt, anchor_iou and keep
    exact, loc_t within rtol 1e-6. Then the cluster kernels as built and
    both routes' times at the timed shapes (``detection_timings``) beside
    the twin's and the bound (no single PyTorch call computes either)."""
    rs = np.random.RandomState(SEED + 20)
    worst, n_match = 0.0, 0
    cases = [(B, N, M) for N in (20, 61, SSD_ANCHORS) for M in (1, 8, 32, 100)
             for B in (1, 32)] + [(2, 20000, 4), (2, 20, 17500), (80, 61, 8)]
    sms = common.sm_count("cuda")
    plans = set()
    for B, N, M in cases:
        anc, lab = _match_case(rs, B, N, M)
        plans.add(kd.match_plan(B, N, M, sms)[::2])
        for thr in (0.5, 0.7):
            for route in DET_ROUTES.values():
                worst = max(worst, _match_errs(kd, anc, lab, thr, route)[0])
                n_match += 1
    log(f"multibox_match sweep: {n_match} cases on both routes (cluster "
        f"plans (split, mode) {sorted(plans)}), anchor_gt and anchor_iou "
        f"equal to the twin's, loc_t worst rel err {worst:.3g} (1e-6)")
    n_nms, plans = 0, set()
    for k in (8, 100, 400, 1024, SSD_ANCHORS):
        for B in (1, 32):
            boxes, ids, valid = _nms_case(rs, B, k)
            plans.add(kd.nms_plan(B, k, sms)[::2])
            for force in (False, True):
                for route in DET_ROUTES.values():
                    _nms_equal(kd, boxes, ids, valid, force, route)
                    n_nms += 1
    boxes, ids, valid = _nms_case(rs, 32, SSD_ANCHORS)
    _nms_equal(kd, boxes[:, :400], ids[:, :400], valid[:, :400], False)
    log(f"nms_keep sweep: {n_nms} cases on both routes (cluster plans "
        f"(split, mode) {sorted(plans)}) and the eval point's strided "
        "rows, keep equal to the twin's")
    sass = det_sass_check(common)
    timings = detection_timings(kd)
    records = {}
    for name, label in (("multibox_match", f"multibox_match "
                         f"{DET_MATCH_TIMED[0]}"),
                        ("nms_keep", f"nms_keep {DET_NMS_TIMED[0]}")):
        t = timings[label]
        new = t["routes"]["new"]
        err = 0.0
        if name == "multibox_match":
            anc, lab = _match_case(rs, *DET_MATCH_TIMED[0])
            err = _match_errs(kd, anc, lab, 0.5)[1]
        records[name] = {
            "name": name, "route": "cuda", "source": DET_SOURCE,
            "replaces": DET_REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": new["event_ms"],
            "device_ms": new["device_ms"], "graph_ms": new["graph_ms"],
            "host_us": new["host_us"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}
    return records, {"sass": sass, **timings}


# the timed shapes: the SSD lane's matcher (batch 32, bench.py's one object
# an image), the same at up to 32 labels an image (real detection data
# carries tens), the Gluon step's batch 4; NMS at the eval point (top 400)
# and over every anchor
DET_MATCH_TIMED = ((32, SSD_ANCHORS, 1), (32, SSD_ANCHORS, 32),
                   (4, SSD_ANCHORS, 1))
DET_NMS_TIMED = ((32, 400), (32, SSD_ANCHORS))
# the routes timed in turns: the cluster matcher and one-launch NMS (the
# route the ops take) and the first design (private ``_route="simple"``)
DET_ROUTES = {"new": None, "simple": "simple"}


def _det_bytes_flops(name, shape):
    """Bytes a call must move (inputs read once, outputs written once) and
    its flops: the matcher's (M, N) IoU and N encodings an image; NMS's
    k (k - 1) / 2 IoUs an image."""
    if name == "multibox_match":
        B, N, M = shape
        return (N * 16 + B * M * 20 + B * N * (4 + 4 + 16),
                B * (M * N * IOU_FLOPS + N * ENCODE_FLOPS))
    B, k = shape
    return B * k * (16 + 4 + 1 + 1), B * k * (k - 1) // 2 * IOU_FLOPS


def detection_timings(kd, routes=DET_ROUTES, rounds: int = 2):
    """Device, graph and event ms and host µs of each route of both B9
    kernels at the timed shapes (``DET_MATCH_TIMED``, ``DET_NMS_TIMED``),
    in turns over ``rounds`` rounds (``_in_turns``), beside the twin's
    event ms and the bound. ``routes`` maps a label to the wrapper's
    ``_route`` (None: the default route, passed as no argument).
    Returns {shape label: {"routes": {label: readings}, "plain_ms",
    "bound_ms", "bound_by"}}."""
    rs = np.random.RandomState(SEED + 21)

    def kw(route):
        return {} if route is None else {"_route": route}
    cases = [("multibox_match", s) for s in DET_MATCH_TIMED] + \
        [("nms_keep", s) for s in DET_NMS_TIMED]
    out = {}
    for name, shape in cases:
        if name == "multibox_match":
            anc, lab = _match_case(rs, *shape)
            calls = {label: (lambda r=r: kd.multibox_match(
                anc, lab, 0.5, DET_VAR, **kw(r)))
                for label, r in routes.items()}
            plain = time_ms(lambda: kd.multibox_match_reference(
                anc, lab, 0.5, DET_VAR), iters=3, warmup=1)
        else:
            boxes, ids, valid = _nms_case(rs, *shape)
            calls = {label: (lambda r=r: kd.nms_keep(
                boxes, ids, valid, 0.45, False, **kw(r)))
                for label, r in routes.items()}
            plain = time_ms(lambda: kd.nms_keep_reference(
                boxes, ids, valid, 0.45, False), iters=2, warmup=1)
        res = _in_turns(calls, getattr(kd, name), rounds)
        moved, flops = _det_bytes_flops(name, shape)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        label = f"{name} {shape}"
        out[label] = {"routes": res, "plain_ms": plain,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
        log(f"{label}: {_turns_line(res)}; plain {plain:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.5f} ms")
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- the SSD-512 lane
SSD_BATCH, SSD_SIZE, SSD_CLASSES, SSD_LR = 32, 512, 20, 0.004  # bench.py


def _ssd_batch(bs):
    """bench.py:283-292: RandomState(0) images, one object per image."""
    rs = np.random.RandomState(0)
    x_np = rs.rand(bs, 3, SSD_SIZE, SSD_SIZE).astype(np.float32)
    y_np = np.full((bs, 1, 5), -1.0, np.float32)
    for i in range(bs):
        x0, y0 = rs.rand(2) * 0.5
        w = 0.2 + rs.rand() * 0.3
        y_np[i, 0] = [rs.randint(SSD_CLASSES), x0, y0, x0 + w, y0 + w]
    return torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()


def _ssd_net(mx, x):
    """ssd_512_resnet50_v1(classes=20, layout="NCHW") on the card, default
    init from the seed, deferred shapes resolved by one forward; its
    trained and auxiliary values as {name: tensor}."""
    from incubator_mxnet_tpu_torch.models.ssd import ssd_512_resnet50_v1
    mx.random.seed(SEED)
    with mx.gpu(0):
        net = ssd_512_resnet50_v1(classes=SSD_CLASSES, layout="NCHW")
        net.initialize()
        net(mx.nd.array(x[:1].cpu().numpy()))
    ps = net.collect_params()
    params = {n: p.data()._data.detach().clone() for n, p in ps.items()
              if p.grad_req != "null"}
    aux = {n: p.data()._data.detach().clone() for n, p in ps.items()
           if p.grad_req == "null"}
    return net, params, aux


def _ssd_loss_and_grads(net, params, aux, x, y, dtype=None):
    """bench.py's loss (bench.py:323-340): functional_call in ``dtype``,
    the heads in float32, multibox_target (the B9 matcher, then mining),
    the multibox loss; gradients by torch.autograd.grad. Returns (loss,
    grads, (cls_f, box_f, anchors), targets)."""
    from incubator_mxnet_tpu_torch.models.ssd import multibox_loss
    from incubator_mxnet_tpu_torch.ops.detection import multibox_target
    from incubator_mxnet_tpu_torch.parallel.dp import functional_call

    def cast(v):
        return v.to(dtype) if dtype is not None and v.is_floating_point() \
            else v
    leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
    with torch.enable_grad():
        merged = {n: cast(v) for n, v in leaves.items()}
        merged.update({n: cast(v) for n, v in aux.items()})
        cls_p, box_p, anchors = functional_call(net, merged, cast(x),
                                                training=True)
        cls_f, box_f = cls_p.float(), box_p.float()
        targets = multibox_target(anchors.float(), y, cls_f.transpose(1, 2),
                                  negative_mining_ratio=3.0,
                                  negative_mining_thresh=0.5)
        bt, bm, ct = targets
        loss = multibox_loss(cls_f, box_f, ct, bt, bm).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    heads = (cls_f.detach(), box_f.detach(), anchors.detach())
    return loss.detach(), dict(zip(leaves, grads)), heads, targets


def ssd_train_phase(mx, kd, common, records, steps=5):
    """Phase 21: SSD-512 at bench.py's lane (ResNet-50 v1 NCHW, batch 32,
    512 x 512, bf16 compute on float32 masters, SGD momentum 0.9, lr 0.004,
    bench.py's synthetic batch), one update per call: bench.py's unroll 4
    is a lax.scan over updates. 2 warm-up and 5 timed steps: finite,
    falling loss, exactly one multibox_match launch per step, every one on
    the cluster route, and no other kernel of the port; a profiled window
    of two steps; then the eval point (multibox_detection at nms_topk 400
    on the step's heads: one nms_keep launch, on the cluster route) and
    the target assignment, each beside its twin; then one Gluon Trainer +
    record() step at batch 4 (one multibox_match, on the cluster route)."""
    from incubator_mxnet_tpu_torch.ops.detection import (multibox_detection,
                                                         multibox_target)
    from incubator_mxnet_tpu_torch.parallel.dp import _sgd_init, _sgd_update
    torch.cuda.reset_peak_memory_stats()
    x, y = _ssd_batch(SSD_BATCH)
    net, params, aux = _ssd_net(mx, x)
    opt = _sgd_init(params, 0.9)

    def step(params, opt):
        loss, grads, heads, _ = _ssd_loss_and_grads(net, params, aux, x, y,
                                                    torch.bfloat16)
        with torch.no_grad():
            params, opt = _sgd_update(params, grads, opt, SSD_LR, 0.0, 0.9)
        return params, opt, loss, heads

    losses = []
    for _ in range(2):
        params, opt, loss, _ = step(params, opt)
        losses.append(loss)
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss, heads = step(params, opt)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.launch_counts()
    cluster = common.sm90_launch_counts()["multibox_match"]
    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    img_s = SSD_BATCH * steps / wall
    log(f"SSD-512 train: losses {[round(v, 4) for v in losses]}; {steps} "
        f"timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} ms/step, "
        f"{img_s:.1f} img/s; peak {peak_gb:.2f} GB; launches {launches}, "
        f"{cluster} multibox_match on the cluster route")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"SSD loss not finite and falling: {losses}")
    others = {k: v for k, v in launches.items() if k != "multibox_match"}
    if launches["multibox_match"] != steps or cluster != steps \
            or any(others.values()):
        raise AssertionError(f"{steps} SSD steps launched {launches} "
                             f"({cluster} on the cluster route): want one "
                             "multibox_match a step, every one on the "
                             "cluster route, and nothing else")
    records["multibox_match"]["launches"] = launches["multibox_match"]
    breakdown = kernel_breakdown("SSD-512", lambda: step(params, opt),
                                 ("match_cluster_kernel",))
    # the eval point and the target assignment on the last step's heads
    cls_f, box_f, anchors = heads
    cls_t = cls_f.transpose(1, 2).contiguous()
    cls_prob = torch.softmax(cls_t, dim=1)
    common.reset_launch_counts()
    det = multibox_detection(cls_prob, box_f, anchors, nms_topk=400)
    torch.cuda.synchronize()
    ev = common.launch_counts()
    ev_cluster = common.sm90_launch_counts()["nms_keep"]
    log(f"SSD-512 detection: {tuple(det.shape)}, "
        f"{int((det[..., 0] >= 0).sum())} kept; launches {ev}, "
        f"{ev_cluster} nms_keep on the cluster route")
    if ev["nms_keep"] != 1 or ev_cluster != 1 or sum(ev.values()) != 1 \
            or not bool(torch.isfinite(det).all()):
        raise AssertionError(f"detection: launches {ev}, {ev_cluster} on "
                             "the cluster route")
    records["nms_keep"]["launches"] = ev["nms_keep"]

    def target():
        return multibox_target(anchors, y, cls_t, negative_mining_ratio=3.0,
                               negative_mining_thresh=0.5)

    def detect():
        return multibox_detection(cls_prob, box_f, anchors, nms_topk=400)

    phases = {"detect_target_ms": time_ms(target, iters=10, warmup=2),
              "detect_nms_ms": time_ms(detect, iters=10, warmup=2)}
    kernels = (kd.multibox_match, kd.nms_keep)
    kd.multibox_match = kd.multibox_match_reference
    kd.nms_keep = kd.nms_keep_reference
    try:
        phases["detect_target_ms_twin"] = time_ms(target, iters=3, warmup=1)
        phases["detect_nms_ms_twin"] = time_ms(detect, iters=3, warmup=1)
    finally:
        kd.multibox_match, kd.nms_keep = kernels
    log(f"SSD-512 head phases: {json.dumps(phases)}")
    rec = ssd_gluon_step(mx, common)
    return {"step_ms": wall / steps * 1e3, "img_s": img_s,
            "loss_first": losses[0], "loss_last": losses[-1],
            "peak_memory_gb": peak_gb, "launches_per_step": {
                "multibox_match": 1}, "cluster_launches": cluster,
            "detection_launches": ev, **phases,
            "gluon_step": rec, **breakdown}


def ssd_gluon_step(mx, common, batch=4):
    """One Trainer + autograd.record() step of the full-width SSD-512
    (float32) at batch 4 through net.targets and SSDMultiBoxLoss: one
    multibox_match launch, a finite loss."""
    from incubator_mxnet_tpu_torch.models.ssd import SSDMultiBoxLoss
    x, y = _ssd_batch(batch)
    net, _, _ = _ssd_net(mx, x)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": SSD_LR, "momentum": 0.9})
    xn = mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0))
    yn = mx.nd.array(y.cpu().numpy(), ctx=mx.gpu(0))
    common.reset_launch_counts()
    with mx.autograd.record():
        cls_preds, box_preds, anchors = net(xn)
        bt, bm, ct = net.targets(anchors, yn, cls_preds)
        loss = SSDMultiBoxLoss()(cls_preds, box_preds, ct, bt, bm).mean()
    loss.backward()
    trainer.step(batch)
    torch.cuda.synchronize()
    rec = common.launch_counts()
    cluster = common.sm90_launch_counts()["multibox_match"]
    value = float(loss.asscalar())
    log(f"SSD-512 Trainer + record() step at batch {batch}: loss "
        f"{value:.6f}; launches {rec}, {cluster} on the cluster route")
    if rec["multibox_match"] != 1 or cluster != 1 or sum(rec.values()) != 1 \
            or not np.isfinite(value):
        raise AssertionError(f"SSD record() step: launches {rec}, loss "
                             f"{value}")
    return {"loss": value, "launches": rec}


def ssd_truth_phase(mx, kd, common, batch=8):
    """Phase 22: at full width in float32, batch 8, with cuDNN
    deterministic: the targets (box_target, box_mask, cls_target) from the
    matcher kernel equal those from its twin on the card, exactly; the
    detections from the NMS kernel equal the twin's, exactly; and one
    step's loss and gradients with the kernels equal those with the twins
    (the targets being identical, the tolerance is 0)."""
    from incubator_mxnet_tpu_torch.ops.detection import multibox_detection
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, y = _ssd_batch(batch)
        net, params, aux = _ssd_net(mx, x)
        runs = {}
        kernels = (kd.multibox_match, kd.nms_keep)
        for route in ("kernels", "twins"):
            if route == "twins":
                kd.multibox_match = kd.multibox_match_reference
                kd.nms_keep = kd.nms_keep_reference
            try:
                common.reset_launch_counts()
                loss, grads, heads, targets = _ssd_loss_and_grads(
                    net, params, aux, x, y)
                cls_f, box_f, anchors = heads
                det = multibox_detection(
                    torch.softmax(cls_f, dim=-1).transpose(1, 2), box_f,
                    anchors, nms_topk=400)
                torch.cuda.synchronize()
                runs[route] = (loss, grads, targets, det,
                               common.launch_counts())
            finally:
                kd.multibox_match, kd.nms_keep = kernels
        (lk, gk, tk, dk, nk), (lt, gt, tt, dt, nt) = runs["kernels"], \
            runs["twins"]
        if nk["multibox_match"] != 1 or nk["nms_keep"] != 1 \
                or any(nt.values()):
            raise AssertionError(f"truth launches: kernels {nk}, twins {nt}")
        same_targets = [torch.equal(a, b) for a, b in zip(tk, tt)]
        same_det = torch.equal(dk, dt)
        loss_err = abs(lk.item() - lt.item())
        grad_err = max(_max_err(gk[n], gt[n]) for n in gt)
        kept = int((dk[..., 0] >= 0).sum())
        log(f"SSD-512 f32 batch {batch}, kernels vs twins: targets "
            f"(box_target, box_mask, cls_target) equal {same_targets}; "
            f"{int((tk[2] > 0).sum())} positives, "
            f"{int((tk[2] == 0).sum())} negatives; detections equal "
            f"{same_det} ({kept} kept); loss {lk.item():.6f} vs "
            f"{lt.item():.6f} (diff {loss_err}); worst gradient diff "
            f"{grad_err} over {len(gt)} leaves (tolerance 0)")
        if not all(same_targets) or not same_det or loss_err > 0 \
                or grad_err > 0:
            raise AssertionError("SSD kernels vs twins differ")
        hybrid = ssd_hybrid_detect(mx, common, x)
        return {"targets_equal": same_targets, "detections_equal": same_det,
                "loss": lk.item(), "loss_abs_diff": loss_err,
                "grad_max_abs_diff": grad_err, "positives":
                int((tk[2] > 0).sum()), "detections_kept": kept,
                "hybrid_detect": hybrid}
    finally:
        torch.backends.cudnn.deterministic = deterministic


def ssd_hybrid_detect(mx, common, x):
    """Phase 22, last: SSD-512 inference as a user calls it,
    ``net.detect(x)`` (float32, batch 8), first not hybridized, then after
    ``hybridize()``: the forward (backbone, heads, ``MultiBoxPrior``'s
    anchors) runs eagerly on the capture stream and is captured at its
    first call and replayed after, the decode and NMS eager behind it. The
    replayed heads against the eager ones (within 1e-5 of the largest
    entry, and whether equal bit for bit), the detections equal where the
    heads are equal bit for bit, one cache entry, one ``nms_keep`` launch
    a detect, and both detects' times (CUDA events over 5 calls)."""
    net, _, _ = _ssd_net(mx, x)
    xn = mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0))
    eager_heads = [t._data.clone() for t in net(xn)]
    eager_det = net.detect(xn)._data.clone()
    eager_ms = time_ms(lambda: net.detect(xn), iters=5, warmup=1)
    net.hybridize()
    t0 = time.perf_counter()
    net.detect(xn)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    common.reset_launch_counts()
    det = net.detect(xn)._data.clone()
    torch.cuda.synchronize()
    launches = {k: v for k, v in common.launch_counts().items() if v}
    heads = [t._data.clone() for t in net(xn)]
    hyb_ms = time_ms(lambda: net.detect(xn), iters=5, warmup=1)
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(heads, eager_heads)]
    bitwise = all(torch.equal(a, b) for a, b in zip(heads, eager_heads))
    res = {"eager_ms": eager_ms, "captured_ms": hyb_ms,
           "first_call_ms": first_ms, "heads_max_err": max(errs),
           "heads_bitwise": bitwise,
           "detections_equal": bool(torch.equal(det, eager_det)),
           "detections_kept": int((det[..., 0] >= 0).sum()),
           "entries": len(net._static.entries), "launches": launches}
    log(f"SSD-512 hybridized detect, batch {x.shape[0]}: {json.dumps(res)}")
    torch.cuda.empty_cache()
    if res["entries"] != 1 or max(errs) > 1e-5 \
            or launches.get("nms_keep") != 1 \
            or (bitwise and not res["detections_equal"]) \
            or not bool(torch.isfinite(det).all()):
        raise AssertionError(f"hybridized SSD detect: {res}")
    return res


# ------------------------------------------- the rtc user kernels (B10)
# B10 is a launcher, not a fixed kernel: the user's CUDA C++ is compiled
# with NVRTC (rtc.CudaModule) and launched on NDArrays. These three user
# kernels, each beside its plain PyTorch twin, are what phase 23 compiles,
# checks and times; the softmax pair is MXNet's custom_softmax_rtc.py op
# (forward and backward of a softmax output layer with its label), written
# one block a row so that it takes any row length.
RTC_KERNELS = ("rtc_launch/softmax_fwd", "rtc_launch/softmax_bwd")
RTC_REPLACES = "incubator_mxnet_tpu/rtc.py:63"
AXPY_SRC = r"""
__global__ void axpy(const float *x, const float *y, float *out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
"""
AXPY_SIGNATURE = "const float *x, const float *y, float *out, int n"
SOFTMAX_SRC = r"""
// max (kMax) or sum of one value over the block; blockDim.x is a multiple
// of 32, at most 1024; every thread gets the result
template <bool kMax>
__device__ float block_reduce(float v, float *red) {
    for (int o = 16; o > 0; o >>= 1) {
        const float u = __shfl_xor_sync(0xffffffffu, v, o);
        v = kMax ? fmaxf(v, u) : v + u;
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    v = lane < (blockDim.x >> 5) ? red[lane]
                                 : (kMax ? __int_as_float(0xff800000) : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
        const float u = __shfl_xor_sync(0xffffffffu, v, o);
        v = kMax ? fmaxf(v, u) : v + u;
    }
    __syncthreads();            // red is reused by the next reduction
    return v;
}

// y = softmax(x) row by row, one block a row: a max pass, a sum pass and
// a write pass; req 1 writes, 2 adds (MXNet's kWriteTo / kAddTo)
template <typename T>
__global__ void softmax_fwd(const T *x, T *y, const int row_size,
                            const int req) {
    __shared__ float red[32];
    const T *xr = x + (long long)blockIdx.x * row_size;
    T *yr = y + (long long)blockIdx.x * row_size;
    float m = __int_as_float(0xff800000);
    for (int i = threadIdx.x; i < row_size; i += blockDim.x)
        m = fmaxf(m, (float)xr[i]);
    m = block_reduce<true>(m, red);
    float s = 0.f;
    for (int i = threadIdx.x; i < row_size; i += blockDim.x)
        s += expf((float)xr[i] - m);
    s = block_reduce<false>(s, red);
    for (int i = threadIdx.x; i < row_size; i += blockDim.x) {
        const T p = (T)(expf((float)xr[i] - m) / s);
        if (req == 1) yr[i] = p;
        else if (req == 2) yr[i] += p;
    }
}

// the softmax output layer's gradient: dx = y - onehot(label), one block a
// row (label holds class indices as floats, as MXNet's labels do)
template <typename T>
__global__ void softmax_bwd(const T *label, const T *y, T *dx,
                            const int row_size, const int req) {
    const int z = (int)label[blockIdx.x];
    const T *yr = y + (long long)blockIdx.x * row_size;
    T *dr = dx + (long long)blockIdx.x * row_size;
    for (int i = threadIdx.x; i < row_size; i += blockDim.x) {
        const T v = i == z ? yr[i] - (T)1 : yr[i];
        if (req == 1) dr[i] = v;
        else if (req == 2) dr[i] += v;
    }
}
"""
SOFTMAX_EXPORTS = ("softmax_fwd<float>", "softmax_bwd<float>")
SOFTMAX_FWD_SIGNATURE = "const float *x, float *y, const int, const int"
SOFTMAX_BWD_SIGNATURE = ("const float *label, const float *y, float *dx, "
                         "const int, const int")
REQ_CODE = {"null": 0, "write": 1, "inplace": 1, "add": 2}
# reverses n floats through dynamic shared memory: a launch above 48 KB
# needs the opt-in that CudaKernel.launch makes
REVERSE_SRC = r"""
__global__ void reverse(const float *x, float *y, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
"""


def axpy_twin(x, y):
    """Plain twin of the axpy kernel: 2x + y."""
    return 2.0 * x + y


def softmax_fwd_twin(x):
    """Plain twin of softmax_fwd: max, exp, sum and divide per row."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def softmax_bwd_twin(label, y):
    """Plain twin of softmax_bwd: y - onehot(label)."""
    hot = torch.zeros_like(y)
    hot[torch.arange(y.shape[0], device=y.device), label.long()] = 1.0
    return y - hot


def row_block(row_size: int) -> int:
    """Threads per row for the softmax kernels: a multiple of 32, <= 512."""
    return min(512, 32 * -(-row_size // 32))


_SOFTMAX_RTC = {}   # the compiled softmax module and its two kernels


def rtc_softmax_kernels(mx):
    """The softmax user kernels, compiled on first use: (forward,
    backward, the CudaModule)."""
    if not _SOFTMAX_RTC:
        mod = mx.rtc.CudaModule(SOFTMAX_SRC, exports=SOFTMAX_EXPORTS)
        _SOFTMAX_RTC["kernels"] = (
            mod.get_kernel("softmax_fwd<float>", SOFTMAX_FWD_SIGNATURE),
            mod.get_kernel("softmax_bwd<float>", SOFTMAX_BWD_SIGNATURE), mod)
    return _SOFTMAX_RTC["kernels"]


def register_softmax_ops(mx):
    """MXNet's custom_softmax_rtc.py op, registered twice with
    ``mx.operator``: ``rtc_softmax`` launches the rtc kernels on arrays on
    the card and runs the twins on CPU arrays (as an MXNet op has a CPU and
    a GPU body); ``twin_softmax`` always runs the twins. Inputs: data
    (n, c) and label (n,) (class indices as floats); output: the row
    softmax; backward: prob - onehot(label), need_top_grad False (the op
    is the loss's head, as SoftmaxOutput is)."""

    class SoftmaxOp(mx.operator.CustomOp):
        def __init__(self, use_rtc):
            self.use_rtc = use_rtc

        def _rtc(self, x):
            return self.use_rtc and x.context.device_type == "gpu"

        def forward(self, is_train, req, in_data, out_data, aux):
            if req[0] == "null":
                return
            x, y = in_data[0], out_data[0]
            if self._rtc(x):
                fwd = rtc_softmax_kernels(mx)[0]
                fwd.launch([x, y, x.shape[1], REQ_CODE[req[0]]], x.context,
                           (x.shape[0],), (row_block(x.shape[1]),))
            else:
                self.assign(y, req[0], softmax_fwd_twin(x.tensor))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            if req[0] == "null":
                return
            label, y, dx = in_data[1], out_data[0], in_grad[0]
            if self._rtc(y):
                bwd = rtc_softmax_kernels(mx)[1]
                bwd.launch([label, y, dx, y.shape[1], REQ_CODE[req[0]]],
                           y.context, (y.shape[0],), (row_block(y.shape[1]),))
            else:
                self.assign(dx, req[0],
                            softmax_bwd_twin(label.tensor, y.tensor))

    def prop(use_rtc):
        class SoftmaxProp(mx.operator.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def infer_shape(self, in_shape):
                return ([in_shape[0], [in_shape[0][0]]], [in_shape[0]], [])

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return SoftmaxOp(use_rtc)
        return SoftmaxProp

    mx.operator.register("rtc_softmax")(prop(True))
    mx.operator.register("twin_softmax")(prop(False))


# examples/train_mnist.py's MLP and configuration (784-128-64-10, batch 64,
# SGD lr 0.1 momentum 0.9), on data from a seeded generator
MLP_BATCH, MLP_LR, MLP_MOMENTUM, MLP_STEPS = 64, 0.1, 0.9, 20


def mnist_batches(seed, steps, batch=MLP_BATCH):
    """MNIST-shaped batches: ten random 784-pixel class templates plus
    noise, in [0, 1], and their labels as float32 class indices."""
    rng = np.random.default_rng(seed)
    templates = rng.random((10, 784))
    out = []
    for _ in range(steps):
        label = rng.integers(0, 10, batch)
        x = 0.7 * templates[label] + 0.3 * rng.random((batch, 784))
        out.append((x.astype(np.float32), label.astype(np.float32)))
    return out


def mnist_mlp(mx):
    """examples/train_mnist.py's MLP in Gluon (the softmax is the custom
    op, applied by :func:`mlp_train`)."""
    nn = mx.gluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(128, in_units=784, activation="relu"),
            nn.Dense(64, in_units=128, activation="relu"),
            nn.Dense(10, in_units=64))
    return net


def mlp_train(mx, net, op_type, batches, ctx, after_step=None):
    """SGD steps of ``net`` through ``gluon.Trainer`` with the custom
    softmax op ``op_type`` as its head: (losses, the first step's
    gradients). The loss (mean cross-entropy) is read from the op's
    output."""
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": MLP_LR,
                                "momentum": MLP_MOMENTUM})
    losses, first_grads = [], None
    for i, (xb, lb) in enumerate(batches):
        x, label = mx.nd.array(xb, ctx=ctx), mx.nd.array(lb, ctx=ctx)
        with mx.autograd.record():
            prob = mx.nd.Custom(net(x), label, op_type=op_type)
        prob.backward()
        if first_grads is None:
            first_grads = [p.grad().asnumpy()
                           for p in net.collect_params().values()]
        trainer.step(xb.shape[0])
        p = prob.asnumpy().astype(np.float64)
        losses.append(float(-np.log(p[np.arange(len(lb)),
                                      lb.astype(int)]).mean()))
        if after_step is not None:
            after_step(i)
    return losses, first_grads


def rtc_kernel_checks(mx):
    """Phase 23, first part: the user kernels compiled with NVRTC (the
    compile time of each module), the axpy at n 2^26 through launch and
    the call form (exact against 2x + y), the softmax forward and backward
    at the MLP's (64, 10) and at the word LM's decoder (4480, 33278)
    against their twins (forward within 1e-6, backward exact), with times
    beside the twins', one library call's and the byte bound; then the
    host cost of one launch beside a PyTorch elementwise op's dispatch,
    and the error paths (:func:`rtc_error_checks`)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def nd(t):
        return mx.nd.NDArray(t, _direct=True)

    from incubator_mxnet_tpu_torch.ops.cuda import nvrtc
    axpy_mod = mx.rtc.CudaModule(AXPY_SRC, exports=["axpy"])
    major, minor, path = nvrtc.nvrtc_version()
    log(f"NVRTC {major}.{minor} ({path}), driver CUDA "
        f"{nvrtc.driver_version()}")
    axpy = axpy_mod.get_kernel("axpy", AXPY_SIGNATURE)
    fwd, bwd, sm_mod = rtc_softmax_kernels(mx)
    compile_ms = {"axpy": axpy_mod.compile_ms,
                  "softmax": sm_mod.compile_ms}
    log(f"NVRTC compile ms per module: {json.dumps(compile_ms)}")
    n = 1 << 26
    x = nd(torch.randn(n, device=dev, generator=g))
    y = nd(torch.randn(n, device=dev, generator=g))
    out = nd(torch.empty(n, device=dev))
    grid = ((n + 255) // 256,)
    axpy.launch([x, y, out, n], mx.gpu(0), grid, (256,))
    call = axpy_mod.get_kernel("axpy", AXPY_SIGNATURE, out_like=0,
                               grid_dims=lambda a, b, m: ((m + 255) // 256,),
                               block_dims=(256,))
    z = call(x, y, n)
    torch.cuda.synchronize()
    want = axpy_twin(x.tensor, y.tensor)
    axpy_err = max(float((out.tensor - want).abs().max()),
                   float((z.tensor - want).abs().max()))
    if axpy_err != 0.0:
        raise AssertionError(f"axpy differs from 2x + y by {axpy_err}")
    timings = {"axpy": {
        "n": n, "max_abs_err": axpy_err,
        "ms": time_ms(lambda: axpy.launch([x, y, out, n], mx.gpu(0), grid,
                                          (256,))),
        "plain_ms": time_ms(lambda: axpy_twin(x.tensor, y.tensor)),
        "library_ms": time_ms(lambda: torch.add(y.tensor, x.tensor,
                                                alpha=2)),
        "bound_ms": 3 * 4 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}}
    del x, y, out, z, want
    errs = {}
    for rows, cols in ((MLP_BATCH, 10), (4480, 33278)):
        xs = nd(3.0 * torch.randn(rows, cols, device=dev, generator=g))
        lab = nd(torch.randint(0, cols, (rows,), device=dev,
                               generator=g).float())
        ys, dx = nd(torch.empty_like(xs.tensor)), nd(torch.empty_like(
            xs.tensor))
        blk = (row_block(cols),)

        def run_fwd():
            fwd.launch([xs, ys, cols, 1], mx.gpu(0), (rows,), blk)

        def run_bwd():
            bwd.launch([lab, ys, dx, cols, 1], mx.gpu(0), (rows,), blk)

        run_fwd()
        run_bwd()
        torch.cuda.synchronize()
        ef = float((ys.tensor - softmax_fwd_twin(xs.tensor)).abs().max())
        eb = float((dx.tensor - softmax_bwd_twin(lab.tensor, ys.tensor))
                   .abs().max())
        errs[f"{rows}x{cols}"] = {"fwd": ef, "bwd": eb}
        if not ef <= 1e-6 or eb != 0.0:
            raise AssertionError(f"rtc softmax at ({rows}, {cols}): forward "
                                 f"err {ef} (tol 1e-6), backward {eb} (0)")
    moved = 2 * 4 * rows * cols
    idx = lab.tensor.long()[:, None]
    minus = torch.full((rows, 1), -1.0, device=dev)
    timings["softmax_fwd"] = {
        "shape": [rows, cols], "max_abs_err": ef, "ms": time_ms(run_fwd),
        "plain_ms": time_ms(lambda: softmax_fwd_twin(xs.tensor), iters=10),
        "library_ms": time_ms(lambda: torch.softmax(xs.tensor, 1)),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    timings["softmax_bwd"] = {
        "shape": [rows, cols], "max_abs_err": eb, "ms": time_ms(run_bwd),
        "plain_ms": time_ms(lambda: softmax_bwd_twin(lab.tensor, ys.tensor),
                            iters=10),
        "library_ms": time_ms(lambda: torch.scatter_add(ys.tensor, 1, idx,
                                                        minus)),
        "bound_ms": (moved + 4 * rows) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    log(f"rtc softmax errors {json.dumps(errs)}")
    records = {}
    for name in RTC_KERNELS:
        t = timings[name.split("/")[1]]
        records[name] = {"name": name, "route": "cuda",
                         "source": "chip_smoke.py", "replaces": RTC_REPLACES,
                         "launches": 0, **{k: t[k] for k in (
                             "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}}
    del xs, ys, dx, lab
    torch.cuda.empty_cache()
    # host cost of one launch (enqueue only) beside torch.add's dispatch
    a = nd(torch.randn(1024, device=dev))
    o = nd(torch.empty(1024, device=dev))

    def host_us(fn, iters=2000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        return us

    timings["launch_host_us"] = host_us(
        lambda: axpy.launch([a, a, o, 1024], mx.gpu(0), (4,), (256,)))
    timings["torch_add_host_us"] = host_us(
        lambda: torch.add(a.tensor, a.tensor))
    timings["compile_ms"] = compile_ms
    timings["errors"] = rtc_error_checks(mx, a, o)
    for name, t in timings.items():
        if isinstance(t, dict) and "ms" in t:
            log(f"time {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                f"ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms (bytes)")
    log(f"launch host cost {timings['launch_host_us']:.2f} us, torch.add "
        f"{timings['torch_add_host_us']:.2f} us")
    return records, timings


def rtc_error_checks(mx, a, o):
    """A launch with 100 KB of dynamic shared memory works (against
    torch.flip); a refused launch (2048 threads a block), a compile error
    and a written array that is not contiguous each raise, the first two
    with the driver's and NVRTC's own words."""
    from incubator_mxnet_tpu_torch.ops.cuda import nvrtc
    mod = mx.rtc.CudaModule(REVERSE_SRC, exports=["reverse"])
    rev = mod.get_kernel("reverse", "const float *x, float *y, int n")
    n = 100 * 1024 // 4
    x = mx.nd.NDArray(torch.randn(n, device="cuda"), _direct=True)
    y = mx.nd.NDArray(torch.empty(n, device="cuda"), _direct=True)
    rev.launch([x, y, n], mx.gpu(0), (1,), (256,), shared_mem=4 * n)
    torch.cuda.synchronize()
    if not torch.equal(y.tensor, torch.flip(x.tensor, (0,))):
        raise AssertionError("reverse through 100 KB of shared memory")
    out = {"shared_100kb": "ok"}
    try:
        rev.launch([x, y, n], mx.gpu(0), (1,), (2048,), shared_mem=4 * n)
        raise AssertionError("a 2048-thread block launched")
    except nvrtc.CudaDriverError as e:
        out["refused_launch"] = str(e)
    try:
        mx.rtc.CudaModule("__global__ void bad(float *x) { x[0] = nope; }",
                          exports=["bad"])
        raise AssertionError("a source with an error compiled")
    except nvrtc.NvrtcCompileError as e:
        if "nope" not in str(e):
            raise AssertionError(f"compile error without NVRTC's log: {e}")
        out["compile_error"] = next(line.strip() for line in str(
            e).splitlines() if "error:" in line)
    strided = mx.nd.NDArray(torch.empty(2 * n, device="cuda")[::2],
                            _direct=True)
    try:
        rev.launch([x, strided, n], mx.gpu(0), (1,), (256,), 4 * n)
        raise AssertionError("a strided output was launched on")
    except ValueError as e:
        out["strided_output"] = str(e)
    torch.cuda.synchronize()
    log(f"rtc error paths: {json.dumps(out)}")
    return out


def mlp_phase(mx, common, records):
    """Phase 23, second part: examples/train_mnist.py's MLP for 20 steps
    with the rtc custom softmax: finite, falling loss; exactly one forward
    and one backward rtc launch a step and no other kernel of the port;
    then the same 20 steps from the same weights with the twin-bodied op:
    the first step's loss and gradients within rtol 1e-5, the weights
    after 20 steps within rtol 1e-4; a profiled window of two steps; and
    test_utils.check_consistency of the op across cpu and gpu(0)."""
    register_softmax_ops(mx)
    fwd, bwd, _ = rtc_softmax_kernels(mx)
    ctx = mx.gpu(0)
    batches = mnist_batches(SEED, MLP_STEPS)
    mx.random.seed(SEED)
    net = mnist_mlp(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    twin = mnist_mlp(mx)
    twin.initialize(ctx=ctx)
    mx.test_utils.copy_params(net, twin)
    per_step, stamps = [], []

    def count(i):       # mlp_train has synchronised: it read the loss
        stamps.append(time.perf_counter())
        per_step.append((fwd.launches, bwd.launches))
        fwd.launches = bwd.launches = 0

    fwd.launches = bwd.launches = 0
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    losses, grads = mlp_train(mx, net, "rtc_softmax", batches, ctx, count)
    launches = common.launch_counts()
    # the first step pays cuBLAS's and the allocator's warm-up
    first_ms = (stamps[0] - t0) * 1e3
    step_ms = (stamps[-1] - stamps[0]) / (MLP_STEPS - 1) * 1e3
    log(f"MLP (rtc softmax): losses {[round(v, 4) for v in losses]}; first "
        f"step {first_ms:.2f} ms, then {step_ms:.3f} ms/step over "
        f"{MLP_STEPS - 1} steps; launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MLP loss not finite and falling: {losses}")
    others = {k: v for k, v in launches.items() if k != "rtc_launch"}
    if any(c != (1, 1) for c in per_step) or len(per_step) != MLP_STEPS \
            or launches["rtc_launch"] != 2 * MLP_STEPS or any(
                others.values()):
        raise AssertionError(f"MLP launches per step {per_step}, counts "
                             f"{launches}: want one forward and one backward "
                             "rtc launch a step and nothing else")
    for name in RTC_KERNELS:
        records[name]["launches"] = MLP_STEPS
    t_losses, t_grads = mlp_train(mx, twin, "twin_softmax", batches, ctx)
    loss_err = abs(losses[0] - t_losses[0]) / abs(t_losses[0])
    grad_err = max(float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)),
                                                     1e-30))
                   for a, b in zip(grads, t_grads))
    w_err = max(float(np.max(np.abs(a.data().asnumpy() - b.data().asnumpy()))
                      / max(np.max(np.abs(b.data().asnumpy())), 1e-30))
                for a, b in zip(net.collect_params().values(),
                                twin.collect_params().values()))
    loss20_err = abs(losses[-1] - t_losses[-1]) / abs(t_losses[-1])
    log(f"MLP rtc vs twin: first loss rel {loss_err:.3e}, first gradients "
        f"rel {grad_err:.3e}, weights after {MLP_STEPS} steps rel "
        f"{w_err:.3e}, last loss rel {loss20_err:.3e}")
    for i, (a, b) in enumerate(zip(grads, t_grads)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=f"first-step gradient {i}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"first-step loss rel err {loss_err} > 1e-5")
    for a, b in zip(net.collect_params().values(),
                    twin.collect_params().values()):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=a.name)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": MLP_LR,
                                "momentum": MLP_MOMENTUM})
    xb, lb = (mx.nd.array(v, ctx=ctx) for v in batches[0])

    def step():
        with mx.autograd.record():
            prob = mx.nd.Custom(net(xb), lb, op_type="rtc_softmax")
        prob.backward()
        trainer.step(MLP_BATCH)

    breakdown = kernel_breakdown("MLP", step, ("softmax_fwd",
                                               "softmax_bwd"))
    consistency = mx.test_utils.check_consistency(
        lambda d, l: mx.nd.Custom(d, l, op_type="rtc_softmax"),
        ctx_list=[mx.cpu(), mx.gpu(0)],
        inputs=[batches[0][0][:, :10] * 5, batches[0][1]],
        dtypes=[np.float32])
    cons = {str(k): float(np.max(np.abs(v - consistency[
        ("cpu(0)", "float32")]))) for k, v in consistency.items()}
    log(f"check_consistency rtc_softmax across cpu and gpu(0): {cons}")
    return {"step_ms": step_ms, "first_step_ms": first_ms,
            "loss_first": losses[0],
            "loss_last": losses[-1], "launches_per_step": {
                "rtc_softmax_fwd": 1, "rtc_softmax_bwd": 1},
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err,
            "weights_rel_err": w_err, "consistency_max_abs": cons,
            **breakdown}


def _memory_held() -> None:
    """What the caching allocator holds after a phase and
    ``empty_cache()``: memory that the next phases cannot use."""
    log(f"memory held: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


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
    from incubator_mxnet_tpu_torch.ops.cuda import lstm as lt
    from incubator_mxnet_tpu_torch.ops.cuda import detection as kd
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

    records, decode_timing = kernel_checks(fa, common)
    serve = serving_phase(serving, tt, fa, common, records)
    f32_step_phase(tt, fa)
    train_records, timings = train_kernel_checks(fa, common)
    records.update(train_records)
    torch.cuda.empty_cache()
    _memory_held()
    train = train_phase(tt, fa, records)
    torch.cuda.empty_cache()
    _memory_held()
    headmajor_phase(tt, fa)
    torch.cuda.empty_cache()
    _memory_held()
    f32_train = f32_train_step_phase(tt, fa)
    torch.cuda.empty_cache()
    _memory_held()
    row_records, row_timings = row_kernel_checks(ln, sm, common)
    records.update(row_records)
    torch.cuda.empty_cache()
    _memory_held()
    nd_train = nd_train_phase(tt, nd_lm, mx, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    nd_truth = nd_truth_phase(tt, nd_lm, mx)
    torch.cuda.empty_cache()
    _memory_held()
    conv_records, conv_timings = conv_kernel_checks(cf, common)
    records.update(conv_records)
    torch.cuda.empty_cache()
    _memory_held()
    resnet = resnet_train_phase(mx, gluon, vision, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    perblock = resnet_perblock_phase(mx, gluon, vision, common)
    torch.cuda.empty_cache()
    _memory_held()
    perblock["hybridized_forward"] = resnet_hybrid_forward(mx, vision,
                                                           common)
    torch.cuda.empty_cache()
    _memory_held()
    resnet_truth = resnet_truth_phase(mx, gluon, vision, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    lstm_records, lstm_timings = lstm_kernel_checks(lt, common)
    records.update(lstm_records)
    torch.cuda.empty_cache()
    _memory_held()
    word_lm = word_lm_train_phase(mx, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    agreement = agreement_check(resnet, resnet_truth, word_lm)
    word_lm_truth = word_lm_truth_phase(mx, lt, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    det_records, det_timings = detection_kernel_checks(kd, common)
    records.update(det_records)
    torch.cuda.empty_cache()
    _memory_held()
    ssd = ssd_train_phase(mx, kd, common, records)
    torch.cuda.empty_cache()
    _memory_held()
    ssd_truth = ssd_truth_phase(mx, kd, common)
    torch.cuda.empty_cache()
    _memory_held()
    rtc_records, rtc_timings = rtc_kernel_checks(mx)
    records.update(rtc_records)
    mlp = mlp_phase(mx, common, records)

    log(f"decode kernel timings {json.dumps(decode_timing)}")
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
    log(f"LSTM kernel timings {json.dumps(lstm_timings)}")
    log(f"word LM training {json.dumps(word_lm)}")
    log(f"captured against eager, remat against none "
        f"{json.dumps(agreement)}")
    log(f"word LM f32 truth {json.dumps(word_lm_truth)}")
    log(f"detection kernel timings {json.dumps(det_timings)}")
    log(f"SSD-512 training {json.dumps(ssd)}")
    log(f"SSD-512 f32 truth {json.dumps(ssd_truth)}")
    log(f"rtc kernel timings {json.dumps(rtc_timings)}")
    log(f"MNIST MLP with the rtc custom softmax {json.dumps(mlp)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[n] for n in (
        "flash_decode_step", "flash_decode_step_paged") + TRAIN_RECORDS
        + ROW_KERNELS + CONV_RECORDS + LSTM_RECORDS + DET_KERNELS
        + RTC_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
