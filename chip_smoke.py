"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card and holds every CUDA kernel
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
  ``test_utils.check_consistency`` of that op;
* batch serving through ``InferenceEngine.load_model(net=...)``: one engine
  serving ``resnet50_v1(layout="NHWC")`` (float32, buckets 1..32) and
  SSD-512's ``detect`` (float32, buckets 1..8), one captured CUDA graph a
  padding bucket, under closed-loop clients, a hot swap, the
  self-healing ladder and the hung-request watchdog;
* int8 inference and the HTTP front end: ``resnet50_v1(layout="NCHW")``
  and the reference's serve-bench MLP served through
  ``load_model(quantize=...)`` (BN folded, naive calibration), their int8
  products on the ``qconv_s8`` / ``qgemm_s8`` kernels, beside float32
  twins, and ``tools/serve.py``'s HTTP routes over the same engine;
* the image input path feeding the ResNet-50 step: bench.py's record file
  (1,024 random 256 x 256 JPEGs) read by ``io.ImageRecordIter`` on the
  native pipeline that ``_native`` builds from ``native/`` (without that
  library, raw-pixel records through a ``gluon.data.DataLoader`` of
  process workers), copied ahead by ``io.DevicePrefetcher``, cropped and
  mirrored on the card by ``image.random_crop_flip``, into phase 14's
  captured step; and the Gluon route (``ImageRecordDataset``, the vision
  transforms, ``DataLoader`` process workers) into the same step.
* the rest of vision and input: ``image.ImageDetIter`` and its
  augmenters feeding the SSD-512 step; ``input_service.InputService``
  (supervised workers, exactly-once replay, the quarantine file) feeding
  the ResNet-50 step; AlexNet, DenseNet, SqueezeNet, Inception V3 and the
  MobileNets served as bucket graphs; and the word LM fed by
  ``WikiText2`` through ``rnn.BucketSentenceIter``, one graph a bucket.
* the sparse recommender path: ``parallel.embedding
  .make_sharded_train_step`` training DLRM at ``bench.py``'s 100M-row lane
  (one card, then 8 gloo ranks on the card) and the sharded FM at
  ``BASELINE.json``'s config #5, every table update one
  ``row_sparse_update`` launch and every tower update one
  ``multi_tensor_update``; the table checkpointed through
  ``fault.CheckpointManager`` and restored; ``Trainer(kvstore="dist_sync")``
  and a ``dist_async`` round across the ranks.

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

24. batch serving (:func:`batch_serving_phase`): the engine above with
   its two endpoints, each bucket one CUDA graph captured at load.
25. int8 serving and HTTP (:func:`int8_serving_phase`): the int8
   kernels as built (``quant_sass_check``: IGMMA in every Hopper-route
   instantiation, IMMA in the first design's, no local bytes); both
   routes (the TMA + s8 ``wgmma`` route the plan gives, the first design
   behind ``_route="simple"``) against the twins bit for bit in every
   epilogue, x channels-last and NCHW, at every conv shape of the
   converted ResNet-50 at bucket 32, the tails and the GEMMs; each conv
   shape's event and graph ms on both routes; the forward's 53 convs as
   one call at buckets 32 and 1, and the head's GEMM at both, each route
   in turns (device, graph, event ms, host µs) beside the bounds, the
   twins and ``torch._int_mm`` (the GEMM, and the 1x1 stride-1 convs on
   their channels-last codes); the int8 ResNet-50 and MLP served
   (``len(buckets)`` captures, replays equal to eager, one ``qconv_s8`` a
   quantized conv and one ``qgemm_s8`` a quantized dense a served batch,
   every conv on the Hopper route but the stem (C 3), a row alone equal
   to its row in a full bucket, the quant-smoke gates, 64 clients x 10
   beside the float32 ResNet-50); then the HTTP front end on
   ``127.0.0.1:0`` over the same engine (``:predict`` npy and JSON,
   ``/readyz``, ``/metrics``, ``:reload``, a ``:generate`` stream, a 429
   shed).
26. the record input path (:func:`input_path_phase`): the native build
   (or why it failed), bench.py's record file, the host batches against
   ``image.imdecode`` bit for bit, then the lane (the host source,
   ``DevicePrefetcher(depth=2)``, ``random_crop_flip``, the captured
   ResNet-50 step at batch 128, bf16): 2 warm-up and 20 timed steps,
   img/s beside phase 14's, the consumer's input wait and the card's busy
   share, the source's img/s alone, a batch's copy ms, 29/13/23/13/3
   fused-conv launches a step on the sm90 route; the first 8 prefetched
   batches against a fresh host source bit for bit, a step on a
   prefetched batch against one on the uploaded host batch bit for bit,
   ``random_crop_flip`` captured against eager; then the Gluon route at
   batch 32 (process workers that must report no CUDA).
27. the detection input path (:func:`detection_input_phase`): 512
   VOC-like JPEG records, ``ImageDetIter`` with ``CreateDetAugmenter``
   (random crop, pad, mirror, ImageNet mean and std),
   ``DevicePrefetcher``, phase 21's SSD-512 step: img/s beside phase
   21's, the iterator's img/s alone, the input-wait and busy shares, one
   cluster-route ``multibox_match`` a step and nothing else, label boxes
   in [0, 1] and -1 padding, the first 4 batches on the card against a
   fresh iterator's bit for bit, one cluster-route ``nms_keep`` at the
   eval point, the fed step's time split;
28. the input service (:func:`input_service_phase`): ``InputService``
   (8 workers) over phase 26's raw records into phase 14's captured step:
   img/s beside phases 26 and 14, ``starvation_share()``, 29/13/23/13/3
   sm90 launches a step, the first epoch's batches against the inline
   service's (sha256), no worker initialising CUDA; a scripted
   ``io.worker_kill``: the same stream and one restart; a corrupt record:
   its exact uri and offset quarantined, the skip counter moved by 1; no
   ``mxtpu*`` segment left in ``/dev/shm``;
29. the zoo families served (:func:`zoo_serving_phase`): AlexNet,
   DenseNet-121, SqueezeNet 1.1, Inception V3 (299), MobileNet 1.0 and
   MobileNet v2 1.0 at full width, float32, buckets (1, 8, 32): 3
   captures at load and none from traffic, each bucket's replay against
   eager bit for bit, padding never reaching real rows, each bucket's
   graph and eager ms in turns, 64 closed-loop clients for MobileNet v2
   and Inception;
30. the bucketed word LM (:func:`bucketed_lm_phase`): phase 18's model
   fed by ``WikiText2``'s synthetic corpus through ``encode_sentences``
   and ``BucketSentenceIter(buckets=[10, 20, 35])``: 3 captures, 4 T
   tensor-core LSTM launches a step at each bucket, tok/s a bucket, and
   a captured T 35 step against the eager one bit for bit (dropout 0).
32. the mesh (``tools/chip_mesh.py``, :func:`mesh_phase`): the five
   paths of the reference's multi-device dry run as a gloo world of 8
   rank processes on the card (NCCL refuses two ranks on one card; the
   collectives stage through pinned host memory): the full-width LM over
   (data 2, tensor 2, seq 2) on ring attention over the flash kernels,
   3 steps, step 1 against the single-device step, each rank's flash
   launches 12 * (seq rank + 1) a step; Ulysses, FSDP + expert-parallel
   MoE, ResNet-50 over (data 4, fsdp 2) and gpipe at the dry run's
   sizes; and a 1-rank NCCL world running the LM at depth 2 on the
   trivial mesh. The flash rows of the kernels line carry the mesh
   launches (``mesh_launches``).
33. the sparse recommender path (``tools/chip_embed.py``,
   :func:`embed_phase`): DLRM at 100M rows (dim 8, 26 ids, batch 4,096,
   SGD) on the card, 1 warm-up and 5 timed steps counted from zero (one
   ``row_sparse_update`` and one ``multi_tensor_update`` (the tower) a
   step on the kernel routes, no densify, one sort a step; step ms,
   samples/s, dedup ratio, a profiled window), the
   kernel against its twin bit for bit on a step's own rows with its times
   and bound, the step at 1M rows on the card against the CPU; the sharded
   FM (1M features, factor 16, 39 active, batch 8,192, Adam): two row
   launches and one tower launch a step, the kernel against its twin;
   then 8 gloo ranks on the card (3 steps of the 100M-row DLRM against
   one card's, one launch of each kernel a rank a step, the collectives'
   share), the table checkpointed by every rank and restored on the card
   bit for bit, a ``dist_sync`` Trainer step and a ``dist_async`` round.
   The ``row_sparse_update`` and ``multi_tensor_update`` records of the
   kernels line carry this path's launches (``launches_by_phase``), the
   row kernel's its times at DLRM's and FM's shapes beside phase 31's.

After every phase, ``_memory_held`` drops cuBLAS's workspaces, empties the
caching allocator's cache and logs allocated and reserved bytes; where
reserved exceeds allocated by more than 2 GB it names the pools and the
segments that hold the difference.

Any failure raises, so the exit code is not 0. The last three lines of
standard output are the kernels' JSON record, the card line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import re
import subprocess
import sys
import threading
import time
import weakref

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


def _device_events(window, tries: int = 3, calls=None, widened: int = 0):
    """Run ``window()`` under torch.profiler until the tracer delivers
    device events, up to ``tries`` windows (on the card a window has come
    back without any, and once three in a row). Each profiled window runs
    behind warm-up windows of its own (the profiler's schedule: CUPTI's
    tracer starts with the warm-up, whose records are dropped), one on the
    first try and one more on each retry, so a retry widens the traced
    span (``widened`` more warm-up windows from the start: a caller's own
    retry); the active window ends with a synchronize, so every kernel it
    launched has completed before the profiler stops and flushes CUPTI's
    buffers. Returns (the active window's CUDA kernel events, or None if
    no window had any; ``window()``'s value from the last active window).
    ``calls``, a dict, receives the active window's counts of kernel
    launch calls and graph replays on the CPU side."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from torch.autograd import DeviceType
    for attempt in range(tries):
        warm = widened + attempt + 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warm, active=1,
                                       repeat=1)) as prof:
            for _ in range(warm):
                window()
                torch.cuda.synchronize()
                prof.step()
            value = window()
            torch.cuda.synchronize()
            prof.step()
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
            f" of {tries}, behind {warm} warm-up windows)")
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
               "attention_kernel_ms": None, "top_device_ops": None}
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
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    out = {"step_wall_ms": wall_ms, "profiled_step_wall_ms": prof_wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "profiled_window_idle_share": 1 - busy_ms / prof_wall_ms,
           "attention_kernel_ms": attn_ms,
           "top_device_ops": [[e.key[:60],
                               e.self_device_time_total / steps / 1e3]
                              for e in top]}
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
           "library_graph_ms_source": lib["graph_ms_source"],
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
    that delivered events, for a kernel wrapper's call or ``with_graph``),
    each retry widened (``calls`` more calls in it, one more warm-up
    window before it); after that the time is not measured: (None, {}). ``with_graph`` adds
    the graph time to the result."""
    fn()
    torch.cuda.synchronize()

    name = "the library call" if wrapper is None else wrapper.__name__

    span = [calls]

    def window():
        before = 0 if wrapper is None else wrapper.launches
        for _ in range(span[0]):
            fn()
        torch.cuda.synchronize()
        return 1 if wrapper is None else (wrapper.launches - before) / span[0]
    graph, timed = None, False
    result = None, {}
    for attempt in range(tries):
        # each retry widens the window: more warm-up windows before it,
        # and more calls in it
        span[0] = calls * (attempt + 1)
        dev, per_call = _device_events(window, 1, widened=attempt)
        if dev is None:
            continue
        if per_call < 1 or per_call != int(per_call):
            raise AssertionError(f"device_ms: {name} launched {per_call} "
                                 "times a call")
        per, lost = {}, {}
        for e in dev:
            key = e.key.replace("void (anonymous namespace)::", "")[:40]
            runs = max(per_call, e.count / span[0])
            per[key] = per.get(key, 0.0) + (
                e.self_device_time_total / e.count * runs / 1e3)
            if e.count < runs * span[0]:
                lost[key] = f"{e.count} of {round(runs * span[0])}"
        if lost:
            log(f"device_ms: the window kept {lost} records of {name}'s "
                f"{span[0]} calls; each kernel's mean duration stands for "
                "its lost ones")
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
    the process). A call whose capture failed is not tried again: None
    (its graph and memory pool are dropped, ``cuda_graph.capture``)."""
    from incubator_mxnet_tpu_torch.cuda_graph import (CapturedStep, capture,
                                                      capture_stream)
    if fn in _UNCAPTURABLE:
        return None
    side = capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def body():
        for _ in range(replays):
            fn()
    step = CapturedStep(body)
    try:
        capture(step, side)
    except Exception as err:            # noqa: BLE001 (an autograd call)
        log(f"graph_ms: the call could not be captured: {err}")
        _UNCAPTURABLE.add(fn)
        return None
    ms = time_ms(step.graph.replay, iters=5, warmup=1) / replays
    step.graph.reset()
    return ms


#: calls whose capture failed in :func:`graph_ms`
_UNCAPTURABLE = weakref.WeakSet()


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
    round) and averaged. A call that cannot be captured into a graph
    (:func:`graph_ms` None) has its graph cell read with CUDA events
    instead, and ``graph_ms_source`` "event_ms" says so ("graph"
    otherwise). Returns {label: {key: mean, key + "_rounds": readings,
    "kernels": the last device split, "graph_ms_source": ...}}."""
    keys = ("device_ms", "graph_ms", "event_ms", "host_us")
    reads = {label: {k: [] for k in keys} for label in calls}
    kernels, sources = {}, {}
    labels = list(calls)
    for i in range(rounds):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            fn = calls[label]
            dev, kernels[label], graph = device_ms(
                fn, wrapper[label] if isinstance(wrapper, dict) else wrapper,
                with_graph=True)
            got = reads[label]
            got["device_ms"].append(dev)
            event = time_ms(fn)
            if graph is None:
                # a call that cannot be captured (SDPA's backward: cuDNN)
                # is timed with CUDA events in its graph cell, and marked
                graph = event
                sources[label] = "event_ms"
            got["graph_ms"].append(graph)
            got["event_ms"].append(event)
            got["host_us"].append(host_us(fn))
    out = {}
    for label, got in reads.items():
        rec = {"kernels": kernels[label],
               "graph_ms_source": sources.get(label, "graph")}
        for k, vals in got.items():
            seen = [v for v in vals if v is not None]
            rec[k] = sum(seen) / len(seen) if seen else None
            rec[k + "_rounds"] = vals
        out[label] = rec
    return out


def _turns_line(res):
    """One log line's worth of :func:`_in_turns`' means."""
    return "; ".join(
        f"{label} device {_ms(r['device_ms'])} graph {_ms(r['graph_ms'])}"
        f"{' (CUDA events)' if r.get('graph_ms_source') == 'event_ms' else ''} "
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
    # the Trainer's step is the fused one: one multi_tensor_update
    if rec["multibox_match"] != 1 or cluster != 1 \
            or rec["multi_tensor_update"] != 1 or sum(rec.values()) != 2 \
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
    # the Trainer's step is the fused one: one multi_tensor_update a step
    others = {k: v for k, v in launches.items()
              if k not in ("rtc_launch", "multi_tensor_update")}
    if any(c != (1, 1) for c in per_step) or len(per_step) != MLP_STEPS \
            or launches["rtc_launch"] != 2 * MLP_STEPS \
            or launches["multi_tensor_update"] != MLP_STEPS \
            or any(others.values()):
        raise AssertionError(f"MLP launches per step {per_step}, counts "
                             f"{launches}: want one forward and one backward "
                             "rtc launch and one multi_tensor_update a step "
                             "and nothing else")
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
                "rtc_softmax_fwd": 1, "rtc_softmax_bwd": 1,
                "multi_tensor_update": 1},
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err,
            "weights_rel_err": w_err, "consistency_max_abs": cons,
            **breakdown}


# ------------------------------------------------ batch serving (A3 1c)
SERVE_RESNET_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_SSD_BUCKETS = (1, 2, 4, 8)
SERVE_CLIENTS, SERVE_REQUESTS = 64, 10
SERVE_MAX_WAIT_MS = 2.0


def _serve_images(seed, n, shape):
    return list(np.random.RandomState(seed).rand(n, *shape)
                .astype(np.float32))


def _closed_loop(ep, xs, clients, per_client, stop=None, timeout=120.0):
    """``clients`` threads, each sending ``per_client`` requests one after
    another (client c's k-th is ``xs[(c + k * clients) % len(xs)]``), or,
    with ``stop`` (a ``threading.Event``), until it is set. Returns the
    wall seconds and, per request, (client, k, input index, output or the
    error, latency s, submit and return ``perf_counter`` stamps)."""
    out = []
    lock = threading.Lock()

    def client(c):
        k = 0
        while (k < per_client) if stop is None else not stop.is_set():
            i = (c + k * clients) % len(xs)
            t0 = time.perf_counter()
            try:
                y = ep.predict(xs[i], timeout=timeout)
                lat = time.perf_counter() - t0
            except Exception as err:       # noqa: BLE001 (counted, raised)
                y, lat = err, None
            with lock:
                out.append((c, k, i, y, lat, t0, time.perf_counter()))
            k += 1
    threads = [threading.Thread(target=client, args=(c,),
                                name=f"chip-smoke-client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, out


def _loop_stats(wall, recs, label):
    errs = [r[3] for r in recs if isinstance(r[3], Exception)]
    if errs:
        raise AssertionError(f"{label}: {len(errs)} of {len(recs)} requests "
                             f"dropped, first {errs[0]!r}")
    lats = np.array([r[4] for r in recs]) * 1e3
    return {"requests": len(recs), "dropped": 0, "wall_s": wall,
            "img_per_s": len(recs) / wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99))}


def _eager_rows(mx, net, xs, batch):
    """``net``'s eager inference forward (not served) over ``xs`` in
    batches of ``batch``: one (rows, ...) array an output."""
    outs = []
    with mx.autograd.pause(train_mode=False), torch.no_grad():
        for s in range(0, len(xs), batch):
            y = net(mx.nd.array(np.stack(xs[s:s + batch]), ctx=mx.gpu(0)))
            ys = y if isinstance(y, (list, tuple)) else [y]
            outs.append([t._data.float().cpu().numpy() for t in ys])
    return [np.concatenate([o[j] for o in outs]) for j in range(len(outs[0]))]


def _served(model, rows, b):
    """``rows`` served as one batch of bucket ``b`` through the model's own
    pack, dispatch and fetch: the real rows of each output."""
    return model.fetch(model.dispatch(model.pack(rows, b), b))


def _bucket_checks(mx, net, model, xs, label, seed):
    """Each bucket's replay against the net's eager forward of the same
    padded batch: equal bit for bit, for a full batch and for one of
    ``n = b // 2`` real rows padded with zeros. Padding rows leave real
    rows alone: those ``n`` rows padded with random rows give the same
    outputs bit for bit. Then the graph's replay and the eager forward
    timed in turns (graph, eager, eager, graph; CUDA events over 10 calls)
    with no traffic on the engine."""
    out = {}
    noise = _serve_images(seed, max(model.buckets), model.item_shape)
    zero = np.zeros(model.item_shape, np.float32)
    for b in model.buckets:
        rows = xs[:b]
        served = _served(model, rows, b)
        eager = _eager_rows(mx, net, rows, b)
        bitwise = all(np.array_equal(s, e) for s, e in zip(served, eager))
        err = max(float(np.abs(s - e).max()) for s, e in zip(served, eager))
        pad = {}
        if b > 1:
            n = b // 2
            zeros = _served(model, rows[:n], b)
            randoms = _served(model, rows[:n] + noise[:b - n], b)
            eager_zeros = _eager_rows(mx, net, rows[:n] + [zero] * (b - n),
                                      b)
            pad = {"real_rows": n,
                   "zero_vs_random_padding_bitwise": all(
                       np.array_equal(z, r[:n])
                       for z, r in zip(zeros, randoms)),
                   "padded_vs_eager_bitwise": all(
                       np.array_equal(z, e[:n])
                       for z, e in zip(zeros, eager_zeros))}
        entry = model._entries[b]
        xb = mx.nd.array(np.stack(rows), ctx=mx.gpu(0))

        graph = entry.step.graph.replay

        def eager_fwd():
            with mx.autograd.pause(train_mode=False), torch.no_grad():
                net(xb)
        reads = {"graph_ms": [], "eager_ms": []}
        with model._lock:
            for fn, key in ((graph, "graph_ms"), (eager_fwd, "eager_ms"),
                            (eager_fwd, "eager_ms"), (graph, "graph_ms")):
                reads[key].append(time_ms(fn, iters=10, warmup=2))
        out[b] = {"bitwise": bitwise, "max_abs_err": err, **pad,
                  "graph_ms": sum(reads["graph_ms"]) / 2,
                  "eager_ms": sum(reads["eager_ms"]) / 2,
                  "graph_ms_rounds": reads["graph_ms"],
                  "eager_ms_rounds": reads["eager_ms"]}
        if not bitwise or not all(pad.values()):
            raise AssertionError(f"{label}: bucket {b}'s replay differs "
                                 f"from its eager forward or its padding "
                                 f"reaches real rows {out[b]}")
    log(f"{label}: bucket replays against eager forwards "
        f"{json.dumps(out)}")
    return out


def _match_detections(a, b, tol):
    """Detections (rows of (class, score, x1, y1, x2, y2), class -1 for
    none) of one image from two runs, matched across: a detection of
    ``a`` matches one of ``b`` of its class within ``tol`` of its score
    and box. One that does not is a near tie when ``b`` has a detection
    of its class within ``tol`` of its score (a reordering, or NMS
    keeping the other of two boxes of near-equal score)."""
    va, vb = a[a[:, 0] >= 0], b[b[:, 0] >= 0]
    matched = ties = 0
    unexplained = []
    for d in va:
        same = vb[vb[:, 0] == d[0]]
        if same.size and float(np.abs(same[:, 1:] - d[1:]).max(1).min()) \
                <= tol:
            matched += 1
        elif same.size and float(np.abs(same[:, 1] - d[1]).min()) <= tol:
            ties += 1
        else:
            unexplained.append(float(d[1]))
    return {"a": len(va), "b": len(vb), "matched": matched,
            "near_ties": ties, "unexplained": len(unexplained),
            "unexplained_top_score": max(unexplained, default=None)}


def _ssd_across_buckets(mx, ssd, eps, xd):
    """The SSD's served detections at bucket 4 (four real rows) against
    the one-row eager ``detect`` of each image: the heads (class logits
    and box offsets) of the two batch sizes, and the detections matched
    across (``_match_detections``)."""
    served = _served(eps.model, xd[:4], 4)[0]
    with mx.autograd.pause(train_mode=False), torch.no_grad():
        four = [t._data.float() for t in
                ssd(mx.nd.array(np.stack(xd[:4]), ctx=mx.gpu(0)))[:2]]
        ones, dets = [], []
        for x in xd[:4]:
            xb = mx.nd.array(x[None], ctx=mx.gpu(0))
            ones.append([t._data.float() for t in ssd(xb)[:2]])
            dets.append(ssd.detect(xb)._data.float().cpu().numpy()[0])
    heads = {}
    for j, name in enumerate(("cls", "box")):
        one = torch.cat([o[j] for o in ones])
        heads[name + "_max_abs"] = float((four[j] - one).abs().max())
        heads[name + "_rel"] = heads[name + "_max_abs"] / float(
            one.abs().max())
    tol = 1e-4
    rows = [_match_detections(served[i], dets[i], tol) for i in range(4)]
    back = [_match_detections(dets[i], served[i], tol) for i in range(4)]
    res = {"heads_bucket4_vs_one_row": heads, "tol": tol,
           "max_abs": float(np.abs(served - np.stack(dets)).max()),
           "served_vs_one_row": {k: sum(r[k] for r in rows)
                                 for k in ("a", "b", "matched", "near_ties",
                                           "unexplained")},
           "one_row_vs_served": {k: sum(r[k] for r in back)
                                 for k in ("matched", "near_ties",
                                           "unexplained")},
           "unexplained_top_score": max(
               [r["unexplained_top_score"] for r in rows + back
                if r["unexplained_top_score"] is not None], default=None)}
    log(f"batch serving: SSD detections at bucket 4 against one-row "
        f"detect {json.dumps(res)}")
    if max(heads["cls_rel"], heads["box_rel"]) > 1e-4 \
            or res["served_vs_one_row"]["unexplained"] \
            or res["one_row_vs_served"]["unexplained"] \
            or not np.isfinite(served).all():
        raise AssertionError(f"SSD across buckets {res}")
    return res


def _dispatch_host_ms(model, rows, b, reps=20):
    """Host ms of each stage of serving ``rows`` in bucket ``b`` through
    the model's own calls: ``pack``, ``dispatch`` (copy in, replay and
    copy out, enqueued on the model's stream), the wait for the batch's
    copy-out event, ``fetch`` (the real rows out of the pinned slot) and
    the demux's slicing into one row a request; the mean over ``reps``
    batches."""
    keys = ("pack", "dispatch", "wait", "fetch", "demux")
    acc = dict.fromkeys(keys, 0.0)
    for _ in range(reps):
        t = [time.perf_counter()]
        batch = model.pack(rows, b)
        t.append(time.perf_counter())
        model.dispatch(batch, b)
        t.append(time.perf_counter())
        batch.slot.event.synchronize()
        t.append(time.perf_counter())
        host = model.fetch(batch)
        t.append(time.perf_counter())
        [[h[i] for h in host] for i in range(len(rows))]
        t.append(time.perf_counter())
        for k, a, z in zip(keys, t, t[1:]):
            acc[k] += (z - a) * 1e3 / reps
    return acc


def _loaded_idle_share(ep, xs, wall_s, n_req):
    """The device's busy time over a loaded window (the closed loop, from
    a profiled run of it), against the unprofiled run's wall."""
    def window():
        return _closed_loop(ep, xs, SERVE_CLIENTS, SERVE_REQUESTS)[0]
    dev, prof_wall = _device_events(window)
    if dev is None:
        return {"device_busy_ms": None, "device_idle_share": None}
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    return {"device_busy_ms": busy, "wall_ms": wall_s * 1e3,
            "profiled_wall_ms": prof_wall * 1e3,
            "device_idle_share": 1 - busy / (wall_s * 1e3),
            "profiled_window_idle_share": 1 - busy / (prof_wall * 1e3),
            "busy_ms_per_request": busy / n_req}


def _watchdog_check(serving, chaos, telemetry):
    """``timeout_ms`` with ``serve.slow_model``: the batch fails with
    ``StepHungError``, the flight recorder is dumped, and the engine serves
    the next request."""
    import os
    import shutil
    import tempfile
    from incubator_mxnet_tpu_torch.guard import StepHungError
    tmp = tempfile.mkdtemp(prefix="chip-smoke-flight-")
    dump = os.path.join(tmp, "flight.jsonl")
    old = os.environ.get("MXTPU_TELEMETRY_DUMP")
    os.environ["MXTPU_TELEMETRY_DUMP"] = dump
    eng = serving.InferenceEngine(max_batch=4, max_wait_ms=1.0,
                                  timeout_ms=50.0, device="cuda")
    eng.SLOW_CHAOS_S = 0.5
    try:
        ep = eng.load_model("slow", fn=lambda x: x * 2.0, item_shape=(4,))
        chaos.arm("serve.slow_model", prob=1.0, seed=5, times=1)
        t0 = time.perf_counter()
        try:
            ep.predict(np.ones(4, np.float32), timeout=60.0)
            tripped = False
        except StepHungError:
            tripped = True
        trip_ms = (time.perf_counter() - t0) * 1e3
        dumped = os.path.exists(dump) and os.path.getsize(dump) > 0
        reason = (json.loads(open(dump).readline())["reason"] if dumped
                  else None)
        after = ep.predict(np.ones(4, np.float32), timeout=60.0)
        res = {"tripped": tripped, "trip_ms": trip_ms, "dumped": dumped,
               "dump_reason": reason, "hung": eng.stats()["slow"]["hung"],
               "served_after": bool(np.array_equal(after, np.full(4, 2.0)))}
    finally:
        chaos.reset()
        eng.close()
        if old is None:
            os.environ.pop("MXTPU_TELEMETRY_DUMP", None)
        else:
            os.environ["MXTPU_TELEMETRY_DUMP"] = old
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"batch serving: the hung-request watchdog {json.dumps(res)}")
    if not (res["tripped"] and res["dumped"] and res["served_after"]
            and str(res["dump_reason"]).startswith("guard:hang")):
        raise AssertionError(f"serving watchdog: {res}")
    return res


def batch_serving_phase(mx, gluon, vision, common, records):
    """Phase 24: one engine, two batch endpoints at full width —
    ``resnet50_v1(layout="NHWC")`` float32 (its input NCHW, one transpose
    at entry), item (3, 224, 224), buckets 1..32; and SSD-512's ``detect``
    (``ssd_512_resnet50_v1(classes=20)``, float32) wrapped in a
    ``HybridBlock`` here, item (3, 512, 512), buckets 1..8 — each bucket
    one captured graph. Checks (any failure raises): ``len(buckets)``
    compiles a model at load and none from traffic; each bucket's replay
    equal to the net's eager forward of the same padded batch bit for bit,
    full and half full, and real rows equal bit for bit under zero and
    random padding (then the replay and the eager forward timed in turns);
    ResNet's served rows against a one-row eager forward (within 1e-3 of
    the largest output), the SSD's heads at batch 4 against batch 1
    (within 1e-4) and each of its served detections matched by one of
    one-row ``detect`` within 1e-4 or a near tie of score, both ways; one
    ``nms_keep`` (cluster route) a served SSD
    batch and one ``softmax_fwd`` a batch whose rows (bucket x anchors)
    the reference's rule gives its kernel (``softmax_viable``: buckets 4
    and 8), counted through replays; a closed loop of 64 clients x 10
    requests (zero dropped; p50, p99, img/s) against one client's 640, the
    device's idle share over it and the host's ms around a dispatch; a hot
    swap to new weights under the loop (zero dropped, every answer
    v1's or v2's, v1's before the swap, v2's after, ``len(buckets)``
    compiles, reserved bytes before the swap and after the release); the
    ladder under ``serve.dispatch_fail`` (retry, rebuild with
    ``len(buckets)`` more compiles, degrade, probe, restore); the
    watchdog with its flight dump."""
    from incubator_mxnet_tpu_torch import chaos, serving, telemetry
    from incubator_mxnet_tpu_torch.models.ssd import ssd_512_resnet50_v1
    from incubator_mxnet_tpu_torch.ops.cuda import softmax as ksm
    res = {}
    compiles = telemetry.counter("mxtpu_serve_compiles_total")

    class SSDDetect(gluon.HybridBlock):
        """The served SSD: ``detect`` (forward, softmax, decode, NMS)."""

        def __init__(self, ssd):
            super().__init__()
            with self.name_scope():
                self.ssd = ssd

        def forward(self, x):
            return self.ssd.detect(x)

    def make_resnet(seed):
        mx.random.seed(seed)
        with mx.gpu(0):
            net = vision.resnet50_v1(layout="NHWC")
            net.initialize()
            net(mx.nd.zeros((1, 3, 224, 224)))
        return net

    eng = serving.InferenceEngine(max_batch=32,
                                  max_wait_ms=SERVE_MAX_WAIT_MS,
                                  device="cuda")
    try:
        net1 = make_resnet(SEED + 21)
        c0 = compiles.value(model="resnet50")
        t0 = time.perf_counter()
        ep = eng.load_model("resnet50", net=net1, item_shape=(3, 224, 224),
                            buckets=SERVE_RESNET_BUCKETS, max_batch=32,
                            weight=1, degrade_after=3, probe_every=0.05)
        load_r = (time.perf_counter() - t0) * 1e3
        mx.random.seed(SEED)
        with mx.gpu(0):
            ssd = ssd_512_resnet50_v1(classes=SSD_CLASSES, layout="NCHW")
            ssd.initialize()
            ssd(mx.nd.zeros((1, 3, SSD_SIZE, SSD_SIZE)))
        det = SSDDetect(ssd)
        s0 = compiles.value(model="ssd")
        t0 = time.perf_counter()
        eps = eng.load_model("ssd", net=det, item_shape=(3, SSD_SIZE,
                                                         SSD_SIZE),
                             buckets=SERVE_SSD_BUCKETS, max_batch=8)
        load_s = (time.perf_counter() - t0) * 1e3
        load_compiles = {"resnet50": compiles.value(model="resnet50") - c0,
                         "ssd": compiles.value(model="ssd") - s0}
        res["load"] = {"ms": {"resnet50": load_r, "ssd": load_s},
                       "compiles": load_compiles}
        log(f"batch serving: loaded {json.dumps(res['load'])}")
        if load_compiles != {"resnet50": len(SERVE_RESNET_BUCKETS),
                             "ssd": len(SERVE_SSD_BUCKETS)}:
            raise AssertionError(f"batch serving compiles {load_compiles}")

        xs = _serve_images(SEED + 22, 64, (3, 224, 224))
        xd = _serve_images(SEED + 23, 8, (3, SSD_SIZE, SSD_SIZE))
        res["resnet_buckets"] = _bucket_checks(mx, net1, ep.model, xs,
                                               "resnet50", SEED + 25)
        res["ssd_buckets"] = _bucket_checks(mx, det, eps.model, xd, "ssd",
                                            SEED + 26)

        # served rows against a one-row eager forward
        ones = _eager_rows(mx, net1, xs[:8], 1)[0]
        futs = [ep.submit(x) for x in xs[:8]]
        served = np.stack([f.result(60.0) for f in futs])
        res["rows_vs_one_row"] = {
            "resnet50_max_abs": float(np.abs(served - ones).max()),
            "resnet50_rel": float(np.abs(served - ones).max()
                                  / np.abs(ones).max()),
            "resnet50_bitwise": bool(np.array_equal(served, ones))}
        log(f"batch serving: served rows against one-row eager forwards "
            f"{json.dumps(res['rows_vs_one_row'])}")
        if not np.isfinite(served).all() \
                or res["rows_vs_one_row"]["resnet50_rel"] > 1e-3:
            raise AssertionError(f"served rows {res['rows_vs_one_row']}")
        res["ssd_vs_one_row"] = _ssd_across_buckets(mx, ssd, eps, xd)

        # SSD: one nms_keep (cluster route) a served batch, and one
        # softmax_fwd where the reference runs its kernel: rows (bucket x
        # anchors) a multiple of 8 (softmax_viable), buckets 4 and 8 here;
        # buckets 1 and 2 take torch.softmax as the reference takes
        # jax.nn.softmax
        anchors = eps.model._out_specs[0][0][0]
        n0 = len(eng.dispatch_log)
        common.reset_launch_counts()
        wall, recs = _closed_loop(eps, xd, 8, 4)
        launches = {k: v for k, v in common.launch_counts().items() if v}
        sm90 = common.sm90_launch_counts()
        served = [b for m, _, b in list(eng.dispatch_log)[n0:] if m == "ssd"]
        viable = {b: ksm.softmax_viable(b * anchors, SSD_CLASSES + 1)
                  for b in SERVE_SSD_BUCKETS}
        want = {"softmax_fwd": sum(viable[b] for b in served),
                "nms_keep": len(served)}
        res["ssd_loop"] = {**_loop_stats(wall, recs, "ssd loop"),
                           "batches": len(served),
                           "batches_by_bucket": {str(b): served.count(b)
                                                 for b in viable},
                           "softmax_kernel_buckets": [b for b in viable
                                                      if viable[b]],
                           "launches": launches,
                           "nms_keep_cluster": sm90["nms_keep"]}
        log(f"batch serving: SSD detect, 8 clients x 4 "
            f"{json.dumps(res['ssd_loop'])}")
        if launches != {k: v for k, v in want.items() if v} \
                or sm90["nms_keep"] != len(served):
            raise AssertionError(f"served SSD launches {res['ssd_loop']}, "
                                 f"want {want}")
        for name in ("softmax_fwd", "nms_keep"):
            records[name]["launches"] += want[name]
            records[name]["served_launches"] = want[name]

        # the closed loop against one client
        r0 = compiles.value(model="resnet50")
        n0 = len(eng.dispatch_log)
        wall, recs = _closed_loop(ep, xs, SERVE_CLIENTS, SERVE_REQUESTS)
        loaded = _loop_stats(wall, recs, "loaded")
        loaded_buckets = [b for m, _, b in list(eng.dispatch_log)[n0:]
                          if m == "resnet50"]
        wall1, recs1 = _closed_loop(ep, xs, 1,
                                    SERVE_CLIENTS * SERVE_REQUESTS)
        serial = _loop_stats(wall1, recs1, "serial")
        res["resnet_loop"] = {
            "loaded": loaded, "serial": serial,
            "loaded_over_serial": loaded["img_per_s"] / serial["img_per_s"],
            "loaded_batches_by_bucket": {
                str(b): loaded_buckets.count(b)
                for b in SERVE_RESNET_BUCKETS},
            "idle": _loaded_idle_share(ep, xs, wall,
                                       SERVE_CLIENTS * SERVE_REQUESTS),
            "dispatch_host_ms": {str(b): _dispatch_host_ms(ep.model,
                                                           xs[:b], b)
                                 for b in (1, 32)}}
        log(f"batch serving: resnet50, {SERVE_CLIENTS} clients x "
            f"{SERVE_REQUESTS} against one client "
            f"{json.dumps(res['resnet_loop'])}")
        if compiles.value(model="resnet50") != r0:
            raise AssertionError("batch serving: traffic compiled")

        # hot swap under the loop
        net2 = make_resnet(SEED + 24)
        ref1 = _eager_rows(mx, net1, xs, 64)[0]
        ref2 = _eager_rows(mx, net2, xs, 64)[0]
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        stamps = {}

        stop = threading.Event()

        def swap():
            try:
                time.sleep(0.3)
                stamps["start"] = time.perf_counter()
                eng.load_model("resnet50", net=net2,
                               item_shape=(3, 224, 224),
                               buckets=SERVE_RESNET_BUCKETS, max_batch=32)
                stamps["end"] = time.perf_counter()
                time.sleep(0.3)
            finally:
                stop.set()
        sw = threading.Thread(target=swap)
        c1 = compiles.value(model="resnet50")
        sw.start()
        wall, recs = _closed_loop(ep, xs, SERVE_CLIENTS, 0, stop=stop)
        sw.join()
        if "end" not in stamps:
            raise AssertionError("hot swap: load_model did not return")
        torch.cuda.empty_cache()
        reserved_after = torch.cuda.memory_reserved()
        versions = []
        for c, k, i, y, lat, t_sub, t_ret in recs:
            e1 = float(np.abs(y - ref1[i]).max())
            e2 = float(np.abs(y - ref2[i]).max())
            v = 1 if e1 < e2 else 2
            versions.append((v, min(e1, e2), t_sub, t_ret))
        tol = 1e-3 * max(np.abs(ref1).max(), np.abs(ref2).max())
        early = [v for v, _, _, t_ret in versions if t_ret < stamps["start"]]
        late = [v for v, _, t_sub, _ in versions if t_sub > stamps["end"]]
        res["hot_swap"] = {
            **_loop_stats(wall, recs, "swap loop"),
            "swap_ms": (stamps["end"] - stamps["start"]) * 1e3,
            "compiles": compiles.value(model="resnet50") - c1,
            "answers_v1": sum(1 for v in versions if v[0] == 1),
            "answers_v2": sum(1 for v in versions if v[0] == 2),
            "v1_before_swap": early.count(1), "of_before": len(early),
            "v2_after_swap": late.count(2), "of_after": len(late),
            "max_err_to_own_version": max(v[1] for v in versions),
            "reserved_before_gb": reserved_before / 1e9,
            "reserved_after_release_gb": reserved_after / 1e9,
            "version": ep.version}
        log(f"batch serving: hot swap under {SERVE_CLIENTS} clients "
            f"{json.dumps(res['hot_swap'])}")
        hs = res["hot_swap"]
        if hs["compiles"] != len(SERVE_RESNET_BUCKETS) \
                or hs["answers_v1"] == 0 or hs["answers_v2"] == 0 \
                or hs["v1_before_swap"] != hs["of_before"] \
                or hs["v2_after_swap"] != hs["of_after"] \
                or hs["max_err_to_own_version"] > tol or ep.version != 2:
            raise AssertionError(f"hot swap {hs}")
        del net1, ref1

        # the self-healing ladder
        c2 = compiles.value(model="resnet50")
        chaos.arm("serve.dispatch_fail", prob=1.0, seed=2, times=3)
        fails = 0
        for _ in range(3):
            try:
                ep.predict(xs[0], timeout=60.0)
            except serving.ServeError:
                fails += 1
        rebuilt = compiles.value(model="resnet50") - c2
        try:
            ep.submit(xs[0])
            degraded_reject = False
        except serving.ModelDegradedError:
            degraded_reject = True
        state_degraded = eng.ready()[1]["resnet50"]
        t0 = time.perf_counter()
        while not eng.ready()[0] and time.perf_counter() - t0 < 30.0:
            time.sleep(0.01)
        restore_ms = (time.perf_counter() - t0) * 1e3
        after = ep.predict(xs[0], timeout=60.0)
        chaos.reset()
        res["ladder"] = {"failures": fails, "rebuild_compiles": rebuilt,
                         "degraded_reject": degraded_reject,
                         "state_when_degraded": state_degraded,
                         "restore_ms": restore_ms,
                         "restored": eng.ready()[0],
                         "served_after_max_err": float(
                             np.abs(after - ref2[0]).max())}
        log(f"batch serving: the ladder under serve.dispatch_fail "
            f"{json.dumps(res['ladder'])}")
        ld = res["ladder"]
        if ld["failures"] != 3 or ld["rebuild_compiles"] != len(
                SERVE_RESNET_BUCKETS) or not ld["degraded_reject"] \
                or ld["state_when_degraded"] != "degraded" \
                or not ld["restored"] or ld["served_after_max_err"] > tol:
            raise AssertionError(f"serving ladder {ld}")
    finally:
        chaos.reset()
        eng.close()
    res["watchdog"] = _watchdog_check(serving, chaos, telemetry)
    return res


# ------------------------------------------- int8 serving and HTTP (phase 25)
QUANT_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/quantized.cu"
QUANT_REPLACES = {
    "qconv_s8": "incubator_mxnet_tpu/ops/quantization.py:170",
    "qgemm_s8": "incubator_mxnet_tpu/ops/quantization.py:155"}
QUANT_KERNELS = ("qconv_s8", "qgemm_s8")
QUANT_BUCKETS = (1, 2, 4, 8, 16, 32)
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor cores
# the reference's quant-smoke gates (tools/quant_smoke.py:45-48)
QUANT_MLP_MAX_REL, QUANT_MLP_MIN_TOP1, QUANT_BYTES_RATIO = 0.15, 0.90, 0.35
# the reference's serve-bench MLP (tools/serve_bench.py:50-53)
QMLP_ITEM, QMLP_HIDDEN, QMLP_LAYERS, QMLP_CLASSES = 256, 256, 24, 64
# shapes off ResNet-50's path: C 3, odd H/W, K not a multiple of 32,
# stride 2 with pad, dilation 2, groups 2 (x shape, w shape, stride, pad,
# dilation, groups)
QCONV_TAILS = (((3, 3, 31, 29), (16, 3, 3, 3), (2, 2), (1, 1), (1, 1), 1),
               ((2, 5, 17, 15), (24, 5, 5, 3), (1, 2), (2, 1), (1, 1), 1),
               ((2, 40, 23, 21), (48, 40, 3, 3), (1, 1), (2, 2), (2, 2), 1),
               ((4, 64, 14, 14), (96, 32, 3, 3), (2, 2), (1, 1), (1, 1), 2),
               ((1, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1))
# shapes on the Hopper route off ResNet-50's path: C and O not multiples of
# the tile, odd H and W, pad 2 with dilation 2, a stride-2 1x1 on odd H, a
# 5x5 with no pad, tiny images; and an output 130 wide (first design)
QCONV_TMA_TAILS = (((3, 48, 9, 11), (40, 48, 3, 3), (1, 1), (1, 1), (1, 1),
                    1),
                   ((2, 32, 13, 7), (24, 32, 3, 3), (1, 1), (2, 2), (2, 2),
                    1),
                   ((1, 160, 15, 9), (200, 160, 1, 1), (2, 2), (0, 0),
                    (1, 1), 1),
                   ((5, 16, 3, 3), (16, 16, 3, 3), (1, 1), (1, 1), (1, 1),
                    1),
                   ((2, 64, 6, 130), (64, 64, 1, 1), (1, 1), (0, 0), (1, 1),
                    1),
                   ((1, 256, 5, 5), (100, 256, 5, 5), (1, 1), (0, 0),
                    (1, 1), 1))
QGEMM_TAILS = ((7, 147, 33), (1, 2048, 1000), (17, 100, 65),
               (200, 512, 130))
QROUTES = {"new": None, "simple": "simple"}


def _qconv_bytes_ops(xs, ws, ys, int8_out, bias):
    """Bytes a conv must move (x and w read once, y written once, the
    bias) and its int8 operations (a multiply and an add a MAC)."""
    n, c, h, w = xs
    o, cg, kh, kw = ws
    _, _, ho, wo = ys
    moved = (n * c * h * w + o * cg * kh * kw
             + n * o * ho * wo * (1 if int8_out else 4)
             + (4 * o if bias else 0))
    return moved, 2 * n * ho * wo * o * cg * kh * kw


def _bound(moved, ops):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _recorded_convs(mx, qop, net, x):
    """Every int8 product of one eager forward of ``net`` over ``x``, in
    order, as ``ops.quantization`` hands it to the kernels (the conv's
    codes and weight in the layout they come in): (kind, operands,
    epilogue)."""
    calls = []
    conv, gemm = qop._conv, qop._gemm

    def rec_conv(xq, wq, stride, pad, dilate, groups, epi=None):
        calls.append(("conv", (xq, wq, tuple(stride), tuple(pad),
                               tuple(dilate), int(groups)), epi))
        return conv(xq, wq, stride, pad, dilate, groups, epi)

    def rec_gemm(xq, wq, epi=None):
        calls.append(("gemm", (xq.reshape(-1, xq.shape[-1]).contiguous(),
                               wq.contiguous()), epi))
        return gemm(xq, wq, epi)
    qop._conv, qop._gemm = rec_conv, rec_gemm
    try:
        with mx.autograd.pause(train_mode=False), torch.no_grad():
            net(x)
    finally:
        qop._conv, qop._gemm = conv, gemm
    torch.cuda.synchronize()
    return calls


def _qkernel_label(key):
    """A profiler key's int8 kernel: ``qtma<BN,epi,T>``, ``qmma<gemm,epi>``,
    "memset" (a split launch's tickets zeroed), or "other" (any copy)."""
    m = re.search(r"qtma_kernel<(\d+), (\d), (true|false)>", key)
    if m:
        return f"qtma<{m.group(1)},{m.group(2)},{int(m.group(3) == 'true')}>"
    m = re.search(r"qmma_kernel<(\d), (\d)>", key)
    if m:
        return f"qmma<{m.group(1)},{m.group(2)}>"
    return "memset" if "memset" in key.lower() else "other"


def _qexpected(qk, convs, route):
    """{kernel label: launches} of one call of ``convs`` on ``route``
    (None: the plan's), a split launch's ticket memset under "memset";
    nothing under "other", which counts only what a window records."""
    out = {}
    for _, (x, w, st, pd, dl, gr), epi in convs:
        plan = qk.qconv_plan(tuple(x.shape), tuple(w.shape), st, pd, dl, gr,
                             qk.sm_count(x.device))
        if plan.route == "tma" and route is None:
            label = f"qtma<{plan.bn},{int(epi is not None)},0>"
            if plan.splits > 1:
                out["memset"] = out.get("memset", 0) + 1
        else:
            label = f"qmma<0,{int(epi is not None)}>"
        out[label] = out.get(label, 0) + 1
    return out


def _qseq_device_ms(seq, expected, calls: int = 3):
    """Device ms of one ``seq()`` (a run of int8 product calls) from
    torch.profiler, counting every kernel the run launches: each kernel's
    mean duration times its launches a call, the larger of ``expected``
    ({label: launches a call}, :func:`_qexpected`) and what the window
    recorded (a window may keep only some records). (None, {}) when no
    window delivers a device event."""
    def window():
        for _ in range(calls):
            seq()
        torch.cuda.synchronize()
    seq()
    torch.cuda.synchronize()
    dev, _ = _device_events(window)
    if dev is None:
        return None, {}
    per = {}
    for e in dev:
        label = _qkernel_label(e.key)
        runs = max(expected.get(label, 0), e.count / calls)
        per[label] = per.get(label, 0.0) + (
            e.self_device_time_total / e.count * runs / 1e3)
    missing = sorted(set(expected) - set(per))
    if missing:
        log(f"int8 device ms: no record of {missing} in the window")
    return sum(per.values()), per


def _qconcurrent_replays(qk, calls, reps: int = 30):
    """Two CUDA graphs of ``calls`` (a forward's int8 products, each graph
    on operands of its own: the recorded ones, and the same with x's codes
    negated), warmed and captured as serving captures a bucket
    (``cuda_graph.first_call``: the one capture stream, a pool a graph),
    then replayed ``reps`` times at once on two streams, as two int8
    models, or both versions of a hot swap, replay. Every output of every
    replay must equal its twin bit for bit (raises otherwise). Returns
    the split-K launches a graph and the outputs compared."""
    from incubator_mxnet_tpu_torch.cuda_graph import CapturedStep, first_call

    def run(kind, args, epi, twin=False):
        if kind == "conv":
            f = qk.qconv_s8_reference if twin else qk.qconv_s8
        else:
            f = qk.qgemm_s8_reference if twin else qk.qgemm_s8
        return f(*args, epi)

    sets = [[(k, a, e) for k, a, e in calls],
            [(k, (-a[0],) + tuple(a[1:]), e) for k, a, e in calls]]
    wants = [[run(*c, twin=True) for c in cs] for cs in sets]
    steps = [CapturedStep(lambda cs=cs: [run(*c) for c in cs])
             for cs in sets]
    for step in steps:
        first_call(step, torch.device("cuda"), what="int8 concurrent replays")
    streams = [torch.cuda.Stream() for _ in steps]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    here = torch.cuda.current_stream()
    for _ in range(reps):
        for step, st in zip(steps, streams):
            st.wait_stream(here)
            with torch.cuda.stream(st):
                step.graph.replay()
        for st in streams:
            here.wait_stream(st)
        for step, want in zip(steps, wants):
            for got, w in zip(step.out, want):
                bad += (got != w).sum()
    wrong = int(bad)
    for step in steps:
        step.graph.reset()
    splits = 0
    for kind, args, _ in calls:
        if kind == "conv":
            x, w, st, pd, dl, gr = args
            plan = qk.qconv_plan(tuple(x.shape), tuple(w.shape), st, pd, dl,
                                 gr, qk.sm_count(x.device))
        else:
            x, w = args
            plan = qk.qgemm_plan(x.shape[0], x.shape[1], w.shape[0],
                                 qk.sm_count(x.device))
        splits += plan.route == "tma" and plan.splits > 1
    if wrong:
        raise AssertionError(f"two int8 graphs replayed at once on two "
                             f"streams: {wrong} values off their twins")
    return {"split_launches_a_graph": splits, "reps": reps,
            "outputs_compared": 2 * reps * len(calls)}


def _rand_case(g, xs, ws, o, with_bias):
    x = torch.randint(-127, 128, xs, generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, ws, generator=g, device="cuda",
                      dtype=torch.int8)
    b = (torch.randint(-40000, 40000, (o,), generator=g, device="cuda",
                       dtype=torch.int32) if with_bias else None)
    return x, w, b


def _qparity(qk, g, cases, gemms):
    """Both routes against the twins bit for bit at every conv case (x
    channels-last and NCHW) in the three epilogues and every GEMM in both;
    raises on any difference. Returns the count of comparisons."""
    n_cmp, cl = 0, torch.channels_last
    for xs, ws, st, pd, dl, gr in cases:
        x, w, b = _rand_case(g, xs, ws, ws[0], True)
        layouts = ((x.contiguous(memory_format=cl),
                    w.contiguous(memory_format=cl)), (x, w))
        for epi in (None, qk.Requant(b, True, 3.1e-5, 141.1, False),
                    qk.Requant(None, False, 2.7e-6, 97.3, False)):
            want = qk.qconv_s8_reference(x, w, st, pd, dl, gr, epi)
            for (xl, wl), (label, route) in itertools.product(
                    layouts, QROUTES.items()):
                got = qk.qconv_s8(xl, wl, st, pd, dl, gr, epi, _route=route)
                n_cmp += 1
                if not torch.equal(got, want):
                    err = int((got.to(torch.int64) - want.to(torch.int64))
                              .abs().max())
                    raise AssertionError(
                        f"qconv_s8 ({label}) {xs} x {ws} stride {st} pad "
                        f"{pd} dilate {dl} groups {gr} epilogue "
                        f"{epi is not None} channels-last "
                        f"{xl.is_contiguous(memory_format=cl)}: off its "
                        f"twin by {err}")
    for xs, ws in gemms:
        x, w, b = _rand_case(g, xs, ws, ws[0], True)
        for epi in (None, qk.Requant(b, True, 3.1e-5, 141.1, False)):
            want = qk.qgemm_s8_reference(x, w, epi)
            for label, route in QROUTES.items():
                got = qk.qgemm_s8(x, w, epi, _route=route)
                n_cmp += 1
                if not torch.equal(got, want):
                    err = int((got.to(torch.int64) - want.to(torch.int64))
                              .abs().max())
                    raise AssertionError(f"qgemm_s8 ({label}) {xs} x {ws} "
                                         f"epilogue {epi is not None}: off "
                                         f"by {err}")
    return n_cmp


def _qseq_turns(qk, convs, rounds: int = 2):
    """The run of ``convs`` (their own operands and epilogues) as one call
    on each route, in turns: device ms (:func:`_qseq_device_ms`, every
    kernel of the run), graph ms, event ms and host µs, each averaged over
    ``rounds`` (the order reversed every other round)."""
    def seq(route):
        def run():
            for _, args, epi in convs:
                qk.qconv_s8(*args, epi, _route=route)
        return run
    runs = {label: seq(route) for label, route in QROUTES.items()}
    expected = {label: _qexpected(qk, convs, route)
                for label, route in QROUTES.items()}
    reads = {label: {k: [] for k in ("device_ms", "graph_ms", "event_ms",
                                     "host_us")} for label in runs}
    split = {}
    for i in range(rounds):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            dev, split[label] = _qseq_device_ms(runs[label], expected[label])
            got = reads[label]
            got["device_ms"].append(dev)
            got["graph_ms"].append(graph_ms(runs[label]))
            got["event_ms"].append(time_ms(runs[label], iters=10, warmup=2))
            got["host_us"].append(host_us(runs[label], calls=5))
    out = {}
    for label, got in reads.items():
        rec = {"kernels": split[label], "launches": expected[label]}
        for k, vals in got.items():
            seen = [v for v in vals if v is not None]
            rec[k] = sum(seen) / len(seen) if seen else None
            rec[k + "_rounds"] = vals
        out[label] = rec
    return out, runs


def _int_mm_convs(convs):
    """The 1x1 stride-1 convs among ``convs`` whose channels-last codes
    ``torch._int_mm`` takes as they lie (rows > 16, C and O multiples of
    8): (x as (N H W, C) rows, w as (C, O), the call)."""
    out = []
    for call in convs:
        x, w, st, pd, _, gr = call[1]
        n, c, h, wd = x.shape
        if tuple(w.shape[2:]) == (1, 1) and st == (1, 1) and pd == (0, 0) \
                and gr == 1 and x.is_contiguous(
                    memory_format=torch.channels_last) \
                and n * h * wd > 16 and c % 8 == 0 and w.shape[0] % 8 == 0:
            out.append((x.permute(0, 2, 3, 1).reshape(-1, c),
                        w.reshape(w.shape[0], c).t(), call))
    return out


def quant_sass_check(common):
    """quantized.cu's kernels as built: the Hopper route's (every
    instantiation of ``qtma_kernel``) each with int8 wgmma (IGMMA) and the
    first design's with int8 mma.sync (IMMA); registers, stack and local
    bytes of each, none with local (spill) bytes."""
    def name_of(want):
        def name(mangled):
            m = re.search(r"qtma_kernelILi(\d+)ELi(\d)ELb([01])E", mangled)
            if m and want == "qtma":
                return f"qtma_kernel<{m.group(1)},{m.group(2)},{m.group(3)}>"
            m = re.search(r"qmma_kernelILi(\d)ELi(\d)E", mangled)
            if m and want == "qmma":
                return f"qmma_kernel<{m.group(1)},{m.group(2)}>"
            return None
        return name
    kernels = _sass_kernels(common, "quantized*.o", name_of("qtma"), "IGMMA")
    if len(kernels) != 12:
        raise AssertionError(f"want 12 qtma_kernel instantiations (tile "
                             f"32/64/128 x 2 epilogues x swapped or not), "
                             f"got {sorted(kernels)}")
    kernels.update(_sass_kernels(common, "quantized*.o", name_of("qmma"),
                                 "IMMA"))
    return kernels


def int8_kernel_checks(mx, qk, common, net, x32, x1):
    """Phase 25's kernel part: ``qconv_s8`` and ``qgemm_s8`` on both
    routes (the Hopper route the plan gives, and the first design behind
    ``_route="simple"``) against their twins bit for bit, in every
    epilogue, x channels-last and NCHW, at every distinct conv shape of
    the converted ResNet-50's forward at bucket 32 (read off the forward
    itself), at the off-path tails (``QCONV_TAILS``, ``QCONV_TMA_TAILS``),
    at the head's GEMM, the MLP's GEMMs and ``QGEMM_TAILS``; two graphs
    of the forward's products at buckets 1 and 32 replayed at once on two
    streams (:func:`_qconcurrent_replays`); each conv
    shape's event and graph ms on both routes beside its bound; then the
    forward's 53 conv launches (its own operands and epilogues) as one
    call at buckets 32 and 1, and the head's GEMM at both, each route in
    turns (device, graph, event ms, host µs) beside the bound, the twins'
    ms and ``torch._int_mm`` (the GEMM, and the run's 1x1 stride-1 convs
    on their channels-last codes). Returns the two kernel records and the
    readings."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 25)
    from incubator_mxnet_tpu_torch.ops import quantization as qop
    copies0 = qk.layout_copies()
    calls = _recorded_convs(mx, qop, net, x32)
    calls1 = _recorded_convs(mx, qop, net, x1)
    copies = {k: v - copies0[k] for k, v in qk.layout_copies().items()}
    if any(copies.values()):
        raise AssertionError(f"the int8 forward made layout copies {copies}")
    convs = [c for c in calls if c[0] == "conv"]
    convs1 = [c for c in calls1 if c[0] == "conv"]
    head = [c for c in calls if c[0] == "gemm"]
    head1 = [c for c in calls1 if c[0] == "gemm"]
    shapes = {}
    for _, (x, w, st, pd, dl, gr), epi in convs:
        key = (tuple(x.shape), tuple(w.shape), st, pd, dl, gr)
        shapes[key] = shapes.get(key, 0) + 1
    cases = list(shapes) + list(QCONV_TAILS) + list(QCONV_TMA_TAILS)
    gemms = [(tuple(h[1][0].shape), tuple(h[1][1].shape))
             for h in head + head1] + \
        [((32, QMLP_ITEM), (QMLP_HIDDEN, QMLP_ITEM)),
         ((32, QMLP_HIDDEN), (QMLP_CLASSES, QMLP_HIDDEN))] + \
        [((n, k), (o, k)) for n, k, o in QGEMM_TAILS]
    sass = quant_sass_check(common)
    n_cmp, worst = _qparity(qk, g, cases, gemms), 0     # or it raised
    routes = {str(k): qk.qconv_plan(*k, qk.sm_count("cuda")).route
              for k in cases}
    simple_convs = []
    for _, (x, w, st, pd, dl, gr), _ in convs:
        plan = qk.qconv_plan(tuple(x.shape), tuple(w.shape), st, pd, dl, gr,
                             qk.sm_count("cuda"))
        if plan.route != "tma":
            simple_convs.append((tuple(x.shape), tuple(w.shape), plan.why))
    log(f"int8 kernels: {n_cmp} comparisons with the twins, both routes "
        f"({len(shapes)} distinct conv shapes of the converted ResNet-50 "
        f"at bucket 32, {len(QCONV_TAILS) + len(QCONV_TMA_TAILS)} tails, "
        f"{len(gemms)} GEMMs), every one bit for bit; the plan's routes "
        f"{json.dumps(routes)}")
    concurrent = {b: _qconcurrent_replays(qk, cs)
                  for b, cs in ((1, calls1), (32, calls))}
    log(f"int8 kernels: two graphs of the forward's products replayed at "
        f"once on two streams, every output equal to its twin bit for bit: "
        f"{json.dumps(concurrent)}")

    per_shape = []
    for (xs, ws, st, pd, dl, gr), count in shapes.items():
        x, w, b = _rand_case(g, xs, ws, ws[0], True)
        x = x.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
        epi = qk.Requant(b, True, 3.1e-5, 141.1, False)
        plan = qk.qconv_plan(xs, ws, st, pd, dl, gr, qk.sm_count("cuda"))
        ys = qk.conv_out_hw(xs[2], xs[3], ws[2:], st, pd, dl)
        bnd, by = _bound(*_qconv_bytes_ops(xs, ws, (xs[0], ws[0]) + ys, True,
                                           True))
        rec = {"x": xs, "w": ws, "stride": st, "pad": pd, "in_net": count,
               "route": plan.route, "splits": plan.splits, "bound_ms": bnd,
               "bound_by": by}
        for label, route in QROUTES.items():
            def one(route=route):
                return qk.qconv_s8(x, w, st, pd, dl, gr, epi, _route=route)
            rec[f"{label}_event_ms"] = time_ms(one, iters=10, warmup=2)
            rec[f"{label}_graph_ms"] = graph_ms(one)
        per_shape.append(rec)
    # a caller's NCHW codes: the wrapper's counted channels-last copy, timed
    # at the largest input of the forward
    xs, ws = (32, 256, 56, 56), (64, 256, 1, 1)
    x, w, _ = _rand_case(g, xs, ws, ws[0], False)
    w = w.contiguous(memory_format=torch.channels_last)
    xcl = x.contiguous(memory_format=torch.channels_last)
    before = qk.layout_copies()["x"]
    nchw_copy = {"x": xs, "w": ws,
                 "channels_last_graph_ms": graph_ms(lambda: qk.qconv_s8(
                     xcl, w)),
                 "nchw_graph_ms": graph_ms(lambda: qk.qconv_s8(x, w)),
                 "copy_graph_ms": graph_ms(lambda: x.contiguous(
                     memory_format=torch.channels_last))}
    if qk.layout_copies()["x"] == before:
        raise AssertionError("an NCHW x made no counted layout copy")
    log(f"int8: qconv_s8 given NCHW codes (a counted channels-last copy) "
        f"{json.dumps(nchw_copy)}")
    slower = [(r["x"], r["w"], r["stride"]) for r in per_shape
              if r["new_graph_ms"] is not None and r["simple_graph_ms"]
              is not None and r["new_graph_ms"] > r["simple_graph_ms"]]
    log(f"int8 conv shapes at bucket 32, each route's event and graph ms "
        f"(requantize epilogue) {json.dumps(per_shape)}; the new route "
        f"slower (graph) at {slower}")

    seqs, bounds = {}, {}
    for bucket, cv in ((32, convs), (1, convs1)):
        moved = ops = 0
        for _, (x, w, st, pd, dl, gr), epi in cv:
            ys = qk.conv_out_hw(x.shape[2], x.shape[3], w.shape[2:], st, pd,
                                dl)
            m, o = _qconv_bytes_ops(tuple(x.shape), tuple(w.shape),
                                    (x.shape[0], w.shape[0]) + ys,
                                    epi is not None,
                                    epi is not None and epi.bias is not None)
            moved, ops = moved + m, ops + o
        bounds[bucket] = (*_bound(moved, ops), ops)
        seqs[bucket], runs = _qseq_turns(qk, cv)
        log(f"qconv_s8, the forward's {len(cv)} convs at bucket {bucket} in "
            f"turns: {_turns_line(seqs[bucket])}; bound "
            f"{bounds[bucket][0]:.4f} ms ({bounds[bucket][1]}); "
            f"{ops / 1e9:.2f} G int8 ops; kernels "
            f"{json.dumps({k: v['kernels'] for k, v in seqs[bucket].items()})}")
        if bucket == 32:
            def seq_twin():
                for _, args, epi in cv:
                    qk.qconv_s8_reference(*args, epi)
            plain = time_ms(seq_twin, iters=2, warmup=1)
            pairs = _int_mm_convs(cv)
            sub = [c for _, _, c in pairs]

            def int_mm_run():
                for a, b, _ in pairs:
                    torch._int_mm(a, b)

            def sub_run():
                for _, args, epi in sub:
                    qk.qconv_s8(*args, epi)
            for a, b, (_, args, _) in pairs:
                if not torch.equal(torch._int_mm(a, b),
                                   qk.qconv_s8(*args).permute(0, 2, 3, 1)
                                   .reshape(a.shape[0], -1)):
                    raise AssertionError("torch._int_mm disagrees with "
                                         "qconv_s8 on a 1x1 conv")
            library = {"convs": len(pairs), "int_mm_graph_ms":
                       graph_ms(int_mm_run), "int_mm_event_ms":
                       time_ms(int_mm_run, iters=10, warmup=2),
                       "new_graph_ms": graph_ms(sub_run)}
            log(f"the {len(pairs)} 1x1 stride-1 convs at bucket 32: "
                f"torch._int_mm (int32 out) {json.dumps(library)}; the twin "
                f"run {plain:.4f} ms")
    new32, new1 = seqs[32]["new"], seqs[1]["new"]
    records = {"qconv_s8": {
        "name": "qconv_s8", "route": "cuda", "source": QUANT_SOURCE,
        "replaces": QUANT_REPLACES["qconv_s8"], "launches": 0,
        "max_abs_err": float(worst), "ms": new32["event_ms"],
        "device_ms": new32["device_ms"], "graph_ms": new32["graph_ms"],
        "host_us": new32["host_us"], "plain_ms": plain,
        "bound_ms": bounds[32][0], "bound_by": bounds[32][1],
        "library_ms": library["int_mm_graph_ms"],
        "library_subset_ms": library["new_graph_ms"],
        "library_of": f"library_ms and library_subset_ms are graph ms on "
                      f"the {library['convs']} 1x1 stride-1 convs only "
                      f"(channels-last codes, int32 out): torch._int_mm, "
                      f"and this route on the same convs; ms, graph_ms "
                      f"and device_ms are of all {len(convs)} convs",
        "simple": {k: seqs[32]["simple"][k] for k in (
            "device_ms", "graph_ms", "event_ms", "host_us")},
        "bucket_1": {"device_ms": new1["device_ms"],
                     "graph_ms": new1["graph_ms"],
                     "event_ms": new1["event_ms"],
                     "host_us": new1["host_us"],
                     "bound_ms": bounds[1][0], "bound_by": bounds[1][1],
                     "simple": {k: seqs[1]["simple"][k] for k in (
                         "device_ms", "graph_ms", "event_ms", "host_us")}},
        "shape": f"ResNet-50's {len(convs)} convs at bucket 32, one call",
        "tera_ops_per_s": bounds[32][2] / new32["event_ms"] / 1e9}}

    # the head's GEMM (raw int32, the float-boundary layer), buckets 32, 1
    gemm_read = {}
    for bucket, hd in ((32, head), (1, head1)):
        (xh, wh), epi_h = hd[0][1], hd[0][2]
        turns = _in_turns({label: (lambda r=route: qk.qgemm_s8(
            xh, wh, epi_h, _route=r)) for label, route in QROUTES.items()},
            qk.qgemm_s8)
        library = None
        if bucket == 32:
            wt = wh.t()
            if not torch.equal(torch._int_mm(xh, wt), qk.qgemm_s8(xh, wh)):
                raise AssertionError("torch._int_mm disagrees with qgemm_s8")
            library = time_ms(lambda: torch._int_mm(xh, wt), iters=20)
            plain = time_ms(lambda: qk.qgemm_s8_reference(xh, wh, epi_h),
                            iters=10, warmup=2)
        n, k = xh.shape
        o = wh.shape[0]
        bnd, by = _bound(n * k + o * k + 4 * n * o, 2 * n * k * o)
        gemm_read[bucket] = {"turns": turns, "bound_ms": bnd,
                             "bound_by": by, "int_mm_ms": library}
        log(f"qgemm_s8 at the head {tuple(xh.shape)} x {tuple(wh.shape)} in "
            f"turns: {_turns_line(turns)}; torch._int_mm {_ms(library)} ms; "
            f"bound {bnd:.5f} ms ({by}); kernels "
            f"{json.dumps({k: v['kernels'] for k, v in turns.items()})}")
    t32, t1 = gemm_read[32]["turns"], gemm_read[1]["turns"]
    xh, wh = head[0][1]
    records["qgemm_s8"] = {
        "name": "qgemm_s8", "route": "cuda", "source": QUANT_SOURCE,
        "replaces": QUANT_REPLACES["qgemm_s8"], "launches": 0,
        "max_abs_err": float(worst), "ms": t32["new"]["event_ms"],
        "device_ms": t32["new"]["device_ms"],
        "graph_ms": t32["new"]["graph_ms"], "host_us": t32["new"]["host_us"],
        "plain_ms": plain, "bound_ms": gemm_read[32]["bound_ms"],
        "bound_by": gemm_read[32]["bound_by"],
        "library_ms": gemm_read[32]["int_mm_ms"],
        "simple": {k: t32["simple"][k] for k in (
            "device_ms", "graph_ms", "event_ms", "host_us")},
        "bucket_1": {**{k: t1["new"][k] for k in (
            "device_ms", "graph_ms", "event_ms", "host_us")},
            "bound_ms": gemm_read[1]["bound_ms"],
            "simple": {k: t1["simple"][k] for k in (
                "device_ms", "graph_ms", "event_ms", "host_us")}},
        "shape": f"{tuple(xh.shape)} x {tuple(wh.shape)}, int32 out"}
    slow = [f"53 convs at bucket {b}" for b in (32, 1)
            if (seqs[b]["new"]["graph_ms"] or 0) >=
            (seqs[b]["simple"]["graph_ms"] or float("inf"))] + \
        [f"head GEMM at bucket {b}" for b in (32, 1)
         if (gemm_read[b]["turns"]["new"]["graph_ms"] or 0) >=
         (gemm_read[b]["turns"]["simple"]["graph_ms"] or float("inf"))]
    if slow:
        log(f"int8: the new route is not faster than the first design "
            f"(graph ms) at {slow}")
    return records, {"per_shape": per_shape, "comparisons": n_cmp,
                     "nchw_copy": nchw_copy,
                     "seq": seqs, "gemm": gemm_read, "slower": slow,
                     "routes": routes, "simple_convs": simple_convs,
                     "concurrent": concurrent, "sass": sass}


def _quant_counts(net):
    """(QuantizedConv2D, QuantizedDense) layers of a converted net, chain
    stages included."""
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        QuantizedConv2D, QuantizedDense)
    n_conv = n_dense = 0
    stack = [net]
    while stack:
        b = stack.pop()
        n_conv += isinstance(b, QuantizedConv2D)
        n_dense += isinstance(b, QuantizedDense)
        stack.extend(b._children.values())
    return n_conv, n_dense


def _qmlp(mx, seed):
    """The reference's serve-bench MLP (24 x Dense(256) ReLU + Dense(64))
    on the card, seeded."""
    from incubator_mxnet_tpu_torch.gluon import nn
    mx.random.seed(seed)
    with mx.gpu(0):
        net = nn.HybridSequential()
        for _ in range(QMLP_LAYERS):
            net.add(nn.Dense(QMLP_HIDDEN, activation="relu"))
        net.add(nn.Dense(QMLP_CLASSES))
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, QMLP_ITEM)))
    return net


def _calib_batches(mx, seed, shape):
    rs = np.random.RandomState(seed)
    with mx.gpu(0):
        return [mx.nd.array(rs.rand(8, *shape).astype(np.float32))
                for _ in range(2)]


def _accuracy(a, b):
    return {"max_rel_err": float(np.abs(a - b).max()
                                 / (np.abs(b).max() + 1e-9)),
            "top1_agreement": float((a.argmax(1) == b.argmax(1)).mean())}


def _http(port, path, body=None, ctype="application/json", headers=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": ctype, **(headers or {})},
        method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _http_checks(serving, eng, ep, xs, mlp_reload):
    """The port's HTTP front end on ``127.0.0.1:0`` in a thread over
    ``eng``: npy and JSON :predict equal ``ep.predict`` bit for bit,
    /readyz and /metrics, a :reload hot swap (``len(buckets)`` captures),
    a :generate stream of 16 tokens equal to the engine's own greedy
    stream, and a shed request's 429 with Retry-After."""
    import io
    import urllib.error
    from http.server import ThreadingHTTPServer
    from incubator_mxnet_tpu_torch import telemetry
    from incubator_mxnet_tpu_torch.tools import serve as tserve
    params, cfg = tserve._build_demo_lm("cuda")
    gep = eng.load_model("genlm", generate={"params": params, "cfg": cfg,
                                            "max_len": 64, "slots": 2})
    eng.load_model("tiny", fn=lambda b: (time.sleep(0.3), b)[1],
                   item_shape=(1,), queue_limit=1, max_batch=1)
    compiles = telemetry.counter("mxtpu_serve_compiles_total")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(
        eng, reloaders={"mlp_int8": mlp_reload}))
    thr = threading.Thread(target=httpd.serve_forever,
                           name="chip-smoke-http", daemon=True)
    thr.start()
    port = httpd.server_address[1]
    res = {}
    try:
        x = xs[0]
        want = ep.predict(x, timeout=60.0)
        buf = io.BytesIO()
        np.save(buf, x)
        t0 = time.perf_counter()
        st, hdr, raw = _http(port, f"/v1/models/{ep.name}:predict",
                             buf.getvalue(), "application/x-npy")
        npy_ms = (time.perf_counter() - t0) * 1e3
        got = np.load(io.BytesIO(raw), allow_pickle=False)
        t0 = time.perf_counter()
        st2, _, raw2 = _http(port, f"/v1/models/{ep.name}:predict",
                             json.dumps({"data": x.tolist()}).encode())
        json_ms = (time.perf_counter() - t0) * 1e3
        got2 = np.asarray(json.loads(raw2)["outputs"][0], np.float32)
        res["predict"] = {"npy_bitwise": bool(np.array_equal(got, want)),
                          "json_bitwise": bool(np.array_equal(got2, want)),
                          "npy_ms": npy_ms, "json_ms": json_ms,
                          "trace_id": hdr.get("x-mxtpu-trace-id")}
        st3, _, body = _http(port, "/readyz")
        _, _, metrics = _http(port, "/metrics")
        res["readyz"] = st3
        res["metrics_has_model_bytes"] = \
            b"mxtpu_serve_model_bytes" in metrics
        c0 = compiles.value(model="mlp_int8")
        st4, _, body = _http(port, "/v1/models/mlp_int8:reload", b"{}")
        res["reload"] = {"status": st4, **json.loads(body),
                         "compiles": compiles.value(model="mlp_int8") - c0}
        prompt = [5, 17, 3, 42, 8]
        greedy = list(gep.submit(np.asarray(prompt, np.int32),
                                 max_new_tokens=16).result(120.0))
        _, _, raw = _http(port, "/v1/models/genlm:generate", json.dumps(
            {"tokens": prompt, "max_new_tokens": 16,
             "stream": True}).encode())
        lines = [json.loads(ln) for ln in raw.decode().splitlines()
                 if ln.strip()]
        res["generate"] = {"tokens": len(lines) - 1,
                           "equal_engine": [ln["token"] for ln in lines[:-1]]
                           == greedy and len(greedy) == 16,
                           "done": bool(lines[-1].get("done"))}
        tiny = eng._endpoints["tiny"]
        held = [tiny.submit(np.zeros((1,), np.float32))]
        time.sleep(0.05)
        held.append(tiny.submit(np.zeros((1,), np.float32)))
        try:
            _http(port, "/v1/models/tiny:predict",
                  json.dumps({"data": [0.0]}).encode())
            res["shed"] = {"status": 200}
        except urllib.error.HTTPError as err:
            res["shed"] = {"status": err.code,
                           "retry_after": err.headers.get("Retry-After"),
                           "reason": json.loads(err.read()).get("reason")}
        for f in held:
            f.result(60.0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thr.join(timeout=10.0)
    log(f"int8 serving: HTTP {json.dumps(res)}")
    p = res["predict"]
    if not (p["npy_bitwise"] and p["json_bitwise"]) or res["readyz"] != 200 \
            or not res["metrics_has_model_bytes"] \
            or res["reload"]["status"] != 200 \
            or res["reload"]["compiles"] != len(QUANT_BUCKETS) \
            or not res["generate"]["equal_engine"] \
            or not res["generate"]["done"] \
            or res["shed"]["status"] != 429 \
            or not res["shed"].get("retry_after"):
        raise AssertionError(f"HTTP front end {res}")
    return res


def int8_serving_phase(mx, gluon, vision, common, records):
    """Phase 25: int8 inference and the HTTP front end on the card.
    ``resnet50_v1(layout="NCHW")`` float32, seeded, its BN statistics
    moved by seeded training-mode forwards, served with
    ``load_model(quantize={"calib_data": two seeded batches of 8,
    "calib_mode": "naive", "fold_bn": True})``, item (3, 224, 224),
    buckets 1..32, beside its float32 twin; the reference's serve-bench
    MLP (24 x Dense(256)) calibrated the same way, beside its float32
    twin. Checks (any failure raises): the kernels on both routes against
    their twins bit for bit, the int8 forward with no layout copy, and
    their SASS (:func:`int8_kernel_checks`, :func:`quant_sass_check`);
    ``len(buckets)`` captures a model at load and none from traffic;
    every bucket's replay equal to the converted net's eager forward bit
    for bit, full and half full, and padding rows leave real rows alone
    (``_bucket_checks``); one ``qconv_s8`` launch a quantized conv and one
    ``qgemm_s8`` a quantized dense in each served batch, through replays,
    both counts read off the converted net, every one on the Hopper route
    but the convs whose shape the plan names (the stem's C 3), logged; the
    MLP's row served alone equal to the same row in a full bucket bit for
    bit (the ResNet's logged); the quant-smoke gates
    (MLP relative logit error <= 0.15, top-1 agreement >= 0.90; int8
    bytes <= 0.35x the float32 endpoint's for both models; the ResNet's
    error and agreement logged); 64 closed-loop clients x 10 on the int8
    and the float32 ResNet with none dropped; then the HTTP front end
    (:func:`_http_checks`)."""
    from incubator_mxnet_tpu_torch import serving, telemetry
    from incubator_mxnet_tpu_torch.ops.cuda import quantized as qk
    from incubator_mxnet_tpu_torch.test_utils import copy_params
    res = {}
    compiles = telemetry.counter("mxtpu_serve_compiles_total")
    bytes_g = telemetry.gauge("mxtpu_serve_model_bytes")
    shape = (3, 224, 224)

    def resnet(seed):
        mx.random.seed(seed)
        with mx.gpu(0):
            net = vision.resnet50_v1(layout="NCHW")
            net.initialize()
            net(mx.nd.zeros((1,) + shape))
        return net

    net_f = resnet(SEED + 31)
    rs = np.random.RandomState(SEED + 32)
    with mx.gpu(0), mx.autograd.record(train_mode=True):
        for _ in range(2):                  # non-trivial BN statistics
            net_f(mx.nd.array(rs.rand(8, *shape).astype(np.float32)))
    net_q = resnet(SEED + 33)
    copy_params(net_f, net_q)
    xs = _serve_images(SEED + 34, 64, shape)
    ref_f = _eager_rows(mx, net_f, xs, 32)[0]

    eng = serving.InferenceEngine(max_batch=32,
                                  max_wait_ms=SERVE_MAX_WAIT_MS,
                                  device="cuda")
    try:
        t0 = time.perf_counter()
        c0 = compiles.value(model="resnet50_int8")
        ep = eng.load_model(
            "resnet50_int8", net=net_q, item_shape=shape,
            buckets=QUANT_BUCKETS, max_batch=32,
            quantize={"calib_data": _calib_batches(mx, SEED + 35, shape),
                      "calib_mode": "naive", "fold_bn": True})
        load_q = (time.perf_counter() - t0) * 1e3
        c_q = compiles.value(model="resnet50_int8") - c0
        c0 = compiles.value(model="resnet50_f32")
        epf = eng.load_model("resnet50_f32", net=net_f, item_shape=shape,
                             buckets=QUANT_BUCKETS, max_batch=32)
        c_f = compiles.value(model="resnet50_f32") - c0
        n_conv, n_dense = _quant_counts(net_q)
        res["resnet_load"] = {"int8_ms": load_q, "compiles_int8": c_q,
                              "compiles_f32": c_f, "quantized_convs": n_conv,
                              "quantized_dense": n_dense,
                              "bytes_int8": bytes_g.value(
                                  model="resnet50_int8"),
                              "bytes_f32": bytes_g.value(
                                  model="resnet50_f32")}
        log(f"int8 serving: ResNet-50 loaded {json.dumps(res['resnet_load'])}")
        if c_q != len(QUANT_BUCKETS) or c_f != len(QUANT_BUCKETS) \
                or n_dense != 1 or n_conv != 53:
            raise AssertionError(f"int8 ResNet-50 load {res['resnet_load']}")

        with mx.gpu(0):
            x32 = mx.nd.array(np.stack(xs[:32]))
            x1 = mx.nd.array(np.stack(xs[:1]))
        k_records, k_read = int8_kernel_checks(mx, qk, common, net_q, x32,
                                               x1)
        records.update(k_records)
        res["kernels"] = k_read

        res["resnet_buckets"] = _bucket_checks(mx, net_q, ep.model, xs,
                                               "resnet50 int8", SEED + 36)
        common.reset_launch_counts()
        _served(ep.model, xs[:32], 32)
        one = {k: v for k, v in common.launch_counts().items() if v}
        if one != {"qconv_s8": n_conv, "qgemm_s8": n_dense}:
            raise AssertionError(f"one bucket-32 replay launched {one}, "
                                 f"want {n_conv} qconv_s8 and {n_dense} "
                                 "qgemm_s8")
        # every conv on the Hopper route but the shapes its plan names
        # (C / groups not a multiple of 16: the stem's C 3)
        simple = k_read["simple_convs"]
        on90 = {k: v for k, v in common.sm90_launch_counts().items() if v}
        if on90 != {"qconv_s8": n_conv - len(simple), "qgemm_s8": n_dense} \
                or any("C 3 " not in why for _, _, why in simple):
            raise AssertionError(f"one bucket-32 replay's Hopper launches "
                                 f"{on90}; first design {simple}")
        log(f"int8 serving: one bucket-32 replay, {on90} on the Hopper "
            f"route; on the first design only {simple}")
        solo = ep.predict(xs[0], timeout=60.0)
        full = _served(ep.model, xs[:32], 32)[0]
        res["resnet_solo_vs_full"] = {
            "bitwise": bool(np.array_equal(solo, full[0])),
            "max_abs_diff": float(np.abs(solo - full[0]).max())}
        served = np.stack([ep.predict(x, timeout=60.0) for x in xs])
        res["resnet_accuracy"] = _accuracy(served, ref_f)
        res["resnet_bytes_ratio"] = (res["resnet_load"]["bytes_int8"]
                                     / res["resnet_load"]["bytes_f32"])
        log(f"int8 serving: ResNet-50 one replay {json.dumps(one)}; row "
            f"alone vs in bucket 32 {json.dumps(res['resnet_solo_vs_full'])}"
            f"; against float32 {json.dumps(res['resnet_accuracy'])}; "
            f"bytes ratio {res['resnet_bytes_ratio']:.4f}")
        if res["resnet_bytes_ratio"] > QUANT_BYTES_RATIO \
                or not np.isfinite(served).all():
            raise AssertionError(f"int8 ResNet-50 {res}")

        # the main path: 64 closed-loop clients on the int8 endpoint, the
        # kernels' counts from 0 just before, read just after
        r0 = compiles.value(model="resnet50_int8")
        n0 = len(eng.dispatch_log)
        common.reset_launch_counts()
        wall, recs = _closed_loop(ep, xs, SERVE_CLIENTS, SERVE_REQUESTS)
        launches = {k: v for k, v in common.launch_counts().items() if v}
        batches = [b for m, _, b in list(eng.dispatch_log)[n0:]
                   if m == "resnet50_int8"]
        loop_q = _loop_stats(wall, recs, "int8 loop")
        wall, recs = _closed_loop(epf, xs, SERVE_CLIENTS, SERVE_REQUESTS)
        loop_f = _loop_stats(wall, recs, "float32 loop")
        res["resnet_loop"] = {
            "int8": {**loop_q, "batches": len(batches),
                     "batches_by_bucket": {str(b): batches.count(b)
                                           for b in QUANT_BUCKETS},
                     "launches": launches},
            "float32": loop_f,
            "int8_over_float32": loop_q["img_per_s"] / loop_f["img_per_s"]}
        log(f"int8 serving: ResNet-50, {SERVE_CLIENTS} clients x "
            f"{SERVE_REQUESTS}, int8 then float32 "
            f"{json.dumps(res['resnet_loop'])}")
        if launches != {"qconv_s8": n_conv * len(batches),
                        "qgemm_s8": n_dense * len(batches)} \
                or compiles.value(model="resnet50_int8") != r0:
            raise AssertionError(f"int8 loop launches {launches} over "
                                 f"{len(batches)} batches, or it compiled")
        res["bucket_graph_ms"] = {
            label: {str(b): time_ms(m._entries[b].step.graph.replay,
                                    iters=10, warmup=2)
                    for b in QUANT_BUCKETS}
            for label, m in (("int8", ep.model), ("float32", epf.model))}
        log(f"int8 serving: each bucket's graph replay, int8 and float32 "
            f"{json.dumps(res['bucket_graph_ms'])}")
        for name in QUANT_KERNELS:
            records[name]["launches"] = launches[name]
            records[name]["launches_per_batch"] = launches[name] // len(
                batches)
        eng.unload("resnet50_f32")

        # the reference's quant-smoke MLP
        mlp_f = _qmlp(mx, SEED + 37)
        mlp_q = _qmlp(mx, SEED + 38)
        copy_params(mlp_f, mlp_q)
        mlp_src = _qmlp(mx, SEED + 39)
        copy_params(mlp_f, mlp_src)
        # calibrated as the reference's gate does (tools/quant_smoke.py:
        # gate_mlp_accuracy: naive, one batch of 64 seeded requests)
        with mx.gpu(0):
            mcal = [mx.nd.array(np.stack(_serve_images(SEED + 40, 64,
                                                       (QMLP_ITEM,))))]
        spec = {"calib_data": mcal, "calib_mode": "naive"}
        c0 = compiles.value(model="mlp_int8")
        epm = eng.load_model("mlp_int8", net=mlp_q, item_shape=(QMLP_ITEM,),
                             buckets=QUANT_BUCKETS, max_batch=32,
                             quantize=spec)
        epmf = eng.load_model("mlp_f32", net=mlp_f,
                              item_shape=(QMLP_ITEM,),
                              buckets=QUANT_BUCKETS, max_batch=32)
        c_m = compiles.value(model="mlp_int8") - c0
        ms = _serve_images(SEED + 41, 64, (QMLP_ITEM,))
        res["mlp_buckets"] = _bucket_checks(mx, mlp_q, epm.model, ms,
                                            "mlp int8", SEED + 42)
        m_int8 = np.stack([epm.predict(x, timeout=60.0) for x in ms])
        m_f32 = np.stack([epmf.predict(x, timeout=60.0) for x in ms])
        solo = epm.predict(ms[0], timeout=60.0)
        full = _served(epm.model, ms[:32], 32)[0]
        # a reading: the same MLP calibrated like the ResNet (two seeded
        # batches of 8)
        from incubator_mxnet_tpu_torch.contrib.quantization import (
            quantize_net)
        mlp_16 = _qmlp(mx, SEED + 44)
        copy_params(mlp_f, mlp_16)
        quantize_net(mlp_16, calib_data=_calib_batches(
            mx, SEED + 45, (QMLP_ITEM,)), calib_mode="naive")
        m_16 = _eager_rows(mx, mlp_16, ms, 32)[0]
        res["mlp"] = {**_accuracy(m_int8, m_f32), "compiles": c_m,
                      "calibrated_on_two_batches_of_8": _accuracy(m_16,
                                                                  m_f32),
                      "compiles_after_traffic":
                          compiles.value(model="mlp_int8") - c0,
                      "bytes_ratio": bytes_g.value(model="mlp_int8")
                      / bytes_g.value(model="mlp_f32"),
                      "solo_vs_full_bitwise": bool(np.array_equal(
                          solo, full[0]))}
        log(f"int8 serving: the quant-smoke MLP {json.dumps(res['mlp'])}")
        m = res["mlp"]
        if m["max_rel_err"] > QUANT_MLP_MAX_REL \
                or m["top1_agreement"] < QUANT_MLP_MIN_TOP1 \
                or m["bytes_ratio"] > QUANT_BYTES_RATIO \
                or not m["solo_vs_full_bitwise"] \
                or m["compiles"] != len(QUANT_BUCKETS) \
                or m["compiles_after_traffic"] != len(QUANT_BUCKETS):
            raise AssertionError(f"quant-smoke gates {m}")
        eng.unload("mlp_f32")

        def mlp_reload():
            net = _qmlp(mx, SEED + 43)
            copy_params(mlp_src, net)
            return {"net": net, "item_shape": (QMLP_ITEM,),
                    "buckets": QUANT_BUCKETS, "max_batch": 32,
                    "quantize": {"calib_data": mcal, "calib_mode": "naive"}}
        res["http"] = _http_checks(serving, eng, ep, xs, mlp_reload)
    finally:
        eng.close()
    return res


# ----------------------------------------------- the record input path
INPUT_RECORDS = 1024           # bench.py's _ensure_rec_file
INPUT_SIZE = 256
INPUT_CROP = (224, 224)
INPUT_WARM, INPUT_TIMED = 2, 20
INPUT_TRUTH_BATCHES = 8
INPUT_EPOCHS = 5               # the lane's source covers this many epochs
INPUT_RATE_BATCHES = 16        # host batches timed for the decode alone
GLUON_INPUT_BATCH = 32
GLUON_INPUT_STEPS = 5
GLUON_INPUT_WORKERS = 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: the fused-conv launches a ResNet-50 step makes (phase 14's counts)
RESNET_CONV_PER_STEP = {"mm_fused": 29, "conv3_fused": 13,
                        "mm_fused_bwd": 23, "conv3_fused_bwd": 13,
                        "dgrad_epilogue": 3}


class _RawImage:
    """A raw-pixel record (``recordio.pack`` of an HWC uint8 image's bytes)
    as (the image, its float32 label); picklable by its module's name, so
    the DataLoader's process workers can take it."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __call__(self, record):
        from incubator_mxnet_tpu_torch import recordio
        header, payload = recordio.unpack(record)
        return (np.frombuffer(payload, np.uint8).reshape(self.shape),
                np.float32(header.label))


def _raw_transform():
    import chip_smoke     # by its module name, which the workers import
    return chip_smoke._RawImage((INPUT_SIZE, INPUT_SIZE, 3))


def _write_input_records(recordio, path, raw):
    """bench.py's record file (``_ensure_rec_file``): INPUT_RECORDS random
    INPUT_SIZE x INPUT_SIZE RGB images and their labels from
    ``RandomState(0)``, JPEG at quality 90 through ``recordio.pack_img``,
    or raw pixels through ``recordio.pack``; written with an index file,
    which ``RecordFileDataset`` and ``ImageRecordDataset`` read. Returns
    (seconds, bytes)."""
    import os
    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    rec = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(INPUT_RECORDS):
        img = rs.randint(0, 255, (INPUT_SIZE, INPUT_SIZE, 3), dtype=np.uint8)
        header = recordio.IRHeader(0, float(rs.randint(0, 1000)), i, 0)
        rec.write_idx(i, recordio.pack(header, img.tobytes()) if raw
                      else recordio.pack_img(header, img, quality=90))
    rec.close()
    return time.perf_counter() - t0, os.path.getsize(path)


def _xy(batch):
    """(data, label) tensors of a DataBatch or of a DataLoader's [x, y]."""
    if hasattr(batch, "data"):
        return batch.data[0]._data, batch.label[0]._data
    return batch[0]._data, batch[1]._data


def _lane_x(image, x_u8, gen):
    """The device half of the lane: a random 224 x 224 crop and mirror of
    the uint8 NHWC batch drawn from ``gen``, then float32 / 255 in phase
    14's layout (NCHW, contiguous)."""
    crop = image.random_crop_flip(x_u8, INPUT_CROP, gen)
    return (crop.permute(0, 3, 1, 2).float() / 255.0).contiguous()


def _input_source(mx, gluon, io, route, path, workers, seed, epochs):
    """The lane's host source, ``epochs`` epochs of RESNET_BATCH batches:
    ``ImageRecordIter`` on the native route over the JPEG records (shuffled
    by ``seed``, reset after each epoch), or, without the native library,
    a ``DataLoader`` over the raw-pixel records, its order ``epochs``
    permutations from ``seed`` in one pass (so its ``workers`` processes
    start once). ``workers=0`` reads in this process. Returns (an iterator
    of batches, the object to close)."""
    if route == "native":
        it = io.ImageRecordIter(
            path_imgrec=path, data_shape=(3, INPUT_SIZE, INPUT_SIZE),
            batch_size=RESNET_BATCH, shuffle=True, dtype="uint8",
            preprocess_threads=max(workers, 1), seed=seed)
        if it.route != "native":
            raise AssertionError(f"ImageRecordIter took the {it.route!r} "
                                 "route with the native library built")

        def batches():
            for _ in range(epochs):
                yield from it
                it.reset()
        return batches(), it
    rs = np.random.RandomState(seed)
    order = np.concatenate([rs.permutation(INPUT_RECORDS)
                            for _ in range(epochs)]).tolist()
    loader = gluon.data.DataLoader(
        gluon.data.RecordFileDataset(path).transform(_raw_transform()),
        batch_size=RESNET_BATCH, sampler=order, last_batch="discard",
        num_workers=workers, thread_pool=False)
    return iter(loader), None


def _host_batches(mx, source, n):
    """The first ``n`` (x, y) batches of a host source, as numpy."""
    out = []
    with mx.cpu():
        for batch in itertools.islice(source, n):
            x, y = _xy(batch)
            out.append((x.numpy(), y.numpy()))
    return out


def _decode_rate(mx, source, skip, n):
    """(seconds to the first batch, images a second) of a host source
    alone (no step, no copy): the rate over ``n`` batches after the
    first ``skip``, one a worker, whose time holds the workers'
    start."""
    with mx.cpu():
        t0 = time.perf_counter()
        next(source)
        first = time.perf_counter() - t0
        for _ in itertools.islice(source, skip - 1):
            pass
        t0 = time.perf_counter()
        for _ in itertools.islice(source, n):
            pass
        return first, n * RESNET_BATCH / (time.perf_counter() - t0)


def _h2d_ms(x_host, copies=10):
    """Event ms of one pinned host batch's copy to the card, and GB/s."""
    pinned = x_host.pin_memory()
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
    dev.copy_(pinned, non_blocking=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(copies):
        dev.copy_(pinned, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / copies
    return ms, pinned.numel() * pinned.element_size() / ms / 1e6


def _check_conv_counts(common, label, steps):
    got, got90 = common.launch_counts(), common.sm90_launch_counts()
    for name, n in RESNET_CONV_PER_STEP.items():
        if got[name] != n * steps or got90[name] != n * steps:
            raise AssertionError(
                f"{label}: {name} launched {got[name]} times ({got90[name]} "
                f"on the sm90 route) in {steps} steps, not {n * steps}")
    return {name: got[name] / steps for name in RESNET_CONV_PER_STEP}


def _crop_capture_check(image, cuda_graph, x_u8):
    """``random_crop_flip`` captured in a CUDA graph with its generator
    registered: a replay equals an eager call from the same generator
    state, bit for bit, and a second replay draws anew."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 261)
    static = x_u8.clone()
    cs = cuda_graph.CapturedStep(
        lambda: image.random_crop_flip(static, INPUT_CROP, g))
    cuda_graph.first_call(cs, static.device, (g,), "random_crop_flip")
    state = g.get_state()
    replay = cs().clone()
    again = cs().clone()
    g.set_state(state)
    eager = image.random_crop_flip(static, INPUT_CROP, g)
    torch.cuda.synchronize()
    if not torch.equal(replay, eager) or torch.equal(replay, again):
        raise AssertionError("random_crop_flip: a graph replay differs from "
                             "the eager call, or two replays drew the same")
    return True


def input_path_phase(mx, gluon, vision, common, synthetic_img_s):
    """Phase 26: the record input path feeding the captured ResNet-50 step.

    a. the port's ``_native`` builds ``native/``'s sources into
       ``build/native_torch/`` (seconds, path, or why it could not), and
       the reference's ``native/build/libmxtpu.so`` is not mapped;
    b. bench.py's record file in a temporary directory: 1,024 random
       256 x 256 RGB JPEGs at quality 90 through ``recordio.pack_img``,
       labels from ``RandomState(0)``; without the native library also the
       same images as raw pixels through ``recordio.pack``;
    c. host truth: the first two batches of ``ImageRecordIter(data_shape=
       (3, 256, 256), batch_size=128, shuffle=False, dtype="uint8")`` equal
       ``image.imdecode`` of the same records one by one, bit for bit (the
       native route, or without it the process route, asserted);
    d. the lane, bench.py's ``_recordio_loop`` with ``BENCH_DEVICE_AUG=1``:
       the host source (``ImageRecordIter(shuffle=True, dtype="uint8",
       preprocess_threads=os.cpu_count())`` on the native route; without
       the native library a ``DataLoader`` of ``os.cpu_count()`` process
       workers over the raw-pixel records) -> ``io.DevicePrefetcher(depth=
       2)`` -> ``image.random_crop_flip(x, (224, 224), generator)`` ->
       float32 / 255, NCHW -> phase 14's captured step (a fresh net, batch
       128, bf16 on float32 masters, SGD momentum 0.9): 2 warm-up steps
       (on the raw branch one a worker, whose first batch holds its
       start) and 20 timed ones; img/s, the share of the wall the consumer waited for
       input, the share the card spent in the crop and the step (CUDA
       events), the source's img/s alone (after one batch a worker, whose
       time holds the workers' start), a batch's pinned
       host-to-device ms, 29/13/23/13/3 fused-conv launches a step (through
       the replays, all on the sm90 route), finite losses, beside phase
       14's synthetic img/s;
    e. input truth: the first 8 batches the prefetcher handed out equal,
       bit for bit, the host batches of a fresh source with the same seed;
       one step from a copy of the state on a delivered batch equals one
       step on the same host batch uploaded with ``torch.from_numpy(...)
       .cuda()``, crop drawn from the same generator state (loss and every
       parameter update bit for bit); ``random_crop_flip`` captured in a
       CUDA graph equals its eager call;
    f. the Gluon route: ``ImageRecordDataset`` over the JPEG records with
       ``transform_first(Compose([RandomResizedCrop(224),
       RandomFlipLeftRight(), ToTensor(), Normalize(...)]))`` ->
       ``DataLoader(batch_size=32, shuffle=True, num_workers=4)`` on
       process workers -> ``DevicePrefetcher`` -> the same captured step at
       batch 32: a step a worker first (the first timed alone), then 5
       timed steps, img/s, finite losses, and every worker's report that
       it did not initialise CUDA."""
    import os
    import shutil
    import tempfile
    from incubator_mxnet_tpu_torch import (_native, cuda_graph, image, io,
                                           recordio)
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    os.environ["MXTPU_BN_IMPL"] = "plain"
    out = {}
    # a. the build
    native = _native.available()
    with open("/proc/self/maps") as f:
        ref_mapped = "native/build/libmxtpu.so" in f.read()
    if ref_mapped:
        raise AssertionError("native/build/libmxtpu.so is mapped: the port "
                             "loaded the reference's library")
    out["native"] = {"available": native,
                     "build_seconds": _native.build_seconds(),
                     "library": _native.LIB_PATH,
                     "error": _native.load_error()}
    log(f"input path: native library {json.dumps(out['native'])}; the "
        f"reference's native/build/libmxtpu.so mapped: {ref_mapped}")
    route = "native" if native else "raw"
    if not native:
        log("input path: the native library is unavailable here (the error "
            "above); the lane takes the raw-pixel branch: a DataLoader of "
            "process workers over raw-pixel records, DevicePrefetcher, "
            "random_crop_flip and the step; the JPEG records are decoded by "
            "PIL on ImageRecordIter's process route")
    workers = os.cpu_count() or 1
    shm = shutil.disk_usage("/dev/shm")
    log(f"input path: {workers} CPUs; /dev/shm {shm.total / 1e9:.2f} GB, "
        f"{shm.free / 1e9:.2f} GB free")
    tmp = tempfile.mkdtemp(prefix="mxtpu_input_")
    try:
        # b. the records
        jpeg = os.path.join(tmp, "imagenet.rec")
        secs, size = _write_input_records(recordio, jpeg, raw=False)
        out["records"] = {"jpeg_seconds": secs, "jpeg_bytes": size}
        lane_path = jpeg
        if not native:
            lane_path = os.path.join(tmp, "imagenet_raw.rec")
            secs, size = _write_input_records(recordio, lane_path, raw=True)
            out["records"].update(raw_seconds=secs, raw_bytes=size)
        log(f"input path: records {json.dumps(out['records'])}")
        # c. host truth
        truth_it = io.ImageRecordIter(
            path_imgrec=jpeg, data_shape=(3, INPUT_SIZE, INPUT_SIZE),
            batch_size=RESNET_BATCH, shuffle=False, dtype="uint8",
            preprocess_threads=workers,
            preprocess_procs=0 if native else workers)
        expect = "native" if native else "procs"
        if truth_it.route != expect:
            raise AssertionError(f"ImageRecordIter took {truth_it.route!r}, "
                                 f"not {expect!r}")
        got = _host_batches(mx, truth_it, 2)
        truth_it.close()
        reader = recordio.MXIndexedRecordIO(jpeg[:-4] + ".idx", jpeg, "r")
        with mx.cpu():
            for b, (x, y) in enumerate(got):
                for j in range(RESNET_BATCH):
                    header, payload = recordio.unpack(
                        reader.read_idx(b * RESNET_BATCH + j))
                    if not np.array_equal(
                            x[j], image.imdecode(payload).asnumpy()) \
                            or y[j] != np.float32(header.label):
                        raise AssertionError(
                            f"ImageRecordIter ({expect}) batch {b} row {j} "
                            "differs from image.imdecode of its record")
        reader.close()
        out["host_truth"] = {"route": expect, "batches": 2,
                             "bitwise": True}
        log(f"input path: host truth {json.dumps(out['host_truth'])}")
        # the source alone: decode img/s, and a batch's copy to the card
        rate_epochs = -(-(workers + INPUT_RATE_BATCHES) * RESNET_BATCH
                        // INPUT_RECORDS)
        src, closer = _input_source(mx, gluon, io, route, lane_path, workers,
                                    SEED, rate_epochs)
        out["first_batch_s"], out["decode_img_s"] = _decode_rate(
            mx, src, workers, INPUT_RATE_BATCHES)
        if closer is not None:
            closer.close()
        del src
        if not native:
            procs_it = io.ImageRecordIter(
                path_imgrec=jpeg, data_shape=(3, INPUT_SIZE, INPUT_SIZE),
                batch_size=RESNET_BATCH, shuffle=True, dtype="uint8",
                preprocess_procs=workers)

            def procs_epochs():
                while True:
                    yield from procs_it
                    procs_it.reset()
            _, out["jpeg_procs_decode_img_s"] = _decode_rate(
                mx, procs_epochs(), workers, INPUT_RATE_BATCHES)
            procs_it.close()
        h2d_ms, h2d_gb_s = _h2d_ms(torch.from_numpy(got[0][0]))
        out["h2d_ms_per_batch"], out["h2d_gb_s"] = h2d_ms, h2d_gb_s
        log(f"input path: the {route} source alone "
            f"{out['decode_img_s']:.1f} img/s ({workers} workers; its "
            f"first batch after {out['first_batch_s']:.2f} s)"
            + (f", JPEG on the process route (PIL) "
               f"{out['jpeg_procs_decode_img_s']:.1f} img/s"
               if not native else "")
            + f"; a batch's pinned copy to the card {h2d_ms:.3f} ms "
            f"({h2d_gb_s:.1f} GB/s)")
        del got
        # d. the lane
        gc.collect()
        torch.cuda.empty_cache()
        net, step, params, aux, opt, _x, _y = _resnet_setup(
            mx, gluon, vision, SEED + 26, RESNET_BATCH, torch.bfloat16)
        del _x, _y
        state = (params, aux, opt)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 26)
        src, closer = _input_source(mx, gluon, io, route, lane_path, workers,
                                    SEED + 1, INPUT_EPOCHS)
        pf = io.DevicePrefetcher(src, depth=2)
        if pf.device.type != "cuda":
            raise AssertionError(f"DevicePrefetcher on {pf.device}")
        kept, losses, waits, marks = [], [], [0.0], []

        def fetch():
            t0 = time.perf_counter()
            x_u8, y = _xy(next(pf))
            waits[0] += time.perf_counter() - t0
            if len(kept) < INPUT_TRUTH_BATCHES:
                kept.append((x_u8.clone(), y.clone()))
            return x_u8, y

        def run(steps):
            nonlocal state
            for _ in range(steps):
                x_u8, y = fetch()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()        # after the stream's wait on the copy
                *state, loss = step(*state, _lane_x(image, x_u8, gen),
                                    y.to(torch.int32))
                ev[1].record()
                marks.append(ev)
                losses.append(loss)
        # on the raw branch a warm-up step a worker: each worker's first
        # batch carries its start (an import of torch and the port)
        warm = INPUT_WARM if native else max(INPUT_WARM, workers)
        t0 = time.perf_counter()
        run(warm)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        common.reset_launch_counts()
        waits[0] = 0.0
        del marks[:]
        t0 = time.perf_counter()
        run(INPUT_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        per_step = _check_conv_counts(common, "input path lane", INPUT_TIMED)
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"input path: losses not finite {losses}")
        lane = {"route": route, "img_s": INPUT_TIMED * RESNET_BATCH / wall,
                "step_ms": wall / INPUT_TIMED * 1e3,
                "input_wait_share": waits[0] / wall,
                "device_busy_share": busy / wall,
                "synthetic_img_s_phase14": synthetic_img_s,
                "warmup_steps": warm, "warmup_s": warm_s,
                "launches_per_step": per_step, "losses": losses}
        log(f"input path lane ({route}): {warm} warm-up steps in "
            f"{warm_s:.2f} s (the first call's capture and the source's "
            f"start), then {INPUT_TIMED} steps in "
            f"{wall:.3f} s, {lane['img_s']:.1f} img/s against phase 14's "
            f"synthetic {synthetic_img_s}; the consumer waited for input "
            f"{lane['input_wait_share']:.4f} of the wall (the host runs "
            f"ahead of the card, so it waits there whichever side is "
            f"slower); the crop and step busy on the card "
            f"{lane['device_busy_share']:.4f} of it; fused-conv "
            f"launches a step {per_step} (all on sm90); losses "
            f"{[round(v, 4) for v in losses]}")
        pf.close()
        if closer is not None:
            closer.close()
        del src, pf
        out["lane"] = lane
        # e. input truth
        src, closer = _input_source(mx, gluon, io, route, lane_path, 0,
                                    SEED + 1, INPUT_EPOCHS)
        host = _host_batches(mx, src, INPUT_TRUTH_BATCHES)
        if closer is not None:
            closer.close()
        for i, ((xd, yd), (xh, yh)) in enumerate(zip(kept, host)):
            if not (np.array_equal(xd.cpu().numpy(), xh)
                    and np.array_equal(yd.cpu().numpy(), yh)):
                raise AssertionError(f"input path: prefetched batch {i} "
                                     "differs from the host batch")
        del kept
        src, closer = _input_source(mx, gluon, io, route, lane_path, workers,
                                    SEED + 1, 1)
        pf = io.DevicePrefetcher(src, depth=2)
        x_dev, y_dev = _xy(next(pf))
        snap = tuple(_clone(t) for t in state)
        g_state = gen.get_state()
        gen.set_state(g_state)
        a = _one_step_from(step, snap, _lane_x(image, x_dev, gen),
                           y_dev.to(torch.int32))
        gen.set_state(g_state)
        b = _one_step_from(step, snap, _lane_x(
            image, torch.from_numpy(host[0][0]).cuda(), gen),
            torch.from_numpy(host[0][1]).cuda().to(torch.int32))
        agree = _agreement("input path: a step on a prefetched batch "
                           "against one on the uploaded host batch", a, b)
        pf.close()
        if closer is not None:
            closer.close()
        del src, pf
        if not agree["bitwise"]:
            raise AssertionError(f"input path: steps differ {agree}")
        captured_crop = _crop_capture_check(image, cuda_graph, x_dev)
        out["input_truth"] = {"prefetched_batches_bitwise":
                              INPUT_TRUTH_BATCHES,
                              "step_on_prefetched_vs_uploaded": agree,
                              "random_crop_flip_captured": captured_crop}
        del x_dev, y_dev, host, snap
        # f. the Gluon route
        tf = gluon.data.vision.transforms
        ds = gluon.data.vision.ImageRecordDataset(jpeg).transform_first(
            tf.Compose([tf.RandomResizedCrop(INPUT_CROP[0]),
                        tf.RandomFlipLeftRight(), tf.ToTensor(),
                        tf.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
        loader = gluon.data.DataLoader(
            ds, batch_size=GLUON_INPUT_BATCH, shuffle=True,
            num_workers=GLUON_INPUT_WORKERS, thread_pool=False,
            last_batch="discard")
        pf = io.DevicePrefetcher(loader, depth=2)
        g_losses = []

        def gluon_steps(n):
            nonlocal state
            for _ in range(n):
                x, y = _xy(next(pf))
                *state, loss = step(*state, x, y.to(torch.int32))
                g_losses.append(loss)
        t0 = time.perf_counter()
        gluon_steps(1)
        torch.cuda.synchronize()
        g_first = time.perf_counter() - t0
        gluon_steps(GLUON_INPUT_WORKERS - 1)   # each worker's first batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gluon_steps(GLUON_INPUT_STEPS)
        torch.cuda.synchronize()
        g_wall = time.perf_counter() - t0
        pf.close()
        del pf
        deadline = time.monotonic() + 60
        while (len(loader.worker_reports) < GLUON_INPUT_WORKERS
               and time.monotonic() < deadline):
            time.sleep(0.1)
        reports = list(loader.worker_reports)
        g_losses = [float(v) for v in g_losses]
        if len(reports) != GLUON_INPUT_WORKERS or any(
                r["cuda_initialized"] for r in reports):
            raise AssertionError(f"DataLoader workers' reports: {reports}")
        if not all(np.isfinite(g_losses)):
            raise AssertionError(f"gluon route: losses not finite "
                                 f"{g_losses}")
        out["gluon"] = {"img_s": GLUON_INPUT_STEPS * GLUON_INPUT_BATCH
                        / g_wall, "first_step_s": g_first,
                        "losses": g_losses, "worker_reports": reports}
        log(f"input path, the Gluon route: the first step (the workers' "
            f"start, the capture) {g_first:.2f} s, then "
            f"{GLUON_INPUT_WORKERS - 1} more; {GLUON_INPUT_STEPS} steps at "
            f"batch {GLUON_INPUT_BATCH} in {g_wall:.3f} s "
            f"({out['gluon']['img_s']:.1f} img/s), losses "
            f"{[round(v, 4) for v in g_losses]}; workers {reports}")
        del step, state, net, params, aux, opt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ----------------------------------------- the detection input path
DET_INPUT_RECORDS = 512
#: VOC's common image sizes, (height, width)
DET_INPUT_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333))
DET_INPUT_MAX_OBJS = 8
DET_INPUT_WARM, DET_INPUT_TIMED = 3, 12
DET_INPUT_TRUTH = 4


def _write_det_records(recordio, path, seed):
    """VOC-like records: DET_INPUT_RECORDS random RGB images of VOC's
    sizes, JPEG at quality 90 through ``recordio.pack_img``, each with
    1-8 boxes over the 20 classes, labels in the reference's ``[2, 5,
    cls, x1, y1, x2, y2, ...]`` header form. Returns (seconds, bytes)."""
    import os
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    rec = recordio.MXRecordIO(path, "w")
    for i in range(DET_INPUT_RECORDS):
        h, w = DET_INPUT_SIZES[i % len(DET_INPUT_SIZES)]
        img = rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
        k = rs.randint(1, DET_INPUT_MAX_OBJS + 1)
        x1, y1 = rs.uniform(0, 0.7, k), rs.uniform(0, 0.7, k)
        boxes = np.stack([rs.randint(0, SSD_CLASSES, k), x1, y1,
                          x1 + rs.uniform(0.1, 0.3, k),
                          y1 + rs.uniform(0.1, 0.3, k)], 1)
        label = np.concatenate([[2, 5], boxes.reshape(-1)]).astype(
            np.float32)
        rec.write(recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                    quality=90))
    rec.close()
    return time.perf_counter() - t0, os.path.getsize(path)


def _det_iter(image, path, seed):
    """``ImageDetIter`` at SSD-512's lane over the records: batch 32,
    (3, 512, 512), shuffled from ``seed``, with ``CreateDetAugmenter(
    rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True, std=True)``
    drawing from ``RandomState(seed)``."""
    augs = image.CreateDetAugmenter(
        data_shape=(3, SSD_SIZE, SSD_SIZE), rand_crop=0.5, rand_pad=0.5,
        rand_mirror=True, mean=True, std=True,
        rng=np.random.RandomState(seed))
    return image.ImageDetIter(SSD_BATCH, (3, SSD_SIZE, SSD_SIZE),
                              path_imgrec=path, max_objs=DET_INPUT_MAX_OBJS,
                              shuffle=True, seed=seed, aug_list=augs)


def _epochs(it):
    """A ``DataIter``'s batches, epoch after epoch (reset between)."""
    while True:
        yield from it
        it.reset()


def _det_labels_ok(y):
    """Every real label row's box inside [0, 1], every padding row -1."""
    real = y[..., 0] >= 0
    boxes = y[..., 1:][real]
    return bool(real.any()) and bool(((boxes >= 0) & (boxes <= 1)).all()) \
        and bool((y[~real] == -1).all())


def detection_input_phase(mx, common, records, synthetic_img_s):
    """Phase 27: the detection input path feeding phase 21's SSD-512 step
    (``ssd_512_resnet50_v1(classes=20, layout="NCHW")``, batch 32,
    512 x 512, bf16 on float32 masters, SGD momentum 0.9, lr 0.004).

    512 VOC-like records (:func:`_write_det_records`) -> ``ImageDetIter``
    with ``CreateDetAugmenter`` (:func:`_det_iter`: one thread builds the
    batches with numpy and PyTorch on the host, a sample at a time) ->
    ``io.DevicePrefetcher(depth=2)`` -> the step: 3 warm-up and 12 timed
    steps (the prefetcher fills its two batches during the warm-up, so
    the timed run reads them and then the iterator's own rate), img/s
    beside phase 21's synthetic img/s, the share of the wall
    the consumer waited for input and the share the card spent in the
    step (CUDA events), the iterator's img/s alone; each step launches
    one ``multibox_match``, on the cluster route, and nothing else of the
    port; finite losses; every label box inside [0, 1] and every padding
    row -1; the first 4 batches on the card equal a fresh iterator's host
    batches (same seeds) bit for bit; the eval point on a fed batch's
    heads launches one ``nms_keep``, on the cluster route; then the fed
    step's device time split (:func:`kernel_breakdown`)."""
    import os
    import shutil
    import tempfile
    from incubator_mxnet_tpu_torch import image, io, recordio
    from incubator_mxnet_tpu_torch.ops.detection import multibox_detection
    from incubator_mxnet_tpu_torch.parallel.dp import _sgd_init, _sgd_update
    out = {}
    tmp = tempfile.mkdtemp(prefix="mxtpu_det_input_")
    try:
        path = os.path.join(tmp, "voc.rec")
        secs, size = _write_det_records(recordio, path, SEED + 27)
        out["records"] = {"count": DET_INPUT_RECORDS, "seconds": secs,
                          "bytes": size}
        # host truth, and the iterator's rate alone
        t0 = time.perf_counter()
        truth_it = _det_iter(image, path, SEED + 27)
        load_s = time.perf_counter() - t0
        with mx.cpu():
            t0 = time.perf_counter()
            host = [truth_it.next() for _ in range(DET_INPUT_TRUTH)]
            iter_s = time.perf_counter() - t0
            host = [(b.data[0]._data.numpy(), b.label[0]._data.numpy())
                    for b in host]
        del truth_it
        out["iterator"] = {"decode_records_s": load_s,
                           "img_s": DET_INPUT_TRUTH * SSD_BATCH / iter_s}
        log(f"detection input: records {json.dumps(out['records'])}; "
            f"ImageDetIter read them in {load_s:.2f} s and builds "
            f"{out['iterator']['img_s']:.1f} img/s alone (one thread)")
        for i, (xh, yh) in enumerate(host):
            if xh.shape != (SSD_BATCH, 3, SSD_SIZE, SSD_SIZE) \
                    or yh.shape != (SSD_BATCH, DET_INPUT_MAX_OBJS, 5) \
                    or not _det_labels_ok(yh) or not np.isfinite(xh).all():
                raise AssertionError(f"detection input: host batch {i} "
                                     f"{xh.shape} {yh.shape} malformed")
        # the lane
        gc.collect()
        torch.cuda.empty_cache()
        net, params, aux = _ssd_net(mx, torch.zeros(
            (1, 3, SSD_SIZE, SSD_SIZE), device="cuda"))
        opt = _sgd_init(params, 0.9)

        def step(params, opt, x, y):
            loss, grads, heads, _ = _ssd_loss_and_grads(
                net, params, aux, x, y, torch.bfloat16)
            with torch.no_grad():
                params, opt = _sgd_update(params, grads, opt, SSD_LR, 0.0,
                                          0.9)
            return params, opt, loss, heads

        pf = io.DevicePrefetcher(_epochs(_det_iter(image, path, SEED + 27)),
                                 depth=2)
        kept, losses, waits, marks = [], [], [0.0], []
        last = {}

        def run(n):
            nonlocal params, opt
            for _ in range(n):
                t0 = time.perf_counter()
                batch = next(pf)
                waits[0] += time.perf_counter() - t0
                x, y = batch.data[0]._data, batch.label[0]._data
                if len(kept) < DET_INPUT_TRUTH:
                    kept.append((x.clone(), y.clone()))
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                params, opt, loss, heads = step(params, opt, x, y)
                ev[1].record()
                marks.append(ev)
                losses.append(loss)
                last.update(x=x, y=y, heads=heads)
        t0 = time.perf_counter()
        run(DET_INPUT_WARM)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        common.reset_launch_counts()
        waits[0] = 0.0
        del marks[:]
        t0 = time.perf_counter()
        run(DET_INPUT_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = common.launch_counts()
        cluster = common.sm90_launch_counts()["multibox_match"]
        busy = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        pf.close()
        del pf
        losses = [float(v) for v in losses]
        others = {k: v for k, v in launches.items()
                  if k != "multibox_match" and v}
        if launches["multibox_match"] != DET_INPUT_TIMED \
                or cluster != DET_INPUT_TIMED or others:
            raise AssertionError(f"detection input: {DET_INPUT_TIMED} fed "
                                 f"steps launched {launches} ({cluster} "
                                 "on the cluster route)")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"detection input: losses {losses}")
        records["multibox_match"].setdefault("launches_by_phase", {})[
            "27"] = launches["multibox_match"]
        for i, ((xd, yd), (xh, yh)) in enumerate(zip(kept, host)):
            if not (np.array_equal(xd.cpu().numpy(), xh)
                    and np.array_equal(yd.cpu().numpy(), yh)):
                raise AssertionError(f"detection input: batch {i} on the "
                                     "card differs from the host batch")
        lane = {"img_s": DET_INPUT_TIMED * SSD_BATCH / wall,
                "step_ms": wall / DET_INPUT_TIMED * 1e3,
                "synthetic_img_s_phase21": synthetic_img_s,
                "input_wait_share": waits[0] / wall,
                "device_busy_share": busy / wall,
                "warmup_s": warm_s, "losses": losses,
                "launches_per_step": {"multibox_match": 1},
                "cluster_launches": cluster,
                "batches_on_card_bitwise": len(kept)}
        log(f"detection input lane: {DET_INPUT_TIMED} record-fed SSD-512 "
            f"steps in {wall:.3f} s, {lane['img_s']:.1f} img/s against "
            f"phase 21's synthetic {synthetic_img_s}; the consumer waited "
            f"{lane['input_wait_share']:.4f} of the wall for input, the "
            f"card was busy in the step {lane['device_busy_share']:.4f} of "
            f"it; launches {launches} ({cluster} on the cluster route); "
            f"losses {[round(v, 4) for v in losses]}")
        # the eval point on a fed batch's heads
        cls_f, box_f, anchors = last["heads"]
        cls_prob = torch.softmax(cls_f.transpose(1, 2).contiguous(), dim=1)
        common.reset_launch_counts()
        det = multibox_detection(cls_prob, box_f, anchors, nms_topk=400)
        torch.cuda.synchronize()
        ev = {k: v for k, v in common.launch_counts().items() if v}
        ev_cluster = common.sm90_launch_counts()["nms_keep"]
        if ev != {"nms_keep": 1} or ev_cluster != 1 \
                or not bool(torch.isfinite(det).all()):
            raise AssertionError(f"detection input eval point: launches "
                                 f"{ev}, {ev_cluster} on the cluster route")
        records["nms_keep"].setdefault("launches_by_phase", {})["27"] = 1
        lane["eval_launches"] = ev
        # the fed step's device time split
        x, y = last["x"], last["y"]
        lane["breakdown"] = kernel_breakdown(
            "SSD-512 record-fed", lambda: step(params, opt, x, y),
            ("match_cluster_kernel",))
        out["lane"] = lane
        del net, params, aux, opt, last, kept
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------- the input service
INPUT_SERVICE_WORKERS = 8
INPUT_SERVICE_KILL_PROB = 0.05


def _kill_seed(prob, workers, fire_by=1, horizon=4, incarnations=3):
    """A chaos seed under which ``io.worker_kill`` fires at slot 0's first
    incarnation within its first ``fire_by`` batches and at no other
    (slot, incarnation) within ``horizon``: exactly one scripted kill
    (chaos._Point's stream, ``Random(seed ^ crc32("io.worker_kill|" +
    salt))``, with the salt ``io:<slot>:<respawns>`` the service gives each
    worker incarnation)."""
    import random
    import zlib

    def fires(seed, salt, n):
        rng = random.Random(
            seed ^ zlib.crc32(f"io.worker_kill|{salt}".encode()))
        return any(rng.random() < prob for _ in range(n))
    for seed in range(200000):
        if fires(seed, "io:0:0", fire_by) and not any(
                fires(seed, f"io:{s}:{inc}", horizon)
                for s in range(workers) for inc in range(incarnations)
                if (s, inc) != (0, 0)):
            return seed
    raise AssertionError("no chaos seed scripts exactly one worker kill")


def _batch_hash(batch):
    """sha256 of a delivered batch's data and label bytes."""
    import hashlib
    h = hashlib.sha256()
    for a in list(batch.data) + list(batch.label or []):
        h.update(a._data.cpu().numpy().tobytes())
    return h.hexdigest()


def input_service_phase(mx, gluon, vision, common, records, synthetic_img_s,
                        loader_img_s):
    """Phase 28: ``input_service.InputService`` feeding phase 14's captured
    ResNet-50 step.

    Phase 26's raw-pixel records (1,024 random 256 x 256 images,
    ``recordio.pack``) as a ``RecordFileDataset`` with phase 26's decode
    (``_RawImage``), ``InputService(num_workers=8, batch_size=128,
    shuffle=True)`` -> ``io.DevicePrefetcher(depth=2)`` ->
    ``random_crop_flip`` -> the step at batch 128, bf16: 8 warm-up steps
    (the workers' start) and 20 timed ones; img/s beside phase 26's
    DataLoader lane and phase 14's synthetic lane, ``starvation_share()``,
    the consumer's input wait and the card's busy share; 29/13/23/13/3
    fused-conv launches a step, all on sm90; the first epoch's delivered
    batches equal (sha256) the inline service's (``num_workers=0``); every
    worker reports it did not initialise CUDA. Then with ``io.worker_kill``
    armed once through ``MXTPU_CHAOS`` (:func:`_kill_seed`), one epoch's
    batches hash as the inline ones, ``stats()["restarts"]`` is 1 and
    ``mxtpu_io_worker_restarts_total{reason="exit"}`` moves by 1. Then
    one record's magic is flipped: an epoch completes, the quarantine file
    holds that record's exact uri and offset, and
    ``mxtpu_io_records_skipped_total{reason="invalid magic"}`` moves by 1.
    After every ``close()``, no ``mxtpu*`` segment this phase made is
    left in ``/dev/shm``."""
    import glob
    import os
    import shutil
    import tempfile
    from incubator_mxnet_tpu_torch import image, io, recordio, telemetry
    from incubator_mxnet_tpu_torch.input_service import (InputService,
                                                         RecordFileDataset)
    os.environ["MXTPU_FUSED_RESNET"] = "1"
    os.environ["MXTPU_BN_IMPL"] = "plain"
    out = {}
    shm0 = set(glob.glob("/dev/shm/mxtpu*"))
    tmp = tempfile.mkdtemp(prefix="mxtpu_input_service_")
    try:
        path = os.path.join(tmp, "imagenet_raw.rec")
        secs, size = _write_input_records(recordio, path, raw=True)
        ds = RecordFileDataset(path, transform=_raw_transform())

        def service(**kw):
            return InputService(ds, RESNET_BATCH, shuffle=True,
                                seed=SEED + 28, **kw)
        with mx.cpu(), service(num_workers=0) as svc:
            truth = [_batch_hash(b) for b in svc]
        out["records"] = {"seconds": secs, "bytes": size,
                          "steps_an_epoch": len(truth)}
        # the lane
        gc.collect()
        torch.cuda.empty_cache()
        net, step, params, aux, opt, _x, _y = _resnet_setup(
            mx, gluon, vision, SEED + 28, RESNET_BATCH, torch.bfloat16)
        del _x, _y
        state = (params, aux, opt)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 28)
        svc = service(num_workers=INPUT_SERVICE_WORKERS)

        def epochs():
            for e in range(INPUT_EPOCHS):
                svc.set_epoch(e)
                svc.reset()
                yield from svc
        pf = io.DevicePrefetcher(epochs(), depth=2)
        delivered, losses, waits, marks = [], [], [0.0], []

        def run(n):
            nonlocal state
            for _ in range(n):
                t0 = time.perf_counter()
                batch = next(pf)
                waits[0] += time.perf_counter() - t0
                if len(delivered) < len(truth):
                    delivered.append(_batch_hash(batch))
                x_u8, y = _xy(batch)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                *state, loss = step(*state, _lane_x(image, x_u8, gen),
                                    y.to(torch.int32))
                ev[1].record()
                marks.append(ev)
                losses.append(loss)
        t0 = time.perf_counter()
        run(INPUT_SERVICE_WORKERS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        common.reset_launch_counts()
        waits[0] = 0.0
        del marks[:]
        t0 = time.perf_counter()
        run(INPUT_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        per_step = _check_conv_counts(common, "input service lane",
                                      INPUT_TIMED)
        for name, n in common.sm90_launch_counts().items():
            if name in RESNET_CONV_PER_STEP:
                records[f"{name}/sm90"].setdefault("launches_by_phase", {})[
                    "28"] = n
        starvation = svc.starvation_share()
        stats = svc.stats()
        pf.close()
        svc.close()
        reports = list(svc.worker_reports)
        del pf
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"input service: losses {losses}")
        if delivered != truth:
            raise AssertionError("input service: the first epoch's "
                                 "delivered batches differ from the inline "
                                 "service's")
        if len(reports) != INPUT_SERVICE_WORKERS or any(
                r["cuda_initialized"] for r in reports):
            raise AssertionError(f"input service workers' reports {reports}")
        lane = {"img_s": INPUT_TIMED * RESNET_BATCH / wall,
                "step_ms": wall / INPUT_TIMED * 1e3,
                "dataloader_img_s_phase26": loader_img_s,
                "synthetic_img_s_phase14": synthetic_img_s,
                "starvation_share": starvation,
                "input_wait_share": waits[0] / wall,
                "device_busy_share": busy / wall, "warmup_s": warm_s,
                "launches_per_step": per_step, "stats": stats,
                "first_epoch_bitwise": True, "losses": losses,
                "worker_reports": reports}
        log(f"input service lane: {INPUT_SERVICE_WORKERS} warm-up steps in "
            f"{warm_s:.2f} s (the workers' start, the capture), then "
            f"{INPUT_TIMED} steps in {wall:.3f} s, {lane['img_s']:.1f} img/s "
            f"against phase 26's DataLoader lane {loader_img_s} and phase "
            f"14's synthetic {synthetic_img_s}; starvation_share "
            f"{starvation:.4f}, input wait {lane['input_wait_share']:.4f}, "
            f"card busy {lane['device_busy_share']:.4f}; fused-conv "
            f"launches a step {per_step} (all on sm90); stats {stats}")
        del step, state, net, params, aux, opt
        out["lane"] = lane
        # a scripted worker kill
        seed = _kill_seed(INPUT_SERVICE_KILL_PROB, INPUT_SERVICE_WORKERS)
        restarts = telemetry.counter("mxtpu_io_worker_restarts_total")
        r0 = restarts.value(reason="exit", pool="input_service")
        os.environ["MXTPU_CHAOS"] = \
            f"io.worker_kill:{INPUT_SERVICE_KILL_PROB}:{seed}"
        try:
            svc = service(num_workers=INPUT_SERVICE_WORKERS, max_restarts=4)
            with mx.cpu():
                killed = [_batch_hash(b) for b in svc]
            kstats = svc.stats()
            svc.close()
        finally:
            os.environ.pop("MXTPU_CHAOS", None)
        moved = restarts.value(reason="exit", pool="input_service") - r0
        out["worker_kill"] = {"chaos_seed": seed, "stats": kstats,
                              "restart_counter_moved": moved,
                              "stream_bitwise": killed == truth}
        log(f"input service under a scripted io.worker_kill: "
            f"{json.dumps(out['worker_kill'])}")
        if killed != truth or kstats["restarts"] != 1 or moved != 1:
            raise AssertionError(f"input service worker kill: "
                                 f"{out['worker_kill']}")
        # a corrupt record
        uri, offset = ds.describe(5)
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(b"\xde\xad\xbe\xef")
        qfile = os.path.join(tmp, "quarantine.jsonl")
        skipped = telemetry.counter("mxtpu_io_records_skipped_total")
        s0 = skipped.value(reason="invalid magic")
        with mx.cpu(), InputService(ds, RESNET_BATCH, num_workers=0,
                                    quarantine=qfile) as svc:
            n = sum(1 for _ in svc)
        with open(qfile) as f:
            lines = [json.loads(line) for line in f]
        out["quarantine"] = {"steps": n, "entries": lines,
                             "counter_moved": skipped.value(
                                 reason="invalid magic") - s0}
        log(f"input service with record 5 corrupted: "
            f"{json.dumps(out['quarantine'])}")
        if n != len(truth) or len(lines) != 1 or lines[0]["uri"] != uri \
                or lines[0]["offset"] != offset \
                or out["quarantine"]["counter_moved"] != 1:
            raise AssertionError(f"input service quarantine "
                                 f"{out['quarantine']} (want {uri} @ "
                                 f"{offset})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    left = sorted(set(glob.glob("/dev/shm/mxtpu*")) - shm0)
    out["shm_segments_left"] = left
    if left:
        raise AssertionError(f"input service left shared memory {left}")
    return out


# ------------------------------------------------ the zoo families served
#: (get_model name, input side): full width, 1000 classes
ZOO_SERVED = (("alexnet", 224), ("densenet121", 224), ("squeezenet1.1", 224),
              ("inceptionv3", 299), ("mobilenet1.0", 224),
              ("mobilenetv2_1.0", 224))
ZOO_BUCKETS = (1, 8, 32)
ZOO_LOOPED = ("mobilenetv2_1.0", "inceptionv3")


def zoo_serving_phase(mx, vision):
    """Phase 29: the five other ``model_zoo.vision`` families served.

    Each of ``alexnet``, ``densenet121``, ``squeezenet1.1``,
    ``inceptionv3`` (299 x 299), ``mobilenet1.0`` and ``mobilenetv2_1.0``
    at full width (1000 classes, default init from a seed), float32,
    through ``InferenceEngine.load_model(name, net=..., item_shape=...,
    buckets=(1, 8, 32))``: ``mxtpu_serve_compiles_total`` moves by
    ``len(buckets)`` at load and not under traffic; each bucket's replay
    equals the net's eager inference forward bit for bit, full and half
    full, and real rows are bit-stable under zero and random padding
    (:func:`_bucket_checks`, which also times each bucket's replay and
    eager forward in turns); 64 closed-loop clients x 10 requests
    (img/s, p50, p99) for ``mobilenetv2_1.0`` and ``inceptionv3``, 8
    requests for the others."""
    from incubator_mxnet_tpu_torch import serving, telemetry
    compiles = telemetry.counter("mxtpu_serve_compiles_total")
    res = {}
    eng = serving.InferenceEngine(max_batch=32,
                                  max_wait_ms=SERVE_MAX_WAIT_MS,
                                  device="cuda")
    try:
        for i, (name, side) in enumerate(ZOO_SERVED):
            shape = (3, side, side)
            mx.random.seed(SEED + 290 + i)
            with mx.gpu(0):
                net = vision.get_model(name)
                net.initialize()
                net(mx.nd.zeros((1,) + shape))
            c0 = compiles.value(model=name)
            t0 = time.perf_counter()
            ep = eng.load_model(name, net=net, item_shape=shape,
                                buckets=ZOO_BUCKETS, max_batch=32)
            load_ms = (time.perf_counter() - t0) * 1e3
            at_load = compiles.value(model=name) - c0
            xs = _serve_images(SEED + 291 + i, 64, shape)
            rec = {"load_ms": load_ms, "compiles_at_load": at_load,
                   "buckets": _bucket_checks(mx, net, ep.model, xs, name,
                                             SEED + 292 + i)}
            clients, per = (64, 10) if name in ZOO_LOOPED else (8, 1)
            wall, recs = _closed_loop(ep, xs, clients, per)
            rec["loop"] = {"clients": clients,
                           **_loop_stats(wall, recs, f"{name} loop")}
            rec["compiles_after_traffic"] = compiles.value(model=name) - c0
            if at_load != len(ZOO_BUCKETS) \
                    or rec["compiles_after_traffic"] != len(ZOO_BUCKETS):
                raise AssertionError(f"{name}: compiles {at_load} at load, "
                                     f"{rec['compiles_after_traffic']} after "
                                     f"traffic, want {len(ZOO_BUCKETS)}")
            log(f"zoo serving {name}: loaded in {load_ms:.0f} ms with "
                f"{at_load} captures; loop {json.dumps(rec['loop'])}")
            res[name] = rec
            eng.unload(name)
            del net, ep
            gc.collect()
    finally:
        eng.close()
    return res


# --------------------------------------------- the bucketed word LM
LM_BUCKETS = (10, 20, 35)
LM_BUCKET_STEPS = 5


def bucketed_lm_phase(mx, common, records):
    """Phase 30: phase 18's word LM (``RNNModel("lstm", 33278, 650, 2
    layers)``, dropout 0.5, bf16 on float32 masters, SGD lr 1.0) fed by
    ``WikiText2``'s synthetic corpus (no local file) through
    ``rnn.encode_sentences`` (its lines as sentences, the dataset's
    vocabulary, padding 0) and ``rnn.BucketSentenceIter(buckets=[10, 20,
    35], batch_size=128, layout="TN")`` (the (T, N) batches the word LM
    takes), trained through ``make_train_step``, which captures one CUDA
    graph a bucket key: one epoch; exactly 3 captures
    (``step._cache_size()``); then a step at each bucket launches 2 T
    ``lstm_fwd_gates`` and 2 T ``lstm_bwd`` (4 T, forward and backward
    of 2 layers), all on the tensor-core route; finite losses; tok/s at
    each bucket (5 replays of one batch); and with dropout 0, one
    captured step at T 35 from a state equals the eager step
    (``_capture=False``, phase 18's yardstick) from the same state, bit
    for bit."""
    import random
    import tempfile
    from incubator_mxnet_tpu_torch import rnn
    from incubator_mxnet_tpu_torch.gluon.contrib.data import WikiText2
    from incubator_mxnet_tpu_torch.gluon.contrib.data import text as wt
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as root, mx.cpu():
        vocab = WikiText2(root=root, segment="train").vocabulary
    sentences = [line.split() for line in
                 wt._synthetic_corpus("train").splitlines()]
    coded, _ = rnn.encode_sentences(sentences, vocab=dict(
        vocab.token_to_idx), invalid_label=0)
    random.seed(SEED + 30)
    np.random.seed(SEED + 30)
    with mx.gpu(0):
        it = rnn.BucketSentenceIter(coded, LM_N, buckets=list(LM_BUCKETS),
                                    invalid_label=0, dtype="int32",
                                    layout="TN")
    if tuple(it.buckets) != LM_BUCKETS:
        raise AssertionError(f"BucketSentenceIter buckets {it.buckets}")
    net, step, params, aux, opt, _x, _y = _word_lm(mx, SEED + 30, 0.5,
                                                   torch.bfloat16)
    del _x, _y
    state = (params, aux, opt)
    losses, by_key = [], {}
    t0 = time.perf_counter()
    for batch in it:
        x, y = batch.data[0]._data, batch.label[0]._data
        *state, loss = step(*state, x, y)
        losses.append(loss)
        by_key.setdefault(batch.bucket_key, (x, y))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    captures = step._cache_size()
    out["epoch"] = {"steps": len(losses), "seconds": epoch_s,
                    "captures": captures,
                    "batches_by_bucket": {
                        str(b): sum(1 for i, _ in it.idx
                                    if it.buckets[i] == b)
                        for b in LM_BUCKETS}}
    log(f"bucketed word LM: one epoch {json.dumps(out['epoch'])}; losses "
        f"{[round(v, 4) for v in losses[:3]]} ... "
        f"{[round(v, 4) for v in losses[-3:]]}")
    if captures != len(LM_BUCKETS) or not all(np.isfinite(losses)):
        raise AssertionError(f"bucketed word LM: {captures} captures, "
                             f"losses finite {all(np.isfinite(losses))}")
    out["buckets"] = {}
    for T in LM_BUCKETS:
        x, y = by_key[T]
        common.reset_launch_counts()
        *state, loss = step(*state, x, y)
        torch.cuda.synchronize()
        got, got90 = common.launch_counts(), common.sm90_launch_counts()
        want = {"lstm_fwd_gates": 2 * T, "lstm_bwd": 2 * T}
        if any(got[k] != n or got90[k] != n for k, n in want.items()) \
                or got["lstm_fwd"]:
            raise AssertionError(f"bucketed word LM at T {T}: launches "
                                 f"{got}, tensor-core {got90}, want {want}")
        for k in want:
            records[f"{k}/sm90"].setdefault("launches_by_phase", {})[
                f"30/T{T}"] = got90[k]
        ms, state, more = _timed_steps(step, tuple(state), x, y,
                                       LM_BUCKET_STEPS)
        if not all(np.isfinite([float(v) for v in more])):
            raise AssertionError(f"bucketed word LM at T {T}: losses")
        out["buckets"][T] = {"step_ms": ms,
                             "tok_s": T * LM_N * 1e3 / ms,
                             "lstm_launches_per_step": 4 * T}
    log(f"bucketed word LM, each bucket's step: "
        f"{json.dumps(out['buckets'])} (4 T LSTM launches a step, all on "
        f"the tensor-core route)")
    if step._cache_size() != len(LM_BUCKETS):
        raise AssertionError("bucketed word LM: traffic captured again")
    del step, state, net, params, aux, opt
    # dropout 0: a captured T 35 step against the eager one, same state
    znet, zstep, zp, za, zo, _, _ = _word_lm(mx, SEED + 30, 0.0,
                                             torch.bfloat16)
    zeager, *_ = _lm_yardstick(mx, znet, torch.bfloat16)
    zsnap = tuple(_clone(t) for t in (zp, za, zo))
    x, y = by_key[35]
    _one_step_from(zstep, zsnap, x, y)
    out["t35_captured_vs_eager"] = _agreement(
        "bucketed word LM dropout 0: a captured T 35 step vs the eager "
        "step, same state", _one_step_from(zstep, zsnap, x, y),
        _one_step_from(zeager, zsnap, x, y))
    if not out["t35_captured_vs_eager"]["bitwise"]:
        raise AssertionError(f"bucketed word LM: captured and eager steps "
                             f"differ {out['t35_captured_vs_eager']}")
    del znet, zstep, zeager, zsnap, zp, za, zo
    return out


#: reserved minus allocated after a phase that ``_memory_held`` explains
MEMORY_SLACK_BYTES = 2e9


# ------------------------------------------------ the fused trainer step
MT_KERNELS = ("multi_tensor_update", "multi_tensor_all_finite",
              "row_sparse_update")
MT_SOURCE = "incubator_mxnet_tpu_torch/ops/cuda/csrc/multi_tensor.cu"
_FUSED_PY = "incubator_mxnet_tpu/optimizer/fused.py"
# no Pallas kernel stands behind them: the reference's fused step is one
# XLA program (_tree_step, _census, row_slice_step)
MT_REPLACES = {"multi_tensor_update": f"{_FUSED_PY}:149",
               "multi_tensor_all_finite": f"{_FUSED_PY}:184",
               "row_sparse_update": f"{_FUSED_PY}:54"}
# bench.py's bench_trainer_step lane: three optimizer settings over
# ResNet-50's parameter shapes, each with the bytes a parameter the
# update must move (inputs read once, outputs written once): SGD with
# momentum reads w, g, mom and writes w, mom; Adam reads w, g, m, v and
# writes w, m, v; float16 weights with float32 masters read the master,
# the float16 g and mom and write the master, mom and the float16 weight
MT_LANE = {"sgd_mom f32": ("sgd", {"learning_rate": 1e-4, "momentum": 0.9},
                           torch.float32, 20),
           "adam f32": ("adam", {"learning_rate": 1e-3}, torch.float32, 28),
           "sgd_mom f16 master": ("sgd", {"learning_rate": 1e-4,
                                          "momentum": 0.9,
                                          "multi_precision": True},
                                  torch.float16, 20)}
MT_STEPS, MT_EQ_STEPS, MT_BULK = 30, 10, 40
EMB_ROWS, EMB_DIM, EMB_BATCH = 33278, 650, (35, 128)   # phase 18's


def resnet50_param_shapes():
    """bench.py's ``_resnet50_param_shapes``: ResNet-50's parameter tree
    (161 tensors, 25,557,032 values): the stem conv and BN, 16 bottleneck
    blocks (3 convs and 3 BN pairs, a projection on each stage's first
    block) and the fc head."""
    shapes = [(7, 7, 3, 64), (64,), (64,)]
    for cin, mid, cout, blocks in ((64, 64, 256, 3), (256, 128, 512, 4),
                                   (512, 256, 1024, 6), (1024, 512, 2048, 3)):
        for b in range(blocks):
            icin = cin if b == 0 else cout
            shapes += [(1, 1, icin, mid), (mid,), (mid,),
                       (3, 3, mid, mid), (mid,), (mid,),
                       (1, 1, mid, cout), (cout,), (cout,)]
            if b == 0:
                shapes += [(1, 1, icin, cout), (cout,), (cout,)]
    return shapes + [(2048, 1000), (1000,)]


def _bits(t):
    """A tensor's bits, for equality to the last bit (NaN included)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(a, b):
    return len(a) == len(b) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _max_abs_err(a, b):
    """The largest |x - y| over two lists of tensors (float32)."""
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               if x.numel() else 0.0 for x, y in zip(a, b))


def _updater_tensors(upd, ws):
    """Every weight and optimizer-state tensor an Updater holds."""
    from incubator_mxnet_tpu_torch.optimizer.optimizer import _state_tensors
    from incubator_mxnet_tpu_torch.ops.cuda.multi_tensor import _leaves
    out = [w._data for w in ws]
    for i in sorted(upd.states):
        out += [t for t in _leaves(_state_tensors(upd.states[i]))
                if t is not None]
    return out


def _kernel_ms(fn, substr, calls: int = 5, rounds: int = 4):
    """From torch.profiler over ``calls`` calls of ``fn`` (no CUDA graph:
    the fused step copies its table from pinned host memory at every
    call): the mean device ms of one launch of the kernels whose names
    hold ``substr`` (launched once a call; a window can lose records, so
    the mean over the records kept), and the device ms of every kernel of
    a call (their sum over the window by ``calls``). A window whose
    records hold no such kernel is profiled again behind more warm-up
    windows, up to ``rounds`` times ``_device_events``' tries; after that
    it raises: the time is measured or the phase fails."""
    def window():
        for _ in range(calls):
            fn()
    for attempt in range(rounds):
        dev, _ = _device_events(window, widened=3 * attempt)
        mine = [e for e in dev or () if substr in e.key]
        if mine:
            break
        log(f"_kernel_ms: no record of {substr!r} (round {attempt + 1} of "
            f"{rounds})")
    else:
        raise AssertionError(f"_kernel_ms: the profiler kept no record of "
                             f"{substr!r} in {rounds} rounds of windows")
    kept = sum(e.count for e in mine)
    if kept < calls:
        log(f"_kernel_ms: the window kept {kept} records of {calls} "
            f"launches of {substr!r}")
    mean = (sum(e.self_device_time_total for e in mine) / kept / 1e3
            if kept else None)
    total = sum(e.self_device_time_total for e in dev)
    return mean, total / calls / 1e3


def _mt_kernel_name(mangled):
    m = re.search(r"(multi_tensor_update_kernel|multi_tensor_all_finite_"
                  r"kernel|row_sparse_update_kernel)(?:ILi(\d)E(\w*?)EEv)?",
                  mangled)
    if not m:
        return mangled[:40]
    kind = f"<{m.group(2)}{', ' + m.group(3) if m.group(3) else ''}>" \
        if m.group(2) else ""
    return m.group(1) + kind


def mt_sass_check(common):
    """The fused step's kernels as built (15: 5 update rules, the census,
    3 row rules x 3 types): registers, no local (spill) bytes and no stack
    (``_sass_kernels``, every kernel loading with LDG), and no FFMA in the
    SGD and NAG kernels: the update keeps PyTorch's separate multiply and
    add, so the compiler must not contract them."""
    kernels = _sass_kernels(common, "multi_tensor*.o", _mt_kernel_name,
                            "LDG", no_stack=True)
    from torch.utils.cpp_extension import CUDA_HOME
    obj = sorted(common.BUILD_DIR.glob("multi_tensor*.o"))[0]
    sass = subprocess.run([f"{CUDA_HOME or '/usr/local/cuda'}/bin/cuobjdump",
                           "-sass", str(obj)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    ffma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _mt_kernel_name(m.group(1))
            ffma[name] = 0
        elif name and re.search(r"\bFFMA\b", line):
            ffma[name] += 1
    # the correctly rounded division and square root (Adam, AdamW) are
    # FFMA sequences of their own; the SGD and NAG rules have neither,
    # so an FFMA there would be a contracted multiply and add
    contracted = {k: v for k, v in ffma.items()
                  if re.search(r"<[012]", k) and v}
    if len(kernels) != 15 or contracted:
        raise AssertionError(f"multi_tensor kernels {sorted(kernels)} (15 "
                             f"wanted), FFMA in the SGD/NAG kernels "
                             f"{contracted} (none wanted)")
    log(f"multi_tensor FFMA counts (division and square root only): "
        f"{json.dumps(ffma)}")
    return {"kernels": len(kernels),
            "registers": sorted({k["reg"] for k in kernels.values()}),
            "local_bytes": sorted({k["local"] for k in kernels.values()}),
            "ffma": ffma}


def _lane_tensors(mx, dt, device="cuda"):
    """bench.py's lane on the card: weights Uniform(-1, 1) and gradients
    Uniform(-1, 1) * 1e-3 from RandomState(0), in ``dt``."""
    shapes = resnet50_param_shapes()
    rs = np.random.RandomState(0)
    w0 = [torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32)).to(
        device, dt) for s in shapes]
    gs = [mx.nd.from_torch(torch.from_numpy(
        (rs.uniform(-1, 1, s) * 1e-3).astype(np.float32)).to(device, dt))
        for s in shapes]
    return w0, gs


def trainer_lane(mx, common, label, nan_check=False):
    """One setting of bench.py's ``bench_trainer_step`` lane (161
    tensors): fused, chunked (``set_bulk_size(40)``) and per-parameter
    Updaters stepped 10 times from the same weights and held equal bit
    for bit; the launches of a step (1 update; 1 census + 1 update with
    ``census=True``; 5 updates at bulk 40); steps/s of the fused and the
    per-parameter paths in turns (30 timed steps after a warm-up, 2
    rounds); the kernel's device ms (profiler) beside its bound, the
    per-tensor twin and ``torch._fused_sgd_`` / ``torch._fused_adam_``;
    with ``nan_check``, a NaN in the last gradient under the census
    (and the sync debug mode at "error": nothing in the step may sync the
    host) leaves every weight and state bit-identical, and a guard reads
    the census at its next step."""
    from incubator_mxnet_tpu_torch import engine
    from incubator_mxnet_tpu_torch.optimizer import optimizer as O
    from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    name, kw, dt, per_param_bytes = MT_LANE[label]
    w0, gs = _lane_tensors(mx, dt)
    idx = list(range(len(w0)))
    n_params = sum(w.numel() for w in w0)
    if len(w0) != 161 or n_params != 25557032:
        raise AssertionError(f"ResNet-50 lane: {len(w0)} tensors, "
                             f"{n_params} values")
    paths = ("fused", "chunked", "per_param")
    ws = {p: [mx.nd.from_torch(w.clone()) for w in w0] for p in paths}
    upd = {p: O.get_updater(O.create(name, **kw)) for p in paths}
    bulk = {"fused": None, "chunked": MT_BULK, "per_param": 0}

    def step(p, census=False):
        with engine.bulk(bulk[p]) if bulk[p] is not None \
                else contextlib.nullcontext():
            return upd[p].update_batch(idx, gs, ws[p], census=census)
    common.reset_launch_counts()
    for _ in range(MT_EQ_STEPS):
        for p in paths:
            step(p)
    torch.cuda.synchronize()
    launches = common.launch_counts()
    got = {p: _updater_tensors(upd[p], ws[p]) for p in paths}
    equal = {p: _same_bits(got["fused"], got[p]) for p in paths[1:]}
    max_abs_err = _max_abs_err(got["fused"], got["per_param"])
    want = {"multi_tensor_update": MT_EQ_STEPS * (1 + -(-161 // MT_BULK))}
    if not all(equal.values()) or {k: v for k, v in launches.items()
                                   if v} != want:
        raise AssertionError(f"{label}: fused equal to {equal} (worst "
                             f"{max_abs_err}); launches {launches}, want "
                             f"{want}")
    per_step = {}
    for tag, fn in (("whole", lambda: step("fused")),
                    ("census", lambda: step("fused", census=True)),
                    (f"bulk {MT_BULK}", lambda: step("chunked"))):
        common.reset_launch_counts()
        ok = fn()
        per_step[tag] = {k: v for k, v in common.launch_counts().items()
                         if v}
        if tag == "census":
            twin = mt.all_finite_reference([g._data for g in gs])
            census_err = abs(int(ok._data) - int(twin))
            if census_err:
                raise AssertionError(f"{label}: the census kernel read "
                                     f"{ok.asnumpy()}, its twin {twin}")
    expect = {"whole": {"multi_tensor_update": 1},
              "census": {"multi_tensor_all_finite": 1,
                         "multi_tensor_update": 1},
              f"bulk {MT_BULK}": {"multi_tensor_update": 5}}
    if per_step != expect:
        raise AssertionError(f"{label}: launches a step {per_step}, want "
                             f"{expect}")
    # steps/s in turns: fused, per-parameter, per-parameter, fused
    rate = {"fused": [], "per_param": []}
    for order in (("fused", "per_param"), ("per_param", "fused")):
        for p in order:
            step(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MT_STEPS):
                step(p)
            torch.cuda.synchronize()
            rate[p].append(MT_STEPS / (time.perf_counter() - t0))
    kernel_ms, fused_dev_ms = _kernel_ms(lambda: step("fused"),
                                         "multi_tensor_update")
    _, per_param_dev_ms = _kernel_ms(lambda: step("per_param"), "", 2)
    step_host_us = host_us(lambda: step("fused"))
    census_ms, _ = _kernel_ms(lambda: step("fused", census=True),
                              "all_finite")
    # the per-tensor twin (the fused step's plain version) on the card
    opt = upd["fused"].optimizer
    sts = [O._state_tensors(upd["fused"].states[i]) for i in idx]
    masters = [s[0] if dt == torch.float16 else None for s in sts]
    subs = [s[1] if dt == torch.float16 else s for s in sts]
    hs = [opt.fused_hypers(i) for i in idx]
    plain_ms = time_ms(lambda: mt.multi_tensor_update_reference(
        opt.tensor_step, [w._data for w in ws["fused"]],
        [g._data for g in gs], subs, hs, masters), iters=3, warmup=1)
    census_plain_ms = time_ms(lambda: mt.all_finite_reference(
        [g._data for g in gs]), iters=3, warmup=1)
    library_ms, census_lib_ms = _library_step(name, kw, w0, gs)
    moved = n_params * per_param_bytes
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    census_bound = n_params * gs[0]._data.element_size() / HBM_BYTES_PER_S \
        * 1e3
    out = {"tensors": len(w0), "params": n_params,
           "fused_steps_per_s": sum(rate["fused"]) / 2,
           "per_param_steps_per_s": sum(rate["per_param"]) / 2,
           "steps_per_s_rounds": rate, "launches_per_step": per_step,
           "equal_after_steps": MT_EQ_STEPS,
           "kernel_device_ms": kernel_ms, "fused_step_device_ms":
           fused_dev_ms, "per_param_step_device_ms": per_param_dev_ms,
           "fused_step_host_us": step_host_us, "plain_ms": plain_ms,
           "bytes": moved, "bound_ms": bound_ms, "library_ms": library_ms,
           "census_device_ms": census_ms, "census_plain_ms":
           census_plain_ms, "census_bound_ms": census_bound,
           "census_library_ms": census_lib_ms,
           "max_abs_err": max_abs_err, "census_max_abs_err": census_err}
    if nan_check:
        out["nan_step"] = _nan_step(mx, upd["fused"], ws["fused"], gs, idx)
    log(f"trainer lane {label}: {json.dumps(out)}")
    return out


def _nan_step(mx, upd, ws, gs, idx):
    """A NaN planted in the last gradient: with the census, the step
    leaves every weight and state bit-identical, syncs nothing (the sync
    debug mode at "error" raises on a synchronising call), and a guard
    given the census trips at its next step."""
    from incubator_mxnet_tpu_torch.guard import GuardPolicy, TrainingGuard
    poisoned = [g.copy() for g in gs]
    poisoned[-1]._data.view(-1)[7] = float("nan")
    before = [t.clone() for t in _updater_tensors(upd, ws)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ok = upd.update_batch(idx, poisoned, ws, census=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    intact = _same_bits(before, _updater_tensors(upd, ws))
    guard = TrainingGuard(GuardPolicy(skip_limit=5))
    guard.note_device_census(ok)
    proceed = guard.fused_grads_ok(None)
    tripped = [(e.kind, e.detail) for e in guard.events]
    if bool(ok.asnumpy()) or not intact or not proceed \
            or tripped != [("nan", "fused census (device)")]:
        raise AssertionError(f"NaN step: census {ok.asnumpy()}, state "
                             f"intact {intact}, guard {tripped}")
    return {"census": False, "state_intact": True, "host_syncs": 0,
            "guard_events": tripped}


def _library_step(name, kw, w0, gs):
    """Event ms of the one PyTorch call that does comparable work on the
    same tensors (``torch._fused_sgd_`` / ``torch._fused_adam_``: their
    rules differ from MXNet's, a yardstick of time, not of values), and of
    ``torch._amp_foreach_non_finite_check_and_unscale_`` for the census.
    None where the call is refused (logged)."""
    params = [w.clone() for w in w0]
    grads = [g._data for g in gs]
    lib = None
    try:
        if name == "sgd":
            bufs = [torch.zeros_like(p) for p in params]
            lib = time_ms(lambda: torch._fused_sgd_(
                params, grads, bufs, weight_decay=0.0, momentum=0.9,
                lr=kw["learning_rate"], dampening=0.0, nesterov=False,
                maximize=False, is_first_step=False), iters=10, warmup=2)
        else:
            m = [torch.zeros_like(p) for p in params]
            v = [torch.zeros_like(p) for p in params]
            steps = [torch.ones((), device=p.device) for p in params]
            lib = time_ms(lambda: torch._fused_adam_(
                params, grads, m, v, [], steps, lr=kw["learning_rate"],
                beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                amsgrad=False, maximize=False), iters=10, warmup=2)
    except (RuntimeError, TypeError) as err:
        log(f"library step for {name}: refused ({err})")
    found = torch.zeros(1, device="cuda")
    inv = torch.ones(1, device="cuda")
    copies = [g.clone() for g in grads]
    census = time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        copies, found, inv), iters=10, warmup=2)
    del params, copies
    return lib, census


#: dtype_matrix's rules: (optimizer, options, kernel rule); Adam's and
#: AdamW's epsilon 1e-3, a value float16 holds (their default 1e-8 rounds
#: to 0 there, and a zero second moment then makes 0 / 0)
MT_RULES = (("sgd", {"wd": 1e-4}, "sgd"),
            ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}, "sgd_mom"),
            ("nag", {"momentum": 0.9}, "nag"),
            ("adam", {"wd": 1e-4, "epsilon": 1e-3}, "adam"),
            ("adamw", {"wd": 0.01, "epsilon": 1e-3}, "adamw"))
MT_STORAGE = {"f32": (torch.float32, False), "f16": (torch.float16, False),
              "bf16": (torch.bfloat16, False),
              "f16 master": (torch.float16, True)}


def dtype_matrix(mx, common, steps=10):
    """Every rule of ``multi_tensor_update`` in every storage it takes
    (float32, float16, bfloat16, float16 with float32 masters): fused and
    per-parameter Updaters stepped ``steps`` times over four tensors (one
    straddling two 16,384-element chunks) from the same weights and
    gradients Uniform(-1, 1), learning rate 1e-3: every weight and state
    finite and equal bit for bit, one launch a fused step."""
    from incubator_mxnet_tpu_torch.optimizer import optimizer as O
    shapes = [(2 * 16384 + 5,), (7, 3), (130, 129), (64,)]
    rs = np.random.RandomState(SEED + 33)
    w_np = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    g_np = [[rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
            for _ in range(steps)]
    res, worst = {}, 0.0
    for name, kw, kind in MT_RULES:
        for tag, (dt, mp) in MT_STORAGE.items():
            ws, upd = {}, {}
            for p in ("fused", "per_param"):
                ws[p] = [mx.nd.from_torch(torch.from_numpy(w).to(
                    "cuda", dt)) for w in w_np]
                upd[p] = O.get_updater(O.create(
                    name, learning_rate=1e-3, multi_precision=mp, **kw))
            common.reset_launch_counts()
            for gs_np in g_np:
                gs = [mx.nd.from_torch(torch.from_numpy(g).to("cuda", dt))
                      for g in gs_np]
                upd["fused"].update_batch(list(range(len(shapes))), gs,
                                          ws["fused"])
                for i, g in enumerate(gs):
                    upd["per_param"](i, g, ws["per_param"][i])
            torch.cuda.synchronize()
            launches = common.launch_counts()["multi_tensor_update"]
            got = {p: _updater_tensors(upd[p], ws[p]) for p in ws}
            err = _max_abs_err(got["fused"], got["per_param"])
            finite = all(bool(torch.isfinite(t).all())
                         for t in got["fused"] + got["per_param"])
            same = _same_bits(got["fused"], got["per_param"])
            res[f"{kind} {tag}"] = {"equal": same, "finite": finite,
                                    "max_abs_err": err,
                                    "launches": launches}
            worst = max(worst, err)
            if not (same and finite) or launches != steps:
                raise AssertionError(f"{kind} {tag}: fused equal {same} "
                                     f"(worst {err}), finite {finite}, "
                                     f"{launches} launches for {steps} "
                                     "steps")
    log(f"multi_tensor rules x storage, {steps} steps: {json.dumps(res)}")
    return {"cases": res, "max_abs_err": worst}


def hybrid_eval_after_step(mx, gluon, common, batch=32):
    """The usual Gluon loop on the card: a hybridized MLP (2048 -> 1024
    -> 1000) evaluated outside ``record()`` (its forward one captured
    graph over static copies of the parameters), a fused ``Trainer.step``
    (SGD with momentum: one ``multi_tensor_update``, in place), and an
    evaluation again, three times. The kernel bumps the version of what
    it writes, so the compiled forward copies the stepped weights in: its
    static copies equal the live parameters bit for bit after each
    evaluation, and its output is within 1e-5 of the largest entry of
    the eager forward's (and whether equal bit for bit) and moved from
    the output before the step."""
    rs = np.random.RandomState(SEED + 34)
    mx.random.seed(SEED + 34)
    with mx.gpu(0):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(1024, in_units=2048, activation="relu"),
                gluon.nn.Dense(1000, in_units=1024))
        net.initialize(mx.init.Xavier())
        x = mx.nd.array(rs.rand(batch, 2048).astype(np.float32))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    params = list(net.collect_params().values())
    rounds = []
    for _ in range(3):
        before = net(x)._data.clone()
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        common.reset_launch_counts()
        trainer.step(batch)
        torch.cuda.synchronize()
        launches = common.launch_counts()["multi_tensor_update"]
        got = net(x)._data.clone()
        static_fresh = _same_bits(net._static.static,
                                  [p.data()._data for p in params])
        net.hybridize(False)
        eager = net(x)._data.clone()
        net.hybridize()
        scale = float(eager.abs().max())
        err = float((got - eager).abs().max()) / scale
        moved = float((got - before).abs().max()) / scale
        rounds.append({"launches": launches, "static_fresh": static_fresh,
                       "max_err": err, "bitwise": bool(torch.equal(
                           got, eager)), "moved": moved})
        if launches != 1 or not static_fresh or not err <= 1e-5 \
                or not moved > 1e-3 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"hybridized eval after a fused step: "
                                 f"{rounds}")
    log(f"hybridized eval after fused steps: {json.dumps(rounds)}")
    return rounds


def resnet_trainer_loop(mx, gluon, vision, common, batch=32):
    """The default Gluon loop at full width: ``resnet50_v1`` (NHWC
    parameters, NCHW input), batch 32, 224², float32, SGD momentum 0.9
    under a ``FactorScheduler``, a bound ``TrainingGuard``:
    ``autograd.record()``, ``loss.backward()``, ``Trainer.step``. One
    fused dispatch (one census and one ``multi_tensor_update`` launch) a
    step and no new plan across the schedule; the step ms of the fused and
    per-parameter paths in turns (no guard); the update's share of the
    step's device time; one step of each path applied to the same
    gradients from the same state, equal bit for bit."""
    import copy
    import os
    from incubator_mxnet_tpu_torch import lr_scheduler as lrs
    from incubator_mxnet_tpu_torch.guard import GuardPolicy, TrainingGuard
    from incubator_mxnet_tpu_torch.optimizer import fused
    from incubator_mxnet_tpu_torch.test_utils import assert_no_retrace
    rs = np.random.RandomState(SEED + 31)
    mx.random.seed(SEED + 31)
    with mx.gpu(0):
        net = vision.resnet50_v1(layout="NHWC")
        net.initialize(mx.init.Xavier())
        x = mx.nd.array(rs.rand(batch, 3, 224, 224).astype(np.float32))
        y = mx.nd.array(rs.randint(0, 1000, (batch,)).astype(np.float32))
        net(x[:1])
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "lr_scheduler": lrs.FactorScheduler(
                                 step=1, factor=0.95)})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_backward():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        return loss

    def step():
        loss = forward_backward()
        trainer.step(batch)
        return loss
    step()
    step()
    torch.cuda.synchronize()
    per_path = {}

    def timed(path, steps=3):
        os.environ["MXTPU_FUSED_STEP"] = "1" if path == "fused" else "0"
        try:
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3
        finally:
            os.environ.pop("MXTPU_FUSED_STEP", None)
    for order in (("fused", "per_param"), ("per_param", "fused")):
        for p in order:
            per_path.setdefault(p, []).append(timed(p))
    # the main path's counted run: the loop, fused, with a guard bound (its
    # census a step on the card)
    trainer._guard = TrainingGuard(GuardPolicy()).bind(trainer=trainer)
    step()                  # the census's plan, built once
    torch.cuda.synchronize()
    stats0 = fused.stats()
    common.reset_launch_counts()
    with assert_no_retrace():
        for _ in range(3):
            loss = step()
    torch.cuda.synchronize()
    launches = common.launch_counts()
    stats1 = fused.stats()
    dispatches = stats1["fused_step_dispatches"] - \
        stats0["fused_step_dispatches"]
    if dispatches != 3 or launches["multi_tensor_update"] != 3 \
            or launches["multi_tensor_all_finite"] != 3 \
            or not np.isfinite(float(loss.mean().asscalar())):
        raise AssertionError(f"ResNet-50 Trainer: {dispatches} fused "
                             f"dispatches, launches {launches} over 3 steps")
    breakdown = kernel_breakdown("ResNet-50 Trainer (fused step)", step,
                                 ("multi_tensor_update",
                                  "multi_tensor_all_finite"), steps=2)
    trainer._guard = None
    # one step of each path on the same gradients from the same state
    forward_backward()
    opt = trainer.optimizer
    params = list(net.collect_params().values())
    snap_w = [p._data._data.clone() for p in params]
    upd = trainer._updaters[0]
    state_t = _updater_tensors(upd, [])
    snap_s = [t.clone() for t in state_t]
    snap_opt = (dict(opt._index_update_count), opt.num_update,
                copy.deepcopy(opt.lr_scheduler))
    trainer.step(batch)
    fused_after = [p._data._data.clone() for p in params]
    with torch.no_grad():
        for p, s in zip(params, snap_w):
            p._data._data.copy_(s)
        for t, s in zip(state_t, snap_s):
            t.copy_(s)
    opt._index_update_count, opt.num_update, opt.lr_scheduler = snap_opt
    os.environ["MXTPU_FUSED_STEP"] = "0"
    try:
        trainer.step(batch)
    finally:
        os.environ.pop("MXTPU_FUSED_STEP", None)
    per_after = [p._data._data for p in params]
    if not _same_bits(fused_after, per_after):
        worst = max(float((a - b).abs().max())
                    for a, b in zip(fused_after, per_after))
        raise AssertionError(f"ResNet-50 Trainer: fused and per-parameter "
                             f"steps differ (worst {worst})")
    out = {"batch": batch, "step_ms": {p: sum(v) / len(v)
                                       for p, v in per_path.items()},
           "step_ms_rounds": per_path, "fused_dispatches_per_step": 1,
           "launches_per_step": {"multi_tensor_update": 1,
                                 "multi_tensor_all_finite": 1},
           "plans_built_across_schedule": 0,
           "fused_equals_per_param": True, "loss": float(
               loss.mean().asscalar()),
           "update_share_of_device": (
               breakdown["kernels_ms"] / breakdown["device_busy_ms"]
               if breakdown.get("device_busy_ms") else None),
           "breakdown": breakdown}
    log(f"ResNet-50 Trainer loop: {json.dumps(out)}")
    return out, launches


def row_sparse_path(mx, gluon, common):
    """``Embedding(33278, 650, sparse_grad=True)`` at phase 18's vocabulary
    and width, token ids (35, 128): its row-sparse gradient
    (``row_sparse_grad``, at most 4,480 active rows) through
    ``Updater.update_batch`` with Adam (``lazy_update``) and SGD at
    momentum 0. The main path's run: both steps, counted from zero, one
    ``row_sparse_update`` each. Then each against the twin bit for bit,
    rows not in the batch untouched; the kernel's device ms against the
    dense ``multi_tensor_update`` of the same table, the twin and, for
    SGD, ``index_add_``. Returns (results, the run's launches)."""
    from incubator_mxnet_tpu_torch.optimizer import optimizer as O
    from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    rs = np.random.RandomState(SEED + 32)
    mx.random.seed(SEED + 32)
    with mx.gpu(0):
        emb = gluon.nn.Embedding(EMB_ROWS, EMB_DIM, sparse_grad=True)
        emb.initialize(mx.init.Uniform(0.1))
        ids = mx.nd.array(rs.randint(0, EMB_ROWS, EMB_BATCH).astype(
            np.float32))
        with mx.autograd.record():
            out = emb(ids)
            loss = (out * out).sum()
        loss.backward()
    g = emb.weight.row_sparse_grad()
    active = g.indices
    if g.nnz > EMB_BATCH[0] * EMB_BATCH[1] or not torch.equal(
            active.cpu(), torch.unique(ids._data.long()).cpu()):
        raise AssertionError(f"row_sparse_grad: {g.nnz} rows")
    w0 = emb.weight.data()._data.clone()
    idle = torch.ones(EMB_ROWS, dtype=torch.bool, device="cuda")
    idle[active] = False
    settings = (("adam", {"learning_rate": 1e-3}),
                ("sgd", {"learning_rate": 0.1}))
    steps = {}
    common.reset_launch_counts()
    for name, kw in settings:
        upd = O.get_updater(O.create(name, **kw))
        w = mx.nd.from_torch(w0.clone())
        upd.update_batch([0], [g], [w])
        steps[name] = (upd, w)
    torch.cuda.synchronize()
    launches = {k: v for k, v in common.launch_counts().items() if v}
    if launches != {"row_sparse_update": len(settings)}:
        raise AssertionError(f"row-sparse steps: launches {launches}, one "
                             f"row_sparse_update a step wanted")
    res = {"active_rows": g.nnz, "launches": launches}
    for name, kw in settings:
        upd, w = steps[name]
        twin_opt = O.create(name, **kw)
        tw = w0.clone()
        st = twin_opt.create_state(0, mx.nd.from_torch(tw))
        twin_opt._update_count(0)
        mt.row_sparse_update_reference(
            twin_opt.tensor_step, tw, O._state_tensors(st), g.indices,
            g.data, twin_opt.fused_hypers(0))
        err = _max_abs_err([w._data], [tw])
        same = torch.equal(_bits(w._data), _bits(tw))
        untouched = torch.equal(_bits(w._data[idle]), _bits(w0[idle]))
        if not same or not untouched:
            raise AssertionError(f"row-sparse {name}: equal to the twin "
                                 f"{same} (worst {err}), idle rows "
                                 f"untouched {untouched}")
        kernel_ms, _ = _kernel_ms(lambda: upd.update_batch([0], [g], [w]),
                                  "row_sparse")
        plain_ms = time_ms(lambda: mt.row_sparse_update_reference(
            twin_opt.tensor_step, tw, O._state_tensors(st), g.indices,
            g.data, twin_opt.fused_hypers(0)), iters=5, warmup=1)
        dense = mx.nd.from_torch(g.todense()._data)
        dupd = O.get_updater(O.create(name, **kw))
        dw = mx.nd.from_torch(w0.clone())
        dense_ms, _ = _kernel_ms(lambda: dupd.update_batch([0], [dense],
                                                          [dw]),
                                 "multi_tensor_update")
        per_row = {"adam": 28, "sgd": 12}[name] * EMB_DIM + 8
        bound = g.nnz * per_row / HBM_BYTES_PER_S * 1e3
        lib = None
        if name == "sgd":
            lw = w0.clone()
            lib = time_ms(lambda: lw.index_add_(0, g.indices, g.data,
                                                alpha=-0.1), iters=10)
        res[name] = {"kernel_device_ms": kernel_ms, "plain_ms": plain_ms,
                     "dense_update_device_ms": dense_ms,
                     "bound_ms": bound, "library_ms": lib,
                     "max_abs_err": err, "equal_to_twin": True,
                     "idle_rows_untouched": True}
    log(f"row-sparse path: {json.dumps(res)}")
    return res, launches


def fused_step_phase(mx, gluon, vision, common, records):
    """Phase 31: the fused trainer step (``optimizer/fused.py`` on
    ``multi_tensor.cu``). The kernels as built (``mt_sass_check``);
    bench.py's ``bench_trainer_step`` lane in three settings
    (``trainer_lane``); every rule in every storage type against the
    per-parameter path (``dtype_matrix``); a hybridized net evaluated
    after a fused ``Trainer.step`` (``hybrid_eval_after_step``); the main
    path, counted from zero: the default
    Gluon loop on ResNet-50 (``resnet_trainer_loop``) then the
    row-sparse Embedding step (``row_sparse_path``), which must launch
    each of the three kernels; the kernels' JSON records."""
    sass = mt_sass_check(common)
    lane = {label: trainer_lane(mx, common, label,
                                nan_check=label == "sgd_mom f32")
            for label in MT_LANE}
    dtypes = dtype_matrix(mx, common)
    hybrid = hybrid_eval_after_step(mx, gluon, common)
    loop, loop_launches = resnet_trainer_loop(mx, gluon, vision, common)
    rows, row_launches = row_sparse_path(mx, gluon, common)
    main = {k: loop_launches[k] + row_launches.get(k, 0)
            for k in MT_KERNELS}
    if not all(main.values()):
        raise AssertionError(f"phase 31's main path left a kernel "
                             f"unlaunched: {main}")
    sgd, adam = lane["sgd_mom f32"], rows["adam"]
    for name, ms, plain, bound, lib, err in (
            ("multi_tensor_update", sgd["kernel_device_ms"],
             sgd["plain_ms"], sgd["bound_ms"], sgd["library_ms"],
             max(sgd["max_abs_err"], dtypes["max_abs_err"])),
            ("multi_tensor_all_finite", sgd["census_device_ms"],
             sgd["census_plain_ms"], sgd["census_bound_ms"],
             sgd["census_library_ms"], sgd["census_max_abs_err"]),
            ("row_sparse_update", adam["kernel_device_ms"],
             adam["plain_ms"], adam["bound_ms"], adam["library_ms"],
             max(adam["max_abs_err"], rows["sgd"]["max_abs_err"]))):
        records[name] = {
            "name": name, "route": "cuda", "source": MT_SOURCE,
            "replaces": MT_REPLACES[name], "launches": main[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}
    return {"sass": sass, "lane": lane, "dtypes": dtypes,
            "hybrid_eval": hybrid, "resnet_trainer": loop,
            "row_sparse": rows, "main_path_launches": main}


def _memory_held(phase: str) -> dict:
    """What the caching allocator holds after ``phase``, once Python's
    garbage is collected, cuBLAS's workspaces are dropped (each (thread,
    stream) pair's, made again at its next GEMM; no graph outlives its
    phase) and the cache is emptied: allocated and reserved bytes. Where
    reserved exceeds allocated by more than ``MEMORY_SLACK_BYTES``, the
    log names what holds it: reserved bytes by memory pool (the default
    pool, or a CUDA graph's private pool) and the segments a live block
    pins (their count and bytes, the largest, their streams)."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    alloc = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    rec = {"phase": phase, "allocated_gb": alloc / 1e9,
           "reserved_gb": reserved / 1e9}
    if reserved - alloc > MEMORY_SLACK_BYTES:
        by_pool, pinned = {}, []
        for seg in torch.cuda.memory_snapshot():
            pool = str(tuple(seg.get("segment_pool_id", (0, 0))))
            by_pool[pool] = by_pool.get(pool, 0) + seg["total_size"]
            live = [b["size"] for b in seg["blocks"]
                    if b["state"] == "active_allocated"]
            if live:
                pinned.append((seg["total_size"], sum(live), max(live),
                               seg.get("stream"), pool))
        pinned.sort(key=lambda p: -p[0])
        rec["held_by"] = {
            "reserved_gb_by_pool": {k: v / 1e9 for k, v in by_pool.items()},
            "pinned_segments": len(pinned),
            "pinned_segments_gb": sum(p[0] for p in pinned) / 1e9,
            "live_gb_in_them": sum(p[1] for p in pinned) / 1e9,
            "largest": [{"segment_mb": p[0] / 2 ** 20,
                         "live_mb": p[1] / 2 ** 20,
                         "largest_live_mb": p[2] / 2 ** 20,
                         "stream": p[3], "pool": p[4]}
                        for p in pinned[:5]]}
    log(f"memory held after {phase}: {json.dumps(rec)}")
    return rec


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

    held, t_phase = [], [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        held.append({**_memory_held(name), "seconds": now - t_phase[0]})
        t_phase[0] = now

    records, decode_timing = kernel_checks(fa, common)
    phase_done("phase 3, the decode kernels")
    serve = serving_phase(serving, tt, fa, common, records)
    phase_done("phase 4, serving")
    f32_step_phase(tt, fa)
    phase_done("phase 5, the float32 decode step")
    train_records, timings = train_kernel_checks(fa, common)
    records.update(train_records)
    phase_done("phase 6, the training kernels")
    train = train_phase(tt, fa, records)
    phase_done("phase 7, LM training")
    headmajor_phase(tt, fa)
    phase_done("phase 8, the head-major route")
    f32_train = f32_train_step_phase(tt, fa)
    phase_done("phase 9, the float32 gradient pass")
    row_records, row_timings = row_kernel_checks(ln, sm, common)
    records.update(row_records)
    phase_done("phase 10, the row kernels")
    nd_train = nd_train_phase(tt, nd_lm, mx, common, records)
    phase_done("phase 11, the nd loop")
    nd_truth = nd_truth_phase(tt, nd_lm, mx)
    phase_done("phase 12, the nd truth")
    conv_records, conv_timings = conv_kernel_checks(cf, common)
    records.update(conv_records)
    phase_done("phase 13, the fused-conv kernels")
    resnet = resnet_train_phase(mx, gluon, vision, common, records)
    phase_done("phase 14, ResNet-50 fused")
    perblock = resnet_perblock_phase(mx, gluon, vision, common)
    perblock["hybridized_forward"] = resnet_hybrid_forward(mx, vision,
                                                           common)
    phase_done("phase 15, ResNet-50 per block and hybridized")
    resnet_truth = resnet_truth_phase(mx, gluon, vision, common, records)
    phase_done("phase 16, the ResNet truth")
    lstm_records, lstm_timings = lstm_kernel_checks(lt, common)
    records.update(lstm_records)
    phase_done("phase 17, the LSTM kernels")
    word_lm = word_lm_train_phase(mx, common, records)
    agreement = agreement_check(resnet, resnet_truth, word_lm)
    phase_done("phase 18, the word LM")
    word_lm_truth = word_lm_truth_phase(mx, lt, common, records)
    phase_done("phase 19, the word LM truth")
    det_records, det_timings = detection_kernel_checks(kd, common)
    records.update(det_records)
    phase_done("phase 20, the detection kernels")
    ssd = ssd_train_phase(mx, kd, common, records)
    phase_done("phase 21, SSD-512")
    ssd_truth = ssd_truth_phase(mx, kd, common)
    phase_done("phase 22, the SSD truth and hybridized detect")
    rtc_records, rtc_timings = rtc_kernel_checks(mx)
    records.update(rtc_records)
    mlp = mlp_phase(mx, common, records)
    phase_done("phase 23, rtc and the MLP")
    batch_serve = batch_serving_phase(mx, gluon, vision, common, records)
    phase_done("phase 24, batch serving")
    int8_serve = int8_serving_phase(mx, gluon, vision, common, records)
    phase_done("phase 25, int8 serving and HTTP")
    input_path = input_path_phase(mx, gluon, vision, common, resnet["img_s"])
    phase_done("phase 26, the record input path")
    det_input = detection_input_phase(mx, common, records, ssd["img_s"])
    phase_done("phase 27, the detection input path")
    input_service = input_service_phase(mx, gluon, vision, common, records,
                                        resnet["img_s"],
                                        input_path["lane"]["img_s"])
    phase_done("phase 28, the input service")
    zoo_serve = zoo_serving_phase(mx, vision)
    phase_done("phase 29, the zoo families served")
    bucketed_lm = bucketed_lm_phase(mx, common, records)
    phase_done("phase 30, the bucketed word LM")
    fused_step = fused_step_phase(mx, gluon, vision, common, records)
    phase_done("phase 31, the fused trainer step")
    from tools import chip_mesh
    mesh = chip_mesh.mesh_phase(log, records)
    phase_done("phase 32, the mesh")
    from tools import chip_embed
    embed = chip_embed.embed_phase(log, records)
    phase_done("phase 33, the sparse recommender path")

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
    log(f"batch serving {json.dumps(batch_serve)}")
    log(f"int8 serving and HTTP {json.dumps(int8_serve)}")
    log(f"the record input path {json.dumps(input_path)}")
    log(f"the detection input path {json.dumps(det_input)}")
    log(f"the input service {json.dumps(input_service)}")
    log(f"the zoo families served {json.dumps(zoo_serve)}")
    log(f"the bucketed word LM {json.dumps(bucketed_lm)}")
    log(f"the fused trainer step {json.dumps(fused_step)}")
    log(f"the mesh {json.dumps(mesh)}")
    log(f"the sparse recommender path {json.dumps(embed)}")
    over = [h["phase"] for h in held
            if h["reserved_gb"] - h["allocated_gb"] > MEMORY_SLACK_BYTES / 1e9]
    table = [[h["phase"], round(h["seconds"], 1), round(h["allocated_gb"], 3),
              round(h["reserved_gb"], 3)] for h in held]
    log(f"each phase's seconds, then GB allocated and reserved after it: "
        f"{json.dumps(table)}; reserved over allocated by more than "
        f"{MEMORY_SLACK_BYTES / 1e9:.0f} GB after: {over}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[n] for n in (
        "flash_decode_step", "flash_decode_step_paged") + TRAIN_RECORDS
        + ROW_KERNELS + CONV_RECORDS + LSTM_RECORDS + DET_KERNELS
        + RTC_KERNELS + QUANT_KERNELS + MT_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
