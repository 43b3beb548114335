#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all in parallel; the decode read's general route
   in a source of its own; the flash-attention
   source holds the normalized forward and ring attention's partial
   mode, the LayerNorm-backward source dx, dgamma and dbeta in one
   kernel; twelve kernels hold a
   float32, a bfloat16 and a float16 instance, and the dequant-fused
   matmul takes float32, bfloat16 and float16 x), print the build
   seconds,
   the compiler's register report, the card's name and power limit, and
   the TF32 switches (held off for the decode phases: the reference
   computes in full float32);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at edge shapes, and time kernel, device,
   plain version and — where one PyTorch call computes the same function
   — that library call (the BatchNorm pair over the fused ResNet-50
   step's 33 conv outputs at batch 32, and edges; the flash-decode
   kernel's fp8 instances over float8_e4m3fn and float8_e5m2 cells at
   S = 1, 4, 64, Dh 64 and 128, cursors 0 / mid / C - S and NaN cells,
   after ``rtc.fp8_cast`` gave the same bytes on the card as on the CPU;
   the bfloat16 instances of softmax, the CE gradient and the BatchNorm
   pair at the bfloat16 ResNet-50 path's shapes and edges, of the
   gather, LayerNorm, GeLU and the decode read at the bfloat16 decode
   path's shapes and edges, and of the LayerNorm backward, GeLU' and
   flash attention at the bfloat16 LM path's shapes and edges, bounds at
   bfloat16 bytes; the float16 instances of the same eleven kernels at
   the same shapes and edges; the LayerNorm backward's one call (dx,
   dgamma and dbeta) in the three types at the LM's (8192, 512) and edges
   (the register route's limit C = 1024 +-1, the eligibility bound),
   repeated bit for bit, each single-half wrapper giving its half bit for
   bit, its device time beside ``native_layer_norm_backward``'s and the
   pair's bound; and the dequant-fused matmul's
   bfloat16 and float16 instances at the quantized path's; the softmax
   head's pair at the LM head's (8192, 32000) in float32, bfloat16 and
   float16, device time beside the bound and ``torch.softmax``'s, the
   softmax held to its plain version there; LayerNorm at the LM's (8192,
   512) in the three types, held to its plain version, its device time
   beside ``F.layer_norm``'s and the bound; ``F.layer_norm``'s and
   ``torch.softmax``'s device times beside the kernels' at the decode and
   ResNet-50 head shapes; the host's launch path of the LayerNorm and
   softmax wrappers, piece by piece, as it is and as it was (the earlier
   path re-enacted); the decode read (key range split over blocks) in
   every instance at the prefill window (S = 64 at the served shape) and
   at a 4096-key cache (S = 1, Dh 64 and 128), held to its plain version,
   its device time beside the byte bound and SDPA's with the same cursor
   mask; row 16's library column, ``torch._weight_int8pack_mm``, where
   the installed PyTorch runs it; ptxas' registers and spills of every
   softmax, LayerNorm, LayerNorm-backward and decode-read instance (none
   may spill); each
   flash-attention
   instance's HGMMA count in its SASS and ptxas' registers and spills —
   the 16-bit instances, both modes, must run on the tensor cores and
   the float32 ones off them, and none may spill; the float32 flash
   forward at Dh 128, (4, 8, 1024, 128) causal, beside SDPA's; row 16 at
   ResNet-50's head at every serving rung (M = 1, 2, 4, 8) in every
   instance, ``torch._weight_int8pack_mm`` beside the int8 rows; the
   route-break table (row 16's GEMV and tiled routes around the break at
   N = 1000 and 32000);
   ptxas' registers and spills of every row 16 instance of both routes
   (none may spill); the optimizer updates over ResNet-50's 157 arrays:
   the multi-tensor kernels (one launch) bit for bit the per-array
   kernels (157 launches) and within 1e-6 of their plain versions, both
   timed, beside ``torch._fused_sgd_`` / ``torch._fused_adam_`` over the
   same arrays (the same bytes, not the same function) and the byte
   bound, and again over the LM's 99 arrays; ``bn_stats`` (one launch a
   call) beside ``torch.var_mean``'s device time over the same 33
   tensors in each type, the stem alone beside its byte bound; the
   attention kernels at head dim 32 (the bench LM over 16 heads), every
   instance against its plain version and timed: the decode read at the
   served step and the S = 64 window beside SDPA, the causal flash
   forward (8, 16, 1024, 32) beside SDPA and beside its Dh 64 instance
   at the same width and at the same rows, the ring's partial block at
   the past shard and the diagonal (2, 16, 1024, 1024, 32); the
   conv-weight dequant over ResNet-50's 53 int8 and e4m3 weights, one
   ``dequant_rows_multi`` launch bit for bit the plain version, its
   device time beside the 53 single-array calls', ``flat_i8.to(float32)``
   over the same values and the byte bound, and one weight a call through
   each kernel (host-paced and device ms, in turns); and in phase
   29, ``torch.relu``'s and ``threshold_backward``'s device times beside
   row 18's user kernels);
3. serve the repo's transformer LM at full width (V=32000, d_model=512,
   8 layers, 8 heads, rotary, cache 256, slot ladder [1, 4, 8], random
   weights from a numpy seed) through ``serve_decoder``'s dispatch thread:
   8 requests of 16 prompt tokens and 64 new tokens, staggered so the
   rung switches; every decode kernel's counter is zeroed just before
   and must have risen while serving; one served stream is then
   teacher-forced on the card and on the CPU and the logits compared;
4. profile 16 full-rung decode steps: wall time per step, the device-busy
   share, and the kernels that take the most device time;
5. train ResNet-50 (1000 classes, 3x224x224, batch 32, numpy-seeded
   synthetic data through ``NDArrayIter``, Xavier init, SGD lr 0.1
   momentum 0.9 wd 1e-4) through ``Module.fit`` on ``gpu(0)`` for 8
   batches: images/s and p50/p99 step ms without the first batch, kernel
   launches per step (softmax 1, cross-entropy backward 1, sgd_mom_multi
   1: ``Module.update``'s one launch over the 157 arrays, no per-array
   ``sgd_mom``),
   a finite loss and moved parameters, and with telemetry on the fit's
   MFU readings (``mfu.model`` of the bf16 peak, ``mfu.flops_per_step``,
   ``mfu.node_coverage``, ``mfu.achieved_flops_per_sec``), held to the
   script's own FLOPs over the p50 step within 10 %; then
   ``Module.update``'s host ms a step beside a per-index loop over the
   module's updater (``Updater(i, g, w)``, a caller's own path: 157
   per-array ``sgd_mom`` launches) on the same gradients, in turns, the
   weights and states put back after;
6. one step of the same model at batch 2 on the card and on the CPU from
   the same parameters, TF32 off: the forward (probabilities, BatchNorm
   moving statistics) within 1e-4, and the updated weights within ten
   times the CPU's own spread under a 1e-6 relative perturbation of the
   starting weights (one ResNet-50 step at batch 2 amplifies rounding:
   a perturbation that small already moves conv0's gradient visibly);
7. two steps of the same fit with ``optimizer="adam"`` at batch 4 (one
   ``adam_multi`` launch a step and no per-array ``adam``), then phase
   5's host ms of ``Module.update`` beside the per-index loop (157
   per-array ``adam`` launches);
8. profile 4 ResNet-50 training steps: device-busy share, the kernels
   that take the most device time, ms per step;
9. train the repo's transformer LM at the bench's full width (V=32000,
   d_model=512, 8 layers, 8 heads, T=1024, batch 8, ``SyntheticLMIter``
   seed 0, Xavier init, SGD lr 0.05) through ``Module.fit`` on ``gpu(0)``
   for 8 batches: tokens/s and p50/p99 step ms without the first batch,
   peak device memory, kernel launches per step (embedding 1, LayerNorm
   17 forward + 17 backward (``ln_bwd``: dx, dgamma and dbeta in one call;
   none from the single-half wrappers), GeLU 8 + 8, flash attention 8,
   softmax 1, cross-entropy backward 1), a finite loss, moved
   parameters and the fit's MFU readings as in phase 5;
10. one SGD step of the same LM at batch 2, T=128 on the card and on the
   CPU from the same numpy-seeded parameters, TF32 off: the
   probabilities within 1e-4, every gradient within 1e-4 of its array's
   largest magnitude, every updated weight within 1e-5;
11. profile 4 LM training steps: device-busy share, device time by group
   (the port's kernels / cuBLAS and the libraries / PyTorch elementwise /
   copies), the kernels that take the most device time;
12. serve ResNet-50 (1000 classes, 3x224x224, Xavier seed 0) bound on
   ``gpu(0)`` through ``mx.serve.serve`` at ladder [1, 2, 4, 8] three
   times — float32, int8, fp8 — each answering 24 scripted requests of
   1-3 rows, one every 4 ms, through ``run_scripted`` on a real clock:
   req/s, p50/p99 latency, occupancy, padding waste, the two quantized
   kernels' libraries (unloaded first) loaded by a quantized ladder's
   warmup and no kernel library loaded after it, exactly 1
   ``dequant_rows_multi`` (the conv prologue's, over the 53 conv
   weights) + 1 ``qfc_matmul`` launches per quantized forward (warmup's
   2 per rung included), no single-array ``dequant_rows``, and none on
   the float ladder, quantized outputs within ``INT8_TOL`` / ``FP8_TOL``
   of the float ladder's; then the imperative path, one
   ``mx.nd.QuantizedConvolution`` call for each of the int8 rewrite's 53
   convs, each dequantizing its own weight (53 ``dequant_rows``, no
   ``dequant_rows_multi``), against the convolution of its plain
   dequant;
13. one int8 and one fp8 quantized ResNet-50 forward at batch 2 on the
   card, through the engine phase 12 served, and on the CPU from the
   same quantized parameters, TF32 off: probabilities within 1e-5, the
   logits within 1e-4 of their largest magnitude, and the same top-1;
14. rung-8 dispatches of the three ladders: wall per dispatch in turns
   (float32, int8, fp8, fp8, int8, float32; 8 each), then 8 of each
   under the profiler: device busy, launches per forward, and for int8
   the device time by group (cuDNN / the two quantized kernels / softmax
   / PyTorch elementwise / copies); then an int8 rung-8 forward of the
   rewritten graph through a Module with its conv prologue (one
   dequant launch) and through one bound with the prologue taken off (a
   dequant launch a conv), in 16 turns: wall ms per forward, the median
   of the per-turn differences with a sign test of whether they are
   resolved, and the peak ``torch.cuda.max_memory_allocated`` above the
   bound state;
15. train ResNet-50 in its fused configuration (the 33 Conv -> BatchNorm
   -> ReLU triples as ``FusedConvBNReLU``) through ``Module.fit`` as in
   phase 5, telemetry on: img/s, p50/p99, exactly 33 ``bn_stats`` + 33
   ``bn_apply_relu`` + 1 softmax + 1 cross-entropy backward + 1
   ``sgd_mom_multi`` launches per step and nothing else, a finite loss, moved
   parameters, the MFU readings;
16. one fused step at batch 2, TF32 off, on the card and on the CPU
   through the CUDA variant's ``autograd.Function`` (its kernels are
   their plain halves there), held as phase 6; then the fused and plain
   nets' inference forward on the card from renamed parameters (random
   BatchNorm statistics and affine), within 1e-4;
17. serve the fused ResNet-50 at ladder [1, 2, 4, 8] with phase 12's 24
   scripted requests, from phase 12's parameters renamed: req/s, p50/p99,
   warmup loading ``bn_apply_relu``'s library and nothing loaded after,
   exactly 33 ``bn_apply_relu`` and 0 ``bn_stats`` per forward, outputs
   within 1e-4 of the float32 ladder's;
18. profile fused and plain ResNet-50 training steps at batch 32 in turns
   (plain, fused, fused, plain; 2 each), 2 fused steps with the moving
   statistics' zero cotangents filled again (the fused op's Function as
   it was before it stopped materializing them), and 8 rung-8 dispatches
   of each ladder: device busy, launches, and device time by group (cuDNN
   / the BatchNorm pair / the port's other kernels / PyTorch elementwise
   / copies);
19. chunked prefill: phase 3's model through ``serve_decoder(symbol_gen=,
   prefill_chunk=64)`` at ladder [1, 4, 8], 8 prompts of 65-150 tokens and
   64 new tokens each, submitted at once and pumped on a real clock, then
   the same at ``prefill_chunk=1``: every dispatch (the S=64 windows too)
   launches the decode kernels exactly once per layer, each request's
   dispatches and TTFT side by side, greedy chains equal (or parted at a
   CPU near-tie), one S=64 window's logits card vs CPU within LOGIT_TOL;
20. speculative decoding: phase 3's 8 requests with a 1-layer draft (the
   target's embedding, layer 0 and final LayerNorm) at spec_k 4 against the
   target alone: acceptance, iterations and tokens/s of both, greedy chains
   equal (near-tie rule); a self draft accepts >= 0.95;
21. the prefix store: ladder [4], an 8 MiB store, 8 requests of a shared
   128-token prefix plus one distinct token: hit rate 7/8, the restored
   rows bitwise the cold capture's, cold and warm TTFT, the
   ``serve.decode.*`` telemetry agreeing with ``stats()``;
22. the fp8 KV cache: phase 3's 8 requests at ladder [1, 4, 8] with float32,
   float8_e4m3fn and float8_e5m2 cells: ``decode_attention_fp8`` launches
   at every fp8 dispatch, the cells stay float8, tokens/s beside float32;
   one stream teacher-forced card vs CPU over the card's cells within
   FP8_LOGIT_TOL;
23. profile a rung-8 S=64 prefill window and a rung-8 speculative
   iteration: wall, device busy, launches, device time by group;
24. (run after 18) train ResNet-50, plain and fused, through
   ``Module(compute_dtype="bfloat16").fit`` as in phase 5, telemetry on:
   img/s, p50/p99, the MFU readings, exactly 1 ``softmax_bf16`` + 1
   ``softmax_ce_bwd_bf16`` (+ 33 ``bn_stats_bf16`` + 33
   ``bn_apply_relu_bf16`` fused) + 1 ``sgd_mom_multi`` per step and no
   float32 instance, a finite loss, and every bound cell still float32;
25. bfloat16 card vs CPU at batch 2 (phase 6's parameters with random
   BatchNorm statistics and affine, TF32 off): the inference forward and
   a training step's forward within ``BF16_SPREAD`` times the CPU's own
   bfloat16-vs-float32 distance (centered log-probabilities, loss);
26. serve ResNet-50, plain and fused, in bfloat16 at ladder [1, 2, 4, 8]
   with phase 12's requests and parameters: req/s, p50/p99, the softmax
   (and ``bn_apply_relu``) library loaded by warmup and nothing after,
   exactly 1 ``softmax_bf16`` (+ 33 ``bn_apply_relu_bf16``) per forward,
   outputs within ``INT8_TOL`` of the float32 ladder's, top-1 agreement;
27. profile bfloat16 training steps (plain, fused, fused, plain; 2 each)
   and 8 rung-8 dispatches of each bfloat16 ladder;
28. ``mx.rtc.Rtc``: a user ``axpb`` kernel (CUDA C++ written in this
   script, compiled at its first push by NVRTC) over 2^24 floats, bit
   for bit
   ``torch.add(y, x, alpha=2)`` with the default launch and with given
   grid / block dims; a wrong shape raises; times against ``2 x + y``
   and ``torch.add`` and the byte bound;
29. ``mx.rtc.register_cuda_op``: ``relu_user`` (a forward and a VJP kernel
   written here; its plain version ``torch.maximum(x, 0)``, the plain
   Activation's, whose gradient at x == 0 is ct / 2) in the place of
   ResNet-50's 50 ``Activation(relu)`` nodes (the symbol's JSON rewired;
   the same parameters load): one step's loss and gradients at batch 32
   against the plain graph's, TF32 off and cuDNN deterministic (its default
   weight gradients sum with atomics: two runs of the plain graph differ),
   within FWD_TOL of the largest |g|; then ``Module.fit`` for 8 steps
   beside the plain graph's fit from the same parameters and batches (phase
   6's Xavier start, phase 5's data): img/s of both, exactly 50 + 50
   launches a step, the weights within SPREAD_FACTOR times the spread of
   the plain fit from 1e-6-perturbed weights (measured on the card: 8 CPU
   steps at batch 32 would take minutes); both kernels over one step's 50
   inputs (exact zeros included) bit for bit against the plain version and
   its autograd backward, timed beside ``torch.relu`` and
   ``threshold_backward``; 2 profiled steps of each fit (plain, user, user,
   plain); the op registered without a VJP kernel refuses a training
   forward;
30. ``mx.operator.CustomOp``: MXNet's custom softmax (numpy forward,
   backward ``p - onehot(label)``, ``need_top_grad=False``) in the place
   of ResNet-50's ``SoftmaxOutput``: one step's gradients against the
   ``SoftmaxOutput`` graph's within FWD_TOL, then 8 steps of each, step
   ms side by side;
31. ``mx.autograd``: a stage-1 bottleneck without BatchNorm at batch 32
   (256 -> 64 -> 64 -> 256 channels, 56 x 56) through ``mx.nd`` inside
   ``train_section``, its gradients from ``mx.autograd.backward``
   against the Executor's of the same symbol within FWD_TOL;
32. (run after 23) phase 3's serving in bfloat16 mixed precision:
   ``serve_decoder(compute_dtype="bfloat16")`` at full width with phase
   3's prompts and arrivals, alternated with the float32 ladder (float32,
   bfloat16, bfloat16, float32): tokens/s and p50/p99 iteration ms of
   each; the four decode libraries (unloaded first) loaded by warmup and
   nothing after; exactly 1 ``embedding_bf16`` + 17 ``layernorm_bf16`` +
   8 ``bias_gelu_bf16`` + 8 ``decode_attention_bf16`` launches per S=1
   dispatch and no float32 decode kernel; the cast layer's 16 cache casts
   and 16 write-backs per dispatch (the parameters' casts kept); request
   0's stream teacher-forced card vs CPU in bfloat16 within
   BF16_LOGIT_TOL (atol and rtol), each served token the CPU's argmax or
   a near-tie;
33. chunked prefill (S=64) and speculative decoding (phase 20's draft,
   spec_k 4) armed under bfloat16: phase 3's prompts at once, windows and
   speculative iterations ran, only the bfloat16 decode instances
   launched, greedy chains equal to phase 32's (or parted at a bfloat16
   near-tie), one S=64 window card vs CPU within BF16_SPREAD times the
   CPU's own bfloat16-vs-float32 distance;
34. 8 rung-8 steps of the float32 and the bfloat16 server in turns
   (float32, bfloat16, bfloat16, float32): wall without the profiler;
   under the profiler wall, device busy, launches, device time by group,
   and the cache casts and write-backs per step; the host's time per
   step by op (the profiler's CPU activity);
35. (run after 31) the LM of phase 9 through
   ``Module(compute_dtype="bfloat16").fit`` and in float32, in turns
   (float32, bfloat16, bfloat16, float32; 8 batches each, telemetry on):
   tokens/s, p50/p99 step ms, peak device memory and the MFU readings of
   each; every bfloat16 step launches exactly 1 ``embedding_bf16``, 17
   ``layernorm_bf16`` + 17 ``layernorm_bwd_bf16``, 8 ``bias_gelu_bf16`` + 8
   ``bias_gelu_dx_bf16``, 8 ``flash_attention_bf16``, 1 ``softmax_bf16``
   and 1 ``softmax_ce_bwd_bf16`` and no float32 instance; one cast per
   parameter per step (99: the tied embedding table once); a finite
   loss, moved parameters, every bound cell float32;
36. one bfloat16 SGD step of the LM at batch 2, T=128, card vs CPU from
   phase 10's parameters, TF32 off: probabilities, every gradient and
   every weight's update within ``BF16_SPREAD`` times the CPU's own
   bfloat16-vs-float32 distance of that array (plus one bfloat16 ulp of
   its largest magnitude);
37. profile 4 float32 and 4 bfloat16 LM steps in turns: wall, device
   busy, launches, device time by group (the port's kernels / cuBLAS /
   PyTorch elementwise / the casts / copies), casts per step, and the
   rate of the cuBLAS group over the step's matmul flops.

Then float16 (``compute_dtype="float16"``) on the same paths, with the
bfloat16 phase functions given the dtype:

38. (run after 27) phase 24 in float16: ResNet-50, plain and fused,
   through ``Module(compute_dtype="float16").fit``, exact ``*_f16``
   launches per step;
39. phase 25 in float16: card vs CPU at batch 2 within ``BF16_SPREAD``
   times the CPU's own float16-vs-float32 distance;
40. phase 26 in float16: ResNet-50, plain and fused, served through
   ``mx.serve.serve(compute_dtype="float16")``;
41. ResNet-50 quantized to int8 through ``Module(quantize_symbol(...),
   compute_dtype=...)`` in bfloat16 and float16: one rung-8 forward
   each with exactly 1 ``qfc_matmul_bf16`` / ``qfc_matmul_f16``, 1
   ``dequant_rows_multi`` and the head's 16-bit softmax, then card vs CPU at
   batch 2 within ``BF16_SPREAD`` times the CPU's own 16-bit-vs-float32
   distance;
42. (run after 34) phase 32 in float16: ``serve_decoder(compute_dtype=
   "float16")`` in turns with float32, exact ``*_f16`` launches a
   dispatch, 2L casts and write-backs, one stream teacher-forced card vs
   CPU within ``BF16_SPREAD`` times the CPU's own float16-vs-float32
   distance (the bfloat16 phase's 2e-2 over 8 is printed beside);
43. phase 33 in float16: chunked prefill and speculative decoding armed;
44. (run after 37) phase 35 in float16: the bench LM through
   ``Module(compute_dtype="float16").fit`` in turns with float32, exact
   ``*_f16`` launches and 99 casts a step;
45. phase 36 in float16: one LM step card vs CPU, at 2 of the 8 layers
   and T 32 (F16_LM_PARITY_LAYERS, F16_LM_PARITY_SEQ: the CPU's float16
   matmuls are slow).

The profiles (phases 27, 34, 37) run in bfloat16 only.

Then sequence parallelism (``fit(spmd=True, mesh=MeshConfig(seq=4))``,
ring attention over ``[gpu(0)] * 4``; phase 2 also holds ring
attention's partial flash kernel, each instance, against its plain
version at the shard shapes (2, 8, 1024, 64): non-causal, the causal
diagonal, a past shard, a future shard (rows that see no key), Tq != Tk):

46. (run after 45) the bench LM at T = 4096, batch 2, through the ring
   fit and the unsharded fit from the same numpy-seeded parameters and
   batches, 4 SGD steps each, TF32 off: tokens/s, p50/p99 step ms, peak
   memory and the MFU readings of each, then 2 profiled steps of each
   (device busy, time by group, the top kernels); exactly 8 x 10 = 80
   ``flash_attention_partial`` launches a step (none for a causal ring's
   wholly future shards) and no ``flash_attention``; the per-step losses
   within RING_LOSS_TOL and every parameter within RING_WEIGHT_TOL of the
   unsharded fit's;
47. one layer's attention at (2, 8, 4096, 64): forward and forward +
   backward of the ring against the unsharded flash attention;
48. phase 46 in bfloat16 and in float16 at 2 layers, beside the unsharded
   fit in the same type and in float32: only the 16-bit partial instance
   launches (2 x 10 a step), every parameter within ``BF16_SPREAD`` times
   the unsharded 16-bit-vs-float32 distance plus one ulp.

Then fine-tuning with frozen parameters, the path of the LayerNorm
backward's single-half wrappers:

49. (run after 48) the bench LM at full width cut to 2 layers, T=1024,
   batch 8, its embedding table and every LayerNorm's gamma / beta but
   the first's frozen (``bind(grad_req=...)``), one SGD step in float32,
   bfloat16 and float16: exactly 4 ``layernorm_bwd_dx`` (dx alone) and 1
   ``layernorm_bwd_dparams`` (dgamma / dbeta alone: the first
   LayerNorm's input needs no gradient) launches and no
   ``layernorm_bwd``; every trained parameter's gradient within
   FROZEN_GRAD_RTOL of the same step with every parameter trained (5
   ``layernorm_bwd`` launches); frozen parameters unmoved.

Then attention at head dim 32:

50. (run after 49) the bench LM over 16 heads (d_model 512, Dh 32) from
   phase 3's parameters through ``serve_decoder`` in float32 and
   bfloat16 (phase 3's prompts and arrivals, exact launches a dispatch,
   one stream teacher-forced card vs CPU within LOGIT_TOL /
   HALF_LOGIT_TOL), through ``Module.fit`` in float32 and bfloat16 at T
   1024, batch 8 (exact launches a step), one step card vs CPU at batch
   2, T 128 in both types (phases 10 and 36's limits), and through the
   sequence-parallel fit at 2 layers against the unsharded fit (phase
   46's limits); the Dh 32 runs must launch the decode read, the flash
   forward (float32 and bfloat16) and the partial block.

Then the head dims between the attention kernels' tiles:

51. (run after 50) for Dh 16, 48, 80, 96 and 112 a 2-layer LM at d_model
   8 Dh over 8 heads (V 32000), numpy-seeded: ``serve_decoder`` in
   float32 and bfloat16 (4 requests, the decode read's instance of the
   type launched; float32 one stream teacher-forced card vs CPU within
   LOGIT_TOL), ``Module.fit`` in float32 and bfloat16 (T 256, batch 4,
   exact flash launches a step), one float32 step card vs CPU (phase
   10's limits), the sequence-parallel fit (``MeshConfig(seq=4)``)
   against the unsharded one (phase 46's limits).
52. (run after 51) inputs the JAX package runs that the port's kernels
   once refused, through the public entry points on the card: the runs
   of phase 51 for LMs at Dh 40 (no multiple of 16) and Dh 256 (the
   wide routes); ``serve_decoder(prefill_chunk=128)`` at capacity 256
   (128-row windows), its greedy chains against chunk 1's; an LM fit
   over a 128256-word vocabulary in float32 and bfloat16 (the streaming
   softmax) and one step card vs CPU; a segmentation net
   (``SoftmaxOutput(multi_output=True)`` over the channel axis,
   ``LayerNorm(axis=1)``) through ``Module.fit`` card vs CPU; the fp8
   ResNet-50 under ``compute_dtype="bfloat16"`` through an
   ``InferenceServer`` (the e4m3 weights reach rows 16 and 17 as
   stored); ``mx.nd.attention`` with Tq != Tk (NaN rows where a query
   sees no key) and over B*H 65536, card vs CPU. Then the new routes'
   device ms beside their bounds and SDPA / ``torch.softmax`` /
   ``native_layer_norm_backward``, and the 16-bit flash operands'
   zero-padded copy alone.

Then the random chain (``mx.random``: the JAX package's threefry2x32
keys) and the classifiers that use Dropout, LRN and Concat; phase 2 also
holds the threefry kernel against its plain version (Dropout in every
instance at the bench LM's and VGG's drop6 shapes and at 1, 7 and 4099
values, aligned and one element off 16 bytes, bit for bit, one case on
the CPU too; uniform at the embedding table's (V, D) and the edges, bit
for bit, its normal and exponential transforms within their limits) and
times it beside ``F.dropout`` / ``torch.rand`` and its bound (bytes, or
threefry's integer operations at the card's INT32 rate):

53. (run after 52) AlexNet, VGG-16 and Inception-BN at 224 x 224 and
   Inception-v3 at 299 x 299 (1000 classes) through ``Module.fit`` on
   ``gpu(0)`` after ``mx.random.seed(0)``: Xavier weights drawn on the
   card by the uniform kernel (one launch a weight), ZOO_STEPS batches of
   ZOO_BATCH (SGD momentum 0.9, wd 1e-4, telemetry on): img/s without
   the first batch, exactly 1 softmax + 1 CE backward + 1
   ``sgd_mom_multi`` (+ AlexNet's and VGG's 2 ``dropout``) launches a
   step, the MFU readings (the rate printed, not held: two timed batches
   of a host-bound net), the masks under the module's key chain bit for
   bit the plain
   version's on the card and the CPU, the device-busy share of 2 more
   steps; then one step of each at batch 2 card vs CPU from the same
   parameters and seed, TF32 off and cuDNN deterministic (phase 6's
   limits), at 67, 32, 224 and 299 pixels (ZOO's last entries);
54. the bench LM with ``dropout=0.1`` (16 Dropouts) through
   ``Module.fit`` for LM_DROPOUT_STEPS batches in float32, bfloat16 and
   float16: tokens/s, phase 9's (35's, 44's) launches a step plus 16
   ``dropout`` (``dropout_bf16``, ``dropout_f16``), the MFU readings
   (the rate printed, not held: two timed batches), the masks under the
   key chain bit for bit the plain version's on the card (the first on
   the CPU), the float32 fit's device-busy share.
55-59. the bench LM and ResNet-50 through kill and resume, the
   Predictor, a warm restart, the 16-bit samplers (each phase's
   function says what it holds).
60. the tensor surface: every op name of ``ops/tensor.py`` with
   ``softmax``, ``log_softmax``, ``SliceChannel`` / ``split`` and
   ``MakeLoss`` (147) through ``mx.nd`` on ``gpu(0)`` and on the CPU from
   the same numpy inputs, TF32 off: (8192, 512) for the elementwise,
   scalar, broadcast, reduction and indexing families, (8, 32000) with a
   row of repeated values for ``sort`` / ``argsort`` / ``topk`` (k 40,
   every ``ret_typ``, both directions), (32, 64, 112, 112) for ``Pad`` and
   ``SliceChannel``; exactly where the op moves, selects, orders or
   compares, else within rtol 1e-5 / atol 1e-6, the gradients through
   ``mx.autograd`` the same way. Then the bench LM (phase 9's width) with
   its head written in those ops, ``MakeLoss(mean(-pick(log_softmax(
   logits), label)))`` over ``get_internals()["lm_logits_output"]``
   grouped with ``BlockGrad(softmax(logits))``: its first-step gradients
   within 1e-5 of each array's max of the ``SoftmaxOutput`` head's (TF32
   off), 4 batches through ``Module.fit`` (tokens/s beside phase 9's,
   phase 9's launches a step less the head's softmax and CE gradient,
   exactly), the device-busy share of 2 more steps.
61. the remaining nn layers and losses: ``LeakyReLU`` (every
   ``act_type``), ``Deconvolution``, ``UpSampling``, ``InstanceNorm``,
   ``L2Normalization``, ``SoftmaxActivation``, ``Crop``, the three
   sequence ops, ``ROIPooling``, ``BilinearSampler``, ``GridGenerator``,
   ``SpatialTransformer``, ``Correlation``, the three regression outputs,
   ``SVMOutput`` and ``IdentityAttachKLSparseReg`` (20) as one-node
   Executors on ``gpu(0)`` and on the CPU at the CPU tests' shapes, TF32
   off: outputs within 2e-5, every input's gradient within 1e-5 of its
   largest magnitude, ``rrelu``'s training slopes (the threefry kernel's
   uniform draws) bit for bit; Fast R-CNN's ROI pooling (128 ROIs over
   512 x 38 x 50, 7 x 7 bins) and FlowNet-C's correlation (256 x 48 x 64,
   max_displacement 20, stride2 2) card vs CPU, each one's device ms and
   backward peak memory on the card. Then DCGAN (``examples/dcgan.py``'s
   graph, kept here as ``dcgan_generator`` / ``dcgan_discriminator``) at
   ngf = ndf = 64, a 100-wide code, batch 64, through two Modules and
   the example's loop (``dcgan_iteration``: the discriminator bound with
   ``inputs_need_grad``, its gradients stashed and added, its input
   gradient through the generator's backward, Adam lr 2e-4 beta1 0.5,
   the ``CustomMetric`` "dacc"): generator samples a second and iteration
   p50 over 10 timed iterations, exactly 2 ``adam_multi`` launches an
   iteration, the device-busy share of 2 more; one iteration card vs CPU
   from the same parameters and noise (``dcgan_parity``).
62. the contrib ops and SSD (TF32 off): (a) the 10 contrib ops under
   their 23 names as one-node Executors on ``gpu(0)`` and on the CPU at
   the CPU tests' shapes: ``quantize``, the anchors, ``MultiBoxTarget``'s
   ``loc_mask`` and ``cls_target`` and ``MultiBoxDetection``'s ids
   exactly, every other output within 2e-5, the gradients of CTC,
   ``fft``, ``ifft`` and ``count_sketch`` within 1e-5 of their largest,
   the NMS ops twice on the card bit for bit; (b) SSD
   (``examples/ssd``, kept here as ``ssd_train_symbol`` and its pieces)
   at the example's defaults (width 32, 96 pixels, batch 16, 128 images,
   8 epochs, SGD lr 0.01, momentum 0.9, wd 5e-4) through ``Module.fit``
   with the example's iterators and ``MultiBoxMetric``: images a second,
   batch p50, the port's launches a step, the device-busy share, and
   ``MultiBoxTarget``'s device ms and launches at a step's inputs; (c)
   ``tests/test_ssd.py``'s convergence gate at its settings (width 16, lr
   0.02, 6 epochs of 96 images): the last epoch's cross-entropy under 0.6
   of the first's, half the ground-truth boxes hit at IoU > 0.3; (d) the
   detect symbol card vs CPU from those parameters on 4 images, the
   decode's device ms and launches; (e) ``MultiProposal`` at Faster
   R-CNN's defaults over a 38 x 63 map card vs CPU, twice bit for bit;
   (f) CTC at T 100, batch 32, 29 classes, loss and gradient card vs CPU;
   each one's device ms and launches.

Each phase's seconds are printed on a line of their own ("chip_smoke:
phase N (...) took S s").

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
launches on its path — the decode kernels while serving, softmax /
cross-entropy / the multi-tensor SGD-momentum while fitting ResNet-50
with SGD, the multi-tensor Adam while fitting with Adam and training
DCGAN, the per-array
SGD-momentum and Adam kernels in phases 5 and 7's per-index updater
loops, the LayerNorm and GeLU backward kernels and
flash attention while fitting the LM (the LayerNorm backward's
single-half wrappers, ``ln_bwd_dx`` / ``ln_bwd_dparams`` and their 16-bit
counters, in phase 49's frozen steps), the quantized kernels while
serving int8 and fp8, the BatchNorm pair while fitting and serving the
fused ResNet-50, ``decode_attention_fp8`` (the decode kernel's fp8
instances) while serving the fp8 caches, the softmax, CE-gradient and
BatchNorm ``*_bf16`` instances while fitting and serving ResNet-50 in
bfloat16, the decode path's four ``*_bf16`` instances while serving the
LM in bfloat16 (phase 32), the LM-training path's four ``*_bf16``
instances while fitting the LM in bfloat16 (phase 35), the ``*_f16``
instances in phases 38, 40, 42 and 44, the dequant-fused matmul's
16-bit instances in phase 41, the partial flash kernel's three
instances in the ring fits of phases 46 and 48, the user kernels
``rtc_axpb`` (its two checked pushes), ``relu_user`` and ``relu_user_vjp``
(the relu_user fit; their source is this script), and the attention
kernels' launches in phases 50 to 52 added to theirs, and the threefry
kernel's in phases 53 (``uniform``: the initializers' draws; ``dropout``)
and 54 (``dropout`` and its 16-bit instances) — max abs error against
the plain version, kernel /
plain / library milliseconds and the bound); the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside a
checkout, the script exits non-zero and prints no result.
"""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time

SEED = 0
#: rounds of the slowest plain versions' timing (``_timed``; the kernels'
#: own times keep three): one, so that phase 2 stays within the script's
#: time as later phases are added
PLAIN_ROUNDS = 1
V, D, N_LAYER, N_HEAD, CAP = 32000, 512, 8, 8, 256
LADDER = [1, 4, 8]
PROMPT, NEW, N_REQ = 16, 64, 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
# H100 SXM 32-bit integer operations: 64 a clock an SM, half the float32
# lanes whose fused multiply-adds make the data sheet's 67 TFLOP/s
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
# threefry2x32's integer operations for one element's 32 bits: 20 rounds
# of add, rotate (one funnel shift) and xor, five key injections of two
# adds, the counter's two adds and the final xor
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2 + 1
# the 16-bit normal and exponential draws on the card against the plain
# version: erfinvf / log1pf against PyTorch's, each rounded to the type
UNIFORM16_ULPS = 1
# ln_bwd_dparams: sums over up to 8192 rows reach a few hundred, where a
# float32 ulp is 3e-5, and the plain version sums in another order; ln_bwd
# (dx, dgamma and dbeta from one call) is held to both limits, dx to
# ln_bwd_dx's and the sums to ln_bwd_dparams', and its line shows the
# larger error against the sums' limit
# qfc_matmul's error is relative to the output's largest magnitude (it
# sums K products in another order than cuBLAS); dequant_rows is exact
TOL = {"embedding": 0.0, "layernorm": 2e-5, "bias_gelu": 2e-5,
       "dequant_rows_multi": 0.0,
       "decode_attention": 2e-5, "decode_attention_fp8": 2e-5,
       "softmax": 2e-5, "softmax_ce_bwd": 2e-5,
       "sgd_mom": 1e-6, "adam": 1e-6, "sgd_mom_multi": 1e-6,
       "adam_multi": 1e-6, "ln_bwd_dx": 2e-5,
       "ln_bwd_dparams": 5e-4, "ln_bwd": 5e-4, "bias_gelu_dx": 2e-5,
       "flash_attention": 2e-5, "qfc_matmul": 1e-5, "dequant_rows": 0.0,
       "bn_stats": 1e-5, "bn_apply_relu": 0.0,
       "softmax_bf16": 1.0, "softmax_ce_bwd_bf16": 0.0,
       "bn_stats_bf16": 1e-5, "bn_apply_relu_bf16": 0.0,
       "embedding_bf16": 0.0, "layernorm_bf16": 1.0, "bias_gelu_bf16": 1.0,
       "decode_attention_bf16": 2e-5, "layernorm_bwd_dx_bf16": 1.0,
       "layernorm_bwd_dparams_bf16": 1.0, "layernorm_bwd_bf16": 1.0,
       "bias_gelu_dx_bf16": 1.0,
       "flash_attention_bf16": 1.0, "qfc_matmul_bf16": 1e-5,
       "flash_attention_partial": 2e-5, "flash_attention_partial_bf16": 2e-5,
       "dropout": 0.0, "dropout_bf16": 0.0, "uniform": 0.0,
       "uniform_bf16": 0.0}
# the float16 instances: the bfloat16 instances' limits, in float16 ulps
# where those are in ulps
TOL.update({k.replace("_bf16", "_f16"): v for k, v in TOL.items()
            if k.endswith("_bf16")})
# bn_stats' error is relative to each channel's sum of squares (which also
# bounds its sum: sum(x)^2 <= n sum(x^2)): float32 sums of up to 401,408
# terms (the stem's channels at batch 32), taken in another order than
# torch.sum's; bn_apply_relu rounds its product and sum as the plain
# version does, so it must match exactly. The bfloat16 instances: softmax
# in bfloat16 ulps (1: a row's float32 sum in another order can move a
# quotient across a rounding boundary), the CE gradient and the apply pass
# exactly, the statistics as bn_stats. The decode path's bfloat16
# instances: the gather exactly, LayerNorm and GeLU in bfloat16 ulps beyond
# the float32 instances' 2e-5 (a product in another order can move a
# rounding), the decode read (float32 out, exactly widened inputs) as the
# float32 read. The LM-training path's bfloat16 instances, in bfloat16
# ulps: dx, GeLU' and attention within one beyond 2e-5 of their plain
# versions on the same values (float32 arithmetic in another order can
# move a rounding), dgamma / dbeta (float32 sums over 8192 rows) within
# one beyond 1e-4
# flash_attention_partial (every instance): acc, m and l within 2e-5 of
# each array's largest magnitude (float32 sums in another order), the
# rows that see no key exactly -inf / 0 / 0 as the plain version's
LOGIT_TOL = 2e-3               # card vs CPU logits, full model, float32
#: softmax edge shapes: each route's limits +-1 (one warp to C = 1024, one
#: block to 32768 with 16-byte units and 16384 without, a cluster of up to
#: four blocks to 65536), C = 1, odd C, the LM head's C = 32000 at N = 64,
#: N = 1
SOFTMAX_EDGES = ((4, 1), (1, 7), (70, 33), (3, 1023), (2, 1024), (3, 1025),
                 (2, 16383), (2, 16384), (2, 16385), (2, 32767), (2, 32768),
                 (2, 32769),
                 (2, 65536), (64, 32000), (1, 1000))
#: LayerNorm edge shapes: the register route's limit +-1 (C = 1024), C = 1,
#: odd C, N = 1
LN_EDGES = ((3, 100), (5, 13), (1, 4096), (2, 1023), (2, 1024), (2, 1025),
            (4, 1), (1, 512))
#: the LayerNorm backward's edge shapes: one row, one column, the
#: eligibility bound (two of the walked route's 64-row chunks at N = 65),
#: the register route's limit +-1 (C = 1024) over more rows than one
#: grid's warps at N = 3000, odd C
LN_BWD_EDGES = ((1, D), (64, 1), (2, 65536), (65, 4096), (70, 1023),
                (3000, 1024), (70, 1025), (300, 100), (5, 13))
REPLACES = {
    "embedding": "mxnet_tpu/ops/pallas_kernels.py:858",
    "layernorm": "mxnet_tpu/ops/pallas_kernels.py:585",
    "bias_gelu": "mxnet_tpu/ops/pallas_kernels.py:746",
    "decode_attention": "mxnet_tpu/ops/pallas_kernels.py:953",
    "decode_attention_fp8": "mxnet_tpu/ops/pallas_kernels.py:953",
    "softmax": "mxnet_tpu/ops/pallas_kernels.py:104",
    "softmax_ce_bwd": "mxnet_tpu/ops/pallas_kernels.py:112",
    "sgd_mom": "mxnet_tpu/ops/pallas_kernels.py:497",
    "adam": "mxnet_tpu/ops/pallas_kernels.py:509",
    # the per-array kernels' arithmetic over a whole step's arrays, as the
    # JAX package's fused step applies it (mxnet_tpu/optimizer.py
    # SGD.fused_plan :222, Adam.fused_plan :366)
    "sgd_mom_multi": "mxnet_tpu/ops/pallas_kernels.py:497",
    "adam_multi": "mxnet_tpu/ops/pallas_kernels.py:509",
    "ln_bwd_dx": "mxnet_tpu/ops/pallas_kernels.py:600",
    "ln_bwd_dparams": "mxnet_tpu/ops/pallas_kernels.py:612",
    # both TPU kernels (:600 dx, :612 dgamma / dbeta) in one launch
    "ln_bwd": "mxnet_tpu/ops/pallas_kernels.py:600",
    "bias_gelu_dx": "mxnet_tpu/ops/pallas_kernels.py:751",
    "flash_attention": "mxnet_tpu/rtc.py:301",
    "qfc_matmul": "mxnet_tpu/ops/quant.py:151",
    "dequant_rows": "mxnet_tpu/ops/quant.py:234",
    # the same TPU kernel over a forward's conv weights, one launch
    "dequant_rows_multi": "mxnet_tpu/ops/quant.py:234",
    "bn_stats": "mxnet_tpu/ops/pallas_kernels.py:217",
    "bn_apply_relu": "mxnet_tpu/ops/pallas_kernels.py:231",
    "softmax_bf16": "mxnet_tpu/ops/pallas_kernels.py:104",
    "softmax_ce_bwd_bf16": "mxnet_tpu/ops/pallas_kernels.py:112",
    "bn_stats_bf16": "mxnet_tpu/ops/pallas_kernels.py:217",
    "bn_apply_relu_bf16": "mxnet_tpu/ops/pallas_kernels.py:231",
    "embedding_bf16": "mxnet_tpu/ops/pallas_kernels.py:858",
    "layernorm_bf16": "mxnet_tpu/ops/pallas_kernels.py:585",
    "bias_gelu_bf16": "mxnet_tpu/ops/pallas_kernels.py:746",
    "decode_attention_bf16": "mxnet_tpu/ops/pallas_kernels.py:953",
    "layernorm_bwd_dx_bf16": "mxnet_tpu/ops/pallas_kernels.py:600",
    "layernorm_bwd_dparams_bf16": "mxnet_tpu/ops/pallas_kernels.py:612",
    "layernorm_bwd_bf16": "mxnet_tpu/ops/pallas_kernels.py:600",
    "bias_gelu_dx_bf16": "mxnet_tpu/ops/pallas_kernels.py:751",
    "flash_attention_bf16": "mxnet_tpu/rtc.py:301",
    "flash_attention_partial": "mxnet_tpu/rtc.py:301",
    "flash_attention_partial_bf16": "mxnet_tpu/rtc.py:301",
    "qfc_matmul_bf16": "mxnet_tpu/ops/quant.py:151",
    # no TPU kernel: jax.random's threefry in XLA, where the JAX package
    # draws Dropout's mask (its bernoulli) and the samplers' uniform bits
    "dropout": "mxnet_tpu/ops/nn.py:638",
    "dropout_bf16": "mxnet_tpu/ops/nn.py:638",
    "uniform": "mxnet_tpu/ops/tensor.py:678",
    "uniform_bf16": "mxnet_tpu/ops/tensor.py:678",
    "rtc_axpb": "mxnet_tpu/rtc.py:41",
    "relu_user": "mxnet_tpu/rtc.py:101",
    "relu_user_vjp": "mxnet_tpu/rtc.py:101",
}
REPLACES.update({k.replace("_bf16", "_f16"): v for k, v in REPLACES.items()
                 if k.endswith("_bf16")})
DECODE_KERNELS = ("embedding", "layernorm", "bias_gelu", "decode_attention")
#: phase 53: the image classifiers of models/ at their published widths,
#: each fitted ZOO_STEPS batches of ZOO_BATCH through Module.fit (name,
#: module, get_symbol kwargs, input side), and one step of each at
#: ZOO_PARITY_BATCH card vs CPU (the last entry: the input side; AlexNet
#: and VGG at the smallest they take, since their fc layers at 224 pixels
#: hold 60M and 138M weights that a CPU step copies and perturbs for ~15
#: s of the time limit; Inception-BN at 32 pixels ends in 1 x 1 BatchNorms
#: over 2 values, whose step is chaotic in float32, so it stays at 224);
#: phase 54 the bench LM with Dropout
ZOO = (("alexnet", "alexnet", {}, 224, 67),
       ("vgg16", "vgg", {"num_layers": 16}, 224, 32),
       ("inception_bn", "inception_bn", {}, 224, 224),
       ("inception_v3", "inception_v3", {}, 299, 299))
ZOO_BATCH, ZOO_STEPS, ZOO_PARITY_BATCH = 32, 3, 2
ZOO_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
LM_DROPOUT, LM_DROPOUT_STEPS = 0.1, 3
#: phases 55-56: kill and resume, RESUME_EPOCHS epochs of
#: RESUME_LM_BATCHES (the bench LM) or RESUME_R50_BATCHES (ResNet-50)
#: batches, a checkpoint every RESUME_EVERY batches, killed at RESUME_KILL;
#: RESUME_SPREAD bounds a resumed run by the uninterrupted run's own
#: repeat where that is not bit for bit. Phases 57-58: the Predictor and a
#: warm restart (ResNet-50 int8 at batch PRED_BATCH; the decode LM at
#: PRED_SLOTS slots, PRED_NEW greedy tokens)
RESUME_EPOCHS, RESUME_LM_BATCHES, RESUME_R50_BATCHES = 2, 4, 3
RESUME_EVERY, RESUME_KILL, RESUME_SPREAD = 2, (1, 1), 10.0
PRED_BATCH, PRED_SLOTS, PRED_NEW = 8, 8, 32
#: phase 59: the 16-bit samplers' draw (the CPU draws it too, in int64
#: PyTorch: the embedding table's 16.4M would take seconds there)
SAMPLER_SHAPE = (D, D)
#: phase 45 (the float16 LM step card vs CPU) at 2 of the 8 layers and T
#: 32 of 128: the card machine's CPU takes float16 matmuls slowly (45-57 s
#: for the two CPU steps at 8 layers and T 128, most of it the 32000-word
#: head), and the time limit holds the script to 720 s
F16_LM_PARITY_LAYERS, F16_LM_PARITY_SEQ = 2, 32
TRAIN_CLASSES, TRAIN_IMAGE, TRAIN_BATCH, TRAIN_STEPS = 1000, (3, 224, 224), \
    32, 8
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FWD_TOL = 1e-4          # card vs CPU forward (probabilities, moving stats)
SPREAD_FACTOR = 10.0    # card vs CPU weights, in units of the CPU's spread
LM_BATCH, LM_SEQ, LM_STEPS = 8, 1024, 8
LM_SGD = (("learning_rate", 0.05),)
LM_KERNELS = ("ln_bwd", "bias_gelu_dx", "flash_attention")
#: LM launches per training step at the bench's 8 layers: one LayerNorm
#: backward call (dx, dgamma and dbeta) per LayerNorm, none from the
#: single-half wrappers, and no update kernel (LM_SGD has no momentum:
#: sgd_update, which has no kernel, as in the JAX package)
LM_PER_STEP = {"embedding": 1, "layernorm": 2 * N_LAYER + 1,
               "ln_bwd": 2 * N_LAYER + 1,
               "bias_gelu": N_LAYER, "bias_gelu_dx": N_LAYER,
               "flash_attention": N_LAYER, "softmax": 1, "softmax_ce_bwd": 1}
#: phase 9's tokens/s and p50 / p99 step ms, read again in phase 60
LM_FIT = {}
LM_PARITY_BATCH, LM_PARITY_SEQ = 2, 128
GRAD_RTOL = 1e-4        # card vs CPU LM gradients, of each array's max |g|
LM_WEIGHT_TOL = 1e-5    # card vs CPU LM weights after one step
QUANT_RUNGS = [1, 2, 4, 8]
QUANT_REQS = 24         # requests of 1-3 rows, one every QUANT_GAP_S
QUANT_GAP_S = 0.004
#: the quantized kernels a served forward launches: the conv prologue's
#: one dequant over every conv weight, and the dense layer's matmul
QUANT_KERNELS = ("qfc_matmul", "dequant_rows_multi")
#: the quantized-forward A/B of phase 14: rung-8 forwards a turn, and the
#: turns of each arm (enough for a sign test of the paired differences to
#: reach p < 0.05 when 13 of 16 agree)
QUANT_AB_FORWARDS, QUANT_AB_TURNS = 8, 16
QUANT_PARITY_TOL = 1e-5  # card vs CPU quantized probabilities, TF32 off
QUANT_LOGIT_RTOL = 1e-4  # the same, on logits, of their largest magnitude
CBR_KERNELS = ("bn_stats", "bn_apply_relu")
BF16_KERNELS = ("softmax_bf16", "softmax_ce_bwd_bf16", "bn_stats_bf16",
                "bn_apply_relu_bf16")
#: the decode path's bfloat16 instances (phases 32-34: serve_decoder with
#: compute_dtype="bfloat16")
BF16_DECODE_KERNELS = ("embedding_bf16", "layernorm_bf16", "bias_gelu_bf16",
                       "decode_attention_bf16")
#: bfloat16 card vs CPU decode logits, atol and rtol (the JAX package's own
#: bfloat16 decode tolerance): cuBLAS and oneDNN round bfloat16 products
#: at other places
BF16_LOGIT_TOL = 2e-2
#: the 16-bit compute dtypes: counter suffix, (mantissa bits, smallest
#: normal exponent), and the decode logits' card-vs-CPU tolerance (a few
#: ulps at 1: float16's ulp is bfloat16's over 8, and so is its
#: tolerance; the float16 phases gate on BF16_SPREAD's rule instead and
#: print this ratio beside it)
HALF_SFX = {"bfloat16": "bf16", "float16": "f16"}
HALF_BITS = {"bfloat16": (7, -126), "float16": (10, -14)}
HALF_LOGIT_TOL = {"bfloat16": BF16_LOGIT_TOL, "float16": BF16_LOGIT_TOL / 8}
#: the LM-training path's bfloat16 instances (phases 35-37:
#: Module(compute_dtype="bfloat16").fit of the bench LM)
BF16_LM_KERNELS = ("layernorm_bwd_bf16", "bias_gelu_dx_bf16",
                   "flash_attention_bf16")
#: bfloat16 LM launches per training step at the bench's 8 layers: every
#: kernel of LM_PER_STEP in its bfloat16 instance, and nothing else
LM_BF16_PER_STEP = {
    "embedding_bf16": 1, "layernorm_bf16": 2 * N_LAYER + 1,
    "layernorm_bwd_bf16": 2 * N_LAYER + 1,
    "bias_gelu_bf16": N_LAYER, "bias_gelu_dx_bf16": N_LAYER,
    "flash_attention_bf16": N_LAYER, "softmax_bf16": 1,
    "softmax_ce_bwd_bf16": 1}
#: the sequence-parallel phases (46-48): the bench LM at T = 4096, batch 2
#: (8192 tokens a batch, as the LM cell's), over MeshConfig(seq=4) on
#: [gpu(0)] * 4; a causal ring of 4 launches the partial kernel 10 times a
#: layer (no launch for a wholly future shard)
RING_SEQ, RING_BATCH, RING_SHARDS, RING_STEPS = 4096, 2, 4, 4
RING_HALF_LAYERS = 2
RING_PER_LAYER = RING_SHARDS * (RING_SHARDS + 1) // 2
#: ring fit vs unsharded fit on the card, TF32 off: per-step loss and every
#: parameter after RING_STEPS SGD steps. Both compute the same attention;
#: the ring merges four shards' online softmax where the flash kernel runs
#: one over all 4096 keys, and its backward recomputes sixteen blocks where
#: the unsharded one recomputes the whole (T, T) product, so float32 sums
#: run in other orders: the LM parity phase's card-vs-CPU limits
RING_LOSS_TOL, RING_WEIGHT_TOL = 1e-4, 1e-5
#: the frozen fine-tuning phase (49): the bench LM cut to 2 layers with its
#: embedding table and the gamma / beta of every LayerNorm but the first
#: frozen (``grad_req`` "null"). The first LayerNorm's input then needs no
#: gradient (dgamma / dbeta alone: ``layernorm_bwd_dparams``) and every
#: other LayerNorm's parameters none (dx alone: ``layernorm_bwd_dx``)
FROZEN_LAYERS = 2
#: its gradients against the same step with every parameter trained: the
#: same kernel computes each half with the other off, so they should agree
#: bit for bit; the limit, of each array's largest magnitude, leaves room
#: for a library that sums in another order from one call to the next
FROZEN_GRAD_RTOL = 1e-6
#: the head-dim-32 phases (2's rows, 50): the bench LM over 16 heads, Dh
#: 32 at d_model 512, which the attention kernels take beside 64 and 128;
#: fit batches a dtype (the first excluded from the rates)
DH32_HEADS, DH32_STEPS = 16, 4
#: the attention kernels whose Dh 32 instances phase 50 must launch
DH32_KERNELS = ("decode_attention", "decode_attention_bf16",
                "flash_attention", "flash_attention_bf16",
                "flash_attention_partial")
#: the head dims between the attention kernels' tiles (phase 2's rows and
#: phase 51): the LMs there are HEADDIM_LAYERS deep at d_model 8 Dh over 8
#: heads, fitted at T HEADDIM_SEQ, batch HEADDIM_BATCH, HEADDIM_STEPS
#: batches a run
HEADDIMS = (16, 48, 80, 96, 112)
#: phase 2's device-ms rows at those head dims (cut from HEADDIMS to fit
#: the time limit; one Dh on each of the 64 and 128 tiles)
HEADDIM_ROWS = (48, 112)
HEADDIM_LAYERS, HEADDIM_SEQ, HEADDIM_BATCH, HEADDIM_STEPS = 2, 256, 4, 2
#: phase 52, inputs the card once refused: LMs at a head dim that is no
#: multiple of 16 and at one above 128 (phase 51's runs at each), a
#: prefill chunk past 64 rows at full width, an LM head past 64 K (the
#: Llama-3 vocabulary), a segmentation net (multi_output softmax over the
#: channel axis, LayerNorm over it), the fp8 ResNet-50 under bfloat16
REFUSED_DHS = (40, 256)
WIDE_PREFILL, WIDE_PREFILL_PROMPTS, WIDE_PREFILL_NEW = 128, [129, 200, 160,
                                                             140], 8
BIG_V, BIG_D, BIG_T, BIG_BATCH, BIG_STEPS = 128256, 256, 128, 4, 2
SEG_IMAGE, SEG_CLASSES, SEG_BATCH, SEG_STEPS = (3, 32, 32), 5, 8, 3
#: card vs CPU segmentation-net weights after SEG_STEPS SGD steps, of each
#: array's largest magnitude, TF32 off: cuDNN and the CPU's convolutions
#: sum in other orders (phase 10's gradient limit)
SEG_WEIGHT_RTOL = GRAD_RTOL
RESNET50 = dict(units=[3, 4, 6, 3], filter_list=[64, 256, 512, 1024, 2048],
                num_classes=TRAIN_CLASSES, image_shape=TRAIN_IMAGE)
BN = dict(fix_gamma=False, eps=2e-5, momentum=0.9)
FUSED_TOL = 1e-4        # fused vs plain ResNet-50 probabilities on the card
MFU_RTOL = 0.10         # mfu.achieved_flops_per_sec vs FLOPs / p50 step
#: bfloat16 card vs CPU (phase 25): within this many times the CPU's own
#: bfloat16-vs-float32 distance — cuDNN and oneDNN round bfloat16 at other
#: places; on a narrow ResNet the port's and the JAX package's bfloat16
#: fits differ by 0.95-2.2 times that distance (tests/test_torch_bf16.py)
BF16_SPREAD = 3.0
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores: mfu.model's peak
#: the decode fast paths (phases 19-24): the prefill chunk and the verify
#: window; 8 prompts of 65-150 tokens (more than one chunk, remainders)
PREFILL_CHUNK, SPEC_K = 64, 4
PREFILL_PROMPTS = [65, 150, 96, 127, 70, 140, 100, 129]
PREFIX_LEN, PREFIX_NEW, PREFIX_MB = 128, 8, 8
SELF_DRAFT_NEW = 24
#: the user-extension phases (28-31): user CUDA kernels through mx.rtc,
#: written here as a user writes them; REPLACES names the JAX package's
#: mechanism they go through (Rtc, register_pallas_op)
USER_KERNELS = ("rtc_axpb", "relu_user", "relu_user_vjp")
RTC_N = 1 << 24                # phase 28: 2^24 floats, 192 MiB moved
GRID_STRIDE = ("for (long long i = blockIdx.x * (long long)blockDim.x + "
               "threadIdx.x; i < {n}; i += (long long)gridDim.x * "
               "blockDim.x)\n")
AXPB_BODY = GRID_STRIDE.format(n=RTC_N) + "    out[i] = 2.0f * x[i] + y[i];"
#: relu_user computes the plain Activation(relu) of the port (and of the
#: JAX package): max(x, 0), whose gradient at x == 0 is ct / 2 as
#: torch.maximum's (and jnp.maximum's) is, where torch.relu's
#: threshold_backward gives 0 -- a batch-32 ResNet-50 step meets exact
#: zeros at a few ReLU inputs; NaN passes through both ways
RELU_BODY = GRID_STRIDE.format(n="n") + \
    "    out[i] = data[i] < 0.0f ? 0.0f : data[i];"
RELU_VJP_BODY = GRID_STRIDE.format(n="n") + \
    "    grad_data[i] = data[i] < 0.0f ? 0.0f\n" + \
    "        : (data[i] == 0.0f ? 0.5f * ct[i] : ct[i]);"
RESNET50_RELUS = 50     # Activation(act_type=relu) nodes of ResNet-50
#: phase 31: a stage-1 bottleneck without BatchNorm at batch 32
BOTTLENECK = dict(batch=32, channels=256, mid=64, hw=56)
#: card vs CPU logits over fp8 cells: the CPU step reads the card's cells,
#: but this step's new K/V row is cast on each side from float32 values
#: that differ in the last bits, and a value at an fp8 rounding boundary
#: lands one code apart (a 1/16 to 1/8 step in that element)
FP8_LOGIT_TOL = 1e-2

#: phase 60: every op name of the tensor surface on the card against the
#: CPU: the bench LM's activation (B*T, d_model) for the elementwise,
#: scalar, broadcast, reduction and indexing families, the LM head's rows
#: (B, V) for the orderings (top TS_TOPK), ResNet-50's first activation
#: for Pad and SliceChannel; arithmetic within TS_RTOL / TS_ATOL, the rest
#: exactly. Then the bench LM through a loss written in those ops for
#: CUSTOM_STEPS batches, its first-step gradients within CUSTOM_GRAD_RTOL
#: of the SoftmaxOutput head's (of each array's largest magnitude)
TS_SHAPE = (LM_BATCH * LM_SEQ, D)
TS_ORDER, TS_TOPK = (LM_BATCH, V), 40
TS_IMAGE = (TRAIN_BATCH, 64, 112, 112)
TS_RTOL, TS_ATOL = 1e-5, 1e-6
CUSTOM_STEPS, CUSTOM_GRAD_RTOL = 4, 1e-5
#: the unary ops' input ranges (the JAX package's sweep table's)
TS_UNARY = {
    "abs": (-1, 1), "arccos": (-0.8, 0.8), "arccosh": (1.3, 3.0),
    "arcsin": (-0.8, 0.8), "arcsinh": (-2, 2), "arctan": (-2, 2),
    "arctanh": (-0.7, 0.7), "ceil": (-3, 3), "cos": (-1.2, 1.2),
    "cosh": (-1.5, 1.5), "degrees": (-2, 2), "exp": (-1.5, 1.5),
    "expm1": (-1.5, 1.5), "fix": (-3, 3), "floor": (-3, 3),
    "gamma": (0.6, 2.8), "gammaln": (0.6, 2.8), "log": (0.4, 2.5),
    "log10": (0.4, 2.5), "log1p": (-0.6, 2.0), "log2": (0.4, 2.5),
    "negative": (-2, 2), "radians": (-90, 90), "rint": (-3, 3),
    "round": (-3, 3), "rsqrt": (0.4, 2.5), "sigmoid": (-2.5, 2.5),
    "sign": (-2, 2), "sin": (-1.2, 1.2), "sinh": (-1.5, 1.5),
    "sqrt": (0.4, 2.5), "square": (-2, 2), "tan": (-0.9, 0.9),
    "tanh": (-2, 2), "_copy": (-1, 1), "identity": (-1, 1),
    "BlockGrad": (-1, 1), "stop_gradient": (-1, 1), "make_loss": (-1, 1),
    "smooth_l1": (-2.5, 2.5), "Cast": (-1, 1), "cast": (-1, 1)}
#: ops whose result only moves, selects, orders or compares values, and
#: ops whose gradient does (no sums): both held exactly
TS_EXACT = {
    "_copy", "identity", "BlockGrad", "stop_gradient", "make_loss", "Cast",
    "cast", "negative", "abs", "sign", "ceil", "floor", "fix", "rint",
    "round", "broadcast_axis", "broadcast_to", "max", "min", "max_axis",
    "min_axis", "argmax", "argmin", "argmax_channel", "_zeros", "_ones",
    "_full", "zeros_like", "ones_like", "_identity_with_attr_like_rhs",
    "slice", "crop", "_slice_assign", "_crop_assign_scalar", "clip",
    "repeat", "tile", "reverse", "flip", "SwapAxis", "swapaxes", "Pad",
    "pad", "take", "batch_take", "one_hot", "pick", "where", "sort",
    "argsort", "topk", "SliceChannel", "split", "MakeLoss"}
TS_GRAD_EXACT = {
    "_copy", "identity", "BlockGrad", "stop_gradient", "make_loss", "Cast",
    "cast", "negative", "abs", "slice", "crop", "_slice_assign",
    "_crop_assign_scalar", "clip", "reverse", "flip", "SwapAxis",
    "swapaxes", "batch_take", "pick", "where", "sort", "topk",
    "SliceChannel", "split", "MakeLoss"}
#: the ops without a gradient (or with a zero one a.e.)
TS_NO_GRAD = {
    "ceil", "floor", "fix", "rint", "round", "sign", "argmax", "argmin",
    "argmax_channel", "_zeros", "_ones", "_full", "zeros_like", "ones_like",
    "one_hot", "argsort"}
TS_BINARY = ("add", "sub", "mul", "div", "power", "hypot", "maximum",
             "minimum", "equal", "not_equal", "greater", "greater_equal",
             "lesser", "lesser_equal", "mod")
TS_COMPARE = TS_BINARY[8:14]
# phase 61(a): the remaining nn layers and losses card vs CPU, TF32 off,
# at the CPU tests' limits: outputs within NN_TOL (rtol and atol), every
# input's gradient within NN_GRAD_RTOL of its largest magnitude; rrelu's
# slopes (the threefry kernel's uniform draws) bit for bit
NN_TOL, NN_GRAD_RTOL = 2e-5, 1e-5
#: Fast R-CNN's ROI pooling over VGG-16's conv5_3 of a 600 x 800 image
#: (stride 16): 128 ROIs into 7 x 7 bins; its backward's peak allocation
#: on the card beyond the inputs stays under ROI_PEAK_BYTES
ROI_REAL = ((1, 512, 38, 50), 128, (7, 7), 1.0 / 16)
ROI_PEAK_BYTES = 1 << 30
#: FlowNet-C's correlation of its conv3 features (a 384 x 512 pair at
#: stride 8): 256 channels, max_displacement 20, stride2 2, pad_size 20
CORR_REAL = ((1, 256, 48, 64), {"kernel_size": 1, "max_displacement": 20,
                                "stride1": 1, "stride2": 2, "pad_size": 20})
# phase 61(b): DCGAN (examples/dcgan.py's graph) at the widths of MXNet's
# example/gan/dcgan.py: ngf = ndf = 64, a 100-wide code, batch 64; Adam
# lr 2e-4, beta1 0.5; warm-up and timed iterations; one iteration card vs
# CPU from the same parameters and noise, TF32 off, cuDNN deterministic:
# the discriminator's and generator's outputs within GAN_OUT_ATOL, the
# moving statistics within GAN_PARAM_ATOL, every parameter within 2 lr +
# GAN_PARAM_ATOL (lr / 20), and the share of a module's elements past
# GAN_PARAM_ATOL within GAN_SPREAD times the CPU's own share, from its
# parameters moved by one float32 ulp, plus GAN_FLIP_FLOOR. Adam's first
# step moves a weight by lr * g / (|g| + eps), +-lr wherever |g| >> eps:
# an element whose gradient lies within float32 noise of 0 takes either
# sign, and its move changes the next pass's gradients by ~1e-2 of their
# largest (both on the card and in the CPU's one-ulp run)
GAN_NGF = GAN_NDF = 64
GAN_CODE, GAN_BATCH = 100, 64
GAN_WARM, GAN_ITERS = 3, 10
GAN_ADAM = {"learning_rate": 2e-4, "beta1": 0.5}
GAN_OUT_ATOL, GAN_PARAM_ATOL = 1e-5, 1e-5
GAN_SPREAD, GAN_FLIP_FLOOR = 3, 1e-4
# phase 62(b): SSD at examples/ssd/train.py's defaults (:111-116, :82-95):
# width 32, 96 x 96 images, batch 16, 128 images, 8 epochs, SGD lr 0.01,
# momentum 0.9, wd 5e-4; (c) the convergence gate of tests/test_ssd.py's
# test_ssd_trains_and_detects at its settings: width 16, lr 0.02, 6 epochs
# of 96 images
SSD_TRAIN = {"epochs": 8, "batch_size": 16, "num_images": 128,
             "data_size": 96, "width": 32, "lr": 0.01}
SSD_GATE = {"epochs": 6, "num_images": 96, "width": 16, "lr": 0.02}
SSD_SGD = {"momentum": 0.9, "wd": 5e-4}


def _timed(fn, reps=200, warm=20, rounds=3):
    """Milliseconds per call on the card: CUDA events around ``reps``
    calls after ``warm`` untimed ones, the median of ``rounds`` such runs
    (a small kernel's calls are timed at the host's pace, and the host is
    shared: one run can land in a slow moment)."""
    import torch
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / reps)
    return sorted(runs)[rounds // 2]


def _device_ms(fn, reps=50):
    """Device milliseconds per call with the L2 cold: CUDA events around
    each call alone, after 1 GiB is written (more than the 50 MB L2) so
    that the call reads its inputs from device memory as a step does.
    A spin kernel after the write keeps the card busy while the host
    enqueues the call, so the events time its kernels and the gaps
    between them, not its host work. ``_device_ms(lambda: None)`` reads
    the events' own floor."""
    import torch
    flush = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(2e9 * (3 * host_s + 2e-4))     # clock cycles, <= 2 GHz
    pairs = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _self_device_us(evt):
    return getattr(evt, "self_device_time_total", None) or \
        getattr(evt, "self_cuda_time_total", 0)


def _bound_ms(nbytes, flops, peak=F32_FLOPS_PER_S):
    """The least time for ``nbytes`` moved and ``flops`` done at the
    peak rate of the inputs' type (float32 outside the tensor cores by
    default)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _halved(names, half):
    """The bfloat16 counter names (a tuple, or a dict's keys) for the
    16-bit type ``half``."""
    sfx = "_" + HALF_SFX[half]
    if isinstance(names, dict):
        return {k.replace("_bf16", sfx): v for k, v in names.items()}
    return tuple(k.replace("_bf16", sfx) for k in names)


def _rstd_err(a, b):
    """rstd's error: absolute below 1, relative above (a row of one value,
    or of equal values, has rstd = 1 / sqrt(eps) ~ 316, where a float32
    ulp is 3e-5)."""
    import torch
    return _max_err(a / torch.clamp(b.abs(), min=1.0),
                    b / torch.clamp(b.abs(), min=1.0))


def _ln_err(ck, x, g, b):
    """The LayerNorm kernel against its plain version: the largest error
    of y, mean and rstd; its std output must be 1 / rstd bit for bit."""
    import torch
    y, stats = ck.layernorm_stats(x, g, b, 1e-5)
    ref = ck.layernorm_plain(x, g, b, 1e-5)
    if not torch.equal(stats[2], 1.0 / stats[1]):
        raise AssertionError("layernorm: std is not 1 / rstd bit for bit")
    return max(_max_err(y, ref[0]), _max_err(stats[0], ref[1]),
               _rstd_err(stats[1], ref[2]))


def _max_err(a, b):
    import torch
    a, b = a.float(), b.float()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    return float((a[~nan_a] - b[~nan_b]).abs().max()) if a.numel() else 0.0


def phase_build(ck):
    import torch
    secs = ck.build()
    print(f"build: {len(ck.KERNELS)} kernels in {secs:.1f} s "
          f"(0 when already built)")
    for name, log in sorted(ck.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(_tf32(False) + " float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()} (decode phases)")
    return smi


def _tf32(on):
    """cuDNN's TF32 switch (PyTorch's default: on); matmuls stay full
    float32. Returns the line that records it."""
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False
    return (f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def _resnet50_param_shapes(mx, batch):
    """ResNet-50's 157 parameter shapes at the training phase's input."""
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(TRAIN_CLASSES, 50, TRAIN_IMAGE)
    arg_shapes, _, _ = sym.infer_shape(data=(batch,) + TRAIN_IMAGE)
    return [s for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")]


def phase_kernels(mx, ck):
    """Each kernel against its plain version at its path's shapes (and
    edge shapes). Returns {name: record} for the result line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    rec = {}
    part = _PhaseClock()
    # 1. embedding: 8 ids into the (32000, 512) table, scale sqrt(512)
    ids = t(rs.randint(0, V, 8), torch.int32)
    w = t(rs.randn(V, D).astype(np.float32))
    scale = float(np.sqrt(D))
    err = _max_err(ck.embedding(ids, w, scale),
                   ck.embedding_plain(ids, w, scale))
    bad = t([-1, V, -V - 1, 5], torch.int32)        # out-of-range ids
    err = max(err, _max_err(ck.embedding(bad, w, scale),
                            ck.embedding_plain(bad, w, scale)))
    n = ids.numel()
    rec["embedding"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.embedding(ids, w, scale)),
        plain_ms=_timed(lambda: ck.embedding_plain(ids, w, scale)),
        library_ms=None,    # no single PyTorch call gathers AND scales
        bound=_bound_ms(n * 4 + 2 * n * D * 4, n * D))
    # 2. LayerNorm: (8, 512), eps 1e-5
    x = t(rs.randn(8, D).astype(np.float32))
    g = t(1 + 0.1 * rs.randn(D).astype(np.float32))
    b = t(0.1 * rs.randn(D).astype(np.float32))
    err = 0.0
    for xx, gg, bb in [(x, g, b)] + [
            (t(3 * rs.randn(*e).astype(np.float32) + 1),
             t(1 + 0.1 * rs.randn(e[1]).astype(np.float32)),
             t(0.1 * rs.randn(e[1]).astype(np.float32))) for e in LN_EDGES]:
        err = max(err, _ln_err(ck, xx, gg, bb))
    rec["layernorm"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.layernorm(x, g, b, 1e-5)),
        plain_ms=_timed(lambda: ck.layernorm_plain(x, g, b, 1e-5)),
        library_ms=_timed(lambda: F.layer_norm(x, (D,), g, b, 1e-5)),
        library_call=lambda: F.layer_norm(x, (D,), g, b, 1e-5),
        bound=_bound_ms(2 * x.numel() * 4 + 2 * D * 4 + 2 * 8 * 4,
                        8 * x.numel()))
    # 3. bias + GeLU: (8, 2048)
    h = t(rs.randn(8, 4 * D).astype(np.float32))
    hb = t(0.1 * rs.randn(4 * D).astype(np.float32))
    err = _max_err(ck.bias_gelu(h, hb), ck.bias_gelu_plain(h, hb))
    rec["bias_gelu"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.bias_gelu(h, hb)),
        plain_ms=_timed(lambda: ck.bias_gelu_plain(h, hb)),
        library_ms=None,    # bias add + GeLU is two PyTorch calls
        bound=_bound_ms(2 * h.numel() * 4 + hb.numel() * 4,
                        8 * h.numel()))
    # 4. decode attention: B=8, H=8, C=256, Dh=64, staggered cursors,
    #    S=1 (the served step) and S=16 (a window the kernel also takes)
    B, H, Dh = 8, N_HEAD, D // N_HEAD
    kc = t(rs.randn(B, H, CAP, Dh).astype(np.float32))
    vc = t(rs.randn(B, H, CAP, Dh).astype(np.float32))
    err = 0.0
    for S, cursors in ((1, [0, 1, 127, 128, 255, 63, 200, 31]),
                       (16, [0, 1, 127, 128, 240, 63, 200, 31])):
        q = t(rs.randn(B, H, S, Dh).astype(np.float32))
        pos = t(cursors, torch.int32)
        err = max(err, _max_err(ck.decode_attention(q, kc, vc, pos),
                                ck.decode_attention_plain(q, kc, vc, pos)))
        if S == 1:
            q1, pos1 = q, pos
    live = np.minimum(CAP, np.asarray([0, 1, 127, 128, 255, 63, 200, 31])
                      + 1)
    mask = (torch.arange(CAP, device=dev)[None, None, None, :]
            <= pos1.long()[:, None, None, None])
    def sdpa_decode():
        return F.scaled_dot_product_attention(q1, kc, vc, attn_mask=mask)
    rec["decode_attention"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.decode_attention(q1, kc, vc, pos1)),
        plain_ms=_timed(lambda: ck.decode_attention_plain(q1, kc, vc, pos1)),
        library_ms=_timed(sdpa_decode), library_call=sdpa_decode,
        bound=_bound_ms(
            2 * q1.numel() * 4 + B * 4 + int(live.sum()) * H * Dh * 4 * 2,
            int(live.sum()) * H * Dh * 4))
    calls = {"embedding": lambda: ck.embedding(ids, w, scale),
             "layernorm": lambda: ck.layernorm(x, g, b, 1e-5),
             "bias_gelu": lambda: ck.bias_gelu(h, hb),
             "decode_attention": lambda: ck.decode_attention(q1, kc, vc,
                                                             pos1)}
    part("2a (the decode kernels, float32)")
    _decode_window_rows(ck, rs, t, kc, vc)
    _decode_long_rows(ck, rs, t)
    calls.update(_decode_fp8_kernel(ck, rs, t, rec, kc, vc, q1, pos1))
    f32 = dict(ids=ids, w=w, scale=scale, x=x, g=g, b=b, h=h, hb=hb, kc=kc,
               vc=vc, q1=q1, pos1=pos1, mask=mask, live=live)
    for half in HALF_SFX:
        calls.update(_bf16_decode_kernels(ck, rs, t, rec, f32, half))
    part("2b (decode rows, fp8 and 16-bit decode kernels)")
    calls.update(_training_kernels(mx, ck, rs, t, rec))
    calls.update(_lm_kernels(ck, rs, t, rec))
    calls.update(_ring_kernels(ck, rs, t, rec))
    part("2c (training, LM and ring kernels)")
    _headdim32_rows(ck, rs, t)
    part("2d (head dim 32 rows)")
    _headdim_rows(ck, rs, t)
    part("2e (head dims 16 to 112 rows)")
    _flash_tensor_cores(ck)
    _row_kernel_resources(ck)
    part("2f (tensor cores, registers and spills)")
    for half in HALF_SFX:
        calls.update(_lm_bf16_kernels(ck, rs, t, rec, half))
    part("2g (16-bit LM kernels)")
    calls.update(_quant_kernels(mx, ck, rs, t, rec))
    calls.update(_quant_half_kernels(ck, rs, t, rec))
    _qfc_rungs(ck, rs, t)
    part("2h (quantized kernels)")
    calls.update(_bn_kernels(mx, ck, rs, t, rec))
    for half in HALF_SFX:
        calls.update(_bf16_kernels(mx, ck, rs, t, rec, half))
    part("2i (BatchNorm and 16-bit ResNet kernels)")
    calls.update(_threefry_kernels(ck, rs, t, rec))
    part("2j (threefry)")
    _launch_path_probe(ck)
    part("2k (launch path)")
    print("kernels: device_ms is CUDA events around each call with 1 GiB "
          "written before it (inputs read from device memory); the events' "
          f"floor (no call) {_device_ms(lambda: None):.6f} ms")
    for name, r in rec.items():
        dev_ms = _device_ms(calls[name])
        err = r.get("ulps", r.get("rel_err", r["max_abs_err"]))
        # the library call's device time, where the kernel's ms is mostly
        # the host's launch path (LayerNorm at the decode shape), and
        # where the next redesigns are ranked by device time (rows 4, 11 +
        # 12, 14 and 17)
        lib_dev = (f"library_device_ms={_device_ms(r['library_call'])} "
                   if "library_call" in r else "")
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} "
              + (f"rel_err={err:.3g} " if "rel_err" in r else "")
              + (f"ulps={err:.3g} " if "ulps" in r else "")
              + f"(tol {TOL[name]}) kernel_ms={r['ms']:.5f} "
              f"device_ms={dev_ms} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']} {lib_dev}"
              f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})")
        if not err <= TOL[name]:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {err} > {TOL[name]}")
    part("2l (device ms of every kernel)")
    return rec


def _host_path_us(fn, reps=500, warm=50):
    """Host microseconds per call of ``fn``: ``time.perf_counter_ns``
    around ``reps`` calls (the card synchronized before; the launches it
    makes are not waited for)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def _launch_path_probe(ck):
    """The host's launch path of the LayerNorm and softmax wrappers at
    the decode and ResNet-50 head shapes (float32), piece by piece: each
    piece as the earlier path did it ("was", re-enacted here) and as the
    wrappers do it now, host microseconds per call; then the whole
    wrappers, the earlier wrapper re-enacted, and the one PyTorch call. The
    re-enactment calls today's C entry point (one more pointer, a scratch
    std) and counts into a scratch dict."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(8, D, device=dev, generator=gen)
    g, b = torch.randn(D, device=dev, generator=gen), \
        torch.randn(D, device=dev, generator=gen)
    xs = torch.randn(TRAIN_BATCH, TRAIN_CLASSES, device=dev, generator=gen)
    n, c = x.shape
    fn_ln, ctr_ln = ck._fn("layernorm", "f32")
    fn_sm, _ = ck._fn("softmax", "f32")
    y, ys = torch.empty_like(x), torch.empty_like(xs)
    stats = torch.empty((3, n), dtype=torch.float32, device=dev)
    scratch = torch.empty((n,), dtype=torch.float32, device=dev)
    p = stats.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    ln_args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), p,
               p + 4 * n, p + 8 * n, n, c, 1e-5, stream)
    sm_args = (xs.data_ptr(), ys.data_ptr(), *xs.shape, stream)
    counts = dict.fromkeys(ck.COUNTERS, 0)
    old_fns = {("layernorm", "mx_layernorm_fwd_f32"): fn_ln,
               ("softmax", "mx_softmax_f32"): fn_sm}

    def old_check(name, **tensors):        # the earlier _check
        dev_ = None
        for key, (t, dtype) in tensors.items():
            if t.device.type != "cuda":
                raise AssertionError(key)
            if dev_ is not None and t.device != dev_:
                raise AssertionError(key)
            dev_ = t.device
            if t.dtype != dtype:
                raise AssertionError(key)
            if not t.is_contiguous():
                raise AssertionError(key)

    def old_fn(name, key):                 # the earlier two-level lookup
        return old_fns.get((name, ck._SPECS[name][1][key]))

    def old_device():
        with torch.cuda.device(x.device):
            pass

    def old_count(name):
        counts[ck._counter(name, "f32")] += 1

    def new_count():
        counts[ctr_ln] += 1

    def old_layernorm(x2, gamma, beta, eps):
        if x2.device.type != "cuda":
            raise AssertionError("cpu")
        key = ck._instance("layernorm", x2)
        old_check("layernorm", x=(x2, x2.dtype), gamma=(gamma, x2.dtype),
                  beta=(beta, x2.dtype))
        if x2.ndim != 2:
            raise AssertionError("ndim")
        n_, c_ = x2.shape
        if gamma.shape != (c_,) or beta.shape != (c_,):
            raise AssertionError("shape")
        y_ = torch.empty_like(x2)
        mean = torch.empty((n_,), dtype=torch.float32, device=x2.device)
        rstd = torch.empty((n_,), dtype=torch.float32, device=x2.device)
        with torch.cuda.device(x2.device):
            st = torch.cuda.current_stream(x2.device).cuda_stream
            err = old_fn("layernorm", key)(
                x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y_.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                scratch.data_ptr(), n_, c_, float(eps), st)
        if err != 0:
            raise AssertionError(err)
        old_count("layernorm")
        return y_, mean, rstd

    def old_softmax(x2):
        if x2.device.type != "cuda":
            raise AssertionError("cpu")
        key = ck._instance("softmax", x2)
        old_check("softmax", x=(x2, x2.dtype))
        if x2.ndim != 2 or x2.shape[1] > ck.SOFTMAX_MAX_C:
            raise AssertionError("shape")
        n_, c_ = x2.shape
        y_ = torch.empty_like(x2)
        with torch.cuda.device(x2.device):
            st = torch.cuda.current_stream(x2.device).cuda_stream
            err = old_fn("softmax", key)(x2.data_ptr(), y_.data_ptr(), n_,
                                         c_, st)
        if err != 0:
            raise AssertionError(err)
        old_count("softmax")
        return y_

    def old_op(x2, gamma, beta, eps):     # the op: Function, 1 / rstd
        y_, mean, rstd, _ = ck._LayerNormFn.apply(x2, gamma, beta, eps)
        return y_, mean, 1.0 / rstd

    checks = dict(x=(x, x.dtype), gamma=(g, x.dtype), beta=(b, x.dtype))
    pieces = [
        ("device test", lambda: x.device.type == "cuda", lambda: x.is_cuda),
        ("instance key", lambda: ck._instance("layernorm", x),
         lambda: ck._instance("layernorm", x)),
        ("check (3 tensors)", lambda: old_check("layernorm", **checks),
         lambda: ck._check("layernorm", **checks)),
        ("outputs", lambda: (torch.empty_like(x), torch.empty(
            (n,), dtype=torch.float32, device=x.device), torch.empty(
            (n,), dtype=torch.float32, device=x.device)),
         lambda: (torch.empty_like(x), x.new_empty((3, n),
                                                    dtype=torch.float32))),
        ("statistics views", lambda: None, lambda: (stats[0], stats[1])),
        ("device switch", old_device,
         lambda: x.get_device() == torch._C._cuda_getDevice()),
        ("stream", lambda: torch.cuda.current_stream(x.device).cuda_stream,
         lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("bound function", lambda: old_fn("layernorm", "f32"),
         lambda: ck._fns.get(("layernorm", "f32"))),
        ("ctypes call + launch", lambda: fn_ln(*ln_args),
         lambda: fn_ln(*ln_args)),
        ("launch counter", lambda: old_count("layernorm"), new_count),
        ("op's std (1 / rstd)", lambda: 1.0 / stats[1], lambda: None),
        ("autograd.Function under no_grad",
         lambda: ck._LayerNormFn.apply(x, g, b, 1e-5), lambda: None),
    ]

    def medians(*fns, rounds=5):
        """Each call's host us, the calls timed in turns, median of
        ``rounds`` (the host is shared: a piece timed alone can land in a
        slow moment)."""
        runs = [[_host_path_us(f) for f in fns] for _ in range(rounds)]
        return [sorted(r[i] for r in runs)[rounds // 2]
                for i in range(len(fns))]
    floor, = medians(lambda: None)
    print(f"launch path: host us per call (time.perf_counter_ns around 500 "
          f"calls, was and now in turns, median of 5; an empty call "
          f"{floor:.3f} us, not subtracted), LayerNorm at ({n}, {c}) "
          f"float32, was (the earlier path, re-enacted) -> now")
    with torch.no_grad():
        for name, was, now in pieces:
            a, b_ = medians(was, now)
            print(f"launch path: {name}: {a:.3f} -> {b_:.3f}")
        whole = [
            ("layernorm wrapper", lambda: old_layernorm(x, g, b, 1e-5),
             lambda: ck.layernorm(x, g, b, 1e-5),
             lambda: F.layer_norm(x, (c,), g, b, 1e-5)),
            # F.layer_norm hands Python one tensor; these, three
            ("layernorm wrapper against the three-output call",
             lambda: old_layernorm(x, g, b, 1e-5),
             lambda: ck.layernorm(x, g, b, 1e-5),
             lambda: torch.native_layer_norm(x, (c,), g, b, 1e-5)),
            ("layernorm_stats (y and one statistics block)",
             lambda: old_layernorm(x, g, b, 1e-5),
             lambda: ck.layernorm_stats(x, g, b, 1e-5),
             lambda: F.layer_norm(x, (c,), g, b, 1e-5)),
            ("LayerNorm op (fused_layernorm, no grad)",
             lambda: old_op(x, g, b, 1e-5),
             lambda: ck.fused_layernorm(x, g, b, 1e-5),
             lambda: F.layer_norm(x, (c,), g, b, 1e-5)),
            (f"softmax wrapper {tuple(xs.shape)}",
             lambda: old_softmax(xs), lambda: ck.softmax(xs),
             lambda: torch.softmax(xs, -1)),
            ("softmax ctypes call + launch", lambda: fn_sm(*sm_args),
             lambda: fn_sm(*sm_args), lambda: torch.softmax(xs, -1))]
        # the LayerNorm backward: the two calls a LayerNorm made before
        # (today's single-half wrappers) -> the one call
        ct = torch.randn(n, c, device=dev, generator=gen)
        _, m, r = ck.layernorm_plain(x, g, b, 1e-5)
        _, lm, lr = torch.ops.aten.native_layer_norm(x, (c,), g, b, 1e-5)
        whole.append((
            f"LayerNorm backward at ({n}, {c}): two single-half wrappers "
            "-> layernorm_bwd",
            lambda: (ck.layernorm_bwd_dx(x, g, ct, m, r),
                     ck.layernorm_bwd_dparams(x, ct, m, r)),
            lambda: ck.layernorm_bwd(x, g, ct, m, r),
            lambda: torch.ops.aten.native_layer_norm_backward(
                ct, x, (c,), lm, lr, g, b, [True, True, True])))
        for name, was, now, lib in whole:
            a, b_, l_ = medians(was, now, lib)
            print(f"launch path: {name}: {a:.3f} -> {b_:.3f} (one PyTorch "
                  f"call: {l_:.3f}; now / PyTorch {b_ / l_:.2f})")


def _row_kernel_resources(ck):
    """ptxas' registers and spills of every softmax, LayerNorm,
    LayerNorm-backward and decode-read instance; the row-resident designs
    and the decode read may not spill."""
    spills = []
    for lib in ("softmax", "layernorm", "ln_bwd", "decode_attention",
                "decode_attention_16", "decode_attention_fp8",
                "decode_attention_any"):
        for fn, r in sorted(ck.resources(lib, sass=False).items()):
            if "registers" not in r:
                continue
            print(f"resources {lib}: {fn}: registers={r['registers']} "
                  f"spill_stores={r.get('spill_stores')} "
                  f"spill_loads={r.get('spill_loads')}")
            if r.get("spill_stores") or r.get("spill_loads"):
                spills.append(fn)
    if spills:
        raise AssertionError(f"spilling row kernels: {spills}")


#: the decode read's instances: cache dtype name, query dtype name
DECODE_INSTANCES = (("float32", "float32"), ("bfloat16", "bfloat16"),
                    ("float16", "float16"), ("float8_e4m3fn", "float32"),
                    ("float8_e5m2", "float32"))
#: the prefill window's row (S = PREFILL_CHUNK at the served shape) and
#: the long-context rows (C = 4096, every cursor at its end, S = 1)
WINDOW_CURSORS = [0, 1, 127, 128, 192, 63, 150, 31]
LONG_CAP = 4096


def _decode_caches(ck, rs, t, cache_dt, B, H, C, Dh, base=None):
    """K and V caches of one instance from the same float32 draws (new
    ones, or ``base``, a float32 pair drawn once for several instances):
    16-bit caches rounded once, fp8 ones cast as the decode path casts
    them."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.rtc import fp8_cast
    dt = getattr(torch, cache_dt)
    if base is None:
        base = [t(rs.randn(B, H, C, Dh).astype(np.float32))
                for _ in range(2)]
    return [fp8_cast(c, dt) if dt in (torch.float8_e4m3fn, torch.float8_e5m2)
            else c.to(dt) for c in base]


def _decode_row(ck, name, q, kc, vc, pos, live_keys, scores, sdpa=True):
    """One decode read against its plain version (within TOL) and timed:
    device ms (L2 flushed) beside its bound (``live_keys`` K and V rows
    read, ``scores`` live (query, key) pairs of 4 Dh flops each, at the
    float32 peak, or the 16-bit one for 16-bit inputs) and, where SDPA
    takes the dtype, SDPA's device ms with the same cursor mask. Prints
    one line."""
    import torch
    import torch.nn.functional as F
    B, H, S, Dh = q.shape
    C = kc.shape[2]
    err = _max_err(ck.decode_attention(q, kc, vc, pos),
                   ck.decode_attention_plain(q, kc, vc, pos))
    if not err <= TOL["decode_attention"]:
        raise AssertionError(f"{name}: decode_attention disagrees with its "
                             f"plain version: {err}")
    nbytes = (q.numel() * (q.element_size() + 4) + B * 4
              + 2 * live_keys * H * Dh * kc.element_size())
    bound = _bound_ms(nbytes, 4 * scores * H * Dh,
                      BF16_FLOPS_PER_S if q.element_size() == 2
                      else F32_FLOPS_PER_S)
    dev_ms = _device_ms(lambda: ck.decode_attention(q, kc, vc, pos))
    line = (f"{name}: max_abs_err={err:.3g} device_ms={dev_ms:.6f} "
            f"bound_ms={bound[0]:.6f} ({bound[1]}) "
            f"x_bound={dev_ms / bound[0]:.2f}")
    if sdpa:
        q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)
        mask = (torch.arange(C, device=q.device)[None, None, :]
                <= q_pos[:, :, None])[:, None]
        def call():
            return F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)
        lib = _device_ms(call)
        line += f" sdpa_device_ms={lib:.6f} kernel/sdpa={dev_ms / lib:.2f}"
    else:
        line += " sdpa_device_ms=- (SDPA needs a dequantized copy)"
    print(line)
    return dev_ms


def _decode_window_rows(ck, rs, t, kc, vc, label="decode window",
                        instances=DECODE_INSTANCES):
    """The prefill window: S = 64 at the served shape (B 8, H 8, C 256,
    Dh 64, or the shape of ``kc``), cursors WINDOW_CURSORS, each of
    ``instances`` (every one by default), SDPA beside the 16-bit and
    float32 ones."""
    import numpy as np
    import torch
    B, H, C, Dh = kc.shape
    pos = t(WINDOW_CURSORS, torch.int32)
    cur = np.asarray(WINDOW_CURSORS)
    live = int(np.minimum(C, cur + PREFILL_CHUNK).sum())
    scores = int(np.minimum(C, cur[:, None] + np.arange(PREFILL_CHUNK) + 1)
                 .sum())
    for cache_dt, q_dt in instances:
        caches = (kc, vc) if cache_dt == "float32" else _decode_caches(
            ck, rs, t, cache_dt, B, H, C, Dh)
        q = t(rs.randn(B, H, PREFILL_CHUNK, Dh).astype(np.float32)).to(
            getattr(torch, q_dt))
        _decode_row(ck, f"{label} S={PREFILL_CHUNK} {cache_dt}", q,
                    *caches, pos, live, scores,
                    sdpa=not cache_dt.startswith("float8"))


def _decode_long_rows(ck, rs, t):
    """The long-context rows: B 8, H 8, C = 4096, S 1, every cursor at
    4095, Dh 64 and 128, every instance: the bytes (134.2 MB float32 at
    Dh 64) bound the call, unlike the served step's 256 keys."""
    import numpy as np
    import torch
    B, H = 8, N_HEAD
    pos = t([LONG_CAP - 1] * B, torch.int32)
    for dh in (64, 128):
        # one float32 draw a Dh for every instance: 2 x 33.5M (Dh 128)
        # normals from numpy take seconds on the card machine's host
        base = [t(rs.randn(B, H, LONG_CAP, dh).astype(np.float32))
                for _ in range(2)]
        for cache_dt, q_dt in DECODE_INSTANCES:
            kc, vc = _decode_caches(ck, rs, t, cache_dt, B, H, LONG_CAP, dh,
                                    base)
            q = t(rs.randn(B, H, 1, dh).astype(np.float32)).to(
                getattr(torch, q_dt))
            _decode_row(ck, f"decode long C={LONG_CAP} Dh={dh} {cache_dt}",
                        q, kc, vc, pos, B * LONG_CAP, B * LONG_CAP,
                        sdpa=not cache_dt.startswith("float8"))
            del kc, vc
        del base
        torch.cuda.empty_cache()


def _decode_fp8_kernel(ck, rs, t, rec, kc, vc, q1, pos1):
    """The flash-decode kernel's fp8 instances: the f32 row's caches cast
    as the decode path casts them (``rtc.fp8_cast``, whose bytes on the
    card must be its bytes on the CPU), at the served S=1 step and at the
    S=4 (verify) and S=64 (prefill) windows; edges: cursors 0, mid and
    C - S, a reused slot (cursor 0 over stale rows), Dh 128, NaN cells in
    a live prefix. Timed with float8_e4m3fn at the served step (e5m2
    printed beside). Fills ``rec``; returns the timed call."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.rtc import fp8_cast
    dtypes = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    edge = np.asarray([0.0, -0.0, 448.0, -448.0, 463.9, 464.0, 465.0, 1000.0,
                       -500.0, np.nan, np.inf, -np.inf, 2.0 ** -9, 2.0 ** -10,
                       2.0 ** -17, 1e-40, 57344.0, 61440.0], np.float32)
    x = np.concatenate([(rs.randn(100000) * 10 ** rs.uniform(-6, 5, 100000))
                        .astype(np.float32), edge])
    for dt in dtypes.values():
        card = fp8_cast(t(x), dt).view(torch.uint8).cpu()
        host = fp8_cast(torch.from_numpy(x), dt).view(torch.uint8)
        if not torch.equal(card, host):
            raise AssertionError(f"fp8_cast to {dt}: card and CPU bytes "
                                 "differ")
    B, H, C, Dh = kc.shape
    err = 0.0
    for dt in dtypes.values():
        for S, dh in ((1, Dh), (4, Dh), (64, Dh), (1, 128), (64, 128)):
            k8, v8 = (fp8_cast(t(3 * rs.randn(B, H, C, dh)), dt)
                      for _ in range(2))
            q = t(rs.randn(B, H, S, dh).astype(np.float32))
            cur = [0, (C - S) // 2, C - S, 5, 0, 1, 200 % (C - S + 1), 31]
            pos = t(cur, torch.int32)
            err = max(err, _max_err(ck.decode_attention(q, k8, v8, pos),
                                    ck.decode_attention_plain(q, k8, v8,
                                                              pos)))
        nan = int(fp8_cast(torch.tensor([float("nan")]), dt)
                  .view(torch.uint8))
        k8.view(torch.uint8)[1, 0, 3, 5] = nan   # live for row 1 (mid)
        v8.view(torch.uint8)[2, 1, 7, 9] = nan   # live for row 2 (C - S)
        got = ck.decode_attention(q, k8, v8, pos)
        err = max(err, _max_err(got, ck.decode_attention_plain(q, k8, v8,
                                                               pos)))
        if not (got[1, 0].isnan().all() and got[2, 1, :, 9].isnan().all()
                and not got[0].isnan().any()):
            raise AssertionError("decode_attention_fp8: NaN cells do not "
                                 "pass through as in the plain version")
    k8, v8 = (fp8_cast(c, dtypes["e4m3"]) for c in (kc, vc))
    e5 = [fp8_cast(c, dtypes["e5m2"]) for c in (kc, vc)]
    live = np.minimum(C, np.asarray([0, 1, 127, 128, 255, 63, 200, 31]) + 1)
    print(f"kernels: decode_attention_fp8 at the served step, e5m2 "
          f"{_timed(lambda: ck.decode_attention(q1, *e5, pos1)):.5f} ms; "
          "fp8_cast gives the same bytes on the card and the CPU")
    rec["decode_attention_fp8"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.decode_attention(q1, k8, v8, pos1)),
        plain_ms=_timed(lambda: ck.decode_attention_plain(q1, k8, v8, pos1)),
        library_ms=None,    # no one PyTorch call reads fp8 K/V (SDPA
        bound=_bound_ms(    # needs a dequantized copy first)
            2 * q1.numel() * 4 + B * 4 + int(live.sum()) * H * Dh * 1 * 2,
            int(live.sum()) * H * Dh * 4))
    return {"decode_attention_fp8": lambda: ck.decode_attention(q1, k8, v8,
                                                                pos1)}


def _training_kernels(mx, ck, rs, t, rec):
    """The four training kernels at the ResNet-50 path's shapes: the
    (32, 1000) head, and the optimizer over all 157 parameter arrays of
    one step (so ms and bound are per training step). Fills ``rec``;
    returns the timed calls."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.loss import softmax_output
    N, C = TRAIN_BATCH, TRAIN_CLASSES
    # 5. softmax: (32, 1000), then SOFTMAX_EDGES
    x = t(4 * rs.randn(N, C).astype(np.float32))
    err = _max_err(ck.softmax(x), ck.softmax_plain(x))
    for shape in SOFTMAX_EDGES:
        e = t(4 * rs.randn(*shape).astype(np.float32))
        err = max(err, _max_err(ck.softmax(e), ck.softmax_plain(e)))
    rec["softmax"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.softmax(x)),
        plain_ms=_timed(lambda: ck.softmax_plain(x)),
        library_ms=_timed(lambda: torch.softmax(x, -1)),
        library_call=lambda: torch.softmax(x, -1),
        bound=_bound_ms(2 * N * C * 4, 5 * N * C))
    # 6. cross-entropy backward: labels in range, past C and negative;
    #    the op's ignore mask and "valid" normalization through autograd
    p = ck.softmax_plain(x)
    lab = t(np.concatenate([rs.randint(0, C, N - 3), [C, -1, C - 1]])
            .astype(np.float32))
    err = max(_max_err(ck.softmax_ce_bwd(p, lab, s, u, -1.0),
                       ck.softmax_ce_bwd_plain(p, lab, s, u, -1.0))
              for s in (1.0, 1 / N) for u in (False, True))
    attrs = mx.ops.get_op("SoftmaxOutput").normalize_attrs(
        {"use_ignore": True, "normalization": "valid"})
    grads = []
    for fns in ({"softmax": ck.softmax, "ce_grad": ck.softmax_ce_bwd}, {}):
        xx = x.clone().requires_grad_(True)
        softmax_output(xx, lab, attrs, **fns).sum().backward()
        grads.append(xx.grad)
    err = max(err, _max_err(*grads))
    rec["softmax_ce_bwd"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.softmax_ce_bwd(p, lab, 1.0)),
        plain_ms=_timed(lambda: ck.softmax_ce_bwd_plain(p, lab, 1.0)),
        library_ms=None,     # no one PyTorch call emits this gradient
        bound=_bound_ms(2 * N * C * 4 + N * 4, 3 * N * C))
    # 7./8. the updates, over one step's 157 arrays, plus an odd length:
    # the multi-tensor kernel (Module.update's one launch a step) and the
    # per-array kernel (157 launches), timed in the same call
    shapes = _resnet50_param_shapes(mx, N)
    n_el = sum(int(np.prod(s)) for s in shapes)
    big = max(shapes, key=lambda s: int(np.prod(s)))
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hp = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale=1 / N, clip=-1.0)
    ah = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-4,
              rescale=1 / N, clip=-1.0)
    err = {"sgd_mom": 0.0, "adam": 0.0}
    for s in (big, (1000003,)):
        w, g, m = (torch.randn(s, device=dev, generator=gen)
                   for _ in range(3))
        var = torch.rand(s, device=dev, generator=gen)
        for clip in (-1.0, 0.01):
            h = dict(hp, clip=clip)
            err["sgd_mom"] = max(err["sgd_mom"], max(
                _max_err(a, b) for a, b in zip(
                    ck.sgd_mom_update(w.clone(), g, m.clone(), **h),
                    ck.sgd_mom_update_plain(w, g, m, **h))))
        err["adam"] = max(err["adam"], max(_max_err(a, b) for a, b in zip(
            ck.adam_update(w.clone(), g, m.clone(), var.clone(), **ah),
            ck.adam_update_plain(w, g, m, var, **ah))))
    calls = {}
    for name, ops, per in (("sgd_mom", 3, hp), ("adam", 4, ah)):
        lists = _update_lists(shapes, ops, gen)
        arrays = list(zip(*lists))
        one = getattr(ck, name + "_update")
        plain = getattr(ck, name + "_update_plain")
        calls[name] = functools.partial(_per_array, one, arrays, per)
        rec[name] = dict(
            max_abs_err=err[name], ms=_timed(calls[name], reps=50, warm=5),
            plain_ms=_timed(functools.partial(_per_array, plain, arrays,
                                              per), reps=20, warm=2,
                            rounds=PLAIN_ROUNDS),
            # torch.optim.SGD keeps buf = mu * buf + g; torch.optim.Adam
            # places epsilon elsewhere
            library_ms=None, bound=_update_bound(name, n_el))
        multi = _multi_row(ck, name, shapes, gen, per)
        rec[name + "_multi"] = multi
        calls[name + "_multi"] = multi.pop("call")
    _multi_lm_rows(mx, ck, gen, hp, ah)
    print(f"kernels: the updates are timed over one ResNet-50 step: "
          f"{len(shapes)} arrays, {n_el} elements, largest {big}; "
          "library_ms / library_device_ms of the multi rows: "
          "torch._fused_sgd_ (momentum 0.9) / torch._fused_adam_ over the "
          "same arrays: the same bytes, not the same function")
    return {"softmax": lambda: ck.softmax(x),
            "softmax_ce_bwd": lambda: ck.softmax_ce_bwd(p, lab, 1.0),
            **calls}


#: each update's bytes an element (inputs read once, outputs written
#: once: SGD-momentum reads w, g, m and writes w, m; Adam reads w, g,
#: mean, var and writes w, mean, var) and float32 operations an element
UPDATE_BYTES = {"sgd_mom": 20, "adam": 28}
UPDATE_FLOPS = {"sgd_mom": 7, "adam": 14}


def _update_bound(name, n_el):
    return _bound_ms(UPDATE_BYTES[name] * n_el, UPDATE_FLOPS[name] * n_el)


def _update_lists(shapes, ops, gen):
    """``ops`` operand lists over ``shapes`` on the card (the last of
    Adam's four, its var, non-negative)."""
    import torch
    return [[torch.randn(s, device=gen.device, generator=gen).abs_()
             if j == 3 else torch.randn(s, device=gen.device, generator=gen)
             for s in shapes] for j in range(ops)]


def _per_array(fn, arrays, hyper):
    """``fn`` (a per-array update or its plain version) over each
    array's operands."""
    return [fn(*a, **hyper) for a in arrays]


def _multi_args(name, lists, hyper):
    """The positional arguments of ``<name>_update_multi`` (and of its
    plain version) over ``lists``, every array with ``hyper``'s lr and
    wd."""
    n = len(lists[0])
    rest = ((hyper["momentum"],) if name == "sgd_mom" else
            (hyper["beta1"], hyper["beta2"], hyper["epsilon"]))
    return (*lists, [hyper["lr"]] * n, [hyper["wd"]] * n, *rest,
            hyper["rescale"], hyper["clip"])


def _fused_library(name, lists, hyper):
    """PyTorch's own multi-tensor update over the same arrays: the same
    bytes, not the same function (its momentum buffer takes g, its
    epsilon sits elsewhere)."""
    import torch
    if name == "sgd_mom":
        return functools.partial(
            torch._fused_sgd_, lists[0], lists[1], lists[2],
            weight_decay=hyper["wd"], momentum=hyper["momentum"],
            lr=hyper["lr"], dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
    steps = [torch.tensor(3.0, device=lists[0][0].device) for _ in lists[0]]
    return functools.partial(
        torch._fused_adam_, lists[0], lists[1], lists[2], lists[3], [], steps,
        lr=hyper["lr"], beta1=hyper["beta1"], beta2=hyper["beta2"],
        weight_decay=hyper["wd"], eps=hyper["epsilon"], amsgrad=False,
        maximize=False)


def _multi_row(ck, name, shapes, gen, hyper):
    """The multi-tensor kernel's record over ``shapes``: its error against
    its plain version on the same lists (with clip, and lengths around a
    vector and a chunk), required bit for bit the per-array kernel's on
    copies; ``call``, the timed launch."""
    import torch
    multi = getattr(ck, name + "_update_multi")
    plain = getattr(ck, name + "_update_multi_plain")
    one = getattr(ck, name + "_update")
    ops = 3 if name == "sgd_mom" else 4
    err, same = 0.0, True
    for case, clip in ((shapes, -1.0), (shapes, 0.01),
                       ([(1,), (3,), (4,), (5,), (4097,), (1000003,)], 0.01)):
        h = dict(hyper, clip=clip)
        lists = _update_lists(case, ops, gen)
        copies = [[t.clone() for t in op] for op in lists]
        want = plain(*_multi_args(name, lists, h))
        multi(*_multi_args(name, lists, h))
        _per_array(one, list(zip(*copies)), h)
        for i, new in enumerate(want):
            for j, dst in enumerate(k for k in range(ops) if k != 1):
                err = max(err, _max_err(lists[dst][i], new[j]))
                same = same and torch.equal(lists[dst][i], copies[dst][i])
    print(f"kernel {name}_multi: bit for bit the per-array kernel over "
          f"{len(shapes)} ResNet-50 arrays and the length edges, clip off "
          f"and on: {same}")
    if not same:
        raise AssertionError(f"{name}_multi differs from the per-array "
                             "kernel")
    lists = _update_lists(shapes, ops, gen)
    args = _multi_args(name, lists, hyper)
    library = _fused_library(name, lists, hyper)
    n_el = sum(t.numel() for t in lists[0])
    return dict(
        max_abs_err=err, call=functools.partial(multi, *args),
        ms=_timed(functools.partial(multi, *args), reps=50, warm=5),
        plain_ms=_timed(functools.partial(plain, *args), reps=20, warm=2,
                        rounds=PLAIN_ROUNDS),
        library_ms=_timed(library, reps=50, warm=5), library_call=library,
        bound=_update_bound(name, n_el))


def _multi_lm_rows(mx, ck, gen, hp, ah):
    """Both multi-tensor kernels over the bench LM's 99 parameter arrays
    (the (32000, 512) table the largest): device ms beside the per-array
    kernel's, PyTorch's multi-tensor update's and the byte bound."""
    import numpy as np
    sym = _lm_symbol(LM_SEQ)
    arg_shapes, _, _ = sym.infer_shape(
        data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH * LM_SEQ,))
    shapes = [s for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")]
    n_el = sum(int(np.prod(s)) for s in shapes)
    for name, ops, hyper in (("sgd_mom", 3, hp), ("adam", 4, ah)):
        lists = _update_lists(shapes, ops, gen)
        multi = functools.partial(getattr(ck, name + "_update_multi"),
                                  *_multi_args(name, lists, hyper))
        per = functools.partial(_per_array, getattr(ck, name + "_update"),
                                list(zip(*lists)), hyper)
        print(f"kernel {name}_multi over the LM's {len(shapes)} arrays "
              f"({n_el} elements): ms={_timed(multi, reps=50, warm=5):.5f} "
              f"device_ms={_device_ms(multi):.6f} per-array "
              f"device_ms={_device_ms(per):.6f} library_device_ms="
              f"{_device_ms(_fused_library(name, lists, hyper)):.6f} "
              f"bound_ms={_update_bound(name, n_el)[0]:.6f} (bytes)")
        del lists


def _same_bytes(x, ct, label):
    """The LayerNorm backward's bytes (x and ct read, one (N, C) written)
    through one PyTorch elementwise call, ``torch.add(x, ct, out=)``: its
    device time, the yardstick for the kernel's streaming part."""
    import torch
    out = torch.empty_like(x)
    print(f"kernels: the LayerNorm backward's bytes at {tuple(x.shape)} "
          f"{label} through torch.add(x, ct, out=): device_ms="
          f"{_device_ms(lambda: torch.add(x, ct, out=out))}")


def _ln_bwd_fused_errs(ck, cases, err_dx, err_dp):
    """``layernorm_bwd`` (one call for dx, dgamma and dbeta) against its
    plain version over ``cases`` (x, gamma, beta, ct, mean, rstd): the
    largest error of dx and of the two sums under each ``(err_dx,
    err_dp)`` pair of measures given. Each call must repeat bit for bit,
    and each single-half wrapper must give its half bit for bit (the same
    kernel with the other half off)."""
    import torch
    worst = [[0.0, 0.0] for _ in err_dx]
    for x, g, _b, ct, m, r in cases:
        got = ck.layernorm_bwd(x, g, ct, m, r)
        want = ck.layernorm_bwd_plain(x, g, ct, m, r)
        for w, edx, edp in zip(worst, err_dx, err_dp):
            w[0] = max(w[0], edx(got[0], want[0]))
            w[1] = max(w[1], edp(got[1], want[1]), edp(got[2], want[2]))
        again = ck.layernorm_bwd(x, g, ct, m, r)
        halves = (ck.layernorm_bwd_dx(x, g, ct, m, r),
                  *ck.layernorm_bwd_dparams(x, ct, m, r))
        for a, b, c in zip(got, again, halves):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(
                    f"ln_bwd at {tuple(x.shape)} {x.dtype}: a repeated call"
                    " or a single-half wrapper gave other bits")
    return worst


def _lm_kernels(ck, rs, t, rec):
    """The four LM-training kernels at the full-width LM path's shapes:
    LayerNorm over (8192, 512), GeLU over (8192, 2048), causal flash
    attention over (8, 8, 1024, 64); plus edge shapes. Fills ``rec``;
    returns the timed calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    N, C = LM_BATCH * LM_SEQ, D

    def ln_case(n, c):
        x = t((3 * rs.randn(n, c) + 1).astype(np.float32))
        g = t((1 + 0.1 * rs.randn(c)).astype(np.float32))
        b = t((0.1 * rs.randn(c)).astype(np.float32))
        ct = t(rs.randn(n, c).astype(np.float32))
        _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
        return x, g, b, ct, mean, rstd
    cases = [ln_case(N, C)] + [ln_case(*e) for e in LN_BWD_EDGES]
    err_dx = max(_max_err(ck.layernorm_bwd_dx(x, g, ct, m, r),
                          ck.layernorm_bwd_dx_plain(x, g, ct, m, r))
                 for x, g, _b, ct, m, r in cases)
    err_dp = max(max(_max_err(a, b) for a, b in zip(
        ck.layernorm_bwd_dparams(x, ct, m, r),
        ck.layernorm_bwd_dparams_plain(x, ct, m, r)))
        for x, _g, _b, ct, m, r in cases)
    fused, = _ln_bwd_fused_errs(ck, cases, [_max_err], [_max_err])
    if not (fused[0] <= TOL["ln_bwd_dx"]
            and fused[1] <= TOL["ln_bwd_dparams"]):
        raise AssertionError(f"ln_bwd disagrees with its plain version: dx "
                             f"{fused[0]}, dgamma / dbeta {fused[1]}")
    x, g, b, ct, m, r = cases[0]
    # the library's LayerNorm backward computes dx, dgamma, dbeta in one
    # call: its time stands beside rows 11 and 12 together
    _, lm_mean, lm_rstd = torch.ops.aten.native_layer_norm(x, (C,), g, b,
                                                           1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            ct, x, (C,), lm_mean, lm_rstd, g, b, [True, True, True])
    lib = _timed(library)
    rec["ln_bwd"] = dict(
        max_abs_err=max(fused), ms=_timed(
            lambda: ck.layernorm_bwd(x, g, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_plain(x, g, ct, m, r)),
        library_ms=lib, library_call=library,
        bound=_bound_ms((3 * N * C + 3 * C + 2 * N) * 4, 15 * N * C))
    print(f"kernels: LayerNorm backward at the LM's ({N}, {C}) float32: "
          f"ln_bwd (dx, dgamma and dbeta, one call) dx err {fused[0]:.3g}, "
          f"dgamma / dbeta err {fused[1]:.3g}, repeats bit for bit; the "
          f"pair's bound {rec['ln_bwd']['bound'][0]:.6f} ms (x and ct read "
          "and dx written once); native_layer_norm_backward ms "
          f"{lib:.5f}")
    _same_bytes(x, ct, "float32")
    rec["ln_bwd_dx"] = dict(
        max_abs_err=err_dx,
        ms=_timed(lambda: ck.layernorm_bwd_dx(x, g, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dx_plain(x, g, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms((3 * N * C + C + 2 * N) * 4, 11 * N * C))
    rec["ln_bwd_dparams"] = dict(
        max_abs_err=err_dp,
        ms=_timed(lambda: ck.layernorm_bwd_dparams(x, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dparams_plain(x, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms((2 * N * C + 2 * N + 2 * C) * 4, 4 * N * C))
    # GeLU backward: (8192, 2048), then (3, 13) and (1, 4)
    F4 = 4 * D
    h = t((3 * rs.randn(N, F4)).astype(np.float32))
    hb = t(rs.randn(F4).astype(np.float32))
    hct = t(rs.randn(N, F4).astype(np.float32))
    err = _max_err(ck.bias_gelu_dx(h, hb, hct),
                   ck.bias_gelu_dx_plain(h, hb, hct))
    for n, c in ((3, 13), (1, 4)):
        e = [t(rs.randn(*s).astype(np.float32)) for s in ((n, c), (c,),
                                                           (n, c))]
        err = max(err, _max_err(ck.bias_gelu_dx(*e),
                                ck.bias_gelu_dx_plain(*e)))
    rec["bias_gelu_dx"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.bias_gelu_dx(h, hb, hct)),
        plain_ms=_timed(lambda: ck.bias_gelu_dx_plain(h, hb, hct)),
        # two PyTorch calls, the bias add and aten.gelu_backward: no one
        # call takes the bias
        library_ms=_timed(lambda: torch.ops.aten.gelu_backward(hct, h + hb)),
        bound=_bound_ms((3 * N * F4 + F4) * 4, 12 * N * F4))
    two = _device_ms(lambda: torch.ops.aten.gelu_backward(hct, h + hb))
    print(f"kernels: bias_gelu_dx library_ms is two calls (h + bias, "
          f"aten.gelu_backward); device ms "
          f"{_device_ms(lambda: ck.bias_gelu_dx(h, hb, hct)):.6f} against "
          f"the two calls' {two:.6f}")
    # flash attention: causal (8, 8, 1024, 64), then T = 1, T = 1000
    # (a ragged last tile), Dh = 128, and non-causal
    Dh = D // N_HEAD
    q, k, v = (t(rs.randn(LM_BATCH, N_HEAD, LM_SEQ, Dh).astype(np.float32))
               for _ in range(3))
    err = _max_err(ck.flash_attention(q, k, v, True),
                   ck.flash_attention_plain(q, k, v, True))
    for shape, causal in (((2, 2, 1, Dh), True), ((1, 2, 1000, Dh), True),
                          ((2, 2, 200, 128), True), ((2, 2, 256, Dh), False),
                          ((1, 2, 300, 128), False)):
        e = [t(rs.randn(*shape).astype(np.float32)) for _ in range(3)]
        err = max(err, _max_err(ck.flash_attention(*e, causal),
                                ck.flash_attention_plain(*e, causal)))
    pairs = LM_BATCH * N_HEAD * LM_SEQ * (LM_SEQ + 1) // 2
    def sdpa_causal():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    rec["flash_attention"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.flash_attention(q, k, v, True), reps=50),
        plain_ms=_timed(lambda: ck.flash_attention_plain(q, k, v, True),
                        reps=20, rounds=PLAIN_ROUNDS, warm=3),
        library_ms=_timed(sdpa_causal, reps=50), library_call=sdpa_causal,
        bound=_bound_ms(4 * q.numel() * 4, 4 * pairs * Dh))
    q2, k2, v2 = (t(rs.randn(4, N_HEAD, LM_SEQ, 128).astype(np.float32))
                  for _ in range(3))
    err2 = _max_err(ck.flash_attention(q2, k2, v2, True),
                    ck.flash_attention_plain(q2, k2, v2, True))
    if not err2 <= TOL["flash_attention"]:
        raise AssertionError(f"flash_attention Dh 128: {err2}")
    pairs2 = 4 * N_HEAD * LM_SEQ * (LM_SEQ + 1) // 2

    def flash128():
        return ck.flash_attention(q2, k2, v2, True)

    def sdpa128():
        return F.scaled_dot_product_attention(q2, k2, v2, is_causal=True)
    print(f"kernels: flash_attention float32 {tuple(q2.shape)} causal: "
          f"max_abs_err {err2:.3g} ms {_timed(flash128, reps=50):.5f} "
          f"device_ms {_device_ms(flash128):.6f} bound_ms "
          f"{_bound_ms(4 * q2.numel() * 4, 4 * pairs2 * 128)[0]:.6f} "
          f"(operations); SDPA causal ms {_timed(sdpa128, reps=50):.5f} "
          f"device_ms {_device_ms(sdpa128):.6f}")
    del q2, k2, v2
    print(f"kernels: LM rows at LayerNorm ({N}, {C}), GeLU ({N}, {F4}), "
          f"flash {tuple(q.shape)} causal; library_ms of ln_bwd, ln_bwd_dx "
          "and ln_bwd_dparams is ONE native_layer_norm_backward call (dx, "
          "dgamma and dbeta together)")
    return {"ln_bwd": lambda: ck.layernorm_bwd(x, g, ct, m, r),
            "ln_bwd_dx": lambda: ck.layernorm_bwd_dx(x, g, ct, m, r),
            "ln_bwd_dparams": lambda: ck.layernorm_bwd_dparams(x, ct, m, r),
            "bias_gelu_dx": lambda: ck.bias_gelu_dx(h, hb, hct),
            "flash_attention": lambda: ck.flash_attention(q, k, v, True)}


def _headdim32_rows(ck, rs, t):
    """The attention kernels at head dim 32, the bench LM over DH32_HEADS
    heads: every instance against its plain version and timed (device
    ms, L2 flushed) beside its bound and, where it takes the type, SDPA's
    device time with the same mask: the decode read at the served step (B
    8, C 256, S 1, phase 2's cursors) and at the S = 64 window; the
    causal flash forward over (8, 16, 1024, 32) in float32, bfloat16 and
    float16, beside its Dh 64 instance at the same width (8, 8, 1024, 64)
    and at the same rows (8, 16, 1024, 64); ring attention's partial
    block at the past shard and the diagonal of (2, 16, 1024, 1024, 32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    B, H, Dh = 8, DH32_HEADS, D // DH32_HEADS
    cursors = [0, 1, 127, 128, 255, 63, 200, 31]
    pos = t(cursors, torch.int32)
    live = int(np.minimum(CAP, np.asarray(cursors) + 1).sum())
    for cache_dt, q_dt in DECODE_INSTANCES:
        kc, vc = _decode_caches(ck, rs, t, cache_dt, B, H, CAP, Dh)
        q = t(rs.randn(B, H, 1, Dh).astype(np.float32)).to(
            getattr(torch, q_dt))
        _decode_row(ck, f"dh32 decode served step {cache_dt}", q, kc, vc,
                    pos, live, live, sdpa=not cache_dt.startswith("float8"))
        if cache_dt == "float32":
            _decode_window_rows(ck, rs, t, kc, vc, label="dh32 decode window")
    pairs = LM_BATCH * LM_SEQ * (LM_SEQ + 1) // 2
    for dtype in ("float32",) + tuple(HALF_SFX):
        dt = getattr(torch, dtype)
        peak = F32_FLOPS_PER_S if dtype == "float32" else BF16_FLOPS_PER_S
        line = []
        for label, shape in (("Dh 32", (LM_BATCH, H, LM_SEQ, Dh)),
                             ("Dh 64 same width", (LM_BATCH, N_HEAD, LM_SEQ,
                                                   D // N_HEAD)),
                             ("Dh 64 same rows", (LM_BATCH, H, LM_SEQ, 64))):
            q, k, v = (t(rs.randn(*shape).astype(np.float32)).to(dt)
                       for _ in range(3))
            got = ck.flash_attention(q, k, v, True)
            want = ck.flash_attention_plain(q, k, v, True)
            err = _max_err(got, want) if dtype == "float32" else \
                _half_ulps(dtype, got, want, atol=2e-5)
            if not err <= (TOL["flash_attention"] if dtype == "float32"
                           else 1.0):
                raise AssertionError(f"flash_attention {dtype} {label} "
                                     f"{shape}: {err}")
            bound = _bound_ms(4 * q.numel() * q.element_size(),
                              4 * pairs * shape[1] * shape[3], peak)
            kern = _device_ms(lambda: ck.flash_attention(q, k, v, True))
            sdpa = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            line.append(f"{label} {shape}: err {err:.3g} device_ms "
                        f"{kern:.6f} bound_ms {bound[0]:.6f} ({bound[1]}) "
                        f"x_bound {kern / bound[0]:.2f} sdpa_device_ms "
                        f"{sdpa:.6f}")
            del q, k, v
        print(f"dh32 flash_attention {dtype} causal: " + "; ".join(line))
        Ts = RING_SEQ // RING_SHARDS
        q, k, v = (t(rs.randn(RING_BATCH, H, Ts, Dh).astype(np.float32))
                   .to(dt) for _ in range(3))
        nbytes = 3 * q.numel() * q.element_size() + q.numel() * 4 + \
            2 * RING_BATCH * H * Ts * 4
        flops = 4 * RING_BATCH * H * Ts * Ts * Dh
        line = []
        for label, q_off, k_off, frac in (("past shard", 2 * Ts, Ts, 1.0),
                                          ("diagonal", Ts, Ts, 0.5)):
            e = _partial_err(
                ck.flash_attention_partial(q, k, v, q_off, k_off, True),
                ck.flash_attention_partial_plain(q, k, v, q_off, k_off, True))
            if not e[1] <= TOL["flash_attention_partial"]:
                raise AssertionError(f"flash_attention_partial {dtype} "
                                     f"Dh 32 {label}: {e}")
            kern = _device_ms(lambda: ck.flash_attention_partial(
                q, k, v, q_off, k_off, True))
            bound = _bound_ms(nbytes, flops * frac, peak)
            line.append(f"{label}: rel_err {e[1]:.3g} device_ms {kern:.6f} "
                        f"bound_ms {bound[0]:.6f} ({bound[1]}) x_bound "
                        f"{kern / bound[0]:.2f}")
        print(f"dh32 flash_attention_partial {dtype} at {tuple(q.shape)}: "
              + "; ".join(line))
        del q, k, v


def _headdim_rows(ck, rs, t):
    """The attention kernels at head dims between their tiles
    (HEADDIM_ROWS, one below the Dh 64 tile's full width and one below the
    Dh 128 tile's; phase 51 fits every Dh of HEADDIMS and the card tests
    hold every instance at each), each on the smallest tile that holds it: every instance
    against its plain version and timed (device ms, L2 flushed) beside
    its bound (the real Dh's bytes and flops) and, where it takes the
    type, SDPA's device time with the same mask: the decode read at the
    served step (B 8, 8 heads, C 256, S 1, phase 2's cursors) and at the
    S = 64 window (float32 and bfloat16; the card tests hold every
    instance's windows); the causal flash forward over (8, 8, 1024, Dh) in
    float32, bfloat16 and float16; ring attention's partial block at the
    past shard (2, 8, 1024, 1024, Dh)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    B, H = 8, N_HEAD
    cursors = [0, 1, 127, 128, 255, 63, 200, 31]
    pos = t(cursors, torch.int32)
    live = int(np.minimum(CAP, np.asarray(cursors) + 1).sum())
    pairs = LM_BATCH * LM_SEQ * (LM_SEQ + 1) // 2
    Ts = RING_SEQ // RING_SHARDS
    for dh in HEADDIM_ROWS:
        print(f"head dim {dh}: the decode read and the float32 flash "
              f"forward on the Dh {ck.head_tile(dh)} tile, the 16-bit "
              f"flash forward on the Dh {max(64, ck.head_tile(dh))} tile")
        for cache_dt, q_dt in DECODE_INSTANCES:
            kc, vc = _decode_caches(ck, rs, t, cache_dt, B, H, CAP, dh)
            q = t(rs.randn(B, H, 1, dh).astype(np.float32)).to(
                getattr(torch, q_dt))
            _decode_row(ck, f"dh{dh} decode served step {cache_dt}", q, kc,
                        vc, pos, live, live,
                        sdpa=not cache_dt.startswith("float8"))
            if cache_dt == "float32":
                _decode_window_rows(ck, rs, t, kc, vc,
                                    label=f"dh{dh} decode window",
                                    instances=DECODE_INSTANCES[:2])
            del kc, vc
        shape = (LM_BATCH, H, LM_SEQ, dh)
        # one float32 draw a Dh for the three types (flash, then partial)
        drawn = [t(rs.randn(*shape).astype(np.float32)) for _ in range(3)]
        ring = [t(rs.randn(RING_BATCH, H, Ts, dh).astype(np.float32))
                for _ in range(3)]
        for dtype in ("float32",) + tuple(HALF_SFX):
            dt = getattr(torch, dtype)
            peak = F32_FLOPS_PER_S if dtype == "float32" else BF16_FLOPS_PER_S
            q, k, v = (x.to(dt) for x in drawn)
            got = ck.flash_attention(q, k, v, True)
            want = ck.flash_attention_plain(q, k, v, True)
            err = _max_err(got, want) if dtype == "float32" else \
                _half_ulps(dtype, got, want, atol=2e-5)
            if not err <= (TOL["flash_attention"] if dtype == "float32"
                           else 1.0):
                raise AssertionError(f"flash_attention {dtype} Dh {dh}: "
                                     f"{err}")
            bound = _bound_ms(4 * q.numel() * q.element_size(),
                              4 * pairs * H * dh, peak)
            kern = _device_ms(lambda: ck.flash_attention(q, k, v, True))
            sdpa = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            del q, k, v
            q, k, v = (x.to(dt) for x in ring)
            e = _partial_err(
                ck.flash_attention_partial(q, k, v, 2 * Ts, Ts, True),
                ck.flash_attention_partial_plain(q, k, v, 2 * Ts, Ts, True))
            if not e[1] <= TOL["flash_attention_partial"]:
                raise AssertionError(f"flash_attention_partial {dtype} Dh "
                                     f"{dh}: {e}")
            part = _device_ms(lambda: ck.flash_attention_partial(
                q, k, v, 2 * Ts, Ts, True))
            pbound = _bound_ms(3 * q.numel() * q.element_size()
                               + q.numel() * 4 + 2 * RING_BATCH * H * Ts * 4,
                               4 * RING_BATCH * H * Ts * Ts * dh, peak)
            print(f"dh{dh} flash_attention {dtype} causal {shape}: err "
                  f"{err:.3g} device_ms {kern:.6f} bound_ms {bound[0]:.6f} "
                  f"({bound[1]}) x_bound {kern / bound[0]:.2f} "
                  f"sdpa_device_ms {sdpa:.6f} kernel/sdpa {kern / sdpa:.2f};"
                  f" partial past shard {tuple(q.shape)}: rel_err "
                  f"{e[1]:.3g} device_ms {part:.6f} bound_ms "
                  f"{pbound[0]:.6f} ({pbound[1]}) x_bound "
                  f"{part / pbound[0]:.2f}")
            del q, k, v
        del drawn, ring
        torch.cuda.empty_cache()


def _partial_err(got, want):
    """(largest |got - want| over the finite values of acc, m and l, the
    same relative to each array's largest magnitude): inf unless the rows
    that see no key are -inf / 0 / 0 in both."""
    import torch
    dead = torch.isneginf(want[1])
    if not (torch.equal(torch.isneginf(got[1]), dead)
            and not got[2][dead].any() and not got[0][dead].any()):
        return float("inf"), float("inf")
    worst, rel = 0.0, 0.0
    for a, b in ((got[0], want[0]), (got[1][~dead], want[1][~dead]),
                 (got[2], want[2])):
        if b.numel():
            e = float((a - b).abs().max())
            worst = max(worst, e)
            rel = max(rel, e / max(float(b.abs().max()), 1.0))
    return worst, rel


def _ring_kernels(ck, rs, t, rec):
    """Ring attention's partial flash kernel, each instance (float32,
    bfloat16, float16), at the sequence-parallel LM's shard shapes (2, 8,
    1024, 64): non-causal, the causal diagonal (q_off = k_off), a causal
    past shard (q_off = k_off + 1024), a future shard (every row sees no
    key), Tq != Tk; timed on the past shard, the block most ring steps
    launch (6 of a layer's 10), the diagonal's time printed beside. Fills
    ``rec``; returns the timed calls."""
    import numpy as np
    import torch
    Dh, Ts = D // N_HEAD, RING_SEQ // RING_SHARDS
    cases = [(Ts, Ts, 0, 0, False), (Ts, Ts, Ts, Ts, True),
             (Ts, Ts, 2 * Ts, Ts, True), (Ts, Ts, 0, Ts, True),
             (Ts, Ts // 2, 3 * Ts // 2, Ts, True),
             (200, 1000, 900, 0, True)]
    calls = {}
    for dtype in ("float32",) + tuple(HALF_SFX):
        dt = getattr(torch, dtype)
        name = "flash_attention_partial" + (
            "" if dtype == "float32" else "_" + HALF_SFX[dtype])
        worst, rel = 0.0, 0.0
        for tq, tk, q_off, k_off, causal in cases:
            q = t(rs.randn(RING_BATCH, N_HEAD, tq, Dh).astype(np.float32), dt)
            k, v = (t(rs.randn(RING_BATCH, N_HEAD, tk, Dh).astype(
                np.float32), dt) for _ in range(2))
            e = _partial_err(
                ck.flash_attention_partial(q, k, v, q_off, k_off, causal),
                ck.flash_attention_partial_plain(q, k, v, q_off, k_off,
                                                 causal))
            worst, rel = max(worst, e[0]), max(rel, e[1])
        q, k, v = (t(rs.randn(RING_BATCH, N_HEAD, Ts, Dh).astype(np.float32),
                     dt) for _ in range(3))
        past = (q, k, v, 2 * Ts, Ts, True)
        flops = 4 * RING_BATCH * N_HEAD * Ts * Ts * Dh
        # the 16-bit instances at the 16-bit peak, as row 14's
        peak = F32_FLOPS_PER_S if dtype == "float32" else BF16_FLOPS_PER_S
        diag = (q, k, v, Ts, Ts, True)
        nbytes = 3 * q.numel() * q.element_size() + q.numel() * 4 + \
            2 * RING_BATCH * N_HEAD * Ts * 4
        rec[name] = dict(
            max_abs_err=worst, rel_err=rel,
            ms=_timed(lambda: ck.flash_attention_partial(*past), reps=50),
            plain_ms=_timed(lambda: ck.flash_attention_partial_plain(*past),
                            reps=20, rounds=PLAIN_ROUNDS, warm=3),
            library_ms=None,    # no one PyTorch call returns (acc, m, l)
            bound=_bound_ms(nbytes, flops, peak))
        diag_ms = _timed(lambda: ck.flash_attention_partial(*diag), reps=50)
        print(f"kernels: {name} at ({RING_BATCH}, {N_HEAD}, {Ts}, {Dh}) "
              f"shards: past shard timed (bound {rec[name]['bound'][0]:.6f}"
              f" ms); the diagonal {diag_ms:.5f} ms (bound "
              f"{_bound_ms(nbytes, flops / 2, peak)[0]:.6f} ms: half the "
              "pairs); "
              "library_ms None: no one PyTorch call returns the "
              "unnormalized (acc, m, l)")
        calls[name] = lambda past=past: ck.flash_attention_partial(*past)
    return calls


#: a demangled flash kernel: ``...::tc::flash_tc<__half, (int)64,
#: (bool)1>`` (16-bit, tensor cores: the tile's head dim) or
#: ``...::cc::flash_fwd<(int)64, (bool)0>`` (float32, CUDA cores)
_FLASH_INSTANCE = re.compile(r"::(flash_tc|flash_fwd)<(?:(\w+), )?"
                             r"\(int\)(\d+), \(bool\)([01])>")


def _flash_tensor_cores(ck):
    """Print each flash-attention instance's HGMMA (wgmma) count in its
    SASS and ptxas' registers (at launch: the 16-bit instances then move
    them to their consumers with setmaxnreg) and spill bytes; fail unless
    every bfloat16 and float16 instance, both modes and tiles (Dh 64,
    which also runs Dh 16 to 48, and Dh 128, which runs 80 to 112),
    holds HGMMA, no float32 instance (tiles Dh 32, 64, 128) holds HGMMA
    (the reference's Precision.HIGHEST rules out TF32), and no instance
    spills."""
    seen = set()
    for fn, res in sorted(ck.resources("flash_attention").items()):
        m = _FLASH_INSTANCE.search(fn)
        if not m:
            continue
        _kind, elem, dh, partial = m.groups()
        elem = elem or "float"
        hgmma = res.get("sass", {}).get("HGMMA", 0)
        spills = (res["spill_stores"], res["spill_loads"])
        print(f"kernels: flash_attention{'_partial' * (partial == '1')} "
              f"<{elem}, Dh {dh}>: HGMMA {hgmma}, ptxas registers "
              f"{res['registers']}, spill stores / loads {spills[0]} / "
              f"{spills[1]} bytes")
        if (hgmma > 0) != (elem != "float") or any(spills):
            raise AssertionError(f"flash <{elem}, {dh}, {partial}>: HGMMA "
                                 f"{hgmma}, spills {spills}")
        seen.add((elem, dh, partial))
    if len(seen) != 14:
        raise AssertionError(f"flash instances in the SASS: {sorted(seen)}")


def _lm_bf16_kernels(ck, rs, t, rec, half="bfloat16"):
    """The LM-training path's four bfloat16 instances at the bfloat16 LM
    path's shapes (LayerNorm backward over (8192, 512), GeLU' over (8192,
    2048), causal flash attention over (8, 8, 1024, 64)) and edges: one
    row, one column, C = 13, 65536, misaligned views (one value at a
    time), T = 1, a ragged T, T on both sides of the 16-bit flash
    kernel's 128-row tiles, Dh 128, non-causal. Bounds at bfloat16 bytes
    and the bfloat16 peak.
    Also the softmax head's bfloat16 pair at the LM head's (8192, 32000)
    beside the float32 pair's device times and ``torch.softmax``'s, the
    softmax held to its plain version there, and LayerNorm at the LM's
    (8192, 512) beside ``F.layer_norm`` (float32 with the bfloat16 call).
    Fills ``rec``; returns the timed calls."""
    sfx = HALF_SFX[half]
    import numpy as np
    import torch
    import torch.nn.functional as F
    bf = getattr(torch, half)
    N, C = LM_BATCH * LM_SEQ, D

    def tb(a):
        return t(np.asarray(a, np.float32)).to(bf)

    def skew(n, *shape):
        """A contiguous bfloat16 view 2 bytes off its allocation."""
        return tb(3 * rs.randn(1 + n) + 1)[1:].view(*shape)

    def ln_case(n, c, x=None):
        x = tb(3 * rs.randn(n, c) + 1) if x is None else x
        g, b = tb(1 + 0.1 * rs.randn(c)), tb(0.1 * rs.randn(c))
        ct = tb(rs.randn(n, c))
        _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
        return x, g, b, ct, mean, rstd
    cases = [ln_case(N, C)] + [ln_case(*e) for e in LN_BWD_EDGES] + [
        ln_case(4, C, skew(4 * C, 4, C))]
    ulp_dx = ulp_dp = err_dx = err_dp = 0.0
    for x, g, _b, ct, m, r in cases:
        got, want = ck.layernorm_bwd_dx(x, g, ct, m, r), \
            ck.layernorm_bwd_dx_plain(x, g, ct, m, r)
        ulp_dx = max(ulp_dx, _half_ulps(half, got, want, atol=2e-5))
        err_dx = max(err_dx, _max_err(got, want))
        for got, want in zip(ck.layernorm_bwd_dparams(x, ct, m, r),
                             ck.layernorm_bwd_dparams_plain(x, ct, m, r)):
            ulp_dp = max(ulp_dp, _half_ulps(half, got, want, atol=1e-4))
            err_dp = max(err_dp, _max_err(got, want))
    ulps, fused = _ln_bwd_fused_errs(
        ck, cases, [lambda a, b: _half_ulps(half, a, b, atol=2e-5), _max_err],
        [lambda a, b: _half_ulps(half, a, b, atol=1e-4), _max_err])
    if not max(ulps) <= TOL["layernorm_bwd_" + sfx]:
        raise AssertionError(f"layernorm_bwd_{sfx} disagrees with its plain "
                             f"version: dx, dgamma / dbeta {ulps} ulps")
    x, g, b, ct, m, r = cases[0]
    _, lm_mean, lm_rstd = torch.ops.aten.native_layer_norm(x, (C,), g, b,
                                                           1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            ct, x, (C,), lm_mean, lm_rstd, g, b, [True, True, True])
    lib = _timed(library)
    rec["layernorm_bwd_" + sfx] = dict(
        max_abs_err=max(fused), ulps=max(ulps),
        ms=_timed(lambda: ck.layernorm_bwd(x, g, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_plain(x, g, ct, m, r)),
        library_ms=lib, library_call=library,
        bound=_bound_ms(3 * N * C * 2 + 3 * C * 2 + 2 * N * 4, 15 * N * C,
                        BF16_FLOPS_PER_S))
    print(f"kernels: LayerNorm backward at the LM's ({N}, {C}) {half}: "
          f"layernorm_bwd_{sfx} (one call) dx {ulps[0]:.3g} ulps, dgamma / "
          f"dbeta {ulps[1]:.3g} ulps, repeats bit for bit; the pair's bound "
          f"{rec['layernorm_bwd_' + sfx]['bound'][0]:.6f} ms; "
          f"native_layer_norm_backward ms {lib:.5f}")
    _same_bytes(x, ct, half)
    rec["layernorm_bwd_dx_" + sfx] = dict(
        max_abs_err=err_dx, ulps=ulp_dx,
        ms=_timed(lambda: ck.layernorm_bwd_dx(x, g, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dx_plain(x, g, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms(3 * N * C * 2 + C * 2 + 2 * N * 4, 11 * N * C,
                        BF16_FLOPS_PER_S))
    rec["layernorm_bwd_dparams_" + sfx] = dict(
        max_abs_err=err_dp, ulps=ulp_dp,
        ms=_timed(lambda: ck.layernorm_bwd_dparams(x, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dparams_plain(x, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms(2 * N * C * 2 + 2 * N * 4 + 2 * C * 2, 4 * N * C,
                        BF16_FLOPS_PER_S))
    F4 = 4 * D
    h, hb, hct = tb(3 * rs.randn(N, F4)), tb(rs.randn(F4)), tb(rs.randn(N, F4))
    ulps = err = 0.0
    for xx, bb, cc in ((h, hb, hct), (tb(rs.randn(3, 13)), tb(rs.randn(13)),
                                      tb(rs.randn(3, 13))),
                       (tb(rs.randn(1, 4)), tb(rs.randn(4)),
                        tb(rs.randn(1, 4))),
                       (skew(2 * 16, 2, 16), tb(rs.randn(16)),
                        tb(rs.randn(2, 16)))):
        got, want = ck.bias_gelu_dx(xx, bb, cc), \
            ck.bias_gelu_dx_plain(xx, bb, cc)
        ulps = max(ulps, _half_ulps(half, got, want, atol=2e-5))
        err = max(err, _max_err(got, want))
    rec["bias_gelu_dx_" + sfx] = dict(
        max_abs_err=err, ulps=ulps,
        ms=_timed(lambda: ck.bias_gelu_dx(h, hb, hct)),
        plain_ms=_timed(lambda: ck.bias_gelu_dx_plain(h, hb, hct)),
        library_ms=None,     # no one PyTorch call takes GeLU' x ct
        bound=_bound_ms(3 * N * F4 * 2 + F4 * 2, 12 * N * F4,
                        BF16_FLOPS_PER_S))
    Dh = D // N_HEAD
    q, k, v = (tb(rs.randn(LM_BATCH, N_HEAD, LM_SEQ, Dh)) for _ in range(3))
    got, want = ck.flash_attention(q, k, v, True), \
        ck.flash_attention_plain(q, k, v, True)
    ulps, err = _half_ulps(half, got, want, atol=2e-5), _max_err(got, want)
    for shape, causal in (((2, 2, 1, Dh), True), ((1, 2, 1000, Dh), True),
                          ((2, 2, 200, 128), True), ((2, 2, 256, Dh), False),
                          ((1, 2, 300, 128), False), ((2, 2, 129, Dh), True),
                          ((1, 2, 257, 128), False)):
        e = [tb(rs.randn(*shape)) for _ in range(3)]
        got, want = ck.flash_attention(*e, causal), \
            ck.flash_attention_plain(*e, causal)
        ulps = max(ulps, _half_ulps(half, got, want, atol=2e-5))
        err = max(err, _max_err(got, want))
    pairs = LM_BATCH * N_HEAD * LM_SEQ * (LM_SEQ + 1) // 2
    rec["flash_attention_" + sfx] = dict(
        max_abs_err=err, ulps=ulps,
        ms=_timed(lambda: ck.flash_attention(q, k, v, True), reps=50),
        plain_ms=_timed(lambda: ck.flash_attention_plain(q, k, v, True),
                        reps=20, rounds=PLAIN_ROUNDS, warm=3),
        library_ms=_timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=50),
        bound=_bound_ms(4 * q.numel() * 2, 4 * pairs * Dh, BF16_FLOPS_PER_S))
    print(f"kernels: LM {sfx} rows at LayerNorm ({N}, {C}), GeLU ({N}, {F4}),"
          f" flash {tuple(q.shape)} causal")
    # the softmax head's pair at the LM head's (8192, 32000)
    head = torch.randn(N, V, device=q.device,
                       generator=torch.Generator(q.device).manual_seed(SEED))
    lab = t(rs.randint(0, V, N).astype(np.float32))
    heads = ((torch.float32, "", F32_FLOPS_PER_S),) * (half == "bfloat16")
    for dtype, tag, peak in heads + ((bf, "_" + sfx, BF16_FLOPS_PER_S),):
        z = (4 * head).to(dtype)
        p = ck.softmax(z)
        want = ck.softmax_plain(z)
        err = _max_err(p, want) if dtype == torch.float32 else \
            _half_ulps(half, p, want)
        del want
        if not err <= TOL["softmax" + tag]:
            raise AssertionError(f"softmax{tag} at the LM head: {err} > "
                                 f"{TOL['softmax' + tag]}")
        nb = N * V * z.element_size()
        print(f"kernels: at the LM head's ({N}, {V}) {dtype}: softmax{tag} "
              f"{'max_abs_err' if dtype == torch.float32 else 'ulps'}={err:.3g}"
              f" device_ms={_device_ms(lambda: ck.softmax(z), reps=10)} "
              f"library_device_ms="
              f"{_device_ms(lambda: torch.softmax(z, -1), reps=10)} "
              f"bound_ms={_bound_ms(2 * nb, 5 * N * V, peak)[0]:.6f}; "
              f"softmax_ce_bwd{tag} device_ms="
              f"{_device_ms(lambda: ck.softmax_ce_bwd(p, lab, 1.0), reps=10)}"
              f" bound_ms={_bound_ms(2 * nb + N * 4, 3 * N * V, peak)[0]:.6f}")
        del z, p
        xl = (3 * head[:, :D] + 1).to(dtype).contiguous()
        gl = (1 + 0.1 * head[0, D:2 * D]).to(dtype)
        bl = (0.1 * head[1, D:2 * D]).to(dtype)
        y, stats = ck.layernorm_stats(xl, gl, bl, 1e-5)
        ref = ck.layernorm_plain(xl, gl, bl, 1e-5)
        err = _max_err(y, ref[0]) if dtype == torch.float32 else \
            _half_ulps(half, y, ref[0], atol=2e-5)
        stat_err = max(_max_err(stats[0], ref[1]),
                       _rstd_err(stats[1], ref[2]))
        if not (err <= TOL["layernorm" + tag] and stat_err <= 2e-5 and
                torch.equal(stats[2], 1.0 / stats[1])):
            raise AssertionError(f"layernorm{tag} at ({N}, {D}): {err}, "
                                 f"statistics {stat_err}")
        lb = 2 * N * D * xl.element_size() + 2 * D * xl.element_size() + \
            3 * N * 4
        print(f"kernels: LayerNorm at the LM's ({N}, {D}) {dtype}: "
              f"layernorm{tag} "
              f"{'max_abs_err' if dtype == torch.float32 else 'ulps'}="
              f"{err:.3g} statistics {stat_err:.3g} device_ms="
              f"{_device_ms(lambda: ck.layernorm(xl, gl, bl, 1e-5))} "
              f"library_device_ms="
              f"{_device_ms(lambda: F.layer_norm(xl, (D,), gl, bl, 1e-5))} "
              f"bound_ms={_bound_ms(lb, 10 * N * D, peak)[0]:.6f}")
        del xl, y, stats, ref
    del head
    return {"layernorm_bwd_" + sfx: lambda: ck.layernorm_bwd(x, g, ct, m, r),
            "layernorm_bwd_dx_" + sfx: lambda: ck.layernorm_bwd_dx(x, g, ct, m,
                                                                 r),
            "layernorm_bwd_dparams_" + sfx: lambda: ck.layernorm_bwd_dparams(
                x, ct, m, r),
            "bias_gelu_dx_" + sfx: lambda: ck.bias_gelu_dx(h, hb, hct),
            "flash_attention_" + sfx: lambda: ck.flash_attention(q, k, v,
                                                               True)}


def _quant_weight(rs, t, n, k, storage):
    """(n, k) narrow weight on the card: random codes plus the extremes
    (+-127 / +-448), the e4m3 subnormals, 0 and -0."""
    import numpy as np
    import torch
    if storage == torch.int8:
        codes = rs.randint(-128, 128, n * k)
        codes[:min(4, codes.size)] = [127, -127, -128, 0][:codes.size]
        return t(codes.reshape(n, k), torch.int8)
    vals = (rs.randn(n * k) * 40).clip(-448, 448).astype(np.float32)
    edge = np.asarray([448.0, -448.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -7,
                       7 * 2.0 ** -9, 0.0, -0.0], np.float32)
    vals[:min(edge.size, vals.size)] = edge[:vals.size]
    return t(vals.reshape(n, k)).to(torch.float8_e4m3fn)


def _dequant_library(wq, scale):
    """The row dequant as ONE PyTorch call, int8 weights only: int8 x
    float32 promotes to float32 and rounds each product once, as the
    kernel does (PyTorch refuses to promote float8_e4m3fn)."""
    import torch
    return torch.mul(wq, scale.unsqueeze(1))


def _quant_kernels(mx, ck, rs, t, rec):
    """The two quantized-serving kernels, int8 and float8_e4m3fn weights:
    the dequant-fused matmul at ResNet-50's fc1 rung 8 ((8, 2048) x (1000,
    2048)) and at edges (M = 1, 257; K = 13; N = 1, 1001; QFC_TILED_EDGE,
    the tiled route), held within
    QFC_RTOL of the output's largest magnitude; the row dequant at the
    path's (512, 4608) and (2048, 512) and at edges (1 and 147 columns),
    held bit for bit to its plain version and, with int8 weights, to
    ``_dequant_library``; the multi-weight dequant over ResNet-50's 53
    conv weights in their conv shapes (and a 1-byte-offset view of 147
    columns, the scalar route) held bit for bit to its plain version.
    Timed with int8 weights (fp8 printed beside): the matmul per call,
    the dequant per ResNet-50 forward — all 53 conv weights, 53 launches
    or one; the device times of the multi launch, of the 53 single-array
    calls and of ``flat_i8.to(torch.float32)`` over one int8 buffer of the
    same 23.5 M values (the same bytes in one PyTorch call) side by side.
    Fills ``rec``; returns the timed calls."""
    import numpy as np
    import torch
    storages = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
    edge_m, edge_k, edge_n = QFC_TILED_EDGE
    edge = ck._qfc_route(edge_m, edge_n, edge_k, _sm_count())
    if edge != (0, 1):
        raise AssertionError(f"row 16 at (M, K, N) {QFC_TILED_EDGE} takes "
                             f"route {edge}, not the tiled one")

    def scale(n):
        return t(np.abs(rs.randn(n)).astype(np.float32) / 100 + 1e-3)
    err_q = rel_q = 0.0
    for st in storages.values():
        for m, k, n in ((QUANT_RUNGS[-1], 2048, TRAIN_CLASSES),
                        (1, 2048, 1000), (257, 64, 33), (5, 13, 7),
                        (3, 300, 1), (4, 64, 1001), QFC_TILED_EDGE):
            x = t(rs.randn(m, k).astype(np.float32))
            w, s = _quant_weight(rs, t, n, k, st), scale(n)
            ref = ck.qfc_matmul_plain(x, w, s)
            err = _max_err(ck.qfc_matmul(x, w, s), ref)
            err_q = max(err_q, err)
            rel_q = max(rel_q, err / max(float(ref.abs().max()), 1e-30))
    err_d = 0.0
    for st in storages.values():
        for rows, cols in ((512, 4608), (2048, 512), (64, 147), (3, 1),
                           (5, 13)):
            w, s = _quant_weight(rs, t, rows, cols, st), scale(rows)
            got, ref = ck.dequant_rows(w, s), ck.dequant_rows_plain(w, s)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                err_d = max(err_d, _max_err(got, ref), 1e-30)
            if st == torch.int8 and not torch.equal(
                    got.view(torch.int32),
                    _dequant_library(w, s).view(torch.int32)):
                raise AssertionError(f"torch.mul differs from dequant_rows "
                                     f"at ({rows}, {cols}) int8")
    x8 = t(rs.randn(QUANT_RUNGS[-1], 2048).astype(np.float32))
    fc = {k: (_quant_weight(rs, t, TRAIN_CLASSES, 2048, st),
              scale(TRAIN_CLASSES)) for k, st in storages.items()}
    shapes = [s for s in _resnet50_param_shapes(mx, 1) if len(s) == 4]
    convs = {k: [(_quant_weight(rs, t, s[0], int(np.prod(s[1:])), st),
                  scale(s[0])) for s in shapes]
             for k, st in storages.items()}
    n_el = sum(int(np.prod(s)) for s in shapes)
    multi = {k: ([w.reshape(sh) for (w, _), sh in zip(convs[k], shapes)],
                 [sc for _, sc in convs[k]]) for k in storages}
    err_m = 0.0
    for key, st in storages.items():
        flat = _quant_weight(rs, t, 1, 1 + 64 * 147, st).reshape(-1)
        ws, ss = multi[key][0] + [flat[1:].view(64, 147)], \
            multi[key][1] + [scale(64)]
        for got, w, sc in zip(ck.dequant_rows_multi(ws, ss), ws, ss):
            ref = ck.dequant_rows_plain(w, sc)
            if got.shape != w.shape or not torch.equal(
                    got.view(torch.int32), ref.view(torch.int32)):
                err_m = max(err_m, _max_err(got.reshape(ref.shape), ref),
                            1e-30)
    flat_i8 = t(rs.randint(-128, 128, n_el), torch.int8)
    dev_multi = {k: _device_ms(lambda k=k: ck.dequant_rows_multi(*multi[k]))
                 for k in storages}
    dev_single = {k: _device_ms(lambda k=k: [ck.dequant_rows(*a)
                                             for a in convs[k]])
                  for k in storages}
    dev_yard = _device_ms(lambda: flat_i8.to(torch.float32))
    bound_d = _bound_ms(5 * n_el + 4 * sum(s[0] for s in shapes), n_el)
    ratio = dev_multi["int8"] / dev_single["int8"]
    print(f"kernels: dequant_rows_multi, ResNet-50's {len(shapes)} conv "
          f"weights ({n_el} values) in one launch: device ms int8 "
          f"{dev_multi['int8']:.6f} e4m3 {dev_multi['e4m3']:.6f}; the "
          f"{len(shapes)} single-array calls int8 {dev_single['int8']:.6f} "
          f"e4m3 {dev_single['e4m3']:.6f}; multi / singles int8 "
          f"{ratio:.3f} e4m3 "
          f"{dev_multi['e4m3'] / dev_single['e4m3']:.3f} (required <= 0.5: "
          f"{'met' if ratio <= 0.5 else 'missed'}); flat_i8.to(float32) "
          f"over {n_el} int8 values {dev_yard:.6f} (multi / it "
          f"{dev_multi['int8'] / dev_yard:.3f}); bound "
          f"{bound_d[0]:.6f} ({bound_d[1]}): multi x_bound "
          f"{dev_multi['int8'] / bound_d[0]:.2f}")
    _dequant_one_weight(ck, convs["int8"])
    m, (n, k) = x8.shape[0], fc["int8"][0].shape
    qfc = {key: _timed(lambda key=key: ck.qfc_matmul(x8, *fc[key]))
           for key in storages}
    deq = {key: _timed(lambda key=key: [ck.dequant_rows(*a)
                                        for a in convs[key]],
                       reps=50, warm=5)
           for key in storages}
    big = convs["int8"][int(np.argmax([np.prod(s) for s in shapes]))]
    print(f"kernels: qfc_matmul ({m}, {k}) x ({n}, {k}) ms int8 "
          f"{qfc['int8']:.5f} e4m3 {qfc['e4m3']:.5f}; dequant_rows per "
          f"ResNet-50 forward ({len(shapes)} weights, {n_el} elements) ms "
          f"int8 {deq['int8']:.5f} e4m3 {deq['e4m3']:.5f}; one "
          f"{tuple(big[0].shape)} dequant "
          f"{_timed(lambda: ck.dequant_rows(*big)):.5f} ms")
    rec["qfc_matmul"] = dict(
        max_abs_err=err_q, rel_err=rel_q, ms=qfc["int8"],
        plain_ms=_timed(lambda: ck.qfc_matmul_plain(x8, *fc["int8"])),
        bound=_bound_ms(m * k * 4 + n * k + n * 4 + m * n * 4, 2 * m * n * k))
    _int8pack_library(ck, rec["qfc_matmul"], x8, *fc["int8"])
    rec["dequant_rows_multi"] = dict(
        max_abs_err=err_m,
        ms=_timed(lambda: ck.dequant_rows_multi(*multi["int8"])),
        plain_ms=_timed(lambda: ck.dequant_rows_multi_plain(
            *multi["int8"]), reps=50, warm=5),
        library_ms=None,    # one PyTorch call a weight: torch.mul x 53
        bound=bound_d)
    rec["dequant_rows"] = dict(
        max_abs_err=err_d, ms=deq["int8"],
        plain_ms=_timed(lambda: [ck.dequant_rows_plain(*a)
                                 for a in convs["int8"]], reps=50, warm=5),
        library_ms=_timed(lambda: [_dequant_library(*a)
                                   for a in convs["int8"]], reps=50, warm=5),
        library_call=lambda: [_dequant_library(*a) for a in convs["int8"]],
        bound=_bound_ms(5 * n_el + 4 * sum(s[0] for s in shapes), n_el))
    return {"qfc_matmul": lambda: ck.qfc_matmul(x8, *fc["int8"]),
            "dequant_rows": lambda: [ck.dequant_rows(*a)
                                     for a in convs["int8"]],
            "dequant_rows_multi": lambda: ck.dequant_rows_multi(
                *multi["int8"])}


def _dequant_one_weight(ck, convs):
    """The computed-weight path's dequant, one weight a call, through each
    kernel: ``dequant_rows(w, s)`` and ``dequant_rows_multi([w], [s])``
    over the 53 int8 conv weights ``convs`` one at a time, bit for bit
    alike; host-paced ms (``_timed``, the ``ms`` column's clock) and
    device ms, in turns (single, multi, multi, single)."""
    import numpy as np
    import torch
    calls = {"dequant_rows": lambda: [ck.dequant_rows(*a) for a in convs],
             "dequant_rows_multi([w], [s])": lambda: [
                 ck.dequant_rows_multi([w], [s])[0] for w, s in convs]}
    for a, b in zip(*(c() for c in calls.values())):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("dequant_rows_multi of one weight differs "
                                 "from dequant_rows")
    order = list(calls) + list(calls)[::-1]
    host, dev = ({k: [] for k in calls} for _ in range(2))
    for k in order:
        host[k].append(_timed(calls[k], reps=50, warm=5))
        dev[k].append(_device_ms(calls[k], reps=20))
    h, d = ({k: float(np.mean(v)) for k, v in t.items()}
            for t in (host, dev))
    single, multi = calls
    print(f"kernels: dequant of one weight a call, ResNet-50's {len(convs)} "
          f"int8 conv weights one by one: ms {single} "
          f"{' / '.join(f'{v:.5f}' for v in host[single])}, {multi} "
          f"{' / '.join(f'{v:.5f}' for v in host[multi])} (multi / single "
          f"{h[multi] / h[single]:.3f}); device ms {single} "
          f"{' / '.join(f'{v:.6f}' for v in dev[single])}, {multi} "
          f"{' / '.join(f'{v:.6f}' for v in dev[multi])} (multi / single "
          f"{d[multi] / d[single]:.3f})")


def _int8pack_library(ck, r, x, w, s):
    """Row 16's library column: ``torch._weight_int8pack_mm(x, w, scales)``,
    y = x . (w . scale)^T with an int8 weight (N, K) and the scales in x's
    dtype, timed into record ``r`` where it runs on the card for x's
    dtype (its difference from the kernel printed, relative to the
    largest output), ``library_ms`` None and the error printed where it
    raises."""
    import torch
    r["library_ms"] = None
    sc = s.to(x.dtype)
    label = f"row 16 library torch._weight_int8pack_mm {x.dtype}"
    try:
        y = torch._weight_int8pack_mm(x, w, sc)
        torch.cuda.synchronize()
    except Exception as e:            # the installed build's answer
        print(f"{label}: raises {type(e).__name__}: "
              f"{str(e).strip().splitlines()[0][:200]}")
        return
    ref = ck.qfc_matmul(x, w, s)
    print(f"{label}: runs; max |y - kernel| {_max_err(y, ref):.3g} "
          f"({_max_err(y, ref) / float(ref.abs().max()):.3g} of the "
          f"largest output)")
    r["library_ms"] = _timed(lambda: torch._weight_int8pack_mm(x, w, sc))
    r["library_call"] = lambda: torch._weight_int8pack_mm(x, w, sc)


def _quant_half_kernels(ck, rs, t, rec):
    """The dequant-fused matmul's bfloat16 and float16 instances (a
    quantized graph under compute_dtype), int8 and float8_e4m3fn weights:
    x in the 16-bit type at ResNet-50's fc1 rung 8 ((8, 2048) x (1000,
    2048)) and at edges (M = 1, 257; K = 13; N = 1, 1001; QFC_TILED_EDGE,
    the tiled route), held within
    TOL (1e-5) of the output's largest magnitude of the plain version on
    the same values (x widened exactly, float32 sums, float32 out). Timed
    with
    int8 weights. Fills ``rec``; returns the timed calls."""
    import numpy as np
    import torch
    storages = (torch.int8, torch.float8_e4m3fn)
    calls = {}
    m, k, n = QUANT_RUNGS[-1], 2048, TRAIN_CLASSES
    w = _quant_weight(rs, t, n, k, torch.int8)
    s = t(np.abs(rs.randn(n)).astype(np.float32) / 100 + 1e-3)
    for half, sfx in HALF_SFX.items():
        dt = getattr(torch, half)
        err_q = rel_q = 0.0
        for st in storages:
            for mm, kk, nn in ((m, k, n), (1, 2048, 1000), (257, 64, 33),
                               (5, 13, 7), (3, 300, 1), (4, 64, 1001),
                               QFC_TILED_EDGE):
                x = t(rs.randn(mm, kk).astype(np.float32)).to(dt)
                ww = _quant_weight(rs, t, nn, kk, st)
                ss = t(np.abs(rs.randn(nn)).astype(np.float32) / 100 + 1e-3)
                ref = ck.qfc_matmul_plain(x, ww, ss)
                err = _max_err(ck.qfc_matmul(x, ww, ss), ref)
                err_q = max(err_q, err)
                rel_q = max(rel_q, err / max(float(ref.abs().max()), 1e-30))
        x8 = t(rs.randn(m, k).astype(np.float32)).to(dt)
        name = "qfc_matmul_" + sfx
        rec[name] = dict(
            max_abs_err=err_q, rel_err=rel_q,
            ms=_timed(lambda x8=x8: ck.qfc_matmul(x8, w, s)),
            plain_ms=_timed(lambda x8=x8: ck.qfc_matmul_plain(x8, w, s)),
            bound=_bound_ms(m * k * 2 + n * k + n * 4 + m * n * 4,
                            2 * m * n * k))
        _int8pack_library(ck, rec[name], x8, w, s)
        calls[name] = lambda x8=x8: ck.qfc_matmul(x8, w, s)
    return calls


#: row 16's route-break table around the break: N -> M of (M, 2048) x
#: (N, 2048), both routes (the full sweep: tools/qfc_flash_prev_kernel.py)
QFC_BREAK_MS = {1000: (8, 976, 977), 32000: (32, 64)}
#: (M, K, N) of a row 16 edge that takes the tiled route (M N past 7400
#: outputs an SM of an H100's 132, with ragged bands and channel tiles)
QFC_TILED_EDGE = (1000, 64, 1001)
QFC_X = ("float32", "bfloat16", "float16")


def _sm_count():
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _qfc_route_ms(ck, x, w, s, route):
    """Device ms of one route of the dequant-fused matmul, launched
    through its bound C entry point (no launch counted)."""
    import torch
    key = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}[x.dtype] + ":" + \
        {torch.int8: "int8", torch.float8_e4m3fn: "e4m3"}[w.dtype]
    fn = ck._fn("qfc_matmul", key)[0]
    (m, k), n = x.shape, w.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)

    def call():
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                 m, n, k, *route, torch.cuda.current_stream().cuda_stream)
        if err:
            raise AssertionError(f"qfc_matmul route {route}: cudaError "
                                 f"{err}")
    call()
    ref = ck.qfc_matmul_plain(x, w, s)
    rel = _max_err(out, ref) / max(float(ref.abs().max()), 1e-30)
    if not rel <= TOL["qfc_matmul"]:
        raise AssertionError(f"qfc_matmul route {route} at M={m}: {rel}")
    return _device_ms(call, reps=20)


def _qfc_break_rows(ck, rs, t, ms, k):
    """Both routes of row 16 at (M, k) x (N, k), int8 weights, float32 x,
    for N -> the Ms in ``ms``: each route's device ms (each held within
    TOL to the plain version) and the wrapper's route."""
    import numpy as np
    import torch
    sms = _sm_count()
    for n, rows in ms.items():
        w = _quant_weight(rs, t, n, k, torch.int8)
        s = t(np.abs(rs.randn(n)).astype(np.float32) / 100 + 1e-3)
        for m in rows:
            x = t(rs.randn(m, k).astype(np.float32))
            gemv = ck._qfc_gemv_plan(m, n, k, sms)
            g_ms = _qfc_route_ms(ck, x, w, s, gemv)
            t_ms = _qfc_route_ms(ck, x, w, s, (0, 1))
            print(f"  route break N={n} M={m}: gemv {gemv} {g_ms:.6f} "
                  f"tiled {t_ms:.6f} (gemv / tiled {g_ms / t_ms:.3f}); "
                  f"wrapper {ck._qfc_route(m, n, k, sms)}")


def _qfc_rungs(ck, rs, t):
    """Row 16 at ResNet-50's head, (M, 2048) x (1000, 2048), at every
    serving rung M in QUANT_RUNGS, every instance (float32, bfloat16 and
    float16 x; int8 and float8_e4m3fn weights): the route, the error
    against the plain version (within TOL of the largest output), ms,
    device ms, plain ms and the bound, with ``torch._weight_int8pack_mm``'s
    ms and device ms beside the int8 rows. Then the route-break table
    around the break (the GEMV and the tiled route's device ms at
    QFC_BREAK_MS, float32 x, int8 weights, the wrapper's route beside) and
    ptxas' registers and spills of every instance of both routes (fails
    on a spill)."""
    import numpy as np
    import torch
    n, k = TRAIN_CLASSES, 2048
    s = t(np.abs(rs.randn(n)).astype(np.float32) / 100 + 1e-3)
    ws = {"int8": _quant_weight(rs, t, n, k, torch.int8),
          "e4m3": _quant_weight(rs, t, n, k, torch.float8_e4m3fn)}
    sms = _sm_count()
    for m in QUANT_RUNGS:
        for xt in QFC_X:
            dt = getattr(torch, xt)
            x = t(rs.randn(m, k).astype(np.float32)).to(dt)
            bound = _bound_ms(m * k * x.element_size() + n * k + n * 4 +
                              m * n * 4, 2 * m * n * k)
            for st, w in ws.items():
                ref = ck.qfc_matmul_plain(x, w, s)
                rel = _max_err(ck.qfc_matmul(x, w, s), ref) / \
                    max(float(ref.abs().max()), 1e-30)
                if not rel <= TOL["qfc_matmul"]:
                    raise AssertionError(f"row 16 M={m} {xt} {st}: {rel}")
                kern = (lambda x=x, w=w: ck.qfc_matmul(x, w, s))
                lib = ""
                if st == "int8":
                    r = {}
                    _int8pack_library(ck, r, x, w, s)
                    lib = " torch._weight_int8pack_mm raises"
                    if r["library_ms"] is not None:
                        lib = (f" torch._weight_int8pack_mm ms "
                               f"{r['library_ms']:.5f} device_ms "
                               f"{_device_ms(r['library_call']):.6f}")
                print(f"kernels: row 16 M={m} x {xt} w {st}: route "
                      f"{ck._qfc_route(m, n, k, sms)} rel_err {rel:.3g} "
                      f"ms {_timed(kern):.5f} device_ms "
                      f"{_device_ms(kern):.6f} plain_ms "
                      f"{_timed(lambda x=x, w=w: ck.qfc_matmul_plain(x, w, s)):.5f}"
                      f" bound_ms {bound[0]:.6f} ({bound[1]}){lib}")
    print(f"kernels: row 16 route break, (M, {k}) x (N, {k}) int8, "
          f"float32 x, device ms")
    _qfc_break_rows(ck, rs, t, QFC_BREAK_MS, k)
    spills = []
    for fn, r in sorted(ck.resources("qfc_matmul").items()):
        if "registers" not in r:
            continue
        print(f"resources qfc_matmul: {fn}: registers={r['registers']} "
              f"spill_stores={r.get('spill_stores')} "
              f"spill_loads={r.get('spill_loads')}")
        if r.get("spill_stores") or r.get("spill_loads"):
            spills.append(fn)
    if spills:
        raise AssertionError(f"spilling qfc_matmul instances: {spills}")


def _stats_err(ck, x):
    """bn_stats against its plain version: the largest error of a
    channel's sum or sum of squares, relative to its sum of squares."""
    import torch
    (s, sq), (ps, psq) = ck.bn_stats(x), ck.bn_stats_plain(x)
    d = torch.maximum((s - ps).abs(), (sq - psq).abs())
    return float((d / psq.clamp_min(1e-30)).max()), _max_err(
        torch.stack([s, sq]), torch.stack([ps, psq]))


def _bn_stats_stem(ck, xs, name):
    """bn_stats over the stem's conv output (``xs[0]``) alone, its plan,
    device ms beside its byte bound and torch.var_mean's device ms; then
    the yardsticks of the step's 33 calls: the same bytes read by
    torch.sum, and 33 calls over one-value tensors (the per-call floor)."""
    import torch
    stem = xs[0]
    n, c, h, w = stem.shape
    plan = ck._bn_stats_plan(n, c, h * w, stem.element_size(),
                             stem.data_ptr() % 16 == 0, _sm_count())
    kern = _device_ms(lambda: ck.bn_stats(stem))
    lib = _device_ms(lambda: torch.var_mean(stem, dim=(0, 2, 3),
                                            unbiased=False))
    bound = _bound_ms(stem.numel() * stem.element_size() + 8 * c,
                      3 * stem.numel())
    print(f"kernels: {name} stem {tuple(stem.shape)} alone, plan {plan}: "
          f"device_ms {kern:.6f} bound_ms {bound[0]:.6f} ({bound[1]}) "
          f"x_bound {kern / bound[0]:.3f}; torch.var_mean device_ms "
          f"{lib:.6f}")
    tiny = [torch.ones((1, 1, 1, 1), device="cuda", dtype=stem.dtype)
            for _ in xs]
    read = _device_ms(lambda: [torch.sum(x) for x in xs])
    floor = _device_ms(lambda: [ck.bn_stats(x) for x in tiny])
    print(f"kernels: {name} over the step's {len(xs)} tensors: the same "
          f"bytes read by torch.sum device_ms {read:.6f}; {len(xs)} calls "
          f"over one-value tensors (the per-call floor) device_ms "
          f"{floor:.6f}")


def _bn_kernels(mx, ck, rs, t, rec):
    """The two FusedConvBNReLU kernels at the fused ResNet-50 path's
    shapes: the 33 fused conv outputs of one batch-32 training step (ms,
    bound and library per step, 33 launches each; the stem's
    (32, 64, 112, 112) alone printed beside), plus edges: HW = 1, 49,
    3136, 15 (not a multiple of 4), C = 1, N = 1, and a misaligned view.
    bn_stats is held relative to each channel's sum of squares,
    bn_apply_relu bit for bit. Fills ``rec``; returns the timed calls."""
    import numpy as np
    import torch
    shapes = _cbr_shapes(mx, TRAIN_BATCH)
    xs = [t((2 * rs.randn(*s) + 0.5).astype(np.float32)) for s in shapes]
    ss = [(t((1 + 0.1 * rs.randn(s[1])).astype(np.float32)),
           t(rs.randn(s[1]).astype(np.float32))) for s in shapes]
    edges = [(2, 8, 1, 1), (3, 16, 7, 7), (2, 64, 56, 56), (5, 3, 3, 5),
             (4, 1, 6, 6), (1, 7, 8, 8), (1, 1, 1, 1)]
    cases = xs[:1] + xs[-1:] + [t((2 * rs.randn(*e) + 0.5).astype(
        np.float32)) for e in edges]
    flat = t(rs.randn(1 + 2 * 8 * 16).astype(np.float32))
    cases.append(flat[1:].view(2, 8, 4, 4))          # 4-byte aligned only
    rel_s = abs_s = abs_a = 0.0
    for x in cases:
        r, a = _stats_err(ck, x)
        rel_s, abs_s = max(rel_s, r), max(abs_s, a)
        c = x.shape[1]
        sc = t((1 + 0.1 * rs.randn(c)).astype(np.float32))
        sh = t(rs.randn(c).astype(np.float32))
        got, ref = ck.bn_apply_relu(x, sc, sh), \
            ck.bn_apply_relu_plain(x, sc, sh)
        if not torch.equal(got, ref):
            abs_a = max(abs_a, _max_err(got, ref), 1e-30)
    nan = t(np.asarray([[[[np.nan, 1.0], [-1.0, 0.0]]]], np.float32))
    one = t(np.ones(1, np.float32))
    if not torch.equal(ck.bn_apply_relu(nan, one, one * 0).isnan(),
                       ck.bn_apply_relu_plain(nan, one, one * 0).isnan()):
        raise AssertionError("bn_apply_relu does not pass NaN through")
    elems = sum(int(np.prod(s)) for s in shapes)
    chans = sum(s[1] for s in shapes)
    stem = xs[0]
    print(f"kernels: the BatchNorm pair over the fused ResNet-50 step's "
          f"{len(shapes)} conv outputs ({elems} floats, "
          f"{4 * elems / 1e6:.1f} MB); stem {tuple(stem.shape)} alone: "
          f"bn_stats {_timed(lambda: ck.bn_stats(stem)):.5f} ms, "
          f"bn_apply_relu "
          f"{_timed(lambda: ck.bn_apply_relu(stem, *ss[0])):.5f} ms")
    _bn_stats_stem(ck, xs, "bn_stats")

    def var_mean():
        return [torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                for x in xs]
    rec["bn_stats"] = dict(
        max_abs_err=abs_s, rel_err=rel_s,
        ms=_timed(lambda: [ck.bn_stats(x) for x in xs], reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.bn_stats_plain(x) for x in xs],
                        reps=20, rounds=PLAIN_ROUNDS, warm=2),
        # one read of x and the moments the op derives from the sums
        library_ms=_timed(var_mean, reps=20, warm=2), library_call=var_mean,
        bound=_bound_ms(4 * elems + 8 * chans, 3 * elems))
    rec["bn_apply_relu"] = dict(
        max_abs_err=abs_a,
        ms=_timed(lambda: [ck.bn_apply_relu(x, *p) for x, p in zip(xs, ss)],
                  reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.bn_apply_relu_plain(x, *p)
                                 for x, p in zip(xs, ss)], reps=20,
                        warm=2, rounds=PLAIN_ROUNDS),
        library_ms=None,    # no one PyTorch call scales, shifts and clamps
        bound=_bound_ms(8 * elems + 8 * chans, 3 * elems))
    return {"bn_stats": lambda: [ck.bn_stats(x) for x in xs],
            "bn_apply_relu": lambda: [ck.bn_apply_relu(x, *p)
                                      for x, p in zip(xs, ss)]}


def _half_ulps(half, a, b, atol=0.0):
    """Largest |a - b|, less ``atol``, in ulps of the 16-bit type ``half``
    at the larger magnitude (values below the normal range in ulps of the
    smallest normal)."""
    import torch
    bits, emin = HALF_BITS[half]
    a, b = a.double(), b.double()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.tensor(2.0 ** emin, dtype=torch.float64,
                                     device=a.device))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    over = ((a - b).abs() - atol).clamp(min=0.0)
    return float((over / ulp).max()) if a.numel() else 0.0


def _bf16_decode_kernels(ck, rs, t, rec, f32, half="bfloat16"):
    """The decode path's four bfloat16 instances at the bfloat16 decode
    path's shapes (phase 2's float32 inputs ``f32`` rounded to bfloat16:
    8 ids into the (32000, 512) table, LayerNorm (8, 512), GeLU (8, 2048),
    the decode read at B=8, H=8, C=256, Dh=64, S=1 with staggered cursors)
    and edges: out-of-range ids; D = 13 and C = 13 (one value at a time);
    misaligned views; an S=16 window and a cursor at C - 1. The gather bit
    for bit, LayerNorm and GeLU within one bfloat16 ulp beyond 2e-5 (the
    statistics within 2e-5), the read within 2e-5 of its plain version on
    the same values. Bounds at bfloat16 bytes (the read's output float32).
    Fills ``rec``; returns the timed calls."""
    sfx = HALF_SFX[half]
    import numpy as np
    import torch
    import torch.nn.functional as F
    bf = getattr(torch, half)

    def tb(a):
        return t(a).to(bf)

    def skew(n, *shape):
        """A contiguous bfloat16 view 2 bytes off its allocation."""
        return tb(rs.randn(1 + n).astype(np.float32))[1:].view(*shape)
    ids, scale = f32["ids"], f32["scale"]
    w = f32["w"].to(bf)
    bad = t([-1, V, -V - 1, 5], torch.int32)
    small = t([0, 49, -1, 50, 7], torch.int32)
    err = 0.0
    for ww, ii in ((w, ids), (w, bad), (tb(rs.randn(50, 13)), small),
                   (skew(50 * 16, 50, 16), small)):
        for sc in (1.0, scale):
            err = max(err, _max_err(ck.embedding(ii, ww, sc),
                                    ck.embedding_plain(ii, ww, sc)))
    n = ids.numel()
    rec["embedding_" + sfx] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.embedding(ids, w, scale)),
        plain_ms=_timed(lambda: ck.embedding_plain(ids, w, scale)),
        library_ms=None,    # no single PyTorch call gathers AND scales
        bound=_bound_ms(n * 4 + 2 * n * D * 2, n * D, BF16_FLOPS_PER_S))
    x, g, b = (f32[k].to(bf) for k in ("x", "g", "b"))
    ulps = abs_err = stat_err = 0.0
    for xx, gg, bb in [(x, g, b)] + [
            (tb(3 * rs.randn(*e) + 1), tb(rs.randn(e[1])),
             tb(rs.randn(e[1]))) for e in LN_EDGES] + [
            (skew(4 * D, 4, D), g, b),
            (skew(2 * 1024, 2, 1024), tb(rs.randn(1024)),
             tb(rs.randn(1024)))]:
        y, stats = ck.layernorm_stats(xx, gg, bb, 1e-5)
        ref = ck.layernorm_plain(xx, gg, bb, 1e-5)
        ulps = max(ulps, _half_ulps(half, y, ref[0], atol=2e-5))
        abs_err = max(abs_err, _max_err(y, ref[0]))
        stat_err = max(stat_err, _max_err(stats[0], ref[1]),
                       _rstd_err(stats[1], ref[2]))
        if not torch.equal(stats[2], 1.0 / stats[1]):
            raise AssertionError(f"layernorm_{sfx}: std is not 1 / rstd")
    if not stat_err <= 2e-5:
        raise AssertionError(f"layernorm_bf16: mean/rstd off by {stat_err}")
    rec["layernorm_" + sfx] = dict(
        max_abs_err=abs_err, ulps=ulps,
        ms=_timed(lambda: ck.layernorm(x, g, b, 1e-5)),
        plain_ms=_timed(lambda: ck.layernorm_plain(x, g, b, 1e-5)),
        library_ms=_timed(lambda: F.layer_norm(x, (D,), g, b, 1e-5)),
        library_call=lambda: F.layer_norm(x, (D,), g, b, 1e-5),
        bound=_bound_ms(2 * x.numel() * 2 + 2 * D * 2 + 2 * 8 * 4,
                        8 * x.numel(), BF16_FLOPS_PER_S))
    h, hb = f32["h"].to(bf), f32["hb"].to(bf)
    ulps = abs_err = 0.0
    for xx, bb in ((h, hb), (tb(3 * rs.randn(3, 13)), tb(rs.randn(13))),
                   (tb(rs.randn(1, 4)), tb(rs.randn(4))),
                   (skew(8 * 4 * D, 8, 4 * D), hb)):
        got, ref = ck.bias_gelu(xx, bb), ck.bias_gelu_plain(xx, bb)
        ulps = max(ulps, _half_ulps(half, got, ref, atol=2e-5))
        abs_err = max(abs_err, _max_err(got, ref))
    rec["bias_gelu_" + sfx] = dict(
        max_abs_err=abs_err, ulps=ulps,
        ms=_timed(lambda: ck.bias_gelu(h, hb)),
        plain_ms=_timed(lambda: ck.bias_gelu_plain(h, hb)),
        library_ms=None,    # bias add + GeLU is two PyTorch calls
        bound=_bound_ms(2 * h.numel() * 2 + hb.numel() * 2, 8 * h.numel(),
                        BF16_FLOPS_PER_S))
    kc, vc, q1 = (f32[k].to(bf) for k in ("kc", "vc", "q1"))
    pos1 = f32["pos1"]
    B, H, Dh = kc.shape[0], kc.shape[1], kc.shape[3]
    err = _max_err(ck.decode_attention(q1, kc, vc, pos1),
                   ck.decode_attention_plain(q1, kc, vc, pos1))
    q16 = tb(rs.randn(B, H, 16, Dh))
    edge = t([0, 1, 127, 128, CAP - 16, CAP - 1, 200, 31], torch.int32)
    err = max(err, _max_err(ck.decode_attention(q16, kc, vc, edge),
                            ck.decode_attention_plain(q16, kc, vc, edge)))
    live = int(f32["live"].sum())
    rec["decode_attention_" + sfx] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.decode_attention(q1, kc, vc, pos1)),
        plain_ms=_timed(lambda: ck.decode_attention_plain(q1, kc, vc, pos1)),
        library_ms=_timed(lambda: F.scaled_dot_product_attention(
            q1, kc, vc, attn_mask=f32["mask"])),
        library_call=lambda: F.scaled_dot_product_attention(
            q1, kc, vc, attn_mask=f32["mask"]),
        bound=_bound_ms(q1.numel() * (2 + 4) + B * 4 + live * H * Dh * 2 * 2,
                        live * H * Dh * 4, BF16_FLOPS_PER_S))
    return {"embedding_" + sfx: lambda: ck.embedding(ids, w, scale),
            "layernorm_" + sfx: lambda: ck.layernorm(x, g, b, 1e-5),
            "bias_gelu_" + sfx: lambda: ck.bias_gelu(h, hb),
            "decode_attention_" + sfx: lambda: ck.decode_attention(q1, kc, vc,
                                                                 pos1)}


def _bf16_kernels(mx, ck, rs, t, rec, half="bfloat16"):
    """The four bfloat16 instances at the bfloat16 ResNet-50 path's shapes
    (the (32, 1000) head; the fused net's 33 conv outputs per batch-32
    step, the stem's (32, 64, 112, 112) alone printed beside) and edges:
    C = 7 (odd: one value at a time), 1025 (block per row), 65536, a
    misaligned view; labels 257 and 999 (float32, which bfloat16 would
    round to 256 and 1000), outside the classes, ignored; HW = 49 and 15
    (one value at a time), 196 (8-byte loads). Softmax within one
    bfloat16 ulp of its plain version (float32 sums in another order can
    move a quotient across a rounding boundary), the CE gradient and the
    apply pass bit for bit, the statistics relative to each channel's sum
    of squares. Bounds at bfloat16 bytes. Fills ``rec``; returns the
    timed calls."""
    sfx = HALF_SFX[half]
    import numpy as np
    import torch
    bf = getattr(torch, half)
    N, C = TRAIN_BATCH, TRAIN_CLASSES

    def tb(a):
        return t(a).to(bf)

    def skew(n, *shape):
        """A contiguous bfloat16 view 2 bytes off its allocation."""
        return tb(4 * rs.randn(1 + n).astype(np.float32))[1:].view(*shape)
    x = tb(4 * rs.randn(N, C).astype(np.float32))
    ulps = _half_ulps(half, ck.softmax(x), ck.softmax_plain(x))
    for e in [tb(4 * rs.randn(*sh).astype(np.float32))
              for sh in SOFTMAX_EDGES + ((4, 2),)] + \
            [skew(4 * C, 4, C), skew(3 * 1024, 3, 1024),
             skew(2 * 32000, 2, 32000)]:
        ulps = max(ulps, _half_ulps(half, ck.softmax(e), ck.softmax_plain(e)))
    rec["softmax_" + sfx] = dict(
        max_abs_err=_max_err(ck.softmax(x), ck.softmax_plain(x)), ulps=ulps,
        ms=_timed(lambda: ck.softmax(x)),
        plain_ms=_timed(lambda: ck.softmax_plain(x)),
        library_ms=_timed(lambda: torch.softmax(x, -1)),
        library_call=lambda: torch.softmax(x, -1),
        bound=_bound_ms(2 * N * C * 2, 5 * N * C, BF16_FLOPS_PER_S))
    p = ck.softmax_plain(x)
    lab = t(np.concatenate([rs.randint(0, C, N - 5),
                            [257, 999, C, -1, C - 1]]).astype(np.float32))
    err = 0.0
    for pp, ll in ((p, lab), (skew(N * C, N, C), lab),
                   (ck.softmax_plain(tb(rs.randn(N, 7).astype(np.float32))),
                    lab.clamp(max=6))):
        for s in (1.0, 1 / N):
            for u in (False, True):
                got = ck.softmax_ce_bwd(pp, ll, s, u, -1.0)
                want = ck.softmax_ce_bwd_plain(pp, ll, s, u, -1.0)
                if not torch.equal(got, want):
                    err = max(err, _max_err(got, want), 1e-30)
    rec["softmax_ce_bwd_" + sfx] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.softmax_ce_bwd(p, lab, 1.0)),
        plain_ms=_timed(lambda: ck.softmax_ce_bwd_plain(p, lab, 1.0)),
        library_ms=None,     # no one PyTorch call emits this gradient
        bound=_bound_ms(2 * N * C * 2 + N * 4, 3 * N * C, BF16_FLOPS_PER_S))
    shapes = _cbr_shapes(mx, TRAIN_BATCH)
    xs = [tb((2 * rs.randn(*sh) + 0.5).astype(np.float32)) for sh in shapes]
    ss = [(t((1 + 0.1 * rs.randn(sh[1])).astype(np.float32)),
           t(rs.randn(sh[1]).astype(np.float32))) for sh in shapes]
    cases = xs[:1] + xs[-1:] + [
        tb((2 * rs.randn(*e) + 0.5).astype(np.float32))
        for e in ((4, 256, 14, 14), (3, 16, 7, 7), (5, 3, 3, 5),
                  (2, 8, 1, 1), (1, 1, 1, 1))] + [skew(2 * 8 * 16, 2, 8, 4, 4)]
    rel_s = abs_s = abs_a = 0.0
    for xx in cases:
        r, a = _stats_err(ck, xx)
        rel_s, abs_s = max(rel_s, r), max(abs_s, a)
        c = xx.shape[1]
        sc = t((1 + 0.1 * rs.randn(c)).astype(np.float32))
        sh = t(rs.randn(c).astype(np.float32))
        got, want = ck.bn_apply_relu(xx, sc, sh), \
            ck.bn_apply_relu_plain(xx, sc, sh)
        if not torch.equal(got, want):
            abs_a = max(abs_a, _max_err(got, want), 1e-30)
    elems = sum(int(np.prod(sh)) for sh in shapes)
    chans = sum(sh[1] for sh in shapes)
    stem = xs[0]
    print(f"kernels: the {half} BatchNorm pair over the fused ResNet-50 "
          f"step's {len(shapes)} conv outputs ({elems} values, "
          f"{2 * elems / 1e6:.1f} MB); stem {tuple(stem.shape)} alone: "
          f"bn_stats_{sfx} {_timed(lambda: ck.bn_stats(stem)):.5f} ms, "
          f"bn_apply_relu_{sfx} "
          f"{_timed(lambda: ck.bn_apply_relu(stem, *ss[0])):.5f} ms")
    _bn_stats_stem(ck, xs, "bn_stats_" + sfx)

    def var_mean():
        return [torch.var_mean(xx, dim=(0, 2, 3), unbiased=False)
                for xx in xs]
    rec["bn_stats_" + sfx] = dict(
        max_abs_err=abs_s, rel_err=rel_s,
        ms=_timed(lambda: [ck.bn_stats(xx) for xx in xs], reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.bn_stats_plain(xx) for xx in xs],
                        reps=20, rounds=PLAIN_ROUNDS, warm=2),
        # one read of x and the moments the op derives from the sums
        library_ms=_timed(var_mean, reps=20, warm=2), library_call=var_mean,
        bound=_bound_ms(2 * elems + 8 * chans, 3 * elems, BF16_FLOPS_PER_S))
    rec["bn_apply_relu_" + sfx] = dict(
        max_abs_err=abs_a,
        ms=_timed(lambda: [ck.bn_apply_relu(xx, *q)
                           for xx, q in zip(xs, ss)], reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.bn_apply_relu_plain(xx, *q)
                                 for xx, q in zip(xs, ss)], reps=20,
                        warm=2, rounds=PLAIN_ROUNDS),
        library_ms=None,    # no one PyTorch call scales, shifts and clamps
        bound=_bound_ms(4 * elems + 8 * chans, 3 * elems, BF16_FLOPS_PER_S))
    return {"softmax_" + sfx: lambda: ck.softmax(x),
            "softmax_ce_bwd_" + sfx: lambda: ck.softmax_ce_bwd(p, lab, 1.0),
            "bn_stats_" + sfx: lambda: [ck.bn_stats(xx) for xx in xs],
            "bn_apply_relu_" + sfx: lambda: [ck.bn_apply_relu(xx, *q)
                                           for xx, q in zip(xs, ss)]}


def _model(mx, rs):
    """The decode symbol at full width and random parameters (numpy)."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    sym = tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                                n_head=N_HEAD, capacity=CAP, per_slot=True)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 1))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("gamma"):
            params[name] = (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            params[name] = (0.02 * rs.randn(*shape)).astype(np.float32)
    print(f"model: {sum(p.size for p in params.values())} parameters")
    return sym, params


def _decoder(mx, sym, params, ctx, slots=1, compute_dtype=None):
    """A driver over ``sym`` bound on ``ctx`` (int32 token ids, which
    ``compute_dtype`` leaves alone)."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    mod = mx.mod.Module(sym, data_names=("data",), label_names=[],
                        context=ctx, compute_dtype=compute_dtype)
    mod.bind([mx.io.DataDesc("data", (slots, 1), np.int32)], None,
             for_training=False)
    mod.init_params(initializer=None,
                    arg_params=mx.convert.params_from_numpy(params, ctx),
                    aux_params={}, allow_missing=True)
    return tfm.BatchedKVCacheDecoder(mod, CAP, slots=slots)


def _serve_waves(sched, prompts):
    """Phase 3's arrivals through the running scheduler's dispatch thread:
    1 request, then 3 (rung 1 -> 4), then 4 (-> 8), each wave once the
    previous one has streamed a few tokens; stops the scheduler. Returns
    (outputs, wall seconds)."""
    try:
        handles = []
        t_serve = time.perf_counter()
        for wave in ((0,), (1, 2, 3), (4, 5, 6, 7)):
            started = threading.Event()
            for i in wave:
                h = sched.submit(prompts[i])
                handles.append(h)
            # the event is bound now: a later wave rebinds `started`, and
            # this wave's handle keeps streaming after its wave is done
            h.add_token_callback(
                lambda _h, _tok, idx, ev=started: idx >= 3 and ev.set())
            if not started.wait(timeout=300):
                raise AssertionError("serving stalled: no tokens streamed")
        outs = [h.result(timeout=600) for h in handles]
        return outs, time.perf_counter() - t_serve
    finally:
        sched.stop()


def _check_served(outs, stats):
    """NEW in-range tokens per request, and the rung switched."""
    if any(len(o) != NEW for o in outs):
        raise AssertionError(f"want {NEW} tokens per request, got "
                             f"{[len(o) for o in outs]}")
    if stats["migrations"] < 2:
        raise AssertionError("the rung never switched")
    for o in outs:
        if not ((o >= 0) & (o < V)).all():
            raise AssertionError("served token ids out of range")


def phase_serve(mx, ck):
    """Full-width serve_decoder through its dispatch thread; returns the
    per-kernel launch counts of the served run, the symbol, parameters,
    prompts and the served chains."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    sym, params = _model(mx, rs)
    prompts = [rs.randint(0, V, PROMPT).tolist() for _ in range(N_REQ)]
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sched = mx.serve.serve_decoder(
        sym, mx.convert.params_from_numpy(params, mx.gpu(0)),
        name="lm-smoke", capacity=CAP, ladder=LADDER, context=mx.gpu(0),
        default_max_new=NEW)
    print(f"serve: engine built and warmed in "
          f"{time.perf_counter() - t0:.2f} s")
    after_warm = ck.launch_counts()
    outs, wall = _serve_waves(sched, prompts)
    counts = ck.launch_counts()
    stats = sched.stats()
    n_tok = sum(len(o) for o in outs)
    print(f"serve: {len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; step_ms={stats['step_ms']}; "
          f"migrations={stats['migrations']} iterations="
          f"{stats['iterations']}")
    print(f"serve: launches warmup={after_warm} total={counts}")
    _check_served(outs, stats)
    for name in DECODE_KERNELS:
        if not counts[name] > after_warm[name]:
            raise AssertionError(f"kernel {name} was not launched while "
                                 "serving")
    # teacher-force request 0's stream (prompt + 8 served tokens) on the
    # card and on the CPU; compare logits, and check each served token is
    # the CPU argmax or within LOGIT_TOL of it (a float32 near-tie)
    stream = prompts[0] + outs[0][:8].tolist()
    gpu, cpu = (_decoder(mx, sym, params, ctx)
                for ctx in (mx.gpu(0), mx.cpu()))
    worst = 0.0
    for d in (gpu, cpu):
        d.join(0)
    for i, tok in enumerate(stream[:-1]):
        a = gpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        b = cpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        if a.shape != (V,) or not np.isfinite(a).all():
            raise AssertionError(f"step {i}: logits {a.shape} not finite")
        worst = max(worst, float(np.abs(a - b).max()))
        if i >= PROMPT - 1:
            served = stream[i + 1]
            if b[served] < b.max() - LOGIT_TOL:
                raise AssertionError(
                    f"served token {served} at step {i} is not the CPU "
                    f"argmax {int(b.argmax())}")
    print(f"teacher-forced {len(stream) - 1} steps: max |logit card - "
          f"cpu| = {worst:.3g} (tol {LOGIT_TOL})")
    if not worst <= LOGIT_TOL:
        raise AssertionError("card and CPU logits disagree")
    return counts, sym, params, prompts, outs


def phase_profile(mx, sym, params, steps=16):
    """Where a full-rung decode step's time goes: 8 active slots, one
    token each, ``steps`` steps under the profiler (device activity
    only). Prints the wall time per step, the device-busy share and the
    kernels that take the most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    drv = _decoder(mx, sym, params, mx.gpu(0), slots=LADDER[-1])
    for s in range(LADDER[-1]):
        drv.join(s)
    tokens = np.random.RandomState(SEED).randint(0, V, (LADDER[-1], 1))
    for _ in range(4):
        drv.step(tokens).asnumpy()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            drv.step(tokens).asnumpy()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((_self_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _self_device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"profile: rung {LADDER[-1]}, {steps} steps: wall {wall_ms:.3f} "
          f"ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    for us, count, key in rows[:8]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step  {count // steps:4d} "
              f"launches/step  {key[:90]}")


def _resnet50(mx):
    from mxnet_tpu_torch.models import resnet
    return resnet.get_symbol(TRAIN_CLASSES, 50, TRAIN_IMAGE)


def _images(n, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *TRAIN_IMAGE).astype(np.float32),
            rs.randint(0, TRAIN_CLASSES, n).astype(np.float32))


def fused_resnet(sym, units, filter_list, num_classes, image_shape):
    """ResNet (bottleneck units, ImageNet stem) in its fused
    configuration, node for node ``models/resnet.py`` otherwise: the
    Convolution -> BatchNorm -> ReLU triples (the stem's, and each unit's
    conv1 + bn2 + relu2 and conv2 + bn3 + relu3) are ``FusedConvBNReLU``
    nodes named after the convolution (the conv's attributes without
    ``no_bias``, plus the BatchNorm's). ``sym`` is a symbol module; the
    tests keep a copy of this builder."""
    def cbr(data, num_filter, kernel, stride, pad, name):
        return sym.FusedConvBNReLU(data=data, num_filter=num_filter,
                                   kernel=kernel, stride=stride, pad=pad,
                                   workspace=256, name=name, **BN)

    data = sym.BatchNorm(data=sym.var("data"), fix_gamma=True, eps=2e-5,
                         momentum=0.9, name="bn_data")
    body = cbr(data, filter_list[0], (7, 7), (2, 2), (3, 3), "conv0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool0")
    for i, n_units in enumerate(units):
        nf = filter_list[i + 1]
        for j in range(n_units):
            name = f"stage{i + 1}_unit{j + 1}"
            stride = (1, 1) if i == 0 or j > 0 else (2, 2)
            act1 = sym.Activation(
                data=sym.BatchNorm(data=body, name=name + "_bn1", **BN),
                act_type="relu", name=name + "_relu1")
            conv1 = cbr(act1, nf // 4, (1, 1), (1, 1), (0, 0),
                        name + "_conv1")
            conv2 = cbr(conv1, nf // 4, (3, 3), stride, (1, 1),
                        name + "_conv2")
            conv3 = sym.Convolution(data=conv2, num_filter=nf, kernel=(1, 1),
                                    stride=(1, 1), pad=(0, 0), no_bias=True,
                                    workspace=256, name=name + "_conv3")
            shortcut = body if j else sym.Convolution(
                data=act1, num_filter=nf, kernel=(1, 1), stride=stride,
                no_bias=True, workspace=256, name=name + "_sc")
            body = conv3 + shortcut
    relu1 = sym.Activation(data=sym.BatchNorm(data=body, name="bn1", **BN),
                           act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    fc1 = sym.FullyConnected(data=sym.Flatten(data=pool1),
                             num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def fused_names(units):
    """{plain ResNet parameter name: fused configuration's}: gamma, beta
    and the moving statistics of each fused triple move from the
    BatchNorm's name to the convolution's (4 x 33 = 132 for ResNet-50)."""
    pairs = [("bn0", "conv0")]
    for i, n_units in enumerate(units):
        for j in range(n_units):
            name = f"stage{i + 1}_unit{j + 1}"
            pairs += [(name + "_bn2", name + "_conv1"),
                      (name + "_bn3", name + "_conv2")]
    return {f"{src}_{k}": f"{dst}_{k}" for src, dst in pairs
            for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _renamed(params):
    names = fused_names(RESNET50["units"])
    return {names.get(k, k): v for k, v in params.items()}


def _fused50(mx):
    return fused_resnet(mx.sym, **RESNET50)


def _cbr_shapes(mx, batch):
    """The output shapes of the fused ResNet-50's 33 FusedConvBNReLU
    nodes at ``batch`` images: the shapes both kernels see on the path."""
    sym = _fused50(mx)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch,) + TRAIN_IMAGE)
    known = dict(zip(sym.list_arguments(), arg_shapes))
    known.update(zip(sym.list_auxiliary_states(), aux_shapes))
    entries = sym._infer_entry_shapes(known)
    return [tuple(entries[id(n)][0]) for n in sym._topo_nodes()
            if n.op == "FusedConvBNReLU"]


def _step_recorder():
    """A batch_end_callback that synchronizes the card and keeps the wall
    clock and the fit's ``mfu.achieved_flops_per_sec`` gauge (None while
    telemetry is off) at each batch's end: returns (callback, stamps,
    rates)."""
    import torch
    from mxnet_tpu_torch.telemetry import metrics
    stamps, rates = [], []

    def step_end(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        g = metrics.get_metric("mfu.achieved_flops_per_sec")
        rates.append(None if g is None else g.value)
    return step_end, stamps, rates


class _HandOffStamps:
    """A DataIter seen through a clock: keeps the time at which each batch
    is handed to ``fit``. From there to the start of the batch's metric
    update (``_metric_stamps``) is the work that ``fit``'s
    ``module.fit.batch`` span times (forward, backward, update, to
    completion), without the metric update and the iterator's host copy of
    the next batch, which the span leaves out."""

    def __init__(self, it):
        self._it, self.stamps = it, []

    def __getattr__(self, name):
        return getattr(self._it, name)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.stamps.append(time.perf_counter())
        return batch


def _metric_stamps(metric):
    """Wrap ``metric.update`` to keep the time at which each batch's
    metric update starts; returns the list of stamps."""
    stamps, update = [], metric.update

    def stamped(*args, **kwargs):
        stamps.append(time.perf_counter())
        return update(*args, **kwargs)
    metric.update = stamped
    return stamps


@contextlib.contextmanager
def _telemetry(mx):
    """Telemetry on (its registry cleared) for one fit: the batch spans
    synchronize the card, and the fit sets its MFU gauges."""
    mx.telemetry.reset()
    mx.telemetry.enable()
    try:
        yield
    finally:
        mx.telemetry.disable()


def _mfu_readings(mx, mod, it, batch_ms, rates, label, gate=True):
    """Print the four MFU readings ``Module.fit`` set while telemetry was
    on, and hold them to the script's own count (the rate only under
    ``gate``): ``mfu.flops_per_step``
    is ``cost_table``'s train FLOPs; the p50 of the per-batch
    ``mfu.achieved_flops_per_sec`` (``rates``, the first batch excluded)
    lies within MFU_RTOL of those FLOPs plus the optimizer update's over
    the p50 of the script's own batch times (``batch_ms``: hand-off to
    the start of the metric update, the same batches). The step time
    between end callbacks also holds the iterator's host copy of the
    batch and the metric update, which the span leaves out, and which
    vary with the load on a shared host."""
    import numpy as np
    from mxnet_tpu_torch.ops.cost import optimizer_flops
    from mxnet_tpu_torch.telemetry import metrics, mfu
    table = mfu.cost_table(mod.symbol, dict(list(it.provide_data) +
                                            list(it.provide_label)))
    n_params = sum(int(np.prod(v.shape)) for v in mod.get_params()[0].values())
    flops = table["train_flops"] + optimizer_flops(
        type(mod._optimizer).__name__, n_params)
    got = {k: metrics.get_metric(k) for k in (
        "mfu.model", "mfu.flops_per_step", "mfu.node_coverage",
        "mfu.achieved_flops_per_sec")}
    if any(g is None for g in got.values()):
        raise AssertionError(f"{label}: MFU gauges missing: {got}")
    got = {k: g.value for k, g in got.items()}
    own = flops / (float(np.percentile(batch_ms, 50)) / 1e3)
    off = float(np.percentile(rates[1:], 50)) / own - 1
    print(f"{label}: mfu.model={got['mfu.model']:.5f} (of the bf16 peak, "
          f"{BF16_FLOPS_PER_S:.3g} FLOP/s) mfu.flops_per_step="
          f"{got['mfu.flops_per_step']:.6g} mfu.node_coverage="
          f"{got['mfu.node_coverage']:.3f} mfu.achieved_flops_per_sec="
          f"{got['mfu.achieved_flops_per_sec']:.6g} (last batch; p50 over "
          f"the batches {100 * off:+.1f}% from the script's FLOPs per step "
          f"{flops:.6g} over the p50 batch, hand-off to metric update, "
          f"{np.percentile(batch_ms, 50):.2f} ms = {own:.6g} FLOP/s, limit "
          f"{100 * MFU_RTOL:.0f}%" + ("" if gate else ", not held: the rate "
                                        "of a few host-bound batches") + ")")
    if got["mfu.flops_per_step"] != table["train_flops"] or \
            (gate and abs(off) > MFU_RTOL) or \
            got["mfu.node_coverage"] != 1.0:
        raise AssertionError(f"{label}: MFU readings disagree with the "
                             "script's count")


def phase_train(mx, ck):
    """ResNet-50 through Module.fit on gpu(0). Returns (launch counts of
    the fit, the bound module for the profile phase)."""
    import torch
    print(_tf32(True) + " (PyTorch's default, for the training phases)")
    X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    print(f"train: ResNet-50 {TRAIN_IMAGE} batch {TRAIN_BATCH}")
    counts, per_step = _fit_phase(mx, ck, mod, it, "train", TRAIN_BATCH,
                                  "img", ("conv0_weight", "fc1_weight"),
                                  optimizer_params=SGD)
    # Module.update: one multi-tensor launch a step, no per-array launch
    want = {"softmax": 1, "softmax_ce_bwd": 1, "sgd_mom_multi": 1,
            "sgd_mom": 0}
    for k, v in want.items():
        if per_step[k] != v:
            raise AssertionError(f"{k}: {per_step[k]} launches per step, "
                                 f"want {v}")
    per_index = _update_host_ms(ck, mod, "train", "sgd_mom")
    return counts, mod, it, per_index


def _update_host_ms(ck, mod, label, kernel, rounds=5):
    """Module.update's host ms a step (its one multi-tensor launch) beside
    a per-index loop over ``mod._updater`` (a caller's own ``Updater(i,
    g, w)``: the per-array kernel, one launch an array) on the same module
    and gradients, in turns; medians of ``rounds`` calls, each timed from
    a synchronized card to the call's return, with its launches counted
    from 0. The weights, states and update counts are put back after.
    Returns the per-array kernel's launches of the per-index calls."""
    import numpy as np
    import torch
    ex, upd, o = mod._exec_group, mod._updater, mod._optimizer
    cells = list(ex.param_arrays)
    for st in upd.states.values():
        cells += [x for x in (st if isinstance(st, tuple) else (st,))
                  if x is not None]
    saved = [c.astorch().clone() for c in cells]
    counts = dict(o._index_update_count), o.num_update

    def per_index():
        for i, (w, g) in enumerate(zip(ex.param_arrays, ex.grad_arrays)):
            if g is not None:
                upd(i, g, w)
    paths = {"Module.update": mod.update, "per-index Updater": per_index}
    ms = {k: [] for k in paths}
    launches = {k: {} for k in paths}
    for r in range(rounds):
        for name in (list(paths) if r % 2 == 0 else list(paths)[::-1]):
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            paths[name]()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for k, v in ck.launch_counts().items():
                if v:
                    launches[name][k] = launches[name].get(k, 0) + v
    for c, v in zip(cells, saved):
        c.astorch().copy_(v)
    o._index_update_count, o.num_update = counts
    n = sum(g is not None for g in ex.grad_arrays)
    print(f"{label}: host ms a step, {n} arrays, medians of {rounds} in "
          "turns: " + "; ".join(
              f"{k} {np.median(v):.4f} (launches a call "
              f"{ {c: x / rounds for c, x in launches[k].items()} })"
              for k, v in ms.items()))
    want = {"Module.update": {kernel + "_multi": rounds},
            "per-index Updater": {kernel: n * rounds}}
    if launches != want:
        raise AssertionError(f"{label}: update launches {launches}, want "
                             f"{want}")
    return launches["per-index Updater"][kernel]


def _fit_phase(mx, ck, mod, it, label, items, unit, watch, into=None,
               on_batch=None, mfu_gate=True, metric=None, **fit_kw):
    """Fit the bound, initialized ``mod`` over ``it`` on the card for one
    epoch with telemetry on: prints items/s and p50/p99 step ms without
    the first batch, peak device memory, the MFU readings (held to the
    script's own count unless ``mfu_gate`` is off), launches per step and
    the train metric; requires a finite loss and the ``watch``
    parameters moved. ``into``, a dict, takes the rate, the p50 / p99
    step ms and the peak GiB; ``on_batch`` runs after each batch's end
    stamp; ``metric`` (acc and ce by default) is the fit's train metric,
    its second value the loss. Returns (launches of the fit, launches per
    step)."""
    import numpy as np
    import torch
    args, _ = mod.get_params()
    before = {k: args[k].asnumpy() for k in watch}
    step_end, stamps, rates = _step_recorder()
    metric = metric or mx.metric.create(["acc", "ce"])
    metric_starts = _metric_stamps(metric)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    fed = _HandOffStamps(it)
    t0 = time.perf_counter()
    with _telemetry(mx):
        mod.fit(fed, num_epoch=1, eval_metric=metric,
                batch_end_callback=[step_end] + ([on_batch] if on_batch
                                                 else []), **fit_kw)
    counts = ck.launch_counts()
    steps = np.diff(stamps) * 1e3          # the first batch excluded
    batches = (np.subtract(metric_starts, fed.stamps) * 1e3)[1:]
    got = dict(rate=items * len(steps) / (steps.sum() / 1e3),
               p50=float(np.percentile(steps, 50)),
               p99=float(np.percentile(steps, 99)),
               peak=torch.cuda.max_memory_allocated() / 2**30)
    if into is not None:
        into.update(got)
    print(f"{label}: {len(stamps)} steps in {time.perf_counter() - t0:.2f} "
          f"s (first {1e3 * (stamps[0] - t0):.1f} ms); without the first: "
          f"{got['rate']:.1f} {unit}/s, step p50 {got['p50']:.2f} ms p99 "
          f"{got['p99']:.2f} ms; peak device memory {got['peak']:.2f} GiB")
    _mfu_readings(mx, mod, it, batches, rates, label, gate=mfu_gate)
    per_step = {k: v / len(stamps) for k, v in counts.items()}
    print(f"{label}: launches per step {per_step}")
    names, values = metric.get()
    print(f"{label}: {dict(zip(names, values))}")
    if not np.isfinite(values[1]):
        raise AssertionError(f"{label}: the training loss is not finite")
    for k, v in before.items():
        moved = float(np.abs(args[k].asnumpy() - v).max())
        print(f"{label}: {k} moved by up to {moved:.3g}")
        if not moved > 0:
            raise AssertionError(f"{label}: {k} did not move")
    return counts, per_step


def _one_step(mx, sym, args, auxs, ctx, X, y, optimizer_params):
    mod = mx.mod.Module(sym, context=ctx)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=len(X)), num_epoch=1,
            arg_params=mx.convert.params_from_numpy(args, ctx),
            aux_params=mx.convert.params_from_numpy(auxs, ctx),
            optimizer_params=optimizer_params)
    a, x = mod.get_params()
    return (mod.get_outputs()[0].asnumpy(),
            {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _resnet50_start(mx, batch):
    """ResNet-50's Xavier (seed SEED) parameters and aux states, numpy,
    and ``batch`` images with labels (seed SEED + 1)."""
    import torch
    X, y = _images(batch, SEED + 1)
    init = mx.mod.Module(_resnet50(mx), context=mx.cpu())
    init.bind([("data", X.shape)], [("softmax_label", y.shape)])
    init.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    return args, auxs, X, y


def _step_parity(mx, sym, args, auxs, X, y, label,
                 cpu_scope=contextlib.nullcontext, seed=None, sgd=SGD):
    """One SGD step (``sgd``) of ``sym`` on the card and on the CPU (inside
    ``cpu_scope()``) from the same parameters, each after
    ``mx.random.seed(seed)`` where a seed is given (a graph with Dropout
    then draws the same masks on both): the forward (probabilities,
    moving statistics) within FWD_TOL, the updated weights within
    SPREAD_FACTOR times the CPU's own spread under a 1e-6 relative
    perturbation of the starting weights."""
    import numpy as np
    rs = np.random.RandomState(SEED + 2)
    nudged = {k: (v * (1 + 1e-6 * rs.randn(*v.shape))).astype(np.float32)
              for k, v in args.items()}

    def step(start, ctx):
        if seed is not None:
            mx.random.seed(seed)
        return _one_step(mx, sym, start, auxs, ctx, X, y, sgd)
    t0 = time.perf_counter()
    with cpu_scope():
        cpu = step(args, mx.cpu())
        spread = step(nudged, mx.cpu())
    t_cpu = time.perf_counter() - t0
    gpu = step(args, mx.gpu(0))
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    aux_err = max((float((np.abs(gpu[2][k] - v) / (1 + np.abs(v))).max())
                   for k, v in cpu[2].items()), default=0.0)
    worst, worst_k, arg_err = -1.0, None, 0.0
    for k, v in cpu[1].items():
        d = float(np.abs(gpu[1][k] - v).max())
        floor = float(np.abs(spread[1][k] - v).max())
        arg_err = max(arg_err, d)
        ratio = d / (SPREAD_FACTOR * floor + 1e-5)
        if ratio > worst:
            worst, worst_k = ratio, (k, d, floor)
    print(f"{label}: one step at batch {len(X)} (CPU steps {t_cpu:.1f} s): "
          f"max |prob card - cpu| = {prob_err:.3g} (limit {FWD_TOL}); max "
          f"relative |aux card - cpu| = {aux_err:.3g} (limit {FWD_TOL}); "
          f"max |arg card - cpu| = {arg_err:.3g}; worst array {worst_k[0]}: "
          f"{worst_k[1]:.3g} against the CPU's 1e-6 spread {worst_k[2]:.3g}"
          f" (limit {SPREAD_FACTOR} x spread + 1e-5, ratio {worst:.3f})")
    if not (prob_err <= FWD_TOL and aux_err <= FWD_TOL and worst <= 1.0):
        raise AssertionError(f"{label}: card and CPU training steps "
                             "disagree")


def phase_train_parity(mx):
    """One ResNet-50 step at batch 2, card vs CPU, TF32 off."""
    print(_tf32(False) + " (parity phase)")
    args, auxs, X, y = _resnet50_start(mx, 2)
    _step_parity(mx, _resnet50(mx), args, auxs, X, y, "parity")


def phase_adam(mx, ck):
    """Two Adam steps of the same fit at batch 4, then Module.update's
    host ms beside the per-index loop's; returns the fit's counts, with
    ``adam`` the per-index loop's launches."""
    import torch
    print(_tf32(True))
    X, y = _images(8, SEED + 3)
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    ck.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=4), num_epoch=1,
            optimizer="adam", initializer=mx.initializer.Xavier(
                rng=torch.Generator().manual_seed(SEED)),
            optimizer_params={"learning_rate": 1e-3, "wd": 1e-4})
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"adam: 2 steps at batch 4: launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if counts["adam_multi"] != 2 or counts["adam"] or counts["sgd_mom"] \
            or counts["sgd_mom_multi"]:
        raise AssertionError(f"adam_multi launched {counts['adam_multi']} "
                             "times, want 2 (one a step), and no other "
                             "update kernel")
    counts["adam"] = _update_host_ms(ck, mod, "adam", "adam", rounds=3)
    return counts


#: device kernels by who wrote them: the port's CUDA kernels (by their
#: names in csrc/ — PyTorch's own softmax kernels are softmax_warp_forward
#: / _backward, so no bare "softmax_" prefix), the convolution and GEMM
#: libraries (cuDNN, cuBLAS, CUTLASS), PyTorch's own elementwise /
#: reduction kernels, and copies
_PORT_KERNELS = ("softmax_rows_", "softmax_ce_bwd_kernel", "sgd_mom_f32",
                 "adam_f32", "multi_update", "ln_fwd", "bias_gelu", "emb_gather",
                 "decode_attn", "ln_bwd_", "ln_dparams_", "flash_fwd",
                 "flash_tc", "bn_stats_", "bn_apply_relu_", "dropout<",
                 "uniform_f32")


def _kernel_group(key):
    if any(k in key for k in _PORT_KERNELS):
        return "port kernels"
    if key.startswith(USER_KERNELS):
        return "user kernels"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "at::native" in key or "softmax_warp_" in key:
        return "PyTorch elementwise/reduction"
    return "conv/GEMM libraries"


def phase_train_profile(mod, it, steps=4, label="train profile",
                        gemm_flops=None):
    """Where a training step's time goes (ResNet-50's, the LM's). With
    ``gemm_flops`` (the matmul flops of one step), also the rate the
    convolution/GEMM libraries reach over their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((_self_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _self_device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"{label}: {steps} steps: wall {wall_ms:.2f} ms/step, "
          f"device busy {busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%"
          f" of wall), {sum(r[1] for r in rows) // steps} kernel launches "
          "per step")
    groups = {}
    for us, count, key in rows:
        g = _kernel_group(key)
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + us, c + count)
    for g, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g}: {us / 1e3 / steps:.3f} ms/step "
              f"({100 * us / 1e3 / steps / busy_ms:.1f}% of device time), "
              f"{count // steps} launches/step")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step  {count // steps:5d} "
              f"launches/step  {key[:90]}")
    if gemm_flops:
        lib_s = groups["conv/GEMM libraries"][0] / 1e6 / steps
        print(f"  the libraries' GEMMs: {gemm_flops / 1e12:.3f} TFLOP per "
              f"step, {gemm_flops / lib_s / 1e12:.1f} TFLOP/s over their "
              f"device time ({100 * gemm_flops / lib_s / F32_FLOPS_PER_S:.1f}"
              f"% of the float32 peak outside the tensor cores)")
    for us, count, key in rows:
        if _kernel_group(key) == "port kernels":
            print(f"  port {us / 1e3 / steps:9.4f} ms/step  "
                  f"{count // steps:5d} launches/step  {key[:80]}")


def _lm_gemm_flops():
    """Matmul flops of one full-width LM step: 6 per weight per token
    (forward, data and weight gradients) over the FullyConnected weights
    (12 D^2 a layer) and the tied head (V D), plus the attention
    backward's recompute: 6 (T x T x Dh) products per (b, h) row."""
    weights = N_LAYER * 12 * D * D + V * D
    attn = N_LAYER * 6 * 2 * LM_BATCH * N_HEAD * LM_SEQ ** 2 * (D // N_HEAD)
    return 6 * weights * LM_BATCH * LM_SEQ + attn


def _lm_symbol(seq, n_head=N_HEAD, n_layer=N_LAYER):
    from mxnet_tpu_torch.models import transformer as tfm
    return tfm.get_symbol(vocab_size=V, d_model=D, n_layer=n_layer,
                          n_head=n_head, seq_len=seq)


def phase_lm_train(mx, ck):
    """The transformer LM at the bench's full width through Module.fit
    on gpu(0). Returns (launch counts of the fit, module, iterator)."""
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(True) + " (PyTorch's default, for the LM training phase)")
    it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, LM_STEPS, seed=SEED)
    mod = mx.mod.Module(_lm_symbol(LM_SEQ), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    watch = ("lm_tok_embed_weight", "lm_l0_qkv_weight", "lm_l0_ln1_beta",
             f"lm_l{N_LAYER - 1}_ffn2_weight", "lm_ln_f_gamma")
    print(f"lm train: V={V} d_model={D} {N_LAYER} layers {N_HEAD} heads "
          f"T={LM_SEQ} batch {LM_BATCH}")
    counts, per_step = _fit_phase(mx, ck, mod, it, "lm train",
                                  LM_BATCH * LM_SEQ, "tokens", watch,
                                  into=LM_FIT, optimizer="sgd",
                                  optimizer_params=LM_SGD)
    want = {k: LM_PER_STEP.get(k, 0) for k in counts}
    if per_step != want:
        raise AssertionError(f"LM launches per step {per_step}, want {want}")
    return counts, mod, it


def _ring_start(n_layer, n_head=N_HEAD):
    """The sequence-parallel phases' LM symbol at T = 4096 and its
    numpy-seeded parameters (the LM parity phase's recipe)."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    sym = tfm.get_symbol(vocab_size=V, d_model=D, n_layer=n_layer,
                         n_head=n_head, seq_len=RING_SEQ)
    shapes, _, _ = sym.infer_shape(data=(RING_BATCH, RING_SEQ),
                                   softmax_label=(RING_BATCH * RING_SEQ,))
    rs = np.random.RandomState(SEED + 6)
    params = {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                  else 0.02 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return sym, params


def _ring_fit(mx, ck, sym, params, label, ring, compute_dtype=None,
              profile=False):
    """One fit of RING_STEPS batches (the same seeded batches every time)
    from ``params`` on the card: over ``[gpu(0)] * RING_SHARDS`` with
    ``spmd=True, mesh=MeshConfig(seq=RING_SHARDS)`` when ``ring``, else
    on ``gpu(0)`` alone; with ``profile``, then 2 steps under the
    profiler. Returns (the fit's launches, launches per step, per-batch
    losses, the parameters after, the rate and step ms of
    ``_fit_phase``)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import MeshConfig
    it = tfm.SyntheticLMIter(V, RING_BATCH, RING_SEQ, RING_STEPS,
                             seed=SEED + 7)
    ctx = [mx.gpu(0)] * (RING_SHARDS if ring else 1)
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(it.provide_data, it.provide_label, spmd=ring,
             mesh=MeshConfig(seq=RING_SHARDS) if ring else None)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params,
                                                            mx.gpu(0)))
    losses = []

    def on_batch(param):
        prob = mod.get_outputs()[0].astorch()
        label_ids = param.locals["batch"].label[0].astorch().to(
            prob.device).long()
        picked = prob.float().gather(1, label_ids[:, None])
        losses.append(float(-torch.log(picked + 1e-8).mean()))
    into = {}
    watch = ("lm_tok_embed_weight", "lm_l0_qkv_weight", "lm_ln_f_gamma")
    counts, per_step = _fit_phase(mx, ck, mod, it, label,
                                  RING_BATCH * RING_SEQ,
                                  "tokens", watch, into=into,
                                  on_batch=on_batch, optimizer="sgd",
                                  optimizer_params=LM_SGD)
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    if profile:
        phase_train_profile(mod, it, steps=2, label=label + " profile")
    del mod
    torch.cuda.empty_cache()
    return counts, per_step, np.asarray(losses), after, into


def _ring_launches(label, per_step, n_layer, sfx=""):
    """The ring fit's launches per step: every LM kernel of the unsharded
    step but the normalized flash kernel, and n_layer x 10 partial
    kernels."""
    want = dict(LM_PER_STEP, flash_attention=0,
                flash_attention_partial=n_layer * RING_PER_LAYER)
    for k in ("layernorm", "ln_bwd"):
        want[k] = 2 * n_layer + 1
    for k in ("bias_gelu", "bias_gelu_dx"):
        want[k] = n_layer
    if sfx:
        wrapper = {"ln_bwd": "layernorm_bwd"}
        want = {wrapper.get(k, k) + sfx: v for k, v in want.items()}
    want = {k: want.get(k, 0) for k in per_step}
    print(f"{label}: flash_attention_partial{sfx} "
          f"{per_step['flash_attention_partial' + sfx]:.1f} launches per "
          f"step (want {n_layer} layers x {RING_PER_LAYER}), "
          f"flash_attention{sfx} {per_step['flash_attention' + sfx]:.1f}")
    if per_step != want:
        raise AssertionError(f"{label}: launches per step {per_step}, "
                             f"want {want}")


def phase_ring_fit(mx, ck):
    """The bench LM at T = 4096, batch 2, through fit(spmd=True,
    mesh=MeshConfig(seq=4)) over [gpu(0)] * 4 and through the unsharded
    fit, from the same parameters and batches, TF32 off: tokens/s and
    p50/p99 of each, the ring's exact launches, per-step losses and
    every parameter within RING_LOSS_TOL / RING_WEIGHT_TOL. Returns the
    ring fit's launches."""
    import numpy as np
    print(_tf32(False) + " (sequence-parallel fit, ring vs unsharded)")
    sym, params = _ring_start(N_LAYER)
    print(f"ring fit: V={V} d_model={D} {N_LAYER} layers {N_HEAD} heads "
          f"T={RING_SEQ} batch {RING_BATCH}, seq={RING_SHARDS} over "
          f"[gpu(0)] * {RING_SHARDS}, {RING_STEPS} SGD steps")
    runs = {ring: _ring_fit(mx, ck, sym, params,
                            "ring fit " + ("ring" if ring else "unsharded"),
                            ring, profile=True) for ring in (False, True)}
    _ring_launches("ring fit ring", runs[True][1], N_LAYER)
    (_, _, loss0, p0, r0), (counts, _, loss1, p1, r1) = runs[False], \
        runs[True]
    loss_err = float(np.abs(loss1 - loss0).max())
    worst = max((float(np.abs(p1[k] - p0[k]).max()), k) for k in p0)
    print(f"ring fit: losses unsharded {loss0.tolist()} ring "
          f"{loss1.tolist()}: max |diff| {loss_err:.3g} (limit "
          f"{RING_LOSS_TOL}); worst parameter {worst[1]}: |ring - "
          f"unsharded| = {worst[0]:.3g} (limit {RING_WEIGHT_TOL}); "
          f"tokens/s ring {r1['rate']:.1f} unsharded {r0['rate']:.1f} "
          f"({r1['rate'] / r0['rate']:.3f}x)")
    if not (loss_err <= RING_LOSS_TOL and worst[0] <= RING_WEIGHT_TOL):
        raise AssertionError("the ring fit and the unsharded fit disagree")
    return counts


def phase_ring_half(mx, ck, half):
    """The sequence-parallel fit in ``half`` (bfloat16 or float16) at
    RING_HALF_LAYERS layers, beside the unsharded fit in ``half`` and in
    float32 from the same parameters: the ring launches only the 16-bit
    partial instance (layers x 10 a step), and every parameter lies
    within BF16_SPREAD times the unsharded 16-bit fit's distance from the
    float32 one (plus one 16-bit ulp of its largest magnitude). Returns
    the ring fit's launches."""
    import numpy as np
    sfx = "_" + HALF_SFX[half]
    sym, params = _ring_start(RING_HALF_LAYERS)
    _, _, loss32, p32, _ = _ring_fit(
        mx, ck, sym, params, f"ring {half} float32 unsharded", False)
    _, _, loss0, p0, r0 = _ring_fit(mx, ck, sym, params,
                                    f"ring {half} unsharded", False, half)
    counts, per_step, loss1, p1, r1 = _ring_fit(
        mx, ck, sym, params, f"ring {half} ring", True, half)
    _ring_launches(f"ring {half}", per_step, RING_HALF_LAYERS, sfx)
    bits = HALF_BITS[half][0]
    worst = (-1.0, None)
    for k, v in p0.items():
        limit = BF16_SPREAD * float(np.abs(v - p32[k]).max()) + \
            float(np.abs(v).max()) * 2.0 ** -bits
        worst = max(worst, (float(np.abs(p1[k] - v).max()) / limit, k))
    loss_err = float(np.abs(loss1 - loss0).max())
    loss_spread = float(np.abs(loss0 - loss32).max())
    print(f"ring {half}: losses unsharded {loss0.tolist()} ring "
          f"{loss1.tolist()} float32 {loss32.tolist()}; worst parameter "
          f"{worst[1]}: {worst[0]:.3g} of its limit ({BF16_SPREAD} x the "
          f"unsharded {half}-vs-float32 distance + 1 ulp); loss |ring - "
          f"unsharded| {loss_err:.3g} (limit {BF16_SPREAD} x "
          f"{loss_spread:.3g} + 1e-4); tokens/s ring {r1['rate']:.1f} "
          f"unsharded {r0['rate']:.1f}")
    if not (worst[0] <= 1.0 and
            loss_err <= BF16_SPREAD * loss_spread + 1e-4):
        raise AssertionError(f"the {half} ring fit and the unsharded fit "
                             "disagree")
    return counts


def phase_ring_layer(mx):
    """One layer's attention at the ring fit's shapes (2, 8, 4096, 64),
    causal, float32, TF32 off: forward and forward + backward of the
    ring over [gpu(0)] * 4 (the partial kernels and their merges; the
    plain ring's recompute) against the unsharded flash attention (the
    flash kernel; the plain (T, T) recompute), CUDA events around
    repeated calls."""
    import torch
    from mxnet_tpu_torch.parallel import (MeshConfig, build_mesh,
                                          ring_attention_sharded)
    from mxnet_tpu_torch.rtc import flash_attention_fn
    gen = torch.Generator().manual_seed(SEED + 8)
    qkv = [torch.randn(RING_BATCH, N_HEAD, RING_SEQ, D // N_HEAD,
                       generator=gen).cuda().requires_grad_(True)
           for _ in range(3)]
    ct = torch.randn(qkv[0].shape, generator=gen).cuda()
    mesh = build_mesh(MeshConfig(seq=RING_SHARDS),
                      [mx.gpu(0)] * RING_SHARDS)
    arms = {"ring": lambda: ring_attention_sharded(*qkv, mesh, causal=True),
            "unsharded": lambda: flash_attention_fn(*qkv, True)}
    for name, fwd in arms.items():
        with torch.no_grad():
            f_ms = _timed(fwd, reps=10, warm=2)
        fb_ms = _timed(lambda: torch.autograd.grad(fwd(), qkv, ct), reps=5,
                       warm=1)
        print(f"ring layer: {name} attention at {tuple(qkv[0].shape)} "
              f"causal: forward {f_ms:.3f} ms, forward + backward "
              f"{fb_ms:.3f} ms (backward {fb_ms - f_ms:.3f} ms)")


def _lm_step(mx, sym, params, ctx, batch, compute_dtype=None):
    """One forward/backward/update of the LM from ``params`` on ``ctx``:
    (probabilities, {name: gradient}, {name: updated weight}), numpy
    float32."""
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(batch.provide_data, batch.provide_label)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params, ctx))
    mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
    mod.forward_backward(batch)
    exe = mod._exec_group.executor
    grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
    mod.update()
    return (mod.get_outputs()[0].asnumpy(), grads,
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()})


def _lm_parity_start(mx, n_head=N_HEAD, n_layer=N_LAYER, seq=LM_PARITY_SEQ):
    """The parity phases' LM symbol (T = ``seq``, ``n_layer`` layers),
    numpy-seeded parameters and one batch of batch 2."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    sym = _lm_symbol(seq, n_head, n_layer)
    shapes, _, _ = sym.infer_shape(
        data=(LM_PARITY_BATCH, seq),
        softmax_label=(LM_PARITY_BATCH * seq,))
    rs = np.random.RandomState(SEED + 4)
    params = {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                  else 0.02 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    batch = next(iter(tfm.SyntheticLMIter(V, LM_PARITY_BATCH, seq, 1,
                                          seed=SEED + 5)))
    return sym, params, batch


def phase_lm_parity(mx, n_head=N_HEAD):
    """One LM step at full width, batch 2, T=128, card vs CPU, TF32 off."""
    import numpy as np
    print(_tf32(False) + f" (LM parity phase, {n_head} heads)")
    sym, params, batch = _lm_parity_start(mx, n_head)
    t0 = time.perf_counter()
    cpu = _lm_step(mx, sym, params, mx.cpu(), batch)
    t_cpu = time.perf_counter() - t0
    gpu = _lm_step(mx, sym, params, mx.gpu(0), batch)
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    label = batch.label[0].asnumpy().astype(np.int64)
    rows = np.arange(len(label))
    loss = [float(-np.log(p[rows, label] + 1e-8).mean()) for p in (gpu[0],
                                                                   cpu[0])]
    worst_g, worst_w = (-1.0, None), (-1.0, None)
    for k, g in cpu[1].items():
        ratio = float(np.abs(gpu[1][k] - g).max()) / \
            (GRAD_RTOL * float(np.abs(g).max()) + 1e-12)
        worst_g = max(worst_g, (ratio, k))
        d = float(np.abs(gpu[2][k] - cpu[2][k]).max())
        worst_w = max(worst_w, (d, k))
    print(f"lm parity ({n_head} heads): one step at batch "
          f"{LM_PARITY_BATCH}, T="
          f"{LM_PARITY_SEQ} (CPU step {t_cpu:.1f} s): loss card "
          f"{loss[0]:.7f} cpu {loss[1]:.7f}; max |prob card - cpu| = "
          f"{prob_err:.3g} (limit {FWD_TOL}); worst gradient "
          f"{worst_g[1]}: {worst_g[0]:.3g} of its limit ({GRAD_RTOL} x its "
          f"max |g|); worst weight {worst_w[1]}: |card - cpu| = "
          f"{worst_w[0]:.3g} (limit {LM_WEIGHT_TOL}); "
          f"{len(cpu[1])} gradients")
    if not (prob_err <= FWD_TOL and abs(loss[0] - loss[1]) <= FWD_TOL
            and worst_g[0] <= 1.0 and worst_w[0] <= LM_WEIGHT_TOL):
        raise AssertionError("card and CPU LM steps disagree")


class _PacedClock:
    """Real time for ``run_scripted``: ``now`` reads the monotonic clock
    and ``advance`` sleeps, so the scripted arrivals land at real
    instants and the latencies count the card's work. The script submits
    and dispatches on one thread, so an arrival due while a dispatch runs
    waits for it."""

    def now(self):
        return time.monotonic()

    def advance(self, seconds):
        time.sleep(max(0.0, seconds))
        return self.now()


def _unload(ck, names):
    """Forget the loaded libraries of kernels ``names`` and of their
    routes (the decode read's per-type and general-route libraries; the
    built files stay), so that their next launch loads them again and
    counts in ``ck.libraries_loaded()``."""
    names = {ck._library(n) for n in names} | {
        ck._library(kernel) for kernel, wrapper in ck._ROUTES.values()
        if wrapper in names}
    for name in names:
        ck._libs.pop(name, None)
    for key in [k for k in ck._fns
                if ck._library(ck._WRAPPER_KERNEL[k[0]]) in names]:
        del ck._fns[key]


def _centered_log(prob):
    """Each row of log(prob) less its mean: log-softmax is the logits less
    one constant per row, so these are the logits less their row mean."""
    import numpy as np
    z = np.log(np.maximum(prob.astype(np.float64), 1e-300))
    return z - z.mean(axis=1, keepdims=True)


def _quant_request(i, rng):
    """Request i of the scripted mix: 1-3 rows (1 + i % 3), numpy-seeded."""
    import numpy as np
    return {"data": rng.rand(1 + i % 3, *TRAIN_IMAGE).astype(np.float32)}


def _serve_ladder(mx, ck, mod, name, kernels, **serve_kw):
    """Serve ``mod`` through mx.serve.serve at ladder QUANT_RUNGS on a
    real clock and answer QUANT_REQS scripted requests of 1-3 rows, one
    every QUANT_GAP_S. The libraries of ``kernels`` are unloaded first
    (phase 2 loaded every library), so that the ladder's warmup must load
    them again and a zero ``compiles_since_warmup`` after it means warmup
    ran them. Returns (server, libraries loaded by warmup, forwards run
    (warmup's 2 per rung included), {kernel: launches}, outputs)."""
    import numpy as np
    _unload(ck, kernels)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    server = mx.serve.serve(mod, name=name, ladder=QUANT_RUNGS,
                            clock=_PacedClock(), start=False, **serve_kw)
    warm_s = time.perf_counter() - t0
    warm_loads = server.engine(name).warmup_compiles
    handles, submit = [], server.submit

    def keep(*a, **k):
        handles.append(submit(*a, **k))
        return handles[-1]
    server.submit = keep        # run_scripted's submits, kept
    now = server._clock.now()
    summary = mx.serve.run_scripted(
        server, [now + i * QUANT_GAP_S for i in range(QUANT_REQS)],
        _quant_request)
    server.submit = submit
    counts = ck.launch_counts()
    stats = server.stats()
    m = stats["models"][name]
    forwards = 2 * len(QUANT_RUNGS) + m["dispatches"]
    ran = {k: counts[k] for k in kernels}
    print(f"serve {name}: bound + warmed in {warm_s:.2f} s; "
          f"{summary['completed']} of {summary['offered']} requests, "
          f"{summary['req_per_sec']} req/s, latency ms p50 "
          f"{summary['latency_ms']['p50']} p99 "
          f"{summary['latency_ms']['p99']}; {m['dispatches']} dispatches"
          f", batch_occupancy {m['batch_occupancy']}, padding_waste_pct "
          f"{m['padding_waste_pct']}, kernel libraries loaded by "
          f"warmup {warm_loads}, compiles_since_warmup "
          f"{stats['compiles_since_warmup']}; exec_est_ms "
          f"{m['exec_est_ms']}; launches {ran} over {forwards} forwards "
          "(warmup included)")
    if stats["compiles_since_warmup"] != 0:
        raise AssertionError(f"{name}: kernels built after warmup")
    if summary["completed"] != QUANT_REQS or summary["errors"]:
        raise AssertionError(f"{name}: {summary}")
    outs = [h.result(timeout=0)[0].asnumpy() for h in handles]
    for i, o in enumerate(outs):
        if o.shape != (1 + i % 3, TRAIN_CLASSES) or not np.isfinite(o).all():
            raise AssertionError(f"{name}: request {i} answered {o.shape}, "
                                 f"finite {np.isfinite(o).all()}")
    return server, warm_loads, forwards, ran, outs


def phase_quant_serve(mx, ck):
    """ResNet-50 (1000 classes, 3x224x224, Xavier seed 0) bound on gpu(0)
    and served through mx.serve.serve at ladder QUANT_RUNGS three times:
    float32, int8, fp8. Each serves QUANT_REQS scripted requests of 1-3
    rows, one every QUANT_GAP_S. Returns (the module, the quantized
    kernels' launches over the int8 and fp8 runs, {tier: server}, the
    float32 ladder's outputs)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import quant
    print(_tf32(True) + " (PyTorch's default, for the quantized-serving "
          "phase)")
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    rung = QUANT_RUNGS[-1]
    mod.bind([("data", (rung,) + TRAIN_IMAGE)], [("softmax_label", (rung,))],
             for_training=False)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    ops = [n.op for n in mod._symbol._topo_nodes() if not n.is_variable]
    # one prologue launch a forward over every conv weight; no conv
    # dequantizes its own
    per_fwd = {"dequant_rows_multi": 1, "dequant_rows": 0,
               "qfc_matmul": ops.count("FullyConnected")}
    kernels = QUANT_KERNELS + ("dequant_rows",)
    libs = len({ck._library(k) for k in kernels})
    outs, launches, servers = {}, dict.fromkeys(QUANT_KERNELS, 0), {}
    for tier in (None, "int8", "fp8"):
        name = tier or "float32"
        server, warm_loads, forwards, ran, outs[name] = _serve_ladder(
            mx, ck, mod, name, kernels, compute_dtype=tier)
        if warm_loads != (libs if tier else 0):
            raise AssertionError(f"{name}: warmup loaded {warm_loads} "
                                 "kernel libraries")
        for k in kernels:
            want = per_fwd[k] * forwards if tier else 0
            if ran[k] != want:
                raise AssertionError(f"{name}: {k} launched {ran[k]} "
                                     f"times, want {want}")
            if k in launches:
                launches[k] += ran[k]
        servers[name] = server
    for tier, tol in (("int8", quant.INT8_TOL), ("fp8", quant.FP8_TOL)):
        worst = max(float(np.abs(q - f).max())
                    for q, f in zip(outs[tier], outs["float32"]))
        zq, zf = (_centered_log(np.concatenate(outs[k]))
                  for k in (tier, "float32"))
        print(f"quant serve {tier}: max |prob - float32 ladder's| = "
              f"{worst:.3g} (tolerance {tol}); centered logits "
              f"{float(np.abs(zq - zf).max()) / float(np.abs(zf).max()):.3g}"
              " of the float32 ladder's largest apart (not gated)")
        if not all(np.allclose(q, f, **tol)
                   for q, f in zip(outs[tier], outs["float32"])):
            raise AssertionError(f"{tier} outputs leave {tol} of the float "
                                 "ladder's")
    launches["dequant_rows"] = _imperative_qconv(mx, ck, mod)
    return mod, launches, servers, outs["float32"]


def _imperative_qconv(mx, ck, mod):
    """The imperative path of a quantized convolution: for each of the int8
    rewrite's QuantizedConvolution nodes, one ``mx.nd.QuantizedConvolution``
    call on the card at batch 1 and 14 x 14 (its own weight's dequant:
    the single-array kernel; no executor, so no prologue), held to the
    convolution of its plain dequant (the same float32 weight bit for
    bit, so the same cuDNN call: within 1e-5 of the largest output),
    TF32 off. Returns its ``dequant_rows`` launches (one a call, and no
    ``dequant_rows_multi``)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import quant
    from mxnet_tpu_torch.ops.nn import _convolution
    print(_tf32(False) + " (imperative quantized convolutions)")
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    qsym, qargs = quant.quantize_symbol(mod._symbol, args, dtype="int8")
    rs = np.random.RandomState(SEED + 8)

    def card(a):
        return mx.nd.NDArray(torch.as_tensor(a).to("cuda"), ctx=mx.gpu(0))
    ck.reset_launch_counts()
    worst, n = 0.0, 0
    for node in qsym._topo_nodes():
        if node.op != "QuantizedConvolution":
            continue
        w, sc = (card(qargs[inp.name].astorch())
                 for inp, _ in node.inputs[1:3])
        groups = int(node.attrs.get("num_group", 1))
        x = card(rs.rand(1, w.shape[1] * groups, 14, 14).astype(np.float32))
        ins = [x, w, sc] + [card(qargs[inp.name].astorch())
                            for inp, _ in node.inputs[3:]]
        got = mx.nd.QuantizedConvolution(*ins, **node.attrs).astorch()
        wf = ck.dequant_rows_plain(w.astorch(), sc.astorch())
        want = _convolution(node.attrs, x.astorch(), wf,
                            ins[3].astorch() if len(ins) > 3 else None)
        worst = max(worst, _max_err(got, want) /
                    max(float(want.abs().max()), 1e-30))
        n += 1
    counts = ck.launch_counts()
    print(f"quant imperative: {n} mx.nd.QuantizedConvolution calls, "
          f"launches dequant_rows {counts['dequant_rows']} "
          f"dequant_rows_multi {counts['dequant_rows_multi']}; worst "
          f"|out - conv of the plain dequant| {worst:.3g} of the largest "
          "output (limit 1e-5)")
    if counts["dequant_rows"] != n or counts["dequant_rows_multi"] != 0 \
            or not worst <= 1e-5:
        raise AssertionError("the imperative quantized convolutions")
    return counts["dequant_rows"]


def phase_quant_parity(mx, mod, servers):
    """One int8 and one fp8 quantized ResNet-50 forward at batch 2, TF32
    off: on the card through the engine that phase 12 served (its
    rewritten graph and kernels), against a CPU Module of the same
    rewrite from the same parameters. The random model's probabilities
    all lie near 1/1000, so beside them the logits the softmax saw are
    held, relative to their largest magnitude (``_centered_log``)."""
    import numpy as np
    from mxnet_tpu_torch.ops import quant
    print(_tf32(False) + " (quantized parity phase)")
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    X = _images(2, SEED + 6)[0]
    for tier in ("int8", "fp8"):
        card = servers[tier].engine(tier).forward(len(X), {"data": X})
        qsym, qargs = quant.quantize_symbol(mod._symbol, args, dtype=tier)
        m = mx.mod.Module(qsym, context=mx.cpu())
        m.bind([("data", X.shape)], [("softmax_label", (len(X),))],
               for_training=False)
        m.init_params(arg_params=qargs, aux_params=auxs)
        m.forward(mx.io.DataBatch([X], None), is_train=False)
        prob = [card[0].asnumpy(), m.get_outputs()[0].asnumpy()]
        err = float(np.abs(prob[0] - prob[1]).max())
        z = [_centered_log(p) for p in prob]
        z_err = float(np.abs(z[0] - z[1]).max()) / float(np.abs(z[1]).max())
        top = [p.argmax(1).tolist() for p in prob]
        print(f"quant parity {tier}: batch 2 through the served engine, "
              f"max |prob card - cpu| = {err:.3g} (limit "
              f"{QUANT_PARITY_TOL}); centered logits {z_err:.3g} of their "
              f"largest magnitude {float(np.abs(z[1]).max()):.4g} apart "
              f"(limit {QUANT_LOGIT_RTOL}); top-1 card {top[0]} cpu "
              f"{top[1]}; max prob {float(prob[1].max()):.4g}")
        if not (err <= QUANT_PARITY_TOL and z_err <= QUANT_LOGIT_RTOL
                and top[0] == top[1]):
            raise AssertionError(f"{tier}: card and CPU quantized forwards "
                                 "disagree")


def phase_quant_half(mx, ck, mod):
    """ResNet-50 quantized to int8 (phase 12's parameters) through
    ``Module(quantize_symbol(...), compute_dtype=...)`` on gpu(0), in
    bfloat16 and in float16: one rung-8 forward each, which launches
    exactly one 16-bit matmul instance (``qfc_matmul_bf16`` /
    ``qfc_matmul_f16``), 1 ``dequant_rows_multi`` (the conv prologue's,
    the int8 weights' scales widened from the compute dtype) and the
    head's 16-bit softmax, and nothing else, and
    answers in the compute dtype. Then a batch-2 forward of the same on the
    card and on the CPU in the compute dtype, beside the CPU's float32
    quantized forward, TF32 off: the card's centered logits within
    BF16_SPREAD times the CPU's own 16-bit-vs-float32 distance. Returns
    {counter: launches}."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import quant
    print(_tf32(False) + " (quantized half-precision phase)")
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    qsym, qargs = quant.quantize_symbol(mod._symbol, args, dtype="int8")
    rung = QUANT_RUNGS[-1]
    X8, X2 = _images(rung, SEED + 7)[0], _images(2, SEED + 6)[0]

    def forward(ctx, X, cd):
        m = mx.mod.Module(qsym, context=ctx, compute_dtype=cd)
        m.bind([("data", X.shape)], [("softmax_label", (len(X),))],
               for_training=False)
        m.init_params(arg_params=qargs, aux_params=auxs)
        m.forward(mx.io.DataBatch([X], None), is_train=False)
        return m.get_outputs()[0]
    launches = {"dequant_rows_multi": 0}
    z32 = _centered_log(forward(mx.cpu(), X2, None).asnumpy())
    for half, sfx in HALF_SFX.items():
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        out = forward(mx.gpu(0), X8, half)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        want = {"qfc_matmul_" + sfx: 1, "dequant_rows_multi": 1,
                "softmax_" + sfx: 1}
        print(f"quant {sfx}: int8 ResNet-50 under compute_dtype={half}, "
              f"rung {rung} forward (bind included) {wall:.3f} s, launches "
              f"{counts}, output {out.astorch().dtype}")
        if counts != want or out.astorch().dtype != getattr(torch, half):
            raise AssertionError(f"quant {sfx}: launches {counts}, want "
                                 f"{want}; output {out.astorch().dtype}")
        launches["qfc_matmul_" + sfx] = counts["qfc_matmul_" + sfx]
        launches["dequant_rows_multi"] += counts["dequant_rows_multi"]
        z = [_centered_log(forward(ctx, X2, half).asnumpy()
                           .astype(np.float32))
             for ctx in (mx.gpu(0), mx.cpu())]
        d = float(np.abs(z[0] - z[1]).max())
        own = float(np.abs(z[1] - z32).max())
        print(f"quant {sfx} parity: batch 2, centered logits card vs CPU "
              f"{d:.4g}, CPU {half} vs float32 {own:.4g} (limit "
              f"{BF16_SPREAD} x)")
        if not (np.isfinite(z[0]).all() and d <= BF16_SPREAD * own):
            raise AssertionError(f"quant {sfx}: card and CPU disagree "
                                 f"beyond {half}'s own spread")
    return launches


def _quant_group(key):
    # the dequant-fused matmul's two routes: qfc_gemv and qfc_matmul_f32
    for name, group in (("dequant_rows", "dequant_rows"),
                        ("qfc_matmul", "qfc_matmul"),
                        ("qfc_gemv", "qfc_matmul")):
        if name in key:
            return f"{group} kernel"
    if "softmax_rows_" in key:
        return "softmax kernel"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "at::native" in key:
        return "PyTorch elementwise/reduction"
    return "cuDNN/cuBLAS"


def phase_quant_profile(servers, steps=8):
    """Where a rung-8 dispatch goes, per tier: ``steps`` full-rung
    submits, each dispatched at once by pump(). The three ladders' wall
    per dispatch is taken in turns (float32, int8, fp8, fp8, int8,
    float32) without the profiler; then each ladder's device time under
    it, with int8's split by kernel group."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    print(_tf32(True))
    rung = QUANT_RUNGS[-1]
    X = np.random.RandomState(SEED + 7).rand(rung, *TRAIN_IMAGE) \
        .astype(np.float32)

    def dispatch(server):
        h = server.submit({"data": X})
        if server.pump() != 1:
            raise AssertionError("a full-rung request did not dispatch")
        h.result(timeout=0)

    def wall_ms(server):
        t0 = time.perf_counter()
        for _ in range(steps):
            dispatch(server)
        return (time.perf_counter() - t0) * 1e3 / steps
    for server in servers.values():
        dispatch(server)
    turns = [(name, wall_ms(servers[name])) for name in
             ("float32", "int8", "fp8", "fp8", "int8", "float32")]
    print(f"quant turns, {steps} rung-{rung} dispatches each, wall "
          "ms/dispatch: " + ", ".join(f"{n} {ms:.3f}" for n, ms in turns))
    for name, server in servers.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                dispatch(server)
            wall = (time.perf_counter() - t0) * 1e3 / steps
        rows = [(_self_device_us(e), e.count, e.key)
                for e in prof.key_averages() if _self_device_us(e) > 0]
        busy_ms = sum(r[0] for r in rows) / 1e3 / steps
        print(f"quant profile: {name} rung {rung}, {steps} dispatches: "
              f"wall {wall:.3f} ms/dispatch, device busy {busy_ms:.3f} "
              f"ms/dispatch ({100 * busy_ms / wall:.1f}% of wall), "
              f"{sum(r[1] for r in rows) / steps:.1f} kernel launches per "
              "forward")
        if name != "int8":
            continue
        groups = {}
        for us, count, key in rows:
            g = _quant_group(key)
            t, c = groups.get(g, (0.0, 0))
            groups[g] = (t + us, c + count)
        for g, (us, count) in sorted(groups.items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"  group {g}: {us / 1e3 / steps:.4f} ms/dispatch "
                  f"({100 * us / 1e3 / steps / busy_ms:.1f}% of device "
                  f"time), {count / steps:.1f} launches/dispatch")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            print(f"  {us / 1e3 / steps:9.4f} ms/dispatch  "
                  f"{count / steps:6.1f} launches/dispatch  {key[:90]}")


def _sign_test_p(k, n):
    """Two-sided sign test: the chance of a split at least as uneven as
    ``k`` of ``n`` when each side is equally likely."""
    from math import comb
    tail = sum(comb(n, i) for i in range(min(k, n - k) + 1)) / 2 ** n
    return min(1.0, 2 * tail)


def phase_quant_hoist(mx, ck, mod):
    """The conv prologue on an int8 rung-8 ResNet-50 forward (phase 12's
    parameters), TF32 on: the rewritten graph bound as the executor binds
    it (one ``dequant_rows_multi`` launch over the 53 conv weights before
    the nodes) and bound with QuantizedConvolution's prologue taken off
    (each conv dequantizes its own weight, a ``dequant_rows`` launch a
    conv: the path before the prologue). The two arms' outputs must agree
    bit for bit; then QUANT_AB_TURNS turns of QUANT_AB_FORWARDS
    synchronized forwards each, in turns: wall ms per forward (the host's
    dispatch included), launches per forward, and the peak of
    ``torch.cuda.max_memory_allocated`` during one forward above what was
    allocated before it (every float32 conv weight lives until the
    forward ends in the prologue arm: ~94 MB; one at a time in the
    other). The per-turn differences' median and a two-sided sign test
    say whether the wall difference is resolved."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import quant
    from mxnet_tpu_torch.ops.registry import get_op
    print(_tf32(True) + " (quantized prologue A/B)")
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    qsym, qargs = quant.quantize_symbol(mod._symbol, args, dtype="int8")
    rung = QUANT_RUNGS[-1]
    batch = mx.io.DataBatch([_images(rung, SEED + 7)[0]], None)
    op = get_op("QuantizedConvolution")
    mods = {}
    for arm in ("prologue", "per conv"):
        saved = op.prologue
        if arm == "per conv":
            op.prologue = None      # read once, when the executor binds
        try:
            m = mx.mod.Module(qsym, context=mx.gpu(0))
            m.bind([("data", (rung,) + TRAIN_IMAGE)],
                   [("softmax_label", (rung,))], for_training=False)
            m.init_params(arg_params=qargs, aux_params=auxs)
        finally:
            op.prologue = saved
        mods[arm] = m

    def forward(m):
        m.forward(batch, is_train=False)
        return m.get_outputs()[0].astorch()
    outs, peaks, counts = {}, {}, {}
    for arm, m in mods.items():
        forward(m)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[arm] = forward(m)
        torch.cuda.synchronize()
        peaks[arm] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        counts[arm] = {k: v for k, v in ck.launch_counts().items()
                       if v and k.startswith("dequant")}
    if not torch.equal(outs["prologue"], outs["per conv"]):
        raise AssertionError("the conv prologue changed the int8 forward's "
                             "output")
    if counts["prologue"] != {"dequant_rows_multi": 1} or \
            counts["per conv"] != {"dequant_rows": 53}:
        raise AssertionError(f"launches a forward: {counts}")
    walls = {arm: [] for arm in mods}
    for turn in range(QUANT_AB_TURNS):
        order = list(mods) if turn % 2 == 0 else list(mods)[::-1]
        for arm in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(QUANT_AB_FORWARDS):
                forward(mods[arm])
            torch.cuda.synchronize()
            walls[arm].append((time.perf_counter() - t0) * 1e3 /
                              QUANT_AB_FORWARDS)
    for arm in mods:
        print(f"quant prologue A/B {arm}: int8 rung-{rung} forward wall "
              f"ms {' / '.join(f'{w:.3f}' for w in walls[arm])} (median "
              f"{np.median(walls[arm]):.3f}); launches "
              f"{counts[arm]}; peak memory above the bound state "
              f"{peaks[arm]:.1f} MiB")
    diffs = np.subtract(walls["per conv"], walls["prologue"])
    faster = int((diffs > 0).sum())
    p = _sign_test_p(faster, len(diffs))
    print(f"quant prologue A/B: per conv - prologue, paired by turn: median "
          f"{np.median(diffs):.3f} ms a forward (quartiles "
          f"{np.percentile(diffs, 25):.3f} / {np.percentile(diffs, 75):.3f}"
          f"); the prologue faster in {faster} of {len(diffs)} turns, sign "
          f"test p = {p:.4f}: "
          f"{'resolved' if p < 0.05 else 'not resolved'}")
    del mods
    torch.cuda.empty_cache()


def phase_fused_train(mx, ck):
    """The fused ResNet-50 through Module.fit on gpu(0): phase 5's data,
    Xavier seed and SGD, batch 32, 8 batches, telemetry on. Returns the
    fit's launch counts."""
    import torch
    print(_tf32(True) + " (PyTorch's default, for the fused training "
          "phase)")
    X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(_fused50(mx), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    counts, per_step = _fit_phase(
        mx, ck, mod, it, "fused train", TRAIN_BATCH, "img",
        ("conv0_weight", "conv0_gamma", "stage4_unit3_conv2_beta",
         "fc1_weight"), optimizer_params=SGD)
    n_cbr = sum(n.op == "FusedConvBNReLU" for n in mod.symbol._topo_nodes())
    n_params = len(mod.get_params()[0])
    want = dict.fromkeys(counts, 0)
    want.update(bn_stats=n_cbr, bn_apply_relu=n_cbr, softmax=1,
                softmax_ce_bwd=1, sgd_mom_multi=1)
    print(f"fused train: want per step {n_cbr} bn_stats and "
          f"bn_apply_relu, 1 softmax, 1 softmax_ce_bwd, 1 sgd_mom_multi "
          f"(all {n_params} parameter arrays), nothing else")
    if per_step != want:
        raise AssertionError(f"fused launches per step {per_step}, want "
                             f"{want}")
    return counts


@contextlib.contextmanager
def _cuda_variant_on_cpu(mx):
    """FusedConvBNReLU's CPU forward replaced by its CUDA variant (the
    autograd.Function, whose kernels are their plain halves on CPU
    tensors), so the CPU side computes what the card does: the one-pass
    variance forward, the plain recompute backward."""
    op = mx.ops.get_op("FusedConvBNReLU")
    plain = op.forward
    op.forward = op.variants["cuda"]["fn"]
    try:
        yield
    finally:
        op.forward = plain


def phase_fused_parity(mx, ck):
    """Phase 6 for the fused net, from phase 6's parameters renamed: one
    step at batch 2, card vs CPU (the CUDA variant's Function on CPU
    tensors), TF32 off; then the fused and plain nets' inference forward
    on the card."""
    import numpy as np
    print(_tf32(False) + " (fused parity phase)")
    p_args, p_auxs, X, y = _resnet50_start(mx, 2)
    args, auxs = _renamed(p_args), _renamed(p_auxs)
    ck.reset_launch_counts()
    _step_parity(mx, _fused50(mx), args, auxs, X, y, "fused parity",
                 cpu_scope=lambda: _cuda_variant_on_cpu(mx))
    ran = {k: ck.launch_counts()[k] for k in CBR_KERNELS}
    print(f"fused parity: the card's step launched {ran}")
    if not all(ran.values()):
        raise AssertionError("the fused step ran without its kernels")
    # Xavier leaves every BatchNorm at mean 0, variance 1, gamma 1, beta
    # 0, where the two nets' arithmetic coincides bit for bit: the
    # inference forwards are compared from statistics and affine
    # parameters drawn at random instead
    rs = np.random.RandomState(SEED + 9)
    p_args = {k: ((1 + 0.2 * rs.randn(*v.shape)) if k.endswith("_gamma")
                  else 0.2 * rs.randn(*v.shape) if k.endswith("_beta")
                  else v).astype(np.float32) for k, v in p_args.items()}
    p_auxs = {k: (0.2 * rs.randn(*v.shape) if k.endswith("_mean")
                  else 1 + 0.5 * rs.rand(*v.shape)).astype(np.float32)
              for k, v in p_auxs.items()}
    probs = []
    for s, a, x in ((_fused50(mx), _renamed(p_args), _renamed(p_auxs)),
                    (_resnet50(mx), p_args, p_auxs)):
        m = mx.mod.Module(s, context=mx.gpu(0))
        m.bind([("data", X.shape)], [("softmax_label", y.shape)],
               for_training=False)
        m.init_params(arg_params=mx.convert.params_from_numpy(a, mx.gpu(0)),
                      aux_params=mx.convert.params_from_numpy(x, mx.gpu(0)))
        m.forward(mx.io.DataBatch([X], None), is_train=False)
        probs.append(m.get_outputs()[0].asnumpy())
    err = float(np.abs(probs[0] - probs[1]).max())
    z = [_centered_log(p) for p in probs]
    z_err = float(np.abs(z[0] - z[1]).max()) / float(np.abs(z[1]).max())
    print(f"fused parity: inference forward on the card, fused vs plain "
          f"from renamed parameters with random BatchNorm statistics and "
          f"affine: max |prob| difference {err:.3g} (limit {FUSED_TOL}); "
          f"centered logits {z_err:.3g} of their largest magnitude "
          f"{float(np.abs(z[1]).max()):.4g} apart (not gated); max prob "
          f"{float(probs[1].max()):.4g}")
    if not err <= FUSED_TOL:
        raise AssertionError("fused and plain inference forwards disagree")


def phase_fused_serve(mx, ck, plain_mod, plain_outs):
    """The fused ResNet-50 served through mx.serve.serve at ladder
    QUANT_RUNGS with phase 12's scripted requests, from phase 12's
    parameters renamed; its outputs against the float32 ladder's. Returns
    (the fused kernels' launches, the server)."""
    import numpy as np
    print(_tf32(True) + " (fused serving phase)")
    rung = QUANT_RUNGS[-1]
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in plain_mod.get_params())
    mod = mx.mod.Module(_fused50(mx), context=mx.gpu(0))
    mod.bind([("data", (rung,) + TRAIN_IMAGE)], [("softmax_label", (rung,))],
             for_training=False)
    mod.init_params(
        arg_params=mx.convert.params_from_numpy(_renamed(args), mx.gpu(0)),
        aux_params=mx.convert.params_from_numpy(_renamed(auxs), mx.gpu(0)))
    n_cbr = sum(n.op == "FusedConvBNReLU" for n in mod.symbol._topo_nodes())
    server, warm_loads, forwards, ran, outs = _serve_ladder(
        mx, ck, mod, "fused", CBR_KERNELS)
    if warm_loads != 1:
        raise AssertionError(f"fused serve: warmup loaded {warm_loads} "
                             "libraries, want bn_apply_relu's")
    if ran != {"bn_stats": 0, "bn_apply_relu": n_cbr * forwards}:
        raise AssertionError(f"fused serve: launches {ran}, want 0 "
                             f"bn_stats and {n_cbr} bn_apply_relu per "
                             "forward")
    worst = max(float(np.abs(o - p).max()) for o, p in zip(outs, plain_outs))
    print(f"fused serve: max |prob - float32 ladder's| = {worst:.3g} "
          f"(limit {FUSED_TOL})")
    if not worst <= FUSED_TOL:
        raise AssertionError("fused and plain ladders disagree")
    return ran, server


def _cbr_group(key):
    if "bn_stats_" in key or "bn_apply_relu_" in key:
        return "bn_stats + bn_apply_relu"
    if any(k in key for k in _PORT_KERNELS):
        return "other port kernels"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "at::native" in key:
        return "PyTorch elementwise/reduction"
    return "cuDNN/cuBLAS"


def _profiled(fn, steps, group=None):
    """(wall ms per call, device-busy ms per call, launches per call,
    {group: (ms per call, launches per call)}) of ``steps`` calls, the
    kernels grouped by ``group`` (default ``_cbr_group``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    group = group or _cbr_group
    groups = {}
    for e in prof.key_averages():
        us = _self_device_us(e)
        if us > 0:
            t, c = groups.get(group(e.key), (0.0, 0))
            groups[group(e.key)] = (t + us / 1e3 / steps,
                                    c + e.count / steps)
    busy = sum(t for t, _ in groups.values())
    return wall, busy, sum(c for _, c in groups.values()), groups


def phase_fused_profile(mx, fused_server, plain_server, steps=2):
    """Fused vs plain ResNet-50 under the profiler: training steps at
    batch 32 in turns (plain, fused, fused, plain; ``steps`` each, so 4
    per net), then ``steps`` fused steps with the moving statistics' zero
    cotangents filled again (FusedConvBNReLU's Function before it stopped
    materializing them), then 8 rung-8 dispatches of each ladder. Device
    busy, launches, and device time by group."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    print(_tf32(True) + " (fused profile phase)")
    X, y = _images(TRAIN_BATCH, SEED + 8)
    batch = mx.io.DataBatch([X], [y])
    mods = {}
    for name, sym in (("plain", _resnet50(mx)), ("fused", _fused50(mx))):
        m = mx.mod.Module(sym, context=mx.gpu(0))
        m.bind([("data", X.shape)], [("softmax_label", y.shape)])
        m.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        m.init_optimizer(optimizer_params=SGD)
        mods[name] = m

    def step(m):
        m.forward_backward(batch)
        m.update()
    runs = {"plain": [], "fused": []}
    for name in ("plain", "fused", "fused", "plain"):
        runs[name].append(_profiled(lambda m=mods[name]: step(m), steps))
    keep = ck._ConvBNReLUFn.__dict__["forward"]

    def filled(ctx, *args):
        out = keep.__func__(ctx, *args)
        ctx.set_materialize_grads(True)
        return out
    ck._ConvBNReLUFn.forward = staticmethod(filled)
    try:
        runs["fused, zero cotangents filled"] = [
            _profiled(lambda: step(mods["fused"]), steps)]
    finally:
        ck._ConvBNReLUFn.forward = keep
    Xs = np.random.RandomState(SEED + 7).rand(QUANT_RUNGS[-1], *TRAIN_IMAGE) \
        .astype(np.float32)

    def dispatch(server):
        h = server.submit({"data": Xs})
        if server.pump() != 1:
            raise AssertionError("a full-rung request did not dispatch")
        h.result(timeout=0)
    for name, server in (("plain", plain_server), ("fused", fused_server)):
        runs[name + " serve"] = [_profiled(lambda s=server: dispatch(s), 8)]
    _print_profiles("fused profile", runs, steps)


def _print_profiles(label, runs, steps):
    """Print ``_profiled`` readings: {name: [readings]}, "serve" names
    over 8 dispatches each, the others over ``steps`` training steps."""
    for name, rr in runs.items():
        n = len(rr)
        wall = sum(r[0] for r in rr) / n
        busy = sum(r[1] for r in rr) / n
        launches = sum(r[2] for r in rr) / n
        unit = "dispatch" if "serve" in name else "step"
        print(f"{label}: {name}, {n * (8 if 'serve' in name else steps)}"
              f" {unit}s: wall {wall:.2f} ms/{unit}, device busy {busy:.3f} "
              f"ms/{unit} ({100 * busy / wall:.1f}% of wall), "
              f"{launches:.1f} kernel launches per {unit}")
        groups = {}
        for r in rr:
            for g, (t, c) in r[3].items():
                t0, c0 = groups.get(g, (0.0, 0.0))
                groups[g] = (t0 + t / n, c0 + c / n)
        for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  group {g}: {t:.3f} ms/{unit} ({100 * t / busy:.1f}% "
                  f"of device time), {c:.1f} launches/{unit}")


# --------------------------------------------------------------------------
# phases 24-27: ResNet-50 in bfloat16 mixed precision (compute_dtype)
# --------------------------------------------------------------------------
def _bf16_cells(label, mod):
    """Every bound cell of ``mod`` (master weights, gradients, moving
    statistics) is still float32 under compute_dtype."""
    import torch
    exe = mod._exec_group.executor
    got = {v.astorch().dtype for d in (exe.arg_dict, exe.aux_dict,
                                       exe.grad_dict) for k, v in d.items()
           if k not in ("data", "softmax_label")}
    print(f"{label}: bound cells {sorted(map(str, got))}")
    if got != {torch.float32}:
        raise AssertionError(f"{label}: cells left float32: {got}")


def phase_bf16_train(mx, ck, half="bfloat16"):
    """ResNet-50, plain and fused, through Module(compute_dtype=half)
    .fit on gpu(0): phase 5's data, Xavier seed and SGD, batch 32, 8
    batches, telemetry on. Exactly the bfloat16 instances launch (1
    softmax + 1 CE gradient, and for the fused net 33 + 33 BatchNorm
    kernels) beside 1 float32 sgd_mom_multi per step (all 157 arrays),
    and nothing else.
    Returns ({net: launch counts}, {net: module})."""
    sfx = HALF_SFX[half]
    import torch
    print(_tf32(True) + f" (PyTorch's default; cuDNN's {half} "
          "convolutions do not read it)")
    counts, mods = {}, {}
    for net, build in (("plain", _resnet50), ("fused", _fused50)):
        X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
        it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
        mod = mx.mod.Module(build(mx), context=mx.gpu(0),
                            compute_dtype=half)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        label = f"{sfx} {net} train"
        counts[net], per_step = _fit_phase(
            mx, ck, mod, it, label, TRAIN_BATCH, "img",
            ("conv0_weight", "fc1_weight"), optimizer_params=SGD)
        n_cbr = sum(n.op == "FusedConvBNReLU"
                    for n in mod.symbol._topo_nodes())
        want = dict.fromkeys(per_step, 0)
        want.update({"softmax_" + sfx: 1, "softmax_ce_bwd_" + sfx: 1,
                     "sgd_mom_multi": 1})
        if n_cbr:
            want.update({"bn_stats_" + sfx: n_cbr,
                         "bn_apply_relu_" + sfx: n_cbr})
        print(f"{label}: want per step "
              f"{ {k: v for k, v in want.items() if v} }, nothing else")
        if per_step != want:
            raise AssertionError(f"{label}: launches per step {per_step}")
        _bf16_cells(label, mod)
        mods[net] = (mod, it)
    return counts, mods


def _bf16_forward(mx, sym, args, auxs, ctx, X, y, cd, is_train):
    """One forward of ``sym`` on ``ctx``: (probabilities as float32 numpy,
    the batch's mean cross-entropy)."""
    import numpy as np
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=cd)
    mod.bind([("data", X.shape)], [("softmax_label", y.shape)],
             for_training=is_train)
    mod.init_params(arg_params=mx.convert.params_from_numpy(args, ctx),
                    aux_params=mx.convert.params_from_numpy(auxs, ctx))
    mod.forward(mx.io.DataBatch([X], [y]), is_train=is_train)
    p = mod.get_outputs()[0].asnumpy()
    loss = float(-np.log(np.maximum(p[np.arange(len(y)), y.astype(int)],
                                    1e-30)).mean())
    return p, loss


def phase_bf16_parity(mx, half="bfloat16"):
    """ResNet-50 in bfloat16 at batch 2, card against the port's CPU run
    from the same parameters (phase 6's, with random BatchNorm statistics
    and affine), TF32 off: the inference forward and the first training
    step's forward (its loss). bfloat16 rounds at other places in cuDNN
    and oneDNN, so the card is held to the CPU within BF16_SPREAD times
    the distance between the CPU's own bfloat16 and float32 runs: the
    centered log-probabilities (max abs) and the loss."""
    sfx = HALF_SFX[half]
    import numpy as np
    print(_tf32(False) + f" ({sfx} parity phase)")
    args, auxs, X, y = _resnet50_start(mx, 2)
    rs = np.random.RandomState(SEED + 9)
    args = {k: ((1 + 0.2 * rs.randn(*v.shape)) if k.endswith("_gamma")
                else 0.2 * rs.randn(*v.shape) if k.endswith("_beta")
                else v).astype(np.float32) for k, v in args.items()}
    auxs = {k: (0.2 * rs.randn(*v.shape) if k.endswith("_mean")
                else 1 + 0.5 * rs.rand(*v.shape)).astype(np.float32)
            for k, v in auxs.items()}
    sym = _resnet50(mx)
    for is_train in (False, True):
        t0 = time.perf_counter()
        runs = {k: _bf16_forward(mx, sym, args, auxs, ctx, X, y, cd,
                                 is_train)
                for k, ctx, cd in (("card", mx.gpu(0), half),
                                   ("cpu", mx.cpu(), half),
                                   ("cpu32", mx.cpu(), None))}
        z = {k: _centered_log(p) for k, (p, _) in runs.items()}
        d = float(np.abs(z["card"] - z["cpu"]).max())
        spread = float(np.abs(z["cpu"] - z["cpu32"]).max())
        dl = abs(runs["card"][1] - runs["cpu"][1])
        # the loss's own bfloat16 spread may cancel to nearly 0: the
        # centered log-probs' spread bounds a row's log-prob moves too
        spread_l = max(abs(runs["cpu"][1] - runs["cpu32"][1]), spread)
        mode = "training step's forward" if is_train else "inference"
        print(f"{sfx} parity ({mode}, batch 2, {time.perf_counter() - t0:.1f}"
              f" s): centered log-probs card vs CPU {d:.4g}, CPU {half} "
              f"vs float32 {spread:.4g} (limit {BF16_SPREAD} x); loss card "
              f"{runs['card'][1]:.6f} CPU {runs['cpu'][1]:.6f} float32 "
              f"{runs['cpu32'][1]:.6f} (limit {BF16_SPREAD} x "
              f"{spread_l:.3g}); top-1 card {runs['card'][0].argmax(1)}"
              f" CPU {runs['cpu'][0].argmax(1)}")
        if not (np.isfinite(z["card"]).all() and
                d <= BF16_SPREAD * spread and
                dl <= BF16_SPREAD * spread_l):
            raise AssertionError(f"{sfx} parity ({mode}): card and CPU "
                                 f"disagree beyond {half}'s own spread")


def phase_bf16_serve(mx, ck, plain_mod, plain_outs, half="bfloat16"):
    """ResNet-50, plain and fused, served in bfloat16 through
    mx.serve.serve(compute_dtype=half) at ladder QUANT_RUNGS with
    phase 12's scripted requests and parameters: req/s, p50/p99, nothing
    loaded after warmup, exactly 1 softmax_bf16 (+ 33 bn_apply_relu_bf16
    for the fused net) per forward and no float32 instance, outputs
    within INT8_TOL of the float32 ladder's (bfloat16 keeps 8 significant
    bits, as the int8 tier's weights keep about 8, and rounds the
    activations too), top-1 agreement reported. Returns ({kernel counter:
    launches}, {net: server})."""
    sfx = HALF_SFX[half]
    import numpy as np
    from mxnet_tpu_torch.ops import quant
    print(_tf32(True) + f" ({sfx} serving phase)")
    rung = QUANT_RUNGS[-1]
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in plain_mod.get_params())
    launches, servers = {}, {}
    ref = np.concatenate(plain_outs)
    for net, build, a, x in (("plain", _resnet50, args, auxs),
                             ("fused", _fused50, _renamed(args),
                              _renamed(auxs))):
        mod = mx.mod.Module(build(mx), context=mx.gpu(0))
        mod.bind([("data", (rung,) + TRAIN_IMAGE)],
                 [("softmax_label", (rung,))], for_training=False)
        mod.init_params(arg_params=mx.convert.params_from_numpy(a, mx.gpu(0)),
                        aux_params=mx.convert.params_from_numpy(x, mx.gpu(0)))
        n_cbr = sum(n.op == "FusedConvBNReLU"
                    for n in mod.symbol._topo_nodes())
        libs = ("softmax", "bn_apply_relu") if n_cbr else ("softmax",)
        server, warm_loads, forwards, _, outs = _serve_ladder(
            mx, ck, mod, f"{sfx} {net}", libs, compute_dtype=half)
        counts = ck.launch_counts()
        want = dict.fromkeys(counts, 0)
        want["softmax_" + sfx] = forwards
        if n_cbr:
            want["bn_apply_relu_" + sfx] = n_cbr * forwards
        if warm_loads != len(libs) or counts != want:
            raise AssertionError(f"{sfx} {net} serve: warmup loaded "
                                 f"{warm_loads} libraries (want "
                                 f"{len(libs)}), launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", want {forwards} forwards' worth")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        got = np.concatenate(outs)
        zg, zr = _centered_log(got), _centered_log(ref)
        top1 = float((got.argmax(1) == ref.argmax(1)).mean())
        print(f"{sfx} {net} serve: max |prob - float32 ladder's| = "
              f"{float(np.abs(got - ref).max()):.3g} (tolerance "
              f"{quant.INT8_TOL}); centered logits "
              f"{float(np.abs(zg - zr).max()) / float(np.abs(zr).max()):.3g}"
              f" of the float32 ladder's largest apart; top-1 agreement "
              f"{top1:.3f} over {len(got)} rows (not gated)")
        if not np.allclose(got, ref, **quant.INT8_TOL):
            raise AssertionError(f"{sfx} {net} serve leaves INT8_TOL of the "
                                 "float32 ladder")
        servers[net] = server
    return launches, servers


def phase_bf16_profile(mods, servers, steps=2):
    """bfloat16 ResNet-50 under the profiler: training steps at batch 32,
    plain and fused in turns (plain, fused, fused, plain), and 8 rung-8
    dispatches of each bfloat16 ladder: wall, device busy, launches,
    device time by group."""
    print(_tf32(True) + " (bf16 profile phase)")
    it = mods["plain"][1]
    it.reset()
    batch = next(iter(it))
    runs = {"plain": [], "fused": []}
    for net in ("plain", "fused", "fused", "plain"):
        def step(m=mods[net][0]):
            m.forward_backward(batch)
            m.update()
        runs[net].append(_profiled(step, steps))
    Xs = batch.data[0].asnumpy()[:QUANT_RUNGS[-1]]

    def dispatch(server):
        h = server.submit({"data": Xs})
        if server.pump() != 1:
            raise AssertionError("a full-rung request did not dispatch")
        h.result(timeout=0)
    for net, server in servers.items():
        runs[net + " serve"] = [_profiled(lambda s=server: dispatch(s), 8)]
    _print_profiles("bf16 profile", runs, steps)


# --------------------------------------------------------------------------
# phases 19-24: decode serving's fast paths
# --------------------------------------------------------------------------
def _gen(n_layer=N_LAYER, cache_dtype=None, n_head=N_HEAD):
    """The decode graph at full width as a ``step_len -> Symbol`` factory
    (``serve_decoder``'s ``symbol_gen``)."""
    from mxnet_tpu_torch.models import transformer as tfm
    return lambda s: tfm.get_decode_symbol(
        vocab_size=V, d_model=D, n_layer=n_layer, n_head=n_head,
        capacity=CAP, per_slot=True, step_len=s, cache_dtype=cache_dtype)


def _draft_params(params):
    """The 1-layer draft of the same width: the target's token embedding,
    layer 0 and final LayerNorm (random weights, as the target's)."""
    import re
    return {k: v for k, v in params.items()
            if not re.match(r"lm_l\d+_", k) or k.startswith("lm_l0_")}


def _serve_all(sched, prompts, new, **submit_kw):
    """Submit every prompt at once and pump the scheduler to the end on
    its real clock: (outputs, handles, wall seconds)."""
    t0 = time.perf_counter()
    hs = [sched.submit(p, max_new_tokens=new, **submit_kw) for p in prompts]
    sched.pump()
    wall = time.perf_counter() - t0
    return [h.result(timeout=0).tolist() for h in hs], hs, wall


def _decode_launches(label, counts, dispatches, read="decode_attention",
                     suffix=""):
    """Every dispatch of a served run is one forward: it must have
    launched the gather once, LayerNorm 2L + 1, GeLU L and the cache read
    (``read``) L times — an S=64 window as much as an S=1 step — and
    nothing else; ``suffix`` "_bf16" counts the bfloat16 instances."""
    want = dict.fromkeys(counts, 0)
    want["embedding" + suffix] = dispatches
    want["layernorm" + suffix] = (2 * N_LAYER + 1) * dispatches
    want["bias_gelu" + suffix] = N_LAYER * dispatches
    want[read] = N_LAYER * dispatches
    print(f"{label}: launches {counts} over {dispatches} dispatches")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")


class _CpuRef:
    """The full-width model on the CPU (one slot and an S=64 window), for
    the logits after a stream: phase 3's near-tie rule for tokens on
    which two card runs differ."""

    def __init__(self, mx, params, compute_dtype=None):
        import numpy as np
        from mxnet_tpu_torch.models import transformer as tfm
        gen, ctx = _gen(), mx.cpu()
        base = mx.mod.Module(gen(1), data_names=("data",), label_names=[],
                             context=ctx, compute_dtype=compute_dtype)
        base.bind([mx.io.DataDesc("data", (1, 1), np.int32)], None,
                  for_training=False)
        base.init_params(initializer=None,
                         arg_params=mx.convert.params_from_numpy(params, ctx),
                         aux_params={}, allow_missing=True)
        win = mx.mod.Module(gen(PREFILL_CHUNK), data_names=("data",),
                            label_names=[], context=ctx,
                            compute_dtype=compute_dtype)
        win.bind([mx.io.DataDesc("data", (1, PREFILL_CHUNK), np.int32)],
                 None, for_training=False, shared_module=base)
        self.drv = tfm.BatchedKVCacheDecoder(base, CAP, slots=1)
        self.drv.add_window(PREFILL_CHUNK, win)

    def logits(self, stream):
        """CPU logits of the token after ``stream`` (windows of 64, then
        single tokens)."""
        import numpy as np
        d = self.drv
        d.leave(0)
        d.join(0)
        i = 0
        while len(stream) - i >= PREFILL_CHUNK:
            out = d.step(np.asarray([stream[i:i + PREFILL_CHUNK]]))
            i += PREFILL_CHUNK
        for tok in stream[i:]:
            out = d.step(np.asarray([[tok]]))
        return out.asnumpy()[0, -1]


def _same_or_near_ties(cpu_ref, prompts, got, want, label, tol=LOGIT_TOL,
                       rtol=0.0):
    """``got`` and ``want`` are two card runs' greedy chains: equal, or at
    the first token where a chain differs both tokens lie within ``tol +
    rtol * |max|`` of the CPU's largest logit (a near-tie; after it the
    streams legitimately part). Returns the requests that differ."""
    parted = 0
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        parted += 1
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        z = cpu_ref.logits(list(p) + a[:i])
        print(f"{label}: a chain parts at token {i}: {a[i]} vs {b[i]}, CPU "
              f"logits {z[a[i]]:.6f} / {z[b[i]]:.6f}, max {z.max():.6f}")
        if min(z[a[i]], z[b[i]]) < z.max() - tol - rtol * abs(z.max()):
            raise AssertionError(f"{label}: chains differ beyond a near-tie")
    return parted


def _trace_counts(mx, handle):
    spans = mx.telemetry.trace.spans(handle.trace_id)
    return (sum(s["name"] == "serve.decode.step" for s in spans),
            sum(s["name"] == "serve.decode.prefill" for s in spans))


def phase_prefill(mx, ck, params, cpu_ref):
    """Chunked prefill at full width through serve_decoder on gpu(0):
    ladder [1, 4, 8], 8 prompts of 65-150 tokens, 64 new each, submitted
    at once and pumped on a real clock, at prefill_chunk 64 and 1. Every
    dispatch launches the decode kernels (the S=64 windows too); the two
    runs' greedy chains agree (or part at a near-tie); one S=64 window's
    logits on the card and the CPU agree within LOGIT_TOL. Returns the
    chunked scheduler (phase 23 profiles it)."""
    import numpy as np
    print(_tf32(False) + " (decode fast-path phases)")
    rs = np.random.RandomState(SEED + 10)
    prompts = [rs.randint(0, V, n).tolist() for n in PREFILL_PROMPTS]
    gen, runs = _gen(), {}
    for chunk in (PREFILL_CHUNK, 1):
        sched = mx.serve.serve_decoder(
            gen(1), mx.convert.params_from_numpy(params, mx.gpu(0)),
            name=f"prefill{chunk}", capacity=CAP, ladder=LADDER,
            context=mx.gpu(0), start=False, symbol_gen=gen,
            prefill_chunk=chunk, prefix_cache_mb=0)
        mx.telemetry.trace.clear()
        ck.reset_launch_counts()
        outs, hs, wall = _serve_all(sched, prompts, NEW)
        st = sched.stats()
        _decode_launches(f"prefill chunk {chunk}", ck.launch_counts(),
                         st["iterations"])
        per = [(len(p),) + _trace_counts(mx, h) + (h.ttft, h.ttft_exec)
               for p, h in zip(prompts, hs)]
        runs[chunk] = (outs, per, wall, st, sched)
        n_tok = sum(len(o) for o in outs)
        print(f"prefill chunk {chunk}: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s; {st['iterations']} iterations, "
              f"{st['prefill_chunks']} prefill chunks, exec_est_ms "
              f"{st['exec_est_ms']}")
    if not runs[PREFILL_CHUNK][3]["prefill_chunks"]:
        raise AssertionError("no prefill window was dispatched")
    print("prefill per request (prompt tokens: dispatches, prefill "
          f"dispatches, ttft s, ttft_exec s) chunk {PREFILL_CHUNK} | chunk 1:")
    for a, b in zip(runs[PREFILL_CHUNK][1], runs[1][1]):
        print(f"  T={a[0]:3d}: {a[1]:3d} {a[2]:3d} {a[3]:.4f} {a[4]:.4f} | "
              f"{b[1]:3d} {b[2]:3d} {b[3]:.4f} {b[4]:.4f}")
    parted = _same_or_near_ties(cpu_ref, prompts, runs[PREFILL_CHUNK][0],
                                runs[1][0], "prefill")
    print(f"prefill: chunk {PREFILL_CHUNK} and chunk 1 greedy chains: "
          f"{len(prompts) - parted} of {len(prompts)} equal")
    # one S=64 window, card vs CPU, from cursor 0
    drv = runs[PREFILL_CHUNK][4].engine.driver(1)
    window = np.asarray([prompts[1][:PREFILL_CHUNK]])
    drv.join(0)
    card = drv.step(window).asnumpy()[0]
    drv.leave(0)
    cpu_ref.drv.leave(0)
    cpu_ref.drv.join(0)
    host = cpu_ref.drv.step(window).asnumpy()[0]
    err = float(np.abs(card - host).max())
    print(f"prefill: one S={PREFILL_CHUNK} window, max |logit card - cpu| = "
          f"{err:.3g} (tol {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError("card and CPU window logits disagree")
    return runs[PREFILL_CHUNK][4]


def phase_spec(mx, ck, params, prompts, cpu_ref):
    """Speculative decoding at full width: phase 3's 8 prompts, 64 new
    tokens, submitted at once, the 1-layer draft at spec_k 4 against the
    target alone (both with chunked prefill); greedy chains agree (or
    part at a near-tie); then a self draft (the target as its own draft)
    must accept >= 0.95 of its proposals. Returns the speculative
    scheduler (phase 23 profiles it)."""
    gen = _gen()
    common = dict(capacity=CAP, ladder=LADDER, context=mx.gpu(0),
                  start=False, symbol_gen=gen, prefill_chunk=PREFILL_CHUNK,
                  prefix_cache_mb=0)

    def tp(p):
        return mx.convert.params_from_numpy(p, mx.gpu(0))
    alone = mx.serve.serve_decoder(gen(1), tp(params), name="spec-off",
                                   **common)
    ref, _, ref_wall = _serve_all(alone, prompts, NEW)
    spec = mx.serve.serve_decoder(
        gen(1), tp(params), name="spec-on", draft_symbol_gen=_gen(1),
        draft_params=tp(_draft_params(params)), spec_k=SPEC_K, **common)
    ck.reset_launch_counts()
    outs, _, wall = _serve_all(spec, prompts, NEW)
    counts = ck.launch_counts()
    st, st_ref = spec.stats(), alone.stats()
    n_tok = sum(len(o) for o in outs)
    print(f"spec: 1-layer draft, spec_k {SPEC_K}: {st['spec']}; "
          f"{st['iterations']} iterations, {n_tok / wall:.1f} tokens/s; "
          f"target alone: {st_ref['iterations']} iterations, "
          f"{sum(len(o) for o in ref) / ref_wall:.1f} tokens/s; launches "
          f"{counts}")
    if not all(counts[k] for k in DECODE_KERNELS):
        raise AssertionError("spec: a decode kernel was not launched")
    parted = _same_or_near_ties(cpu_ref, prompts, outs, ref, "spec")
    print(f"spec: greedy chains equal to the target alone's in "
          f"{len(prompts) - parted} of {len(prompts)} requests")
    self_draft = mx.serve.serve_decoder(
        gen(1), tp(params), name="spec-self", draft_symbol_gen=gen,
        draft_params=tp(params), spec_k=SPEC_K, **common)
    _serve_all(self_draft, prompts, SELF_DRAFT_NEW)
    acc = self_draft.stats()["spec"]
    print(f"spec: self draft, {SELF_DRAFT_NEW} new tokens: {acc}")
    if not acc["acceptance"] >= 0.95:
        raise AssertionError(f"self-draft acceptance {acc['acceptance']}")
    return spec


def phase_prefix(mx, ck, params):
    """The prefix store at full width: ladder [4], an 8 MiB store, 8
    requests of a shared 128-token prefix plus one distinct token each
    (the first alone, cold; then 7 at once, warm): the hit rate is 7/8,
    the rows each warm slot holds are bitwise the cold capture's, and
    every dispatch launched the decode kernels."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SEED + 11)
    shared = rs.randint(0, V, PREFIX_LEN).tolist()
    prompts = [shared + [int(t)] for t in rs.randint(0, V, N_REQ)]
    gen = _gen()
    sched = mx.serve.serve_decoder(
        gen(1), mx.convert.params_from_numpy(params, mx.gpu(0)),
        name="prefix", capacity=CAP, ladder=[4], context=mx.gpu(0),
        start=False, symbol_gen=gen, prefill_chunk=PREFILL_CHUNK,
        prefix_cache_mb=PREFIX_MB)
    ck.reset_launch_counts()
    _, cold, _ = _serve_all(sched, prompts[:1], PREFIX_NEW,
                            prefix_id="shared")
    _, warm, _ = _serve_all(sched, prompts[1:], PREFIX_NEW,
                            prefix_id="shared")
    st = sched.stats()
    _decode_launches("prefix", ck.launch_counts(), st["iterations"])
    store = st["prefix"]
    ttft = [h.ttft_exec for h in warm]
    print(f"prefix: {store}; ttft_exec cold {cold[0].ttft_exec:.4f} s, "
          f"warm mean {np.mean(ttft):.4f} s (min {min(ttft):.4f}, max "
          f"{max(ttft):.4f}); {st['iterations']} iterations")
    if store["hits"] != N_REQ - 1 or store["misses"] != 1:
        raise AssertionError(f"prefix hit rate {store['hit_rate']}, want "
                             f"{N_REQ - 1}/{N_REQ}")
    tel = {k: mx.telemetry.get_metric(f"serve.decode.{k}", model="prefix")
           for k in ("prefix.hits", "prefix.misses", "prefix.captures",
                     "iterations", "step.seconds")}
    print("prefix: telemetry " + ", ".join(
        f"serve.decode.{k}={getattr(m, 'count', None) or m.value}"
        for k, m in tel.items()))
    if (tel["prefix.hits"].value, tel["prefix.misses"].value,
            tel["prefix.captures"].value, tel["step.seconds"].count) != \
            (N_REQ - 1, 1, 1, st["iterations"]):
        raise AssertionError("prefix: the serve.decode telemetry disagrees "
                             "with stats()")
    entry = sched.prefix_store.lookup("shared", prompts[0])[1]
    drv = sched.engine.driver(4)
    for slot in range(4):
        rows = drv.capture_rows(slot, PREFIX_LEN)
        for nm, r in entry.payloads["target"].items():
            if not torch.equal(rows[nm].view(torch.uint8),
                               r[:, :PREFIX_LEN].view(torch.uint8)):
                raise AssertionError(f"prefix: slot {slot} {nm} is not the "
                                     "cold capture's bytes")
    print(f"prefix: the first {PREFIX_LEN} rows of all 4 slots are bitwise "
          "the cold capture's")


def phase_fp8(mx, ck, params, prompts):
    """The fp8 KV cache at full width: phase 3's 8 prompts, 64 new tokens,
    submitted at once, ladder [1, 4, 8], with float32, float8_e4m3fn and
    float8_e5m2 cells: the fp8 runs launch ``decode_attention_fp8`` at
    every dispatch (and the float32 read never), and their cells stay
    float8. Then one stream teacher-forced on the card and the CPU, the
    CPU step reading the card's cells. Returns the fp8 launches."""
    import numpy as np
    import torch
    runs, fp8_launches = {}, 0
    for cd in (None, "fp8", "e5m2"):
        gen = _gen(cache_dtype=cd)
        sched = mx.serve.serve_decoder(
            gen(1), mx.convert.params_from_numpy(params, mx.gpu(0)),
            name=f"cache-{cd}", capacity=CAP, ladder=LADDER,
            context=mx.gpu(0), start=False, prefix_cache_mb=0)
        ck.reset_launch_counts()
        outs, _, wall = _serve_all(sched, prompts, NEW)
        counts, st = ck.launch_counts(), sched.stats()
        read = "decode_attention_fp8" if cd else "decode_attention"
        _decode_launches(f"cache {cd or 'float32'}", counts,
                         st["iterations"], read=read)
        fp8_launches += counts["decode_attention_fp8"]
        cells = {cell.astorch().dtype for nm, cell in
                 sched.engine._bm._leader._exec_group.executor
                 .aux_dict.items() if nm.endswith("_cache")}
        n_tok = sum(len(o) for o in outs)
        runs[cd] = outs
        same = sum(a == b for a, b in zip(outs, runs[None]))
        print(f"cache {cd or 'float32'}: cells {sorted(map(str, cells))}; "
              f"{n_tok / wall:.1f} tokens/s ({st['iterations']} iterations, "
              f"{wall:.3f} s); {same} of {len(outs)} chains equal to the "
              "float32 cache's")
        want = {None: torch.float32, "fp8": torch.float8_e4m3fn,
                "e5m2": torch.float8_e5m2}[cd]
        if cells != {want}:
            raise AssertionError(f"cache cells {cells}, want {want}")
    # teacher-force request 0's e4m3 stream; before each step the CPU
    # driver takes the card's cells, so the step compares one read
    sym = _gen(cache_dtype="fp8")(1)
    stream = prompts[0] + runs["fp8"][0][:8]
    gpu, cpu = (_decoder(mx, sym, params, ctx)
                for ctx in (mx.gpu(0), mx.cpu()))
    g_aux, c_aux = (d._mod._exec_group.executor.aux_dict for d in (gpu, cpu))
    worst, flipped = 0.0, 0
    for d in (gpu, cpu):
        d.join(0)
    for i, tok in enumerate(stream[:-1]):
        for nm, cell in g_aux.items():
            c_aux[nm].astorch().view(torch.uint8).copy_(
                cell.astorch().view(torch.uint8).cpu())
        a = gpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        b = cpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        flipped += sum(int((cell.astorch().view(torch.uint8).cpu() !=
                            c_aux[nm].astorch().view(torch.uint8)).sum())
                       for nm, cell in g_aux.items()
                       if nm.endswith("_cache"))
        if not np.isfinite(a).all():
            raise AssertionError(f"fp8 step {i}: logits not finite")
        worst = max(worst, float(np.abs(a - b).max()))
        if i >= PROMPT - 1 and b[stream[i + 1]] < b.max() - FP8_LOGIT_TOL:
            raise AssertionError(f"fp8: served token {stream[i + 1]} at step "
                                 f"{i} is not the CPU argmax")
    print(f"fp8: teacher-forced {len(stream) - 1} steps over the card's "
          f"cells: max |logit card - cpu| = {worst:.3g} (tol "
          f"{FP8_LOGIT_TOL}); {flipped} new cells one code apart")
    if not worst <= FP8_LOGIT_TOL:
        raise AssertionError("card and CPU fp8 logits disagree")
    return fp8_launches


def phase_fastpath_profile(mx, prefill_sched, spec_sched, steps=4):
    """A rung-8 S=64 prefill window and a rung-8 speculative iteration
    (4 draft steps and one S=4 verify) under the profiler: wall, device
    busy, launches, device time by group."""
    import types
    import numpy as np
    rs = np.random.RandomState(SEED + 12)
    rows = list(range(LADDER[-1]))
    drv = prefill_sched.engine.driver(LADDER[-1])
    sdrv, ddrv = (e.driver(LADDER[-1]) for e in (spec_sched.engine,
                                                  spec_sched.draft))
    for d in (drv, sdrv, ddrv):
        for r in rows:
            d.join(r)
    window = rs.randint(0, V, (LADDER[-1], PREFILL_CHUNK))
    base = rs.randint(0, V, (LADDER[-1], 1))
    greedy = mx.serve.SamplingParams()
    meta = [(r, types.SimpleNamespace(sampling=greedy, rng=None))
            for r in rows]

    def prefill():
        drv.rewind_many(rows, [0] * len(rows))
        drv.step(window).asnumpy()

    def spec_iteration():
        for d in (sdrv, ddrv):
            d.rewind_many(rows, [PROMPT] * len(rows))
        spec_sched._dispatch_spec(sdrv, ddrv, base, meta, SPEC_K)
    for label, fn in ((f"S={PREFILL_CHUNK} prefill window", prefill),
                      (f"speculative iteration (k={SPEC_K})",
                       spec_iteration)):
        wall, busy, launches, groups = _profiled(fn, steps)
        print(f"fast-path profile: rung {LADDER[-1]} {label}, {steps} "
              f"dispatches: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% of wall), {launches:.1f} launches")
        for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  group {g}: {t:.3f} ms ({100 * t / busy:.1f}%), "
                  f"{c:.1f} launches")
    for d in (drv, sdrv, ddrv):
        for r in rows:
            d.leave(r)


# --------------------------------------------------------------------------
# phases 32-34: LM decode serving in bfloat16 (compute_dtype)
# --------------------------------------------------------------------------
def _bf16_within(a, b, half="bfloat16"):
    """(worst |a - b|, worst |a - b| / (tol * (1 + |b|))) with tol the
    16-bit type's HALF_LOGIT_TOL: the second is at most 1 when a is within
    tol of b, atol and rtol."""
    import numpy as np
    d = np.abs(a - b)
    tol = HALF_LOGIT_TOL[half]
    return float(d.max()), float((d / (tol * (1 + np.abs(b)))).max())


def phase_bf16_decode(mx, ck, params, prompts, half="bfloat16"):
    """Phase 3's serving in bfloat16 mixed precision: the full-width model
    through ``serve_decoder(compute_dtype=half)``'s dispatch thread
    with phase 3's prompts and arrivals, alternated with the float32
    ladder (float32, bfloat16, bfloat16, float32). Each run: the four
    decode libraries unloaded first so that warmup loads them (and nothing
    loads after it), the launches of every dispatch exactly those of one
    forward — in bfloat16 the ``*_bf16`` instances and no float32 decode
    kernel —, the cast layer's casts and write-backs exactly the 2L caches
    a dispatch (the parameters' casts are kept). Then request 0's bfloat16
    stream (prompt + 8 served tokens) teacher-forced on the card and on
    the CPU in bfloat16: logits within HALF_LOGIT_TOL[half], every served token
    the CPU's argmax or a near-tie. Returns (the bfloat16 runs' launches,
    {label: the last scheduler}, the bfloat16 chains)."""
    sfx = HALF_SFX[half]
    import numpy as np
    print(_tf32(False) + f" ({sfx} decode phases)")
    sym = _gen()(1)
    rates, last, bf16_counts = {}, {}, None
    for cd in (None, half, half, None):
        label = cd or "float32"
        _unload(ck, DECODE_KERNELS)
        t0 = time.perf_counter()
        sched = mx.serve.serve_decoder(
            sym, mx.convert.params_from_numpy(params, mx.gpu(0)),
            name=f"lm-{label}", capacity=CAP, ladder=LADDER,
            context=mx.gpu(0), default_max_new=NEW, compute_dtype=cd)
        warm_s = time.perf_counter() - t0
        ck.reset_launch_counts()
        mx.executor.reset_cast_counts()
        outs, wall = _serve_waves(sched, prompts)
        counts, casts = ck.launch_counts(), mx.executor.cast_counts()
        st = sched.stats()
        its, n_tok = st["iterations"], sum(len(o) for o in outs)
        print(f"{sfx} decode: {label}: built and warmed in {warm_s:.2f} s, "
              f"{sched.engine.warmup_compiles} kernel libraries loaded by "
              f"warmup, compiles_since_warmup {st['compiles_since_warmup']};"
              f" {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
              f"tokens/s; iteration ms {st['step_ms']}; {its} iterations, "
              f"{st['migrations']} migrations; cast layer {casts}")
        _check_served(outs, st)
        if cd:
            _decode_launches(f"{sfx} decode {label}", counts, its,
                             read="decode_attention_" + sfx, suffix="_" + sfx)
            bf16_counts = {k: counts[k] + (bf16_counts or {}).get(k, 0)
                           for k in _halved(BF16_DECODE_KERNELS, half)}
            chains = [o.tolist() for o in outs]
        else:
            _decode_launches(f"{sfx} decode {label}", counts, its)
        per = 2 * N_LAYER * its if cd else 0
        if casts != {"casts": per, "write_backs": per}:
            raise AssertionError(f"{label}: cast layer {casts}, want {per} "
                                 "casts and write-backs (2L a dispatch)")
        if sched.engine.warmup_compiles != len(DECODE_KERNELS) or \
                st["compiles_since_warmup"] != 0:
            raise AssertionError(f"{label}: warmup did not load the decode "
                                 "libraries, or a library loaded after it")
        rates.setdefault(label, []).append(n_tok / wall)
        last[label] = sched
    f32, bf = (np.mean(rates[k]) for k in ("float32", half))
    print(f"{sfx} decode: tokens/s float32 {rates['float32']} (mean "
          f"{f32:.1f}), {half} {rates[half]} (mean {bf:.1f}): "
          f"{half} {100 * (bf / f32 - 1):+.1f}%")
    stream = prompts[0] + chains[0][:8]
    gpu, cpu = (_decoder(mx, sym, params, ctx, compute_dtype=half)
                for ctx in (mx.gpu(0), mx.cpu()))
    cpu32 = _decoder(mx, sym, params, mx.cpu())
    worst = ratio = own = 0.0
    for d in (gpu, cpu, cpu32):
        d.join(0)
    for i, tok in enumerate(stream[:-1]):
        a, b, c = (d.step(np.asarray([[tok]])).asnumpy()[0, 0]
                   for d in (gpu, cpu, cpu32))
        if a.shape != (V,) or not np.isfinite(a).all():
            raise AssertionError(f"{sfx} step {i}: logits {a.shape} not "
                                 "finite")
        w, r = _bf16_within(a, b, half)
        worst, ratio = max(worst, w), max(ratio, r)
        own = max(own, float(np.abs(b - c).max()))
        top = float(b.max())
        if i >= PROMPT - 1 and b[stream[i + 1]] < \
                top - 2 * HALF_LOGIT_TOL[half] * (1 + abs(top)):
            raise AssertionError(f"bf16: served token {stream[i + 1]} at "
                                 f"step {i} is not the CPU argmax "
                                 f"{int(b.argmax())} nor a near-tie")
    print(f"{sfx} decode: teacher-forced {len(stream) - 1} steps: max "
          f"|logit card - cpu| = {worst:.3g}, {ratio:.3f} of the tolerance "
          f"({HALF_LOGIT_TOL[half]} atol and rtol); the CPU's own {half} vs "
          f"float32 distance {own:.3g}")
    # float16 is held by the spread rule (its card-vs-CPU distance sits
    # at the edge of bfloat16's tolerance over 8), bfloat16 by that
    # tolerance
    if not (ratio <= 1.0 if half == "bfloat16"
            else worst <= BF16_SPREAD * own):
        raise AssertionError(f"{sfx} card and CPU logits disagree")
    return bf16_counts, last, chains


def phase_bf16_fastpaths(mx, ck, params, prompts, ref, cpu32,
                         half="bfloat16"):
    """Chunked prefill and speculative decoding armed under bfloat16:
    phase 3's prompts through one ``serve_decoder(compute_dtype=
    half, symbol_gen=, prefill_chunk=64, draft_symbol_gen=,
    spec_k=4)`` (phase 20's 1-layer draft), submitted at once and pumped:
    windows and speculative iterations ran, only the bfloat16 decode
    instances launched, the greedy chains equal phase 32's bfloat16
    chains ``ref`` or part at a bfloat16 near-tie (CPU bfloat16
    reference), and one S=64 window's logits card vs CPU bfloat16 within
    BF16_SPREAD times the CPU's own bfloat16-vs-float32 distance (the
    float32 ``_CpuRef`` ``cpu32``): over a 64-row window 8 layers of
    bfloat16 roundings, placed otherwise by cuBLAS than by oneDNN,
    accumulate to about HALF_LOGIT_TOL[half]."""
    sfx = HALF_SFX[half]
    import numpy as np
    gen = _gen()

    def tp(p):
        return mx.convert.params_from_numpy(p, mx.gpu(0))
    sched = mx.serve.serve_decoder(
        gen(1), tp(params), name="bf16-fast", capacity=CAP, ladder=LADDER,
        context=mx.gpu(0), start=False, compute_dtype=half,
        symbol_gen=gen, prefill_chunk=PREFILL_CHUNK,
        draft_symbol_gen=_gen(1), draft_params=tp(_draft_params(params)),
        spec_k=SPEC_K, prefix_cache_mb=0)
    ck.reset_launch_counts()
    outs, _, wall = _serve_all(sched, prompts, NEW)
    counts, st = ck.launch_counts(), sched.stats()
    n_tok = sum(len(o) for o in outs)
    print(f"{sfx} fast paths: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; {st['iterations']} iterations, "
          f"{st['prefill_chunks']} prefill chunks, spec {st['spec']}; "
          f"launches {counts}")
    kernels = _halved(BF16_DECODE_KERNELS, half)
    if not all(counts[k] for k in kernels) or \
            any(v for k, v in counts.items() if k not in kernels):
        raise AssertionError("bf16 fast paths: want the bfloat16 decode "
                             "instances and nothing else")
    if not st["prefill_chunks"] or not st["spec"]["proposed"]:
        raise AssertionError("bf16 fast paths: no window or no speculation")
    cpu_ref = _CpuRef(mx, params, compute_dtype=half)
    parted = _same_or_near_ties(cpu_ref, prompts, outs, ref,
                                f"{sfx} fast paths",
                                tol=2 * HALF_LOGIT_TOL[half],
                                rtol=2 * HALF_LOGIT_TOL[half])
    print(f"{sfx} fast paths: greedy chains equal to phase 32's in "
          f"{len(prompts) - parted} of {len(prompts)} requests")
    window = np.random.RandomState(SEED + 13).randint(
        0, V, (1, PREFILL_CHUNK))
    drv = sched.engine.driver(1)
    drv.join(0)
    card = drv.step(window).asnumpy()[0]
    drv.leave(0)
    host = {}
    for key, r in (("bf16", cpu_ref), ("f32", cpu32)):
        r.drv.leave(0)
        r.drv.join(0)
        host[key] = r.drv.step(window).asnumpy()[0]
    worst, ratio = _bf16_within(card, host["bf16"], half)
    own = float(np.abs(host["bf16"] - host["f32"]).max())
    print(f"{sfx} fast paths: one S={PREFILL_CHUNK} window, max |logit card "
          f"- cpu| = {worst:.3g} ({ratio:.3f} of {HALF_LOGIT_TOL[half]} atol "
          "and "
          f"rtol); the CPU's own {half} vs float32 distance {own:.3g} "
          f"(limit {BF16_SPREAD} times that)")
    if not worst <= BF16_SPREAD * own:
        raise AssertionError("bf16 card and CPU window logits disagree")


def _decode_group(key):
    if any(k in key for k in _PORT_KERNELS):
        return "port kernels"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "copy_kernel" in key:
        return "copy kernels (the casts)"
    if "at::native" in key or "softmax_warp_" in key:
        return "PyTorch elementwise/reduction"
    return "cuBLAS"


def phase_bf16_decode_profile(mx, scheds, steps=8):
    """Rung-8 S=1 steps of phase 32's float32 and bfloat16 servers, each
    way in turns (float32, bfloat16, bfloat16, float32; ``steps`` each):
    the wall per step without the profiler; under the profiler wall,
    device busy, launches, device time by group and the cast layer's
    cache casts and write-backs per step; then the host's time per step
    (the profiler's CPU activity): the self time of every op and the ops
    that take the most."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rows = list(range(LADDER[-1]))
    tokens = np.random.RandomState(SEED + 14).randint(0, V, (len(rows), 1))
    drivers = {k: s.engine.driver(LADDER[-1]) for k, s in scheds.items()}
    for d in drivers.values():
        for r in rows:
            d.join(r)
    order = ("float32", "bfloat16", "bfloat16", "float32")

    def steps_of(label, n):
        drv = drivers[label]
        drv.rewind_many(rows, [PROMPT] * len(rows))
        return [lambda: drv.step(tokens).asnumpy()] * n
    walls = {"float32": [], "bfloat16": []}
    for label in order:
        fns = steps_of(label, steps + 1)
        fns[0]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn in fns[1:]:
            fn()
        walls[label].append((time.perf_counter() - t0) * 1e3 / steps)
    print(f"bf16 decode profile: rung {LADDER[-1]} wall ms/step without "
          f"the profiler, in turns {order}: {walls}")
    runs, casts = {"float32": [], "bfloat16": []}, {}
    for label in order:
        fns = steps_of(label, 1)
        mx.executor.reset_cast_counts()
        runs[label].append(_profiled(fns[0], steps, group=_decode_group))
        casts[label] = {k: v / (steps + 1) for k, v in
                        mx.executor.cast_counts().items()}
    _print_profiles("bf16 decode profile", runs, steps)
    print(f"bf16 decode profile: wall ms/step of each profiled turn "
          f"{ {k: [round(r[0], 3) for r in v] for k, v in runs.items()} }; "
          f"cast layer per step {casts}")
    for label in ("float32", "bfloat16"):
        fn = steps_of(label, 1)[0]
        fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                fn()
        evts = [(e.self_cpu_time_total / 1e3 / steps, e.count / steps,
                 e.key) for e in prof.key_averages()]
        total = sum(e[0] for e in evts)
        print(f"bf16 decode host profile: {label}: {total:.3f} ms/step of "
              f"ops' self time on the host, {sum(e[1] for e in evts):.0f} "
              "op calls/step; most:")
        for ms, n, key in sorted(evts, reverse=True)[:10]:
            print(f"  {ms:8.4f} ms/step {n:6.1f} calls/step  {key[:70]}")
    for d in drivers.values():
        for r in rows:
            d.leave(r)


# --------------------------------------------------------------------------
# the user-extension surfaces: mx.rtc, mx.operator, mx.autograd
# --------------------------------------------------------------------------
def phase_rtc(mx):
    """An ``Rtc`` push of a user ``axpb`` kernel over 2^24 floats: bit for
    bit ``torch.add(y, x, alpha=2)``, with the default launch and with
    given dims; a wrong shape raises. Returns (its record, launches)."""
    import torch
    from mxnet_tpu_torch import rtc
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(RTC_N, generator=gen).to(dev)
    y = torch.randn(RTC_N, generator=gen).to(dev)
    xs, ys = mx.nd.NDArray(x), mx.nd.NDArray(y)
    out = mx.nd.NDArray(torch.empty_like(x))
    kernel = mx.rtc.Rtc("rtc_axpb", [("x", xs), ("y", ys)], [("out", out)],
                        AXPB_BODY)
    want = torch.add(y, x, alpha=2.0)
    rtc.reset_launch_counts()
    t0 = time.perf_counter()
    kernel.push([xs, ys], [out])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    err = _max_err(out.astorch(), want)
    out.astorch().zero_()
    kernel.push([xs, ys], [out], grid_dims=(528,), block_dims=(512,))
    torch.cuda.synchronize()
    err = max(err, _max_err(out.astorch(), want))
    launches = rtc.launch_counts()["rtc_axpb"]
    print(f"rtc: route nvrtc, first push {first:.3f} s "
          f"(build and load included), max |err| {err} against "
          f"torch.add(y, x, alpha=2) (default launch, then grid 528 x "
          f"block 512); launches {launches}")
    if err != 0.0 or launches != 2:
        raise AssertionError("rtc_axpb disagrees with torch.add or did not "
                             "launch twice")
    try:
        kernel.push([xs, mx.nd.NDArray(y[:1000])], [out])
    except mx.MXNetError as e:
        print(f"rtc: a wrong shape raises: {e}")
    else:
        raise AssertionError("Rtc.push took an input of the wrong shape")
    push = lambda: kernel.push([xs, ys], [out])     # noqa: E731
    rec = {"max_abs_err": err, "ms": _timed(push),
           "device_ms": _device_ms(push),
           "plain_ms": _timed(lambda: 2.0 * x + y),
           "library_ms": _timed(lambda: torch.add(y, x, alpha=2.0)),
           "bound": _bound_ms(3 * RTC_N * 4, 2 * RTC_N)}
    print(f"rtc_axpb: {rec['ms']:.5f} ms, device {rec['device_ms']}, plain "
          f"{rec['plain_ms']:.5f}, library {rec['library_ms']:.5f}, bound "
          f"{rec['bound'][0]:.5f} ({rec['bound'][1]})")
    return rec, launches


def _rewired(mx, sym, rewire):
    """``sym`` through its JSON with ``rewire(node)`` applied to each node
    (it returns whether it changed the node); returns (symbol, count)."""
    graph = json.loads(sym.tojson())
    count = sum(bool(rewire(node)) for node in graph["nodes"])
    return mx.sym.load_json(json.dumps(graph)), count


def _relu_to(op):
    def rewire(node):
        if node["op"] == "Activation" and \
                node.get("attrs", {}).get("act_type") == "relu":
            node["op"] = op
            node["attrs"] = {k: v for k, v in node["attrs"].items()
                             if k != "act_type"}
            return True
        return False
    return rewire


def _register_relu_user(mx):
    import torch
    for name, vjp in (("relu_user", RELU_VJP_BODY), ("relu_user_novjp",
                                                      None)):
        if name not in mx.sym.__dict__:
            mx.rtc.register_cuda_op(
                name, kernel=lambda attrs: RELU_BODY,
                vjp_kernel=None if vjp is None else (lambda attrs, v=vjp: v),
                out_shapes=lambda attrs, shapes: [(shapes[0], None)],
                reference=lambda attrs, x: torch.maximum(x, x.new_zeros(())))


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms for a comparison of two graphs on
    the card: its default weight-gradient algorithms sum with atomics in
    an order that changes from run to run."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _grads_close(got, want):
    """The largest gradient difference between two {name: numpy} dicts, as
    a share of the largest gradient magnitude in ``want`` (a per-array
    scale would blow up arrays whose gradient sums cancel, such as
    bn0_gamma's, 1e-4 of the others at batch 4); returns (share, name)."""
    import numpy as np
    scale = max(float(np.abs(g).max()) for g in want.values())
    worst, worst_k = 0.0, None
    for k, g in want.items():
        d = float(np.abs(got[k] - g).max()) / scale
        if d > worst:
            worst, worst_k = d, k
    return worst, worst_k


def _ce_loss(mod, y):
    import numpy as np
    prob = mod.get_outputs()[0].asnumpy()
    return float(-np.log(prob[np.arange(len(y)), y.astype(int)]).mean())


def _step_pair(mx, syms, args, auxs, X, y, label):
    """One forward_backward of each symbol in ``syms`` (the plain one
    last) from the same parameters on the card, TF32 off, cuDNN
    deterministic: the loss and every gradient within FWD_TOL (of the
    largest |g|)."""
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=mx.gpu(0))],
                            [mx.nd.array(y, ctx=mx.gpu(0))])

    def step(sym, scope):
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mod.bind([("data", X.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params=mx.convert.params_from_numpy(
            args, mx.gpu(0)), aux_params=mx.convert.params_from_numpy(
            auxs, mx.gpu(0)))
        with scope():
            mod.forward_backward(batch)
        return mod, {k: g.asnumpy() for k, g in
                     mod._exec_group.executor.grad_dict.items()}

    mods, grads = zip(*[step(sym, _deterministic) for sym in syms])
    losses = [_ce_loss(m, y) for m in mods]
    worst, worst_k = _grads_close(*grads)
    noise, noise_k = _grads_close(*[step(syms[1], contextlib.nullcontext)[1]
                                    for _ in range(2)])
    print(f"{label}: the plain graph run twice with cuDNN's default "
          f"algorithms: {noise:.3g} of the largest |g| apart ({noise_k})")
    print(f"{label}: one step at batch {len(X)}, TF32 off, cuDNN "
          f"deterministic: loss "
          f"{losses[0]:.6f} against the plain graph's {losses[1]:.6f}; max "
          f"gradient difference {worst:.3g} of the largest |g| ({worst_k}; "
          f"limit {FWD_TOL})")
    if abs(losses[0] - losses[1]) > FWD_TOL or worst > FWD_TOL:
        raise AssertionError(f"{label}: the step disagrees with the plain "
                             "graph's")


def _fit_timed(mx, sym, args, auxs, X, y, label):
    """Fit ``sym`` on the card for one epoch over (X, y) from the given
    parameters: prints img/s and p50 step ms without the first batch;
    returns (the module, step seconds)."""
    import numpy as np
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    step_end, stamps, _ = _step_recorder()
    metric = mx.metric.create(["acc", "ce"])
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer_params=SGD,
            arg_params=mx.convert.params_from_numpy(args, mx.gpu(0)),
            aux_params=mx.convert.params_from_numpy(auxs, mx.gpu(0)),
            batch_end_callback=step_end)
    steps = np.diff(stamps)
    names, values = metric.get()
    print(f"{label}: {len(stamps)} steps, without the first "
          f"{TRAIN_BATCH * len(steps) / steps.sum():.1f} img/s, step p50 "
          f"{1e3 * np.percentile(steps, 50):.2f} ms; "
          f"{dict(zip(names, values))}")
    if not np.isfinite(values[1]):
        raise AssertionError(f"{label}: the training loss is not finite")
    return mod, steps


def _weights_within_spread(label, mod, plain, spread):
    """``mod``'s weights against the plain fit's, each array within
    SPREAD_FACTOR times the spread of the plain fit from 1e-6-perturbed
    starting weights."""
    import numpy as np
    got, want, pert = (m.get_params()[0] for m in (mod, plain, spread))
    worst, worst_k = -1.0, None
    for k, w in want.items():
        w = w.asnumpy()
        d = float(np.abs(got[k].asnumpy() - w).max())
        floor = float(np.abs(pert[k].asnumpy() - w).max())
        ratio = d / (SPREAD_FACTOR * floor + 1e-5)
        if ratio > worst:
            worst, worst_k = ratio, (k, d, floor)
    print(f"{label}: weights after {TRAIN_STEPS} steps against the plain "
          f"fit's: worst {worst_k[0]} {worst_k[1]:.3g} against the 1e-6 "
          f"spread {worst_k[2]:.3g} (limit {SPREAD_FACTOR} x spread + 1e-5, "
          f"ratio {worst:.3f})")
    if worst > 1.0:
        raise AssertionError(f"{label}: the fit left the plain fit's spread")


def _relu_shapes(mx, sym, batch):
    """The input shapes of the graph's ``relu_user`` nodes at ``batch``."""
    shapes = sym._infer_entry_shapes({"data": (batch,) + TRAIN_IMAGE,
                                      "softmax_label": (batch,)})
    return [shapes[id(n.inputs[0][0])][n.inputs[0][1]]
            for n in sym._topo_nodes() if n.op == "relu_user"]


def _relu_kernel_records(mx, shapes):
    """``relu_user`` and its VJP over one step's inputs (the 50 shapes of
    ResNet-50 at batch 32, exact zeros planted) against the plain version
    (``torch.maximum(x, 0)`` and its autograd backward); torch.relu and
    threshold_backward are timed beside them (they differ at x == 0)."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 5)
    xs = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    cts = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    for x in xs:
        x.view(-1)[::97] = 0.0
    op = mx.ops.get_op("relu_user")
    kernels = op.variants["cuda"]["kernels"]
    plain = lambda x: op.forward({}, [x], [], False, None)[0][0]  # noqa: E731
    fwd = lambda: [kernels.forward({}, [x])[0] for x in xs]  # noqa: E731
    vjp = lambda: [kernels.vjp({}, [x], [c])[0]  # noqa: E731
                   for x, c in zip(xs, cts)]

    def plain_vjp(x, c):
        leaf = x.detach().requires_grad_(True)
        return torch.autograd.grad(plain(leaf), leaf, c)[0]
    thb = torch.ops.aten.threshold_backward
    err_f = max(_max_err(a, plain(x)) for a, x in zip(fwd(), xs))
    err_b = max(_max_err(a, plain_vjp(x, c))
                for a, x, c in zip(vjp(), xs, cts))
    n = sum(x.numel() for x in xs)
    recs = {
        "relu_user": {
            "max_abs_err": err_f, "ms": _timed(fwd, reps=20, warm=3),
            "device_ms": _device_ms(fwd, reps=10),
            "plain_ms": _timed(lambda: [plain(x) for x in xs], 20, 3),
            "library_ms": _timed(lambda: [torch.relu(x) for x in xs], 20,
                                 3),
            "bound": _bound_ms(2 * 4 * n, n)},
        "relu_user_vjp": {
            "max_abs_err": err_b, "ms": _timed(vjp, reps=20, warm=3),
            "device_ms": _device_ms(vjp, reps=10),
            "plain_ms": _timed(lambda: [plain_vjp(x, c) for x, c
                                        in zip(xs, cts)], 20, 3),
            "library_ms": _timed(lambda: [thb(c, x, 0.0) for x, c
                                          in zip(xs, cts)], 20, 3),
            "bound": _bound_ms(3 * 4 * n, n)}}
    recs["relu_user"]["library_device_ms"] = _device_ms(
        lambda: [torch.relu(x) for x in xs], reps=10)
    recs["relu_user_vjp"]["library_device_ms"] = _device_ms(
        lambda: [thb(c, x, 0.0) for x, c in zip(xs, cts)], reps=10)
    for name, r in recs.items():
        print(f"{name}: over one step's {len(xs)} inputs ({n} values): "
              f"{r['ms']:.5f} ms per step, device {r['device_ms']}, plain "
              f"{r['plain_ms']:.5f}, library {r['library_ms']:.5f} "
              f"(device {r['library_device_ms']:.6f}), bound "
              f"{r['bound'][0]:.5f} ({r['bound'][1]}), max |err| "
              f"{r['max_abs_err']}")
        if r["max_abs_err"] != 0.0:
            raise AssertionError(f"{name} disagrees with its plain version")
    return recs


def _py_node():
    """A Python autograd node with one launch each way and no ctypes (a
    clone forward, a clone backward): the host cost of the node alone."""
    import torch

    class Clone(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, ct):
            return ct.clone()
    return Clone.apply


def _host_us(fn, reps=1000, warm=20):
    """Host microseconds per call of ``fn`` over ``reps`` calls, to a
    synchronize (the device work of each call is a few microseconds)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def _user_op_host_probe(mx, mods, batch):
    """Where a step with 50 user ReLUs spends its extra host time. On a
    4096-float input, where the device takes a few microseconds a kernel
    and the host sets the pace: each piece of one user launch, one
    ReLU's forward and backward through the op, and a chain of 50 ReLUs
    forward and backward (the step's count), each against the plain
    version and a Python autograd node without ctypes. Then one step's
    forward and backward apart through the modules of the fits (plain,
    user, user, plain; 3 each): the host's time to return, the time to a
    synchronize and the garbage collector's time; and the forward's host
    time by op, each executor dispatch timed in place."""
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch import rtc
    print("user op probe: live threads "
          f"{sorted(t.name for t in threading.enumerate())}")
    dev = torch.device("cuda", 0)
    x = torch.randn(4096, device=dev)
    out = torch.empty_like(x)
    op = mx.ops.get_op("relu_user")
    kern = op.variants["cuda"]["kernels"]
    funcs = {
        "relu_user": lambda t: op.variants["cuda"]["fn"](
            {}, [t], [], True, None)[0][0],
        "plain": lambda t: op.forward({}, [t], [], True, None)[0][0],
        "python node": _py_node()}
    params = [("data", torch.float32, True), ("out", torch.float32, False)]
    src = rtc.kernel_source("relu_user", params, RELU_BODY, True)
    pieces = {
        "kernel_source": lambda: rtc.kernel_source("relu_user", params,
                                                   RELU_BODY, True),
        "_launch_user": lambda: rtc._launch_user(
            "relu_user", "relu_user", src, [x, out], x.numel(), (16,),
            (256,)),
        "op forward, no autograd": lambda: kern.forward({}, [x]),
        "torch.maximum": lambda: funcs["plain"](x)}
    print("user op probe: host us per call: " + ", ".join(
        f"{k} {_host_us(f):.2f}" for k, f in pieces.items()))
    leaf = x.clone().requires_grad_(True)
    ct = torch.ones_like(x)

    def one(f):
        return lambda: torch.autograd.grad(f(leaf), leaf, ct)

    def chain(f):
        def run():
            y = leaf
            for _ in range(RESNET50_RELUS):
                y = f(y)
            torch.autograd.grad(y, leaf, ct)
        return run
    per_relu = {k: (_host_us(one(f)), _host_us(chain(f), reps=100) /
                    RESNET50_RELUS) for k, f in funcs.items()}
    print("user op probe: host us per ReLU, forward + backward, alone / in "
          f"a chain of {RESNET50_RELUS}: " + ", ".join(
              f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in per_relu.items()))
    order = (("plain", mods[0]), ("relu_user", mods[1]),
             ("relu_user", mods[1]), ("plain", mods[0]))
    gc_acc = {"t": None, "ms": 0.0, "n": 0}

    def on_gc(phase, info):
        if phase == "start":
            gc_acc["t"] = time.perf_counter()
        elif gc_acc["t"] is not None:
            gc_acc["ms"] += 1e3 * (time.perf_counter() - gc_acc["t"])
            gc_acc["n"] += 1
    times = {}
    gc.callbacks.append(on_gc)
    try:
        for name, mod in order:
            for _ in range(3):
                torch.cuda.synchronize()
                g0 = gc_acc["ms"], gc_acc["n"]
                t0 = time.perf_counter()
                mod.forward(batch, is_train=True)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                mod.backward()
                t3 = time.perf_counter()
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                times.setdefault(name, []).append(
                    (1e3 * (t1 - t0), 1e3 * (t2 - t0), 1e3 * (t3 - t2),
                     1e3 * (t4 - t2), gc_acc["ms"] - g0[0],
                     gc_acc["n"] - g0[1]))
    finally:
        gc.callbacks.remove(on_gc)
    med = {k: np.median(np.array(v), axis=0) for k, v in times.items()}
    for name, (fh, fs, bh, bs, _, _) in med.items():
        got = np.array(times[name])
        print(f"user op probe: {name} step, median of 6: forward host "
              f"{fh:.2f} ms (to sync {fs:.2f}), backward host {bh:.2f} ms "
              f"(to sync {bs:.2f}); garbage collection "
              f"{got[:, 4].sum() / len(got):.2f} ms and "
              f"{got[:, 5].sum() / len(got):.1f} passes a step")
    d = med["relu_user"] - med["plain"]
    chained = RESNET50_RELUS * 1e-3 * (per_relu["relu_user"][1] -
                                       per_relu["plain"][1])
    print(f"user op probe: relu_user minus plain: forward host {d[0]:+.2f}"
          f" ms (to sync {d[1]:+.2f}), backward host {d[2]:+.2f} ms (to "
          f"sync {d[3]:+.2f}); the chain predicts {chained:+.2f} ms a step")
    # the forward's host time by op, in place: each dispatch timed from
    # the executor's call to its return (plain, user, user, plain, 2
    # forwards each, twice: 8 forwards a graph, medians per forward)
    from mxnet_tpu_torch import executor
    real, spent = executor.dispatch, {}

    def timed(opdef, *a):
        t = time.perf_counter()
        try:
            return real(opdef, *a)
        finally:
            spent[opdef.name] = spent.get(opdef.name, 0.0) + \
                time.perf_counter() - t
    forwards = {"plain": [], "relu_user": []}
    executor.dispatch = timed
    try:
        for name, mod in order * 2:
            for _ in range(2):
                spent.clear()
                torch.cuda.synchronize()
                mod.forward(batch, is_train=True)
                forwards[name].append(dict(spent))
        torch.cuda.synchronize()
    finally:
        executor.dispatch = real
    ops = sorted({op for f in forwards.values() for d in f for op in d})
    med = {name: {op: 1e3 * np.median([d.get(op, 0.0) for d in f])
                  for op in ops} for name, f in forwards.items()}
    tot = {name: 1e3 * np.array([sum(d.values()) for d in f])
           for name, f in forwards.items()}
    rows = sorted(ops, key=lambda op: -abs(med["relu_user"][op] -
                                           med["plain"][op]))
    print("user op probe: forward host ms by op, plain / relu_user "
          "(median of 8 forwards each): " + ", ".join(
              f"{op} {med['plain'][op]:.2f} / {med['relu_user'][op]:.2f}"
              for op in rows[:6]) + "; all ops per forward min / median / "
          "max: " + "; ".join(
              f"{name} {t.min():.2f} / {np.median(t):.2f} / {t.max():.2f}"
              for name, t in tot.items()))


def phase_user_op(mx, args, auxs):
    """ResNet-50 with its 50 ReLUs as the user op ``relu_user`` (a forward
    and a VJP kernel, registered with ``register_cuda_op``) through
    ``Module.fit``: one step's loss and gradients against the plain
    graph's (TF32 off), then 8 steps beside the plain graph's fit from the
    same parameters and batches, exactly 50 + 50 launches a step, the
    weights within the plain fit's spread; the kernels over one step's
    inputs; the op without a VJP kernel refused in a training bind.
    Returns (records, launches)."""
    import numpy as np
    from mxnet_tpu_torch import rtc
    _register_relu_user(mx)
    plain = _resnet50(mx)
    user, count = _rewired(mx, plain, _relu_to("relu_user"))
    print(f"user op: {count} Activation(relu) nodes of ResNet-50 rewired "
          "to relu_user (route nvrtc)")
    if count != RESNET50_RELUS or plain.list_arguments() != \
            user.list_arguments():
        raise AssertionError("the rewired ResNet-50 differs from the plain "
                             "one beyond its ReLUs")
    print(_tf32(False) + " (user op step phase)")
    X1, y1 = _images(TRAIN_BATCH, SEED + 3)
    _step_pair(mx, (user, plain), args, auxs, X1, y1, "user op")
    print(_tf32(True) + " (user op fits)")
    X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
    rs = np.random.RandomState(SEED + 2)
    nudged = {k: (v * (1 + 1e-6 * rs.randn(*v.shape))).astype(np.float32)
              for k, v in args.items()}
    plain_mod, plain_steps = _fit_timed(mx, plain, args, auxs, X, y,
                                        "user op: plain fit")
    rtc.reset_launch_counts()
    user_mod, user_steps = _fit_timed(mx, user, args, auxs, X, y,
                                      "user op: relu_user fit")
    counts = rtc.launch_counts()
    per_step = {k: counts[k] / TRAIN_STEPS for k in ("relu_user",
                                                     "relu_user_vjp")}
    print(f"user op: launches per step {per_step} (want "
          f"{RESNET50_RELUS} each); step p50 "
          f"{1e3 * np.percentile(user_steps, 50):.2f} ms against the plain "
          f"{1e3 * np.percentile(plain_steps, 50):.2f} ms")
    if any(v != RESNET50_RELUS for v in per_step.values()):
        raise AssertionError("relu_user / relu_user_vjp did not launch 50 "
                             "times a step")
    spread_mod, _ = _fit_timed(mx, plain, nudged, auxs, X, y,
                               "user op: plain fit, perturbed start")
    _weights_within_spread("user op", user_mod, plain_mod, spread_mod)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    for name, mod in (("plain", plain_mod), ("relu_user", user_mod),
                      ("relu_user", user_mod), ("plain", plain_mod)):
        phase_train_profile(mod, it, steps=2,
                            label=f"user op profile, {name}")
    it.reset()
    _user_op_host_probe(mx, (plain_mod, user_mod), next(iter(it)))
    recs = _relu_kernel_records(mx, _relu_shapes(mx, user, TRAIN_BATCH))
    novjp, _ = _rewired(mx, plain, _relu_to("relu_user_novjp"))
    mod = mx.mod.Module(novjp, context=mx.gpu(0))
    mod.bind([("data", (2,) + TRAIN_IMAGE)], [("softmax_label", (2,))])
    mod.init_params(arg_params=mx.convert.params_from_numpy(args, mx.gpu(0)),
                    aux_params=mx.convert.params_from_numpy(auxs, mx.gpu(0)))
    try:
        mod.forward(mx.io.DataBatch([X[:2]], [y[:2]]), is_train=True)
    except mx.MXNetError as e:
        print(f"user op: without a vjp_kernel a training forward raises: "
              f"{e}")
    else:
        raise AssertionError("relu_user_novjp ran a training forward")
    return recs, counts


def _register_custom_softmax(mx):
    import numpy as np
    if "chip_softmax" in mx.operator.get_all_registered():
        return

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().astype(np.int64)
            p = out_data[0].asnumpy().copy()
            p[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], p)

    @mx.operator.register("chip_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Softmax()


def phase_custom_op(mx, args, auxs):
    """ResNet-50 with MXNet's canonical custom softmax (a numpy forward,
    backward p - onehot(label), need_top_grad=False) in the place of
    SoftmaxOutput: one Module.fit step's gradients against the
    SoftmaxOutput graph's (TF32 off), then 8 steps of each, step ms side by
    side."""
    import numpy as np
    _register_custom_softmax(mx)

    def rewire(node):
        if node["op"] != "SoftmaxOutput":
            return False
        node["op"], node["attrs"] = "Custom", {"op_type": "chip_softmax"}
        return True
    plain = _resnet50(mx)
    custom, count = _rewired(mx, plain, rewire)
    if count != 1 or custom.list_arguments() != plain.list_arguments():
        raise AssertionError("the custom-softmax ResNet-50 differs from the "
                             "plain one beyond its head")
    print(_tf32(False) + " (CustomOp step phase)")
    X1, y1 = _images(TRAIN_BATCH, SEED + 4)
    _step_pair(mx, (custom, plain), args, auxs, X1, y1, "custom op")
    print(_tf32(True) + " (CustomOp fits)")
    X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
    _, plain_steps = _fit_timed(mx, plain, args, auxs, X, y,
                                "custom op: SoftmaxOutput fit")
    _, custom_steps = _fit_timed(mx, custom, args, auxs, X, y,
                                 "custom op: Custom softmax fit")
    a, b = (1e3 * np.percentile(s, 50) for s in (custom_steps, plain_steps))
    print(f"custom op: step p50 {a:.2f} ms against SoftmaxOutput's "
          f"{b:.2f} ms ({a - b:+.2f} ms; the numpy body copies "
          f"({TRAIN_BATCH}, {TRAIN_CLASSES}) floats each way twice and "
          "waits for the device at each copy)")


def phase_autograd(mx):
    """A stage-1 bottleneck without BatchNorm at batch 32 (256 -> 64 -> 64
    -> 256 channels, 56 x 56; Convolution, Activation, _plus) through
    ``mx.nd`` inside ``train_section`` on the card: the gradients from
    ``mx.autograd.backward`` against the Executor's of the same symbol,
    TF32 off, cuDNN deterministic, within FWD_TOL of the largest |g|."""
    import numpy as np
    import torch
    print(_tf32(False) + " (autograd phase)")
    b, c, m, hw = (BOTTLENECK[k] for k in ("batch", "channels", "mid", "hw"))
    rs = np.random.RandomState(SEED + 6)
    vals = {"data": rs.randn(b, c, hw, hw),
            "w1": rs.randn(m, c, 1, 1) * np.sqrt(2.0 / c),
            "w2": rs.randn(m, m, 3, 3) * np.sqrt(2.0 / (9 * m)),
            "w3": rs.randn(c, m, 1, 1) * np.sqrt(2.0 / m)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}

    def block(F, x, w1, w2, w3):
        h = F.Convolution(F.Activation(x, act_type="relu"), w1,
                          kernel=(1, 1), num_filter=m, no_bias=True)
        h = F.Convolution(F.Activation(h, act_type="relu"), w2,
                          kernel=(3, 3), pad=(1, 1), num_filter=m,
                          no_bias=True)
        h = F.Convolution(F.Activation(h, act_type="relu"), w3,
                          kernel=(1, 1), num_filter=c, no_bias=True)
        return F._plus(h, x)

    names = list(vals)
    cells = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in vals.items()}
    grads = {k: mx.nd.zeros(v.shape, ctx=mx.gpu(0)) for k, v in vals.items()}
    mx.autograd.mark_variables([cells[k] for k in names],
                               [grads[k] for k in names])
    t0 = time.perf_counter()
    with _deterministic():
        with mx.autograd.train_section():
            out = block(mx.nd, *[cells[k] for k in names])
        mx.autograd.backward(out)
        torch.cuda.synchronize()
    t_ag = time.perf_counter() - t0
    sym = block(mx.sym, *[mx.sym.var(k) for k in names])
    exe = sym.simple_bind(mx.gpu(0), **{k: v.shape for k, v in vals.items()})
    for k, v in vals.items():
        exe.arg_dict[k][:] = v
    t0 = time.perf_counter()
    with _deterministic():
        exe.forward(is_train=True)
        exe.backward([mx.nd.array(np.ones(out.shape, np.float32),
                                  ctx=mx.gpu(0))])
        torch.cuda.synchronize()
    t_exe = time.perf_counter() - t0
    out_err = float(np.abs(out.asnumpy() - exe.outputs[0].asnumpy()).max())
    worst, worst_k = _grads_close({k: grads[k].asnumpy() for k in names},
                                  {k: exe.grad_dict[k].asnumpy()
                                   for k in names})
    print(f"autograd: bottleneck {b}x{c}x{hw}x{hw}: output max |diff| "
          f"{out_err:.3g}, max gradient difference {worst:.3g} of the "
          f"largest |g| "
          f"({worst_k}; limit {FWD_TOL}) against the Executor; first "
          f"forward+backward {1e3 * t_ag:.1f} ms imperative, "
          f"{1e3 * t_exe:.1f} ms Executor")
    if worst > FWD_TOL or out_err > FWD_TOL:
        raise AssertionError("autograd disagrees with the Executor")


# --------------------------------------------------------------------------
# phases 35-37: transformer-LM training in bfloat16 (compute_dtype)
# --------------------------------------------------------------------------
def phase_lm_bf16_train(mx, ck, half="bfloat16"):
    """The bench-width LM through Module(compute_dtype=...).fit on gpu(0)
    in float32 and in bfloat16, in turns (float32, bfloat16, bfloat16,
    float32; LM_STEPS batches each, phase 9's data, Xavier seed and SGD,
    telemetry on): tokens/s, p50/p99 step ms, peak memory and the MFU
    readings of each; every bfloat16 step launches exactly
    LM_BF16_PER_STEP and no float32 instance; one cast per parameter per
    step (the tied embedding table once); the bound cells float32.
    Returns (the bfloat16 fits' launch counts, {dtype: (module,
    iterator)} of the last fit of each)."""
    sfx = HALF_SFX[half]
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(True) + f" (PyTorch's default, for the LM {sfx} training "
          "phase)")
    stats = {"float32": [], half: []}
    counts, mods = {}, {}
    for turn, dtype in enumerate(("float32", half, half,
                                  "float32")):
        mods.pop(dtype, None)
        torch.cuda.empty_cache()
        it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, LM_STEPS, seed=SEED)
        mod = mx.mod.Module(_lm_symbol(LM_SEQ), context=mx.gpu(0),
                            compute_dtype=None if dtype == "float32"
                            else dtype)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        label = f"lm {dtype} train (turn {turn + 1})"
        got = {}
        mx.executor.reset_cast_counts()
        fit_counts, per_step = _fit_phase(
            mx, ck, mod, it, label, LM_BATCH * LM_SEQ, "tokens",
            ("lm_tok_embed_weight", "lm_l0_qkv_weight", "lm_l0_ln1_beta",
             f"lm_l{N_LAYER - 1}_ffn2_weight", "lm_ln_f_gamma"), into=got,
            optimizer="sgd", optimizer_params=LM_SGD)
        stats[dtype].append(got)
        casts = mx.executor.cast_counts()["casts"] / LM_STEPS
        n_params = len(mod.get_params()[0])
        if dtype == half:
            want = {k: _halved(LM_BF16_PER_STEP, half).get(k, 0)
                    for k in per_step}
            print(f"{label}: {casts:.1f} casts per step for {n_params} "
                  "parameters (the tied embedding table read twice, cast "
                  "once)")
            if per_step != want:
                raise AssertionError(f"{label}: launches per step "
                                     f"{per_step}, want {want}")
            if casts != n_params:
                raise AssertionError(f"{label}: {casts} casts per step, "
                                     f"want {n_params}")
            for k, v in fit_counts.items():
                counts[k] = counts.get(k, 0) + v
        elif per_step != {k: LM_PER_STEP.get(k, 0) for k in per_step} \
                or casts:
            raise AssertionError(f"{label}: launches per step {per_step}, "
                                 f"casts {casts}")
        _bf16_cells(label, mod)
        mods[dtype] = (mod, it)
    summary = {k: [f"{g['rate']:.1f} tokens/s, p50 {g['p50']:.2f} ms, p99 "
                   f"{g['p99']:.2f} ms, peak {g['peak']:.2f} GiB"
                   for g in v] for k, v in stats.items()}
    ratio = (sum(g["rate"] for g in stats[half]) /
             sum(g["rate"] for g in stats["float32"]))
    print(f"lm {sfx} train: in turns (float32, {half}, {half}, float32):"
          f" {summary}; {half} / float32 tokens/s = {ratio:.3f}")
    return counts, mods


def phase_lm_bf16_parity(mx, half="bfloat16", n_head=N_HEAD,
                         n_layer=N_LAYER, seq=LM_PARITY_SEQ):
    """One bfloat16 SGD step of the LM at full width, batch 2, T=128, on
    the card and on the CPU from phase 10's parameters and batch, TF32
    off, beside the CPU's float32 step: the probabilities, every gradient
    and every weight's update (updated weight less the start) of the card
    within BF16_SPREAD times the CPU's own bfloat16-vs-float32 distance
    of that array, plus one bfloat16 ulp of the array's largest magnitude
    (one rounding that lands the other way on one element near the
    largest, which a bfloat16 sum of near-cancelling terms can show where
    bfloat16 and float32 happen to agree). The losses are printed."""
    sfx = HALF_SFX[half]
    import numpy as np
    print(_tf32(False) + f" (LM {sfx} parity phase, {n_head} heads, "
          f"{n_layer} layers, T={seq})")
    sym, params, batch = _lm_parity_start(mx, n_head, n_layer, seq)
    t0 = time.perf_counter()
    cpu = _lm_step(mx, sym, params, mx.cpu(), batch, half)
    cpu32 = _lm_step(mx, sym, params, mx.cpu(), batch)
    t_cpu = time.perf_counter() - t0
    card = _lm_step(mx, sym, params, mx.gpu(0), batch, half)
    label = batch.label[0].asnumpy().astype(np.int64)
    rows = np.arange(len(label))
    loss = [float(-np.log(r[0][rows, label] + 1e-8).mean())
            for r in (card, cpu, cpu32)]

    def ratio(a, b, own):
        top = float(np.abs(b).max())
        bits, emin = HALF_BITS[half]
        ulp = 2.0 ** (np.floor(np.log2(max(top, 2.0 ** emin))) - bits)
        return float(np.abs(a - b).max()) / (BF16_SPREAD * own + ulp)
    for r in (card, cpu, cpu32):                # updates, not weights
        r[2].update({k: w - params[k] for k, w in r[2].items()})
    worst = {"prob": (ratio(card[0], cpu[0],
                            float(np.abs(cpu[0] - cpu32[0]).max())), "prob")}
    for i, what in ((1, "gradient"), (2, "update")):
        worst[what] = max(
            (ratio(card[i][k], cpu[i][k],
                   float(np.abs(cpu[i][k] - cpu32[i][k]).max())), k)
            for k in cpu[i])
    print(f"lm {sfx} parity ({n_head} heads, {n_layer} layers): one step"
          f" at batch {LM_PARITY_BATCH}, T="
          f"{seq} (two CPU steps {t_cpu:.1f} s): loss card "
          f"{loss[0]:.6f} cpu {sfx} {loss[1]:.6f} cpu float32 {loss[2]:.6f}; "
          f"worst of its limit (BF16_SPREAD {BF16_SPREAD} x the CPU's "
          f"{half}-vs-float32 distance + one {sfx} ulp of the array's max):"
          f" {worst}; {len(cpu[1])} gradients")
    if not (all(r <= 1.0 for r, _ in worst.values()) and
            np.isfinite(card[0]).all() and np.isfinite(loss[0])):
        raise AssertionError("bf16 card and CPU LM steps disagree beyond "
                             f"{half}'s own spread")


def phase_lm_bf16_profile(mx, mods, steps=2):
    """LM training steps of phase 35's float32 and bfloat16 modules under
    the profiler in turns (float32, bfloat16, bfloat16, float32;
    ``steps`` each): wall, device busy, launches, device time by group
    (the port's kernels / cuBLAS / PyTorch elementwise / the casts /
    copies), the casts per step, and the rate the cuBLAS group reaches
    over the step's matmul flops; then the bfloat16 step's kernels that
    take the most device time (phase 11's listing)."""
    print(_tf32(True) + " (LM bf16 profile phase)")
    batches = {}
    for dtype, (mod, it) in mods.items():
        it.reset()
        batches[dtype] = next(iter(it))
    runs = {"float32": [], "bfloat16": []}
    casts = {}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        mod = mods[dtype][0]

        def step(m=mod, b=batches[dtype]):
            m.forward_backward(b)
            m.update()
        mx.executor.reset_cast_counts()
        runs[dtype].append(_profiled(step, steps, group=_decode_group))
        casts[dtype] = mx.executor.cast_counts()["casts"] / (steps + 1)
    _print_profiles("lm bf16 profile", runs, steps)
    flops = _lm_gemm_flops()
    for dtype, rr in runs.items():
        lib = sum(r[3].get("cuBLAS", (0.0, 0))[0] for r in rr) / len(rr)
        rate = flops / (lib / 1e3)
        print(f"lm bf16 profile: {dtype}: {casts[dtype]:.1f} casts per step;"
              f" the matmuls' {flops / 1e12:.3f} TFLOP per step over the "
              f"cuBLAS group's {lib:.3f} ms = {rate / 1e12:.1f} TFLOP/s "
              f"({100 * rate / BF16_FLOPS_PER_S:.1f}% of the bf16 peak)")
    phase_train_profile(*mods["bfloat16"], steps=steps,
                        label="lm bf16 profile, kernels")


def _frozen_step(mx, sym, params, batch, compute_dtype, grad_req):
    """One forward/backward of the LM on gpu(0) from ``params`` under
    ``grad_req``, then one SGD update: ({name: gradient} of the trained
    parameters, numpy float32; the launches of the forward/backward; the
    parameters after)."""
    ctx = mx.gpu(0)
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(batch.provide_data, batch.provide_label, grad_req=grad_req)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params, ctx))
    mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    mod.forward_backward(batch)
    counts = ck.launch_counts()
    grads = {k: v.asnumpy() for k, v in
             mod._exec_group.executor.grad_dict.items()}
    mod.update()
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return grads, counts, after


def phase_lm_frozen(mx, ck):
    """Fine-tuning with frozen parameters, the path of the LayerNorm
    backward's single-half wrappers: the bench LM at full width cut to
    FROZEN_LAYERS layers, T=1024, batch 8 (the LM cell's 8192 rows), with
    the embedding table and the gamma / beta of every LayerNorm but the
    first frozen (``bind(grad_req=...)``, "null"), in float32, bfloat16
    and float16. One step each: exactly 2L ``layernorm_bwd_dx`` and one
    ``layernorm_bwd_dparams`` launch and no ``layernorm_bwd``; every
    trained parameter's gradient within FROZEN_GRAD_RTOL of the same
    step with every parameter trained (which launches ``layernorm_bwd``
    2L + 1 times); the frozen parameters unmoved, the trained ones moved.
    Returns {counter: launches} of the single-half wrappers' counters in
    the frozen steps."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(False) + " (frozen fine-tuning phase)")
    sym = tfm.get_symbol(vocab_size=V, d_model=D, n_layer=FROZEN_LAYERS,
                         n_head=N_HEAD, seq_len=LM_SEQ)
    shapes, _, _ = sym.infer_shape(data=(LM_BATCH, LM_SEQ),
                                   softmax_label=(LM_BATCH * LM_SEQ,))
    rs = np.random.RandomState(SEED + 8)
    params = {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                  else 0.02 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    batch = next(iter(tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, 1,
                                          seed=SEED + 9)))
    norms = [n for n in params if n.endswith(("_gamma", "_beta"))]
    frozen = {n for n in params if "embed" in n} | {
        n for n in norms if not n.startswith("lm_l0_ln1_")}
    req = {n: "null" if n in frozen else "write" for n in params}
    total = {}
    for dtype in ("float32",) + tuple(HALF_SFX):
        sfx = "" if dtype == "float32" else "_" + HALF_SFX[dtype]
        cd = None if dtype == "float32" else dtype
        full, full_counts, _ = _frozen_step(mx, sym, params, batch, cd,
                                            "write")
        grads, counts, after = _frozen_step(mx, sym, params, batch, cd, req)
        names = {"ln_bwd": "layernorm_bwd", "ln_bwd_dx": "layernorm_bwd_dx",
                 "ln_bwd_dparams": "layernorm_bwd_dparams"}
        key = {k: (k if not sfx else names[k] + sfx) for k in names}
        got = {k: counts[key[k]] for k in names}
        want = {"ln_bwd": 0, "ln_bwd_dx": 2 * FROZEN_LAYERS,
                "ln_bwd_dparams": 1}
        worst, same = (0.0, ""), True
        for k, g in grads.items():
            ratio = float(np.abs(g - full[k]).max()) / (
                FROZEN_GRAD_RTOL * float(np.abs(full[k]).max()) + 1e-30)
            worst = max(worst, (ratio, k))
            same = same and np.array_equal(g, full[k])
        still = max(float(np.abs(after[k] - params[k]).max())
                    for k in frozen)
        moved = min(float(np.abs(after[k] - params[k]).max())
                    for k in params if k not in frozen)
        print(f"lm frozen {dtype}: {FROZEN_LAYERS} layers, ({LM_BATCH}, "
              f"{LM_SEQ}), {len(frozen)} of {len(params)} parameters frozen:"
              f" LayerNorm backward launches {got} (want {want}; the full "
              f"step: {key['ln_bwd']} {full_counts[key['ln_bwd']]}); "
              f"{len(grads)} gradients against the full step's: bit for bit"
              f" {same}, worst {worst[1]} {worst[0]:.3g} of its limit "
              f"({FROZEN_GRAD_RTOL} x its max |g|); frozen moved by "
              f"{still:.3g}, trained by at least {moved:.3g}")
        if not (got == want and full_counts[key["ln_bwd"]] ==
                2 * FROZEN_LAYERS + 1 and worst[0] <= 1.0 and still == 0.0
                and moved > 0 and set(grads) == set(params) - frozen):
            raise AssertionError(f"lm frozen {dtype}: launches {got}, "
                                 f"gradients {worst}, frozen moved {still}")
        for k in ("ln_bwd_dx", "ln_bwd_dparams"):
            total[key[k]] = got[k]
    return total


def _dh32_teacher_forced(mx, sym, params, stream, half, label="dh32"):
    """``stream`` teacher-forced through the decode graph ``sym`` on the
    card and on the CPU (in ``half``, or float32 for None): (the worst
    |logit card - cpu|, the worst of it over its limit). Float32 is held
    to LOGIT_TOL, a 16-bit type to HALF_LOGIT_TOL (atol and rtol); every
    token past the prompt must be the CPU's argmax or a near-tie."""
    import numpy as np
    gpu, cpu = (_decoder(mx, sym, params, ctx, compute_dtype=half)
                for ctx in (mx.gpu(0), mx.cpu()))
    for d in (gpu, cpu):
        d.join(0)
    worst = ratio = 0.0
    for i, tok in enumerate(stream[:-1]):
        a, b = (d.step(np.asarray([[tok]])).asnumpy()[0, 0]
                for d in (gpu, cpu))
        if a.shape != (V,) or not np.isfinite(a).all():
            raise AssertionError(f"{label} step {i}: logits {a.shape} not "
                                 "finite")
        if half:
            w, r = _bf16_within(a, b, half)
            near = 2 * HALF_LOGIT_TOL[half] * (1 + abs(float(b.max())))
        else:
            w = float(np.abs(a - b).max())
            r, near = w / LOGIT_TOL, LOGIT_TOL
        worst, ratio = max(worst, w), max(ratio, r)
        if i >= PROMPT - 1 and b[stream[i + 1]] < b.max() - near:
            raise AssertionError(f"{label}: served token {stream[i + 1]} "
                                 f"at step {i} is not the CPU argmax "
                                 f"{int(b.argmax())} nor a near-tie")
    return worst, ratio


def phase_headdim32(mx, ck, params, prompts):
    """Phase 50: the bench LM over DH32_HEADS heads (d_model 512, Dh 32)
    through the port's entry points on the card. serve_decoder in float32
    and bfloat16 with phase 3's prompts and arrivals (rungs 1 -> 4 -> 8)
    and phase 3's parameters (a head count leaves the parameters' shapes
    alone): exact launches a dispatch, request 0's stream teacher-forced
    card vs CPU within LOGIT_TOL / HALF_LOGIT_TOL; Module.fit in float32
    and bfloat16 at T 1024, batch 8, DH32_STEPS SGD steps each, exact
    launches a step; one step card vs CPU at batch 2, T 128 in float32
    (GRAD_RTOL) and bfloat16 (BF16_SPREAD); the sequence-parallel fit
    (MeshConfig(seq=4)) at RING_HALF_LAYERS layers against the unsharded
    fit (RING_LOSS_TOL / RING_WEIGHT_TOL). Every counter is set to 0 just
    before each run and read just after; returns the Dh 32 runs' launches
    of DH32_KERNELS, each of which must be launched."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    heads = DH32_HEADS
    print(_tf32(False) + f" (head dim {D // heads}: {heads} heads)")
    total = dict.fromkeys(DH32_KERNELS, 0)
    sym = _gen(n_head=heads)(1)
    for cd in (None, "bfloat16"):
        label = f"dh32 serve {cd or 'float32'}"
        sfx = "" if cd is None else "_" + HALF_SFX[cd]
        t0 = time.perf_counter()
        sched = mx.serve.serve_decoder(
            sym, mx.convert.params_from_numpy(params, mx.gpu(0)),
            name=f"lm-dh32-{cd or 'float32'}", capacity=CAP, ladder=LADDER,
            context=mx.gpu(0), default_max_new=NEW, compute_dtype=cd)
        warm_s = time.perf_counter() - t0
        ck.reset_launch_counts()
        outs, wall = _serve_waves(sched, prompts)
        counts, st = ck.launch_counts(), sched.stats()
        n_tok = sum(len(o) for o in outs)
        print(f"{label}: built and warmed in {warm_s:.2f} s; {n_tok} tokens "
              f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; iteration "
              f"ms {st['step_ms']}; {st['iterations']} iterations, "
              f"{st['migrations']} migrations")
        _check_served(outs, st)
        _decode_launches(label, counts, st["iterations"],
                         read="decode_attention" + sfx, suffix=sfx)
        total["decode_attention" + sfx] += counts["decode_attention" + sfx]
        stream = prompts[0] + outs[0][:8].tolist()
        worst, ratio = _dh32_teacher_forced(mx, sym, params, stream, cd)
        print(f"{label}: teacher-forced {len(stream) - 1} steps: max "
              f"|logit card - cpu| = {worst:.3g}, {ratio:.3f} of the limit "
              f"({HALF_LOGIT_TOL[cd] if cd else LOGIT_TOL})")
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: card and CPU logits disagree")
    print(_tf32(True) + " (PyTorch's default, for the Dh 32 LM fits)")
    for cd in (None, "bfloat16"):
        label = f"dh32 lm {cd or 'float32'} train"
        torch.cuda.empty_cache()
        it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, DH32_STEPS, seed=SEED)
        mod = mx.mod.Module(_lm_symbol(LM_SEQ, heads), context=mx.gpu(0),
                            compute_dtype=cd)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        counts, per_step = _fit_phase(
            mx, ck, mod, it, label, LM_BATCH * LM_SEQ, "tokens",
            ("lm_tok_embed_weight", "lm_l0_qkv_weight", "lm_ln_f_gamma"),
            optimizer="sgd", optimizer_params=LM_SGD)
        want = LM_PER_STEP if cd is None else _halved(LM_BF16_PER_STEP, cd)
        want = {k: want.get(k, 0) for k in per_step}
        if per_step != want:
            raise AssertionError(f"{label}: launches per step {per_step}, "
                                 f"want {want}")
        name = "flash_attention" + ("" if cd is None else
                                    "_" + HALF_SFX[cd])
        total[name] += counts[name]
        del mod
    phase_lm_parity(mx, heads)
    phase_lm_bf16_parity(mx, "bfloat16", heads)
    print(_tf32(False) + " (Dh 32 sequence-parallel fit)")
    rsym, rparams = _ring_start(RING_HALF_LAYERS, heads)
    runs = {ring: _ring_fit(mx, ck, rsym, rparams,
                            "dh32 ring fit " + ("ring" if ring
                                                else "unsharded"), ring)
            for ring in (False, True)}
    _ring_launches("dh32 ring fit ring", runs[True][1], RING_HALF_LAYERS)
    (_, _, loss0, p0, _), (counts, _, loss1, p1, _) = runs[False], \
        runs[True]
    loss_err = float(np.abs(loss1 - loss0).max())
    worst = max((float(np.abs(p1[k] - p0[k]).max()), k) for k in p0)
    print(f"dh32 ring fit: losses unsharded {loss0.tolist()} ring "
          f"{loss1.tolist()}: max |diff| {loss_err:.3g} (limit "
          f"{RING_LOSS_TOL}); worst parameter {worst[1]}: |ring - "
          f"unsharded| = {worst[0]:.3g} (limit {RING_WEIGHT_TOL})")
    if not (loss_err <= RING_LOSS_TOL and worst[0] <= RING_WEIGHT_TOL):
        raise AssertionError("the Dh 32 ring fit and the unsharded fit "
                             "disagree")
    total["flash_attention_partial"] += counts["flash_attention_partial"]
    print(f"dh32: the Dh 32 runs' launches {total}")
    idle = [k for k, n in total.items() if not n > 0]
    if idle:
        raise AssertionError(f"Dh 32 kernels not launched: {idle}")
    return total


def _headdim_params(sym, seed, **shapes):
    """Numpy-seeded parameters of ``sym`` at ``shapes`` (the LM parity
    phase's recipe)."""
    import numpy as np
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                else 0.02 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _headdim_fit(mx, ck, sym, params, ctx, compute_dtype=None, mesh=None):
    """HEADDIM_STEPS SGD batches of ``sym`` from ``params`` on ``ctx`` (a
    context list and ``mesh`` for the sequence-parallel fit): (the launch
    counts, the parameters after, numpy)."""
    from mxnet_tpu_torch.models import transformer as tfm
    it = tfm.SyntheticLMIter(V, HEADDIM_BATCH, HEADDIM_SEQ, HEADDIM_STEPS,
                             seed=SEED + 9)
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(it.provide_data, it.provide_label, spmd=mesh is not None,
             mesh=mesh)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params,
                                                            mx.gpu(0)))
    ck.reset_launch_counts()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=LM_SGD)
    counts = ck.launch_counts()
    return counts, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_headdims(mx, ck, prompts):
    """Phase 51: for each Dh of HEADDIMS a HEADDIM_LAYERS-layer LM at
    d_model 8 Dh over 8 heads (V 32000), numpy-seeded, through the
    port's entry points on the card: ``serve_decoder`` in float32 and
    bfloat16 (4 of phase 3's prompts, ladder [1, 4], 8 new tokens each;
    the decode read's instance of the type must launch), the float32
    stream of request 0 teacher-forced card vs CPU (LOGIT_TOL);
    ``Module.fit`` in float32 and bfloat16 (T HEADDIM_SEQ, batch
    HEADDIM_BATCH, HEADDIM_STEPS batches, exactly HEADDIM_LAYERS flash
    launches of the type a step); one float32 step card vs CPU at batch
    2 (phase 10's limits); the sequence-parallel fit against the
    unsharded one in float32 (phase 46's weight limit, L x 10 partial
    launches a step). Every counter is set to 0 just before each run and
    read just after; returns the runs' launches of DH32_KERNELS, each of
    which must be launched at every Dh."""
    import torch
    total = dict.fromkeys(DH32_KERNELS, 0)
    for dh in HEADDIMS:
        for k, n in _headdim_lm(mx, ck, prompts, dh).items():
            total[k] += n
        torch.cuda.empty_cache()
    return total


def _headdim_lm(mx, ck, prompts, dh):
    """Phase 51's runs for one head dim ``dh`` (its docstring); returns
    the runs' launches of DH32_KERNELS, each of which must be launched."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import MeshConfig
    from mxnet_tpu_torch.serve import FakeClock
    t_dh = time.perf_counter()
    seen = dict.fromkeys(DH32_KERNELS, 0)
    d_model, heads = 8 * dh, 8
    print(_tf32(False) + f" (head dim {dh}: d_model {d_model})")
    dsym = tfm.get_decode_symbol(vocab_size=V, d_model=d_model,
                                 n_layer=HEADDIM_LAYERS, n_head=heads,
                                 capacity=CAP, per_slot=True)
    dparams = _headdim_params(dsym, SEED + dh, data=(1, 1))
    for cd in (None, "bfloat16"):
        sfx = "" if cd is None else "_" + HALF_SFX[cd]
        sched = mx.serve.serve_decoder(
            dsym, mx.convert.params_from_numpy(dparams, mx.gpu(0)),
            name=f"lm-dh{dh}-{cd or 'float32'}", capacity=CAP,
            ladder=[1, 4], context=mx.gpu(0), clock=FakeClock(),
            start=False, compute_dtype=cd)
        ck.reset_launch_counts()
        hs = [sched.submit(p[:8], max_new_tokens=8) for p in prompts[:4]]
        sched.pump()
        outs = [h.result(timeout=0) for h in hs]
        counts = ck.launch_counts()
        if any(len(o) != 8 or not ((o >= 0) & (o < V)).all()
               for o in outs):
            raise AssertionError(f"dh{dh} serve: {outs}")
        seen["decode_attention" + sfx] += counts["decode_attention" + sfx]
        if cd is None:
            stream = prompts[0][:8] + outs[0][:4].tolist()
            worst, ratio = _dh32_teacher_forced(
                mx, dsym, dparams, stream, None, label=f"dh{dh}")
            print(f"dh{dh} serve float32: teacher-forced "
                  f"{len(stream) - 1} steps: max |logit card - cpu| = "
                  f"{worst:.3g}, {ratio:.3f} of the limit ({LOGIT_TOL})")
            if not ratio <= 1.0:
                raise AssertionError(f"dh{dh}: card and CPU logits "
                                     "disagree")
    sym = tfm.get_symbol(V, d_model, HEADDIM_LAYERS, heads, HEADDIM_SEQ)
    params = _headdim_params(sym, SEED + dh + 1,
                             data=(HEADDIM_BATCH, HEADDIM_SEQ),
                             softmax_label=(HEADDIM_BATCH * HEADDIM_SEQ,))
    runs = {}
    for cd in (None, "bfloat16"):
        sfx = "" if cd is None else "_" + HALF_SFX[cd]
        counts, after = _headdim_fit(mx, ck, sym, params, mx.gpu(0), cd)
        runs[cd] = after
        want = HEADDIM_STEPS * HEADDIM_LAYERS
        if counts["flash_attention" + sfx] != want or \
                counts["flash_attention_partial" + sfx] != 0:
            raise AssertionError(f"dh{dh} fit {cd}: flash launches "
                                 f"{counts['flash_attention' + sfx]}, "
                                 f"want {want}")
        if not all(np.isfinite(v).all() for v in after.values()) or \
                not np.abs(after["lm_l0_qkv_weight"] -
                           params["lm_l0_qkv_weight"]).max() > 0:
            raise AssertionError(f"dh{dh} fit {cd}: parameters not "
                                 "finite or not moved")
        seen["flash_attention" + sfx] += counts["flash_attention" + sfx]
    # one float32 step card vs CPU at batch 2
    batch = next(iter(tfm.SyntheticLMIter(V, 2, HEADDIM_SEQ, 1,
                                          seed=SEED + 10)))
    cpu = _lm_step(mx, sym, params, mx.cpu(), batch)
    gpu = _lm_step(mx, sym, params, mx.gpu(0), batch)
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    worst_g = max(float(np.abs(gpu[1][k] - g).max()) /
                  (GRAD_RTOL * float(np.abs(g).max()) + 1e-12)
                  for k, g in cpu[1].items())
    worst_w = max(float(np.abs(gpu[2][k] - w).max())
                  for k, w in cpu[2].items())
    # the sequence-parallel fit against the unsharded one, float32
    counts, ring = _headdim_fit(mx, ck, sym, params,
                                [mx.gpu(0)] * RING_SHARDS,
                                mesh=MeshConfig(seq=RING_SHARDS))
    want = HEADDIM_STEPS * HEADDIM_LAYERS * RING_PER_LAYER
    ring_err = max(float(np.abs(ring[k] - v).max())
                   for k, v in runs[None].items())
    seen["flash_attention_partial"] += counts["flash_attention_partial"]
    # one partial call: a query shard against a key shard, float32; q, k,
    # v read and (acc, m, l) written once, 4 Tq Tk Dh operations a (b, h)
    tq = HEADDIM_SEQ // RING_SHARDS
    rows = HEADDIM_BATCH * heads * tq
    bound = _bound_ms(4 * (4 * rows * dh + 2 * rows),
                      4 * HEADDIM_BATCH * heads * tq * tq * dh)
    print(f"dh{dh}: ring partial call ({HEADDIM_BATCH}, {heads}, {tq} "
          f"queries x {tq} keys, Dh {dh}) float32 bound "
          f"{bound[0]:.6f} ms ({bound[1]})")
    print(f"dh{dh}: step card vs CPU max |prob| {prob_err:.3g} (limit "
          f"{FWD_TOL}), worst gradient {worst_g:.3g} of its limit, "
          f"worst weight {worst_w:.3g} (limit {LM_WEIGHT_TOL}); ring "
          f"fit: partial launches {counts['flash_attention_partial']} "
          f"(want {want}), flash {counts['flash_attention']}, worst "
          f"|ring - unsharded| weight {ring_err:.3g} (limit "
          f"{RING_WEIGHT_TOL}); launches {seen}; "
          f"{time.perf_counter() - t_dh:.1f} s")
    if not (prob_err <= FWD_TOL and worst_g <= 1.0 and
            worst_w <= LM_WEIGHT_TOL):
        raise AssertionError(f"dh{dh}: card and CPU LM steps disagree")
    if counts["flash_attention_partial"] != want or \
            counts["flash_attention"] or not ring_err <= RING_WEIGHT_TOL:
        raise AssertionError(f"dh{dh}: the ring fit")
    idle = [k for k, n in seen.items() if not n > 0]
    if idle:
        raise AssertionError(f"Dh {dh}: kernels not launched: {idle}")
    return seen


def _seg_fit(mx, ck, ctx, X, Y, params):
    """SEG_STEPS SGD batches of the segmentation net on ``ctx`` from
    ``params``, scored by pixel accuracy (argmax over axis 1 against a
    label a position): (launch counts, parameters after, numpy)."""
    import torch

    class PixelAccuracy(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("pixel-accuracy")

        def update(self, labels, preds):
            for label, pred in zip(labels, preds):
                lab = label.astorch().to(torch.int64)
                hit = pred.astorch().argmax(1).to(lab.device) == lab
                self._accumulate(hit.sum(), lab.numel())
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                             name="c1")
    net = mx.sym.LayerNorm(net, axis=1, name="ln1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Convolution(net, num_filter=SEG_CLASSES, kernel=(1, 1),
                             name="c2")
    sym = mx.sym.SoftmaxOutput(net, multi_output=True, use_ignore=True,
                               ignore_label=0, normalization="valid",
                               name="softmax")
    it = mx.io.NDArrayIter(X, Y, batch_size=SEG_BATCH)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params, ctx),
                    aux_params={})
    ck.reset_launch_counts()
    mod.fit(it, num_epoch=1, eval_metric=PixelAccuracy(),
            optimizer="sgd", optimizer_params={"learning_rate": 0.05,
                                               "momentum": 0.9})
    return ck.launch_counts(), {k: v.asnumpy()
                                for k, v in mod.get_params()[0].items()}


def _refused_rows(ck):
    """Device ms (L2 flushed) of the routes phase 52 adds, at shapes a
    path gives them, beside their bound and the one PyTorch call that
    computes the same function (SDPA with the same mask, torch.softmax,
    native_layer_norm_backward), as lines "refused rows: ..."."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.rtc import fp8_cast
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def line(label, fn, nbytes, flops, peak, lib=None):
        ms = _device_ms(fn)
        bound, by = _bound_ms(nbytes, flops, peak)
        lib_ms = None if lib is None else _device_ms(lib)
        print(f"refused rows: {label}: device {ms:.6f} ms, bound "
              f"{bound:.6f} ({by}), {ms / bound:.2f}x; library "
              + ("None" if lib_ms is None else
                 f"{lib_ms:.6f} ms (the kernel {ms / lib_ms:.2f}x)"))

    def decode(dh, S, dtype, cache=None):
        B, H, C = 8, 8, CAP
        q = rnd(B, H, S, dh, dtype=dtype)
        kc, vc = rnd(B, H, C, dh, dtype=dtype), rnd(B, H, C, dh, dtype=dtype)
        if cache is not None:
            kc, vc = fp8_cast(kc, cache), fp8_cast(vc, cache)
        pos = torch.full((B,), C - S, dtype=torch.int32, device=dev)
        live = (torch.arange(C, device=dev)[None, :] <=
                (C - S + torch.arange(S, device=dev))[:, None])
        el = kc.element_size()
        nbytes = 2 * B * H * C * dh * el + B * H * S * dh * (
            q.element_size() + 4)
        lib = None if cache is not None else (
            lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                   attn_mask=live))
        route = ck.decode_route(dh, S, el, kc.data_ptr(), vc.data_ptr())
        line(f"decode_attention Dh {dh} S {S} {kc.dtype} (8 x 8 rows, C "
             f"{C}, route {route})",
             lambda: ck.decode_attention(q, kc, vc, pos), nbytes,
             4 * B * H * int(live.sum()) * dh,
             F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S,
             lib)

    for dh in (40, 256):
        decode(dh, 1, torch.float32)
        decode(dh, 1, torch.bfloat16)
        decode(dh, 1, torch.float32, torch.float8_e4m3fn)
    decode(64, 128, torch.float32)
    decode(64, 128, torch.bfloat16)

    def flash(B, H, tq, tk, dh, dtype, causal=True):
        q = rnd(B, H, tq, dh, dtype=dtype)
        k, v = rnd(B, H, tk, dh, dtype=dtype), rnd(B, H, tk, dh, dtype=dtype)
        live = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
        visible = int(live.sum()) if causal else tq * tk
        el = q.element_size()
        nbytes = B * H * (2 * tq + 2 * tk) * dh * el
        line(f"flash_attention {B}x{H} Tq {tq} Tk {tk} Dh {dh} {dtype} "
             f"causal {causal}",
             lambda: ck.flash_attention(q, k, v, causal), nbytes,
             4 * B * H * visible * dh,
             F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S,
             lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=live if causal else None))
        return q, k, v

    for dtype in (torch.float32, torch.bfloat16):
        flash(8, 8, 1024, 1024, 40, dtype)
        flash(2, 8, 1024, 1024, 256, dtype)
        flash(8, 8, 512, 1024, 64, dtype)
        flash(4096, 16, 8, 8, 64, dtype)
    q, k, v = flash(8, 8, 1024, 1024, 20, torch.bfloat16)
    pad = _device_ms(lambda: ck._flash_operands(q, k, v))
    print(f"refused rows: the zero-padded copy of bfloat16 q, k, v (8, 8, "
          f"1024, 20 -> 24) alone: device {pad:.6f} ms")
    for dtype in (torch.float32, torch.bfloat16):
        x = 4 * rnd(8192, BIG_V, dtype=dtype)
        el = x.element_size()
        line(f"softmax (8192, {BIG_V}) {dtype} (streaming route)",
             lambda: ck.softmax(x), 2 * x.numel() * el, 4 * x.numel(),
             F32_FLOPS_PER_S, lambda: torch.softmax(x, -1))
        del x
        n, c = 256, 131072
        x, ct = rnd(n, c, dtype=dtype), rnd(n, c, dtype=dtype)
        g = rnd(c, dtype=dtype)
        _, mean, rstd = ck.layernorm_plain(x, g, g, 1e-5)
        _, lm, lr = torch.ops.aten.native_layer_norm(x, (c,), g, g, 1e-5)
        line(f"ln_bwd ({n}, {c}) {dtype} (walked route)",
             lambda: ck.layernorm_bwd(x, g, ct, mean, rstd),
             (3 * n * c + 3 * c) * el + 8 * n, 11 * n * c, F32_FLOPS_PER_S,
             lambda: torch.ops.aten.native_layer_norm_backward(
                 ct, x, (c,), lm, lr, g, g, [True, True, True]))
        del x, ct
    torch.cuda.empty_cache()


def phase_refused_inputs(mx, ck, prompts, params, cpu_ref, q_mod):
    """Phase 52: inputs the JAX package runs that the port's kernels once
    refused on the card, through the public entry points on gpu(0), each
    against the CPU or the plain version: LMs at Dh 40 and 256 (phase
    51's runs: ``serve_decoder``, ``Module.fit``, the ring fit, one step
    card vs CPU); ``serve_decoder(prefill_chunk=128)`` at capacity 256
    (the S = 128 windows' greedy chains against chunk 1's, or a
    near-tie); an LM fit over V 128256 (the streaming softmax, one step
    card vs CPU); a ``multi_output`` + ``LayerNorm(axis=1)`` net through
    ``Module.fit`` card vs CPU; the fp8 ResNet-50 under
    ``compute_dtype="bfloat16"`` through an ``InferenceServer`` (the e4m3
    instances launch; centered logits within BF16_SPREAD of the CPU's
    own bfloat16 distance); ``mx.nd.attention`` with Tq != Tk and over
    B*H 65536 card vs CPU. Every counter is set to 0 just before each run
    and read just after. Then the new routes' device times
    (``_refused_rows``). Returns {counter: launches}."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import quant
    from mxnet_tpu_torch.serve import FakeClock
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    # LMs at a head dim no multiple of 16 and one above 128
    for dh in REFUSED_DHS:
        add(_headdim_lm(mx, ck, prompts, dh))
        torch.cuda.empty_cache()
    # prefill windows of 128 rows at full width
    print(_tf32(False) + " (phase 52)")
    rs = np.random.RandomState(SEED + 52)
    wprompts = [rs.randint(0, V, n).tolist() for n in WIDE_PREFILL_PROMPTS]
    gen, runs = _gen(), {}
    for chunk in (WIDE_PREFILL, 1):
        sched = mx.serve.serve_decoder(
            gen(1), mx.convert.params_from_numpy(params, mx.gpu(0)),
            name=f"prefill-wide{chunk}", capacity=CAP, ladder=LADDER,
            context=mx.gpu(0), start=False, symbol_gen=gen,
            prefill_chunk=chunk, prefix_cache_mb=0)
        ck.reset_launch_counts()
        outs, _, wall = _serve_all(sched, wprompts, WIDE_PREFILL_NEW)
        counts, st = ck.launch_counts(), sched.stats()
        _decode_launches(f"refused: prefill chunk {chunk}", counts,
                         st["iterations"])
        runs[chunk] = (outs, st)
        add(counts)
        print(f"refused: prefill chunk {chunk}: {st['prefill_chunks']} "
              f"prefill chunks, {st['iterations']} iterations in "
              f"{wall:.3f} s")
    if not runs[WIDE_PREFILL][1]["prefill_chunks"]:
        raise AssertionError("no 128-row prefill window was dispatched")
    parted = _same_or_near_ties(cpu_ref, wprompts, runs[WIDE_PREFILL][0],
                                runs[1][0], "refused: prefill 128")
    print(f"refused: prefill chunk {WIDE_PREFILL} and chunk 1 greedy "
          f"chains: {len(wprompts) - parted} of {len(wprompts)} equal")
    # an LM head over V 128256: fit in float32 and bfloat16, one step
    # card vs CPU
    sym = tfm.get_symbol(BIG_V, BIG_D, 1, BIG_D // 64, BIG_T)
    big = _headdim_params(sym, SEED + 53, data=(BIG_BATCH, BIG_T),
                          softmax_label=(BIG_BATCH * BIG_T,))
    for cd in (None, "bfloat16"):
        sfx = "" if cd is None else "_" + HALF_SFX[cd]
        it = tfm.SyntheticLMIter(BIG_V, BIG_BATCH, BIG_T, BIG_STEPS,
                                 seed=SEED + 54)
        mod = mx.mod.Module(sym, context=mx.gpu(0), compute_dtype=cd)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=mx.convert.params_from_numpy(big,
                                                                mx.gpu(0)))
        ck.reset_launch_counts()
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=LM_SGD)
        counts = ck.launch_counts()
        after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        print(f"refused: V {BIG_V} fit {cd or 'float32'}: softmax "
              f"{counts['softmax' + sfx]}, CE gradient "
              f"{counts['softmax_ce_bwd' + sfx]} launches")
        if counts["softmax" + sfx] != BIG_STEPS or \
                counts["softmax_ce_bwd" + sfx] != BIG_STEPS or \
                not all(np.isfinite(v).all() for v in after.values()):
            raise AssertionError(f"V {BIG_V} fit {cd}: launches or weights")
        add(counts)
        del mod
    batch = next(iter(tfm.SyntheticLMIter(BIG_V, 2, BIG_T, 1,
                                          seed=SEED + 55)))
    cpu = _lm_step(mx, sym, big, mx.cpu(), batch)
    gpu = _lm_step(mx, sym, big, mx.gpu(0), batch)
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    worst_g = max(float(np.abs(gpu[1][k] - g).max()) /
                  (GRAD_RTOL * float(np.abs(g).max()) + 1e-12)
                  for k, g in cpu[1].items())
    print(f"refused: V {BIG_V} step card vs CPU max |prob| {prob_err:.3g} "
          f"(limit {FWD_TOL}), worst gradient {worst_g:.3g} of its limit")
    if not (prob_err <= FWD_TOL and worst_g <= 1.0):
        raise AssertionError(f"V {BIG_V}: card and CPU steps disagree")
    del cpu, gpu
    torch.cuda.empty_cache()
    # a segmentation net: multi_output softmax and LayerNorm over axis 1
    rs = np.random.RandomState(SEED + 56)
    X = rs.rand(SEG_BATCH * SEG_STEPS, *SEG_IMAGE).astype(np.float32)
    Y = rs.randint(0, SEG_CLASSES, (len(X),) + SEG_IMAGE[1:]).astype(
        np.float32)
    seg_params = {
        "c1_weight": 0.3 * rs.randn(16, 3, 3, 3), "c1_bias": np.zeros(16),
        "ln1_gamma": 1 + 0.1 * rs.randn(16), "ln1_beta": 0.1 * rs.randn(16),
        "c2_weight": 0.3 * rs.randn(SEG_CLASSES, 16, 1, 1),
        "c2_bias": np.zeros(SEG_CLASSES)}
    seg_params = {k: v.astype(np.float32) for k, v in seg_params.items()}
    card_counts, card_w = _seg_fit(mx, ck, mx.gpu(0), X, Y, seg_params)
    _, cpu_w = _seg_fit(mx, ck, mx.cpu(), X, Y, seg_params)
    worst = max(float(np.abs(card_w[k] - w).max()) /
                (SEG_WEIGHT_RTOL * float(np.abs(w).max()) + 1e-12)
                for k, w in cpu_w.items())
    want = {k: SEG_STEPS for k in ("softmax", "softmax_ce_bwd", "layernorm",
                                   "ln_bwd")}
    got = {k: card_counts[k] for k in want}
    print(f"refused: multi_output + LayerNorm(axis=1) net fit: launches "
          f"{got}; weights card vs CPU {worst:.3g} of the limit")
    if got != want or not worst <= 1.0:
        raise AssertionError("the segmentation net's fit")
    add(card_counts)
    # the fp8 ResNet-50 under compute_dtype="bfloat16", served
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in q_mod.get_params())
    qsym, qargs = quant.quantize_symbol(q_mod._symbol, args, dtype="fp8")

    def bound(ctx, n, cd):
        m = mx.mod.Module(qsym, context=ctx, compute_dtype=cd)
        m.bind([("data", (n,) + TRAIN_IMAGE)], [("softmax_label", (n,))],
               for_training=False)
        m.init_params(arg_params=qargs, aux_params=auxs)
        return m
    # a ladder whose top rung the request fills: one dispatch at once
    server = mx.serve.serve(bound(mx.gpu(0), 2, "bfloat16"),
                            name="fp8-bf16", ladder=[1, 2], start=False,
                            clock=FakeClock())
    X2 = _images(2, SEED + 6)[0]
    ck.reset_launch_counts()
    h = server.submit({"data": X2})
    if server.pump() != 1:
        raise AssertionError("the fp8 bfloat16 request did not dispatch")
    out = h.result(timeout=0)[0].asnumpy()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    server.stop()
    want = {"qfc_matmul_bf16": 1, "dequant_rows_multi": 1, "softmax_bf16": 1}
    print(f"refused: fp8 ResNet-50 under bfloat16, served 2 rows: launches "
          f"{counts}")
    if counts != want:
        raise AssertionError(f"fp8 bfloat16 serve: launches {counts}, want "
                             f"{want}")
    add(counts)
    card = _centered_log(np.asarray(out, np.float32))

    def cpu_fwd(cd):
        m = bound(mx.cpu(), 2, cd)
        m.forward(mx.io.DataBatch([X2], None), is_train=False)
        return _centered_log(m.get_outputs()[0].asnumpy().astype(
            np.float32))
    host, host32 = cpu_fwd("bfloat16"), cpu_fwd(None)
    d, own = float(np.abs(card - host).max()), float(np.abs(host -
                                                            host32).max())
    print(f"refused: fp8 bfloat16 served centered logits card vs CPU "
          f"{d:.4g}, CPU bfloat16 vs float32 {own:.4g} (limit "
          f"{BF16_SPREAD} x)")
    if not (np.isfinite(card).all() and d <= BF16_SPREAD * own):
        raise AssertionError("fp8 bfloat16: card and CPU disagree")
    # attention with Tq != Tk, and over B*H 65536
    for shape_q, shape_k, causal in (((2, 4, 70, 64), (2, 4, 200, 64), True),
                                     ((2, 4, 200, 64), (2, 4, 70, 64), True),
                                     ((2, 4, 200, 40), (2, 4, 70, 40), False),
                                     ((4096, 16, 8, 64), (4096, 16, 8, 64),
                                      True)):
        rs = np.random.RandomState(sum(shape_q))
        q = rs.randn(*shape_q).astype(np.float32)
        k, v = (rs.randn(*shape_k).astype(np.float32) for _ in range(2))
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            ck.reset_launch_counts()
            o = mx.nd.attention(*(mx.nd.array(a, ctx=ctx) for a in (q, k, v)),
                                causal=causal)
            res.append(o.asnumpy())
            if ctx.device_type == "gpu":
                add(ck.launch_counts())
                if ck.launch_counts()["flash_attention"] != 1:
                    raise AssertionError("attention: no flash launch")
        nan = np.isnan(res[1])
        err = float(np.abs(res[0][~nan] - res[1][~nan]).max())
        print(f"refused: attention q {shape_q} k {shape_k} causal {causal}: "
              f"card vs CPU {err:.3g} (limit {FWD_TOL}), NaN rows "
              f"{int(nan.any(-1).sum())} on both: "
              f"{np.array_equal(nan, np.isnan(res[0]))}")
        if not (err <= FWD_TOL and np.array_equal(nan, np.isnan(res[0]))):
            raise AssertionError("attention: card and CPU disagree")
    _refused_rows(ck)
    return total


def _threefry_kernels(ck, rs, t, rec):
    """The threefry kernel's two entry points against their plain
    versions on the same inputs. Dropout in every instance at the bench
    LM's shape (LM_BATCH, LM_SEQ, D), at VGG's drop6 (ZOO_BATCH, 4096) and
    at the edges (1, 7 and 4099 values: no whole 16-byte unit, an odd
    size, a tail past the last unit), each aligned and on a view one
    element off 16 bytes, y and the mask bit for bit; uniform at the
    embedding table's (V, D), the initializers' largest draw, and at the
    edges, bit for bit, with its normal transform within 1e-5 of max(1,
    |value|) and its exponential within 2 ulps (erfinvf and log1pf
    against PyTorch's). Timed beside F.dropout and torch.rand (the same
    bytes and the distribution, not the same bits) and the bound: the
    larger of the bytes (x read, y and mask written) and threefry's
    integer operations at the card's INT32 rate. Returns the calls that
    device_ms times."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import random as mxr
    key = mxr.split(mxr.prng_key(SEED))[1]
    lm, drop6 = (LM_BATCH, LM_SEQ, D), (ZOO_BATCH, 4096)
    calls = {}
    for dtype, name in ((torch.float32, "dropout"),
                        (torch.bfloat16, "dropout_bf16"),
                        (torch.float16, "dropout_f16")):
        err = 0.0
        for shape in (lm, drop6, (1,), (7,), (4099,)):
            n = int(np.prod(shape))
            flat = t(rs.randn(n + 1).astype(np.float32), dtype)
            for x in (flat[:n].view(shape), flat[1:].view(shape)):
                for keep in (0.9, 0.5):
                    y, m = ck.dropout(x, key, keep)
                    py, pm = ck.dropout_plain(x, key, keep)
                    if not (torch.equal(y, py) and torch.equal(m, pm)):
                        err = max(err, _max_err(y, py), _max_err(m, pm),
                                  float("inf") if not torch.equal(
                                      m == 0, pm == 0) else 0.0)
        cpu_y, cpu_m = ck.dropout_plain(flat[:7].cpu(), key, 0.5)
        y, m = ck.dropout(flat[:7], key, 0.5)
        if not (torch.equal(y.cpu(), cpu_y) and torch.equal(m.cpu(), cpu_m)):
            err = float("inf")
        x = t(rs.randn(*lm).astype(np.float32), dtype)
        n = x.numel()
        rec[name] = dict(
            max_abs_err=err, ms=_timed(lambda: ck.dropout(x, key, 0.9)),
            plain_ms=_timed(lambda: ck.dropout_plain(x, key, 0.9), reps=20,
                            warm=2, rounds=PLAIN_ROUNDS),
            library_ms=_timed(lambda: F.dropout(x, 0.1, True)),
            library_call=lambda x=x: F.dropout(x, 0.1, True),
            bound=_int_bound_ms(3 * n * x.element_size(), THREEFRY_OPS * n))
        calls[name] = lambda x=x: ck.dropout(x, key, 0.9)
    err = 0.0
    for shape in ((V, D), (1,), (7,), (4099,)):
        for lo, hi in ((0.0, 1.0), (-0.0765, 0.0765)):
            got = ck.uniform(key, shape, lo, hi, device="cuda")
            # the table's 16.4M draws against the plain version on the
            # card (integer arithmetic, the same bits on any device), the
            # edges against it on the CPU
            want = ck.uniform_plain(key, shape, lo, hi,
                                    device="cuda" if shape == (V, D)
                                    else None)
            err = max(err, 0.0 if torch.equal(got.to(want.device), want)
                      else float("inf"))
    for transform, limit in ((mxr.NORMAL, None), (mxr.EXPONENTIAL, 2)):
        got = ck.uniform(key, (4099,), transform=transform,
                         device="cuda").cpu()
        want = ck.uniform_plain(key, (4099,), transform=transform)
        if limit is None:
            rel = float(((got - want).abs() / want.abs().clamp(min=1.0))
                        .max())
            ok = rel <= 1e-5
        else:
            ok = int((got.view(torch.int32).long() -
                      want.view(torch.int32).long()).abs().max()) <= limit
        print(f"kernel uniform: transform {transform} against torch's "
              f"erfinv / log1p: {'within' if ok else 'OUTSIDE'} its limit")
        if not ok:
            err = float("inf")
    n = V * D
    rec["uniform"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.uniform(key, (V, D), device="cuda"), reps=50),
        plain_ms=_timed(lambda: ck.uniform_plain(key, (V, D), device="cuda"),
                        reps=5, warm=1),
        library_ms=_timed(lambda: torch.rand((V, D), device="cuda"),
                          reps=50),
        library_call=lambda: torch.rand((V, D), device="cuda"),
        bound=_int_bound_ms(4 * n, THREEFRY_OPS * n))
    calls["uniform"] = lambda: ck.uniform(key, (V, D), device="cuda")
    for dtype, name in ((torch.bfloat16, "uniform_bf16"),
                        (torch.float16, "uniform_f16")):
        calls[name] = _uniform16_row(ck, key, dtype, name, rec)
    return calls


def _uniform16_row(ck, key, dtype, name, rec):
    """The threefry kernel's 16-bit uniform instance against the plain
    version: uniform draws at the embedding table's (V, D) (on the card:
    integer arithmetic, the same bits on any device) and at the edges (on
    the CPU) bit for bit, normal and exponential within UNIFORM16_ULPS of
    the type (erfinvf / log1pf against PyTorch's, each rounded to the
    type). Timed beside torch.rand in the type and the bound (2 bytes
    written and threefry's integer operations an element). Returns the
    call that device_ms times."""
    import torch
    from mxnet_tpu_torch import random as mxr
    err = 0.0
    for shape in ((V, D), (1,), (7,), (4099,)):
        for lo, hi in ((0.0, 1.0), (-0.0765, 0.0765), (-2.5, 3.3)):
            got = ck.uniform(key, shape, lo, hi, device="cuda", dtype=dtype)
            want = ck.uniform_plain(key, shape, lo, hi,
                                    device="cuda" if shape == (V, D)
                                    else None, dtype=dtype)
            if not torch.equal(got.to(want.device), want):
                err = float("inf")
    for transform in (mxr.NORMAL, mxr.EXPONENTIAL):
        got = ck.uniform(key, (4099,), transform=transform, device="cuda",
                         dtype=dtype).cpu()
        want = ck.uniform_plain(key, (4099,), transform=transform,
                                dtype=dtype)
        ulps = int((got.view(torch.int16).long() -
                    want.view(torch.int16).long()).abs().max())
        print(f"kernel {name}: transform {transform} within {ulps} ulps "
              f"of the plain version (limit {UNIFORM16_ULPS})")
        if ulps > UNIFORM16_ULPS:
            err = float("inf")
    n = V * D
    rec[name] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.uniform(key, (V, D), device="cuda",
                                     dtype=dtype), reps=50),
        plain_ms=_timed(lambda: ck.uniform_plain(key, (V, D), device="cuda",
                                                 dtype=dtype),
                        reps=5, warm=1),
        library_ms=_timed(lambda: torch.rand((V, D), device="cuda",
                                             dtype=dtype), reps=50),
        library_call=lambda: torch.rand((V, D), device="cuda", dtype=dtype),
        bound=_int_bound_ms(2 * n, THREEFRY_OPS * n))
    return lambda: ck.uniform(key, (V, D), device="cuda", dtype=dtype)


def _int_bound_ms(nbytes, int_ops):
    """The least time for ``nbytes`` moved and ``int_ops`` 32-bit integer
    operations at the card's INT32 rate."""
    return _bound_ms(nbytes, int_ops, peak=INT32_OPS_PER_S)


@contextlib.contextmanager
def _dropout_tap(ck):
    """Keep every Dropout kernel call's (key, keep, x, mask) while the
    block runs: the wrapper is wrapped, the kernel and its counter are
    the wrapper's own."""
    import numpy as np
    seen, real = [], ck.dropout

    def tapped(x, key, keep):
        y, m = real(x, key, keep)
        seen.append((np.array(key, dtype=np.uint32), keep, x, m))
        return y, m
    ck.dropout = tapped
    try:
        yield seen
    finally:
        ck.dropout = real


def _check_dropout_chain(ck, label, sym, step_key, seen, steps, cpu_every):
    """The masks a fit drew: each step's Dropout nodes under the module's
    chain (the step's key is the second half of splitting the chain's
    key; node i folds in i, its index in the node list), each mask bit
    for bit the plain version's on the card, and every ``cpu_every``-th
    bit for bit the plain version's on the CPU. Returns the masks
    compared on the CPU."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import random as mxr
    nodes = [i for i, n in enumerate(sym._topo_nodes())
             if not n.is_variable and n.op == "Dropout"]
    want, k = [], np.array(step_key, dtype=np.uint32)
    for _ in range(steps):
        k, sub = mxr.split(k)
        want += [mxr.fold_in(sub, i) for i in nodes]
    if len(seen) != len(want):
        raise AssertionError(f"{label}: {len(seen)} Dropout launches, want "
                             f"{len(want)}")
    on_cpu = 0
    for j, ((key, keep, x, m), w) in enumerate(zip(seen, want)):
        if not np.array_equal(key, w):
            raise AssertionError(f"{label}: Dropout call {j} ran under key "
                                 f"{key}, the chain gives {w}")
        if not torch.equal(m, ck.dropout_plain(x, key, keep)[1]):
            raise AssertionError(f"{label}: Dropout call {j}'s mask is not "
                                 "the plain version's on the card")
        if j % cpu_every == 0:
            on_cpu += 1
            if not torch.equal(m.cpu(),
                               ck.dropout_plain(x.cpu(), key, keep)[1]):
                raise AssertionError(f"{label}: Dropout call {j}'s mask is "
                                     "not the CPU's")
    if seen:
        kept = float(np.mean([float((m != 0).float().mean())
                              for _, _, _, m in seen]))
        print(f"{label}: {len(seen)} Dropout masks under the module's key "
              f"chain, bit for bit the plain version's on the card, {on_cpu}"
              f" of them on the CPU too; kept share {kept:.4f}")
    return on_cpu


def _zoo_symbol(module, kw):
    import importlib
    return importlib.import_module(f"mxnet_tpu_torch.models.{module}") \
        .get_symbol(num_classes=TRAIN_CLASSES, **kw)


def _zoo_images(n, side, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 3, side, side).astype(np.float32),
            rs.randint(0, TRAIN_CLASSES, n).astype(np.float32))


def phase_zoo(mx, ck):
    """AlexNet, VGG-16, Inception-BN and Inception-v3 (1000 classes, 224 x
    224, Inception-v3 299 x 299) through Module.fit on gpu(0): after
    mx.random.seed(SEED) the module binds, its Xavier weights are drawn
    on the card by the uniform kernel (one launch a weight), and it fits
    ZOO_STEPS batches of ZOO_BATCH (ZOO_SGD, telemetry on): img/s without
    the first batch, launches per step (1 softmax, 1 CE backward, 1
    sgd_mom_multi, and AlexNet's and VGG's 2 Dropouts), a finite loss,
    moved weights; the Dropout masks under the module's key chain, bit
    for bit the plain version's (on the CPU too); the device-busy share
    of 2 more steps. Then one step of each at ZOO_PARITY_BATCH card vs
    CPU from the same parameters and seed, TF32 off (phase 6's rule).
    Returns the launches of the fits and the initializations."""
    import numpy as np
    import torch
    counts = {}
    for label, module, kw, side, parity_side in ZOO:
        print(_tf32(True) + f" (PyTorch's default, for the {label} fit)")
        t0 = time.perf_counter()
        sym = _zoo_symbol(module, kw)
        X, y = _zoo_images(ZOO_BATCH * ZOO_STEPS, side, SEED)
        it = mx.io.NDArrayIter(X, y, batch_size=ZOO_BATCH)
        mx.random.seed(SEED)
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mod.bind(it.provide_data, it.provide_label)
        ck.reset_launch_counts()
        mod.init_params(mx.initializer.Xavier())
        n_weights = sum(1 for k in mod.get_params()[0]
                        if k.endswith("weight"))
        inits = ck.launch_counts()["uniform"]
        print(f"zoo {label}: {n_weights} weights drawn on the card, "
              f"{inits} uniform launches")
        if inits != n_weights:
            raise AssertionError(f"zoo {label}: {inits} uniform launches "
                                 f"for {n_weights} weights")
        counts["uniform"] = counts.get("uniform", 0) + inits
        mod.init_optimizer(optimizer_params=ZOO_SGD)
        step_key = mod._step_key
        names = list(mod.get_params()[0])
        with _dropout_tap(ck) as seen:
            # two timed batches of a host-bound net: the telemetry span's
            # rate and the script's differ by more than MFU_RTOL there
            # (Inception-BN +10.4 %), so the rate is printed, not held
            fit_counts, per_step = _fit_phase(
                mx, ck, mod, it, f"zoo {label}", ZOO_BATCH, "img",
                (names[0], names[-1]), mfu_gate=False)
        drops = sum(1 for n in sym._topo_nodes()
                    if not n.is_variable and n.op == "Dropout")
        want = {"softmax": 1, "softmax_ce_bwd": 1, "sgd_mom_multi": 1,
                "dropout": drops}
        got = {k: per_step.get(k, 0) for k in want}
        print(f"zoo {label}: Dropout launches a step {got['dropout']}")
        if got != want or any(v for k, v in per_step.items()
                              if k not in want):
            raise AssertionError(f"zoo {label}: launches per step "
                                 f"{per_step}, want {want}")
        _check_dropout_chain(ck, f"zoo {label}", sym, step_key, seen,
                             ZOO_STEPS, 1)
        del seen
        for k, v in fit_counts.items():
            counts[k] = counts.get(k, 0) + v
        phase_train_profile(mod, it, steps=2, label=f"zoo {label} profile")
        del mod, it
        torch.cuda.empty_cache()
        print(f"zoo {label}: fit phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        print(_tf32(False) + f" (the {label} parity step)")
        Xp, yp = _zoo_images(ZOO_PARITY_BATCH, parity_side, SEED + 1)
        init = mx.mod.Module(sym, context=mx.cpu())
        init.bind([("data", Xp.shape)], [("softmax_label", yp.shape)])
        init.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                      for d in init.get_params())
        with _deterministic():
            _step_parity(mx, sym, args, auxs, Xp, yp, f"zoo {label} parity",
                         seed=SEED, sgd=ZOO_SGD)
        print(f"zoo {label}: parity step took "
              f"{time.perf_counter() - t0:.1f} s")
    return counts


def phase_lm_dropout(mx, ck):
    """The bench LM with dropout=LM_DROPOUT (two Dropouts a layer, 16)
    through Module.fit on gpu(0), LM_DROPOUT_STEPS batches in float32,
    bfloat16 and float16 (compute_dtype): tokens/s, launches per step
    (LM_PER_STEP plus 16 Dropouts, the 16-bit paths' instances), the
    masks under the module's key chain bit for bit the plain version's
    on the card (the first step's first on the CPU too), the
    device-busy share of 2 more steps (float32). Returns the fits'
    launch counts."""
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(True) + " (PyTorch's default, for the LM Dropout fits)")
    counts = {}
    sym = tfm.get_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                         n_head=N_HEAD, seq_len=LM_SEQ, dropout=LM_DROPOUT)
    drops = 2 * N_LAYER
    for dtype in ("float32", "bfloat16", "float16"):
        t0 = time.perf_counter()
        it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, LM_DROPOUT_STEPS,
                                 seed=SEED)
        mx.random.seed(SEED)
        mod = mx.mod.Module(sym, context=mx.gpu(0),
                            compute_dtype=None if dtype == "float32"
                            else dtype)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.initializer.Xavier(
            rng=torch.Generator().manual_seed(SEED)))
        mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
        step_key = mod._step_key
        label = f"lm dropout {dtype}"
        with _dropout_tap(ck) as seen:
            # two timed batches: the MFU rate is printed, not held (as in
            # phase 53)
            fit_counts, per_step = _fit_phase(
                mx, ck, mod, it, label, LM_BATCH * LM_SEQ, "tokens",
                ("lm_tok_embed_weight", "lm_ln_f_gamma"), mfu_gate=False)
        base = LM_PER_STEP if dtype == "float32" else \
            _halved(LM_BF16_PER_STEP, dtype)
        name = "dropout" + ("" if dtype == "float32"
                            else "_" + HALF_SFX[dtype])
        want = {k: base.get(k, 0) for k in per_step}
        want[name] = drops
        print(f"{label}: Dropout launches a step {per_step.get(name)}")
        if per_step != want:
            raise AssertionError(f"{label}: launches per step {per_step}, "
                                 f"want {want}")
        _check_dropout_chain(ck, label, sym, step_key, seen,
                             LM_DROPOUT_STEPS, drops * LM_DROPOUT_STEPS)
        del seen
        for k, v in fit_counts.items():
            counts[k] = counts.get(k, 0) + v
        if dtype == "float32":
            phase_train_profile(mod, it, steps=2, label=f"{label} profile")
        del mod, it
        torch.cuda.empty_cache()
        print(f"{label}: took {time.perf_counter() - t0:.1f} s")
    return counts


def _card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class _Killed(Exception):
    """A kill at a batch boundary: raised from the end callback, before
    the boundary's checkpoint tick; the module is abandoned."""


def _ckpt_dir(name):
    """A fresh directory for a phase's checkpoints, under the checkout's
    git-ignored build/."""
    import shutil
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_ckpt", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def _resume_fit(mx, sym, make_iter, init, optimizer, opt_params, seed,
                kill_at=None, mgr=None, resume=False, stamps=None):
    """One fit of RESUME_EPOCHS epochs on gpu(0) from the parameters
    ``init`` (NDArrays, copied in) after ``mx.random.seed(seed)``;
    ``kill_at`` raises out of the fit at that batch; ``stamps`` takes the
    time at each batch's end (the card synchronized). Returns the
    module."""
    import torch
    mx.random.seed(seed)
    mod = mx.mod.Module(sym, context=mx.gpu(0))

    def cb(p):
        if stamps is not None:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        if (p.epoch, p.nbatch) == kill_at:
            raise _Killed()
    try:
        mod.fit(make_iter(), num_epoch=RESUME_EPOCHS, batch_end_callback=cb,
                arg_params=init[0], aux_params=init[1], optimizer=optimizer,
                optimizer_params=opt_params(), checkpoint=mgr, resume=resume)
    except _Killed:
        pass
    torch.cuda.synchronize()
    return mod


def _fit_state(mod):
    """(parameters, aux states, optimizer states by name, num_update):
    the card's tensors, cloned."""
    arg, aux = mod.get_params()
    names = mod._param_names
    states = {}
    for i, st in mod._updater.states.items():
        leaves = st if isinstance(st, tuple) else (st,)
        states[names[i]] = [s.astorch().clone() for s in leaves
                            if s is not None]
    return ({k: v.astorch().clone() for k, v in arg.items()},
            {k: v.astorch().clone() for k, v in aux.items()}, states,
            mod._optimizer.num_update)


def _state_diff(a, b):
    """{array name: max |a - b|} over the arrays that differ."""
    import torch
    out = {}
    for part in range(3):
        for k, v in a[part].items():
            for x, z in zip(v if part == 2 else [v],
                            b[part][k] if part == 2 else [b[part][k]]):
                if not torch.equal(x, z):
                    out[k] = max(out.get(k, 0.0),
                                 float((x.double() - z.double()).abs().max()))
    if a[3] != b[3]:
        out["num_update"] = float(abs(a[3] - b[3]))
    return out


def _repeat(label, full, again):
    """Whether the uninterrupted run repeats itself bit for bit: prints it
    (naming the arrays that do not repeat) and returns {array: its own
    run-to-run difference}, empty when it repeats."""
    rep = _state_diff(full, again)
    if rep:
        worst = sorted(rep.items(), key=lambda kv: -kv[1])[:6]
        print(f"{label}: the uninterrupted run does NOT repeat itself bit "
              f"for bit: {len(rep)} arrays differ, the largest {worst}")
    else:
        print(f"{label}: the uninterrupted run repeats itself bit for bit "
              f"(parameters, aux states, optimizer states, num_update "
              f"{full[3]})")
    return rep


def _resume_gate(label, what, full, rep, got):
    """The bit-for-bit gate on ``got`` (the end state of ``what``): equal
    to the uninterrupted run ``full``; where that run does not repeat
    itself (``rep``, from ``_repeat``), within RESUME_SPREAD times its
    own difference, array by array."""
    diff = _state_diff(full, got)
    if not diff:
        print(f"{label}: {what}: bit for bit the uninterrupted run")
        return
    worst = sorted(diff.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: {what} differs in {len(diff)} arrays, the largest "
          f"{worst}")
    if not rep:
        raise AssertionError(f"{label}: {what} is not bit for bit the "
                             "uninterrupted run, which repeats itself")
    for k, d in diff.items():
        if d > RESUME_SPREAD * rep.get(k, 0.0):
            raise AssertionError(
                f"{label}: {k} differs by {d} after {what}, more than "
                f"{RESUME_SPREAD} x the uninterrupted run's own repeat "
                f"{rep.get(k, 0.0)}")


def _ckpt_metrics(mx, mgr_dir):
    """The checkpoint telemetry of the last fit, read exactly from the
    flight ring's ``ckpt.snapshot`` (exposed_us) and ``ckpt.commit``
    (dur_us) records (the ``ckpt.exposed_stall.seconds`` and
    ``ckpt.snapshot.seconds`` histograms hold the same observations in
    buckets), and the newest commit's payload bytes."""
    import numpy as np
    recs = mx.telemetry.flightrec.get_records()
    stall = np.array([r["exposed_us"] for r in recs
                      if r.get("kind") == "ckpt.snapshot"]) / 1e6
    commit = np.array([r["dur_us"] for r in recs
                       if r.get("kind") == "ckpt.commit"]) / 1e6
    hist = mx.telemetry.get_metric("ckpt.exposed_stall.seconds")
    if hist is None or hist.count != len(stall):
        raise AssertionError("ckpt.exposed_stall.seconds does not hold "
                             "every save")
    _, path = mx.checkpoint.latest_checkpoint(mgr_dir)
    size = os.path.getsize(os.path.join(path, "state.pkl"))
    return (f"ckpt.exposed_stall.seconds p50 {np.median(stall):.4f} max "
            f"{stall.max():.4f} over {len(stall)} saves {stall.round(4)}; "
            f"ckpt.snapshot.seconds p50 {np.median(commit):.3f} max "
            f"{commit.max():.3f} over {len(commit)} commits; payload "
            f"{size} bytes")


def _grad_repeat(mx, sym, init, make_iter):
    """One training step's gradients twice from the same state and key:
    the names of the arrays whose gradients differ."""
    import numpy as np
    import torch
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    it = make_iter()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=init[0], aux_params=init[1])
    batch = next(iter(it))
    grads = []
    for _ in range(2):
        mx.random.seed(SEED)
        mod.forward_backward(batch)
        torch.cuda.synchronize()
        grads.append({n: g.astorch().clone() for n, g in zip(
            mod._param_names, mod._exec_group.grad_arrays) if g is not None})
    del mod
    return sorted(n for n in grads[0]
                  if not torch.equal(grads[0][n], grads[1][n]))


def phase_lm_resume(mx, ck):
    """The bench LM (dropout LM_DROPOUT) with Adam at lr 1e-3 under a
    FactorScheduler, RESUME_EPOCHS epochs of RESUME_LM_BATCHES batches on
    gpu(0), through kill and resume. First one step's gradients twice from
    the same state and key, naming the arrays whose gradients do not
    repeat; then, under PyTorch's deterministic algorithms (index_add_'s
    deterministic route; uninitialized memory left unfilled), the
    uninterrupted run twice (does it repeat itself bit for bit?), once
    with a CheckpointManager saving every RESUME_EVERY batches (tokens/s
    with and without it, the exposed stall, the snapshot seconds, the
    payload's bytes; the same final state as without), killed at
    RESUME_KILL, and resumed with fit(resume=dir) in a fresh Module under
    another seed: bit for bit the uninterrupted run. Returns the resumed
    fit's launch counts."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(True) + " (PyTorch's default, for the LM resume phase)")
    sym = tfm.get_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                         n_head=N_HEAD, seq_len=LM_SEQ, dropout=LM_DROPOUT)
    start = mx.mod.Module(sym, context=mx.gpu(0))
    start.bind([mx.io.DataDesc("data", (LM_BATCH, LM_SEQ), np.int32)],
               [("softmax_label", (LM_BATCH * LM_SEQ,))])
    start.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    init = start.get_params()
    del start

    def make_iter():
        return tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, RESUME_LM_BATCHES,
                                   seed=SEED)

    def adam():
        return {"learning_rate": 1e-3, "lr_scheduler":
                mx.lr_scheduler.FactorScheduler(step=3, factor=0.5)}
    label = "lm resume"
    tokens = LM_BATCH * LM_SEQ
    steps = RESUME_EPOCHS * RESUME_LM_BATCHES
    print(f"{label}: on {_card_line()}; V={V} d_model={D} {N_LAYER} "
          f"layers {N_HEAD} heads T={LM_SEQ} batch {LM_BATCH} dropout "
          f"{LM_DROPOUT}, Adam lr 1e-3 "
          f"FactorScheduler(3, 0.5), {RESUME_EPOCHS} epochs of "
          f"{RESUME_LM_BATCHES} batches")
    differ = _grad_repeat(mx, sym, init, make_iter)
    print(f"{label}: one step's gradients twice from the same state and "
          f"key: {len(differ)} arrays differ {differ[:4]}"
          + (" - the embedding backward's index_add_ (float32 atomics over "
             "a batch's repeated ids) does not repeat" if differ ==
             ["lm_tok_embed_weight"] else ""))
    print(f"{label}: the fits below run under "
          "torch.use_deterministic_algorithms(True, warn_only=True), which "
          "gives index_add_ its deterministic route")
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        counts = _lm_resume_runs(mx, ck, sym, init, make_iter, adam, label,
                                 tokens, steps)
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
    return counts


def _lm_resume_runs(mx, ck, sym, init, make_iter, adam, label, tokens,
                    steps):
    import numpy as np
    ck.reset_launch_counts()
    plain_stamps = []
    full = _fit_state(_resume_fit(mx, sym, make_iter, init, "adam", adam,
                                  SEED))
    per_step = {k: v / steps for k, v in ck.launch_counts().items() if v}
    print(f"{label}: launches a step {per_step}")
    for name, want in (("adam_multi", 1), ("dropout", 2 * N_LAYER)):
        if per_step.get(name) != want:
            raise AssertionError(f"{label}: {name} launches a step "
                                 f"{per_step.get(name)}, want {want}")
    again = _fit_state(_resume_fit(mx, sym, make_iter, init, "adam", adam,
                                   SEED, stamps=plain_stamps))
    d_every = _ckpt_dir("lm_every")
    mgr = mx.checkpoint.CheckpointManager(d_every,
                                          every_n_batches=RESUME_EVERY,
                                          keep_last=1)
    ckpt_stamps = []
    mx.telemetry.reset()
    mx.telemetry.enable()
    t0 = time.perf_counter()
    try:
        saved = _fit_state(_resume_fit(mx, sym, make_iter, init, "adam",
                                       adam, SEED, mgr=mgr,
                                       stamps=ckpt_stamps))
        wall_ckpt = time.perf_counter() - t0
        metrics = _ckpt_metrics(mx, d_every)
    finally:
        mx.telemetry.disable()
        mgr.close()
    for what, st in (("without", plain_stamps), ("with", ckpt_stamps)):
        per = np.diff(st)
        print(f"{label}: {what} the manager: {tokens / np.median(per):.1f} "
              f"tokens/s at the median step ({np.median(per) * 1e3:.2f} "
              f"ms), {tokens * len(per) / per.sum():.1f} tokens/s over "
              f"steps 2-{steps}")
    print(f"{label}: the saving fit took {wall_ckpt:.2f} s, the last "
          f"commit's wait included; {metrics}")
    d_kill = _ckpt_dir("lm_kill")
    mgr = mx.checkpoint.CheckpointManager(d_kill,
                                          every_n_batches=RESUME_EVERY)
    try:
        _resume_fit(mx, sym, make_iter, init, "adam", adam, SEED,
                    kill_at=RESUME_KILL, mgr=mgr)
    finally:
        mgr.close()
    seq, path = mx.checkpoint.latest_checkpoint(d_kill)
    with open(os.path.join(path, "manifest.json")) as f:
        cursor = json.load(f)["cursor"]
    print(f"{label}: killed at {RESUME_KILL}; newest commit {seq} at "
          f"cursor {cursor}")
    ck.reset_launch_counts()
    resumed_mod = _resume_fit(mx, sym, make_iter, init, "adam", adam,
                              SEED + 99, resume=d_kill)
    counts = ck.launch_counts()
    print(f"{label}: the resumed fit's launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    rep = _repeat(label, full, again)
    _resume_gate(label, "killed and resumed", full, rep,
                 _fit_state(resumed_mod))
    _resume_gate(label, f"the fit that saved every {RESUME_EVERY} batches",
                 full, rep, saved)
    import shutil
    shutil.rmtree(os.path.dirname(d_kill), ignore_errors=True)
    return counts


def phase_resnet_resume(mx, ck):
    """ResNet-50 at batch TRAIN_BATCH, SGD momentum 0.9 wd 1e-4, an
    NDArrayIter with shuffle=True, RESUME_EPOCHS epochs of
    RESUME_R50_BATCHES batches, under cuDNN's deterministic algorithms:
    the uninterrupted run twice, killed at RESUME_KILL with a checkpoint
    every RESUME_EVERY batches, resumed: the bit-for-bit gate. Returns
    the resumed fit's launch counts."""
    import torch
    label = "resnet-50 resume"
    print(_tf32(True) + " (PyTorch's default); cudnn.deterministic = True "
          f"for this phase; on {_card_line()}")
    n = RESUME_R50_BATCHES * TRAIN_BATCH
    X, y = _images(n, SEED + 2)
    args, auxs, _, _ = _resnet50_start(mx, 1)
    init = (mx.convert.params_from_numpy(args, mx.gpu(0)),
            mx.convert.params_from_numpy(auxs, mx.gpu(0)))
    sym = _resnet50(mx)

    def make_iter():
        return mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH, shuffle=True)

    def sgd():
        return dict(SGD, momentum=0.9, wd=1e-4)
    with _deterministic():
        full = _fit_state(_resume_fit(mx, sym, make_iter, init, "sgd", sgd,
                                      SEED))
        again = _fit_state(_resume_fit(mx, sym, make_iter, init, "sgd", sgd,
                                       SEED))
        d = _ckpt_dir("resnet50")
        mgr = mx.checkpoint.CheckpointManager(d,
                                              every_n_batches=RESUME_EVERY)
        try:
            _resume_fit(mx, sym, make_iter, init, "sgd", sgd, SEED,
                        kill_at=RESUME_KILL, mgr=mgr)
        finally:
            mgr.close()
        seq, path = mx.checkpoint.latest_checkpoint(d)
        with open(os.path.join(path, "manifest.json")) as f:
            cursor = json.load(f)["cursor"]
        print(f"{label}: killed at {RESUME_KILL}; newest commit {seq} at "
              f"cursor {cursor}, "
              f"{os.path.getsize(os.path.join(path, 'state.pkl'))} bytes")
        ck.reset_launch_counts()
        resumed = _fit_state(_resume_fit(mx, sym, make_iter, init, "sgd",
                                         sgd, SEED + 99, resume=d))
        counts = ck.launch_counts()
    print(f"{label}: the resumed fit's launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("softmax", "softmax_ce_bwd", "sgd_mom_multi"):
        if not counts[name] > 0:
            raise AssertionError(f"{label}: {name} did not launch")
    _resume_gate(label, "killed and resumed", full,
                 _repeat(label, full, again), resumed)
    import shutil
    shutil.rmtree(os.path.dirname(d), ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def _serve_all_pumped(server, model, requests):
    """Each request through a FakeClock server, pumped: the outputs."""
    outs = []
    for x in requests:
        h = server.submit({"data": x}, model=model)
        server._clock.advance(1.0)
        server.pump()
        outs.append(h.result(timeout=0)[0].asnumpy())
    return outs


def _greedy_predictor(pred, prompts, new, slot_tokens=None):
    """Greedy decode through a per-slot decode Predictor: every slot fed
    its prompt a token a step, then ``new`` greedy steps. Returns (the
    chains, the logits of every greedy step, forward ms a step)."""
    import numpy as np
    slots = len(prompts)
    steps_ms, logits = [], []
    toks = np.zeros((slots, 1), np.int32)
    chains = [[] for _ in range(slots)]
    for t in range(len(prompts[0]) + new - 1):
        for s in range(slots):
            toks[s, 0] = prompts[s][t] if t < len(prompts[s]) else \
                chains[s][-1]
        t0 = time.perf_counter()
        out = pred.forward(data=toks)[0].asnumpy()[:, 0]
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        if t >= len(prompts[0]) - 1:
            logits.append(out)
            for s in range(slots):
                chains[s].append(int(out[s].argmax()))
    return chains, logits, float(np.median(steps_ms))


def _chains_agree(label, got, got_logits, want):
    """Greedy chains against the served ones: equal, or the first token
    they differ at is a float32 near-tie of the Predictor's own logits
    (the two tokens within LOGIT_TOL)."""
    same = 0
    for s, (g, w) in enumerate(zip(got, want)):
        w = list(w[:len(g)])
        if g == w:
            same += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        row = got_logits[j][s]
        if row[g[j]] - row[w[j]] > LOGIT_TOL:
            raise AssertionError(
                f"{label}: slot {s} token {j}: {g[j]} against the served "
                f"{w[j]}, logits {row[g[j]]} vs {row[w[j]]}")
    print(f"{label}: {same} of {len(got)} greedy chains equal the served "
          "ones token for token (the others first differ at a near-tie)")


def phase_predictor(mx, ck, params, prompts, served):
    """The Predictor on the card. (a) ResNet-50 exported with
    quantize="int8" at batch PRED_BATCH, served through
    InferenceServer.register(predictor=path) beside a BucketEngine over
    the same quantized graph at rung PRED_BATCH: the same outputs, the
    quantized kernels read from their counters, forward ms of both.
    (b) The bench decode LM exported per_slot at PRED_SLOTS slots: greedy
    decode of phase 3's prompts, PRED_NEW tokens, through
    Predictor.forward against serve_decoder's chains; reset_slot frees a
    slot, which then decodes phase 3's first prompt again, token for token
    as slot 0 did. Returns (launch counts, the server, its requests and
    outputs, the artifact's directory)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(False) + f" (the Predictor against the engine); on "
          f"{_card_line()}")
    label = "predictor int8"
    counts = {}
    d = _ckpt_dir("predictor")
    os.makedirs(d)
    args, auxs, X, _ = _resnet50_start(mx, PRED_BATCH)
    sym = _resnet50(mx)
    path = os.path.join(d, "resnet50_int8.mxt")
    t0 = time.perf_counter()
    mx.export_model(path, sym, mx.convert.params_from_numpy(args, mx.cpu()),
                    mx.convert.params_from_numpy(auxs, mx.cpu()),
                    {"data": (PRED_BATCH,) + TRAIN_IMAGE}, quantize="int8")
    print(f"{label}: exported in {time.perf_counter() - t0:.2f} s, "
          f"{os.path.getsize(path)} bytes")
    server = mx.serve.InferenceServer(clock=mx.serve.FakeClock())
    server.register("r50-int8-pred", predictor=path)
    server.register("r50-int8", symbol=sym,
                    arg_params=mx.convert.params_from_numpy(args, mx.cpu()),
                    aux_params=mx.convert.params_from_numpy(auxs, mx.cpu()),
                    data_shapes={"data": TRAIN_IMAGE}, ladder=[PRED_BATCH],
                    context=mx.gpu(0), compute_dtype="int8")
    rs = np.random.RandomState(SEED + 3)
    requests = [X[:r] + 0.01 * rs.rand(r, *TRAIN_IMAGE).astype(np.float32)
                for r in (PRED_BATCH, 3, 5)]
    ck.reset_launch_counts()
    got = _serve_all_pumped(server, "r50-int8-pred", requests)
    pcounts = ck.launch_counts()
    want = _serve_all_pumped(server, "r50-int8", requests)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"{label}: PredictorEngine vs BucketEngine at rung {PRED_BATCH}: "
          f"max |diff| {err:.3g} over {len(requests)} requests")
    if err != 0.0:
        raise AssertionError(f"{label}: the Predictor's outputs differ from "
                             f"the BucketEngine's by {err}")
    per_fwd = {k: v / len(requests) for k, v in pcounts.items() if v}
    print(f"{label}: launches a Predictor forward {per_fwd}")
    for name in QUANT_KERNELS:
        if per_fwd.get(name) != 1:
            raise AssertionError(f"{label}: {name} launches a forward "
                                 f"{per_fwd.get(name)}, want 1")
    counts.update(pcounts)
    pred = server.engine("r50-int8-pred")._pred
    eng = server.engine("r50-int8")
    full = {"data": requests[0]}
    for what, fn in (("Predictor.forward", lambda: pred.forward(**full)),
                     ("BucketEngine.forward",
                      lambda: eng.forward(PRED_BATCH, full))):
        ms = _timed(lambda: fn()[0].asnumpy(), reps=10, warm=2, rounds=3)
        print(f"{label}: {what} at batch {PRED_BATCH}: {ms:.3f} ms "
              "(host to host)")

    label = "predictor decode"
    dsym = tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                                 n_head=N_HEAD, capacity=CAP, per_slot=True)
    dpath = os.path.join(d, "lm_decode.mxt")
    mx.export_model(dpath, dsym, mx.convert.params_from_numpy(params,
                                                               mx.cpu()),
                    {}, {"data": (PRED_SLOTS, 1)},
                    data_dtypes={"data": np.int32})
    dpred = mx.Predictor(dpath)
    if not dpred.stateful:
        raise AssertionError(f"{label}: the decode artifact is not stateful")
    ck.reset_launch_counts()
    chains, logits, ms = _greedy_predictor(dpred, prompts[:PRED_SLOTS],
                                           PRED_NEW)
    dcounts = ck.launch_counts()
    n_fwd = PROMPT + PRED_NEW - 1
    print(f"{label}: {PRED_SLOTS} slots, {n_fwd} forwards, "
          f"{ms:.3f} ms a forward (median, host to host); launches a "
          f"forward { {k: v / n_fwd for k, v in dcounts.items() if v} }")
    for name in DECODE_KERNELS:
        if not dcounts[name] > 0:
            raise AssertionError(f"{label}: {name} did not launch")
    _chains_agree(label, chains, logits, served)
    drv = _decoder(mx, dsym, params, mx.gpu(0), slots=PRED_SLOTS)
    for s in range(PRED_SLOTS):
        drv.join(s)
    tok = np.zeros((PRED_SLOTS, 1), np.int32)
    eng_ms = _timed(lambda: drv.step(tok).asnumpy(), reps=16, warm=2,
                    rounds=3)
    print(f"{label}: the engine's driver (BatchedKVCacheDecoder) step at "
          f"{PRED_SLOTS} slots: {eng_ms:.3f} ms; the Predictor's forward "
          f"{ms:.3f} ms")
    del drv
    ck.reset_launch_counts()
    # free slot 3 and decode phase 3's first prompt there while the other
    # slots go on with their chains
    slot = 3
    dpred.reset_slot(slot)
    again = [list(prompts[s]) + chains[s] for s in range(PRED_SLOTS)]
    toks = np.zeros((PRED_SLOTS, 1), np.int32)
    fresh = []
    for t in range(PROMPT + PRED_NEW - 1):
        for s in range(PRED_SLOTS):
            if s == slot:
                toks[s, 0] = prompts[0][t] if t < PROMPT else fresh[-1]
            else:
                toks[s, 0] = again[s][-1]
        out = dpred.forward(data=toks)[0].asnumpy()[:, 0]
        for s in range(PRED_SLOTS):
            if s != slot:
                again[s].append(int(out[s].argmax()))
        if t >= PROMPT - 1:
            fresh.append(int(out[slot].argmax()))
    same = fresh == chains[0]
    print(f"{label}: slot {slot} freed by reset_slot decodes prompt 0 "
          f"again: {'the same' if same else 'ANOTHER'} chain as slot 0")
    if not same:
        raise AssertionError(f"{label}: slot {slot} after reset_slot "
                             f"decoded {fresh[:8]}..., slot 0 "
                             f"{chains[0][:8]}...")
    for k, v in ck.launch_counts().items():
        dcounts[k] += v
    for k, v in dcounts.items():
        counts[k] = counts.get(k, 0) + v
    del dpred
    torch.cuda.empty_cache()
    return counts, server, requests, {"r50-int8-pred": got,
                                      "r50-int8": want}


def phase_warm_restart(mx, ck, server, requests, outs):
    """Phase 57's server committed with checkpoint_to, dropped, and
    rebuilt by restore_server(dir, start=True) (the quantized kernels'
    libraries unloaded first, so warmup loads them again): the seconds
    from restore_server to the first response, the same requests' same
    outputs, and no kernel build after warmup."""
    import numpy as np
    label = "warm restart"
    print(f"{label}: on {_card_line()}")
    d = _ckpt_dir("serve")
    t0 = time.perf_counter()
    seq = server.checkpoint_to(d)
    print(f"{label}: checkpoint_to committed seq {seq} in "
          f"{time.perf_counter() - t0:.2f} s")
    server.stop()
    del server
    _unload(ck, QUANT_KERNELS)
    before = ck.libraries_loaded()
    t0 = time.perf_counter()
    restored = mx.serve.restore_server(d, start=True)
    first = restored.submit({"data": requests[0]},
                            model="r50-int8-pred").result(timeout=120)
    t_first = time.perf_counter() - t0
    try:
        print(f"{label}: restore_server to the first response "
              f"{t_first:.2f} s (warmup loaded "
              f"{ck.libraries_loaded() - before} kernel libraries)")
        got = {m: [restored.submit({"data": x}, model=m).result(
            timeout=120)[0].asnumpy() for x in requests] for m in outs}
        if not np.array_equal(first[0].asnumpy(), outs["r50-int8-pred"][0]):
            raise AssertionError(f"{label}: the first response differs")
        for m, want in outs.items():
            err = max(float(np.abs(g - w).max())
                      for g, w in zip(got[m], want))
            print(f"{label}: {m}: max |restored - before| {err:.3g}")
            if err != 0.0:
                raise AssertionError(f"{label}: {m} answers differently "
                                     "after the restart")
        compiles = restored.stats()["compiles_since_warmup"]
        print(f"{label}: compiles_since_warmup {compiles}")
        if compiles != 0:
            raise AssertionError(f"{label}: {compiles} kernel builds after "
                                 "warmup")
    finally:
        restored.stop()
    import shutil
    shutil.rmtree(os.path.dirname(d), ignore_errors=True)


def phase_samplers16(mx, ck):
    """The imperative samplers in bfloat16 and float16 on gpu(0) (the
    threefry kernel's 16-bit instances) after mx.random.seed, at
    SAMPLER_SHAPE: uniform bit for bit the CPU's draws after
    the same seed, normal and exponential within UNIFORM16_ULPS. Returns
    the launch counts."""
    import torch
    print(f"samplers: on {_card_line()}")
    ck.reset_launch_counts()
    for dtype in ("bfloat16", "float16"):
        draws = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            mx.random.seed(SEED)
            with ctx:
                draws[ctx.device_type] = [t.astorch().cpu() for t in (
                    mx.nd.random_uniform(low=-0.07, high=0.07,
                                         shape=SAMPLER_SHAPE, dtype=dtype),
                    mx.nd.random_normal(shape=SAMPLER_SHAPE, dtype=dtype),
                    mx.nd.random_exponential(shape=SAMPLER_SHAPE,
                                             dtype=dtype))]
        cpu, gpu = draws["cpu"], draws["gpu"]
        ulps = [int((a.view(torch.int16).long() -
                     b.view(torch.int16).long()).abs().max())
                for a, b in zip(cpu[1:], gpu[1:])]
        same = torch.equal(cpu[0], gpu[0])
        print(f"samplers {dtype}: uniform "
              f"{'bit for bit' if same else 'DIFFERENT'}, normal / "
              f"exponential within {ulps} ulps of the CPU's")
        if not same or max(ulps) > UNIFORM16_ULPS:
            raise AssertionError(f"samplers {dtype}: the card's draws "
                                 "differ from the CPU's")
    counts = ck.launch_counts()
    for name in ("uniform_bf16", "uniform_f16"):
        if counts[name] != 3:
            raise AssertionError(f"{name}: {counts[name]} launches, want 3")
    return counts


def _ts_cases(dev):
    """(op name, make the numpy inputs, attrs) for every op name of the
    tensor surface (147: ``ops/tensor.py``'s families, ``softmax``,
    ``log_softmax``, ``SliceChannel`` / ``split``, ``MakeLoss``), the inputs
    made when the case runs (one (8192, 512) array is 16 MiB), drawn on
    ``dev`` from a generator seeded with SEED and copied to the host (a
    host draw takes 15-30 ms an array, seconds for the phase)."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    X, ROW = TS_SHAPE, (1, TS_SHAPE[1])

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def u(lo, hi, shape=X):
        return lambda: (rand(shape) * (hi - lo) + lo).cpu().numpy()

    def ints(hi, shape=X, lo=0):
        return lambda: torch.randint(lo, hi, shape, generator=gen,
                                     device=dev).to(torch.float32) \
            .cpu().numpy()

    def away(shape=X):
        def make():
            mag = rand(shape) + 0.5
            return torch.where(rand(shape) < 0.5, -mag, mag).cpu().numpy()
        return make

    def both(*makers):
        return lambda: [m() for m in makers]

    cases = []

    def add(name, make, **attrs):
        cases.append((name, make, attrs))

    for name, (lo, hi) in TS_UNARY.items():
        attrs = {"dtype": "float16"} if name in ("Cast", "cast") else {}
        if name == "smooth_l1":
            attrs = {"scalar": 1.0}
        add(name, both(u(lo, hi)), **attrs)
    pair = {"div": both(u(-1, 1), away()),
            "power": both(u(0.4, 2.0), u(0.4, 2.0)),
            "hypot": both(away(), away()),
            "mod": both(u(0.55, 0.95), u(1.1, 2.0))}
    for b in TS_BINARY:
        make = both(ints(3), ints(3)) if b in TS_COMPARE else \
            pair.get(b, both(u(-1, 1), u(-1, 1)))
        names = [f"elemwise_{b}" if b in ("add", "sub", "mul", "div")
                 else f"_{b}", f"broadcast_{b}"]
        for n in names:
            if n in ("elemwise_add", "broadcast_add"):
                continue            # ops of an earlier slice
            if n.startswith("broadcast_"):
                # positive: rhs's gradient sums 8192 rows, which must not
                # cancel (a sum's order shows as cancellation's error)
                lhs, rhs = (ints(3), ints(3, ROW)) if b in TS_COMPARE \
                    else ((u(0.55, 0.95), u(1.1, 2.0, ROW)) if b == "mod"
                          else (u(0.4, 2.0), u(0.4, 2.0, ROW)))
                add(n, both(lhs, rhs))
            else:
                add(n, make)
    scalar = {"power": (u(0.4, 2.0), 2.5), "mod": (u(0.2, 1.2), 1.5),
              "maximum": (u(-1, 1), 0.1), "minimum": (u(-1, 1), 0.1),
              "hypot": (away(), 1.5)}
    for b in TS_BINARY:
        make, s = (ints(3), 1.0) if b in TS_COMPARE else \
            scalar.get(b, (away() if b == "div" else u(-1, 1), 1.5))
        add(f"_{b}_scalar", both(make), scalar=s)
    for name, make, s in (("_rsub_scalar", u(-1, 1), 1.5),
                          ("_rdiv_scalar", away(), 1.5),
                          ("_rpower_scalar", u(-1.5, 1.5), 1.5),
                          ("_rmod_scalar", u(1.7, 2.8), 1.5),
                          ("_plus_scalar", u(-1, 1), 1.5),
                          ("_minus_scalar", u(-1, 1), 1.5),
                          ("_rminus_scalar", u(-1, 1), 1.5)):
        add(name, both(make), scalar=s)
    for name in ("_minus", "_mul", "_grad_add"):
        add(name, both(u(-1, 1), u(-1, 1)))
    add("_div", both(u(-1, 1), away()))
    for name in ("add_n", "ElementWiseSum", "_sum"):
        add(name, both(u(-1, 1), u(-1, 1), u(-1, 1)), num_args=3)
    add("broadcast_axis", both(u(-1, 1, (X[0], 1))), axis=1, size=X[1])
    add("broadcast_to", both(u(-1, 1, ROW)), shape=X)
    for name, make in (("mean", u(0.5, 1.5)), ("prod", u(0.98, 1.02)),
                       ("norm", u(-1, 1))):
        add(name, both(make), axis=1)

    def with_nans(lo, hi):
        def make():
            x = u(lo, hi)()
            x[u(0, 1)() < 0.01] = np.nan
            return [x]
        return make
    add("nansum", with_nans(0.5, 1.5), axis=1)
    add("nanprod", with_nans(0.98, 1.02), axis=1)
    for name in ("max", "min", "max_axis", "min_axis", "argmax", "argmin"):
        add(name, both(ints(50)), axis=1)       # ties along every row
    add("argmax_channel", both(ints(50)))
    add("softmax_cross_entropy", both(u(-3, 3), ints(X[1], (X[0],))))
    add("_zeros", both(), shape=X)
    add("_ones", both(), shape=X, dtype="int32")
    add("_full", both(), shape=X, value=0.1)
    add("zeros_like", both(u(-1, 1)))
    add("ones_like", both(u(-1, 1)))
    add("_identity_with_attr_like_rhs", both(u(-1, 1), u(-1, 1)))
    seq = (LM_BATCH, LM_SEQ, D // N_HEAD)
    add("batch_dot", both(u(0, 1, seq), u(0, 1, seq)), transpose_b=True)
    half, col = (X[0] // 2, X[1] // 2), X[1] // 8
    add("slice", both(u(-1, 1)), begin=(0, col), end=half)
    add("crop", both(u(-1, 1)), begin=(3, 0), end=(X[0], 5 * col))
    add("_slice_assign", both(u(-1, 1), u(-1, 1, (half[0], half[1] - col))),
        begin=(0, col), end=half)
    add("_crop_assign_scalar", both(u(-1, 1)), begin=(7, 3), end=half,
        scalar=2.5)

    def at_bounds():
        x = u(-1, 1)()
        x.reshape(-1)[::7] = 0.5
        x.reshape(-1)[3::7] = -0.5
        return [x]
    add("clip", at_bounds, a_min=-0.5, a_max=0.5)
    add("repeat", both(u(-1, 1)), repeats=2, axis=1)
    add("tile", both(u(-1, 1)), reps=(1, 2))
    add("reverse", both(u(-1, 1)), axis=1)
    add("flip", both(u(-1, 1)), axis=(0, 1))
    add("SwapAxis", both(u(-1, 1)), dim1=0, dim2=1)
    add("swapaxes", both(u(-1, 1)), dim1=1, dim2=0)
    image_pad = (0, 0, 0, 0, 1, 1, 1, 1)
    for name, mode in (("Pad", "constant"), ("Pad", "edge"),
                       ("pad", "reflect")):
        add(name, both(u(-1, 1, TS_IMAGE)), mode=mode, pad_width=image_pad,
            constant_value=0.5)
    add("take", both(u(-1, 1), ints(X[0] + 100, (X[0] // 2,), lo=-100)))
    add("batch_take", both(u(-1, 1), ints(X[1], (X[0],))))
    add("one_hot", both(ints(X[1] + 8, (X[0],), lo=-8)), depth=X[1])
    add("pick", both(u(-1, 1), ints(X[1], (X[0],))))
    add("where", both(ints(2, (X[0],)), u(-1, 1), u(-1, 1)))

    def head_rows():
        x = u(-1, 1, TS_ORDER)()
        x[0] = ints(20, (TS_ORDER[1],))()        # a row of repeated values
        return [x]
    for asc in (True, False):
        add("sort", head_rows, is_ascend=asc)
        add("argsort", head_rows, is_ascend=asc)
        for ret in ("indices", "value", "both", "mask"):
            add("topk", head_rows, k=TS_TOPK, ret_typ=ret, is_ascend=asc)
    add("softmax", both(u(-3, 3)), axis=-1)
    add("log_softmax", both(u(-3, 3)), axis=-1)
    add("SliceChannel", both(u(-1, 1, TS_IMAGE)), num_outputs=2, axis=1)
    add("split", both(u(-1, 1, TS_IMAGE)), num_outputs=4, axis=1,
        squeeze_axis=False)
    add("MakeLoss", both(u(-1, 1)), grad_scale=0.5, normalization="batch")
    return cases


def _ts_heads(name, dev, seed):
    """The head gradients of a case: made once from the first run's
    outputs (drawn on ``dev`` from ``seed``), then the same for every
    run. Positive, U(0.5, 1.5): a gradient that sums them (a broadcast's)
    must not cancel, or the order of the sum shows as its error; rows of
    zero sum for log_softmax, whose gradient g - softmax * sum(g) would
    cancel to ~0 where it meets a softmax one ulp of log-space away on
    the other device."""
    import torch
    made = []

    def heads(outs):
        if not made:
            gen = torch.Generator(device=dev).manual_seed(seed)
            made.extend(torch.rand(o.shape, generator=gen, device=dev) +
                        0.5 for o in outs)
            if name == "log_softmax":
                made[:] = [h - h.mean(dim=-1, keepdim=True) for h in made]
        return made
    return heads


def _ts_run(mx, name, arrays, attrs, ctx, heads):
    """``mx.nd.<name>`` on ``ctx`` inside a train section and, unless the
    op has no gradient, the gradients of its outputs with respect to its
    inputs under ``heads(outputs)``: (outputs, gradients), tensors on
    ``ctx``."""
    xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
    gs = [mx.nd.zeros(a.shape, ctx=ctx) for a in arrays]
    differentiable = name not in TS_NO_GRAD
    if differentiable:
        mx.autograd.mark_variables(xs, gs)
    with ctx, mx.autograd.train_section():      # ctx: ops with no input
        out = getattr(mx.nd, name)(*xs, **attrs)
    outs = out if isinstance(out, list) else [out]
    # BlockGrad's output carries no history: its gradient cells stay 0
    if differentiable and any(o.astorch().requires_grad for o in outs):
        mx.autograd.backward(outs, out_grads=heads(outs))
    return [o.astorch().detach() for o in outs], \
        [g.astorch() for g in gs] if differentiable else []


def _ts_err(got, want, exact):
    """0 where the card's ``got`` is the CPU's ``want`` (NaN where it is
    NaN), else the worst |got - want| over the limit (inf for exact
    tensors that differ); compared on the card (numpy takes ~30 s for
    the phase's arrays)."""
    import torch
    want = want.to(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if exact:
        same = torch.equal(got, want) or (got.is_floating_point() and
                                          torch.allclose(got, want, rtol=0,
                                                         atol=0,
                                                         equal_nan=True))
        return 0.0 if same else float("inf")
    g, w = got.double(), want.double()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        return float("inf")
    ok = ~torch.isnan(w)
    return float((torch.abs(g[ok] - w[ok]) /
                  (TS_ATOL + TS_RTOL * torch.abs(w[ok]))).max()) \
        if bool(ok.any()) else 0.0


def phase_tensor_surface(mx):
    """Phase 60(a): every op name of the tensor surface through ``mx.nd``
    on gpu(0) and on the CPU from the same numpy inputs, TF32 off: the
    outputs exactly for ops that move, select, order or compare, else
    within TS_RTOL / TS_ATOL; the gradients through ``mx.autograd`` the
    same way (exactly where the backward only moves values) for every
    differentiable op, from the same random head gradients."""
    print(_tf32(False) + " (the tensor surface, card vs CPU)")
    names, calls, grads, worst = set(), 0, 0, {}
    t0 = time.perf_counter()
    spent = dict.fromkeys(("inputs", "cpu", "card"), 0.0)
    dev = mx.gpu(0).torch_device()
    for i, (name, make, attrs) in enumerate(_ts_cases(dev)):
        t = time.perf_counter()
        arrays = make()
        heads = _ts_heads(name, dev, SEED + 1000 + i)
        spent["inputs"] += time.perf_counter() - t
        t = time.perf_counter()
        want, want_g = _ts_run(mx, name, arrays, attrs, mx.cpu(), heads)
        spent["cpu"] += time.perf_counter() - t
        t = time.perf_counter()
        got, got_g = _ts_run(mx, name, arrays, attrs, mx.gpu(0), heads)
        spent["card"] += time.perf_counter() - t
        err = max(_ts_err(g, w, name in TS_EXACT)
                  for g, w in zip(got, want))
        gerr = max([_ts_err(g, w, name in TS_GRAD_EXACT)
                    for g, w in zip(got_g, want_g)] or [0.0])
        worst[name] = max(worst.get(name, 0.0), err, gerr)
        if not (err <= 1.0 and gerr <= 1.0):
            raise AssertionError(
                f"tensor surface: {name}({attrs}) on the card differs from "
                f"the CPU: output {err:.3g}, gradient {gerr:.3g} of the "
                "limit (inf: an exact op that differs)")
        names.add(name)
        calls += 1
        grads += bool(got_g)
    arith = {k: v for k, v in worst.items() if k not in TS_EXACT}
    top = sorted(arith.items(), key=lambda kv: -kv[1])[:5]
    print(f"tensor surface: {len(names)} op names, {calls} calls, "
          f"{grads} with gradients, card vs CPU in "
          f"{time.perf_counter() - t0:.1f} s (inputs {spent['inputs']:.1f}, "
          f"CPU {spent['cpu']:.1f}, card with its copies "
          f"{spent['card']:.1f}): {len(names & TS_EXACT)} "
          f"names exact; arithmetic worst of the limit (rtol {TS_RTOL}, "
          f"atol {TS_ATOL}): " + ", ".join(f"{k} {v:.3g}" for k, v in top))
    if len(names) != 147:
        raise AssertionError(f"tensor surface: {len(names)} op names run, "
                             "want 147")


def _custom_head(mx, sym):
    """The bench LM's logits under ``MakeLoss(mean(-pick(log_softmax(
    logits), label)))``, with ``BlockGrad(softmax(logits))`` beside it."""
    logits = sym.get_internals()["lm_logits_output"]
    label = mx.sym.var("softmax_label")
    loss = mx.sym.MakeLoss(mx.sym.mean(-mx.sym.pick(
        mx.sym.log_softmax(logits), label)), name="ce")
    return mx.sym.Group([loss, mx.sym.BlockGrad(mx.sym.softmax(logits),
                                                name="prob")])


def _prob_metric(mx):
    """acc and ce over the custom head's probabilities (its second
    output: the first is the scalar loss)."""
    class OnProbabilities(mx.metric.CompositeEvalMetric):
        def update(self, labels, preds):
            super().update(labels, preds[1:])
    return OnProbabilities(["acc", "ce"])


def _head_grads(mx, sym, params, batch):
    """One training forward and backward of ``sym`` on gpu(0): the
    parameters' gradients (numpy)."""
    import numpy as np
    req = {k: "write" if k in params else "null"
           for k in sym.list_arguments()}
    ex = sym.simple_bind(ctx=mx.gpu(0), grad_req=req,
                         data=(LM_BATCH, LM_SEQ),
                         softmax_label=(LM_BATCH * LM_SEQ,),
                         type_dict={"data": np.int32})
    ex.forward(is_train=True, data=batch.data[0],
               softmax_label=batch.label[0], **params)
    ex.backward()
    return {k: ex.grad_dict[k].asnumpy() for k in params}


def phase_custom_loss(mx, ck):
    """Phase 60(b): the bench LM (phase 9's width) with its head written
    in the tensor ops (``_custom_head``) on gpu(0): from the same Xavier
    parameters (seed SEED) and batch, TF32 off, its first-step gradients
    within CUSTOM_GRAD_RTOL of each array's largest magnitude of the
    ``SoftmaxOutput(normalization="batch")`` head's; then CUSTOM_STEPS
    batches through ``Module.fit`` (SGD, phase 9's settings and TF32):
    tokens/s beside phase 9's, the launches a step (phase 9's less the
    head's softmax and CE-gradient kernels, exactly), the device-busy
    share of 2 more steps. Returns the fit's launch counts."""
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(False) + " (the custom head against SoftmaxOutput)")
    sym = _lm_symbol(LM_SEQ)
    head = _custom_head(mx, sym)
    init = mx.mod.Module(sym, context=mx.gpu(0))
    it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, CUSTOM_STEPS, seed=SEED)
    init.bind(it.provide_data, it.provide_label)
    init.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    params = init.get_params()[0]
    batch = next(iter(it))
    want = _head_grads(mx, sym, params, batch)
    got = _head_grads(mx, head, params, batch)
    worst = max(float(abs(got[k] - g).max()) / float(abs(g).max())
                for k, g in want.items())
    print(f"custom loss: first-step gradients of the MakeLoss head against "
          f"SoftmaxOutput's over {len(want)} arrays: worst "
          f"{worst:.3g} of the array's max |g| (limit {CUSTOM_GRAD_RTOL})")
    if not worst <= CUSTOM_GRAD_RTOL:
        raise AssertionError("custom loss: its gradients differ from the "
                             "SoftmaxOutput head's")
    del want, got, init
    torch.cuda.empty_cache()
    print(_tf32(True) + " (PyTorch's default, for the custom-loss fit)")
    it.reset()
    mod = mx.mod.Module(head, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params)
    into = {}
    counts, per_step = _fit_phase(
        mx, ck, mod, it, "custom loss fit", LM_BATCH * LM_SEQ, "tokens",
        ("lm_tok_embed_weight", "lm_ln_f_gamma"), into=into,
        metric=_prob_metric(mx), mfu_gate=False, optimizer="sgd",
        optimizer_params=LM_SGD)
    print(f"custom loss fit: {into['rate']:.1f} tokens/s beside phase 9's "
          f"SoftmaxOutput head {LM_FIT.get('rate', float('nan')):.1f} "
          f"(step p50 {into['p50']:.2f} ms against "
          f"{LM_FIT.get('p50', float('nan')):.2f} ms)")
    want = {k: v for k, v in LM_PER_STEP.items()
            if k not in ("softmax", "softmax_ce_bwd")}
    want = {k: want.get(k, 0) for k in per_step}
    if per_step != want:
        raise AssertionError(f"custom loss fit: launches per step "
                             f"{per_step}, want {want}")
    phase_train_profile(mod, it, steps=2, label="custom loss profile")
    del mod, it
    torch.cuda.empty_cache()
    return counts


def _nn_cases():
    """Phase 61(a)'s cases: (op name, [(input name, numpy array)], attrs),
    the CPU tests' shapes, numpy-seeded. The inputs are the op's, in its
    order, parameters included."""
    import numpy as np
    rs = np.random.RandomState(SEED + 61)

    def u(*shape, lo=-1.0, hi=1.0):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def away(*shape):
        return (u(*shape, lo=0.3) * np.where(rs.rand(*shape) < 0.5, -1, 1)
                ).astype(np.float32)

    def const(*rows):
        return np.array(rows, np.float32)

    relu = np.maximum(u(2, 3, 8, 9), 0)
    return [
        ("LeakyReLU", [("data", away(2, 4))], {"act_type": "leaky",
                                               "slope": 0.3}),
        ("LeakyReLU", [("data", away(2, 4))], {"act_type": "elu",
                                               "slope": 0.3}),
        ("LeakyReLU", [("data", away(2, 3, 4)), ("gamma", u(3))],
         {"act_type": "prelu"}),
        ("LeakyReLU", [("data", u(3, 5))], {"act_type": "gelu"}),
        ("LeakyReLU", [("data", u(5, 16))], {"act_type": "rrelu",
                                             "lower_bound": 0.1,
                                             "upper_bound": 0.6}),
        ("Deconvolution", [("data", u(2, 3, 4, 4)), ("weight", u(3, 2, 4, 4)),
                           ("bias", u(2))],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "num_filter": 2,
          "no_bias": False}),
        ("Deconvolution", [("data", u(1, 4, 3, 3)), ("weight", u(4, 2, 3, 3))],
         {"kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
          "num_group": 2}),
        ("Deconvolution", [("data", u(2, 3, 5)), ("weight", u(3, 4, 3))],
         {"kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,),
          "num_filter": 4}),
        ("Deconvolution", [("data", u(1, 2, 3, 4)), ("weight", u(2, 3, 3, 3))],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (2, 3),
          "num_filter": 3}),
        ("UpSampling", [("arg0", u(1, 2, 2, 2)), ("arg1", u(1, 3, 4, 4))],
         {"scale": 2, "num_args": 2, "sample_type": "nearest"}),
        ("UpSampling", [("data", u(2, 3, 2, 3)), ("weight", u(3, 1, 5, 5))],
         {"scale": 3, "num_filter": 3, "sample_type": "bilinear"}),
        ("InstanceNorm", [("data", u(2, 3, 4, 5)), ("gamma", u(3)),
                          ("beta", u(3))], {"eps": 1e-5}),
        ("L2Normalization", [("data", away(2, 3, 4))], {"mode": "channel"}),
        ("L2Normalization", [("data", away(2, 3, 2, 2))],
         {"mode": "instance"}),
        ("SoftmaxActivation", [("data", u(2, 3, 2, 2))], {"mode": "channel"}),
        ("SoftmaxActivation", [("data", u(3, 4))], {}),
        ("Crop", [("data", u(1, 2, 6, 7)), ("crop_like", u(1, 1, 3, 4))],
         {"num_args": 2, "offset": (1, 2)}),
        ("Crop", [("data", u(2, 2, 5, 5))], {"num_args": 1, "offset": (4, 3),
                                             "h_w": (3, 3)}),
        ("Crop", [("data", u(1, 2, 6, 7))], {"num_args": 1, "h_w": (3, 3),
                                             "center_crop": True}),
        ("SequenceLast", [("data", u(4, 3, 2)),
                          ("sequence_length", const(0, 4, 1.7))],
         {"use_sequence_length": True}),
        ("SequenceMask", [("data", u(4, 3, 2)),
                          ("sequence_length", const(1, 4, 0))],
         {"use_sequence_length": True, "value": -1.5}),
        ("SequenceReverse", [("data", u(4, 3, 2)),
                             ("sequence_length", const(2, 4, 1))],
         {"use_sequence_length": True}),
        ("SequenceReverse", [("data", u(3, 2, 4))], {}),
        ("ROIPooling", [("data", relu), ("rois", const(
            [0, 0, 0, 15, 11], [1, 3, 2, 9, 14], [1, -4, -2, 30, 40],
            [0, 6, 6, 6, 6], [1, 40, 2, 50, 8]))],
         {"pooled_size": (3, 2), "spatial_scale": 0.5}),
        ("BilinearSampler", [("data", u(2, 3, 5, 4)),
                             ("grid", u(2, 2, 3, 4, lo=-1.3, hi=1.3))], {}),
        ("GridGenerator", [("data", u(2, 6))],
         {"transform_type": "affine", "target_shape": (7, 3)}),
        ("GridGenerator", [("data", u(1, 2, 4, 4, lo=-0.3, hi=0.3))],
         {"transform_type": "warp"}),
        ("SpatialTransformer", [("data", u(2, 3, 6, 6)),
                                ("loc", u(2, 6, lo=-0.8, hi=0.8))],
         {"transform_type": "affine", "sampler_type": "bilinear",
          "target_shape": (4, 5)}),
        ("Correlation", [("data1", u(1, 3, 5, 6)), ("data2", u(1, 3, 5, 6))],
         {"max_displacement": 2, "stride2": 2, "pad_size": 2}),
        ("LinearRegressionOutput", [("data", u(4, 3)), ("label", u(4, 3))],
         {"grad_scale": 2.0}),
        ("LogisticRegressionOutput", [("data", u(4, 1)),
                                      ("label", const([0], [1], [1], [0]))],
         {"grad_scale": 0.5}),
        ("MAERegressionOutput", [("data", u(2, 3, 2)), ("label", u(2, 3, 2))],
         {}),
        ("SVMOutput", [("data", u(5, 4)), ("label", const(0, 3, 1, 2, 7))],
         {"margin": 0.5, "regularization_coefficient": 2.0,
          "use_linear": True}),
        ("SVMOutput", [("data", u(5, 4)), ("label", const(1, 1, 0, 3, -1))],
         {"margin": 2.0}),
        ("IdentityAttachKLSparseReg", [("data", u(6, 3, lo=0.05, hi=0.95))],
         {"sparseness_target": 0.2, "penalty": 0.1}),
    ]


def _nn_run(mx, name, inputs, attrs, ctx, heads=True):
    """The op as a one-node graph on ``ctx``: a training forward under
    mx.random's key from SEED and, with ``heads``, a backward from head
    gradients U(0.5, 1.5) (numpy, SEED): (outputs, {input: gradient}),
    tensors on ``ctx``."""
    import numpy as np
    node = getattr(mx.sym, name)(*[mx.sym.var(k) for k, _ in inputs],
                                 name="t", **attrs)
    ex = node.simple_bind(ctx=ctx, grad_req="write" if heads else "null",
                          **{k: v.shape for k, v in inputs})
    mx.random.seed(SEED)
    outs = ex.forward(is_train=True, **{k: mx.nd.array(v, ctx=ctx)
                                        for k, v in inputs})
    if not heads:
        return [o.astorch() for o in outs], {}
    rs = np.random.RandomState(SEED)
    ex.backward([mx.nd.array(rs.uniform(0.5, 1.5, o.shape).astype(
        np.float32), ctx=ctx) for o in outs])
    return [o.astorch() for o in outs], {k: ex.grad_dict[k].astorch()
                                         for k, _ in inputs}


def _nn_err(got, want, grads=False):
    """The card's ``got`` against the CPU's ``want`` as a share of the
    limit (> 1 fails): outputs elementwise within NN_TOL (rtol and atol,
    NaN where NaN), gradients within NN_GRAD_RTOL of the largest |want|."""
    import torch
    want = want.to(got.device)
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    ok = ~torch.isnan(want)
    if not bool(ok.any()):
        return 0.0
    g, w = got[ok].double(), want[ok].double()
    if grads:
        return float((g - w).abs().max()) / (
            NN_GRAD_RTOL * max(float(w.abs().max()), 1e-30))
    return float(((g - w).abs() / (NN_TOL + NN_TOL * w.abs())).max())


def phase_nn_layers(mx):
    """Phase 61(a): the 20 remaining nn layers and losses (the nn layers,
    the regression outputs, SVMOutput, IdentityAttachKLSparseReg), each
    through a one-node Executor on gpu(0) and on the CPU from the same
    numpy inputs (``_nn_cases``), TF32 off: outputs and every input's
    gradient within the CPU tests' limits, rrelu's training output bit for
    bit; then Fast R-CNN's ROI pooling (ROI_REAL) and FlowNet-C's
    correlation (CORR_REAL) card vs CPU, forward, with each one's backward
    on the card (its device ms and peak allocation; the ROI gradient's
    total equals the head's over the non-empty cells)."""
    import numpy as np
    import torch
    print(_tf32(False) + " (the nn layers, card vs CPU)")
    names, worst = set(), {}
    for name, inputs, attrs in _nn_cases():
        want, want_g = _nn_run(mx, name, inputs, attrs, mx.cpu())
        got, got_g = _nn_run(mx, name, inputs, attrs, mx.gpu(0))
        if attrs.get("act_type") == "rrelu":
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            print(f"nn layers: rrelu's training output card vs CPU bit for "
                  f"bit: {same}")
            if not same:
                raise AssertionError("nn layers: rrelu's slopes differ on "
                                     "the card")
        err = max(_nn_err(g, w) for g, w in zip(got, want))
        gerr = max(_nn_err(got_g[k], w, grads=True)
                   for k, w in want_g.items())
        worst[name] = max(worst.get(name, 0.0), err, gerr)
        if not (err <= 1.0 and gerr <= 1.0):
            raise AssertionError(
                f"nn layers: {name}({attrs}) on the card differs from the "
                f"CPU: output {err:.3g}, gradient {gerr:.3g} of the limit")
        names.add(name)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"nn layers: {len(names)} op names card vs CPU, outputs and "
          f"gradients; worst of the limit (outputs {NN_TOL}, gradients "
          f"{NN_GRAD_RTOL} of max): " +
          ", ".join(f"{k} {v:.3g}" for k, v in top))
    if len(names) != 20:
        raise AssertionError(f"nn layers: {len(names)} op names, want 20")
    rs = np.random.RandomState(SEED + 62)
    shape, n_roi, pooled, scale = ROI_REAL
    h_img, w_img = shape[2] / scale, shape[3] / scale
    x1, y1 = rs.uniform(0, w_img - 32, n_roi), rs.uniform(0, h_img - 32, n_roi)
    rois = np.stack([np.zeros(n_roi), x1, y1,
                     np.minimum(x1 + rs.uniform(16, 400, n_roi), w_img - 1),
                     np.minimum(y1 + rs.uniform(16, 300, n_roi), h_img - 1)],
                    1).astype(np.float32)
    feats = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    c_shape, c_attrs = CORR_REAL
    real = [("ROIPooling", [("data", feats), ("rois", rois)],
             {"pooled_size": pooled, "spatial_scale": scale}),
            ("Correlation", [("data1", rs.randn(*c_shape).astype(np.float32)),
                             ("data2", rs.randn(*c_shape).astype(np.float32))],
             c_attrs)]
    for name, inputs, attrs in real:
        t0 = time.perf_counter()
        want, _ = _nn_run(mx, name, inputs, attrs, mx.cpu(), heads=False)
        cpu_s = time.perf_counter() - t0
        got, _ = _nn_run(mx, name, inputs, attrs, mx.gpu(0), heads=False)
        err = _nn_err(got[0], want[0])
        if not err <= 1.0:
            raise AssertionError(f"nn layers: {name} at its realistic shape "
                                 f"differs card vs CPU ({err:.3g} of the "
                                 "limit)")
        xs = [torch.tensor(v, device="cuda", requires_grad=True)
              for _, v in inputs]
        op = mx.ops.get_op(name)
        a = op.normalize_attrs(attrs)

        def fwd():
            return op.forward(a, xs, [], True, None)[0][0]
        out = fwd()
        g = torch.rand(out.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(SEED))

        def fwd_bwd():
            return torch.autograd.grad(fwd(), xs[0], g)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = fwd_bwd()[0]
        peak = torch.cuda.max_memory_allocated() - base
        if not bool(torch.isfinite(grads).all()):
            raise AssertionError(f"nn layers: {name}'s gradient at its "
                                 "realistic shape is not finite")
        line = (f"nn layers: {name} {tuple(inputs[0][1].shape)} {attrs}: "
                f"card vs CPU {err:.3g} of the limit (CPU forward "
                f"{cpu_s:.2f} s); card forward device_ms="
                f"{_device_ms(fwd, reps=5):.4f}, forward + backward "
                f"device_ms={_device_ms(fwd_bwd, reps=5):.4f}, "
                f"backward peak {peak / 2**20:.1f} MiB above the inputs")
        if name == "ROIPooling":
            from mxnet_tpu_torch.ops.nn import roi_bins
            _, ym, xm = roi_bins(xs[1], scale, pooled, shape[2:], shape[0])
            full = ym.any(-1)[:, None, :, None] & xm.any(-1)[:, None, None]
            mass = float((g * full).sum())
            got_mass = float(grads.sum())
            line += (f"; gradient total {got_mass:.6g} against the head's "
                     f"over the non-empty cells {mass:.6g}")
            if abs(got_mass - mass) > 1e-4 * mass or peak > ROI_PEAK_BYTES:
                raise AssertionError(f"nn layers: ROIPooling's backward at "
                                     f"Fast R-CNN's shape: gradient total "
                                     f"{got_mass} against {mass}, peak "
                                     f"{peak} bytes")
        print(line)
        del xs, out, grads
        torch.cuda.empty_cache()


def dcgan_generator(sym, ngf=GAN_NGF, nc=3):
    """``examples/dcgan.py``'s ``make_generator`` on ``sym`` (either
    package's symbol module): four transposed convolutions from the
    (N, code, 1, 1) ``rand`` to (N, nc, 32, 32), BatchNorm and ReLU
    between, tanh at the end."""
    g = sym.Deconvolution(sym.var("rand"), name="g1", kernel=(4, 4),
                          num_filter=ngf * 4, no_bias=True)
    g = sym.BatchNorm(g, name="gbn1", fix_gamma=False)
    g = sym.Activation(g, name="gact1", act_type="relu")
    for i, nf in ((2, ngf * 2), (3, ngf)):
        g = sym.Deconvolution(g, name=f"g{i}", kernel=(4, 4), stride=(2, 2),
                              pad=(1, 1), num_filter=nf, no_bias=True)
        g = sym.BatchNorm(g, name=f"gbn{i}", fix_gamma=False)
        g = sym.Activation(g, name=f"gact{i}", act_type="relu")
    g = sym.Deconvolution(g, name="g4", kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=nc, no_bias=True)
    return sym.Activation(g, name="gout", act_type="tanh")


def dcgan_discriminator(sym, ndf=GAN_NDF):
    """``examples/dcgan.py``'s ``make_discriminator`` on ``sym``: four
    convolutions from (N, 3, 32, 32) to one logit, LeakyReLU(0.2) between
    (BatchNorm after the second and third), then
    ``LogisticRegressionOutput`` against ``label`` (N, 1)."""
    d = sym.var("data")
    label = sym.var("label")
    for i, nf in enumerate((ndf, ndf * 2, ndf * 4)):
        d = sym.Convolution(d, name=f"d{i + 1}", kernel=(4, 4), stride=(2, 2),
                            pad=(1, 1), num_filter=nf, no_bias=True)
        if i:
            d = sym.BatchNorm(d, name=f"dbn{i + 1}", fix_gamma=False)
        d = sym.LeakyReLU(d, name=f"dact{i + 1}", act_type="leaky",
                          slope=0.2)
    d = sym.Convolution(d, name="d4", kernel=(4, 4), num_filter=1,
                        no_bias=True)
    return sym.LogisticRegressionOutput(sym.Flatten(d), label, name="dloss")


def dcgan_modules(mx, ctx, batch, ngf=GAN_NGF, ndf=GAN_NDF, code=GAN_CODE,
                  params=None, rng=None):
    """The generator Module (bound on ``rand``) and the discriminator
    Module (bound with ``inputs_need_grad=True``) of examples/dcgan.py on
    ``ctx``, either package as ``mx``: initialized by ``Normal(0.02)``
    (under mx.random, or from ``rng``, a torch.Generator of the port) or
    from ``params`` ((arg, aux) numpy dicts for each), Adam lr 2e-4, beta1
    0.5. Returns (modG, modD)."""
    modG = mx.mod.Module(dcgan_generator(mx.sym, ngf), data_names=("rand",),
                         label_names=None, context=ctx)
    modG.bind(data_shapes=[("rand", (batch, code, 1, 1))])
    modD = mx.mod.Module(dcgan_discriminator(mx.sym, ndf),
                         data_names=("data",), label_names=("label",),
                         context=ctx)
    modD.bind(data_shapes=[("data", (batch, 3, 32, 32))],
              label_shapes=[("label", (batch, 1))], inputs_need_grad=True)
    for i, mod in enumerate((modG, modD)):
        if params is not None:
            args, auxs = params[i]
            mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                        for k, v in args.items()},
                            aux_params={k: mx.nd.array(v, ctx=ctx)
                                        for k, v in auxs.items()})
        else:
            mod.init_params(mx.initializer.Normal(0.02) if rng is None
                            else mx.initializer.Normal(0.02, rng=rng))
        mod.init_optimizer(optimizer="adam", optimizer_params=dict(GAN_ADAM))
    return modG, modD


def dcgan_metric(mx):
    """The example's discriminator accuracy, a ``CustomMetric``."""
    return mx.metric.CustomMetric(
        lambda lab, pred: ((pred > 0.5) == (lab > 0.5)).mean(), name="dacc")


def _grads(mod, index, into):
    """Copy the gradients ``mod``'s update is about to use into ``into``
    as numpy, keyed ``"<index>:<name>"``."""
    if into is not None:
        into.update({f"{index}:{n}": g.asnumpy() for n, g in zip(
            mod._param_names, mod._exec_group.grad_arrays) if g is not None})


def dcgan_iteration(mx, modG, modD, noise, real, labels, metric, grads=None):
    """One iteration of examples/dcgan.py's loop, either package as
    ``mx``: the generator's forward on ``noise``; the discriminator's
    forward and backward on the fakes with label 0, its gradients stashed;
    on ``real`` with label 1, the stash added, an update; on the fakes
    with label 1, its input gradient through the generator's backward, an
    update. ``labels``: (ones, zeros) NDArrays (N, 1); ``grads``: a dict
    that takes the gradients each update used (``_grads``). Returns the
    fakes and the discriminator's three outputs (NDArrays)."""
    ones, zeros = labels
    batch = mx.io.DataBatch
    modG.forward(batch([noise], []), is_train=True)
    fake = modG.get_outputs()[0]
    modD.forward(batch([fake], [zeros]), is_train=True)
    modD.backward()
    stash = [g.copy() if g is not None else None
             for g in modD._exec_group.grad_arrays]
    out_fake = modD.get_outputs()[0]
    metric.update([zeros], [out_fake])
    modD.forward(batch([real], [ones]), is_train=True)
    modD.backward()
    for g, s in zip(modD._exec_group.grad_arrays, stash):
        if g is not None and s is not None:
            g += s
    _grads(modD, 1, grads)
    modD.update()
    out_real = modD.get_outputs()[0]
    metric.update([ones], [out_real])
    modD.forward(batch([fake], [ones]), is_train=True)
    modD.backward()
    modG.backward([modD.get_input_grads()[0]])
    _grads(modG, 0, grads)
    modG.update()
    return fake, [out_fake, out_real, modD.get_outputs()[0]]


def real_blobs(rs, n):
    """examples/dcgan.py's ``real_batch``: a bright gaussian blob at a
    random centre on a dark 32 x 32 ground, three equal channels, in
    [-1, 1]."""
    import numpy as np
    yy, xx = np.mgrid[0:32, 0:32]
    imgs = np.empty((n, 3, 32, 32), np.float32)
    for i in range(n):
        cy, cx = rs.uniform(8, 24, size=2)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0))
        imgs[i] = np.stack([blob] * 3) * 2 - 1
    return imgs


def _module_state(mods):
    """{name: numpy} of every parameter and moving statistic of the
    modules, prefixed by the module's index."""
    out = {}
    for i, mod in enumerate(mods):
        args, auxs = mod.get_params()
        for k, v in list(args.items()) + list(auxs.items()):
            out[f"{i}:{k}"] = v.asnumpy()
    return out


def _one_ulp(params, seed):
    """``params`` with every parameter (not the moving statistics) moved
    by one float32 ulp, up or down at random."""
    import numpy as np
    rs = np.random.RandomState(seed)
    step = np.float32(2.0 ** -23)
    return [({k: (v * (1 + step * rs.choice([-1, 1], v.shape))).astype(
        np.float32) for k, v in args.items()}, auxs) for args, auxs in params]


def _gan_diff(a, b):
    """Run ``a`` against run ``b``: (output error, moving-statistics error,
    largest parameter error, {module: share of elements past
    GAN_PARAM_ATOL}, {module: worst gradient error over each array's
    largest})."""
    import numpy as np
    out = max(float(np.abs(x - y).max())
              for x, y in zip(a["outputs"], b["outputs"]))
    aux, worst, past, elems, grad = 0.0, 0.0, {}, {}, {}
    for k, v in b["state"].items():
        d = np.abs(a["state"][k] - v)
        m = int(k[0])
        if k not in b["grads"]:               # a moving statistic
            aux = max(aux, float(d.max()))
            continue
        worst = max(worst, float(d.max()))
        past[m] = past.get(m, 0) + int((d > GAN_PARAM_ATOL).sum())
        elems[m] = elems.get(m, 0) + d.size
        g = b["grads"][k]
        grad[m] = max(grad.get(m, 0.0), float(np.abs(a["grads"][k] - g).max())
                      / max(float(np.abs(g).max()), 1e-30))
    return out, aux, worst, {m: past[m] / elems[m] for m in past}, grad


def dcgan_parity(mx, params, z, x, ctxs=None):
    """One DCGAN iteration on gpu(0) and on the CPU (``ctxs``) from
    ``params`` (as ``dcgan_modules`` takes them), noise ``z`` and real
    images ``x``, cuDNN deterministic (TF32 as the caller set it), and on
    the CPU again from the parameters moved by one ulp (``_one_ulp``):
    the card's outputs within GAN_OUT_ATOL of the CPU's, its moving
    statistics within GAN_PARAM_ATOL, every parameter within 2 lr +
    GAN_PARAM_ATOL, and each module's share of elements past
    GAN_PARAM_ATOL within GAN_SPREAD times the one-ulp run's plus
    GAN_FLIP_FLOOR. Returns the line that reports it (with the gradients
    each update used, against the one-ulp run's); raises on a
    difference."""
    import numpy as np
    batch = z.shape[0]
    ngf, ndf = params[0][0]["g3_weight"].shape[1], \
        params[1][0]["d1_weight"].shape[0]
    card, cpu = ctxs or (mx.gpu(0), mx.cpu())
    runs = []
    for ctx, start in ((card, params), (cpu, params),
                       (cpu, _one_ulp(params, SEED + 61))):
        mods = dcgan_modules(mx, ctx, batch, ngf, ndf, z.shape[1],
                             params=start)
        lab = (mx.nd.ones((batch, 1), ctx=ctx),
               mx.nd.zeros((batch, 1), ctx=ctx))
        grads = {}
        with _deterministic():
            fake, outs = dcgan_iteration(
                mx, *mods, mx.nd.array(z, ctx=ctx), mx.nd.array(x, ctx=ctx),
                lab, dcgan_metric(mx), grads=grads)
        runs.append({"outputs": [o.asnumpy() for o in [fake] + outs],
                     "state": _module_state(mods), "grads": grads})
    out, aux, worst, share, grad = _gan_diff(runs[0], runs[1])
    _, _, _, ulp_share, ulp_grad = _gan_diff(runs[2], runs[1])
    limit = {m: GAN_SPREAD * ulp_share[m] + GAN_FLIP_FLOOR for m in share}
    lr = GAN_ADAM["learning_rate"]
    names = ("generator", "discriminator")
    line = (f"dcgan parity: one iteration card vs CPU: the fakes and the "
            f"discriminator's three outputs within {out:.3g} (limit "
            f"{GAN_OUT_ATOL}); the moving statistics within {aux:.3g} "
            f"(limit {GAN_PARAM_ATOL}); the parameters within {worst:.3g} "
            f"(limit 2 lr + {GAN_PARAM_ATOL}); share of elements past "
            f"{GAN_PARAM_ATOL}: " + ", ".join(
                f"{names[m]} {share[m]:.3g} (the CPU's one-ulp run "
                f"{ulp_share[m]:.3g}, limit {limit[m]:.3g})" for m in share) +
            "; the gradients the updates used, worst over each array's "
            "largest: " + ", ".join(
                f"{names[m]} {grad[m]:.3g} (one-ulp run {ulp_grad[m]:.3g})"
                for m in grad))
    if not (out <= GAN_OUT_ATOL and aux <= GAN_PARAM_ATOL and
            worst <= 2 * lr + GAN_PARAM_ATOL and
            all(share[m] <= limit[m] for m in share)):
        raise AssertionError(f"{line}: the card's iteration differs from "
                             "the CPU's")
    return line


def phase_dcgan(mx, ck):
    """Phase 61(b): DCGAN through two Modules on gpu(0) at GAN_NGF /
    GAN_NDF, a GAN_CODE code and batch GAN_BATCH: after mx.random.seed
    the Normal(0.02) weights drawn on the card (the uniform kernel, one
    launch a weight), GAN_WARM + GAN_ITERS iterations of the example's
    loop (``dcgan_iteration``) with its CustomMetric, PyTorch's TF32
    default: generator samples a second and iteration p50 over the timed
    ones, exactly 2 ``adam_multi`` launches an iteration and no other port
    kernel, finite outputs; the device-busy share and launches of 2 more
    iterations under the profiler (``_profiled``, after one more
    unprofiled). Then one iteration card vs CPU from the same parameters
    and noise (TF32 off, cuDNN deterministic, ``dcgan_parity``). Returns
    the launches of the initialization and the timed iterations."""
    import numpy as np
    import torch
    print(_tf32(True) + " (PyTorch's default, for the DCGAN iterations)")
    rs = np.random.RandomState(SEED)
    mx.random.seed(SEED)
    ck.reset_launch_counts()
    modG, modD = dcgan_modules(mx, mx.gpu(0), GAN_BATCH)
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    weights = sum(1 for mod in (modG, modD)
                  for k in mod.get_params()[0] if k.endswith("weight"))
    print(f"dcgan: {weights} weights drawn on the card, "
          f"{counts.get('uniform', 0)} uniform launches")
    if counts != {"uniform": weights}:
        raise AssertionError(f"dcgan: launches while initializing {counts}")
    dev = mx.gpu(0)
    labels = (mx.nd.ones((GAN_BATCH, 1), ctx=dev),
              mx.nd.zeros((GAN_BATCH, 1), ctx=dev))
    metric = dcgan_metric(mx)
    n = GAN_WARM + GAN_ITERS
    noise = [mx.nd.array(rs.randn(GAN_BATCH, GAN_CODE, 1, 1).astype(
        np.float32), ctx=dev) for _ in range(n + 3)]
    real = [mx.nd.array(real_blobs(rs, GAN_BATCH), ctx=dev)
            for _ in range(n + 3)]
    ck.reset_launch_counts()
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fake, outs = dcgan_iteration(mx, modG, modD, noise[i], real[i],
                                     labels, metric)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loop = {k: v for k, v in ck.launch_counts().items() if v}
    for k, v in loop.items():
        counts[k] = counts.get(k, 0) + v
    per_iter = {k: v / n for k, v in loop.items()}
    timed = times[GAN_WARM:]
    p50 = float(np.median(timed))
    rate = GAN_BATCH * len(timed) / (sum(timed) / 1e3)
    name, dacc = metric.get()
    print(f"dcgan: {n} iterations ({GAN_WARM} warm-up) at ngf {GAN_NGF}, "
          f"ndf {GAN_NDF}, code {GAN_CODE}, batch {GAN_BATCH}: "
          f"{rate:.1f} generator samples/s over the {len(timed)} timed, "
          f"iteration p50 {p50:.2f} ms (min {min(timed):.2f}, max "
          f"{max(timed):.2f}); port kernel launches an iteration "
          f"{per_iter}; {name} {dacc:.3f}")
    if per_iter != {"adam_multi": 2.0}:
        raise AssertionError(f"dcgan: port kernel launches an iteration "
                             f"{per_iter}, want adam_multi 2")
    for o in [fake] + outs:
        if not bool(torch.isfinite(o.astorch()).all()):
            raise AssertionError("dcgan: an output is not finite")
    more = iter(range(n, n + 3))

    def step():
        i = next(more)
        dcgan_iteration(mx, modG, modD, noise[i], real[i], labels, metric)
    wall, busy, launches, groups = _profiled(step, 2, _kernel_group)
    print(f"dcgan profile: 2 iterations: wall {wall:.2f} ms/iteration, "
          f"device busy {busy:.2f} ms/iteration ({100 * busy / wall:.1f}% "
          f"of wall), {launches:.0f} kernel launches an iteration")
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g}: {t:.3f} ms/iteration ({100 * t / busy:.1f}% "
              f"of device time), {c:.0f} launches/iteration")
    del modG, modD, fake, outs
    torch.cuda.empty_cache()
    print(_tf32(False) + " (the DCGAN iteration, card vs CPU)")
    t0 = time.perf_counter()
    init = dcgan_modules(mx, mx.cpu(), GAN_BATCH,
                         rng=torch.Generator().manual_seed(SEED))
    params = [tuple({k: v.asnumpy() for k, v in d.items()}
                    for d in mod.get_params()) for mod in init]
    z = rs.randn(GAN_BATCH, GAN_CODE, 1, 1).astype(np.float32)
    x = real_blobs(rs, GAN_BATCH)
    print(dcgan_parity(mx, params, z, x) +
          f" ({time.perf_counter() - t0:.1f} s)")
    return counts


# --------------------------------------------------------------------------
# phase 62: the contrib ops and SSD (examples/ssd) through the port
# --------------------------------------------------------------------------
#: examples/ssd/symbol.py's per-scale anchors: (sizes, ratios), A = |sizes|
#: + |ratios| - 1 a pixel
SSD_SCALES = [
    ((0.15, 0.25), (1.0, 2.0, 0.5)),
    ((0.4, 0.55), (1.0, 2.0, 0.5)),
    ((0.7, 0.85), (1.0, 2.0, 0.5)),
]


def _ssd_conv_block(sym, data, num_filter, name, stride=(1, 1)):
    c = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), stride=stride,
                        num_filter=num_filter, name=f"{name}_conv")
    b = sym.BatchNorm(c, fix_gamma=False, name=f"{name}_bn")
    return sym.Activation(b, act_type="relu", name=f"{name}_relu")


def ssd_body(sym, data, width=32):
    """examples/ssd/symbol.py's ``_body``: three detection scales at /8,
    /16 and /32."""
    x = _ssd_conv_block(sym, data, width, "b1a")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="p1")
    x = _ssd_conv_block(sym, x, width * 2, "b2a")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="p2")
    x = _ssd_conv_block(sym, x, width * 2, "b3a")
    f1 = _ssd_conv_block(sym, x, width * 2, "b3b")
    x = sym.Pooling(f1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="p3")
    f2 = _ssd_conv_block(sym, x, width * 4, "b4a")
    x = sym.Pooling(f2, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="p4")
    f3 = _ssd_conv_block(sym, x, width * 4, "b5a")
    return [f1, f2, f3]


def ssd_multibox_layer(sym, features, num_classes):
    """examples/ssd/symbol.py's ``multibox_layer``: per scale a 3 x 3 loc
    and cls conv, channel-last flatten, and the scale's anchors ->
    (loc_preds, cls_preds (N, C + 1, A), anchors)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    for i, (feat, (sizes, ratios)) in enumerate(zip(features, SSD_SCALES)):
        num_anchors = len(sizes) + len(ratios) - 1
        loc = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name=f"loc_pred{i}_conv")
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(loc))
        cls = sym.Convolution(
            feat, kernel=(3, 3), pad=(1, 1),
            num_filter=num_anchors * (num_classes + 1),
            name=f"cls_pred{i}_conv")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Reshape(cls, shape=(0, -1, num_classes + 1))
        cls_layers.append(cls)
        anchor_layers.append(sym.MultiBoxPrior(
            feat, sizes=sizes, ratios=ratios, clip=True,
            name=f"anchors{i}"))
    loc_preds = sym.Concat(*loc_layers, dim=1, num_args=len(loc_layers),
                           name="loc_preds")
    cls_concat = sym.Concat(*cls_layers, dim=1, num_args=len(cls_layers))
    cls_preds = sym.transpose(cls_concat, axes=(0, 2, 1), name="cls_preds")
    anchors = sym.Concat(*anchor_layers, dim=1,
                         num_args=len(anchor_layers), name="anchors")
    return loc_preds, cls_preds, anchors


def ssd_train_symbol(sym, num_classes=2, width=32):
    """examples/ssd/symbol.py's ``get_train_symbol`` on ``sym`` (either
    package's symbol module): MultiBoxTarget with hard-negative mining
    (ratio 3), the class head a valid-normalized SoftmaxOutput that
    ignores -1, the box head a smooth-L1 MakeLoss, and the class targets
    as a third, gradient-free output."""
    data = sym.var("data")
    label = sym.var("label")
    loc_preds, cls_preds, anchors = ssd_multibox_layer(
        sym, ssd_body(sym, data, width), num_classes)
    tmp = sym.MultiBoxTarget(anchors, label, cls_preds,
                             overlap_threshold=0.5, ignore_label=-1,
                             negative_mining_ratio=3,
                             name="multibox_target")
    loc_target, loc_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target, ignore_label=-1,
                                 use_ignore=True, multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_mask * (loc_preds - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(sym.BlockGrad(cls_target), grad_scale=0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def ssd_detect_symbol(sym, num_classes=2, width=32, nms_threshold=0.45,
                      score_threshold=0.1):
    """examples/ssd/symbol.py's ``get_detect_symbol``: the class softmax
    and ``MultiBoxDetection`` over the same body and heads."""
    data = sym.var("data")
    loc_preds, cls_preds, anchors = ssd_multibox_layer(
        sym, ssd_body(sym, data, width), num_classes)
    cls_prob = sym.softmax(cls_preds, axis=1, name="cls_prob_det")
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                 nms_threshold=nms_threshold,
                                 threshold=score_threshold,
                                 force_suppress=False, clip=True,
                                 name="detection")


def ssd_metric(mx):
    """examples/ssd/train.py's ``MultiBoxMetric`` on ``mx`` (either
    package): the cross-entropy of the class head over the anchors its
    target keeps, and the mean smooth-L1 box loss a kept anchor."""
    import numpy as np

    class MultiBoxMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("MultiBox")
            self.num = 2
            self.reset()

        def reset(self):
            self.sum_metric = [0.0, 0.0]
            self.num_inst = [0, 0]

        def update(self, labels, preds):
            cls_prob = preds[0].asnumpy()
            loc_loss = preds[1].asnumpy()
            cls_label = preds[2].asnumpy()
            valid = cls_label >= 0
            idx = cls_label.astype(int)
            n, _, a = cls_prob.shape
            picked = cls_prob[np.arange(n)[:, None], idx,
                              np.arange(a)[None, :]]
            ce = -np.log(np.maximum(picked, 1e-12)) * valid
            self.sum_metric[0] += ce.sum()
            self.num_inst[0] += int(valid.sum())
            self.sum_metric[1] += loc_loss.sum()
            self.num_inst[1] += max(int(valid.sum()), 1)

        def get(self):
            return (["cross_entropy", "smooth_l1"],
                    [self.sum_metric[i] / max(self.num_inst[i], 1)
                     for i in range(2)])

    return MultiBoxMetric()


def shapes_dataset(n_images, size=96, rng=None, max_objects=3):
    """examples/ssd/data.py's ``make_shapes_dataset``: 1-3 coloured
    squares (class 0) and disks (class 1) on a noisy ground, with
    normalized [cls, x1, y1, x2, y2] labels."""
    import numpy as np
    rng = rng or np.random.RandomState(0)
    images, labels = [], []
    for _ in range(n_images):
        img = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
        n_obj = rng.randint(1, max_objects + 1)
        rows = []
        for _ in range(n_obj):
            side = rng.randint(size // 5, size // 2)
            x0 = rng.randint(0, size - side)
            y0 = rng.randint(0, size - side)
            color = rng.randint(120, 255, 3)
            cls = rng.randint(0, 2)
            if cls == 0:
                img[y0:y0 + side, x0:x0 + side] = color
            else:
                yy, xx = np.mgrid[0:size, 0:size]
                cy, cx = y0 + side / 2, x0 + side / 2
                mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= (side / 2) ** 2
                img[mask] = color
            rows.append([cls, x0 / size, y0 / size,
                         (x0 + side) / size, (y0 + side) / size])
        images.append(img)
        labels.append(np.array(rows, dtype=np.float32))
    return images, labels


def ssd_iters(mx, args, rng=None):
    """examples/ssd/train.py's ``build_iters`` on ``mx``: the training
    iterator (crop and pad with probability 0.5, mirror, shuffled) and
    the validation one, ``args`` as the example's namespace."""
    import numpy as np
    rng = rng or np.random.RandomState(42)
    imgs, labs = shapes_dataset(args.num_images, size=args.data_size,
                                rng=rng)
    vimgs, vlabs = shapes_dataset(
        max(args.num_images // 4, args.batch_size), size=args.data_size,
        rng=rng)
    shape = (3, args.data_size, args.data_size)
    train_aug = mx.image.CreateDetAugmenter(
        shape, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
        mean=np.zeros(3), std=np.full(3, 255.0))
    val_aug = mx.image.CreateDetAugmenter(shape, mean=np.zeros(3),
                                          std=np.full(3, 255.0))
    train = mx.image.ImageDetIter(args.batch_size, shape, imgs, labs,
                                  shuffle=True, aug_list=train_aug,
                                  max_objects=3)
    val = mx.image.ImageDetIter(args.batch_size, shape, vimgs, vlabs,
                                aug_list=val_aug, max_objects=3)
    return train, val


def ssd_detect(mx, mod, args, images, ctx):
    """examples/ssd/train.py's ``detect`` on ``ctx``: the detect symbol
    bound there with ``mod``'s parameters over ``images`` -> (N, A, 6)
    numpy, and the executor."""
    import numpy as np
    det_sym = ssd_detect_symbol(mx.sym, num_classes=2, width=args.width)
    shape = (len(images), 3, args.data_size, args.data_size)
    exe = det_sym.simple_bind(ctx=ctx, grad_req="null", data=shape)
    arg_params, aux_params = mod.get_params()
    exe.copy_params_from(arg_params, aux_params, allow_extra_params=True)
    batch = np.stack([img.astype(np.float32).transpose(2, 0, 1) / 255.0
                      for img in images])
    exe.forward(is_train=False, data=mx.nd.array(batch, ctx=ctx))
    return exe.outputs[0].asnumpy(), exe


def ssd_hits(dets, labs, iou=0.3):
    """tests/test_ssd.py's gate: the ground-truth boxes that one of the
    image's top len(gt) kept detections overlaps at IoU > ``iou``."""
    import numpy as np
    hits = 0
    for det, lab in zip(dets, labs):
        kept = det[det[:, 0] >= 0]
        if not len(kept):
            continue
        top = kept[np.argsort(-kept[:, 1])][: len(lab)]
        for gt in lab:
            gx1, gy1, gx2, gy2 = gt[1:5]
            for row in top:
                x1, y1, x2, y2 = row[2:6]
                ix = max(0, min(x2, gx2) - max(x1, gx1))
                iy = max(0, min(y2, gy2) - max(y1, gy1))
                inter = ix * iy
                union = (x2 - x1) * (y2 - y1) + \
                    (gx2 - gx1) * (gy2 - gy1) - inter
                if union > 0 and inter / union > iou:
                    hits += 1
                    break
    return hits


def _contrib_cases():
    """Phase 62(a)'s cases, the CPU tests' shapes, numpy-seeded: (op
    name, [(input name, numpy array)], attrs, whether its gradient is
    held). Integer inputs keep their dtype."""
    import numpy as np
    rs = np.random.RandomState(SEED + 62)

    def u(*shape, lo=-1.0, hi=1.0):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def const(*rows):
        return np.array(rows, np.float32)

    anchors = const([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                     [0.0, 0.0, 0.2, 0.2], [0.6, 0.1, 0.9, 0.4]])
    labels = const([[0, 0.12, 0.12, 0.38, 0.42], [1, 0.55, 0.5, 0.88, 0.92]],
                   [[1, 0.0, 0.0, 0.3, 0.25], [-1, 0, 0, 0, 0]])
    prior = np.concatenate([
        np.stack(np.meshgrid(np.arange(6) / 6, np.arange(6) / 6), -1)
        .reshape(-1, 2), np.stack(np.meshgrid(np.arange(6) / 6 + 0.3,
                                              np.arange(6) / 6 + 0.3), -1)
        .reshape(-1, 2)], 1)[None].astype(np.float32)
    span = (const(-1.0), const(1.0))
    return [
        ("_contrib_quantize", [("data", u(3, 7)), ("min_range", span[0]),
                               ("max_range", span[1])], {}, False),
        ("_contrib_quantize", [("data", u(3, 7, lo=-1.2, hi=1.2)),
                               ("min_range", span[0]),
                               ("max_range", span[1])],
         {"out_type": "int8"}, False),
        ("_contrib_dequantize", [("data", rs.randint(0, 256, (3, 7))
                                  .astype(np.uint8)),
                                 ("min_range", span[0]),
                                 ("max_range", span[1])], {}, False),
        ("_contrib_fft", [("data", u(2, 4))], {}, True),
        ("_contrib_ifft", [("data", u(2, 8))], {}, True),
        ("_contrib_count_sketch", [("data", u(3, 9)),
                                   ("h", const([0, 3, -1, -6, 2, 7, 1, -3,
                                                 5])),
                                   ("s", const([1, -1, 1, -1, 1, 1, -1, 1,
                                                -1]))], {"out_dim": 4},
         True),
        ("_contrib_ctc_loss", [("data", u(5, 2, 4)),
                               ("label", const([1, 2, 0], [2, 3, 1]))],
         {}, True),
        ("_contrib_ctc_loss", [("data", u(6, 3, 5)),
                               ("label", const([1, 1, 2], [0, 0, 0],
                                               [4, 3, 0])),
                               ("data_lengths", const(6, 4, 5)),
                               ("label_lengths", const(3, 0, 2))],
         {"use_data_lengths": True, "use_label_lengths": True}, True),
        ("MultiBoxPrior", [("data", u(1, 2, 5, 7))],
         {"sizes": (0.4, 0.8), "ratios": (1.0, 2.0, 0.5), "clip": True},
         False),
        ("MultiBoxTarget", [("anchor", anchors[None]), ("label", labels),
                            ("cls_pred", u(2, 3, 4, lo=0.0))],
         {"negative_mining_ratio": 3}, False),
        ("MultiBoxTarget", [("anchor", prior), ("label", labels),
                            ("cls_pred", np.zeros((2, 3, 36), np.float32))],
         {"negative_mining_ratio": 3, "minimum_negative_samples": 5},
         False),
        ("MultiBoxDetection", [
            ("cls_prob", rs.dirichlet(np.ones(3), (2, 36)).transpose(
                0, 2, 1).astype(np.float32)),
            ("loc_pred", u(2, 144, lo=-0.1, hi=0.1)), ("anchor", prior)],
         {"nms_threshold": 0.3}, False),
        ("MultiBoxDetection", [
            ("cls_prob", np.full((2, 3, 36), 1 / 3, np.float32)),
            ("loc_pred", np.zeros((2, 144), np.float32)), ("anchor", prior)],
         {"threshold": 0.2}, False),
        ("MultiProposal", [("cls_prob", u(2, 6, 4, 5, lo=0.0)),
                           ("bbox_pred", u(2, 12, 4, 5, lo=-0.2, hi=0.2)),
                           ("im_info", const([60, 70, 1.0], [50, 64, 0.5]))],
         {"feature_stride": 16, "scales": (1.0, 2.0, 4.0), "ratios": (1.0,),
          "rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
          "rpn_min_size": 4, "threshold": 0.5, "output_score": True},
         False),
    ]


#: phase 62(a)'s outputs held exactly card vs CPU: quantize's integers,
#: the anchors, MultiBoxTarget's loc_mask and cls_target, and
#: MultiBoxDetection's ids (its column 0)
CONTRIB_EXACT = {"_contrib_quantize": (0,), "MultiBoxPrior": (0,),
                 "MultiBoxTarget": (1, 2)}
CONTRIB_TOL, CTC_GRAD_RTOL, SKETCH_RTOL = 2e-5, 1e-5, 1e-6


def _contrib_run(mx, name, inputs, attrs, ctx, grads=False):
    """``name`` as a one-node graph on ``ctx``, each input's cell of its
    own dtype: an inference forward, or with ``grads`` a training forward
    and a backward from head gradients U(0.5, 1.5) (numpy, SEED) ->
    (outputs, {float input: gradient}) as tensors on ``ctx``."""
    import numpy as np
    node = getattr(mx.sym, name)(*[mx.sym.var(k) for k, _ in inputs],
                                 name="t", **attrs)
    floats = [k for k, v in inputs if v.dtype == np.float32]
    ex = node.simple_bind(
        ctx=ctx, grad_req={k: "write" if grads and k in floats else "null"
                           for k, _ in inputs},
        type_dict={k: v.dtype for k, v in inputs},
        **{k: v.shape for k, v in inputs})
    outs = ex.forward(is_train=grads, **{k: mx.nd.array(v, ctx=ctx)
                                         for k, v in inputs})
    if not grads:
        return [o.astorch() for o in outs], {}
    rs = np.random.RandomState(SEED)
    ex.backward([mx.nd.array(rs.uniform(0.5, 1.5, o.shape).astype(
        np.float32), ctx=ctx) for o in outs])
    return [o.astorch() for o in outs], {k: ex.grad_dict[k].astorch()
                                         for k in floats}


def _contrib_err(name, i, got, want):
    """Output ``i`` of ``name`` on the card against the CPU's, as a share
    of its limit (> 1 fails): exactly for CONTRIB_EXACT and
    MultiBoxDetection's ids, else within CONTRIB_TOL (rtol and atol;
    count_sketch also within SKETCH_RTOL of the largest magnitude)."""
    import torch
    want = want.to(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if i in CONTRIB_EXACT.get(name, ()):
        return 0.0 if torch.equal(got, want) else float("inf")
    if name == "MultiBoxDetection" and not torch.equal(got[..., 0],
                                                       want[..., 0]):
        return float("inf")
    g, w = got.double(), want.double()
    err = float(((g - w).abs() / (CONTRIB_TOL + CONTRIB_TOL * w.abs()))
                .max()) if g.numel() else 0.0
    if name == "_contrib_count_sketch":
        err = max(err, float((g - w).abs().max()) / (
            SKETCH_RTOL * max(float(w.abs().max()), 1e-30)))
    return err


def _ops_alone(fn, reps=3):
    """(device ms, busy ms, launches) of one call of ``fn`` on the card:
    CUDA events with the L2 flushed (``_device_ms``; past the launch
    queue's depth, about a thousand launches, the host's enqueue paces
    the card and this is the call's host time), and the profiler's sum of
    the call's kernel times and its launches."""
    wall, busy, launches, _ = _profiled(fn, 1, _kernel_group)
    return _device_ms(fn, reps=reps), busy, launches


def phase_contrib(mx, card=None):
    """Phase 62(a): the 10 contrib ops under all 23 of their names, each
    name through a one-node Executor on the card and on the CPU from the
    same numpy inputs (``_contrib_cases``; an alias runs its op's first
    case), TF32 off: quantize, the anchors, MultiBoxTarget's loc_mask and
    cls_target and MultiBoxDetection's ids exactly, every other output
    within CONTRIB_TOL (count_sketch also within SKETCH_RTOL of its
    largest), the gradients of fft, ifft, count_sketch and CTC within
    CTC_GRAD_RTOL of each one's largest; the ops with an NMS loop run
    twice on the card and repeat bit for bit."""
    import torch
    card = card or mx.gpu(0)
    print(_tf32(False) + " (the contrib ops, card vs CPU)")
    cases = _contrib_cases()
    firsts = {}
    for case in cases:
        firsts.setdefault(case[0], case)
    names = sorted(n for n in mx.ops.OP_REGISTRY
                   if mx.ops.get_op(n).name in firsts)
    runs = cases + [(n,) + firsts[mx.ops.get_op(n).name][1:]
                    for n in names if n not in firsts]
    worst = {}
    for name, inputs, attrs, grads in runs:
        canon = mx.ops.get_op(name).name
        want, want_g = _contrib_run(mx, name, inputs, attrs, mx.cpu(), grads)
        got, got_g = _contrib_run(mx, name, inputs, attrs, card, grads)
        errs = [_contrib_err(canon, i, g, w)
                for i, (g, w) in enumerate(zip(got, want))]
        errs += [float((got_g[k].double() - w.to(got_g[k].device).double())
                       .abs().max()) / (CTC_GRAD_RTOL * max(
                           float(w.abs().max()), 1e-30))
                 for k, w in want_g.items()]
        if canon in ("MultiBoxDetection", "MultiProposal"):
            again, _ = _contrib_run(mx, name, inputs, attrs, card)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"contrib: {name}({attrs}) does not "
                                     "repeat bit for bit on the card")
        err = max(errs)
        worst[name] = max(worst.get(name, 0.0), err)
        if not err <= 1.0:
            raise AssertionError(f"contrib: {name}({attrs}) on the card "
                                 f"differs from the CPU: {err:.3g} of the "
                                 "limit")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"contrib: {len(worst)} op names card vs CPU; the NMS ops repeat "
          f"bit for bit; worst of the limit: " +
          ", ".join(f"{k} {v:.3g}" for k, v in top))
    if len(worst) != 23:
        raise AssertionError(f"contrib: {len(worst)} op names, want 23")


def _ssd_args(**kw):
    import types
    return types.SimpleNamespace(**{**SSD_TRAIN, **kw})


def _seeded():
    import random
    import numpy as np
    random.seed(SEED)
    np.random.seed(SEED)


def phase_ssd_fit(mx, ck):
    """Phase 62(b): SSD at examples/ssd/train.py's defaults (SSD_TRAIN)
    through ``Module.fit`` on gpu(0) with the example's iterators,
    ``MultiBoxMetric`` and SGD, TF32 off: images a second and batch p50
    within each epoch (its first batch excluded), the port's kernel
    launches a step, the device-busy share and launches of 2 more steps
    under the profiler, and ``MultiBoxTarget``'s own device ms and
    launches at the step's inputs. Returns (the module, its launches)."""
    import numpy as np
    import torch
    args = _ssd_args()
    _seeded()
    mx.random.seed(SEED)
    train_it, val_it = ssd_iters(mx, args)
    net = ssd_train_symbol(mx.sym, num_classes=2, width=args.width)
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    metric = ssd_metric(mx)
    stamps = []

    def step_end(param):
        torch.cuda.synchronize()
        stamps.append((param.epoch, time.perf_counter()))
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(train_it, eval_data=val_it, eval_metric=metric,
            num_epoch=args.epochs, initializer=mx.initializer.Xavier(),
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, **SSD_SGD},
            batch_end_callback=[step_end])
    fit_s = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    steps = np.array([b - a for (ea, a), (eb, b) in zip(stamps, stamps[1:])
                      if ea == eb]) * 1e3
    rate = args.batch_size * len(steps) / (steps.sum() / 1e3)
    per_step = {k: v / len(stamps) for k, v in counts.items()}
    names, values = metric.get()
    print(f"ssd fit: {args.epochs} epochs of {len(stamps) // args.epochs} "
          f"batches at width {args.width}, {args.data_size} px, batch "
          f"{args.batch_size}, SGD lr {args.lr}: {fit_s:.2f} s; "
          f"{rate:.1f} images/s over {len(steps)} batches (each epoch's "
          f"first excluded), batch p50 {np.percentile(steps, 50):.2f} ms "
          f"(min {steps.min():.2f}, max {steps.max():.2f}); port kernel "
          f"launches a step {per_step}; validation "
          f"{dict(zip(names, (round(float(v), 6) for v in values)))}")
    if not all(np.isfinite(values)):
        raise AssertionError("ssd fit: the validation metric is not finite")
    for k in ("softmax", "softmax_ce_bwd", "sgd_mom_multi"):
        if not counts.get(k):
            raise AssertionError(f"ssd fit: the {k} kernel did not launch")
    train_it.reset()
    batch = next(iter(train_it))

    def step():
        mod.forward_backward(batch)
        mod.update()
    wall, busy, launches, groups = _profiled(step, 2, _kernel_group)
    print(f"ssd profile: 2 steps: wall {wall:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step ({100 * busy / wall:.1f}% of wall), "
          f"{launches:.0f} kernel launches a step")
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g}: {t:.3f} ms/step ({100 * t / busy:.1f}% of "
              f"device time), {c:.0f} launches/step")
    node = [n for n in net._topo_nodes() if n.name == "multibox_target"][0]
    inner = mx.sym.Group([net.get_internals()[k] for k in (
        "anchors_output", "cls_preds_output")])
    sub = inner.simple_bind(ctx=mx.gpu(0), grad_req="null",
                            data=batch.data[0].shape)
    sub.copy_params_from(*mod.get_params(), allow_extra_params=True)
    anc, cls = sub.forward(is_train=False, data=batch.data[0])
    lab = mx.nd.array(batch.label[0].asnumpy(), ctx=mx.gpu(0)).astorch()
    ins = [anc.astorch(), lab, cls.astorch()]
    op = mx.ops.get_op("MultiBoxTarget")
    ms, busy, n = _ops_alone(lambda: op.forward(node.attrs, ins, [], False,
                                                None))
    print(f"ssd MultiBoxTarget at a step's inputs ({ins[0].shape[1]} "
          f"anchors, batch {lab.shape[0]}): device_ms={ms:.4f}, kernels "
          f"{busy:.4f} ms, {n:.0f} launches a call")
    return mod, counts


def phase_ssd_gate(mx):
    """Phase 62(c): tests/test_ssd.py's ``test_ssd_trains_and_detects`` on
    gpu(0) at its settings (SSD_GATE: width 16, lr 0.02, 6 epochs of 96
    images, the iterators from RandomState(1)), its loop of
    ``forward_backward`` / ``update`` / ``update_metric``: the last
    epoch's cross-entropy under 0.6 of the first's, and at least half the
    ground-truth boxes of 4 images from RandomState(9) hit at IoU > 0.3
    by the decoded detections. Returns (the module, its args)."""
    import numpy as np
    args = _ssd_args(**SSD_GATE)
    _seeded()
    mx.random.seed(SEED)
    train_it, _ = ssd_iters(mx, args, rng=np.random.RandomState(1))
    mod = mx.mod.Module(ssd_train_symbol(mx.sym, 2, args.width),
                        data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    metric = ssd_metric(mx)
    ces = []
    for epoch in range(args.epochs):
        train_it.reset()
        metric.reset()
        for batch in train_it:
            if not mod.binded:
                mod.bind(train_it.provide_data, train_it.provide_label,
                         for_training=True)
                mod.init_params(mx.initializer.Xavier())
                mod.init_optimizer(optimizer="sgd", optimizer_params={
                    "learning_rate": args.lr, **SSD_SGD})
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
        ces.append(metric.get()[1][0])
    imgs, labs = shapes_dataset(4, size=args.data_size,
                                rng=np.random.RandomState(9))
    dets, _ = ssd_detect(mx, mod, args, imgs, mx.gpu(0))
    hits, total = ssd_hits(dets, labs), sum(len(lab) for lab in labs)
    print(f"ssd gate (tests/test_ssd.py's settings): cross-entropy by epoch "
          f"{[round(float(c), 4) for c in ces]} (last / first "
          f"{ces[-1] / ces[0]:.3f}, limit 0.6); {hits} of {total} "
          f"ground-truth boxes hit at IoU > 0.3 (limit half)")
    if not (ces[-1] < 0.6 * ces[0] and hits >= total * 0.5):
        raise AssertionError("ssd gate: the convergence gate of "
                             "tests/test_ssd.py fails on the card")
    return mod, args


def _kept_rows(det):
    """The kept rows of one image's (A, 6) detections, ordered by score,
    and whether two of their scores lie within 1e-5."""
    import numpy as np
    kept = det[det[:, 0] >= 0]
    kept = kept[np.argsort(-kept[:, 1], kind="stable")]
    near = bool(len(kept) > 1 and np.diff(-kept[:, 1]).min() < 1e-5)
    return kept, near


def phase_ssd_detect(mx, mod, args):
    """Phase 62(d): the detect symbol from ``mod``'s parameters on the
    same 4 images on gpu(0) and on the CPU, TF32 off: per image the same
    number of kept rows, their ids equal and values within CONTRIB_TOL,
    ordered by score where no two scores lie within 1e-5 and else as sets
    (ordered by id and box); the decode's device ms and launches (the
    whole forward, and ``MultiBoxDetection`` alone at its inputs)."""
    import numpy as np
    imgs, _ = shapes_dataset(4, size=args.data_size,
                             rng=np.random.RandomState(7))
    got, exe = ssd_detect(mx, mod, args, imgs, mx.gpu(0))
    want, _ = ssd_detect(mx, mod, args, imgs, mx.cpu())
    kept_n, near_n = 0, 0
    for g, w in zip(got, want):
        (gk, gnear), (wk, wnear) = _kept_rows(g), _kept_rows(w)
        if gnear or wnear:
            near_n += 1
            gk, wk = (k[np.lexsort(k[:, ::-1].T)] for k in (gk, wk))
        if gk.shape != wk.shape or not np.array_equal(gk[:, 0], wk[:, 0]) \
                or not np.allclose(gk, wk, rtol=CONTRIB_TOL,
                                   atol=CONTRIB_TOL):
            raise AssertionError("ssd detect: the kept detections differ "
                                 "card vs CPU")
        kept_n += len(gk)
    batch = mx.nd.array(np.stack([img.astype(np.float32).transpose(2, 0, 1)
                                  / 255.0 for img in imgs]), ctx=mx.gpu(0))
    fwd_ms, fwd_busy, fwd_n = _ops_alone(lambda: exe.forward(
        is_train=False, data=batch))
    op = mx.ops.get_op("MultiBoxDetection")
    node = [n for n in exe._symbol._topo_nodes()
            if n.name == "detection"][0]
    inner = mx.sym.Group([exe._symbol.get_internals()[k] for k in (
        "cls_prob_det_output", "loc_preds_output", "anchors_output")])
    sub = inner.simple_bind(ctx=mx.gpu(0), grad_req="null",
                            data=batch.shape)
    sub.copy_params_from(*mod.get_params(), allow_extra_params=True)
    ins = [o.astorch() for o in sub.forward(is_train=False, data=batch)]
    ms, busy, n = _ops_alone(lambda: op.forward(node.attrs, ins, [], False,
                                                None))
    print(f"ssd detect: 4 images, {kept_n} kept detections card vs CPU "
          f"({near_n} images compared as sets for scores within 1e-5); "
          f"the detect forward device_ms={fwd_ms:.4f}, kernels "
          f"{fwd_busy:.4f} ms, {fwd_n:.0f} launches; MultiBoxDetection "
          f"alone ({ins[2].shape[1]} anchors, its NMS loop) device_ms="
          f"{ms:.4f}, kernels {busy:.4f} ms, {n:.0f} launches")


#: Faster R-CNN's RPN proposals at the op's defaults: stride 16, 12
#: anchors (scales 4, 8, 16, 32 x ratios 0.5, 1, 2), pre 6000, post 300,
#: over the 38 x 63 conv5_3 map of a 600 x 1000 image
MP_REAL = ((1, 38, 63), {"feature_stride": 16,
                         "scales": (4.0, 8.0, 16.0, 32.0),
                         "ratios": (0.5, 1.0, 2.0),
                         "rpn_pre_nms_top_n": 6000,
                         "rpn_post_nms_top_n": 300, "threshold": 0.7,
                         "rpn_min_size": 16, "output_score": True})
#: CTC at a speech-like shape: T 100 frames, batch 32, 29 classes (blank,
#: 26 letters, space, apostrophe), labels of 5 to 20
CTC_REAL = (100, 32, 29, 20)


def phase_proposal_ctc(mx):
    """Phase 62(e, f): MultiProposal at Faster R-CNN's defaults (MP_REAL)
    card vs CPU, the rois within CONTRIB_TOL and the scores equal where
    the rank is the same (twice on the card, bit for bit); CTC at
    CTC_REAL, loss within CONTRIB_TOL and the gradient within
    CTC_GRAD_RTOL of its largest, card vs CPU. Each one's device ms (CTC:
    forward plus backward) and launches."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SEED + 63)
    (n, h, w), attrs = MP_REAL
    a = len(attrs["scales"]) * len(attrs["ratios"])
    # centre shifts only: with the log-size deltas 0 (exp(0) is 1 on
    # either device) the boxes are the same bits on the card and the CPU,
    # where ulps of exp would move some of the 6000^2 IoUs across 0.7
    deltas = rs.normal(0, 0.1, (n, a, 4, h, w)).astype(np.float32)
    deltas[:, :, 2:] = 0.0
    inputs = [("cls_prob", rs.uniform(0, 1, (n, 2 * a, h, w)).astype(
                  np.float32)),
              ("bbox_pred", deltas.reshape(n, 4 * a, h, w)),
              ("im_info", np.array([[600.0, 1000.0, 1.0]], np.float32))]
    t0 = time.perf_counter()
    want, _ = _contrib_run(mx, "MultiProposal", inputs, attrs, mx.cpu())
    cpu_s = time.perf_counter() - t0
    got, _ = _contrib_run(mx, "MultiProposal", inputs, attrs, mx.gpu(0))
    again, _ = _contrib_run(mx, "MultiProposal", inputs, attrs, mx.gpu(0))
    err = max(_contrib_err("MultiProposal", i, g, wt)
              for i, (g, wt) in enumerate(zip(got, want)))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    op = mx.ops.get_op("MultiProposal")
    at = op.normalize_attrs(attrs)
    ins = [torch.tensor(v, device="cuda") for _, v in inputs]
    ms, busy, launches = _ops_alone(
        lambda: op.forward(at, ins, [], False, None), reps=2)
    print(f"MultiProposal at Faster R-CNN's shape ({2 * a} x {h} x {w}, "
          f"pre {attrs['rpn_pre_nms_top_n']}, post "
          f"{attrs['rpn_post_nms_top_n']}): card vs CPU {err:.3g} of the "
          f"limit, repeats bit for bit: {same} (CPU {cpu_s:.2f} s); "
          f"device_ms={ms:.4f}, kernels {busy:.4f} ms, {launches:.0f} "
          f"launches a call")
    if not (err <= 1.0 and same):
        raise AssertionError("MultiProposal at its realistic shape differs "
                             "card vs CPU or does not repeat")
    T, N, C, L = CTC_REAL
    lens = rs.randint(5, L + 1, N)
    label = np.zeros((N, L), np.float32)
    for i, k in enumerate(lens):
        label[i, :k] = rs.randint(1, C, k)
    inputs = [("data", rs.randn(T, N, C).astype(np.float32)),
              ("label", label)]
    want, want_g = _contrib_run(mx, "CTCLoss", inputs, {}, mx.cpu(), True)
    got, got_g = _contrib_run(mx, "CTCLoss", inputs, {}, mx.gpu(0), True)
    err = _contrib_err("CTCLoss", 0, got[0], want[0])
    truth = ctc_float64_grad(mx, inputs[0][1], label)
    card_err, cpu_err = (float((g["data"].cpu().double() - truth).abs().max())
                         / float(truth.abs().max()) for g in (got_g, want_g))
    op = mx.ops.get_op("CTCLoss")
    x = torch.tensor(inputs[0][1], device="cuda", requires_grad=True)
    lab = torch.tensor(label, device="cuda")
    head = torch.ones(N, device="cuda")

    def fwd_bwd():
        loss = op.forward(op.normalize_attrs({}), [x, lab], [], True,
                          None)[0][0]
        return torch.autograd.grad(loss, x, head)
    ms, busy, launches = _ops_alone(fwd_bwd)
    print(f"CTC at (T {T}, N {N}, C {C}, labels of 5-{L}): loss card vs "
          f"CPU {err:.3g} of the limit; the gradient's distance from the "
          f"CPU's float64 gradient, over its largest: card {card_err:.3g}, "
          f"CPU float32 {cpu_err:.3g} (limit {CTC_SPREAD} times the CPU's);"
          f" forward + backward device_ms={ms:.4f}, kernels {busy:.4f} ms, "
          f"{launches:.0f} launches")
    if not (err <= 1.0 and card_err <= CTC_SPREAD * cpu_err):
        raise AssertionError("CTC at its realistic shape differs card vs "
                             "CPU")


#: CTC at CTC_REAL: alpha reaches -400 over 100 frames, where a float32
#: ulp is 3e-5, so the gradient of either device is held to the CPU's
#: float64 one, the card within CTC_SPREAD times the CPU's float32 distance
CTC_SPREAD = 3


def ctc_float64_grad(mx, data, label):
    """The CTC loss's gradient of ``data`` (T, N, C) on the CPU in float64
    under ``_contrib_run``'s head gradient, the reference both float32
    runs are held to."""
    import numpy as np
    import torch
    op = mx.ops.get_op("CTCLoss")
    x = torch.tensor(data, dtype=torch.float64, requires_grad=True)
    loss = op.forward(op.normalize_attrs({}), [x, torch.tensor(label)], [],
                      True, None)[0][0]
    head = np.random.RandomState(SEED).uniform(0.5, 1.5, loss.shape)
    return torch.autograd.grad(loss, x, torch.tensor(head))[0]


def phase_ssd(mx, ck):
    """Phase 62: the contrib ops card vs CPU, SSD's fit at the example's
    defaults, the convergence gate of tests/test_ssd.py, the decode card
    vs CPU, MultiProposal and CTC at realistic shapes. Returns the port
    kernels' launches of the SSD fit."""
    import torch
    tick = _PhaseClock()
    phase_contrib(mx)
    tick("62(a) (the contrib ops)")
    print(_tf32(False) + " (SSD)")
    mod, counts = phase_ssd_fit(mx, ck)
    del mod
    tick("62(b) (SSD fit)")
    gate_mod, args = phase_ssd_gate(mx)
    tick("62(c) (SSD gate)")
    phase_ssd_detect(mx, gate_mod, args)
    del gate_mod
    tick("62(d) (SSD detect)")
    phase_proposal_ctc(mx)
    tick("62(e, f) (MultiProposal, CTC)")
    torch.cuda.empty_cache()
    return counts


class _PhaseClock:
    """Prints, on a line of its own, the seconds since the last call (or
    since it was made) under the phase's name."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, label):
        now = time.perf_counter()
        print(f"chip_smoke: phase {label} took {now - self.t:.1f} s")
        self.t = now


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")):
        print("chip_smoke: run from the root of a checkout (no "
              "mxnet_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    tick = _PhaseClock()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = phase_build(ck)
    tick("1 (build)")
    rec = phase_kernels(mx, ck)
    tick("2 (kernels)")
    serve_counts, sym, params, prompts, served = phase_serve(mx, ck)
    tick("3 (serve)")
    phase_profile(mx, sym, params)
    tick("4 (decode profile)")
    train_counts, train_mod, train_it, sgd_per_array = phase_train(mx, ck)
    tick("5 (ResNet-50 fit)")
    phase_train_parity(mx)
    tick("6 (ResNet-50 parity)")
    adam_counts = phase_adam(mx, ck)
    tick("7 (Adam)")
    phase_train_profile(train_mod, train_it)
    tick("8 (ResNet-50 profile)")
    del train_mod, train_it
    lm_counts, lm_mod, lm_it = phase_lm_train(mx, ck)
    tick("9 (LM fit)")
    phase_lm_parity(mx)
    tick("10 (LM parity)")
    phase_train_profile(lm_mod, lm_it, label="lm profile",
                        gemm_flops=_lm_gemm_flops())
    tick("11 (LM profile)")
    del lm_mod, lm_it
    torch.cuda.empty_cache()
    q_mod, quant_counts, q_servers, float_outs = phase_quant_serve(mx, ck)
    tick("12 (quantized serving)")
    phase_quant_parity(mx, q_mod, q_servers)
    tick("13 (quantized parity)")
    phase_quant_profile(q_servers)
    phase_quant_hoist(mx, ck, q_mod)
    tick("14 (quantized profile, prologue A/B)")
    cbr_counts = phase_fused_train(mx, ck)
    tick("15 (fused fit)")
    phase_fused_parity(mx, ck)
    tick("16 (fused parity)")
    cbr_serve_counts, f_server = phase_fused_serve(mx, ck, q_mod, float_outs)
    tick("17 (fused serving)")
    phase_fused_profile(mx, f_server, q_servers["float32"])
    tick("18 (fused profile)")
    bf16_counts, bf16_mods = phase_bf16_train(mx, ck)
    tick("24 (bfloat16 ResNet-50 fit)")
    phase_bf16_parity(mx)
    tick("25 (bfloat16 parity)")
    bf16_serve_counts, bf16_servers = phase_bf16_serve(mx, ck, q_mod,
                                                       float_outs)
    tick("26 (bfloat16 serving)")
    phase_bf16_profile(bf16_mods, bf16_servers)
    tick("27 (bfloat16 profile)")
    del bf16_mods
    f16_counts, f16_mods = phase_bf16_train(mx, ck, "float16")
    del f16_mods
    tick("38 (float16 ResNet-50 fit)")
    phase_bf16_parity(mx, "float16")
    tick("39 (float16 parity)")
    f16_serve_counts, f16_servers = phase_bf16_serve(mx, ck, q_mod,
                                                     float_outs, "float16")
    tick("40 (float16 serving)")
    quant_half_counts = phase_quant_half(mx, ck, q_mod)
    tick("41 (quantized 16-bit)")
    for server in list(q_servers.values()) + [f_server] + \
            list(bf16_servers.values()) + list(f16_servers.values()):
        server.stop()
    mx.telemetry.trace.configure(capacity=1 << 16)
    cpu_ref = _CpuRef(mx, params)
    prefill_sched = phase_prefill(mx, ck, params, cpu_ref)
    tick("19 (chunked prefill)")
    spec_sched = phase_spec(mx, ck, params, prompts, cpu_ref)
    tick("20 (speculation)")
    phase_prefix(mx, ck, params)
    tick("21 (prefix store)")
    fp8_launches = phase_fp8(mx, ck, params, prompts)
    tick("22 (fp8 cache)")
    phase_fastpath_profile(mx, prefill_sched, spec_sched)
    tick("23 (fast-path profile)")
    del prefill_sched, spec_sched
    bf16_decode_counts, bf16_scheds, bf16_chains = phase_bf16_decode(
        mx, ck, params, prompts)
    tick("32 (bfloat16 decode)")
    phase_bf16_fastpaths(mx, ck, params, prompts, bf16_chains, cpu_ref)
    tick("33 (bfloat16 fast paths)")
    phase_bf16_decode_profile(mx, bf16_scheds)
    tick("34 (bfloat16 decode profile)")
    del bf16_scheds
    f16_decode_counts, f16_scheds, f16_chains = phase_bf16_decode(
        mx, ck, params, prompts, "float16")
    del f16_scheds
    tick("42 (float16 decode)")
    phase_bf16_fastpaths(mx, ck, params, prompts, f16_chains, cpu_ref,
                         "float16")
    tick("43 (float16 fast paths)")
    torch.cuda.empty_cache()
    user_rec, axpb_launches = phase_rtc(mx)
    tick("28 (mx.rtc)")
    args50, auxs50, _, _ = _resnet50_start(mx, 2)
    relu_rec, relu_counts = phase_user_op(mx, args50, auxs50)
    tick("29 (user op)")
    user_rec = {"rtc_axpb": user_rec, **relu_rec}
    phase_custom_op(mx, args50, auxs50)
    tick("30 (CustomOp)")
    phase_autograd(mx)
    tick("31 (autograd)")
    del args50, auxs50
    torch.cuda.empty_cache()
    bf16_lm_counts, lm_mods = phase_lm_bf16_train(mx, ck)
    tick("35 (bfloat16 LM fit)")
    phase_lm_bf16_parity(mx)
    tick("36 (bfloat16 LM parity)")
    phase_lm_bf16_profile(mx, lm_mods)
    tick("37 (bfloat16 LM profile)")
    del lm_mods
    f16_lm_counts, lm_mods = phase_lm_bf16_train(mx, ck, "float16")
    del lm_mods
    tick("44 (float16 LM fit)")
    phase_lm_bf16_parity(mx, "float16", n_layer=F16_LM_PARITY_LAYERS,
                         seq=F16_LM_PARITY_SEQ)
    tick("45 (float16 LM parity)")
    torch.cuda.empty_cache()
    ring_counts = {"float32": phase_ring_fit(mx, ck)}
    tick("46 (ring fit)")
    phase_ring_layer(mx)
    tick("47 (ring layer)")
    for half in HALF_SFX:
        ring_counts[half] = phase_ring_half(mx, ck, half)
    tick("48 (16-bit ring fits)")
    frozen_counts = phase_lm_frozen(mx, ck)
    tick("49 (frozen fine-tuning)")
    dh32_counts = phase_headdim32(mx, ck, params, prompts)
    tick("50 (head dim 32)")
    headdim_counts = phase_headdims(mx, ck, prompts)
    tick("51 (head dims)")
    refused_counts = phase_refused_inputs(mx, ck, prompts, params, cpu_ref,
                                          q_mod)
    tick("52 (inputs the card refused)")
    del q_mod
    torch.cuda.empty_cache()
    zoo_counts = phase_zoo(mx, ck)
    tick("53 (AlexNet, VGG-16, Inception-BN, Inception-v3)")
    lm_drop_counts = phase_lm_dropout(mx, ck)
    tick("54 (the LM with Dropout)")
    torch.cuda.empty_cache()
    lm_resume_counts = phase_lm_resume(mx, ck)
    tick("55 (the LM through kill and resume)")
    r50_resume_counts = phase_resnet_resume(mx, ck)
    tick("56 (ResNet-50 through kill and resume)")
    pred_counts, pred_server, pred_reqs, pred_outs = phase_predictor(
        mx, ck, params, prompts, served)
    tick("57 (the Predictor)")
    phase_warm_restart(mx, ck, pred_server, pred_reqs, pred_outs)
    del pred_server
    tick("58 (a warm restart)")
    sampler_counts = phase_samplers16(mx, ck)
    tick("59 (16-bit samplers)")
    phase_tensor_surface(mx)
    custom_counts = phase_custom_loss(mx, ck)
    tick("60 (the tensor surface)")
    phase_nn_layers(mx)
    dcgan_counts = phase_dcgan(mx, ck)
    tick("61 (the nn layers and losses, DCGAN)")
    ssd_counts = phase_ssd(mx, ck)
    tick("62 (the contrib ops, SSD)")
    launches = dict(train_counts)
    launches.update({k: serve_counts[k] for k in DECODE_KERNELS})
    launches.update({k: lm_counts[k] for k in LM_KERNELS})
    launches.update(quant_counts)
    launches.update({k: cbr_counts[k] + cbr_serve_counts[k]
                     for k in CBR_KERNELS})
    launches["decode_attention_fp8"] = fp8_launches
    for name in BF16_KERNELS:
        launches[name] = sum(c[name] for c in bf16_counts.values()) + \
            bf16_serve_counts.get(name, 0)
    launches.update(bf16_decode_counts)
    launches.update({k: bf16_lm_counts[k] for k in BF16_LM_KERNELS})
    for name in _halved(BF16_KERNELS, "float16"):
        launches[name] = sum(c[name] for c in f16_counts.values()) + \
            f16_serve_counts.get(name, 0)
    launches.update(f16_decode_counts)
    launches.update({k: f16_lm_counts[k]
                     for k in _halved(BF16_LM_KERNELS, "float16")})
    for k, n in quant_half_counts.items():
        launches[k] = launches.get(k, 0) + n
    for dtype, counts in ring_counts.items():
        name = "flash_attention_partial" + (
            "" if dtype == "float32" else "_" + HALF_SFX[dtype])
        launches[name] = counts[name]
    launches.update(frozen_counts)
    for counts in (dh32_counts, headdim_counts, refused_counts, zoo_counts,
                   lm_drop_counts, lm_resume_counts, r50_resume_counts,
                   pred_counts, sampler_counts, custom_counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    # the per-array kernels' launches: a caller's own Updater(i, g, w)
    # loop (phases 5 and 7), the path Module.update no longer takes
    launches["sgd_mom"] = sgd_per_array
    for k in ("adam", "adam_multi"):
        launches[k] = adam_counts[k]
    # DCGAN's two Module.update calls an iteration (phase 61), SSD's fit
    # (phase 62)
    for counts in (dcgan_counts, ssd_counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    kernels = []
    for name in ck.launch_counts():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": ck.source(name),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    user_launches = {"rtc_axpb": axpb_launches,
                     "relu_user": relu_counts["relu_user"],
                     "relu_user_vjp": relu_counts["relu_user_vjp"]}
    for name in USER_KERNELS:
        r = user_rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "chip_smoke.py",
            "replaces": REPLACES[name], "launches": user_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels that did not launch on their path: "
                             f"{idle}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
