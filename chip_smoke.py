#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out FILE.json]
                          [--only stream|a8|conv|attn|ssd|dec|pool|load|
                                  decwin|moe|train|tp|pipeline|sharded]

Phases, each printed as it runs; any failure raises and the script exits
non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the TF32 flags (both forced off: the kernels and their
   plain versions compare in full float32), and the kernels' build from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) with its time.
2. Kernels: each CUDA kernel held against its plain PyTorch version on
   the card at shapes the compiled yolov8n at 640 gives it (batch 8;
   every conv case is checked to be a conv launch of that graph), with
   its time (CUDA events over back-to-back launches, after warm-up), the
   plain version's time, one PyTorch library call's time as a yardstick
   (never called by the port), and the bound from
   ``repro_torch.roofline.analysis`` on its H100 SXM entry: max(FLOPs /
   the peak of the route's math, times its passes, bytes / 3.35 TB/s). #3
   (``maxpool2d``, ``kernel_cases``) at the kernel table's three earlier
   cases (POOL_EARLIER: yolov8n's SPPF pool at 640 and two 2×2 pools) and
   at yolov3-tiny's six pool launches at 416 (V3T_POOLS, batch 8; each
   checked to be a maxpool launch of the compiled yolov3-tiny graph, its
   activation included); each prints its plan (``pool_plan``), launches
   twice, bit-equal, and is read both ways; the sums over the earlier
   three and over the six print apart (``pool_sums``); NaN inputs give
   #3's NaN where its plain version has them, on both routes, and
   ``pointwise(relu)``'s likewise (``nan_probe``). #1 (``conv2d``)
   at CONV_CASES: the seven earlier cases (CONV_EARLIER) and two short-M
   launches (M = 3200, K split); bound by its route, three TF32 passes
   at 495 TFLOP/s (``KERNEL_ROUTES`` of ``repro_torch.roofline.
   analysis``), the fp32 bound printed beside; each case
   prints its plan, launches twice, bit-equal, and is read both ways
   (``conv_cases``, with #2's), and the sums over the seven earlier
   cases print apart (``conv_sums``).
   #4 and #5 (``stream_cases``): main's two resizes at 640 (20×20×256
   and 40×40×128, each checked to be a resize launch of the compiled
   graph), the 7 activations on 8×80×80×64, and silu at fusion_off's
   largest and smallest activation launches (8×80×80×16, 8×5×5×64);
   each launches twice, bit-equal, and is read both ways: back to back
   and, for the kernel and the library call, device time and host
   issue per call (``per_call_ms``); the sums print on their own lines
   (#5's 7 activation cases are the kernel table's earlier ones).
   ``issue_split`` then times one #5 call's host issue by parts, the
   launch path's steps in their earlier form and as they are now.
   The quantized matmuls (``csrc/qmatmul.cu``) are checked the same way
   at the matmul shapes of the quantized yolov8n at 640 (im2col rows
   M = 8·Ho·Wo, K = K·K·C, N = F): int8, int16 and packed-int4 codes,
   the int32 accumulator bit-equal, per-group scales aligned (grouped
   kernel) and unaligned (the float kernel, as the JAX package does);
   their bound uses the int8 tensor-core peak (1979 TOPS) for the A8
   kernels, and for #7 the dense TF32 peak (495 TFLOP/s) over its
   passes (2 a product, 4 with int16 codes: ``KERNEL_ROUTES``), the route
   its tensor-core kernel takes at fp32 accuracy; every #7, #8 and #10
   case prints its plan (BM, BN, splits; ``_plan`` / ``_plan_a8``),
   launches twice, bit-equal, and is read both ways: its device time and
   its yardstick's beside the back-to-back ones (``per_call_ms``:
   launches queued behind a spin, the host's issue hidden), and the host
   issue per call. #8 and #10 also run at the widest N among the
   graph's matmul launches, and their sums over the earlier 6 and 10
   cases print on lines of their own (``a8_sums``); #10 at the stem is
   checked to launch on the caller's own codes (``a8_pointer_check``:
   no padded copy). Their
   yardstick is ``torch._int_mm`` (K zero-padded to a
   multiple of 8 outside the timed call, so the stem's K = 27 is timed
   too; "n/a" where its other shape rules refuse the case) or
   ``torch.matmul`` on the dequantized weight (TF32 off). The unaligned
   per-group case launches the float kernel and is reported, bounded
   and timed as one of its cases; both per-group cases are launched once
   more with ``pipeline="double"`` and must take the same kernel. #9
   also runs at the shortest-M and the widest-N matmul launches of the
   compiled quant_per_group design (A8G_SHAPES, blocks of 16, checked
   against that graph's launches) and at one of its launches in blocks
   of 9 (A8G_TK9); every #9 case prints its plan (``_plan_a8g``),
   launches twice, bit-equal, and is read both ways beside
   ``torch._int_mm``; its sums print with #8's (``a8_sums``), and its
   exact case (integer partial sums below 2^24) must equal the int64
   contraction bit for bit, unsplit and split (``a8g_exact_check``).
   The double-buffered kernels (``pipeline="double"``): #2
   (``conv2d_double``) at every conv case, against ``ref.conv2d``
   (1e-4) and against #1 on the same inputs (DOUBLE_CONV_TOL, 1e-5,
   bit-equality reported), with #1's plan, bound and both-way reading;
   #10 (``qmatmul_a8_double``) at every matmul shape in int8 and packed
   int4 (K = 27 odd at the stem), against ``ref.qmatmul_a8`` (1e-4) and
   #8, its int32 accumulator read through an identity epilogue bit-equal
   to #8's. Each case launches twice (the two results equal bit for
   bit: a missing wait or barrier shows as a difference), and its grid
   sibling's time is printed beside its own, with the same bound and
   yardstick as the sibling's. The W4A8 design's forward is read grid
   and double (``a8_forward``: device and issue ms, and a
   ``torch.profiler`` split with the A8 kernels' share).
3. Seven YOLO paths through the user's entry points, each with the launch
   counters set to 0 just before it and read just after:
   ``main``: yolov8n at 640 → ``core.compile`` → ``serve.Deployment``
   (2 replicas, batch 8) serving 32 requests; ``fusion_off``: the same
   entry points with the fusion passes off (yolov8n at 160,
   ``CompileConfig(passes=())``), where every activation, add, concat
   and split launches on its own (its forward is also read as device
   and host issue ms, ``device_ms``); ``quant_w8a16``: yolov8n at 640 with
   ``CompileConfig(backend="quant")`` serving 32 requests;
   ``quant_w4a8``: the same at ``w_bits=4, a_bits=8``, one batch;
   ``quant_per_group``: yolov8n at 160 at W8A8 recalibrated with
   per-group activation scales, one batch, its forward then read as
   device and host issue ms with a profiler split
   (``per_group_forward``); ``mixed``: yolov8n at 160, the design
   ``CompileConfig(bits="mixed")`` makes, one batch. These three A8
   designs take their activation scales
   (``calibrate_activation_scales(backend="ref")`` on the batch each
   calibrates on: ``compile``'s own for quant_w4a8 and mixed under
   ``plain_compile``, ``plain_scales`` for the per-group recalibration)
   and mixed its wordlength assignment (the search on
   ``QuantBackend(dispatch="ref")``, its float reference and ranges on
   ``"ref"``) from the plain versions only; each prints a sha256 digest
   of its scales (and assignment) on an ``[a8_scales]`` line, and
   ``a8_scale_proof`` builds them again with #1's outputs moved one ulp:
   the digests must not move, while the same designs calibrated through
   the kernels must (the control). ``double``: the
   designs of ``main`` and ``quant_w4a8`` (no recompile), one batch
   each through ``AcceleratorReplica(acc, backend=DoubleBuffered(...))``,
   the executors' own lowering table with the conv and A8 matmul entry
   points called with ``pipeline="double"`` (63 #2 + 3 maxpool + 2 resize; 63 #10 + 3
   maxpool + 2 resize), every conv held against the grid kernel on the
   grid path's input (float within 1e-5, W4A8 within one ulp; the
   bit-equal count printed), the float outputs within MAIN_TOL of the
   plain path, the W4A8 outputs equal to ``quant_w4a8``'s served batch
   (within its A8 bound if a conv was one ulp apart),
   and both designs' forward device time, double and grid. Launch counts are
   checked per forward, and every output against the same graph run
   through the plain versions on the card (``backend="ref"``, or a
   ``QuantBackend(dispatch="ref")`` for the quantized paths) at
   atol = rtol = 1e-3 (63 float32 convs, sums in another order). Where
   the design quantizes activations to 8 bits, a code may round the
   other way where its float input differs in the last bit, and the
   random weights of later layers amplify it; there every conv is held
   against its plain version on the plain path's own input
   (``LayerCompare``, 1e-4) and on the kernel path's own input
   (``reverse_layer_check``: the served kernel path end to end, each
   conv also run plain, the activation codes that round the other way
   counted at each consuming conv's scale, each one apart), and end to
   end, on three input batches, the outputs within 16·2^-8·max|out| of
   the plain path or within A8_SPREAD times the plain path's own spread
   when every conv output moves by one ulp (``a8_path_check``, each
   reading's margin printed: kernel / (A8_SPREAD·spread), max and mean;
   a reading that breaks the rule, here or on path ``tp``, is kept, and
   the script fails after the last phase, before its result lines).
   The LM kernels (``csrc/rmsnorm.cu``, ``attention.cu``,
   ``decode_attention.cu``) are checked the same way at granite-3-8b's
   shapes (prefill rows 2048 × 4096, a decode step's 4 rows, causal
   attention at 2048, a ragged 509, 128 queries after 2048 keys, decode
   of 4 rows over a 4096 cache at lengths 1/700/2048/4096) and at
   gemma2-like ones (D 256, window, softcap); their bound counts only
   the visible (query, key) pairs or the live cache rows; yardsticks
   ``F.rms_norm`` and ``F.scaled_dot_product_attention(enable_gqa=True)``
   with a boolean mask ("n/a" with a softcap, which it lacks; the SDPA
   backend that ran each case is read from its kernel names,
   ``library_backend``). #11 (``attention.cu``, TF32 tensor cores) is
   bound by its route, three TF32 passes (``KERNEL_ROUTES``), the fp32 bound
   printed beside it; each case prints its tile, launches twice,
   bit-equal, and is read both ways with SDPA beside it (``BOTH_WAYS``);
   the sums print on lines of their own (``attn_sums``). #12
   (``decode_attention.cu``, fixed-size shares of the live cache) prints
   its plan (positions a share, shares a row, grid and busy blocks:
   ``dec_plan``), launches twice, bit-equal, and is read both ways with
   SDPA beside it; its sums print on lines of their own (``dec_sums``);
   past the cache with a window (DEC_PAST_S: lengths S - 1 to
   S + 137, window 100) it is held to the reference's rule, the window
   from len - window, exactly 0 where nothing is visible
   (``dec_window_check``). #6 is read both ways too. #7 gains a case at
   granite's decode shape (4, 4096, 12800).
4. Timing: a short serving window (a smoke reading, not a benchmark),
   the executor forward, and the spans of one replica step run alone
   (assemble, issue, wait, copy-out on the host clock; the forward's and
   the weight dequantization's device time with the host's issue hidden
   behind a spin on the stream), for the float and the W8A16 path; for
   the latter also the im2col of its 3×3 convs and the on-the-fly W8
   quantization an unannotated conv pays on the quant backend; the float
   forward at 640 and fusion_off's at 160 by device time, each split by
   ``torch.profiler`` into conv kernels, ``torch.cat`` and the rest
   (``float_forward``).
   ``load``: the open-loop harness (``repro_torch.loadgen``) with the
   counters set to 0 just before it and read just after: the JAX
   package's published model-clock sweep (yolov3-tiny at 64, batch 4, 2
   replicas, an SLO of 6 modeled rounds, levels 0.5-2.0, 48 rounds;
   ``model_clock_load``) on the card, every served output finite, its
   rows equal to the same sweep on the CPU (run after the counters are
   read) and its knee to LOAD_KNEE_RPS; then main's design at 640
   (``wall_load``): the card's fleet round measured (``fleet_round_ms``)
   and used as the harness's step_ms, and Poisson arrivals at 0.5, 1.0
   and 2.0 x the capacity that gives, on the wall clock, the first level
   read twice; each level prints offered load, goodput, on-time
   fraction, admitted/rejected/expired/failed, p50/p99, the worst submit
   lag, utilization, the round and the capacity, and the ledger is
   asserted. Its launches must be conv2d, maxpool2d and resize only.
5. ``lm``: granite-3-8b at full width and depth (40 layers, d 4096,
   vocab 49155; float32 weights from ``lm.init_params`` with a seeded
   generator on the card, ~30 GiB) served by ``serve.engine.Engine``
   (``LmReplica`` + ``ContinuousBatch``, 4 slots, a 4096-position cache):
   8 prompts of 128–2048 tokens from seed 0, 32 greedy tokens each, the
   launch counters set to 0 just before and read just after (per
   prefill 81 rmsnorm + 40 mha, per decode step 81 rmsnorm + 40
   decode_attention, nothing else). The served logits are held to the
   plain path on the card by teacher forcing (the served tokens replayed
   through ``lm.prefill``/``lm.decode_step`` with
   ``ops.set_default_backend("ref")``): every step within LM_TOL, and
   every served token equal to the plain argmax where the plain top-2
   margin exceeds twice that step's difference. Prefill ms by prompt
   length, tokens/s, and the device and issue ms of a prefill and of a
   decode step.
6. ``ssm`` and ``hybrid``: mamba2-130m (24 layers, d 768, 24 SSD heads
   of 64, N 128) and zamba2-1.2b (38 Mamba-2 layers, d 2048, 64 SSD
   heads of 64, N 64, and one shared transformer block of 32/32 heads
   of 64 applied every 6 layers) at full width and depth, served and
   checked as ``lm`` (teacher forcing within SSM_TOL), with 8 prompts of
   the lengths SSM_PROMPTS (each at most the chunk of 256 or a multiple
   of it, as the JAX package's chunked scan asserts). Launches per
   prefill: mamba2 49 rmsnorm + 24 ssd_scan, zamba2 91 rmsnorm + 7 mha +
   38 ssd_scan; per decode step mamba2 49 rmsnorm, zamba2 91 rmsnorm + 7
   decode_attention (the one-token recurrence is plain tensor code, as
   in the JAX package). The SSD kernel (``csrc/ssd_scan.cu``, the
   chunk-parallel SSD on the TF32 tensor cores: two or three passes a
   call, counted as one launch) is held against ``ref.ssd_chunked`` in
   phase 2 at mamba2's and zamba2's prefill at 2048, a batch of 4 at a
   ragged 509, with an initial state, and at two groups (SSD_CASES; no
   PyTorch call computes an SSD scan, so its library time is "n/a");
   each case prints its plan (chunk, heads a block), launches twice,
   bit-equal, is read both ways (``BOTH_WAYS``) and is bound by the
   function's own need (three TF32 products for each FLOP of the
   chunked algorithm at its least-work chunk; x, dt, A, B, C, h0, y and
   the final state once: ``ssd_least_work``), the fp32 least-work bound
   and the route's chunk-state bytes (``ssd_state_bytes``) printed
   beside it; the sums print on a line of their own (``ssd_sums``).
   The attention kernels are also held at zamba2's head width 64
   (MHA_CASES, DEC_CASES).
6b. The moe, vlm and encdec families and the int8 KV cache, each path
   with the counters set to 0 just before it, its launches asserted
   per prefill and step (``lm_launches``: qk-norm adds 2 rmsnorm a
   layer; encdec adds ``ln_x``, the encoder and a cross-attention mha
   per prefill, a second decode_attention a step; kv8's step attends
   through tensor code, no decode_attention), its weights freed after
   it and its peak memory printed. ``kv8``: granite-3-8b with
   ``kv_bits=8`` on the ``lm`` path's weights, served by Engine
   (FAMILY_REQ prompts in LM_PROMPT, FAMILY_NEW tokens each), held to
   the plain ``kv_bits=8`` replay: prefill logits within LM_TOL, the
   clear-margin token rule, each decode step's mean relative logit
   difference below KV8_MEAN_REL (the JAX package's bound), the served
   and replayed caches' differing codes counted. ``moe``:
   qwen3-moe-30b-a3b at full width, MOE_LAYERS of 48, served likewise;
   every routing recorded through ``moe.route`` (``Routes``) and the
   plain replay forced onto the served experts (its own gates at them),
   its logits within LM_TOL, every decision where its own top-k
   differs a near tie (margin below ROUTE_TIE); dropped_frac per
   prefill. ``vlm``: llava-next-34b at full width, VLM_LAYERS of 60, at
   the model level (the reference's LmReplica passes only tokens):
   VLM_ROWS rows of its 2880 seeded patch embeddings and a
   VLM_PROMPT-token prompt, FAMILY_NEW greedy steps. ``encdec``:
   seamless-m4t-medium whole at the model level, ENCDEC_ROWS rows of
   ENCDEC_SRC frames and ENCDEC_PROMPT tokens. Both held at LM_TOL by
   teacher forcing. Phase 2 holds #11 and #12 at these paths' head
   ratios and cross-attention shapes (MHA_FAMILY_CASES,
   DEC_FAMILY_CASES; their sums print apart, ``family_sums``). The
   grouped expert contractions' (``moe.experts``) and the int8 decode
   attention's (``flash.decode_grouped_q8``) device time in a step is
   read under ``torch.profiler`` (``profile_call`` labels).
6c. ``train`` (``run_train``): gradient steps through the forward kernels
   under autograd (``kernels/autograd.py``: #6, #11, #13 launched
   forward, the plain version recomputed for backward). granite-3-8b
   at full width, TRAIN_LAYERS of 40, TRAIN_ROWS x TRAIN_SEQ tokens in
   TRAIN_MB microbatches, adamw, remat "full": step 0 through the
   kernels and all plain (``train_route_check``: launches asserted,
   2 (4L+1) rmsnorm and 2 (2L) mha; the loss and each gradient leaf
   within TRAIN_TOL), one forward + backward per remat mode (peak,
   losses equal), TRAIN_STEPS adamw steps (ms, tokens/s, peak), one
   step under ``torch.profiler`` split by part (``train_split``), one
   int8_adamw step (state bytes a parameter); mamba2-130m whole at
   TRAIN_SSM (#13 under autograd, the same check, a profiled step);
   ``examples/train_lm.py``'s granite-100m through ``train.loop.train``
   (SMALL_STEPS steps, the example's loss drop, a restart from the
   step-SMALL_CKPT checkpoint within RESTART_TOL).
6d. Several positions in one process, over ``cuda_devices()`` (one card:
   every position names cuda:0). ``tp`` (``run_tp``, after ``double``):
   main's design served by TP_REPLICAS tensor-parallel replicas of
   TP_WIDTH positions, N_REQ requests (each conv once a position on its
   filter slice, then an all-gather; launches from the graph), within
   MAIN_TOL of the plain executor and TP_TOL of the one-device forward,
   one forward's all-gather bytes (``roofline.trace``) equal to the
   graph's, its device and issue ms beside main's, a serving window's
   frames/s. ``pipeline`` (``run_pipeline``, after ``train``):
   granite-3-8b at full width, PIPE_LAYERS layers in PIPE_STAGES stages,
   PIPE_MICRO microbatches of 1 x PIPE_SEQ embeddings through
   ``core.pipeline.pipeline_infer``, within PIPE_TOL of the sequential
   loop, 2 #6 and 1 #11 a layer a microbatch, the permute and
   all-reduce bytes, ms a call, ``pipeline_latency_model`` of the
   measured stage, and yolov8n's 4-stage ``partition_stages`` with
   ``stage_latency`` (a model). Then ``[roofline]``
   (``roofline_shares``): the analytic and model FLOPs of granite's
   prefill at 2048, its train step and the pipelined call, as shares of
   the fp32 peak. ``sharded`` (``run_sharded``, after ``pipeline``): the
   LM steps over a (data, model) mesh (``dist/spmd.py`` through
   ``launch.steps``): granite-3-8b at full width, TRAIN_LAYERS layers,
   on SHARD_MESH (data 2, model 4) — one adamw train step (TRAIN_ROWS x
   TRAIN_SEQ, TRAIN_MB microbatches, remat full), one prefill of
   SHARD_PREFILL x TRAIN_SEQ, SHARD_DECODE decode steps — and one
   mamba2-130m adamw step of TRAIN_SSM on SHARD_SSM_MESH (#13 a
   position); each held to the unsharded step and to the same sharded
   call on the plain versions on the same inputs (SHARD_TOL), its
   #6/#11/#12/#13 launches and its labelled transfers
   (kind, count, bytes; ``roofline.trace``) equal to the counts derived
   from the plan (``sharded_launches``, ``sharded_transfers``), with
   each step's ms beside the unsharded step's, the peak memory and the
   step's share of the fp32 peak (``analysis.peak_share``).
7. A JSON line listing all 13 kernels (``launches`` is the count on
   the path that runs it: ``main`` for conv, maxpool and resize,
   ``fusion_off`` for pointwise, ``quant_w8a16`` for qmatmul,
   ``quant_w4a8`` for qmatmul_a8, ``quant_per_group`` for the grouped
   kernel, ``double`` for conv2d_double and qmatmul_a8_double, ``lm``
   for rmsnorm, mha and decode_attention, ``ssm`` for ssd_scan;
   ``launches_by_path`` has every path; #11's and #12's sums include
   their LM-family cases), then the result line.

``--only pool`` runs only phase 1, #3's cases (``pool_sums``), the NaN
probe (reported, not enforced, so that it reads an earlier checkout too),
each case under its planned tile or grid and its neighbours
(``pool_sweep``) and one yolov3-tiny float forward at 416, batch 8:
device time, back to back, and a ``torch.profiler`` split, maxpool
kernel time and launches, conv, the rest (``v3t_forward``), and prints
no result line; like the other ``--only`` readings it can be copied
into a checkout of an earlier commit to read that commit on the same
card.
``--only stream`` runs only phase 1, #4 and #5's cases and fusion_off's
forward reading, and prints no result line: copied into a checkout of an
earlier commit and run there, it reads that commit's #4 and #5 on the
same card (before/after within one call). ``--only a8`` does the same
for #8, #9 and #10's cases, #9's exact case, the W4A8 forward
(``a8_forward``) and the per-group forward (``per_group_forward``), ``--only
conv`` for #1 and #2's cases, the float forwards (``float_forward``),
the forwards with #1's split of K·K·C capped by each rule of
CONV_SPLIT_RULES (``conv_split_rules``), one split conv's host issue
by parts (``conv_issue_split``) and how far #1 would move
quant_per_group's calibrated activation scales from the plain path's
(``calib_drift``: the kernel route, which the design no longer takes);
``--only a8check`` for paths quant_w4a8, quant_per_group and mixed (the
scale digests, the reverse layer check, the margins), the digest proof
(``a8_scale_proof``) and ``calib_drift``;
``--only attn`` for #11's cases with SDPA's (``attn_sums``) and a
``torch.profiler`` split of one granite-3-8b prefill at 2048, full width
and depth: mha kernel time and launches, GEMM, the rest
(``attn_prefill_split``); ``--only ssd`` for #13's cases (``ssd_sums``)
and mamba2-130m prefills at SSD_PREFILLS' lengths and zamba2-1.2b's at
2048, full width and depth: wall and host issue per prefill over
PREFILL_CALLS calls, and a ``torch.profiler`` split, ssd_scan kernel
time and launches (its passes counted apart), GEMM, the rest
(``ssd_prefill_split``); ``--only dec`` for #12's cases with SDPA's and
#6's (``dec_sums``), #12 at half and twice its planned share length
(``dec_share_sweep``), and one granite-3-8b and one zamba2-1.2b decode
step, full width and depth, 4 rows at lengths 128/700/2048/4000 of a
4096 cache: host issue, time to a synchronise, and a ``torch.profiler``
split, decode_attention kernel time and launches, GEMM, the rest
(``dec_step_split``); ``--only load`` for the wall-clock load of
yolov8n at 640, float and W8A16 (``wall_load``: DEFAULT_LEVELS with
Poisson arrivals, the four arrival shapes at 1.0x, replica 0 crashing
at step 16 at 0.9x, and the sweep and the crash again with arrivals in
groups of 8), with each design's launches; ``--only decwin`` for
``dec_window_check`` alone (reported, not enforced, so that it reads an
earlier checkout's #12 too); ``--only moe`` for path ``moe`` and
llama4-maverick-400b-a17b at full width, one group of its grouped
layout (a dense and an MoE layer with all 128 experts: 69.1 GiB of
float32 weights), at the model level: one row of LLAMA4_PROMPT tokens
and FAMILY_NEW greedy steps, checked as ``moe``, its peak memory
printed (kept out of the full run, which must not fail on memory);
``--only train`` for path ``train`` alone; ``--only tp``, ``--only
pipeline`` and ``--only sharded`` for those paths alone (``pipeline``
with its roofline share).

Needs one CUDA card; exits non-zero without one, and in a directory that
does not hold the repository's ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import functools
import hashlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
IMG, BATCH, N_REQ = 640, 8, 32
MAIN_TOL = 1e-3
# Random weights are the He-scaled init times this gain: at the plain
# scale the activations decay to ~1e-10 by the detect heads (no BN, W8
# storage), which would make a 1e-3 output comparison vacuous; at 1.75
# the heads stay at 0.1–1.
WEIGHT_GAIN = 1.75
KERNEL_TOL = {"conv2d": 1e-4, "conv2d_double": 1e-4, "pointwise": 1e-4,
              "maxpool2d": 0.0, "resize_nearest": 0.0,   # 0: bit-equal
              "qmatmul": 1e-4, "qmatmul_a8": 1e-4,
              "qmatmul_a8_double": 1e-4, "qmatmul_a8_grouped": 1e-4,
              # the JAX package's kernel tests' own tolerances
              "rmsnorm": 1e-5, "mha": 2e-5, "decode_attention": 2e-5,
              "ssd_scan": 1e-3}
# The double-buffered conv (#2) against the grid conv (#1) on the same
# input: the JAX package's test_double_buffered_conv_matches_grid.
DOUBLE_CONV_TOL = 1e-5
# 16·2^-8 of the output range: the JAX package's _quant_atol at 8 bits
A8_TOL = 16 * 2.0 ** -8
# Every bound is ``repro_torch.roofline.analysis``'s on its H100 entry
# (``bound``): a kernel's by its route's math and passes
# (``KERNEL_ROUTES``: #1, #2, #11 and #13 three TF32 products, #7 two,
# four with int16 codes, #8-#10 int8), the fp32 one printed beside the
# tensor-core routes'.
# Paths whose design quantizes activations to 8 bits are also read end
# to end on three input batches (the first is the one served) and may
# land up to this many times the plain path's own one-ulp spread from
# the plain path (max and mean |difference|; ``a8_path_check``). The rule
# assumes a plain path within an ulp or so of each conv's exact value:
# its scales come from the plain versions, and the plain matmul with
# per-K scales (``ref.qmatmul_a8``, what #9 is held against) rounds its
# sums once, from float64. Its readings on the H100 are in PERF.md.
A8_SPREAD = 2.0
# Kernels whose cases also launch twice (bit-equal) and are read both
# ways, device time and host issue per call, over this many calls (#3
# too, its short cases near the launch floor; #1 and #2
# through ``conv_cases``' own flag, as #7-#10 through ``qmm_cases``';
# #6's, #11's, #12's and #13's cases, SDPA beside #11's and #12's, through
# ``check_cases``).
BOTH_WAYS = ("pointwise", "resize_nearest", "maxpool2d", "rmsnorm", "mha",
             "decode_attention", "ssd_scan")
BOTH_WAYS_CALLS = 50
# FLOPs per element of each activation (for the pointwise bound).
ACT_FLOPS = {"identity": 0, "none": 0, "relu": 1, "leaky_relu": 2,
             "hardswish": 5, "silu": 5, "gelu": 10}
SOURCES = {
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:132"),
    "conv2d_double": ("src/repro_torch/csrc/conv2d.cu",
                      "src/repro/kernels/conv2d.py:91"),
    "maxpool2d": ("src/repro_torch/csrc/maxpool.cu",
                  "src/repro/kernels/maxpool.py:39"),
    "resize_nearest": ("src/repro_torch/csrc/resize.cu",
                       "src/repro/kernels/resize.py:29"),
    "pointwise": ("src/repro_torch/csrc/pointwise.cu",
                  "src/repro/kernels/pointwise.py:26"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:100"),
    "qmatmul_a8": ("src/repro_torch/csrc/qmatmul.cu",
                   "src/repro/kernels/qmatmul.py:333"),
    "qmatmul_a8_double": ("src/repro_torch/csrc/qmatmul.cu",
                          "src/repro/kernels/qmatmul.py:252"),
    "qmatmul_a8_grouped": ("src/repro_torch/csrc/qmatmul.cu",
                           "src/repro/kernels/qmatmul.py:206"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/pointwise.py:52"),
    "mha": ("src/repro_torch/csrc/attention.cu",
            "src/repro/kernels/attention.py:85"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:70"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:64"),
}
# The path whose launch count a kernel reports in the kernels line.
KERNEL_PATH = {"conv2d": "main", "maxpool2d": "main",
               "resize_nearest": "main", "pointwise": "fusion_off",
               "qmatmul": "quant_w8a16", "qmatmul_a8": "quant_w4a8",
               "qmatmul_a8_grouped": "quant_per_group", "rmsnorm": "lm",
               "mha": "lm", "decode_attention": "lm", "ssd_scan": "ssm",
               "conv2d_double": "double", "qmatmul_a8_double": "double"}
# The LM paths (LM_PATHS below) at full width and depth, float32, served
# by Engine (LmReplica + ContinuousBatch) with these slots and cache.
LM_BATCH, LM_CACHE = 4, 4096
LM_REQ, LM_NEW, LM_PROMPT = 8, 32, (128, 2048)
# Served logits against the plain path replaying the served tokens
# (teacher forcing), max |difference| over every step of every request:
# 9.12e-6 measured on the H100 (PERF.md, PR 13: the kernels' last-bit
# differences and a 4-row against a 1-row matmul, through 40 layers).
LM_TOL = 1e-4
# The ssm and hybrid paths: mamba2-130m and zamba2-1.2b at full width and
# depth, served like lm; prompt lengths at most the chunk (256) or a
# multiple of it, as the JAX package's chunked scan asserts; served
# logits within SSM_TOL of the plain path (the SSD kernel's own
# tolerance, the JAX package's SSD kernel test's).
SSM_PROMPTS = (64, 160, 256, 512, 768, 1024, 1536, 2048)
SSM_TOL = 1e-3
# path: (arch, prompt lengths, or None for LM_REQ lengths uniform in
# LM_PROMPT, tolerance of the teacher-forced check)
LM_PATHS = {"lm": ("granite-3-8b", None, LM_TOL),
            "ssm": ("mamba2-130m", SSM_PROMPTS, SSM_TOL),
            "hybrid": ("zamba2-1.2b", SSM_PROMPTS, SSM_TOL)}
# The moe, vlm and encdec families and the int8 KV cache (paths moe, kv8,
# vlm, encdec; llama4-maverick under --only moe): FAMILY_REQ requests
# (prompts uniform in LM_PROMPT) and FAMILY_NEW greedy tokens each, at
# full width; the layers run of the configs the card cannot hold whole
# in float32, and the rows and lengths of the model-level paths.
FAMILY_REQ, FAMILY_NEW = 4, 16
MOE_LAYERS = 12                  # of qwen3-moe-30b-a3b's 48: 30.2 GiB
VLM_LAYERS = 8                   # of llava-next-34b's 60: 20.0 GiB
VLM_ROWS, VLM_PROMPT = 2, 128    # after its 2880 patch embeddings
ENCDEC_ROWS, ENCDEC_SRC, ENCDEC_PROMPT = 4, 1024, 64
LLAMA4_PROMPT = 2048             # one group (2 of 48 layers): 69.1 GiB
# Path train (``run_train``): (a) granite-3-8b at full width, TRAIN_LAYERS
# of its 40 layers, TRAIN_ROWS rows of TRAIN_SEQ tokens in TRAIN_MB
# microbatches, adamw, remat "full" (1.20 B float32 parameters: 19.2 GB of
# parameters, gradients and two moments at 16 B a parameter); (b)
# mamba2-130m whole, TRAIN_SSM = (rows, tokens), one microbatch; (c)
# examples/train_lm.py's granite-100m through the train loop: SMALL_STEPS
# steps of SMALL_TC, a checkpoint every SMALL_CKPT steps, restarted from
# the first. Step 0 through the kernels against all plain: the loss within
# TRAIN_TOL relative, each gradient leaf's max |difference| within
# TRAIN_TOL x its max |value|; the restart's losses within RESTART_TOL
# relative of the uninterrupted run's.
# Path tp: main's design served by tensor-parallel replicas (TP_WIDTH
# positions a replica, TP_REPLICAS replicas over ``cuda_devices()``, one
# card: every position names cuda:0), held within MAIN_TOL of the plain
# executor and within TP_TOL of the one-device kernel forward.
TP_WIDTH, TP_REPLICAS, TP_TOL = 2, 2, 1e-4
# Path pipeline: granite-3-8b at full width, PIPE_LAYERS of its 40
# layers stacked into PIPE_STAGES stages, PIPE_MICRO microbatches of
# 1 x PIPE_SEQ tokens of embeddings, held to the sequential layer loop.
PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 8, 4, 8, 512
PIPE_TOL = 1e-4
TRAIN_LAYERS = 4
TRAIN_ROWS, TRAIN_SEQ, TRAIN_MB = 4, 2048, 2
TRAIN_STEPS = 4
TRAIN_LR = 3e-4
TRAIN_TOL = 1e-4
TRAIN_SSM = (2, 512)
SMALL_STEPS, SMALL_CKPT = 200, 100
SMALL_TC = dict(batch=8, seq_len=256, microbatches=2, lr=1e-3, warmup=20)
RESTART_TOL = 1e-6
# Path sharded: granite-3-8b at full width (TRAIN_LAYERS of 40 layers) on
# a (data, model) mesh of SHARD_MESH positions over ``cuda_devices()``
# (one card: every position names cuda:0): one adamw train step of
# TRAIN_ROWS x TRAIN_SEQ in TRAIN_MB microbatches (remat full), one
# prefill of SHARD_PREFILL rows x TRAIN_SEQ (cache TRAIN_SEQ +
# SHARD_DECODE), SHARD_DECODE decode steps; mamba2-130m whole, one adamw
# step of TRAIN_SSM on SHARD_SSM_MESH. Each sharded call through the
# kernels is held to the unsharded step and to the same sharded call on
# the plain versions, on the same inputs: logits, caches, loss, grad norm
# and the adamw moments (m and sqrt(v)) within SHARD_TOL of the largest
# |value| (mamba2's moments within SSM_TOL, as its other paths); each
# parameter's update within SHARD_TOL x lr (plus one float32 rounding of
# the parameter) of the one its own gathered moments give (SHARD_ADAMW).
# qwen3-moe-30b-a3b at full width, SHARD_MOE_LAYERS of its 48 layers, on
# SHARD_MESH: the calls of granite's, the routes of each unsharded call
# forced onto the sharded ones.
# zamba2-1.2b at full width, SHARD_HYBRID_LAYERS of its 38 layers (two
# shared-block calls), and seamless-m4t-medium whole (12 + 12 layers) on
# SHARD_MESH: an adamw step of SHARD_SMALL (rows x tokens; seamless over
# as many source frames), a prefill of SHARD_PREFILL rows of as many
# tokens, SHARD_DECODE decode steps. granite-3-8b on (a)'s weights at
# kv_bits=8 (the prefill and decode steps of (a)) and at remat="group"
# (one adafactor step of (a)'s shape on SHARD_MESH, one int8_adamw step
# on SHARD_INT8_MESH, where d_ff's 1,600 columns a position cut its
# groups of 128: 12.5 a shard, so a group's absmax is a maximum over
# positions).
SHARD_MESH, SHARD_SSM_MESH = (2, 4), (2, 2)
SHARD_INT8_MESH = (1, 8)
SHARD_MOE_LAYERS = 2
SHARD_HYBRID_LAYERS = 12
SHARD_SMALL = (2, 512)
SHARD_PREFILL, SHARD_DECODE = 2, 8
SHARD_TOL = 1e-4
SHARD_ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
# kv8's decode steps against the plain kv_bits=8 replay: mean relative
# logit difference below the JAX package's own bound for the int8 cache
# (tests/test_quantized_serving.py:46-48).
KV8_MEAN_REL = 0.05
# A replayed MoE routing whose own top-k differs from the served one
# must be a near tie: a probability margin below this.
ROUTE_TIE = 1e-4
# (M, K, N, act, res) of the quantized matmul cases: matmul launches of
# the quantized yolov8n at 640, batch 8 (stem, a 3x3 with residual at
# 160, the 3x3 head at 80, the 3x3 at 20, the 1x1 class head at 80).
QMM_SHAPES = {
    "stem": (819200, 27, 16, "hardswish", False),
    "3x3_res_160": (204800, 144, 16, "hardswish", True),
    "3x3_head_80": (51200, 576, 64, "hardswish", False),
    "3x3_20": (3200, 2304, 64, "hardswish", False),
    "1x1_cls_80": (51200, 64, 80, "identity", False),
}
# (M, K, N, act, res) of #9's later cases: the shortest-M and the
# widest-N matmul launches of the compiled quant_per_group design
# (yolov8n at 160, W8A8, batch 8; each checked to be a launch of that
# graph and to be its shortest M, its widest N), both in blocks of 16
# features as that path runs them; and a launch of it (the 3x3 at 20)
# in blocks of 9 (``A8G_TK9``).
A8G_SHAPES = {
    "short_M200_K2304_N64": (200, 2304, 64, "hardswish", False),
    "widest_N256_M200_K1152": (200, 1152, 256, "hardswish", False),
}
A8G_TK9 = (3200, 576, 64, "hardswish", False)
# (input H, C, K, F, stride, act, res) of the conv cases: all conv
# launches of yolov8n at 640 after the default passes. The first seven
# are the earlier cases, kept comparable (their sums print apart:
# ``conv_sums``); the last two are short-M launches (M = 3200), where K
# is split.
CONV_CASES = {
    "stem_3x3s2_640": (640, 3, 3, 16, 2, "hardswish", False),
    "3x3s2_160": (160, 32, 3, 64, 2, "hardswish", False),
    "3x3s1_res_160": (160, 16, 3, 16, 1, "hardswish", True),
    "3x3s1_res_80": (80, 32, 3, 32, 1, "hardswish", True),
    "3x3s1_head_80": (80, 64, 3, 64, 1, "hardswish", False),
    "1x1_c2f_80": (80, 192, 1, 64, 1, "hardswish", False),
    "1x1_cls_80": (80, 64, 1, 80, 1, "identity", False),
    "3x3s1_20": (20, 256, 3, 64, 1, "hardswish", False),
    "3x3s2_40_F256": (40, 128, 3, 256, 2, "hardswish", False),
}
CONV_EARLIER = tuple(CONV_CASES)[:7]
# (input H, C, k, stride, act) of #3's earlier cases at batch 8 (the
# kernel table's first rows): yolov8n's SPPF pool at 640, and two 2×2
# pools that are no launch of a served model, kept comparable.
POOL_EARLIER = {"5x5s1_sppf_20": (20, 128, 5, 1, "identity"),
                "2x2s2_leaky_80": (80, 64, 2, 2, "leaky_relu"),
                "2x2s1_leaky_13": (13, 128, 2, 1, "leaky_relu")}
# (input H, W, C, k, stride, act) of the maxpool launches of yolov3-tiny
# at its configured 416 (``yolo.build("yolov3-tiny")`` after the default
# passes; the monotone leaky relu moved onto the pooled value), in launch
# order: the pools that move the most bytes of any served model.
V3T_POOLS = ((416, 416, 16, 2, 2, "leaky_relu"),
             (208, 208, 32, 2, 2, "leaky_relu"),
             (104, 104, 64, 2, 2, "leaky_relu"),
             (52, 52, 128, 2, 2, "leaky_relu"),
             (26, 26, 256, 2, 2, "identity"),
             (13, 13, 512, 2, 1, "leaky_relu"))
# (B, Tq, Tk, Hq, Hkv, D, causal, window, softcap) of the attention
# cases: granite-3-8b's prefill at 2048, a ragged length, a gemma2-like
# local layer (D 256, window 256, softcap 50), and 128 queries at the end
# of 2048 keys (causal offset Tk - Tq).
MHA_CASES = {
    "granite_T2048_causal": (1, 2048, 2048, 32, 8, 128, True, None, None),
    "granite_T509_ragged": (1, 509, 509, 32, 8, 128, True, None, None),
    "gemma2_D256_win256_cap50": (1, 1024, 1024, 8, 4, 256, True, 256, 50.0),
    "granite_Tq128_Tk2048": (1, 128, 2048, 32, 8, 128, True, None, None),
    "zamba2_T2048_causal_D64": (1, 2048, 2048, 32, 32, 64, True, None,
                                None),
}
# (B, S, Hq, Hkv, D, lengths, window, softcap) of the decode cases:
# granite-3-8b's decode batch over a 4096 cache, and a gemma2-like one.
DEC_CASES = {
    "granite_B4_S4096": (4, 4096, 32, 8, 128, (1, 700, 2048, 4096), None,
                         None),
    "gemma2_D256_win512_cap50": (4, 4096, 8, 4, 256, (1, 300, 2048, 4096),
                                 512, 50.0),
    "zamba2_B4_S4096_D64": (4, 4096, 32, 32, 64, (1, 700, 2048, 4096), None,
                            None),
}
# The LM families' attention launches (the moe, vlm and encdec paths),
# apart from MHA_CASES and DEC_CASES so that their sums stay comparable:
# #11 at qwen3-moe's rep 8 (32/4) and llava-next's rep 7 (56/8), causal,
# and seamless-m4t's cross-attention (64 queries over 1024 encoder rows)
# and encoder, non-causal at D 64; #12 at rep 8, llama4-maverick's rep 5
# (40/8), and seamless-m4t's cross-attention step, len = S = 1024.
MHA_FAMILY_CASES = {
    "qwen3_rep8_T2048_causal": (1, 2048, 2048, 32, 4, 128, True, None,
                                None),
    "llava_rep7_T3008_causal": (1, 3008, 3008, 56, 8, 128, True, None,
                                None),
    "seamless_cross_Tq64_Tk1024_D64": (4, 64, 1024, 16, 16, 64, False, None,
                                       None),
    "seamless_encoder_T1024_D64": (4, 1024, 1024, 16, 16, 64, False, None,
                                   None),
}
DEC_FAMILY_CASES = {
    "qwen3_rep8_B4_S4096": (4, 4096, 32, 4, 128, (1, 700, 2048, 4096),
                            None, None),
    "llama4_rep5_B4_S4096": (4, 4096, 40, 8, 128, (1, 700, 2048, 4096),
                             None, None),
    "seamless_cross_B4_len_S1024_D64": (4, 1024, 16, 16, 64, (1024,) * 4,
                                        None, None),
}
# #12 where a cache length passes S with a window (B, S, Hq, Hkv, D,
# window, seed; the card test's shape): the window starts at len - window,
# as the Pallas kernel's does, and a row with nothing visible gives 0
# (``dec_window_check``).
DEC_PAST_S = (8, 700, 8, 2, 128, 100, 11)
# (Bt, T, H, P, G, N, initial state) of the SSD cases: mamba2-130m's and
# zamba2-1.2b's prefill at 2048, a batch of 4 at a ragged 509, a state
# handed over (h0) at mamba2's width, and mamba2's widths over two groups
# of 12 heads (head h reading group h // 12).
SSD_CASES = {
    "mamba2_T2048": (1, 2048, 24, 64, 1, 128, False),
    "zamba2_T2048": (1, 2048, 64, 64, 1, 64, False),
    "mamba2_B4_T509_ragged": (4, 509, 24, 64, 1, 128, False),
    "mamba2_B2_T768_h0": (2, 768, 24, 64, 1, 128, True),
    "mamba2_G2_T1024": (1, 1024, 24, 64, 2, 128, False),
}
# The LM prefills read by ``--only ssd`` (``ssd_prefill_split``): each
# arch's prompt lengths (mamba2's up to 1,024 tokens are host-bound), and
# the calls of each read on the host clock.
SSD_PREFILLS = {"mamba2-130m": (512, 1024, 2048), "zamba2-1.2b": (2048,)}
PREFILL_CALLS = 21


# Path load: the port's open-loop harness (``repro_torch.loadgen``).
# (a) The JAX package's published saturation sweep on the model clock
# (benchmarks/load_harness.py): yolov3-tiny at 64, batch 4, 2 replicas,
# an SLO of 6 modeled rounds, seed 0, 48 rounds a level. Its knee is a
# DSE figure (the report's batched_latency_ms, an FPGA model): the card
# and the CPU must both give LOAD_KNEE_RPS, the JAX package's figure.
LOAD_MODEL = ("yolov3-tiny", 64, 4)             # arch, img, batch
LOAD_MODEL_LEVELS = (0.5, 0.75, 1.0, 1.5, 2.0)
LOAD_MODEL_ROUNDS = 48
LOAD_KNEE_RPS = 5704.059151093396
# (b) Wall-clock sweeps of yolov8n at IMG, batch BATCH, LOAD_REPLICAS
# replicas, Poisson arrivals at multiples of the card's capacity: the
# harness's step_ms is the card's fleet round (the median wall time of
# one round, every replica serving one full batch, after
# LOAD_ROUND_WARM rounds), the SLO LOAD_SLO_ROUNDS of them, LOAD_ROUNDS
# rounds a level. The full run reads LOAD_SHORT_LEVELS (the first one
# twice); ``--only load`` DEFAULT_LEVELS, the arrival shapes at 1.0x and
# replica 0 crashing at step LOAD_KILL_STEP at LOAD_KILL_LEVEL x.
LOAD_REPLICAS, LOAD_SLO_ROUNDS, LOAD_ROUNDS = 2, 6, 32
LOAD_SHORT_LEVELS = (0.5, 1.0, 2.0)
LOAD_ROUND_WARM, LOAD_ROUND_REPS = 3, 9
LOAD_KILL_STEP, LOAD_KILL_LEVEL = 16, 0.9
# a wall run keeps every LOAD_SAMPLE-th request to check its outputs
# after the run (keeping all of them would add allocations to the
# timed window: 4.8 MB of outputs a request at 640)
LOAD_SAMPLE = 16


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(torch, fn, budget_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(min(200, max(5, budget_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, reps: int = 3) -> tuple[float, float]:
    """(device ms, host issue ms) of one call of ``fn``, median of
    ``reps``. A spin queued first keeps the card busy while the host
    issues ``fn``, so the events around it time the device work alone;
    the spin is long enough when the issue is shorter than it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, host = [], []
    fn()
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(500_000_000)          # ~0.25 s at 1.98 GHz
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return sorted(dev)[reps // 2], sorted(host)[reps // 2]


def per_call_ms(torch, fn, n: int = 20) -> tuple[float, float]:
    """(device ms, host issue ms) per call of ``fn`` over ``n`` calls
    queued behind ``device_ms``'s spin: unlike ``cuda_ms``, a call whose
    host issue outlasts its kernels is timed by its kernels, and the
    issue is read on its own."""
    dev, host = device_ms(torch, lambda: [fn() for _ in range(n)])
    return dev / n, host / n


def library_backend(torch, fn) -> dict:
    """Which backend a library call ran, read from the kernel names of one
    call under ``torch.profiler``: SDPA's memory-efficient (CUTLASS
    ``fmha_cutlassF``), flash or cuDNN kernel, else its math path (the
    matmuls and softmax of the plain formula); with the name of the
    longest kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ks[e.name] = ks.get(e.name, 0.0) + e.time_range.elapsed_us()
    names = " ".join(ks).lower()
    backend = ("efficient" if "fmha_cutlass" in names or "efficient" in names
               else "flash" if "flash" in names
               else "cudnn" if "cudnn" in names else "math")
    top = max(ks, key=ks.get) if ks else None
    return {"backend": backend, "kernel": top[:80] if top else None,
            "kernels": len(ks)}


def attn_plan(mod, dev, D: int, B: int, Tq: int, Tk: int,
              Hq: int) -> dict | None:
    """#11's tile and split of the kv sweep at a case's shape on ``dev``'s
    card (``attention._plan``), or None in a checkout from before that
    planner (an ``--only`` run there)."""
    fn = getattr(mod, "_plan", None)
    if fn is None:
        return None
    bq, bk, stages, splits = fn(D, B, Tq, Tk, Hq, mod.sm_count(dev))
    return {"BQ": bq, "BK": bk, "stages": stages, "splits": splits}


def dec_plan(mod, dev, S: int, window, D: int, rep: int, bh: int,
             lens) -> dict | None:
    """#12's positions a share and shares a row (``decode_attention.
    _plan``) at a case's shape on ``dev``'s card, with the busy blocks
    its lengths give, or None in a checkout from before that planner (an
    ``--only`` run there)."""
    fn = getattr(mod, "_plan", None)
    if fn is None:
        return None
    L, shares = fn(S, window or 0, D, rep, bh, mod.sm_count(dev))
    groups = -(-rep // mod.head_block(rep))
    busy = sum(-(-n // L) for n in live_positions(S, lens, window))
    return {"L": L, "shares": shares, "grid": bh * groups * shares,
            "busy": bh // len(lens) * groups * busy}


def pool_plan(mod, dev, N: int, H: int, W: int, C: int, k: int,
              s: int) -> dict | None:
    """#3's plan (``maxpool._plan``: route, float4 or float, tile, grid)
    at a case's shape on ``dev``'s card, for 16-byte aligned operands (a
    fresh allocation's), or None in a checkout from before that planner
    (an ``--only`` run there)."""
    fn = getattr(mod, "_plan", None)
    if fn is None:
        return None
    p = fn(N, H, W, C, k, s, 0, 0, mod.sm_count(dev))
    return {"route": ("overlap", "disjoint")[p.route], "vec": p.vec,
            "tile": [p.th, p.tw, p.cs], "grid": [p.gx, p.gy, p.gz]}


def bound(flops: float, nbytes: float, route: str | None = None
          ) -> tuple[float, float]:
    """(ms bound by operations, ms bound by bytes) of ``flops`` and
    ``nbytes`` on the H100, from ``repro_torch.roofline.analysis``: by
    ``route``'s math and passes (a key of its ``KERNEL_ROUTES``), or at
    the fp32 peak."""
    from repro_torch.roofline import analysis
    r = analysis.kernel_bound(route, flops, nbytes) if route \
        else analysis.kernel_roofline(flops, nbytes)
    return r["t_compute_s"] * 1e3, r["t_memory_s"] * 1e3


def conv_launch_shapes(codegen, graph) -> set:
    """(output H, C, K, F, stride, act, res) of every conv launch."""
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((n.geom("H"), n.geom("C"), n.geom("K"), n.geom("F"),
                     n.geom("stride"), n.attrs.get("act", "identity"),
                     bool(n.attrs.get("fuse_add"))))
    return out


def resize_launch_shapes(codegen, graph) -> set:
    """(input H, W, C, scale) of every resize launch."""
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "resize":
            s = n.geom("scale")
            out.add((n.geom("H") // s, n.geom("W") // s, n.geom("C"), s))
    return out


def act_launch_shapes(codegen, graph) -> set:
    """(activation, H, W, C) of every activation launch."""
    return {(n.op, n.geom("H"), n.geom("W"), n.geom("C"))
            for n in map(graph.nodes.get, codegen.launch_nodes(graph))
            if n.op in ACT_FLOPS}


def pool_launch_shapes(codegen, graph) -> list:
    """(input H, W, C, k, stride, act) of every maxpool launch, in launch
    order."""
    out = []
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "maxpool":
            H, W, C = graph.streams[n.inputs[0]].shape
            out.append((H, W, C, n.geom("K"), n.geom("stride"),
                        n.attrs.get("act", "identity")))
    return out


def matmul_launch_shapes(codegen, graph) -> set:
    """(M, K, N, act, res) of every quantized matmul launch at BATCH."""
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((BATCH * n.geom("H") * n.geom("W"),
                     n.geom("K") ** 2 * n.geom("C"), n.geom("F"),
                     n.attrs.get("act", "identity"),
                     bool(n.attrs.get("fuse_add"))))
    return out


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version, at yolov8n@640 shapes
# --------------------------------------------------------------------------

def kernel_cases(torch, F, K, dev, v3t_pools: list):
    """(kernel, case, kernel_fn, plain_fn, library_fn, flops, bytes,
    plan): #3's cases (#1's and #2's are ``conv_cases``'), POOL_EARLIER's
    and V3T_POOLS', each of the latter checked against ``v3t_pools``, the
    maxpool launches of the compiled yolov3-tiny graph."""
    if sorted(v3t_pools) != sorted(V3T_POOLS):
        raise AssertionError(f"yolov3-tiny's maxpool launches {v3t_pools} "
                             f"are not V3T_POOLS")
    gen = torch.Generator(device=dev).manual_seed(0)
    nb = 4   # bytes per float32
    shapes = [(name, H, H, C, k, s, act)
              for name, (H, C, k, s, act) in POOL_EARLIER.items()]
    shapes += [(f"v3t_{H}x{W}x{C}_{k}x{k}s{s}", H, W, C, k, s, act)
               for H, W, C, k, s, act in V3T_POOLS]
    cases = []
    for name, H, W, C, k, s, act in shapes:
        x = torch.randn(BATCH, H, W, C, generator=gen, device=dev)
        Ho, Wo = -(-H // s), -(-W // s)
        xn = x.permute(0, 3, 1, 2)
        cases.append((
            "maxpool2d", name,
            lambda x=x, k=k, s=s, a=act: K.maxpool.maxpool2d(
                x, k=k, stride=s, act=a),
            lambda x=x, k=k, s=s, a=act: K.ref.maxpool2d(
                x, k=k, stride=s, act=a),
            lambda xn=xn, k=k, s=s: F.max_pool2d(xn, k, s, (k - 1) // 2),
            BATCH * Ho * Wo * C * (k * k + ACT_FLOPS[act]),
            nb * (x.numel() + BATCH * Ho * Wo * C),
            pool_plan(K.maxpool, dev, BATCH, H, W, C, k, s)))
    return cases


def stream_cases(torch, F, K, dev, resize_shapes: set, act_shapes: set):
    """#4 and #5, as ``kernel_cases``: main's two resizes at 640 (each
    checked to be a resize launch of that graph); the 7 activations on
    8×80×80×64 (the kernel table's first cases); silu at fusion_off's
    largest and smallest activation launches (yolov8n at 160,
    ``passes=()``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    nb = 4
    cases = []
    for H, C in ((20, 256), (40, 128)):
        if (H, H, C, 2) not in resize_shapes:
            raise AssertionError(f"resize {H}x{H}x{C} is not a resize "
                                 f"launch of the compiled yolov8n")
        xr = torch.randn(BATCH, H, H, C, generator=gen, device=dev)
        xrn = xr.permute(0, 3, 1, 2)
        cases.append((
            "resize_nearest", f"{H}x{H}x{C}_to_{2 * H}",
            lambda xr=xr: K.resize.resize_nearest(xr, scale=2),
            lambda xr=xr: K.ref.resize_nearest(xr, scale=2),
            lambda xrn=xrn: F.interpolate(xrn, scale_factor=2,
                                          mode="nearest"),
            0, nb * xr.numel() * 5))
    library = {"hardswish": F.hardswish, "relu": F.relu, "silu": F.silu,
               "leaky_relu": lambda t: F.leaky_relu(t, 0.1),
               "gelu": lambda t: F.gelu(t, approximate="tanh"),
               "identity": torch.clone, "none": torch.clone}
    xp = torch.randn(BATCH, 80, 80, 64, generator=gen, device=dev) * 3.0
    acts = [(a, a, xp) for a in sorted(ACT_FLOPS)]
    for H, C in ((80, 16), (5, 64)):
        if ("silu", H, H, C) not in act_shapes:
            raise AssertionError(f"silu {H}x{H}x{C} is not an activation "
                                 f"launch of the fusion_off graph")
        acts.append((f"silu_{BATCH}x{H}x{H}x{C}", "silu", torch.randn(
            BATCH, H, H, C, generator=gen, device=dev) * 3.0))
    for case, act, x in acts:
        cases.append((
            "pointwise", case,
            lambda a=act, x=x: K.pointwise.pointwise(x, a),
            lambda a=act, x=x: K.ref.pointwise(x, a),
            lambda a=act, x=x: library[a](x),
            x.numel() * ACT_FLOPS[act], nb * x.numel() * 2))
    return cases


def qmm_extra(Q, M: int, Kf: int, N: int, kind: int, dev) -> dict:
    """#7's case extras: its plan, printed; the case launches twice,
    bit-equal (split K sums its partials in order, with no atomics), and
    is read both ways."""
    bm, bn, _, splits = Q._plan(M, Kf, N, kind, Q.sm_count(dev))
    return {"again": True, "both_ways": True,
            "plan": {"BM": bm, "BN": bn, "splits": splits}}


def tile_plan(mod, planner: str, dev, *shape):
    """A tensor-core kernel's plan (BM, BN, splits) at ``shape`` on
    ``dev``'s card, from ``mod``'s ``planner`` (#8's and #10's
    ``qmatmul._plan_a8``, #1's and #2's ``conv2d._plan``), or None in a
    checkout from before that planner (an ``--only`` run there)."""
    fn = getattr(mod, planner, None)
    if fn is None:
        return None
    bm, bn, splits = fn(*shape, mod.sm_count(dev))
    return {"BM": bm, "BN": bn, "splits": splits}


def a8g_plan(Q, dev, M: int, Kf: int, N: int, tk: int) -> dict | None:
    """#9's plan (BM, BN, splits, slices a chunk; ``qmatmul._plan_a8g``)
    at a case's shape and block width on ``dev``'s card, or None in a
    checkout from before that planner (an ``--only`` run there)."""
    fn = getattr(Q, "_plan_a8g", None)
    if fn is None:
        return None
    bm, bn, splits, per = fn(M, Kf, N, tk, Q.sm_count(dev))
    return {"BM": bm, "BN": bn, "splits": splits, "per": per, "tk": tk}


def qmm_cases(torch, K, quant, dev, mm_shapes: set, kinds=None,
              g_shapes: set | None = None):
    """The quantized matmul cases: (kernel, case, kernel_fn, plain_fn,
    library_fn or None, ops, bytes, peak, tol, counter that must move,
    counter that must not[, extras]); only the kernels in ``kinds``
    where given. #8 and #10 also run at the widest N among the graph's
    matmul launches (``widest_N...``, packed int4 as on quant_w4a8); #9
    at A8G_SHAPES and A8G_TK9, each checked against ``g_shapes``, the
    matmul launches of the compiled quant_per_group design."""
    gen = torch.Generator(device=dev).manual_seed(1)
    Q, ref = K.qmatmul, K.ref
    cases = []
    for name, (M, Kf, N, act, use_res) in QMM_SHAPES.items():
        if (M, Kf, N, act, use_res) not in mm_shapes:
            raise AssertionError(f"matmul case {name} is not a conv "
                                 f"launch of the compiled yolov8n")
    if g_shapes is not None:
        for name, shape in (*A8G_SHAPES.items(), ("groups_of_9", A8G_TK9)):
            if shape not in g_shapes:
                raise AssertionError(f"#9 case {name} {shape} is not a "
                                     f"matmul launch of quant_per_group")
        short, wide_g = A8G_SHAPES.values()
        if short[0] != min(s[0] for s in g_shapes) or wide_g[2] != max(
                s[2] for s in g_shapes):
            raise AssertionError("A8G_SHAPES are not quant_per_group's "
                                 "shortest M and widest N")
    wide = max(mm_shapes, key=lambda s: (s[2], s[1], s[0]))
    shapes = {**QMM_SHAPES, f"widest_N{wide[2]}": wide}
    rows = {}

    def data(M, Kf, N, use_res):
        key = (M, Kf, N, use_res)
        if key not in rows:
            x = torch.randn(M, Kf, generator=gen, device=dev)
            w = torch.randn(Kf, N, generator=gen, device=dev) * Kf ** -0.5
            b = torch.randn(N, generator=gen, device=dev) * 0.1
            r = torch.randn(M, N, generator=gen, device=dev) \
                if use_res else None
            rows[key] = (x, w, b, r)
        return rows[key]

    def wq(w, bits, pack):
        qt = quant.quantize(w, quant.QuantConfig(
            bits=bits, granularity="per_channel", axis=-1, pack=pack))
        codes = ref.unpack4(qt.q)[:w.shape[0]] if pack else qt.q
        return qt, codes, qt.scale.reshape(1, -1), qt.zero.reshape(1, -1)

    def int_mm(xq, codes):
        """torch._int_mm on the same codes, K zero-padded to a multiple
        of 8 outside the timed call (exact: a zero code adds 0); None
        where its other shape rules refuse the case."""
        M, Kf = xq.shape
        if M <= 16 or codes.shape[1] % 8:
            return None
        pad = (-Kf) % 8
        a = torch.nn.functional.pad(xq, (0, pad)).contiguous()
        c = torch.nn.functional.pad(codes, (0, 0, 0, pad)).contiguous()
        return lambda: torch._int_mm(a, c)

    # #7: float x × int8 / int16 / packed-int4 codes
    for name, bits, pack in (("stem", 4, True), ("3x3_res_160", 8, False),
                             ("3x3_head_80", 8, False),
                             ("3x3_head_80", 16, False),
                             ("3x3_20", 8, False), ("1x1_cls_80", 8, False)):
        M, Kf, N, act, use_res = QMM_SHAPES[name]
        x, w, b, r = data(M, Kf, N, use_res)
        qt, codes, sc, zr = wq(w, bits, pack)
        wd = qt.dequantize().reshape(Kf, N)
        qbytes = qt.q.numel() * qt.q.element_size()
        nbytes = 4 * (M * Kf + M * N * (2 if use_res else 1) + 3 * N) \
            + qbytes
        kind = Q._PACKED if pack else Q._CODE_KIND[qt.q.dtype]
        cases.append((
            "qmatmul", f"{name}_w{bits}",
            lambda x=x, qt=qt, b=b, r=r, a=act, p=pack: Q.qmatmul(
                x, qt.q, qt.scale, qt.zero, b, act=a, res=r, w_packed=p),
            lambda x=x, c=codes, sc=sc, zr=zr, b=b, r=r, a=act:
                ref.qmatmul(x, c, sc, zr, b, act=a, res=r),
            lambda x=x, wd=wd: torch.matmul(x, wd),
            2 * M * Kf * N, nbytes,
            "qmatmul_int16" if bits == 16 else "qmatmul",
            KERNEL_TOL["qmatmul"], Q.qmatmul.launches,
            None, qmm_extra(Q, M, Kf, N, kind, dev)))
    # #8: int8 codes × int8 / packed-int4 codes, int32 accumulator
    for name, bits, pack, acc_only in (
            ("stem", 4, True, False), ("3x3_res_160", 8, False, False),
            ("3x3_head_80", 8, False, False), ("3x3_head_80", 8, False, True),
            ("3x3_20", 8, False, False), ("1x1_cls_80", 8, False, False),
            (f"widest_N{wide[2]}", 4, True, False)):
        M, Kf, N, act, use_res = shapes[name]
        x, w, b, r = data(M, Kf, N, use_res)
        qt, codes, sc, zr = wq(w, bits, pack)
        xs = float(x.abs().max()) / 127
        xq = ref.quantize_activation(x, xs)
        qbytes = qt.q.numel()
        if acc_only:        # y == the int32 accumulator, bit for bit
            one = torch.ones(1, device=dev)
            nil = torch.zeros(1, device=dev)
            kfn = lambda xq=xq, qt=qt: Q.qmatmul_a8(
                xq, qt.q, one, nil, x_scale=1.0)
            pfn = lambda xq=xq, c=codes: ref.qmatmul_a8(
                xq, c, one, nil, 1.0)
            case, tol, act, r, b = f"{name}_acc_int32", 0.0, "identity", \
                None, None
        else:
            kfn = lambda xq=xq, qt=qt, b=b, r=r, a=act, xs=xs, p=pack: \
                Q.qmatmul_a8(xq, qt.q, qt.scale, qt.zero, b, x_scale=xs,
                             act=a, res=r, w_packed=p)
            pfn = lambda xq=xq, c=codes, sc=sc, zr=zr, b=b, r=r, a=act, \
                xs=xs: ref.qmatmul_a8(xq, c, sc, zr, xs, b, act=a, res=r)
            case, tol = f"{name}_w{bits}a8", KERNEL_TOL["qmatmul_a8"]
        cases.append((
            "qmatmul_a8", case, kfn, pfn, int_mm(xq, codes),
            2 * M * Kf * N,
            M * Kf + qbytes + 4 * (M * N * (2 if r is not None else 1)
                                   + 3 * N),
            "qmatmul_a8", tol, Q.qmatmul_a8.launches, None,
            {"again": True, "both_ways": True,
             "plan": tile_plan(Q, "_plan_a8", dev, M, Kf, N)}))
    # #9: per-group activation scales aligned to groups of 16; and runs
    # of 6, which share no K tile >= 8, so that qmatmul_a8 launches #7
    # on xq·s_k (a float32 contraction: counted, bounded and timed as a
    # qmatmul case, its yardstick torch.matmul on xq·s_k). #9's cases
    # print their plan, launch twice (bit-equal) and are read both ways,
    # beside torch._int_mm on the same codes (no scales)
    M, Kf, N, act, _ = QMM_SHAPES["3x3_head_80"]
    x, w, b, _ = data(M, Kf, N, False)
    qt, codes, sc, zr = wq(w, 8, False)
    wd = qt.dequantize().reshape(Kf, N)
    for run, kname, moves, stays in (
            (16, "qmatmul_a8_grouped", Q.qmatmul_a8_grouped.launches,
             Q.qmatmul.launches),
            (6, "qmatmul", Q.qmatmul.launches,
             Q.qmatmul_a8_grouped.launches)):
        amax = x.abs().amax(dim=0).reshape(-1, run).amax(dim=1)
        sv = tuple(float(v) / 127 for v in amax.repeat_interleave(run))
        svt = torch.tensor(sv, device=dev)
        xq = ref.quantize_activation(x, svt)
        xf = xq.to(torch.float32) * svt
        lib = int_mm(xq, codes) if kname == "qmatmul_a8_grouped" \
            else (lambda xf=xf: torch.matmul(xf, wd))
        nbytes = M * Kf + qt.q.numel() + 4 * (M * N + 3 * N + Kf)
        float7 = kname == "qmatmul"
        cases.append((
            kname, f"3x3_head_80_a8_groups_of_{run}",
            lambda xq=xq, sv=sv: Q.qmatmul_a8(
                xq, qt.q, qt.scale, qt.zero, b, x_scale=sv, act=act),
            lambda xq=xq, svt=svt: ref.qmatmul_a8(
                xq, codes, sc, zr, svt, b, act=act),
            lib, 2 * M * Kf * N, nbytes, kname, KERNEL_TOL[kname], moves,
            stays,
            qmm_extra(Q, M, Kf, N, Q._CODE_KIND[qt.q.dtype], dev)
            if float7 else {"again": True, "both_ways": True,
                            "plan": a8g_plan(Q, dev, M, Kf, N, run)}))
        # the per-K scales with pipeline="double" take the same route
        # (never #10), as in the JAX package: launch-checked, not timed
        n10, n_moves = Q.qmatmul_a8.launches_double.value, moves.value
        Q.qmatmul_a8(xq, qt.q, qt.scale, qt.zero, b, x_scale=sv, act=act,
                     pipeline="double")
        if (Q.qmatmul_a8.launches_double.value, moves.value) != (
                n10, n_moves + 1):
            raise AssertionError(f"per-K scales (runs of {run}) with "
                                 f"pipeline='double' did not launch "
                                 f"{kname}")

    def a8_grouped(name, shape, run):
        """#9 at a quant_per_group launch shape, int8 codes, scales in
        runs of ``run`` features; the caller's K tile is K, so that
        ``_group_tile`` aligns blocks of exactly ``run``."""
        M, Kf, N, act, use_res = shape
        x, w, b, r = data(M, Kf, N, use_res)
        qt, codes, sc, zr = wq(w, 8, False)
        amax = x.abs().amax(dim=0).reshape(-1, run).amax(dim=1)
        sv = tuple(float(v) / 127 for v in amax.repeat_interleave(run))
        svt = torch.tensor(sv, device=dev)
        xq = ref.quantize_activation(x, svt)
        tk, _ = Q._group_tile(sv, Kf, Kf, False)
        return (
            "qmatmul_a8_grouped", f"{name}_a8_groups_of_{run}",
            lambda: Q.qmatmul_a8(xq, qt.q, qt.scale, qt.zero, b,
                                 x_scale=sv, act=act, res=r, tk=Kf),
            lambda: ref.qmatmul_a8(xq, codes, sc, zr, svt, b, act=act,
                                   res=r),
            int_mm(xq, codes), 2 * M * Kf * N,
            M * Kf + qt.q.numel() + 4 * (
                M * N * (2 if use_res else 1) + 3 * N + Kf),
            "qmatmul_a8_grouped", KERNEL_TOL["qmatmul_a8_grouped"],
            Q.qmatmul_a8_grouped.launches, Q.qmatmul.launches,
            {"again": True, "both_ways": True,
             "plan": a8g_plan(Q, dev, M, Kf, N, tk)})

    if g_shapes is not None:
        cases += [a8_grouped(name, shape, 16)
                  for name, shape in A8G_SHAPES.items()]
        cases.append(a8_grouped("M{}_K{}_N{}".format(*A8G_TK9[:3]),
                                A8G_TK9, 9))
    # #10: #8's cases with the K sweep double-buffered, int8 and packed
    # int4 at every shape; beside each, #8 on the same inputs (the grid
    # sibling) and the int32 accumulators of both read through an
    # identity epilogue (unit scale, zero 0, no bias, x_scale 1). Built
    # in a function of its own: the lambdas above read qt, b, act, ...
    # of this scope when they run.
    one, nil = torch.ones(1, device=dev), torch.zeros(1, device=dev)

    def a8_double(name, bits, pack):
        M, Kf, N, act, use_res = shapes[name]
        x, w, b, r = data(M, Kf, N, use_res)
        xs = float(x.abs().max()) / 127
        xq = ref.quantize_activation(x, xs)
        qt, codes, sc, zr = wq(w, bits, pack)
        kw = dict(act=act, res=r, w_packed=pack)
        return (
            "qmatmul_a8_double", f"{name}_w{bits}a8",
            lambda: Q.qmatmul_a8(xq, qt.q, qt.scale, qt.zero, b,
                                 x_scale=xs, pipeline="double", **kw),
            lambda: ref.qmatmul_a8(xq, codes, sc, zr, xs, b, act=act,
                                   res=r),
            int_mm(xq, codes), 2 * M * Kf * N,
            M * Kf + qt.q.numel() + 4 * (
                M * N * (2 if use_res else 1) + 3 * N),
            "qmatmul_a8_double", KERNEL_TOL["qmatmul_a8_double"],
            Q.qmatmul_a8.launches_double, Q.qmatmul_a8.launches,
            {"grid": lambda: Q.qmatmul_a8(xq, qt.q, qt.scale, qt.zero, b,
                                          x_scale=xs, **kw),
             "grid_tol": KERNEL_TOL["qmatmul_a8"],
             "acc": tuple(
                 lambda pl=pl: Q.qmatmul_a8(xq, qt.q, one, nil,
                                            x_scale=1.0, w_packed=pack,
                                            pipeline=pl)
                 for pl in ("double", "grid")),
             "both_ways": True, "plan": tile_plan(Q, "_plan_a8", dev, M, Kf, N)})

    cases += [a8_double(name, bits, pack) for name in QMM_SHAPES
              for bits, pack in ((8, False), (4, True))]
    cases.append(a8_double(f"widest_N{wide[2]}", 4, True))
    return [c for c in cases if kinds is None or c[0] in kinds]


def conv_cases(torch, F, K, dev, conv_shapes: set):
    """#1 and #2 at every CONV_CASES shape (each a conv launch of the
    compiled yolov8n at 640), on the same inputs, in ``qmm_cases``' form:
    each against ``ref.conv2d`` (KERNEL_TOL), launched twice bit-equal,
    its plan printed, read both ways (device time and host issue per
    call, the kernel's and cuDNN fp32's, TF32 off), and bound by its
    route, three TF32 passes (``KERNEL_ROUTES``), the fp32
    bound beside it; #2 also against #1 (DOUBLE_CONV_TOL, bit-equality
    reported)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = []
    for name, (H, C, Kk, Fo, s, act, use_res) in CONV_CASES.items():
        Ho = -(-H // s)
        if (Ho, C, Kk, Fo, s, act, use_res) not in conv_shapes:
            raise AssertionError(f"conv case {name} is not a conv launch "
                                 f"of the compiled yolov8n")
        x = rnd(BATCH, H, H, C)
        w = rnd(Kk, Kk, C, Fo, scale=(Kk * Kk * C) ** -0.5)
        b = rnd(Fo, scale=0.1)
        res = rnd(BATCH, Ho, Ho, Fo) if use_res else None
        xn = x.permute(0, 3, 1, 2)              # channels-last NCHW view
        wn = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(stride=s, act=act, res=res)
        flops = 2 * BATCH * Ho * Ho * Kk * Kk * C * Fo
        nbytes = 4 * (x.numel() + w.numel() + b.numel()
                      + BATCH * Ho * Ho * Fo * (2 if use_res else 1))
        grid = functools.partial(K.conv2d.conv2d, x, w, b, **kw)
        plain = functools.partial(K.ref.conv2d, x, w, b, **kw)
        cudnn = functools.partial(F.conv2d, xn, wn, b, stride=s,
                                  padding=Kk // 2)
        common = {"both_ways": True, "fp32_bound_ms": max(bound(flops,
                                                                nbytes)),
                  "plan": tile_plan(K.conv2d, "_plan", dev, BATCH * Ho * Ho,
                                    Kk * Kk * C, Fo)}
        cases.append((
            "conv2d", name, grid, plain, cudnn, flops, nbytes, "conv2d",
            KERNEL_TOL["conv2d"], K.conv2d.launches,
            K.conv2d.launches_double, {**common, "again": True}))
        cases.append((
            "conv2d_double", name, functools.partial(
                K.conv2d.conv2d, x, w, b, pipeline="double", **kw),
            plain, cudnn, flops, nbytes, "conv2d_double",
            KERNEL_TOL["conv2d_double"], K.conv2d.launches_double,
            K.conv2d.launches,
            {**common, "grid": grid, "grid_tol": DOUBLE_CONV_TOL}))
    return cases


def visible_pairs(Tq: int, Tk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible: the work of a kernel
    that skips what is masked (queries are the last Tq positions)."""
    import numpy as np
    qi = np.arange(Tq) + Tk - Tq
    hi = np.minimum(qi + 1, Tk) if causal else np.full(Tq, Tk)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(Tq, int)
    return int(np.maximum(hi - lo, 0).sum())


def live_positions(S: int, lengths, window) -> list:
    """Per row, the cache positions a decode step reads: those below
    min(len, S) and, with a window, from len - window on."""
    out = []
    for n in lengths:
        hi = max(min(n, S), 0)
        out.append(max(hi - (max(n - window, 0) if window else 0), 0))
    return out


def lm_cases(torch, F, K, quant, dev):
    """The LM kernels' cases, in ``qmm_cases``' form: RMSNorm at the
    granite prefill and decode rows and the gemma2 width; attention
    (MHA_CASES) and decode attention (DEC_CASES), whose bound counts only
    the visible (query, key) pairs or the live cache rows; and #7 at the
    granite decode shape (the MLP up projection of a W8 step: M = 4
    rows, K = 4096, N = 12800). Library yardsticks: ``F.rms_norm``,
    ``F.scaled_dot_product_attention`` with ``enable_gqa=True`` and a
    boolean mask (none where a softcap is set: it has no softcap; the
    backend it ran, read by ``library_backend``), ``torch.matmul`` on the
    dequantized weight. #11 is bound by its route, three TF32 products a
    product (``KERNEL_ROUTES``), the fp32 bound printed beside it; its plan is
    printed."""
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = []
    for R, D in ((2048, 4096), (4, 4096), (509, 2304)):
        x, g = rnd(R, D), rnd(D, scale=0.1)
        w1 = 1.0 + g
        cases.append((
            "rmsnorm", f"rows{R}_D{D}",
            lambda x=x, g=g: K.pointwise.rmsnorm(x, g, 1e-6),
            lambda x=x, g=g: K.ref.rmsnorm(x, g, 1e-6),
            lambda x=x, w1=w1, D=D: F.rms_norm(x, (D,), w1, 1e-6),
            5 * R * D, 4 * (2 * R * D + D), "rmsnorm",
            KERNEL_TOL["rmsnorm"], K.pointwise.rmsnorm_launches, None))
    for name, (B, Tq, Tk, Hq, Hkv, D, causal, win, cap) in {
            **MHA_CASES, **MHA_FAMILY_CASES}.items():
        q, k, v = rnd(B, Tq, Hq, D), rnd(B, Tk, Hkv, D), rnd(B, Tk, Hkv, D)
        kw = dict(causal=causal, window=win, softcap=cap)
        qi = torch.arange(Tq, device=dev)[:, None] + Tk - Tq
        ki = torch.arange(Tk, device=dev)[None, :]
        mask = (ki <= qi) if causal else torch.ones_like(ki <= qi)
        if win:
            mask = mask & (ki > qi - win)
        lib = None if cap else (
            lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=True))
        flops = 4 * B * Hq * D * visible_pairs(Tq, Tk, causal, win)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        cases.append((
            "mha", name,
            lambda q=q, k=k, v=v, kw=kw: K.attention.mha(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: K.ref.mha(q, k, v, **kw), lib,
            flops, nbytes, "mha", KERNEL_TOL["mha"],
            K.attention.launches, None,
            {"fp32_bound_ms": max(bound(flops, nbytes)),
             "plan": attn_plan(K.attention, dev, D, B, Tq, Tk, Hq),
             "library_backend": True}))
    for name, (B, S, Hq, Hkv, D, lens, win, cap) in {
            **DEC_CASES, **DEC_FAMILY_CASES}.items():
        q, kc, vc = rnd(B, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(window=win, softcap=cap)
        pos = torch.arange(S, device=dev)[None, :]
        mask = pos < ln[:, None]
        if win:
            mask = mask & (pos >= ln[:, None] - win)
        lib = None if cap else (
            lambda q=q, kc=kc, vc=vc, m=mask[:, None, None, :]:
                F.scaled_dot_product_attention(
                    q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=m, enable_gqa=True))
        live = sum(live_positions(S, lens, win))
        cases.append((
            "decode_attention", name,
            lambda q=q, kc=kc, vc=vc, ln=ln, kw=kw:
                K.decode_attention.decode_attention(q, kc, vc, ln, **kw),
            lambda q=q, kc=kc, vc=vc, ln=ln, kw=kw:
                K.ref.decode_attention(q, kc, vc, ln, **kw), lib,
            4 * Hq * D * live, 4 * (2 * live * Hkv * D + 2 * B * Hq * D + B),
            "decode_attention", KERNEL_TOL["decode_attention"],
            K.decode_attention.launches, None,
            {"plan": dec_plan(K.decode_attention, dev, S, win, D, Hq // Hkv,
                              B * Hkv, lens)}))
    M, Kf, N = 4, 4096, 12800
    x, w = rnd(M, Kf), rnd(Kf, N, scale=Kf ** -0.5)
    qt = quant.quantize(w, quant.QuantConfig(bits=8))   # per tensor, as
    wd = qt.dequantize().reshape(Kf, N)                 # one W8 layer's
    sc, zr = qt.scale.reshape(1, -1), qt.zero.reshape(1, -1)
    nbytes = 4 * (M * Kf + M * N + 2) + Kf * N
    cases.append((
        "qmatmul", "granite_decode_up_4x4096x12800_w8",
        lambda: K.qmatmul.qmatmul(x, qt.q, qt.scale, qt.zero),
        lambda: K.ref.qmatmul(x, qt.q, sc, zr),
        lambda: torch.matmul(x, wd), 2 * M * Kf * N, nbytes, "qmatmul",
        KERNEL_TOL["qmatmul"], K.qmatmul.qmatmul.launches,
        None, qmm_extra(K.qmatmul, M, Kf, N, 0, dev)))
    return cases


def ssd_work(Bt: int, T: int, H: int, P: int, G: int, N: int,
             h0: bool, chunk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the chunked SSD scan at chunk ``chunk``: per
    chunk of c tokens, C·Bᵀ once per group and W·x per head on the causal
    half (c(c+1)/2 pairs), C·S and the state update per head (c·N·P
    each) and the state's decay (N·P per head); x, dt, A, B, C (and h0)
    read once, y and the final state written once."""
    flops = 0
    for t0 in range(0, T, chunk):
        c = min(chunk, T - t0)
        tri = c * (c + 1) // 2
        flops += 2 * Bt * (G * tri * N + H * tri * P + 2 * H * c * N * P) \
            + Bt * H * N * P
    nbytes = 4 * (2 * Bt * T * H * P + Bt * T * H + H + 2 * Bt * T * G * N
                  + Bt * H * N * P * (2 if h0 else 1))
    return flops, nbytes


def ssd_least_work(Bt: int, T: int, H: int, P: int, G: int, N: int,
                   h0: bool) -> tuple[int, int, int]:
    """(chunk, FLOPs, bytes) at the chunk from 1 to T whose work
    (``ssd_work``) is least: the count behind the SSD scan's bound. The
    intra-chunk terms grow with the chunk and the decay shrinks with it,
    so the least lies near sqrt(H·N·P / (G·N + H·P)), about 11 tokens at
    mamba2-130m's widths and 8 at zamba2-1.2b's."""
    best = min(range(1, T + 1),
               key=lambda c: ssd_work(Bt, T, H, P, G, N, h0, c)[0])
    return (best, *ssd_work(Bt, T, H, P, G, N, h0, best))


def ssd_state_bytes(Bt: int, T: int, H: int, N: int, P: int,
                    chunk: int) -> int:
    """Bytes of csrc/ssd_scan.cu's chunk states at ``chunk``: their four
    passes through device memory where there is more than one chunk
    (pass 1 writes nc of them, pass 2 reads nc and writes nc - 1, pass 3
    reads nc - 1). The route moves them; the function does not need
    them, so they are printed beside the bound, not counted in it."""
    nc = -(-T // chunk)
    return 4 * (4 * nc - 2) * Bt * H * N * P if nc > 1 else 0


def ssd_plan(mod, dev, Bt: int, T: int, H: int, P: int, G: int,
             N: int) -> dict | None:
    """#13's chunk (``ssd_scan.SSD_CHUNK``) and heads a block
    (``ssd_scan._plan``) at a case's shape on ``dev``'s card, or None in
    a checkout from before that planner (an ``--only`` run there)."""
    fn = getattr(mod, "_plan", None)
    if fn is None:
        return None
    return {"chunk": mod.SSD_CHUNK,
            "heads": fn(Bt, T, H, P, G, N, mod.sm_count(dev))}


def ssd_inputs(torch, F, dev, Bt, T, H, P, G, N, with_h0, gen):
    """x, B, C unit normals, dt = softplus of one, A = -linspace(1, 16,
    H) (the models' ``-exp(A_log)``), h0 a unit normal or None."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x, dt = rnd(Bt, T, H, P), F.softplus(rnd(Bt, T, H))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    B, C = rnd(Bt, T, G, N), rnd(Bt, T, G, N)
    return x, dt, A, B, C, rnd(Bt, H, N, P) if with_h0 else None


def ssd_cases(torch, F, K, dev):
    """The SSD kernel's cases (SSD_CASES) in ``qmm_cases``' form, against
    ``ref.ssd_chunked`` (inputs from ``ssd_inputs``). The bound is the
    function's own: the chunked algorithm's least work
    (``ssd_least_work``), three TF32 products (``KERNEL_ROUTES``) a FLOP over
    the TF32 peak, and its bytes. The fp32 bound of that work, the
    route's chunk-state bytes at the plan's chunk (``ssd_state_bytes``;
    64, the old kernel's chunk, where the checkout has no planner) and
    the work at the configs' chunk (256) are printed beside it. No
    PyTorch call computes an SSD scan: no library yardstick."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for name, (Bt, T, H, P, G, N, with_h0) in SSD_CASES.items():
        x, dt, A, B, C, h0 = ssd_inputs(torch, F, dev, Bt, T, H, P, G, N,
                                        with_h0, gen)
        plan = ssd_plan(K.ssd_scan, dev, Bt, T, H, P, G, N)
        chunk = plan["chunk"] if plan else 64
        best, flops, nbytes = ssd_least_work(Bt, T, H, P, G, N, with_h0)
        states = ssd_state_bytes(Bt, T, H, N, P, chunk)
        at256 = ssd_work(Bt, T, H, P, G, N, with_h0, 256)[0]
        print(f"ssd_scan {name}: plan {plan}; least work at chunk {best}: "
              f"{flops / 1e9:.4f} GFLOP (3 TF32 products a "
              f"FLOP), {nbytes / 1e6:.3f} MB; the route's chunk states at "
              f"chunk {chunk}: {states / 1e6:.3f} MB more (not in the "
              f"bound); {at256 / 1e9:.4f} GFLOP at the configs' 256",
              flush=True)
        cases.append((
            "ssd_scan", name,
            lambda a=(x, dt, A, B, C), h0=h0: K.ssd_scan.ssd_scan(*a, h0=h0),
            lambda a=(x, dt, A, B, C), h0=h0: K.ref.ssd_chunked(*a, h0=h0),
            None, flops, nbytes, "ssd_scan",
            KERNEL_TOL["ssd_scan"], K.ssd_scan.launches, None,
            {"fp32_bound_ms": max(bound(flops, nbytes)), "plan": plan,
             "state_mb": states / 1e6}))
    return cases


def ssd_sums(per_kernel: dict) -> dict:
    """#13's sums over its cases (SSD_CASES), each key summed, printed on
    a line of its own."""
    keys = ("ms", "device_ms", "issue_ms", "bound_ms", "fp32_bound_ms",
            "plain_ms")
    cases = per_kernel["ssd_scan"]["cases"]
    sums = {k: sum(c[k] for c in cases) for k in keys}
    f = {k: f"{v:.4f}" for k, v in sums.items()}
    print(f"  ssd_scan sum over its {len(cases)} cases: kernel {f['ms']} ms "
          f"back to back, device {f['device_ms']}, issue {f['issue_ms']}; "
          f"plain {f['plain_ms']}; bound {f['bound_ms']} (3xTF32), "
          f"{f['fp32_bound_ms']} (fp32)", flush=True)
    return {"cases": len(cases), **sums}


def ssd_prefill_split(torch, lm, registry, dev, arch: str,
                      lengths: tuple = (2048,)) -> dict:
    """Prefills of ``arch`` at full width and depth (float32 weights from
    a seeded generator on the card), one prompt of each length T in
    ``lengths``: its wall time to a synchronise and its host issue over
    PREFILL_CALLS calls on the host clock (median and least; the queue
    empty at each start), then ``profile_call``'s split of its kernels'
    time (``busy``) into #13 (kernels whose name holds ``ssd``: time,
    launches, and each kernel name's), cuBLAS GEMMs (names holding
    ``gemm``) and the rest. Keyed by T."""
    cfg = registry.get(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    out = {}
    for T in lengths:
        toks = torch.randint(
            0, cfg.vocab, (1, T), device=dev, dtype=torch.int32,
            generator=torch.Generator(device=dev).manual_seed(5))

        def call():
            return lm.prefill(params, cfg, {"tokens": toks}, T + LM_NEW)

        with torch.inference_mode():
            sp = profile_call(torch, call, match="ssd")
            issue, wall = [], []
            for _ in range(PREFILL_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                issue.append((t1 - t0) * 1e3)
                wall.append((time.perf_counter() - t0) * 1e3)
        by = sp.get("by_name", {})
        gemm = sum(v[0] for k, v in by.items() if "gemm" in k.lower())
        passes = {k[:60]: v for k, v in by.items() if "ssd" in k}
        r = {"arch": arch, "T": T, "layers": cfg.n_layers,
             "calls": PREFILL_CALLS,
             "wall_ms": statistics.median(wall), "wall_min_ms": min(wall),
             "issue_ms": statistics.median(issue),
             "issue_min_ms": min(issue), "busy_ms": sp["busy"],
             "ssd_ms": sp.get("match_ms"),
             "ssd_kernels": sp.get("match_kernels"),
             "ssd_by_kernel": passes, "gemm_ms": gemm}
        head = (f"[ssd] {arch} prefill {T} ({cfg.n_layers} layers): "
                f"{r['wall_ms']:.3f} ms to a synchronise (least "
                f"{r['wall_min_ms']:.3f}), host issue {r['issue_ms']:.3f} "
                f"(least {r['issue_min_ms']:.3f}), medians of "
                f"{PREFILL_CALLS}")
        if sp["busy"] is not None:
            r["rest_ms"] = sp["busy"] - r["ssd_ms"] - gemm
            print(f"{head}; kernels {sp['busy']:.1f} ms: ssd_scan "
                  f"{r['ssd_ms']:.2f} in {r['ssd_kernels']} kernel launches "
                  f"({passes}), GEMM {gemm:.1f}, the rest "
                  f"{r['rest_ms']:.2f}", flush=True)
        else:
            print(f"{head}; device not measured (no kernel records)",
                  flush=True)
        out[T] = r
    del params
    torch.cuda.empty_cache()
    return out


def check_kernels(torch, cases: list) -> dict:
    """Phase 2 for the cases of ``kernel_cases`` and ``stream_cases``:
    each agrees with its plain version and is timed back to back; an
    eighth entry, #3's plan, is printed and kept. A case
    of a kernel in BOTH_WAYS also launches twice (the two results equal
    bit for bit) and is read both ways: the kernel's and the library
    call's device time and host issue per call (``per_call_ms``), kept
    in the case beside the back-to-back times."""
    per_kernel: dict = {}
    for kname, case, kfn, pfn, lfn, flops, nbytes, *plan in cases:
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        tol = KERNEL_TOL[kname]
        err = float((got - want).abs().max())
        ok = bool(torch.equal(got, want)) if tol == 0 else bool(
            torch.allclose(got, want, atol=tol, rtol=tol))
        if not ok:
            raise AssertionError(f"{kname}[{case}] disagrees with its "
                                 f"plain version: max_abs_err={err}")
        t_k, t_p, t_l = (cuda_ms(torch, kfn), cuda_ms(torch, pfn),
                         cuda_ms(torch, lfn))
        b_ops, b_bytes = bound(flops, nbytes, kname)
        extra, note = {}, ""
        if plan:        # #3's, None in a checkout without its planner
            extra["plan"] = plan[0]
            note += "; plan " + (" ".join(f"{k}={v}" for k, v in
                                          plan[0].items())
                                 if plan[0] else "n/a")
        if kname in BOTH_WAYS:
            again = kfn()
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                raise AssertionError(f"{kname}[{case}]: two launches on "
                                     f"the same inputs differ")
            d_k, i_k = per_call_ms(torch, kfn, BOTH_WAYS_CALLS)
            d_l, i_l = per_call_ms(torch, lfn, BOTH_WAYS_CALLS)
            extra.update({"bit_equal_twice": True, "device_ms": d_k,
                          "issue_ms": i_k, "library_device_ms": d_l,
                          "library_issue_ms": i_l})
            note += (f"; two launches bit-equal; device kernel={d_k:.4f}ms "
                    f"library={d_l:.4f}ms; issue per call kernel="
                    f"{i_k:.4f}ms library={i_l:.4f}ms")
        print(f"  {kname:15s} {case:18s} max_abs_err={err:.3e} "
              f"(tol {'bit-equal' if tol == 0 else tol}) "
              f"kernel={t_k:.4f}ms plain={t_p:.4f}ms library={t_l:.4f}ms "
              f"bound={max(b_ops, b_bytes):.4f}ms "
              f"({'operations' if b_ops >= b_bytes else 'bytes'}){note}",
              flush=True)
        agg = per_kernel.setdefault(kname, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "cases": []})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bound_ms", max(b_ops, b_bytes)),
                       ("ops_ms", b_ops), ("bytes_ms", b_bytes)):
            agg[key] += v
        agg["cases"].append({"case": case, "ms": t_k, "plain_ms": t_p,
                             "library_ms": t_l, "max_abs_err": err,
                             "bound_ms": max(b_ops, b_bytes),
                             "bound_by": "operations" if b_ops >= b_bytes
                             else "bytes", **extra})
    return per_kernel


def stream_sums(per_kernel: dict) -> dict:
    """Sums over #5's 7 activation cases on 8×80×80×64 (the cases of
    the kernel table's earlier rows) and over #4's cases, each key of
    the cases summed, printed on a line of their own."""
    out = {}
    for kname, label, pick in (
            ("pointwise", "7 activations on 8x80x80x64",
             lambda c: c["case"] in ACT_FLOPS),
            ("resize_nearest", "both resizes", lambda c: True)):
        cases = [c for c in per_kernel[kname]["cases"] if pick(c)]
        sums = {k: sum(c[k] for c in cases) for k in (
            "ms", "library_ms", "device_ms", "library_device_ms",
            "issue_ms", "library_issue_ms", "bound_ms", "plain_ms")}
        out[kname] = {"cases": len(cases), **sums}
        print(f"  {kname} sum over {label}: kernel {sums['ms']:.4f} ms "
              f"back to back, device {sums['device_ms']:.4f}, issue "
              f"{sums['issue_ms']:.4f}; library {sums['library_ms']:.4f}, "
              f"device {sums['library_device_ms']:.4f}, issue "
              f"{sums['library_issue_ms']:.4f}; plain "
              f"{sums['plain_ms']:.4f}; bound {sums['bound_ms']:.4f}",
              flush=True)
    return out


def pool_sums(per_kernel: dict) -> dict:
    """#3's sums over POOL_EARLIER's three cases and over yolov3-tiny's
    six (V3T_POOLS), each key summed, each printed on a line of its
    own."""
    out = {}
    keys = ("ms", "library_ms", "device_ms", "library_device_ms",
            "issue_ms", "library_issue_ms", "bound_ms", "plain_ms")
    for key, label, pick in (
            ("earlier", "the 3 earlier cases", lambda c: c in POOL_EARLIER),
            ("v3t", "yolov3-tiny's 6 pools at 416",
             lambda c: c.startswith("v3t_"))):
        cases = [c for c in per_kernel["maxpool2d"]["cases"]
                 if pick(c["case"])]
        sums = {k: sum(c[k] for c in cases) for k in keys}
        out[key] = {"cases": len(cases), **sums}
        f = {k: f"{v:.4f}" for k, v in sums.items()}
        print(f"  maxpool2d sum over {label}: kernel {f['ms']} ms back to "
              f"back, device {f['device_ms']}, issue {f['issue_ms']}; "
              f"library {f['library_ms']}, device {f['library_device_ms']}"
              f", issue {f['library_issue_ms']}; plain {f['plain_ms']}; "
              f"bound {f['bound_ms']} (bytes)", flush=True)
    return out


def nan_probe(torch, K, dev, strict: bool = True) -> dict:
    """NaN at a seeded 1% of the inputs: #3's output NaN exactly where
    its plain version's is, and equal elsewhere, at SPPF's 5×5/s1 and a
    2×2/s1 (overlap route), a 2×2/s2 (disjoint route) and C = 6 (one
    float at a time); ``pointwise(relu)`` likewise on 8×80×80×64. With
    ``strict``, a mismatch raises."""
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    cases = [("maxpool2d 5x5s1 8x20x20x128", (BATCH, 20, 20, 128), 5, 1),
             ("maxpool2d 2x2s1 8x13x13x128", (BATCH, 13, 13, 128), 2, 1),
             ("maxpool2d 2x2s2 8x80x80x64", (BATCH, 80, 80, 64), 2, 2),
             ("maxpool2d 2x2s2 2x13x13x6", (2, 13, 13, 6), 2, 2),
             ("pointwise relu 8x80x80x64", (BATCH, 80, 80, 64), 0, 0)]
    for name, shape, k, s in cases:
        x = torch.randn(*shape, generator=gen, device=dev)
        x[torch.rand(*shape, generator=gen, device=dev) < 0.01] = \
            float("nan")
        if k:
            got = K.maxpool.maxpool2d(x, k=k, stride=s, act="leaky_relu")
            want = K.ref.maxpool2d(x, k=k, stride=s, act="leaky_relu")
        else:
            got, want = K.pointwise.pointwise(x, "relu"), K.ref.pointwise(
                x, "relu")
        torch.cuda.synchronize()
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        same = bool(torch.equal(nan_g, nan_w)) and bool(
            torch.equal(got[~nan_w], want[~nan_w]))
        out[name] = {"same": same, "nan_plain": int(nan_w.sum()),
                     "nan_kernel": int(nan_g.sum())}
    ok = all(v["same"] for v in out.values())
    print("[nan] NaN positions and values equal to the plain version: "
          + "; ".join(f"{k} {v['same']} ({v['nan_kernel']} of "
                      f"{v['nan_plain']} NaN)" for k, v in out.items()),
          flush=True)
    if strict and not ok:
        raise AssertionError(f"NaN probe: {out}")
    return out


def pool_sweep(torch, K, build, dev) -> dict | None:
    """#3's device ms a call (``per_call_ms``) at each of its cases under
    its planned launch and its neighbours, launched through ``build.
    launch`` (not counted) and each bit-equal to the plain version: on the
    overlap route every th of TILE_ROWS whose tile fits shared memory, on
    the disjoint route one round of pairs a thread and one output a
    thread (both past one wave where the outputs are many). None in a
    checkout without ``maxpool._launch_args``."""
    mp = K.maxpool
    args_of = getattr(mp, "_launch_args", None)
    if args_of is None:
        return None
    gen = torch.Generator(device=dev).manual_seed(21)
    shapes = [(name, H, H, C, k, s, act)
              for name, (H, C, k, s, act) in POOL_EARLIER.items()]
    shapes += [(f"v3t_{H}x{W}x{C}_{k}x{k}s{s}", H, W, C, k, s, act)
               for H, W, C, k, s, act in V3T_POOLS]
    out = {}
    for name, H, W, C, k, s, act in shapes:
        x = torch.randn(BATCH, H, W, C, generator=gen, device=dev)
        want = K.ref.maxpool2d(x, k=k, stride=s, act=act)
        y = torch.empty_like(want)
        args = args_of(BATCH, H, W, C, k, s, build.act_code(act), True,
                       build.sm_count(dev)).values()
        head, plan = args[:11], mp.Plan(*args[11:])
        Ho, Wo = args[6], args[7]
        alts = {"planned": plan}
        if plan.route == mp.OVERLAP:
            for t in mp.TILE_ROWS:
                if t <= Ho and t != plan.th and mp.smem_bytes(
                        t, plan.tw, plan.cs, k, s, plan.vec) <= mp.SMEM_LIMIT:
                    alts[f"th {t}"] = plan._replace(th=t, gy=-(-Ho // t))
        else:
            vecs = BATCH * Ho * Wo * (C // 4 if plan.vec else C)
            alts["one round"] = plan._replace(
                gx=-(-vecs // (2 * mp.THREADS)))
            alts["one output a thread"] = plan._replace(
                gx=-(-vecs // mp.THREADS))
        res = {}
        for label, p in alts.items():
            a = mp.PoolArgs(*head, *p)

            def run(a=a):
                build.launch("repro_maxpool2d_nhwc_f32", dev, x.data_ptr(),
                             y.data_ptr(), ctypes.addressof(a))
            y.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"pool_sweep {name} {label} {p}")
            res[label] = {"th": p.th, "grid": [p.gx, p.gy, p.gz],
                          "device_ms": per_call_ms(torch, run,
                                                   BOTH_WAYS_CALLS)[0]}
        out[name] = res
        print(f"[pool_sweep] {name}: " + "; ".join(
            f"{label} (th {r['th']}, grid {r['grid']}) {r['device_ms']:.4f}"
            for label, r in res.items()), flush=True)
    return out


def a8_sums(per_kernel: dict) -> dict:
    """#8's 6 and #10's 10 cases of the kernel table's earlier rows (all
    but ``widest_N...``), and #9's earlier case (3x3_head_80) and all of
    its cases, each key summed and printed on a line of its own."""
    out = {}
    for key, kname, label, pick in (
            ("qmatmul_a8", "qmatmul_a8", "earlier ",
             lambda c: not c.startswith("widest")),
            ("qmatmul_a8_double", "qmatmul_a8_double", "earlier ",
             lambda c: not c.startswith("widest")),
            ("qmatmul_a8_grouped", "qmatmul_a8_grouped", "earlier ",
             lambda c: c.startswith("3x3_head_80")),
            ("qmatmul_a8_grouped_all", "qmatmul_a8_grouped", "",
             lambda c: True)):
        if kname not in per_kernel:
            continue
        cases = [c for c in per_kernel[kname]["cases"] if pick(c["case"])]
        sums = {k: sum(c[k] for c in cases) for k in (
            "ms", "library_ms", "device_ms", "library_device_ms",
            "issue_ms", "library_issue_ms", "bound_ms", "plain_ms")}
        out[key] = {"cases": len(cases), **sums}
        f = {k: f"{v:.4f}" for k, v in sums.items()}
        print(f"  {kname} sum over its {len(cases)} {label}cases: kernel "
              f"{f['ms']} ms back to back, device {f['device_ms']}, issue "
              f"{f['issue_ms']}; library {f['library_ms']}, device "
              f"{f['library_device_ms']}, issue {f['library_issue_ms']}; "
              f"plain {f['plain_ms']}; bound {f['bound_ms']}", flush=True)
    return out


def conv_sums(per_kernel: dict) -> dict:
    """#1's and #2's sums over the seven earlier cases (CONV_EARLIER),
    each key summed, and the later cases one by one, each printed on a
    line of its own."""
    out = {}
    keys = ("ms", "library_ms", "device_ms", "library_device_ms",
            "issue_ms", "library_issue_ms", "bound_ms", "fp32_bound_ms",
            "plain_ms")
    for kname in ("conv2d", "conv2d_double"):
        cases = [c for c in per_kernel[kname]["cases"]
                 if c["case"] in CONV_EARLIER]
        sums = {k: sum(c[k] for c in cases) for k in keys}
        out[kname] = {"cases": len(cases), **sums}
        f = {k: f"{v:.4f}" for k, v in sums.items()}
        print(f"  {kname} sum over the {len(cases)} earlier cases: kernel "
              f"{f['ms']} ms back to back, device {f['device_ms']}, issue "
              f"{f['issue_ms']}; library {f['library_ms']}, device "
              f"{f['library_device_ms']}, issue {f['library_issue_ms']}; "
              f"plain {f['plain_ms']}; bound {f['bound_ms']} (3xTF32), "
              f"{f['fp32_bound_ms']} (fp32)", flush=True)
        for c in per_kernel[kname]["cases"]:
            if c["case"] not in CONV_EARLIER:
                print(f"  {kname} {c['case']}: device {c['device_ms']:.4f}"
                      f" ms (library {c['library_device_ms']:.4f}), back to"
                      f" back {c['ms']:.4f}; bound {c['bound_ms']:.4f}",
                      flush=True)
    return out


def attn_sums(per_kernel: dict) -> dict:
    """#11's sums over its cases (MHA_CASES), each key summed, and over
    the cases SDPA takes (no softcap): the kernel's and SDPA's, back to
    back and by device time; #12's and SDPA's over DEC_CASES without a
    softcap. Each printed on a line of its own."""
    out = {}
    keys = ("ms", "device_ms", "issue_ms", "bound_ms", "fp32_bound_ms",
            "plain_ms")
    cases = [c for c in per_kernel["mha"]["cases"] if c["case"] in MHA_CASES]
    sums = {k: sum(c[k] for c in cases) for k in keys}
    lib = [c for c in cases if c["library_ms"] is not None]
    with_lib = {k: sum(c[k] for c in lib) for k in (
        "ms", "device_ms", "library_ms", "library_device_ms")}
    out["mha"] = {"cases": len(cases), **sums, "sdpa_cases": len(lib),
                  **{f"sdpa_cases_{k}": v for k, v in with_lib.items()}}
    f = {k: f"{v:.4f}" for k, v in sums.items()}
    w = {k: f"{v:.4f}" for k, v in with_lib.items()}
    print(f"  mha sum over its {len(cases)} cases: kernel {f['ms']} ms back "
          f"to back, device {f['device_ms']}, issue {f['issue_ms']}; plain "
          f"{f['plain_ms']}; bound {f['bound_ms']} (3xTF32), "
          f"{f['fp32_bound_ms']} (fp32)", flush=True)
    print(f"  mha over the {len(lib)} cases without softcap: kernel "
          f"{w['ms']} ms back to back, device {w['device_ms']}; SDPA "
          f"{w['library_ms']}, device {w['library_device_ms']}", flush=True)
    out["mha_families"] = family_sums(per_kernel, "mha", MHA_FAMILY_CASES)
    if "decode_attention" in per_kernel:
        out["decode_attention"] = dec_sums(per_kernel)
    return out


def dec_sums(per_kernel: dict) -> dict:
    """#12's sums over DEC_CASES (back to back, device time, host issue
    per call, bound) and, over the cases SDPA takes (no softcap), the
    kernel's and SDPA's, back to back and by device time; each printed
    on a line of its own."""
    cases = [c for c in per_kernel["decode_attention"]["cases"]
             if c["case"] in DEC_CASES]
    keys = ("ms", "device_ms", "issue_ms", "bound_ms", "plain_ms")
    sums = {k: sum(c[k] for c in cases) for k in keys}
    lib = [c for c in cases if c["library_ms"] is not None]
    with_lib = {k: sum(c[k] for c in lib) for k in (
        "ms", "device_ms", "library_ms", "library_device_ms")}
    f = {k: f"{v:.4f}" for k, v in sums.items()}
    w = {k: f"{v:.4f}" for k, v in with_lib.items()}
    print(f"  decode_attention sum over its {len(cases)} cases: kernel "
          f"{f['ms']} ms back to back, device {f['device_ms']}, issue "
          f"{f['issue_ms']}; plain {f['plain_ms']}; bound {f['bound_ms']} "
          f"(bytes)", flush=True)
    print(f"  decode_attention over the {len(lib)} cases without softcap: "
          f"kernel {w['ms']} ms back to back, device {w['device_ms']}; SDPA "
          f"{w['library_ms']}, device {w['library_device_ms']}", flush=True)
    return {"cases": len(cases), **sums, "sdpa_cases": len(lib),
            **{f"sdpa_cases_{k}": v for k, v in with_lib.items()},
            "families": family_sums(per_kernel, "decode_attention",
                                    DEC_FAMILY_CASES)}


def family_sums(per_kernel: dict, kname: str, names: dict) -> dict:
    """``kname``'s sums over its LM-family cases ``names`` (kernel back to
    back and by device time, plain, bound, SDPA by device time), printed
    on a line of their own."""
    cases = [c for c in per_kernel[kname]["cases"] if c["case"] in names]
    sums = {k: sum(c[k] for c in cases) for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "library_device_ms")}
    f = {k: f"{v:.4f}" for k, v in sums.items()}
    print(f"  {kname} sum over the {len(cases)} LM-family cases: kernel "
          f"{f['ms']} ms back to back, device {f['device_ms']}; plain "
          f"{f['plain_ms']}; bound {f['bound_ms']}; SDPA device "
          f"{f['library_device_ms']}", flush=True)
    return {"cases": len(cases), **sums}


def dec_share_sweep(torch, K, dev) -> dict | None:
    """#12's device time a call (``per_call_ms``) at each DEC_CASES case
    with the share length its plan picks, half of it and twice it
    (``decode_attention._plan`` patched for the reading, the cap on
    shares a row kept), to read the plan's rule against its neighbours;
    None in a checkout from before that planner."""
    mod = K.decode_attention
    real = getattr(mod, "_plan", None)
    if real is None:
        return None
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    try:
        for name, (B, S, Hq, Hkv, D, lens, win, cap) in DEC_CASES.items():
            q = torch.randn(B, Hq, D, generator=gen, device=dev)
            kc = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            vc = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            L0 = real(S, win or 0, D, Hq // Hkv, B * Hkv,
                      mod.sm_count(dev))[0]
            span = min(S, win) if win else S
            row = {}
            for L in (L0 // 2, L0, 2 * L0):
                shares = -(-span // L)
                if shares > mod.MAX_SHARES:
                    continue
                mod._plan = lambda *a, L=L, n=shares: (L, n)
                row[L] = per_call_ms(torch, lambda: mod.decode_attention(
                    q, kc, vc, ln, window=win, softcap=cap),
                    BOTH_WAYS_CALLS)[0]
            mod._plan = real
            out[name] = {"plan_L": L0, "device_ms": row}
            print(f"  decode_attention {name}: device ms by share length "
                  + ", ".join(f"{L}{' (plan)' if L == L0 else ''}: {v:.4f}"
                              for L, v in row.items()), flush=True)
    finally:
        mod._plan = real
    return out


def dec_step_split(torch, lm, registry, dev, arch: str) -> dict:
    """One decode step of ``arch`` at full width and depth (float32
    weights from a seeded generator on the card) over LM_BATCH rows of a
    LM_CACHE cache at ``lm_spans``' lengths (128, 700, 2048, 4000), read
    by ``profile_call``: the step's host issue and its time to a
    synchronise, and its kernels' time split into #12 (kernels named
    ``decode``: time and launches), cuBLAS GEMMs (names holding
    ``gemm``) and the rest."""
    cfg = registry.get(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    cache = lm.init_cache(cfg, LM_BATCH, LM_CACHE, device=dev)
    cache["len"] = torch.tensor([128, 700, 2048, 4000][:LM_BATCH],
                                dtype=torch.int32, device=dev)
    tokens = torch.arange(1, LM_BATCH + 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        sp = profile_call(torch, lambda: lm.decode_step(params, cfg, tokens,
                                                        cache),
                          match="decode")
    del params, cache
    torch.cuda.empty_cache()
    by = sp.get("by_name", {})
    gemm = sum(v[0] for k, v in by.items() if "gemm" in k.lower())
    out = {"arch": arch, "layers": cfg.n_layers, "wall_ms": sp["wall"],
           "issue_ms": sp["issue"], "busy_ms": sp["busy"],
           "span_ms": sp["span"], "dec_ms": sp.get("match_ms"),
           "dec_kernels": sp.get("match_kernels"), "gemm_ms": gemm,
           "dec_by_name": {k: v for k, v in by.items() if "decode" in k}}
    if sp["busy"] is not None:
        out["rest_ms"] = sp["busy"] - out["dec_ms"] - gemm
        print(f"[dec] {arch} decode step ({cfg.n_layers} layers, lengths "
              f"128/700/2048/4000 of {LM_CACHE}): {sp['wall']:.2f} ms to a "
              f"synchronise (host issue {sp['issue']:.2f}); kernels "
              f"{sp['busy']:.3f} ms over a {sp['span']:.3f} ms span: "
              f"decode_attention {out['dec_ms']:.4f} in "
              f"{out['dec_kernels']} kernels, GEMM {gemm:.3f}, the rest "
              f"{out['rest_ms']:.3f}", flush=True)
    else:
        print(f"[dec] {arch} decode step: {sp['wall']:.2f} ms; device not "
              f"measured (no kernel records)", flush=True)
    return out


def dec_window_check(torch, K, dev, strict: bool = True) -> dict:
    """#12 at lengths around and past S with a window (DEC_PAST_S):
    within KERNEL_TOL of the plain version where a position is visible,
    exactly 0 where none is (the plain version gives NaN there, the
    Pallas kernel 0). The visible range is [max(len - window, 0),
    min(len, S)). With ``strict``, a miss raises; without, it is only
    reported, so that the check reads an earlier checkout too."""
    B, S, Hq, Hkv, D, win, seed = DEC_PAST_S
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=gen, device=dev)
    kc = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    vc = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    lens = (S - 1, S, S + 1, S + 9, S + 50, S + win - 1, S + win,
            S + win + 37)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = K.decode_attention.decode_attention(q, kc, vc, ln, window=win)
    want = K.ref.decode_attention(q, kc, vc, ln, window=win)
    torch.cuda.synchronize()
    tol = KERNEL_TOL["decode_attention"]
    rows, ok = {}, True
    for b, n in enumerate(lens):
        visible = min(n, S) - max(n - win, 0)
        if visible > 0:
            err = float((got[b] - want[b]).abs().max())
            good = bool(torch.all((got[b] - want[b]).abs()
                                  <= tol + tol * want[b].abs()))
        else:
            err = float(got[b].abs().max())
            good = err == 0.0
        rows[n] = {"visible": max(visible, 0), "max_abs_err": err,
                   "ok": good}
        ok = ok and good
    print(f"[dec_window] #12 at B {B}, S {S}, window {win}: "
          + "; ".join(f"len {n} ({v['visible']} visible) max_abs_err "
                      f"{v['max_abs_err']:.3e}{'' if v['ok'] else ' MISS'}"
                      for n, v in rows.items())
          + f" (within {tol}, 0 where nothing is visible)", flush=True)
    if strict and not ok:
        raise AssertionError(f"#12 past S with a window: {rows}")
    return {"shape": DEC_PAST_S, "lengths": rows, "ok": ok}


def attn_prefill_split(torch, lm, registry, dev, T: int = 2048) -> dict:
    """One granite-3-8b prefill of T tokens at full width and depth
    (float32 weights from a seeded generator on the card), read by
    ``profile_call``: the call's time on the host clock to a synchronise
    (``wall``) and its kernels' time (``busy``), split into #11 (``mha``
    kernels: time and launches), cuBLAS GEMMs (kernel names holding
    ``gemm``) and the rest."""
    cfg = registry.get("granite-3-8b")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    toks = torch.randint(0, cfg.vocab, (1, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5),
                         dtype=torch.int32)
    with torch.inference_mode():
        sp = profile_call(torch, lambda: lm.prefill(
            params, cfg, {"tokens": toks}, T + LM_NEW), match="mha")
    del params
    torch.cuda.empty_cache()
    by = sp.get("by_name", {})
    gemm = sum(v[0] for k, v in by.items() if "gemm" in k.lower())
    out = {"T": T, "layers": cfg.n_layers, "wall_ms": sp["wall"],
           "issue_ms": sp["issue"], "busy_ms": sp["busy"],
           "mha_ms": sp.get("match_ms"), "mha_launches":
           sp.get("match_kernels"), "gemm_ms": gemm}
    if sp["busy"] is not None:
        out["rest_ms"] = sp["busy"] - out["mha_ms"] - gemm
        print(f"[attn] granite-3-8b prefill {T} ({cfg.n_layers} layers): "
              f"{sp['wall']:.1f} ms to a synchronise (host issue "
              f"{sp['issue']:.1f}); kernels {sp['busy']:.1f} ms: mha "
              f"{out['mha_ms']:.2f} in {out['mha_launches']} launches, GEMM "
              f"{gemm:.1f}, the rest {out['rest_ms']:.2f}", flush=True)
    else:
        print(f"[attn] granite-3-8b prefill {T}: {sp['wall']:.1f} ms; "
              f"device not measured (no kernel records)", flush=True)
    return out


def a8_pointer_check(torch, Q, dev) -> dict:
    """#10 at the stem's shape (K = 27, packed int4) launches on the
    caller's own xq and codes: no padded copy of either is made."""
    M, Kf, N, _, _ = QMM_SHAPES["stem"]
    xq = torch.zeros(M, Kf, dtype=torch.int8, device=dev)
    q = torch.zeros((Kf + 1) // 2, N, dtype=torch.int8, device=dev)
    one, nil = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    seen, real = [], Q.launch

    def spy(fn, d, *args):
        seen.append((fn, args[0], args[1]))
        return real(fn, d, *args)
    Q.launch = spy
    try:
        Q.qmatmul_a8(xq, q, one, nil, x_scale=1.0, w_packed=True,
                     pipeline="double")
    finally:
        Q.launch = real
    if seen != [("repro_qmatmul_a8_double", xq.data_ptr(), q.data_ptr())]:
        raise AssertionError(f"qmatmul_a8_double at the stem launched "
                             f"{seen}, not on the caller's xq and codes")
    print(f"  qmatmul_a8_double  stem: one launch, on the caller's own "
          f"{M} x {Kf} codes (K = {Kf}, no padded copy)", flush=True)
    return {"launches": len(seen), "on_callers_xq": True}


def a8g_exact_check(torch, Q, dev) -> dict:
    """#9's exact case at the named shape (3x3_head_80, unsplit) and at
    short_M200_K2304_N64 (split by its plan): activation and weight
    codes in [-8, 7], block scales alternating 1 and 2 over blocks of 16,
    unit weight scale, zero 0. Every partial sum is then an integer
    below 2^24, so the result must equal the int64 contraction
    (computed in float64, exact here) bit for bit, in any order of the
    sums and across any split."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name, (M, Kf, N) in (
            ("3x3_head_80", QMM_SHAPES["3x3_head_80"][:3]),
            ("short_M200_K2304_N64",
             A8G_SHAPES["short_M200_K2304_N64"][:3])):
        xq = torch.randint(-8, 8, (M, Kf), generator=gen, device=dev,
                           dtype=torch.int8)
        q = torch.randint(-8, 8, (Kf, N), generator=gen, device=dev,
                          dtype=torch.int8)
        sv = tuple(float(1 + (k // 16) % 2) for k in range(Kf))
        sk = torch.tensor(sv, dtype=torch.float64, device=dev)
        want = ((xq.to(torch.float64) * sk) @ q.to(torch.float64)).to(
            torch.float32)
        one, nil = torch.ones(1, device=dev), torch.zeros(1, device=dev)
        n9 = Q.qmatmul_a8_grouped.launches.value
        got = Q.qmatmul_a8(xq, q, one, nil, x_scale=sv)
        torch.cuda.synchronize()
        plan = a8g_plan(Q, dev, M, Kf, N, 16)
        out[name] = {"bit_equal": bool(torch.equal(got, want)),
                     "plan": plan}
        if Q.qmatmul_a8_grouped.launches.value != n9 + 1 \
                or not out[name]["bit_equal"]:
            raise AssertionError(f"#9 exact case {name}: not bit-equal to "
                                 f"the int64 contraction (max |diff| "
                                 f"{float((got - want).abs().max())})")
        print(f"  qmatmul_a8_grouped exact case {name} ({M}x{Kf}x{N}, "
              f"plan {plan}): bit-equal to the int64 contraction",
              flush=True)
    return out


def per_group_forward(torch, acc_g, xb, table, counters) -> dict:
    """quant_per_group's forward (yolov8n at 160, W8A8, per-group scales)
    on batch ``xb`` through ``table``: its launches (every conv #9, or
    #7 where a conv's groups share no K tile), device and host issue ms
    (``device_ms``, median of 5) and a ``torch.profiler`` split (the A8
    kernels' summed time and count: #9 and its split reduce)."""
    for c in counters.values():
        c.reset()
    acc_g.forward(xb, backend=table)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items() if c.value}
    if launches.get("qmatmul_a8_grouped", 0) \
            + launches.get("qmatmul", 0) != 63:
        raise AssertionError(f"quant_per_group forward launched "
                             f"{launches}")
    dev, issue = device_ms(torch, lambda: acc_g.forward(xb, backend=table),
                           reps=5)
    prof = profile_call(torch, lambda: acc_g.forward(xb, backend=table),
                        top=8, match="qmatmul_a8")
    split = (f"kernels busy {prof['busy']:.3f} ms over {prof['kernels']} "
             f"launches, of it {prof['match_ms']:.3f} ms in "
             f"{prof['match_kernels']} A8 matmul kernels; top {prof['top']}"
             if prof["busy"] is not None else "no kernel records")
    print(f"[per_group_forward] launches {launches}; device {dev:.3f} ms, "
          f"host issue {issue:.3f} ms; profiler: {split}", flush=True)
    return {"launches": launches, "device_ms": dev, "issue_ms": issue,
            "profile": prof}


def a8_forward(torch, K, acc, xb, grid, counters) -> dict:
    """The W4A8 design's forward on batch ``xb``, through the grid table
    (#8) and the DoubleBuffered one (#10): 63 launches of the kernel a
    forward (counted), device and host issue ms (``device_ms``, median of
    5), and a ``torch.profiler`` split of one forward (``profile_call``:
    the A8 kernels' summed time and count, the top kernels by time)."""
    out = {}
    for label, table, kname in (
            ("grid", grid, "qmatmul_a8"),
            ("double", DoubleBuffered(K, grid), "qmatmul_a8_double")):
        for c in counters.values():
            c.reset()
        acc.forward(xb, backend=table)
        torch.cuda.synchronize()
        if counters[kname].value != 63:
            raise AssertionError(f"W4A8 forward ({label}) launched "
                                 f"{counters[kname].value} {kname}")
        dev, issue = device_ms(torch, lambda: acc.forward(xb, backend=table),
                               reps=5)
        prof = profile_call(torch, lambda: acc.forward(xb, backend=table),
                            top=8, match="qmatmul_a8")
        out[label] = {"device_ms": dev, "issue_ms": issue, "profile": prof}
        split = (f"kernels busy {prof['busy']:.3f} ms over "
                 f"{prof['kernels']} launches, of it {prof['match_ms']:.3f} "
                 f"ms in {prof['match_kernels']} A8 matmul launches; top "
                 f"{prof['top']}" if prof["busy"] is not None
                 else "no kernel records")
        print(f"[w4a8_forward] {label}: 63 {kname} a forward; device "
              f"{dev:.3f} ms, host issue {issue:.3f} ms; profiler: {split}",
              flush=True)
    return out


def issue_split(torch, K, build, dev, n: int = 200) -> dict:
    """Host issue per call, µs, of one #5 call (silu on 8×5×5×64, its
    kernel queued behind ``device_ms``'s spin, ``n`` calls a reading) and
    of its parts: the wrapper's steps, and the launch path's steps both
    in the earlier form of ``_build.launch`` (the library's lock taken,
    ``torch.cuda.device`` entered, a ``Stream`` built, the function
    looked up by name) and as it takes them now."""
    x = torch.randn(BATCH, 5, 5, 64, device=dev)
    y = torch.empty_like(x)
    lib, fn, idx = build.library(), "repro_pointwise_f32", dev.index
    f = build._fns[fn]
    xp, yp, numel = x.data_ptr(), y.data_ptr(), x.numel()
    head, nvec, blocks = K.pointwise._plan(numel, xp, yp,
                                           build.sm_count(dev))
    args = (xp, yp, numel, head, nvec, build.act_code("silu"), blocks)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def locked():
        with build._lock:
            return build._lib

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def old_launch():
        with build._lock:
            lib_ = build._lib
        with torch.cuda.device(dev):
            rc = getattr(lib_, fn)(*args,
                                   torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(rc)

    parts = {
        "wrapper pointwise(x, 'silu')": lambda: K.pointwise.pointwise(
            x, "silu"),
        "  act_code": lambda: build.act_code("silu"),
        "  check_operand": lambda: build.check_operand("x", x, dev),
        "  torch.empty_like": lambda: torch.empty_like(x),
        "  data_ptr x2": lambda: (x.data_ptr(), y.data_ptr()),
        "  _plan with sm_count": lambda: K.pointwise._plan(
            numel, xp, yp, build.sm_count(dev)),
        "  launch (now)": lambda: build.launch(fn, dev, *args),
        "  LaunchCounter.add": K.pointwise.launches.add,
        "launch, earlier form": old_launch,
        "  old: library() under its lock": locked,
        "  old: torch.cuda.device entered": device_ctx,
        "  old: current_stream(dev).cuda_stream": lambda:
            torch.cuda.current_stream(dev).cuda_stream,
        "  old: getattr(lib, fn)": lambda: getattr(lib, fn),
        "  now: _fns[fn]": lambda: build._fns[fn],
        "  now: current device compared": lambda:
            torch._C._cuda_getDevice() == idx,
        "  now: raw stream handle": lambda:
            torch._C._cuda_getCurrentRawStream(idx),
        "  the ctypes call (launches)": lambda: f(*args, stream),
        "an empty call (the reading's own cost)": lambda: None,
    }
    out = {}
    for name, part in parts.items():
        out[name] = per_call_ms(torch, part, n)[1] * 1e3
    torch.cuda.synchronize()
    print("[issue] host issue per call, us (n = " + str(n) + " calls behind "
          "a spin, median of 3): " + "; ".join(
              f"{k.strip()} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def check_sibling(torch, kname: str, case: str, got, kfn, sib: dict) -> dict:
    """The checks of a double-buffered kernel's case beyond its plain
    version: a second launch equal to the first bit for bit (a missing
    wait or barrier between a slot's last read and its refill shows as
    results that differ from run to run), the grid sibling on the same
    inputs within ``sib["grid_tol"]`` (bit-equality reported), and
    where ``sib["acc"]`` gives the two kernels through an identity
    epilogue, their int32 accumulators equal (|acc| < 2^24, so float32
    holds them exactly). Returns what it read, with the sibling's
    time."""
    again = kfn()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        raise AssertionError(f"{kname}[{case}]: two launches on the same "
                             f"inputs differ")
    want = sib["grid"]()
    torch.cuda.synchronize()
    tol = sib["grid_tol"]
    out = {"vs_grid_max_abs_err": float((got - want).abs().max()),
           "bit_equal_to_grid": bool(torch.equal(got, want))}
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{kname}[{case}] disagrees with its grid "
                             f"sibling: {out}")
    if "acc" in sib:
        a, b = (fn() for fn in sib["acc"])
        torch.cuda.synchronize()
        big = float(b.abs().max())
        out["acc_bit_equal"] = bool(torch.equal(a, b))
        if big >= 2 ** 24 or not out["acc_bit_equal"]:
            raise AssertionError(f"{kname}[{case}]: int32 accumulator "
                                 f"differs from the grid kernel's "
                                 f"(max |acc| {big})")
    out["grid_ms"] = cuda_ms(torch, sib["grid"])
    return out


def check_cases(torch, cases: list, per_kernel: dict):
    """Phase 2 for the cases of ``qmm_cases``, ``lm_cases``,
    ``ssd_cases`` and ``conv_cases``: each launches its kernel
    once (its counter moves by one, ``stays`` does not), agrees with its
    plain version (every output, where it returns a tuple), and is
    timed. A case's 12th entry, a dict, adds checks: with ``grid`` it
    passes ``check_sibling``; with ``again`` (#7's and #8's cases) a
    second launch must equal the first bit for bit; its ``plan`` is
    printed; with ``both_ways`` the kernel's and the library call's
    device time and host issue per call (``per_call_ms``) are printed
    and kept beside the back-to-back times. Adds to ``per_kernel``."""
    for (kname, case, kfn, pfn, lfn, ops, nbytes, route, tol, moves,
         stays, *sib) in cases:
        n_moves = moves.value
        n_stays = stays.value if stays is not None else 0
        got = kfn()
        torch.cuda.synchronize()
        if moves.value != n_moves + 1 or (
                stays is not None and stays.value != n_stays):
            raise AssertionError(f"{kname}[{case}] launched the wrong "
                                 f"kernel")
        want = pfn()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        ok = all(bool(torch.equal(g, w)) if tol == 0 else bool(
            torch.allclose(g, w, atol=tol, rtol=tol)) for g, w in pairs)
        # what allclose holds to 1: |got - plain| / (tol + tol·|plain|)
        ratio = max(float(((g - w).abs() / (tol * (1 + w.abs()))).max())
                    for g, w in pairs) if tol else 0.0
        if not ok:
            raise AssertionError(f"{kname}[{case}] disagrees with its "
                                 f"plain version: max_abs_err={err}")
        extra = check_sibling(torch, kname, case, got, kfn, sib[0]) \
            if sib and "grid" in sib[0] else {}
        note = ""
        if sib and "plan" in sib[0]:
            plan = sib[0]["plan"]
            extra["plan"] = plan
            note = " plan " + (" ".join(f"{k}={v}" for k, v in plan.items())
                               if plan else "n/a")
        if sib and "fp32_bound_ms" in sib[0]:
            extra["fp32_bound_ms"] = sib[0]["fp32_bound_ms"]
            note += f"; fp32 bound={extra['fp32_bound_ms']:.4f}ms"
        both = kname in BOTH_WAYS or bool(sib and sib[0].get("both_ways"))
        if kname in BOTH_WAYS or (sib and sib[0].get("again")):
            again = kfn()
            torch.cuda.synchronize()
            pairs = zip(again, got) if isinstance(got, tuple) \
                else [(again, got)]
            if not all(torch.equal(a, g) for a, g in pairs):
                raise AssertionError(f"{kname}[{case}]: two launches on "
                                     f"the same inputs differ")
            extra["bit_equal_twice"] = True
            note += ", two launches bit-equal"
        t_k, t_p = cuda_ms(torch, kfn), cuda_ms(torch, pfn)
        t_l = cuda_ms(torch, lfn) if lfn is not None else None
        if both:
            d_k, i_k = per_call_ms(torch, kfn, BOTH_WAYS_CALLS)
            extra.update(device_ms=d_k, issue_ms=i_k)
            note += f"; device time kernel={d_k:.4f}ms"
            if lfn is not None:
                d_l, i_l = per_call_ms(torch, lfn, BOTH_WAYS_CALLS)
                extra.update(library_device_ms=d_l, library_issue_ms=i_l)
                note += f" library={d_l:.4f}ms"
            note += f"; issue per call kernel={i_k:.4f}ms" + (
                f" library={i_l:.4f}ms" if lfn is not None else "")
        if sib and sib[0].get("library_backend") and lfn is not None:
            extra["library_backend"] = library_backend(torch, lfn)
            note += f"; library backend {extra['library_backend']['backend']}"
        b_ops, b_bytes = bound(ops, nbytes, route)
        lib = f"{t_l:.4f}ms" if t_l is not None else "n/a"
        grid = (f" grid={extra['grid_ms']:.4f}ms (double/grid "
                f"{t_k / extra['grid_ms']:.3f}; vs grid max_abs_err "
                f"{extra['vs_grid_max_abs_err']:.3e}, bit-equal "
                f"{extra['bit_equal_to_grid']}"
                + (f", int32 acc bit-equal {extra['acc_bit_equal']}"
                   if "acc_bit_equal" in extra else "") + ")") \
            if "grid_ms" in extra else ""
        print(f"  {kname:18s} {case:34s} max_abs_err={err:.3e} "
              f"(tol {'bit-equal' if tol == 0 else tol}; err/(tol·(1+|plain|)) "
              f"{ratio:.3f}) "
              f"kernel={t_k:.4f}ms plain={t_p:.4f}ms library={lib} "
              f"bound={max(b_ops, b_bytes):.4f}ms "
              f"({'operations' if b_ops >= b_bytes else 'bytes'}){grid}"
              f"{note}", flush=True)
        agg = per_kernel.setdefault(kname, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "cases": []})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p),
                       ("bound_ms", max(b_ops, b_bytes)),
                       ("ops_ms", b_ops), ("bytes_ms", b_bytes)):
            agg[key] += v
        if t_l is None:
            agg["library_na"] = True
        else:
            agg["library_ms"] += t_l
        agg["cases"].append({"case": case, "ms": t_k, "plain_ms": t_p,
                             "library_ms": t_l, "max_abs_err": err,
                             "tol_ratio": ratio,
                             "bound_ms": max(b_ops, b_bytes),
                             "bound_by": "operations" if b_ops >= b_bytes
                             else "bytes", **extra})


# --------------------------------------------------------------------------
# phase 3: the main path through the user's entry points
# --------------------------------------------------------------------------

def fusion_off_forward(torch, acc_off, xb) -> dict:
    """Device and host issue ms of one forward of the fusion_off design
    (its 57 #5 launches among 125; ``device_ms``, median of 9: the
    host's issue spreads widely from one reading to the next)."""
    dev, issue = device_ms(torch, lambda: acc_off.forward(xb), reps=9)
    print(f"[fusion_off] forward (batch {BATCH}): device {dev:.3f} ms, "
          f"host issue {issue:.3f} ms", flush=True)
    return {"device_ms": dev, "issue_ms": issue}


def v3t_forward(torch, acc_t, xb_t, counters) -> dict:
    """One yolov3-tiny float forward at 416, batch 8 (6 maxpool launches):
    device and host issue ms (``device_ms``, median of 5), back to back
    (``cuda_ms``), and a ``torch.profiler`` split of one forward
    (``profile_call``): the maxpool kernels (names holding "pool"), the
    conv kernels ("conv2d"), and the rest."""
    for c in counters.values():
        c.reset()
    acc_t.forward(xb_t)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items() if c.value}
    if launches.get("maxpool2d") != len(V3T_POOLS):
        raise AssertionError(f"yolov3-tiny forward launches {launches}")
    dev, issue = device_ms(torch, lambda: acc_t.forward(xb_t), reps=5)
    b2b = cuda_ms(torch, lambda: acc_t.forward(xb_t), budget_ms=300)
    prof = profile_call(torch, lambda: acc_t.forward(xb_t))
    by = prof.pop("by_name", {})
    split = {}
    for key, match in (("pool", "pool"), ("conv", "conv2d")):
        hit = [v for k, v in by.items() if match in k]
        split[f"{key}_ms"] = sum(v[0] for v in hit)
        split[f"{key}_kernels"] = sum(v[1] for v in hit)
    busy = prof["busy"]
    split["rest_ms"] = None if busy is None \
        else busy - split["pool_ms"] - split["conv_ms"]
    print(f"[v3t_forward] yolov3-tiny@416 batch {BATCH}: launches "
          f"{launches}; device {dev:.4f} ms, host issue {issue:.4f} ms, "
          f"back to back {b2b:.4f} ms; profiler: "
          + (f"kernels busy {busy:.4f} ms in {prof['kernels']} launches: "
             f"maxpool {split['pool_ms']:.4f} ms ({split['pool_kernels']}),"
             f" conv {split['conv_ms']:.4f} ({split['conv_kernels']}), the "
             f"rest {split['rest_ms']:.4f}; top {prof['top']}"
             if busy is not None else "no kernel records"), flush=True)
    return {"launches": launches, "device_ms": dev, "issue_ms": issue,
            "back_to_back_ms": b2b, "profile": prof, **split}


def float_forward(torch, acc, xb, acc_off, xb_off) -> dict:
    """The float design's forward at 640 (``main``'s) and fusion_off's
    at 160, batch 8: device and host issue ms (``device_ms``, median of 5
    and of 9), back to back (``cuda_ms``: the host's issue and the
    device overlapped, as a serving replica runs it), and a
    ``torch.profiler`` split of one forward (``profile_call``, whose
    ``wall`` is one forward issued on an idle card to the end of its
    synchronise): the conv kernels (#1 and its split pass: names holding
    "conv2d"), ``torch.cat`` (the channel windows of ``kernels/ops.py``:
    "CatArray"), and the rest."""
    out = {}
    for label, a, x, reps in (("main_640", acc, xb, 5),
                              ("fusion_off_160", acc_off, xb_off, 9)):
        dev, issue = device_ms(torch, lambda: a.forward(x), reps=reps)
        b2b = cuda_ms(torch, lambda: a.forward(x), budget_ms=300)
        prof = profile_call(torch, lambda: a.forward(x))
        by = prof.pop("by_name", {})
        conv = [v for k, v in by.items() if "conv2d" in k]
        cat = [v for k, v in by.items() if "CatArray" in k]
        busy = prof["busy"]
        split = {"conv_ms": sum(v[0] for v in conv),
                 "conv_kernels": sum(v[1] for v in conv),
                 "cat_ms": sum(v[0] for v in cat),
                 "cat_kernels": sum(v[1] for v in cat)}
        split["rest_ms"] = None if busy is None \
            else busy - split["conv_ms"] - split["cat_ms"]
        out[label] = {"device_ms": dev, "issue_ms": issue,
                      "back_to_back_ms": b2b, "profile": prof, **split}
        print(f"[float_forward] {label}: device {dev:.3f} ms, host issue "
              f"{issue:.3f} ms, back to back {b2b:.3f} ms, one on an idle "
              f"card {prof['wall']:.3f} ms; profiler: "
              + (f"kernels busy {busy:.3f} ms in {prof['kernels']} "
                 f"launches: conv {split['conv_ms']:.3f} ms "
                 f"({split['conv_kernels']}), torch.cat "
                 f"{split['cat_ms']:.3f} ({split['cat_kernels']}), the rest "
                 f"{split['rest_ms']:.3f}; top {prof['top']}"
                 if busy is not None else "no kernel records"), flush=True)
    return out


# The rules the split-K ablation (``conv_split_rules``) compares, each a
# cap on #1's and #2's chunks of K·K·C for (M, K·K·C, F), None for none.
CONV_SPLIT_RULES = {
    "as planned": lambda M, KKC, F: None,
    "chunks of >= 4 slices": lambda M, KKC, F: max(1, KKC // 128),
    "scratch <= windows/4 (#8's)": lambda M, KKC, F: max(1, KKC // (4 * F)),
    "no split": lambda M, KKC, F: 1,
}


def conv_split_rules(torch, K, acc, xb, acc_off, xb_off) -> dict | None:
    """The float forward at 640 and at 160 (device ms, median of 5, and
    back to back) with #1's split of K·K·C capped by each rule of
    CONV_SPLIT_RULES (``conv2d._plan``'s ``cap``, set for the length of
    the reading), and its split convs and chunks a forward; None in a
    checkout without that planner."""
    orig = getattr(K.conv2d, "_plan", None)
    if orig is None:
        return None
    out = {}
    try:
        for rule, cap in CONV_SPLIT_RULES.items():
            K.conv2d._plan = (lambda M, KKC, F, sms, cap=cap:
                              orig(M, KKC, F, sms, cap(M, KKC, F)))
            row = {}
            for label, a, x in (("main_640", acc, xb),
                                ("fusion_off_160", acc_off, xb_off)):
                dev, issue = device_ms(torch, lambda: a.forward(x), reps=5)
                row[label] = {"device_ms": dev, "issue_ms": issue,
                              "back_to_back_ms": cuda_ms(
                                  torch, lambda: a.forward(x),
                                  budget_ms=300)}
            out[rule] = row
            print(f"[split_rules] {rule}: " + "; ".join(
                f"{lab} device {r['device_ms']:.3f} ms, issue "
                f"{r['issue_ms']:.3f}, back to back "
                f"{r['back_to_back_ms']:.3f}" for lab, r in row.items()),
                flush=True)
    finally:
        K.conv2d._plan = orig
    return out


def conv_issue_split(torch, K, build, dev, n: int = 200) -> dict | None:
    """Host issue per call, µs, of one #1 call at ``3x3s1_20`` (the split
    case: 8×20×20×256 → 64, K·K·C 2304) and of its parts (``n`` calls a
    reading, behind ``device_ms``'s spin), the C entry point with its
    split pass and with one chunk; None in a checkout without the
    planner."""
    plan = tile_plan(K.conv2d, "_plan", dev, BATCH * 400, 2304, 64)
    if plan is None:
        return None
    x = torch.randn(BATCH, 20, 20, 256, device=dev)
    w = torch.randn(3, 3, 256, 64, device=dev) * 2304 ** -0.5
    b = torch.zeros(64, device=dev)
    y = torch.empty(BATCH, 20, 20, 64, device=dev)
    M, splits = BATCH * 400, plan["splits"]
    ws = torch.empty(splits * M * 64, device=dev)
    fn, sm = "repro_conv2d_nhwc_f32", build.sm_count(dev)
    head = (x.data_ptr(), w.data_ptr(), b.data_ptr(), None, y.data_ptr(),
            BATCH, 20, 20, 256, 3, 64, 1, 20, 20, 1, 1,
            build.act_code("hardswish"), plan["BM"], plan["BN"])
    parts = {
        "wrapper conv2d(x, w, b, act='hardswish')": lambda: K.conv2d.conv2d(
            x, w, b, act="hardswish"),
        "  check_operand x3": lambda: (
            build.check_operand("x", x, dev),
            build.check_operand("w", w, dev, (3, 3, 256, 64)),
            build.check_operand("b", b, dev, (64,))),
        "  same_pads x2": lambda: (K.ref.same_pads(20, 3, 1),
                                   K.ref.same_pads(20, 3, 1)),
        "  torch.empty y": lambda: torch.empty(
            (BATCH, 20, 20, 64), device=dev, dtype=torch.float32),
        "  _plan with sm_count": lambda: K.conv2d._plan(
            M, 2304, 64, build.sm_count(dev)),
        "  the stream's scratch slot": lambda: build.scratch_slot(
            dev, torch._C._cuda_getCurrentRawStream(dev.index)),
        f"  torch.empty of the scratch ({splits} chunks; the slot's "
        f"earlier form)": lambda: torch.empty(
            splits * M * 64, device=dev, dtype=torch.float32),
        "  launch: tile + split pass": lambda: build.launch(
            fn, dev, *head, splits, ws.data_ptr()),
        "  launch: tile, one chunk": lambda: build.launch(
            fn, dev, *head, 1, None),
        "  LaunchCounter.add": K.conv2d.launches.add,
        "an empty call (the reading's own cost)": lambda: None,
    }
    out = {}
    for name, part in parts.items():
        out[name] = per_call_ms(torch, part, n)[1] * 1e3
    torch.cuda.synchronize()
    print(f"[conv_issue] host issue per call, us (n = {n} calls behind a "
          f"spin, median of 3; sm {sm}): " + "; ".join(
              f"{k.strip()} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def calib_drift(torch, core, codegen, yolo, ImageStream, place, dev) -> dict:
    """``quant_per_group``'s activation scales (yolov8n at 160, W8A8,
    weights seed 1, per group of 16 on ``ImageStream(160, 8, seed=9)``)
    calibrated through the kernels (``backend="auto"``, the port's
    default: its float forward runs #1) and through the plain versions
    (what the path serves, ``plain_scales``): the largest and the mean
    relative difference of a scale, and the share of scales that
    differ."""
    model = yolo.build("yolov8n", 160)
    params = random_params(torch, codegen, model.graph, 1)
    acc = core.compile(model, core.CompileConfig(
        backend="quant", w_bits=8, a_bits=8, batch_size=BATCH),
        params=params)
    calib = torch.from_numpy(ImageStream(160, BATCH, seed=9).batch_at(0)
                             ).to(dev)
    got = {}
    for backend in ("auto", "ref"):
        got[backend] = codegen.calibrate_activation_scales(
            acc.graph, place(params, dev), calib, backend=backend,
            granularity="per_group", group_size=16)
    rel = [abs(a / b - 1.0) for name in got["ref"]
           for a, b in zip(got["auto"][name], got["ref"][name])]
    out = {"scales": len(rel), "max_rel": max(rel),
           "mean_rel": sum(rel) / len(rel),
           "differ": sum(r > 0 for r in rel) / len(rel)}
    print(f"[calib_drift] quant_per_group's {out['scales']} activation "
          f"scales through the kernels vs the plain versions: max relative "
          f"difference {out['max_rel']:.3e}, mean {out['mean_rel']:.3e}, "
          f"{out['differ']:.3f} of them differ", flush=True)
    return out


def serve(Deployment, DetectRequest, ImageStream, acc, n_req, img, seed,
          backend=None, **deploy):
    images = list(ImageStream(img, BATCH, seed=seed).frames(n_req))
    t0 = time.perf_counter()
    with Deployment(acc, backend=backend, **deploy) as dep:
        for i, im in enumerate(images):
            if not dep.submit(DetectRequest(uid=i, image=im)):
                raise AssertionError(f"request {i} rejected")
        done = dep.run()
        stats = dep.stats()             # counters + latency/busy snapshot
    wall = time.perf_counter() - t0
    return images, done, stats, wall


def random_params(torch, codegen, graph, seed: int) -> dict:
    params = codegen.init_params(graph, torch.Generator().manual_seed(seed))
    for p in params.values():
        p["w"] *= WEIGHT_GAIN
    return params


def check_outputs(torch, np, acc, images, done, shapes, ref_backend="ref"
                  ) -> tuple:
    """Every request done, outputs finite with the expected shapes, and
    within MAIN_TOL of the same graph on the plain versions (card)."""
    if len(done) != len(images) or not all(r.done for r in done):
        raise AssertionError(f"{sum(r.done for r in done)}/{len(images)} "
                             f"requests done")
    worst = scale = 0.0
    for i in range(0, len(images), BATCH):
        xb = torch.from_numpy(np.stack(images[i:i + BATCH])).to(
            acc.torch_device)
        want = [o.cpu() for o in acc.forward(xb, backend=ref_backend)]
        for j, req in enumerate(done[i:i + BATCH]):
            if req.uid != i + j:
                raise AssertionError(f"request {req.uid} out of order")
            got_shapes = [tuple(o.shape) for o in req.outputs]
            if got_shapes != shapes:
                raise AssertionError(f"output shapes {got_shapes} != "
                                     f"{shapes}")
            for o, w in zip(req.outputs, want):
                g = torch.from_numpy(o)
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError("non-finite output")
                worst = max(worst, float((g - w[j]).abs().max()))
                scale = max(scale, float(w[j].abs().max()))
                if not torch.allclose(g, w[j], atol=MAIN_TOL,
                                      rtol=MAIN_TOL):
                    raise AssertionError(
                        f"request {req.uid}: max_abs_err "
                        f"{float((g - w[j]).abs().max())} vs ref")
    return worst, scale


class LayerCompare:
    """A lowering table that runs every conv twice on the SAME input —
    through ``kern`` (the kernels) and ``plain`` (the plain versions) —
    records the worst disagreement, and passes the plain result on, so
    that a difference in one layer never reaches the next. Used where
    activations are quantized: an 8-bit code that rounds the other way
    in one layer (its float input differing in the last bit) would
    otherwise be amplified by the random weights of later layers. Path
    ``double`` uses it with the double-buffered kernels as ``kern`` and
    the grid kernels as ``plain``: within ``tol`` (atol = rtol), or with
    ``ulp`` within one unit in the last place; ``equal`` counts the
    convs that agree bit for bit."""
    name = "layer_compare"

    def __init__(self, kern, plain, tol: float | None = None,
                 ulp: bool = False):
        self.kern, self.plain = kern, plain
        self.tol = KERNEL_TOL["qmatmul"] if tol is None else tol
        self.ulp = ulp
        self.worst, self.convs, self.equal = 0.0, 0, 0

    def fuses_pool(self, node):
        return self.plain.fuses_pool(node)

    def conv(self, x, p, node, res=None, **kw):
        want = self.plain.conv(x, p, node, res, **kw)
        got = self.kern.conv(x, p, node, res, **kw)
        d = (got - want).abs()
        err = float(d.max())
        if self.ulp:
            a = want.abs()
            bad = bool((d > a.nextafter(a.new_full(a.shape, float("inf")))
                        - a).any())
        else:
            bad = float((d - self.tol * want.abs()).max()) > self.tol
        self.worst = max(self.worst, err)
        self.convs += 1
        self.equal += int(err == 0.0)
        if bad:
            raise AssertionError(f"{node.name}: {self.kern.name} path "
                                 f"disagrees with the {self.plain.name} path "
                                 f"on the same input: max_abs_err {err}")
        return want

    def __getattr__(self, item):
        return getattr(self.plain, item)


class NudgedOutputs:
    """The plain lowering table with every conv output moved one unit in
    the last place toward ``to`` (+inf or -inf): the plain path's own
    end-to-end spread when each conv differs from it in the last bit,
    as the grouped kernel does."""
    name = "nudged"

    def __init__(self, torch, plain, to: float):
        self.torch, self.plain, self.to = torch, plain, to

    def fuses_pool(self, node):
        return self.plain.fuses_pool(node)

    def conv(self, x, p, node, res=None, **kw):
        y = self.plain.conv(x, p, node, res, **kw)
        return self.torch.nextafter(y, self.torch.full_like(y, self.to))

    def __getattr__(self, item):
        return getattr(self.plain, item)


class KernelPathCompare:
    """The reverse of ``LayerCompare``: the kernel path end to end, every
    conv also run by its plain version on the kernel path's own input.

    The executor is handed the batch twice over (2N rows). At each conv
    the first N rows of its input are the kernel path's: ``kern`` and
    ``plain`` both run on them (within KERNEL_TOL, as ``LayerCompare``), and
    the conv passes on the kernel output as its first N rows and the
    plain output as its last N. The pools, resizes, concats and splits
    between convs move both halves alike, so at an A≤8 conv the last N
    rows are what its producers' plain versions gave on the kernel
    path's input. Both halves quantized at the conv's own ``a_scale``
    (its input, ``ref.quantize_activation``) count the activation codes
    that round the other way; each must be one apart. ``flips`` maps an
    A≤8 conv to (codes that differ, codes)."""
    name = "kernel_path_compare"

    def __init__(self, torch, kern, plain, n: int):
        from repro_torch.kernels import ops, ref
        self.torch, self.ops, self.ref = torch, ops, ref
        self.kern, self.plain, self.n = kern, plain, n
        self.tol = KERNEL_TOL["qmatmul"]
        self.worst, self.convs, self.flips = 0.0, 0, {}

    def fuses_pool(self, node):
        return self.kern.fuses_pool(node)

    def _halves(self, x):
        d = self.ops.channel_concat(x) if isinstance(x, (list, tuple)) \
            else x
        return d[:self.n], d[self.n:]

    def conv(self, x, p, node, res=None, **kw):
        torch = self.torch
        xk, xp = self._halves(x)
        rk = None if res is None else self._halves(res)[0]
        got = self.kern.conv(xk, p, node, rk, **kw)
        want = self.plain.conv(xk, p, node, rk, **kw)
        err = float((got - want).abs().max())
        self.worst = max(self.worst, err)
        self.convs += 1
        if float(((got - want).abs() - self.tol * want.abs()).max()) \
                > self.tol:
            raise AssertionError(f"{node.name}: {self.kern.name} path and "
                                 f"its plain version on the kernel path's "
                                 f"input: max_abs_err {err}")
        s = node.attrs.get("a_scale")
        bits = int(node.attrs.get("a_bits", 16))
        if bits <= 8 and s is not None:
            qs = s if isinstance(s, float) else torch.tensor(
                s, dtype=torch.float32, device=xk.device)
            d = (self.ref.quantize_activation(xk, qs, bits=bits).int()
                 - self.ref.quantize_activation(xp, qs, bits=bits).int()
                 ).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"{node.name}: an activation code "
                                     f"{int(d.max())} apart")
            self.flips[node.name] = (int((d != 0).sum()), d.numel())
        return torch.cat([got, want])

    def __getattr__(self, item):
        return getattr(self.kern, item)


def reverse_layer_check(torch, np, acc, kern, plain, images, served,
                        label: str) -> dict:
    """``KernelPathCompare`` over the batch ``images``: every conv within
    KERNEL_TOL of its plain version on the kernel path's own input,
    every activation code that rounds the other way one apart, and the
    first half's outputs bit-equal to ``served``, the kernel path's
    outputs on that batch (the served ones on the served batch). Prints
    the codes by consuming conv."""
    n = len(images)
    xb = torch.from_numpy(np.stack(images)).to(acc.torch_device)
    cmp = KernelPathCompare(torch, kern, plain, n)
    outs = acc.forward(torch.cat([xb, xb]), backend=cmp)
    if cmp.convs != 63:
        raise AssertionError(f"{label}: reverse layer check ran "
                             f"{cmp.convs} convs")
    if not all(torch.equal(o[:n].cpu(), s) for o, s in zip(outs, served)):
        raise AssertionError(f"{label}: the reverse layer check's kernel "
                             f"half is not the kernel path's outputs")
    flipped = sum(f for f, _ in cmp.flips.values())
    codes = sum(c for _, c in cmp.flips.values())
    out = {"convs": cmp.convs, "max_abs_err": cmp.worst,
           "a8_convs": len(cmp.flips), "codes": codes, "flipped": flipped,
           "flips_by_conv": {k: f for k, (f, _) in cmp.flips.items()}}
    print(f"[{label}] reverse layer check, the kernel path with each "
          f"conv also run plain on its own input: {cmp.convs} convs within "
          f"{cmp.tol} (max_abs_err {cmp.worst:.3e}); activation codes at "
          f"the consuming conv's a_scale that round the other way: "
          f"{flipped} of {codes} at {len(cmp.flips)} A8 convs, each one "
          f"apart; by conv: " + (", ".join(
              f"{k} {f}" for k, f in out["flips_by_conv"].items() if f)
              or "none"), flush=True)
    return out


def scale_digest(np, graph, assignment=None) -> dict:
    """sha256 over every conv's activation scale (``a_scale``, float32
    bytes, after the node's name) in topological order, and over a mixed
    design's wordlength assignment (sorted JSON): a later run's log can
    be compared with this one's."""
    h = hashlib.sha256()
    n = 0
    for node in graph.topo_order():
        s = node.attrs.get("a_scale")
        if node.op == "conv" and s is not None:
            h.update(node.name.encode())
            h.update(np.asarray(s, dtype=np.float32).tobytes())
            n += 1
    out = {"scaled_convs": n, "scales_sha256": h.hexdigest()}
    if assignment is not None:
        out["assignment_sha256"] = hashlib.sha256(json.dumps(
            assignment, sort_keys=True).encode()).hexdigest()
    return out


def plain_scales(codegen, graph, params, calib, **kw) -> dict:
    """``graph``'s activation scales calibrated on the plain versions
    (``backend="ref"``, the JAX package's default), every A≤8 conv's
    overwritten: no kernel takes part in choosing them. The per-group
    recalibration of quant_per_group uses it."""
    written = codegen.calibrate_activation_scales(graph, params, calib,
                                                  backend="ref", **kw)
    a8 = {n.name for n in graph.nodes.values()
          if n.op == "conv" and int(n.attrs.get("a_bits", 16)) <= 8}
    if set(written) != a8:
        raise AssertionError(f"plain calibration wrote {len(written)} of "
                             f"{len(a8)} A8 convs' scales")
    return written


@contextlib.contextmanager
def nudged_conv_kernel(torch, K):
    """For the length of the block, #1's outputs moved one unit in the
    last place toward +inf: ``kernels.conv2d.conv2d``, the entry point
    of every float conv on the kernel route, wrapped (its attributes,
    the launch counters, kept). Only ``a8_scale_proof`` uses it."""
    fn = K.conv2d.conv2d

    @functools.wraps(fn)
    def nudged(*args, **kw):
        y = fn(*args, **kw)
        return torch.nextafter(y, torch.full_like(y, float("inf")))
    K.conv2d.conv2d = nudged
    try:
        yield
    finally:
        K.conv2d.conv2d = fn


def a8_failure(failed: list, msg: str) -> None:
    """A reading that breaks the A8 rule, kept in ``failed`` and printed:
    the run reads every A8 design and path, then fails at its end
    (``main``'s ``a8_verdict``)."""
    failed.append(msg)
    print(f"[a8] FAILED: {msg}", flush=True)


@contextlib.contextmanager
def plain_compile(codegen, dse, table):
    """For the length of the block, ``compile`` makes an A8 design with no
    kernel taking part: ``codegen.calibrate_activation_scales`` measures
    its ranges on ``"ref"`` (the JAX package's default), and
    ``dse.mixed_precision_search`` runs its trials on the lowering table
    ``table`` (``QuantBackend(dispatch="ref")``; its float reference and
    ranges on that dispatch), whatever their callers pass. The design,
    its report and its accuracy probe are then ``compile``'s own, on
    scales from the plain versions. ``compile_w4a8`` and
    ``compile_mixed`` use it."""
    calibrate, search = (codegen.calibrate_activation_scales,
                         dse.mixed_precision_search)

    @functools.wraps(calibrate)
    def plain_calibrate(*args, **kw):
        return calibrate(*args, **{**kw, "backend": "ref"})

    @functools.wraps(search)
    def plain_search(*args, **kw):
        return search(*args, **{**kw, "backend": table})
    codegen.calibrate_activation_scales = plain_calibrate
    dse.mixed_precision_search = plain_search
    try:
        yield
    finally:
        codegen.calibrate_activation_scales = calibrate
        dse.mixed_precision_search = search


def a8_path_check(torch, np, ImageStream, acc, kern, plain, done, images,
                  shapes, img: int, seeds: tuple, label: str,
                  failed: list) -> dict:
    """The output check of a path whose design quantizes activations to
    8 bits, where a code that rounds the other way in one layer (its
    float input differing in the last bit) is amplified by the random
    weights of later layers, so that one end-to-end tolerance is
    ill-conditioned:

    * the served requests are done, in order, with the expected shapes;
    * every conv is within KERNEL_TOL of its plain version on the plain
      path's own input (``LayerCompare``, on the served batch), and on
      the kernel path's own input (``reverse_layer_check`` on each
      seed's batch, the served kernel path on the first: the activation
      codes that round the other way counted by consuming conv, each one
      apart);
    * on each of ``seeds``' batches (the first the served one) the
      kernel path's outputs are finite, and within A8_TOL·max|out| of
      the plain path or, failing that, within A8_SPREAD times the plain
      path's own spread when every conv output moves by one ulp
      (``NudgedOutputs``, up and down; max and mean |difference|, the
      spread taken over all the batches). Each reading's margin is
      printed: kernel_max / (A8_SPREAD·spread_max) and kernel_mean /
      (A8_SPREAD·spread_mean), at most 1 where the spread rule holds.
      A reading within neither bound fails: it is kept in ``failed``
      (``a8_failure``).

    The design's activation scales come from the plain versions
    (``plain_scales``), so the plain path and the rule's spread do not
    move with the kernels' last bits."""
    if len(done) != len(images) or not all(r.done for r in done):
        raise AssertionError(f"{label}: {sum(r.done for r in done)}/"
                             f"{len(images)} requests done")
    for j, req in enumerate(done):
        if req.uid != j or [tuple(o.shape) for o in req.outputs] != shapes:
            raise AssertionError(f"{label}: request {req.uid}")
    served = [torch.from_numpy(np.stack([r.outputs[i] for r in done]))
              for i in range(len(shapes))]
    cmp = LayerCompare(kern, plain)
    acc.forward(torch.from_numpy(np.stack(images)).to(acc.torch_device),
                backend=cmp)
    if cmp.convs != 63:
        raise AssertionError(f"{label}: layer check ran {cmp.convs} convs")
    readings, reverse = [], []
    for i, seed in enumerate(seeds):
        batch = images if i == 0 else list(
            ImageStream(img, BATCH, seed=seed).frames(BATCH))
        xb = torch.from_numpy(np.stack(batch)).to(acc.torch_device)
        want = [o.cpu() for o in acc.forward(xb, backend=plain)]
        got = served if i == 0 else [o.cpu() for o in acc.forward(xb)]
        reverse.append(reverse_layer_check(torch, np, acc, kern, plain,
                                           batch, got,
                                           f"{label}] [seed {seed}"))
        for o in got:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{label}: non-finite output")
        spread = [[o.cpu() for o in acc.forward(
            xb, backend=NudgedOutputs(torch, plain, to))]
            for to in (float("inf"), float("-inf"))]

        def diff(outs):
            d = [(o - w).abs() for o, w in zip(outs, want)]
            return (max(float(t.max()) for t in d),
                    float(torch.cat([t.reshape(-1) for t in d]).mean()))
        k_max, k_mean = diff(got)
        w = [diff(o) for o in spread]
        readings.append({"seed": seed, "kernel_max": k_max,
                         "kernel_mean": k_mean,
                         "codes_flipped": reverse[-1]["flipped"],
                         "spread_max": max(a for a, _ in w),
                         "spread_mean": max(b for _, b in w),
                         "max_out": max(float(t.abs().max())
                                        for t in want)})
    s_max = max(r["spread_max"] for r in readings)
    s_mean = max(r["spread_mean"] for r in readings)
    for r in readings:
        r["within_tol"] = r["kernel_max"] <= A8_TOL * r["max_out"]
        r["within_spread"] = (r["kernel_max"] <= A8_SPREAD * s_max
                              and r["kernel_mean"] <= A8_SPREAD * s_mean)
        r["margin_max"] = r["kernel_max"] / (A8_SPREAD * s_max)
        r["margin_mean"] = r["kernel_mean"] / (A8_SPREAD * s_mean)
        print(f"[{label}] seed {r['seed']}: kernel path vs plain max "
              f"{r['kernel_max']:.4e} mean {r['kernel_mean']:.4e}; plain "
              f"nudged one ulp vs plain max {r['spread_max']:.4e} mean "
              f"{r['spread_mean']:.4e}; max |output| {r['max_out']:.4e}; "
              f"within {A8_TOL:.4f}·max|out|: {r['within_tol']}, within "
              f"{A8_SPREAD}x the spread: {r['within_spread']}; margin max "
              f"{r['margin_max']:.4f} mean {r['margin_mean']:.4f}",
              flush=True)
        if not (r["within_tol"] or r["within_spread"]):
            a8_failure(failed, f"{label}: seed {r['seed']}: the kernel "
                               f"path is further from the plain path than "
                               f"either bound (margin max "
                               f"{r['margin_max']:.4f} mean "
                               f"{r['margin_mean']:.4f})")
    return {"layer_max_abs_err": cmp.worst, "reverse": reverse,
            "readings": readings,
            "max_abs_err": max(r["kernel_max"] for r in readings)}


class DoubleBuffered:
    """The lowering table of path ``double``: ``base``'s own lowering
    (``KernelBackend`` or ``QuantBackend``, the code the executors run),
    with the two kernel entry points its convs reach,
    ``kernels.conv2d.conv2d`` and ``kernels.qmatmul.qmatmul_a8``, called
    with ``pipeline="double"`` for the length of each conv. A float conv
    then launches #2 (its fused pool the maxpool kernel, as
    ``ops.conv2d(pool=)`` does) and an A8 conv #10 (through
    ``ops.qconv2d_a8``); the launch counts show that every conv did.
    The entry points are module attributes, so one conv at a time holds
    them (``_DOUBLE_LOCK``): a deployment's replicas issue from threads
    of their own."""
    name = "double"

    def __init__(self, K, base):
        self.base = base
        self.entries = ((K.conv2d, "conv2d"), (K.qmatmul, "qmatmul_a8"))

    def conv(self, *args, **kw):
        with _DOUBLE_LOCK:
            saved = [getattr(m, f) for m, f in self.entries]
            for (m, f), fn in zip(self.entries, saved):
                setattr(m, f, _with_double(fn))
            try:
                return self.base.conv(*args, **kw)
            finally:
                for (m, f), fn in zip(self.entries, saved):
                    setattr(m, f, fn)

    def __getattr__(self, item):
        return getattr(self.base, item)


_DOUBLE_LOCK = threading.Lock()


def _with_double(fn):
    """``fn`` with its ``pipeline`` argument set to "double" whatever
    the caller passes (its attributes, the launch counters, kept)."""
    @functools.wraps(fn)
    def double(*args, pipeline="grid", **kw):
        return fn(*args, pipeline="double", **kw)
    return double


def double_forward(torch, np, AcceleratorReplica, DetectRequest, counters,
                   acc, table, grid, images, compare) -> tuple:
    """One forward of ``acc``'s design on path ``double``: a replica
    pinned to the lowering table ``table`` (``AcceleratorReplica(acc,
    backend=table)``) serves one batch of ``images``, the launch counters
    set to 0 just before and read just after; then every conv is held
    against ``grid`` on the grid path's own input (``compare``, a
    LayerCompare of the two), and both forwards' device time is read
    (``device_ms``). Returns (launches, the served requests, readings)."""
    batch = [DetectRequest(uid=j, image=im)
             for j, im in enumerate(images[:BATCH])]
    rep = AcceleratorReplica(acc, backend=table)
    for c in counters.values():
        c.reset()
    rep.complete(rep.dispatch(batch))
    counts = {k: c.value for k, c in counters.items()}
    xb = torch.from_numpy(np.stack(images[:BATCH])).to(acc.torch_device)
    acc.forward(xb, backend=compare)
    if compare.convs != 63:
        raise AssertionError(f"double: the layer check ran {compare.convs} "
                             f"convs")
    dev_d, issue_d = device_ms(torch, lambda: acc.forward(xb, backend=table))
    dev_g, issue_g = device_ms(torch, lambda: acc.forward(xb, backend=grid))
    return counts, batch, {
        "conv_max_abs_err_vs_grid": compare.worst,
        "convs_bit_equal_to_grid": compare.equal,
        "forward_device_ms": dev_d, "forward_issue_ms": issue_d,
        "grid_forward_device_ms": dev_g, "grid_forward_issue_ms": issue_g}


def replica_spans(torch, AcceleratorReplica, DetectRequest, QTensor,
                  dequantize, acc, images, steps: int = 8) -> dict:
    """Median spans (ms) of one replica step run alone on the caller's
    thread: ``assemble`` (stack, pin, start the upload), ``issue`` (the
    host launching the forward), ``wait`` (the card finishing after the
    issue returned), ``copy_out`` (outputs to numpy); then the device
    time and host issue time of the forward and of dequantizing every
    weight, each measured with the issue hidden (``device_ms``)."""
    rep = AcceleratorReplica(acc)
    spans: dict = {k: [] for k in ("assemble", "issue", "wait",
                                   "copy_out", "step")}
    for i in range(steps + 1):                  # step 0 warms up
        batch = [DetectRequest(uid=j, image=im)
                 for j, im in enumerate(images[:BATCH])]
        t0 = time.perf_counter()
        prepared = rep.assemble(batch)
        t1 = time.perf_counter()
        handle = rep.execute(prepared)
        t2 = time.perf_counter()
        handle[-1].synchronize()                # the step's CUDA event
        t3 = time.perf_counter()
        rep.complete(handle)
        t4 = time.perf_counter()
        if i:
            for k, a, b in (("assemble", t0, t1), ("issue", t1, t2),
                            ("wait", t2, t3), ("copy_out", t3, t4),
                            ("step", t0, t4)):
                spans[k].append((b - a) * 1e3)
    out = {k: sorted(v)[len(v) // 2] for k, v in spans.items()}
    xb = prepared[-1]
    weights = [p["w"] for p in acc.params.values()
               if isinstance(p["w"], QTensor)]
    out["forward_device"], out["forward_issue"] = device_ms(
        torch, lambda: acc.forward(xb))
    out["dequant_device"], out["dequant_issue"] = device_ms(
        torch, lambda: [dequantize(w) for w in weights])
    out["dequant_tensors"] = len(weights)
    return out


def quant_extra_spans(torch, codegen, ops, quant, acc, float_params) -> dict:
    """Device and issue ms of the W8A16 path's host-built pieces: the
    im2col of every conv that is not 1×1/1 (from a random input of that
    conv's shape), and the on-the-fly W8 quantization that the quant
    backend gives an unannotated conv, for all 63 float weights."""
    gen = torch.Generator(device=acc.torch_device).manual_seed(4)
    ins = []
    for name in codegen.launch_nodes(acc.graph):
        n = acc.graph.nodes[name]
        if n.op == "conv" and (n.geom("K") > 1 or n.geom("stride") > 1):
            Hi = n.geom("W_in")             # square inputs
            ins.append((torch.randn(BATCH, Hi, Hi, n.geom("C"),
                                    generator=gen, device=acc.torch_device),
                        n.geom("K"), n.geom("stride")))
    out = {}
    out["im2col_device"], out["im2col_issue"] = device_ms(
        torch, lambda: [ops._im2col(x, k, s) for x, k, s in ins])
    out["im2col_convs"] = len(ins)
    ws = [p["w"] for p in float_params.values()]
    cfg = quant.QuantConfig(bits=8, granularity="per_channel", axis=-1)
    out["quantize_device"], out["quantize_issue"] = device_ms(
        torch, lambda: [quant.quantize(w, cfg) for w in ws])
    return out


# --------------------------------------------------------------------------
# the lm path: granite-3-8b served by Engine, checked by teacher forcing
# --------------------------------------------------------------------------

def lm_prompts(np, vocab: int, lens=None, n: int = LM_REQ) -> list:
    """Prompts from seed 0 of the lengths ``lens``, or of ``n`` lengths
    uniform in LM_PROMPT."""
    rng = np.random.default_rng(0)
    if lens is None:
        lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, size=n)
    return [[int(t) for t in rng.integers(0, vocab, size=int(n))]
            for n in lens]


def serve_lm(torch, np, Engine, Request, cfg, params, dev, prompts,
             n_new: int = LM_NEW, on_prefill=None, on_decode=None):
    """Serve ``prompts`` through ``Engine`` (greedy, ``n_new`` tokens
    each). The replica's sampler records the logits it samples from (the
    served logits), and its prefill is timed on the host clock between
    two synchronisations (its sampling synchronises right after anyway).
    ``on_prefill(tokens)`` and ``on_decode(replica)`` are called just
    before each prefill and decode step. Returns (finished requests, wall
    s, {uid: [logits per token]}, [(prompt length, prefill ms)], decode
    steps, [host ms to issue each decode step], the replica)."""
    eng = Engine(cfg, params, max_batch=LM_BATCH, cache_size=LM_CACHE,
                 seed=0, device=dev)
    rep = eng._replica
    served: dict = {}
    prefill_ms: list = []
    sample, prefill = rep._sample, rep._prefill1

    def record(logits, req):
        row = logits.detach().float().cpu().numpy() \
            if isinstance(logits, torch.Tensor) \
            else np.array(logits, np.float32)
        served.setdefault(req.uid, []).append(row)
        return sample(logits, req)

    def timed_prefill(p, batch):
        if on_prefill is not None:
            on_prefill(batch["tokens"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(p, batch)
        torch.cuda.synchronize()
        prefill_ms.append((int(batch["tokens"].shape[1]),
                           (time.perf_counter() - t0) * 1e3))
        return out

    decode, decode_issue = rep._decode, []

    def timed_decode(p, tokens, cache):
        if on_decode is not None:
            on_decode(rep)
        t0 = time.perf_counter()
        out = decode(p, tokens, cache)
        decode_issue.append((time.perf_counter() - t0) * 1e3)
        return out

    rep._sample, rep._prefill1 = record, timed_prefill
    rep._decode = timed_decode
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=n_new))
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rep.stats["batches"]
    eng.close()
    # the wrappers close over the replica's own bound methods: drop them
    # so that the replica, and its weights, go when its last name does
    del rep._sample, rep._prefill1, rep._decode
    return done, wall, served, prefill_ms, steps, decode_issue, rep


def hold_logits(torch, tag: str, want_rows: list, got_rows: list,
                tokens: list, out: dict) -> None:
    """One request's served logits (``got_rows``, numpy, one a token)
    against the plain path's (``want_rows``, tensors) on the same
    tokens: each step's max |difference| and mean relative difference
    (mean |difference| over mean |plain|) go into ``out`` (step 0, the
    prefill, apart), and every served token whose plain top-2 margin
    exceeds twice that step's difference must be the plain argmax."""
    if len(got_rows) != len(want_rows):
        raise AssertionError(f"{tag}: {len(got_rows)} served logits, "
                             f"{len(want_rows)} replayed")
    for t, (want, g) in enumerate(zip(want_rows, got_rows)):
        g = torch.from_numpy(g) if not isinstance(g, torch.Tensor) else g
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} step {t}: non-finite logits")
        diff = (g - want).abs()
        d = float(diff.max())
        rel = float(diff.mean() / (want.abs().mean() + 1e-9))
        out["prefill" if t == 0 else "steps"].append(d)
        if t:
            out["step_rel"].append(rel)
        top2 = torch.topk(want, 2).values
        if float(top2[0] - top2[1]) > 2 * d:
            out["tokens_checked"] += 1
            if tokens[t] != int(want.argmax()):
                raise AssertionError(
                    f"{tag} step {t}: served token {tokens[t]} != plain "
                    f"argmax {int(want.argmax())} (margin "
                    f"{float(top2[0] - top2[1]):.3e}, difference {d:.3e})")
        else:
            out["tokens_within_margin"] += 1


def held_summary(out: dict) -> dict:
    """``hold_logits``' lists as maxima and means."""
    diffs = out["prefill"] + out["steps"]
    return {"max_abs_err": max(diffs),
            "mean_step_err": sum(diffs) / len(diffs),
            "prefill_max_abs_err": max(out["prefill"]),
            "step_max_abs_err": max(out["steps"], default=0.0),
            "step_mean_rel_max": max(out["step_rel"], default=0.0),
            "tokens_checked": out["tokens_checked"],
            "tokens_within_margin": out["tokens_within_margin"]}


def new_held() -> dict:
    return {"prefill": [], "steps": [], "step_rel": [],
            "tokens_checked": 0, "tokens_within_margin": 0}


def replay_plain(torch, np, lm, ops, cfg, params, dev, prompts, done,
                 served, n_new: int = LM_NEW, before=None,
                 after=None) -> dict:
    """Teacher forcing on the plain path: every request's prompt, then
    its served tokens one by one, through ``lm.prefill`` and
    ``lm.decode_step`` with the default backend set to ``"ref"`` (the
    plain versions, on the card), each request's logits held to its
    served ones by ``hold_logits``. ``before(uid)`` runs before a
    request's replay, ``after(uid, cache)`` after it. Returns
    ``held_summary``."""
    out = new_held()
    ops.set_default_backend("ref")
    try:
        for req in sorted(done, key=lambda r: r.uid):
            prompt, toks = prompts[req.uid], req.out_tokens
            if len(toks) != n_new:
                raise AssertionError(f"request {req.uid}: {len(toks)} "
                                     f"tokens, expected {n_new}")
            if before is not None:
                before(req.uid)
            rows = []
            with torch.inference_mode():
                t = torch.tensor([prompt], dtype=torch.int32, device=dev)
                logits, cache = lm.prefill(params, cfg, {"tokens": t},
                                           len(prompt) + n_new)
                rows.append(logits[0].cpu())
                for tok in toks[:-1]:
                    logits, cache = lm.decode_step(
                        params, cfg,
                        torch.tensor([tok], dtype=torch.int32, device=dev),
                        cache)
                    rows.append(logits[0].cpu())
            if after is not None:
                after(req.uid, cache)
            hold_logits(torch, f"{cfg.name} request {req.uid}", rows,
                        served[req.uid], toks, out)
    finally:
        ops.set_default_backend("auto")
    return held_summary(out)


def profile_call(torch, fn, top: int = 6, match: str | None = None,
                 labels: dict | None = None, reps: int = 3) -> dict:
    """``reps`` calls of ``fn`` (after a warm-up call; neither with
    ``reps=0``) on the host clock,
    then one under ``torch.profiler``: ``issue`` (the host's time to
    return from ``fn``, the queue empty at its start, median), ``wall``
    (to the end of a synchronise after it, median), and from the
    profiler's kernel records
    ``busy`` (the kernels' summed time), ``span`` (first kernel start to
    last kernel end), ``kernels`` (launches) and the ``top`` kernel
    names by time, and ``by_name`` (each kernel name's ms and count);
    with ``match``, ``match_ms`` and ``match_kernels``,
    the time and count of the kernels whose name contains it; with
    ``labels`` ({label: (module, function name)}), each such function
    runs under ``torch.profiler.record_function(label)`` in the profiled
    call only, and ``label_ms`` has, for each label, the summed time of
    the kernels inside its ranges on the device's timeline, its ranges
    and those kernels, and ``outside`` each kernel name's ms and count
    outside every label's ranges; the device numbers are None where the
    profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if reps:
        fn()
    issue, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    out = {"issue": sorted(issue)[reps // 2] if reps else None,
           "wall": sorted(wall)[reps // 2] if reps else None, "busy": None,
           "span": None, "kernels": 0, "top": []}
    saved = {}
    for label, (mod, name) in (labels or {}).items():
        def under(*a, _f=getattr(mod, name), _label=label, **kw):
            with record_function(_label):
                return _f(*a, **kw)
        saved[label] = (mod, name, getattr(mod, name))
        setattr(mod, name, under)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, name, f in saved.values():
            setattr(mod, name, f)
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ks = [e for e in gpu if e.name not in (labels or {})]   # not ranges
    if labels:
        out["label_ms"], out["outside"] = {}, {}
        labelled = set()
        for label in labels:
            spans = [(e.time_range.start, e.time_range.end) for e in gpu
                     if e.name == label]
            inside = [k for k in ks if any(
                a <= k.time_range.start and k.time_range.end <= b
                for a, b in spans)]
            labelled.update(id(k) for k in inside)
            out["label_ms"][label] = [
                sum(k.time_range.elapsed_us() for k in inside) / 1e3,
                len(spans), len(inside)]
        for k in ks:
            if id(k) not in labelled:
                ms, n = out["outside"].get(k.name, (0.0, 0))
                out["outside"][k.name] = (
                    ms + k.time_range.elapsed_us() / 1e3, n + 1)
    if ks:
        by_name: dict = {}
        counts: dict = {}
        for e in ks:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            counts[e.name] = counts.get(e.name, 0) + 1
        out["by_name"] = {k: [v, counts[k]] for k, v in by_name.items()}
        out.update(
            busy=sum(by_name.values()), kernels=len(ks),
            span=(max(e.time_range.end for e in ks)
                  - min(e.time_range.start for e in ks)) / 1e3,
            top=sorted(((round(v, 3), k[:60]) for k, v in by_name.items()),
                       reverse=True)[:top])
        if match is not None:
            hit = [e for e in ks if match in e.name]
            out.update(match_ms=sum(e.time_range.elapsed_us()
                                    for e in hit) / 1e3,
                       match_kernels=len(hit))
    return out


def lm_spans(torch, lm, cfg, params, dev, prefills=(512, 2048),
             labels: dict | None = None) -> dict:
    """``profile_call`` of one prefill at each length of ``prefills`` and
    of one decode step of LM_BATCH rows over a LM_CACHE cache at lengths
    128, 700, 2048 and 4000 (``labels`` passed on)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    out: dict = {}
    with torch.inference_mode():
        for T in prefills:
            toks = torch.randint(0, cfg.vocab, (1, T), generator=gen,
                                 device=dev, dtype=torch.int32)
            out[f"prefill_{T}"] = profile_call(torch, lambda: lm.prefill(
                params, cfg, {"tokens": toks}, T + LM_NEW), labels=labels)
        cache = lm.init_cache(cfg, LM_BATCH, LM_CACHE, device=dev)
        cache["len"] = torch.tensor([128, 700, 2048, 4000][:LM_BATCH],
                                    dtype=torch.int32, device=dev)
        tokens = torch.arange(1, LM_BATCH + 1, dtype=torch.int32,
                              device=dev)
        out["decode_step"] = profile_call(
            torch, lambda: lm.decode_step(params, cfg, tokens, cache),
            labels=labels)
    del cache
    return out


def lm_launches(cfg, prefills: int, steps: int) -> dict:
    """The LM kernels' launches of ``prefills`` prefills and ``steps``
    decode steps. Attention families: per layer 2 rmsnorm (4 more with
    post_norm, 2 more, qnorm and knorm, with qk_norm) and one mha
    (prefill) or decode_attention (step; none with kv_bits=8, whose step
    attends through plain tensor code); encdec adds per decoder layer
    ``ln_x`` and a cross-attention mha (prefill, with qk_norm its two
    norms) or decode_attention (step), and per prefill the encoder: per
    layer 2 rmsnorm (and qk_norm's 2) and one mha, then ``enc_norm``.
    SSM: per layer 2 rmsnorm (``ln``, the mixer's norm) and, in a
    prefill, one ssd_scan; per shared-block call of a hybrid, 2 rmsnorm
    and one mha or decode_attention. One more rmsnorm for the final
    norm."""
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        qk = 2 if cfg.qk_norm else 0
        per = 2 + (4 if cfg.post_norm else 0) + qk
        pre_norms = step_norms = per * L + 1
        mha, dec = L, (0 if cfg.kv_bits == 8 else L)
        if cfg.is_encdec:
            E = cfg.n_enc_layers
            pre_norms += L * (1 + qk) + E * (2 + qk) + 1
            step_norms += L
            mha += L + E
            dec += L
        return {"rmsnorm": pre_norms * prefills + step_norms * steps,
                "mha": mha * prefills, "decode_attention": dec * steps,
                "ssd_scan": 0}
    attn = -(-L // cfg.shared_attn_every) if cfg.family == "hybrid" else 0
    norms = 2 * (L + attn) + 1
    return {"rmsnorm": norms * (prefills + steps), "mha": attn * prefills,
            "decode_attention": attn * steps, "ssd_scan": L * prefills}


def _nonzero(d: dict) -> str:
    return " + ".join(f"{v} {k}" for k, v in d.items() if v) or "none"


def describe(cfg) -> str:
    """An LM config's widths, for a path's first line."""
    if cfg.family in ("ssm", "hybrid"):
        sc = cfg.ssm
        out = (f"SSD d_inner {sc.d_inner}, {sc.n_heads} heads of "
               f"{sc.head_dim}, N {sc.d_state}, G {sc.n_groups}, chunk "
               f"{sc.chunk}")
        if cfg.family == "hybrid":
            out += (f"; a shared block of {cfg.n_heads}/{cfg.n_kv_heads} "
                    f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, every "
                    f"{cfg.shared_attn_every} layers")
        return out
    out = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"
    if cfg.family == "moe":
        m = cfg.moe
        out += (f", {m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff}"
                + (f" and {m.n_shared} shared of {m.shared_d_ff}"
                   if m.n_shared else "")
                + (f" every {cfg.moe_every} layers (dense d_ff {cfg.d_ff})"
                   if cfg.moe_every > 1 else "")
                + f", capacity factor {m.capacity_factor}")
    else:
        out += f", d_ff {cfg.d_ff}"
    if cfg.qk_norm:
        out += ", qk-norm"
    if cfg.is_encdec:
        out += f", {cfg.n_enc_layers} encoder layers"
    if cfg.kv_bits == 8:
        out += ", int8 KV cache"
    return out


def make_lm(torch, lm, registry, dev, tag: str, arch: str,
            n_layers: int | None = None, params=None, **replace):
    """``arch``'s config (``n_layers`` of its layers, fields replaced),
    and random float32 weights made on the card from seed 0 (or
    ``params``); the peak memory statistic reset first."""
    import dataclasses
    full = registry.get(arch)
    cfg = dataclasses.replace(full, **replace, **(
        {} if n_layers is None else {"n_layers": n_layers}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    made = params is None
    if made:
        params = lm.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    depth = (f"{cfg.n_layers} of {full.n_layers} layers"
             if cfg.n_layers != full.n_layers else f"{cfg.n_layers} layers")
    print(f"{tag} {cfg.name}: {depth}, d {cfg.d_model}, {describe(cfg)}, "
          f"vocab {cfg.vocab}; {n_params / 1e9:.3f} B float32 parameters "
          f"({n_params * 4 / 2 ** 30:.1f} GiB) "
          + (f"made on {dev} in {time.perf_counter() - t0:.1f}s" if made
             else "reused"), flush=True)
    return cfg, params


def free_card(torch) -> None:
    """Collect what only a reference cycle keeps (a path's weights), then
    hand the cached blocks back to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def serve_path(torch, np, Engine, Request, counters, dev, tag: str, cfg,
               params, prompts, n_new: int, **hooks) -> tuple:
    """``prompts`` served by Engine (``serve_lm``) with the launch
    counters set to 0 just before and read just after, the launches
    checked per prefill and per decode step (``lm_launches``). Returns
    (counts, run dict, done, served logits, replica)."""
    for c in counters.values():
        c.reset()
    done, wall, served, prefill_ms, steps, decode_issue, rep = serve_lm(
        torch, np, Engine, Request, cfg, params, dev, prompts, n_new,
        **hooks)
    counts = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want.update(lm_launches(cfg, len(prompts), steps))
    if len(done) != len(prompts) or not all(r.done for r in done) \
            or counts != want:
        raise AssertionError(f"{tag}: {len(done)} requests done over "
                             f"{steps} decode steps, launches {counts}, "
                             f"expected {want}")
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"{tag} Engine(max_batch={LM_BATCH}, cache_size={LM_CACHE}) "
          f"served {len(done)} requests (prompts "
          f"{sorted(len(p) for p in prompts)}, {n_new} greedy tokens each)"
          f" in {wall:.2f}s over {steps} decode steps: {n_tok / wall:.1f} "
          f"tokens/s; launches {counts} = per prefill "
          f"{_nonzero(lm_launches(cfg, 1, 0))}, per decode step "
          f"{_nonzero(lm_launches(cfg, 0, 1))}", flush=True)
    issue_med = sorted(decode_issue)[len(decode_issue) // 2]
    step_ms = (wall - sum(m for _, m in prefill_ms) / 1e3) / steps * 1e3
    print(f"{tag} prefill ms by prompt length (host clock, synchronised): "
          + ", ".join(f"{n}: {m:.1f}" for n, m in sorted(prefill_ms))
          + f"; the rest of the run over the decode steps: {step_ms:.2f} "
          f"ms a step, host issue median {issue_med:.2f} ms", flush=True)
    run = {"arch": cfg.name, "layers": cfg.n_layers,
           "requests": len(done), "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "decode_steps": steps,
           "prefill_ms": sorted(prefill_ms),
           "decode_issue_ms_median": issue_med,
           "decode_step_ms_in_serving": step_ms}
    return counts, run, done, served, rep


def print_spans(tag: str, spans: dict) -> None:
    for name, sp in spans.items():
        dev_txt = "device not measured (no kernel records)" \
            if sp["busy"] is None else (
                f"kernels {sp['busy']:.3f} ms busy over a {sp['span']:.3f}"
                f" ms span ({sp['kernels']} launches; idle share "
                f"{1 - sp['busy'] / sp['span']:.3f}); top {sp['top']}")
        lab = "".join(
            f"; {k} {v[0]:.3f} ms of kernels ({v[2]}) in {v[1]} calls"
            + (f" ({v[0] / sp['busy']:.3f} of the kernels)"
               if sp["busy"] else "")
            for k, v in sp.get("label_ms", {}).items())
        print(f"{tag} {name}: host issue {sp['issue']:.3f} ms, issue to "
              f"synchronised {sp['wall']:.3f} ms; {dev_txt}{lab}",
              flush=True)


def print_check(tag: str, check: dict, tol: float) -> None:
    print(f"{tag} teacher-forced plain path on the card: served logits "
          f"within {check['max_abs_err']:.3e} (prefill "
          f"{check['prefill_max_abs_err']:.3e}, decode steps "
          f"{check['step_max_abs_err']:.3e}, mean per step "
          f"{check['mean_step_err']:.3e}; tolerance {tol}); "
          f"{check['tokens_checked']} served tokens equal to the plain "
          f"argmax where its top-2 margin exceeds twice the step's "
          f"difference, {check['tokens_within_margin']} within that "
          f"margin", flush=True)


def run_lm(torch, np, lm, ops, registry, Engine, Request, counters, dev,
           path: str, keep: bool = False) -> tuple:
    """An LM path of LM_PATHS (``lm``: granite-3-8b; ``ssm``: mamba2-130m;
    ``hybrid``: zamba2-1.2b) at full width and depth, random float32
    weights from a seeded generator on the card, served by Engine with
    the launch counters set to 0 just before and read just after;
    launches checked per prefill and per decode step (``lm_launches``);
    the served logits held to the plain path by teacher forcing (the
    path's tolerance, and the served tokens to its argmax where its
    margin is clear); spans timed. Returns (counts, run dict, and with
    ``keep`` the weights, else None: freed)."""
    arch, lens, tol = LM_PATHS[path]
    tag = f"[{path}]"
    cfg, params = make_lm(torch, lm, registry, dev, tag, arch)
    prompts = lm_prompts(np, cfg.vocab, lens)
    counts, run, done, served, _ = serve_path(
        torch, np, Engine, Request, counters, dev, tag, cfg, params,
        prompts, LM_NEW)
    check = replay_plain(torch, np, lm, ops, cfg, params, dev, prompts,
                         done, served)
    hold(tag, check, tol)
    spans = lm_spans(torch, lm, cfg, params, dev)
    print_spans(tag, spans)
    run.update(spans_ms=spans, check=check, tolerance=tol,
               peak_gib=peak_gib(torch))
    print(f"{tag} peak memory {run['peak_gib']:.2f} GiB", flush=True)
    if not keep:
        del params
        params = None
        free_card(torch)
    return counts, run, params


# --------------------------------------------------------------------------
# multi-position paths: tensor-parallel replicas and the streaming pipeline
# --------------------------------------------------------------------------

def positions(n: int) -> list:
    """``n`` positions over ``cuda_devices()``, wrapping: with one card
    every position names cuda:0."""
    from repro_torch.device import cuda_devices
    devs = cuda_devices()
    return [devs[i % len(devs)] for i in range(n)]


def run_tp(torch, np, codegen, ImageStream, Deployment, DetectRequest,
           counters, acc, xb) -> tuple:
    """Path tp: ``acc`` (main's design) served by TP_REPLICAS
    tensor-parallel replicas of TP_WIDTH positions
    (``Deployment(tensor_parallel=...)`` over ``cuda_devices()``),
    N_REQ requests: each sharded conv launches #1 once a position on its
    filter slice, then an all-gather; maxpools and resizes launch once
    on the replicated stream. Gates: the launches (from the graph), the
    outputs within MAIN_TOL of the plain executor and within TP_TOL of
    the one-device kernel forward on each batch, and one profiled
    forward's all-gather bytes (``roofline.trace``) equal to the
    sharded convs' outputs' bytes from the graph. Readings: frames/s of
    a second window, the forward's device and issue ms beside main's
    one-device forward. Returns (launches, run dict)."""
    from repro_torch.device import cuda_devices
    from repro_torch.dist import sharding
    from repro_torch.roofline import trace
    from repro_torch.serve.deployment import step_fn_for, tp_backend
    tag = "[tp]"
    t_path = time.perf_counter()
    devs = positions(TP_WIDTH * TP_REPLICAS)
    print(f"{tag} {TP_REPLICAS} replicas x {TP_WIDTH} positions over "
          f"cuda_devices() = {sorted({str(d) for d in devs})}: "
          + ("every position names cuda:0" if len(set(devs)) == 1 else
             "positions on distinct cards"), flush=True)
    g = acc.graph
    convs = [g.nodes[n] for n in codegen.launch_nodes(g)
             if g.nodes[n].op == "conv"]
    sharded = [n for n in convs if n.geom("F") % TP_WIDTH == 0]
    per_fwd = zero_counts(counters, conv2d=TP_WIDTH * len(sharded)
                          + len(convs) - len(sharded), maxpool2d=3,
                          resize_nearest=2)
    gather_bytes = sum(BATCH * int(np.prod(g.streams[n.outputs[0]].shape))
                       * 4 for n in sharded)
    _zero(counters)
    images, done, stats, wall = serve(
        Deployment, DetectRequest, ImageStream, acc, N_REQ, IMG, 0,
        replicas=TP_REPLICAS, tensor_parallel=TP_WIDTH,
        devices=cuda_devices())
    counts = _counts(counters)
    batches = stats["batches"]
    want = {k: v * batches for k, v in per_fwd.items()}
    if batches != N_REQ // BATCH or counts != want:
        raise AssertionError(f"{tag} launches {counts} over {batches} "
                             f"batches, expected {want}")
    err_ref, scale = check_outputs(
        torch, np, acc, images, done,
        [(IMG // s, IMG // s, 144) for s in (8, 16, 32)])
    err_one = 0.0
    for i in range(0, N_REQ, BATCH):
        x = torch.from_numpy(np.stack(images[i:i + BATCH])).to(
            acc.torch_device)
        one = [o.cpu() for o in acc.forward(x)]
        for j, req in enumerate(done[i:i + BATCH]):
            for o, w in zip(req.outputs, one):
                got = torch.from_numpy(o)
                err_one = max(err_one, float((got - w[j]).abs().max()))
                if not torch.allclose(got, w[j], atol=TP_TOL, rtol=TP_TOL):
                    raise AssertionError(f"{tag} request {req.uid}: "
                                         f"{float((got - w[j]).abs().max())}"
                                         f" from the one-device forward")
    print(f"{tag} served {stats['frames']} requests in {batches} batches; "
          f"launches {_nonzero(counts)} = {batches} x {_nonzero(per_fwd)} "
          f"({len(sharded)} of {len(convs)} convs sharded); outputs within "
          f"{MAIN_TOL} of backend='ref' (max_abs_err {err_ref:.3e}, max "
          f"|output| {scale:.3e}) and within {TP_TOL} of the one-device "
          f"kernel forward (max_abs_err {err_one:.3e})", flush=True)
    # one replica's forward, alone: the same step function and placement
    step = step_fn_for(acc, tp_backend(None))
    placed = sharding.place_sharded(acc.params, positions(TP_WIDTH))
    fwd = functools.partial(step, placed, xb)
    from torch.profiler import ProfilerActivity, profile
    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd()
        torch.cuda.synchronize()
    got = trace.collective_bytes(prof)
    n_gather = trace.collective_count(prof)
    if got != {"all-gather": gather_bytes, "total": gather_bytes} \
            or n_gather != len(sharded):
        raise AssertionError(f"{tag} trace {got} in {n_gather} transfers, "
                             f"the graph's {gather_bytes} in {len(sharded)}")
    dev_tp, issue_tp = device_ms(torch, fwd, reps=5)
    dev_one, issue_one = device_ms(torch, lambda: acc.forward(xb), reps=5)
    b2b_tp = cuda_ms(torch, fwd, budget_ms=300)
    b2b_one = cuda_ms(torch, lambda: acc.forward(xb), budget_ms=300)
    _, _, stats2, wall2 = serve(
        Deployment, DetectRequest, ImageStream, acc, 2 * N_REQ, IMG, 2,
        replicas=TP_REPLICAS, tensor_parallel=TP_WIDTH,
        devices=cuda_devices())
    fps = stats2["frames"] / wall2
    run = {"launches_per_forward": per_fwd, "sharded_convs": len(sharded),
           "convs": len(convs), "max_abs_err_vs_ref": err_ref,
           "max_abs_err_vs_one_device": err_one,
           "trace_bytes": got, "trace_transfers": n_gather,
           "graph_gather_bytes": gather_bytes,
           "forward_device_ms": dev_tp, "forward_issue_ms": issue_tp,
           "forward_back_to_back_ms": b2b_tp,
           "main_forward_device_ms": dev_one,
           "main_forward_issue_ms": issue_one,
           "main_forward_back_to_back_ms": b2b_one,
           "frames_per_s": fps, "ms_per_batch":
           wall2 / stats2["batches"] * 1e3}
    print(f"{tag} one forward: {n_gather} all-gathers of {got['total']} B "
          f"(roofline.trace; the graph's sharded conv outputs "
          f"{gather_bytes} B); device {dev_tp:.3f} ms, issue "
          f"{issue_tp:.3f} ms, back to back {b2b_tp:.3f} ms; main's "
          f"one-device forward device {dev_one:.3f} ms, issue "
          f"{issue_one:.3f} ms, back to back {b2b_one:.3f} ms; serving "
          f"window {fps:.1f} frames/s, {run['ms_per_batch']:.2f} ms/batch "
          f"over {stats2['frames']} requests", flush=True)
    run["seconds"] = time.perf_counter() - t_path
    print(f"{tag} path tp took {run['seconds']:.1f}s", flush=True)
    return counts, run


# Path tp's quantized and double-buffered designs: each conv's kernel
# counter by the lowering the one-device table takes.
_A8_KERNELS = ("qmatmul_a8", "qmatmul_a8_double", "qmatmul_a8_grouped")


def tp_conv_kernel(qmm, quant_kern, node, w, quant: bool,
                   double: bool) -> str:
    """The counter a conv of a design launches: #7 ``qmatmul`` (float
    activations, or per-channel activation scales whose runs align to no
    K tile: ``qmm._group_tile``), #8 ``qmatmul_a8`` (#10 under
    ``double``), #9 ``qmatmul_a8_grouped`` (per-channel activation
    scales, whatever the pipeline), or #1 ``conv2d`` (#2 under
    ``double``) where it runs in float (the float design; a quant
    design's float lowering)."""
    low = quant_kern.select_lowering(node, w) if quant else "float"
    if low == "int8-w":
        return "qmatmul"
    if low == "int8-wa":
        a = node.attrs["a_scale"]
        if not isinstance(a, tuple):
            return "qmatmul_a8_double" if double else "qmatmul_a8"
        xs = tuple(float(v) for v in a) * (node.geom("K") ** 2)
        return "qmatmul" if qmm._group_tile(xs, len(xs), 128, bool(
            w.packed))[0] is None else "qmatmul_a8_grouped"
    return "conv2d_double" if double else "conv2d"


def tp_plan(codegen, quant_mod, qmm, quant_kern, acc, quant: bool,
            double: bool) -> tuple:
    """One tensor-parallel forward of ``acc``'s design, from its graph:
    (each counter's launches, each conv's counter, the convs cut by
    filter, the all-gather bytes). A conv whose filters divide TP_WIDTH
    (and whose weight cuts into filter blocks) launches its kernel once
    a position, then an all-gather of its output; every other node
    launches once, a maxpool unfused."""
    g = acc.graph
    launches: dict = {}
    kernel_of, sharded = {}, []
    for name in codegen.launch_nodes(g):
        n = g.nodes[name]
        if n.op == "conv":
            w = acc.params[name]["w"]
            k = kernel_of[name] = tp_conv_kernel(qmm, quant_kern, n, w,
                                                 quant, double)
            cut = n.geom("F") % TP_WIDTH == 0 and (
                not isinstance(w, quant_mod.QTensor)
                or quant_mod.cuts_by_filter(w))
            sharded += [n] if cut else []
            launches[k] = launches.get(k, 0) + (TP_WIDTH if cut else 1)
        else:
            k = {"maxpool": "maxpool2d", "resize": "resize_nearest"}.get(
                n.op, "pointwise")
            if n.op not in ("concat", "split", "add"):
                launches[k] = launches.get(k, 0) + 1
    nbytes = sum(BATCH * int(math.prod(g.streams[n.outputs[0]].shape)) * 4
                 for n in sharded)
    return launches, kernel_of, sharded, nbytes


class TpCompare:
    """A one-device lowering table that runs every conv twice on the same
    input, the one-device path's own: through ``one`` and through
    ``codegen.TensorParallel(one)`` over the placed parameters
    (``placed``), and holds the two within KERNEL_TOL of the conv's
    kernel (atol = rtol). Where the conv contracts int8 activation codes
    and is cut by filter, its int32 sums are held bit-equal too: the
    conv's codes through the same kernel with unit scales, zero 0 and no
    bias, on each position's filter block and on the whole weight, whose
    outputs are then the sums exactly (below 2^24). The one-device
    result is passed on; pools run as nodes of their own."""
    name = "tp_compare"

    def __init__(self, torch, codegen, ops, ref, one, placed, kernel_of,
                 double: bool):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.one, self.tp = one, codegen.TensorParallel(one)
        self.placed, self.kernel_of, self.double = placed, kernel_of, double
        self.worst, self.convs, self.sums_equal = 0.0, 0, 0

    def fuses_pool(self, node):
        return False

    def _sums(self, x, w, node, dev):
        torch = self.torch
        a = node.attrs["a_scale"]
        codes = self.ref.quantize_activation(
            x, a if isinstance(a, float) else torch.tensor(
                a, dtype=torch.float32, device=x.device),
            bits=int(node.attrs.get("a_bits", 8))).to(dev, torch.float32)
        unit = 1.0 if isinstance(a, float) else tuple(1.0 for _ in a)
        return self.ops.qconv2d_a8(
            codes, w.q, torch.ones_like(w.scale), torch.zeros_like(w.zero),
            None, x_scale=unit, a_bits=8, K=node.geom("K"),
            stride=node.geom("stride"), w_packed=w.packed,
            pipeline="double" if self.double else "grid")

    def conv(self, x, p, node, res=None, **kw):
        want = self.one.conv(x, p, node, res)
        st = self.placed[node.name]["w"]
        got = self.tp.conv(x, self.placed[node.name], node, res)
        kname = self.kernel_of[node.name]
        tol = KERNEL_TOL[kname]
        err = float((got - want).abs().max())
        self.worst = max(self.worst, err)
        self.convs += 1
        if float((got - want).abs().sub(tol * want.abs()).max()) > tol:
            raise AssertionError(f"{node.name}: tensor-parallel {kname} "
                                 f"{err} from one device on the same "
                                 f"input")
        if kname in _A8_KERNELS and st.spec and st.spec[-1] is not None:
            xd = self.ops.channel_concat(x)
            whole = self._sums(xd, p["w"], node, xd.device)
            parts = [self._sums(xd, st.shard(i), node, st.shard(i).q.device)
                     .to(xd.device) for i in range(len(st.shards))]
            if not self.torch.equal(self.torch.cat(parts, -1), whole):
                raise AssertionError(f"{node.name}: int32 sums of the "
                                     f"filter blocks differ from one "
                                     f"device's")
            self.sums_equal += 1
        return want

    def __getattr__(self, item):
        return getattr(self.one, item)


def plans_of(torch, K, fn) -> list:
    """The tensor-core kernels' plans (planner, plan) of ``fn()``'s calls
    in order: #1/#2's ``conv2d._plan``, #7's ``qmatmul._plan``, #8/#10's
    ``_plan_a8``, #9's ``_plan_a8g``."""
    rec: list = []
    entries = ((K.conv2d, "_plan"), (K.qmatmul, "_plan"),
               (K.qmatmul, "_plan_a8"), (K.qmatmul, "_plan_a8g"))
    saved = [getattr(m, f) for m, f in entries]

    def wrap(real, label):
        def planner(*a, **kw):
            out = real(*a, **kw)
            rec.append((label, tuple(out)))
            return out
        return planner
    for (m, f), real in zip(entries, saved):
        setattr(m, f, wrap(real, f"{m.__name__}.{f}"))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for (m, f), real in zip(entries, saved):
            setattr(m, f, real)
    return rec


def same_plans(one: list, tp: list, kernel_of: dict, sharded: list,
               order: list) -> bool:
    """Whether every conv's kernel ran on the same plan (tile, split) at
    each position as on one device: ``one`` has a plan a conv, ``tp`` one
    a position for each conv cut by filter, in ``order``."""
    cut = {n.name for n in sharded}
    i = j = 0
    same = True
    for name in order:
        n_tp = TP_WIDTH if name in cut else 1
        want = one[i]
        for got in tp[j:j + n_tp]:
            if got[0] != want[0]:
                raise AssertionError(f"plans out of step at {name}: "
                                     f"{got} against {want}")
            same &= got[1] == want[1]
        i, j = i + 1, j + n_tp
    if i != len(one) or j != len(tp):
        raise AssertionError(f"{len(one)} one-device plans and {len(tp)} "
                             f"tensor-parallel ones for {len(order)} convs")
    return same


def run_tp_quant(torch, np, codegen, quant_mod, ops, ref, K, ImageStream,
                 Deployment, DetectRequest, counters, designs: list,
                 failed: list) -> tuple:
    """Path tp's quantized and double-buffered designs, with no
    recompile: each entry of ``designs`` (label, accelerator, its
    one-device lowering table, its plain table, img, seed) served by
    TP_REPLICAS tensor-parallel replicas of TP_WIDTH positions
    (``Deployment(tensor_parallel=..., backend=<table>)``), N_REQ
    requests, the launch counters set to 0 just before and read just
    after. Each sharded conv launches its kernel (#7, #8, #9, #10, #1 or
    #2, ``tp_conv_kernel``) once a position on its filter block, then an
    all-gather; the rest once, maxpool unfused (``tp_plan``). Gates: the
    launches; every conv against one device on the one-device path's
    input (``TpCompare``: KERNEL_TOL, int32 sums bit-equal); end to end,
    the served outputs bit-equal to the one-device kernel forward where
    every conv's plan is the same at each position (``plans_of``),
    otherwise, for a design that quantizes activations to 8 bits, within
    A8_TOL·max|out| of the plain path or A8_SPREAD times its one-ulp
    spread (``a8_path_check``'s rule; a reading that breaks it is kept in
    ``failed``, ``a8_failure``), and for the others within TP_TOL
    of the one-device forward; one profiled forward's all-gather bytes
    (``roofline.trace``) equal to the graph's. Readings: the forward's
    device, issue and back-to-back ms beside the one-device forward's,
    frames/s of a second window. Returns (launches, {label: run})."""
    from repro_torch.device import cuda_devices
    from repro_torch.dist import sharding
    from repro_torch.roofline import trace
    from repro_torch.serve.deployment import step_fn_for, tp_backend
    from torch.profiler import ProfilerActivity, profile
    total = {k: 0 for k in counters}
    runs: dict = {}
    for label, acc, one, plain, img, seed in designs:
        tag = f"[tp] {label}:"
        t0 = time.perf_counter()
        quant = isinstance(getattr(one, "base", one), codegen.QuantBackend)
        double = isinstance(one, DoubleBuffered)
        a8 = quant and any(int(n.attrs.get("a_bits", 16)) <= 8
                           and n.attrs.get("a_scale") is not None
                           for n in acc.graph.nodes.values())
        per_fwd, kernel_of, sharded, gather_bytes = tp_plan(
            codegen, quant_mod, K.qmatmul, codegen.get_backend("quant"),
            acc, quant, double)
        _zero(counters)
        images, done, stats, wall = serve(
            Deployment, DetectRequest, ImageStream, acc, N_REQ, img, seed,
            backend=one, replicas=TP_REPLICAS, tensor_parallel=TP_WIDTH,
            devices=cuda_devices())
        counts = _counts(counters)
        batches = stats["batches"]
        want = {k: per_fwd.get(k, 0) * batches for k in counters}
        if batches != N_REQ // BATCH or counts != want:
            raise AssertionError(f"{tag} launches {counts} over {batches} "
                                 f"batches, expected {want}")
        for k, v in counts.items():
            total[k] += v
        shapes = [tuple(o.shape[1:]) for o in acc.forward(
            torch.zeros((1, img, img, 3), device=acc.torch_device))]
        if len(done) != N_REQ or any(
                not r.done or [tuple(o.shape) for o in r.outputs] != shapes
                or not all(np.isfinite(o).all() for o in r.outputs)
                for r in done):
            raise AssertionError(f"{tag} served outputs")
        placed = sharding.place_sharded(acc.params, positions(TP_WIDTH))
        step = step_fn_for(acc, tp_backend(one))
        xb = torch.from_numpy(np.stack(images[:BATCH])).to(acc.torch_device)
        cmp = TpCompare(torch, codegen, ops, ref, one, placed, kernel_of,
                        double)
        acc.forward(xb, backend=cmp)
        order = [n.name for n in acc.graph.topo_order() if n.op == "conv"]
        same = same_plans(
            plans_of(torch, K, lambda: acc.forward(xb, backend=one)),
            plans_of(torch, K, lambda: step(placed, xb)), kernel_of,
            sharded, order)
        e2e = {"vs_one_max": 0.0, "bit_equal": True}
        for i in range(0, N_REQ, BATCH):
            x = torch.from_numpy(np.stack(images[i:i + BATCH])).to(
                acc.torch_device)
            got = [torch.from_numpy(np.stack([r.outputs[j] for r in
                                              done[i:i + BATCH]]))
                   for j in range(len(shapes))]
            one_out = [o.cpu() for o in acc.forward(x, backend=one)]
            d = max(float((a - b).abs().max()) for a, b in zip(got, one_out))
            e2e["vs_one_max"] = max(e2e["vs_one_max"], d)
            e2e["bit_equal"] &= d == 0.0
            if same:
                if d != 0.0:
                    raise AssertionError(f"{tag} batch {i // BATCH}: every "
                                         f"plan the same, yet {d} from one "
                                         f"device")
            elif a8:
                want_p = [o.cpu() for o in acc.forward(x, backend=plain)]
                spread = [[o.cpu() for o in acc.forward(
                    x, backend=NudgedOutputs(torch, plain, to))]
                    for to in (float("inf"), float("-inf"))]

                def diff(outs):
                    t = [(o - w).abs() for o, w in zip(outs, want_p)]
                    return (max(float(u.max()) for u in t), float(
                        torch.cat([u.reshape(-1) for u in t]).mean()))
                k_max, k_mean = diff(got)
                s = [diff(o) for o in spread]
                s_max, s_mean = max(a for a, _ in s), max(b for _, b in s)
                top = max(float(w.abs().max()) for w in want_p)
                ok = k_max <= A8_TOL * top or (
                    k_max <= A8_SPREAD * s_max
                    and k_mean <= A8_SPREAD * s_mean)
                e2e.setdefault("a8", []).append(
                    {"batch": i // BATCH, "vs_plain_max": k_max,
                     "vs_plain_mean": k_mean, "spread_max": s_max,
                     "spread_mean": s_mean, "max_out": top, "ok": ok,
                     "margin_max": k_max / (A8_SPREAD * s_max),
                     "margin_mean": k_mean / (A8_SPREAD * s_mean)})
                if not ok:
                    a8_failure(failed, f"{tag} batch {i // BATCH}: "
                                       f"{e2e['a8'][-1]}")
            elif not all(torch.allclose(a, b, atol=TP_TOL, rtol=TP_TOL)
                         for a, b in zip(got, one_out)):
                raise AssertionError(f"{tag} batch {i // BATCH}: {d} from "
                                     f"one device")
        fwd = functools.partial(step, placed, xb)
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fwd()
            torch.cuda.synchronize()
        got_b = trace.collective_bytes(prof)
        n_gather = trace.collective_count(prof)
        if got_b != {"all-gather": gather_bytes, "total": gather_bytes} \
                or n_gather != len(sharded):
            raise AssertionError(f"{tag} trace {got_b} in {n_gather} "
                                 f"transfers, the graph's {gather_bytes} "
                                 f"in {len(sharded)}")
        dev_tp, issue_tp = device_ms(torch, fwd, reps=5)
        dev_one, issue_one = device_ms(
            torch, lambda: acc.forward(xb, backend=one), reps=5)
        b2b_tp = cuda_ms(torch, fwd, budget_ms=300)
        b2b_one = cuda_ms(torch, lambda: acc.forward(xb, backend=one),
                          budget_ms=300)
        _, _, stats2, wall2 = serve(
            Deployment, DetectRequest, ImageStream, acc, N_REQ, img,
            seed + 1, backend=one, replicas=TP_REPLICAS,
            tensor_parallel=TP_WIDTH, devices=cuda_devices())
        fps = stats2["frames"] / wall2
        run = {"img": img, "launches_per_forward": per_fwd,
               "sharded_convs": len(sharded), "convs": len(order),
               "conv_max_abs_err_vs_one": cmp.worst,
               "convs_int32_sums_equal": cmp.sums_equal,
               "same_plans": same, "end_to_end": e2e,
               "trace_bytes": got_b, "trace_transfers": n_gather,
               "forward_device_ms": dev_tp, "forward_issue_ms": issue_tp,
               "forward_back_to_back_ms": b2b_tp,
               "one_device_forward_device_ms": dev_one,
               "one_device_forward_issue_ms": issue_one,
               "one_device_forward_back_to_back_ms": b2b_one,
               "frames_per_s": fps,
               "ms_per_batch": wall2 / stats2["batches"] * 1e3}
        held = ("bit-equal to one device (every plan the same)" if same
                else "within A8_TOL or A8_SPREAD of the plain path "
                f"(margins by batch, max/mean: " + ", ".join(
                    f"{r['margin_max']:.4f}/{r['margin_mean']:.4f}"
                    for r in e2e["a8"]) + ")" if a8
                else f"within {TP_TOL} of one device")
        print(f"{tag} yolov8n@{img}, {TP_REPLICAS} replicas x {TP_WIDTH} "
              f"positions: launches a forward {_nonzero(per_fwd)} "
              f"({len(sharded)} of {len(order)} convs cut by filter); each "
              f"conv against one device on its input: max_abs_err "
              f"{cmp.worst:.3e}, int32 sums bit-equal at {cmp.sums_equal} "
              f"A8 convs; every plan the same at each position: {same}; "
              f"served outputs {held} (max |diff| from one device "
              f"{e2e['vs_one_max']:.3e}); {n_gather} all-gathers of "
              f"{got_b['total']} B; forward device {dev_tp:.3f} ms, issue "
              f"{issue_tp:.3f} ms, back to back {b2b_tp:.3f} ms; one device "
              f"{dev_one:.3f} / {issue_one:.3f} / {b2b_one:.3f} ms; "
              f"{fps:.1f} frames/s; {time.perf_counter() - t0:.1f}s",
              flush=True)
        runs[label] = run
        del placed, step, cmp
    return total, runs


def zero_counts(counters, **nonzero) -> dict:
    """Every counter's name with 0, but ``nonzero``'s counts."""
    return {k: nonzero.get(k, 0) for k in counters}


def run_pipeline(torch, np, lm, registry, counters, dev, graph) -> tuple:
    """Path pipeline: granite-3-8b at full width, PIPE_LAYERS of its
    layers stacked into PIPE_STAGES stages (``core.pipeline.
    stack_stages``) on a ``stage`` mesh over ``cuda_devices()``, fed
    PIPE_MICRO microbatches of 1 x PIPE_SEQ tokens of embeddings; each
    stage runs its dense layers with no cache and a causal mask
    (``lm.dense_layers``). Gates: pipelined within PIPE_TOL of the
    sequential layer loop; 2 #6 and 1 #11 a layer a microbatch (the
    port skips a stage on a tick where it holds no microbatch); the
    trace's permute and all-reduce bytes as the schedule moves them.
    Readings: ms a pipelined call and a sequential loop (median of 5),
    the modelled interval and fill (``pipeline_latency_model``) of the
    measured stage time, and ``graph``'s 4-stage ``partition_stages``
    with ``stage_latency`` (a model, not a measurement). Returns
    (launches, run dict)."""
    from repro_torch.core import dse, pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import trace
    from repro_torch.tree import tree_map
    tag = "[pipeline]"
    t_path = time.perf_counter()
    cfg, params = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                          PIPE_LAYERS)
    devs = positions(PIPE_STAGES)
    mesh = mesh_lib.make_mesh((PIPE_STAGES,), ("stage",), devices=devs)
    print(f"{tag} {PIPE_STAGES} stages of {PIPE_LAYERS // PIPE_STAGES} "
          f"layers on {mesh}: "
          + ("every position names cuda:0" if len(set(devs)) == 1 else
             "stages on distinct cards"), flush=True)
    stages = pipeline.stack_stages(params["layers"], PIPE_STAGES,
                                   PIPE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (PIPE_MICRO, 1, PIPE_SEQ),
                         generator=gen, device=dev)
    x = params["embed"]["table"][toks]

    def stage_fn(p, h):
        return lm.dense_layers(cfg, p, h)

    def piped():
        return pipeline.pipeline_infer(stage_fn, stages, x, mesh)

    def sequential():
        return torch.stack([lm.dense_layers(cfg, params["layers"], x[i])
                            for i in range(PIPE_MICRO)])

    with torch.inference_mode():
        _zero(counters)
        got = piped()
        torch.cuda.synchronize()
        counts = _counts(counters)
        want_counts = zero_counts(
            counters, rmsnorm=2 * PIPE_LAYERS * PIPE_MICRO,
            mha=PIPE_LAYERS * PIPE_MICRO)
        if counts != want_counts:
            raise AssertionError(f"{tag} launches {counts}, expected "
                                 f"{want_counts}")
        want = sequential()
        err = float((got - want).abs().max())
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or not torch.allclose(got, want, atol=PIPE_TOL,
                                      rtol=PIPE_TOL):
            raise AssertionError(f"{tag} pipelined vs sequential: "
                                 f"max_abs_err {err}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            piped()
            torch.cuda.synchronize()
        got_bytes = trace.collective_bytes(prof)
        mb = PIPE_SEQ * cfg.d_model * 4
        want_bytes = {"collective-permute": PIPE_MICRO * (PIPE_STAGES - 1)
                      * mb, "all-reduce": PIPE_MICRO * mb}
        want_bytes["total"] = sum(want_bytes.values())
        if got_bytes != want_bytes:
            raise AssertionError(f"{tag} trace {got_bytes}, expected "
                                 f"{want_bytes}")
        pipe_ms = sorted(_timed(torch, piped)[1] for _ in range(5))[2]
        seq_ms = sorted(_timed(torch, sequential)[1] for _ in range(5))[2]
        first = tree_map(lambda a: a[0], stages)
        stage_ms = cuda_ms(torch, lambda: stage_fn(first, x[0]),
                           budget_ms=300)
    model = pipeline.pipeline_latency_model([stage_ms / 1e3] * PIPE_STAGES,
                                            PIPE_MICRO)
    print(f"{tag} pipelined within {PIPE_TOL} of the sequential layer loop "
          f"(max_abs_err {err:.3e}); launches {_nonzero(counts)} "
          f"(= {PIPE_MICRO} microbatches x {PIPE_LAYERS} layers x 2 #6 and "
          f"x 1 #11); trace {got_bytes} ({trace.collective_count(prof)} "
          f"transfers); a pipelined call {pipe_ms:.1f} ms, the sequential "
          f"loop {seq_ms:.1f} ms (median of 5; one card runs the stages "
          f"one after another); one stage on one microbatch {stage_ms:.2f} "
          f"ms: modelled interval {model['interval_s'] * 1e3:.2f} ms, fill "
          f"{model['fill_s'] * 1e3:.2f} ms, total "
          f"{model['total_s'] * 1e3:.2f} ms, bubble "
          f"{model['bubble_frac']:.3f} (pipeline_latency_model: "
          f"{PIPE_STAGES} cards)", flush=True)
    plan = dse.partition_stages(graph, 4)
    lat = dse.stage_latency(plan)
    print(f"{tag} a model, not a measurement: yolov8n@{IMG}'s 4-stage "
          f"partition_stages: {[len(b) for b in plan.boundaries]} nodes, "
          f"stage MACs {plan.stage_flops} (imbalance "
          f"{plan.imbalance:.4f}); stage_latency on the H100 entry at fp32: "
          f"interval {lat['interval_s'] * 1e6:.2f} us, fill "
          f"{lat['fill_s'] * 1e6:.2f} us a frame", flush=True)
    run = {"stages": PIPE_STAGES, "layers": PIPE_LAYERS,
           "microbatches": PIPE_MICRO, "seq": PIPE_SEQ,
           "max_abs_err": err, "launches": counts, "trace_bytes": got_bytes,
           "pipelined_ms": pipe_ms, "sequential_ms": seq_ms,
           "stage_ms": stage_ms, "latency_model": model,
           "yolov8n_partition": {"nodes": [len(b) for b in plan.boundaries],
                                 "stage_macs": plan.stage_flops,
                                 "imbalance": plan.imbalance,
                                 "stage_latency": lat},
           "peak_gib": peak_gib(torch)}
    del params, stages, x, got, want
    free_card(torch)
    run["seconds"] = time.perf_counter() - t_path
    print(f"{tag} path pipeline took {run['seconds']:.1f}s, peak "
          f"{run['peak_gib']:.2f} GiB", flush=True)
    return counts, run


def roofline_shares(registry, lm_runs: dict) -> dict:
    """The analytic work (``roofline.analysis.analytic_flops``, the
    layers only for the pipeline call) and MODEL_FLOPS of three readings
    of the full run, each over its measured ms as a share of the H100's
    fp32 peak: granite-3-8b's prefill at 2048 (``lm``), the granite
    train step (``train``) and the pipelined call (``pipeline``)."""
    import dataclasses
    from repro_torch.configs.base import ShapeCell
    from repro_torch.roofline import analysis
    full = registry.get("granite-3-8b")
    out = {}
    readings = []
    if "lm" in lm_runs:
        cell = ShapeCell("prefill_2048", "prefill", 2048, 1)
        readings.append(("granite prefill 2048", full, cell,
                         lm_runs["lm"]["spans_ms"]["prefill_2048"]["wall"],
                         None))
    if "train" in lm_runs:
        g = lm_runs["train"]["granite"]
        cfg = dataclasses.replace(full, n_layers=g["layers"], remat="full")
        cell = ShapeCell("train", "train", g["seq"], g["rows"])
        readings.append(("granite train step", cfg, cell,
                         g["step_ms_median"], None))
    if "pipeline" in lm_runs:
        p = lm_runs["pipeline"]
        cfg = dataclasses.replace(full, n_layers=p["layers"])
        cell = ShapeCell("pipeline", "prefill", p["seq"], p["microbatches"])
        readout = 2.0 * cell.global_batch * cfg.d_model * cfg.vocab
        n_layer = cfg.param_count() - dataclasses.replace(
            cfg, n_layers=0).param_count()
        readings.append(("pipeline call (layers)", cfg, cell,
                         p["pipelined_ms"],
                         (readout, 2.0 * n_layer * cell.tokens())))
    for label, cfg, cell, ms, layers in readings:
        af = analysis.analytic_flops(cfg, cell)
        work = af["total"] if cell.kind == "train" else af["fwd"]
        mf = analysis.model_flops(cfg, cell)
        if layers is not None:          # no embedding, no readout
            work, mf = work - layers[0], layers[1]
        out[label] = {
            "analytic_flops": work, "model_flops": mf, "ms": ms,
            "analytic_share_fp32": analysis.peak_share(work, ms / 1e3),
            "model_share_fp32": analysis.peak_share(mf, ms / 1e3)}
        print(f"[roofline] {label}: analytic_flops {work / 1e12:.3f} TFLOP, "
              f"model_flops {mf / 1e12:.3f} TFLOP in {ms:.1f} ms: "
              f"{out[label]['analytic_share_fp32']:.3f} (analytic) and "
              f"{out[label]['model_share_fp32']:.3f} (model) of the H100's "
              f"fp32 peak", flush=True)
    return out


# --------------------------------------------------------------------------
# the moe, vlm and encdec families and the int8 KV cache
# --------------------------------------------------------------------------

class Routes:
    """An MoE path's routes. While recording, ``moe.route`` and
    ``moe.forward_with_aux`` are wrapped: every routing's experts (``idx``,
    (N, K), kept on the card) and every layer's ``dropped_frac`` are kept
    with ``tag`` (("prefill", uid) or ("decode", [uid of each slot or
    None])). ``force`` then makes ``moe.route`` replay a request's
    recorded experts in order (``start(uid)``) with the replay's own
    gates at them (its softmax at the recorded experts, normalised), and
    counts the decisions whose own top-k differs, each with its margin:
    the largest |p(own k-th) - p(recorded k-th)| over the ranks where
    the two differ, in the replay's probabilities."""

    def __init__(self, moe):
        self.moe = moe
        self.route, self.fwa = moe.route, moe.forward_with_aux
        self.tag = None
        self.log: list = []
        self.dropped: list = []
        self.queue: list = []
        self.decisions = 0
        self.flips: list = []

    def record(self) -> None:
        def route(p, cfg, xt):
            out = self.route(p, cfg, xt)
            self.log.append((self.tag, out[2].clone()))
            return out

        def fwa(p, cfg, x):
            y, aux = self.fwa(p, cfg, x)
            self.dropped.append((self.tag, aux["dropped_frac"]))
            return y, aux
        self.moe.route, self.moe.forward_with_aux = route, fwa

    def restore(self) -> None:
        self.moe.route, self.moe.forward_with_aux = self.route, self.fwa

    def by_request(self) -> dict:
        """{uid: recorded idx of each routing, in call order}: a prefill's
        whole, a decode step's row of the request's slot."""
        out: dict = {}
        for (kind, who), idx in self.log:
            if kind == "prefill":
                out.setdefault(who, []).append(idx)
            else:
                for slot, uid in enumerate(who):
                    if uid is not None:
                        out.setdefault(uid, []).append(idx[slot:slot + 1])
        return out

    def dropped_by_prefill(self) -> dict:
        """{uid: (mean, max) of dropped_frac over a prefill's layers}."""
        out: dict = {}
        for (kind, who), d in self.dropped:
            if kind == "prefill":
                out.setdefault(who, []).append(float(d))
        return {u: (sum(v) / len(v), max(v)) for u, v in out.items()}

    def force(self) -> None:
        recorded = self.by_request()

        def route(p, cfg, xt):
            probs, _, own = self.route(p, cfg, xt)
            rec = self.queue.pop(0)
            if rec.shape != own.shape:
                raise AssertionError(f"replayed routing {tuple(own.shape)}"
                                     f" against recorded "
                                     f"{tuple(rec.shape)}")
            self.decisions += own.shape[0]
            differ = own != rec
            rows = differ.any(-1).nonzero()[:, 0]
            if rows.numel():
                po = probs[rows].gather(-1, own[rows])
                pr = probs[rows].gather(-1, rec[rows])
                gap = ((po - pr).abs() * differ[rows]).amax(-1)
                self.flips.extend(float(g) for g in gap.detach().cpu())
            gate = probs.gather(-1, rec)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gate, rec

        self.recorded = recorded
        self.moe.route = route

    def start(self, uid) -> None:
        if self.queue:
            raise AssertionError(f"{len(self.queue)} recorded routings "
                                 f"not replayed")
        self.queue = list(self.recorded[uid])

    def summary(self) -> dict:
        return {"decisions": self.decisions, "flips": len(self.flips),
                "flip_margins": sorted(self.flips),
                "max_flip_margin": max(self.flips, default=0.0)}


class CallRoutes(Routes):
    """``Routes`` for whole calls (a sharded call against its unsharded
    one, where a pack over other rows or a last-bit difference could
    route otherwise): ``recording()`` keeps one call's routings in
    order; ``forced(repeat)`` replays them onto another call whose
    routings come in the same order, each ``repeat`` times in a row (a
    sharded call routes once a device), with that call's own gates at
    the recorded experts, counting its own flips and their margins."""

    @contextlib.contextmanager
    def recording(self):
        self.log.clear()
        self.dropped.clear()
        self.tag = ("prefill", 0)
        self.record()
        try:
            yield
        finally:
            self.restore()

    @contextlib.contextmanager
    def forced(self, repeat: int):
        self.force()
        self.queue = [r for r in self.recorded.get(0, [])
                      for _ in range(repeat)]
        try:
            yield
        finally:
            self.restore()
        if self.queue:
            raise AssertionError(f"{len(self.queue)} recorded routings "
                                 f"not replayed")

    def dropped_frac(self) -> tuple:
        """(mean, max) dropped_frac over the recorded call's MoE layers."""
        d = [float(x) for _, x in self.dropped]
        return sum(d) / len(d), max(d)


def check_routes(tag: str, routes: Routes,
                 what: str = "the plain replay forced onto the served "
                 "path's experts") -> dict:
    """Every decision whose replayed top-k differs from the served one is
    a near tie: margin below ROUTE_TIE."""
    if routes.queue:
        raise AssertionError(f"{tag}: {len(routes.queue)} recorded "
                             f"routings not replayed")
    r = routes.summary()
    print(f"{tag} routes: {what}; its own top-k differs at {r['flips']} of "
          f"{r['decisions']} routing decisions, margins "
          f"{[f'{m:.2e}' for m in r['flip_margins'][-8:]]} (largest "
          f"{r['max_flip_margin']:.3e}; each must be below {ROUTE_TIE})",
          flush=True)
    if r["max_flip_margin"] >= ROUTE_TIE:
        raise AssertionError(f"{tag}: a route flip with margin "
                             f"{r['max_flip_margin']} is no near tie")
    return r


def hold(tag: str, check: dict, tol: float) -> None:
    print_check(tag, check, tol)
    if not check["max_abs_err"] <= tol:
        raise AssertionError(f"{tag}: served logits {check['max_abs_err']}"
                             f" from the plain path, tolerance {tol}")


def run_moe(torch, np, lm, ops, registry, Engine, Request, counters,
            dev) -> tuple:
    """Path moe: qwen3-moe-30b-a3b at full width, MOE_LAYERS of its 48
    layers, served by Engine (FAMILY_REQ prompts in LM_PROMPT,
    FAMILY_NEW greedy tokens each); every routing recorded (``Routes``)
    and the plain replay forced onto the served experts, its logits held
    at LM_TOL and its own flips near ties; dropped_frac per prefill;
    spans with the grouped expert contractions' share (``moe.experts``)."""
    from repro_torch.nn import moe
    tag = "[moe]"
    cfg, params = make_lm(torch, lm, registry, dev, tag,
                          "qwen3-moe-30b-a3b", MOE_LAYERS)
    prompts = lm_prompts(np, cfg.vocab, n=FAMILY_REQ)
    uid_of = {tuple(p): i for i, p in enumerate(prompts)}
    routes = Routes(moe)

    def on_prefill(tokens):
        routes.tag = ("prefill", uid_of[tuple(tokens[0].tolist())])

    def on_decode(rep):
        routes.tag = ("decode", [r.uid if r is not None else None
                                 for r in rep.slots])

    routes.record()
    try:
        counts, run, done, served, _ = serve_path(
            torch, np, Engine, Request, counters, dev, tag, cfg, params,
            prompts, FAMILY_NEW, on_prefill=on_prefill, on_decode=on_decode)
    finally:
        routes.restore()
    dropped = routes.dropped_by_prefill()
    print(f"{tag} dropped_frac per prefill (mean, max over {cfg.n_layers} "
          f"MoE layers): " + ", ".join(
              f"{len(prompts[u])} tokens: {m:.4f}, {x:.4f}"
              for u, (m, x) in sorted(dropped.items())), flush=True)
    routes.force()
    try:
        check = replay_plain(torch, np, lm, ops, cfg, params, dev, prompts,
                             done, served, FAMILY_NEW, before=routes.start)
    finally:
        routes.restore()
    hold(tag, check, LM_TOL)
    run["routes"] = check_routes(tag, routes)
    spans = lm_spans(torch, lm, cfg, params, dev, labels={
        "moe.experts": (moe, "experts")})
    print_spans(tag, spans)
    run.update(check=check, tolerance=LM_TOL, spans_ms=spans,
               dropped_frac_by_prefill=dropped, peak_gib=peak_gib(torch))
    print(f"{tag} peak memory {run['peak_gib']:.2f} GiB", flush=True)
    del params
    free_card(torch)
    return counts, run


def run_kv8(torch, np, lm, ops, registry, Engine, Request, counters, dev,
            params) -> tuple:
    """Path kv8: granite-3-8b at full width and depth with the int8 KV
    cache (``kv_bits=8``), on the ``lm`` path's weights, served by Engine
    (FAMILY_REQ prompts, FAMILY_NEW tokens). Held to the plain
    ``kv_bits=8`` replay: prefill logits within LM_TOL; each decode step
    (whose attention is the same tensor code on both sides, over codes
    that may differ by one where their inputs differ in the last bits)
    by the clear-margin token rule and a mean relative difference below
    KV8_MEAN_REL; the served and replayed caches' codes compared."""
    from repro_torch.nn import flash
    tag = "[kv8]"
    cfg, params = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                          params=params, kv_bits=8)
    prompts = lm_prompts(np, cfg.vocab, n=FAMILY_REQ)
    slot_of: dict = {}

    def on_decode(rep):
        for s, r in enumerate(rep.slots):
            if r is not None and slot_of.setdefault(r.uid, s) != s:
                raise AssertionError(f"{tag}: request {r.uid} moved slots")

    counts, run, done, served, rep = serve_path(
        torch, np, Engine, Request, counters, dev, tag, cfg, params,
        prompts, FAMILY_NEW, on_decode=on_decode)
    if rep.cache["k"].dtype != torch.int8 or len(set(slot_of.values())) \
            != len(prompts):
        raise AssertionError(f"{tag}: slots {slot_of}, cache "
                             f"{rep.cache['k'].dtype}")
    codes = {"differ": 0, "total": 0, "max_code_diff": 0,
             "scale_max_rel": 0.0}

    def after(uid, cache):
        n = len(prompts[uid]) + FAMILY_NEW - 1
        s = slot_of[uid]
        for k in ("k", "v"):
            d = (rep.cache[k][:, s, :n].to(torch.int32)
                 - cache[k][:, 0, :n]).abs()
            codes["differ"] += int((d > 0).sum())
            codes["total"] += d.numel()
            codes["max_code_diff"] = max(codes["max_code_diff"],
                                         int(d.max()))
            a, b = rep.cache[k + "_s"][:, s, :n], cache[k + "_s"][:, 0, :n]
            codes["scale_max_rel"] = max(codes["scale_max_rel"], float(
                ((a - b).abs() / b.abs()).max()))

    check = replay_plain(torch, np, lm, ops, cfg, params, dev, prompts,
                         done, served, FAMILY_NEW, after=after)
    print_check(tag, check, f"prefill {LM_TOL}, decode steps mean relative "
                f"{KV8_MEAN_REL}")
    print(f"{tag} served cache against the replay's: {codes['differ']} of "
          f"{codes['total']} codes differ (largest by {codes['max_code_diff']}"
          f"), scales within {codes['scale_max_rel']:.3e} relative; the "
          f"decode steps' mean relative logit difference at most "
          f"{check['step_mean_rel_max']:.3e}", flush=True)
    if not check["prefill_max_abs_err"] <= LM_TOL \
            or not check["step_mean_rel_max"] < KV8_MEAN_REL:
        raise AssertionError(f"{tag}: prefill {check['prefill_max_abs_err']}"
                             f" (tolerance {LM_TOL}), decode steps' mean "
                             f"relative {check['step_mean_rel_max']} "
                             f"(bound {KV8_MEAN_REL})")
    spans = lm_spans(torch, lm, cfg, params, dev, prefills=(), labels={
        "decode_grouped_q8": (flash, "decode_grouped_q8")})
    print_spans(tag, spans)
    run.update(check=check, codes=codes, spans_ms=spans,
               tolerance={"prefill": LM_TOL, "step_mean_rel": KV8_MEAN_REL},
               peak_gib=peak_gib(torch))
    print(f"{tag} peak memory {run['peak_gib']:.2f} GiB", flush=True)
    return counts, run


def model_level(torch, lm, ops, counters, tag: str, cfg, params, batch,
                n_new: int, routes: Routes | None = None) -> tuple:
    """A model-level path: ``lm.prefill`` on ``batch`` then ``n_new``
    greedy ``lm.decode_step`` calls (n_new + 1 tokens a row), the launch
    counters set to 0 just
    before and read just after (checked by ``lm_launches``), each call
    timed (prefill and steps to a synchronise, the steps' host issue);
    then the plain path on the card (``ops.set_default_backend("ref")``)
    teacher-forced on the served tokens, held by ``hold_logits``. With
    ``routes``, the served routings are recorded and the replay forced
    onto them. Returns (counts, run dict, held summary)."""
    B = batch["tokens"].shape[0]
    T = batch["tokens"].shape[1] + (batch["embeds"].shape[1]
                                    if "embeds" in batch else 0)
    size = T + n_new + 1
    for c in counters.values():
        c.reset()
    rows, toks, step_ms, issue_ms = [], [], [], []
    if routes is not None:
        routes.record()
    try:
        with torch.inference_mode():
            if routes is not None:
                routes.tag = ("prefill", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, batch, size)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            for i in range(n_new + 1):
                rows.append(logits.float().cpu())
                tok = logits.argmax(-1).to(torch.int32)
                toks.append(tok.cpu())
                if i == n_new:
                    break
                if routes is not None:
                    routes.tag = ("decode", [0])
                t0 = time.perf_counter()
                logits, cache = lm.decode_step(params, cfg, tok, cache)
                issue_ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        if routes is not None:
            routes.restore()
    counts = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want.update(lm_launches(cfg, 1, n_new))
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    del cache
    n_tok = B * (n_new + 1)
    wall = (pre_ms + sum(step_ms)) / 1e3
    step_med = sorted(step_ms)[n_new // 2]
    print(f"{tag} prefill of {B} rows x {T} positions {pre_ms:.1f} ms, then "
          f"{n_new} greedy decode steps: median {step_med:.2f} ms a step "
          f"to a synchronise, host issue median "
          f"{sorted(issue_ms)[n_new // 2]:.2f} ms; {n_tok / wall:.1f} "
          f"tokens/s; launches {_nonzero(counts)} = per prefill "
          f"{_nonzero(lm_launches(cfg, 1, 0))}, per decode step "
          f"{_nonzero(lm_launches(cfg, 0, 1))}", flush=True)
    if routes is not None:
        routes.force()
        routes.start(0)
    out = new_held()
    ops.set_default_backend("ref")
    try:
        with torch.inference_mode():
            logits, cache = lm.prefill(params, cfg, batch, size)
            want_rows = [logits.float().cpu()]
            for tok in toks[:-1]:
                logits, cache = lm.decode_step(params, cfg, tok.to(
                    logits.device), cache)
                want_rows.append(logits.float().cpu())
        del cache
    finally:
        ops.set_default_backend("auto")
        if routes is not None:
            routes.restore()
    for b in range(B):
        hold_logits(torch, f"{tag} row {b}", [w[b] for w in want_rows],
                    [r[b] for r in rows], [int(t[b]) for t in toks], out)
    run = {"arch": cfg.name, "layers": cfg.n_layers, "rows": B,
           "positions": T, "prefill_ms": pre_ms, "decode_steps": n_new,
           "step_ms_median": step_med,
           "step_issue_ms_median": sorted(issue_ms)[n_new // 2],
           "tokens_per_s": n_tok / wall}
    return counts, run, held_summary(out)


def run_vlm(torch, np, lm, ops, registry, counters, dev) -> tuple:
    """Path vlm: llava-next-34b at full width, VLM_LAYERS of its 60
    layers, at the model level (the reference's LmReplica cannot serve
    it): VLM_ROWS rows of its 2880 seeded patch embeddings and a
    VLM_PROMPT-token prompt, then FAMILY_NEW greedy steps, held at
    LM_TOL."""
    tag = "[vlm]"
    cfg, params = make_lm(torch, lm, registry, dev, tag, "llava-next-34b",
                          VLM_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (VLM_ROWS, VLM_PROMPT),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "embeds": torch.randn(VLM_ROWS, cfg.n_frontend_tokens,
                                   cfg.d_model, generator=gen, device=dev)}
    counts, run, check = model_level(torch, lm, ops, counters, tag, cfg,
                                     params, batch, FAMILY_NEW)
    hold(tag, check, LM_TOL)
    run.update(check=check, tolerance=LM_TOL, peak_gib=peak_gib(torch))
    print(f"{tag} peak memory {run['peak_gib']:.2f} GiB", flush=True)
    del params, batch
    free_card(torch)
    return counts, run


def run_encdec(torch, np, lm, ops, registry, counters, dev) -> tuple:
    """Path encdec: seamless-m4t-medium whole, at the model level:
    ENCDEC_ROWS rows of ENCDEC_SRC seeded source frames and an
    ENCDEC_PROMPT-token prompt, then FAMILY_NEW greedy steps, held at
    LM_TOL."""
    tag = "[encdec]"
    cfg, params = make_lm(torch, lm, registry, dev, tag,
                          "seamless-m4t-medium")
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (ENCDEC_ROWS, ENCDEC_PROMPT),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "src_embeds": torch.randn(ENCDEC_ROWS, ENCDEC_SRC, cfg.d_model,
                                       generator=gen, device=dev)}
    counts, run, check = model_level(torch, lm, ops, counters, tag, cfg,
                                     params, batch, FAMILY_NEW)
    hold(tag, check, LM_TOL)
    run.update(check=check, tolerance=LM_TOL, src_len=ENCDEC_SRC,
               peak_gib=peak_gib(torch))
    print(f"{tag} peak memory {run['peak_gib']:.2f} GiB", flush=True)
    del params, batch
    free_card(torch)
    return counts, run


def run_llama4(torch, np, lm, ops, registry, counters, dev) -> tuple:
    """``--only moe``: llama4-maverick-400b-a17b at full width, one group
    of its grouped layout (a dense layer and an MoE layer with all 128
    experts and the shared expert: 2 of 48 layers), at the model level:
    one row of LLAMA4_PROMPT tokens, then FAMILY_NEW greedy steps, the
    replay forced onto the served routes (as path moe), held at
    LM_TOL; peak memory printed."""
    from repro_torch.nn import moe
    tag = "[llama4]"
    cfg, params = make_lm(torch, lm, registry, dev, tag,
                          "llama4-maverick-400b-a17b",
                          registry.get("llama4-maverick-400b-a17b")
                          .moe_every)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, LLAMA4_PROMPT),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    routes = Routes(moe)
    counts, run, check = model_level(torch, lm, ops, counters, tag, cfg,
                                     params, batch, FAMILY_NEW, routes)
    hold(tag, check, LM_TOL)
    run.update(check=check, tolerance=LM_TOL,
               routes=check_routes(tag, routes),
               dropped_frac_prefill=routes.dropped_by_prefill(),
               peak_gib=peak_gib(torch))
    print(f"{tag} dropped_frac of the prefill (mean, max): "
          f"{run['dropped_frac_prefill']}; peak memory "
          f"{run['peak_gib']:.2f} GiB", flush=True)
    del params, batch
    free_card(torch)
    return counts, run


def train_launches(cfg, microbatches: int, recompute: bool) -> dict:
    """The forward kernels' launches of one train step: per microbatch
    the forward's (``lm_launches`` of one prefill) and, with remat, the
    checkpointed layers' again (all of it but the final norm)."""
    out = {}
    for k, v in lm_launches(cfg, 1, 0).items():
        again = (v - 1 if k == "rmsnorm" else v) if recompute and v else 0
        out[k] = microbatches * (v + again)
    return out


def _counts(counters) -> dict:
    return {k: c.value for k, c in counters.items()}


def _zero(counters) -> None:
    for c in counters.values():
        c.reset()


def _timed(torch, fn):
    """(fn's result, its wall ms to a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_route_check(torch, ops, steps, tree, counters, tag: str, cfg,
                      params, batch, n_mb: int) -> dict:
    """Step 0's loss and gradients twice on one weight set and batch:
    through the kernels (the launch counters set to 0 just before and
    read just after, held to ``train_launches``), then with every op on
    its plain version (``ops.set_default_backend("ref")``, no launch);
    the loss held within TRAIN_TOL relative, each gradient leaf's max
    |difference| within TRAIN_TOL x its max |value|."""
    _zero(counters)
    (g_k, m_k), k_ms = _timed(torch, lambda: steps.accumulate_grads(
        params, cfg, batch, n_mb))
    counts = _counts(counters)
    want = {k: 0 for k in counters}
    want.update(train_launches(cfg, n_mb, cfg.remat != "none"))
    if counts != want:
        raise AssertionError(f"{tag} launches {counts}, expected {want}")
    ops.set_default_backend("ref")
    try:
        (g_r, m_r), r_ms = _timed(torch, lambda: steps.accumulate_grads(
            params, cfg, batch, n_mb))
    finally:
        ops.set_default_backend("auto")
    if _counts(counters) != counts:
        raise AssertionError(f"{tag} the plain route launched a kernel")
    loss_k, loss_r = float(m_k["loss"]), float(m_r["loss"])
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    flat_r = dict(tree.flatten_with_path(g_r))
    worst, worst_leaf, finite = 0.0, None, True
    for path, gk in tree.flatten_with_path(g_k):
        gr = flat_r[path]
        finite &= bool(torch.isfinite(gk).all())
        ratio = float((gk - gr).abs().max()
                      / gr.abs().max().clamp(min=1e-30))
        if ratio >= worst:
            worst, worst_leaf = ratio, "|".join(map(str, path))
    gn_k = float(steps.opt_lib.global_norm(g_k))
    gn_r = float(steps.opt_lib.global_norm(g_r))
    del g_k, g_r
    print(f"{tag} step 0, {batch['tokens'].shape[0]} x "
          f"{tuple(batch['tokens'].shape[1:])} tokens: loss {loss_k!r} "
          f"through the kernels ({k_ms:.0f} ms, a first call; launches "
          f"{_nonzero(counts)}), {loss_r!r} all plain ({r_ms:.0f} ms): "
          f"relative {loss_rel:.3e}; worst gradient leaf {worst_leaf} "
          f"max|diff| / max|leaf| {worst:.3e} (tolerance {TRAIN_TOL}); "
          f"grad norm {gn_k!r} vs {gn_r!r}", flush=True)
    if not (finite and loss_rel <= TRAIN_TOL and worst <= TRAIN_TOL):
        raise AssertionError(f"{tag} step 0 differs from the plain route")
    return {"launches": counts, "kernel_ms": k_ms, "plain_ms": r_ms,
            "loss": loss_k, "loss_plain": loss_r, "loss_rel": loss_rel,
            "grad_worst_ratio": worst, "grad_worst_leaf": worst_leaf,
            "grad_norm": gn_k, "grad_norm_plain": gn_r,
            "tolerance": TRAIN_TOL}


def train_split(prof: dict) -> dict:
    """A profiled train step's device time by part: the plain backward
    recompute of each kernel and the optimizer (their labels' ranges),
    then, outside those ranges, the forward kernels #6, #11, #13 (first
    calls and remat recomputes), cuBLAS (names with "gemm") and the
    rest; each with its share of the kernels' summed time."""
    parts = {k: v[0] for k, v in prof["label_ms"].items()}
    fwd = {"#6 forward": "rmsnorm_kernel", "#11 forward": "mha_",
           "#13 forward": "ssd_"}
    for k in list(fwd) + ["cublas", "rest"]:
        parts[k] = 0.0
    for name, (ms, _) in prof["outside"].items():
        key = next((k for k, m in fwd.items() if m in name), None)
        if key is None:
            key = "cublas" if "gemm" in name.lower() else "rest"
        parts[key] += ms
    busy = prof["busy"] or float("nan")
    return {k: [v, v / busy] for k, v in parts.items()}


def train_profile(torch, tag: str, what: str, fn, labels: dict) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``profile_call``,
    no timed calls before it), split by ``train_split``."""
    prof = profile_call(torch, fn, top=8, reps=0, labels=labels)
    out = {"busy_ms": prof["busy"], "span_ms": prof["span"],
           "kernels": prof["kernels"], "top": prof["top"],
           "label_ms": prof.get("label_ms"),
           "split": train_split(prof) if prof["busy"] else None}
    if out["split"]:
        print(f"{tag} {what} under torch.profiler: kernels "
              f"{prof['busy']:.1f} ms busy over a {prof['span']:.1f} ms "
              f"span, {prof['kernels']} launches; by part (ms, share) "
              + ", ".join(f"{k} {v[0]:.1f} ({v[1]:.1%})"
                          for k, v in out["split"].items()), flush=True)
    else:
        print(f"{tag} torch.profiler recorded no kernel", flush=True)
    return out


def run_train(torch, np, lm, ops, registry, counters, dev) -> tuple:
    """Path train: a gradient step through the forward kernels under
    autograd (``kernels/autograd.py``), at full width.

    (a) granite-3-8b, TRAIN_LAYERS of 40 layers, remat "full":
    ``train_route_check`` on TokenStream's batch 0; TRAIN_STEPS adamw
    steps (``launch.steps.make_train_step``; step ms, tokens/s, peak);
    one gradient computation in each remat mode (peak, losses equal);
    one step under ``torch.profiler`` (``train_split``); one int8_adamw
    step (its state's bytes a parameter). (b) mamba2-130m whole at
    TRAIN_SSM: ``train_route_check`` (#13 under autograd). (c) granite-
    100m through ``train.loop.train``: SMALL_STEPS steps (the loss must
    drop by more than 0.5, the example's assertion), then a restart from
    the step-SMALL_CKPT checkpoint in a fresh state, its losses within
    RESTART_TOL relative of the uninterrupted run's. Each run's launches
    are held to ``train_launches``. Returns (the launches of (a)'s steps,
    (b)'s kernel route and (c)'s uninterrupted run, the run dict)."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers
    from repro_torch.train.loop import TrainConfig, train
    tag = "[train]"
    t_path = time.perf_counter()
    run: dict = {}
    total = {k: 0 for k in counters}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def batch_of(cfg, rows, seq, n_mb, index):
        b = TokenStream(vocab=cfg.vocab, seq_len=seq, batch=rows, seed=0,
                        microbatches=n_mb).batch_at(index)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # (a) granite-3-8b at full width
    cfg, params = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                          TRAIN_LAYERS, remat="full")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{tag} reckoning: {n_params / 1e9:.3f} B parameters x 16 B "
          f"(float32 weights, gradients, adamw's two moments) = "
          f"{n_params * 16 / 1e9:.1f} GB, plus activations; batch "
          f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens in {TRAIN_MB} microbatches",
          flush=True)
    a = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
         "rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "microbatches": TRAIN_MB}
    b0 = batch_of(cfg, TRAIN_ROWS, TRAIN_SEQ, TRAIN_MB, 0)
    a["step0"] = train_route_check(torch, ops, steps, tree, counters, tag,
                                   cfg, params, b0, TRAIN_MB)
    modes = {}
    for mode in ("none", "full", "dots", "group"):
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        (g, m), ms = _timed(torch, lambda: steps.accumulate_grads(
            params, dataclasses.replace(cfg, remat=mode), b0, TRAIN_MB))
        modes[mode] = {"loss": float(m["loss"]), "ms": ms,
                       "peak_gib": peak_gib(torch),
                       "launches": _counts(counters)}
        del g
        print(f"{tag} remat {mode}: forward + backward of both "
              f"microbatches {ms:.0f} ms, peak {modes[mode]['peak_gib']:.2f}"
              f" GiB, loss {modes[mode]['loss']!r}, launches "
              f"{_nonzero(modes[mode]['launches'])}", flush=True)
    if len({v["loss"] for v in modes.values()}) != 1:
        raise AssertionError(f"{tag} remat modes' losses differ: {modes}")
    a["remat"] = modes
    free_card(torch)
    opt = optimizers.adamw(lr=TRAIN_LR)
    step_fn = steps.make_train_step(cfg, opt, TRAIN_MB)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        b = batch_of(cfg, TRAIN_ROWS, TRAIN_SEQ, TRAIN_MB, i)
        (params, state, m), ms = _timed(
            torch, lambda: step_fn(params, state, i, b))
        step_ms.append(ms)
        losses.append(float(m["loss"]))
    counts = _counts(counters)
    want = {k: 0 for k in counters}
    want.update({k: TRAIN_STEPS * v for k, v in train_launches(
        cfg, TRAIN_MB, True).items()})
    if counts != want or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} steps: launches {counts}, expected "
                             f"{want}; losses {losses}")
    add(counts)
    med = statistics.median(step_ms[1:])
    a.update(step_ms=step_ms, step_ms_median=med, losses=losses,
             tokens_per_s=TRAIN_ROWS * TRAIN_SEQ / med * 1e3,
             peak_gib=peak_gib(torch), launches=counts)
    print(f"{tag} {TRAIN_STEPS} adamw steps (lr {TRAIN_LR}): ms "
          f"{[round(x, 1) for x in step_ms]}, median after the first "
          f"{med:.1f} ms, {a['tokens_per_s']:.0f} tokens/s; losses "
          f"{losses}; peak {a['peak_gib']:.2f} GiB; launches "
          f"{_nonzero(counts)} = {TRAIN_STEPS} x "
          f"{_nonzero(train_launches(cfg, TRAIN_MB, True))}", flush=True)
    holder = [params, state]

    def one_step():
        holder[0], holder[1], m = step_fn(holder[0], holder[1], TRAIN_STEPS,
                                          b0)
        float(m["loss"])
    # each kernel's plain backward recompute and the optimizer, labelled
    labels = {"#6 backward (plain)": (kgrad, "rmsnorm_backward"),
              "#11 backward (plain)": (kgrad, "mha_backward"),
              "#13 backward (plain)": (kgrad, "ssd_scan_backward"),
              "optimizer": (steps, "apply_optimizer")}

    def labelled(*names):
        return {k: labels[k] for k in names}
    a["profile"] = train_profile(
        torch, tag, "one adamw step", one_step,
        labelled("#6 backward (plain)", "#11 backward (plain)", "optimizer"))
    params, state = holder
    del holder, state
    free_card(torch)
    opt8 = optimizers.int8_adamw(lr=TRAIN_LR)
    state8 = opt8.init(params)
    bpp = sum(t.numel() * t.element_size()
              for t in tree.leaves(state8)) / n_params
    (params, state8, m8), ms8 = _timed(torch, lambda: steps.make_train_step(
        cfg, opt8, TRAIN_MB)(params, state8, 0, b0))
    a["int8_adamw"] = {"state_bytes_per_param": bpp, "step_ms": ms8,
                       "loss": float(m8["loss"])}
    print(f"{tag} int8_adamw: state {bpp:.4f} bytes a parameter (adamw 8), "
          f"one step {ms8:.0f} ms, loss {a['int8_adamw']['loss']!r}",
          flush=True)
    if not np.isfinite(a["int8_adamw"]["loss"]):
        raise AssertionError(f"{tag} int8_adamw step: {a['int8_adamw']}")
    del params, state8, b0
    free_card(torch)
    run["granite"] = a

    # (b) mamba2-130m whole: #13 under autograd
    cfg, params = make_lm(torch, lm, registry, dev, tag, "mamba2-130m")
    rows, seq = TRAIN_SSM
    bm = batch_of(cfg, rows, seq, 1, 0)
    chk = train_route_check(torch, ops, steps, tree, counters, tag, cfg,
                            params, bm, 1)
    add(chk["launches"])
    run["mamba2"] = {"arch": cfg.name, "rows": rows, "seq": seq,
                     "remat": cfg.remat, "step0": chk,
                     "peak_gib": peak_gib(torch)}
    run["mamba2"]["profile"] = train_profile(
        torch, tag, f"{cfg.name}'s forward + backward",
        lambda: float(steps.accumulate_grads(params, cfg, bm, 1)[1]["loss"]),
        labelled("#6 backward (plain)", "#13 backward (plain)"))
    del params, bm
    free_card(torch)

    # (c) granite-100m: examples/train_lm.py's run, then a restart
    cfg = dataclasses.replace(
        registry.GRANITE_3_8B, name="granite-100m", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1536, vocab=8192,
        remat="none", attn_chunk=256)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        tc = TrainConfig(steps=SMALL_STEPS, ckpt_dir=str(d / "full"),
                         ckpt_every=SMALL_CKPT, log_every=50, **SMALL_TC)
        _zero(counters)
        full, full_ms = _timed(torch, lambda: train(cfg, tc, device=dev))
        counts = _counts(counters)
        want = {k: 0 for k in counters}
        want.update({k: SMALL_STEPS * v for k, v in train_launches(
            cfg, tc.microbatches, False).items()})
        if counts != want:
            raise AssertionError(f"{tag} granite-100m launches {counts}, "
                                 f"expected {want}")
        add(counts)
        restart = d / "restart"
        shutil.copytree(d / "full" / f"step_{SMALL_CKPT:08d}",
                        restart / f"step_{SMALL_CKPT:08d}")
        tc2 = dataclasses.replace(tc, ckpt_dir=str(restart))
        again, again_ms = _timed(torch, lambda: train(cfg, tc2, device=dev))
    hist, hist2 = full["loss_history"], again["loss_history"]
    tail = hist[SMALL_CKPT:]
    rel = max(abs(x - y) / abs(y) for x, y in zip(hist2, tail))
    tokens = SMALL_STEPS * tc.batch * tc.seq_len
    c = {"arch": cfg.name, "params": sum(
        t.numel() for t in _leaves(full["final_state"].params)),
        "steps": SMALL_STEPS, **SMALL_TC, "first_loss": hist[0],
        "last_loss": hist[-1], "seconds": full_ms / 1e3,
        "tokens_per_s": tokens / full_ms * 1e3, "launches": counts,
        "restart_from": SMALL_CKPT, "restart_seconds": again_ms / 1e3,
        "restart_max_rel": rel, "restart_bit_equal": hist2 == tail}
    print(f"{tag} {cfg.name} ({c['params'] / 1e6:.1f} M parameters): "
          f"{SMALL_STEPS} steps of {tc.batch} x {tc.seq_len} in "
          f"{c['seconds']:.1f} s ({c['tokens_per_s']:.0f} tokens/s), loss "
          f"{hist[0]!r} -> {hist[-1]!r} (uniform {np.log(cfg.vocab):.3f}); "
          f"launches {_nonzero(counts)}; restarted from step {SMALL_CKPT} "
          f"in a fresh state: {len(hist2)} losses, max relative "
          f"difference {rel:.3e} (tolerance {RESTART_TOL}), bit-equal "
          f"{c['restart_bit_equal']}", flush=True)
    if not (hist[-1] < hist[0] - 0.5 and len(hist2) == len(tail)
            and rel <= RESTART_TOL):
        raise AssertionError(f"{tag} granite-100m: {c}")
    run["granite_100m"] = c
    del full, again
    free_card(torch)
    run["seconds"] = time.perf_counter() - t_path
    print(f"{tag} path train took {run['seconds']:.1f}s", flush=True)
    return total, run


def _held(st) -> int:
    """The positions that hold one block of a ``ShardedTensor`` (its
    spec's cut axes divide the mesh)."""
    from repro_torch.dist import sharding
    n = len(st.shards)
    cut = 1
    for ax in st.spec:
        if ax is not None:
            for a in sharding._axes(ax):
                cut *= st.mesh.shape[a]
    return n // cut


def _on_model(st) -> bool:
    from repro_torch.dist import sharding
    return any(ax is not None and "model" in sharding._axes(ax)
               for ax in st.spec)


def _model_axis(spec) -> int | None:
    """The axis a spec cuts over ``model``, or None."""
    from repro_torch.dist import sharding
    for i, ax in enumerate(spec):
        if ax is not None and "model" in sharding._axes(ax):
            return i
    return None


def _replays(cfg, kind: str, part: str = "decoder") -> int:
    """How often a call runs a block's forward: a train step's
    checkpointed blocks twice (``full``, ``dots``), the decoder layers
    of the attention families three times under ``group`` (the group's
    recompute, then each layer's); zamba2's shared block is never
    checkpointed, the encoder's layers as ``full`` under ``group``."""
    if kind != "train" or cfg.remat == "none" or part == "shared":
        return 1
    grouped = cfg.family == "moe" and cfg.moe_every > 1
    if part == "decoder" and cfg.remat == "group" and cfg.family in (
            "dense", "vlm", "moe", "encdec") and not grouped \
            and cfg.scan_layers:
        return 3
    return 2


def sharded_launches(cfg, sp, kind: str, n_mb: int = 1,
                     steps: int = 1) -> dict:
    """#6, #11, #12 and #13 launches of one sharded call, from the mesh
    and the plan: every position runs its layers' norms (2 a layer;
    post-norms 4 more, QK-norm 2 more, an encdec decoder layer's ``ln_x``
    1 more; an SSM layer's ``ln`` and mixer norm; zamba2's shared block 2
    a call) and its attention (an encdec decoder layer's self- and
    cross-attention; the shared block's; none in an int8 cache's decode
    step, whose attention is tensor code) or mixer on its heads or data
    shard, its encoder layers' 2 norms and attention and ``enc_norm`` in
    forward and prefill, a train step's checkpointed blocks again
    (``_replays``); the final norm at every position where the head is
    vocab-sharded, else once a data group."""
    n = len(sp["embed"]["table"].shards)
    tp = sp["embed"]["table"].mesh.shape.get("model", 1)
    dp = n // tp
    head = sp["embed"]["table"] if cfg.tie_embeddings else sp["lm_head"]["w"]
    final = n if (tp > 1 and _on_model(head)) else dp
    L = cfg.n_layers
    dec, enc = _replays(cfg, kind), _replays(cfg, kind, "encoder")
    fwd = kind != "decode"
    att = "mha" if fwd else "decode_attention"
    out = {"rmsnorm": 0, "mha": 0, "decode_attention": 0, "ssd_scan": 0}
    if cfg.family in ("ssm", "hybrid"):
        calls = -(-L // cfg.shared_attn_every) \
            if cfg.family == "hybrid" else 0
        out["rmsnorm"] = n * L * 2 * dec + n * calls * 2
        out["ssd_scan"] = n * L * dec if fwd else 0
        out[att] = n * calls
    else:
        norms = 2 + (4 if cfg.post_norm else 0) \
            + (2 if cfg.qk_norm else 0) + (1 if cfg.is_encdec else 0)
        out["rmsnorm"] = n * L * norms * dec
        per = 2 if cfg.is_encdec else 1
        if fwd or cfg.kv_bits != 8:
            out[att] = n * L * per * dec
        if cfg.is_encdec and fwd:
            out["rmsnorm"] += n * cfg.n_enc_layers * 2 * enc + n
            out["mha"] += n * cfg.n_enc_layers * enc
    reps = n_mb if kind == "train" else steps if kind == "decode" else 1
    return {k: reps * (v + (final if k == "rmsnorm" else 0))
            for k, v in out.items()}


def _moe_layer(cfg, i: int) -> bool:
    return cfg.family == "moe" and (cfg.moe_every <= 1
                                    or i % cfg.moe_every == cfg.moe_every - 1)


def opt_transfers(opt_name: str, sp, state) -> dict:
    """The optimizer's labelled transfers of a sharded step, leaf by leaf
    from the layouts: adafactor, for a leaf cut over ``model``, an
    all-reduce of its row mean of g² (cut on its last axis) or of its
    column mean (on its second to last) and then of the mean of ``vr``,
    and of its rms (4 bytes); for each of its statistics laid out
    otherwise than the leaf's blocks read it (``vr`` at the parameter's
    dims but the last, ``vc`` at all but the second to last), an
    all-gather of it on the way in where it is stored cut, and on the
    way out where the blocks' layout is cut. int8_adamw: two all-reduces
    (the maxima of m and of v) of the group absmax where a leaf's groups
    straddle its shards. None for adamw and sgd."""
    from collections import Counter
    from repro_torch.optim import optimizers
    from repro_torch.tree import flatten_with_path
    want: Counter = Counter()
    if opt_name not in ("adafactor", "int8_adamw"):
        return {}

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree
    for path, st in flatten_with_path(sp):
        nd, cut = st.ndim, _model_axis(st.spec)
        if opt_name == "int8_adamw":
            g = optimizers._qgroup(tuple(st.shape))
            if cut == nd - 1 and st.shards[0].shape[-1] % g:
                want[("all-reduce", math.prod(st.shape[:-1])
                      * (st.shape[-1] // g) * 4)] += 2
            continue
        f = at(state["f"], path)
        sp_ = tuple(st.spec) + (None,) * (nd - len(st.spec))
        lay = {"v": sp_} if nd < 2 else {"vr": sp_[:-1],
                                         "vc": sp_[:-2] + sp_[-1:]}
        for name, spec in lay.items():
            short = list(spec)
            while short and short[-1] is None:
                short.pop()
            if tuple(f[name].spec) != tuple(short):
                whole = math.prod(f[name].shape) * 4
                if _model_axis(f[name].spec) is not None:
                    want[("all-gather", whole)] += 1
                if _model_axis(spec) is not None:
                    want[("all-gather", whole)] += 1
        if cut is None:
            continue
        if nd >= 2:
            kept = st.shape[:-1] if cut == nd - 1 \
                else st.shape[:-2] + st.shape[-1:]
            want[("all-reduce", math.prod(kept) * 4)] += 1
            if cut == nd - 2:
                want[("all-reduce", math.prod(st.shape[:-2]) * 4)] += 1
        want[("all-reduce", 4)] += 1
    return dict(want)


def sharded_transfers(cfg, sp, kind: str, rows: int, T: int,
                      n_mb: int = 1, steps: int = 1, src: int = 0,
                      opt_name: str = "adamw", state=None) -> dict:
    """The labelled transfers of one sharded call, (kind, bytes) → count,
    derived from the plan's specs: the embedding's all-reduce where the
    table is vocab-sharded; a layer's all-reduce where ``wo`` is cut
    over ``model`` and where ``down`` is (an MLP's, or an MoE layer's
    shared expert's), an encdec decoder layer's cross-attention's
    (its ``wo``), zamba2's two a shared-block call; an all-gather of
    the q projection and of each kv projection where it is cut within
    heads (a cross-attention's kv of the ``src`` encoder rows, in forward
    and prefill); an encoder
    layer's two all-reduces of its ``src`` rows; an MoE layer's
    all-gather of its input rows over the data groups (the whole batch
    at each position) where there are several; the logits' all-gather
    over ``model`` where the head is vocab-sharded; the loss's
    all-reduce (8 bytes) and the whole logits' all-gather over the data
    groups where there are several. A train step also runs a
    checkpointed block's collectives again (``_replays``), every forward
    collective's adjoint (an all-gather a reduce-scatter), one gradient
    all-reduce a leaf held by more than one position, the global norm's
    (4 bytes) and ``opt_transfers`` of its optimizer and ``state``."""
    from collections import Counter
    from repro_torch.tree import leaves
    first = sp["embed"]["table"]
    n = len(first.shards)
    tp = first.mesh.shape.get("model", 1)
    dp = n // tp
    d, V = cfg.d_model, cfg.vocab
    head = sp["embed"]["table"] if cfg.tie_embeddings else sp["lm_head"]["w"]
    r = rows // dp
    kvc = cfg.n_kv_heads * cfg.head_dim * 4
    lay = sp["layers"]
    blocks = {"dense": lay["dense"], "moe": lay["moe"]} \
        if "dense" in lay else {"moe" if "moe" in lay else "dense": lay}

    def attn(at, t):            # an attention's: q, kv gathers, wo's sum
        out = Counter()
        if tp > 1 and _on_model(at["wq"]["w"]) and cfg.n_heads % tp:
            out[("all-gather", r * t * cfg.n_heads * cfg.head_dim * 4)] += 1
        if tp > 1 and _on_model(at["wk"]["w"]) and cfg.n_kv_heads % tp:
            out[("all-gather", r * t * kvc)] += 2
        if tp > 1 and _on_model(at["wo"]["w"]):
            out[("all-reduce", r * t * d * 4)] += 1
        return out

    def mlp(m, t):
        out = Counter()
        if tp > 1 and m is not None and _on_model(m["down"]["w"]):
            out[("all-reduce", r * t * d * 4)] += 1
        return out

    def once(t):        # (outer, layers, encoder, shared, MoE rows) a pass
        outer, layer, enc, shared, rows_dp = (Counter() for _ in range(5))
        if tp > 1 and _on_model(sp["embed"]["table"]):
            outer[("all-reduce", r * t * d * 4)] += 1
        if cfg.family == "hybrid":
            for _ in range(-(-cfg.n_layers // cfg.shared_attn_every)):
                shared += attn(sp["shared"]["attn"], t) \
                    + mlp(sp["shared"]["mlp"], t)
        for i in range(cfg.n_layers if cfg.family not in (
                "ssm", "hybrid") else 0):
            blk = blocks["moe" if _moe_layer(cfg, i) else "dense"]
            layer += attn(blk["attn"], t)
            if cfg.is_encdec:
                xa = attn(blk["xattn"], t)
                if kind == "decode":        # k and v read from the cache
                    xa.pop(("all-gather", r * t * kvc), None)
                elif ("all-gather", r * t * kvc) in xa:
                    xa.pop(("all-gather", r * t * kvc))
                    layer[("all-gather", r * src * kvc)] += 2
                layer += xa
            layer += mlp(blk["mlp"] if "mlp" in blk else
                         blk["moe"]["shared"] if "shared" in blk.get(
                             "moe", {}) else None, t)
            if "moe" in blk and dp > 1:
                rows_dp[("all-gather", rows * t * d * 4)] += 1
        if cfg.is_encdec and kind != "decode":
            el = sp["enc_layers"]
            for _ in range(cfg.n_enc_layers):
                enc += attn(el["attn"], src) + mlp(el["mlp"], src)
        if tp > 1 and _on_model(head):
            outer[("all-gather", r * (t if kind == "train" else 1)
                   * V * 4)] += 1
        return outer, layer, enc, shared, rows_dp

    out = Counter()
    if kind == "train":
        outer, layer, enc, shared, rows_dp = once(T)
        adj = Counter()
        for (k, b), c in (outer + layer + enc + shared).items():
            adj[("reduce-scatter", b // tp) if k == "all-gather"
                else (k, b)] += c
        for (k, b), c in rows_dp.items():
            adj[("reduce-scatter", b // dp)] += c
        per_mb = outer + shared + adj
        for part, again in ((layer + rows_dp, _replays(cfg, kind)),
                            (enc, _replays(cfg, kind, "encoder"))):
            per_mb += Counter({k: v * again for k, v in part.items()})
        if dp > 1:
            per_mb[("all-reduce", 8)] += 2
        for k, v in per_mb.items():
            out[k] += n_mb * v
        for st in leaves(sp):
            if _held(st) > 1:
                out[("all-reduce", st.shards[0].numel() * 4)] += 1
        if n > 1:
            out[("all-reduce", 4)] += 1
        for k, v in opt_transfers(opt_name, sp, state).items():
            out[k] += v
        return dict(out)
    for s in range(steps):
        outer, layer, enc, shared, rows_dp = once(
            T if kind == "prefill" else 1)
        out += outer + layer + enc + shared + rows_dp
        if dp > 1:
            out[("all-gather", rows * V * 4)] += 1
    return dict(out)


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _whole(st):
    from repro_torch.dist.sharding import ShardedTensor
    return st.gather() if isinstance(st, ShardedTensor) else st


def _state_check(torch, s_a, s_b, loose: str | None = None) -> dict:
    """The worst leaf of optimizer state ``s_a`` (gathered where sharded)
    against ``s_b``'s (which may be held on the host), by kind of
    statistic, as (ratio, leaf): max |difference| over max |value| of
    adamw's first moment and of the square root of its second (``v``
    itself doubles the gradient's relative difference), of the square
    roots of adafactor's ``vr``, ``vc`` and ``v``, of int8_adamw's
    scales (``v``'s square-rooted); and int8_adamw's codes, each
    dequantized moment's |difference| in scale steps (the larger scale
    plus 127 times the scales' difference): a code may round the other
    way where its input differs in the last bits. Leaves whose path
    holds ``loose`` are read apart, under their kind + `` (loose)``."""
    from repro_torch.tree import flatten_with_path
    out: dict = {}

    def note(kind, path, ratio):
        key = "|".join(map(str, path))
        if loose is not None and loose in key:
            kind += " (loose)"
        if ratio >= out.get(kind, (-1.0, None))[0]:
            out[kind] = (ratio, key)
    flat_a, flat_b = dict(flatten_with_path(s_a)), dict(
        flatten_with_path(s_b))
    for path, st in flat_a.items():
        a = _whole(st)
        b = _whole(flat_b[path]).to(a.device)
        if path[0] == "f":
            note(path[-1], path, _rel(torch.sqrt(a), torch.sqrt(b)))
        elif path[-1] == "q":
            continue
        elif path[-1] == "s":
            f = torch.sqrt if path[0] == "v" else (lambda t: t)
            note(path[0] + "_scale", path, _rel(f(a), f(b)))
            qa = _whole(flat_a[path[:-1] + ("q",)])
            qb = _whole(flat_b[path[:-1] + ("q",)]).to(a.device)
            g = qa.shape[-1] // a.shape[-1]
            sa, sb = (torch.repeat_interleave(x.double(), g, dim=-1)
                      for x in (a, b))
            step = torch.maximum(sa, sb) + 127 * (sa - sb).abs()
            note("codes", path[:-1], float(((qa.double() * sa - qb.double()
                                              * sb).abs() / step).max()))
        else:
            f = torch.sqrt if path[0] == "v" else (lambda t: t)
            note(path[0], path, _rel(f(a), f(b)))
    return out


def _held_to(state: dict, tol: float, loose_tol: float) -> bool:
    """``_state_check``'s worst within ``tol`` (a ``loose`` leaf within
    ``loose_tol``; codes within one scale step)."""
    return all(r <= (1.0 if k == "codes" else loose_tol if "loose" in k
                     else tol) for k, (r, _) in state.items())


def _fmt_state(state: dict) -> str:
    return ", ".join(f"{k} {r:.3e} ({leaf})" for k, (r, leaf) in
                     sorted(state.items()))


def _split_sums_check(torch, lm, cfg, params, mb, groups: int,
                      parts: int) -> tuple:
    """The sums of the sharded step where the ``model`` positions each
    run a replicated stack and read one vocab block of the head (the SSM
    family), taken in unsharded code: the unsharded loss's gradients of
    microbatch ``mb`` as the sum over ``groups`` row blocks (the data
    groups) of ``parts`` backward passes each, one from the logits'
    cotangent on each vocab block, against one backward pass of the
    whole microbatch. (the worst leaf's max |difference| / max |value|,
    the leaf)."""
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    pg = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = leaves(pg)

    def grads(batch, split: bool, tokens):
        logits, _ = lm.forward(pg, cfg, batch)
        nll, _ = lm._nll_sums(cfg, logits, batch["labels"])
        (cot,) = torch.autograd.grad(nll / tokens, logits,
                                     retain_graph=True)
        n = logits.shape[-1] // parts
        cuts = [(j * n, (j + 1) * n) for j in range(parts)] if split \
            else [(0, logits.shape[-1])]
        out = []
        for j, (lo, hi) in enumerate(cuts):
            part = torch.zeros_like(cot)
            part[..., lo:hi] = cot[..., lo:hi]
            out.append(torch.autograd.grad(
                logits, flat, grad_outputs=part,
                retain_graph=j < len(cuts) - 1, allow_unused=True))
        return out

    def total(gs):
        return [sum(g[i] for g in gs if g[i] is not None)
                if any(g[i] is not None for g in gs) else None
                for i in range(len(flat))]
    tokens = float((mb["labels"] >= 0).sum())
    whole = total(grads(mb, False, tokens))
    r = mb["tokens"].shape[0] // groups
    split = total([g for k in range(groups) for g in grads(
        {key: v[k * r:(k + 1) * r] for key, v in mb.items()}, True,
        tokens)])
    paths = [path for path, _ in flatten_with_path(pg)]
    return max((_rel(a, b), "|".join(map(str, path)))
               for path, a, b in zip(paths, split, whole) if b is not None)


def _update_check(torch, p_old, p_new, state, step: int) -> tuple:
    """Each gathered parameter of a sharded adamw step (SHARD_ADAMW, lr
    TRAIN_LR) against p_old + the update its own gathered moments give,
    in the optimizer's float32 arithmetic: (the worst max |difference| /
    (SHARD_TOL x lr + float32 eps x |parameter|), its leaf, its max
    |difference|). A block skipped, updated twice or by another
    position's moments is off by about lr x |update| (> 1e-4 x lr
    wherever weight decay acts)."""
    from repro_torch.tree import flatten_with_path
    a = SHARD_ADAMW
    old = dict(flatten_with_path(p_old))
    ms, vs = (dict(flatten_with_path(state[k])) for k in ("m", "v"))
    worst = (0.0, None, 0.0)
    for path, st in flatten_with_path(p_new):
        p = old[path]
        t = torch.tensor(step, device=p.device).to(torch.float32) + 1.0
        c1, c2 = 1 - a["b1"] ** t, 1 - a["b2"] ** t
        u = (ms[path].gather() / c1) / (torch.sqrt(vs[path].gather() / c2)
                                        + a["eps"]) + a["weight_decay"] * p
        worst = _worse(torch, worst, path, st.gather(), p + (-TRAIN_LR * u))
    return worst


def _worse(torch, worst: tuple, path, got, want) -> tuple:
    diff = (got - want).abs()
    ratio = float((diff / (SHARD_TOL * TRAIN_LR + torch.finfo(
        torch.float32).eps * want.abs())).max())
    if ratio >= worst[0]:
        return (ratio, "|".join(map(str, path)), float(diff.max()))
    return worst


def _rule_check(torch, opt, p_old, p_new, state_old, grads,
                step: int) -> tuple:
    """Each gathered parameter of a sharded adafactor or int8_adamw step
    against its own rule: p_old + the optimizer's unsharded update of
    the step's own gradients (``grads``: the sharded step's, gathered,
    clipped) and the old state (gathered), in float32 on the card; as
    ``_update_check``. A lockstep reduction that missed a block, or a
    group or statistic cut another way, moves the update by far more
    than 1e-4 x lr."""
    from repro_torch.optim import optimizers
    from repro_torch.tree import flatten_with_path, tree_map
    upd, _ = opt.update(grads, state_old, p_old, step)
    want = dict(flatten_with_path(tree_map(optimizers.apply_update, p_old,
                                           upd)))
    worst = (0.0, None, 0.0)
    for path, st in flatten_with_path(p_new):
        worst = _worse(torch, worst, path, st.gather(), want[path])
    return worst


def _trace_of(torch, fn) -> tuple:
    """(fn's result, its labelled transfers (kind, bytes) → count): each
    ``roofline.trace.transfer`` range fn opens, counted as it opens. These
    are the ranges a ``torch.profiler`` trace of fn holds (the CPU tests
    read them so); a profiler here would build a tree of every op of the
    call, about 9 s a sharded zamba2 or mamba2 step on the host of an
    NVIDIA H100 80GB HBM3 machine."""
    from collections import Counter
    from repro_torch.roofline import trace
    got: Counter = Counter()
    label = trace.transfer

    def counting(kind, nbytes):
        got[(kind, int(nbytes))] += 1
        return label(kind, nbytes)
    trace.transfer = counting
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        trace.transfer = label
    return out, dict(got)


def _fmt(transfers: dict) -> str:
    return ", ".join(f"{k} {b} B x {c}" for (k, b), c in
                     sorted(transfers.items()))


def _mean_rel(a, b) -> float:
    """mean |a - b| over mean |b| (the int8 cache's decode rule)."""
    return float((a - b).abs().mean() / b.abs().mean().clamp(min=1e-30))


def _codes_differ(torch, a, b) -> tuple:
    """(codes that differ, the largest difference) of two int8 caches'
    codes."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int((d > 0).sum()), int(d.max())


def run_sharded(torch, np, lm, registry, counters, dev) -> tuple:
    """Path sharded: the LM train, prefill and decode steps over a
    (data, model) mesh of positions on ``cuda_devices()`` (one card:
    every position names cuda:0), through ``launch.steps`` on
    ``place_params`` trees (``dist/spmd.py``). (a) granite-3-8b at full
    width, TRAIN_LAYERS layers, on SHARD_MESH: one adamw step of
    TRAIN_ROWS x TRAIN_SEQ in TRAIN_MB microbatches (remat full), one
    prefill of SHARD_PREFILL x TRAIN_SEQ, SHARD_DECODE decode steps;
    (b) mamba2-130m whole on SHARD_SSM_MESH, one adamw step of TRAIN_SSM;
    (c) qwen3-moe-30b-a3b at full width, SHARD_MOE_LAYERS layers, on
    SHARD_MESH: the calls of (a), every routing of each unsharded call
    recorded and forced onto the sharded calls (``CallRoutes``; their
    own flips held to margins below ROUTE_TIE), the unsharded step's
    results moved to the host before the sharded one runs; (d)
    zamba2-1.2b at full width, SHARD_HYBRID_LAYERS layers (two
    shared-block calls), on SHARD_MESH: one adamw step of SHARD_SMALL
    (remat full), a prefill of SHARD_PREFILL x SHARD_SMALL's length,
    SHARD_DECODE decode steps; (e) seamless-m4t-medium whole on
    SHARD_MESH, the calls of (d) over as many source frames; (f)
    granite-3-8b at ``kv_bits=8`` on (a)'s weights: (a)'s prefill and
    decode steps, the decode logits and the decoded cache's scales held
    by KV8_MEAN_REL and the int8 codes counted (each within one); (g) granite-3-8b at ``remat="group"`` on (a)'s
    weights: one adafactor step of (a)'s shape on SHARD_MESH and one
    int8_adamw step on SHARD_INT8_MESH.
    Each sharded call runs under ``torch.profiler`` with the launch
    counters set to 0 just before it: its launches and transfers are
    held to ``sharded_launches``/``sharded_transfers``, its outputs to
    the unsharded step's and to the same sharded call on the plain
    versions (``ops.set_default_backend("ref")``, no launch) on the same
    inputs (loss and grad norm relative, the optimizer state
    (``_state_check``), logits and caches max |diff| / max |value|,
    within SHARD_TOL; mamba2's state within SSM_TOL, zamba2's mixer
    leaves' too), each parameter's update to the one its gathered
    moments give (adamw, ``_update_check``) or its optimizer's own rule
    on the step's gathered gradients (``_rule_check``). The unsharded
    step is also run with its microbatches cut into the data groups'
    rows (not for the MoE model, whose capacity is the call's) and on
    the plain versions, and mamba2's gradients are also summed as the
    sharded step sums them (``_split_sums_check``): each against the
    unsharded step is printed as the spread of a summation order with
    no sharding code in it. A second call of each is timed beside the
    unsharded one's second call; peak memory; the step's analytic FLOPs
    as a share of the fp32 peak. Returns (launches, run dict)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.nn import moe
    from repro_torch.optim import optimizers
    from repro_torch.roofline import analysis
    from repro_torch.tree import tree_map
    tag = "[sharded]"
    t_path = time.perf_counter()
    run: dict = {}
    total = {k: 0 for k in counters}
    card = smi()
    n_dev = len({str(d) for d in positions(math.prod(SHARD_MESH))})

    def batch_of(cfg, rows, seq, n_mb, index):
        b = TokenStream(vocab=cfg.vocab, seq_len=seq, batch=rows, seed=0,
                        microbatches=n_mb).batch_at(index)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if cfg.is_encdec:           # as many source frames as tokens
            g = torch.Generator(device=dev).manual_seed(index)
            b["src_embeds"] = torch.randn(
                b["tokens"].shape + (cfg.d_model,), generator=g, device=dev)
        return b

    def counted(what, fn, want_launches, want_transfers):
        _zero(counters)
        out, got = _trace_of(torch, fn)
        counts = _counts(counters)
        want = {k: 0 for k in counters}
        want.update(want_launches)
        if counts != want:
            raise AssertionError(f"{tag} {what}: launches {counts}, "
                                 f"expected {want}")
        if got != want_transfers:
            raise AssertionError(f"{tag} {what}: transfers {_fmt(got)}, "
                                 f"expected {_fmt(want_transfers)}")
        for k, v in counts.items():
            total[k] += v
        return out, counts, got

    def plain(what, fn):
        """fn with every op on its plain version: no launch."""
        _zero(counters)
        ops.set_default_backend("ref")
        try:
            out = fn()
        finally:
            ops.set_default_backend("auto")
        if any(_counts(counters).values()):
            raise AssertionError(f"{tag} {what} on the plain versions "
                                 f"launched {_counts(counters)}")
        return out

    def recorded(routes):
        return routes.recording() if routes else contextlib.nullcontext()

    def forced(routes, repeat):
        return routes.forced(repeat) if routes else contextlib.nullcontext()

    def make_opt(name):
        extra = SHARD_ADAMW if name in ("adamw", "int8_adamw") else {}
        return optimizers.get(name, lr=TRAIN_LR, **extra)

    def step_grads(cfg, sp, b, n_mb):
        """The sharded step's own gradients, clipped, gathered."""
        dt = spmd.Distinct(sp)
        g, _ = steps.accumulate_grads(dt.tensors, cfg, b, n_mb,
                                      loss_fn=dt.loss_fn)
        g = dt.sum_blocks(g)
        g, _ = optimizers.clip_by_global_norm(g, 1.0, dt.norm(g))
        return spmd.gather(dt.sharded(g))

    def train_case(label, cfg, params, shape, rows, seq, n_mb, tol,
                   routes=None, opt_name="adamw", loose=None):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                                  devices=positions(math.prod(shape)))
        sp = steps.place_params(params, mesh, cfg=cfg)
        opt = make_opt(opt_name)
        step = steps.make_train_step(cfg, opt, n_mb)
        b = batch_of(cfg, rows, seq, n_mb, 0)
        state = opt.init(params)
        with recorded(routes):
            p_un, s_un, m_un = step(params, state, 0, b)
        del p_un
        dropped = routes.dropped_frac() if routes else None
        if routes:          # the sharded step runs beside it on the card
            s_un = tree_map(lambda t: t.cpu(), s_un)
            free_card(torch)
        un_ms = _timed(torch, lambda: step(params, state, 0, b)[2])[1]
        # two summation orders with no sharding code in them: the
        # unsharded step with its microbatches cut into the data groups'
        # rows (the data-parallel split of the sums; an MoE layer's
        # capacity would change), and on the plain versions
        row_split = None
        if not routes:
            split = {k: v.reshape((n_mb * shape[0], -1)
                                  + tuple(v.shape[2:])) for k, v in b.items()}
            s_rs = steps.make_train_step(cfg, opt, n_mb * shape[0])(
                params, state, 0, split)[1]
            row_split = _state_check(torch, s_un, s_rs, loose)
            del s_rs, split
        cot_split = _split_sums_check(
            torch, lm, cfg, params, {k: v[0] for k, v in b.items()},
            shape[0], shape[1]) if cfg.family == "ssm" and n_mb == 1 \
            else None
        free_card(torch)
        with forced(routes, 1):
            s_up, m_up = plain(f"{label} unsharded step",
                               lambda: step(params, state, 0, b)[1:])
        witness = _state_check(torch, s_up, s_un, loose)
        del s_up
        free_card(torch)
        ss = steps.init_opt_state(opt, sp, cfg)
        with forced(routes, n_dev):
            (p_sh, s_sh, m_sh), counts, got = counted(
                f"{label} train step", lambda: step(sp, ss, 0, b),
                sharded_launches(cfg, sp, "train", n_mb),
                sharded_transfers(cfg, sp, "train", rows // n_mb, seq,
                                  n_mb, src=seq, opt_name=opt_name,
                                  state=ss))

        def rel(m, k):
            return abs(float(m_sh[k]) - float(m[k])) / abs(float(m[k]))
        loss_rel, gn_rel = rel(m_un, "loss"), rel(m_un, "grad_norm")
        mom = _state_check(torch, s_sh, s_un, loose)
        if opt_name == "adamw":
            upd = _update_check(torch, params, p_sh, s_sh, 0)
        else:
            with forced(routes, n_dev):
                grads = step_grads(cfg, sp, b, n_mb)
            upd = _rule_check(torch, opt, params, p_sh, state, grads, 0)
            del grads
        finite = bool(torch.isfinite(m_sh["loss"])) and \
            bool(torch.isfinite(m_sh["grad_norm"]))
        del p_sh, s_un, state
        free_card(torch)
        # the same sharded step on the plain versions
        with forced(routes, n_dev):
            s_pl, m_pl = plain(f"{label} train step",
                               lambda: step(sp, ss, 0, b)[1:])
        vs_plain = {"loss_rel": rel(m_pl, "loss"),
                    "grad_norm_rel": rel(m_pl, "grad_norm"),
                    "state": _state_check(torch, s_sh, s_pl, loose)}
        del s_sh, s_pl
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        sh_ms = _timed(torch, lambda: step(sp, ss, 0, b)[2])[1]
        peak = peak_gib(torch)
        cell = ShapeCell("train", "train", seq, rows)
        work = analysis.analytic_flops(cfg, cell)["total"]
        out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": shape,
               "rows": rows, "seq": seq, "microbatches": n_mb,
               "optimizer": opt_name, "remat": cfg.remat,
               "loss": float(m_sh["loss"]), "loss_unsharded":
               float(m_un["loss"]), "loss_rel": loss_rel,
               "grad_norm": float(m_sh["grad_norm"]), "grad_norm_rel":
               gn_rel, "state_worst": mom, "tolerance": tol,
               "loose": loose, "vs_plain": vs_plain,
               "unsharded_row_split": row_split,
               "unsharded_split_sums": cot_split,
               "unsharded_kernels_vs_plain": {
                   "loss_rel": abs(float(m_un["loss"]) - float(m_up["loss"]))
                   / abs(float(m_up["loss"])), "state": witness},
               "update_worst": upd, "dropped_frac": dropped,
               "launches": counts, "transfers": _fmt(got),
               "transfer_count": sum(got.values()),
               "transfer_bytes": sum(b * c for (_, b), c in got.items()),
               "ms": sh_ms, "unsharded_ms": un_ms, "peak_gib": peak,
               "analytic_flops": work,
               "fp32_peak_share": analysis.peak_share(work, sh_ms / 1e3)}
        print(f"{tag} {label} {opt_name} train step (remat {cfg.remat}) on "
              f"{mesh}: loss {out['loss']!r} (unsharded "
              f"{out['loss_unsharded']!r}, relative {loss_rel:.3e}), grad "
              f"norm relative {gn_rel:.3e}, state's worst {_fmt_state(mom)} "
              f"(tolerance {tol}"
              + ("" if loose is None else f"; {loose} leaves {SSM_TOL}")
              + f"; codes in scale steps, within 1); against the same "
              f"sharded step on the plain versions (no launch): loss "
              f"{vs_plain['loss_rel']:.3e}, grad norm "
              f"{vs_plain['grad_norm_rel']:.3e}, state "
              f"{_fmt_state(vs_plain['state'])}; with no sharding, "
              + ("" if row_split is None else
                 f"the unsharded step against itself with its "
                 f"microbatches cut into the data groups' rows: state "
                 f"{_fmt_state(row_split)}, ")
              + ("" if cot_split is None else
                 f"its gradients summed as the sharded step sums them "
                 f"({shape[0]} row blocks x {shape[1]} backward passes, "
                 f"one a vocab block): {cot_split[0]:.3e} "
                 f"({cot_split[1]}), ")
              + f"through the kernels against plain: state "
              f"{_fmt_state(witness)}; "
              + ("" if dropped is None else
                 f"dropped_frac of the MoE layers mean {dropped[0]:.4f}, "
                 f"max {dropped[1]:.4f}; ")
              + f"each parameter's update against "
              + ("its gathered moments'" if opt_name == "adamw" else
                 "its optimizer's rule on the step's gathered gradients")
              + f" worst {upd[0]:.3e} of SHARD_TOL x lr + one rounding "
              f"({upd[1]}, max |diff| {upd[2]:.3e}); "
              f"launches {_nonzero(counts)} = sharded_launches; "
              f"transfers ({out['transfer_count']}, "
              f"{out['transfer_bytes']} B) {out['transfers']} = "
              f"sharded_transfers; {sh_ms:.1f} ms a step (unsharded "
              f"{un_ms:.1f} ms; each a second call) on {card}; peak "
              f"{peak:.2f} GiB; {work:.4e} analytic FLOPs, "
              f"{out['fp32_peak_share']:.4f} of the fp32 peak", flush=True)
        ok = finite and max(loss_rel, gn_rel, vs_plain["loss_rel"],
                            vs_plain["grad_norm_rel"]) <= tol \
            and _held_to(mom, tol, SSM_TOL) \
            and _held_to(vs_plain["state"], tol, SSM_TOL) and upd[0] <= 1.0
        if not ok:
            raise AssertionError(f"{tag} {label} train step: {out}")
        del sp, ss
        free_card(torch)
        return out

    def infer_case(label, cfg, params, routes=None, seq=TRAIN_SEQ,
                   loose=None):
        mesh = mesh_lib.make_mesh(SHARD_MESH, ("data", "model"),
                                  devices=positions(math.prod(SHARD_MESH)))
        sp = steps.place_params(params, mesh, cfg=cfg)
        S = seq + SHARD_DECODE
        prefill = steps.make_prefill_step(cfg, S)
        decode = steps.make_decode_step(cfg)
        b = batch_of(cfg, SHARD_PREFILL, seq, 1, 1)
        pb = {k: v[0] for k, v in b.items() if k != "labels"}
        q8 = cfg.kv_bits == 8

        def cache_errs(name, c_a, c_b, errs, codes, decoded=False):
            """Every cache leaf: max |diff| / max |value| (SSM_TOL for
            the ``loose`` leaves), the int8 codes counted; after decode
            steps (``decoded``), the int8 cache's scales by the decode
            logits' rule, mean relative (their rows' floats follow
            attention over codes that may round the other way), their
            max |diff| / max |value| printed."""
            for k, st in c_a.items():
                if k == "len":
                    continue
                a, bb = st.gather(), _whole(c_b[k])
                if a.dtype == torch.int8:
                    codes[f"{name}_{k}"] = _codes_differ(torch, a, bb)
                elif q8 and decoded:
                    steps_rel[f"{name}_{k}"] = _mean_rel(a, bb)
                    scales_rel[f"{name}_{k}"] = _rel(a, bb)
                else:
                    errs[f"{name}_{k}" + (" (loose)" if loose and k in loose
                                          else "")] = _rel(a, bb)
        with recorded(routes):
            l_un, c_un = prefill(params, pb)
        dropped = routes.dropped_frac() if routes else None
        (_, _), un_ms = _timed(torch, lambda: prefill(params, pb))
        torch.cuda.reset_peak_memory_stats()
        with forced(routes, n_dev):
            (l_sh, c_sh), counts, got = counted(
                f"{label} prefill", lambda: prefill(sp, pb),
                sharded_launches(cfg, sp, "prefill"),
                sharded_transfers(cfg, sp, "prefill", SHARD_PREFILL,
                                  seq, src=seq))
        with forced(routes, n_dev):
            l_pl, c_pl = plain(f"{label} prefill", lambda: prefill(sp, pb))
        errs = {"prefill": _rel(l_sh, l_un),
                "prefill_vs_plain": _rel(l_sh, l_pl)}
        codes: dict = {}
        steps_rel: dict = {}
        scales_rel: dict = {}
        cache_errs("prefill_cache_vs_plain", c_sh, c_pl, errs, codes)
        (_, _), sh_ms = _timed(torch, lambda: prefill(sp, pb))
        cell = ShapeCell("prefill", "prefill", seq, SHARD_PREFILL)
        work = analysis.analytic_flops(cfg, cell)["fwd"]
        pre = {"launches": counts, "transfers": _fmt(got), "ms": sh_ms,
               "unsharded_ms": un_ms, "analytic_flops": work,
               "fp32_peak_share": analysis.peak_share(work, sh_ms / 1e3),
               "dropped_frac": dropped}
        gen = torch.Generator(device=dev).manual_seed(5)
        dec_ms, dec_un_ms = [], []
        d_counts, d_got = None, None
        for i in range(SHARD_DECODE):
            tok = torch.randint(0, cfg.vocab, (SHARD_PREFILL,),
                                generator=gen, device=dev,
                                dtype=torch.int32)
            with recorded(routes):
                (l_un, c_un), ms_u = _timed(
                    torch, lambda: decode(params, tok, c_un))
            if i == 0:
                with forced(routes, n_dev):
                    (l_sh, c_sh), d_counts, d_got = counted(
                        f"{label} decode step", lambda: decode(sp, tok, c_sh),
                        sharded_launches(cfg, sp, "decode"),
                        sharded_transfers(cfg, sp, "decode", SHARD_PREFILL,
                                          1))
                with forced(routes, n_dev):
                    l_pl, c_pl = plain(f"{label} decode step",
                                       lambda: decode(sp, tok, c_pl))
                if q8:
                    steps_rel["decode_0_vs_plain"] = _mean_rel(l_sh, l_pl)
                else:
                    errs["decode_0_vs_plain"] = _rel(l_sh, l_pl)
                cache_errs("decode_0_cache_vs_plain", c_sh, c_pl, errs,
                           codes, decoded=True)
                del l_pl, c_pl
            else:
                with forced(routes, n_dev):
                    (l_sh, c_sh), ms_s = _timed(
                        torch, lambda: decode(sp, tok, c_sh))
                dec_ms.append(ms_s)
                dec_un_ms.append(ms_u)
            if q8:
                steps_rel[f"decode_{i}"] = _mean_rel(l_sh, l_un)
            else:
                errs[f"decode_{i}"] = _rel(l_sh, l_un)
        cache_errs("cache", c_sh, c_un, errs, codes, decoded=True)
        if not all(bool(torch.isfinite(x).all()) for x in (l_sh, l_un)):
            raise AssertionError(f"{tag} {label}: non-finite logits")
        cell = ShapeCell("decode", "decode", S, SHARD_PREFILL)
        dwork = analysis.analytic_flops(cfg, cell)["fwd"]
        dmed = statistics.median(dec_ms)
        out = {
            "prefill": pre, "rows": SHARD_PREFILL, "seq": seq,
            "cache": S, "decode_steps": SHARD_DECODE,
            "decode_launches": d_counts, "decode_transfers": _fmt(d_got),
            "decode_ms_median": dmed,
            "decode_unsharded_ms_median": statistics.median(dec_un_ms),
            "decode_fp32_peak_share": analysis.peak_share(dwork, dmed / 1e3),
            "rel_errs": errs, "decode_mean_rel": steps_rel,
            "codes_differ": codes, "scales_max_rel": scales_rel,
            "peak_gib": peak_gib(torch)}
        strict = {k: v for k, v in errs.items() if "loose" not in k}
        worst = max(strict.values())
        worst_plain = max(v for k, v in strict.items() if "plain" in k)
        worst_loose = max([v for k, v in errs.items() if "loose" in k],
                          default=0.0)
        print(f"{tag} {label} prefill {SHARD_PREFILL} x {seq} (cache "
              f"{S}): launches {_nonzero(counts)}, transfers {_fmt(got)} (= "
              f"sharded_launches, sharded_transfers); {sh_ms:.1f} ms "
              f"(unsharded {un_ms:.1f} ms), {pre['fp32_peak_share']:.4f} of "
              f"the fp32 peak"
              + ("" if dropped is None else
                 f", dropped_frac mean {dropped[0]:.4f} max "
                 f"{dropped[1]:.4f}")
              + f"; {SHARD_DECODE} decode steps: the first's launches "
              f"{_nonzero(d_counts)}, transfers {_fmt(d_got)}; median "
              f"{dmed:.2f} ms a step after it (unsharded "
              f"{out['decode_unsharded_ms_median']:.2f} ms), "
              f"{out['decode_fp32_peak_share']:.5f} of the fp32 "
              f"peak; logits and cache max |diff| / max |value| worst "
              f"{worst:.3e} (tolerance {SHARD_TOL}; against the unsharded "
              f"steps, and the prefill and first decode step against the "
              f"same sharded calls on the plain versions, no launch: "
              f"{worst_plain:.3e})"
              + ("" if not loose else
                 f", the {'/'.join(loose)} leaves {worst_loose:.3e} "
                 f"(tolerance {SSM_TOL})")
              + ("" if not q8 else
                 f"; the decode logits' and the decoded cache scales' mean "
                 f"relative difference worst {max(steps_rel.values()):.3e} "
                 f"(bound {KV8_MEAN_REL}; the scales' max |diff| / max "
                 f"|value| {scales_rel}); int8 codes differing (count, "
                 f"largest): {codes}")
              + f"; peak {out['peak_gib']:.2f} GiB on {card}", flush=True)
        if worst > SHARD_TOL or worst_loose > SSM_TOL or (q8 and (
                max(steps_rel.values()) >= KV8_MEAN_REL
                or max(m for _, m in codes.values()) > 1)):
            raise AssertionError(f"{tag} {label} inference: {errs} "
                                 f"{steps_rel} {codes}")
        del sp, c_un, c_sh, l_un, l_sh
        free_card(torch)
        return out

    failed: list = []

    def sub(letter, fn):
        """Sub-path ``letter``, timed; a failed check is kept, the next
        runs."""
        t0 = time.perf_counter()
        try:
            fn()
        except AssertionError as e:
            failed.append(f"({letter}) {e}")
            print(f"{tag} ({letter}) FAILED: {e}", flush=True)
        free_card(torch)
        run.setdefault("sub_seconds", {})[letter] = \
            run.get("sub_seconds", {}).get(letter, 0.0) \
            + time.perf_counter() - t0

    def granite():
        # (a) granite-3-8b
        cfg, params = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                              TRAIN_LAYERS, remat="full")
        sub("a", lambda: run.update(
            train=train_case("granite-3-8b", cfg, params, SHARD_MESH,
                             TRAIN_ROWS, TRAIN_SEQ, TRAIN_MB, SHARD_TOL),
            infer=infer_case("granite-3-8b", cfg, params)))
        # (f) the int8 KV cache on the same weights
        cfg8, _ = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                          TRAIN_LAYERS, params=params, kv_bits=8)
        sub("f", lambda: run.update(kv8_infer=infer_case(
            "granite-3-8b kv_bits=8", cfg8, params)))
        # (g) adafactor and int8_adamw over the shards, remat group
        cfgg, _ = make_lm(torch, lm, registry, dev, tag, "granite-3-8b",
                          TRAIN_LAYERS, params=params, remat="group")
        for name, shape in (("adafactor", SHARD_MESH),
                            ("int8_adamw", SHARD_INT8_MESH)):
            sub("g", lambda name=name, shape=shape: run.update({
                f"{name}_train": train_case(
                    "granite-3-8b", cfgg, params, shape, TRAIN_ROWS,
                    TRAIN_SEQ, TRAIN_MB, SHARD_TOL, opt_name=name)}))

    def mamba2():
        # (b) mamba2-130m: #13 a position on its data shard
        cfg, params = make_lm(torch, lm, registry, dev, tag, "mamba2-130m")
        rows, seq = TRAIN_SSM
        run["ssm"] = train_case("mamba2-130m", cfg, params, SHARD_SSM_MESH,
                                rows, seq, 1, SSM_TOL)

    def qwen3():
        # (c) qwen3-moe-30b-a3b: replicated experts on the whole batch a
        # device, attention by heads; the routes of each unsharded call
        # forced onto the sharded ones
        cfg, params = make_lm(torch, lm, registry, dev, tag,
                              "qwen3-moe-30b-a3b", SHARD_MOE_LAYERS,
                              remat="full")
        routes = CallRoutes(moe)
        run["moe_train"] = train_case("qwen3-moe-30b-a3b", cfg, params,
                                      SHARD_MESH, TRAIN_ROWS, TRAIN_SEQ,
                                      TRAIN_MB, SHARD_TOL, routes)
        run["moe_infer"] = infer_case("qwen3-moe-30b-a3b", cfg, params,
                                      routes)
        run["moe_routes"] = check_routes(
            f"{tag} qwen3-moe-30b-a3b", routes, "the sharded calls forced "
            "onto the unsharded calls' experts")

    def zamba2():
        # (d) zamba2-1.2b: the mixer a position on its data shard, the
        # shared block's attention and MLP cut over model
        rows, seq = SHARD_SMALL
        cfg, params = make_lm(torch, lm, registry, dev, tag, "zamba2-1.2b",
                              SHARD_HYBRID_LAYERS, remat="full")
        run["hybrid_train"] = train_case("zamba2-1.2b", cfg, params,
                                         SHARD_MESH, rows, seq, 1,
                                         SHARD_TOL, loose="mixer")
        run["hybrid_infer"] = infer_case("zamba2-1.2b", cfg, params,
                                         seq=seq, loose=("conv", "ssm"))

    def seamless():
        # (e) seamless-m4t-medium: the encoder in lockstep, cross-attention
        # by heads over each position's rows of the encoder output
        rows, seq = SHARD_SMALL
        cfg, params = make_lm(torch, lm, registry, dev, tag,
                              "seamless-m4t-medium", remat="full")
        run["encdec_train"] = train_case("seamless-m4t-medium", cfg,
                                         params, SHARD_MESH, rows, seq, 1,
                                         SHARD_TOL)
        run["encdec_infer"] = infer_case("seamless-m4t-medium", cfg, params,
                                         seq=seq)

    granite()
    free_card(torch)
    for letter, fn in (("b", mamba2), ("c", qwen3), ("d", zamba2),
                       ("e", seamless)):
        sub(letter, fn)
    if failed:
        raise AssertionError(f"{tag} " + "; ".join(failed))
    run["launches"] = total
    run["seconds"] = time.perf_counter() - t_path
    print(f"{tag} launches {_nonzero(total)}; path sharded took "
          f"{run['seconds']:.1f}s (by sub-path: " + ", ".join(
              f"{k} {v:.1f}s" for k, v in run["sub_seconds"].items())
          + ")", flush=True)
    return total, run


def long_gaps(proc, duration_s: float, step_s: float) -> int:
    """Gaps of ``proc``'s schedule (from 0) longer than half a round:
    the wall loop (``OpenLoopHarness._run_wall``) starts a round only
    in such a gap, while the queue holds a request."""
    ts = [0.0] + [a.t for a in proc.schedule(duration_s)]
    return sum(1 for a, b in zip(ts, ts[1:]) if b - a > step_s / 2)


def recording(OpenLoopHarness, every: int):
    """``OpenLoopHarness`` keeping every ``every``-th request it submits
    (by uid) in ``kept``, so that a run's served outputs can be checked
    after the run (``check_served``)."""
    class Recording(OpenLoopHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.kept = []

        def _request(self, arrival):
            req = super()._request(arrival)
            if arrival.uid % every == 0:
                self.kept.append(req)
            return req
    return Recording


def check_served(np, kept: list) -> int:
    """Every served request in ``kept`` has outputs, all finite; returns
    how many were served, and empties ``kept``."""
    n = 0
    for req in kept:
        if not getattr(req, "done", False):
            continue
        if not req.outputs or not all(np.isfinite(o).all()
                                      for o in req.outputs):
            raise AssertionError(f"load: request {req.uid} served a "
                                 f"missing or non-finite output")
        n += 1
    kept.clear()
    return n


def load_row(r) -> dict:
    """The numbers a load reading prints of one ``LoadResult``."""
    x = r.extras
    return {"process": r.process["process"], "level": x.get("level"),
            "offered_rps": r.offered_rps,
            "offered_rps_measured": r.offered_rps_measured,
            "goodput_rps": r.goodput_rps, "on_time_frac": r.on_time_frac,
            "n_offered": r.n_offered, "admitted": r.admitted,
            "rejected": r.rejected, "expired": r.expired,
            "failed": r.failed, "completed": r.completed,
            "p50_ms": r.latency["p50_ms"], "p99_ms": r.latency["p99_ms"],
            "max_submit_lag_ms": x.get("max_submit_lag_ms"),
            "utilization": r.utilization, "rounds": x["rounds"],
            "makespan_s": r.makespan_s, "step_ms": x["step_ms"],
            "capacity_rps": x["capacity_rps"], "faults": x["faults"]}


def check_ledger(r, label: str) -> None:
    """Open loop: every offered request admitted or rejected, every
    admitted one completed, expired or failed."""
    if r.admitted + r.rejected != r.n_offered or \
            r.admitted != r.completed + r.expired + r.failed:
        raise AssertionError(f"load {label}: ledger {load_row(r)}")


def print_load(tag: str, row: dict) -> None:
    def ms(v):
        return "-" if v is None else f"{v:.2f}"
    lag = row["max_submit_lag_ms"]
    util = row["utilization"]
    print(f"[{tag}] {row['process']} level {row['level']}: offered "
          f"{row['offered_rps']:.2f} rps (measured "
          f"{row['offered_rps_measured']:.2f}), goodput "
          f"{row['goodput_rps']:.2f} rps, on time {row['on_time_frac']:.4f}, "
          f"admitted/rejected/expired/failed {row['admitted']}/"
          f"{row['rejected']}/{row['expired']}/{row['failed']} of "
          f"{row['n_offered']}, p50 {ms(row['p50_ms'])} ms, p99 "
          f"{ms(row['p99_ms'])} ms, max submit lag {ms(lag)} ms, "
          f"utilization {'-' if util is None else f'{util:.3f}'}, "
          f"{row['rounds']} rounds in {row['makespan_s']:.3f} s "
          f"({row.get('long_gaps')} arrival gaps over half a round); round "
          f"{row['step_ms']:.3f} ms, capacity {row['capacity_rps']:.2f} rps",
          flush=True)


def model_clock_load(np, core, yolo, lg, devices=None) -> dict:
    """(a) of path load: the JAX package's published sweep (LOAD_MODEL)
    on the model clock, over a design compiled for ``devices`` (None:
    the card). Every served output is checked finite."""
    arch, img, batch = LOAD_MODEL
    acc = core.compile(yolo.build(arch, img),
                       core.CompileConfig(batch_size=batch),
                       torch_device=devices[0] if devices else None)
    step = float(acc.report["batched_latency_ms"])
    h = recording(lg.OpenLoopHarness, 1)(
        acc, replicas=LOAD_REPLICAS, batch_size=batch,
        slo_ms=LOAD_SLO_ROUNDS * step, step_ms=step, seed=0,
        devices=devices)
    t0 = time.perf_counter()
    results, knee = h.sweep(levels=LOAD_MODEL_LEVELS,
                            rounds=LOAD_MODEL_ROUNDS, seed=0)
    for r in results:
        check_ledger(r, "model clock")
    return {"where": "cpu" if devices else "card", "step_ms": step,
            "knee": knee, "rows": [r.to_row() for r in results],
            "outputs_checked": check_served(np, h.kept),
            "seconds": time.perf_counter() - t0}


def fleet_round_ms(h, DetectRequest) -> tuple[float, list]:
    """The card's fleet round under ``h``'s own deployment: the median
    wall time of ``dep.run(max_steps=replicas, max_steps_per_replica=1)``
    with every replica's batch full, over LOAD_ROUND_REPS rounds after
    LOAD_ROUND_WARM (and after the harness's warm-up)."""
    h._warmup()
    n = h.replicas * h.batch_size
    times = []
    with h._make_deployment(time.monotonic, faults=False) as dep:
        for i in range(LOAD_ROUND_WARM + LOAD_ROUND_REPS):
            for j in range(n):
                if not dep.submit(DetectRequest(
                        uid=i * n + j, image=h._frames[j % len(h._frames)])):
                    raise AssertionError("load: a round's request rejected")
            t0 = time.perf_counter()
            done = dep.run(max_steps=h.replicas, max_steps_per_replica=1)
            times.append((time.perf_counter() - t0) * 1e3)
            if len(done) != n or not all(r.done for r in done):
                raise AssertionError(f"load: a round served {len(done)} of "
                                     f"{n}")
    return statistics.median(times[LOAD_ROUND_WARM:]), times


def wall_load(np, lg, serve_mod, acc, DetectRequest, label: str,
              backend=None, levels=LOAD_SHORT_LEVELS,
              extended=False) -> dict:
    """(b) of path load: a wall-clock sweep of ``acc`` at ``levels`` x
    the card's capacity (``fleet_round_ms``), Poisson arrivals, seed 0,
    LOAD_ROUNDS rounds a level; the first level read once more before
    the sweep (is the warm-up enough?). ``extended`` (``--only load``)
    reads instead, after the sweep, the four arrival shapes at 1.0x
    (``load_harness._process_rows``), one row with replica 0 crashing
    at step LOAD_KILL_STEP at LOAD_KILL_LEVEL x (``chaos_harness``'s
    kill scenario), and the sweep and the crash row again with arrivals
    in groups of BATCH (``GroupedArrivals``: a camera handing over a
    batch a capture, the reference's elastic workload), whose gaps are
    long enough for the wall loop to start rounds in them (PERF.md
    §7)."""
    Rec = recording(lg.OpenLoopHarness, LOAD_SAMPLE)
    kw = dict(replicas=LOAD_REPLICAS, batch_size=BATCH, backend=backend,
              seed=0)
    round_ms, samples = fleet_round_ms(Rec(acc, step_ms=1.0, **kw),
                                       DetectRequest)
    slo_ms = LOAD_SLO_ROUNDS * round_ms
    h = Rec(acc, slo_ms=slo_ms, step_ms=round_ms, **kw)
    cap = h.capacity_rps()
    duration = LOAD_ROUNDS * h.step_s
    print(f"[load] {label}: fleet round {round_ms:.3f} ms (median of "
          f"{LOAD_ROUND_REPS} after {LOAD_ROUND_WARM}; all: "
          + ", ".join(f"{t:.2f}" for t in samples)
          + f") -> capacity {cap:.2f} rps; slo {slo_ms:.2f} ms; "
          f"{LOAD_ROUNDS} rounds ({duration:.3f} s) a level", flush=True)
    out = {"round_ms": round_ms, "round_samples_ms": samples,
           "capacity_rps": cap, "slo_ms": slo_ms, "duration_s": duration}
    kept = [h.kept]

    def poisson(rate, seed=0):
        return lg.PoissonArrivals(rate=rate, seed=seed)

    def groups(rate, seed=0):
        return lg.GroupedArrivals(poisson(rate / BATCH, seed), BATCH)

    def row_of(tag, r, proc):
        check_ledger(r, f"{label} {tag}")
        row = load_row(r)
        row["long_gaps"] = long_gaps(proc, duration, h.step_s)
        print_load(f"load {label} {tag}", row)
        return row

    def run(tag, proc, level, harness=h):
        r = harness.run(proc, duration, clock="wall")
        r.extras["level"] = level
        return row_of(tag, r, proc)

    def sweep(tag, process_for):
        results, knee = h.sweep(levels=levels, rounds=LOAD_ROUNDS, seed=0,
                                clock="wall", process_for=process_for)
        rows = [row_of(tag, r, process_for(r.extras["level"] * cap, 0))
                for r in results]
        # find_knee falls back to the lowest level when none clears its
        # floor
        floor = knee["efficiency_floor"]
        held = "" if any(e >= floor for e in knee["on_time_frac_by_level"]) \
            else f"; no level on time >= {floor}: the lowest"
        print(f"[load] {label} {tag}: knee at "
              f"{knee['knee_offered_rps']:.2f} rps offered "
              f"({knee['knee_offered_rps'] / cap:.2f} x capacity{held}), "
              f"goodput peak {knee['goodput_peak_rps']:.2f} rps; on time "
              f"by level {knee['on_time_frac_by_level']}", flush=True)
        return {"rows": rows, "knee": knee}

    def crash(tag, proc):
        hk = Rec(acc, slo_ms=slo_ms, step_ms=round_ms, retry_budget=2,
                 fault_plan=serve_mod.FaultPlan([serve_mod.FaultEvent(
                     replica=0, kind="crash", step=LOAD_KILL_STEP)], seed=0),
                 **kw)
        kept.append(hk.kept)
        row = run(tag, proc, LOAD_KILL_LEVEL, harness=hk)
        # the crash fires only if replica 0 reaches step LOAD_KILL_STEP
        # inside the run; the ledger holds either way
        print(f"[load] {label} {tag} at replica 0's step {LOAD_KILL_STEP}: "
              f"{'fired' if row['faults']['faults'] else 'did not fire'}; "
              f"faults {row['faults']}", flush=True)
        return row

    if not extended:
        out["first_level_first_reading"] = run(
            "first reading", poisson(levels[0] * cap), levels[0])
    out["sweep"] = sweep("sweep", poisson)
    if extended:
        period, burst_w = duration / 2.0, max(duration / 8.0, 2 * h.step_s)
        out["shapes"] = [run("shape", proc, 1.0) for proc in (
            lg.ConstantArrivals(rate=cap), poisson(cap),
            lg.DiurnalPoissonArrivals(base_rate=0.2 * cap,
                                      peak_rate=1.8 * cap, period_s=period,
                                      seed=0),
            lg.OnOffBurstArrivals(rate_on=2.0 * cap, on_s=burst_w,
                                  off_s=burst_w, seed=0))]
        out["kill"] = crash("crash", poisson(LOAD_KILL_LEVEL * cap))
        out["grouped"] = sweep("grouped", groups)
        out["grouped_kill"] = crash("grouped crash",
                                    groups(LOAD_KILL_LEVEL * cap))
    out["outputs_checked"] = sum(check_served(np, k) for k in kept)
    return out


def _leaves(tree) -> list:
    """The leaves of a nested dict."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--only", choices=("stream", "a8", "conv", "attn",
                                       "ssd", "dec", "pool", "load",
                                       "decwin", "moe", "train", "tp",
                                       "pipeline", "sharded", "a8check"),
                    help="only one slice's reading, for a before/after "
                    "(copied into an older checkout, it reads that "
                    "checkout's kernels): stream, #4 and #5's cases and the "
                    "fusion_off forward; a8, #8, #9 and #10's cases, the "
                    "W4A8 forward, grid and double, and the per-group "
                    "forward; conv, #1 and #2's cases, "
                    "the float forwards at 640 and 160, the split-K "
                    "ablation and a split conv's host issue by parts; "
                    "attn, #11's cases (and SDPA's) and a profiler split "
                    "of one granite-3-8b prefill at 2048; ssd, #13's cases, "
                    "each at every compiled chunk, and a profiler split of "
                    "one mamba2-130m and one zamba2-1.2b prefill at 2048; "
                    "dec, #12's cases (and SDPA's), #6's, #12 at half and "
                    "twice its planned share length, and a profiler split "
                    "of one granite-3-8b and one zamba2-1.2b decode step; "
                    "pool, #3's cases, the NaN probe and a profiler split "
                    "of one yolov3-tiny forward at 416; load, the wall-"
                    "clock load sweeps of yolov8n at 640, float and W8A16, "
                    "the arrival shapes and a replica crash; decwin, #12 "
                    "past S with a window (reported, not enforced); moe, "
                    "path moe and llama4-maverick's one full-width group "
                    "(69.1 GiB of weights); train, path train; tp, path tp "
                    "(main's design by tensor-parallel replicas); "
                    "pipeline, path pipeline (granite-3-8b's streaming "
                    "pipeline) and its roofline share; sharded, path "
                    "sharded (the LM steps over a (data, model) mesh); "
                    "a8check, paths quant_w4a8, quant_per_group and mixed "
                    "(the A8 designs' scale digests, the reverse layer "
                    "check, a8_path_check's margins), the proof that #1's "
                    "last bits move no scale, and calib_drift. "
                    "Prints no result line")
    args = ap.parse_args()

    T0 = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.nn.functional as F
        import repro_torch.core as core
        from repro_torch.core import codegen, dse, toolflow
        from repro_torch.data.synthetic import ImageStream
        from repro_torch.kernels import _build
        from repro_torch.configs import registry
        from repro_torch.kernels import (attention, conv2d, decode_attention,
                                         maxpool, ops, pointwise, qmatmul,
                                         ref, resize, ssd_scan)
        from repro_torch.models import lm, yolo
        from repro_torch.serve.engine import Engine, Request
        from repro_torch.core import quant
        from repro_torch.core.quant import QTensor, dequantize
        from repro_torch.core.toolflow import place
        from repro_torch.serve import (AcceleratorReplica, Deployment,
                                       DetectRequest)
        import repro_torch.serve as serve_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from "
              f"{ROOT / 'src'}: {e}", file=sys.stderr)
        return 3

    K = types.SimpleNamespace(conv2d=conv2d, maxpool=maxpool, resize=resize,
                              pointwise=pointwise, qmatmul=qmatmul, ref=ref,
                              attention=attention,
                              decode_attention=decode_attention,
                              ssd_scan=ssd_scan)
    counters = {"conv2d": conv2d.launches,
                "conv2d_double": conv2d.launches_double,
                "maxpool2d": maxpool.launches,
                "resize_nearest": resize.launches,
                "pointwise": pointwise.launches,
                "qmatmul": qmatmul.qmatmul.launches,
                "qmatmul_a8": qmatmul.qmatmul_a8.launches,
                "qmatmul_a8_double": qmatmul.qmatmul_a8.launches_double,
                "qmatmul_a8_grouped": qmatmul.qmatmul_a8_grouped.launches,
                "rmsnorm": pointwise.rmsnorm_launches,
                "mha": attention.launches,
                "decode_attention": decode_attention.launches,
                "ssd_scan": ssd_scan.launches}
    quant_ref = codegen.QuantBackend(name="quant_ref", dispatch="ref")
    quant_kern = codegen.get_backend("quant")

    # ---------------------------------------------------------------- 1
    card = smi()
    print(f"[env] nvidia-smi: {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"[build] {'built' if info['built'] else 'loaded'} {info['path']} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS[:2])}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for line in info.get("log", "").splitlines():
        entry = line.partition("Compiling entry function '")[2]
        if entry:       # the kernel (mangled, template arguments and all)
            kernel = entry.split("'")[0]
            print(f"[build] {kernel}")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- 2
    model = yolo.build("yolov8n")
    dev0 = torch.device("cuda", 0)

    def write_out(per_kernel: dict, **extra) -> None:
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({
                "card": card, "torch": torch.__version__,
                "cases": {k: v["cases"] for k, v in per_kernel.items()},
                **extra}, indent=1))

    if args.only == "moe":
        lm_runs = {}
        _, lm_runs["moe"] = run_moe(torch, np, lm, ops, registry, Engine,
                                    Request, counters, dev0)
        _, lm_runs["llama4"] = run_llama4(torch, np, lm, ops, registry,
                                          counters, dev0)
        write_out({}, **lm_runs)
        print(f"[card] {smi()}")
        return 0
    if args.only == "train":
        _, run = run_train(torch, np, lm, ops, registry, counters, dev0)
        write_out({}, train=run)
        print(f"[card] {smi()}")
        return 0
    if args.only == "sharded":
        _, run = run_sharded(torch, np, lm, registry, counters, dev0)
        write_out({}, sharded=run)
        print(f"[card] {smi()}")
        return 0
    if args.only == "pipeline":
        _, run = run_pipeline(torch, np, lm, registry, counters, dev0,
                              model.graph)
        write_out({}, pipeline=run,
                  roofline=roofline_shares(registry, {"pipeline": run}))
        print(f"[card] {smi()}")
        return 0
    if args.only == "attn":
        print("[kernels] #11 vs its plain version on the card", flush=True)
        per_kernel = {}
        check_cases(torch, [c for c in lm_cases(torch, F, K, quant, dev0)
                            if c[0] == "mha"], per_kernel)
        sums = attn_sums(per_kernel)
        write_out(per_kernel, sums=sums, prefill=attn_prefill_split(
            torch, lm, registry, dev0))
        print(f"[card] {smi()}")
        return 0
    if args.only == "dec":
        print("[kernels] #12 and #6 vs their plain versions on the card",
              flush=True)
        per_kernel = {}
        check_cases(torch, [c for c in lm_cases(torch, F, K, quant, dev0)
                            if c[0] in ("decode_attention", "rmsnorm")],
                    per_kernel)
        sums = dec_sums(per_kernel)
        write_out(per_kernel, sums=sums,
                  share_sweep=dec_share_sweep(torch, K, dev0), step={
            a: dec_step_split(torch, lm, registry, dev0, a)
            for a in ("granite-3-8b", "zamba2-1.2b")})
        print(f"[card] {smi()}")
        return 0
    if args.only == "decwin":
        write_out({}, dec_window=dec_window_check(torch, K, dev0,
                                                  strict=False))
        print(f"[card] {smi()}")
        return 0
    if args.only == "load":
        import repro_torch.loadgen as lg
        load = {}
        # the designs of main and quant_w8a16 (the same weights)
        for label, backend in (("float", None), ("w8a16", "quant")):
            acc_l = core.compile(model, core.CompileConfig(
                backend=backend, batch_size=BATCH, replicas=LOAD_REPLICAS),
                params=random_params(torch, codegen, model.graph, 0))
            for c in counters.values():
                c.reset()
            load[label] = wall_load(
                np, lg, serve_mod, acc_l, DetectRequest,
                f"yolov8n@{IMG} {label}", backend=backend,
                levels=lg.DEFAULT_LEVELS, extended=True)
            load[label]["launches"] = {k: c.value
                                       for k, c in counters.items()}
            print(f"[load] {label}: launches "
                  f"{_nonzero(load[label]['launches'])}", flush=True)
            del acc_l
            torch.cuda.empty_cache()
        write_out({}, load=load)
        print(f"[card] {smi()}")
        return 0
    if args.only == "ssd":
        print("[kernels] #13 vs its plain version on the card", flush=True)
        per_kernel = {}
        check_cases(torch, ssd_cases(torch, F, K, dev0), per_kernel)
        sums = ssd_sums(per_kernel)
        write_out(per_kernel, sums=sums, prefill={
            a: ssd_prefill_split(torch, lm, registry, dev0, a, lengths)
            for a, lengths in SSD_PREFILLS.items()})
        print(f"[card] {smi()}")
        return 0
    # yolov3-tiny at 416 (float): its maxpool launches are #3's later cases
    model_t = yolo.build("yolov3-tiny")
    acc_t = core.compile(model_t, core.CompileConfig(batch_size=BATCH),
                         params=random_params(torch, codegen, model_t.graph,
                                              3))
    pools = kernel_cases(torch, F, K, dev0,
                         pool_launch_shapes(codegen, acc_t.graph))
    if args.only == "pool":
        print("[kernels] #3 vs its plain version on the card", flush=True)
        per_kernel = check_kernels(torch, pools)
        sums = pool_sums(per_kernel)
        nan = nan_probe(torch, K, dev0, strict=False)
        xb_t = torch.from_numpy(ImageStream(model_t.cfg.img_size, BATCH,
                                            seed=8).batch_at(0)).to(dev0)
        write_out(per_kernel, sums=sums, nan=nan,
                  sweep=pool_sweep(torch, K, _build, dev0),
                  v3t_forward=v3t_forward(torch, acc_t, xb_t, counters))
        print(f"[card] {smi()}")
        return 0
    # quant_per_group's design (yolov8n at 160, W8A8; its activation
    # scales are calibrated per group in phase 3): its matmul launch
    # shapes hold #9's later cases
    model160 = yolo.build("yolov8n", 160)
    fp160 = random_params(torch, codegen, model160.graph, 1)
    acc_g = core.compile(model160, core.CompileConfig(
        backend="quant", w_bits=8, a_bits=8, batch_size=BATCH),
        params=fp160)
    g_shapes = matmul_launch_shapes(codegen, acc_g.graph)

    def drive(acc_, n_req, img, seed, backend=None):
        for c in counters.values():
            c.reset()
        run = serve(Deployment, DetectRequest, ImageStream, acc_, n_req,
                    img, seed, backend)
        return run, {k: c.value for k, c in counters.items()}

    zero = functools.partial(zero_counts, counters)

    # The A8 designs take their activation scales, and mixed its
    # wordlength assignment, from the plain versions only, so that no
    # kernel's last bits move them (``a8_scale_proof``).
    digests: dict = {}
    # readings that break the A8 rule, kept so that every A8 design and
    # path is read; the run fails at its end if any is here
    a8_failed: list = []

    def a8_verdict() -> None:
        if a8_failed:
            raise AssertionError("the A8 rule failed: "
                                 + "; ".join(a8_failed))

    def recalibrate_per_group(graph=None) -> dict:
        """quant_per_group's design (``graph``: ``acc_g``'s unless given)
        recalibrated with per-group scales on the plain versions, on a
        batch of the image stream (another seed than the one served)."""
        calib_g = torch.from_numpy(ImageStream(160, BATCH, seed=9).batch_at(
            0)).to(acc_g.torch_device)
        return plain_scales(codegen, acc_g.graph if graph is None else graph,
                            place(fp160, acc_g.torch_device), calib_g,
                            granularity="per_group", group_size=16)

    def w4a8_calib(graph):
        """compile's own calibration batch for the W4A8 design."""
        return toolflow._calib_batch(graph, core.CompileConfig().calib_frames,
                                     dev0)

    def compile_w4a8():
        """quant_w4a8's design: yolov8n at 640, packed W4, A8, its scales
        calibrated by ``compile`` on its own calibration batch on the
        plain versions (``plain_compile``)."""
        with plain_compile(codegen, dse, quant_ref):
            return core.compile(model, core.CompileConfig(
                backend="quant", w_bits=4, a_bits=8, batch_size=BATCH),
                params=random_params(torch, codegen, model.graph, 0))

    def compile_mixed():
        """mixed's design: ``compile(bits="mixed")`` at 160, its
        wordlength search on the plain versions (``plain_compile``: the
        trials on ``quant_ref``, so the float reference and the ranges
        its activation scales come from on ``"ref"``)."""
        cfg = core.CompileConfig(bits="mixed", search_evals=16,
                                 calib_frames=1, batch_size=BATCH)
        t0 = time.perf_counter()
        with plain_compile(codegen, dse, quant_ref):
            acc_ = core.compile(model160, cfg, params=random_params(
                torch, codegen, model160.graph, 2))
        print(f"[mixed] compiled with the wordlength search on the plain "
              f"versions: {acc_.report['search_evals']} evaluations, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return acc_

    def digest_of(label: str, acc_, graph=None) -> dict:
        """``scale_digest`` of a design (``graph``: ``acc_``'s unless
        given), printed on an ``[a8_scales]`` line."""
        d = scale_digest(np, acc_.graph if graph is None else graph,
                         acc_.report.get("mixed_assignment"))
        print(f"[a8_scales] {label}: scales sha256 {d['scales_sha256']} "
              f"over {d['scaled_convs']} convs" + (
                  f"; assignment sha256 {d['assignment_sha256']}"
                  if "assignment_sha256" in d else ""), flush=True)
        return d

    def a8_scale_proof(g4) -> dict:
        """The A8 designs built again with #1's outputs moved one ulp
        (``nudged_conv_kernel``): compile_w4a8, the per-group
        recalibration on a copy of ``acc_g``'s graph, and compile_mixed.
        Their digests must equal ``digests``, the served designs'.
        Control: each of the first two designs' scales (``g4``, the
        served W4A8 design's graph; ``acc_g``'s) calibrated through the
        kernels (``backend="auto"``) must move under the same nudge, or
        it reached no scale."""
        t0 = time.perf_counter()
        p4 = place(random_params(torch, codegen, model.graph, 0), dev0)
        calib_g = torch.from_numpy(ImageStream(160, BATCH, seed=9).batch_at(
            0)).to(dev0)

        def kernel_route() -> dict:
            a, b = copy.deepcopy(g4), copy.deepcopy(acc_g.graph)
            codegen.calibrate_activation_scales(a, p4, w4a8_calib(a))
            codegen.calibrate_activation_scales(
                b, place(fp160, dev0), calib_g, granularity="per_group",
                group_size=16)
            return {"quant_w4a8": scale_digest(np, a)["scales_sha256"],
                    "quant_per_group": scale_digest(np, b)["scales_sha256"]}
        before = kernel_route()
        with nudged_conv_kernel(torch, K):
            again = {"quant_w4a8": digest_of("quant_w4a8 (#1 nudged)",
                                             compile_w4a8())}
            g = copy.deepcopy(acc_g.graph)
            recalibrate_per_group(g)
            again["quant_per_group"] = digest_of(
                "quant_per_group (#1 nudged)", acc_g, g)
            again["mixed"] = digest_of("mixed (#1 nudged)", compile_mixed())
            after = kernel_route()
        for label, d in again.items():
            if d != digests[label]:
                raise AssertionError(f"{label}: scales built with #1 nudged "
                                     f"{d} != {digests[label]}")
        moved = {k: before[k] != after[k] for k in before}
        if not all(moved.values()):
            raise AssertionError(f"the nudge moved no kernel-calibrated "
                                 f"scale: {moved}")
        out = {"equal": True, "kernel_route_moved": moved,
               "seconds": time.perf_counter() - t0}
        print(f"[a8_scales] with #1's outputs moved one ulp the A8 designs' "
              f"digests are unchanged ({', '.join(again)}); the same nudge "
              f"moves the scales calibrated through the kernels: {moved}; "
              f"{out['seconds']:.1f}s", flush=True)
        return out

    auto = codegen.get_backend("auto")

    def dbl(base):
        return DoubleBuffered(K, base)

    def tp_designs(acc, acc_q, acc_4, acc_m) -> list:
        """Path tp's designs after main's: (label, accelerator, its
        one-device lowering table, its plain table, img, seed)."""
        return [("quant_w8a16", acc_q, quant_kern, quant_ref, IMG, 0),
                ("quant_w4a8", acc_4, quant_kern, quant_ref, IMG, 5),
                ("quant_per_group", acc_g, quant_kern, quant_ref, 160, 6),
                ("mixed", acc_m, quant_kern, quant_ref, 160, 7),
                ("double_float", acc, dbl(auto), auto, IMG, 0),
                ("double_w4a8", acc_4, dbl(quant_kern), quant_ref, IMG, 5)]

    def per_group_path():
        """Path quant_per_group: the design recalibrated with per-group
        scales (``recalibrate_per_group``), one batch served,
        ``a8_path_check``, and its forward read (``per_group_forward``)."""
        written = recalibrate_per_group()
        digests["quant_per_group"] = digest_of("quant_per_group", acc_g)
        (images_g, done_g, _, _), cg = drive(acc_g, BATCH, 160, 6,
                                             backend="quant")
        n_g, n_f = cg["qmatmul_a8_grouped"], cg["qmatmul"]
        if n_g + n_f != 63 or n_g <= 0 or cg["conv2d"] or cg["qmatmul_a8"]:
            raise AssertionError(f"quant_per_group launches {cg}")
        # The grouped kernel folds exact int32 block sums in float32, the
        # plain version rounds the exact sums once: the two differ in the
        # last bits, which is what a8_path_check is built for.
        a8_g = a8_path_check(torch, np, ImageStream, acc_g, quant_kern,
                             quant_ref, done_g, images_g,
                             [(20, 20, 144), (10, 10, 144), (5, 5, 144)],
                             160, (6, 10, 11), "quant_per_group",
                             failed=a8_failed)
        print(f"[quant_per_group] yolov8n@160 W8A8, {len(written)} convs "
              f"recalibrated per group of 16 channels on the plain versions; "
              f"launches {cg}; every "
              f"conv within {KERNEL_TOL['qmatmul_a8_grouped']} of its plain "
              f"version on the same input (max_abs_err "
              f"{a8_g['layer_max_abs_err']:.3e}); end to end max_abs_err "
              f"{a8_g['max_abs_err']:.3e}", flush=True)
        fwd_g = per_group_forward(torch, acc_g, torch.from_numpy(
            np.stack(images_g)).to(acc_g.torch_device), quant_kern,
            counters)
        return cg, a8_g, fwd_g

    shapes640 = [(80, 80, 144), (40, 40, 144), (20, 20, 144)]
    shapes160 = [(20, 20, 144), (10, 10, 144), (5, 5, 144)]

    def w4a8_path() -> tuple:
        """Path quant_w4a8: packed int4 weights, int8 activations, one
        batch served and ``a8_path_check``. Returns (design, images,
        served requests, launches, check, accuracy probe)."""
        t0 = time.perf_counter()
        acc_4 = compile_w4a8()
        digests["quant_w4a8"] = digest_of("quant_w4a8", acc_4)
        probe = {k: acc_4.report[k] for k in (
            "quant_max_abs_delta", "quant_mean_rel_delta")}
        (images_4, done_4, _, _), c4 = drive(acc_4, BATCH, IMG, 5,
                                             backend="quant")
        want_4 = zero(qmatmul_a8=63, maxpool2d=3, resize_nearest=2)
        packed = sum(1 for p in acc_4.params.values() if p["w"].packed)
        if c4 != want_4 or packed != 63:
            raise AssertionError(f"quant_w4a8 launches {c4} ({packed} packed "
                                 f"weights), expected {want_4}")
        a8_4 = a8_path_check(torch, np, ImageStream, acc_4, quant_kern,
                             quant_ref, done_4, images_4, shapes640, IMG,
                             (5, 12, 13), "quant_w4a8", failed=a8_failed)
        print(f"[quant_w4a8] compiled (scales on the plain versions) and "
              f"served one batch in {time.perf_counter() - t0:.1f}s; "
              f"launches {c4} on {packed} "
              f"packed-int4 weights; every conv within "
              f"{KERNEL_TOL['qmatmul_a8']} of its plain version on the same "
              f"input (max_abs_err {a8_4['layer_max_abs_err']:.3e}); end to "
              f"end max_abs_err {a8_4['max_abs_err']:.3e}; accuracy probe "
              f"(compile's, on the served scales) {probe}", flush=True)
        return acc_4, images_4, done_4, c4, a8_4, probe

    def mixed_path() -> tuple:
        """Path mixed: the plain-searched design (``compile_mixed``), one
        batch served, ``a8_path_check`` where a layer quantizes its
        activations, else MAIN_TOL. Returns (design, launches, max
        error, the A8 check or None, probe)."""
        t0 = time.perf_counter()
        acc_m = compile_mixed()
        t_search = time.perf_counter() - t0
        digests["mixed"] = digest_of("mixed", acc_m)
        (images_m, done_m, _, _), cm = drive(acc_m, BATCH, 160, 7,
                                             backend="quant")
        nq = cm["qmatmul"] + cm["qmatmul_a8"] + cm["qmatmul_a8_grouped"]
        if nq != 63 or cm["conv2d"]:
            raise AssertionError(f"mixed launches {cm}")
        counts_m: dict = {}
        for wa in acc_m.report["mixed_assignment"].values():
            key = f"W{wa[0]}A{wa[1]}"
            counts_m[key] = counts_m.get(key, 0) + 1
        # the 8-bit bound only where the search chose a layer that
        # quantizes its activations; else MAIN_TOL, as on quant_w8a16
        a8_m = any(wa[1] <= 8
                   for wa in acc_m.report["mixed_assignment"].values())
        check_m = None
        if a8_m:
            check_m = a8_path_check(torch, np, ImageStream, acc_m,
                                    quant_kern, quant_ref, done_m, images_m,
                                    shapes160, 160, (7, 14, 15), "mixed",
                                    failed=a8_failed)
            err_m = check_m["max_abs_err"]
        else:
            err_m, _ = check_outputs(torch, np, acc_m, images_m, done_m,
                                     shapes160, ref_backend=quant_ref)
        probe = {"mixed_accuracy_delta": acc_m.report["mixed_accuracy_delta"],
                 "wordlengths": counts_m,
                 "assignment": acc_m.report["mixed_assignment"],
                 "search_evals": acc_m.report["search_evals"],
                 "compile_s": t_search}
        print(f"[mixed] yolov8n@160 bits='mixed' (search_evals=16 on the "
              f"plain versions, {t_search:.1f}s to compile): chosen "
              f"wordlengths {counts_m} at delta "
              f"{acc_m.report['mixed_accuracy_delta']:.4e} (budget "
              f"{acc_m.report['accuracy_budget']}); launches {cm}; outputs "
              f"{'checked as on quant_w4a8' if a8_m else f'within {MAIN_TOL}'} "
              f"against the plain quant path (max_abs_err {err_m:.3e})",
              flush=True)
        return acc_m, cm, err_m, check_m, probe

    if args.only == "a8check":
        acc_4, _, _, c4, a8_4, probe_4 = w4a8_path()
        cg, a8_g, _ = per_group_path()
        _, cm, err_m, a8_m, probe_m = mixed_path()
        proof = a8_scale_proof(acc_4.graph)
        drift = calib_drift(torch, core, codegen, yolo, ImageStream, place,
                            dev0)
        write_out({}, a8check={
            "digests": digests, "proof": proof, "calib_drift": drift,
            "a8_failed": a8_failed,
            "quant_w4a8": {"launches": c4, "a8_path_check": a8_4,
                           "probe": probe_4},
            "quant_per_group": {"launches": cg, "a8_path_check": a8_g},
            "mixed": {"launches": cm, "max_abs_err": err_m,
                      "a8_path_check": a8_m, "probe": probe_m}})
        print(f"[card] {smi()}")
        a8_verdict()
        return 0

    if args.only == "a8":
        acc_4 = compile_w4a8()
        print("[kernels] #8, #9 and #10 vs their plain versions on the card",
              flush=True)
        per_kernel: dict = {}
        check_cases(torch, qmm_cases(
            torch, K, quant, dev0, matmul_launch_shapes(codegen, acc_4.graph),
            kinds=("qmatmul_a8", "qmatmul_a8_double", "qmatmul_a8_grouped"),
            g_shapes=g_shapes), per_kernel)
        sums = a8_sums(per_kernel)
        exact = a8g_exact_check(torch, qmatmul, dev0)
        xb4 = torch.from_numpy(ImageStream(IMG, BATCH, seed=5).batch_at(0)
                               ).to(dev0)
        w4a8 = a8_forward(torch, K, acc_4, xb4, quant_kern, counters)
        cg, a8_g, fwd_g = per_group_path()
        write_out(per_kernel, sums=sums, w4a8_forward=w4a8,
                  a8g_exact=exact, per_group={
                      "launches": cg, "a8_path_check": a8_g,
                      "forward": fwd_g})
        print(f"[card] {smi()}")
        a8_verdict()
        return 0
    t0 = time.perf_counter()
    acc = core.compile(model, core.CompileConfig(batch_size=BATCH,
                                                 replicas=2),
                       params=random_params(torch, codegen, model.graph, 0))
    print(f"[main] compiled {acc.name} on {acc.torch_device} in "
          f"{time.perf_counter() - t0:.1f}s; launch nodes per forward: "
          f"{len(codegen.launch_nodes(acc.graph))}", flush=True)
    model_off = yolo.build("yolov8n", 160)
    acc_off = core.compile(model_off,
                           core.CompileConfig(batch_size=BATCH, passes=()),
                           params=random_params(torch, codegen,
                                                model_off.graph, 1))
    xb = torch.from_numpy(ImageStream(IMG, BATCH, seed=3).batch_at(0)
                          ).to(dev0)
    xb_off = torch.from_numpy(ImageStream(160, BATCH, seed=4).batch_at(0)
                              ).to(dev0)
    if args.only == "tp":
        _, run = run_tp(torch, np, codegen, ImageStream, Deployment,
                        DetectRequest, counters, acc, xb)
        acc_q = core.compile(model, core.CompileConfig(
            backend="quant", batch_size=BATCH, replicas=2),
            params=random_params(torch, codegen, model.graph, 0))
        recalibrate_per_group()
        digests["quant_per_group"] = digest_of("quant_per_group", acc_g)
        acc_4, acc_m = compile_w4a8(), compile_mixed()
        digests["quant_w4a8"] = digest_of("quant_w4a8", acc_4)
        digests["mixed"] = digest_of("mixed", acc_m)
        _, run["designs"] = run_tp_quant(
            torch, np, codegen, quant, ops, ref, K, ImageStream, Deployment,
            DetectRequest, counters, tp_designs(acc, acc_q, acc_4, acc_m),
            failed=a8_failed)
        write_out({}, tp=run)
        print(f"[card] {smi()}")
        a8_verdict()
        return 0
    convs = conv_cases(torch, F, K, dev0,
                       conv_launch_shapes(codegen, acc.graph))
    if args.only == "conv":
        print("[kernels] #1 and #2 vs their plain version on the card",
              flush=True)
        per_kernel = {}
        check_cases(torch, convs, per_kernel)
        sums = conv_sums(per_kernel)
        fwd = float_forward(torch, acc, xb, acc_off, xb_off)
        rules = conv_split_rules(torch, K, acc, xb, acc_off, xb_off)
        write_out(per_kernel, sums=sums, float_forward=fwd,
                  split_rules=rules,
                  issue_split_us=conv_issue_split(torch, K, _build, dev0),
                  calib_drift=calib_drift(torch, core, codegen, yolo,
                                          ImageStream, place, dev0))
        print(f"[card] {smi()}")
        return 0
    streams = stream_cases(torch, F, K, dev0,
                           resize_launch_shapes(codegen, acc.graph),
                           act_launch_shapes(codegen, acc_off.graph))
    if args.only == "stream":
        print("[kernels] #4 and #5 vs their plain versions on the card",
              flush=True)
        per_kernel = check_kernels(torch, streams)
        sums = stream_sums(per_kernel)
        write_out(per_kernel, sums=sums, fusion_off_forward=fusion_off_forward(
            torch, acc_off, xb_off))
        print(f"[card] {smi()}")
        return 0
    t0 = time.perf_counter()
    params_q = random_params(torch, codegen, model.graph, 0)
    acc_q = core.compile(model, core.CompileConfig(
        backend="quant", batch_size=BATCH, replicas=2), params=params_q)
    print(f"[quant_w8a16] compiled {acc_q.name} backend=quant in "
          f"{time.perf_counter() - t0:.1f}s; accuracy probe "
          f"quant_max_abs_delta={acc_q.report['quant_max_abs_delta']:.4e} "
          f"quant_mean_rel_delta="
          f"{acc_q.report['quant_mean_rel_delta']:.4e}", flush=True)
    print("[kernels] each kernel vs its plain version on the card", flush=True)
    per_kernel = check_kernels(torch, pools + streams)
    sums = stream_sums(per_kernel)
    sums_pool = pool_sums(per_kernel)
    nan = nan_probe(torch, K, dev0)
    split = issue_split(torch, K, _build, dev0)
    check_cases(torch, qmm_cases(torch, K, quant, dev0, matmul_launch_shapes(
        codegen, acc_q.graph), g_shapes=g_shapes)
        + lm_cases(torch, F, K, quant, dev0)
        + ssd_cases(torch, F, K, dev0) + convs, per_kernel)
    sums_a8 = a8_sums(per_kernel)
    exact_a8g = a8g_exact_check(torch, qmatmul, dev0)
    sums_conv = conv_sums(per_kernel)
    sums_attn = attn_sums(per_kernel)
    sums_ssd = ssd_sums(per_kernel)
    pointer = a8_pointer_check(torch, qmatmul, dev0)
    dec_window = dec_window_check(torch, K, dev0)

    def lap(label: str) -> None:
        print(f"[time] {label} done at {time.perf_counter() - T0:.0f}s",
              flush=True)
    lap("build and the kernels' cases")

    # ---------------------------------------------------------------- 3
    (images, done, stats, wall), main_counts = drive(acc, N_REQ, IMG, 0)
    batches = stats["batches"]
    print(f"[main] served {stats['frames']} requests in {batches} batches "
          f"on {stats['replicas']} replicas; launches {main_counts}")
    want = zero(conv2d=63 * batches, maxpool2d=3 * batches,
                resize_nearest=2 * batches)
    if batches != N_REQ // BATCH or main_counts != want:
        raise AssertionError(f"main path launches {main_counts} over "
                             f"{batches} batches, expected {want}")
    err_main, scale_main = check_outputs(
        torch, np, acc, images, done,
        [(80, 80, 144), (40, 40, 144), (20, 20, 144)])
    print(f"[main] outputs within {MAIN_TOL} of backend='ref' on the card "
          f"(max_abs_err {err_main:.3e}, max |output| {scale_main:.3e})",
          flush=True)

    (images_off, done_off, stats_off, _), off_counts = drive(
        acc_off, BATCH, 160, 1)
    want_off = zero(conv2d=63, maxpool2d=3, resize_nearest=2, pointwise=57)
    if stats_off["batches"] != 1 or off_counts != want_off:
        raise AssertionError(f"fusion-off launches {off_counts} over "
                             f"{stats_off['batches']} batches, expected "
                             f"{want_off} for one")
    err_off, scale_off = check_outputs(
        torch, np, acc_off, images_off, done_off,
        [(20, 20, 144), (10, 10, 144), (5, 5, 144)])
    print(f"[fusion_off] yolov8n@160 passes=(): launches per forward "
          f"{off_counts}; outputs within {MAIN_TOL} of backend='ref' "
          f"(max_abs_err {err_off:.3e}, max |output| {scale_off:.3e})",
          flush=True)
    off_fwd = fusion_off_forward(torch, acc_off, xb_off)
    probes = {"quant_w8a16": {k: acc_q.report[k] for k in (
        "quant_max_abs_delta", "quant_mean_rel_delta")}}

    # quant_w8a16: the W8A16 design served like main
    (images_q, done_q, stats_q, wall_q), q_counts = drive(
        acc_q, N_REQ, IMG, 0, backend="quant")
    bq = stats_q["batches"]
    want_q = zero(qmatmul=63 * bq, maxpool2d=3 * bq, resize_nearest=2 * bq)
    if bq != N_REQ // BATCH or q_counts != want_q:
        raise AssertionError(f"quant_w8a16 launches {q_counts} over {bq} "
                             f"batches, expected {want_q}")
    err_q, scale_q = check_outputs(torch, np, acc_q, images_q, done_q,
                                   shapes640, ref_backend=quant_ref)
    print(f"[quant_w8a16] served {stats_q['frames']} requests in {bq} "
          f"batches; launches {q_counts}; outputs within {MAIN_TOL} of a "
          f"QuantBackend(dispatch='ref') on the card (max_abs_err "
          f"{err_q:.3e}, max |output| {scale_q:.3e})", flush=True)

    # quant_w4a8, quant_per_group, mixed: the A8 designs (scales, and
    # mixed's assignment, from the plain versions), then the proof that
    # #1's last bits do not move them
    acc_4, images_4, done_4, c4, a8_4, probes["quant_w4a8"] = w4a8_path()
    cg, a8_g, fwd_g = per_group_path()
    acc_m, cm, err_m, _, probes["mixed"] = mixed_path()
    scale_proof = a8_scale_proof(acc_4.graph)
    lap("paths main to mixed")

    # double: pipeline="double" on the designs that main and quant_w4a8
    # compiled (no recompile), one forward each through a replica pinned
    # to the DoubleBuffered table; each conv held against the grid
    # kernels on the grid path's input
    double = {}
    c_df, done_df, double["float"] = double_forward(
        torch, np, AcceleratorReplica, DetectRequest, counters, acc,
        dbl(auto), auto, images,
        LayerCompare(dbl(auto), auto, tol=DOUBLE_CONV_TOL))
    if c_df != zero(conv2d_double=63, maxpool2d=3, resize_nearest=2):
        raise AssertionError(f"double (float) launches {c_df}")
    err_df, _ = check_outputs(torch, np, acc, images[:BATCH], done_df,
                              shapes640)
    double["float"]["max_abs_err_vs_ref"] = err_df
    c_dq, done_dq, double["w4a8"] = double_forward(
        torch, np, AcceleratorReplica, DetectRequest, counters, acc_4,
        dbl(quant_kern), quant_kern, images_4,
        LayerCompare(dbl(quant_kern), quant_kern, ulp=True))
    if c_dq != zero(qmatmul_a8_double=63, maxpool2d=3, resize_nearest=2):
        raise AssertionError(f"double (W4A8) launches {c_dq}")
    double["w4a8_forward"] = a8_forward(
        torch, K, acc_4, torch.from_numpy(np.stack(images_4[:BATCH])).to(
            acc_4.torch_device), quant_kern, counters)
    diffs = []
    for r_d, r_g in zip(done_dq, done_4):
        for o_d, o_g in zip(r_d.outputs, r_g.outputs):
            if o_d.shape != o_g.shape or not np.isfinite(o_d).all():
                raise AssertionError(f"double (W4A8): request {r_d.uid}")
            diffs.append(float(np.abs(o_d - o_g).max()))
    double["w4a8"]["max_abs_err_vs_grid_served"] = max(diffs)
    # every conv bit-equal to the grid kernel's on the same input makes
    # the served outputs equal too (the same pools, resizes and codes);
    # a conv one ulp apart may flip a code downstream, so the outputs are
    # then held to the A8 bound instead
    bound_dq = 0.0 if double["w4a8"]["convs_bit_equal_to_grid"] == 63 \
        else A8_TOL * max(float(np.abs(o).max())
                          for r in done_4 for o in r.outputs)
    if max(diffs) > bound_dq:
        raise AssertionError(f"double (W4A8): served outputs "
                             f"{max(diffs)} from quant_w4a8's, beyond "
                             f"{bound_dq}")
    double["w4a8"]["served_bound"] = bound_dq
    for label, c, d, held in (
            ("float", c_df, double["float"], f"within {DOUBLE_CONV_TOL}"),
            ("W4A8", c_dq, double["w4a8"], "at most one ulp")):
        e2e = (f"outputs within {MAIN_TOL} of backend='ref' (max_abs_err "
               f"{d['max_abs_err_vs_ref']:.3e})" if label == "float" else
               f"outputs within {d['served_bound']:.3e} of quant_w4a8's "
               f"served batch (grid kernels): max_abs_err "
               f"{d['max_abs_err_vs_grid_served']:.3e}")
        print(f"[double] {label} design: launches per forward "
              f"{_nonzero(c)}; every conv against the grid kernel on the "
              f"grid path's input: max_abs_err "
              f"{d['conv_max_abs_err_vs_grid']:.3e} ({held}), bit-equal "
              f"at {d['convs_bit_equal_to_grid']}/63 convs; "
              f"{e2e}; forward device ms double "
              f"{d['forward_device_ms']:.3f} (issue "
              f"{d['forward_issue_ms']:.3f}), grid "
              f"{d['grid_forward_device_ms']:.3f} (issue "
              f"{d['grid_forward_issue_ms']:.3f})", flush=True)

    paths = {"main": main_counts, "fusion_off": off_counts,
             "quant_w8a16": q_counts, "quant_w4a8": c4,
             "quant_per_group": cg, "mixed": cm,
             "double": {k: c_df[k] + c_dq[k] for k in counters}}
    # tp: main's design by tensor-parallel replicas, then the designs
    # quant_w8a16, quant_w4a8, quant_per_group, mixed and double compiled
    paths["tp"], tp_run = run_tp(torch, np, codegen, ImageStream,
                                 Deployment, DetectRequest, counters, acc,
                                 xb)
    c_tq, tp_run["designs"] = run_tp_quant(
        torch, np, codegen, quant, ops, ref, K, ImageStream, Deployment,
        DetectRequest, counters, tp_designs(acc, acc_q, acc_4, acc_m),
        failed=a8_failed)
    paths["tp"] = {k: paths["tp"][k] + c_tq[k] for k in counters}
    lap("paths double and tp")

    # ---------------------------------------------------------------- 4
    # A short serving window after warm-up: a smoke reading of the
    # serving loop, not a benchmark (64 requests, well under a second).
    _, _, stats2, wall2 = serve(Deployment, DetectRequest,
                                ImageStream, acc, 2 * N_REQ, IMG, seed=2)
    ms_batch = wall2 / stats2["batches"] * 1e3
    fps = stats2["frames"] / wall2
    fwd_ms = cuda_ms(torch, lambda: acc.forward(xb), budget_ms=500)
    ref_ms = cuda_ms(torch, lambda: acc.forward(xb, backend="ref"),
                     budget_ms=500)
    lat = stats2["latency"]
    busy = [r["busy_frac"] for r in stats2["per_replica"]]
    print(f"[timing] {card}: Deployment smoke window {ms_batch:.2f} ms/batch "
          f"of {BATCH}, {fps:.1f} frames/s over {stats2['frames']} "
          f"requests (first run incl. warm-up: {wall:.2f}s); per-batch "
          f"service time on the replica workers (execute + copy-out) p50 "
          f"{lat['p50_ms']} ms, busy fractions {busy}; executor forward "
          f"back to back {fwd_ms:.3f} ms/batch on the kernels, "
          f"{ref_ms:.3f} ms/batch on the plain versions", flush=True)
    spans = replica_spans(torch, AcceleratorReplica, DetectRequest, QTensor,
                          dequantize, acc, images)
    print(f"[timing] one replica step alone, median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)
    fwd_split = float_forward(torch, acc, xb, acc_off, xb_off)
    fwd_q = cuda_ms(torch, lambda: acc_q.forward(xb), budget_ms=500)
    spans_q = replica_spans(torch, AcceleratorReplica, DetectRequest,
                            QTensor, dequantize, acc_q, images_q)
    spans_q.update(quant_extra_spans(torch, codegen, ops, quant, acc_q,
                                     place(params_q, acc_q.torch_device)))
    print(f"[timing] quant_w8a16 executor forward back to back "
          f"{fwd_q:.3f} ms/batch (float path {fwd_ms:.3f}); one replica "
          f"step alone, median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans_q.items()),
          flush=True)

    # ---------------------------------------------------------------- load
    # the open-loop harness through the user's entry points: (a) the
    # published model-clock sweep on the card (and, outside the counted
    # run, on the CPU: the same rows), (b) a short wall-clock sweep of
    # main's design at multiples of the card's measured capacity
    import repro_torch.loadgen as lg
    t_load = time.perf_counter()
    for c in counters.values():
        c.reset()
    load = {"model_clock": model_clock_load(np, core, yolo, lg)}
    load["wall_float"] = wall_load(np, lg, serve_mod, acc, DetectRequest,
                                   f"yolov8n@{IMG} float")
    paths["load"] = {k: c.value for k, c in counters.items()}
    load["model_clock_cpu"] = model_clock_load(np, core, yolo, lg,
                                               devices=["cpu"])
    mc, mc_cpu = load["model_clock"], load["model_clock_cpu"]
    knee = mc["knee"]["knee_offered_rps"]
    print(f"[load] model clock, {LOAD_MODEL[0]}@{LOAD_MODEL[1]} batch "
          f"{LOAD_MODEL[2]}: knee {knee!r} rps on the card "
          f"({mc['seconds']:.1f}s), {mc_cpu['knee']['knee_offered_rps']!r} "
          f"on the CPU ({mc_cpu['seconds']:.1f}s), published "
          f"{LOAD_KNEE_RPS!r}; on time by level "
          f"{mc['knee']['on_time_frac_by_level']}; "
          f"{mc['outputs_checked']} served outputs finite on the card",
          flush=True)
    if mc["rows"] != mc_cpu["rows"] or mc["knee"] != mc_cpu["knee"] \
            or knee != LOAD_KNEE_RPS or mc["outputs_checked"] <= 0:
        raise AssertionError(f"load: model-clock sweep {mc['knee']} on the "
                             f"card, {mc_cpu['knee']} on the CPU")
    want_load = {k: v for k, v in paths["load"].items() if v}
    if set(want_load) != {"conv2d", "maxpool2d", "resize_nearest"}:
        raise AssertionError(f"load path launches {paths['load']}")
    load["seconds"] = time.perf_counter() - t_load
    print(f"[load] launches {_nonzero(paths['load'])}; path load took "
          f"{load['seconds']:.1f}s", flush=True)
    lap("timing and load")

    # ---------------------------------------------------------------- 5, 6
    # lm, ssm, hybrid: granite-3-8b, mamba2-130m and zamba2-1.2b at full
    # width and depth, each served by Engine
    lm_runs = {}
    for path in LM_PATHS:
        paths[path], lm_runs[path], kept = run_lm(
            torch, np, lm, ops, registry, Engine, Request, counters, dev0,
            path, keep=path == "lm")
        if path == "lm":        # kv8 serves granite on the same weights
            paths["kv8"], lm_runs["kv8"] = run_kv8(
                torch, np, lm, ops, registry, Engine, Request, counters,
                dev0, kept)
            del kept
            free_card(torch)
        lap(f"path {path}")
    # moe, vlm, encdec: qwen3-moe-30b-a3b (12 of 48 layers) served by
    # Engine; llava-next-34b (8 of 60) and seamless-m4t-medium (whole) at
    # the model level
    paths["moe"], lm_runs["moe"] = run_moe(
        torch, np, lm, ops, registry, Engine, Request, counters, dev0)
    paths["vlm"], lm_runs["vlm"] = run_vlm(torch, np, lm, ops, registry,
                                           counters, dev0)
    paths["encdec"], lm_runs["encdec"] = run_encdec(
        torch, np, lm, ops, registry, counters, dev0)
    lap("paths moe, vlm and encdec")
    # train: gradient steps through the forward kernels under autograd
    paths["train"], lm_runs["train"] = run_train(
        torch, np, lm, ops, registry, counters, dev0)
    lap("path train")
    # pipeline: granite-3-8b's layers as a streaming pipeline
    paths["pipeline"], lm_runs["pipeline"] = run_pipeline(
        torch, np, lm, registry, counters, dev0, model.graph)
    # sharded: the LM steps over a (data, model) mesh of positions
    paths["sharded"], lm_runs["sharded"] = run_sharded(
        torch, np, lm, registry, counters, dev0)
    shares = roofline_shares(registry, lm_runs)
    for kname, path in KERNEL_PATH.items():
        if paths[path][kname] <= 0:
            raise AssertionError(f"{kname} never launched on {path}")

    # ---------------------------------------------------------------- 7
    kernels = []
    for kname, agg in per_kernel.items():
        src, replaces = SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": paths[KERNEL_PATH[kname]][kname],
            "path": KERNEL_PATH[kname],
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": "operations" if agg["ops_ms"] >= agg["bytes_ms"]
            else "bytes",
            # a sum over cases; null where the library refuses a case
            "library_ms": None if agg.get("library_na")
            else agg["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "kernels": kernels,
            "cases": {k: v["cases"] for k, v in per_kernel.items()},
            "main": {"launches": paths, "max_abs_err": err_main,
                     "max_abs_out": scale_main,
                     "fusion_off_max_abs_err": err_off,
                     "ms_per_batch": ms_batch,
                     "frames_per_s": fps, "forward_ms": fwd_ms,
                     "service_p50_ms": lat["p50_ms"], "busy_frac": busy,
                     "forward_ref_ms": ref_ms, "batch": BATCH,
                     "replica_step_spans_ms": spans},
            "quant": {"w8a16_max_abs_err": err_q, "w8a16_max_abs_out":
                      scale_q, "w4a8": a8_4, "per_group": a8_g,
                      "a8_scale_digests": digests,
                      "a8_scale_proof": scale_proof,
                      "a8_failed": a8_failed,
                      "mixed_max_abs_err": err_m, "probes": probes,
                      "per_group_forward": fwd_g,
                      "a8g_exact": exact_a8g,
                      "w8a16_forward_ms": fwd_q,
                      "w8a16_replica_step_spans_ms": spans_q},
            "double": {**double, "a8_sums": sums_a8,
                       "a8_stem_pointer": pointer},
            "stream": {"sums": sums, "issue_split_us": split,
                       "fusion_off_forward": off_fwd},
            "conv": {"sums": sums_conv, "float_forward": fwd_split},
            "pool": {"sums": sums_pool, "nan": nan},
            "attn": {"sums": sums_attn}, "ssd": {"sums": sums_ssd},
            "dec_window": dec_window, "load": load, "tp": tp_run,
            "roofline": shares, **lm_runs, "build_s": info["seconds"]},
            indent=1))
    print(f"[time] chip_smoke.py ran {time.perf_counter() - T0:.0f}s")
    print(f"[card] {smi()}")
    a8_verdict()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
