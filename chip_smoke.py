#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line is printed:

 1. card     the card's name and power limit (nvidia-smi); TF32 off.
 2. build    every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
             with nvcc for sm_90a; build seconds and ptxas' report.
 3. kernels  each kernel against its plain PyTorch version on the card at
             the shapes of its path at ``gpt_345m`` width (serving: 16
             heads of 64, page size 16, 128 pages per sequence, paged
             attention on f32, bf16 and int8 pages at lengths 1..2048,
             then 16 rows x 512, 2 rows x 2048, D 128, page size 32,
             lengths on the split edges with a row of 0, 32 lanes a
             token (D 128 / 256 / 512) over 4096 positions, and D 16,
             each also held
             against the split kernels' mirror, the same bits over two
             runs, the row of 2048 alone the bits it has in the batch of
             16; training:
             LayerNorm over 16384 rows of 1024, flash attention at
             batch 16 x 1024 tokens x 16 heads of 64, causal, dropout
             0.1, read in place from the QKV projection's output, and
             gpt_1p3b's 4 x 1024 x 16 heads of 128, each timed at dropout
             0.1 and 0 against SDPA at the same dropout, then f32 and the
             other head sizes at small shapes; every flash shape (bf16
             and f32, fixed and packed, wide heads too) at dropout 0.1
             and 0, out and lse the same bits over two runs
             as dq, dk and dv: at D 64 and 128 with fixed lengths the
             wgmma forward, dq and dk/dv kernels, packed the wgmma dq and
             dk/dv, elsewhere the mma.sync ones) and at
             ``bert_base`` width (LayerNorm with a residual over 4096 rows
             of 768; softmax cross-entropy over the MLM head's (4096,
             30528) logits with 84% of the rows ignored and over the NSP
             head's (32, 2), then ragged vocabularies); flash at cross
             lengths (kv_len != q_len) and padded head sizes (48, 96);
             flash with ``seq_lens``, with ``causal_shift`` (one shift
             leaving rows no key, one leaving every row none), with an lse
             cotangent folded into delta, and at head sizes 160 (padded to
             256) and 256, bf16 and f32; the packed varlen kernels at
             bench_packed's sequences (8 packed causal sequences of
             64..1024 tokens, 16 heads of 64, bf16, dropout 0 and 0.1,
             both timed, with PyTorch's ``varlen_attn`` as the library
             yardstick where this torch has it (at 0.1 only if it takes a
             dropout), else SDPA on the padded batch), then
             f32, cross lengths with rows that see no key, sequences of
             length 0, no mask, head sizes 48 and 256 and other
             ``block_q``/``block_k`` for the dropout hash's layout (and
             D 320), bf16 at D 128 and 64 over lengths off a multiple of
             128, causal and full, cross and zero lengths; each packed
             set's dq and dk/dv on the route its dtype and head size
             take (bf16 at D 64 and 128 the wgmma kernels, checked under
             the profiler); flash at head sizes past 256 (320 and 512,
             padded to multiples of 128), bf16 and f32, causal and not;
             flash past 65535 (b, h) slices (4097 x 64 tokens x 16 heads,
             D 64 and 32 bf16, D 64 f32) and packed past 65535 heads, at
             both dropouts;
             LayerNorm at widths past its register path (2048 over the
             gpt_1p3b step's 4096 rows, 5120 with a residual, 1003: not a
             multiple of 8; the one-pass backward, its dw and db the same
             bits over two runs, timed beside ``native_layer_norm_backward``
             and the bound; 12288 and 16001 with a residual, rows too wide
             for its stages), bf16 and f32;
             w8a16: each row at M in {1, 2, 5, 16, 17, 64, 512} the
             same bits as alone, two calls the same bits, and M = 1 and
             512 the bits of ``w8a16_split_reference`` (the plain model of
             the kernel's sum order), at (K, N) = (1024, 4096), (4096,
             1024) and (48, 1000) (K off a multiple of 32, N off 16); K =
             48, N = 1000 at M 16 and 512, f32 and bf16 x, and at M =
             65535 * 64 + 1;
             LayerNorm without weight and bias; the fusion pass's block
             kernels at the shapes of its paths (LayerNorm + matmul at
             gpt_345m's (8192, 1024) @ (1024, 3072) and BERT's tied
             decoder, (4096, 768) @ a transposed (30528, 768) table;
             matmul + bias + gelu at (8192, 1024) @ (1024, 4096), tanh, and
             BERT's (4096, 768) @ (768, 3072), erf) in bf16, then f32 and
             the other options at small shapes, both also at the
             gpt_1p3b step's shapes ((4096, 2048) @ (2048, 6144) and @
             (2048, 8192), tanh; timed), LayerNorm + matmul also at K =
             2048 and 5120, with a transposed W at a ragged N (1000), and
             at K = 1003 and 2050, matmul + bias + gelu at K = 1003 (both
             zero-padded to a multiple of 8 by the wrapper); both at output
             widths off a multiple of 16 bytes (BERT's unpadded vocabulary
             30522 through the tied decoder's transposed view and through
             a Linear weight, 4090, 3070) and at 2,097,121 rows, bf16 and
             f32: max abs
             error against the
             stated tolerance, times with CUDA events (median of 30 after
             warm-up, L2 flushed before each launch), and the least time
             the card could take (bytes over 3.35 TB/s or operations over
             the peak for their type).
 4. model    prefill + decode logits on the card against the same steps
             on the CPU, at a small width, fp32 and int8.
 5. serve    ``ServingEngine`` on cuda at the gpt_345m widths (24 layers,
             random weights from seed 0) at fp32, bf16 and int8: 32
             prompts of 16..500 tokens, 32 new tokens each; every kernel
             counter is set to 0 just before ``generate`` and read just
             after; the join/leave contract (solo == inside the batch);
             then, at bf16, one prompt decoded inside a batch of 16
             (bucket 16) and alone (bucket 2), each decode step split
             into its stages, reporting the first stage whose row differs
             bit for bit between the two.
 6. http     one ``/v1/generate`` and one ``/healthz`` over the fp32 engine.
 7. train    the training step of ``bench.py::bench_gpt`` on the card:
             first a small width (gpt_tiny, f32, dropout 0) against the
             same weights' 3-step loss trajectory on the CPU, at
             sequence 64 (plain attention) and at 512 (the flash
             kernels); then the main path, gpt_345m at full width and
             depth (batch 16 x seq 1024, AMP O2 bf16, AdamW with f32
             masters, recompute, dropout 0.1) for 8 steps on a fixed
             batch, the kernel counters set to 0 just before and read
             just after: every loss finite, the last below the first,
             the LayerNorm and flash launches per step as the model's
             structure implies, peak memory, and a profile of where the
             device time goes (the flash forward's and backward's shares
             apart; every flash backward call on the wgmma dq and dk/dv
             kernels, none on the mma.sync ones); then the same step at
             sequence 256, which
             must launch no flash kernel.
 8. bert     the BERT pretraining step (MLM + NSP) on the card: first
             ``bert_tiny`` (f32, dropout 0) against the same weights'
             3-step loss trajectory on the CPU, at sequence 64 with a
             padding mask and at 512 (the flash kernels); then
             ``bert_base`` at 32 x 128, O2 bf16, dropout 0, 3 steps on
             the kernels against the same steps with the LayerNorm and
             cross-entropy wrappers replaced by their plain versions on
             the card (a loss rise after Adam's first, unwarmed step is
             the model's if both show it); then the main
             path of this slice, ``bert_base`` at full width and depth
             (batch 32 x seq 128, AMP O2 bf16, AdamW with f32 masters,
             dropout 0.1, no recompute, 20 MLM targets a sequence) for 8
             steps, the counters set to 0 just before and read just after:
             losses finite, the cross-entropy and LayerNorm (residual
             included) launches per step as the model implies, no flash,
             peak memory and a profile; then 2 steps at batch 8 x 512,
             which must run the flash kernels, non-causal, in each layer.
             Phases 7 and 8 run with the fusion pass off, as PRs 3-5
             measured them.
 9. fusion   the fusion pass on (``paddle_tpu_torch.ops.fusion_pass``):
             first gpt_tiny and bert_tiny (f32, dropout 0) against the
             same weights' 3-step loss trajectories on the CPU; then
             bench_gpt's headline step, gpt_345m at batch 8 x 1024 with
             recompute off (AMP O2 bf16, AdamW with f32 masters, dropout
             0.1) for 8 steps: the rewrites the pass reports, the block
             kernels' (LayerNorm + matmul, matmul + bias + gelu),
             LayerNorm and flash launches per step as the model implies,
             losses finite and falling, peak memory and a profile (the
             flash backward on the wgmma kernels, as in phase 7); then 3
             steps with the pass on against 3 with it off from the same
             weights at dropout 0 (where the attention clusters are
             rewritten too); then the same step with the pass on and off
             in turns, timed; then bert_base at 32 x 128 with the pass
             on, 8 steps, its rewrites and launches per step; then
             bert_base with the unpadded uncased vocabulary (30522) at 32 x
             128, dropout 0, 2 steps with the pass on (the tied decoder at
             N = 30522 through the LayerNorm + matmul kernel) against 2
             with it off; last gpt_1p3b at full width (hidden 2048, 16 heads of 128), 2
             layers, batch 4 x 1024, O2 bf16, no recompute: one forward
             and backward in which each call of rows 7-8 and 11-12 is
             held against its plain version on the same inputs (phase 3's
             tolerances), then 2 steps: its rewrites and launches per
             step; then the same from the same weights with rows 7-8 and
             11-12 on their plain versions: the logits and every
             gradient, read in f32, within WIDE_TOL (relative norm) and
             the losses within FUSION_TOL.
10. packed   ``bench.py::bench_packed`` on the port:
             ``F.flash_attn_unpadded`` over the 8 packed causal sequences
             of 64..1024 tokens (3392 tokens, 16 heads of 64, bf16),
             forward and backward, 10 iterations updating q by dq * 1e-3,
             the counters set to 0 just before and read just after (rows
             4-6 once each an iteration, no row 1-3), against the same
             tokens through the padded flash kernels at (8, 1024, 16, 64):
             out and dq on the valid rows, ms an iteration, tokens/s, the
             padded / packed ratio, each side's device busy time, the
             host's time to build and upload the packed layout; under
             the profiler the packed backward runs the wgmma dq and dk/dv
             kernels once each an iteration and no mma.sync backward
             kernel (their device time an iteration); then 2
             iterations at dropout 0.1 with the run's generator.
11. capture  the captured step (``paddle_tpu_torch.jit.capture``): first
             ``F.embedding``'s backward (the port's fixed summation order)
             8 times at BERT's token-type, position and word shapes and
             GPT's word shape, bf16 and f32, the same bits every run, timed
             beside the library's; then bert_base
             at 32 x 128, dropout 0.1, the fusion pass off and on, then
             bench_gpt's headline step (gpt_345m, 8 x 1024, no recompute,
             pass on), then the recompute step (16 x 1024, pass off): each
             8 steps eager (``step.eager``) and 8 captured (``step(...)``,
             a warm-up that captures one CUDA graph, then 7 replays) from
             the same weights and generator state: losses, every
             parameter, master weight, optimizer slot, the step count and
             the generator's offset the same bits (on BERT, 8 eager steps
             with the token-type table's gradient dropped at one step must
             fail that comparison); 1 compile, 7 hits, no
             fallback; the launches per step of phases 7-9 on both; a
             profiled replay naming the LayerNorm, flash, block and (BERT)
             cross-entropy kernels; then the two in turns (eager, graph,
             graph, eager) for the median step, each profiled for its
             device busy time; peak memory and capture seconds.  A step
             that reads its loss on the host falls back (``capture_unsafe``)
             and runs eagerly.  Then the serving engine's graphs (one a
             prefill and a decode bucket) at fp32, bf16 and int8 over phase
             5's requests, in turns with the same engine's steps run
             eagerly: tokens identical, decode tokens/s, median step and
             peak memory each way; 4 prompts alone as in the batch; a
             weight swap reaching the graphs (their tokens those of the
             new weights run eagerly).
12. schedule the learning rate on the card, its schedules, gradient clipping
             and the optimizer family on the captured steps: bert_base at
             32 x 128 (pass off) under AdamW with BERT's warm-up (4
             steps) and linear decay, and bench_gpt's headline step
             (gpt_345m, 8 x 1024, pass on) under AdamW with Megatron's
             warm-up and cosine decay, both with a global-norm clip of 1.0:
             each 12 steps eager and 12 captured from the same weights,
             the schedule stepped after each: losses, every state tensor
             and the generator offset the same bits, the learning-rate
             tensor ``np.float32`` of the schedule's value at every step, 1
             compile and 11 hits, no fallback, the launches of phase 11;
             on BERT a replay that never writes its learning rate must
             differ from eager; then eager, captured and phase 11's
             schedule-free graph step in turns (medians, busy shares);
             then SGD, Momentum (Nesterov), Adagrad, Adadelta, RMSProp
             (centered, momentum), Adam (amsgrad), Adamax, Lamb, NAdam
             and RAdam on gpt_345m cut to 2 layers (8 x 1024, pass on),
             4 steps eager and 4 captured each, under StepDecay or
             ExponentialDecay with the per-tensor clips and the L1 / L2
             decays in turn: the same bits and 1 compile each.
13. checkpoint  checkpoints on the card, in a temporary directory whose
             free space is checked first (a shortfall fails, named) and
             whose files each path removes after its check: bench_gpt's
             headline step (gpt_345m 8 x 1024, pass on, dropout 0.1,
             phase 12's AdamW with warm-up and cosine, clip 1.0) run 6
             captured steps uninterrupted; a second run saves after step
             3 through a ``CheckpointManager``, synchronously (timed, then
             removed) and asynchronously (the caller's stall timed, the
             run going on while the writer writes; a second async save
             after step 6 timed too, then removed); a fresh step from
             seed 1 restored there runs steps 4-6: every loss, LR reading,
             state tensor and the generator the uninterrupted bits, 1
             compile, no fallback, the launches of phase 12; then the
             same restore into the first run's captured step.  bert_base
             32 x 128 (pass off, BERT's recipe) the same, saving steps 2
             and 3; then step 3 corrupted twice (a flipped byte, which the
             manifest CRC catches; a flipped bit under a re-sealed
             manifest, which only the content digest catches): each time
             ``restore_latest`` falls back to step 2, the error naming the
             leaf, and the restored step runs to the uninterrupted bits.
             Then phase 5's gpt_345m weights through ``save_served_model``
             and ``load_engine`` at fp32, bf16 (decode bucket 16) and
             int8, each engine's tokens on phase 5's requests those of an
             engine built in memory; ``save_quantized_model`` with
             calibration on the card, its directory served against the
             int8 engine; ``logit_divergence`` at full width; then the hot
             reload over HTTP: generation 1 (the weights perturbed) saved,
             ``POST /v1/reload`` with 16 requests in flight, ``/healthz``'s
             ``weights_step`` 1, the tokens after equal to a fresh
             engine's on generation 1, the graphs the same objects, none
             captured again.  Save, restore and reload seconds, GB and
             GB/s, decode tokens/s before and after the reload.
14. hapi     data loading and ``hapi.Model.fit`` over the captured step:
             gpt_345m built from a generator seeded 0, decorated O2 bf16
             before ``Model(...)``, ``AdamW(1e-4, multi_precision=True,
             parameters=...)``, the causal-LM loss, dropout 0.1, no
             recompute, the fusion pass on, fed by a DataLoader (2
             spawned workers, shuffled by a ``RandomState(0)`` sampler)
             over 64 synthetic sequences of 1025 tokens at bench_gpt's
             headline 8 x 1024: one epoch of 8 steps, saving after step 3
             through a ``CheckpointManager`` with the loader's
             ``state_dict()`` as its data state; 1 compile, 7 hits, no
             fallback, the headline step's launches each step; losses and
             every state tensor the bits of ``build_train_step`` fed the
             same batches; a fresh ``Model`` (seed 1) and DataLoader
             restored there run steps 4-8 to the same bits; then ``fit``
             and the bare captured step in turns (fit, step, step, fit):
             median step wall times, the host's wait on the loader each
             step, peak memory; a profiled replay of ``train_batch``
             holding the launches to the counters.  Then the JAX
             package's hapi test classifier (Flatten, Linear 192 -> 32,
             ReLU, Linear 32 -> 4, ``Adam(0.01)``, ``CrossEntropyLoss``,
             ``Accuracy``) through ``fit`` (3 epochs), ``evaluate`` and
             ``predict`` on the card against the CPU's plain path:
             within ``HAPI_CLS_TOL``, the cross-entropy kernels counted
             on the training and eval steps and in a profiled replay.
15. hybrid   data x tensor parallelism (``paddle_tpu_torch.distributed``)
             at the headline GPT-345m widths (hidden 1024, 16 heads,
             vocabulary 50304, 8 x 1024, no recompute, the fusion pass off,
             the same weights from seed 0), each run's ranks started by
             ``spawn`` and reporting to this process: (a) NCCL at a world
             of one, ``fleet.init`` with every degree 1, the mp layers at
             degree 1, O2 bf16, AdamW with ``ClipGradByGlobalNorm(1.0)``,
             dropout 0.1, captured (1 compile, the rest replays, no
             fallback): losses and every state tensor the bits of
             ``build_train_step``'s plain-model step (captured too), the
             clip's global norm read from its ``last_norm`` after each
             replay the plain step's and new each step, the launches of
             rows 1-3 and 7-8 a step on the counters and in a profiled
             replay; then, in the same process, the world-of-one f32 step
             (dropout 0, the same optimizer) at full depth and at
             ``HYBRID_C_LAYERS``: the references.  Every f32 comparison
             below holds, against its reference, the losses within
             ``HYBRID_LOSS_TOL``, the clip's norm after each step within
             ``HYBRID_NORM_RTOL``, the ``gather_params`` of the updates
             (updated minus initial weights) within ``HYBRID_PARAM_TOL``
             element by element and within ``HYBRID_UPDATE_RTOL`` of each
             tensor's update in 2-norm.  (b) mp = 2, two ranks sharing
             the card over gloo (asked for), depth cut to
             ``HYBRID_C_LAYERS``: 2 f32 steps so compared; the planted
             fault (the two ranks trade their shards) must fail the loss
             comparison; then ``HYBRID_STEPS`` (2) bf16 O2 steps
             at dropout 0.1: finite losses, the replicated parameters the
             same bits on both ranks; each rank's launches (flash at 8
             heads).  (c) dp = 2 x mp = 2, four ranks on the card over
             gloo, depth cut to ``HYBRID_C_LAYERS``: ``HYBRID_C_STEPS``
             (2) f32 steps on the global batch so compared, both dp ranks' shards the same
             bits.  (d) with two cards or more, (b) over NCCL, one card a
             rank, captured, its norms read after each replay; otherwise
             one line says it did not run.  The
             gloo runs are eager (gloo's collectives run on the host) and
             their step times are printed as such, not as throughput.
16. zero-pipeline  ZeRO and the pipeline at the same widths, held to
             phase 15's world-of-one f32 references as phase 15 holds
             its runs (losses, the clip's norms, the gathered updates,
             each rank's launches): (a), in phase 15's world-of-one
             process, pp = sharding = 1 with ZeRO's ``os_g`` set by the
             strategy (stage 2), NCCL, O2 bf16, dropout 0.1, captured:
             no ZeRO plan made, every state tensor, the losses, the
             norms and the generator the plain step's bits, launches on
             the counters and in a profiled replay; (b) pp 2 with 2
             virtual stages a rank and 4 micro-batches, two ranks over
             gloo, full depth, 2 f32 steps (a stage's launches: each of
             its 12 blocks once a micro-batch); the planted fault, one
             micro-batch's gradient dropped, must miss the bound on the
             first step's updates; 3 bf16 steps at dropout 0.1: finite
             losses, the tied word embedding the same bits on both
             stages; (c) sharding 2 at ``os_g``, full depth: as (b), the
             two ranks' parameters the same bits, each rank's optimizer
             state at most ``ZP_STATE_SHARE`` of the world of one's, the
             planted fault two ranks' windows traded; (d) mp 2 x pp 2 x
             sharding 2 (eight ranks, the dryrun's mesh), 4 layers, 2
             steps, 2 virtual stages; (e) with two cards or more, (b) over NCCL,
             captured; otherwise one line says it did not run.
17. sep      sequence parallelism, two sep ranks sharing the card over
             gloo unless named: (a) ``ring_attention`` and
             ``ulysses_attention`` at GPT-345m's attention (8 x 1024, 16
             heads of 64), causal, bf16 and f32, dropout 0 and 0.1 with
             one seed: each rank's output and dq/dk/dv shards against
             the world of one's flash kernels on the whole sequence
             within ``SEP_TOL``; before it, rows 1-3 against their plain
             versions at the ring's shifts (``SEP_SHIFTS``: fully masked,
             diagonal, unmasked) with the hash base set, on the wgmma
             kernels (bf16, D 64 and 128) and the mma.sync ones (f32);
             the ring with its masked blocks computed gives the skipped
             run's bits.  (b) GPT-345m 8 x 1024 cut to
             ``HYBRID_C_LAYERS`` layers, sep 2, 2 f32 steps at dropout 0
             against phase 15's cut world-of-one f32 reference and at
             attention dropout 0.1 (hidden 0) against the cut
             world-of-one run at those settings, both as phase 15 holds
             its runs; 2 bf16 O2 steps at dropout 0.1: finite
             losses; each rank's launches of rows 1-3 (the ring computes
             ``r + 1`` blocks on rank ``r``) and 7-8 a step.  (c) the
             dryrun's second mesh, mp 2 x sharding 2 x sep 2 at
             ``os_g`` (eight ranks), ``HYBRID_C_LAYERS`` layers, 2 steps,
             against phase 15's cut reference; each rank's optimizer state at
             most ``ZP_STATE_SHARE`` of the world of one's.  (d)
             bench_packed's packed causal sequences (16 heads of 64,
             bf16) with the heads split over the two ranks: each rank's
             output and gradients the same bits as the whole run's head
             slice.
18. sharded-ckpt  sharded checkpoints of the hybrid steps, inside phase
             16's rank processes (gloo, f32, GPT-345m 8 x 1024): (b) pp 2
             x v 2 x M 4 and (c) sharding 2 at ``os_g`` at full depth,
             (d) mp 2 x pp 2 x sharding 2 at ``HYBRID_C_LAYERS``.  Each
             saves after its first step through a ``CheckpointManager``,
             once synchronously and once asynchronously (every rank its
             windows, in the JAX package's layout, into one directory);
             a fresh step from seed 1 restores each and runs the steps
             left: the losses, every state tensor's bits and the
             generators the uninterrupted run's, each rank's launches of
             rows 1-3 and 7-8 on the counters in the resumed steps.  The
             bytes of the windows the ranks wrote sum to the world of
             one's.  Then, in this process, a world-of-one step restores
             (b)'s and (c)'s files: every window of every rank the same
             bits in its tensors.  Save and restore seconds printed.
19. moe-ep   ``MoELayer`` at GPT-345m's width (D 1024, Dff 4096, 8
             experts, gshard top-2, capacity factor 1.2, 8 x 1024 tokens,
             f32): the world of one on the card (its forward + backward
             ms, eager), then ep 2 and dp 2 x ep 2 over gloo in one
             four-rank spawn: the loss and the loss after one SGD step of
             0.1 (the dryrun's recipe) within ``MOE_LOSS_RTOL`` of the
             world of one's, each rank's experts the world of one's bits
             before the step, and the gradients the step applies (its
             experts' windows and the gate's, averaged over the data
             group; a fixed stride of elements) within ``MOE_GRAD_RTOL``
             of the world of one's, in norm.
20. engine   the auto-parallel ``Engine`` and the launcher: (a)
             GPT-345m 8 x 1024 through ``Engine.fit`` at a world of one
             (O2 bf16 from ``strategy.amp``, no dynamic loss scaling,
             dropout 0.1, AdamW, the fusion pass on, no recompute), 8
             steps from a DataLoader over batches staged on the card, in
             turns Engine / bare ``build_train_step`` / bare / Engine on
             the same weights and batches: the losses and every state
             tensor the same bits after each pair of turns, 1 capture
             and 7 replays each, both medians; then an Engine saves
             after step 3 and a fresh Engine's ``restore_latest``
             resumes steps 4-6 to the uninterrupted run's bits.  (b)
             ``python -m paddle_tpu_torch.distributed.launch
             --nproc_per_node 2`` on a worker script written here: each
             rank joins gloo on the card and runs ``Engine.fit`` at
             sharding 2 (stage 2, ``os_g``) on GPT-345m's widths at
             ``HYBRID_C_LAYERS`` layers, f32, dropout 0, 3 steps: each
             rank's losses within ``ENGINE_LOSS_TOL`` of the world of
             one's, the launcher's code 0, each rank's ``workerlog``.
             (c) in the same ranks: one ``rpc_sync`` each way, and a
             ``ShardedEmbedding`` over the two ranks (GPT's vocabulary x
             1024, 8 x 1024 ids a rank): each rank's rows and its window
             of the table's gradient the bits of ``F.embedding`` on the
             whole table over both ranks' ids.  Rows 1-3 and 7-8 counted
             on (a)'s replays and (b)'s ranks.  Budget 80 s.
21. telemetry and tuner  the observability core on paths the earlier
             phases already run, then the auto-tuner; budget 60 s, (d)
             45 s of it.  (a) on phase 6's fp32 engine: telemetry on, 4
             requests to ``/v1/generate``, ``GET /metrics`` answers 200
             in Prometheus text, whose request, completion and token
             counters equal what was posted and returned, the queue
             depth 0, the KV page gauges the pool's own counts, the HTTP
             latency histogram 4 requests.  (b) on phase 14's GPT fit:
             turns off / on / on / off of 8 steps (an epoch) from
             a 2-worker DataLoader (forked workers: a spawned one takes
             15-20 s to start on the chip machine), each step ending in
             the loss read on the host: with telemetry on, 16 train
             steps, the capture's hits and misses on the counters, 16
             data waits, the ``bytes_in_use`` gauge equal to
             ``torch.cuda.memory_stats()`` at the step it was read, 16
             ``step`` records in the JSONL sink; the on and off medians
             printed.  (c) in phase 20 (b)'s launched ranks: each rank's
             ``pt_collective_*`` counts and bytes a collective equal to
             what its ZeRO plan implies (the reducer's buckets, the
             windows' all-gathers, the clip's and the loss's
             all-reduces a step) and its bucket plan booked once.  (d)
             ``AutoTuner`` on GPT-345m at sequence 1024 on this card
             (``Cluster.auto_detect()``): micro-batch {8, 16} x
             recompute {off, on}, each trial a captured
             ``build_train_step``, 1 capture and 4 replays, tokens/s
             from the replays' median, predicted and measured step times
             side by side; ``get_best()`` the fastest trial, no trial
             the cost model kept out of memory, the recorder's CSV read
             back.
Phases 5-9 run the training steps and the serving engine as users do:
on the card, through their CUDA graphs (the kernel counters count a
replay's launches, as phase 11 checks against the eager steps).

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``.  Exits non-zero when no CUDA device
is present, and when run without the ``paddle_tpu_torch`` package beside
it.
"""
from __future__ import annotations

import dataclasses
import gc
import inspect
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import torch

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
TIMED_ITERS = 30
GPT_345M = dict(vocab_size=50304, hidden=1024, layers=24, heads=16,
                max_seq_len=2048, ffn_mult=4)
PAGE_SIZE = 16
# phase 3's paged attention sets (rows 13-14), the serve shape first: its
# times are the kernels line's; then the serve profile's 16 rows x 512,
# a solo decode bucket, gpt_1p3b's head size, a page size of 32, lengths
# on the kernels' split edges (128 positions) with a row of 0, a token's
# row over 32 lanes in every page dtype with a table past the combine's
# batch of 16 splits, and over 4, 2 and 1 lanes (head size 16)
PAGED_LENGTHS = [1, 16, 17, 100, 255, 256, 511, 700, 1000, 1023, 1024, 1500,
                 1777, 2000, 2047, 2048]
PAGED_SETS = (
    ("B=16 H=16 D=64 ps=16 lengths 1..2048", {}),
    ("16 rows x 512", dict(lengths=[512] * 16)),
    ("2 rows x 2048", dict(lengths=[2048, 2048])),
    ("D=128 lengths 1..2048", dict(d=128)),
    ("ps=32 lengths 1..2048", dict(ps=32)),
    ("split edges and length 0", dict(lengths=[
        0, 1, 127, 128, 129, 255, 256, 257, 383, 384, 1023, 1024, 1025,
        2047, 2048, 16])),
    ("D=128/256/512 width 4096", dict(
        d={"f32": 128, "bf16": 256, "int8": 512}, width=4096,
        lengths=[4096, 2049, 1000, 0])),
    ("D=16", dict(d=16)),
)
TOL = {"f32": 2e-5, "int8": 2e-5, "bf16": 2e-2}
MODEL_TOL = {"fp32": 1e-4, "int8": 1e-2}

LN_TOL = {"f32": dict(abs=1e-5, rel_dw_db=1e-4),
          "bf16": dict(abs=2e-2, rel=2e-2)}   # |err| <= abs + rel * |ref|
TRAIN_TOL = 1e-4                            # card vs CPU loss, f32
# bert_base O2 bf16 on the kernels vs on their plain versions: relative
# loss difference (bf16 rounds in other places, through 12 layers)
BERT_PLAIN_TOL = 5e-3
# the fusion pass on vs off, gpt_345m 8 x 1024 O2 bf16, dropout 0: relative
# loss difference (the block kernels add the bias and take gelu on the f32
# sum where the unfused step rounds to bf16 first; 24 layers)
FUSION_TOL = 5e-3
FUSED_BATCH, FUSED_STEPS, FUSED_CMP_STEPS = 8, 8, 3     # bench_gpt's rung
# logit_divergence of gpt_345m (fp32 against int8) on the card against the
# same call on the CPU's plain path, same weights and prompts: relative
# gap.  The int8 weights are the same bits on both; the int8 KV pages
# round activations that differ in fp32's last bits, so a level may flip
DIVERGENCE_RTOL = 5e-2
# the block kernels against their plain versions: max |err| within this
# share of max |ref| (f32: sums in another order; bf16: about 2.5 bf16
# steps of the largest output, one rounding of h and of the output)
BLOCK_TOL = {"f32": 1e-4, "bf16": 1e-2}
# gpt_1p3b at full width (hidden 2048, 16 heads of 128), depth cut to 2
# layers: the width the port's LayerNorm and block kernels took first in
# PR 8, at bench_gpt's sequence
WIDE_LAYERS, WIDE_BATCH, WIDE_STEPS = 2, 4, 3
# its first forward and backward on the kernels against the same on rows
# 7-8 and 11-12's plain versions, read in f32: ||got - want|| / ||want||
# for the logits and for each parameter's gradient (both sides sum in f32
# and round to bf16 in the same places, in another order: about one bf16
# step, 2^-8, on a share of the elements)
WIDE_TOL = 1e-2
# w8a16: row r of a launch of M rows has the bits of row r launched alone
W8A16_BITS_M = (1, 2, 5, 16, 17, 64, 512)
# shapes the card once refused: w8a16 at K off a multiple of 32 and N off a
# multiple of 16, and past 65535 of the prefill route's 64-row blocks
W8A16_ODD_K, W8A16_ODD_N, W8A16_MANY_ROWS = 48, 1000, 65535 * 64 + 1
# the block kernels past 65535 of the f32 kernels' 32-row blocks
BLOCK_MANY_ROWS = 65535 * 32 + 1
# flash past 65535 slices: 4097 x 16 = 65552 (b, h) slices of 64 tokens;
# packed, 65540 heads
FLASH_MANY_SLICES, PACKED_MANY_HEADS = (4097, 64, 16), 65540
# BERT's unpadded uncased vocabulary (incubate/models/bert.py names it)
BERT_UNPADDED_VOCAB, BERT_VOCAB_STEPS = 30522, 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 8
SHORT_SEQ, SHORT_STEPS = 256, 3             # below the flash lengths
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 8        # phase-1 pretraining
BERT_LONG_BATCH, BERT_LONG_SEQ, BERT_LONG_STEPS = 8, 512, 2   # phase 2
BERT_HIDDEN, BERT_HEADS, BERT_VOCAB = 768, 12, 30528
# phase 11: steps eager and captured, then turns a b b a of the two
CAPTURE_STEPS, CAPTURE_TURN_STEPS = 8, 2
CAPTURE_TURNS = ("eager", "graph", "graph", "eager")
# the parameter whose gradient a planted fault drops at the middle step of
# an eager run (BERT's token-type table, 2 rows x 4096 ids): the bit
# comparison of phase 11 must see it
PLANTED = "token_type_embeddings.weight"
# F.embedding's backward against the library's on the card, max |diff| over
# max |g|: both sum in f32 (in another order); bf16 rounds each once
EMBED_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# phase 12: the scheduled, clipped steps (eager and captured), then the
# optimizer sweep on gpt_345m cut to SWEEP_LAYERS layers
SCHEDULE_STEPS = 12
SWEEP_LAYERS, SWEEP_STEPS = 2, 4
# phase 13: steps of the uninterrupted run, the step saved and resumed
# from, and the free disk a path needs over the bytes it writes
RESUME_STEPS, RESUME_SAVE_AT, CKPT_DISK_MARGIN = 6, 3, 1.2
# phase 14: GPT through hapi's fit from the DataLoader (sequences of the
# synthetic dataset, loader workers, the step saved after and resumed
# from), fit and the bare captured step in turns; the classifier's data
# and its card-vs-CPU tolerance (f32: losses, eval loss and accuracy,
# predictions after 6 Adam(0.01) steps)
HAPI_SEQS, HAPI_WORKERS, HAPI_SAVE_AT = 64, 2, 3
HAPI_TURNS = ("fit", "step", "step", "fit")
HAPI_CLS_SIZE, HAPI_CLS_TOL = 64, 1e-4
# phase 15: data x tensor parallelism.  (a)'s plain and degree-1 steps, the
# f32 steps of the references, (b), (c) and (d); the cut depth
HYBRID_BATCH, HYBRID_A_STEPS, HYBRID_STEPS = 8, 4, 2
HYBRID_C_LAYERS = 4
# the runs at HYBRID_C_LAYERS (phase 15 (b), (c), 16 (d), 17 (b), (c) and
# their world-of-one references) take 2 steps, cut from 3 to keep the
# whole run inside its clock when phase 17 came; the full-depth runs
# (phase 16 (b), (c)) take HYBRID_STEPS, and phase 15 (b) and 17 (b) run
# at HYBRID_C_LAYERS, cut from full depth, since phase 20 came (a whole
# run on a slower host took 1264.7 s, every phase 25-40% over the usual)
HYBRID_C_STEPS = 2
HYBRID_LR, HYBRID_CLIP = 1e-4, 1.0
# sharded against the world-of-one step, f32: losses within the bound the
# JAX hybrid step is held to (__graft_entry__.py:163-169).  AdamW's first
# steps move a weight by up to about lr a step (3e-4 in all); each weight
# after the steps within lr of the reference's (the readings: 3.666e-05 at
# mp 2, 2.059e-05 at dp 2 x mp 2), and each tensor's update (updated minus
# initial weights) within HYBRID_UPDATE_RTOL of the reference's update in
# 2-norm, so a shard left as it was (about 0.7) or moved the wrong way (2)
# fails
HYBRID_LOSS_TOL = 1e-4
HYBRID_PARAM_TOL = HYBRID_LR
HYBRID_UPDATE_RTOL = 1e-2
# AdamW's update hardly moves when every gradient is scaled alike, so the
# losses cannot show a wrong clip: its global norm (the shards' squares
# all-reduced over mp, the replicated ones counted once), read from the
# clip's last_norm after each step (a captured step's replay writes it),
# is held to the world of one's, f32 sums in another order
HYBRID_NORM_RTOL = 1e-5
# (a)'s process group: NCCL at a world of one (a rehearsal on the CPU sets
# gloo); seconds a run's ranks may take
HYBRID_BACKEND, HYBRID_TIMEOUT = "nccl", 420
# phase 16: ZeRO and the pipeline.  (b)'s pipeline (stages, virtual stages
# a rank, micro-batches); (c) sharding 2 at os_g; (d) mp 2 x pp 2 x
# sharding 2 at HYBRID_C_LAYERS, 2 virtual stages; their references are
# phase 15's world-of-one f32 runs; a ZeRO rank's optimizer state at most
# ZP_STATE_SHARE of the world of one's; the word embedding, tied across
# the first and the last stage
ZP_PP, ZP_V, ZP_M = 2, 2, 4
ZP_STATE_SHARE = 0.55
ZP_WORD = "gpt.embeddings.word_embeddings.weight"
# phase 18: the checkpoint directory's filesystem must hold the two
# checkpoints of a run and the two kept for the world of one's loads
# (CKPT_DISK_MARGIN over their bytes)
# phase 19: the MoE layer at GPT-345m's width; the tokens split over dp
# ranks and the experts over ep ranks route as the whole batch does, but
# the gate's product over fewer rows may round otherwise, and a token near
# a tie may change expert: the losses within MOE_LOSS_RTOL of the world of
# one's, relative.  The SGD step moves the loss only about 2e-4 relative,
# so the gradients it applies are held too, each within MOE_GRAD_RTOL of
# the world of one's in norm (a rank's expert gradient dropped, or summed
# where it is averaged, reads 1.0), on every MOE_SAMPLES-th element
MOE_D, MOE_DFF, MOE_E, MOE_CF, MOE_TOKENS = 1024, 4096, 8, 1.2, 8 * 1024
MOE_LOSS_RTOL, MOE_GRAD_RTOL, MOE_TIMED = 1e-4, 1e-3, 5
MOE_SAMPLES = 1 << 16
# phase 20: Engine.fit against the bare step (steps a turn, the step saved
# after and resumed from); the launched sharding-2 ranks' steps, held to
# the world of one's losses within phase 15's reading (9.537e-07, the
# largest difference of its f32 ranks), and the launch's time limit
ENGINE_STEPS, ENGINE_SAVE_AT, ENGINE_RESUME_TO = 8, 3, 6
ENGINE_TURNS = ("engine", "bare", "bare", "engine")
ENGINE_LAUNCH_STEPS, ENGINE_LOSS_TOL, ENGINE_LAUNCH_TIMEOUT = 3, 9.537e-07, 300
# phase 21: (a)'s requests; (b)'s turns, each one epoch of phase 14's
# loader (HAPI_SEQS / FUSED_BATCH = 8 steps; the memory gauges read at
# each turn's last step); (d)'s candidates (micro-batch x recompute at
# TRAIN_SEQ, one card) and its replays a trial
TELEMETRY_REQUESTS = 4
TELEMETRY_TURNS = (False, True, True, False)
TUNER_MBS, TUNER_RECOMPUTE, TUNER_REPLAYS = (8, 16), (False, True), 4
# each phase-21 part's seconds, for the phase's total
PHASE21_S = {}
# phase 17: sequence parallelism over SEP_DEGREE ranks on the card; the
# ring's causal shifts on a 512-row block (its keys all after its queries,
# the diagonal, all before), each with the hash base of the ring step that
# has it; a ring's output is merged in f32 from its blocks' outputs and
# rounded again, and its gradients summed from its blocks', so in bf16 it
# is held to twice the flash kernels' bound (two roundings), in f32 to
# theirs
SEP_DEGREE = 2
SEP_SHIFTS = {-512: (0, 512), 0: (512, 512), 512: (512, 0)}
SEP_TOL = {"f32": dict(abs=2e-5, grad=1e-4),
           "bf16": dict(abs=4e-2, rel=4e-2)}
MLM_IGNORED = 0.84          # share of MLM rows whose label is -100
# softmax cross-entropy: loss and lse within 1e-5 of max(1, |ref|); dx
# within 1e-6 in f32, within one bf16 step of the plain version's f32
# result rounded to bf16
XENT_TOL = {"loss": 1e-5, "f32": 1e-6, "bf16": "1 ulp"}
# flash attention: f32 out and lse, f32 gradients; bf16 |err| <= abs + rel *
# |ref| (one bf16 rounding of outputs that reach |x| ~ 10)
FLASH_TOL = {"f32": dict(abs=2e-5, grad=1e-4),
             "bf16": dict(abs=TOL["bf16"], rel=TOL["bf16"])}
FLASH_DROPOUT, FLASH_SEED = 0.1, 20250917
# every flash and packed check runs at both: each kernel is built with and
# without dropout, and a wrong keep mask shows only at the first
FLASH_DROPOUTS = (FLASH_DROPOUT, 0.0)
# bench.py::bench_packed: 8 packed causal sequences of 64..1024 tokens (3392
# against 8 x 1024 padded), gpt_345m's attention (16 heads of 64), bf16
PACKED_LENS = [64, 128, 896, 256, 1024, 192, 512, 320]
PACKED_HEADS, PACKED_HD, PACKED_ITERS = 16, 64, 10
PACKED_PATH = "packed 8 seqs 64..1024"

REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:144",
    "paged_attention_int8": "paddle_tpu/ops/paged_attention.py:303",
    "w8a16_matmul": "paddle_tpu/ops/quant_kernels.py:132",
    "layer_norm_fwd": "paddle_tpu/ops/fused_kernels.py:198",
    "layer_norm_bwd": "paddle_tpu/ops/fused_kernels.py:245",
    "flash_fwd": "paddle_tpu/ops/pallas_ops.py:233",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_ops.py:396",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_ops.py:418",
    "flash_packed_fwd": "paddle_tpu/ops/pallas_ops.py:930",
    "flash_packed_bwd_dq": "paddle_tpu/ops/pallas_ops.py:978",
    "flash_packed_bwd_dkv": "paddle_tpu/ops/pallas_ops.py:1005",
    "softmax_xent_fwd": "paddle_tpu/ops/fused_kernels.py:445",
    "softmax_xent_bwd": "paddle_tpu/ops/fused_kernels.py:476",
    "ln_matmul": "paddle_tpu/ops/fused_kernels.py:792",
    "matmul_bias_gelu": "paddle_tpu/ops/fused_kernels.py:965",
}
SOURCES = {
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_int8": "paddle_tpu_torch/csrc/paged_attention.cu",
    "w8a16_matmul": "paddle_tpu_torch/csrc/w8a16.cu",
    "layer_norm_fwd": "paddle_tpu_torch/csrc/layer_norm.cu",
    "layer_norm_bwd": "paddle_tpu_torch/csrc/layer_norm.cu",
    "flash_fwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dq": "paddle_tpu_torch/csrc/flash_attention_dq.cu",
    "flash_bwd_dkv": "paddle_tpu_torch/csrc/flash_attention_dkv.cu",
    "flash_packed_fwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_packed_bwd_dq": "paddle_tpu_torch/csrc/flash_attention_dq.cu",
    "flash_packed_bwd_dkv": "paddle_tpu_torch/csrc/flash_attention_dkv.cu",
    "softmax_xent_fwd": "paddle_tpu_torch/csrc/softmax_xent.cu",
    "softmax_xent_bwd": "paddle_tpu_torch/csrc/softmax_xent.cu",
    "ln_matmul": "paddle_tpu_torch/csrc/block_gemm.cu",
    "matmul_bias_gelu": "paddle_tpu_torch/csrc/block_gemm.cu",
}
SERVE_KERNELS = ("paged_attention", "paged_attention_int8", "w8a16_matmul")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PACKED_KERNELS = ("flash_packed_fwd", "flash_packed_bwd_dq",
                  "flash_packed_bwd_dkv")
LN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd")
XENT_KERNELS = ("softmax_xent_fwd", "softmax_xent_bwd")
TRAIN_KERNELS = LN_KERNELS + FLASH_KERNELS
BLOCK_KERNELS = ("ln_matmul", "matmul_bias_gelu")
# every CUDA kernel (each ``__global__`` function of
# ``paddle_tpu_torch/csrc/*.cu``) under the share of a step's device time
# the profiles report it in; a profile finds a kernel by its name in the
# profiler's key, so a kernel missing here drops out of those shares
PROFILE_KERNELS = {
    "LayerNorm forward": ("ln_fwd_kernel", "ln_fwd_any_kernel",
                          "ln_fwd_staged_kernel"),
    "LayerNorm backward": ("ln_bwd_kernel", "ln_bwd_reduce_kernel",
                           "ln_bwd_one_pass_kernel"),
    "flash forward": ("flash_fwd_kernel", "flash_fwd_wg_kernel",
                      "flash_fwd_wide_kernel"),
    "flash backward": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                       "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel",
                       "flash_bwd_dq_wide_kernel",
                       "flash_bwd_dkv_wide_kernel"),
    "cross-entropy": ("xent_fwd_kernel", "xent_bwd_kernel"),
    "LayerNorm + matmul": ("ln_matmul_kernel", "lnmm_whole_kernel",
                           "lnmm_stats_kernel", "lnmm_stream_kernel"),
    "matmul + bias + gelu": ("mm_gelu_kernel", "mbg_kernel"),
    "paged attention": ("paged_split_kernel", "paged_combine_kernel"),
    "w8a16": ("w8a16_kernel", "w8a16_split_kernel"),
}
# each wrapper's launch runs exactly one of these kernels (the others it
# may add: a LayerNorm backward's reduce kernel, a streamed LayerNorm +
# matmul's stats kernel, a paged call's split kernel).  So their counts in
# a profile are the wrappers' launches as the card ran them: the check on
# the counters that a CUDA graph's replay adds (phase 11).  The paged
# wrappers share their kernels and are counted together; the packed
# wrappers' kernels are the flash ones, never on a captured path.  A
# LayerNorm kernel's residual variant is its third template argument.
HEAD_KERNELS = {
    ("layer_norm_fwd",): ("ln_fwd_kernel", "ln_fwd_any_kernel",
                          "ln_fwd_staged_kernel"),
    ("layer_norm_bwd",): ("ln_bwd_kernel", "ln_bwd_one_pass_kernel"),
    ("flash_fwd",): ("flash_fwd_kernel", "flash_fwd_wg_kernel",
                     "flash_fwd_wide_kernel"),
    ("flash_bwd_dq",): ("flash_bwd_dq_kernel", "flash_bwd_dq_wg_kernel",
                        "flash_bwd_dq_wide_kernel"),
    ("flash_bwd_dkv",): ("flash_bwd_dkv_kernel", "flash_bwd_dkv_wg_kernel",
                         "flash_bwd_dkv_wide_kernel"),
    ("softmax_xent_fwd",): ("xent_fwd_kernel",),
    ("softmax_xent_bwd",): ("xent_bwd_kernel",),
    ("ln_matmul",): ("ln_matmul_kernel", "lnmm_whole_kernel",
                     "lnmm_stream_kernel"),
    ("matmul_bias_gelu",): ("mm_gelu_kernel", "mbg_kernel"),
    ("paged_attention", "paged_attention_int8"): ("paged_combine_kernel",),
    ("w8a16_matmul",): ("w8a16_kernel", "w8a16_split_kernel"),
}
# the flash backward's kernels on the GPT steps (bf16, fixed lengths, D =
# 64): the wgmma ones, and not the mma.sync ones
WG_FLASH_BWD = ("flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel")
MMA_FLASH_BWD = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
# the flash forward's: the packed forward's route is checked as the
# backward's (bf16 at D 64 and 128 the wgmma kernel)
WG_FLASH_FWD, MMA_FLASH_FWD = ("flash_fwd_wg_kernel",), ("flash_fwd_kernel",)
FLASH_ROUTES = WG_FLASH_FWD + MMA_FLASH_FWD + WG_FLASH_BWD + MMA_FLASH_BWD


def log(*args):
    print(*args, flush=True)


# -- timing ------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events.

    Before each timed call the L2 cache is flushed (a 256 MB write) and
    the stream is held busy by a spin kernel, so the host has enqueued
    the call before the start event fires: the pair measures the device
    work, not the host's launch overhead.
    """

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn, iters=TIMED_ITERS, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("[card]", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "| cuda", torch.version.cuda, "| devices", torch.cuda.device_count())
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] TF32 off for matmul and cuDNN")
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build(_build.SOURCES, verbose=True)
    secs = time.perf_counter() - t0
    for name, (path, out) in built.items():
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log(f"[build] {name}: {path.name}")
        for ln in lines:
            log("   ", ln)
    log(f"[build] {len(built)} libraries in {secs:.2f} s")


def _paged_inputs(gen, kv_dtype, lengths=None, h=16, d=64, ps=PAGE_SIZE,
                  width=None):
    """Serve shapes by default: B = 16 rows, H = 16, D = 64, ps = 16, 128
    pages per row (``width`` 2048 positions, gpt_345m's ``max_seq_len``),
    ragged lengths from 1 to 2048 with an exact page and partly filled
    last pages; every row's table has dead pages."""
    from paddle_tpu_torch.ops.quant_kernels import quantize_kv
    lengths = PAGED_LENGTHS if lengths is None else lengths
    width = GPT_345M["max_seq_len"] if width is None else width
    b, maxp = len(lengths), width // ps
    n_pages = 1 + b * maxp
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    perm = torch.randperm(n_pages - 1, generator=gen, device=DEVICE) + 1
    tables = perm.reshape(b, maxp).to(torch.int32).contiguous()
    qdt = torch.bfloat16 if kv_dtype == torch.bfloat16 else torch.float32
    q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(qdt)
    k = torch.randn(n_pages, ps, h, d, generator=gen, device=DEVICE)
    v = torch.randn(n_pages, ps, h, d, generator=gen, device=DEVICE)
    if kv_dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return q, kq, vq, ks, vs, tables, lengths
    return q, k.to(kv_dtype), v.to(kv_dtype), None, None, tables, lengths


def _paged_bytes_flops(q, k, ks, tables, lengths):
    b, h, d = q.shape
    ps = k.shape[1]
    live = lengths.long().sum().item()
    live_pages = ((lengths.long() + ps - 1) // ps).sum().item()
    nbytes = (2 * q.numel() * q.element_size()        # q in, out
              + 2 * live * h * d * k.element_size()   # live K and V
              + 4 * live_pages + 4 * b)               # page ids, lengths
    if ks is not None:
        nbytes += 2 * live * h * 4                    # live K/V scales
    return nbytes, 4.0 * live * h * d


def _paged_set(timer, gen, tag, kv_dtype, label, shape, main):
    """One paged attention set against its plain version (rows with a
    live position; the plain version gives a row of length 0 the mean of
    V, the kernels 0, as the Pallas kernel) and against the split
    kernels' mirror (every row), within ``TOL``; two runs the same bits;
    the kernel's time beside its bound.  At the serve shape (``main``)
    also: the longest row (2048) alone the bits it has in the batch."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_int8,
        paged_attention_int8_reference, paged_attention_reference,
        paged_attention_split_reference)
    shape = {key: val[tag] if isinstance(val, dict) else val
             for key, val in shape.items()}
    q, k, v, ks, vs, pt, ln = _paged_inputs(gen, kv_dtype, **shape)
    if ks is None:
        name = "paged_attention"
        kern = lambda q, pt, ln: paged_attention(q, k, v, pt, ln)  # noqa: E731
        ref = lambda: paged_attention_reference(q, k, v, pt, ln)  # noqa: E731
        scales = {}
    else:
        name = "paged_attention_int8"
        kern = lambda q, pt, ln: paged_attention_int8(  # noqa: E731
            q, k, v, ks, vs, pt, ln)
        ref = lambda: paged_attention_int8_reference(  # noqa: E731
            q, k, v, ks, vs, pt, ln)
        scales = dict(k_scale=ks, v_scale=vs)
    run = lambda: kern(q, pt, ln)  # noqa: E731
    out, again = run(), run()
    want, mirror = ref(), paged_attention_split_reference(q, k, v, pt, ln,
                                                          **scales)
    torch.cuda.synchronize()
    live = ln > 0
    err = (out.float() - want.float())[live].abs().max().item()
    err_mirror = (out.float() - mirror.float()).abs().max().item()
    checks = {
        "finite": bool(torch.isfinite(out.float()).all()),
        f"plain within {TOL[tag]:.0e}": err <= TOL[tag],
        f"mirror within {TOL[tag]:.0e}": err_mirror <= TOL[tag],
        "length 0 gives 0": not out[~live].float().any(),
        "two runs the same bits": torch.equal(out, again),
    }
    if main:
        r = int(torch.argmax(ln))       # the row of length 2048
        alone = kern(q[r:r + 1], pt[r:r + 1], ln[r:r + 1])
        torch.cuda.synchronize()
        checks[f"row {int(ln[r])} alone == in the batch of {len(ln)}"] = \
            torch.equal(alone[0], out[r])
    b, h, d = q.shape
    nbytes, flops = _paged_bytes_flops(q, k, ks, pt, ln)
    t_bound, by = bound_ms(nbytes, flops, torch.float32)
    ms, plain = timer(run), timer(ref)
    failed = [c for c, ok in checks.items() if not ok]
    log(f"[kernel] {name}[{tag}] {label} (B={b} H={h} D={d} "
        f"ps={k.shape[1]}): max_abs_err {err:.3e} against plain, "
        f"{err_mirror:.3e} against the split mirror (tol {TOL[tag]:.0e}); "
        f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {t_bound:.4f} ms "
        f"({by}, {t_bound / ms:.2f} of it); checks "
        f"{'all pass' if not failed else 'FAIL: ' + ', '.join(failed)}; no "
        f"single PyTorch call computes paged attention")
    if failed:
        raise AssertionError(f"{name}[{tag}] {label}: {failed} (max abs err "
                             f"{err} plain, {err_mirror} mirror)")
    variant = tag if main else f"{tag} {label}"
    return name, dict(variant=variant, max_abs_err=max(err, err_mirror),
                      tol=TOL[tag], ms=ms, plain_ms=plain, bound_ms=t_bound,
                      bound_by=by, library_ms=None)


def phase_kernels(timer):
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}

    for tag, kv_dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                          ("int8", torch.int8)):
        for i, (label, shape) in enumerate(PAGED_SETS):
            name, row = _paged_set(timer, gen, tag, kv_dtype, label, shape,
                                   main=i == 0)
            results.setdefault(name, []).append(row)

    hid, ffn = GPT_345M["hidden"], GPT_345M["hidden"] * 4
    # one layer's six products: q, k, v, o, then the MLP's w1 and w2
    layer = [(hid, hid)] * 4 + [(hid, ffn), (ffn, hid)]
    rows = results["w8a16_matmul"] = []
    for m in (16, 512):
        ops = [_w8a16_operands(gen, m, kk, nn, torch.float32)
               for kk, nn in layer]
        rows.append(_w8a16_entry(timer, ops, f"one layer's 6 products at "
                                 f"M={m}, timed as one call", TOL["f32"]))
        for i in (0, 4, 5):   # each shape alone
            kk, nn = layer[i]
            rows.append(_w8a16_entry(timer, ops[i:i + 1],
                                     f"M={m} K={kk} N={nn}", TOL["f32"]))
    for kk, nn in layer[3:]:  # bf16 activations, at decode
        ops = [_w8a16_operands(gen, 16, kk, nn, torch.bfloat16)]
        rows.append(_w8a16_entry(timer, ops, f"bf16 x, M=16 K={kk} N={nn}",
                                 TOL["bf16"]))
    for kk, nn in layer[3:]:  # the serve engine's contract, f32 x
        rows.append(_w8a16_rows_alone(gen, kk, nn))
    # any K and N: a hidden size off a multiple of 32 (48, which the wrapper
    # pads to 64 columns of x) and an output width off a multiple of 16
    # (1000, the weight read by plain loads), at decode and prefill, f32 and
    # bf16 x, with the rows-alone contract and the split model's bits; and
    # past 65535 row blocks of the prefill route (M = 65535 * 64 + 1)
    for m, x_dtype, tag in ((16, torch.float32, "f32"),
                            (512, torch.float32, "f32"),
                            (16, torch.bfloat16, "bf16")):
        ops = [_w8a16_operands(gen, m, W8A16_ODD_K, W8A16_ODD_N, x_dtype)]
        rows.append(_w8a16_entry(timer, ops, f"{tag} x, M={m} K={W8A16_ODD_K}"
                                 f" N={W8A16_ODD_N}", TOL[tag]))
    rows.append(_w8a16_rows_alone(gen, W8A16_ODD_K, W8A16_ODD_N))
    ops = [_w8a16_operands(gen, W8A16_MANY_ROWS, W8A16_ODD_K, 40,
                           torch.float32)]
    rows.append(_w8a16_entry(timer, ops, f"f32 x, M={W8A16_MANY_ROWS} "
                             f"K={W8A16_ODD_K} N=40", TOL["f32"]))
    del ops
    torch.cuda.empty_cache()

    # the training step's LayerNorm: batch 16 x seq 1024 rows of hidden
    # 1024, bf16 under O2 (the main path) and f32
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd, bwd = _layer_norm_entries(timer, gen, tag, dtype,
                                       TRAIN_BATCH * TRAIN_SEQ,
                                       GPT_345M["hidden"], 1e-5)
        results.setdefault("layer_norm_fwd", []).append(fwd)
        results.setdefault("layer_norm_bwd", []).append(bwd)
    # BERT's post-LN blocks: LayerNorm of x + residual over batch 32 x
    # seq 128 rows of hidden 768, eps 1e-12, bf16 and f32; then bf16
    # without a residual, as BERT's embeddings and MLM head run it
    for tag, dtype, residual in (("bf16", torch.bfloat16, True),
                                 ("f32", torch.float32, True),
                                 ("bf16", torch.bfloat16, False)):
        fwd, bwd = _layer_norm_entries(timer, gen, tag, dtype,
                                       BERT_BATCH * BERT_SEQ, BERT_HIDDEN,
                                       1e-12, residual=residual)
        results["layer_norm_fwd"].append(fwd)
        results["layer_norm_bwd"].append(bwd)

    # widths past the register path (GPT-1.3B's 2048 at its step's 4 x
    # 1024 rows, GPT-13B's 5120 with a residual) and a d that is not a
    # multiple of 8: the one-pass backward; then rows too wide for its two
    # stages beside the column sums (read in place twice), 16-byte rows and
    # not, with a residual
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for rows, d, residual in ((WIDE_BATCH * TRAIN_SEQ, 2048, False),
                                  (2048, 5120, True), (2048, 1003, True),
                                  (2048, 1003, False), (300, 12288, True),
                                  (100, 16001, True)):
            fwd, bwd = _layer_norm_entries(timer, gen, tag, dtype, rows, d,
                                           1e-5, residual=residual)
            results["layer_norm_fwd"].append(fwd)
            results["layer_norm_bwd"].append(bwd)
        torch.cuda.empty_cache()

    # softmax cross-entropy: the MLM head's logits (bf16 under O2, timed,
    # first), then f32, smoothing, the NSP head and ragged vocabularies
    mlm_rows = BERT_BATCH * BERT_SEQ
    shapes = [("bf16", mlm_rows, BERT_VOCAB, 0.0, MLM_IGNORED, True),
              ("bf16", mlm_rows, BERT_VOCAB, 0.1, MLM_IGNORED, False),
              ("f32", mlm_rows, BERT_VOCAB, 0.0, MLM_IGNORED, False),
              ("f32", mlm_rows, BERT_VOCAB, 0.1, MLM_IGNORED, False),
              ("bf16", BERT_BATCH, 2, 0.0, 0.0, True),
              ("bf16", mlm_rows, 30522, 0.0, MLM_IGNORED, False),
              ("f32", 37, 1000, 0.1, 0.25, False),
              ("bf16", 37, 1000, 0.0, 0.25, False)]
    for tag, rows, v, smoothing, ignored, timed in shapes:
        for name, row in _xent_entries(timer, gen, tag, rows, v, smoothing,
                                       ignored, timed).items():
            results.setdefault(name, []).append(row)
        torch.cuda.empty_cache()

    # flash attention: the main path's shape first (bf16, batch 16 x 1024,
    # 16 heads of 64, causal, dropout), timed with its library yardstick at
    # the same dropout, then again at dropout 0; gpt_1p3b's (4 x 1024, 16
    # heads of 128), timed the same way; then BERT's at 8 x 512 (12 heads
    # of 64, no mask), f32 and the other head sizes, a ragged length and no
    # mask.  Every shape runs at dropout FLASH_DROPOUT and 0.
    heads, hd = GPT_345M["heads"], GPT_345M["hidden"] // GPT_345M["heads"]
    shapes = [("bf16", (TRAIN_BATCH, TRAIN_SEQ, heads, hd), True, True),
              ("bf16", (WIDE_BATCH, TRAIN_SEQ, 16, 128), True, True),
              ("bf16", (BERT_LONG_BATCH, BERT_LONG_SEQ, BERT_HEADS,
                        BERT_HIDDEN // BERT_HEADS), False, False),
              ("f32", (2, 512, 4, 64), True, False),
              ("f32", (2, 512, 4, 32), True, False),
              ("f32", (2, 512, 4, 128), True, False),
              ("f32", (1, 700, 3, 64), False, False),
              ("bf16", (2, 512, 4, 32), True, False),
              ("bf16", (2, 512, 4, 128), True, False),
              ("bf16", (1, 700, 3, 64), False, False)]
    for tag, shape, causal, timed in shapes:
        for p in FLASH_DROPOUTS:
            for name, row in _flash_entries(timer, gen, tag, shape, causal,
                                            timed, dropout=p).items():
                results.setdefault(name, []).append(row)
    # cross lengths (q_len != kv_len, the causal diagonal aligned to the
    # end, a q_len past kv_len leaving rows with no key) and head sizes the
    # wrapper pads (48 to 64, 96 to 128)
    shapes = [(tag, shape, causal, kv)
              for tag in ("bf16", "f32")
              for shape, causal, kv in (((2, 128, 4, 64), True, 640),
                                        ((2, 128, 4, 64), False, 640),
                                        ((1, 200, 2, 64), True, 72),
                                        ((1, 40, 2, 48), True, 72),
                                        ((2, 512, 4, 48), True, None),
                                        ((2, 300, 4, 96), False, None),
                                        ((2, 128, 4, 96), True, 640))]
    for tag, shape, causal, kv in shapes:
        for p in FLASH_DROPOUTS:
            for name, row in _flash_entries(timer, gen, tag, shape, causal,
                                            False, kv_len=kv,
                                            dropout=p).items():
                results[name].append(row)
    # head sizes past 256 (padded to multiples of 128: 320 to 384, and 512),
    # bf16 and f32, causal and not, at both dropouts
    for tag, d, causal, p in itertools.product(
            ("bf16", "f32"), (320, 512), (True, False), FLASH_DROPOUTS):
        for name, row in _flash_entries(timer, gen, tag, (2, 200, 2, d),
                                        causal, False, dropout=p).items():
            results[name].append(row)
    # past 65535 slices (the mma.sync kernels' old gridDim.y): 65552 (b, h)
    # slices, bf16 at D 64 (the wgmma kernels) and D 32 (mma.sync), f32 at
    # D 64 (mma.sync), causal, at both dropouts
    for tag, d, p in itertools.product(("bf16", "f32"), (64, 32),
                                       FLASH_DROPOUTS):
        if tag == "f32" and d == 32:
            continue
        for name, row in _flash_entries(timer, gen, tag,
                                        (*FLASH_MANY_SLICES, d), True, False,
                                        dropout=p).items():
            results[name].append(row)
        torch.cuda.empty_cache()
    _flash_variant_rows(timer, gen, results)
    _packed_rows(timer, gen, results)

    # LayerNorm without weight and bias (the fusion pass's matches reach it)
    for tag, dtype, rows, d in (("bf16", torch.bfloat16, 4096, 768),
                                ("f32", torch.float32, 1000, 96),
                                ("bf16", torch.bfloat16, 2048, 1003),
                                ("f32", torch.float32, 300, 2048)):
        fwd, bwd = _layer_norm_no_affine(gen, tag, dtype, rows, d, 1e-12)
        results["layer_norm_fwd"].append(fwd)
        results["layer_norm_bwd"].append(bwd)

    # the fusion pass's block kernels: the four shapes of this slice's
    # paths in bf16, timed, then the MLM transform's product, f32 at small
    # shapes (the tied decoder's transposed weight included), both gelu
    # forms, no residual / no LayerNorm affine / no bias
    h, bh = GPT_345M["hidden"], BERT_HIDDEN
    gpt_rows, bert_rows = FUSED_BATCH * TRAIN_SEQ, BERT_BATCH * BERT_SEQ
    lnmm = [("bf16", gpt_rows, h, 3 * h, dict(timed=True)),
            ("bf16", bert_rows, bh, BERT_VOCAB,
             dict(eps=1e-12, strided=True, timed=True)),
            ("f32", 100, 96, 200, dict(residual=True)),
            ("f32", 100, 96, 200, dict(strided=True, ln_affine=False,
                                       bias=False)),
            ("f32", 37, 1024, 136, dict(residual=True, strided=True)),
            ("bf16", 100, 96, 200, dict(residual=True, ln_affine=False)),
            ("bf16", 37, 768, 264, dict(strided=True, bias=False))]
    # K past 1024 (h streamed by k tile): the gpt_1p3b step's ln1 + qkv
    # (4 x 1024 rows, 2048 @ 6144: every item a run of several column
    # tiles), timed; GPT-1.3B's 2048 and GPT-13B's 5120 with a residual, no
    # LayerNorm affine and no bias; a transposed W at a ragged N (1000 = 3 x
    # 256 + 232); and K = 1003 and 2050, not multiples of 8 (zero-padded by
    # the wrapper)
    lnmm.append(("bf16", WIDE_BATCH * TRAIN_SEQ, 2048, 3 * 2048,
                 dict(timed=True)))
    for tag in ("bf16", "f32"):
        lnmm += [(tag, 300, 2048, 520, dict(residual=True, ln_affine=False,
                                            bias=False)),
                 (tag, 300, 5120, 520, dict(residual=True, ln_affine=False,
                                            bias=False)),
                 (tag, 300, 2048, 1000, dict(strided=True)),
                 (tag, 300, 1003, 520, dict(residual=True)),
                 (tag, 37, 1003, 1000, dict(strided=True, ln_affine=False)),
                 (tag, 300, 2050, 520, dict(residual=True, bias=False))]
    # output widths off a multiple of 16 bytes: BERT's unpadded vocabulary
    # through the tied decoder's transposed view (read in place) and through
    # a Linear weight (a zero-padded copy), FFN widths 4090 and 3070; and
    # past 65535 of the f32 kernels' 32-row blocks
    for tag in ("bf16", "f32"):
        lnmm += [(tag, 300, 768, BERT_UNPADDED_VOCAB,
                  dict(strided=True, eps=1e-12)),
                 (tag, 300, 768, BERT_UNPADDED_VOCAB, dict(residual=True)),
                 (tag, 300, 2048, 4090, dict(residual=True, bias=False)),
                 (tag, 37, 1003, 3070, dict(strided=True)),
                 (tag, BLOCK_MANY_ROWS, 16, 20, dict())]
    for tag, rows, k, n, kw in lnmm:
        results.setdefault("ln_matmul", []).append(
            _ln_matmul_entry(timer, gen, tag, rows, k, n, **kw))
        torch.cuda.empty_cache()
    mbg = [("bf16", gpt_rows, h, 4 * h, dict(approximate=True, timed=True)),
           ("bf16", bert_rows, bh, 4 * bh,
            dict(approximate=False, timed=True)),
           ("bf16", bert_rows, bh, bh, dict(approximate=False)),
           # the gpt_1p3b step's fc1 + gelu, 4 x 1024 rows, 2048 @ 8192
           ("bf16", WIDE_BATCH * TRAIN_SEQ, 2048, 4 * 2048,
            dict(approximate=True, timed=True)),
           ("f32", 100, 96, 200, dict(approximate=True)),
           ("f32", 100, 96, 200, dict(approximate=False, bias=False)),
           ("f32", 37, 64, 136, dict(approximate=True, strided=True)),
           ("bf16", 100, 96, 200, dict(approximate=True, strided=True,
                                       bias=False)),
           # a W past 16 MB, read by groups of row blocks, transposed
           ("bf16", 300, 2048, 8200, dict(approximate=False, strided=True)),
           # K not a multiple of 8 (zero-padded by the wrapper)
           ("bf16", 300, 1003, 520, dict(approximate=True)),
           ("f32", 37, 1003, 1000, dict(approximate=False, strided=True))]
    # output widths off a multiple of 16 bytes (y and z returned as views of
    # rows 16 bytes apart), and past 65535 of the f32 kernel's row blocks
    for tag in ("bf16", "f32"):
        mbg += [(tag, 300, 768, BERT_UNPADDED_VOCAB,
                 dict(approximate=False)),
                (tag, 300, 1024, 4090, dict(approximate=True)),
                (tag, 300, 1024, 3070, dict(approximate=True, strided=True,
                                            bias=False)),
                (tag, BLOCK_MANY_ROWS, 16, 20, dict(approximate=True))]
    for tag, rows, k, n, kw in mbg:
        results.setdefault("matmul_bias_gelu", []).append(
            _mbg_entry(timer, gen, tag, rows, k, n, **kw))
        torch.cuda.empty_cache()
    return results


def _gemm_weight(gen, k, n, dtype, strided):
    """A (k, n) weight: a Linear's contiguous tensor, or (``strided``) the
    transposed view of an (n, k) table, read in place as BERT's tied
    decoder reads the word embeddings."""
    if strided:
        return (torch.randn(n, k, generator=gen, device=DEVICE) * 0.05
                ).to(dtype).t()
    return (torch.randn(k, n, generator=gen, device=DEVICE) * 0.05).to(dtype)


def _block_err(got, want, tag):
    """Max abs error, and whether it is within ``BLOCK_TOL`` of max|ref|."""
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    return err, finite and err <= BLOCK_TOL[tag] * want.float().abs().max(
        ).item()


def _block_row(variant, err, same_bits, tag):
    return dict(variant=variant, max_abs_err=err, tol=BLOCK_TOL[tag],
                bit_identical=same_bits, ms=None, plain_ms=None,
                bound_ms=None, bound_by=None, library_ms=None)


def _ln_matmul_entry(timer, gen, tag, rows, k, n, *, eps=1e-5,
                     residual=False, ln_affine=True, bias=True,
                     strided=False, timed=False):
    """The LayerNorm + matmul kernel against its plain version at ``(rows,
    k) @ (k, n)``, bit-identical over two calls; ``timed``: kernel, plain
    and library (``F.layer_norm`` then ``F.linear``, two calls) times and
    the bound."""
    from paddle_tpu_torch.ops.fused_kernels import (ln_matmul,
                                                    ln_matmul_reference)
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    x = (torch.randn(rows, k, generator=gen, device=DEVICE) * 2 + 0.5
         ).to(dtype)
    r = (torch.randn(rows, k, generator=gen, device=DEVICE).to(dtype)
         if residual else None)
    lw = lb = None
    if ln_affine:
        lw = (1 + 0.3 * torch.randn(k, generator=gen, device=DEVICE)
              ).to(dtype)
        lb = (0.2 * torch.randn(k, generator=gen, device=DEVICE)).to(dtype)
    w = _gemm_weight(gen, k, n, dtype, strided)
    b = ((0.1 * torch.randn(n, generator=gen, device=DEVICE)).to(dtype)
         if bias else None)
    args = (x, w, lw, lb, b, r, eps)
    y, again = ln_matmul(*args), ln_matmul(*args)
    want = ln_matmul_reference(*args)
    torch.cuda.synchronize()
    err, ok = _block_err(y, want, tag)
    same_bits = torch.equal(y, again)
    variant = (f"{tag} ({rows}, {k}) @ ({k}, {n})"
               f"{' W a transposed view' if strided else ''}"
               f"{' residual' if residual else ''}"
               f"{'' if ln_affine else ' no LayerNorm affine'}"
               f"{'' if bias else ' no bias'} eps {eps}")
    log(f"[kernel] ln_matmul[{variant}]: max_abs_err {err:.3e} (tol "
        f"{BLOCK_TOL[tag]} x max|ref| {want.float().abs().max().item():.3f})"
        f"; bit-identical over two calls: {same_bits}")
    if not ok or not same_bits:
        raise AssertionError(f"ln_matmul[{variant}] disagrees with its plain "
                             f"version ({err}) or differs between calls "
                             f"({same_bits})")
    row = _block_row(variant, err, same_bits, tag)
    if not timed:
        return row
    es = x.element_size()
    nbytes = ((rows * k * (2 if residual else 1) + k * n + rows * n) * es
              + (2 * k + n) * es)
    bound = bound_ms(nbytes, 2.0 * rows * k * n, dtype)
    wl = w.t()                   # F.linear's (n, k)
    fn = torch.nn.functional

    def library():
        return fn.linear(fn.layer_norm(x + r if residual else x, (k,), lw, lb,
                                       eps), wl, b)

    row.update(ms=timer(lambda: ln_matmul(*args)),
               plain_ms=timer(lambda: ln_matmul_reference(*args), iters=5),
               library_ms=timer(library), bound_ms=bound[0],
               bound_by=bound[1])
    log(f"[kernel] ln_matmul[{variant}] times: kernel {row['ms']:.4f} ms "
        f"plain {row['plain_ms']:.4f} ms library (F.layer_norm, F.linear: "
        f"two calls) {row['library_ms']:.4f} ms bound {bound[0]:.4f} ms "
        f"({bound[1]}, {2.0 * rows * k * n / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB)")
    return row


def _mbg_entry(timer, gen, tag, rows, k, n, *, approximate, bias=True,
               strided=False, timed=False):
    """The matmul + bias + gelu kernel against its plain version at
    ``(rows, k) @ (k, n)``: y and the stored pre-activation z,
    bit-identical over two calls; ``timed``: kernel, plain and library
    (``F.linear`` then ``F.gelu``, two calls) times and the bound."""
    from paddle_tpu_torch.ops.fused_kernels import (
        matmul_bias_gelu, matmul_bias_gelu_reference)
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    x = torch.randn(rows, k, generator=gen, device=DEVICE).to(dtype)
    w = _gemm_weight(gen, k, n, dtype, strided)
    b = ((0.1 * torch.randn(n, generator=gen, device=DEVICE)).to(dtype)
         if bias else None)
    args = (x, w, b, approximate)
    (y, z), (y2, z2) = matmul_bias_gelu(*args), matmul_bias_gelu(*args)
    y_ref, z_ref = matmul_bias_gelu_reference(*args)
    torch.cuda.synchronize()
    (err_y, ok_y), (err_z, ok_z) = (_block_err(y, y_ref, tag),
                                    _block_err(z, z_ref, tag))
    same_bits = torch.equal(y, y2) and torch.equal(z, z2)
    form = "tanh" if approximate else "erf"
    variant = (f"{tag} ({rows}, {k}) @ ({k}, {n}) {form}"
               f"{' W a transposed view' if strided else ''}"
               f"{'' if bias else ' no bias'}")
    log(f"[kernel] matmul_bias_gelu[{variant}]: max_abs_err y {err_y:.3e} z "
        f"{err_z:.3e} (tol {BLOCK_TOL[tag]} x max|ref|); bit-identical over "
        f"two calls: {same_bits}")
    if not (ok_y and ok_z and same_bits):
        raise AssertionError(f"matmul_bias_gelu[{variant}] disagrees with its "
                             f"plain version (y {err_y}, z {err_z}) or "
                             f"differs between calls ({same_bits})")
    row = _block_row(variant, max(err_y, err_z), same_bits, tag)
    row["errors"] = {"y": err_y, "z": err_z}
    if not timed:
        return row
    es = x.element_size()
    nbytes = (rows * k + k * n + n + 2 * rows * n) * es
    bound = bound_ms(nbytes, 2.0 * rows * k * n, dtype)
    wl = w.t()
    fn = torch.nn.functional

    def library():
        return fn.gelu(fn.linear(x, wl, b), approximate=form.replace(
            "erf", "none"))

    row.update(ms=timer(lambda: matmul_bias_gelu(*args)),
               plain_ms=timer(lambda: matmul_bias_gelu_reference(*args),
                              iters=5),
               library_ms=timer(library), bound_ms=bound[0],
               bound_by=bound[1])
    log(f"[kernel] matmul_bias_gelu[{variant}] times: kernel "
        f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
        f"(F.linear, F.gelu: two calls) {row['library_ms']:.4f} ms bound "
        f"{bound[0]:.4f} ms ({bound[1]}, {2.0 * rows * k * n / 1e9:.1f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB)")
    return row


def _layer_norm_no_affine(gen, tag, dtype, rows, d, eps):
    """The LayerNorm kernels with no weight and no bias against their plain
    versions: y, mean, rstd, dx and db (dw is None), y, mean, rstd, dx and
    db bit-identical over two runs."""
    from paddle_tpu_torch.ops.fused_kernels import (
        layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_fwd_reference)
    x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 2 + 0.5
         ).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
    y, mean, rstd = layer_norm_fwd(x, None, None, eps)
    fwd2 = layer_norm_fwd(x, None, None, eps)
    y_ref, mean_ref, rstd_ref = layer_norm_fwd_reference(x, None, None, eps)
    dx, dw, db = layer_norm_bwd(g, x, None, mean, rstd)
    dx2, _, db2 = layer_norm_bwd(g, x, None, mean, rstd)
    dx_ref, _, db_ref = layer_norm_bwd_reference(g, x, None, mean, rstd)
    torch.cuda.synchronize()
    errs = {"y": _ln_err(y, y_ref, tag), "mean": _ln_err(mean, mean_ref, tag),
            "rstd": _ln_err(rstd, rstd_ref, tag),
            "dx": _ln_err(dx, dx_ref, tag),
            "db": _ln_err(db, db_ref, tag, rel_to_max=True)}
    same_bits = (torch.equal(dx, dx2) and torch.equal(db, db2) and dw is None
                 and all(torch.equal(a, b)
                         for a, b in zip((y, mean, rstd), fwd2)))
    variant = f"{tag} no affine ({rows}, {d})"
    log(f"[kernel] layer_norm[{variant}]: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {LN_TOL[tag]}); y/mean/rstd/dx/db bit-identical over two "
        f"runs, dw None: {same_bits}")
    bad = [k for k, (_, ok) in errs.items() if not ok]
    if bad or not same_bits:
        raise AssertionError(f"layer_norm[{variant}] disagrees with its plain "
                             f"version on {bad} or differs between runs "
                             f"({same_bits})")
    fwd = dict(variant=variant, max_abs_err=errs["y"][0], tol=LN_TOL[tag],
               ms=None, plain_ms=None, bound_ms=None, bound_by=None,
               library_ms=None)
    bwd = dict(fwd, max_abs_err=max(errs["dx"][0], errs["db"][0]),
               bit_identical=same_bits)
    return fwd, bwd


def _flash_err(out, want, tag, key):
    """Max abs error and whether it is within ``FLASH_TOL``."""
    err = (out.float() - want.float()).abs()
    finite = bool(torch.isfinite(out.float()).all())
    t = FLASH_TOL[tag]
    if tag == "bf16":
        ok = bool((err <= t["abs"] + t["rel"] * want.float().abs()).all())
    else:
        ok = err.max().item() <= (t["abs"] if key in ("out", "lse")
                                  else t["grad"])
    return err.max().item(), finite and ok


def _flash_entries(timer, gen, tag, shape, causal, timed, kv_len=None,
                   seq_lens=None, causal_shift=None, dlse=False,
                   dropout=FLASH_DROPOUT, hash_base=None):
    """The three flash kernels against their plain versions on one shape:
    q, k and v read in place from one ``(B, S, H, 3 * D)`` tensor as the
    model's QKV projection gives them (with ``kv_len``: q alone, k and v
    from one ``(B, kv_len, H, 2 * D)`` tensor), dropout ``dropout`` with a
    fixed seed; every kernel fed the same inputs as its plain
    version (the backward ones the kernel forward's lse and one delta);
    dq, dk and dv bit-identical over two runs.  ``seq_lens`` (a list) and
    ``causal_shift`` (an int) are the masks' variants, passed as int32
    tensors on the card; ``hash_base`` places the dropout hash (a ring
    step's); ``dlse`` folds a random lse cotangent into delta.
    ``timed``: kernel, plain and library times and the bounds."""
    from paddle_tpu_torch.ops import pallas_ops as po
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    b, s, h, d = shape
    if kv_len is None:
        qkv = torch.randn(b, s, h, 3 * d, generator=gen, device=DEVICE
                          ).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q = torch.randn(b, s, h, d, generator=gen, device=DEVICE).to(dtype)
        kv = torch.randn(b, kv_len, h, 2 * d, generator=gen, device=DEVICE
                         ).to(dtype)
        k, v = kv[..., :d], kv[..., d:]
    do = torch.randn(b, s, h, d, generator=gen, device=DEVICE).to(dtype)
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=DEVICE)
    opts = dict(causal=causal, sm_scale=1.0 / math.sqrt(d),
                dropout_p=dropout)
    if seq_lens is not None:
        opts["seq_lens"] = torch.tensor(seq_lens, dtype=torch.int32,
                                        device=DEVICE)
    if causal_shift is not None:
        opts["causal_shift"] = torch.tensor(causal_shift, dtype=torch.int32,
                                            device=DEVICE)
    if hash_base is not None:
        opts["hash_base"] = hash_base
    out, lse = po.flash_fwd(q, k, v, seed, **opts)
    out2, lse2 = po.flash_fwd(q, k, v, seed, **opts)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)
    if dlse:
        delta = delta - torch.randn(b, h, s, generator=gen, device=DEVICE)
    delta = delta.contiguous()
    bwd_args = (q, k, v, do, lse, delta, seed)
    dq = po.flash_bwd_dq(*bwd_args, **opts)
    dk, dv = po.flash_bwd_dkv(*bwd_args, **opts)
    dq2 = po.flash_bwd_dq(*bwd_args, **opts)
    dk2, dv2 = po.flash_bwd_dkv(*bwd_args, **opts)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ref_opts = dict(opts, seed=seed)
    out_ref, lse_ref = po.mha_reference(qt, kt, vt, **ref_opts)
    dq_ref = po.mha_dq_reference(qt, kt, vt, dot, lse, delta, **ref_opts)
    dk_ref, dv_ref = po.mha_dkv_reference(qt, kt, vt, dot, lse, delta,
                                          **ref_opts)
    torch.cuda.synchronize()
    errs = {"out": _flash_err(out, out_ref.transpose(1, 2), tag, "out"),
            "lse": _flash_err(lse, lse_ref, tag, "lse"),
            "dq": _flash_err(dq, dq_ref.transpose(1, 2), tag, "dq"),
            "dk": _flash_err(dk, dk_ref.transpose(1, 2), tag, "dk"),
            "dv": _flash_err(dv, dv_ref.transpose(1, 2), tag, "dv")}
    same_bits = (torch.equal(out, out2) and torch.equal(lse, lse2)
                 and torch.equal(dq, dq2) and torch.equal(dk, dk2)
                 and torch.equal(dv, dv2))
    del out_ref, dq_ref, dk_ref, dv_ref, out2, lse2
    variant = (f"{tag} B={b} S={s}{'' if kv_len is None else f' kv={kv_len}'}"
               f" H={h} D={d} {'causal' if causal else 'full'} dropout "
               f"{dropout}"
               + ("" if seq_lens is None else f" seq_lens {seq_lens}")
               + ("" if causal_shift is None else f" shift {causal_shift}")
               + ("" if hash_base is None else f" hash base {hash_base}")
               + (" lse cotangent" if dlse else ""))
    log(f"[kernel] flash[{variant}]: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {FLASH_TOL[tag]}); out/lse/dq/dk/dv bit-identical over two "
        f"runs: {same_bits}")
    bad = [k for k, (_, ok) in errs.items() if not ok]
    if bad or not same_bits:
        raise AssertionError(f"flash[{variant}] disagrees with its plain "
                             f"versions on {bad}, or out/lse/dq/dk/dv differ "
                             f"between runs (bit-identical: {same_bits})")
    rows = {"flash_fwd": dict(variant=variant, max_abs_err=max(
                errs["out"][0], errs["lse"][0]),
                errors={k: errs[k][0] for k in ("out", "lse")},
                bit_identical=same_bits),
            "flash_bwd_dq": dict(variant=variant, max_abs_err=errs["dq"][0],
                                 bit_identical=same_bits),
            "flash_bwd_dkv": dict(variant=variant, max_abs_err=max(
                errs["dk"][0], errs["dv"][0]),
                errors={k: errs[k][0] for k in ("dk", "dv")},
                bit_identical=same_bits)}
    for row in rows.values():
        row.update(tol=FLASH_TOL[tag], ms=None, plain_ms=None, bound_ms=None,
                   bound_by=None, library_ms=None)
    if not timed:
        return rows

    # bounds: each input read once, each output written once; the products
    # over the (query, key) pairs this mask keeps
    es, n, bh = q.element_size(), b * s * h * d, b * h
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    stats = bh * s * 4
    work = {"flash_fwd": (4 * n * es + stats, 2 * 2.0 * pairs * d),
            "flash_bwd_dq": (5 * n * es + 2 * stats, 3 * 2.0 * pairs * d),
            "flash_bwd_dkv": (6 * n * es + 2 * stats, 4 * 2.0 * pairs * d)}
    for name, (nbytes, flops) in work.items():
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound_ms(
            nbytes, flops, dtype)
    times = {
        "flash_fwd": timer(lambda: po.flash_fwd(q, k, v, seed, **opts)),
        "flash_bwd_dq": timer(lambda: po.flash_bwd_dq(*bwd_args, **opts)),
        "flash_bwd_dkv": timer(lambda: po.flash_bwd_dkv(*bwd_args, **opts)),
    }
    plain = {
        "flash_fwd": timer(lambda: po.mha_reference(qt, kt, vt, **ref_opts),
                           iters=5),
        "flash_bwd_dq": timer(lambda: po.mha_dq_reference(
            qt, kt, vt, dot, lse, delta, **ref_opts), iters=5),
        "flash_bwd_dkv": timer(lambda: po.mha_dkv_reference(
            qt, kt, vt, dot, lse, delta, **ref_opts), iters=5),
    }
    lib_fwd, lib_bwd = _sdpa_times(timer, q, k, v, do, causal, dropout)
    for name in rows:
        rows[name].update(ms=times[name], plain_ms=plain[name],
                          library_ms=lib_fwd if name == "flash_fwd"
                          else lib_bwd)
    log(f"[kernel] flash[{variant}] times: "
        + "; ".join(f"{name} kernel {times[name]:.4f} ms plain "
                    f"{plain[name]:.4f} ms bound {rows[name]['bound_ms']:.4f}"
                    f" ms ({rows[name]['bound_by']})" for name in rows)
        + f"; library (SDPA flash backend, {'causal' if causal else 'full'},"
        f" dropout {dropout}, the kernels' own) forward {lib_fwd:.4f} ms, "
        f"backward (dq, dk and dv in one, forward+backward less forward) "
        f"{lib_bwd:.4f} ms")
    return rows


def _sdpa_times(timer, q, k, v, do, causal, dropout=0.0):
    """The library yardstick: ``scaled_dot_product_attention`` on its
    flash backend at the kernels' dropout, on contiguous ``(B, H, S, D)``
    copies; the forward, and the backward as forward+backward less the
    forward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qc, kc, vc, doc = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    leaves = [x.detach().requires_grad_() for x in (qc, kc, vc)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        out = sdpa(*leaves, dropout_p=dropout, is_causal=causal)
        torch.autograd.grad(out, leaves, doc)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = timer(lambda: sdpa(qc, kc, vc, dropout_p=dropout,
                                 is_causal=causal))
        both = timer(fwd_bwd)
    return fwd, both - fwd


def _flash_variant_rows(timer, gen, results):
    """Rows 1-3 with the masks' variants (``seq_lens``, ``causal_shift``,
    one shift leaving every row of a tile no key), an lse cotangent, and
    head sizes 160 (padded to 256) and 256, in bf16 and f32."""
    shapes = [((2, 512, 4, 64), True, dict(seq_lens=[300, 512])),
              ((2, 256, 4, 64), False, dict(seq_lens=[0, 200])),
              ((1, 256, 4, 64), True, dict(kv_len=384, causal_shift=100)),
              ((1, 256, 4, 64), True, dict(causal_shift=-100)),
              ((1, 128, 2, 64), True, dict(causal_shift=-200)),
              ((2, 512, 4, 64), True, dict(dlse=True)),
              ((1, 200, 2, 160), True, dict(kv_len=264)),
              ((2, 256, 2, 256), True, dict(dlse=True)),
              ((1, 130, 2, 256), False, dict(seq_lens=[77]))]
    for tag in ("bf16", "f32"):
        for shape, causal, kw in shapes:
            for p in FLASH_DROPOUTS:
                for name, row in _flash_entries(timer, gen, tag, shape,
                                                causal, False, dropout=p,
                                                **kw).items():
                    results[name].append(row)


def _kept_pairs(lq, lk, causal):
    """(query, key) pairs one sequence pair keeps: all, or those on and
    below the bottom-right diagonal."""
    if not causal:
        return lq * lk
    return sum(max(0, min(lk, i + lk - lq + 1)) for i in range(lq))


def _packed_rows(timer, gen, results):
    """Rows 4-6: bench_packed's sequences first (bf16, causal, dropout 0,
    then dropout 0.1, each timed with the library's yardstick at the same
    dropout where it takes one), then small sets at both dropouts, f32
    and bf16: cross lengths (some ``len_q > len_k``, rows with no key),
    sequences of length 0, no mask, head sizes 48, 256 and 320 and other
    ``block_q``/``block_k`` for the dropout hash's layout; bf16 at D 128
    and 64 over lengths off a multiple of 128 (the wgmma backward's tiles
    crossing into the next sequence), causal and full; past 65535 heads.
    Each entry checks which backward kernels ran (``route``)."""
    cross_q, cross_k = [50, 7, 130, 0, 64], [20, 33, 100, 15, 64]
    sets = [("bf16", PACKED_LENS, PACKED_LENS, PACKED_HEADS, PACKED_HD, True,
             0.0, (None, None), True),
            ("bf16", PACKED_LENS, PACKED_LENS, PACKED_HEADS, PACKED_HD, True,
             FLASH_DROPOUT, (None, None), True)]
    for tag, p in itertools.product(("f32", "bf16"), FLASH_DROPOUTS):
        sets += [(tag, [37, 0, 130, 64, 5], [37, 0, 130, 64, 5], 4, 64, True,
                  p, (None, None), False),
                 (tag, cross_q, cross_k, 4, 64, True, p, (None, None), False),
                 (tag, cross_q, cross_k, 4, 64, False, p, (128, 64), False),
                 (tag, [100, 0, 77, 200], [100, 0, 77, 200], 2, 48, True,
                  p, (64, 128), False),
                 (tag, [100, 0, 77, 200], [60, 9, 77, 230], 2, 256, True,
                  p, (None, None), False),
                 (tag, [100, 0, 77, 200], [60, 9, 77, 230], 2, 320, True,
                  p, (None, None), False)]
    # the wgmma backward's units at D 64 and 128: tiles of 128 rows that
    # cross their sequence's end into the next one's rows (lengths off a
    # multiple of 128), zero lengths on either side, len_q > len_k
    long_q, long_k = [300, 0, 129, 517, 64, 17], [150, 40, 0, 513, 200, 3]
    for p in FLASH_DROPOUTS:
        sets += [("bf16", long_q, long_q, 4, 128, True, p, (None, None),
                  False),
                 ("bf16", long_q, long_q, 4, 128, False, p, (None, None),
                  False),
                 ("bf16", long_q, long_k, 4, 128, True, p, (None, None),
                  False),
                 ("bf16", long_q, long_k, 4, 128, False, p, (128, 64),
                  False),
                 ("bf16", long_q, long_k, 4, 64, True, p, (64, 128),
                  False)]
    # more than 65535 heads (the mma.sync kernels' old gridDim.y)
    sets += [("bf16", [40, 0, 24], [40, 0, 24], PACKED_MANY_HEADS, 64, True,
              p, (None, None), False) for p in FLASH_DROPOUTS]
    for tag, lq, lk, h, d, causal, p, blocks, timed in sets:
        for name, row in _packed_entries(timer, gen, tag, lq, lk, h, d,
                                         causal, p, blocks, timed).items():
            results.setdefault(name, []).append(row)
        torch.cuda.empty_cache()


def _packed_entries(timer, gen, tag, lens_q, lens_k, h, d, causal, dropout,
                    blocks, timed):
    """The three packed kernels against their plain versions on one set of
    sequences: q, k and v read in place from one ``(total, H, 3 * D)``
    tensor as a QKV projection gives them (cross lengths: q alone, k and v
    from one ``(total_k, H, 2 * D)`` tensor); every kernel fed the same
    inputs as its plain version (the backward ones the kernel forward's lse
    and one delta); out, lse, dq, dk and dv bit-identical over two runs,
    and the second run's kernels those of the set's route.  ``blocks``
    (block_q, block_k) set the dropout hash's layout.  ``timed``: kernel,
    plain and library times and the bounds."""
    from paddle_tpu_torch.ops import pallas_ops as po
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    tq, tk = sum(lens_q), sum(lens_k)
    cu_q = [0, *itertools.accumulate(lens_q)]
    cu_k = [0, *itertools.accumulate(lens_k)]
    if lens_q == lens_k:
        qkv = torch.randn(tq, h, 3 * d, generator=gen, device=DEVICE
                          ).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q = torch.randn(tq, h, d, generator=gen, device=DEVICE).to(dtype)
        kv = torch.randn(tk, h, 2 * d, generator=gen, device=DEVICE
                         ).to(dtype)
        k, v = kv[..., :d], kv[..., d:]
    do = torch.randn(tq, h, d, generator=gen, device=DEVICE).to(dtype)
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=DEVICE)
    bq, bk = blocks
    layout = po.PackedLayout(cu_q, cu_k, tq, tk, block_q=bq, block_k=bk)
    opts = dict(causal=causal, sm_scale=1.0 / math.sqrt(d), dropout_p=dropout)
    out, lse = po.flash_packed_fwd(q, k, v, layout, seed, **opts)
    delta = (out.float() * do.float()).sum(-1).t().contiguous()
    bwd_args = (q, k, v, do, lse, delta)
    dq = po.flash_packed_bwd_dq(*bwd_args, layout, seed, **opts)
    dk, dv = po.flash_packed_bwd_dkv(*bwd_args, layout, seed, **opts)
    second = {}

    def again():
        second["fwd"] = po.flash_packed_fwd(q, k, v, layout, seed, **opts)
        second["dq"] = po.flash_packed_bwd_dq(*bwd_args, layout, seed,
                                              **opts)
        second["dkv"] = po.flash_packed_bwd_dkv(*bwd_args, layout, seed,
                                                **opts)
    # the route the second run took, read off the kernels' names: bf16 at
    # D 64 and 128 (after padding) the wgmma kernels, forward and backward,
    # every other case the mma.sync ones (the wide heads their slab
    # kernels, neither)
    calls, _ = _flash_calls(again)
    (out2, lse2), dq2, (dk2, dv2) = second["fwd"], second["dq"], second["dkv"]
    kd = po._kernel_head_dim(d)
    route = ("wgmma" if tag == "bf16" and kd in (64, 128) else
             "mma.sync" if kd <= 256 else "wide")
    want_calls = {n: float(route == ("wgmma" if n in WG_FLASH_FWD
                                     + WG_FLASH_BWD else "mma.sync"))
                  for n in FLASH_ROUTES}
    ref_opts = dict(opts, seed=seed, block_q=bq, block_k=bk)
    out_ref, lse_ref = po.mha_packed_reference(q, k, v, cu_q, cu_k,
                                               **ref_opts)
    dq_ref = po.mha_packed_dq_reference(*bwd_args, cu_q, cu_k, **ref_opts)
    dk_ref, dv_ref = po.mha_packed_dkv_reference(*bwd_args, cu_q, cu_k,
                                                 **ref_opts)
    torch.cuda.synchronize()
    errs = {"out": _flash_err(out, out_ref, tag, "out"),
            "lse": _flash_err(lse, lse_ref, tag, "lse"),
            "dq": _flash_err(dq, dq_ref, tag, "dq"),
            "dk": _flash_err(dk, dk_ref, tag, "dk"),
            "dv": _flash_err(dv, dv_ref, tag, "dv")}
    same_bits = (torch.equal(out, out2) and torch.equal(lse, lse2)
                 and torch.equal(dq, dq2) and torch.equal(dk, dk2)
                 and torch.equal(dv, dv2))
    del out_ref, dq_ref, dk_ref, dv_ref
    variant = (f"{tag} lens {lens_q}"
               + ("" if lens_k == lens_q else f" kv lens {lens_k}")
               + f" H={h} D={d} {'causal' if causal else 'full'} dropout "
               f"{dropout}"
               + ("" if blocks == (None, None) else f" blocks {bq}/{bk}"))
    log(f"[kernel] flash_packed[{variant}]: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {FLASH_TOL[tag]}); out/lse/dq/dk/dv bit-identical over "
        f"two runs: {same_bits}; rows 4-6 route {route}, kernels run "
        f"{ {n: c for n, c in calls.items() if c} }")
    bad = [k for k, (_, ok) in errs.items() if not ok]
    if bad or not same_bits or calls != want_calls:
        raise AssertionError(f"flash_packed[{variant}] disagrees with its "
                             f"plain versions on {bad}, or out/lse/dq/dk/dv "
                             f"differ between runs (bit-identical: "
                             f"{same_bits}), or the kernels run were "
                             f"{calls}, not the {route} route's "
                             f"{want_calls}")
    rows = {"flash_packed_fwd": dict(variant=variant, max_abs_err=max(
                errs["out"][0], errs["lse"][0]),
                errors={k: errs[k][0] for k in ("out", "lse")},
                bit_identical=same_bits, route=route),
            "flash_packed_bwd_dq": dict(variant=variant,
                                        max_abs_err=errs["dq"][0],
                                        bit_identical=same_bits,
                                        route=route),
            "flash_packed_bwd_dkv": dict(variant=variant, max_abs_err=max(
                errs["dk"][0], errs["dv"][0]),
                errors={k: errs[k][0] for k in ("dk", "dv")},
                bit_identical=same_bits, route=route)}
    for row in rows.values():
        row.update(tol=FLASH_TOL[tag], ms=None, plain_ms=None, bound_ms=None,
                   bound_by=None, library_ms=None)
    if not timed:
        return rows

    # bounds: each input read once, each output written once; the products
    # over the (query, key) pairs the masks keep, sequence by sequence
    es, nq, nk = q.element_size(), tq * h * d, tk * h * d
    pairs = h * sum(_kept_pairs(a, b, causal) for a, b in zip(lens_q, lens_k))
    stats = h * tq * 4
    work = {"flash_packed_fwd": ((2 * nq + 2 * nk) * es + stats,
                                 2 * 2.0 * pairs * d),
            "flash_packed_bwd_dq": ((3 * nq + 2 * nk) * es + 2 * stats,
                                    3 * 2.0 * pairs * d),
            "flash_packed_bwd_dkv": ((2 * nq + 4 * nk) * es + 2 * stats,
                                     4 * 2.0 * pairs * d)}
    for name, (nbytes, flops) in work.items():
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound_ms(
            nbytes, flops, dtype)
        rows[name].update(bytes=nbytes, flops=flops, kept_pairs=pairs)
    times = {
        "flash_packed_fwd": timer(lambda: po.flash_packed_fwd(
            q, k, v, layout, seed, **opts)),
        "flash_packed_bwd_dq": timer(lambda: po.flash_packed_bwd_dq(
            *bwd_args, layout, seed, **opts)),
        "flash_packed_bwd_dkv": timer(lambda: po.flash_packed_bwd_dkv(
            *bwd_args, layout, seed, **opts)),
    }
    plain = {
        "flash_packed_fwd": timer(lambda: po.mha_packed_reference(
            q, k, v, cu_q, cu_k, **ref_opts), iters=5),
        "flash_packed_bwd_dq": timer(lambda: po.mha_packed_dq_reference(
            *bwd_args, cu_q, cu_k, **ref_opts), iters=5),
        "flash_packed_bwd_dkv": timer(lambda: po.mha_packed_dkv_reference(
            *bwd_args, cu_q, cu_k, **ref_opts), iters=5),
    }
    lib_fwd, lib_bwd, lib = _varlen_library_times(
        timer, q, k, v, do, cu_q, cu_k, lens_q, lens_k, causal, dropout)
    for name in rows:
        rows[name].update(ms=times[name], plain_ms=plain[name],
                          library_ms=lib_fwd if name == "flash_packed_fwd"
                          else lib_bwd, library=lib)
    bwd_ms = times["flash_packed_bwd_dq"] + times["flash_packed_bwd_dkv"]
    lib_times = ("none at this dropout" if lib_fwd is None else
                 f"forward {lib_fwd:.4f} ms, backward (dq, dk and dv in one, "
                 f"forward+backward less forward) {lib_bwd:.4f} ms; rows 5 + "
                 f"6 / the library's backward {bwd_ms / lib_bwd:.3f}")
    log(f"[kernel] flash_packed[{variant}] times: "
        + "; ".join(f"{name} kernel {times[name]:.4f} ms plain "
                    f"{plain[name]:.4f} ms bound {rows[name]['bound_ms']:.4f}"
                    f" ms ({rows[name]['bound_by']})" for name in rows)
        + f"; kept pairs {pairs}; library ({lib}): {lib_times}")
    return rows


def _varlen_library_times(timer, q, k, v, do, cu_q, cu_k, lens_q, lens_k,
                          causal, dropout=0.0):
    """The library yardstick of the packed kernels at their dropout:
    PyTorch's ``torch.nn.attention.varlen.varlen_attn`` on the same packed
    data where this torch has it, else ``scaled_dot_product_attention``'s
    flash backend on the padded batch.  Returns (forward ms, backward ms as
    forward+backward less the forward, which call was timed); the times are
    None where ``varlen_attn`` takes no dropout and ``dropout`` > 0.  The
    port never calls either."""
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        varlen_attn = None
    if varlen_attn is not None:
        params = inspect.signature(varlen_attn).parameters
        mask = (dict(is_causal=causal) if "is_causal" in params
                else dict(window_size=(-1, 0) if causal else (-1, -1)))
        if dropout > 0:
            if "dropout_p" not in params:
                return None, None, ("torch.nn.attention.varlen.varlen_attn "
                                    "takes no dropout")
            mask["dropout_p"] = dropout
        cq, ck = (torch.tensor(c, dtype=torch.int32, device=DEVICE)
                  for c in (cu_q, cu_k))
        args = (cq, ck, max(lens_q), max(lens_k))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        leaves = [x.detach().requires_grad_() for x in (qc, kc, vc)]

        def fwd_bwd():
            out = varlen_attn(*leaves, *args, **mask)
            torch.autograd.grad(out, leaves, do)
        try:
            fwd = timer(lambda: varlen_attn(qc, kc, vc, *args, **mask))
            return fwd, timer(fwd_bwd) - fwd, (
                f"torch.nn.attention.varlen.varlen_attn {mask}")
        except (RuntimeError, TypeError, ValueError) as e:
            log(f"[kernel] varlen_attn does not run here "
                f"({str(e).splitlines()[0][:200]}); the yardstick is SDPA "
                f"on the padded batch")
    b, mq, mk = len(lens_q), max(lens_q), max(lens_k)

    def padded(x, lens, m):
        buf = torch.zeros((b, m) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=DEVICE)
        at = 0
        for i, n in enumerate(lens):
            buf[i, :n] = x[at:at + n]
            at += n
        return buf
    fwd, bwd = _sdpa_times(timer, padded(q, lens_q, mq),
                           padded(k, lens_k, mk), padded(v, lens_k, mk),
                           padded(do, lens_q, mq), causal, dropout)
    return fwd, bwd, (f"SDPA flash on the padded ({b}, {mq}) batch, dropout "
                      f"{dropout}")


def _ln_err(out, want, tag, rel_to_max=False):
    """Max abs error and whether it is within the tolerance: bf16
    ``abs + rel * |ref|`` per element; f32 abs, or relative to the
    largest |ref| for the row sums dw and db."""
    err = (out.float() - want.float()).abs()
    finite = bool(torch.isfinite(out.float()).all())
    if tag == "bf16":
        t = LN_TOL["bf16"]
        ok = bool((err <= t["abs"] + t["rel"] * want.float().abs()).all())
    elif rel_to_max:
        ok = err.max().item() <= (LN_TOL["f32"]["rel_dw_db"]
                                  * want.float().abs().max().item())
    else:
        ok = err.max().item() <= LN_TOL["f32"]["abs"]
    return err.max().item(), finite and ok


def _layer_norm_entries(timer, gen, tag, dtype, rows, d, eps,
                        residual=False):
    """The LayerNorm kernels against their plain versions at ``(rows,
    d)``, with or without a residual: errors on y, dx, dw and db (and,
    through the autograd function, the residual's gradient, which must be
    dx itself), dw and db bit-identical over two runs, and the kernel,
    plain and library times (the library on ``x + r`` with a residual);
    y, mean and rstd bit-identical over two runs too."""
    from paddle_tpu_torch.ops.fused_kernels import (
        fused_layer_norm, layer_norm_bwd, layer_norm_bwd_reference,
        layer_norm_fwd, layer_norm_fwd_reference)
    x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 2 + 0.5
         ).to(dtype)
    w = (1 + 0.3 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    b = (0.2 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
    r = (torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
         if residual else None)
    y, mean, rstd = layer_norm_fwd(x, w, b, eps, r)
    fwd2 = layer_norm_fwd(x, w, b, eps, r)
    y_ref, mean_ref, rstd_ref = layer_norm_fwd_reference(x, w, b, eps, r)
    grads = layer_norm_bwd(g, x, w, mean, rstd, r)
    again = layer_norm_bwd(g, x, w, mean, rstd, r)
    grads_ref = layer_norm_bwd_reference(g, x, w, mean, rstd, r)
    torch.cuda.synchronize()
    errs = {"y": _ln_err(y, y_ref, tag), "mean": _ln_err(mean, mean_ref, tag),
            "rstd": _ln_err(rstd, rstd_ref, tag),
            "dx": _ln_err(grads[0], grads_ref[0], tag),
            "dw": _ln_err(grads[1], grads_ref[1], tag, rel_to_max=True),
            "db": _ln_err(grads[2], grads_ref[2], tag, rel_to_max=True)}
    fwd_bits = all(torch.equal(a, b) for a, b in zip((y, mean, rstd), fwd2))
    same_bits = torch.equal(grads[1], again[1]) and torch.equal(grads[2],
                                                                again[2])
    if residual:
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        fused_layer_norm(*leaves[:3], eps, residual=leaves[3]).backward(g)
        torch.cuda.synchronize()
        errs["dr"] = _ln_err(leaves[3].grad, grads_ref[0], tag)
        same_bits = same_bits and torch.equal(leaves[3].grad, leaves[0].grad)
        del leaves
    es, nin = x.element_size(), 3 if residual else 2   # x (r) in, y out
    fwd_bytes = nin * rows * d * es + 2 * d * es + 2 * rows * 4
    bwd_bytes = (nin + 1) * rows * d * es + 3 * d * es + 2 * rows * 4
    fwd_bound = bound_ms(fwd_bytes, 8.0 * rows * d, torch.float32)
    bwd_bound = bound_ms(bwd_bytes, 12.0 * rows * d, torch.float32)
    xr = x + r if residual else x
    lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(xr, [d], w, b,
                                                          eps)[1:]
    times = {
        "fwd": timer(lambda: layer_norm_fwd(x, w, b, eps, r)),
        "fwd_plain": timer(lambda: layer_norm_fwd_reference(x, w, b, eps,
                                                            r)),
        "fwd_lib": timer(lambda: torch.nn.functional.layer_norm(
            x + r if residual else x, (d,), w, b, eps)),
        "bwd": timer(lambda: layer_norm_bwd(g, x, w, mean, rstd, r)),
        "bwd_plain": timer(lambda: layer_norm_bwd_reference(
            g, x, w, mean, rstd, r)),
        "bwd_lib": timer(lambda: torch.ops.aten.native_layer_norm_backward(
            g, xr, [d], lib_mean, lib_rstd, w, b, [True, True, True])),
    }
    tol = LN_TOL[tag]
    variant = f"{tag}{' residual' if residual else ''} ({rows}, {d})"
    lib = "F.layer_norm(x + r)" if residual else "F.layer_norm"
    log(f"[kernel] layer_norm[{variant}]: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {tol}); y/mean/rstd bit-identical over two runs: "
        f"{fwd_bits}; dw/db bit-identical over two runs"
        f"{', dr is dx' if residual else ''}: {same_bits}; "
        f"fwd kernel {times['fwd']:.4f} ms plain {times['fwd_plain']:.4f} "
        f"library({lib}) {times['fwd_lib']:.4f} bound "
        f"{fwd_bound[0]:.4f} ({fwd_bound[1]}, {fwd_bytes / 1e6:.1f} MB); "
        f"bwd kernel {times['bwd']:.4f} ms plain {times['bwd_plain']:.4f} "
        f"library(native_layer_norm_backward) {times['bwd_lib']:.4f} bound "
        f"{bwd_bound[0]:.4f} ({bwd_bound[1]}, {bwd_bytes / 1e6:.1f} MB)")
    bad = [k for k, (_, ok) in errs.items() if not ok]
    if bad or not same_bits or not fwd_bits:
        raise AssertionError(f"layer_norm[{variant}] disagrees with its "
                             f"plain version on {bad}, or y/mean/rstd "
                             f"({fwd_bits}) or dw/db (or dr) ({same_bits}) "
                             f"differ between runs")
    fwd = dict(variant=variant, max_abs_err=errs["y"][0],
               errors={k: errs[k][0] for k in ("y", "mean", "rstd")},
               bit_identical=fwd_bits,
               tol=tol, ms=times["fwd"], plain_ms=times["fwd_plain"],
               bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
               library_ms=times["fwd_lib"])
    bwd_keys = ("dx", "dw", "db") + (("dr",) if residual else ())
    bwd = dict(variant=variant, max_abs_err=max(errs[k][0]
                                                for k in bwd_keys),
               errors={k: errs[k][0] for k in bwd_keys},
               bit_identical=same_bits, tol=tol, ms=times["bwd"],
               plain_ms=times["bwd_plain"], bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1], library_ms=times["bwd_lib"])
    return fwd, bwd


def _bf16_steps(got, want32):
    """|got - round_bf16(want32)| in units of one bf16 step at that value
    (8 significand bits; the smallest normal's step at 0)."""
    want = want32.to(torch.bfloat16).float()
    _, e = torch.frexp(want)
    step = torch.ldexp(torch.ones_like(want), e - 8)
    step = torch.where(want == 0, torch.full_like(want, 2.0 ** -133), step)
    return ((got.float() - want).abs() / step).max().item()


def _xent_inputs(gen, rows, v, dtype, ignored):
    """Logits (about N(0, 4), a few spikes), labels with ``ignored`` of
    the rows at -100 and one past the vocabulary, an f32 output
    gradient."""
    x = torch.randn(rows, v, generator=gen, device=DEVICE) * 2
    x[::97, ::13] += 8.0
    lab = torch.randint(0, v, (rows,), generator=gen, device=DEVICE)
    drop = torch.rand(rows, generator=gen, device=DEVICE) < ignored
    lab = torch.where(drop, torch.full_like(lab, -100), lab)
    lab[min(3, rows - 1)] = v + 3
    g = torch.randn(rows, generator=gen, device=DEVICE)
    return x.to(dtype), lab, g


def _xent_entries(timer, gen, tag, rows, v, smoothing, ignored, timed):
    """The cross-entropy kernels against their plain versions at ``(rows,
    v)``: loss and lse relative to max(1, |ref|), dx (f32 absolute, bf16
    in steps of the plain version's rounded f32 result), every output
    bit-identical over two calls.  ``timed``: kernel, plain and library
    times and the bounds, the backward's counting only the logits of the
    rows it must read (ignored rows need none)."""
    from paddle_tpu_torch.ops.fused_kernels import (
        softmax_xent_bwd, softmax_xent_bwd_reference, softmax_xent_fwd,
        softmax_xent_fwd_reference)
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    x, lab64, g = _xent_inputs(gen, rows, v, dtype, ignored)
    lab = lab64.to(torch.int32)
    opts = (-100, smoothing)
    loss, lse = softmax_xent_fwd(x, lab, *opts)
    loss2, lse2 = softmax_xent_fwd(x, lab, *opts)
    dx = softmax_xent_bwd(g, x, lab, lse, *opts)
    dx2 = softmax_xent_bwd(g, x, lab, lse, *opts)
    loss_ref, lse_ref = softmax_xent_fwd_reference(x, lab, *opts)
    dx_ref = softmax_xent_bwd_reference(g, x.float(), lab, lse, *opts)
    torch.cuda.synchronize()
    errs, oks = {}, {}
    for key, got, want in (("loss", loss, loss_ref), ("lse", lse, lse_ref)):
        err = (got - want).abs()
        errs[key] = err.max().item()
        oks[key] = bool((err <= XENT_TOL["loss"] * torch.clamp(
            want.abs(), min=1.0)).all())
    errs["dx"] = (dx.float() - dx_ref).abs().max().item()
    if tag == "bf16":
        errs["dx_bf16_steps"] = _bf16_steps(dx, dx_ref)
        oks["dx"] = errs["dx_bf16_steps"] <= 1.0
    else:
        oks["dx"] = errs["dx"] <= XENT_TOL["f32"]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (loss, lse, dx))
    same_bits = (torch.equal(loss, loss2) and torch.equal(lse, lse2)
                 and torch.equal(dx, dx2))
    n_valid = int((lab != -100).sum().item())
    variant = (f"{tag} ({rows}, {v}) smoothing {smoothing} ignored "
               f"{rows - n_valid}/{rows}")
    log(f"[kernel] softmax_xent[{variant}]: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {XENT_TOL}); bit-identical over two calls: {same_bits}")
    bad = [k for k, ok in oks.items() if not ok]
    if bad or not finite or not same_bits:
        raise AssertionError(f"softmax_xent[{variant}] disagrees with its "
                             f"plain version on {bad} (finite {finite}), or "
                             f"differs between calls ({same_bits})")
    rows_out = {
        "softmax_xent_fwd": dict(variant=variant, max_abs_err=max(
            errs["loss"], errs["lse"]), errors={k: errs[k] for k in
                                                ("loss", "lse")}),
        "softmax_xent_bwd": dict(variant=variant, max_abs_err=errs["dx"],
                                 errors={k: v for k, v in errs.items()
                                         if k.startswith("dx")}),
    }
    for row in rows_out.values():
        row.update(tol=XENT_TOL, bit_identical=same_bits, ms=None,
                   plain_ms=None, bound_ms=None, bound_by=None,
                   library_ms=None)
    if not timed:
        return rows_out

    es, n = x.element_size(), rows * v
    stats = 4 * rows                                 # one int32/f32 a row
    fwd_bytes = n * es + 3 * stats                   # x, labels; loss, lse
    bwd_bytes = n_valid * v * es + n * es + 3 * stats   # read, dx, lab/lse/g
    dense_bwd = 2 * n * es + 3 * stats
    fwd_bound = bound_ms(fwd_bytes, 5.0 * n, torch.float32)
    bwd_bound = bound_ms(bwd_bytes, 5.0 * n_valid * v, torch.float32)
    ce = torch.nn.functional.cross_entropy
    xl = x.detach().requires_grad_()
    gl = g.to(dtype)
    # the library takes no label past the vocabulary: clip it, as the
    # kernels do for the target logit
    lab_lib = torch.where(lab64 == -100, lab64, lab64.clamp(max=v - 1))

    def lib_fwd_bwd():
        torch.autograd.grad(ce(xl, lab_lib, reduction="none"), xl, gl)

    times = {
        "fwd": timer(lambda: softmax_xent_fwd(x, lab, *opts)),
        "fwd_plain": timer(lambda: softmax_xent_fwd_reference(x, lab,
                                                              *opts)),
        "fwd_lib": timer(lambda: ce(x, lab_lib, reduction="none")),
        "bwd": timer(lambda: softmax_xent_bwd(g, x, lab, lse, *opts)),
        "bwd_plain": timer(lambda: softmax_xent_bwd_reference(
            g, x, lab, lse, *opts)),
        "both_lib": timer(lib_fwd_bwd),
    }
    times["bwd_lib"] = times["both_lib"] - times["fwd_lib"]
    log(f"[kernel] softmax_xent[{variant}] times: fwd kernel "
        f"{times['fwd']:.4f} ms plain {times['fwd_plain']:.4f} "
        f"library(F.cross_entropy, reduction none) {times['fwd_lib']:.4f} "
        f"bound {fwd_bound[0]:.4f} ({fwd_bound[1]}, {fwd_bytes / 1e6:.1f} "
        f"MB); bwd kernel {times['bwd']:.4f} ms plain "
        f"{times['bwd_plain']:.4f} library(forward+backward less forward) "
        f"{times['bwd_lib']:.4f} bound {bwd_bound[0]:.4f} ({bwd_bound[1]}, "
        f"{bwd_bytes / 1e6:.1f} MB: the {n_valid} valid rows read, dx "
        f"written; reading every row: {dense_bwd / 1e6:.1f} MB, "
        f"{dense_bwd / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    for name, key in (("softmax_xent_fwd", "fwd"),
                      ("softmax_xent_bwd", "bwd")):
        bnd = fwd_bound if key == "fwd" else bwd_bound
        rows_out[name].update(ms=times[key], plain_ms=times[key + "_plain"],
                              library_ms=times[key + "_lib"],
                              bound_ms=bnd[0], bound_by=bnd[1])
    rows_out["softmax_xent_bwd"]["bound_ms_reading_every_row"] = (
        dense_bwd / HBM_BYTES_PER_S * 1e3)
    return rows_out


def _w8a16_operands(gen, m, k, n, x_dtype):
    """x (M, K), an int8 (K, N) weight with its (N,) scale, and the
    weight dequantized ahead for the library call.  bf16 x is scaled to
    keep |out| < 4, where a bf16 step is at most 2^-6 < its tolerance."""
    from paddle_tpu_torch.ops.quant_kernels import quantize_weight
    x = torch.randn(m, k, generator=gen, device=DEVICE)
    if x_dtype == torch.bfloat16:
        x = (x * 0.25).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=DEVICE) * 0.02
    wq, sc = quantize_weight(w, axis=1)
    return x, wq, sc, (wq.float() * sc).to(x_dtype)


def _w8a16_entry(timer, ops, variant, tol):
    """Check the kernel against its plain version on every product of
    ``ops`` and time the products as one call: the kernel, the plain
    version, and the library call (matmul on the dequantized weight)."""
    from paddle_tpu_torch.ops.quant_kernels import (w8a16_matmul,
                                                    w8a16_matmul_reference)

    def run(fn):
        return [fn(x, wq, sc) for x, wq, sc, _ in ops]

    outs, wants = run(w8a16_matmul), run(w8a16_matmul_reference)
    torch.cuda.synchronize()
    err = max((o.float() - w.float()).abs().max().item()
              for o, w in zip(outs, wants))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    nbytes = sum(x.numel() * x.element_size() + wq.numel() + sc.numel() * 4
                 + x.shape[0] * wq.shape[1] * x.element_size()
                 for x, wq, sc, _ in ops)
    flops = sum(2.0 * x.shape[0] * x.shape[1] * wq.shape[1]
                for x, wq, _, _ in ops)
    # f32 x: f32 FMAs; bf16 x: the tensor cores' rate (int8 widens to bf16
    # exactly), so its bound is the bytes
    t_bound, by = bound_ms(nbytes, flops, ops[0][0].dtype)
    ms = timer(lambda: run(w8a16_matmul))
    plain = timer(lambda: run(w8a16_matmul_reference))
    lib = timer(lambda: [torch.matmul(x, wd) for x, _, _, wd in ops])
    log(f"[kernel] w8a16_matmul {variant}: max_abs_err {err:.3e} (tol "
        f"{tol:.0e}) kernel {ms:.4f} ms plain {plain:.4f} ms library(matmul "
        f"on the dequantized weight) {lib:.4f} ms bound {t_bound:.4f} ms "
        f"({by})")
    if not (finite and err <= tol):
        raise AssertionError(f"w8a16_matmul {variant} disagrees with its "
                             f"plain version: {err} > {tol}")
    return dict(variant=variant, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain, bound_ms=t_bound, bound_by=by, library_ms=lib)


def _w8a16_rows_alone(gen, kk, nn):
    """The serve engine's contract on the kernel, f32 x at (K, N): row r
    of a launch of M rows, for every M of ``W8A16_BITS_M``, has the bits of
    row r launched alone (M = 1), and two calls give the same bits; and
    the kernel's sums at M = 1 (the cluster's split K) and at the largest
    M (one block over all of K) have the bits of ``w8a16_split_reference``,
    the plain model of its sum order."""
    from paddle_tpu_torch.ops.quant_kernels import (w8a16_matmul,
                                                    w8a16_split_reference)
    mmax = max(W8A16_BITS_M)
    x, wq, sc, _ = _w8a16_operands(gen, mmax, kk, nn, torch.float32)
    alone = torch.cat([w8a16_matmul(x[r:r + 1], wq, sc)
                       for r in range(mmax)])
    differ = [m for m in W8A16_BITS_M
              if not torch.equal(w8a16_matmul(x[:m], wq, sc), alone[:m])]
    full = w8a16_matmul(x, wq, sc)
    again = torch.equal(full, w8a16_matmul(x, wq, sc))
    model = w8a16_split_reference(x, wq, sc)
    torch.cuda.synchronize()
    off_model = [m for m, got in ((1, alone[:1]), (mmax, full))
                 if not torch.equal(got, model[:m])]
    variant = (f"f32 x, K={kk} N={nn}: rows at M in {W8A16_BITS_M} against "
               f"each row alone; M = 1 and {mmax} against the split model")
    log(f"[kernel] w8a16_matmul {variant}: M with a differing row "
        f"{differ or 'none'}; bit-identical over two calls: {again}; M off "
        f"the split model's bits {off_model or 'none'} (max_abs_err "
        f"{(full - model).abs().max().item():.3e})")
    if differ or not again or off_model:
        raise AssertionError(f"w8a16_matmul {variant}: rows differ at M "
                             f"{differ}, or between calls ({again}), or "
                             f"from the split model at M {off_model}")
    return dict(variant=variant, max_abs_err=0.0, tol=0.0,
                bit_identical=True, ms=None, plain_ms=None, bound_ms=None,
                bound_by=None, library_ms=None)


def phase_model():
    """The step functions on the card (kernels) against the same steps on
    the CPU (plain versions), at a small width, from the same weights."""
    from paddle_tpu_torch.serving import model as M
    from paddle_tpu_torch.serving.quant import quantize_params
    spec = M.ModelSpec(vocab_size=512, hidden=256, layers=2, heads=4,
                       max_seq_len=256)
    ps, pages = PAGE_SIZE, 1 + 4 * 16
    cpu_params = M.init_params(spec, seed=1, device="cpu")
    rng = np.random.RandomState(1)
    lens = [5, 16, 33, 100]
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, pages))[:4 * 16].reshape(4, 16)
        .astype(np.int32))
    for prec in ("fp32", "int8"):
        params = (quantize_params(cpu_params, spec) if prec == "int8"
                  else cpu_params)
        logits = {}
        for dev in ("cpu", DEVICE):
            p = {k: v.to(dev) for k, v in params.items()}
            kv_dtype = torch.int8 if prec == "int8" else torch.float32
            shape = (spec.layers, pages * ps, spec.heads, spec.head_dim)
            kf = torch.zeros(shape, dtype=kv_dtype, device=dev)
            vf = torch.zeros(shape, dtype=kv_dtype, device=dev)
            kw = ({"k_scale": torch.zeros(shape[:3], device=dev),
                   "v_scale": torch.zeros(shape[:3], device=dev)}
                  if prec == "int8" else {})
            outs = []
            for row, n in enumerate(lens):
                toks = torch.from_numpy(
                    rng_tokens(row, 128, spec.vocab_size)).to(dev)
                *_, lg = M.prefill_step(spec, p, kf, vf, toks, n,
                                        tables[row].to(dev), page_size=ps,
                                        **kw)
                outs.append(lg)
            pos = torch.tensor(lens, dtype=torch.int32, device=dev)
            toks = torch.tensor([3, 7, 11, 13], dtype=torch.int32, device=dev)
            *_, lg = M.decode_step(spec, p, kf, vf, toks, pos, tables.to(dev),
                                   page_size=ps, **kw)
            outs.append(lg.reshape(-1))
            logits[dev] = torch.cat([o.reshape(-1).float().cpu()
                                     for o in outs])
        err = (logits["cpu"] - logits[DEVICE]).abs().max().item()
        log(f"[model] {prec}: prefill+decode logits, card vs CPU, max_abs_err "
            f"{err:.3e} (tol {MODEL_TOL[prec]:.0e})")
        if not (math.isfinite(err) and err <= MODEL_TOL[prec]):
            raise AssertionError(f"model {prec}: card and CPU disagree: {err}")


def rng_tokens(seed, n, vocab):
    return np.random.RandomState(100 + seed).randint(1, vocab, size=n) \
        .astype(np.int32)


def _serve_prompts(vocab):
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 501, size=32)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


def phase_serve(smi):
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine, init_params)
    spec = ModelSpec(**GPT_345M)
    prompts = _serve_prompts(spec.vocab_size)
    launches = {name: 0 for name in KERNELS}
    params = init_params(spec, seed=0, device=DEVICE)
    fp32_engine = None
    for prec in ("fp32", "bf16", "int8"):
        cfg = ServeConfig(decode_buckets=(2, 4, 8, 16),
                          prefill_buckets=(64, 128, 256, 512),
                          kv_pages=1024, page_size=PAGE_SIZE,
                          max_inflight=64, max_new_tokens=32,
                          precision=prec)
        t0 = time.perf_counter()
        engine = ServingEngine(spec, params, cfg, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sched = engine.scheduler
        sched._step_times.clear()
        steps0 = sched.stats["steps"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in KERNELS.items()}
        steps = sched.stats["steps"] - steps0
        step_times = list(sched._step_times)
        if len(outs) != 32 or any(
                len(o) != 32 or not all(0 <= t < spec.vocab_size for t in o)
                for o in outs):
            raise AssertionError(f"serve {prec}: malformed output")
        want = ["paged_attention_int8", "w8a16_matmul"] if prec == "int8" \
            else ["paged_attention"]
        for name in want:
            if counts[name] < spec.layers * steps:
                raise AssertionError(
                    f"serve {prec}: {name} launched {counts[name]} times, "
                    f"fewer than layers x decode steps = {spec.layers * steps}")
        for name in KERNELS:
            launches[name] += counts[name]
        decode_tokens = sum(len(o) - 1 for o in outs)
        log(f"[serve] {prec}: 32 requests x 32 tokens, {steps} decode steps, "
            f"decode {decode_tokens / sum(step_times):.1f} tok/s, median step "
            f"{statistics.median(step_times) * 1e3:.2f} ms, generate wall "
            f"{wall:.2f} s, engine build+warm-up {build_s:.2f} s, launches "
            f"{counts} | {smi}")

        # join/leave: prompts decoded alone (bucket 2) give the tokens
        # they got inside the batch (bucket 16)
        solo = [engine.generate([p], max_new_tokens=32)[0]
                for p in prompts[:4]]
        if solo == outs[:4]:
            log(f"[serve] {prec}: join/leave holds across buckets "
                f"(4 solo == in batch)")
        else:
            log(f"[serve] {prec}: join/leave FAILS across buckets 2 and 16; "
                f"checking within one bucket")
            one = ServingEngine(spec, params, cfg.replace(decode_buckets=(16,)),
                                device=DEVICE)
            batched = one.generate(prompts, max_new_tokens=32)
            solo = [one.generate([p], max_new_tokens=32)[0]
                    for p in prompts[:4]]
            one.close()
            del one
            if solo != batched[:4]:
                raise AssertionError(f"serve {prec}: join/leave fails even "
                                     f"within one bucket")
            log(f"[serve] {prec}: join/leave holds within bucket 16 only")
        if prec == "fp32":
            fp32_engine = engine
        else:
            engine.close()
            del engine
            torch.cuda.empty_cache()
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve path")
    return fp32_engine, launches, prompts, params


def _decode_stages(spec, p, k_flat, v_flat, tokens, positions, tables):
    """``decode_step`` of the serving model at bf16, split into its
    stages: yields ``(stage, tensor)`` in the order the step runs them,
    each tensor with the batch on its first axis; writes the pools as the
    step does."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention
    from paddle_tpu_torch.serving import model as M
    b, cdt = tokens.shape[0], p["embed"].dtype
    positions = positions.to(torch.int32)
    dest = M._flat_dest(tables, positions, PAGE_SIZE)
    pages = (k_flat.shape[1] // PAGE_SIZE, PAGE_SIZE, spec.heads,
             spec.head_dim)
    h = p["embed"][tokens.long()] + p["pos"][positions.long()]
    yield "embedding", h
    for i in range(spec.layers):
        x = M._ln(h, p[f"h{i}.ln1.w"], p[f"h{i}.ln1.b"]).to(cdt)
        yield f"layer {i} ln1", x
        q, k, v = (M._matmul(p, f"h{i}.attn.{w}", x).reshape(
            b, spec.heads, spec.head_dim) for w in ("wq", "wk", "wv"))
        yield f"layer {i} qkv products", torch.cat([q, k, v], -1)
        M._write_kv(k_flat, v_flat, None, None, i, dest, k, v)
        o = paged_attention(q, k_flat[i].view(pages), v_flat[i].view(pages),
                            tables, positions + 1)
        yield f"layer {i} paged attention (port kernel)", o
        a = M._matmul(p, f"h{i}.attn.wo", o.reshape(b, spec.hidden))
        yield f"layer {i} out_proj", a
        h = h + a
        x2 = M._ln(h, p[f"h{i}.ln2.w"], p[f"h{i}.ln2.b"]).to(cdt)
        yield f"layer {i} ln2", x2
        f1 = M._matmul(p, f"h{i}.mlp.w1", x2) + p[f"h{i}.mlp.b1"]
        yield f"layer {i} mlp fc1", f1
        g = torch.nn.functional.gelu(f1, approximate="tanh")
        f2 = M._matmul(p, f"h{i}.mlp.w2", g) + p[f"h{i}.mlp.b2"]
        yield f"layer {i} mlp fc2", f2
        h = h + f2
    hf = M._ln(h, p["lnf.w"], p["lnf.b"]).to(cdt)
    yield "final ln", hf
    logits = hf @ p["embed"].T
    yield "logits", logits
    yield "next token", torch.argmax(logits, dim=-1)


def phase_bucket_stages(params, prompts):
    """Where bf16 join/leave across decode buckets breaks.  A bf16 engine
    (gpt_345m, the serve phase's weights) generates 16 prompts together
    (decode bucket 16), then the first one alone (bucket 2); every decode
    step of that prompt also runs split into its stages
    (:func:`_decode_stages`, whose logits must equal the step's).  Prints
    the first step and stage at which the prompt's row differs bit for
    bit between the two runs, or that none does; fails when that stage is
    the port's own kernel (paged attention), whose sums must not depend
    on the batch."""
    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine)
    from paddle_tpu_torch.serving import engine as E
    spec = ModelSpec(**GPT_345M)
    cfg = ServeConfig(decode_buckets=(2, 4, 8, 16),
                      prefill_buckets=(64, 128, 256, 512), kv_pages=1024,
                      page_size=PAGE_SIZE, max_inflight=64,
                      max_new_tokens=32, precision="bf16")
    # the stages are read on the host, so the buckets run eagerly here
    # (no graphs), each through decode_step
    engine = _uncaptured_engine(spec, params, cfg, device=DEVICE)
    record = []
    step_fn = E.decode_step

    def staged(sp, p, k_flat, v_flat, tokens, positions, tables, **kw):
        stages = list(_decode_stages(sp, p, k_flat.clone(), v_flat.clone(),
                                     tokens, positions, tables))
        out = step_fn(sp, p, k_flat, v_flat, tokens, positions, tables, **kw)
        if not torch.equal(stages[-2][1], out[-1]):
            raise AssertionError("the staged decode step is not decode_step")
        record.append((tokens.shape[0], [(n, t[0].clone())
                                         for n, t in stages]))
        return out

    E.decode_step = staged
    try:
        batched = engine.generate(prompts[:16], max_new_tokens=32)
        runs = {16: record[:31]}
        record.clear()
        solo = engine.generate(prompts[:1], max_new_tokens=32)
        runs[2] = record[:31]
    finally:
        E.decode_step = step_fn
        engine.close()
    if {b for b, _ in runs[16]} != {16} or {b for b, _ in runs[2]} != {2}:
        raise AssertionError("the bucket runs did not decode in buckets 16 "
                             "and 2")
    first = None
    for i, ((_, big), (_, small)) in enumerate(zip(runs[16], runs[2])):
        for (name, x), (_, y) in zip(big, small):
            if not torch.equal(x, y):
                diff = (x.float() - y.float()).abs().max().item()
                first = (f"decode step {i + 1}, {name} (max abs difference "
                         f"{diff:.3e})")
                break
        if first:
            break
    log(f"[serve] bf16 prompt 0 in bucket 16 vs alone in bucket 2: tokens "
        f"{'equal' if solo[0] == batched[0] else 'differ'}; first stage whose "
        f"row differs bit for bit: {first}")
    if first is not None and "port kernel" in first:
        raise AssertionError(f"the port's kernel depends on the bucket: "
                             f"{first}")
    return first


def phase_http(engine, prompt):
    from paddle_tpu_torch.serving.http import ServeHTTPServer
    srv = ServeHTTPServer(engine, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"tokens": prompt, "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body = r.status, json.loads(r.read())
        if status != 200 or len(body["tokens"]) != 8:
            raise AssertionError(f"/v1/generate: {status} {body}")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or not health["ok"]:
            raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"[http] /v1/generate 200 with 8 tokens in "
            f"{body['latency_ms']:.1f} ms; /healthz ok")
        return _telemetry_serve(engine, base, prompt)
    finally:
        srv.stop()
        engine.close()


# -- phase 21: telemetry and the tuner ----------------------------------------

def _prom_value(text, name, **labels):
    """The sample ``name`` with ``labels`` (among others: the process's
    identity) in Prometheus text; None when absent."""
    for line in text.splitlines():
        if line.startswith("#") or not line.startswith(name):
            continue
        key, value = line.rsplit(" ", 1)
        series, _, rest = key.partition("{")
        if series != name:
            continue
        got = dict(kv.split("=", 1) for kv in rest.rstrip("}").split(",")
                   if kv)
        if all(got.get(k) == f'"{v}"' for k, v in labels.items()):
            return float(value)
    return None


def _telemetry_serve(engine, base, prompt):
    """Phase 21 (a): telemetry on over the live server; returns {path:
    launch counts} of its requests."""
    from paddle_tpu_torch.observability import configure, reset
    from paddle_tpu_torch.ops import reset_launch_counts
    t0 = time.perf_counter()
    configure(enabled=True)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        generated = 0
        for i in range(TELEMETRY_REQUESTS):
            status, body = _post(base, "/v1/generate",
                                 {"tokens": prompt[i:],
                                  "max_new_tokens": 8 + i})
            if status != 200:
                raise AssertionError(f"(a) /v1/generate: {status} {body}")
            generated += len(body["tokens"])
        launches = _launch_counts()
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            status, ctype = r.status, r.headers["Content-Type"]
            text = r.read().decode()
        kv = engine.pool.snapshot()
        got = {
            "requests": _prom_value(text, "pt_serve_requests_total"),
            "completed": _prom_value(text, "pt_serve_completed_total"),
            "tokens": _prom_value(text, "pt_serve_tokens_total"),
            "queue_depth": _prom_value(text, "pt_serve_queue_depth"),
            "active": _prom_value(text, "pt_serve_active_sequences"),
            "kv_used": _prom_value(text, "pt_serve_kv_pages", state="used"),
            "kv_free": _prom_value(text, "pt_serve_kv_pages", state="free"),
            "kv_reserved": _prom_value(text, "pt_serve_kv_pages",
                                       state="reserved"),
            "http_count": _prom_value(
                text, "pt_serve_http_request_seconds_count")}
        want = {"requests": TELEMETRY_REQUESTS,
                "completed": TELEMETRY_REQUESTS, "tokens": generated,
                "queue_depth": 0, "active": 0,
                "kv_used": kv["used_pages"], "kv_free": kv["free_pages"],
                "kv_reserved": kv["reserved_pages"],
                "http_count": TELEMETRY_REQUESTS}
        PHASE21_S["a"] = time.perf_counter() - t0
        log(f"[telemetry] (a) /metrics {status} {ctype!r}, "
            f"{len(text.splitlines())} lines: {got}; want {want}; "
            f"paged_attention launches {launches['paged_attention']} "
            f"({PHASE21_S['a']:.1f} s)")
        if status != 200 or not ctype.startswith(
                "text/plain; version=0.0.4") or got != want:
            raise AssertionError(f"(a) /metrics: {status} {ctype}, {got} "
                                 f"against {want}")
        if launches["paged_attention"] == 0:
            raise AssertionError("(a) the requests launched no paged "
                                 "attention")
    finally:
        configure(enabled=False)
        reset()
    return {f"serve fp32 {TELEMETRY_REQUESTS} requests telemetry on":
            launches}


def _telemetry_turns(smi, a, ds, gpt, root):
    """Phase 21 (b): ``a`` (phase 14's captured hapi Model) fit in turns
    telemetry off / on / on / off, an epoch of a 2-worker loader a turn.
    Returns {path: launch counts} of the on turns."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.observability import (configure, get_registry,
                                                get_telemetry, reset)
    from paddle_tpu_torch.ops import reset_launch_counts
    t_start = time.perf_counter()
    label = f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} hapi fit telemetry on"
    sink_dir = os.path.join(root, "telemetry")

    class Tokens(_HapiTokens):
        """Defined here, so it does not pickle: the loader forks."""

    class MemoryAt(Callback):
        """At each step the gauges were read: the gauge against the
        allocator's counter read now, at the same step boundary."""

        def __init__(self):
            super().__init__()
            self.pairs = []

        def on_train_batch_end(self, step, logs=None):
            tel = get_telemetry()
            if tel.enabled and tel._steps % tel._mem_every == 0:
                gauge = get_registry().gauge(
                    "pt_device_memory_bytes", labelnames=("stat",)).value(
                    stat="bytes_in_use")
                self.pairs.append((gauge, torch.cuda.memory_stats()[
                    "allocated_bytes.all.current"]))

    data = Tokens(gpt.vocab_size)
    per_turn = len(data) // FUSED_BATCH
    times = {True: [], False: []}
    mem = MemoryAt()
    stats0 = dict(a.train_step.captured.stats)
    launches = {}
    for on in TELEMETRY_TURNS:
        if on:
            tel = configure(enabled=True, jsonl_dir=sink_dir)
            tel._mem_every = per_turn
            before = dict(a.train_step.captured.stats)
            torch.cuda.synchronize()
            reset_launch_counts()
        clock = _hapi_callbacks()
        loader = _hapi_loader(data)
        a.fit(loader, epochs=1, verbose=0, callbacks=[clock, mem])
        times[on] += clock.times[1:]       # the first waits on the workers
        if on:
            counts = _launch_counts()
            launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
            after = a.train_step.captured.stats
            configure(enabled=False)
            for k in ("hits", "misses"):
                stats0[k + "_on"] = stats0.get(k + "_on", 0) + \
                    after[k] - before[k]
    snap = get_registry().snapshot()
    records = []
    for name in sorted(os.listdir(sink_dir)):
        with open(os.path.join(sink_dir, name)) as f:
            records += [json.loads(line) for line in f]
    reset()

    def value(metric, key=""):
        series = snap.get(metric, {}).get("series", {})
        v = series.get(key)
        return v["count"] if isinstance(v, dict) else v

    n_on = per_turn * TELEMETRY_TURNS.count(True)
    got = {"steps": value("pt_steps_total", "mode=train"),
           "hits": value("pt_capture_cache_hits_total"),
           "misses": sum(v for v in snap.get(
               "pt_capture_cache_misses_total", {}).get(
               "series", {}).values()),
           "data_waits": value("pt_data_wait_seconds"),
           "step_records": sum(r["event"] == "step" for r in records)}
    want = {"steps": n_on, "hits": stats0["hits_on"],
            "misses": stats0["misses_on"], "data_waits": n_on,
            "step_records": n_on}
    med = {on: statistics.median(t) * 1e3 for on, t in times.items()}
    PHASE21_S["b"] = time.perf_counter() - t_start
    log(f"[telemetry] (b) {label}: {got}, want {want} (the capture's own "
        f"hits / misses over the on turns); memory gauge against "
        f"memory_stats() at the steps it was read {mem.pairs}; median step "
        f"with telemetry on {med[True]:.3f} ms, off {med[False]:.3f} ms "
        f"(on - off {med[True] - med[False]:+.3f} ms; turns "
        f"{'/'.join('on' if t else 'off' for t in TELEMETRY_TURNS)}, "
        f"{per_turn} steps each, the loss read each step) "
        f"({PHASE21_S['b']:.1f} s) | {smi}")
    if got != want or want["misses"] != 0:
        raise AssertionError(f"(b) telemetry: {got} against {want}")
    if len(mem.pairs) != TELEMETRY_TURNS.count(True) or any(
            g != m for g, m in mem.pairs):
        raise AssertionError(f"(b) the memory gauge {mem.pairs}")
    _check_counts(label, launches, _headline_per_step(gpt), n_on)
    return {label: launches}


def _plan_collectives(plan, steps):
    """Phase 21 (c): {op: (calls, input bytes)} one launched rank makes in
    ``steps`` ZeRO steps at sharding 2 (dp 1), from its plan (``plan``:
    the reducer's buckets as (kind, bytes), the gather buckets' bytes,
    the loss's, the clip's and the criterion's bytes): a step
    reduce-scatters or all-reduces each reducer bucket, all-reduces the
    clip's two partial squares and the loss over the sharding group,
    all-gathers each gather bucket's window (its bytes over the group's
    size), and the vocabulary-parallel cross-entropy all-reduces its
    rows' max, sum of exponentials and target logit (f32, one a token)
    over fleet's model-parallel group, of one rank here."""
    want = {"all_reduce": [0, 0], "reduce_scatter": [0, 0],
            "all_gather": [0, 0]}
    for kind, nbytes in plan["reduce"]:
        want[kind][0] += steps
        want[kind][1] += steps * nbytes
    for nbytes in plan["gather"]:
        want["all_gather"][0] += steps
        want["all_gather"][1] += steps * nbytes // plan["n"]
    want["all_reduce"][0] += 5 * steps
    want["all_reduce"][1] += steps * (plan["clip_bytes"] + plan["loss_bytes"]
                                      + 3 * plan["criterion_bytes"])
    return {op: tuple(v) for op, v in want.items() if v[0]}


def _check_rank_collectives(res, steps):
    """Phase 21 (c): one launched rank's telemetry against its plan."""
    snap, plan = res["telemetry"], res["plan"]
    want = _plan_collectives(plan, steps)

    def series(name):
        return {k.split("=", 1)[1]: (v["count"] if isinstance(v, dict)
                                     else v)
                for k, v in snap.get(name, {}).get("series", {}).items()}
    got = {op: (int(n), int(series("pt_collective_bytes_total").get(op, 0)))
           for op, n in series("pt_collective_ops_total").items()}
    buckets = {}
    for kind, _ in plan["reduce"]:
        buckets[kind] = buckets.get(kind, 0) + 1
    got_buckets = {k: int(v) for k, v in
                   series("pt_grad_buckets_total").items()}
    timed = {k: int(v) for k, v in
             series("pt_collective_time_seconds").items()}
    per_call_ms = {
        k.split("=", 1)[1]: round(v["sum"] / v["count"] * 1e3, 3)
        for k, v in snap["pt_collective_time_seconds"]["series"].items()}
    log(f"[telemetry] (c) launched rank {res['rank']}: collectives {got} "
        f"(want {want} from the plan: reducer buckets {plan['reduce']}, "
        f"gather buckets {plan['gather']} over {plan['n']} ranks, "
        f"{steps} steps); grad buckets {got_buckets} (want {buckets}); "
        f"host-timed calls {timed}, mean host ms a call {per_call_ms}")
    if got != want or got_buckets != buckets or \
            timed != {op: n for op, (n, _) in want.items()}:
        raise AssertionError(f"(c) rank {res['rank']}: collectives {got} "
                             f"against {want}, buckets {got_buckets} "
                             f"against {buckets}, timed {timed}")


def phase_tuner(smi):
    """Phase 21 (d): ``AutoTuner`` on GPT-345m on this card; returns
    {path: launch counts} of each trial."""
    import tempfile
    from paddle_tpu_torch.distributed.auto_parallel.cluster import Cluster
    from paddle_tpu_torch.distributed.auto_tuner import (AutoTuner,
                                                         HistoryRecorder)
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.ops import reset_launch_counts
    from paddle_tpu_torch.train import build_train_step, make_batch
    t_start = time.perf_counter()
    base = gpt_345m(max_position_embeddings=TRAIN_SEQ)
    h, layers = base.hidden_size, base.num_layers
    # the word and position embeddings, the blocks, the final LayerNorm
    # (parallel_cost's count: 354,871,296 at GPT-345m)
    n_params = ((base.vocab_size + base.max_position_embeddings) * h
                + layers * (12 * h * h + 13 * h) + 2 * h)
    model = {"n_params": n_params, "num_layers": layers,
             "hidden_size": h, "seq_len": TRAIN_SEQ}
    tuner = AutoTuner({
        "candidates": {"dp_degree": [1], "mp_degree": [1],
                       "pp_degree": [1], "sharding_degree": [1],
                       "micro_batch_size": list(TUNER_MBS),
                       "use_recompute": list(TUNER_RECOMPUTE)},
        "num_chips": 1, "model": model, "cluster": Cluster.auto_detect()})
    out, rows = {}, []
    while (cfg := tuner.search_once()) is not None:
        mbs, rc = cfg["micro_batch_size"], cfg["use_recompute"]
        gpt = gpt_345m(use_recompute=rc, max_position_embeddings=TRAIN_SEQ)
        label = (f"gpt_345m {mbs}x{TRAIN_SEQ} tuner trial "
                 f"{'recompute' if rc else 'no recompute'}")
        step = None
        try:
            step = build_train_step(gpt, device=DEVICE, seed=0, fusion=True)
            ids, labels = make_batch(gpt, mbs, TRAIN_SEQ, seed=0,
                                     device=DEVICE)
            torch.cuda.synchronize()
            reset_launch_counts()
            step(ids, labels).item()                       # the capture
            times = []
            for _ in range(TUNER_REPLAYS):
                t0 = time.perf_counter()
                step(ids, labels).item()
                times.append(time.perf_counter() - t0)
            launches = _launch_counts()
            _check_captured(label, step, TUNER_REPLAYS + 1)
            status = "ok"
        except torch.cuda.OutOfMemoryError:
            status, times, launches = "oom", None, {}
        del step
        _free_steps()
        med = statistics.median(times) if times else None
        tps = mbs * TRAIN_SEQ / med if med else None
        tuner.add_cfg(**cfg, throughput=tps, status=status,
                      measured_step_time=med)
        rows.append((label, cfg["predicted_step_time"], med, tps, status))
        log(f"[tuner] {label}: predicted {cfg['predicted_step_time']:.4f} s "
            f"({cfg['predicted_memory_bytes'] / 1e9:.2f} GB), measured "
            f"{med if med is None else round(med, 5)} s a step "
            f"({tps if tps is None else round(tps, 1)} tokens/s), {status}; "
            f"replays {[round(t * 1e3, 2) for t in times or []]} ms | {smi}")
        if status != "ok":
            raise AssertionError(f"(d) {label}: the cost model kept it and "
                                 f"it ran out of memory")
        per = _recompute_per_step(gpt) if rc else _headline_per_step(gpt)
        _check_counts(label, launches, per, TUNER_REPLAYS + 1)
        out[label] = launches
    history = tuner.recorder.history
    best, err = tuner.get_best()
    fastest = max(history, key=lambda c: c["throughput"])
    with tempfile.TemporaryDirectory(prefix="pt_tuner_") as d:
        path = os.path.join(d, "history.csv")
        tuner.recorder.store_history(path)
        with open(path, "rb") as f:
            first = f.read()
        back = HistoryRecorder()
        rows_back, missing = back.load_history(path)
        again = os.path.join(d, "again.csv")
        back.store_history(again)
        with open(again, "rb") as f:
            same = f.read() == first
        best_back, _ = back.get_best()
    PHASE21_S["d"] = time.perf_counter() - t_start
    log(f"[tuner] (d) {len(history)} trials, pruned by the cost model "
        f"{tuner.pruned_by_cost}; best {best['micro_batch_size']} x "
        f"{TRAIN_SEQ}, recompute {best['use_recompute']}: "
        f"{best['throughput']:.1f} tokens/s (predicted "
        f"{best['predicted_step_time']:.4f} s, measured "
        f"{best['measured_step_time']:.5f} s); the CSV read back "
        f"{len(rows_back)} rows, written again the same bytes {same} "
        f"({PHASE21_S['d']:.1f} s) | {smi}")
    if err or best is not fastest or len(history) != \
            len(TUNER_MBS) * len(TUNER_RECOMPUTE) or missing or not same \
            or best_back["throughput"] != best["throughput"]:
        raise AssertionError(f"(d) the tuner: best {best} against the "
                             f"fastest {fastest}, history {history}, CSV "
                             f"read back {rows_back}")
    return out


def phase_train(smi):
    """The training path on the card: card against CPU at a small width
    (plain attention at sequence 64, the flash kernels at 512), then 8
    steps of gpt_345m at sequence 1024 (the main path), then a few at
    sequence 256, below the flash lengths."""
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.train import build_train_step, make_batch

    # same weights, f32, dropout 0: the 3-step loss trajectory, below and
    # at the flash lengths (the position table widened to 512)
    for seq in (64, F.FLASH_MIN_SEQ):
        cfg = dataclasses.replace(
            gpt_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     use_recompute=True), max_position_embeddings=max(seq, 128))
        steps = {dev: build_train_step(cfg, device=dev, seed=1, amp_o2=False,
                                       fusion=False)
                 for dev in ("cpu", DEVICE)}
        steps[DEVICE].model.load_state_dict(steps["cpu"].model.state_dict())
        ids, labels = make_batch(cfg, 4, seq, seed=1, device="cpu")
        reset_launch_counts()
        traj = {dev: [st(ids.to(dev), labels.to(dev)).item()
                      for _ in range(3)] for dev, st in steps.items()}
        flash = {n: KERNELS[n].launches for n in FLASH_KERNELS}
        _check_small_captured(f"train seq {seq}", steps, 3)
        err = max(abs(a - b) for a, b in zip(traj["cpu"], traj[DEVICE]))
        log(f"[train] gpt_tiny seq {seq} f32 3-step loss, card {traj[DEVICE]} "
            f"vs CPU {traj['cpu']}: max diff {err:.3e} (tol {TRAIN_TOL:.0e}); "
            f"flash launches on the card {flash}")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"train seq {seq}: card and CPU trajectories "
                                 f"differ by {err}")
        want = 0 if seq < F.FLASH_MIN_SEQ else 3 * cfg.num_layers
        if flash["flash_bwd_dq"] != want:
            raise AssertionError(f"train seq {seq}: flash dq launched "
                                 f"{flash['flash_bwd_dq']} times, want {want}")
        del steps

    launches = _train_run(smi, TRAIN_SEQ, TRAIN_STEPS, profile=True)
    short = _train_run(smi, SHORT_SEQ, SHORT_STEPS, profile=False)
    if any(short[n] for n in FLASH_KERNELS):
        raise AssertionError(f"train seq {SHORT_SEQ}: flash kernels launched "
                             f"below the flash lengths: {short}")
    return launches


def _train_run(smi, seq, n_steps, profile):
    """gpt_345m, batch 16 x ``seq``, O2 bf16, recompute, dropout 0.1, for
    ``n_steps`` on a fixed batch; the kernel counters set to 0 just before
    and read just after.  Checks finite, falling losses and the launches
    per step; returns the launch counts."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_345m(use_recompute=True, max_position_embeddings=seq)
    t0 = time.perf_counter()
    step = build_train_step(cfg, device=DEVICE, seed=0, fusion=False)
    ids, labels = make_batch(cfg, TRAIN_BATCH, seq, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in step.params.values())
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())   # waits for the card
        times.append(time.perf_counter() - t0)
    launches = {name: KERNELS[name].launches for name in KERNELS}
    _check_captured(f"train seq {seq}", step, n_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times[1:])
    tokens = TRAIN_BATCH * seq
    layers = cfg.num_layers
    # per step: LayerNorm 2 per block and the final one, the blocks' 2
    # again in the backward pass's recompute, one backward each; flash
    # one forward per block and again in the recompute, one dq and one
    # dk/dv per block
    flash = seq >= F.FLASH_MIN_SEQ
    per_step = {"layer_norm_fwd": 4 * layers + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "flash_fwd": 2 * layers if flash else 0,
                "flash_bwd_dq": layers if flash else 0,
                "flash_bwd_dkv": layers if flash else 0}
    log(f"[train] gpt_345m ({n_params} parameters) batch {TRAIN_BATCH} x "
        f"seq {seq}, O2 bf16, AdamW, recompute: losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(t * 1e3, 2) for t in times]}; median step (2..{n_steps}) "
        f"{med * 1e3:.2f} ms, {tokens / med:.1f} tokens/s; first step "
        f"{times[0] * 1e3:.1f} ms; build {build_s:.2f} s; peak memory "
        f"{peak_gb:.2f} GB; launches {launches} | {smi}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train seq {seq}: loss not finite and falling: "
                             f"{losses}")
    for name, n in per_step.items():
        if launches[name] != n_steps * n:
            raise AssertionError(f"train seq {seq}: {name} launched "
                                 f"{launches[name]} times in {n_steps} steps, "
                                 f"want {n_steps * n}")
    if profile:
        _profile_train_step(step, ids, labels, med, smi, "gpt_345m",
                            flash_bwd=layers)
    del step
    torch.cuda.empty_cache()
    return launches


def _profile_train_step(step, inputs, targets, step_s, smi, model,
                        steps=2, flash_bwd=None):
    """Where a training step's time goes: device time summed over the
    step's kernels under ``torch.profiler``, its share of the median
    step wall time, device operations per step, the largest kernels, and
    the port's kernels' shares (``PROFILE_KERNELS``: LayerNorm, the flash
    forward and backward, ...).  ``flash_bwd``: the flash backward's calls
    a step, checked to be the wgmma kernels' (``WG_FLASH_BWD``), none of
    them the mma.sync ones."""
    from paddle_tpu_torch.serving.profile import _device_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(inputs, targets).item()
    torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("train: the profiler recorded no device time")
    busy_ms = sum(_device_us(e) for e in kernels) / steps / 1e3
    ops = sum(e.count for e in kernels) / steps
    shares, own = [], []
    for label, names in PROFILE_KERNELS.items():
        es = [e for e in kernels if any(n in e.key for n in names)]
        if not es:
            continue
        ms = sum(_device_us(e) for e in es) / steps / 1e3
        shares.append(f"{label} kernels {ms:.3f} ms per step "
                      f"({ms / busy_ms:.3f} of device time)")
        own += es
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    top += [e for e in own if e not in top]
    log(f"[train] profile of {steps} {model} steps: device busy "
        f"{busy_ms:.3f} ms per step, {busy_ms / (step_s * 1e3):.3f} of the "
        f"median step wall {step_s * 1e3:.2f} ms; {ops:.0f} device ops per "
        f"step; {'; '.join(shares)} | {smi}")
    for e in top:
        log(f"    {_device_us(e) / steps / 1e3:8.3f} ms {e.count / steps:6.0f}"
            f" calls  {e.key[:100]}")
    if flash_bwd is not None:
        calls = {n: sum(e.count for e in kernels if n in e.key) / steps
                 for n in WG_FLASH_BWD + MMA_FLASH_BWD}
        want = {n: flash_bwd if n in WG_FLASH_BWD else 0 for n in calls}
        log(f"[train] {model}: flash backward calls a step {calls}")
        if calls != want:
            raise AssertionError(f"{model}: flash backward calls a step "
                                 f"{calls}, want {want}")


def phase_bert(smi):
    """The BERT pretraining path on the card: card against CPU at a small
    width (a padding mask at sequence 64, the flash kernels at 512), then
    8 steps of bert_base at 32 x 128 (the main path), then 2 at 8 x 512.
    Returns the main path's launch counts and the 512 run's."""
    from paddle_tpu_torch.incubate.models import bert_tiny
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        make_bert_batch)

    # same weights, f32, dropout 0: the 3-step loss trajectory with a
    # padding mask (plain attention) and at the flash lengths
    for seq, padded in ((64, True), (F.FLASH_MIN_SEQ, False)):
        cfg = dataclasses.replace(
            bert_tiny(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0),
            max_position_embeddings=max(seq, 128))
        steps = {dev: build_bert_pretrain_step(cfg, device=dev, seed=1,
                                               amp_o2=False, fusion=False)
                 for dev in ("cpu", DEVICE)}
        steps[DEVICE].model.load_state_dict(steps["cpu"].model.state_dict())
        inputs, targets = make_bert_batch(cfg, 4, seq, seed=1, device="cpu",
                                          padded=padded)
        reset_launch_counts()
        traj = {}
        for dev, st in steps.items():
            on = ({k: v.to(dev) for k, v in inputs.items()},
                  {k: v.to(dev) for k, v in targets.items()})
            traj[dev] = [st(*on).item() for _ in range(3)]
        counts = {n: KERNELS[n].launches for n in XENT_KERNELS
                  + FLASH_KERNELS}
        _check_small_captured(f"bert seq {seq}", steps, 3)
        err = max(abs(a - b) for a, b in zip(traj["cpu"], traj[DEVICE]))
        log(f"[bert] bert_tiny seq {seq}{' padding mask' if padded else ''} "
            f"f32 3-step loss, card {traj[DEVICE]} vs CPU {traj['cpu']}: max "
            f"diff {err:.3e} (tol {TRAIN_TOL:.0e}); launches on the card "
            f"{counts}")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"bert seq {seq}: card and CPU trajectories "
                                 f"differ by {err}")
        flash = 0 if padded else 3 * cfg.num_layers
        want = {"softmax_xent_fwd": 6, "softmax_xent_bwd": 6,
                **{n: flash for n in FLASH_KERNELS}}
        if counts != want:
            raise AssertionError(f"bert seq {seq}: launches {counts}, want "
                                 f"{want}")
        del steps

    _bert_kernels_vs_plain()
    main = _bert_run(smi, BERT_BATCH, BERT_SEQ, BERT_STEPS, profile=True)
    long = _bert_run(smi, BERT_LONG_BATCH, BERT_LONG_SEQ, BERT_LONG_STEPS,
                     profile=False)
    return main, long


def _bert_kernels_vs_plain(n_steps=3):
    """bert_base at the main path's shape, O2 bf16, dropout 0: the loss
    trajectory on the kernels, then from the same weights with the
    LayerNorm and cross-entropy wrappers replaced by their plain versions
    (on the card's tensors); relative difference within
    ``BERT_PLAIN_TOL``."""
    from paddle_tpu_torch.incubate.models import bert_base
    from paddle_tpu_torch.ops import fused_kernels as fk
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        make_bert_batch)
    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    inputs, targets = make_bert_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0,
                                      device=DEVICE)
    names = ("layer_norm_fwd", "layer_norm_bwd", "softmax_xent_fwd",
             "softmax_xent_bwd")
    kernels = {n: getattr(fk, n) for n in names}
    traj = {}
    try:
        for mode in ("kernels", "plain"):
            for n in names:
                setattr(fk, n, kernels[n] if mode == "kernels"
                        else getattr(fk, n + "_reference"))
            step = build_bert_pretrain_step(cfg, device=DEVICE, seed=0,
                                            fusion=False)
            traj[mode] = [step(inputs, targets).item()
                          for _ in range(n_steps)]
            del step
            torch.cuda.empty_cache()
    finally:
        for n in names:
            setattr(fk, n, kernels[n])
    err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernels"],
                                                  traj["plain"]))
    log(f"[bert] bert_base {BERT_BATCH} x {BERT_SEQ} O2 bf16 dropout 0, "
        f"{n_steps}-step loss on the kernels {traj['kernels']} vs their "
        f"plain versions {traj['plain']}: max relative diff {err:.3e} (tol "
        f"{BERT_PLAIN_TOL:.0e})")
    if not err <= BERT_PLAIN_TOL:
        raise AssertionError(f"bert_base: the kernels' trajectory differs "
                             f"from the plain versions' by {err}")


def _bert_run(smi, batch, seq, n_steps, profile):
    """bert_base, ``batch`` x ``seq``, O2 bf16, dropout 0.1, no recompute,
    for ``n_steps`` on a fixed batch; the kernel counters set to 0 just
    before and read just after.  Checks finite losses and the launches
    per step; returns the launch counts (residual LayerNorm launches
    under ``layer_norm_*.residual``)."""
    from paddle_tpu_torch.incubate.models import bert_base
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import reset_launch_counts
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        make_bert_batch)
    cfg = bert_base()
    t0 = time.perf_counter()
    step = build_bert_pretrain_step(cfg, device=DEVICE, seed=0, fusion=False)
    inputs, targets = make_bert_batch(cfg, batch, seq, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in step.params.values())
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step(inputs, targets).item())   # waits for the card
        times.append(time.perf_counter() - t0)
    launches = _launch_counts()
    _check_captured(f"bert {batch} x {seq}", step, n_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times[1:])
    layers = cfg.num_layers
    # per step: LayerNorm after the embeddings and in the MLM head, two
    # with a residual per block, one backward each; the MLM and the NSP
    # loss; flash one forward, one dq and one dk/dv per block from 512 on
    flash = layers if seq >= F.FLASH_MIN_SEQ else 0
    per_step = {"layer_norm_fwd": 2 * layers + 2,
                "layer_norm_bwd": 2 * layers + 2,
                "layer_norm_fwd.residual": 2 * layers,
                "layer_norm_bwd.residual": 2 * layers,
                "softmax_xent_fwd": 2, "softmax_xent_bwd": 2,
                **{n: flash for n in FLASH_KERNELS}}
    log(f"[bert] bert_base ({n_params} parameters) batch {batch} x seq "
        f"{seq}, O2 bf16, AdamW, dropout 0.1, no recompute: losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(t * 1e3, 2) for t in times]}; median step (2..{n_steps}) "
        f"{med * 1e3:.2f} ms, {batch / med:.1f} sequences/s, "
        f"{batch * seq / med:.1f} tokens/s; first step {times[0] * 1e3:.1f} "
        f"ms; build {build_s:.2f} s; peak memory {peak_gb:.2f} GB; launches "
        f"{ {n: launches[n] for n in per_step} } | {smi}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bert {batch} x {seq}: loss not finite: "
                             f"{losses}")
    for name, n in per_step.items():
        if launches[name] != n_steps * n:
            raise AssertionError(f"bert {batch} x {seq}: {name} launched "
                                 f"{launches[name]} times in {n_steps} "
                                 f"steps, want {n_steps * n}")
    if profile:
        _profile_train_step(step, inputs, targets, med, smi, "bert_base")
    del step
    torch.cuda.empty_cache()
    return launches


# -- phase 9: the fusion pass --------------------------------------------------

def phase_fusion(smi):
    """The fusion pass on: card against CPU at small widths, then
    bench_gpt's headline step (gpt_345m, 8 x 1024, no recompute) and its
    pass-on vs pass-off comparison, then bert_base at 32 x 128.  Returns
    the launch counts of the GPT and the BERT runs."""
    from paddle_tpu_torch.incubate.models import bert_tiny, gpt_tiny
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        build_train_step, make_batch,
                                        make_bert_batch)
    if not fp.fusion_enabled():
        raise AssertionError("phase 9 needs the fusion pass: PT_FUSION_PASS "
                             "turns it off")
    # same weights, f32, dropout 0, pass on: the 3-step loss trajectory
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    small = (("gpt_tiny", gpt_tiny(**no_drop), build_train_step,
              lambda c, dev: make_batch(c, 4, 64, seed=1, device=dev),
              {"ln_matmul": 2, "matmul_bias_gelu": 2}),
             ("bert_tiny", bert_tiny(**no_drop), build_bert_pretrain_step,
              lambda c, dev: make_bert_batch(c, 4, 64, seed=1, device=dev),
              {"ln_matmul": 1, "matmul_bias_gelu": 3}))
    for name, cfg, build, batch, per_step in small:
        steps = {dev: build(cfg, device=dev, seed=1, amp_o2=False,
                            fusion=True) for dev in ("cpu", DEVICE)}
        steps[DEVICE].model.load_state_dict(steps["cpu"].model.state_dict())
        inputs, targets = batch(cfg, "cpu")
        reset_launch_counts()
        traj = {}
        for dev, st in steps.items():
            if isinstance(inputs, dict):
                on = ({k: v.to(dev) for k, v in inputs.items()},
                      {k: v.to(dev) for k, v in targets.items()})
            else:
                on = (inputs.to(dev), targets.to(dev))
            traj[dev] = [st(*on).item() for _ in range(3)]
        counts = {n: KERNELS[n].launches for n in BLOCK_KERNELS}
        _check_small_captured(f"fusion {name}", steps, 3)
        err = max(abs(a - b) for a, b in zip(traj["cpu"], traj[DEVICE]))
        log(f"[fusion] {name} seq 64 f32 pass on, 3-step loss, card "
            f"{traj[DEVICE]} vs CPU {traj['cpu']}: max diff {err:.3e} (tol "
            f"{TRAIN_TOL:.0e}); block kernel launches on the card {counts}")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"fusion {name}: card and CPU trajectories "
                                 f"differ by {err}")
        want = {n: 3 * c for n, c in per_step.items()}
        if counts != want:
            raise AssertionError(f"fusion {name}: launches {counts}, want "
                                 f"{want}")
        del steps

    gpt = _fused_gpt_run(smi)
    _fused_gpt_on_vs_off()
    _fused_gpt_ab(smi)
    bert = _fused_bert_run(smi)
    _fused_bert_unpadded_vocab()
    wide = _fused_gpt_wide(smi)
    return gpt, bert, wide


def phase_packed(smi):
    """``bench.py::bench_packed`` on the port: ``F.flash_attn_unpadded``
    over bench_packed's 8 packed causal sequences (16 heads of 64, bf16,
    dropout 0, ``loss = out.float().sum()``), forward and backward,
    ``PACKED_ITERS`` iterations that update q by ``dq * 1e-3``; the same
    tokens through the padded flash kernels at (8, 1024, 16, 64).  Checks
    out and dq of the two on the valid rows, and the launches (the
    counters set to 0 just before each run and read just after): rows 4-6
    once each an iteration and no row 1-3 on the packed side, the reverse
    on the padded side.  Then 2 iterations at dropout 0.1 with the run's
    generator.  Returns the packed run's launch counts."""
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.ops import pallas_ops as po
    lens, h, d = PACKED_LENS, PACKED_HEADS, PACKED_HD
    b, mx, total = len(lens), max(lens), sum(lens)
    cu = torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    qp, kp, vp = (torch.randn(total, h, d, generator=gen, device=DEVICE
                              ).to(torch.bfloat16) for _ in range(3))
    rows = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)]
                     ).to(DEVICE)
    cols = torch.cat([torch.arange(n) for n in lens]).to(DEVICE)

    def pad(x):
        buf = torch.zeros((b, mx, h, d), dtype=x.dtype, device=DEVICE)
        buf[rows, cols] = x
        return buf
    qb, kb, vb = pad(qp), pad(kp), pad(vp)
    scale = 1.0 / math.sqrt(d)

    def packed_fb(q, dropout=0.0, generator=None):
        q = q.detach().requires_grad_()
        out, _ = F.flash_attn_unpadded(q, kp, vp, cu, cu, mx, mx, scale,
                                       dropout=dropout, causal=True,
                                       generator=generator)
        loss = out.float().sum()
        return loss, out, torch.autograd.grad(loss, q)[0]

    def padded_fb(q):
        q = q.detach().requires_grad_()
        out, _ = F.flash_attention(q, kb, vb, causal=True)
        loss = out.float().sum()
        return loss, out, torch.autograd.grad(loss, q)[0]

    _, out_p, dq_p = packed_fb(qp)
    _, out_b, dq_b = padded_fb(qb)
    torch.cuda.synchronize()
    errs = {"out": _flash_err(out_p, out_b[rows, cols], "bf16", "out"),
            "dq": _flash_err(dq_p, dq_b[rows, cols], "bf16", "dq")}
    log(f"[packed] {PACKED_PATH} vs the padded ({b}, {mx}, {h}, {d}) flash "
        f"path on the valid rows: max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {FLASH_TOL['bf16']})")
    if not all(ok for _, ok in errs.values()):
        raise AssertionError(f"packed: packed and padded paths disagree on "
                             f"the valid rows: {errs}")

    def timed(fb, q0):
        """ms an iteration over PACKED_ITERS, host clock ending in a
        synchronize, and the launches of that run."""
        torch.cuda.synchronize()
        reset_launch_counts()
        q, t0 = q0, time.perf_counter()
        for _ in range(PACKED_ITERS):
            loss, _, dq = fb(q)
            q = (q.float() + dq.float() * 1e-3).to(q.dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / PACKED_ITERS * 1e3
        launches = {n: KERNELS[n].launches for n in KERNELS}
        if not math.isfinite(loss.item()):
            raise AssertionError(f"packed: loss {loss.item()}")
        return ms, launches

    ms_packed, launches = timed(packed_fb, qp)
    ms_padded, padded_launches = timed(padded_fb, qb)
    want = {n: PACKED_ITERS for n in PACKED_KERNELS}
    want.update({n: 0 for n in FLASH_KERNELS})
    got = {n: launches[n] for n in want}
    want_b = {n: PACKED_ITERS - want[n] for n in want}
    got_b = {n: padded_launches[n] for n in want}
    log(f"[packed] {PACKED_ITERS} forward+backward iterations, launches: "
        f"packed {got}, padded {got_b}")
    if got != want or got_b != want_b:
        raise AssertionError(f"packed: launches packed {got} (want {want}), "
                             f"padded {got_b} (want {want_b})")
    log(f"[packed] {smi}: packed {ms_packed:.3f} ms an iteration "
        f"({total / ms_packed * 1e3:.1f} tokens/s), padded {ms_padded:.3f} ms"
        f" ({total / ms_padded * 1e3:.1f} tokens/s); padded / packed "
        f"{ms_padded / ms_packed:.3f} (packed_varlen_speedup); {total} "
        f"tokens against {b * mx} padded")

    # the host's part the padded side lacks: cu read and checked, the hash
    # bases and tile tables built and copied to the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PACKED_ITERS):
        po.PackedLayout(cu, cu, total, total).tables(qp.device, True)
    torch.cuda.synchronize()
    log(f"[packed] PackedLayout and its tables on the card: "
        f"{(time.perf_counter() - t0) / PACKED_ITERS * 1e3:.4f} ms a call "
        f"(host clock)")
    for label, fb, q0, ms in (("packed", packed_fb, qp, ms_packed),
                              ("padded", padded_fb, qb, ms_padded)):
        busy, ops, top = _device_busy(lambda: fb(q0), 3)
        log(f"[packed] {label}: device busy {busy:.3f} ms an iteration, "
            f"{busy / ms:.3f} of its wall time {ms:.3f} ms; {ops:.0f} device "
            f"operations an iteration; most device time: {top}")
    # rows 4-6 on the wgmma kernels: each once an iteration, and no
    # mma.sync flash kernel
    calls, ms = _flash_calls(lambda: packed_fb(qp), 3)
    want_calls = {n: float(n in WG_FLASH_FWD + WG_FLASH_BWD) for n in calls}
    log(f"[packed] the packed kernels, calls an iteration: {calls}; their "
        f"device time an iteration: forward {ms['fwd']:.4f} ms, backward "
        f"{ms['bwd']:.4f} ms | {smi}")
    if calls != want_calls:
        raise AssertionError(f"packed: flash kernels {calls}, want "
                             f"{want_calls}")

    generator = make_generator(FLASH_SEED, DEVICE)
    losses = [packed_fb(qp, FLASH_DROPOUT, generator)[0].item()
              for _ in range(2)]
    log(f"[packed] dropout {FLASH_DROPOUT} with the run's generator, 2 "
        f"iterations: losses {losses}")
    if not all(math.isfinite(x) for x in losses) or losses[0] == losses[1]:
        raise AssertionError(f"packed: dropout losses {losses} (finite, "
                             f"and each iteration's mask its own)")
    return launches


def _profiled_kernels(fn, n, sessions=3):
    """The device kernels of ``n`` runs of ``fn`` under ``torch.profiler``:
    one entry a kernel name (``key``, ``count``, its device time in
    ``self_device_time_total``), for the kernels that start after a spin
    kernel that follows one more run of ``fn`` in the same session.  That
    first run is there to be left out: late in a long run a session lost
    the first run's packed forward record (phase 10: the session's raw
    events held 2 of 3 forward kernels, the first run's missing, and 3 of
    3 of every other kernel; phase 3, after phase 10 had run first, 0 of
    1; never in a fresh process).  The card is idle when a session starts.
    A session that records no device kernel after the spin kernel (or not
    the spin kernel itself) says nothing about the runs, so it is taken
    again, up to ``sessions`` times, and logged."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = [e.time_range.end for e in events if "spin_kernel" in e.name]
        kernels = {}
        for e in events:
            if spins and e.time_range.start >= spins[-1]:
                k = kernels.setdefault(e.name, types.SimpleNamespace(
                    key=e.name, count=0, self_device_time_total=0.0))
                k.count += 1
                k.self_device_time_total += e.self_device_time_total
        if kernels:
            return list(kernels.values())
        log(f"[profile] session {attempt + 1} of {sessions} recorded no "
            f"device kernel after its spin kernel; profiling the runs again")
    return []


def _flash_calls(fn, n=1, sessions=3):
    """The flash kernels that ``n`` runs of ``fn`` launch: ({name: calls
    a run} for each of ``FLASH_ROUTES``, {"fwd", "bwd": their device ms
    a run}).  The runs launch the same kernels, so a session whose count
    of some kernel is not a multiple of ``n`` lost records (see
    `_profiled_kernels`); it is taken again, up to ``sessions`` times, and
    logged."""
    from paddle_tpu_torch.serving.profile import _device_us
    fwd = WG_FLASH_FWD + MMA_FLASH_FWD
    for attempt in range(sessions):
        mine = [e for e in _profiled_kernels(fn, n)
                if any(k in e.key for k in FLASH_ROUTES)]
        counts = {k: sum(e.count for e in mine if k in e.key)
                  for k in FLASH_ROUTES}
        if all(c % n == 0 for c in counts.values()):
            break
        log(f"[profile] session {attempt + 1} of {sessions} counted "
            f"{counts} in {n} runs; profiling the runs again")
    return ({k: c / n for k, c in counts.items()},
            {side: sum(_device_us(e) for e in mine
                       if any(k in e.key for k in fwd) == (side == "fwd"))
             / n / 1e3 for side in ("fwd", "bwd")})


def _template_args(key, start):
    """The top-level template arguments of the demangled name ``key``
    whose ``<`` is at ``start``."""
    args, depth, cur = [], 0, ""
    for ch in key[start:]:
        if ch == "<":
            depth += 1
            if depth == 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth == 0:
                break
        elif ch == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
            continue
        cur += ch
    return args + [cur.strip()]


def _device_launches(kernels, n):
    """Wrapper launches a run, counted on the device: ``kernels`` (from
    :func:`_profiled_kernels`, ``n`` runs) by ``HEAD_KERNELS``, keyed as
    the counters are (``"+"``-joined where wrappers share their kernels;
    ``layer_norm_*.residual`` for the residual variants)."""
    import re
    out = {}
    for wrappers, names in HEAD_KERNELS.items():
        key = "+".join(wrappers)
        for e in kernels:
            for name in names:
                m = re.search(rf"(?<!\w){name}(?=[<(])", e.key)
                if m is None:
                    continue
                out[key] = out.get(key, 0) + e.count / n
                if wrappers[0].startswith("layer_norm") and \
                        e.key[m.end()] == "<" and \
                        _template_args(e.key, m.end())[2] == "true":
                    res = key + ".residual"
                    out[res] = out.get(res, 0) + e.count / n
    return out


def _counter_launches(counts):
    """Counter readings (``{name or name.residual: count}``) keyed as
    :func:`_device_launches` keys them, zeros left out."""
    out = {}
    for wrappers in HEAD_KERNELS:
        key = "+".join(wrappers)
        for suffix in ("", ".residual"):
            n = sum(counts.get(w + suffix, 0) for w in wrappers)
            if n:
                out[key + suffix] = n
    return out


def _check_device_launches(what, fn, n, want, sessions=4):
    """Profile ``n`` runs of ``fn`` and hold the wrapper launches that the
    device ran a run (:func:`_device_launches`) equal to ``want`` (counter
    readings a run).  A session that lost records (a serving graph's
    session loses 4-24 of the paged kernels' 1488 records now and then)
    is taken again, up to ``sessions`` in all, each logged.  Returns the
    profiled kernels."""
    want = _counter_launches(want)
    for attempt in range(sessions):
        kernels = _profiled_kernels(fn, n)
        got = {k: v for k, v in _device_launches(kernels, n).items() if v}
        if got == want:
            return kernels
        log(f"[profile] {what}: session {attempt + 1} counted {got} on the "
            f"device, the counters {want}")
    raise AssertionError(f"{what}: the device ran {got} wrapper launches a "
                         f"run, the counters say {want}")


def _device_busy(fn, n):
    """Device time of ``fn`` under ``torch.profiler``, summed over its
    kernels: (ms per call, device operations per call, the three largest
    kernels by name and ms per call)."""
    from paddle_tpu_torch.serving.profile import _device_us
    kernels = _profiled_kernels(fn, n)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(kernels, key=_device_us, reverse=True)[:3]
    return (sum(_device_us(e) for e in kernels) / n / 1e3,
            sum(e.count for e in kernels) / n,
            "; ".join(f"{e.key[:60]} {_device_us(e) / n / 1e3:.4f} ms"
                      for e in top))


def _run_steps(step, inputs, targets, n_steps, what, watch=None):
    """``n_steps`` of ``step`` with every kernel counter set to 0 just
    before and read just after: (losses, step times, launch counts,
    peak GB).  A ``TrainStep`` must be fresh, and is held to 1 capture
    and ``n_steps - 1`` replays (:func:`_check_captured`).  ``watch()``,
    if given, runs after each step, untimed."""
    from paddle_tpu_torch.ops import reset_launch_counts
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step(inputs, targets).item())   # waits for the card
        times.append(time.perf_counter() - t0)
        if watch is not None:
            watch()
    launches = _launch_counts()
    if hasattr(step, "captured"):
        _check_captured(what, step, n_steps)
    return losses, times, launches, torch.cuda.max_memory_allocated() / 1e9


def _check_captured(what, step, calls):
    """``step`` (a ``TrainStep`` called ``calls`` times since it was
    built) captured once, replayed the other calls, never fell back: the
    steps timed and counted are the graph's, not eager ones."""
    stats = step.captured.stats
    if (stats["compiles"], stats["hits"], stats["fallback"]) != (
            1, calls - 1, None):
        raise AssertionError(f"{what}: capture stats {stats} after {calls} "
                             f"calls, want 1 compile, {calls - 1} hits, no "
                             f"fallback")


def _check_small_captured(what, steps, calls):
    """The card-against-CPU pair ``steps`` ({device: TrainStep}): the
    card's captured (:func:`_check_captured`), the CPU's run as written."""
    _check_captured(f"{what} (card)", steps[DEVICE], calls)
    if steps["cpu"].captured.stats["fallback"] != "cpu":
        raise AssertionError(f"{what}: the CPU step reports "
                             f"{steps['cpu'].captured.stats}")


def _check_counts(what, launches, per_step, n_steps):
    for name, n in per_step.items():
        if launches[name] != n_steps * n:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times in {n_steps} steps, want "
                                 f"{n_steps * n}")


def _check_rewrites(what, want):
    from paddle_tpu_torch.ops import fusion_pass as fp
    got = fp.summary()
    if got["rewrites"] != want or got["traces"] != 1 or got["fallbacks"]:
        raise AssertionError(f"{what}: the pass reports {got}, want one "
                             f"trace rewriting {want}")
    return got


def _fused_gpt_run(smi):
    """bench_gpt's headline step: gpt_345m at batch 8 x 1024, recompute
    off, O2 bf16, AdamW, dropout 0.1, the fusion pass on, 8 steps on a
    fixed batch.  Checks the rewrites, the launches per step, finite and
    falling losses; returns the launch counts."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    t0 = time.perf_counter()
    step = build_train_step(cfg, device=DEVICE, seed=0, fusion=True)
    ids, labels = make_batch(cfg, FUSED_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fp.reset_stats()
    losses, times, launches, peak_gb = _run_steps(
        step, ids, labels, FUSED_STEPS, "gpt_345m fused")
    layers = cfg.num_layers
    rewrites = _check_rewrites("gpt_345m fused", {
        "ln_matmul": layers, "matmul_bias_gelu": layers,
        "layer_norm": layers, "residual_ln": 1})
    med = statistics.median(times[1:])
    tokens = FUSED_BATCH * TRAIN_SEQ
    # per step: ln1 + qkv and fc1 + gelu per block in the block kernels;
    # LayerNorm: ln2 per block and the final one (with the last block's
    # residual), the blocks' ln1 again in the LayerNorm + matmul backward,
    # one backward each; flash once per block, no recompute
    per_step = {"ln_matmul": layers, "matmul_bias_gelu": layers,
                "layer_norm_fwd": 2 * layers + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "layer_norm_fwd.residual": 1, "layer_norm_bwd.residual": 1,
                **{n: layers for n in FLASH_KERNELS}}
    log(f"[fusion] gpt_345m batch {FUSED_BATCH} x seq {TRAIN_SEQ}, O2 bf16, "
        f"AdamW, dropout 0.1, no recompute, fusion pass on ({rewrites}): "
        f"losses {[round(v, 4) for v in losses]}; step ms "
        f"{[round(t * 1e3, 2) for t in times]}; median step "
        f"(2..{FUSED_STEPS}) {med * 1e3:.2f} ms, {tokens / med:.1f} "
        f"tokens/s; first step {times[0] * 1e3:.1f} ms; build {build_s:.2f} "
        f"s; peak memory {peak_gb:.2f} GB; launches "
        f"{ {n: launches[n] for n in per_step} } | {smi}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt_345m fused: loss not finite and falling: "
                             f"{losses}")
    _check_counts("gpt_345m fused", launches, per_step, FUSED_STEPS)
    _profile_train_step(step, ids, labels, med, smi, "gpt_345m fused",
                        flash_bwd=layers)
    del step
    torch.cuda.empty_cache()
    return launches


def _fused_gpt_on_vs_off():
    """gpt_345m at 8 x 1024, no recompute, O2 bf16, dropout 0: 3 steps
    with the pass on against 3 with it off, from the same weights; the
    attention clusters are rewritten too at dropout 0.  Relative loss
    difference within ``FUSION_TOL``."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = make_batch(cfg, FUSED_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    traj, launches = {}, {}
    for fusion in (True, False):
        fp.reset_stats()
        step = build_train_step(cfg, device=DEVICE, seed=0, fusion=fusion)
        traj[fusion], _, launches[fusion], _ = _run_steps(
            step, ids, labels, FUSED_CMP_STEPS,
            f"gpt_345m dropout 0 pass {'on' if fusion else 'off'}")
        if fusion:
            layers = cfg.num_layers
            rewrites = _check_rewrites("gpt_345m fused, dropout 0", {
                "attention_block": layers, "ln_matmul": layers,
                "matmul_bias_gelu": layers, "layer_norm": layers,
                "residual_ln": 1})
        del step
        torch.cuda.empty_cache()
    err = max(abs(a - b) / abs(b) for a, b in zip(traj[True], traj[False]))
    blocks = {n: (launches[True][n], launches[False][n])
              for n in BLOCK_KERNELS + FLASH_KERNELS}
    log(f"[fusion] gpt_345m {FUSED_BATCH} x {TRAIN_SEQ} O2 bf16 dropout 0, "
        f"{FUSED_CMP_STEPS}-step loss with the pass on {traj[True]} vs off "
        f"{traj[False]}: max relative diff {err:.3e} (tol {FUSION_TOL:.0e}); "
        f"rewrites {rewrites['rewrites']}; launches on / off {blocks}")
    if not err <= FUSION_TOL:
        raise AssertionError(f"gpt_345m: the pass on and off differ by {err}")
    if any(launches[False][n] for n in BLOCK_KERNELS) or any(
            launches[True][n] != FUSED_CMP_STEPS * cfg.num_layers
            for n in BLOCK_KERNELS + FLASH_KERNELS):
        raise AssertionError(f"gpt_345m on vs off: launches {blocks}")


def _clocks():
    """The card's SM clock (MHz), power draw (W) and temperature (C)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return tuple(float(v) for v in out.split(","))


def _fused_gpt_ab(smi, turns=(True, False, False, True) * 2, turn_steps=2):
    """The headline step with the pass on and off, same weights and
    dropout draws, in alternating turns of ``turn_steps`` steps after two
    untimed steps of each: the median step of each in one call on one
    card, and the card's clock, power and temperature after each turn."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    ids, labels = make_batch(cfg, FUSED_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    steps = {fusion: build_train_step(cfg, device=DEVICE, seed=0,
                                      fusion=fusion)
             for fusion in (True, False)}
    times = {True: [], False: []}
    for fusion in (True, False):
        for _ in range(2):
            steps[fusion](ids, labels).item()
    clocks = []
    for fusion in turns:
        for _ in range(turn_steps):
            t0 = time.perf_counter()
            steps[fusion](ids, labels).item()   # waits for the card
            times[fusion].append(time.perf_counter() - t0)
        clocks.append(_clocks())
    for fusion, step in steps.items():
        _check_captured(f"gpt_345m pass {'on' if fusion else 'off'} turns",
                        step, 2 + turns.count(fusion) * turn_steps)
    med = {f: statistics.median(t) * 1e3 for f, t in times.items()}
    sm, watts, temp = (sorted(c[i] for c in clocks) for i in range(3))
    log(f"[fusion] gpt_345m {FUSED_BATCH} x {TRAIN_SEQ}, no recompute, "
        f"dropout 0.1, turns {'/'.join('on' if t else 'off' for t in turns)}"
        f" of {turn_steps} steps: median step with the pass on "
        f"{med[True]:.2f} ms ({FUSED_BATCH * TRAIN_SEQ / med[True] * 1e3:.1f}"
        f" tokens/s), off {med[False]:.2f} ms "
        f"({FUSED_BATCH * TRAIN_SEQ / med[False] * 1e3:.1f} tokens/s); on / "
        f"off {med[True] / med[False]:.3f}; step ms on "
        f"{[round(t * 1e3, 2) for t in times[True]]} off "
        f"{[round(t * 1e3, 2) for t in times[False]]}; after each turn SM "
        f"clock {sm[0]:.0f}-{sm[-1]:.0f} MHz, power {watts[0]:.0f}-"
        f"{watts[-1]:.0f} W, {temp[0]:.0f}-{temp[-1]:.0f} C | {smi}")
    del steps
    torch.cuda.empty_cache()


def _fwd_bwd_f32(step, ids, labels):
    """One forward and backward of ``step``'s model on its generator, no
    update: the logits and every parameter's gradient, in f32."""
    logits = step.model(ids, generator=step.generator)
    step.criterion(logits, labels).float().backward()
    grads = {n: p.grad.float() for n, p in step.params.items()
             if p.grad is not None}
    for p in step.params.values():
        p.grad = None
    return logits.detach().float(), grads


def _checked_calls(fk, names):
    """Replace each wrapper ``names`` of ``fk`` (rows 7-8, 11-12) by one
    that also runs its plain version on the same inputs and holds each
    output against it within its phase-3 tolerance (``LN_TOL``,
    ``BLOCK_TOL``).  Returns ``{name: [(max abs err, ok), ...]}``, one entry
    per output of each call; the caller puts the wrappers back."""
    def ln_fwd(out, want, tag):
        return [_ln_err(o, w, tag) for o, w in zip(out, want)]

    def ln_bwd(out, want, tag):
        return [_ln_err(o, w, tag, rel_to_max=i > 0)
                for i, (o, w) in enumerate(zip(out, want)) if w is not None]

    def block(out, want, tag):
        pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
        return [_block_err(o, w, tag) for o, w in pairs]

    compare = {"layer_norm_fwd": ln_fwd, "layer_norm_bwd": ln_bwd,
               "ln_matmul": block, "matmul_bias_gelu": block}
    seen = {n: [] for n in names}

    def checked(name):
        kernel = getattr(fk, name)
        reference = getattr(fk, name + "_reference")

        def fn(*args, **kw):
            out = kernel(*args, **kw)
            tag = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
            seen[name] += compare[name](out, reference(*args, **kw), tag)
            return out
        # the wrapper adds to the counters of the module name it is
        # called by: these, while it is replaced
        fn.launches = fn.residual_launches = 0
        return fn

    for n in names:
        setattr(fk, n, checked(n))
    return seen


def _rel_norm(got, want):
    """||got - want|| / ||want|| (the difference's norm where want is 0)."""
    diff = (got - want).norm().item()
    ref = want.norm().item()
    return diff / ref if ref > 0 else diff


def _fused_gpt_wide(smi):
    """gpt_1p3b at full width (hidden 2048, 16 heads of 128) and
    ``WIDE_LAYERS`` layers, batch ``WIDE_BATCH`` x ``TRAIN_SEQ``, O2 bf16,
    AdamW, dropout 0.1, no recompute, the fusion pass on: one forward and
    backward without an update (logits and every parameter's gradient kept
    in f32), then ``WIDE_STEPS`` steps: the rewrites, the launches per
    step as the model implies and finite losses.  Then the same from the
    same weights and dropout draws with rows 7-8 and 11-12 replaced by
    their plain versions on the card: the logits and each gradient within
    ``WIDE_TOL`` (relative norm), the losses within ``FUSION_TOL``.
    Returns the launch counts of the kernels' steps."""
    from paddle_tpu_torch.incubate.models import gpt_1p3b
    from paddle_tpu_torch.ops import fused_kernels as fk
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = dataclasses.replace(gpt_1p3b(use_recompute=False,
                                       max_position_embeddings=TRAIN_SEQ),
                              num_layers=WIDE_LAYERS)
    ids, labels = make_batch(cfg, WIDE_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    names = ("layer_norm_fwd", "layer_norm_bwd", "ln_matmul",
             "matmul_bias_gelu")
    kernels = {n: getattr(fk, n) for n in names}
    traj, first = {}, {}
    try:
        for mode in ("kernels", "plain"):
            for n in names:
                setattr(fk, n, kernels[n] if mode == "kernels"
                        else getattr(fk, n + "_reference"))
            fp.reset_stats()
            step = build_train_step(cfg, device=DEVICE, seed=0, fusion=True)
            if mode == "kernels":   # each call against its plain version
                calls = _checked_calls(fk, names)
            first[mode] = _fwd_bwd_f32(step, ids, labels)
            for n in names:
                setattr(fk, n, kernels[n] if mode == "kernels"
                        else getattr(fk, n + "_reference"))
            traj[mode], times, launches, peak_gb = _run_steps(
                step, ids, labels, WIDE_STEPS, f"gpt_1p3b {mode}")
            if mode == "kernels":
                counts, kernel_times, kernel_peak = launches, times, peak_gb
                rewrites = _check_rewrites("gpt_1p3b fused", {
                    "ln_matmul": WIDE_LAYERS, "matmul_bias_gelu": WIDE_LAYERS,
                    "layer_norm": WIDE_LAYERS, "residual_ln": 1})
                # where its time goes: the LayerNorm backward's share above
                # all, every call of it on the one-pass kernel
                _profile_train_step(step, ids, labels,
                                    statistics.median(times[1:]), smi,
                                    "gpt_1p3b fused")
            del step
            torch.cuda.empty_cache()
    finally:
        for n in names:
            setattr(fk, n, kernels[n])
    # per step, as _fused_gpt_run: ln1 + qkv and fc1 + gelu per block;
    # LayerNorm: ln2 per block, the final one, ln1 again in the block
    # kernel's backward; flash once per block
    per_step = {"ln_matmul": WIDE_LAYERS, "matmul_bias_gelu": WIDE_LAYERS,
                "layer_norm_fwd": 2 * WIDE_LAYERS + 1,
                "layer_norm_bwd": 2 * WIDE_LAYERS + 1,
                "layer_norm_fwd.residual": 1, "layer_norm_bwd.residual": 1,
                **{n: WIDE_LAYERS for n in FLASH_KERNELS}}
    err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernels"],
                                                  traj["plain"]))
    per_call = {n: (len(v), max(e for e, _ in v), all(ok for _, ok in v))
                for n, v in calls.items() if v}
    (lg, gr), (lg_ref, gr_ref) = first["kernels"], first["plain"]
    rel = {"logits": _rel_norm(lg, lg_ref)}
    rel.update({n: _rel_norm(gr[n], gr_ref[n]) for n in gr_ref})
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    finite = all(bool(torch.isfinite(t).all()) for t in (lg, *gr.values()))
    del first, lg, gr, lg_ref, gr_ref
    log(f"[fusion] gpt_1p3b {WIDE_LAYERS} layers (hidden 2048, 16 heads of "
        f"128), batch {WIDE_BATCH} x {TRAIN_SEQ}, O2 bf16, dropout 0.1, no "
        f"recompute, pass on ({rewrites}): first forward and backward, each "
        f"call of rows 7-8, 11-12 against its plain version on its inputs "
        f"(outputs checked, max abs err, within tolerance): {per_call}; the "
        f"same on the kernels vs plain, f32 relative norm: logits "
        f"{rel['logits']:.3e}, gradients of {len(rel) - 1} parameters, the "
        f"worst {[(n, float(f'{v:.3e}')) for n, v in worst]} (tol "
        f"{WIDE_TOL:.0e}); losses on the kernels {traj['kernels']} vs plain "
        f"{traj['plain']}: max relative diff {err:.3e} (tol "
        f"{FUSION_TOL:.0e}); step ms "
        f"{[round(t * 1e3, 2) for t in kernel_times]}; peak memory "
        f"{kernel_peak:.2f} GB; launches "
        f"{ {n: counts[n] for n in per_step} } | {smi}")
    if not finite or not all(math.isfinite(v) for v in traj["kernels"]):
        raise AssertionError(f"gpt_1p3b: logits, gradients or losses not "
                             f"finite: {traj}")
    if sorted(per_call) != sorted(names) or not all(
            ok for _, _, ok in per_call.values()):
        raise AssertionError(f"gpt_1p3b: a call of rows 7-8, 11-12 "
                             f"disagrees with its plain version on its "
                             f"inputs, or a kernel was not called: "
                             f"{per_call}")
    bad = {n: v for n, v in rel.items() if not v <= WIDE_TOL}
    if bad:
        raise AssertionError(f"gpt_1p3b: the kernels' logits or gradients "
                             f"differ from the plain versions' beyond "
                             f"{WIDE_TOL}: {bad}")
    if not err <= FUSION_TOL:
        raise AssertionError(f"gpt_1p3b: the kernels' losses differ from "
                             f"the plain versions' by {err}")
    _check_counts("gpt_1p3b fused", counts, per_step, WIDE_STEPS)
    return counts


def _fused_bert_run(smi):
    """bert_base at 32 x 128, O2 bf16, AdamW, dropout 0.1, no recompute,
    the fusion pass on, 8 steps on a fixed batch: the rewrites, the
    launches per step, finite losses, a profile; returns the launch
    counts."""
    from paddle_tpu_torch.incubate.models import bert_base
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        make_bert_batch)
    cfg = bert_base()
    step = build_bert_pretrain_step(cfg, device=DEVICE, seed=0, fusion=True)
    inputs, targets = make_bert_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0,
                                      device=DEVICE)
    fp.reset_stats()
    losses, times, launches, peak_gb = _run_steps(
        step, inputs, targets, BERT_STEPS, "bert_base fused")
    layers = cfg.num_layers
    # the embeddings' add (word + position + token type, all (B, T, H))
    # feeds only their LayerNorm, so it is absorbed as a residual, as the
    # JAX matcher absorbs it on this batch
    rewrites = _check_rewrites("bert_base fused", {
        "residual_ln": 2 * layers + 1, "matmul_bias_gelu": layers + 1,
        "ln_matmul": 1})
    med = statistics.median(times[1:])
    # per step: fc1 + gelu per block and the MLM transform; the MLM
    # LayerNorm + tied decoder; LayerNorm: two per block and the
    # embeddings', with a residual, and the MLM one again in the block
    # kernel's backward, one backward each; the MLM and NSP losses
    per_step = {"ln_matmul": 1, "matmul_bias_gelu": layers + 1,
                "layer_norm_fwd": 2 * layers + 2,
                "layer_norm_bwd": 2 * layers + 2,
                "layer_norm_fwd.residual": 2 * layers + 1,
                "layer_norm_bwd.residual": 2 * layers + 1,
                "softmax_xent_fwd": 2, "softmax_xent_bwd": 2,
                **{n: 0 for n in FLASH_KERNELS}}
    log(f"[fusion] bert_base batch {BERT_BATCH} x seq {BERT_SEQ}, O2 bf16, "
        f"AdamW, dropout 0.1, fusion pass on ({rewrites}): losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(t * 1e3, 2) for t in times]}; median step "
        f"(2..{BERT_STEPS}) {med * 1e3:.2f} ms, {BERT_BATCH / med:.1f} "
        f"sequences/s, {BERT_BATCH * BERT_SEQ / med:.1f} tokens/s; peak "
        f"memory {peak_gb:.2f} GB; launches "
        f"{ {n: launches[n] for n in per_step} } | {smi}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bert_base fused: loss not finite: {losses}")
    _check_counts("bert_base fused", launches, per_step, BERT_STEPS)
    _profile_train_step(step, inputs, targets, med, smi, "bert_base fused")
    del step
    torch.cuda.empty_cache()
    return launches


def _fused_bert_unpadded_vocab():
    """bert_base with its unpadded uncased vocabulary (30522, an output
    width off a multiple of 16 bytes for the tied decoder), 32 x 128, O2
    bf16, AdamW, dropout 0: ``BERT_VOCAB_STEPS`` steps with the fusion
    pass on (the MLM LayerNorm and the decoder through the LayerNorm +
    matmul kernel at N = 30522, the table read in place) against as many
    with it off, from the same weights; the relative loss difference
    within ``FUSION_TOL``, and the block kernels launched only with the
    pass on."""
    from paddle_tpu_torch.incubate.models import bert_base
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        make_bert_batch)
    cfg = bert_base(vocab_size=BERT_UNPADDED_VOCAB, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    inputs, targets = make_bert_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0,
                                      device=DEVICE)
    traj, launches = {}, {}
    for fusion in (True, False):
        fp.reset_stats()
        step = build_bert_pretrain_step(cfg, device=DEVICE, seed=0,
                                        fusion=fusion)
        traj[fusion], _, launches[fusion], _ = _run_steps(
            step, inputs, targets, BERT_VOCAB_STEPS,
            f"bert_base vocab {cfg.vocab_size} pass "
            f"{'on' if fusion else 'off'}")
        del step
        torch.cuda.empty_cache()
    err = max(abs(a - b) / abs(b) for a, b in zip(traj[True], traj[False]))
    blocks = {n: (launches[True][n], launches[False][n])
              for n in BLOCK_KERNELS}
    want = {"ln_matmul": BERT_VOCAB_STEPS,
            "matmul_bias_gelu": BERT_VOCAB_STEPS * (cfg.num_layers + 1)}
    log(f"[fusion] bert_base vocab {cfg.vocab_size} batch {BERT_BATCH} x seq "
        f"{BERT_SEQ}, O2 bf16, dropout 0, {BERT_VOCAB_STEPS}-step loss with "
        f"the pass on {traj[True]} vs off {traj[False]}: max relative diff "
        f"{err:.3e} (tol {FUSION_TOL:.0e}); launches on / off {blocks}")
    if not (all(math.isfinite(v) for v in traj[True]) and err <= FUSION_TOL):
        raise AssertionError(f"bert_base vocab {cfg.vocab_size}: the pass on "
                             f"and off differ by {err}")
    if any(launches[False][n] for n in BLOCK_KERNELS) or any(
            launches[True][n] != c for n, c in want.items()):
        raise AssertionError(f"bert_base vocab {cfg.vocab_size}: launches "
                             f"{blocks}, want {want} with the pass on")


# -- phase 11: the captured step ------------------------------------------------

def _bits(t):
    """``t``'s bits as integers of its width (bit-for-bit comparison)."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(width[t.element_size()])


def _step_state(step):
    """Every tensor of a training step's state by name: parameters,
    master weights, optimizer slots, the step count."""
    out = {f"param {n}": p for n, p in step.params.items()}
    out.update({f"master {n}": t for n, t in step.state["master"].items()})
    for slot, d in step.state["slots"].items():
        out.update({f"{slot} {n}": t for n, t in d.items()})
    out["step"] = step.state["step"]
    return out


def _state_digest(state):
    """A sha256 over each tensor's bit sum (int64), in name order."""
    import hashlib
    sums = torch.stack([_bits(state[n]).sum(dtype=torch.int64)
                        for n in sorted(state)]).cpu().numpy()
    return hashlib.sha256(sums.tobytes()).hexdigest()[:16]


def _capture_turns(fns, turns=CAPTURE_TURNS, turn_steps=CAPTURE_TURN_STEPS):
    """Step wall times of the steps ``fns`` ({way: callable}) in
    ``turns`` (a b b a), each step ending in the loss read on the host."""
    times = {way: [] for way in fns}
    for way in turns:
        for _ in range(turn_steps):
            t0 = time.perf_counter()
            fns[way]().item()
            times[way].append(time.perf_counter() - t0)
    return times


def _differ(want, got):
    """The names of the state tensors whose bits differ."""
    return [n for n in want if not torch.equal(_bits(want[n]), _bits(got[n]))]


def _planted_fault(make, want):
    """What the bit comparison must catch: ``CAPTURE_STEPS`` eager steps
    from the same weights and generator as the eager run whose state is
    ``want``, with ``PLANTED``'s gradient dropped at the middle step.
    Returns the tensors whose bits then differ from ``want``."""
    step, inputs, targets = make()
    names = [n for n in step.params if PLANTED in n]
    for i in range(CAPTURE_STEPS):
        hooks = ([step.params[n].register_hook(torch.zeros_like)
                  for n in names] if i == CAPTURE_STEPS // 2 else [])
        step.eager(inputs, targets)
        for h in hooks:
            h.remove()
    got = _step_state(step)
    del step
    return _differ(want, got)


def _capture_path(smi, label, make, per_step, want_kernels):
    """One training path eager and captured: ``make()`` builds the step
    and its batch (the same weights and generator state each call).
    ``CAPTURE_STEPS`` eager steps (``step.eager``) and as many captured
    ones (``step(...)``: a warm-up that captures, then replays) must give
    the same losses, parameters, masters, slots, step count and generator
    offset, bit for bit (on a path with ``PLANTED``, a planted fault must
    fail that comparison); the capture 1 compile, 7 hits, no fallback;
    the launches per step ``per_step`` on both.  The launches that the
    graph adds at each replay must be the eager step's, and a profile
    must count them on the device, eager and replayed
    (:func:`_check_device_launches`); the replay must name the kernels
    ``want_kernels`` (labels of ``PROFILE_KERNELS``).  Then both in turns
    (a b b a) for the step wall times, and each profiled for its device
    busy time.  Returns the captured run's launch counts."""
    from paddle_tpu_torch.serving.profile import _device_us
    eager, inputs, targets = make()
    graph, _, _ = make()
    runs = {}
    for way, step in (("eager", eager.eager), ("graph", graph)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[way] = _run_steps(step, inputs, targets, CAPTURE_STEPS,
                               f"capture {label}")
    (le, te, ne, pe), (lg, tg, ng, pg) = runs["eager"], runs["graph"]
    stats = dict(graph.captured.stats)
    se, sg = _step_state(eager), _step_state(graph)
    differ = _differ(se, sg)
    planted = (_planted_fault(make, se)
               if any(PLANTED in n for n in eager.params) else None)
    offsets = (eager.generator.get_offset(), graph.generator.get_offset())
    # the graph's launches a replay: the counters it adds, held to the
    # eager step's and to what the device runs
    per_eager = {k: v / CAPTURE_STEPS for k, v in ne.items()}
    (entry,) = graph.captured.graphs
    recorded = {n if a == "launches" else f"{n}.residual": c
                for (n, a), c in entry.launches.items()}
    if _counter_launches(recorded) != _counter_launches(per_eager):
        raise AssertionError(f"capture {label}: the graph adds launches "
                             f"{_counter_launches(recorded)} a replay, the "
                             f"eager step runs {_counter_launches(per_eager)}")
    times = _capture_turns({"eager": lambda: eager.eager(inputs, targets),
                            "graph": lambda: graph(inputs, targets)})
    med = {w: statistics.median(t) * 1e3 for w, t in times.items()}
    busy, names = {}, {}
    for way, fn, want in (
            ("eager", lambda: eager.eager(inputs, targets), per_eager),
            ("graph", lambda: graph(inputs, targets), recorded)):
        kernels = _check_device_launches(f"capture {label} {way}", fn, 2,
                                         want)
        busy[way] = sum(_device_us(e) for e in kernels) / 2 / 1e3
        names[way] = [lab for lab, ks in PROFILE_KERNELS.items()
                      if any(k in e.key for e in kernels for k in ks)]
    log(f"[capture] {label}: {CAPTURE_STEPS} steps eager / captured from the "
        f"same weights: losses {le} / {lg}; state digest "
        f"{_state_digest(se)} / {_state_digest(sg)}, tensors that differ "
        f"{differ[:4]} of {len(se)}; "
        + ("" if planted is None else
           f"with {PLANTED}'s gradient dropped at step "
           f"{CAPTURE_STEPS // 2 + 1} (planted), {len(planted)} tensors "
           f"differ ({planted[:4]}); ")
        + f"generator offset {offsets[0]} / "
        f"{offsets[1]}; capture {stats} in {graph.captured.capture_seconds:.3f}"
        f" s, first captured step {tg[0] * 1e3:.1f} ms (eager {te[0] * 1e3:.1f}"
        f"); peak memory {pe:.2f} / {pg:.2f} GB; turns "
        f"{'/'.join(CAPTURE_TURNS)} of {CAPTURE_TURN_STEPS}: median step eager "
        f"{med['eager']:.2f} ms, graph {med['graph']:.2f} ms (graph / eager "
        f"{med['graph'] / med['eager']:.3f}); step ms eager "
        f"{[round(t * 1e3, 2) for t in times['eager']]} graph "
        f"{[round(t * 1e3, 2) for t in times['graph']]}; device busy a step "
        f"eager {busy['eager']:.3f} ms ({busy['eager'] / med['eager']:.3f} of "
        f"its median), graph {busy['graph']:.3f} ms ({busy['graph'] / med['graph']:.3f}"
        f"); kernels in the profiled replay {names['graph']}; launches a "
        f"replay, counted on the device {_counter_launches(recorded)}; "
        f"launches {ne == ng} eager == graph { {n: ng[n] for n in per_step} }"
        f" | {smi}")
    if le != lg or differ or offsets[0] != offsets[1]:
        raise AssertionError(f"capture {label}: the captured step is not the "
                             f"eager one bit for bit: losses {le} / {lg}, "
                             f"tensors {differ[:8]}, offsets {offsets}")
    if planted is not None and not planted:
        raise AssertionError(f"capture {label}: the bit comparison misses a "
                             f"dropped gradient of {PLANTED}")
    _check_counts(f"capture {label} eager", ne, per_step, CAPTURE_STEPS)
    _check_counts(f"capture {label} graph", ng, per_step, CAPTURE_STEPS)
    missing = [k for k in want_kernels if k not in names["graph"]]
    if missing:
        raise AssertionError(f"capture {label}: the profiled replay names no "
                             f"{missing} kernel: {names['graph']}")
    del eager, graph
    torch.cuda.empty_cache()
    return ng


def _embedding_runs(smi):
    """``F.embedding``'s backward (the port's: a fixed summation order)
    8 times on the same inputs at BERT's token-type (2 rows), position
    (512) and word-embedding (30528) shapes over a ``make_bert_batch``
    batch, and at GPT's word-embedding shape (50304 x 1024, bench_gpt's 8
    x 1024 ids), bf16 and f32: the same bits every run, or the phase
    fails.  Beside it the library's ``torch.nn.functional.embedding``: its
    8 runs (the same bits or not, logged), its gradient's largest
    difference from the port's (within ``EMBED_TOL`` of the largest
    value: another summation order), and both backward times
    (``Timer``)."""
    from paddle_tpu_torch.incubate.models import bert_base, gpt_345m
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.train import make_batch, make_bert_batch
    timer = Timer()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    bert = bert_base()
    inputs, _ = make_bert_batch(bert, BERT_BATCH, BERT_SEQ, seed=0,
                                device=DEVICE)
    positions = torch.arange(BERT_SEQ, device=DEVICE).expand(
        BERT_BATCH, BERT_SEQ).contiguous()
    gpt_ids, _ = make_batch(gpt_345m(), FUSED_BATCH, TRAIN_SEQ, seed=0,
                            device=DEVICE)
    shapes = (("BERT token types", 2, BERT_HIDDEN, inputs["token_type_ids"]),
              ("BERT positions", bert.max_position_embeddings, BERT_HIDDEN,
               positions),
              ("BERT words", BERT_VOCAB, BERT_HIDDEN, inputs["input_ids"]),
              ("GPT words", GPT_345M["vocab_size"], GPT_345M["hidden"],
               gpt_ids))
    out, varies = [], []
    for label, rows, d, ids in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            w = torch.randn(rows, d, generator=gen, device=DEVICE
                            ).to(dtype).requires_grad_(True)
            g = torch.randn(*ids.shape, d, generator=gen,
                            device=DEVICE).to(dtype)
            got = {}
            for way, fn in (("port", F.embedding),
                            ("library", torch.nn.functional.embedding)):
                runs = []
                for _ in range(8):
                    w.grad = None
                    fn(ids, w).backward(g)
                    runs.append(w.grad)
                same = all(torch.equal(_bits(r), _bits(runs[0]))
                           for r in runs)
                y = fn(ids, w)
                ms = timer(lambda: torch.autograd.grad(y, w, g,
                                                       retain_graph=True))
                got[way] = (same, ms, runs[0].float())
            ref = got["library"][2].abs().max().item()
            diff = (got["port"][2] - got["library"][2]).abs().max().item()
            tag = f"{label} ({rows}, {d}) {str(dtype)[6:]}"
            out.append(f"{tag}: port 8 runs "
                       f"{'the same bits' if got['port'][0] else 'DIFFER'} "
                       f"{got['port'][1]:.4f} ms, library "
                       f"{'the same bits' if got['library'][0] else 'differ'}"
                       f" {got['library'][1]:.4f} ms, max |port - library| "
                       f"{diff:.3e} (max |g| {ref:.3e})")
            if not got["port"][0] or diff > EMBED_TOL[dtype] * ref:
                varies.append(tag)
            w.grad = None
    log(f"[capture] F.embedding's backward (the port's, one fixed summation "
        f"order) against the library's, 8 eager runs each on the same "
        f"inputs, backward ms (Timer): {'; '.join(out)} | {smi}")
    if varies:
        raise AssertionError(f"capture: F.embedding's backward is not the "
                             f"same bits over 8 runs, or not the library's "
                             f"gradient, at {varies}")
    del timer
    torch.cuda.empty_cache()


def _capture_unsafe():
    """A step that reads a value on the host cannot be captured: its
    capture falls back (``capture_unsafe``) and it runs eagerly, giving
    what the eager step gives."""
    from paddle_tpu_torch.jit import capture_step
    lin = torch.nn.Linear(64, 64, device=DEVICE)
    x = torch.randn(8, 64, device=DEVICE)

    def fn(x):
        y = lin(x).square().mean()
        return y * 2 if y.item() > 0 else y

    step = capture_step(fn)
    got = [step(x).item() for _ in range(3)]
    want = fn(x).item()
    log(f"[capture] a step reading its loss on the host: {step.stats}, "
        f"values {got} (eager {want})")
    if step.stats["fallback"] != "capture_unsafe" or step.stats["compiles"] \
            or got != [want] * 3:
        raise AssertionError(f"capture: the unsafe step did not fall back "
                             f"cleanly: {step.stats}, {got} vs {want}")


def _uncaptured_engine(*args, **kw):
    """A ``ServingEngine`` built with ``PT_CAPTURE=0``: no graphs, each
    bucket's step run eagerly (``decode_step``, ``prefill_step``)."""
    import os
    from paddle_tpu_torch.serving import ServingEngine
    old = os.environ.get("PT_CAPTURE")
    os.environ["PT_CAPTURE"] = "0"
    try:
        return ServingEngine(*args, **kw)
    finally:
        if old is None:
            del os.environ["PT_CAPTURE"]
        else:
            os.environ["PT_CAPTURE"] = old


def _capture_serve(smi):
    """The serving engine's graphs (one a prefill and a decode bucket) at
    fp32, bf16 and int8 over phase 5's requests: in turns (a b b a) with
    an engine on the same weights whose buckets run eagerly
    (:func:`_uncaptured_engine`), the tokens and the launch counts
    identical, and the graph engine's launches counted on the device
    (:func:`_check_device_launches`); 4 prompts alone through the graphs
    equal to their tokens in the batch (fp32 and int8; bf16's contract is
    one bucket's, phase 5); then both engines' weights swapped (seed 1):
    the graphs' next tokens those of the new weights run eagerly, and
    changed.  Decode tokens/s, median decode step and peak memory above
    the engines' own of each way.  Returns the graph turns' launch counts
    summed over the precisions."""
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine, init_params)
    spec = ModelSpec(**GPT_345M)
    prompts = _serve_prompts(spec.vocab_size)
    params = init_params(spec, seed=0, device=DEVICE)
    swapped = init_params(spec, seed=1, device=DEVICE)
    total = {name: 0 for name in KERNELS}
    for prec in ("fp32", "bf16", "int8"):
        cfg = ServeConfig(decode_buckets=(2, 4, 8, 16),
                          prefill_buckets=(64, 128, 256, 512),
                          kv_pages=1024, page_size=PAGE_SIZE,
                          max_inflight=64, max_new_tokens=32,
                          precision=prec)
        engines, held_gb, build_s = {}, {}, {}
        for way, build in (("graph", ServingEngine),
                           ("eager", _uncaptured_engine)):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            engines[way] = build(spec, params, cfg, device=DEVICE)
            torch.cuda.synchronize()
            build_s[way] = time.perf_counter() - t0
            held_gb[way] = (torch.cuda.memory_allocated() - mem0) / 1e9
        engine = engines["graph"]
        n_buckets = len(cfg.prefill_buckets) + len(cfg.decode_buckets)
        n_graphs = len(engine._graphs)
        if (n_graphs, len(engines["eager"]._graphs)) != (n_buckets, 0) or \
                engine.compiled_programs != n_buckets:
            raise AssertionError(f"capture serve {prec}: {n_graphs} graphs "
                                 f"({engine.compiled_programs} programs), "
                                 f"want one a bucket, {n_buckets}, and none "
                                 f"in the uncaptured engine")
        outs, rows = {}, {}
        for turn, way in enumerate(CAPTURE_TURNS):
            eng = engines[way]
            eng.scheduler._step_times.clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            outs[turn] = eng.generate(prompts, max_new_tokens=32)
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in KERNELS.items()}
            step_times = list(eng.scheduler._step_times)
            tokens = sum(len(o) - 1 for o in outs[turn])
            rows.setdefault(way, []).append(
                (tokens / sum(step_times), statistics.median(step_times) * 1e3,
                 (torch.cuda.max_memory_allocated() - base) / 1e9, counts))
        first = outs[0]
        same = all(o == first for o in outs.values())
        launches_same = all(r[3] == rows["eager"][0][3]
                            for way in rows for r in rows[way])
        _check_device_launches(
            f"capture serve {prec} graph",
            lambda: engine.generate(prompts, max_new_tokens=32), 1,
            rows["graph"][0][3])
        solo = [engine.generate([p], max_new_tokens=32)[0]
                for p in prompts[:4]]
        # the swap: the graphs read the served tensors, written in place
        before = engine.generate(prompts[:4], max_new_tokens=8)
        for eng in engines.values():
            eng.install_weights(swapped, step=1)
        after = engine.generate(prompts[:4], max_new_tokens=8)
        after_eager = engines["eager"].generate(prompts[:4], max_new_tokens=8)
        for eng in engines.values():
            eng.close()
        for name in KERNELS:
            total[name] += sum(r[3][name] for r in rows["graph"])

        def fmt(way):
            return ", ".join(f"{tps:.1f} tok/s median step {ms:.2f} ms peak "
                             f"{gb:.2f} GB" for tps, ms, gb, _ in rows[way])
        log(f"[capture] serve {prec}: {n_graphs} graphs captured in "
            f"{engine.capture_seconds:.3f} s (engine build {build_s['graph']:.2f}"
            f" s, uncaptured {build_s['eager']:.2f} s; held after the build: "
            f"{held_gb['graph']:.2f} GB with the graphs, {held_gb['eager']:.2f}"
            f" GB without: weights, pools, graphs); turns "
            f"{'/'.join(CAPTURE_TURNS)}, peak above what is held: eager "
            f"{fmt('eager')}; graph {fmt('graph')}; tokens identical across "
            f"turns {same}; launches alike {launches_same} "
            f"{rows['graph'][0][3]}, counted on the device; 4 alone == in "
            f"batch {solo == first[:4]}; weight swap: graph == eager on the "
            f"new weights {after == after_eager}, changed {after != before} | "
            f"{smi}")
        if not same or not launches_same:
            raise AssertionError(f"capture serve {prec}: the graphs' tokens "
                                 f"or launches differ from the eager steps'")
        # bf16's contract covers one bucket (phase 5 checks it within
        # bucket 16): across buckets 2 and 16 its rows may differ
        if solo != first[:4] and prec != "bf16":
            raise AssertionError(f"capture serve {prec}: join/leave fails "
                                 f"under the graphs")
        if after != after_eager or after == before:
            raise AssertionError(f"capture serve {prec}: the weight swap did "
                                 f"not reach the graphs")
        del engine, engines, eng
        torch.cuda.empty_cache()
    return total


def _bert_per_step(bert, fusion):
    """The kernel launches of one bert_base step, the fusion pass on or
    off."""
    layers = bert.num_layers
    return {"layer_norm_fwd": 2 * layers + 2,
            "layer_norm_bwd": 2 * layers + 2,
            "softmax_xent_fwd": 2, "softmax_xent_bwd": 2,
            **{n: 0 for n in FLASH_KERNELS},
            **({"ln_matmul": 1, "matmul_bias_gelu": layers + 1,
                "layer_norm_fwd.residual": 2 * layers + 1,
                "layer_norm_bwd.residual": 2 * layers + 1} if fusion else {
                "layer_norm_fwd.residual": 2 * layers,
                "layer_norm_bwd.residual": 2 * layers})}


def _headline_per_step(gpt):
    """The kernel launches of one step of bench_gpt's headline step (no
    recompute, the fusion pass on) at ``gpt``'s depth."""
    layers = gpt.num_layers
    return {"ln_matmul": layers, "matmul_bias_gelu": layers,
            "layer_norm_fwd": 2 * layers + 1,
            "layer_norm_bwd": 2 * layers + 1,
            "layer_norm_fwd.residual": 1, "layer_norm_bwd.residual": 1,
            **{n: layers for n in FLASH_KERNELS}}


def _recompute_per_step(gpt):
    """The kernel launches of one GPT step with recompute (the fusion
    pass leaves a recomputed block as it is): the backward reruns each
    block's forward, its two LayerNorms and its attention."""
    layers = gpt.num_layers
    return {"ln_matmul": 0, "matmul_bias_gelu": 0,
            "layer_norm_fwd": 4 * layers + 1,
            "layer_norm_bwd": 2 * layers + 1,
            "layer_norm_fwd.residual": 0, "layer_norm_bwd.residual": 0,
            "flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}


def phase_capture(smi):
    """The captured step (``paddle_tpu_torch.jit.capture``): bert_base 32
    x 128 (pass off and on), bench_gpt's headline step (gpt_345m 8 x 1024,
    no recompute, pass on) and the recompute step (16 x 1024, pass off),
    each eager against captured (:func:`_capture_path`); a step that
    cannot be captured falls back; the serving engine's graphs
    (:func:`_capture_serve`).  Returns {path: launch counts}."""
    from paddle_tpu_torch.incubate.models import bert_base, gpt_345m
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        build_train_step, make_batch,
                                        make_bert_batch)
    bert = bert_base()
    t0 = time.perf_counter()
    _embedding_runs(smi)
    log(f"[time] capture embedding runs {time.perf_counter() - t0:.1f} s")
    out = {}
    for fusion in (False, True):
        label = f"bert_base {BERT_BATCH}x{BERT_SEQ} pass {'on' if fusion else 'off'}"

        def make(fusion=fusion):
            step = build_bert_pretrain_step(bert, device=DEVICE, seed=0,
                                            fusion=fusion)
            return (step, *make_bert_batch(bert, BERT_BATCH, BERT_SEQ, seed=0,
                                           device=DEVICE))
        want = ["LayerNorm forward", "LayerNorm backward", "cross-entropy"]
        if fusion:
            want += ["LayerNorm + matmul", "matmul + bias + gelu"]
        out[label] = _capture_path(smi, label, make,
                                   _bert_per_step(bert, fusion), want)

    gpt = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    layers = gpt.num_layers

    def make_headline():
        step = build_train_step(gpt, device=DEVICE, seed=0, fusion=True)
        return (step, *make_batch(gpt, FUSED_BATCH, TRAIN_SEQ, seed=0,
                                  device=DEVICE))
    label = f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} fused"
    out[label] = _capture_path(
        smi, label, make_headline, _headline_per_step(gpt),
        ["LayerNorm forward", "LayerNorm backward", "flash forward",
         "flash backward", "LayerNorm + matmul", "matmul + bias + gelu"])

    rec = gpt_345m(use_recompute=True, max_position_embeddings=TRAIN_SEQ)

    def make_recompute():
        step = build_train_step(rec, device=DEVICE, seed=0, fusion=False)
        return (step, *make_batch(rec, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                  device=DEVICE))
    label = f"gpt_345m {TRAIN_BATCH}x{TRAIN_SEQ} recompute"
    out[label] = _capture_path(
        smi, label, make_recompute,
        {"layer_norm_fwd": 4 * layers + 1, "layer_norm_bwd": 2 * layers + 1,
         "flash_fwd": 2 * layers, "flash_bwd_dq": layers,
         "flash_bwd_dkv": layers},
        ["LayerNorm forward", "LayerNorm backward", "flash forward",
         "flash backward"])
    _capture_unsafe()
    out["serve"] = _capture_serve(smi)
    return out


# -- phase 12: schedules, clipping and the optimizer family -------------------

def _gpt_optimizer():
    """Megatron GPT's schedule: linear warm-up over 4 steps, then cosine
    decay over ``SCHEDULE_STEPS``; a global-norm clip of 1.0; AdamW."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4,
                                                    T_max=SCHEDULE_STEPS),
                            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
    return AdamW(sched, grad_clip=ClipGradByGlobalNorm(1.0))


def _bert_optimizer():
    """BERT's schedule: linear warm-up over 4 steps, then linear decay to
    0 over ``SCHEDULE_STEPS``; a global-norm clip of 1.0; AdamW."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.PolynomialDecay(1e-4,
                                               decay_steps=SCHEDULE_STEPS,
                                               end_lr=0.0, power=1.0),
                            4, 0.0, 1e-4)
    return AdamW(sched, grad_clip=ClipGradByGlobalNorm(1.0))


def _sweep_optimizers():
    """Every other optimizer, each under a StepDecay or ExponentialDecay
    schedule, the per-tensor clips and the L1 / L2 decays in turn."""
    from paddle_tpu_torch.nn import ClipGradByNorm, ClipGradByValue
    from paddle_tpu_torch.optimizer import (SGD, Adadelta, Adagrad, Adam,
                                            Adamax, Lamb, Momentum, NAdam,
                                            RAdam, RMSProp, lr)
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay
    return {
        "SGD": lambda: SGD(lr.StepDecay(1e-2, step_size=2),
                           grad_clip=ClipGradByNorm(1.0),
                           weight_decay=L2Decay(0.01)),
        "Momentum (Nesterov)": lambda: Momentum(
            lr.ExponentialDecay(1e-2, gamma=0.9), use_nesterov=True,
            grad_clip=ClipGradByValue(1.0), weight_decay=L1Decay(1e-4)),
        "Adagrad": lambda: Adagrad(lr.StepDecay(1e-2, step_size=2),
                                   initial_accumulator_value=0.1,
                                   grad_clip=ClipGradByNorm(1.0)),
        "Adadelta": lambda: Adadelta(lr.ExponentialDecay(1.0, gamma=0.9),
                                     grad_clip=ClipGradByValue(1.0),
                                     weight_decay=L2Decay(0.01)),
        "RMSProp (centered, momentum 0.9)": lambda: RMSProp(
            lr.StepDecay(1e-4, step_size=2), centered=True, momentum=0.9,
            grad_clip=ClipGradByNorm(1.0), weight_decay=L1Decay(1e-4)),
        "Adam (amsgrad)": lambda: Adam(
            lr.ExponentialDecay(1e-4, gamma=0.9), amsgrad=True,
            grad_clip=ClipGradByValue(1.0), weight_decay=L2Decay(0.01)),
        "Adamax": lambda: Adamax(lr.StepDecay(1e-4, step_size=2),
                                 grad_clip=ClipGradByNorm(1.0),
                                 weight_decay=L1Decay(1e-4)),
        "Lamb": lambda: Lamb(lr.ExponentialDecay(1e-4, gamma=0.9),
                             grad_clip=ClipGradByValue(1.0)),
        "NAdam": lambda: NAdam(lr.StepDecay(1e-4, step_size=2),
                               grad_clip=ClipGradByNorm(1.0),
                               weight_decay=L2Decay(0.01)),
        "RAdam": lambda: RAdam(lr.ExponentialDecay(1e-4, gamma=0.9),
                               grad_clip=ClipGradByValue(1.0),
                               weight_decay=L1Decay(1e-4)),
    }


def _free_steps():
    """Give the card back the memory of the training steps just dropped: a
    step whose model the fusion pass traced sits in reference cycles
    (the traced graph and its module), so its parameters and its graph's
    memory pool wait for a collection."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] after freeing the steps: allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")


def _scheduled_run(step, inputs, targets, n_steps, what, eager):
    """``n_steps`` of the ``TrainStep`` ``step`` under its optimizer's
    schedule: captured (``step(...)``, which writes the learning rate
    before each call) or, with ``eager``, ``step.eager`` after an explicit
    ``write_lr()``.  After each step (untimed) the learning-rate tensor
    is read back beside ``np.float32`` of the host schedule's value, then
    the schedule steps.  Returns :func:`_run_steps`' tuple and the
    (read, host) pairs."""
    opt = step.optimizer
    sched = opt._learning_rate_scheduler
    lrs = []

    def watch():
        lrs.append((opt.lr_tensor.item(), float(np.float32(opt.get_lr()))))
        sched.step()

    def run_eager(i, t):
        opt.write_lr()
        return step.eager(i, t)
    return (*_run_steps(run_eager if eager else step, inputs, targets,
                        n_steps, what, watch=watch), lrs)


def _schedule_path(smi, label, make, make_plain, per_step, planted):
    """One scheduled, clipped training path, eager against captured:
    ``make()`` builds the step with its schedule and batch (the same
    weights, generator and schedule each call).  ``SCHEDULE_STEPS`` eager
    and as many captured steps (:func:`_scheduled_run`) must give the
    same losses, parameters, masters, slots, step count and generator
    offset bit for bit, the learning-rate tensor ``np.float32`` of the
    schedule's value at every step on both, 1 compile and ``n - 1`` hits
    with no fallback, the launches ``per_step``.  With ``planted``, a
    captured run whose learning-rate tensor is never written (the graph
    called directly) must differ from eager.  Then eager, the captured
    step and ``make_plain()``'s (phase 11's step: constant rate, no clip)
    in turns, each profiled for its device busy time.  Returns the
    captured run's launch counts."""
    eager, inputs, targets = make()
    graph, _, _ = make()
    runs = {}
    for way, step in (("eager", eager), ("graph", graph)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[way] = _scheduled_run(step, inputs, targets, SCHEDULE_STEPS,
                                   f"schedule {label}", way == "eager")
    (le, te, ne, pe, re), (lg, tg, ng, pg, rg) = runs["eager"], runs["graph"]
    se, sg = _step_state(eager), _step_state(graph)
    differ = _differ(se, sg)
    digests = (_state_digest(se), _state_digest(sg), len(se))
    offsets = (eager.generator.get_offset(), graph.generator.get_offset())
    lr_off = [(i, a, b) for i, (a, b) in enumerate(re + rg) if a != b]
    stuck = None
    if planted:
        bad, _, _ = make()
        sched = bad.optimizer._learning_rate_scheduler
        for _ in range(SCHEDULE_STEPS):
            bad.captured(inputs, targets)     # no write_lr: a stale rate
            sched.step()
        stuck = (bad.optimizer.lr_tensor.item(),
                 _differ(se, _step_state(bad)))
        del bad
    fns = {"eager": lambda: (eager.optimizer.write_lr(),
                             eager.eager(inputs, targets))[1],
           "graph": lambda: graph(inputs, targets)}
    times = _capture_turns(fns)
    busy = {w: _device_busy(fn, 2) for w, fn in fns.items()}
    # then the schedule-free step beside the graph, the eager copy freed
    # (three copies of gpt_345m with two graph pools do not fit)
    del eager, fns
    _free_steps()
    plain, _, _ = make_plain()
    plain(inputs, targets)                    # its warm-up and capture
    fns = {"graph": lambda: graph(inputs, targets),
           "plain": lambda: plain(inputs, targets)}
    turns = ("graph", "plain", "plain", "graph")
    pair = _capture_turns(fns, turns)
    times.update(graph2=pair["graph"], plain=pair["plain"])
    med = {w: statistics.median(t) * 1e3 for w, t in times.items()}
    busy["plain"] = _device_busy(fns["plain"], 2)
    stats = dict(graph.captured.stats)
    pstats = dict(plain.captured.stats)
    opt = graph.optimizer
    log(f"[schedule] {label}: {SCHEDULE_STEPS} steps eager / captured from "
        f"the same weights under {type(opt).__name__}("
        f"{type(opt._learning_rate).__name__}("
        f"{type(opt._learning_rate.lr_sched).__name__}), "
        f"{type(opt._grad_clip).__name__}(1.0)): losses {le} / "
        f"{lg}; learning rate read from its tensor {[a for a, _ in rg]}, "
        f"steps off np.float32 of the schedule {lr_off[:4]}; state digest "
        f"{digests[0]} / {digests[1]}, tensors that differ "
        f"{differ[:4]} of {digests[2]}; generator offset {offsets[0]} / "
        f"{offsets[1]}; capture {stats} in "
        f"{graph.captured.capture_seconds:.3f} s; "
        + ("" if stuck is None else
           f"the graph replayed without writing the rate (planted): rate "
           f"{stuck[0]}, {len(stuck[1])} tensors differ from eager "
           f"({stuck[1][:3]}); ")
        + f"peak memory {pe:.2f} / {pg:.2f} GB; turns "
        f"{'/'.join(CAPTURE_TURNS)}, then {'/'.join(turns)}, of "
        f"{CAPTURE_TURN_STEPS}: median step eager {med['eager']:.2f} ms, "
        f"graph {med['graph']:.2f} ms; then graph {med['graph2']:.2f} ms, "
        f"schedule-free graph (phase 11's step, {pstats['compiles']} "
        f"compile) {med['plain']:.2f} ms (graph - schedule-free "
        f"{med['graph2'] - med['plain']:+.2f} ms); step ms graph "
        f"{[round(t * 1e3, 2) for t in times['graph2']]} schedule-free "
        f"{[round(t * 1e3, 2) for t in times['plain']]}; device "
        f"busy a step eager {busy['eager'][0]:.3f} ms ("
        f"{busy['eager'][0] / med['eager']:.3f} of its median), graph "
        f"{busy['graph'][0]:.3f} ms ({busy['graph'][0] / med['graph']:.3f}), "
        f"schedule-free {busy['plain'][0]:.3f} ms "
        f"({busy['plain'][0] / med['plain']:.3f}); device operations a step "
        f"graph {busy['graph'][1]:.0f}, schedule-free {busy['plain'][1]:.0f}"
        f"; launches {ne == ng} eager == graph | {smi}")
    if (le != lg or differ or offsets[0] != offsets[1] or lr_off
            or not all(math.isfinite(x) for x in le)):
        raise AssertionError(f"schedule {label}: the captured step is not "
                             f"the eager one bit for bit: losses {le} / "
                             f"{lg}, tensors {differ[:8]}, offsets "
                             f"{offsets}, learning rates off {lr_off[:4]}")
    if stats["compiles"] != 1 or stats["fallback"] is not None or \
            pstats["compiles"] != 1 or pstats["fallback"] is not None:
        raise AssertionError(f"schedule {label}: after the turns the "
                             f"capture reports {stats}, the schedule-free "
                             f"step {pstats}: want 1 compile, no fallback")
    if stuck is not None and not stuck[1]:
        raise AssertionError(f"schedule {label}: a replay that never wrote "
                             f"its learning rate gave the eager bits")
    _check_counts(f"schedule {label} eager", ne, per_step, SCHEDULE_STEPS)
    _check_counts(f"schedule {label} graph", ng, per_step, SCHEDULE_STEPS)
    del graph, plain, fns
    _free_steps()
    return ng


def _optimizer_sweep(smi):
    """Every optimizer of :func:`_sweep_optimizers` on bench_gpt's
    headline step cut to ``SWEEP_LAYERS`` layers (gpt_345m's widths, 8 x
    1024, the fusion pass on, O2 bf16), ``SWEEP_STEPS`` steps eager and
    as many captured from the same weights: losses finite and every
    state tensor the same bits, the learning-rate tensor the schedule's
    value, 1 compile and ``n - 1`` hits, the launches of the headline
    step at that depth.  Returns the captured runs' launch counts,
    summed."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.ops import KERNELS
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = dataclasses.replace(
        gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ),
        num_layers=SWEEP_LAYERS)
    inputs, targets = make_batch(cfg, FUSED_BATCH, TRAIN_SEQ, seed=0,
                                 device=DEVICE)
    total = {name: 0 for name in KERNELS}
    rows, bad = [], []
    for name, make_opt in _sweep_optimizers().items():
        runs, state = {}, {}
        for way in ("eager", "graph"):
            step = build_train_step(cfg, device=DEVICE, seed=0, fusion=True,
                                    optimizer=make_opt())
            runs[way] = _scheduled_run(step, inputs, targets, SWEEP_STEPS,
                                       f"sweep {name}", way == "eager")
            state[way] = _step_state(step)
            slots = tuple(step.state["slots"])
            del step
        (le, _, ne, _, re), (lg, _, ng, _, rg) = runs["eager"], runs["graph"]
        differ = _differ(state["eager"], state["graph"])
        lr_off = [(a, b) for a, b in re + rg if a != b]
        for k in total:
            total[k] += ng.get(k, 0)
        rows.append(f"{name} (slots {slots}): losses {le} / {lg}, rates "
                    f"{[a for a, _ in rg]}, {len(differ)} of "
                    f"{len(state['eager'])} tensors differ")
        if (le != lg or differ or lr_off
                or not all(math.isfinite(x) for x in le)):
            bad.append(name)
        _check_counts(f"sweep {name} eager", ne, _headline_per_step(cfg),
                      SWEEP_STEPS)
        _check_counts(f"sweep {name} graph", ng, _headline_per_step(cfg),
                      SWEEP_STEPS)
        del state
        _free_steps()
    log(f"[schedule] optimizer sweep, gpt_345m cut to {SWEEP_LAYERS} layers "
        f"at {FUSED_BATCH}x{TRAIN_SEQ}, pass on, {SWEEP_STEPS} steps eager / "
        f"captured each (1 compile, {SWEEP_STEPS - 1} hits, no fallback "
        f"each): {'; '.join(rows)} | {smi}")
    if bad:
        raise AssertionError(f"schedule sweep: captured and eager steps "
                             f"differ (or a loss is not finite) for {bad}")
    return total


def phase_schedule(smi):
    """The learning rate on the card, its schedules, gradient clipping and
    the optimizer family on the captured steps: bert_base 32 x 128 (pass
    off) under BERT's warm-up and linear decay, with a planted fault;
    bench_gpt's headline step under Megatron's warm-up and cosine; both
    with a global-norm clip, each eager against captured and beside phase
    11's schedule-free step (:func:`_schedule_path`); then the optimizer
    sweep (:func:`_optimizer_sweep`).  Returns {path: launch counts}."""
    from paddle_tpu_torch.incubate.models import bert_base, gpt_345m
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        build_train_step, make_batch,
                                        make_bert_batch)
    out = {}
    bert = bert_base()
    _free_steps()

    def make_bert(optimizer=_bert_optimizer):
        step = build_bert_pretrain_step(
            bert, device=DEVICE, seed=0, fusion=False,
            optimizer=optimizer() if optimizer else None)
        return (step, *make_bert_batch(bert, BERT_BATCH, BERT_SEQ, seed=0,
                                       device=DEVICE))
    label = f"bert_base {BERT_BATCH}x{BERT_SEQ} pass off scheduled"
    t0 = time.perf_counter()
    out[label] = _schedule_path(smi, label, make_bert,
                                lambda: make_bert(None),
                                _bert_per_step(bert, False), planted=True)
    log(f"[time] schedule {label} {time.perf_counter() - t0:.1f} s")
    gpt = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)

    def make_gpt(optimizer=_gpt_optimizer):
        step = build_train_step(gpt, device=DEVICE, seed=0, fusion=True,
                                optimizer=optimizer() if optimizer else None)
        return (step, *make_batch(gpt, FUSED_BATCH, TRAIN_SEQ, seed=0,
                                  device=DEVICE))
    label = f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} fused scheduled"
    t0 = time.perf_counter()
    out[label] = _schedule_path(smi, label, make_gpt, lambda: make_gpt(None),
                                _headline_per_step(gpt), planted=False)
    log(f"[time] schedule {label} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out[f"gpt_345m {SWEEP_LAYERS} layers optimizer sweep"] = \
        _optimizer_sweep(smi)
    log(f"[time] schedule optimizer sweep {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 13: checkpoints, resume, served-model directories, hot reload ------

def _tree_bytes(tree):
    """The bytes of a nested dict's tensors (what a checkpoint of it
    holds, less the headers)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _need_disk(what, path, nbytes):
    """Fail, naming the shortfall, when ``path``'s filesystem has less
    than ``nbytes`` (times ``CKPT_DISK_MARGIN``) free."""
    need = nbytes * CKPT_DISK_MARGIN
    free = shutil.disk_usage(path).free
    log(f"[checkpoint] {what}: {free / 1e9:.2f} GB free at {path} "
        f"({_filesystem(path)}), {need / 1e9:.2f} GB needed")
    if free < need:
        raise AssertionError(f"checkpoint {what}: {path} has "
                             f"{free / 1e9:.2f} GB free, {need / 1e9:.2f} GB "
                             f"needed: short by {(need - free) / 1e9:.2f} GB")


def _filesystem(path):
    """The type and source of the filesystem holding ``path`` (from
    ``/proc/mounts``, read only)."""
    path, best = os.path.realpath(path), ("?", "?", "")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                src, mnt, kind = line.split()[:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) >= len(best[2]):
                    best = (kind, src, mnt)
    except OSError:
        pass
    return f"{best[0]} {best[1]} on {best[2] or '?'}"


def _resume_run(step, inputs, targets, n):
    """``n`` captured steps of a scheduled ``TrainStep``: (losses, the
    learning-rate tensor read after each step); the schedule steps after
    each."""
    opt = step.optimizer
    sched = opt._learning_rate_scheduler
    losses, rates = [], []
    for _ in range(n):
        losses.append(step(inputs, targets).item())
        rates.append(opt.lr_tensor.item())
        sched.step()
    return losses, rates


def _resume_state(step):
    """Every state tensor of a step (:func:`_step_state`) and its
    generator's state, cloned."""
    out = {k: v.detach().clone() for k, v in _step_state(step).items()}
    out["generator"] = step.generator.get_state()
    return out


def _on_card(state):
    """``state`` without the generator's (host) state."""
    return {k: v for k, v in state.items() if k != "generator"}


def _resume_check(what, want, got, step, calls):
    """``got`` ((losses, rates), state) the same bits as ``want``, and
    ``step`` captured once over ``calls`` calls with no fallback."""
    (wl, wr), ws = want
    (gl, gr), gs = got
    differ = _differ(ws, gs)
    stats = step.captured.stats
    log(f"[checkpoint] {what}: losses {gl} (uninterrupted {wl}); learning "
        f"rate {gr} ({wr}); state digest {_state_digest(_on_card(gs))} "
        f"({_state_digest(_on_card(ws))}), tensors that differ "
        f"{differ[:4]} of "
        f"{len(ws)}; capture {stats}")
    if (gl, gr) != (wl, wr) or differ:
        raise AssertionError(f"checkpoint {what}: the resumed run is not the "
                             f"uninterrupted one bit for bit: losses {gl} / "
                             f"{wl}, rates {gr} / {wr}, tensors {differ[:8]}")
    _check_captured(what, step, calls)


def _corrupt_fallback(what, mgr_root, newest, older, fault, step, inputs,
                      targets, want):
    """Corrupt step ``newest`` under ``mgr_root`` with ``fault`` (which
    returns the shard file it hit), check that a full verify names it,
    that ``restore_latest`` falls back to ``older``, and that the step
    restored from there runs to ``want``'s bits.  Returns the error."""
    from paddle_tpu_torch.distributed import (CheckpointCorruptError,
                                              CheckpointManager,
                                              verify_checkpoint)
    from paddle_tpu_torch.train import restore_checkpoint
    mgr = CheckpointManager(mgr_root, orphan_age=None)
    rel = fault(mgr.step_dir(newest))
    leaf_dir = rel.split(os.sep)[-2]
    try:
        verify_checkpoint(mgr.step_dir(newest), integrity="full")
        err = None
    except CheckpointCorruptError as e:
        err = str(e)
    if err is None or leaf_dir not in err:
        raise AssertionError(f"checkpoint {what}: a full verify of the "
                             f"corrupted step {newest} gave {err!r}, which "
                             f"does not name {leaf_dir}")
    n = restore_checkpoint(mgr, step)
    calls = step.captured.stats["hits"] + 1
    run = _resume_run(step, inputs, targets, RESUME_STEPS - older)
    _resume_check(f"{what}: fell back to step {n}", want,
                  (run, _resume_state(step)), step,
                  calls + RESUME_STEPS - older)
    if n != older:
        raise AssertionError(f"checkpoint {what}: restore_latest gave step "
                             f"{n}, not the older step {older}")
    return err


def _flip_byte(step_dir, mask=0xFF):
    """XOR the last byte of the step's first shard file with ``mask``
    (its manifest CRC no longer matches; the same call again undoes it);
    returns the file, relative to the step."""
    rel = _shard_files(step_dir)[0]
    with open(os.path.join(step_dir, rel), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ mask]))
    return rel


def _poison(step_dir):
    """Flip one bit of the step's first shard file and re-seal its
    COMMIT manifest's CRC over the corrupted bytes: corruption before
    serialization, which only the content digest catches."""
    import zlib
    rel = _flip_byte(step_dir, 0x01)
    with open(os.path.join(step_dir, rel), "rb") as f:
        data = f.read()
    marker = os.path.join(step_dir, "COMMIT.0")
    with open(marker) as f:
        mk = json.load(f)
    mk["files"][rel.replace(os.sep, "/")]["crc32"] = \
        zlib.crc32(data) & 0xFFFFFFFF
    with open(marker, "w") as f:
        json.dump(mk, f)
    return rel


def _shard_files(step_dir):
    out = []
    for d, _, files in os.walk(os.path.join(step_dir, "data")):
        out += [os.path.relpath(os.path.join(d, f), step_dir) for f in files]
    return sorted(out)


def _resume_path(smi, label, make, per_step, root, corrupt):
    """One training path saved and resumed on the card.  ``make(seed)``
    builds the scheduled, clipped step and its batch.  Run A: the
    uninterrupted ``RESUME_STEPS`` captured steps.  Run B (seed 0):
    ``RESUME_SAVE_AT`` steps, a synchronous save (timed, then removed)
    and an asynchronous one through a ``CheckpointManager`` (the caller's
    stall timed; B runs on while the writer writes); with ``corrupt``,
    B first saves one step earlier too.  Then a fresh step from seed 1,
    the checkpoint restored into it, the remaining steps: losses, LR
    readings, every state tensor and the generator the bits of A, 1
    compile, no fallback; then the same restore into A itself (already
    captured).  With ``corrupt``, the newest step is corrupted twice (a
    flipped byte, then a flipped bit under a re-sealed manifest) and
    each time ``restore_latest`` falls back to the older step, the error
    naming the leaf.  Returns the fresh step's launch counts."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.ops import reset_launch_counts
    from paddle_tpu_torch.train import restore_checkpoint, save_checkpoint
    a, inputs, targets = make(0)
    run_a = _resume_run(a, inputs, targets, RESUME_STEPS)
    want_a = (run_a, _resume_state(a))
    k = RESUME_SAVE_AT
    want = ((run_a[0][k:], run_a[1][k:]), want_a[1])
    older = k - 1
    want_older = ((run_a[0][older:], run_a[1][older:]), want_a[1])
    b, _, _ = make(0)
    gen_bytes = _tree_bytes(b.checkpoint_tree())
    # the async save's generations (two with corrupt) and the second one
    _need_disk(label, root, gen_bytes * (3 if corrupt else 2))
    if corrupt:
        _resume_run(b, inputs, targets, older)
        save_checkpoint(CheckpointManager(os.path.join(root, "run")), older, b)
        _resume_run(b, inputs, targets, 1)
    else:
        _resume_run(b, inputs, targets, k)
    t0 = time.perf_counter()
    save_checkpoint(CheckpointManager(os.path.join(root, "sync")), k, b)
    sync_s = time.perf_counter() - t0
    disk = _dir_bytes(os.path.join(root, "sync"))
    shutil.rmtree(os.path.join(root, "sync"))
    mgr = CheckpointManager(os.path.join(root, "run"), async_save=True)
    t0 = time.perf_counter()
    save_checkpoint(mgr, k, b)
    stall_s = time.perf_counter() - t0
    run_b = _resume_run(b, inputs, targets, RESUME_STEPS - k)
    mgr.wait()
    async_s = time.perf_counter() - t0
    b_differ = _differ(want_a[1], _resume_state(b))
    # a second async save: the host allocator now holds the pinned blocks
    # the first one's copy was made in
    again = CheckpointManager(os.path.join(root, "again"), async_save=True)
    t0 = time.perf_counter()
    save_checkpoint(again, RESUME_STEPS, b)
    stall2_s = time.perf_counter() - t0
    again.wait()
    shutil.rmtree(again.root)
    del b
    _free_steps()
    c, _, _ = make(1)
    t0 = time.perf_counter()
    n = restore_checkpoint(mgr, c)
    restore_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    run_c = _resume_run(c, inputs, targets, RESUME_STEPS - k)
    launches = _launch_counts()
    log(f"[checkpoint] {label}: a generation {gen_bytes / 1e9:.3f} GB of "
        f"tensors, {disk / 1e9:.3f} GB on disk; sync save {sync_s:.2f} s "
        f"({disk / 1e9 / sync_s:.2f} GB/s); async save: the caller stalled "
        f"{stall_s:.2f} s (the host copy), committed after {async_s:.2f} s "
        f"while {RESUME_STEPS - k} steps ran on ({disk / 1e9 / async_s:.2f} "
        f"GB/s), a second async save stalled {stall2_s:.2f} s; restore {restore_s:.2f} s ({disk / 1e9 / restore_s:.2f} "
        f"GB/s, verified in full) | {smi}")
    if n != k or run_b != want[0] or b_differ:
        raise AssertionError(f"checkpoint {label}: restored step {n}; the "
                             f"saving run went on to {run_b} against "
                             f"{want[0]}, tensors {b_differ[:4]}")
    _resume_check(f"{label} fresh step (seed 1) restored", want,
                  (run_c, _resume_state(c)), c, RESUME_STEPS - k)
    _check_counts(f"checkpoint {label}", launches, per_step,
                  RESUME_STEPS - k)
    del c
    _free_steps()
    n = restore_checkpoint(mgr, a)
    run_a2 = _resume_run(a, inputs, targets, RESUME_STEPS - k)
    _resume_check(f"{label} the captured step restored", want,
                  (run_a2, _resume_state(a)), a, 2 * RESUME_STEPS - k)
    if corrupt:
        run = os.path.join(root, "run")
        for fault in (_flip_byte, _poison):
            err = _corrupt_fallback(f"{label} {fault.__name__[1:]}", run, k,
                                    older, fault, a, inputs, targets,
                                    want_older)
            log(f"[checkpoint] {label}: {fault.__name__[1:]} of step {k}: "
                f"{err}")
            if fault is _flip_byte:   # undo the flip: one fault at a time
                _flip_byte(os.path.join(run, f"step_{k:08d}"))
    del a
    _free_steps()
    return launches


def _served_paths(smi, root):
    """Serving from a model directory at full width (phase 5's gpt_345m
    weights and requests): ``save_served_model``, then ``load_engine`` at
    fp32, bf16 (one decode bucket, 16) and int8, each engine's tokens
    those of an engine built in memory from the same weights; then
    ``save_quantized_model`` (calibration on the card) served from its
    directory against the int8 engine, and ``logit_divergence``.  Then
    the hot reload over HTTP (:func:`_reload_path`).  Returns {path:
    launch counts}."""
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine, init_params,
                                          load_engine, save_served_model)
    from paddle_tpu_torch.serving.quant import (default_calibration_prompts,
                                                logit_divergence,
                                                save_quantized_model)
    spec = ModelSpec(**GPT_345M)
    prompts = _serve_prompts(spec.vocab_size)
    params = init_params(spec, seed=0, device=DEVICE)
    pbytes = _tree_bytes(params)
    _need_disk("served-model dirs", root, pbytes * 2.5)
    cfg = ServeConfig(decode_buckets=(2, 4, 8, 16),
                      prefill_buckets=(64, 128, 256, 512), kv_pages=1024,
                      page_size=PAGE_SIZE, max_inflight=64, max_new_tokens=32)
    t0 = time.perf_counter()
    path = save_served_model(os.path.join(root, "fp32"), spec, params, cfg)
    save_s = time.perf_counter() - t0
    out, tokens, engines = {}, {}, {}
    for prec in ("fp32", "bf16", "int8"):
        kw = {"precision": prec}
        if prec == "bf16":          # bf16's join/leave holds in one bucket
            kw["decode_buckets"] = (16,)
        mem = ServingEngine(spec, params, cfg.replace(**kw), device=DEVICE)
        tokens[prec] = mem.generate(prompts, max_new_tokens=32)
        mem.close()
        del mem
        t0 = time.perf_counter()
        eng = load_engine(path, device=DEVICE, **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        got = eng.generate(prompts, max_new_tokens=32)
        torch.cuda.synchronize()
        out[f"serve from dir {prec}"] = {n: f.launches
                                         for n, f in KERNELS.items()}
        log(f"[checkpoint] serve from dir {prec}: load_engine {load_s:.2f} s "
            f"(restore, warm-up, {len(eng._graphs)} graphs), weights step "
            f"{eng.weights_step}; 32 requests x 32 tokens equal to the "
            f"in-memory engine's: {got == tokens[prec]}")
        if got != tokens[prec] or eng.weights_step != 0:
            raise AssertionError(f"serve from dir {prec}: tokens differ from "
                                 f"an engine built in memory")
        if prec == "fp32":
            engines[prec] = eng
        else:
            eng.close()
            del eng
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    qpath = save_quantized_model(os.path.join(root, "int8"), spec, params,
                                 cfg, max_new=4)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    div = logit_divergence(spec, params, default_calibration_prompts(spec),
                           max_new=4, page_size=PAGE_SIZE)
    div_s = time.perf_counter() - t0
    out["calibrate/logit_divergence"] = {n: f.launches
                                         for n, f in KERNELS.items()}
    t0 = time.perf_counter()
    div_cpu = logit_divergence(spec, {k: v.cpu() for k, v in params.items()},
                               default_calibration_prompts(spec), max_new=4,
                               page_size=PAGE_SIZE)
    div_cpu_s = time.perf_counter() - t0
    with open(os.path.join(qpath, "serve_config.json")) as f:
        scales = json.load(f)["precision"]["act_scales"]
    eng = load_engine(qpath, device=DEVICE)
    reset_launch_counts()
    got = eng.generate(prompts, max_new_tokens=32)
    out["serve from quantized dir int8"] = {n: f.launches
                                            for n, f in KERNELS.items()}
    eng.close()
    del eng
    lo, hi = min(scales, key=scales.get), max(scales, key=scales.get)
    log(f"[checkpoint] served dir: save_served_model {save_s:.2f} s "
        f"({_dir_bytes(path) / 1e9:.3f} GB); save_quantized_model "
        f"{cal_s:.2f} s with calibration on the card "
        f"({_dir_bytes(qpath) / 1e9:.3f} GB), {len(scales)} act scales "
        f"{scales[lo]:.4g} ({lo}) .. {scales[hi]:.4g} ({hi}); "
        f"logit_divergence {div:.6g} in {div_s:.2f} s (4 prompts, 4 new "
        f"tokens, fp32 against int8), {div_cpu:.6g} on the CPU's plain "
        f"path in {div_cpu_s:.2f} s (relative gap "
        f"{abs(div - div_cpu) / div_cpu:.3e}, limit {DIVERGENCE_RTOL:g}); "
        f"the quantized dir's tokens equal the int8 engine's: "
        f"{got == tokens['int8']} | {smi}")
    if got != tokens["int8"]:
        raise AssertionError("serve from the quantized dir: tokens differ "
                             "from the int8 engine built in memory")
    if not (math.isfinite(div) and div_cpu > 0 and
            abs(div - div_cpu) <= DIVERGENCE_RTOL * div_cpu) or \
            not all(math.isfinite(s) and s > 0 for s in scales.values()):
        raise AssertionError(f"calibration: divergence {div} on the card, "
                             f"{div_cpu} on the CPU; scales {scales[lo]} .. "
                             f"{scales[hi]}")
    out["serve reload"] = _reload_path(smi, engines.pop("fp32"), spec,
                                       params, cfg, prompts,
                                       tokens["fp32"])
    return out


def _post(base, path, body, timeout=300):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _reload_path(smi, engine, spec, params, cfg, prompts, tokens0):
    """The hot reload over HTTP, under traffic: 16 clients each post one
    prompt's requests back to back; once the scheduler holds active rows,
    generation 1 (the weights perturbed) is saved into the directory's
    manager and ``POST /v1/reload`` sent.  The swap waits for active
    rows and is made with them resident (requests whose tokens come from
    both generations); every request answers 200 with
    32 tokens in the vocabulary, those that ended before the swap with
    generation 0's tokens (``tokens0``, the in-memory engine's), those
    that began after it with a fresh engine's on generation 1.
    ``/healthz`` then shows ``weights_step`` 1, the tokens that follow
    equal the fresh engine's, the graphs are the same objects and none
    was captured again.  Returns the launch counts of the generate after
    the reload."""
    import threading
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.http import ServeHTTPServer
    n_clients, new = 16, 32

    def tok_s(eng):
        eng.scheduler._step_times.clear()
        got = eng.generate(prompts, max_new_tokens=new)
        times = list(eng.scheduler._step_times)
        return got, sum(len(o) - 1 for o in got) / sum(times)

    graphs = {k: id(b.graph.graph) for k, b in engine._graphs.items()}
    captured_s = engine.capture_seconds
    _, before_tps = tok_s(engine)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    gen1 = {k: v + 0.01 * torch.randn(v.shape, generator=g, device=DEVICE)
            for k, v in params.items()}
    t0 = time.perf_counter()
    engine.checkpoint_manager.save(1, gen1)
    publish_s = time.perf_counter() - t0
    sched, swap = engine.scheduler, {}

    def install(p, step=None):
        """The engine's install, held until the scheduler has active rows
        and made at a step boundary with them resident: under the
        scheduler's lock, taken before the weights lock as a step takes
        them.  A resident row has tokens left, so each one active here
        decodes on generation 0 before the swap and on 1 after it."""
        t0 = time.perf_counter()
        while True:
            with sched._lock:
                if sched._active:
                    swap["waited"] = time.perf_counter() - t0
                    swap["active"] = len(sched._active)
                    swap["t_in"] = time.perf_counter()
                    install_weights(p, step)
                    swap["t_out"] = time.perf_counter()
                    return
            if time.perf_counter() - t0 > 60:
                raise TimeoutError("no active row to swap under in 60 s")
            time.sleep(0.0005)

    install_weights = engine.install_weights
    engine.install_weights = install
    srv = ServeHTTPServer(engine, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    results, stop, reloaded = [], threading.Event(), []

    def client(i):
        """Requests for prompt ``i`` until the reload has returned and
        one request has begun after it."""
        while True:
            t_start = time.perf_counter()
            try:
                status, body = _post(base, "/v1/generate",
                                     {"tokens": prompts[i],
                                      "max_new_tokens": new})
            except Exception as e:      # recorded, and failed below
                results.append((i, t_start, time.perf_counter(),
                                getattr(e, "code", repr(e)), None))
                return
            results.append((i, t_start, time.perf_counter(), status,
                            body.get("tokens")))
            if stop.is_set() and t_start > reloaded[0]:
                return
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    try:
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 120
        while not sched.snapshot()["active_sequences"]:
            if time.perf_counter() > deadline:
                raise AssertionError("serve reload: no request became "
                                     "active within 120 s")
            time.sleep(0.001)
        steps0 = sched.snapshot()["steps"]
        t0 = time.perf_counter()
        status, body = _post(base, "/v1/reload", {})
        reload_s = time.perf_counter() - t0
        steps_during = sched.snapshot()["steps"] - steps0
        reloaded.append(time.perf_counter())
        stop.set()
        for t in threads:
            t.join(300)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        _, solo = _post(base, "/v1/generate",
                        {"tokens": prompts[0], "max_new_tokens": new})
    finally:
        if not reloaded:
            reloaded.append(0.0)
        stop.set()
        for t in threads:
            t.join(300)
        srv.stop()
        del engine.install_weights
    torch.cuda.synchronize()
    reset_launch_counts()
    after, after_tps = tok_s(engine)
    launches = {n: f.launches for n, f in KERNELS.items()}
    fresh = ServingEngine(spec, gen1, cfg, device=DEVICE)
    want = fresh.generate(prompts, max_new_tokens=new)
    want_solo = fresh.generate([prompts[0]], max_new_tokens=new)[0]
    fresh.close()
    del fresh
    bad, n_old, n_new, n_span = [], 0, 0, 0
    for i, t_start, t_end, st, toks in results:
        if st != 200 or not isinstance(toks, list) or len(toks) != new or \
                not all(isinstance(x, int) and 0 <= x < spec.vocab_size
                        for x in toks):
            bad.append(f"prompt {i}: status {st}, tokens {toks!r:.80}")
        elif t_end < swap.get("t_in", 0.0):
            n_old += 1
            if toks != tokens0[i]:
                bad.append(f"prompt {i}: ended before the swap, not "
                           f"generation 0's tokens")
        elif t_start > swap.get("t_out", math.inf):
            n_new += 1
            if toks != want[i]:
                bad.append(f"prompt {i}: began after the swap, not "
                           f"generation 1's tokens")
        else:
            n_span += 1
    same_graphs = {k: id(b.graph.graph)
                   for k, b in engine._graphs.items()} == graphs
    log(f"[checkpoint] serve reload: generation 1 published in "
        f"{publish_s:.2f} s; POST /v1/reload {status} {body} in "
        f"{reload_s:.2f} s under {n_clients} clients ({steps_during} "
        f"scheduler steps during it; the swap waited "
        f"{swap.get('waited', math.nan) * 1e3:.3f} ms for active rows and "
        f"found {swap.get('active')}); "
        f"{len(results)} requests answered: {n_old} before the swap with "
        f"generation 0's tokens, {n_new} after it with generation 1's, "
        f"{n_span} across it, all 200 with {new} tokens: {not bad}; "
        f"/healthz weights_step {health['weights_step']}; tokens after equal "
        f"a fresh engine's on generation 1: {after == want} (one over HTTP: "
        f"{solo['tokens'] == want_solo}); graphs the same objects "
        f"{same_graphs} ({len(graphs)}), capture seconds {captured_s:.3f} -> "
        f"{engine.capture_seconds:.3f}; decode {before_tps:.1f} tok/s "
        f"before, {after_tps:.1f} after | {smi}")
    engine.close()
    if (status, body) != (200, {"reloaded": True, "weights_step": 1}) or \
            health["weights_step"] != 1:
        raise AssertionError(f"serve reload: /v1/reload {status} {body}, "
                             f"healthz {health['weights_step']}")
    if not swap.get("active") or n_span < swap["active"] or not n_old or \
            not n_new or bad:
        raise AssertionError(f"serve reload: the swap found "
                             f"{swap.get('active')} rows active, {n_span} "
                             f"requests ran across it; {n_old} before it, "
                             f"{n_new} after; {len(bad)} wrong: {bad[:4]}")
    if after != want or solo["tokens"] != want_solo:
        raise AssertionError("serve reload: the tokens after the reload are "
                             "not a fresh engine's on generation 1")
    if not same_graphs or engine.capture_seconds != captured_s:
        raise AssertionError("serve reload: a graph was captured again")
    return launches


def phase_checkpoint(smi):
    """Checkpoints on the card, in a temporary directory whose free space
    is checked first and whose files each path removes after its check:
    bench_gpt's headline step (gpt_345m 8 x 1024, pass on, dropout 0.1,
    phase 12's AdamW recipe) and bert_base 32 x 128 (pass off, BERT's
    recipe) saved and resumed (:func:`_resume_path`; BERT also through
    two corruptions), then serving from a model directory, calibration
    and the hot reload (:func:`_served_paths`).  Returns {path: launch
    counts}."""
    import tempfile
    from paddle_tpu_torch.incubate.models import bert_base, gpt_345m
    from paddle_tpu_torch.train import (build_bert_pretrain_step,
                                        build_train_step, make_batch,
                                        make_bert_batch)
    out = {}
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    gpt = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    bert = bert_base()

    def make_gpt(seed):
        step = build_train_step(gpt, device=DEVICE, seed=seed, fusion=True,
                                optimizer=_gpt_optimizer())
        return (step, *make_batch(gpt, FUSED_BATCH, TRAIN_SEQ, seed=0,
                                  device=DEVICE))

    def make_bert(seed):
        step = build_bert_pretrain_step(bert, device=DEVICE, seed=seed,
                                        fusion=False,
                                        optimizer=_bert_optimizer())
        return (step, *make_bert_batch(bert, BERT_BATCH, BERT_SEQ, seed=0,
                                       device=DEVICE))
    try:
        for label, make, per_step, corrupt in (
                (f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} resume captured",
                 make_gpt, _headline_per_step(gpt), False),
                (f"bert_base {BERT_BATCH}x{BERT_SEQ} resume captured",
                 make_bert, _bert_per_step(bert, False), True)):
            root = os.path.join(base, label.split()[0])
            os.makedirs(root)
            t0 = time.perf_counter()
            out[label] = _resume_path(smi, label, make, per_step, root,
                                      corrupt)
            shutil.rmtree(root)
            log(f"[time] checkpoint {label} {time.perf_counter() - t0:.1f} s")
        root = os.path.join(base, "serve")
        os.makedirs(root)
        t0 = time.perf_counter()
        out.update(_served_paths(smi, root))
        shutil.rmtree(root)
        log(f"[time] checkpoint serve {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


# -- phase 14: data loading and hapi --------------------------------------------

class _HapiTokens:
    """bench_gpt's synthetic data as a dataset: ``HAPI_SEQS`` sequences
    of ``TRAIN_SEQ + 1`` tokens from ``np.random.RandomState(0)``; a
    sample is (ids ``[:-1]``, labels ``[1:]``).  Defined here, so it
    pickles: the loader spawns its workers."""

    def __init__(self, vocab):
        self.tokens = np.random.RandomState(0).randint(
            0, vocab, (HAPI_SEQS, TRAIN_SEQ + 1)).astype(np.int64)

    def __getitem__(self, i):
        return self.tokens[i, :-1], self.tokens[i, 1:]

    def __len__(self):
        return len(self.tokens)


def _hapi_loader(ds, workers=HAPI_WORKERS):
    """The loader of phase 14: shuffled by a ``RandomState(0)`` sampler,
    ``FUSED_BATCH`` sequences a batch, ``workers`` worker processes."""
    from paddle_tpu_torch.io import BatchSampler, DataLoader, RandomSampler
    sampler = BatchSampler(sampler=RandomSampler(
        ds, generator=np.random.RandomState(0)), batch_size=FUSED_BATCH)
    return DataLoader(ds, batch_sampler=sampler, num_workers=workers)


class _TimedLoader:
    """A loader whose ``next()`` waits are kept (``waits``, seconds)."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


def _hapi_callbacks():
    """A callback that reads each step's loss on the host (``losses``)
    and keeps the wall time from the epoch's start or the last step's end
    to this step's end (``times``)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.times = [], []

        def on_epoch_begin(self, epoch, logs=None):
            self._t = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))     # waits for the card
            now = time.perf_counter()
            self.times.append(now - self._t)
            self._t = now
    return StepClock()


def _hapi_gpt(gpt, seed):
    """gpt_345m through hapi as phase 14 drives it: the network drawn
    from a generator seeded ``seed`` on the card, O2 bf16 (decorated
    before ``Model``), ``AdamW(1e-4, multi_precision=True,
    parameters=...)``, the causal-LM loss, the fusion pass as
    ``fusion_enabled()`` says (on)."""
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    gen = make_generator(seed, DEVICE)
    net = GPTForCausalLM(gpt, generator=gen)
    decorate(net, level="O2", dtype="bfloat16")
    model = Model(net, generator=gen)
    model.prepare(optimizer=AdamW(learning_rate=1e-4, multi_precision=True,
                                  parameters=net.parameters()),
                  loss=GPTPretrainingCriterion())
    return model


def _launch_counts():
    """Every wrapper's launch counter, the LayerNorm residual variants'
    as ``name.residual``."""
    from paddle_tpu_torch.ops import KERNELS
    launches = {name: KERNELS[name].launches for name in KERNELS}
    for name in LN_KERNELS:
        launches[name + ".residual"] = KERNELS[name].residual_launches
    return launches


def _hapi_gpt_path(smi, root):
    """GPT-345m through ``Model.fit`` at bench_gpt's headline shape
    (8 x 1024, no recompute, dropout 0.1, the fusion pass on, O2 bf16,
    AdamW) from phase 14's DataLoader (2 workers): run A, one epoch of 8
    steps, saves after step ``HAPI_SAVE_AT`` through a
    ``CheckpointManager`` with the loader's ``state_dict()`` as its data
    state; it must capture once and replay 7 times, launching the
    headline step's kernels each step.  Run B, ``build_train_step`` on
    the same batches in the same order: losses and every state tensor
    the same bits as A.  Run C, a fresh ``Model`` (weights from seed 1)
    and a fresh DataLoader restored there: steps 4-8 A's bits.  Then
    ``fit`` and the bare captured step in turns (a b b a), the host's
    wait on the loader and peak memory, and the launches of a replay
    held to the profiler's count.  Returns {path: launch counts}."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.ops import reset_launch_counts
    from paddle_tpu_torch.train import (build_train_step,
                                        restore_checkpoint, save_checkpoint)
    gpt = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    per_step = _headline_per_step(gpt)
    ds = _HapiTokens(gpt.vocab_size)
    n_steps = len(ds) // FUSED_BATCH
    label = f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} hapi fit"
    mgr = CheckpointManager(os.path.join(root, "run"), async_save=True)

    class SaveAt(Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == HAPI_SAVE_AT - 1:
                save_checkpoint(mgr, HAPI_SAVE_AT, self.model.train_step,
                                data_state=loader.state_dict())

    a = _hapi_gpt(gpt, 0)
    loader = _hapi_loader(ds)
    _need_disk("hapi", root, _tree_bytes(a.train_step.checkpoint_tree()))
    clock = _hapi_callbacks()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    a.fit(loader, epochs=1, verbose=0, callbacks=[clock, SaveAt()])
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    mgr.wait()
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    _check_captured(f"{label} (run A)", a.train_step, n_steps)
    _check_counts(label, launches, per_step, n_steps)
    losses_a = clock.losses
    log(f"[hapi] {label}: run A {n_steps} steps in {fit_s:.2f} s (capture "
        f"and the save after step {HAPI_SAVE_AT} included), losses "
        f"{losses_a}; capture {a.train_step.captured.stats}; peak "
        f"{peak_a:.2f} GB")
    # uniform random tokens: nothing to learn, so no fall to check
    if not all(math.isfinite(v) for v in losses_a):
        raise AssertionError(f"{label}: losses {losses_a}")

    batches = [tuple(t.to(DEVICE) for t in batch)
               for batch in _hapi_loader(ds, workers=0)]
    b = build_train_step(gpt, device=DEVICE, seed=0, fusion=True)
    losses_b = [b(ids, labels).item() for ids, labels in batches]
    state_a = _step_state(a.train_step)
    differ = _differ(state_a, _step_state(b))
    same_rng = torch.equal(a.train_step.generator.get_state(),
                           b.generator.get_state())
    log(f"[hapi] {label}: build_train_step on the same batches: losses "
        f"{losses_b}; state digest {_state_digest(_step_state(b))} (fit "
        f"{_state_digest(state_a)}), tensors that differ {differ[:4]} of "
        f"{len(state_a)}, generators the same: {same_rng}")
    if losses_b != losses_a or differ or not same_rng:
        raise AssertionError(f"{label}: fit and build_train_step differ: "
                             f"losses {losses_a} / {losses_b}, tensors "
                             f"{differ[:8]}, generator same {same_rng}")
    _check_captured(f"{label} (build_train_step)", b, n_steps)
    del b
    _free_steps()

    c = _hapi_gpt(gpt, 1)
    t0 = time.perf_counter()
    n = restore_checkpoint(mgr, c.train_step)
    restore_s = time.perf_counter() - t0
    resumed = _hapi_loader(ds)
    resumed.load_state_dict(mgr.load_data_state(n))
    clock_c = _hapi_callbacks()
    c.fit(resumed, epochs=1, verbose=0, callbacks=[clock_c])
    differ = _differ(state_a, _step_state(c.train_step))
    log(f"[hapi] {label}: resumed at step {n} (restore {restore_s:.2f} s) "
        f"into a fresh Model and DataLoader: losses {clock_c.losses} "
        f"(uninterrupted {losses_a[n:]}), tensors that differ {differ[:4]}")
    if n != HAPI_SAVE_AT or clock_c.losses != losses_a[n:] or differ or \
            not torch.equal(c.train_step.generator.get_state(),
                            a.train_step.generator.get_state()):
        raise AssertionError(f"{label}: the resumed steps are not the "
                             f"uninterrupted ones: step {n}, losses "
                             f"{clock_c.losses} / {losses_a[n:]}, tensors "
                             f"{differ[:8]}")
    _check_captured(f"{label} (resumed)", c.train_step, n_steps - n)
    del c
    shutil.rmtree(mgr.root)
    _free_steps()

    # fit against the bare captured step, in turns
    b = build_train_step(gpt, device=DEVICE, seed=0, fusion=True)
    b(*batches[0]).item()                              # capture
    times = {"fit": [], "step": []}
    waits, peaks = [], []
    for way in HAPI_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if way == "fit":
            timed, clock = _TimedLoader(_hapi_loader(ds)), _hapi_callbacks()
            a.fit(timed, epochs=1, verbose=0, callbacks=[clock])
            times["fit"] += clock.times
            waits += timed.waits
        else:
            for ids, labels in batches:
                t0 = time.perf_counter()
                b(ids, labels).item()
                times["step"].append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    wait_ms = sorted(w * 1e3 for w in waits)
    log(f"[hapi] {label}: turns {'/'.join(HAPI_TURNS)}, {n_steps} steps "
        f"each: fit median {med['fit']:.2f} ms a step (first steps "
        f"{[round(t * 1e3, 2) for t in times['fit'][::n_steps]]} ms, the "
        f"workers' start), the bare captured step {med['step']:.2f} ms "
        f"(fit - step {med['fit'] - med['step']:+.2f} ms); the host's wait "
        f"on the loader a step: median {statistics.median(wait_ms):.3f} "
        f"ms, max {wait_ms[-1]:.3f} ms, after the first of each epoch max "
        f"{max(w * 1e3 for i, w in enumerate(waits) if i % n_steps):.3f} "
        f"ms; peak {max(peaks):.2f} GB (fit) | {smi}")
    del b
    ids, labels = batches[0]
    kernels = _check_device_launches(
        f"{label} replay", lambda: a.train_batch([ids], [labels]), 2,
        per_step)
    log(f"[hapi] {label}: a profiled replay of train_batch ran "
        f"{len(kernels)} kernel names, the counters' launches on the "
        f"device")
    out = {label: launches}
    out.update(_telemetry_turns(smi, a, ds, gpt, root))
    del a, batches
    _free_steps()
    return out


class _Shapes:
    """The classifier's data: ``HAPI_CLS_SIZE`` images (3, 8, 8) of 4
    classes, a class centre plus noise, from ``RandomState(0)`` (the JAX
    package's ``FakeData`` recipe); a sample is (image, label)."""

    def __init__(self):
        rng = np.random.RandomState(0)
        centres = rng.randn(4, 3, 8, 8).astype(np.float32)
        self.labels = np.arange(HAPI_CLS_SIZE) % 4
        self.images = (centres[self.labels] + 0.5 * rng.randn(
            HAPI_CLS_SIZE, 3, 8, 8).astype(np.float32))

    def __getitem__(self, i):
        return self.images[i], np.int64(self.labels[i])

    def __len__(self):
        return HAPI_CLS_SIZE


def _hapi_classifier(device):
    """The JAX package's hapi test classifier on ``device``: Flatten,
    Linear 192 -> 32, ReLU, Linear 32 -> 4, ``Adam(0.01)``,
    ``CrossEntropyLoss``, ``Accuracy``, 3 epochs of batch 32 (the global
    numpy stream seeded 0 first: the same order on both devices), then
    ``evaluate`` and ``predict``.  Returns (losses, eval logs, predictions,
    model)."""
    from paddle_tpu_torch import metric, nn
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.optimizer import Adam

    class Data(_Shapes, Dataset):
        pass

    # drawn on the CPU, so both devices start from the same weights
    gen = make_generator(42, "cpu")
    net = torch.nn.Sequential(
        torch.nn.Flatten(), nn.Linear(3 * 8 * 8, 32, XavierNormal(),
                                      generator=gen),
        torch.nn.ReLU(), nn.Linear(32, 4, XavierNormal(), generator=gen))
    net.to(device)
    model = Model(net)
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=nn.CrossEntropyLoss(), metrics=metric.Accuracy())
    clock = _hapi_callbacks()
    np.random.seed(0)
    data = Data()
    model.fit(data, epochs=3, batch_size=32, verbose=0, callbacks=[clock])
    logs = model.evaluate(data, batch_size=32, verbose=0)
    preds = model.predict(data, batch_size=8, stack_outputs=True)[0]
    return clock.losses, logs, preds, model


def _hapi_classifier_path(smi):
    """The classifier through ``fit``, ``evaluate`` and ``predict`` on the
    card against the same on the CPU's plain path (the same weights and
    data order): losses, eval loss and accuracy, predictions within
    ``HAPI_CLS_TOL``; the cross-entropy kernels (rows 9-10) counted on
    the training and eval steps, captured, and held to a profiled
    replay.  Returns {path: launch counts}."""
    from paddle_tpu_torch.ops import reset_launch_counts
    label = f"classifier {HAPI_CLS_SIZE} x (3, 8, 8) hapi"
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, logs, preds, model = _hapi_classifier(DEVICE)
    launches = _launch_counts()
    want_losses, want_logs, want_preds, _ = _hapi_classifier("cpu")
    err = max([abs(a - b) for a, b in zip(losses, want_losses)]
              + [abs(logs["loss"] - want_logs["loss"]),
                 abs(logs["acc"] - want_logs["acc"]),
                 float(np.abs(preds - want_preds).max())])
    steps = 3 * HAPI_CLS_SIZE // 32
    evals = HAPI_CLS_SIZE // 32
    train, ev = model.train_step.captured.stats, model._eval_step.stats
    log(f"[hapi] {label}: fit losses {losses} (CPU {want_losses}), "
        f"evaluate {logs} (CPU {want_logs}), predictions {preds.shape}; "
        f"max |card - CPU| {err:.3e} (limit {HAPI_CLS_TOL}); softmax_xent "
        f"fwd / bwd launches {launches['softmax_xent_fwd']} / "
        f"{launches['softmax_xent_bwd']} (train {steps} steps, eval "
        f"{evals} batches); capture: train {train}, eval {ev} | {smi}")
    if err > HAPI_CLS_TOL or len(losses) != steps or \
            losses[-1] >= losses[0]:
        raise AssertionError(f"{label}: card and CPU differ by {err} "
                             f"(limit {HAPI_CLS_TOL}), losses {losses}")
    if (launches["softmax_xent_fwd"], launches["softmax_xent_bwd"]) != (
            steps + evals, steps):
        raise AssertionError(f"{label}: cross-entropy launches {launches}")
    _check_captured(f"{label} train", model.train_step, steps)
    # evaluate's batches and predict's (no labels): a graph each
    if (ev["compiles"], ev["fallback"]) != (2, None):
        raise AssertionError(f"{label}: the eval step's capture {ev}")
    x = torch.from_numpy(_Shapes().images[:32])
    y = torch.from_numpy(_Shapes().labels[:32])
    _check_device_launches(f"{label} replay",
                           lambda: model.train_batch([x], [y]), 2,
                           {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1})
    del model
    _free_steps()
    return {label: launches}


def phase_hapi(smi):
    """Data loading and hapi on the card (:func:`_hapi_gpt_path`,
    :func:`_hapi_classifier_path`), in a temporary directory.  Returns
    {path: launch counts}."""
    import tempfile
    base = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    try:
        t0 = time.perf_counter()
        out = _hapi_gpt_path(smi, base)
        log(f"[time] hapi gpt {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out.update(_hapi_classifier_path(smi))
        log(f"[time] hapi classifier {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


# -- phase 15: data x tensor parallelism ----------------------------------------

def _hybrid_cfg(layers=None, dropout=True):
    """GPT-345m at the headline step's widths, no recompute, the position
    table at ``TRAIN_SEQ``; ``layers`` cuts the depth."""
    from paddle_tpu_torch.incubate.models import gpt_345m
    kw = {} if dropout else dict(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    cfg = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ,
                   **kw)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _attn_dropout_cfg(layers=None):
    """GPT-345m as :func:`_hybrid_cfg`, attention dropout 0.1, hidden
    dropout 0 (phase 17 (b)'s second run)."""
    return dataclasses.replace(_hybrid_cfg(layers, dropout=False),
                               attention_probs_dropout_prob=FLASH_DROPOUT)


def _degrees(dp=1, mp=1, zero_stage=None):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    if zero_stage is not None:
        strategy.sharding = True
        strategy.sharding_configs = {"stage": zero_stage}
    return strategy


def _hybrid_optimizer(bf16=False):
    """AdamW at ``HYBRID_LR`` with the global-norm clip (master weights in
    f32 for O2 bf16)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=HYBRID_LR, multi_precision=bf16,
                 grad_clip=ClipGradByGlobalNorm(HYBRID_CLIP))


def _weights(step):
    """A copy of the step's parameters, by name, on the card."""
    from paddle_tpu_torch.distributed import unwrap_model
    return {n: p.detach().clone()
            for n, p in unwrap_model(step.model).named_parameters()}


def _updates(step, init):
    """Each parameter's update since ``init`` (:func:`_weights`), by name
    in f32 numpy, and the split axes."""
    from paddle_tpu_torch.distributed import unwrap_model
    from paddle_tpu_torch.incubate.models import split_axes
    model = unwrap_model(step.model)
    return ({n: (p.detach() - init[n]).float().cpu().numpy()
             for n, p in model.named_parameters()}, split_axes(model))


def _hybrid_steps(step, ids, labels, n, after_first=None):
    """``n`` steps, the counters set to 0 just before and read just after:
    (losses, step seconds, launch counts, the clip's global norm after
    each step (none without a global-norm clip)); ``after_first()`` runs
    after the first step, untimed."""
    from paddle_tpu_torch.ops import reset_launch_counts
    clip = step.optimizer._grad_clip
    if ids.is_cuda:
        torch.cuda.synchronize()
    reset_launch_counts()
    losses, times, norms = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        times.append(time.perf_counter() - t0)
        if getattr(clip, "last_norm", None) is not None:
            norms.append(clip.last_norm.item())
        if after_first is not None and len(losses) == 1:
            after_first()
    return losses, times, _launch_counts(), norms


def _plain_per_step(cfg):
    """Launches of one unfused, non-recompute GPT step at ``cfg``'s depth:
    LayerNorm forward and backward 2 a block and the final one, the flash
    forward, dq and dk/dv one a block."""
    layers = cfg.num_layers
    return {"layer_norm_fwd": 2 * layers + 1,
            "layer_norm_bwd": 2 * layers + 1,
            "layer_norm_fwd.residual": 0, "layer_norm_bwd.residual": 0,
            **{n: layers for n in FLASH_KERNELS}}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _hybrid_world1_rank(backend):
    """(a) and the references of (b) and (c), in one rank of a world of
    one on the card (see the module docstring)."""
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.train import build_train_step, make_batch
    init_parallel_env(backend, device=DEVICE)
    capture = backend == "nccl"
    out = {}
    cfg = _hybrid_cfg()
    ids, labels = make_batch(cfg, HYBRID_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    plain = build_train_step(cfg, device=DEVICE, fusion=False,
                             optimizer=_hybrid_optimizer(bf16=True))
    losses_p, times_p, _, norms_p = _hybrid_steps(plain, ids, labels,
                                                  HYBRID_A_STEPS)
    want = {k: t.clone() for k, t in _step_state(plain).items()}
    want_rng = plain.generator.get_state()
    del plain
    _free()
    hyb = build_train_step(cfg, device=DEVICE, fusion=False,
                           strategy=_degrees(), capture=capture,
                           optimizer=_hybrid_optimizer(bf16=True))
    losses_h, times_h, launches, norms_h = _hybrid_steps(hyb, ids, labels,
                                                         HYBRID_A_STEPS)
    if capture:
        _check_captured("hybrid (a)", hyb, HYBRID_A_STEPS)
    got = _step_state(hyb)
    differ = _differ(want, got)
    same_rng = torch.equal(want_rng, hyb.generator.get_state())
    per_step = _plain_per_step(cfg)
    _check_counts("hybrid (a)", launches, per_step, HYBRID_A_STEPS)
    profiled = None
    if capture:
        profiled = len(_check_device_launches(
            "hybrid (a) replay", lambda: hyb(ids, labels), 2, per_step))
    log(f"[hybrid] (a) rank 0: losses {losses_h}, plain {losses_p}, "
        f"tensors that differ {len(differ)}")
    out["a"] = {"plain": losses_p, "hybrid": losses_h, "differ": differ,
                "norms_plain": norms_p, "norms_hybrid": norms_h,
                "n_state": len(want), "plain_s": times_p, "hybrid_s": times_h,
                "same_rng": same_rng,
                "launches": launches, "profiled": profiled,
                "stats": None if hyb.captured is None
                else dict(hyb.captured.stats)}
    del hyb, got
    _free()
    # phase 16 (a): pp = sharding = 1 with ZeRO's os_g set through fleet's
    # strategy, against the same plain step
    t0 = time.perf_counter()
    zs = build_train_step(cfg, device=DEVICE, fusion=False,
                          strategy=_degrees(zero_stage=2), capture=capture,
                          optimizer=_hybrid_optimizer(bf16=True))
    from paddle_tpu_torch.distributed.sharding import zero_level
    losses_z, times_z, launches_z, norms_z = _hybrid_steps(zs, ids, labels,
                                                           HYBRID_A_STEPS)
    if capture:
        _check_captured("zero-pipeline (a)", zs, HYBRID_A_STEPS)
    differ_z = _differ(want, _step_state(zs))
    same_rng_z = torch.equal(want_rng, zs.generator.get_state())
    _check_counts("zero-pipeline (a)", launches_z, per_step, HYBRID_A_STEPS)
    profiled_z = None
    if capture:
        profiled_z = len(_check_device_launches(
            "zero-pipeline (a) replay", lambda: zs(ids, labels), 2,
            per_step))
    out["a16"] = {"losses": losses_z, "plain": losses_p, "norms": norms_z,
                  "norms_plain": norms_p, "differ": differ_z,
                  "same_rng": same_rng_z,
                  "level": zero_level(zs.optimizer), "zero": zs.zero,
                  "launches": launches_z, "profiled": profiled_z,
                  "times": times_z, "plain_s": times_p,
                  "seconds": time.perf_counter() - t0,
                  "stats": None if zs.captured is None
                  else dict(zs.captured.stats)}
    out["a16"]["zero"] = out["a16"]["zero"] is not None
    del zs, want
    _free()
    # the f32 references: phases 15 and 16 (b), (c), and phase 17 (b) at
    # attention dropout 0.1
    for key, cfg in (("b", _hybrid_cfg(dropout=False)),
                     ("c", _hybrid_cfg(HYBRID_C_LAYERS, dropout=False)),
                     ("c_attn", _attn_dropout_cfg(HYBRID_C_LAYERS))):
        step = build_train_step(cfg, device=DEVICE, amp_o2=False,
                                fusion=False, strategy=_degrees(),
                                capture=False,
                                optimizer=_hybrid_optimizer())
        init = _weights(step)
        n_steps = HYBRID_C_STEPS if key.startswith("c") else HYBRID_STEPS
        losses, times, _, norms = _hybrid_steps(step, ids, labels, n_steps)
        updates, _ = _updates(step, init)
        out[key] = {"losses": losses, "times": times, "updates": updates,
                    "norms": norms}
        del init
        del step
        _free()
    return out


def _swap_shards(step):
    """The planted fault: the two model-parallel ranks trade shards."""
    from paddle_tpu_torch.distributed import broadcast
    from paddle_tpu_torch.distributed import unwrap_model
    from paddle_tpu_torch.distributed.fleet.meta_parallel import is_shard
    group = step.hcg.get_model_parallel_group()
    with torch.no_grad():
        for p in unwrap_model(step.model).parameters():
            if not is_shard(p):
                continue
            a, b = p.data.clone(), p.data.clone()
            broadcast(a, src=group.ranks[0], group=group)
            broadcast(b, src=group.ranks[1], group=group)
            p.data.copy_(b if group.rank == 0 else a)


def _bits_sha(t):
    import hashlib
    return hashlib.sha256(_bits(t).cpu().numpy().tobytes()).hexdigest()[:16]


def _hybrid_rank(dp, mp, layers, backend, planted, bf16):
    """One rank of (b), (c) or (d): f32 steps at dp x mp (dropout 0,
    AdamW and the clip) from seed 0's weights; with ``planted``, one step
    after the mp ranks traded shards; with ``bf16``, O2 bf16 steps at
    dropout 0.1 and the replicated parameters' bit hashes."""
    from paddle_tpu_torch.distributed import (fleet, init_parallel_env,
                                              rank_device, unwrap_model)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import is_shard
    from paddle_tpu_torch.train import build_train_step, make_batch
    init_parallel_env(backend, device=DEVICE)
    dev = rank_device()
    capture = backend == "nccl"
    cfg = _hybrid_cfg(layers, dropout=False)
    ids, labels = make_batch(cfg, HYBRID_BATCH, TRAIN_SEQ, seed=0,
                             device=dev)

    def f32_step():
        return build_train_step(cfg, device=dev, amp_o2=False, fusion=False,
                                dp=dp, mp=mp, capture=capture,
                                optimizer=_hybrid_optimizer())

    step = f32_step()
    hcg = fleet.get_hybrid_communicate_group()
    init = _weights(step)
    n_steps = HYBRID_C_STEPS if layers else HYBRID_STEPS
    losses, times, launches, norms = _hybrid_steps(step, ids, labels,
                                                   n_steps)
    if capture:
        _check_captured("hybrid f32", step, n_steps)
    updates, axes = _updates(step, init)
    res = {"rank": hcg.get_global_rank(),
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "heads": unwrap_model(step.model).gpt.layers[0].attn.num_heads,
           "losses": losses, "times": times, "launches": launches,
           "updates": updates, "axes": axes, "norms": norms}
    del step, init
    _free()
    if planted:
        step = f32_step()
        _swap_shards(step)
        res["planted_loss"] = step(ids, labels).item()
        del step
        _free()
    if bf16:
        step = build_train_step(_hybrid_cfg(layers), device=dev,
                                fusion=False, dp=dp, mp=mp, capture=capture)
        b_losses, b_times, b_launches, _ = _hybrid_steps(step, ids, labels,
                                                         HYBRID_STEPS)
        model = unwrap_model(step.model)
        res["bf16"] = {"losses": b_losses, "times": b_times,
                       "launches": b_launches,
                       "replicated": {n: _bits_sha(p) for n, p in
                                      model.named_parameters()
                                      if not is_shard(p)}}
        del step
        _free()
    return res


def _gathered_err(ranks, want, dp_rank=0):
    """``dp_rank``'s mp ranks' updates gathered against the reference's
    (``want``): the max |difference| over every weight (the updated
    weights', since both start from the same ones), and the largest
    2-norm of a tensor's difference over that of its reference update,
    with its name."""
    from paddle_tpu_torch.incubate.models import gather_params
    mine = sorted((r for r in ranks if r["dp_rank"] == dp_rank),
                  key=lambda r: r["mp_rank"])
    full = gather_params([r["updates"] for r in mine], mine[0]["axes"])
    if set(full) != set(want):
        raise AssertionError(f"gathered names {sorted(set(full) ^ set(want))}")
    worst, rel = 0.0, (0.0, None)
    for name, w in want.items():
        if full[name].shape != w.shape:
            raise AssertionError(f"{name}: gathered {full[name].shape}, "
                                 f"want {w.shape}")
        d = full[name] - w
        worst = max(worst, float(np.abs(d).max()))
        r = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30))
        rel = max(rel, (r, name), key=lambda t: t[0])
    return worst, rel


def _check_hybrid_ranks(what, ranks, ref, per_step):
    """The f32 ranks of (b), (c) or (d) against the world-of-one
    reference: losses, the clip's norms, gathered updates, the dp ranks'
    shards, launches."""
    loss_err = max(abs(a - b) for r in ranks
                   for a, b in zip(r["losses"], ref["losses"]))
    param_err, (upd_err, upd_name) = _gathered_err(ranks, ref["updates"])
    # the clip's global norm over the shards, read after every step
    norm_err = max((abs(a - b) / b for r in ranks
                    for a, b in zip(r["norms"], ref["norms"])), default=0.0)
    log(f"[hybrid] {what}: f32 losses {ranks[0]['losses']} against the world "
        f"of one's {ref['losses']}: max |diff| {loss_err:.3e} (tol "
        f"{HYBRID_LOSS_TOL:.0e}); gathered weights max |diff| "
        f"{param_err:.3e} (tol {HYBRID_PARAM_TOL:.0e}); updates' largest "
        f"relative 2-norm diff {upd_err:.3e} ({upd_name}, tol "
        f"{HYBRID_UPDATE_RTOL:.0e}); the clip's global norms "
        f"{ranks[0]['norms']} (world of one {ref['norms']}, max relative "
        f"diff {norm_err:.2e}, tol {HYBRID_NORM_RTOL:.0e}); heads a rank "
        f"{ranks[0]['heads']}")
    n_steps = len(ref["losses"])
    if any(len(r["norms"]) != n_steps for r in [ref, *ranks]) or \
            not norm_err <= HYBRID_NORM_RTOL:
        raise AssertionError(f"{what}: clip norms "
                             f"{[r['norms'] for r in ranks]}, the world of "
                             f"one's {ref['norms']}")
    if not loss_err <= HYBRID_LOSS_TOL or not param_err <= HYBRID_PARAM_TOL \
            or not upd_err <= HYBRID_UPDATE_RTOL:
        raise AssertionError(f"{what}: sharded f32 steps differ from the "
                             f"world of one: losses {loss_err}, weights "
                             f"{param_err}, updates {upd_err} ({upd_name})")
    by = {(r["dp_rank"], r["mp_rank"]): r for r in ranks}
    for (dp, mp), r in by.items():
        if dp and any(not np.array_equal(a, by[0, mp]["updates"][n])
                      for n, a in r["updates"].items()):
            raise AssertionError(f"{what}: dp rank {dp}'s shard {mp} is not "
                                 f"dp rank 0's")
        _check_counts(f"{what} rank {r['rank']}", r["launches"], per_step,
                      n_steps)
    return loss_err, param_err


def phase_hybrid(smi):
    """Data x tensor parallelism on the card (see the module docstring):
    (a) to (d).  Returns ({path: launch counts}, the world-of-one
    process's results: phase 16's (a) and the f32 references)."""
    from paddle_tpu_torch.distributed import spawn
    _free_steps()
    out = {}
    t0 = time.perf_counter()
    [w1] = spawn(_hybrid_world1_rank, args=(HYBRID_BACKEND,), nprocs=1,
                 timeout=HYBRID_TIMEOUT)
    a = w1["a"]
    med = {k: statistics.median(a[k][1:]) * 1e3 for k in ("plain_s",
                                                           "hybrid_s")}
    log(f"[hybrid] (a) {HYBRID_BACKEND} world of 1, every degree 1, O2 bf16, "
        f"dropout 0.1, {HYBRID_BATCH}x{TRAIN_SEQ}: losses {a['hybrid']} "
        f"(plain build_train_step {a['plain']}); state tensors that differ "
        f"{a['differ'][:4]} of {a['n_state']}; generator the same "
        f"{a['same_rng']}; the clip's global norms {a['norms_hybrid']} "
        f"(plain {a['norms_plain']}); capture {a['stats']}; median step "
        f"{med['hybrid_s']:.2f} ms (plain {med['plain_s']:.2f} ms); a "
        f"profiled replay ran {a['profiled']} kernel names, the counters' "
        f"launches; {time.perf_counter() - t0:.1f} s with the references | "
        f"{smi}")
    if a["hybrid"] != a["plain"] or a["differ"] or not a["same_rng"]:
        raise AssertionError(f"hybrid (a): the degree-1 step is not the "
                             f"plain step's bits: losses {a['hybrid']} / "
                             f"{a['plain']}, tensors {a['differ'][:8]}")
    # the norm each replay wrote: the plain step's, a new one every step
    norms = a["norms_hybrid"]
    if norms != a["norms_plain"] or len(set(norms)) != HYBRID_A_STEPS or \
            not all(math.isfinite(v) and v > 0 for v in norms):
        raise AssertionError(f"hybrid (a): the captured clip's norms "
                             f"{norms}, the plain step's "
                             f"{a['norms_plain']}")
    out[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} hybrid dp1 mp1 "
        f"{HYBRID_BACKEND} captured"] = a["launches"]

    full, cut = _hybrid_cfg(), _hybrid_cfg(HYBRID_C_LAYERS)
    t0 = time.perf_counter()
    ranks = spawn(_hybrid_rank, args=(1, 2, HYBRID_C_LAYERS, "gloo", True,
                                      True),
                  nprocs=2, timeout=HYBRID_TIMEOUT)
    _check_hybrid_ranks(f"(b) mp 2 over gloo, {HYBRID_C_LAYERS} layers",
                        ranks, w1["c"], _plain_per_step(cut))
    planted = [abs(r["planted_loss"] - w1["c"]["losses"][0]) for r in ranks]
    log(f"[hybrid] (b) planted fault, the two ranks' shards traded: first "
        f"losses {[r['planted_loss'] for r in ranks]} against "
        f"{w1['c']['losses'][0]}: |diff| {planted}, must exceed "
        f"{HYBRID_LOSS_TOL:.0e}")
    if not min(planted) > HYBRID_LOSS_TOL:
        raise AssertionError("(b): the planted fault passed the comparison")
    bf = [r["bf16"] for r in ranks]
    if not all(math.isfinite(v) for r in bf for v in r["losses"]) or \
            bf[0]["replicated"] != bf[1]["replicated"]:
        raise AssertionError(f"(b) bf16 dropout 0.1: losses "
                             f"{[r['losses'] for r in bf]}, replicated "
                             f"parameters the same bits: "
                             f"{bf[0]['replicated'] == bf[1]['replicated']}")
    for r in ranks:
        _check_counts(f"(b) bf16 rank {r['rank']}", r["bf16"]["launches"],
                      _plain_per_step(cut), HYBRID_STEPS)
    log(f"[hybrid] (b) bf16 O2 dropout 0.1: losses {bf[0]['losses']} (rank "
        f"1 {bf[1]['losses']}); {len(bf[0]['replicated'])} replicated "
        f"parameters the same bits on both ranks; step ms eager, gloo, card "
        f"shared: f32 {[round(t * 1e3, 1) for t in ranks[0]['times']]}, "
        f"bf16 {[round(t * 1e3, 1) for t in bf[0]['times']]}; "
        f"{time.perf_counter() - t0:.1f} s")
    for r in ranks:
        out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x{TRAIN_SEQ} "
            f"mp2 gloo rank {r['rank']} f32"] = r["launches"]
        out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x{TRAIN_SEQ} "
            f"mp2 gloo rank {r['rank']} bf16"] = r["bf16"]["launches"]
    del ranks, bf

    t0 = time.perf_counter()
    ranks = spawn(_hybrid_rank, args=(2, 2, HYBRID_C_LAYERS, "gloo", False,
                                      False),
                  nprocs=4, timeout=HYBRID_TIMEOUT)
    _check_hybrid_ranks(f"(c) dp 2 x mp 2 over gloo, {HYBRID_C_LAYERS} "
                        f"layers", ranks, w1["c"], _plain_per_step(cut))
    log(f"[hybrid] (c) step ms eager, gloo, card shared: "
        f"{[round(t * 1e3, 1) for t in ranks[0]['times']]}; "
        f"{time.perf_counter() - t0:.1f} s")
    out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x{TRAIN_SEQ} dp2 "
        f"mp2 gloo rank 0"] = ranks[0]["launches"]
    del ranks

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= 2:
        t0 = time.perf_counter()
        ranks = spawn(_hybrid_rank, args=(1, 2, None, "nccl", False, False),
                      nprocs=2, timeout=HYBRID_TIMEOUT)
        _check_hybrid_ranks("(d) mp 2 over NCCL, two cards, captured", ranks,
                            w1["b"], _plain_per_step(full))
        log(f"[hybrid] (d) step ms (graph): "
            f"{[round(t * 1e3, 1) for t in ranks[0]['times']]}; "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        log(f"[hybrid] (d) not run: this machine has {cards} card(s); NCCL "
            f"takes one card a rank, so mp 2 over NCCL needs two")
    return out, w1

# -- phase 16: ZeRO and the pipeline ------------------------------------------------

ZP_DEGREES = {
    "b": dict(pp=ZP_PP, virtual_stages=ZP_V, microbatches=ZP_M),
    "c": dict(sharding=2, sharding_level="os_g"),
    "d": dict(mp=2, pp=2, sharding=2, sharding_level="os_g",
              virtual_stages=2),
    "e": dict(pp=ZP_PP, virtual_stages=ZP_V, microbatches=ZP_M),
}


def _stage_per_step(cfg, pp, stage, micro):
    """Launches of one step on pipeline stage ``stage`` of ``pp``: each
    of its blocks runs once a micro-batch (LayerNorm 2, flash 1 each),
    the last stage's ``final_ln`` too."""
    blocks = cfg.num_layers // pp
    ln = (2 * blocks + (stage == pp - 1)) * micro
    return {"layer_norm_fwd": ln, "layer_norm_bwd": ln,
            "layer_norm_fwd.residual": 0, "layer_norm_bwd.residual": 0,
            **{n: blocks * micro for n in FLASH_KERNELS}}


def _upd_diff(got, want):
    """(max |got - want| over every tensor, (the largest relative 2-norm
    of a tensor's difference, its name)), on the card."""
    worst, rel = 0.0, (0.0, None)
    for n, w in want.items():
        d = (got[n] - w).float()
        worst = max(worst, d.abs().max().item())
        r = (d.norm() / w.float().norm().clamp(min=1e-30)).item()
        rel = max(rel, (r, n), key=lambda t: t[0])
    return worst, rel


def _zp_rank(kind, backend, ckpt_root=None):
    """One rank of phase 16's (b), (c), (d) or (e): f32 steps (dropout 0,
    AdamW and the clip) from seed 0's weights at ``ZP_DEGREES[kind]``;
    (b) and (c) then one step with the planted fault against the honest
    first step's updates, and (b) O2 bf16 steps at dropout 0.1.  With
    ``ckpt_root``, phase 18's work on the same ranks: the honest run saves
    after its first step (:func:`_ckpt_save`), and fresh steps resume from
    its files (:func:`_ckpt_resume`)."""
    from paddle_tpu_torch.distributed import (init_parallel_env, rank_device,
                                              unwrap_model)
    from paddle_tpu_torch.distributed.sharding import state_bytes, window
    from paddle_tpu_torch.train import build_train_step, make_batch
    init_parallel_env(backend, device=DEVICE)
    dev = rank_device()
    capture = backend == "nccl"
    layers = HYBRID_C_LAYERS if kind == "d" else None
    degrees = ZP_DEGREES[kind]
    cfg = _hybrid_cfg(layers, dropout=False)
    ids, labels = make_batch(cfg, HYBRID_BATCH, TRAIN_SEQ, seed=0,
                             device=dev)

    def build(amp_o2=False, c=cfg, seed=0):
        return build_train_step(c, device=dev, amp_o2=amp_o2, fusion=False,
                                capture=capture, seed=seed,
                                optimizer=_hybrid_optimizer(bf16=amp_o2),
                                **degrees)

    step = build()
    hcg = step.hcg
    coords = (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
              hcg.get_sharding_parallel_rank(), hcg.get_model_parallel_rank())
    init = _weights(step)
    first, saved = {}, {}
    n_steps = HYBRID_C_STEPS if layers else HYBRID_STEPS

    def after_first():
        first.update(_weights(step))
        if ckpt_root is not None:
            saved.update(_ckpt_save(step, os.path.join(ckpt_root, kind)))

    losses, times, launches, norms = _hybrid_steps(
        step, ids, labels, n_steps, after_first=after_first)
    if capture:
        _check_captured(f"zero-pipeline ({kind})", step, n_steps)
    ckpt = None
    if ckpt_root is not None:
        ckpt = _ckpt_after(step, saved, losses)
    updates, axes = _updates(step, init)
    first = {n: first[n] - init[n] for n in first}
    micro = step.engine.M if step.engine is not None else 1
    res = {"coords": coords, "rank": hcg.get_global_rank(),
           "losses": losses, "times": times, "launches": launches,
           "norms": norms, "axes": axes, "micro": micro,
           "pp": hcg.get_pipe_parallel_world_size(),
           "heads": next(m for m in unwrap_model(step.model).gpt.layers
                         if hasattr(m, "attn")).attn.num_heads,
           "state_bytes": state_bytes(step.state),
           # AdamW's two f32 slots of every parameter the rank holds
           # whole: the world of one's state for them
           "whole_bytes": sum(p.numel() * 4 * 2
                              for p in step.params.values()),
           "param_sha": {n: _bits_sha(p) for n, p in step.params.items()}}
    if coords[0] == 0 and coords[2] == 0:     # data rank 0 ships its updates
        res["updates"] = updates
    del step, updates
    _free()
    if ckpt is not None:
        res["ckpt"] = _ckpt_resume(ckpt, build, ids, labels, n_steps)
    if kind == "b":
        # a micro-batch's gradient dropped: the last virtual stage passes
        # no gradient back for micro-batch 2 of each step
        step = build()
        net = unwrap_model(step.model)
        last, calls, chunk = net.pipeline[0] * net.pipeline[2] - 1, [0], \
            net.forward_chunk

        def dropping(k, x, generator=None):
            y = chunk(k, x, generator=generator)
            if k == last:
                calls[0] += 1
                if calls[0] % step.engine.M == 2:
                    y = y.detach() + (y - y.detach()) * 0
            return y

        net.forward_chunk = dropping
    elif kind == "c":
        # the two ranks' ZeRO windows traded
        step = build()
        z = step.zero
        z.views = {k: (window(p.data, z.dims[k], z.n, z.n - 1 - z.rank)
                       if k in z.dims else p) for k, p in z.params.items()}
    else:
        step = None
    if step is not None:
        start = _weights(step)
        p_loss = step(ids, labels).item()
        p_norm = step.optimizer._grad_clip.last_norm.item()
        got = {n: t - start[n] for n, t in _weights(step).items()}
        res["planted"] = {"loss": p_loss, "norm": p_norm,
                          "diff": _upd_diff(got, first)}
        del step, start, got
    del first, init
    _free()
    if kind == "b":
        step = build(amp_o2=True, c=_hybrid_cfg(layers))
        b_losses, b_times, b_launches, _ = _hybrid_steps(step, ids, labels,
                                                         HYBRID_STEPS)
        res["bf16"] = {"losses": b_losses, "times": b_times,
                       "launches": b_launches,
                       "word": _bits_sha(step.params[ZP_WORD])
                       if ZP_WORD in step.params else None}
        del step
        _free()
    return res


def _zp_gathered(ranks):
    """The updates of data rank 0's ranks: stages' names joined, mp
    slices concatenated, as numpy by name."""
    parts = {}
    for r in ranks:
        if "updates" not in r:
            continue
        mp = r["coords"][3]
        for n, a in r["updates"].items():
            parts.setdefault(n, {})[mp] = (a, r["axes"][n])
    out = {}
    for n, by_mp in parts.items():
        axis = by_mp[0][1]
        out[n] = by_mp[0][0] if axis is None else np.concatenate(
            [by_mp[m][0] for m in sorted(by_mp)], axis)
    return out


def _check_zp(what, ranks, ref, per_step, tag="zero-pipeline"):
    """The f32 ranks of (b)-(e) against their world-of-one reference, as
    phase 15 holds its runs: losses, the clip's norms, the gathered
    updates; each rank's launches (``per_step(rank)``); the sharding
    ranks' parameters the same bits."""
    loss_err = max(abs(a - b) for r in ranks
                   for a, b in zip(r["losses"], ref["losses"]))
    norm_err = max((abs(a - b) / b for r in ranks
                    for a, b in zip(r["norms"], ref["norms"])), default=0.0)
    full = _zp_gathered(ranks)
    if set(full) != set(ref["updates"]):
        raise AssertionError(f"{what}: gathered names "
                             f"{sorted(set(full) ^ set(ref['updates']))[:6]}")
    worst, rel = 0.0, (0.0, None)
    for name, w in ref["updates"].items():
        if full[name].shape != w.shape:
            raise AssertionError(f"{what}: {name} gathered "
                                 f"{full[name].shape}, want {w.shape}")
        d = full[name] - w
        worst = max(worst, float(np.abs(d).max()))
        r = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30))
        rel = max(rel, (r, name), key=lambda t: t[0])
    log(f"[{tag}] {what}: f32 losses {ranks[0]['losses']} against "
        f"the world of one's {ref['losses']}: max |diff| {loss_err:.3e} (tol "
        f"{HYBRID_LOSS_TOL:.0e}); gathered updates max |diff| {worst:.3e} "
        f"(tol {HYBRID_PARAM_TOL:.0e}), largest relative 2-norm diff "
        f"{rel[0]:.3e} ({rel[1]}, tol {HYBRID_UPDATE_RTOL:.0e}); the clip's "
        f"norms {ranks[0]['norms']} (world of one {ref['norms']}, max "
        f"relative diff {norm_err:.2e}, tol {HYBRID_NORM_RTOL:.0e}); heads a "
        f"rank {ranks[0]['heads']}; step ms eager, gloo, card shared "
        f"{[round(t * 1e3, 1) for t in ranks[0]['times']]}")
    n_steps = len(ref["losses"])
    if any(len(r["norms"]) != n_steps for r in ranks) or \
            not norm_err <= HYBRID_NORM_RTOL or \
            not loss_err <= HYBRID_LOSS_TOL or \
            not worst <= HYBRID_PARAM_TOL or not rel[0] <= HYBRID_UPDATE_RTOL:
        raise AssertionError(f"{what}: against the world of one: losses "
                             f"{loss_err}, norms {norm_err}, updates {worst}, "
                             f"{rel}")
    by = {r["coords"]: r for r in ranks}
    for (dp, s, sh, mp), r in by.items():
        if sh and r["param_sha"] != by[(dp, s, 0, mp)]["param_sha"]:
            raise AssertionError(f"{what}: sharding rank {sh}'s parameters "
                                 f"are not sharding rank 0's")
        _check_counts(f"{what} rank {r['rank']}", r["launches"], per_step(r),
                      n_steps)


def _check_planted(what, ranks, fault):
    """The planted fault's first step against the honest run's first
    step: its updates must miss the bound the honest run is held to."""
    worst = [r["planted"]["diff"] for r in ranks]
    log(f"[zero-pipeline] {what} planted fault, {fault}: first-step updates "
        f"against the honest first step's: max |diff| "
        f"{[round(w[0], 8) for w in worst]}, relative "
        f"{[(round(w[1][0], 4), w[1][1]) for w in worst]}; norms "
        f"{[r['planted']['norm'] for r in ranks]} against "
        f"{[r['norms'][0] for r in ranks]}; must exceed "
        f"{HYBRID_UPDATE_RTOL:.0e} relative")
    if not all(w[1][0] > HYBRID_UPDATE_RTOL for w in worst):
        raise AssertionError(f"{what}: the planted fault ({fault}) passed "
                             f"the comparison")


# -- phase 18: sharded checkpoints (on phase 16's ranks) -------------------------

def _ckpt_save(step, root):
    """Save ``step`` as step 1 under ``root/sync`` (synchronously) and
    ``root/async`` (through an asynchronous manager, waited for later):
    {"sync_s", "async_s": the seconds until save returned, "manager",
    "windows": this rank's windows as saved, "bytes": what it wrote}."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.distributed.checkpoint import rank_payload_bytes
    from paddle_tpu_torch.train import save_checkpoint
    t0 = time.perf_counter()
    save_checkpoint(CheckpointManager(os.path.join(root, "sync")), 1, step,
                    block=True)
    sync_s = time.perf_counter() - t0
    mgr = CheckpointManager(os.path.join(root, "async"), async_save=True)
    t0 = time.perf_counter()
    save_checkpoint(mgr, 1, step)
    async_s = time.perf_counter() - t0
    return {"root": root, "sync_s": sync_s, "async_s": async_s,
            "manager": mgr, "windows": _tree_windows(step),
            "bytes": rank_payload_bytes(os.path.join(
                root, "sync", "step_00000001"), step.hcg.get_global_rank())}


def _bits_digest(t):
    """An exact digest of ``t``'s bits computed on its device: the sum
    modulo 2^64 of each element's bits times its index + 1 (any changed,
    lost or moved element changes it), with the element count."""
    b = _bits(t).reshape(-1).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64)
    return (b.numel(), int((b * w).sum()))


def _tree_windows(step):
    """Every window of ``step``'s params and optimizer state (replicas
    too): [(leaf path, window, global shape, bits digest)]."""
    from paddle_tpu_torch.distributed.checkpoint import ShardWindow, \
        _flat_items
    tree = step.checkpoint_tree()
    out = []
    for path, w in _flat_items({"params": tree["params"],
                                "opt_tree": tree["opt_tree"]}):
        if isinstance(w, ShardWindow):
            out.append((path, w.window, w.global_shape,
                        _bits_digest(w.tensor())))
    return out


def _ckpt_after(step, saved, losses):
    """After the uninterrupted run: the async save waited for, and the
    state's bits (every tensor, the generators)."""
    from paddle_tpu_torch.distributed.checkpoint_layout import generators_of
    t0 = time.perf_counter()
    saved["manager"].wait()
    return {**{k: saved[k] for k in ("root", "sync_s", "async_s", "windows",
                                     "bytes")},
            "losses": losses, "async_wait_s": time.perf_counter() - t0,
            "state": {n: _bits_sha(t) for n, t in _step_state(step).items()},
            "generators": [_bits_sha(g.get_state())
                           for g in generators_of(step)]}


def _ckpt_resume(ck, build, ids, labels, n_steps):
    """A fresh step (seed 1) restored from each of the run's checkpoints
    runs the steps left: {mode: (restore seconds, losses, the tensors and
    generators whose bits differ from the uninterrupted run's, launches,
    step seconds)}."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.distributed.checkpoint_layout import generators_of
    from paddle_tpu_torch.train import restore_checkpoint
    out = {}
    for mode in ("sync", "async"):
        fresh = build(seed=1)
        t0 = time.perf_counter()
        n = restore_checkpoint(CheckpointManager(
            os.path.join(ck["root"], mode)), fresh)
        restore_s = time.perf_counter() - t0
        losses, times, launches, _ = _hybrid_steps(fresh, ids, labels,
                                                   n_steps - 1)
        state = {k: _bits_sha(t) for k, t in _step_state(fresh).items()}
        gens = [_bits_sha(g.get_state()) for g in generators_of(fresh)]
        out[mode] = {"step": n, "restore_s": restore_s,
                     "losses": ck["losses"][:1] + losses, "times": times,
                     "launches": launches,
                     "differ": [k for k in ck["state"]
                                if state.get(k) != ck["state"][k]],
                     "generators": gens == ck["generators"]}
        del fresh
        _free()
    return {**{k: ck[k] for k in ("losses", "sync_s", "async_s",
                                  "async_wait_s", "windows", "bytes")},
            **out}


def _w1_leaf(tree, path, shape):
    """A world-of-one tree's tensor for a sharded leaf ``path`` of
    ``shape``: a ``__ppstack__`` leaf stacked from its blocks."""
    node = tree
    for k in path[:-1]:
        node = node[k]
    name = path[-1]
    if not name.startswith("__ppstack__."):
        return node[name]
    loc = name[len("__ppstack__."):]
    n = int(np.prod(shape[:len(shape) - node[f"gpt.layers.0.{loc}"].dim()]))
    return torch.stack([node[f"gpt.layers.{i}.{loc}"]
                        for i in range(n)]).reshape(shape)


def _ckpt_world_of_one(step, what, root, ranks):
    """The world-of-one f32 ``step`` restores the ranks' checkpoint at
    ``root``: every window of every rank the same bits in its tensors.
    Returns (restore seconds, windows checked)."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.train import restore_checkpoint
    t0 = time.perf_counter()
    n = restore_checkpoint(CheckpointManager(root), step)
    restore_s = time.perf_counter() - t0
    tree = step.checkpoint_tree()
    tree = {"params": tree["params"], "opt_tree": tree["opt_tree"]}
    bad, checked = [], 0
    for r in ranks:
        for path, win, shape, digest in r["ckpt"]["windows"]:
            t = _w1_leaf(tree, path, shape)
            got = _bits_digest(t[tuple(slice(a, b) for a, b in win)])
            checked += 1
            if got != tuple(digest):
                bad.append((path, win))
    if n != 1 or bad:
        raise AssertionError(f"sharded-ckpt {what}: the world of one restored "
                             f"step {n}; windows whose bits differ "
                             f"{bad[:4]} of {checked}")
    return restore_s, checked


def _w1_bytes(step):
    """The world of one's bytes of params and optimizer state, and those
    of one block."""
    tree = step.checkpoint_tree()
    leaves = [(p, t.numel() * t.element_size()) for p, t in _flat_leaves(
        {"params": tree["params"], "opt_tree": tree["opt_tree"]})]
    return (sum(b for _, b in leaves),
            sum(b for p, b in leaves if p[-1].startswith("gpt.layers.0.")))


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, path + (k,))
    else:
        yield path, tree


def _check_ckpt(what, ranks, per_step, world_bytes=None):
    """Phase 18's checks of one run: each resume the uninterrupted bits,
    its launches; the ranks' bytes against the world of one's."""
    for r in ranks:
        ck = r["ckpt"]
        for mode in ("sync", "async"):
            m = ck[mode]
            if m["step"] != 1 or m["losses"] != ck["losses"] or \
                    m["differ"] or not m["generators"]:
                raise AssertionError(
                    f"sharded-ckpt {what} rank {r['rank']} {mode}: restored "
                    f"step {m['step']}, losses {m['losses']} against "
                    f"{ck['losses']}, tensors that differ {m['differ'][:4]}, "
                    f"generators the same {m['generators']}")
            _check_counts(f"sharded-ckpt {what} rank {r['rank']} {mode}",
                          m["launches"], per_step(r), len(ck["losses"]) - 1)
    total = sum(r["ckpt"]["bytes"] for r in ranks)
    ck = ranks[0]["ckpt"]
    log(f"[sharded-ckpt] {what}: save s sync "
        f"{[round(r['ckpt']['sync_s'], 2) for r in ranks]}, async (until "
        f"save returned) {[round(r['ckpt']['async_s'], 2) for r in ranks]} "
        f"+ waited {[round(r['ckpt']['async_wait_s'], 2) for r in ranks]}; "
        f"restore s sync {[round(r['ckpt']['sync']['restore_s'], 2) for r in ranks]}, "
        f"async {[round(r['ckpt']['async']['restore_s'], 2) for r in ranks]}; "
        f"resumed losses {ck['sync']['losses']} = uninterrupted "
        f"{ck['losses']}; every state tensor and generator the same bits "
        f"on every rank; bytes written a rank "
        f"{[r['ckpt']['bytes'] for r in ranks]}, sum {total}"
        + ("" if world_bytes is None else
           f" (the world of one's {world_bytes})")
        + "; launches in the resumed steps (sync) by rank: "
        + "; ".join(f"{r['rank']}: " + ", ".join(
            f"{k} {r['ckpt']['sync']['launches'][k]}"
            for k in FLASH_KERNELS + LN_KERNELS) for r in ranks))
    if world_bytes is not None and total != world_bytes:
        raise AssertionError(f"sharded-ckpt {what}: the ranks wrote {total} "
                             f"bytes of windows, the world of one holds "
                             f"{world_bytes}")


def phase_zero_pipeline(smi, w1):
    """ZeRO and the pipeline on the card (see the module docstring): (a)
    from phase 15's world-of-one process, then (b) to (e), and on the
    ranks of (b), (c) and (d) phase 18's sharded checkpoints.  Returns
    ({path: launch counts}, {path: launch counts} of phase 18's resumed
    steps)."""
    from paddle_tpu_torch.distributed import spawn
    _free_steps()
    out = {}
    a = w1["a16"]
    med = statistics.median(a["times"][1:]) * 1e3
    log(f"[zero-pipeline] (a) {HYBRID_BACKEND} world of 1, pp = sharding = "
        f"1 with ZeRO level {a['level']} set by the strategy (no ZeRO plan "
        f"made: {not a['zero']}), O2 bf16, dropout 0.1, {HYBRID_BATCH}x"
        f"{TRAIN_SEQ}: losses {a['losses']} (plain {a['plain']}); state "
        f"tensors that differ {a['differ'][:4]}; generator the same "
        f"{a['same_rng']}; norms {a['norms']}; capture {a['stats']}; median "
        f"step {med:.2f} ms; a profiled replay ran {a['profiled']} kernel "
        f"names, the counters' launches; {a['seconds']:.1f} s | {smi}")
    if a["losses"] != a["plain"] or a["differ"] or not a["same_rng"] or \
            a["norms"] != a["norms_plain"] or a["level"] != "os_g" or \
            a["zero"]:
        raise AssertionError(f"zero-pipeline (a): the degree-1 step with "
                             f"os_g is not the plain step's bits: "
                             f"{a['losses']} / {a['plain']}, "
                             f"{a['differ'][:8]}")
    out[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} zero os_g pp1 sharding1 "
        f"{HYBRID_BACKEND} captured"] = a["launches"]
    full, cut = _hybrid_cfg(), _hybrid_cfg(HYBRID_C_LAYERS)

    def per_stage(cfg):
        return lambda r: _stage_per_step(cfg, r["pp"], r["coords"][1],
                                         r["micro"])

    import tempfile
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    # (b)'s kept checkpoint beside (c)'s two, GPT-345m's f32 state each
    # (AdamW's two moments beside the weights)
    n_params = 355_000_000
    _need_disk("sharded-ckpt", ckpt_root, 3 * 3 * 4 * n_params)
    resumed, ck_secs = {}, []

    def ckpt_secs(ranks):
        """The seconds phase 18 added to a run's ranks (rank 0's)."""
        ck = ranks[0]["ckpt"]
        return (ck["sync_s"] + ck["async_s"] + ck["async_wait_s"] +
                sum(ck[m]["restore_s"] + sum(ck[m]["times"])
                    for m in ("sync", "async")))

    t0 = time.perf_counter()
    ranks = spawn(_zp_rank, args=("b", "gloo", ckpt_root), nprocs=ZP_PP,
                  timeout=HYBRID_TIMEOUT)
    shutil.rmtree(os.path.join(ckpt_root, "b", "async"), ignore_errors=True)
    _check_zp(f"(b) pp {ZP_PP}, v {ZP_V}, M {ZP_M} over gloo", ranks,
              w1["b"], per_stage(full))
    ranks_b = ranks
    for r in ranks_b:
        r.pop("updates", None)
    for r in ranks_b:
        resumed[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} pp{ZP_PP} v{ZP_V} "
                f"M{ZP_M} gloo stage {r['coords'][1]} resumed"] = \
            r["ckpt"]["sync"]["launches"]
    _check_planted("(b)", ranks, "micro-batch 2's gradient dropped")
    bf = [r["bf16"] for r in ranks]
    words = [b["word"] for b in bf]
    log(f"[zero-pipeline] (b) bf16 O2 dropout 0.1: losses {bf[0]['losses']} "
        f"(stage 1 {bf[1]['losses']}); the tied word embedding's bits "
        f"{words}; step ms {[round(t * 1e3, 1) for t in bf[0]['times']]}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) for b in bf for v in b["losses"]) or \
            words[0] is None or words[0] != words[-1]:
        raise AssertionError(f"(b) bf16: losses {[b['losses'] for b in bf]}, "
                             f"tied embedding bits {words}")
    for r in ranks:
        s = r["coords"][1]
        _check_counts(f"(b) bf16 stage {s}", r["bf16"]["launches"],
                      per_stage(full)(r), HYBRID_STEPS)
        out[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} pp{ZP_PP} v{ZP_V} "
            f"M{ZP_M} gloo stage {s} f32"] = r["launches"]
        out[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} pp{ZP_PP} v{ZP_V} "
            f"M{ZP_M} gloo stage {s} bf16"] = r["bf16"]["launches"]
    del ranks, bf

    t0 = time.perf_counter()
    ranks = spawn(_zp_rank, args=("c", "gloo", ckpt_root), nprocs=2,
                  timeout=HYBRID_TIMEOUT)
    shutil.rmtree(os.path.join(ckpt_root, "c", "async"), ignore_errors=True)
    _check_zp("(c) sharding 2 at os_g over gloo", ranks, w1["b"],
              lambda r: _plain_per_step(full))
    # (b)'s and (c)'s kept files into one world-of-one step here
    t0 = time.perf_counter()
    from paddle_tpu_torch.train import build_train_step
    one = build_train_step(_hybrid_cfg(dropout=False), device=DEVICE,
                           amp_o2=False, fusion=False, seed=1, capture=False,
                           optimizer=_hybrid_optimizer())
    w1_bytes, block_bytes = _w1_bytes(one)
    for kind, what, rk in (("b", f"(b) pp {ZP_PP} x v {ZP_V}", ranks_b),
                           ("c", "(c) sharding 2 at os_g", ranks)):
        got = _ckpt_world_of_one(one, what, os.path.join(
            ckpt_root, kind, "sync"), rk)
        shutil.rmtree(os.path.join(ckpt_root, kind), ignore_errors=True)
        log(f"[sharded-ckpt] {what} into a world of one on the card: "
            f"restored in {got[0]:.2f} s, {got[1]} windows of the ranks "
            f"the same bits")
    del one
    _free()
    ck_secs.append(time.perf_counter() - t0)
    log(f"[sharded-ckpt] the world of one's build, two restores and checks "
        f"{ck_secs[-1]:.1f} s")
    _check_ckpt(f"(b) pp {ZP_PP} x v {ZP_V} x M {ZP_M}", ranks_b,
                per_stage(full), w1_bytes)
    _check_ckpt("(c) sharding 2 at os_g", ranks,
                lambda r: _plain_per_step(full), w1_bytes)
    ck_secs.extend([ckpt_secs(ranks_b), ckpt_secs(ranks)])
    resumed[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} sharding2 os_g gloo rank 0 "
            f"resumed"] = ranks[0]["ckpt"]["sync"]["launches"]
    _check_planted("(c)", ranks, "the two ranks' windows traded")
    shares = [r["state_bytes"] / r["whole_bytes"] for r in ranks]
    log(f"[zero-pipeline] (c) optimizer-state bytes a rank "
        f"{[r['state_bytes'] for r in ranks]} against the world of one's "
        f"{ranks[0]['whole_bytes']}: {[round(x, 4) for x in shares]} (at most "
        f"{ZP_STATE_SHARE}); {time.perf_counter() - t0:.1f} s")
    if not max(shares) <= ZP_STATE_SHARE:
        raise AssertionError(f"(c): optimizer state shares {shares}")
    out[f"gpt_345m {HYBRID_BATCH}x{TRAIN_SEQ} sharding2 os_g gloo rank 0"] = \
        ranks[0]["launches"]
    del ranks

    t0 = time.perf_counter()
    ranks = spawn(_zp_rank, args=("d", "gloo", ckpt_root), nprocs=8,
                  timeout=HYBRID_TIMEOUT)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    _check_zp(f"(d) mp 2 x pp 2 x sharding 2 at os_g, v 2, "
              f"{HYBRID_C_LAYERS} layers, over gloo", ranks, w1["c"],
              per_stage(cut))
    _check_ckpt(f"(d) mp 2 x pp 2 x sharding 2, {HYBRID_C_LAYERS} layers",
                ranks, per_stage(cut),
                w1_bytes - (full.num_layers - cut.num_layers) * block_bytes)
    ck_secs.append(ckpt_secs(ranks))
    for r in ranks:
        if r["coords"][0] == r["coords"][2] == r["coords"][3] == 0:
            resumed[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x"
                    f"{TRAIN_SEQ} mp2 pp2 sharding2 gloo stage "
                    f"{r['coords'][1]} resumed"] = r["ckpt"]["sync"]["launches"]
    log(f"[zero-pipeline] (d) {time.perf_counter() - t0:.1f} s")
    log(f"[time] sharded-ckpt {sum(ck_secs):.1f} s (saves, restores and "
        f"resumed steps on rank 0 of (b), (c), (d), and the world of one's "
        f"restores; budget 100 s)")
    for r in ranks:
        if r["coords"][0] == r["coords"][2] == r["coords"][3] == 0:
            out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x"
                f"{TRAIN_SEQ} mp2 pp2 sharding2 gloo stage "
                f"{r['coords'][1]}"] = r["launches"]
    del ranks

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= 2:
        t0 = time.perf_counter()
        ranks = spawn(_zp_rank, args=("e", "nccl"), nprocs=ZP_PP,
                      timeout=HYBRID_TIMEOUT)
        _check_zp(f"(e) pp {ZP_PP} over NCCL, captured", ranks, w1["b"],
                  per_stage(full))
        log(f"[zero-pipeline] (e) {time.perf_counter() - t0:.1f} s")
    else:
        log(f"[zero-pipeline] (e) not run: this machine has {cards} card(s); "
            f"NCCL takes one card a rank, so pp {ZP_PP} over NCCL needs "
            f"{ZP_PP}")
    return out, resumed


# -- phase 17: sequence parallelism ---------------------------------------------


def _sep_kernel_checks(gen):
    """Rows 1-3 against their plain versions at each of the ring's shifts
    on a 512-row block, with that ring step's hash base, at both dropouts:
    the wgmma kernels (bf16, D 64 and 128) and the mma.sync ones (f32).
    Returns the rows."""
    rows = []
    for tag, shape in (("bf16", (HYBRID_BATCH, 512, 16, 64)),
                       ("bf16", (HYBRID_BATCH, 512, 8, 128)),
                       ("f32", (HYBRID_BATCH, 512, 16, 64))):
        for shift, (r0, c0) in SEP_SHIFTS.items():
            for p in FLASH_DROPOUTS:
                rows.append(_flash_entries(
                    None, gen, tag, shape, True, False, causal_shift=shift,
                    dropout=p, hash_base=(r0, c0, 0, 0)))
    return rows


def _sep_attention(r, n):
    """(a) on sep rank ``r`` of ``n``: ring and Ulysses attention on this
    rank's shard of one (B, H, S, D) batch against the world of one's
    flash kernels (``pallas_ops.mha``) on the whole of it; the ring with
    its masked blocks computed; the launches of each ring run."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention, ulysses_attention)
    from paddle_tpu_torch.ops import pallas_ops as po
    from paddle_tpu_torch.ops import reset_launch_counts
    b, h, s, d = HYBRID_BATCH, 16, TRAIN_SEQ, 64
    sl = s // n
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=DEVICE)
    res, launches = {}, {}

    def run(fn, q, k, v, do, **kw):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = fn(q, k, v, **kw)
        o.backward(do)
        return [o.detach(), q.grad, k.grad, v.grad]

    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=DEVICE
                                   ).to(dtype) for _ in range(4))
        mine = [t[:, :, r * sl:(r + 1) * sl] for t in (q, k, v, do)]
        for p in FLASH_DROPOUTS:
            full = run(po.mha, q, k, v, do, causal=True, dropout_p=p,
                       seed=seed)
            want = [t[:, :, r * sl:(r + 1) * sl] for t in full]
            for kind, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                torch.cuda.synchronize()
                reset_launch_counts()
                got = run(fn, *mine, causal=True, dropout_p=p, seed=seed)
                torch.cuda.synchronize()
                launches[kind, tag, p] = _launch_counts()
                errs = {}
                for key, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                    err = (g.float() - w.float()).abs()
                    t = SEP_TOL[tag]
                    bound = t["abs"] + t["rel"] * w.float().abs() \
                        if tag == "bf16" else \
                        (t["abs"] if key == "out" else t["grad"])
                    errs[key] = (err.max().item(),
                                 bool(torch.isfinite(g.float()).all()) and
                                 bool((err <= bound).all()))
                res[kind, tag, p] = errs
                if kind == "ring":
                    again = run(fn, *mine, causal=True, dropout_p=p,
                                seed=seed, skip_masked=False)
                    res["computed", tag, p] = all(
                        torch.equal(a, c) for a, c in zip(got, again))
            del full, want
    return res, launches


def _sep_packed(r, n):
    """(d) on sep rank ``r``: bench_packed's sequences, this rank's heads
    against the whole run's head slice, out and gradients."""
    from paddle_tpu_torch.ops import pallas_ops as po
    from paddle_tpu_torch.ops import reset_launch_counts
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    lens = PACKED_LENS
    cu = [0]
    for x in lens:
        cu.append(cu[-1] + x)
    h, d = PACKED_HEADS, PACKED_HD
    q, k, v, do = (torch.randn(cu[-1], h, d, generator=gen, device=DEVICE
                               ).to(torch.bfloat16) for _ in range(4))

    def run(q, k, v, do):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = po.mha_packed(q, k, v, cu, cu, causal=True)
        o.backward(do)
        return [o.detach(), q.grad, k.grad, v.grad]

    full = run(q, k, v, do)
    hs = slice(r * h // n, (r + 1) * h // n)
    torch.cuda.synchronize()
    reset_launch_counts()
    mine = run(*(t[:, hs] for t in (q, k, v, do)))
    torch.cuda.synchronize()
    launches = _launch_counts()
    same = {key: torch.equal(g, w[:, hs]) for key, g, w in
            zip(("out", "dq", "dk", "dv"), mine, full)}
    return same, launches


def _sep_per_step(cfg, sep_rank):
    """Launches of one sep step on sep rank ``sep_rank``: the LayerNorms
    of an unfused step, and each flash kernel once a block the ring
    computes (``sep_rank + 1`` of them, causal) a layer."""
    return dict(_plain_per_step(cfg),
                **{nm: cfg.num_layers * (sep_rank + 1)
                   for nm in FLASH_KERNELS})


def _sep_rank(kind, backend):
    """One rank of phase 17: ``kind`` "abd" runs (a), (b) and (d) at sep
    2; "c" the eight-rank mesh of (c)."""
    from paddle_tpu_torch.distributed import (fleet, init_parallel_env,
                                              rank_device, unwrap_model)
    from paddle_tpu_torch.distributed.sharding import state_bytes
    from paddle_tpu_torch.train import build_train_step, make_batch
    init_parallel_env(backend, device=DEVICE)
    dev = rank_device()
    res = {}
    if kind == "abd":
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"sep_degree": SEP_DEGREE}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        r = hcg.get_sep_parallel_rank()
        t0 = time.perf_counter()
        res["a"], res["a_launches"] = _sep_attention(r, SEP_DEGREE)
        res["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["d"], res["d_launches"] = _sep_packed(r, SEP_DEGREE)
        res["d_s"] = time.perf_counter() - t0
        _free()
        runs = (("b", _hybrid_cfg(HYBRID_C_LAYERS, dropout=False), False),
                ("b_attn", _attn_dropout_cfg(HYBRID_C_LAYERS), False),
                ("b_bf16", _hybrid_cfg(HYBRID_C_LAYERS), True))
        degrees = dict(sep=SEP_DEGREE)
    else:
        runs = (("c", _hybrid_cfg(HYBRID_C_LAYERS, dropout=False), False),)
        degrees = dict(mp=2, sharding=2, sep=SEP_DEGREE,
                       sharding_level="os_g")
    for key, cfg, bf16 in runs:
        t0 = time.perf_counter()
        ids, labels = make_batch(cfg, HYBRID_BATCH, TRAIN_SEQ, seed=0,
                                 device=dev)
        step = build_train_step(cfg, device=dev, amp_o2=bf16, fusion=False,
                                capture=False,
                                optimizer=_hybrid_optimizer(bf16=bf16),
                                **degrees)
        hcg = step.hcg
        init = _weights(step)
        n_steps = HYBRID_C_STEPS if key == "c" else HYBRID_STEPS
        losses, times, launches, norms = _hybrid_steps(step, ids, labels,
                                                       n_steps)
        run = {"losses": losses, "times": times, "launches": launches,
               "norms": norms, "rank": hcg.get_global_rank(),
               "sep_rank": hcg.get_sep_parallel_rank(),
               "coords": (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                          hcg.get_sharding_parallel_rank(),
                          hcg.get_model_parallel_rank()),
               "pp": 1, "micro": 1,
               "heads": unwrap_model(step.model).gpt.layers[0].attn
               .num_heads,
               "param_sha": {n: _bits_sha(p)
                             for n, p in step.params.items()}}
        if not bf16:
            updates, axes = _updates(step, init)
            run["axes"] = axes
            if run["coords"][0] == run["coords"][2] == 0:
                run["updates"] = updates
            del updates
        if key == "c":
            run["state_bytes"] = state_bytes(step.state)
            run["whole_bytes"] = sum(p.numel() * 4 * 2
                                     for p in step.params.values())
        run["seconds"] = time.perf_counter() - t0
        res[key] = run
        del step, init
        _free()
    return res


def phase_sep(smi, w1):
    """Sequence parallelism on the card (see the module docstring): (a)
    to (d).  ``w1``: phase 15's world-of-one results (the f32
    references).  Returns {path: launch counts}."""
    from paddle_tpu_torch.distributed import spawn
    _free_steps()
    out = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    rows = _sep_kernel_checks(gen)
    worst = {}
    for row in rows:
        for name, r in row.items():
            worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
    log(f"[sep] rows 1-3 at the ring's shifts {sorted(SEP_SHIFTS)} with "
        f"their hash bases, bf16 D 64 and 128 (wgmma) and f32 (mma.sync), "
        f"dropout {FLASH_DROPOUTS}: {len(rows)} checks against the plain "
        f"versions passed, the same bits over two runs; max |err| "
        f"{ {k: f'{v:.3e}' for k, v in worst.items()} }; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ranks = spawn(_sep_rank, args=("abd", "gloo"), nprocs=SEP_DEGREE,
                  timeout=HYBRID_TIMEOUT)
    ranks.sort(key=lambda x: x["b"]["sep_rank"])
    # (a)
    for i, r in enumerate(ranks):
        bad = [(key, k) for key, errs in r["a"].items()
               if key[0] != "computed" for k, (_, ok) in errs.items()
               if not ok]
        computed = {key: v for key, v in r["a"].items()
                    if key[0] == "computed"}
        ring = {f"{t} {p}": {n: c for n, c in v.items() if c}
                for (kd, t, p), v in r["a_launches"].items() if kd == "ring"}
        log(f"[sep] (a) rank {i}, {HYBRID_BATCH} x {TRAIN_SEQ}, 16 heads of "
            f"64, causal, shard of {TRAIN_SEQ // SEP_DEGREE}: "
            + "; ".join(f"{kind} {tag} dropout {p}: " + " ".join(
                f"{k} {e:.3e}" for k, (e, _) in errs.items())
                for (kind, tag, p), errs in r["a"].items()
                if kind != "computed")
            + f" (tol {SEP_TOL}); the ring with its masked blocks computed "
            f"the same bits: {computed}; ring launches {ring}; "
            f"{r['a_s']:.1f} s")
        if bad or not all(computed.values()):
            raise AssertionError(f"sep (a) rank {i}: {bad} beyond SEP_TOL, "
                                 f"or masked blocks computed differ: "
                                 f"{computed}")
        for (kind, tag, p), counts in r["a_launches"].items():
            want = {"ring": i + 1, "ulysses": 1}[kind]
            if any(counts[n] != want for n in FLASH_KERNELS):
                raise AssertionError(f"sep (a) rank {i} {kind} {tag} {p}: "
                                     f"launches {counts}, want {want} each")
            out[f"{kind} attention sep{SEP_DEGREE} {HYBRID_BATCH}x"
                f"{TRAIN_SEQ} {tag} dropout {p} gloo rank {i}"] = counts
    # (d)
    for i, r in enumerate(ranks):
        log(f"[sep] (d) rank {i}: packed {PACKED_PATH}, heads "
            f"{i * PACKED_HEADS // SEP_DEGREE}..."
            f"{(i + 1) * PACKED_HEADS // SEP_DEGREE - 1} of {PACKED_HEADS}: "
            f"the same bits as the whole run's head slice {r['d']}; "
            f"{r['d_s']:.1f} s")
        if not all(r["d"].values()):
            raise AssertionError(f"sep (d) rank {i}: {r['d']}")
        out[f"{PACKED_PATH} heads split over sep{SEP_DEGREE} rank {i}"] = \
            r["d_launches"]
    # (b)
    cut = _hybrid_cfg(HYBRID_C_LAYERS)
    per = {i: _sep_per_step(cut, i) for i in range(SEP_DEGREE)}
    for key, ref, what in (("b", w1["c"], "dropout 0"),
                           ("b_attn", w1["c_attn"],
                            f"attention dropout {FLASH_DROPOUT}, hidden 0")):
        _check_zp(f"(b) sep {SEP_DEGREE}, {HYBRID_C_LAYERS} layers, {what}",
                  [r[key] for r in ranks],
                  ref, lambda x: per[x["sep_rank"]], tag="sep")
        for i, r in enumerate(ranks):    # both sep ranks share coordinates
            _check_counts(f"sep (b) {key} rank {i}", r[key]["launches"],
                          per[i], HYBRID_STEPS)
    bf = [r["b_bf16"] for r in ranks]
    if not all(math.isfinite(v) for b in bf for v in b["losses"]):
        raise AssertionError(f"sep (b) bf16: losses "
                             f"{[b['losses'] for b in bf]}")
    for i, r in enumerate(ranks):
        _check_counts(f"sep (b) bf16 rank {i}", r["b_bf16"]["launches"],
                      per[i], HYBRID_STEPS)
        for key in ("b", "b_attn", "b_bf16"):
            counts = r[key]["launches"]
            a_step = {n: counts[n] // HYBRID_STEPS
                      for n in FLASH_KERNELS + LN_KERNELS}
            log(f"[sep] (b) rank {i} {key}: launches a step {a_step}; "
                f"losses {r[key]['losses']}; step ms eager, gloo, card "
                f"shared {[round(t * 1e3, 1) for t in r[key]['times']]}; "
                f"{r[key]['seconds']:.1f} s")
            tag = {"b": "f32", "b_attn": "f32 attention dropout",
                   "b_bf16": "bf16"}[key]
            out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x"
                f"{TRAIN_SEQ} sep{SEP_DEGREE} gloo rank {i} {tag}"] = counts
    if any(r["b"]["param_sha"] != ranks[0]["b"]["param_sha"]
           for r in ranks):
        raise AssertionError("sep (b): the sep ranks' parameters differ")
    log(f"[sep] (a), (b), (d) {time.perf_counter() - t0:.1f} s | {smi}")
    # (c)
    t0 = time.perf_counter()
    ranks = spawn(_sep_rank, args=("c", "gloo"), nprocs=8,
                  timeout=HYBRID_TIMEOUT)
    runs = [r["c"] for r in ranks]
    _check_zp(f"(c) mp 2 x sharding 2 x sep {SEP_DEGREE} at os_g, "
              f"{HYBRID_C_LAYERS} layers", runs, w1["c"],
              lambda x: _sep_per_step(cut, x["sep_rank"]), tag="sep")
    by = {(x["coords"], x["sep_rank"]): x for x in runs}
    for (coords, sep), x in by.items():
        _check_counts(f"sep (c) rank {x['rank']}", x["launches"],
                      _sep_per_step(cut, sep), HYBRID_C_STEPS)
        if sep and x["param_sha"] != by[coords, 0]["param_sha"]:
            raise AssertionError(f"sep (c): sep rank {sep}'s parameters at "
                                 f"{coords} are not sep rank 0's")
    shares = [x["state_bytes"] / x["whole_bytes"] for x in runs]
    log(f"[sep] (c) optimizer-state bytes a rank against the world of one's "
        f"for the same parameters: {[round(v, 4) for v in shares]} (at most "
        f"{ZP_STATE_SHARE}); {time.perf_counter() - t0:.1f} s")
    if not max(shares) <= ZP_STATE_SHARE:
        raise AssertionError(f"sep (c): optimizer state shares {shares}")
    for x in runs:
        if x["coords"] == (0, 0, 0, 0):
            out[f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x"
                f"{TRAIN_SEQ} mp2 sharding2 sep{SEP_DEGREE} os_g gloo sep "
                f"rank {x['sep_rank']}"] = x["launches"]
    return out


# -- phase 19: MoE and expert parallelism ------------------------------------------

def _moe_layer(seed, moe_group=None):
    """The MoE layer at GPT-345m's width from ``seed`` (every rank draws
    the whole layer and keeps its experts)."""
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertMlp,
                                                                  MoELayer)
    gen = make_generator(seed, DEVICE)
    experts = ExpertMlp(MOE_E, MOE_D, MOE_DFF, generator=gen,
                        moe_group=moe_group)
    layer = MoELayer(MOE_D, experts, gate={"type": "gshard", "top_k": 2},
                     capacity_factor=MOE_CF, moe_group=moe_group,
                     generator=gen)
    x = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device=DEVICE)
    return layer, x


def _moe_sample(t):
    """About MOE_SAMPLES elements of ``t`` at a fixed stride, on the host."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // MOE_SAMPLES)].cpu().numpy()


def _moe_recipe(layer, x, data_group=None):
    """The dryrun's recipe on this rank's tokens: the loss (mean of y^2
    over every rank's tokens), the gradients averaged over the data
    group, one SGD step of 0.1, the loss again.  Returns the two losses
    and the gradients the step applied."""
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce

    def mean(t):
        t = t.detach().clone()
        if data_group is not None:
            all_reduce(t, op=ReduceOp.AVG, group=data_group)
        return t.item()

    params = dict(layer.named_parameters())
    loss = (layer(x).float() ** 2).mean()
    loss.backward()
    l0 = mean(loss)
    grads = {}
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] = p.grad
            if data_group is not None:
                all_reduce(g, op=ReduceOp.AVG, group=data_group)
            p -= 0.1 * g
            p.grad = None
        l1 = mean((layer(x).float() ** 2).mean())
    return [l0, l1], grads


def _moe_rank(cases):
    """ep 2 (ranks 0 and 1) and dp 2 x ep 2 (all four) over gloo on the
    card: each rank's experts' bits before the step, the recipe's losses
    and samples of the gradients it applied."""
    from paddle_tpu_torch.distributed import (build_mesh, get_rank,
                                              init_parallel_env)
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        expert_parallel_groups
    init_parallel_env("gloo", device=DEVICE)
    me, out = get_rank(), {}
    for name, degrees in cases.items():
        n = int(np.prod(list(degrees.values())))
        mesh = build_mesh(degrees, world_size=n)
        ep, dg = expert_parallel_groups(mesh, me)
        if ep is None:
            continue
        layer, x = _moe_layer(0, ep)
        coords = mesh.coords(me)
        rows = x.reshape(mesh.shape["dp"], -1, MOE_D)[coords["dp"]]
        experts = {k: _bits_sha(p) for k, p in
                   layer.experts.named_parameters()}
        t0 = time.perf_counter()
        losses, grads = _moe_recipe(layer, rows,
                                    dg if dg.nranks > 1 else None)
        out[name] = {"coords": coords, "experts": experts, "losses": losses,
                     "grads": {k: _moe_sample(g) for k, g in grads.items()},
                     "seconds": time.perf_counter() - t0}
        del layer, x
        _free()
    return out


def phase_moe(smi):
    """MoE and expert parallelism on the card (see the module docstring)."""
    from paddle_tpu_torch.distributed import spawn
    t_phase = time.perf_counter()
    layer, x = _moe_layer(0)
    local = MOE_E // 2
    shas = {j: {k: _bits_sha(p[j * local:(j + 1) * local])
                for k, p in layer.experts.named_parameters()}
            for j in range(2)}
    fb = []
    for i in range(MOE_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (layer(x).float() ** 2).mean().backward()
        torch.cuda.synchronize()
        if i:
            fb.append((time.perf_counter() - t0) * 1e3)
        layer.zero_grad(set_to_none=True)
    want, grads = _moe_recipe(layer, x)
    # each ep rank's window of the expert gradients, the gate's whole
    want_g = {j: {k: _moe_sample(g[j * local:(j + 1) * local]
                                 if k.startswith("experts.") else g)
                  for k, g in grads.items()} for j in range(2)}
    del layer, x, grads
    _free()
    cases = {"ep2": {"ep": 2}, "dp2xep2": {"dp": 2, "ep": 2}}
    ranks = spawn(_moe_rank, args=(cases,), nprocs=4, timeout=HYBRID_TIMEOUT)
    worst, worst_g = 0.0, dict.fromkeys(cases, 0.0)
    for name in cases:
        for r in ranks:
            got = r.get(name)
            if got is None:
                continue
            j = got["coords"]["ep"]
            err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                          want))
            worst = max(worst, err)
            if sorted(got["grads"]) != sorted(want_g[j]):
                raise AssertionError(f"moe-ep {name}: gradients of "
                                     f"{sorted(got['grads'])}, want "
                                     f"{sorted(want_g[j])}")
            err_g = {k: float(np.linalg.norm(g - want_g[j][k])
                              / np.linalg.norm(want_g[j][k]))
                     for k, g in got["grads"].items()}
            worst_g[name] = max(worst_g[name], *err_g.values())
            if (got["experts"] != shas[j] or not err <= MOE_LOSS_RTOL
                    or not max(err_g.values()) <= MOE_GRAD_RTOL):
                raise AssertionError(
                    f"moe-ep {name} rank at {got['coords']}: losses "
                    f"{got['losses']} against the world of one's {want} "
                    f"(relative {err:.2e}, bound {MOE_LOSS_RTOL:.0e}); "
                    f"gradients' relative error in norm {err_g} (bound "
                    f"{MOE_GRAD_RTOL:.0e}); experts the world of one's "
                    f"bits: {got['experts'] == shas[j]}")
    if not want[1] < want[0]:
        raise AssertionError(f"moe-ep: the SGD step did not lower the loss "
                             f"{want}")
    log(f"[moe-ep] MoELayer D {MOE_D}, Dff {MOE_DFF}, {MOE_E} experts, "
        f"gshard top-2, capacity factor {MOE_CF}, {MOE_TOKENS} tokens, f32: "
        f"world of one forward+backward (eager) median "
        f"{statistics.median(fb):.2f} ms ({[round(t, 2) for t in fb]}); "
        f"losses before and after one SGD step of 0.1 {want}; ep 2 "
        f"{[r['ep2']['losses'] for r in ranks if 'ep2' in r]}, dp 2 x ep 2 "
        f"{[r['dp2xep2']['losses'] for r in ranks]}: max relative diff "
        f"{worst:.2e} (bound {MOE_LOSS_RTOL:.0e}); the gradients the step "
        f"applies: max relative error in norm "
        f"{ {k: f'{v:.2e}' for k, v in worst_g.items()} } (bound "
        f"{MOE_GRAD_RTOL:.0e}); every rank's experts the "
        f"world of one's bits; recipe s a rank "
        f"{[round(r['dp2xep2']['seconds'], 2) for r in ranks]} (gloo, card "
        f"shared); {time.perf_counter() - t_phase:.1f} s | {smi}")


# -- phase 20: the Engine and the launcher ----------------------------------------

class _Staged:
    """Samples (ids, labels) already on the card."""

    def __init__(self, items):
        self.items = items

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _engine_gpt(gpt, seed):
    """gpt_345m through the ``Engine`` as phase 20 (a) drives it: the
    network drawn from a generator seeded ``seed`` on the card, O2 bf16
    from ``strategy.amp`` (no dynamic loss scaling), ``AdamW(1e-4,
    multi_precision=True)``, the causal-LM loss: ``build_train_step``'s
    step."""
    from paddle_tpu_torch.distributed import Engine, fleet
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    gen = make_generator(seed, DEVICE)
    net = GPTForCausalLM(gpt, generator=gen)
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {"use_bf16": True,
                            "use_dynamic_loss_scaling": False}
    return Engine(net, loss=GPTPretrainingCriterion(),
                  optimizer=AdamW(learning_rate=1e-4, multi_precision=True,
                                  parameters=net.parameters()),
                  strategy=strategy, generator=gen)


def _engine_fit(eng, loader, n=None):
    """``eng.fit`` over ``loader`` (its first ``n`` batches): (losses,
    step seconds, launch counts), the counters set to 0 just before."""
    from paddle_tpu_torch.ops import reset_launch_counts
    clock = _hapi_callbacks()
    torch.cuda.synchronize()
    reset_launch_counts()
    eng.fit(loader, epochs=1, steps_per_epoch=n, verbose=0,
            callbacks=[clock])
    return clock.losses, clock.times, _launch_counts()


def _bare_steps(step, batches):
    losses, times = [], []
    for ids, labels in batches:
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        times.append(time.perf_counter() - t0)
    return losses, times


def _engine_path(smi, root):
    """(a): the Engine at a world of one against the bare step, then its
    save and a fresh Engine's ``restore_latest`` (:func:`phase_engine`).
    Returns {path: launch counts}."""
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.incubate.models import gpt_345m
    from paddle_tpu_torch.train import build_train_step
    gpt = gpt_345m(use_recompute=False, max_position_embeddings=TRAIN_SEQ)
    per_step = _headline_per_step(gpt)
    tokens = _HapiTokens(gpt.vocab_size)
    ds = _Staged([tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                        for a in tokens[i]) for i in range(len(tokens))])
    loader = DataLoader(ds, batch_size=FUSED_BATCH, shuffle=False)
    batches = [tuple(torch.stack([ds.items[i][k] for i in range(
        j * FUSED_BATCH, (j + 1) * FUSED_BATCH)]) for k in (0, 1))
        for j in range(ENGINE_STEPS)]
    label = f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} Engine.fit"
    a = _engine_gpt(gpt, 0)
    b = build_train_step(gpt, device=DEVICE, seed=0)
    losses = {"engine": [], "bare": []}
    times = {"engine": [], "bare": []}
    launches = None
    for turn, way in enumerate(ENGINE_TURNS):
        if way == "engine":
            got, secs, counts = _engine_fit(a, loader)
            if launches is None:
                launches = counts
                _check_captured(f"{label} (first turn)", a.train_step,
                                ENGINE_STEPS)
                _check_counts(label, launches, per_step, ENGINE_STEPS)
        else:
            got, secs = _bare_steps(b, batches)
        losses[way] += got
        # the first step of each side captures its graph
        times[way] += secs[1:] if not times[way] else secs
        if turn in (1, 3):
            differ = _differ(_step_state(b), _step_state(a.train_step))
            same_rng = torch.equal(a.train_step.generator.get_state(),
                                   b.generator.get_state())
            if losses["engine"] != losses["bare"] or differ or not same_rng:
                raise AssertionError(
                    f"{label}: Engine and build_train_step differ after "
                    f"{len(losses['bare'])} steps: losses "
                    f"{losses['engine']} / {losses['bare']}, tensors "
                    f"{differ[:8]}, generator same {same_rng}")
    _check_captured(label, a.train_step, 2 * ENGINE_STEPS)
    _check_captured(f"{label} (bare)", b, 2 * ENGINE_STEPS)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    n_state = len(_step_state(b))
    log(f"[engine] (a) {label}: turns {'/'.join(ENGINE_TURNS)}, "
        f"{ENGINE_STEPS} steps each: losses and all {n_state} state tensors "
        f"the same bits after steps {ENGINE_STEPS} and {2 * ENGINE_STEPS}; "
        f"Engine median {med['engine']:.2f} ms a step, the bare graph step "
        f"{med['bare']:.2f} ms (Engine - bare {med['engine'] - med['bare']:+.2f}"
        f" ms); capture {a.train_step.captured.stats}; first losses "
        f"{losses['engine'][:ENGINE_STEPS]} | {smi}")
    if not all(math.isfinite(v) for v in losses["engine"]):
        raise AssertionError(f"{label}: losses {losses['engine']}")
    want = losses["engine"][:ENGINE_RESUME_TO]
    del a, b
    _free_steps()

    # the save after ENGINE_SAVE_AT steps and the resume
    mgr = CheckpointManager(os.path.join(root, "engine"))
    c = _engine_gpt(gpt, 0)
    first, _, _ = _engine_fit(c, loader, ENGINE_SAVE_AT)
    _need_disk("engine", root, _tree_bytes(c.train_step.checkpoint_tree()))
    t0 = time.perf_counter()
    c.save(mgr.step_dir(ENGINE_SAVE_AT))
    save_s = time.perf_counter() - t0
    tail = _Staged(ds.items[ENGINE_SAVE_AT * FUSED_BATCH:
                            ENGINE_RESUME_TO * FUSED_BATCH])
    rest_loader = DataLoader(tail, batch_size=FUSED_BATCH, shuffle=False)
    rest_c, _, _ = _engine_fit(c, rest_loader)
    d = _engine_gpt(gpt, 1)
    t0 = time.perf_counter()
    n = d.restore_latest(mgr.root)
    restore_s = time.perf_counter() - t0
    rest_d, _, resumed = _engine_fit(d, rest_loader)
    differ = _differ(_step_state(c.train_step), _step_state(d.train_step))
    log(f"[engine] (a) {label}: saved after step {ENGINE_SAVE_AT} in "
        f"{save_s:.2f} s, a fresh Engine (weights from seed 1) restored step "
        f"{n} in {restore_s:.2f} s and ran steps {ENGINE_SAVE_AT + 1}-"
        f"{ENGINE_RESUME_TO}: losses {rest_d} (uninterrupted {rest_c}), "
        f"tensors that differ {differ[:4]}")
    if n != ENGINE_SAVE_AT or first + rest_c != want or rest_d != rest_c \
            or differ or not torch.equal(c.train_step.generator.get_state(),
                                         d.train_step.generator.get_state()):
        raise AssertionError(f"{label}: the resumed steps are not the "
                             f"uninterrupted ones: step {n}, losses "
                             f"{first + rest_c} / {want} / {rest_d}, tensors "
                             f"{differ[:8]}")
    _check_captured(f"{label} (resumed)", d.train_step,
                    ENGINE_RESUME_TO - ENGINE_SAVE_AT)
    _check_counts(f"{label} (resumed)", resumed, per_step,
                  ENGINE_RESUME_TO - ENGINE_SAVE_AT)
    del c, d
    shutil.rmtree(mgr.root)
    _free_steps()
    return {label: launches, f"{label} resumed": resumed}


#: phase 20 (b) and (c): one launched rank (written to a file and run by
#: the launcher, one process a rank)
_ENGINE_WORKER = r'''
import json, os, sys, time
import numpy as np
import torch


def who(tag):
    return tag, int(os.environ["PADDLE_TRAINER_ID"]), os.getpid()


def main():
    out, device, fields = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    batch, seq, steps, lr, clip = (int(sys.argv[4]), int(sys.argv[5]),
        int(sys.argv[6]), float(sys.argv[7]), float(sys.argv[8]))
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed import Engine, fleet, rpc
    from paddle_tpu_torch.distributed.ps import ShardedEmbedding
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.models import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import embedding
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import make_batch
    tdist.init_parallel_env("gloo", device=device)
    r, dev = tdist.get_rank(), tdist.rank_device()
    cfg = GPTConfig(**fields)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    ids, labels = make_batch(cfg, batch, seq, seed=0, device=dev)
    gen = make_generator(0, dev)
    net = GPTForCausalLM(cfg, generator=gen)
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 2}
    strategy.hybrid_configs = {"sharding_degree": 2}
    eng = Engine(net, loss=GPTPretrainingCriterion(), strategy=strategy,
                 optimizer=AdamW(learning_rate=lr,
                                 grad_clip=ClipGradByGlobalNorm(clip)),
                 generator=gen)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.times, self.t = [], [], time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            now = time.perf_counter()
            self.times.append(now - self.t)
            self.t = now

    rec = Losses()
    # phase 21 (c): telemetry on from the step's build (its bucket plan)
    # to the end of fit
    from paddle_tpu_torch.observability import configure, get_registry
    configure(enabled=True, jsonl_dir=os.path.join(out, "telemetry"))
    eng.prepare()
    sync()
    reset_launch_counts()
    eng.fit([(ids, labels)] * steps, epochs=1, verbose=0, callbacks=[rec])
    telemetry = get_registry().snapshot()
    configure(enabled=False)
    zp = eng.train_step.zero
    plan = {"reduce": [[b.kind, b.nbytes]
                       for b in zp.reducer.plan.buckets],
            "gather": [b.nbytes for b in zp.gather_plan.buckets],
            "n": zp.n, "clip_bytes": 2 * 4, "loss_bytes": 4,
            "criterion_bytes": batch // tdist.get_world_size() * seq * 4}
    counts = {n: KERNELS[n].launches for n in KERNELS}
    for n in ("layer_norm_fwd", "layer_norm_bwd"):
        counts[n + ".residual"] = KERNELS[n].residual_launches
    level = eng.train_step.zero.level
    # (c) rpc each way, then the sharded table on the card
    rpc.init_rpc(f"worker{r}")
    peer = rpc.rpc_sync(f"worker{1 - r}", who, args=(f"from {r}",),
                        timeout=60)
    rpc.shutdown()
    vocab, width = cfg.vocab_size, cfg.hidden_size
    emb = ShardedEmbedding(vocab, width, generator=make_generator(7, dev))
    mine = [make_batch(cfg, batch, seq, seed=10 + k, device=dev)[0]
            for k in range(2)]
    gouts = [torch.randn(batch, seq, width, device=dev,
                         generator=make_generator(20 + k, dev))
             for k in range(2)]
    t0 = time.perf_counter()
    rows = emb(mine[r])
    rows.backward(gouts[r])
    sync()
    ps_s = time.perf_counter() - t0
    whole = XavierNormal()((vocab, width), make_generator(7, dev))
    whole.requires_grad_()
    want = embedding(torch.cat(mine), whole)
    want.backward(torch.cat(gouts))
    lo = emb.weight.row_offset
    per = emb.weight.shape[0]
    fwd_err = (rows - want[r * batch:(r + 1) * batch]).abs().max().item()
    grad_err = (emb.weight.grad - whole.grad[lo:lo + per]).abs().max().item()
    res = {"rank": r, "losses": rec.losses, "times": rec.times,
           "counts": counts, "level": level, "peer": list(peer),
           "telemetry": telemetry, "plan": plan,
           "shard_axes": list(emb._shard_axes), "rows": [lo, lo + per],
           "ps_fwd_err": fwd_err, "ps_grad_err": grad_err, "ps_s": ps_s,
           "ps_same_bits": bool(torch.equal(rows, want[r * batch:(r + 1) *
                                                       batch]) and
                                torch.equal(emb.weight.grad,
                                            whole.grad[lo:lo + per]))}
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res)[:400], flush=True)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
'''


def _launched_ranks(tmp, cfg):
    """(b) and (c): the worker script written into ``tmp`` and run by the
    launcher over two ranks on ``cfg`` (a ``GPTConfig``); the launcher's
    code, its seconds and each rank's results."""
    script = os.path.join(tmp, "engine_worker.py")
    with open(script, "w") as f:
        f.write(_ENGINE_WORKER)
    out, logs = os.path.join(tmp, "out"), os.path.join(tmp, "log")
    os.makedirs(out)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", logs, script, out,
           DEVICE, json.dumps(dataclasses.asdict(cfg)), str(HYBRID_BATCH),
           str(TRAIN_SEQ), str(ENGINE_LAUNCH_STEPS), str(HYBRID_LR),
           str(HYBRID_CLIP)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        text, _ = proc.communicate(timeout=ENGINE_LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"the launcher did not finish within "
                             f"{ENGINE_LAUNCH_TIMEOUT} s")
    secs = time.perf_counter() - t0
    tails = {}
    for r in range(2):
        path = os.path.join(logs, f"workerlog.{r}")
        if not os.path.exists(path):
            raise AssertionError(f"the launcher wrote no {path}")
        with open(path) as f:
            tails[r] = f.read()[-2000:]
    if proc.returncode != 0:
        raise AssertionError(f"the launcher exited with {proc.returncode}: "
                             f"{text.decode()[-2000:]}\n{tails}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return proc.returncode, secs, ranks


def phase_engine(smi):
    """Phase 20 (module docstring).  Returns {path: launch counts}."""
    import tempfile
    from paddle_tpu_torch.train import build_train_step, make_batch
    out = {}
    with tempfile.TemporaryDirectory(prefix="pt_engine_") as root:
        out.update(_engine_path(smi, root))
        # (b)'s reference: the world of one at the launched ranks' step
        cut = _hybrid_cfg(HYBRID_C_LAYERS, dropout=False)
        ids, labels = make_batch(cut, HYBRID_BATCH, TRAIN_SEQ, seed=0,
                                 device=DEVICE)
        one = build_train_step(cut, device=DEVICE, amp_o2=False,
                               fusion=False, capture=False,
                               optimizer=_hybrid_optimizer())
        want, _, _, _ = _hybrid_steps(one, ids, labels, ENGINE_LAUNCH_STEPS)
        del one
        _free()
        code, secs, ranks = _launched_ranks(root, cut)
    per_step = _plain_per_step(cut)
    label = (f"gpt_345m {HYBRID_C_LAYERS} layers {HYBRID_BATCH}x{TRAIN_SEQ} "
             f"Engine.fit sharding2 os_g launched gloo")
    for res in ranks:
        r = res["rank"]
        err = max(abs(a - b) for a, b in zip(res["losses"], want))
        log(f"[engine] (b) launched rank {r}: ZeRO {res['level']}, losses "
            f"{res['losses']} (world of one {want}, max |diff| {err:.3e}), "
            f"step seconds {[round(t, 3) for t in res['times']]}; (c) rpc "
            f"answered {res['peer']}, ShardedEmbedding over "
            f"{res['shard_axes']} rows {res['rows']}: rows max |err| "
            f"{res['ps_fwd_err']:.3e}, gradient max |err| "
            f"{res['ps_grad_err']:.3e}, the same bits "
            f"{res['ps_same_bits']}, lookup + backward {res['ps_s']:.3f} s")
        if len(res["losses"]) != ENGINE_LAUNCH_STEPS or \
                err > ENGINE_LOSS_TOL or res["level"] != "os_g":
            raise AssertionError(f"(b) launched rank {r}: losses "
                                 f"{res['losses']} against {want} "
                                 f"(bound {ENGINE_LOSS_TOL}), ZeRO "
                                 f"{res['level']}")
        if res["peer"][:2] != [f"from {r}", 1 - r] or \
                not res["ps_same_bits"] or res["rows"][1] - \
                res["rows"][0] != cut.vocab_size // 2:
            raise AssertionError(f"(c) launched rank {r}: rpc {res['peer']}, "
                                 f"ShardedEmbedding rows {res['rows']}, "
                                 f"errors {res['ps_fwd_err']} / "
                                 f"{res['ps_grad_err']}")
        _check_counts(f"(b) launched rank {r}", res["counts"], per_step,
                      ENGINE_LAUNCH_STEPS)
        _check_rank_collectives(res, ENGINE_LAUNCH_STEPS)
        out[f"{label} rank {r}"] = res["counts"]
    log(f"[engine] (b) the launcher: code {code}, {secs:.1f} s for two "
        f"ranks (start, build, {ENGINE_LAUNCH_STEPS} steps, rpc and the "
        f"sharded table) | {smi}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    t_start = t_lap = time.perf_counter()

    def lap(what):
        """Log the seconds since the last lap."""
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[time] {what} {now - t_lap:.1f} s")
        t_lap = now

    smi = phase_card()
    phase_build()
    lap("card and build")
    timer = Timer()
    results = phase_kernels(timer)
    del timer
    lap("kernels")
    phase_model()
    engine, launches, prompts, params = phase_serve(smi)
    phase_bucket_stages(params, prompts)
    del params
    tele_serve = phase_http(engine, prompts[0][:64])
    del engine
    torch.cuda.empty_cache()
    lap("model and serve")
    train_launches = phase_train(smi)
    lap("train")
    bert_launches, bert_long = phase_bert(smi)
    lap("bert")
    fused_gpt, fused_bert, fused_wide = phase_fusion(smi)
    lap("fusion")
    packed = phase_packed(smi)
    lap("packed")
    captured = phase_capture(smi)
    lap("capture")
    scheduled = phase_schedule(smi)
    lap("schedule")
    checkpointed = phase_checkpoint(smi)
    lap("checkpoint")
    hapi = phase_hapi(smi)
    lap("hapi")
    hybrid, world1 = phase_hybrid(smi)
    lap("hybrid")
    zero_pipeline, resumed = phase_zero_pipeline(smi, world1)
    lap("zero-pipeline and sharded-ckpt")
    sep = phase_sep(smi, world1)
    del world1
    lap("sep")
    phase_moe(smi)
    lap("moe-ep")
    engine = phase_engine(smi)
    lap("engine and launcher")
    tuned = phase_tuner(smi)
    lap("tuner")
    log(f"[time] phase 21 (telemetry and tuner) "
        f"{sum(PHASE21_S.values()):.1f} s: "
        f"{ {k: round(v, 1) for k, v in sorted(PHASE21_S.items())} } "
        f"(budget 60 s, (d) 45 s)")
    # each kernel's launches on its paths' runs: the GPT step for
    # LayerNorm and flash, the BERT step for LayerNorm (its residual
    # variant) and cross-entropy, the BERT step at 512 for flash
    by_path = {name: {} for name in results}
    for name in TRAIN_KERNELS:
        by_path[name][f"gpt_345m {TRAIN_BATCH}x{TRAIN_SEQ}"] = \
            train_launches[name]
    for name in LN_KERNELS + XENT_KERNELS:
        by_path[name][f"bert_base {BERT_BATCH}x{BERT_SEQ}"] = \
            bert_launches[name]
    for name in LN_KERNELS:
        by_path[name][f"bert_base {BERT_BATCH}x{BERT_SEQ} residual"] = \
            bert_launches[name + ".residual"]
    for name in FLASH_KERNELS:
        by_path[name][f"bert_base {BERT_LONG_BATCH}x{BERT_LONG_SEQ}"] = \
            bert_long[name]
    for name in SERVE_KERNELS:
        by_path[name]["serve"] = launches[name]
    for name in PACKED_KERNELS:
        by_path[name][PACKED_PATH] = packed[name]
    # the fusion pass's paths: the block kernels' first is the GPT one
    for name in BLOCK_KERNELS + TRAIN_KERNELS:
        by_path[name][f"gpt_345m {FUSED_BATCH}x{TRAIN_SEQ} fused"] = \
            fused_gpt[name]
    for name in BLOCK_KERNELS + LN_KERNELS + XENT_KERNELS:
        by_path[name][f"bert_base {BERT_BATCH}x{BERT_SEQ} fused"] = \
            fused_bert[name]
    for name in BLOCK_KERNELS + TRAIN_KERNELS:
        by_path[name][f"gpt_1p3b {WIDE_LAYERS} layers "
                      f"{WIDE_BATCH}x{TRAIN_SEQ} fused"] = fused_wide[name]
    # phase 11's captured paths (the serve path's graphs at all three
    # precisions)
    for path, counts in captured.items():
        for name in by_path:
            if counts.get(name):
                by_path[name][f"{path} captured"] = counts[name]
    # phase 12's scheduled, clipped paths and the optimizer sweep
    for path, counts in scheduled.items():
        for name in by_path:
            if counts.get(name):
                by_path[name][f"{path} captured"] = counts[name]
    # phase 13's resumed steps, served directories, calibration and reload
    for path, counts in checkpointed.items():
        for name in by_path:
            if counts.get(name):
                by_path[name][path] = counts[name]
    # phase 14's hapi paths: GPT's fit, the classifier's fit and evaluate
    # phase 15's hybrid runs: (a) captured, each rank of (b) and (c)'s rank 0
    # phase 16's: (a) captured, each stage of (b), (c)'s rank 0, (d)'s
    # stages
    # phase 17's: (a)'s ring and Ulysses runs and (d)'s packed heads on each
    # rank, (b)'s steps on each rank, (c)'s data rank 0
    # phase 18's resumed steps: (b)'s stages, (c)'s rank 0, (d)'s stages
    # phase 20's: (a)'s Engine replays, each launched rank of (b)
    # phase 21's: (a)'s requests, (b)'s on turns (in hapi's), (d)'s trials
    for path, counts in itertools.chain(hapi.items(), hybrid.items(),
                                        zero_pipeline.items(), sep.items(),
                                        resumed.items(), engine.items(),
                                        tele_serve.items(), tuned.items()):
        for name in by_path:
            if counts.get(name):
                by_path[name][path] = counts[name]
    kernels = []
    for name, rows in results.items():
        top = rows[0]
        paths = by_path[name]
        # launches: the count of the kernel's first main path (GPT for
        # LayerNorm and flash, BERT 32 x 128 for cross-entropy, GPT 8 x
        # 1024 fused for the block kernels, the packed phase for the packed
        # kernels); every path's count is in launches_by_path
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": next(iter(paths.values())),
            "launches_by_path": paths,
            "max_abs_err": top["max_abs_err"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "measured_at": top["variant"],
            "variants": rows,
        })
    from paddle_tpu_torch.ops import KERNELS
    if sorted(k["name"] for k in kernels) != sorted(KERNELS):
        raise AssertionError(f"the kernels line lists "
                             f"{[k['name'] for k in kernels]}, not every "
                             f"kernel of the port: {sorted(KERNELS)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
