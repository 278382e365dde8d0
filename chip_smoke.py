#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   from the checkout, one ``nvcc`` per source, all started together.
3. kernels: every CUDA entry against its plain PyTorch version on the card,
   at the main path's shapes plus ragged shapes (and a T > 1 stack), with
   kernel, plain, library and bound times, the achieved fp32 TFLOP/s and
   the kernel's time over the library call's (the dense kernel at every K
   of matrix powers' batch of 16); the flash kernels at danube's
   and starcoder2's attention shapes, windowed, ragged, bf16 and f32 (the
   prefill kernel's records with its achieved TFLOP/s and share of the
   bf16 tensor-core peak; an f32 record's operations bound at three split
   TF32 products, a third of the TF32 peak, the fp32 FMA bound beside
   it); the row kernel also cold (rotating RowSets), by the profiler, and
   its host time; the dual kernel and the library
   pair by the profiler and their host times; the flash kernels also at
   phase 17's shapes (paligemma's prefix of 256 and head dim 256, bf16
   and f32; hubert's full attention; qwen2-moe's and qwen3-moe's heads)
   and phase 18's (zamba2's shared block: head dim 64, a group of 1), and
   at two dense configs no phase serves (command-r-plus-104b's group of
   12, qwen1.5-32b's 40 heads); the dense entries' skinny tile (views of
   p < 4 columns: the learning views' 2^20 x 1-3, PageRank's and OLS's
   vectors at K = 1) and the row entry's at p = 1, each also by the
   profiler beside addmm's; K1, the flash-attention backward
   (``K1_CASES``: the training path's shapes, phase 22's per-rank ones,
   danube's S = 4128 under its window, the prefix at head dim 256, full
   attention, groups of 1, 4, 12 and 16), through the autograd Function against torch.autograd through
   the plain attention (f32 at the kernel tolerance; bf16 within the
   bound derived from the roundings, tests/flash_bounds.py),
   a second call bit for bit, the forward with the row log-sum-exp giving
   the forward's out bit for bit, each timed beside the plain versions
   and SDPA's forward and backward (its backend named), with the bound of
   the five products; each flash forward record names the kernel the
   binding took (``kernel``: bf16 at head dims 64, 80 and 128 the wgmma
   one) and its time over SDPA's (``x_sdpa``);
   then every CUDA entry but flash_attention, given an operand that
   requires grad, raises (no backward yet; the forward with LSE and K1:
   not differentiable) and launches nothing;
   flash_attention differentiates, launching the forward with LSE once
   and K1 once.
4. matrix powers A^16 (n = 10000, exp model, the paper's size): 8 single
   updates, one batch of 16, 20 queued updates with a final flush, all
   replayed through the re-evaluation engine and compared view by view;
   the kernel launch counts must equal the engine's applies.
5. OLS (m = 16384, n = 8192, p = 1): the same sequence.
6. row-local, compact regime: the left chain Y1 = X W1, Y2 = Y1 W2 at
   n = 2^20, m = 384, K = 256 under rank-8 row-local carriers touching 1 %
   of the rows (8 single, one stacked batch of 16, 8 Zipf-skewed), through
   a carrier engine, a second engine fed the same deltas widened to dense
   factor pairs, and re-evaluation.
7. row-local, mixed regime: the general iterative form (n = 10000,
   p = 128, k = 16, exp) under rank-1 carriers on A touching 100 rows (8
   single, one batch of 8): A, T1 and S2 take the row kernel, the other
   views the dense kernel.
8. sums of powers, gradient descent, PageRank (edge updates) and the
   general iterative form at n = 10000 on the dense path: 4 single
   updates, one batch of 8, 8 queued updates with a flush.
9. Sherman-Morrison through the dual-matmul kernel on OLS's maintained
   W (8192 x 8192) from phase 5: the first call's seconds apart from the
   median of the warm ones, and the dual kernels' device time a call.
10. serve_danube_full: h2o-danube-1.8b at its published width and depth
    (24 layers, d_model 2560, bf16, random weights from a seed) on
    ``ServeEngine``: 8 prompts of 4096 tokens, prefill, 32 greedy decode
    steps (positions 4096-4127 wrap the 4096-slot ring); prefill ms, decode
    ms per step, tokens/s, the decode step's byte bound, peak memory; the
    flash kernels checked again on layer 0's real q/k/v; one more prefill
    and two decode steps under ``torch.profiler`` (device time, idle share,
    and the bf16 tensor-core attention kernel's time and launches).
11. serve_danube_f32_exact: the same widths in f32 at 4 layers; every
    decode step's logits against ``forward``'s at its position over the
    whole 4128-token sequence (window mask in the prefill kernel against
    the wrapped ring in the decode kernel), greedy tokens against
    ``forward``'s argmax.
12. the incremental logit view Y = H W^T over phase 10's final-norm hidden
    states (32768 x 2560) and lm_head (32000 x 2560): 8 rank-1 hot-swaps
    through ``ServeEngine`` with a re-plan of the view after the first 4
    (the queue must survive it) and a flush, against H W'^T recomputed.
13. planned maintenance (``repro_torch.plan``), each engine against
    re-evaluation and its launches against its applies (only the
    incremental views of a planned firing reach the kernel):
    a. calibration: ``calibrate_cost_scale`` on PageRank (n = 10000,
       k = 16; probe rank 32, best of 9) and ``calibrate_op_cost_scales``
       at n = 512 and n = 4096;
    b. PageRank with phase 8's edge stream unplanned, planned at a's
       cost scale (per view, and chain-aware), and planless under the
       cost flush policy (per-view
       strategies, in-firing re-evaluations, seconds per update; the
       re-evaluation engine's beside them);
    c. OLS (16384 x 8192) planned for batches of 16 read once in 10^4
       firings: Z lazy, skipped by a batch, refreshed by reading beta;
    d. matrix powers A^16 (n = 10000) with every view hybrid at rank 32
       under four batches of 16: every second batch re-evaluates;
    e. phase 6's compact chain and carriers under a plan for rank-8
       carriers on 1 % of the rows: still on the row kernel;
    f. a second planned PageRank engine on b's trigger cache builds no
       trigger fn.
14. guarded maintenance (``repro_torch.guard``), each engine against
    re-evaluation and its launches against its applies (a guarded firing's
    applies run the out-of-place entry, its fused commit one
    ``select_commit`` a written view):
    a. matrix powers A^16 (n = 10000, exp; phase 4's cell) unguarded,
       guarded on the fused path, guarded on the snapshot path (a static
       plan) and clone-then-apply (each firing clones the views it
       writes, applies in place, checks its outputs): single updates, a
       batch of 16 and 8 queued updates on one stream;
    b. a's fused engine under chaos (poison 0.05, trigger raise 0.03),
       64 firings at a seed where both fire: the counters, a raised
       firing's rollback onto its very pre-firing tensors, the views
       against re-evaluation; a NaN planted in a view sets the
       out-of-place entry's flag and the commit keeps the store bit for
       bit;
    c. phase 6's compact chain, guarded against unguarded single row-local
       firings, the touched rows' saved bytes, an overflowing carrier
       rolled back with its rows restored bit for bit;
    d. a's cell under a drift sentinel (probe every 8) and an adaptive
       planner: the probe's time, a perturbed view found, healed and
       counted by the planner, and the planner's online cost-scale refit;
    e. phase 12's logit view under a ``DegradePolicy``: 8 hot-swaps and a
       flush against phase 12's, the peak memory of the out-of-place Y, a
       flush forced to fail (chaos) served from the last-good snapshot
       bit for bit, ``view_health`` degraded, then the recovery flushing
       the backlog exactly.
15. the multi-tenant fleet (``repro_torch.fleet``), every tenant engine
    on the card and out of place, its launches against the applies of
    every firing that ran:
    a. 8 logit-view tenants behind phase 10's server, each over its own
       4096 of phase 12's hidden states and a seeded copy of lm_head
       (Y 4096 x 32000): rank-1 hot-swaps of card tensors through
       ``ServeEngine.hot_swap`` into the fleet, ``flush_views`` and
       ``view_logits``; per update against the same 8 guarded engines
       driven one after another with identical groups (3 rounds in
       turns), bring-up on the shared trigger cache against cold
       per-tenant engines (one miss a key, 7 hits), every tenant bit for
       bit against its engine and within MAIN_TOL of H_i W_i^T;
    b. chaos acceptance on a virtual clock: 4 matrix-powers tenants (A^16,
       n = 10000), OLS (16384 x 8192) and phase 6's compact chain (rank-8
       carriers logged as carriers), 200 submissions under worker crashes,
       lease expiry, slow workers and poison at a seed where crash, expiry
       and poison all fire (found by the same drive on tiny CPU tenants):
       exactly once, bit-identical isolated replays, within MAIN_TOL of
       re-evaluation, replays onto the very pre-claim tensors; per-claim
       ms by tenant kind; one more row-local claim under the profiler with
       the copy of its row views that out-of-place writing costs;
    c. a cold, sheddable matrix-powers tenant (n = 10000) in the degraded
       and shedding tiers: shed decisions, its deltas folded on the card
       and one re-evaluation on read, against an incremental engine;
    d. a's tenants under four live worker threads on the real clock, then
       a drain: every store bit for bit against a deterministic drive of
       its commit log (the launch counters are exact under threads).
16. the higher-order deferred cascade and the learning views
    (``order=``, ``repro_torch.fivm``), each engine's launches against its
    applies (a firing that only banks launches nothing; a fold, one
    out-of-place apply a banked input and one a low-rank apply of its
    sweep):
    a. matrix powers A^16 (n = 10000, exp; phase 4's cell) first order,
       order 2 at window 8, order 3 at window 4 and only P16 at depth 2,
       in turns on one stream of rank-8 batches, 64 firings read every 8,
       then 64 read every 64, each segment ending in a flush against
       re-evaluation: ms an update, folds, sweeps, re-evaluations, fold
       applies, read ms, the memory the window base holds;
    b. a guarded order-2 engine under chaos at a seed where a fold raises
       (found by the same drive on a tiny CPU engine, whose counters the
       card's must equal): the fold rolled back onto the very pre-fold
       views and cascade state, re-folded bitwise as a fresh evaluation;
    c. a depth-2 plan adopted at construction, an adaptive planner's swap
       to depth mid-stream (a stream in a rank-8 subspace, so the window's
       re-compression at its cap is exact), a lazy plus deferred plan
       refused;
    d. two order-2 matrix-powers tenants and a first-order control under
       15b's chaos: exactly once, the tiny CPU drive's admitted counts
       and commit logs, bit for bit against same-order replays, after a
       fold barrier within MAIN_TOL of first-order replays;
    e. the Δ² view of P2 = A·A against 2·d·d;
    f. a ring RingSpec(256, 1, 2^20, 2 slots, proj 64) bootstrapped with
       seeded rows, 1024 labeled events at order 1 and at order 2 (ingest
       µs an event, read ms, ridge against batch_ridge in float64,
       insert-then-delete, k-means centroids, the row kernel at order 1),
       a fleet-hosted ring tenant's staleness against its SLO, and
       ``python -m repro_torch.launch.serve --fivm`` at this size.
17. the moe, vlm and audio families at published widths, bf16, each
    run's launches one flash_attention a layer for its prefill or forward
    and one flash_decode a layer a step; seconds of each part, its peak
    memory:
    a. qwen2-moe-a2.7b (24 layers, 60 experts top-4 and 4 shared, 14.3 B
       params) behind the ServeEngine: 8 prompts of 1024 tokens, 32
       greedy steps; one decode step and one prefill split by the
       profiler (attention, router and dispatch, expert products,
       combine, shared expert, head); an f32 cut of 4 layers at the same
       widths (B = 2, 256 tokens, 32 steps, T*k <= 4096 so nothing is
       dropped): decode logits and greedy tokens against forward's;
    b. qwen3-moe-235b-a22b at full width, 2 of its 94 layers (128
       experts top-8, decode at a group of 16): prefill and 8 steps;
    c. paligemma-3b (hd 256, MQA) through LM.prefill on 256 patches and
       768 tokens, then 32 LM.decode_step calls; an f32 cut of 4 layers:
       prefill logits against forward's, decode logits against a longer
       forward's over the tokens fed, and a patch perturbed at the end of
       the prefix moving the logits at position 0;
    d. hubert-xlarge's encoder (48 layers, full attention) over 8 x 1024
       frames; an f32 cut of 4 layers on the card against the same cut
       on the CPU (the plain versions).
18. the hybrid and ssm families at published widths, bf16, cut to
    RECUR_SERVE_LAYERS, seconds of each part and its peak memory:
    a. zamba2-1.2b (14 of its 38 Mamba2 layers: the shared attention + MLP
       block after each of 2 groups of 6, and the tail of 2): a forward
       over 8 x 2048 tokens (the
       chunked SSD scan, one flash_attention a group), cold and warm;
       the ServeEngine on 8 prompts of 256 tokens prefilled token by
       token, then 32 greedy steps (one flash_decode a group a step);
       one step split by the profiler (Mamba2 in_proj, conv + state
       update, gate + norm + out_proj; shared attention, MLP, head,
       other) against its byte bound (weights, states read and written,
       the valid KV slots); an f32 cut of 7 layers (a group and a tail
       of 1) at B = 2: the prefill's and every step's logits against
       forward over the 288 tokens, and the card's forward against the
       CPU's on the same weights;
    b. xlstm-350m (1 of its 3 groups of 7 mLSTM blocks and an sLSTM
       block; no attention, so no flash kernel): the same drive, split
       into mLSTM,
       sLSTM and head; its f32 cut of 8 layers (one group).
19. the training path:
    a. h2o-danube-1.8b at full width and depth in bf16 (remat "block"),
       ``make_train_step`` with AdamW on 8 sequences of 4096 tokens a
       step (the train_4k shape's global batch of 256 cut for one card)
       in 2 microbatches: a warm-up step, then 4 timed steps on one fixed
       batch (wall ms, tokens/s; the loss must fall, the gradient norm
       stay finite and every master weight move), the forward with LSE
       and K1's launches against the config's count (twice and once a
       layer a microbatch), peak memory, the model FLOPs' share of the
       bf16 peak, and one more step split by the profiler (forward
       blocks, head + cross-entropy forward and backward, recompute, K1,
       the rest of the backward, optimizer);
    b. each family's f32 cut (danube 1 layer at B = 2, S = 1024;
       qwen2-moe 1 layer at S = 520, past the dense-safe capacity;
       paligemma and hubert 1 layer at phase 17's cuts' batches, hubert
       at S = 1024; zamba2 and xlstm as phase 18's) takes one step on the
       card: its loss within 1e-4
       relative and every gradient leaf within MAIN_TOL of its largest
       entry of the same cut's on the CPU, the flash launches counted.
20. the training driver, ``repro_torch.launch.train.train``, with
    checkpoints and supervised restarts, on h2o-danube-1.8b at its
    published widths in bf16 cut to CKPT_LAYERS (B = 4, S = 4096), in a
    temporary directory whose free space is checked first:
    a. 8 steps, no checkpoints; then the costs of a checkpoint of the
       end state: the caller's staging, the writer's gather, encode with
       CRC and write, GB on disk, the staged copy's device memory, and
       the step's ms without a save and with one in flight;
    b. the same 8 steps with a checkpoint every 4 and a controller over 2
       hosts whose host 1 goes silent after the sixth step: 1 restart,
       steps 4 and 5 replayed, the flash launches the config's for the
       10 steps run;
    c. the newest checkpoint restored into a fresh template, bit for bit;
    d. one step taken twice from the same state (bit-reproducible?), then
       b's end state against a's, bit for bit if so;
    e. step 8's payload corrupted by the chaos hook: launch.train resumes
       from step 4 and ends at a's state;
    f. ``python -m repro_torch.launch.train`` twice on a checkpoint
       directory: the second run resumes from step 20;
    g. phase 11's engine through ``save_checkpoint`` and
       ``restore_checkpoint``: the params bit for bit, the cache and
       views reset, greedy tokens equal to a fresh engine's.
21. the row-sharded engine (``IncrementalEngine(mesh=...)``,
    ``repro_torch.dist.ivm_shard``), every firing's rank_update_batched
    launches equal to its applies on every rank, and the bytes of its
    collectives:
    a. a one-rank NCCL mesh in this process: matrix powers A^16
       (n = 10000) under 3 single updates and a batch of 16, against the
       single-device engine fed the same stream (SHARD_ONE_TOL) and
       re-evaluation (MAIN_TOL);
    b. four gloo ranks in spawned processes sharing the card (rank r on
       cuda:(r % device_count)), each holding 2500 rows of matrix powers'
       views: the same stream unplanned, then planned with every view
       re-evaluated in the firing, one re-evaluation product of two
       10000^2 views, then OLS (16384 x 8192) row-sharded; each rank's
       replicated factor blocks bit for bit against rank 0's; rank 0
       holds every gathered view against the single-device engine and
       re-evaluation (MAIN_TOL); ms an update (four ranks sharing one
       card: no scaling figure); the phase's seconds and each rank's peak
       memory;
    c. the drift sentinel on the four ranks (matrix powers at
       SHARD_SENTINEL_N, probed every second firing): P4 shifted on every
       rank's rows after a firing, the next firing's probe finds the same
       drifts on every rank (each rank's rows' squares summed over the
       ranks) and recovers the drifted views on the mesh in their row
       layout; one more probe and recovery heal the view the first left
       drifted (P16, consistent with the drifted P8), and a probe after
       finds none; the gathered views against re-evaluation (MAIN_TOL).
22. the LM half of the sharded dist/ (``repro_torch.dist.sharding``:
    explicit tensor, expert and data parallelism, and the fsdp rule) on
    four gloo ranks in spawned processes sharing the card, over (2, 2),
    (1, 4) and (4, 1) meshes, at published widths:
    a. h2o-danube-1.8b cut to 2 layers, f32, B = 4, S = 512 on (2, 2)
       (16 query and 4 KV heads a rank): one step's loss and gradients,
       averaged over the data ranks and gathered whole, against the
       single-device step's on rank 0 (phase 19b's tolerances);
    b. the same cut in bf16, B = 4, S = 2048, three steps: ms a step
       beside the single-device step's at the same global batch,
       ``sharding.BYTES`` a step (the model axis's reduces, the data
       axis's gradient mean), the flash launches a rank;
    c. qwen3-moe-235b-a22b cut to 1 layer, f32 forward on (1, 4) (32
       experts, 16 query heads and 1 KV head a rank), B = 2, S = 256
       (T·k = 4096: nothing dropped): the MoE block given the same input
       against the single device at 2e-4, the logits at the reference
       test's 5e-3, the tokens whose top-8 experts differ counted;
    d. b's state saved (gathered, rank 0 writes the reference's format)
       and restored onto plan_mesh(2, 2)'s (1, 2) sub-mesh of the first
       two ranks: every leaf bit for bit, then one step;
    e. ``launch/train.py --mesh local --model-parallel 2`` on the four
       ranks, custom-10m, 3 steps;
    f. the fsdp rule, ``{"fsdp": "data"}`` (params and optimizer state
       split over the data axis too, each block gathered whole inside its
       remat region), a's and b's cut on (2, 2) and (4, 1): a's
       gradients against a's single device; on (4, 1) one step clipped
       far below the gradients' norm, its norm and update against the
       single device's; b's first LM_SHARD_FSDP_STEPS steps, their
       losses against b's single device, ``sharding.BYTES`` equal to
       ``tools/torch_shard_bytes.py --rules``'s meta walk (run on the CPU
       meanwhile), the state's bytes and the peak a rank; the (2, 2)
       params saved and restored under the default rules, bit for bit;
       an f32 decode of LM_SHARD_FSDP_DECODE on (2, 2) within the
       serving bound, greedy tokens equal;
    g. the cache_seq rule, ``{"cache_seq": "model"}`` on (1, 4) (each rank
       a quarter of the decode cache's slots with every KV head; the
       decode kernel's LSE instance on the rank's valid slots, the
       partials merged by their log-sum-exp): the cut in f32 prefilled
       with fewer positions than one rank's slots and decoded past them,
       every step's logits within LM_SHARD_CSEQ_TOL of the single
       device's; in bf16 at LM_SHARD_CSEQ_BF16 (a 4096-slot ring, 1024 a
       rank), fed the same tokens, its logits within
       LM_SHARD_CSEQ_BF16_TOL of the same mesh's under the default rules
       and of the single
       device's, the greedy tokens that agree counted, ms a step beside
       the default rules', a step's bytes the meta walk's;
    h. the seq_sp rule, ``{"seq_sp": "model"}`` on (2, 2) (the residual
       stream split over the sequence between blocks, gathered before
       attention and the MLP, their row-parallel outputs reduce-scattered):
       a's gradients within LM_SHARD_SEQ_GRAD_TOL of each leaf's largest
       entry and the loss within LM_SHARD_SEQ_LOSS_TOL of a's single
       device; b's first LM_SHARD_FSDP_STEPS steps, losses within
       LM_SHARD_SEQ_BF16_TOL of b's single device, bytes the meta walk's,
       ms and peak beside b's.
23. the roofline walk (``repro_torch.roofline``: every aten op's FLOPs by
    ``torch.utils.flop_counter``'s formulas and bytes by storage, each
    kernel entry by its own formula) and the dry-run:
    a. phase 19a's danube bf16 training step (8 x 4096, 2 microbatches,
       remat "block") after a warm-up and ROOF_TRAIN_STEPS timed steps,
       walked on the card and on meta: equal FLOPs, bytes and kernel
       entries; the walk's bound on one H100 (data sheet), the measured
       step, their ratio and model_flops_estimate's MFU;
    b. phase 10's decode step (8 sequences, the 4096-slot ring wrapped)
       the same way, ROOF_DECODE_STEPS timed;
    c. a's walked peak (plus what the card held beside the step's
       arguments) within ROOF_PEAK_TOL of max_memory_allocated;
    d. ``python -m repro_torch.launch.dryrun`` on ROOF_CELLS (danube and
       qwen3-moe train_4k on 16x16, command-r-plus decode_32k on
       2x16x16, zamba2 long_500k), each in a process of its own on the
       CPU, started first: per-chip memory, the three roofline terms and
       the bottleneck (predictions from the data sheet).
24. the recurrent families and gradient compression on a model axis
    (Mamba2 and the mLSTM split by whole heads, the sLSTM cell
    replicated) on four gloo ranks in spawned processes sharing the
    card, over (2, 2) and (1, 4), zamba2-1.2b at published widths cut to
    ZAMBA_CUT_LAYERS (one group of 6 and a tail of 1) and xlstm-350m to
    XLSTM_CUT_LAYERS (7 mLSTM + 1 sLSTM):
    a. each family f32 on (2, 2), RECUR_SHARD_EXACT's (B, S): one step's
       loss and gathered gradients against the single device's on rank 0
       (phase 19b's tolerances), and on a one-rank (1, 1) placement
       within SHARD_ONE_TOL;
    b. each family bf16 on (2, 2), RECUR_SHARD_STEP's steps: losses
       within LM_SHARD_BF16_LOSS_C / sqrt(B·S) of the single device's, ms
       a step beside its, ``sharding.BYTES`` a step by mesh axis;
    c. each family f32 on (1, 4): a token-by-token prefill of
       RECUR_SHARD_PROMPT positions and RECUR_SHARD_NEW greedy steps
       through ``LM.decode_step`` (the cache placed by
       ``LM.cache_specs``): logits within SERVE_ATOL + SERVE_RTOL |logit|
       of the single device's, greedy tokens equal, zamba2's flash_decode
       launches counted a step;
    d. rank-RECUR_SHARD_COMP_RANK compression on (2, 2) of a's zamba2
       gradients: the decompressed gradients against the single device's
       compression of the whole leaves from the same Q₀ (MAIN_TOL of each
       leaf's largest entry), the factor bytes on the model axis against
       their formula;
    e. b's zamba2 state saved on (2, 2) (gathered, rank 0 writes the
       reference's format) and restored onto (1, 4): params, master
       weights and moments bit for bit;
    f. the training driver (``launch.train.train`` on
       ``make_local_mesh(2)``) with compression rank 2 for zamba2's cut
       in bf16, RECUR_SHARD_DRIVER_BATCH, RECUR_SHARD_DRIVER_STEPS steps.

Every launch count is set to 0 just before a phase drives its engines and
read just after (in each rank, for phases 21b's and 22's spawned ranks);
the counts of each kernel must equal the applies (or calls) the phase
made.

The last two lines of standard output are the ``{"kernels": [...]}``
record (``rank_update_batched``'s with its launches over phases 4-9,
12-16 and 21 by K = T*k; the rank-update entries' by M's columns p, and the
dense entries' on the skinny tile by K; the flash entries' launches by
kernel, ``launches_by_kernel`` (K1's by the route of its kernels), and
the kernel of their headline shape; the forward with LSE and K1 at phase 19's danube shape;
the decode kernel's LSE instance at 22g's per-rank shape; phase 23's
flash launches among the rest) and
``{"ok": true, "device":
{...}}``.  Without CUDA,
or outside a checkout, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
DEVICE = "cuda"   # where the script makes its inputs

# Tolerance of a kernel against its plain version: the repo's kernel
# tolerance (tests/conftest.py assert_close), |got - want| <= ATOL + RTOL
# |want|.  Both sum K products in fp32, in different orders.
KERNEL_RTOL = KERNEL_ATOL = 2e-4

# Tolerance of every incremental view against the re-evaluation engine's,
# as max |incr - reeval| / max |reeval|.  Both run fp32 with TF32 off, but
# they sum inner dimensions of 8192-16384 in different orders (factored
# chains and rank-k applies against full GEMMs and an LU inverse), and the
# incremental side carries its rounding through 44 updates.  A wrong apply
# (an update lost or applied twice) moves a view by more than 1e-2 of its
# largest entry at these update scales, far above this bound.
MAIN_TOL = 1e-3

UPDATES_SINGLE, UPDATES_BATCH, UPDATES_QUEUED = 8, 16, 20
# phases 4 and 13d: matrix powers; phases 5 and 13c: OLS (m x n, p = 1)
POWERS_N, OLS_M, OLS_N = 10000, 16384, 8192
# phase 3's cold row timings rotate over at least this many RowSets, and
# over enough to touch twice the H100's 50 MB L2 where the view is large
ROW_COLD_SETS, L2_BYTES = 8, 50 * 2 ** 20
# the four apps of phase 8 run at n = 10000 with fewer updates, to keep
# the script short
APP_N, APP_UPDATES = 10000, (4, 8, 8)

# phase 6: the left chain of benchmarks/bench_sparse.py at its widths
# (m = 384, K = 256, rank-8 carriers, 1 % of rows), n raised to 2^20
CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK = 2 ** 20, 384, 256, 8
CHAIN_ROWS = CHAIN_N // 100
# phase 7: the general iterative form under 100-row carriers on A
GI_N, GI_P, GI_K, GI_ROWS = 10000, 128, 16, 100

# phases 10-12: h2o-danube-1.8b serving (arXiv:2401.16818)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "h2o-danube-1.8b", 8, \
    4096, 32
EXACT_LAYERS = 4            # phase 11's depth, cut from 24; phase 17's cuts
HOT_SWAPS = 8               # phase 12's rank-1 head deltas
# phase 15: 8 logit-view tenants, each over its own 4096 of phase 12's
# 32768 hidden states; 3 timed rounds of 8 hot-swaps a tenant; 15b's
# chaos drive makes 200 submissions
FLEET_TENANTS, FLEET_ROWS, FLEET_ROUNDS, FLEET_SUBMISSIONS = 8, 4096, 3, 200
# phase 16: matrix powers (POWERS_N) under rank-HO_RANK batches, HO_FIRINGS
# firings a segment, one segment for each read cadence; 16b's guarded
# drive; 16c's adaptive firings; 16d's fleet submissions
HO_RANK, HO_FIRINGS, HO_READS = 8, 64, (8, 64)
HO_GUARD_FIRINGS, HO_ADAPTIVE_FIRINGS, HO_FLEET_SUBMISSIONS = 24, 24, 120
HO_FLEET_OPTS = {f"powers{i}": {"order": 2, "fold_window": 4}
                 for i in range(2)}
# 16e: Δ²(A·A) against 2·d·d, both one rank-1 product in fp32, relative to
# the view's largest entry
DELTA2_TOL = 1e-5
# 16f: the learning views' ring.  Width and capacity match phase 6's
# n = 2^20 (chosen here, not taken from the F-IVM paper); FIVM_BOOT seeded
# rows, FIVM_EVENTS labeled events read every FIVM_READ_EVERY, a fleet
# tenant fed FIVM_FLEET_EVENTS under a FIVM_SLO-second staleness SLO
FIVM_FEATURES, FIVM_CAPACITY, FIVM_BOOT, FIVM_PROJ = 256, 2 ** 20, 4096, 64
FIVM_EVENTS, FIVM_READ_EVERY, FIVM_FLEET_EVENTS = 1024, 128, 256
FIVM_LAM, FIVM_CLUSTERS, FIVM_SLO = 0.1, 4, 0.5
# Ridge coefficients against batch_ridge in float64 on the live rows, as
# max |B - B64| / max |B64|: G sums >= 4096 rows in fp32 on the card and
# the solve is well conditioned (G about FIVM_BOOT times the identity),
# so a few 1e-6; a lost or doubled event moves B by more than 1e-3
FIVM_TOL = 1e-4
# insert-then-delete against the ring before, relative to each view's
# largest entry: the reference's 1e-6 (tests/test_fivm.py), widened for
# the card's rank-k applies summing in another order
FIVM_RESTORE_TOL = 1e-5
# the maintained XP against X·R computed apart in float64 from the ring's
# own X and R, relative to its largest entry: each row of XP is one fp32
# dot product of 256 terms (a few 1e-7); a row the row kernel misses,
# doubles or writes to the wrong place moves it by O(1)
FIVM_XP_TOL = 1e-5

# phase 17: the transformer families at published widths.  17a serves
# qwen2-moe-a2.7b (hf:Qwen/Qwen1.5-MoE-A2.7B) at full depth on prompts of
# 1024 tokens (the head's f32 logits at every prefill position would take
# 20 GB at 8 x 4096); its f32 cut keeps T*k <= 4096 in forward and decode,
# so both take the dense-safe capacity and drop nothing
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_NEW = "qwen2-moe-a2.7b", 8, 1024, 32
MOE_CUT_BATCH, MOE_CUT_PROMPT = 2, 256
# 17b: qwen3-moe-235b-a22b at full width, 2 of its 94 layers (all 94 take
# 470 GB in bf16)
QWEN3_ARCH, QWEN3_LAYERS, QWEN3_BATCH, QWEN3_PROMPT, QWEN3_NEW = \
    "qwen3-moe-235b-a22b", 2, 4, 512, 8
# 17c: paligemma-3b, 256 image patches and 768 text tokens, 32 decode steps
# in a cache of VLM_MAX_SEQ slots; its f32 cut on VLM_CUT_TEXT tokens
VLM_ARCH, VLM_BATCH, VLM_PATCHES, VLM_TEXT, VLM_NEW = "paligemma-3b", 4, \
    256, 768, 32
VLM_MAX_SEQ = VLM_PATCHES + VLM_TEXT + VLM_NEW
VLM_CUT_BATCH, VLM_CUT_TEXT = 2, 256
# 17d: hubert-xlarge's encoder over 8 x 1024 frames; its f32 cut on 2
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES, AUDIO_CUT_BATCH = "hubert-xlarge", \
    8, 1024, 2

# phase 18: the recurrent families at published widths, bf16.  18a serves
# zamba2-1.2b (arXiv:2411.15242), 18b xlstm-350m (arXiv:2405.04517), each
# cut to RECUR_SERVE_LAYERS (zamba2 two groups of 6 and its tail of 2,
# xlstm one group of 7 + 1; full depth until the script's time limit
# asked for a cut, PERF.md §6, PR 37): a forward over RECUR_BATCH x
# RECUR_FWD_SEQ tokens, then the ServeEngine on RECUR_BATCH prompts of
# RECUR_PROMPT tokens stepped token by token (host-bound: a decode step
# each) and RECUR_NEW greedy steps in a cache of RECUR_MAX_SEQ slots
ZAMBA_ARCH, XLSTM_ARCH = "zamba2-1.2b", "xlstm-350m"
RECUR_SERVE_LAYERS = {ZAMBA_ARCH: 14, XLSTM_ARCH: 8}
RECUR_BATCH, RECUR_FWD_SEQ, RECUR_PROMPT, RECUR_NEW, RECUR_MAX_SEQ = \
    8, 2048, 256, 32, 512
# their f32 cuts at the same widths: zamba2 at 7 layers (one group of 6
# and a tail of 1, so both paths run), xlstm at 8 (one group of 7 + 1)
ZAMBA_CUT_LAYERS, XLSTM_CUT_LAYERS, RECUR_CUT_BATCH = 7, 8, 2
RECUR_CUT_SEQ = RECUR_PROMPT + RECUR_NEW

# phase 21: the row-sharded engine.  21b runs SHARD_WORLD gloo ranks on one
# card (NCCL takes one rank a card); each engine takes SHARD_SINGLE single
# updates, then one batch of SHARD_BATCH; a rank that does not report in
# SHARD_TIMEOUT_S fails the phase
SHARD_WORLD, SHARD_SINGLE, SHARD_BATCH, SHARD_TIMEOUT_S = 4, 3, 16, 600
# 21c: the drift sentinel on a four-rank engine, matrix powers A^16 at
# SHARD_SENTINEL_N probed every second firing (tolerance 5e-3); after the
# first firing SHARD_SENTINEL_SHIFT is added to every entry of P4 on every
# rank; the second firing's probe must find it and its recovery, with one
# more probe and recovery for the descendant it leaves drifted, heal it
SHARD_SENTINEL_N, SHARD_SENTINEL_SHIFT = 4096, 0.05
# phase 22: the LM half of the sharded dist/ on LM_SHARD_WORLD gloo ranks
# sharing the card, over (2, 2) and (1, 4) meshes: danube at full width
# cut to LM_SHARD_LAYERS, one f32 step at LM_SHARD_EXACT's (B, S) (22a),
# LM_SHARD_STEP's bf16 steps (22b, saved and restored onto the (1, 2)
# sub-mesh in 22d); qwen3-moe at full width cut to 1 layer, an f32 forward
# at LM_SHARD_MOE's (B, S): T·k = 4096, so no pair is dropped (22c); the
# training driver's --mesh local for LM_SHARD_DRIVER_STEPS steps (22e).
# Rehearsed on the CPU at the reduced widths with LM_SHARD_REHEARSE's
# (B, S) and steps.
LM_SHARD_WORLD, LM_SHARD_LAYERS, LM_SHARD_TIMEOUT_S = 4, 2, 600
LM_SHARD_EXACT, LM_SHARD_STEP, LM_SHARD_MOE = (4, 512), (4, 2048, 3), \
    (2, 256)
LM_SHARD_DRIVER_STEPS = 3
LM_SHARD_REHEARSE = {"exact": (4, 32), "step": (4, 32, 2), "moe": (2, 32),
                     "cseq_f32": (4, 64, 12, 40),
                     "cseq_bf16": (4, 64, 12, 24)}
# 22c's logits against the single device, of max(|logits|, 1): the
# reference test's bound (tests/test_distributed.py:158)
LM_SHARD_LOGIT_TOL = 5e-3
# 22b's bf16 losses on (2, 2) against the single device's at the same
# global batch, relative, within LM_SHARD_BF16_LOSS_C / sqrt(B·S): the
# sharded step sums its row-parallel products and its gradients in
# another order, and the mean loss averages those roundings over B·S
# tokens.  Sound runs moved it by 1.84e-5 at 4 x 2048 tokens on the card
# and 1.48e-4 at 4 x 32 on the CPU (PERF.md §6, phase 22): both 1.7e-3
# times 1/sqrt(B·S); 1e-2 leaves 6x of that
LM_SHARD_BF16_LOSS_C = 1e-2
# 22f: the "fsdp" rule, {"fsdp": "data"}: the same danube cut with its
# params and optimizer state split over the data axis too, each block
# gathered whole before it runs, on (2, 2) and (4, 1): 22a's f32 gradients
# (both meshes) and, on (4, 1), one step clipped to LM_SHARD_FSDP_CLIP at
# learning rate LM_SHARD_FSDP_LR (the clipped gradients under AdamW's eps,
# where the update is linear in the clip scale, so a wrong global norm
# moves it); the first LM_SHARD_FSDP_STEPS of 22b's bf16 steps (both
# meshes; the (2, 2) params saved and restored without the rule); a decode
# of LM_SHARD_FSDP_DECODE's (B, prompt positions, steps in all) in f32 on
# (2, 2)
LM_SHARD_FSDP_RULES = {"fsdp": "data"}
LM_SHARD_FSDP_CLIP, LM_SHARD_FSDP_LR = 1e-6, 1e-2
LM_SHARD_FSDP_STEPS = 2
LM_SHARD_FSDP_DECODE = (4, 4, 8)
# 22g: the "cache_seq" rule on (1, 4): the same danube cut, each rank
# holding a quarter of the decode cache's slots with every KV head.
# LM_SHARD_CSEQ_F32's (B, max_seq, prompt positions, last position): an
# f32 prefill of fewer positions than one rank's slots (the other ranks
# hold none valid), then steps past one rank's slots, fed the same
# tokens, each step's logits within LM_SHARD_CSEQ_TOL of the single
# device's (of the largest logit, at least 1); LM_SHARD_CSEQ_BF16's the
# bf16 serving decode (a 4096-slot ring, 1024 a rank, decoded past the
# first rank's), fed the same tokens: its logits within
# LM_SHARD_CSEQ_BF16_TOL of the same mesh's under the default rules (the
# cache whole on every rank) and of the single device's, the greedy
# tokens that agree counted (bf16 rounds the activations on both sides
# after sums taken in other orders, so a near-tie may flip, and a greedy
# run fed its own tokens then diverges: the f32 run is the exactness
# check), its ms a step beside the default rules', one step's bytes the
# meta walk's.
LM_SHARD_CSEQ_RULES = {"cache_seq": "model"}
LM_SHARD_CSEQ_F32 = (4, 64, 12, 40)
LM_SHARD_CSEQ_BF16 = (8, 4096, 1000, 1040)
LM_SHARD_CSEQ_TOL = 1e-5
# 22g's bf16 logits against the default rules' and the single device's, of
# the largest logit (at least 1): bf16 rounds every activation to 2^-9 of
# itself, and the two sides round after sums taken in other orders; the
# reduced cut on the CPU moved them by 0.6 % (default rules) and 1.5 %
# (single device) of the largest logit (PERF.md §6, PR 37), 5e-2 leaves 3x
LM_SHARD_CSEQ_BF16_TOL = 5e-2
# 22h: the "seq_sp" rule on (2, 2): 22a's f32 gradients, each leaf within
# LM_SHARD_SEQ_GRAD_TOL of its largest entry and the loss within
# LM_SHARD_SEQ_LOSS_TOL (relative) of the single device's; then 22b's
# first LM_SHARD_FSDP_STEPS bf16 steps, their losses within
# LM_SHARD_SEQ_BF16_TOL (relative) of 22b's single device's, their bytes
# the meta walk's, their ms and peak beside 22b's.
LM_SHARD_SEQ_RULES = {"seq_sp": "model"}
LM_SHARD_SEQ_GRAD_TOL, LM_SHARD_SEQ_LOSS_TOL = 1e-5, 1e-6
LM_SHARD_SEQ_BF16_TOL = 1e-4
# phase 24: the recurrent families and compression on a model axis, on
# LM_SHARD_WORLD gloo ranks sharing the card over (2, 2) and (1, 4), both
# families at published widths cut to ZAMBA_CUT_LAYERS / XLSTM_CUT_LAYERS:
# an f32 step at RECUR_SHARD_EXACT's (B, S) (24a, and 24d's gradients),
# RECUR_SHARD_STEP's bf16 steps (24b, zamba2's saved in 24e), decode of
# RECUR_SHARD_PROMPT positions and RECUR_SHARD_NEW greedy steps (24c);
# the driver for zamba2's cut, RECUR_SHARD_DRIVER_STEPS steps (24f).
# Rehearsed on the CPU at the reduced widths with RECUR_SHARD_REHEARSE's
# sizes.
RECUR_SHARD_EXACT, RECUR_SHARD_STEP = (4, 256), (4, 512, 2)
RECUR_SHARD_PROMPT, RECUR_SHARD_NEW = 32, 8
RECUR_SHARD_COMP_RANK, RECUR_SHARD_DRIVER_STEPS = 4, 3
RECUR_SHARD_DRIVER_BATCH = (8, 128)
RECUR_SHARD_REHEARSE = {"exact": (4, 40), "step": (4, 40, 2),
                        "decode": (8, 4), "driver": (4, 32)}
# 21a against the single-device engine, relative to each view's largest
# entry: the same kernel on the same rows, and every collective of one
# rank a copy, so equal or within a few ulps
SHARD_ONE_TOL = 1e-5

# Tolerance of an attention kernel against its plain version.  f32: the
# kernel tolerance above.  bf16: the plain versions keep p in f32, the
# decode kernel too, and the prefill kernel carries p as two bf16 terms
# (about 2^-17 |p|); each output is rounded once to bf16, so they differ
# by at most one rounding step, <= 2**-7 |x|.
ATTN_TOL = {"float32": (KERNEL_RTOL, KERNEL_ATOL), "bfloat16": (1e-2, 1e-3)}
# Phase 11's end-to-end tolerance, |decode - forward| <= ATOL + RTOL |fwd|
# on every logit: the repo's serving tolerance (tests/test_serve.py:40).
SERVE_RTOL = SERVE_ATOL = 1e-4

# fp32 (non-tensor-core) peak, memory rate and dense bf16 and TF32
# tensor-core peaks per part, from NVIDIA's data sheets at the part's full
# power limit: (name match, fp32 TFLOP/s, TB/s, bf16 TFLOP/s, TF32
# TFLOP/s).
PEAKS = (("H100 PCIe", 51.0, 2.0, 756.0, 378.0),
         ("H100 NVL", 60.0, 3.9, 835.0, 417.5),
         ("H100", 67.0, 3.35, 989.0, 495.0))

SOURCES = {
    "rank_update_batched": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update": "src/repro_torch/kernels/csrc/rank_update.cu",
    "rank_update_rows": "src/repro_torch/kernels/csrc/rank_update_rows.cu",
    "dual_matmul": "src/repro_torch/kernels/csrc/dual_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_fwd_lse":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "flash_decode_lse": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "rank_update_batched_out": "src/repro_torch/kernels/csrc/rank_update.cu",
    "select_commit": "src/repro_torch/kernels/csrc/select_commit.cu"}
# the bf16 prefill kernel danube's head dim 80 takes in
# csrc/flash_attention.cu (the wgmma one; head dims 32, 96 and 256 take
# flash_attention_bf16_mma), as the profiler lists it
FLASH_BF16_KERNEL = "flash_attention_bf16_wgmma"
REPLACES = {
    "rank_update_batched": "src/repro/kernels/rank_update.py:84",
    "rank_update": "src/repro/kernels/rank_update.py:40",
    "rank_update_rows": "src/repro/kernels/rank_update_rows.py:50",
    "dual_matmul": "src/repro/kernels/dual_matmul.py:45",
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
    # the same Pallas forward, also writing its row statistics (which the
    # Pallas kernel computes and its wrapper drops)
    "flash_attention_fwd_lse": "src/repro/kernels/flash_attention.py:77",
    # no Pallas backward: XLA differentiates blockwise_attention, the
    # reference's training path
    "flash_attention_bwd": "src/repro/models/attention.py:99",
    "flash_decode": "src/repro/kernels/flash_decode.py:69",
    # the same Pallas kernel, also writing its row statistics (which it
    # computes and its wrapper drops): a rank's partial of a cache split
    # over ranks ("cache_seq")
    "flash_decode_lse": "src/repro/kernels/flash_decode.py:69",
    # both TPU entries, out of place: every apply of a guarded firing
    "rank_update_batched_out": "src/repro/kernels/rank_update.py:84",
    # no Pallas kernel: the reference's fused jnp.where select-commit
    "select_commit": "src/repro/guard/__init__.py:316"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks(name: str):
    for key, tflops, tbs, bf16, tf32 in PEAKS:
        if key in name:
            return key, tflops * 1e12, tbs * 1e12, bf16 * 1e12, tf32 * 1e12
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def bound(nbytes: float, flops: float, flops_peak: float,
          bytes_peak: float):
    """Least time (ms) for work that must move ``nbytes`` and do
    ``flops``, and which of the two bounds it."""
    t_bytes = nbytes / bytes_peak * 1e3
    t_ops = flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, target_ms: float = 40.0) -> float:
    """Mean ms per call of ``fn`` over a run of launches, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(5, min(200, int(target_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(text: str):
    """(kernel instance, line) for each register and spill line of
    ``ptxas -v`` output; the instance is its mangled name shortened."""
    entry = "?"
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_"
                           r"[0-9a-f]{8}(?:\d+(?:tc|tf32x3))?\d+|^_Z\d+", "",
                           found.group(1)).split("EEv")[0]
        elif "registers" in line or "spill" in line:
            yield entry, line.strip()


def kernel_modules():
    from repro_torch.kernels import (dual_matmul, flash_attention,
                                     flash_decode, rank_update,
                                     rank_update_rows, select_commit)
    return (rank_update, rank_update_rows, dual_matmul, flash_attention,
            flash_decode, select_commit)


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


# rank_update_batched_out's launches by K = T*k, the rank-update entries'
# launches by M's columns p (BY_P) and the dense entries' launches on the
# skinny tile (p < PSKINNY) by K (SKINNY_K), summed over every read of
# the counts after a main-path drive (launches()); phase 3's comparisons
# are never read, since each drive resets the counts first
OUT_RANKS: dict = {}
BY_P: dict = {}
SKINNY_K: dict = {}
# the flash forward entries' launches by the kernel each took
FLASH_BY_KERNEL: dict = {}


def launches() -> dict:
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import rank_update, rank_update_rows
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    for K, count in out_ranks().items():
        OUT_RANKS[K] = OUT_RANKS.get(K, 0) + count
    for counters, into in ((rank_update.COLS, BY_P),
                           (rank_update_rows.COLS, BY_P),
                           (rank_update.SKINNY_RANKS, SKINNY_K),
                           (cuda_fa.BY_KERNEL, FLASH_BY_KERNEL)):
        for entry, counter in counters.items():
            tally = into.setdefault(entry, {})
            for key, count in counter.items():
                tally[key] = tally.get(key, 0) + count
    return out


def dense_ranks() -> dict:
    """rank_update_batched's launches since the last reset, by K = T*k."""
    from repro_torch.kernels import rank_update
    return dict(sorted(rank_update.RANKS["rank_update_batched"].items()))


def out_ranks() -> dict:
    """rank_update_batched_out's launches since the last reset, by K."""
    from repro_torch.kernels import rank_update
    return dict(sorted(
        rank_update.RANKS["rank_update_batched_out"].items()))


def check_launches(label: str, got: dict, expect: dict) -> None:
    """Every kernel's launches equal ``expect``'s count (0 if not named)."""
    expect = {**{name: 0 for name in got}, **expect}
    if got != expect:
        raise AssertionError(f"{label}: kernel launches {got} != the "
                             f"phase's applies {expect}")


def check_close(label: str, got, want, rtol: float = KERNEL_RTOL,
                atol: float = KERNEL_ATOL) -> float:
    """Raise unless |got - want| <= atol + rtol |want|; max abs err."""
    import torch
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or "
                             "non-finite output")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    worst = float(((got - want).abs() - rtol * want.abs()).max()) \
        if got.numel() else 0.0
    if worst > atol:
        raise AssertionError(f"{label}: max abs err {err} exceeds atol "
                             f"{atol} + rtol {rtol} |want|")
    return err


def check_views(label: str, got: dict, want: dict) -> dict:
    """Every view of ``want`` against ``got``, relative to its largest
    entry, within MAIN_TOL."""
    import torch
    rel = {}
    for view, w in want.items():
        g = got[view]
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: view {view} is {tuple(g.shape)}"
                                 f" or non-finite")
        scale = float(w.abs().max()) or 1.0
        rel[view] = float((g - w).abs().max()) / scale
        if rel[view] > MAIN_TOL:
            raise AssertionError(f"{label}: view {view} differs from "
                                 f"re-evaluation by {rel[view]} > {MAIN_TOL}")
    return rel


# -- phase 3 ------------------------------------------------------------------

def skinny_times(kernel, library) -> dict:
    """A skinny-tile shape's kernel and library times by the profiler (the
    kernel's ms by events reads the binding's host time below ~30 us)."""
    return {"device_ms": device_ms_per_call(kernel, reps=40)[1],
            "library_device_ms": device_ms_per_call(library, reps=40)[1],
            "host_us": host_us(kernel)}


def check_grad_refusal() -> dict:
    """Each CUDA entry but flash_attention, given an operand that requires
    grad under grad mode, raises (it has no backward yet; the forward with
    LSE and K1 are not differentiable themselves) and launches nothing;
    flash_attention differentiates: under grad mode it launches the
    forward with the row log-sum-exp once, and its gradient the backward
    (K1) once.  Under no_grad every call launches once."""
    import torch
    from repro_torch.kernels import ops
    (cuda_ru, cuda_rows, cuda_dual, cuda_fa, cuda_fd,
     cuda_sel) = kernel_modules()

    def f(*shape, grad=False):
        return torch.randn(*shape, device=DEVICE).requires_grad_(grad)

    calls = {
        "rank_update": lambda g: cuda_ru.rank_update(
            f(64, 1), f(64, 2, grad=g), f(1, 2)),
        "rank_update_batched": lambda g: cuda_ru.rank_update_batched(
            f(64, 8), f(1, 64, 2), f(1, 8, 2, grad=g)),
        "rank_update_batched_out": lambda g: cuda_ru.rank_update_batched_out(
            f(64, 3, grad=g), f(1, 64, 2), f(1, 3, 2)),
        "rank_update_rows": lambda g: cuda_rows.rank_update_rows(
            f(64, 1), cuda_rows.RowSet([1, 4], 64), f(2, 2, grad=g),
            f(1, 2)),
        "dual_matmul": lambda g: cuda_dual.dual_matmul(
            f(64, 8, grad=g), f(8, 1), f(64, 1)),
        "flash_attention": lambda g: cuda_fa.flash_attention(
            f(1, 8, 2, 64, grad=g), f(1, 8, 2, 64), f(1, 8, 2, 64)),
        "flash_attention_fwd_lse": lambda g: cuda_fa.flash_attention_fwd_lse(
            f(1, 8, 2, 64), f(1, 8, 2, 64, grad=g), f(1, 8, 2, 64)),
        "flash_attention_bwd": lambda g: cuda_fa.flash_attention_bwd(
            f(1, 8, 2, 64), f(1, 8, 2, 64), f(1, 8, 2, 64), f(1, 8, 2, 64),
            f(1, 8, 2, 64, grad=g), torch.zeros(1, 2, 8, device=DEVICE)),
        "flash_decode": lambda g: cuda_fd.flash_decode(
            f(1, 2, 64), f(1, 8, 2, 64, grad=g), f(1, 8, 2, 64), 8),
        "flash_decode_lse": lambda g: cuda_fd.flash_decode_lse(
            f(1, 2, 64, grad=g), f(1, 8, 2, 64), f(1, 8, 2, 64), 8),
        "select_commit": lambda g: cuda_sel.select_commit(
            torch.zeros(1, dtype=torch.int32, device=DEVICE),
            f(4, 4, grad=g), f(4, 4))}

    def counts():   # read apart from launches(): no main-path drive
        return {k: c for mod in kernel_modules()
                for k, c in mod.LAUNCHES.items()}

    reset_launches()
    refused = {}
    for entry, call in calls.items():
        if entry == "flash_attention":
            continue
        try:
            call(True)
            refused[entry] = False
        except RuntimeError as err:
            refused[entry] = ("not differentiable" if entry.startswith(
                "flash_attention") else "no backward yet") in str(err)
    refused_counts = counts()
    out = calls["flash_attention"](True)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    differentiated = {k: c - refused_counts[k] for k, c in counts().items()
                      if k.startswith("flash_attention")}
    before = counts()
    with torch.no_grad():
        for call in calls.values():
            call(True)
    torch.cuda.synchronize()
    after = counts()
    # the plain versions on the CPU still differentiate
    u = torch.randn(16, 2, requires_grad=True)
    ops.rank_update(torch.zeros(16, 1), u, torch.ones(1, 2)).sum().backward()
    rec = {"phase": "grad_refusal", "refused": refused,
           "launches_refused": {e: refused_counts[e] for e in refused},
           "flash_attention_grad_launches": differentiated,
           "launches_no_grad": {e: after[e] - before[e] for e in calls},
           "cpu_grad_ok": bool(torch.equal(u.grad, torch.ones(16, 2)))}
    log("grad " + json.dumps(rec))
    if not all(refused.values()) or any(refused_counts.values()) or any(
            after[e] - before[e] != 1 for e in calls) \
            or differentiated != {"flash_attention": 0,
                                  "flash_attention_fwd_lse": 1,
                                  "flash_attention_bwd": 1} \
            or not rec["cpu_grad_ok"]:
        raise AssertionError(f"grad refusal: {rec}")
    reset_launches()
    return rec


def check_kernels(flops_peak: float, bytes_peak: float):
    """Each CUDA entry against its plain version at the given shapes.
    Returns {entry: [per-shape records]}."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    cuda_ru, cuda_rows, cuda_dual = kernel_modules()[:3]

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    def record(entry, shape, err, ms, plain_ms, lib_ms, nbytes, flops,
               **times):
        b_ms, b_by = bound(nbytes, flops, flops_peak, bytes_peak)
        # achieved fp32 rate, and the kernel's time over the library call's
        rec = {"entry": entry, **shape, "max_abs_err": err, "ms": ms,
               **times, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "vs_library": ms / lib_ms}
        log("kernel " + json.dumps(rec))
        out[entry].append(rec)

    out = {name: [] for name in SOURCES}

    # (n, p, T, k): the main path's applies (matrix powers' views at every K
    # of a batch of 16, OLS X and Z/W, phase 16f's ring at order 1: G at
    # K = 2, Y and W at K = 1), a ragged shape, and T > 1 stacks
    # phase 21b's shards: a rank's 2500 rows of matrix powers' views (K = 1
    # at A, 16 at P16 and at A in a batch, 256 at P16 in a batch) and of
    # OLS's X and Z/W
    batched_cases = [(10000, 10000, 1, K)
                     for K in (1, 16, 32, 64, 128, 256)] + [
        (2500, 10000, 1, K) for K in (1, 16, 256)] + [
        (4096, 8192, 1, 1), (2048, 8192, 1, 2)] + [
        (8192, 8192, 1, 2), (8192, 8192, 1, 32),
        (16384, 8192, 1, 1), (16384, 8192, 1, 16),
        (FIVM_FEATURES, FIVM_FEATURES, 1, 2), (FIVM_CAPACITY, 1, 1, 1),
        (37, 101, 1, 5), (1000, 777, 4, 3), (10000, 10000, 16, 1)]
    # the skinny tile (p < 4): phase 16f's 2^20 x 1 Y and W at K = 1-3
    # (the main path's only launches below 4 columns) and views of 2 and 3
    # columns, a T = 16 stack of rank-1 pairs and K = 64 at 2^20 x 1, the
    # p = 1 programs' vectors (PageRank's 10000 x 1, OLS's 8192 x 1; their
    # engines re-evaluate those views, so they take no launch) at K = 1
    batched_cases += [(FIVM_CAPACITY, p, 1, K) for p in (1, 2, 3)
                      for K in (1, 2, 3) if (p, K) != (1, 1)] + [
        (FIVM_CAPACITY, 1, 16, 1), (FIVM_CAPACITY, 1, 1, 64),
        (APP_N, 1, 1, 1), (OLS_N, 1, 1, 1)]
    single_cases = [(10000, 10000, 1), (2500, 10000, 1), (16384, 8192, 1),
                    (37, 101, 5),
                    (FIVM_CAPACITY, 1, 1), (OLS_N, 1, 1)]
    cases = [("rank_update_batched", c) for c in batched_cases] + \
            [("rank_update", (n, p, 1, k)) for n, p, k in single_cases]
    for entry, (n, p, t, k) in cases:
        m0 = randn(n, p)
        u = randn(t, n, k)
        v = randn(t, p, k)
        K = t * k
        u2 = u.permute(1, 0, 2).reshape(n, K).contiguous()
        v2 = v.permute(1, 0, 2).reshape(p, K).contiguous()
        if entry == "rank_update":
            args = (u[0], v[0])
            kernel, plain = cuda_ru.rank_update, ref.rank_update
        else:
            args = (u, v)
            kernel, plain = cuda_ru.rank_update_batched, ref.rank_update_batched
        want = plain(m0, *args)
        got = kernel(m0.clone(), *args)
        torch.cuda.synchronize()
        err = check_close(f"{entry} {(n, p, t, k)}", got, want)
        del want, got
        work = m0.clone()
        ms = time_ms(lambda: kernel(work, *args))
        plain_ms = time_ms(lambda: plain(m0, *args))
        lib_ms = time_ms(lambda: work.addmm_(u2, v2.T))
        record(entry, {"n": n, "p": p, "T": t, "k": k}, err, ms, plain_ms,
               lib_ms, 8.0 * n * p + 4.0 * K * (n + p), 2.0 * n * p * K,
               **(skinny_times(lambda: kernel(work, *args),
                               lambda: work.addmm_(u2, v2.T))
                  if p < cuda_ru.PSKINNY else {}))
        del m0, u, v, u2, v2, work

    # the out-of-place entry (every apply of a guarded firing, and of a
    # deferred engine's firings and folds) at matrix powers' K: single
    # updates and batches (a rank-1 firing's chain at K = 1, 2, 4, 8, 16,
    # as 16b's window-4 folds), phase 16a's banked inputs (K = 32, 64, 128)
    # and its fold sweeps, whose chain doubles K at each power (64 x 2^4
    # for order 2, 128 x 2^4 for order 3); phase 16f's banked X, Y and W
    # applies at order 2 (two or three events a window); and a ragged
    # shape.  Each is held to the plain version and, bit for bit, to the
    # in-place entry, its source untouched and its flag clear; the
    # library call is an out-of-place torch.addmm
    for n, p, k in [(10000, 10000, K) for K in (
            1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)] + [
            (FIVM_CAPACITY, FIVM_FEATURES, K) for K in (2, 3)] + [
            (FIVM_CAPACITY, p, K) for p in (1, 2, 3) for K in (1, 2, 3)] + [
            (FIVM_CAPACITY, 1, 64), (37, 101, 5)]:
        m0 = randn(n, p)
        u = randn(1, n, k)
        v = randn(1, p, k)
        src = m0.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        got = cuda_ru.rank_update_batched_out(m0, u, v, flag)
        same = torch.equal(got, cuda_ru.rank_update_batched(src.clone(), u,
                                                            v))
        want, bad = ref.rank_update_batched_out(m0, u, v)
        torch.cuda.synchronize()
        err = check_close(f"rank_update_batched_out {(n, p, k)}", got, want)
        if not same or int(flag) != int(bad) or not torch.equal(m0, src):
            raise AssertionError(f"rank_update_batched_out {(n, p, k)}: "
                                 f"bitwise in-place {same}, flag "
                                 f"{int(flag)}, source kept "
                                 f"{torch.equal(m0, src)}")
        del got, want, src
        ms = time_ms(lambda: cuda_ru.rank_update_batched_out(m0, u, v, flag))
        plain_ms = time_ms(lambda: ref.rank_update_batched_out(m0, u, v))
        lib_ms = time_ms(lambda: torch.addmm(m0, u[0], v[0].T))
        record("rank_update_batched_out", {"n": n, "p": p, "T": 1, "k": k},
               err, ms, plain_ms, lib_ms, 8.0 * n * p + 4.0 * k * (n + p),
               2.0 * n * p * k, **(skinny_times(
                   lambda: cuda_ru.rank_update_batched_out(m0, u, v, flag),
                   lambda: torch.addmm(m0, u[0], v[0].T))
                  if p < cuda_ru.PSKINNY else {}))
        del m0, u, v

    # select_commit at matrix powers' view size: a clean firing (flags
    # clear: the launch, whose every block reads the flags and returns)
    # and a failed one (old copied over new, bit for bit); the plain
    # version is torch.where over the flags, the library call one
    # torch.where on a ready predicate
    n = 10000
    old, new = randn(n, n), randn(n, n)
    keep = new.clone()
    clean = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    failed = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    cuda_sel = kernel_modules()[5]
    cuda_sel.select_commit(clean, old, new)
    kept = torch.equal(new, keep)
    cuda_sel.select_commit(failed, old, new)
    torch.cuda.synchronize()
    if not kept or not torch.equal(new, ref.select_commit(failed, old,
                                                           keep)):
        raise AssertionError(f"select_commit: clean kept new {kept}, "
                             "failed gave old bit for bit "
                             f"{torch.equal(new, old)}")
    for case, flags, nbytes in (("clean", clean, 8.0),
                                ("failed", failed, 8.0 * n * n + 8.0)):
        ok = ~flags.bool().any()

        def kernel():
            cuda_sel.select_commit(flags, old, new)

        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: ref.select_commit(flags, old, new))
        lib_ms = time_ms(lambda: torch.where(ok, new, old))
        busy, summed = device_ms_per_call(kernel, "select_commit", reps=40)
        record("select_commit", {"n": n, "p": n, "case": case}, 0.0, ms,
               plain_ms, lib_ms, nbytes, 0.0, device_ms=busy,
               kernel_sum_ms=summed, host_us=host_us(kernel))
    del old, new, keep

    # (n, p, r, k): phase 6's applies to X and to Y1, Y2 (one carrier, and
    # a stacked batch of about 16 x 1 % of the rows at rank 128), phase 7's
    # to A and S2 and to T1 (one carrier, a batch of 8), phase 16f's ring
    # at order 1 (one event's row of X and of XP = X·R), a ragged shape.
    # ms and device_ms are warm: every launch on the same rows, which stay
    # in L2 where they fit.  cold_ms and cold_device_ms rotate over
    # ROW_COLD_SETS or more RowSets with their own blocks, touching at least
    # twice the L2 where the view is large enough, as the engine's carriers
    # touch other rows every firing.  device_ms is the profiler's kernel
    # time, host_us the binding's enqueue time: where the kernel is shorter
    # than the host's work, ms is the host's.
    rng = np.random.default_rng(0)
    row_cases = [(CHAIN_N, CHAIN_M, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_K, CHAIN_ROWS, CHAIN_RANK),
                 (CHAIN_N, CHAIN_M, 15 * CHAIN_ROWS, 16 * CHAIN_RANK),
                 (GI_N, GI_N, GI_ROWS, 1), (GI_N, GI_P, GI_ROWS, 1),
                 (GI_N, GI_N, 8 * GI_ROWS, 8),
                 (FIVM_CAPACITY, FIVM_FEATURES, 1, 1),
                 (FIVM_CAPACITY, FIVM_PROJ, 1, 1), (37, 101, 5, 3),
                 # the skinny tile: one event's row of a 2^20 x 1 view, and
                 # phase 6's carriers on a 2^20 x 1 view
                 (FIVM_CAPACITY, 1, 1, 1),
                 (CHAIN_N, 1, CHAIN_ROWS, CHAIN_RANK)]
    for n, p, r, k in row_cases:
        m0 = randn(n, p)
        v = randn(p, k)
        count = max(ROW_COLD_SETS,
                    min(64, -(-2 * L2_BYTES // (4 * r * p))))
        sets = [(cuda_rows.RowSet(np.sort(rng.choice(n, r, replace=False)),
                                  n), randn(r, k)) for _ in range(count)]
        for rs, _ in sets:   # each set's ids uploaded before any timing
            rs.ids(m0.device)
        rows, block = sets[0]
        idx = rows.index(DEVICE)
        want = ref.rank_update_rows(m0, idx, block, v)
        got = cuda_rows.rank_update_rows(m0.clone(), rows, block, v)
        torch.cuda.synchronize()
        err = check_close(f"rank_update_rows {(n, p, r, k)}", got, want)
        del want, got
        work = m0.clone()
        turn = itertools.count()

        def warm():
            cuda_rows.rank_update_rows(work, rows, block, v)

        def cold():
            cuda_rows.rank_update_rows(work, *sets[next(turn) % count], v)

        ms = time_ms(warm)
        times = {"cold_ms": time_ms(cold),
                 "device_ms": device_ms_per_call(warm, reps=40)[1],
                 "cold_device_ms": device_ms_per_call(cold, reps=40)[1],
                 "host_us": host_us(warm), "cold_sets": count}
        plain_ms = time_ms(lambda: ref.rank_update_rows(m0, idx, block, v))
        lib_ms = time_ms(lambda: work.index_add_(0, idx, block @ v.T))
        record("rank_update_rows", {"n": n, "p": p, "r": r, "k": k}, err, ms,
               plain_ms, lib_ms, 8.0 * r * p + 4.0 * k * (r + p) + 4.0 * r,
               2.0 * r * p * k, **times)
        del m0, v, sets, rows, block, work

    # (n, m, k): phase 9's W (8192^2, k = 1) and ragged shapes.  device_ms
    # is the union of the kernels' intervals under the profiler (the final
    # sum is a programmatic dependent launch), kernel_sum_ms their summed
    # time, host_us the binding's enqueue time; where the kernels take less
    # than the host, ms (events) reads the host.  The same for the library
    # pair.
    for n, m, k in [(8192, 8192, 1), (1000, 777, 5), (37, 101, 1)]:
        a = randn(n, m)
        u = randn(m, k)
        v = randn(n, k)
        got = cuda_dual.dual_matmul(a, u, v)
        want = ref.dual_matmul(a, u, v)
        torch.cuda.synchronize()
        err = max(check_close(f"dual_matmul {(n, m, k)} {name}", g, w)
                  for name, g, w in zip("PQ", got, want))

        def kernel():
            cuda_dual.dual_matmul(a, u, v)

        def library():
            return a @ u, a.T @ v

        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: ref.dual_matmul(a, u, v))
        lib_ms = time_ms(library)
        busy, summed = device_ms_per_call(kernel, "dual_", reps=40)
        lib_busy, lib_summed = device_ms_per_call(library, reps=40)
        record("dual_matmul", {"n": n, "m": m, "k": k}, err, ms, plain_ms,
               lib_ms, 4.0 * n * m + 4.0 * k * (2 * n + 2 * m),
               4.0 * n * m * k, device_ms=busy, kernel_sum_ms=summed,
               host_us=host_us(kernel), library_device_ms=lib_busy,
               library_kernel_sum_ms=lib_summed,
               library_host_us=host_us(library))
        del a, u, v, got, want
    torch.cuda.empty_cache()
    return out


# -- phase 3, the flash kernels -------------------------------------------------

def attention_pairs(s: int, causal: bool, window, prefix: int = 0) -> int:
    """Query-key pairs the mask keeps over a length-s sequence: under the
    causal mask query qp keeps keys up to qp, or up to prefix - 1 inside
    the prefix (the prefix's square is counted whole), then the window."""
    import numpy as np
    qp = np.arange(s, dtype=np.int64)
    hi = np.where(qp < prefix, prefix - 1, qp) if causal \
        else np.full(s, s - 1, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_record(entry, shape, err, ms, plain_ms, lib_ms, nbytes, flops,
                     dtype, bytes_peak, flops_peak, bf16_peak, tf32_peak,
                     log_it=True) -> dict:
    """A kernel record whose operations bound is taken at the least time
    the card can do the inputs' products in: bf16 on the tensor cores, or
    f32-exact as three split TF32 products (a third of the TF32 peak); the
    bound at the fp32 FMA peak is kept beside it."""
    peak = bf16_peak if dtype == "bfloat16" else tf32_peak / 3
    b_ms, b_by = bound(nbytes, flops, peak, bytes_peak)
    rec = {"entry": entry, **shape, "dtype": dtype, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_ms": bound(nbytes, flops, flops_peak, bytes_peak)[0],
           "flops": flops, "bytes": nbytes}
    if entry == "flash_attention":
        # achieved rate: the tensor cores are in use above the fp32 peak
        rec["tflops"] = flops / (ms * 1e-3) / 1e12
        rec["bf16_peak_frac"] = flops / (ms * 1e-3) / bf16_peak
    if log_it:
        log("kernel " + json.dumps(rec))
    return rec


def sdpa_inputs(q, k, v, causal, window, prefix):
    """SDPA's operands for the flash kernels' function: q, k, v as (B,
    heads, S, hd) and the keep-mask, None where ``is_causal`` and
    ``enable_gqa`` express it; SDPA's fused kernels take no mask under
    enable_gqa (its math path would build every score), so a window or
    the prefix-LM term gets the explicit mask and the expanded heads."""
    import torch
    from repro_torch.kernels import ref
    s, h, kvh = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if (window is not None and window < s) or (causal and prefix > 0):
        pos = torch.arange(s, device=q.device)
        mask = ref.attention_keep(pos, pos, causal=causal, window=window,
                                  prefix_len=prefix)
        kt, vt = (x.repeat_interleave(h // kvh, dim=1) for x in (kt, vt))
    return qt, kt, vt, mask


def check_flash_attention(q, k, v, causal, window, peaks_, label,
                          timed=True, prefix=0) -> dict:
    """The flash-attention kernel against its plain version (and timed
    against it and SDPA) on q (B,S,H,hd), k/v (B,S,KV,hd), the first
    ``prefix`` positions bidirectional under the causal mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    got = cuda_fa.flash_attention(q, k, v, **opts)
    want = ref.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {label}", got, want,
                      *ATTN_TOL[dtype])
    del got, want
    shape = {"b": b, "s": s, "h": h, "kvh": k.shape[2], "hd": hd,
             "causal": causal, "window": window, "prefix": prefix,
             "case": label}
    if not timed:
        return {"case": label, "max_abs_err": err}
    ms = time_ms(lambda: cuda_fa.flash_attention(q, k, v, **opts))
    plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, **opts))
    qt, kt, vt, mask = sdpa_inputs(q, k, v, causal, window, prefix)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=mask is None))
    del kt, vt
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * b * h * hd * attention_pairs(s, causal, window, prefix)
    rec = attention_record("flash_attention", shape, err, ms, plain_ms,
                           lib_ms, nbytes, flops, dtype, *peaks_,
                           log_it=False)
    rec.update({"kernel": cuda_fa.kernel_of(q.dtype, hd),
                "x_sdpa": ms / lib_ms})
    log("kernel " + json.dumps(rec))
    return rec


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``: the time to enqueue ``reps``
    calls back to back (the card drains them afterwards)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def device_ms_per_call(fn, match=None, reps: int = 20):
    """(busy, summed) device ms per call of ``fn`` from ``torch.profiler``:
    the union of the intervals of the kernels whose names hold ``match``
    (else of all kernels), and the sum of their times; None when the
    profiler saw no device activity."""
    prof = device_profile(lambda: [fn() for _ in range(reps)],
                          match=(match,) if match else ())
    if prof["device_ms"] is None:
        return None, None
    if match:
        summed, _, busy = prof["match"][match]
    else:
        summed, busy = prof["device_ms"], prof["busy_ms"]
    return busy / reps, summed / reps


def check_flash_decode(q, kc, vc, n_valid, peaks_, label,
                       timed=True) -> dict:
    """The flash-decode kernel against its plain version, with n_valid as
    an int and as a device tensor (the decode step's form; the two agree
    bit for bit, and so do repeated calls), and timed against the plain
    version and SDPA: CUDA events over back-to-back calls (``ms``), the
    profiler's kernel time (``device_ms``) and the host's enqueue time
    (``host_us``), the last two for SDPA as well."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as cuda_fd
    from repro_torch.kernels import ref
    b, h, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    n_t = torch.tensor(n_valid, dtype=torch.int32, device=q.device)
    got = cuda_fd.flash_decode(q, kc, vc, n_t)
    want = ref.flash_decode(q, kc, vc, n_valid)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode {label}", got, want, *ATTN_TOL[dtype])
    for again in (cuda_fd.flash_decode(q, kc, vc, n_valid),
                  cuda_fd.flash_decode(q, kc, vc, n_t)):
        if not torch.equal(again, got):
            raise AssertionError(f"flash_decode {label}: two calls differ")
    del got, want
    if not timed:
        return {"case": label, "max_abs_err": err}
    shape = {"b": b, "L": kc.shape[1], "h": h, "kvh": kc.shape[2], "hd": hd,
             "n_valid": n_valid, "case": label}

    def kernel():
        return cuda_fd.flash_decode(q, kc, vc, n_t)

    qt = q[:, :, None]
    kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (kc, vc))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ref.flash_decode(q, kc, vc, n_t))
    lib_ms = time_ms(library)
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * b * n_valid * kc.shape[2] * hd)
    flops = 4.0 * b * h * hd * n_valid
    rec = attention_record("flash_decode", shape, err, ms, plain_ms, lib_ms,
                           nbytes, flops, dtype, *peaks_, log_it=False)
    busy, summed = device_ms_per_call(kernel, "flash_decode")
    lib_busy, lib_summed = device_ms_per_call(library)
    rec.update({"device_ms": busy, "kernel_sum_ms": summed,
                "host_us": host_us(kernel), "library_device_ms": lib_busy,
                "library_kernel_sum_ms": lib_summed,
                "library_host_us": host_us(library)})
    log("kernel " + json.dumps(rec))
    return rec


def check_flash_decode_lse(q, kc, vc, n_valid, peaks_, label,
                           timed=True) -> dict:
    """The flash-decode kernel's LSE instance (flash_decode_fwd_lse, the
    cache_seq decode's per-rank partial) against ref.flash_decode_lse,
    n_valid a device tensor as the decode step gives it: out (f32,
    unrounded) and lse within the f32 kernel tolerance whatever the
    caches' type (the scores' products are exact in f32 and p carries
    about 24 bits); at n_valid 0 out 0 and lse -inf exactly; the output
    rounded to the caches' type flash_decode's bit for bit; two calls
    bit for bit.  Timed (n_valid > 0) against the plain version and SDPA
    over the valid slots (which gives the output, not its statistics):
    CUDA events, and the profiler's kernel time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as cuda_fd
    from repro_torch.kernels import ref
    b, h, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    n_t = torch.tensor(n_valid, dtype=torch.int32, device=q.device)
    out, lse = cuda_fd.flash_decode_lse(q, kc, vc, n_t)
    want, want_lse = ref.flash_decode_lse(q, kc, vc, n_valid)
    torch.cuda.synchronize()
    if n_valid == 0:
        if not (torch.equal(out, torch.zeros_like(out))
                and torch.isneginf(lse).all()):
            raise AssertionError(f"flash_decode_lse {label}: n_valid 0 "
                                 "gave other than out 0 and lse -inf")
        err = 0.0
    else:
        err = max(check_close(f"flash_decode_lse {label} out", out, want),
                  check_close(f"flash_decode_lse {label} lse", lse,
                              want_lse))
        if not torch.equal(out.to(q.dtype),
                           cuda_fd.flash_decode(q, kc, vc, n_t)):
            raise AssertionError(f"flash_decode_lse {label}: its rounded "
                                 "output is not flash_decode's")
    again = cuda_fd.flash_decode_lse(q, kc, vc, n_t)
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        raise AssertionError(f"flash_decode_lse {label}: two calls differ")
    del out, lse, want, want_lse, again
    if not timed:
        return {"case": label, "max_abs_err": err}
    shape = {"b": b, "L": kc.shape[1], "h": h, "kvh": kc.shape[2], "hd": hd,
             "n_valid": n_valid, "case": label}

    def kernel():
        return cuda_fd.flash_decode_lse(q, kc, vc, n_t)

    qt = q[:, :, None]
    kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (kc, vc))
    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ref.flash_decode_lse(q, kc, vc, n_t))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True))
    nbytes = (q.numel() * q.element_size() + 4 * b * h * (hd + 1)
              + 2 * b * n_valid * kc.shape[2] * hd * kc.element_size())
    flops = 4.0 * b * h * hd * n_valid
    rec = attention_record("flash_decode_lse", shape, err, ms, plain_ms,
                           lib_ms, nbytes, flops, dtype, *peaks_,
                           log_it=False)
    busy, summed = device_ms_per_call(kernel, "flash_decode")
    rec.update({"device_ms": busy, "kernel_sum_ms": summed,
                "host_us": host_us(kernel)})
    log("kernel " + json.dumps(rec))
    return rec


# phase 3's flash-attention forward cases (check_flash_kernels): (label,
# b, s, h, kvh, hd, window, dtype, causal, prefix)
FLASH_CASES = [
    ("danube_prefill_bf16", 8, 4096, 32, 8, 80, 4096, "bfloat16", True, 0),
    ("danube_prefill_bf16_s4128", 8, 4128, 32, 8, 80, 4096, "bfloat16",
     True, 0),
    ("danube_prefill_f32_s4128", 8, 4128, 32, 8, 80, 4096, "float32",
     True, 0),
    ("starcoder2_bf16", 2, 4096, 36, 4, 128, None, "bfloat16", True, 0),
    ("window1024_bf16", 2, 4096, 32, 8, 80, 1024, "bfloat16", True, 0),
    ("ragged_s1000_bf16", 2, 1000, 32, 8, 80, None, "bfloat16", True, 0),
    ("paligemma_prefill_bf16", VLM_BATCH, VLM_PATCHES + VLM_TEXT, 8,
     1, 256, None, "bfloat16", True, VLM_PATCHES),
    ("paligemma_prefill_f32", VLM_BATCH, VLM_PATCHES + VLM_TEXT, 8,
     1, 256, None, "float32", True, VLM_PATCHES),
    ("hubert_prefill_bf16", AUDIO_BATCH, AUDIO_FRAMES, 16, 16, 80,
     None, "bfloat16", False, 0),
    ("qwen2_moe_prefill_bf16", MOE_BATCH, MOE_PROMPT, 16, 16, 128,
     None, "bfloat16", True, 0),
    ("qwen3_moe_prefill_bf16", QWEN3_BATCH, QWEN3_PROMPT, 64, 4,
     128, None, "bfloat16", True, 0),
    ("qwen2_moe_cut_prefill_f32", MOE_CUT_BATCH, MOE_CUT_PROMPT, 16,
     16, 128, None, "float32", True, 0),
    ("qwen2_moe_cut_forward_f32", MOE_CUT_BATCH,
     MOE_CUT_PROMPT + MOE_NEW, 16, 16, 128, None, "float32", True, 0),
    ("paligemma_cut_forward_f32", VLM_CUT_BATCH,
     VLM_PATCHES + VLM_CUT_TEXT + VLM_NEW, 8, 1, 256, None, "float32",
     True, VLM_PATCHES),
    ("hubert_cut_f32", AUDIO_CUT_BATCH, AUDIO_FRAMES, 16, 16, 80,
     None, "float32", False, 0),
    ("zamba2_forward_bf16", RECUR_BATCH, RECUR_FWD_SEQ, 32, 32, 64,
     None, "bfloat16", True, 0),
    ("zamba2_cut_forward_f32", RECUR_CUT_BATCH, RECUR_CUT_SEQ, 32,
     32, 64, None, "float32", True, 0),
    # two dense configs no phase serves: command-r-plus-104b (a
    # group of 12) and qwen1.5-32b (H = KV = 40), hd 128
    ("command_r_prefill_bf16", 2, 2048, 96, 8, 128, None, "bfloat16",
     True, 0),
    ("command_r_prefill_f32", 2, 2048, 96, 8, 128, None, "float32", True,
     0),
    ("qwen15_32b_prefill_bf16", 2, 2048, 40, 40, 128, None, "bfloat16",
     True, 0),
    ("qwen15_32b_prefill_f32", 2, 2048, 40, 40, 128, None, "float32",
     True, 0),
    # phase 22c's per-rank shape: qwen3-moe's 16 query heads and
    # one KV head a rank of (1, 4)
    ("shard_qwen3_forward_f32", LM_SHARD_MOE[0], LM_SHARD_MOE[1], 16,
     1, 128, None, "float32", True, 0),
    # phase 24's per-rank shapes: zamba2's shared block, 16 of its
    # 32 heads a rank of (2, 2), two data rows a rank (24a f32, 24b
    # bf16)
    ("shard_zamba2_exact_f32", RECUR_SHARD_EXACT[0] // 2,
     RECUR_SHARD_EXACT[1], 16, 16, 64, None, "float32", True, 0),
    ("shard_zamba2_step_bf16", RECUR_SHARD_STEP[0] // 2,
     RECUR_SHARD_STEP[1], 16, 16, 64, None, "bfloat16", True, 0)]


def check_flash_kernels(peaks_) -> dict:
    """Phase 3's flash cases: danube's prefill (B=8, S=4096, H=32, KV=8,
    hd=80, its 4096 window) in bf16 and, at phase 11's ragged 4128, in
    bf16 and f32; starcoder2's heads (H=36, KV=4, hd=128); a window
    shorter than S; a ragged S; decode over danube's 4096-slot ring at
    n_valid 1, 2049 and 4096 (a wrapped ring is full), bf16 and f32, and
    starcoder2's.  Phase 17's shapes: paligemma's prefill (B=4, S=1024,
    H=8, KV=1, hd=256, a prefix of 256) in bf16 and f32, hubert's (H=KV=16,
    hd=80, full attention), qwen2-moe's (H=KV=16, hd=128) and qwen3-moe's
    (H=64, KV=4, hd=128); decode for qwen2-moe, qwen3-moe (a group of 16)
    and paligemma (hd 256, bf16 and f32, L = n_valid = 1056); and phase
    17's f32 cuts at their own shapes: qwen2-moe's prefill and forward
    (S=256, 288) and decode (L = n_valid = 288), paligemma's forward (S=544,
    prefix 256) and decode (L = n_valid = 544), hubert's (S=1024, full).
    Phase 18's: zamba2's shared block at head dim 64, a group of 1, its
    forward (B=8, S=2048, H=KV=32) in bf16 and its cut's (B=2, S=288) in
    f32; decode over its 512-slot cache at n_valid 288 in bf16 and over
    the cut's full 288-slot cache in f32.  Two dense configs that no phase
    serves, at hd 128 in bf16 and f32: command-r-plus-104b (H=96, KV=8, a
    group of 12) and qwen1.5-32b (H=KV=40), prefill at B=2, S=2048 and
    decode at B=8, L=n_valid=4096.  Phase 22c's per-rank shape: qwen3-moe's
    16 query heads and one KV head a rank (B=2, S=256, hd 128) in f32;
    22f's decode (danube's 16 query and 4 KV heads a rank of (2, 2), and
    the single device's, over a cache of 8 slots) in f32.  The decode
    kernel's LSE instance (flash_decode_lse) at 22g's per-rank shapes
    (danube's heads over a quarter of its bf16 ring, full and with no
    valid slot; the f32 cut's) and at the single device's ring."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"flash_attention": [], "flash_decode": [], "flash_decode_lse": []}
    for label, b, s, h, kvh, hd, window, dt, causal, prefix in FLASH_CASES:
        dt = getattr(torch, dt)
        q = randn(b, s, h, hd, dtype=dt)
        k, v = randn(b, s, kvh, hd, dtype=dt), randn(b, s, kvh, hd, dtype=dt)
        out["flash_attention"].append(check_flash_attention(
            q, k, v, causal, window, peaks_, label, prefix=prefix))
        del q, k, v
        torch.cuda.empty_cache()
    # (label, b, L, h, kvh, hd, n_valid, dtype)
    for label, b, L, h, kvh, hd, n_valid, dt in [
            ("danube_decode_bf16_n1", 8, 4096, 32, 8, 80, 1, bf16),
            ("danube_decode_bf16_n2049", 8, 4096, 32, 8, 80, 2049, bf16),
            ("danube_decode_bf16_wrapped", 8, 4096, 32, 8, 80, 4096, bf16),
            ("danube_decode_f32_wrapped", 8, 4096, 32, 8, 80, 4096, f32),
            ("starcoder2_decode_bf16", 8, 4096, 36, 4, 128, 4096, bf16),
            ("qwen2_moe_decode_bf16", MOE_BATCH, MOE_PROMPT + MOE_NEW, 16,
             16, 128, MOE_PROMPT + MOE_NEW, bf16),
            ("qwen3_moe_decode_bf16", QWEN3_BATCH, QWEN3_PROMPT + QWEN3_NEW,
             64, 4, 128, QWEN3_PROMPT + QWEN3_NEW, bf16),
            ("paligemma_decode_bf16", VLM_BATCH, VLM_MAX_SEQ, 8, 1, 256,
             VLM_MAX_SEQ, bf16),
            ("paligemma_decode_f32", VLM_BATCH, VLM_MAX_SEQ, 8, 1, 256,
             VLM_MAX_SEQ, f32),
            ("qwen2_moe_cut_decode_f32", MOE_CUT_BATCH,
             MOE_CUT_PROMPT + MOE_NEW, 16, 16, 128, MOE_CUT_PROMPT + MOE_NEW,
             f32),
            ("paligemma_cut_decode_f32", VLM_CUT_BATCH,
             VLM_PATCHES + VLM_CUT_TEXT + VLM_NEW, 8, 1, 256,
             VLM_PATCHES + VLM_CUT_TEXT + VLM_NEW, f32),
            ("zamba2_decode_bf16", RECUR_BATCH, RECUR_MAX_SEQ, 32, 32, 64,
             RECUR_PROMPT + RECUR_NEW, bf16),
            ("zamba2_cut_decode_f32", RECUR_CUT_BATCH, RECUR_CUT_SEQ, 32, 32,
             64, RECUR_CUT_SEQ, f32),
            ("command_r_decode_bf16", 8, 4096, 96, 8, 128, 4096, bf16),
            ("command_r_decode_f32", 8, 4096, 96, 8, 128, 4096, f32),
            ("qwen15_32b_decode_bf16", 8, 4096, 40, 40, 128, 4096, bf16),
            ("qwen15_32b_decode_f32", 8, 4096, 40, 40, 128, 4096, f32),
            # phase 24c's: zamba2's 8 of 32 heads a rank of (1, 4), and
            # the single device's 32, over the whole cache
            ("shard_zamba2_decode_f32", RECUR_SHARD_EXACT[0],
             RECUR_SHARD_PROMPT + RECUR_SHARD_NEW, 8, 8, 64,
             RECUR_SHARD_PROMPT + RECUR_SHARD_NEW, f32),
            ("zamba2_shard_single_decode_f32", RECUR_SHARD_EXACT[0],
             RECUR_SHARD_PROMPT + RECUR_SHARD_NEW, 32, 32, 64,
             RECUR_SHARD_PROMPT + RECUR_SHARD_NEW, f32),
            # 22f's decode: danube's 16 query and 4 KV heads of (2, 2), two
            # data rows a rank, and the single device's, over the whole
            # cache
            ("shard_danube_fsdp_decode_f32", LM_SHARD_FSDP_DECODE[0] // 2,
             LM_SHARD_FSDP_DECODE[2], 16, 4, 80, LM_SHARD_FSDP_DECODE[2],
             f32),
            ("danube_fsdp_single_decode_f32", LM_SHARD_FSDP_DECODE[0],
             LM_SHARD_FSDP_DECODE[2], 32, 8, 80, LM_SHARD_FSDP_DECODE[2],
             f32)]:
        q = randn(b, h, hd, dtype=dt)
        kc, vc = (randn(b, L, kvh, hd, dtype=dt) for _ in range(2))
        out["flash_decode"].append(check_flash_decode(
            q, kc, vc, n_valid, peaks_, label))
        del q, kc, vc
    # the LSE instance: 22g's per-rank shape (danube's heads over a quarter
    # of its bf16 decode ring, full, and past every valid slot: n_valid
    # 0), the single device's ring, and 22g's f32 cut
    b22, slots22, _, _ = LM_SHARD_CSEQ_BF16
    bf32, slots32, _, _ = LM_SHARD_CSEQ_F32
    for label, b, L, h, kvh, hd, n_valid, dt in [
            ("danube_cseq_rank_bf16", b22, slots22 // 4, 32, 8, 80,
             slots22 // 4, bf16),
            ("danube_cseq_rank_bf16_n0", b22, slots22 // 4, 32, 8, 80, 0,
             bf16),
            ("danube_decode_lse_bf16_wrapped", 8, 4096, 32, 8, 80, 4096,
             bf16),
            ("danube_cseq_rank_f32", bf32, slots32 // 4, 32, 8, 80,
             slots32 // 4, f32)]:
        q = randn(b, h, hd, dtype=dt)
        kc, vc = (randn(b, L, kvh, hd, dtype=dt) for _ in range(2))
        out["flash_decode_lse"].append(check_flash_decode_lse(
            q, kc, vc, n_valid, peaks_, label, timed=n_valid > 0))
        del q, kc, vc
    torch.cuda.empty_cache()
    return out


def sdpa_backend(fn) -> str:
    """Which of SDPA's kernels ``fn`` ran, by the names the profiler
    lists: flash, efficient (memory-efficient, CUTLASS), cudnn or math."""
    names = " ".join(r[0] for r in device_profile(fn, top=50)["top"])
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("cutlass", "efficient")):
        if key in names.lower():
            return backend
    return "math"


def check_flash_bwd(q, k, v, dout, causal, window, peaks_, label,
                    prefix=0) -> tuple:
    """K1 and the forward with the row log-sum-exp on q (B,S,H,hd), k/v
    (B,S,KV,hd) and the upstream gradient ``dout``: the forward's out bit
    for bit flash_attention_fwd's and its lse within the kernel tolerance
    of the plain version's; the gradients through the FlashAttention
    Function against torch.autograd through ref.flash_attention on the
    same card tensors (f32: the kernel tolerance; bf16: the bound of
    tests/flash_bounds.py, derived from the rounding of the
    inputs and outputs).  Timed beside the plain versions and SDPA's
    forward and backward (``enable_gqa``; the expanded heads and an
    explicit mask where the mask needs one), naming the backend SDPA ran;
    the backward's record counts the split plan's entries (``splits``, 0:
    unsplit), the route of its kernels (``kernel``) and its time over
    SDPA's (``x_sdpa``; ``x_cudnn`` where SDPA ran cuDNN's).  Returns the
    (forward with LSE, backward) records."""
    import torch
    import torch.nn.functional as F
    from flash_bounds import flash_attention_bwd_bf16_bound
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    dtype = str(q.dtype).replace("torch.", "")
    opts = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    if not torch.equal(out, cuda_fa.flash_attention(q, k, v, **opts)):
        raise AssertionError(f"flash_attention_fwd_lse {label}: out is not "
                             "flash_attention_fwd's bit for bit")
    fwd_err = check_close(f"flash_attention_fwd_lse {label} lse", lse,
                          ref.flash_attention_lse(q, k, v, **opts)[1])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cuda_fa.flash_attention(*leaves, **opts).backward(dout)
    got = [x.grad for x in leaves]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention(*plain, **opts).backward(dout)
    want = [x.grad for x in plain]
    del leaves, plain
    torch.cuda.synchronize()
    errs = []
    if dtype == "float32":
        for name, a, w in zip("qkv", got, want):
            errs.append(check_close(f"flash_attention_bwd {label} d{name}",
                                    a, w))
    else:
        bounds = flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse,
                                                got, want, **opts)
        for name, a, w, bnd in zip("qkv", got, want, bounds):
            diff = (a.float() - w.float()).abs()
            if not bool(torch.isfinite(a).all()) or bool((diff > bnd).any()):
                raise AssertionError(
                    f"flash_attention_bwd {label} d{name}: max abs err "
                    f"{float(diff.max())} past the bf16 bound at "
                    f"{float((diff / bnd).max())} of it")
            errs.append(float(diff.max()))
        del bounds
    del got, want
    again = cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    if not all(torch.equal(x, y) for x, y in zip(
            again, cuda_fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                               **opts))):
        raise AssertionError(f"flash_attention_bwd {label}: two calls "
                             "differ")
    del again
    shape = {"b": b, "s": s, "h": h, "kvh": kvh, "hd": hd, "causal": causal,
             "window": window, "prefix": prefix, "case": label}
    qt, kt, vt, mask = sdpa_inputs(q, k, v, causal, window, prefix)
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=mask is None)

    lib_out = sdpa()
    gt = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (lq, lk, lv), gt,
                                   retain_graph=True)

    recs = []
    fwd_ms = time_ms(lambda: cuda_fa.flash_attention_fwd_lse(q, k, v,
                                                             **opts))
    fwd_plain = time_ms(lambda: ref.flash_attention_lse(q, k, v, **opts))
    fwd_lib = time_ms(sdpa)
    item = q.element_size()
    pairs = attention_pairs(s, causal, window, prefix)
    nbytes = item * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * s
    fwd_rec = attention_record(
        "flash_attention_fwd_lse", shape, fwd_err, fwd_ms, fwd_plain,
        fwd_lib, nbytes, 4.0 * b * h * hd * pairs, dtype, *peaks_,
        log_it=False)
    fwd_rec.update({"kernel": cuda_fa.kernel_of(q.dtype, hd),
                    "x_sdpa": fwd_ms / fwd_lib})
    log("kernel " + json.dumps(fwd_rec))
    recs.append(fwd_rec)
    bwd_ms = time_ms(lambda: cuda_fa.flash_attention_bwd(q, k, v, out, dout,
                                                         lse, **opts))
    bwd_plain = time_ms(lambda: ref.flash_attention_bwd(q, k, v, out, dout,
                                                        lse, **opts))
    bwd_lib = time_ms(sdpa_bwd)
    backend = sdpa_backend(sdpa_bwd)
    # q, out, dout read and dq written; k, v read and dk, dv written; lse
    nbytes = item * (4 * q.numel() + 4 * k.numel()) + 4 * b * h * s
    flops = 10.0 * b * h * hd * pairs
    rec = attention_record("flash_attention_bwd", shape, max(errs), bwd_ms,
                           bwd_plain, bwd_lib, nbytes, flops, dtype,
                           *peaks_, log_it=False)
    rec.update({"errs_dq_dk_dv": errs, "tflops": flops / bwd_ms / 1e9,
                "library": f"sdpa backward ({backend})",
                "library_kernel": backend,
                "kernel": cuda_fa.bwd_kernel_of(q.dtype, hd),
                "x_sdpa": bwd_ms / bwd_lib,
                "x_cudnn": bwd_ms / bwd_lib if backend == "cudnn" else None,
                "splits": cuda_fa.bwd_splits(q, k, **opts)})
    log("kernel " + json.dumps(rec))
    recs.append(rec)
    del lib_out, lq, lk, lv, out, lse
    return tuple(recs)


# (label, b, s, h, kvh, hd, window, dtype, causal, prefix): the training
# path's shapes (phase 19: danube at full width, B = 4 a microbatch; the
# f32 cuts' attention), then phase 3's forward shapes that the training
# path does not reach: danube's S = 4128 under its 4096 window (B cut to
# 2), a window of 1024, a ragged S, the prefix at head dim 256, full
# attention, groups of 1, 12 and 16
TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ = 8, 2, 4096
CUT_TRAIN_SEQ = 1024   # the f32 dense and audio cuts' S in phase 19b
# the f32 moe cut's S in phase 19b: T*k = 4160 > 4096 pairs, so it takes
# the capacity-factor dispatch a training batch takes (phase 17's S = 256
# takes the dense-safe capacity, every expert a slot for every pair: 60x
# the expert products, 84 s of the CPU side's loss and gradients)
MOE_TRAIN_SEQ = 520
K1_CASES = [
    ("danube_train_bf16", TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 32, 8, 80,
     4096, "bfloat16", True, 0),
    ("danube_cut_train_f32", 2, CUT_TRAIN_SEQ, 32, 8, 80, 4096, "float32",
     True, 0),
    ("qwen2_moe_cut_train_f32", MOE_CUT_BATCH, MOE_TRAIN_SEQ, 16, 16, 128,
     None, "float32", True, 0),
    ("paligemma_cut_train_f32", VLM_CUT_BATCH, VLM_PATCHES + VLM_CUT_TEXT, 8,
     1, 256, None, "float32", True, VLM_PATCHES),
    ("hubert_cut_train_f32", AUDIO_CUT_BATCH, CUT_TRAIN_SEQ, 16, 16, 80,
     None, "float32", False, 0),
    ("zamba2_cut_train_f32", RECUR_CUT_BATCH, RECUR_CUT_SEQ, 32, 32, 64,
     None, "float32", True, 0),
    ("danube_f32_s4128", 2, 4128, 32, 8, 80, 4096, "float32", True, 0),
    ("danube_bf16_s4128", 2, 4128, 32, 8, 80, 4096, "bfloat16", True, 0),
    ("window1024_bf16", 2, 4096, 32, 8, 80, 1024, "bfloat16", True, 0),
    ("ragged_s1000_bf16", 2, 1000, 32, 8, 80, None, "bfloat16", True, 0),
    ("paligemma_prefill_bf16", VLM_BATCH, VLM_PATCHES + VLM_TEXT, 8, 1, 256,
     None, "bfloat16", True, VLM_PATCHES),
    ("hubert_prefill_bf16", AUDIO_BATCH, AUDIO_FRAMES, 16, 16, 80, None,
     "bfloat16", False, 0),
    ("zamba2_forward_bf16", RECUR_BATCH, RECUR_FWD_SEQ, 32, 32, 64, None,
     "bfloat16", True, 0),
    ("qwen3_moe_prefill_bf16", QWEN3_BATCH, QWEN3_PROMPT, 64, 4, 128, None,
     "bfloat16", True, 0),
    ("command_r_prefill_bf16", 2, 2048, 96, 8, 128, None, "bfloat16", True,
     0),
    # phase 22's per-rank shapes: danube's 16 query and 4 KV heads a rank
    # of (2, 2), two data rows a rank (22b bf16, 22a f32); last, so that
    # the cases above draw their inputs as before
    ("shard_danube_train_bf16", LM_SHARD_STEP[0] // 2, LM_SHARD_STEP[1],
     16, 4, 80, 4096, "bfloat16", True, 0),
    ("shard_danube_exact_f32", LM_SHARD_EXACT[0] // 2, LM_SHARD_EXACT[1],
     16, 4, 80, 4096, "float32", True, 0),
    # 22f's on (4, 1): a rank holds all 32 query and 8 KV heads of one of
    # the four data rows (22b bf16, 22a f32)
    ("shard_danube_fsdp41_bf16", LM_SHARD_STEP[0] // 4, LM_SHARD_STEP[1],
     32, 8, 80, 4096, "bfloat16", True, 0),
    ("shard_danube_fsdp41_f32", LM_SHARD_EXACT[0] // 4, LM_SHARD_EXACT[1],
     32, 8, 80, 4096, "float32", True, 0),
    # phase 24's: zamba2's shared block with 16 of its 32 heads a rank of
    # (2, 2), two data rows a rank (24a f32, 24b bf16), the driver's (24f:
    # four rows of 8 a rank), and the single device's at 24a's and 24b's
    # batches (rank 0's references)
    ("shard_zamba2_exact_f32", RECUR_SHARD_EXACT[0] // 2,
     RECUR_SHARD_EXACT[1], 16, 16, 64, None, "float32", True, 0),
    ("shard_zamba2_step_bf16", RECUR_SHARD_STEP[0] // 2, RECUR_SHARD_STEP[1],
     16, 16, 64, None, "bfloat16", True, 0),
    ("shard_zamba2_driver_bf16", RECUR_SHARD_DRIVER_BATCH[0] // 2,
     RECUR_SHARD_DRIVER_BATCH[1], 16, 16, 64, None, "bfloat16", True, 0),
    ("zamba2_shard_single_f32", RECUR_SHARD_EXACT[0], RECUR_SHARD_EXACT[1],
     32, 32, 64, None, "float32", True, 0),
    ("zamba2_shard_single_bf16", RECUR_SHARD_STEP[0], RECUR_SHARD_STEP[1],
     32, 32, 64, None, "bfloat16", True, 0)]


def check_flash_bwd_kernels(peaks_) -> dict:
    """Phase 3's K1 cases (``K1_CASES``), each with the forward with LSE:
    {entry: [records]}."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {"flash_attention_fwd_lse": [], "flash_attention_bwd": []}
    for label, b, s, h, kvh, hd, window, dt, causal, prefix in K1_CASES:
        dtype = getattr(torch, dt)
        q, dout = (torch.randn(b, s, h, hd, device=DEVICE,
                               generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, kvh, hd, device=DEVICE,
                            generator=gen).to(dtype) for _ in range(2))
        fwd, bwd = check_flash_bwd(q, k, v, dout, causal, window, peaks_,
                                   label, prefix=prefix)
        out["flash_attention_fwd_lse"].append(fwd)
        out["flash_attention_bwd"].append(bwd)
        del q, k, v, dout
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phases 4, 5 and 8: the dense path ----------------------------------------

def drive(label: str, app, inputs, stream,
          counts=(UPDATES_SINGLE, UPDATES_BATCH, UPDATES_QUEUED)) -> dict:
    """Drive one app's engine through all three update paths, replay the
    same updates through its re-evaluation engine, and hold every view
    against it.  Returns the phase's record, launch counts included."""
    import torch

    eng, ree, name = app.engine, app.reeval, app.update_input
    t0 = time.perf_counter()
    app.initialize(inputs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_single, n_batch, n_queued = counts
    total = n_single + n_batch + n_queued
    ups = [stream.next_update() for _ in range(total)]
    single = ups[:n_single]
    batch = ups[n_single:n_single + n_batch]
    queued = ups[n_single + n_batch:]

    torch.cuda.synchronize()
    reset_launches()
    fired0 = eng.stats.triggers_fired
    applies0 = eng.stats.lowrank_applies
    single_s = []
    for u, v in single:
        t0 = time.perf_counter()
        eng.apply_update(name, u, v, block=True)
        single_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    eng.apply_updates(name, batch, block=True)
    batch_s = (time.perf_counter() - t0) / len(batch)
    t0 = time.perf_counter()
    for u, v in queued:
        eng.enqueue_update(name, u, v)
    eng.flush(block=True)
    queued_s = (time.perf_counter() - t0) / len(queued)
    firings = eng.stats.triggers_fired - fired0
    applies = eng.stats.lowrank_applies - applies0
    reeval_s = []
    for u, v in ups:
        t0 = time.perf_counter()
        ree.apply_update(name, u, v, block=True)
        reeval_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    got, ranks = launches(), dense_ranks()
    check_launches(label, got, {"rank_update_batched": applies,
                                "rank_update": total,
                                "rank_update_rows": 0, "dual_matmul": 0})
    rel = check_views(label, eng.views, ree.views)
    eng.reevaluate(block=True)
    rec = {"phase": label, "views": {k: list(v.shape)
                                     for k, v in eng.views.items()},
           "initialize_s": init_s, "firings": firings,
           "lowrank_applies": applies, "launches": got,
           "dense_ranks": ranks,
           "updates": {"single": n_single, "batch": n_batch,
                       "queued": n_queued},
           "apply_update_s_first": single_s[0],
           "apply_update_s_median": statistics.median(single_s[1:]),
           "apply_updates_s_per_update": batch_s,
           "enqueue_flush_s_per_update": queued_s,
           "reeval_engine_s_first": reeval_s[0],
           "reeval_engine_s_median": statistics.median(reeval_s[1:]),
           "reevaluate_s": eng.stats.reeval_seconds,
           "rel_err_vs_reeval": rel, "tolerance": MAIN_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


class EdgeStream:
    """PageRank edge updates at distinct pages: each replaces one page's
    outlink column by a random stochastic column (``PageRank.edge_update``
    against the initialized M, exact because no page repeats)."""

    def __init__(self, app, n: int, seed: int):
        import numpy as np
        self.app, self.n = app, n
        self.rng = np.random.default_rng(seed)
        self.pages = iter(self.rng.permutation(n))

    def next_update(self):
        col = self.rng.random(self.n).astype("float32")
        col /= col.sum()
        return self.app.edge_update(int(next(self.pages)), col)


# -- phases 6 and 7: row-local carriers ---------------------------------------

def chain_program(n: int, m: int, k: int):
    """The left chain of benchmarks/bench_sparse.py: Y1 = X W1, Y2 = Y1 W2."""
    from repro_torch.core import Program, dim, matmul
    p = Program(name="chain")
    X = p.input("X", (dim("N"), dim("M")))
    W1 = p.input("W1", (dim("M"), dim("K")))
    W2 = p.input("W2", (dim("K"), dim("K")))
    Y1 = p.let("Y1", matmul(X, W1))
    p.let("Y2", matmul(Y1, W2))
    p.outputs = ["Y1", "Y2"]
    return p.bind_dims(N=n, M=m, K=k)


def timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive_carriers(label: str, eng, ree, name: str, steps, widened=None
                   ) -> dict:
    """Fire ``steps`` — (kind, carriers) applied one by one, or ("batch",
    carriers) stacked into one firing — through the carrier
    engine ``eng``, the same deltas widened to factor pairs through
    ``widened`` (if given), and one by one through ``ree``; hold every
    view against re-evaluation and the launches against the applies."""
    import torch
    from repro_torch.core import NoOpCarrier, stack_carriers
    pairs = [[c.factors() for c in cs] for _, cs in steps]
    stats0 = dict(vars(eng.stats))
    wide0 = widened.stats.lowrank_applies if widened is not None else 0
    torch.cuda.synchronize()
    reset_launches()
    times = {"carrier": {}, "widened": {}}
    for (kind, cs), ps in zip(steps, pairs):
        if kind != "batch":
            times["carrier"].setdefault(kind, []).extend(
                timed(lambda: eng.apply_update(name, c)) for c in cs)
            if widened is not None:
                times["widened"].setdefault(kind, []).extend(
                    timed(lambda: widened.apply_update(name, *p)) for p in ps)
        else:
            # a no-op in the batch is skipped and counted, never fired
            t = timed(lambda: eng.apply_updates(
                name, cs + [NoOpCarrier(*cs[0].nm)]))
            times["carrier"].setdefault(kind, []).append(t / len(cs))
            if widened is not None:
                t = timed(lambda: widened.apply_updates(name, ps))
                times["widened"].setdefault(kind, []).append(t / len(ps))
    reeval_s = []
    for ps in pairs:
        for p in ps:
            reeval_s.append(timed(lambda: ree.apply_update(name, *p)))
    got, ranks = launches(), dense_ranks()
    d = {k: v - stats0[k] for k, v in vars(eng.stats).items()
         if isinstance(v, int)}
    firings = sum(len(cs) if kind != "batch" else 1 for kind, cs in steps)
    if d["rowlocal_firings"] != firings or d["widened_carriers"] != 0:
        raise AssertionError(f"{label}: {d['rowlocal_firings']} row-local "
                             f"firings and {d['widened_carriers']} widened "
                             f"carriers in {firings} firings")
    if d["noop_skips"] != sum(kind == "batch" for kind, _ in steps):
        raise AssertionError(f"{label}: {d['noop_skips']} no-op skips")
    wide = (widened.stats.lowrank_applies - wide0) if widened else 0
    check_launches(label, got, {
        "rank_update_rows": d["row_applies"],
        "rank_update_batched": d["lowrank_applies"] + wide,
        "rank_update": len(reeval_s), "dual_matmul": 0})
    rel = check_views(label, eng.views, ree.views)
    rel_wide = check_views(label + " widened", widened.views, ree.views) \
        if widened is not None else None
    per_update = {path: {k: statistics.median(v) for k, v in ts.items()}
                  for path, ts in times.items() if ts}
    rec = {"phase": label, "firings": firings, "engine_counts": d,
           "launches": got, "dense_ranks": ranks, "rows_touched": {
               kind: [stack_carriers(cs).rows_touched] if kind == "batch"
               else [c.rows_touched for c in cs] for kind, cs in steps},
           "seconds_per_update_median": per_update,
           "reeval_engine_s_median": statistics.median(reeval_s),
           "rel_err_vs_reeval": rel, "rel_err_widened_vs_reeval": rel_wide,
           "tolerance": MAIN_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_compact() -> dict:
    """Phase 6: the left chain at n = 2^20 under row-local carriers."""
    import torch
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.data import row_local_stream, zipf_row_stream
    n, m, k, rank = CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK
    g = torch.Generator(device=DEVICE).manual_seed(0)
    # made on the card: the engines copy them
    inputs = {"X": torch.randn(n, m, device=DEVICE, generator=g),
              "W1": torch.randn(m, k, device=DEVICE, generator=g) / m ** 0.5,
              "W2": torch.randn(k, k, device=DEVICE, generator=g) / k ** 0.5}
    prog = chain_program(n, m, k)
    eng = IncrementalEngine(prog, {"X": rank})
    wide = IncrementalEngine(prog, {"X": rank})
    ree = ReevalEngine(prog)
    t0 = time.perf_counter()
    for e in (eng, wide, ree):
        e.initialize(inputs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del inputs
    s = row_local_stream(n, CHAIN_ROWS, m=m, rank=rank, seed=1)
    z = zipf_row_stream(n, m, 1.5, seed=2, rows_touched=CHAIN_ROWS)
    steps = [("single", [s.next_carrier() for _ in range(8)]),
             ("batch", [s.next_carrier() for _ in range(16)]),
             ("zipf", [z.next_carrier() for _ in range(8)])]
    rec = drive_carriers(f"rowlocal_compact_chain_n{n}_m{m}_K{k}", eng, ree,
                         "X", steps, widened=wide)
    rec["initialize_s"] = init_s
    rec["compact"] = all(fn.compact for fn in eng._rowlocal_fns.values())
    if not rec["compact"]:
        raise AssertionError("the chain's row-local trigger is not compact")
    return rec


def phase_mixed() -> dict:
    """Phase 7: the general iterative form under 100-row carriers on A."""
    import torch
    from repro_torch.apps import GeneralIterative
    from repro_torch.data import row_local_stream
    app = GeneralIterative(n=GI_N, p=GI_P, k=GI_K, model="exp", with_b=True)
    t0 = time.perf_counter()
    app.initialize(GeneralIterative.synthesize(GI_N, GI_P, seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s = row_local_stream(GI_N, GI_ROWS, m=GI_N, rank=1, seed=3)
    steps = [("single", [s.next_carrier() for _ in range(8)]),
             ("batch", [s.next_carrier() for _ in range(8)])]
    rec = drive_carriers(f"rowlocal_mixed_general_n{GI_N}_p{GI_P}_k{GI_K}",
                         app.engine, app.reeval, "A", steps)
    rec["initialize_s"] = init_s
    fns = app.engine._rowlocal_fns.values()
    rec["row_views_per_firing"] = sorted({fn.row_applies for fn in fns})
    if any(fn.compact for fn in fns) or not all(fn.row_applies and
                                                fn.dense_applies
                                                for fn in fns):
        raise AssertionError("the general form's row-local trigger is not "
                             "mixed")
    return rec


def phase_apps() -> list:
    """Phase 8: the other four paper apps at n = 10000, dense path."""
    import torch
    from repro_torch.apps import (BatchGradientDescent, GeneralIterative,
                                  PageRank, SumsOfPowers)
    from repro_torch.data import UpdateStream
    n = APP_N
    recs = []

    def run(label, make, inputs, stream_of):
        app = make()
        stream = stream_of(app)
        recs.append(drive(label, app, inputs, stream, APP_UPDATES))
        del app
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    run(f"sums_of_powers_n{n}_k16_exp",
        lambda: SumsOfPowers(n=n, k=16, model="exp"),
        SumsOfPowers.synthesize(n, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=4))
    run(f"gradient_descent_m{n}_n{n}_p1000_k16_linear",
        lambda: BatchGradientDescent(m=n, n=n, p=1000, k=16,
                                     model="linear"),
        BatchGradientDescent.synthesize(n, n, 1000, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=5))
    pr = PageRank.synthesize(n, seed=0)
    run(f"pagerank_n{n}_k16_linear", lambda: PageRank(n=n, k=16), pr,
        lambda app: EdgeStream(app, n, seed=6))
    run(f"general_iterative_n{n}_p{GI_P}_k16_exp",
        lambda: GeneralIterative(n=n, p=GI_P, k=16, model="exp"),
        GeneralIterative.synthesize(n, GI_P, seed=0),
        lambda app: UpdateStream(n=n, m=n, seed=7))
    return recs


def phase_sherman_morrison(w, calls: int = 4) -> dict:
    """Phase 9: ops.sherman_morrison_delta on OLS's W through the dual
    kernel, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(8)
    n = w.shape[0]
    uvs = [tuple(torch.tensor(rng.normal(size=n).astype(np.float32),
                              device=DEVICE) for _ in range(2))
           for _ in range(calls)]
    torch.cuda.synchronize()
    reset_launches()
    outs, seconds = [], []
    for u, v in uvs:
        t0 = time.perf_counter()
        outs.append(ops.sherman_morrison_delta(w, u, v))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    got = launches()
    check_launches("sherman_morrison", got, {
        "dual_matmul": calls, "rank_update_batched": 0, "rank_update": 0,
        "rank_update_rows": 0})
    err = 0.0
    for (u, v), (l, r) in zip(uvs, outs):
        wl, wr = ref.sherman_morrison_delta(w, u, v)
        err = max(err, check_close("sherman_morrison L", l, wl),
                  check_close("sherman_morrison R", r, wr))
    # after the counted calls: the dual kernels' device time a call (the
    # union of their intervals) and the whole call's, by the profiler
    u, v = uvs[-1]
    dual_ms = device_ms_per_call(
        lambda: ops.sherman_morrison_delta(w, u, v), "dual_", reps=10)[0]
    call_ms = device_ms_per_call(
        lambda: ops.sherman_morrison_delta(w, u, v), reps=10)[0]
    rec = {"phase": f"sherman_morrison_w{n}", "calls": calls,
           "launches": got, "seconds_per_call": sum(seconds) / calls,
           "first_call_s": seconds[0],
           "warm_median_s": statistics.median(seconds[1:]),
           "dual_device_ms_per_call": dual_ms,
           "call_device_ms": call_ms, "max_abs_err": err}
    log("main " + json.dumps(rec))
    return rec


# -- phases 10-12: LM serving -----------------------------------------------------

def serve_engine(n_layers=None, dtype=None, seed=0):
    """A ServeEngine over h2o-danube-1.8b (random weights from ``seed``)
    for 8 prompts of 4096 tokens and 32 new ones."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    cfg = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    model = LM(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    return ServeEngine(model, params, batch_size=SERVE_BATCH,
                       max_seq=SERVE_PROMPT + SERVE_NEW)


def serve(eng, prompts, new: int = SERVE_NEW):
    """Prefill and ``new`` greedy decode steps through the engine's
    entry points; returns (last logits of the prefill, the logits of each
    step, the tokens, prefill seconds, seconds of each step)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = eng.sample(last)
    steps, toks, step_s = [], [tok], []
    for _ in range(new):
        t0 = time.perf_counter()
        logits = eng.decode(tok)
        tok = eng.sample(logits)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(logits)
        toks.append(tok)
    return last, steps, torch.stack(toks, dim=1), prefill_s, step_s


def layer0_qkv(eng, tokens, pos0: int):
    """Layer 0's rope'd q, k, v (B, S, heads, hd) for ``tokens`` at
    positions pos0 .. pos0+S-1: the kernels' real inputs in this run."""
    import torch
    from repro_torch.models import attention, layers
    cfg, params = eng.model.cfg, eng.params
    bp = {name: {k: v[0] for k, v in leaf.items()}
          for name, leaf in params["blocks"].items()}
    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    x = layers.rmsnorm(bp["ln1"], layers.embed(params["embed"], tokens),
                       cfg.norm_eps)
    q, k, v = attention._project_qkv(bp["attn"], cfg, x)
    pos = torch.arange(pos0, pos0 + tokens.shape[1], device=DEVICE)
    cos, sin = layers.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
    return (layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin),
            v)


def flat_params(tree, prefix=""):
    """(dotted name, tensor) for every leaf of a param tree, in sorted-key
    order (``repro_torch.train.optimizer.leaves``')."""
    for name in sorted(tree):
        if isinstance(tree[name], dict):
            yield from flat_params(tree[name], f"{prefix}{name}.")
        else:
            yield prefix + name, tree[name]


def busy_ms(events) -> float:
    """ms in which at least one of the kernel ``events`` ran: the union of
    their intervals (a kernel launched as a programmatic dependent starts
    while the one before it drains, so summed times count that twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def device_profile(fn, top: int = 8, match=()) -> dict:
    """Kernel time on the card for one call of ``fn``, by
    ``torch.profiler``: device ms (summed kernel time), busy ms (the union
    of the kernels' intervals), kernels launched, the kernels that took the
    most time, and [summed ms, launches, busy ms] of the kernels whose
    names hold each string of ``match``.  ``device_ms`` and ``busy_ms``
    are None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    kern.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms": total if kern else None,
            "busy_ms": busy_ms(events) if kern else None,
            "kernels": sum(e.count for e in kern),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in kern[:top]],
            "match": {m: [sum(e.self_device_time_total for e in kern
                              if m in e.key) / 1e3,
                          sum(e.count for e in kern if m in e.key),
                          busy_ms([e for e in events if m in e.name])]
                      for m in match}}


def phase_serve_full(peaks_):
    """Phase 10: h2o-danube-1.8b at published width and depth, bf16.
    Returns (record, engine, prompts) for phase 12."""
    import numpy as np
    import torch
    eng = serve_engine()
    cfg = eng.model.cfg
    prompts = np.random.default_rng(10).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts)
    got = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    label = "serve_danube_full"
    check_launches(label, got, {"flash_attention": cfg.n_layers,
                                "flash_decode": cfg.n_layers * SERVE_NEW})
    if last.shape != (SERVE_BATCH, cfg.vocab) or not all(
            torch.isfinite(x).all() for x in (last, *steps)) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: non-finite logits or bad tokens")
    # the kernels against their plain versions on layer 0's real inputs:
    # the prompts' q/k/v, and the ring after the run with the next query
    q, k, v = layer0_qkv(eng, prompts, 0)
    real = [check_flash_attention(q, k, v, True, cfg.sliding_window,
                                  peaks_, "danube_layer0_prompts",
                                  timed=False)]
    del q, k, v
    q, _, _ = layer0_qkv(eng, toks[:, -1:], eng._pos)
    kv = eng.cache["kv"]
    real.append(check_flash_decode(q[:, 0].contiguous(), kv["k"][0],
                                   kv["v"][0], kv["k"].shape[2], peaks_,
                                   "danube_layer0_ring"))
    # where the time goes: one more prefill and two decode steps under the
    # profiler (kernel time; the host clock above gives the wall time)
    prof_prefill = device_profile(lambda: eng.prefill(prompts),
                                  match=(FLASH_BF16_KERNEL,))
    if prof_prefill["device_ms"] is not None and \
            prof_prefill["match"][FLASH_BF16_KERNEL][1] != cfg.n_layers:
        raise AssertionError(
            f"{label}: the profiled prefill ran {FLASH_BF16_KERNEL} "
            f"{prof_prefill['match'][FLASH_BF16_KERNEL][1]} times, not "
            f"{cfg.n_layers}")
    tok = toks[:, -1]
    prof_decode = device_profile(lambda: [eng.decode(tok) for _ in range(2)],
                                 match=("flash_decode",))
    if prof_decode["device_ms"] is not None:
        for key in ("device_ms", "busy_ms", "kernels"):
            prof_decode[key] /= 2
        prof_decode["match"] = {k: [x / 2 for x in v]
                                for k, v in prof_decode["match"].items()}
    weight_bytes = sum(t.numel() * t.element_size()
                       for name, t in flat_params(eng.params)
                       if name != "embed.table")
    kv_bytes = sum(t.numel() * t.element_size() for t in kv.values())
    decode_ms = 1e3 * statistics.median(step_s)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "params": sum(t.numel() for _, t in flat_params(eng.params)),
           "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new": SERVE_NEW,
           "launches": got, "prefill_ms": 1e3 * prefill_s,
           "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_first": 1e3 * step_s[0],
           "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
           "decode_bound_ms": (weight_bytes + kv_bytes) / peaks_[0] * 1e3,
           "decode_bound_bytes": weight_bytes + kv_bytes,
           "peak_mem_gib": peak, "real_input_checks": real,
           "profile_prefill": prof_prefill,
           "profile_decode_per_step": prof_decode}
    for name, prof, wall_ms in (("prefill", prof_prefill, 1e3 * prefill_s),
                                ("decode", prof_decode, decode_ms)):
        if prof["device_ms"] is not None:
            rec[f"{name}_device_idle_share"] = 1 - prof["busy_ms"] / wall_ms
    log("main " + json.dumps(rec))
    return rec, eng, prompts


def phase_serve_exact() -> dict:
    """Phase 11: danube's widths in f32 at EXACT_LAYERS layers; decode
    logits and greedy tokens against forward's over the whole sequence."""
    import numpy as np
    import torch
    eng = serve_engine(n_layers=EXACT_LAYERS, dtype="float32", seed=1)
    cfg = eng.model.cfg
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts)
    got = launches()
    label = "serve_danube_f32_exact"
    check_launches(label, got, {"flash_attention": cfg.n_layers,
                                "flash_decode": cfg.n_layers * SERVE_NEW})
    # forward over the prompt and every token fed to a decode step
    seq = torch.cat([torch.as_tensor(prompts, device=DEVICE).long(),
                     toks[:, :SERVE_NEW].long()], dim=1)
    full, _ = eng.model.forward(eng.params, {"tokens": seq})
    want = full[:, SERVE_PROMPT - 1:]                 # (B, 1 + NEW, V)
    del full
    rec = {"phase": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "positions": [SERVE_PROMPT - 1, SERVE_PROMPT + SERVE_NEW - 1],
           "launches": got,
           **check_decode(label, torch.stack([last, *steps], dim=1), toks,
                          want),
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * statistics.median(step_s),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def check_decode(label, got_logits, toks, want) -> dict:
    """Decode logits (B, >= n, V) against forward's ``want`` (B, n, V) at
    the same positions, within |got - want| <= SERVE_ATOL + SERVE_RTOL
    |want| on every logit; the greedy tokens (B, >= n) are forward's
    argmax, up to ties within twice that tolerance."""
    import torch
    n = want.shape[1]
    got_logits = got_logits[:, :n]
    diff = (got_logits - want).abs()
    excess = float((diff - SERVE_RTOL * want.abs()).max())
    if not torch.isfinite(got_logits).all() or excess > SERVE_ATOL:
        raise AssertionError(f"{label}: decode logits differ from forward's "
                             f"by {float(diff.max())} (atol {SERVE_ATOL} + "
                             f"rtol {SERVE_RTOL} |forward|)")
    fwd_tok = want.argmax(dim=-1)
    chosen = want.gather(-1, toks[:, :n, None].long())[..., 0]
    margin = want.max(dim=-1).values - chosen
    tied = (toks[:, :n].long() != fwd_tok)
    tol = 2 * (SERVE_ATOL + SERVE_RTOL * want.abs().max(dim=-1).values)
    if bool((tied & (margin > tol)).any()):
        raise AssertionError(f"{label}: a greedy token is not forward's "
                             "argmax")
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float(diff.max() / want.abs().max()),
            "tolerance": [SERVE_RTOL, SERVE_ATOL],
            "greedy_mismatches_within_tolerance": int(tied.sum())}


def phase_logit_view(eng, prompts):
    """Phase 12: the logit view over phase 10's 8 x 4096 final-norm hidden
    states and its lm_head, under rank-1 hot-swaps through the engine.
    Returns the record, H, and W with the hot-swaps added (phase 14e's
    view starts from them)."""
    import numpy as np
    import torch
    from repro_torch.plan import WorkloadDescriptor
    from repro_torch.serve import IncrementalLogitView
    cfg = eng.model.cfg
    H = eng.model.hidden(eng.params, {"tokens": prompts})
    H = H.reshape(-1, cfg.d_model).float()
    W = eng.params["lm_head"]["table"].float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    view = IncrementalLogitView(H, W)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.attach_logit_view("lm_head", view)
    applies0 = view.engine.stats.lowrank_applies
    rng = np.random.default_rng(12)
    deltas = [(rng.standard_normal((cfg.vocab, 1)).astype(np.float32) * .01,
               rng.standard_normal((cfg.d_model, 1)).astype(np.float32)
               * .01) for _ in range(HOT_SWAPS)]
    label = "logit_view_danube"
    half = HOT_SWAPS // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flushed = [eng.hot_swap("lm_head", u, v) for u, v in deltas[:half]]
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    # a re-plan mid-stream, timed on its own: the queued deltas survive
    # it, and the new plan keeps Y incremental, so the flush still runs
    # the dense kernel at K = HOT_SWAPS
    pending = view.pending_updates
    t0 = time.perf_counter()
    plan = view.replan(WorkloadDescriptor(batch_size=HOT_SWAPS))
    replan_s = time.perf_counter() - t0
    if view.pending_updates != pending or view.engine.plan is not plan:
        raise AssertionError(f"replan dropped the queue: {pending} -> "
                             f"{view.pending_updates} pending")
    if plan.views["Y"].strategy != "incremental":
        raise AssertionError(f"{label}: the replan maintains Y by "
                             f"{plan.views['Y'].strategy!r}")
    t0 = time.perf_counter()
    flushed += [eng.hot_swap("lm_head", u, v) for u, v in deltas[half:]]
    eng.flush_views()
    Y = eng.view_logits("lm_head")
    torch.cuda.synchronize()
    swap_s += time.perf_counter() - t0
    got, ranks = launches(), dense_ranks()
    applies = view.engine.stats.lowrank_applies - applies0
    check_launches(label, got, {"rank_update_batched": applies})
    if view.engine.stats.plan_reevals or not ranks.get(HOT_SWAPS):
        raise AssertionError(f"{label}: {view.engine.stats.plan_reevals} "
                             f"views re-evaluated, dense launches by K "
                             f"{ranks}")
    for u, v in deltas:
        W += torch.from_numpy(u).to(DEVICE) @ torch.from_numpy(v).to(DEVICE).T
    t0 = time.perf_counter()
    want = H @ W.T
    torch.cuda.synchronize()
    reeval_s = time.perf_counter() - t0
    rel = check_views(label, {"Y": Y}, {"Y": want})
    rec = {"phase": label, "H": list(H.shape), "W": list(W.shape),
           "Y": list(Y.shape), "hot_swaps": HOT_SWAPS,
           "flushed_on_enqueue": sum(flushed),
           "replan_after": half, "pending_at_replan": pending,
           "replanned": {n: vp.strategy for n, vp in plan.views.items()},
           "firings": view.engine.stats.triggers_fired,
           "lowrank_applies": applies, "launches": got,
           "dense_ranks": ranks,
           "initialize_s": init_s, "hot_swap_and_flush_s": swap_s,
           "replan_s": replan_s,
           "reeval_matmul_s": reeval_s, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec, H, W


# -- phase 13: planned maintenance ----------------------------------------------

def view_strategies(eng) -> dict:
    """Each view's strategy under ``eng``'s plan."""
    return {n: vp.strategy for n, vp in sorted(eng.plan.views.items())}


def phase_calibrate() -> dict:
    """13a: the planner's cost model calibrated on the card — the sweep's
    cost per FLOP over re-evaluation's on PageRank (n = 10000, k = 16;
    the reference's probe: rank 32, best of 9), and the op kinds' costs
    per FLOP over a matmul's at n = 512 and n = 4096."""
    import torch
    from repro_torch.apps.pagerank import PageRank, build_pagerank_program
    from repro_torch.core import IncrementalEngine
    from repro_torch.plan import (TriggerCache, calibrate_cost_scale,
                                  calibrate_op_cost_scales)
    prog = build_pagerank_program(APP_N, 16)
    inputs = PageRank.synthesize(APP_N, seed=0)
    cache, made = TriggerCache(), []

    def make():
        made.append(IncrementalEngine(prog, {"M": 1}, trigger_cache=cache))
        return made[-1]

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    scale = calibrate_cost_scale(make, inputs, "M", trigger_cache=cache)
    scale_s = time.perf_counter() - t0
    got, ranks = launches(), dense_ranks()
    check_launches("plan_calibrate", got, {"rank_update_batched": sum(
        e.stats.lowrank_applies for e in made)})
    del made
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops = {n: calibrate_op_cost_scales(n) for n in (512, 4096)}
    ops_s = time.perf_counter() - t0
    rec = {"phase": f"plan_calibrate_pagerank_n{APP_N}_k16",
           "cost_scale": scale, "probe_rank": 32, "samples": 9,
           "cost_scale_s": scale_s,
           "op_cost_scales": {f"n{n}": v for n, v in ops.items()},
           "op_cost_scales_s": ops_s, "launches": got, "dense_ranks": ranks}
    log("main " + json.dumps(rec))
    return rec


def phase_plan_pagerank(cost_scale: float) -> list:
    """13b and 13f: PageRank (n = 10000, k = 16, phase 8's edge stream)
    unplanned, planned at the calibrated cost scale (per view, and with
    the shared delta chain priced in), and planless under the cost flush
    policy, each held against re-evaluation; then a second planned engine
    on the first one's trigger cache, which must build nothing."""
    import torch
    from repro_torch.apps import PageRank
    from repro_torch.plan import TriggerCache, WorkloadDescriptor
    n = APP_N
    pr = PageRank.synthesize(n, seed=0)
    cache = TriggerCache()
    ways = {"unplanned": {},
            "planned": {"plan": WorkloadDescriptor(cost_scale=cost_scale),
                        "trigger_cache": cache},
            "planned_chain_aware": {
                "plan": WorkloadDescriptor(cost_scale=cost_scale,
                                           chain_aware=True),
                "trigger_cache": TriggerCache()},
            "cost_policy": {"flush_policy": "cost"}}
    recs, planned = [], None
    for way, kw in ways.items():
        app = PageRank(n=n, k=16, **kw)
        rec = drive(f"plan_pagerank_n{n}_k16_{way}", app, pr,
                    EdgeStream(app, n, seed=6), APP_UPDATES)
        eng = app.engine
        rec["plan_reevals"] = eng.stats.plan_reevals
        if eng.plan is not None:
            rec["strategies"] = view_strategies(eng)
        elif way == "cost_policy":
            rec["cost_flush_rank"] = eng.cost_flush_rank("M")
        log("main " + json.dumps({k: rec[k] for k in (
            "phase", "plan_reevals", "strategies", "cost_flush_rank")
            if k in rec}))
        recs.append(rec)
        if way == "planned":
            planned = app
        else:
            del app
        torch.cuda.empty_cache()

    # 13f: a second planned engine on the same cache rebuilds nothing
    misses = cache.misses
    app = PageRank(n=n, k=16, plan=planned.engine.plan, trigger_cache=cache)
    app.engine.initialize(pr)
    stream = EdgeStream(app, n, seed=16)
    ups = [stream.next_update() for _ in range(1 + APP_UPDATES[1])]
    torch.cuda.synchronize()
    reset_launches()
    app.engine.apply_update("M", *ups[0], block=True)
    app.engine.apply_updates("M", ups[1:], block=True)
    got, ranks = launches(), dense_ranks()
    label = f"plan_trigger_cache_pagerank_n{n}"
    check_launches(label, got, {
        "rank_update_batched": app.engine.stats.lowrank_applies})
    same = app.engine._trigger_fns["M"] is planned.engine._trigger_fns["M"]
    if cache.misses != misses or not same:
        raise AssertionError(f"{label}: the second engine built "
                             f"{cache.misses - misses} trigger fns "
                             f"(same base fn: {same})")
    rec = {"phase": label, "misses_before": misses,
           "misses_after": cache.misses, "hits": cache.hits,
           "same_trigger_fn": same, "launches": got, "dense_ranks": ranks}
    log("main " + json.dumps(rec))
    recs.append(rec)
    del app, planned
    torch.cuda.empty_cache()
    return recs


def stacked(ups):
    """One (n, T) x (m, T) pair from T rank-1 updates."""
    import numpy as np
    return (np.concatenate([u for u, _ in ups], axis=1),
            np.concatenate([v for _, v in ups], axis=1))


def phase_plan_ols() -> dict:
    """13c: OLS (16384 x 8192, p = 1) planned for batches of 16 read once
    in 10^4 firings: Z goes lazy, a batch of 16 skips it, and reading
    beta refreshes it exactly."""
    import torch
    from repro_torch.apps import OLS
    from repro_torch.data import UpdateStream
    from repro_torch.plan import TriggerCache, WorkloadDescriptor
    m_rows, n_cols = OLS_M, OLS_N
    inputs, _ = OLS.synthesize(m_rows, n_cols, 1, seed=0)
    app = OLS(m_rows, n_cols, 1, trigger_cache=TriggerCache(),
              plan=WorkloadDescriptor(batch_size=UPDATES_BATCH,
                                      reads_per_firing=1e-4))
    eng, label = app.engine, f"plan_ols_m{m_rows}_n{n_cols}_p1_lazy"
    if eng.plan.lazy_views() != frozenset({"Z"}):
        raise AssertionError(f"{label}: lazy views "
                             f"{sorted(eng.plan.lazy_views())}, not Z")
    app.initialize(inputs)
    del inputs
    stream = UpdateStream(n=m_rows, m=n_cols, seed=13)
    ups = [stream.next_update() for _ in range(UPDATES_BATCH)]
    torch.cuda.synchronize()
    reset_launches()
    batch_s = timed(lambda: eng.apply_updates("X", ups, block=True))
    if eng.stats.lazy_skips <= 0:
        raise AssertionError(f"{label}: {eng.stats.lazy_skips} lazy skips")
    # the read refreshes Z: check_views below holds it to re-evaluation
    read_s = timed(lambda: eng.output("beta"))
    if eng.stats.reads != 1:
        raise AssertionError(f"{label}: {eng.stats.reads} reads counted")
    app.reeval.apply_update("X", *stacked(ups), block=True)
    got, ranks = launches(), dense_ranks()
    check_launches(label, got, {
        "rank_update_batched": eng.stats.lowrank_applies, "rank_update": 1})
    rel = check_views(label, eng.views, app.reeval.views)
    rec = {"phase": label, "strategies": view_strategies(eng),
           "lazy": sorted(eng.plan.lazy_views()),
           "lazy_skips": eng.stats.lazy_skips,
           "reads": eng.stats.reads,
           "apply_updates_s_per_update": batch_s / len(ups),
           "output_refresh_s": read_s,
           "lowrank_applies": eng.stats.lowrank_applies, "launches": got,
           "dense_ranks": ranks, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del app
    torch.cuda.empty_cache()
    return rec


def phase_plan_powers() -> dict:
    """13d: matrix powers A^16 (n = 10000, exp) with every view hybrid at
    threshold rank 32 (the reference test's construction), under four
    batches of 16: every second batch re-evaluates every view."""
    from dataclasses import replace
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.data import UpdateStream
    from repro_torch.plan import (MaintenancePlan, TriggerCache,
                                  WorkloadDescriptor, plan_program)
    n, threshold, batches = POWERS_N, 32, 4
    base = plan_program(build_powers_program(k=16, n=n, model="exp"),
                        WorkloadDescriptor())
    plan = MaintenancePlan(base.fingerprint, base.workload, {
        v: replace(vp, strategy="hybrid", threshold_rank=threshold)
        for v, vp in base.views.items()})
    app = MatrixPowers(n=n, k=16, model="exp", plan=plan,
                       trigger_cache=TriggerCache())
    eng, label = app.engine, f"plan_matrix_powers_n{n}_k16_hybrid{threshold}"
    app.initialize(MatrixPowers.synthesize(n, seed=0))
    stream = UpdateStream(n=n, m=n, seed=14)
    ups = [[stream.next_update() for _ in range(UPDATES_BATCH)]
           for _ in range(batches)]
    torch.cuda.synchronize()
    reset_launches()
    reevals, seconds = [], []
    for batch in ups:
        before = eng.stats.plan_reevals
        seconds.append(timed(lambda: eng.apply_updates("A", batch,
                                                       block=True)))
        reevals.append(eng.stats.plan_reevals - before)
    views = len(plan.views)
    if reevals != [0, views] * (batches // 2) \
            or eng.stats.plan_reevals != 2 * views:
        raise AssertionError(f"{label}: re-evaluated views per batch "
                             f"{reevals}, expected every second batch to "
                             f"re-evaluate all {views}")
    app.reeval.apply_update("A", *stacked([uv for b in ups for uv in b]),
                            block=True)
    got, ranks = launches(), dense_ranks()
    check_launches(label, got, {
        "rank_update_batched": eng.stats.lowrank_applies, "rank_update": 1})
    rel = check_views(label, eng.views, app.reeval.views)
    rec = {"phase": label, "views": views, "reevals_per_batch": reevals,
           "plan_reevals": eng.stats.plan_reevals,
           "batch_s": seconds, "lowrank_applies": eng.stats.lowrank_applies,
           "launches": got, "dense_ranks": ranks, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del app
    torch.cuda.empty_cache()
    return rec


def phase_plan_compact(unplanned: dict) -> dict:
    """13e: phase 6's compact chain and carriers under a plan priced for
    rank-8 carriers on 1 % of the rows: the carriers still take the row
    kernel, as many firings as in phase 6's unplanned run."""
    import torch
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.data import row_local_stream, zipf_row_stream
    from repro_torch.plan import TriggerCache, WorkloadDescriptor
    n, m, k, rank = CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK
    g = torch.Generator(device=DEVICE).manual_seed(0)
    inputs = {"X": torch.randn(n, m, device=DEVICE, generator=g),
              "W1": torch.randn(m, k, device=DEVICE, generator=g) / m ** 0.5,
              "W2": torch.randn(k, k, device=DEVICE, generator=g) / k ** 0.5}
    prog = chain_program(n, m, k)
    eng = IncrementalEngine(prog, {"X": rank}, trigger_cache=TriggerCache(),
                            plan=WorkloadDescriptor(update_rank=rank,
                                                    affected_fraction=0.01))
    ree = ReevalEngine(prog)
    for e in (eng, ree):
        e.initialize(inputs)
    del inputs
    s = row_local_stream(n, CHAIN_ROWS, m=m, rank=rank, seed=1)
    z = zipf_row_stream(n, m, 1.5, seed=2, rows_touched=CHAIN_ROWS)
    steps = [("single", [s.next_carrier() for _ in range(8)]),
             ("batch", [s.next_carrier() for _ in range(16)]),
             ("zipf", [z.next_carrier() for _ in range(8)])]
    label = f"plan_rowlocal_compact_chain_n{n}_m{m}_K{k}"
    rec = drive_carriers(label, eng, ree, "X", steps)
    want = unplanned["engine_counts"]["rowlocal_firings"]
    if rec["engine_counts"]["rowlocal_firings"] != want:
        raise AssertionError(f"{label}: {rec['engine_counts']} row-local "
                             f"firings, the unplanned run made {want}")
    rec["strategies"] = view_strategies(eng)
    rec["row_local_views"] = sorted(v for v, vp in eng.plan.views.items()
                                    if vp.row_local)
    log("main " + json.dumps({k: rec[k] for k in (
        "phase", "strategies", "row_local_views")}))
    del eng, ree
    torch.cuda.empty_cache()
    return rec


def phase_plan(compact: dict) -> list:
    """Phase 13: planned maintenance at full width (13a-13f)."""
    import torch
    t0 = time.perf_counter()
    recs = [phase_calibrate()]
    recs += phase_plan_pagerank(recs[0]["cost_scale"])
    recs.append(phase_plan_ols())
    recs.append(phase_plan_powers())
    recs.append(phase_plan_compact(compact))
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 13: {time.perf_counter() - t0:.2f} s")
    return recs


# -- phase 14: guarded maintenance ------------------------------------------------

def clone_then_apply(eng) -> None:
    """Make ``eng`` (unguarded) fire transactionally without the
    out-of-place entry: each firing first clones the views it writes,
    applies in place, then checks its outputs with a host read and puts
    the clones back on failure.  The baseline the out-of-place design is
    measured against (phase 14a); not a path of the port."""
    from repro_torch.guard import check_finite
    inner = eng._fire_inner

    def fire(input_name, bucket, P, Q):
        written = dict.fromkeys(
            up.view for up in eng._bucket_trigger(input_name, bucket).updates)
        saved = {n: eng.views[n].clone() for n in written}
        inner(input_name, bucket, P, Q)
        if check_finite(eng.views, written) is not None:
            eng.views.update(saved)

    eng._fire_inner = fire


def drive_guarded(label: str, app, ups, single: int, batches: int,
                  batch: int, queues: int, queued: int) -> dict:
    """One matrix-powers engine through ``single`` updates (the first a
    warm-up, then the median), ``batches`` batches of ``batch`` and
    ``queues`` rounds of ``queued`` queued updates with a flush (the
    median per update of each), each ending in a synchronize; returns the
    times, the launches and the counts the launches must equal."""
    import torch
    eng = app.engine
    firings0 = eng.stats.triggers_fired
    applies0 = eng.stats.lowrank_applies
    fused = eng._guard_fast_path
    it = iter(ups)
    torch.cuda.synchronize()
    reset_launches()
    single_s = [timed(lambda: eng.apply_update("A", *next(it)))
                for _ in range(single)]
    batch_s = [timed(lambda: eng.apply_updates(
        "A", [next(it) for _ in range(batch)])) / batch
        for _ in range(batches)]

    def queue():
        for _ in range(queued):
            eng.enqueue_update("A", *next(it))
        eng.flush()
    queued_s = [timed(queue) / queued for _ in range(queues)]
    if eng.guard is not None:
        eng.guard.sync()
    got, ranks = launches(), dense_ranks()
    firings = eng.stats.triggers_fired - firings0
    applies = eng.stats.lowrank_applies - applies0
    written = len({up.view for up in eng.compiled.triggers["A"].updates})
    entry = ("rank_update_batched_out" if eng._out_of_place
             else "rank_update_batched")
    check_launches(label, got, {
        entry: applies,
        "select_commit": written * firings if fused else 0})
    rec = {"variant": label, "fused": fused, "firings": firings,
           "lowrank_applies": applies, "launches": got, "dense_ranks": ranks,
           "apply_update_s_first": single_s[0],
           "apply_update_s_median": statistics.median(single_s[1:]),
           "apply_updates_s_per_update": statistics.median(batch_s),
           "apply_updates_s_per_update_runs": batch_s,
           "enqueue_flush_s_per_update": statistics.median(queued_s),
           "enqueue_flush_s_per_update_runs": queued_s}
    if eng.guard is not None:
        rec["guard_stats"] = dataclasses.asdict(eng.guard.stats)
    return rec


def phase_guard_powers():
    """14a: matrix powers A^16 (n = 10000, exp; phase 4's cell) unguarded,
    guarded on the fused path, guarded on the snapshot path (a static
    all-incremental plan) and clone-then-apply, on one update stream:
    8 single updates after a warm-up, three batches of 16, two rounds of
    8 queued; every engine's views against one re-evaluation of the
    stream.  Returns the record and the four apps by way."""
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.data import UpdateStream
    from repro_torch.guard import GuardConfig
    from repro_torch.plan import TriggerCache, static_plan
    n, single, batches, batch, queues, queued = POWERS_N, 9, 3, \
        UPDATES_BATCH, 2, 8
    inputs = MatrixPowers.synthesize(n, seed=0)
    stream = UpdateStream(n=n, m=n, seed=21)
    ups = [stream.next_update()
           for _ in range(single + batches * batch + queues * queued)]
    ways = ("unguarded", "guarded_fused", "guarded_snapshot",
            "clone_then_apply")
    apps, recs = {}, []
    for way in ways:
        kw = {"guard": GuardConfig()} if way.startswith("guarded") else {}
        if way == "guarded_snapshot":
            kw["trigger_cache"] = TriggerCache()
        app = MatrixPowers(n=n, k=16, model="exp", **kw)
        if way == "guarded_snapshot":
            app.engine.set_plan(static_plan(app.engine, "incremental"))
        if way == "clone_then_apply":
            clone_then_apply(app.engine)
        app.engine.initialize(inputs)
        recs.append(drive_guarded(f"guard_powers_{way}", app, ups, single,
                                  batches, batch, queues, queued))
        apps[way] = app
    ree = apps["unguarded"].reeval
    ree.initialize(inputs)
    ree.apply_update("A", *stacked(ups), block=True)
    for way, rec in zip(ways, recs):
        rec["rel_err_vs_reeval"] = check_views(f"guard_powers_{way}",
                                              apps[way].engine.views,
                                              ree.views)
    base = recs[0]
    for rec in recs[1:]:
        rec["over_unguarded"] = {
            key: rec[key] / base[key] for key in (
                "apply_update_s_median", "apply_updates_s_per_update",
                "enqueue_flush_s_per_update")}
    by_k = {}
    for r in recs:
        for K, count in r["dense_ranks"].items():
            by_k[K] = by_k.get(K, 0) + count
    rec = {"phase": f"guard_matrix_powers_n{n}_k16_exp", "ways": recs,
           "tolerance": MAIN_TOL, "dense_ranks": by_k,
           "launches": {k: sum(r["launches"][k] for r in recs)
                        for k in recs[0]["launches"]}}
    log("main " + json.dumps(rec))
    return rec, apps


def chaos_seed(n: int, firings: int, poison_p: float, raise_p: float):
    """The first seed under which a fused guarded engine's ``firings``
    single updates of (n, 1) factors are both poisoned and raised at, and
    the index of the first firing that raises.  Found by the monkey's own
    draws on host arrays of the same shapes: the engine makes the same
    calls in the same order."""
    import numpy as np
    from repro_torch.guard import ChaosConfig, ChaosError
    dummy = np.zeros((n, 1), np.float32)
    for seed in range(1000):
        monkey = ChaosConfig(seed=seed, poison_p=poison_p,
                             trigger_raise_p=raise_p).monkey()
        first = None
        for i in range(firings):
            monkey.poison_update(dummy, dummy)
            try:
                monkey.maybe_raise_in_trigger()
            except ChaosError:
                first = i if first is None else first
        if monkey.poisoned and monkey.raises:
            return seed, first
    raise AssertionError("no seed poisons and raises")


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (NaN included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_guard_chaos(app) -> dict:
    """14b: matrix powers at n = 10000 on the fused path under chaos
    (poison 0.05, trigger raise 0.03), 64 firings at a seed where both
    fire; one raised firing held to a rollback onto its very pre-firing
    tensors; the views against re-evaluation of the maintained input;
    then a NaN planted in a view: the out-of-place entry's flag is set
    and the select-commit leaves the store bit-identical."""
    import torch
    from repro_torch.data import UpdateStream
    from repro_torch.guard import ChaosConfig
    from repro_torch.kernels import ops
    n, firings = POWERS_N, 64
    seed, first = chaos_seed(n, firings, 0.05, 0.03)
    eng = app.engine
    eng.chaos = ChaosConfig(seed=seed, poison_p=0.05,
                            trigger_raise_p=0.03).monkey()
    eng.guard.sync()
    g0 = dataclasses.asdict(eng.guard.stats)
    stream = UpdateStream(n=n, m=n, seed=22)
    label = f"guard_chaos_matrix_powers_n{n}"
    torch.cuda.synchronize()
    reset_launches()
    applies0 = eng.stats.lowrank_applies
    t0 = time.perf_counter()
    rollback = None
    for i in range(firings):
        uv = stream.next_update()
        if i == first:
            before = dict(eng.views)
            clones = {k: t.clone() for k, t in before.items()}
            eng.apply_update("A", *uv)
            rollback = all(eng.views[k] is t and same_bits(t, clones[k])
                           for k, t in before.items())
            del clones
        else:
            eng.apply_update("A", *uv)
    eng.guard.sync()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    g = {k: v - g0[k] for k, v in dataclasses.asdict(eng.guard.stats).items()
         if k != "max_drift"}
    ch = eng.chaos
    ok = (g["quarantined"] == ch.poisoned and g["rollbacks"] == ch.raises
          and g["admitted"] + g["quarantined"] == firings and rollback
          and all(bool(torch.isfinite(t).all()) for t in eng.views.values()))
    if not ok:
        raise AssertionError(f"{label}: guard {g}, poisoned {ch.poisoned}, "
                             f"raises {ch.raises}, rollback {rollback}")
    applies = eng.stats.lowrank_applies - applies0
    written = len({up.view for up in eng.compiled.triggers["A"].updates})
    check_launches(label, got, {
        "rank_update_batched_out": applies,
        "select_commit": written * (firings - ch.raises)})
    eng.chaos = None
    want = eng._evaluator({"A": eng.views["A"]})
    rel = check_views(label, eng.views, want)
    del want
    # a NaN in a view's kernel input: the flag, then the select puts the
    # pre-firing store back bit for bit (the NaN included)
    flag = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    top = eng.compiled.program.statements[-1].target.name
    eng.views[top][n // 3, n // 7] = float("nan")
    u, v = stream.next_update()
    uu = torch.from_numpy(u).to(DEVICE)
    out = ops.rank_update_batched_out(eng.views[top], uu[None],
                                      torch.from_numpy(v).to(DEVICE)[None],
                                      flag)
    del out
    before = {k: t.clone() for k, t in eng.views.items()}
    rollbacks = eng.guard.stats.rollbacks
    eng.apply_update("A", u, v)
    eng.guard.sync()
    kept = all(same_bits(eng.views[k], t) for k, t in before.items())
    if int(flag) != 1 or not kept or \
            eng.guard.stats.rollbacks != rollbacks + 1:
        raise AssertionError(f"{label}: NaN in {top}: flag {int(flag)}, "
                             f"store kept {kept}")
    del before
    rec = {"phase": label, "seed": seed, "firings": firings,
           "first_raise": first, "poisoned": ch.poisoned,
           "raises": ch.raises, "guard": g, "rollback_same_tensors": rollback,
           "seconds_per_firing": seconds / firings, "launches": got,
           "lowrank_applies": applies, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL, "nan_flag": int(flag),
           "nan_store_bit_identical": kept}
    log("main " + json.dumps(rec))
    return rec


def phase_guard_rows() -> dict:
    """14c: phase 6's compact chain (n = 2^20, m = 384, K = 256) under
    rank-8 carriers on 1 % of the rows, unguarded and guarded (the
    snapshot path: touched rows saved, in-place row kernel); then a
    carrier whose rows overflow, rolled back onto the same tensors with
    the touched rows restored bit for bit."""
    import torch
    from repro_torch.core import IncrementalEngine
    from repro_torch.data import row_local_stream
    from repro_torch.guard import GuardConfig
    n, m, k, rank = CHAIN_N, CHAIN_M, CHAIN_K, CHAIN_RANK
    g = torch.Generator(device=DEVICE).manual_seed(0)
    inputs = {"X": torch.randn(n, m, device=DEVICE, generator=g),
              "W1": torch.randn(m, k, device=DEVICE, generator=g) / m ** 0.5,
              "W2": torch.randn(k, k, device=DEVICE, generator=g) / k ** 0.5}
    prog = chain_program(n, m, k)
    engines = {"unguarded": IncrementalEngine(prog, {"X": rank}),
               "guarded": IncrementalEngine(prog, {"X": rank},
                                            guard=GuardConfig())}
    for e in engines.values():
        e.initialize(inputs)
    del inputs
    s = row_local_stream(n, CHAIN_ROWS, m=m, rank=rank, seed=31)
    carriers = [s.next_carrier() for _ in range(9)]
    label = f"guard_rowlocal_compact_chain_n{n}_m{m}_K{k}"
    times = {}
    torch.cuda.synchronize()
    reset_launches()
    for way, e in engines.items():
        ts = [timed(lambda: e.apply_update("X", c)) for c in carriers]
        times[way] = statistics.median(ts[1:])
    got = launches()
    applies = sum(e.stats.row_applies for e in engines.values())
    check_launches(label, got, {"rank_update_rows": applies})
    eng = engines["guarded"]
    rel = check_views(label, eng.views, engines["unguarded"].views)
    if eng.stats.rowlocal_firings != len(carriers):
        raise AssertionError(f"{label}: {eng.stats.rowlocal_firings} "
                             "row-local guarded firings")
    fn = next(iter(eng._rowlocal_fns.values()))
    r = int(carriers[0].rows_touched)
    saved_bytes = sum(4 * r * eng.views[v].shape[1] + 8 * r
                      for v in fn.row_views)
    # an overflowing carrier: the row kernel writes inf into its rows, the
    # output check reads them, and the rollback scatters them back
    bad = s.next_carrier()
    bad.block[:] = 1e38
    bad.V[:] = 10.0                     # 8 x 1e39 per touched entry: inf
    before = dict(eng.views)
    clones = {k: t.clone() for k, t in before.items()}
    rollbacks = eng.guard.stats.rollbacks
    rb_s = timed(lambda: eng.apply_update("X", bad))
    restored = all(eng.views[k] is t and same_bits(t, clones[k])
                   for k, t in before.items())
    if not restored or eng.guard.stats.rollbacks != rollbacks + 1:
        raise AssertionError(f"{label}: the overflowing carrier's rollback "
                             f"restored the rows: {restored}")
    del clones, before
    rec = {"phase": label, "carriers": len(carriers), "rows_touched": r,
           "single_s_median": times,
           "guarded_over_unguarded": times["guarded"] / times["unguarded"],
           "row_views": list(fn.row_views),
           "saved_row_bytes": saved_bytes, "rollback_s": rb_s,
           "rollback_rows_bit_identical": restored, "launches": got,
           "rel_err_vs_unguarded": rel, "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del engines, eng
    torch.cuda.empty_cache()
    return rec


def phase_guard_sentinel() -> dict:
    """14d: 14a's cell under a drift sentinel (probe every 8 firings) with
    an adaptive planner attached: the probe's time, a view perturbed past
    the tolerance, its recovery and the planner's drift count, and what
    the planner's online ``refit_from_stats`` picks."""
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.data import UpdateStream
    from repro_torch.guard import GuardConfig, SentinelConfig
    from repro_torch.plan import AdaptivePlanner, TriggerCache
    n = POWERS_N
    app = MatrixPowers(n=n, k=16, model="exp", guard=GuardConfig(
        sentinel=SentinelConfig(probe_every=8)), plan=AdaptivePlanner(),
        trigger_cache=TriggerCache())
    eng = app.engine
    app.initialize(MatrixPowers.synthesize(n, seed=0))
    stream = UpdateStream(n=n, m=n, seed=23)
    sen = eng.guard.sentinel
    label = f"guard_sentinel_matrix_powers_n{n}"
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(8):                  # the eighth firing probes
        eng.apply_update("A", *stream.next_update(), block=True)
    probes0, clean = sen.probes, dict(sen.last_drift)
    probe_s = min(timed(lambda: sen.probe(eng)) for _ in range(3))
    drifted = "P4"
    eng.views[drifted] = eng.views[drifted] + 1.0
    for _ in range(8):                  # the next probe finds and heals it
        eng.apply_update("A", *stream.next_update(), block=True)
    found = dict(sen.last_drift)
    eng.reevaluate(block=True)
    scale = eng.planner.refit_from_stats(eng.stats)
    new_plan = eng.planner.maybe_replan()
    got = launches()
    check_launches(label, got, {
        "rank_update_batched_out": eng.stats.lowrank_applies})
    ok = (sen.recoveries == 1 and eng.planner.drift_counts.get(drifted) == 1
          and found[drifted] > sen.config.tol
          and max(clean.values()) <= sen.config.tol)
    if not ok:
        raise AssertionError(f"{label}: recoveries {sen.recoveries}, drift "
                             f"counts {eng.planner.drift_counts}, drifts "
                             f"{found}")
    want = eng._evaluator({"A": eng.views["A"]})
    rel = check_views(label, eng.views, want)
    rec = {"phase": label, "probes": sen.probes, "probe_s": probe_s,
           "probes_before_perturbation": probes0, "clean_drift": clean,
           "perturbed": drifted, "drift_found": found,
           "recoveries": sen.recoveries,
           "drift_counts": eng.planner.drift_counts,
           "replans": eng.stats.replans,
           "refit_cost_scale": scale,
           "strategies_after_refit": ({v: vp.strategy for v, vp in
                                       sorted(new_plan.views.items())}
                                      if new_plan is not None else
                                      view_strategies(eng)),
           "launches": got, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del app, eng
    torch.cuda.empty_cache()
    return rec


def swap_rounds(eng, deltas, rounds: int):
    """``rounds`` rounds of len(deltas) / rounds hot-swaps and a flush
    through ``eng`` (a ServeEngine), each timed to a synchronize; returns
    the seconds of each and the most device memory a round added."""
    import torch
    per = len(deltas) // rounds
    seconds, extra = [], 0.0
    for r in range(rounds):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for u, v in deltas[r * per:(r + 1) * per]:
            eng.hot_swap("lm_head", u, v)
        eng.flush_views()
        eng.view_logits("lm_head")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        extra = max(extra, torch.cuda.max_memory_allocated() - before)
    return seconds, extra / 2 ** 30


def phase_degraded_view(eng, H, W0, phase12: dict) -> dict:
    """14e: phase 12's logit view (Y = H W^T, 32768 x 32000 f32) on the
    same ServeEngine: rounds of 8 hot-swaps and a flush unguarded (in
    place), then under a DegradePolicy (the view's engine out of place),
    with the memory a round adds; then a flush forced to fail (chaos):
    the degraded read is the pre-failure logits bit for bit and
    ``view_health`` reads the open breaker; once the breaker half-opens,
    the recovery flushes the backlog exactly."""
    import numpy as np
    import torch
    from repro_torch.guard import ChaosConfig, DegradePolicy
    from repro_torch.serve import IncrementalLogitView
    cfg = eng.model.cfg
    label = "guard_degraded_logit_view_danube"
    rounds = 3
    W = W0.clone()
    view = IncrementalLogitView(H, W)
    eng.degrade = None
    eng.attach_logit_view("lm_head", view)
    rng = np.random.default_rng(14)
    deltas = [(rng.standard_normal((cfg.vocab, 1)).astype(np.float32) * .01,
               rng.standard_normal((cfg.d_model, 1)).astype(np.float32)
               * .01) for _ in range((2 * rounds + 1) * HOT_SWAPS)]
    plain, guarded = deltas[:rounds * HOT_SWAPS], \
        deltas[rounds * HOT_SWAPS:2 * rounds * HOT_SWAPS]
    torch.cuda.synchronize()
    reset_launches()
    applies0 = view.engine.stats.lowrank_applies
    plain_s, plain_gib = swap_rounds(eng, plain, rounds)
    inplace = view.engine.stats.lowrank_applies - applies0
    eng.degrade = DegradePolicy(max_retries=1, backoff_base=0.0,
                                breaker_threshold=1, breaker_reset=0.25)
    eng.attach_logit_view("lm_head", view)      # now wrapped, out of place
    guarded_s, guarded_gib = swap_rounds(eng, guarded, rounds)
    good = eng.view_logits("lm_head")
    good_copy = good.clone()
    # the next flush fails: the view degrades to its last-good logits
    view.engine.chaos = ChaosConfig(trigger_raise_p=1.0).monkey()
    for u, v in deltas[2 * rounds * HOT_SWAPS:]:
        eng.hot_swap("lm_head", u, v)
    eng.flush_views()
    health = eng.view_health()["lm_head"]
    served = eng.view_logits("lm_head")
    degraded = (health["breaker"] == "open"
                and health["serving"] == "snapshot"
                and served is good and same_bits(served, good_copy)
                and view.pending_updates == HOT_SWAPS)
    del good_copy
    if not degraded:
        raise AssertionError(f"{label}: health {health}, pending "
                             f"{view.pending_updates}")
    view.engine.chaos = None
    time.sleep(0.3)                     # past breaker_reset: half-open
    eng.flush_views()
    recovered = eng.view_health()["lm_head"]
    Y = eng.view_logits("lm_head")
    torch.cuda.synchronize()
    got, ranks = launches(), dense_ranks()
    applies = view.engine.stats.lowrank_applies - applies0
    check_launches(label, got, {"rank_update_batched": inplace,
                                "rank_update_batched_out": applies - inplace})
    if recovered["serving"] != "fresh" or view.pending_updates:
        raise AssertionError(f"{label}: after recovery {recovered}")
    for u, v in deltas:
        W += torch.from_numpy(u).to(DEVICE) @ \
            torch.from_numpy(v).to(DEVICE).T
    rel = check_views(label, {"Y": Y}, {"Y": H @ W.T})
    rec = {"phase": label, "Y": list(Y.shape), "hot_swaps": HOT_SWAPS,
           "rounds": rounds,
           "unguarded_hot_swap_and_flush_s": plain_s,
           "guarded_hot_swap_and_flush_s": guarded_s,
           "guarded_over_unguarded": statistics.median(guarded_s)
           / statistics.median(plain_s),
           "phase12_hot_swap_and_flush_s": phase12["hot_swap_and_flush_s"],
           "unguarded_round_extra_gib": plain_gib,
           "guarded_round_extra_gib": guarded_gib,
           "health_degraded": health, "health_recovered": recovered,
           "launches": got, "dense_ranks": ranks, "lowrank_applies": applies,
           "rel_err_vs_reeval": rel, "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del view, Y, served, good
    eng._logit_views.clear()
    eng._view_guards.clear()
    torch.cuda.empty_cache()
    return rec


def phase_guard(serve) -> list:
    """Phase 14: guarded maintenance (``repro_torch.guard``) at full
    width: 14a-d on matrix powers and the compact chain, 14e on the
    logit view."""
    import torch
    t0 = time.perf_counter()
    rec, apps = phase_guard_powers()
    recs = [rec]
    recs.append(phase_guard_chaos(apps["guarded_fused"]))
    del apps, rec
    torch.cuda.empty_cache()
    recs.append(phase_guard_rows())
    recs.append(phase_guard_sentinel())
    recs.append(phase_degraded_view(*serve))
    log(f"phase 14: {time.perf_counter() - t0:.2f} s")
    return recs


# -- phase 15: the multi-tenant fleet ---------------------------------------------

def replay_groups(eng, updates: dict, groups) -> None:
    """Feed ``updates`` ({lsn: (u, v) or carrier}) to ``eng`` in
    ``groups``, the firing groups of a tenant's ``commit_log``."""
    for name, lsns in groups:
        eng.apply_updates(name, [updates[lsn] for lsn in lsns])


def fleet_bits(label: str, tenant, eng) -> None:
    """A tenant's committed store against ``eng``'s views, bit for bit."""
    bad = [k for k, t in tenant.committed_views.items()
           if not same_bits(t, eng.views[k])]
    if bad:
        raise AssertionError(f"{label}: committed views {bad} differ from "
                             "the isolated replay")


def phase_fleet_logit(eng, H, W) -> tuple:
    """15a: 8 logit-view tenants behind the server, each over its own 4096
    of phase 12's hidden states and its own seeded copy of lm_head, under
    rank-1 hot-swaps through ``ServeEngine.hot_swap`` (card tensors) and
    ``flush_views``; against the same 8 guarded engines driven one after
    another with identical groups.  Returns the record, the fleet, the
    baseline engines, the tenants' inputs and the deltas so far (15d
    goes on from them)."""
    import torch
    from repro_torch.core import IncrementalEngine
    from repro_torch.fleet import FleetConfig, FleetScheduler, TenantSpec
    from repro_torch.guard import GuardConfig
    from repro_torch.plan import TriggerCache
    from repro_torch.serve import build_logit_view_program
    cfg = eng.model.cfg
    n_t, rows, d, p = FLEET_TENANTS, FLEET_ROWS, cfg.d_model, cfg.vocab
    label = f"fleet_logit_views_danube_{n_t}x{rows}"
    prog = build_logit_view_program(rows, d, p)
    inputs = []
    for i in range(n_t):
        g = torch.Generator(device=DEVICE).manual_seed(1500 + i)
        inputs.append({"H": H[i * rows:(i + 1) * rows],
                       "W": W + 1e-3 * torch.randn(p, d, device=DEVICE,
                                                   generator=g)})
    g = torch.Generator(device=DEVICE).manual_seed(1515)

    def group():
        return [[(torch.randn(p, 1, device=DEVICE, generator=g) * .01,
                  torch.randn(d, 1, device=DEVICE, generator=g) * .01)
                 for _ in range(HOT_SWAPS)] for _ in range(n_t)]
    deltas = [group() for _ in range(1 + FLEET_ROUNDS)]
    torch.cuda.synchronize()
    reset_launches()
    # bring-up: cold per-tenant engines (own caches) against fleet
    # tenants on one shared cache, each then firing its first group
    t0 = time.perf_counter()
    base = []
    for i in range(n_t):
        e = IncrementalEngine(prog, {"W": 1}, guard=GuardConfig(),
                              trigger_cache=TriggerCache())
        e.initialize(inputs[i])
        e.apply_updates("W", deltas[0][i])
        e.guard.sync()
        base.append(e)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = FleetScheduler(FleetConfig(lease_ttl=30.0))
    paths = {f"lm_head.{i}": f"lm{i}" for i in range(n_t)}
    for i in range(n_t):
        fleet.add_tenant(TenantSpec(f"lm{i}", prog, {"W": 1},
                                    max_claim_rank=HOT_SWAPS,
                                    queue_capacity=4 * HOT_SWAPS),
                         inputs[i])
    eng.attach_fleet(fleet, paths)
    for j in range(HOT_SWAPS):
        for i in range(n_t):
            eng.hot_swap(f"lm_head.{i}", *deltas[0][i][j])
    eng.flush_views()
    torch.cuda.synchronize()
    shared_s = time.perf_counter() - t0
    cache = fleet.registry.trigger_cache.stats()
    if cache["misses"] != cache["entries"] or \
            cache["hits"] != (n_t - 1) * cache["misses"]:
        raise AssertionError(f"{label}: trigger cache {cache}: not one miss "
                             f"a key and {n_t - 1} hits")

    submit_s = []

    def fleet_round(r):
        t0 = time.perf_counter()
        for j in range(HOT_SWAPS):
            for i in range(n_t):
                if not eng.hot_swap(f"lm_head.{i}", *deltas[r][i][j]):
                    raise AssertionError(f"{label}: a hot-swap was refused")
        submit_s.append((time.perf_counter() - t0) / (n_t * HOT_SWAPS))
        eng.flush_views()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (n_t * HOT_SWAPS)

    def base_round(r):
        t0 = time.perf_counter()
        for i, e in enumerate(base):
            e.apply_updates("W", deltas[r][i])
            e.guard.sync()          # the per-tenant settle a commit implies
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (n_t * HOT_SWAPS)
    fleet_s, base_s = [], []
    for r in range(1, 1 + FLEET_ROUNDS):   # in turns, alternating the lead
        if r % 2:
            fleet_s.append(fleet_round(r))
            base_s.append(base_round(r))
        else:
            base_s.append(base_round(r))
            fleet_s.append(fleet_round(r))
    got = launches()
    tenants = [fleet.registry.get(f"lm{i}") for i in range(n_t)]
    applies = sum(t.engine.stats.lowrank_applies + e.stats.lowrank_applies
                  for t, e in zip(tenants, base))
    firings = sum(t.engine.stats.triggers_fired + e.stats.triggers_fired
                  for t, e in zip(tenants, base))
    check_launches(label, got, {"rank_update_batched_out": applies,
                                "select_commit": 2 * firings})
    rel = {}
    for i, (t, e) in enumerate(zip(tenants, base)):
        groups = [tuple(range(k * HOT_SWAPS + 1, (k + 1) * HOT_SWAPS + 1))
                  for k in range(1 + FLEET_ROUNDS)]
        if [lsns for _, lsns in t.commit_log] != groups or \
                t.stats.committed_updates != HOT_SWAPS * (1 + FLEET_ROUNDS):
            raise AssertionError(f"{label}: lm{i} commit log "
                                 f"{t.commit_log}, stats {t.stats}")
        fleet_bits(f"{label} lm{i}", t, e)
        Wi = inputs[i]["W"].clone()
        for r in range(1 + FLEET_ROUNDS):
            for u, v in deltas[r][i]:
                Wi += u @ v.T
        rel[f"lm{i}"] = check_views(
            f"{label} lm{i}", {"Y": eng.view_logits(f"lm_head.{i}")},
            {"Y": inputs[i]["H"] @ Wi.T})["Y"]
        del Wi
    rec = {"phase": label, "tenants": n_t, "H": [rows, d], "W": [p, d],
           "hot_swaps_a_round": HOT_SWAPS, "rounds": FLEET_ROUNDS,
           "fleet_s_per_update": fleet_s, "engines_s_per_update": base_s,
           "fleet_submit_s_per_update": submit_s,
           "fleet_over_engines": [f / b for f, b in zip(fleet_s, base_s)],
           "fleet_over_engines_median": statistics.median(
               f / b for f, b in zip(fleet_s, base_s)),
           "bring_up_shared_cache_s": shared_s, "bring_up_cold_s": cold_s,
           "trigger_cache": cache,
           "fleet_stats": fleet.fleet_stats(), "launches": got,
           "lowrank_applies": applies, "firings": firings,
           "rel_err_vs_reeval": rel, "tolerance": MAIN_TOL,
           "bit_identical_to_isolated_engines": True}
    log("main " + json.dumps(rec))
    return rec, fleet, base, inputs, deltas


def phase_fleet_live(eng, fleet, base, inputs, deltas) -> dict:
    """15d: 15a's tenants under four live worker threads on the real
    clock: a round of hot-swaps while they run, then ``flush_views``
    (a drain that waits on the workers); every committed store against
    its 15a engine driven deterministically through the same groups,
    bit for bit, and the launches against the applies (the counters are
    exact under threads)."""
    import torch
    n_t = FLEET_TENANTS
    label = f"fleet_live_threads_danube_{n_t}x{FLEET_ROWS}"
    tenants = [fleet.registry.get(f"lm{i}") for i in range(n_t)]
    done = [len(t.commit_log) for t in tenants]
    s0 = [(t.engine.stats.lowrank_applies, t.engine.stats.triggers_fired)
          for t in tenants]
    p, d = tenants[0].engine.views["W"].shape
    g = torch.Generator(device=DEVICE).manual_seed(1516)
    live = [[(torch.randn(p, 1, device=DEVICE, generator=g) * .01,
              torch.randn(d, 1, device=DEVICE, generator=g) * .01)
             for _ in range(2 * HOT_SWAPS)] for _ in range(n_t)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fleet.start(workers=4)
    try:
        for j in range(2 * HOT_SWAPS):
            for i in range(n_t):
                eng.hot_swap(f"lm_head.{i}", *live[i][j])
        eng.flush_views()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        fleet.stop()
    got = launches()
    applies = sum(t.engine.stats.lowrank_applies - a
                  for t, (a, _) in zip(tenants, s0))
    firings = sum(t.engine.stats.triggers_fired - f
                  for t, (_, f) in zip(tenants, s0))
    check_launches(label, got, {"rank_update_batched_out": applies,
                                "select_commit": 2 * firings})
    sizes = []
    first = 1 + HOT_SWAPS * (1 + FLEET_ROUNDS)
    for i, (t, e) in enumerate(zip(tenants, base)):
        groups = t.commit_log[done[i]:]
        sizes.extend(len(lsns) for _, lsns in groups)
        replay_groups(e, {first + j: uv for j, uv in enumerate(live[i])},
                      groups)
        if t.dirty() or t.stats.committed_updates != \
                HOT_SWAPS * (3 + FLEET_ROUNDS):
            raise AssertionError(f"{label}: lm{i} {t.health()}")
        fleet_bits(f"{label} lm{i}", t, e)
    rec = {"phase": label, "workers": 4, "updates": 2 * HOT_SWAPS * n_t,
           "seconds": seconds, "s_per_update": seconds / (2 * HOT_SWAPS * n_t),
           "claims": len(sizes), "claim_sizes": sorted(sizes),
           "fleet_stats": fleet.fleet_stats(), "launches": got,
           "lowrank_applies": applies, "firings": firings,
           "bit_identical_to_deterministic_drive": True}
    log("main " + json.dumps(rec))
    return rec


def count_applies(eng, acc) -> None:
    """Add each firing's applies to ``acc`` as it runs, before any
    rollback of the claim restores the engine's counters."""
    written = {name: len({up.view for up in trig.updates})
               for name, trig in eng.compiled.triggers.items()}
    inner = eng.apply_updates
    depth = [0]     # a widened carrier batch calls apply_updates again

    def apply_updates(name, updates, block=False):
        st = eng.stats
        s0 = (st.lowrank_applies, st.row_applies, st.triggers_fired,
              st.rowlocal_firings)
        depth[0] += 1
        try:
            out = inner(name, updates, block=block)
        finally:
            depth[0] -= 1
        if depth[0]:
            return out
        acc["dense"] += st.lowrank_applies - s0[0]
        acc["rows"] += st.row_applies - s0[1]
        if eng._guard_fast_path:
            acc["fused"] += written[name] * (
                st.triggers_fired - s0[2]
                - (st.rowlocal_firings - s0[3]))
        return out
    eng.apply_updates = apply_updates


def fleet_chaos_tenants(full: bool) -> list:
    """15b's tenants: (id, kind, program, ranks, input maker, update
    maker), at full width, or tiny on the CPU (the chaos seed search)."""
    import torch
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.apps.ols import build_ols_program
    from repro_torch.data import UpdateStream, row_local_stream
    dev = DEVICE if full else "cpu"
    n, (m, k) = (POWERS_N, (OLS_M, OLS_N)) if full else (16, (32, 8))
    # the tiny chain keeps Y1 and Y2 factored under rank-8 carriers
    cn, cm, ck = (CHAIN_N, CHAIN_M, CHAIN_K) if full else (1024, 64, 32)

    def randn(seed, *shape, scale=1.0):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, device=dev, generator=g) * scale

    def powers(seed):
        return lambda: {"A": randn(seed, n, n, scale=0.9 / n ** 0.5)}

    def ols():
        X = randn(1600, m, k)
        return {"X": X, "Y": X @ randn(1601, k, 1) + randn(1602, m, 1,
                                                           scale=0.1)}

    def chain():
        return {"X": randn(1610, cn, cm), "W1": randn(1611, cm, ck,
                                                      scale=cm ** -0.5),
                "W2": randn(1612, ck, ck, scale=ck ** -0.5)}
    out = []
    for i in range(4):
        s = UpdateStream(n=n, m=n, seed=1620 + i)
        out.append((f"powers{i}", "matrix_powers",
                    build_powers_program(k=16, n=n, model="exp"), {"A": 1},
                    powers(1590 + i), lambda s=s: ("A", s.next_update())))
    s = UpdateStream(n=m, m=k, seed=1630)
    out.append(("ols", "ols", build_ols_program(m, k, 1), {"X": 1}, ols,
                lambda s=s: ("X", s.next_update())))
    c = row_local_stream(cn, max(1, cn // 100), m=cm, rank=CHAIN_RANK,
                         seed=1640)
    out.append(("chain", "rowlocal_compact_chain", chain_program(cn, cm, ck),
                {"X": CHAIN_RANK}, chain,
                lambda c=c: ("X", (c.next_carrier(),))))
    return out


def fleet_chaos_drive(full: bool, seed: int, instrument=None,
                      tenants=None, submissions: int = FLEET_SUBMISSIONS,
                      engine_opts=None) -> tuple:
    """15b's drive: the tenants of ``tenants(full)`` (by default
    :func:`fleet_chaos_tenants`; ``engine_opts`` maps a tenant to its
    engine's keywords) behind one fleet on a virtual clock under
    ``ChaosConfig(seed)``'s worker faults and poison, ``submissions``
    submissions to tenants drawn from a seeded stream, a deterministic
    drive every 25.  ``instrument(fleet, specs)`` runs once the tenants
    are in.  Returns the fleet, the logged payloads by tenant and LSN,
    the admitted counts, the outcomes and the tenants' specs."""
    import numpy as np
    from repro_torch.fleet import (FleetConfig, FleetScheduler,
                                   OverloadPolicy, TenantSpec)
    from repro_torch.guard import ChaosConfig

    class VClock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, dt):
            self.t += dt
    vc = VClock()
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0, overload=OverloadPolicy(
            degraded_at=0.7, shedding_at=0.9, cold_after_s=1e9),
            chaos=ChaosConfig(seed=seed, worker_crash_p=0.1,
                              lease_expiry_p=0.1, slow_worker_p=0.05,
                              slow_worker_s=1.5, poison_p=0.02)),
        clock=vc, sleep=vc.sleep)
    specs = (tenants or fleet_chaos_tenants)(full)
    for tid, kind, prog, ranks, make, _ in specs:
        opts = dict((engine_opts or {}).get(tid, {}))
        if not full:
            opts["device"] = "cpu"
        fleet.add_tenant(TenantSpec(tid, prog, ranks, slo_s=0.5,
                                    queue_capacity=64, engine_opts=opts),
                         make())
    if instrument is not None:
        instrument(fleet, specs)
    rng = np.random.default_rng(seed + 1650)
    logged = {tid: {} for tid, *_ in specs}
    admitted = dict.fromkeys(logged, 0)
    outcomes = {}

    def drain():
        for k, n in fleet.run_until_idle(
                workers=3, on_stall=lambda: vc.sleep(1.1)).items():
            outcomes[k] = outcomes.get(k, 0) + n
    for step in range(submissions):
        tid, _, _, _, _, nxt = specs[int(rng.integers(len(specs)))]
        name, upd = nxt()
        if fleet.submit(tid, name, *upd) == "admitted":
            admitted[tid] += 1
            entry = fleet.registry.get(tid).log.pending(0)[-1]
            logged[tid][entry.lsn] = entry.payload()
        vc.sleep(0.01)
        if step % 25 == 24:
            drain()
    drain()
    return fleet, logged, admitted, outcomes, specs


def fleet_chaos_seed() -> int:
    """The first seed under which 15b's drive crashes a worker, expires a
    lease and poisons an update, found by the same drive on tiny CPU
    tenants: the fleet's chaos draws follow its claims and submissions,
    not the tenants' widths."""
    for seed in range(100):
        ch = fleet_chaos_drive(False, seed)[0].chaos
        if ch.worker_crashes and ch.lease_expiries and ch.poisoned:
            return seed
    raise AssertionError("no seed crashes, expires and poisons")


def claim_profile(fn, top: int = 10) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms, the card's
    kernels and copies (summed ms, count) and the host's operations by
    self time, each the ``top`` largest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                       for e in dev[:top]],
            "host": [[e.key[:50], e.self_cpu_time_total / 1e3, e.count]
                     for e in host[:top]]}


def phase_fleet_chaos(bytes_peak: float) -> dict:
    """15b: chaos acceptance at full width on the deterministic drive (4
    matrix-powers tenants, OLS, the compact row-local chain); exactly
    once, bit-identical isolated replays, exact against re-evaluation,
    replays onto the very pre-claim tensors, launches against the
    applies of every firing that ran; per-claim ms by tenant kind; then
    one more row-local claim under the profiler with the copy-on-write
    of its row views."""
    import torch
    from repro_torch.core import IncrementalEngine
    from repro_torch.guard import GuardConfig
    t0 = time.perf_counter()
    seed = fleet_chaos_seed()
    search_s = time.perf_counter() - t0
    label = "fleet_chaos_powers_ols_chain"
    claims, replays, fired = {}, [], {}

    def instrument(fleet, specs) -> None:
        kinds = {tid: kind for tid, kind, *_ in specs}
        for tid in kinds:
            fired[tid] = {"dense": 0, "rows": 0, "fused": 0}
            count_applies(fleet.registry.get(tid).engine, fired[tid])
        inner = fleet._fire_claim

        def fire_claim(tenant, lease, reeval=False):
            # a replay restores the dead claim's snapshot: it must hold the
            # very tensors the tenant last committed
            if (tenant.inflight is not None
                    and tenant.inflight.token != lease.token):
                snap = tenant.inflight.snapshot.views
                replays.append(all(snap[k] is v for k, v in
                                   tenant.committed_views.items()))
            t0 = time.perf_counter()
            res = "crashed"
            try:
                res = inner(tenant, lease, reeval=reeval)
                return res
            finally:
                torch.cuda.synchronize()
                claims.setdefault(kinds[tenant.spec.tenant_id], {}) \
                    .setdefault(res, []).append(
                        (time.perf_counter() - t0) * 1e3)
        fleet._fire_claim = fire_claim
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    fleet, logged, admitted, outcomes, specs = fleet_chaos_drive(
        True, seed, instrument)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    got = launches()
    check_launches(label, got, {
        "rank_update_batched_out": sum(a["dense"] for a in fired.values()),
        "rank_update_rows": sum(a["rows"] for a in fired.values()),
        "select_commit": sum(a["fused"] for a in fired.values())})
    ch = fleet.chaos
    stats = fleet.fleet_stats()
    if not (ch.worker_crashes and ch.lease_expiries and ch.poisoned
            and replays and all(replays) and fired["chain"]["rows"]
            and stats["replays"] + stats["fenced_aborts"] > 0):
        raise AssertionError(f"{label}: chaos {stats.get('chaos')}, crashes "
                             f"{ch.worker_crashes}, replays {replays}")
    rel = {}
    for tid, kind, prog, ranks, make, _ in specs:
        t = fleet.registry.get(tid)
        if t.dirty() or t.stats.committed_updates != admitted[tid] \
                or t.applied_lsn != admitted[tid]:
            raise AssertionError(f"{label}: {tid} admitted {admitted[tid]}"
                                 f", {t.stats}, {t.health()}")
        ref = IncrementalEngine(prog, ranks, guard=GuardConfig())
        ref._write_out_of_place()
        inputs = make()
        ref.initialize(inputs)
        del inputs
        replay_groups(ref, logged[tid], t.commit_log)
        fleet_bits(f"{label} {tid}", t, ref)
        del ref
        want = t.engine._evaluator({k: t.committed_views[k]
                                    for k in prog.inputs})
        rel[tid] = check_views(f"{label} {tid}", t.committed_views, want)
        del want
        torch.cuda.empty_cache()
    # one more row-local claim under the profiler: the copy of the row
    # views (out of place), the guard's row gathers, the row kernel
    fleet.chaos = None
    chain = fleet.registry.get("chain")
    ceng = chain.engine
    # the profiled claim fires one carrier: the base rank's trigger
    fn = ceng._rowlocal_trigger_fn("X", ceng.compiled.triggers["X"].rank)
    cow_bytes = 2 * sum(4 * ceng.views[v].numel() for v in fn.row_views)
    cow_ms = time_ms(lambda: [ceng.views[v].clone() for v in fn.row_views],
                     target_ms=20.0)
    claim_ms = {k: {r: {"n": len(v), "median": statistics.median(v),
                        "min": min(v), "max": max(v)}
                    for r, v in by.items()} for k, by in claims.items()}
    name, upd = specs[-1][5]()
    fleet.submit("chain", name, *upd)
    before = dict(ceng.views)
    prof = claim_profile(lambda: fleet.run_claim("profiled"))
    if [v for v in fn.row_views if ceng.views[v] is before[v]]:
        raise AssertionError(f"{label}: the row-local claim wrote a row view "
                             "in place")
    del before
    rec = {"phase": label, "seed": seed, "seed_search_s": search_s,
           "submissions": FLEET_SUBMISSIONS, "admitted": admitted,
           "outcomes": outcomes, "drive_s": drive_s,
           "chaos": {"worker_crashes": ch.worker_crashes,
                     "lease_expiries": ch.lease_expiries,
                     "slowdowns": ch.slowdowns, "poisoned": ch.poisoned},
           "replays": stats["replays"], "fenced_aborts":
           stats["fenced_aborts"], "replays_onto_pre_claim_tensors":
           len(replays), "leases": stats["leases"],
           "trigger_cache": stats["trigger_cache"],
           "claim_ms": claim_ms,
           "fired": fired, "launches": got,
           "cow_row_views": list(fn.row_views), "cow_bytes": cow_bytes,
           "cow_ms": cow_ms, "cow_bound_ms": cow_bytes / bytes_peak * 1e3,
           "rowlocal_claim_profile": prof,
           "rel_err_vs_reeval": rel, "tolerance": MAIN_TOL,
           "bit_identical_to_isolated_replays": True}
    log("main " + json.dumps(rec))
    del fleet, chain, ceng, fn
    torch.cuda.empty_cache()
    return rec


def phase_fleet_overload() -> dict:
    """15c: one cold, sheddable matrix-powers tenant (n = 10000) beside a
    reserved one pushed into the degraded and shedding tiers: its pending
    deltas fold into A on the card and it re-evaluates once, on read,
    within MAIN_TOL of an incremental engine fed the same updates; the
    shed decisions counted."""
    import torch
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.core import IncrementalEngine
    from repro_torch.data import UpdateStream
    from repro_torch.fleet import (FleetConfig, FleetScheduler,
                                   OverloadPolicy, TenantSpec)
    n = POWERS_N
    label = f"fleet_overload_matrix_powers_n{n}"
    clock = {"t": 0.0}
    fleet = FleetScheduler(
        FleetConfig(lease_ttl=1.0, overload=OverloadPolicy(
            degraded_at=0.5, shedding_at=0.75, cold_after_s=2.0)),
        clock=lambda: clock["t"])
    prog = build_powers_program(k=16, n=n, model="exp")
    g = torch.Generator(device=DEVICE).manual_seed(1700)
    A = torch.randn(n, n, device=DEVICE, generator=g) * (0.9 / n ** 0.5)
    cold = fleet.add_tenant(TenantSpec("cold", prog, {"A": 1},
                                       queue_capacity=4), {"A": A})
    vip = fleet.add_tenant(TenantSpec("vip", prog, {"A": 1},
                                      queue_capacity=4, sheddable=False),
                           {"A": A})
    s = UpdateStream(n=n, m=n, seed=1701)
    ups = [s.next_update() for _ in range(9)]
    torch.cuda.synchronize()
    reset_launches()
    clock["t"] += 3.0                   # both tenants go cold
    decisions = [fleet.submit("cold", "A", *uv) for uv in ups[:4]]
    tier_after_cold = fleet.tier()
    decisions += [fleet.submit("vip", "A", *uv) for uv in ups[4:6]]
    tier_after_vip = fleet.tier()
    decisions += [fleet.submit("cold", "A", *uv) for uv in ups[6:8]]
    decisions.append(fleet.submit("vip", "A", *ups[8]))
    shed = decisions.count("shed")
    if (tier_after_cold, tier_after_vip, cold.mode) != \
            ("degraded", "shedding", "reeval_on_read") or shed != 2:
        raise AssertionError(f"{label}: tiers {tier_after_cold}, "
                             f"{tier_after_vip}, mode {cold.mode}, "
                             f"decisions {decisions}")
    s0 = (vip.engine.stats.lowrank_applies, vip.engine.stats.triggers_fired)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.read("cold")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    fleet.run_until_idle(on_stall=lambda: clock.__setitem__(
        "t", clock["t"] + 1.1))
    inc = IncrementalEngine(prog, {"A": 1})
    inc.initialize({"A": A})
    del A
    inc.apply_updates("A", ups[:4])
    torch.cuda.synchronize()
    got, ranks = launches(), dense_ranks()
    vip_applies = vip.engine.stats.lowrank_applies - s0[0]
    vip_firings = vip.engine.stats.triggers_fired - s0[1]
    written = len({up.view for up in vip.engine.compiled.triggers["A"]
                   .updates})
    check_launches(label, got, {
        "rank_update_batched": inc.stats.lowrank_applies,
        "rank_update_batched_out": vip_applies,
        "select_commit": written * vip_firings})
    if cold.stats.reeval_on_read != 1 or cold.dirty() or vip.dirty() or \
            cold.engine.stats.reevals != 1:
        raise AssertionError(f"{label}: cold {cold.stats}, vip "
                             f"{vip.health()}")
    rel = check_views(label, cold.committed_views, inc.views)
    rec = {"phase": label, "decisions": decisions, "shed": shed,
           "tier_after_cold": tier_after_cold,
           "tier_after_vip": tier_after_vip,
           "reeval_on_read": cold.stats.reeval_on_read,
           "commit_log": cold.commit_log, "read_s": read_s,
           "launches": got, "dense_ranks": ranks,
           "rel_err_vs_incremental": rel, "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del fleet, cold, vip, inc
    torch.cuda.empty_cache()
    return rec


def phase_fleet(serve, bytes_peak: float) -> list:
    """Phase 15: the multi-tenant fleet (``repro_torch.fleet``) at full
    width on one card: 15a the logit-view tenants behind the server, 15b
    chaos acceptance, 15c overload, 15d 15a's tenants under live
    workers."""
    import torch
    eng, H, W = serve
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec, fleet, base, inputs, deltas = phase_fleet_logit(eng, H, W)
    recs = [rec]
    recs.append(phase_fleet_live(eng, fleet, base, inputs, deltas))
    del fleet, base, inputs, deltas, rec
    eng._fleet, eng._fleet_tenants = None, {}
    torch.cuda.empty_cache()
    recs.append(phase_fleet_chaos(bytes_peak))
    recs.append(phase_fleet_overload())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seconds = time.perf_counter() - t0
    for r in recs:
        r["phase15_peak_mem_gib"] = peak
    log(f"phase 15: {seconds:.2f} s, peak memory {peak:.2f} GiB")
    return recs


# -- phase 16: the deferred cascade and the learning views --------------------

def count_fold_applies(eng, acc: dict) -> None:
    """Add the dense applies each window fold of ``eng`` makes (its
    banked inputs and its sweep) to ``acc["fold"]``."""
    inner = eng._fold

    def fold(upto):
        a0 = eng.stats.lowrank_applies
        try:
            inner(upto)
        finally:
            acc["fold"] += eng.stats.lowrank_applies - a0
    eng._fold = fold


def ho_input(n: int, seed: int, device=None) -> dict:
    """Matrix powers' input A (spectral radius about 0.9), drawn on
    ``device`` (the script's, by default) from ``seed``."""
    import torch
    device = device or DEVICE
    g = torch.Generator(device=device).manual_seed(seed)
    return {"A": torch.randn(n, n, device=device, generator=g)
            * (0.9 / n ** 0.5)}


def plus_updates(A, ups):
    """``A + Σ u vᵀ`` over the rank-1 updates ``ups``, summed in f64 on
    the card and returned in f32: the re-evaluation engine's input."""
    import torch
    P, Q = stacked(ups)
    P = torch.from_numpy(P).to(DEVICE, torch.float64)
    Q = torch.from_numpy(Q).to(DEVICE, torch.float64)
    return (A.double() + P @ Q.T).float()


def ho_engine(n: int, order, fold_window: int = 8, **kw):
    """Matrix powers A^16 (exp) at ``order`` (an int, a {view: depth}
    dict, or None for first order) on the card."""
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.core import IncrementalEngine
    return IncrementalEngine(build_powers_program(k=16, n=n, model="exp"),
                             {"A": 1}, order=order, fold_window=fold_window,
                             **kw)


def fold_counters(eng) -> dict:
    st = eng.stats
    return {"folds": st.folds, "fold_sweeps": st.fold_sweeps,
            "fold_reevals": st.fold_reevals, "fold_aborts": st.fold_aborts,
            "recompressions": st.recompressions}


def reeval_views(eng, A) -> dict:
    """Every view of ``eng``'s program re-evaluated from the input A."""
    return {"A": A, **eng._evaluator({"A": A})}


def phase_ho_powers() -> dict:
    """16a: matrix powers A^16 (n = 10000, exp; phase 4's cell) under
    rank-8 ``apply_updates`` batches, first order and on the deferred
    cascade (order 2 at window 8, order 3 at window 4, only the output
    view at depth 2), driven in turns on one stream: HO_FIRINGS firings a
    segment, read every 8 firings in the first segment and every 64 in
    the second; after each segment every engine is flushed and held
    against the re-evaluation of the stream."""
    import torch
    from repro_torch.data import UpdateStream
    n = POWERS_N
    out_view = "P16"
    variants = {
        "first_order": {"order": None},
        "order2_w8": {"order": 2, "fold_window": 8},
        # the window's full rank (16 firings x rank 8): a cap below a
        # window's numerical rank would truncate it
        "order3_w4": {"order": 3, "fold_window": 4, "max_fold_rank": 128},
        "mixed_p16_d2": {"order": {out_view: 2}, "fold_window": 8}}
    inputs = ho_input(n, 1600)
    engines, folds, mem = {}, {}, {}
    for name, kw in variants.items():
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        eng = ho_engine(n, **kw)
        eng.initialize(inputs)
        folds[name] = {"fold": 0}
        count_fold_applies(eng, folds[name])
        engines[name] = eng
        torch.cuda.synchronize()
        mem[name] = {"views_gib": (torch.cuda.memory_allocated() - m0)
                     / 2 ** 30}
    A = inputs.pop("A")
    stream = UpdateStream(n=n, m=n, seed=1601)
    runs, by_k, total = [], {}, {}
    for cadence in HO_READS:
        batches = [[stream.next_update() for _ in range(HO_RANK)]
                   for _ in range(HO_FIRINGS)]
        for name, eng in engines.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            reset_launches()
            s0, c0 = dataclasses.replace(eng.stats), fold_counters(eng)
            f0 = folds[name]["fold"]
            read_s = []
            t0 = time.perf_counter()
            for i, ups in enumerate(batches):
                eng.apply_updates("A", ups)
                if (i + 1) % cadence == 0:
                    r0 = time.perf_counter()
                    eng.output()
                    torch.cuda.synchronize()
                    read_s.append(time.perf_counter() - r0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got, ranks, oranks = launches(), dense_ranks(), out_ranks()
            applies = eng.stats.lowrank_applies - s0.lowrank_applies
            fold_applies = folds[name]["fold"] - f0
            entry = ("rank_update_batched_out" if eng._out_of_place
                     else "rank_update_batched")
            check_launches(f"ho_powers {name} reads/{cadence}", got,
                           {entry: applies})
            if eng._deferred and name != "mixed_p16_d2" \
                    and applies != fold_applies:
                raise AssertionError(f"ho_powers {name}: a banking firing "
                                     f"launched ({applies} applies, "
                                     f"{fold_applies} in folds)")
            c1 = fold_counters(eng)
            runs.append({
                "variant": name, "reads_every": cadence,
                "firings": HO_FIRINGS, "updates": HO_FIRINGS * HO_RANK,
                "ms_per_update": seconds * 1e3 / (HO_FIRINGS * HO_RANK),
                "read_ms": [s * 1e3 for s in read_s],
                "counters": {k: c1[k] - c0[k] for k in c1},
                "lowrank_applies": applies, "fold_applies": fold_applies,
                "launches": got, "dense_ranks": ranks, "out_ranks": oranks,
                "peak_extra_gib": (torch.cuda.max_memory_allocated() - m0)
                / 2 ** 30})
            for K, count in ranks.items():
                by_k[K] = by_k.get(K, 0) + count
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        A = plus_updates(A, [uv for ups in batches for uv in ups])
        want = reeval_views(engines["first_order"], A)
        for name, eng in engines.items():
            eng.flush()
            runs.append({"variant": name, "after_reads_every": cadence,
                         "rel_err_vs_reeval": check_views(
                             f"ho_powers {name} reads/{cadence}",
                             eng.views, want)})
        del want
    base = {r["reads_every"]: r["ms_per_update"] for r in runs
            if r.get("variant") == "first_order" and "reads_every" in r}
    for r in runs:
        if "reads_every" in r:
            r["over_first_order"] = r["ms_per_update"] / \
                base[r["reads_every"]]
    for name, eng in engines.items():
        mem[name]["totals"] = fold_counters(eng)
    rec = {"phase": f"ho_matrix_powers_n{n}_k16_exp", "rank": HO_RANK,
           "runs": runs, "memory": mem, "tolerance": MAIN_TOL,
           "launches": total, "dense_ranks": by_k}
    log("main " + json.dumps(rec))
    del engines, A
    torch.cuda.empty_cache()
    return rec


def ho_guard_drive(n: int, seed: int, device: str, instrument=None):
    """16b's drive: an order-2 guarded matrix-powers engine at window 4
    under chaos trigger raises, HO_GUARD_FIRINGS single updates.
    Returns the engine and the admitted updates."""
    from repro_torch.data import UpdateStream
    from repro_torch.guard import ChaosConfig, GuardConfig
    eng = ho_engine(n, 2, fold_window=4, guard=GuardConfig(),
                    chaos=ChaosConfig(seed=seed, trigger_raise_p=0.15),
                    device=device)
    eng.initialize(ho_input(n, 1610, device))
    if instrument is not None:
        instrument(eng)
    stream = UpdateStream(n=n, m=n, seed=1602)
    admitted = []
    for _ in range(HO_GUARD_FIRINGS):
        u, v = stream.next_update()
        aborted = eng.guard.stats.aborted_firings
        eng.apply_update("A", u, v)
        if eng.guard.stats.aborted_firings == aborted:
            admitted.append((u, v))
    eng.flush()
    return eng, admitted


def ho_counters(eng) -> dict:
    g = eng.guard.stats
    return {"folds": eng.stats.folds, "fold_aborts": eng.stats.fold_aborts,
            "folded_views": eng.stats.fold_sweeps + eng.stats.fold_reevals,
            "raises": eng.chaos.raises, "rollbacks": g.rollbacks,
            "aborted_firings": g.aborted_firings, "admitted": g.admitted}


def ho_guard_seed() -> tuple:
    """The first seed under which 16b's drive raises in a fold (and in a
    firing), found by the same drive on a tiny CPU engine: the chaos
    draws follow firings and folds, not widths.  Returns the seed and the
    tiny drive's counters."""
    for seed in range(200):
        eng, _ = ho_guard_drive(16, seed, "cpu")
        c = ho_counters(eng)
        if c["fold_aborts"] and c["aborted_firings"] and \
                c["folds"] > c["fold_aborts"]:
            return seed, c
    raise AssertionError("no seed raises in a fold")


def phase_ho_guard() -> dict:
    """16b: the guarded cascade at n = 10000 under chaos at a seed where a
    fold raises: the fold rolled back (views and cascade state the very
    pre-fold objects, bit for bit), re-folded by re-evaluation exactly,
    the counters the tiny CPU drive's, the views against re-evaluation of
    the admitted updates."""
    import torch
    seed, cpu = ho_guard_seed()
    label = f"ho_guard_matrix_powers_n{POWERS_N}"
    seen = {"restores": 0, "exact": [], "fold": 0}

    def instrument(eng):
        inner_fold, inner_restore = eng._fold, eng._cascade_restore
        count_fold_applies(eng, seen)

        def fold(upto):
            seen["pre"] = (eng._cascade_snapshot(), dict(eng.views))
            aborts = eng.stats.fold_aborts
            try:
                inner_fold(upto)
            finally:
                seen.pop("pre")
            if eng.stats.fold_aborts > aborts:
                # the re-fold re-evaluated the deferred views: exactly
                # what a fresh evaluation of the current input gives
                want = eng._evaluator({"A": eng.views["A"]})
                seen["exact"].append(all(same_bits(eng.views[k], t)
                                         for k, t in want.items()))
                del want

        def restore(snap):
            inner_restore(snap)
            if "pre" not in seen:
                return        # a firing's rollback, not a fold's
            (factors, base, firings, _), views = seen["pre"]
            now = eng._cascade_snapshot()
            same = (now[2] == firings
                    and all(a is b for o in factors
                            for k in factors[o]
                            for a, b in zip(now[0][o][k], factors[o][k]))
                    and all(now[1][o][k] is base[o][k]
                            for o in base for k in base[o])
                    and all(eng.views[k] is t for k, t in views.items()))
            seen["restores"] += 1
            seen.setdefault("rolled_back_bit_for_bit", []).append(same)
        eng._fold = fold
        eng._cascade_restore = restore
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng, admitted = ho_guard_drive(POWERS_N, seed, DEVICE, instrument)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    card = ho_counters(eng)
    rolled = seen.get("rolled_back_bit_for_bit", [])
    if card != cpu or not card["fold_aborts"] or not rolled \
            or not all(rolled) or not seen["exact"] \
            or not all(seen["exact"]):
        raise AssertionError(f"{label}: card {card} vs cpu {cpu}, rolled "
                             f"back {rolled}, exact re-fold {seen['exact']}")
    A = plus_updates(ho_input(POWERS_N, 1610)["A"], admitted)
    rel = check_views(label, eng.views, reeval_views(eng, A))
    del A
    # every out-of-place apply: the committed firings' and the folds'
    # (an aborted firing or fold raised before its first apply)
    check_launches(label, got, {"rank_update_batched_out":
                                eng.stats.lowrank_applies})
    rec = {"phase": label, "seed": seed, "firings": HO_GUARD_FIRINGS,
           "counters": card, "cpu_counters": cpu,
           "fold_applies": seen["fold"],
           "rolled_back_bit_for_bit": rolled,
           "refold_exact": seen["exact"], "seconds": seconds,
           "launches": got, "rel_err_vs_reeval": rel,
           "tolerance": MAIN_TOL}
    log("main " + json.dumps(rec))
    del eng
    torch.cuda.empty_cache()
    return rec


def subspace_stream(n: int, rank: int, seed: int):
    """Rank-1 updates u vᵀ whose u and v stay in fixed rank-``rank``
    bases: any window of them has numerical rank <= ``rank``, so the
    cascade's re-compression at its rank cap is exact."""
    import numpy as np
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, rank)).astype(np.float32) / n ** 0.5
    V = rng.standard_normal((n, rank)).astype(np.float32) * 0.05

    def nxt():
        a = rng.standard_normal((rank, 1)).astype(np.float32)
        b = rng.standard_normal((rank, 1)).astype(np.float32)
        return U @ a, V @ b
    return nxt


def phase_ho_plans() -> dict:
    """16c: plans with depth at n = 10000.  A depth-2 plan for every view
    adopted at construction (window 8, rank-8 batches); an adaptive
    planner that sees batches of 16 rank-1 updates and no reads re-plans
    to depth 2 mid-stream (window 8: the window passes the rank cap of 64
    and the cap is what amortizes a fold, so the stream stays in a rank-8
    subspace, where the re-compression at the cap is exact); a plan
    mixing a lazy and a deferred view is refused.  Both engines against
    re-evaluation, their launches against their applies."""
    import torch
    from dataclasses import replace
    from repro_torch.data import UpdateStream
    from repro_torch.plan import (AdaptivePlanner, TriggerCache,
                                  WorkloadDescriptor, plan_program)
    n = POWERS_N
    inputs = ho_input(n, 1620)
    compiled = ho_engine(n, None, device="cpu").compiled
    base = plan_program(compiled, WorkloadDescriptor(update_rank=1))
    deep = replace(base, views={k: replace(vp, strategy="incremental",
                                           threshold_rank=None,
                                           materialize=True, order=2)
                                for k, vp in base.views.items()})
    names = sorted(deep.views)
    bad = replace(deep, views={**deep.views, names[0]: replace(
        deep.views[names[0]], materialize=False, order=1)})
    try:
        ho_engine(n, None, plan=bad, device="cpu")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("ho_plans: a lazy plus deferred plan was "
                             "accepted")
    stream = UpdateStream(n=n, m=n, seed=1621)
    deep_batches = [[stream.next_update() for _ in range(HO_RANK)]
                    for _ in range(16)]
    nxt = subspace_stream(n, 8, seed=1622)
    adaptive_batches = [[nxt() for _ in range(16)]
                        for _ in range(HO_ADAPTIVE_FIRINGS)]
    ways = {"deep_plan": (deep, deep_batches),
            "adaptive": (AdaptivePlanner(
                WorkloadDescriptor(update_rank=1, max_order=2,
                                   fold_window=8),
                replan_every=6, drift_tol=0.2), adaptive_batches)}
    recs, total, by_k = {}, {}, {}
    for way, (plan, batches) in ways.items():
        torch.cuda.synchronize()
        reset_launches()
        eng = ho_engine(n, None, fold_window=8, plan=plan,
                        trigger_cache=TriggerCache())
        eng.initialize(inputs)
        # the firings before an adaptive swap to depth apply in place
        swapped_at, in_place = (None, 0) if way == "adaptive" else (0, 0)
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            eng.apply_updates("A", batch)
            if swapped_at is None and eng._deferred:
                swapped_at, in_place = i + 1, eng.stats.lowrank_applies
        eng.output()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, ranks = launches(), dense_ranks()
        if swapped_at is None or eng._deferred != set(deep.views) \
                or not eng._out_of_place:
            raise AssertionError(f"ho_plans {way}: orders "
                                 f"{eng._view_orders}")
        check_launches(f"ho_plans {way}", got, {
            "rank_update_batched": in_place, "rank_update_batched_out":
            eng.stats.lowrank_applies - in_place})
        A = plus_updates(inputs["A"], [uv for b in batches for uv in b])
        recs[way] = {
            "swapped_at_firing": swapped_at, "orders": eng._view_orders,
            "replans": eng.stats.replans, "firings": len(batches),
            "seconds": seconds, "ms_per_update":
            seconds * 1e3 / sum(len(b) for b in batches),
            "counters": fold_counters(eng), "launches": got,
            "dense_ranks": ranks,
            "rel_err_vs_reeval": check_views(f"ho_plans {way}", eng.views,
                                             reeval_views(eng, A))}
        for K, count in ranks.items():
            by_k[K] = by_k.get(K, 0) + count
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        del eng, A
        torch.cuda.empty_cache()
    rec = {"phase": f"ho_plans_matrix_powers_n{n}", **recs,
           "lazy_plus_deferred_refused": refused, "tolerance": MAIN_TOL,
           "launches": total, "dense_ranks": by_k}
    log("main " + json.dumps(rec))
    return rec


def ho_fleet_tenants(full: bool) -> list:
    """16d's tenants, in :func:`fleet_chaos_tenants`' shape: three
    matrix-powers tenants, at full width or tiny on the CPU (the seed
    search); HO_FLEET_OPTS puts the first two at order 2."""
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.data import UpdateStream
    dev = DEVICE if full else "cpu"
    n = POWERS_N if full else 16
    out = []
    for i in range(3):
        s = UpdateStream(n=n, m=n, seed=1660 + i)
        out.append((f"powers{i}", "matrix_powers",
                    build_powers_program(k=16, n=n, model="exp"), {"A": 1},
                    lambda i=i: ho_input(n, 1670 + i, dev),
                    lambda s=s: ("A", s.next_update())))
    return out


def ho_fleet_drive(full: bool, seed: int, instrument=None) -> tuple:
    """16d's drive: 15b's, over :func:`ho_fleet_tenants`."""
    return fleet_chaos_drive(full, seed, instrument, tenants=ho_fleet_tenants,
                             submissions=HO_FLEET_SUBMISSIONS,
                             engine_opts=HO_FLEET_OPTS)


def ho_fleet_seed() -> tuple:
    """The first seed under which 16d's drive crashes a worker, expires a
    lease, poisons an update and folds both deferred tenants, found on
    tiny CPU tenants; returns it with the tiny drive's admitted counts
    and commit logs."""
    for seed in range(100):
        fleet, _, admitted, _, specs = ho_fleet_drive(False, seed)
        ch = fleet.chaos
        folded = all(fleet.registry.get(tid).engine.stats.folds
                     for tid in HO_FLEET_OPTS)
        if ch.worker_crashes and ch.lease_expiries and ch.poisoned \
                and folded:
            return seed, admitted, {tid: fleet.registry.get(tid).commit_log
                                    for tid, *_ in specs}
    raise AssertionError("no seed crashes, expires, poisons and folds")


def phase_ho_fleet() -> dict:
    """16d: two order-2 tenants and a first-order control under 15b's
    chaos at n = 10000: exactly once; the admitted counts and commit
    logs of the tiny CPU drive at the seed; every committed store bit for
    bit against an isolated same-order replay; after a fold barrier,
    within MAIN_TOL of a first-order replay of the same commit groups."""
    import torch
    from repro_torch.core import IncrementalEngine
    from repro_torch.guard import GuardConfig
    seed, cpu_admitted, cpu_logs = ho_fleet_seed()
    label = "ho_fleet_powers"
    fired = {}

    def instrument(fleet, specs):
        for tid in fleet.registry.ids():
            fired[tid] = {"dense": 0, "rows": 0, "fused": 0}
            count_applies(fleet.registry.get(tid).engine, fired[tid])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fleet, logged, admitted, _, specs = ho_fleet_drive(True, seed,
                                                       instrument)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    got = launches()
    check_launches(label, got, {
        "rank_update_batched_out": sum(a["dense"] for a in fired.values()),
        "select_commit": sum(a["fused"] for a in fired.values())})
    if admitted != cpu_admitted:
        raise AssertionError(f"{label}: admitted {admitted}, the CPU "
                             f"drive's at the same seed {cpu_admitted}")
    rel, counters = {}, {}
    for tid, _, prog, ranks, make, _ in specs:
        opts = HO_FLEET_OPTS.get(tid, {})
        t = fleet.registry.get(tid)
        if t.dirty() or t.stats.committed_updates != admitted[tid] \
                or t.commit_log != cpu_logs[tid] \
                or bool(opts) != bool(t.engine._deferred):
            raise AssertionError(f"{label}: {tid} admitted {admitted[tid]}"
                                 f", {t.stats}")
        inputs = make()
        ref = IncrementalEngine(prog, ranks, guard=GuardConfig(), **opts)
        ref._write_out_of_place()
        ref.initialize(inputs)
        replay_groups(ref, logged[tid], t.commit_log)
        fleet_bits(f"{label} {tid}", t, ref)
        del ref
        counters[tid] = fold_counters(t.engine)
        views = t.engine.flush()             # the fold barrier
        first = IncrementalEngine(prog, ranks, guard=GuardConfig())
        first.initialize(inputs)
        replay_groups(first, logged[tid], t.commit_log)
        rel[tid] = check_views(f"{label} {tid} vs first order", views,
                               first.views)
        del first, views, inputs
        torch.cuda.empty_cache()
    ch = fleet.chaos
    stats = fleet.fleet_stats()
    if not (ch.worker_crashes and ch.lease_expiries and ch.poisoned
            and all(counters[t]["folds"] for t in ("powers0", "powers1"))):
        raise AssertionError(f"{label}: chaos {stats.get('chaos')}, "
                             f"counters {counters}")
    rec = {"phase": label, "seed": seed, "drive_s": drive_s,
           "submissions": HO_FLEET_SUBMISSIONS, "admitted": admitted,
           "chaos": {"worker_crashes": ch.worker_crashes,
                     "lease_expiries": ch.lease_expiries,
                     "slowdowns": ch.slowdowns, "poisoned": ch.poisoned},
           "replays": stats["replays"],
           "fenced_aborts": stats["fenced_aborts"],
           "fold_counters": counters, "fired": fired, "launches": got,
           "rel_err_vs_first_order": rel, "tolerance": MAIN_TOL,
           "bit_identical_to_isolated_replays": True}
    log("main " + json.dumps(rec))
    del fleet
    torch.cuda.empty_cache()
    return rec


def phase_ho_delta() -> dict:
    """16e: the Δ² view of P2 = A·A at n = 10000: zero-initialized by
    ``materialize_delta_views``, one firing of ``delta_trigger_fn("A",
    2)`` under a rank-1 d = u vᵀ, held against 2·d·d computed apart as
    2·u (vᵀu) vᵀ; both are one rank-1 product in fp32, so they agree to
    a few ulps of the view's largest entry (DELTA2_TOL)."""
    import numpy as np
    import torch
    from repro_torch.apps.matrix_powers import build_powers_program
    from repro_torch.core import IncrementalEngine
    n = POWERS_N
    eng = IncrementalEngine(build_powers_program(k=2, n=n, model="exp"),
                            {"A": 1}, order=2)
    eng.initialize(ho_input(n, 1690))
    names = eng.materialize_delta_views("A", 2)
    fn = eng.delta_trigger_fn("A", 2)
    rng = np.random.default_rng(1691)
    u = (rng.standard_normal((n, 1)) * 0.01).astype(np.float32)
    v = (rng.standard_normal((n, 1)) * 0.01).astype(np.float32)
    before = dict(eng.views)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn(dict(eng.views), u, v)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = launches()
    check_launches("ho_delta2", got, {"rank_update_batched_out":
                                      fn.lowrank_applies})
    uu = torch.from_numpy(u).to(DEVICE)
    vv = torch.from_numpy(v).to(DEVICE)
    want = 2.0 * (uu * float(vv.T @ uu)) @ vv.T
    d2 = out[names[0]]
    scale = float(want.abs().max())
    rel = float((d2 - want).abs().max()) / scale
    untouched = all(eng.views[k] is t for k, t in before.items()) and \
        not bool(eng.views[names[0]].any())
    if names != ("__d2__P2",) or rel > DELTA2_TOL or not untouched:
        raise AssertionError(f"ho_delta2: {names}, rel err {rel}, store "
                             f"untouched {untouched}")
    rec = {"phase": f"ho_delta2_P2_n{n}", "views": list(names), "ms": ms,
           "rel_err_vs_2dd": rel, "tolerance": DELTA2_TOL,
           "max_abs": scale, "launches": got}
    log("main " + json.dumps(rec))
    del eng, out, want, d2, before
    torch.cuda.empty_cache()
    return rec


def fivm_oracle_live(boot_X, boot_Y, stream):
    """The live rows (slot order) of a bootstrapped ring after a labeled
    stream, built on the host from the events: the bootstrap rows 0..b-1,
    then the stream's live slots (all above them)."""
    import numpy as np
    slots = stream.live_slots
    X = np.concatenate([boot_X] + [stream._live[s][0][None]
                                   for s in slots])
    Y = np.concatenate([boot_Y] + [stream._live[s][1][None]
                                   for s in slots])
    return X, Y


def drive_ring(ring, solver, events, read_every: int) -> dict:
    """Apply ``events`` one by one, reading (fold plus ``solver``'s ridge
    re-solve) every ``read_every``; returns ingest µs an event and read
    ms."""
    import torch
    ingest, reads = 0.0, []
    for i in range(0, len(events), read_every):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.apply_events(events[i:i + read_every])
        torch.cuda.synchronize()
        ingest += time.perf_counter() - t0
        t0 = time.perf_counter()
        solver.coefficients()
        reads.append((time.perf_counter() - t0) * 1e3)
    return {"ingest_us_per_event": ingest * 1e6 / len(events),
            "read_ms": reads, "read_ms_median": statistics.median(reads)}


def phase_fivm() -> dict:
    """16f: a ring RingSpec(256, 1, 2^20, 2 slots, proj 64) bootstrapped
    with FIVM_BOOT seeded rows, then FIVM_EVENTS labeled events (churn
    0.3) at order 1 and at order 2 in turns: ingest µs an event, read ms
    (fold plus ridge re-solve); ridge against batch_ridge on the live
    rows in float64; insert-then-delete restoring the ring; k-means
    centroids against batch_kmeans on the live rows built on the host; the
    row kernel's launches at order 1; a fleet-hosted ring tenant under
    live workers, its staleness against its SLO; then ``python -m
    repro_torch.launch.serve --fivm`` at this size."""
    import numpy as np
    import torch
    from repro_torch.data import LabeledUpdate, labeled_stream
    from repro_torch.fivm import (KMeansSolver, RidgeSolver, Ring, RingSpec,
                                  batch_kmeans, batch_ridge)
    from repro_torch.fivm.registry import RingRegistry, submit_event
    from repro_torch.fleet import FleetConfig, FleetScheduler
    from repro_torch.plan import TriggerCache
    spec = RingSpec(features=FIVM_FEATURES, targets=1,
                    capacity=FIVM_CAPACITY, model_slots=2,
                    proj_dim=FIVM_PROJ)
    rng = np.random.default_rng(1700)
    boot_X = rng.standard_normal((FIVM_BOOT, spec.features)
                                 ).astype(np.float32)
    w = rng.standard_normal((spec.features, 1)).astype(np.float32)
    boot_Y = (boot_X @ w + 0.01 * rng.standard_normal(
        (FIVM_BOOT, 1))).astype(np.float32)
    recs, total, by_k = {}, {}, {}
    for order in (1, 2):
        label = f"fivm_order{order}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ring = Ring(spec, order=None if order == 1 else 2,
                    trigger_cache=TriggerCache())
        ring.bootstrap(boot_X, boot_Y)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        solver = RidgeSolver(ring, lam=FIVM_LAM)
        solver.coefficients()                     # the first solve
        stream = labeled_stream(spec.features, capacity=spec.capacity,
                                churn=0.3, seed=1701)
        events = stream.events(FIVM_EVENTS)
        s0 = dataclasses.replace(ring.stats)
        reset_launches()
        timing = drive_ring(ring, solver, events, FIVM_READ_EVERY)
        torch.cuda.synchronize()
        got, ranks, oranks = launches(), dense_ranks(), out_ranks()
        st = ring.stats
        applies = st.lowrank_applies - s0.lowrank_applies
        rows = st.row_applies - s0.row_applies
        entry = ("rank_update_batched_out" if ring.engine._out_of_place
                 else "rank_update_batched")
        check_launches(label, got, {entry: applies,
                                    "rank_update_rows": rows})
        if (order == 1) != (rows > 0) or \
                (order == 2 and (st.rowlocal_firings or not st.folds)):
            raise AssertionError(f"{label}: row applies {rows}, folds "
                                 f"{st.folds}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        for K, count in ranks.items():
            by_k[K] = by_k.get(K, 0) + count
        B = solver.coefficients()
        Xl, Yl = ring.live_data()
        Xo, Yo = fivm_oracle_live(boot_X, boot_Y, stream)
        # the live rows: exact at order 1 (each row written once a window);
        # a window that deletes and re-inserts one slot sums its one-hot
        # columns in the kernel's order, within an ulp of |x|
        live_err = float(max(np.abs(Xl - Xo).max(), np.abs(Yl - Yo).max())) \
            if Xl.shape == Xo.shape and Yl.shape == Yo.shape else np.inf
        # XP, which the row kernel writes at order 1, against X·R
        views = ring.engine.views
        xp_want = views["X"].double() @ views["R"].double()
        xp_err = float((views["XP"].double() - xp_want).abs().max()
                       / max(float(xp_want.abs().max()), 1.0))
        del views, xp_want
        B_batch = batch_ridge(Xo, Yo, FIVM_LAM)
        ridge_err = float(np.abs(B - B_batch).max()
                          / max(float(np.abs(B_batch).max()), 1.0))
        before = ring.read("G", "XY", "s", "c", "YY", "XP")
        x = rng.standard_normal(spec.features).astype(np.float32)
        y = rng.standard_normal(1).astype(np.float32)
        slot = FIVM_BOOT      # never used by the stream (it fills from
        #                      the top of the capacity down)
        ring.apply(LabeledUpdate("insert", slot, x, y))
        moved = float(np.abs(ring.gram() - before["G"]).max())
        ring.apply(LabeledUpdate("delete", slot, x, y))
        after = ring.read("G", "XY", "s", "c", "YY", "XP")
        restore = {k: float(np.abs(after[k] - before[k]).max()
                            / max(float(np.abs(before[k]).max()), 1.0))
                   for k in before}
        t0 = time.perf_counter()
        km = KMeansSolver(ring, FIVM_CLUSTERS, seed=1)
        C = km.fit()
        C_batch, _ = batch_kmeans(Xo, FIVM_CLUSTERS, seed=1)
        km_s = time.perf_counter() - t0
        km_err = float(np.abs(C - C_batch).max())
        ok = (live_err <= 1e-5 and ridge_err <= FIVM_TOL and moved > 1e-3
              and xp_err <= FIVM_XP_TOL
              and max(restore.values()) <= FIVM_RESTORE_TOL
              and km_err <= 1e-5)
        recs[label] = {
            "bootstrap_s": boot_s, **timing, "events": FIVM_EVENTS,
            "read_every": FIVM_READ_EVERY, "live": int(Xl.shape[0]),
            "folds": st.folds, "fold_reevals": st.fold_reevals,
            "rowlocal_firings": st.rowlocal_firings,
            "row_applies": rows, "lowrank_applies": applies,
            "launches": got, "dense_ranks": ranks, "out_ranks": oranks,
            "live_rows_max_abs_err": live_err,
            "XP_rel_err_vs_X_R_f64": xp_err,
            "ridge_rel_err_vs_batch_f64": ridge_err,
            "ridge_strategies": solver.stats.strategy_log[-4:],
            "insert_moved_G": moved, "insert_delete_rel_resid": restore,
            "kmeans_err": km_err, "kmeans_inertia": km.inertia,
            "kmeans_s": km_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if not ok:
            raise AssertionError(f"{label}: {recs[label]}")
        del ring, solver, km, Xl, Yl
        torch.cuda.empty_cache()
    # the fleet face: a guarded ring tenant under live workers, the same
    # carriers as Ring.apply, its staleness sampled at every submission
    fleet = FleetScheduler(FleetConfig(lease_ttl=5.0, workers=2))
    reg = RingRegistry(TriggerCache())
    reg.add_fleet_tenant(fleet, spec, "fivm-ring", slo_s=FIVM_SLO,
                         queue_capacity=4 * FIVM_FLEET_EVENTS)
    tenant = fleet.registry.get("fivm-ring")
    stream = labeled_stream(spec.features, capacity=spec.capacity,
                            churn=0.3, seed=1702)
    events = stream.events(FIVM_FLEET_EVENTS)
    fired = {"dense": 0, "rows": 0, "fused": 0}
    count_applies(tenant.engine, fired)
    stale = []
    torch.cuda.synchronize()
    reset_launches()
    fleet.start()
    try:
        t0 = time.perf_counter()
        decisions = []
        for ev in events:
            decisions.extend(submit_event(fleet, "fivm-ring",
                                          spec.capacity, ev))
            stale.append(tenant.staleness())
        fleet.drain(["fivm-ring"], timeout_s=600.0)
        fleet_s = time.perf_counter() - t0
    finally:
        fleet.stop()
    torch.cuda.synchronize()
    got = launches()
    check_launches("fivm_fleet", got, {
        "rank_update_batched_out": fired["dense"],
        "rank_update_rows": fired["rows"], "select_commit": fired["fused"]})
    G = fleet.read_views("fivm-ring")["G"].cpu().numpy()
    Xo = np.stack([stream._live[s][0] for s in stream.live_slots]) \
        if stream.live_slots else np.zeros((0, spec.features), np.float32)
    G_err = float(np.abs(G - Xo.T.astype(np.float64) @ Xo).max()
                  / max(float(np.abs(G).max()), 1.0))
    health = fleet.tenant_health()[0]
    if set(decisions) != {"admitted"} or tenant.dirty() or \
            tenant.stats.committed_updates != 3 * FIVM_FLEET_EVENTS or \
            G_err > FIVM_TOL:
        raise AssertionError(f"fivm_fleet: {health}, G err {G_err}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    recs["fleet_ring_tenant"] = {
        "events": FIVM_FLEET_EVENTS, "seconds": fleet_s,
        "firings_per_s": 3 * FIVM_FLEET_EVENTS / fleet_s,
        "staleness_max_s": max(stale),
        "staleness_p50_s": statistics.median(stale), "slo_s": FIVM_SLO,
        "within_slo": max(stale) <= FIVM_SLO, "fired": fired,
        "G_rel_err_vs_f64": G_err, "health": health, "launches": got}
    del fleet, reg, tenant
    torch.cuda.empty_cache()
    # the serving CLI at this size, in a process of its own
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fivm",
         "--fivm-features", str(FIVM_FEATURES),
         "--fivm-capacity", str(FIVM_CAPACITY)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    if cli.returncode != 0:
        raise AssertionError(f"serve --fivm exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    recs["serve_cli"] = {"seconds": time.perf_counter() - t0,
                         "stdout": cli.stdout.strip().splitlines()[-2:]}
    rec = {"phase": f"fivm_f{FIVM_FEATURES}_c{FIVM_CAPACITY}", **recs,
           "ridge_tolerance": FIVM_TOL,
           "restore_tolerance": FIVM_RESTORE_TOL,
           "xp_tolerance": FIVM_XP_TOL, "launches": total,
           "dense_ranks": by_k}
    log("main " + json.dumps(rec))
    return rec


def phase_ho() -> list:
    """Phase 16: the higher-order deferred cascade and the learning views
    (``repro_torch.fivm``) at full width on one card."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs, peak = [], 0.0
    for part, fn in (("16a", phase_ho_powers), ("16b", phase_ho_guard),
                     ("16c", phase_ho_plans), ("16d", phase_ho_fleet),
                     ("16e", phase_ho_delta),
                     ("16f", phase_fivm)):
        t1 = time.perf_counter()
        recs.append(fn())
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        log(f"phase {part}: {time.perf_counter() - t1:.2f} s")
    seconds = time.perf_counter() - t0
    for r in recs:
        r["phase16_peak_mem_gib"] = peak
    log(f"phase 16: {seconds:.2f} s, peak memory {peak:.2f} GiB")
    return recs


# -- phase 17: the transformer families at full width ---------------------------

def family_lm(arch: str, n_layers=None, dtype=None, seed: int = 0):
    """(LM on the card, random params from ``seed``) for ``arch`` at its
    published widths, cut to ``n_layers`` and cast to ``dtype`` when
    given."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    model = LM(cfg)
    return model, model.init(torch.Generator(device=DEVICE).manual_seed(seed))


def family_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """The port's synthetic batch of ``seq`` positions (a vlm's patches
    included), numpy."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import synth_batch
    return synth_batch(cfg, ShapeConfig("chip", seq, batch, "prefill"),
                       seed=seed)


def param_bytes(params, skip=()) -> int:
    return sum(t.numel() * t.element_size()
               for name, t in flat_params(params) if name not in skip)


def decode_read_bytes(model, params, prompt: int, steps: int,
                      batch: int) -> int:
    """Bytes the median of ``steps`` decode steps after a ``prompt``-long
    prefill must read at least: every block's weights (all experts: the
    dispatch multiplies each at its capacity), the final norm, the head's
    table, and the KV caches' valid slots (step i attends prompt + i + 1),
    each once."""
    cfg = model.cfg
    skip = {"frontend.w", "frontend.b"}
    if not cfg.tie_embeddings:
        skip.add("embed.table")      # one row a token
    n_valid = statistics.median(range(prompt + 1, prompt + steps + 1))
    kv = 2 * cfg.n_layers * batch * n_valid * cfg.n_kv_heads \
        * cfg.resolved_head_dim * model.dtype.itemsize
    return int(param_bytes(params, skip) + kv)


@contextlib.contextmanager
def annotated(parts):
    """Each (owner, attribute, label) of ``parts`` called inside a
    profiler range named ``label`` while the block runs."""
    import torch
    saved = []
    for owner, attr, label in parts:
        fn = getattr(owner, attr)

        def wrapped(*args, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def moe_split(fn, attention_fn: str) -> dict:
    """One call of ``fn`` (a MoE prefill or decode step) under the
    profiler, its kernel time split by the port's functions: attention
    (``attention_fn`` of every layer: projections, rope and the flash
    kernel), router and dispatch, the expert products, combine, the
    shared expert, the head, and the rest (embedding, norms,
    residuals)."""
    from repro_torch.models import attention, moe
    from repro_torch.models.model import LM
    return range_split(fn, [(attention, attention_fn, "attention"),
                            (moe, "_route", "router_dispatch"),
                            (moe, "_dispatch", "router_dispatch"),
                            (moe, "_experts", "expert_products"),
                            (moe, "_combine", "combine"),
                            (moe, "_shared_expert", "shared_expert"),
                            (LM, "logits", "head")])


def range_split(fn, parts) -> dict:
    """One call of ``fn`` under the profiler, its kernel time split by
    the ``parts`` (owner, attribute, label) it calls, which must not nest,
    and the rest ("other"); with the device's busy time (the union of the
    kernels' intervals) and the kernels launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with annotated(parts), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = list(prof.events())
    labels = {label for _, _, label in parts}
    # the device's kernels, not the ranges record_function marks there
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in labels
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {"device_ms": None, "wall_ms_profiled": wall_ms}
    split = {}
    for _, _, label in parts:
        split[label] = sum(e.device_time_total for e in events
                           if e.device_type == DeviceType.CPU
                           and e.name == label) / 1e3
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    split["other"] = device_ms - sum(split.values())
    return {"device_ms": device_ms, "busy_ms": busy_ms(kernels),
            "kernels": len(kernels), "split_ms": split,
            "wall_ms_profiled": wall_ms}


def launch_record(label: str, model, steps: int) -> dict:
    """The launches since the last reset, checked: one flash_attention a
    layer for the prefill or forward, one flash_decode a layer a step,
    nothing else."""
    got = launches()
    n = model.cfg.n_layers
    check_launches(label, got, {"flash_attention": n,
                                "flash_decode": n * steps})
    return got


def check_finite(label: str, *tensors) -> None:
    import torch
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{label}: non-finite logits")


def phase_moe_serve(peaks_) -> dict:
    """17a: qwen2-moe-a2.7b at full width and depth in bf16 behind the
    ServeEngine: MOE_BATCH prompts of MOE_PROMPT tokens, MOE_NEW greedy
    steps, then one step split by the profiler."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    label = "moe_qwen2_full"
    model, params = family_lm(MOE_ARCH)
    cfg = model.cfg
    eng = ServeEngine(model, params, batch_size=MOE_BATCH,
                      max_seq=MOE_PROMPT + MOE_NEW)
    prompts = family_batch(cfg, MOE_BATCH, MOE_PROMPT, 17)["tokens"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts, MOE_NEW)
    got = launch_record(label, model, MOE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_finite(label, last, *steps)
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: a token outside the vocabulary")
    del last, steps
    # one step again under the profiler, re-decoding the last position
    # (the cache is full)
    eng._pos -= 1
    split = moe_split(lambda: eng.decode(toks[:, -1]), "decode_attention")
    # a second prefill, warm, with its own peak, then one more profiled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.prefill(prompts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prefill_split = moe_split(lambda: eng.prefill(prompts),
                              "attention_block")
    read = decode_read_bytes(model, params, MOE_PROMPT, MOE_NEW, MOE_BATCH)
    decode_ms = 1e3 * statistics.median(step_s)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype,
           "params": sum(t.numel() for _, t in flat_params(params)),
           "param_gb": param_bytes(params) / 1e9,
           "batch": MOE_BATCH, "prompt": MOE_PROMPT, "new": MOE_NEW,
           "launches": got, "prefill_ms": 1e3 * prefill_s,
           "prefill_ms_warm": 1e3 * warm_s,
           "prefill_tokens_per_s": MOE_BATCH * MOE_PROMPT / warm_s,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_first": 1e3 * step_s[0],
           "decode_tokens_per_s": MOE_BATCH / decode_ms * 1e3,
           "decode_bound_ms": read / peaks_[0] * 1e3,
           "decode_bound_bytes": read,
           "allocated_before_gib": before, "peak_mem_gib": peak,
           "prefill_peak_mem_gib": warm_peak, "profile_decode_step": split,
           "profile_prefill": prefill_split}
    if split["device_ms"] is not None:
        # against the unprofiled wall times, as phase 10's
        rec["decode_device_idle_share"] = 1 - split["busy_ms"] / decode_ms
        rec["prefill_device_idle_share"] = \
            1 - prefill_split["busy_ms"] / (1e3 * warm_s)
    log("main " + json.dumps(rec))
    return rec


def phase_moe_exact() -> dict:
    """17a's cut: qwen2-moe-a2.7b's widths in f32 at EXACT_LAYERS layers;
    decode logits and greedy tokens against forward's over the whole
    sequence.  T*k stays <= 4096, so neither drops a pair."""
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.models import moe
    label = "moe_qwen2_f32_exact"
    model, params = family_lm(MOE_ARCH, EXACT_LAYERS, "float32", seed=1)
    cfg = model.cfg
    seq_len = MOE_CUT_PROMPT + MOE_NEW
    if MOE_CUT_BATCH * seq_len * cfg.moe.top_k > 4096:
        raise AssertionError(f"{label}: forward would drop pairs")
    eng = ServeEngine(model, params, batch_size=MOE_CUT_BATCH,
                      max_seq=seq_len)
    prompts = family_batch(cfg, MOE_CUT_BATCH, MOE_CUT_PROMPT, 18)["tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts, MOE_NEW)
    got = launch_record(label, model, MOE_NEW)
    seq = torch.cat([torch.as_tensor(prompts, device=DEVICE).long(),
                     toks[:, :MOE_NEW].long()], dim=1)
    full, aux = model.forward(params, {"tokens": seq})
    want = full[:, MOE_CUT_PROMPT - 1:]
    rec = {"phase": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": MOE_CUT_BATCH, "prompt": MOE_CUT_PROMPT,
           "new": MOE_NEW, "capacity_forward": moe._capacity(
               MOE_CUT_BATCH * seq_len, cfg),
           "positions": [MOE_CUT_PROMPT - 1, seq_len - 1], "launches": got,
           **check_decode(label, torch.stack([last, *steps], dim=1), toks,
                          want),
           "aux": float(aux),
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * statistics.median(step_s),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if not rec["aux"] > 0:
        raise AssertionError(f"{label}: router loss {rec['aux']} is not > 0")
    log("main " + json.dumps(rec))
    return rec


def phase_moe_wide() -> dict:
    """17b: qwen3-moe-235b-a22b at full width, QWEN3_LAYERS layers, bf16:
    128 routed experts top-8, no shared expert, decode at a group of 16."""
    import torch
    from repro_torch.serve import ServeEngine
    label = "moe_qwen3_full_width"
    model, params = family_lm(QWEN3_ARCH, QWEN3_LAYERS)
    cfg = model.cfg
    eng = ServeEngine(model, params, batch_size=QWEN3_BATCH,
                      max_seq=QWEN3_PROMPT + QWEN3_NEW)
    prompts = family_batch(cfg, QWEN3_BATCH, QWEN3_PROMPT, 19)["tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts, QWEN3_NEW)
    got = launch_record(label, model, QWEN3_NEW)
    check_finite(label, last, *steps)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "group": cfg.n_heads // cfg.n_kv_heads,
           "param_gb": param_bytes(params) / 1e9,
           "batch": QWEN3_BATCH, "prompt": QWEN3_PROMPT, "new": QWEN3_NEW,
           "launches": got, "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * statistics.median(step_s),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def vlm_generate(model, params, batch: dict, new: int, max_seq: int):
    """LM.prefill over the image prefix and text, then ``new`` greedy
    LM.decode_step calls; returns (prefill logits (B, S, V), the logits of
    each step, the fed tokens (B, new), prefill s, step s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    s0 = logits.shape[1]
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    steps, fed, step_s = [], [], []
    for i in range(new):
        t0 = time.perf_counter()
        fed.append(tok)
        step, cache = model.decode_step(params, cache, tok, s0 + i)
        tok = step[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(step[:, 0])
    return logits, steps, torch.cat(fed, dim=1), prefill_s, step_s


def phase_vlm_serve(peaks_) -> dict:
    """17c: paligemma-3b at full width and depth in bf16 through
    LM.prefill and LM.decode_step (the reference's ServeEngine passes
    tokens only, so it prefills no image)."""
    import torch
    label = "vlm_paligemma_full"
    model, params = family_lm(VLM_ARCH)
    cfg = model.cfg
    batch = family_batch(cfg, VLM_BATCH, VLM_PATCHES + VLM_TEXT, 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, steps, fed, prefill_s, step_s = vlm_generate(
        model, params, batch, VLM_NEW, VLM_MAX_SEQ)
    got = launch_record(label, model, VLM_NEW)
    check_finite(label, logits[:, -1], *steps)
    decode_ms = 1e3 * statistics.median(step_s)
    read = decode_read_bytes(model, params, VLM_PATCHES + VLM_TEXT, VLM_NEW,
                             VLM_BATCH)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "param_gb": param_bytes(params) / 1e9,
           "batch": VLM_BATCH, "patches": VLM_PATCHES, "text": VLM_TEXT,
           "new": VLM_NEW, "max_seq": VLM_MAX_SEQ, "launches": got,
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": decode_ms,
           "decode_bound_ms": read / peaks_[0] * 1e3,
           "decode_bound_bytes": read,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_vlm_exact() -> dict:
    """17c's cut: paligemma-3b's widths in f32 at EXACT_LAYERS layers:
    prefill logits against forward's, each decode step's against a longer
    forward over the tokens fed, and a patch perturbed at the end of the
    prefix moves the logits at position 0."""
    import torch
    label = "vlm_paligemma_f32_exact"
    model, params = family_lm(VLM_ARCH, EXACT_LAYERS, "float32", seed=1)
    cfg = model.cfg
    s0 = VLM_PATCHES + VLM_CUT_TEXT
    batch = family_batch(cfg, VLM_CUT_BATCH, s0, 21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, steps, fed, prefill_s, step_s = vlm_generate(
        model, params, batch, VLM_NEW, s0 + VLM_NEW)
    got = launch_record(label, model, VLM_NEW)
    full, _ = model.forward(params, batch)
    prefill = check_decode(f"{label} prefill", logits, logits.argmax(-1),
                           full)
    longer = dict(batch, tokens=torch.cat(
        [torch.as_tensor(batch["tokens"], device=DEVICE).long(), fed],
        dim=1))
    full_ext, _ = model.forward(params, longer)
    want = full_ext[:, s0:]                      # position s0 + i: step i
    decode = check_decode(label, torch.stack(steps, dim=1), torch.cat(
        [fed[:, 1:], torch.stack(steps, 1)[:, -1:].argmax(-1)], dim=1),
        want)
    moved = dict(batch, patches=batch["patches"].copy())
    moved["patches"][:, -1] += 3.0
    moved_logits, _ = model.forward(params, moved)
    shift = float((moved_logits[:, 0] - full[:, 0]).abs().max())
    if not shift > 1e-6:
        raise AssertionError(f"{label}: the last patch does not reach "
                             f"position 0 (max shift {shift})")
    rec = {"phase": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": VLM_CUT_BATCH, "patches": VLM_PATCHES,
           "text": VLM_CUT_TEXT, "new": VLM_NEW, "launches": got,
           "prefill_vs_forward": prefill,
           "prefill_bitwise_equal": bool(torch.equal(logits, full)),
           "decode_vs_longer_forward": decode,
           "prefix_shift_at_position_0": shift,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_audio() -> list:
    """17d: hubert-xlarge's encoder at full width and depth in bf16 over
    AUDIO_BATCH x AUDIO_FRAMES frames (full attention), then its f32 cut on
    the card against the same cut on the CPU (the plain versions)."""
    import torch
    label = "audio_hubert_full"
    model, params = family_lm(AUDIO_ARCH)
    cfg = model.cfg
    batch = family_batch(cfg, AUDIO_BATCH, AUDIO_FRAMES, 22)
    frames = {"frames": batch["frames"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, frames)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    got = launch_record(label, model, 0)
    check_finite(label, logits)
    if logits.shape != (AUDIO_BATCH, AUDIO_FRAMES, cfg.vocab):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}")
    t0 = time.perf_counter()
    model.forward(params, frames)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    recs = [{"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
             "dtype": cfg.dtype,
             "param_gb": param_bytes(params) / 1e9,
             "batch": AUDIO_BATCH, "frames": AUDIO_FRAMES, "launches": got,
             "forward_ms_first": 1e3 * forward_s,
             "forward_ms": 1e3 * again_s,
             "frames_per_s": AUDIO_BATCH * AUDIO_FRAMES / again_s,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}]
    log("main " + json.dumps(recs[-1]))
    del model, params, logits

    from repro_torch.models import LM
    label = "audio_hubert_f32_card_vs_cpu"
    model, params = family_lm(AUDIO_ARCH, EXACT_LAYERS, "float32", seed=1)
    frames = {"frames": batch["frames"][:AUDIO_CUT_BATCH]}
    reset_launches()
    card, _ = model.forward(params, frames)
    got = launch_record(label, model, 0)
    plain, _ = LM(model.cfg, device="cpu").forward(cpu_copy(params), frames)
    err = check_close(label, card.cpu(), plain, SERVE_RTOL, SERVE_ATOL)
    recs.append({"phase": label, "n_layers": EXACT_LAYERS,
                 "dtype": "float32", "batch": AUDIO_CUT_BATCH,
                 "frames": AUDIO_FRAMES, "launches": got,
                 "max_abs_err": err, "tolerance": [SERVE_RTOL, SERVE_ATOL]})
    log("main " + json.dumps(recs[-1]))
    return recs


def phase_families(peaks_) -> list:
    """Phase 17: the moe, vlm and audio families at full width on one
    card."""
    import torch
    gc.collect()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    recs, peak = [], 0.0
    for part, fn in (("17a", lambda: [phase_moe_serve(peaks_),
                                      phase_moe_exact()]),
                     ("17b", lambda: [phase_moe_wide()]),
                     ("17c", lambda: [phase_vlm_serve(peaks_),
                                      phase_vlm_exact()]),
                     ("17d", phase_audio)):
        # earlier phases' engines sit in reference cycles until the
        # collector runs: collect them before the part, not inside it
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        recs.extend(fn())
        peak = max(peak, max(r["peak_mem_gib"] for r in recs
                             if "peak_mem_gib" in r))
        log(f"phase {part}: {time.perf_counter() - t1:.2f} s")
    seconds = time.perf_counter() - t0
    log(f"phase 17: {seconds:.2f} s, peak memory {peak:.2f} GiB "
        f"(allocated before it: {before:.2f} GiB)")
    return recs


# -- phase 18: the recurrent families at full width ----------------------------

def cpu_copy(params):
    """The same param tree on the CPU."""
    return {k: cpu_copy(v) if isinstance(v, dict) else v.cpu()
            for k, v in params.items()}


def attention_groups(cfg) -> int:
    """Applications of the hybrid's shared attention block (one a group
    of attn_every Mamba2 blocks), each one flash_attention a forward and
    one flash_decode a step; 0 for the ssm family."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0


def recurrent_step_bytes(model, params, cache, n_valid: float) -> int:
    """Bytes a decode step must move at least: every block's weights, the
    final norm and the head's table once (the embedding: one row a
    token), every recurrent state read and written once, and the
    ``n_valid`` valid KV slots of each shared-block application read
    once."""
    skip = set() if model.cfg.tie_embeddings else {"embed.table"}
    states = sum(t.numel() * t.element_size()
                 for name, t in flat_params(cache)
                 if not name.startswith("kv."))
    kv = 0
    if "kv" in cache:
        k = cache["kv"]["k"]                      # (G, B, L, KV, hd)
        kv = 2 * k.shape[0] * k.shape[1] * n_valid * k.shape[3] \
            * k.shape[4] * k.element_size()
    return int(param_bytes(params, skip) + 2 * states + kv)


def recurrent_serve(arch: str, peaks_, parts, seed: int) -> list:
    """18a / 18b: ``arch`` at full width in bf16, cut to
    RECUR_SERVE_LAYERS: a forward over RECUR_BATCH x RECUR_FWD_SEQ tokens
    (cold, then warm); the ServeEngine with RECUR_PROMPT tokens prefilled
    token by token and RECUR_NEW greedy steps; one more step split by the
    profiler over ``parts``."""
    import torch
    from repro_torch.serve import ServeEngine
    model, params = family_lm(arch, n_layers=RECUR_SERVE_LAYERS[arch])
    cfg = model.cfg
    label = f"{cfg.family}_{arch}_full"
    groups = attention_groups(cfg)
    tokens = family_batch(cfg, RECUR_BATCH, RECUR_FWD_SEQ, seed)["tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    check_launches(f"{label} forward", got, {"flash_attention": groups})
    check_finite(label, logits)
    if logits.shape != (RECUR_BATCH, RECUR_FWD_SEQ, cfg.vocab):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}")
    del logits
    t0 = time.perf_counter()
    model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    recs = [{"phase": f"{label}_forward", "arch": cfg.name,
             "n_layers": cfg.n_layers, "dtype": cfg.dtype,
             "params": sum(t.numel() for _, t in flat_params(params)),
             "param_gb": param_bytes(params) / 1e9, "batch": RECUR_BATCH,
             "seq": RECUR_FWD_SEQ, "launches": got,
             "forward_ms_first": 1e3 * first_s, "forward_ms": 1e3 * warm_s,
             "forward_tokens_per_s": RECUR_BATCH * RECUR_FWD_SEQ / warm_s,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}]
    log("main " + json.dumps(recs[-1]))

    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(model, params, batch_size=RECUR_BATCH,
                      max_seq=RECUR_MAX_SEQ)
    prompts = family_batch(cfg, RECUR_BATCH, RECUR_PROMPT, seed + 1)[
        "tokens"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts, RECUR_NEW)
    got = launches()
    check_launches(label, got, {"flash_decode": groups * (RECUR_PROMPT
                                                          + RECUR_NEW)})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_finite(label, last, *steps)
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: a token outside the vocabulary")
    del last, steps
    # one step again under the profiler, from the last position
    eng._pos -= 1
    split = range_split(lambda: eng.decode(toks[:, -1]), parts)
    n_valid = statistics.median(range(RECUR_PROMPT + 1,
                                      RECUR_PROMPT + RECUR_NEW + 1))
    read = recurrent_step_bytes(model, params, eng.cache, n_valid)
    decode_ms = 1e3 * statistics.median(step_s)
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": RECUR_BATCH, "prompt": RECUR_PROMPT,
           "new": RECUR_NEW, "max_seq": RECUR_MAX_SEQ, "launches": got,
           "prefill_ms": 1e3 * prefill_s,
           "prefill_tokens_per_s": RECUR_BATCH * RECUR_PROMPT / prefill_s,
           "prefill_ms_per_position": 1e3 * prefill_s / RECUR_PROMPT,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_first": 1e3 * step_s[0],
           "decode_tokens_per_s": RECUR_BATCH / decode_ms * 1e3,
           "decode_bound_ms": read / peaks_[0] * 1e3,
           "decode_bound_bytes": read,
           "state_bytes": sum(t.numel() * t.element_size()
                              for name, t in flat_params(eng.cache)
                              if not name.startswith("kv.")),
           "allocated_before_gib": before, "peak_mem_gib": peak,
           "profile_decode_step": split}
    if split["device_ms"] is not None:
        rec["decode_device_idle_share"] = 1 - split["busy_ms"] / decode_ms
    log("main " + json.dumps(rec))
    recs.append(rec)
    return recs


def recurrent_exact(arch: str, n_layers: int, seed: int) -> dict:
    """The f32 cut of ``arch`` at its widths and ``n_layers`` layers:
    RECUR_CUT_BATCH prompts of RECUR_PROMPT tokens prefilled token by
    token and RECUR_NEW greedy steps, every step's logits and greedy token
    against forward's over the RECUR_CUT_SEQ tokens fed, and the card's
    forward against the CPU port's on the same weights."""
    import torch
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    model, params = family_lm(arch, n_layers, "float32", seed=seed)
    cfg = model.cfg
    label = f"{cfg.family}_{arch}_f32_exact"
    groups = attention_groups(cfg)
    eng = ServeEngine(model, params, batch_size=RECUR_CUT_BATCH,
                      max_seq=RECUR_CUT_SEQ)
    prompts = family_batch(cfg, RECUR_CUT_BATCH, RECUR_PROMPT, seed + 1)[
        "tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last, steps, toks, prefill_s, step_s = serve(eng, prompts, RECUR_NEW)
    seq = torch.cat([torch.as_tensor(prompts, device=DEVICE).long(),
                     toks[:, :RECUR_NEW].long()], dim=1)
    full, _ = model.forward(params, {"tokens": seq})
    got = launches()
    check_launches(label, got, {"flash_attention": groups,
                                "flash_decode": groups * RECUR_CUT_SEQ})
    checked = check_decode(label, torch.stack([last, *steps], dim=1), toks,
                           full[:, RECUR_PROMPT - 1:])
    plain, _ = LM(cfg, device="cpu").forward(cpu_copy(params),
                                             {"tokens": seq.cpu()})
    err = check_close(f"{label} card vs cpu", full.cpu(), plain, SERVE_RTOL,
                      SERVE_ATOL)
    rec = {"phase": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": RECUR_CUT_BATCH, "prompt": RECUR_PROMPT,
           "new": RECUR_NEW, "launches": got, **checked,
           "forward_vs_cpu_max_abs_err": err,
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * statistics.median(step_s),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def phase_recurrent(peaks_) -> list:
    """Phase 18: the hybrid and ssm families at full width on one card,
    each decode step split by the port's functions."""
    import torch
    from repro_torch.models import attention, layers, ssm, xlstm
    from repro_torch.models.model import LM
    zamba_parts = [(ssm, "_project", "mamba2_in_proj"),
                   (ssm, "_state_step", "mamba2_conv_state"),
                   (ssm, "_output", "mamba2_out_proj"),
                   (attention, "decode_attention", "shared_attention"),
                   (layers, "mlp", "mlp"), (LM, "logits", "head")]
    xlstm_parts = [(xlstm, "mlstm_decode_step", "mlstm"),
                   (xlstm, "slstm_decode_step", "slstm"),
                   (LM, "logits", "head")]
    log(f"phase 18b: {XLSTM_ARCH} has no attention: no flash kernel runs")
    t0 = time.perf_counter()
    recs, peak = [], 0.0
    for part, fn in (
            ("18a", lambda: [*recurrent_serve(ZAMBA_ARCH, peaks_,
                                              zamba_parts, 25),
                             recurrent_exact(ZAMBA_ARCH, ZAMBA_CUT_LAYERS,
                                             27)]),
            ("18b", lambda: [*recurrent_serve(XLSTM_ARCH, peaks_,
                                              xlstm_parts, 29),
                             recurrent_exact(XLSTM_ARCH, XLSTM_CUT_LAYERS,
                                             31)])):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        recs.extend(fn())
        peak = max(peak, max(r["peak_mem_gib"] for r in recs))
        log(f"phase {part}: {time.perf_counter() - t1:.2f} s")
    log(f"phase 18: {time.perf_counter() - t0:.2f} s, peak memory "
        f"{peak:.2f} GiB")
    return recs


# -- phase 19: the training path ----------------------------------------------

# 19a: h2o-danube-1.8b at full width and depth in bf16 (remat "block", its
# config's), the train_4k shape's 4096-token sequences with the global
# batch of 256 cut to TRAIN_BATCH a step in TRAIN_MICRO microbatches;
# TRAIN_STEPS timed steps after one warm-up step, on one fixed batch, at
# a learning rate under which the loss falls step by step from the random
# init (3e-4 diverged at the second step; 3e-5 and 1e-5 fell, then
# oscillated)
TRAIN_STEPS, TRAIN_LR = 4, 3e-6
# 19b: each family's f32 cut (the transformer families at
# TRAIN_CUT_LAYERS, phase 18's recurrent depths; phase 17's and 18's
# batches; the dense and audio cuts at S = CUT_TRAIN_SEQ and the moe cut
# at MOE_TRAIN_SEQ, so that the CPU side takes seconds) takes one step on
# the card, its loss and gradients held against the same cut's on the CPU
# (the plain versions): the loss to TRAIN_LOSS_RTOL relative, each
# gradient leaf to MAIN_TOL of its
# largest entry (fp32 sums in other orders over up to 4096-token
# batches; a wrong mask, group sum or scale moves a leaf by far more).
# The transformer cuts take 1 layer, not phase 11's 4: every leaf kind
# and kernel call of a block is in each layer, and the CPU sides (81 s of
# the H100 machine's host at 4 layers, 66 s at 2 in PR 37's slow calls)
# are most of the phase
TRAIN_LOSS_RTOL = 1e-4
TRAIN_CUT_LAYERS = 1
TRAIN_CUTS = [(SERVE_ARCH, TRAIN_CUT_LAYERS, 2, CUT_TRAIN_SEQ),
              (MOE_ARCH, TRAIN_CUT_LAYERS, MOE_CUT_BATCH, MOE_TRAIN_SEQ),
              (VLM_ARCH, TRAIN_CUT_LAYERS, VLM_CUT_BATCH,
               VLM_PATCHES + VLM_CUT_TEXT),
              (AUDIO_ARCH, TRAIN_CUT_LAYERS, AUDIO_CUT_BATCH, CUT_TRAIN_SEQ),
              (ZAMBA_ARCH, ZAMBA_CUT_LAYERS, RECUR_CUT_BATCH, RECUR_CUT_SEQ),
              (XLSTM_ARCH, XLSTM_CUT_LAYERS, RECUR_CUT_BATCH,
               RECUR_CUT_SEQ)]


def attention_layers(cfg) -> int:
    """Attention applications of one forward: every block of the
    transformer families, one a group of the hybrid's, none for ssm."""
    from repro_torch.models.model import TRANSFORMER
    return cfg.n_layers if cfg.family in TRANSFORMER \
        else attention_groups(cfg)


def model_flops(cfg, params, batch: int, seq: int) -> float:
    """FLOPs of one training step's products: 6 per matrix weight (the
    embedding table excluded: it is gathered) a token, and attention's two
    products three times (forward, and the backward's twice) over the
    pairs the mask keeps."""
    matmul = sum(t.numel() for name, t in flat_params(params)
                 if t.dim() >= 2 and name != "embed.table")
    if cfg.tie_embeddings:
        matmul += params["embed"]["table"].numel()
    pairs = attention_pairs(seq, True, cfg.sliding_window)
    attn = 12.0 * attention_layers(cfg) * batch * cfg.n_heads \
        * cfg.resolved_head_dim * pairs
    return 6.0 * matmul * batch * seq + attn


def train_split(fn) -> dict:
    """One call of ``fn`` (a dense model's train step) under the profiler,
    its kernel time split: the forward's blocks, the head and
    cross-entropy forward and backward, the blocks' recompute (the
    checkpointed blocks run again inside the backward), the flash
    backward's kernels, the rest of the backward, the optimizer, and
    the rest (embedding, final norm, gradient sums).  A partition: each
    kernel goes to the innermost ``record_function`` range or autograd
    node around its launch (K1's by name).  A block on the main thread is
    the forward's, on the autograd engine's thread the recompute; the
    head's backward nodes are those whose sequence numbers its forward
    ops recorded on the main thread."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_mod
    from repro_torch.train import train_step as train_mod
    parts = [(model_mod.LM, "_layer", "block"),
             (model_mod.LM, "logits", "head_ce"),
             (model_mod, "_cross_entropy", "head_ce"),
             (train_mod, "adamw_update", "optimizer")]
    labels = {label for _, _, label in parts}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with annotated(parts), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in labels
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {"device_ms": None, "wall_ms_profiled": wall_ms}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    head = [e for e in cpu if e.name == "head_ce"]
    main = head[0].thread

    def inside(e, rs):
        return any(r.thread == e.thread
                   and r.time_range.start <= e.time_range.start
                   and e.time_range.end <= r.time_range.end for r in rs)

    # the head's backward nodes: those whose forward ops ran in a head
    # range on the main thread (sequence numbers count per thread)
    seqs = {e.sequence_nr for e in cpu if e.thread == main
            and getattr(e, "sequence_nr", -1) >= 0 and inside(e, head)}

    def part(e) -> str:
        """The part a launch belongs to: that of its innermost enclosing
        range or autograd node, so each kernel counts once."""
        while e is not None:
            if e.name == "block":
                return "forward_blocks" if e.thread == main else "recompute"
            if e.name == "head_ce":
                return "head_ce_forward"
            if e.name == "optimizer":
                return "optimizer"
            if e.name.startswith("autograd::engine::evaluate_function"):
                return ("head_ce_backward" if e.sequence_nr in seqs
                        and e.fwd_thread == main else "backward_other")
            e = e.cpu_parent
        return "other"

    split = dict.fromkeys(
        ("forward_blocks", "head_ce_forward", "recompute",
         "flash_attention_bwd", "head_ce_backward", "optimizer",
         "backward_other", "other"), 0.0)
    nodes = set()
    for e in cpu:
        for kern in e.kernels:
            if kern.name in labels:   # a range's own span on the card
                continue
            key = "flash_attention_bwd" if "flash_bwd" in kern.name \
                else part(e)
            split[key] += kern.duration / 1e3
            if key == "head_ce_backward":
                nodes.add(id(e))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"device_ms": device_ms, "busy_ms": busy_ms(kernels),
            "kernels": len(kernels), "split_ms": split,
            # kernels the profiler tied to no launch on the host
            "unlinked_ms": device_ms - sum(split.values()),
            "head_ce_backward_launches": len(nodes),
            "wall_ms_profiled": wall_ms}


def phase_train_full(peaks_) -> dict:
    """19a: h2o-danube-1.8b trains at full width and depth in bf16 through
    ``make_train_step`` (AdamW, microbatches, remat "block"): a warm-up
    step, then TRAIN_STEPS timed steps on one fixed batch, whose loss must
    fall, with a finite gradient norm, every param moved and the flash
    kernels' launches as the config predicts (the forward with LSE twice a
    layer a microbatch: the forward and the recompute; K1 once); then one
    more step under the profiler."""
    import torch
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.train import (TrainState, adamw_init, make_train_step,
                                   require_grad)
    label = "train_danube_full"
    bf16_peak = peaks_[2]
    torch.cuda.reset_peak_memory_stats()
    model, params = family_lm(SERVE_ARCH, seed=41)
    cfg = model.cfg
    state = TrainState(require_grad(params), adamw_init(params),
                       torch.Generator(device=DEVICE).manual_seed(42))
    # the f32 master weights move every step (a bf16 norm scale of 1.0
    # may not, under steps of about lr)
    first = {name: leaf.detach().flatten()[:1024].to(torch.float32, copy=True)
             for name, leaf in flat_params(params)}
    batch = family_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 43)
    step = make_train_step(model, lr=TRAIN_LR, warmup=1, total_steps=100,
                           microbatches=TRAIN_MICRO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    warm_loss = float(metrics["loss"])
    warm_s = time.perf_counter() - t0
    reset_launches()
    losses, norms, step_s = [], [], []
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        log(f"train step {i + 1}: {1e3 * step_s[-1]:.1f} ms, "
            f"{tokens / step_s[-1]:.1f} tokens/s, loss {losses[-1]:.6f}, "
            f"grad_norm {norms[-1]:.6f}")
    got = launches()
    n_att = attention_layers(cfg) * TRAIN_MICRO * TRAIN_STEPS
    check_launches(label, got, {"flash_attention_fwd_lse": 2 * n_att,
                                "flash_attention_bwd": n_att})
    # K1's launches by the route of its kernels: bf16 at danube's head
    # dim 80 takes the wgmma kernels every time
    k1_by_kernel = dict(cuda_fa.BY_KERNEL["flash_attention_bwd"])
    if k1_by_kernel != {"flash_bwd_wgmma": n_att}:
        raise AssertionError(f"{label}: K1 launched {k1_by_kernel}, not "
                             f"flash_bwd_wgmma {n_att} times")
    moved = sum(1 for name, leaf in flat_params(state.opt.master)
                if not torch.equal(leaf.flatten()[:1024], first[name]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = model_flops(cfg, state.params, TRAIN_BATCH, TRAIN_SEQ)
    median_s = statistics.median(step_s)
    split = train_split(lambda: step(state, batch))
    rec = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_BATCH,
           "microbatches": TRAIN_MICRO, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "reduced": {"global_batch": "256 -> 8 sequences a step (2 "
                                       "microbatches of 4), one card"},
           "warmup_loss": warm_loss, "warmup_s": warm_s, "losses": losses,
           "grad_norms": norms, "step_ms": [1e3 * s for s in step_s],
           "tokens_per_s_median": tokens / median_s,
           "params_moved": moved, "params": len(first),
           "launches": got, "k1_launches_by_kernel": k1_by_kernel,
           "peak_mem_gib": peak, "model_flops_per_step": flops,
           "model_flops_share_of_bf16_peak": flops / median_s / bf16_peak,
           "profiled_step": split}
    log(f"train: model FLOPs {flops:.4e} a step, "
        f"{flops / median_s / 1e12:.2f} TFLOP/s, "
        f"{flops / median_s / bf16_peak:.4f} of the bf16 peak; peak memory "
        f"{peak:.2f} GiB")
    log(f"train split (device ms): {json.dumps(split)}")
    log("main " + json.dumps(rec))
    if not (losses[-1] < losses[0] and all(map(math.isfinite, norms))
            and moved == len(first)):
        raise AssertionError(f"{label}: the loss did not fall, a grad norm "
                             f"is not finite or a param did not move: {rec}")
    return rec


def train_cut(arch: str, n_layers: int, batch: int, seq: int,
              seed: int) -> dict:
    """19b: the f32 cut of ``arch`` takes one train step on the card: its
    loss and gradients (``LM.loss`` and autograd, through the CUDA flash
    kernels and K1) against the same cut's on the CPU (the plain
    versions), then AdamW on the card with them."""
    import torch
    from repro_torch.models import LM
    from repro_torch.train import adamw_init, adamw_update, require_grad
    from repro_torch.train.optimizer import tree_map
    model, params = family_lm(arch, n_layers, "float32", seed=seed)
    cfg = model.cfg
    label = f"train_{cfg.family}_{arch}_f32_exact"
    cparams = require_grad(cpu_copy(params))
    require_grad(params)
    data = family_batch(cfg, batch, seq, seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    names, leaves = zip(*flat_params(params))
    loss, _ = model.loss(params, data)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    got = launches()
    n_att = attention_layers(cfg)
    check_launches(label, got, {"flash_attention_fwd_lse": 2 * n_att,
                                "flash_attention_bwd": n_att})
    t0 = time.perf_counter()
    closs, _ = LM(cfg, device="cpu").loss(cparams, data)
    cgrads = torch.autograd.grad(closs, [x for _, x in flat_params(
        cparams)], allow_unused=True, materialize_grads=True)
    cpu_s = time.perf_counter() - t0
    loss, closs = loss.detach(), closs.detach()
    loss_rel = abs(float(loss) - float(closs)) / abs(float(closs))
    worst, worst_leaf = 0.0, None
    for name, g, c in zip(names, grads, cgrads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: gradient {name} not finite")
        rel = float((g.cpu() - c).abs().max()) / (float(c.abs().max())
                                                  or 1.0)
        if rel >= worst:
            worst, worst_leaf = rel, name
    it = iter(grads)
    params, opt, metrics = adamw_update(tree_map(lambda _: next(it), params),
                                        adamw_init(params), params, lr=1e-3)
    rec = {"phase": label, "arch": arch, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": batch,
           "seq": seq, "loss": float(loss), "loss_cpu": float(closs),
           "loss_rel_err": loss_rel, "grad_leaves": len(names),
           "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
           "grad_norm": float(metrics["grad_norm"]), "launches": got,
           "card_loss_and_grads_s": card_s, "cpu_loss_and_grads_s": cpu_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    if loss_rel > TRAIN_LOSS_RTOL or worst > MAIN_TOL \
            or not math.isfinite(rec["grad_norm"]):
        raise AssertionError(f"{label}: card against CPU: loss {loss_rel} "
                             f"(limit {TRAIN_LOSS_RTOL}), gradient "
                             f"{worst_leaf} {worst} (limit {MAIN_TOL})")
    return rec


def phase_train(peaks_) -> list:
    """Phase 19: the training path on the card (19a danube at full width
    and depth in bf16; 19b every family's f32 cut against the CPU)."""
    import torch
    t0 = time.perf_counter()
    recs = []
    for part, fn in (("19a", lambda: [phase_train_full(peaks_)]),
                     *((f"19b {arch}", lambda a=arch, n=n, b=b, s=s, i=i:
                        [train_cut(a, n, b, s, 51 + 2 * i)])
                       for i, (arch, n, b, s) in enumerate(TRAIN_CUTS))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        recs.extend(fn())
        log(f"phase {part}: {time.perf_counter() - t1:.2f} s")
    log(f"phase 19: {time.perf_counter() - t0:.2f} s, peak memory "
        f"{max(r['peak_mem_gib'] for r in recs):.2f} GiB")
    return recs



# -- phase 20: the training driver with checkpoints and restarts --------------

# h2o-danube-1.8b at its published widths in bf16 (remat "block", its
# config's) through repro_torch.launch.train, cut to CKPT_LAYERS of its 24
# layers: 302.8 M params, so a full checkpoint of the TrainState is 4.84
# GB on disk (params stored as f32, as the reference stores bf16, plus f32
# master, m and v); at full depth a checkpoint would take 29 GB and the
# phase writes several (4 layers, 7.07 GB, until the script's time limit
# asked for a cut: PERF.md §6, PR 37).  B x S is
# phase 19a's microbatch.  CKPT_STEPS steps, a checkpoint every
# CKPT_SAVE_EVERY; 20b's host 1 goes silent after CKPT_SILENT_AFTER steps;
# the learning rate keeps the loss finite (phase 19a's).
CKPT_LAYERS, CKPT_BATCH, CKPT_SEQ = 2, TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ
CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_SILENT_AFTER, CKPT_LR = 8, 4, 6, TRAIN_LR
# steps timed without a save, then with one in flight
CKPT_TIMED_STEPS = 5
# A resumed run against the uninterrupted one, where a step is not
# bit-reproducible on the card: each leaf to MAIN_TOL of its largest
# entry (fp32 sums in other orders over 4 replayed steps; a lost or
# doubled step moves the moments by far more)
CKPT_RESUME_TOL = MAIN_TOL
# 20f: the command users run, twice
CKPT_CLI = ["--arch", "custom-10m", "--steps", "20", "--save-every", "10"]


def clone_state(state):
    """An owned copy of a TrainState on its device (the generator a new
    one with the same state)."""
    import torch
    from repro_torch.train import OptState, TrainState, require_grad
    from repro_torch.train.optimizer import tree_map

    def copy(x):
        return x.detach().clone()

    gen = torch.Generator(device=state.rng.device)
    gen.set_state(state.rng.get_state())
    opt = state.opt
    return TrainState(require_grad(tree_map(copy, state.params)),
                      OptState(copy(opt.step), tree_map(copy, opt.master),
                               tree_map(copy, opt.m), tree_map(copy, opt.v)),
                      gen)


def state_diff(got, want) -> dict:
    """Leaf by leaf (the checkpoint's paths): how many differ in any bit,
    and the largest |got - want| over the leaf's largest |want|."""
    import torch
    from repro_torch.dist.checkpoint import _leaf_paths
    pg, pw = _leaf_paths(got), _leaf_paths(want)
    if [p for p, _ in pg] != [p for p, _ in pw]:
        raise AssertionError("the states have different leaves")
    unequal, worst, worst_leaf = [], 0.0, None
    for (path, a), (_, b) in zip(pg, pw):
        if isinstance(b, torch.Generator):
            a, b = a.get_state(), b.get_state()
        elif a.device != b.device or a.dtype != b.dtype:
            raise AssertionError(f"{path}: {a.device} {a.dtype} against "
                                 f"{b.device} {b.dtype}")
        if torch.equal(a, b):
            continue
        unequal.append(path)
        rel = float((a.double() - b.double()).abs().max()) / (
            float(b.double().abs().max()) or 1.0)
        if rel >= worst:
            worst, worst_leaf = rel, path
    return {"leaves": len(pg), "unequal": len(unequal),
            "unequal_first": unequal[:4], "worst_rel_err": worst,
            "worst_leaf": worst_leaf}


def drive_train(label: str, cfg, **kw) -> dict:
    """One call of ``repro_torch.launch.train.train`` on the card, the
    entry point's own loop; its module's ``synth_batch``,
    ``make_train_step`` and ``CheckpointManager`` wrapped to record the
    step of each batch drawn, the state after each step, and the managers
    it made.  The flash kernels' launches must be the config's for the
    steps actually run (the forward with LSE twice a layer a step under
    remat "block", K1 once).  → record, with the final state and the
    managers under ``_state`` and ``_managers``."""
    import torch
    import repro_torch.launch.train as train_mod
    seen, box, managers = [], {}, []
    orig = (train_mod.synth_batch, train_mod.make_train_step,
            train_mod.CheckpointManager)

    def synth(*a, **k):
        seen.append(k["step"])
        return orig[0](*a, **k)

    def make(*a, **k):
        fn = orig[1](*a, **k)

        def step(state, batch):
            state, metrics = fn(state, batch)
            box["state"] = state
            return state, metrics
        return step

    class Recorded(orig[2]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            managers.append(self)

    train_mod.synth_batch, train_mod.make_train_step = synth, make
    train_mod.CheckpointManager = Recorded
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = train_mod.train(cfg, steps=CKPT_STEPS, batch=CKPT_BATCH,
                                 seq=CKPT_SEQ, lr=CKPT_LR, seed=61,
                                 log_every=1, **kw)
    finally:
        (train_mod.synth_batch, train_mod.make_train_step,
         train_mod.CheckpointManager) = orig
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    n_att = attention_layers(cfg) * len(seen)
    check_launches(label, got, {"flash_attention_fwd_lse": 2 * n_att,
                                "flash_attention_bwd": n_att})
    losses = [h["loss"] for h in result["history"]]
    if not losses or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    return {"phase": label, "steps_run": seen, "launches": got,
            "restarts": result["restarts"], "phase_after": result["phase"],
            "ft_events": result["ft_events"], "losses": losses,
            "ms_per_step": [h["ms_per_step"] for h in result["history"]],
            "seconds": seconds, "_state": box["state"],
            "_managers": managers}


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


def timed_steps(step, state, batch, n: int) -> list:
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def ckpt_costs(cfg, state, directory: Path) -> dict:
    """20a's end state through a CheckpointManager of its own: the device
    memory the staged copy adds, the steps' ms without a save and with
    one in flight (on a copy of the state, stepped in place), the save's
    parts (the caller's staging; the writer's gather, encode with CRC and
    write) and GB on disk.  The restore is timed in 20c."""
    import torch
    from repro_torch.dist import CheckpointManager
    from repro_torch.models import LM
    from repro_torch.train import make_train_step
    label = "ckpt_costs"
    model = LM(cfg)
    step = make_train_step(model, lr=CKPT_LR, warmup=1, total_steps=100)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in family_batch(
        cfg, CKPT_BATCH, CKPT_SEQ, 67).items()}
    work = clone_state(state)
    reset_launches()
    timed_steps(step, work, batch, 1)                      # warm
    plain = timed_steps(step, work, batch, CKPT_TIMED_STEPS)
    mgr = CheckpointManager(str(directory), async_save=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mgr.save(CKPT_STEPS, state)
    staged = torch.cuda.memory_allocated() - before
    during = timed_steps(step, work, batch, CKPT_TIMED_STEPS)
    in_flight = not mgr._inflight.done()
    t0 = time.perf_counter()
    mgr.wait()
    waited = time.perf_counter() - t0
    got = launches()
    n_att = attention_layers(cfg) * (2 * CKPT_TIMED_STEPS + 1)
    check_launches(label, got, {"flash_attention_fwd_lse": 2 * n_att,
                                "flash_attention_bwd": n_att})
    parts = {k: 1e3 * v for k, v in mgr.last_save_s.items()}
    nbytes = os.path.getsize(str(directory / f"ckpt_{CKPT_STEPS:08d}.npz"))
    mgr.close()
    writer_ms = parts["gather"] + parts["encode"] + parts["write"]
    rec = {"phase": label, "launches": got,
           "save_stage_ms": parts["stage"], "writer_ms": writer_ms,
           "gather_ms": parts["gather"], "encode_crc_ms": parts["encode"],
           "write_ms": parts["write"], "gb_on_disk": nbytes / 1e9,
           "write_gb_per_s": nbytes / 1e9 / (parts["write"] / 1e3),
           "writer_gb_per_s": nbytes / 1e9 / (writer_ms / 1e3),
           "wait_after_steps_ms": 1e3 * waited,
           "staged_copy_gib": staged / 2 ** 30,
           "step_ms_without_save": spread(plain),
           "step_ms_save_in_flight": spread(during),
           "save_in_flight_through_the_steps": in_flight}
    log("main " + json.dumps(rec))
    return rec


def phase_ckpt_cli(directory: Path) -> dict:
    """20f: ``python -m repro_torch.launch.train`` with a checkpoint
    directory, twice, in subprocesses on the card: the second run resumes
    from the step the first finished."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CKPT_CLI,
           "--ckpt-dir", str(directory)]
    outs, seconds = [], []
    reset_launches()   # the subprocesses' launches are their own
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        seconds.append(time.perf_counter() - t0)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        outs.append(proc.stdout)
        for line in proc.stdout.splitlines():
            log(f"  {line}")
    last = int(CKPT_CLI[CKPT_CLI.index("--steps") + 1])
    if f"resumed from step {last}" not in outs[1] or "resumed" in outs[0]:
        raise AssertionError("the second run did not resume from step "
                             f"{last}:\n{outs[1]}")
    rec = {"phase": "ckpt_cli", "command": cmd[1:], "seconds": seconds,
           "launches": launches()}
    log("main " + json.dumps(rec))
    return rec


def phase_ckpt_serve(directory: Path) -> dict:
    """20g: phase 11's f32 4-layer engine: ``save_checkpoint``, a
    generation and a logit view attached, the weights moved, then
    ``restore_checkpoint``: the params bit for bit, the cache, position
    and views reset, and a greedy generation equal to a fresh engine's on
    the saved weights."""
    import numpy as np
    import torch
    from repro_torch.dist import CheckpointManager
    from repro_torch.serve import IncrementalLogitView, ServeEngine
    from repro_torch.train.optimizer import leaves, tree_map
    label = "ckpt_serve_danube_f32"
    eng = serve_engine(n_layers=EXACT_LAYERS, dtype="float32", seed=1)
    cfg = eng.model.cfg
    saved = tree_map(lambda x: x.clone(), eng.params)
    prompts = np.random.default_rng(71).integers(
        1, cfg.vocab, (SERVE_BATCH, 64)).astype(np.int32)
    new = 8
    mgr = CheckpointManager(str(directory), async_save=False)
    reset_launches()
    t0 = time.perf_counter()
    eng.save_checkpoint(mgr, 1)
    save_s = time.perf_counter() - t0
    eng.generate(prompts, max_new=new)
    H = torch.randn(64, cfg.d_model, device=DEVICE)
    eng.attach_logit_view("lm_head", IncrementalLogitView(
        H, eng.params["lm_head"]["table"].float(), device=DEVICE))
    for leaf in leaves(eng.params):
        leaf.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore_checkpoint(mgr)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = state_diff(eng.params, saved)
    reset = (eng._pos == 0 and not eng._logit_views and not eng._view_guards
             and not any(bool(x.any()) for x in leaves(eng.cache)))
    got_tokens = eng.generate(prompts, max_new=new)
    fresh = ServeEngine(eng.model, saved, batch_size=SERVE_BATCH,
                        max_seq=eng.max_seq)
    want_tokens = fresh.generate(prompts, max_new=new)
    got = launches()
    check_launches(label, got, {"flash_attention": 3 * cfg.n_layers,
                                "flash_decode": 3 * cfg.n_layers * new})
    rec = {"phase": label, "launches": got, "params_diff": diff,
           "reset": reset, "tokens_equal": bool(np.array_equal(
               got_tokens, want_tokens)), "save_s": save_s,
           "restore_s": restore_s}
    log("main " + json.dumps(rec))
    if diff["unequal"] or not reset or not rec["tokens_equal"]:
        raise AssertionError(f"{label}: {rec}")
    return rec


def phase_ckpt() -> list:
    """Phase 20: the training driver on the card with checkpoints, a
    supervised restart, a restore round trip, a resume and a recovery
    drill (20a-20e), its command line (20f) and the serving hooks (20g),
    in a temporary directory checked for space first and removed at the
    end."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import CheckpointManager, FaultTolerantController
    from repro_torch.dist.fault_tolerance import FaultToleranceConfig
    from repro_torch.guard import ChaosConfig
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=CKPT_LAYERS)
    # a checkpoint: params stored as f32, f32 master, m and v
    ckpt_bytes = 16 * cfg.param_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    # at most two checkpoints on disk at once (20b's steps 4 and 8, or
    # the cost measurement's one), then 20f's and 20g's (1.8 GB); half
    # again for slack
    need = 3 * ckpt_bytes
    free = shutil.disk_usage(tmp).free
    log(f"phase 20: {tmp}: {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
        f"needed ({ckpt_bytes / 1e9:.2f} GB a checkpoint of "
        f"{cfg.param_count() / 1e6:.1f} M params)")
    recs = []
    try:
        if free < need:
            raise RuntimeError(f"phase 20 needs {need / 1e9:.1f} GB in "
                               f"{tmp}, {free / 1e9:.1f} GB free")
        # 20a: uninterrupted, no checkpoint directory
        a = drive_train("driver_uninterrupted", cfg, resume=False)
        if a["steps_run"] != list(range(CKPT_STEPS)) or a["restarts"]:
            raise AssertionError(f"20a: {a}")
        state_a = a.pop("_state")
        a.pop("_managers")
        log("main " + json.dumps(a))
        recs.append(a)
        gc.collect()
        recs.append(ckpt_costs(cfg, state_a, tmp / "costs"))
        shutil.rmtree(tmp / "costs")
        gc.collect()

        # 20b: the same steps with checkpoints; host 1 of 2 goes silent
        # after the sixth step (tests/test_fault_tolerance.py's driver
        # test: a fake clock, its heartbeat backdated past the timeout)
        clock = {"t": 0.0}
        steps_seen = []
        driver_ckpt = tmp / "driver"

        class SilentHost(FaultTolerantController):
            def tick(self):
                steps_seen.append(None)
                clock["t"] += 0.1
                if len(steps_seen) == CKPT_SILENT_AFTER:
                    self._last_seen[1] -= 100.0
                return super().tick()

        ctl = SilentHost(2, FaultToleranceConfig(heartbeat_timeout=3.0),
                         clock=lambda: clock["t"])
        b = drive_train("driver_supervised_restart", cfg,
                        ckpt_dir=str(driver_ckpt),
                        save_every=CKPT_SAVE_EVERY, controller=ctl)
        want_seen = [*range(CKPT_SILENT_AFTER),
                     *range(CKPT_SAVE_EVERY, CKPT_STEPS)]
        state_b = b.pop("_state")
        # the parts of the training driver's last save: blocking, with no
        # step beside it
        b["final_save_ms"] = {k: 1e3 * v for k, v in
                              b.pop("_managers")[0].last_save_s.items()}
        log("main " + json.dumps(b))
        if (b["restarts"] != 1 or b["phase_after"] != "running"
                or not any("failed host 1" in e for e in b["ft_events"])
                or b["steps_run"] != want_seen):
            raise AssertionError(f"20b: {b}")
        recs.append(b)

        # 20c: the newest checkpoint into a fresh template, bit for bit
        model = LM(cfg)
        mgr = CheckpointManager(str(driver_ckpt), async_save=False)
        reset_launches()
        template = init_train_state(model, torch.Generator(
            device=DEVICE).manual_seed(73))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore(template)
        torch.cuda.synchronize()
        del template
        c = {"phase": "ckpt_restore_round_trip",
             "steps": mgr.all_steps(), "restored_step":
             mgr.last_restored_step, "restore_ms":
             1e3 * (time.perf_counter() - t0),
             "diff": state_diff(restored, state_b),
             "params_require_grad": all(
                 p.requires_grad and p.is_leaf for _, p in flat_params(
                     restored.params)),
             "launches": launches()}
        log("main " + json.dumps(c))
        if (c["diff"]["unequal"] or c["restored_step"] != CKPT_STEPS
                or not c["params_require_grad"]):
            raise AssertionError(f"20c: {c}")
        recs.append(c)

        # 20d: is one step bit-reproducible on the card?  Then the
        # resumed run must equal the uninterrupted one bit for bit
        step = make_train_step(model, lr=CKPT_LR, warmup=1, total_steps=100)
        batch = family_batch(cfg, CKPT_BATCH, CKPT_SEQ, 79)
        reset_launches()
        twin = clone_state(restored)
        one, _ = step(restored, batch)
        two, _ = step(twin, batch)
        torch.cuda.synchronize()
        repro = state_diff(one, two)
        del one, two, twin, restored
        n_att = attention_layers(cfg) * 2
        got = launches()
        check_launches("ckpt_step_twice", got, {
            "flash_attention_fwd_lse": 2 * n_att,
            "flash_attention_bwd": n_att})
        resume = state_diff(state_b, state_a)
        d = {"phase": "ckpt_resume_against_uninterrupted",
             "step_bit_reproducible": repro["unequal"] == 0,
             "step_twice_diff": repro, "resume_diff": resume,
             "tolerance": (0.0 if repro["unequal"] == 0
                           else CKPT_RESUME_TOL), "launches": got}
        log("main " + json.dumps(d))
        if resume["worst_rel_err"] > d["tolerance"] or (
                d["step_bit_reproducible"] and resume["unequal"]):
            raise AssertionError(f"20d: {d}")
        recs.append(d)
        del state_b
        gc.collect()

        # 20e: step 8's payload corrupted by the chaos hook: the training
        # driver's resume falls back to step 4 and finishes every step
        monkey = ChaosConfig(seed=83, corrupt_checkpoint_p=1.0).monkey()
        if not monkey.maybe_corrupt_checkpoint(
                str(driver_ckpt / f"ckpt_{CKPT_STEPS:08d}.npz")):
            raise AssertionError("20e: the chaos hook corrupted nothing")
        e = drive_train("driver_resume_after_corruption", cfg,
                        ckpt_dir=str(driver_ckpt),
                        save_every=CKPT_SAVE_EVERY, resume=True,
                        ft_config=FaultToleranceConfig(
                            heartbeat_timeout=3600.0))
        e["restored_step"] = e.pop("_managers")[0].last_restored_step
        e["diff_to_uninterrupted"] = state_diff(e.pop("_state"), state_a)
        log("main " + json.dumps(e))
        if (e["restored_step"] != CKPT_SAVE_EVERY
                or e["steps_run"] != list(range(CKPT_SAVE_EVERY, CKPT_STEPS))
                or e["restarts"] or e["diff_to_uninterrupted"][
                    "worst_rel_err"] > d["tolerance"]
                or (d["step_bit_reproducible"]
                    and e["diff_to_uninterrupted"]["unequal"])):
            raise AssertionError(f"20e: {e}")
        recs.append(e)
        del state_a
        gc.collect()
        torch.cuda.empty_cache()

        # 20f: the command line; 20g: the serving hooks
        recs.append(phase_ckpt_cli(tmp / "cli"))
        recs.append(phase_ckpt_serve(tmp / "serve"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 20: {time.perf_counter() - t_phase:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return recs


# -- phase 21: the row-sharded engine -------------------------------------------

def kernel_counts() -> dict:
    """Every kernel module's launch counters since the last reset, and
    the rank-update entries' by K, by p and on the skinny tile by K, as
    plain dicts (a spawned rank sends them to the parent)."""
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import rank_update, rank_update_rows
    out = {"launches": {}, "ranks": {}, "cols": {}, "skinny": {},
           "flash_kernels": {}}
    for mod in kernel_modules():
        out["launches"].update(mod.LAUNCHES)
    for key, counters in (("ranks", rank_update.RANKS),
                          ("cols", rank_update.COLS),
                          ("cols", rank_update_rows.COLS),
                          ("skinny", rank_update.SKINNY_RANKS),
                          ("flash_kernels", cuda_fa.BY_KERNEL)):
        for entry, counter in counters.items():
            out[key][entry] = dict(counter)
    return out


def merge_counts(total: dict, counts: dict) -> None:
    """Add a main-path drive's ``kernel_counts()`` (a spawned rank's) to
    ``total`` and to the kernels record's tallies by p, by skinny K, the
    out-of-place entry's by K and the flash forward's by kernel, as
    ``launches()`` adds the parent's."""
    for entry, count in counts["launches"].items():
        total[entry] = total.get(entry, 0) + count
    for key, into in (("cols", BY_P), ("skinny", SKINNY_K),
                      ("flash_kernels", FLASH_BY_KERNEL)):
        for entry, counter in counts[key].items():
            tally = into.setdefault(entry, {})
            for k, count in counter.items():
                tally[k] = tally.get(k, 0) + count
    for k, count in counts["ranks"].get("rank_update_batched_out",
                                        {}).items():
        OUT_RANKS[k] = OUT_RANKS.get(k, 0) + count


def shard_stream(n: int, m: int, seed: int) -> list:
    from repro_torch.data import UpdateStream
    stream = UpdateStream(n=n, m=m, seed=seed)
    return [stream.next_update() for _ in range(SHARD_SINGLE + SHARD_BATCH)]


def shard_drive(eng, name: str, ups, batches=None) -> list:
    """Fire ``ups`` on an engine, each of the first SHARD_SINGLE alone and
    the rest as one batch (or each list of ``batches`` as one batch).
    Per firing: the dense kernel's launches, which must equal the
    engine's applies, the collectives' bytes and the blocked ms."""
    import torch
    from repro_torch.dist import ivm_shard
    from repro_torch.kernels import rank_update
    if batches is None:
        batches = [[up] for up in ups[:SHARD_SINGLE]] + [ups[SHARD_SINGLE:]]
        singles = SHARD_SINGLE
    else:
        singles = 0
    out = []
    for i, group in enumerate(batches):
        l0 = rank_update.LAUNCHES["rank_update_batched"]
        a0 = eng.stats.lowrank_applies
        b0 = dict(ivm_shard.BYTES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < singles:
            eng.apply_update(name, *group[0], block=True)
        else:
            eng.apply_updates(name, group, block=True)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"updates": len(group), "single": i < singles, "ms": ms,
               "ms_per_update": ms / len(group),
               "launches": rank_update.LAUNCHES["rank_update_batched"] - l0,
               "lowrank_applies": eng.stats.lowrank_applies - a0,
               "bytes": {k: ivm_shard.BYTES[k] - b0[k]
                         for k in ivm_shard.BYTES}}
        if rec["launches"] != rec["lowrank_applies"]:
            raise AssertionError(f"a firing launched rank_update_batched "
                                 f"{rec['launches']} times for "
                                 f"{rec['lowrank_applies']} applies")
        out.append(rec)
    return out


def shard_compare(label: str, eng, wants: dict) -> dict:
    """Every view of a mesh engine gathered whole (a collective: every
    rank calls it) and held, on the rank that has them, against each
    ``wants[key] = (views, limit)`` relative to the view's largest
    entry.  Returns {key: {view: rel}}."""
    import torch
    rel = {key: {} for key in wants}
    for name in sorted(eng.views):
        got = eng.output(name)
        if not wants:
            continue
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: view {name} is non-finite")
        for key, (views, limit) in wants.items():
            want = views[name]
            if got.shape != want.shape:
                raise AssertionError(f"{label}: view {name} is "
                                     f"{tuple(got.shape)}, {key}'s "
                                     f"{tuple(want.shape)}")
            scale = float(want.abs().max()) or 1.0
            rel[key][name] = float((got - want).abs().max()) / scale
            if rel[key][name] > limit:
                raise AssertionError(f"{label}: view {name} differs from "
                                     f"the {key} engine's by "
                                     f"{rel[key][name]} > {limit}")
        del got
    return rel


def shard_replicated_equal(eng, name: str, up, mesh) -> dict:
    """The factor blocks one more firing of ``eng``'s trigger computes,
    without an apply: each replicated block against rank 0's, bit for
    bit (broadcast from rank 0)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import ivm_shard
    u, v = (torch.as_tensor(x, dtype=torch.float32).reshape(len(x), -1)
            .to(eng.device) for x in up)
    vals = ivm_shard.firing_values(eng.compiled.triggers[name], eng.program,
                                   eng.views, u, v, mesh)
    reps = [t.reshape(-1) for kind, t in vals.values() if kind == "Rep"]
    flat = torch.cat(reps)
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.get_group("rows"))
    return {"blocks": len(reps), "values": flat.numel(),
            "kinds": {a: kind for a, (kind, _) in vals.items()},
            "bit_equal": bool(torch.equal(flat, ref))}


def phase_shard_one_rank() -> dict:
    """21a: matrix powers on a one-rank NCCL mesh in this process, against
    the single-device engine (SHARD_ONE_TOL) and re-evaluation
    (MAIN_TOL), both on the card and fed the same stream."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.apps import MatrixPowers
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.core.iterative import matrix_powers
    from repro_torch.dist import ivm_shard
    n = POWERS_N
    label = f"shard_one_rank_nccl_powers_n{n}_k16"
    inputs = MatrixPowers.synthesize(n, seed=0)
    ups = shard_stream(n, n, seed=21)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = DeviceMesh("cuda", torch.arange(1),
                              mesh_dim_names=("rows",))
            backend = dist.get_backend(mesh.get_group("rows"))
            eng = IncrementalEngine(matrix_powers(k=16, n=n, model="exp"),
                                    mesh=mesh)
            eng.initialize(inputs)
            torch.cuda.synchronize()
            reset_launches()
            ivm_shard.reset_bytes()
            firings = shard_drive(eng, "A", ups)
            got, ranks = launches(), dense_ranks()
            applies = eng.stats.lowrank_applies
            check_launches(label, got, {"rank_update_batched": applies})
            single = IncrementalEngine(
                matrix_powers(k=16, n=n, model="exp"), device=DEVICE)
            single.initialize(inputs)
            shard_drive(single, "A", ups)
            ree = ReevalEngine(matrix_powers(k=16, n=n, model="exp"),
                               device=DEVICE)
            ree.initialize(inputs)
            for u, v in ups:
                ree.apply_update("A", u, v)
            rel = shard_compare(label, eng, {
                "single_device": (single.views, SHARD_ONE_TOL),
                "reeval": (ree.views, MAIN_TOL)})
            fired = eng.stats.triggers_fired
            del eng, single, ree
        finally:
            dist.destroy_process_group()
    rec = {"phase": label, "backend": backend, "world": 1,
           "firings": firings, "triggers_fired": fired,
           "lowrank_applies": applies, "launches": got,
           "dense_ranks": ranks,
           "rel_err_vs_single_device": rel["single_device"],
           "single_device_tolerance": SHARD_ONE_TOL,
           "rel_err_vs_reeval": rel["reeval"], "tolerance": MAIN_TOL,
           "seconds": time.perf_counter() - t_phase,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("main " + json.dumps(rec))
    return rec


def shard_rank_powers(rank: int, mesh) -> dict:
    """21b's matrix powers on one rank: the unplanned engine, the planned
    one (every view re-evaluated in the firing), one re-evaluation
    product's bytes, and on rank 0 the single-device engine and
    re-evaluation to hold both against."""
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.core.iterative import matrix_powers
    from repro_torch.dist import ivm_shard
    from repro_torch.plan import TriggerCache, WorkloadDescriptor
    n = POWERS_N
    label = f"shard_rank{rank}_powers_n{n}_k16"
    inputs = MatrixPowers.synthesize(n, seed=0)
    ups = shard_stream(n, n, seed=21)
    out = {}
    eng = IncrementalEngine(matrix_powers(k=16, n=n, model="exp"),
                            mesh=mesh)
    t0 = time.perf_counter()
    eng.initialize(inputs)
    torch.cuda.synchronize()
    out["initialize_s"] = time.perf_counter() - t0
    out["local_shape"] = list(eng.views["P16"].shape)
    reset_launches()
    ivm_shard.reset_bytes()
    out["firings"] = shard_drive(eng, "A", ups)
    counts = kernel_counts()
    check_launches(label, counts["launches"],
                   {"rank_update_batched": eng.stats.lowrank_applies})
    out["lowrank_applies"] = eng.stats.lowrank_applies
    out["replicated"] = shard_replicated_equal(eng, "A", ups[0], mesh)
    planned = IncrementalEngine(matrix_powers(k=16, n=n, model="exp"),
                                mesh=mesh, trigger_cache=TriggerCache(),
                                plan=WorkloadDescriptor(batch_size=100000))
    planned.initialize(inputs)
    torch.cuda.synchronize()
    reset_launches()
    out["planned_firings"] = shard_drive(
        planned, "A", ups, batches=[ups[:SHARD_SINGLE], ups[SHARD_SINGLE:]])
    pcounts = kernel_counts()
    check_launches(label + "_planned", pcounts["launches"],
                   {"rank_update_batched": planned.stats.lowrank_applies})
    out["plan_reevals"] = planned.stats.plan_reevals
    if not out["plan_reevals"]:
        raise AssertionError(f"{label}: the planned engine re-evaluated "
                             "no view")
    ivm_shard.reset_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivm_shard.distributed_reeval_matmul(mesh)(eng.views["A"],
                                              eng.views["P2"])
    torch.cuda.synchronize()
    out["reeval_matmul"] = {"ms": (time.perf_counter() - t0) * 1e3,
                            "bytes": dict(ivm_shard.BYTES)}
    wants = {}
    if rank == 0:
        single = IncrementalEngine(matrix_powers(k=16, n=n, model="exp"),
                                   device=DEVICE)
        single.initialize(inputs)
        shard_drive(single, "A", ups)
        ree = ReevalEngine(matrix_powers(k=16, n=n, model="exp"),
                           device=DEVICE)
        ree.initialize(inputs)
        for u, v in ups:
            ree.apply_update("A", u, v)
        wants = {"single_device": (single.views, MAIN_TOL),
                 "reeval": (ree.views, MAIN_TOL)}
    out["rel_err"] = shard_compare(label, eng, wants)
    out["planned_rel_err"] = shard_compare(label + "_planned", planned,
                                           wants)
    return out, [counts, pcounts]


def shard_rank_ols(rank: int, mesh) -> dict:
    """21b's OLS on one rank, against the single-device engine and
    re-evaluation on rank 0."""
    import torch
    from repro_torch.apps import OLS
    from repro_torch.apps.ols import build_ols_program
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.dist import ivm_shard
    m_rows, n_cols = OLS_M, OLS_N
    label = f"shard_rank{rank}_ols_m{m_rows}_n{n_cols}_p1"
    inputs, _ = OLS.synthesize(m_rows, n_cols, 1, seed=0)
    ups = shard_stream(m_rows, n_cols, seed=22)
    out = {}
    eng = IncrementalEngine(build_ols_program(m_rows, n_cols, 1), mesh=mesh)
    t0 = time.perf_counter()
    eng.initialize(inputs)
    torch.cuda.synchronize()
    out["initialize_s"] = time.perf_counter() - t0
    out["local_shapes"] = {k: list(v.shape) for k, v in eng.views.items()}
    reset_launches()
    ivm_shard.reset_bytes()
    out["firings"] = shard_drive(eng, "X", ups)
    counts = kernel_counts()
    check_launches(label, counts["launches"],
                   {"rank_update_batched": eng.stats.lowrank_applies})
    out["lowrank_applies"] = eng.stats.lowrank_applies
    out["replicated"] = shard_replicated_equal(eng, "X", ups[0], mesh)
    wants = {}
    if rank == 0:
        single = IncrementalEngine(build_ols_program(m_rows, n_cols, 1),
                                   device=DEVICE)
        single.initialize(inputs)
        shard_drive(single, "X", ups)
        ree = ReevalEngine(build_ols_program(m_rows, n_cols, 1),
                           device=DEVICE)
        ree.initialize(inputs)
        for u, v in ups:
            ree.apply_update("X", u, v)
        wants = {"single_device": (single.views, MAIN_TOL),
                 "reeval": (ree.views, MAIN_TOL)}
    out["rel_err"] = shard_compare(label, eng, wants)
    return out, [counts]


def shard_rank_sentinel(rank: int, mesh) -> dict:
    """21c: the drift sentinel on the four-rank engine (in place, so its
    firings launch the dense kernel once an apply): a firing, P4 shifted
    on every rank's rows, a firing whose probe finds the drift (the same
    drifts on every rank: the squares are summed over the rows' ranks)
    and recovers the views it finds, on the mesh in their row layout; a
    second probe and recovery (the recovered P8 leaves P16 drifted); a
    probe after finds none; on rank 0 the gathered views against
    re-evaluation (MAIN_TOL)."""
    import torch
    from repro_torch.apps import MatrixPowers
    from repro_torch.core import IncrementalEngine, ReevalEngine
    from repro_torch.core.iterative import matrix_powers
    from repro_torch.guard import GuardConfig, SentinelConfig
    n = SHARD_SENTINEL_N
    label = f"shard_rank{rank}_sentinel_n{n}_k16"
    inputs = MatrixPowers.synthesize(n, seed=0)
    ups = shard_stream(n, n, seed=23)[:2]
    config = SentinelConfig(probe_every=2, seed=7)
    eng = IncrementalEngine(matrix_powers(k=16, n=n, model="exp"),
                            mesh=mesh, guard=GuardConfig(
                                sentinel=config, transactional=False))
    eng.initialize(inputs)
    torch.cuda.synchronize()
    reset_launches()
    eng.apply_update("A", *ups[0], block=True)
    eng.views["P4"].add_(SHARD_SENTINEL_SHIFT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.apply_update("A", *ups[1], block=True)
    torch.cuda.synchronize()
    out = {"firing_with_probe_ms": (time.perf_counter() - t0) * 1e3}
    counts = kernel_counts()
    check_launches(label, counts["launches"],
                   {"rank_update_batched": eng.stats.lowrank_applies})
    sentinel = eng.guard.sentinel
    out.update(lowrank_applies=eng.stats.lowrank_applies,
               probes=sentinel.probes, recoveries=sentinel.recoveries,
               drift=dict(sentinel.last_drift),
               local_rows=int(eng.views["P4"].shape[0]))
    # a view consistent with a drifted parent (P16 with P8) drifts once
    # the parent is recovered: the next probe finds it, as the
    # reference's sentinel would at its next cadence
    t0 = time.perf_counter()
    out["second"] = sentinel.probe(eng)
    out["probe_ms"] = (time.perf_counter() - t0) * 1e3
    out["second_recovered"] = sentinel.recover(eng,
                                               sentinel.drifted_views())
    out["after"] = sentinel.probe(eng)
    drifted = sorted(k for k, d in out["drift"].items() if d > config.tol)
    if sentinel.recoveries < 1 or "P4" not in drifted \
            or max(out["after"].values()) > config.tol \
            or out["local_rows"] != n // SHARD_WORLD:
        raise AssertionError(f"{label}: the sentinel did not find and heal "
                             f"the drift: {out}")
    wants = {}
    if rank == 0:
        ree = ReevalEngine(matrix_powers(k=16, n=n, model="exp"),
                           device=DEVICE)
        ree.initialize(inputs)
        for u, v in ups:
            ree.apply_update("A", u, v)
        wants = {"reeval": (ree.views, MAIN_TOL)}
    out["rel_err"] = shard_compare(label, eng, wants)
    return out, [counts]


def shard_rank(rank: int, world: int, store: str, results) -> None:
    """One of 21b's ranks, in a spawned process: join the gloo world
    through the file store ``store`` on ``cuda:(rank % device_count)``,
    run matrix powers and OLS on the ``("rows",)`` mesh, and put
    ``(rank, record)`` — or ``(rank, traceback)`` — on ``results``."""
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            t0 = time.perf_counter()
            mesh = DeviceMesh("cuda", torch.arange(world),
                              mesh_dim_names=("rows",))
            torch.cuda.reset_peak_memory_stats()
            rec = {"device": f"cuda:{torch.cuda.current_device()}",
                   "backend": dist.get_backend(mesh.get_group("rows"))}
            rec["counts"] = []
            for key, body in (("powers", shard_rank_powers),
                              ("ols", shard_rank_ols),
                              ("sentinel", shard_rank_sentinel)):
                rec[key], counts = body(rank, mesh)
                rec["counts"] += counts
                gc.collect()
                torch.cuda.empty_cache()
            rec["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                   / 2 ** 30)
            rec["seconds"] = time.perf_counter() - t0
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, rec))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, traceback.format_exc()))
        raise


def phase_shard_four_ranks() -> dict:
    """21b: SHARD_WORLD gloo ranks in spawned processes, all on this card
    (NCCL takes one rank a card), each running :func:`shard_rank`.  Every
    rank's launches must equal its applies and its replicated blocks
    rank 0's bit for bit; rank 0 holds the gathered views against the
    single-device engine and re-evaluation.  A rank that fails, or does
    not report within SHARD_TIMEOUT_S, fails the phase."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    label = f"shard_{SHARD_WORLD}_ranks_gloo_one_card"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    t_phase = time.perf_counter()
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=shard_rank,
                             args=(r, SHARD_WORLD, f"{tmp}/store", results))
                 for r in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + SHARD_TIMEOUT_S
            while len(recs) < SHARD_WORLD:
                rank, rec = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                if isinstance(rec, str):
                    raise AssertionError(f"{label}: rank {rank} failed:\n"
                                         f"{rec}")
                recs[rank] = rec
        except queue_mod.Empty:
            raise AssertionError(
                f"{label}: ranks {sorted(set(range(SHARD_WORLD)) - set(recs))}"
                f" did not report in {SHARD_TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{label}: rank exit codes {codes}")
    got, ranks = {}, {}
    for rank in sorted(recs):
        for counts in recs[rank].pop("counts"):
            merge_counts(got, counts)
            for K, count in counts["ranks"]["rank_update_batched"].items():
                ranks[K] = ranks.get(K, 0) + count
        for app in ("powers", "ols"):
            if not recs[rank][app]["replicated"]["bit_equal"]:
                raise AssertionError(f"{label}: rank {rank}'s replicated "
                                     f"{app} blocks differ from rank 0's")
    applies = sum(r[app]["lowrank_applies"] for r in recs.values()
                  for app in ("powers", "ols", "sentinel")) + sum(
        f["lowrank_applies"] for r in recs.values()
        for f in r["powers"]["planned_firings"])
    check_launches(label, got, {"rank_update_batched": applies})
    drifts = [[r["sentinel"][k] for k in ("drift", "second", "after")]
              for _, r in sorted(recs.items())]
    if any(d != drifts[0] for d in drifts):
        raise AssertionError(f"{label}: the ranks' sentinels read other "
                             f"drifts: {drifts}")
    rec = {"phase": label, "world": SHARD_WORLD,
           "note": "the ranks time-share one card: times are no scaling "
                   "figure",
           "launches": got, "dense_ranks": dict(sorted(ranks.items())),
           "lowrank_applies": applies, "ranks": recs,
           "seconds": time.perf_counter() - t_phase}
    log("main " + json.dumps(rec))
    return rec


def phase_shard() -> list:
    """21: the row-sharded engine (21a one NCCL rank, 21b four gloo ranks
    on one card, 21c the drift sentinel on them); its seconds and each
    rank's peak memory."""
    import torch
    t0 = time.perf_counter()
    one = phase_shard_one_rank()
    gc.collect()
    torch.cuda.empty_cache()
    four = phase_shard_four_ranks()
    for rank, r in sorted(four["ranks"].items()):
        for app in ("powers", "ols"):
            ms = [f["ms_per_update"] for f in r[app]["firings"]]
            log(f"shard rank {rank} ({r['device']}, {r['backend']}, "
                f"{SHARD_WORLD} ranks sharing one card) {app}: ms an "
                f"update {ms}, launches a firing "
                f"{[f['launches'] for f in r[app]['firings']]}, bytes a "
                f"firing {[f['bytes'] for f in r[app]['firings']]}")
        log(f"shard rank {rank} reeval matmul of two {POWERS_N}^2 views: "
            f"{r['powers']['reeval_matmul']}")
        log(f"shard rank {rank} 21c sentinel at n = {SHARD_SENTINEL_N}: "
            f"{json.dumps(r['sentinel'])}")
    peak = [round(r["peak_mem_gib"], 2) for _, r in sorted(
        four["ranks"].items())]
    log(f"phase 21: {time.perf_counter() - t0:.1f} s; peak GiB: one rank "
        f"{one['peak_mem_gib']:.2f}, four ranks {peak}")
    return [one, four]



# -- phase 22: the LM half of the sharded dist/ -------------------------------

def lm22_cfg(arch: str, n_layers: int, dtype: str, rehearse: bool):
    """``arch`` at its published widths (its reduced widths when
    rehearsing on the CPU), cut to ``n_layers``, in ``dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.reduced() if rehearse else cfg
    return dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype)


def lm22_tokens(cfg, batch: int, seq: int, seed: int):
    """The same global batch of tokens on every rank, from ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                         dtype=np.int64))


def lm22_gen(device, seed: int):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def lm22_grads(model, params, batch: dict, specs=None):
    """(loss of the global batch, gradients averaged over the data ranks)
    of the rank's local params (the whole params without a mesh), placed
    by ``specs`` (needed under the fsdp rule)."""
    import torch
    from repro_torch.train.optimizer import leaves, unflatten
    from repro_torch.train.train_step import data_rows, mean_over_data
    loss, _ = model.loss(params, data_rows(batch, model.device))
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), mean_over_data(unflatten(params, grads), specs)


def lm22_worst(got: dict, want) -> tuple:
    """(the largest relative error of any leaf, against its largest
    entry; that leaf) of a whole tree ``got`` ({name: tensor}) against
    ``want``."""
    worst, worst_leaf = 0.0, None
    for name, w in flat_params(want):
        rel = float((got[name] - w).abs().max()) / (
            float(w.abs().max()) or 1.0)
        if rel >= worst:
            worst, worst_leaf = rel, name
    return worst, worst_leaf


def lm22_layer(tree, i: int = 0):
    """Layer ``i``'s params of a stacked tree."""
    if isinstance(tree, dict):
        return {k: lm22_layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm22_sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def lm22_heads(cfg, params) -> dict:
    hd = cfg.resolved_head_dim
    attn = params["blocks"]["attn"]
    return {"q_heads": attn["wq"].shape[-1] // hd,
            "kv_heads": attn["wk"].shape[-1] // hd, "head_dim": hd}


class Lm22Counts:
    """A rank's main-path launches: each sharded drive resets the kernel
    counters just before it and reads them just after, with the launches
    its configuration predicts (``expect``); the single-device references
    between drives are never read."""

    def __init__(self, device):
        self.device = device
        self.counts, self.expect = [], {}

    def drive(self, fn, expect: dict):
        reset_launches()
        out = fn()
        lm22_sync(self.device)
        self.counts.append(kernel_counts())
        for entry, n in expect.items():
            self.expect[entry] = self.expect.get(entry, 0) + n
        return out


def lm22_train_launches(cfg, steps: int = 1) -> dict:
    """A train step's flash launches: the forward with LSE once a layer
    (twice under remat: the recompute) and K1 once."""
    fwd = 2 if cfg.remat != "none" else 1
    n = attention_layers(cfg) * steps
    return {"flash_attention_fwd_lse": fwd * n, "flash_attention_bwd": n}


def lm22_exact(rank: int, mesh, counts: Lm22Counts, rehearse: bool
               ) -> tuple:
    """22a: danube at full width cut to LM_SHARD_LAYERS, f32, on (2, 2):
    one step's loss and gathered gradients, on rank 0 against the
    single-device loss and gradients (phase 19b's tolerances).  Returns
    (record, rank 0's single-device (loss, gradients), which 22f holds
    its gradients against; None on the other ranks)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import (gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM
    from repro_torch.train import require_grad
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    b, s = LM_SHARD_REHEARSE["exact"] if rehearse else LM_SHARD_EXACT
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 71)}
    t0 = time.perf_counter()
    with use_sharding(mesh):
        specs = model.param_specs()
        params = require_grad(shard_tree(
            model.init(lm22_gen(model.device, 61)), specs))
        heads = lm22_heads(cfg, params)
        loss, grads = counts.drive(lambda: lm22_grads(model, params, batch),
                                   lm22_train_launches(cfg))
        whole = gather_tree(grads, specs)
    out = {"batch": b, "seq": s, **heads, "loss": float(loss),
           "sharded_s": time.perf_counter() - t0}
    del params, grads
    kept = None
    if rank == 0:
        single = require_grad(model.init(lm22_gen(model.device, 61)))
        want_loss, want = lm22_grads(model, single, batch)
        out["loss_single"] = float(want_loss)
        out["loss_rel_err"] = abs(float(loss) - float(want_loss)) / abs(
            float(want_loss))
        got = dict(flat_params(whole))
        worst, worst_leaf = lm22_worst(got, want)
        out.update(grad_leaves=len(got), grad_worst_rel_err=worst,
                   grad_worst_leaf=worst_leaf)
        if out["loss_rel_err"] > TRAIN_LOSS_RTOL or worst > MAIN_TOL:
            raise AssertionError(
                f"22a: sharded against single device: loss "
                f"{out['loss_rel_err']} (limit {TRAIN_LOSS_RTOL}), gradient "
                f"{worst_leaf} {worst} (limit {MAIN_TOL})")
        kept = (want_loss, want)
        del single
    del whole
    dist.barrier()
    return out, kept


def lm22_step(rank: int, mesh, counts: Lm22Counts, rehearse: bool):
    """22b: the same cut in bf16 on (2, 2): LM_SHARD_STEP's steps timed,
    the bytes of each, then on rank 0 the single-device step at the same
    global batch.  Returns (record, state, model, batch)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "bfloat16", rehearse)
    b, s, steps = LM_SHARD_REHEARSE["step"] if rehearse else LM_SHARD_STEP
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 72)}
    out = {"batch": b, "seq": s, "ms": [], "bytes": [], "loss": []}
    with sharding.use_sharding(mesh):
        base = lm22_peak_reset(model.device)
        state = init_train_state(model, lm22_gen(model.device, 62))
        out.update(lm22_heads(cfg, state.params))
        out["state_bytes"] = lm22_state_bytes(state)
        step = make_train_step(model)
        for _ in range(steps):
            sharding.reset_bytes()
            lm22_sync(model.device)
            t0 = time.perf_counter()
            state, metrics = counts.drive(lambda: step(state, batch),
                                          lm22_train_launches(cfg))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["bytes"].append(dict(sharding.BYTES))
            out["loss"].append(float(metrics["loss"]))
    out.update(lm22_peak(model.device, base))
    out["launches_a_step"] = lm22_train_launches(cfg)
    if rank == 0:
        single = init_train_state(model, lm22_gen(model.device, 62))
        one = make_train_step(model)
        out["single_ms"], out["single_loss"] = [], []
        for _ in range(steps):
            lm22_sync(model.device)
            t0 = time.perf_counter()
            single, metrics = one(single, batch)
            lm22_sync(model.device)
            out["single_ms"].append((time.perf_counter() - t0) * 1e3)
            out["single_loss"].append(float(metrics["loss"]))
        del single, one
        out["loss_worst_rel_err"] = max(
            abs(a - b) / abs(b)
            for a, b in zip(out["loss"], out["single_loss"]))
        out["loss_tol"] = LM_SHARD_BF16_LOSS_C / math.sqrt(b * s)
        if not out["loss_worst_rel_err"] <= out["loss_tol"]:
            raise AssertionError(
                f"22b: bf16 losses {out['loss']} on (2, 2) against the "
                f"single device's {out['single_loss']}: relative "
                f"{out['loss_worst_rel_err']:.3g} > {out['loss_tol']:.3g}")
    dist.barrier()
    return out, state, model, batch


def lm22_remesh(rank: int, mesh, state, model, batch, counts: Lm22Counts,
                directory: str) -> dict:
    """22d: 22b's state saved (gathered, rank 0 writes), restored onto
    plan_mesh's (1, 2) sub-mesh of the first two ranks (which hold the
    same model halves as on (2, 2), so their restored blocks must equal
    22b's bit for bit), and one step there."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import CheckpointManager, sharding
    from repro_torch.dist.fault_tolerance import plan_mesh
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_state_specs)
    mgr = CheckpointManager(directory, async_save=False)
    saved_step = int(state.opt.step)
    with sharding.use_sharding(mesh):
        lm22_sync(model.device)
        t0 = time.perf_counter()
        mgr.save(saved_step, state, blocking=True,
                 specs=train_state_specs(model))
        out = {"save_s": time.perf_counter() - t0,
               "plan": plan_mesh(2, 2)}
    sub = make_elastic_mesh(2, 2, device_type=mesh.device_type)
    out["mesh"] = [list(sub.shape), list(sub.mesh_dim_names)]
    if rank < 2:
        with sharding.use_sharding(sub):
            fresh = init_train_state(model, lm22_gen(model.device, 63))
            t0 = time.perf_counter()
            restored = mgr.restore(fresh, step=saved_step,
                                   specs=train_state_specs(model))
            out["restore_s"] = time.perf_counter() - t0
            del fresh
            diff = []
            for key in ("params", "master", "m", "v"):
                saved = (state.params if key == "params"
                         else getattr(state.opt, key))
                back = dict(flat_params(restored.params if key == "params"
                                        else getattr(restored.opt, key)))
                diff += [f"{key}.{name}" for name, x in flat_params(saved)
                         if not torch.equal(x, back[name])]
            out["leaves_differing"] = diff
            out["restored_step"] = mgr.last_restored_step
            if diff or int(restored.opt.step) != saved_step:
                raise AssertionError(f"22d: restored leaves differ from the "
                                     f"saved ones: {diff[:8]}")
            step = make_train_step(model)
            _, metrics = counts.drive(
                lambda: step(restored, batch),
                lm22_train_launches(model.cfg))
            out["loss"] = float(metrics["loss"])
            if not math.isfinite(out["loss"]):
                raise AssertionError(f"22d: loss {out['loss']} after the "
                                     "restore")
            del restored
    dist.barrier()
    return out


def lm22_peak_reset(device) -> int:
    """Reset the card's peak-memory counter (not on the CPU); the bytes
    allocated now, the baseline of :func:`lm22_peak`."""
    import torch
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def lm22_peak(device, base: int) -> dict:
    """The card's peak allocated GiB since :func:`lm22_peak_reset`, and the
    baseline it started from (nothing on the CPU)."""
    import torch
    if device.type != "cuda":
        return {}
    torch.cuda.synchronize()
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "base_gib": base / 2 ** 30}


def lm22_state_bytes(state) -> dict:
    """The bytes a rank holds of a train state: its params' blocks and its
    master weights and moments (f32)."""
    from repro_torch.train.optimizer import leaves

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in leaves(tree))

    return {"params": nbytes(state.params),
            "master_m_v": sum(nbytes(getattr(state.opt, k))
                              for k in ("master", "m", "v"))}


def lm22_fsdp_grads(rank: int, meshes: dict, counts: Lm22Counts,
                    rehearse: bool, single) -> dict:
    """22f's f32 part: 22a's gradients under ``{"fsdp": "data"}`` on (2, 2)
    and (4, 1), gathered whole, on rank 0 against 22a's single device
    (``single``: its loss and gradients) at 22a's tolerances."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import (gather_tree, shard_tree,
                                           use_sharding)
    from repro_torch.models import LM
    from repro_torch.train import require_grad
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    b, s = LM_SHARD_REHEARSE["exact"] if rehearse else LM_SHARD_EXACT
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 71)}
    out = {}
    for key, mesh in meshes.items():
        t0 = time.perf_counter()
        with use_sharding(mesh, LM_SHARD_FSDP_RULES):
            specs = model.param_specs()
            params = require_grad(shard_tree(
                model.init(lm22_gen(model.device, 61)), specs))
            rec = {"mesh": key, **lm22_heads(cfg, params),
                   "d_model_a_rank": params["blocks"]["attn"]["wq"].shape[1]}
            loss, grads = counts.drive(
                lambda: lm22_grads(model, params, batch, specs),
                lm22_train_launches(cfg))
            whole = gather_tree(grads, specs)
        rec.update(loss=float(loss), seconds=time.perf_counter() - t0)
        if rank == 0:
            want_loss, want = single
            rec["loss_rel_err"] = abs(float(loss) - float(want_loss)) / abs(
                float(want_loss))
            worst, leaf = lm22_worst(dict(flat_params(whole)), want)
            rec.update(grad_worst_rel_err=worst, grad_worst_leaf=leaf)
            if rec["loss_rel_err"] > TRAIN_LOSS_RTOL or worst > MAIN_TOL:
                raise AssertionError(
                    f"22f {key}: fsdp against single device: loss "
                    f"{rec['loss_rel_err']} (limit {TRAIN_LOSS_RTOL}), "
                    f"gradient {leaf} {worst} (limit {MAIN_TOL})")
        del params, grads, whole
        gc.collect()
        dist.barrier()
        out[key] = rec
    return out


def lm22_fsdp_clip(rank: int, mesh, counts: Lm22Counts,
                   rehearse: bool) -> dict:
    """22f's clipped step: the f32 cut under ``{"fsdp": "data"}`` on
    (4, 1), one step clipped to LM_SHARD_FSDP_CLIP at LM_SHARD_FSDP_LR; on
    rank 0 its global norm and each leaf's update (the params after the
    step less before) against the single device's, the update within
    MAIN_TOL of its largest entry."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import gather_tree, use_sharding
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    b, s = LM_SHARD_REHEARSE["exact"] if rehearse else LM_SHARD_EXACT
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 71)}

    def stepper():
        return make_train_step(model, lr=LM_SHARD_FSDP_LR, warmup=1,
                               grad_clip=LM_SHARD_FSDP_CLIP)

    with use_sharding(mesh, LM_SHARD_FSDP_RULES):
        specs = model.param_specs()
        state = init_train_state(model, lm22_gen(model.device, 61))
        state, metrics = counts.drive(lambda: stepper()(state, batch),
                                      lm22_train_launches(cfg))
        whole = gather_tree(state.params, specs)
    out = {"clip": LM_SHARD_FSDP_CLIP, "lr": LM_SHARD_FSDP_LR,
           "grad_norm": float(metrics["grad_norm"]),
           "loss": float(metrics["loss"])}
    del state
    if rank == 0:
        single = init_train_state(model, lm22_gen(model.device, 61))
        before = {k: v.detach().clone() for k, v in
                  flat_params(single.params)}
        single, want = stepper()(single, batch)
        out["grad_norm_single"] = float(want["grad_norm"])
        out["grad_norm_rel_err"] = abs(out["grad_norm"] - float(
            want["grad_norm"])) / float(want["grad_norm"])
        got = {k: v - before[k] for k, v in flat_params(whole)}
        delta = {k: v.detach() - before[k] for k, v in
                 flat_params(single.params)}
        out["update_worst_rel_err"], out["update_worst_leaf"] = lm22_worst(
            got, delta)
        if out["grad_norm"] <= 10 * LM_SHARD_FSDP_CLIP \
                or out["grad_norm_rel_err"] > TRAIN_LOSS_RTOL \
                or out["update_worst_rel_err"] > MAIN_TOL:
            raise AssertionError(f"22f: the clipped step on (4, 1) against "
                                 f"the single device: {out}")
        del single, before, got, delta
    del whole
    gc.collect()
    dist.barrier()
    return out


def lm22_fsdp_steps(rank: int, meshes: dict, counts: Lm22Counts,
                    rehearse: bool, single_loss) -> tuple:
    """22f's bf16 part: 22b's first LM_SHARD_FSDP_STEPS steps under
    ``{"fsdp": "data"}`` on (2, 2) and (4, 1), each timed with its bytes,
    the state's bytes a rank and the card's peak; on rank 0 the losses
    against 22b's single device (``single_loss``) within 22b's limit.
    Returns (records, the (2, 2) state, the model)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "bfloat16", rehearse)
    b, s, _ = LM_SHARD_REHEARSE["step"] if rehearse else LM_SHARD_STEP
    steps = LM_SHARD_FSDP_STEPS
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 72)}
    out, kept = {}, None
    for key, mesh in meshes.items():
        rec = {"mesh": key, "batch": b, "seq": s, "ms": [], "bytes": [],
               "loss": []}
        with sharding.use_sharding(mesh, LM_SHARD_FSDP_RULES):
            base = lm22_peak_reset(model.device)
            state = init_train_state(model, lm22_gen(model.device, 62))
            rec["state_bytes"] = lm22_state_bytes(state)
            step = make_train_step(model)
            for _ in range(steps):
                sharding.reset_bytes()
                lm22_sync(model.device)
                t0 = time.perf_counter()
                state, metrics = counts.drive(lambda: step(state, batch),
                                              lm22_train_launches(cfg))
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["bytes"].append(dict(sharding.BYTES))
                rec["loss"].append(float(metrics["loss"]))
        rec.update(lm22_peak(model.device, base))
        if rank == 0:
            rec["loss_worst_rel_err"] = max(
                abs(x - y) / abs(y) for x, y in zip(rec["loss"], single_loss))
            rec["loss_tol"] = LM_SHARD_BF16_LOSS_C / math.sqrt(b * s)
            if not rec["loss_worst_rel_err"] <= rec["loss_tol"]:
                raise AssertionError(
                    f"22f {key}: bf16 losses {rec['loss']} under fsdp "
                    f"against the single device's {single_loss}: relative "
                    f"{rec['loss_worst_rel_err']:.3g} > {rec['loss_tol']:.3g}")
        if key == "22":
            kept = state
        del state
        gc.collect()
        dist.barrier()
        out[key] = rec
    return out, kept, model


def lm22_fsdp_ckpt(rank: int, mesh, state, model, directory: str) -> dict:
    """22f's checkpoint: the params of the (2, 2) fsdp state (the
    optimizer state's restore across the rule is the CPU tests'; here a
    full state would take 39 s) saved (gathered, rank 0 writes), restored
    onto (2, 2) under the default rules; each rank's restored blocks cut
    over the data axis as the rule cuts them must be its fsdp blocks, bit
    for bit (the rest of a block is another data rank's, which holds
    it)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import CheckpointManager, sharding
    mgr = CheckpointManager(directory, async_save=False)
    saved_step = int(state.opt.step)
    with sharding.use_sharding(mesh, LM_SHARD_FSDP_RULES) as ctx:
        plan = model._fsdp_plan()
        lm22_sync(model.device)
        t0 = time.perf_counter()
        mgr.save(saved_step, state.params, blocking=True,
                 specs=model.param_specs())
        out = {"save_s": time.perf_counter() - t0}
        coord = ctx.coord(ctx.fsdp_axes)
    with sharding.use_sharding(mesh):
        fresh = sharding.shard_tree(model.init(lm22_gen(model.device, 63)),
                                    model.param_specs())
        t0 = time.perf_counter()
        restored = mgr.restore(fresh, step=saved_step,
                               specs=model.param_specs())
        out["restore_s"] = time.perf_counter() - t0
        del fresh
    where = dict(flat_params(plan))
    back = dict(flat_params(restored))
    diff = []
    for name, x in flat_params(state.params):
        y = back[name]
        if where[name] is not None:
            dim = where[name][0] % y.dim()
            y = y.narrow(dim, coord * x.shape[dim], x.shape[dim])
        if not torch.equal(x, y):
            diff.append(name)
    out.update(leaves_differing=diff, restored_step=mgr.last_restored_step,
               default_wq=list(restored["blocks"]["attn"]["wq"].shape),
               fsdp_wq=list(state.params["blocks"]["attn"]["wq"].shape))
    if diff or mgr.last_restored_step != saved_step:
        raise AssertionError(f"22f: the fsdp checkpoint restored without "
                             f"the rule differs: {diff[:8]}")
    del restored
    gc.collect()
    dist.barrier()
    return out


def lm22_fsdp_decode(rank: int, mesh, counts: Lm22Counts,
                     rehearse: bool) -> dict:
    """22f's decode: the f32 cut under ``{"fsdp": "data"}`` on (2, 2),
    LM_SHARD_FSDP_DECODE's prompt positions fed a step at a time, then
    greedy steps (each block gathered a step); on rank 0 every step's
    logits within the serving bound of the single device's, greedy tokens
    equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM
    from repro_torch.train.train_step import data_rows
    b, prompt_len, steps = LM_SHARD_FSDP_DECODE
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    model = LM(cfg, device=counts.device)
    prompt = lm22_tokens(cfg, b, prompt_len, 76).to(model.device)
    out = {"batch": b, "prompt": prompt_len, "steps": steps}
    with torch.no_grad(), use_sharding(mesh, LM_SHARD_FSDP_RULES):
        ctx = current_ctx()
        params = shard_tree(model.init(lm22_gen(model.device, 77)),
                            model.param_specs())
        cache = shard_tree(model.init_cache(b, steps),
                           model.cache_specs(b, steps))
        lm22_sync(model.device)
        t0 = time.perf_counter()
        logits, toks = counts.drive(
            lambda: recur24_decode_run(
                model, params, cache, prompt, steps,
                lambda t: data_rows({"t": t}, model.device)["t"],
                lambda x: gather(gather(x, -1, MODEL), 0, ctx.batch_axes)),
            {"flash_decode": attention_layers(cfg) * steps})
        lm22_sync(model.device)
        out["ms_a_step"] = (time.perf_counter() - t0) * 1e3 / steps
    del params, cache
    if rank == 0:
        with torch.no_grad():
            whole = model.init(lm22_gen(model.device, 77))
            want, want_toks = recur24_decode_run(
                model, whole, model.init_cache(b, steps), prompt, steps,
                lambda t: t, lambda x: x)
        diff = (logits - want).abs()
        out["max_abs_err"] = float(diff.max())
        out["excess"] = float((diff - SERVE_RTOL * want.abs()).max())
        out["greedy_equal"] = bool(torch.equal(toks, want_toks))
        if not torch.isfinite(logits).all() or out["excess"] > SERVE_ATOL \
                or not out["greedy_equal"]:
            raise AssertionError(
                f"22f: decode under fsdp on (2, 2) against the single "
                f"device: max |diff| {out['max_abs_err']}, greedy equal "
                f"{out['greedy_equal']}")
        del whole, want
    gc.collect()
    dist.barrier()
    return out


def lm22_fsdp(rank: int, mesh22, mesh41, counts: Lm22Counts,
              rehearse: bool, single, single_loss, directory: str) -> dict:
    """22f: the fsdp rule on (2, 2) and (4, 1); each part's seconds."""
    meshes = {"22": mesh22, "41": mesh41}
    out, parts = {}, {}
    t0 = time.perf_counter()
    out["grads"] = lm22_fsdp_grads(rank, meshes, counts, rehearse, single)
    parts["grads"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["clip"] = lm22_fsdp_clip(rank, mesh41, counts, rehearse)
    parts["clip"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["steps"], state, model = lm22_fsdp_steps(rank, meshes, counts,
                                                 rehearse, single_loss)
    parts["steps"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["ckpt"] = lm22_fsdp_ckpt(rank, mesh22, state, model, directory)
    parts["ckpt"] = time.perf_counter() - t1
    del state
    gc.collect()
    t1 = time.perf_counter()
    out["decode"] = lm22_fsdp_decode(rank, mesh22, counts, rehearse)
    parts["decode"] = time.perf_counter() - t1
    out["part_s"] = parts
    out["seconds"] = time.perf_counter() - t0
    return out


def lm22_decode_run(model, mesh, rules, tokens, max_seq: int, prompt: int,
                    seed: int, greedy: bool):
    """A batched prefill of ``prompt`` positions of ``tokens`` and one
    decode step a position after it up to ``tokens``' last, on ``mesh``
    under ``rules`` (each rank its blocks of the params and of the cache
    placed by ``LM.cache_specs``), or on one device without a mesh;
    ``greedy`` feeds each step the last step's argmax, else the next of
    ``tokens``.  Returns (the prefill's last logits and each step's,
    gathered whole, (steps + 1, B, V); the greedy tokens (B, steps + 1);
    the ms of each decode step; one step's collective bytes, read before
    the logits' gathers; the cache block's shape)."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.train.train_step import data_rows
    placed = (sharding.use_sharding(mesh, rules) if mesh is not None
              else contextlib.nullcontext())
    with torch.no_grad(), placed:
        ctx = sharding.current_ctx()
        params = model.init(lm22_gen(model.device, seed))
        specs = None
        if mesh is not None:
            params = sharding.shard_tree(params, model.param_specs())
            specs = model.cache_specs(tokens.shape[0], max_seq)

        def rows(t):
            return data_rows({"t": t}, model.device)["t"] if specs else t

        def whole(x):
            if specs is None:
                return x
            if x.shape[-1] != model.cfg.vocab:
                x = sharding.gather(x, -1, sharding.MODEL)
            return sharding.gather(x, 0, ctx.batch_axes)

        logits, cache = model.prefill(
            params, {"tokens": rows(tokens[:, :prompt])}, max_seq,
            specs=specs)
        out = [whole(logits[:, -1])]
        toks = [out[-1].argmax(-1)]
        ms, step_bytes = [], None
        for i in range(prompt, tokens.shape[1]):
            nxt = toks[-1][:, None] if greedy else tokens[:, i:i + 1]
            sharding.reset_bytes()
            lm22_sync(model.device)
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, rows(nxt), i,
                                              specs)
            if step_bytes is None:
                step_bytes = dict(sharding.BYTES)
            out.append(whole(logits[:, 0]))
            lm22_sync(model.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(out[-1].argmax(-1))
        shape = tuple(cache["kv"]["k"].shape)
    return torch.stack(out), torch.stack(toks, dim=1), ms, step_bytes, shape


def lm22_cache_seq(rank: int, mesh, counts: Lm22Counts,
                   rehearse: bool) -> dict:
    """22g: danube at full width cut to LM_SHARD_LAYERS under
    ``{"cache_seq": "model"}`` on (1, 4).  f32 (LM_SHARD_CSEQ_F32, the
    same tokens fed each step): on rank 0 every step's logits against
    the single device's.  bf16 (LM_SHARD_CSEQ_BF16, the same tokens fed
    each step): the logits against the same mesh's under the default
    rules and, on rank 0, the single device's (:func:`lm22_bf16_agreement`),
    the ms a step of both mesh runs, one step's bytes (checked against
    the meta walk by the phase)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import LM
    out = {}
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    b, max_seq, prompt, last = (LM_SHARD_REHEARSE["cseq_f32"] if rehearse
                                else LM_SHARD_CSEQ_F32)
    model = LM(cfg, device=counts.device)
    tokens = lm22_tokens(cfg, b, last, 78).to(model.device)
    steps = last - prompt
    layers_ = attention_layers(cfg)
    expect = {"flash_attention": layers_,
              "flash_decode_lse": layers_ * steps}
    logits, _, ms, _, shape = counts.drive(
        lambda: lm22_decode_run(model, mesh, LM_SHARD_CSEQ_RULES, tokens,
                                max_seq, prompt, 79, greedy=False), expect)
    f32 = {"batch": b, "max_seq": max_seq, "prompt": prompt, "steps": steps,
           "cache_block": list(shape), "ms_a_step": ms}
    if rank == 0:
        want = lm22_decode_run(model, None, None, tokens, max_seq, prompt,
                               79, greedy=False)[0]
        diff = float((logits - want).abs().max())
        f32["max_abs_err"] = diff
        f32["limit"] = LM_SHARD_CSEQ_TOL * max(float(want.abs().max()), 1.0)
        if not torch.isfinite(logits).all() or diff > f32["limit"]:
            raise AssertionError(f"22g: f32 decode under cache_seq against "
                                 f"the single device: {f32}")
        del want
    out["f32"] = f32
    del logits
    gc.collect()
    dist.barrier()
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "bfloat16", rehearse)
    b, max_seq, prompt, last = (LM_SHARD_REHEARSE["cseq_bf16"] if rehearse
                                else LM_SHARD_CSEQ_BF16)
    model = LM(cfg, device=counts.device)
    tokens = lm22_tokens(cfg, b, last, 80).to(model.device)
    steps = last - prompt
    runs = {}
    for key, rules, entry in (("cache_seq", LM_SHARD_CSEQ_RULES,
                               "flash_decode_lse"),
                              ("default", None, "flash_decode")):
        logits, toks, ms, nbytes, shape = counts.drive(
            lambda: lm22_decode_run(model, mesh, rules, tokens, max_seq,
                                    prompt, 81, greedy=False),
            {"flash_attention": layers_, entry: layers_ * steps})
        if not torch.isfinite(logits).all():
            raise AssertionError(f"22g: bf16 {key} logits are not finite")
        runs[key] = {"logits": logits, "toks": toks, "ms": ms,
                     "bytes": nbytes, "cache_block": list(shape)}
    if rank == 0:
        logits, toks = lm22_decode_run(model, None, None, tokens, max_seq,
                                       prompt, 81, greedy=False)[:2]
        runs["single"] = {"logits": logits, "toks": toks}
    bf16 = {"batch": b, "max_seq": max_seq, "prompt": prompt,
            "steps": steps,
            **{f"{k}_{f}": runs[k][f] for k in ("cache_seq", "default")
               for f in ("ms", "cache_block")},
            "bytes": runs["cache_seq"]["bytes"],
            "default_bytes": runs["default"]["bytes"]}
    got = runs["cache_seq"]
    for key in ("default", "single"):
        if key not in runs:
            continue
        bf16[key] = lm22_bf16_agreement(got["logits"], got["toks"],
                                        runs[key]["logits"],
                                        runs[key]["toks"])
        if bf16[key]["excess"] > 0:
            raise AssertionError(f"22g: bf16 logits under cache_seq against "
                                 f"the {key}'s: {bf16[key]}")
    out["bf16"] = bf16
    del runs, got
    gc.collect()
    dist.barrier()
    return out


def lm22_bf16_agreement(logits, toks, want, want_toks) -> dict:
    """bf16 decode logits (steps, B, V) against ``want``'s, fed the same
    tokens: the largest difference, its excess over
    LM_SHARD_CSEQ_BF16_TOL of the largest logit (at least 1), and the
    greedy tokens (each step's argmax) that agree, with the largest
    top-two margin of ``want`` where they do not (a flip needs a margin
    within twice the difference)."""
    diff = float((logits - want).abs().max())
    limit = LM_SHARD_CSEQ_BF16_TOL * max(float(want.abs().max()), 1.0)
    same = toks == want_toks
    top2 = want.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).T          # (B, steps + 1)
    return {"max_abs_err": diff, "limit": limit, "excess": diff - limit,
            "greedy_equal": int(same.sum()), "greedy_of": same.numel(),
            "flip_margin_max": float(margin[~same].max()) if (~same).any()
            else 0.0,
            "margin_min": float(margin.min())}


def lm22_seq_sp(rank: int, mesh, counts: Lm22Counts, rehearse: bool,
                single, single_loss) -> dict:
    """22h: 22a's f32 gradients under ``{"seq_sp": "model"}`` on (2, 2),
    on rank 0 against 22a's single device (``single``: its loss and
    gradients; LM_SHARD_SEQ_GRAD_TOL of each leaf's largest entry,
    LM_SHARD_SEQ_LOSS_TOL on the loss); then 22b's first
    LM_SHARD_FSDP_STEPS bf16 steps under the rule, each timed with its
    bytes and the peak, their losses against 22b's single device's
    (``single_loss``)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import gather_tree, shard_tree
    from repro_torch.models import LM
    from repro_torch.train import (init_train_state, make_train_step,
                                   require_grad)
    out = {}
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "float32", rehearse)
    b, s = LM_SHARD_REHEARSE["exact"] if rehearse else LM_SHARD_EXACT
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 71)}
    t0 = time.perf_counter()
    with sharding.use_sharding(mesh, LM_SHARD_SEQ_RULES):
        specs = model.param_specs()
        params = require_grad(shard_tree(
            model.init(lm22_gen(model.device, 61)), specs))
        loss, grads = counts.drive(lambda: lm22_grads(model, params, batch),
                                   lm22_train_launches(cfg))
        whole = gather_tree(grads, specs)
    grad = {"batch": b, "seq": s, "loss": float(loss),
            "seconds": time.perf_counter() - t0}
    if rank == 0:
        want_loss, want = single
        grad["loss_rel_err"] = abs(float(loss) - float(want_loss)) / abs(
            float(want_loss))
        grad["grad_worst_rel_err"], grad["grad_worst_leaf"] = lm22_worst(
            dict(flat_params(whole)), want)
        if grad["loss_rel_err"] > LM_SHARD_SEQ_LOSS_TOL \
                or grad["grad_worst_rel_err"] > LM_SHARD_SEQ_GRAD_TOL:
            raise AssertionError(f"22h: seq_sp against the single device: "
                                 f"{grad}")
    out["grads"] = grad
    del params, grads, whole
    gc.collect()
    dist.barrier()
    cfg = lm22_cfg(SERVE_ARCH, LM_SHARD_LAYERS, "bfloat16", rehearse)
    b, s, _ = LM_SHARD_REHEARSE["step"] if rehearse else LM_SHARD_STEP
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 72)}
    rec = {"batch": b, "seq": s, "ms": [], "bytes": [], "loss": []}
    with sharding.use_sharding(mesh, LM_SHARD_SEQ_RULES):
        base = lm22_peak_reset(model.device)
        state = init_train_state(model, lm22_gen(model.device, 62))
        step = make_train_step(model)
        for _ in range(LM_SHARD_FSDP_STEPS):
            sharding.reset_bytes()
            lm22_sync(model.device)
            t0 = time.perf_counter()
            state, metrics = counts.drive(lambda: step(state, batch),
                                          lm22_train_launches(cfg))
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["bytes"].append(dict(sharding.BYTES))
            rec["loss"].append(float(metrics["loss"]))
    rec.update(lm22_peak(model.device, base))
    if rank == 0:
        rec["loss_worst_rel_err"] = max(
            abs(x - y) / abs(y) for x, y in zip(rec["loss"], single_loss))
        # rehearsed at 4 x 32 tokens, 22b's limit (its bf16 noise scales as
        # 1 / sqrt(B S))
        rec["loss_tol"] = (LM_SHARD_BF16_LOSS_C / math.sqrt(b * s)
                           if rehearse else LM_SHARD_SEQ_BF16_TOL)
        if not rec["loss_worst_rel_err"] <= rec["loss_tol"]:
            raise AssertionError(f"22h: bf16 losses {rec['loss']} under "
                                 f"seq_sp against the single device's "
                                 f"{single_loss}")
    out["steps"] = rec
    del state
    gc.collect()
    dist.barrier()
    return out


def lm22_moe(rank: int, mesh, counts: Lm22Counts, rehearse: bool) -> dict:
    """22c: qwen3-moe at full width cut to 1 layer, f32, forward on
    (1, 4): each rank draws the whole params in turn (one whole model on
    the card at a time) and keeps its blocks; on rank 0 the MoE block,
    given the same input, against the single device at 2e-4, and the
    logits at the reference test's 5e-3, with the tokens whose top-k
    experts differ counted."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.models import LM, moe
    from repro_torch.train.train_step import data_rows
    cfg = lm22_cfg(QWEN3_ARCH, 1, "float32", rehearse)
    b, s = LM_SHARD_REHEARSE["moe"] if rehearse else LM_SHARD_MOE
    model = LM(cfg, device=counts.device)
    batch = {"tokens": lm22_tokens(cfg, b, s, 73)}
    gen = torch.Generator().manual_seed(74)
    x = torch.randn(b, s, cfg.d_model, generator=gen).to(model.device)
    routes = []
    route = moe._route

    def recording(*args):
        top_p, top_e, probs = route(*args)
        routes.append(top_e)
        return top_p, top_e, probs

    out = {"batch": b, "seq": s}
    whole0 = None
    with sharding.use_sharding(mesh) as ctx:
        specs = model.param_specs()
        for r in range(dist.get_world_size()):
            if rank == r:
                whole = model.init(lm22_gen(model.device, 64))
                params = sharding.shard_tree(whole, specs)
                if rank == 0:
                    whole0 = whole
                del whole
                gc.collect()
                if model.device.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        out.update(lm22_heads(cfg, params))
        out["experts_a_rank"] = params["blocks"]["moe"]["w_in"].shape[1]
        moe._route = recording
        try:
            with torch.no_grad():
                logits, _ = counts.drive(
                    lambda: model.forward(params, data_rows(batch,
                                                            model.device)),
                    {"flash_attention": attention_layers(cfg)})
                block = moe.moe_block(lm22_layer(params["blocks"]["moe"]),
                                      cfg, x)
                logits = sharding.gather(logits, -1, sharding.MODEL, ctx)
        finally:
            moe._route = route
    sharded_routes = routes[:1]
    # every rank frees its blocks and cached buffers before rank 0's
    # reference runs the whole layer (its 128 experts' dense-safe slot
    # buffers alone take 8 GiB a product)
    del params
    gc.collect()
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        routes.clear()
        moe._route = recording
        try:
            with torch.no_grad():
                want, _ = model.forward(whole0, batch)
                want_block = moe.moe_block(
                    lm22_layer(whole0["blocks"]["moe"]), cfg, x)
        finally:
            moe._route = route
        got_e = sharded_routes[0].sort(dim=-1).values
        want_e = routes[0].sort(dim=-1).values
        out["tokens_topk_differ"] = int((got_e != want_e).any(
            dim=-1).sum())
        out["tokens"] = int(got_e.shape[0])
        out["block_rel_err"] = float((block - want_block).abs().max()) / max(
            float(want_block.abs().max()), 1.0)
        out["logits_rel_err"] = float((logits - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        if out["block_rel_err"] > KERNEL_RTOL \
                or out["logits_rel_err"] > LM_SHARD_LOGIT_TOL:
            raise AssertionError(
                f"22c: block {out['block_rel_err']} (limit {KERNEL_RTOL}), "
                f"logits {out['logits_rel_err']} (limit "
                f"{LM_SHARD_LOGIT_TOL}) against the single device")
        del whole0, want, want_block
    del logits, block
    gc.collect()
    dist.barrier()
    return out


def lm22_driver(rank: int, world: int, directory: str, counts: Lm22Counts,
                rehearse: bool) -> dict:
    """22e: ``launch/train.py --mesh local --model-parallel 2`` on the four
    ranks for LM_SHARD_DRIVER_STEPS steps, through a file store of its
    own; rank 0's history."""
    from repro_torch.launch import train as train_mod
    steps = LM_SHARD_DRIVER_STEPS
    args = ["--arch", "custom-10m", "--steps", str(steps), "--batch", "8",
            "--seq", "128", "--log-every", "1", "--mesh", "local",
            "--model-parallel", "2",
            "--init-method", f"file://{directory}/driver_store",
            "--world-size", str(world), "--rank", str(rank),
            "--out", f"{directory}/driver.json"]
    if rehearse:
        args += ["--device", "cpu"]
    cfg = train_mod.custom_10m()
    t0 = time.perf_counter()
    counts.drive(lambda: train_mod.main(args),
                 lm22_train_launches(cfg, steps))
    out = {"seconds": time.perf_counter() - t0}
    if rank == 0:
        with open(f"{directory}/driver.json") as f:
            out["history"] = json.load(f)["history"]
        if len(out["history"]) != steps or not all(
                math.isfinite(h["loss"]) for h in out["history"]):
            raise AssertionError(f"22e: history {out['history']}")
    return out


def gloo_rank_join(rank: int, world: int, store: str, rehearse: bool):
    """A spawned rank of phases 22 and 24: the port on the path, the rank
    on ``cuda:(rank % device_count)`` (the CPU when rehearsing), joined
    to the gloo world through the file store ``store``; returns (device,
    counts, the (2, 2) mesh, the (1, 4) mesh) over the world."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cpu" if rehearse else "cuda"
    if rehearse:
        torch.set_num_threads(2)
        device = torch.device("cpu")
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device_type, torch.cuda.current_device())
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    grid = torch.arange(world)
    return (device, Lm22Counts(device),
            DeviceMesh(device_type, grid.reshape(2, 2),
                       mesh_dim_names=("data", "model")),
            DeviceMesh(device_type, grid.reshape(1, 4),
                       mesh_dim_names=("data", "model")))


def gloo_ranks(label: str, target, rehearse: bool) -> tuple:
    """LM_SHARD_WORLD spawned processes, each running ``target(rank,
    world, store, results, directory, rehearse)`` in a gloo world of its
    own file store: (records by rank, the launches their main-path drives
    counted).  Every rank's launches must equal what its drives expect
    (not checked when rehearsing).  A rank that fails, or does not report
    within LM_SHARD_TIMEOUT_S, fails the phase."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, LM_SHARD_WORLD, f"{tmp}/store",
                                   results, tmp, rehearse))
                 for r in range(LM_SHARD_WORLD)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + LM_SHARD_TIMEOUT_S
            while len(recs) < LM_SHARD_WORLD:
                rank, rec = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                if isinstance(rec, str):
                    raise AssertionError(f"{label}: rank {rank} failed:\n"
                                         f"{rec}")
                recs[rank] = rec
        except queue_mod.Empty:
            raise AssertionError(
                f"{label}: ranks "
                f"{sorted(set(range(LM_SHARD_WORLD)) - set(recs))} did not "
                f"report in {LM_SHARD_TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{label}: rank exit codes {codes}")
    got, expect = {}, {}
    for rank in sorted(recs):
        for counts in recs[rank].pop("counts"):
            merge_counts(got, counts)
        for entry, n in recs[rank].pop("expect").items():
            expect[entry] = expect.get(entry, 0) + n
    if not rehearse:
        check_launches(label, got, expect)
    return recs, got


def lm_shard_rank(rank: int, world: int, store: str, results,
                  directory: str, rehearse: bool = False) -> None:
    """One of phase 22's ranks, in a spawned process: join the gloo world
    through the file store ``store`` on ``cuda:(rank % device_count)``
    (the CPU when rehearsing), build the (2, 2), (1, 4) and (4, 1)
    meshes, run 22a, 22b, 22d, 22f, 22h, 22g and 22c on them, leave the
    group, run 22e, and put ``(rank, record)`` — or ``(rank, traceback)``
    — on ``results``."""
    try:
        device, counts, mesh22, mesh14 = gloo_rank_join(rank, world, store,
                                                        rehearse)
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        mesh41 = DeviceMesh(mesh22.device_type,
                            torch.arange(world).reshape(4, 1),
                            mesh_dim_names=("data", "model"))
        rec = {"device": str(device)}
        t0 = time.perf_counter()
        try:
            if not rehearse:
                torch.cuda.reset_peak_memory_stats()
            parts = {}
            t1 = time.perf_counter()
            rec["22a"], single = lm22_exact(rank, mesh22, counts, rehearse)
            parts["22a"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22a ({parts['22a']:.1f} s): "
                    f"{json.dumps(rec['22a'])}")
            t1 = time.perf_counter()
            rec["22b"], state, model, batch = lm22_step(rank, mesh22, counts,
                                                        rehearse)
            parts["22b"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22b ({parts['22b']:.1f} s): "
                    f"{json.dumps(rec['22b'])}")
            t1 = time.perf_counter()
            rec["22d"] = lm22_remesh(rank, mesh22, state, model, batch,
                                     counts, f"{directory}/ckpt")
            parts["22d"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22d ({parts['22d']:.1f} s): "
                    f"{json.dumps(rec['22d'])}")
            del state, model
            gc.collect()
            if not rehearse:
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec["22f"] = lm22_fsdp(rank, mesh22, mesh41, counts, rehearse,
                                   single, rec["22b"].get("single_loss"),
                                   f"{directory}/fsdp_ckpt")
            parts["22f"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22f ({parts['22f']:.1f} s): "
                    f"{json.dumps(rec['22f'])}")
            gc.collect()
            if not rehearse:
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec["22h"] = lm22_seq_sp(rank, mesh22, counts, rehearse, single,
                                     rec["22b"].get("single_loss"))
            parts["22h"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22h ({parts['22h']:.1f} s): "
                    f"{json.dumps(rec['22h'])}")
            del single
            gc.collect()
            if not rehearse:
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec["22g"] = lm22_cache_seq(rank, mesh14, counts, rehearse)
            parts["22g"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22g ({parts['22g']:.1f} s): "
                    f"{json.dumps(rec['22g'])}")
            gc.collect()
            if not rehearse:
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec["22c"] = lm22_moe(rank, mesh14, counts, rehearse)
            parts["22c"] = time.perf_counter() - t1
            if rank == 0:
                log(f"lm shard rank 0 22c ({parts['22c']:.1f} s): "
                    f"{json.dumps(rec['22c'])}")
            if not rehearse:
                rec["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        t1 = time.perf_counter()
        rec["22e"] = lm22_driver(rank, world, directory, counts, rehearse)
        parts["22e"] = time.perf_counter() - t1
        if rank == 0:
            log(f"lm shard rank 0 22e ({parts['22e']:.1f} s): "
                f"{json.dumps(rec['22e'])}")
        rec["part_s"] = parts
        rec["seconds"] = time.perf_counter() - t0
        rec["counts"], rec["expect"] = counts.counts, counts.expect
        results.put((rank, rec))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, traceback.format_exc()))
        raise


def lm22_fsdp_bytes_start(rehearse: bool) -> dict:
    """The bytes of 22f's, 22h's and 22g's drives predicted on meta:
    ``tools/torch_shard_bytes.py`` on 22b's step under
    LM_SHARD_FSDP_RULES on (2, 2) and (4, 1) and under LM_SHARD_SEQ_RULES
    on (2, 2), and on one decode step of 22g's bf16 decode under
    LM_SHARD_CSEQ_RULES on (1, 4), each in a process of its own on the
    CPU (no card), started together."""
    b, s, _ = LM_SHARD_REHEARSE["step"] if rehearse else LM_SHARD_STEP
    db, dseq, dpos, _ = (LM_SHARD_REHEARSE["cseq_bf16"] if rehearse
                         else LM_SHARD_CSEQ_BF16)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    tool = Path(__file__).resolve().parent / "tools" / "torch_shard_bytes.py"
    cells = {"22f_22": ("2,2", LM_SHARD_FSDP_RULES, b, s, []),
             "22f_41": ("4,1", LM_SHARD_FSDP_RULES, b, s, []),
             "22h": ("2,2", LM_SHARD_SEQ_RULES, b, s, []),
             "22g": ("1,4", LM_SHARD_CSEQ_RULES, db, dseq,
                     ["--decode", str(dpos)])}
    return {key: subprocess.Popen(
        [sys.executable, str(tool), "--arch", SERVE_ARCH, "--layers",
         str(LM_SHARD_LAYERS), "--batch", str(bb), "--seq", str(ss),
         "--mesh", mesh, "--rules", json.dumps(rules)] + extra
        + (["--reduced"] if rehearse else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for key, (mesh, rules, bb, ss, extra) in cells.items()}


def lm22_meta_records(key: str, r: dict) -> list:
    """A rank's byte records that the meta walk ``key`` predicts: each of
    22f's bf16 steps on a mesh, each of 22h's, 22g's first bf16 decode
    step under the rule."""
    if key.startswith("22f_"):
        return r["22f"]["steps"][key[4:]]["bytes"]
    if key == "22h":
        return r["22h"]["steps"]["bytes"]
    return [r["22g"]["bf16"]["bytes"]]


def lm22_fsdp_bytes_check(procs: dict, recs: dict) -> dict:
    """Every rank's bytes by kind and axis in each drive the meta walks
    predict (:func:`lm22_fsdp_bytes_start`) against theirs, equal."""
    keys = ("all_reduce", "all_gather", "calls", "on_data", "on_model")
    out = {}
    for key, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=LM_SHARD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode:
            raise AssertionError(f"{key}: torch_shard_bytes.py exited "
                                 f"{proc.returncode}:\n{stderr[-2000:]}")
        want = json.loads(stdout.strip().splitlines()[-1])["bytes"]
        for rank, r in sorted(recs.items()):
            for i, got in enumerate(lm22_meta_records(key, r)):
                bad = {k: (got.get(k, 0), want.get(k, 0)) for k in keys
                       if got.get(k, 0) != want.get(k, 0)}
                if bad:
                    raise AssertionError(f"{key}: rank {rank} record {i} "
                                         f"bytes against the meta walk: "
                                         f"{bad}")
        out[key] = {k: want.get(k, 0) for k in keys}
    return out


def phase_lm_shard(rehearse: bool = False) -> dict:
    """Phase 22: LM_SHARD_WORLD gloo ranks in spawned processes, all on
    this card (NCCL takes one rank a card), each running
    :func:`lm_shard_rank`: explicit tensor, expert and data parallelism
    of the transformer families, the fsdp rule, the seq_sp rule (22h), the
    cache_seq decode (22g), the elastic re-mesh and the training driver's
    ``--mesh local``.  Every rank's flash launches must equal what its
    drives predict (:func:`gloo_ranks`), and 22f's, 22h's and 22g's bytes
    the meta walk's.  ``rehearse`` runs the same drives at the
    reduced widths on the CPU (no kernel, no launch check)."""
    label = f"lm_shard_{LM_SHARD_WORLD}_ranks_gloo_one_card"
    t_phase = time.perf_counter()
    meta = lm22_fsdp_bytes_start(rehearse)
    try:
        recs, got = gloo_ranks(label, lm_shard_rank, rehearse)
    except BaseException:
        for proc in meta.values():
            proc.kill()
            proc.wait()
        raise
    fsdp_bytes = lm22_fsdp_bytes_check(meta, recs)
    rec = {"phase": label, "world": LM_SHARD_WORLD,
           "note": "the ranks time-share one card over gloo: times are no "
                   "scaling figure",
           "launches": got, "ranks": recs, "fsdp_meta_bytes": fsdp_bytes,
           "seconds": time.perf_counter() - t_phase}
    log("main " + json.dumps(rec))
    for rank, r in sorted(recs.items()):
        b = r["22b"]
        log(f"lm shard rank {rank} ({r['device']}, {LM_SHARD_WORLD} gloo "
            f"ranks sharing one card): 22b danube bf16 {b['batch']} x "
            f"{b['seq']} on (2, 2), {b['q_heads']} query and "
            f"{b['kv_heads']} KV heads a rank: step ms {b['ms']}"
            + (f", single device {b['single_ms']}" if "single_ms" in b
               else "") + f"; bytes a step {b['bytes'][-1]}; launches a "
            f"step {b['launches_a_step']}; state bytes {b['state_bytes']}; "
            f"peak GiB {b.get('peak_gib')}; parts {r['part_s']}")
        for key, f in sorted(r["22f"]["steps"].items()):
            log(f"lm shard rank {rank} 22f fsdp on {key}: step ms {f['ms']}"
                f"; bytes a step {f['bytes'][-1]}; state bytes "
                f"{f['state_bytes']}; peak GiB {f.get('peak_gib')}")
        h, g = r["22h"]["steps"], r["22g"]["bf16"]
        log(f"lm shard rank {rank} 22h seq_sp on (2, 2): step ms {h['ms']} "
            f"(22b {b['ms']}); bytes a step {h['bytes'][-1]} (meta "
            f"{fsdp_bytes['22h']}); peak GiB {h.get('peak_gib')} (22b "
            f"{b.get('peak_gib')})")
        log(f"lm shard rank {rank} 22g cache_seq on (1, 4), bf16 {g['batch']}"
            f" x {g['max_seq']} slots, cache block {g['cache_seq_cache_block']}"
            f" (default {g['default_cache_block']}): ms a step "
            f"{g['cache_seq_ms']} (default rules {g['default_ms']}); bytes a "
            f"step {g['bytes']} (meta {fsdp_bytes['22g']}; default rules "
            f"{g['default_bytes']}); against the default rules "
            f"{g['default']}" + (f", the single device {g['single']}"
                                 if "single" in g else ""))
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s; 22a {recs[0]['22a']}"
        f"; 22c {recs[0]['22c']}; 22d {recs[0]['22d']}; 22e "
        f"{recs[0]['22e']}; 22f parts {recs[0]['22f']['part_s']}; 22g f32 "
        f"{recs[0]['22g']['f32']}; 22h grads {recs[0]['22h']['grads']}; meta "
        f"bytes {fsdp_bytes}; parts {recs[0]['part_s']}; peak GiB "
        f"{[round(r.get('peak_mem_gib', 0.0), 2) for _, r in sorted(recs.items())]}")
    return rec


# -- phase 23: the roofline walk and the dry-run --------------------------------

# 23d: the dry-run's cells, each the CLI in a process of its own on the CPU
# (arch, shape, --mesh, the status it must report)
ROOF_CELLS = (("h2o-danube-1.8b", "train_4k", "single", "ok"),
              ("qwen3-moe-235b-a22b", "train_4k", "single", "ok"),
              ("command-r-plus-104b", "decode_32k", "multi", "ok"),
              ("zamba2-1.2b", "long_500k", "single", "ok"))
ROOF_TIMEOUT_S = 300
# 23a: phase 19a's training step timed after a warm-up; 23b: phase 10's
# decode step, ROOF_DECODE_STEPS timed
ROOF_TRAIN_STEPS, ROOF_DECODE_STEPS = 2, 8
# 23c: the walked peak against torch.cuda.max_memory_allocated, relative
ROOF_PEAK_TOL = 0.15


def roof_dryrun_start(directory: Path) -> list:
    """23d: the dry-run CLI on every ROOF_CELLS cell, each in a process of
    its own on the CPU (no card), all started together."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--results", str(directory),
         "--force"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for arch, shape, mesh, _ in ROOF_CELLS]


def roof_dryrun_finish(procs: list, directory: Path) -> list:
    """23d: each cell's JSON (its status must be ROOF_CELLS'): per-chip
    memory, the three roofline terms and the bottleneck."""
    out = []
    for (arch, shape, mesh, status), proc in zip(ROOF_CELLS, procs):
        try:
            text, _ = proc.communicate(timeout=ROOF_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry-run {arch} {shape}: no result in "
                                 f"{ROOF_TIMEOUT_S} s") from None
        if proc.returncode:
            raise AssertionError(f"dry-run {arch} {shape} {mesh}: exit "
                                 f"{proc.returncode}\n{text[-3000:]}")
        name = "2x16x16" if mesh == "multi" else "16x16"
        with open(directory / f"{arch}__{shape}__{name}__baseline.json") \
                as f:
            res = json.load(f)
        if res["status"] != status:
            raise AssertionError(f"dry-run {arch} {shape} {name}: "
                                 f"{res['status']}, not {status}: {res}")
        r = res["roofline"]
        rec = {"arch": arch, "shape": shape, "mesh": name,
               "status": res["status"], "walk_s": res["walk_s"],
               "memory_per_chip_gib": {k: v / 2 ** 30 for k, v in
                                       res["memory_analysis"].items()},
               "t_compute_ms": 1e3 * r["t_compute"],
               "t_memory_ms": 1e3 * r["t_memory"],
               "t_collective_ms": 1e3 * r["t_collective"],
               "bottleneck": r["bottleneck"],
               "roofline_fraction": r["roofline_fraction"],
               "entries": res["entries"]}
        log(f"roofline dry-run (a prediction from the H100 data sheet, "
            f"not measured): {json.dumps(rec)}")
        out.append(rec)
    return out


def roof_walk(fn, args):
    """(walk, output) of one call of ``fn`` under a roofline walk whose
    arguments are ``args``."""
    from repro_torch.roofline.op_walk import Walk
    walk = Walk(args)
    with walk:
        out = fn()
    walk.finish(out)
    return walk, out


def roof_same(label: str, card, meta) -> dict:
    """The card's walk against meta's: equal FLOPs, bytes and kernel
    entries (calls, FLOPs and bytes each); the aten ops that differ are
    named when they do not."""
    a, b = card.summary(), meta.summary()
    diff = {k: (a[k], b[k]) for k in ("flops", "bytes", "entries")
            if a[k] != b[k]}
    if diff:
        ops = {k: (card.by_op.get(k), meta.by_op.get(k))
               for k in sorted(set(card.by_op) | set(meta.by_op))
               if card.by_op.get(k) != meta.by_op.get(k)}
        raise AssertionError(f"{label}: the card's walk {diff} differs "
                             f"from meta's; by aten op {ops}")
    return {"flops": a["flops"], "bytes": a["bytes"],
            "entries": a["entries"], "aten_ops": (a["ops"], b["ops"])}


def roof_report(walk, cfg, shape, label: str, step_ms: float) -> dict:
    """The walk's roofline on one H100 (data sheet), the measured step
    beside its bound, and the model FLOPs' share of the bf16 peak."""
    from repro_torch.roofline import H100_SXM, analyze_step
    from repro_torch.roofline.analysis import (model_bytes_estimate,
                                               model_flops_estimate)
    flops = model_flops_estimate(cfg, shape)
    rep = analyze_step(walk, arch=cfg.name, shape=label, mesh_name="1",
                       chips=1, model_flops=flops,
                       model_bytes=model_bytes_estimate(cfg, shape))
    return {"t_compute_ms": 1e3 * rep.t_compute,
            "t_memory_ms": 1e3 * rep.t_memory, "bottleneck": rep.bottleneck,
            "t_bound_ms": 1e3 * rep.t_bound, "step_ms": step_ms,
            "step_over_bound": step_ms / (1e3 * rep.t_bound),
            "model_flops": flops,
            "mfu": flops / (step_ms / 1e3) / H100_SXM.peak_flops_bf16,
            "useful_flops_ratio": rep.useful_flops_ratio,
            "memory_gib": {k: v / 2 ** 30
                           for k, v in rep.memory_per_chip.items()}}


def phase_roofline() -> dict:
    """Phase 23: the roofline walk (``repro_torch.roofline``) of the
    card's steps against meta's, and the dry-run: a. phase 19a's danube
    bf16 training step (8 x 4096, 2 microbatches) walked on the card
    and on meta: equal FLOPs, bytes and kernel entries; the walk's bound,
    the measured step, their ratio, model_flops_estimate's MFU; b. phase
    10's decode step (8 sequences, the 4096-slot ring wrapped) likewise;
    c. a's walked peak against max_memory_allocated (within
    ROOF_PEAK_TOL); d. the dry-run CLI on ROOF_CELLS in processes of
    their own on the CPU, started first."""
    import tempfile
    label = "roofline"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = roof_dryrun_start(Path(tmp))
        try:
            rec = roof_steps()
        except BaseException:
            for proc in procs:
                proc.kill()
                proc.communicate()
            raise
        cells = roof_dryrun_finish(procs, Path(tmp))
    rec.update(phase=label, dryrun=cells,
               seconds=time.perf_counter() - t_phase)
    log("main " + json.dumps(rec))
    log(f"phase 23: {rec['seconds']:.1f} s")
    return rec


def roof_steps() -> dict:
    """Phase 23a-c on the card (see :func:`phase_roofline`)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import LM
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.train import (TrainState, adamw_init, make_train_step,
                                   require_grad)
    label = "roofline"
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    # a. the training step
    model, params = family_lm(SERVE_ARCH, seed=61)
    cfg = model.cfg
    state = TrainState(require_grad(params), adamw_init(params),
                       torch.Generator(device=DEVICE).manual_seed(62))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             family_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 63).items()}
    step = make_train_step(model, lr=TRAIN_LR, warmup=1, total_steps=100,
                           microbatches=TRAIN_MICRO)
    step(state, batch)
    times = []
    for _ in range(ROOF_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card, out = roof_walk(lambda: step(state, batch), (state, batch))
    torch.cuda.synchronize()
    walked_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(out[1]["loss"])):
        raise AssertionError(f"{label}: the walked step's loss is not "
                             "finite")
    del out
    # c. the walked peak, plus what the card held beside the step's
    # arguments, against the allocator's peak
    walked_peak = card.peak_bytes + (base - card.argument_bytes)
    peak_rel = abs(walked_peak - peak) / peak
    mmodel = LM(cfg, device="meta")
    mparams = mmodel.init(None)
    mstate = TrainState(require_grad(mparams), adamw_init(mparams),
                        torch.Generator())
    mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batch.items()}
    mstep = make_train_step(mmodel, lr=TRAIN_LR, warmup=1, total_steps=100,
                            microbatches=TRAIN_MICRO)
    t0 = time.perf_counter()
    meta, _ = roof_walk(lambda: mstep(mstate, mbatch), (mstate, mbatch))
    meta_s = time.perf_counter() - t0
    train = {"shape": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                       "microbatches": TRAIN_MICRO, "remat": cfg.remat},
             **roof_same(f"{label} train", card, meta),
             **roof_report(card, cfg, ShapeConfig(
                 "train", TRAIN_SEQ, TRAIN_BATCH, "train"), "phase19a",
                 statistics.median(times)),
             "step_ms_all": times, "walked_step_ms": walked_ms,
             "meta_walk_s": meta_s,
             "peak": {"walked_gib": walked_peak / 2 ** 30,
                      "max_memory_allocated_gib": peak / 2 ** 30,
                      "base_gib": base / 2 ** 30,
                      "argument_gib": card.argument_bytes / 2 ** 30,
                      "rel": peak_rel}}
    log(f"roofline 23a (train): {json.dumps(train)}")
    del state, batch, mstate, mparams, card, meta
    gc.collect()
    torch.cuda.empty_cache()
    if peak_rel > ROOF_PEAK_TOL:
        raise AssertionError(f"{label}: the walked peak {walked_peak} is "
                             f"{peak_rel:.3f} off max_memory_allocated "
                             f"{peak} (> {ROOF_PEAK_TOL})")
    # b. the decode step (its params no longer require grad)
    for leaf in (t for _, t in flat_params(params)):
        leaf.requires_grad_(False)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
    token = torch.ones((SERVE_BATCH, 1), dtype=torch.int32, device=DEVICE)
    serve = make_serve_step(model)
    pos = SERVE_PROMPT
    times = []
    with torch.no_grad():
        serve(params, cache, token, pos)
        for i in range(ROOF_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = serve(params, cache, token, pos + 1 + i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        check_finite(f"{label} decode", logits)
        card, _ = roof_walk(lambda: serve(params, cache, token, pos),
                            (params, cache, token))
        mcache = mmodel.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
        mparams = mmodel.init(None)
        mtoken = torch.empty((SERVE_BATCH, 1), dtype=torch.int32,
                             device="meta")
        meta, _ = roof_walk(lambda: make_serve_step(mmodel)(
            mparams, mcache, mtoken, pos), (mparams, mcache, mtoken))
    decode = {"shape": {"batch": SERVE_BATCH,
                        "cache_slots": cache["kv"]["k"].shape[2],
                        "pos": pos},
              **roof_same(f"{label} decode", card, meta),
              **roof_report(card, cfg, ShapeConfig(
                  "decode", SERVE_PROMPT, SERVE_BATCH, "decode"),
                  "phase10_decode", statistics.median(times)),
              "step_ms_all": times}
    log(f"roofline 23b (decode): {json.dumps(decode)}")
    got = launches()
    n_train = ROOF_TRAIN_STEPS + 2          # warm-up, timed, walked
    n_att = cfg.n_layers * TRAIN_MICRO * n_train
    check_launches(label, got, {
        "flash_attention_fwd_lse": 2 * n_att, "flash_attention_bwd": n_att,
        "flash_decode": cfg.n_layers * (ROOF_DECODE_STEPS + 2)})
    del model, params, cache
    return {"train": train, "decode": decode, "launches": got}


# -- phase 24: the recurrent families and compression on a model axis --------

RECUR24_ARCHS = ((ZAMBA_ARCH, ZAMBA_CUT_LAYERS), (XLSTM_ARCH,
                                                  XLSTM_CUT_LAYERS))


def recur24_rel(got: dict, want) -> tuple:
    """(largest relative error, its leaf) of gathered leaves ``got``
    against a tree ``want``, each relative to the leaf's largest entry."""
    worst, leaf = 0.0, None
    for name, w in flat_params(want):
        rel = float((got[name].to(w.dtype) - w).abs().max()) / (
            float(w.abs().max()) or 1.0)
        if rel >= worst:
            worst, leaf = rel, name
    return worst, leaf


def recur24_heads(model, params) -> dict:
    """The head-aligned blocks a rank holds."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        mixer = params["mamba_groups"]["mixer"]
        return {"mamba_heads": mixer["out_proj"].shape[-2]
                // cfg.ssm.headdim,
                "in_proj": list(mixer["in_proj"].shape[-2:]),
                "attn_q_heads": params["shared_attn"]["attn"]["wq"].shape[-1]
                // cfg.resolved_head_dim}
    mixer = params["mlstm_groups"]["mixer"]
    return {"mlstm_heads": mixer["wq"].shape[-3],
            "slstm_up": params["slstm"]["cell"]["up_l"].shape[-1]}


def recur24_comp_bytes(model, ctx, rank: int, min_dim: int) -> int:
    """24d's factor bytes a rank on the model axis, ring counted, from
    each compressible leaf's whole shape and split: its last dimension
    split, one all-reduce of P (n×k); an earlier one, an all-gather of
    the rank's rows of P and an all-reduce of Q (m×k)."""
    from repro_torch.dist.sharding import spec_axes
    specs = dict(flat_params(model.param_specs(ctx)))
    shapes = dict(flat_params(model.param_shapes()))
    world, total = ctx.tp, 0
    for name, spec in specs.items():
        shape = shapes[name]
        n, m = math.prod(shape[:-1]), shape[-1]
        if len(shape) < 2 or min(n, m) < min_dim or not spec_axes(spec):
            continue
        if len(spec) == len(shape) and spec[-1] is not None:
            total += 2 * (world - 1) * n * rank * 4 // world
        else:
            total += (world - 1) * (n // world) * rank * 4 \
                + 2 * (world - 1) * m * rank * 4 // world
    return total


def recur24_exact(rank: int, mesh, counts: Lm22Counts, rehearse: bool
                  ) -> dict:
    """24a and 24d: each family f32 on (2, 2), one step's loss and
    gathered gradients; on rank 0 against the single device's and a
    one-rank (1, 1) placement's; then zamba2's gradients compressed on
    the mesh against the single device's compression of the whole."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import (MeshShape, gather_tree,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM
    from repro_torch.train import grad_compression as gcmp
    from repro_torch.train import require_grad
    b, s = RECUR_SHARD_REHEARSE["exact"] if rehearse else RECUR_SHARD_EXACT
    out = {}
    for arch, layers in RECUR24_ARCHS:
        cfg = lm22_cfg(arch, layers, "float32", rehearse)
        model = LM(cfg, device=counts.device)
        batch = {"tokens": lm22_tokens(cfg, b, s, 81)}
        rec = {"batch": b, "seq": s, "n_layers": layers}
        t0 = time.perf_counter()
        with use_sharding(mesh) as ctx:
            specs = model.param_specs()
            params = require_grad(shard_tree(
                model.init(lm22_gen(model.device, 82)), specs))
            rec.update(recur24_heads(model, params))
            loss, grads = counts.drive(
                lambda: lm22_grads(model, params, batch),
                lm22_train_launches(cfg))
            whole = dict(flat_params(gather_tree(grads, specs)))
            if cfg.family == "hybrid":
                comp = gcmp.init_compression(
                    params, rank=RECUR_SHARD_COMP_RANK, min_dim=128,
                    generator=lm22_gen(model.device, 83),
                    specs=specs)
                sharding.reset_bytes()
                compressed, _ = gcmp.compress_tree(grads, comp, specs)
                comp_bytes = dict(sharding.BYTES)
                decompressed = dict(flat_params(gather_tree(
                    gcmp.decompress_tree(compressed), specs)))
                want_bytes = recur24_comp_bytes(
                    model, ctx, RECUR_SHARD_COMP_RANK, 128)
                del comp, compressed
        rec.update(loss=float(loss), sharded_s=time.perf_counter() - t0)
        del params, grads
        if rank == 0:
            single = require_grad(model.init(lm22_gen(model.device, 82)))
            want_loss, want = lm22_grads(model, single, batch)
            rec["loss_single"] = float(want_loss)
            rec["loss_rel_err"] = abs(float(loss) - float(want_loss)) / abs(
                float(want_loss))
            rec["grad_worst_rel_err"], rec["grad_worst_leaf"] = recur24_rel(
                whole, want)
            rec["grad_leaves"] = len(whole)
            if rec["loss_rel_err"] > TRAIN_LOSS_RTOL \
                    or rec["grad_worst_rel_err"] > MAIN_TOL:
                raise AssertionError(
                    f"24a {arch}: sharded against single device: loss "
                    f"{rec['loss_rel_err']} (limit {TRAIN_LOSS_RTOL}), "
                    f"gradient {rec['grad_worst_leaf']} "
                    f"{rec['grad_worst_rel_err']} (limit {MAIN_TOL})")
            # one rank: the same placement code on a (1, 1) mesh, which
            # issues no collective
            with use_sharding(MeshShape((1, 1), ("data", "model"))):
                one = require_grad(shard_tree(
                    model.init(lm22_gen(model.device, 82)),
                    model.param_specs()))
                one_loss, one_grads = lm22_grads(model, one, batch)
            rec["one_rank_rel_err"] = max(
                abs(float(one_loss) - float(want_loss)) / abs(
                    float(want_loss)),
                recur24_rel(dict(flat_params(one_grads)), want)[0])
            if rec["one_rank_rel_err"] > SHARD_ONE_TOL:
                raise AssertionError(f"24a {arch}: one rank against the "
                                     f"single device: "
                                     f"{rec['one_rank_rel_err']}")
            del one, one_grads
            if cfg.family == "hybrid":
                # the single device's compression of the whole gradients
                # (the sharded ones, gathered) from the same Q0
                wgrads = {}
                for name, g in whole.items():
                    node = wgrads
                    *head, last = name.split(".")
                    for k in head:
                        node = node.setdefault(k, {})
                    node[last] = g
                state = gcmp.init_compression(
                    wgrads, rank=RECUR_SHARD_COMP_RANK, min_dim=128,
                    generator=lm22_gen(model.device, 83))
                want_dec = gcmp.decompress_tree(
                    gcmp.compress_tree(wgrads, state)[0])
                worst, leaf = recur24_rel(decompressed, want_dec)
                rec["compression"] = {
                    "rank": RECUR_SHARD_COMP_RANK,
                    "worst_rel_err": worst, "worst_leaf": leaf,
                    "bytes": comp_bytes, "bytes_predicted": want_bytes,
                    "leaves_low_rank": sum(
                        q is not None for _, q in flat_params(state.q))}
                if worst > MAIN_TOL or comp_bytes.get("on_model") \
                        != want_bytes or comp_bytes.get("on_data", 0):
                    raise AssertionError(f"24d: {rec['compression']}")
                del wgrads, state, want_dec
            del single, want
        del whole
        if cfg.family == "hybrid":
            del decompressed
        gc.collect()
        dist.barrier()
        out[arch] = rec
    return out


def recur24_step(rank: int, mesh, counts: Lm22Counts, rehearse: bool):
    """24b: each family bf16 on (2, 2), RECUR_SHARD_STEP's steps timed
    with the bytes of each, then on rank 0 the single device's at the
    same global batch.  Returns (records, zamba2's state, model)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.models import LM
    from repro_torch.train import init_train_state, make_train_step
    b, s, steps = (RECUR_SHARD_REHEARSE["step"] if rehearse
                   else RECUR_SHARD_STEP)
    out, kept = {}, None
    for arch, layers in RECUR24_ARCHS:
        cfg = lm22_cfg(arch, layers, "bfloat16", rehearse)
        model = LM(cfg, device=counts.device)
        batch = {"tokens": lm22_tokens(cfg, b, s, 84)}
        rec = {"batch": b, "seq": s, "ms": [], "bytes": [], "loss": []}
        with sharding.use_sharding(mesh):
            state = init_train_state(model, lm22_gen(model.device, 85))
            rec.update(recur24_heads(model, state.params))
            step = make_train_step(model)
            for _ in range(steps):
                sharding.reset_bytes()
                lm22_sync(model.device)
                t0 = time.perf_counter()
                state, metrics = counts.drive(lambda: step(state, batch),
                                              lm22_train_launches(cfg))
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["bytes"].append(dict(sharding.BYTES))
                rec["loss"].append(float(metrics["loss"]))
        rec["launches_a_step"] = lm22_train_launches(cfg)
        if rank == 0:
            single = init_train_state(model, lm22_gen(model.device, 85))
            one = make_train_step(model)
            rec["single_ms"], rec["single_loss"] = [], []
            for _ in range(steps):
                lm22_sync(model.device)
                t0 = time.perf_counter()
                single, metrics = one(single, batch)
                lm22_sync(model.device)
                rec["single_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["single_loss"].append(float(metrics["loss"]))
            del single, one
            rec["loss_worst_rel_err"] = max(
                abs(x - y) / abs(y)
                for x, y in zip(rec["loss"], rec["single_loss"]))
            rec["loss_tol"] = LM_SHARD_BF16_LOSS_C / math.sqrt(b * s)
            if not rec["loss_worst_rel_err"] <= rec["loss_tol"]:
                raise AssertionError(
                    f"24b {arch}: bf16 losses {rec['loss']} on (2, 2) "
                    f"against the single device's {rec['single_loss']}: "
                    f"relative {rec['loss_worst_rel_err']:.3g} > "
                    f"{rec['loss_tol']:.3g}")
        if cfg.family == "hybrid":
            kept = (state, model)
        del state
        gc.collect()
        dist.barrier()
        out[arch] = rec
    return out, kept


def recur24_decode_run(model, params, cache, prompt, steps: int, rows_of,
                       gather_logits):
    """A token-by-token prefill of ``prompt``'s positions, then greedy
    steps to ``steps`` positions in all: every step's logits (whole) and
    the greedy tokens (whole)."""
    import torch
    logits, tokens = [], []
    token = rows_of(prompt[:, :1])
    for pos in range(steps):
        out, cache = model.decode_step(params, cache, token, pos)
        whole = gather_logits(out)[:, 0]
        logits.append(whole)
        if pos + 1 < prompt.shape[1]:
            token = rows_of(prompt[:, pos + 1:pos + 2])
        else:
            nxt = whole.argmax(dim=-1, keepdim=True)
            tokens.append(nxt[:, 0])
            token = rows_of(nxt)
    return torch.stack(logits, dim=1), torch.stack(tokens, dim=1)


def recur24_decode(rank: int, mesh, counts: Lm22Counts, rehearse: bool
                   ) -> dict:
    """24c: each family f32 on (1, 4), decode through ``LM.decode_step``
    from a cache placed by ``LM.cache_specs``; on rank 0 against the
    single device's decode of the same params."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import (MODEL, current_ctx, gather,
                                           shard_tree, use_sharding)
    from repro_torch.models import LM
    from repro_torch.train.train_step import data_rows
    prompt_len, new = (RECUR_SHARD_REHEARSE["decode"] if rehearse
                       else (RECUR_SHARD_PROMPT, RECUR_SHARD_NEW))
    b = RECUR_SHARD_EXACT[0]
    steps = prompt_len + new
    out = {}
    for arch, layers in RECUR24_ARCHS:
        cfg = lm22_cfg(arch, layers, "float32", rehearse)
        model = LM(cfg, device=counts.device)
        prompt = lm22_tokens(cfg, b, prompt_len, 86).to(model.device)
        rec = {"batch": b, "prompt": prompt_len, "new": new}
        with torch.no_grad(), use_sharding(mesh):
            ctx = current_ctx()
            params = shard_tree(model.init(lm22_gen(model.device, 87)),
                                model.param_specs())
            cache = shard_tree(model.init_cache(b, steps),
                               model.cache_specs(b, steps))
            rec["cache_local"] = {name: list(t.shape) for name, t in
                                  flat_params(cache)
                                  if not name.startswith("kv.")}
            lm22_sync(model.device)
            t0 = time.perf_counter()
            logits, toks = counts.drive(
                lambda: recur24_decode_run(
                    model, params, cache, prompt, steps,
                    lambda t: data_rows({"t": t}, model.device)["t"],
                    lambda x: gather(gather(x, -1, MODEL), 0,
                                     ctx.batch_axes)),
                {"flash_decode": attention_groups(cfg) * steps})
            lm22_sync(model.device)
            rec["ms_a_step"] = (time.perf_counter() - t0) * 1e3 / steps
        rec["launches_a_step"] = {"flash_decode": attention_groups(cfg)}
        del params, cache
        if rank == 0:
            with torch.no_grad():
                whole = model.init(lm22_gen(model.device, 87))
                want, want_toks = recur24_decode_run(
                    model, whole, model.init_cache(b, steps), prompt,
                    steps, lambda t: t, lambda x: x)
            diff = (logits - want).abs()
            rec["max_abs_err"] = float(diff.max())
            rec["excess"] = float((diff - SERVE_RTOL * want.abs()).max())
            rec["greedy_equal"] = bool(torch.equal(toks, want_toks))
            if not torch.isfinite(logits).all() \
                    or rec["excess"] > SERVE_ATOL or not rec["greedy_equal"]:
                raise AssertionError(
                    f"24c {arch}: decode on (1, 4) against the single "
                    f"device: max |diff| {rec['max_abs_err']}, greedy equal "
                    f"{rec['greedy_equal']}")
            del whole, want
        gc.collect()
        dist.barrier()
        out[arch] = rec
    return out


def recur24_ckpt(rank: int, mesh22, mesh14, kept, directory: str) -> dict:
    """24e: 24b's zamba2 state saved on (2, 2) (gathered, rank 0 writes),
    restored onto (1, 4): each rank's restored blocks against its blocks
    of the saved state, gathered whole before the save, bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import CheckpointManager
    from repro_torch.dist.sharding import (gather_tree, local_block,
                                           use_sharding)
    from repro_torch.train import init_train_state, train_state_specs
    state, model = kept
    mgr = CheckpointManager(directory, async_save=False)
    step = int(state.opt.step)
    with use_sharding(mesh22):
        specs = train_state_specs(model)
        whole = {key: gather_tree(
            state.params if key == "params" else getattr(state.opt, key),
            specs.params) for key in ("params", "master", "m", "v")}
        lm22_sync(model.device)
        t0 = time.perf_counter()
        mgr.save(step, state, blocking=True, specs=specs)
        out = {"save_s": time.perf_counter() - t0}
    del state
    gc.collect()
    with use_sharding(mesh14):
        specs = train_state_specs(model)
        fresh = init_train_state(model, lm22_gen(model.device, 88))
        t0 = time.perf_counter()
        back = mgr.restore(fresh, step=step, specs=specs)
        out["restore_s"] = time.perf_counter() - t0
        del fresh
        spec_at = dict(flat_params(specs.params))
        differ = []
        for key in ("params", "master", "m", "v"):
            got = dict(flat_params(back.params if key == "params"
                                   else getattr(back.opt, key)))
            for name, w in flat_params(whole[key]):
                if not torch.equal(got[name], local_block(w,
                                                          spec_at[name])):
                    differ.append(f"{key}.{name}")
        out.update(leaves_differing=differ, restored_step=int(back.opt.step),
                   in_proj_local=list(back.params["mamba_groups"]["mixer"][
                       "in_proj"].shape))
        if differ or out["restored_step"] != step:
            raise AssertionError(f"24e: restored on (1, 4), leaves differ "
                                 f"from the saved ones: {differ[:8]}")
    del back, whole
    gc.collect()
    dist.barrier()
    return out


def recur24_driver(rank: int, world: int, directory: str,
                   counts: Lm22Counts, rehearse: bool) -> dict:
    """24f: the training driver, ``launch.train.train``, on a
    ``make_local_mesh(2)`` of the four ranks (a world of its own file
    store), zamba2 cut to ZAMBA_CUT_LAYERS in bf16 (its whole depth on
    four ranks runs out of the card's memory) with compression rank 2,
    RECUR_SHARD_DRIVER_STEPS steps; rank 0's history."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_local_mesh
    steps = RECUR_SHARD_DRIVER_STEPS
    b, s = (RECUR_SHARD_REHEARSE["driver"] if rehearse
            else RECUR_SHARD_DRIVER_BATCH)
    cfg = lm22_cfg(ZAMBA_ARCH, ZAMBA_CUT_LAYERS, "bfloat16", rehearse)
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/recur_driver_store",
        world_size=world, rank=rank)
    t0 = time.perf_counter()
    try:
        mesh = make_local_mesh(2, device_type=counts.device.type)
        result = counts.drive(
            lambda: train_mod.train(cfg, steps=steps, batch=b, seq=s,
                                    compression_rank=2, mesh=mesh,
                                    log_every=1),
            lm22_train_launches(cfg, steps))
    finally:
        dist.destroy_process_group()
    out = {"seconds": time.perf_counter() - t0, "batch": b, "seq": s,
           "n_layers": cfg.n_layers}
    if rank == 0:
        out["history"] = result["history"]
        if len(out["history"]) != steps or not all(
                math.isfinite(h["loss"]) for h in out["history"]):
            raise AssertionError(f"24f: history {out['history']}")
    return out


def recur_shard_rank(rank: int, world: int, store: str, results,
                     directory: str, rehearse: bool = False) -> None:
    """One of phase 24's ranks, in a spawned process: join the gloo world
    through ``store`` on ``cuda:(rank % device_count)`` (the CPU when
    rehearsing), build the (2, 2) and (1, 4) meshes, run 24a-24e, leave
    the group, run 24f, and put ``(rank, record)`` -- or ``(rank,
    traceback)`` -- on ``results``."""
    try:
        device, counts, mesh22, mesh14 = gloo_rank_join(rank, world, store,
                                                        rehearse)
        import torch
        import torch.distributed as dist
        rec, parts = {"device": str(device)}, {}
        t0 = time.perf_counter()
        try:
            if not rehearse:
                torch.cuda.reset_peak_memory_stats()
            for part, fn in (
                    ("24a", lambda: recur24_exact(rank, mesh22, counts,
                                                  rehearse)),
                    ("24b", lambda: recur24_step(rank, mesh22, counts,
                                                 rehearse)),
                    ("24c", lambda: recur24_decode(rank, mesh14, counts,
                                                   rehearse))):
                t1 = time.perf_counter()
                rec[part] = fn()
                parts[part] = time.perf_counter() - t1
                if part == "24b":
                    rec[part], kept = rec[part]
                if rank == 0:
                    log(f"recurrent shard rank 0 {part} "
                        f"({parts[part]:.1f} s): {json.dumps(rec[part])}")
            t1 = time.perf_counter()
            rec["24e"] = recur24_ckpt(rank, mesh22, mesh14, kept,
                                      f"{directory}/recur_ckpt")
            parts["24e"] = time.perf_counter() - t1
            del kept
            if rank == 0:
                log(f"recurrent shard rank 0 24e ({parts['24e']:.1f} s): "
                    f"{json.dumps(rec['24e'])}")
            if not rehearse:
                rec["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        gc.collect()
        if not rehearse:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec["24f"] = recur24_driver(rank, world, directory, counts, rehearse)
        parts["24f"] = time.perf_counter() - t1
        if rank == 0:
            log(f"recurrent shard rank 0 24f ({parts['24f']:.1f} s): "
                f"{json.dumps(rec['24f'])}")
        rec["part_s"] = parts
        rec["seconds"] = time.perf_counter() - t0
        rec["counts"], rec["expect"] = counts.counts, counts.expect
        results.put((rank, rec))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, traceback.format_exc()))
        raise


def phase_recur_shard(rehearse: bool = False) -> dict:
    """Phase 24: LM_SHARD_WORLD gloo ranks in spawned processes, all on
    this card, each running :func:`recur_shard_rank`: the recurrent
    families and gradient compression on a model axis, a checkpoint
    across meshes and the training driver.  Every rank's flash launches
    must equal what its drives predict (:func:`gloo_ranks`).
    ``rehearse`` runs the same drives at the reduced widths on the CPU
    (no kernel, no launch check)."""
    label = f"recurrent_shard_{LM_SHARD_WORLD}_ranks_gloo_one_card"
    t_phase = time.perf_counter()
    recs, got = gloo_ranks(label, recur_shard_rank, rehearse)
    rec = {"phase": label, "world": LM_SHARD_WORLD,
           "note": "the ranks time-share one card over gloo: times are no "
                   "scaling figure",
           "launches": got, "ranks": recs,
           "seconds": time.perf_counter() - t_phase}
    log("main " + json.dumps(rec))
    for rank, r in sorted(recs.items()):
        for arch, b in r["24b"].items():
            log(f"recurrent shard rank {rank} ({r['device']}, "
                f"{LM_SHARD_WORLD} gloo ranks sharing one card): 24b {arch} "
                f"bf16 {b['batch']} x {b['seq']} on (2, 2): step ms "
                f"{b['ms']}" + (f", single device {b['single_ms']}"
                               if "single_ms" in b else "")
                + f"; bytes a step {b['bytes'][-1]}; parts {r['part_s']}")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s; peak GiB "
        f"{[round(r.get('peak_mem_gib', 0.0), 2) for _, r in sorted(recs.items())]}")
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(SRC.parent / "tests"))   # tests/flash_bounds.py
    from repro_torch.apps import OLS, MatrixPowers
    from repro_torch.data import UpdateStream
    from repro_torch.kernels import cuda_build

    # 1. device
    smi = nvidia_smi()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    part, flops_peak, bytes_peak, bf16_peak, tf32_peak = peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind}; peaks from the {part} data sheet: "
        f"{flops_peak / 1e12} TFLOP/s fp32, {bytes_peak / 1e12} TB/s, "
        f"{bf16_peak / 1e12} TFLOP/s bf16 and {tf32_peak / 1e12} TF32 "
        "(tensor cores, dense)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{json.dumps(build_s)}")
    for name, text in sorted(cuda_build.BUILD_LOGS.items()):
        for entry, line in ptxas_lines(text):
            log(f"ptxas {name} {entry}: {line}")

    # 3. kernels
    shapes = check_kernels(flops_peak, bytes_peak)
    peaks_ = (bytes_peak, flops_peak, bf16_peak, tf32_peak)
    shapes.update(check_flash_kernels(peaks_))
    shapes.update(check_flash_bwd_kernels(peaks_))
    check_grad_refusal()

    # 4. matrix powers at the paper's size; 5. OLS at the paper's n range
    n = POWERS_N
    phases = [drive(f"matrix_powers_n{n}_k16_exp",
                    MatrixPowers(n=n, k=16, model="exp"),
                    MatrixPowers.synthesize(n, seed=0),
                    UpdateStream(n=n, m=n, seed=1))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m_rows, n_cols = OLS_M, OLS_N
    inputs, _ = OLS.synthesize(m_rows, n_cols, 1, seed=0)
    ols = OLS(m_rows, n_cols, 1)
    phases.append(drive(f"ols_m{m_rows}_n{n_cols}_p1", ols, inputs,
                        UpdateStream(n=m_rows, m=n_cols, seed=1)))
    w = ols.engine.views["W"]
    del ols, inputs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 6.-7. row-local carriers; 8. the other apps; 9. Sherman-Morrison
    compact = phase_compact()
    phases.append(compact)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases.append(phase_mixed())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases.extend(phase_apps())
    phases.append(phase_sherman_morrison(w))
    del w
    torch.cuda.empty_cache()

    # 10.-12. LM serving
    rec, eng, prompts = phase_serve_full(peaks_)
    phases.append(rec)
    phases.append(phase_serve_exact())
    torch.cuda.empty_cache()
    rec, H, W = phase_logit_view(eng, prompts)
    phases.append(rec)
    del prompts
    torch.cuda.empty_cache()

    # 13. planned maintenance
    phases.extend(phase_plan(compact))

    # 14. guarded maintenance (14e on phase 12's view and server)
    phases.extend(phase_guard((eng, H, W, rec)))
    del rec
    torch.cuda.empty_cache()

    # 15. the multi-tenant fleet (15a and 15d behind phase 10's server)
    phases.extend(phase_fleet((eng, H, W), bytes_peak))
    del eng, H, W
    torch.cuda.empty_cache()

    # 16. the higher-order deferred cascade and the learning views
    phases.extend(phase_ho())
    torch.cuda.empty_cache()

    # 17. the moe, vlm and audio families at full width
    phases.extend(phase_families(peaks_))
    torch.cuda.empty_cache()

    # 18. the hybrid and ssm families at full width
    phases.extend(phase_recurrent(peaks_))
    torch.cuda.empty_cache()

    # 19. the training path
    phases.extend(phase_train(peaks_))
    torch.cuda.empty_cache()

    # 20. the training driver with checkpoints and supervised restarts
    torch.cuda.reset_peak_memory_stats()
    phases.extend(phase_ckpt())
    gc.collect()
    torch.cuda.empty_cache()

    # 21. the row-sharded engine: one NCCL rank, four gloo ranks on the card
    phases.extend(phase_shard())
    torch.cuda.empty_cache()

    # 22. the LM half of the sharded dist/: four gloo ranks on the card
    phases.append(phase_lm_shard())
    torch.cuda.empty_cache()

    # 23. the roofline walk on the card and on meta; the dry-run
    phases.append(phase_roofline())
    torch.cuda.empty_cache()

    # 24. the recurrent families and compression on a model axis: four
    # gloo ranks on the card
    phases.append(phase_recur_shard())
    torch.cuda.empty_cache()

    # the kernels record: per entry, the main path's launches and the
    # numbers of its headline shape (the most common call of the path)
    headline = {"rank_update_batched": (10000, 10000, 1, 16),
                "rank_update": (10000, 10000, 1, 1),
                "rank_update_rows": (CHAIN_N, CHAIN_M, CHAIN_ROWS,
                                     CHAIN_RANK),
                "dual_matmul": (8192, 8192, 1),
                "flash_attention": "danube_prefill_bf16",
                "flash_attention_fwd_lse": "danube_train_bf16",
                "flash_attention_bwd": "danube_train_bf16",
                "flash_decode": "danube_decode_bf16_wrapped",
                "flash_decode_lse": "danube_cseq_rank_bf16",
                "rank_update_batched_out": (10000, 10000, 1, 16),
                "select_commit": "clean"}
    # rank_update_batched's launches over phases 4-9, 12-16 and 21 by K, so that
    # each K's gap to its bound can be weighed by its launches
    by_k = {}
    for ph in phases:
        for K, count in ph.get("dense_ranks", {}).items():
            by_k[K] = by_k.get(K, 0) + count
    if sum(by_k.values()) != sum(ph["launches"]["rank_update_batched"]
                                 for ph in phases):
        raise AssertionError(f"launches by K {by_k} do not sum to the "
                             "launches of rank_update_batched")
    # the out-of-place entry's, read at every main-path drive (phases 14-16)
    if sum(OUT_RANKS.values()) != sum(
            ph["launches"]["rank_update_batched_out"] for ph in phases):
        raise AssertionError(f"launches by K {OUT_RANKS} do not sum to the "
                             "launches of rank_update_batched_out")
    kernels = []
    for entry, recs in shapes.items():
        head = next(r for r in recs
                    if r.get("case", tuple(r[k] for k in r if k in
                                           ("n", "p", "m", "T", "r", "k")))
                    == headline[entry])
        kernels.append({
            "name": entry, "route": "cuda", "source": SOURCES[entry],
            "replaces": REPLACES[entry],
            "launches": sum(ph["launches"][entry] for ph in phases),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: v for k, v in head.items()
                      if k in ("n", "p", "m", "T", "r", "k", "b", "s", "L",
                               "h", "kvh", "hd", "window", "n_valid",
                               "dtype")}})
        if entry in BY_P:
            # the main path's launches by M's columns p (p < PSKINNY: the
            # skinny tile), and the dense entries' skinny launches by K
            kernels[-1]["launches_by_p"] = dict(sorted(BY_P[entry].items()))
            if sum(BY_P[entry].values()) != kernels[-1]["launches"]:
                raise AssertionError(
                    f"{entry}: launches by p {BY_P[entry]} do not sum to "
                    f"its {kernels[-1]['launches']} launches")
            if SKINNY_K.get(entry):
                kernels[-1]["skinny_launches_by_K"] = dict(
                    sorted(SKINNY_K[entry].items()))
        if entry in ("flash_attention", "flash_attention_fwd_lse",
                     "flash_attention_bwd"):
            # the kernel the headline shape takes, and the main path's
            # launches by kernel (by head dim and type; K1's by the route
            # of its kernels)
            kernels[-1]["kernel"] = head["kernel"]
            kernels[-1]["launches_by_kernel"] = dict(sorted(
                FLASH_BY_KERNEL.get(entry, {}).items()))
            if sum(kernels[-1]["launches_by_kernel"].values()) \
                    != kernels[-1]["launches"]:
                raise AssertionError(
                    f"{entry}: launches by kernel "
                    f"{kernels[-1]['launches_by_kernel']} do not sum to its "
                    f"{kernels[-1]['launches']} launches")
            wgmma = "flash_bwd_wgmma" if entry == "flash_attention_bwd" \
                else "flash_attention_bf16_wgmma"
            if not kernels[-1]["launches_by_kernel"].get(wgmma):
                raise AssertionError(f"{entry}: the main path launched no "
                                     f"{wgmma}")
        if entry == "rank_update_batched":
            kernels[-1]["launches_by_K"] = dict(sorted(by_k.items()))
        if entry == "rank_update_batched_out":
            kernels[-1]["launches_by_K"] = dict(sorted(OUT_RANKS.items()))
        if entry in ("rank_update_batched", "rank_update_batched_out"):
            # the K that phase 3 held against the plain version, any shape
            kernels[-1]["checked_K"] = sorted(
                {r["T"] * r["k"] for r in recs})
        for key in ("device_ms", "kernel_sum_ms", "host_us",
                    "library_device_ms", "library_kernel_sum_ms",
                    "library_host_us"):
            if key in head:
                kernels[-1][key] = head[key]
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
