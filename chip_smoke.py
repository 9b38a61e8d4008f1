#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit, and an ``nvcc`` build of every kernel
   from ``src/repro_torch/kernels/csrc``, all sources at once;
2. each of the six kernels against its plain PyTorch version on the card,
   at odd small shapes and under both precisions (nnz not a multiple of
   128, duplicates, zero padding, one slice, ranks 5x3, 13x22x10, 16 and
   33x40, 2-way, an order-5 tensor, ``fused=False`` against the fused kernel, and the
   megakernel with a group's row 0 and its padding in different ranges);
   kernels 1 and 5 read the factor matrices through the schedule and each
   gives the same bits twice; each ``ttm`` call launches one kernel and
   gives the same bits twice; the order >= 4 chain kernel
   (``csrc/kron_chain_scatter.cu``) at 4- to 6-way shapes, with rows
   spanning several of its ranges, in fp32, bf16_fp32acc and f64, against
   its plain version and against kernels 3 and 4 (``fused=False``), the
   same bits twice; the bf16_fp32acc calls of kernels 1 and 5 and the
   chain kernel also no further from the f64 sum of their terms than the
   plain version (``nearer_exact``), in phases 4, 5 and 6 too;
3. the card against the CPU from the same factors (fit history, factor
   projectors and core): a NELL-2-like tensor (1000^3, 24,000 nonzeros,
   ranks 16, 5 sweeps) split and with ``fuse_core``, a 4-way tensor
   (200x200x200x20, 1,000,000 nonzeros, ranks 8, 5 sweeps; the chain
   kernel once a mode), and a small 4-way tensor with ``fuse_core`` (which
   takes the split TTM); under ``bf16_fp32acc`` the NELL-2-like tensor
   split and with ``fuse_core`` and the small 4-way tensor, held to
   ``BF16_CARD_VS_CPU`` (the card's kernels 1 and 5 and chain kernel keep
   each product of bf16 operands unrounded);
4. the 3-way main path at the published size of FROSTT's NELL-2 tensor
   (12,092 x 9,184 x 28,818, 76,879,419 nonzeros; synthetic uniform
   coordinates, values uniform in [0.1, 10)), ranks (16, 16, 16), 5 sweeps:
   launch counts, per-sweep time, no gather of (nnz, R) operand rows in a
   warm sweep (``ops._gathered_block_rows.calls``), kernels 1-2 against
   their plain versions at the path's own shapes under both precisions,
   kernel 1's same bits from two calls, and their times and bounds (kernel
   1's bf16_fp32acc route on bf16 m16n8k16 beside its fp32 route); a
   bf16_fp32acc plan of 5 sweeps in turns with the fp32 plan (launches,
   ms a sweep, busy share, the fit within 1e-2 of fp32's; its schedules
   dropped after); then
   the per-sweep pipeline (``pipeline="python"``) on the same tensor and
   factors: its launches, the scan pipeline's fit, factors and core bit for
   bit, and its time per sweep beside the scan pipeline's;
5. path B, the same tensor through ``make_engine("cuda", fuse_core=True)``:
   launch counts, the fit, factors and core against phase 4's, per-sweep
   time in turns with the split path, no gather of (nnz, R) operand rows in
   its warm runs, peak memory beside the split path's, and the megakernel
   against its plain version and the split core update, its same bits from
   two calls, its time and bound, in fp32 and bf16_fp32acc (bf16 m16n8k16
   walk, 2xTF32 rounds); a bf16_fp32acc ``fuse_core`` plan of 5 sweeps in
   turns with the fp32 one, as phase 4's;
6. path A, the 4-way path at the published size of FROSTT's NIPS tensor
   (2,482 x 2,862 x 14,036 x 17, 3,101,609 nonzeros; synthetic uniform
   coordinates, counts Poisson(3) + 1), ranks 16, 5 sweeps: launch counts
   (the chain kernel once a mode, no kernel 3 or 4), per-sweep time, peak
   memory (<= ``PHASE6_PEAK_GB``), no (nnz, R) gather in a warm sweep; per
   mode the chain kernel against its plain version and against the unfused
   route (``fused=False``, kernels 3 and 4, whose launches and device time
   it counts), the same bits twice, its time per slot (mode 3's 17 long
   rows against the others), kernels 3 and 4 against their plain versions,
   and the core TTM; the core against one built from the returned factors
   by the plain versions alone; the chain kernel's bf16_fp32acc route
   (2xTF32) a mode against its plain version, timed beside the fp32 route,
   with its bound, plain and library times, and a bf16_fp32acc plan of 5
   sweeps in turns with the fp32 plan, as phase 4's;
7. kernels 6 (flash attention) and 7 (the Mamba-2 SSD chunk) against their
   plain versions at odd shapes: GQA, MQA, T > S, S not a block multiple,
   D 16-128 (80 included), non-causal, the Zamba2 serving shape at S 1,024,
   the model's strided views (head dim 28 among them), in f32 (the CUDA-core
   route) and bf16 (the tensor-core route), each call checked to take its
   dtype's route; kernel 7 at L 1-256 (63, 64, 255 among them), N and P
   1-128 (17 and 80 among them) and a decay steep enough that exp above
   the diagonal overflows, each with B and C in bf16 and in f32;
8. zamba2-2.7b SMOKE, card against CPU from the same seeded weights, in
   float32 and bfloat16: prefill logits, 8 teacher-forced decode steps and
   the greedy tokens of ``Engine.generate``;
9. the LM serving path at full width: zamba2-2.7b as registered (54 Mamba-2
   layers, d 2,560, 2.42 B parameters from a seeded generator on the card),
   ``Engine.generate`` of 16 new tokens cold (64 until PR 29) and 64 warm
   after 4 prompts of 4,096 tokens:
   launch counts (9 and 54 per prefill, the 9 on the tensor-core route),
   prefill ms, decode ms per step,
   tokens/s, peak memory and the device's busy share; kernel 6 against its
   plain version on one layer's real inputs; kernel 7 against its plain
   version on every one of the 54 calls of a warm prefill, each on the
   inputs its layer really receives, at the fp32 rule, with two controls
   on layer 0's inputs (the function in f64 must pass the rule, its
   products on one TF32 pass must fail it); both kernels' times and
   bounds; and, as a guard against gross faults, the last-token prefill
   logits against a prefill that runs the plain versions on the card,
   within a limit set in the same run from the f64 control's movement;
10. the paper's Table V tensors (Amazon 20000^3 at ranks 32, NELL-2's
    1000^3 portion, the exact matmul tensor, the 130x150 angiogram at ranks
    (30, 35)) at their published ranks and sweeps: card against CPU, the fit
    against an error taken without the projection identity (densely, or at
    the nonzeros for Amazon), ms per sweep, peak memory, launches, the
    paper's call counts, and kernels 1 and 2 at these shapes against their
    plain versions, with times and bounds;
11. dense HOOI: Table II (a rank-16 tensor with 1e-9 noise, svd,
    householder and gram) card against CPU at 200^3 and at the paper's
    800^3 its dense errors, ms per sweep and peak; Fig. 6 (sparse gram
    against dense svd at 200^3, three sparsities, warm times); and EM
    completion, card against CPU at 64x64x32 and a 256x256x128 volume
    observed at 20%: the error on the unobserved entries, ms per EM round;
12. the Tucker decomposition service (``repro_torch.serve.TuckerService``,
    max_batch 16, max_wait_ms 5, 2 executors) fed by 4 threads: 64 requests
    at the NELL-2 portion's shape (householder, 5 sweeps), 32 at Amazon's
    (gram, 2 sweeps) and 16 4-way tensors (200x200x200x20, ranks 8, gram, 3
    sweeps), nonzeros drawn per request; every result against the same
    request served alone per-tensor (fit 1e-4, projectors 1e-3, core 1e-3 x
    max|core| after sign alignment), dispatches per tenant <= ceil(N / 16),
    each flush's launches (kernel 1 or the chain kernel as one member's
    run, kernel 2 once a member a sweep), requests/s, p50 / p99, the
    sequential loop's requests/s, peak memory, one flush alone and its busy
    share, and kernels 1-4 and the chain kernel at a flush's stacked shapes
    against their plain versions with times and bounds;
13. autotuning and snapshot/resume on phase 4's tensor, drawn anew: a cold
    ``autotune=True`` plan (one search, ``min(4, candidates)`` trials with
    the default among them, none raising; each trial's config and ms), its
    result within phase 3's tolerances of phase 4's (its bits when the pick
    is the default), kernel 1 (and 5) on the tuned schedules against their
    plain versions, a warm plan with no search and no trial, a forced
    ``"fused"`` trial that launches kernel 5, the tuned and the split warm
    sweep ms in turns; snapshots every 2 sweeps (phase 4's bits, 4 written,
    3 kept, schedules built in the first segment only, phase 4's launches),
    a kill at sweep 4 and ``tucker.resume`` (phase 4's bits, no schedule
    build), a retried segment (phase 4's bits), the overhead at 1 and 5
    sweeps a segment; and the kill and resume of a 4-way tensor at tenant
    C's shape (the chain kernel and kernel 2), its uninterrupted run's bits
    and launches;
14. sharded sparse HOOI (``TuckerSpec.shard``) in ranks spawned with
    ``torch.multiprocessing``: phase 4's tensor (drawn anew in each rank,
    its checksum held to phase 4's) over NCCL in a world of one (phase 4's
    bits, kernels 1 and 2 launched as in phase 4, the all-reduce bytes of
    a sweep worked out here); on 4 ranks over gloo sharing the card (every
    rank the same bits, phase 3's tolerances of phase 4, the imbalance,
    kernels 1 and 2 on every rank, warm sweep ms, all-reduce ms a sweep,
    kernel 1's ms on one rank's slice, peak memory per rank); tenant C's
    4-way shape on 4 ranks (the chain kernel and kernel 2 on every rank,
    within phase 3's tolerances of its unsharded run; on rank 0's slice the
    chain kernel and kernels 3 and 4 against their plain versions and each
    other); a kill at sweep 4 resumed on 4 ranks
    (the uninterrupted 4-rank bits, the 4-rank fingerprint in the manifest,
    rank 0 alone writing) and on 2 (the clamp warning, phase 3's
    tolerances);
15. float64 through the f64 instantiations of kernels 1-4 and the chain
    kernel (kernels 1 and 2 on the f64 tensor cores, DMMA: the route
    ``kron_kernel.launch_route`` names, checked against the DMMA and the
    TF32 and bf16 HMMA instructions that ``cuobjdump`` finds in each f32,
    f64 and bf16 instantiation's SASS, and the registers and CTAs an SM of
    each): each against its f64 plain version at odd shapes, and
    kernels 1 and 2 on phase 4's
    tensor (drawn anew, its checksum held to phase 4's) in f64 from phase
    4's initial factors (3 and 1 launches a sweep, ms a sweep, peak, within
    phase 3's tolerances of phase 4's f32 run); exact rank-1 tensors (the
    f64 fit error <= 1e-6), phase 3's mid tensor and tenant C's 4-way shape
    card against CPU in f64 (the f64 fit 1e-10, projectors 1e-8; at tenant
    C the chain kernel timed beside kernels 3 and 4 in f64), Table
    II's rank-16 tensor at 800^3 in f64 (dense error <= 1e-10), and one
    service flush of 16 f64 requests against each served alone; 15g kernel
    5's f64 instantiation (``fuse_core=True``): at odd 2- and 3-way shapes
    (ranks 1-17, R not a multiple of 8) against its f64 plain version, at
    NELL-2's last mode against its plain version and the split f64 core
    update (kernel 1, then kernel 2, in f64), the same bits twice, timed
    beside both; phase 4's tensor in f64 with ``fuse_core=True`` (3 + 1
    launches a sweep) held to 15b's split f64 run (f64 fit 1e-10,
    projectors and core 1e-8); one f64 autotune search with the fused
    layout timed beside the split one;
16. the paper's Kron reuse on the torch engine (torch ops, no launch) for
    the Table V tensors and tenant C's shape, against the plain torch chain
    (fit and core within 1e-6), with the share of distinct Kron rows, ms a
    sweep and peak both ways, and ``engine="cuda"`` ignoring the flag (the
    bits of the run without);
17. the service across 4 gloo ranks sharing the card (rank 0 serving
    phase 12's tenants A and C, their first 16 and 4 requests, from 4
    threads, the others
    ``serve_follower``): every result within phase 14b's tolerances of a
    world-of-one service, every follower back from ``close()``,
    requests/s, p50 / p99 and the announces' bytes and ms;
18. the contract checks (``repro_torch.analysis``) on the card: the lint
    matrix (every cell's sweeps under ``torch.cuda.set_sync_debug_mode``,
    the function mode's host-read and precision checks, the schedules'
    write disjointness and shared memory), its sharded cells on 2 gloo
    ranks sharing the card, ``TuckerPlan.lint`` and ``analyze`` on phase
    4's NELL-2 plan beside its warm sweep ms, ``TuckerPlan.lint`` on tenant
    C's 4-way shape (the chain kernel's sweeps, its cuts), and a seeded ``.item()`` in a
    sweep, which must be flagged; any finding the port's baseline
    (``repro_torch/analysis/baseline.json``) does not list fails;
19. the dense, ssm, audio, vlm and moe families at full width: qwen2-7b
    (28 layers, GQA 7), mamba2-1.3b (48 layers, N 128), musicgen-large (48
    layers, prefill from 4,096 seeded frame embeddings), internvl2-76b's
    LM cut to 8 of its 80 layers (GQA 8), granite-moe-1b-a400m whole (24
    layers, 32 experts top-8, GQA 2) and grok-1-314b cut to 6 of its 64
    layers at full width (8 experts top-2 in two d_ff shards, GQA 6;
    ``GROK_LAYERS``), seeded bf16 weights made on the
    card, batch 4, 4,096-token prompts, 16 new tokens (64 until PR 29;
    tokens/s from the warm prefill and decode steps at 64): launches per
    prefill from the counters (kernel 6 once an attention layer on the
    tensor-core route, kernel 7 once an SSM layer), prefill ms, decode ms a
    step, tokens/s, peak, busy share; kernel 6 on layer 0's inputs against
    its plain version (2^-7 x max|plain|) with SDPA's time, kernel 7 on
    every call of a warm prefill at the fp32 rule and on layer 0's inputs
    with the f64 and TF32 controls; each family's SMOKE config card
    against CPU with phase 8's tolerances;
20. Tucker-factorized layers: ``tuckerize_linear`` on an exact rank-64
    3,584 x 18,944 weight (qwen2-7b's ``wi``) at ranks (64, 64) applied to
    4 x 4,096 tokens against x @ W, and ``tuckerize_expert_stack`` on an
    exact low-rank (32, 1,024, 512) stack at ranks (8, 64, 64); relative
    errors <= 1e-4, card against CPU, ms, compression ratios;
21. the moe family and sampling: 21a layer 0's ``moe_block`` card against
    CPU in f32 on identical inputs for granite's SMOKE, grok's SMOKE with
    two expert shards and granite's at capacity factor 0.5 (pairs dropped):
    the same experts, kept pairs and slots, the output within 1e-5 x
    max|CPU|, the aux within 1e-6, the forward's logits within phase 8's
    f32 tolerance; 21b, read during phase 19's warm prefills of granite and
    grok at full width, each layer's dropped share and aux, each
    ``moe_block``'s ms and their share of the prefill, and
    ``flops.cell_cost``'s executed and useful FLOPs over the prefill time
    against the bf16 peak; 21c granite at full width sampling at T 0.8: a
    seeded CUDA generator repeats its tokens, another seed does not, every
    token below the vocabulary; 2^20 draws of one logit row held to
    softmax(row / T) by a chi-square test (p >= 1e-6);
22. training, on an emptied card: 22a the backward kernels of kernels 6
    and 7 against their plain versions at odd shapes (kernel 6 in bf16 on
    its ``"wgmma"`` route, ``csrc/flash_attention_bwd_wgmma.cu``, with TMA
    staging and, at D 28, ordinary-load staging, and in f32 on its
    ``"simt"`` route, ``csrc/flash_attention_bwd.cu``, each call checked
    to take its dtype's route; GQA 1, 3 and 8, D 16 to 128, S != T, the
    model's strided views; kernel 7, ``csrc/ssd_chunk_bwd.cu``, at L 64 to
    256, N 16 to 128, bf16 and f32 B and C), bf16 gradients within
    BF16_OUT_TOL and f32 ones at the fp32 rule, each the same bits twice,
    and kernel 6's forward log-sum-exp; 22b one train step
    of each family's SMOKE config in f32, card against CPU (loss, grad
    norm, first moments, parameters; ``TRAIN_SMOKE_TOL``), with its exact
    launches; 22c Zamba2-2.7B as registered trained by ``Trainer`` for 4
    steps of 2 x 4,096 tokens (remat "full"): exactly 2 x 9 kernel-6 and
    2 x 54 kernel-7 forward launches and 9 and 54 backward launches a
    step (every kernel-6 backward on the ``"wgmma"`` route), every
    backward call of step 1 against its plain version, the
    step-0 loss within 10% of ln(32,000), finite grad norms, moved
    parameters, ms a step, tokens/s, peak memory, the busy share of a
    profiled step, executed and useful FLOP/s (``flops.cell_cost``) over
    the bf16 peak, and each backward kernel's ms beside its plain
    version's, SDPA backward's (kernel 6) and its bound, kernel 6's
    device time by pass (delta, dK/dV, dQ) beside its design's bound, and
    both kernels' registers and spills from ptxas; 22d repro-100m at
    full width through ``python -m repro_torch.train``'s code path, 60
    steps of 8 x 128 with a checkpoint every 50 (the loss falls), then a
    run killed at step 55 that resumes at 50 with the checkpoint's bits
    and later losses within ``R100_RESUME_LOSS_TOL`` of the uninterrupted
    run's;
23. QRP gradient compression (``repro_torch.optim.compression``): 23a
    ``compress_matrix`` on the card against the same call on the CPU for
    each of granite-moe-1b-a400m's 10 layer-stacked gradient shapes at
    r = 64 (seeded gradients of rank r plus noise; the subspaces within
    1e-3, sin of the largest principal angle, which bounds the projectors'
    gap; Q P^T within 1e-3 x max|CPU|); 23b ``python -m
    repro_torch.launch.compress_bench --rank 64 --arch
    granite-moe-1b-a400m`` over 2 gloo ranks sharing the card: every output
    finite, each rank's bytes to ``all_reduce`` exactly the r (m + n) model
    (r = min(64, m, n)), both ranks the same G_hat bits, both syncs' bytes
    and ms;
24. the roofline (``repro_torch.launch.roofline``) under its ``h100-sxm``
    preset over one record a measured cell: phase 19's prefills (4 x
    4,096; the depth-cut InternVL2 and Grok cells listed as skipped) and
    phase 22c's Zamba2-2.7B train step (2 x 4,096), each with
    ``flops.cell_cost``'s FLOPs, no collective bytes on one card and the
    measured peak memory; the compute term must be ``cell_cost``'s FLOPs
    over the preset's bf16 peak, which phases 21b and 22c divide by;
25. training across ranks: 25a repro-100m at full width through ``python
    -m torch.distributed.run --standalone --nproc-per-node 2 -m
    repro_torch.train --full-100m`` (2 gloo ranks sharing the card, the
    ``(2, 1)`` host mesh, ZeRO-3 blocks of the parameters, the master copy
    and the moments) for ``R25_STEPS`` steps of 8 x 128, held to 22d's
    world-of-one history (the step-0 loss, every loss, the step-0 grad
    norm, ``R25_TOL``); both ranks the same whole parameters at the end;
    every kernel-6 launch on each rank on the ``"wgmma"`` route, exactly
    ``R25_FWD_A_STEP`` forward and ``R25_BWD_A_STEP`` backward launches a
    step; each step's collective bytes a rank exactly the count from the
    specs; ms a step, peak a rank, the collective route; 25b 2 ranks
    again (spawned, the same mesh): the first ``R25_RERUN`` steps again
    give 25a's losses and grad norms to the bit (each step's loss reads the
    parameters the step before it wrote), every kernel-6 backward call of
    those steps against its plain version (22a's rule);
    22d's last checkpoint restored at world 2 gathers back to its bits;
    25c a trainer at world 1 resumes from 25a's world-2 checkpoint with its
    bits and takes ``R25_RESUME_STEPS`` more steps within ``R25_TOL`` of
    22d's losses;
    25d repro-100m whole (12 layers, d 768, ``"cp"``, bf16) on the
    ``(2, 2)`` mesh, 4 gloo ranks sharing the card under ``RULES_TRAIN``
    (ZeRO over the data axis and TP / SP / CP over the model axis at once),
    ``R25D``'s 6 steps of 8 x 128 through the example's trainer, held to
    22d's world-1 history (the step-0 loss within ``R25DE_LOSS0_TOL``,
    every loss within ``R25_TOL``), every rank the same losses and grad
    norms, each step's bytes by kind a rank the count of
    ``collective_bytes_per_step``, every kernel-6 launch on ``"wgmma"``
    (24 forward and 12 backward a step a rank: the cp blocks, S < T on the
    ranks of model coordinate 1), 22d's last checkpoint restored on the
    mesh (two-dim specs) gathering back to its bits; 25e Zamba2-2.7B
    whole (54 Mamba-2 layers, 9 shared blocks, bf16, remat "full") on the
    ``(1, 2)`` mesh, ``R25E``'s 2 steps of 2 x 1,024, held to a world-1
    run of the same weights and batch in this process (run first and
    freed before the ranks spawn; the step-0 loss within
    ``R25DE_LOSS0_TOL``, the grad norms reported), every kernel-6 backward
    call (rank 1's cp block (2, 32, 512, 80) against 1,024 keys) and every
    kernel-7 backward call on the rank's 40 heads against its plain
    version (22a's rules, :func:`gated_backward`), the launches of each
    kernel exact, the bytes the count; both cells report ms a step by
    world, seconds in collectives, bytes staged and the peak a rank, and
    the first gated calls' inputs give the kernels line's
    ``flash_attention_bwd_cp`` and ``ssd_chunk_bwd_tp`` rows (SDPA's
    backward with the end-aligned bool mask as the library call);
26. serving across ranks with a model axis (gloo ranks sharing the card,
    spawned as phase 14's; every collective staged through the host):
    26a Qwen2-7B whole (28 layers, bf16, seeded weights, ``RULES_SERVE``,
    the config's ``"cp"``) on the ``(1, 2)`` mesh, each rank holding its
    tensor-parallel blocks, 4 prompts of 1,024 tokens, a budget of 2,048
    and 4 decode steps fed world 1's greedy tokens; world 1 is
    ``Engine(mesh=None)`` on the same weights in this process, first. Both
    ranks' last-token prefill logits and every decode step's within
    ``R26_TOL`` x max|logit| of world 1's, the same bits on every rank, a
    warm prefill the cold one's bits; every kernel-6 call of each rank's
    gated prefill (a cp query block against the keys up to its end: S < T
    on rank 1) against its plain version (the bf16 rule), exactly one
    launch a layer a prefill and none a decode step; that call's inputs
    timed alone (the kernels line's ``flash_attention_cp`` row, SDPA with
    the end-aligned mask as the library call). 26b granite-moe-1b-a400m
    whole on the ``(2, 2)`` mesh (4 ranks; expert parallel over the model
    axis, the expert stacks' data blocks gathered a layer), 4 x 256
    prompts, 2 decode steps, at ``capacity_factor`` 8 (no pair dropped on
    either mesh) held to world 1 the same way; an ``Engine.generate`` of 2
    tokens on every rank (the same tokens on all); each rank's dropped
    share a layer at the registered 1.25. 26c Zamba2-2.7B whole (54 Mamba
    layers and 9 shared blocks, bf16, seeded weights, ``RULES_SERVE``, its
    ``"cp"``) on the ``(1, 2)`` mesh, each rank its 40 of the 80 SSM heads
    (its column blocks of ``wz``, ``wx``, ``wb``, ``wc``, ``wdt``, its
    channels of the conv, the gated RMSNorm over a cut ``d_inner``, ``wo``'s
    row block) and the shared block's attention through kernel 6 at D 80,
    4 x 1,024 prompts (4 SSD chunks of 256), a budget of 1,280 and 2 decode
    steps fed world 1's greedy tokens; 26d Mamba2-1.3B at full width cut to
    12 of its 48 layers on ``(1, 2)``, 4 x 512 prompts, 4 decode steps, in
    bf16 and again in f32 (26d-f32). 26c and 26d-f32 are held to world 1 as 26a is; 26d's bf16
    logits are reported, not gated: the random weights carry a rounding's
    change through 48 Mamba layers chaotically (world 1 moves as far under
    the control below). In all three the first Mamba layer's output of the
    prefill and of every decode step, on the same inputs and before any
    chaos, is held to the control's (the bf16 rule; a bf16 decode step the
    bf16-operand rule, ``R26_DECODE_PRECISION``): world 1 with its ``wo``
    products rounded as the mesh rounds them
    (``_mesh_rounding_at_world_one``); every kernel-7 call of each rank's gated prefill
    (``(4 x heads / 2, chunks, 256, 64)``) against its plain version (the
    fp32 rule), exactly one launch a Mamba layer a prefill and none in a
    decode step; 26c's kernel-6 calls against their plain version (the
    bf16 rule); 26c rank 1's first kernel-7 call and first S < T kernel-6
    call timed alone (the kernels line's ``ssd_chunk_tp`` and
    ``flash_attention_cp_d80`` rows). Reported: prefill ms and decode ms
    a step at world 1 and on the mesh, collective bytes by kind and seconds
    a rank, peak a rank, the greedy tokens that agree;
27. one JSON line per phase, the kernels line (the f64 instantiations in
    rows of their own, then the chain kernel's bf16 route, then the two
    backward kernels, then kernel 6 at 26a's cp block's S < T, kernel 6 at
    26c's, kernel 7 on 26c's rank's heads; kernels 3 and 4's launches are
    those of the unfused route, ``fused=False``, which the default order
    >= 4 path no longer takes), then the device line.

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda), and the
checkout's ``src/`` beside this file. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import Optional

# Path A holds a 51 GB contrib per mode whose size changes from mode to
# mode; without expandable segments the caching allocator splits the freed
# 51 GB block for small tensors and cannot hand it out whole again (an
# out-of-memory error on the second mode with 47 GiB reserved but free).
# Set before torch is imported, which reads it once.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.launch.roofline import ARCH_PRESETS  # noqa: E402
except ImportError:
    sys.exit("chip_smoke: src/repro_torch is not beside this script")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the f32 CUDA-core rate
# and the dense bf16 and TF32 tensor-core rates; HBM and bf16 are read from
# repro_torch.launch.roofline's "h100-sxm" preset. Kernel 6 on bf16 operands
# runs on the tensor cores and its bound counts them at the bf16 rate;
# kernels 1's and 5's fp32 products run on the tensor cores (3xTF32) and
# their bounds count them at the TF32 rate, their bf16_fp32acc products
# (bf16 m16n8k16) at the bf16 rate; the chain kernel's products run on TF32 under both
# precisions (3xTF32, 2xTF32); kernel 7's bound counts C B^T on bf16
# operands at the bf16 rate and its other products (3xTF32) as three
# products at the TF32 rate; every other kernel does its arithmetic in f32
# on the CUDA cores.
PEAK_BYTES_PER_S = ARCH_PRESETS["h100-sxm"].hbm_bw
PEAK_F32_FLOPS = 67e12
# f64: the card's peak (the DMMA tensor cores, where kernels 1, 2 and 5 run
# their f64 products), which every f64 bound counts; and the CUDA cores',
# where kernels 3 and 4 and the chain kernel run theirs, for each f64 row's
# "f64_core_bound_ms" beside its bound
PEAK_F64_FLOPS = 67e12
PEAK_F64_CORE_FLOPS = 34e12
PEAK_BF16_FLOPS = ARCH_PRESETS["h100-sxm"].peak_flops
PEAK_TF32_FLOPS = 495e12

NELL2_SHAPE = (12092, 9184, 28818)
NELL2_NNZ = 76_879_419
NELL2_RANKS = (16, 16, 16)
NIPS_SHAPE = (2482, 2862, 14036, 17)  # frostt.io/tensors/nips
NIPS_NNZ = 3_101_609
NIPS_RANKS = (16, 16, 16, 16)
# phase 6's peak: the schedules, factors and unfoldings of the NIPS sweep on
# the chain kernel (55.28 GB while kernels 3 and 4 wrote a (nnz, K) contrib)
PHASE6_PEAK_GB = 5.0
N_ITER = 5
WARM_RUNS = 5  # warm NELL-2 decompositions timed in phase 4
SEED = 0

# Tolerances, as a fraction of max|plain|:
# fp32: kernel and plain form the same rounded terms (a*b, then *v) and
#   differ only in the order of their f32 sums (the kernel sums each output
#   in slot order, index_add_ in atomic order, cuBLAS in its own blocks).
#   Two orders of n terms drift apart like a random walk of about sqrt(n)
#   roundings of 2^-24 each, and with cancellation that drift is measured
#   against an output far smaller than its terms: at NELL-2 size (8.4 K
#   terms per row) it reached 6.6e-6 x max|plain|. So the limit is
#   1e-5, raised to 4 sqrt(n) 2^-24 where n, the most terms summed into one
#   output, makes that larger (2.2e-5 at 8.4 K terms).
# bf16_fp32acc: the plain versions keep the reference's roundings: each
#   product a*b of the bf16 operands rounded to bf16, then scaled by the f32
#   value and summed in f32. Kernel 3 rounds as they do (the CUDA cores)
#   and agrees as closely as fp32 does. Kernels 1 and 5 (bf16 m16n8k16:
#   a * (v b split into bf16 hi + lo)) and the chain kernel (2xTF32: f_1 *
#   (v f_2 ... split into two TF32 parts)) give that rounding up on
#   purpose: their terms are a*b*v to ~2^-16 and ~2^-21, up to 2^-8 (one
#   bf16 rounding) of a term from the plain version's, unbiased, so over n
#   terms of one sign the sums differ by far less than 2^-8 of max|plain|
#   and with cancellation by ~sqrt(n) 2^-8 of a term. 2e-2 is the bound the
#   reference's own kernel tests set for bf16 operands, kept as the stated
#   limit; phases 2, 4 and 6 report the worst error as a share of it, and
#   phases 2, 4, 5 and 6 hold these three kernels to the exact sum of their
#   terms (nearer_exact).
TOL = {"fp32": 1e-5, "bf16_fp32acc": 2e-2}
# "fp64" (the f64 instantiations): on the CUDA cores the same rounded terms
#   as the plain version, summed in another order, as fp32; kernels 1 and 5
#   on DMMA form fma(round(v a), b, acc) where the plain version rounds
#   round(round(a b) v), one f64 ulp of each term apart, which over n
#   terms is at most ~n 2^-52 |term| (<= 2^-52 max|plain| when the terms
#   share a sign) and ~sqrt(n) 2^-52 |term| when they do not, as the fp32
#   route's 3xTF32 terms meet the fp32 rule; kernel 2 and kernel 5's rounds
#   on DMMA sum the products in their own order. So max(1e-13, 4 sqrt(n)
#   2^-53) x max|plain| for n terms summed into one output.
TOL_F64 = 1e-13
# "bf16" (kernel 6 on bf16 operands): the kernel and its plain version each
# round their f32 output to bf16, so they can land one bf16 ulp (2^-8
# relative) apart; 2^-7 x max|plain| leaves room for the f32 differences
# beneath that rounding.
BF16_OUT_TOL = 2.0 ** -7

# device-side symbols of each wrapper's kernels, for the profiler's sums; the
# leading "::" keeps "::ttm_kernel" from matching the megakernel's
# "kron_scatter_ttm_kernel"
KERNEL_SYMBOLS = {
    "fused_kron_scatter": ("::kron_scatter_kernel",),
    "ttm": ("::ttm_kernel",),
    "kron_contrib": ("::kron_contrib_kernel",),
    "scatter_rows": ("::scatter_rows_kernel",),
    "fused_kron_scatter_ttm": ("::kron_scatter_ttm_kernel", "::kron_scatter_ttm_reduce_kernel"),
    "flash_attention": ("::flash_attention_kernel", "::flash_attention_wgmma_kernel"),
    "ssd_chunk": ("::ssd_chunk_kernel",),
    "flash_attention_bwd": ("::dkdv_kernel", "::dq_kernel", "::bwd_prep_kernel",
                            "::dkdv_wgmma_kernel", "::dq_wgmma_kernel"),
    "ssd_chunk_bwd": ("::ssd_bwd_cols_kernel", "::ssd_bwd_rows_kernel"),
    "fused_kron_chain_scatter": ("::chain_scatter_kernel", "::chain_combine_kernel"),
    # kernel 6's backward by pass, for 22c
    "flash_attention_bwd dK/dV": ("::dkdv_kernel", "::dkdv_wgmma_kernel"),
    "flash_attention_bwd dQ": ("::dq_kernel", "::dq_wgmma_kernel"),
    "flash_attention_bwd delta": ("::bwd_prep_kernel",),
}
NO_LM_LAUNCHES = {"flash_attention": 0, "ssd_chunk": 0}


# numbers one phase hands to a later one (phase 4's sweep ms for phase 18)
RECORDED: dict = {}


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    log(f"phase 1: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc in parallel: " + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(secs.items())) + ")")
    for name in _build.SOURCES:
        kernel = ""  # the kernel and template arguments the next lines are of
        for line in (_build.BUILD_DIR / f"{name}.ptxas.log").read_text().splitlines():
            m = re.search(r"Function properties for \S*?\d([a-z][a-z_]*_kernel)(I\S{0,40})?", line)
            if m:
                kernel = m.group(1) + (m.group(2) or "")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")
    log_occupancy(dev)
    start_sass_dumps()  # read by phase 15

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("2 kernels", phase2_kernels, dev)
    timed("3 card vs CPU", phase3_mid, dev)
    kernels, coo, split_res, split_peak = timed("4 NELL-2", phase4_nell2, dev, card)
    # phase 13 draws this tensor anew and holds its runs to these bits
    ref4 = {"checksum": coo_checksum(coo), "fit": split_res.fit_history.copy(),
            "factors": [f.cpu() for f in split_res.factors], "core": split_res.core.cpu()}
    kernels.update(timed("5 path B", phase5_fused_core, dev, card, coo, split_res, split_peak))
    del coo, split_res
    release_memory()
    kernels.update(timed("6 path A", phase6_nips, dev, card))
    release_memory()
    timed("7 LM kernels", phase7_lm_kernels, dev)
    timed("8 SMOKE card vs CPU", phase8_smoke_card_vs_cpu, dev)
    kernels.update(timed("9 Zamba2 serving", phase9_zamba2, dev, card))
    timed("10 Table V", phase10_table5, dev, card)
    timed("11 dense HOOI and completion", phase11_dense, dev, card)
    timed("12 Tucker service", phase12_service, dev, card)
    timed("13 autotuning and snapshots", phase13_autotune_snapshots, dev, card, ref4)
    timed("14 sharded", phase14_sharded, dev, card, ref4)
    kernels.update(timed("15 float64", phase15_float64, dev, card, ref4))
    timed("16 Kron reuse", phase16_kron_reuse, dev, card)
    timed("17 sharded service", phase17_sharded_service, dev, card)
    timed("18 contract checks", phase18_contracts, dev, card, ref4)
    timed("19 LM families", phase19_families, dev, card)
    timed("20 Tucker layers", phase20_tucker_layers, dev, card)
    timed("21 moe and sampling", phase21_moe_sampling, dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as train_tmp:
        kernels.update(timed("22 training", phase22_training, dev, card, train_tmp))
        timed("23 gradient compression", phase23_compression, dev, card)
        timed("24 roofline", phase24_roofline, dev, card)
        timed("25 training across ranks", phase25_train_ranks, dev, card, train_tmp)
        kernels.update(timed("25d/25e training with a model axis", phase25_model_axis, dev,
                             card, train_tmp))
    kernels.update(timed("26 serving across ranks", phase26_serve_ranks, dev, card))
    print(json.dumps({"kernels": [kernels[k] for k in list(wrappers()) + F64_ROWS
                                  + ["fused_kron_scatter_bf16", "fused_kron_scatter_ttm_bf16",
                                     "fused_kron_chain_scatter_bf16", "flash_attention_bwd",
                                     "ssd_chunk_bwd", "flash_attention_cp",
                                     "flash_attention_cp_d80", "ssd_chunk_tp",
                                     "flash_attention_bwd_cp", "ssd_chunk_bwd_tp"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# -- helpers -----------------------------------------------------------------


def synced(out):
    """``out`` after the card has finished the launch that made it, so a
    fault in that launch surfaces here."""
    torch.cuda.synchronize()
    return out


def limit_of(want, precision: str, n_terms: int):
    """(limit, tol, max|plain|) for outputs ``want`` of a plain version
    under TOL or, for ``precision="bf16"``, BF16_OUT_TOL (see there);
    ``n_terms`` is the most terms summed into one output."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    if precision == "fp64":  # the f64 instantiations: f64 in, f64 out
        tol = max(TOL_F64, 4 * n_terms ** 0.5 * 2.0 ** -53)
    else:
        tol = BF16_OUT_TOL if precision == "bf16" else TOL[precision]
    if precision == "fp32":
        tol = max(tol, 4 * n_terms ** 0.5 * 2.0 ** -24)
    return tol * max(scale, 1e-30), tol, scale


def against_plain(got, want, precision: str, n_terms: int):
    """(max abs error, limit, tol, max|plain|, within) of ``got`` against
    ``want`` under :func:`limit_of`'s limit."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    limit, tol, scale = limit_of(want, precision, n_terms)
    same_dtype = precision != "fp64" or got.dtype == want.dtype == torch.float64
    return (err, limit, tol, scale,
            same_dtype and bool(torch.isfinite(got).all()) and err <= limit)


def compare(name: str, precision: str, got, want, n_terms: int) -> float:
    """Max abs error of ``got`` against ``want``, checked by
    :func:`against_plain`."""
    torch.cuda.synchronize()
    err, limit, tol, scale, ok = against_plain(got, want, precision, n_terms)
    log(f"  {name} [{precision}]: max_abs_err {err:.3e} <= {limit:.3e} "
        f"(tol {tol:.3g} x max|plain| {scale:.3e}, {n_terms} terms) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} [{precision}] disagrees with its plain version")
    return err


def share_of_limit(name: str, precision: str, got, want, n_terms: int) -> float:
    """:func:`compare`, returning the error as a share of its limit."""
    return compare(name, precision, got, want, n_terms) / limit_of(want, precision, n_terms)[0]


def bf16_exact_kron_scatter(fa, fb, sched, n_rows: int):
    """Kernel 1's bf16_fp32acc terms unrounded and summed in f64: the bf16
    operands' products (exact in f64) times the value, through the f64 plain
    version."""
    from repro_torch.kernels import kron_kernel

    return kron_kernel.fused_kron_scatter_plain(
        fa.bfloat16().double(), None if fb is None else fb.bfloat16().double(), sched, n_rows)


def bf16_exact_kron_scatter_ttm(fa, fb, u, sched, n_rows: int):
    """Kernel 5's bf16_fp32acc result from unrounded terms in f64: U rounded
    to bf16, times :func:`bf16_exact_kron_scatter`'s Y."""
    return u.bfloat16().double().T @ bf16_exact_kron_scatter(fa, fb, sched, n_rows)


def bf16_exact_chain_scatter(factors, sched, n_rows: int):
    """The chain kernel's bf16_fp32acc terms in f64: f_1 and f_2 rounded to
    bf16 (their product exact), the value and later factors f32, the terms
    formed and summed in f64 by the f64 plain version."""
    from repro_torch.kernels import kron_kernel

    return kron_kernel.fused_kron_chain_scatter_plain(
        [f.bfloat16().double() if c < 2 else f.double() for c, f in enumerate(factors)],
        sched, n_rows)


def nearer_exact(name: str, got, plain, exact) -> None:
    """Check a bf16_fp32acc kernel that keeps each product of its bf16
    operands (the routes of kernels 1 and 5 and the chain kernel) against ``exact``,
    the f64 sum of those terms: no further from it than its plain version
    (which rounds each product to bf16) is, plus BF16_EXACT_SLACK x
    max|exact| for its f32 sums. A kernel that lost the split of v b (a
    term rounded once to bf16) is as far off as the plain version and
    fails here, where the 2e-2 limit against the plain version cannot see
    it."""
    torch.cuda.synchronize()
    d_got = float((got.double() - exact).abs().max())
    d_plain = float((plain.double() - exact).abs().max())
    slack = BF16_EXACT_SLACK * float(exact.abs().max())
    ok = bool(torch.isfinite(got).all()) and d_got <= d_plain + slack
    log(f"  {name} [bf16_fp32acc] against the exact sum of its terms: {d_got:.3e} <= plain's "
        f"{d_plain:.3e} + {slack:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} [bf16_fp32acc] is further from the exact sum than its plain version")


# nearer_exact's room for the kernels' f32 sums (up to ~sqrt(n) 2^-24 of a
# term over n terms, ~5e-6 of max|exact| at NELL-2's 8.4 K terms a row; the
# kernels' terms ~2^-16 of themselves), x max|exact|, as
# tests/test_torch_bf16_route.py's SUM_SLACK
BF16_EXACT_SLACK = 2.0 ** -14


def time_ms(fn, reps: int = 5, flush_l2: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events; optionally with L2 flushed before each."""
    junk = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if flush_l2 else None
    fn()
    times = []
    for _ in range(reps):
        if junk is not None:
            junk.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def profile_run(fn) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_kernels": sum(n for _, n in by_name.values()),
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, (ms, n) in top],
           "kernel_ms": {
               name: sum(ms for k, (ms, _) in by_name.items() if any(p in k for p in pats))
               for name, pats in KERNEL_SYMBOLS.items()}}
    log(f"  profile of a warm run: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
        + ("" if by_name else " (the profiler saw no device events)"))
    for row in out["top"]:
        log(f"    {row['ms']:9.3f} ms {row['count']:5d}x  {row['kernel']}")
    return out


def host_launch_us(dev, n: int = 2000) -> float:
    """Host microseconds per call of a one-element torch op on the card (the
    dispatch and launch that each of QRP's small kernels pays), over ``n``
    calls after a warm-up."""
    x = torch.zeros(1, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def check_ttm_call(label: str, y, u, precision: str):
    """``ttm`` on the card: one device kernel per call (counted where the C
    side launches it), and the same bits from two calls on the same inputs.
    Returns the first result."""
    from repro_torch.kernels import kron_kernel, ttm_kernel

    before = ttm_kernel.kernels_launched()
    first = synced(ttm_kernel.ttm(y, u, precision=precision))
    n = ttm_kernel.kernels_launched() - before
    again = synced(ttm_kernel.ttm(y, u, precision=precision))
    log(f"  ttm {label} [{precision}]: {n} kernel launch per call, bulk copies "
        f"{ttm_kernel.bulk_copies(*kron_kernel._cast_operands(precision, y, u))}, "
        f"same bits twice: {torch.equal(first, again)}")
    check(n == 1, f"ttm {label} [{precision}] launched {n} kernels, want 1")
    check(torch.equal(first, again), f"ttm {label} [{precision}] differs between two calls")
    return first


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``flops`` operations at ``peak_flops`` (the f32
    CUDA-core rate unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kron_scatter_flops(nnz: int, ra: int, k: int) -> int:
    """Operations kernel 1's function needs for ``nnz`` slots of K output
    columns: Y[row] += v (a (x) b) scales a's ``ra`` entries by v once, then
    K fused multiply-adds (2-way, ra=0: K products with v and K adds)."""
    return nnz * (2 * k + ra)


def kron_contrib_flops(n: int, ka: int, kb: int, scaled: bool = True) -> int:
    """Operations of ``n`` Kron rows v (a (x) b): the shorter operand scaled
    by v once, then ka kb products; no scaling for a link whose v is ones."""
    return n * ((min(ka, kb) if scaled else 0) + ka * kb)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_scatter_work(sched, factors, n_rows: int, nnz: int, elem: int = 4):
    """(bytes, operations) the order >= 4 unfolding of one mode must move
    and do, as the chain kernel reads its inputs: the slot coordinates,
    values, rows and cuts and the ``factors`` (as cast) once each, Y_(n)
    written once (``elem`` bytes an entry); for each of the ``nnz`` real
    slots v f_1 (R_1 products), its B row f_2 (x) ... (K_B (N - 3)
    products) and K fused multiply-adds."""
    k = 1
    for f in factors:
        k *= f.shape[1]
    r0 = factors[0].shape[1]
    nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.chain_cuts,
                        *factors) + n_rows * k * elem)
    return nbytes, nnz * (2 * k + r0 + (len(factors) - 2) * (k // r0))


def wrappers() -> dict:
    """Each kernel's wrapper, by kernel name; each counts its launches."""
    from repro_torch.kernels import flash_attention, kron_kernel, ssd_scan, ttm_kernel

    return {"fused_kron_scatter": kron_kernel.fused_kron_scatter, "ttm": ttm_kernel.ttm,
            "kron_contrib": kron_kernel.kron_contrib, "scatter_rows": kron_kernel.scatter_rows,
            "fused_kron_scatter_ttm": kron_kernel.fused_kron_scatter_ttm,
            "flash_attention": flash_attention.flash_attention, "ssd_chunk": ssd_scan.ssd_chunk,
            "fused_kron_chain_scatter": kron_kernel.fused_kron_chain_scatter}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def release_memory() -> None:
    """Drop cached plans (and their schedules) and return freed blocks."""
    from repro_torch import tucker

    tucker.clear_plan_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def chain_plain(rows, vals, sched, n_rows: int, precision: str, step: int = 0):
    """The order >= 4 unfolding through the plain versions alone, on slot
    chunks of ``step`` slots (all at once for 0), so that the full-size
    contrib is never formed: the same Kron rows and the same sums as
    kron_contrib -> kron_contrib -> scatter_rows."""
    from repro_torch.kernels import kron_kernel
    from repro_torch.sparse.layout import slot_rows

    k = 1
    for r in rows:
        k *= r.shape[1]
    out = torch.zeros((sched.n_row_blocks * sched.bi, k), device=vals.device,
                      dtype=kron_kernel.result_dtype(rows[0].dtype, precision))
    slots = slot_rows(sched)
    step = step or vals.shape[0]
    for s in range(0, vals.shape[0], step):
        c = kron_kernel.kron_contrib_plain(rows[0][s:s + step], rows[1][s:s + step],
                                           vals[s:s + step], precision=precision)
        for extra in rows[2:]:
            c = kron_kernel.kron_contrib_plain(c, extra[s:s + step].to(c.dtype),
                                               torch.ones_like(vals[s:s + step], dtype=c.dtype))
        out.index_add_(0, slots[s:s + step], c)
    return kron_kernel._mask_unvisited(out[:n_rows], sched)


def kron_factors(fs, mode):
    """Kernel 1's two factor matrices for ``mode`` (the second None for a
    2-way tensor), in the order of the schedule's slot coordinates."""
    from repro_torch.sparse.layout import operand_modes

    modes = operand_modes(len(fs), mode)
    return fs[modes[0]], (fs[modes[1]] if len(modes) > 1 else None)


def max_row_count(coo, mode) -> int:
    """The most nonzeros that share one mode-``mode`` coordinate: the most
    terms the unfolding sums into one output."""
    return int(torch.bincount(coo.indices[:, mode].long()).max()) if coo.nnz else 0


def schedule_of(coo, mode):
    from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout

    return DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo)


# -- phase 2 -----------------------------------------------------------------


def phase2_kernels(dev) -> None:
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import row_parts

    log("phase 2: kernels against their plain versions, odd shapes")
    rng = np.random.default_rng(SEED)
    worst = {p: 0.0 for p in TOL}  # kernel 1's worst error over its limit

    def coo_of(shape, idx, vals):
        return SparseCOO.from_parts(idx.astype(np.int32), vals.astype(np.float32),
                                    shape, device=dev)

    cases = []
    shape = (50, 40, 30)
    idx = np.stack([rng.integers(0, s, 1000) for s in shape], 1)
    cases.append(("nnz 1000 (not a multiple of 128), ranks 5x3", coo_of(
        shape, idx, rng.standard_normal(1000)), (4, 3, 5)))
    dup = np.concatenate([idx[:300], idx[:300], idx[:77]])
    cases.append(("duplicate coordinates", coo_of(shape, dup, rng.standard_normal(677)),
                  (4, 3, 5)))
    base = coo_of(shape, idx[:500], rng.standard_normal(500))
    cases.append(("explicit zero padding rows", base.pad_to(631), (4, 3, 5)))
    one = np.stack([np.full(700, 777), rng.integers(0, 200, 700), rng.integers(0, 90, 700)], 1)
    cases.append(("one slice, most row blocks empty", coo_of(
        (1000, 200, 90), one, rng.standard_normal(700)), (6, 5, 7)))
    cases.append(("ranks 33x40, K over six 32-lane tiles", coo_of(
        shape, idx, rng.standard_normal(1000)), (4, 40, 33)))
    big = (300, 200, 100)
    cases.append(("ranks 16, 20,000 nnz, many chunks a range", coo_of(
        big, np.stack([rng.integers(0, s_, 20000) for s_ in big], 1),
        rng.standard_normal(20000)), (16, 16, 16)))
    cases.append(("ranks 13x22x10, factor rows padded to 16 bytes", coo_of(
        shape, idx, rng.standard_normal(1000)), (13, 22, 10)))
    # ranks 1 and 17 (R not a multiple of 8): the m16 tiles' and the k16
    # blocks' tails of the bf16 tensor-core route
    cases.append(("ranks 17x1x9, m16 and k16 tails", coo_of(
        shape, idx, rng.standard_normal(1000)), (17, 1, 9)))
    cases.append(("ranks 2x7x17, m16 and k16 tails", coo_of(
        shape, idx, rng.standard_normal(1000)), (2, 7, 17)))
    two = np.stack([rng.integers(0, 300, 900), rng.integers(0, 200, 900)], 1)
    cases.append(("2-way tensor", coo_of((300, 200), two, rng.standard_normal(900)), (6, 4)))
    # row 0 of the first 128-row group gets a range of its own (5,000 slots),
    # and the group's padding (it aliases row 0) lands in row 5's range.
    alias_rows = np.concatenate([np.zeros(5000), np.full(300, 3), np.full(301, 5),
                                 rng.integers(200, 400, 700)])
    alias = coo_of((400, 30, 20), np.stack(
        [alias_rows, rng.integers(0, 30, alias_rows.size), rng.integers(0, 20, alias_rows.size)],
        1), rng.standard_normal(alias_rows.size))
    cases.append(("row 0 and its group's padding in different ranges", alias, (4, 3, 5)))
    for label, coo, ranks in cases:
        fs = [torch.randn(s, r, device=dev) for s, r in zip(coo.shape, ranks)]
        for mode in range(coo.ndim):
            sched = schedule_of(coo, mode)
            n_rows = coo.shape[mode]
            rows, vals = ops._gathered_block_rows(coo.indices, coo.values, fs, mode,
                                                  sched, coo.ndim)
            fa, fb = kron_factors(fs, mode)
            n_terms = max_row_count(coo, mode)
            tag = f"{label} mode {mode} ({rows[0].shape[1]}x{rows[1].shape[1]})"
            for prec in ("fp32", "bf16_fp32acc"):
                got = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows, precision=prec))
                want = synced(kron_kernel.fused_kron_scatter_plain(fa, fb, sched, n_rows,
                                                                   precision=prec))
                worst[prec] = max(worst[prec], share_of_limit(f"fused_kron_scatter {tag}", prec,
                                                              got, want, n_terms))
                if prec == "bf16_fp32acc":
                    nearer_exact(f"fused_kron_scatter {tag}", got, want,
                                 synced(bf16_exact_kron_scatter(fa, fb, sched, n_rows)))
                again = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows,
                                                              precision=prec))
                check(torch.equal(got, again), f"fused_kron_scatter {tag} differs between two "
                      f"runs")
                contrib = synced(kron_kernel.kron_contrib(rows[0], rows[1], vals, precision=prec))
                compare(f"kron_contrib {tag}", prec, contrib, synced(
                    kron_kernel.kron_contrib_plain(rows[0], rows[1], vals, precision=prec)), 1)
                compare(f"scatter_rows {tag} of the {prec} contrib", "fp32",
                        synced(kron_kernel.scatter_rows(contrib, sched, n_rows)),
                        synced(kron_kernel.scatter_rows_plain(contrib, sched, n_rows)), n_terms)
                compare(f"fused=False chain against kernel 1, {tag}", prec, synced(
                    ops.sparse_ttm_chain_device(coo.indices, coo.values, fs, mode, sched,
                                                shape=coo.shape, fused=False, precision=prec)),
                    got, n_terms)
                g_want = synced(kron_kernel.fused_kron_scatter_ttm_plain(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                g = synced(kron_kernel.fused_kron_scatter_ttm(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                compare(f"fused_kron_scatter_ttm {tag}", prec, g, g_want, coo.nnz)
                if prec == "bf16_fp32acc":
                    nearer_exact(f"fused_kron_scatter_ttm {tag}", g, g_want, synced(
                        bf16_exact_kron_scatter_ttm(fa, fb, fs[mode], sched, n_rows)))
                again = synced(kron_kernel.fused_kron_scatter_ttm(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                check(torch.equal(g, again), f"fused_kron_scatter_ttm {tag} differs "
                      f"between two runs")
                if coo is alias:  # the segmented sums under other row-aligned splits
                    for n_parts in (1, 2, 3, 7):
                        sp = dataclasses.replace(sched, parts=row_parts(sched, n_parts))
                        label2 = f"{tag}, {int(sp.parts.numel()) - 1} ranges"
                        worst[prec] = max(worst[prec], share_of_limit(
                            f"fused_kron_scatter {label2}", prec, synced(
                                kron_kernel.fused_kron_scatter(fa, fb, sp, n_rows,
                                                               precision=prec)),
                            want, n_terms))
                        compare(f"scatter_rows {label2}", "fp32",
                                synced(kron_kernel.scatter_rows(contrib, sp, n_rows)),
                                synced(kron_kernel.scatter_rows_plain(contrib, sp, n_rows)),
                                n_terms)
                        compare(f"fused_kron_scatter_ttm {label2}", prec, synced(
                            kron_kernel.fused_kron_scatter_ttm(fa, fb, fs[mode], sp, n_rows,
                                                               precision=prec)),
                            g_want, coo.nnz)
            if coo is alias and mode == 0:
                parts = sched.parts.tolist()
                first_pad = int(torch.nonzero(sched.valid[:5632] == 0).min())
                check(parts[1] <= 5000 < first_pad and first_pad not in parts,
                      f"alias case: ranges {parts[:4]}, first padding slot {first_pad}")
    # an order-5 tensor: kron_contrib chained three times, then scatter_rows;
    # its core update is that chain followed by the TTM kernel.
    shape5, ranks5 = (30, 20, 10, 8, 6), (3, 2, 4, 2, 3)
    coo5 = coo_of(shape5, np.stack([rng.integers(0, s, 2000) for s in shape5], 1),
                  rng.standard_normal(2000))
    fs5 = [torch.randn(s, r, device=dev) for s, r in zip(shape5, ranks5)]
    for mode in range(5):
        sched = schedule_of(coo5, mode)
        rows, vals = ops._gathered_block_rows(coo5.indices, coo5.values, fs5, mode, sched, 5)
        n_terms = max_row_count(coo5, mode)
        for prec in ("fp32", "bf16_fp32acc"):
            y = synced(ops.sparse_ttm_chain_device(coo5.indices, coo5.values, fs5, mode, sched,
                                                   shape=shape5, precision=prec))
            y_plain = synced(chain_plain(rows, vals, sched, shape5[mode], prec))
            compare(f"order-5 chain mode {mode}", prec, y, y_plain, n_terms)
            compare(f"order-5 core update mode {mode}", prec, synced(ops.sparse_ttm_core_device(
                coo5.indices, coo5.values, fs5, mode, sched, shape=shape5, precision=prec)),
                synced(ttm_kernel.ttm_plain(y_plain.T, fs5[mode].T, precision=prec).T),
                coo5.nnz)
    chain_worst = phase2_chain_kernel(dev, rng)
    for l_, i_, r_, transposed in ((15, 1000, 3, True), (256, 28818, 16, True),
                                   (100, 300, 17, False), (8, 8, 8, False)):
        if transposed:  # the path's views: y = Y_(N)^T, u = U_N^T
            y = torch.randn(i_, l_, device=dev).T
            u = torch.randn(i_, r_, device=dev).T
        else:
            y = torch.randn(l_, i_, device=dev)
            u = torch.randn(r_, i_, device=dev)
        for prec in ("fp32", "bf16_fp32acc"):
            label = f"y ({l_}, {i_}){' transposed' if transposed else ''} u ({r_}, {i_})"
            compare(f"ttm {label}", prec, check_ttm_call(label, y, u, prec),
                    synced(ttm_kernel.ttm_plain(y, u, precision=prec)), i_)
    log("  worst error against the plain version as a share of its limit: " + ", ".join(
        f"{name} [{p}] {w[p]:.3g}" for name, w in (("fused_kron_scatter", worst),
                                                  ("fused_kron_chain_scatter", chain_worst))
        for p in TOL))


def phase2_chain_kernel(dev, rng) -> dict:
    """The chain kernel at odd 4- to 6-way shapes: ranks 16 (K 4,096, NIPS's),
    odd ranks, two m16 tiles, duplicates, explicit zero padding, one slice,
    a heavy row 0 whose group's padding lies far from it; short ranges
    (``slots_per_part``) so that rows span several warps. In fp32,
    bf16_fp32acc and f64, each against its plain version and against the
    chain of kernels 3 and 4 (``fused=False``), and the same bits twice;
    bf16_fp32acc also against the exact sum of its terms. Returns the worst
    error against the plain version as a share of its limit, by precision
    (f32 factors)."""
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops
    from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout, operand_modes

    def coo_of(shape, nnz, idx=None):
        idx = np.stack([rng.integers(0, s_, nnz) for s_ in shape], 1) if idx is None else idx
        return SparseCOO.from_parts(idx.astype(np.int32), rng.standard_normal(idx.shape[0]),
                                    shape, device=dev)

    base = np.stack([rng.integers(0, s_, 2000) for s_ in (40, 30, 20, 7)], 1)
    one = np.stack([np.full(700, 777), rng.integers(0, 200, 700), rng.integers(0, 90, 700),
                    rng.integers(0, 5, 700)], 1)
    alias_rows = np.concatenate([np.zeros(5000), np.full(300, 3), np.full(301, 5),
                                 rng.integers(200, 400, 700)])
    alias = np.stack([alias_rows] + [rng.integers(0, s_, alias_rows.size) for s_ in (30, 20, 7)],
                     1)
    cases = [
        ("4-way ranks 5x4x3x2", coo_of((40, 30, 20, 7), 3000), (5, 4, 3, 2), 1024),
        ("4-way ranks 16 (K 4,096), rows over many ranges", coo_of((60, 50, 40, 10), 20000),
         (16, 16, 16, 16), 100),
        ("4-way ranks 33x5x4x3, two m16 tiles", coo_of((70, 60, 50, 40), 4000), (33, 5, 4, 3),
         256),
        ("4-way ranks 1x17x3x7, m16 and n8 tails", coo_of((50, 40, 30, 20), 3000),
         (1, 17, 3, 7), 64),
        ("4-way duplicates and explicit zero padding",
         coo_of((40, 30, 20, 7), 0, np.concatenate([base, base[:500]])).pad_to(2631),
         (4, 3, 5, 2), 64),
        ("4-way one slice, most row blocks empty", coo_of((1000, 200, 90, 5), 0, one),
         (6, 5, 7, 3), 128),
        ("4-way row 0 heavy, its group's padding in another range",
         coo_of((400, 30, 20, 7), 0, alias), (4, 3, 5, 2), 128),
        ("5-way ranks 3x2x4x2x3", coo_of((30, 20, 10, 8, 6), 2000), (3, 2, 4, 2, 3), 37),
        ("6-way ranks 2-3", coo_of((10, 9, 8, 7, 6, 5), 1500), (2, 3, 2, 2, 3, 2), 50),
    ]
    worst = {p: 0.0 for p in TOL}
    for label, coo32, ranks, spp in cases:
        for dtype in (torch.float32, torch.float64):
            coo = SparseCOO(coo32.indices, coo32.values.to(dtype), coo32.shape)
            fs = [torch.randn(s_, r, device=dev, dtype=dtype) for s_, r in zip(coo.shape, ranks)]
            for mode in range(coo.ndim):
                sched = DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo,
                                                   slots_per_part=spp)
                opf = [fs[t] for t in operand_modes(coo.ndim, mode)]
                n_rows, n_terms = coo.shape[mode], max_row_count(coo, mode)
                for prec in ("fp32",) if dtype == torch.float64 else TOL:
                    rule = "fp64" if dtype == torch.float64 else prec
                    tag = (f"fused_kron_chain_scatter {label} mode {mode} "
                           f"({int(sched.chain_cuts.numel()) - 1} ranges)")
                    kern = partial(kron_kernel.fused_kron_chain_scatter, opf, sched, n_rows,
                                   precision=prec)
                    got = synced(kern())
                    want = synced(kron_kernel.fused_kron_chain_scatter_plain(
                        opf, sched, n_rows, precision=prec))
                    share = share_of_limit(tag, rule, got, want, n_terms)
                    if dtype == torch.float32:
                        worst[prec] = max(worst[prec], share)
                    if prec == "bf16_fp32acc":
                        nearer_exact(tag, got, want,
                                     synced(bf16_exact_chain_scatter(opf, sched, n_rows)))
                    compare(f"{tag} against kernels 3 and 4", rule, got, synced(
                        ops.sparse_ttm_chain_device(coo.indices, coo.values, fs, mode, sched,
                                                    shape=coo.shape, fused=False,
                                                    precision=prec)), n_terms)
                    check(torch.equal(got, synced(kern())),
                          f"{tag} [{prec}] differs between two calls")
    return worst


# -- phase 3 -----------------------------------------------------------------


def phase3_mid(dev) -> None:
    from repro_torch.core.engine import make_engine
    from repro_torch.sparse.generators import random_sparse_tensor

    log("phase 3: card against CPU from the same factors, 5 sweeps")
    nell = random_sparse_tensor((1000, 1000, 1000), 2.4e-5, seed=11, value_dist="uniform")
    card_vs_cpu("NELL-2-like 1000^3, 24,000 nnz, ranks 16", nell, (16, 16, 16),
                expect={"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER})
    card_vs_cpu("the same with fuse_core", nell, (16, 16, 16),
                engine=lambda d: make_engine("auto", d, fuse_core=True),
                expect={"fused_kron_scatter": 3 * N_ITER, "fused_kron_scatter_ttm": N_ITER})
    four = random_sparse_tensor((200, 200, 200, 20), 1e6 / (200 * 200 * 200 * 20), seed=12,
                                value_dist="counts")
    card_vs_cpu("4-way 200x200x200x20, 1,000,000 nnz, ranks 8", four, (8, 8, 8, 8),
                expect={"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER})
    # no megakernel above order 3: fuse_core takes the TTM of the Y_(N) the
    # sweep built, with no second unfolding
    small = random_sparse_tensor((60, 50, 40, 10), 2e4 / (60 * 50 * 40 * 10), seed=13,
                                 value_dist="counts")
    card_vs_cpu("4-way 60x50x40x10, 20,000 nnz, ranks 4, fuse_core", small, (4, 4, 4, 4),
                engine=lambda d: make_engine("auto", d, fuse_core=True),
                expect={"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER})
    # bf16_fp32acc: the card's kernels 1 and 5 and chain kernel give up the
    # plain versions' bf16 rounding of each product (see TOL), so the CPU is
    # held within BF16_CARD_VS_CPU
    bf16 = lambda d: make_engine("auto", d, precision="bf16_fp32acc")  # noqa: E731
    card_vs_cpu("NELL-2-like 1000^3, ranks 16, bf16_fp32acc", nell, (16, 16, 16), engine=bf16,
                expect={"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER}, **BF16_CARD_VS_CPU)
    card_vs_cpu("NELL-2-like 1000^3, ranks 16, bf16_fp32acc, fuse_core", nell, (16, 16, 16),
                engine=lambda d: make_engine("auto", d, precision="bf16_fp32acc", fuse_core=True),
                expect={"fused_kron_scatter": 3 * N_ITER, "fused_kron_scatter_ttm": N_ITER},
                **BF16_CARD_VS_CPU)
    card_vs_cpu("4-way 60x50x40x10, ranks 4, bf16_fp32acc", small, (4, 4, 4, 4), engine=bf16,
                expect={"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER},
                **BF16_CARD_VS_CPU)


# Phase 3's bf16_fp32acc tolerances. Each term of Y departs from the CPU's
# by at most one bf16 rounding, 2^-8 of itself, so ||Y|| and the fit (first
# order in Y) move by at most 2^-8: fit_tol 2^-8. The factors move by
# ||dY|| over the gap between the R-th and (R+1)-th singular values of the
# unfolding; these random tensors' leading singular values lie within
# 1/16 of each other, so the projectors within 16 x 2^-8 = 2^-4. Columns of
# nearly equal singular values may swap or rotate between the two runs,
# which matching signs cannot undo (a D1 run saw the 3-way core off by
# max|core| so), so the cores are compared in the CPU's factor basis
# (align="basis"), within 4 x 2^-8 = 2^-6 x max|core|: Y's move, and the
# part of the card's subspace outside the CPU's. tests/
# test_torch_bf16_route.py runs both cases on the CPU with the card's terms
# (the products of the bf16 operands unrounded) and holds them within these
# limits with room.
BF16_CARD_VS_CPU = {"fit_tol": 2.0 ** -8, "proj_tol": 2.0 ** -4, "core_tol": 2.0 ** -6,
                    "align": "basis"}


def card_vs_cpu(label, x, ranks=None, engine=None, expect=None, spec=None,
                align: str = "sign", fit_tol: float = 1e-4, proj_tol: float = 1e-3,
                core_tol: float = 1e-3):
    """Decompose ``x`` (a COO, or a dense tensor for ``spec``'s dense
    algorithm) on the card and on the CPU from the same seeded orthonormal
    factors, by ``spec`` (``TuckerSpec(x.shape, ranks, n_iter=N_ITER)`` by
    default), through a prebuilt engine from ``engine(device)`` when given;
    the fit histories must agree within ``fit_tol`` (1e-4), the factor
    projectors within 1e-3 and the cores, once the factor columns' signs are
    matched, within 1e-3 x max|CPU core| (``fit_tol``, ``proj_tol`` and
    ``core_tol`` set other limits; a float64 spec's factors are drawn in
    f64, and as its fit history is kept in f32, as the reference keeps it,
    the history is held to two f32 ulps and ``fit_tol`` holds the f64 fit
    of the last sweep, :func:`fit64`); the card run must launch ``expect``
    (nothing on the dense paths). Returns the card's and the CPU's
    results.

    ``align="basis"`` compares the card's core in the CPU's factor basis,
    G x_n (U_cpu,n^T U_card,n), for a tensor whose QRP pivots tie exactly
    (the binary matmul tensor's column norms): rounding then breaks the ties
    differently on the two devices, the same subspace comes in another
    column order, and signs alone cannot match the cores."""
    from repro_torch import tucker

    spec = spec or tucker.TuckerSpec(x.shape, ranks, n_iter=N_ITER)
    rng = np.random.default_rng(SEED)
    fdt = np.float64 if spec.dtype == "float64" else np.float32
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(fdt)
          for s, r in zip(spec.shape, spec.ranks)]
    res = {}
    for d in ("cuda", "cpu"):
        reset_launches()
        t0 = time.perf_counter()
        plan = tucker.plan(spec, device=d, engine=engine(d) if engine else None)
        res[d] = plan(x, factors_init=[torch.from_numpy(f) for f in f0])
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        log(f"  {label} on {d}: {time.perf_counter() - t0:.2f} s, launches {launches}")
        if d == "cuda":
            check(launches == (expect or {}), f"{label}: launches {launches}, want {expect}")
        else:
            check(not launches, f"{label}: the CPU run launched {launches}")
    cu, cp = res["cuda"], res["cpu"]
    card_engine = "cuda" if spec.algorithm == "sparse" else "torch"
    check(cu.engine == card_engine and cp.engine == "torch", f"engines {cu.engine}, {cp.engine}")
    hist_err = float(np.abs(cu.fit_history - cp.fit_history).max())
    proj_err = max(
        float((a.cpu() @ a.cpu().T - b @ b.T).abs().max())
        for a, b in zip(cu.factors, cp.factors)
    )
    log(f"  fit card {cu.fit_history.tolist()}")
    log(f"  fit cpu  {cp.fit_history.tolist()}")
    hist_tol = fit_tol
    if spec.dtype == "float64":
        hist_tol = max(fit_tol, F32_HISTORY_ULPS)
        x2 = xnorm2_of(x)
        gap64 = abs(fit64(cu, x2) - fit64(cp, x2))
        log(f"  f64 fit of the last sweep: card {fit64(cu, x2)!r}, CPU {fit64(cp, x2)!r}, "
            f"diff {gap64:.3e} <= {fit_tol:g}")
        check(gap64 <= fit_tol, f"{label}: card and CPU f64 fits disagree")
    log(f"  fit history max diff {hist_err:.3e} <= {hist_tol:g}; projector UU^T max diff "
        f"{proj_err:.3e} <= {proj_tol:g}; card launches {cu.launches}")
    check(cu.fit_history.shape == cp.fit_history.shape and hist_err <= hist_tol,
          f"{label}: card and CPU fit histories disagree")
    check(proj_err <= proj_tol, f"{label}: card and CPU factor subspaces disagree")
    from repro_torch.core.ttm import ttm

    core = cu.core.cpu()
    for n, (a, b) in enumerate(zip(cu.factors, cp.factors)):
        if align == "basis":
            core = ttm(core, b.T @ a.cpu(), n)
        else:  # a factor column is defined up to its sign: flip the core's slices to match
            sign = torch.sign((a.cpu() * b).sum(0))
            core = core * sign.reshape([-1 if t == n else 1 for t in range(core.dim())])
    scale = float(cp.core.abs().max())
    core_err = float((core - cp.core).abs().max())
    log(f"  core max diff ({align} aligned) {core_err:.3e} <= {core_tol * scale:.3e} "
        f"({core_tol:g} x max|core| {scale:.3e})")
    check(bool(torch.isfinite(core).all()) and core_err <= core_tol * scale,
          f"{label}: card and CPU cores disagree")
    return cu, cp


# -- phase 4 -----------------------------------------------------------------


def synthetic(dev, shape, nnz: int, seed: int, values: str):
    """Unique uniform coordinates at a published shape and nonzero count,
    drawn on the card from a seeded generator: sort-based dedup, no loop over
    the nonzeros. (The same steps in host numpy took 202 s at NELL-2 size on
    the shared host CPU of an H100 node.) ``values`` is "uniform" (uniform
    in [0.1, 10), like ``repro.sparse.datasets.nell2_like``) or "counts"
    (Poisson(3) + 1, like ``value_dist="counts"``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = 1
    for s in shape:
        total *= s
    lin = torch.empty(0, dtype=torch.int64, device=dev)
    while lin.numel() < nnz:
        more = torch.randint(0, total, (nnz - lin.numel() + nnz // 1000 + 1024,),
                             generator=g, device=dev, dtype=torch.int64)
        lin = torch.unique(torch.cat([lin, more]))
    lin = lin[torch.randperm(lin.numel(), generator=g, device=dev)[:nnz]]
    idx = torch.empty((nnz, len(shape)), dtype=torch.int32, device=dev)
    for k in range(len(shape) - 1, -1, -1):
        idx[:, k] = lin % shape[k]
        lin = lin // shape[k]
    if values == "uniform":
        vals = torch.rand(nnz, generator=g, device=dev) * 9.9 + 0.1
    else:
        vals = torch.poisson(torch.full((nnz,), 3.0, device=dev), generator=g) + 1.0
    return idx, vals


def unique_coords(coo) -> bool:
    lin = torch.zeros(coo.nnz, dtype=torch.int64, device=coo.indices.device)
    for k, s in enumerate(coo.shape):
        lin = lin * s + coo.indices[:, k].long()
    return int(torch.unique(lin).numel()) == coo.nnz


def phase4_nell2(dev, card: str):
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    log(f"phase 4: NELL-2 size {NELL2_SHAPE}, {NELL2_NNZ} nnz, ranks {NELL2_RANKS}, "
        f"{N_ITER} sweeps")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NELL2_SHAPE, NELL2_NNZ, SEED, "uniform")
    coo = SparseCOO.from_parts(idx, vals, NELL2_SHAPE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(unique_coords(coo), "synthetic coordinates are not unique")
    del idx, vals
    spec = tucker.TuckerSpec(shape=NELL2_SHAPE, ranks=NELL2_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev)

    # the main path, cold: every count starts at 0 here and is read right after.
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9  # the tensor
    reset_launches()
    t0 = time.perf_counter()
    res = tucker.decompose(coo, NELL2_RANKS, n_iter=N_ITER, device=dev)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, schedule builds "
        f"{res.schedule_builds}, fit {hist.tolist()}")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER, "kron_contrib": 0,
                       "scatter_rows": 0, "fused_kron_scatter_ttm": 0,
                       "fused_kron_chain_scatter": 0, **NO_LM_LAUNCHES},
          f"main path launches {launches}, want {3 * N_ITER} and {N_ITER}")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all((hist >= 0) & (hist <= 1))), f"fit history {hist}")
    check(all(bool(torch.isfinite(f).all()) for f in res.factors)
          and bool(torch.isfinite(res.core).all()), "non-finite factors or core")
    check(tuple(res.core.shape) == NELL2_RANKS, f"core shape {tuple(res.core.shape)}")

    # warm runs (schedules cached on the plan's engine): per-sweep time of
    # each, and no gather of (nnz, R) operand rows (kernel 1 reads the
    # factors itself). Most of a sweep is the host launching QRP's small
    # kernels, so the runs' spread is reported beside the host's cost of one
    # small launch and the device kernels per sweep.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gathers = ops._gathered_block_rows.calls
    warm_runs = []
    t0 = time.perf_counter()
    for _ in range(WARM_RUNS):
        start.record()
        warm = plan(coo)
        end.record()
        end.synchronize()
        warm_runs.append(start.elapsed_time(end) / N_ITER)
        check(warm.schedule_builds == 0, "warm run rebuilt schedules")
        check(np.array_equal(warm.fit_history, hist), "warm run differs from the cold run")
    t_warm = (time.perf_counter() - t0) / WARM_RUNS
    gathers = ops._gathered_block_rows.calls - gathers
    sweep_ms = float(np.median(warm_runs))
    RECORDED["phase4_sweep_ms"] = sweep_ms
    launch_us = host_launch_us(dev)
    log(f"  warm runs: " + ", ".join(f"{m:.2f}" for m in warm_runs)
        + f" ms per sweep (median {sweep_ms:.2f}), operand-row gathers {gathers}; "
        f"host {launch_us:.2f} us per small torch kernel")
    check(gathers == 0, f"the warm split sweep gathered operand rows {gathers} times")
    profile = profile_run(lambda: plan(coo))
    kernels_per_sweep = profile["device_kernels"] / N_ITER
    log(f"  {kernels_per_sweep:.0f} device kernels per sweep: x {launch_us:.2f} us = "
        f"{kernels_per_sweep * launch_us / 1e3:.2f} ms of host launches per sweep")
    python_pipeline = per_sweep_pipeline(plan, coo, res, launches, sweep_ms)

    # each kernel at the path's shapes, against its plain version.
    eng, fs = plan.engine, [f.contiguous() for f in res.factors]
    kron_ms = {p: 0.0 for p in TOL}
    kron_plain_ms = {p: 0.0 for p in TOL}
    kron_bound, kron_err, per_mode = {p: 0.0 for p in TOL}, {p: 0.0 for p in TOL}, []
    kron_bytes, kron_flops = {p: 0 for p in TOL}, {p: 0 for p in TOL}
    kron_worst = {p: 0.0 for p in TOL}  # the worst error over its limit
    y_last = None
    for mode in range(3):
        sched = eng.device_schedule(coo, mode)
        n_rows = NELL2_SHAPE[mode]
        fa, fb = kron_factors(fs, mode)
        nnz_real = NELL2_NNZ
        n_terms = max_row_count(coo, mode)
        slots = int(sched.vals.shape[0])
        for p in TOL:
            kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows, precision=p)
            plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, sched, n_rows,
                            precision=p)
            got, want = synced(kern()), synced(plain())
            label = (f"fused_kron_scatter NELL-2 mode {mode} ({fa.shape[1]}x{fb.shape[1]}, "
                     f"{slots} slots)")
            err = compare(label, p, got, want, n_terms)
            kron_err[p] = max(kron_err[p], err)
            kron_worst[p] = max(kron_worst[p], err / limit_of(want, p, n_terms)[0])
            if p == "bf16_fp32acc":
                nearer_exact(label, got, want,
                             synced(bf16_exact_kron_scatter(fa, fb, sched, n_rows)))
            check(torch.equal(got, synced(kern())),
                  f"fused_kron_scatter NELL-2 mode {mode} [{p}] differs between two calls")
            del want
            if p == "fp32" and mode == 2:
                y_last = got
            k_ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
            k = fa.shape[1] * fb.shape[1]
            # what the kernel must read: the slot coordinates and values, the
            # schedule's rows and ranges, the two factor matrices (as cast)
            # once each; and Y written once
            nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                                *kron_kernel._cast_operands(p, fa, fb)) + n_rows * k * 4)
            flops = kron_scatter_flops(nnz_real, fa.shape[1], k)
            # fp32 runs on the tensor cores in 3xTF32, bf16_fp32acc on the
            # bf16 tensor cores (m16n8k16)
            peak = PEAK_TF32_FLOPS if p == "fp32" else PEAK_BF16_FLOPS
            mode_bound, _ = bound(nbytes, flops, peak)
            kron_ms[p] += k_ms
            kron_plain_ms[p] += p_ms
            kron_bound[p] += mode_bound
            kron_bytes[p] += nbytes
            kron_flops[p] += flops
            per_mode.append({"mode": mode, "precision": p, "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": mode_bound, "bytes": nbytes, "flops": flops,
                             "parts": int(sched.parts.numel()) - 1})
            log(f"    mode {mode} [{p}]: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"bound {mode_bound:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP), "
                f"{int(sched.parts.numel()) - 1} ranges (one a warp)")
            del got
    routes = {p: kron_kernel.launch_route("fused_kron_scatter", torch.float32, p) for p in TOL}
    log(f"  fused_kron_scatter a sweep: bf16_fp32acc ({routes['bf16_fp32acc']}) "
        f"{kron_ms['bf16_fp32acc']:.3f} ms beside fp32 ({routes['fp32']}) "
        f"{kron_ms['fp32']:.3f} ms; bounds {kron_bound['bf16_fp32acc']:.3f} / "
        f"{kron_bound['fp32']:.3f} ms; worst error as a share of the limit "
        + ", ".join(f"[{p}] {kron_worst[p]:.3g}" for p in TOL) + "; the same bits twice")
    bf16_run = bf16_sweeps(dev, spec, coo, plan, hist, profile,
                           {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER})

    u = fs[2]
    ttm_row = {}
    for p in TOL:
        yc, uc = y_last.T, u.T
        kern = partial(ttm_kernel.ttm, yc, uc, precision=p)
        plain = partial(ttm_kernel.ttm_plain, yc, uc, precision=p)
        err = compare(f"ttm NELL-2 y {tuple(yc.shape)} (transposed view) u "
                      f"{tuple(uc.shape)}", p, check_ttm_call("NELL-2", yc, uc, p),
                      synced(plain()), yc.shape[1])
        yb, ub = kron_kernel._cast_operands(p, yc, uc)
        # one PyTorch call of the same function; bf16 matmul would round its
        # output to bf16, a different function, so none under bf16_fp32acc
        lib = partial(torch.matmul, yb, ub.T) if p == "fp32" else None
        l_, i_ = yc.shape
        nbytes = (l_ * i_ + u.shape[1] * i_) * yb.element_size() + l_ * u.shape[1] * 4
        flops = 2 * l_ * i_ * u.shape[1]
        ttm_row[p] = {
            "ms": time_ms(kern, reps=20, flush_l2=True),
            "plain_ms": time_ms(plain, reps=20, flush_l2=True),
            "library_ms": time_ms(lib, reps=20, flush_l2=True) if lib else None,
            "bound_ms": bound(nbytes, flops)[0], "bound_by": bound(nbytes, flops)[1],
            "max_abs_err": err,
        }
        log(f"    ttm [{p}]: {json.dumps(ttm_row[p])}")

    summary = {
        "phase": "4 NELL-2 main path", "card": card,
        "shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS, "n_iter": N_ITER,
        "setup_s": {"generate_on_card": t_gen,
                    "cold_decompose_incl_schedules": t_cold, "warm_decompose": t_warm},
        "sweep_ms": sweep_ms, "sweep_ms_warm_runs": warm_runs,
        "host_us_per_small_kernel": launch_us, "device_kernels_per_sweep": kernels_per_sweep,
        "launches_per_sweep": {k: v / N_ITER for k, v in launches.items()},
        "kron_ms_per_sweep": kron_ms, "kron_plain_ms_per_sweep": kron_plain_ms,
        "kron_bound_ms_per_sweep": kron_bound, "kron_per_mode": per_mode,
        "kron_worst_share_of_limit": kron_worst, "bf16_fp32acc_sweeps": bf16_run,
        "ttm": ttm_row,
        "profile_warm_run": profile,
        "peak_memory_gb": peak_gb, "resident_at_start_gb": resident_gb,
        "slot_cache_gb": sum(nbytes_of(eng.device_schedule(coo, m).idx,
                                       eng.device_schedule(coo, m).vals) for m in range(3)) / 1e9,
        "operand_row_gathers_warm_run": gathers,
        "fit_history": hist.tolist(),
        "python_pipeline": python_pipeline,
    }
    print(json.dumps(summary), flush=True)
    rows = [
        {"name": "fused_kron_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kron_scatter.cu",
         "replaces": "src/repro/kernels/kron_kernel.py:306",
         "launches": launches["fused_kron_scatter"], "max_abs_err": kron_err["fp32"],
         "ms": kron_ms["fp32"], "plain_ms": kron_plain_ms["fp32"],
         "device_ms": profile["kernel_ms"]["fused_kron_scatter"] / N_ITER,
         "bound_ms": kron_bound["fp32"],
         "bound_by": bound(kron_bytes["fp32"], kron_flops["fp32"], PEAK_TF32_FLOPS)[1],
         "f32_core_bound_ms": bound(kron_bytes["fp32"], kron_flops["fp32"])[0],
         # no single PyTorch call computes it without first forming the
         # (nnz, K) Kron rows, 79 GB at this size
         "library_ms": None},
        {"name": "fused_kron_scatter_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kron_scatter.cu",
         "replaces": "src/repro/kernels/kron_kernel.py:306",
         # the bf16_fp32acc main path's run (bf16_sweeps), on the bf16
         # tensor cores
         "launches": bf16_run["launches"]["fused_kron_scatter"],
         "path": "bf16_fp32acc, a warm plan of 5 sweeps",
         "max_abs_err": kron_err["bf16_fp32acc"],
         "worst_share_of_limit": kron_worst["bf16_fp32acc"],
         "ms": kron_ms["bf16_fp32acc"], "plain_ms": kron_plain_ms["bf16_fp32acc"],
         "device_ms": bf16_run["profile"]["kernel_ms"]["fused_kron_scatter"] / N_ITER,
         "bound_ms": kron_bound["bf16_fp32acc"],
         "bound_by": bound(kron_bytes["bf16_fp32acc"], kron_flops["bf16_fp32acc"],
                           PEAK_BF16_FLOPS)[1],
         "library_ms": None},
        {"name": "ttm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ttm.cu",
         "replaces": "src/repro/kernels/ttm_kernel.py:62",
         "launches": launches["ttm"], "max_abs_err": ttm_row["fp32"]["max_abs_err"],
         "ms": ttm_row["fp32"]["ms"], "plain_ms": ttm_row["fp32"]["plain_ms"],
         "device_ms": profile["kernel_ms"]["ttm"] / N_ITER,
         "bound_ms": ttm_row["fp32"]["bound_ms"], "bound_by": ttm_row["fp32"]["bound_by"],
         "library_ms": ttm_row["fp32"]["library_ms"]},
    ]
    return {r["name"]: r for r in rows}, coo, res, (peak_gb, resident_gb)


def bf16_sweeps(dev, spec, coo, plan32, fit32, profile32: dict, expect: dict, engine=None):
    """The main path under ``precision="bf16_fp32acc"``: a plan of the same
    spec at that precision (on ``engine``, a bf16_fp32acc engine, where
    given), built and run once cold (its schedules), then
    warm runs of ``N_ITER`` sweeps in turns with the fp32 plan ``plan32``
    (bf16, fp32, fp32, bf16), every count at 0 before the first bf16 turn
    and read after it (its launches, ``expect``); the ms a sweep of each
    (the mean of its two turns) and, from a profiled warm run, the device's
    busy share and time beside the fp32 run's (``profile32``); its fit
    finite and within BF16_FIT_TOL of the fp32 run's (``fit32``). Its
    schedules are dropped at the end (the plan cache, which also holds the
    fp32 plan that phase 5 reuses, stays), so that later phases see the
    memory they saw before."""
    from repro_torch import tucker

    plan = tucker.plan(dataclasses.replace(spec, precision="bf16_fp32acc"), device=dev,
                       engine=engine)
    plan(coo)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    turns, launches, res = {"bf16_fp32acc": [], "fp32": []}, None, None
    for name in ("bf16_fp32acc", "fp32", "fp32", "bf16_fp32acc"):
        if launches is None:
            reset_launches()
        start.record()
        got = (plan if name == "bf16_fp32acc" else plan32)(coo)
        end.record()
        end.synchronize()
        turns[name].append(start.elapsed_time(end) / N_ITER)
        if launches is None:
            launches, res = {k: v for k, v in read_launches().items() if v}, got
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    prof = profile_run(lambda: plan(coo))
    gap = float(np.abs(res.fit_history - fit32).max())
    out = {"launches": launches, "sweep_ms": ms["bf16_fp32acc"], "sweep_ms_fp32": ms["fp32"],
           "sweep_ms_turns": turns, "busy_share": prof["busy_share"],
           "busy_share_fp32": profile32["busy_share"],
           "device_busy_ms_per_sweep": prof["device_busy_ms"] / N_ITER,
           "device_busy_ms_per_sweep_fp32": profile32["device_busy_ms"] / N_ITER,
           "fit_history": res.fit_history.tolist(), "fit_gap_to_fp32": gap, "profile": prof}
    log(f"  bf16_fp32acc plan: {ms['bf16_fp32acc']:.3f} ms a sweep (fp32 {ms['fp32']:.3f}, in "
        f"turns), busy share {prof['busy_share']:.3f} (fp32 {profile32['busy_share']:.3f}), "
        f"device {out['device_busy_ms_per_sweep']:.3f} ms a sweep (fp32 "
        f"{out['device_busy_ms_per_sweep_fp32']:.3f}), launches {launches}, fit "
        f"{res.fit_history.tolist()}, max gap to fp32's {gap:.3e} <= {BF16_FIT_TOL:g}")
    check(res.engine == "cuda" and res.precision == "bf16_fp32acc",
          f"bf16 plan ran {res.engine} at {res.precision}")
    check(launches == expect, f"bf16_fp32acc plan launches {launches}, want {expect}")
    check(bool(np.all(np.isfinite(res.fit_history))) and gap <= BF16_FIT_TOL,
          f"bf16_fp32acc fit {res.fit_history} against fp32's {fit32}")
    plan.engine.dev_schedules.clear()
    torch.cuda.empty_cache()
    return out


# the bf16_fp32acc main path's fit against fp32's, phases 4 and 6
BF16_FIT_TOL = 1e-2


def per_sweep_pipeline(plan, coo, scan_res, scan_launches, scan_sweep_ms) -> dict:
    """The per-sweep pipeline (``pipeline="python"``) on phase 4's tensor,
    through the scan plan's engine (its schedules) and from the same initial
    factors (the plan's default draw): its launch counts, the scan run's fit
    history, factors and core bit for bit (the same sweeps on deterministic
    kernels; only the fit is read back after each sweep), and its ms per
    sweep beside the scan pipeline's median of this run."""
    from repro_torch import tucker

    py_plan = tucker.plan(dataclasses.replace(plan.spec, pipeline="python"),
                          device=plan.device, engine=plan.engine)
    reset_launches()
    py = py_plan(coo)
    torch.cuda.synchronize()
    launches = read_launches()
    same = (np.array_equal(py.fit_history, scan_res.fit_history)
            and torch.equal(py.core, scan_res.core)
            and all(torch.equal(a, b) for a, b in zip(py.factors, scan_res.factors)))
    log(f"  per-sweep pipeline: launches {launches}, dispatches {py.dispatches}, "
        f"schedule builds {py.schedule_builds}, same fit, factors and core as the scan "
        f"pipeline: {same}")
    check(launches == scan_launches, f"per-sweep pipeline launches {launches}, want "
          f"{scan_launches}")
    check(py.dispatches == N_ITER and py.schedule_builds == 0,
          f"per-sweep pipeline: {py.dispatches} dispatches, {py.schedule_builds} builds")
    check(same, "the per-sweep pipeline differs from the scan pipeline")
    runs = [ms / N_ITER for ms in warm_ms(lambda: py_plan(coo))]
    sweep_ms = float(np.median(runs))
    log(f"  per-sweep pipeline warm runs: " + ", ".join(f"{m:.2f}" for m in runs)
        + f" ms per sweep (median {sweep_ms:.2f}; the scan pipeline {scan_sweep_ms:.2f})")
    return {"sweep_ms": sweep_ms, "sweep_ms_warm_runs": runs,
            "scan_sweep_ms": scan_sweep_ms, "launches": launches,
            "dispatches": py.dispatches, "same_bits_as_scan": same}


# -- phase 5: path B, the fused core update at NELL-2 size ---------------------


def phase5_fused_core(dev, card: str, coo, split_res, split_peak):
    """``split_res`` and ``split_peak`` (peak and resident GB) are phase 4's
    cold run of the split path on ``coo``."""
    from repro_torch import tucker
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    log(f"phase 5: path B, make_engine('cuda', fuse_core=True) on the phase 4 tensor, "
        f"{N_ITER} sweeps")
    spec = tucker.TuckerSpec(shape=NELL2_SHAPE, ranks=NELL2_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev, engine=make_engine("cuda", dev, fuse_core=True))
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9  # the tensor and phase 4's schedules
    reset_launches()
    t0 = time.perf_counter()
    res = plan(coo)  # the same seeded initial factors as phase 4's run
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, fit {hist.tolist()}")
    split_peak_gb, split_resident_gb = split_peak
    log(f"  cold peak memory: path B {peak_gb:.2f} GB, {peak_gb - resident_gb:.2f} above the "
        f"{resident_gb:.2f} GB resident (the tensor and phase 4's schedules); split path "
        f"(phase 4) {split_peak_gb:.2f} GB, {split_peak_gb - split_resident_gb:.2f} above the "
        f"{split_resident_gb:.2f} GB resident (the tensor)")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 3 * N_ITER, "ttm": 0, "kron_contrib": 0,
                       "scatter_rows": 0, "fused_kron_scatter_ttm": N_ITER,
                       "fused_kron_chain_scatter": 0, **NO_LM_LAUNCHES},
          f"path B launches {launches}")
    hist_err = float(np.abs(hist - split_res.fit_history).max())
    proj_err = max(float((a @ a.T - b @ b.T).abs().max())
                   for a, b in zip(res.factors, split_res.factors))
    log(f"  against phase 4 (split core): fit history max diff {hist_err:.3e} <= 1e-4, "
        f"projector max diff {proj_err:.3e} <= 1e-3")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist))) and hist_err <= 1e-4,
          "fused-core fit history disagrees with the split path")
    check(proj_err <= 1e-3, "fused-core factors disagree with the split path")
    check(tuple(res.core.shape) == NELL2_RANKS, f"fused-core core shape {tuple(res.core.shape)}")
    # the core is all that fuse_core changes (the factors never read it)
    core_err = compare("path B core against phase 4's split core", "fp32", res.core,
                       split_res.core, NELL2_NNZ)

    # warm runs of the split plan (phase 4's, cached) and of path B in turns,
    # each with its peak memory above what was allocated before it; path B
    # makes no (nnz, R) operand-row gather (kernel 5 reads the factors itself)
    split_plan = tucker.plan(spec, device=dev)
    turns, warm_peak = [], {"split": 0.0, "fused": 0.0}
    gathers = ops._gathered_block_rows.calls
    for name, p in (("split", split_plan), ("fused", plan), ("fused", plan),
                    ("split", split_plan)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        calls = ops._gathered_block_rows.calls
        start.record()
        warm = p(coo)
        end.record()
        end.synchronize()
        turns.append((name, start.elapsed_time(end) / N_ITER))
        warm_peak[name] = max(warm_peak[name],
                              (torch.cuda.max_memory_allocated() - before) / 1e9)
        check(warm.schedule_builds == 0, f"{name} warm run rebuilt schedules")
        if name == "fused":
            check(np.array_equal(warm.fit_history, hist), "path B warm run changed its result")
            check(ops._gathered_block_rows.calls == calls,
                  "path B's warm run gathered (nnz, R) operand rows")
    gathers = ops._gathered_block_rows.calls - gathers
    log("  warm ms per sweep, in turns: " + ", ".join(f"{n} {ms:.1f}" for n, ms in turns)
        + f"; operand-row gathers {gathers}; peak above the resident memory: split "
        f"{warm_peak['split']:.3f} GB, path B {warm_peak['fused']:.3f} GB")
    check(gathers == 0, f"the warm runs gathered operand rows {gathers} times")
    sweep_ms = float(np.mean([ms for n, ms in turns if n == "fused"]))
    split_sweep_ms = float(np.mean([ms for n, ms in turns if n == "split"]))
    profile = profile_run(lambda: plan(coo))

    # the megakernel at the path's shapes: against its plain version, against
    # the split core update it replaces (kernel 1's Y, then the TTM kernel).
    eng, fs, mode = plan.engine, [f.contiguous() for f in res.factors], 2
    sched = eng.device_schedule(coo, mode)
    fa, fb = kron_factors(fs, mode)
    u = fs[mode]
    n_rows = NELL2_SHAPE[mode]
    ra, rb, r, k = fa.shape[1], fb.shape[1], u.shape[1], fa.shape[1] * fb.shape[1]
    nnzp = int(sched.vals.shape[0])
    grid = dict(kron_kernel.mega_grid(dev, ra, rb, kron_kernel._padded_factor(fa).shape[1],
                                      kron_kernel._padded_factor(fb).shape[1], r, 0,
                                      int(sched.parts.numel()) - 1),
                ranges=int(sched.parts.numel()) - 1)
    log(f"  megakernel grid (fp32): {grid}")
    visited = int(torch.unique(coo.indices[:, mode]).numel())
    row = {}
    for p in TOL:
        kern = partial(kron_kernel.fused_kron_scatter_ttm, fa, fb, u, sched, n_rows,
                       precision=p)
        plain = partial(kron_kernel.fused_kron_scatter_ttm_plain, fa, fb, u, sched, n_rows,
                        precision=p)
        got, want = synced(kern()), synced(plain())
        err = compare(f"fused_kron_scatter_ttm NELL-2 mode {mode}", p, got, want, NELL2_NNZ)
        if p == "bf16_fp32acc":
            nearer_exact(f"fused_kron_scatter_ttm NELL-2 mode {mode}", got, want, synced(
                bf16_exact_kron_scatter_ttm(fa, fb, u, sched, n_rows)))
        del want
        check(torch.equal(got, synced(kern())),
              f"fused_kron_scatter_ttm NELL-2 mode {mode} [{p}] differs between two calls")
        y = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows, precision=p))
        split = synced(ttm_kernel.ttm(y.T, u.T, precision=p).T)
        compare(f"fused_kron_scatter_ttm NELL-2 against the split core update", p, got,
                split, NELL2_NNZ)
        # what the kernel must read, as kernel 1's bound counts it: the slot
        # coordinates and values, the schedule's rows and ranges, the two
        # factor matrices and U (as cast) once each; and the core written once
        fac = kron_kernel._cast_operands(p, fa, fb, u)
        nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                            *fac) + r * k * 4)
        flops = kron_scatter_flops(NELL2_NNZ, ra, k) + 2 * visited * r * k
        # fp32 runs on the tensor cores (3xTF32), bf16_fp32acc's walk on
        # the bf16 tensor cores (m16n8k16)
        bound_ms, bound_by = bound(nbytes, flops,
                                   PEAK_TF32_FLOPS if p == "fp32" else PEAK_BF16_FLOPS)
        # PR 12's design read the gathered (nnz, R) rows of a and b instead of
        # the coordinates, at the f32 CUDA-core rate
        gathered_bytes = (nnzp * (ra + rb) * fac[0].element_size()
                          + nbytes_of(sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                                      fac[2]) + r * k * 4)
        row[p] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, reps=1),
                  "split_ttm_ms": time_ms(partial(ttm_kernel.ttm, y.T, u.T, precision=p),
                                          reps=20, flush_l2=True),
                  "split_unfolding_ms": time_ms(partial(
                      kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows, precision=p)),
                  "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                  "flops": flops, "f32_core_bound_ms": bound(nbytes, flops)[0],
                  "pr12_design_bound_ms": bound(gathered_bytes, flops)[0],
                  "max_abs_err": err}
        log(f"    fused_kron_scatter_ttm [{p}]: {json.dumps(row[p])}")
        del y, split, got
    log(f"  fused_kron_scatter_ttm: bf16_fp32acc "
        f"({kron_kernel.launch_route('fused_kron_scatter_ttm', torch.float32, 'bf16_fp32acc')}) "
        f"{row['bf16_fp32acc']['ms']:.3f} ms beside fp32 {row['fp32']['ms']:.3f} ms; bounds "
        f"{row['bf16_fp32acc']['bound_ms']:.3f} / {row['fp32']['bound_ms']:.3f} ms")
    bf16_run = bf16_sweeps(
        dev, spec, coo, plan, hist, profile,
        {"fused_kron_scatter": 3 * N_ITER, "fused_kron_scatter_ttm": N_ITER},
        engine=make_engine("cuda", dev, precision="bf16_fp32acc", fuse_core=True))
    print(json.dumps({
        "phase": "5 path B fused core update", "card": card, "shape": NELL2_SHAPE,
        "nnz": NELL2_NNZ, "ranks": NELL2_RANKS, "n_iter": N_ITER,
        "setup_s": {"cold_decompose_incl_schedules": t_cold}, "sweep_ms": sweep_ms,
        "split_sweep_ms_same_call": split_sweep_ms, "turns": turns,
        "launches_per_sweep": {k: n / N_ITER for k, n in launches.items()},
        "operand_row_gathers_warm_runs": gathers,
        "megakernel": row, "megakernel_grid": grid, "core_max_abs_err_vs_split": core_err,
        "profile_warm_run": profile, "peak_memory_gb": peak_gb,
        "resident_at_start_gb": resident_gb, "split_peak_memory_gb_phase4": split_peak_gb,
        "split_resident_at_start_gb_phase4": split_resident_gb,
        "warm_peak_above_resident_gb": warm_peak,
        "fit_history": hist.tolist(), "bf16_fp32acc_sweeps": bf16_run}), flush=True)
    return {"fused_kron_scatter_ttm": {
        "name": "fused_kron_scatter_ttm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kron_scatter_ttm.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:428",
        "launches": launches["fused_kron_scatter_ttm"], "max_abs_err": row["fp32"]["max_abs_err"],
        "ms": row["fp32"]["ms"], "plain_ms": row["fp32"]["plain_ms"],
        "device_ms": profile["kernel_ms"]["fused_kron_scatter_ttm"] / N_ITER,
        "bound_ms": row["fp32"]["bound_ms"], "bound_by": row["fp32"]["bound_by"],
        "pr12_design_bound_ms": row["fp32"]["pr12_design_bound_ms"],
        # no single PyTorch call builds Y from the nonzeros and contracts it
        "library_ms": None},
        "fused_kron_scatter_ttm_bf16": {
        "name": "fused_kron_scatter_ttm_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kron_scatter_ttm.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:428",
        # the bf16_fp32acc fuse_core plan's run (bf16_sweeps): the walk on
        # bf16 m16n8k16, the rounds on 2xTF32
        "launches": bf16_run["launches"]["fused_kron_scatter_ttm"],
        "path": "bf16_fp32acc, fuse_core=True, a warm plan of 5 sweeps",
        "max_abs_err": row["bf16_fp32acc"]["max_abs_err"],
        "ms": row["bf16_fp32acc"]["ms"], "plain_ms": row["bf16_fp32acc"]["plain_ms"],
        "device_ms": bf16_run["profile"]["kernel_ms"]["fused_kron_scatter_ttm"] / N_ITER,
        "bound_ms": row["bf16_fp32acc"]["bound_ms"], "bound_by": row["bf16_fp32acc"]["bound_by"],
        "library_ms": None}}


# -- phase 6: path A, the 4-way path at NIPS size ------------------------------


def phase6_nips(dev, card: str):
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO, fold_dense
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import operand_modes, slot_rows

    log(f"phase 6: path A, NIPS size {NIPS_SHAPE}, {NIPS_NNZ} nnz, ranks {NIPS_RANKS}, "
        f"{N_ITER} sweeps")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NIPS_SHAPE, NIPS_NNZ, SEED, "counts")
    coo = SparseCOO.from_parts(idx, vals, NIPS_SHAPE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(unique_coords(coo), "synthetic coordinates are not unique")
    del idx, vals
    spec = tucker.TuckerSpec(shape=NIPS_SHAPE, ranks=NIPS_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = tucker.decompose(coo, NIPS_RANKS, n_iter=N_ITER, device=dev)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, schedule builds "
        f"{res.schedule_builds}, peak {peak_gb:.2f} GB, fit {hist.tolist()}")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 0, "ttm": N_ITER, "kron_contrib": 0,
                       "scatter_rows": 0, "fused_kron_scatter_ttm": 0,
                       "fused_kron_chain_scatter": 4 * N_ITER, **NO_LM_LAUNCHES},
          f"path A launches {launches}")
    check(peak_gb <= PHASE6_PEAK_GB, f"path A peak {peak_gb:.2f} GB > {PHASE6_PEAK_GB} GB")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all((hist >= 0) & (hist <= 1))), f"fit history {hist}")
    check(all(bool(torch.isfinite(f).all()) for f in res.factors),
          "non-finite factors")
    check(tuple(res.core.shape) == spec.ranks, f"core shape {tuple(res.core.shape)}")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gathers = ops._gathered_block_rows.calls
    start.record()
    warm = plan(coo)
    end.record()
    end.synchronize()
    sweep_ms = start.elapsed_time(end) / N_ITER
    warm_gathers = ops._gathered_block_rows.calls - gathers
    log(f"  warm run: {sweep_ms:.3f} ms a sweep, (nnz, R) operand gathers {warm_gathers}")
    check(warm.schedule_builds == 0 and np.array_equal(warm.fit_history, hist),
          "path A warm run rebuilt schedules or changed its result")
    check(warm_gathers == 0, f"path A's warm run gathered (nnz, R) rows {warm_gathers} times")
    del warm
    profile = profile_run(lambda: plan(coo))

    # fuse_core on a 4-way tensor: there is no megakernel above order 3, so
    # the core update is the TTM of the Y_(3) the sweep built, with no second
    # unfolding: the launches, the result and the time are the split path's.
    fplan = tucker.plan(spec, device=dev, engine=make_engine("cuda", dev, fuse_core=True))
    fplan(coo)  # builds the new engine's schedules
    reset_launches()
    start.record()
    fres = fplan(coo)
    end.record()
    end.synchronize()
    fused_sweep_ms = start.elapsed_time(end) / N_ITER
    flaunch = read_launches()
    log(f"  fuse_core: {fused_sweep_ms:.1f} ms per sweep (split {sweep_ms:.1f}), launches "
        f"{flaunch}, core bit-identical to the split run: {torch.equal(fres.core, res.core)}")
    check(flaunch == launches, f"fuse_core on the 4-way path launches {flaunch}, want {launches}")
    check(np.abs(fres.fit_history - hist).max() <= 1e-4, "fuse_core fit history differs")
    compare("NIPS core with fuse_core against the split run", "fp32", fres.core, res.core,
            NIPS_NNZ)
    del fplan, fres

    # each kernel at the path's shapes against its plain version, mode by
    # mode: the chain kernel, then kernels 3 and 4 on the unfused route
    # (``fused=False``), whose 51 GB second-link contrib exists once at a
    # time, the plain versions running on slot chunks.
    eng, fs = plan.engine, [f.contiguous() for f in res.factors]
    names = ("fused_kron_chain_scatter", "kron_contrib", "scatter_rows")
    tot = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
                  "bound_ms": 0.0, "max_abs_err": 0.0} for name in names}
    tot["fused_kron_chain_scatter"].update(f32_core_bound_ms=0.0, design_3xtf32_bound_ms=0.0)
    # the chain kernel's bf16_fp32acc route (2xTF32), a sweep's four modes
    # bounded as the fp32 route: the same operations at the TF32 rate, with
    # the CUDA-core and 2xTF32 yardsticks beside it
    tot_b = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
             "bound_ms": 0.0, "f32_core_bound_ms": 0.0, "design_2xtf32_bound_ms": 0.0,
             "max_abs_err": 0.0}
    unfused = {"launches": {}, "device_ms": {}, "gathers": 0}
    chain_worst = {p: 0.0 for p in TOL}  # the worst error over its limit
    per_mode = []
    for mode in range(4):
        sched = eng.device_schedule(coo, mode)
        n_rows = NIPS_SHAPE[mode]
        opf = [fs[t] for t in operand_modes(4, mode)]
        n_terms = max_row_count(coo, mode)
        nnzp = int(sched.vals.shape[0])
        m = {"mode": mode, "slots": nnzp, "rows": n_rows, "terms_a_row_max": n_terms,
             "ranges": int(sched.parts.numel()) - 1,
             "chain_ranges": int(sched.chain_cuts.numel()) - 1}
        # the chain kernel against its plain version (slot chunks), twice
        # for its bits
        fused = partial(kron_kernel.fused_kron_chain_scatter, opf, sched, n_rows)
        fused_plain = partial(kron_kernel.fused_kron_chain_scatter_plain, opf, sched, n_rows)
        yf = synced(fused())
        y_plain = synced(fused_plain())
        err_f = compare(f"fused_kron_chain_scatter NIPS mode {mode} ({nnzp} slots, "
                        f"{m['chain_ranges']} ranges)", "fp32", yf, y_plain, n_terms)
        chain_worst["fp32"] = max(chain_worst["fp32"],
                                  err_f / limit_of(y_plain, "fp32", n_terms)[0])
        same = torch.equal(yf, synced(fused()))
        log(f"  fused_kron_chain_scatter NIPS mode {mode}: the same bits from two calls: {same}")
        check(same, f"fused_kron_chain_scatter NIPS mode {mode} differs between two calls")
        # the unfused route, kernels 3 and 4 (sparse_ttm_chain_kernel with
        # fused=False): its launches and device time, and the chain kernel
        # against its Y
        got = {}
        reset_launches()
        gathers = ops._gathered_block_rows.calls
        prof = profile_run(lambda: got.update(y=ops.sparse_ttm_chain_kernel(
            coo, fs, mode, sched, fused=False)))
        unfused["gathers"] += ops._gathered_block_rows.calls - gathers
        for name, n in read_launches().items():
            if n:
                unfused["launches"][name] = unfused["launches"].get(name, 0) + n
        for name in ("kron_contrib", "scatter_rows"):
            unfused["device_ms"][name] = (unfused["device_ms"].get(name, 0.0)
                                          + prof["kernel_ms"][name])
        compare(f"fused_kron_chain_scatter NIPS mode {mode} against fused=False (kernels 3, 4)",
                "fp32", yf, got["y"], n_terms)
        del got
        f_ms = time_ms(fused, reps=10)
        f_plain = time_ms(fused_plain, reps=1)
        f_bytes, f_flops = chain_scatter_work(sched, opf, n_rows, NIPS_NNZ)
        del yf
        # the bf16_fp32acc route against its plain version, twice for its bits
        b16 = partial(kron_kernel.fused_kron_chain_scatter, opf, sched, n_rows,
                      precision="bf16_fp32acc")
        b16_plain = partial(kron_kernel.fused_kron_chain_scatter_plain, opf, sched, n_rows,
                            precision="bf16_fp32acc")
        yb, yb_plain = synced(b16()), synced(b16_plain())
        err_bf = compare(f"fused_kron_chain_scatter NIPS mode {mode}", "bf16_fp32acc", yb,
                         yb_plain, n_terms)
        chain_worst["bf16_fp32acc"] = max(
            chain_worst["bf16_fp32acc"], err_bf / limit_of(yb_plain, "bf16_fp32acc", n_terms)[0])
        nearer_exact(f"fused_kron_chain_scatter NIPS mode {mode}", yb, yb_plain,
                     synced(bf16_exact_chain_scatter(opf, sched, n_rows)))
        check(torch.equal(yb, synced(b16())),
              f"fused_kron_chain_scatter bf16 NIPS mode {mode} differs between two calls")
        del yb, yb_plain
        bf_ms, bf_plain = time_ms(b16, reps=10), time_ms(b16_plain, reps=1)
        # f_1 and f_2 staged in bf16, the later factors in f32
        bf_bytes, bf_flops = chain_scatter_work(
            sched, list(kron_kernel._cast_operands("bf16_fp32acc", *opf[:2])) + opf[2:], n_rows,
            NIPS_NNZ)
        torch.cuda.empty_cache()

        rows, v = ops._gathered_block_rows(coo.indices, coo.values, fs, mode, sched, 4)
        ones = torch.ones_like(v)
        k1 = rows[0].shape[1] * rows[1].shape[1]
        step = (1 << 26) // (k1 * rows[2].shape[1])  # slots per plain chunk: 268 MB
        # link 1: (nnzp, R) x (nnzp, R) -> (nnzp, R^2), written once, read by link 2
        c1 = synced(kron_kernel.kron_contrib(rows[0], rows[1], v))
        err1 = compare(f"kron_contrib NIPS mode {mode} link 1", "fp32", c1,
                       synced(kron_kernel.kron_contrib_plain(rows[0], rows[1], v)), 1)
        # link 2: (nnzp, R^2) x (nnzp, R) -> (nnzp, R^3), compared by chunks
        c2 = synced(kron_kernel.kron_contrib(c1, rows[2], ones))
        err2, scale2, finite = 0.0, 0.0, True
        for s in range(0, nnzp, step):  # chunks: a full-size temporary would not fit
            want = kron_kernel.kron_contrib_plain(c1[s:s + step], rows[2][s:s + step],
                                                  ones[s:s + step])
            err2 = max(err2, float((c2[s:s + step] - want).abs().max()))
            scale2 = max(scale2, float(want.abs().max()))
            finite = finite and bool(torch.isfinite(c2[s:s + step]).all())
        ok = finite and err2 <= TOL["fp32"] * max(scale2, 1e-30)
        log(f"  kron_contrib NIPS mode {mode} link 2 [fp32]: max_abs_err {err2:.3e} <= "
            f"{TOL['fp32'] * scale2:.3e} (by chunks of {step} slots) {'ok' if ok else 'FAIL'}")
        check(ok, f"kron_contrib NIPS mode {mode} link 2 disagrees with its plain version")
        y = synced(kron_kernel.scatter_rows(c2, sched, n_rows))
        err_s = compare(f"scatter_rows NIPS mode {mode}", "fp32", y,
                        synced(kron_kernel.scatter_rows_plain(c2, sched, n_rows)), n_terms)
        # the chain kernel's plain version is the chain of plain versions
        compare(f"Y_({mode}) NIPS, kernels 3 and 4 against the plain chain by chunks", "fp32",
                y, y_plain, n_terms)
        if mode == 3:  # the core update's unfolding, (17, 4096)
            y3, y3_plain = y, y_plain
        slots = slot_rows(sched)
        k = c2.shape[1]
        # times: scatter_rows while c2 exists, then kron_contrib with c2 freed
        s_ms = time_ms(partial(kron_kernel.scatter_rows, c2, sched, n_rows))
        s_plain = time_ms(partial(kron_kernel.scatter_rows_plain, c2, sched, n_rows), reps=1)
        s_lib = time_ms(lambda: torch.zeros((n_rows, k), device=dev).index_add_(0, slots, c2),
                        reps=1)
        s_bytes = nbytes_of(c2, sched.rel_row, sched.blkmap, sched.parts) + n_rows * k * 4
        s_flops = NIPS_NNZ * k
        del c2, y
        torch.cuda.empty_cache()
        c_ms = time_ms(partial(kron_kernel.kron_contrib, rows[0], rows[1], v))
        c_ms += time_ms(partial(kron_kernel.kron_contrib, c1, rows[2], ones))
        c_plain = time_ms(partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v))

        def link2_plain_chunks():
            for s in range(0, nnzp, step):
                kron_kernel.kron_contrib_plain(c1[s:s + step], rows[2][s:s + step],
                                               ones[s:s + step])

        c_plain += time_ms(link2_plain_chunks, reps=1)
        c_lib2 = time_ms(lambda: torch.einsum("ti,tj->tij", c1 * ones[:, None], rows[2]),
                         reps=3)
        c_lib = time_ms(lambda: torch.einsum("ti,tj->tij", rows[0] * v[:, None], rows[1]))
        c_lib += c_lib2
        # the bf16 route's first link: products of the bf16 rows rounded to
        # bf16, then scaled by the f32 values, as the kernel rounds them
        bf_lib = time_ms(lambda: torch.einsum("ti,tj->tij", rows[0].bfloat16(),
                                             rows[1].bfloat16()).float() * v[:, None, None])
        bf_lib += c_lib2 + s_lib
        c_bytes = nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + nnzp * k * 4
        c_flops = (kron_contrib_flops(nnzp, rows[0].shape[1], rows[1].shape[1])
                   + kron_contrib_flops(nnzp, k1, rows[2].shape[1], scaled=False))
        # the chain kernel's library time: the same function as one einsum a
        # link and index_add_ (no single call computes it)
        for name, ms, pl, lib, nb, fl, err, peak in (
                ("fused_kron_chain_scatter", f_ms, f_plain, c_lib + s_lib, f_bytes, f_flops,
                 err_f, PEAK_TF32_FLOPS),
                ("kron_contrib", c_ms, c_plain, c_lib, c_bytes, c_flops, max(err1, err2),
                 PEAK_F32_FLOPS),
                ("scatter_rows", s_ms, s_plain, s_lib, s_bytes, s_flops, err_s,
                 PEAK_F32_FLOPS)):
            b_ms, _ = bound(nb, fl, peak)
            t = tot[name]
            t["ms"] += ms
            t["plain_ms"] += pl
            t["library_ms"] += lib
            t["bytes"] += nb
            t["flops"] += fl
            t["bound_ms"] += b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
            m[name] = {"ms": ms, "plain_ms": pl, "library_ms": lib, "bound_ms": b_ms}
        bf_bound = bound(bf_bytes, bf_flops, PEAK_TF32_FLOPS)[0]
        for key, val in (("ms", bf_ms), ("plain_ms", bf_plain), ("library_ms", bf_lib),
                         ("bytes", bf_bytes), ("flops", bf_flops), ("bound_ms", bf_bound),
                         ("f32_core_bound_ms", bound(bf_bytes, bf_flops)[0]),
                         ("design_2xtf32_bound_ms",
                          bound(bf_bytes, 2 * bf_flops, PEAK_TF32_FLOPS)[0])):
            tot_b[key] += val
        tot_b["max_abs_err"] = max(tot_b["max_abs_err"], err_bf)
        m["fused_kron_chain_scatter_bf16"] = {"ms": bf_ms, "plain_ms": bf_plain,
                                              "library_ms": bf_lib, "bound_ms": bf_bound}
        t = tot["fused_kron_chain_scatter"]
        t["f32_core_bound_ms"] += bound(f_bytes, f_flops)[0]
        t["design_3xtf32_bound_ms"] += bound(f_bytes, 3 * f_flops, PEAK_TF32_FLOPS)[0]
        m["fused_kron_chain_scatter"]["us_per_slot"] = f_ms * 1e3 / nnzp
        log(f"    mode {mode}: {json.dumps(m)}")
        per_mode.append(m)
        del c1, rows, v, ones, slots, y_plain
        torch.cuda.empty_cache()
    check(unfused["launches"] == {"kron_contrib": 8, "scatter_rows": 4}
          and unfused["gathers"] == 4,
          f"the unfused unfoldings launched {unfused['launches']} with {unfused['gathers']} "
          f"gathers, want 8 and 4 launches and 4 gathers")
    # ms per slot of the mode of 17 long rows against the other modes' mean
    per_slot = [r["fused_kron_chain_scatter"]["us_per_slot"] for r in per_mode]
    skew = per_slot[3] / (sum(per_slot[:3]) / 3)
    log(f"  fused_kron_chain_scatter: {tot['fused_kron_chain_scatter']['ms']:.3f} ms a sweep, "
        f"us a slot by mode {[round(x, 6) for x in per_slot]}, mode 3 against the others' mean "
        f"{skew:.3f}x")
    # the bf16_fp32acc main path: its launches, sweep time, busy share and
    # the chain kernel's device time, beside the fp32 run's
    bf16_run = bf16_sweeps(dev, spec, coo, plan, hist, profile,
                           {"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER})
    b_device = bf16_run["profile"]["kernel_ms"]["fused_kron_chain_scatter"] / N_ITER
    route_b = kron_kernel.launch_route("fused_kron_chain_scatter", torch.float32, "bf16_fp32acc")
    log(f"  fused_kron_chain_scatter bf16_fp32acc ({route_b}): {tot_b['ms']:.3f} ms a "
        f"sweep (fp32 {tot['fused_kron_chain_scatter']['ms']:.3f}), device {b_device:.3f} (fp32 "
        f"{profile['kernel_ms']['fused_kron_chain_scatter'] / N_ITER:.3f}), plain "
        f"{tot_b['plain_ms']:.1f}, library {tot_b['library_ms']:.3f}, bound "
        f"{tot_b['bound_ms']:.4f}; worst error as a share of the limit "
        + ", ".join(f"[{p}] {chain_worst[p]:.3g}" for p in TOL) + "; the same bits twice")

    # the core update at the path's shapes: the TTM kernel on the transposed
    # views of Y_(3) (17, 4096) and U_3 (17, 16), against its plain version;
    # then the returned core against one made by the plain versions alone
    # (plain chain, plain TTM) from the returned factors, which are the ones
    # the last sweep's core update used.
    u3 = fs[3]
    ttm_row = {}
    for p in TOL:
        kern = partial(ttm_kernel.ttm, y3.T, u3.T, precision=p)
        plain = partial(ttm_kernel.ttm_plain, y3.T, u3.T, precision=p)
        err = compare(f"ttm NIPS y {tuple(y3.T.shape)} (transposed view) u {tuple(u3.T.shape)}",
                      p, check_ttm_call("NIPS", y3.T, u3.T, p), synced(plain()), y3.shape[0])
        ttm_row[p] = {"ms": time_ms(kern, reps=20), "plain_ms": time_ms(plain, reps=20),
                      "max_abs_err": err}
    core_plain = fold_dense(ttm_kernel.ttm_plain(y3_plain.T, u3.T).T, 3, NIPS_RANKS)
    core_err = compare("NIPS core against the plain chain and plain TTM", "fp32", res.core,
                       core_plain, NIPS_NNZ)
    del y3, y3_plain, core_plain
    print(json.dumps({
        "phase": "6 path A NIPS", "card": card, "shape": NIPS_SHAPE, "nnz": NIPS_NNZ,
        "ranks": NIPS_RANKS, "n_iter": N_ITER,
        "setup_s": {"generate_on_card": t_gen, "cold_decompose_incl_schedules": t_cold},
        "sweep_ms": sweep_ms, "fuse_core_sweep_ms": fused_sweep_ms,
        "launches_per_sweep": {k: n / N_ITER for k, n in launches.items()},
        "operand_row_gathers_warm_run": warm_gathers,
        "per_sweep": tot, "per_sweep_bf16_route": tot_b, "per_mode": per_mode,
        "chain_worst_share_of_limit": chain_worst, "bf16_fp32acc_sweeps": bf16_run,
        "mode3_per_slot_vs_others": skew,
        "unfused_unfoldings": unfused, "ttm_core_update": ttm_row,
        "core_max_abs_err_vs_plain": core_err, "profile_warm_run": profile,
        "peak_memory_gb": peak_gb, "fit_history": hist.tolist()}), flush=True)
    t = tot["fused_kron_chain_scatter"]
    out = {"fused_kron_chain_scatter": {
        "name": "fused_kron_chain_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kron_chain_scatter.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:74",
        "also_replaces": "src/repro/kernels/kron_kernel.py:207",
        "launches": launches["fused_kron_chain_scatter"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "device_ms": profile["kernel_ms"]["fused_kron_chain_scatter"] / N_ITER,
        "bound_ms": t["bound_ms"], "bound_by": bound(t["bytes"], t["flops"], PEAK_TF32_FLOPS)[1],
        "f32_core_bound_ms": t["f32_core_bound_ms"],
        "design_3xtf32_bound_ms": t["design_3xtf32_bound_ms"],
        # one einsum a link and index_add_: no single PyTorch call computes it
        "library_ms": t["library_ms"], "library": "torch.einsum x 2 + index_add_"}}
    out["fused_kron_chain_scatter_bf16"] = {
        "name": "fused_kron_chain_scatter_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kron_chain_scatter.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:74",
        "also_replaces": "src/repro/kernels/kron_kernel.py:207",
        # the bf16_fp32acc main path's run (bf16_sweeps), on 2xTF32
        "launches": bf16_run["launches"]["fused_kron_chain_scatter"],
        "path": "bf16_fp32acc, a warm plan of 5 sweeps",
        "max_abs_err": tot_b["max_abs_err"],
        "worst_share_of_limit": chain_worst["bf16_fp32acc"], "ms": tot_b["ms"],
        "plain_ms": tot_b["plain_ms"], "device_ms": b_device,
        "bound_ms": tot_b["bound_ms"],
        "bound_by": bound(tot_b["bytes"], tot_b["flops"], PEAK_TF32_FLOPS)[1],
        "f32_core_bound_ms": tot_b["f32_core_bound_ms"],
        "design_2xtf32_bound_ms": tot_b["design_2xtf32_bound_ms"],
        "library_ms": tot_b["library_ms"], "library": "torch.einsum x 2 + index_add_"}
    for name, src, line in (("kron_contrib", "kron_contrib.cu", 74),
                            ("scatter_rows", "scatter_rows.cu", 207)):
        t = tot[name]
        out[name] = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/kron_kernel.py:{line}",
            # the default order >= 4 path runs the chain kernel: these come
            # from the unfused unfoldings (fused=False), one sweep's worth
            "launches": unfused["launches"][name], "path": "fused=False",
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "device_ms": unfused["device_ms"][name],
            "bound_ms": t["bound_ms"], "bound_by": bound(t["bytes"], t["flops"])[1],
            "library_ms": t["library_ms"]}
    return out


# -- phase 10: the paper's Table V tensors --------------------------------------

# Table V tensors densified for the quality check up to this many entries
# (NELL-2's 1000^3 is 4 GB in f32; Amazon's 20000^3 would be 32 TB).
TABLE5_DENSE_MAX = 1 << 30


def tf32_off() -> None:
    """The dense products (the dense path, the reconstructions) must run in
    full f32 on the card, as on the CPU: TF32 must be off, as ``main`` set it
    and phase 9 restores it."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is allowed for float32 matrix products")


def error_at_nonzeros(coo, core, factors) -> float:
    """||X - Xhat|| / ||X|| from Xhat at the nonzeros alone, in float64 (a
    check, not the port's path): ||X - Xhat||^2 = ||X||^2 - 2 <X, Xhat> +
    ||G||^2 for orthonormal factors. Needs no dense tensor."""
    from repro_torch.core.reconstruct import reconstruct_at

    core, factors = core.double(), [f.double() for f in factors]
    x = coo.values.double()
    xx = float(x @ x)
    xhat = reconstruct_at(core, factors, coo.indices)
    return float(np.sqrt(max(xx - 2 * float(x @ xhat) + float((core * core).sum()), 0.0) / xx))


def warm_ms(fn, runs: int = 3) -> list:
    """Milliseconds of each of ``runs`` warm calls of ``fn``, each bracketed
    by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def table5_kernels(name, coo, eng, fs) -> dict:
    """Kernels 1 and 2 at one Table V tensor's shapes, on the card and
    against their plain versions (fp32): kernel 1 on every mode, kernel 2 on
    the core update; times, the plain versions' and ``torch.matmul``'s, and
    bounds as in phase 4 (kernel 1's products at the TF32 rate)."""
    from repro_torch.kernels import kron_kernel, ttm_kernel

    n = coo.ndim
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "bytes": 0,
          "flops": 0, "per_mode": []}
    y_last = None
    for mode in range(n):
        sched = eng.device_schedule(coo, mode)
        n_rows = coo.shape[mode]
        fa, fb = kron_factors(fs, mode)
        kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows)
        plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, sched, n_rows)
        got = synced(kern())
        k = got.shape[1]
        err = compare(f"fused_kron_scatter {name} mode {mode} (K {k}, {coo.nnz} nnz)", "fp32",
                      got, synced(plain()), max_row_count(coo, mode))
        check(torch.equal(got, synced(kern())), f"fused_kron_scatter {name} mode {mode} "
              f"differs between two calls")
        nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                            *[f for f in (fa, fb) if f is not None]) + n_rows * k * 4)
        flops = kron_scatter_flops(coo.nnz, fa.shape[1] if fb is not None else 0, k)
        ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
        b_ms = bound(nbytes, flops, PEAK_TF32_FLOPS)[0]
        k1["per_mode"].append({"mode": mode, "K": k, "ms": ms, "plain_ms": p_ms,
                               "bound_ms": b_ms})
        for key, v in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", b_ms), ("bytes", nbytes),
                       ("flops", flops)):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if mode == n - 1:
            y_last = got
    k1["bound_by"] = bound(k1["bytes"], k1["flops"], PEAK_TF32_FLOPS)[1]
    yc, uc = y_last.T, fs[n - 1].T
    l_, i_ = yc.shape
    err = compare(f"ttm {name} y {tuple(yc.shape)} u {tuple(uc.shape)}", "fp32",
                  check_ttm_call(name, yc, uc, "fp32"),
                  synced(ttm_kernel.ttm_plain(yc, uc)), i_)
    nbytes = (l_ * i_ + uc.shape[0] * i_) * 4 + l_ * uc.shape[0] * 4
    flops = 2 * l_ * i_ * uc.shape[0]
    k2 = {"ms": time_ms(partial(ttm_kernel.ttm, yc, uc), reps=20, flush_l2=True),
          "plain_ms": time_ms(partial(ttm_kernel.ttm_plain, yc, uc), reps=20, flush_l2=True),
          "library_ms": time_ms(partial(torch.matmul, yc, uc.T), reps=20, flush_l2=True),
          "bound_ms": bound(nbytes, flops)[0], "bound_by": bound(nbytes, flops)[1],
          "max_abs_err": err, "shape": [l_, i_, uc.shape[0]]}
    return {"fused_kron_scatter": k1, "ttm": k2}


def phase10_table5(dev, card: str) -> None:
    from repro_torch import tucker
    from repro_torch.core.hooi import sweep_call_counts
    from repro_torch.core.reconstruct import relative_error_dense
    from repro_torch.sparse.datasets import PAPER_DATASETS

    tf32_off()
    log("phase 10: the paper's Table V tensors at their published shapes, ranks and sweeps, "
        "householder")
    for name, ds in PAPER_DATASETS.items():
        release_memory()
        t0 = time.perf_counter()
        coo = ds.build(device=dev)  # drawn in numpy as the reference draws it
        t_build = time.perf_counter() - t0
        spec = tucker.spec_for(coo, ds.ranks, n_iter=ds.n_iter, method="householder")
        n, n_iter = coo.ndim, ds.n_iter
        expect = {"fused_kron_scatter": n * n_iter, "ttm": n_iter}
        label = f"{name} {ds.shape}, {coo.nnz} nnz, ranks {spec.ranks}, {n_iter} sweeps"
        cu, _ = card_vs_cpu(label, coo, spec=spec, expect=expect,
                            align="basis" if name == "matmul" else "sign")

        # quality: the fit against an error that does not use the projection
        # identity, the dense one where the tensor can be densified
        at_nnz = error_at_nonzeros(coo, cu.core, cu.factors)
        dense = None
        if math.prod(ds.shape) <= TABLE5_DENSE_MAX:
            dense = float(relative_error_dense(coo.to_dense(), cu.core, cu.factors))
        indep = dense if dense is not None else at_nnz
        log(f"  {name}: rel_error {cu.rel_error:.7f}, dense error {dense}, error at the "
            f"nonzeros (f64) {at_nnz:.7f}; |rel_error - independent| "
            f"{abs(cu.rel_error - indep):.3e} <= 1e-4")
        check(abs(cu.rel_error - indep) <= 1e-4,
              f"{name}: rel_error {cu.rel_error} against the independent error {indep}")

        # the tensor's main path on the card: cold (schedules) and warm
        release_memory()
        plan = tucker.plan(spec, device=dev)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        res = plan(coo)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(launches == expect, f"{name}: launches {launches}, want {expect}")
        check(res.n_sweeps == n_iter and bool(np.all(np.isfinite(res.fit_history))),
              f"{name}: fit history {res.fit_history}")
        runs = [ms / n_iter for ms in warm_ms(lambda: plan(coo))]
        kernels = table5_kernels(name, coo, plan.engine, [f.contiguous() for f in res.factors])
        counts = sweep_call_counts(ds.shape, spec.ranks, coo.nnz, n_iter)
        summary = {
            "phase": "10 Table V", "card": card, "dataset": name, "shape": ds.shape,
            "nnz": coo.nnz, "ranks": spec.ranks, "n_iter": n_iter, "exact": ds.exact,
            "build_s": t_build, "cold_decompose_incl_schedules_s": t_cold,
            "sweep_ms": float(np.median(runs)), "sweep_ms_warm_runs": runs,
            "peak_memory_gb": peak / 1e9, "above_resident_gb": (peak - resident) / 1e9,
            "launches": launches, "sweep_call_counts": counts,
            "qrp_calls_run": n * n_iter,
            # the quality of the card's run from card_vs_cpu's factors; the
            # timed runs start from the plan's default draw
            "fit_history": cu.fit_history.tolist(), "rel_error": cu.rel_error,
            "dense_error": dense, "error_at_nonzeros": at_nnz,
            "timed_run_fit_history": res.fit_history.tolist(), "kernels": kernels,
        }
        log(f"  {name}: {summary['sweep_ms']:.3f} ms per sweep (warm runs "
            + ", ".join(f"{m:.3f}" for m in runs) + f"), peak {peak / 1e9:.3f} GB, "
            f"call counts {counts}")
        print(json.dumps(summary), flush=True)
        del coo, cu, res, plan
    release_memory()


# -- phase 11: dense HOOI (Table II, Fig. 6) and completion -----------------------

TABLE2_SIZE = 800  # the paper's largest Table II size, 2.05 GB in f32
TABLE2_RANK = 16
METHODS = ("svd", "householder", "gram")


def table2_tensor(size: int, dev, rank: int = TABLE2_RANK, dtype=torch.float32,
                  noise: bool = True):
    """``benchmarks/table2_accuracy.py``'s tensor in f32: a random
    rank-(16, 16, 16) tensor, factors and core from ``default_rng(size)``,
    the product taken as a TTM chain in f64 on ``dev``, plus noise of 1e-9;
    the noise from that numpy generator on the CPU (as the benchmark and the
    CPU test at 200^3 draw it), from a torch generator seeded with ``size``
    on the card (512 M numpy draws would take the host ~10 s). ``dtype``
    float64 keeps it in f64; ``noise=False`` leaves the exact rank-16
    tensor."""
    from repro_torch.core.reconstruct import reconstruct_dense

    rng = np.random.default_rng(size)
    us = [np.linalg.qr(rng.standard_normal((size, rank)))[0] for _ in range(3)]
    g = rng.standard_normal((rank,) * 3)
    x = reconstruct_dense(torch.from_numpy(g).to(dev), [torch.from_numpy(u).to(dev) for u in us])
    if not noise:
        pass
    elif x.device.type == "cpu":
        x += 1e-9 * torch.from_numpy(rng.standard_normal(x.shape))
    else:
        gen = torch.Generator(device=x.device).manual_seed(size)
        x += 1e-9 * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x.to(dtype)


def phase11_dense(dev, card: str) -> None:
    from repro_torch import tucker
    from repro_torch.core.reconstruct import reconstruct_dense, relative_error_dense
    from repro_torch.sparse.generators import low_rank_sparse_tensor, random_sparse_tensor

    tf32_off()
    log(f"phase 11: dense HOOI (Table II at {TABLE2_SIZE}^3, Fig. 6) and completion")
    summary = {"phase": "11 dense HOOI and completion", "card": card}

    # Table II: the card against the CPU at 200^3, then the paper's 800^3.
    # The fit here sits at the f32 floor of the projection identity (ROADMAP
    # queue 3): sqrt(||X||^2 - ||G||^2) cancels to 0 or to a few 1e-4 by
    # rounding alone, so the fit histories are held to 1e-3; the dense
    # errors, which do not cancel, are printed beside them.
    x200 = table2_tensor(200, torch.device("cpu"))
    for method in METHODS:
        cu, cp = card_vs_cpu(
            f"Table II 200^3, rank 16, {method}", x200, fit_tol=1e-3,
            spec=tucker.TuckerSpec(x200.shape, (TABLE2_RANK,) * 3, algorithm="dense",
                                   method=method, n_iter=3))
        e_card = relative_error_dense(x200, cu.core.cpu(), [f.cpu() for f in cu.factors])
        e_cpu = relative_error_dense(x200, cp.core, cp.factors)
        log(f"  dense error card {float(e_card):.3e}, CPU {float(e_cpu):.3e}")
    del x200, cu, cp
    t0 = time.perf_counter()
    x = table2_tensor(TABLE2_SIZE, dev)
    torch.cuda.synchronize()
    table2 = {"size": TABLE2_SIZE, "build_s": time.perf_counter() - t0}
    for method in METHODS:
        plan = tucker.plan(tucker.spec_for(x, (TABLE2_RANK,) * 3, n_iter=3, method=method),
                           device=dev)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        res = plan(x)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(not launches and res.engine == "torch" and res.dispatches == 0
              and res.launches == 0, f"Table II {method}: launches {launches}, engine "
              f"{res.engine}, dispatches {res.dispatches}")
        runs = [ms / 3 for ms in warm_ms(lambda: plan(x))]
        err = float(relative_error_dense(x, res.core, res.factors))
        table2[method] = {"rel_error_dense": err, "rel_error": res.rel_error,
                          "fit_history": res.fit_history.tolist(),
                          "sweep_ms": float(np.median(runs)), "sweep_ms_warm_runs": runs,
                          "cold_s": cold, "peak_memory_gb": peak / 1e9,
                          "above_resident_gb": (peak - resident) / 1e9}
        log(f"  Table II {TABLE2_SIZE}^3 {method}: relative_error_dense {err:.3e} <= 1e-5, "
            f"{table2[method]['sweep_ms']:.2f} ms per sweep, peak {peak / 1e9:.2f} GB "
            f"({(peak - resident) / 1e9:.2f} above the tensor)")
        check(err <= 1e-5, f"Table II {method}: relative_error_dense {err}")
    # the claim: QRP loses no accuracy against SVD, to 1e-6. One-sided: in
    # f32 the SVD update's own error grows with the size while QRP's does
    # not (on the CPU: svd 0.98e-6 at 200^3, 2.0e-6 at 400^3 and 600^3;
    # householder 0.79e-6, 0.78e-6, 0.94e-6), so |qrp - svd| <= 1e-6 would
    # fail for SVD's rounding, not for a loss of QRP's
    for method in ("householder", "gram"):
        gap = table2[method]["rel_error_dense"] - table2["svd"]["rel_error_dense"]
        log(f"  Table II: {method} - svd = {gap:.3e} (<= 1e-6)")
        check(gap <= 1e-6, f"Table II: {method} loses {gap} against svd")
    summary["table2"] = table2
    del x, plan, res
    release_memory()

    # Fig. 6: sparse HOOI (gram) against dense HOOI (svd) at 200^3, 2 sweeps;
    # warm times of whole decompositions, nothing gated on speed
    fig6 = []
    for sp in (1e-5, 1e-4, 1e-3):
        coo = random_sparse_tensor((200,) * 3, sp, seed=int(sp * 1e7) % 997).to(dev)
        sparse_plan = tucker.plan(tucker.spec_for(coo, (16,) * 3, n_iter=2, method="gram"),
                                  device=dev)
        reset_launches()
        rs = sparse_plan(coo)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        check(launches == {"fused_kron_scatter": 6, "ttm": 2},
              f"Fig. 6 sparse {sp}: launches {launches}")
        dense = coo.to_dense()
        dense_plan = tucker.plan(tucker.spec_for(dense, (16,) * 3, n_iter=2, method="svd"),
                                 device=dev)
        reset_launches()
        rd = dense_plan(dense)
        torch.cuda.synchronize()
        check(not any(read_launches().values()), f"Fig. 6 dense {sp} launched kernels")
        for r in (rs, rd):
            check(bool(np.all(np.isfinite(r.fit_history)))
                  and bool(np.all((r.fit_history >= 0) & (r.fit_history <= 1))),
                  f"Fig. 6 {sp}: fit history {r.fit_history}")
        sparse_ms = time_ms(lambda: sparse_plan(coo), reps=3)
        dense_ms = time_ms(lambda: dense_plan(dense), reps=3)
        fig6.append({"sparsity": sp, "nnz": coo.nnz, "sparse_gram_ms": sparse_ms,
                     "dense_svd_ms": dense_ms, "speedup": dense_ms / sparse_ms,
                     "sparse_fit": rs.fit_history.tolist(), "dense_fit": rd.fit_history.tolist()})
        log(f"  Fig. 6 200^3 at {sp:g} ({coo.nnz} nnz): sparse gram {sparse_ms:.2f} ms, "
            f"dense svd {dense_ms:.2f} ms (2 sweeps, warm)")
    summary["fig6"] = fig6
    release_memory()

    # completion: the card against the CPU at 64x64x32, then an MRI-sized
    # 256x256x128 volume observed at 20% of its entries
    ranks, kw = (16, 16, 16), dict(algorithm="complete", method="gram", n_iter=2, n_rounds=10)
    small, _ = low_rank_sparse_tensor((64, 64, 32), ranks, 0.2, seed=SEED)
    card_vs_cpu("completion 64x64x32, 20% observed, ranks 16", small,
                spec=tucker.TuckerSpec(small.shape, ranks, **kw))
    t0 = time.perf_counter()
    coo, truth = low_rank_sparse_tensor((256, 256, 128), ranks, 0.2, seed=SEED)
    t_gen = time.perf_counter() - t0
    coo = coo.to(dev)
    plan = tucker.plan(tucker.spec_for(coo, ranks, **kw), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    res = plan(coo)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    check(not any(read_launches().values()), "completion launched kernels")
    runs = [ms / kw["n_rounds"] for ms in warm_ms(lambda: plan(coo), runs=1)]
    x_true = reconstruct_dense(torch.from_numpy(truth["core"]).to(dev),
                               [torch.from_numpy(f).to(dev) for f in truth["factors"]]).float()
    seen = torch.zeros(coo.shape, dtype=torch.bool, device=dev)
    seen[tuple(coo.indices.long().T)] = True
    diff = reconstruct_dense(res.core, res.factors) - x_true
    unobserved = float(diff[~seen].norm() / x_true[~seen].norm())
    observed = float(diff[seen].norm() / x_true[seen].norm())
    check(np.isfinite(unobserved) and bool(np.all(np.isfinite(res.fit_history))),
          f"completion: error {unobserved}, fit {res.fit_history}")
    summary["completion"] = {
        "shape": coo.shape, "ranks": ranks, "observed": coo.nnz, **kw,
        "generate_s": t_gen, "cold_s": cold, "ms_per_em_round": runs[0],
        "error_unobserved": unobserved, "error_observed": observed,
        "fit_history_last_round": res.fit_history.tolist()}
    log(f"  completion 256x256x128, {coo.nnz} observed: error on the unobserved entries "
        f"{unobserved:.4e} (observed {observed:.4e}), {runs[0]:.2f} ms per EM round, "
        f"generated in {t_gen:.1f} s")
    print(json.dumps(summary), flush=True)
    del coo, plan, res, x_true, seen, diff
    release_memory()


# -- phase 7: the LM kernels at odd shapes ------------------------------------

# (b, H, KVH, S, T, D, causal, what the case covers)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, "GQA G=2"),
    (1, 8, 4, 64, 256, 32, True, "T > S"),
    (2, 2, 2, 100, 100, 64, True, "S not a block multiple"),
    (1, 4, 1, 128, 128, 128, True, "MQA, D 128"),
    (2, 3, 3, 77, 77, 80, True, "D 80, S 77"),
    (1, 6, 2, 33, 200, 16, True, "D 16, G 3, T > S"),
    (2, 2, 1, 1, 300, 80, True, "one query row, as in decode"),
    (1, 4, 2, 70, 130, 48, False, "non-causal, T not a block multiple"),
    (4, 32, 32, 1024, 1024, 80, True, "the Zamba2 serving shape at S 1,024"),
    (1, 4, 2, 300, 300, 80, True, "S 300, not a multiple of the 128-row q block"),
    (1, 6, 2, 200, 520, 64, True, "T > S, G 3, T not a multiple of the 128-key block"),
]
# the model's layout, (b, s, heads, hd) projections passed as (b, heads, s,
# hd) views: (b, s, t, H, KVH, D, causal, what the case covers); D 28 (the
# qwen2-7b SMOKE head dim) breaks TMA's 16-byte rules and takes the tensor-core
# kernel's ordinary-load staging
VIEW_CASES = [
    (2, 90, 90, 6, 3, 80, True, "D 80, G 2"),
    (2, 130, 130, 4, 4, 16, True, "D 16"),
    (1, 200, 200, 6, 2, 64, True, "D 64, G 3"),
    (2, 129, 129, 2, 1, 128, True, "D 128, MQA"),
    (2, 100, 100, 4, 2, 28, True, "D 28: ordinary-load staging"),
    (1, 64, 192, 4, 2, 80, True, "D 80, T > S"),
    (2, 77, 150, 4, 2, 80, False, "D 80, non-causal"),
]
# (BH, C, L, P, N, decay rate, what the case covers); the log decays are
# cumulative sums of -rate * |N(0, 1)|. Each case runs with B and C in bf16
# and in f32.
SSD_CASES = [
    (2, 3, 64, 32, 16, 0.1, "the reference kernel test's first shape"),
    (1, 1, 128, 64, 32, 0.1, "the reference kernel test's second shape"),
    (2, 2, 32, 16, 16, 0.1, "L 32"),
    (3, 2, 256, 64, 64, 0.1, "L 256, N = P 64 (the Zamba2 path's chunk)"),
    (1, 3, 100, 48, 80, 0.1, "L, N, P not multiples of 16 or 64"),
    (2, 1, 200, 128, 128, 0.1, "N = P 128"),
    (1, 2, 256, 16, 128, 0.1, "P 16, N 128"),
    (2, 2, 256, 64, 64, 8.0, "steep decay: exp above the diagonal overflows"),
    (3, 2, 1, 17, 1, 0.1, "L 1, N 1, P 17"),
    (2, 2, 63, 1, 17, 0.1, "L 63, P 1, N 17"),
    (2, 1, 64, 80, 64, 0.1, "L 64, P 80"),
    (1, 3, 255, 64, 80, 0.1, "L 255, N 80"),
    (1, 2, 255, 17, 64, 8.0, "L 255, P 17, steep decay"),
    (2, 1, 256, 128, 1, 0.1, "N 1, P 128"),
    (1, 2, 256, 1, 128, 8.0, "P 1, N 128, steep decay"),
]


def phase7_lm_kernels(dev) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    log("phase 7: kernels 6 and 7 against their plain versions, odd shapes")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def attend(label, q, k, v, causal, n_terms):
        """One call against the plain version; bf16 must take the wgmma
        route and f32 the simt route, once each."""
        prec = "bf16" if q.dtype == torch.bfloat16 else "fp32"
        route = "wgmma" if prec == "bf16" else "simt"
        staging = fa.launch_plan(q.dtype, (q.shape, k.shape, v.shape),
                                 (q.stride(), k.stride(), v.stride()),
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr()), causal=causal)[1]
        before = dict(fa.flash_attention.launches_by_route)
        got = synced(fa.flash_attention(q, k, v, causal=causal))
        taken = {r: n - before[r] for r, n in fa.flash_attention.launches_by_route.items()}
        check(taken == {"wgmma": int(route == "wgmma"), "simt": int(route == "simt")},
              f"flash_attention {label} [{prec}] took routes {taken}, want {route}")
        want = synced(fa.flash_attention_plain(q, k, v, causal=causal))
        check(got.dtype == q.dtype and got.shape == want.shape and got.stride() == q.stride(),
              f"flash_attention {label}: {got.dtype} {tuple(got.shape)} {got.stride()}")
        compare(f"flash_attention {label} ({route}{', ' + staging if staging else ''})", prec,
                got.float(), want.float(), n_terms)
        return staging

    for b, h, kvh, s, t, d, causal, label in FLASH_CASES:
        q32, k32, v32 = randn(b, h, s, d), randn(b, kvh, t, d), randn(b, kvh, t, d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            attend(f"{label} {(b, h, kvh, s, t, d)}", q, k, v, causal, t * d)
    # the model's layout: views read through their strides, the output in q's
    for b, s, t, h, kvh, d, causal, label in VIEW_CASES:
        qm, km, vm = randn(b, s, h, d), randn(b, t, kvh, d), randn(b, t, kvh, d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype).transpose(1, 2) for x in (qm, km, vm))
            staging = attend(f"(b, s, heads, hd) views {label} {(b, h, kvh, s, t, d)}",
                             q, k, v, causal, t * d)
            if dtype == torch.bfloat16:
                check(staging == ("threads" if (2 * d) % 16 else "tma"),
                      f"flash_attention views {label}: staging {staging}")

    for bh, c, n_l, p, n, rate, label in SSD_CASES:
        x, bm, cm = randn(bh, c, n_l, p), randn(bh, c, n_l, n), randn(bh, c, n_l, n)
        acs = torch.cumsum(-rate * randn(bh, c, n_l).abs(), dim=-1)
        for dtype in (torch.bfloat16, torch.float32):
            b_, c_ = bm.to(dtype), cm.to(dtype)
            y, st = synced(ssd_scan.ssd_chunk(x, acs, b_, c_))
            y_want, st_want = synced(ssd_scan.ssd_chunk_plain(x, acs, b_, c_))
            tag = f"ssd_chunk {label} {(bh, c, n_l, p, n)} B, C {str(dtype)[6:]}"
            compare(f"{tag} y", "fp32", y, y_want, n_l * n)
            compare(f"{tag} state", "fp32", st, st_want, n_l)


# -- phase 8: Zamba2 SMOKE, card against CPU -----------------------------------

# Card against CPU for the SMOKE model, as a fraction of max|CPU logit|.
# float32: both devices compute in f32 (no TF32), but the bf16 K/V cache,
#   conv states and inter-chunk SSD states are rounded from f32 values that
#   differ in their last bits between the devices, so a rounded entry can
#   land one bf16 ulp (2^-8 relative) away; on the CPU the port against the
#   JAX reference shows up to 1.7e-3 from that alone (3 chunks, 8 steps).
# bfloat16: every activation is rounded to bf16 after each op on both sides,
#   at places where the two devices' f32 sums differ; on the CPU the port
#   against the JAX reference differs by up to 5e-2 for that reason.
LM_TOL = {"float32": 5e-3, "bfloat16": 1e-1}
SMOKE_B, SMOKE_P, SMOKE_NEW = 3, 40, 8  # batch, prompt (two SSD chunks), new tokens


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_leaves(v)
    else:
        yield tree


def greedy_agrees(got, want, ref_logits, tol: float, vocab: int, label: str) -> int:
    """``got`` and ``want`` (B, P + n) greedy tokens must agree up to a step
    where the reference's two best logits are within ``tol`` x max|logit|
    (a near tie, which either side may break); ``ref_logits[i]`` (B, V) are
    the logits that chose token i of ``want``. Returns the steps that
    agreed."""
    n = len(ref_logits)
    p = want.shape[1] - n
    for i in range(n):
        if np.array_equal(got[:, p + i], want[:, p + i]):
            continue
        lg = ref_logits[i][:, :vocab].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        limit = tol * float(lg.abs().max())
        log(f"  {label}: tokens differ at step {i}; the reference's smallest top-2 gap there "
            f"{gap:.3e}, limit {limit:.3e}")
        check(gap <= limit, f"{label}: greedy tokens differ at step {i} where the reference's "
              f"top-2 gap {gap:.3e} exceeds {limit:.3e}")
        return i
    return n


def teacher_forced(eng, tokens, p: int, n: int):
    """Prefill ``tokens[:, :p]``, then ``n - 1`` decode steps fed with
    ``tokens[:, p + i]``: the n logits that choose tokens p .. p + n - 1, and
    the prefill cache."""
    dev = eng.device
    t = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    logits, cache = eng.prefill(eng.params, {"tokens": t[:, :p]})
    prefill_cache = cache
    cache = eng._pad_cache(cache, p)
    out = [logits]
    for i in range(n - 1):
        logits, cache = eng.decode(eng.params, cache, {"token": t[:, p + i:p + i + 1],
                                                       "pos": p + i})
        out.append(logits)
    return out, prefill_cache


def phase8_smoke_card_vs_cpu(dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    log(f"phase 8: zamba2-2.7b SMOKE, card against CPU from the same weights "
        f"(batch {SMOKE_B}, prompt {SMOKE_P}, {SMOKE_NEW} new tokens)")
    rng = np.random.default_rng(SEED)
    for dtype, tol in LM_TOL.items():
        cfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True), dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        scfg = ServeConfig(max_seq_len=SMOKE_P + SMOKE_NEW, batch_size=SMOKE_B)
        eng = {"cpu": Engine(cfg, params, scfg, device="cpu"),
               "cuda": Engine(cfg, tree_to(params, dev), scfg, device=dev)}
        prompts = rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_P))
        # greedy tokens on each device, then both devices teacher-forced on
        # the CPU's tokens: prefill logits and every decode step's logits
        out = {d: e.generate(prompts, SMOKE_NEW) for d, e in eng.items()}
        reset_launches()
        logits = {}
        for d, e in eng.items():
            logits[d], cache = teacher_forced(e, out["cpu"], SMOKE_P, SMOKE_NEW)
            if d == "cuda":
                launches = {k: v for k, v in read_launches().items() if v}
                n_sb = cfg.n_layers // cfg.hybrid_period
                check(launches == {"flash_attention": n_sb, "ssd_chunk": cfg.n_layers},
                      f"SMOKE card prefill launches {launches}")
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            a = a.float().cpu()
            b = b.float()
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            what = "prefill" if i == 0 else f"decode step {i}"
            log(f"  {dtype} {what}: max_abs_err {err:.3e} <= {tol * scale:.3e} "
                f"(tol {tol} x max|cpu logit| {scale:.3e})")
            check(bool(torch.isfinite(a).all()) and err <= tol * scale,
                  f"SMOKE {dtype} {what}: card and CPU logits disagree")
        agreed = greedy_agrees(out["cuda"], out["cpu"], logits["cpu"], tol, cfg.vocab_size,
                               f"SMOKE {dtype} greedy")
        log(f"  {dtype} greedy tokens: {agreed} of {SMOKE_NEW} steps equal")
        check(out["cuda"].shape == (SMOKE_B, SMOKE_P + SMOKE_NEW)
              and np.array_equal(out["cuda"][:, :SMOKE_P], prompts), "SMOKE generate shape")


# -- phase 9: the slice's path, Zamba2-2.7B served at full width ---------------

SERVE_B, SERVE_P, SERVE_NEW, SERVE_MAX = 4, 4096, 64, 4224
# the tokens each cold ``generate`` of phases 9 and 19 makes (SERVE_NEW until
# PR 29, cut to make room for phase 25): it checks the main path's launches
# and output; tokens/s come from the warm runs at SERVE_NEW, as before
COLD_NEW = 16
# The last-token prefill logits with the kernels against a prefill that runs
# the plain versions on the card: a guard against gross faults (wrong wiring,
# a lost chunk, NaN), not a check of rounding. The mixer rounds y_diag +
# y_inter to bf16 (models/mamba2.py), so one f32 ulp of kernel 7's outputs
# flips bf16 roundings, and random weights carry that chaotically through 54
# layers to a few % of max|logit| (PERF.md section 6: kernel 7 in f64 and
# correctly rounded moved them 5.21%, noise of 1e-7 on y 4.81%, one TF32
# pass 8.13%). So the limit is measured in the same run: the movement the
# f64 control (a prefill of the plain versions with the SSD chunk in f64)
# causes, times SERVE_LOGIT_MARGIN. A correctly rounded kernel 7 moves the
# logits as the f64 control does, and kernel 6 adds its own rounding beside
# it; 3x leaves room for both, while a gross fault moves the logits by the
# order of max|logit|. This guard alone does not separate the TF32 control
# from a correct kernel 7 (8.13% is within 3 x 5.21%): the per-layer fp32
# check of kernel 7 (``ssd_per_layer_gate``) does, and its TF32 control must
# fail it in every run.
SERVE_LOGIT_MARGIN = 3.0


def capture_inputs(fn) -> dict:
    """Run ``fn`` with ``ops.flash_attention`` and ``ops.ssd_chunk`` wrapped
    so that the arguments of each one's first call are kept (cloned, strides
    included): one layer's real inputs at the path's shapes."""
    from repro_torch.kernels import ops

    kept, orig = {}, {n: getattr(ops, n) for n in ("flash_attention", "ssd_chunk")}

    def keeper(name):
        def call(*args, **kwargs):
            kept.setdefault(name, ([a.clone() for a in args], dict(kwargs)))
            return orig[name](*args, **kwargs)
        return call

    try:
        for n in orig:
            setattr(ops, n, keeper(n))
        fn()
    finally:
        for n, f in orig.items():
            setattr(ops, n, f)
    return kept


def with_plain_kernels(fn, ssd=None):
    """``fn()`` with the model's two LM kernel calls sent to their plain
    versions (the reference prefill on the card); ``ssd`` replaces the plain
    SSD chunk when given."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd_scan

    orig = ops.flash_attention, ops.ssd_chunk
    ops.flash_attention, ops.ssd_chunk = fa.flash_attention_plain, ssd or ssd_scan.ssd_chunk_plain
    try:
        return fn()
    finally:
        ops.flash_attention, ops.ssd_chunk = orig


def serving_setup(dev):
    """Zamba2-2.7B as registered, weights from the seed on the card, its
    serving engine and the seeded prompts; and the seconds the weights took."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng = Engine(cfg, params, ServeConfig(max_seq_len=SERVE_MAX, batch_size=SERVE_B), device=dev)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (SERVE_B, SERVE_P))
    return cfg, params, eng, prompts, t_init


def ssd_chunk_f64(x, a, b, c):
    """Kernel 7's function in f64 on the card, rounded to f32: the function
    correctly rounded, the control that the fp32 rule must pass."""
    x, a, bm, cm = (t.double() for t in (x, a, b, c))
    causal = torch.ones((x.shape[2], x.shape[2]), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
    y = ((cm @ bm.transpose(-1, -2)) * decay) @ x
    st = (bm * torch.exp(a[..., -1:] - a)[..., None]).transpose(-1, -2) @ x
    return y.float(), st.float()


def ssd_chunk_tf32(x, a, b, c):
    """``ssd_chunk_plain`` with its f32 products on one TF32 pass (cuBLAS
    with TF32 allowed): the control that the fp32 rule must fail."""
    from repro_torch.kernels import ssd_scan

    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return ssd_scan.ssd_chunk_plain(x, a, b, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def ssd_rule(got, want, n_l: int, n_state: int) -> dict:
    """Kernel 7's outputs (y, state) against the plain version's at the fp32
    rule, n = L N terms for y and L for the state: each one's error over
    its limit, and whether both are within."""
    out = {}
    for what, g, w, n_terms in (("y", got[0], want[0], n_l * n_state),
                                ("state", got[1], want[1], n_l)):
        err, limit, _, _, ok = against_plain(g, w, "fp32", n_terms)
        out[what] = {"max_abs_err": err, "limit": limit, "over_limit": err / limit, "ok": ok}
    out["ok"] = out["y"]["ok"] and out["state"]["ok"]
    return out


def ssd_per_layer_gate(fn, n_calls: int):
    """Run ``fn`` (a prefill that runs the kernels) with ``ops.ssd_chunk``
    wrapped: each call launches kernel 7, runs ``ssd_chunk_plain`` on the
    same inputs, holds y and the state to the fp32 rule (``ssd_rule``) and
    passes the kernel's own outputs on, so that each layer is judged on the
    inputs it really receives and nothing is kept beyond the call. Fails at
    the first call outside the rule or if there were not ``n_calls`` calls;
    returns the worst call and ``fn``'s result."""
    from repro_torch.kernels import ops, ssd_scan

    orig, worst, calls = ops.ssd_chunk, {"over_limit": -1.0}, [0]

    def gated(x, a, b, c):
        got = orig(x, a, b, c)
        layer = calls[0]
        calls[0] += 1
        r = ssd_rule(got, ssd_scan.ssd_chunk_plain(x, a, b, c), x.shape[2], b.shape[3])
        check(r["ok"], f"kernel 7 at layer {layer} is outside the fp32 rule: {json.dumps(r)}")
        for what in ("y", "state"):
            if r[what]["over_limit"] > worst["over_limit"]:
                worst.update(r[what], layer=layer, output=what)
        return got

    ops.ssd_chunk = gated
    try:
        out = fn()
    finally:
        ops.ssd_chunk = orig
    check(calls[0] == n_calls, f"the gated prefill made {calls[0]} SSD chunk calls, want {n_calls}")
    worst.pop("ok")
    return dict(worst, calls=calls[0]), out


def phase9_zamba2(dev, card: str):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    cfg, params, eng, prompts, t_init = serving_setup(dev)
    n_sb = cfg.n_layers // cfg.hybrid_period
    log(f"phase 9: {cfg.name} as registered ({cfg.n_layers} Mamba-2 layers, d {cfg.d_model}, "
        f"{n_sb} shared-attention calls), batch {SERVE_B}, prompts of {SERVE_P}, "
        f"{SERVE_NEW} new tokens, max_seq_len {SERVE_MAX}")
    n_params = sum(t.numel() for t in param_leaves(params))

    # the main path: every count starts at 0 here and is read right after.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, COLD_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_launches()
    fa_routes = dict(fa.flash_attention.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  generate (cold, {COLD_NEW} new tokens): {t_gen:.3f} s, launches {launches}, "
        f"flash_attention routes "
        f"{fa_routes}, peak {peak_gb:.2f} GB, {n_params / 1e9:.3f} B parameters "
        f"(init {t_init:.2f} s)")
    check(launches == {"fused_kron_scatter": 0, "ttm": 0, "kron_contrib": 0, "scatter_rows": 0,
                       "fused_kron_scatter_ttm": 0, "fused_kron_chain_scatter": 0,
                       "flash_attention": n_sb,
                       "ssd_chunk": cfg.n_layers},
          f"serving launches {launches}, want {n_sb} and {cfg.n_layers} (one prefill)")
    check(fa_routes == {"wgmma": n_sb, "simt": 0},
          f"prefill attention routes {fa_routes}, want all {n_sb} on the tensor-core kernel")
    check(out.shape == (SERVE_B, SERVE_P + COLD_NEW) and np.array_equal(out[:, :SERVE_P], prompts)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"generate output {out.shape}")

    # warm timings: prefill and decode steps by CUDA events, generate by the
    # host clock; device busy time of one prefill and of 8 decode steps by the
    # profiler, over the same work's time without the profiler
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    prefill_ms = time_ms(lambda: eng.prefill(params, {"tokens": tokens}), reps=3)
    logits, cache = eng.prefill(params, {"tokens": tokens})
    check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
    step = {"cache": eng._pad_cache(cache, SERVE_P), "token": eng._sample(logits)[:, None],
            "pos": SERVE_P}
    del cache

    def decode_steps(n):
        for _ in range(n):
            lg, step["cache"] = eng.decode(params, step["cache"],
                                           {"token": step["token"], "pos": step["pos"]})
            step["token"] = eng._sample(lg)[:, None]
            step["pos"] += 1
        return lg

    n_steps = 16
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step_logits = decode_steps(n_steps)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / n_steps
    check(bool(torch.isfinite(step_logits.float()).all()), "non-finite decode logits")
    prof_decode = profile_run(lambda: decode_steps(8))
    del step, step_logits
    prof_prefill = profile_run(lambda: eng.prefill(params, {"tokens": tokens}))
    t0 = time.perf_counter()
    eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    t_gen_warm = time.perf_counter() - t0
    busy = {"prefill": prof_prefill["device_busy_ms"] / prefill_ms,
            "decode": prof_decode["device_busy_ms"] / (8 * decode_ms),
            "generate": (prof_prefill["device_busy_ms"] + (SERVE_NEW - 1)
                         * prof_decode["device_busy_ms"] / 8) / (t_gen_warm * 1e3)}
    log(f"  warm: prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms per step, generate "
        f"{t_gen_warm:.3f} s ({SERVE_B * SERVE_NEW / t_gen_warm:.1f} generated tokens/s); "
        f"device busy share " + ", ".join(f"{k} {v:.3f}" for k, v in busy.items()))

    # each kernel on one layer's real inputs at the path's shapes
    kept = capture_inputs(lambda: eng.prefill(params, {"tokens": tokens}))
    (q, k, v), kw = kept["flash_attention"]
    fa_kern = partial(fa.flash_attention, q, k, v, **kw)
    fa_plain = partial(fa.flash_attention_plain, q, k, v, **kw)
    fa_err = compare(f"flash_attention Zamba2 layer 0 q {tuple(q.shape)} {q.dtype}", "bf16",
                     synced(fa_kern()).float(), synced(fa_plain()).float(), q.shape[2] * q.shape[3])
    b_, h_, s_, d_ = q.shape
    t_ = k.shape[2]
    fa_flops = 4 * b_ * h_ * d_ * sum(min(t_, i + 1 + t_ - s_) for i in range(s_))
    fa_bytes = nbytes_of(q, k, v, q)
    # the CUDA-core kernel on f32 operands at the same shape (its earlier
    # time on this path, when it served bf16 too)
    qf, kf, vf = q.float(), k.float(), v.float()
    simt_ms = time_ms(partial(fa.flash_attention, qf, kf, vf, **kw), reps=3)
    del qf, kf, vf
    fa_row = {"ms": time_ms(fa_kern), "plain_ms": time_ms(fa_plain, reps=3),
              "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                  q, k, v, is_causal=True)),
              "bound_ms": max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_BF16_FLOPS) * 1e3,
              "bound_by": ("bytes" if fa_bytes / PEAK_BYTES_PER_S >= fa_flops / PEAK_BF16_FLOPS
                           else "operations"),
              # p @ v twice (p_hi, p_lo): 1.5x the minimum tensor-core work
              "bound_split_ms": max(fa_bytes / PEAK_BYTES_PER_S,
                                    1.5 * fa_flops / PEAK_BF16_FLOPS) * 1e3,
              "f32_core_bound_ms": fa_flops / PEAK_F32_FLOPS * 1e3,
              "simt_f32_ms": simt_ms,
              "flops": fa_flops, "bytes": fa_bytes, "max_abs_err": fa_err}
    log(f"    flash_attention: {json.dumps(fa_row)}")
    (x, acs, bm, cm), _ = kept["ssd_chunk"]
    del kept
    ssd_kern = partial(ssd_scan.ssd_chunk, x, acs, bm, cm)
    ssd_plain = partial(ssd_scan.ssd_chunk_plain, x, acs, bm, cm)
    bh_, c_, l_, p_ = x.shape
    n_ = bm.shape[-1]
    # kernel 7 on every call of a warm prefill, each on its layer's inputs
    per_layer, gated_logits = ssd_per_layer_gate(
        lambda: eng.prefill(params, {"tokens": tokens})[0], cfg.n_layers)
    log(f"  ssd_chunk on all {per_layer['calls']} calls of a warm prefill, fp32 rule "
        f"(y: {l_ * n_} terms, state: {l_}): worst at layer {per_layer['layer']} "
        f"{per_layer['output']}, max_abs_err {per_layer['max_abs_err']:.3e} <= "
        f"{per_layer['limit']:.3e} ({per_layer['over_limit']:.4f} of the limit); the gated "
        f"prefill's logits equal the kernels' prefill's: {torch.equal(gated_logits, logits)}")
    del gated_logits
    # the rule's controls on layer 0's inputs: the correctly rounded function
    # must pass it and one TF32 pass must fail it, or it cannot judge kernel 7
    want = synced(ssd_plain())
    controls = {}
    for name, ctrl, must_pass in (("f64", ssd_chunk_f64, True),
                                  ("one TF32 pass", ssd_chunk_tf32, False)):
        r = ssd_rule(synced(ctrl(x, acs, bm, cm)), want, l_, n_)
        controls[name] = {k: r[k]["over_limit"] for k in ("y", "state")}
        log(f"  ssd_chunk control on layer 0, {name}: y {r['y']['max_abs_err']:.3e} and state "
            f"{r['state']['max_abs_err']:.3e}, {controls[name]['y']:.4g} and "
            f"{controls[name]['state']:.4g} of their limits: "
            f"{'passes' if r['ok'] else 'fails'} the fp32 rule (must "
            f"{'pass' if must_pass else 'fail'})")
        check(r["ok"] == must_pass, f"the {name} control {'fails' if must_pass else 'passes'} "
              f"the fp32 rule on layer 0: the rule cannot judge kernel 7")
    y, st = synced(ssd_kern())
    ssd_err = max(compare(f"ssd_chunk Zamba2 layer 0 y {tuple(x.shape)}", "fp32", y, want[0],
                          l_ * n_),
                  compare(f"ssd_chunk Zamba2 layer 0 state {tuple(st.shape)}", "fp32", st,
                          want[1], l_))
    del y, st, want
    # the guard against gross faults: last-token logits against a prefill
    # with the plain versions on the card, within SERVE_LOGIT_MARGIN x the
    # f64 control's movement of them (see SERVE_LOGIT_MARGIN)
    got = logits.float()
    want = with_plain_kernels(lambda: eng.prefill(params, {"tokens": tokens})[0]).float()
    f64_moved = float((with_plain_kernels(lambda: eng.prefill(params, {"tokens": tokens})[0],
                                          ssd_chunk_f64).float() - want).abs().max())
    scale = float(want.abs().max())
    logit_err = float((got - want).abs().max())
    logit_limit = SERVE_LOGIT_MARGIN * f64_moved
    same_top = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  last-token logits, kernels against plain versions: max_abs_err {logit_err:.3e} "
        f"({logit_err / scale:.4f} of max|plain| {scale:.3e}) <= {logit_limit:.3e} "
        f"({SERVE_LOGIT_MARGIN} x the f64 control's {f64_moved:.3e}, {f64_moved / scale:.4f} "
        f"of max|plain|); argmax equal in {same_top:.2f} of rows")
    check(bool(torch.isfinite(got).all()) and logit_err <= logit_limit,
          "prefill logits with the kernels are further from the plain versions' than the "
          "guard allows")
    del logits, got, want
    # the least time: the bytes once, or C B^T (bf16 operands) at the bf16
    # rate and the 3xTF32 products as three TF32 products each; the f32
    # CUDA-core reckoning of the earlier kernel beside it
    tri = bh_ * c_ * l_ * (l_ + 1) // 2
    score_flops, y_flops, st_flops = tri * 2 * n_, tri * 2 * p_, bh_ * c_ * 2 * l_ * n_ * p_
    ssd_flops = score_flops + y_flops + st_flops
    ssd_bytes = nbytes_of(x, acs, bm, cm, x) + bh_ * c_ * n_ * p_ * 4
    t_bytes = ssd_bytes / PEAK_BYTES_PER_S
    t_ops = score_flops / PEAK_BF16_FLOPS + 3 * (y_flops + st_flops) / PEAK_TF32_FLOPS
    ssd_bound, ssd_bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                          else "operations")
    # the same call with B and C widened to f32 (all three products 3xTF32)
    bmf, cmf = bm.float(), cm.float()
    y32, st32 = synced(ssd_scan.ssd_chunk(x, acs, bmf, cmf))
    y_want, st_want = synced(ssd_scan.ssd_chunk_plain(x, acs, bmf, cmf))
    ssd_err = max(ssd_err, compare(f"ssd_chunk Zamba2 layer 0 y, B and C widened to f32",
                                   "fp32", y32, y_want, l_ * n_),
                  compare(f"ssd_chunk Zamba2 layer 0 state, B and C widened to f32", "fp32",
                          st32, st_want, l_))
    del y32, st32, y_want, st_want
    f32_bytes = nbytes_of(x, acs, bmf, cmf, x) + bh_ * c_ * n_ * p_ * 4
    ssd_row = {"ms": time_ms(ssd_kern), "plain_ms": time_ms(ssd_plain, reps=3),
               "bound_ms": ssd_bound, "bound_by": ssd_bound_by,
               "f32_core_bound_ms": bound(ssd_bytes, ssd_flops)[0],
               "b_c_dtype": str(bm.dtype), "per_layer": per_layer, "controls": controls,
               "f32_b_c_ms": time_ms(partial(ssd_scan.ssd_chunk, x, acs, bmf, cmf)),
               "f32_b_c_bound_ms": bound(f32_bytes, 3 * ssd_flops, PEAK_TF32_FLOPS)[0],
               "flops": ssd_flops, "bytes": ssd_bytes, "max_abs_err": ssd_err}
    del bmf, cmf
    log(f"    ssd_chunk: {json.dumps(ssd_row)}")

    kms = prof_prefill["kernel_ms"]
    summary = {
        "phase": "9 Zamba2-2.7B serving", "card": card, "config": cfg.name,
        "params": n_params, "batch": SERVE_B, "prompt": SERVE_P, "new_tokens": SERVE_NEW,
        "max_seq_len": SERVE_MAX,
        "setup_s": {"init_params_on_card": t_init, "cold_generate": t_gen},
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "generate_s": t_gen_warm, "generated_tokens_per_s": SERVE_B * SERVE_NEW / t_gen_warm,
        "decode_tokens_per_s": SERVE_B * 1e3 / decode_ms,
        "launches_per_generate": {k: v for k, v in launches.items() if v},
        "peak_memory_gb": peak_gb,
        "last_logit_max_abs_err_vs_plain": logit_err, "last_logit_scale": scale,
        "last_logit_limit": logit_limit, "last_logit_f64_control_moved": f64_moved,
        "flash_attention": fa_row, "ssd_chunk": ssd_row,
        "device_busy_share": busy, "profile_prefill": prof_prefill,
        "profile_8_decode_steps": prof_decode,
    }
    print(json.dumps(summary), flush=True)
    return {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "launches": launches["flash_attention"], "max_abs_err": fa_err, "ms": fa_row["ms"],
            "plain_ms": fa_row["plain_ms"], "device_ms": kms["flash_attention"] / n_sb,
            "bound_ms": fa_row["bound_ms"], "bound_by": fa_row["bound_by"],
            "bound_split_ms": fa_row["bound_split_ms"], "simt_f32_ms": fa_row["simt_f32_ms"],
            "library_ms": fa_row["library_ms"]},
        "ssd_chunk": {
            "name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:48",
            "launches": launches["ssd_chunk"], "max_abs_err": ssd_err, "ms": ssd_row["ms"],
            "plain_ms": ssd_row["plain_ms"], "device_ms": kms["ssd_chunk"] / cfg.n_layers,
            "bound_ms": ssd_row["bound_ms"], "bound_by": ssd_row["bound_by"],
            "f32_core_bound_ms": ssd_row["f32_core_bound_ms"],
            "b_c_dtype": ssd_row["b_c_dtype"], "f32_b_c_ms": ssd_row["f32_b_c_ms"],
            "f32_b_c_bound_ms": ssd_row["f32_b_c_bound_ms"],
            # no single PyTorch call builds the masked decay and both products
            "library_ms": None},
    }


# -- phase 12: the Tucker decomposition service ------------------------------------

# (name, shape, ranks, method, sweeps, requests, nnz range) of each tenant:
# the NELL-2 portion of Table V, Amazon's shape of Table V, and a 4-way
# tensor (kernels 3 and 4); uniform coordinates, values uniform in [0.1, 10)
SERVICE_TENANTS = (
    ("A", (1000, 1000, 1000), (16, 16, 16), "householder", 5, 64, (12_000, 36_000)),
    ("B", (20000, 20000, 20000), (32, 32, 32), "gram", 2, 32, (600, 1_200)),
    ("C", (200, 200, 200, 20), (8, 8, 8, 8), "gram", 3, 16, (20_000, 80_000)),
)
SERVICE_MAX_BATCH = 16
SERVICE_THREADS = 4


def projector_gap(u, v, rows: int = 2048) -> float:
    """max |U U^T - V V^T| over row blocks, never the whole (I, I) at once."""
    gap = 0.0
    for s in range(0, u.shape[0], rows):
        gap = max(gap, float((u[s:s + rows] @ u.T - v[s:s + rows] @ v.T).abs().max()))
    return gap


def core_gap(got, want):
    """(max |core difference|, max |want's core|) once ``got``'s factor
    columns are matched to ``want``'s by sign."""
    core = got.core
    for n, (a, b) in enumerate(zip(got.factors, want.factors)):
        sign = torch.sign((a * b).sum(0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.dim())])
    return float((core - want.core).abs().max()), float(want.core.abs().max())


def single_run_launches(order: int) -> dict:
    """Launches of one per-tensor sweep of an ``order``-way tensor: kernel 1
    a mode, or the chain kernel a mode above order 3; kernel 2 once."""
    if order <= 3:
        return {"fused_kron_scatter": order, "ttm": 1}
    return {"fused_kron_chain_scatter": order, "ttm": 1}


def stacked_kernel_checks(name, stacked, fs, k: int, shape) -> dict:
    """The unfolding kernels and kernel 2 at one flush's stacked shapes
    against their plain versions (fp32 rule), from the flush's final
    factors: kernel 1 on every mode over the stack (for the 4-way tenant the
    chain kernel, and kernels 3 and 4 as the unfused route runs them),
    kernel 2 on each member's row views of the last unfolding, as the
    batched sweeps call it. Times and bounds as phases 4, 6 and 10."""
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import operand_modes, slot_rows

    eng = make_engine("cuda", stacked.device)
    n = stacked.ndim
    out = {}
    if n <= 3:
        rows3 = table5_kernels(f"{name} stacked", stacked, eng, fs)
        out["fused_kron_scatter"] = rows3["fused_kron_scatter"]
        out["ttm_whole_stack"] = rows3["ttm"]
        y_last = kron_kernel.fused_kron_scatter(*kron_factors(fs, n - 1),
                                                eng.device_schedule(stacked, n - 1),
                                                stacked.shape[n - 1])
    else:
        tot = {nm: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                    "max_abs_err": 0.0, "bytes": 0, "flops": 0}
               for nm in ("fused_kron_chain_scatter", "kron_contrib", "scatter_rows")}
        for mode in range(n):
            sched = eng.device_schedule(stacked, mode)
            n_rows = stacked.shape[mode]
            rows, v = ops._gathered_block_rows(stacked.indices, stacked.values, fs, mode,
                                               sched, n)
            ones = torch.ones_like(v)
            c1 = synced(kron_kernel.kron_contrib(rows[0], rows[1], v))
            e1 = compare(f"kron_contrib {name} stacked mode {mode} link 1", "fp32", c1,
                         synced(kron_kernel.kron_contrib_plain(rows[0], rows[1], v)), 1)
            c2 = synced(kron_kernel.kron_contrib(c1, rows[2], ones))
            e2 = compare(f"kron_contrib {name} stacked mode {mode} link 2", "fp32", c2,
                         synced(kron_kernel.kron_contrib_plain(c1, rows[2], ones)), 1)
            y = synced(kron_kernel.scatter_rows(c2, sched, n_rows))
            terms = max_row_count(stacked, mode)
            es = compare(f"scatter_rows {name} stacked mode {mode}", "fp32", y,
                         synced(kron_kernel.scatter_rows_plain(c2, sched, n_rows)), terms)
            compare(f"Y_({mode}) {name} stacked, kernels against the plain chain", "fp32", y,
                    synced(chain_plain(rows, v, sched, n_rows, "fp32")), terms)
            opf = [fs[t] for t in operand_modes(n, mode)]
            fused = partial(kron_kernel.fused_kron_chain_scatter, opf, sched, n_rows)
            fused_plain = partial(kron_kernel.fused_kron_chain_scatter_plain, opf, sched, n_rows)
            yf = synced(fused())
            ef = compare(f"fused_kron_chain_scatter {name} stacked mode {mode}", "fp32", yf,
                         synced(fused_plain()), terms)
            compare(f"fused_kron_chain_scatter {name} stacked mode {mode} against kernels 3 "
                    f"and 4", "fp32", yf, y, terms)
            f_bytes, f_flops = chain_scatter_work(sched, opf, n_rows, int(stacked.nnz))
            kk = c2.shape[1]
            slots = slot_rows(sched)
            # one PyTorch call each for the same functions (as phase 6):
            # torch.einsum for both links, index_add_ for the scatter
            c_lib = (time_ms(lambda: torch.einsum("ti,tj->tij", rows[0] * v[:, None], rows[1]))
                     + time_ms(lambda: torch.einsum("ti,tj->tij", c1 * ones[:, None], rows[2])))
            s_lib = time_ms(lambda: torch.zeros((n_rows, kk), device=c2.device)
                            .index_add_(0, slots, c2))
            for nm, ms, pl, lib, nb, fl, err, peak in (
                    ("fused_kron_chain_scatter", time_ms(fused), time_ms(fused_plain),
                     c_lib + s_lib, f_bytes, f_flops, ef, PEAK_TF32_FLOPS),
                    ("kron_contrib",
                     time_ms(partial(kron_kernel.kron_contrib, rows[0], rows[1], v))
                     + time_ms(partial(kron_kernel.kron_contrib, c1, rows[2], ones)),
                     time_ms(partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v))
                     + time_ms(partial(kron_kernel.kron_contrib_plain, c1, rows[2], ones)),
                     c_lib,
                     nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + c2.numel() * 4,
                     kron_contrib_flops(v.shape[0], rows[0].shape[1], rows[1].shape[1])
                     + kron_contrib_flops(v.shape[0], c1.shape[1], rows[2].shape[1],
                                          scaled=False), max(e1, e2), PEAK_F32_FLOPS),
                    ("scatter_rows", time_ms(partial(kron_kernel.scatter_rows, c2, sched, n_rows)),
                     time_ms(partial(kron_kernel.scatter_rows_plain, c2, sched, n_rows)),
                     s_lib,
                     nbytes_of(c2, sched.rel_row, sched.blkmap, sched.parts) + n_rows * kk * 4,
                     int(stacked.nnz) * kk, es, PEAK_F32_FLOPS)):
                t = tot[nm]
                t["ms"] += ms
                t["plain_ms"] += pl
                t["library_ms"] += lib
                t["bound_ms"] += bound(nb, fl, peak)[0]
                t["peak"] = peak
                t["bytes"] += nb
                t["flops"] += fl
                t["max_abs_err"] = max(t["max_abs_err"], err)
            if mode == n - 1:
                y_last = yf
            del c1, c2, rows, v, ones, y
        for nm, t in tot.items():
            t["bound_by"] = bound(t["bytes"], t["flops"], t.pop("peak"))[1]
            out[nm] = t
    # kernel 2 as the batched sweeps call it: on member i's rows of Y_(N)
    # and U_N, transposed views (no copy)
    rows_n = shape[n - 1]
    err = 0.0
    for i in range(k):
        yv, uv = y_last[i * rows_n:(i + 1) * rows_n].T, fs[n - 1][i * rows_n:(i + 1) * rows_n].T
        err = max(err, compare(f"ttm {name} member {i} view y {tuple(yv.shape)} u "
                               f"{tuple(uv.shape)}", "fp32", check_ttm_call(name, yv, uv, "fp32"),
                               synced(ttm_kernel.ttm_plain(yv, uv)), rows_n))
    yv, uv = y_last[:rows_n].T, fs[n - 1][:rows_n].T
    l_, i_ = yv.shape
    nb, fl = (l_ * i_ + uv.shape[0] * i_) * 4 + l_ * uv.shape[0] * 4, 2 * l_ * i_ * uv.shape[0]
    out["ttm"] = {"ms": time_ms(partial(ttm_kernel.ttm, yv, uv), reps=20, flush_l2=True),
                  "plain_ms": time_ms(partial(ttm_kernel.ttm_plain, yv, uv), reps=20,
                                      flush_l2=True),
                  "library_ms": time_ms(partial(torch.matmul, yv, uv.T), reps=20, flush_l2=True),
                  "bound_ms": bound(nb, fl)[0], "bound_by": bound(nb, fl)[1],
                  "max_abs_err": err, "shape": [l_, i_, uv.shape[0]], "calls_per_sweep": k}
    return out


def phase12_service(dev, card: str) -> None:
    import threading

    import repro_torch.obs as obs
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.serve import ServiceConfig, TuckerService
    from repro_torch.sparse.layout import stack_coo_batch

    tf32_off()
    release_memory()
    log(f"phase 12: TuckerService(max_batch {SERVICE_MAX_BATCH}, max_wait_ms 5, 2 executors), "
        f"{SERVICE_THREADS} submitting threads, tenants "
        + "; ".join(f"{t[0]} {t[5]} x {t[1]} ranks {t[2]} {t[3]} {t[4]} sweeps nnz {t[6]}"
                    for t in SERVICE_TENANTS))
    specs = [tucker.TuckerSpec(shape, ranks, method=method, n_iter=sweeps)
             for _, shape, ranks, method, sweeps, _, _ in SERVICE_TENANTS]
    t0 = time.perf_counter()
    reqs = []  # (tenant, coo, generator seed), tenant by tenant
    for t, (_, shape, _, _, _, n_req, (lo, hi)) in enumerate(SERVICE_TENANTS):
        rng = np.random.default_rng(1200 + t)
        for i in range(n_req):
            seed = 12_000 + 1000 * t + i
            idx, vals = synthetic(dev, shape, int(rng.integers(lo, hi + 1)), seed, "uniform")
            reqs.append((t, SparseCOO.from_parts(idx, vals, shape), seed))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # the sequential loop: each request served alone, per-tensor, one after
    # another (each call ends in its history's read); the reference results
    seq, seq_s = [], [0.0] * len(SERVICE_TENANTS)
    for t, coo, seed in reqs:
        plan = tucker.plan(specs[t], device=dev)
        t0 = time.perf_counter()
        seq.append(plan(coo, generator=gen(seed)))
        seq_s[t] += time.perf_counter() - t0
    for (t, coo, _), res in zip(reqs, seq):
        want = sum(single_run_launches(coo.ndim).values()) * specs[t].n_iter
        check(res.launches == want and res.n_sweeps == specs[t].n_iter,
              f"tenant {SERVICE_TENANTS[t][0]} per-tensor run: {res.launches} launches, "
              f"{res.n_sweeps} sweeps; want {want}, {specs[t].n_iter}")

    # the service: every count starts at 0 here and is read right after
    groups = []  # runs of 16 requests of one tenant, handed to the threads in turn
    for t in range(len(SERVICE_TENANTS)):
        mine = [i for i, r in enumerate(reqs) if r[0] == t]
        groups += [mine[s:s + SERVICE_MAX_BATCH] for s in range(0, len(mine), SERVICE_MAX_BATCH)]
    per_thread = [[i for g in groups[th::SERVICE_THREADS] for i in g]
                  for th in range(SERVICE_THREADS)]
    tickets, sub_t, errors = [None] * len(reqs), [0.0] * len(reqs), []
    obs.tracer.clear()
    obs.configure(enabled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    svc = TuckerService(ServiceConfig(max_batch=SERVICE_MAX_BATCH, max_wait_ms=5.0,
                                      max_inflight_flushes=2))
    barrier = threading.Barrier(SERVICE_THREADS + 1)

    def submitter(th):
        barrier.wait(60)
        try:
            for i in per_thread[th]:
                t, coo, seed = reqs[i]
                sub_t[i] = time.perf_counter()
                tickets[i] = svc.submit_coo(coo, specs[t], generator=gen(seed))
        except Exception as exc:  # reported below: the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(th,)) for th in range(SERVICE_THREADS)]
    for th in threads:
        th.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(600)
    try:
        check(not errors and not any(th.is_alive() for th in threads),
              f"submitting threads failed: {errors}")
        failed = [(i, tk.exception(timeout=600)) for i, tk in enumerate(tickets)]
        failed = [(i, e) for i, e in failed if e is not None]
        check(not failed, f"{len(failed)} tickets failed, the first: {failed[:1]}")
        results = [tk.result() for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        svc.close()
        obs.configure(enabled=False)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    spans = [e for e in obs.tracer.events()
             if e.name == "sweep.dispatch" and e.attrs.get("program") == "batched"]
    snap = svc.metrics.snapshot()
    log(f"  service: {len(reqs)} requests in {wall:.3f} s, launches {launches}, "
        f"{len(spans)} batched dispatch spans, metrics dispatches {snap['dispatches']}")

    # every kernel of the path ran, and the flushes' own counts add up to them
    path_kernels = ("fused_kron_scatter", "fused_kron_chain_scatter", "ttm")
    for name in path_kernels:
        check(launches[name] > 0, f"phase 12 launched {name} no time")
    off_path = ("fused_kron_scatter_ttm", "kron_contrib", "scatter_rows", *NO_LM_LAUNCHES)
    check(not any(launches[k] for k in off_path),
          f"phase 12 launched kernels off its path: {launches}")
    from_spans = {name: sum(e.attrs["launches"].get(name, 0) for e in spans)
                  for name in path_kernels}
    check(from_spans == {k: launches[k] for k in path_kernels},
          f"the flushes' launches {from_spans} do not add up to the run's {launches}")

    tenants = []
    for t, (name, shape, ranks, method, sweeps, n_req, _) in enumerate(SERVICE_TENANTS):
        ids = [i for i, r in enumerate(reqs) if r[0] == t]
        res_t = [results[i] for i in ids]
        dispatches = sum(r.dispatches for r in res_t)
        t_spans = [e for e in spans if tuple(e.attrs["shape"]) == tuple(shape)]
        check(dispatches <= -(-n_req // SERVICE_MAX_BATCH),
              f"tenant {name}: {dispatches} dispatches for {n_req} requests")
        check(len(t_spans) >= dispatches >= 1,
              f"tenant {name}: {len(t_spans)} dispatch spans for {dispatches} flushes")
        per_flush = []
        for e in t_spans:
            k, s_run = e.attrs["batch"], e.attrs["sweeps_run"]
            want = {kk: v * s_run for kk, v in single_run_launches(len(shape)).items()}
            want["ttm"] = k * s_run
            check(e.attrs["launches"] == want,
                  f"tenant {name} flush of {k}: launches {e.attrs['launches']}, want {want}")
            per_flush.append({"batch": k, "sweeps": s_run, "launches": e.attrs["launches"],
                              "ms": e.duration_ms})
        fit_gap = proj = core = core_scale = 0.0
        for i in ids:
            got, want = results[i], seq[i]
            check(got.n_sweeps == want.n_sweeps == sweeps,
                  f"tenant {name} request {i}: {got.n_sweeps} sweeps, alone {want.n_sweeps}")
            check(bool(np.all(np.isfinite(got.fit_history))), f"request {i}: {got.fit_history}")
            fit_gap = max(fit_gap, float(np.abs(got.fit_history - want.fit_history).max()))
            proj = max(proj, max(projector_gap(a, b) for a, b in zip(got.factors, want.factors)))
            gap, scale = core_gap(got, want)
            check(gap <= 1e-3 * scale, f"tenant {name} request {i}: core gap {gap} > 1e-3 x "
                                       f"{scale}")
            core, core_scale = max(core, gap / scale), max(core_scale, scale)
        check(fit_gap <= 1e-4, f"tenant {name}: fit history gap {fit_gap} > 1e-4")
        check(proj <= 1e-3, f"tenant {name}: projector gap {proj} > 1e-3")
        lat = np.asarray([r.timing.total_ms for r in res_t])
        span_s = max(sub_t[i] + results[i].timing.total_ms / 1e3 for i in ids) - min(
            sub_t[i] for i in ids)
        row = {"tenant": name, "shape": shape, "ranks": specs[t].ranks, "method": method,
               "sweeps": sweeps, "requests": n_req,
               "nnz": [min(reqs[i][1].nnz for i in ids), max(reqs[i][1].nnz for i in ids)],
               "dispatches": dispatches, "flushes": per_flush,
               "requests_per_s": n_req / span_s, "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "sequential_requests_per_s": n_req / seq_s[t],
               "sequential_ms_per_request": seq_s[t] * 1e3 / n_req,
               "ratio_to_sequential": (n_req / span_s) / (n_req / seq_s[t]),
               "fit_gap": fit_gap, "projector_gap": proj, "core_gap_over_scale": core}
        log(f"  tenant {name}: {json.dumps(row)}")
        tenants.append(row)

    # one flush of each tenant alone: its wall time beside one request served
    # alone, the device's busy share (tenant A), and kernels 1-4 at the
    # flush's stacked shapes, from the flush's final factors
    flush_ms, flush_stages, kernels = {}, {}, {}
    for t, (name, shape, *_rest) in enumerate(SERVICE_TENANTS):
        ids = [i for i, r in enumerate(reqs) if r[0] == t][:SERVICE_MAX_BATCH]
        plan = tucker.plan(specs[t], device=dev)
        members = [reqs[i][1] for i in ids]
        flush_ms[name] = []
        obs.configure(enabled=True)  # the stages: factor draws and stacking, sweeps
        try:
            for _ in range(2):  # the first allocates the flush's memory anew
                t0 = time.perf_counter()
                batch = plan.batch(members, generators=[gen(reqs[i][2]) for i in ids])
                flush_ms[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            obs.configure(enabled=False)
        flush_stages[name] = batch[0].trace_summary
        if t == 0:
            prof = profile_run(lambda: plan.batch(members,
                                                  generators=[gen(reqs[i][2]) for i in ids]))
        stacked, _ = stack_coo_batch(members)
        fs = [torch.cat([r.factors[m] for r in batch]).contiguous() for m in range(len(shape))]
        kernels[name] = stacked_kernel_checks(name, stacked, fs, len(members), shape)
        del stacked, fs, batch
        release_memory()
    summary = {
        "phase": "12 Tucker service", "card": card,
        "config": {"max_batch": SERVICE_MAX_BATCH, "max_wait_ms": 5.0, "max_inflight_flushes": 2,
                   "submitting_threads": SERVICE_THREADS},
        "generate_s": t_gen, "wall_s": wall, "requests": len(reqs),
        "requests_per_s": len(reqs) / wall, "sequential_s": sum(seq_s),
        "sequential_requests_per_s": len(reqs) / sum(seq_s),
        "ratio_to_sequential": sum(seq_s) / wall,
        "peak_above_resident_gb": (peak - resident) / 1e9, "resident_gb": resident / 1e9,
        "launches": {k: v for k, v in launches.items() if v},
        "metrics": {k: snap[k] for k in ("dispatches", "flushes", "requests_per_dispatch",
                                         "batch_size_mean", "completed", "failed")},
        "tenants": tenants,
        "flush_alone_ms": flush_ms, "flush_alone_stages_ms": flush_stages,
        # a warm flush of 16 alone against its 16 requests served alone
        "flush_alone_amortization": {
            row["tenant"]: SERVICE_MAX_BATCH * row["sequential_ms_per_request"]
            / flush_ms[row["tenant"]][-1] for row in tenants},
        "flush_a_profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share",
                                                 "device_kernels", "kernel_ms")},
        "kernels_at_stacked_shapes": kernels,
    }
    print(json.dumps(summary), flush=True)
    del reqs, seq, results
    release_memory()

# -- phase 13: autotuning and snapshot/resume ------------------------------------------

AUTOTUNE_MAX_TRIALS = 4  # autotune()'s default: the default config and three more
SNAP_EVERY = 2  # sweeps per segment: 5 sweeps write steps 0, 2, 4 and 5
SNAP_KILL_AT = 4  # the injected kill, at a segment boundary
SNAP_RETRY_AT = 2  # the injected transient failure, retried in place
OVERHEAD_TURNS = 7  # turns of (no snapshot, every sweep, every 5 sweeps)
TENANT_C = ((200, 200, 200, 20), 80_000, (8, 8, 8, 8), "gram")  # phase 12's 4-way tenant


def same_bits(res, fit, factors, core) -> bool:
    """``res``'s fit history, factors and core are exactly the given ones
    (host copies)."""
    return (np.array_equal(res.fit_history, fit) and torch.equal(res.core.cpu(), core)
            and all(torch.equal(a.cpu(), b) for a, b in zip(res.factors, factors)))


def host_copy(res):
    return res.fit_history.copy(), [f.cpu() for f in res.factors], res.core.cpu()


def coo_checksum(coo) -> tuple:
    """Sums of a tensor's coordinates and values (int64 and f64): phase 13
    draws phase 4's tensor anew and checks it is the same one."""
    return (int(coo.indices.long().sum()), float(coo.values.double().sum()))


def within_phase3_tolerances(label: str, got, fit, factors, core) -> dict:
    """``got`` against a run held on the host: fit 1e-4, projectors 1e-3,
    core 1e-3 x max|core| with factor signs matched (phase 3's rule)."""
    fit_gap = float(np.abs(got.fit_history - fit).max())
    proj = max(projector_gap(a, b.to(a.device)) for a, b in zip(got.factors, factors))
    c = got.core.cpu()
    for n, (a, b) in enumerate(zip(got.factors, factors)):
        sign = torch.sign((a.cpu() * b).sum(0))
        c = c * sign.reshape([-1 if t == n else 1 for t in range(c.dim())])
    scale = float(core.abs().max())
    core_gap = float((c - core).abs().max())
    log(f"  {label}: fit {fit_gap:.3e} <= 1e-4, projectors {proj:.3e} <= 1e-3, core "
        f"{core_gap:.3e} <= {1e-3 * scale:.3e}")
    check(got.fit_history.shape == fit.shape and fit_gap <= 1e-4 and proj <= 1e-3
          and core_gap <= 1e-3 * scale, f"{label}: outside phase 3's tolerances")
    return {"fit_gap": fit_gap, "projector_gap": proj, "core_gap_over_scale": core_gap / scale}


def snapshot_bytes(directory: str) -> int:
    """Bytes of the newest snapshot in ``directory`` (its npz and manifest)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    step = CheckpointManager(directory).latest_step()
    d = Path(directory) / f"step_{step:08d}"
    return sum(f.stat().st_size for f in d.iterdir())


def phase13_autotune_snapshots(dev, card: str, ref4: dict) -> None:
    """Autotuning and snapshot/resume on phase 4's tensor (drawn anew from
    its seed; ``ref4`` holds phase 4's fit history, factors, core and the
    tensor's checksum), then the 4-way kill and resume at tenant C's
    shape. The tuning table and the snapshots go to a temporary directory
    that is removed at the end."""
    import shutil
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.kernels import autotune as at

    tf32_off()
    release_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    saved_env = os.environ.get(at.TABLE_ENV)
    os.environ[at.TABLE_ENV] = os.path.join(tmp, "autotune.json")
    try:
        _phase13(dev, card, ref4, tmp)
    finally:
        obs.configure(enabled=False)
        if saved_env is None:
            os.environ.pop(at.TABLE_ENV, None)
        else:
            os.environ[at.TABLE_ENV] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)
        release_memory()


def _phase13(dev, card: str, ref4: dict, tmp: str) -> None:
    import repro_torch.obs as obs
    from repro_torch import tucker
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import kron_kernel
    from repro_torch.runtime.fault_tolerance import FailureInjector

    log(f"phase 13: autotuning and snapshot/resume at NELL-2 size {NELL2_SHAPE}, "
        f"{NELL2_NNZ} nnz, ranks {NELL2_RANKS}, {N_ITER} sweeps; 4-way kill and resume at "
        f"{TENANT_C[0]}")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NELL2_SHAPE, NELL2_NNZ, SEED, "uniform")
    coo = SparseCOO.from_parts(idx, vals, NELL2_SHAPE)
    del idx, vals
    check(coo_checksum(coo) == ref4["checksum"], "phase 13's NELL-2 tensor is not phase 4's")
    fit4, factors4, core4 = ref4["fit"], ref4["factors"], ref4["core"]
    log(f"  phase 4's tensor drawn anew in {time.perf_counter() - t0:.2f} s (checksum equal)")
    out = {"phase": "13 autotuning and snapshot/resume", "card": card}

    # 13a: the cold autotuned plan: every count starts at 0 here
    spec_t = tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER, autotune=True)
    obs.tracer.clear()
    obs.configure(enabled=True)
    at.reset_counters()
    reset_launches()
    t0 = time.perf_counter()
    tuned = tucker.plan(spec_t, device=dev)(coo)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    counters = dict(at.COUNTERS)
    events = obs.tracer.events()
    obs.configure(enabled=False)
    search = [e for e in events if e.name == "autotune.search"]
    trials = [e for e in events if e.name == "autotune.trial"]
    check(len(search) == 1, f"{len(search)} autotune.search spans")
    n_cands = search[0].attrs["candidates"]
    pick = tuned.tuned_blocks
    rows = [{"config": at.BlockConfig(e.attrs["bn"], e.attrs["bi"], e.attrs["slots_per_part"],
                                      e.attrs["layout"])._asdict(),
             "ms": e.attrs.get("best_ms"), "error": e.attrs.get("error"), "nnz": e.attrs["nnz"]}
            for e in trials]
    for r in rows:
        log(f"  trial {r['config']}: {r['ms']} ms on {r['nnz']} nonzeros"
            + (f", raised {r['error']}" if r["error"] else ""))
    log(f"  cold autotuned run: {t_cold:.2f} s, counters {counters}, {n_cands} candidates, "
        f"pick {pick}, launches {launches}")
    check(counters["searches"] == 1 and counters["table_hits"] == 0
          and counters["trials"] == min(AUTOTUNE_MAX_TRIALS, n_cands) == len(trials),
          f"cold search: counters {counters}, {len(trials)} trial spans, {n_cands} candidates")
    check(any(r["config"] == at.DEFAULT_CONFIG._asdict() for r in rows),
          "the default config was not among the trials")
    check(not any(r["error"] for r in rows), f"a trial raised: {rows}")
    check(pick is not None and pick._asdict() in [r["config"] for r in rows],
          f"the pick {pick} is not a trial's config")
    check(launches["fused_kron_scatter"] > 0 and launches["ttm"] + launches[
        "fused_kron_scatter_ttm"] > 0, f"the tuned run launched {launches}")
    if pick == at.DEFAULT_CONFIG:
        check(same_bits(tuned, fit4, factors4, core4),
              "the default pick differs from phase 4's bits")
        out["tuned_vs_phase4"] = "same bits"
    else:
        out["tuned_vs_phase4"] = within_phase3_tolerances("tuned against phase 4", tuned, fit4,
                                                          factors4, core4)
    tuned_bits = host_copy(tuned)
    # kernel 1 (and kernel 5 for a fused pick) on the tuned schedules,
    # against their plain versions
    eng = tucker.plan(spec_t, device=dev).engine
    fs = [f.contiguous() for f in tuned.factors]
    for mode in range(3):
        sched = eng.device_schedule(coo, mode)
        fa, fb = kron_factors(fs, mode)
        compare(f"fused_kron_scatter NELL-2 mode {mode}, tuned schedule (bn {sched.bn}, bi "
                f"{sched.bi}, {int(sched.parts.numel()) - 1} ranges)", "fp32",
                synced(kron_kernel.fused_kron_scatter(fa, fb, sched, NELL2_SHAPE[mode])),
                synced(kron_kernel.fused_kron_scatter_plain(fa, fb, sched, NELL2_SHAPE[mode])),
                max_row_count(coo, mode))
        if mode == 2 and pick.layout == "fused":
            compare("fused_kron_scatter_ttm NELL-2, tuned schedule", "fp32",
                    synced(kron_kernel.fused_kron_scatter_ttm(fa, fb, fs[2], sched,
                                                              NELL2_SHAPE[2])),
                    synced(kron_kernel.fused_kron_scatter_ttm_plain(fa, fb, fs[2], sched,
                                                                    NELL2_SHAPE[2])),
                    NELL2_NNZ)

    # the warm plan: the table answers, no search
    tucker.clear_plan_cache()
    at.reset_counters()
    reset_launches()
    warm = tucker.plan(spec_t, device=dev)(coo)
    counters_warm = dict(at.COUNTERS)
    log(f"  warm autotuned plan: counters {counters_warm}, pick {warm.tuned_blocks}")
    check(counters_warm == {"searches": 0, "trials": 0, "table_hits": 1},
          f"warm plan: counters {counters_warm}")
    check(warm.tuned_blocks == pick and same_bits(warm, *tuned_bits),
          "the warm plan differs from the cold one")

    # one forced fused trial: it runs kernel 5 (and no kernel 2)
    reset_launches()
    fused_ms = at.trial_time_ms(at.BlockConfig(layout="fused"), NELL2_SHAPE, NELL2_RANKS,
                                NELL2_NNZ, device=dev)
    fused_launches = read_launches()
    log(f"  forced fused trial: {fused_ms:.3f} ms, launches {fused_launches}")
    check(fused_launches["fused_kron_scatter_ttm"] > 0 and fused_launches["ttm"] == 0,
          f"the fused trial launched {fused_launches}")

    # warm sweep ms, tuned against the split path of phase 4, in turns
    plan_t = tucker.plan(spec_t, device=dev)
    plan_d = tucker.plan(tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER), device=dev)
    first_d = plan_d(coo)
    check(same_bits(first_d, fit4, factors4, core4), "the split path differs from phase 4's")
    runs_t, runs_d = [], []
    for _ in range(WARM_RUNS):
        runs_d += [ms / N_ITER for ms in warm_ms(lambda: plan_d(coo), runs=1)]
        runs_t += [ms / N_ITER for ms in warm_ms(lambda: plan_t(coo), runs=1)]
    tuned_ms, default_ms = float(np.median(runs_t)), float(np.median(runs_d))
    log(f"  warm ms per sweep: tuned {tuned_ms:.2f} (" + ", ".join(f"{m:.2f}" for m in runs_t)
        + f"), phase 4's split path {default_ms:.2f} ("
        + ", ".join(f"{m:.2f}" for m in runs_d) + ")")
    out["autotune"] = {"candidates": n_cands, "trials": rows, "pick": pick._asdict(),
                       "cold_run_s": t_cold, "counters_cold": counters,
                       "counters_warm": counters_warm, "forced_fused_trial_ms": fused_ms,
                       "forced_fused_trial_launches": {k: v for k, v in fused_launches.items()
                                                       if v},
                       "tuned_sweep_ms": tuned_ms, "tuned_sweep_ms_runs": runs_t,
                       "split_sweep_ms": default_ms, "split_sweep_ms_runs": runs_d}
    del plan_t, warm, tuned, first_d, eng, fs
    tucker.clear_plan_cache()

    # 13b: snapshots from phase 4's initial factors (the plan's default draw)
    def snap_spec(name, every=SNAP_EVERY, **kw):
        return tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER,
                                 snapshot=tucker.SnapshotSpec(every_n_sweeps=every,
                                                              directory=os.path.join(tmp, name),
                                                              **kw))

    spec_a = snap_spec("uninterrupted")
    obs.tracer.clear()
    obs.configure(enabled=True)
    reset_launches()
    res_a = tucker.plan(spec_a, device=dev)(coo)
    torch.cuda.synchronize()
    launches_a = read_launches()
    segs = [e for e in obs.tracer.events()
            if e.name == "sweep.dispatch" and e.attrs.get("program") == "segment"]
    obs.configure(enabled=False)
    steps = CheckpointManager(spec_a.snapshot.directory).all_steps()
    seg_builds = [e.attrs["schedule_builds"] for e in segs]
    log(f"  uninterrupted snapshot run: {res_a.dispatches} segments, "
        f"{res_a.snapshots_written} snapshots, steps kept {steps}, builds by segment "
        f"{seg_builds}, launches {launches_a}")
    check(same_bits(res_a, fit4, factors4, core4), "the snapshot run differs from phase 4's")
    check(res_a.snapshots_written == 4 and steps == [2, 4, 5] and res_a.dispatches == 3,
          f"snapshot run: {res_a.snapshots_written} written, steps {steps}")
    check(seg_builds == [3, 0, 0], f"schedule builds by segment {seg_builds}")
    want = {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER, "kron_contrib": 0,
            "scatter_rows": 0, "fused_kron_scatter_ttm": 0, "fused_kron_chain_scatter": 0,
            **NO_LM_LAUNCHES}
    check(launches_a == want, f"snapshot run launches {launches_a}, want {want}")

    spec_k = snap_spec("killed")
    reset_launches()
    try:
        tucker.plan(spec_k, device=dev)(coo, injector=FailureInjector([SNAP_KILL_AT]))
        killed = False
    except RuntimeError as exc:
        killed = "injected failure" in str(exc)
    check(killed, "the injected kill did not raise")
    resumed = tucker.resume(spec_k, coo, device=dev)
    torch.cuda.synchronize()
    launches_k = read_launches()
    log(f"  killed at sweep {SNAP_KILL_AT}, resumed from {resumed.resumed_from_sweep}: "
        f"{resumed.dispatches} segment, {resumed.schedule_builds} builds, launches over both "
        f"{launches_k}")
    check(resumed.resumed_from_sweep == SNAP_KILL_AT and resumed.schedule_builds == 0,
          f"resume: from {resumed.resumed_from_sweep}, {resumed.schedule_builds} builds")
    check(same_bits(resumed, fit4, factors4, core4), "the resumed run differs from phase 4's")
    check(launches_k == want, f"kill and resume launched {launches_k}, want {want}")

    # the runs below share the split plan's engine (its schedules of coo)
    spec_r = snap_spec("retried", max_retries=1, retry_backoff_s=0.0)
    retried = tucker.plan(spec_r, device=dev, engine=plan_d.engine)(
        coo, injector=FailureInjector([SNAP_RETRY_AT]))
    log(f"  retried at sweep {SNAP_RETRY_AT}: retries {retried.retries}")
    check(retried.retries == 1 and same_bits(retried, fit4, factors4, core4),
          f"the retried run: {retried.retries} retries, or other bits")

    # the overhead: warm ms per sweep at 1 and 5 sweeps a segment against no
    # snapshot, in turns, each timed call writing its snapshots; and each
    # write's own time, from its snapshot.spill span (the sweep time of this
    # host-bound path moves by more than a write costs from run to run)
    spec_1, spec_5 = snap_spec("every1", every=1), snap_spec("every5", every=5)
    plans = {"none": plan_d, "every_1": tucker.plan(spec_1, device=dev, engine=plan_d.engine),
             "every_5": tucker.plan(spec_5, device=dev, engine=plan_d.engine)}
    for p in plans.values():
        p(coo)  # warm: schedules built
    runs = {k: [] for k in plans}
    obs.tracer.clear()
    obs.configure(enabled=True)
    gc.collect()
    for _ in range(OVERHEAD_TURNS):
        for k, p in plans.items():
            runs[k] += [ms / N_ITER for ms in warm_ms(lambda p=p: p(coo), runs=1)]
    spills = [e.duration_ms for e in obs.tracer.events() if e.name == "snapshot.spill"]
    obs.configure(enabled=False)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    spill_ms = float(np.median(spills))
    per_run = {"every_1": N_ITER + 1, "every_5": 2}  # the step-0 snapshot and each boundary
    check(len(spills) == OVERHEAD_TURNS * sum(per_run.values()),
          f"{len(spills)} snapshot.spill spans in the overhead runs")
    spill = snapshot_bytes(spec_1.snapshot.directory)
    log(f"  overhead, ms per sweep (medians of {OVERHEAD_TURNS} turns): none {med['none']:.2f}, "
        f"every 1 {med['every_1']:.2f} ({med['every_1'] - med['none']:+.2f}), every 5 "
        f"{med['every_5']:.2f} ({med['every_5'] - med['none']:+.2f}); a write {spill_ms:.2f} ms "
        f"(median of {len(spills)}), so +{per_run['every_1'] * spill_ms / N_ITER:.2f} and "
        f"+{per_run['every_5'] * spill_ms / N_ITER:.2f} ms a sweep; {spill} bytes a snapshot")
    out["snapshots"] = {"every_n_sweeps": SNAP_EVERY, "written": res_a.snapshots_written,
                        "steps_kept": steps, "builds_by_segment": seg_builds,
                        "launches": {k: v for k, v in launches_a.items() if v},
                        "kill_at": SNAP_KILL_AT, "resumed_from": resumed.resumed_from_sweep,
                        "retries": retried.retries, "sweep_ms": med, "sweep_ms_runs": runs,
                        "spill_ms_median": spill_ms, "spills_timed": len(spills),
                        "spill_ms_range": [min(spills), max(spills)],
                        "spill_ms_per_sweep": {k: n * spill_ms / N_ITER
                                               for k, n in per_run.items()},
                        "bytes_per_snapshot": spill}
    del plans, plan_d, res_a, resumed, retried
    del coo
    release_memory()

    # 13c: the 4-way path (the chain kernel and kernel 2) under segments
    shape_c, nnz_c, ranks_c, method_c = TENANT_C
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    coo_c = SparseCOO.from_parts(idx, vals, shape_c)
    reset_launches()
    base_c = tucker.plan(tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER),
                         device=dev)(coo_c)
    torch.cuda.synchronize()
    want_c = read_launches()
    spec_c = tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER,
                               snapshot=tucker.SnapshotSpec(
                                   every_n_sweeps=SNAP_EVERY,
                                   directory=os.path.join(tmp, "four_way")))
    reset_launches()
    try:
        tucker.plan(spec_c, device=dev)(coo_c, injector=FailureInjector([SNAP_KILL_AT]))
        killed = False
    except RuntimeError as exc:
        killed = "injected failure" in str(exc)
    resumed_c = tucker.resume(spec_c, coo_c, device=dev)
    torch.cuda.synchronize()
    launches_c = read_launches()
    log(f"  4-way: killed {killed}, resumed from {resumed_c.resumed_from_sweep}, launches over "
        f"both {launches_c} (uninterrupted {want_c})")
    check(killed and resumed_c.resumed_from_sweep == SNAP_KILL_AT,
          "the 4-way kill and resume did not run")
    check(want_c["fused_kron_chain_scatter"] == 4 * N_ITER and want_c["kron_contrib"] == 0
          and want_c["scatter_rows"] == 0 and launches_c == want_c,
          f"4-way launches {launches_c}, want {want_c}")
    check(same_bits(resumed_c, *host_copy(base_c)),
          "the 4-way resumed run differs from its uninterrupted run")
    check(bool(np.all(np.isfinite(resumed_c.fit_history))), "4-way fit not finite")
    out["four_way"] = {"shape": shape_c, "nnz": nnz_c, "ranks": ranks_c, "method": method_c,
                       "resumed_from": resumed_c.resumed_from_sweep,
                       "launches": {k: v for k, v in launches_c.items() if v},
                       "fit_history": resumed_c.fit_history.tolist()}
    print(json.dumps(out), flush=True)


# -- phase 14: sharded sparse HOOI over torch.distributed ----------------------------

SHARD_WORLD = 4  # 14b-14d: ranks sharing the one card over gloo
SHARD_RESUME_WORLD = 2  # 14d: the elastic resume
SHARD_WARM_RUNS = 2  # 3 until the time limit cut it
SHARD_TIMEOUT_S = 300  # each group's collective timeout, and each spawn's deadline


def shard_imbalance_of(nnz: int, world: int) -> float:
    """``1 - min/max`` of the shards' real nonzeros when ``nnz`` nonzeros
    are padded to a multiple of ``world`` and cut into contiguous slices,
    worked out here apart from the port."""
    per = -(-nnz // world)
    counts = [min(max(nnz - r * per, 0), per) for r in range(world)]
    return 1.0 - min(counts) / max(counts)


def shard_child(rank: int, world: int, backend: str, store: str, tmp: str, job: str,
                cfg: dict) -> None:
    """One rank of phase 14, in a spawned process: joins the group, draws
    the tensor on its device from phase 4's seed, runs ``job`` and saves
    its results to ``tmp``. The parent built the kernels; this process
    loads them."""
    import datetime

    import torch.distributed as dist

    on_card = cfg["device"] != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)  # every rank's card: the one of this machine
        torch.cuda.reset_peak_memory_stats()
    else:  # a rehearsal: the ranks share the host's cores
        torch.set_num_threads(1)
    # NCCL binds its communicator to the rank's card at once
    bind = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S), **bind)
    try:
        out = SHARD_JOBS[job](rank, world, torch.device(cfg["device"]), tmp, cfg)
        if on_card:
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(out, os.path.join(tmp, f"{job}-r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _shard_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _shard_tensor(dev, cfg: dict, which: str = "nell2"):
    from repro_torch.core.coo import SparseCOO

    if which == "nell2":
        idx, vals = synthetic(dev, cfg["shape"], cfg["nnz"], SEED, "uniform")
        return SparseCOO.from_parts(idx, vals, cfg["shape"])
    shape_c, nnz_c = cfg["tenant_c"][:2]
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    return SparseCOO.from_parts(idx, vals, shape_c)


def _shard_result(res, launches: dict) -> dict:
    return {"fit": res.fit_history.copy(), "factors": [f.cpu() for f in res.factors],
            "core": res.core.cpu(), "launches": {k: v for k, v in launches.items() if v},
            "dispatches": res.dispatches, "collective_bytes": res.collective_bytes_per_sweep,
            "imbalance": res.shard_imbalance, "resumed_from": res.resumed_from_sweep,
            "world": res.spec.shard.num_devices if res.spec.shard else None}


def _shard_warm(plan, coo, dev, runs: int) -> dict:
    """Warm sweep ms (host clock around each call, which ends in a
    synchronize), the ranks lined up at a barrier before each; then the
    all-reduce ms a sweep, from one more call with each collective timed
    between two synchronizes."""
    import torch.distributed as dist

    from repro_torch.core.engine import ShardedSweepEngine

    n_iter = plan.spec.n_iter
    sweep_ms = []
    for _ in range(runs):
        dist.barrier()
        t0 = time.perf_counter()
        plan(coo)
        _shard_sync(dev)
        sweep_ms.append((time.perf_counter() - t0) * 1e3 / n_iter)
    spent = []
    real = ShardedSweepEngine.all_reduce

    def timed(self, y):
        _shard_sync(dev)
        t0 = time.perf_counter()
        out = real(self, y)
        _shard_sync(dev)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    ShardedSweepEngine.all_reduce = timed
    try:
        dist.barrier()
        plan(coo)
    finally:
        ShardedSweepEngine.all_reduce = real
    return {"sweep_ms": float(np.median(sweep_ms)), "sweep_ms_runs": sweep_ms,
            "allreduce_ms_per_sweep": sum(spent) / n_iter, "allreduces": len(spent)}


def _shard_job_one(rank, world, dev, tmp, cfg) -> dict:
    """14a: phase 4's tensor and factors on a world of one."""
    from repro_torch import tucker

    coo = _shard_tensor(dev, cfg)
    spec = tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world))
    plan = tucker.plan(spec, device=dev)
    reset_launches()
    res = plan(coo)
    _shard_sync(dev)
    out = _shard_result(res, read_launches())
    out["checksum"] = coo_checksum(coo)
    out["fingerprint"] = tucker.mesh_fingerprint(plan.mesh)
    out.update(_shard_warm(plan, coo, dev, SHARD_WARM_RUNS))
    return out


def _shard_kernel1_on_slice(plan, coo, res, shape) -> dict:
    """Kernel 1 on this rank's slice, mode by mode, at the schedules the
    sharded sweep gave it: against its plain version (fp32), both timed,
    and its bound for the slice's real nonzeros."""
    from repro_torch.kernels import kron_kernel

    sched = plan.engine.shard_schedule(coo, plan.mesh)
    local = sched.coo
    real_nnz = int(sched.shard_counts[sched.rank])
    fs = [f.contiguous() for f in res.factors]
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "per_mode": []}
    nbytes_all, flops_all = 0, 0
    for mode in range(3):
        ds = plan.engine.device_schedule(local, mode)
        fa, fb = kron_factors(fs, mode)
        kern = partial(kron_kernel.fused_kron_scatter, fa, fb, ds, shape[mode])
        plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, ds, shape[mode])
        err = compare(f"fused_kron_scatter rank 0's slice mode {mode} ({real_nnz} nnz)", "fp32",
                      synced(kern()), synced(plain()), max_row_count(local, mode))
        ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
        k = fa.shape[1] * fb.shape[1]
        nbytes = (nbytes_of(ds.idx, ds.vals, ds.rel_row, ds.blkmap, ds.parts,
                            *kron_kernel._cast_operands("fp32", fa, fb)) + shape[mode] * k * 4)
        flops = kron_scatter_flops(real_nnz, fa.shape[1], k)
        b_ms, _ = bound(nbytes, flops, PEAK_TF32_FLOPS)
        nbytes_all, flops_all = nbytes_all + nbytes, flops_all + flops
        for key, v in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
            row[key] += v
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["per_mode"].append({"mode": mode, "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                "max_abs_err": err})
    row["bound_by"] = bound(nbytes_all, flops_all, PEAK_TF32_FLOPS)[1]
    return {"kernel1": row, "kernel1_ms_per_sweep": row["ms"], "slice_nnz": real_nnz}


def _shard_kernels34_on_slice(plan, coo, res, shape) -> dict:
    """The chain kernel, and kernels 3 and 4 as the unfused route runs them,
    on this rank's slice of a 4-way tensor, mode by mode, at the schedules
    the sharded sweep gave them: each against its plain version (fp32), the
    chain kernel against kernels 3 and 4 too, all timed, and each kernel's
    bound."""
    from repro_torch.kernels import kron_kernel, ops
    from repro_torch.sparse.layout import operand_modes

    sched = plan.engine.shard_schedule(coo, plan.mesh)
    local = sched.coo
    real_nnz = int(sched.shard_counts[sched.rank])
    fs = [f.contiguous() for f in res.factors]
    tot = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                  "bytes": 0, "flops": 0}
           for name in ("fused_kron_chain_scatter", "kron_contrib", "scatter_rows")}
    for mode in range(4):
        ds = plan.engine.device_schedule(local, mode)
        rows, v = ops._gathered_block_rows(local.indices, local.values, fs, mode, ds, 4)
        ones = torch.ones_like(v)
        nnzp = v.shape[0]
        label = f"rank 0's slice mode {mode} ({real_nnz} nnz)"
        link1 = partial(kron_kernel.kron_contrib, rows[0], rows[1], v)
        link1_plain = partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v)
        c1 = synced(link1())
        err1 = compare(f"kron_contrib {label} link 1", "fp32", c1, synced(link1_plain()), 1)
        link2 = partial(kron_kernel.kron_contrib, c1, rows[2], ones)
        link2_plain = partial(kron_kernel.kron_contrib_plain, c1, rows[2], ones)
        c2 = synced(link2())
        err2 = compare(f"kron_contrib {label} link 2", "fp32", c2, synced(link2_plain()), 1)
        scat = partial(kron_kernel.scatter_rows, c2, ds, shape[mode])
        scat_plain = partial(kron_kernel.scatter_rows_plain, c2, ds, shape[mode])
        y = synced(scat())
        terms = max_row_count(local, mode)
        err_s = compare(f"scatter_rows {label}", "fp32", y, synced(scat_plain()), terms)
        opf = [fs[t] for t in operand_modes(4, mode)]
        fused = partial(kron_kernel.fused_kron_chain_scatter, opf, ds, shape[mode])
        fused_plain = partial(kron_kernel.fused_kron_chain_scatter_plain, opf, ds, shape[mode])
        yf = synced(fused())
        err_f = compare(f"fused_kron_chain_scatter {label}", "fp32", yf, synced(fused_plain()),
                        terms)
        compare(f"fused_kron_chain_scatter {label} against kernels 3 and 4", "fp32", yf, y,
                terms)
        f_bytes, f_flops = chain_scatter_work(ds, opf, shape[mode], real_nnz)
        k1, k = c1.shape[1], c2.shape[1]
        for name, ms, p_ms, nb, fl, err, peak in (
                ("fused_kron_chain_scatter", time_ms(fused), time_ms(fused_plain), f_bytes,
                 f_flops, err_f, PEAK_TF32_FLOPS),
                ("kron_contrib", time_ms(link1) + time_ms(link2),
                 time_ms(link1_plain) + time_ms(link2_plain),
                 # link 1 writes c1 and link 2 reads it; link 2 writes c2
                 nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + nnzp * k * 4,
                 kron_contrib_flops(nnzp, rows[0].shape[1], rows[1].shape[1])
                 + kron_contrib_flops(nnzp, k1, rows[2].shape[1], scaled=False),
                 max(err1, err2), PEAK_F32_FLOPS),
                ("scatter_rows", time_ms(scat), time_ms(scat_plain),
                 nbytes_of(c2, ds.rel_row, ds.blkmap, ds.parts) + shape[mode] * k * 4,
                 real_nnz * k, err_s, PEAK_F32_FLOPS)):
            t = tot[name]
            t["ms"] += ms
            t["plain_ms"] += p_ms
            t["bound_ms"] += bound(nb, fl, peak)[0]
            t["bytes"] += nb
            t["flops"] += fl
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["peak"] = peak
    for t in tot.values():
        t["bound_by"] = bound(t["bytes"], t["flops"], t.pop("peak"))[1]
    return {"slice_nnz": real_nnz, **tot}


def _count_checkpoint_saves() -> list:
    """Steps this process writes through ``CheckpointManager.save``."""
    from repro_torch.checkpoint.manager import CheckpointManager

    saves, real = [], CheckpointManager.save

    def save(self, step, state, extra=None):
        saves.append(int(step))
        return real(self, step, state, extra=extra)

    CheckpointManager.save = save
    return saves


def _shard_snap_spec(cfg, tmp, name, world):
    from repro_torch import tucker

    return tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world),
                             snapshot=tucker.SnapshotSpec(every_n_sweeps=SNAP_EVERY,
                                                          directory=os.path.join(tmp, name)))


def _shard_job_four(rank, world, dev, tmp, cfg) -> dict:
    """14b-14d on ``world`` ranks sharing the card."""
    import torch.distributed as dist

    from repro_torch import tucker
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import kron_kernel
    from repro_torch.runtime.fault_tolerance import FailureInjector

    saves = _count_checkpoint_saves()
    coo = _shard_tensor(dev, cfg)
    out = {"checksum": coo_checksum(coo)}
    # 14b: the main path of this phase; the counts start at 0 here
    spec = tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world))
    plan = tucker.plan(spec, device=dev)
    dist.barrier()
    reset_launches()
    res = plan(coo)
    _shard_sync(dev)
    out["b"] = _shard_result(res, read_launches())
    out["b"].update(_shard_warm(plan, coo, dev, SHARD_WARM_RUNS))
    out["fingerprint"] = tucker.mesh_fingerprint(plan.mesh)
    if dev.type == "cuda":  # kernel 1 on this rank's slice, the other ranks idle
        dist.barrier()
        if rank == 0:
            out["b"].update(_shard_kernel1_on_slice(plan, coo, res, cfg["shape"]))
        dist.barrier()
    del plan
    tucker.clear_plan_cache()

    # 14c: tenant C's 4-way shape, sharded, and unsharded on rank 0
    coo_c = _shard_tensor(dev, cfg, "tenant_c")
    shape_c, _, ranks_c, method_c = cfg["tenant_c"]
    spec_c = tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER,
                               shard=tucker.ShardSpec(world))
    plan_c = tucker.plan(spec_c, device=dev)
    dist.barrier()
    reset_launches()
    res_c = plan_c(coo_c)
    _shard_sync(dev)
    out["c"] = _shard_result(res_c, read_launches())
    if rank == 0:
        base = tucker.plan(tucker.TuckerSpec(shape_c, ranks_c, method=method_c,
                                             n_iter=N_ITER), device=dev)(coo_c)
        out["c_unsharded"] = _shard_result(base, {})
        if dev.type == "cuda":  # kernels 3 and 4 on this rank's slice
            out["c_kernels"] = _shard_kernels34_on_slice(plan_c, coo_c, res_c, shape_c)
    dist.barrier()
    del coo_c, plan_c
    tucker.clear_plan_cache()

    # 14d: kill at a segment boundary; resume on this world; a second job
    # is left for fewer ranks
    killed = []
    for name in ("same_world", "fewer_ranks"):
        try:
            tucker.plan(_shard_snap_spec(cfg, tmp, name, world), device=dev)(
                coo, injector=FailureInjector([SNAP_KILL_AT]))
            killed.append(False)
        except RuntimeError as exc:
            killed.append("injected failure" in str(exc))
    dist.barrier()
    out["killed"] = killed
    if rank == 0:
        mgr = CheckpointManager(os.path.join(tmp, "fewer_ranks"))
        out["manifest_mesh"] = mgr.read_manifest()["extra"]["mesh"]
        out["steps_on_disk"] = mgr.all_steps()
    reset_launches()
    resumed = tucker.resume(_shard_snap_spec(cfg, tmp, "same_world", world), coo, device=dev)
    _shard_sync(dev)
    out["d"] = _shard_result(resumed, read_launches())
    out["saves"] = list(saves)
    return out


def _shard_job_fewer(rank, world, dev, tmp, cfg) -> dict:
    """14d: the job killed on ``SHARD_WORLD`` ranks, resumed on these."""
    import warnings

    from repro_torch import tucker

    saves = _count_checkpoint_saves()
    coo = _shard_tensor(dev, cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tucker.resume(_shard_snap_spec(cfg, tmp, "fewer_ranks", SHARD_WORLD), coo,
                            device=dev)
    _shard_sync(dev)
    out = _shard_result(res, {})
    out["warned"] = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    out["saves"] = list(saves)
    return out


SHARD_JOBS = {"one": _shard_job_one, "four": _shard_job_four, "fewer": _shard_job_fewer}
# phase 25b's ranks (phases 17 and 18 add theirs below)


def run_ranks(job: str, world: int, backend: str, tmp: str, cfg: dict) -> list:
    """Spawn ``world`` ranks of ``job`` and return each rank's saved result;
    a rank that fails fails the phase, and none outlives it."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp, f"store-{job}")
    ctx = mp.start_processes(shard_child, args=(world, backend, store, tmp, job, cfg),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"phase 14 {job}: ranks still running after {SHARD_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [torch.load(os.path.join(tmp, f"{job}-r{r}.pt"), weights_only=False)
            for r in range(world)]


def _as_run(r: dict, dev):
    """A rank's saved result as ``within_phase3_tolerances`` reads one."""
    from types import SimpleNamespace

    return SimpleNamespace(fit_history=r["fit"], factors=[f.to(dev) for f in r["factors"]],
                           core=r["core"])


def _same_bits(a: dict, b: dict) -> bool:
    return (np.array_equal(a["fit"], b["fit"]) and torch.equal(a["core"], b["core"])
            and all(torch.equal(x, y) for x, y in zip(a["factors"], b["factors"])))


def phase14_sharded(dev, card: str, ref4: dict, cfg: Optional[dict] = None) -> None:
    """Sharded sparse HOOI (``TuckerSpec.shard``) in spawned ranks: 14a
    phase 4's run over NCCL in a world of one (its bits); 14b the same on 4
    ranks over gloo sharing the card (every rank the same bits, phase 3's
    tolerances of phase 4); 14c tenant C's 4-way shape on 4 ranks against
    its unsharded run; 14d a kill and resume on 4 ranks (14b's bits) and
    on 2 (the clamp warning, phase 3's tolerances). ``cfg`` shrinks the
    shapes for a rehearsal on the CPU (``{"device": "cpu", ...}``)."""
    import shutil
    import tempfile

    cfg = {"device": "cuda", "shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS,
           "tenant_c": TENANT_C, "backend_a": "nccl", **(cfg or {})}
    on_card = cfg["device"] != "cpu"
    shape, nnz, ranks = cfg["shape"], cfg["nnz"], cfg["ranks"]
    log(f"phase 14: sharded sparse HOOI, {shape}, {nnz} nnz, ranks {ranks}, {N_ITER} sweeps: "
        f"a world of one over {cfg['backend_a']}, {SHARD_WORLD} and {SHARD_RESUME_WORLD} "
        f"ranks over gloo sharing the card; tenant C {cfg['tenant_c'][0]}")
    if on_card:
        release_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase14_")
    out = {"phase": "14 sharded sparse HOOI", "card": card}
    # N all-reduces a sweep, of I_n x prod_{t != n} R_t f32 each
    want_bytes = sum(dim * math.prod(r for t, r in enumerate(ranks) if t != m) * 4
                     for m, dim in enumerate(shape))
    launches3 = {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER}
    try:
        # 14a
        t0 = time.perf_counter()
        a = run_ranks("one", 1, cfg["backend_a"], tmp, cfg)[0]
        t_a = time.perf_counter() - t0
        log(f"  14a: world of one over {cfg['backend_a']} ({a['fingerprint']}), {t_a:.1f} s: "
            f"launches {a['launches']}, {a['collective_bytes']} B a sweep, warm "
            f"{a['sweep_ms']:.2f} ms a sweep (all-reduce {a['allreduce_ms_per_sweep']:.3f})")
        check(a["checksum"] == ref4["checksum"], "14a: the tensor is not phase 4's")
        check(_same_bits(a, ref4), "14a: not phase 4's bits")
        check(a["collective_bytes"] == want_bytes,
              f"14a: {a['collective_bytes']} B a sweep, want {want_bytes}")
        check(a["dispatches"] == 1 and a["imbalance"] == 0.0, "14a: dispatches or imbalance")
        if on_card:
            check(a["launches"] == launches3, f"14a: launches {a['launches']}")
        out["14a"] = {key: a.get(key) for key in (
            "launches", "collective_bytes", "sweep_ms", "sweep_ms_runs",
            "allreduce_ms_per_sweep", "fingerprint", "peak_gb")}
        out["14a"]["seconds"] = t_a

        # 14b-14d
        t0 = time.perf_counter()
        four = run_ranks("four", SHARD_WORLD, "gloo", tmp, cfg)
        t_four = time.perf_counter() - t0
        r0 = four[0]
        fp4 = r0["fingerprint"]
        for r, o in enumerate(four):
            check(o["checksum"] == ref4["checksum"], f"rank {r}: the tensor is not phase 4's")
            for part in ("b", "c", "d"):
                check(_same_bits(o[part], r0[part]), f"14{part}: rank {r}'s bits are not rank 0's")
            if on_card:
                check(o["b"]["launches"] == launches3, f"14b rank {r}: launches "
                      f"{o['b']['launches']}")
                want_c = {"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER}
                check(o["c"]["launches"] == want_c, f"14c rank {r}: launches "
                      f"{o['c']['launches']}")
            check(o["killed"] == [True, True], f"14d rank {r}: the kills {o['killed']}")
            check(o["saves"] == ([0, 2, 4] * 2 + [5] if r == 0 else []),
                  f"14d rank {r} wrote steps {o['saves']}")
        b = r0["b"]
        want_imb = shard_imbalance_of(nnz, SHARD_WORLD)
        log(f"  14b: {SHARD_WORLD} ranks over gloo ({fp4}), {t_four:.1f} s for 14b-14d; "
            f"imbalance {b['imbalance']!r} (want {want_imb!r}); every rank the same bits")
        check(b["imbalance"] == want_imb and b["collective_bytes"] == want_bytes,
              "14b: imbalance or collective bytes")
        out["14b"] = {"vs_phase4": within_phase3_tolerances(
            "14b against phase 4", _as_run(b, dev), ref4["fit"], ref4["factors"], ref4["core"])}
        for r, o in enumerate(four):
            log(f"  14b rank {r}: warm {o['b']['sweep_ms']:.2f} ms a sweep ("
                + ", ".join(f"{m:.2f}" for m in o["b"]["sweep_ms_runs"])
                + f"), all-reduce {o['b']['allreduce_ms_per_sweep']:.2f} ms a sweep over "
                f"{o['b']['allreduces']} calls, peak {o.get('peak_gb', 0.0):.2f} GB")
        out["14b"].update(
            imbalance=b["imbalance"], collective_bytes=b["collective_bytes"],
            sweep_ms_by_rank=[o["b"]["sweep_ms"] for o in four],
            sweep_ms_runs_by_rank=[o["b"]["sweep_ms_runs"] for o in four],
            allreduce_ms_per_sweep_by_rank=[o["b"]["allreduce_ms_per_sweep"] for o in four],
            peak_gb_by_rank=[o.get("peak_gb") for o in four],
            kernel1_ms_per_sweep_rank0=b.get("kernel1_ms_per_sweep"),
            kernel1_rank0=b.get("kernel1"),
            slice_nnz_rank0=b.get("slice_nnz"), launches_rank0=b["launches"])
        if on_card:
            k1 = b["kernel1"]
            check(math.isfinite(k1["max_abs_err"]) and k1["plain_ms"] > 0,
                  "14b: kernel 1 was not held to its plain version on rank 0's slice")
            log(f"  14b kernel 1 on rank 0's slice ({b['slice_nnz']} nnz), 3 modes, CUDA "
                f"events: {k1['ms']:.3f} ms a sweep, plain {k1['plain_ms']:.3f} ms, bound "
                f"{k1['bound_ms']:.3f} ms, max_abs_err {k1['max_abs_err']:.3e}")
        c = r0["c"]
        out["14c"] = {"vs_unsharded": within_phase3_tolerances(
            "14c against its unsharded run", _as_run(c, dev), r0["c_unsharded"]["fit"],
            r0["c_unsharded"]["factors"], r0["c_unsharded"]["core"]),
            "launches_rank0": c["launches"], "imbalance": c["imbalance"],
            "kernels_rank0": r0.get("c_kernels")}
        if on_card:
            for name in ("fused_kron_chain_scatter", "kron_contrib", "scatter_rows"):
                k = r0["c_kernels"][name]
                check(math.isfinite(k["max_abs_err"]) and k["plain_ms"] > 0,
                      f"14c: {name} was not held to its plain version on rank 0's slice")
                log(f"  14c {name} on rank 0's slice ({r0['c_kernels']['slice_nnz']} nnz), 4 "
                    f"modes: {k['ms']:.3f} ms a sweep, plain {k['plain_ms']:.3f} ms, bound "
                    f"{k['bound_ms']:.4f} ms, max_abs_err {k['max_abs_err']:.3e}")
        check(c["imbalance"] == shard_imbalance_of(cfg["tenant_c"][1], SHARD_WORLD),
              "14c: imbalance")
        d = r0["d"]
        log(f"  14d: killed at sweep {SNAP_KILL_AT} on {SHARD_WORLD} ranks, resumed there from "
            f"{d['resumed_from']}: 14b's bits {_same_bits(d, b)}; manifest mesh "
            f"{r0['manifest_mesh']}, steps on disk {r0['steps_on_disk']}")
        check(d["resumed_from"] == SNAP_KILL_AT and _same_bits(d, b),
              "14d: the resumed run is not the uninterrupted 4-rank run")
        check(r0["manifest_mesh"] == fp4, f"14d: manifest mesh {r0['manifest_mesh']}")

        t0 = time.perf_counter()
        fewer = run_ranks("fewer", SHARD_RESUME_WORLD, "gloo", tmp, cfg)
        t_fewer = time.perf_counter() - t0
        f0 = fewer[0]
        for r, o in enumerate(fewer):
            check(_same_bits(o, f0), f"14d: rank {r} of {SHARD_RESUME_WORLD} differs")
            check(any(w.startswith(f"resuming a {SHARD_WORLD}-device job on "
                                   f"{SHARD_RESUME_WORLD} attached device(s): clamping")
                      for w in o["warned"]), f"14d: rank {r} did not warn: {o['warned']}")
            check(o["saves"] == ([5] if r == 0 else []), f"14d rank {r} wrote {o['saves']}")
        check(f0["world"] == SHARD_RESUME_WORLD and f0["resumed_from"] == SNAP_KILL_AT,
              "14d: the clamp or the resume point")
        log(f"  14d: resumed on {SHARD_RESUME_WORLD} ranks in {t_fewer:.1f} s, warned: "
            f"{f0['warned'][0][:60]}...")
        out["14d"] = {"killed_at": SNAP_KILL_AT, "resumed_same_world": "14b's bits",
                      "manifest_mesh": r0["manifest_mesh"], "steps_on_disk": r0["steps_on_disk"],
                      "fewer_ranks_vs_14b": within_phase3_tolerances(
                          "14d on 2 ranks against 14b", _as_run(f0, dev), b["fit"],
                          b["factors"], b["core"]),
                      "seconds_fewer": t_fewer}
        out["seconds"] = {"14a": t_a, "14b-d": t_four, "14d_fewer": t_fewer}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)


# -- phase 15: float64 through kernels 1-4 --------------------------------------

# the kernel symbols' first template argument in a mangled name, by dtype
_MANGLED_DTYPE = {"d": "float64", "f": "float32", "13__nv_bfloat16": "bfloat16"}
# (library, kernel symbol, wrapper) of the kernels whose datapath
# kron_kernel.launch_route names and the SASS shows
ROUTED_SYMBOLS = (("kron_scatter", "kron_scatter_kernel", "fused_kron_scatter"),
                  ("ttm", "ttm_kernel", "ttm"),
                  ("kron_scatter_ttm", "kron_scatter_ttm_kernel", "fused_kron_scatter_ttm"),
                  ("kron_chain_scatter", "chain_scatter_kernel", "fused_kron_chain_scatter"))


_SASS_DUMPS = {}  # library name -> (its SASS file, the cuobjdump process writing it)


def start_sass_dumps() -> None:
    """Start ``cuobjdump -sass`` (beside ``nvcc``) of each library of
    ROUTED_SYMBOLS in the background, each into ``build/kernels/<name>.sass``
    (phase 1 starts them after the build; :func:`sass_mma_counts` waits)."""
    from repro_torch.kernels import _build

    for name, _, _ in ROUTED_SYMBOLS:
        if name not in _SASS_DUMPS:
            tool = Path(_build.nvcc()).parent / "cuobjdump"
            path = _build.BUILD_DIR / f"{name}.sass"
            with open(path, "w") as out:
                _SASS_DUMPS[name] = (path, subprocess.Popen(
                    [str(tool), "-sass", str(_build.library_path(name))], stdout=out,
                    stderr=subprocess.STDOUT))


def sass_mma_counts(name: str) -> dict:
    """Tensor-core instructions in the SASS of each kernel of the built
    library of ``csrc/<name>.cu``: ``{"<kernel> <dtype>": {"DMMA": n,
    "HMMA.TF32": n, "HMMA.BF16": n, "HMMA": n}}`` (HMMA of any type in the
    last), the dtype that of the kernel's first template argument,
    instantiations summed."""
    start_sass_dumps()
    path, proc = _SASS_DUMPS[name]
    check(proc.wait() == 0, f"cuobjdump -sass of lib{name} failed: {path.read_text()[-2000:]}")
    counts, key = {}, None
    for line in path.read_text().splitlines():
        if "Function :" in line:
            m = re.search(r"\d([a-z][a-z_]*_kernel)I(d|f|13__nv_bfloat16)", line)
            key = f"{m.group(1)} {_MANGLED_DTYPE[m.group(2)]}" if m else None
            if key:
                counts.setdefault(key, {"DMMA": 0, "HMMA.TF32": 0, "HMMA.BF16": 0, "HMMA": 0})
        elif key:
            op = re.search(r"\s(DMMA|HMMA)(\.\S*)?", line)
            if op:
                counts[key][op.group(1)] += 1
                for kind in ("TF32", "BF16"):
                    if op.group(1) == "HMMA" and f".{kind}" in (op.group(2) or ""):
                        counts[key][f"HMMA.{kind}"] += 1
    return counts


# the tensor-core instructions each route's SASS holds (the others none):
# DMMA, HMMA of TF32 operands (m16n8k8), HMMA of bf16 operands (m16n8k16)
_ROUTE_MMA = {"dmma": "DMMA", "3xtf32": "HMMA.TF32", "2xtf32": "HMMA.TF32",
              "bf16_mma": "HMMA.BF16", "cuda_cores": None}
# what a kernel holds besides its route's products: kernel 5's rounds G +=
# U^T Y run on TF32 HMMA in f32 (3xTF32) and bf16 (2xTF32, beside its
# walk's bf16 HMMA), and on DMMA, its route's, in f64
_EXTRA_MMA = {("fused_kron_scatter_ttm", "float32"): "HMMA.TF32",
              ("fused_kron_scatter_ttm", "bfloat16"): "HMMA.TF32"}


def check_routes_in_sass() -> dict:
    """Each routed kernel's f32, f64 and bf16 instantiations hold
    tensor-core instructions of exactly the kind that
    ``kron_kernel.launch_route`` names (``_ROUTE_MMA``): DMMA where it says
    ``"dmma"``, TF32 HMMA where ``"3xtf32"`` or ``"2xtf32"``, bf16 HMMA
    where ``"bf16_mma"``, none where ``"cuda_cores"``; besides those, only
    kernel 5's TF32 contraction rounds in f32 and bf16 (``_EXTRA_MMA``). The bf16
    instantiation is the route of f32 operands under ``bf16_fp32acc``.
    Returns the counts by wrapper and operand type."""
    from repro_torch.kernels import kron_kernel

    out = {}
    for lib, symbol, wrapper in ROUTED_SYMBOLS:
        counts = sass_mma_counts(lib)
        for name, dtype, precision in (("float32", torch.float32, "fp32"),
                                       ("float64", torch.float64, "fp32"),
                                       ("bfloat16", torch.float32, "bf16_fp32acc")):
            route = kron_kernel.launch_route(wrapper, dtype, precision)
            got = counts.get(f"{symbol} {name}")
            check(got is not None, f"no {symbol} {name} in the SASS of lib{lib}")
            out[f"{wrapper} {name}"] = {"route": route, **got}
            log(f"  SASS {symbol} {name}: {got['DMMA']} DMMA, {got['HMMA.TF32']} TF32 HMMA, "
                f"{got['HMMA.BF16']} bf16 HMMA, {got['HMMA']} HMMA; route {route}")
            want = {_ROUTE_MMA[route], _EXTRA_MMA.get((wrapper, name))} - {None}
            check(all((got[k] > 0) == (k in want) for k in ("DMMA", "HMMA.TF32", "HMMA.BF16"))
                  and got["HMMA"] == got["HMMA.TF32"] + got["HMMA.BF16"],
                  f"{symbol} {name}: the SASS ({got}) is not the route {route!r} (want {want})")
    return out


def log_occupancy(dev) -> dict:
    """Registers a thread and CTAs an SM of kernel 1 (at ranks 16 x 16),
    kernel 2 and kernel 5 (at ranks 16 x 16 x 16, its first pass), by
    operand type, as their launchers size them; logged."""
    from repro_torch.kernels import kron_kernel, ttm_kernel

    out = {}
    for label, dtype, precision in (("f32", torch.float32, "fp32"),
                                    ("bf16", torch.float32, "bf16_fp32acc"),
                                    ("f64", torch.float64, "fp32")):
        kind = kron_kernel._kind(torch.bfloat16 if precision == "bf16_fp32acc" else dtype)
        mega = kron_kernel.mega_grid(dev, 16, 16, 16, 16, 16, kind, 28818)
        for kernel, occ in (
                ("fused_kron_scatter", kron_kernel.occupancy(dev, 16, 16, dtype, precision)),
                ("ttm", ttm_kernel.occupancy(
                    dev, torch.bfloat16 if precision == "bf16_fp32acc" else dtype)),
                ("fused_kron_scatter_ttm", {k: mega[k] for k in (
                    "threads", "smem_bytes", "registers", "ctas_per_sm")})):
            route = kron_kernel.launch_route(kernel, dtype, precision)
            out[f"{kernel} {label}"] = {"route": route, **occ}
            log(f"  occupancy {kernel} {label} ({route}): {occ['threads']} threads, "
                f"{occ['smem_bytes']} B shared, {occ['registers']} registers, "
                f"{occ['ctas_per_sm']} CTAs an SM")
    return out



F64_ROWS = ["fused_kron_scatter_f64", "ttm_f64", "kron_contrib_f64", "scatter_rows_f64",
            "fused_kron_chain_scatter_f64", "fused_kron_scatter_ttm_f64"]
# 15g: kernel 5 in f64 at odd shapes, 2- and 3-way, ranks 1-17 and R not a
# multiple of 8 (shape, ranks, nnz)
KERNEL5_F64_CASES = [((50, 40, 30), (4, 3, 5), 1000), ((300, 200, 100), (16, 16, 16), 20_000),
                     ((100, 80, 60), (13, 17, 10), 5000), ((70, 60, 50), (2, 1, 17), 3000),
                     ((40, 30, 20), (17, 9, 11), 2500), ((60, 50), (7, 5), 700),
                     ((90, 70), (1, 3), 400)]
F64_FIT_TOL, F64_PROJ_TOL = 1e-10, 1e-8  # 15c-15f: f64 card against f64 CPU or alone
# a fit history is kept in f32 in either dtype (the reference's too): two
# f32 ulps of a value in [0.5, 1)
F32_HISTORY_ULPS = 2.0 ** -23
RANK1_SUPPORT = (40, 30, 20)  # 15c: 24,000 nonzeros, phase 3's count
RANK1_SEEDS = 4  # 15c: rank-1 tensors drawn
RANK1_FIT_ERR = 1e-6


def xnorm2_of(x) -> float:
    """||X||^2 in f64 of a COO tensor (its values) or a dense one."""
    vals = x.values if hasattr(x, "values") and not isinstance(x, torch.Tensor) else x
    return float(vals.double().square().sum())


def fit64(res, xnorm2: float) -> float:
    """The last sweep's relative error in f64, from the projection
    identity on the result's core: what the f32 fit history rounds."""
    g2 = float(res.core.double().square().sum())
    return math.sqrt(max(xnorm2 - g2, 0.0) / xnorm2)


def f64_kernel_cases(dev) -> None:
    """15a: kernels 1-4 in f64 against their f64 plain versions at phase 2's
    odd shapes (nnz not a multiple of 128, duplicates, 2-way, ranks 5x3,
    16, 13x22x10, 33x40, a 4-way chain), each kernel 1 and 2 call twice for
    its bits."""
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    rng = np.random.default_rng(SEED + 15)
    cases = [((50, 40, 30), (4, 3, 5), 1000), ((300, 200, 100), (16, 16, 16), 20_000),
             ((100, 80, 60), (13, 22, 10), 5000), ((70, 60, 50), (2, 33, 40), 3000),
             ((60, 50), (7, 5), 700)]
    for shape, ranks, nnz in cases:
        idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
        idx = np.concatenate([idx, idx[:nnz // 5]])  # duplicate coordinates
        coo = SparseCOO.from_parts(idx.astype(np.int32), rng.standard_normal(idx.shape[0]),
                                   shape, device=dev)
        fs = [torch.tensor(np.linalg.qr(rng.standard_normal((s, r)))[0], device=dev)
              for s, r in zip(shape, ranks)]
        for mode in range(len(shape)):
            sched = schedule_of(coo, mode)
            fa, fb = kron_factors(fs, mode)
            kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, shape[mode])
            got = synced(kern())
            compare(f"fused_kron_scatter f64 {shape} ranks {ranks} mode {mode}", "fp64", got,
                    synced(kron_kernel.fused_kron_scatter_plain(fa, fb, sched, shape[mode])),
                    max_row_count(coo, mode))
            check(torch.equal(got, synced(kern())), f"kernel 1 f64 {shape} mode {mode}: "
                  f"two calls differ")
        y, u = got.T, fs[len(shape) - 1].T
        compare(f"ttm f64 y {tuple(y.shape)} u {tuple(u.shape)}", "fp64",
                check_ttm_call(f"f64 {shape}", y, u, "fp32"),
                synced(ttm_kernel.ttm_plain(y, u)), y.shape[1])
    shape, ranks = (40, 30, 20, 7), (5, 4, 3, 2)
    idx = np.stack([rng.integers(0, s, 3000) for s in shape], 1).astype(np.int32)
    coo = SparseCOO.from_parts(idx, rng.standard_normal(3000), shape, device=dev)
    fs = [torch.tensor(rng.standard_normal((s, r)), device=dev) for s, r in zip(shape, ranks)]
    for mode in range(4):
        sched = schedule_of(coo, mode)
        rows, vals = ops._gathered_block_rows(coo.indices, coo.values, fs, mode, sched, 4)
        c1 = synced(kron_kernel.kron_contrib(rows[0], rows[1], vals))
        compare(f"kron_contrib f64 4-way mode {mode} link 1", "fp64", c1,
                kron_kernel.kron_contrib_plain(rows[0], rows[1], vals), 1)
        ones = torch.ones_like(vals)
        c2 = synced(kron_kernel.kron_contrib(c1, rows[2], ones))
        compare(f"kron_contrib f64 4-way mode {mode} link 2", "fp64", c2,
                kron_kernel.kron_contrib_plain(c1, rows[2], ones), 1)
        compare(f"scatter_rows f64 4-way mode {mode}", "fp64",
                synced(kron_kernel.scatter_rows(c2, sched, shape[mode])),
                kron_kernel.scatter_rows_plain(c2, sched, shape[mode]),
                max_row_count(coo, mode))


def dense_error64(x, core, factors) -> float:
    """||X - Xhat|| / ||X|| in f64, Xhat densified (``relative_error_dense``
    takes X in f32, whose rounding would hide an f64 result's accuracy)."""
    from repro_torch.core.reconstruct import reconstruct_dense

    x = x.double()
    xhat = reconstruct_dense(core.double(), [f.double() for f in factors])
    return float(torch.linalg.vector_norm(x - xhat) / torch.linalg.vector_norm(x))


def rank1_tensor(dev, cfg: dict, seed: int):
    """An exact rank-1 tensor at phase 3's shape: a (x) b (x) c over
    supports of RANK1_SUPPORT rows a mode (24,000 nonzeros), entries
    uniform in [0.5, 1.5), every product stored."""
    from repro_torch.core.coo import SparseCOO

    rng = np.random.default_rng(SEED + 151 + seed)
    shape = cfg["rank1_shape"]
    sup = [np.sort(rng.choice(s, k, replace=False)) for s, k in zip(shape, cfg["rank1_support"])]
    vecs = [rng.uniform(0.5, 1.5, k) for k in cfg["rank1_support"]]
    grid = np.stack(np.meshgrid(*sup, indexing="ij"), -1).reshape(-1, 3)
    vals = np.einsum("i,j,k->ijk", *vecs).reshape(-1)
    return SparseCOO.from_parts(grid.astype(np.int32), vals, shape, device=dev)


def phase15_float64(dev, card: str, ref4: dict, cfg: Optional[dict] = None) -> dict:
    """float64 on the card through the f64 instantiations of kernels 1-4:
    15a the kernels at odd shapes and kernel 1 on NELL-2's three mode
    schedules against their f64 plain versions; 15b phase 4's tensor (drawn
    anew, its checksum held to phase 4's) in f64 from phase 4's initial
    factors, held to phase 4's f32 run; 15c an exact rank-1 tensor's fit
    error and phase 3's mid tensor card against CPU; 15d tenant C's 4-way
    shape card against CPU (the chain kernel and kernel 2), the chain kernel
    timed beside kernels 3 and 4 on the unfused route; 15e Table II at
    800^3 in f64; 15f one service flush of 16 f64 tenant-A requests against
    each served alone; 15g kernel 5 in f64 (:func:`phase15g_kernel5_f64`).
    Returns the kernels line's six f64 rows. ``cfg`` shrinks the shapes for
    a rehearsal on the CPU."""
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.core.hooi import init_factors
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.generators import random_sparse_tensor
    from repro_torch.sparse.layout import operand_modes

    cfg = {"shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS,
           "rank1_shape": (1000, 1000, 1000), "rank1_support": RANK1_SUPPORT,
           "mid": ((1000, 1000, 1000), 2.4e-5, (16, 16, 16)), "tenant_c": TENANT_C,
           "table2": TABLE2_SIZE, "service": SERVICE_TENANTS[0], "flush": SERVICE_MAX_BATCH,
           **(cfg or {})}
    on_card = dev.type == "cuda"
    tf32_off()
    release_memory()
    log(f"phase 15: float64 through kernels 1-4: odd shapes, NELL-2 {cfg['shape']} "
        f"{cfg['nnz']} nnz, a rank-1 tensor, phase 3's mid tensor, tenant C, Table II at "
        f"{cfg['table2']}^3, a service flush")
    out = {"phase": "15 float64", "card": card}
    rows = {}

    t0 = time.perf_counter()
    f64_kernel_cases(dev)
    out["15a_odd_shapes_s"] = time.perf_counter() - t0

    # 15b: the main path in f64
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, cfg["shape"], cfg["nnz"], SEED, "uniform")
    check(coo_checksum(SparseCOO(idx, vals, cfg["shape"])) == ref4["checksum"],
          "15b: the NELL-2 tensor is not phase 4's")
    coo = SparseCOO(idx, vals.double(), cfg["shape"])
    del idx, vals
    f0 = [f.double().to(dev) for f in init_factors(cfg["shape"], cfg["ranks"])]  # phase 4's
    spec = tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER, dtype="float64")
    plan = tucker.plan(spec, device=dev)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()  # the f64 main path: every count starts at 0 here
    res = plan(coo, factors_init=f0)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER, "kron_contrib": 0,
            "scatter_rows": 0, "fused_kron_scatter_ttm": 0, "fused_kron_chain_scatter": 0,
            **NO_LM_LAUNCHES}
    log(f"  15b NELL-2 in f64: drawn and decomposed cold in {t_cold:.2f} s, launches "
        f"{launches}, fit {res.fit_history.tolist()}")
    check(launches == want or not on_card, f"15b: launches {launches}, want {want}")
    check(res.core.dtype == torch.float64 and all(f.dtype == torch.float64 for f in res.factors),
          "15b: the result is not float64")
    vs4 = within_phase3_tolerances("15b f64 against phase 4's f32 run", res, ref4["fit"],
                                   ref4["factors"], ref4["core"])
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        warm = plan(coo, factors_init=f0)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / N_ITER)
        check(np.array_equal(warm.fit_history, res.fit_history) and warm.schedule_builds == 0,
              "15b: a warm run is not the cold run")
    profile = profile_run(lambda: plan(coo, factors_init=f0))
    out["15b"] = {"shape": cfg["shape"], "nnz": cfg["nnz"], "cold_s": t_cold,
                  "profile_warm_run": profile,
                  "sweep_ms": float(np.median(runs)), "sweep_ms_runs": runs,
                  "peak_memory_gb": peak / 1e9, "above_resident_gb": (peak - resident) / 1e9,
                  "launches_per_sweep": {k: v / N_ITER for k, v in launches.items() if v},
                  "vs_phase4_f32": vs4, "fit_history": res.fit_history.tolist()}
    log(f"  15b: {out['15b']['sweep_ms']:.2f} ms a sweep (" + ", ".join(f"{m:.2f}" for m in runs)
        + f"), peak {peak / 1e9:.2f} GB")

    # 15a at the main path's shapes: kernel 1 on the three mode schedules, kernel 2
    eng, fs = plan.engine, [f.contiguous() for f in res.factors]
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "f64_core_bound_ms": 0.0,
          "max_abs_err": 0.0, "bytes": 0, "flops": 0}
    y_last = None
    for mode in range(3):
        sched = eng.device_schedule(coo, mode)
        n_rows = cfg["shape"][mode]
        fa, fb = kron_factors(fs, mode)
        kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows)
        plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, sched, n_rows)
        got = synced(kern())
        k1["max_abs_err"] = max(k1["max_abs_err"], compare(
            f"fused_kron_scatter f64 NELL-2 mode {mode}", "fp64", got, synced(plain()),
            max_row_count(coo, mode)))
        k = got.shape[1]
        nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                            fa, fb) + n_rows * k * 8)
        flops = kron_scatter_flops(coo.nnz, fa.shape[1], k)
        for key, v in (("ms", time_ms(kern)), ("plain_ms", time_ms(plain, reps=1)),
                       ("bound_ms", bound(nbytes, flops, PEAK_F64_FLOPS)[0]),
                       ("f64_core_bound_ms", bound(nbytes, flops, PEAK_F64_CORE_FLOPS)[0]),
                       ("bytes", nbytes), ("flops", flops)):
            k1[key] += v
        if mode == 2:
            y_last = got
        del got
    k1["bound_by"] = bound(k1["bytes"], k1["flops"], PEAK_F64_FLOPS)[1]
    yc, uc = y_last.T, fs[2].T
    k2_err = compare(f"ttm f64 NELL-2 y {tuple(yc.shape)} u {tuple(uc.shape)}", "fp64",
                     check_ttm_call("f64 NELL-2", yc, uc, "fp32"),
                     synced(ttm_kernel.ttm_plain(yc, uc)), yc.shape[1])
    l_, i_ = yc.shape
    nbytes = (l_ * i_ + uc.shape[0] * i_) * 8 + l_ * uc.shape[0] * 8
    flops = 2 * l_ * i_ * uc.shape[0]
    k2 = {"ms": time_ms(partial(ttm_kernel.ttm, yc, uc), reps=20, flush_l2=True),
          "plain_ms": time_ms(partial(ttm_kernel.ttm_plain, yc, uc), reps=20, flush_l2=True),
          "library_ms": time_ms(partial(torch.matmul, yc, uc.T), reps=20, flush_l2=True),
          "bound_ms": bound(nbytes, flops, PEAK_F64_FLOPS)[0],
          "bound_by": bound(nbytes, flops, PEAK_F64_FLOPS)[1],
          "f64_core_bound_ms": bound(nbytes, flops, PEAK_F64_CORE_FLOPS)[0],
          "max_abs_err": k2_err}
    log(f"  15a kernel 1 f64 at NELL-2: {k1['ms']:.3f} ms a sweep, plain {k1['plain_ms']:.1f}, "
        f"bound {k1['bound_ms']:.3f} ({k1['bound_by']}); kernel 2 f64 {k2['ms']:.4f} ms, "
        f"plain {k2['plain_ms']:.4f}, torch.matmul {k2['library_ms']:.4f}, bound "
        f"{k2['bound_ms']:.4f}")
    src = "src/repro_torch/kernels/csrc/"
    device_ms = {k: v / N_ITER for k, v in profile["kernel_ms"].items()}
    # the datapath of each, its SASS and its launch (kernel 1 at NELL-2's ranks)
    sass = check_routes_in_sass() if on_card else {}
    design = {}
    for name, occ in (("fused_kron_scatter", kron_kernel.occupancy(dev, *cfg["ranks"][:2],
                                                                   torch.float64)
                       if on_card else {}),
                      ("ttm", ttm_kernel.occupancy(dev, torch.float64) if on_card else {})):
        design[name] = {"datapath": kron_kernel.launch_route(name, torch.float64),
                        "sass_dmma": sass.get(f"{name} float64", {}).get("DMMA"),
                        "registers": occ.get("registers"), "ctas_per_sm": occ.get("ctas_per_sm"),
                        "threads": occ.get("threads")}
        log(f"  15a {name} f64: {design[name]}")
    check(all(d["datapath"] == "dmma" for d in design.values()),
          f"15a: kernels 1 and 2 in f64 are not on the DMMA route: {design}")
    rows["fused_kron_scatter_f64"] = {
        "name": "fused_kron_scatter_f64", "route": "cuda", "source": src + "kron_scatter.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:306",
        "launches": launches["fused_kron_scatter"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "device_ms": device_ms["fused_kron_scatter"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "f64_core_bound_ms": k1["f64_core_bound_ms"],
        "library_ms": None, **design["fused_kron_scatter"]}
    rows["ttm_f64"] = {"name": "ttm_f64", "route": "cuda", "source": src + "ttm.cu",
                       "replaces": "src/repro/kernels/ttm_kernel.py:62",
                       "launches": launches["ttm"], "device_ms": device_ms["ttm"], **k2,
                       **design["ttm"]}
    out["15a"] = {"kernel1_nell2": k1, "kernel2_nell2": k2}
    del warm, eng, fs, y_last, yc, uc
    release_memory()

    # 15g: kernel 5 in f64 (fuse_core=True)
    rows["fused_kron_scatter_ttm_f64"], out["15g"] = phase15g_kernel5_f64(
        dev, cfg, coo, plan, res, f0)
    del coo, plan, res, f0
    release_memory()

    # 15c: the fit's floor: exact rank-1 tensors, whose true error is 0, in
    # f32 and f64 (the projection identity cancels to 0 or to its dtype's
    # floor, by the sign of its rounding), and phase 3's mid tensor card
    # against CPU
    rank1 = {"float32": [], "float64": []}
    for seed in range(RANK1_SEEDS):
        r1 = rank1_tensor(dev, cfg, seed)
        for dt in rank1:
            coo1 = SparseCOO(r1.indices, r1.values.to(getattr(torch, dt)), r1.shape)
            r = tucker.plan(tucker.TuckerSpec(r1.shape, (1, 1, 1), n_iter=N_ITER, dtype=dt),
                            device=dev)(coo1)
            rank1[dt].append(float(r.rel_error))
    log(f"  15c exact rank-1 tensors {r1.shape}, {r1.nnz} nnz each, ranks 1: fit errors f64 "
        f"{rank1['float64']} (<= {RANK1_FIT_ERR:g}), f32 {rank1['float32']}")
    check(all(0.0 <= e <= RANK1_FIT_ERR for e in rank1["float64"]),
          f"15c: f64 fit errors {rank1['float64']}")
    shape_m, density, ranks_m = cfg["mid"]
    mid = random_sparse_tensor(shape_m, density, seed=11, value_dist="uniform")
    mid = SparseCOO(mid.indices, mid.values.double(), mid.shape)
    card_vs_cpu(f"15c mid tensor {shape_m} in f64", mid, fit_tol=F64_FIT_TOL,
                proj_tol=F64_PROJ_TOL, core_tol=F64_PROJ_TOL,
                spec=tucker.TuckerSpec(shape_m, ranks_m, n_iter=N_ITER, dtype="float64"),
                expect={"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER} if on_card else None)
    out["15c"] = {"rank1_fit_errors": rank1, "rank1_nnz": r1.nnz}
    del r1, mid

    # 15d: tenant C's 4-way shape in f64 (the chain kernel and kernel 2;
    # kernels 3 and 4 on the unfused route)
    shape_c, nnz_c, ranks_c, method_c = cfg["tenant_c"]
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    coo_c = SparseCOO(idx.cpu(), vals.double().cpu(), shape_c)
    spec_c = tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER,
                               dtype="float64")
    want_c = {"fused_kron_chain_scatter": 4 * N_ITER, "ttm": N_ITER}
    cu, _ = card_vs_cpu(f"15d tenant C {shape_c} in f64", coo_c, spec=spec_c,
                        fit_tol=F64_FIT_TOL, proj_tol=F64_PROJ_TOL, core_tol=F64_PROJ_TOL,
                        expect=want_c if on_card else None)
    coo_c = coo_c.to(dev)
    plan_c = tucker.plan(spec_c, device=dev)
    plan_c(coo_c)  # warm: the schedules
    device_ms_c = {k: v / N_ITER
                   for k, v in profile_run(lambda: plan_c(coo_c))["kernel_ms"].items()}
    fs = [f.contiguous() for f in cu.factors]
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "f64_core_bound_ms": 0.0, "max_abs_err": 0.0}
    k4, k34 = dict(k3), dict(k3)
    # the unfused route (kernels 3 and 4), one sweep's unfoldings in one
    # profiled window (the profiler can miss a window of one short call):
    # its launches and device time
    scheds = [plan_c.engine.device_schedule(coo_c, mode) for mode in range(4)]
    unfused_y = {}
    reset_launches()
    prof = profile_run(lambda: unfused_y.update(
        {mode: ops.sparse_ttm_chain_kernel(coo_c, fs, mode, scheds[mode], fused=False)
         for mode in range(4)}))
    unfused = {"launches": {k: n for k, n in read_launches().items() if n},
               "device_ms": {k: prof["kernel_ms"][k] for k in ("kron_contrib", "scatter_rows")}}
    for mode in range(4):
        sched = scheds[mode]
        n_terms = max_row_count(coo_c, mode)
        opf = [fs[t] for t in operand_modes(4, mode)]
        fused = partial(kron_kernel.fused_kron_chain_scatter, opf, sched, shape_c[mode])
        fused_plain = partial(kron_kernel.fused_kron_chain_scatter_plain, opf, sched,
                              shape_c[mode])
        yf = synced(fused())
        k34["max_abs_err"] = max(k34["max_abs_err"], compare(
            f"fused_kron_chain_scatter f64 tenant C mode {mode}", "fp64", yf, fused_plain(),
            n_terms))
        compare(f"fused_kron_chain_scatter f64 tenant C mode {mode} against kernels 3 and 4",
                "fp64", yf, unfused_y.pop(mode), n_terms)
        check(torch.equal(yf, synced(fused())),
              f"fused_kron_chain_scatter f64 tenant C mode {mode} differs between two calls")
        r, v = ops._gathered_block_rows(coo_c.indices, coo_c.values, fs, mode, sched, 4)
        ones = torch.ones_like(v)
        c1 = synced(kron_kernel.kron_contrib(r[0], r[1], v))
        c2 = synced(kron_kernel.kron_contrib(c1, r[2], ones))
        k3["max_abs_err"] = max(k3["max_abs_err"], compare(
            f"kron_contrib f64 tenant C mode {mode} (both links)", "fp64", c2,
            kron_kernel.kron_contrib_plain(kron_kernel.kron_contrib_plain(r[0], r[1], v), r[2],
                                           ones), 1))
        y = synced(kron_kernel.scatter_rows(c2, sched, shape_c[mode]))
        k4["max_abs_err"] = max(k4["max_abs_err"], compare(
            f"scatter_rows f64 tenant C mode {mode}", "fp64", y,
            kron_kernel.scatter_rows_plain(c2, sched, shape_c[mode]), n_terms))

        def chain():
            return kron_kernel.kron_contrib(kron_kernel.kron_contrib(r[0], r[1], v), r[2], ones)

        def chain_plain_():
            return kron_kernel.kron_contrib_plain(
                kron_kernel.kron_contrib_plain(r[0], r[1], v), r[2], ones)

        def chain_lib():
            ab = torch.einsum("ti,tj->tij", r[0], r[1]).reshape(v.shape[0], -1) * v[:, None]
            return torch.einsum("ti,tj->tij", ab, r[2]).reshape(v.shape[0], -1)

        def scatter_lib():
            return torch.zeros((sched.n_row_blocks * sched.bi, c2.shape[1]), dtype=c2.dtype,
                               device=c2.device).index_add_(0, slots, c2)

        from repro_torch.sparse.layout import slot_rows

        slots = slot_rows(sched)
        n = v.shape[0]
        kk = [x.shape[1] for x in r]
        b3 = 8 * n * (sum(kk) + 1 + kk[0] * kk[1] * 2 + kk[0] * kk[1] * kk[2])
        b4 = 8 * n * c2.shape[1] + 4 * n + 8 * shape_c[mode] * c2.shape[1]
        b34, f34 = chain_scatter_work(sched, opf, shape_c[mode], nnz_c, elem=8)
        lib3, lib4 = time_ms(chain_lib, reps=3), time_ms(scatter_lib, reps=3)
        for acc, kern, plain, lib_ms, nbytes, flops in (
                (k34, fused, fused_plain, lib3 + lib4, b34, f34),
                (k3, chain, chain_plain_, lib3, b3,
                 kron_contrib_flops(n, kk[0], kk[1])
                 + kron_contrib_flops(n, kk[0] * kk[1], kk[2], scaled=False)),
                (k4, partial(kron_kernel.scatter_rows, c2, sched, shape_c[mode]),
                 partial(kron_kernel.scatter_rows_plain, c2, sched, shape_c[mode]),
                 lib4, b4, n * c2.shape[1])):
            acc["ms"] += time_ms(kern)
            acc["plain_ms"] += time_ms(plain, reps=3)
            acc["library_ms"] += lib_ms
            acc["bound_ms"] += bound(nbytes, flops, PEAK_F64_FLOPS)[0]
            acc["f64_core_bound_ms"] += bound(nbytes, flops, PEAK_F64_CORE_FLOPS)[0]
            acc["bound_by"] = bound(nbytes, flops, PEAK_F64_FLOPS)[1]
        del c1, c2, y, yf
    check(unfused["launches"] == {"kron_contrib": 8, "scatter_rows": 4},
          f"15d: the unfused unfoldings launched {unfused['launches']}")
    log(f"  15d tenant C in f64, 4 modes, ms a sweep: the chain kernel {k34['ms']:.3f} (plain "
        f"{k34['plain_ms']:.3f}, library {k34['library_ms']:.3f}, bound {k34['bound_ms']:.4f}); "
        f"kernels 3 (both links) and 4 {k3['ms']:.3f} / {k4['ms']:.3f}, plain "
        f"{k3['plain_ms']:.3f} / {k4['plain_ms']:.3f}, library {k3['library_ms']:.3f} / "
        f"{k4['library_ms']:.3f}, bound {k3['bound_ms']:.4f} / {k4['bound_ms']:.4f}")
    rows["fused_kron_chain_scatter_f64"] = {
        "name": "fused_kron_chain_scatter_f64", "route": "cuda",
        "source": src + "kron_chain_scatter.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:74",
        "also_replaces": "src/repro/kernels/kron_kernel.py:207",
        "launches": want_c["fused_kron_chain_scatter"],
        "device_ms": device_ms_c["fused_kron_chain_scatter"],
        "library": "torch.einsum x 2 + index_add_", **k34}
    rows["kron_contrib_f64"] = {"name": "kron_contrib_f64", "route": "cuda",
                                "source": src + "kron_contrib.cu",
                                "replaces": "src/repro/kernels/kron_kernel.py:74",
                                "launches": unfused["launches"]["kron_contrib"],
                                "path": "fused=False",
                                "device_ms": unfused["device_ms"]["kron_contrib"], **k3}
    rows["scatter_rows_f64"] = {"name": "scatter_rows_f64", "route": "cuda",
                                "source": src + "scatter_rows.cu",
                                "replaces": "src/repro/kernels/kron_kernel.py:207",
                                "launches": unfused["launches"]["scatter_rows"],
                                "path": "fused=False",
                                "device_ms": unfused["device_ms"]["scatter_rows"], **k4}
    out["15d"] = {"shape": shape_c, "nnz": nnz_c, "chain_kernel": k34, "kernel3": k3,
                  "kernel4": k4, "unfused_unfoldings": unfused,
                  "fit_history": cu.fit_history.tolist()}
    del coo_c, plan_c, cu, fs
    release_memory()

    # 15e: Table II's rank-16 tensor in f64 without its 1e-9 noise (which
    # sets an error floor of ~1e-9 sqrt(800^3) / ||X|| = 3.5e-7 at 800^3):
    # the error left is the arithmetic's, ~1e-7 in f32, ~1e-15 in f64
    t0 = time.perf_counter()
    x = table2_tensor(cfg["table2"], dev, dtype=torch.float64, noise=False)
    table2 = {"size": cfg["table2"], "build_s": time.perf_counter() - t0, "noise": 0.0}
    for method in METHODS:
        plan = tucker.plan(tucker.spec_for(x, (TABLE2_RANK,) * 3, n_iter=3, method=method),
                           device=dev)
        torch.cuda.reset_peak_memory_stats()
        res = plan(x)
        torch.cuda.synchronize()
        ms = [m / 3 for m in warm_ms(lambda: plan(x))]
        err = dense_error64(x, res.core, res.factors)
        table2[method] = {"rel_error_dense_f64": err, "rel_error": res.rel_error,
                          "sweep_ms": float(np.median(ms)), "sweep_ms_runs": ms,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  15e Table II {cfg['table2']}^3 rank 16 in f64 {method}: dense error "
            f"{err:.3e} <= 1e-10 (fit {res.rel_error:.3e}); {table2[method]['sweep_ms']:.2f} "
            f"ms a sweep")
        check(res.core.dtype == torch.float64 and 0.0 <= err <= 1e-10,
              f"15e {method}: dense error {err}")
    out["15e"] = table2
    del x, plan, res
    release_memory()

    # 15f: one service flush of f64 tenant-A requests, against each alone
    import repro_torch.obs as obs
    from repro_torch.serve import ServiceConfig, TuckerService

    _, shape_a, ranks_a, method_a, sweeps_a, _, (lo, hi) = cfg["service"]
    spec_a = tucker.TuckerSpec(shape_a, ranks_a, method=method_a, n_iter=sweeps_a,
                               dtype="float64")
    rng = np.random.default_rng(1500)
    reqs = []
    for i in range(cfg["flush"]):
        idx, vals = synthetic(dev, shape_a, int(rng.integers(lo, hi + 1)), 15_000 + i, "uniform")
        reqs.append((SparseCOO(idx, vals.double(), shape_a), 15_000 + i))
    alone = [tucker.plan(spec_a, device=dev)(c, generator=torch.Generator().manual_seed(s))
             for c, s in reqs]
    obs.tracer.clear()
    obs.configure(enabled=True)
    try:
        with TuckerService(ServiceConfig(max_batch=cfg["flush"], max_wait_ms=60_000.0,
                                         device=str(dev))) as svc:
            tickets = [svc.submit_coo(c, spec_a, generator=torch.Generator().manual_seed(s))
                       for c, s in reqs]
            t0 = time.perf_counter()
            svc.flush()
            served = [t.result(timeout=600) for t in tickets]
            flush_s = time.perf_counter() - t0
        spans = [e for e in obs.tracer.events()
                 if e.name == "sweep.dispatch" and e.attrs.get("program") == "batched"]
    finally:
        obs.configure(enabled=False)
    check(len(spans) == 1 and sum(r.dispatches for r in served) == 1,
          f"15f: {len(spans)} batched dispatches for one flush")
    gaps = []
    for (c, _), got, want in zip(reqs, served, alone):
        x2 = xnorm2_of(c)
        gaps.append((abs(fit64(got, x2) - fit64(want, x2)),
                     float(np.abs(got.fit_history - want.fit_history).max()),
                     max(projector_gap(a, b) for a, b in zip(got.factors, want.factors))))
    worst = tuple(max(g[i] for g in gaps) for i in range(3))
    log(f"  15f one flush of {len(reqs)} f64 requests {shape_a}: {flush_s * 1e3:.1f} ms, "
        f"launches {spans[0].attrs['launches']}; worst against each alone: f64 fit "
        f"{worst[0]:.3e} <= {F64_FIT_TOL:g} (f32 history {worst[1]:.3e} <= "
        f"{F32_HISTORY_ULPS:.3g}), projectors {worst[2]:.3e} <= {F64_PROJ_TOL:g}")
    check(worst[0] <= F64_FIT_TOL and worst[1] <= F32_HISTORY_ULPS
          and worst[2] <= F64_PROJ_TOL, "15f: a served f64 request is not its run alone")
    check(all(r.core.dtype == torch.float64 for r in served), "15f: a result is not float64")
    out["15f"] = {"requests": len(reqs), "flush_ms": flush_s * 1e3,
                  "launches": spans[0].attrs["launches"], "fit64_gap": worst[0],
                  "history_gap": worst[1], "projector_gap": worst[2]}
    del reqs, alone, served
    release_memory()
    print(json.dumps(out), flush=True)
    return rows


def phase15g_kernel5_f64(dev, cfg: dict, coo, split_plan, split_res, f0):
    """15g, kernel 5 in f64: at odd shapes against its f64 plain version,
    every mode, the same bits twice; at NELL-2's last mode (``coo``, 15b's
    f64 tensor, and 15b's factors) against its plain version and the split
    f64 core update (kernel 1 f64, then kernel 2 f64), the same bits twice,
    timed beside both; 15b's run again with ``fuse_core=True``
    (``split_plan``'s spec on a fused engine, from ``f0``), held to 15b's
    split run ``split_res`` (f64 fit 1e-10, projectors and core 1e-8); one
    autotune search in f64 that times the fused layout beside the split one.
    Returns (the kernels line's row, the phase's report)."""
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    import tempfile

    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import kron_kernel, ttm_kernel

    on_card = dev.type == "cuda"
    rep = {}
    rng = np.random.default_rng(SEED + 157)
    t0 = time.perf_counter()
    for shape, ranks, nnz in cfg.get("kernel5_cases", KERNEL5_F64_CASES):
        idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
        idx = np.concatenate([idx, idx[:nnz // 5]])  # duplicate coordinates
        c = SparseCOO.from_parts(idx.astype(np.int32), rng.standard_normal(idx.shape[0]),
                                 shape, device=dev)
        fs = [torch.tensor(np.linalg.qr(rng.standard_normal((s, r)))[0], device=dev)
              for s, r in zip(shape, ranks)]
        for mode in range(len(shape)):
            sched = schedule_of(c, mode)
            fa, fb = kron_factors(fs, mode)
            kern = partial(kron_kernel.fused_kron_scatter_ttm, fa, fb, fs[mode], sched,
                           shape[mode])
            got = synced(kern())
            compare(f"fused_kron_scatter_ttm f64 {shape} ranks {ranks} mode {mode}", "fp64",
                    got, synced(kron_kernel.fused_kron_scatter_ttm_plain(
                        fa, fb, fs[mode], sched, shape[mode])), c.nnz)
            check(torch.equal(got, synced(kern())),
                  f"kernel 5 f64 {shape} mode {mode}: two calls differ")
    rep["odd_shapes_s"] = time.perf_counter() - t0

    # NELL-2's last mode: kernel 5 f64 against its plain version and the
    # split f64 core update
    shape, mode = cfg["shape"], len(cfg["shape"]) - 1
    fs = [f.contiguous() for f in split_res.factors]
    sched = split_plan.engine.device_schedule(coo, mode)
    fa, fb = kron_factors(fs, mode)
    u, n_rows = fs[mode], shape[mode]
    ra, rb, r = fa.shape[1], fb.shape[1], u.shape[1]
    k = ra * rb
    grid = kron_kernel.mega_grid(dev, ra, rb, kron_kernel._padded_factor(fa).shape[1],
                                 kron_kernel._padded_factor(fb).shape[1], r, 2,
                                 int(sched.parts.numel()) - 1) if on_card else {}
    kern = partial(kron_kernel.fused_kron_scatter_ttm, fa, fb, u, sched, n_rows)
    plain = partial(kron_kernel.fused_kron_scatter_ttm_plain, fa, fb, u, sched, n_rows)

    def split():
        return ttm_kernel.ttm(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows).T, u.T).T

    got = synced(kern())
    check(got.dtype == torch.float64, f"15g: kernel 5 returned {got.dtype}")
    err = compare(f"fused_kron_scatter_ttm f64 NELL-2 mode {mode}", "fp64", got,
                  synced(plain()), cfg["nnz"])
    compare("fused_kron_scatter_ttm f64 NELL-2 against the split f64 core update (kernels "
            "1 and 2 in f64)", "fp64", got, synced(split()), cfg["nnz"])
    check(torch.equal(got, synced(kern())), "15g: kernel 5 f64 at NELL-2 differs between two "
          "calls")
    visited = int(torch.unique(coo.indices[:, mode]).numel())
    nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts, fa, fb,
                        u) + r * k * 8)
    flops = kron_scatter_flops(coo.nnz, ra, k) + 2 * visited * r * k
    k5 = {"ms": time_ms(kern, reps=3), "plain_ms": time_ms(plain, reps=1),
          "split_ms": time_ms(split, reps=3),
          "bound_ms": bound(nbytes, flops, PEAK_F64_FLOPS)[0],
          "bound_by": bound(nbytes, flops, PEAK_F64_FLOPS)[1],
          "f64_core_bound_ms": bound(nbytes, flops, PEAK_F64_CORE_FLOPS)[0],
          "bytes": nbytes, "flops": flops, "max_abs_err": err, "grid": grid}
    log(f"  15g kernel 5 f64 at NELL-2 mode {mode}: {k5['ms']:.3f} ms (split f64 core update "
        f"{k5['split_ms']:.3f}, plain {k5['plain_ms']:.1f}), bound {k5['bound_ms']:.4f} "
        f"({k5['bound_by']}), {k5['f64_core_bound_ms']:.4f} at the CUDA-core rate; grid {grid}")
    del got
    release_memory()

    # 15b's tensor with fuse_core=True, held to 15b's split f64 run
    fplan = tucker.plan(split_plan.spec, device=dev,
                        engine=make_engine("cuda" if on_card else "torch", dev, fuse_core=True))
    reset_launches()
    fres = fplan(coo, factors_init=f0)
    torch.cuda.synchronize()
    launches = read_launches()
    n_iter = split_plan.spec.n_iter
    want = {"fused_kron_scatter": 3 * n_iter, "ttm": 0, "kron_contrib": 0, "scatter_rows": 0,
            "fused_kron_scatter_ttm": n_iter, "fused_kron_chain_scatter": 0, **NO_LM_LAUNCHES}
    check(launches == want or not on_card, f"15g: fuse_core f64 launches {launches}, want {want}")
    check(fres.core.dtype == torch.float64, "15g: the fused core is not float64")
    x2 = xnorm2_of(coo)
    fit_gap = abs(fit64(fres, x2) - fit64(split_res, x2))
    proj = max(projector_gap(a, b) for a, b in zip(fres.factors, split_res.factors))
    cg, cscale = core_gap(fres, split_res)
    log(f"  15g NELL-2 in f64 with fuse_core: launches {launches}; against 15b's split run: "
        f"f64 fit {fit_gap:.3e} <= {F64_FIT_TOL:g}, projectors {proj:.3e} <= "
        f"{F64_PROJ_TOL:g}, core {cg:.3e} <= {F64_PROJ_TOL:g} x {cscale:.3e}")
    check(fit_gap <= F64_FIT_TOL and proj <= F64_PROJ_TOL and cg <= F64_PROJ_TOL * cscale,
          "15g: fuse_core in f64 disagrees with the split f64 run")
    turns = []
    for name, p in (("split", split_plan), ("fused", fplan), ("fused", fplan),
                    ("split", split_plan)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p(coo, factors_init=f0)
        end.record()
        end.synchronize()
        turns.append((name, start.elapsed_time(end) / n_iter))
    prof = profile_run(lambda: fplan(coo, factors_init=f0))
    k5["device_ms"] = prof["kernel_ms"]["fused_kron_scatter_ttm"] / n_iter
    log("  15g warm ms a sweep, in turns: " + ", ".join(f"{n} {ms:.2f}" for n, ms in turns))
    rep.update(kernel5_nell2=k5, launches=launches, turns=turns, fit64_gap=fit_gap,
               projector_gap=proj, core_gap_over_scale=cg / cscale,
               profile_warm_run=prof)
    del fplan, fres
    release_memory()

    # one autotune search in f64: the fused layout timed beside the split one
    at.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        cands = at.candidate_configs(shape, cfg["ranks"], cfg["nnz"], dtype="float64",
                                     device=dev)
        split_c = next(c for c in cands if c.layout == "split")
        fused_c = next(c for c in cands if c.layout == "fused")
        problem = {}
        trials = {}
        for c in (split_c, fused_c):
            trials[c.layout] = {"config": c._asdict(), "ms": at.trial_time_ms(
                c, shape, cfg["ranks"], cfg["nnz"], dtype="float64", device=dev,
                problem=problem)}
        del problem
        pick = at.autotune(shape, cfg["ranks"], cfg["nnz"], dtype="float64", device=dev,
                           table=at.TuningTable(os.path.join(tmp, "table.json")))
    counters = dict(at.COUNTERS)
    log(f"  15g autotune in f64: {len(cands)} candidates, fused {trials['fused']} against "
        f"split {trials['split']} ms a trial sweep; the search's pick {pick}, counters "
        f"{counters}")
    check(counters["searches"] == 1 and counters["trials"] >= 1, f"15g: counters {counters}")
    rep.update(autotune={"candidates": len(cands), "trials": trials, "pick": pick._asdict(),
                         "counters": counters})
    row = {"name": "fused_kron_scatter_ttm_f64", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kron_scatter_ttm.cu",
           "replaces": "src/repro/kernels/kron_kernel.py:428",
           "launches": launches["fused_kron_scatter_ttm"], "path": "fuse_core=True, f64",
           "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
           "device_ms": k5["device_ms"], "bound_ms": k5["bound_ms"],
           "bound_by": k5["bound_by"], "f64_core_bound_ms": k5["f64_core_bound_ms"],
           "split_f64_ms": k5["split_ms"],
           # no single PyTorch call builds Y from the nonzeros and contracts it
           "library_ms": None}
    return row, rep


# -- phase 16: Kron reuse on the torch engine -----------------------------------

REUSE_TOL = 1e-6  # 16: the trick's exactness, one call a mode, x max|plain|


@contextlib.contextmanager
def deterministic():
    """Every scatter in its deterministic version (``index_add_`` among
    them), and an error for any operation that has none: the reuse chain
    and the plain chain then sum the same terms in the same order and agree
    to their bits; without it the card's atomics reorder each unfolding's
    sums from run to run."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def aligned_core_gap(got, want) -> float:
    """max |core difference| / max|want's core| after ``got``'s factor
    columns are matched to ``want``'s: by sign (exact), or where QRP pivots
    tie and the columns come in another order, by taking ``got``'s core into
    ``want``'s basis, G x_n (U_want,n^T U_got,n), in f64 (its own rounding
    is that of the factors' orthonormality, ~1e-7 in f32); the smaller."""
    from repro_torch.core.ttm import ttm

    sign_gap, scale = core_gap(got, want)
    core = got.core.double()
    for n, (a, b) in enumerate(zip(got.factors, want.factors)):
        core = ttm(core, b.double().T @ a.double(), n)
    basis_gap = float((core - want.core.double()).abs().max())
    return min(sign_gap, basis_gap) / scale


def reuse_chain_checks(name, coo, plan, res) -> list:
    """16's one-call checks of the paper's trick, per mode, on a reuse
    run's factors: the reuse chain against ``core.kron.sparse_ttm_chain``
    (the reference's XLA chain without reuse, in torch ops) with
    deterministic scatters within REUSE_TOL x max|plain| (the same terms in
    the same order: the same bits), and with the card's atomic scatters, as
    the timed runs sum, within the fp32 rule (sum order); each chain's ms."""
    from repro_torch.core.kron import sparse_ttm_chain, sparse_ttm_chain_reuse_device

    fs = [f.contiguous() for f in res.factors]
    rows = []
    for mode in range(coo.ndim):
        sched = plan.engine.device_schedule(coo, mode)
        reuse = partial(sparse_ttm_chain_reuse_device, coo.indices, coo.values, fs, mode,
                        sched, shape=tuple(coo.shape))
        plain = partial(sparse_ttm_chain, coo, fs, mode)
        with deterministic():
            got, want = synced(reuse()), synced(plain())
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        same_bits = torch.equal(got, want)
        log(f"  16 {name} mode {mode}: reuse chain against the plain chain, deterministic "
            f"scatters: max_abs_err {err:.3e} <= {REUSE_TOL:g} x {scale:.3e} (the same bits: "
            f"{same_bits})")
        check(err <= REUSE_TOL * scale, f"16 {name} mode {mode}: the reuse chain is not exact")
        del got, want
        atomic_err = compare(f"16 {name} mode {mode} reuse chain, atomic scatters", "fp32",
                             synced(reuse()), synced(plain()), max_row_count(coo, mode))
        rows.append({"max_abs_err_deterministic": err, "same_bits": same_bits,
                     "max_abs_err_atomic": atomic_err, "reuse_ms": time_ms(reuse),
                     "plain_ms": time_ms(plain)})
    return rows


def phase16_kron_reuse(dev, card: str, cfg: Optional[dict] = None) -> None:
    """The paper's Kron reuse (Sec. III-C) on the torch engine, the twin of
    the reference's XLA engine, on the card: the four Table V tensors and
    tenant C's shape, each run with ``use_kron_reuse`` on ``engine="torch"``
    (torch ops alone: no kernel launches) and on the kernel path
    (``engine="auto"``: ``cuda`` on the card), from the same initial
    factors. Per mode: the share of distinct Kron rows and the one-call
    checks of ``reuse_chain_checks``. Per run: ms a sweep and the peak both
    ways; one timed reuse run against the kernel path's by phase 3's rule
    (two implementations that sum in different orders): fit 1e-4, factor
    projectors and the aligned core (``aligned_core_gap``) 1e-3. ``engine="cuda"`` with
    reuse ignores it: the bits of the run without. ``cfg`` shrinks tenant C
    for a rehearsal on the CPU."""
    import dataclasses

    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.sparse.datasets import PAPER_DATASETS

    cfg = {"tenant_c": TENANT_C, **(cfg or {})}
    tf32_off()
    log("phase 16: Kron reuse on the torch engine (Table V, tenant C), against the plain "
        "torch chain and the kernel path; cuda ignores it")
    tensors = []
    for name, ds in PAPER_DATASETS.items():
        coo = ds.build(device=dev)
        tensors.append((name, coo, tucker.spec_for(coo, ds.ranks, n_iter=ds.n_iter,
                                                   method="householder")))
    shape_c, nnz_c, ranks_c, method_c = cfg["tenant_c"]
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    coo = SparseCOO.from_parts(idx, vals, shape_c)
    tensors.append(("tenant_c", coo, tucker.TuckerSpec(shape_c, ranks_c, method=method_c,
                                                       n_iter=3)))
    out = {"phase": "16 Kron reuse", "card": card, "tensors": {}}
    for name, coo, spec in tensors:
        row = {"shape": coo.shape, "nnz": coo.nnz}
        runs = {}
        for key, engine, reuse in (("reuse", "torch", True), ("kernels", "auto", False)):
            release_memory()
            plan = tucker.plan(dataclasses.replace(spec, engine=engine, use_kron_reuse=reuse),
                               device=dev)
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launches()
            cold = plan(coo)
            torch.cuda.synchronize()
            launches = {k: v for k, v in read_launches().items() if v}
            timed = []
            ms = [m / spec.n_iter for m in warm_ms(lambda: timed.append(plan(coo)))]
            row[key] = {"sweep_ms": float(np.median(ms)), "sweep_ms_runs": ms,
                        "peak_above_resident_gb": (torch.cuda.max_memory_allocated()
                                                   - resident) / 1e9,
                        "schedule_builds_cold": cold.schedule_builds, "launches": launches}
            check(reuse or dev.type != "cuda" or launches.get("ttm"),
                  f"16 {name}: the kernel path launched {launches}")
            if reuse:
                check(not launches and cold.engine == "torch", f"16 {name}: the torch engine "
                      f"launched {launches}")
                check(sorted(plan.engine.kron_plans) == list(range(coo.ndim)),
                      f"16 {name}: the reuse path did not run")
                row["unique_share_by_mode"] = [
                    int(plan.engine.kron_plans[m].unique_indices.shape[0]) / coo.nnz
                    for m in range(coo.ndim)]
                row["modes"] = reuse_chain_checks(name, coo, plan, timed[-1])
            runs[key] = timed[-1]
            del cold, timed, plan
        # phase 3's rule for two implementations that sum in different
        # orders (an f32 fit near 0.1 moves ~1e-6 with the core's last bits:
        # the angiogram's read 1.3e-6 on an H100), the core aligned as phase 10 aligns
        # the matmul tensor's (its QRP pivots tie, so the columns may come in
        # another order)
        got, want = runs["reuse"], runs["kernels"]
        fit_gap = float(np.abs(got.fit_history - want.fit_history).max())
        proj_gap = max(projector_gap(a, b) for a, b in zip(got.factors, want.factors))
        core_gap_ = aligned_core_gap(got, want)
        row.update(fit_gap=fit_gap, projector_gap=proj_gap, core_gap_over_scale=core_gap_)
        log(f"  16 {name} a timed reuse run against the kernel path: fit {fit_gap:.3e} <= "
            f"1e-4, projectors {proj_gap:.3e} <= 1e-3, core {core_gap_:.3e} <= 1e-3 "
            f"x max|core| (aligned)")
        check(got.fit_history.shape == want.fit_history.shape and fit_gap <= 1e-4
              and proj_gap <= 1e-3 and core_gap_ <= 1e-3,
              f"16 {name}: the reuse run disagrees with the kernel path's")
        # cuda ignores the flag: the bits of the cuda run without it (a
        # rehearsal on the CPU has no cuda engine)
        same = None
        if dev.type == "cuda":
            cuda = tucker.plan(dataclasses.replace(spec, engine="cuda", use_kron_reuse=True),
                               device=dev)(coo)
            want = runs["kernels"]
            same = (np.array_equal(cuda.fit_history, want.fit_history)
                    and torch.equal(cuda.core, want.core)
                    and all(torch.equal(a, b) for a, b in zip(cuda.factors, want.factors)))
            del cuda
        row["cuda_reuse_same_bits"] = same
        log(f"  16 {name} {coo.shape} {coo.nnz} nnz: distinct Kron rows / nnz by mode "
            + ", ".join(f"{u:.4f}" for u in row["unique_share_by_mode"])
            + "; one unfolding reuse / plain chain ms by mode "
            + ", ".join(f"{m['reuse_ms']:.3f} / {m['plain_ms']:.3f}" for m in row["modes"])
            + f"; ms a sweep reuse {row['reuse']['sweep_ms']:.3f}, kernel path "
            f"{row['kernels']['sweep_ms']:.3f}; peak above the tensor "
            f"{row['reuse']['peak_above_resident_gb']:.4f} / "
            f"{row['kernels']['peak_above_resident_gb']:.4f} GB; cuda with reuse gives its "
            f"bits without: {same}")
        check(same is not False, f"16 {name}: engine='cuda' with use_kron_reuse changed the bits")
        out["tensors"][name] = row
        del runs
    del tensors
    release_memory()
    print(json.dumps(out), flush=True)


# -- phase 17: the sharded service across 4 ranks ------------------------------

SERVICE_SHARD_WORLD = 4
SERVICE_SHARD_TENANTS = ("A", "C")  # phase 12's tenants A and C
# their first 16 and 4 requests (cut from 64 and 16, then from 32 and 8: the
# time limit)
SERVICE_SHARD_REQUESTS = {"A": 16, "C": 4}


def service_shard_requests(dev, cfg: dict) -> list:
    """Phase 12's requests of tenants A and C (the same seeds), each
    (tenant index, COO on ``dev``, generator seed)."""
    from repro_torch.core.coo import SparseCOO

    reqs = []
    for t, (name, shape, _, _, _, n_req, (lo, hi)) in enumerate(cfg["tenants"]):
        if name not in SERVICE_SHARD_TENANTS:
            continue
        rng = np.random.default_rng(1200 + t)
        for i in range(n_req):
            seed = 12_000 + 1000 * t + i
            idx, vals = synthetic(dev, shape, int(rng.integers(lo, hi + 1)), seed, "uniform")
            reqs.append((t, SparseCOO.from_parts(idx, vals, shape), seed))
    return reqs


def serve_requests(svc, specs, reqs, threads: int) -> dict:
    """Submit ``reqs`` from ``threads`` threads (tenant groups in turns, as
    phase 12) and wait for every result: the results in request order, the
    burst's seconds and each request's end-to-end ms."""
    import threading

    per_thread = [list(range(len(reqs)))[th::threads] for th in range(threads)]
    tickets, errors = [None] * len(reqs), []
    barrier = threading.Barrier(threads + 1)

    def submitter(th):
        barrier.wait(60)
        try:
            for i in per_thread[th]:
                t, coo, seed = reqs[i]
                tickets[i] = svc.submit_coo(coo, specs[t],
                                            generator=torch.Generator().manual_seed(seed))
        except Exception as exc:  # reported below: the phase fails
            errors.append(exc)

    workers = [threading.Thread(target=submitter, args=(th,)) for th in range(threads)]
    for w in workers:
        w.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for w in workers:
        w.join(600)
    check(not errors and not any(w.is_alive() for w in workers), f"submitters failed: {errors}")
    results = [tk.result(timeout=SHARD_TIMEOUT_S) for tk in tickets]
    return {"results": results, "seconds": time.perf_counter() - t0,
            "total_ms": [r.timing.total_ms for r in results]}


def _service_specs(cfg: dict) -> list:
    from repro_torch import tucker

    return [tucker.TuckerSpec(shape, ranks, method=method, n_iter=sweeps)
            for _, shape, ranks, method, sweeps, _, _ in cfg["tenants"]]


def _shard_job_service(rank, world, dev, tmp, cfg) -> dict:
    """17: rank 0 serves phase 12's tenants A and C through
    ``TuckerService(ServiceConfig(shard=ShardSpec(world)))`` from 4
    submitting threads; the other ranks follow (``serve_follower``) until
    rank 0's ``close()``. Each rank's kernel launches, counted from just
    before it serves or follows to just after the stop."""
    import repro_torch.obs as obs
    from repro_torch import tucker
    from repro_torch.serve import ServiceConfig, TuckerService, serve_follower

    svc_cfg = ServiceConfig(shard=tucker.ShardSpec(world), max_batch=SERVICE_MAX_BATCH,
                            max_wait_ms=5.0, max_inflight_flushes=2, device=str(dev))
    if rank != 0:
        reset_launches()
        serve_follower(svc_cfg)
        _shard_sync(dev)
        return {"returned": True, "launches": read_launches()}
    reqs = service_shard_requests(dev, cfg)
    _shard_sync(dev)
    obs.tracer.clear()
    obs.configure(enabled=True)
    try:
        reset_launches()
        svc = TuckerService(svc_cfg)
        served = serve_requests(svc, _service_specs(cfg), reqs, SERVICE_THREADS)
        svc.close()
        _shard_sync(dev)
        launches = read_launches()
        snap = svc.metrics.snapshot()
        announces = [(e.attrs["announce_bytes"], e.attrs["announce_ms"], e.attrs["batch_size"])
                     for e in obs.tracer.events()
                     if e.name == "serve.dispatch" and "announce_bytes" in e.attrs]
    finally:
        obs.configure(enabled=False)
    return {"returned": True, "launches": launches, "seconds": served["seconds"],
            "total_ms": served["total_ms"],
            "results": [_shard_result(r, {}) for r in served["results"]],
            "dispatches": snap["dispatches"], "announces": announces}


SHARD_JOBS["service"] = _shard_job_service


def phase17_sharded_service(dev, card: str, cfg: Optional[dict] = None) -> None:
    """The service across ranks: 4 gloo ranks sharing the card, rank 0
    serving phase 12's tenants A and C (their first 16 and 4 requests,
    ``SERVICE_SHARD_REQUESTS``) from 4 threads
    into 2 executors, the others following; every result within phase
    14b's tolerances of the same request served by a world-of-one service
    here, every rank back from ``close()``; requests/s, p50 / p99, and the
    announces' bytes and ms a request. Overhead figures (4 processes time-
    share one card and gloo stages through the host), not scaling. ``cfg``
    shrinks the tenants for a rehearsal on the CPU."""
    import shutil
    import tempfile

    from repro_torch import tucker
    from repro_torch.serve import ServiceConfig, TuckerService

    tenants = tuple(t[:5] + (SERVICE_SHARD_REQUESTS.get(t[0], t[5]),) + t[6:]
                    for t in SERVICE_TENANTS)
    cfg = {"device": str(dev), "tenants": tenants, **(cfg or {})}
    release_memory()
    log(f"phase 17: TuckerService(shard=ShardSpec({SERVICE_SHARD_WORLD})) across "
        f"{SERVICE_SHARD_WORLD} gloo ranks sharing the card, tenants {SERVICE_SHARD_TENANTS}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    try:
        t0 = time.perf_counter()
        ranks = run_ranks("service", SERVICE_SHARD_WORLD, "gloo", tmp, cfg)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(r["returned"] for r in ranks), "17: a follower did not return after close()")
    r0 = ranks[0]
    # the same requests through a world-of-one service, here
    reqs = service_shard_requests(dev, cfg)
    with TuckerService(ServiceConfig(shard=tucker.ShardSpec(1), max_batch=SERVICE_MAX_BATCH,
                                     max_wait_ms=5.0, device=str(dev))) as svc:
        one = serve_requests(svc, _service_specs(cfg), reqs, SERVICE_THREADS)
    check(len(r0["results"]) == len(reqs), f"17: {len(r0['results'])} results for "
          f"{len(reqs)} requests")
    worst = {"fit_gap": 0.0, "projector_gap": 0.0, "core_gap_over_scale": 0.0}
    for got, want in zip(r0["results"], one["results"]):
        fit, factors, core = host_copy(want)
        gaps = within_phase3_tolerances("17 a request against the world of one",
                                        _as_run(got, dev), fit, factors, core)
        worst = {k: max(worst[k], gaps[k]) for k in worst}
    n = len(reqs)
    lat = np.asarray(r0["total_ms"])
    # one announce a flush, for all its requests; a sharded request is one dispatch
    ann_bytes = sum(b for b, _, _ in r0["announces"])
    ann_ms = [m for _, m, _ in r0["announces"]]
    check(sum(k for _, _, k in r0["announces"]) == r0["dispatches"] == n,
          f"17: announces for {sum(k for _, _, k in r0['announces'])} requests, "
          f"{r0['dispatches']} dispatches, {n} requests")
    # every rank ran each request's sweeps through the kernels on its slice:
    # kernel 1 a mode (3-way, tenant A) or kernels 3 and 4 (4-way, C), and
    # kernel 2 once, a sweep (on the card; a rehearsal on the CPU launches none)
    want = {}
    for r in r0["results"]:
        for k, v in single_run_launches(r["core"].dim()).items():
            want[k] = want.get(k, 0) + v * len(r["fit"])
    launches = [{k: v for k, v in r["launches"].items() if v} for r in ranks]
    log(f"  17 launches by rank {launches}, each rank wants {want}")
    check(dev.type != "cuda" or all(got == want for got in launches),
          f"17: launches by rank {launches}, want {want} on every rank")
    out = {"phase": "17 sharded service", "card": card, "world": SERVICE_SHARD_WORLD,
           "requests": n, "spawn_and_serve_s": t_ranks,
           "requests_per_s": n / r0["seconds"], "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "world_of_one_requests_per_s": n / one["seconds"],
           "flushes": len(ann_ms), "announce_bytes_per_request": ann_bytes / n,
           "announce_ms_per_request": sum(ann_ms) / n,
           "announce_ms_max": float(np.max(ann_ms)), "vs_world_of_one": worst,
           "launches_by_rank": launches}
    log(f"  17: {n} requests across {SERVICE_SHARD_WORLD} ranks: {out['requests_per_s']:.2f} "
        f"requests/s (a world of one {out['world_of_one_requests_per_s']:.2f}), p50 "
        f"{out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms; an announce "
        f"{out['announce_bytes_per_request'] / 1e3:.1f} KB and "
        f"{out['announce_ms_per_request']:.2f} ms a request; worst against the world of one "
        f"{worst}; every follower returned")
    del reqs, one
    release_memory()
    print(json.dumps(out), flush=True)



# -- phase 18: the contract checks on the card -------------------------------------

LINT_WORLD = 2  # 18b: the sharded cells, gloo ranks sharing the card
NELL2_LINT_WARM_RUNS = 3


def item_engine(dev):
    """18d's seeded control: the kernel engine of ``dev`` with one
    ``.item()`` injected into each unfolding."""
    from repro_torch.core.engine import SweepEngine

    class ItemEngine(SweepEngine):
        def mode_unfolding(self, coo, factors, mode):
            y = super().mode_unfolding(coo, factors, mode)
            y.abs().max().item()
            return y

    return ItemEngine(name="cuda" if dev.type == "cuda" else "torch", device=dev)


def _lint_cells():
    from repro_torch.analysis import runner

    return runner.default_matrix()


def _shard_job_lint(rank, world, dev, tmp, cfg) -> dict:
    """18b: the matrix's sharded cells on this rank (every rank runs them,
    as every rank runs a sharded plan), on the card over gloo."""
    from repro_torch import analysis

    cells = [c for c in _lint_cells() if c.min_ranks > 1]
    report = analysis.run_matrix(cells, device=dev, baseline=analysis.Baseline.load(
        analysis.default_baseline_path()))
    _shard_sync(dev)
    return {"report": report.to_json()}


SHARD_JOBS["lint"] = _shard_job_lint


def _print_cells(label: str, report) -> None:
    for c in report.cells:
        if c.skipped is not None:
            log(f"  {label} SKIP {c.name}: {c.skipped}")
        else:
            log(f"  {label} {'ok  ' if not c.findings else 'FAIL'} {c.name} [{c.engine}]"
                + (f" ({c.suppressed} suppressed)" if c.suppressed else ""))
            for f in c.findings:
                log(f"    {f}")


def phase18_contracts(dev, card: str, ref4: dict, cfg: Optional[dict] = None) -> None:
    """The contract checks (``repro_torch.analysis``) on the card: 18a the
    lint matrix (every cell but the sharded ones, each under
    ``torch.cuda.set_sync_debug_mode``), 18b the sharded cells on 2 gloo
    ranks sharing the card, 18c ``TuckerPlan.lint`` and ``analyze`` on
    phase 4's NELL-2 plan (the tensor drawn anew, its checksum held to
    phase 4's) beside its warm sweep ms, and ``TuckerPlan.lint`` on tenant
    C's 4-way shape, whose sweeps run the chain kernel, 18d a seeded
    ``.item()`` in a sweep, which must be flagged. Any finding the port's baseline does not
    list fails the phase; the suppressed ones are printed with their
    reasons."""
    import shutil
    import tempfile

    from repro_torch import analysis, tucker
    from repro_torch.analysis import runner
    from repro_torch.core.coo import SparseCOO

    cfg = cfg or {"shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS,
                  "lint_world": LINT_WORLD}
    baseline = analysis.Baseline.load(analysis.default_baseline_path())
    log(f"phase 18: the contract checks on the card (baseline "
        f"{len(baseline.suppressions)} suppression(s))")
    for sup in baseline.suppressions:
        log(f"  suppressed: {sup.check} @ {sup.where} [{sup.match}]: {sup.reason}")

    # 18a: the matrix on the card; the sharded cells skip (a world of one)
    t0 = time.perf_counter()
    reset_launches()
    raw = analysis.run_matrix(device=dev)
    launches = read_launches()
    t_matrix = time.perf_counter() - t0
    kept, suppressed = baseline.filter(raw.findings)
    _print_cells("18a", raw)
    for c in raw.cells:
        if c.skipped is None and c.name != "plan-cache":
            want = ("torch" if c.name == "torch/scan/kron-reuse" or dev.type != "cuda"
                    else "cuda")
            check(c.engine == want, f"18a {c.name} ran on {c.engine}, want {want}")
    check(dev.type != "cuda" or (launches["fused_kron_scatter"] > 0 and launches["ttm"] > 0
                                 and launches["fused_kron_scatter_ttm"] > 0),
          f"18a: the matrix did not run kernels 1, 2 and 5 ({launches})")
    check(not kept, f"18a: {len(kept)} finding(s) the baseline does not list: "
          + "; ".join(str(f) for f in kept))
    skipped = [c.name for c in raw.cells if c.skipped is not None]
    check(sorted(skipped) == ["sharded/scan/fp32", "sharded/segment/fp32"],
          f"18a skipped {skipped}")

    # 18b: the sharded cells on gloo ranks sharing the card
    tmp = tempfile.mkdtemp(prefix="chip-smoke-lint-")
    try:
        t0 = time.perf_counter()
        ranks = run_ranks("lint", cfg["lint_world"], "gloo", tmp, {"device": str(dev)})
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sharded = []
    for r, out in enumerate(ranks):
        rep = out["report"]
        cells = {c["name"]: c for c in rep["cells"]}
        for name in ("sharded/scan/fp32", "sharded/segment/fp32"):
            c = cells[name]
            log(f"  18b rank {r} {name} [{c['engine']}]: {len(c['findings'])} finding(s), "
                f"{c['suppressed']} suppressed, skipped {c['skipped']}")
            check(c["skipped"] is None and c["engine"] == ("cuda" if dev.type == "cuda"
                                                           else "torch"),
                  f"18b rank {r}: {name} did not run on the card: {c}")
            sharded.append({"rank": r, "cell": name, "findings": c["findings"],
                            "suppressed": c["suppressed"]})
        check(rep["ok"], f"18b rank {r}: findings the baseline does not list: {rep}")

    # 18c: phase 4's plan on phase 4's tensor
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, cfg["shape"], cfg["nnz"], SEED, "uniform")
    coo = SparseCOO.from_parts(idx, vals, cfg["shape"])
    del idx, vals
    if ref4 is not None:
        check(coo_checksum(coo) == ref4["checksum"], "18c: phase 4's tensor drawn anew differs")
    plan = tucker.plan(tucker.TuckerSpec(shape=cfg["shape"], ranks=cfg["ranks"],
                                         n_iter=N_ITER), device=dev)
    plan(coo)  # builds the schedules
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    runs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(NELL2_LINT_WARM_RUNS):
        start.record()
        plan(coo)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / N_ITER)
    sweep_ms = float(np.median(runs))
    t0 = time.perf_counter()
    nell_raw = plan.lint(coo)
    t_lint = time.perf_counter() - t0
    nell_kept, nell_sup = baseline.filter(nell_raw)
    for f in nell_raw:
        log(f"  18c {'suppressed' if f in nell_sup else 'FINDING'}: {f}")
    check(not nell_kept, f"18c: NELL-2's lint has {len(nell_kept)} finding(s) the baseline "
          "does not list: " + "; ".join(str(f) for f in nell_kept))
    terms = plan.analyze(coo)
    achieved = {"modelled_gb_per_s": terms["hbm_bytes_per_sweep"] / (sweep_ms * 1e-3) / 1e9,
                "modelled_tflop_per_s": terms["dot_flops_per_sweep"] / (sweep_ms * 1e-3) / 1e12}
    achieved["hbm_share"] = achieved["modelled_gb_per_s"] * 1e9 / PEAK_BYTES_PER_S
    log(f"  18c NELL-2: lint {t_lint:.2f} s, {len(nell_raw)} finding(s) ({len(nell_sup)} "
        f"suppressed); analyze {json.dumps(terms)}; warm sweep {sweep_ms:.2f} ms "
        f"(phase 4: {RECORDED.get('phase4_sweep_ms')}): {json.dumps(achieved)}")
    check(terms["engine"] == ("cuda" if dev.type == "cuda" else "torch")
          and terms["program"] == "scan", f"18c analyze {terms}")
    del coo, plan
    release_memory()
    # ... and tenant C's 4-way shape: its sweeps on the chain kernel
    shape_c, nnz_c, ranks_c, method_c = cfg.get("tenant_c", TENANT_C)
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    coo_c = SparseCOO.from_parts(idx, vals, shape_c)
    del idx, vals
    plan_c = tucker.plan(tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER),
                         device=dev)
    reset_launches()
    four_raw = plan_c.lint(coo_c)
    four_launches = {k: v for k, v in read_launches().items() if v}
    four_kept, four_sup = baseline.filter(four_raw)
    for f in four_raw:
        log(f"  18c 4-way {'suppressed' if f in four_sup else 'FINDING'}: {f}")
    log(f"  18c 4-way {shape_c}: {len(four_raw)} finding(s) ({len(four_sup)} suppressed), "
        f"launches {four_launches}")
    check(not four_kept, f"18c: the 4-way lint has {len(four_kept)} finding(s) the baseline "
          "does not list: " + "; ".join(str(f) for f in four_kept))
    check(dev.type != "cuda" or four_launches.get("fused_kron_chain_scatter", 0) > 0,
          f"18c: the 4-way lint launched no chain kernel ({four_launches})")
    del coo_c, plan_c
    release_memory()

    # 18d: the seeded control: one .item() in each unfolding of a sweep
    from repro_torch.sparse.generators import random_sparse_tensor

    small = random_sparse_tensor((120, 100, 80), 0.01, seed=SEED).to(dev)
    ctrl = tucker.TuckerPlan(tucker.TuckerSpec(shape=(120, 100, 80), ranks=(8, 8, 8),
                                               n_iter=2), device=dev,
                             engine=item_engine(dev))
    control = ctrl.lint(small)
    for f in control:
        log(f"  18d control: {f}")
    reads = [f for f in control if f.check == "transfer" and "item()" in f.message]
    syncs = [f for f in control if f.check == "transfer" and "host sync at" in f.message]
    # (a CPU rehearsal has no sync debug mode: the function mode alone)
    check(reads and (syncs or dev.type != "cuda"),
          "18d: the seeded .item() was not flagged by both the function mode "
          f"and the sync debug mode: {[str(f) for f in control]}")
    check(not baseline.filter(reads + syncs)[1], "18d: the baseline suppresses the control")

    out = {"phase": "18 contract checks", "card": card,
           "matrix_s": t_matrix, "matrix_launches": {k: v for k, v in launches.items() if v},
           "cells": [{"name": c.name, "engine": c.engine, "skipped": c.skipped,
                      "findings": [f.to_json() for f in c.findings]} for c in raw.cells],
           "suppressed": [f.to_json() for f in suppressed + nell_sup + four_sup],
           "sharded_ranks_s": t_ranks, "sharded": sharded,
           "nell2": {"setup_s": t_setup, "lint_s": t_lint, "sweep_ms": sweep_ms,
                     "sweep_ms_runs": runs, "phase4_sweep_ms": RECORDED.get("phase4_sweep_ms"),
                     "analyze": terms, "achieved_from_models": achieved,
                     "findings": [f.to_json() for f in nell_raw]},
           "four_way": {"shape": shape_c, "nnz": nnz_c, "launches": four_launches,
                        "findings": [f.to_json() for f in four_raw]},
           "control": [f.to_json() for f in control]}
    print(json.dumps(out), flush=True)


# -- phase 19: the dense, ssm, audio and vlm families at full width -----------------

# (config, layers kept (None: all), prefill input): Qwen2-7B (dense, GQA 7),
# Mamba2-1.3B (ssm, N 128, chunk 256), MusicGen-large (audio, frame
# embeddings), InternVL2-76B's LM (vlm, GQA 8) cut to 8 of its 80 layers:
# its 70.55 B parameters take 141 GB in bf16, past one card's 80 GB;
# granite-moe-1b-a400m whole (moe, 32 experts top-8, GQA 2); Grok-1 (moe, 8
# experts top-2, two expert shards, GQA 6) cut to GROK_LAYERS of its 64
# layers at full width: each layer holds 9.84 GB in bf16. Grok runs last, on
# a card the others have left empty.
GROK_LAYERS = 6
FAMILY_SERVING = (
    ("qwen2-7b", None, "tokens"),
    ("mamba2-1.3b", None, "tokens"),
    ("musicgen-large", None, "embeds"),
    ("internvl2-76b", 8, "tokens"),
    ("granite-moe-1b-a400m", None, "tokens"),
    ("grok-1-314b", GROK_LAYERS, "tokens"),
)
FAMILY_DECODE_STEPS = 8


def family_generate(eng, batch: dict, n: int) -> np.ndarray:
    """``Engine.generate``'s loop from a prefill batch (tokens or
    ``embeds``): the prefill, then ``n - 1`` greedy decode steps fed with
    tokens. Returns the (B, n) new tokens."""
    logits, cache = eng.prefill(eng.params, batch)
    p = next(iter(batch.values())).shape[1]
    cache = eng._pad_cache(cache, p)
    token = eng._sample(logits)
    out = [token[:, None]]
    for i in range(n - 1):
        logits, cache = eng.decode(eng.params, cache, {"token": token[:, None], "pos": p + i})
        token = eng._sample(logits)
        out.append(token[:, None])
    return torch.cat(out, dim=1).cpu().numpy()


def flash_row(label: str, q, k, v, kw) -> dict:
    """Kernel 6 on one layer's inputs: against its plain version (the bf16
    rule), its ms, the plain version's, SDPA's on the same inputs (GQA
    through ``enable_gqa``; with more keys than queries, the end-aligned
    causal mask) and the bound."""
    from repro_torch.kernels import flash_attention as fa

    kern = partial(fa.flash_attention, q, k, v, **kw)
    plain = partial(fa.flash_attention_plain, q, k, v, **kw)
    err = compare(f"flash_attention {label} q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}",
                  "bf16", synced(kern()).float(), synced(plain()).float(),
                  q.shape[2] * q.shape[3])
    b_, h_, s_, d_ = q.shape
    t_ = k.shape[2]
    flops = 4 * b_ * h_ * d_ * sum(min(t_, i + 1 + t_ - s_) for i in range(s_))
    nbytes = nbytes_of(q, k, v, q)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if t_ > s_:  # SDPA's is_causal aligns the diagonal to the top left: the mask instead
        mask = torch.ones(s_, t_, dtype=torch.bool, device=q.device).tril(t_ - s_)
        lib = partial(sdpa, q, k, v, attn_mask=mask, enable_gqa=h_ != k.shape[1])
    else:
        lib = partial(sdpa, q, k, v, is_causal=True, enable_gqa=h_ != k.shape[1])
    lib_ms = time_ms(lib)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return {"shape": [b_, h_, s_, d_], "kv_heads": int(k.shape[1]), "kv_len": t_,
            "ms": time_ms(kern),
            "plain_ms": time_ms(plain, reps=3), "library_ms": lib_ms,
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
            "flops": flops, "bytes": nbytes, "max_abs_err": err}


def ssd_row(label: str, x, acs, bm, cm) -> dict:
    """Kernel 7 on one layer's inputs: against its plain version (the fp32
    rule), the f64 control (must pass) and the TF32 control (must fail),
    its ms, the plain version's and the bound."""
    from repro_torch.kernels import ssd_scan

    kern = partial(ssd_scan.ssd_chunk, x, acs, bm, cm)
    plain = partial(ssd_scan.ssd_chunk_plain, x, acs, bm, cm)
    bh_, c_, l_, p_ = x.shape
    n_ = bm.shape[-1]
    want = synced(plain())
    controls = {}
    for name, ctrl, must_pass in (("f64", ssd_chunk_f64, True),
                                  ("one TF32 pass", ssd_chunk_tf32, False)):
        r = ssd_rule(synced(ctrl(x, acs, bm, cm)), want, l_, n_)
        controls[name] = {k: r[k]["over_limit"] for k in ("y", "state")}
        # (a CPU rehearsal has no TF32: there the TF32 control is the plain f32)
        check(r["ok"] == must_pass or (not x.is_cuda and not must_pass),
              f"{label}: the {name} control "
              f"{'fails' if must_pass else 'passes'} the fp32 rule: the rule cannot judge "
              "kernel 7 here")
    y, st = synced(kern())
    err = max(compare(f"ssd_chunk {label} y {tuple(x.shape)} N {n_}", "fp32", y, want[0],
                      l_ * n_),
              compare(f"ssd_chunk {label} state {tuple(st.shape)}", "fp32", st, want[1], l_))
    del y, st, want
    tri = bh_ * c_ * l_ * (l_ + 1) // 2
    score, yf, stf = tri * 2 * n_, tri * 2 * p_, bh_ * c_ * 2 * l_ * n_ * p_
    nbytes = nbytes_of(x, acs, bm, cm, x) + bh_ * c_ * n_ * p_ * 4
    t_b = nbytes / PEAK_BYTES_PER_S
    t_o = score / PEAK_BF16_FLOPS + 3 * (yf + stf) / PEAK_TF32_FLOPS
    return {"shape": [bh_, c_, l_, p_, n_], "b_c_dtype": str(bm.dtype), "ms": time_ms(kern),
            "plain_ms": time_ms(plain, reps=3), "library_ms": None,
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
            "controls": controls, "flops": score + yf + stf, "bytes": nbytes,
            "max_abs_err": err}


def smoke_card_vs_cpu(dev, arch: str, embeds: bool) -> dict:
    """Phase 8's check for ``arch``'s SMOKE config: card against CPU from the
    same seeded weights, in f32 and bf16 (phase 8's tolerances): prefill
    logits (from embeds too, for the audio and vision families),
    teacher-forced decode steps and the greedy tokens of ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import ATTENTION_FAMILIES, init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    rng = np.random.default_rng(SEED)
    out = {}
    for dtype, tol in LM_TOL.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        scfg = ServeConfig(max_seq_len=SMOKE_P + SMOKE_NEW, batch_size=SMOKE_B)
        eng = {"cpu": Engine(cfg, params, scfg, device="cpu"),
               "cuda": Engine(cfg, tree_to(params, dev), scfg, device=dev)}
        prompts = rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_P))
        gen = {d: e.generate(prompts, SMOKE_NEW) for d, e in eng.items()}
        logits = {}
        for d, e in eng.items():
            reset_launches()
            logits[d], _ = teacher_forced(e, gen["cpu"], SMOKE_P, SMOKE_NEW)
            if d == "cuda":
                got = {k: v for k, v in read_launches().items() if v}
                attn = cfg.n_layers if cfg.family in ATTENTION_FAMILIES else 0
                want = {"flash_attention": attn} if attn else {"ssd_chunk": cfg.n_layers}
                check(got == want, f"{arch} SMOKE card prefill launches {got}, want {want}")
        errs = []
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            a, b = a.float().cpu(), b.float()
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            errs.append(err / scale)
            check(bool(torch.isfinite(a).all()) and err <= tol * scale,
                  f"{arch} SMOKE {dtype} step {i}: card and CPU logits disagree "
                  f"({err:.3e} > {tol} x {scale:.3e})")
        agreed = greedy_agrees(gen["cuda"], gen["cpu"], logits["cpu"], tol, cfg.vocab_size,
                               f"{arch} SMOKE {dtype} greedy")
        row = {"max_rel_err": max(errs), "greedy_steps_equal": agreed}
        if embeds:
            emb = torch.randn((SMOKE_B, SMOKE_P, cfg.d_model),
                              generator=torch.Generator().manual_seed(SEED))
            a = eng["cuda"].prefill(eng["cuda"].params, {"embeds": emb.to(dev)})[0].float().cpu()
            b = eng["cpu"].prefill(params, {"embeds": emb})[0].float()
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= tol * scale, f"{arch} SMOKE {dtype} prefill from embeds: card and CPU "
                  f"disagree ({err:.3e} > {tol} x {scale:.3e})")
            row["embeds_prefill_rel_err"] = err / scale
        log(f"  {arch} SMOKE {dtype}: card against CPU {json.dumps(row)}")
        out[dtype] = row
    return out


def serve_family(dev, card: str, arch: str, keep_layers, prefill_input: str,
                 smoke: bool = False) -> dict:
    """One family at full width: seeded bf16 weights made on the card, batch
    4, 4,096-token prompts (or frame embeddings), a cold ``generate`` of
    COLD_NEW new tokens; the launches per generate from the counters;
    prefill ms, decode ms a step, tokens/s,
    peak and busy share; kernel 6 on layer 0's inputs (and SDPA's time),
    kernel 7 on every call of a warm prefill (``ssd_per_layer_gate``) and on
    layer 0's inputs with the two controls; for the ``moe`` family, phase
    21b's report of its blocks (:func:`moe_prefill_report`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import ATTENTION_FAMILIES, init_params, param_count_actual
    from repro_torch.serve.engine import Engine, ServeConfig

    full = get_config(arch, smoke=smoke)  # SMOKE: a CPU rehearsal
    cfg = full if keep_layers is None or smoke else dataclasses.replace(full,
                                                                        n_layers=keep_layers)
    attn_layers = cfg.n_layers if cfg.family in ATTENTION_FAMILIES else 0
    ssd_layers = cfg.n_layers if cfg.family == "ssm" else 0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in param_leaves(params))
    eng = Engine(cfg, params, ServeConfig(max_seq_len=SERVE_MAX, batch_size=SERVE_B), device=dev)
    if prefill_input == "embeds":
        x = torch.randn((SERVE_B, SERVE_P, cfg.d_model), generator=gen, device=dev)
        batch = {"embeds": x.to(torch.bfloat16)}
        del x
    else:
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (SERVE_B, SERVE_P))
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev)}
    log(f"  {arch}: {cfg.family}, {cfg.n_layers} layers"
        + (f" (cut from {full.n_layers})" if keep_layers else "")
        + f", d {cfg.d_model}, {n_params / 1e9:.3f} B parameters (the config's full count "
        f"{param_count_actual(full) / 1e9:.3f} B), prefill from {prefill_input}")

    # the main path: every count starts at 0 here and is read right after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    if prefill_input == "embeds":
        new = family_generate(eng, batch, COLD_NEW)
    else:
        new = eng.generate(prompts, COLD_NEW)[:, SERVE_P:]
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    routes = dict(fa.flash_attention.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"fused_kron_scatter": 0, "ttm": 0, "kron_contrib": 0, "scatter_rows": 0,
            "fused_kron_scatter_ttm": 0, "fused_kron_chain_scatter": 0,
            "flash_attention": attn_layers,
            "ssd_chunk": ssd_layers}
    log(f"    cold generate {t_cold:.3f} s, launches {launches}, routes {routes}, peak "
        f"{peak_gb:.2f} GB")
    check(launches == want, f"{arch}: launches {launches}, want {want} (one prefill)")
    check(routes.get("wgmma", 0) == attn_layers,
          f"{arch}: attention routes {routes}, want all {attn_layers} on the tensor cores")
    check(new.shape == (SERVE_B, COLD_NEW) and bool(((new >= 0) & (new < cfg.vocab_size)).all()),
          f"{arch}: generated tokens {new.shape}")

    prefill = partial(eng.prefill, params, batch)
    prefill_ms = time_ms(prefill, reps=2)
    logits, cache = prefill()
    check(bool(torch.isfinite(logits.float()).all()), f"{arch}: non-finite prefill logits")
    step = {"cache": eng._pad_cache(cache, SERVE_P), "token": eng._sample(logits)[:, None],
            "pos": SERVE_P}
    del cache

    def decode_steps(n):
        for _ in range(n):
            lg, step["cache"] = eng.decode(params, step["cache"],
                                           {"token": step["token"], "pos": step["pos"]})
            step["token"] = eng._sample(lg)[:, None]
            step["pos"] += 1
        return lg

    decode_steps(1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lg = decode_steps(FAMILY_DECODE_STEPS)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / FAMILY_DECODE_STEPS
    check(bool(torch.isfinite(lg.float()).all()), f"{arch}: non-finite decode logits")
    prof_decode = profile_run(lambda: decode_steps(4))
    del step, lg
    prof_prefill = profile_run(prefill)
    gen_s = (prefill_ms + (SERVE_NEW - 1) * decode_ms) / 1e3
    busy = {"prefill": prof_prefill["device_busy_ms"] / prefill_ms,
            "decode": prof_decode["device_busy_ms"] / (4 * decode_ms)}
    log(f"    warm: prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms a step, "
        f"{SERVE_B * SERVE_NEW / gen_s:.1f} generated tokens/s; busy {busy}")

    rows = {}
    kept = capture_inputs(prefill)
    if attn_layers:
        (q, k, v), kw = kept["flash_attention"]
        rows["flash_attention"] = flash_row(f"{arch} layer 0", q, k, v, kw)
        log(f"    flash_attention: {json.dumps(rows['flash_attention'])}")
        del q, k, v
    if ssd_layers:
        per_layer, gated = ssd_per_layer_gate(lambda: prefill()[0], ssd_layers)
        check(torch.equal(gated, logits), f"{arch}: the gated prefill's logits differ")
        (x, acs, bm, cm), _ = kept["ssd_chunk"]
        rows["ssd_chunk"] = dict(ssd_row(f"{arch} layer 0", x, acs, bm, cm),
                                 per_layer=per_layer)
        log(f"    ssd_chunk: {json.dumps(rows['ssd_chunk'])}")
        del x, acs, bm, cm, gated
    del kept, logits
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["device_ms"] = prof_prefill["kernel_ms"][name] / launches[name]
    if cfg.family == "moe":
        RECORDED.setdefault("moe", {})[arch] = moe_prefill_report(cfg, eng, batch, prefill_ms)
    RECORDED.setdefault("roofline", []).append(roofline_record(
        arch, cfg, full, {"name": f"prefill_{SERVE_B}x{SERVE_P}", "seq_len": SERVE_P,
                          "global_batch": SERVE_B, "kind": "prefill"},
        prefill_ms, peak_gb * 1e9))
    smoke = smoke_card_vs_cpu(dev, arch, prefill_input == "embeds")
    out = {"config": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "layers_of_config": full.n_layers, "params": n_params, "init_s": t_init,
           "prefill_input": prefill_input, "cold_generate_s": t_cold,
           "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "generate_s_from_parts": gen_s, "generated_tokens_per_s": SERVE_B * SERVE_NEW / gen_s,
           "decode_tokens_per_s": SERVE_B * 1e3 / decode_ms, "peak_memory_gb": peak_gb,
           "launches_per_generate": {k: v for k, v in launches.items() if v},
           "device_busy_share": busy, "kernels": rows, "smoke_card_vs_cpu": smoke,
           "profile_prefill_top": prof_prefill["top"][:8],
           "profile_decode_top": prof_decode["top"][:8]}
    del eng, params, batch
    release_memory()
    return out


def phase19_families(dev, card: str, smoke: bool = False) -> None:
    log(f"phase 19: the dense, ssm, audio, vlm and moe families at full width, batch {SERVE_B}, "
        f"{SERVE_P}-token prompts, {COLD_NEW} new tokens, bf16, seeded weights on the card")
    out = {"phase": "19 LM families", "card": card, "batch": SERVE_B, "prompt": SERVE_P,
           "new_tokens": COLD_NEW, "tokens_per_s_at": SERVE_NEW, "families": {}}
    for arch, keep, prefill_input in FAMILY_SERVING:
        t0 = time.perf_counter()
        out["families"][arch] = serve_family(dev, card, arch, keep, prefill_input, smoke)
        out["families"][arch]["phase_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


# -- phase 20: Tucker-factorized layers at full width ---------------------------------

TL_LINEAR = (3584, 18944, 64)  # qwen2-7b's wi (d, ff), its exact rank
TL_EXPERTS = ((32, 1024, 512), (8, 64, 64))  # granite-moe's expert stack (E, d, ff), ranks
TL_TOL = 1e-4


def exact_low_rank(dev, shape, ranks, seed: int):
    """A tensor of exact multilinear rank ``ranks``: a seeded core times
    orthonormal factors, in f32 on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(tuple(ranks), generator=g, device=dev)
    for n, (i, r) in enumerate(zip(shape, ranks)):
        u, _ = torch.linalg.qr(torch.randn((i, r), generator=g, device=dev))
        x = torch.movedim(torch.tensordot(u, x, dims=([1], [n])), 0, n)
    return x.contiguous()


def _projector_gap(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a @ a.T - b @ b.T).abs().max())


def phase20_tucker_layers(dev, card: str) -> None:
    """``tuckerize_linear`` on an exact rank-64 3,584 x 18,944 weight at ranks
    (64, 64), applied to 4 x 4,096 tokens against x @ W; and
    ``tuckerize_expert_stack`` on an exact low-rank (32, 1,024, 512) stack at
    ranks (8, 64, 64), each expert applied against x @ W_e. Relative errors
    <= 1e-4; card against CPU by the factors' projectors; ms; the
    compression ratios."""
    from repro_torch.models import tucker_layers as tl

    m, n, r = TL_LINEAR
    log(f"phase 20: Tucker-factorized layers: a rank-{r} {m} x {n} weight at ranks ({r}, {r}), "
        f"an expert stack {TL_EXPERTS[0]} at ranks {TL_EXPERTS[1]}")
    out = {"phase": "20 Tucker layers", "card": card}
    w = exact_low_rank(dev, (m, n), (r, r), SEED)
    t0 = time.perf_counter()
    p = tl.tuckerize_linear(w, (r, r))
    torch.cuda.synchronize()
    t_fact = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = tl.tuckerize_linear(w, (r, r))
    torch.cuda.synchronize()
    t_fact_warm = time.perf_counter() - t0
    check(all(t.device == w.device for t in p.values()), "20: the factors left the card")
    x = torch.randn((SERVE_B * SERVE_P, m), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    y, y_ref = synced(tl.tucker_linear_apply(p, x)), synced(x @ w)
    lin_err = float((y - y_ref).abs().max() / y_ref.abs().max())
    w_hat = p["u1"] @ p["core"] @ p["u2"].T
    w_err = float((w_hat - w).abs().max() / w.abs().max())
    del y, y_ref, w_hat
    apply_ms = time_ms(partial(tl.tucker_linear_apply, p, x))
    dense_ms = time_ms(lambda: x @ w)
    p_cpu = tl.tuckerize_linear(w.cpu(), (r, r))
    lin_gap = max(_projector_gap(p["u1"], p_cpu["u1"]), _projector_gap(p["u2"], p_cpu["u2"]))
    ratio = tl.linear_compression_ratio(m, n, (r, r))
    out["linear"] = {"shape": [m, n], "ranks": [r, r], "tokens": x.shape[0],
                     "apply_rel_err": lin_err, "weight_rel_err": w_err,
                     "card_vs_cpu_projector_gap": lin_gap, "tuckerize_s_cold": t_fact,
                     "tuckerize_s_warm": t_fact_warm, "apply_ms": apply_ms,
                     "dense_matmul_ms": dense_ms, "compression_ratio": ratio}
    log(f"  linear: {json.dumps(out['linear'])}")
    check(lin_err <= TL_TOL and w_err <= TL_TOL, f"20: the Tucker linear is off: apply "
          f"{lin_err:.3e}, weight {w_err:.3e} (limit {TL_TOL})")
    check(lin_gap <= 1e-3, f"20: card and CPU factors differ: projector gap {lin_gap:.3e}")
    del w, x, p, p_cpu
    release_memory()

    shape, ranks = TL_EXPERTS
    experts = exact_low_rank(dev, shape, ranks, SEED + 1)
    t0 = time.perf_counter()
    pe = tl.tuckerize_expert_stack(experts, ranks)
    torch.cuda.synchronize()
    t_exp = time.perf_counter() - t0
    xe = torch.randn((SERVE_P, shape[1]), generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev)
    exp_err = 0.0
    for e in range(shape[0]):
        got, want = tl.tucker_expert_apply(pe, e, xe), xe @ experts[e]
        exp_err = max(exp_err, float((got - want).abs().max() / want.abs().max()))
    pe_cpu = tl.tuckerize_expert_stack(experts.cpu(), ranks)
    exp_gap = max(_projector_gap(pe[k], pe_cpu[k]) for k in ("u_e", "u_d", "u_f"))
    e_apply_ms = time_ms(partial(tl.tucker_expert_apply, pe, 0, xe))
    e_dense_ms = time_ms(lambda: xe @ experts[0])
    out["experts"] = {"shape": list(shape), "ranks": list(ranks), "tokens": SERVE_P,
                      "apply_rel_err": exp_err, "card_vs_cpu_projector_gap": exp_gap,
                      "tuckerize_s": t_exp, "apply_ms_one_expert": e_apply_ms,
                      "dense_matmul_ms_one_expert": e_dense_ms,
                      "compression_ratio": tl.expert_compression_ratio(*shape, ranks)}
    log(f"  experts: {json.dumps(out['experts'])}")
    check(exp_err <= TL_TOL, f"20: the Tucker expert stack is off: {exp_err:.3e}")
    check(exp_gap <= 1e-3, f"20: card and CPU expert factors differ: {exp_gap:.3e}")
    del experts, pe, pe_cpu, xe
    release_memory()
    print(json.dumps(out), flush=True)



# -- phase 21: the moe family and sampling --------------------------------------------

# 21a, card against CPU in f32 on identical inputs: moe_block's output within
# MOE_TOL x max|CPU| (the same operations, f32 sums in other orders, TF32
# off), its aux within MOE_AUX_TOL; the forward's logits within phase 8's
# f32 tolerance. Cases (config, expert_shards, capacity_factor), SMOKE
# widths: grok's SMOKE has one shard, so the shard sum takes 2 here, and
# capacity 0.5 drops pairs.
MOE_TOL, MOE_AUX_TOL = 1e-5, 1e-6
MOE_CASES = (
    ("granite-moe-1b-a400m", 1, 1.25),
    ("grok-1-314b", 2, 1.25),
    ("granite-moe-1b-a400m", 1, 0.5),
)
MOE_WEIGHTS = ("router", "moe_wi", "moe_wg", "moe_wo")
# 21c: granite at full width sampling at SAMPLE_T from SAMPLE_P-token
# prompts; SAMPLE_DRAWS draws of one logit row, SAMPLE_BATCH rows a call,
# held to softmax(row[:V] / T) by a chi-square test at p >= SAMPLE_MIN_P
SAMPLE_T, SAMPLE_P, SAMPLE_NEW = 0.8, 64, 16
SAMPLE_DRAWS, SAMPLE_BATCH, SAMPLE_MIN_P = 1 << 20, 1 << 12, 1e-6


def moe_prefill_report(cfg, eng, batch: dict, prefill_ms: float) -> dict:
    """Phase 21b on phase 19's model at full width: one warm prefill with
    each ``moe_block`` call bracketed by CUDA events and its routing read
    (the dropped share of routed pairs, the aux); the blocks' ms and their
    share of ``prefill_ms``; and ``flops.cell_cost``'s executed and useful
    FLOPs of this prefill over ``prefill_ms`` against the bf16 peak."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops, moe

    orig, calls = moe.moe_block, []

    def timed(cfg_, x, wr, wi, wg, wo, **kw):
        r = moe.route(cfg_, x.reshape(-1, x.shape[-1]), wr)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y, aux = orig(cfg_, x, wr, wi, wg, wo, **kw)
        end.record()
        calls.append((start, end, r.dropped_share, aux, r.cap))
        return y, aux

    moe.moe_block = timed
    try:
        eng.prefill(eng.params, batch)
    finally:
        moe.moe_block = orig
    torch.cuda.synchronize()
    check(len(calls) == cfg.n_layers, f"{cfg.name}: {len(calls)} moe_block calls in a prefill, "
          f"want {cfg.n_layers}")
    ms = [s.elapsed_time(e) for s, e, *_ in calls]
    dropped = [float(c[2]) for c in calls]
    aux = [float(c[3]) for c in calls]
    check(all(math.isfinite(a) and a > 0 for a in aux) and all(0 <= d < 1 for d in dropped),
          f"{cfg.name}: moe aux {aux}, dropped shares {dropped}")
    cost = flops.cell_cost(cfg, ShapeConfig("serve", SERVE_P, SERVE_B, "prefill"))
    sec = prefill_ms / 1e3
    out = {"layers": cfg.n_layers, "capacity": calls[0][4], "routed_pairs":
           SERVE_B * SERVE_P * cfg.top_k, "dropped_share_per_layer": dropped,
           "aux_per_layer": aux, "moe_block_ms_per_layer": ms,
           "moe_block_ms_sum": sum(ms), "moe_share_of_prefill": sum(ms) / prefill_ms,
           "prefill_ms": prefill_ms, "cell_cost_flops": cost.flops,
           "cell_cost_model_flops": cost.model_flops,
           "executed_tflops_per_s": cost.flops / sec / 1e12,
           "model_tflops_per_s": cost.model_flops / sec / 1e12,
           "executed_share_of_bf16_peak": cost.flops / sec / PEAK_BF16_FLOPS,
           "model_share_of_bf16_peak": cost.model_flops / sec / PEAK_BF16_FLOPS}
    log(f"    21b moe blocks: {json.dumps(out)}")
    return out


def moe_card_vs_cpu(dev, arch: str, shards: int, cf: float) -> dict:
    """Phase 21a for one SMOKE case in f32: layer 0's ``moe_block`` on the
    card and on the CPU from identical weights and inputs (the same experts,
    kept pairs and slots; output and aux within their tolerances), and the
    full forward's logits and aux."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import forward, init_params

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              expert_shards=shards, capacity_factor=cf)
    label = f"{arch} SMOKE, {shards} shard(s), capacity {cf}"
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    cparams = tree_to(params, dev)
    x = torch.randn((SMOKE_B, SMOKE_P, cfg.d_model),
                    generator=torch.Generator().manual_seed(SEED + 1))
    w = [params["layers"][n][0] for n in MOE_WEIGHTS]
    cw = [cparams["layers"][n][0] for n in MOE_WEIGHTS]
    r = moe.route(cfg, x.reshape(-1, cfg.d_model), w[0])
    rc = moe.route(cfg, x.to(dev).reshape(-1, cfg.d_model), cw[0])
    check(rc.slot.device.type == dev.type, f"21a {label}: routing left {dev}")
    for name in ("tope", "keep", "slot"):
        check(torch.equal(getattr(rc, name).cpu(), getattr(r, name)),
              f"21a {label}: the card's {name} differ from the CPU's")
    y, aux = moe.moe_block(cfg, x, *w)
    yc, auxc = moe.moe_block(cfg, x.to(dev), *cw)
    err = float((yc.cpu() - y).abs().max()) / float(y.abs().max())
    aux_err = abs(float(auxc) - float(aux))
    check(yc.device.type == dev.type and err <= MOE_TOL and aux_err <= MOE_AUX_TOL,
          f"21a {label}: moe_block card against CPU {err:.3e} (limit {MOE_TOL}), aux "
          f"{aux_err:.3e} (limit {MOE_AUX_TOL})")
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SMOKE_B, SMOKE_P)), dtype=torch.long)
    lg, _, faux = forward(cfg, params, tokens)
    lgc, _, fauxc = forward(cfg, cparams, tokens.to(dev))
    lg_err = float((lgc.float().cpu() - lg).abs().max()) / float(lg.abs().max())
    tol = LM_TOL["float32"]
    check(bool(torch.isfinite(lgc).all()) and lg_err <= tol,
          f"21a {label}: forward logits card against CPU {lg_err:.3e} (limit {tol})")
    fa_err = abs(float(fauxc) - float(faux))
    check(fa_err <= cfg.n_layers * MOE_AUX_TOL,
          f"21a {label}: forward aux card against CPU {fa_err:.3e}")
    row = {"config": cfg.name, "expert_shards": shards, "capacity_factor": cf,
           "capacity": r.cap, "routed_pairs": int(r.keep.numel()),
           "dropped_share": float(r.dropped_share), "moe_rel_err": err, "aux_err": aux_err,
           "aux": float(aux), "forward_logit_rel_err": lg_err, "forward_aux_err": fa_err}
    log(f"  21a {label}: {json.dumps(row)}")
    return row


def chi_square_p(counts: torch.Tensor, probs: torch.Tensor) -> float:
    """The chi-square test's p-value of ``counts`` against ``probs`` (both on
    the CPU), the bins whose expected count is below 5 pooled into one:
    Q(df / 2, stat / 2), the regularized upper incomplete gamma function."""
    counts, probs = counts.double(), probs.double()
    expected = counts.sum() * probs
    small = expected < 5
    obs = torch.cat([counts[~small], counts[small].sum()[None]])
    exp = torch.cat([expected[~small], expected[small].sum()[None]])
    if float(exp[-1]) == 0:
        obs, exp = obs[:-1], exp[:-1]
    stat = ((obs - exp) ** 2 / exp).sum()
    df = torch.tensor(float(len(obs) - 1), dtype=torch.float64)
    return float(torch.special.gammaincc(df / 2, stat / 2))


def sampling_on_card(dev, smoke: bool = False) -> dict:
    """Phase 21c: granite at full width on the card, ``generate`` at T 0.8
    with a CUDA generator seeded twice (the same tokens) and with another
    seed (other tokens), every token below ``vocab_size``; then
    ``SAMPLE_DRAWS`` draws of ``Engine._sample`` from one prefill logit row
    against softmax(row[:V] / T) (chi-square, p >= 1e-6; the same counts
    against T x 1.2 reported as a control), and the ms of one sampled and
    one greedy ``_sample`` of a decode step's 4 rows. ``smoke``: the SMOKE
    config, for a CPU rehearsal."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config("granite-moe-1b-a400m", smoke=smoke)
    v = cfg.vocab_size
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = np.random.default_rng(SEED + 2).integers(0, v, (SERVE_B, SAMPLE_P))

    def engine(temperature: float, seed: int):
        return Engine(cfg, params, ServeConfig(max_seq_len=SAMPLE_P + SAMPLE_NEW,
                                               batch_size=SERVE_B, temperature=temperature),
                      device=dev, generator=torch.Generator(device=dev).manual_seed(seed))

    runs = [engine(SAMPLE_T, seed).generate(prompts, SAMPLE_NEW) for seed in (1, 1, 2)]
    greedy = engine(0.0, 1).generate(prompts, SAMPLE_NEW)
    new = [r[:, SAMPLE_P:] for r in runs]
    check(all(np.array_equal(r[:, :SAMPLE_P], prompts) for r in runs), "21c: prompts changed")
    check(np.array_equal(new[0], new[1]), "21c: one seed gave two token sequences")
    check(not np.array_equal(new[0], new[2]), "21c: two seeds gave the same tokens")
    check(all(int(r.min()) >= 0 and int(r.max()) < v for r in new), "21c: a token >= vocab")

    eng = engine(SAMPLE_T, 3)
    logits, _ = eng.prefill(params, {"tokens": torch.as_tensor(prompts, device=dev)})
    row = logits[0]
    counts = torch.zeros(v, dtype=torch.long, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH):
        tok = eng._sample(row.expand(SAMPLE_BATCH, -1))
        counts += torch.bincount(tok, minlength=v)
    end.record()
    end.synchronize()
    check(tok.device.type == dev.type and int(counts.sum()) == SAMPLE_DRAWS
          and counts.numel() == v,
          f"21c: {int(counts.sum())} draws over {counts.numel()} tokens, on {tok.device}")
    scaled = (row[:v].float() / SAMPLE_T).double().cpu()
    p = chi_square_p(counts.cpu(), torch.softmax(scaled, dim=-1))
    p_ctrl = chi_square_p(counts.cpu(), torch.softmax(scaled / 1.2, dim=-1))
    check(p >= SAMPLE_MIN_P, f"21c: draws against softmax(row / T): p {p:.3e} < {SAMPLE_MIN_P}")
    out = {"config": cfg.name, "temperature": SAMPLE_T, "prompt": SAMPLE_P,
           "new_tokens": SAMPLE_NEW, "seeded_twice_equal": True, "other_seed_differs": True,
           "tokens_differing_from_greedy": int((new[0] != greedy[:, SAMPLE_P:]).sum()),
           "draws": SAMPLE_DRAWS, "chi_square_p": p, "control_p_at_1.2T": p_ctrl,
           "draw_ms_per_row_batch": start.elapsed_time(end) / (SAMPLE_DRAWS // SAMPLE_BATCH),
           "sample_ms_decode_step": time_ms(partial(eng._sample, logits)),
           "greedy_ms_decode_step": time_ms(partial(engine(0.0, 0)._sample, logits))}
    log(f"  21c sampling: {json.dumps(out)}")
    del eng, params, logits, row, counts
    release_memory()
    return out


def phase21_moe_sampling(dev, card: str, smoke: bool = False) -> None:
    """21a the moe block card against CPU in f32 (SMOKE; two expert shards;
    dropped pairs), 21b phase 19's report of granite's and grok's blocks at
    full width, 21c sampling with temperature > 0 on the card (``smoke``:
    at SMOKE width, a CPU rehearsal)."""
    from repro_torch.configs import get_config

    log("phase 21: the moe family (card against CPU in f32; the blocks at full width from "
        "phase 19) and sampling at temperature > 0")
    cases = [moe_card_vs_cpu(dev, arch, shards, cf) for arch, shards, cf in MOE_CASES]
    check(any(c["dropped_share"] > 0 for c in cases), "21a: no case dropped a pair")
    moe_archs = [a for a, _, _ in FAMILY_SERVING if get_config(a).family == "moe"]
    check(sorted(RECORDED.get("moe", {})) == sorted(moe_archs),
          f"21b: phase 19 reported {sorted(RECORDED.get('moe', {}))}, want {moe_archs}")
    out = {"phase": "21 moe and sampling", "card": card, "card_vs_cpu": cases,
           "prefill": RECORDED["moe"], "sampling": sampling_on_card(dev, smoke)}
    print(json.dumps(out), flush=True)

# -- phase 22: training ------------------------------------------------------------

# 22a: kernel 6's backward on the model's layout, (b, s, t, H, KVH, D, causal,
# what the case covers): GQA 1, 3 and 8, D 28, 64, 80 and 128, S != T (the
# diagonal at the kv end), S and T off the 64-row tiles, and non-causal. In
# bf16 each takes the "wgmma" route with TMA staging, except D 28, whose
# 56-byte head stride takes the ordinary-load staging; in f32 the "simt"
# route
FLASH_BWD_CASES = [
    (2, 100, 100, 8, 8, 80, True, "GQA 1, D 80 (Zamba2's head dim)"),
    (1, 77, 150, 6, 2, 64, True, "GQA 3, D 64, T > S"),
    (2, 130, 130, 8, 1, 128, True, "GQA 8, D 128"),
    (2, 128, 128, 12, 4, 64, True, "GQA 3, D 64 (repro-100m's heads)"),
    (1, 64, 192, 4, 4, 80, True, "GQA 1, D 80, T > S"),
    (2, 70, 90, 4, 2, 16, False, "non-causal, D 16"),
    (2, 90, 90, 6, 2, 28, True, "GQA 3, D 28 (ordinary-load staging)"),
]
# 22a: kernel 7's backward, (BH, C, L, P, N, decay rate, what the case
# covers); each with B and C in bf16 and in f32
SSD_BWD_CASES = [
    (2, 3, 64, 32, 16, 0.1, "L 64, N 16"),
    (2, 2, 256, 64, 64, 0.1, "L 256, N = P 64 (Zamba2's chunk)"),
    (1, 2, 256, 64, 128, 0.1, "L 256, N 128"),
    (2, 1, 64, 80, 128, 8.0, "L 64, P 80, N 128, steep decay"),
    (1, 2, 100, 17, 64, 0.1, "L 100, P 17, N 64"),
]
# 22b: one train step of each family's SMOKE config in f32, card against
# CPU from the same parameters and batch
TRAIN_SMOKE = ("repro-100m", "granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b",
               "musicgen-large", "internvl2-76b")
TRAIN_SMOKE_B, TRAIN_SMOKE_S, TRAIN_SMOKE_LR = 2, 64, 1e-3
# the limits of 22b, each a fraction of the CPU's value: f32 on both
# devices, the card's kernels summing in other orders than the CPU's plain
# versions (kernel 7 in 3xTF32); the loss 1e-5, the grad norm 1e-4, each
# updated first moment (0.1 x the clipped gradient) 1e-3 of its max|CPU|.
# The first AdamW step moves each entry by lr x m/sqrt(v) = lr x sign(g),
# so a gradient entry near zero whose sign differs between the devices
# moves its parameter 2 lr apart: the parameters are held to that.
TRAIN_SMOKE_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "mu": 1e-3}
# 22c: Zamba2-2.7B at full width, cut from the reference's train_4k shape
# (global batch 256 x 4,096 tokens) to 2 x 4,096 tokens, 3 steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 3  # 4 steps until the time limit cut one
TRAIN_GATED_STEP = 1  # the step whose backward kernels run beside their plain versions
LOSS0_BAND = 0.10  # the step-0 loss within 10% of ln(vocab): random weights
# 22d: repro-100m through ``python -m repro_torch.train``'s code path
# (cut from 300 steps and a kill at 160, then from 200 and a kill at 110 to
# make room for phase 25, then from 120 and a kill at 70 for phase 26's
# ssm cells, to keep the script within its time limit)
R100_STEPS, R100_CKPT_EVERY, R100_KILL = 60, 50, 55
# 22d: the resumed run's losses against the uninterrupted run's, relative.
# Bits are not the bar: the embedding's backward (``index_put_`` with
# accumulate) may sum in another order on another run. Measured: the same
# losses to the bit over steps 150-299 of a 300-step run on one H100 at
# 700 W (PERF.md, phase 22d); 1e-3 leaves room for such sums and no more.
R100_RESUME_LOSS_TOL = 1e-3


def all_wrappers() -> dict:
    """:func:`wrappers` and the two backward kernels' wrappers."""
    from repro_torch.kernels import flash_attention, ssd_scan

    return {**wrappers(), "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "ssd_chunk_bwd": ssd_scan.ssd_chunk_bwd}


def reset_all_launches() -> None:
    reset_launches()
    for fn in all_wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_all_launches() -> dict:
    return {name: fn.launches for name, fn in all_wrappers().items()}


def judge(name: str, got, want, n_terms: int):
    """``against_plain`` of one gradient, its rule by its dtype: bf16 outputs
    BF16_OUT_TOL, f32 outputs the fp32 rule over ``n_terms``; returns (the
    max abs error, its share of the limit) and fails at once outside it."""
    prec = "bf16" if got.dtype == torch.bfloat16 else "fp32"
    err, limit, _, _, ok = against_plain(got.float(), want.float(), prec, n_terms)
    check(ok and got.dtype == want.dtype,
          f"{name} [{prec}]: max_abs_err {err:.3e} > {limit:.3e} ({got.dtype}, {want.dtype})")
    return err, err / limit


def worse(acc: dict, name: str, judged) -> None:
    """Fold one :func:`judge` result into ``acc[name]``'s worst error and
    worst share of a limit."""
    err, ratio = judged
    row = acc.setdefault(name, {"max_abs_err": 0.0, "worst_over_limit": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["worst_over_limit"] = max(row["worst_over_limit"], ratio)


def flash_bwd_terms(q, k) -> dict:
    """The most terms summed into one output of each gradient: dq sums T
    keys' dS k, dk and dv the G S query rows of their kv head, each term
    from a D-term product."""
    g = q.shape[1] // k.shape[1]
    return {"dq": k.shape[2] * q.shape[3], "dk": g * q.shape[2] * q.shape[3],
            "dv": g * q.shape[2] * q.shape[3]}


def ssd_bwd_terms(x, bm) -> dict:
    l_, p_, n_ = x.shape[2], x.shape[3], bm.shape[3]
    w = l_ * max(n_, p_)
    return {"dx": w, "da": l_ * (n_ + p_), "db": w, "dc": w}


def gated_backward(fn):
    """``fn()`` with ``flash_attention_bwd`` and ``ssd_chunk_bwd`` wrapped
    where the autograd Functions look them up: each call launches the
    kernel, runs the plain version on the same inputs, holds every gradient
    to its rule (:func:`judge`) and passes the kernel's own gradients on;
    the first call's inputs are kept (cloned, strides included). Returns
    (fn's result, the calls and worst share of a limit by kernel, the kept
    inputs)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    orig_fa, orig_ssd = fa.flash_attention_bwd, ssd_scan.ssd_chunk_bwd
    report = {n: {"calls": 0, "max_abs_err": 0.0, "worst_over_limit": 0.0}
              for n in ("flash_attention_bwd", "ssd_chunk_bwd")}
    kept = {}

    def note(name, judged, args):
        report[name]["calls"] += 1
        for j in judged:
            worse(report, name, j)
        kept.setdefault(name, [a.clone() if isinstance(a, torch.Tensor) else a for a in args])

    def attn(q, k, v, out, lse, dout, causal=True, scale=None):
        got = orig_fa(q, k, v, out, lse, dout, causal, scale)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale)
        terms = flash_bwd_terms(q, k)
        layer = report["flash_attention_bwd"]["calls"]
        judged = [judge(f"flash_attention_bwd call {layer} {n}", g, w, terms[n])
                  for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        del want
        note("flash_attention_bwd", judged, (q, k, v, out, lse, dout, causal, scale))
        return got

    def ssd(x, a, b, c, dy, ds):
        got = orig_ssd(x, a, b, c, dy, ds)
        want = ssd_scan.ssd_chunk_bwd_plain(x, a, b, c, dy, ds)
        terms = ssd_bwd_terms(x, b)
        layer = report["ssd_chunk_bwd"]["calls"]
        judged = [judge(f"ssd_chunk_bwd call {layer} {n}", g, w, terms[n])
                  for n, g, w in zip(("dx", "da", "db", "dc"), got, want)]
        del want
        note("ssd_chunk_bwd", judged, (x, a, b, c, dy, ds))
        return got

    fa.flash_attention_bwd, ssd_scan.ssd_chunk_bwd = attn, ssd
    try:
        out = fn()
    finally:
        fa.flash_attention_bwd, ssd_scan.ssd_chunk_bwd = orig_fa, orig_ssd
    return out, report, kept


def same_bits_twice(fn) -> bool:
    first = synced(fn())
    again = synced(fn())
    return all(torch.equal(a, b) for a, b in zip(first, again))


def phase22a_bwd_kernels(dev) -> dict:
    """Each backward kernel against its plain version at odd shapes, and the
    same bits from two calls; kernel 6's forward log-sum-exp against the
    plain version's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    worst, routes = {}, {}
    for b, s, t, h, kvh, d, causal, label in FLASH_BWD_CASES:
        qm, km, vm, dom = randn(b, s, h, d), randn(b, t, kvh, d), randn(b, t, kvh, d), \
            randn(b, s, h, d)
        for dtype in (torch.float32, torch.bfloat16):
            # the model's layout: (b, s, heads, hd) read through (b, heads, s, hd) views
            q, k, v, do = (x.to(dtype).transpose(1, 2) for x in (qm, km, vm, dom))
            tag = f"{label} {(b, h, kvh, s, t, d)} {str(dtype)[6:]}"
            out, lse = synced(fa._forward(q, k, v, causal, None, want_lse=True))
            _, lse_want = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
            compare(f"flash_attention lse {tag}", "fp32", lse, lse_want, t * d)
            run = partial(fa.flash_attention_bwd, q, k, v, out, lse, do, causal)
            before = dict(fa.flash_attention_bwd.launches_by_route)
            got = synced(run())
            taken = {r: n - before[r] for r, n in fa.flash_attention_bwd.launches_by_route.items()}
            route, staging = fa.bwd_launch_plan(
                dtype, (q.shape, k.shape, v.shape, do.shape),
                (q.stride(), k.stride(), v.stride(), do.stride()),
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr()), causal=causal)
            want_route = fa.ROUTES[dtype]
            want_staging = None if dtype == torch.float32 else ("threads" if d == 28 else "tma")
            check(route == want_route and staging == want_staging
                  and taken == {r: int(r == want_route) for r in taken},
                  f"flash_attention_bwd {tag}: took {taken}, planned {route}/{staging}, want "
                  f"{want_route}/{want_staging}")
            routes[(want_route, staging)] = routes.get((want_route, staging), 0) + 1
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
            terms = flash_bwd_terms(q, k)
            for n, gg, w in zip(("dq", "dk", "dv"), got, want):
                # the kernel writes each gradient in its operand's layout
                like = {"dq": q, "dk": k, "dv": v}[n]
                check(gg.dtype == dtype and (not gg.is_cuda or gg.stride() == like.stride()),
                      f"flash_attention_bwd {tag} {n}: {gg.dtype} {gg.stride()}")
                worse(worst, "flash_attention_bwd",
                      judge(f"flash_attention_bwd {tag} {n}", gg, w, terms[n]))
            check(same_bits_twice(run), f"flash_attention_bwd {tag}: two calls differ")
    for bh, c, n_l, p, n, rate, label in SSD_BWD_CASES:
        x, bm, cm = randn(bh, c, n_l, p), randn(bh, c, n_l, n), randn(bh, c, n_l, n)
        acs = torch.cumsum(-rate * randn(bh, c, n_l).abs(), dim=-1)
        dy, ds = randn(bh, c, n_l, p), randn(bh, c, n, p)
        for dtype in (torch.bfloat16, torch.float32):
            b_, c_ = bm.to(dtype), cm.to(dtype)
            tag = f"{label} {(bh, c, n_l, p, n)} B, C {str(dtype)[6:]}"
            run = partial(ssd_scan.ssd_chunk_bwd, x, acs, b_, c_, dy, ds)
            got = synced(run())
            want = ssd_scan.ssd_chunk_bwd_plain(x, acs, b_, c_, dy, ds)
            terms = ssd_bwd_terms(x, b_)
            for name, gg, w in zip(("dx", "da", "db", "dc"), got, want):
                worse(worst, "ssd_chunk_bwd",
                      judge(f"ssd_chunk_bwd {tag} {name}", gg, w, terms[name]))
            check(same_bits_twice(run), f"ssd_chunk_bwd {tag}: two calls differ")
    check(set(routes) == {("wgmma", "tma"), ("wgmma", "threads"), ("simt", None)},
          f"22a: kernel 6's backward took {sorted(routes, key=str)}, want both routes and both "
          f"stagings")
    log(f"  22a: both backward kernels within their rules at {len(FLASH_BWD_CASES) * 2} and "
        f"{len(SSD_BWD_CASES) * 2} odd cases, the same bits twice; kernel 6's calls by route "
        f"and staging {json.dumps({f'{r}/{s}': n for (r, s), n in routes.items()})}; worst "
        f"share of a limit " + json.dumps(worst))
    return worst


def train_batch(cfg, shape, step: int, dev, seed: int = 1234) -> dict:
    from repro_torch.data.pipeline import DataConfig, batch_for_step

    b = batch_for_step(cfg, shape, DataConfig(seed=seed), step, embeds=cfg.frontend != "none")
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def smoke_train_launches(cfg) -> dict:
    """The kernels one train step of ``cfg`` launches under remat "full": each
    forward kernel twice (the forward and its recompute), each backward
    kernel once, per attention or SSD layer."""
    from repro_torch.models.model import ATTENTION_FAMILIES

    check(cfg.remat == "full", f"{cfg.name}: remat {cfg.remat!r}, want the default 'full'")
    n_sb = cfg.n_layers // cfg.hybrid_period
    attn = {"hybrid": n_sb, "ssm": 0}.get(cfg.family, cfg.n_layers)
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    check(cfg.family in ATTENTION_FAMILIES or ssd, f"{cfg.name}: family {cfg.family}")
    out = {"flash_attention": 2 * attn, "flash_attention_bwd": attn, "ssd_chunk": 2 * ssd,
           "ssd_chunk_bwd": ssd}
    return {k: v for k, v in out.items() if v}


def phase22b_smoke_card_vs_cpu(dev) -> dict:
    """One train step of each family's SMOKE config in f32 on the card and on
    the CPU, from the same parameters and batch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    shape = ShapeConfig("smoke", TRAIN_SMOKE_S, TRAIN_SMOKE_B, "train")
    out = {}
    for arch in TRAIN_SMOKE:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_SMOKE_LR, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, opt_cfg)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        res = {}
        for where in ("cpu", "cuda"):
            d = torch.device("cpu") if where == "cpu" else dev
            p = tree_to(params, d)
            reset_all_launches()
            new_p, opt, m = step(p, adamw.init(p), train_batch(cfg, shape, 0, d))
            res[where] = (tree_to(new_p, "cpu"), tree_to(opt.mu, "cpu"),
                          {k: float(v) for k, v in m.items()})
            if where == "cuda":
                got = {k: v for k, v in read_all_launches().items() if v}
                check(got == smoke_train_launches(cfg),
                      f"22b {arch}: the card's step launched {got}, want "
                      f"{smoke_train_launches(cfg)}")
        (p_cpu, mu_cpu, m_cpu), (p_card, mu_card, m_card) = res["cpu"], res["cuda"]
        row = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "grad_norm")}
        for k in ("loss", "grad_norm"):
            check(math.isfinite(m_card[k]) and row[k] <= TRAIN_SMOKE_TOL[k],
                  f"22b {arch}: {k} card {m_card[k]} against CPU {m_cpu[k]}")
        row["mu"] = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(adamw.leaves(mu_card), adamw.leaves(mu_cpu)))
        check(row["mu"] <= TRAIN_SMOKE_TOL["mu"], f"22b {arch}: first moments {row['mu']}")
        lr = m_cpu["lr"]
        row["param_moved_over_2lr"] = max(
            float((a - b).abs().max()) / (2 * lr + 1e-6 * float(b.abs().max()))
            for a, b in zip(adamw.leaves(p_card), adamw.leaves(p_cpu)))
        check(row["param_moved_over_2lr"] <= 1.0 + 1e-3, f"22b {arch}: parameters {row}")
        log(f"  22b {arch} SMOKE f32, one train step: card against CPU {json.dumps(row)}")
        out[arch] = row
    return out


def sdpa_bwd_ms(q, k, v, dout, causal: bool) -> float:
    """Milliseconds of SDPA's backward (``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention`` with ``enable_gqa``) on the same
    operands: the library call beside kernel 6's backward. With more keys
    than queries the causal rule is the end-aligned bool mask (SDPA's
    ``is_causal`` aligns the diagonal to the top left)."""
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    s_, t_ = q.shape[2], k.shape[2]
    if causal and t_ > s_:
        mask = torch.ones(s_, t_, dtype=torch.bool, device=q.device).tril(t_ - s_)
        kw = {"attn_mask": mask}
    else:
        kw = {"is_causal": causal}
    out = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, enable_gqa=True, **kw)
    return time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), dout, retain_graph=True))


def flash_bwd_row(args, label: str) -> dict:
    """Kernel 6's backward on ``args`` (q, k, v, out, lse, dout, causal,
    scale): its ms, the plain version's, SDPA backward's and the bound (five
    products over the causal half at the bf16 rate, or the bytes)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, out, lse, dout, causal, scale = args
    kern = partial(fa.flash_attention_bwd, q, k, v, out, lse, dout, causal, scale)
    plain = partial(fa.flash_attention_bwd_plain, q, k, v, out, lse, dout, causal, scale)
    b_, h_, s_, d_ = q.shape
    t_ = k.shape[2]
    seen = sum(min(t_, i + 1 + t_ - s_) for i in range(s_)) if causal else s_ * t_
    flops = 5 * 2 * b_ * h_ * d_ * seen
    nbytes = nbytes_of(q, k, v, out, lse, dout, q, k, v)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    route = fa.ROUTES[q.dtype]
    row = {"shape": [b_, h_, s_, d_], "kv_heads": int(k.shape[1]), "dtype": str(q.dtype),
           "route": route, "ms": time_ms(kern), "plain_ms": time_ms(plain, reps=3),
           "library_ms": sdpa_bwd_ms(q, k, v, dout, causal),
           "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
           # the wgmma design's own tensor-core work: ten product-equivalents
           # (S^T, dP^T, dV and dK split hi + lo; S, dP and dQ split again)
           "design_bound_ms": max(t_b, 2 * t_o) * 1e3 if route == "wgmma" else None,
           "f32_core_bound_ms": flops / PEAK_F32_FLOPS * 1e3, "flops": flops, "bytes": nbytes}
    log(f"    flash_attention_bwd {label}: {json.dumps(row)}")
    return row


def ssd_bwd_row(args, label: str) -> dict:
    """Kernel 7's backward on ``args`` (x, a, b, c, dy, ds): its ms, the
    plain version's and the bound (C B^T on bf16 operands at the bf16 rate,
    the f32 products as three TF32 products each, or the bytes)."""
    from repro_torch.kernels import ssd_scan

    x, a, bm, cm, dy, ds = args
    kern = partial(ssd_scan.ssd_chunk_bwd, *args)
    plain = partial(ssd_scan.ssd_chunk_bwd_plain, *args)
    bh_, c_, l_, p_ = x.shape
    n_ = bm.shape[-1]
    tri = bh_ * c_ * l_ * (l_ + 1) // 2
    # G = C B^T; dy x^T; M^T dy; dG B; dG^T C; and the state's B dS, x dS^T
    score = tri * 2 * n_
    rest = tri * 2 * (p_ + p_ + n_ + n_) + bh_ * c_ * 2 * 2 * l_ * n_ * p_
    nbytes = nbytes_of(x, a, bm, cm, dy, ds, x, a, bm, cm)
    t_b = nbytes / PEAK_BYTES_PER_S
    score_rate = PEAK_BF16_FLOPS if bm.dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    t_o = score / score_rate + 3 * rest / PEAK_TF32_FLOPS
    row = {"shape": [bh_, c_, l_, p_, n_], "b_c_dtype": str(bm.dtype), "ms": time_ms(kern),
           "plain_ms": time_ms(plain, reps=3), "library_ms": None,
           "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
           "f32_core_bound_ms": bound(nbytes, score + rest)[0], "flops": score + rest,
           "bytes": nbytes}
    log(f"    ssd_chunk_bwd {label}: {json.dumps(row)}")
    return row


def ptxas_usage(path) -> list:
    """(kernel, "registers; spills") of each kernel in a ptxas log, the
    kernel named by its mangled name's kernel and template arguments."""
    out, kernel = [], None
    for line in Path(path).read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            kernel = next((m for m in re.findall(r"\d+([a-z_]+_kernel)", mangled)), mangled)
            kernel += mangled[mangled.index(kernel) + len(kernel):].split("EEv")[0]
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "registers" in line:
            out.append((kernel, f"{line.split(':', 1)[1].strip()}; {spills}"))
            kernel = None
    return out


def phase22c_zamba2(dev, card: str) -> dict:
    """Zamba2-2.7B as registered, trained by ``Trainer`` for TRAIN_STEPS steps
    of TRAIN_B x TRAIN_S tokens (remat "full", no checkpoint directory); step
    TRAIN_GATED_STEP under :func:`gated_backward`."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops as flops_lib
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("zamba2-2.7b")
    check(cfg.remat == "full", f"zamba2-2.7b's remat is {cfg.remat!r}, want the default 'full'")
    n_sb = cfg.n_layers // cfg.hybrid_period
    shape = ShapeConfig("train_4k_cut", TRAIN_S, TRAIN_B, "train")
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                         opt=adamw.AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, shape, tcfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in adamw.leaves(trainer.params))
    log(f"  22c: {cfg.name} ({n_params / 1e9:.3f} B parameters, {n_sb} shared-attention calls, "
        f"{cfg.n_layers} Mamba-2 layers), {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens, "
        f"remat {cfg.remat}; state on the card in {t_init:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    watched = {"embed": lambda p: p["embed"]["table"][:64],
               "lm_head": lambda p: p["lm_head"]["w"],
               "mamba wx": lambda p: p["layers"]["wx"][0, 0],
               "shared wq": lambda p: p["shared"]["wq"], "a_log": lambda p: p["layers"]["a_log"]}
    before = {k: f(trainer.params).clone() for k, f in watched.items()}

    step_fn, calls, gate = trainer.step_fn, [0], {}

    def step_with_gate(*args):
        i = calls[0]
        calls[0] += 1
        if i != TRAIN_GATED_STEP:
            return step_fn(*args)
        out, gate["report"], gate["kept"] = gated_backward(lambda: step_fn(*args))
        return out

    trainer.step_fn = step_with_gate
    # the main path: every count starts at 0 here and is read right after
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    hist = trainer.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_all_launches()
    from repro_torch.kernels import flash_attention as fa
    bwd_routes = dict(fa.flash_attention_bwd.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bwd_routes == {"wgmma": n_sb * TRAIN_STEPS, "simt": 0},
          f"22c: kernel 6's backward took the routes {bwd_routes}, want every one of "
          f"{n_sb * TRAIN_STEPS} calls on 'wgmma'")
    want = {k: 0 for k in launches}
    want.update({"flash_attention": 2 * n_sb * TRAIN_STEPS,
                 "flash_attention_bwd": n_sb * TRAIN_STEPS,
                 "ssd_chunk": 2 * cfg.n_layers * TRAIN_STEPS,
                 "ssd_chunk_bwd": cfg.n_layers * TRAIN_STEPS})
    log(f"  22c: {TRAIN_STEPS} steps in {t_run:.1f} s, launches {launches}, peak {peak_gb:.2f} GB")
    check(launches == want, f"22c launches {launches}, want {want} (remat 'full': each forward "
          f"kernel twice a step)")
    rep = gate["report"]
    check(rep["flash_attention_bwd"]["calls"] == n_sb
          and rep["ssd_chunk_bwd"]["calls"] == cfg.n_layers,
          f"22c: the gated step made {rep} backward calls, want {n_sb} and {cfg.n_layers}")
    losses = [h["loss"] for h in hist]
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) <= LOSS0_BAND * ln_v,
          f"22c: step-0 loss {losses[0]:.4f}, want within {LOSS0_BAND:.0%} of ln({cfg.vocab_size}) "
          f"= {ln_v:.4f}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
          f"22c: non-finite loss or grad norm in {hist}")
    moved = {k: float((f(trainer.params).float() - before[k].float()).abs().max())
             for k, f in watched.items()}
    check(all(v > 0 for v in moved.values()), f"22c: parameters did not move: {moved}")
    del before
    warm = [h["step_time_s"] for i, h in enumerate(hist) if i > TRAIN_GATED_STEP]
    step_s = sorted(warm)[len(warm) // 2]
    cost = flops_lib.cell_cost(cfg, shape)
    RECORDED.setdefault("roofline", []).append(roofline_record(
        "zamba2-2.7b", cfg, cfg, dataclasses.asdict(shape), step_s * 1e3, peak_gb * 1e9))
    # the backward kernels again on the gated step's first inputs: two calls'
    # bits, their times and the library call's
    kept = gate.pop("kept")
    from repro_torch.kernels import _build, ssd_scan
    fa_args, ssd_args = kept["flash_attention_bwd"], kept["ssd_chunk_bwd"]
    check(same_bits_twice(partial(fa.flash_attention_bwd, *fa_args)),
          "22c: flash_attention_bwd differs between two calls at the path's shape")
    check(same_bits_twice(partial(ssd_scan.ssd_chunk_bwd, *ssd_args)),
          "22c: ssd_chunk_bwd differs between two calls at the path's shape")
    fa_row = flash_bwd_row(fa_args, "Zamba2-2.7B training, layer 0")
    ssd_row = ssd_bwd_row(ssd_args, "Zamba2-2.7B training, layer 0")
    # the forward kernels at the same shapes, without and with the LSE
    q, k, v = fa_args[:3]
    fwd_ms = {"no_lse": time_ms(partial(fa._forward, q, k, v, True, None, False)),
              "lse": time_ms(partial(fa._forward, q, k, v, True, None, True))}
    del kept, fa_args, ssd_args, q, k, v
    # one more step under the profiler: the device's busy share and each
    # kernel's device time
    batch = train_batch(cfg, shape, TRAIN_STEPS, dev)
    holder = {}

    def one_step():
        holder["out"] = step_fn(trainer.params, trainer.opt_state, batch)
        float(holder["out"][2]["loss"])

    prof = profile_run(one_step)
    trainer.params, trainer.opt_state, _ = holder.pop("out")
    kms = prof["kernel_ms"]
    # kernel 6's backward by pass, a call's device time, beside the design's
    # bound, SDPA's backward and the plain version
    passes = {name: kms[f"flash_attention_bwd {name}"] / n_sb for name in ("delta", "dK/dV", "dQ")}
    log(f"  22c: kernel 6's backward a call, device ms by pass {json.dumps(passes)}; design "
        f"bound {fa_row['design_bound_ms']:.3f} ms, bound {fa_row['bound_ms']:.3f}, SDPA "
        f"backward {fa_row['library_ms']:.3f}, plain {fa_row['plain_ms']:.3f}")
    fa_row["device_ms_by_pass"] = passes
    for name in ("flash_attention_bwd_wgmma", "ssd_chunk_bwd"):
        for kernel, usage in ptxas_usage(_build.BUILD_DIR / f"{name}.ptxas.log"):
            log(f"  22c ptxas {name} {kernel}: {usage}")
    summary = {
        "phase": "22c Zamba2-2.7B training", "card": card, "config": cfg.name, "params": n_params,
        "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS, "remat": cfg.remat,
        "cut_from": "train_4k (global batch 256 x 4,096 tokens): batch 2, 3 steps",
        "init_s": t_init, "run_s": t_run, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist], "step_s": [h["step_time_s"] for h in hist],
        "ms_per_step": step_s * 1e3, "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
        "peak_memory_gb": peak_gb, "launches": {k: v for k, v in launches.items() if v},
        "flash_attention_bwd_routes": bwd_routes, "gated_step": rep, "params_moved": moved,
        "executed_flops": cost.flops, "useful_flops": cost.model_flops,
        "executed_share_of_bf16_peak": cost.flops / step_s / PEAK_BF16_FLOPS,
        "useful_share_of_bf16_peak": cost.model_flops / step_s / PEAK_BF16_FLOPS,
        "device_busy_share": prof["busy_share"], "profiled_step_ms": prof["wall_ms"],
        "kernel_device_ms_per_step": kms, "forward_attention_ms": fwd_ms,
        "flash_attention_bwd": fa_row, "ssd_chunk_bwd": ssd_row,
        "profile_top": prof["top"],
    }
    print(json.dumps(summary), flush=True)
    return {
        "flash_attention_bwd": {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "launches": launches["flash_attention_bwd"],
            "max_abs_err": rep["flash_attention_bwd"]["max_abs_err"], "ms": fa_row["ms"],
            "plain_ms": fa_row["plain_ms"],
            "device_ms": kms["flash_attention_bwd"] / n_sb, "bound_ms": fa_row["bound_ms"],
            "bound_by": fa_row["bound_by"], "library_ms": fa_row["library_ms"],
            "worst_over_limit": rep["flash_attention_bwd"]["worst_over_limit"]},
        "ssd_chunk_bwd": {
            "name": "ssd_chunk_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:48",
            "launches": launches["ssd_chunk_bwd"],
            "max_abs_err": rep["ssd_chunk_bwd"]["max_abs_err"], "ms": ssd_row["ms"],
            "plain_ms": ssd_row["plain_ms"],
            "device_ms": kms["ssd_chunk_bwd"] / cfg.n_layers, "bound_ms": ssd_row["bound_ms"],
            "bound_by": ssd_row["bound_by"],
            # no single PyTorch call computes the masked-decay block's VJP
            "library_ms": None,
            "worst_over_limit": rep["ssd_chunk_bwd"]["worst_over_limit"]},
    }


def phase22d_repro100m(dev, card: str, tmp: str) -> dict:
    """repro-100m at full width through ``python -m repro_torch.train``'s code
    path: R100_STEPS steps of 8 x 128 with the example's optimizer settings
    and a checkpoint every R100_CKPT_EVERY; then a run killed at step
    R100_KILL, restarted from its latest checkpoint."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.train import __main__ as train_main

    def args(name):
        return train_main.parse_args(["--steps", str(R100_STEPS), "--full-100m", "--batch", "8",
                                      "--seq", "128", "--ckpt-dir", os.path.join(tmp, name),
                                      "--device", str(dev)])

    a = train_main.make_trainer(args("a"))
    check(a.tcfg.ft.checkpoint_every == R100_CKPT_EVERY and a.start_step == 0,
          f"22d: checkpoint every {a.tcfg.ft.checkpoint_every}, start {a.start_step}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist_a = a.run()
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    line = train_main.loss_line(hist_a)
    log(f"  22d: {a.cfg.name}, {R100_STEPS} steps in {t_a:.1f} s: {line}")
    first = sum(h["loss"] for h in hist_a[:10]) / 10
    last = sum(h["loss"] for h in hist_a[-10:]) / 10
    check(last < first, f"22d: the loss did not fall: {line}")

    class Killed(Exception):
        pass

    b1 = train_main.make_trainer(args("b"), FailureInjector(fail_at=[R100_KILL], exc=Killed))
    try:
        b1.run()
    except Killed:
        pass
    else:
        check(False, "22d: the injected kill did not stop the run")
    del b1
    kill_step = R100_KILL // R100_CKPT_EVERY * R100_CKPT_EVERY
    b2 = train_main.make_trainer(args("b"))
    check(b2.start_step == kill_step, f"22d: resumed at {b2.start_step}, want {kill_step}")
    like = (b2.params, b2.opt_state)
    (ck_p, ck_o), step, _ = CheckpointManager(os.path.join(tmp, "b")).restore(like, kill_step,
                                                                               device=dev)
    restored = adamw.leaves(b2.params) + [t for part in b2.opt_state[:3]
                                          for t in adamw.leaves(part)] + [b2.opt_state.count]
    stored = (adamw.leaves(ck_p) + [t for part in ck_o[:3] for t in adamw.leaves(part)]
              + [ck_o.count])
    same = len(restored) == len(stored) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(restored, stored))
    check(same and int(b2.opt_state.count) == kill_step,
          f"22d: the restored state is not the step-{kill_step} checkpoint bit for bit")
    del ck_p, ck_o, stored, restored
    t0 = time.perf_counter()
    hist_b = b2.run()
    t_b = time.perf_counter() - t0
    check([h["step"] for h in hist_b] == list(range(kill_step, R100_STEPS)),
          f"22d: the resumed run took steps {hist_b[0]['step']}..{hist_b[-1]['step']}")
    gaps = [abs(hb["loss"] - ha["loss"]) / ha["loss"]
            for hb, ha in zip(hist_b, hist_a[kill_step:])]
    out = {"steps": R100_STEPS, "run_s": t_a, "resumed_run_s": t_b,
           "first10": first, "last10": last, "loss_line": line,
           "ms_per_step": 1e3 * sorted(h["step_time_s"] for h in hist_a)[R100_STEPS // 2],
           "resumed_at": b2.start_step, "restored_bits_equal": same,
           "resumed_loss_rel_gap_max": max(gaps), "resumed_loss_rel_gap_last": gaps[-1],
           "resumed_final_loss": hist_b[-1]["loss"], "final_loss": hist_a[-1]["loss"],
           "peak_gb": peak / 1e9}
    # phase 25 holds training across ranks to this run: its history, its
    # step time and peak, and its checkpoints
    RECORDED["r100"] = {"history": [{k: h[k] for k in ("loss", "grad_norm", "step_time_s")}
                                    for h in hist_a],
                        "ms_per_step": out["ms_per_step"], "peak_bytes": peak,
                        "ckpt_dir": os.path.join(tmp, "a"), "last_step": R100_STEPS}
    log(f"  22d: resumed at {b2.start_step} (the restored state is the checkpoint's bits), "
        f"{len(hist_b)} steps in {t_b:.1f} s; later losses against the uninterrupted run's: "
        f"max relative gap {max(gaps):.3e}, last {gaps[-1]:.3e}")
    check(max(gaps) <= R100_RESUME_LOSS_TOL,
          f"22d: resumed losses {max(gaps):.3e} from the uninterrupted run's, over "
          f"{R100_RESUME_LOSS_TOL}")
    return out


def repro100m_bwd_row(dev, calls: int = 20) -> dict:
    """Kernel 6's backward at repro-100m's shape (b 8, 12 heads over 4, 128,
    64): :func:`flash_bwd_row` and the device ms a call, profiled over
    ``calls`` calls (the profiler can miss a one-call window)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
                   .transpose(1, 2) for shape in ((8, 128, 12, 64), (8, 128, 4, 64),
                                                  (8, 128, 4, 64), (8, 128, 12, 64)))
    out, lse = fa._forward(q, k, v, True, None, want_lse=True)
    row = flash_bwd_row((q, k, v, out, lse, do, True, None), "repro-100m training shape")

    def run():
        for _ in range(calls):
            fa.flash_attention_bwd(q, k, v, out, lse, do, True)

    row["device_ms"] = profile_run(run)["kernel_ms"]["flash_attention_bwd"] / calls
    return row


def phase22_training(dev, card: str, tmp: str) -> dict:
    """22a the backward kernels at odd shapes, 22b card against CPU at SMOKE
    size for every family, 22c Zamba2-2.7B trained at full width (the main
    path), 22d repro-100m through ``python -m repro_torch.train`` with a
    kill and a resume, its checkpoints under ``tmp`` (phase 25 reads them).
    Runs on an emptied card; returns the kernels' rows."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 22: training (the card holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"before it)")
    secs = {}
    t0 = time.perf_counter()
    worst = phase22a_bwd_kernels(dev)
    secs["22a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke = phase22b_smoke_card_vs_cpu(dev)
    secs["22b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phase22c_zamba2(dev, card)
    secs["22c"] = time.perf_counter() - t0
    release_memory()
    t0 = time.perf_counter()
    r100 = phase22d_repro100m(dev, card, tmp)
    secs["22d"] = time.perf_counter() - t0
    r100["flash_attention_bwd"] = repro100m_bwd_row(dev)
    for name, row in rows.items():
        row["worst_over_limit_22a"] = worst[name]["worst_over_limit"]
    print(json.dumps({"phase": "22 training", "card": card, "seconds": secs,
                      "smoke_card_vs_cpu": smoke, "repro_100m": r100,
                      "bwd_worst_over_limit_22a": worst}), flush=True)
    return rows


# -- phase 23: QRP gradient compression ---------------------------------------------

COMPRESS_ARCH, COMPRESS_RANK = "granite-moe-1b-a400m", 64
COMPRESS_TOL = 1e-3  # 23a: subspace angle, and Q P^T x max|CPU|
COMPRESS_TIMEOUT_S = 600


def principal_sin(q, q_ref) -> float:
    """sin of the largest principal angle between the column spaces of two
    matrices with orthonormal columns, ||(I - Q Q^T) Q_ref||_2 in f64: the
    spectral norm of the difference of their projectors, which bounds its
    largest entry."""
    q, q_ref = q.double(), q_ref.double()
    return float(torch.linalg.matrix_norm(q_ref - q @ (q.T @ q_ref), ord=2))


def phase23_compression(dev, card: str, arch: str = COMPRESS_ARCH, smoke: bool = False) -> None:
    """23a ``compress_matrix`` card against CPU at each of the config's
    layer-stacked gradient shapes; 23b the compression bench's CLI over 2
    gloo ranks sharing the card. ``smoke`` takes the config's SMOKE shapes
    (a CPU rehearsal)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import compress_bench as cb
    from repro_torch.optim.compression import compress_matrix, decompress_matrix

    release_memory()
    mats = cb.grad_matrices(get_config(arch, smoke=smoke))
    rank = 8 if smoke else COMPRESS_RANK
    log(f"phase 23: QRP gradient compression at {arch}{' SMOKE' if smoke else ''}'s {len(mats)} "
        f"gradient matrices, r = {rank}")
    out = {"phase": "23 gradient compression", "card": card, "arch": arch, "rank": rank,
           "card_vs_cpu": []}
    for i, (name, m, n) in enumerate(mats):
        g = cb.seeded_gradient(m, n, rank, cb.SEED + i, dev)
        t0 = time.perf_counter()
        q, p = compress_matrix(g, rank)
        ghat = decompress_matrix(q, p)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        g_cpu = g.cpu()
        del g
        t0 = time.perf_counter()
        q_cpu, p_cpu = compress_matrix(g_cpu, rank)
        want = decompress_matrix(q_cpu, p_cpu)
        cpu_s = time.perf_counter() - t0
        sin = principal_sin(q.cpu(), q_cpu)
        scale = float(want.abs().max())
        err = float((ghat.cpu() - want).abs().max())
        finite = bool(torch.isfinite(ghat).all() and torch.isfinite(q).all())
        row = {"name": name, "m": m, "n": n, "r": q.shape[1], "subspace_sin": sin,
               "qpt_err_over_max": err / scale, "card_s": card_s, "cpu_s": cpu_s}
        log(f"  23a {name} ({m} x {n}, r {q.shape[1]}): subspace sin {sin:.3e} <= "
            f"{COMPRESS_TOL:g}, Q P^T {err / scale:.3e} <= {COMPRESS_TOL:g} x max|CPU|; card "
            f"{card_s:.3f} s, CPU {cpu_s:.3f} s")
        check(finite and sin <= COMPRESS_TOL and err <= COMPRESS_TOL * scale,
              f"23a: compress_matrix on the card disagrees with the CPU at {name}")
        out["card_vs_cpu"].append(row)
        del q, p, ghat, g_cpu, q_cpu, p_cpu, want
        release_memory()

    # 23b: the bench as its CLI runs it, 2 gloo ranks sharing the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compress_") as tmp:
        path = os.path.join(tmp, "compress_bench.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.compress_bench", "--rank", str(rank),
               "--arch", arch, "--out", path, "--device", dev.type] + (
                   ["--smoke"] if smoke else [])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=COMPRESS_TIMEOUT_S, check=False)
        bench_s = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines():
            log(f"  23b {line}")
        check(proc.returncode == 0, f"23b: compress_bench exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        res = json.loads(Path(path).read_text())
    want_bytes = 4 * sum(min(rank, m, n) * (m + n) for _, m, n in mats)
    check(res["ok"] and res["world"] == 2 and res["checks"]["finite"]
          and res["checks"]["same_bits_on_every_rank"]
          and res["qrp_compressed"]["coll_bytes"] == want_bytes
          and res["raw"]["coll_bytes"] == 4 * sum(m * n for _, m, n in mats),
          f"23b: the bench's checks {res['checks']}, bytes {res['qrp_compressed']['coll_bytes']}"
          f" against {want_bytes}")
    log(f"  23b over 2 {res['backend']} ranks on {res['device_name']}: raw {res['raw']['coll_bytes']} B a "
        f"rank in {res['raw']['ms']:.1f} ms, compressed {res['qrp_compressed']['coll_bytes']} B "
        f"in {res['qrp_compressed']['ms']:.1f} ms; reduction {res['reduction']:.4f}x (the "
        f"reference's r = {rank} model {res['analytic_reduction']:.4f}x); ms the median of "
        f"{len(res['raw']['ms_runs'])} runs after a warm-up; {bench_s:.1f} s")
    out["bench"] = dict(res, seconds=bench_s)
    print(json.dumps(out), flush=True)


# -- phase 24: the roofline of the measured cells --------------------------------------


def roofline_record(arch: str, cfg, full, shape: dict, ms: float, peak_bytes: float) -> dict:
    """A record of one measured cell in the roofline's schema: one chip, no
    collective bytes, ``flops.cell_cost``'s FLOPs of ``cfg`` at ``shape`` (a
    ShapeConfig as a dict) and the measured peak; a depth-cut ``cfg`` (fewer
    layers than ``full``) is listed as skipped, since the roofline counts
    the registered config's layers."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops

    rec = {"arch": arch, "shape": shape, "mesh": "1", "chips": 1, "measured_ms": ms}
    if cfg.n_layers != full.n_layers:
        return dict(rec, status="skipped",
                    reason=f"depth cut to {cfg.n_layers} of {full.n_layers} layers")
    cost = flops.cell_cost(cfg, ShapeConfig(**shape))
    return dict(rec, status="ok", hlo={"dot_flops": cost.flops, "total_coll_bytes": 0},
                memory={"peak_tpu_est_bytes": peak_bytes})


def phase24_roofline(dev, card: str) -> None:
    """The roofline under ``h100-sxm`` over phases 19's and 22c's records,
    through the module's CLI; each compute term held to ``cell_cost``'s
    FLOPs over the bf16 peak the earlier phases divide by."""
    import tempfile

    from repro_torch.launch import roofline

    recs = RECORDED.get("roofline", [])
    kinds = {r["shape"]["kind"] for r in recs if r["status"] == "ok"}
    check({"prefill", "train"} <= kinds, f"24: phases 19 and 22c recorded {kinds}")
    h100 = roofline.resolve_arch("h100-sxm")
    log(f"phase 24: the roofline of {len(recs)} measured cells under h100-sxm ({card})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_roofline_") as tmp:
        path = os.path.join(tmp, "records.json")
        Path(path).write_text(json.dumps(recs))
        roofline.main([path, "--arch", "h100-sxm", "--md", os.path.join(tmp, "roofline.md")])
        md = Path(tmp, "roofline.md").read_text()
    out = {"phase": "24 roofline", "card": card, "arch": "h100-sxm", "cells": []}
    for rec in recs:
        if rec["status"] != "ok":
            out["cells"].append({"arch": rec["arch"], "shape": rec["shape"]["name"],
                                 "skipped": rec["reason"]})
            continue
        t = roofline.roofline_terms(rec, h100)
        want = rec["hlo"]["dot_flops"] / PEAK_BF16_FLOPS
        check(t["compute_s"] == want, f"24: {rec['arch']} compute term {t['compute_s']} is not "
              f"cell_cost's FLOPs over the bf16 peak, {want}")
        bound_ms = max(t["compute_s"], t["memory_s"], t["collective_s"]) * 1e3
        out["cells"].append({"arch": rec["arch"], "shape": rec["shape"]["name"],
                             "measured_ms": rec["measured_ms"], "roofline_ms": bound_ms,
                             "measured_over_roofline": rec["measured_ms"] / bound_ms,
                             "peak_gb": rec["memory"]["peak_tpu_est_bytes"] / 1e9, **t})
    out["table"] = md
    print(json.dumps(out), flush=True)



# -- phase 25: training across ranks ------------------------------------------------

R25_WORLD = 2  # gloo ranks sharing the card: the (2, 1) host mesh
# each world-2 step moves ~0.5 GB a rank through gloo (1-2 s a step on one
# H100's host), so 4 steps (12 until 25d took the data axis up again on the
# (2, 2) mesh); 22d's first 4 + R25_RESUME_STEPS are the baseline
R25_STEPS = 4
R25_RERUN = 2  # 25b: the steps run again at world 2, their backward calls gated (3 until 25d)
R25_RESUME_STEPS = 3  # 25c: world-1 steps after 25a's world-2 checkpoint (5 until 25d)
# world 2 against 22d's world of one: the batch's two halves run apart and
# their bf16 gradients are summed in bf16 by the reduce-scatter, so the bits
# differ from one rank's; the step-0 loss sees only the forward (each rank's
# mean over half the rows), every later loss the whole drift. Asked for:
# 1e-3, 2e-2 and 1e-2; measured on one H100 at 700 W (PERF.md, PR 29), the
# same in two runs: 2.0e-7, 1.06e-3 over 12 steps and 1.13e-3, and 1.22e-3
# for 25c's resumed losses; held at about 4x those
R25_TOL = {"loss0": 1e-5, "loss": 5e-3, "grad_norm0": 5e-3}
R25_FWD_A_STEP, R25_BWD_A_STEP = 24, 12  # 12 attention layers, remat "full"
R25_TIMEOUT_S = 600


def r25_args(tmp: str, name: str, steps: int, dev, report: str = "") -> list:
    argv = ["--steps", str(steps), "--full-100m", "--batch", "8", "--seq", "128",
            "--ckpt-dir", os.path.join(tmp, name), "--device", str(dev)]
    return argv + (["--report", report] if report else [])


def _train_job_ranks(rank, world, dev, tmp, cfg) -> dict:
    """25b, one rank: the first R25_RERUN steps again on the host mesh, no
    checkpoint, every kernel-6 backward call gated; and 22d's last
    checkpoint restored on the mesh and gathered whole."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import __main__ as train_main
    from repro_torch.train.step import train_state_specs

    mesh = make_host_mesh(device=dev)
    out = {"route": mesh.route, "world": mesh.size}
    args = train_main.parse_args(r25_args(tmp, "25b", R25_RERUN, dev))
    args.ckpt_dir = ""  # no checkpoint: the rerun is held to 25a's history
    t = train_main.make_trainer(args, mesh=mesh)
    hist, gate, _ = gated_backward(t.run)
    out["gate"] = gate["flash_attention_bwd"]
    out["history"] = [(h["loss"], h["grad_norm"]) for h in hist]
    del t
    like, shardings = train_state_specs(get_config("repro-100m"), mesh)
    mgr = CheckpointManager(cfg["ckpt_dir"])
    (p, o), step, _ = mgr.restore(like, cfg["last_step"], device=dev, shardings=shardings)
    named = _flat_state(*shardings)[:-1]  # the count is replicated
    whole = [mesh.gather_full(t, sh.spec).cpu() for t, sh in
             zip(_flat_state(p, o)[:-1], named)] + [o.count.cpu()]
    out["restored_step"] = step
    if rank == 0:
        (wp, wo), _, _ = mgr.restore(like, cfg["last_step"], device="cpu")
        want = _flat_state(wp, wo)
        out["restored_bits_equal"] = len(want) == len(whole) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(whole, want))
        out["restored_block_rows"] = int(p["lm_head"]["w"].shape[0])
    return out


def _flat_state(params, opt) -> list:
    """``(params, OptState)`` as one list: params, master, mu, nu, count."""
    from repro_torch.optim import adamw

    return (adamw.leaves(params) + [t for part in opt[:3] for t in adamw.leaves(part)]
            + [opt.count])


SHARD_JOBS["train25"] = _train_job_ranks


def run_distributed_train(tmp: str, dev) -> tuple:
    """25a: ``python -m torch.distributed.run --standalone --nproc-per-node
    R25_WORLD -m repro_torch.train --full-100m ...`` in a subprocess; returns
    (each rank's report, the command's wall seconds, its output's tail)."""
    report = os.path.join(tmp, "25a-report")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={R25_WORLD}", "-m", "repro_torch.train"]
    cmd += r25_args(tmp, "25a", R25_STEPS, dev.type, report)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=R25_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise Failure(f"25a: the distributed run took over {R25_TIMEOUT_S} s: "
                      f"{(e.stderr or '')[-2000:]}")
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"25a: exit {proc.returncode}: {proc.stderr[-3000:]}")
    reports = [json.loads(Path(report, f"rank{r}.json").read_text()) for r in range(R25_WORLD)]
    return reports, wall, proc.stdout.strip().splitlines()[-3:]


def phase25_train_ranks(dev, card: str, tmp: str) -> None:
    """25a-25c (see the module's docstring), against 22d's world-of-one run
    of the same configuration (``RECORDED["r100"]``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.train import __main__ as train_main

    base = RECORDED.get("r100")
    check(base is not None and len(base["history"]) >= R25_STEPS + R25_RESUME_STEPS,
          "25: phase 22d recorded no world-of-one run to hold world 2 to")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    secs = {}
    # 25a: the normal entry point over 2 ranks
    t0 = time.perf_counter()
    reports, wall, tail = run_distributed_train(tmp, dev)
    secs["25a"] = time.perf_counter() - t0
    for line in tail:
        log(f"  25a: {line}")
    hist = reports[0]["history"]
    check(all([(h["loss"], h["grad_norm"]) for h in r["history"]]
              == [(h["loss"], h["grad_norm"]) for h in hist] for r in reports),
          "25a: the ranks' losses or grad norms differ")
    check([h["step"] for h in hist] == list(range(R25_STEPS)),
          f"25a: steps {hist[0]['step']}..{hist[-1]['step']}")
    check(reports[0]["params_digest"] == reports[1]["params_digest"],
          "25a: the ranks gather different parameters after the last step")
    want = base["history"]
    gaps = [abs(h["loss"] - w["loss"]) / abs(w["loss"]) for h, w in zip(hist, want)]
    gnorm0 = abs(hist[0]["grad_norm"] - want[0]["grad_norm"]) / want[0]["grad_norm"]
    log(f"  25a: world 2 against 22d's world of one: step-0 loss {hist[0]['loss']:.6f} / "
        f"{want[0]['loss']:.6f} (gap {gaps[0]:.3e}), worst loss gap {max(gaps):.3e} at step "
        f"{gaps.index(max(gaps))}, step-0 grad norm gap {gnorm0:.3e}")
    check(gaps[0] <= R25_TOL["loss0"], f"25a: step-0 loss gap {gaps[0]:.3e}")
    check(max(gaps) <= R25_TOL["loss"], f"25a: loss gap {max(gaps):.3e}")
    check(gnorm0 <= R25_TOL["grad_norm0"], f"25a: step-0 grad norm gap {gnorm0:.3e}")
    cfg = get_config("repro-100m")
    for r in reports:
        fwd, bwd = r["flash_attention"], r["flash_attention_bwd"]
        check(r["route"] == "gloo-host-staged" and r["world"] == R25_WORLD,
              f"25a rank {r['rank']}: route {r['route']}, world {r['world']}")
        check(fwd == {"wgmma": R25_FWD_A_STEP * R25_STEPS, "simt": 0}
              and bwd == {"wgmma": R25_BWD_A_STEP * R25_STEPS, "simt": 0},
              f"25a rank {r['rank']}: kernel 6 launches {fwd}, backward {bwd}")
        model = r["collective_bytes_per_step_model"]
        for h in r["history"]:
            got = {k: int(h[f"{k}_bytes"]) for k in model}
            check(got == model, f"25a rank {r['rank']} step {h['step']}: bytes {got}, "
                  f"the specs say {model}")
    staged = int(hist[0]["host_staged_bytes"])
    ms2 = 1e3 * sorted(h["step_time_s"] for h in hist)[R25_STEPS // 2]
    coll_ms = 1e3 * sorted(h["collective_s"] for h in hist)[R25_STEPS // 2]
    peaks = [r["peak_bytes"] for r in reports]
    log(f"  25a: {R25_STEPS} steps at world {R25_WORLD} in {wall:.1f} s of wall (start-up "
        f"included); {ms2:.1f} ms a step ({coll_ms:.1f} of it in collectives, the median) "
        f"against {base['ms_per_step']:.1f} at world 1; bytes a "
        f"rank a step {reports[0]['collective_bytes_per_step_model']}, {staged} staged through "
        f"the host; peak a rank {[round(x / 1e9, 3) for x in peaks]} GB against "
        f"{base['peak_bytes'] / 1e9:.3f} at world 1")
    # 25b: 2 ranks again, spawned: the first steps twice, the gate, 22d's restore
    t0 = time.perf_counter()
    ranks = run_ranks("train25", R25_WORLD, "gloo", tmp,
                      {"device": str(dev), "ckpt_dir": base["ckpt_dir"],
                       "last_step": base["last_step"]})
    secs["25b"] = time.perf_counter() - t0
    first = [(h["loss"], h["grad_norm"]) for h in hist[:R25_RERUN]]
    for r, res in enumerate(ranks):
        check(res["history"] == first,
              f"25b rank {r}: losses and grad norms {res['history']} against 25a's {first}")
        gate = res["gate"]
        check(gate["calls"] == R25_BWD_A_STEP * R25_RERUN,
              f"25b rank {r}: {gate['calls']} gated backward calls")
        check(res["restored_step"] == base["last_step"], f"25b rank {r}: restored "
              f"{res['restored_step']}")
    check(ranks[0]["restored_bits_equal"]
          and ranks[0]["restored_block_rows"] == cfg.d_model // R25_WORLD,
          "25b: 22d's checkpoint restored at world 2 does not gather back to its bits")
    log(f"  25b: {R25_RERUN} steps again on each rank: 25a's losses and grad norms to the "
        f"bit; {ranks[0]['gate']['calls']} backward calls a rank within 22a's rule "
        f"(worst {max(r['gate']['worst_over_limit'] for r in ranks):.3f} of the limit); "
        f"22d's step-{base['last_step']} checkpoint restored at world 2 gathers to its bits")
    # 25c: world 1 resumes from the world-2 checkpoint
    t0 = time.perf_counter()
    args = train_main.parse_args(r25_args(tmp, "25a", R25_STEPS + R25_RESUME_STEPS, dev))
    one = train_main.make_trainer(args)
    check(one.start_step == R25_STEPS, f"25c: resumed at {one.start_step}")
    (cp, co), _, _ = CheckpointManager(os.path.join(tmp, "25a")).restore(
        (one.params, one.opt_state), R25_STEPS, device=dev)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(_flat_state(one.params, one.opt_state), _flat_state(cp, co)))
    check(same, "25c: the world-1 trainer did not restore the world-2 checkpoint's bits")
    del cp, co
    hist_c = one.run()
    resumed = [abs(h["loss"] - w["loss"]) / abs(w["loss"])
               for h, w in zip(hist_c, want[R25_STEPS:])]
    secs["25c"] = time.perf_counter() - t0
    log(f"  25c: world 1 resumed at step {one.start_step} from the world-2 checkpoint with its "
        f"bits; {len(hist_c)} steps, losses against 22d's: worst gap {max(resumed):.3e}")
    check(len(hist_c) == R25_RESUME_STEPS and max(resumed) <= R25_TOL["loss"],
          f"25c: resumed losses {max(resumed):.3e} from 22d's")
    del one
    model = reports[0]["collective_bytes_per_step_model"]
    print(json.dumps({
        "phase": "25 training across ranks", "card": card, "seconds": secs,
        "world": R25_WORLD, "route": reports[0]["route"], "steps": R25_STEPS,
        "ms_per_step": {"1": base["ms_per_step"], "2": ms2}, "wall_s_25a": wall,
        "collective_ms_per_step": coll_ms,
        "loss_gap": {"step0": gaps[0], "max": max(gaps), "resumed_at_world1_max": max(resumed)},
        "grad_norm0_gap": gnorm0, "bytes_per_rank_per_step": model,
        "host_staged_bytes_per_step": staged,
        "peak_gb": {"world1": base["peak_bytes"] / 1e9, "world2_ranks": [x / 1e9 for x in peaks]},
        "kernel6_launches_by_rank": [{"fwd": r["flash_attention"], "bwd": r["flash_attention_bwd"]}
                                     for r in reports],
        "bwd_gate": [r["gate"] for r in ranks],
        "losses_world2": [h["loss"] for h in hist]}), flush=True)


# -- phase 25d, 25e: LM training with a model axis -----------------------------------

# 25d: repro-100m whole ("cp", bf16) on the (2, 2) mesh, 4 gloo ranks sharing
# the card, RULES_TRAIN: ZeRO over the data axis and TP / SP / CP over the
# model axis together, 22d's 8 x 128 tokens and optimizer, held to 22d's
# world-1 history. 25e: Zamba2-2.7B whole (54 Mamba-2 layers, 9 shared
# blocks, bf16, remat "full") on the (1, 2) mesh, each rank its 40 of the 80
# SSM heads, 2 x 1,024 tokens, 2 steps, held to a world-1 run of the same
# weights and batch in this process; every backward call of kernels 6 and 7
# gated against its plain version.
R25D = {"arch": "repro-100m", "mesh": (2, 2), "batch": 8, "seq": 128, "steps": 6}
R25E = {"arch": "zamba2-2.7b", "mesh": (1, 2), "batch": 2, "seq": 1024, "steps": 2}
# the step-0 loss sees only the forward: the mesh's bf16 partial products
# summed in another order than one rank's products
R25DE_LOSS0_TOL = 1e-3


def _model_axis_report(t, hist, mesh, batch: int, seq: int) -> dict:
    """What a 25d / 25e rank reports of its run: the history, the count of
    the step's collective bytes from the specs, kernel 6's launches by
    route, the mesh's coordinates and route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.step import collective_bytes_per_step

    return {"history": [{k: h[k] for k in ("loss", "grad_norm", "step_time_s", "collective_s",
                                           "all_gather_bytes", "reduce_scatter_bytes",
                                           "all_reduce_bytes", "all_to_all_bytes",
                                           "host_staged_bytes")} for h in hist],
            "model": collective_bytes_per_step(t.cfg, mesh, t.rules, batch, seq),
            "launches": read_all_launches(),
            "fwd_routes": dict(fa.flash_attention.launches_by_route),
            "bwd_routes": dict(fa.flash_attention_bwd.launches_by_route),
            "coords": dict(mesh.coords), "route": mesh.route}


def _train25d_job(rank, world, dev, tmp, cfg) -> dict:
    """25d, one rank: repro-100m on the (2, 2) mesh through the example's
    trainer, no checkpoint (the main path, counts reset right before it);
    then 22d's last checkpoint restored on the mesh (two-dim specs) and
    gathered whole."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import __main__ as train_main
    from repro_torch.train.step import train_state_specs

    mesh = make_mesh(R25D["mesh"], ("data", "model"), device=dev)
    args = train_main.parse_args(r25_args(tmp, "25d", R25D["steps"], dev))
    args.ckpt_dir = ""
    t = train_main.make_trainer(args, mesh=mesh)
    _shard_sync(dev)
    reset_all_launches()
    hist = t.run()
    _shard_sync(dev)
    out = _model_axis_report(t, hist, mesh, args.batch, args.seq)
    del t
    like, shardings = train_state_specs(get_config("repro-100m"), mesh)
    mgr = CheckpointManager(cfg["ckpt_dir"])
    (p, o), step, _ = mgr.restore(like, cfg["last_step"], device=dev, shardings=shardings)
    named = _flat_state(*shardings)[:-1]
    whole = [mesh.gather_full(x, sh.spec).cpu() for x, sh in
             zip(_flat_state(p, o)[:-1], named)] + [o.count.cpu()]
    out["restored_step"] = step
    out["restored_blocks"] = [int(p["lm_head"]["w"].shape[0]), int(p["lm_head"]["w"].shape[1])]
    if rank == 0:
        (wp, wo), _, _ = mgr.restore(like, cfg["last_step"], device="cpu")
        want = _flat_state(wp, wo)
        out["restored_bits_equal"] = len(want) == len(whole) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(whole, want))
    return out


def _r25e_trainer(dev, mesh=None):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(R25E["arch"])
    shape = ShapeConfig("25e", R25E["seq"], R25E["batch"], "train")
    tcfg = TrainerConfig(total_steps=R25E["steps"], log_every=1000,
                         opt=adamw.AdamWConfig(warmup_steps=2, total_steps=R25E["steps"]))
    return Trainer(cfg, shape, tcfg, device=dev, mesh=mesh)


def _train25e_job(rank, world, dev, tmp, cfg) -> dict:
    """25e, one rank: Zamba2-2.7B on the (1, 2) mesh, every backward call of
    kernels 6 and 7 gated (:func:`gated_backward`); the first calls' inputs
    kept for the kernels line."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(R25E["mesh"], ("data", "model"), device=dev)
    t0 = time.perf_counter()
    t = _r25e_trainer(dev, mesh)
    _shard_sync(dev)
    init_s = time.perf_counter() - t0
    reset_all_launches()
    hist, gate, kept = gated_backward(t.run)
    _shard_sync(dev)
    out = _model_axis_report(t, hist, mesh, R25E["batch"], R25E["seq"])
    out.update(gate=gate, init_s=init_s, kept={
        name: [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        for name, args in kept.items()})
    return out


SHARD_JOBS["train25d"] = _train25d_job
SHARD_JOBS["train25e"] = _train25e_job


def _check_model_axis_ranks(label: str, ranks: list, launches: dict, routes: dict) -> dict:
    """The checks every 25d / 25e rank passes: the same losses and grad
    norms on all, each step's bytes the count, the launches and kernel 6's
    routes; returns the cell's numbers a rank."""
    hist = ranks[0]["history"]
    for r, res in enumerate(ranks):
        check([(h["loss"], h["grad_norm"]) for h in res["history"]]
              == [(h["loss"], h["grad_norm"]) for h in hist],
              f"{label} rank {r}: losses or grad norms differ from rank 0's")
        check(res["route"] == "gloo-host-staged", f"{label} rank {r}: route {res['route']}")
        got = {k: v for k, v in res["launches"].items() if v}
        check(got == launches, f"{label} rank {r}: launches {got}, want {launches}")
        check(res["fwd_routes"] == routes["fwd"] and res["bwd_routes"] == routes["bwd"],
              f"{label} rank {r}: kernel 6 routes {res['fwd_routes']}, {res['bwd_routes']}")
        for h in res["history"]:
            kinds = {k: int(h[f"{k}_bytes"]) for k in res["model"]}
            check(kinds == res["model"], f"{label} rank {r}: bytes {kinds}, the specs say "
                  f"{res['model']}")
    n = len(hist)
    return {"ms_per_step": [1e3 * sorted(h["step_time_s"] for h in res["history"])[n // 2]
                            for res in ranks],
            "collective_s_per_step": [sorted(h["collective_s"] for h in res["history"])[n // 2]
                                      for res in ranks],
            "bytes_per_rank_per_step": ranks[0]["model"],
            "host_staged_bytes_per_step": int(hist[0]["host_staged_bytes"]),
            "peak_gb": [res.get("peak_gb", 0.0) for res in ranks],
            "losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist]}


def kept_bwd_row(name: str, args, dev, label: str, calls: int = 50) -> dict:
    """A backward kernel (``name``: ``"flash_attention_bwd"`` or
    ``"ssd_chunk_bwd"``) on a rank's kept inputs, moved to ``dev``:
    :func:`flash_bwd_row`'s or :func:`ssd_bwd_row`'s numbers (kernel 6's
    library call SDPA's backward, with the end-aligned bool mask where
    S < T) and the device ms a call over ``calls`` profiled calls (None
    where the profiler saw no device event: a short window can be lost)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    kernel, row_fn = ((fa.flash_attention_bwd, flash_bwd_row) if name == "flash_attention_bwd"
                      else (ssd_scan.ssd_chunk_bwd, ssd_bwd_row))
    row = row_fn(args, label)

    def run():
        for _ in range(calls):
            kernel(*args)

    prof = profile_run(run)
    row["device_ms"] = prof["kernel_ms"][name] / calls if prof["device_busy_ms"] else None
    return row


def phase25_model_axis(dev, card: str, tmp: str) -> dict:
    """25d and 25e (see the module's docstring). Returns the kernels line's
    rows: kernel 6's backward at 25e's cp block (S < T) and kernel 7's on a
    rank's heads."""
    from repro_torch.configs import get_config

    base = RECORDED.get("r100")
    check(base is not None and len(base["history"]) >= R25D["steps"],
          "25d: phase 22d recorded no world-of-one run to hold the mesh to")
    release_memory()
    secs, out = {}, {"phase": "25d/25e training with a model axis", "card": card}
    # 25d
    t0 = time.perf_counter()
    ranks = run_ranks("train25d", math.prod(R25D["mesh"]), "gloo", tmp,
                      {"device": str(dev), "ckpt_dir": base["ckpt_dir"],
                       "last_step": base["last_step"]})
    secs["25d"] = time.perf_counter() - t0
    cfg = get_config("repro-100m")
    steps = R25D["steps"]
    fwd, bwd = R25_FWD_A_STEP * steps, R25_BWD_A_STEP * steps
    d = _check_model_axis_ranks("25d", ranks, {"flash_attention": fwd,
                                               "flash_attention_bwd": bwd},
                                {"fwd": {"wgmma": fwd, "simt": 0},
                                 "bwd": {"wgmma": bwd, "simt": 0}})
    want = base["history"]
    gaps = [abs(l - w["loss"]) / abs(w["loss"]) for l, w in zip(d["losses"], want)]
    gn_gaps = [abs(g - w["grad_norm"]) / w["grad_norm"] for g, w in zip(d["grad_norms"], want)]
    log(f"  25d: {cfg.name} on {R25D['mesh']}, {steps} steps: step-0 loss {d['losses'][0]:.6f} "
        f"/ {want[0]['loss']:.6f} (gap {gaps[0]:.3e}), worst loss gap {max(gaps):.3e}, grad "
        f"norm gaps {[f'{g:.2e}' for g in gn_gaps]}; {[round(x, 1) for x in d['ms_per_step']]} "
        f"ms a step against {base['ms_per_step']:.1f} at world 1, "
        f"{[round(x, 3) for x in d['collective_s_per_step']]} s in collectives; bytes a rank a "
        f"step {d['bytes_per_rank_per_step']}, {d['host_staged_bytes_per_step']} staged; peak "
        f"{[round(x, 3) for x in d['peak_gb']]} GB against {base['peak_bytes'] / 1e9:.3f}")
    check(gaps[0] <= R25DE_LOSS0_TOL, f"25d: step-0 loss gap {gaps[0]:.3e}")
    check(max(gaps) <= R25_TOL["loss"], f"25d: loss gap {max(gaps):.3e}")
    check(all(r["restored_step"] == base["last_step"] for r in ranks)
          and ranks[0]["restored_bits_equal"]
          and ranks[0]["restored_blocks"] == [cfg.d_model // 2, cfg.padded_vocab // 2],
          f"25d: 22d's checkpoint restored on {R25D['mesh']} does not gather back to its bits "
          f"({[r['restored_step'] for r in ranks]}, {ranks[0]['restored_blocks']})")
    out["25d"] = {**d, "world1_ms_per_step": base["ms_per_step"],
                  "world1_peak_gb": base["peak_bytes"] / 1e9, "loss_gaps": gaps,
                  "grad_norm_gaps": gn_gaps, "restored_checkpoint_bits_equal": True}
    del ranks
    # 25e: world 1 first, freed before the ranks spawn
    t0 = time.perf_counter()
    one = _r25e_trainer(dev)
    torch.cuda.reset_peak_memory_stats()
    hist1 = one.run()
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    one_ms = 1e3 * min(h["step_time_s"] for h in hist1)
    del one
    release_memory()
    secs["25e world 1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks("train25e", math.prod(R25E["mesh"]), "gloo", tmp, {"device": str(dev)})
    secs["25e"] = time.perf_counter() - t0
    cfg = get_config(R25E["arch"])
    n_sb, steps = cfg.n_layers // cfg.hybrid_period, R25E["steps"]
    e = _check_model_axis_ranks("25e", ranks, {
        "flash_attention": 2 * n_sb * steps, "flash_attention_bwd": n_sb * steps,
        "ssd_chunk": 2 * cfg.n_layers * steps, "ssd_chunk_bwd": cfg.n_layers * steps},
        {"fwd": {"wgmma": 2 * n_sb * steps, "simt": 0},
         "bwd": {"wgmma": n_sb * steps, "simt": 0}})
    for r, res in enumerate(ranks):
        gate = res["gate"]
        check(gate["flash_attention_bwd"]["calls"] == n_sb * steps
              and gate["ssd_chunk_bwd"]["calls"] == cfg.n_layers * steps,
              f"25e rank {r}: gated calls {gate}")
    gap0 = abs(e["losses"][0] - hist1[0]["loss"]) / abs(hist1[0]["loss"])
    gn = [(h["grad_norm"], g) for h, g in zip(hist1, e["grad_norms"])]
    kept = ranks[1]["kept"]  # rank 1: its query block ends at the keys' end, S < T
    fq, fk = kept["flash_attention_bwd"][0], kept["flash_attention_bwd"][1]
    check(fk.shape[2] > fq.shape[2], f"25e: rank 1's first kernel-6 backward call has q "
          f"{tuple(fq.shape)}, k {tuple(fk.shape)}: not a cp block")
    log(f"  25e: {cfg.name} on {R25E['mesh']}, {steps} steps of {R25E['batch']} x "
        f"{R25E['seq']}: step-0 loss {e['losses'][0]:.6f} / {hist1[0]['loss']:.6f} at world 1 "
        f"(gap {gap0:.3e}); grad norms (world 1, mesh) {gn}; "
        f"{[round(x, 1) for x in e['ms_per_step']]} ms a step against {one_ms:.1f} at world 1, "
        f"{[round(x, 3) for x in e['collective_s_per_step']]} s in collectives; bytes a rank a "
        f"step {e['bytes_per_rank_per_step']}, {e['host_staged_bytes_per_step']} staged; peak "
        f"{[round(x, 2) for x in e['peak_gb']]} GB against {one_peak:.2f}; gated backward "
        f"calls a rank {[r['gate'] for r in ranks]}; rank 1's cp block q {tuple(fq.shape)} "
        f"against {fk.shape[2]} keys")
    check(gap0 <= R25DE_LOSS0_TOL, f"25e: step-0 loss gap {gap0:.3e}")
    rows = {"flash_attention_bwd_cp": kept_bwd_row("flash_attention_bwd",
                                                   kept["flash_attention_bwd"], dev,
                                                   "cp block, S < T"),
            "ssd_chunk_bwd_tp": kept_bwd_row("ssd_chunk_bwd", kept["ssd_chunk_bwd"], dev,
                                             "a rank's heads")}
    out["25e"] = {**e, "world1_ms_per_step": one_ms, "world1_peak_gb": one_peak,
                  "world1_losses": [h["loss"] for h in hist1],
                  "world1_grad_norms": [h["grad_norm"] for h in hist1], "loss0_gap": gap0,
                  "init_s": [r["init_s"] for r in ranks], "gate": [r["gate"] for r in ranks],
                  "kernel_rows": rows}
    out["seconds"] = secs
    print(json.dumps(out), flush=True)
    launches = {"flash_attention_bwd": sum(r["launches"]["flash_attention_bwd"] for r in ranks),
                "ssd_chunk_bwd": sum(r["launches"]["ssd_chunk_bwd"] for r in ranks)}
    worst = {n: max(r["gate"][n]["max_abs_err"] for r in ranks) for n in launches}
    result = {}
    for key, name, kernel, source, replaces in (
            ("flash_attention_bwd_cp", "flash_attention_bwd (cp block, S < T)",
             "flash_attention_bwd", "flash_attention_bwd_wgmma.cu", "flash_attention.py:78"),
            ("ssd_chunk_bwd_tp", "ssd_chunk_bwd (a rank's heads, Zamba2)", "ssd_chunk_bwd",
             "ssd_chunk_bwd.cu", "ssd_scan.py:48")):
        row = rows[key]
        result[key] = {"name": name, "route": "cuda",
                       "source": f"src/repro_torch/kernels/csrc/{source}",
                       "replaces": f"src/repro/kernels/{replaces}",
                       "launches": launches[kernel], "max_abs_err": worst[kernel],
                       **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "device_ms", "shape")}}
    return result


# -- phase 26: LM serving across ranks with a model axis ---------------------------

# 26a: Qwen2-7B whole (28 layers, bf16, "cp") on the (1, 2) mesh; 26b:
# granite-moe-1b-a400m whole on the (2, 2) mesh (4 ranks); gloo ranks sharing
# the card, collectives staged through the host
# (cut from 8 and 4 decode steps and 4 generated tokens: the time limit)
R26_DENSE = {"arch": "qwen2-7b", "mesh": (1, 2), "batch": 4, "prompt": 1024, "budget": 2048,
             "steps": 4, "rules": "RULES_SERVE"}
R26_MOE = {"arch": "granite-moe-1b-a400m", "mesh": (2, 2), "batch": 4, "prompt": 256,
           "budget": 512, "steps": 2, "rules": "RULES_SERVE", "capacity_factor": 8.0,
           "new": 2}
# 26c: Zamba2-2.7B whole (54 Mamba layers, 9 shared blocks) on (1, 2): each
# rank its 40 of the 80 heads, the shared block's attention "cp" at hd 80;
# 26d: Mamba2-1.3B (64 heads, N 128) on (1, 2)
R26_HYBRID = {"arch": "zamba2-2.7b", "mesh": (1, 2), "batch": 4, "prompt": 1024,
              "budget": 1280, "steps": 2, "rules": "RULES_SERVE"}
# Mamba2-1.3B's bf16 logits are reported, not gated ("logits": "reported"):
# random weights carry a rounding-level change through its 48 Mamba layers
# chaotically (SERVE_LOGIT_MARGIN's finding), so the mesh's other roundings
# move its last logits by about what the control (world 1 with its ``wo``
# products rounded as the mesh rounds them) moves world 1's own, more than
# R26_TOL. The same cell in f32, where no bf16 rounding feeds the chaos, is
# gated by R26_TOL. In every ssm and hybrid cell the first Mamba layer's
# output of the prefill and of each decode step, on the same inputs and
# before any chaos, is held to the control's: the prefill's by kernel 6's
# bf16 rule, a decode step's as R26_DECODE_PRECISION says (against world
# 1's own it is reported: the two partial products' roundings alone come
# near 2^-7 of max|y|).
# Both Mamba2-1.3B cells are cut to 12 of the 48 layers at full width: the
# script passed 1,100 s with them whole (1,154.5 s on one H100 80GB HBM3 at
# 700 W whose host ran slow).
R26_SSM = {"arch": "mamba2-1.3b", "mesh": (1, 2), "batch": 4, "prompt": 512, "budget": 640,
           "steps": 4, "rules": "RULES_SERVE", "logits": "reported", "n_layers": 12}
R26_SSM_F32 = {**R26_SSM, "dtype": "float32", "logits": "gated"}
R26_TOL = LM_TOL["bfloat16"]  # phase 8's bf16 rule: 1e-1 x max|logit|
# A bf16 decode step's first Mamba layer against the control's: unlike the
# prefill's products over thousands of rows, a step's 4-row products take
# cuBLAS kernels whose f32 sum order follows the operands' widths, so the
# mesh's bf16 roundings (a rank's partial product of ``wo`` among them,
# which can exceed the sum it enters) land an ulp from the control's.
# Measured 1.30 x 2^-7 of max|y| (26c) on one H100 80GB HBM3 at 700 W, 0 on
# the CPU. Held to the bf16-operand rule, TOL["bf16_fp32acc"] = 2e-2; a
# gated norm over the rank's block alone lands 1.7-10x over it (a CPU
# rehearsal with that fault). f32 cells keep 2^-7.
R26_DECODE_PRECISION = {"bfloat16": "bf16_fp32acc", "float32": "bf16"}


def _r26_cfg(spec: dict):
    """The spec's config as registered, at the spec's capacity factor, dtype
    and depth if it names them."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    extra = {k: spec[k] for k in ("capacity_factor", "dtype", "n_layers") if spec.get(k)}
    return dataclasses.replace(cfg, **extra)


def _r26_inputs(cfg, spec: dict, dev):
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (spec["batch"], spec["prompt"]))
    return torch.as_tensor(prompts, dtype=torch.long, device=dev)


def _r26_world_one(dev, spec: dict) -> dict:
    """World 1: ``Engine(mesh=None)`` on the seeded weights: the prefill's
    logits, greedy decode steps (their tokens feed the ranks), prefill ms
    and decode ms a step, peak."""
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = _r26_cfg(spec)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    eng = Engine(cfg, params, ServeConfig(max_seq_len=spec["budget"], batch_size=spec["batch"]),
                 device=dev)
    tokens = _r26_inputs(cfg, spec, dev)
    p = spec["prompt"]
    prefill_ms = time_ms(partial(eng.prefill, params, {"tokens": tokens}), reps=2)
    mixer0 = {}
    with _first_mixer_output(mixer0):
        logits, cache = eng.prefill(params, {"tokens": tokens})
    cache = eng._pad_cache(cache, p)
    out, fed = [logits.float().cpu()], [eng._sample(logits)]
    t0 = time.perf_counter()
    for i in range(spec["steps"]):
        logits, cache = eng.decode(params, cache, {"token": fed[-1][:, None], "pos": p + i})
        out.append(logits.float().cpu())
        fed.append(eng._sample(logits))
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / spec["steps"]
    res = {"logits": out, "fed": torch.stack(fed[:-1], dim=1).cpu(),
           "greedy": torch.stack(fed, dim=1).cpu(), "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "mixer0": mixer0.get("y")}
    if cfg.family in ("ssm", "hybrid"):
        # the control: world 1 again with its Mamba layers' wo products
        # rounded as the mesh rounds them, fed the same tokens
        control0 = {}
        with (_mesh_rounding_at_world_one(spec["mesh"][1]),
              _first_mixer_output(control0, cfg.n_layers)):
            logits, cache = eng.prefill(params, {"tokens": tokens})
            cache = eng._pad_cache(cache, p)
            control = [logits.float().cpu()]
            for i in range(spec["steps"]):
                logits, cache = eng.decode(params, cache, {"token": fed[i][:, None],
                                                           "pos": p + i})
                control.append(logits.float().cpu())
        res["control"], res["control_mixer0"] = control, control0["y"]
        res["control_mixer0_steps"] = [y.cpu() for y in control0["steps"]]
    del eng, params, cache, logits
    release_memory()
    return res


def _flash_gate(records: list, keep: dict):
    """``ops.flash_attention`` wrapped: every call's output held to its plain
    version on the same inputs by the bf16 rule (``against_plain``), and
    the first call with more keys than queries (S < T) kept."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def gate(q, k, v, **kw):
        out = real(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err, limit, _, _, ok = against_plain(out.float(), want.float(), "bf16", q.shape[3])
        records.append({"s": int(q.shape[2]), "t": int(k.shape[2]), "ok": ok,
                        "over_limit": err / limit})
        if k.shape[2] > q.shape[2] and "q" not in keep:
            keep.update(q=q.cpu(), k=k.cpu(), v=v.cpu(), kw=dict(kw))
        return out

    return real, gate


@contextlib.contextmanager
def _first_mixer_output(keep: dict, per_step: int = 1):
    """The first Mamba layer's mixer output inside, f32: of a prefill in
    ``keep["y"]`` (on the host; world 1's whole, a rank's block of the
    residual's positions), and of each decode step in ``keep["steps"]`` (on
    the device, uncopied until read: a step's every ``per_step``-th call,
    its Mamba layers' count; the whole (b, 1, d) on every rank). Nothing for
    the attention families."""
    from repro_torch.models import transformer as tfm

    real, real_step = tfm.ssd_mixer, tfm.ssd_decode_step
    keep["steps"], calls = [], [0]

    def record(*args, **kw):
        out = real(*args, **kw)
        if "y" not in keep:
            keep["y"] = out[0].float().cpu()
        return out

    def record_step(*args, **kw):
        out = real_step(*args, **kw)
        if calls[0] % per_step == 0:
            keep["steps"].append(out[0].to(torch.float32, copy=True))
        calls[0] += 1
        return out

    tfm.ssd_mixer, tfm.ssd_decode_step = record, record_step
    try:
        yield keep
    finally:
        tfm.ssd_mixer, tfm.ssd_decode_step = real, real_step


@contextlib.contextmanager
def _mesh_rounding_at_world_one(n: int):
    """World 1's Mamba layers with ``wo``'s product (``mamba2._out_product``)
    taken as a mesh of ``n`` model ranks takes it: the products of ``n`` row
    blocks, each rounded to the model's dtype, summed in block order (the
    reduce-scatter's sum, or a decode step's all-reduce). The rest of world
    1's path is as it is: the movement of the logits this causes is the
    scale of a rounding-level change carried through the random weights'
    layers."""
    from repro_torch.models import mamba2

    def blocked(g, w):
        rows = w.shape[0] // n
        out = g[..., :rows] @ w[:rows]
        for i in range(1, n):
            out = out + g[..., i * rows:(i + 1) * rows] @ w[i * rows:(i + 1) * rows]
        return out

    real = mamba2._out_product
    mamba2._out_product = blocked
    try:
        yield
    finally:
        mamba2._out_product = real


def _ssd_gate(records: list, keep: dict):
    """``ops.ssd_chunk`` wrapped: every call's outputs held to its plain
    version on the same inputs by the fp32 rule (``ssd_rule``), the
    kernel's own outputs passed on, and the first call's inputs kept."""
    from repro_torch.kernels import ops, ssd_scan

    real = ops.ssd_chunk

    def gate(x, a, b, c):
        got = real(x, a, b, c)
        r = ssd_rule(got, ssd_scan.ssd_chunk_plain(x, a, b, c), x.shape[2], b.shape[3])
        records.append({"shape": list(x.shape) + [int(b.shape[3])], "ok": r["ok"],
                        "over_limit": max(r["y"]["over_limit"], r["state"]["over_limit"])})
        if "x" not in keep:
            keep.update(x=x.cpu(), a=a.cpu(), b=b.cpu(), c=c.cpu())
        return got

    return real, gate


def _serve26_job(rank, world, dev, tmp, cfg_in) -> dict:
    """One rank of phase 26: every cell of ``cfg_in["cells"]`` (one mesh
    shape) in turn, in one spawn of the ranks; each cell's results by its
    label, with its seconds and peak on this rank."""
    out = {}
    for label, spec in cfg_in["cells"]:
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out[label] = _serve26_cell(rank, dev, tmp, label, spec)
        out[label]["seconds"] = time.perf_counter() - t0
        if dev.type == "cuda":
            out[label]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        release_memory()
    return {"cells": out}


def _serve26_cell(rank, dev, tmp, label: str, spec: dict) -> dict:
    """One cell of phase 26 on this rank: the mesh, this rank's blocks of
    the seeded weights, a prefill with every kernel-6 and kernel-7 call
    gated, a timed prefill, teacher-forced decode steps fed world 1's
    tokens, and (``"new"``) an ``Engine.generate``; for the MoE, a prefill
    at the registered capacity with each layer's dropped share."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import sharding
    from repro_torch.models.model import init_params, param_pspecs
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = _r26_cfg(spec)
    rules = getattr(sharding, spec["rules"])
    mesh = make_mesh(spec["mesh"], ("data", "model"), device=dev)
    specs = param_pspecs(cfg, rules, mesh)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh=mesh,
                         specs=specs)
    torch.cuda.synchronize()
    out = {"route": mesh.route, "coords": dict(mesh.coords), "init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size() for t in param_leaves(params))}
    scfg = ServeConfig(max_seq_len=spec["budget"], batch_size=spec["batch"])
    eng = Engine(cfg, params, scfg, dev, mesh=mesh, rules=rules)
    tokens = _r26_inputs(cfg, spec, dev)
    fed = torch.load(os.path.join(tmp, f"26{label}-fed.pt")).to(dev)
    p = spec["prompt"]
    # the main path: every count starts at 0 here and is read right after
    records, keep, records7, keep7 = [], {}, [], {}
    real, gate = _flash_gate(records, keep)
    real7, gate7 = _ssd_gate(records7, keep7)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mesh.reset_counters()
    mixer0 = {}
    ops.flash_attention, ops.ssd_chunk = gate, gate7
    try:
        with _first_mixer_output(mixer0):
            logits, cache = eng.prefill(params, {"tokens": tokens})
    finally:
        ops.flash_attention, ops.ssd_chunk = real, real7
    out["prefill_launches"] = read_launches()
    out["gate"], out["gate7"] = records, records7
    out["mixer0"] = mixer0.get("y")
    out["positions"] = sharding.ServeLayout.build(mesh, rules, spec["batch"],
                                                  spec["prompt"]).positions()
    cache = eng._pad_cache(cache, p)
    reset_launches()
    steps = [logits.float().cpu()]
    mesh.reset_counters()
    mixer0_steps = {}
    t0 = time.perf_counter()
    with _first_mixer_output(mixer0_steps, cfg.n_layers):
        for i in range(spec["steps"]):
            logits, cache = eng.decode(params, cache, {"token": fed[:, i:i + 1], "pos": p + i})
            steps.append(logits.float().cpu())
    torch.cuda.synchronize()
    out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / spec["steps"]
    out["mixer0_steps"] = [y.cpu() for y in mixer0_steps["steps"]]
    out["decode_counters"] = {k: v / spec["steps"] for k, v in mesh.counters.items()}
    out["decode_launches"] = read_launches()
    del cache
    if rank == 1 and keep:
        torch.save(keep, os.path.join(tmp, f"26{label}-flash-inputs.pt"))
    if rank == 1 and keep7:
        torch.save(keep7, os.path.join(tmp, f"26{label}-ssd-inputs.pt"))
    # a warm prefill, timed on the host's clock (the staged collectives block it)
    mesh.barrier()
    mesh.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm, _ = eng.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    out["prefill_counters"] = dict(mesh.counters)
    out["warm_same_bits"] = torch.equal(warm.float().cpu(), steps[0])
    del warm
    out["digest"] = [float(x.double().sum()) for x in steps]
    if spec.get("new"):
        out["generated"] = eng.generate(tokens.cpu().numpy(), spec["new"])[:, p:]
    if cfg.family == "moe":  # each layer's dropped share at the registered capacity
        drops = []
        real_route = moe_lib.route

        def recording(cfg_, xt, wr):
            r = real_route(cfg_, xt, wr)
            drops.append(float(r.dropped_share))
            return r

        eng125 = Engine(_r26_cfg(dict(spec, capacity_factor=None)), params, scfg, dev,
                        mesh=mesh, rules=rules)
        moe_lib.route = recording
        try:
            eng125.prefill(params, {"tokens": tokens})
        finally:
            moe_lib.route = real_route
        out["dropped_share_registered"] = drops
    if rank == 0:
        torch.save(steps, os.path.join(tmp, f"26{label}-logits-r0.pt"))
    return out


SHARD_JOBS["serve26"] = _serve26_job


def flash_row_cp(inputs: dict, dev) -> dict:
    """Kernel 6 on a cp query block's inputs (S < T, from a rank's prefill),
    alone on ``dev``: :func:`flash_row`'s numbers, SDPA with the
    end-aligned causal mask as the library call."""
    q, k, v = (inputs[n].to(dev) for n in ("q", "k", "v"))
    return flash_row("cp block, S < T", q, k, v, inputs["kw"])


def _phase26_cell(dev, card: str, label: str, spec: dict, tmp: str, one: dict,
                  ranks: list) -> dict:
    """26a-26d-f32's gates and numbers from world 1's run ``one`` and the
    ranks' results ``ranks`` (see the module's docstring)."""
    world = math.prod(spec["mesh"])
    cfg = _r26_cfg(spec)
    ssm_family = cfg.family in ("ssm", "hybrid")
    got = torch.load(os.path.join(tmp, f"26{label}-logits-r0.pt"))
    gated = spec.get("logits") != "reported"  # see R26_SSM
    gaps, control = [], []
    for i, (a, b) in enumerate(zip(got, one["logits"])):
        scale = float(b.abs().max())
        gaps.append(float((a - b).abs().max()) / scale)
        if ssm_family:  # world 1's own movement under the control (see R26_SSM)
            control.append(float((one["control"][i] - b).abs().max()) / scale)
        check(bool(torch.isfinite(a).all()) and (gaps[-1] <= R26_TOL or not gated),
              f"26{label} step {i}: logits {gaps[-1]:.3e} of max|logit| from world 1's, "
              f"limit {R26_TOL:.3e}")
    layer0, layer0_world1, layer0_steps = [], [], []
    for r, res in enumerate(ranks) if ssm_family else ():
        # the first Mamba layer on the same inputs, before any chaos: against
        # the control's (the mesh's rounding of wo at world 1) by the bf16 rule
        p0, p1 = res["positions"]
        err, lim, _, _, ok = against_plain(res["mixer0"], one["control_mixer0"][:, p0:p1],
                                           "bf16", cfg.d_inner)
        layer0.append(err / lim)
        check(ok, f"26{label} rank {r}: the first Mamba layer's output {err:.3e} from the "
                  f"control's, limit {lim:.3e}")
        err1, lim1, _, _, _ = against_plain(res["mixer0"], one["mixer0"][:, p0:p1], "bf16",
                                            cfg.d_inner)
        layer0_world1.append(err1 / lim1)
        # and in every decode step: the cut state, the conv on the rank's
        # channels, h on its heads, wo's all-reduced row blocks
        check(len(res["mixer0_steps"]) == spec["steps"] == len(one["control_mixer0_steps"]),
              f"26{label} rank {r}: {len(res['mixer0_steps'])} decode steps' first Mamba "
              f"layer kept")
        for i, (y, want) in enumerate(zip(res["mixer0_steps"], one["control_mixer0_steps"])):
            err, lim, _, _, ok = against_plain(y, want, R26_DECODE_PRECISION[cfg.dtype],
                                               cfg.d_inner)
            layer0_steps.append(err / lim)
            check(ok, f"26{label} rank {r} decode step {i}: the first Mamba layer's output "
                      f"{err:.3e} from the control's, limit {lim:.3e}")
    check(all(r["digest"] == ranks[0]["digest"] for r in ranks),
          f"26{label}: the ranks' logits differ")
    check(all(r["warm_same_bits"] for r in ranks), f"26{label}: a warm prefill gave other bits")
    agree = [float((g.argmax(-1) == w).float().mean())
             for g, w in zip(got, one["greedy"].unbind(1))]
    # one kernel-6 launch an attention layer (the hybrid: a shared block) and
    # one kernel-7 launch a Mamba layer, on the rank's heads, a prefill
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = (cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid"
            else 0 if cfg.family == "ssm" else cfg.n_layers)
    want = {k: v for k, v in (("flash_attention", attn), ("ssd_chunk", ssd)) if v}
    n = spec["mesh"][1]
    heads = cfg.ssm_nheads // n if cfg.ssm_nheads % n == 0 else cfg.ssm_nheads
    chunk = min(cfg.ssm_chunk, spec["prompt"])
    ssd_shape = [spec["batch"] // spec["mesh"][0] * heads, -(-spec["prompt"] // chunk), chunk,
                 cfg.ssm_headdim, cfg.ssm_state]
    for r, res in enumerate(ranks):
        check(res["route"] == "gloo-host-staged", f"26{label} rank {r}: route {res['route']}")
        launches = {k: v for k, v in res["prefill_launches"].items() if v}
        check(launches == want, f"26{label} rank {r}: prefill launches {launches}, want {want}")
        check(not any(res["decode_launches"].values()),
              f"26{label} rank {r}: decode launched {res['decode_launches']}")
        gate, gate7 = res["gate"], res["gate7"]
        check(len(gate) == attn and all(g["ok"] for g in gate),
              f"26{label} rank {r}: kernel 6 against its plain version: {gate}")
        check(len(gate7) == ssd and all(g["ok"] and g["shape"] == ssd_shape for g in gate7),
              f"26{label} rank {r}: kernel 7 against its plain version at {ssd_shape}: {gate7}")
    shapes = [sorted({(g["s"], g["t"]) for g in r["gate"]}) for r in ranks]
    row, row7 = {}, {}
    flash_in = os.path.join(tmp, f"26{label}-flash-inputs.pt")
    if os.path.exists(flash_in):
        row = flash_row_cp(torch.load(flash_in), dev)
        os.remove(flash_in)
        log(f"  26{label} kernel 6 at S < T: {json.dumps(row)}")
    ssd_in = os.path.join(tmp, f"26{label}-ssd-inputs.pt")
    if os.path.exists(ssd_in):
        k7 = torch.load(ssd_in)
        os.remove(ssd_in)
        row7 = ssd_row(f"26{label} rank 1's heads",
                       *(k7[name].to(dev) for name in ("x", "a", "b", "c")))
        log(f"  26{label} kernel 7 on a rank's heads: {json.dumps(row7)}")
    res = {
        "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "mesh": list(spec["mesh"]), "rules": spec["rules"],
        "attn_partitioning": cfg.attn_partitioning, "batch": spec["batch"],
        "prompt": spec["prompt"], "budget": spec["budget"], "decode_steps": spec["steps"],
        "seconds": {"world1": one["seconds"], "ranks": [r["seconds"] for r in ranks]},
        "prefill_ms": {"1": one["prefill_ms"], str(world): [r["prefill_ms"] for r in ranks]},
        "decode_ms_per_step": {"1": one["decode_ms"],
                               str(world): [r["decode_ms"] for r in ranks]},
        "logit_gap_of_max": gaps, "logit_limit_of_max": R26_TOL if gated else None,
        "control_gap_of_max": control or None, "layer0_over_limit_by_rank": layer0 or None,
        "layer0_against_world1_over_limit_by_rank": layer0_world1 or None,
        "layer0_decode_over_limit_worst": max(layer0_steps, default=None),
        "greedy_agree": agree,
        "prefill_collectives_by_rank": [r["prefill_counters"] for r in ranks],
        "decode_collectives_per_step_by_rank": [r["decode_counters"] for r in ranks],
        "peak_gb": {"1": one["peak_gb"], str(world): [r.get("peak_gb") for r in ranks]},
        "param_gb_by_rank": [r["param_bytes"] / 1e9 for r in ranks],
        "init_s_by_rank": [r["init_s"] for r in ranks],
        "kernel6_launches_per_rank_per_prefill": [r["prefill_launches"]["flash_attention"]
                                                  for r in ranks],
        "kernel6_shapes_by_rank": shapes,
        "kernel6_worst_over_limit": max((g["over_limit"] for r in ranks for g in r["gate"]),
                                        default=None),
        "kernel6_cp_row": row,
        "kernel7_launches_per_rank_per_prefill": [r["prefill_launches"]["ssd_chunk"]
                                                  for r in ranks],
        "kernel7_shape": ssd_shape if ssd else None,
        "kernel7_worst_over_limit": max((g["over_limit"] for r in ranks for g in r["gate7"]),
                                        default=None),
        "kernel7_tp_row": row7}
    if spec.get("new"):
        want = one["greedy"][:, :spec["new"]].numpy()
        res["generate_greedy_agree"] = [float((r["generated"] == want).mean()) for r in ranks]
        check(all(np.array_equal(r["generated"], ranks[0]["generated"]) for r in ranks),
              f"26{label}: the ranks generated different tokens")
    if "dropped_share_registered" in ranks[0]:
        res["dropped_share_at_registered_capacity"] = {
            "capacity_factor": _r26_cfg(dict(spec, capacity_factor=None)).capacity_factor,
            "by_rank": [r["dropped_share_registered"] for r in ranks]}
    limit = f"limit {R26_TOL:.3g}" if gated else "reported"
    log(f"  26{label}: {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) on {spec['mesh']}: "
        f"logits within {max(gaps):.3e} of world 1's ({limit}); "
        f"greedy agree {agree}; prefill {one['prefill_ms']:.1f} ms "
        f"at world 1, {[round(r['prefill_ms'], 1) for r in ranks]} at world {world}; decode "
        f"{one['decode_ms']:.2f} / {[round(r['decode_ms'], 2) for r in ranks]} ms a step")
    return res


def _r26_row(name: str, source: str, replaces: str, launches: int, row: dict) -> dict:
    """A kernels-line row from a cell's timed call."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape")},
            **({"kv_len": row["kv_len"]} if "kv_len" in row else {})}


def phase26_serve_ranks(dev, card: str) -> dict:
    """26a-26d-f32 (see the module's docstring). Returns the kernels line's
    rows: kernel 6 at a cp block's shapes (S < T) of 26a and of 26c (D 80,
    no GQA), kernel 7 on a rank's heads of 26c."""
    out = {"phase": "26 serving across ranks", "card": card, "spawn_s": {}}
    cells = (("a", R26_DENSE), ("b", R26_MOE), ("c", R26_HYBRID), ("d", R26_SSM),
             ("d-f32", R26_SSM_F32))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve26_") as tmp:
        ones, by_rank = {}, {}
        for label, spec in cells:  # world 1 of every cell first: its tokens feed the ranks
            t0 = time.perf_counter()
            ones[label] = _r26_world_one(dev, spec)
            ones[label]["seconds"] = time.perf_counter() - t0
            torch.save(ones[label]["fed"], os.path.join(tmp, f"26{label}-fed.pt"))
        # one spawn of the ranks a mesh shape runs all its cells in turn
        for shape in dict.fromkeys(spec["mesh"] for _, spec in cells):
            group = [(label, spec) for label, spec in cells if spec["mesh"] == shape]
            t0 = time.perf_counter()
            ranks = run_ranks("serve26", math.prod(shape), "gloo", tmp,
                              {"device": str(dev), "cells": group})
            out["spawn_s"][str(shape)] = time.perf_counter() - t0
            for label, _ in group:
                by_rank[label] = [r["cells"][label] for r in ranks]
        for label, spec in cells:
            res = _phase26_cell(dev, card, label, spec, tmp, ones[label], by_rank[label])
            res["phase_s"] = ones[label]["seconds"] + max(r["seconds"] for r in by_rank[label])
            out[f"26{label}"] = res
            log(f"  26{label}: {res['phase_s']:.1f} s (world 1 and the ranks' own time)")
    print(json.dumps(out), flush=True)
    rows = {}
    for key, cell, which, name, source, replaces, count in (
            ("flash_attention_cp", "26a", "kernel6_cp_row", "flash_attention (cp block, S < T)",
             "flash_attention_wgmma.cu", "flash_attention.py:78", "kernel6"),
            ("flash_attention_cp_d80", "26c", "kernel6_cp_row",
             "flash_attention (Zamba2's cp block, D 80, S < T)", "flash_attention_wgmma.cu",
             "flash_attention.py:78", "kernel6"),
            ("ssd_chunk_tp", "26c", "kernel7_tp_row", "ssd_chunk (a rank's heads, Zamba2)",
             "ssd_chunk.cu", "ssd_scan.py:48", "kernel7")):
        row = out[cell][which]
        check(bool(row), f"{cell}: no {name} call was kept")
        rows[key] = _r26_row(name, source, replaces,
                             sum(out[cell][f"{count}_launches_per_rank_per_prefill"]), row)
    return rows


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
