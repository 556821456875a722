#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and check them:
multi-tenant LoRA co-serving decode and multi-task LoRA/Adapter/IA3
fine-tuning on llama3.2-3b (each on a bf16 and on an int8 backbone),
multi-task fine-tuning and decode on the hybrid zamba2-2.7b (Mamba2 +
shared attention; bf16 and int8), fine-tuning and decode of all eight PEFT
kinds, the online co-serving service (MuxTuneService) under tenant churn,
the fleet tier (FleetRouter over several services: routing, live
migration, crash recovery, autoscaling), training and serving of the MoE
family on full-size deepseek-moe-16b, and of starcoder2-7b (attention
biases, the GELU MLP), serving of yi-34b, training and serving of the vlm
family (qwen2-vl-7b: M-RoPE, qkv biases) and of the audio family
(whisper-large-v3: the encoder, cross-attention, LayerNorm), and training
and serving of the ssm family (xlstm-1.3b: mLSTM and sLSTM blocks, the
three mamba_scan kernels tiled for its [1024, 1025] state; bf16 and int8)
at full size.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each (several for the kernel phases).  The kernel
phases run alone on the card; then the main paths of ``PATHS_BESIDE[0]``
run here while a second process (``chip_smoke.py --paths ...``) runs
those of ``PATHS_BESIDE[1]`` on the same card (its lines follow when it
ends), and last ``PATHS_ALONE`` here alone; a ``seconds`` line gives each
part's wall seconds:

1. device        -- nvidia-smi name and power limit, torch and CUDA versions;
2. build, ptxas, -- nvcc builds every kernel under src/repro_torch/csrc;
   sass             each kernel's registers and spill bytes from ptxas;
                    the tensor-core instruction (HGMMA for the wgmma
                    kernel, HMMA for the mma.sync ones) counted in every
                    instantiation's SASS by cuobjdump;
3. kernels       -- each forward kernel against its plain PyTorch version at
                    the serving path's full-width bf16 shapes, with times
                    (CUDA events, median of 25 runs, L2 flushed before each,
                    and the profiler's device time); decode attention also
                    at Smax 1000 and 2048 and on a misaligned q;
                    quant_matmul at every BaseOp shape of the decode step
                    (M = 8), the bind prefill (4096) and the training step
                    (2816), and a ragged one, with the backward's plain dx
                    product timed at the training shapes; then M = 1, 8,
                    64, 65 and 300 across its route and cluster switches,
                    and x and scale at misaligned offsets, each run twice
                    for the same bits; packed attention at the bind's
                    prefill behind a prefix tenant's 16 rows padded to 64
                    (R = 4, buckets 128 and 512) and decode attention over
                    the pool's cache with the windows the soft-prompt fold
                    opens (Smax = 64 + 1024, starts 0-64), each twice for
                    the same bits and timed beside masked SDPA;
4. train_kernels -- at the training paths' shapes (one fused micro-batch of
                    11 rows x 256 from the planner): for llama3.2-3b the
                    forwards that save h / the logsumexp, the grouped LoRA
                    backward and the packed attention dq and dk/dv kernels,
                    each against autograd of the plain version, with times
                    (the backward's pair kernel and per-task reduction
                    also apart, the reduction beside its own byte bound);
                    grouped LoRA at stack ranks 8 to 320 (the kernels'
                    rank tiles) and on 64-row tiles whose rows change task,
                    the backward at M = 2856 with an empty slot, and the
                    backward run twice for the same bits;
                    packed attention on edge layouts and on
                    q, k, v at a misaligned storage offset;
                    for zamba2-2.7b grouped LoRA at the Mamba2 projections
                    (2560 -> 10448, 5120 -> 2560) and the shared block's
                    q / v, packed attention at dh = 80, and the three
                    mamba_scan kernels (forward, state and chunk backward)
                    at 80 heads of 64, also in a four-chunk carry case with
                    resets and a non-zero initial state, and unmasked, each
                    run twice for the same bits, with each kernel's
                    registers, spills, shared memory and blocks per SM;
5. serve         -- llama3.2-3b at full width and depth, random weights from
                    a seed, four LoRA tenants on one stacked adapter set;
                    eight greedy requests bound by one batched prefill and
                    generated to completion through PEFTEngine, with the
                    kernels' launch counts checked and a profile of three
                    micro steps; then serve_check, a teacher-forced rerun on
                    the kernels and on the plain versions, logits compared,
                    beside a second plain path (``plain_split``: decode
                    attention in the Pallas kernel's split order) whose
                    distance from the first is the check's noise floor;
6. train         -- llama3.2-3b at full width and depth, seed-0 backbone,
                    tenants sst2:lora:8, qa:lora:16, rte:adapter:8, sst2:ia3
                    planned into one hTask; one warm-up and six timed
                    PEFTEngine.run_iteration calls, launch counts checked
                    against the plan, one iteration profiled;
7. train_check   -- one step's per-task losses and adapter gradients from one
                    state, on the kernels and on the plain versions, beside
                    two second plain paths (``plain_stored_o``: packed
                    attention's backward reading D from the stored bf16 o,
                    as the Pallas kernels do; ``plain_reordered``: grouped
                    LoRA's and packed attention's f32 sums in another
                    order) whose distances from the first are the check's
                    noise floor;
8. serve_int8, train_int8, train_check_int8 -- phases 5-7 again with
                    ``backbone_dtype="int8"``: every BaseOp product goes
                    through the quant_matmul kernel; the serve phase also
                    reports the backbone's bytes and how many greedy tokens
                    agree with the bf16 run's; both checks also run a second
                    plain path (the scale applied before the sum) whose
                    distance from the first is their noise floor, and the
                    train check runs on six seeded states;
9. train_zamba, train_check_zamba -- phases 6-7 on zamba2-2.7b at full
                    width and depth (54 layers: 9 super-blocks of 5 Mamba2
                    blocks and the shared attention+MLP block), the same
                    tenants on ssm_in, ssm_out, attn_q and attn_v; the plain
                    runs of the check recompute each super-block in the
                    backward (see ``plain_path``);
10. train_methods, train_check_methods -- llama3.2-3b (bf16, full width,
                    ``METHODS_LAYERS`` of 28 layers) with one
                    tenant of each of the eight PEFT kinds on the attention
                    sites (one hTask of 27 rows x 256; the prefix tenant's 16
                    rows padded to 64 key rows): one warm-up iteration, then
                    five steps under the port's TrainSupervisor, checkpointed
                    every two steps into a temporary directory with a
                    simulated failure before step 3; the state restored at
                    the rollback must equal a host copy taken at the save
                    bit for bit, every artifact's keys the state's, the
                    frozen leaves (VeRA's A / B, Diff-Pruning's rows) stay
                    put and the launch counts match the plan; then
                    train_check on this path (its plain runs recompute each
                    layer in the backward).  The train_kernels phase holds
                    packed attention's three kernels at this path's prefix
                    shape too (case ``prefix_train``).
11. serve_methods -- llama3.2-3b (bf16, full width, ``COSERVE_LAYERS`` of 28
                    layers) with one
                    tenant of each PEFT kind on an 8-row pool (max_len
                    1024, one row per kind, prompts of 64-512 tokens, 32
                    greedy tokens): the prefix row's window opened over its
                    folded k/v rows, launches per micro step, and a
                    teacher-forced check (with the fold) whose gate comes
                    from this path's own two plain paths (``_gate_from``);
12. coserve      -- MuxTuneService on llama3.2-3b (bf16, full width,
                    ``COSERVE_LAYERS`` of 28 layers) through the churn of
                    the JAX service test (LoRA,
                    Prefix-Tuning, DoRA and VeRA tenants: queueing,
                    cancellation, completion with checkpoint-out and
                    compaction, a warm start) with eight decode requests
                    interleaved into the training iterations; per iteration
                    device ms, decode tokens, host syncs, lifecycle seconds
                    and the memory peak; gates on A's losses against a solo
                    run, B's artifact bit for bit, every request's tokens
                    against the plain path's replay of the same decode.
13. fleet        -- FleetRouter over MuxTuneService instances of llama3.2-3b
                    (bf16, full width, ``FLEET_LAYERS`` of 28 layers, one
                    backbone each) in one
                    process: three LoRA / Adapter tenants routed against
                    the lockstep ClusterSim oracle, one live-migrated with
                    requests in flight, the instance of another killed (it
                    waits for capacity, the autoscaler spawns an instance
                    under that queue pressure, and it resumes there from
                    its step-4 cadence artifact with its in-flight request
                    re-created), a scale-down once the fleet is idle; eight
                    greedy requests; per fleet step wall s, device ms,
                    instances, residents, decode tokens, utilization and
                    the memory peak, per event its seconds; gates on the
                    oracle, every tenant's and request's end, the migrated
                    and the recovered tenant's losses against solo runs,
                    the launches of every training iteration and decode
                    operation, each instance's decode against the plain
                    replay, and the fleet.* span trace;
14. fleet_int8   -- a bf16 and an int8 instance under backbone_affine:
                    tenants route by backbone label, train to completion,
                    quant_matmul on the int8 instance's path;
15. train_moe    -- phase 6 on deepseek-moe-16b at full width and depth (28
                    layers, d = 2048, 64 routed experts top-6 and 2 shared,
                    16.9 B parameters, random bf16 weights from a seed), the
                    tenants on q, v and the shared experts' up / down; then
                    one iteration run twice from one state (the same bits
                    in the losses, the adapter and optimizer state and the
                    routes), the tokens dropped per layer and the
                    load-balance loss the engine added to the loss.  The
                    moe_kernels lines (in the kernel phases) hold kernels
                    1-7 at this model's shapes: grouped LoRA at the
                    shared-expert sites, packed and decode attention with
                    one query head per k/v head, quant_matmul at its BaseOp
                    shapes;
16. train_check_moe -- phase 7 on it, gated at MOE_GRAD_PATH_TOL (set from
                    this path's own plain-path spread), the f32 run widening
                    one layer's weights at a time, the routing flips of each
                    run against the plain one;
17. serve_moe    -- phase 5 on it, at 14 of its 28 layers
                    (``MOE_SERVE_LAYERS``): four LoRA tenants on the seven attention
                    and shared-expert sites, 32 greedy tokens a row; the
                    teacher-forced check's gate set from this path's own
                    ``plain_split`` spread (``_gate_from``) before the kernel
                    path runs; the routing flips, the tokens dropped per
                    layer at the bind, the micro step's device ms beside the
                    floor of reading every expert's weights;
18. serve_moe_int8 -- phase 17 on an int8 backbone (attention and shared
                    experts int8, routed experts bf16): quant_matmul
                    launches, the backbone's bytes against Eq. 5.
19. serve_zamba, serve_zamba_int8 -- zamba2-2.7b at full width and 30 of
                    its 54 layers (``ZAMBA_SERVE_LAYERS``: 5 super-blocks)
                    on a bf16 and on an int8 backbone: four LoRA tenants on
                    the Mamba2 projections and the shared block's q / v,
                    eight rows, prompts of 16-64 tokens fed through
                    Model.decode_step, 32 greedy tokens; launches per step,
                    the logits against the plain path's (gate from its own
                    second plain path), the kernels' decode against their
                    own forward within twice the plain path's distance; on
                    int8 the backbone's bytes beside Eq. 5's clamp.  The
                    kernel phases hold decode attention at dh = 80 and
                    quant_matmul at zamba2's shapes (N = 10,448: a partial
                    tile on both routes), and the mamba_scan kernels at this
                    path's forward (one chunk of 95 rows);
20. train_zamba_int8 -- phases 6-7 on zamba2-2.7b's int8 backbone, gated at
                    ZAMBA_INT8_GRAD_PATH_TOL;
21. train_starcoder2, serve_starcoder2 -- starcoder2-7b at full width and
                    depth, its q/k/v/o biases filled with random values:
                    phases 6-7 with the tenants on q, v, fc1 and fc2 (gate
                    STARCODER2_GRAD_PATH_TOL), then phase 5's shape through
                    PEFTEngine on all six sites at 16 of its 32 layers
                    (``STARCODER2_SERVE_LAYERS``), gated from its own
                    plain_split spread.  The kernel phases hold grouped LoRA
                    at fc1 / fc2, packed attention (forward, dq, dk/dv) at 9
                    query heads per k/v head and decode attention there;
22. serve_yi     -- yi-34b (68.78 GB of bf16 weights) at full width and depth
                    through PEFTEngine: four LoRA tenants on the seven sites,
                    prompts of 64-256, 16 greedy tokens; the f32 rerun
                    widens a layer at a time; the peaks beside the card's
                    memory.  The kernel phases hold grouped LoRA at yi's
                    sites and decode attention at 7 query heads per k/v
                    head.
23. train_qwen2vl, serve_qwen2vl -- qwen2-vl-7b at full width and depth
                    (28 layers, d = 3584, H = 28, Hkv = 4, dh = 128), its
                    q/k/v/o biases filled random: phases 6-7 with the
                    tenants on q, v, up and down (training batches carry no
                    M-RoPE channels: plain RoPE, as in the JAX package; gate
                    QWEN2VL_GRAD_PATH_TOL), then phase 5's shape through
                    PEFTEngine on its seven sites at 14 of its 28 layers
                    (``QWEN2VL_SERVE_LAYERS``), the bind's prefill (and
                    the teacher-forced rerun's) carrying the prompt's three
                    M-RoPE channels, gated from its own plain_split spread.
                    The kernel phases hold grouped LoRA at its sites, packed
                    attention (forward, dq, dk/dv) at 7 query heads per k/v
                    head on the training layout and its forward at the
                    bind's 8 x 512, and decode attention at those heads;
24. serve_whisper -- whisper-large-v3 at full width, its 32 encoder layers
                    and 16 of its 32 decoder layers (``WHISPER_SERVE_LAYERS``;
                    d = 1280, H = Hkv = 20, dh = 64), every bias
                    filled: the encoder once over random
                    frames [8, 1500, 1280] into the fixed cross caches, four
                    LoRA tenants on the decoder's six sites, prompts of
                    16-64 fed through Model.decode_step (no audio prefill),
                    32 greedy tokens; launches per step (decode attention
                    twice a layer, grouped LoRA at q and o twice), the
                    logits against the plain path's (gate from its own
                    plain_split), the f32 guard, the decode against its own
                    forward within twice the plain path's distance;
25. train_whisper, train_check_whisper -- whisper through the model-level
                    launch.steps.build_train_step (PEFTEngine's batches
                    carry no frames): the LoRA / Adapter / IA3 tenants on
                    the decoder's q, v, fc1 and fc2, 8 rows of 256 tokens
                    beside 1500 frames each, a warm-up and six steps,
                    launches per step checked, then phase 7 on it (gate
                    WHISPER_GRAD_PATH_TOL).  The kernel phases hold grouped
                    LoRA at its sites (q twice a decoder layer), packed
                    attention at the encoder (8 x 1500, non-causal), at the
                    decoder's self-attention and at the cross-attention (256
                    queries over 1500 frames, non-causal: the packed
                    attention kernels with one segment a row), forward, dq
                    and dk/dv, and decode attention at its heads and over
                    the whole 1500-row cross cache.
26. serve_xlstm  -- xlstm-1.3b at full width and 16 of its 48 blocks
                    (``XLSTM_SERVE_LAYERS``: 2 of 6 super-blocks of 7 mLSTM
                    and 1 sLSTM): four
                    LoRA tenants on the mLSTM's ssm_in, q and v and the
                    sLSTM's ssm_in, prompts of 16-64 fed through
                    Model.decode_step (no prefill, as in the JAX package),
                    32 greedy tokens (95 steps) over 1.88 GB of mLSTM
                    states; launches per step, the teacher-forced logits
                    against the plain path's (gate from plain_reordered's
                    spread), Model.forward over the same tokens on the tiled
                    mamba_scan (14 calls) against the decode, and every
                    kernel call of that forward and of two decode steps held
                    to its plain version (``audited_calls``).  The kernel
                    phases (``xlstm_kernels``) hold the tiled forward at
                    (dk, dv) = (1024, 1025), padded to 1088, against the
                    plain version: the training shape (8 x 256, resets), a
                    two-chunk carry case with a random h0 and the entry
                    states, and this path's forward (8 x 95), each twice for
                    the same bits, no spill; and grouped LoRA at its sites;
                    then the tiled state and chunk backward against their
                    plain versions and against autograd of the plain forward:
                    the train_xlstm path's shape (its plan's reset rows, one
                    chunk, no dh0), a two-chunk carry case with h0, dhf and
                    dh0 (also through ops.mamba_scan under autograd) and a
                    four-chunk case with resets, each twice for the same
                    bits, no spill;
27. train_xlstm, train_check_xlstm -- phases 6-7 on xlstm-1.3b at full width
                    and depth (48 blocks), the tenants on the mLSTM's ssm_in,
                    q and v and the sLSTM's ssm_in: per micro step 42 calls
                    of each tiled scan kernel and 132 grouped LoRA; the
                    check's plain runs recompute each mLSTM block, gate
                    XLSTM_GRAD_PATH_TOL, and an audit holds every tiled-scan
                    and grouped-LoRA call of one step to its plain version
                    (on this model's random weights the gradient gate cannot
                    tell a fault from chaos).
28. serve_xlstm_int8, train_xlstm_int8 -- phases 26-27 on xlstm-1.3b's int8
                    backbone (the mLSTM's up, q, k, v and down and the
                    sLSTM's in and out int8, 3.77 GB at full depth where
                    Eq. 5 prices 1.01 GB, JAX's clamp): every BaseOp through
                    quant_matmul, 37 products a super-block (serve at 16
                    blocks: 74 a decode step and in the forward; train at
                    48: 222 a micro step), the second plain path
                    ``plain_scale_first``, gates from each path's own
                    spread (train: XLSTM_INT8_GRAD_PATH_TOL), and the audit
                    holding every quant_matmul call too.  The xlstm_kernels
                    lines hold quant_matmul at this model's four (K, N).
29. multi_rank   -- last and alone (``PATHS_LAST``): two processes on
                    cuda:0 joined by gloo through a FileStore (NCCL refuses
                    two ranks on one device), so it checks the sharded math
                    at full width with the kernels inside each rank against
                    one rank on the same card, and measures no NCCL
                    behaviour, link bandwidth or multi-card speed.  The
                    gloo probe (each ``GLOO_CUDA_OPS`` entry marked direct,
                    run on CUDA tensors); ``ep_moe``: deepseek-moe-16b at 14
                    of 28 layers, 32 of its 64 experts a rank, one
                    run_iteration of train_moe's tenants under
                    ``experts="model"`` against rank 0's single-rank one
                    (losses at 1%, gradients at max(MOE_GRAD_PATH_TOL, 2 S),
                    S plain_reordered's distance from plain), and the a2a
                    branch and its int8 wire against the local branch with
                    no token dropped; ``cp_attention``: llama3.2-3b's
                    attention at B 2 x S 8192, striped over the ranks,
                    against the packed-attention kernel on one rank (gates
                    max(the kernel gate, 2 S), S from a second block size);
                    ``pipeline``: llama3.2-3b as 2 stages of 14 layers, 4
                    micro-batches, against pipeline_reference; ``psum_tree``
                    of the train path's LoRA gradients with and without
                    ``compress`` (the int8 formula exact).  Each rank's
                    device ms, collective and staged bytes by op and peak
                    memory; the kernels' launches of the multi-rank runs
                    (the single-rank references not counted).

The whole script is held to ``TIME_BUDGET_S`` (1,200 s) on one card.
Every line of phases 11-25 and of their kernel cases carries the card's
name and power limit (``"card"``).  Then the seconds line, a {"kernels":
[...]} line and last {"ok": true, "device": {...}}.  Any failure raises
(in the second process too): the script exits non-zero and prints no ok
line.  Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:8,sst2:ia3"
# the hybrid tenants' sites: the Mamba2 projections and the shared block's q, v
ZAMBA_TARGETS = ("ssm_in", "ssm_out", "attn_q", "attn_v")
# the MoE paths (deepseek-moe-16b): the training tenants on two attention and
# two shared-expert sites; the serving tenants on the seven attention and
# shared-expert sites
MOE_ARCH = "deepseek-moe-16b"
MOE_TARGETS = ("attn_q", "attn_v", "shared_mlp_up", "shared_mlp_down")
MOE_SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "shared_mlp_gate", "shared_mlp_up",
             "shared_mlp_down")
# the hybrid serving paths (serve_zamba, serve_zamba_int8): 8 rows, prompts of
# 16-64 tokens fed through Model.decode_step (the hybrid family has no
# prefill), then 32 greedy tokens: the longest prompt sets the steps
ZAMBA_SERVE_ROWS, ZAMBA_SERVE_NEW, ZAMBA_SERVE_PROMPTS = 8, 32, (16, 64)
ZAMBA_SERVE_STEPS = ZAMBA_SERVE_PROMPTS[1] + ZAMBA_SERVE_NEW - 1
# the ssm family's serving path (serve_xlstm): xlstm-1.3b at full width and
# depth, its tenants on the mLSTM's up-projection and q / v (an ssm_out
# tenant cannot run on the sLSTM blocks), the zamba2 path's traffic
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_TARGETS = ("ssm_in", "attn_q", "attn_v")
XLSTM_HEADS, XLSTM_DK = 4, 1024  # the mLSTM's heads and head width (dv = dk + 1)
XLSTM_SERVE_STEPS = ZAMBA_SERVE_STEPS
# the serving paths cut in depth at full width, host-bound (their seconds grow
# with the layers' launches), so that the script with the vlm, audio and ssm
# paths stays inside TIME_BUDGET_S on a slow host: zamba2's decode at 5 of its
# 9 super-blocks (30 of 54 layers), deepseek-moe-16b's at 14 of 28 layers,
# whisper's at 16 of its 32 decoder layers (the encoder whole), starcoder2-7b's
# at 16 of 32, qwen2-vl-7b's at 14 of 28 and xlstm-1.3b's at 16 of 48 blocks (2
# of 6 super-blocks, cut from 3 to pay for the multi_rank phase; train_xlstm
# runs all 48); their gates come from each run's own plain paths
ZAMBA_SERVE_LAYERS, MOE_SERVE_LAYERS, WHISPER_SERVE_LAYERS = 30, 14, 16
STARCODER2_SERVE_LAYERS, QWEN2VL_SERVE_LAYERS, XLSTM_SERVE_LAYERS = 16, 14, 16
# starcoder2-7b (the GELU fc1 / fc2 MLP, attention biases): the training
# tenants on q, v, fc1 and fc2; the serving tenants on all six sites
STARCODER2_ARCH = "starcoder2-7b"
STARCODER2_TARGETS = ("attn_q", "attn_v", "mlp_fc1", "mlp_fc2")
STARCODER2_SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_fc1", "mlp_fc2")
# yi-34b serves only (its 68.8 GB bf16 backbone leaves no room on one card
# for training activations): the serving tenants on its seven sites
YI_ARCH = "yi-34b"
# one tenant of each PEFT kind on the attention sites (the train_methods path)
METHODS_TASKS = ("sst2:lora:8,qa:adapter:8,rte:ia3,sst2:prefix:16,qa:diff:16,rte:dora:8,"
                 "sst2:vera:64,qa:bitfit")
# the supervised loop: steps, checkpoint cadence, the step a failure precedes
METHODS_STEPS, METHODS_CKPT_EVERY, METHODS_FAIL_AT = 5, 2, 3
# qwen2-vl-7b (M-RoPE, qkv biases, 7 query heads per k/v head at dh = 128):
# the training tenants on q, v, up and down; the serving tenants on its seven
# sites (SITES).  Its training batches carry no M-RoPE channels (plain RoPE,
# as in the JAX package); the bind builds them.
QWEN2VL_ARCH = "qwen2-vl-7b"
QWEN2VL_TARGETS = ("attn_q", "attn_v", "mlp_up", "mlp_down")
# whisper-large-v3 (32 encoder and 32 decoder layers, d = 1280, dh = 64): the
# training tenants (TRAIN_TASKS, two rows each) on the decoder's q, v, fc1 and
# fc2, 8 rows of 256 tokens beside 1500 frames each; the serving tenants on
# the decoder's six sites, 8 rows, prompts of 16-64 fed through decode_step
# (the audio family has no prefill), then 32 greedy tokens
WHISPER_ARCH = "whisper-large-v3"
WHISPER_TARGETS = ("attn_q", "attn_v", "mlp_fc1", "mlp_fc2")
WHISPER_SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_fc1", "mlp_fc2")
WHISPER_TRAIN_ROWS, WHISPER_TRAIN_LEN = 8, 256
WHISPER_SERVE_ROWS, WHISPER_SERVE_NEW, WHISPER_SERVE_PROMPTS = 8, 32, (16, 64)
WHISPER_SERVE_STEPS = WHISPER_SERVE_PROMPTS[1] + WHISPER_SERVE_NEW - 1
# The wall seconds the whole script is held to on one card, the kernels'
# build included: the limit of a run (the seconds line reports it beside the
# total).  train_methods and the two fleet paths run llama3.2-3b at full
# width and half its depth: host-bound paths, cut to stay inside it (as
# COSERVE_LAYERS).
TIME_BUDGET_S = 1200
# the whole script's seconds as predicted before the run that adds the
# multi_rank phase (about 120 s) and cuts serve_xlstm / serve_xlstm_int8 to 16
# blocks (about 45 s off their groups), from 783.8 s (a fast host) and 993.2 s
# (a slow one) before them
PREDICTED_TOTAL_S = {"fast_host": 860, "slow_host": 1070}
METHODS_LAYERS = FLEET_LAYERS = 14
# the kinds whose adapter delta runs through the grouped-LoRA kernel
GROUPED_LORA_KINDS = ("lora", "dora")
# the kernels of a training micro step (forward and backward)
TRAIN_KERNELS = ("grouped_lora", "grouped_lora_bwd", "packed_attention", "packed_attention_dq",
                 "packed_attention_dkv")
TRAIN_MICRO_BATCH = 8
TRAIN_LR = 2e-3
TRAIN_ITERS = 6
# bf16 keeps 8 significant bits: a kernel and its plain version that sum in
# f32 in different orders may round one output a unit in the last place
# apart, i.e. up to 2**-8 of its magnitude.  Two such units at the largest
# magnitude bound every element.
KERNEL_TOL = 2 * 2.0 ** -8
# Logits after 28 bf16 layers: every layer rounds its residual stream, and
# the kernels round their outputs after f32 sums taken in another order than
# the plain versions, so per-layer differences of a few units in the last
# place compound over the 64 teacher-forced steps.  Two plain paths that
# differ only in the order of decode attention's f32 sums (``plain_split``:
# the Pallas kernel's split order; no kernel involved) came S = 4.143% of
# the largest logit apart at their worst step (mean 3.40%), bit for bit in
# two runs made before the decode-attention and grouped-LoRA kernels were
# redesigned (NVIDIA H100 80GB HBM3, 700 W), while the kernel path sat
# 4.95% from the plain one: the former 5% gate lay inside the noise of two
# right answers.  The gate is the larger of 5% and
# 2 S (two such spreads), rounded up to 0.005: 8.5%.  It stays far below a
# routing, masking or cache fault (an error of the order of the logits); the
# f32 guard holds the kernel path to the plain path's accuracy.
LOGIT_TOL = 0.085
# On the int8 backbone the BaseOp products differ between the two paths too
# (kernel vs plain int8 product, where the bf16 paths share one cuBLAS
# product), so more roundings compound.  Two plain int8 paths that differ
# only in where the scale is applied (after the sum, as the Pallas kernel
# does, or before it, as the JAX xla tier does) came 5.3% of the largest
# logit apart over serve_check_int8's 64 steps on an H100, the kernel path
# 5.0% from the plain one: a 5% gate lay inside the noise of two right
# answers.  10% bounds the sum of two such spreads and stays far below a
# fault; the f32 guard holds the kernel path to the plain path's accuracy.
INT8_LOGIT_TOL = 0.10
# Kernel gradients against autograd of the plain versions, per output: two
# bf16 units as above, doubled for packed attention, whose backward reads
# D = rowsum(do * o) from the forward's bf16 o (as the Pallas kernel does)
# where autograd differentiates the plain version's f32 o: a relative 2**-9
# error in D enters every ds.
GRAD_TOL = {"grouped_lora_bwd": KERNEL_TOL, "packed_attention_dq": 2 * KERNEL_TOL,
            "packed_attention_dkv": 2 * KERNEL_TOL, "mamba_scan_bwd_chunk": KERNEL_TOL}
# f32 outputs (h, lse): sums in another order, a few f32 units of the largest
# magnitude.
F32_TOL = 1e-5
# One training step through 28 bf16 layers, kernels against plain versions.
# The per-task losses are means over ~500 tokens of log-softmax values
# whose logits differ by bf16 roundings compounded over the layers (as
# LOGIT_TOL): 1% of the loss.  An adapter leaf's gradient carries those
# roundings forward and then back through the layers, in each of the two
# bf16 paths, so their difference may reach the sum of two such spreads
# (GRAD_PATH_TOL, measured below, of the leaf's largest |g|).  A third run,
# the plain versions on f32 weights, is the reference both bf16 paths are
# measured against: the kernel path's worst leaf must stay within twice the
# plain path's.  A routing, masking or slot fault gives errors of the order
# of the value.
LOSS_TOL = 0.01
# The gate is measured against second right answers, plain paths with no
# kernel: ``plain_stored_o`` (packed attention's backward reading D from the
# stored bf16 o, as the Pallas and CUDA kernels do) and ``plain_reordered``
# (grouped LoRA's and packed attention's f32 contractions, forward and
# backward, each summed as two halves).  Over token seeds 0-9
# (train_check_spread.py, PYTHONHASHSEED=0, run twice, bit for bit alike,
# on the kernels of the tree before the mamba_scan state backward's
# redesign, NVIDIA H100 80GB HBM3, 700 W) they came 0.0251-0.0486 (S) and
# 0.0536-0.0843 (S') of a leaf's largest |g| from the plain path, and the
# kernel path 0.0539-0.1179: seed 8's adapter.attn_o.down at 0.1179 is
# nearer two plain paths' own distance than it is to a fault.  Swapping
# packed attention's plain version in alone brought every seed to 0.0587 or
# less, since packed attention is the only kernel on the Adapter and IA3
# tenants' rows; no packed-attention or grouped-LoRA call on any seed was
# further from its plain version than its kernel tolerance (the worst:
# forward 0.0065 against 0.0078, dq 0.0119 against 0.0156).  The gate is
# the larger of 10%, 2 S and 2 S', rounded up to 0.005: 2 S' = 0.1685.
GRAD_PATH_TOL = 0.17
# On the int8 backbone the forward's BaseOp products differ between the two
# paths as well (see INT8_LOGIT_TOL).  Over the six seeded states of
# train_check_int8 on an H100 two plain int8 paths that differ only in where
# the scale is applied came 5.8-11.0% of a leaf's largest |g| apart, and the
# kernel path 5.8-7.7% from the plain one: GRAD_PATH_TOL lies inside that
# noise.  20% bounds the sum of two such spreads; the f32 guard holds the
# kernel path to the plain path's accuracy.  The int8 check runs on each of
# INT8_CHECK_SEEDS.
INT8_GRAD_PATH_TOL = 0.20
INT8_CHECK_SEEDS = (3, 4, 5, 6, 7, 8)
# On zamba2-2.7b (54 layers: 45 bf16 scans and the shared block 9 times)
# each bf16 path sits further from the f32 run than on llama.  Set, as
# GRAD_PATH_TOL was, from the two second plain paths before the kernel path
# was gated: over token seeds 0-9 (``PYTHONHASHSEED=0 python3
# train_check_spread.py . 10 zamba``, NVIDIA H100 80GB HBM3, 700.00 W) they
# came 0.0228-0.0344 (S, ``plain_stored_o``) and 0.0597-0.0934 (S',
# ``plain_reordered``) of a leaf's largest |g| from the plain path, and the
# kernel path 0.0622-0.0807.  max(10%, 2 S, 2 S') rounded up to 0.005:
# 2 S' = 0.1868 -> 0.19 (it was 20%, set from two runs).
ZAMBA_GRAD_PATH_TOL = 0.19
# train_check_methods (one tenant of each of the eight PEFT kinds on
# llama3.2-3b, bf16, 27 rows x 256): set, as GRAD_PATH_TOL was, from the
# two second plain paths before the kernel path was gated.  Over token
# seeds 0-9 (``PYTHONHASHSEED=0 python3 train_check_spread.py . 10
# methods``, NVIDIA H100 80GB HBM3, 700.00 W) they came 0.0294-0.0336 (S,
# ``plain_stored_o``) and 0.0573-0.0790 (S', ``plain_reordered``) of a
# leaf's largest |g| from the plain path, and the kernel path 0.0576-0.0722;
# no grouped-LoRA or packed-attention call on any seed was further from its
# plain version than its kernel tolerance.  max(10%, 2 S, 2 S') rounded up
# to 0.005: 2 S' = 0.158 -> 0.16.
METHODS_GRAD_PATH_TOL = 0.16
# train_check_moe (deepseek-moe-16b, bf16, the training tenants on q, v and
# the shared experts' up / down, 11 rows x 256): set, as GRAD_PATH_TOL was,
# from its own two second plain paths before the kernel path was gated.
# A routing flip (a token whose top-6 set differs between two paths) moves
# that token's output by far more than a bf16 unit, and random weights
# leave the router's 64 probabilities close together, so flips are common:
# over token seeds 0-7 (``PYTHONHASHSEED=0 python3 train_check_spread.py .
# 8 moe``, NVIDIA H100 80GB HBM3, 700.00 W) ``plain_reordered`` flipped
# 7,404-9,878 of the 78,848 (layer, token) pairs against the plain path and
# the kernel path 8,323-9,568; they came 0.0220-0.0323 (S,
# ``plain_stored_o``, no flip) and 0.0981-0.1326 (S') of a leaf's largest
# |g| from the plain path, and the kernel path 0.1019-0.1287.  No
# grouped-LoRA call was further from its plain version than its kernel
# tolerance; packed attention's dq was on 5 of 224 calls (worst 0.0193
# against 0.0156).  max(10%, 2 S, 2 S') rounded up to 0.005: 2 S' =
# 0.2652 -> 0.27.
MOE_GRAD_PATH_TOL = 0.27
# train_check_zamba_int8 (zamba2-2.7b on the int8 backbone) and
# train_check_starcoder2 (starcoder2-7b, bf16): each set, as GRAD_PATH_TOL
# was, from its own second plain paths before the kernel path was gated,
# over token seeds 0-9 (``train_check_spread.py . 10 zamba_int8`` /
# ``starcoder2``, NVIDIA H100 80GB HBM3, 700.00 W).  zamba2 int8:
# ``plain_scale_first`` came 0.0773-0.1009 (S') from the plain path, the
# kernel path 0.0735-0.1220; 2 S' = 0.2018 -> 0.205.  starcoder2, its
# q/k/v/o biases filled random as its paths run it: ``plain_stored_o``
# 0.0196-0.0265 (S), ``plain_reordered`` 0.0271-0.0400 (S'), the kernel
# path 0.0290-0.0534; 2 S' = 0.080, under the 10% floor of
# max(10%, 2 S, 2 S').
ZAMBA_INT8_GRAD_PATH_TOL = 0.205
STARCODER2_GRAD_PATH_TOL = 0.10
# train_check_qwen2vl (qwen2-vl-7b, bf16, its q/k/v/o biases filled random,
# the training tenants on q, v, up and down) and train_check_whisper
# (whisper-large-v3, every bias filled, the tenants on the decoder's q, v,
# fc1 and fc2): each set, as GRAD_PATH_TOL was, from its own second plain
# paths before the kernel path was gated, over token seeds 0-9
# (``train_check_spread.py . 10 qwen2vl`` / ``whisper``, NVIDIA H100 80GB
# HBM3, 700.00 W).  qwen2-vl: ``plain_stored_o`` 0.0411 (S),
# ``plain_reordered`` 0.0852 (S'), the kernel path 0.0588-0.1078; 2 S' =
# 0.1705 -> 0.175.  whisper (its frames from the seed too): S = 0.0273,
# ``plain_reordered`` 0.0252, the kernel path 0.0199-0.0304; 2 S = 0.0545,
# under the 10% floor of max(10%, 2 S, 2 S').
QWEN2VL_GRAD_PATH_TOL = 0.175
WHISPER_GRAD_PATH_TOL = 0.10
# train_check_xlstm (xlstm-1.3b, bf16, the training tenants on the mLSTM's
# ssm_in, q and v and the sLSTM's ssm_in): set, as GRAD_PATH_TOL was, from its
# own second plain path before the kernel path was gated.  Over token seeds
# 0-9 (``PYTHONHASHSEED=0 python3 train_check_spread.py . 10 xlstm``, NVIDIA
# H100 80GB HBM3, 700.00 W) ``plain_reordered`` came 1.2766-2.3280 (S') of a
# leaf's largest f32 |g| from the plain path, the plain path 4.1939 from the
# f32 run, and the kernel path 2.7801-4.7375 from the plain one: on random
# weights this model's gradients are chaotic (a bf16 unit grows past the
# gradient's own size over 48 blocks, as its logits do, ``serve_xlstm``), so
# the gate catches nothing and the audit of every kernel call
# (``train_check_xlstm``) is the check that counts.  The kernel path went
# past 2 S' on one seed of ten (seed 7, mlstm.lora.attn_v.b: 4.7375), so
# the path trains on seeded batches (``XLSTM_DATA_SEED``) and its check
# starts from the same state in every run.  Every audited call of the ten
# seeds was inside its tolerance, and the per-task losses of the kernel
# path within 0.22% of the plain path's (the f32 run's within 0.32%).
# max(10%, 2 S') rounded up to 0.005: 2 S' = 4.6560 -> 4.66.
XLSTM_GRAD_PATH_TOL = 4.66
XLSTM_DATA_SEED = 0
# train_check_xlstm_int8 (xlstm-1.3b on the int8 backbone): set, as the bf16
# gate was, from its own second plain paths before the kernel path was gated.
# Over token seeds 0-9 (``PYTHONHASHSEED=0 python3 train_check_spread.py . 10
# xlstm_int8``, numpy-seeded streams, seed 0 the state this path checks;
# NVIDIA H100 80GB HBM3, 700.00 W) ``plain_scale_first`` came 1.6784-3.7601
# (S') of a leaf's largest f32 |g| from the plain path, ``plain_reordered``
# 1.0460-2.0774, the plain path 1.5164-2.3449 from the f32 run, and the
# kernel path 1.8521-2.8687 from the plain one (1.8521 on seed 0): as chaotic
# as on bf16, so the audit, which now holds every quant_matmul call too, is
# the check that counts (none over on any seed; the int8 products' worst
# 0.0065 against 0.0078).  max(10%, 2 S') rounded up to 0.005: 2 S' = 7.5203
# -> 7.525.
XLSTM_INT8_GRAD_PATH_TOL = 7.525
# The int8 backbone's bytes against the cost model's Eq. 5 term, which
# counts the BaseOp weights at one byte and the rest at two but not the f32
# scales (0.1% of the backbone at full width).
BACKBONE_BYTES_TOL = 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of ``fn`` in ms, L2 flushed before each run."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, runs: int = 25, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def compare(out, ref, what: str, rel_tol: float = KERNEL_TOL):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel_tol * scale
    ok = err <= tol
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} > tol {tol}")
    return err, (err / scale if scale else 0.0), tol


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def profile_device(torch, fn, n: int, groups):
    """Device time by kernel over ``n`` calls of ``fn``, the device's busy
    share of the wall time, and launches per call.  ``groups`` maps a group
    name to substrings of kernel names; the rest is "matmul" (cuBLAS) or
    "other".  Only the device's activity is recorded: the host's op events
    are not read, and recording them costs host seconds on a path of many
    small launches (xlstm-1.3b's training iteration launches 121,340
    kernels).  ``profile_seconds``: the profile's own wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = (us / 1e3 / n, e.count / n)
    by_group = {g: 0.0 for g in list(groups) + ["matmul", "other"]}
    for name, (ms, _) in kernels.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), None)
        if g is None:
            g = "matmul" if any(w in name.lower() for w in
                                ("gemm", "gemv", "cutlass", "xmma", "nvjet")) else "other"
        by_group[g] += ms
    device_ms = sum(by_group.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"calls": n, "profile_seconds": time.perf_counter() - t_prof,
            "wall_ms_per_call": wall_ms,
            "device_ms_per_call": device_ms if kernels else None,
            "device_busy_share": device_ms / wall_ms if kernels else None,
            "kernel_launches_per_call": sum(c for _, c in kernels.values()),
            "device_ms_by_group": by_group,
            "top_kernels": [{"name": k[:80], "ms_per_call": v[0], "calls_per_call": v[1]}
                            for k, v in top]}


def _profile_kernels(torch, body, n: int):
    """Device microseconds by kernel name over ``n`` calls of ``body``."""
    from torch.profiler import ProfilerActivity, profile

    body()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            body()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def launch_device_ms(torch, timer, fn, key: str, n: int = 5) -> dict:
    """Device time per call of each kernel whose name holds ``key``, by the
    kernel's own name (a call of several launches, each apart), from the
    profiler, L2 flushed before each call.  Where a kernel takes less time
    than the host needs to launch it, the CUDA-event time of a call
    (``Timer``) counts the device's wait for the launch; this does not.  The
    profiler now and then reports no kernel at all: up to three tries, else
    {}."""
    import re

    for _ in range(3):
        out = {}
        for name, us in _profile_kernels(torch, lambda: (timer.flush.zero_(), fn()), n).items():
            if key in name and us > 0:
                m = re.search(r"[A-Za-z_]\w*_kernel", name)
                short = m.group(0) if m else name[:60]
                out[short] = out.get(short, 0.0) + us / 1e3 / n
        if out:
            return out
    return {}


def kernel_device_ms(torch, timer, fn, key: str, n: int = 5):
    """The device time per call of the kernels whose names hold ``key``
    (``launch_device_ms`` summed), or None where the profiler reports none."""
    by_name = launch_device_ms(torch, timer, fn, key, n)
    return sum(by_name.values()) if by_name else None


def call_memory(torch, fn) -> dict:
    """Device memory of one call of ``fn``: its peak above what was
    allocated before it (``peak_bytes``, its outputs included), the bytes of
    the tensors it returns (``output_bytes``) and the difference, the call's
    scratch (``scratch_bytes``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outs = out if isinstance(out, (tuple, list)) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in outs if t is not None)
    del out, outs
    return {"peak_bytes": peak, "output_bytes": nbytes, "scratch_bytes": peak - nbytes}


def library_device_ms(torch, timer, fn, n: int = 5):
    """Device time per call of every kernel ``fn`` launches (a library call
    whose kernel names are not known beforehand), L2 flushed before each
    call; the flush's own kernels, found by profiling it alone, are left
    out.  Up to three tries, else None (as ``kernel_device_ms``)."""
    flush = set(_profile_kernels(torch, timer.flush.zero_, 1))
    for _ in range(3):
        us = sum(t for name, t in _profile_kernels(
            torch, lambda: (timer.flush.zero_(), fn()), n).items() if name not in flush)
        if us > 0:
            return us / 1e3 / n
    return None


def kernel_phase(torch, timer):
    """Each kernel against its plain version at the serving path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.grouped_lora import grouped_lora_cuda, grouped_lora_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    dev = "cuda"
    results = {}

    # ---- grouped LoRA: T = 4 tenants at stack rank 64, some rows -1 ----
    T, r = 4, 64
    batch_tasks = [0, 1, 2, 3, 0, 1, 2, -1]
    per_shape = {}
    for M in (8, 4096):
        rt = torch.tensor(batch_tasks, dtype=torch.int32, device=dev).repeat_interleave(M // 8)
        scale = torch.tensor([2.0, 1.0, 2.0, 0.5], dtype=torch.float32, device=dev)
        present = len({t for t in batch_tasks if t >= 0})
        active_rows = int((rt >= 0).sum().item())
        for d_in, d_out in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
            x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
            a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
            b = (torch.randn((T, r, d_out), generator=g, device=dev) * 0.02).to(bf16)
            out = grouped_lora_cuda(x, a, b, rt, scale)
            ref = grouped_lora_plain(x, a, b, rt, scale)
            torch.cuda.synchronize()
            if out[rt < 0].abs().max().item() != 0.0:
                raise AssertionError("grouped_lora: a row_task = -1 row is not exactly 0")
            err, rel, tol = compare(out, ref, f"grouped_lora M={M} {d_in}x{d_out}")
            ms = timer(lambda: grouped_lora_cuda(x, a, b, rt, scale))
            dev_ms = kernel_device_ms(torch, timer, lambda: grouped_lora_cuda(x, a, b, rt, scale),
                                      "grouped_lora_pair")
            plain_ms = timer(lambda: grouped_lora_plain(x, a, b, rt, scale))
            nbytes = 2 * (M * d_in + present * r * (d_in + d_out) + M * d_out) + 4 * (M + T)
            flops = 2.0 * active_rows * r * (d_in + d_out)
            bms, by = bound_ms(nbytes, flops)
            per_shape[(M, d_in, d_out)] = (ms, plain_ms, bms, dev_ms, err)
            emit({"phase": "kernels", "kernel": "grouped_lora", "M": M, "d_in": d_in,
                  "d_out": d_out, "T": T, "r": r, "max_abs_err": err, "max_rel_err": rel,
                  "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                  "bound_ms": bms, "bound_by": by, "library_ms": None})
    # one layer of one decode step: the seven LoRA sites at M = 8
    layer = [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072), (3072, 8192),
             (3072, 8192), (8192, 3072)]
    sums = [sum(per_shape[(8, di, do)][i] for di, do in layer) for i in range(3)]
    devs = [per_shape[(8, di, do)][3] for di, do in layer]
    results["grouped_lora"] = {
        "shape": "M=8, T=4, r=64: the seven LoRA sites of one layer of one decode step (sum)",
        "ms": sums[0], "device_ms": None if None in devs else sum(devs), "plain_ms": sums[1],
        "bound_ms": sums[2], "bound_by": "bytes", "library_ms": None,
        "max_abs_err": max(v[4] for v in per_shape.values())}

    # ---- packed attention: prefill shape, plain and with a 16-row prefix ----
    B, S, H, Hkv, dh, P = 8, 512, 24, 8, 128, 16
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf16)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf16)
    pk = torch.randn((B, P, Hkv, dh), generator=g, device=dev).to(bf16)
    pv = torch.randn((B, P, Hkv, dh), generator=g, device=dev).to(bf16)
    keep = torch.tensor([1, 0, 1, 0, 1, 1, 0, 1], device=dev, dtype=torch.float32)[:, None]
    keep = keep.expand(B, P).contiguous()
    pa_err = 0.0
    for name, kw in (("causal", {}), ("prefix16", {"prefix_kv": (pk, pv), "prefix_keep": keep})):
        out = ops.packed_attention(q, k, v, **kw)
        with ops.force_plain():
            ref = ops.packed_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err, rel, tol = compare(out, ref, f"packed_attention {name}")
        pa_err = max(pa_err, err)
        ms = timer(lambda: ops.packed_attention(q, k, v, **kw))
        with ops.force_plain():
            plain_ms = timer(lambda: ops.packed_attention(q, k, v, **kw))
        pairs = B * S * (S + 1) // 2
        Sk = S
        if name == "prefix16":
            pairs += int(keep.sum().item()) * S
            Sk = S + P
        nbytes = 2 * (2 * B * S * H * dh + 2 * B * Sk * Hkv * dh) + 4 * 2 * B * (S + Sk)
        flops = 4.0 * dh * H * pairs
        bms, by = bound_ms(nbytes, flops)
        lib_ms = dev_ms = lib_dev_ms = None
        if name == "causal":
            dev_ms = kernel_device_ms(torch, timer, lambda: ops.packed_attention(q, k, v),
                                      "packed_attention_fwd")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
            lib_ms = timer(sdpa)
            lib_dev_ms = library_device_ms(torch, timer, sdpa)
        emit({"phase": "kernels", "kernel": "packed_attention", "case": name, "B": B, "S": S,
              "Sk": Sk, "H": H, "Hkv": Hkv, "dh": dh, "max_abs_err": err, "max_rel_err": rel,
              "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms,
              "bound_by": by, "library_ms": lib_ms, "library_device_ms": lib_dev_ms})
        if name == "causal":
            results["packed_attention"] = {
                "shape": f"B={B}, S={S}, H={H}, Hkv={Hkv}, dh={dh}, causal",
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
    # the kernel's non-causal branch (not on the serving path): checked only
    out = ops.packed_attention(q, k, v, causal=False)
    with ops.force_plain():
        ref = ops.packed_attention(q, k, v, causal=False)
    err, rel, tol = compare(out, ref, "packed_attention not causal")
    emit({"phase": "kernels", "kernel": "packed_attention", "case": "not_causal",
          "max_abs_err": err, "max_rel_err": rel, "tol": tol})
    results["packed_attention"]["max_abs_err"] = max(pa_err, err)

    results["decode_attention"] = decode_kernel_case(torch, timer, g, H, Hkv, dh)
    return results


def decode_kernel_case(torch, timer, g, H, Hkv, dh, model=None):
    """Decode attention against its plain version: 8 rows over a 1024-row
    cache with mixed windows (the serving path's shape), timed beside SDPA
    over the whole cache under the window mask; then the edge cases.
    ``model`` names another model's heads in the lines."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    dev, bf16 = "cuda", torch.bfloat16
    Bd, Smax = 8, 1024
    qd = torch.randn((Bd, 1, H, dh), generator=g, device=dev).to(bf16)
    kc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    vc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    start = torch.tensor([0, 0, 100, 0, 0, 0, 512, 0], dtype=torch.int32, device=dev)
    end = torch.tensor([1024, 700, 513, 300, 65, 1, 900, 0], dtype=torch.int32, device=dev)
    out = ops.decode_attention(qd, kc, vc, end, start)
    with ops.force_plain():
        ref = ops.decode_attention(qd, kc, vc, end, start)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all() or out[7].abs().max().item() != 0.0:
        raise AssertionError("decode_attention: the empty window is not finite zeros")
    err, rel, tol = compare(out, ref, "decode_attention")
    ms = timer(lambda: ops.decode_attention(qd, kc, vc, end, start))
    with ops.force_plain():
        plain_ms = timer(lambda: ops.decode_attention(qd, kc, vc, end, start))
    pos = torch.arange(Smax, device=dev)
    mask = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])
    qt = qd.transpose(1, 2).contiguous()
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    dev_ms = kernel_device_ms(torch, timer, lambda: ops.decode_attention(qd, kc, vc, end, start),
                              "decode_attention_kernel")

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)
    lib_ms = timer(sdpa)
    lib_dev_ms = library_device_ms(torch, timer, sdpa)
    window = int((end - start).clamp_min(0).sum().item())
    nbytes = 2 * (2 * Bd * H * dh + 2 * window * Hkv * dh) + 4 * 2 * Bd
    bms, by = bound_ms(nbytes, 4.0 * H * dh * window)
    tag = {"model": model, "card": card()} if model else {}
    emit({"phase": "kernels", "kernel": "decode_attention", **tag, "B": Bd, "Smax": Smax,
          "H": H, "Hkv": Hkv, "dh": dh, "window_rows": window, "max_abs_err": err,
          "max_rel_err": rel, "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
          "library_device_ms": lib_dev_ms})
    return {
        "shape": f"B={Bd}, Smax={Smax}, H={H}, Hkv={Hkv}, dh={dh}, {window} window rows",
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
        "max_abs_err": max(err, _decode_edge_cases(torch, g, H, Hkv, dh, tag))}


def _decode_edge_cases(torch, g, H, Hkv, dh, tag=None):
    """Decode attention through ``ops.decode_attention`` against the plain
    version where the kernel's splits meet their edges, one line each:
    Smax = 1000 (the last split partly masked), Smax = 2048 (the split
    widened to 256 rows, two chunks a block, so that a cluster holds 8
    blocks) and q as a view two bytes past a 16-byte boundary, which ops
    hands the kernel as an aligned copy.  Windows reach into the last split,
    start mid-split, hold one row or none (finite zeros).  One launch each.
    Returns the largest error."""
    from repro_torch.kernels import ops

    bf16, dev, Bd = torch.bfloat16, "cuda", 8
    worst = 0.0
    for case, Smax in (("smax1000", 1000), ("smax2048", 2048), ("misaligned_q", 1024)):
        kc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
        vc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
        if case == "misaligned_q":
            base = torch.randn((Bd * H * dh + 1,), generator=g, device=dev).to(bf16)
            qd = base[1:].view(Bd, 1, H, dh)
            if qd.data_ptr() % 16 == 0:
                raise AssertionError("decode_attention case misaligned_q: q is 16-byte aligned")
        else:
            qd = torch.randn((Bd, 1, H, dh), generator=g, device=dev).to(bf16)
        start = torch.tensor([0, 0, 100, 0, 5, 0, Smax // 2 + 3, 0], dtype=torch.int32,
                             device=dev)
        end = torch.tensor([Smax, Smax - 1, 513, 300, 6, 1, Smax - 24, 0], dtype=torch.int32,
                           device=dev)
        before = ops.launch_counts()["decode_attention"]
        out = ops.decode_attention(qd, kc, vc, end, start)
        launched = ops.launch_counts()["decode_attention"] - before
        with ops.force_plain():
            ref = ops.decode_attention(qd, kc, vc, end, start)
        torch.cuda.synchronize()
        if launched != 1:
            raise AssertionError(f"decode_attention case {case}: {launched} launches, want 1")
        if not torch.isfinite(out.float()).all() or out[7].abs().max().item() != 0.0:
            raise AssertionError(f"decode_attention case {case}: the empty window is not "
                                 f"finite zeros")
        err, rel, tol = compare(out, ref, f"decode_attention case {case}")
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "decode_attention", **(tag or {}), "case": case,
              "B": Bd,
              "Smax": Smax, "H": H, "Hkv": Hkv, "dh": dh, "q_data_ptr_mod_16": qd.data_ptr() % 16,
              "max_abs_err": err, "max_rel_err": rel, "tol": tol})
    return worst


QMM_SHAPES = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))  # (K, N)
# one layer's BaseOp sites: q, k, v, o, gate, up, down
QMM_LAYER = ((3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072), (3072, 8192),
             (3072, 8192), (8192, 3072))
QMM_M = {"decode": 8, "prefill": 4096, "train": 2816}


# the tensor-core instruction each kernel built on the tensor cores must
# hold in its machine code, every instantiation: (library, kernel, opcode);
# decode attention runs on the CUDA cores
SASS_EXPECT = (("quant_matmul", "qmm_wgmma_kernel", "HGMMA"),
               ("quant_matmul", "qmm_mma_kernel", "HMMA"),
               ("grouped_lora", "grouped_lora_pair_kernel", "HMMA"),
               ("grouped_lora", "grouped_lora_reduce_kernel", "HMMA"),
               ("packed_attention", "packed_attention_fwd_kernel", "HMMA"),
               ("packed_attention", "packed_attention_dq_kernel", "HMMA"),
               ("packed_attention", "packed_attention_dkv_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_fwd_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_bwd_state_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_bwd_chunk_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_bwd_state_tiled_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_scores_kernel", "HGMMA"),
               ("mamba_scan", "mamba_scan_states_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_outputs_kernel", "HMMA"),
               ("mamba_scan", "mamba_scan_bwd_scores_kernel", "HGMMA"),
               ("mamba_scan", "mamba_scan_bwd_outputs_kernel", "HMMA"))


def sass_phase() -> None:
    """Each tensor-core kernel's SASS (``cuobjdump``) holds its tensor-core
    instruction in every instantiation: fails otherwise.  One line with
    the counts."""
    from repro_torch.kernels import _build

    by_lib = {}
    rows = []
    for lib, kernel, op in SASS_EXPECT:
        if lib not in by_lib:
            by_lib[lib] = _build.sass_opcodes(lib, ("HGMMA", "HMMA"))
        found = {fn: c[op] for fn, c in by_lib[lib].items() if kernel in fn}
        if not found or min(found.values()) == 0:
            raise AssertionError(f"sass: {kernel} in {lib}.cu lacks {op}: {found}")
        rows.append({"source": f"{lib}.cu", "kernel": kernel, "opcode": op,
                     "instantiations": len(found), "counts": sorted(found.values())})
    emit({"phase": "sass", "kernels": rows})


def quant_kernel_phase(torch, timer, shapes=QMM_SHAPES, layer=QMM_LAYER, model=None,
                       layer_what="the seven BaseOp products of one layer"):
    """quant_matmul against its plain version at every (M, K, N) of the int8
    paths, and a ragged shape; the backward's dx product at the training
    shapes.  The yardstick is ``torch._weight_int8pack_mm`` where the card's
    PyTorch has it, else cuBLAS bf16 on the dequantized weight, which is
    timed beside it in any case (the bf16 backbone's product).  ``model``
    names another model's (K, N) ``shapes`` and ``layer`` (``layer_what``
    says what the sum is): its lines carry the name, the ragged and edge
    cases are left to the default run, and the entry is
    ``quant_matmul_<model>``.  A shape whose N is not a multiple of the
    kernels' 128-column tiles ends in a partial tile on both routes."""
    from repro_torch.kernels import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(4)
    dev, bf16 = "cuda", torch.bfloat16
    library = None
    per_shape = {}
    ragged_err = 0.0
    for path, M in QMM_M.items():
        for K, N in tuple(shapes) + ((40, 72),) * (path == "decode" and model is None):
            Mx = 5 if K == 40 else M
            x = torch.randn((Mx, K), generator=g, device=dev).to(bf16)
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            scale = torch.rand((N,), generator=g, device=dev) * 2e-4 + 1e-4
            out = qm.quant_matmul_cuda(x, q, scale)
            ref = qm.quant_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            err, rel, tol = compare(out, ref, f"quant_matmul M={Mx} K={K} N={N}")
            _same_bits(torch, out, qm.quant_matmul_cuda(x, q, scale), f"quant_matmul M={Mx}")
            line = {"phase": "kernels", "kernel": "quant_matmul", "path": path, "M": Mx,
                    "K": K, "N": N, "plan": list(qm.plan_of(x, q, scale)[0]),
                    "max_abs_err": err, "max_rel_err": rel, "tol": tol,
                    **({"model": model, "card": card()} if model else {})}
            if K == 40:  # the ragged case: checked only
                ragged_err = err
                emit(line)
                continue
            ms = timer(lambda: qm.quant_matmul_cuda(x, q, scale))
            dev_ms = kernel_device_ms(torch, timer, lambda: qm.quant_matmul_cuda(x, q, scale),
                                      "qmm_")
            plain_ms = timer(lambda: qm.quant_matmul_plain(x, q, scale))
            if library is None:
                try:
                    torch._weight_int8pack_mm(x, q.t().contiguous(), scale.to(bf16))
                    torch.cuda.synchronize()
                    library = "torch._weight_int8pack_mm"
                except (RuntimeError, NotImplementedError):
                    library = "torch.matmul bf16 on the dequantized weight"
            w = (q.float() * scale).to(bf16)
            cublas_ms = timer(lambda: torch.matmul(x, w))
            del w
            if library.startswith("torch._weight"):
                # far slower than the kernel at large M: fewer runs there
                qt, sb = q.t().contiguous(), scale.to(bf16)
                lib_ms = timer(lambda: torch._weight_int8pack_mm(x, qt, sb),
                               *((25, 3) if Mx <= 64 else (5, 1)))
            else:
                lib_ms = cublas_ms
            work = {"bytes": K * N + 2 * Mx * (K + N) + 4 * N, "flops": 2.0 * Mx * K * N}
            bms, by = bound_ms(work["bytes"], work["flops"])
            times = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "cublas_bf16_dequantized_ms": cublas_ms}
            line.update({**times, "bound_ms": bms, "bound_by": by, "library": library})
            if path == "train":  # the backward's plain contraction, as the path runs it
                gy = torch.randn((Mx, N), generator=g, device=dev).to(bf16)
                line["dx_plain_ms"] = timer(lambda: qm.quant_matmul_dx(gy, q, scale, bf16))
            per_shape[(path, K, N)] = {**times, **work, "max_abs_err": err}
            emit(line)
    results = {}
    for path in QMM_M:
        sites = [per_shape[(path, K, N)] for K, N in layer]
        total = {key: None if any(v[key] is None for v in sites) else sum(v[key] for v in sites)
                 for key in sites[0]}  # (a device time the profiler did not see is None)
        bms, by = bound_ms(total.pop("bytes"), total.pop("flops"))
        total["max_abs_err"] = max(v["max_abs_err"] for (p, _, _), v in per_shape.items()
                                   if p == path)
        results[path] = {
            "shape": f"M={QMM_M[path]}: {layer_what} (sum)",
            **total, "bound_ms": bms, "bound_by": by, "library": library}
    out = results["decode"]
    if model is None:
        out["max_abs_err"] = max(out["max_abs_err"], ragged_err, _quant_edge_cases(torch, g))
    out["prefill_variant"], out["train_variant"] = results["prefill"], results["train"]
    return {"quant_matmul" + (f"_{model}" if model else ""): out}


def _same_bits(torch, a, b, what: str) -> None:
    """Two runs of a kernel on the same inputs: the same bits (fixed-order sums)."""
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two runs on the same inputs differ")


def _quant_edge_cases(torch, g):
    """quant_matmul across its route and cluster switches: M = 1, 8, 64
    (mma.sync, K split over clusters), 65 and 300 (wgmma, a ragged token
    tile) at (K, N) = (8192, 3072) and (3072, 1024), and the ragged
    (40, 72) at M = 300 (element loads); then x, and scale, as views at a
    misaligned storage offset at M = 8 and 2816, through
    ``ops.quant_matmul`` (which copies them aligned: wgmma above 64 rows)
    and straight into the wrapper (mma.sync: element loads for x, scalar
    reads of scale).  Each against the plain version, run twice for the
    same bits, one launch each.  One line each, with the plan the wrapper
    ran; returns the largest error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm

    dev, bf16 = "cuda", torch.bfloat16
    worst = 0.0

    def case(x, q, scale, what, fn):
        nonlocal worst
        before = qm.launch_counts["quant_matmul"]
        out = fn(x, q, scale)
        launches = qm.launch_counts["quant_matmul"] - before
        err, rel, tol = compare(out, qm.quant_matmul_plain(x, q, scale), what)
        _same_bits(torch, out, fn(x, q, scale), what)
        if launches != 1:
            raise AssertionError(f"{what}: {launches} launches, not 1")
        worst = max(worst, err)
        return {"max_abs_err": err, "max_rel_err": rel, "tol": tol, "launches": launches}

    def operands(M, K, N, offset=0, scale_offset=0):
        x = torch.randn((M * K + offset,), generator=g, device=dev).to(bf16)[offset:].view(M, K)
        q = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand((N + scale_offset,), generator=g, device=dev) * 2e-4 + 1e-4
        return x, q, scale[scale_offset:]

    shapes = [(M, K, N) for M in (1, 8, 64, 65, 300) for K, N in ((8192, 3072), (3072, 1024))]
    for M, K, N in shapes + [(300, 40, 72)]:
        x, q, scale = operands(M, K, N)
        res = case(x, q, scale, f"quant_matmul edge M={M} K={K} N={N}", qm.quant_matmul_cuda)
        emit({"phase": "kernels", "kernel": "quant_matmul", "case": "edge", "M": M, "K": K,
              "N": N, "plan": list(qm.plan_of(x, q, scale)[0]), **res})
    via_ops = lambda x, q, s: ops.quant_matmul(x, q, s, "md,df->mf")  # noqa: E731
    for what, offsets in (("x", {"offset": 1}), ("scale", {"scale_offset": 1})):
        for M in (8, 2816):
            x, q, scale = operands(M, 3072, 3072, **offsets)
            for how, fn in (("ops", via_ops), ("wrapper", qm.quant_matmul_cuda)):
                res = case(x, q, scale, f"quant_matmul misaligned {what} M={M} via {how}", fn)
                ran = (x, q, scale) if how == "wrapper" else map(ops.aligned, (x, q, scale))
                emit({"phase": "kernels", "kernel": "quant_matmul", "case": f"misaligned_{what}",
                      "via": how, "M": M, "K": 3072, "N": 3072,
                      "x_data_ptr_mod_16": x.data_ptr() % 16,
                      "scale_data_ptr_mod_8": scale.data_ptr() % 8,
                      "plan": list(qm.plan_of(*ran)[0]), **res})
    return worst


@contextlib.contextmanager
def plain_scale_first():
    """The plain versions, with the int8 product's scale applied to the
    weight before the sum (the JAX xla tier's order) where the kernel and
    its plain version apply it after (the Pallas kernel's).  The two are
    equally right: their distance is the noise floor of the int8 checks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm

    plain = qm.quant_matmul_plain
    qm.quant_matmul_plain = lambda x, q, s: (x.float() @ (q.float() * s)).to(x.dtype)
    try:
        with ops.force_plain():
            yield
    finally:
        qm.quant_matmul_plain = plain


@contextlib.contextmanager
def plain_split():
    """The plain versions, with decode attention in the Pallas kernel's own
    order (a partial softmax per split of ``SPLIT`` cache rows, then the
    online-softmax combine) where the plain version sums over the whole
    window at once.  The two are the same function with their f32 sums in
    another order: their distance is the noise floor of serve_check."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    plain = da.decode_attention_plain
    da.decode_attention_plain = da.decode_attention_split_plain
    try:
        with ops.force_plain():
            yield
    finally:
        da.decode_attention_plain = plain


@contextlib.contextmanager
def plain_stored_o():
    """The plain versions, with packed attention's backward taking
    D = rowsum(do * o) from the forward's stored bf16 o (as the Pallas
    ``_dq_kernel`` / ``_dkv_kernel`` and the CUDA kernels do) where autograd
    of the plain version differentiates its f32 o.  The two are equally
    right: their distance is the noise floor of the bf16 train checks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_attention as pa

    plain = pa.packed_attention_plain
    pa.packed_attention_plain = pa.packed_attention_stored_o_plain
    try:
        with ops.force_plain():
            yield
    finally:
        pa.packed_attention_plain = plain


@contextlib.contextmanager
def plain_reordered():
    """The plain versions, with grouped LoRA's and packed attention's f32
    contractions, forward and backward, each summed as two halves added at
    the end (as a kernel that splits it in two sums it) where the plain
    versions leave the order to cuBLAS.  The two are the same functions in
    another order, no kernel involved: their distance is the noise floor of
    the bf16 train checks."""
    from repro_torch.kernels import grouped_lora as gl
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_attention as pa

    plain = gl.grouped_lora_plain, pa.packed_attention_plain
    gl.grouped_lora_plain = gl.grouped_lora_reordered_plain
    pa.packed_attention_plain = pa.packed_attention_reordered_plain
    try:
        with ops.force_plain():
            yield
    finally:
        gl.grouped_lora_plain, pa.packed_attention_plain = plain


def densify(torch, tree):
    """An f32 copy of a backbone tree with every int8 node dequantized: the
    reference weights of the f32 runs."""
    from repro_torch.models.quantize import dequantize, is_quantized

    if is_quantized(tree):
        return dequantize(tree, torch.float32)
    if isinstance(tree, dict):
        return {k: densify(torch, v) for k, v in tree.items()}
    return tree.float()


def serve_phase(torch, backbone_dtype="bfloat16", bf16_run=None):
    """The main path: PEFTEngine serving 8 requests of 4 LoRA tenants on a
    backbone stored as ``backbone_dtype``.  ``bf16_run`` is what the bf16
    run returned: the int8 run reports its greedy tokens' agreement with it.
    Returns the launch counts and what a later run compares with."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import (
        ExecutionPlanner,
        ModelGenerator,
        ParallelismSpec,
        PEFTEngine,
        PEFTTask,
    )
    from repro_torch.core.cost_model import CostModel
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import tensor_bytes
    from repro_torch.peft.methods import AdapterConfig, base_op_dims

    cfg = get_config("llama3.2-3b").with_overrides(backbone_dtype=backbone_dtype)
    int8 = backbone_dtype == "int8"
    suffix = "_int8" if int8 else ""
    L = cfg.num_layers
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=SITES)
               for rk, al in ((8, 16.0), (16, 16.0), (32, 64.0), (64, 32.0))]
    tasks = [PEFTTask(f"tenant{i}", tc, (512,), 1) for i, tc in enumerate(tenants)]
    gen = ModelGenerator(cfg, seed=0)
    backbone = gen.init_backbone()
    reg = gen.register_tasks(tasks)
    mta, adapters = reg.mta, reg.adapter_params
    for site in adapters["lora"].values():  # LoRA's B starts at 0: fill it
        site["b"].copy_(torch.randn(site["b"].shape, generator=gen.generator,
                                    device="cuda") * 0.02)
    plan = ExecutionPlanner(cfg, ParallelismSpec()).plan(tasks)
    engine = PEFTEngine(gen, plan)
    model = engine.model
    rows, max_len, cap, Lp = 8, 1024, 64, 512
    engine.ensure_decode_pool(rows, max_len, cap)

    rs = np.random.RandomState(0)
    tenant_of = [0, 0, 1, 1, 2, 2, 3, 3]
    lengths = rs.randint(64, Lp + 1, rows).astype(np.int32)
    lengths[0], lengths[5] = Lp, 64
    max_new = rs.randint(32, cap + 1, rows).astype(np.int32)
    max_new[3] = cap
    tokens = np.zeros((rows, Lp), np.int32)
    for i in range(rows):
        tokens[i, :lengths[i]] = rs.randint(1, cfg.vocab_size, lengths[i])
    slots, scales = engine.decode_row_ctx(tenant_of)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        engine.dispatch_decode_bind_batched(np.arange(rows), tokens, lengths, slots, scales,
                                            max_new)
        acct = engine.decode_accounting()
        bind_s = time.perf_counter() - t0
        step_s = []
        while acct["active"].any():
            t1 = time.perf_counter()
            engine.dispatch_decode_micro(slots, scales)
            acct = engine.decode_accounting()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    n_micro = len(step_s)
    if list(acct["n_out"]) != list(max_new):
        raise AssertionError(f"requests did not complete: n_out {acct['n_out']} "
                             f"max_new {max_new}")
    want = dict.fromkeys(counts, 0)
    want.update({"grouped_lora": len(SITES) * L * (1 + n_micro), "packed_attention": L,
                 "decode_attention": L * n_micro})
    if int8:  # every BaseOp of every layer, in the bind and in each micro step
        want["quant_matmul"] = len(base_op_dims(cfg)) * L * (1 + n_micro)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path implies {want}")
    gen = [engine.decode_outputs(i)[:max_new[i]] for i in range(rows)]
    decode_tokens = int(sum(max_new) - rows)
    nbytes = tensor_bytes(backbone)
    extra = {}
    if int8:
        # the cost model's Eq. 5 backbone term is what the planner sees
        want_bytes = CostModel(cfg, [], ParallelismSpec()).stage_memory([])
        if abs(nbytes - want_bytes) > BACKBONE_BYTES_TOL * want_bytes:
            raise AssertionError(f"int8 backbone holds {nbytes} bytes, the cost model "
                                 f"{want_bytes}")
        agree = [int((a == b).sum()) for a, b in zip(gen, bf16_run["tokens"])]
        extra = {"bf16_backbone_bytes": bf16_run["backbone_bytes"],
                 "cost_model_backbone_bytes": want_bytes,
                 "greedy_tokens_agreeing_with_bf16": sum(agree) / float(sum(max_new)),
                 "greedy_agreement_by_row": [a / float(m) for a, m in zip(agree, max_new)]}
    emit({"phase": "serve" + suffix, "model": cfg.name, "layers": L, "d_model": cfg.d_model,
          "backbone_dtype": backbone_dtype, "backbone_bytes": nbytes, **extra,
          "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
          "requests": rows, "prompt_lengths": lengths.tolist(),
          "max_new": max_new.tolist(), "bucket": Lp, "micro_steps": n_micro,
          "launches": counts, "bind_s": bind_s,
          "prefill_tokens_per_s": float(lengths.sum()) / bind_s,
          "decode_tokens_per_s": decode_tokens / sum(step_s),
          "micro_step_ms_median": statistics.median(step_s) * 1e3,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    torch.cuda.synchronize()

    with torch.no_grad():
        prof = profile_device(torch, lambda: engine.dispatch_decode_micro(slots, scales), 3,
                              {"grouped_lora": ("grouped_lora",),
                               "decode_attention": ("decode_attention_kernel",),
                               "quant_matmul": ("qmm_",)})
    emit({"phase": "profile", "path": "serve micro step" + suffix, **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})

    # ---- teacher-forced rerun: kernels vs plain versions, every step ----
    # A third run, the plain versions on float32 weights and caches, is the
    # reference both bf16 runs are measured against: the kernel path should
    # be as close to it as the plain bf16 path.
    dev = torch.device("cuda")
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    out_t = torch.as_tensor(np.stack([np.pad(x, (0, cap - len(x))) for x in gen]), device=dev)
    mx_t = torch.as_tensor(max_new, device=dev)
    ctxf = mta.ctx_factory_from_slots(slots, scales)
    ar = torch.arange(rows, device=dev)
    modes = {
        "kernel": (backbone, adapters, torch.bfloat16, contextlib.nullcontext),
        "plain": (backbone, adapters, torch.bfloat16, ops.force_plain),
        "f32": (densify(torch, backbone),
                tree_map(lambda t: t.float(), adapters), torch.float32, ops.force_plain),
    }
    modes["plain_split"] = (backbone, adapters, torch.bfloat16, plain_split)
    if int8:
        modes["plain_scale_first"] = (backbone, adapters, torch.bfloat16, plain_scale_first)
    # per step: max |difference| over the live rows, relative to the largest
    # |logit| of the second path of the pair
    steps_rel = {"kernel_vs_plain": [], "kernel_vs_f32": [], "plain_vs_f32": [],
                 "plain_split_vs_plain": []}
    if int8:
        steps_rel["plain_scale_first_vs_plain"] = []
    worst = {"scale": 0.0, "argmax_agree": 1.0}

    def check(logits, live):
        lg = {m: logits[m][live].float() for m in modes}
        for key in steps_rel:
            a, b = key.split("_vs_")
            steps_rel[key].append(
                (lg[a] - lg[b]).abs().max().item() / lg[b].abs().max().item())
        worst["scale"] = max(worst["scale"], lg["plain"].abs().max().item())
        agree = (lg["kernel"].argmax(-1) == lg["plain"].argmax(-1)).float().mean().item()
        worst["argmax_agree"] = min(worst["argmax_agree"], agree)

    with torch.no_grad():
        states, logits = {}, {}
        for mode, (bb, ad, dt, ctx) in modes.items():
            with ctx():
                st = model.init_decode_state(rows, max_len, cache_dtype=dt)
                lg, states[mode] = model.prefill(bb, {"tokens": tok_t}, st, adapters=ad,
                                                 ctx_factory=ctxf, lengths=len_t)
                logits[mode] = lg[ar, (len_t - 1).long()]
        if not torch.equal(logits["kernel"].float().argmax(-1).to(torch.int32), out_t[:, 0]):
            raise AssertionError("teacher-forced prefill does not give the served first tokens")
        check(logits, torch.ones(rows, dtype=torch.bool, device=dev))
        for i in range(n_micro):
            live = (i + 1) < mx_t
            cur = out_t[ar, torch.minimum(torch.tensor(i, device=dev), mx_t - 1).long()][:, None]
            for mode, (bb, ad, dt, ctx) in modes.items():
                with ctx():
                    st = states[mode]
                    lg, new = model.decode_step(bb, st, cur, adapters=ad, ctx_factory=ctxf)
                    new["pos"] = torch.where(live, new["pos"], st["pos"])
                    states[mode], logits[mode] = new, lg[:, 0]
            served = out_t[ar, torch.clamp(torch.tensor(i + 1, device=dev), max=cap - 1)]
            tf = logits["kernel"].float().argmax(-1).to(torch.int32)
            if not torch.equal(tf[live], served[live]):
                raise AssertionError(f"step {i}: teacher-forced kernel tokens differ from "
                                     f"the served tokens")
            check(logits, live)
    torch.cuda.synchronize()
    top = {k: max(v) for k, v in steps_rel.items()}
    tol = INT8_LOGIT_TOL if int8 else LOGIT_TOL
    emit({"phase": "serve_check" + suffix, "steps": n_micro + 1,
          "logit_max_rel_err": top["kernel_vs_plain"],
          "logit_worst_step": steps_rel["kernel_vs_plain"].index(top["kernel_vs_plain"]),
          "tol_rel": tol, "logit_scale": worst["scale"],
          "argmax_agreement_min": worst["argmax_agree"],
          "kernel_vs_f32_max_rel": top["kernel_vs_f32"],
          "plain_vs_f32_max_rel": top["plain_vs_f32"],
          "plain_split_vs_plain_max_rel": top["plain_split_vs_plain"],
          "plain_scale_first_vs_plain_max_rel": top.get("plain_scale_first_vs_plain"),
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in steps_rel.items()}})
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_check{suffix}: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if not top["kernel_vs_f32"] <= 2 * top["plain_vs_f32"]:
        raise AssertionError(f"serve_check{suffix}: the kernel path is further from the f32 "
                             f"run ({top['kernel_vs_f32']}) than twice the plain path "
                             f"({top['plain_vs_f32']})")
    return counts, {"tokens": gen, "backbone_bytes": nbytes}


def train_plan(backbone_dtype="bfloat16"):
    """The training path's configuration, tenants and plan (host-side); the
    planner's cost model prices the backbone at ``backbone_dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config("llama3.2-3b").with_overrides(backbone_dtype=backbone_dtype)
    tasks = parse_tasks(TRAIN_TASKS, TRAIN_MICRO_BATCH)
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def methods_plan():
    """The train_methods path: llama3.2-3b (bf16) at full width and
    ``METHODS_LAYERS`` of its 28 layers, one tenant of each PEFT kind
    (``METHODS_TASKS``), and their plan."""
    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config("llama3.2-3b").with_overrides(num_layers=METHODS_LAYERS)
    tasks = parse_tasks(METHODS_TASKS, TRAIN_MICRO_BATCH)
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def _retargeted_plan(arch, targets, backbone_dtype="bfloat16"):
    """``arch`` at full width and depth on a ``backbone_dtype`` backbone,
    the training tenants (``TRAIN_TASKS``) on ``targets``, and their plan."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config(arch).with_overrides(backbone_dtype=backbone_dtype)
    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=targets))
             for t in parse_tasks(TRAIN_TASKS, TRAIN_MICRO_BATCH)]
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def zamba_plan(backbone_dtype="bfloat16"):
    """The hybrid training path's configuration (zamba2-2.7b at full width
    and depth, on a ``backbone_dtype`` backbone), the same tenants on the
    Mamba2 projections and the shared block's q / v, and their plan."""
    return _retargeted_plan("zamba2-2.7b", ZAMBA_TARGETS, backbone_dtype)


def starcoder2_plan():
    """The starcoder2 training path: starcoder2-7b at full width and depth
    (bf16), the training tenants on q, v, fc1 and fc2, and their plan."""
    return _retargeted_plan(STARCODER2_ARCH, STARCODER2_TARGETS)


def xlstm_plan(backbone_dtype="bfloat16"):
    """The ssm family's training path: xlstm-1.3b at full width and depth
    (on a ``backbone_dtype`` backbone), the training tenants on the mLSTM's
    ssm_in, q and v (the sLSTM's ssm_in too: its only site of the three),
    their plan, and the seed of its batches (``XLSTM_DATA_SEED``)."""
    return _retargeted_plan(XLSTM_ARCH, XLSTM_TARGETS, backbone_dtype) + (XLSTM_DATA_SEED,)


def step_launches(cfg, adapters):
    """Kernel launches of one training micro step, forward and backward,
    from the model's layout and the grouped-LoRA sites (LoRA's and DoRA's)
    of the adapter tree.  The ssm family's mLSTM scans run the tiled
    kernels (xlstm's (1024, 1025) state), one call of each a block."""
    def sites(tree):
        return sum(len(tree.get(kind, {})) for kind in GROUPED_LORA_KINDS)

    if cfg.family == "ssm":  # n_super x (per mLSTM blocks + one sLSTM block), no attention
        n_super = cfg.num_layers // cfg.slstm_period
        scans = n_super * (cfg.slstm_period - 1)
        lora = scans * sites(adapters["mlstm"]) + n_super * sites(adapters["slstm"])
        return {"grouped_lora": lora, "grouped_lora_bwd": lora, "mamba_scan_tiled": scans,
                "mamba_scan_bwd_state_tiled": scans, "mamba_scan_bwd_chunk_tiled": scans}
    if cfg.family in ("dense", "vlm", "moe"):
        attn, scans = cfg.num_layers, 0
        lora = sites(adapters) * cfg.num_layers
    else:  # hybrid: n_super x (per Mamba2 blocks + the shared block)
        attn = cfg.num_layers // cfg.hybrid_period
        scans = attn * (cfg.hybrid_period - 1)
        lora = scans * sites(adapters["mamba"]) + attn * sites(adapters["shared_attn"])
    return {"grouped_lora": lora, "grouped_lora_bwd": lora, "packed_attention": attn,
            "packed_attention_dq": attn, "packed_attention_dkv": attn, "mamba_scan": scans,
            "mamba_scan_bwd_state": scans, "mamba_scan_bwd_chunk": scans}


def _autograd_ms(torch, timer, out, inputs, grad):
    """Time of the backward of an autograd graph built once."""
    return timer(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True))


def _lora_train_kernels(torch, timer, g, tasks, plan, shapes, layer, layer_what, tag,
                        kind="lora"):
    """Grouped LoRA forward (saving h) and backward against autograd of the
    plain version at M = rows x row_len of the plan's first hTask, the rows,
    stack rank and capacity (one slot per tenant) of the tenants of ``kind``
    (LoRA, or DoRA's direction update), for each (d_in, d_out) of
    ``shapes``; the results sum the shapes of ``layer`` (one layer's or one
    super-block's sites)."""
    from repro_torch.kernels import grouped_lora as gl

    bf16, dev = torch.bfloat16, "cuda"
    h0 = plan.htasks[0]
    B, S = h0.rows, h0.row_len
    M = B * S
    lora = [i for i, t in enumerate(tasks) if t.adapter.kind == kind]
    T, r = len(lora), max(tasks[i].adapter.rank for i in lora)
    slot = {t: s for s, t in enumerate(lora)}
    row_task = [slot.get(t, -1) for t in plan.segments_for(0).row_task]
    rt = torch.tensor(row_task, dtype=torch.int32, device=dev).repeat_interleave(S)
    scale = torch.tensor([tasks[i].adapter.scale for i in lora], dtype=torch.float32,
                         device=dev)
    active = int((rt >= 0).sum().item())
    per_shape = {}
    for d_in, d_out in shapes:
        x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
        gy = torch.randn((M, d_out), generator=g, device=dev).to(bf16)
        a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
        b = (torch.randn((T, r, d_out), generator=g, device=dev) * 0.02).to(bf16)
        y, h = gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)
        xr, ar, br = (t.clone().requires_grad_(True) for t in (x, a, b))
        y_ref = gl.grouped_lora_plain(xr, ar, br, rt, scale)
        h_ref = torch.zeros((M, r), device=dev)
        for t in range(T):
            h_ref = torch.where((rt == t)[:, None], x.float() @ a[t].float(), h_ref)
        dx, da, db = gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)
        for n, o, o2 in zip(("dx", "dA", "dB"), (dx, da, db),
                            gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)):
            _same_bits(torch, o, o2, f"grouped_lora backward {d_in}x{d_out} {n}")
        refs = torch.autograd.grad(y_ref, (xr, ar, br), gy, retain_graph=True)
        torch.cuda.synchronize()
        if y[rt < 0].abs().max().item() != 0.0 or dx[rt < 0].abs().max().item() != 0.0:
            raise AssertionError("grouped_lora: a row_task = -1 row is not exactly 0")
        where = f"grouped_lora train M={M} {d_in}x{d_out}"
        err_f = max(compare(y, y_ref, where)[0],
                    compare(h, h_ref, where + " h", F32_TOL)[0])
        err_b = max(compare(o, ref, f"{where} {n}", GRAD_TOL["grouped_lora_bwd"])[0]
                    for n, o, ref in zip(("dx", "dA", "dB"), (dx, da, db), refs))
        ms_f = timer(lambda: gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True))
        dev_f = kernel_device_ms(torch, timer, lambda: gl.grouped_lora_cuda(
            x, a, b, rt, scale, save_h=True), "grouped_lora_pair")
        plain_f = timer(lambda: gl.grouped_lora_plain(x, a, b, rt, scale))
        ms_b = timer(lambda: gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy))
        bwd = lambda: gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)  # noqa: E731
        dev_b = kernel_device_ms(torch, timer, bwd, "grouped_lora")  # the pair and reduce kernels
        # the backward's two kernels apart: the pair kernel (dh, dx) and the
        # per-task reduction (dA, dB)
        dev_pair = kernel_device_ms(torch, timer, bwd, "grouped_lora_pair")
        dev_red = kernel_device_ms(torch, timer, bwd, "reduce")
        plain_b = _autograd_ms(torch, timer, y_ref, (xr, ar, br), gy)
        ab = 2 * T * r * (d_in + d_out)
        work = {"fwd": (2 * (M * d_in + M * d_out) + ab + 4 * (M * r + M + T),
                        2.0 * active * r * (d_in + d_out)),
                "bwd": (2 * (2 * M * d_in + M * d_out) + 2 * ab + 4 * (M * r + M + T),
                        4.0 * active * r * (d_in + d_out)),
                # the reduction alone: x and g read once, h and dh read once,
                # bf16 dA and dB written once
                "reduce": (2 * M * (d_in + d_out) + 2 * 4 * M * r + ab + 4 * (M + T),
                           2.0 * active * r * (d_in + d_out))}
        bf, byf = bound_ms(*work["fwd"])
        bb, byb = bound_ms(*work["bwd"])
        br_ms, byr = bound_ms(*work["reduce"])
        per_shape[(d_in, d_out)] = {"fwd": (ms_f, plain_f, err_f) + work["fwd"] + (dev_f,),
                                    "bwd": (ms_b, plain_b, err_b) + work["bwd"] + (dev_b,),
                                    "split": (dev_pair, dev_red) + work["reduce"]}
        emit({"phase": "train_kernels", "kernel": "grouped_lora", "model": tag, "stack": kind,
              "M": M, "rows_with_lora": active, "d_in": d_in, "d_out": d_out, "T": T, "r": r,
              "fwd_save_h": {"ms": ms_f, "device_ms": dev_f, "plain_ms": plain_f,
                             "bound_ms": bf, "bound_by": byf, "max_abs_err": err_f},
              "bwd": {"ms": ms_b, "device_ms": dev_b, "plain_ms": plain_b, "bound_ms": bb,
                      "bound_by": byb, "max_abs_err": err_b,
                      "tol_rel": GRAD_TOL["grouped_lora_bwd"],
                      "pair_device_ms": dev_pair, "reduce_device_ms": dev_red,
                      "reduce_bound_ms": br_ms, "reduce_bound_by": byr}})
    results = {}
    for key, name in (("fwd", "grouped_lora_train"), ("bwd", "grouped_lora_bwd")):
        ms, plain, nbytes, flops = (sum(per_shape[sh][key][i] for sh in layer)
                                    for i in (0, 1, 3, 4))
        devs = [per_shape[sh][key][5] for sh in layer]
        bms, by = bound_ms(nbytes, flops)
        results[name] = {
            "shape": f"M={M}, T={T}, r={r}: {layer_what} of one training micro step (sum)",
            "ms": ms, "device_ms": None if None in devs else sum(devs), "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "max_abs_err": max(v[key][2] for v in per_shape.values())}
    pairs, reds = ([per_shape[sh]["split"][i] for sh in layer] for i in (0, 1))
    rbms, rby = bound_ms(*(sum(per_shape[sh]["split"][i] for sh in layer) for i in (2, 3)))
    results["grouped_lora_bwd"].update({
        "pair_device_ms": None if None in pairs else sum(pairs),
        "reduce_device_ms": None if None in reds else sum(reds),
        "reduce_bound_ms": rbms, "reduce_bound_by": rby})
    return results, (rt, scale, r, M)


def _attention_check(torch, q, k, v, do, ints, causal, bq, bk, where):
    """The forward (o, lse), dq and dk/dv kernels on one input against the
    plain version and autograd of it.  Rows that see no key must give o = 0
    and lse = 1e30 exactly; lse is compared on the other rows.  Returns the
    kernels' outputs, the plain graph, the mask and the largest errors."""
    from repro_torch.kernels import packed_attention as pa

    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    o, lse = pa.packed_attention_cuda(q, k, v, *ints, causal, bq, bk, save_lse=True)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o_ref = pa.packed_attention_plain(qr, kr, vr, *ints, causal, bq, bk)
    mask = pa.visible_mask(*ints, causal, bq, bk)
    sc = torch.einsum("bqkgd,bpkd->bqkgp", q.float().reshape(B, S, Hkv, H // Hkv, dh),
                      k.float()) / dh ** 0.5
    sc = sc.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    lse_ref = torch.logsumexp(sc, dim=-1).reshape(B, S, H).permute(0, 2, 1)
    dq = pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, causal, bq, bk)
    dk, dv = pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, causal, bq, bk)
    dq_ref, dk_ref, dv_ref = torch.autograd.grad(o_ref, (qr, kr, vr), do, retain_graph=True)
    torch.cuda.synchronize()
    dead = ~mask.any(-1)  # [B, S]: queries that see no key
    n_dead = int(dead.sum().item())
    if n_dead:
        dead_h = dead[:, None, :].expand(B, H, S)
        if o.permute(0, 2, 1, 3)[dead_h].abs().max().item() != 0.0 \
                or not bool((lse[dead_h] == 1e30).all()):
            raise AssertionError(f"{where}: a query that sees no key is not o = 0, lse = 1e30")
    live = ~dead[:, None, :].expand(B, H, S)
    err_f = max(compare(o, o_ref, where)[0],
                compare(lse[live], lse_ref[live], where + " lse", F32_TOL)[0])
    err_dq = compare(dq, dq_ref, where + " dq", GRAD_TOL["packed_attention_dq"])[0]
    err_dkv = max(compare(dk, dk_ref, where + " dk", GRAD_TOL["packed_attention_dkv"])[0],
                  compare(dv, dv_ref, where + " dv", GRAD_TOL["packed_attention_dkv"])[0])
    return (o, lse), (o_ref, qr, kr, vr), mask, n_dead, (err_f, err_dq, err_dkv)


def _attention_edge_cases(torch, g, cfg, S_loader, tag):
    """Layouts that the redesigned kernels' tiling meets only at its edges,
    each held to the plain version (forward, lse) and autograd of it (dq,
    dk/dv), one line each: (a) S = 200 (not a multiple of 16 or 64) behind a
    16-row prefix of wildcard (-1) and unseen (-2) rows, dh = 128, G = 3;
    (b) queries that see no key; (c) dh = 64; (d) dq and dk/dv on a loader
    layout at S = 200 at the model's heads; (e) segments that alternate every
    64 rows, so that the tiles a warp skips (segment ranges disjoint) and the
    ones it computes alternate, behind a wildcard prefix in one batch row;
    (f) misaligned q, k, v (``_misaligned_attention_case``)."""
    from repro_torch.core.alignment import align_tasks
    from repro_torch.data.synthetic import make_task
    from repro_torch.kernels import packed_attention as pa

    bf16, dev, i32 = torch.bfloat16, "cuda", torch.int32

    def rows(B, S):
        return torch.arange(S, dtype=i32, device=dev).expand(B, S).contiguous()

    def prefixed(pos, seg, pseg):  # pseg [B, P]: -1 or -2 per prefix row
        B, P = pseg.shape
        kpos = torch.cat([torch.full((B, P), -1, dtype=i32, device=dev), pos], 1)
        return pos, seg, kpos.contiguous(), torch.cat([pseg, seg], 1).contiguous()

    def run(case, B, S, H, Hkv, dh, ints, causal=True, block=128):
        Sk = ints[2].shape[1]
        q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
        k = torch.randn((B, Sk, Hkv, dh), generator=g, device=dev).to(bf16)
        v = torch.randn((B, Sk, Hkv, dh), generator=g, device=dev).to(bf16)
        do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
        bq, bk = pa.tile_sizes(S, Sk, block, block)
        where = f"packed_attention {tag} case {case}"
        *_, n_dead, (err_f, err_dq, err_dkv) = _attention_check(
            torch, q, k, v, do, [t.contiguous() for t in ints], causal, bq, bk, where)
        emit({"phase": "train_kernels", "kernel": "packed_attention", "model": tag,
              "case": case, "B": B, "S": S, "Sk": Sk, "H": H, "Hkv": Hkv, "dh": dh,
              "bq": bq, "bk": bk, "rows_seeing_no_key": n_dead,
              "fwd_lse_max_abs_err": err_f, "dq_max_abs_err": err_dq,
              "dkv_max_abs_err": err_dkv})

    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    # (d) the loader's layout at S = 200: one hTask's rows, the model's heads
    tasks = [make_task(f"t{i}", ds, 4, seed=i) for i, ds in enumerate(("sst2", "qa", "sst2"))]
    arr = align_tasks(tasks, [0, 1, 2], "chunked", row_len=S_loader).arrays()
    pos = torch.as_tensor(arr["positions"], device=dev)
    seg = torch.as_tensor(arr["segment_ids"], device=dev)
    run(f"d_loader_S{S_loader}_G{H // Hkv}", pos.shape[0], S_loader, H, Hkv, dh,
        (pos, seg, pos, seg), block=cfg.attn_q_block)
    if tag != "llama3.2-3b":
        return
    B, S, P = 2, 200, 16
    pseg = torch.full((B, P), -2, dtype=i32, device=dev)
    pseg[0, ::2] = -1
    pseg[1, :5] = -1
    zeros = torch.zeros((B, S), dtype=i32, device=dev)
    run("a_S200_prefix16", B, S, 6, 2, 128, prefixed(rows(B, S), zeros, pseg))
    # (b) rows 17 and 130 carry segments no key has; their own keys another
    seg_b = zeros.clone()
    seg_b[:, 17], seg_b[:, 130] = 7, 9
    kseg_b = zeros.clone()
    run("b_rows_seeing_no_key", B, S, 6, 2, 128, (rows(B, S), seg_b, rows(B, S), kseg_b))
    run("c_dh64", B, 256, 8, 2, 64, (rows(B, 256), torch.zeros((B, 256), dtype=i32,
                                                                device=dev)) * 2)
    S = 512  # segments change at every 64th key index (the prefix shifts them by P)
    seg_e = ((torch.arange(S, device=dev) + P) // 64 % 2).to(i32).expand(B, S).contiguous()
    pseg = torch.full((B, P), -2, dtype=i32, device=dev)
    pseg[0] = -1
    run("e_alternating_segments", B, S, H, Hkv, dh, prefixed(rows(B, S), seg_e, pseg))
    _misaligned_attention_case(torch, g, tag)


def _misaligned_attention_case(torch, g, tag):
    """(f) q, k and v as contiguous views two bytes past a 16-byte boundary,
    which the kernels' cp.async cannot read: ops.packed_attention hands the
    forward, dq and dk/dv kernels aligned copies (each launched once), and
    its output and the gradients to the views match the plain version's."""
    from repro_torch.kernels import ops

    bf16, dev = torch.bfloat16, "cuda"
    B, S, H, Hkv, dh = 2, 256, 6, 2, 128

    def odd_view(*shape):  # a leaf view at element offset 1 of its storage
        n = shape[0] * shape[1] * shape[2] * shape[3]
        base = torch.randn((n + 1,), generator=g, device=dev).to(bf16)
        return base[1:].view(shape).requires_grad_(True)

    q, k, v = odd_view(B, S, H, dh), odd_view(B, S, Hkv, dh), odd_view(B, S, Hkv, dh)
    if any(t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise AssertionError("packed_attention case f: a view is 16-byte aligned")
    do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    seg = (torch.arange(S, device=dev) // 100).to(torch.int32).expand(B, S).contiguous()
    before = ops.launch_counts()
    o = ops.packed_attention(q, k, v, seg)
    grads = torch.autograd.grad(o, (q, k, v), do)
    launched = {n: ops.launch_counts()[n] - before[n]
                for n in ("packed_attention", "packed_attention_dq", "packed_attention_dkv")}
    if set(launched.values()) != {1}:
        raise AssertionError(f"packed_attention case f: launches {launched}, want one each")
    with ops.force_plain():
        o_ref = ops.packed_attention(q, k, v, seg)
        refs = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.cuda.synchronize()
    where = f"packed_attention {tag} case f_misaligned"
    err_f = compare(o, o_ref, where)[0]
    err_dq = compare(grads[0], refs[0], where + " dq", GRAD_TOL["packed_attention_dq"])[0]
    err_dkv = max(compare(gr, ref, f"{where} {n}", GRAD_TOL["packed_attention_dkv"])[0]
                  for n, gr, ref in zip(("dk", "dv"), grads[1:], refs[1:]))
    emit({"phase": "train_kernels", "kernel": "packed_attention", "model": tag,
          "case": "f_misaligned", "B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh,
          "data_ptr_mod_16": [t.data_ptr() % 16 for t in (q, k, v)], "launches": launched,
          "fwd_max_abs_err": err_f, "dq_max_abs_err": err_dq, "dkv_max_abs_err": err_dkv})


def _attention_train_kernels(torch, timer, g, cfg, plan, tag):
    """Packed attention forward (saving lse), dq and dk/dv against autograd
    of the plain version on the plan's loader layout at the model's heads,
    with the model's tiles and with the ops default (128) where the tile
    rule cuts; SDPA's forward and backward as the library times; then the
    edge cases of ``_attention_edge_cases``."""
    import torch.nn.functional as F

    from repro_torch.kernels import packed_attention as pa

    bf16, dev = torch.bfloat16, "cuda"
    h0 = plan.htasks[0]
    B, S = h0.rows, h0.row_len
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    arr = plan.alignment[0].arrays()
    pos = torch.as_tensor(arr["positions"], device=dev)
    seg = torch.as_tensor(arr["segment_ids"], device=dev)
    ints = (pos, seg, pos, seg)
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf16)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf16)
    do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    path_tiles = pa.tile_sizes(S, S, cfg.attn_q_block)
    results = {}
    # the model's tiles, and the ops default (128), where the tile rule cuts
    for case, (bq, bk) in (("path", path_tiles), ("tile128", pa.tile_sizes(S, S))):
        where = f"packed_attention train {tag} {case} (bq={bq}, bk={bk})"
        (o, lse), (o_ref, qr, kr, vr), mask, _, (err_f, err_dq, err_dkv) = _attention_check(
            torch, q, k, v, do, ints, True, bq, bk, where)
        line = {"phase": "train_kernels", "kernel": "packed_attention", "model": tag,
                "case": case, "B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh, "bq": bq, "bk": bk,
                "fwd_lse_max_abs_err": err_f, "dq_max_abs_err": err_dq,
                "dkv_max_abs_err": err_dkv}
        if case == "path":
            pairs = int(mask.sum().item()) * H  # visible (query, key, head) triples
            qo = 2 * B * S * H * dh
            kv = 2 * B * S * Hkv * dh
            ib = 4 * 4 * B * S + 4 * B * H * S
            calls = {
                "fwd": lambda: pa.packed_attention_cuda(q, k, v, *ints, True, bq, bk,
                                                        save_lse=True),
                "dq": lambda: pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, True,
                                                          bq, bk),
                "dkv": lambda: pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, True,
                                                            bq, bk)}
            ms = {key: timer(fn) for key, fn in calls.items()}
            dev_ms = {key: kernel_device_ms(torch, timer, fn, f"packed_attention_{key}")
                      for key, fn in calls.items()}
            plain = {"fwd": timer(lambda: pa.packed_attention_plain(q, k, v, *ints, True,
                                                                    bq, bk)),
                     "dq": _autograd_ms(torch, timer, o_ref, (qr,), do),
                     "dkv": _autograd_ms(torch, timer, o_ref, (kr, vr), do)}
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            lib = {"fwd": timer(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)),
                   "dq": _autograd_ms(torch, timer, o_lib, (qt,), dot),
                   "dkv": _autograd_ms(torch, timer, o_lib, (kt, vt), dot)}
            lib_dev = {"fwd": library_device_ms(
                           torch, timer, lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True, enable_gqa=True)),
                       "dq": library_device_ms(torch, timer, lambda: torch.autograd.grad(
                           o_lib, (qt,), dot, retain_graph=True)),
                       "dkv": library_device_ms(torch, timer, lambda: torch.autograd.grad(
                           o_lib, (kt, vt), dot, retain_graph=True))}
            bounds = {"fwd": bound_ms(2 * qo + 2 * kv + ib, 4.0 * dh * pairs),
                      "dq": bound_ms(4 * qo + 2 * kv + ib, 6.0 * dh * pairs),
                      "dkv": bound_ms(3 * qo + 4 * kv + ib, 8.0 * dh * pairs)}
            shape = (f"B={B}, S={S}, H={H}, Hkv={Hkv}, dh={dh}, causal, loader layout, "
                     f"{pairs} visible (query, key, head) triples")
            for name, key, err in (("packed_attention_train", "fwd", err_f),
                                   ("packed_attention_dq", "dq", err_dq),
                                   ("packed_attention_dkv", "dkv", err_dkv)):
                entry = {"ms": ms[key], "device_ms": dev_ms[key], "plain_ms": plain[key],
                         "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                         "library_ms": lib[key], "library_device_ms": lib_dev[key]}
                results[name] = {"shape": shape, **entry, "max_abs_err": err}
                line[key] = entry
        emit(line)
    _attention_edge_cases(torch, g, cfg, 200, tag)
    return results


def train_kernel_phase(torch, timer, cfg, tasks, plan):
    """Each training kernel against autograd of its plain version at the
    training path's shapes: the first hTask of the plan (rows x row_len
    tokens), the LoRA stack of its tenants, llama3.2-3b's attention."""
    from repro_torch.kernels import grouped_lora as gl

    g = torch.Generator(device="cuda").manual_seed(2)
    bf16, dev = torch.bfloat16, "cuda"
    layer = [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072)]
    results, (rt, scale, r, M) = _lora_train_kernels(
        torch, timer, g, tasks, plan, ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)),
        layer, "the four LoRA sites of one layer", cfg.name)
    # a capacity slot no row routes to gets exact zeros
    a3 = (torch.randn((3, 3072, r), generator=g, device=dev) * 0.02).to(bf16)
    b3 = (torch.randn((3, r, 1024), generator=g, device=dev) * 0.02).to(bf16)
    x3 = torch.randn((M, 3072), generator=g, device=dev).to(bf16)
    g3 = torch.randn((M, 1024), generator=g, device=dev).to(bf16)
    s3 = torch.cat([scale, torch.ones(1, device=dev)])
    _, h3 = gl.grouped_lora_cuda(x3, a3, b3, rt, s3, save_h=True)
    _, da3, db3 = gl.grouped_lora_bwd_cuda(x3, a3, b3, rt, s3, h3, g3)
    if da3[2].abs().max().item() != 0.0 or db3[2].abs().max().item() != 0.0:
        raise AssertionError("grouped_lora backward: an unused slot's gradient is not 0")
    _lora_ragged_empty_case(torch, g, rt)
    _lora_rank_cases(torch, timer, g, plan.htasks[0].rows, plan.htasks[0].row_len)
    results.update(_attention_train_kernels(torch, timer, g, cfg, plan, cfg.name))
    return results


def methods_kernel_phase(torch, timer, cfg, tasks, plan):
    """The train_methods path's kernels at its own shapes: grouped LoRA
    forward and backward for the LoRA stack and for DoRA's direction update
    at the four attention sites (``_lora_train_kernels`` on this plan, most
    rows at slot -1); packed attention's forward, dq and dk/dv kernels at the
    path's prefix shape (case ``prefix_train``): the plan's rows x 256
    queries behind the prefix tenant's 16 learned rows, padded to 64 as
    ``ops.padded_prefix_rows`` pads them (Sk = 320, key tiles of 64); the
    prefix rows wildcards (-1) on the prefix tenant's batch rows and unseen
    (-2) on the others', the pad rows unseen everywhere.  Each kernel against
    autograd of the plain version under ``GRAD_TOL``, and run twice for the
    same bits; the plain version and SDPA with the visibility mask timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_attention as pa

    bf16, dev, i32 = torch.bfloat16, "cuda", torch.int32
    g = torch.Generator(device=dev).manual_seed(11)
    results = {}
    layer = [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072)]
    for kind in ("lora", "dora"):
        stack, _ = _lora_train_kernels(
            torch, timer, g, tasks, plan, ((3072, 3072), (3072, 1024)), layer,
            f"the four {kind} sites of one layer", f"{cfg.name} train_methods", kind)
        results.update({f"{k}_methods_{kind}": v for k, v in stack.items()})
    h0 = plan.htasks[0]
    B, S = h0.rows, h0.row_len
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    arr = plan.alignment[0].arrays()
    pos = torch.as_tensor(arr["positions"], device=dev)
    seg = torch.as_tensor(arr["segment_ids"], device=dev)
    (owner,) = [i for i, t in enumerate(tasks) if t.adapter.kind == "prefix"]
    rank = tasks[owner].adapter.rank
    P = ops.padded_prefix_rows(S, rank)
    owns = torch.as_tensor([t == owner for t in plan.segments_for(0).row_task], device=dev)
    pseg = torch.full((B, P), -2, dtype=i32, device=dev)
    pseg[:, :rank] = torch.where(owns, -1, -2).to(i32)[:, None]
    kpos = torch.cat([torch.full((B, P), -1, dtype=i32, device=dev), pos], 1).contiguous()
    ints = (pos, seg, kpos, torch.cat([pseg, seg], 1).contiguous())
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    k = torch.randn((B, S + P, Hkv, dh), generator=g, device=dev).to(bf16)
    v = torch.randn((B, S + P, Hkv, dh), generator=g, device=dev).to(bf16)
    do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    bq, bk = pa.tile_sizes(S, S + P, cfg.attn_q_block)
    where = f"packed_attention {cfg.name} case prefix_train"
    (o, lse), (o_ref, qr, kr, vr), mask, n_dead, (err_f, err_dq, err_dkv) = _attention_check(
        torch, q, k, v, do, ints, True, bq, bk, where)
    dq = pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, True, bq, bk)
    dk, dv = pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, True, bq, bk)
    o2, lse2 = pa.packed_attention_cuda(q, k, v, *ints, True, bq, bk, save_lse=True)
    dq2 = pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, True, bq, bk)
    dk2, dv2 = pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, True, bq, bk)
    for a, b, what in ((o, o2, "o"), (lse, lse2, "lse"), (dq, dq2, "dq"), (dk, dk2, "dk"),
                       (dv, dv2, "dv")):
        _same_bits(torch, a, b, f"{where} {what}")
    calls = {"fwd": lambda: pa.packed_attention_cuda(q, k, v, *ints, True, bq, bk,
                                                     save_lse=True),
             "dq": lambda: pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, True, bq, bk),
             "dkv": lambda: pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, True,
                                                         bq, bk)}
    pairs = int(mask.sum().item()) * H
    qo, kv = 2 * B * S * H * dh, 2 * B * (S + P) * Hkv * dh
    ib = 4 * 2 * B * S + 4 * 2 * B * (S + P) + 4 * B * H * S
    bounds = {"fwd": bound_ms(2 * qo + 2 * kv + ib, 4.0 * dh * pairs),
              "dq": bound_ms(4 * qo + 2 * kv + ib, 6.0 * dh * pairs),
              "dkv": bound_ms(3 * qo + 4 * kv + ib, 8.0 * dh * pairs)}
    plain = {"fwd": timer(lambda: pa.packed_attention_plain(q, k, v, *ints, True, bq, bk)),
             "dq": _autograd_ms(torch, timer, o_ref, (qr,), do),
             "dkv": _autograd_ms(torch, timer, o_ref, (kr, vr), do)}
    # the library: SDPA with the boolean visibility mask [B, 1, S, Sk]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dot, am = do.transpose(1, 2).contiguous(), mask[:, None]
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)
    lib = {"fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                         enable_gqa=True),
           "dq": lambda: torch.autograd.grad(o_lib, (qt,), dot, retain_graph=True),
           "dkv": lambda: torch.autograd.grad(o_lib, (kt, vt), dot, retain_graph=True)}
    lib = {key: {"library_ms": timer(fn), "library_device_ms": library_device_ms(torch, timer, fn)}
           for key, fn in lib.items()}
    line = {"phase": "train_kernels", "kernel": "packed_attention", "model": cfg.name,
            "case": "prefix_train", "B": B, "S": S, "Sk": S + P, "prefix_rows": rank,
            "padded_prefix_rows": P, "H": H, "Hkv": Hkv, "dh": dh, "bq": bq, "bk": bk,
            "rows_seeing_no_key": n_dead, "fwd_lse_max_abs_err": err_f,
            "dq_max_abs_err": err_dq, "dkv_max_abs_err": err_dkv, "same_bits_twice": True}
    for name, key, err in (("packed_attention_train_prefix", "fwd", err_f),
                           ("packed_attention_dq_prefix", "dq", err_dq),
                           ("packed_attention_dkv_prefix", "dkv", err_dkv)):
        entry = {"ms": timer(calls[key]),
                 "device_ms": kernel_device_ms(torch, timer, calls[key],
                                               f"packed_attention_{key}"),
                 "plain_ms": plain[key], "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                 **lib[key], "max_abs_err": err}
        line[key] = entry
        results[name] = {"shape": f"B={B}, S={S}, Sk={S + P} ({rank} prefix rows padded "
                                  f"to {P}), H={H}, Hkv={Hkv}, dh={dh}, causal, loader layout",
                         **entry}
    emit(line)
    return results


def _lora_ragged_empty_case(torch, g, rt):
    """The grouped-LoRA backward at M = 2816 + 40 (not a multiple of the
    reduction's 64-row chunks: the path's rows, then 40 rows of slot 1)
    with four slots, slot 3 routed no row: against autograd of the plain
    version, dA and dB of slot 3 exactly 0, two runs the same bits."""
    from repro_torch.kernels import grouped_lora as gl

    bf16, dev = torch.bfloat16, "cuda"
    d_in, d_out, T, r = 3072, 1024, 4, 16
    rt = torch.cat([rt, torch.ones(40, dtype=torch.int32, device=dev)])
    M = rt.shape[0]
    scale = torch.tensor([2.0, 1.0, 0.5, 1.0], dtype=torch.float32, device=dev)
    x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
    gy = torch.randn((M, d_out), generator=g, device=dev).to(bf16)
    a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
    b = (torch.randn((T, r, d_out), generator=g, device=dev) * 0.02).to(bf16)
    _, h = gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)
    outs = gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)
    where = f"grouped_lora backward M={M}, slot 3 empty"
    for n, o, o2 in zip(("dx", "dA", "dB"), outs, gl.grouped_lora_bwd_cuda(
            x, a, b, rt, scale, h, gy)):
        _same_bits(torch, o, o2, f"{where} {n}")
    xr, ar, br = (t.clone().requires_grad_(True) for t in (x, a, b))
    refs = torch.autograd.grad(gl.grouped_lora_plain(xr, ar, br, rt, scale), (xr, ar, br), gy)
    err = {n: compare(o, ref, f"{where} {n}", GRAD_TOL["grouped_lora_bwd"])[0]
           for n, o, ref in zip(("dx", "dA", "dB"), outs, refs)}
    if outs[1][3].abs().max().item() != 0.0 or outs[2][3].abs().max().item() != 0.0:
        raise AssertionError(f"{where}: the empty slot's dA or dB is not exactly 0")
    emit({"phase": "train_kernels", "kernel": "grouped_lora_bwd", "case": "ragged_empty_slot",
          "M": M, "d_in": d_in, "d_out": d_out, "T": T, "r": r, "empty_slot": 3,
          "max_abs_err": err, "tol_rel": GRAD_TOL["grouped_lora_bwd"]})


def _lora_rank_cases(torch, timer, g, rows, row_len):
    """Grouped LoRA at stack ranks 8, 16 and 64 (one rank tile of the
    kernels) and 96 and 128 (two), with mixed per-task ranks (each tenant's
    B rows past its own rank zero, as a padded stack holds them), three
    tasks and no-adapter rows, which must come out exactly 0 (y, h, dx);
    rank 64 is the baseline of the times.  The forward at decode (M = 8, a
    task per row) against the plain version; the forward (saving h) and the
    backward at the training rows against the plain version and autograd of
    it; then tiles whose rows change task (``_lora_mixed_tile_case``).  One
    line each."""
    from repro_torch.kernels import grouped_lora as gl

    bf16, dev, i32 = torch.bfloat16, "cuda", torch.int32
    d_in, d_out = 3072, 1024
    M = rows * row_len
    rt = (torch.arange(rows, device=dev) % 4 - 1).to(i32).repeat_interleave(row_len)
    rt8 = torch.tensor([0, 1, 2, -1, 2, 1, 0, 2], dtype=i32, device=dev)
    for r, ranks in ((8, (8, 4, 8)), (16, (16, 8, 12)), (64, (64, 16, 40)),
                     (96, (96, 16, 64)), (128, (128, 8, 100)), (320, (320, 64, 200))):
        T = len(ranks)
        a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
        b = torch.randn((T, r, d_out), generator=g, device=dev) * 0.02
        for t, rk in enumerate(ranks):
            b[t, rk:] = 0.0
        b = b.to(bf16)
        scale = torch.tensor([16.0 / rk for rk in ranks], dtype=torch.float32, device=dev)
        where = f"grouped_lora rank {r} ranks {ranks}"
        x8 = torch.randn((8, d_in), generator=g, device=dev).to(bf16)
        y8 = gl.grouped_lora_cuda(x8, a, b, rt8, scale)
        err = {"fwd_M8": compare(y8, gl.grouped_lora_plain(x8, a, b, rt8, scale),
                                 where + " M=8")[0]}
        x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
        gy = torch.randn((M, d_out), generator=g, device=dev).to(bf16)
        y, h = gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)
        dx, da, db = gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)
        for n, o, o2 in zip(("dx", "dA", "dB"), (dx, da, db),
                            gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)):
            _same_bits(torch, o, o2, f"{where} {n}")
        xr, ar, br = (t.clone().requires_grad_(True) for t in (x, a, b))
        y_ref = gl.grouped_lora_plain(xr, ar, br, rt, scale)
        refs = torch.autograd.grad(y_ref, (xr, ar, br), gy)
        h_ref = torch.zeros((M, r), device=dev)
        for t in range(T):
            h_ref = torch.where((rt == t)[:, None], x.float() @ a[t].float(), h_ref)
        torch.cuda.synchronize()
        if any(o[m].abs().max().item() != 0.0 for o, m in ((y8, rt8 < 0), (y, rt < 0),
                                                            (h, rt < 0), (dx, rt < 0))):
            raise AssertionError(f"{where}: a row_task = -1 row is not exactly 0")
        err["fwd"] = compare(y, y_ref, f"{where} M={M}")[0]
        err["h"] = compare(h, h_ref, f"{where} M={M} h", F32_TOL)[0]
        for n, o, ref in zip(("dx", "dA", "dB"), (dx, da, db), refs):
            err[n] = compare(o, ref, f"{where} M={M} {n}", GRAD_TOL["grouped_lora_bwd"])[0]
        emit({"phase": "train_kernels", "kernel": "grouped_lora", "case": f"rank{r}",
              "task_ranks": list(ranks), "M": M, "d_in": d_in, "d_out": d_out, "T": T, "r": r,
              "max_abs_err": err, "tol_rel": KERNEL_TOL,
              "fwd_save_h_ms": timer(lambda: gl.grouped_lora_cuda(x, a, b, rt, scale,
                                                                  save_h=True)),
              "bwd_ms": timer(lambda: gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy))})
    _lora_mixed_tile_case(torch, timer, g)


def _lora_mixed_tile_case(torch, timer, g):
    """Grouped LoRA at M = 4096 (the bind's rows) with the task changing
    every 24 rows (-1, 0, 1, 2, 3 in turn), so that most 64-row tiles of the
    kernel hold three tasks: the forward (saving h) and the backward against
    the plain version and autograd of it; the -1 rows exactly 0.  One line."""
    from repro_torch.kernels import grouped_lora as gl

    bf16, dev = torch.bfloat16, "cuda"
    M, d_in, d_out, T, r = 4096, 3072, 1024, 4, 64
    rt = (torch.arange(M, device=dev) // 24 % 5 - 1).to(torch.int32)
    scale = torch.tensor([2.0, 1.0, 2.0, 0.5], dtype=torch.float32, device=dev)
    x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
    gy = torch.randn((M, d_out), generator=g, device=dev).to(bf16)
    a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
    b = (torch.randn((T, r, d_out), generator=g, device=dev) * 0.02).to(bf16)
    y, h = gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)
    dx, da, db = gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)
    xr, ar, br = (t.clone().requires_grad_(True) for t in (x, a, b))
    y_ref = gl.grouped_lora_plain(xr, ar, br, rt, scale)
    refs = torch.autograd.grad(y_ref, (xr, ar, br), gy)
    h_ref = torch.zeros((M, r), device=dev)
    for t in range(T):
        h_ref = torch.where((rt == t)[:, None], x.float() @ a[t].float(), h_ref)
    torch.cuda.synchronize()
    where = "grouped_lora mixed-task tiles M=4096"
    if any(o[rt < 0].abs().max().item() != 0.0 for o in (y, h, dx)):
        raise AssertionError(f"{where}: a row_task = -1 row is not exactly 0")
    err = {"fwd": compare(y, y_ref, where)[0], "h": compare(h, h_ref, where + " h", F32_TOL)[0]}
    for n, o, ref in zip(("dx", "dA", "dB"), (dx, da, db), refs):
        err[n] = compare(o, ref, f"{where} {n}", GRAD_TOL["grouped_lora_bwd"])[0]
    emit({"phase": "train_kernels", "kernel": "grouped_lora", "case": "mixed_task_tiles",
          "M": M, "d_in": d_in, "d_out": d_out, "T": T, "r": r, "task_run_rows": 24,
          "max_abs_err": err, "tol_rel": KERNEL_TOL,
          "fwd_save_h_ms": timer(lambda: gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)),
          "bwd_ms": timer(lambda: gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy))})


def _scan_case(torch, g, B, S, H, resets, h0_zero, reset_rows=None):
    """Inputs of a mamba_scan call as mamba2_apply forms them: C and B rows
    (q, k) broadcast over the heads and made contiguous, x heads (v), the
    decay dt * -exp(a_log) and input gate log(dt) of a softplus dt, and
    ``la`` zeroed at the reset rows, as ``ops.mamba_scan`` does.
    ``reset_rows`` gives the rows [B, S] (else random at rate ``resets``)."""
    import torch.nn.functional as F

    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn((B, S, 1, 64), generator=g, device=dev).to(bf16).expand(B, S, H, 64)
    k = torch.randn((B, S, 1, 64), generator=g, device=dev).to(bf16).expand(B, S, H, 64)
    v = torch.randn((B, S, H, 64), generator=g, device=dev).to(bf16)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev) - 2.0)
    a_log = torch.rand((H,), generator=g, device=dev) * 2.0
    la = dt * -torch.exp(a_log)
    li = torch.log(torch.clamp(dt, min=1e-9))
    h0 = torch.zeros((B, H, 64, 64), device=dev) if h0_zero \
        else torch.randn((B, H, 64, 64), generator=g, device=dev) * 0.5
    r = reset_rows
    if r is None and resets:
        r = (torch.rand((B, S), generator=g, device=dev) < resets).to(torch.int32)
        r[0, 0] = 1  # one row starts with a reset, the others carry h0 in
    if r is not None:
        la = torch.where(r[:, :, None] > 0, torch.zeros_like(la), la)
    return [t.contiguous() for t in (q, k, v, la, li)] + [r, h0]


def _scan_work(torch, B, S, H, Q, r, want_dh0=True):
    """(bytes, operations) of the forward, state backward and chunk backward
    on these inputs: each input read once, each output written once; the
    products of the live (query, key) pairs of each chunk (same segment,
    key not after query) and the state terms of the rows they reach.  The
    state backward needs q, dy and la only on the rows its updates read
    (before each chunk's first reset; none of the first chunk's without
    ``want_dh0``, whose dh0 it then does not write)."""
    n = S // Q
    rc = torch.zeros((B, n, Q), dtype=torch.int64, device="cuda") if r is None \
        else r.reshape(B, n, Q).long()
    seg = torch.cumsum(rc, dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device="cuda"))
    pairs = int(((seg[..., :, None] == seg[..., None, :]) & tri).sum().item()) * H
    entry = int((seg == 0).sum().item()) * H
    entry_state = int((seg[:, 0 if want_dh0 else 1:] == 0).sum().item()) * H
    exit_ = int((seg == seg[..., -1:]).sum().item()) * H
    rows, dd = B * S * H, 64 * 64
    x16, f32 = rows * 64 * 2, rows * 4
    states = B * H * dd * 4
    ints = B * S * 4 if r is not None else 0
    return {
        "fwd": (3 * x16 + 2 * f32 + ints + states + x16 + states + n * states,
                4.0 * 64 * pairs + 2.0 * dd * (entry + exit_)),
        "bwd_state": (entry_state * (2 * 64 * 2 + 4) + ints + states + n * states
                      + (states if want_dh0 else 0), 2.0 * dd * entry_state),
        "bwd_chunk": (4 * x16 + 2 * f32 + ints + 2 * n * states + 3 * x16 + 2 * f32,
                      10.0 * 64 * pairs + 2.0 * dd * (entry + 2 * exit_) + 4.0 * 64 * rows),
    }


def _mamba_train_kernels(torch, timer, g, cfg, plan):
    """The three mamba_scan kernels against their plain versions and against
    autograd of the plain forward: at the training shapes (the plan's first
    hTask, its reset rows, zamba2's heads, Q = min(ssm_chunk, row_len), zero
    initial state as mamba2_apply passes it), and in a carry case of four
    chunks (S = 1024) with random resets and a non-zero initial state, and
    an unmasked one, and at serve_zamba's forward (8 rows of 95, one chunk
    of 95: partial 64-row tiles).  Tolerances: y and dq/dk/dv (bf16) within KERNEL_TOL of
    their largest magnitude, as the other bf16 outputs; the f32 outputs (h,
    hin, dla, dli, dh0, and gexit against the plain state backward) within
    F32_TOL of theirs: sums in another order.  Each case runs every kernel
    twice for the same bits, and the backward again without dh0
    (``want_dh0=False``: the same gexit and dq, dk, dv, dla, dli bits, no
    dh0).  The path case's line also holds each kernel's registers and
    spills (ptxas), its dynamic shared memory and how many of its blocks an
    SM holds (no kernel may spill), the state backward's time without dh0,
    and the unmasked case's line its time with every product live."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as ms

    h0_ = plan.htasks[0]
    B, S = h0_.rows, h0_.row_len
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    reset = torch.as_tensor(plan.alignment[0].arrays()["reset"], device="cuda")
    Sd = ZAMBA_SERVE_STEPS  # serve_zamba's forward: one chunk of 95 rows
    cases = {"path": (B, S, Q, _scan_case(torch, g, B, S, H, 0, True,
                                          (reset > 0).to(torch.int32))),
             "carry": (2, 1024, 256, _scan_case(torch, g, 2, 1024, H, 0.004, False)),
             "unmasked": (2, 1024, 256, _scan_case(torch, g, 2, 1024, H, 0, False)),
             "serve_forward": (8, Sd, Sd, _scan_case(torch, g, 8, Sd, H, 0, True))}
    results = {}
    worst = dict.fromkeys(("mamba_scan", "mamba_scan_bwd_state", "mamba_scan_bwd_chunk"), 0.0)
    for case, (Bc, Sc, Qc, (q, k, v, la, li, r, h0)) in cases.items():
        where = f"mamba_scan {case} B={Bc} S={Sc} H={H} Q={Qc}"
        y, h, hin = ms.mamba_scan_cuda(q, k, v, la, li, r, h0, Qc, save_states=True)
        for a_, b_ in zip((y, h, hin), ms.mamba_scan_cuda(q, k, v, la, li, r, h0, Qc,
                                                          save_states=True)):
            _same_bits(torch, a_, b_, where + " forward")
        ts = [t.clone().requires_grad_(True) for t in (q, k, v, la, li, h0)]
        y_ref, h_ref, hin_ref = ms.mamba_scan_plain(*ts[:5], r, ts[5], Qc, save_states=True)
        dy = torch.randn(y.shape, generator=g, device="cuda").to(torch.bfloat16)
        dhf = torch.randn(h.shape, generator=g, device="cuda") * 0.3
        got = ms.mamba_scan_backward_cuda(q, k, v, la, li, r, hin, h, dy, dhf, Qc)
        gexit, dh0 = ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc)
        for a_, b_ in zip((gexit, dh0), ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc)):
            _same_bits(torch, a_, b_, where + " state backward")
        gexit_ref = ms.mamba_scan_bwd_state_plain(q, la, r, dy, dhf, Qc)[0]
        no_dh0 = ms.mamba_scan_backward_cuda(q, k, v, la, li, r, hin, h, dy, dhf, Qc,
                                             want_dh0=False)
        gexit_no_dh0, none = ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc, want_dh0=False)
        if no_dh0[5] is not None or none is not None:
            raise AssertionError(f"{where}: want_dh0=False returned a dh0")
        for name, a_, b_ in zip(("gexit", "dq", "dk", "dv", "dla", "dli"),
                                (gexit_no_dh0, *no_dh0[:5]), (gexit, *got[:5])):
            _same_bits(torch, a_, b_, f"{where} want_dh0=False {name}")
        chunk_out = ms.mamba_scan_bwd_chunk_cuda(q, k, v, la, li, r, dy, hin, gexit, Qc)
        for a_, b_ in zip(chunk_out, ms.mamba_scan_bwd_chunk_cuda(q, k, v, la, li, r, dy, hin,
                                                                  gexit, Qc)):
            _same_bits(torch, a_, b_, where + " chunk backward")
        refs = torch.autograd.grad((y_ref.float() * dy.float()).sum() + (h_ref * dhf).sum(), ts,
                                   retain_graph=True)
        torch.cuda.synchronize()
        err = {"y": compare(y, y_ref, where + " y")[0],
               "h": compare(h, h_ref, where + " h", F32_TOL)[0],
               "hin": compare(hin, hin_ref, where + " hin", F32_TOL)[0],
               "gexit": compare(gexit, gexit_ref, where + " gexit", F32_TOL)[0]}
        for name, got_t, ref_t in zip(("dq", "dk", "dv", "dla", "dli", "dh0"), got, refs):
            tol = GRAD_TOL["mamba_scan_bwd_chunk"] if name in ("dq", "dk", "dv") else F32_TOL
            err[name] = compare(got_t, ref_t, f"{where} {name}", tol)[0]
        case_err = {"mamba_scan": max(err["y"], err["h"], err["hin"]),
                    "mamba_scan_bwd_state": max(err["dh0"], err["gexit"]),
                    "mamba_scan_bwd_chunk": max(err[n] for n in ("dq", "dk", "dv", "dla", "dli"))}
        worst = {name: max(worst[name], case_err[name]) for name in worst}
        line = {"phase": "train_kernels", "kernel": "mamba_scan", "model": cfg.name,
                "case": case, "B": Bc, "S": Sc, "H": H, "dk": 64, "dv": 64, "Q": Qc,
                "reset_rows": 0 if r is None else int(r.sum().item()),
                "h0_nonzero": bool(h0.abs().max().item() > 0), "max_abs_err": err}
        if case == "path":
            ptxas = [e for e in _build.ptxas_report() if e["source"] == "mamba_scan.cu"]
            resources = {}
            for kernel in ms._KINDS:
                rep = next(e for e in ptxas if kernel + "_kernel" in e["kernel"])
                occ = ms.occupancy(kernel, Qc)
                if occ["smem_bytes"] != ms.smem_bytes(kernel, Qc):
                    raise AssertionError(f"{kernel}: {occ['smem_bytes']} bytes of shared memory, "
                                         f"smem_bytes says {ms.smem_bytes(kernel, Qc)}")
                if rep["spill_stores"] + rep["spill_loads"]:
                    raise AssertionError(f"{kernel} spills: {rep}")
                resources[kernel] = {key: rep[key] for key in
                                     ("registers", "spill_stores", "spill_loads")} | occ
            line["resources"] = resources
            plain_in = (q, k, v, la, li, r, h0, Qc)
            times = {
                "mamba_scan": (timer(lambda: ms.mamba_scan_cuda(*plain_in, save_states=True)),
                               timer(lambda: ms.mamba_scan_plain(*plain_in, save_states=True))),
                "mamba_scan_bwd_state": (
                    timer(lambda: ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc)),
                    timer(lambda: ms.mamba_scan_bwd_state_plain(q, la, r, dy, dhf, Qc))),
                "mamba_scan_bwd_chunk": (
                    timer(lambda: ms.mamba_scan_bwd_chunk_cuda(q, k, v, la, li, r, dy, hin,
                                                               gexit, Qc)),
                    timer(lambda: ms.mamba_scan_bwd_chunk_plain(q, k, v, la, li, r, dy, hin,
                                                                gexit, Qc)))}
            # device time too: the state backward is shorter than its launch
            dev_ms = {
                "mamba_scan": kernel_device_ms(
                    torch, timer, lambda: ms.mamba_scan_cuda(*plain_in, save_states=True),
                    "mamba_scan_fwd"),
                "mamba_scan_bwd_state": kernel_device_ms(
                    torch, timer, lambda: ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc),
                    "mamba_scan_bwd_state"),
                "mamba_scan_bwd_chunk": kernel_device_ms(
                    torch, timer, lambda: ms.mamba_scan_bwd_chunk_cuda(
                        q, k, v, la, li, r, dy, hin, gexit, Qc), "mamba_scan_bwd_chunk")}
            autograd_ms = _autograd_ms(torch, timer, (y_ref.float() * dy.float()).sum()
                                       + (h_ref * dhf).sum(), ts, None)
            work = _scan_work(torch, Bc, Sc, H, Qc, r)
            shape = (f"B={Bc}, S={Sc}, H={H}, dk=dv=64, Q={Qc}, the plan's reset rows "
                     f"({line['reset_rows']}), h0 = 0")
            for name, key in (("mamba_scan", "fwd"), ("mamba_scan_bwd_state", "bwd_state"),
                              ("mamba_scan_bwd_chunk", "bwd_chunk")):
                bms, by = bound_ms(*work[key])
                results[name] = {"shape": shape, "ms": times[name][0],
                                 "device_ms": dev_ms[name], "plain_ms": times[name][1],
                                 "bound_ms": bms, "bound_by": by, "library_ms": None}
                line[key] = {k_: v_ for k_, v_ in results[name].items() if k_ != "shape"}
            line["plain_autograd_backward_ms"] = autograd_ms
            line["bwd_state"]["want_dh0_false"] = {
                "ms": timer(lambda: ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc,
                                                                 want_dh0=False)),
                "device_ms": kernel_device_ms(
                    torch, timer, lambda: ms.mamba_scan_bwd_state_cuda(
                        q, la, r, dy, dhf, Qc, want_dh0=False), "mamba_scan_bwd_state"),
                "bound_ms": bound_ms(*_scan_work(torch, Bc, Sc, H, Qc, r, False)["bwd_state"])[0]}
        if case == "unmasked":  # every product of the state backward live
            bms, by = bound_ms(*_scan_work(torch, Bc, Sc, H, Qc, r)["bwd_state"])
            line["bwd_state"] = {
                "device_ms": kernel_device_ms(
                    torch, timer, lambda: ms.mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, Qc),
                    "mamba_scan_bwd_state"), "bound_ms": bms, "bound_by": by}
        emit(line)
    for name in worst:  # over the three cases
        results[name]["max_abs_err"] = worst[name]
    return results


def _xlstm_scan_case(torch, g, B, S, resets, h0_zero, reset_rows=None, open_rows=True):
    """Inputs of a mamba_scan call as mlstm_apply forms them at xlstm-1.3b's
    width (H = 4, dk = 1024, dv = 1025): q, k / sqrt(1024) and v with its
    ones-column (bf16; the division by 32 is exact), log-sigmoid gates of
    a forget pre-activation around 2 and an input one around 0, ``la``
    zeroed at the reset rows as ``ops.mamba_scan`` does.  ``reset_rows``
    gives the rows [B, S] (else random at rate ``resets``, each row opening
    a segment when ``open_rows``, as a packed training row does)."""
    import torch.nn.functional as F

    dev, bf16, H, dk = "cuda", torch.bfloat16, XLSTM_HEADS, XLSTM_DK
    q = torch.randn((B, S, H, dk), generator=g, device=dev).to(bf16)
    k = (torch.randn((B, S, H, dk), generator=g, device=dev).to(bf16).float() / 32.0).to(bf16)
    v = torch.cat([torch.randn((B, S, H, dk), generator=g, device=dev),
                   torch.ones((B, S, H, 1), device=dev)], dim=-1).to(bf16)
    la = F.logsigmoid(torch.randn((B, S, H), generator=g, device=dev) + 2.0)
    li = F.logsigmoid(torch.randn((B, S, H), generator=g, device=dev))
    h0 = torch.zeros((B, H, dk, dk + 1), device=dev) if h0_zero \
        else torch.randn((B, H, dk, dk + 1), generator=g, device=dev) * 0.5
    r = reset_rows
    if r is None and resets:
        r = (torch.rand((B, S), generator=g, device=dev) < resets).to(torch.int32)
        if open_rows:
            r[:, 0] = 1
    if r is not None:
        la = torch.where(r[:, :, None] > 0, torch.zeros_like(la), la)
    return [t.contiguous() for t in (q, k, v, la, li)] + [r, h0]


def _xlstm_scan_work(torch, B, S, H, Q, dk, dv, r, h0_zero):
    """(bytes, operations) of the scan at (dk, dv) on these inputs (what the
    function needs, not what the tiled kernel does): q, k, v, la, li, r and
    h0 read once, y and the final state written once; per chunk the live
    (query, key) pairs' scores and P v (2 (dk + dv) each), the entry state's
    q H on the rows it reaches where that state is not zero (not in the
    first chunk from h0 = 0, nor after a chunk cut by a reset: a carried
    zero), and the update's k v on the rows that feed the exit state."""
    n = S // Q
    rc = torch.zeros((B, n, Q), dtype=torch.int64, device="cuda") if r is None \
        else r.reshape(B, n, Q).long()
    seg = torch.cumsum(rc, dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device="cuda"))
    pairs = int(((seg[..., :, None] == seg[..., None, :]) & tri).sum().item()) * H
    entry_rows = (seg == 0).sum(dim=2)  # [B, n]
    live_in = torch.ones((B, n), dtype=torch.bool, device="cuda")
    live_in[:, 0] = not h0_zero
    for c in range(1, n):  # a chunk's entry state is zero where every earlier one was cut
        live_in[:, c] = live_in[:, c - 1] | (seg[:, c - 1, -1] > 0)
    entry = int((entry_rows * live_in).sum().item()) * H
    exit_ = int((seg == seg[..., -1:]).sum().item()) * H
    rows = B * S * H
    state = B * H * dk * dv * 4
    nbytes = (2 * rows * dk * 2 + rows * dv * 2 + 2 * rows * 4 + (B * S * 4 if r is not None
              else 0) + state + rows * dv * 2 + state)
    return nbytes, 2.0 * (dk + dv) * pairs + 2.0 * dk * dv * (entry + exit_)


def _xlstm_bwd_work(torch, B, S, H, Q, dk, dv, r, h0_zero, dhf_zero, want_dh0):
    """(bytes, operations) of the state and the chunk backward at (dk, dv)
    on these inputs, by the rule of ``_xlstm_scan_work`` (what the function
    needs, not what the tiled kernels do).  The state backward reads q, dy
    and la on the rows its updates need (a chunk's rows before its first
    reset; none of the first chunk's without ``want_dh0``), r and dhf, and
    writes every chunk's gexit (and dh0); it does 2 dk dv per such row.  The
    chunk backward reads q, k, v, dy, la, li, r, hin and gexit and writes
    dq, dk, dv, dcum and dli; per live (query, key) pair it takes both
    scores and the three products (2 (3 dk + 2 dv)), the entry state's dy
    H_in^T on the rows it reaches where H_in is not zero, the exit
    adjoint's v G^T and k G on the rows that feed it where G_exit is not
    zero (after the last chunk G_exit is dhf; before chunk c it is zero
    where chunk c neither carries a live one through nor has a row before
    its first reset), and the rows' q . dq and k . dk (4 dk)."""
    n = S // Q
    rc = torch.zeros((B, n, Q), dtype=torch.int64, device="cuda") if r is None \
        else r.reshape(B, n, Q).long()
    seg = torch.cumsum(rc, dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device="cuda"))
    pairs = int(((seg[..., :, None] == seg[..., None, :]) & tri).sum().item()) * H
    entry_rows = (seg == 0).sum(dim=2)  # [B, n]
    exit_rows = (seg == seg[..., -1:]).sum(dim=2)
    carry = seg[..., -1] == 0
    live_in = torch.ones((B, n), dtype=torch.bool, device="cuda")
    live_in[:, 0] = not h0_zero
    live_exit = torch.zeros((B, n), dtype=torch.bool, device="cuda")
    live_exit[:, n - 1] = not dhf_zero
    for c in range(n - 1, 0, -1):
        live_exit[:, c - 1] = (carry[:, c] & live_exit[:, c]) | (entry_rows[:, c] > 0)
    needed = torch.ones((B, n), dtype=torch.bool, device="cuda")
    needed[:, 0] = want_dh0
    upd = int((entry_rows * needed).sum().item()) * H
    entry = int((entry_rows * live_in).sum().item()) * H
    exit_ = int((exit_rows * live_exit).sum().item()) * H
    rows = B * S * H
    state = B * H * dk * dv * 4
    ints = B * S * 4 if r is not None else 0
    return {"bwd_state": (upd * (2 * dk + 2 * dv + 4) + ints + state + n * state
                          + (state if want_dh0 else 0), 2.0 * dk * dv * upd),
            "bwd_chunk": (rows * (4 * dk + 4 * dv + 8) + ints + 2 * n * state
                          + rows * (4 * dk + 2 * dv + 8),
                          2.0 * (3 * dk + 2 * dv) * pairs + 2.0 * dk * dv * (entry + 2 * exit_)
                          + 4.0 * dk * rows)}


def _scan_resources(ms, ptxas, kinds) -> dict:
    """Each tiled-scan kernel of ``kinds`` (keys of ``ms._KINDS``): its
    registers and spills (``ptxas``, which fails on a spill), its dynamic
    shared memory and blocks per SM at a chunk of 256."""
    out = {}
    for kind in kinds:
        kernel = kind + "_kernel"
        rep = next(e for name, e in ptxas.items() if kernel in name)
        if rep["spill_stores"] + rep["spill_loads"]:
            raise AssertionError(f"{kernel} spills: {rep}")
        out[kernel] = {key: rep[key] for key in ("registers", "spill_stores", "spill_loads")}
        out[kernel].update(ms.occupancy(kind, 256))
    return out


def _xlstm_train_kernels(torch, timer, g, ptxas):
    """The tiled state and chunk backward kernels at xlstm-1.3b's (1024,
    1025) state, v, dy and the states padded with zero columns to 1088 as
    ``ops.tile_padded``'s autograd hands them: the path case (the
    train_xlstm plan's hTask, its reset rows, one chunk of 256, h0 = 0, the
    final state's gradient 0, no dh0: what training runs), a carry case (2
    x 512: two chunks, a random h0 and dhf, dh0 wanted; also through
    ``ops.mamba_scan`` under autograd, as the model calls it) and a
    four-chunk case (2 x 1024, random resets inside the rows, h0 reaching
    the rows before the first, dh0 wanted).  Each kernel against its plain
    version on the same operands (``mamba_scan_bwd_state_plain``,
    ``mamba_scan_bwd_chunk_plain``) and the whole backward against autograd
    of ``mamba_scan_plain`` on the unpadded operands: dq, dk, dv (bf16)
    within KERNEL_TOL of their largest magnitude, gexit, dh0, dcum, dla and
    dli (f32) within F32_TOL; the padded columns of dv, gexit and dh0
    exactly 0; each kernel twice for the same bits; no spill (``ptxas``).
    Each case's line has ms, device ms, the bound by bytes and by
    operations (``_xlstm_bwd_work``) and the plain ms; the chunk
    backward's also each launch's device ms (scores, outputs, rows:
    ``launch_device_ms``) and its scratch (``memory``).  Entries
    ``mamba_scan_bwd_state_tiled_xlstm`` and
    ``mamba_scan_bwd_chunk_tiled_xlstm`` (the path case, the others as
    variants, the worst error over the three)."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    resources = _scan_resources(ms, ptxas, ("mamba_scan_bwd_state_tiled", "mamba_scan_bwd_scores",
                                            "mamba_scan_bwd_outputs", "mamba_scan_bwd_rows"))
    cfg, _, plan, _ = xlstm_plan()
    ht = plan.htasks[0]
    H, dk, dv = XLSTM_HEADS, XLSTM_DK, XLSTM_DK + 1
    pad = -dv % ms.TILE
    reset = torch.as_tensor(plan.alignment[0].arrays()["reset"], device="cuda")
    Q = min(cfg.ssm_chunk, ht.row_len)
    # (B, S, Q, input arguments, dhf and dh0 live)
    cases = {"path": (ht.rows, ht.row_len, Q, dict(resets=0, h0_zero=True,
                                                   reset_rows=(reset > 0).to(torch.int32)), False),
             "carry": (2, 512, 256, dict(resets=0, h0_zero=False), True),
             "four_chunk": (2, 1024, 256, dict(resets=0.004, h0_zero=False, open_rows=False), True)}
    chunk_tol = GRAD_TOL["mamba_scan_bwd_chunk"]
    out = {"state": {}, "chunk": {}}
    worst = {"state": 0.0, "chunk": 0.0}
    for case, (B, S, Qc, kw, live) in cases.items():
        where = f"mamba_scan tiled backward {case} B={B} S={S} H={H} dk={dk} dv={dv} Q={Qc}"
        q, k, v, la, li, r, h0 = _xlstm_scan_case(torch, g, B, S, **kw)
        dy = torch.randn(v.shape, generator=g, device="cuda").to(torch.bfloat16)
        dhf = torch.randn(h0.shape, generator=g, device="cuda") * 0.3 if live \
            else torch.zeros_like(h0)
        vp, h0p, dyp, dhfp = (F.pad(t, (0, pad)).contiguous() for t in (v, h0, dy, dhf))
        with torch.no_grad():
            _, h, hin = ms.mamba_scan_tiled_cuda(q, k, vp, la, li, r, h0p, Qc, save_states=True)
            st_args = (q, la, r, dyp, dhfp, Qc, live)
            gexit, dh0 = ms.mamba_scan_bwd_state_tiled_cuda(*st_args)
            for a_, b_ in zip((gexit, dh0), ms.mamba_scan_bwd_state_tiled_cuda(*st_args)):
                if a_ is not None:
                    _same_bits(torch, a_, b_, where + " state backward")
            ch_args = (q, k, vp, la, li, r, dyp, hin, gexit, Qc)
            got = ms.mamba_scan_bwd_chunk_tiled_cuda(*ch_args)
            for a_, b_ in zip(got, ms.mamba_scan_bwd_chunk_tiled_cuda(*ch_args)):
                _same_bits(torch, a_, b_, where + " chunk backward")
            gexit_ref, dh0_ref = ms.mamba_scan_bwd_state_plain(*st_args)
            ref = ms.mamba_scan_bwd_chunk_plain(*ch_args)
            full = ms.mamba_scan_backward_cuda(q, k, vp, la, li, r, hin, h, dyp, dhfp, Qc, live)
        err = {"gexit": compare(gexit, gexit_ref, where + " gexit", F32_TOL)[0]}
        pads = [gexit[..., dv:], got[2][..., dv:]]
        if live:
            err["dh0"] = compare(dh0, dh0_ref, where + " dh0", F32_TOL)[0]
            pads.append(dh0[..., dv:])
        if any(bool(t.abs().max().item() > 0) for t in pads):
            raise AssertionError(f"{where}: a padded column of dv, gexit or dh0 is not 0")
        for name, a_, b_, tol in zip(("dq", "dk", "dv", "dcum", "dli"), got, ref,
                                     (chunk_tol,) * 3 + (F32_TOL,) * 2):
            err[name] = compare(a_, b_, f"{where} {name} (plain chunk backward)", tol)[0]
        ts = [t.clone().requires_grad_(True) for t in (q, k, v, la, li, h0)]
        y_ref, h_ref = ms.mamba_scan_plain(*ts[:5], r, ts[5], Qc)
        refs = torch.autograd.grad((y_ref.float() * dy.float()).sum() + (h_ref * dhf).sum(), ts)
        got_full = (full[0], full[1], full[2][..., :dv], full[3], full[4],
                    full[5][..., :dv] if live else None)
        auto = {}
        for name, a_, b_ in zip(("dq", "dk", "dv", "dla", "dli", "dh0"), got_full, refs):
            if a_ is not None:
                tol = chunk_tol if name in ("dq", "dk", "dv") else F32_TOL
                auto[name] = compare(a_, b_, f"{where} {name} (autograd)", tol)[0]
        line = {"phase": "xlstm_kernels", "card": card(), "kernel": "mamba_scan_tiled_backward",
                "case": case, "B": B, "S": S, "H": H, "dk": dk, "dv": dv, "dv_padded": dv + pad,
                "Q": Qc, "reset_rows": 0 if r is None else int(r.sum().item()),
                "h0_nonzero": live, "dhf_nonzero": live, "want_dh0": live,
                "max_abs_err": err, "max_abs_err_vs_autograd": auto,
                "tol_rel": {"dq_dk_dv": chunk_tol, "f32": F32_TOL}}
        if case == "carry":  # the op as the model calls it, under autograd, on the kernels
            before = ops.launch_counts()
            ts = [t.clone().requires_grad_(True) for t in (q, k, v, la, li, h0)]
            y_op, h_op = ops.mamba_scan(*ts[:5], chunk=Qc, reset=r, h0=ts[5])
            grads = torch.autograd.grad((y_op.float() * dy.float()).sum() + (h_op * dhf).sum(),
                                        ts)
            ran = {key: n_ - before[key] for key, n_ in ops.launch_counts().items()
                   if n_ != before[key]}
            if ran != {"mamba_scan_tiled": 1, "mamba_scan_bwd_state_tiled": 1,
                       "mamba_scan_bwd_chunk_tiled": 1}:
                raise AssertionError(f"{where}: ops.mamba_scan under autograd launched {ran}")
            line["ops_mamba_scan_vs_autograd"] = {
                name: compare(a_, b_, f"{where} {name} (ops.mamba_scan)",
                              chunk_tol if name in ("dq", "dk", "dv") else F32_TOL)[0]
                for name, a_, b_ in zip(("dq", "dk", "dv", "dla", "dli", "dh0"), grads, refs)}
            del grads, y_op, h_op
        del ts, y_ref, h_ref, refs, full, got_full, ref, gexit_ref, dh0_ref
        work = _xlstm_bwd_work(torch, B, S, H, Qc, dk, dv, r, kw["h0_zero"], not live, live)
        shape = (f"B={B}, S={S}, H={H}, (dk, dv) = ({dk}, {dv}) padded to ({dk}, {dv + pad}), "
                 f"Q={Qc}, reset rows {line['reset_rows']}, h0 and dhf "
                 f"{'random' if live else '0'}, dh0 {'wanted' if live else 'not wanted'}")
        for key, fn, plain, dev_key in (
                ("state", lambda: ms.mamba_scan_bwd_state_tiled_cuda(*st_args),
                 lambda: ms.mamba_scan_bwd_state_plain(*st_args), "mamba_scan_bwd_state_tiled"),
                ("chunk", lambda: ms.mamba_scan_bwd_chunk_tiled_cuda(*ch_args),
                 lambda: ms.mamba_scan_bwd_chunk_plain(*ch_args), "mamba_scan_bwd_")):
            bms, by = bound_ms(*work["bwd_" + key])
            launches = launch_device_ms(torch, timer, fn, dev_key, 3)
            res = {"shape": shape, "ms": timer(fn, runs=5, warmup=1),
                   "device_ms": sum(launches.values()) if launches else None,
                   "plain_ms": timer(plain, runs=3, warmup=1),
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "bytes_bound_ms": work["bwd_" + key][0] / HBM_BYTES_PER_S * 1e3,
                   "operations_bound_ms": work["bwd_" + key][1] / BF16_FLOP_PER_S * 1e3}
            if key == "chunk":
                res["launch_device_ms"] = launches
                res["memory"] = call_memory(torch, fn)
            out[key][case] = res
            line["bwd_" + key] = {k_: v_ for k_, v_ in res.items() if k_ != "shape"}
        case_err = {"state": max(err["gexit"], err.get("dh0", 0.0), auto.get("dh0", 0.0)),
                    "chunk": max(max(err[n] for n in ("dq", "dk", "dv", "dcum", "dli")),
                                 max(auto[n] for n in ("dq", "dk", "dv", "dla", "dli")))}
        worst = {key: max(worst[key], case_err[key]) for key in worst}
        if case == "path":
            line["resources"] = resources
        emit(line)
        del q, k, v, vp, h0p, dy, dyp, dhf, dhfp, h, hin, gexit, dh0, got, ch_args
        torch.cuda.empty_cache()
    results = {}
    for key, name in (("state", "mamba_scan_bwd_state_tiled_xlstm"),
                      ("chunk", "mamba_scan_bwd_chunk_tiled_xlstm")):
        own = dict(out[key]["path"])
        own["carry_variant"], own["four_chunk_variant"] = out[key]["carry"], \
            out[key]["four_chunk"]
        own["max_abs_err"] = worst[key]
        results[name] = own
    return results


def xlstm_kernel_phase(torch, timer):
    """The kernels of serve_xlstm at their shapes.  The tiled mamba_scan
    forward at xlstm-1.3b's (dk, dv) = (1024, 1025) (through
    ``ops.tile_padded``, v padded to 1088) against ``mamba_scan_plain`` on
    the card: the training shape (B = 8, S = 256, one chunk of 256, random
    resets, h0 = 0), a carry case (B = 2, S = 512: two chunks, a non-zero
    h0, the final state and the entry states wanted) and serve_xlstm's
    forward (8 rows of 95, one chunk of 95: partial 64-row tiles).  y within
    KERNEL_TOL of its largest magnitude, the final and entry states within
    F32_TOL; each case run twice for the same bits; no tiled forward kernel
    (scores, states, outputs) may spill.  Each case's line has the call's
    device ms, each launch's (``launch_device_ms``) and its scratch
    (``memory``).  Then grouped LoRA at M = 8 on the tenants'
    sites (ssm_in 2048 -> 8192, attn_q / attn_v 4096 -> 4096).  Then
    quant_matmul (the int8 paths) at the four (K, N) of a super-block's 37
    BaseOp products (``xlstm_qmm_layer``: (2048, 8192) for the mLSTM's up
    and the sLSTM's in, (4096, 4096) for q / k / v, (4096, 2048) for the
    mLSTM's down, (2048, 2048) for the sLSTM's out) at M = 8, 4096 and 2816
    (``quant_kernel_phase``).  Then the tiled state and chunk backward
    (``_xlstm_train_kernels``).  Entries ``mamba_scan_tiled_xlstm`` (the
    serve forward) with the others as variants, ``grouped_lora_xlstm``,
    ``grouped_lora_bwd_xlstm_decode``, ``quant_matmul_xlstm``,
    ``mamba_scan_bwd_state_tiled_xlstm``, ``mamba_scan_bwd_chunk_tiled_xlstm``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mamba_scan as ms

    g = torch.Generator(device="cuda").manual_seed(23)
    H, dk, dv = XLSTM_HEADS, XLSTM_DK, XLSTM_DK + 1
    Sd = XLSTM_SERVE_STEPS
    cases = {"train": (8, 256, 256, 0.01, True), "carry": (2, 512, 256, 0.0, False),
             "serve_forward": (8, Sd, Sd, 0.0, True)}
    results = {}
    ptxas = {e["kernel"]: e for e in _build.ptxas_report() if e["source"] == "mamba_scan.cu"}
    resources = _scan_resources(ms, ptxas, ("mamba_scan_scores", "mamba_scan_states",
                                            "mamba_scan_outputs"))
    with torch.no_grad():
        for case, (B, S, Q, resets, h0_zero) in cases.items():
            where = f"mamba_scan tiled {case} B={B} S={S} H={H} dk={dk} dv={dv} Q={Q}"
            q, k, v, la, li, r, h0 = _xlstm_scan_case(torch, g, B, S, resets, h0_zero)
            y, h = ops.tile_padded(ms.mamba_scan_tiled_cuda, q, k, v, la, li, r, h0, Q)
            y2, h2 = ops.tile_padded(ms.mamba_scan_tiled_cuda, q, k, v, la, li, r, h0, Q)
            _same_bits(torch, y, y2, where + " y")
            _same_bits(torch, h, h2, where + " h")
            y_ref, h_ref, hin_ref = ms.mamba_scan_plain(q, k, v, la, li, r, h0, Q,
                                                        save_states=True)
            err = {"y": compare(y, y_ref, where + " y")[0],
                   "h": compare(h, h_ref, where + " h", F32_TOL)[0]}
            # the padded operands as the op hands them to the kernel
            vp = torch.nn.functional.pad(v, (0, -dv % ms.TILE))
            h0p = torch.nn.functional.pad(h0, (0, -dv % ms.TILE))
            args = (q, k, vp, la, li, r, h0p, Q)
            if case == "carry":
                _, _, hin = ms.mamba_scan_tiled_cuda(*args, save_states=True)
                err["hin"] = compare(hin[..., :dv], hin_ref, where + " hin", F32_TOL)[0]
            del y2, h2, hin_ref
            work = _xlstm_scan_work(torch, B, S, H, Q, dk, dv, r, h0_zero)
            bms, by = bound_ms(*work)
            launches = launch_device_ms(torch, timer, lambda: ms.mamba_scan_tiled_cuda(*args),
                                        "mamba_scan_", 3)
            res = {"shape": f"B={B}, S={S}, H={H}, (dk, dv) = ({dk}, {dv}) padded to "
                            f"({dk}, {vp.shape[-1]}), Q={Q}, reset rows "
                            f"{0 if r is None else int(r.sum().item())}, h0 "
                            f"{'0' if h0_zero else 'random'}",
                   "ms": timer(lambda: ms.mamba_scan_tiled_cuda(*args), runs=5, warmup=1),
                   "launch_device_ms": launches,
                   "device_ms": sum(launches.values()) if launches else None,
                   "memory": call_memory(torch, lambda: ms.mamba_scan_tiled_cuda(*args)),
                   "plain_ms": timer(lambda: ms.mamba_scan_plain(q, k, v, la, li, r, h0, Q),
                                     runs=3, warmup=1),
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "bytes_bound_ms": work[0] / HBM_BYTES_PER_S * 1e3,
                   "operations_bound_ms": work[1] / BF16_FLOP_PER_S * 1e3,
                   "max_abs_err": max(err.values())}
            results[case] = res
            emit({"phase": "xlstm_kernels", "card": card(), "kernel": "mamba_scan_tiled",
                  "case": case, "max_abs_err": err, "tol_rel": {"y": KERNEL_TOL,
                                                                "h": F32_TOL, "hin": F32_TOL},
                  **({"resources": resources} if case == "train" else {}),
                  **{key: val for key, val in res.items() if key != "max_abs_err"}})
            del q, k, v, y, h, y_ref, h_ref, args, vp, h0p
            torch.cuda.empty_cache()
    own = dict(results["serve_forward"])
    own["train_variant"], own["carry_variant"] = results["train"], results["carry"]
    out = {"mamba_scan_tiled_xlstm": own}
    cfg = get_config(XLSTM_ARCH)
    out.update(_lora_decode_kernels(torch, timer, g, cfg, XLSTM_TARGETS, "xlstm"))
    layer = xlstm_qmm_layer(cfg)
    with torch.no_grad():
        out.update(quant_kernel_phase(
            torch, timer, tuple(dict.fromkeys(layer)), layer, model="xlstm",
            layer_what=f"the {len(layer)} BaseOp products of one super-block"))
    out.update(_xlstm_train_kernels(torch, timer, g, ptxas))
    return out


def zamba_kernel_phase(torch, timer, cfg, tasks, plan):
    """The training kernels at zamba2's shapes: grouped LoRA at the Mamba2
    projections (2560 -> 10448, ragged at the tile edge, and 5120 -> 2560)
    and the shared block's q / v (2560 -> 2560); packed attention at
    dh = 80, H = Hkv = 32; the three mamba_scan kernels."""
    g = torch.Generator(device="cuda").manual_seed(5)
    per = cfg.hybrid_period - 1
    layer = [(2560, 10448), (5120, 2560)] * per + [(2560, 2560)] * 2
    results, _ = _lora_train_kernels(
        torch, timer, g, tasks, plan, ((2560, 10448), (5120, 2560), (2560, 2560)), layer,
        f"the {2 * per + 2} LoRA sites of one super-block ({per} x ssm_in, ssm_out; "
        f"attn_q, attn_v)", cfg.name)
    results.update(_attention_train_kernels(torch, timer, g, cfg, plan, cfg.name))
    results.update(_mamba_train_kernels(torch, timer, g, cfg, plan))
    return {f"{k}_zamba2": v for k, v in results.items()}


def path_suffix(cfg) -> str:
    """A path's phase-name suffix: the model (none for llama3.2-3b), then
    ``_int8`` on an int8 backbone."""
    model = {STARCODER2_ARCH: "_starcoder2", YI_ARCH: "_yi", QWEN2VL_ARCH: "_qwen2vl",
             WHISPER_ARCH: "_whisper", XLSTM_ARCH: "_xlstm"}.get(cfg.name) or {
        "hybrid": "_zamba", "moe": "_moe"}.get(cfg.family, "")
    return model + ("_int8" if cfg.backbone_dtype == "int8" else "")


def base_op_calls(cfg) -> int:
    """BaseOp products of one forward over a token: every layer's sites; on
    the hybrid family each Mamba2 block's two and the shared block's seven
    in each super-block; on the ssm family each super-block's
    ``xlstm_qmm_layer``."""
    from repro_torch.peft.methods import base_op_dims

    if cfg.family == "ssm":
        return cfg.num_layers // cfg.slstm_period * len(xlstm_qmm_layer(cfg))
    dims = base_op_dims(cfg)
    if cfg.family != "hybrid":
        return len(dims) * cfg.num_layers
    n_super, per = cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period - 1
    return n_super * (2 * per + len(dims) - 2)


def xlstm_qmm_layer(cfg):
    """(K, N) of one ssm super-block's BaseOp products in the order they
    run: each mLSTM block's up, q, k, v and down, then the sLSTM block's in
    and out (its blocks run no MLP, in either package, whatever ``d_ff``
    says)."""
    from repro_torch.peft.methods import base_op_dims

    dims, d = base_op_dims(cfg), cfg.d_model
    mlstm = tuple(dims[s] for s in ("ssm_in", "attn_q", "attn_k", "attn_v", "ssm_out"))
    return mlstm * (cfg.slstm_period - 1) + ((d, 4 * d), (d, d))


def init_backbone(torch, gen):
    """``gen``'s backbone from its seed; where the config has q/k/v/o
    biases, which start at 0 in both packages and would hide their add,
    they are then filled from ``gen``'s generator (0.1 x N(0, 1)), and on
    the audio family the MLP's and the LayerNorms' biases too."""
    backbone = gen.init_backbone()
    biases = ("b_q", "b_k", "b_v", "b_o") + (
        ("b_fc1", "b_fc2", "b") if gen.cfg.family == "audio" else ())

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in biases:
                v.copy_(torch.randn(v.shape, generator=gen.generator, device=v.device) * 0.1)
    if gen.cfg.attention_bias:
        fill(backbone)
    return backbone


def train_phase(torch, cfg, tasks, plan, data_seed=None):
    """The training path: PEFTEngine.run_iteration on ``cfg`` (llama3.2-3b,
    zamba2-2.7b, deepseek-moe-16b, starcoder2-7b, qwen2-vl-7b or
    xlstm-1.3b), its backbone stored as ``cfg.backbone_dtype``.  With
    ``data_seed`` every task's tokens come from a numpy seed
    (``_seeded_stream(data_seed + task)``) where the synthetic corpora
    seed from Python's per-process salted ``hash``: the path then trains on
    the same batches in every run, and its check starts from the same
    state."""
    import numpy as np

    from repro_torch.core import ModelGenerator, ParallelismSpec, PEFTEngine
    from repro_torch.core.cost_model import CostModel
    from repro_torch.data import HTaskLoader
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import tensor_bytes

    int8 = cfg.backbone_dtype == "int8"
    suffix = path_suffix(cfg)
    L = cfg.num_layers
    gen = ModelGenerator(cfg, seed=0)
    init_backbone(torch, gen)
    reg = gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=TRAIN_LR)

    def streams():
        return None if data_seed is None else {
            i: _seeded_stream(data_seed + i, cfg.vocab_size) for i in range(len(tasks))}
    loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size, streams=streams())
               for i in range(len(plan.htasks))}
    summary = plan.summary()
    emit({"phase": "train_plan" + suffix, "backbone_dtype": cfg.backbone_dtype, **summary,
          "htasks": [{"task_ids": list(h.task_ids), "rows": h.rows, "row_len": h.row_len,
                      "tokens": h.tokens, "effective_tokens": h.effective_tokens}
                     for h in plan.htasks],
          "kind_capacity": reg.mta.kind_capacity, "kind_rank": reg.mta.kind_rank})
    warm = engine.run_iteration(loaders)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    iters = []
    for i in range(TRAIN_ITERS):
        m = engine.run_iteration(loaders)
        tp = engine.throughput(m)
        if not (np.isfinite(m.loss) and np.all(np.isfinite(m.per_task_loss))):
            raise AssertionError(f"iteration {i}: non-finite loss {m.per_task_loss}")
        iters.append((m, tp))
        emit({"phase": "train_iteration" + suffix, "iteration": i, "loss": m.loss,
              "per_task_loss": m.per_task_loss.tolist(), "seconds": m.wall_seconds,
              "tokens_per_s": tp["tokens_per_s"],
              "effective_tokens_per_s": tp["effective_tokens_per_s"]})
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    steps_per_iter = len(engine._schedule(None))
    n = TRAIN_ITERS * steps_per_iter
    want = dict.fromkeys(counts, 0)
    want.update({k: n * v for k, v in step_launches(cfg, reg.adapter_params).items()})
    if int8:  # every BaseOp of every layer, once per micro step (forward)
        want["quant_matmul"] = n * base_op_calls(cfg)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the plan implies {want}")
    secs = [m.wall_seconds for m, _ in iters]
    eq5 = {"cost_model_backbone_bytes": CostModel(cfg, [], ParallelismSpec()).stage_memory([])
           } if int8 else {}
    emit({"phase": "train" + suffix, "card": card(), "backbone_dtype": cfg.backbone_dtype,
          "model": cfg.name,
          "layers": L, "d_model": cfg.d_model, "backbone_bytes": tensor_bytes(engine.backbone),
          **eq5,
          "tasks": TRAIN_TASKS, "micro_batch": TRAIN_MICRO_BATCH, "lr": TRAIN_LR,
          "warmup_seconds": warm.wall_seconds, "iterations": TRAIN_ITERS,
          "micro_steps_per_iteration": steps_per_iter, "launches": counts,
          "seconds_per_iteration_median": statistics.median(secs),
          "tokens_per_s_median": statistics.median(tp["tokens_per_s"] for _, tp in iters),
          "effective_tokens_per_s_median": statistics.median(
              tp["effective_tokens_per_s"] for _, tp in iters),
          "first_per_task_loss": iters[0][0].per_task_loss.tolist(),
          "last_per_task_loss": iters[-1][0].per_task_loss.tolist(),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    prof = profile_device(torch, lambda: engine.run_iteration(loaders), 1,
                          {"grouped_lora": ("grouped_lora",),
                           "packed_attention": ("packed_attention",),
                           "mamba_scan": ("mamba_scan",),
                           "quant_matmul": ("qmm_",),
                           # f32 cuBLAS: quant_matmul's dx on int8; the Adapter
                           # method's f32 products
                           "f32_matmul": ("sgemm", "f32f32")})
    # the profiler slows the host: the device's busy share of an unprofiled
    # iteration is its device time over the timed iterations' median
    emit({"phase": "profile", "path": "train iteration" + suffix, "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(secs) * 1e3) if prof["device_ms_per_call"] else None})
    return counts, engine


def methods_train_phase(torch, cfg, tasks, plan):
    """The train_methods path: PEFTEngine.run_iteration on one tenant of
    each PEFT kind, one warm-up iteration, then ``METHODS_STEPS`` steps under
    the port's TrainSupervisor (a checkpoint every ``METHODS_CKPT_EVERY``
    steps into a temporary directory, a simulated failure before step
    ``METHODS_FAIL_AT``).  Gates: the state restored at the rollback equals,
    bit for bit, a host copy taken when its checkpoint was saved (adapters,
    AdamW step, m and v); every artifact's keys are the state's; the frozen
    leaves (VeRA's A / B, Diff-Pruning's rows) never change; losses finite;
    launches as the plan implies."""
    import tempfile

    import numpy as np

    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.data import HTaskLoader
    from repro_torch.distributed import (CheckpointStore, SupervisorConfig, TrainSupervisor,
                                         simulated_failure)
    from repro_torch.distributed.checkpoint import _flatten_with_paths
    from repro_torch.kernels import ops
    from repro_torch.peft.methods import get_method

    gen = ModelGenerator(cfg, seed=0)
    gen.init_backbone()
    reg = gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=TRAIN_LR)
    loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size)
               for i in range(len(plan.htasks))}
    emit({"phase": "train_plan_methods", **plan.summary(),
          "htasks": [{"task_ids": list(h.task_ids), "rows": h.rows, "row_len": h.row_len,
                      "tokens": h.tokens, "effective_tokens": h.effective_tokens}
                     for h in plan.htasks],
          "kind_capacity": reg.mta.kind_capacity, "kind_rank": reg.mta.kind_rank})
    warm = engine.run_iteration(loaders)

    def frozen_leaves(tree):
        return {k: t for k, t in _flatten_with_paths(tree)
                if not t.is_floating_point() or not get_method(k.split("/")[0]).trainable(
                    k.rsplit("/", 1)[1])}

    frozen = {k: t.clone() for k, t in frozen_leaves(engine.reg.adapter_params).items()}
    if sorted({k.rsplit("/", 1)[1] for k in frozen}) != ["A", "B", "rows"]:
        raise AssertionError(f"train_methods: frozen leaves {sorted(frozen)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    steps_run, iters, copies, restored, stalls = [], [], {}, [], []
    pending = {METHODS_FAIL_AT}

    def hook(i):
        if i in pending:
            pending.discard(i)
            raise simulated_failure()

    def step_fn(state, i):
        engine.reg.adapter_params, engine.reg.opt_state = state
        m = engine.run_iteration(loaders)
        if not (np.isfinite(m.loss) and np.all(np.isfinite(m.per_task_loss))):
            raise AssertionError(f"train_methods step {i}: non-finite loss {m.per_task_loss}")
        now = frozen_leaves(engine.reg.adapter_params)
        for k, t in frozen.items():
            if not torch.equal(now[k], t):
                raise AssertionError(f"train_methods step {i}: frozen leaf {k} changed")
        steps_run.append(i)
        iters.append((m, engine.throughput(m)))
        emit({"phase": "train_iteration_methods", "step": i, "loss": m.loss,
              "per_task_loss": m.per_task_loss.tolist(), "seconds": m.wall_seconds})
        return engine.reg.adapter_params, engine.reg.opt_state

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=os.path.join(tmp, "sup"),
                                               ckpt_every=METHODS_CKPT_EVERY),
                              failure_hook=hook)
        save_async, resume = sup.ckpt.save_async, sup.resume

        def recording_save(step, tree, extra=None):
            t0 = time.perf_counter()
            save_async(step, tree, extra)
            stalls.append(time.perf_counter() - t0)
            copies[step] = {k: t.detach().cpu().clone() for k, t in _flatten_with_paths(tree)}

        def recording_resume(init_state, shardings=None):
            state, i = resume(init_state, shardings)
            if sup.restarts:
                restored.append((i, {k: t.detach().cpu().clone()
                                     for k, t in _flatten_with_paths(state)}))
            return state, i

        sup.ckpt.save_async, sup.resume = recording_save, recording_resume
        t0 = time.perf_counter()
        state = sup.run((engine.reg.adapter_params, engine.reg.opt_state), step_fn,
                        METHODS_STEPS)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        # the steps before the failure, then again from the last checkpoint
        want_steps = list(range(METHODS_FAIL_AT)) + list(range(
            METHODS_FAIL_AT - METHODS_FAIL_AT % METHODS_CKPT_EVERY, METHODS_STEPS))
        if sup.restarts != 1 or steps_run != want_steps:
            raise AssertionError(f"train_methods: restarts {sup.restarts}, steps {steps_run}")
        (at, got), = restored
        want = copies[at]
        if list(got) != list(want) or any(
                got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"train_methods: the state restored at step {at} is not the "
                                 f"one saved there")
        keys = [k for k, _ in _flatten_with_paths(state)]
        sizes = {}
        for step in sorted(copies):
            path = os.path.join(tmp, "sup", f"step_{step:08d}")
            if not os.path.isdir(path):  # pruned (keep = 3)
                continue
            with open(os.path.join(path, "manifest.json")) as f:
                if list(json.load(f)["leaves"]) != keys:
                    raise AssertionError(f"train_methods: step {step}'s keys are not the state's")
            sizes[step] = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
        t0 = time.perf_counter()
        CheckpointStore(os.path.join(tmp, "sync")).save(METHODS_STEPS, state)
        save_s = time.perf_counter() - t0
    n = len(steps_run) * len(engine._schedule(None))
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update({k: n * v for k, v in step_launches(cfg, reg.adapter_params).items()})
    if counts != want_counts:
        raise AssertionError(f"kernel launches {counts}, the plan implies {want_counts}")
    secs = [m.wall_seconds for m, _ in iters]
    emit({"phase": "train_methods", "model": cfg.name, "layers": cfg.num_layers,
          "tasks": METHODS_TASKS, "micro_batch": TRAIN_MICRO_BATCH, "lr": TRAIN_LR,
          "warmup_seconds": warm.wall_seconds, "steps_run": steps_run,
          "restarts": sup.restarts, "restored_step": at, "restored_bits_equal": True,
          "checkpointed_steps": sorted(copies), "committed_bytes": sizes,
          "state_leaves": len(keys), "save_async_call_seconds": stalls,
          "save_sync_seconds": save_s, "loop_seconds": loop_s, "launches": counts,
          "seconds_per_iteration_median": statistics.median(secs),
          "tokens_per_s_median": statistics.median(tp["tokens_per_s"] for _, tp in iters),
          "effective_tokens_per_s_median": statistics.median(
              tp["effective_tokens_per_s"] for _, tp in iters),
          "last_per_task_loss": iters[-1][0].per_task_loss.tolist(),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    prof = profile_device(torch, lambda: engine.run_iteration(loaders), 1,
                          {"grouped_lora": ("grouped_lora",),
                           "packed_attention": ("packed_attention",),
                           "f32_matmul": ("sgemm", "f32f32")})
    emit({"phase": "profile", "path": "train iteration_methods", **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(secs) * 1e3) if prof["device_ms_per_call"] else None})
    return counts, engine


def _seeded_stream(seed: int, vocab: int):
    """Tokens from a numpy seed.  The synthetic corpora seed from Python's
    per-process salted ``hash``, so their batches differ from run to run;
    train_check's tolerances are held on one batch that every run sees."""
    import numpy as np

    rng = np.random.RandomState(seed)
    while True:
        yield int(rng.randint(1, vocab))


def train_check(torch, engine, seed=3, extra=None, methods=False):
    """One step's per-task losses and adapter gradients from one state, on
    the kernels, under ops.force_plain(), and under ops.force_plain() on
    f32 copies of the weights, int8 nodes dequantized (the reference); also
    under second plain paths whose distance from the first is the checks'
    noise floor: plain_scale_first() on an int8 backbone, plain_stored_o()
    on a bf16 one and plain_reordered() on a bf16 one but zamba2's.  ``extra`` maps more
    runs' names to their contexts (train_check_spread.py's), each reported
    against the plain run.  ``methods`` marks the train_methods path (its
    gate, and each layer recomputed in the plain runs' backward).  On an
    MoE backbone, and on any whose f32 copy passes 24 GB (starcoder2-7b),
    the plain runs recompute each layer too and the f32 run widens one
    layer's weights at a time (``recompute(widen=True)``: the f32 backbone
    would not fit beside the bf16 one); on MoE the routing flips (layer,
    token pairs whose expert set differs from the plain run's) of each run
    are reported.
    LoRA and DoRA B, Adapter up, IA3 s, Diff-Pruning delta, DoRA dm and
    VeRA / BitFit b start at zero, which would leave other gradients
    exactly zero: they are filled from ``seed`` first, and the batch's
    tokens come from ``seed`` too.  The frozen leaves (Diff-Pruning's
    integer rows, VeRA's shared A / B) take no gradient and are not
    compared."""
    from repro_torch.data import HTaskLoader
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import device_put_batch
    from repro_torch.peft.methods import get_method

    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def fill(tree):  # depth first, in the tree's order: one draw per filled leaf
        return {k: fill(t) if isinstance(t, dict) else
                ((torch.randn(t.shape, generator=g, device=dev) * 0.02).to(t.dtype)
                 if k in ("b", "up", "s", "delta", "dm") else t)
                for k, t in tree.items()}

    params = fill(engine.reg.adapter_params)
    if hasattr(engine, "check_batch"):  # whisper's trainer (its frames beside the tokens)
        batch = engine.check_batch(seed)
    else:
        plan, vocab = engine.plan, engine.model.cfg.vocab_size
        loader = HTaskLoader(plan.tasks, plan.alignment[0], vocab,
                             streams={i: _seeded_stream(97 + seed + i, vocab)
                                      for i in range(len(plan.tasks))})
        batch = device_put_batch(next(loader), dev)
    fn = engine._loss_and_grads_fn(0)
    cfg = engine.model.cfg
    moe = cfg.family == "moe"
    # an f32 backbone over 24 GB (deepseek-moe-16b's 67.5, starcoder2-7b's
    # 29.6, qwen2-vl-7b's 30.5) is widened a layer at a time, its plain runs
    # recomputing each layer; whisper's plain runs recompute each decoder
    # layer too (each cross-attention's f32 scores over 1500 frames)
    wide = moe or cfg.param_count() * 4 > 24e9
    # (the ssm family's plain runs recompute each mLSTM block: autograd of the
    # plain scan keeps about 0.5 GB a block at xlstm-1.3b's [1024, 1025] state)
    plain = plain_path(torch, engine.model,
                       remat=methods or wide or cfg.family in ("audio", "ssm"))
    f32_params = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    if wide:
        f32_backbone = {k: v if k == "layers" else densify(torch, v)
                        for k, v in engine.backbone.items()}
        f32_ctx = lambda: _stacked(ops.force_plain,  # noqa: E731
                                   recompute(engine.model, True, widen=True))
    else:
        f32_backbone, f32_ctx = densify(torch, engine.backbone), plain
    runs = {"kernel": (params, engine.backbone, contextlib.nullcontext),
            "plain": (params, engine.backbone, plain),
            "f32": (f32_params, f32_backbone, f32_ctx)}
    int8 = engine.model.cfg.backbone_dtype == "int8"
    if int8:  # (recomputing as the plain run does: zamba2's plain scans)
        runs["plain_scale_first"] = (params, engine.backbone,
                                     lambda: _stacked(plain, plain_scale_first))
    elif cfg.family != "ssm":  # (the ssm family runs no attention)
        runs["plain_stored_o"] = (params, engine.backbone, lambda: _stacked(plain, plain_stored_o))
    hybrid = cfg.family == "hybrid"
    if not (int8 or hybrid):  # (train_check_spread.py adds it on zamba2)
        runs["plain_reordered"] = (params, engine.backbone,
                                   lambda: _stacked(plain, plain_reordered))
    rc = recompute(engine.model, methods)
    for name, ctx in (extra or {}).items():
        runs[name] = (params, engine.backbone, lambda ctx=ctx: _stacked(rc, ctx))
    # the compared leaves: floating and trainable (a path's first registered
    # method name is its kind)
    paths = [p for p in _leaf_paths(params) if _leaf(params, p).is_floating_point()
             and get_method(next(k for k in p if k in engine.reg.mta.kind_tasks)).trainable(p[-1])]
    pt, grads, routes = {}, {}, {}
    # the f32 run takes the batch's floating entries (whisper's frames) in f32
    f32_batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    run_s = {}
    for mode, (ad, bb, ctx) in runs.items():
        routes[mode] = []
        t_run = time.perf_counter()
        with ctx(), moe_routes(routes[mode]):
            _, pt[mode], gr = fn(ad, bb, f32_batch if mode == "f32" else batch)
        grads[mode] = [_leaf(gr, p) for p in paths]
        torch.cuda.synchronize()
        run_s[mode] = time.perf_counter() - t_run
    flips = {f"{m}_vs_plain": route_flips(routes[m], routes["plain"],
                                          engine.model.cfg.num_layers)
             for m in runs if moe and m != "plain"}
    loss_rel = {m: ((pt[m] - pt["plain"]).abs() / pt["plain"].abs()).max().item()
                for m in runs if m != "plain"}
    loss_err = loss_rel["kernel"]
    names = [".".join(path) for path in paths]
    pairs = [("kernel", "plain"), ("kernel", "f32"), ("plain", "f32")]
    pairs += [(name, "plain") for name in runs if name.startswith("plain_")]
    pairs += [(name, "plain") for name in extra or {}]
    worst = {f"{a}_vs_{b}": (0.0, "") for a, b in pairs}
    for i, name in enumerate(names):
        scale = grads["f32"][i].float().abs().max().item()
        if scale == 0.0:
            raise AssertionError(f"train_check: {name} has an all-zero gradient")
        for a, b in pairs:
            err = (grads[a][i].float() - grads[b][i].float()).abs().max().item() / scale
            if err > worst[f"{a}_vs_{b}"][0]:
                worst[f"{a}_vs_{b}"] = (err, name)
    if cfg.name == XLSTM_ARCH:
        tol = XLSTM_INT8_GRAD_PATH_TOL if int8 else XLSTM_GRAD_PATH_TOL
    elif int8:
        tol = ZAMBA_INT8_GRAD_PATH_TOL if hybrid else INT8_GRAD_PATH_TOL
    elif hybrid:
        tol = ZAMBA_GRAD_PATH_TOL
    elif moe:
        tol = MOE_GRAD_PATH_TOL
    elif cfg.name == STARCODER2_ARCH:
        tol = STARCODER2_GRAD_PATH_TOL
    elif cfg.name == QWEN2VL_ARCH:
        tol = QWEN2VL_GRAD_PATH_TOL
    elif cfg.name == WHISPER_ARCH:
        tol = WHISPER_GRAD_PATH_TOL
    else:
        tol = METHODS_GRAD_PATH_TOL if methods else GRAD_PATH_TOL
    suffix = "_methods" if methods else path_suffix(cfg)
    emit({"phase": "train_check" + suffix, "seed": seed, "card": card(),
          **({"routing_flips": flips} if moe else {}),
          "per_task_loss_kernel": pt["kernel"].tolist(),
          "per_task_loss_plain": pt["plain"].tolist(), "per_task_loss_f32": pt["f32"].tolist(),
          "loss_max_rel_err": loss_err, "loss_tol_rel": LOSS_TOL,
          "loss_rel_vs_plain": loss_rel, "grad_leaves": len(names),
          "grad_err_rel_to_leaf_max": {k: {"max": v[0], "leaf": v[1]} for k, v in worst.items()},
          "grad_tol": tol, "run_seconds": run_s})
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"train_check: per-task losses {pt['kernel'].tolist()} vs plain "
                             f"{pt['plain'].tolist()}: relative {loss_err} > {LOSS_TOL}")
    if not worst["kernel_vs_plain"][0] <= tol:
        raise AssertionError(f"train_check: {worst['kernel_vs_plain'][1]} kernel vs plain "
                             f"off by {worst['kernel_vs_plain'][0]} of its max > {tol}")
    if not worst["kernel_vs_f32"][0] <= 2 * worst["plain_vs_f32"][0]:
        raise AssertionError(f"train_check: the kernel path is further from the f32 "
                             f"reference ({worst['kernel_vs_f32']}) than twice the plain "
                             f"path ({worst['plain_vs_f32']})")


@contextlib.contextmanager
def _stacked(*ctxs):
    """The contexts ``ctxs`` (callables) entered in order."""
    with contextlib.ExitStack() as stack:
        for ctx in ctxs:
            stack.enter_context(ctx())
        yield


def recompute(model, dense=False, widen=False):
    """A context factory under which ``model`` recomputes each hybrid
    super-block in the backward (``torch.utils.checkpoint``,
    non-reentrant): the JAX config's ``remat=True`` (``jax.checkpoint`` of
    the super-block), which changes no value.  Without it autograd of the
    plain scan would keep several f32 [rows, Q, Q, heads] tensors for each
    of the 45 Mamba2 blocks, more than the card holds beside the f32
    backbone.  ``dense`` recomputes each dense layer likewise, under the
    adapter context it ran in: on the train_methods path (27 rows, eight
    kinds each adding f32 [rows, S, d_out] terms at its sites) one step
    holds about 60 GB without it.  ``widen`` (with ``dense``) runs each layer
    on an f32 copy of its weights made inside the recomputed block, so that
    no more than one layer's f32 weights live at a time: the f32 run of an
    MoE backbone (16.9 B parameters, 67.5 GB in f32) holds its bf16 layers
    and widens them one at a time.  On the audio family ``dense``
    recomputes each decoder layer (``_audio_block``), on the ssm family each
    mLSTM block (``ssm.mlstm_apply``, whose plain scan keeps f32 [rows, dk,
    dv] states).  The kernel path runs without recomputation, as training
    does."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.peft.hooks import active_context, adapter_scope

    def remat_block(block):
        def run(lp, x, *args, **kw):
            scope = active_context()

            def layer(x):
                with adapter_scope(scope):
                    return block(densify(torch, lp) if widen else lp, x, *args, **kw)
            return checkpoint(layer, x, use_reentrant=False)
        return run

    @contextlib.contextmanager
    def ctx():
        if model.cfg.family == "ssm" and dense:
            from repro_torch.models import ssm

            mlstm = ssm.mlstm_apply

            def remat_mlstm(p, x, cfg, reset=None, state=None):
                if state is not None:  # (decode: nothing to recompute)
                    return mlstm(p, x, cfg, reset=reset, state=state)
                scope = active_context()

                def block(x):
                    with adapter_scope(scope):
                        return mlstm(densify(torch, p) if widen else p, x, cfg, reset=reset)
                return checkpoint(block, x, use_reentrant=False)
            ssm.mlstm_apply = remat_mlstm
            try:
                yield
            finally:
                ssm.mlstm_apply = mlstm
            return
        if model.cfg.family == "hybrid":
            name, fn = "_super_block", model._super_block
            wrapped = lambda x, *a, **kw: checkpoint(fn, x, *a,  # noqa: E731
                                                     use_reentrant=False, **kw)
        elif dense:
            name = "_audio_block" if model.cfg.family == "audio" else "_block"
            wrapped = remat_block(getattr(model, name))
        else:
            yield
            return
        setattr(model, name, wrapped)
        try:
            yield
        finally:
            delattr(model, name)
    return ctx


def plain_path(torch, model, remat=False):
    """A context for the plain versions' runs of ``model``, recomputing as
    :func:`recompute` does (dense layers when ``remat``)."""
    from repro_torch.kernels import ops

    rc = recompute(model, remat)
    return lambda: _stacked(ops.force_plain, rc)


def _leaf_paths(tree, prefix=()):
    """Paths of a nested dict's leaves, in ``tree_leaves`` order."""
    return [p for k, v in tree.items()
            for p in (_leaf_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)])]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the co-serving paths: serve_methods (the decode pool with one tenant of each
# PEFT kind) and coserve (MuxTuneService under tenant churn)

SERVE_METHODS_ROWS, SERVE_METHODS_MAX_LEN, SERVE_METHODS_NEW = 8, 1024, 32
# serve_methods and coserve run llama3.2-3b at full width and half its
# depth: both are host-bound (their time grows with the layers' launches),
# and with the MoE phases the script would otherwise run long (1,044 s
# on an H100 with both at 28 layers)
COSERVE_LAYERS = 14
# the leaves that start at zero: filled from the generator before serving, so
# that every kind's rows leave the bare backbone's
ZERO_INIT_LEAVES = ("b", "up", "s", "delta", "dm")
COSERVE_NEW, COSERVE_MAX_ITERS = 32, 16
# the coserve tenants: (id, dataset, kind, rank, micro-batch); D's larger
# micro-batch makes it wait in the queue while B is resident
COSERVE_TENANTS = (("a", "sst2", "lora", 8, 8), ("b", "qa", "prefix", 16, 8),
                   ("c", "rte", "dora", 8, 8), ("d", "sst2", "vera", 64, 32))
COSERVE_TARGETS = {"a": 8, "b": 4, "c": 50, "d": 4}
COSERVE_WARM_STEPS = 2
CARD = {}  # nvidia-smi's name and power limit (``card()``)


def card():
    """The card's name and power limit as nvidia-smi reports them, read
    once: the device line and every line of the co-serving phases carry
    them."""
    if not CARD:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        CARD.update(zip(("name", "power_limit"), (x.strip() for x in smi.split(","))))
    return CARD


def _gate_from(spread: float, base: float = LOGIT_TOL) -> float:
    """``base`` (``LOGIT_TOL``) unless twice the path's own plain-path
    spread exceeds it; then max(5%, 2 S) rounded up to 0.005."""
    import math

    if 2 * spread <= base:
        return base
    return math.ceil(max(0.05, 2 * spread) / 0.005 - 1e-9) * 0.005


def bind_kernel_cases(torch, timer, g):
    """The serving paths' new shapes, each against its plain version and run
    twice for the same bits: packed attention at the bind's prefill behind
    a prefix tenant's 16 learned rows, padded to 64 (R = 4 requests of a
    128- and a 512-token bucket, the model's q tile of 512, the prefix on
    two rows of four), timed beside SDPA under the visibility mask; decode
    attention over the pool's cache (Smax = prefix region + 1024) with the
    windows the fold opens: starts 0, 16, 48 and 64 across the rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_attention as pa

    dev, bf16, i32 = "cuda", torch.bfloat16, torch.int32
    H, Hkv, dh, P, bq = 24, 8, 128, 16, 512
    results, worst = {}, 0.0
    for Lp in (128, 512):
        R = 4
        q = torch.randn((R, Lp, H, dh), generator=g, device=dev).to(bf16)
        k = torch.randn((R, Lp, Hkv, dh), generator=g, device=dev).to(bf16)
        v = torch.randn((R, Lp, Hkv, dh), generator=g, device=dev).to(bf16)
        pk = torch.randn((R, P, Hkv, dh), generator=g, device=dev).to(bf16)
        pv = torch.randn((R, P, Hkv, dh), generator=g, device=dev).to(bf16)
        keep = torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)[:, None].expand(R, P).contiguous()
        kw = {"prefix_kv": (pk, pv), "prefix_keep": keep, "block_q": bq}
        before = ops.launch_counts()["packed_attention"]
        out = ops.packed_attention(q, k, v, **kw)
        out2 = ops.packed_attention(q, k, v, **kw)
        launched = ops.launch_counts()["packed_attention"] - before
        with ops.force_plain():
            ref = ops.packed_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if launched != 2:
            raise AssertionError(f"packed_attention bind{Lp}: {launched} launches, want 2")
        _same_bits(torch, out, out2, f"packed_attention bind{Lp}")
        err, rel, tol = compare(out, ref, f"packed_attention bind{Lp}")
        worst = max(worst, err)
        Pp = ops.padded_prefix_rows(Lp, P)
        Sk = Lp + Pp
        # the visibility mask of the call: causal prompt keys, the owned
        # prefix rows (pad rows and unowned rows unseen)
        qpos = torch.arange(Lp, device=dev)
        causal = qpos[:, None] >= qpos[None, :]
        pre = torch.zeros((R, Lp, Pp), dtype=torch.bool, device=dev)
        pre[:, :, :P] = (keep > 0)[:, None, :]
        mask = torch.cat([pre, causal.expand(R, Lp, Lp)], dim=2)
        ks, vs = torch.cat([F.pad(pk, (0, 0, 0, 0, 0, Pp - P)), k], 1), \
            torch.cat([F.pad(pv, (0, 0, 0, 0, 0, Pp - P)), v], 1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ks, vs))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                                  enable_gqa=True)
        pairs = int(mask.sum().item()) * H
        # the bytes the function must move: q and out, the prompt keys and
        # values, the prefix rows of the requests that own them (not the
        # pad rows, not the unowned rows), and prefix_keep
        kv_rows = R * Lp + int((keep[:, 0] > 0).sum().item()) * P
        nbytes = 2 * (2 * R * Lp * H * dh + 2 * kv_rows * Hkv * dh) + 4 * R * P
        bms, by = bound_ms(nbytes, 4.0 * dh * pairs)
        call = lambda: ops.packed_attention(q, k, v, **kw)  # noqa: E731
        with ops.force_plain():
            plain_ms = timer(call)
        entry = {"ms": timer(call),
                 "device_ms": kernel_device_ms(torch, timer, call, "packed_attention_fwd"),
                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": timer(sdpa), "library_device_ms": library_device_ms(torch, timer,
                                                                                   sdpa)}
        emit({"phase": "kernels", "kernel": "packed_attention", "case": f"bind_prefix_{Lp}",
              "card": card(), "R": R, "S": Lp, "Sk": Sk, "prefix_rows": P,
              "padded_prefix_rows": Pp, "kv_rows_in_bound": kv_rows, "H": H, "Hkv": Hkv, "dh": dh,
              "tiles": list(pa.tile_sizes(Lp, Sk, bq)), "max_abs_err": err,
              "max_rel_err": rel, "tol": tol, "same_bits_twice": True, **entry})
        results[f"packed_attention_bind_prefix_{Lp}"] = {
            "shape": f"R={R}, S={Lp}, Sk={Sk} ({P} prefix rows padded to {Pp}), H={H}, "
                     f"Hkv={Hkv}, dh={dh}, causal, the prefix on 2 rows of 4",
            **entry, "max_abs_err": err}

    # decode attention over the pool's cache: prefix region 64, 1024 rows
    pres, Bd = 64, 8
    Smax = pres + 1024
    qd = torch.randn((Bd, 1, H, dh), generator=g, device=dev).to(bf16)
    kc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    vc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    start = torch.tensor([0, 48, 64, 64, 16, 48, 64, 0], dtype=i32, device=dev)
    end = torch.tensor([pres + 512 + 32, pres + 97, pres + 300, Smax, pres + 65, pres + 1,
                        pres + 700, pres + 1000], dtype=i32, device=dev)
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(qd, kc, vc, end, start)
    out2 = ops.decode_attention(qd, kc, vc, end, start)
    launched = ops.launch_counts()["decode_attention"] - before
    with ops.force_plain():
        ref = ops.decode_attention(qd, kc, vc, end, start)
    torch.cuda.synchronize()
    if launched != 2:
        raise AssertionError(f"decode_attention pool: {launched} launches, want 2")
    _same_bits(torch, out, out2, "decode_attention pool")
    err, rel, tol = compare(out, ref, "decode_attention pool")
    worst = max(worst, err)
    pos = torch.arange(Smax, device=dev)
    mask = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])
    qt = qd.transpose(1, 2).contiguous()
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)
    call = lambda: ops.decode_attention(qd, kc, vc, end, start)  # noqa: E731
    with ops.force_plain():
        plain_ms = timer(call)
    window = int((end - start).clamp_min(0).sum().item())
    nbytes = 2 * (2 * Bd * H * dh + 2 * window * Hkv * dh) + 4 * 2 * Bd
    bms, by = bound_ms(nbytes, 4.0 * H * dh * window)
    entry = {"ms": timer(call),
             "device_ms": kernel_device_ms(torch, timer, call, "decode_attention_kernel"),
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": timer(sdpa),
             "library_device_ms": library_device_ms(torch, timer, sdpa)}
    emit({"phase": "kernels", "kernel": "decode_attention", "case": "pool_prefix_windows",
          "card": card(), "B": Bd, "Smax": Smax, "prefix_reserve": pres,
          "starts": start.tolist(), "ends": end.tolist(), "H": H, "Hkv": Hkv, "dh": dh,
          "window_rows": window, "max_abs_err": err, "max_rel_err": rel, "tol": tol,
          "same_bits_twice": True, **entry})
    results["decode_attention_pool"] = {
        "shape": f"B={Bd}, Smax={Smax} (prefix region {pres}), starts 0-64, "
                 f"{window} window rows", **entry, "max_abs_err": err}
    return results, worst


def _fill_zero_leaves(torch, adapters, generator):
    """Fill every zero-init adapter leaf (``ZERO_INIT_LEAVES``) from the
    generator, in place."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ZERO_INIT_LEAVES and v is not None and v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=generator, device=v.device) * 0.02)
    walk(adapters)


def serve_methods_phase(torch):
    """The serve_methods path: llama3.2-3b at full width and
    ``COSERVE_LAYERS`` layers (bf16,
    random weights from a seed), one tenant of each PEFT kind on the
    attention sites (``METHODS_TASKS``), the zero-init leaves filled; an
    8-row pool of max_len 1024 (its prefix region the prefix tenant's 16
    rows), one row per kind, prompts of 64-512 tokens bound by one batched
    prefill, 32 greedy tokens each through PEFTEngine.  Gates: the prefix
    row's window starts at prefix_reserve - 16 and every other row's at
    prefix_reserve; launches per micro step as the path implies; then a
    teacher-forced rerun (serve_check's method, with the fold) on the plain
    versions, on a second plain path (``plain_split``) whose distance S from
    the first sets this path's gate before the kernel path runs
    (``_gate_from``), on the kernels, and on f32 weights.  Returns the
    launch counts and the gate."""
    import numpy as np

    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as lsteps

    t_phase = time.perf_counter()
    cfg, tasks, plan = methods_plan()
    cfg = cfg.with_overrides(num_layers=COSERVE_LAYERS)
    L = cfg.num_layers
    gen = ModelGenerator(cfg, seed=0)
    backbone = gen.init_backbone()
    reg = gen.register_tasks(tasks)
    _fill_zero_leaves(torch, reg.adapter_params, gen.generator)
    engine = PEFTEngine(gen, plan)
    model, mta, adapters = engine.model, reg.mta, reg.adapter_params
    rows, max_len, new = SERVE_METHODS_ROWS, SERVE_METHODS_MAX_LEN, SERVE_METHODS_NEW
    engine.ensure_decode_pool(rows, max_len, new)
    pres = engine.decode_prefix_reserve()
    rs = np.random.RandomState(1)
    Lp = 512
    lengths = rs.randint(64, Lp + 1, rows).astype(np.int32)
    lengths[0], lengths[1] = Lp, 64
    tokens = np.zeros((rows, Lp), np.int32)
    for i in range(rows):
        tokens[i, :lengths[i]] = rs.randint(1, cfg.vocab_size, lengths[i])
    max_new = np.full((rows,), new, np.int32)
    row_task = list(range(rows))        # row i serves task i: one row per kind
    prefix_row = [i for i, t in enumerate(tasks) if t.adapter.kind == "prefix"]
    P = tasks[prefix_row[0]].adapter.rank
    slots, scales = engine.decode_row_ctx(row_task)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        engine.dispatch_decode_bind_batched(np.arange(rows), tokens, lengths, slots, scales,
                                            max_new)
        acct = engine.decode_accounting()
        bind_s = time.perf_counter() - t0
        step_s = []
        while acct["active"].any():
            t1 = time.perf_counter()
            engine.dispatch_decode_micro(slots, scales)
            acct = engine.decode_accounting()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    n_micro = len(step_s)
    if list(acct["n_out"]) != list(max_new) or n_micro != new - 1:
        raise AssertionError(f"serve_methods: requests did not complete: n_out "
                             f"{acct['n_out']}, {n_micro} micro steps")
    lo = engine._decode_pool["state"]["lo"].cpu().tolist()
    want_lo = [pres - P if i in prefix_row else pres for i in range(rows)]
    if lo != want_lo:
        raise AssertionError(f"serve_methods: windows start at {lo}, want {want_lo}")
    per_step = step_launches(cfg, adapters)["grouped_lora"]
    want = dict.fromkeys(counts, 0)
    want.update({"grouped_lora": per_step * (1 + n_micro), "packed_attention": L,
                 "decode_attention": L * n_micro})
    if counts != want:
        raise AssertionError(f"serve_methods: kernel launches {counts}, the path implies {want}")
    served = [engine.decode_outputs(i)[:new] for i in range(rows)]
    emit({"phase": "serve_methods", "card": card(), "model": cfg.name, "layers": L,
          "tenants": [f"{t.adapter.kind}:{t.adapter.rank}" for t in tasks],
          "prefix_reserve": pres, "windows_start": lo, "requests": rows,
          "prompt_lengths": lengths.tolist(), "bucket": Lp, "max_new": new,
          "micro_steps": n_micro, "launches": counts,
          "launches_per_micro_step": {"grouped_lora": per_step, "decode_attention": L},
          "bind_s": bind_s, "micro_step_ms_median": statistics.median(step_s) * 1e3,
          "decode_tokens_per_s": rows * n_micro / sum(step_s),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    with torch.no_grad():
        prof = profile_device(torch, lambda: engine.dispatch_decode_micro(slots, scales), 3,
                              {"grouped_lora": ("grouped_lora",),
                               "decode_attention": ("decode_attention_kernel",)})
    emit({"phase": "profile", "path": "serve_methods micro step", "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})

    # ---- teacher-forced rerun with the fold: each mode's logits per step ----
    dev = torch.device("cuda")
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    out_t = torch.as_tensor(np.stack(served), device=dev)
    ctxf = mta.ctx_factory_from_slots(slots, scales)
    ar = torch.arange(rows, device=dev)

    def trajectory(bb, ad, dt):
        st = model.init_decode_state(rows, max_len, cache_dtype=dt, prefix_reserve=pres)
        lg, st = model.prefill(bb, {"tokens": tok_t}, st, adapters=ad, ctx_factory=ctxf,
                               prefix_reserve=pres, lengths=len_t)
        lsteps.fold_soft_prompts(model, mta, ad, slots, st, pres)
        out = [lg[ar, (len_t - 1).long()].float()]
        for i in range(n_micro):
            lg, st = model.decode_step(bb, st, out_t[:, i:i + 1], adapters=ad, ctx_factory=ctxf,
                                       prefix_reserve=pres)
            out.append(lg[:, 0].float())
        return out

    with torch.no_grad():
        with ops.force_plain():
            plain = trajectory(backbone, adapters, torch.bfloat16)
        with plain_split():
            split = trajectory(backbone, adapters, torch.bfloat16)
        spread = max(_rel_by_step(split, plain))
        tol = _gate_from(spread)
        emit({"phase": "serve_methods_gate", "card": card(),
              "plain_split_vs_plain_max_rel": spread, "two_s": 2 * spread,
              "logit_tol": LOGIT_TOL, "gate": tol})
        kernel = trajectory(backbone, adapters, torch.bfloat16)
        tf = torch.stack([x.argmax(-1) for x in kernel], 1).to(torch.int32)
        if not torch.equal(tf, out_t):
            raise AssertionError("serve_methods: teacher-forced kernel tokens differ from the "
                                 "served tokens")
        with ops.force_plain():
            f32 = trajectory(densify(torch, backbone), tree_map(
                lambda t: t.float() if t.is_floating_point() else t, adapters), torch.float32)
    rel = {"kernel_vs_plain": _rel_by_step(kernel, plain),
           "kernel_vs_f32": _rel_by_step(kernel, f32), "plain_vs_f32": _rel_by_step(plain, f32),
           "plain_split_vs_plain": _rel_by_step(split, plain)}
    top = {k: max(v) for k, v in rel.items()}
    agree = min((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(kernel, plain))
    emit({"phase": "serve_methods_check", "card": card(), "steps": n_micro + 1,
          "logit_max_rel_err": top["kernel_vs_plain"], "tol_rel": tol,
          "kernel_vs_f32_max_rel": top["kernel_vs_f32"],
          "plain_vs_f32_max_rel": top["plain_vs_f32"],
          "plain_split_vs_plain_max_rel": top["plain_split_vs_plain"],
          "argmax_agreement_min": agree, "phase_seconds": time.perf_counter() - t_phase,
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in rel.items()}})
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_methods_check: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if not top["kernel_vs_f32"] <= 2 * top["plain_vs_f32"]:
        raise AssertionError(f"serve_methods_check: the kernel path is further from the f32 "
                             f"run ({top['kernel_vs_f32']}) than twice the plain path "
                             f"({top['plain_vs_f32']})")
    return counts, tol


class _DecodeLog:
    """Records every decode-pool operation of a service run: the pool's
    allocation, each batched bind with the request ids it binds, each micro
    step with the tokens it was fed, the adapter tree each read and the
    logits each sampled from (a device copy, no host read).  The plain path
    then replays the same decode from the same states, teacher-forced, and
    is held to the kernel run's logits at every step.  Adapter updates make
    new tensors, so a kept reference is the state the kernel run read.
    Each operation also records the generator of the engine that ran it
    (``"gen"``: one per service, so several services' decodes replay apart)
    and the kernel launches it made (``"launches"``)."""

    def __init__(self):
        self.ops, self.pending_ids = [], None

    def install(self, engine_cls, sched_cls):
        import numpy as np

        from repro_torch.kernels import ops
        from repro_torch.launch import steps as lsteps

        log = self
        names = ("ensure_decode_pool", "dispatch_decode_bind_batched", "dispatch_decode_micro")
        self.saved = {(engine_cls, n): getattr(engine_cls, n) for n in names}
        self.saved[(sched_cls, "_dispatch_bind_group")] = sched_cls._dispatch_bind_group
        self.saved[(lsteps, "sample_tokens")] = lsteps.sample_tokens
        ensure, bind, micro = (self.saved[(engine_cls, n)] for n in names)
        group = self.saved[(sched_cls, "_dispatch_bind_group")]
        sample = self.saved[(lsteps, "sample_tokens")]

        def ensure_decode_pool(eng, rows, max_len, cap):
            key = (id(eng), eng.decode_pool_gen)
            pool = ensure(eng, rows, max_len, cap)
            if (id(eng), eng.decode_pool_gen) != key:
                log.ops.append({"op": "alloc", "geom": eng._decode_geom, "gen": id(eng.gen)})
            return pool

        def counted(op, fn, *a):
            before = ops.launch_counts()
            log.ops.append(op)
            out = fn(*a)
            op["launches"] = {k: n - before[k] for k, n in ops.launch_counts().items()}
            return out

        def dispatch_bind(eng, rows, tokens, lengths, row_slots, scales, max_new, sampling=None):
            op = {"op": "bind", "ids": log.pending_ids, "rows": np.asarray(rows),
                  "tokens": np.asarray(tokens), "lengths": np.asarray(lengths),
                  "slots": row_slots, "scales": scales, "max_new": np.asarray(max_new),
                  "adapters": eng.reg.adapter_params, "mta": eng.reg.mta,
                  "geom": eng._decode_geom, "gen": id(eng.gen)}
            return counted(op, bind, eng, rows, tokens, lengths, row_slots, scales, max_new,
                           sampling)

        def dispatch_micro(eng, row_slots, scales):
            op = {"op": "micro", "slots": row_slots, "scales": scales,
                  "adapters": eng.reg.adapter_params, "mta": eng.reg.mta,
                  "geom": eng._decode_geom, "cur": eng._decode_pool["cur"].clone(),
                  "gen": id(eng.gen)}
            return counted(op, micro, eng, row_slots, scales)

        def dispatch_group(sched, engine, bucket, items):
            log.pending_ids = [req.request_id for _, req in items]
            return group(sched, engine, bucket, items)

        def sample_tokens(logits, *a, **k):
            log.ops[-1]["logits"] = logits.detach().clone()
            return sample(logits, *a, **k)

        engine_cls.ensure_decode_pool = ensure_decode_pool
        engine_cls.dispatch_decode_bind_batched = dispatch_bind
        engine_cls.dispatch_decode_micro = dispatch_micro
        sched_cls._dispatch_bind_group = dispatch_group
        lsteps.sample_tokens = sample_tokens

    def uninstall(self):
        for (owner, name), fn in self.saved.items():
            setattr(owner, name, fn)

    def replay_plain(self, torch, model, backbone, gen=None):
        """The recorded decode on the plain versions, teacher-forced: each
        micro step is fed the tokens that the kernel run fed it (only the
        operations of generator ``gen``, the service's, if given).  Returns
        (per request, its steps as (kernel token, plain token, the plain
        top-two margin relative to the row's largest |logit|); for each
        bind and micro step, the kernel logits' largest distance from the
        plain ones over its live rows, relative to their largest plain
        |logit|, as serve_check measures it)."""
        from repro_torch.kernels import ops
        from repro_torch.launch import steps as lsteps

        seen = []
        real_sample = lsteps.sample_tokens

        def sample(logits, *a, **k):
            seen.append(logits.float())
            return real_sample(logits, *a, **k)

        per_req, rel, row_req, pool = {}, [], {}, None

        def hold(op, live, ids):
            if "logits" not in op:
                raise AssertionError(f"coserve: no kernel logits recorded for a {op['op']}")
            k, p = op["logits"].float()[live], seen[0][live]
            rel.append(((k - p).abs().max() / p.abs().max()).item())
            top = p.topk(2, dim=-1).values
            margin = ((top[:, 0] - top[:, 1]) / p.abs().amax(-1)).tolist()
            for rid, kt, pt, m in zip(ids, k.argmax(-1).tolist(), p.argmax(-1).tolist(), margin):
                per_req[rid].append((kt, pt, m))

        lsteps.sample_tokens = sample
        try:
            with torch.no_grad(), ops.force_plain():
                for op in self.ops:
                    if gen is not None and op["gen"] != id(gen):
                        continue
                    _, max_len, cap, pres = op["geom"]
                    if op["op"] == "alloc":
                        pool = lsteps.init_decode_pool(model, op["geom"][0], max_len, cap,
                                                       prefix_reserve=pres)
                        row_req = {}
                        continue
                    dev = pool["cur"].device
                    seen.clear()
                    if op["op"] == "bind":
                        fn = lsteps.build_decode_batched_bind_step(model, op["mta"], max_len,
                                                                   pres)
                        rows = op["rows"]
                        pool = fn(backbone, op["adapters"], pool, torch.as_tensor(rows, device=dev),
                                  torch.as_tensor(op["tokens"], device=dev),
                                  torch.as_tensor(op["lengths"], device=dev), op["slots"],
                                  op["scales"], torch.as_tensor(op["max_new"], device=dev),
                                  lsteps.greedy_sampling(len(rows), dev), [])
                        for r, rid in zip(rows.tolist(), op["ids"]):
                            row_req[r] = rid
                            per_req[rid] = []
                        hold(op, torch.arange(len(rows), device=dev), op["ids"])
                        continue
                    active = pool["active"].tolist()
                    live = [r for r, on in enumerate(active) if on and r in row_req]
                    pool["cur"].copy_(op["cur"])          # the tokens the kernel run fed
                    pool = lsteps.build_decode_micro_step(model, op["mta"], pres)(
                        backbone, op["adapters"], pool, op["slots"], op["scales"], [])
                    if live:
                        hold(op, torch.as_tensor(live, device=dev), [row_req[r] for r in live])
        finally:
            lsteps.sample_tokens = real_sample
        return per_req, rel


class _SyncCounter:
    """Counts host reads of CUDA tensors (``.item()``, ``.cpu()``,
    ``.tolist()``) and ``torch.cuda.synchronize`` calls while installed."""

    def __init__(self, torch):
        self.torch, self.n = torch, 0
        self.real = {name: getattr(torch.Tensor, name) for name in ("item", "cpu", "tolist")}
        self.real_sync = torch.cuda.synchronize

    def __enter__(self):
        torch = self.torch

        def wrap(name):
            real = self.real[name]

            def f(t, *a, **k):
                if t.is_cuda:
                    self.n += 1
                return real(t, *a, **k)
            return f

        for name in self.real:
            setattr(torch.Tensor, name, wrap(name))

        def sync(*a, **k):
            self.n += 1
            return self.real_sync(*a, **k)
        torch.cuda.synchronize = sync
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.torch.Tensor, name, fn)
        self.torch.cuda.synchronize = self.real_sync
        return False


def _raw_device_ms(torch, prof) -> float:
    """Device ms of a profiled window, summed from the raw trace's device
    events (building the per-op event tree of a decode iteration, a few
    hundred thousand kernels, costs tens of seconds)."""
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6


def coserve_phase(torch, tol):
    """The coserve path: MuxTuneService on llama3.2-3b at full width and
    ``COSERVE_LAYERS`` layers (bf16, random weights from a seed),
    CoServeConfig(decode_slots=8,
    decode_max_len=1024), reserve_slots=2, checkpoints and cadence
    checkpoints (every 2 steps) into a temporary directory, and the churn of
    the JAX service test: A (LoRA) and B (Prefix-Tuning) at clock 0; C
    (DoRA) and D (VeRA, which waits in the queue under the Eq. 5 budget of
    {A, B, C}) at clock 2; C cancelled at clock 3; B completes at clock 4
    (checkpointed out, the stacks compacted) and D is admitted; B resubmitted
    warm-started from its artifact, admitted when D and A complete.  Eight
    greedy requests of 64-512 prompt tokens and 32 new tokens go to A, B, C,
    D and the warm-started B before and during the churn.

    The churn runs twice.  The first pass runs bare: its iteration walls,
    decode p50 / p99 and memory peaks are the ones reported.  The second is
    instrumented: the profiler (device ms an iteration), the host-sync
    counter, timers around attach, detach, compact and checkpoint-out (each
    ends in a sync), and the decode log; every gate reads it.  Gates: A's
    per-iteration losses within LOSS_TOL of a solo service run of A; B's
    artifact equals the slice it was cut from bit for bit, read back with
    load_task_tree, and the warm-started B starts from it; every request
    done with its 32 tokens in both passes; the plain path's teacher-forced
    replay of the instrumented pass's decode within ``tol`` (serve_methods'
    gate) of the kernel logits at every bind and micro step, and its greedy
    token apart from the served one only where its top two logits are
    within ``tol``; p50 <= p99, both > 0; replans >= 4; step-cache hits > 0.
    Prints per iteration: wall s and the memory peak (bare pass); device
    ms, decode tokens and micro steps, host syncs, seconds in attach,
    detach, compact and checkpoint-out (instrumented pass)."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import PEFTEngine
    from repro_torch.core.registry import load_task_tree, slice_task_tree
    from repro_torch.core.task import ParallelismSpec
    from repro_torch.data.synthetic import make_task
    from repro_torch.distributed.checkpoint import CheckpointStore
    from repro_torch.kernels import ops
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.peft.multitask import MultiTaskAdapters
    from repro_torch.serve import (AdmissionConfig, AdmissionController, CoServeConfig,
                                   DecodeScheduler, MuxTuneService, RequestSpec, TenantSpec)

    t_phase = time.perf_counter()
    cfg = get_config("llama3.2-3b").with_overrides(num_layers=COSERVE_LAYERS)
    T = {tid: make_task(tid, ds, mb, AdapterConfig(kind, rank=rank), seed=i)
         for i, (tid, ds, kind, rank, mb) in enumerate(COSERVE_TENANTS)}
    probe = AdmissionController(cfg, ParallelismSpec())
    budget = probe.resident_memory([T["a"], T["b"], T["c"]])
    if not (probe.resident_memory([T["a"], T["b"], T["d"]]) > budget
            >= probe.resident_memory([T["a"], T["d"]])):
        raise AssertionError("coserve: the Eq. 5 budget does not queue D behind B")
    real_sync = torch.cuda.synchronize

    def service(tmp, **kw):
        return MuxTuneService(
            cfg, ParallelismSpec(), lr=TRAIN_LR, n_micro=1, enable_fusion=False,
            reserve_slots=2, seed=0, ckpt_dir=os.path.join(tmp, "ckpt"),
            fault_dir=os.path.join(tmp, "fault"), ckpt_cadence=2,
            admission=AdmissionConfig(memory_budget=budget, max_queue=4), **kw)

    def churn(tmp, step, prepare=None):
        """The churn scenario on a fresh service (``prepare(svc)`` first);
        ``step(svc)`` runs one iteration and returns (metrics, the iteration
        line's fields)."""
        svc = service(tmp, coserve=CoServeConfig(decode_slots=8, decode_max_len=1024,
                                                 max_new_cap=COSERVE_NEW, slo_seconds=2.0,
                                                 max_tokens_per_iter=COSERVE_NEW))
        if prepare is not None:
            prepare(svc)
        rs = np.random.RandomState(4)
        reqs, losses, states = [], [], {}

        def submit(tenants, requests, warm=False):
            for t in tenants:
                svc.submit(TenantSpec(T[t], target_steps=COSERVE_WARM_STEPS if warm
                                      else COSERVE_TARGETS[t],
                                      warm_start_dir=os.path.join(tmp, "ckpt", t) if warm
                                      else None))
            for t in requests:
                prompt = rs.randint(1, cfg.vocab_size, int(rs.randint(64, 513)))
                reqs.append(svc.submit_request(t, RequestSpec(prompt,
                                                              max_new_tokens=COSERVE_NEW)))

        events = {0: lambda: submit("ab", "aab"), 2: lambda: submit("cd", "cd"),
                  3: lambda: svc.cancel("c"), 4: lambda: submit("b", "bad", warm=True)}
        for it in range(COSERVE_MAX_ITERS):
            if it in events:
                events[it]()
                states[it] = {t: r.state for t, r in svc.tenants.items()}
            if not svc.resident and not len(svc.queue):
                break
            ids = [t.task_id for t in svc.plan.tasks] if svc.plan else []
            torch.cuda.reset_peak_memory_stats()
            m, fields = step(svc)
            if m is not None:
                losses.append({t: float(m.per_task_loss[i]) for i, t in enumerate(ids)})
            emit({"phase": "coserve_iteration", "card": card(), "iteration": it,
                  "clock": svc.clock, "resident": ids,
                  "queued": [r.task_id for r in svc.queue.items()],
                  "per_task_loss": losses[-1] if m is not None else None,
                  "decode_tokens": m.decode_tokens if m else 0,
                  "decode_micro_steps": m.decode_micro_steps if m else 0,
                  "decode_mid_iteration_micro_steps": svc.coserve.last_mid_micros,
                  "decode_seconds": m.decode_seconds if m else 0.0, **fields,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        for r in reqs:
            if r.state != "done" or len(r.tokens_out) != COSERVE_NEW:
                got = 0 if r.tokens_out is None else len(r.tokens_out)
                raise AssertionError(f"coserve: request {r.request_id} ended {r.state} "
                                     f"({r.reason}) with {got} tokens")
        co = svc.accounting()["coserve"]
        if not 0 < co["decode_p50_s"] <= co["decode_p99_s"]:
            raise AssertionError(f"coserve: decode p50 {co['decode_p50_s']} "
                                 f"p99 {co['decode_p99_s']}")
        return svc, reqs, losses, states

    # ---- the bare pass: the latency and memory that are reported ----
    bare_lines = []

    def bare_step(svc):
        t0 = time.perf_counter()
        m = svc.step()
        wall = time.perf_counter() - t0
        real_sync()
        bare_lines.append({"wall_s": wall, "max_memory_allocated":
                           torch.cuda.max_memory_allocated()})
        return m, {"pass": "bare", "wall_s": wall}

    t_bare = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        svc, _, _, _ = churn(tmp, bare_step)
        bare = svc.accounting()
        del svc
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the instrumented pass: device time, syncs, lifecycle, the gates ----
    t_inst = time.perf_counter()
    spent = {"attach_s": 0.0, "detach_s": 0.0, "compact_s": 0.0, "checkpoint_out_s": 0.0}
    captured, inst_lines = {}, []

    def timed(key, fn):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            real_sync()
            spent[key] += time.perf_counter() - t0
            return out
        return f

    def instrument(svc):
        svc._attach = timed("attach_s", svc._attach)
        svc._detach = timed("detach_s", svc._detach)
        svc.gen.compact = timed("compact_s", svc.gen.compact)
        ckpt_out, warm = svc.checkpoint_out_tenant, svc._warm_start

        def checkpoint_out(task_id, ckpt_dir, include_optimizer=True):
            reg = svc.gen.registered
            captured.setdefault(task_id, tree_map(
                lambda t: t.detach().clone(),
                slice_task_tree(cfg, reg.mta, reg.adapter_params, reg.task_index(task_id))))
            return ckpt_out(task_id, ckpt_dir, include_optimizer)

        def warm_start(rec):
            warm(rec)
            reg = svc.gen.registered
            captured["warm_" + rec.task_id] = slice_task_tree(
                cfg, reg.mta, reg.adapter_params, reg.task_index(rec.task_id))
        svc.checkpoint_out_tenant = timed("checkpoint_out_s", checkpoint_out)
        svc._warm_start = warm_start

    def inst_step(svc):
        with profile(activities=[ProfilerActivity.CUDA]) as prof, _SyncCounter(torch) as syncs:
            t0 = time.perf_counter()
            m = svc.step()
            wall = time.perf_counter() - t0
            real_sync()
        fields = {"pass": "instrumented", "wall_s_profiled": wall,
                  "device_ms": _raw_device_ms(torch, prof),
                  "host_syncs": syncs.n, **spent}
        inst_lines.append(fields)
        spent.update(dict.fromkeys(spent, 0.0))
        return m, fields

    log = _DecodeLog()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        log.install(PEFTEngine, DecodeScheduler)
        try:
            svc, reqs, losses, states = churn(tmp, inst_step, instrument)
        finally:
            log.uninstall()
        counts = ops.launch_counts()
        acct = svc.accounting()
        torch.cuda.synchronize()

        # ---- B's artifact, read back; the warm-started B starts from it ----
        if "b" not in captured or "warm_b" not in captured:
            raise AssertionError(f"coserve: B was not checkpointed out and warm-started "
                                 f"({sorted(captured)})")
        store = CheckpointStore(os.path.join(tmp, "ckpt", "b"))
        _, art, _ = store.restore(captured["b"])
        kind_cfg = [AdapterConfig("prefix", rank=COSERVE_TENANTS[1][3])]
        fresh_mta = MultiTaskAdapters(cfg, kind_cfg)
        fresh = fresh_mta.init(torch.Generator(device="cuda").manual_seed(1))
        loaded = slice_task_tree(cfg, fresh_mta,
                                 load_task_tree(cfg, fresh_mta, fresh, 0, art, strict=True), 0)
        want = captured["b"]
        for what, tree in (("artifact", art), ("load_task_tree", loaded),
                           ("warm start", captured["warm_b"])):
            if sorted(_leaf_paths(tree)) != sorted(_leaf_paths(want)):
                raise AssertionError(f"coserve: B's {what} has leaves {_leaf_paths(tree)}, "
                                     f"the slice {_leaf_paths(want)}")
            for path in _leaf_paths(want):
                a, b = _leaf(tree, path), _leaf(want, path)
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"coserve: B's {what} leaf {path} is not the slice "
                                         f"it was cut from")

    # ---- every request's logits and tokens against the plain replay ----
    t_replay = time.perf_counter()
    per_req, rel = log.replay_plain(torch, svc.gen.model, svc.gen.backbone_params)
    del log
    req_lines = []
    for r in reqs:
        steps_ = per_req[r.request_id]
        if [kt for kt, _, _ in steps_] != [int(t) for t in r.tokens_out]:
            raise AssertionError(f"coserve: request {r.request_id}: the recorded kernel logits "
                                 f"do not give its served tokens")
        apart = [i for i, (kt, pt, _) in enumerate(steps_) if kt != pt]
        wide = [(i, steps_[i][2]) for i in apart if steps_[i][2] > tol]
        if wide:
            raise AssertionError(f"coserve: request {r.request_id}: the plain path picks another "
                                 f"token at steps {wide} (step, plain top-two margin) > {tol}")
        req_lines.append({"request": r.request_id, "task": r.task_id,
                          "prompt_tokens": len(r.prompt), "queue_wait": r.queue_wait,
                          "makespan_iters": r.finish_clock - r.submit_clock,
                          "steps_apart_from_plain": apart,
                          "plain_margin_max_there": max((steps_[i][2] for i in apart),
                                                        default=None)})
    emit({"phase": "coserve_check", "card": card(), "decode_steps_held": len(rel),
          "logit_max_rel_err": max(rel), "tol_rel": tol,
          "rel_err_by_step": [round(x, 5) for x in rel]})
    if not max(rel) <= tol:
        raise AssertionError(f"coserve_check: logits kernel vs plain off by {max(rel)} of the "
                             f"largest logit > {tol}")

    # ---- the solo A run: A's losses across the churn ----
    t_solo = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        solo = service(tmp)
        solo.submit(TenantSpec(T["a"], target_steps=COSERVE_TARGETS["a"]))
        solo_losses = [solo.step().per_task_loss[0] for _ in range(COSERVE_TARGETS["a"])]
        del solo
    churn_a = [x["a"] for x in losses if "a" in x]
    rel_a = [abs(c - s) / abs(s) for c, s in zip(churn_a, solo_losses)]
    if len(churn_a) != COSERVE_TARGETS["a"] or max(rel_a) > LOSS_TOL:
        raise AssertionError(f"coserve: A's losses {churn_a} vs solo {solo_losses} "
                             f"(rel {rel_a}) > {LOSS_TOL}")
    seconds = {"bare_pass": t_inst - t_bare, "instrumented_pass": t_replay - t_inst,
               "plain_replay": t_solo - t_replay, "solo_a": time.perf_counter() - t_solo}

    if not all(counts[k] > 0 for k in TRAIN_KERNELS + ("decode_attention",)):
        raise AssertionError(f"coserve: a kernel of the path never launched: {counts}")
    if acct["replans"] < 4 or acct["cache_hits"] <= 0:
        raise AssertionError(f"coserve: replans {acct['replans']}, cache hits {acct['cache_hits']}")
    want_states = {2: {"d": "queued"}, 3: {"d": "queued", "c": "cancelled"},
                   4: {"b": "queued", "d": "running"}}
    for it, want in want_states.items():
        if any(states[it][t] != s for t, s in want.items()):
            raise AssertionError(f"coserve: after the events of iteration {it} the tenants are "
                                 f"{states[it]}, want {want}")
    for t in "abd":
        if svc.record(t).state != "completed":
            raise AssertionError(f"coserve: tenant {t} ended {svc.record(t).state}")
    co, co_inst = bare["coserve"], acct["coserve"]
    emit({"phase": "coserve", "card": card(), "model": cfg.name, "layers": cfg.num_layers,
          "tenants": [f"{t}:{k}:{r} (micro-batch {mb})" for t, _, k, r, mb in COSERVE_TENANTS],
          "memory_budget": budget, "iterations": len(inst_lines), "launches": counts,
          "replans": acct["replans"], "cache_hits": acct["cache_hits"],
          "cache_misses": acct["cache_misses"], "decode_tokens": co["decode_tokens"],
          "decode_p50_s": co["decode_p50_s"], "decode_p99_s": co["decode_p99_s"],
          "decode_p50_s_instrumented": co_inst["decode_p50_s"],
          "decode_p99_s_instrumented": co_inst["decode_p99_s"],
          "mid_iteration_binds": co_inst["mid_iteration_binds"],
          "a_loss_rel_to_solo_max": max(rel_a), "logit_max_rel_err": max(rel),
          "requests": req_lines,
          "wall_s_per_iteration": [x["wall_s"] for x in bare_lines],
          "host_syncs_per_iteration": [x["host_syncs"] for x in inst_lines],
          "device_ms_per_iteration": [x["device_ms"] for x in inst_lines],
          "max_memory_allocated": max(x["max_memory_allocated"] for x in bare_lines),
          "b_artifact_bits_equal": True,
          "seconds": dict(seconds, phase=time.perf_counter() - t_phase),
          "tenants_end": {t: r.accounting() for t, r in svc.tenants.items()}})
    return counts


# the fleet path: tenants (id, dataset, kind, rank, micro-batch), targets,
# and the fleet clock of each event
FLEET_TENANTS = (("f0", "sst2", "lora", 8, 4), ("f1", "qa", "adapter", 8, 4),
                 ("f2", "rte", "lora", 8, 4))
FLEET_TARGETS = {"f0": 11, "f1": 10, "f2": 10}
FLEET_NEW, FLEET_TOKENS_PER_ITER, FLEET_MAX_ITERS = 32, 8, 24
# clock -> tenants that get a greedy request (r0-r7, 64-512 prompt tokens)
FLEET_REQUESTS = {0: ("f0", "f1"), 1: ("f2",), 2: ("f0",), 4: ("f1", "f2"), 6: ("f1", "f0")}
FLEET_MIGRATE_AT, FLEET_KILL_AT = 3, 5
FLEET_CKPT_CADENCE = 2


def _fleet_factory(torch, cfg_of, fault_dir, coserve, admission, built):
    """The one factory of every fleet service: llama3.2-3b at full width and
    depth, seed 0 (the same backbone on every instance, which migration
    parity needs), fusion off (a migrated tenant's trajectory is its solo
    one), cadence checkpoints every 2 steps; the backbone is built inside
    the factory, so a spawn's seconds include it.  ``cfg_of(iid)`` is the
    instance's config; ``built`` collects (iid, seconds, service)."""
    from repro_torch.core.task import ParallelismSpec
    from repro_torch.serve import MuxTuneService

    def factory(iid):
        t0 = time.perf_counter()
        svc = MuxTuneService(cfg_of(iid), ParallelismSpec(), lr=TRAIN_LR, n_micro=1,
                             enable_fusion=False, reserve_slots=4, seed=0, fault_dir=fault_dir,
                             ckpt_cadence=FLEET_CKPT_CADENCE if fault_dir else 0,
                             coserve=coserve, admission=admission)
        svc.gen.init_backbone()
        torch.cuda.synchronize()
        built.append((iid, time.perf_counter() - t0, svc))
        return svc
    return factory


class _StepLaunches:
    """Wraps each service's ``step``: the kernel launches of the step, less
    those the decode log recorded for its binds and micro steps, are the
    training iteration's, held to ``step_launches`` of the instance's
    adapter tree times its micro steps; each decode operation is held to
    what it implies (a bind: the grouped-LoRA sites and one packed attention
    a layer; a micro step: the sites and one decode attention a layer); on
    an int8 backbone every BaseOp of every layer runs quant_matmul once a
    micro step (training forward, bind prefill, decode micro step).  Keeps
    each step's line fields, metrics and end time (a service step ends in
    the decode segment's host read)."""

    def __init__(self, log):
        self.log, self.lines, self.checked = log, [], {"train_iterations": 0, "decode_ops": 0}

    def wrap(self, torch, iid, svc):
        from repro_torch.kernels import ops
        from repro_torch.peft.methods.config import base_op_dims

        real, cfg = svc.step, svc.cfg
        L = cfg.num_layers
        qmm = len(base_op_dims(cfg)) * L if cfg.backbone_dtype == "int8" else 0
        log = self.log

        def want_for(adapters, micro, kind):
            per = step_launches(cfg, adapters)
            if kind == "train":
                want = {k: micro * per[k] for k in TRAIN_KERNELS}
            else:
                want = {"grouped_lora": per["grouped_lora"],
                        "packed_attention" if kind == "bind" else "decode_attention": L}
            if qmm:
                want["quant_matmul"] = qmm * micro
            return want

        def step():
            eng = svc.engine
            micro = len(eng._schedule(svc.n_micro)) if eng is not None and svc.resident else 0
            adapters = svc.gen.registered.adapter_params if micro else None
            n_ops = len(log.ops) if log is not None else 0
            before = ops.launch_counts()
            m = real()
            got = {k: n - before[k] for k, n in ops.launch_counts().items()}
            for op in (log.ops[n_ops:] if log is not None else ()):
                if op["op"] == "alloc":
                    continue
                want = dict.fromkeys(got, 0)
                want.update(want_for(op["adapters"], 1, op["op"]))
                if op["launches"] != want:
                    raise AssertionError(f"fleet: instance {iid} {op['op']} launched "
                                         f"{op['launches']}, it implies {want}")
                got = {k: n - op["launches"][k] for k, n in got.items()}
                self.checked["decode_ops"] += 1
            want = dict.fromkeys(got, 0)
            if micro:
                want.update(want_for(adapters, micro, "train"))
                self.checked["train_iterations"] += 1
            if got != want:
                raise AssertionError(f"fleet: instance {iid} training iteration launched {got}, "
                                     f"its plan implies {want}")
            self.lines.append({"instance": iid, "clock": svc.clock, "metrics": m,
                               "train_launches": got, "micro_steps": micro,
                               "t_end": time.perf_counter()})
            return m
        svc.step = step


def fleet_phase(torch, tol):
    """The fleet path: a FleetRouter (best_fit, ``AdmissionConfig(max_tenants=
    2)``) over MuxTuneService instances of llama3.2-3b at full width and
    depth (bf16, random weights from seed 0) in one process on the card,
    with the autoscaler (1 to 3 instances, cooldown 1) attached.  F0 (LoRA
    8) and F1 (Adapter 8) at clock 0 pack onto instance 0, F2 (LoRA 8) at
    clock 1 lands on instance 1; F0 is live-migrated to instance 1 after 3
    iterations with a request in flight; after 5 iterations the instance
    holding F1 is killed (its checkpoint writers waited on first): F1 finds
    no feasible survivor and waits in the recovery queue, the autoscaler
    spawns instance 2 under that queue pressure, and F1 resumes there from
    its step-4 cadence artifact with its in-flight request re-created from
    its spec; once every tenant completes, the idle fleet scales down.
    Eight greedy requests (r0-r7, 64-512 prompt tokens, 32 new tokens)
    go to the tenants before and during the churn.

    The utilization band is set so that utilization alone never scales (the
    host-bound decode moves the calibrated iteration walls between runs):
    up on queue pressure, down once every instance is idle.

    Gates: every routing decision equals the lockstep ClusterSim's pick
    (agreement 1.0); the migration moves an in-flight request; F0's
    per-iteration losses within LOSS_TOL of a solo service run of F0;
    F1 resumes at step 4, its dead record LOST / instance_failure, no cold
    restart, and its post-recovery losses within LOSS_TOL of a solo service
    warm-started from the same step-4 artifact; every tenant COMPLETED with
    its target steps; every request done with its 32 tokens; one scale-up
    and one scale-down; the kernel launches of every training iteration and
    decode operation as its plan implies (``_StepLaunches``), none outside
    them; the plain path's teacher-forced replay of each instance's decode
    (the dead one's too) within ``tol`` of the kernel logits at every bind
    and micro step, another greedy token only where the plain top two are
    within ``tol``; the fleet.* span trace valid with every phase.  Prints a
    line per fleet step (wall s, device ms from the profiler over the step,
    live instances, residents, decode tokens, utilization, memory peak) and
    per event (spawn, migration phases, kill, recovery, the re-created
    request's first token, scale-up, scale-down).  Returns the launch
    counts."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import PEFTEngine
    from repro_torch.data.synthetic import make_task
    from repro_torch.fleet import Autoscaler, AutoscalerConfig, FleetRouter
    from repro_torch.kernels import ops
    from repro_torch.obs.tracing import SpanTracer, set_tracer, validate_chrome_trace
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.serve import (COMPLETED, LOST, AdmissionConfig, CoServeConfig,
                                   DecodeScheduler, RequestSpec, TenantSpec)

    t_phase = time.perf_counter()
    cfg = get_config("llama3.2-3b").with_overrides(num_layers=FLEET_LAYERS)
    T = {tid: make_task(tid, ds, mb, AdapterConfig(kind, rank=rank), seed=i)
         for i, (tid, ds, kind, rank, mb) in enumerate(FLEET_TENANTS)}
    # slo 30 s: every iteration decodes FLEET_TOKENS_PER_ITER micro steps at
    # its end, so a request bound in an iteration is still in flight after
    # it (at most 1 + 2 x 8 of 32 tokens) and done within four more
    coserve = CoServeConfig(decode_slots=8, decode_max_len=1024, max_new_cap=FLEET_NEW,
                            slo_seconds=30.0, max_tokens_per_iter=FLEET_TOKENS_PER_ITER)
    admission = AdmissionConfig(max_tenants=2)
    rs = np.random.RandomState(6)
    events, step_lines, built = [], [], []

    def event(name, **fields):
        line = {"phase": "fleet_event", "card": card(), "event": name, **fields}
        events.append(line)
        emit(line)

    tmp = tempfile.mkdtemp(prefix="fleet_")
    log = _DecodeLog()
    counter = _StepLaunches(log)
    fleet = None
    try:
        factory = _fleet_factory(torch, lambda iid: cfg, os.path.join(tmp, "fault"), coserve,
                                 admission, built)

        def counted_factory(iid):
            svc = factory(iid)
            counter.wrap(torch, iid, svc)
            event("spawn", instance=iid, seconds=built[-1][1],
                  backbone_bytes=svc.planner.cost_model([]).stage_memory([]))
            return svc

        tracer = SpanTracer()
        prev_tracer = set_tracer(tracer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        log.install(PEFTEngine, DecodeScheduler)
        reqs, kill_report, mig_report = {}, None, None
        times = {}
        try:
            fleet = FleetRouter(counted_factory, n_instances=2, policy="best_fit")
            fleet.autoscaler = Autoscaler(AutoscalerConfig(
                min_instances=1, max_instances=3, cooldown_ticks=1, scale_up_util=1.0,
                scale_down_util=1e-9))
            real_try = fleet._try_recover

            def try_recover(tid, ticket):
                t0 = time.perf_counter()
                iid = real_try(tid, ticket)
                if iid is not None:
                    torch.cuda.synchronize()
                    times["recovered"] = time.perf_counter()
                    event("recover", task=tid, instance=iid, from_step=ticket.steps_trained,
                          seconds=times["recovered"] - t0,
                          kill_to_recovered_s=times["recovered"] - times["kill"],
                          requeued=fleet.recoveries[-1].requeued_requests)
                return iid
            fleet._try_recover = try_recover

            def submit(tid):
                t0 = time.perf_counter()
                d = fleet.submit(TenantSpec(T[tid], target_steps=FLEET_TARGETS[tid]))
                torch.cuda.synchronize()
                event("route", seconds=time.perf_counter() - t0, **d.summary())
                if d.outcome != "admit" or d.instance != d.oracle:
                    raise AssertionError(f"fleet: {tid} routed {d.summary()}")

            def request(tid):
                rid = f"r{len(reqs)}"
                prompt = rs.randint(1, cfg.vocab_size, int(rs.randint(64, 513)))
                reqs[rid] = fleet.submit_request(tid, RequestSpec(
                    prompt, max_new_tokens=FLEET_NEW, request_id=rid))

            first_token = {}
            for it in range(FLEET_MAX_ITERS):
                clock = fleet.clock
                if clock == 0:
                    submit("f0")
                    submit("f1")
                if clock == 1:
                    submit("f2")
                if clock == FLEET_MIGRATE_AT:
                    inflight = [r for r, q in reqs.items() if q.task_id == "f0"
                                and q.state == "decoding"]
                    mig_report = fleet.migrate("f0")
                    event("migrate", **mig_report.summary(), request_ids=mig_report.request_ids,
                          in_flight_before=inflight)
                    if not inflight or not set(inflight) <= set(mig_report.request_ids):
                        raise AssertionError(f"fleet: the migration moved "
                                             f"{mig_report.request_ids}, in flight {inflight}")
                if clock == FLEET_KILL_AT:
                    victim = fleet.instances[fleet.placements["f1"]]
                    for st in victim.service._fault_stores.values():
                        st.wait()
                    # the artifact recovery reads, kept apart: the recovered
                    # F1 goes on committing cadence steps into the same place
                    src = os.path.join(tmp, "fault", "f1", "step_00000004")
                    shutil.copytree(src, os.path.join(tmp, "f1_step4", "step_00000004"))
                    inflight = [r for r, q in reqs.items() if q.task_id == "f1"
                                and q.state == "decoding"]
                    times["kill"] = time.perf_counter()
                    kill_report = fleet.kill(victim.iid)
                    event("kill", seconds=time.perf_counter() - times["kill"],
                          steps_trained=victim.service.tenants["f1"].steps_trained,
                          in_flight=inflight, **kill_report.summary())
                    if kill_report.queued != ["f1"] or kill_report.cold or not inflight:
                        raise AssertionError(f"fleet: the kill gave {kill_report.summary()}, "
                                             f"in flight {inflight}")
                for tid in FLEET_REQUESTS.get(clock, ()):
                    request(tid)
                if not fleet.has_work():
                    break
                ups = fleet.autoscaler.accounting()["scale_ups"]
                downs = fleet.autoscaler.accounting()["scale_downs"]
                n_lines = len(counter.lines)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fleet.step()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                acct = fleet.autoscaler.accounting()
                for ev in acct["events"][ups + downs:]:
                    event("scale_" + ev["direction"], instance=ev["instance"],
                          utilization=ev["utilization"], clock=ev["clock"])
                mine = counter.lines[n_lines:]
                for rid in (kill_report.requeued_requests if kill_report else ()):
                    live = fleet._find_request(rid)
                    if rid not in first_token and live is not None and live.state in (
                            "decoding", "done"):
                        # the end of the owner's step that bound it (the
                        # bind's prefill gives the first token)
                        owner = next(i for i, x in fleet.instances.items()
                                     if rid in x.service.coserve.requests)
                        first_token[rid] = next(x["t_end"] for x in reversed(mine)
                                                if x["instance"] == owner)
                        event("first_token_after_recovery", request=rid,
                              seconds=first_token[rid] - times["recovered"])
                line = {"phase": "fleet_step", "card": card(), "clock": fleet.clock,
                        "wall_s_profiled": wall, "device_ms": _raw_device_ms(torch, prof),
                        "instances": sorted(fleet.instances),
                        "residents": {str(i): x.service.resident_ids
                                      for i, x in fleet.instances.items()},
                        "queued": [p.task.task_id for p in fleet.queue],
                        "recovery_queued": list(fleet.recovery_queue),
                        "decode_tokens": sum(x["metrics"].decode_tokens for x in mine
                                             if x["metrics"] is not None),
                        "train_micro_steps": sum(x["micro_steps"] for x in mine),
                        "utilization": fleet.autoscaler.fleet_utilization(fleet),
                        "max_memory_allocated": torch.cuda.max_memory_allocated()}
                step_lines.append(line)
                emit(line)
            # idle ticks: the autoscaler retires instances of the idle fleet
            for _ in range(3):
                if fleet.autoscaler.accounting()["scale_downs"]:
                    break
                n_ev = len(fleet.autoscaler.events)
                fleet.step()
                for ev in fleet.autoscaler.events[n_ev:]:
                    event("scale_" + ev["direction"], instance=ev["instance"],
                          utilization=ev["utilization"], clock=ev["clock"])
        finally:
            log.uninstall()
            set_tracer(prev_tracer)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        # ---- the run's gates ----
        in_steps = {k: 0 for k in counts}
        for x in counter.lines:
            for k, n in x["train_launches"].items():
                in_steps[k] += n
        for op in log.ops:
            for k, n in op.get("launches", {}).items():
                in_steps[k] += n
        if in_steps != counts:
            raise AssertionError(f"fleet: launches outside the services' steps: {counts} "
                                 f"against {in_steps} in them")
        if not all(counts[k] > 0 for k in TRAIN_KERNELS + ("decode_attention",)):
            raise AssertionError(f"fleet: a kernel of the path never launched: {counts}")
        agreement = fleet.oracle_agreement()
        if agreement != 1.0:
            raise AssertionError(f"fleet: oracle agreement {agreement}: "
                                 f"{[d.summary() for d in fleet.decisions]}")
        scale = fleet.autoscaler.accounting()
        if scale["scale_ups"] < 1 or scale["scale_downs"] < 1:
            raise AssertionError(f"fleet: autoscaler events {scale['events']}")
        for tid, target in FLEET_TARGETS.items():
            rec = fleet.record(tid)
            if rec.state != COMPLETED or rec.steps_trained != target:
                raise AssertionError(f"fleet: {tid} ended {rec.state} after "
                                     f"{rec.steps_trained} steps, want {target}")
        dead = fleet.failed_instances[0].service.tenants["f1"]
        if (dead.state, dead.reason) != (LOST, "instance_failure"):
            raise AssertionError(f"fleet: the dead F1 record is {dead.state} / {dead.reason}")
        recovered = [d for d in fleet.decisions if d.outcome == "recover"]
        if [d.task_id for d in recovered] != ["f1"]:
            raise AssertionError(f"fleet: recoveries {[d.summary() for d in recovered]}")
        f1_losses = fleet.record("f1").losses
        if len(f1_losses) != 4 + FLEET_TARGETS["f1"] - 4:
            raise AssertionError(f"fleet: F1 did not resume at step 4: {len(f1_losses)} losses")
        survivors = list(fleet.instances.values()) + fleet.retired_instances
        # each request's last object: a request the dead instance finished
        # stays there, one it lost was re-created on a survivor
        final = {}
        for inst in fleet.failed_instances + survivors:
            for rid, q in inst.service.coserve.requests.items():
                final[rid] = (inst, q)
        for rid in reqs:
            q = final[rid][1] if rid in final else None
            if q is None or q.state != "done" or len(q.tokens_out) != FLEET_NEW \
                    or q.reason:
                raise AssertionError(f"fleet: request {rid} ended "
                                     f"{None if q is None else (q.state, q.reason)}")

        # ---- each instance's decode against the plain replay ----
        t_replay = time.perf_counter()
        held, rel_all, apart = 0, [], {}
        everyone = survivors + fleet.failed_instances
        for inst in everyone:
            gen = inst.service.gen
            per_req, rel = log.replay_plain(torch, gen.model, gen.backbone_params, gen=gen)
            held += len(rel)
            rel_all += rel
            for rid, steps_ in per_req.items():
                wide = [(i, m) for i, (kt, pt, m) in enumerate(steps_) if kt != pt and m > tol]
                if wide:
                    raise AssertionError(f"fleet: instance {inst.iid} request {rid}: the plain "
                                         f"path picks another token at {wide} > {tol}")
                apart.setdefault(rid, []).append(
                    (inst.iid, [i for i, (kt, pt, _) in enumerate(steps_) if kt != pt]))
                if final.get(rid, (None,))[0] is inst:
                    q = final[rid][1]
                    if [kt for kt, _, _ in steps_] != [int(t) for t in q.tokens_out]:
                        raise AssertionError(f"fleet: request {rid}: the recorded kernel "
                                             f"logits do not give its served tokens")
        if held == 0 or not max(rel_all) <= tol:
            raise AssertionError(f"fleet_check: logits kernel vs plain off by "
                                 f"{max(rel_all, default=None)} > {tol} ({held} steps)")
        emit({"phase": "fleet_check", "card": card(), "decode_steps_held": held,
              "logit_max_rel_err": max(rel_all), "tol_rel": tol,
              "steps_apart_from_plain": apart,
              "decode_ops_checked": counter.checked["decode_ops"],
              "train_iterations_checked": counter.checked["train_iterations"]})
        stats = validate_chrome_trace(tracer.chrome_trace(), require_phases=[
            "fleet.route", "fleet.migrate", "fleet.recover", "fleet.recover.warm_start",
            "fleet.scale_up", "fleet.scale_down", "fleet.step"])
        fleet_spans = {k: v for k, v in stats["phases"].items() if k.startswith("fleet.")}
        f0_losses = list(fleet.record("f0").losses)
        acct = fleet.accounting()
        tenants_end = {t: fleet.record(t).accounting() for t in FLEET_TARGETS}
        del log, fleet, tracer, prof, reqs, final, survivors, everyone, inst, dead
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the solo controls: F0 alone; F1 warm-started from step 4 ----
        t_solo = time.perf_counter()
        solo_built = []
        solo_factory = _fleet_factory(torch, lambda iid: cfg, None, coserve, admission,
                                      solo_built)
        solo = solo_factory(0)
        solo.submit(TenantSpec(T["f0"], target_steps=FLEET_TARGETS["f0"]))
        solo_f0 = [float(solo.step().per_task_loss[0]) for _ in range(FLEET_TARGETS["f0"])]
        del solo
        solo_built.clear()
        gc.collect()
        solo = solo_factory(1)
        solo.submit(TenantSpec(T["f1"], target_steps=FLEET_TARGETS["f1"] - 4,
                               warm_start_dir=os.path.join(tmp, "f1_step4")))
        solo_f1 = [float(solo.step().per_task_loss[0]) for _ in range(FLEET_TARGETS["f1"] - 4)]
        if solo.record("f1").reason.startswith("warm_start"):
            raise AssertionError(f"fleet: the solo warm start failed: {solo.record('f1').reason}")
        del solo
        solo_built.clear()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel_f0 = [abs(c - s) / abs(s) for c, s in zip(f0_losses, solo_f0)]
    rel_f1 = [abs(c - s) / abs(s) for c, s in zip(f1_losses[-len(solo_f1):], solo_f1)]
    if len(f0_losses) != len(solo_f0) or max(rel_f0) > LOSS_TOL:
        raise AssertionError(f"fleet: F0's losses {f0_losses} vs solo {solo_f0} (rel {rel_f0})")
    if max(rel_f1) > LOSS_TOL:
        raise AssertionError(f"fleet: F1's post-recovery losses {f1_losses} vs the solo warm "
                             f"start {solo_f1} (rel {rel_f1})")
    emit({"phase": "fleet", "card": card(), "model": cfg.name, "layers": cfg.num_layers,
          "tenants": [f"{t}:{k}:{r} (micro-batch {mb})" for t, _, k, r, mb in FLEET_TENANTS],
          "targets": FLEET_TARGETS, "launches": counts, "oracle_agreement": agreement,
          "decisions": acct["decisions"], "migrations": acct["migrations"],
          "recoveries": acct["recoveries"], "autoscaler": acct["autoscaler"],
          "fleet_spans": fleet_spans, "f0_loss_rel_to_solo_max": max(rel_f0),
          "f1_loss_rel_to_solo_warm_start_max": max(rel_f1), "logit_max_rel_err": max(rel_all),
          "fleet_steps": len(step_lines),
          "wall_s_profiled_per_step": [x["wall_s_profiled"] for x in step_lines],
          "device_ms_per_step": [x["device_ms"] for x in step_lines],
          "max_memory_allocated": peak, "tenants_end": tenants_end,
          "seconds": {"fleet_run": t_replay - t_phase, "plain_replay": t_solo - t_replay,
                      "solo_runs": time.perf_counter() - t_solo,
                      "phase": time.perf_counter() - t_phase}})
    return counts


def fleet_int8_phase(torch):
    """The heterogeneous fleet: one bf16 and one int8 instance of llama3.2-3b
    (full width and depth) under backbone_affine; two LoRA tenants
    submitted with each label land on their own label's instance (the
    oracle agrees) and train 2 steps each to COMPLETED, every training
    iteration's launches as its plan implies (quant_matmul at every BaseOp
    of every layer on the int8 instance); the int8 instance's Eq. 5
    backbone bytes below the bf16 one's.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_task
    from repro_torch.fleet import FleetRouter
    from repro_torch.kernels import ops
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.serve import COMPLETED, TenantSpec

    t_phase = time.perf_counter()
    llama = get_config("llama3.2-3b").with_overrides(num_layers=FLEET_LAYERS)
    cfgs = {0: llama, 1: llama.with_overrides(backbone_dtype="int8")}
    built = []
    counter = _StepLaunches(None)
    factory = _fleet_factory(torch, cfgs.__getitem__, None, None, None, built)

    def counted_factory(iid):
        svc = factory(iid)
        counter.wrap(torch, iid, svc)
        return svc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = FleetRouter(counted_factory, n_instances=2, policy="backbone_affine")
    labels = {iid: inst.backbone for iid, inst in fleet.instances.items()}
    bb = {iid: inst.backbone_bytes for iid, inst in fleet.instances.items()}
    if not (labels[0].endswith(":bfloat16") and labels[1].endswith(":int8") and bb[1] < bb[0]):
        raise AssertionError(f"fleet_int8: labels {labels}, backbone bytes {bb}")
    decisions = []
    for i in range(4):
        d = fleet.submit(TenantSpec(make_task(f"h{i}", ("sst2", "qa")[i % 2], 4,
                                              AdapterConfig("lora", rank=8), seed=i),
                                    target_steps=2, backbone=labels[i % 2]))
        decisions.append(d.summary())
        if d.outcome != "admit" or d.instance != i % 2 or d.oracle != d.instance:
            raise AssertionError(f"fleet_int8: h{i} routed {d.summary()}")
    steps = fleet.run(max_iters=8)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    for i in range(4):
        rec = fleet.record(f"h{i}")
        if rec.state != COMPLETED or rec.steps_trained != 2:
            raise AssertionError(f"fleet_int8: h{i} ended {rec.state} after {rec.steps_trained}")
    in_steps = {k: sum(x["train_launches"][k] for x in counter.lines) for k in counts}
    if in_steps != counts or counts["quant_matmul"] == 0 or fleet.oracle_agreement() != 1.0:
        raise AssertionError(f"fleet_int8: launches {counts}, in the steps {in_steps}, "
                             f"agreement {fleet.oracle_agreement()}")
    emit({"phase": "fleet_int8", "card": card(), "labels": labels,
          "backbone_bytes_eq5": bb, "decisions": decisions, "fleet_steps": steps,
          "launches": counts, "train_iterations_checked": counter.checked["train_iterations"],
          "spawn_seconds": [s for _, s, _ in built],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    del fleet
    built.clear()
    return counts


# ---------------------------------------------------------------------------
# the MoE paths: deepseek-moe-16b training and serving at full width and depth


def moe_plan(backbone_dtype="bfloat16"):
    """The MoE training path: deepseek-moe-16b at full width and depth, the
    training tenants on q, v and the shared experts' up / down
    (``MOE_TARGETS``), and their plan (one hTask of 11 rows x 256)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config(MOE_ARCH).with_overrides(backbone_dtype=backbone_dtype)
    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=MOE_TARGETS))
             for t in parse_tasks(TRAIN_TASKS, TRAIN_MICRO_BATCH)]
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


@contextlib.contextmanager
def moe_routes(log):
    """Appends each MoE layer call's routed expert ids [T, k] and its
    load-balance loss to ``log`` (in call order), through the port's
    ``_aux_losses``; values are unchanged.  On another family nothing is
    called."""
    from repro_torch.models import moe

    orig = moe._aux_losses

    def record(probs, ids, n_experts):
        out = orig(probs, ids, n_experts)
        log.append((ids.detach(), out["moe_load_balance"].detach()))
        return out

    moe._aux_losses = record
    try:
        yield
    finally:
        moe._aux_losses = orig


def route_flips(a, b, n):
    """(layer, token) pairs whose expert set differs between two runs'
    ``moe_routes`` logs, over their first ``n`` calls (the forward's: a
    recomputing run logs its backward's recomputations after them), and
    the pairs compared."""
    flips = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum().item())
                for (x, _), (y, _) in zip(a[:n], b[:n]))
    return {"flips": flips, "pairs": sum(int(x.shape[0]) for x, _ in a[:n])}


def route_stats(cfg, log):
    """Per logged MoE call: the tokens, the capacity, the assignments
    dropped past it and the load-balance loss (host reads)."""
    from repro_torch.models import moe

    out = []
    for ids, lb in log:
        T = int(ids.shape[0])
        cap = moe._capacity(T, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
        out.append({"tokens": T, "capacity": cap,
                    "dropped": moe.dropped_tokens(ids, cfg.num_experts, cap),
                    "load_balance": lb.item()})
    return out


class _LazyF32:
    """A stacked layer leaf (or an int8 node, or an untied token table) that
    gives an f32 copy of the layer (or the rows) it is indexed with: the f32
    serving runs of a large backbone widen one layer at a time, since the
    whole f32 backbone (67.5 GB for deepseek-moe-16b, 137.6 GB for yi-34b)
    does not fit beside the bf16 one."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, i):
        from repro_torch.models.quantize import dequantize, is_quantized

        if is_quantized(self.leaf):
            return dequantize({"q": self.leaf["q"][i], "scale": self.leaf["scale"][i]})
        return self.leaf[i].float()


def lazy_f32(torch, backbone):
    """The f32 reference weights of ``backbone`` (as ``densify``), its
    stacked layers widened one layer at a time as the model slices them and
    its token table the rows the embedding gathers."""
    from repro_torch.models.quantize import is_quantized

    def wrap(node):
        if isinstance(node, dict) and not is_quantized(node):
            return {k: wrap(v) for k, v in node.items()}
        return _LazyF32(node)

    out = {k: wrap(v) if k == "layers" else densify(torch, v) for k, v in backbone.items()
           if k != "embed"}
    out["embed"] = {k: _LazyF32(v) if k == "tok" and "unembed" in backbone["embed"]
                    else densify(torch, v) for k, v in backbone["embed"].items()}
    return out


def _lora_decode_kernels(torch, timer, g, cfg, sites, tag):
    """Grouped LoRA forward and backward (against autograd of the plain
    version) at the serving path's M = 8: four tenants at stack rank 64, two
    rows each, at each distinct (d_in, d_out) of ``sites``; the results
    (``grouped_lora_<tag>``, ``grouped_lora_bwd_<tag>_decode``) sum the
    sites of one layer of one decode step; lines of phase ``<tag>_kernels``."""
    from repro_torch.kernels import grouped_lora as gl
    from repro_torch.peft.methods import base_op_dims

    bf16, dev = torch.bfloat16, "cuda"
    T, r, M = 4, 64, 8
    rt = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32, device=dev)
    scale = torch.tensor([2.0, 1.0, 2.0, 0.5], dtype=torch.float32, device=dev)
    dims = base_op_dims(cfg)
    layer = [dims[s] for s in sites]
    per_shape = {}
    for d_in, d_out in sorted(set(layer)):
        x = torch.randn((M, d_in), generator=g, device=dev).to(bf16)
        gy = torch.randn((M, d_out), generator=g, device=dev).to(bf16)
        a = (torch.randn((T, d_in, r), generator=g, device=dev) * 0.02).to(bf16)
        b = (torch.randn((T, r, d_out), generator=g, device=dev) * 0.02).to(bf16)
        y, h = gl.grouped_lora_cuda(x, a, b, rt, scale, save_h=True)
        xr, ar, br = (t.clone().requires_grad_(True) for t in (x, a, b))
        y_ref = gl.grouped_lora_plain(xr, ar, br, rt, scale)
        grads = gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)
        refs = torch.autograd.grad(y_ref, (xr, ar, br), gy, retain_graph=True)
        where = f"grouped_lora {cfg.name} M={M} {d_in}x{d_out}"
        err_f = compare(y, y_ref, where)[0]
        err_b = max(compare(o, ref, f"{where} {n}", GRAD_TOL["grouped_lora_bwd"])[0]
                    for n, o, ref in zip(("dx", "dA", "dB"), grads, refs))
        fwd = lambda: gl.grouped_lora_cuda(x, a, b, rt, scale)  # noqa: E731
        bwd = lambda: gl.grouped_lora_bwd_cuda(x, a, b, rt, scale, h, gy)  # noqa: E731
        ab = 2 * T * r * (d_in + d_out)
        work_f = (2 * M * (d_in + d_out) + ab + 4 * (M + T), 2.0 * M * r * (d_in + d_out))
        work_b = (2 * (2 * M * d_in + M * d_out) + 2 * ab + 4 * (M * r + M + T),
                  4.0 * M * r * (d_in + d_out))
        line = {"fwd": {"ms": timer(fwd), "device_ms": kernel_device_ms(
                    torch, timer, fwd, "grouped_lora_pair"),
                        "plain_ms": timer(lambda: gl.grouped_lora_plain(x, a, b, rt, scale)),
                        "max_abs_err": err_f},
                "bwd": {"ms": timer(bwd), "device_ms": kernel_device_ms(
                    torch, timer, bwd, "grouped_lora"),
                        "plain_ms": _autograd_ms(torch, timer, y_ref, (xr, ar, br), gy),
                        "max_abs_err": err_b}}
        for key, work in (("fwd", work_f), ("bwd", work_b)):
            line[key]["bound_ms"], line[key]["bound_by"] = bound_ms(*work)
            line[key]["work"] = work
        per_shape[(d_in, d_out)] = line
        emit({"phase": f"{tag}_kernels", "card": card(), "kernel": "grouped_lora",
              "model": cfg.name, "M": M, "T": T, "r": r, "d_in": d_in, "d_out": d_out,
              **{k: {kk: vv for kk, vv in v.items() if kk != "work"} for k, v in line.items()}})
    results = {}
    for key, name in (("fwd", f"grouped_lora_{tag}"), ("bwd", f"grouped_lora_bwd_{tag}_decode")):
        sums = {f: None if any(per_shape[sh][key][f] is None for sh in layer)
                else sum(per_shape[sh][key][f] for sh in layer)
                for f in ("ms", "device_ms", "plain_ms")}
        bms, by = bound_ms(*(sum(per_shape[sh][key]["work"][i] for sh in layer)
                             for i in (0, 1)))
        results[name] = {
            "shape": f"M={M}, T={T}, r={r}: the {len(sites)} LoRA sites of one {cfg.name} "
                     f"layer (sum)",
            **sums, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "max_abs_err": max(v[key]["max_abs_err"] for v in per_shape.values())}
    return results


def moe_kernel_phase(torch, timer, cfg, tasks, plan):
    """Kernels 1-7 at the MoE paths' shapes (deepseek-moe-16b): grouped LoRA
    forward and backward at the training path's 11 x 256 rows on q, v and
    the shared experts' up / down, and at the serving path's 8 rows on all
    seven sites; packed attention's forward, dq and dk/dv on the training
    layout with one query head per k/v head (H = Hkv = 16, dh = 128), with
    its edge cases; decode attention over an 8-row, 1024-row cache at those
    heads; quant_matmul at M = 8, 4096 and 2816 for the model's BaseOp
    shapes.  Each against its plain version, with the times, bounds and
    library times of the other kernel phases; entries ``<name>_moe``."""
    g = torch.Generator(device="cuda").manual_seed(11)
    d, ffs = cfg.d_model, cfg.num_shared_experts * cfg.expert_d_ff
    results = {}
    lora, _ = _lora_train_kernels(
        torch, timer, g, tasks, plan, ((d, cfg.q_dim), (d, ffs), (ffs, d)),
        [(d, cfg.q_dim), (d, cfg.kv_dim), (d, ffs), (ffs, d)],
        "the four LoRA sites (q, v, shared up and down) of one layer", cfg.name)
    results["grouped_lora_train_moe"] = lora["grouped_lora_train"]
    results["grouped_lora_bwd_moe"] = lora["grouped_lora_bwd"]
    results.update(_lora_decode_kernels(torch, timer, g, cfg, MOE_SITES, "moe"))
    att = _attention_train_kernels(torch, timer, g, cfg, plan, cfg.name)
    results.update({f"{k}_moe": v for k, v in att.items()})
    with torch.no_grad():
        results["decode_attention_moe"] = decode_kernel_case(
            torch, timer, g, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim())
        shapes = ((d, cfg.q_dim), (d, ffs), (ffs, d))
        layer = ((d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim), (cfg.q_dim, d), (d, ffs),
                 (d, ffs), (ffs, d))
        results.update(quant_kernel_phase(torch, timer, shapes, layer, model="moe"))
    return results


def _tree_equal(torch, a, b) -> bool:
    """Whether two states (dicts, tuples, dataclasses of tensors) hold the
    same bits."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_tree_equal(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k]) for k in a)
    if hasattr(a, "__dataclass_fields__"):
        return all(_tree_equal(torch, getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def train_moe_phase(torch, cfg, tasks, plan):
    """The MoE training path: ``train_phase`` on deepseek-moe-16b, then one
    iteration run twice from one state on one numpy-seeded batch: the
    losses and the adapter and optimizer state must come out the same bits
    (dispatch and combine are gathers, no atomics), and the first run's
    routing gives the tokens dropped per layer and the load-balance loss,
    which must be what the engine added to the loss (``aux_coef`` times
    its sum over the layers)."""
    import copy
    import itertools

    import numpy as np

    from repro_torch.data import HTaskLoader

    counts, engine = train_phase(torch, cfg, tasks, plan)
    vocab = cfg.vocab_size
    fixed = {}
    for h in range(len(plan.htasks)):
        loader = HTaskLoader(plan.tasks, plan.alignment[h], vocab,
                             streams={i: _seeded_stream(131 + i, vocab)
                                      for i in range(len(plan.tasks))})
        fixed[h] = itertools.repeat(next(loader))
    snap = copy.deepcopy((engine.reg.adapter_params, engine.reg.opt_state, engine._slot_steps))
    runs = []
    for _ in range(2):
        (engine.reg.adapter_params, engine.reg.opt_state,
         engine._slot_steps) = copy.deepcopy(snap)
        log = []
        with moe_routes(log):
            m = engine.run_iteration(fixed)
        runs.append((m, (engine.reg.adapter_params, engine.reg.opt_state,
                         engine._slot_steps), log))
    (m0, s0, log0), (m1, s1, log1) = runs
    same_loss = m0.loss == m1.loss and np.array_equal(m0.per_task_loss, m1.per_task_loss)
    same_state = _tree_equal(torch, s0, s1)
    same_routes = all(torch.equal(a[0], b[0]) for a, b in zip(log0, log1))
    stats = route_stats(cfg, log0)
    lb = sum(x["load_balance"] for x in stats)
    aux = m0.loss - float(np.sum(m0.per_task_loss))
    emit({"phase": "train_moe_repeat", "card": card(), "model": cfg.name,
          "loss": [m0.loss, m1.loss], "per_task_loss": m0.per_task_loss.tolist(),
          "same_bits_loss": same_loss, "same_bits_state": same_state,
          "same_routes": same_routes, "moe_calls": len(log0),
          "tokens": stats[0]["tokens"], "capacity": stats[0]["capacity"],
          "slots": cfg.num_experts * stats[0]["capacity"],
          "assignments": stats[0]["tokens"] * cfg.top_k,
          "dropped_by_layer": [x["dropped"] for x in stats],
          "dropped_share": sum(x["dropped"] for x in stats) / float(
              len(stats) * stats[0]["tokens"] * cfg.top_k),
          "load_balance_by_layer": [round(x["load_balance"], 6) for x in stats],
          "moe_load_balance": lb, "aux_coef": engine.aux_coef,
          "loss_minus_task_losses": aux})
    if not (same_loss and same_state and same_routes):
        raise AssertionError(f"train_moe: one iteration from one state gave other bits "
                             f"(losses {same_loss}, state {same_state}, routes {same_routes})")
    if len(log0) != cfg.num_layers * len(engine._schedule(None)):
        raise AssertionError(f"train_moe: {len(log0)} MoE calls in an iteration")
    if not abs(aux - engine.aux_coef * lb) <= 1e-2 * engine.aux_coef * lb:
        raise AssertionError(f"train_moe: the loss holds {aux} beyond the tasks' losses, "
                             f"aux_coef x load balance is {engine.aux_coef * lb}")
    return counts, engine


# (rank, alpha) of the four LoRA tenants of the serving paths through the pool
SERVE_TENANTS = ((8, 16.0), (16, 16.0), (32, 64.0), (64, 32.0))
# yi-34b's tenants: a stack of rank 16, whose adapters (0.92 GiB) and AdamW
# moments (3.67 GiB) fit beside the 64.05 GiB backbone, where rank 64's
# (3.67 + 14.7 GiB) do not
YI_TENANTS = ((8, 16.0), (8, 16.0), (16, 32.0), (16, 32.0))


def serve_pool_phase(torch, arch, sites, prompts=(64, 512), new=32, bucket=512,
                     ranks=SERVE_TENANTS, backbone_dtype="bfloat16", layers=None):
    """A serving path through PEFTEngine's decode pool (phase 5's shape) on
    a dense, vlm or MoE model: ``arch`` at full width and depth (or
    ``layers`` of its layers) on a ``backbone_dtype`` backbone (random weights from a seed, the attention
    biases filled where the config has them; on vlm the prefills carry the
    prompt's M-RoPE channels, ``launch.steps.prefill_batch``), four LoRA tenants
    (``ranks``: (rank, alpha) each) on ``sites``, two rows each of an 8-row
    pool of max_len 1024, prompts of ``prompts`` tokens bound by one
    batched prefill (padded to ``bucket``), ``new`` greedy tokens each.
    Gates: the launches the path implies (quant_matmul at every BaseOp on
    int8); on MoE and int8 the backbone's bytes against Eq. 5 (an MoE
    model's routed experts stay bf16); a teacher-forced rerun with the same
    bind batch (MoE capacity depends on who shares it) on the plain
    versions and on second plain paths (``plain_split``; on int8 also
    ``plain_scale_first``) whose spread sets the gate (``_gate_from``)
    before the kernel path runs, then on the kernels (which must give the
    served tokens) and on f32 weights and adapters widened a layer at a
    time (``lazy_f32``), the pool and the tenants' AdamW moments freed
    first and its cache no longer than the run needs; the peaks below the
    card's memory.  Prints the micro step's device and host ms beside the
    floor of reading its weights (on MoE every expert's), and on MoE the
    routing flips of each path against the plain one and the tokens
    dropped per layer at the bind.  Returns the launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ModelGenerator, ParallelismSpec, PEFTEngine
    from repro_torch.core import PEFTTask
    from repro_torch.core.cost_model import CostModel
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import prefill_batch
    from repro_torch.models.quantize import tensor_bytes
    from repro_torch.peft.methods import AdapterConfig, base_op_dims

    t_phase = time.perf_counter()
    cfg = get_config(arch).with_overrides(backbone_dtype=backbone_dtype)
    if layers:
        cfg = cfg.with_overrides(num_layers=layers)
    int8, moe = backbone_dtype == "int8", cfg.family == "moe"
    suffix = path_suffix(cfg)
    L = cfg.num_layers
    total = torch.cuda.get_device_properties(0).total_memory
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=sites) for rk, al in ranks]
    tasks = [PEFTTask(f"tenant{i}", tc, (bucket,), 1) for i, tc in enumerate(tenants)]
    gen = ModelGenerator(cfg, seed=0)
    backbone = init_backbone(torch, gen)
    reg = gen.register_tasks(tasks)
    mta, adapters = reg.mta, reg.adapter_params
    _fill_zero_leaves(torch, adapters, gen.generator)  # LoRA's B starts at 0
    plan = ExecutionPlanner(cfg, ParallelismSpec()).plan(tasks)
    engine = PEFTEngine(gen, plan)
    model = engine.model
    rows, max_len = 8, 1024
    engine.ensure_decode_pool(rows, max_len, new)
    rs = np.random.RandomState(0)
    lengths = rs.randint(prompts[0], prompts[1] + 1, rows).astype(np.int32)
    lengths[0], lengths[5] = prompts[1], prompts[0]
    tokens = np.zeros((rows, bucket), np.int32)
    for i in range(rows):
        tokens[i, :lengths[i]] = rs.randint(1, cfg.vocab_size, lengths[i])
    max_new = np.full((rows,), new, np.int32)
    slots, scales = engine.decode_row_ctx([0, 0, 1, 1, 2, 2, 3, 3])
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        engine.dispatch_decode_bind_batched(np.arange(rows), tokens, lengths, slots, scales,
                                            max_new)
        acct = engine.decode_accounting()
        bind_s = time.perf_counter() - t0
        step_s = []
        while acct["active"].any():
            t1 = time.perf_counter()
            engine.dispatch_decode_micro(slots, scales)
            acct = engine.decode_accounting()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_micro = len(step_s)
    if list(acct["n_out"]) != list(max_new) or n_micro != new - 1:
        raise AssertionError(f"serve{suffix}: requests did not complete: n_out "
                             f"{acct['n_out']}, {n_micro} micro steps")
    want = dict.fromkeys(counts, 0)
    want.update({"grouped_lora": len(sites) * L * (1 + n_micro), "packed_attention": L,
                 "decode_attention": L * n_micro})
    if int8:  # every BaseOp of every layer, in the bind and in each micro step
        want["quant_matmul"] = len(base_op_dims(cfg)) * L * (1 + n_micro)
    if counts != want:
        raise AssertionError(f"serve{suffix}: kernel launches {counts}, the path implies {want}")
    served = [engine.decode_outputs(i)[:new] for i in range(rows)]
    nbytes = tensor_bytes(backbone)
    eq5 = CostModel(cfg, [], ParallelismSpec()).stage_memory([])
    if (moe or int8) and abs(nbytes - eq5) > BACKBONE_BYTES_TOL * eq5:
        raise AssertionError(f"serve{suffix}: the backbone holds {nbytes} bytes, the cost "
                             f"model {eq5}")
    # the decode micro step's weight-read floor: every weight a micro step
    # reads (all but the table the embedding gathers 8 rows from); on MoE
    # also every routed expert's three matrices in every layer (the expert
    # FFN runs all experts at full capacity)
    read_bytes = nbytes - tensor_bytes(backbone["embed"]["tok"])
    floors = {"weights_read_bytes": read_bytes,
              "weights_floor_ms": read_bytes / HBM_BYTES_PER_S * 1e3}
    if moe:
        expert_bytes = L * cfg.num_experts * 3 * cfg.d_model * cfg.expert_d_ff * 2
        floors.update({"experts_bytes": expert_bytes,
                       "experts_floor_ms": expert_bytes / HBM_BYTES_PER_S * 1e3})
    emit({"phase": "serve" + suffix, "card": card(), "model": cfg.name, "layers": L,
          "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          **({"experts": cfg.num_experts, "top_k": cfg.top_k} if moe else {}),
          "backbone_dtype": backbone_dtype, "backbone_bytes": nbytes,
          "cost_model_backbone_bytes": eq5, "param_count": cfg.param_count(),
          "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
          "requests": rows, "prompt_lengths": lengths.tolist(), "bucket": bucket,
          "max_new": new, "micro_steps": n_micro, "launches": counts, "bind_s": bind_s,
          "prefill_tokens_per_s": float(lengths.sum()) / bind_s,
          "decode_tokens_per_s": rows * n_micro / sum(step_s),
          "micro_step_ms_median": statistics.median(step_s) * 1e3, **floors,
          "max_memory_allocated": peak, "device_total_memory": total})
    with torch.no_grad():
        prof = profile_device(torch, lambda: engine.dispatch_decode_micro(slots, scales), 3,
                              {"grouped_lora": ("grouped_lora",),
                               "decode_attention": ("decode_attention_kernel",),
                               "quant_matmul": ("qmm_",)})
    emit({"phase": "profile", "path": "serve micro step" + suffix, "card": card(), **prof,
          **floors, "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})
    # the pool's caches go (the reruns hold their own), and the tenants'
    # AdamW moments (this path trains nothing): yi-34b's f32 rerun needs room
    del engine
    reg.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()

    # ---- teacher-forced rerun: each mode's logits and routes per step ----
    dev = torch.device("cuda")
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    out_t = torch.as_tensor(np.stack(served), device=dev)
    ctxf = mta.ctx_factory_from_slots(slots, scales)
    ar = torch.arange(rows, device=dev)
    logs, seconds = {}, {}

    def trajectory(name, bb, ad, dt, cache_len=max_len):
        t1 = time.perf_counter()
        with moe_routes(logs.setdefault(name, [])):
            st = model.init_decode_state(rows, cache_len, cache_dtype=dt)
            lg, st = model.prefill(bb, prefill_batch(cfg, tok_t), st, adapters=ad,
                                   ctx_factory=ctxf, lengths=len_t)
            out = [lg[ar, (len_t - 1).long()].float()]
            del lg
            for i in range(n_micro):
                lg, st = model.decode_step(bb, st, out_t[:, i:i + 1], adapters=ad,
                                           ctx_factory=ctxf)
                out.append(lg[:, 0].float())
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
        return out

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        second = {"plain_split": plain_split}
        if int8:
            second["plain_scale_first"] = plain_scale_first
        traj = {}
        with ops.force_plain():
            traj["plain"] = trajectory("plain", backbone, adapters, torch.bfloat16)
        for name, ctx in second.items():
            with ctx():
                traj[name] = trajectory(name, backbone, adapters, torch.bfloat16)
        spread = max(max(_rel_by_step(traj[n], traj["plain"])) for n in second)
        base = INT8_LOGIT_TOL if int8 else LOGIT_TOL
        tol = _gate_from(spread, base)
        emit({"phase": "serve_check" + suffix + "_gate", "card": card(),
              "plain_paths_vs_plain_max_rel": spread, "two_s": 2 * spread,
              "base_tol": base, "gate": tol})
        traj["kernel"] = trajectory("kernel", backbone, adapters, torch.bfloat16)
        tf = torch.stack([x.argmax(-1) for x in traj["kernel"]], 1).to(torch.int32)
        if not torch.equal(tf, out_t):
            raise AssertionError(f"serve{suffix}: teacher-forced kernel tokens differ from "
                                 f"the served tokens")
        with ops.force_plain():
            traj["f32"] = trajectory("f32", lazy_f32(torch, backbone), tree_map(
                lambda t: _LazyF32(t) if t.is_floating_point() else t, adapters),
                torch.float32, bucket + new)
    check_peak = torch.cuda.max_memory_allocated()
    rel = {"kernel_vs_plain": _rel_by_step(traj["kernel"], traj["plain"]),
           "kernel_vs_f32": _rel_by_step(traj["kernel"], traj["f32"]),
           "plain_vs_f32": _rel_by_step(traj["plain"], traj["f32"])}
    rel.update({f"{n}_vs_plain": _rel_by_step(traj[n], traj["plain"]) for n in second})
    top = {k: max(v) for k, v in rel.items()}
    agree = min((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(traj["kernel"], traj["plain"]))
    routing = {}
    if moe:
        bind = route_stats(cfg, logs["kernel"][:L])
        routing = {
            "routing_flips": {f"{m}_vs_plain": route_flips(logs[m], logs["plain"],
                                                           len(logs["plain"]))
                              for m in logs if m != "plain"},
            "bind_tokens": bind[0]["tokens"], "bind_capacity": bind[0]["capacity"],
            "bind_dropped_by_layer": [x["dropped"] for x in bind],
            "decode_capacity": route_stats(cfg, logs["kernel"][L:L + 1])[0]["capacity"],
            "decode_dropped": sum(x["dropped"] for x in route_stats(cfg, logs["kernel"][L:]))}
    emit({"phase": "serve_check" + suffix, "card": card(), "steps": n_micro + 1,
          "logit_max_rel_err": top["kernel_vs_plain"], "tol_rel": tol,
          "logit_worst_step": rel["kernel_vs_plain"].index(top["kernel_vs_plain"]),
          **{f"{k}_max_rel": v for k, v in top.items() if k != "kernel_vs_plain"},
          **routing, "argmax_agreement_min": agree, "trajectory_seconds": seconds,
          "max_memory_allocated": check_peak, "device_total_memory": total,
          "phase_seconds": time.perf_counter() - t_phase,
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in rel.items()}})
    if not max(peak, check_peak) < total:
        raise AssertionError(f"serve{suffix}: peak {max(peak, check_peak)} bytes, the card "
                             f"holds {total}")
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_check{suffix}: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if not top["kernel_vs_f32"] <= 2 * top["plain_vs_f32"]:
        raise AssertionError(f"serve_check{suffix}: the kernel path is further from the f32 "
                             f"run ({top['kernel_vs_f32']}) than twice the plain path "
                             f"({top['plain_vs_f32']})")
    return counts


def zamba_serve_kernel_phase(torch, timer, cfg):
    """The hybrid serving paths' kernels at their shapes: decode attention
    over the shared block's cache (H = Hkv = 32, dh = 80: ten 8-dim lanes a
    key) and quant_matmul at zamba2's BaseOp shapes, M = 8 (decode), 4096
    and 2816 (training); the in-projection's N = 10,448 ends in a partial
    tile of 80 columns on both routes.  Entries ``decode_attention_zamba2``
    and ``quant_matmul_zamba2`` (one super-block's 17 products)."""
    from repro_torch.peft.methods import base_op_dims

    g = torch.Generator(device="cuda").manual_seed(13)
    d, per = cfg.d_model, cfg.hybrid_period - 1
    (_, n_in), (d_in, _) = base_op_dims(cfg)["ssm_in"], base_op_dims(cfg)["ssm_out"]
    layer = ((d, n_in), (d_in, d)) * per + (
        (d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim), (cfg.q_dim, d), (d, cfg.d_ff),
        (d, cfg.d_ff), (cfg.d_ff, d))
    shapes = tuple(dict.fromkeys(layer))  # each distinct (K, N) once
    with torch.no_grad():
        results = {"decode_attention_zamba2": decode_kernel_case(
            torch, timer, g, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(), cfg.name)}
        results.update(quant_kernel_phase(
            torch, timer, shapes, layer, model="zamba2",
            layer_what=f"the {len(layer)} BaseOp products of one super-block"))
    return results


def starcoder2_kernel_phase(torch, timer, cfg, tasks, plan):
    """Kernels 1-6 at starcoder2-7b's shapes: grouped LoRA forward and
    backward at the training path's rows on q, v, fc1 (4608 -> 18432) and
    fc2 (18432 -> 4608), and at M = 8 on the six serving sites; packed
    attention's forward, dq and dk/dv on the training layout at 9 query
    heads per k/v head (H = 36, Hkv = 4), with its edge cases; decode
    attention at those heads, where the P V partials take shared memory of
    their own (G = 9).  Entries ``<name>_starcoder2``."""
    g = torch.Generator(device="cuda").manual_seed(17)
    d, ff = cfg.d_model, cfg.d_ff
    sites = [(d, cfg.q_dim), (d, cfg.kv_dim), (d, ff), (ff, d)]
    lora, _ = _lora_train_kernels(torch, timer, g, tasks, plan, sites, sites,
                                  "the four LoRA sites (q, v, fc1, fc2) of one layer", cfg.name)
    results = {"grouped_lora_train_starcoder2": lora["grouped_lora_train"],
               "grouped_lora_bwd_starcoder2": lora["grouped_lora_bwd"]}
    results.update(_lora_decode_kernels(torch, timer, g, cfg, STARCODER2_SITES, "starcoder2"))
    att = _attention_train_kernels(torch, timer, g, cfg, plan, cfg.name)
    results.update({f"{k}_starcoder2": v for k, v in att.items()})
    with torch.no_grad():
        results["decode_attention_starcoder2"] = decode_kernel_case(
            torch, timer, g, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(), cfg.name)
    return results


def yi_kernel_phase(torch, timer):
    """yi-34b's serving shapes: grouped LoRA at M = 8 on its seven sites
    (7168 -> 20480 among them) and decode attention at 7 query heads per
    k/v head (H = 56, Hkv = 8).  Entries ``<name>_yi``."""
    from repro_torch.configs import get_config

    cfg = get_config(YI_ARCH)
    g = torch.Generator(device="cuda").manual_seed(19)
    results = _lora_decode_kernels(torch, timer, g, cfg, SITES, "yi")
    with torch.no_grad():
        results["decode_attention_yi"] = decode_kernel_case(
            torch, timer, g, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(), cfg.name)
    return results


def _rel_by_step(a, b):
    """Per step: max |a - b| over the rows, relative to the largest |b|."""
    return [((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b)]


def serve_zamba_phase(torch, backbone_dtype="bfloat16"):
    """The hybrid serving path: zamba2-2.7b at full width and
    ``ZAMBA_SERVE_LAYERS`` of its 54 layers on a
    ``backbone_dtype`` backbone (random weights from a seed), four LoRA
    tenants (ranks 8-64) on ssm_in, ssm_out, attn_q and attn_v, two rows
    each, routed per row through ``ctx_factory_from_slots``; prompts of
    16-64 tokens fed through ``Model.decode_step`` (the hybrid family has no
    prefill), each row then greedy for 32 tokens, all rows stepping
    together (``ZAMBA_SERVE_STEPS`` steps).  Gates: the launches the path
    implies (decode attention once a super-block, grouped LoRA at each site,
    on int8 quant_matmul at every BaseOp, no other kernel); teacher-forced
    reruns of the fed tokens on the plain versions and on second plain paths
    (``plain_split``; on int8 ``plain_scale_first``), whose spread sets
    the gate (``_gate_from``), then (bf16) on f32 weights, each held to the
    served run's logits (the kernel path on the same tokens); the kernel path's
    distance from its own ``Model.forward`` over the same tokens (packed
    attention and mamba_scan) within twice the plain path's.  Prints the
    decode step's device and host ms, the peak memory and, on int8, the
    backbone's bytes beside Eq. 5.  Returns the launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ModelGenerator, ParallelismSpec, PEFTTask
    from repro_torch.core.cost_model import CostModel
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import quantized_param_count, tensor_bytes
    from repro_torch.peft.methods import AdapterConfig

    t_phase = time.perf_counter()
    int8 = backbone_dtype == "int8"
    cfg = get_config("zamba2-2.7b").with_overrides(backbone_dtype=backbone_dtype,
                                                   num_layers=ZAMBA_SERVE_LAYERS)
    suffix = path_suffix(cfg)
    n_super, per = cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period - 1
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=ZAMBA_TARGETS)
               for rk, al in ((8, 16.0), (16, 16.0), (32, 64.0), (64, 32.0))]
    tasks = [PEFTTask(f"tenant{i}", tc, (ZAMBA_SERVE_PROMPTS[1],), 1)
             for i, tc in enumerate(tenants)]
    gen = ModelGenerator(cfg, seed=0)
    backbone = gen.init_backbone()
    reg = gen.register_tasks(tasks)
    mta, adapters = reg.mta, reg.adapter_params
    _fill_zero_leaves(torch, adapters, gen.generator)  # LoRA's B starts at 0
    model = gen.model
    rows, T, new = ZAMBA_SERVE_ROWS, ZAMBA_SERVE_STEPS, ZAMBA_SERVE_NEW
    rs = np.random.RandomState(0)
    lengths = rs.randint(ZAMBA_SERVE_PROMPTS[0], ZAMBA_SERVE_PROMPTS[1] + 1, rows)
    lengths[0], lengths[5] = ZAMBA_SERVE_PROMPTS[1], ZAMBA_SERVE_PROMPTS[0]
    prompts = np.zeros((rows, T), np.int32)
    for i, n in enumerate(lengths):
        prompts[i, :n] = rs.randint(1, cfg.vocab_size, n)
    dev = torch.device("cuda")
    slots = {k: torch.as_tensor(v, device=dev)
             for k, v in mta.decode_row_slots([0, 0, 1, 1, 2, 2, 3, 3]).items()}
    ctxf = mta.ctx_factory_from_slots(slots)
    feed = torch.as_tensor(prompts, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    fed = torch.zeros((rows, T), dtype=torch.int32, device=dev)  # the token each step takes
    picked = torch.zeros((rows, T), dtype=torch.int32, device=dev)  # each step's argmax
    served = []  # each step's logits: the kernel path's trajectory of the check below
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    with torch.no_grad():
        st = model.init_decode_state(rows, T)
        cur = feed[:, :1]
        for t in range(T):
            t1 = time.perf_counter()
            fed[:, t] = cur[:, 0]
            lg, st = model.decode_step(backbone, st, cur, adapters=adapters, ctx_factory=ctxf)
            served.append(lg[:, 0].float())
            picked[:, t] = lg[:, 0].argmax(-1).to(torch.int32)
            if t + 1 < T:  # the prompt while it lasts, then the row's own greedy token
                cur = torch.where(t + 1 < len_t, feed[:, t + 1], picked[:, t])[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counts, 0)
    want.update({"decode_attention": n_super * T,
                 "grouped_lora": n_super * (2 * per + 2) * T})
    if int8:
        want["quant_matmul"] = base_op_calls(cfg) * T
    if counts != want:
        raise AssertionError(f"serve{suffix}: kernel launches {counts}, the path implies {want}")
    generated = [picked[i, lengths[i] - 1:lengths[i] - 1 + new].tolist() for i in range(rows)]
    nbytes = tensor_bytes(backbone)
    eq5 = CostModel(cfg, [], ParallelismSpec()).stage_memory([])
    line = {"phase": "serve" + suffix, "card": card(), "model": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model, "super_blocks": n_super,
            "backbone_dtype": backbone_dtype, "backbone_bytes": nbytes,
            "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
            "rows": rows, "prompt_lengths": lengths.tolist(), "new_tokens": new, "steps": T,
            "launches": counts, "step_ms_median": statistics.median(step_s) * 1e3,
            "decode_tokens_per_s": rows * T / sum(step_s),
            "max_memory_allocated": peak, "first_generated": generated[0][:8]}
    if int8:  # Eq. 5 prices the whole backbone at one byte (the JAX clamp)
        line.update({"cost_model_backbone_bytes": eq5,
                     "quantized_param_count": quantized_param_count(cfg),
                     "param_count": cfg.param_count(),
                     "backbone_bytes_over_eq5": nbytes / eq5 - 1.0})
    emit(line)
    with torch.no_grad():
        prof = profile_device(torch, lambda: model.decode_step(
            backbone, st, fed[:, -1:], adapters=adapters, ctx_factory=ctxf), 3,
            {"grouped_lora": ("grouped_lora",), "decode_attention": ("decode_attention_kernel",),
             "quant_matmul": ("qmm_",)})
    emit({"phase": "profile", "path": "serve decode step" + suffix, "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})
    del st

    # ---- teacher-forced reruns of the fed tokens, and the forward ----
    def trajectory(bb, ad, dt):
        state = model.init_decode_state(rows, T, cache_dtype=dt)
        out = []
        for t in range(T):
            lg, state = model.decode_step(bb, state, fed[:, t:t + 1], adapters=ad,
                                          ctx_factory=ctxf)
            out.append(lg[:, 0].float())
        return out

    def forward(bb, ad):
        lg = model.forward(bb, {"tokens": fed}, adapters=ad, ctx_factory=ctxf,
                           return_logits=True)["logits"]
        return [lg[:, t].float() for t in range(T)]

    bf16 = torch.bfloat16
    traj, fwd, seconds = {}, {}, {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
        return out

    with torch.no_grad():
        # the second plain path: decode attention's split order, or on int8
        # the scale's place (the larger of the two on every int8 path so far)
        second = {"plain_scale_first": plain_scale_first} if int8 else \
            {"plain_split": plain_split}
        with ops.force_plain():
            traj["plain"] = timed("plain", lambda: trajectory(backbone, adapters, bf16))
            fwd["plain"] = forward(backbone, adapters)
        for name, ctx in second.items():
            with ctx():
                traj[name] = timed(name, lambda: trajectory(backbone, adapters, bf16))
        spread = max(max(_rel_by_step(traj[n], traj["plain"])) for n in second)
        base = INT8_LOGIT_TOL if int8 else LOGIT_TOL
        tol = _gate_from(spread, base)
        emit({"phase": "serve_check" + suffix + "_gate", "card": card(),
              "plain_paths_vs_plain_max_rel": spread, "two_s": 2 * spread, "base_tol": base,
              "gate": tol})
        traj["kernel"] = served  # the served run is the kernel path's teacher-forced run
        fwd["kernel"] = forward(backbone, adapters)
        if not int8:  # the f32 guard (on int8 the decode-vs-forward gate alone)
            f32_bb = densify(torch, backbone)
            f32_ad = tree_map(lambda t: t.float() if t.is_floating_point() else t, adapters)
            with ops.force_plain():
                traj["f32"] = timed("f32", lambda: trajectory(f32_bb, f32_ad, torch.float32))
            del f32_bb
    rel = {"kernel_vs_plain": _rel_by_step(traj["kernel"], traj["plain"]),
           "kernel_decode_vs_forward": _rel_by_step(traj["kernel"], fwd["kernel"]),
           "plain_decode_vs_forward": _rel_by_step(traj["plain"], fwd["plain"])}
    if "f32" in traj:
        rel["kernel_vs_f32"] = _rel_by_step(traj["kernel"], traj["f32"])
        rel["plain_vs_f32"] = _rel_by_step(traj["plain"], traj["f32"])
    rel.update({f"{n}_vs_plain": _rel_by_step(traj[n], traj["plain"]) for n in second})
    top = {k: max(v) for k, v in rel.items()}
    agree = min((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(traj["kernel"], traj["plain"]))
    emit({"phase": "serve_check" + suffix, "card": card(), "steps": T,
          "logit_max_rel_err": top["kernel_vs_plain"], "tol_rel": tol,
          "logit_worst_step": rel["kernel_vs_plain"].index(top["kernel_vs_plain"]),
          **{f"{k}_max_rel": v for k, v in top.items() if k != "kernel_vs_plain"},
          "argmax_agreement_min": agree, "trajectory_seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in rel.items()}})
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_check{suffix}: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if "kernel_vs_f32" in top and not top["kernel_vs_f32"] <= 2 * top["plain_vs_f32"]:
        raise AssertionError(f"serve_check{suffix}: the kernel path is further from the f32 "
                             f"run ({top['kernel_vs_f32']}) than twice the plain path "
                             f"({top['plain_vs_f32']})")
    if not top["kernel_decode_vs_forward"] <= 2 * top["plain_decode_vs_forward"]:
        raise AssertionError(f"serve_check{suffix}: the kernels' decode is "
                             f"{top['kernel_decode_vs_forward']} from their forward, over twice "
                             f"the plain path's {top['plain_decode_vs_forward']}")
    return counts


# ---------------------------------------------------------------------------
# the vlm and audio families: qwen2-vl-7b and whisper-large-v3


def qwen2vl_plan():
    """The qwen2-vl training path: qwen2-vl-7b at full width and depth
    (bf16), the training tenants on q, v, up and down, and their plan."""
    return _retargeted_plan(QWEN2VL_ARCH, QWEN2VL_TARGETS)


def _attention_case(torch, timer, g, tag, case, dims, causal, bq, bk, grads=True):
    """Packed attention over q [B, S, H, dh] and k/v [B, Sk, Hkv, dh]
    (``dims`` = (B, S, Sk, H, Hkv, dh)), one segment a row at positions
    0.. each: the forward (o, lse), dq and dk/dv against the plain version
    and autograd of it (``_attention_check``), timed (the forward, and with
    ``grads`` the backward kernels) beside the plain version and SDPA on the
    same q, k, v (causal, or every key visible), with the bound from the
    visible pairs.  One line; returns {"fwd": entry, "dq": ..., "dkv": ...}."""
    import torch.nn.functional as F

    from repro_torch.kernels import packed_attention as pa

    bf16, dev = torch.bfloat16, "cuda"
    B, S, Sk, H, Hkv, dh = dims

    def ids(n, fill=None):
        if fill is not None:
            return torch.full((B, n), fill, dtype=torch.int32, device=dev)
        return torch.arange(n, dtype=torch.int32, device=dev).expand(B, n).contiguous()

    ints = (ids(S), ids(S, 0), ids(Sk), ids(Sk, 0))
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    k = torch.randn((B, Sk, Hkv, dh), generator=g, device=dev).to(bf16)
    v = torch.randn((B, Sk, Hkv, dh), generator=g, device=dev).to(bf16)
    do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    where = f"packed_attention {tag} {case} (bq={bq}, bk={bk})"
    (o, lse), (o_ref, qr, kr, vr), mask, _, errs = _attention_check(
        torch, q, k, v, do, ints, causal, bq, bk, where)
    pairs = int(mask.sum().item()) * H
    del mask
    qo, kv = 2 * B * S * H * dh, 2 * B * Sk * Hkv * dh
    ib = 4 * 2 * B * (S + Sk) + 4 * B * H * S
    calls = {"fwd": lambda: pa.packed_attention_cuda(q, k, v, *ints, causal, bq, bk,
                                                     save_lse=True),
             "dq": lambda: pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, causal,
                                                       bq, bk),
             "dkv": lambda: pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, causal,
                                                         bq, bk)}
    keys = ("fwd", "dq", "dkv") if grads else ("fwd",)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(grads) for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    plain = {"fwd": timer(lambda: pa.packed_attention_plain(q, k, v, *ints, causal, bq, bk))}
    lib = {"fwd": timer(sdpa)}
    lib_dev = {"fwd": library_device_ms(torch, timer, sdpa)}
    if grads:
        o_lib = sdpa()
        plain.update(dq=_autograd_ms(torch, timer, o_ref, (qr,), do),
                     dkv=_autograd_ms(torch, timer, o_ref, (kr, vr), do))
        lib.update(dq=_autograd_ms(torch, timer, o_lib, (qt,), dot),
                   dkv=_autograd_ms(torch, timer, o_lib, (kt, vt), dot))
        lib_dev.update({key: library_device_ms(torch, timer, lambda ins=ins: torch.autograd.grad(
            o_lib, ins, dot, retain_graph=True)) for key, ins in (("dq", (qt,)),
                                                                  ("dkv", (kt, vt)))})
    bounds = {"fwd": bound_ms(2 * qo + 2 * kv + ib, 4.0 * dh * pairs),
              "dq": bound_ms(4 * qo + 2 * kv + ib, 6.0 * dh * pairs),
              "dkv": bound_ms(3 * qo + 4 * kv + ib, 8.0 * dh * pairs)}
    shape = (f"B={B}, S={S}, Sk={Sk}, H={H}, Hkv={Hkv}, dh={dh}, "
             f"{'causal' if causal else 'non-causal'}, {pairs} visible (query, key, head) "
             f"triples")
    out = {}
    for key, err in zip(keys, errs):
        out[key] = {"shape": shape, "ms": timer(calls[key]),
                    "device_ms": kernel_device_ms(torch, timer, calls[key],
                                                  f"packed_attention_{key}"),
                    "plain_ms": plain[key], "bound_ms": bounds[key][0],
                    "bound_by": bounds[key][1], "library_ms": lib[key],
                    "library_device_ms": lib_dev[key], "max_abs_err": err}
    emit({"phase": "kernels", "kernel": "packed_attention", "model": tag, "card": card(),
          "case": case, "B": B, "S": S, "Sk": Sk, "H": H, "Hkv": Hkv, "dh": dh,
          "causal": causal, "bq": bq, "bk": bk, "fwd_lse_max_abs_err": errs[0],
          "dq_max_abs_err": errs[1], "dkv_max_abs_err": errs[2],
          **{key: {kk: vv for kk, vv in e.items() if kk != "shape"} for key, e in out.items()}})
    return out


def _stored_o_case(torch, g, tag, dims, bq, bk):
    """Packed attention's backward kernels where every key and value row
    shares a large common part (as the bias b_k / b_v and the LayerNorm give
    whisper's encoder rows) and the scores are small, non-causal: dq =
    scale sum_k p (dp - D) k cancels that common part exactly, so the D =
    rowsum(do * o) that the kernels (and the Pallas ones) take from the
    stored bf16 o moves dq by far more than 2**-9 of it.  dq and dk/dv are
    held to the plain backward that reads D from the same stored o
    (``packed_attention_stored_o_plain``'s), within their kernel
    tolerances; their distance from autograd of the f32 plain version is
    printed beside, ungated.  One line; returns the largest gated error."""
    import types

    from repro_torch.kernels import packed_attention as pa

    bf16, dev = torch.bfloat16, "cuda"
    B, S, Sk, H, Hkv, dh = dims

    def ids(n, fill=None):
        if fill is not None:
            return torch.full((B, n), fill, dtype=torch.int32, device=dev)
        return torch.arange(n, dtype=torch.int32, device=dev).expand(B, n).contiguous()

    def common(shape, n):  # N(0, 1) rows plus a part shared by every row
        c = torch.randn((1, 1) + shape[2:], generator=g, device=dev) * n
        return (torch.randn(shape, generator=g, device=dev) + c).to(bf16)

    ints = (ids(S), ids(S, 0), ids(Sk), ids(Sk, 0))
    q = (torch.randn((B, S, H, dh), generator=g, device=dev) * 0.1).to(bf16)
    k, v = common((B, Sk, Hkv, dh), 3.0), common((B, Sk, Hkv, dh), 3.0)
    do = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf16)
    rule = (False, bq, bk)
    o, lse = pa.packed_attention_cuda(q, k, v, *ints, *rule, save_lse=True)
    dq = pa.packed_attention_dq_cuda(q, k, v, *ints, o, lse, do, *rule)
    dk, dv = pa.packed_attention_dkv_cuda(q, k, v, *ints, o, lse, do, *rule)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, *ints, o), rule=rule)
    ref = pa._StoredOPlainFunction.backward(ctx, do)[:3]
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    f32 = torch.autograd.grad(pa.packed_attention_plain(qr, kr, vr, *ints, *rule),
                              (qr, kr, vr), do)
    where = f"packed_attention {tag} shared_kv stored-o"
    errs = {n: compare(t, r, f"{where} {n}", GRAD_TOL["packed_attention_" + kern])[0]
            for n, t, r, kern in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                     ("dq", "dkv", "dkv"))}
    vs_f32 = {n: ((t.float() - r.float()).abs().max() / r.float().abs().max()).item()
              for n, t, r in zip(("dq", "dk", "dv"), (dq, dk, dv), f32)}
    emit({"phase": "kernels", "kernel": "packed_attention", "model": tag, "card": card(),
          "case": "shared_kv", "B": B, "S": S, "Sk": Sk, "H": H, "Hkv": Hkv, "dh": dh,
          "max_abs_err_vs_stored_o_plain": errs,
          "rel_err_vs_f32_autograd_ungated": vs_f32})
    return max(errs.values())


def qwen2vl_kernel_phase(torch, timer, cfg, tasks, plan):
    """Kernels 1-6 at qwen2-vl-7b's shapes: grouped LoRA forward and
    backward at the training path's rows on q (3584 -> 3584), v (-> 512),
    up (-> 18944) and down, and at M = 8 on its seven serving sites; packed
    attention's forward, dq and dk/dv on the training layout at 7 query
    heads per k/v head (H = 28, Hkv = 4, dh = 128: dk/dv summed over seven
    heads), with its edge cases, and its forward at the bind's prefill (8 x
    512); decode attention at those heads.  Entries ``<name>_qwen2vl``."""
    g = torch.Generator(device="cuda").manual_seed(23)
    d, ff = cfg.d_model, cfg.d_ff
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    sites = [(d, cfg.q_dim), (d, cfg.kv_dim), (d, ff), (ff, d)]
    lora, _ = _lora_train_kernels(torch, timer, g, tasks, plan, sites, sites,
                                  "the four LoRA sites (q, v, up, down) of one layer", cfg.name)
    results = {"grouped_lora_train_qwen2vl": lora["grouped_lora_train"],
               "grouped_lora_bwd_qwen2vl": lora["grouped_lora_bwd"]}
    results.update(_lora_decode_kernels(torch, timer, g, cfg, SITES, "qwen2vl"))
    att = _attention_train_kernels(torch, timer, g, cfg, plan, cfg.name)
    results.update({f"{k}_qwen2vl": v for k, v in att.items()})
    from repro_torch.kernels import packed_attention as pa

    pre = _attention_case(torch, timer, g, cfg.name, "prefill", (8, 512, 512, H, Hkv, dh), True,
                          *pa.tile_sizes(512, 512, cfg.attn_q_block), grads=False)
    results["packed_attention_prefill_qwen2vl"] = pre["fwd"]
    with torch.no_grad():
        results["decode_attention_qwen2vl"] = decode_kernel_case(torch, timer, g, H, Hkv, dh,
                                                                 cfg.name)
    return results


def _decode_cross_case(torch, timer, g, cfg):
    """Decode attention over whisper's fixed cross cache: 8 rows, each
    window the whole 1500 encoder rows (``lo`` 0, ``len`` 1500), H = Hkv =
    20, dh = 64, against the plain version and beside SDPA over the whole
    cache (no mask).  One line; returns its entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    dev, bf16 = "cuda", torch.bfloat16
    Bd, Smax = WHISPER_SERVE_ROWS, cfg.max_source_positions
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    qd = torch.randn((Bd, 1, H, dh), generator=g, device=dev).to(bf16)
    kc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    vc = torch.randn((Bd, Smax, Hkv, dh), generator=g, device=dev).to(bf16)
    end = torch.full((Bd,), Smax, dtype=torch.int32, device=dev)
    start = torch.zeros((Bd,), dtype=torch.int32, device=dev)
    call = lambda: ops.decode_attention(qd, kc, vc, end, start)  # noqa: E731
    out = call()
    with ops.force_plain():
        ref = call()
        plain_ms = timer(call)
    err, rel, tol = compare(out, ref, "decode_attention cross")
    qt = qd.transpose(1, 2).contiguous()
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    window = Bd * Smax
    bms, by = bound_ms(2 * (2 * Bd * H * dh + 2 * window * Hkv * dh) + 4 * 2 * Bd,
                       4.0 * H * dh * window)
    entry = {"shape": f"B={Bd}, Smax={Smax}, H={H}, Hkv={Hkv}, dh={dh}, every row's window "
                      f"the whole cross cache ({window} rows)",
             "ms": timer(call),
             "device_ms": kernel_device_ms(torch, timer, call, "decode_attention_kernel"),
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": timer(sdpa),
             "library_device_ms": library_device_ms(torch, timer, sdpa), "max_abs_err": err}
    emit({"phase": "kernels", "kernel": "decode_attention", "model": cfg.name, "card": card(),
          "case": "cross", "max_rel_err": rel, "tol": tol,
          **{k: v for k, v in entry.items() if k != "shape"}})
    return entry


class _RowPlan:
    """The part of an ExecutionPlan that ``_lora_train_kernels`` reads, for
    whisper's training rows (no planner: its batches carry the frames):
    one hTask of ``rows`` x ``row_len``, the rows laid out as ``segments``."""

    def __init__(self, rows, row_len, segments):
        import types

        self.htasks = [types.SimpleNamespace(rows=rows, row_len=row_len)]
        self._segments = segments

    def segments_for(self, i):
        return self._segments


def whisper_kernel_phase(torch, timer):
    """Kernels 1-6 at whisper-large-v3's shapes: grouped LoRA forward and
    backward at train_whisper's rows (8 x 256) on the decoder's q (twice a
    layer: self and cross), v, fc1 (1280 -> 5120) and fc2, and at M = 8 on
    its serving sites (q and o twice a layer); packed attention at the
    encoder (8 x 1500 frames, H = Hkv = 20, dh = 64, non-causal: the tile
    rule's gcd(1500, 128) = 4 plays no part, and the kernels' last query and
    key tiles are partial), at the decoder's causal self-attention (8 x 256)
    and at its cross-attention (8 x 256 queries over 1500 frames,
    non-causal), forward, dq and dk/dv, the backward also where keys and
    values share a large common part (``_stored_o_case``); decode attention at the
    self-attention's heads and over the fixed cross cache.  Entries
    ``<name>_whisper`` (the cross-attention's ``<name>_cross_whisper``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import packed_attention as pa

    cfg = get_config(WHISPER_ARCH)
    g = torch.Generator(device="cuda").manual_seed(29)
    d, ff, Sa = cfg.d_model, cfg.d_ff, cfg.max_source_positions
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    B, S = WHISPER_TRAIN_ROWS, WHISPER_TRAIN_LEN
    tasks, segments = whisper_tasks()
    layer = [(d, d), (d, d), (d, d), (d, ff), (ff, d)]
    lora, _ = _lora_train_kernels(
        torch, timer, g, tasks, _RowPlan(B, S, segments), sorted(set(layer)), layer,
        "the five LoRA calls (self q, cross q, v, fc1, fc2) of one decoder layer", cfg.name)
    results = {"grouped_lora_train_whisper": lora["grouped_lora_train"],
               "grouped_lora_bwd_whisper": lora["grouped_lora_bwd"]}
    results.update(_lora_decode_kernels(torch, timer, g, cfg, WHISPER_SITES + ("attn_q", "attn_o"),
                                        "whisper"))
    enc = _attention_case(torch, timer, g, cfg.name, "encoder", (B, Sa, Sa, H, Hkv, dh), False,
                          *pa.tile_sizes(Sa, Sa, cfg.attn_q_block), grads=False)
    dec = _attention_case(torch, timer, g, cfg.name, "decoder_self", (B, S, S, H, Hkv, dh), True,
                          *pa.tile_sizes(S, S, cfg.attn_q_block))
    cross = _attention_case(torch, timer, g, cfg.name, "cross", (B, S, Sa, H, Hkv, dh), False,
                            *pa.tile_sizes(S, Sa))
    _stored_o_case(torch, g, cfg.name, (B, S, Sa, H, Hkv, dh), *pa.tile_sizes(S, Sa))
    results.update({"packed_attention_encoder_whisper": enc["fwd"],
                    "packed_attention_train_whisper": dec["fwd"],
                    "packed_attention_dq_whisper": dec["dq"],
                    "packed_attention_dkv_whisper": dec["dkv"],
                    "packed_attention_cross_whisper": cross["fwd"],
                    "packed_attention_dq_cross_whisper": cross["dq"],
                    "packed_attention_dkv_cross_whisper": cross["dkv"]})
    with torch.no_grad():
        results["decode_attention_whisper"] = decode_kernel_case(torch, timer, g, H, Hkv, dh,
                                                                 cfg.name)
        results["decode_attention_cross_whisper"] = _decode_cross_case(torch, timer, g, cfg)
    return results


def whisper_tasks():
    """train_whisper's tenants (``TRAIN_TASKS``, two rows each) on the
    decoder's q, v, fc1 and fc2, and their rows (contiguous, two a task)."""
    import dataclasses

    from repro_torch.launch.train import parse_tasks
    from repro_torch.peft.multitask import TaskSegments

    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter,
                                                                targets=WHISPER_TARGETS))
             for t in parse_tasks(TRAIN_TASKS, 2)]
    return tasks, TaskSegments.contiguous([t.micro_batch for t in tasks])


class WhisperTrainer:
    """train_whisper's state: whisper-large-v3 at full width and depth (a
    seed-0 backbone, every bias filled, ``init_backbone``), the tenants of
    ``whisper_tasks`` and ``launch.steps.build_train_step`` (the JAX
    package's model-level training step; its PEFTEngine batches carry no
    frames).  Batch ``i`` (:meth:`batch`) holds 8 rows of 256 tokens, one
    sequence a row (the decoder's self-attention takes no segments), their
    next tokens as labels, and random bf16 frames [8, 1500, 1280], all from
    ``data_seed`` and ``i``.  ``train_check`` reads it as it reads an
    engine: ``reg``, ``model``, ``backbone``, ``device``,
    ``_loss_and_grads_fn`` and ``check_batch``."""

    def __init__(self, torch, data_seed: int = 0):
        from repro_torch.configs import get_config
        from repro_torch.core import ModelGenerator
        from repro_torch.launch.steps import build_train_step

        self.torch, self.data_seed = torch, data_seed
        self.cfg = get_config(WHISPER_ARCH)
        self.tasks, self.segments = whisper_tasks()
        gen = ModelGenerator(self.cfg, seed=0)
        self.backbone = init_backbone(torch, gen)
        self.reg = gen.register_tasks(self.tasks)
        self.model, self.device = gen.model, gen.device
        self.step = build_train_step(self.model, self.reg.mta, self.segments, lr=TRAIN_LR)

    def batch(self, i: int, seed=None):
        import numpy as np

        torch, cfg = self.torch, self.cfg
        seed = self.data_seed * 1000 + i if seed is None else seed
        rs = np.random.RandomState(seed)
        B, S = WHISPER_TRAIN_ROWS, WHISPER_TRAIN_LEN
        toks = torch.as_tensor(rs.randint(1, cfg.vocab_size, (B, S + 1)).astype(np.int32),
                               device=self.device)
        g = torch.Generator(device=self.device).manual_seed(seed)
        frames = torch.randn((B, cfg.max_source_positions, cfg.d_model), generator=g,
                             device=self.device).to(torch.bfloat16)
        return {"tokens": toks[:, :S].contiguous(), "labels": toks[:, 1:].contiguous(),
                "loss_mask": torch.ones((B, S), dtype=torch.float32, device=self.device),
                "audio_embed": frames}

    def run(self, batch):
        """One training step; returns (loss, per-task losses) on the device."""
        reg = self.reg
        reg.adapter_params, reg.opt_state, loss, pt = self.step(
            self.backbone, reg.adapter_params, reg.opt_state, batch)
        return loss, pt

    def _loss_and_grads_fn(self, _htask):
        return self.step.loss_and_grads

    def check_batch(self, seed: int):
        return self.batch(0, seed=97 + seed)


def whisper_step_launches(cfg, adapters):
    """Kernel launches of one whisper training step: packed attention once
    an encoder layer (forward only: no gradient reaches the encoder) and
    twice a decoder layer (self and cross, forward, dq and dk/dv); grouped
    LoRA (forward and backward) once a decoder layer at each LoRA site,
    twice at q and o (the decoder layer's scope covers its cross-attention,
    which projects q alone)."""
    L = cfg.num_layers
    lora = L * sum(2 if site in ("attn_q", "attn_o") else 1
                   for kind in GROUPED_LORA_KINDS for site in adapters.get(kind, {}))
    return {"grouped_lora": lora, "grouped_lora_bwd": lora,
            "packed_attention": cfg.num_encoder_layers + 2 * L,
            "packed_attention_dq": 2 * L, "packed_attention_dkv": 2 * L}


def train_whisper_phase(torch):
    """The audio training path: ``WhisperTrainer``'s one warm-up and
    ``TRAIN_ITERS`` timed steps, each on a fresh batch; launch counts
    checked against ``whisper_step_launches``, one step profiled.  Returns
    (the launch counts, the trainer) for ``train_check``."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.quantize import tensor_bytes

    tr = WhisperTrainer(torch)
    cfg, B, S = tr.cfg, WHISPER_TRAIN_ROWS, WHISPER_TRAIN_LEN
    t0 = time.perf_counter()
    tr.run(tr.batch(0))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    secs, losses = [], []
    for i in range(TRAIN_ITERS):
        batch = tr.batch(1 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, pt = tr.run(batch)
        pt = pt.tolist()  # the step's one host read
        secs.append(time.perf_counter() - t1)
        if not np.all(np.isfinite(pt)):
            raise AssertionError(f"train_whisper step {i}: non-finite loss {pt}")
        losses.append(pt)
        emit({"phase": "train_iteration_whisper", "iteration": i, "loss": float(loss),
              "per_task_loss": pt, "seconds": secs[-1], "tokens_per_s": B * S / secs[-1]})
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update({k: TRAIN_ITERS * v
                 for k, v in whisper_step_launches(cfg, tr.reg.adapter_params).items()})
    if counts != want:
        raise AssertionError(f"train_whisper: kernel launches {counts}, the path implies {want}")
    emit({"phase": "train_whisper", "card": card(), "model": cfg.name,
          "layers": cfg.num_layers, "encoder_layers": cfg.num_encoder_layers,
          "d_model": cfg.d_model, "backbone_bytes": tensor_bytes(tr.backbone),
          "param_count": cfg.param_count(), "tasks": TRAIN_TASKS,
          "targets": list(WHISPER_TARGETS), "rows": B, "row_len": S,
          "frames": cfg.max_source_positions, "lr": TRAIN_LR, "warmup_seconds": warm_s,
          "steps": TRAIN_ITERS, "launches": counts,
          "seconds_per_step_median": statistics.median(secs),
          "tokens_per_s_median": B * S / statistics.median(secs),
          "frames_per_s_median": B * cfg.max_source_positions / statistics.median(secs),
          "first_per_task_loss": losses[0], "last_per_task_loss": losses[-1],
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    batch = tr.batch(TRAIN_ITERS + 1)
    prof = profile_device(torch, lambda: tr.run(batch), 1,
                          {"grouped_lora": ("grouped_lora",),
                           "packed_attention": ("packed_attention",),
                           "f32_matmul": ("sgemm", "f32f32")})
    emit({"phase": "profile", "path": "train step_whisper", "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(secs) * 1e3) if prof["device_ms_per_call"] else None})
    return counts, tr


def serve_whisper_phase(torch):
    """The audio serving path: whisper-large-v3 at full width, its 32
    encoder layers and ``WHISPER_SERVE_LAYERS`` of its 32 decoder layers
    (random weights from a seed, every bias filled), the encoder run once
    over random bf16 frames [8, 1500, 1280] into the fixed cross caches
    (``Model.init_decode_state(params=..., audio_embed=...)``: L x 8 x
    1500 x 20 x 64, k and v), four LoRA tenants (ranks 8-64) on the
    decoder's six sites, two rows each, routed per row through
    ``ctx_factory_from_slots``; prompts of 16-64 tokens fed through
    ``Model.decode_step`` (the audio family has no prefill), each row then
    greedy for 32 tokens, all rows stepping together (``WHISPER_SERVE_STEPS``
    steps).  Gates: the launches the path implies (packed attention once an
    encoder layer; per step decode attention twice a layer, self and cross,
    and grouped LoRA at each site, q and o twice: the cross-attention's too);
    teacher-forced reruns of the fed tokens (each from its own encoder run)
    on the plain versions and on a second plain path (``plain_split``),
    whose spread sets the gate (``_gate_from``), held to the served run's
    logits over the real vocabulary; the kernel path's distance from its
    own ``Model.forward`` over the same tokens and frames within twice the
    plain path's (the decode rotates the cross-attention's q at the
    cache's row count, the forward at each token's index, as the JAX
    package does, so neither distance is small).  No f32 rerun: the
    plain reruns of 95 host-bound steps already take most of the phase's
    time, and the decode-vs-forward gate holds the kernels to the plain
    path's accuracy, as on serve_zamba_int8.  Prints the encoder's
    seconds, the decode step's device and host ms and the peak memory.
    Returns the launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ModelGenerator, PEFTTask
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import tensor_bytes
    from repro_torch.peft.methods import AdapterConfig

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER_ARCH).with_overrides(num_layers=WHISPER_SERVE_LAYERS)
    L, suffix = cfg.num_layers, path_suffix(cfg)
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=WHISPER_SITES)
               for rk, al in SERVE_TENANTS]
    tasks = [PEFTTask(f"tenant{i}", tc, (WHISPER_SERVE_PROMPTS[1],), 1)
             for i, tc in enumerate(tenants)]
    gen = ModelGenerator(cfg, seed=0)
    backbone = init_backbone(torch, gen)
    reg = gen.register_tasks(tasks)
    mta, adapters = reg.mta, reg.adapter_params
    _fill_zero_leaves(torch, adapters, gen.generator)  # LoRA's B starts at 0
    model = gen.model
    rows, T, new = WHISPER_SERVE_ROWS, WHISPER_SERVE_STEPS, WHISPER_SERVE_NEW
    # logits compared over the real vocabulary: the padded columns hold -1e9
    V = cfg.vocab_size
    dev = torch.device("cuda")
    frames = torch.randn((rows, cfg.max_source_positions, cfg.d_model), generator=gen.generator,
                         device=dev).to(torch.bfloat16)
    rs = np.random.RandomState(0)
    lengths = rs.randint(WHISPER_SERVE_PROMPTS[0], WHISPER_SERVE_PROMPTS[1] + 1, rows)
    lengths[0], lengths[5] = WHISPER_SERVE_PROMPTS[1], WHISPER_SERVE_PROMPTS[0]
    prompts = np.zeros((rows, T), np.int32)
    for i, n in enumerate(lengths):
        prompts[i, :n] = rs.randint(1, cfg.vocab_size, n)
    slots = {k: torch.as_tensor(v, device=dev)
             for k, v in mta.decode_row_slots([0, 0, 1, 1, 2, 2, 3, 3]).items()}
    ctxf = mta.ctx_factory_from_slots(slots)
    feed = torch.as_tensor(prompts, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    fed = torch.zeros((rows, T), dtype=torch.int32, device=dev)
    picked = torch.zeros((rows, T), dtype=torch.int32, device=dev)
    served = []
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    with torch.no_grad():
        t0 = time.perf_counter()
        # three rows more than the steps: the profile below runs three more
        st = model.init_decode_state(rows, T + 3, params=backbone, audio_embed=frames)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        cur = feed[:, :1]
        for t in range(T):
            t1 = time.perf_counter()
            fed[:, t] = cur[:, 0]
            lg, st = model.decode_step(backbone, st, cur, adapters=adapters, ctx_factory=ctxf)
            served.append(lg[:, 0, :V].float())
            picked[:, t] = lg[:, 0].argmax(-1).to(torch.int32)
            if t + 1 < T:  # the prompt while it lasts, then the row's own greedy token
                cur = torch.where(t + 1 < len_t, feed[:, t + 1], picked[:, t])[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counts, 0)
    want.update({"packed_attention": cfg.num_encoder_layers, "decode_attention": 2 * L * T,
                 "grouped_lora": (len(WHISPER_SITES) + 2) * L * T})
    if counts != want:
        raise AssertionError(f"serve{suffix}: kernel launches {counts}, the path implies {want}")
    generated = [picked[i, lengths[i] - 1:lengths[i] - 1 + new].tolist() for i in range(rows)]
    emit({"phase": "serve" + suffix, "card": card(), "model": cfg.name, "layers": L,
          "encoder_layers": cfg.num_encoder_layers, "d_model": cfg.d_model,
          "backbone_bytes": tensor_bytes(backbone), "param_count": cfg.param_count(),
          "cross_cache_bytes": tensor_bytes({"k": st["cross_k"], "v": st["cross_v"]}),
          "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
          "rows": rows, "frames": cfg.max_source_positions, "prompt_lengths": lengths.tolist(),
          "new_tokens": new, "steps": T, "launches": counts, "encode_s": encode_s,
          "step_ms_median": statistics.median(step_s) * 1e3,
          "decode_tokens_per_s": rows * T / sum(step_s),
          "max_memory_allocated": peak, "first_generated": generated[0][:8]})
    with torch.no_grad():
        prof = profile_device(torch, lambda: model.decode_step(
            backbone, st, fed[:, -1:], adapters=adapters, ctx_factory=ctxf), 3,
            {"grouped_lora": ("grouped_lora",), "decode_attention": ("decode_attention_kernel",)})
    emit({"phase": "profile", "path": "serve decode step" + suffix, "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})
    del st

    # ---- teacher-forced reruns of the fed tokens, and the forward ----
    def trajectory(bb, ad, dt):
        state = model.init_decode_state(rows, T, cache_dtype=dt, params=bb,
                                        audio_embed=frames.to(dt))
        out = []
        for t in range(T):
            lg, state = model.decode_step(bb, state, fed[:, t:t + 1], adapters=ad,
                                          ctx_factory=ctxf)
            out.append(lg[:, 0, :V].float())
        return out

    def forward(bb, ad):
        lg = model.forward(bb, {"tokens": fed, "audio_embed": frames}, adapters=ad,
                           ctx_factory=ctxf, return_logits=True)["logits"]
        return [lg[:, t, :V].float() for t in range(T)]

    traj, fwd, seconds = {}, {}, {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
        return out

    bf16 = torch.bfloat16
    with torch.no_grad():
        with ops.force_plain():
            traj["plain"] = timed("plain", lambda: trajectory(backbone, adapters, bf16))
            fwd["plain"] = forward(backbone, adapters)
        with plain_split():
            traj["plain_split"] = timed("plain_split",
                                        lambda: trajectory(backbone, adapters, bf16))
        spread = max(_rel_by_step(traj["plain_split"], traj["plain"]))
        tol = _gate_from(spread, LOGIT_TOL)
        emit({"phase": "serve_check" + suffix + "_gate", "card": card(),
              "plain_paths_vs_plain_max_rel": spread, "two_s": 2 * spread,
              "base_tol": LOGIT_TOL, "gate": tol})
        traj["kernel"] = served  # the served run is the kernel path's teacher-forced run
        fwd["kernel"] = forward(backbone, adapters)
    rel = {"kernel_vs_plain": _rel_by_step(traj["kernel"], traj["plain"]),
           "kernel_decode_vs_forward": _rel_by_step(traj["kernel"], fwd["kernel"]),
           "plain_decode_vs_forward": _rel_by_step(traj["plain"], fwd["plain"]),
           "plain_split_vs_plain": _rel_by_step(traj["plain_split"], traj["plain"])}
    top = {k: max(v) for k, v in rel.items()}
    agree = min((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(traj["kernel"], traj["plain"]))
    emit({"phase": "serve_check" + suffix, "card": card(), "steps": T,
          "logit_max_rel_err": top["kernel_vs_plain"], "tol_rel": tol,
          "logit_worst_step": rel["kernel_vs_plain"].index(top["kernel_vs_plain"]),
          **{f"{k}_max_rel": v for k, v in top.items() if k != "kernel_vs_plain"},
          "argmax_agreement_min": agree, "trajectory_seconds": seconds,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "phase_seconds": time.perf_counter() - t_phase,
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in rel.items()}})
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_check{suffix}: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if not top["kernel_decode_vs_forward"] <= 2 * top["plain_decode_vs_forward"]:
        raise AssertionError(f"serve_check{suffix}: the kernels' decode is "
                             f"{top['kernel_decode_vs_forward']} from their forward, over twice "
                             f"the plain path's {top['plain_decode_vs_forward']}")
    return counts


@contextlib.contextmanager
def audited_calls(torch, records):
    """Each tiled mamba_scan kernel call (the forward, the state and the
    chunk backward), each grouped-LoRA kernel call (forward and backward)
    and each quant_matmul kernel call, as it runs, held to its plain
    version on the same operands (autograd of it for the grouped-LoRA
    backward): a record per output, ``(kernel_output, error as a share of
    the plain output's largest magnitude, tolerance)``; y, dq, dk, dv, the
    LoRA outputs and the int8 products at KERNEL_TOL (GRAD_TOL for the
    backwards), the f32 states and rows (h, hin, gexit, dh0, dcum, dli) at
    F32_TOL.  The kernels' results are returned unchanged.  On a model
    whose logits and gradients no end-to-end comparison can hold (a bf16
    unit anywhere grows to their size over its depth) this holds every
    kernel call of the path on the operands the path gave it."""
    from repro_torch.kernels import grouped_lora as gl
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import quant_matmul as qm

    names = ("mamba_scan_tiled_cuda", "mamba_scan_bwd_state_tiled_cuda",
             "mamba_scan_bwd_chunk_tiled_cuda")
    orig = {name: getattr(ms, name) for name in names}
    orig_lora = gl.grouped_lora_cuda, gl.grouped_lora_bwd_cuda
    orig_qmm = qm.quant_matmul_cuda
    chunk_tol = GRAD_TOL["mamba_scan_bwd_chunk"]

    def rel(out, ref):
        scale = ref.float().abs().max().item()
        return (out.float() - ref.float()).abs().max().item() / scale if scale else 0.0

    def add(kernel, outs, got, refs, tols):
        for name, out, ref, tol in zip(outs, got, refs, tols):
            if out is not None:
                records.append((f"{kernel}_{name}", rel(out, ref), tol))

    def scan(q, k, v, la, li, r, h0, chunk, save_states=False):
        out = orig[names[0]](q, k, v, la, li, r, h0, chunk, save_states)
        add("mamba_scan_tiled", ("y", "h", "hin"), out,
            ms.mamba_scan_plain(q, k, v, la, li, r, h0, chunk, save_states),
            (KERNEL_TOL, F32_TOL, F32_TOL))
        return out

    def state(q, la, r, dy, dhf, chunk, want_dh0=True):
        out = orig[names[1]](q, la, r, dy, dhf, chunk, want_dh0)
        add("mamba_scan_bwd_state_tiled", ("gexit", "dh0"), out,
            ms.mamba_scan_bwd_state_plain(q, la, r, dy, dhf, chunk, want_dh0), (F32_TOL,) * 2)
        return out

    def chunk_(q, k, v, la, li, r, dy, hin, gexit, chunk):
        out = orig[names[2]](q, k, v, la, li, r, dy, hin, gexit, chunk)
        add("mamba_scan_bwd_chunk_tiled", ("dq", "dk", "dv", "dcum", "dli"), out,
            ms.mamba_scan_bwd_chunk_plain(q, k, v, la, li, r, dy, hin, gexit, chunk),
            (chunk_tol,) * 3 + (F32_TOL,) * 2)
        return out

    def lora(x, a, b, rt, scale, **kw):
        out = orig_lora[0](x, a, b, rt, scale, **kw)
        y = out[0] if isinstance(out, tuple) else out
        records.append(("grouped_lora", rel(y, gl.grouped_lora_plain(x, a, b, rt, scale)),
                        KERNEL_TOL))
        return out

    def lora_bwd(x, a, b, rt, scale, h, g):
        out = orig_lora[1](x, a, b, rt, scale, h, g)
        with torch.enable_grad():
            ts = [t.detach().requires_grad_(True) for t in (x, a, b)]
            refs = torch.autograd.grad(gl.grouped_lora_plain(*ts, rt, scale), ts, g)
        add("grouped_lora_bwd", ("dx", "da", "db"), out, refs,
            (GRAD_TOL["grouped_lora_bwd"],) * 3)
        return out

    def qmm(x, q, scale):
        out = orig_qmm(x, q, scale)
        records.append(("quant_matmul", rel(out, qm.quant_matmul_plain(x, q, scale)),
                        KERNEL_TOL))
        return out

    for name, fn in zip(names, (scan, state, chunk_)):
        setattr(ms, name, fn)
    gl.grouped_lora_cuda, gl.grouped_lora_bwd_cuda = lora, lora_bwd
    qm.quant_matmul_cuda = qmm
    try:
        yield
    finally:
        for name in names:
            setattr(ms, name, orig[name])
        gl.grouped_lora_cuda, gl.grouped_lora_bwd_cuda = orig_lora
        qm.quant_matmul_cuda = orig_qmm


def audit_summary(records):
    """Per kernel output of ``audited_calls`` (or of another audit's
    records): calls, the worst error, the tolerance, the calls over it and
    the worst call's index among that output's calls."""
    out = {}
    for kernel, err, tol in records:
        e = out.setdefault(kernel, {"calls": 0, "max": 0.0, "tol": tol, "over": 0, "worst": 0})
        if err > e["max"]:
            e["max"], e["worst"] = err, e["calls"]
        e["over"] += err > tol
        e["calls"] += 1
    return out


def train_check_xlstm(torch, engine, seed=3):
    """``train_check`` on xlstm-1.3b (gate ``XLSTM_GRAD_PATH_TOL``, on an
    int8 backbone ``XLSTM_INT8_GRAD_PATH_TOL``) with one more run of the
    kernel path, ``audit``, under ``audited_calls``: every tiled scan
    (forward, state and chunk backward), grouped-LoRA (forward and
    backward) and, on int8, quant_matmul call of the step held to its plain
    version on its operands.  Random weights make this model chaotic (a
    bf16 unit anywhere grows to the logits' size over its 48 blocks,
    ``serve_xlstm``), so the audit is the check that counts: it fails
    unless every output was audited on every call the step makes
    (``step_launches``, ``base_op_calls``) and none is over its tolerance.
    The audit's line is printed even when a gate of ``train_check``
    fails."""
    records = []
    try:
        train_check(torch, engine, seed, extra={"audit": lambda: audited_calls(torch, records)})
    finally:
        audit = audit_summary(records)
        emit({"phase": f"train_check{path_suffix(engine.model.cfg)}_audit", "seed": seed,
              "card": card(), "audit": audit})
    n = step_launches(engine.model.cfg, engine.reg.adapter_params)
    scans, lora = n["mamba_scan_tiled"], n["grouped_lora"]
    want = {f"mamba_scan_tiled_{o}": scans for o in ("y", "h", "hin")}
    want["mamba_scan_bwd_state_tiled_gexit"] = scans  # (no dh0: h0 = 0 takes no gradient)
    want.update({f"mamba_scan_bwd_chunk_tiled_{o}": scans
                 for o in ("dq", "dk", "dv", "dcum", "dli")})
    want["grouped_lora"] = lora
    want.update({f"grouped_lora_bwd_{o}": lora for o in ("dx", "da", "db")})
    cfg = engine.model.cfg
    if cfg.backbone_dtype == "int8":  # every BaseOp of the forward (dx is a plain product)
        want["quant_matmul"] = base_op_calls(cfg)
    calls = {name: e["calls"] for name, e in audit.items()}
    if calls != want or any(e["over"] for e in audit.values()):
        raise AssertionError(f"train_check{path_suffix(cfg)}: audit calls {calls}, the step "
                             f"implies {want}; {audit}")


def serve_xlstm_phase(torch, backbone_dtype="bfloat16"):
    """The ssm family's serving path: xlstm-1.3b at full width and
    ``XLSTM_SERVE_LAYERS`` of its 48 blocks (2 of its 6 super-blocks of 7
    mLSTM and 1 sLSTM; random bf16 weights from a seed) on a
    ``backbone_dtype`` backbone, four LoRA tenants
    (``SERVE_TENANTS``' ranks and
    alphas) on the mLSTM's ssm_in, attn_q and attn_v and the sLSTM's ssm_in,
    two rows each, routed per row through ``ctx_factory_from_slots``;
    prompts of 16-64 tokens fed through ``Model.decode_step`` (the family
    has no prefill), each row then greedy for 32 tokens, all rows stepping
    together (``XLSTM_SERVE_STEPS`` steps) over 1.88 GB of mLSTM states.
    Gates: the launches the path implies (per step grouped LoRA 44 = 2 x
    (7 x 3 + 1); on int8 quant_matmul 74 = 2 x (7 x 5 + 2), every BaseOp;
    no other kernel: the recurrent steps are plain PyTorch, as in the JAX
    package); a teacher-forced rerun of the fed tokens on the plain versions
    and one on a second plain path, ``plain_reordered`` (grouped LoRA's f32
    sums as two halves; on int8 ``plain_scale_first``, the int8 product's
    scale before the sum), whose spread sets the gate (``_gate_from``),
    held to the served run's logits (``plain_split``, the other second
    plain path, changes decode attention only, which this path does not
    run: it is the plain path bit for bit, so it is not rerun);
    ``Model.forward`` over the same tokens on the kernels: 14
    ``ops.mamba_scan`` calls, each one ``mamba_scan_tiled`` call (three CUDA
    launches: the chunk's scores, the 16 x 17 tiles of the padded [1024,
    1088] state a (row, head), y by column tile), 44 grouped LoRA and on
    int8 74 quant_matmul, nothing else; its distance from the kernels'
    decode within twice the plain path's.  On random weights this model
    carries a difference of one bf16 unit to the logits' size over its
    blocks (the plain paths' spread is of that order from the first step),
    so those gates cannot fail; the audit (``audited_calls``) holds each of
    the forward's 14 tiled scans, 44 grouped-LoRA and (int8) 74
    quant_matmul calls and each grouped-LoRA and quant_matmul call of two
    decode steps to its plain version on the operands the path gave it.
    Prints the decode step's device and host ms and the peak memory, on
    int8 the backbone's bytes beside Eq. 5's price.  Returns the launch
    counts of the decode and the forward."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import ModelGenerator, ParallelismSpec, PEFTTask
    from repro_torch.core.cost_model import CostModel
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import quantized_param_count, tensor_bytes
    from repro_torch.peft.methods import AdapterConfig

    t_phase = time.perf_counter()
    int8 = backbone_dtype == "int8"
    cfg = get_config(XLSTM_ARCH).with_overrides(num_layers=XLSTM_SERVE_LAYERS,
                                                backbone_dtype=backbone_dtype)
    suffix = path_suffix(cfg)
    n_super, per = cfg.num_layers // cfg.slstm_period, cfg.slstm_period - 1
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=XLSTM_TARGETS)
               for rk, al in SERVE_TENANTS]
    tasks = [PEFTTask(f"tenant{i}", tc, (ZAMBA_SERVE_PROMPTS[1],), 1)
             for i, tc in enumerate(tenants)]
    gen = ModelGenerator(cfg, seed=0)
    backbone = gen.init_backbone()
    reg = gen.register_tasks(tasks)
    mta, adapters = reg.mta, reg.adapter_params
    _fill_zero_leaves(torch, adapters, gen.generator)  # LoRA's B starts at 0
    model = gen.model
    rows, T, new = ZAMBA_SERVE_ROWS, XLSTM_SERVE_STEPS, ZAMBA_SERVE_NEW
    rs = np.random.RandomState(0)
    lengths = rs.randint(ZAMBA_SERVE_PROMPTS[0], ZAMBA_SERVE_PROMPTS[1] + 1, rows)
    lengths[0], lengths[5] = ZAMBA_SERVE_PROMPTS[1], ZAMBA_SERVE_PROMPTS[0]
    prompts = np.zeros((rows, T), np.int32)
    for i, n in enumerate(lengths):
        prompts[i, :n] = rs.randint(1, cfg.vocab_size, n)
    dev = torch.device("cuda")
    slots = {k: torch.as_tensor(v, device=dev)
             for k, v in mta.decode_row_slots([0, 0, 1, 1, 2, 2, 3, 3]).items()}
    ctxf = mta.ctx_factory_from_slots(slots)
    feed = torch.as_tensor(prompts, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    fed = torch.zeros((rows, T), dtype=torch.int32, device=dev)  # the token each step takes
    picked = torch.zeros((rows, T), dtype=torch.int32, device=dev)  # each step's argmax
    served = []  # each step's logits: the kernel path's trajectory of the check below
    vocab = cfg.vocab_size
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    with torch.no_grad():
        st = model.init_decode_state(rows, T)
        state_bytes = tensor_bytes(st["mlstm"]) + tensor_bytes(st["slstm"])
        cur = feed[:, :1]
        for t in range(T):
            t1 = time.perf_counter()
            fed[:, t] = cur[:, 0]
            lg, st = model.decode_step(backbone, st, cur, adapters=adapters, ctx_factory=ctxf)
            served.append(lg[:, 0, :vocab].float())
            picked[:, t] = lg[:, 0, :vocab].argmax(-1).to(torch.int32)
            if t + 1 < T:  # the prompt while it lasts, then the row's own greedy token
                cur = torch.where(t + 1 < len_t, feed[:, t + 1], picked[:, t])[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lora_a_step = n_super * (per * len(XLSTM_TARGETS) + 1)
    qmm_a_step = base_op_calls(cfg) if int8 else 0
    want = dict.fromkeys(counts, 0)
    want["grouped_lora"] = lora_a_step * T
    if int8:
        want["quant_matmul"] = qmm_a_step * T
    if counts != want:
        raise AssertionError(f"serve{suffix}: kernel launches {counts}, the path implies {want}")
    generated = [picked[i, lengths[i] - 1:lengths[i] - 1 + new].tolist() for i in range(rows)]
    nbytes = tensor_bytes(backbone)
    line = {"phase": "serve" + suffix, "card": card(), "model": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model, "super_blocks": n_super,
            "backbone_dtype": backbone_dtype, "backbone_bytes": nbytes,
            "state_bytes": state_bytes,
            "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
            "rows": rows, "prompt_lengths": lengths.tolist(), "new_tokens": new, "steps": T,
            "launches": counts, "step_ms_median": statistics.median(step_s) * 1e3,
            "decode_tokens_per_s": rows * T / sum(step_s),
            "max_memory_allocated": peak, "first_generated": generated[0][:8]}
    if int8:  # Eq. 5 prices the clamped count at one byte (the JAX clamp)
        eq5 = CostModel(cfg, [], ParallelismSpec()).stage_memory([])
        line.update({"cost_model_backbone_bytes": eq5,
                     "quantized_param_count": quantized_param_count(cfg),
                     "param_count": cfg.param_count(), "backbone_bytes_over_eq5": nbytes / eq5})
    emit(line)
    with torch.no_grad():
        prof = profile_device(torch, lambda: model.decode_step(
            backbone, st, fed[:, -1:], adapters=adapters, ctx_factory=ctxf), 3,
            {"grouped_lora": ("grouped_lora",), "quant_matmul": ("qmm_",)})
    emit({"phase": "profile", "path": "serve decode step" + suffix, "card": card(), **prof,
          "device_busy_share_unprofiled": prof["device_ms_per_call"] / (
              statistics.median(step_s) * 1e3) if prof["device_ms_per_call"] else None})
    del st

    # ---- teacher-forced reruns of the fed tokens, and the forward ----
    def trajectory():
        state = model.init_decode_state(rows, T)
        out = []
        for t in range(T):
            lg, state = model.decode_step(backbone, state, fed[:, t:t + 1], adapters=adapters,
                                          ctx_factory=ctxf)
            out.append(lg[:, 0, :vocab].float())
        return out

    def forward():
        lg = model.forward(backbone, {"tokens": fed}, adapters=adapters, ctx_factory=ctxf,
                           return_logits=True)["logits"]
        return [lg[:, t, :vocab].float() for t in range(T)]

    traj, fwd, seconds = {}, {}, {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
        return out

    second = {"plain_scale_first": plain_scale_first} if int8 else \
        {"plain_reordered": plain_reordered}
    with torch.no_grad():
        with ops.force_plain():
            traj["plain"] = timed("plain", trajectory)
            fwd["plain"] = timed("plain_forward", forward)
        for name, ctx in second.items():
            with ctx():
                traj[name] = timed(name, trajectory)
        spread = max(max(_rel_by_step(traj[n], traj["plain"])) for n in second)
        base = INT8_LOGIT_TOL if int8 else LOGIT_TOL
        tol = _gate_from(spread, base)
        emit({"phase": "serve_check" + suffix + "_gate", "card": card(),
              "plain_paths_vs_plain_max_rel": spread, "two_s": 2 * spread,
              "base_tol": base, "gate": tol})
        traj["kernel"] = served  # the served run is the kernel path's teacher-forced run
        ops.reset_launch_counts()
        fwd["kernel"] = timed("kernel_forward", forward)
        fwd_counts = ops.launch_counts()
        records = []
        with audited_calls(torch, records):
            forward()
            state = model.init_decode_state(rows, T)
            for t in range(2):
                model.decode_step(backbone, state, fed[:, t:t + 1], adapters=adapters,
                                  ctx_factory=ctxf)
            del state
    audit = audit_summary(records)
    want = dict.fromkeys(fwd_counts, 0)
    want.update({"grouped_lora": lora_a_step, "mamba_scan_tiled": n_super * per})
    if int8:
        want["quant_matmul"] = qmm_a_step
    if fwd_counts != want:
        raise AssertionError(f"serve{suffix} forward: kernel launches {fwd_counts}, the path "
                             f"implies {want}")
    rel = {"kernel_vs_plain": _rel_by_step(traj["kernel"], traj["plain"]),
           "kernel_decode_vs_forward": _rel_by_step(traj["kernel"], fwd["kernel"]),
           "plain_decode_vs_forward": _rel_by_step(traj["plain"], fwd["plain"]),
           "kernel_forward_vs_plain_forward": _rel_by_step(fwd["kernel"], fwd["plain"])}
    rel.update({f"{n}_vs_plain": _rel_by_step(traj[n], traj["plain"]) for n in second})
    top = {k: max(v) for k, v in rel.items()}
    agree = min((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(traj["kernel"], traj["plain"]))
    emit({"phase": "serve_check" + suffix, "card": card(), "steps": T,
          "logit_max_rel_err": top["kernel_vs_plain"], "tol_rel": tol,
          "logit_worst_step": rel["kernel_vs_plain"].index(top["kernel_vs_plain"]),
          **{f"{k}_max_rel": v for k, v in top.items() if k != "kernel_vs_plain"},
          "forward_launches": fwd_counts, "audit": audit, "argmax_agreement_min": agree,
          "trajectory_seconds": seconds, "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "phase_seconds": time.perf_counter() - t_phase,
          "rel_err_by_step": {k: [round(x, 5) for x in v] for k, v in rel.items()}})
    if not top["kernel_vs_plain"] <= tol:
        raise AssertionError(f"serve_check{suffix}: logits kernel vs plain off by "
                             f"{top['kernel_vs_plain']} of the largest logit > {tol}")
    if not top["kernel_decode_vs_forward"] <= 2 * top["plain_decode_vs_forward"]:
        raise AssertionError(f"serve_check{suffix}: the kernels' decode is "
                             f"{top['kernel_decode_vs_forward']} from their forward, over twice "
                             f"the plain path's {top['plain_decode_vs_forward']}")
    calls = {name: e["calls"] for name, e in audit.items()}
    want = {"mamba_scan_tiled_y": n_super * per, "mamba_scan_tiled_h": n_super * per,
            "grouped_lora": 3 * lora_a_step}
    if int8:  # the forward's and two decode steps'
        want["quant_matmul"] = 3 * qmm_a_step
    if calls != want or any(e["over"] for e in audit.values()):
        raise AssertionError(f"serve_check{suffix}: audit calls {calls}, the path implies "
                             f"{want}; {audit}")
    return {k: counts[k] + fwd_counts[k] for k in counts}


# ---------------------------------------------------------------------------
# The multi_rank phase: two ranks on one card, joined by gloo
# ---------------------------------------------------------------------------

# Two processes on cuda:0 (NCCL refuses two ranks on one device), joined by
# gloo through a FileStore: the port's sharded math at full width with its
# kernels inside each rank, held to the single-rank path on the same card.
# It measures no NCCL behaviour, no link bandwidth and no multi-card speed.
MULTI_RANK_WORLD = 2
MULTI_RANK_TIMEOUT_S = 300  # every collective; the world is killed after 2x
MOE_EP_LAYERS = MOE_SERVE_LAYERS  # deepseek-moe-16b at 14 of 28 layers
# a capacity factor at which neither MoE branch drops a token on the a2a
# case's batch: the local branch's slots are 4x an expert's mean load, the
# a2a branch's c_send holds a rank's every assignment and c_exp 9.5x the mean
MOE_A2A_CF = 4.0
CP_B, CP_S = 2, 8192  # llama3.2-3b's attention, striped over the two ranks
CP_SECOND_BLOCK = 512  # the second plain path's block (the rule gives 256)
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 2, 4, (2, 256)  # 2 x 14 layers of llama3.2-3b
# the EP gradient gate's base: the MoE training check's gate (kernel vs
# plain, routing flips included, MOE_GRAD_PATH_TOL); the gate is
# max(base, 2 S), S the distance between two plain single-rank paths
EP_GRAD_BASE = MOE_GRAD_PATH_TOL


def _rel_leaf_max(torch, a, b):
    """The largest per-leaf ``max|a - b| / max|b|`` over two trees, and its
    leaf."""
    worst = (0.0, "")
    for path in _leaf_paths(b):
        x, y = _leaf(a, path), _leaf(b, path)
        if x is None or not y.is_floating_point():
            continue
        scale = y.float().abs().max().item()
        if scale == 0.0:
            continue
        err = (x.float() - y.float()).abs().max().item() / scale
        if err > worst[0]:
            worst = (err, ".".join(path))
    return worst


def _err(out, ref):
    """(max abs error, its share of the reference's largest |value|)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, (err / scale if scale else 0.0)


class _Lines:
    """A rank's lines, each written to its file as it comes (the calling
    process prints them when the world ends, whether or not it failed)."""

    def __init__(self, path):
        self.path = path

    def append(self, line) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")


def _raise_if(failures, what: str) -> None:
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))


def _rank_stats(torch, ms: float) -> dict:
    """This rank's device ms, collective and staged bytes by op, and peak."""
    from repro_torch.distributed import collectives as C

    return {"device_ms": ms, "collective_bytes": dict(C.collective_bytes),
            "staged_bytes": dict(C.staged_bytes),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


class _Span:
    """CUDA events around a block on this rank's stream (device ms), the
    ranks of ``mesh`` lined up first by a barrier (so that no rank's time
    holds another's preceding work)."""

    def __init__(self, torch, mesh):
        self.torch, self.mesh = torch, mesh

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.distributed import collectives as C

        self.torch.cuda.synchronize()
        dist.barrier(group=self.mesh.group(self.mesh.axis_names)[0])
        C.reset_counters()
        self.torch.cuda.reset_peak_memory_stats()
        self.start = self.torch.cuda.Event(enable_timing=True)
        self.end = self.torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.end.synchronize()
        self.ms = self.start.elapsed_time(self.end)


def gloo_probe(torch, mesh) -> dict:
    """Each primitive that ``collectives.GLOO_CUDA_OPS`` marks direct, run by
    gloo on CUDA tensors of both ranks and checked; a primitive that raises
    or gives other values fails the phase (the table is wrong).  Entries
    marked False are staged through host memory and not probed here."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    pg, ranks = mesh.group("model")
    r, n = mesh.rank, len(ranks)
    dev = torch.device("cuda")
    got = {}
    for op, direct in C.GLOO_CUDA_OPS.items():
        if not direct:
            got[op] = "staged (not probed)"
            continue
        try:  # reports each primitive; the route is the table's, never this
            ok = _probe_op(torch, dist, op, pg, ranks, r, n, dev)
        except Exception as exc:  # noqa: BLE001
            ok = f"raised {type(exc).__name__}: {str(exc)[:200]}"
        got[op] = "direct" if ok is True else (ok or "other values")
    line = {"phase": "multi_rank_gloo_probe", "rank": r, "gloo_cuda_ops": got}
    if any(v not in ("direct", "staged (not probed)") for v in got.values()):
        raise AssertionError(f"gloo_probe: GLOO_CUDA_OPS is wrong on this card: {line}")
    return line


def _probe_op(torch, dist, op, pg, ranks, r, n, dev) -> bool:
    """One primitive on CUDA tensors of every rank: whether it gave the
    values it should."""
    if op == "all_reduce":
        x = torch.full((1000,), float(r + 1), device=dev)
        dist.all_reduce(x, group=pg)
        return bool((x == n * (n + 1) / 2).all())
    if op == "all_gather":
        x = torch.full((1000,), float(r), device=dev)
        parts = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(parts, x, group=pg)
        return all(bool((p == i).all()) for i, p in enumerate(parts))
    if op == "all_to_all":  # rank j's block r is r + 10 j
        x = torch.arange(n, dtype=torch.float32, device=dev).repeat_interleave(4) + 10 * r
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=pg)
        return bool((out.view(n, 4) == (torch.arange(n, device=dev) * 10 + r)[:, None]).all())
    raise AssertionError(f"gloo_probe: no probe for {op}")


def moe_ep_plan():
    """train_moe's tenants on deepseek-moe-16b cut to ``MOE_EP_LAYERS``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config(MOE_ARCH).with_overrides(num_layers=MOE_EP_LAYERS)
    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=MOE_TARGETS))
             for t in parse_tasks(TRAIN_TASKS, TRAIN_MICRO_BATCH)]
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def _fill_adapters(torch, tree, seed):
    """The zero-initialised leaves (LoRA b, Adapter up, IA3 s) filled from
    ``seed`` (train_check's fill), so that every leaf takes a gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def fill(node):
        return {k: fill(t) if isinstance(t, dict) else
                ((torch.randn(t.shape, generator=g, device="cuda") * 0.02).to(t.dtype)
                 if k in ZERO_INIT_LEAVES else t)
                for k, t in node.items()}
    return fill(tree)


def _ep_moe_case(torch, mesh, out):
    """deepseek-moe-16b (14 layers) under EP over the two ranks: one
    run_iteration against rank 0's single-rank one, the a2a branch's and
    the int8 wire's forwards against the local branch.  Returns the EP
    iteration's launch counts."""
    import copy
    import itertools

    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.data import HTaskLoader
    from repro_torch.distributed.sharding import ShardingRules, activate_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import local_tree, param_shardings
    from repro_torch.models import moe
    from repro_torch.models.quantize import tensor_bytes

    rank = mesh.rank
    cfg, tasks, plan = moe_ep_plan()
    rules = ShardingRules.replicated().with_updates(experts="model")
    gen = ModelGenerator(cfg, seed=0)
    full = init_backbone(torch, gen)
    specs = param_shardings(gen.model, mesh, rules)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    routed_layer = 3 * e * d * f * 2  # bf16 bytes of a layer's routed experts
    full_bytes = tensor_bytes(full)
    predicted = full_bytes - cfg.num_layers * routed_layer // MULTI_RANK_WORLD
    local = local_tree(full, specs, mesh)
    if rank != 0:  # rank 0 keeps the whole tree for the single-rank reference
        full = None
    gen.backbone_params = local
    reg = gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=TRAIN_LR)
    reg.adapter_params = _fill_adapters(torch, reg.adapter_params, 11)
    vocab = cfg.vocab_size
    fixed = {h: itertools.repeat(next(HTaskLoader(
        plan.tasks, plan.alignment[h], vocab,
        streams={i: _seeded_stream(151 + i, vocab) for i in range(len(plan.tasks))})))
        for h in range(len(plan.htasks))}
    snap = copy.deepcopy((reg.adapter_params, reg.opt_state, engine._slot_steps))
    torch.cuda.synchronize()
    memory = {"rank": rank, "predicted_local_bytes": predicted,
              "routed_experts_bytes_per_layer": routed_layer // MULTI_RANK_WORLD,
              "local_backbone_bytes": tensor_bytes(local),
              "full_backbone_bytes_held": full_bytes if full is not None else 0,
              "memory_allocated_before_run": torch.cuda.memory_allocated()}
    if tensor_bytes(local) != predicted:
        raise AssertionError(f"ep_moe: rank {rank} holds {tensor_bytes(local)} bytes, "
                             f"reckoned {predicted}")

    def iteration(backbone, ctx):
        (reg.adapter_params, reg.opt_state, engine._slot_steps) = copy.deepcopy(snap)
        engine.backbone = backbone
        with ctx():
            m = engine.run_iteration(fixed)
        return m, reg.opt_state.m

    ops.reset_launch_counts()
    with _Span(torch, mesh) as span:
        m_ep, g_ep = iteration(local, lambda: activate_rules(mesh, rules))
    counts = ops.launch_counts()
    line = {"phase": "multi_rank_ep_moe", "card": CARD, "rank": rank, "model": cfg.name,
            "layers": cfg.num_layers,
            "experts_held": int(local["layers"]["moe"]["w_gate"].shape[1]),
            "loss_ep": m_ep.loss, "per_task_loss_ep": m_ep.per_task_loss.tolist(),
            "launches": counts, "memory": memory, **_rank_stats(torch, span.ms)}
    # the a2a branch and the int8 wire, forward, on layer 0's experts
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = plan.htasks[0].rows
    x = torch.randn((rows, 256, d), generator=g, device="cuda").to(torch.bfloat16)
    cfg_a2a = cfg.with_overrides(capacity_factor=MOE_A2A_CF)
    p_loc = {k: v[0] for k, v in local["layers"]["moe"].items()}
    a2a = {}
    with torch.no_grad():
        for wire in ("f32", "int8"):
            over = {"moe_impl": "a2a", **({"moe_wire": "int8"} if wire == "int8" else {})}
            moe.a2a_drops = []
            try:
                with _Span(torch, mesh) as sp, activate_rules(mesh, rules.with_updates(**over)):
                    y, _ = moe.moe_apply(p_loc, x, cfg_a2a)
            finally:
                drops, moe.a2a_drops = moe.a2a_drops, None
            a2a[wire] = (y, drops, _rank_stats(torch, sp.ms))
    line["a2a"] = {w: {"drops": dr, **st} for w, (_, dr, st) in a2a.items()}
    failures = []
    if rank == 0:  # the single-rank references
        res, failures = _ep_moe_reference(torch, cfg, cfg_a2a, full, x, a2a, iteration, m_ep,
                                          g_ep, engine.model)
        line.update(res)
    if any(dd["send"] or dd["expert"] for _, dr, _ in a2a.values() for dd in dr):
        failures.append(f"the a2a branch dropped tokens at capacity factor {MOE_A2A_CF}")
    out.append(line)
    _raise_if(failures, "ep_moe")
    return counts


def _ep_moe_reference(torch, cfg, cfg_a2a, full, x, a2a, iteration, m_ep, g_ep, model):
    """Rank 0: the single-rank iteration (kernels; plain; plain_reordered)
    against the EP one, and the local branch against the a2a forwards, each
    gate max(base, 2 S) with S from a second right answer.  Returns the
    line's fields and the failed checks."""
    import contextlib

    from repro_torch.models import moe

    m_1, g_1 = iteration(full, contextlib.nullcontext)
    plain = plain_path(torch, model, remat=True)
    m_p, g_p = iteration(full, plain)
    m_r, g_r = iteration(full, lambda: _stacked(plain, plain_reordered))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(m_ep.per_task_loss, m_1.per_task_loss))
    grad_err, grad_leaf = _rel_leaf_max(torch, g_ep, g_1)
    spread, spread_leaf = _rel_leaf_max(torch, g_r, g_p)
    gate = max(EP_GRAD_BASE, 2 * spread)
    p0 = {k: v[0] for k, v in full["layers"]["moe"].items()}
    with torch.no_grad():
        flat = x.reshape(-1, cfg.d_model)
        ids, gates, _ = moe._route(flat, p0["router"], cfg.top_k)
        cap = moe._capacity(flat.shape[0], cfg.top_k, cfg.num_experts, cfg_a2a.capacity_factor)
        local_drops = moe.dropped_tokens(ids, cfg.num_experts, cap)
        y_local, _ = moe.moe_apply(p0, x, cfg_a2a)
        xf = flat.float()
        absmax = xf.abs().amax(dim=-1, keepdim=True) / 127.0
        xq = (torch.clamp(torch.round(xf / torch.clamp(absmax, min=1e-12)), -127, 127)
              * absmax).to(x.dtype)
        y_round = moe._expert_core(xq, p0, ids, gates, cap).reshape(x.shape)
        # the second right answers: the local branch in f32 (the same routing),
        # on x and on the round-tripped tokens; the bf16 local branch's distance
        # from them is the forward gates' spread
        p32 = {k: v.float() for k, v in p0.items()}
        y32 = moe._expert_core(xf, p32, ids, gates, cap).reshape(x.shape)
        y32_round = moe._expert_core(xq.float(), p32, ids, gates, cap).reshape(x.shape)
    spread_fwd = _err(y_local, y32)[1]
    spread_round = _err(y_round, y32_round)[1]
    err_a2a, err_int8 = _err(a2a["f32"][0], y_local), _err(a2a["int8"][0], y_round)
    gate_a2a, gate_int8 = max(KERNEL_TOL, 2 * spread_fwd), max(KERNEL_TOL, 2 * spread_round)
    res = {"loss_single": m_1.loss, "per_task_loss_single": m_1.per_task_loss.tolist(),
           "loss_max_rel_err": loss_rel, "loss_tol_rel": LOSS_TOL,
           "grad_err_rel_to_leaf_max": {"max": grad_err, "leaf": grad_leaf},
           "grad_spread_plain_reordered_vs_plain": {"max": spread, "leaf": spread_leaf},
           "grad_gate": gate, "grad_gate_base": EP_GRAD_BASE,
           "local_branch_drops": local_drops, "capacity_factor": MOE_A2A_CF,
           "a2a_vs_local": err_a2a, "a2a_gate": gate_a2a, "local_vs_f32_spread": spread_fwd,
           "int8_wire_vs_round_trip": err_int8, "int8_gate": gate_int8,
           "round_trip_vs_f32_spread": spread_round,
           "int8_wire_vs_f32_wire_rel": _err(a2a["int8"][0], a2a["f32"][0])[1],
           "gate_base": KERNEL_TOL}
    failures = []
    if local_drops:
        failures.append(f"the local branch dropped {local_drops} assignments")
    if not loss_rel <= LOSS_TOL:
        failures.append(f"per-task losses {m_ep.per_task_loss} vs single rank "
                        f"{m_1.per_task_loss}: relative {loss_rel} > {LOSS_TOL}")
    if not grad_err <= gate:
        failures.append(f"gradient {grad_leaf} off by {grad_err} of its max > {gate}")
    if not err_a2a[1] <= gate_a2a:
        failures.append(f"a2a vs local {err_a2a} > {gate_a2a}")
    if not err_int8[1] <= gate_int8:
        failures.append(f"int8 wire vs the round trip {err_int8} > {gate_int8}")
    return res, failures


def _cp_case(torch, mesh, out):
    """llama3.2-3b's attention, B 2 x S 8192, striped over the two ranks
    (plain PyTorch, no kernel), against the packed-attention kernel on the
    unstriped sequence on rank 0; a second plain path (block 512) sets the
    gate's spread."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models.cp_attention import stripe_permutation, striped_cp_attention

    cfg = get_config("llama3.2-3b")
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    P_sz, r = mesh.shape["model"], mesh.coord("model")
    blk = max(min(cfg.attn_q_block, 256, CP_S // (4 * P_sz)), 16)  # attention's rule
    g = torch.Generator(device="cuda").manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(CP_B, CP_S, H, dh), rnd(CP_B, CP_S, Hkv, dh), rnd(CP_B, CP_S, Hkv, dh), \
        rnd(CP_B, CP_S, H, dh)
    idx = torch.arange(CP_S, device="cuda")
    cuts = torch.tensor([[3000], [5000]], device="cuda")  # two segments a row
    seg = (idx[None] >= cuts).to(torch.int32)
    pos = (idx[None] - torch.where(seg > 0, cuts, 0)).to(torch.int32)
    S_l = CP_S // P_sz

    def run(block):
        perm = torch.from_numpy(stripe_permutation(CP_S, block, P_sz)).to("cuda")
        mine = perm[r * S_l:(r + 1) * S_l]
        ql, kl, vl = (t[:, mine].detach().requires_grad_(True) for t in (q, k, v))
        with _Span(torch, mesh) as span:
            o = striped_cp_attention(ql, kl, vl, pos[:, mine], seg[:, mine], mesh, "model",
                                     block)
            o.backward(do[:, mine])
        stats = _rank_stats(torch, span.ms)
        inv = torch.argsort(perm)
        whole = [C.all_gather_nograd(t.contiguous(), "model", mesh, 1)[:, inv]
                 for t in (o, ql.grad, kl.grad, vl.grad)]
        return whole, stats

    ours, stats = run(blk)
    second, stats2 = run(CP_SECOND_BLOCK)
    failures = []
    line = {"phase": "multi_rank_cp_attention", "card": CARD, "rank": r,
            "shape": {"B": CP_B, "S": CP_S, "H": H, "Hkv": Hkv, "dh": dh},
            "block": blk, "second_block": CP_SECOND_BLOCK, **stats,
            "second_path": stats2}
    if r == 0:
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_ref = ops.packed_attention(qr, kr, vr, segment_ids=seg, positions=pos,
                                     block_q=cfg.attn_q_block)
        o_ref.backward(do)
        names = ("o", "dq", "dk", "dv")
        base = {"o": KERNEL_TOL, "dq": GRAD_TOL["packed_attention_dq"],
                "dk": GRAD_TOL["packed_attention_dkv"], "dv": GRAD_TOL["packed_attention_dkv"]}
        refs = (o_ref, qr.grad, kr.grad, vr.grad)
        res = {}
        for name, a, b, ref in zip(names, ours, second, refs):
            spread = _err(a, b)[1]
            gate = max(base[name], 2 * spread)
            err, rel = _err(a, ref)
            res[name] = {"max_abs_err": err, "rel": rel, "gate": gate, "base": base[name],
                         "spread_second_block": spread}
            if not rel <= gate:
                failures.append(f"{name} vs the packed-attention kernel {rel} > {gate}")
        line["vs_packed_attention_kernel"] = res
    out.append(line)
    _raise_if(failures, "cp_attention")


def _pipeline_case(torch, mesh, gen, out):
    """llama3.2-3b as 2 stages of 14 layers over the two ranks (the packed
    attention kernels inside), 4 micro-batches of [2, 256, 3072]: the
    outputs and the micro-batches' gradient against pipeline_reference on
    rank 0.  Returns the pipeline's launch counts."""
    from repro_torch.distributed.pipeline import pipeline_ranks, pipeline_reference
    from repro_torch.distributed.sharding import local_block
    from repro_torch.kernels import ops

    model, cfg = gen.model, gen.cfg
    per = cfg.num_layers // PIPE_STAGES
    stacked = tree_map(lambda a: a.view(PIPE_STAGES, per, *a.shape[1:]),
                       gen.backbone_params["layers"])
    mine = tree_map(lambda a: local_block(a, ("stage",) + (None,) * (a.ndim - 1), mesh),
                    stacked)

    def stage_fn(p, x):
        for i in range(per):
            x, _ = model._block(tree_map(lambda a: a[i], p), x, positions=None,
                                segment_ids=None, collect_kv=False)
        return x

    g = torch.Generator(device="cuda").manual_seed(37)
    shape = (PIPE_MICRO,) + PIPE_MB + (cfg.d_model,)
    micro = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    dout = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    mb = micro.clone().requires_grad_(True)
    ops.reset_launch_counts()
    with _Span(torch, mesh) as span:
        outs = pipeline_ranks(stage_fn, mine, mb, mesh, "stage")
        outs.backward(dout)
    counts = ops.launch_counts()
    line = {"phase": "multi_rank_pipeline", "card": CARD, "rank": mesh.rank,
            "stages": PIPE_STAGES, "layers_per_stage": per, "micro_batches": PIPE_MICRO,
            "micro_batch": list(PIPE_MB) + [cfg.d_model], "launches": counts,
            **_rank_stats(torch, span.ms)}
    failures = []
    if mesh.rank == 0:
        mr = micro.clone().requires_grad_(True)
        ref = pipeline_reference(stage_fn, stacked, mr, PIPE_STAGES)
        ref.backward(dout)
        line["outputs_vs_reference"] = _err(outs, ref)
        line["grad_vs_reference"] = _err(mb.grad, mr.grad)
        line["same_bits"] = bool(torch.equal(outs, ref) and torch.equal(mb.grad, mr.grad))
        line["tol_rel"] = KERNEL_TOL
        failures = [f"{k} {line[k]} > {KERNEL_TOL}" for k in ("outputs_vs_reference",
                                                             "grad_vs_reference")
                    if not line[k][1] <= KERNEL_TOL]
    out.append(line)
    _raise_if(failures, "pipeline")
    return counts


def _psum_tree_case(torch, mesh, engine, out):
    """The train path's LoRA adapter gradients (each rank its own seeded
    batch), summed over the two ranks by psum_tree with and without
    ``compress``; the compressed sum against the int8 formula on both
    ranks' gradients.  Returns the gradient step's launch counts."""
    from repro_torch.data import HTaskLoader
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import device_put_batch

    r, vocab = mesh.rank, engine.model.cfg.vocab_size
    plan = engine.plan
    params = _fill_adapters(torch, engine.reg.adapter_params, 13)
    batch = device_put_batch(next(HTaskLoader(
        plan.tasks, plan.alignment[0], vocab,
        streams={i: _seeded_stream(300 + 10 * r + i, vocab) for i in range(len(plan.tasks))})),
        engine.device)
    ops.reset_launch_counts()
    _, _, grads = engine._loss_and_grads_fn(0)(params, engine.backbone, batch)
    counts = ops.launch_counts()
    lora = grads["lora"]
    with _Span(torch, mesh) as exact_span:
        exact = C.psum_tree(lora, "model", mesh=mesh)
    exact_stats = _rank_stats(torch, exact_span.ms)
    with _Span(torch, mesh) as comp_span:
        comp = C.psum_tree(lora, "model", compress=True, mesh=mesh)
    comp_stats = _rank_stats(torch, comp_span.ms)
    paths = _leaf_paths(lora)
    flat = torch.cat([_leaf(lora, p).reshape(-1).float() for p in sorted(paths)])
    both = C.all_gather_nograd(flat[None], "model", mesh, 0)
    qs = [C.quantize_int8(both[i]) for i in range(both.shape[0])]
    formula = (sum(q.to(torch.int32) for q, _ in qs).float()
               * (sum(s for _, s in qs) / both.shape[0])).reshape(-1)[:flat.shape[0]]
    # the formula in each leaf's type (psum_tree casts the f32 sum back)
    formula = torch.cat([part.to(_leaf(lora, p).dtype).float() for p, part in zip(
        sorted(paths), formula.split([_leaf(lora, p).numel() for p in sorted(paths)]))])
    got = torch.cat([_leaf(comp, p).reshape(-1).float() for p in sorted(paths)])
    want = torch.cat([_leaf(exact, p).reshape(-1).float() for p in sorted(paths)])
    formula_err = (got - formula).abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    line = {"phase": "multi_rank_psum_tree", "card": CARD, "rank": r, "leaves": len(paths),
            "elements": int(flat.shape[0]),
            "compression_error": C.compression_error(flat).item(),
            "compressed_vs_exact_sum_rel_l2": rel_l2,
            "compressed_vs_formula_max_abs": formula_err,
            "exact": exact_stats, "compressed": comp_stats}
    out.append(line)
    _raise_if([f"the compressed sum is {formula_err} off the int8 formula"]
              if formula_err != 0.0 else [], "psum_tree")
    return counts


def _multi_rank_worker(rank, world, card_info, lines_dir):
    """One rank of the multi_rank phase: its lines (into
    ``lines_dir/rank<r>.jsonl`` as they come) and its launch counts."""
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_mesh

    CARD.update(card_info)
    _build.build_all()  # the calling process built them: this loads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(backend="gloo", timeout_s=MULTI_RANK_TIMEOUT_S)
    mesh = make_mesh((world,), ("model",), **kw)
    stage = make_mesh((world,), ("stage",), **kw)
    out = _Lines(os.path.join(lines_dir, f"rank{rank}.jsonl"))
    out.append(gloo_probe(torch, mesh))
    counts = dict.fromkeys(ops.launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    add(_ep_moe_case(torch, mesh, out))
    gc.collect()
    torch.cuda.empty_cache()
    _cp_case(torch, mesh, out)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.core import ModelGenerator, PEFTEngine

    cfg, tasks, plan = train_plan()
    gen = ModelGenerator(cfg, seed=0)
    init_backbone(torch, gen)
    gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=TRAIN_LR)
    add(_pipeline_case(torch, stage, gen, out))
    add(_psum_tree_case(torch, mesh, engine, out))
    return counts


def multi_rank_phase(torch):
    """The multi_rank path: ``MULTI_RANK_WORLD`` processes on cuda:0 joined
    by gloo through a FileStore in a temporary directory (every collective
    bounded by ``MULTI_RANK_TIMEOUT_S``; the world joined with a timeout,
    killed on expiry: a rank that fails or hangs fails the phase).  Prints
    each rank's lines (rank order) and returns the launch counts of the
    multi-rank runs summed over the ranks (the single-rank references
    excluded)."""
    from repro_torch.launch.mesh import run_world

    card()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            results = run_world(_multi_rank_worker, MULTI_RANK_WORLD,
                                os.path.join(tmp, "store"), args=(dict(CARD), tmp),
                                backend="gloo", timeout_s=MULTI_RANK_TIMEOUT_S)
        finally:  # each rank's lines, in rank order, also when the world failed
            for r in range(MULTI_RANK_WORLD):
                path = os.path.join(tmp, f"rank{r}.jsonl")
                if os.path.exists(path):
                    with open(path) as f:
                        for line in f:
                            print(line, end="", flush=True)
    counts = {}
    for res in results:
        for k, v in res.items():
            counts[k] = counts.get(k, 0) + v
    for name in ("grouped_lora", "grouped_lora_bwd", "packed_attention", "packed_attention_dq",
                 "packed_attention_dkv"):
        if not counts.get(name):
            raise AssertionError(f"multi_rank: {name} was not launched ({counts})")
    return counts


# The main paths in the order they run.  The first two groups run at once,
# each in its own process on the one card: both are host-bound (the card
# is 5-45% busy on them), they hold at most 43 and 17 GB, and on a slow host
# the script would pass its time limit run one after the other.  The
# whisper paths (3.1 GB of weights, host-bound decode) join them, and
# serve_xlstm (17.2 GB at its peak at full depth, host-bound decode: 19% busy) joins the
# second, which ended first without it (395 s against 413); serve_xlstm_int8
# (host-bound decode too) joins the first, whose paths took 315 s against the
# second's 352 without it (NVIDIA H100 80GB HBM3, 700 W).  The last
# group needs the card to itself (deepseek-moe-16b's 60 GB of training,
# yi-34b's 79 GB, qwen2-vl-7b's 15.2 GB backbone beside its training
# activations, xlstm-1.3b's 16.5 GB of saved mLSTM states beside 60 GB of
# training, on bf16 and on int8), and runs alone after them.
PATHS_BESIDE = (
    ("serve", "serve_int8", "train", "train_methods", "train_int8", "train_zamba",
     "train_zamba_int8", "train_whisper", "serve_xlstm_int8"),
    ("serve_methods", "coserve", "fleet", "fleet_int8", "serve_zamba", "serve_zamba_int8",
     "serve_whisper", "serve_xlstm"))
# and last the multi_rank phase, alone: its two ranks share the card
PATHS_LAST = ("multi_rank",)
PATHS_ALONE = ("train_moe", "serve_moe", "serve_moe_int8", "train_starcoder2",
               "serve_starcoder2", "serve_yi", "train_qwen2vl", "serve_qwen2vl", "train_xlstm",
               "train_xlstm_int8")


def _timed(torch, laps, name, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds into ``laps[name]``; then the
    cycle an engine's step closures make is collected, so that the next
    phase's memory peak holds its own backbone only."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    laps[name] = time.perf_counter() - t
    return out


def run_paths(torch, names, counts, laps, carry=None):
    """The main paths ``names`` in order, each with the launch counts set to
    0 just before it: its counts into ``counts``, its seconds into
    ``laps``.  ``carry`` holds what a later path takes from an earlier one
    (serve's tokens for serve_int8, serve_methods' gate for coserve and the
    fleet), so a path runs after the one it takes from."""
    carry = {} if carry is None else carry

    def train(name, plan, phase=train_phase, seeds=(3,), methods=False, check=None):
        def run():
            counts[name], engine = phase(torch, *plan)
            for seed in seeds:
                if check is None:
                    train_check(torch, engine, seed, methods=methods)
                else:
                    check(torch, engine, seed)
        _timed(torch, laps, name, run)

    def serve(name, fn, *args, **kw):
        counts[name] = _timed(torch, laps, name, fn, torch, *args, **kw)

    def llama_serve(int8=False):
        if int8:
            counts["serve_int8"], _ = _timed(torch, laps, "serve_int8", serve_phase, torch,
                                             "int8", carry["serve"])
        else:
            counts["serve"], carry["serve"] = _timed(torch, laps, "serve", serve_phase, torch)

    def serve_methods():
        counts["serve_methods"], carry["gate"] = _timed(torch, laps, "serve_methods",
                                                        serve_methods_phase, torch)

    table = {
        # llama3.2-3b serving and training on bf16 and int8 backbones, the
        # eight kinds under the supervisor; zamba2-2.7b training (bf16, int8)
        "serve": llama_serve,
        "serve_int8": lambda: llama_serve(int8=True),
        "train": lambda: train("train", train_plan()),
        "train_methods": lambda: train("train_methods", methods_plan(), methods_train_phase,
                                       methods=True),
        "train_int8": lambda: train("train_int8", train_plan("int8"), seeds=INT8_CHECK_SEEDS),
        "train_zamba": lambda: train("train_zamba", zamba_plan()),
        "train_zamba_int8": lambda: train("train_zamba_int8", zamba_plan("int8")),
        # the co-serving paths: the pool with one tenant of each PEFT kind,
        # the service under tenant churn; the fleet tier (bf16, bf16 + int8)
        "serve_methods": serve_methods,
        "coserve": lambda: serve("coserve", coserve_phase, carry["gate"]),
        "fleet": lambda: serve("fleet", fleet_phase, carry["gate"]),
        "fleet_int8": lambda: serve("fleet_int8", fleet_int8_phase),
        # zamba2 decode (bf16, int8)
        "serve_zamba": lambda: serve("serve_zamba", serve_zamba_phase),
        "serve_zamba_int8": lambda: serve("serve_zamba_int8", serve_zamba_phase, "int8"),
        # the MoE family: deepseek-moe-16b training and serving (bf16, int8)
        "train_moe": lambda: train("train_moe", moe_plan(), train_moe_phase),
        "serve_moe": lambda: serve("serve_moe", serve_pool_phase, MOE_ARCH, MOE_SITES,
                                   layers=MOE_SERVE_LAYERS),
        "serve_moe_int8": lambda: serve("serve_moe_int8", serve_pool_phase, MOE_ARCH,
                                        MOE_SITES, backbone_dtype="int8",
                                        layers=MOE_SERVE_LAYERS),
        # starcoder2-7b training and serving, yi-34b serving
        "train_starcoder2": lambda: train("train_starcoder2", starcoder2_plan()),
        "serve_starcoder2": lambda: serve("serve_starcoder2", serve_pool_phase,
                                          STARCODER2_ARCH, STARCODER2_SITES,
                                          layers=STARCODER2_SERVE_LAYERS),
        "serve_yi": lambda: serve("serve_yi", serve_pool_phase, YI_ARCH, SITES, (64, 256), 16,
                                  256, YI_TENANTS),
        # the vlm family (qwen2-vl-7b) and the audio family (whisper-large-v3)
        "train_qwen2vl": lambda: train("train_qwen2vl", qwen2vl_plan()),
        "serve_qwen2vl": lambda: serve("serve_qwen2vl", serve_pool_phase, QWEN2VL_ARCH, SITES,
                                       layers=QWEN2VL_SERVE_LAYERS),
        "train_whisper": lambda: train("train_whisper", (), train_whisper_phase),
        "serve_whisper": lambda: serve("serve_whisper", serve_whisper_phase),
        # the ssm family (xlstm-1.3b): decode, and the forward on the tiled scan;
        # training on the tiled scan's three kernels; both on an int8 backbone
        "serve_xlstm": lambda: serve("serve_xlstm", serve_xlstm_phase),
        "train_xlstm": lambda: train("train_xlstm", xlstm_plan(), check=train_check_xlstm),
        "serve_xlstm_int8": lambda: serve("serve_xlstm_int8", serve_xlstm_phase, "int8"),
        "train_xlstm_int8": lambda: train("train_xlstm_int8", xlstm_plan("int8"),
                                          check=train_check_xlstm),
        # the multi-device tier: two ranks on the card, joined by gloo
        "multi_rank": lambda: serve("multi_rank", multi_rank_phase),
    }
    for name in names:
        table[name]()


def _setup(torch) -> None:
    """Build (or load) the kernels; keep the plain versions' f32 matmuls in
    full f32 (no TF32): they are the reference here."""
    from repro_torch.kernels import _build

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worker_main(names) -> int:
    """``chip_smoke.py --paths a,b,...``: the main paths ``names`` in this
    process (the kernels already built by the calling one), their lines,
    then last one line of their launch counts and seconds."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    _setup(torch)
    counts, laps = {}, {}
    run_paths(torch, names, counts, laps)
    emit({"phase": "worker", "counts": counts, "laps": laps})
    return 0


def run_beside(torch, names, counts, laps, worker_names) -> None:
    """The main paths ``names`` here while a second process runs
    ``worker_names`` on the same card; its lines are printed after it ends,
    its counts and seconds merged into ``counts`` and ``laps``.  A failure
    on either side raises (the worker is stopped if this side fails)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "worker.jsonl")
        with open(out_path, "w") as out:
            worker = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--paths",
                                       ",".join(worker_names)], stdout=out)
        try:
            run_paths(torch, names, counts, laps)
        except BaseException:
            worker.kill()
            raise
        finally:
            rc = worker.wait()
        with open(out_path) as f:
            lines = f.read().splitlines()
    for line in lines:
        print(line, flush=True)
    if rc != 0:
        raise RuntimeError(f"chip_smoke: the worker process ({', '.join(worker_names)}) "
                           f"exited {rc}")
    last = json.loads(lines[-1])
    counts.update(last["counts"])
    laps.update({f"{k} (beside)": v for k, v in last["laps"].items()})


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--paths":
        return worker_main(sys.argv[2].split(","))
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = card()
    emit({"phase": "device", "nvidia_smi": f"{smi['name']}, {smi['power_limit']}",
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    emit({"phase": "build", "seconds": _build.build_all(),
          "sources": [p.name for p in _build.sources()]})
    emit({"phase": "ptxas", "kernels": _build.ptxas_report()})
    sass_phase()
    _setup(torch)
    torch.cuda.synchronize()
    timer = Timer(torch)
    laps = {}  # seconds of the kernel cases and of each main path

    def kernel_cases():
        with torch.no_grad():
            kern = kernel_phase(torch, timer)
            kern.update(quant_kernel_phase(torch, timer))
            kern.update(bind_kernel_cases(torch, timer,
                                          torch.Generator(device="cuda").manual_seed(7))[0])
        kern.update(train_kernel_phase(torch, timer, *train_plan()))
        kern.update(methods_kernel_phase(torch, timer, *methods_plan()))
        zamba = zamba_plan()
        kern.update(zamba_kernel_phase(torch, timer, *zamba))
        kern.update(moe_kernel_phase(torch, timer, *moe_plan()))
        kern.update(zamba_serve_kernel_phase(torch, timer, zamba[0]))
        kern.update(starcoder2_kernel_phase(torch, timer, *starcoder2_plan()))
        kern.update(yi_kernel_phase(torch, timer))
        kern.update(qwen2vl_kernel_phase(torch, timer, *qwen2vl_plan()))
        kern.update(whisper_kernel_phase(torch, timer))
        kern.update(xlstm_kernel_phase(torch, timer))
        torch.cuda.synchronize()
        return kern

    # the kernel cases (timed: alone on the card), then the main paths
    kern = _timed(torch, laps, "kernel_cases", kernel_cases)
    counts = {}
    t = time.perf_counter()
    run_beside(torch, PATHS_BESIDE[0], counts, laps, PATHS_BESIDE[1])
    laps["paths_beside"] = time.perf_counter() - t
    run_paths(torch, PATHS_ALONE + PATHS_LAST, counts, laps)
    emit({"phase": "seconds", "card": card(), "laps": laps,
          "total": time.perf_counter() - t_start, "predicted_total": PREDICTED_TOTAL_S,
          "budget": TIME_BUDGET_S})

    # (name, source, Pallas kernel body, the entry's own measurement, variants)
    csrc, jax_k = "src/repro_torch/csrc/", "src/repro/kernels/"
    kernels = [
        ("grouped_lora", "grouped_lora.cu", "grouped_lora.py:49", "grouped_lora",
         {"train_variant": "grouped_lora_train", "zamba2_variant": "grouped_lora_train_zamba2",
          "methods_variant": "grouped_lora_train_methods_lora",
          "methods_dora_variant": "grouped_lora_train_methods_dora",
          "moe_variant": "grouped_lora_moe", "moe_train_variant": "grouped_lora_train_moe",
          "starcoder2_variant": "grouped_lora_starcoder2",
          "starcoder2_train_variant": "grouped_lora_train_starcoder2",
          "yi_variant": "grouped_lora_yi", "qwen2vl_variant": "grouped_lora_qwen2vl",
          "qwen2vl_train_variant": "grouped_lora_train_qwen2vl",
          "whisper_variant": "grouped_lora_whisper",
          "whisper_train_variant": "grouped_lora_train_whisper",
          "xlstm_variant": "grouped_lora_xlstm"}),
        ("grouped_lora_bwd", "grouped_lora.cu", "grouped_lora.py:91", "grouped_lora_bwd",
         {"zamba2_variant": "grouped_lora_bwd_zamba2",
          "methods_variant": "grouped_lora_bwd_methods_lora",
          "methods_dora_variant": "grouped_lora_bwd_methods_dora",
          "moe_variant": "grouped_lora_bwd_moe",
          "moe_decode_variant": "grouped_lora_bwd_moe_decode",
          "starcoder2_variant": "grouped_lora_bwd_starcoder2",
          "starcoder2_decode_variant": "grouped_lora_bwd_starcoder2_decode",
          "yi_decode_variant": "grouped_lora_bwd_yi_decode",
          "qwen2vl_variant": "grouped_lora_bwd_qwen2vl",
          "qwen2vl_decode_variant": "grouped_lora_bwd_qwen2vl_decode",
          "whisper_variant": "grouped_lora_bwd_whisper",
          "whisper_decode_variant": "grouped_lora_bwd_whisper_decode",
          "xlstm_decode_variant": "grouped_lora_bwd_xlstm_decode"}),
        ("packed_attention", "packed_attention.cu", "packed_attention.py:60", "packed_attention",
         {"train_variant": "packed_attention_train",
          "zamba2_variant": "packed_attention_train_zamba2",
          "prefix_variant": "packed_attention_train_prefix",
          "bind_prefix_128_variant": "packed_attention_bind_prefix_128",
          "bind_prefix_512_variant": "packed_attention_bind_prefix_512",
          "moe_variant": "packed_attention_train_moe",
          "starcoder2_variant": "packed_attention_train_starcoder2",
          "qwen2vl_variant": "packed_attention_train_qwen2vl",
          "qwen2vl_prefill_variant": "packed_attention_prefill_qwen2vl",
          "whisper_encoder_variant": "packed_attention_encoder_whisper",
          "whisper_variant": "packed_attention_train_whisper",
          "whisper_cross_variant": "packed_attention_cross_whisper"}),
        ("packed_attention_dq", "packed_attention.cu", "packed_attention.py:128",
         "packed_attention_dq", {"zamba2_variant": "packed_attention_dq_zamba2",
                                 "prefix_variant": "packed_attention_dq_prefix",
                                 "moe_variant": "packed_attention_dq_moe",
                                 "starcoder2_variant": "packed_attention_dq_starcoder2",
                                 "qwen2vl_variant": "packed_attention_dq_qwen2vl",
                                 "whisper_variant": "packed_attention_dq_whisper",
                                 "whisper_cross_variant": "packed_attention_dq_cross_whisper"}),
        ("packed_attention_dkv", "packed_attention.cu", "packed_attention.py:185",
         "packed_attention_dkv", {"zamba2_variant": "packed_attention_dkv_zamba2",
                                  "prefix_variant": "packed_attention_dkv_prefix",
                                  "moe_variant": "packed_attention_dkv_moe",
                                  "starcoder2_variant": "packed_attention_dkv_starcoder2",
                                  "qwen2vl_variant": "packed_attention_dkv_qwen2vl",
                                  "whisper_variant": "packed_attention_dkv_whisper",
                                  "whisper_cross_variant":
                                      "packed_attention_dkv_cross_whisper"}),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:40",
         "decode_attention", {"pool_variant": "decode_attention_pool",
                              "moe_variant": "decode_attention_moe",
                              "zamba2_variant": "decode_attention_zamba2",
                              "starcoder2_variant": "decode_attention_starcoder2",
                              "yi_variant": "decode_attention_yi",
                              "qwen2vl_variant": "decode_attention_qwen2vl",
                              "whisper_variant": "decode_attention_whisper",
                              "whisper_cross_variant": "decode_attention_cross_whisper"}),
        ("quant_matmul", "quant_matmul.cu", "quant_matmul.py:36", "quant_matmul",
         {"moe_variant": "quant_matmul_moe", "zamba2_variant": "quant_matmul_zamba2",
          "xlstm_variant": "quant_matmul_xlstm"}),
        ("mamba_scan", "mamba_scan.cu", "mamba_scan.py:76", "mamba_scan_zamba2", {}),
        # the forward at xlstm's (1024, 1025) state, tiled 64 x 64 (row 8's variant)
        ("mamba_scan_tiled", "mamba_scan.cu", "mamba_scan.py:76", "mamba_scan_tiled_xlstm", {}),
        ("mamba_scan_bwd_state", "mamba_scan.cu", "mamba_scan.py:136",
         "mamba_scan_bwd_state_zamba2", {}),
        ("mamba_scan_bwd_chunk", "mamba_scan.cu", "mamba_scan.py:175",
         "mamba_scan_bwd_chunk_zamba2", {}),
        # the backward at xlstm's (1024, 1025) state, tiled 64 x 64 (rows 9-10's variants)
        ("mamba_scan_bwd_state_tiled", "mamba_scan.cu", "mamba_scan.py:136",
         "mamba_scan_bwd_state_tiled_xlstm", {}),
        ("mamba_scan_bwd_chunk_tiled", "mamba_scan.cu", "mamba_scan.py:175",
         "mamba_scan_bwd_chunk_tiled_xlstm", {}),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src, "replaces": jax_k + rep,
         "launches": sum(c[name] for c in counts.values()),
         "launches_by_path": {path: c[name] for path, c in counts.items()},
         **kern[own], **{k: kern[v] for k, v in variants.items()}}
        for name, src, rep, own, variants in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
