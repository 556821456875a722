#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and check them:
multi-tenant LoRA co-serving decode and multi-task LoRA/Adapter/IA3
fine-tuning on llama3.2-3b (each on a bf16 and on an int8 backbone), and
multi-task fine-tuning on the hybrid zamba2-2.7b (Mamba2 + shared attention).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each (several for the kernel phases):

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
                    for the same bits;
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
10. train_methods, train_check_methods -- llama3.2-3b (bf16) with one
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

Then a {"kernels": [...]} line and last {"ok": true, "device": {...}}.  Any
failure raises: the script exits non-zero and prints no ok line.  Without a
CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:8,sst2:ia3"
# the hybrid tenants' sites: the Mamba2 projections and the shared block's q, v
ZAMBA_TARGETS = ("ssm_in", "ssm_out", "attn_q", "attn_v")
# one tenant of each PEFT kind on the attention sites (the train_methods path)
METHODS_TASKS = ("sst2:lora:8,qa:adapter:8,rte:ia3,sst2:prefix:16,qa:diff:16,rte:dora:8,"
                 "sst2:vera:64,qa:bitfit")
# the supervised loop: steps, checkpoint cadence, the step a failure precedes
METHODS_STEPS, METHODS_CKPT_EVERY, METHODS_FAIL_AT = 5, 2, 3
# the kinds whose adapter delta runs through the grouped-LoRA kernel
GROUPED_LORA_KINDS = ("lora", "dora")
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
# each bf16 path sits further from the f32 run than on llama: 13.3-15.4% of
# a leaf's largest |g| in two runs on an H100, and kernel vs plain came
# 6.3% and 8.7% apart (the adapters' state before the check follows each
# run's synthetic batches).  GRAD_PATH_TOL lies inside that noise; 20%
# bounds the sum of two such spreads and stays far below a fault; the f32
# guard holds the kernel path to the plain path's accuracy.
ZAMBA_GRAD_PATH_TOL = 0.20
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
    "other"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
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
    return {"calls": n, "wall_ms_per_call": wall_ms,
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


def kernel_device_ms(torch, timer, fn, key: str, n: int = 5):
    """Device time per call of the kernels whose names hold ``key``, from
    the profiler, L2 flushed before each call.  Where a kernel takes less
    time than the host needs to launch it, the CUDA-event time of a call
    (``Timer``) counts the device's wait for the launch; this does not.  The
    profiler now and then reports no kernel at all: up to three tries, else
    None."""
    for _ in range(3):
        us = sum(t for name, t in _profile_kernels(
            torch, lambda: (timer.flush.zero_(), fn()), n).items() if key in name)
        if us > 0:
            return us / 1e3 / n
    return None


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


def decode_kernel_case(torch, timer, g, H, Hkv, dh):
    """Decode attention against its plain version: 8 rows over a 1024-row
    cache with mixed windows (the serving path's shape), timed beside SDPA
    over the whole cache under the window mask; then the edge cases."""
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
    emit({"phase": "kernels", "kernel": "decode_attention", "B": Bd, "Smax": Smax, "H": H,
          "Hkv": Hkv, "dh": dh, "window_rows": window, "max_abs_err": err,
          "max_rel_err": rel, "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
          "library_device_ms": lib_dev_ms})
    return {
        "shape": f"B={Bd}, Smax={Smax}, H={H}, Hkv={Hkv}, dh={dh}, {window} window rows",
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
        "max_abs_err": max(err, _decode_edge_cases(torch, g, H, Hkv, dh))}


def _decode_edge_cases(torch, g, H, Hkv, dh):
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
        emit({"phase": "kernels", "kernel": "decode_attention", "case": case, "B": Bd,
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
               ("mamba_scan", "mamba_scan_bwd_chunk_kernel", "HMMA"))


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


def quant_kernel_phase(torch, timer):
    """quant_matmul against its plain version at every (M, K, N) of the int8
    paths, and a ragged shape; the backward's dx product at the training
    shapes.  The yardstick is ``torch._weight_int8pack_mm`` where the card's
    PyTorch has it, else cuBLAS bf16 on the dequantized weight, which is
    timed beside it in any case (the bf16 backbone's product)."""
    from repro_torch.kernels import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(4)
    dev, bf16 = "cuda", torch.bfloat16
    library = None
    per_shape = {}
    for path, M in QMM_M.items():
        for K, N in QMM_SHAPES + ((40, 72),) * (path == "decode"):
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
                    "max_abs_err": err, "max_rel_err": rel, "tol": tol}
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
        layer = [per_shape[(path, K, N)] for K, N in QMM_LAYER]
        total = {key: None if any(v[key] is None for v in layer) else sum(v[key] for v in layer)
                 for key in layer[0]}  # (a device time the profiler did not see is None)
        bms, by = bound_ms(total.pop("bytes"), total.pop("flops"))
        total["max_abs_err"] = max(v["max_abs_err"] for (p, _, _), v in per_shape.items()
                                   if p == path)
        results[path] = {
            "shape": f"M={QMM_M[path]}: the seven BaseOp products of one layer (sum)",
            **total, "bound_ms": bms, "bound_by": by, "library": library}
    out = results["decode"]
    out["max_abs_err"] = max(out["max_abs_err"], ragged_err, _quant_edge_cases(torch, g))
    out["prefill_variant"], out["train_variant"] = results["prefill"], results["train"]
    return {"quant_matmul": out}


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
    """The train_methods path: llama3.2-3b (bf16) at full width and depth,
    one tenant of each PEFT kind (``METHODS_TASKS``), and their plan."""
    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config("llama3.2-3b")
    tasks = parse_tasks(METHODS_TASKS, TRAIN_MICRO_BATCH)
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def zamba_plan():
    """The hybrid training path's configuration (zamba2-2.7b at full width
    and depth), the same tenants on the Mamba2 projections and the shared
    block's q / v, and their plan."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlanner, ParallelismSpec
    from repro_torch.launch.train import parse_tasks

    cfg = get_config("zamba2-2.7b")
    tasks = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=ZAMBA_TARGETS))
             for t in parse_tasks(TRAIN_TASKS, TRAIN_MICRO_BATCH)]
    plan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1)).plan(tasks, n_micro=1)
    return cfg, tasks, plan


def step_launches(cfg, adapters):
    """Kernel launches of one training micro step, forward and backward,
    from the model's layout and the grouped-LoRA sites (LoRA's and DoRA's)
    of the adapter tree."""
    def sites(tree):
        return sum(len(tree.get(kind, {})) for kind in GROUPED_LORA_KINDS)

    if cfg.family == "dense":
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
    an unmasked one.  Tolerances: y and dq/dk/dv (bf16) within KERNEL_TOL of
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
    cases = {"path": (B, S, Q, _scan_case(torch, g, B, S, H, 0, True,
                                          (reset > 0).to(torch.int32))),
             "carry": (2, 1024, 256, _scan_case(torch, g, 2, 1024, H, 0.004, False)),
             "unmasked": (2, 1024, 256, _scan_case(torch, g, 2, 1024, H, 0, False))}
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


def train_phase(torch, cfg, tasks, plan):
    """The training path: PEFTEngine.run_iteration on ``cfg`` (llama3.2-3b
    or zamba2-2.7b), its backbone stored as ``cfg.backbone_dtype``."""
    import numpy as np

    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.data import HTaskLoader
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import tensor_bytes

    int8 = cfg.backbone_dtype == "int8"
    suffix = "_int8" if int8 else ("_zamba" if cfg.family == "hybrid" else "")
    L = cfg.num_layers
    gen = ModelGenerator(cfg, seed=0)
    gen.init_backbone()
    reg = gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=TRAIN_LR)
    loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size)
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
        from repro_torch.peft.methods import base_op_dims
        want["quant_matmul"] = n * len(base_op_dims(cfg)) * L
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the plan implies {want}")
    secs = [m.wall_seconds for m, _ in iters]
    emit({"phase": "train" + suffix, "backbone_dtype": cfg.backbone_dtype, "model": cfg.name,
          "layers": L, "d_model": cfg.d_model, "backbone_bytes": tensor_bytes(engine.backbone),
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
    emit({"phase": "profile", "path": "train iteration" + suffix, **prof,
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
    on a bf16 one and plain_reordered() on llama's.  ``extra`` maps more
    runs' names to their contexts (train_check_spread.py's), each reported
    against the plain run.  ``methods`` marks the train_methods path (its
    gate, and each layer recomputed in the plain runs' backward).
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
    plan, vocab = engine.plan, engine.model.cfg.vocab_size
    loader = HTaskLoader(plan.tasks, plan.alignment[0], vocab,
                         streams={i: _seeded_stream(97 + seed + i, vocab)
                                  for i in range(len(plan.tasks))})
    batch = device_put_batch(next(loader), dev)
    fn = engine._loss_and_grads_fn(0)
    plain = plain_path(torch, engine.model, remat=methods)
    runs = {"kernel": (params, engine.backbone, contextlib.nullcontext),
            "plain": (params, engine.backbone, plain),
            "f32": (tree_map(lambda t: t.float() if t.is_floating_point() else t, params),
                    densify(torch, engine.backbone), plain)}
    int8 = engine.model.cfg.backbone_dtype == "int8"
    if int8:
        runs["plain_scale_first"] = (params, engine.backbone, plain_scale_first)
    else:
        runs["plain_stored_o"] = (params, engine.backbone, lambda: _stacked(plain, plain_stored_o))
    hybrid = engine.model.cfg.family == "hybrid"
    if not (int8 or hybrid):
        runs["plain_reordered"] = (params, engine.backbone,
                                   lambda: _stacked(plain, plain_reordered))
    rc = recompute(engine.model, methods)
    for name, ctx in (extra or {}).items():
        runs[name] = (params, engine.backbone, lambda ctx=ctx: _stacked(rc, ctx))
    # the compared leaves: floating and trainable (a path's first registered
    # method name is its kind)
    paths = [p for p in _leaf_paths(params) if _leaf(params, p).is_floating_point()
             and get_method(next(k for k in p if k in engine.reg.mta.kind_tasks)).trainable(p[-1])]
    pt, grads = {}, {}
    for mode, (ad, bb, ctx) in runs.items():
        with ctx():
            _, pt[mode], gr = fn(ad, bb, batch)
        grads[mode] = [_leaf(gr, p) for p in paths]
    torch.cuda.synchronize()
    loss_err = ((pt["kernel"] - pt["plain"]).abs() / pt["plain"].abs()).max().item()
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"train_check: per-task losses {pt['kernel'].tolist()} vs plain "
                             f"{pt['plain'].tolist()}: relative {loss_err} > {LOSS_TOL}")
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
    tol = INT8_GRAD_PATH_TOL if int8 else (ZAMBA_GRAD_PATH_TOL if hybrid else (
        METHODS_GRAD_PATH_TOL if methods else GRAD_PATH_TOL))
    suffix = "_int8" if int8 else ("_zamba" if hybrid else ("_methods" if methods else ""))
    emit({"phase": "train_check" + suffix, "seed": seed,
          "per_task_loss_kernel": pt["kernel"].tolist(),
          "per_task_loss_plain": pt["plain"].tolist(), "per_task_loss_f32": pt["f32"].tolist(),
          "loss_max_rel_err": loss_err, "loss_tol_rel": LOSS_TOL, "grad_leaves": len(names),
          "grad_err_rel_to_leaf_max": {k: {"max": v[0], "leaf": v[1]} for k, v in worst.items()},
          "grad_tol": tol})
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


def recompute(model, dense=False):
    """A context factory under which ``model`` recomputes each hybrid
    super-block in the backward (``torch.utils.checkpoint``,
    non-reentrant): the JAX config's ``remat=True`` (``jax.checkpoint`` of
    the super-block), which changes no value.  Without it autograd of the
    plain scan would keep several f32 [rows, Q, Q, heads] tensors for each
    of the 45 Mamba2 blocks, more than the card holds beside the f32
    backbone.  ``dense`` recomputes each dense layer likewise, under the
    adapter context it ran in: on the train_methods path (27 rows, eight
    kinds each adding f32 [rows, S, d_out] terms at its sites) one step
    holds about 60 GB without it.  The kernel path runs without
    recomputation, as training does."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.peft.hooks import active_context, adapter_scope

    def remat_block(block):
        def run(lp, x, **kw):
            scope = active_context()

            def layer(x):
                with adapter_scope(scope):
                    return block(lp, x, **kw)
            return checkpoint(layer, x, use_reentrant=False)
        return run

    @contextlib.contextmanager
    def ctx():
        if model.cfg.family == "hybrid":
            name, fn = "_super_block", model._super_block
            wrapped = lambda x, *a, **kw: checkpoint(fn, x, *a,  # noqa: E731
                                                     use_reentrant=False, **kw)
        elif dense:
            name, wrapped = "_block", remat_block(model._block)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    emit({"phase": "build", "seconds": _build.build_all(),
          "sources": [p.name for p in _build.sources()]})
    emit({"phase": "ptxas", "kernels": _build.ptxas_report()})
    sass_phase()
    torch.cuda.synchronize()

    # the plain versions are the reference here: keep their f32 matmuls in
    # full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    with torch.no_grad():
        kern = kernel_phase(torch, timer)
        kern.update(quant_kernel_phase(torch, timer))
    cfg, tasks, plan = train_plan()
    kern.update(train_kernel_phase(torch, timer, cfg, tasks, plan))
    methods = methods_plan()
    kern.update(methods_kernel_phase(torch, timer, *methods))
    zamba = zamba_plan()
    kern.update(zamba_kernel_phase(torch, timer, *zamba))
    torch.cuda.synchronize()

    # the main paths (llama3.2-3b on bf16 and int8 backbones, zamba2-2.7b
    # training), each with the launch counts set to 0 just before it
    counts = {}
    # (the engine's step closures refer to it: collect the cycle, so that
    # each phase's memory peak holds its own backbone only)
    counts["serve"], bf16_run = serve_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    counts["serve_int8"], _ = serve_phase(torch, "int8", bf16_run)
    gc.collect()
    torch.cuda.empty_cache()
    counts["train"], engine = train_phase(torch, cfg, tasks, plan)
    train_check(torch, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    counts["train_methods"], engine = methods_train_phase(torch, *methods)
    train_check(torch, engine, methods=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    counts["train_int8"], engine = train_phase(torch, *train_plan("int8"))
    for seed in INT8_CHECK_SEEDS:
        train_check(torch, engine, seed)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    counts["train_zamba"], engine = train_phase(torch, *zamba)
    train_check(torch, engine)

    # (name, source, Pallas kernel body, the entry's own measurement, variants)
    csrc, jax_k = "src/repro_torch/csrc/", "src/repro/kernels/"
    kernels = [
        ("grouped_lora", "grouped_lora.cu", "grouped_lora.py:49", "grouped_lora",
         {"train_variant": "grouped_lora_train", "zamba2_variant": "grouped_lora_train_zamba2",
          "methods_variant": "grouped_lora_train_methods_lora",
          "methods_dora_variant": "grouped_lora_train_methods_dora"}),
        ("grouped_lora_bwd", "grouped_lora.cu", "grouped_lora.py:91", "grouped_lora_bwd",
         {"zamba2_variant": "grouped_lora_bwd_zamba2",
          "methods_variant": "grouped_lora_bwd_methods_lora",
          "methods_dora_variant": "grouped_lora_bwd_methods_dora"}),
        ("packed_attention", "packed_attention.cu", "packed_attention.py:60", "packed_attention",
         {"train_variant": "packed_attention_train",
          "zamba2_variant": "packed_attention_train_zamba2",
          "prefix_variant": "packed_attention_train_prefix"}),
        ("packed_attention_dq", "packed_attention.cu", "packed_attention.py:128",
         "packed_attention_dq", {"zamba2_variant": "packed_attention_dq_zamba2",
                                 "prefix_variant": "packed_attention_dq_prefix"}),
        ("packed_attention_dkv", "packed_attention.cu", "packed_attention.py:185",
         "packed_attention_dkv", {"zamba2_variant": "packed_attention_dkv_zamba2",
                                  "prefix_variant": "packed_attention_dkv_prefix"}),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:40",
         "decode_attention", {}),
        ("quant_matmul", "quant_matmul.cu", "quant_matmul.py:36", "quant_matmul", {}),
        ("mamba_scan", "mamba_scan.cu", "mamba_scan.py:76", "mamba_scan_zamba2", {}),
        ("mamba_scan_bwd_state", "mamba_scan.cu", "mamba_scan.py:136",
         "mamba_scan_bwd_state_zamba2", {}),
        ("mamba_scan_bwd_chunk", "mamba_scan.cu", "mamba_scan.py:175",
         "mamba_scan_bwd_chunk_zamba2", {}),
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
