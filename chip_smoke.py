#!/usr/bin/env python3
"""Run the PyTorch port's multi-tenant LoRA co-serving decode path on one
NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each:

1. device   -- nvidia-smi name and power limit, torch and CUDA versions;
2. build    -- nvcc builds every kernel under src/repro_torch/csrc;
3. kernels  -- each kernel against its plain PyTorch version on the card at
               the serving path's full-width bf16 shapes, with times (CUDA
               events, median of 25 runs, L2 flushed before each);
4. serve    -- llama3.2-3b at full width and depth, random weights from a
               seed, four LoRA tenants on one stacked adapter set; eight
               greedy requests bound by one batched prefill and generated to
               completion through PEFTEngine, with the kernels' launch counts
               checked; then a teacher-forced rerun on the kernels and on the
               plain versions, logits compared at every step.

Then a {"kernels": [...]} line, the raw nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises: the script exits non-zero
and prints no ok line.  Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
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
# bf16 keeps 8 significant bits: a kernel and its plain version that sum in
# f32 in different orders may round one output a unit in the last place
# apart, i.e. up to 2**-8 of its magnitude.  Two such units at the largest
# magnitude bound every element.
KERNEL_TOL = 2 * 2.0 ** -8
# Logits after 28 bf16 layers: every layer rounds its residual stream, and
# the kernels round their outputs after f32 sums taken in another order than
# the plain versions, so per-layer differences of a few units in the last
# place compound.  5% of the largest logit stays far below what a routing,
# masking or cache fault gives (an error of the order of the logits).
LOGIT_TOL = 0.05


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


def compare(out, ref, what: str):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = KERNEL_TOL * scale
    ok = err <= tol
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} > tol {tol}")
    return err, (err / scale if scale else 0.0), tol


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def profile_micro_steps(torch, engine, slots, scales, n: int = 3):
    """Device time by kernel over ``n`` fused micro steps of the finished
    pool (idle rows compute the same work as live ones), and the device's
    busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.dispatch_decode_micro(slots, scales)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = (us / 1e3 / n, e.count / n)
    groups = {"grouped_lora": 0.0, "decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, (ms, _) in kernels.items():
        if "grouped_lora" in name:
            groups["grouped_lora"] += ms
        elif "decode_stage" in name:
            groups["decode_attention"] += ms
        elif any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": n, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if kernels else None,
            "device_busy_share": device_ms / wall_ms if kernels else None,
            "kernel_launches_per_step": sum(c for _, c in kernels.values()),
            "device_ms_by_group": groups,
            "top_kernels": [{"name": k[:80], "ms_per_step": v[0], "calls_per_step": v[1]}
                            for k, v in top]}


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
            plain_ms = timer(lambda: grouped_lora_plain(x, a, b, rt, scale))
            nbytes = 2 * (M * d_in + present * r * (d_in + d_out) + M * d_out) + 4 * (M + T)
            flops = 2.0 * active_rows * r * (d_in + d_out)
            bms, by = bound_ms(nbytes, flops)
            per_shape[(M, d_in, d_out)] = (ms, plain_ms, bms, err)
            emit({"phase": "kernels", "kernel": "grouped_lora", "M": M, "d_in": d_in,
                  "d_out": d_out, "T": T, "r": r, "max_abs_err": err, "max_rel_err": rel,
                  "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                  "bound_by": by, "library_ms": None})
    # one layer of one decode step: the seven LoRA sites at M = 8
    layer = [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072), (3072, 8192),
             (3072, 8192), (8192, 3072)]
    sums = [sum(per_shape[(8, di, do)][i] for di, do in layer) for i in range(3)]
    results["grouped_lora"] = {
        "shape": "M=8, T=4, r=64: the seven LoRA sites of one layer of one decode step (sum)",
        "ms": sums[0], "plain_ms": sums[1], "bound_ms": sums[2],
        "bound_by": "bytes", "library_ms": None,
        "max_abs_err": max(v[3] for v in per_shape.values())}

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
        lib_ms = None
        if name == "causal":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        emit({"phase": "kernels", "kernel": "packed_attention", "case": name, "B": B, "S": S,
              "Sk": Sk, "H": H, "Hkv": Hkv, "dh": dh, "max_abs_err": err, "max_rel_err": rel,
              "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
              "library_ms": lib_ms})
        if name == "causal":
            results["packed_attention"] = {
                "shape": f"B={B}, S={S}, H={H}, Hkv={Hkv}, dh={dh}, causal",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms}
    # the kernel's non-causal branch (not on the serving path): checked only
    out = ops.packed_attention(q, k, v, causal=False)
    with ops.force_plain():
        ref = ops.packed_attention(q, k, v, causal=False)
    err, rel, tol = compare(out, ref, "packed_attention not causal")
    emit({"phase": "kernels", "kernel": "packed_attention", "case": "not_causal",
          "max_abs_err": err, "max_rel_err": rel, "tol": tol})
    results["packed_attention"]["max_abs_err"] = max(pa_err, err)

    # ---- decode attention: 8 rows over a 1024-row cache, mixed windows ----
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
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True))
    window = int((end - start).clamp_min(0).sum().item())
    nbytes = 2 * (2 * Bd * H * dh + 2 * window * Hkv * dh) + 4 * 2 * Bd
    bms, by = bound_ms(nbytes, 4.0 * H * dh * window)
    emit({"phase": "kernels", "kernel": "decode_attention", "B": Bd, "Smax": Smax, "H": H,
          "Hkv": Hkv, "dh": dh, "window_rows": window, "max_abs_err": err,
          "max_rel_err": rel, "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
          "bound_by": by, "library_ms": lib_ms})
    results["decode_attention"] = {
        "shape": f"B={Bd}, Smax={Smax}, H={H}, Hkv={Hkv}, dh={dh}, {window} window rows",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "max_abs_err": err}
    return results


def serve_phase(torch):
    """The main path: PEFTEngine serving 8 requests of 4 LoRA tenants."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.engine import PEFTEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.peft.multitask import MultiTaskAdapters

    cfg = get_config("llama3.2-3b")
    L = cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    model = Model(cfg)
    backbone = model.init(g)
    tenants = [AdapterConfig("lora", rank=rk, alpha=al, targets=SITES)
               for rk, al in ((8, 16.0), (16, 16.0), (32, 64.0), (64, 32.0))]
    mta = MultiTaskAdapters(cfg, tenants)
    adapters = mta.init(g)
    for site in adapters["lora"].values():  # LoRA's B starts at 0: fill it
        site["b"].copy_(torch.randn(site["b"].shape, generator=g, device="cuda") * 0.02)
    engine = PEFTEngine(model, backbone, mta, adapters)
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
    want = {"grouped_lora": len(SITES) * L * (1 + n_micro), "packed_attention": L,
            "decode_attention": L * n_micro}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path implies {want}")
    gen = [engine.decode_outputs(i)[:max_new[i]] for i in range(rows)]
    decode_tokens = int(sum(max_new) - rows)
    emit({"phase": "serve", "model": cfg.name, "layers": L, "d_model": cfg.d_model,
          "tenants": [{"rank": t.rank, "alpha": t.alpha} for t in tenants],
          "requests": rows, "prompt_lengths": lengths.tolist(),
          "max_new": max_new.tolist(), "bucket": Lp, "micro_steps": n_micro,
          "launches": counts, "bind_s": bind_s,
          "prefill_tokens_per_s": float(lengths.sum()) / bind_s,
          "decode_tokens_per_s": decode_tokens / sum(step_s),
          "micro_step_ms_median": statistics.median(step_s) * 1e3,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    torch.cuda.synchronize()

    prof = profile_micro_steps(torch, engine, slots, scales)
    emit({"phase": "profile", **prof})

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
        "f32": (tree_map(lambda t: t.float(), backbone),
                tree_map(lambda t: t.float(), adapters), torch.float32, ops.force_plain),
    }
    worst = {"kernel_vs_plain": 0.0, "kernel_vs_f32": 0.0, "plain_vs_f32": 0.0,
             "scale": 0.0, "argmax_agree": 1.0}

    def check(logits, live, where):
        lk, lp, lr = (logits[m][live].float() for m in ("kernel", "plain", "f32"))
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        if not err <= LOGIT_TOL * scale:
            raise AssertionError(f"{where}: logits kernel vs plain max abs {err} "
                                 f"> {LOGIT_TOL} x {scale}")
        worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], err)
        worst["kernel_vs_f32"] = max(worst["kernel_vs_f32"], (lk - lr).abs().max().item())
        worst["plain_vs_f32"] = max(worst["plain_vs_f32"], (lp - lr).abs().max().item())
        worst["scale"] = max(worst["scale"], scale)
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
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
        check(logits, torch.ones(rows, dtype=torch.bool, device=dev), "prefill")
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
            check(logits, live, f"decode step {i}")
    torch.cuda.synchronize()
    emit({"phase": "serve_check", "steps": n_micro + 1,
          "logit_max_abs_err": worst["kernel_vs_plain"], "logit_scale": worst["scale"],
          "tol": LOGIT_TOL * worst["scale"], "argmax_agreement_min": worst["argmax_agree"],
          "kernel_vs_f32_max_abs": worst["kernel_vs_f32"],
          "plain_vs_f32_max_abs": worst["plain_vs_f32"]})
    return counts


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
    torch.cuda.synchronize()

    # the plain versions are the reference here: keep their f32 matmuls in
    # full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    with torch.no_grad():
        kern = kernel_phase(torch, timer)
    torch.cuda.synchronize()

    counts = serve_phase(torch)

    sources = {"grouped_lora": ("src/repro_torch/csrc/grouped_lora.cu",
                                "src/repro/kernels/grouped_lora.py:49"),
               "packed_attention": ("src/repro_torch/csrc/packed_attention.cu",
                                    "src/repro/kernels/packed_attention.py:60"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:40")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **kern[name]}
        for name, (src, rep) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
