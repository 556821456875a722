"""The spread of chip_smoke's ``train_check`` over training data.

``chip_smoke.py`` checks one training step's adapter gradients (kernels
against the plain versions, both against an f32 run) from the state its
training path reached, and that state depends on the tokens it trained on.
This script repeats that on a llama3.2-3b bf16 path for ``N`` token
seeds: a fresh engine, the warm-up iteration and ``chip_smoke.TRAIN_ITERS``
iterations on loaders seeded ``0 .. N - 1``, then ``train_check``.  The path
is ``train`` (the four LoRA / Adapter / IA3 tenants, the default) or
``methods`` (one tenant of each of the eight PEFT kinds,
``chip_smoke.methods_plan``, checked by ``train_check_methods``).  One
JSON line per seed with its distances (each the worst leaf's, as a share of
that leaf's largest f32 |g|):

* kernel vs plain, kernel vs f32, plain vs f32;
* ``plain_stored_o_vs_plain`` and ``plain_reordered_vs_plain``: two plain
  paths (``chip_smoke.plain_stored_o`` / ``plain_reordered``), no kernel,
  each at a distance from the plain one that is the gate's noise floor;
* ``swap_<family>_vs_plain`` for each family of ``ops.FAMILIES``: the
  kernel path with that family's plain version swapped in alone
  (``ops.force_plain([family])``; packed attention also by direction);
* ``audit_vs_plain``: the kernel path again, every grouped-LoRA and
  packed-attention kernel call held to its plain version on the same
  operands (``audit``: per kernel the calls, the worst error as a share of
  the plain output's largest magnitude, the tolerance chip_smoke holds it
  to, how many calls exceed it, and the worst call's index);

then a summary line: per distance the sorted values over the seeds, ``S``
and ``S_reordered`` (the worst of the two plain-path distances).

    PYTHONHASHSEED=0 python3 train_check_spread.py [ROOT] [N] [train|methods]

``ROOT`` is the checkout whose ``chip_smoke.py`` and ``src/`` are used
(default ``.``), so two trees can be held to the same seeds.  The token
streams hash the task id with Python's ``hash``, which is salted per
process: fix ``PYTHONHASHSEED`` to compare runs.  Needs one CUDA card.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import sys
import time


@contextlib.contextmanager
def audited(torch, c, records):
    """Each grouped-LoRA and packed-attention kernel call, as it runs, held
    to its plain version (autograd of it for a backward) on the same
    operands: a record per call and output, ``(kernel, error as a share of
    the plain output's largest magnitude, tolerance)``.  The kernels'
    results are returned unchanged."""
    from repro_torch.kernels import grouped_lora as gl
    from repro_torch.kernels import packed_attention as pa

    def rel(out, ref):
        scale = ref.float().abs().max().item()
        return (out.float() - ref.float()).abs().max().item() / scale if scale else 0.0

    def vjp(plain, leaves, rest, g):
        with torch.enable_grad():
            ts = [t.detach().requires_grad_(True) for t in leaves]
            return torch.autograd.grad(plain(*ts, *rest), ts, g)

    orig = {"fwd": pa.packed_attention_cuda, "dq": pa.packed_attention_dq_cuda,
            "dkv": pa.packed_attention_dkv_cuda, "gl": gl.grouped_lora_cuda,
            "gl_bwd": gl.grouped_lora_bwd_cuda}

    def attn_fwd(q, k, v, *rest, **kw):
        out = orig["fwd"](q, k, v, *rest, **kw)
        o = out[0] if isinstance(out, tuple) else out
        records.append(("packed_attention", rel(o, pa.packed_attention_plain(q, k, v, *rest)),
                        c.KERNEL_TOL))
        return out

    def attn_bwd(name, out_names):
        def fn(q, k, v, p, s, kp, ks, o, lse, do, *rule):
            out = orig[name](q, k, v, p, s, kp, ks, o, lse, do, *rule)
            refs = dict(zip(("dq", "dk", "dv"), vjp(pa.packed_attention_plain, (q, k, v),
                                                    (p, s, kp, ks, *rule), do)))
            for n_, t in zip(out_names, out if isinstance(out, tuple) else (out,)):
                records.append((f"packed_attention_{n_}", rel(t, refs[n_]),
                                c.GRAD_TOL["packed_attention_" + name]))
            return out
        return fn

    def lora_fwd(x, a, b, rt, scale, **kw):
        out = orig["gl"](x, a, b, rt, scale, **kw)
        y = out[0] if isinstance(out, tuple) else out
        records.append(("grouped_lora", rel(y, gl.grouped_lora_plain(x, a, b, rt, scale)),
                        c.KERNEL_TOL))
        return out

    def lora_bwd(x, a, b, rt, scale, h, g):
        out = orig["gl_bwd"](x, a, b, rt, scale, h, g)
        refs = vjp(gl.grouped_lora_plain, (x, a, b), (rt, scale), g)
        for n_, t, r_ in zip(("dx", "da", "db"), out, refs):
            records.append((f"grouped_lora_bwd_{n_}", rel(t, r_), c.GRAD_TOL["grouped_lora_bwd"]))
        return out

    pa.packed_attention_cuda = attn_fwd
    pa.packed_attention_dq_cuda = attn_bwd("dq", ("dq",))
    pa.packed_attention_dkv_cuda = attn_bwd("dkv", ("dk", "dv"))
    gl.grouped_lora_cuda, gl.grouped_lora_bwd_cuda = lora_fwd, lora_bwd
    try:
        yield
    finally:
        pa.packed_attention_cuda, pa.packed_attention_dq_cuda = orig["fwd"], orig["dq"]
        pa.packed_attention_dkv_cuda = orig["dkv"]
        gl.grouped_lora_cuda, gl.grouped_lora_bwd_cuda = orig["gl"], orig["gl_bwd"]


def audit_summary(records):
    """Per kernel output: calls, worst error, tolerance, calls over it and
    the worst call's index among that output's calls."""
    out = {}
    for kernel, err, tol in records:
        e = out.setdefault(kernel, {"calls": 0, "max": 0.0, "tol": tol, "over": 0, "worst": 0})
        if err > e["max"]:
            e["max"], e["worst"] = err, e["calls"]
        e["over"] += err > tol
        e["calls"] += 1
    return out


def main() -> int:
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    path = sys.argv[3] if len(sys.argv) > 3 else "train"
    if path not in ("train", "methods"):
        raise SystemExit(f"train_check_spread: unknown path {path!r} (train or methods)")
    methods = path == "methods"
    os.chdir(root)
    sys.path[:0] = [".", "src"]
    import torch

    if not torch.cuda.is_available():
        print("train_check_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.data import HTaskLoader
    from repro_torch.kernels import _build, ops

    t0 = time.time()
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tasks, plan = c.methods_plan() if methods else c.train_plan()
    rows = []
    for seed in range(n):
        gen = ModelGenerator(cfg, seed=0)
        gen.init_backbone()
        gen.register_tasks(tasks)
        engine = PEFTEngine(gen, plan, lr=c.TRAIN_LR)
        loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size, seed=seed)
                   for i in range(len(plan.htasks))}
        for _ in range(1 + c.TRAIN_ITERS):
            engine.run_iteration(loaders)
        records = []
        extra = {f"swap_{f}": (lambda f=f: ops.force_plain([f])) for f in ops.FAMILIES}
        extra["audit"] = lambda: audited(torch, c, records)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                c.train_check(torch, engine, extra=extra, methods=methods)
                ok = True
            except AssertionError:
                ok = False
        phase = '"train_check_methods"' if methods else '"train_check"'
        line = [ln for ln in buf.getvalue().splitlines() if phase in ln][-1]
        worst = json.loads(line)["grad_err_rel_to_leaf_max"]
        rows.append({"seed": seed, "ok": ok, **{k: v["max"] for k, v in worst.items()},
                     "leaf": {k: v["leaf"] for k, v in worst.items()},
                     "audit": audit_summary(records)})
        print(json.dumps(rows[-1]), flush=True)
        del engine, gen, loaders
        gc.collect()
        torch.cuda.empty_cache()
    dists = [k for k in rows[0] if k.endswith("_vs_plain") or k.endswith("_vs_f32")]
    print(json.dumps({"root": root, "path": path, "seeds": n,
                      "failed": sum(not r["ok"] for r in rows),
                      "tol": c.METHODS_GRAD_PATH_TOL if methods else c.GRAD_PATH_TOL,
                      **{k: sorted(r[k] for r in rows) for k in dists},
                      "S": max(r["plain_stored_o_vs_plain"] for r in rows),
                      "S_reordered": max(r["plain_reordered_vs_plain"] for r in rows),
                      "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
