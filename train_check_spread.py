"""The spread of chip_smoke's ``train_check`` over training data.

``chip_smoke.py`` checks one training step's adapter gradients (kernels
against the plain versions, both against an f32 run) from the state its
training path reached, and that state depends on the tokens it trained on.
This script repeats that on a path for ``N`` token seeds: a fresh
engine (its backbone from ``chip_smoke.init_backbone``, starcoder2-7b's
biases filled as there), the warm-up iteration and ``chip_smoke.TRAIN_ITERS`` iterations on
loaders seeded ``0 .. N - 1``, then ``train_check``.  The path is ``train``
(llama3.2-3b, the four LoRA / Adapter / IA3 tenants, the default),
``methods`` (llama3.2-3b, one tenant of each of the eight PEFT kinds,
``chip_smoke.methods_plan``, checked by ``train_check_methods``), ``moe``
(deepseek-moe-16b, the four tenants on q, v and the shared experts' up /
down, ``chip_smoke.moe_plan``, checked by ``train_check_moe``, which also
reports each run's routing flips against the plain run), ``zamba`` and
``zamba_int8`` (zamba2-2.7b on a bf16 or an int8 backbone, the tenants on
the Mamba2 projections and the shared block's q / v,
``chip_smoke.zamba_plan``), ``starcoder2`` (starcoder2-7b, the tenants
on q, v, fc1 and fc2, ``chip_smoke.starcoder2_plan``), ``qwen2vl``
(qwen2-vl-7b, its biases filled as there, the tenants on q, v, up and
down, ``chip_smoke.qwen2vl_plan``) or ``whisper`` (whisper-large-v3, the
tenants on the decoder's q, v, fc1 and fc2: a ``chip_smoke.WhisperTrainer``
whose batches, frames included, come from the seed, trained through
``launch.steps.build_train_step`` as chip_smoke's ``train_whisper`` does)
or ``xlstm`` and ``xlstm_int8`` (xlstm-1.3b on a bf16 or an int8
backbone, the tenants on the mLSTM's ssm_in, q and v and the sLSTM's
ssm_in, ``chip_smoke.xlstm_plan``; its mLSTM scans run the tiled kernels at
(1024, 1025)).  Where the plan names a data seed, as ``xlstm_plan``
does, seed ``s`` trains on ``chip_smoke._seeded_stream(s + task)``'s tokens
for chip_smoke's warm-up, timed and profiled iterations, so the plan's own
seed is the state that chip_smoke's check holds.  One JSON line per
seed with its distances (each the worst leaf's, as a share of that leaf's
largest f32 |g|):

* kernel vs plain, kernel vs f32, plain vs f32;
* the second plain paths, no kernel, each at a distance from the plain
  one that is the gate's noise floor: on a bf16 backbone
  ``plain_stored_o_vs_plain`` and ``plain_reordered_vs_plain``
  (``chip_smoke.plain_stored_o`` / ``plain_reordered``; on zamba2 this
  script adds the latter, which chip_smoke's check leaves out), on an int8
  one ``plain_scale_first_vs_plain`` (and on xlstm-1.3b's int8 backbone,
  where grouped LoRA's kernel runs too, this script adds
  ``plain_reordered_vs_plain``);
* ``swap_<family>_vs_plain`` for each family of ``ops.FAMILIES`` that the
  path runs: the kernel path with that family's plain version swapped in
  alone (``ops.force_plain([family])``; packed attention also by
  direction);
* ``audit_vs_plain``: the kernel path again, every grouped-LoRA,
  packed-attention and tiled mamba_scan kernel call (forward, state and
  chunk backward) held to its plain version on the same operands
  (``audit``: per kernel output the calls, the worst error as a share of
  the plain output's largest magnitude, the tolerance chip_smoke holds it
  to, how many calls exceed it, and the worst call's index; packed
  attention's dq, dk and dv also against the plain backward that reads D
  from the kernel's stored o, ``<name>_stored_o``);

each seed's line also has every run's per-task losses' largest relative
distance from the plain run's (``loss_rel``); then a summary
line: per distance the sorted values over the seeds, the worst loss
distance of each run, and
per second plain path its worst (``S`` for ``plain_stored_o``,
``S_reordered`` for ``plain_reordered``, ``S_scale_first`` for
``plain_scale_first``) and ``S_prime``, the worst of them all.

    PYTHONHASHSEED=0 python3 train_check_spread.py [ROOT] [N] [PATH]

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
import types


@contextlib.contextmanager
def audited(torch, c, records):
    """Each packed-attention kernel call, as it runs, held to its plain
    version (autograd of it for a backward) on the same operands, and each
    grouped-LoRA and tiled mamba_scan kernel call likewise
    (``chip_smoke.audited_calls``): a record per call and output,
    ``(kernel, error as a share of the plain output's largest magnitude,
    tolerance)``.  The kernels' results are returned unchanged."""
    from repro_torch.kernels import packed_attention as pa

    def rel(out, ref):
        scale = ref.float().abs().max().item()
        return (out.float() - ref.float()).abs().max().item() / scale if scale else 0.0

    def vjp(plain, leaves, rest, g):
        with torch.enable_grad():
            ts = [t.detach().requires_grad_(True) for t in leaves]
            return torch.autograd.grad(plain(*ts, *rest), ts, g)

    orig = {"fwd": pa.packed_attention_cuda, "dq": pa.packed_attention_dq_cuda,
            "dkv": pa.packed_attention_dkv_cuda}

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
            # the plain backward reading D from the kernel's stored o, as the
            # kernels (and the Pallas ones) do
            ctx = types.SimpleNamespace(saved_tensors=(q, k, v, p, s, kp, ks, o), rule=rule)
            stored = dict(zip(("dq", "dk", "dv"), pa._StoredOPlainFunction.backward(ctx, do)))
            for n_, t in zip(out_names, out if isinstance(out, tuple) else (out,)):
                tol = c.GRAD_TOL["packed_attention_" + name]
                records.append((f"packed_attention_{n_}", rel(t, refs[n_]), tol))
                records.append((f"packed_attention_{n_}_stored_o", rel(t, stored[n_]), tol))
            return out
        return fn

    pa.packed_attention_cuda = attn_fwd
    pa.packed_attention_dq_cuda = attn_bwd("dq", ("dq",))
    pa.packed_attention_dkv_cuda = attn_bwd("dkv", ("dk", "dv"))
    try:
        with c.audited_calls(torch, records):
            yield
    finally:
        pa.packed_attention_cuda, pa.packed_attention_dq_cuda = orig["fwd"], orig["dq"]
        pa.packed_attention_dkv_cuda = orig["dkv"]


def main() -> int:
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    path = sys.argv[3] if len(sys.argv) > 3 else "train"
    paths = ("train", "methods", "moe", "zamba", "zamba_int8", "starcoder2", "qwen2vl",
             "whisper", "xlstm", "xlstm_int8")
    if path not in paths:
        raise SystemExit(f"train_check_spread: unknown path {path!r} ({', '.join(paths)})")
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
    if path == "whisper":
        from repro_torch.configs import get_config

        cfg, tasks, plan, data_seed = get_config(c.WHISPER_ARCH), None, None, ()
    else:
        cfg, tasks, plan, *data_seed = {"train": c.train_plan, "methods": c.methods_plan,
                            "moe": c.moe_plan, "zamba": c.zamba_plan,
                            "zamba_int8": lambda: c.zamba_plan("int8"),
                            "starcoder2": c.starcoder2_plan,
                            "qwen2vl": c.qwen2vl_plan, "xlstm": c.xlstm_plan,
                            "xlstm_int8": lambda: c.xlstm_plan("int8")}[path]()
    int8 = cfg.backbone_dtype == "int8"
    # the families this path runs (decode attention runs in no training step,
    # packed attention in none of the ssm family's)
    families = [f for f in ops.FAMILIES if f != "decode_attention"
                and (f != "quant_matmul" or int8)
                and (f != "mamba_scan" or cfg.family in ("hybrid", "ssm"))
                and not (f.startswith("packed_attention") and cfg.family == "ssm")]
    rows = []
    for seed in range(n):
        if path == "whisper":
            engine = gen = loaders = c.WhisperTrainer(torch, data_seed=seed)
            for i in range(1 + c.TRAIN_ITERS):
                engine.run(engine.batch(i))
        else:
            gen = ModelGenerator(cfg, seed=0)
            c.init_backbone(torch, gen)
            gen.register_tasks(tasks)
            engine = PEFTEngine(gen, plan, lr=c.TRAIN_LR)
            streams = (lambda: {i: c._seeded_stream(seed + i, cfg.vocab_size)
                                for i in range(len(tasks))}) if data_seed else (lambda: None)
            loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size, seed=seed,
                                      streams=streams())
                       for i in range(len(plan.htasks))}
            # (a seeded path also runs chip_smoke's profiled iteration: its state)
            for _ in range(1 + c.TRAIN_ITERS + bool(data_seed)):
                engine.run_iteration(loaders)
        records = []
        # on the ssm family a run with a plain version in it recomputes each
        # mLSTM block, as chip_smoke's plain runs do: autograd of the plain scan
        # or of the plain int8 products (their f32 weights) keeps GBs a block
        remat = c.recompute(engine.model, True) if cfg.family == "ssm" else \
            contextlib.nullcontext
        extra = {f"swap_{f}": (lambda f=f: c._stacked(remat, lambda: ops.force_plain([f])))
                 for f in families}
        extra["audit"] = lambda: audited(torch, c, records)
        if (cfg.family == "hybrid" and not int8) or (cfg.family == "ssm" and int8):
            # (chip_smoke's check leaves it out there)
            extra["plain_reordered"] = lambda: c._stacked(remat, c.plain_reordered)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                c.train_check(torch, engine, extra=extra, methods=methods)
                ok = True
            except AssertionError:
                ok = False
        phase = '"train_check%s"' % ("_methods" if methods else c.path_suffix(cfg))
        line = json.loads([ln for ln in buf.getvalue().splitlines() if phase in ln][-1])
        worst = line["grad_err_rel_to_leaf_max"]
        rows.append({"seed": seed, "ok": ok, **{k: v["max"] for k, v in worst.items()},
                     "leaf": {k: v["leaf"] for k, v in worst.items()},
                     "loss_rel": line["loss_rel_vs_plain"],
                     "audit": c.audit_summary(records),
                     **({"routing_flips": line["routing_flips"]} if path == "moe" else {})})
        print(json.dumps(rows[-1]), flush=True)
        del engine, gen, loaders
        gc.collect()
        torch.cuda.empty_cache()
    dists = [k for k in rows[0] if k.endswith("_vs_plain") or k.endswith("_vs_f32")]
    second = {"S": "plain_stored_o_vs_plain", "S_reordered": "plain_reordered_vs_plain",
              "S_scale_first": "plain_scale_first_vs_plain"}
    worst = {name: max(r[key] for r in rows) for name, key in second.items() if key in rows[0]}
    print(json.dumps({"root": root, "path": path, "seeds": n,
                      "failed": sum(not r["ok"] for r in rows), "tol": line["grad_tol"],
                      **{k: sorted(r[k] for r in rows) for k in dists},
                      "loss_rel": {m: max(r["loss_rel"][m] for r in rows)
                                   for m in rows[0]["loss_rel"]},
                      **worst, "S_prime": max(worst.values()),
                      "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
