"""The spread of chip_smoke's ``train_check`` over training data.

``chip_smoke.py`` checks one training step's adapter gradients (kernels
against the plain versions, both against an f32 run) from the state its
training path reached, and that state depends on the tokens it trained on.
This script repeats that on the llama3.2-3b bf16 path for ``N`` token
seeds: a fresh engine, the warm-up iteration and ``chip_smoke.TRAIN_ITERS``
iterations on loaders seeded ``0 .. N - 1``, then ``train_check``.  One
JSON line per seed with its four distances (each the worst leaf's, as a
share of that leaf's largest f32 |g|): kernel vs plain, kernel vs f32,
plain vs f32, and ``plain_stored_o_vs_plain``, the distance of two plain
paths (``chip_smoke.plain_stored_o``) that is the gate's noise floor; then
a summary line whose ``S`` is the worst of the last over the seeds.

    PYTHONHASHSEED=0 python3 train_check_spread.py [ROOT] [N]

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


def main() -> int:
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    os.chdir(root)
    sys.path[:0] = [".", "src"]
    import torch

    if not torch.cuda.is_available():
        print("train_check_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.core import ModelGenerator, PEFTEngine
    from repro_torch.data import HTaskLoader
    from repro_torch.kernels import _build

    t0 = time.time()
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tasks, plan = c.train_plan()
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
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                c.train_check(torch, engine)
                ok = True
            except AssertionError:
                ok = False
        line = [ln for ln in buf.getvalue().splitlines() if '"train_check"' in ln][-1]
        worst = json.loads(line)["grad_err_rel_to_leaf_max"]
        rows.append({"seed": seed, "ok": ok, **{k: v["max"] for k, v in worst.items()},
                     "kernel_vs_plain_leaf": worst["kernel_vs_plain"]["leaf"]})
        print(json.dumps(rows[-1]), flush=True)
        del engine, gen, loaders
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "seeds": n, "failed": sum(not r["ok"] for r in rows),
                      "tol": c.GRAD_PATH_TOL,
                      "kernel_vs_plain": sorted(r["kernel_vs_plain"] for r in rows),
                      "plain_vs_f32": sorted(r["plain_vs_f32"] for r in rows),
                      "plain_stored_o_vs_plain": sorted(r["plain_stored_o_vs_plain"]
                                                        for r in rows),
                      "S": max(r["plain_stored_o_vs_plain"] for r in rows),
                      "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
