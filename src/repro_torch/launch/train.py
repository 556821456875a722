"""End-to-end multi-task PEFT training, one instance (port of
``repro.launch.train``).

Synthetic tenant tasks -> ExecutionPlanner (fusion / grouping / template /
alignment) -> ModelGenerator.register_tasks -> PEFTEngine.run_iteration.
Runs on the CUDA card unless ``--device cpu`` is given; reduced widths via
``--scale``.  Checkpointing (the JAX entry point's ``TrainSupervisor``,
``--ckpt-dir``, ``--ckpt-every``) is not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --scale 0.25 --steps 50 --tasks sst2:lora:4,qa:lora:8,rte:adapter:4

For ``--arch zamba2-2.7b`` use ``--scale 0.25`` or more: ``scaled_config``
(the JAX entry point's formula) keeps ``hybrid_period`` = 6, so below
``--scale 0.112`` it gives fewer layers than one super-block and the model
has no block at all.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.core import ExecutionPlanner, ModelGenerator, ParallelismSpec, PEFTEngine
from repro_torch.data import HTaskLoader, make_task
from repro_torch.peft.methods import AdapterConfig, resolve_kind


def parse_tasks(spec: str, micro_batch: int):
    """``ds[:kind[:rank]]`` per task, any registered PEFT method name."""
    tasks = []
    for i, part in enumerate(spec.split(",")):
        bits = part.split(":")
        ds = bits[0]
        kind = resolve_kind(bits[1]) if len(bits) > 1 else "lora"
        rank = int(bits[2]) if len(bits) > 2 else 8
        tasks.append(make_task(f"task{i}-{ds}", ds, micro_batch,
                               AdapterConfig(kind, rank=rank), seed=i))
    return tasks


def scaled_config(arch: str, scale: float):
    cfg = get_config(arch)
    if scale >= 1.0:
        return cfg
    d = max(int(cfg.d_model * scale) // 64 * 64, 64)
    heads = max(int(cfg.num_heads * scale), 1)
    kv = max(min(cfg.num_kv_heads, heads), 1)
    while heads % kv:
        kv -= 1
    return cfg.with_overrides(
        d_model=d,
        num_layers=max(int(cfg.num_layers * scale), 2),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=max(d // heads // 8 * 8, 8),
        d_ff=max(int(cfg.d_ff * scale) // 64 * 64, 64) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192),
        remat=False,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tasks", default="sst2:lora:8,qa:lora:8,rte:adapter:4,sst2:ia3")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--alignment", default="chunked", choices=["chunked", "zero_pad", "pack_only"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.scale)
    tasks = parse_tasks(args.tasks, args.micro_batch)
    print(f"arch={cfg.name} d={cfg.d_model} L={cfg.num_layers} "
          f"params~{cfg.param_count()/1e6:.0f}M  tasks={len(tasks)}  device={args.device}")

    planner = ExecutionPlanner(cfg, ParallelismSpec(num_stages=args.stages, chips_per_stage=1))
    plan = planner.plan(tasks, n_micro=args.n_micro, alignment_mode=args.alignment)
    print("plan:", json.dumps(plan.summary(), default=float))

    gen = ModelGenerator(cfg, device=args.device)
    gen.register_tasks(tasks)
    engine = PEFTEngine(gen, plan, lr=args.lr, device=args.device)
    loaders = {i: HTaskLoader(tasks, plan.alignment[i], cfg.vocab_size)
               for i in range(len(plan.htasks))}
    for i in range(args.steps):
        m = engine.run_iteration(loaders)
        if i % 5 == 0 or i == args.steps - 1:
            tp = engine.throughput(m)
            print(f"step {i:4d}  loss={m.loss:.4f}  "
                  f"tok/s={tp['tokens_per_s']:.0f}  "
                  f"eff-tok/s={tp['effective_tokens_per_s']:.0f}", flush=True)
    print("done")


if __name__ == "__main__":
    main()
