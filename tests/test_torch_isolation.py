"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on CUDA unless the caller names the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.launch.train, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_entry_points_need_cuda_unless_cpu_is_named(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.core import ExecutionPlanner, ModelGenerator, ParallelismSpec, PEFTEngine
    from repro_torch.data import make_task
    from repro_torch.models.transformer import Model
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.peft.multitask import MultiTaskAdapters

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiTaskAdapters(cfg, [AdapterConfig("lora")])
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelGenerator(cfg)
    tasks = [make_task("t0", "sst2", 2)]
    gen = ModelGenerator(cfg, device="cpu")
    gen.register_tasks(tasks)
    plan = ExecutionPlanner(cfg, ParallelismSpec()).plan(tasks)
    with pytest.raises(RuntimeError, match="CUDA"):
        PEFTEngine(gen, plan)
    eng = PEFTEngine(gen, plan, device="cpu")
    assert eng.ensure_decode_pool(2, 8, 2)["cur"].device.type == "cpu"


def test_registry_lists_only_ported_configs():
    from repro_torch.configs import ARCH_NAMES, get_config

    assert ARCH_NAMES == ("llama3.2-3b", "smollm-360m", "zamba2-2.7b")
    assert get_config("llama3.2-3b").num_layers == 28
    assert get_config("smollm-360m").num_layers == 32
    assert get_config("zamba2-2.7b").num_layers == 54
    with pytest.raises(KeyError, match="not ported"):
        get_config("xlstm-1.3b")
