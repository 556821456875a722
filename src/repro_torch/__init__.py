"""PyTorch / CUDA port of the MuxTune system for one NVIDIA H100.

Mirrors the layout of the JAX package (``configs``, ``kernels``, ``models``,
``peft``, ``launch``, ``core``) module for module.  The hot-path kernels are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at their first
launch (``kernels/_build.py``); importing the package needs neither ``nvcc``
nor a card.

Entry points take ``device="cuda"`` by default and raise when no CUDA device
is present, unless the caller asks for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names the CPU.

    Raises when CUDA is asked for (the default) and no CUDA device exists —
    a run never drops to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
