"""ModelGenerator + ``register_tasks()`` — multi-task attachment (§3.2)
(port of ``repro.core.registry``, first registration).

The backbone is instantiated once from a seeded ``torch.Generator`` (and
quantized to int8 there when ``cfg.backbone_dtype == "int8"``);
registering tasks builds the stacked adapter tree with slot-stable
capacities (a kind's stack doubles when full) and fresh AdamW moments.
Re-registration, which migrates surviving tasks' adapters and moments into
the new stacks (``deregister_tasks``, ``compact``, ``_migrate``), comes
with tenant churn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.task import PEFTTask
from repro_torch.models.quantize import quantize_backbone
from repro_torch.models.transformer import Model
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import AdamWState, adamw_init


def _group_depths(cfg: ArchConfig) -> Dict[str, int]:
    """Layer dims stacked before the task axis, per adapter group ("" = the
    whole tree): one for the dense family; the hybrid family's ``mamba``
    group is stacked [n_super, per] and its ``shared_attn`` group not at all."""
    if cfg.family == "dense":
        return {"": 1}
    if cfg.family == "hybrid":
        return {"mamba": 2, "shared_attn": 0}
    raise NotImplementedError(f"the port runs the dense and hybrid families, not {cfg.family}")


@dataclass
class RegisteredTasks:
    tasks: List[PEFTTask]
    mta: MultiTaskAdapters
    adapter_params: Any
    opt_state: AdamWState


class ModelGenerator:
    """Builds the PEFT model for an instance and registers its tasks
    (``device="cuda"`` by default; raises without CUDA unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, arch, seed: int = 0, device="cuda"):
        self.cfg = get_config(arch) if isinstance(arch, str) else arch
        self.device = resolve_device(device)
        self.model = Model(self.cfg, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.backbone_params: Optional[Any] = None
        self.registered: Optional[RegisteredTasks] = None

    def init_backbone(self) -> Any:
        if self.backbone_params is None:
            params = self.model.init(self.generator)
            if self.cfg.backbone_dtype == "int8":
                # quantize once at build; each dense leaf goes as its int8
                # node replaces it
                params = quantize_backbone(params, self.cfg)
            self.backbone_params = params
        return self.backbone_params

    def register_tasks(self, new_tasks: Sequence[PEFTTask]) -> RegisteredTasks:
        """Register the instance's tasks (§3.2 API).  Adding tasks to a
        registered instance migrates adapter state, which is not ported yet."""
        if self.registered is not None:
            raise NotImplementedError("re-registration (tenant churn) is not ported yet")
        tasks: List[PEFTTask] = []
        for t in new_tasks:
            if any(t.task_id == o.task_id for o in tasks):
                raise ValueError(f"duplicate task_id {t.task_id}")
            tasks.append(t)
        return self._rebuild(tasks)

    def _slot_plan(self, tasks: List[PEFTTask]):
        """Slot assignment of a first registration: each task takes its
        kind's lowest free slot, and a full stack doubles its capacity
        (1 -> 2 -> 4), so later arrivals find free slots."""
        slots = np.full((len(tasks),), -1, np.int32)
        used: Dict[str, set] = {}
        caps: Dict[str, int] = {}
        for i, t in enumerate(tasks):
            kind = t.adapter.kind
            taken = used.setdefault(kind, set())
            cap = caps.get(kind, 0)
            free = [s for s in range(cap) if s not in taken]
            if free:
                s = free[0]
            else:
                s = max(taken, default=-1) + 1
                caps[kind] = max(cap * 2, s + 1)  # amortized growth
            slots[i] = s
            taken.add(s)
        return slots, caps

    def _rebuild(self, tasks: List[PEFTTask]) -> RegisteredTasks:
        slots, caps = self._slot_plan(tasks)
        mta = MultiTaskAdapters(self.cfg, [t.adapter for t in tasks], kind_capacity=caps,
                                task_slot=slots, device=self.device)
        params = mta.init(self.generator)
        self.registered = RegisteredTasks(tasks, mta, params, adamw_init(params))
        return self.registered
