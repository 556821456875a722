"""Multi-task adapter state + the spatially fused Dispatch/Aggregate rule
(port of ``repro.peft.multitask``, dense family).

``MultiTaskAdapters`` builds one stacked parameter tree per PEFT kind
(``{kind: {site: {leaf: [L, capacity, ...]}}}``, the JAX package's layout),
so the model slices adapters per layer beside the backbone weights.
``MultiTaskContext`` routes each batch row to its task's adapter slot and
merges every kind's contribution into the BaseOp output: one grouped
computation per kind covers all tasks of the fused batch.

Slots follow the task order within each kind; capacities equal the live
task count (the JAX package's slot-stable ``kind_capacity``/``task_slot``
options come with online churn, in a later slice).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.models.layers import ParamSpec, materialize
from repro_torch.peft.hooks import AdapterContext
from repro_torch.peft.methods import AdapterConfig, ApplyContext, base_op_dims, get_method


class MultiTaskAdapters:
    """Builds and applies stacked multi-task adapter params for one backbone.

    The stack rank of a kind is the largest rank among its tasks; each
    task's slot keeps its own scale (LoRA: its own alpha / rank)."""

    def __init__(self, cfg: ArchConfig, task_cfgs: Sequence[AdapterConfig],
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.task_cfgs = tuple(task_cfgs)
        self.dims = base_op_dims(cfg)
        self.kind_tasks: Dict[str, List[int]] = {}
        for i, tc in enumerate(self.task_cfgs):
            self.kind_tasks.setdefault(tc.kind, []).append(i)
        self.task_slot = np.full((len(self.task_cfgs),), -1, np.int32)
        for ids in self.kind_tasks.values():
            for slot, tid in enumerate(ids):
                self.task_slot[tid] = slot
        self.kind_rank = {kind: max(self.task_cfgs[i].rank for i in ids)
                          for kind, ids in self.kind_tasks.items()}
        self.kind_capacity = {kind: len(ids) for kind, ids in self.kind_tasks.items()}

    # ------------------------------------------------------------------

    def kind_targets(self, kind: str) -> Tuple[str, ...]:
        """Union of the member tasks' requested BaseOp targets."""
        tgts = set().union(*(self.task_cfgs[i].targets for i in self.kind_tasks[kind]))
        return tuple(sorted(tgts))

    def kind_sites(self, kind: str) -> Dict[str, Tuple[int, int]]:
        return get_method(kind).sites(self.kind_targets(kind), self.dims)

    def spec(self) -> Dict[str, Any]:
        """Adapter ParamSpec tree, stacked over the backbone's layers."""
        L = self.cfg.num_layers
        out: Dict[str, Any] = {}
        for kind in self.kind_tasks:
            method = get_method(kind)
            kspec = {}
            for site, (din, dout) in self.kind_sites(kind).items():
                kspec[site] = {
                    leaf: ParamSpec((L,) + s.shape, s.init, s.scale)
                    for leaf, s in method.param_specs(self.kind_rank[kind], din, dout,
                                                      self.kind_capacity[kind]).items()}
            if kspec:
                out[kind] = kspec
        return out

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded adapter params on this object's device (LoRA's B is 0)."""
        return materialize(self.spec(), generator, self.device)

    # ------------------------------------------------------------------

    def scales(self, kind: str) -> np.ndarray:
        """Per-slot aggregate scale, sized to the kind's stack capacity."""
        method = get_method(kind)
        out = np.ones((self.kind_capacity[kind],), np.float32)
        for i in self.kind_tasks[kind]:
            out[int(self.task_slot[i])] = method.slot_scale(self.task_cfgs[i])
        return out

    def decode_row_slots(self, row_task: Sequence[int]) -> Dict[str, np.ndarray]:
        """Per-kind [B] slot vectors for a row -> task map (-1 = unbound)."""
        rt = np.asarray(row_task, np.int32)
        out: Dict[str, np.ndarray] = {}
        for kind, ids in self.kind_tasks.items():
            members = set(ids)
            slots = np.full(rt.shape, -1, np.int32)
            for r, t in enumerate(rt):
                if t in members:
                    slots[r] = self.task_slot[t]
            out[kind] = slots
        return out

    def ctx_factory_from_slots(self, kind_slots: Dict[str, torch.Tensor],
                               kind_scales: Optional[Dict[str, torch.Tensor]] = None):
        """Adapter-context factory over explicit per-row slot vectors
        (``kind_slots[kind]`` [B] int32, -1 = row not of this kind)."""
        if kind_scales is None:
            kind_scales = {kind: torch.as_tensor(self.scales(kind), device=self.device)
                           for kind in self.kind_tasks}

        def factory(layer_adapters: Any) -> AdapterContext:
            return MultiTaskContext(layer_adapters, kind_slots, kind_scales)

        return factory


class MultiTaskContext(AdapterContext):
    """Grouped Dispatch/Aggregate over a fused batch: one contribution per
    PEFT kind, each produced by that kind's registered method."""

    def __init__(self, layer_adapters, kind_slots, kind_scales):
        self.ad = layer_adapters or {}
        self.kind_slots = kind_slots
        self.kind_scales = kind_scales

    def has(self, name: str) -> bool:
        return any(name in kspec for kspec in self.ad.values())

    def apply(self, name: str, x: torch.Tensor, base_out: torch.Tensor) -> torch.Tensor:
        """Site output ``(base_out + sum_k add_k) * prod_k mul_k``, summed in
        f32 and cast to base_out's type."""
        B, S = x.shape[0], x.shape[1]
        d_in = int(np.prod(x.shape[2:]))
        d_out = int(np.prod(base_out.shape[2:]))
        x3 = x.reshape(B, S, d_in)
        out3 = base_out.reshape(B, S, d_out)
        y = out3.float()
        mul = None
        for kind, kspec in self.ad.items():
            if name not in kspec:
                continue
            slots = self.kind_slots[kind]
            ctx = ApplyContext(slots=slots, gate=(slots >= 0).float(),
                               scale=self.kind_scales[kind])
            a, m1 = get_method(kind).apply(kspec[name], x3, out3, ctx)
            if a is not None:
                y = y + a
            if m1 is not None:
                mul = m1 if mul is None else mul * m1
        if mul is not None:
            y = y * mul
        return y.to(base_out.dtype).reshape(base_out.shape)
