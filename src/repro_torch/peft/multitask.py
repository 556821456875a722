"""Multi-task adapter state + the spatially fused Dispatch/Aggregate rule
(port of ``repro.peft.multitask``, dense and hybrid families).

``TaskSegments`` is the static row -> task map of a fused (hTask) batch and
reduces per-token losses to per-task means.  ``MultiTaskAdapters`` builds
one stacked parameter tree per PEFT kind (``{kind: {site: {leaf: [L,
capacity, ...]}}}``, the JAX package's layout; the hybrid family has two
such groups, ``{"mamba": ..., "shared_attn": ...}``), so the model slices
adapters per layer beside the backbone weights.  A kind's stack may hold
more slots than live tasks (``kind_capacity``) and each task owns an
explicit slot (``task_slot``): unused slots hold fresh-init values that no
row routes to.  ``MultiTaskContext`` routes each batch row to its task's
adapter slot and merges every kind's contribution into the BaseOp output:
one grouped computation per kind covers all tasks of the fused batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.models.layers import ParamSpec, materialize
from repro_torch.peft.hooks import AdapterContext
from repro_torch.peft.methods import (
    AdapterConfig,
    ApplyContext,
    base_op_dims,
    get_method,
    supports_attention_prefix,
)


@dataclass(frozen=True)
class TaskSegments:
    """Row-level task layout of a fused batch (static)."""

    row_task: Tuple[int, ...]  # len == fused batch rows; values in [0, n_tasks)
    n_tasks: int

    @staticmethod
    def contiguous(rows_per_task: Sequence[int]) -> "TaskSegments":
        rt: List[int] = []
        for t, n in enumerate(rows_per_task):
            rt.extend([t] * n)
        return TaskSegments(tuple(rt), len(rows_per_task))

    def relabel(self, member_ids: Sequence[int]) -> "TaskSegments":
        """Re-index rows onto the member list (global -> local task ids)."""
        lookup = {g: l for l, g in enumerate(member_ids)}
        return TaskSegments(tuple(lookup[t] for t in self.row_task), len(member_ids))

    def row_task_array(self) -> np.ndarray:
        return np.asarray(self.row_task, np.int32)

    def one_hot(self, device) -> torch.Tensor:
        """[n_tasks, B] f32 row membership (the per-task sums' fixed-order
        reduction matrix)."""
        rt = torch.as_tensor(self.row_task_array(), device=device).long()
        return (rt[None, :] == torch.arange(self.n_tasks, device=device)[:, None]).float()

    def per_task_loss(self, per_token_loss: torch.Tensor, loss_mask: torch.Tensor,
                      one_hot: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[n_tasks] mean loss per task — per-task isolation (Eq. 1-2).
        ``one_hot`` is :meth:`one_hot` on the loss's device (built here when
        not given)."""
        oh = self.one_hot(per_token_loss.device) if one_hot is None else one_hot
        losses = oh @ per_token_loss.sum(dim=-1)
        counts = oh @ loss_mask.float().sum(dim=-1)
        return losses / counts.clamp_min(1.0)


class MultiTaskAdapters:
    """Builds and applies stacked multi-task adapter params for one backbone.

    The stack rank of a kind is the largest rank among its tasks (never
    below ``kind_rank``); each task's slot keeps its own scale (LoRA: its
    own alpha / rank).  ``kind_capacity`` sizes a kind's stack above its
    live count, ``task_slot`` places each task in its kind's stack."""

    def __init__(self, cfg: ArchConfig, task_cfgs: Sequence[AdapterConfig],
                 kind_capacity: Optional[Dict[str, int]] = None,
                 kind_rank: Optional[Dict[str, int]] = None,
                 task_slot: Optional[Sequence[int]] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.task_cfgs = tuple(task_cfgs)
        self.dims = base_op_dims(cfg)
        self.attention_ok = supports_attention_prefix(cfg)
        self.kind_tasks: Dict[str, List[int]] = {}
        for i, tc in enumerate(self.task_cfgs):
            self.kind_tasks.setdefault(tc.kind, []).append(i)
        if task_slot is None:
            self.task_slot = np.full((len(self.task_cfgs),), -1, np.int32)
            for ids in self.kind_tasks.values():
                for slot, tid in enumerate(ids):
                    self.task_slot[tid] = slot
        else:
            self.task_slot = np.asarray(task_slot, np.int32)
            if self.task_slot.shape != (len(self.task_cfgs),):
                raise ValueError(f"task_slot {self.task_slot.shape} for "
                                 f"{len(self.task_cfgs)} tasks")
            for kind, ids in self.kind_tasks.items():
                slots = [int(self.task_slot[i]) for i in ids]
                if len(set(slots)) != len(slots) or min(slots) < 0:
                    raise ValueError(f"slot collision for kind {kind}: {slots}")
        self.kind_rank: Dict[str, int] = {}
        self.kind_capacity: Dict[str, int] = {}
        for kind, ids in self.kind_tasks.items():
            r = max(self.task_cfgs[i].rank for i in ids)
            self.kind_rank[kind] = max(r, (kind_rank or {}).get(kind, 0))
            need = max(int(self.task_slot[i]) for i in ids) + 1
            self.kind_capacity[kind] = max(need, (kind_capacity or {}).get(kind, 0))

    # ------------------------------------------------------------------

    def kind_targets(self, kind: str) -> Tuple[str, ...]:
        """Union of the member tasks' requested BaseOp targets."""
        tgts = set().union(*(self.task_cfgs[i].targets for i in self.kind_tasks[kind]))
        return tuple(sorted(tgts))

    def kind_sites(self, kind: str,
                   targets_filter: Optional[set] = None) -> Dict[str, Tuple[int, int]]:
        """The method's attach sites, restricted to a BaseOp-dims filter."""
        dims = self.dims if targets_filter is None else {
            n: d for n, d in self.dims.items() if n in targets_filter}
        return get_method(kind).sites(self.kind_targets(kind), dims,
                                      attention=self.attention_ok)

    def _per_layer_spec(self, targets_filter: Optional[set] = None) -> Dict[str, Any]:
        """One layer's ``{kind: {site: {leaf: ParamSpec}}}``; a kind with no
        site under the filter is left out."""
        out: Dict[str, Any] = {}
        for kind in self.kind_tasks:
            method = get_method(kind)
            kspec = {site: method.param_specs(self.kind_rank[kind], din, dout,
                                              self.kind_capacity[kind])
                     for site, (din, dout) in self.kind_sites(kind, targets_filter).items()}
            if kspec:
                out[kind] = kspec
        return out

    @staticmethod
    def _stack(spec: Any, *dims: int) -> Any:
        if isinstance(spec, ParamSpec):
            return ParamSpec(tuple(dims) + spec.shape, spec.init, spec.scale)
        return {k: MultiTaskAdapters._stack(v, *dims) for k, v in spec.items()}

    def spec(self) -> Dict[str, Any]:
        """Adapter ParamSpec tree mirroring the backbone's layer layout:
        stacked over the layers (dense), or the hybrid family's two groups,
        ``mamba`` stacked ``[n_super, per, ...]`` over the Mamba2 sites and
        ``shared_attn`` unstacked over the rest."""
        cfg = self.cfg
        if cfg.family == "dense":
            return self._stack(self._per_layer_spec(), cfg.num_layers)
        n_super = cfg.num_layers // cfg.hybrid_period
        ssm_targets = {"ssm_in", "ssm_out"}
        return {
            "mamba": self._stack(self._per_layer_spec(ssm_targets), n_super,
                                 cfg.hybrid_period - 1),
            "shared_attn": self._per_layer_spec(set(self.dims) - ssm_targets),
        }

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded adapter params on this object's device (LoRA's B, the
        adapter's ``up`` and IA3's ``s`` are 0)."""
        return materialize(self.spec(), generator, self.device)

    # ------------------------------------------------------------------

    def scales(self, kind: str) -> np.ndarray:
        """Per-slot aggregate scale, sized to the kind's stack capacity."""
        method = get_method(kind)
        out = np.ones((self.kind_capacity[kind],), np.float32)
        for i in self.kind_tasks[kind]:
            out[int(self.task_slot[i])] = method.slot_scale(self.task_cfgs[i])
        return out

    def slot_values(self, kind: str, per_task: Dict[int, float],
                    fill: float = 0.0) -> np.ndarray:
        """Scatter per-task values to their slots in a capacity-sized vector."""
        out = np.full((self.kind_capacity[kind],), fill, np.float32)
        for i in self.kind_tasks[kind]:
            if i in per_task:
                out[int(self.task_slot[i])] = per_task[i]
        return out

    def kind_row_slots(self, segments: TaskSegments, kind: str) -> np.ndarray:
        """Per batch-row slot within the ``kind`` stack; -1 => not this kind."""
        return self.decode_row_slots(segments.row_task_array())[kind]

    def ctx_factory(self, segments: TaskSegments):
        """The per-layer adapter-context factory of a fused training batch."""
        kind_slots = {kind: torch.as_tensor(self.kind_row_slots(segments, kind),
                                            device=self.device)
                      for kind in self.kind_tasks}
        return self.ctx_factory_from_slots(kind_slots)

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
        add = mul = None
        for kind, kspec in self.ad.items():
            if name not in kspec:
                continue
            slots = self.kind_slots[kind]
            ctx = ApplyContext(slots=slots, gate=(slots >= 0).float(),
                               scale=self.kind_scales[kind])
            a, m1 = get_method(kind).apply(kspec[name], x3, out3, ctx)
            if a is not None:
                add = a if add is None else add + a
            if m1 is not None:
                mul = m1 if mul is None else mul * m1
        y = out3.float()
        if add is not None:  # the kinds' deltas are summed first, as in the JAX package
            y = y + add
        if mul is not None:
            y = y * mul
        return y.to(base_out.dtype).reshape(base_out.shape)
