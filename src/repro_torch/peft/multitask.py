"""Multi-task adapter state + the spatially fused Dispatch/Aggregate rule
(port of ``repro.peft.multitask``).

``TaskSegments`` is the static row -> task map of a fused (hTask) batch and
reduces per-token losses to per-task means.  ``MultiTaskAdapters`` builds
one stacked parameter tree per PEFT kind (``{kind: {site: {leaf: [L,
capacity, ...]}}}``, the JAX package's layout; the hybrid family has two
such groups, ``{"mamba": ..., "shared_attn": ...}``, the ``ssm`` family
``{"mlstm": ..., "slstm": ...}``), so the model slices
adapters per layer beside the backbone weights.  A kind's stack may hold
more slots than live tasks (``kind_capacity``) and each task owns an
explicit slot (``task_slot``): unused slots hold fresh-init values that no
row routes to.  ``MultiTaskContext`` routes each batch row to its task's
adapter slot and merges every kind's contribution into the BaseOp output:
one grouped computation per kind covers all tasks of the fused batch.
Soft-prompt kinds surface per-row k/v prefix rows to attention through
``MultiTaskContext.attn_prefix``.
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
            return ParamSpec(tuple(dims) + spec.shape, spec.init, spec.scale, spec.dtype)
        return {k: MultiTaskAdapters._stack(v, *dims) for k, v in spec.items()}

    def spec(self) -> Dict[str, Any]:
        """Adapter ParamSpec tree mirroring the backbone's layer layout:
        stacked over the layers (dense, vlm, MoE; on audio over the decoder's
        layers, the encoder carrying none), or the hybrid family's two groups,
        ``mamba`` stacked ``[n_super, per, ...]`` over the Mamba2 sites and
        ``shared_attn`` unstacked over the rest, or the ``ssm`` family's
        ``mlstm`` stacked ``[n_super, per, ...]`` over every site and
        ``slstm`` ``[n_super, ...]`` over ``ssm_in`` / ``ssm_out``."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm", "moe", "audio"):
            return self._stack(self._per_layer_spec(), cfg.num_layers)
        if cfg.family == "ssm":
            n_super = cfg.num_layers // cfg.slstm_period
            return {
                "mlstm": self._stack(self._per_layer_spec(), n_super, cfg.slstm_period - 1),
                "slstm": self._stack(self._per_layer_spec({"ssm_in", "ssm_out"}), n_super),
            }
        n_super = cfg.num_layers // cfg.hybrid_period
        ssm_targets = {"ssm_in", "ssm_out"}
        return {
            "mamba": self._stack(self._per_layer_spec(ssm_targets), n_super,
                                 cfg.hybrid_period - 1),
            "shared_attn": self._per_layer_spec(set(self.dims) - ssm_targets),
        }

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded adapter params on this object's device (LoRA's B, the
        adapter's ``up`` and IA3's ``s`` are 0), then each method's
        ``post_init``."""
        return self._post_init(materialize(self.spec(), generator, self.device))

    def _post_init(self, params: Any) -> Any:
        """Each method's deterministic fixups at each of its sites
        (Diff-Pruning's rows, VeRA's shared A / B).  Pure in (site, dims),
        so every build gives the same values, and the JAX package's (VeRA's
        in the stack's bf16)."""
        site_dims = {k: self.kind_sites(k) for k in self.kind_tasks}

        def walk(node: Any) -> Any:
            if not isinstance(node, dict):
                return node
            out = {}
            for k, v in node.items():
                if k in self.kind_tasks and isinstance(v, dict):
                    method = get_method(k)
                    out[k] = {site: method.post_init(dict(leaves), site,
                                                     *site_dims[k].get(site, (0, 0)))
                              for site, leaves in v.items()}
                else:
                    out[k] = walk(v)
            return out

        return walk(params)

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

    def reads_base_weight(self, name: str) -> bool:
        return any(name in kspec and get_method(kind).reads_base_weight
                   for kind, kspec in self.ad.items())

    def _site_ctx(self, kind: str, d_in: int = 0, d_out: int = 0,
                  base_weight: Optional[torch.Tensor] = None) -> ApplyContext:
        slots = self.kind_slots[kind]
        return ApplyContext(slots=slots, gate=(slots >= 0).float(),
                            scale=self.kind_scales[kind], d_in=d_in, d_out=d_out,
                            base_weight=base_weight)

    def apply(self, name: str, x: torch.Tensor, base_out: torch.Tensor,
              w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Site output ``(base_out + sum_k add_k) * prod_k mul_k``, summed in
        f32 and cast to base_out's type.  ``w`` is the op's weight (None
        where no resident kind reads it on an int8 backbone)."""
        B, S = x.shape[0], x.shape[1]
        d_in = int(np.prod(x.shape[2:]))
        d_out = int(np.prod(base_out.shape[2:]))
        x3 = x.reshape(B, S, d_in)
        out3 = base_out.reshape(B, S, d_out)
        w2 = w.reshape(d_in, d_out) if w is not None else None
        add = mul = None
        for kind, kspec in self.ad.items():
            if name not in kspec:
                continue
            ctx = self._site_ctx(kind, d_in, d_out, w2)
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

    def attn_prefix(self):
        """Every soft-prompt kind's per-row k/v prefix rows for this layer,
        concatenated along the prefix axis: ``(pk, pv, keep)`` with pk / pv
        [B, P, kv_dim] and keep [B, P] (1.0 where the row's task owns the
        row), or None."""
        pks, pvs, keeps = [], [], []
        for kind, kspec in self.ad.items():
            p = kspec.get("attn_prefix")
            if p is None:
                continue
            ctx = self._site_ctx(kind)
            pref = get_method(kind).attn_prefix(p, ctx)
            if pref is None:
                continue
            pk, pv = pref
            pks.append(pk)
            pvs.append(pv)
            keeps.append(ctx.gate[:, None].expand(pk.shape[:2]))
        if not pks:
            return None
        return torch.cat(pks, dim=1), torch.cat(pvs, dim=1), torch.cat(keeps, dim=1)
