"""ModelGenerator + ``register_tasks()`` — dynamic multi-task attachment (§3.2)
(port of ``repro.core.registry``).

The backbone is instantiated once from a seeded ``torch.Generator`` (and
quantized to int8 there when ``cfg.backbone_dtype == "int8"``); task
arrival and completion rebuild only the stacked adapter tree, migrating the
surviving tasks' adapter values and AdamW moments into the new stacks.  No
backbone re-init, ever.  Slots are stable across churn: a survivor keeps its
slot, a newcomer takes its kind's lowest free slot, and a kind's stack
capacity and stack rank only grow (``compact`` re-packs them), so leaf
shapes, and the engine's cached step closures with them, survive arrivals
and departures.  Fresh tenants draw their adapters from the generator's
own seeded stream (the JAX package draws from its PRNG key).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.task import PEFTTask
from repro_torch.models.quantize import quantize_backbone
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import shared_leaf
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import AdamWState, adamw_init, tree_map


def _group_depths(cfg: ArchConfig) -> Dict[str, int]:
    """Layer dims stacked before the task axis, per adapter group ("" = the
    whole tree): one for the dense, vlm, audio (the decoder's layers) and MoE
    families; the hybrid family's ``mamba``
    group is stacked [n_super, per] and its ``shared_attn`` group not at all;
    the ``ssm`` family's ``mlstm`` group [n_super, per], ``slstm`` [n_super]."""
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        return {"": 1}
    if cfg.family == "hybrid":
        return {"mamba": 2, "shared_attn": 0}
    if cfg.family == "ssm":
        return {"mlstm": 2, "slstm": 1}
    raise ValueError(cfg.family)


@dataclass
class RegisteredTasks:
    tasks: List[PEFTTask]
    mta: MultiTaskAdapters
    adapter_params: Any
    opt_state: AdamWState

    def signature(self) -> Tuple:
        return tuple((t.task_id, t.adapter.kind, t.adapter.rank, int(self.mta.task_slot[i]))
                     for i, t in enumerate(self.tasks))

    def task_index(self, task_id: str) -> int:
        for i, t in enumerate(self.tasks):
            if t.task_id == task_id:
                return i
        raise KeyError(task_id)


def slice_task_tree(cfg: ArchConfig, mta: MultiTaskAdapters, tree: Any,
                    task_index: int) -> Any:
    """One task's adapter slices of the stacked tree (task axis removed): the
    standalone artifact a completed tenant checkpoints out.  Shared leaves
    (a method's ``shared_params``) carry no task axis and are included
    whole, so the artifact follows the method's checkpoint schema.  ``None``
    leaves (an integer leaf's moments) are left out."""
    kind = mta.task_cfgs[task_index].kind
    slot = int(mta.task_slot[task_index])
    depths = _group_depths(cfg)

    def walk(node: Any, depth: int, in_kind: bool, name=None) -> Any:
        if not isinstance(node, dict):
            if node is None or not in_kind:
                return None
            if name is not None and shared_leaf(kind, name):
                return node
            return node.select(depth, slot)
        out = {}
        for k, v in node.items():
            if k in mta.kind_tasks and not in_kind:
                if k != kind:
                    continue
                out[k] = walk(v, depth, True)
            else:
                sub = walk(v, depth, in_kind, k)
                if sub is not None and not (isinstance(sub, dict) and not sub):
                    out[k] = sub
        return out

    if "" in depths:
        return walk(tree, depths[""], False)
    return {gk: walk(tree.get(gk, {}), d, False) for gk, d in depths.items() if gk in tree}


def load_task_tree(cfg: ArchConfig, mta: MultiTaskAdapters, tree: Any, task_index: int,
                   sub: Any, strict: bool = False) -> Any:
    """Write one task's adapter subtree back into its stack slot (warm
    start); returns a new tree whose written leaves are copies.  A subtree
    saved at a smaller stack rank loads into the leading rank slice; a wider
    one loads when its overflow is exactly zero (rank padding).  Any other
    mismatch keeps the fresh leaf, or raises with ``strict=True``."""
    kind = mta.task_cfgs[task_index].kind
    slot = int(mta.task_slot[task_index])
    depths = _group_depths(cfg)

    def skip(node, src):
        if strict:
            raise ValueError(f"warm-start leaf shape {tuple(src.shape)} incompatible with "
                             f"stack leaf {tuple(node.shape)} (task axis {kind}[{slot}])")
        return node

    def walk(node: Any, sub_node: Any, depth: int, in_kind: bool, name=None) -> Any:
        if not isinstance(node, dict):
            if node is None or sub_node is None or not in_kind:
                return node
            if name is not None and shared_leaf(kind, name):
                # shared frozen leaf: rebuilt by the method's post_init, never
                # written from an artifact
                return node
            src = torch.as_tensor(sub_node, device=node.device)
            if src.dim() != node.dim() - 1:
                return skip(node, src)
            head, tail = tuple(node.shape[:depth]), tuple(node.shape[depth + 1:])
            s_head, s_tail = tuple(src.shape[:depth]), tuple(src.shape[depth:])
            if s_head != head:
                return skip(node, src)
            if any(s > t for s, t in zip(s_tail, tail)):
                # a wider artifact loads iff its overflow is exactly zero
                clip = src[(slice(None),) * depth
                           + tuple(slice(0, min(s, t)) for s, t in zip(s_tail, tail))]
                if int(torch.count_nonzero(src)) != int(torch.count_nonzero(clip)):
                    return skip(node, src)
                src = clip
                s_tail = tuple(src.shape[depth:])
            out = node.clone()
            idx = (slice(None),) * depth + (slot,) + tuple(slice(0, s) for s in s_tail)
            out[idx] = src.to(node.dtype)
            return out
        out = {}
        for k, v in node.items():
            if k in mta.kind_tasks and not in_kind:
                if k == kind and isinstance(sub_node, dict) and k in sub_node:
                    out[k] = walk(v, sub_node[k], depth, True)
                else:
                    out[k] = v
            else:
                s = sub_node.get(k) if isinstance(sub_node, dict) else None
                out[k] = walk(v, s, depth, in_kind, k)
        return out

    if "" in depths:
        return walk(tree, sub, depths[""], False)
    return {gk: (walk(tree[gk], (sub or {}).get(gk), d, False) if gk in (sub or {})
                 else tree[gk])
            for gk, d in depths.items() if gk in tree}


class ModelGenerator:
    """Builds the PEFT model for an instance and manages task registration
    (``device="cuda"`` by default; raises without CUDA unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, arch, seed: int = 0, device="cuda"):
        self.cfg = get_config(arch) if isinstance(arch, str) else arch
        self.device = resolve_device(device)
        self.model = Model(self.cfg, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.backbone_params: Optional[Any] = None
        self.registered: Optional[RegisteredTasks] = None
        # slot-stability state: stack capacity and rank floor per kind are
        # monotone across attach / detach (shrunk only by compact())
        self._kind_capacity: Dict[str, int] = {}
        self._kind_rank: Dict[str, int] = {}
        # pre-reserved slots per kind: a serving controller sets this so the
        # first arrivals land in already-allocated stacks
        self.capacity_floor: int = 0

    def init_backbone(self) -> Any:
        if self.backbone_params is None:
            params = self.model.init(self.generator)
            if self.cfg.backbone_dtype == "int8":
                # quantize once at build; each dense leaf goes as its int8
                # node replaces it
                params = quantize_backbone(params, self.cfg)
            self.backbone_params = params
        return self.backbone_params

    # ------------------------------------------------------------------

    def register_tasks(self, new_tasks: Sequence[PEFTTask]) -> RegisteredTasks:
        """Add tasks to (or build) the in-flight instance — §3.2 API."""
        old = self.registered
        tasks = list(old.tasks) if old else []
        existing = {t.task_id for t in tasks}
        for t in new_tasks:
            if t.task_id in existing:
                raise ValueError(f"duplicate task_id {t.task_id}")
            existing.add(t.task_id)
            tasks.append(t)
        return self._rebuild(tasks, old)

    def deregister_tasks(self, task_ids: Sequence[str]) -> RegisteredTasks:
        old = self.registered
        if old is None:
            raise ValueError("no task is registered")
        drop = set(task_ids)
        return self._rebuild([t for t in old.tasks if t.task_id not in drop], old)

    def compact(self) -> RegisteredTasks:
        """Re-pack slots densely and shrink capacities to the live task set,
        freeing departed tenants' adapter and moment memory.  Stack ranks do
        not shrink.  Every cached step is invalidated by the shape change."""
        old = self.registered
        if old is None:
            raise ValueError("no task is registered")
        return self._rebuild(list(old.tasks), old, compact=True)

    # ------------------------------------------------------------------

    def _slot_plan(self, tasks: List[PEFTTask], old: Optional[RegisteredTasks]):
        """Slot-stable assignment: survivors keep their slots, new tasks take
        the lowest free slot; a full stack doubles its capacity."""
        old_ids = {t.task_id: i for i, t in enumerate(old.tasks)} if old else {}
        slots = np.full((len(tasks),), -1, np.int32)
        used: Dict[str, set] = {}
        for i, t in enumerate(tasks):
            kind = t.adapter.kind
            used.setdefault(kind, set())
            if old is not None and t.task_id in old_ids:
                oi = old_ids[t.task_id]
                if old.tasks[oi].adapter.kind != kind:
                    continue
                s = int(old.mta.task_slot[oi])
                slots[i] = s
                used[kind].add(s)
        caps = dict(self._kind_capacity)
        if self.capacity_floor:
            for kind in {t.adapter.kind for t in tasks}:
                caps[kind] = max(caps.get(kind, 0), self.capacity_floor)
        for i, t in enumerate(tasks):
            if slots[i] >= 0:
                continue
            kind = t.adapter.kind
            cap = caps.get(kind, 0)
            free = [s for s in range(cap) if s not in used[kind]]
            if free:
                s = free[0]
            else:
                s = max(used[kind], default=-1) + 1
                caps[kind] = max(cap * 2, s + 1)  # amortized growth
            slots[i] = s
            used[kind].add(s)
        # drop the floors of kinds with no live task
        live = {t.adapter.kind for t in tasks}
        caps = {k: v for k, v in caps.items() if k in live}
        ranks = {k: v for k, v in self._kind_rank.items() if k in live}
        return slots, caps, ranks

    def _rebuild(self, tasks: List[PEFTTask], old: Optional[RegisteredTasks],
                 compact: bool = False) -> RegisteredTasks:
        if compact:
            # dense re-pack: default slots, capacities = live counts
            live = {t.adapter.kind for t in tasks}
            slots, caps = None, None
            ranks = {k: v for k, v in self._kind_rank.items() if k in live}
        else:
            slots, caps, ranks = self._slot_plan(tasks, old)
        mta = MultiTaskAdapters(self.cfg, [t.adapter for t in tasks], kind_capacity=caps,
                                kind_rank=ranks, task_slot=slots, device=self.device)
        self._kind_capacity = dict(mta.kind_capacity)
        self._kind_rank = dict(mta.kind_rank)
        params = mta.init(self.generator)
        if tasks:
            opt = adamw_init(params)
        else:  # no leaf: the moments keep the tree's (empty) structure
            none = tree_map(lambda p: None, params)
            opt = AdamWState(torch.zeros((), dtype=torch.int32, device=self.device), none, none)
        if old is not None and old.tasks and tasks:
            params, opt = self._migrate(old, mta, params, opt, tasks)
        self.registered = RegisteredTasks(tasks, mta, params, opt)
        return self.registered

    def _migrate(self, old: RegisteredTasks, new_mta: MultiTaskAdapters, new_params: Any,
                 new_opt: AdamWState, tasks: List[PEFTTask]) -> Tuple[Any, AdamWState]:
        """Copy surviving tasks' adapter values and moments into the new
        stacks (into the leading slice where the stack rank grew)."""
        old_ids = {t.task_id: i for i, t in enumerate(old.tasks)}

        def slot_map(kind: str) -> Dict[int, int]:
            out = {}
            for i, t in enumerate(tasks):
                oi = old_ids.get(t.task_id)
                if t.adapter.kind != kind or oi is None or old.tasks[oi].adapter.kind != kind:
                    continue
                out[int(new_mta.task_slot[i])] = int(old.mta.task_slot[oi])
            return out

        def copy_leaf(new_leaf, old_leaf, kind, ax, slots, name):
            if old_leaf is None or new_leaf is None:
                return new_leaf
            if shared_leaf(kind, name):
                # shared frozen leaf: its deterministic init is the value
                return new_leaf
            old_tail = tuple(old_leaf.shape[ax + 1:])
            new_tail = tuple(new_leaf.shape[ax + 1:])
            grows = (len(new_tail) == len(old_tail)
                     and all(n >= o for n, o in zip(new_tail, old_tail)))
            if tuple(new_leaf.shape[:ax]) != tuple(old_leaf.shape[:ax]) or not grows:
                return new_leaf  # incompatible shape: keep the fresh init
            for ns, os_ in slots.items():
                idx = (slice(None),) * ax + (ns,) + tuple(slice(0, o) for o in old_tail)
                new_leaf[idx] = old_leaf.select(ax, os_).to(new_leaf.dtype)
            return new_leaf

        def merge(new_node, old_node, kind, ax, slots, name=None):
            # structure-tolerant: keys only the new stack has stay fresh
            if not isinstance(new_node, dict):
                return copy_leaf(new_node, old_node, kind, ax, slots, name)
            if not isinstance(old_node, dict):
                return new_node
            return {k: merge(v, old_node[k], kind, ax, slots, k) if k in old_node else v
                    for k, v in new_node.items()}

        def walk(new_p, old_p, depth):
            if not isinstance(new_p, dict) or not isinstance(old_p, dict):
                return new_p
            out = dict(new_p)
            for kind in new_p:
                if kind not in old_p or kind not in new_mta.kind_tasks:
                    continue
                slots = slot_map(kind)
                if slots:
                    out[kind] = merge(new_p[kind], old_p[kind], kind, depth, slots)
            return out

        depths = _group_depths(self.cfg)
        trees = (new_params, new_opt.m, new_opt.v)
        olds = (old.adapter_params, old.opt_state.m, old.opt_state.v)
        if "" in depths:
            p, m, v = (walk(n, o, depths[""]) for n, o in zip(trees, olds))
        else:
            p, m, v = ({gk: walk(n[gk], o.get(gk), d) for gk, d in depths.items() if gk in n}
                       for n, o in zip(trees, olds))
        return p, AdamWState(new_opt.step, m, v)
