"""PEFTEngine: executes an ExecutionPlan as multi-task steps (§3.1) and
serves the fused decode pool (port of ``repro.core.engine``).

Spatial multiplexing = one fused batch per hTask (grouped adapters, shared
backbone).  Temporal multiplexing = template-ordered execution of bucket
micro-batches.  The engine is built from a ``ModelGenerator`` (backbone and
registered adapters) and the plan of the same task list.

Per-task optimizer isolation: losses are per-task means summed (so the
gradients are exactly the per-task gradients — Eq. 1-2), per-task learning
rates enter as lr-scale trees, and member-slot masks confine every update —
values, AdamW moments and bias-correction step counts — to the slots of the
tasks present in the micro-batch.  A NaN guard zeroes a step's update
without touching any task's state.  Masks and guard are ``torch.where`` on
the device.

The iteration loop has one host sync: the loss and the per-task sums
accumulate on the device and are read once at the end; batches go to the
device through a two-deep queue of non-blocking copies.  Gradients are
taken with respect to the adapter leaves only: the backbone has
``requires_grad=False``.  Compiled steps are cached by hTask signature in
the JAX package; here the cache holds each hTask's step closure (its
routing tensors, masks and loss reduction), built once.

On a CUDA device every adapter projection and every attention runs the
hand-written kernels (``repro_torch.kernels``), forward and backward.

Online serving (task churn): ``attach_tasks`` / ``detach_tasks`` swap in a
new plan; step closures whose hTask signature survives the change are
reused (``cache_hits`` / ``cache_misses`` count the lookups), and
surviving tenants keep their adapter values, moments and per-slot step
counts.  ``run_iteration(interleave=...)`` calls a hook after each training
micro step's dispatch, where the co-serving scheduler enqueues decode work
on the same stream; it adds no host sync.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.registry import ModelGenerator, RegisteredTasks, _group_depths
from repro_torch.launch import steps
from repro_torch.obs.tracing import span
from repro_torch.peft.methods import shared_leaf
from repro_torch.train.optimizer import (
    adamw_update,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclass
class StepMetrics:
    loss: float
    per_task_loss: np.ndarray
    tokens: int
    effective_tokens: int
    wall_seconds: float
    # co-serving (token-level decode interleave): zero when no inference
    # traffic rode along with this training iteration
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    decode_p50_s: float = 0.0   # windowed per-token latency percentiles
    decode_p99_s: float = 0.0
    decode_micro_steps: int = 0  # fused micro steps in the timed segment

    @property
    def decode_token_seconds(self) -> float:
        """Mean wall seconds per decode token of this iteration's batch: the
        decode-side channel ``cost_model.calibrate_profile(decode_samples=)``
        fits."""
        return self.decode_seconds / max(self.decode_tokens, 1)


class PEFTEngine:
    def __init__(self, gen: ModelGenerator, plan: ExecutionPlan, lr: float = 1e-4,
                 aux_coef: float = 1e-3, device="cuda"):
        self.device = resolve_device(device)
        if gen.device != self.device:
            raise ValueError(f"generator on {gen.device}, engine on {self.device}")
        if gen.registered is None:
            raise ValueError("register_tasks() first")
        self.gen = gen
        self.model = gen.model
        self.plan = plan
        self.lr = lr
        self.aux_coef = aux_coef
        self.backbone = gen.init_backbone()
        self.reg: RegisteredTasks = gen.registered
        self._check_alignment()
        self._steps: Dict[Tuple, Callable] = {}   # hTask signature -> step
        self.cache_hits = 0
        self.cache_misses = 0
        self._adapter_sig = self._adapter_shape_sig()
        self._lr_scales = self._build_lr_scales()
        self._slot_steps = self._fresh_slot_steps()
        self._member_ids = self._build_member_ids()
        self._decode_pool: Optional[Dict[str, Any]] = None
        self._decode_geom: Optional[tuple] = None  # (rows, max_len, cap, prefix)
        # the pool rows bound with temp > 0, kept on the host so that a
        # greedy micro step reads nothing back from the device
        self._decode_sampled: List[int] = []
        # the pool's step closures, rebuilt with the training step cache
        # (adapter-stack shape changes), not on churn
        self._decode_fns: Dict[Any, Callable] = {}
        self.decode_pool_gen = 0  # bumps when the pool is (re)allocated

    # ------------------------------------------------------------------

    def _check_alignment(self) -> None:
        plan_ids = [t.task_id for t in self.plan.tasks]
        reg_ids = [t.task_id for t in self.reg.tasks]
        if plan_ids != reg_ids:
            raise ValueError(f"plan/registry task order mismatch: {plan_ids} vs {reg_ids}")

    def _adapter_shape_sig(self) -> Tuple:
        out = []

        def walk(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    out.append((path + (k,), tuple(v.shape), str(v.dtype)))

        walk(self.reg.adapter_params, ())
        return tuple(out)

    def _fresh_slot_steps(self) -> Dict[str, torch.Tensor]:
        mta = self.reg.mta
        return {kind: torch.zeros((mta.kind_capacity[kind],), dtype=torch.float32,
                                  device=self.device)
                for kind in mta.kind_tasks}

    def _build_member_ids(self) -> Dict[int, torch.Tensor]:
        """Per-hTask device-resident global member indices (for the on-device
        local -> global loss scatter)."""
        return {i: torch.as_tensor(np.asarray(h.task_ids, np.int64), device=self.device)
                for i, h in enumerate(self.plan.htasks)}

    def _broadcast_slots(self, vecs: Dict[str, Any]) -> Any:
        """Expand per-kind slot vectors [capacity] into a tree aligned with
        the adapter params, each leaf shaped to broadcast along the leaf's
        task axis, which follows its group's layer dims.  Leaves a method
        declares shared (no task axis) get a scalar 0.0, which as a mask or
        lr-scale freezes them."""
        mta = self.reg.mta
        depths = _group_depths(self.gen.cfg)
        params = self.reg.adapter_params

        def walk(tree: Any, depth: int, kind: Optional[str] = None, name=None):
            if not isinstance(tree, dict):
                if kind is None or kind not in vecs:
                    return None
                if name is not None and shared_leaf(kind, name):
                    return torch.zeros((), dtype=torch.float32, device=self.device)
                v = torch.as_tensor(vecs[kind], dtype=torch.float32, device=self.device)
                shape = [1] * tree.dim()
                shape[depth] = v.shape[0]
                return v.reshape(shape)
            return {k: walk(sub, depth, k if k in mta.kind_tasks else kind, k)
                    for k, sub in tree.items()}

        if "" in depths:
            return walk(params, depths[""])
        return {group: walk(params[group], d) for group, d in depths.items()}

    def _build_lr_scales(self):
        """Per-slot lr multipliers broadcast along each leaf's task axis."""
        mta = self.reg.mta
        vecs = {kind: mta.slot_values(kind, {i: mta.task_cfgs[i].lr for i in ids},
                                      fill=self.lr) / self.lr
                for kind, ids in mta.kind_tasks.items()}
        return self._broadcast_slots(vecs)

    # ------------------------------------------------------------------
    # Task churn: incremental re-plan (§3.2 online path)

    def attach_tasks(self, new_tasks: Sequence, plan: ExecutionPlan) -> None:
        """Hot-attach tenants (fresh adapters and zero moments at free
        slots) and swap to ``plan``.  Steps whose signature is unchanged are
        reused."""
        old_reg = self.reg
        self.reg = self.gen.register_tasks(new_tasks)
        self._after_rebuild(old_reg, plan)

    def detach_tasks(self, task_ids: Sequence[str], plan: ExecutionPlan,
                     compact: bool = False) -> None:
        """Detach tenants; their slots are freed for reuse.  ``compact=True``
        re-packs the stacks densely, freeing the departed tenants' adapter
        and moment memory, at the cost of rebuilding every step."""
        old_reg = self.reg
        self.reg = self.gen.deregister_tasks(task_ids)
        if compact:
            self.reg = self.gen.compact()
        self._after_rebuild(old_reg, plan)

    def _after_rebuild(self, old_reg: RegisteredTasks, plan: ExecutionPlan) -> None:
        self.plan = plan
        self._check_alignment()
        new_sig = self._adapter_shape_sig()
        if new_sig != self._adapter_sig:
            self._steps.clear()        # stack shapes changed: every step is stale
            self._decode_fns.clear()   # the decode steps close over the stacks too
            self._adapter_sig = new_sig
        self._lr_scales = self._build_lr_scales()
        self._slot_steps = self._carry_slot_steps(old_reg)
        self._member_ids = self._build_member_ids()

    def _carry_slot_steps(self, old_reg: RegisteredTasks) -> Dict[str, torch.Tensor]:
        """Carry surviving tasks' per-slot update counts across a rebuild."""
        old_vecs = {k: v.cpu().numpy() for k, v in self._slot_steps.items()}
        old_ids = {t.task_id: i for i, t in enumerate(old_reg.tasks)}
        mta = self.reg.mta
        out = {}
        for kind, ids in mta.kind_tasks.items():
            vec = np.zeros((mta.kind_capacity[kind],), np.float32)
            old_vec = old_vecs.get(kind)
            for i in ids:
                oi = old_ids.get(self.reg.tasks[i].task_id)
                if oi is None or old_reg.tasks[oi].adapter.kind != kind or old_vec is None:
                    continue
                vec[int(mta.task_slot[i])] = old_vec[int(old_reg.mta.task_slot[oi])]
            out[kind] = torch.as_tensor(vec, device=self.device)
        return out

    # ------------------------------------------------------------------

    def step_signature(self, htask_idx: int) -> Tuple:
        """Step identity, free of global task indices: batch geometry, each
        row's (kind, slot), each member's hyperparameters and the adapter
        stack shapes."""
        h = self.plan.htasks[htask_idx]
        seg = self.plan.segments_for(htask_idx)
        mta = self.reg.mta
        row_sig = tuple((mta.task_cfgs[t].kind, int(mta.task_slot[t])) for t in seg.row_task)
        mem_sig = tuple(
            (mta.task_cfgs[t].kind, int(mta.task_slot[t]), mta.task_cfgs[t].rank,
             float(mta.task_cfgs[t].scale), float(mta.task_cfgs[t].lr),
             tuple(sorted(mta.task_cfgs[t].targets)))
            for t in h.task_ids)
        return (h.rows, h.row_len, row_sig, mem_sig, self._adapter_sig)

    def _loss_and_grads_fn(self, htask_idx: int) -> Callable:
        """``(adapters, backbone, batch) -> (loss, per-task losses, grads)``
        of one hTask's fused batch: the sum of the members' mean losses and
        its gradient with respect to every floating adapter leaf (zeros for
        a leaf no row reached, as for VeRA's frozen A / B; None for an
        integer leaf)."""
        h = self.plan.htasks[htask_idx]
        segments = self.plan.segments_for(htask_idx)
        local_seg = segments.relabel(h.task_ids)
        one_hot = local_seg.one_hot(self.device)
        ctxf = self.reg.mta.ctx_factory(segments)
        model, aux_coef = self.model, self.aux_coef

        def loss_and_grads(adapters, backbone, batch):
            # integer leaves (Diff-Pruning's rows) take no gradient: they pass
            # through, and their gradient leaf is None
            leaves = [t.detach().requires_grad_(True) if t.is_floating_point() else t
                      for t in tree_leaves(adapters)]
            with torch.enable_grad():
                out = model.forward(backbone, batch, adapters=tree_unflatten(adapters, leaves),
                                    ctx_factory=ctxf)
                pt = local_seg.per_task_loss(out["per_token_loss"], batch["loss_mask"],
                                             one_hot)
                loss = pt.sum()
                for k, v in out["aux"].items():
                    if k == "moe_load_balance":
                        loss = loss + aux_coef * v
                got = iter(torch.autograd.grad(loss, [l for l in leaves if l.requires_grad],
                                               allow_unused=True))
            grads = []
            for leaf in leaves:
                g = next(got) if leaf.requires_grad else None
                grads.append(torch.zeros_like(leaf) if leaf.requires_grad and g is None else g)
            grads = tree_unflatten(adapters, grads)
            return loss.detach(), pt.detach(), grads

        return loss_and_grads

    def _make_step(self, htask_idx: int) -> Callable:
        h = self.plan.htasks[htask_idx]
        loss_and_grads = self._loss_and_grads_fn(htask_idx)
        lr, lr_scales = self.lr, self._lr_scales
        mta = self.reg.mta
        # member masks: 1.0 at member slots, 0 elsewhere — confine update,
        # moments and step counts to the tasks present in this micro-batch
        member_slots: Dict[str, set] = {}
        for t in h.task_ids:
            member_slots.setdefault(mta.task_cfgs[t].kind, set()).add(int(mta.task_slot[t]))
        mask_vecs = {
            kind: torch.as_tensor([1.0 if s in member_slots.get(kind, ()) else 0.0
                                   for s in range(mta.kind_capacity[kind])],
                                  dtype=torch.float32, device=self.device)
            for kind in mta.kind_tasks}
        masks = self._broadcast_slots(mask_vecs)

        def step(backbone, adapters, opt_state, slot_steps, batch, member_ids, acc):
            loss, pt, grads = loss_and_grads(adapters, backbone, batch)
            finite = torch.isfinite(loss)
            # NaN guard composes with member masking: a diverging step keeps
            # non-members untouched by construction and reverts members
            counts = {k: torch.where(finite, v + mask_vecs[k], v) for k, v in slot_steps.items()}
            updates, new_opt = adamw_update(grads, opt_state, adapters, lr=lr,
                                            lr_scales=lr_scales,
                                            step_counts=self._broadcast_slots(counts))
            updates = tree_map(
                lambda u, mk: torch.where(finite, u * mk.to(u.dtype), torch.zeros_like(u)),
                updates, masks)

            def guard_moment(new, old, mk):
                return torch.where(finite & (mk > 0), new, old)

            new_opt = new_opt._replace(m=tree_map(guard_moment, new_opt.m, opt_state.m, masks),
                                       v=tree_map(guard_moment, new_opt.v, opt_state.v, masks))
            adapters = apply_updates(adapters, updates)
            total, pt_acc = acc
            return adapters, new_opt, counts, (total + loss, pt_acc.index_add(0, member_ids, pt))

        return step

    def _step_for(self, htask_idx: int) -> Callable:
        key = self.step_signature(htask_idx)
        if key not in self._steps:
            self._steps[key] = self._make_step(htask_idx)
            self.cache_misses += 1
        else:
            self.cache_hits += 1
        return self._steps[key]

    def _schedule(self, n_micro: Optional[int]) -> List[int]:
        """hTask launch order for one iteration (template order).

        ``n_micro=None`` follows the planner's template verbatim.  An
        explicit ``n_micro`` is honored per bucket: each bucket runs exactly
        ``n_micro`` micro-steps — template entries beyond that are
        truncated, buckets the template under-covers are repeated."""
        buckets = self.plan.template.buckets
        order = [m.bucket for m in self.plan.template.micro_order]
        if n_micro is not None:
            counts = [0] * len(buckets)
            kept: List[int] = []
            for b in order:
                if counts[b] < n_micro:
                    counts[b] += 1
                    kept.append(b)
            for b in range(len(buckets)):
                kept.extend([b] * (n_micro - counts[b]))
            order = kept
        return [hid for b in order for hid in buckets[b].htask_ids]

    def run_iteration(self, loaders: Dict[int, Iterator], n_micro: Optional[int] = None,
                      interleave: Optional[Callable[[], None]] = None) -> StepMetrics:
        """One training iteration: all buckets, template order.  Micro steps
        enqueue back to back; the one device -> host transfer is the read of
        the accumulated loss and per-task sums at the end.

        ``interleave`` (token-level co-serving): called after every training
        micro step's dispatch.  It may enqueue decode work
        (``dispatch_decode_micro``, a bind) on the same stream, between the
        training micro steps, without a host sync.

        The loop is span-instrumented (``engine.iteration``,
        ``engine.prefetch``, ``engine.micro_step``, ``engine.sync`` on the
        ``engine`` track); with tracing off every site is one shared no-op."""
        with span("engine.iteration", track="engine"):
            t0 = time.perf_counter()
            schedule = self._schedule(n_micro)
            # per-task accumulator sized to the total slot capacity; sliced to
            # the live tasks on the host
            n_acc = max(len(self.plan.tasks), sum(self.reg.mta.kind_capacity.values()))
            acc = (torch.zeros((), dtype=torch.float32, device=self.device),
                   torch.zeros((n_acc,), dtype=torch.float32, device=self.device))
            tokens = eff = 0
            batches = steps.prefetch_to_device((next(loaders[h]) for h in schedule),
                                               self.device)
            for hid in schedule:
                with span("engine.prefetch", track="engine"):
                    batch = next(batches, None)
                if batch is None:
                    break
                step = self._step_for(hid)
                with span("engine.micro_step", track="engine"):
                    (self.reg.adapter_params, self.reg.opt_state, self._slot_steps,
                     acc) = step(self.backbone, self.reg.adapter_params, self.reg.opt_state,
                                 self._slot_steps, batch, self._member_ids[hid], acc)
                h = self.plan.htasks[hid]
                tokens += h.tokens
                eff += h.effective_tokens
                if interleave is not None:
                    interleave()
            # the iteration's single host sync
            with span("engine.sync", track="engine"):
                got = torch.cat([acc[0].reshape(1), acc[1]]).cpu().numpy().astype(np.float64)
            dt = time.perf_counter() - t0
        return StepMetrics(float(got[0]), got[1:1 + len(self.plan.tasks)], tokens, eff, dt)

    def throughput(self, metrics: StepMetrics) -> Dict[str, float]:
        return {
            "tokens_per_s": metrics.tokens / max(metrics.wall_seconds, 1e-9),
            "effective_tokens_per_s": metrics.effective_tokens / max(metrics.wall_seconds, 1e-9),
        }

    # ------------------------------------------------------------------
    # Task-aware decode pool (co-serving data plane)

    def decode_prefix_reserve(self) -> int:
        return steps.decode_prefix_reserve(self.reg.mta)

    def ensure_decode_pool(self, rows: int, max_len: int, max_new_cap: int) -> Dict[str, Any]:
        """Allocate (or re-allocate on a geometry change, such as an
        attaching prefix tenant widening the prefix region) the fused decode
        pool.  A re-allocation bumps ``decode_pool_gen``: in-flight rows are
        lost and their requests must be bound again."""
        pres = self.decode_prefix_reserve()
        geom = (rows, max_len, max_new_cap, pres)
        if self._decode_pool is None or self._decode_geom != geom:
            self._decode_pool = steps.init_decode_pool(self.model, rows, max_len,
                                                       max_new_cap, prefix_reserve=pres)
            self._decode_geom = geom
            self._decode_sampled = []
            self._decode_fns.clear()
            self.decode_pool_gen += 1
        return self._decode_pool

    def decode_row_ctx(self, row_task: Sequence[int]):
        """(row_slots, scales) dicts of device tensors for a row -> task map
        (-1 = unbound row)."""
        mta = self.reg.mta
        slots = {k: torch.as_tensor(v, device=self.device)
                 for k, v in mta.decode_row_slots(row_task).items()}
        scales = {k: torch.as_tensor(mta.scales(k), device=self.device) for k in mta.kind_tasks}
        return slots, scales

    def decode_micro_ready(self) -> bool:
        """True once the fused decode micro step has run: latency samples
        taken before then include its first launch (on the card, the
        kernels' build) and stay out of the SLO p50/p99 window."""
        return "micro" in self._decode_fns

    def _decode_fn(self, key, make) -> Callable:
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = self._decode_fns[key] = make()
        return fn

    def dispatch_decode_micro(self, row_slots, scales) -> None:
        """One fused decode token for the pool (no host sync of its own
        unless a row samples): interleavable between training micro steps."""
        fn = self._decode_fn("micro", lambda: steps.build_decode_micro_step(
            self.model, self.reg.mta, self._decode_geom[3]))
        with span("decode.micro_step", track="engine"):
            self._decode_pool = fn(self.backbone, self.reg.adapter_params, self._decode_pool,
                                   row_slots, scales, self._decode_sampled)

    def dispatch_decode_bind(self, row: int, tokens: np.ndarray, length: int, row_slots,
                             scales, max_new: int, sampling=None) -> None:
        """Bind one request to pool row ``row`` (``tokens`` [1, Lp])."""
        self.dispatch_decode_bind_batched(
            np.asarray([row], np.int32), np.asarray(tokens, np.int32),
            np.asarray([length], np.int32), row_slots, scales,
            np.asarray([max_new], np.int32), sampling)

    def dispatch_decode_bind_batched(self, rows, tokens, lengths, row_slots, scales,
                                     max_new, sampling=None) -> None:
        """Bind ``R`` requests in one batched prefill.  ``tokens`` [R, Lp]
        (one prompt bucket); ``row_slots`` are the R bound rows' slots;
        ``sampling`` holds the per-request ``temp``, ``top_k``, ``top_p``
        and ``rng`` seeds [R] (greedy when None)."""
        dev = self.device
        R, Lp = int(np.shape(tokens)[0]), int(np.shape(tokens)[1])
        fn = self._decode_fn("bind", lambda: steps.build_decode_batched_bind_step(
            self.model, self.reg.mta, self._decode_geom[1], self._decode_geom[3]))
        temps = np.zeros((R,), np.float32) if sampling is None else sampling["temp"]
        temps = temps.cpu().numpy() if torch.is_tensor(temps) else np.asarray(temps)
        sampled = [i for i in range(R) if temps[i] > 0]
        bound = [int(r) for r in np.asarray(rows).reshape(-1)]
        self._decode_sampled = sorted([r for r in self._decode_sampled if r not in bound]
                                      + [bound[i] for i in sampled])
        if sampling is None:
            sampling = steps.greedy_sampling(R, dev)
        else:
            sampling = {
                "temp": torch.as_tensor(sampling["temp"], dtype=torch.float32, device=dev),
                "top_k": torch.as_tensor(sampling["top_k"], dtype=torch.int32, device=dev),
                "top_p": torch.as_tensor(sampling["top_p"], dtype=torch.float32, device=dev),
                "rng": torch.as_tensor(sampling["rng"], dtype=torch.int64, device=dev),
            }

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        with span("decode.bind", track="engine", args={"rows": R, "bucket": Lp}):
            self._decode_pool = fn(self.backbone, self.reg.adapter_params, self._decode_pool,
                                   t32(rows), t32(tokens), t32(lengths), row_slots,
                                   scales, t32(max_new), sampling, sampled)

    def decode_accounting(self) -> Dict[str, np.ndarray]:
        """The host sync of the decode pool: small counters only, in one
        device -> host copy."""
        p = self._decode_pool
        with span("decode.accounting_sync", track="engine"):
            got = torch.stack([p["n_out"], p["active"], p["state"]["pos"]]).cpu().numpy()
        return {"n_out": got[0], "active": got[1], "pos": got[2]}

    def decode_outputs(self, row: int) -> np.ndarray:
        """Generated token buffer of one pool row: a host copy, which a later
        bind to the row leaves alone (on the CPU ``.cpu()`` is no copy)."""
        return self._decode_pool["out"][row].cpu().numpy().copy()
