"""MuxTuneService: the online multi-tenant fine-tuning controller (port of
``repro.serve.service``; ``device="cuda"`` unless the caller names the CPU).

The offline half of the system (planner + engine) compiles ONE static task
set; this module is the datacenter-service half: tenants arrive, train,
cancel and complete against a single running ``PEFTEngine`` instance.

Control plane per event:
  submit  -> admission gate (Eq. 5 memory + saturation curve) -> hot-attach
             (fresh adapter at a free stack slot, zero moments) or bounded
             priority wait queue;
  cancel  -> de-queue, or detach a resident tenant (no checkpoint);
  step    -> one engine iteration over the current plan; tenants reaching
             their target step count complete: their adapter slice is
             checkpointed out atomically (``distributed.checkpoint``), the
             slot + moments are freed, and the wait queue re-drains.

Every census change re-plans (pure host arithmetic) and swaps the plan into
the engine via ``attach_tasks``/``detach_tasks`` — step closures of
buckets whose hTask signature survives the change are reused, and surviving
tenants carry adapter values, AdamW moments and per-slot step counts across
the boundary, so their optimization trajectory is EXACTLY what a solo run
would produce on the same data.

Per-tenant accounting (queue wait, iterations, tokens, effective-token
ratio, makespan, loss history) is kept in ``TenantRecord``s.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.core.cost_model import HardwareProfile, calibrate_profile
from repro_torch.core.engine import PEFTEngine, StepMetrics
from repro_torch.core.planner import ExecutionPlan, ExecutionPlanner
from repro_torch.core.registry import ModelGenerator, load_task_tree, slice_task_tree
from repro_torch.core.task import ParallelismSpec, PEFTTask
from repro_torch.data.loader import HTaskLoader
from repro_torch.data.synthetic import token_stream
from repro_torch.distributed.checkpoint import CheckpointStore
from repro_torch.train.optimizer import AdamWState
from repro_torch.obs.telemetry import TelemetryRegistry
from repro_torch.obs.tracing import instant, span
from repro_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    WaitQueue,
)
from repro_torch.serve.inference import (
    CoServeConfig,
    DecodeScheduler,
    InferenceRequest,
)
from repro_torch.serve.spec import (
    TenantSpec,
    coerce_request_spec,
    coerce_tenant_spec,
)

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
CANCELLED = "cancelled"
REJECTED = "rejected"
MIGRATED = "migrated"  # moved to another instance (fleet tier)
LOST = "lost"          # instance died with the tenant attached (fleet tier)


@dataclass
class MigrationTicket:
    """In-process handoff bundle for live tenant migration between instances.

    Produced by ``release_tenant`` on the source instance and consumed by
    ``migrate_in`` on the target.  Besides the checkpoint directory (adapter
    slice + AdamW moment slices + per-slot step count, written atomically by
    ``checkpoint_out_tenant``), it carries the tenant's LIVE token-stream
    generator — the target continues the training-data sequence exactly
    where the source left off, which is what makes the post-migration loss
    trajectory solo-parity — plus the drained inference requests awaiting
    re-binding and the accounting the target record inherits.

    Crash recovery builds the same ticket WITHOUT a cooperating
    source: the spec comes from the submission record, the
    checkpoint directory is the tenant's latest committed cadence artifact
    (None = nothing committed yet, cold restart), ``stream`` is None (a
    fresh data stream — matching a solo restart from the same artifact)
    and the requests are re-created from their ``RequestSpec`` records."""

    spec: TenantSpec
    ckpt_dir: Optional[str]
    steps_trained: int
    tokens: int
    effective_tokens: int
    decode_tokens: int
    losses: List[float]
    stream: Any
    requests: List[InferenceRequest]
    source_clock: int
    # the source stack's rank for the task's kind: the tenant TRAINED at
    # this width (rank-padded by co-residents), so the target's stack must
    # open at least as wide for the artifact to load exactly
    stack_rank: int = 0

    @property
    def task(self) -> PEFTTask:
        return self.spec.task

    @property
    def task_id(self) -> str:
        return self.spec.task_id

    @property
    def priority(self) -> int:
        return self.spec.priority

    @property
    def target_steps(self) -> int:
        return self.spec.target_steps


@dataclass
class TenantRecord:
    spec: TenantSpec
    state: str = QUEUED
    reason: str = ""
    submit_step: int = 0          # service clock at submit
    admit_step: int = -1
    finish_step: int = -1
    steps_trained: int = 0
    tokens: int = 0               # padded tokens billed to this tenant
    effective_tokens: int = 0     # non-padding tokens actually trained
    decode_tokens: int = 0        # co-served inference tokens (all effective)
    losses: List[float] = field(default_factory=list)
    checkpoint_path: Optional[str] = None

    @property
    def task(self) -> PEFTTask:
        return self.spec.task

    @property
    def priority(self) -> int:
        return self.spec.priority

    @property
    def target_steps(self) -> int:
        return self.spec.target_steps

    @property
    def warm_start_dir(self) -> Optional[str]:
        return self.spec.warm_start_dir

    @property
    def task_id(self) -> str:
        return self.spec.task_id

    @property
    def queue_wait(self) -> int:
        if self.admit_step < 0:
            return -1
        return self.admit_step - self.submit_step

    @property
    def makespan(self) -> int:
        if self.finish_step < 0:
            return -1
        return self.finish_step - self.submit_step

    @property
    def effective_token_ratio(self) -> float:
        return self.effective_tokens / max(self.tokens, 1)

    def accounting(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id,
            "state": self.state,
            "queue_wait": self.queue_wait,
            "steps_trained": self.steps_trained,
            "tokens": self.tokens,
            "effective_tokens": self.effective_tokens,
            "decode_tokens": self.decode_tokens,
            "effective_token_ratio": round(self.effective_token_ratio, 4),
            "makespan": self.makespan,
            "final_loss": self.losses[-1] if self.losses else None,
            "checkpoint": self.checkpoint_path,
        }


class MuxTuneService:
    def __init__(
        self,
        cfg: ArchConfig,
        parallelism: Optional[ParallelismSpec] = None,
        lr: float = 1e-3,
        n_micro: int = 1,
        enable_fusion: bool = True,
        hw: Optional[HardwareProfile] = None,
        admission: Optional[AdmissionConfig] = None,
        ckpt_dir: Optional[str] = None,
        seed: int = 0,
        reserve_slots: int = 0,
        compact_threshold: float = 0.5,
        coserve: Optional[CoServeConfig] = None,
        auto_recalibrate: bool = True,
        drift_threshold: float = 1.0,
        drift_window: int = 8,
        telemetry: Optional[TelemetryRegistry] = None,
        fault_dir: Optional[str] = None,
        ckpt_cadence: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.parallelism = parallelism or ParallelismSpec()
        self.lr = lr
        self.n_micro = n_micro
        self.enable_fusion = enable_fusion
        self.admission_config = admission or AdmissionConfig()
        self.planner = ExecutionPlanner(
            cfg, self.parallelism, hw,
            memory_budget=self.admission_config.memory_budget)
        self.admission = AdmissionController(
            cfg, self.parallelism, hw, self.admission_config,
            cost_model_fn=self.planner.cost_model)
        self.ckpt_dir = ckpt_dir
        self.seed = seed
        self.compact_threshold = compact_threshold
        # fault tolerance: every ``ckpt_cadence`` trained steps each
        # resident tenant's full artifact (adapter + AdamW moments + slot
        # step) is committed under <fault_dir>/<task_id> on a background
        # thread — the latest committed artifact is what crash recovery
        # warm-starts from, bounding lost work to one cadence interval
        self.fault_dir = fault_dir
        self.ckpt_cadence = int(ckpt_cadence)
        self._fault_stores: Dict[str, CheckpointStore] = {}

        self.gen = ModelGenerator(cfg, seed=seed, device=device)
        self.device = self.gen.device
        self.gen.capacity_floor = reserve_slots
        self.engine: Optional[PEFTEngine] = None
        self.plan: Optional[ExecutionPlan] = None
        self.clock = 0                      # engine iterations executed
        self.tenants: Dict[str, TenantRecord] = {}
        self.retired: List[TenantRecord] = []  # earlier runs of resubmitters
        self.queue = WaitQueue(self.admission_config.max_queue)
        self._streams: Dict[str, Any] = {}  # task_id -> persistent token gen
        self._loaders: Dict[int, HTaskLoader] = {}
        self._iter_tokens: Dict[str, tuple] = {}  # task_id -> (padded, eff)/iter
        # telemetry registry: the service's per-tenant sensor layer.  The
        # trace buffers below are BOUNDED rings from it (list-like read API,
        # capped writes) — long trace replays no longer grow host memory
        # without bound the way the old ad-hoc Python lists did.
        self.telemetry = telemetry or TelemetryRegistry()
        self._calibration_window = min(256, self.telemetry.ring_cap)
        # Eq. 5 bytes after every census event
        self.memory_trace = self.telemetry.series("service.memory_bytes")
        self.replans = 0
        self._cache_stats = [0, 0]           # hits/misses of retired engines
        # measured (tasks, hTask schedule, wall) per iteration — the raw
        # material for HardwareProfile calibration of the admission gate
        self.calibration_trace = self.telemetry.series(
            "service.calibration", cap=self._calibration_window)
        # decode-side channel: (rows, mean_ctx, per-micro-step seconds) from
        # each warm timed decode segment — fits the "__decode__" scale so
        # token_budget's estimator is calibrated independently of the
        # training-step wall scale
        self.decode_trace = self.telemetry.series(
            "service.decode_samples", cap=self._calibration_window)
        # token-level co-serving: inference decode traffic interleaved with
        # the training iterations under a latency SLO (FlexLLM-style)
        self.coserve = DecodeScheduler(coserve, telemetry=self.telemetry)
        # auto-recalibration on drift: when the predicted-vs-
        # measured iteration-time ratio drifts beyond ``drift_threshold``
        # (median log-ratio error over ``drift_window`` iterations), refit
        # the hardware profile from the rolling StepMetrics window
        self.auto_recalibrate = auto_recalibrate
        self.drift_threshold = drift_threshold
        self.drift_window = drift_window
        self.recalibrations = 0
        self._drift: List[float] = []  # recent measured/predicted ratios
        self._cm_cache = (None, None, None)  # (plan, hw, CostModel)

    # ------------------------------------------------------------------
    # introspection

    @property
    def resident(self) -> List[PEFTTask]:
        return list(self.gen.registered.tasks) if self.gen.registered else []

    @property
    def resident_ids(self) -> List[str]:
        return [t.task_id for t in self.resident]

    def record(self, task_id: str) -> TenantRecord:
        return self.tenants[task_id]

    def accounting(self) -> Dict[str, Any]:
        everyone = self.retired + list(self.tenants.values())
        recs = [r.accounting() for r in everyone]
        done = [r for r in everyone if r.state == COMPLETED]
        waits = [r.queue_wait for r in everyone if r.queue_wait >= 0]
        return {
            "clock": self.clock,
            "replans": self.replans,
            "tenants": recs,
            "completed": len(done),
            "mean_queue_wait": float(np.mean(waits)) if waits else 0.0,
            "cache_hits": self._cache_stats[0] + (
                self.engine.cache_hits if self.engine else 0),
            "cache_misses": self._cache_stats[1] + (
                self.engine.cache_misses if self.engine else 0),
            "peak_stage_memory": max(self.memory_trace, default=0.0),
            "memory_budget": self.admission_config.memory_budget,
            "recalibrations": self.recalibrations,
            "coserve": self.coserve.accounting(),
        }

    # ------------------------------------------------------------------
    # tenant lifecycle

    def submit(self, spec, **legacy) -> TenantRecord:
        """Admit, queue or reject one tenant.  New API: ``submit(TenantSpec)``
        — the legacy ``submit(task, priority=..., target_steps=...,
        warm_start_dir=...)`` form still works for one release (deprecation
        warning)."""
        spec = coerce_tenant_spec(spec, legacy, "MuxTuneService.submit")
        task = spec.task
        if task.task_id in self.tenants:
            prev = self.tenants[task.task_id]
            if prev.state in (QUEUED, RUNNING):
                raise ValueError(f"tenant {task.task_id} already live")
            self.retired.append(prev)  # resubmission keeps prior accounting
        rec = TenantRecord(spec, submit_step=self.clock)
        self.tenants[task.task_id] = rec
        instant("tenant.submit", track=f"tenant:{task.task_id}")
        decision = self.admission.check(self.resident, task)
        if decision:
            self._attach([rec])
            outcome = "admit"
        else:
            rec.reason = decision.reason
            if self.queue.push(rec, spec.priority):
                outcome = "queue"
            else:
                rec.state = REJECTED
                rec.reason = f"queue_full({decision.reason})"
                outcome = "reject"
        # admission decisions are first-class telemetry: the fleet tier's
        # router / autoscaler acts on admit/reject rates and their reasons
        self.telemetry.counter("service.admission", decision=outcome,
                               reason=decision.reason).inc()
        return rec

    def submit_request(self, task_id: str, prompt, **legacy
                       ) -> InferenceRequest:
        """Submit an inference request against a tenant's adapter stack.
        New API: ``submit_request(task_id, RequestSpec(prompt, ...))`` — the
        legacy kwargs form still works for one release.

        The request queues for a decode-pool row and is served token-level
        interleaved with the training iterations (SLO-packed decode
        micro-batches) — or bound mid-iteration when a row is free
        (continuous batching).  Sampling: ``temperature`` 0 is exact greedy;
        ``top_k``/``top_p`` filter the proposal; ``seed`` makes sampled
        generations replayable.  ``slo_class``: lower = higher priority for
        pool rows (FIFO within a class).  The tenant must be (or become)
        resident; requests of a departing tenant are cancelled with
        ``tenant_departed``."""
        spec = coerce_request_spec(prompt, legacy,
                                   "MuxTuneService.submit_request")
        rid = (spec.request_id
               or f"req{len(self.coserve.requests)}-{task_id}")
        req = InferenceRequest.from_spec(spec, task_id, rid,
                                         submit_clock=self.clock)
        if self.cfg.family not in ("dense", "moe"):
            # the bind step's prefill-into-cache needs a full-depth KV stack;
            # reject up front instead of crashing the training iteration the
            # bind would have interleaved into (the hybrid family decodes
            # through Model.decode_step only, as in the JAX package; the JAX
            # package also serves vlm, which the port has not)
            return self.coserve.reject(req, "family_unsupported")
        return self.coserve.submit(req)

    def cancel_request(self, request_id: str) -> InferenceRequest:
        self.coserve.cancel(request_id, self.clock, reason="user_cancel")
        return self.coserve.requests[request_id]

    def cancel(self, task_id: str) -> TenantRecord:
        rec = self.tenants[task_id]
        if rec.state == QUEUED:
            hit = self.queue.remove(lambda r: r.task_id == task_id)
            rec.state = CANCELLED if hit else rec.state
            rec.finish_step = self.clock
        elif rec.state == RUNNING:
            self._detach([rec], checkpoint=False)
            rec.state = CANCELLED
            rec.finish_step = self.clock
        return rec

    # ------------------------------------------------------------------
    # live migration hooks (a fleet controller drives these)

    def drain_tenant(self, task_id: str) -> List[InferenceRequest]:
        """Migration phase 1 (drain): pull the tenant's live decode requests
        out of the scheduler via the pool-generation recovery semantics —
        in-flight rows are freed and the request objects leave this
        scheduler to be adopted on the target.  Nothing is cancelled."""
        rec = self.tenants[task_id]
        if rec.state != RUNNING:
            raise ValueError(f"tenant {task_id} not running ({rec.state})")
        return self.coserve.drain_task(task_id)

    def _tenant_artifact(self, task_id: str, include_optimizer: bool = True):
        """(tree, extra) of one RESIDENT tenant's checkpoint artifact — THE
        layout every checkpoint surface shares: migration
        checkpoint-out, completion checkpoints (adapter-only) and the fault-
        tolerance cadence writes all serialize exactly this through one
        ``CheckpointStore``, so any of them warm-starts any restore path."""
        rec = self.tenants[task_id]
        reg = self.gen.registered
        gi = reg.task_index(task_id)
        kind = rec.task.adapter.kind
        sub: Any = slice_task_tree(self.cfg, reg.mta, reg.adapter_params, gi)
        extra: Dict[str, Any] = {
            "task_id": task_id,
            "steps_trained": rec.steps_trained,
            "losses": rec.losses[-8:],
            "priority": rec.priority,
            "target_steps": rec.target_steps,
            # the rank-padded width the tenant trained at: crash recovery
            # reads this from the manifest to re-open the restoring stack
            # at least as wide (exact warm-start parity)
            "stack_rank": int(reg.mta.kind_rank[kind]),
        }
        if include_optimizer:
            sub = {
                "params": sub,
                "m": slice_task_tree(self.cfg, reg.mta, reg.opt_state.m, gi),
                "v": slice_task_tree(self.cfg, reg.mta, reg.opt_state.v, gi),
            }
            slot = int(reg.mta.task_slot[gi])
            extra["slot_step"] = float(self.engine._slot_steps[kind][slot].cpu())
        return sub, extra

    def checkpoint_out_tenant(self, task_id: str, ckpt_dir: str,
                              include_optimizer: bool = True) -> str:
        """Migration phase 2 (checkpoint out): atomically checkpoint one
        RESIDENT tenant's adapter slice — with ``include_optimizer`` also
        its AdamW moment slices and per-slot step count, the layout a
        migration warm-start restores for an exactly solo-parity loss
        trajectory on the target instance."""
        rec = self.tenants[task_id]
        sub, extra = self._tenant_artifact(task_id, include_optimizer)
        with span("service.checkpoint_out", track="service",
                  args={"task": task_id, "optimizer": include_optimizer}):
            path = CheckpointStore(ckpt_dir).save(rec.steps_trained, sub,
                                                  extra=extra)
        rec.checkpoint_path = path
        self.telemetry.counter("service.checkpoint", direction="out").inc()
        return path

    # ------------------------------------------------------------------
    # fault-tolerance cadence checkpoints

    def fault_store(self, task_id: str) -> Optional[CheckpointStore]:
        """The tenant's cadence-checkpoint store (<fault_dir>/<task_id>),
        or None when the service runs without a fault directory."""
        if not self.fault_dir:
            return None
        st = self._fault_stores.get(task_id)
        if st is None:
            st = CheckpointStore(os.path.join(self.fault_dir, task_id),
                                 keep=2)
            self._fault_stores[task_id] = st
        return st

    def _cadence_checkpoint(self, rec: TenantRecord) -> None:
        """Commit one tenant's full artifact asynchronously: the device
        slices are host-copied now (one sync), serialization and the atomic
        rename happen on the store's background thread — the training loop
        never blocks on checkpoint IO."""
        sub, extra = self._tenant_artifact(rec.task_id,
                                           include_optimizer=True)
        with span("service.checkpoint_cadence", track="service",
                  args={"task": rec.task_id, "step": rec.steps_trained}):
            self.fault_store(rec.task_id).save_async(rec.steps_trained, sub,
                                                     extra=extra)
        self.telemetry.counter("service.checkpoint",
                               direction="cadence").inc()

    def release_tenant(self, task_id: str, ckpt_dir: str,
                       requests: Optional[List[InferenceRequest]] = None,
                       ) -> MigrationTicket:
        """Migration phase 3 (release): detach the tenant WITHOUT the
        completion checkpoint (the migration checkpoint already exists) and
        bundle everything the target needs — including the live token-stream
        generator, so the data sequence continues exactly."""
        rec = self.tenants[task_id]
        if rec.state != RUNNING:
            raise ValueError(f"tenant {task_id} not running ({rec.state})")
        stream = self._streams.get(task_id)
        kind = rec.task.adapter.kind
        ticket = MigrationTicket(
            spec=rec.spec, ckpt_dir=ckpt_dir,
            steps_trained=rec.steps_trained, tokens=rec.tokens,
            effective_tokens=rec.effective_tokens,
            decode_tokens=rec.decode_tokens, losses=list(rec.losses),
            stream=stream, requests=list(requests or []),
            source_clock=self.clock,
            stack_rank=int(self.gen.registered.mta.kind_rank[kind]))
        self._detach([rec], checkpoint=False)
        rec.state = MIGRATED
        rec.reason = "migrated_out"
        rec.finish_step = self.clock
        instant("tenant.migrate_out", track=f"tenant:{task_id}")
        self.telemetry.counter("service.migrations", direction="out").inc()
        return ticket

    def migrate_in(self, ticket: MigrationTicket) -> TenantRecord:
        """Migration phase 4 (warm start): admit a migrated tenant with its
        full optimizer state.  Re-binding the drained inference requests is
        the separate ``adopt_requests`` phase (the protocol's final span)."""
        task = ticket.task
        tid = task.task_id
        if tid in self.tenants:
            prev = self.tenants[tid]
            if prev.state in (QUEUED, RUNNING):
                raise ValueError(f"tenant {tid} already live on target")
            self.retired.append(prev)
        decision = self.admission.check(self.resident, task)
        if not decision:
            raise ValueError(
                f"migration target cannot admit {tid}: {decision.reason}")
        rec = TenantRecord(replace(ticket.spec,
                                   warm_start_dir=ticket.ckpt_dir),
                           submit_step=self.clock)
        rec.steps_trained = ticket.steps_trained
        rec.tokens = ticket.tokens
        rec.effective_tokens = ticket.effective_tokens
        rec.decode_tokens = ticket.decode_tokens
        rec.losses = list(ticket.losses)
        self.tenants[tid] = rec
        if ticket.stream is not None:
            # live stream handoff: _attach's setdefault keeps this generator
            self._streams[tid] = ticket.stream
        if ticket.stack_rank:
            # the tenant trained at the source stack's (rank-padded) width:
            # raise this kind's monotone rank floor so the target stack
            # opens at least that wide and the artifact loads exactly
            kind = task.adapter.kind
            self.gen._kind_rank[kind] = max(
                self.gen._kind_rank.get(kind, 0), ticket.stack_rank)
        instant("tenant.migrate_in", track=f"tenant:{tid}")
        self._attach([rec])
        if rec.reason.startswith("warm_start"):
            raise ValueError(
                f"migration warm-start failed for {tid}: {rec.reason}")
        self.telemetry.counter("service.migrations", direction="in").inc()
        self.telemetry.counter("service.admission", decision="admit",
                               reason=decision.reason).inc()
        return rec

    def adopt_requests(self, requests: List[InferenceRequest]) -> None:
        """Migration phase 5 (re-bind): adopt drained requests from a source
        instance.  They queue for pool rows like fresh submissions — the
        regenerated tokens replay the source's exactly (deterministic
        prompt + seeded sampling against the migrated adapter)."""
        for req in requests:
            req.submit_clock = self.clock
            self.coserve.adopt(req)

    # ------------------------------------------------------------------
    # attach / detach / re-plan

    def _replan(self, tasks: List[PEFTTask]) -> ExecutionPlan:
        with span("service.replan", track="service",
                  args={"tasks": len(tasks)}):
            plan = self.planner.replan(tasks, prev=self.plan,
                                       n_micro=self.n_micro,
                                       enable_fusion=self.enable_fusion)
        self.replans += 1
        self.telemetry.counter("service.replans").inc()
        return plan

    def _attach(self, recs: List[TenantRecord]) -> None:
        new_tasks = [r.task for r in recs]
        prospective = self.resident + new_tasks
        plan = self._replan(prospective)
        if self.engine is None:
            self.gen.register_tasks(new_tasks)
            self.engine = PEFTEngine(self.gen, plan, lr=self.lr, device=self.device)
        else:
            self.engine.attach_tasks(new_tasks, plan)
        self.plan = plan
        for r in recs:
            r.state = RUNNING
            r.admit_step = self.clock
            instant("tenant.attach", track=f"tenant:{r.task_id}")
            # per-tenant footprint + queue wait: the signals a fleet-level
            # placement / migration policy keys on
            self.telemetry.gauge("tenant.eq5_bytes", task=r.task_id).set(
                self.admission.resident_memory([r.task]))
            self.telemetry.histogram("service.queue_wait_iters").observe(
                r.queue_wait)
            self._streams.setdefault(
                r.task_id, token_stream(r.task_id, self.cfg.vocab_size, self.seed))
            if r.warm_start_dir:
                self._warm_start(r)
        self._rebuild_loaders()
        mem = self.admission.resident_memory(self.resident)
        self.memory_trace.append(mem)
        self.telemetry.gauge("service.memory_bytes").set(mem)

    def _warm_start(self, rec: TenantRecord) -> None:
        reg = self.gen.registered
        gi = reg.task_index(rec.task_id)
        like = slice_task_tree(self.cfg, reg.mta, reg.adapter_params, gi)
        # migration checkpoints carry the optimizer-inclusive layout
        # {"params", "m", "v"} (+ per-slot step count in extra): try it
        # first, then fall back to the plain adapter-only artifact of a
        # completed tenant re-submitting
        like_full = {
            "params": like,
            "m": slice_task_tree(self.cfg, reg.mta, reg.opt_state.m, gi),
            "v": slice_task_tree(self.cfg, reg.mta, reg.opt_state.v, gi),
        }
        # strict_shapes=False: the artifact keeps its SAVED rank-pad width
        # (cohort-dependent); load_task_tree owns the adaptation rules
        store = CheckpointStore(rec.warm_start_dir)
        full, res = True, None
        try:
            res = store.restore(like_full, strict_shapes=False)
        except (ValueError, KeyError, IOError):
            res = None
        if res is None:
            full = False
            try:
                res = store.restore(like, strict_shapes=False)
            except (ValueError, KeyError, IOError):
                rec.reason = "warm_start_shape_mismatch"
                return
        if res is None:
            rec.reason = "warm_start_empty"
            return
        _, sub, extra = res
        try:
            if full:
                reg.adapter_params = load_task_tree(
                    self.cfg, reg.mta, reg.adapter_params, gi, sub["params"],
                    strict=True)
                m2 = load_task_tree(self.cfg, reg.mta, reg.opt_state.m, gi,
                                    sub["m"], strict=True)
                v2 = load_task_tree(self.cfg, reg.mta, reg.opt_state.v, gi,
                                    sub["v"], strict=True)
                reg.opt_state = AdamWState(reg.opt_state.step, m2, v2)
                slot_step = (extra or {}).get("slot_step")
                if slot_step is not None and self.engine is not None:
                    # per-slot bias-correction counter: without it the first
                    # post-migration update would rewarm AdamW from step 0
                    # and the loss trajectory would diverge from solo
                    kind = rec.task.adapter.kind
                    slot = int(reg.mta.task_slot[gi])
                    self.engine._slot_steps[kind][slot] = float(slot_step)
            else:
                reg.adapter_params = load_task_tree(self.cfg, reg.mta,
                                                    reg.adapter_params, gi,
                                                    sub, strict=True)
            self.telemetry.counter("service.checkpoint", direction="in").inc()
        except ValueError:
            rec.reason = "warm_start_shape_mismatch"

    def _detach(self, recs: List[TenantRecord], checkpoint: bool) -> None:
        assert self.engine is not None
        if checkpoint and self.ckpt_dir:
            for r in recs:
                # completion artifacts stay adapter-only: a completed tenant
                # resubmits into a DIFFERENT optimizer (moments restart), so
                # only the adapter values travel
                self.checkpoint_out_tenant(
                    r.task_id, f"{self.ckpt_dir}/{r.task_id}",
                    include_optimizer=False)
        ids = [r.task_id for r in recs]
        for tid in ids:
            # join any in-flight cadence write before the tenant leaves, so
            # its last committed artifact is durable (and errors surface)
            st = self._fault_stores.pop(tid, None)
            if st is not None:
                st.wait()
            self._streams.pop(tid, None)
            self.coserve.drop_task(tid, self.clock)
            instant("tenant.detach", track=f"tenant:{tid}")
            # metric isolation under churn: a departed tenant's labeled
            # series must not outlive it (its lifetime accounting stays in
            # the TenantRecord)
            self.telemetry.detach_tenant(tid)
        remaining = [t for t in self.resident if t.task_id not in ids]
        if not remaining:
            # last tenant out: drop the engine (a fresh one boots on the next
            # admission); the backbone stays cached in the generator
            self.gen.deregister_tasks(ids)
            self._cache_stats[0] += self.engine.cache_hits
            self._cache_stats[1] += self.engine.cache_misses
            self.engine = None
            self.plan = None
            self._loaders = {}
        else:
            plan = self._replan(remaining)
            compact = self._occupancy_after(remaining) <= self.compact_threshold
            self.engine.detach_tasks(ids, plan, compact=compact)
            self.plan = plan
            self._rebuild_loaders()
        mem = self.admission.resident_memory(remaining)
        self.memory_trace.append(mem)
        self.telemetry.gauge("service.memory_bytes").set(mem)
        self._drain_queue()

    def _occupancy_after(self, remaining: List[PEFTTask]) -> float:
        """Max per-kind slot occupancy — compaction must only fire when
        EVERY kind's stack is sparse; a cross-kind average would compact
        (and recompile) a cohort whose own stack is still full."""
        caps = self.gen._kind_capacity
        live: Dict[str, int] = {}
        for t in remaining:
            live[t.adapter.kind] = live.get(t.adapter.kind, 0) + 1
        ratios = [live.get(k, 0) / c for k, c in caps.items() if c]
        return max(ratios) if ratios else 1.0

    def _drain_queue(self) -> None:
        """Admit queued tenants that now fit, highest priority first
        (lower-priority tenants may backfill past a blocked head)."""
        admitted: List[TenantRecord] = []
        for rec in list(self.queue.items()):
            decision = self.admission.check(
                self.resident + [a.task for a in admitted], rec.task)
            if decision:
                self.queue.remove(lambda r, t=rec.task_id: r.task_id == t)
                admitted.append(rec)
        if admitted:
            self._attach(admitted)

    def _rebuild_loaders(self) -> None:
        tasks = self.resident
        streams = {i: self._streams[t.task_id] for i, t in enumerate(tasks)}
        self._loaders = {
            i: HTaskLoader(tasks, self.plan.alignment[i], self.cfg.vocab_size,
                           seed=self.seed, streams=streams)
            for i in range(len(self.plan.htasks))
        }
        self._iter_tokens = self._per_iteration_tokens()

    def _per_iteration_tokens(self) -> Dict[str, tuple]:
        """(padded, effective) tokens each tenant trains per iteration under
        the current plan — the billing split of §3.5."""
        counts: Dict[int, int] = {}
        for hid in self.engine._schedule(self.n_micro):
            counts[hid] = counts.get(hid, 0) + 1
        out: Dict[str, list] = {}
        tasks = self.plan.tasks
        for hid, n in counts.items():
            ap = self.plan.alignment[hid]
            for row in ap.rows:
                tid = tasks[row.task].task_id
                eff = sum(s.length for s in row.segments)
                pad, e = out.get(tid, (0, 0))
                out[tid] = (pad + n * ap.row_len, e + n * eff)
        return {k: tuple(v) for k, v in out.items()}

    # ------------------------------------------------------------------
    # data plane

    def step(self) -> Optional[StepMetrics]:
        """One engine iteration for the current resident set, with any
        waiting inference traffic token-level interleaved under the SLO;
        completes tenants that reached their target and re-drains the wait
        queue."""
        with span("service.step", track="service"):
            return self._step()

    def _step(self) -> Optional[StepMetrics]:
        if self.engine is None or not self.resident:
            self.clock += 1
            if len(self.queue):
                self._drain_queue()
            return None
        interleave = None
        task_index = {t.task_id: i for i, t in enumerate(self.plan.tasks)}
        coserving = self.coserve.has_actionable(task_index)
        if coserving:
            self.coserve.prepare(self.engine, task_index, self.clock)
            # request binds (single-row prefills) dispatch through the
            # engine's interleave hook: their device work overlaps the
            # training micro-step queue instead of stalling before it
            interleave = self.coserve.interleave_fn(self.engine)
        metrics = self.engine.run_iteration(self._loaders, n_micro=self.n_micro,
                                            interleave=interleave)
        if coserving:
            self.coserve.flush_binds(self.engine)
            mean_ctx = self.coserve.config.decode_max_len / 2
            k = self.coserve.token_budget(self._cost_model(), mean_ctx,
                                          self.predicted_iteration_seconds())
            dtok, dwall, per_task = self.coserve.run_tokens(
                self.engine, k, self.clock)
            metrics.decode_tokens = dtok
            metrics.decode_seconds = dwall
            metrics.decode_micro_steps = k
            pct = self.coserve.latency_percentiles()
            metrics.decode_p50_s = pct["decode_p50_s"]
            metrics.decode_p99_s = pct["decode_p99_s"]
            for tid, n in per_task.items():
                rec = self.tenants.get(tid)
                if rec is not None:
                    rec.decode_tokens += n
            if self.coserve.last_step_seconds is not None:
                # measured per-micro-step decode seconds from the warm timed
                # segment: the raw material for the "__decode__" scale fit
                self.decode_trace.append((self.coserve.last_step_rows,
                                          mean_ctx,
                                          self.coserve.last_step_seconds))
        if not (coserving and (self.coserve.last_bind_count
                               or self.coserve.last_mid_micros)):
            # bind iterations interleave a prefill (and possibly its jit
            # compile) into the training dispatch queue, and continuous-
            # batching iterations interleave decode micro-steps: their wall
            # is not pure training time and would bias the calibration fit
            # and the drift detector
            self._record_calibration_sample(metrics)
            self._maybe_recalibrate(metrics)
        self.clock += 1
        completed: List[TenantRecord] = []
        for gi, task in enumerate(self.plan.tasks):
            rec = self.tenants[task.task_id]
            rec.steps_trained += 1
            rec.losses.append(float(metrics.per_task_loss[gi]))
            pad, eff = self._iter_tokens.get(task.task_id, (0, 0))
            rec.tokens += pad
            rec.effective_tokens += eff
            if rec.steps_trained >= rec.target_steps:
                completed.append(rec)
        if self.fault_dir and self.ckpt_cadence > 0:
            for task in self.plan.tasks:
                rec = self.tenants[task.task_id]
                # completing tenants get their (durable, synchronous)
                # completion checkpoint in _detach below instead
                if (rec.steps_trained < rec.target_steps
                        and rec.steps_trained % self.ckpt_cadence == 0):
                    self._cadence_checkpoint(rec)
        if completed:
            for r in completed:
                r.state = COMPLETED
                r.finish_step = self.clock
            self._detach(completed, checkpoint=True)
        return metrics

    def run(self, max_iters: int = 1000) -> Dict[str, Any]:
        """Step until every live tenant drains (or ``max_iters``)."""
        for _ in range(max_iters):
            if not self.resident and not len(self.queue):
                break
            self.step()
        return self.accounting()

    # ------------------------------------------------------------------
    # hardware calibration (measured StepMetrics -> admission gate)

    def _htask_counts(self) -> List[tuple]:
        """(hTask, micro-steps) actually executed per iteration of the
        current plan — the schedule the cost model predicts against."""
        counts: Dict[int, int] = {}
        for hid in self.engine._schedule(self.n_micro):
            counts[hid] = counts.get(hid, 0) + 1
        return [(self.plan.htasks[h], n) for h, n in counts.items()]

    def _record_calibration_sample(self, metrics: StepMetrics) -> None:
        # the ring caps itself at the calibration window — no manual trim
        self.calibration_trace.append((
            tuple(self.plan.tasks), tuple(self._htask_counts()),
            metrics.wall_seconds,
        ))

    def _maybe_recalibrate(self, metrics: StepMetrics) -> None:
        """Auto-recalibration on drift: refit the hardware profile
        from the rolling StepMetrics window when the measured/predicted
        iteration-time ratio's window median drifts beyond the threshold —
        e.g. after a backend change, noisy-neighbor contention, or the
        first iterations of a cold service whose analytic profile is wrong
        for the hardware it actually landed on."""
        if not self.auto_recalibrate:
            return
        pred = self.predicted_iteration_seconds()
        if pred <= 0.0 or metrics.wall_seconds <= 0.0:
            return
        self._drift.append(metrics.wall_seconds / pred)
        if len(self._drift) > self.drift_window:
            del self._drift[:-self.drift_window]
        if len(self._drift) < self.drift_window:
            return
        err = abs(float(np.log(np.median(self._drift))))
        if err > float(np.log1p(self.drift_threshold)):
            # refit on the DRIFTED window only: the long trace still holds
            # pre-drift (or compile-transient) walls that would drag the
            # least-squares scale back toward the regime we just left
            self.calibrate(window=self.drift_window)
            self.recalibrations += 1
            self._drift.clear()

    def calibrate(self, window: Optional[int] = None) -> HardwareProfile:
        """Fit the cost model's saturation knee + analytic->wall scale to the
        measured ``StepMetrics`` of recent iterations and install the fitted
        profile into BOTH the planner and the admission controller — the
        saturation gate then tracks the hardware this service actually runs
        on (Fig. 9b on real timings) instead of the analytic roofline."""
        samples = self.calibration_trace[-(window or self._calibration_window):]
        dsamples = self.decode_trace[-(window or self._calibration_window):]
        with span("service.calibrate", track="service",
                  args={"samples": len(samples)}):
            hw = calibrate_profile(self.cfg, self.parallelism, samples,
                                   base_hw=self.planner.hw,
                                   decode_samples=dsamples)
        self.telemetry.counter("service.calibration_refits").inc()
        self.planner.hw = hw
        self.admission.hw = hw
        return hw

    def _cost_model(self):
        """Cost model of the CURRENT plan under the CURRENT profile, cached
        — the serving hot loop consults it several times per iteration and
        it only changes on re-plan or recalibration."""
        plan, hw, cm = self._cm_cache
        if plan is not self.plan or hw is not self.planner.hw:
            cm = self.planner.cost_model(self.plan.tasks)
            self._cm_cache = (self.plan, self.planner.hw, cm)
        return cm

    def predicted_iteration_seconds(self) -> float:
        """Current plan's predicted wall time per iteration under the (poss.
        calibrated) profile — compare against StepMetrics.wall_seconds."""
        if self.plan is None or self.engine is None:
            return 0.0
        return self._cost_model().schedule_latency(self._htask_counts())
