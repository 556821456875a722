"""Fleet-wide admission router over N in-process MuxTuneService instances
(port of ``repro.fleet.router``; the control plane is host Python, the
instances run on the devices their factory gives them).

The cluster simulator's placement policies (``fcfs`` / ``best_fit`` /
``backbone_affine``) become REAL here: the router evaluates them against
live per-instance state — each service's ``AdmissionController`` (Eq. 5
bytes + calibrated saturation curve) decides feasibility, the policy picks
among feasible instances — and keeps a ``ClusterSim`` in lockstep as a
placement oracle, so every live routing decision can be validated against
the abstract model it came from.

Overflow goes to a bounded fleet-level wait queue (highest priority first,
FIFO within a class) that re-drains after every fleet step; hard overflow
rejects.  Live tenant migration and autoscaling are delegated to the
``MigrationProtocol`` and ``Autoscaler`` but planned here (target
selection reuses the same policy code path as admission).

Elastic fault tolerance: ``kill(iid)`` crashes an instance mid-run (fault
injection).  The router holds everything recovery needs on
its own side — the ``TenantSpec`` each tenant was admitted under, the
``RequestSpec`` of every live inference request, and each tenant's latest
committed cadence checkpoint (``CheckpointStore`` under the shared fault
directory).  Recovery is migration WITHOUT a cooperating source: a crash
ticket is built from those durable records alone, orphaned tenants are
re-admitted on survivors through the ordinary ``migrate_in`` warm-start
path (``ElasticPlanner`` orders them by priority, then progress) and
their in-flight decode requests are re-created from their specs on the
new owner — re-prefilled and regenerated with seeded sampling, so no
request is ever cancelled.  Every recovery placement replays through the
lockstep oracle like a fresh admission.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.simulator import ClusterSim, TaskArrival
from repro_torch.core.task import PEFTTask
from repro_torch.distributed.checkpoint import CheckpointStore
from repro_torch.distributed.fault_tolerance import ElasticPlanner
from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import TelemetryRegistry
from repro_torch.obs.tracing import instant, span
from repro_torch.serve.inference import CANCELLED as REQ_CANCELLED
from repro_torch.serve.inference import DONE as REQ_DONE
from repro_torch.serve.inference import REJECTED as REQ_REJECTED
from repro_torch.serve.inference import InferenceRequest
from repro_torch.serve.service import (CANCELLED, COMPLETED, LOST, MIGRATED,
                                       QUEUED, REJECTED, RUNNING, MigrationTicket,
                                       MuxTuneService, TenantRecord)
from repro_torch.serve.spec import (RequestSpec, TenantSpec, coerce_request_spec,
                                    coerce_tenant_spec)
from repro_torch.fleet.migration import MigrationProtocol, MigrationReport

GB = 1024.0 ** 3
log = get_logger("fleet")


@dataclass
class RouteDecision:
    clock: int
    task_id: str
    instance: int          # -1 = not placed (queued or rejected)
    oracle: int            # ClusterSim's lockstep pick (-1 = infeasible)
    outcome: str           # admit | queue | reject | recover | recover_queue

    def summary(self) -> Dict[str, Any]:
        return {"clock": self.clock, "task_id": self.task_id,
                "instance": self.instance, "oracle": self.oracle,
                "outcome": self.outcome,
                "oracle_agrees": self.instance == self.oracle}


@dataclass
class RecoveryReport:
    """What one ``kill`` recovered: where each orphan landed (or that it
    queued for capacity), which tenants had no committed artifact (cold
    restart) and which request ids were re-created on new owners."""
    instance: int
    orphans: List[str]
    placed: Dict[str, int] = field(default_factory=dict)
    queued: List[str] = field(default_factory=list)
    cold: List[str] = field(default_factory=list)
    requeued_requests: List[str] = field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        return {"instance": self.instance, "orphans": list(self.orphans),
                "placed": dict(self.placed), "queued": list(self.queued),
                "cold": list(self.cold),
                "requeued_requests": list(self.requeued_requests)}


@dataclass
class _Pending:
    spec: TenantSpec
    seq: int

    @property
    def task(self) -> PEFTTask:
        return self.spec.task

    @property
    def priority(self) -> int:
        return self.spec.priority


@dataclass
class FleetInstance:
    """One managed service instance plus its fleet-side bookkeeping.

    ``backbone`` is the instance's pinned label (``<arch>:<backbone_dtype>``,
    derived from its service config at spawn) and ``backbone_bytes`` its own
    Eq. 5 resident-backbone footprint — an int8 instance is cheaper than an
    fp32 one, and the lockstep oracle prices each accordingly."""
    iid: int
    service: MuxTuneService
    backbone: str
    backbone_bytes: float = 0.0
    admitted: int = 0
    migrated_in: int = 0
    migrated_out: int = 0
    recovered: int = 0     # crash-recovered tenants warm-started here
    retired: bool = False

    @property
    def n_resident(self) -> int:
        return len(self.service.resident)

    def resident_bytes(self) -> float:
        return float(self.service.admission.resident_memory(
            self.service.resident))

    def can_admit(self, task: PEFTTask) -> bool:
        if self.retired:
            return False
        return bool(self.service.admission.check(self.service.resident,
                                                 task))

    def summary(self) -> Dict[str, Any]:
        return {
            "iid": self.iid,
            "backbone": self.backbone,
            "retired": self.retired,
            "resident": self.service.resident_ids,
            "n_resident": self.n_resident,
            "resident_bytes": self.resident_bytes(),
            "admitted": self.admitted,
            "migrated_in": self.migrated_in,
            "migrated_out": self.migrated_out,
            "recovered": self.recovered,
            "clock": self.service.clock,
        }


class FleetRouter:
    """The fleet control plane: admission, placement, migration planning.

    ``factory(iid) -> MuxTuneService`` builds instances.  Fleets may be
    backbone-heterogeneous: each instance is labeled
    ``<arch>:<backbone_dtype>`` from its own service config at spawn (e.g.
    an fp32 pool next to an int8-quantized pool), tenants route only onto
    instances whose label matches their requested backbone, and migration
    targets are constrained the same way — which is what keeps migration
    and request adoption safe between matching instances.  ``backbone``
    (when given) overrides the default label tenants are submitted under;
    otherwise the first spawned instance's label is the default.
    """

    def __init__(
        self,
        factory: Callable[[int], MuxTuneService],
        n_instances: int = 2,
        policy: str = "best_fit",
        max_queue: int = 32,
        backbone: Optional[str] = None,
        telemetry: Optional[TelemetryRegistry] = None,
        migration: Optional[MigrationProtocol] = None,
        oracle: bool = True,
    ):
        if policy not in ("fcfs", "best_fit", "backbone_affine"):
            raise ValueError(policy)
        self.factory = factory
        self.policy = policy
        self.max_queue = max_queue
        self.backbone = backbone
        self.telemetry = telemetry or TelemetryRegistry()
        self.migration = migration or MigrationProtocol(
            telemetry=self.telemetry)
        self.use_oracle = oracle
        self.instances: Dict[int, FleetInstance] = {}
        self.retired_instances: List[FleetInstance] = []
        self.failed_instances: List[FleetInstance] = []
        self.queue: List[_Pending] = []
        self.placements: Dict[str, int] = {}      # task_id -> live iid
        self.decisions: List[RouteDecision] = []
        self.migrations: List[MigrationReport] = []
        self.rejected: List[str] = []
        # durable submission records — everything crash recovery gets to use
        # (the dead instance is never asked anything)
        self.specs: Dict[str, TenantSpec] = {}
        self._request_specs: Dict[str, Tuple[str, RequestSpec]] = {}
        self.elastic = ElasticPlanner()
        self.recovery_queue: List[str] = []       # orphans awaiting capacity
        self._crash_tickets: Dict[str, MigrationTicket] = {}
        self._crash_reports: Dict[str, RecoveryReport] = {}
        self.recoveries: List[RecoveryReport] = []
        self.autoscaler = None                    # installed by Autoscaler
        self.clock = 0
        self._next_iid = 0
        self._seq = 0
        self._arrivals: Dict[str, TaskArrival] = {}  # oracle-side footprints
        self.sim: Optional[ClusterSim] = None
        self._backbone_bytes = 0.0
        for _ in range(n_instances):
            self.spawn()

    # ------------------------------------------------------------------
    # instance lifecycle

    def spawn(self) -> FleetInstance:
        """Provision one instance (and mirror it into the oracle)."""
        iid = self._next_iid
        self._next_iid += 1
        svc = self.factory(iid)
        # per-instance pinned label + Eq. 5 backbone footprint: the service
        # config decides both (an int8 backbone is a different label AND a
        # smaller resident copy than fp32 of the same arch)
        label = f"{svc.cfg.name}:{svc.cfg.backbone_dtype}"
        bb_bytes = float(svc.planner.cost_model([]).stage_memory([]))
        inst = FleetInstance(iid, svc, label, backbone_bytes=bb_bytes)
        self.instances[iid] = inst
        if self.backbone is None:
            self.backbone = label
        if self.sim is None:
            # oracle geometry from the first live instance: the Eq. 5
            # budget and backbone bytes the AdmissionController gates with
            self._backbone_bytes = bb_bytes
            self.sim = ClusterSim(
                n_chips=0,
                chips_per_instance=max(svc.parallelism.total_chips, 1),
                max_colocate=svc.admission_config.max_tenants,
                policy=self.policy,
                hbm_gb=svc.admission_config.memory_budget / GB,
                backbone_gb=self._backbone_bytes / GB,
            )
        sim_iid = self.sim.add_instance(backbone=label,
                                        backbone_gb=bb_bytes / GB,
                                        pinned=True)
        assert sim_iid == iid, "oracle instance ids out of lockstep"
        self.telemetry.gauge("fleet.instances").set(float(len(self.instances)))
        instant("fleet.spawn", track="fleet", args={"instance": iid})
        return inst

    def retire(self, iid: int) -> None:
        """Retire an EMPTY instance (mirror into the oracle)."""
        inst = self.instances[iid]
        if inst.n_resident or any(
            i == iid for i in self.placements.values()):
            raise ValueError(f"instance {iid} still has resident tenants")
        del self.instances[iid]
        inst.retired = True
        self.retired_instances.append(inst)
        self.sim.remove_instance(iid)
        self.telemetry.gauge("fleet.instances").set(float(len(self.instances)))
        instant("fleet.retire", track="fleet", args={"instance": iid})

    def drain_and_retire(self, iid: int) -> bool:
        """Migrate every resident tenant off ``iid``, then retire it.
        Returns False (instance untouched beyond completed migrations) when
        some tenant has no feasible target."""
        resident = [tid for tid, i in self.placements.items() if i == iid]
        for tid in resident:
            try:
                self.migrate(tid)
            except ValueError:
                return False
        self.retire(iid)
        return True

    # ------------------------------------------------------------------
    # placement policy (mirrors ClusterSim._pick against live state)

    def _feasible(self, task: PEFTTask, backbone: str,
                  exclude: Optional[set] = None) -> List[FleetInstance]:
        out = []
        for iid in sorted(self.instances):
            if exclude and iid in exclude:
                continue
            inst = self.instances[iid]
            if inst.backbone != backbone:
                continue
            if inst.can_admit(task):
                out.append(inst)
        return out

    def _pick_instance(self, task: PEFTTask, backbone: str,
                       exclude: Optional[set] = None
                       ) -> Optional[FleetInstance]:
        feas = self._feasible(task, backbone, exclude)
        if not feas:
            return None
        if self.policy == "fcfs":
            return feas[0]
        # best_fit / backbone_affine: pack tightest (most residents, then
        # most bytes) — identical key, identical tie-break (lowest iid) to
        # the simulator's max() over its feasible list
        if self.policy == "backbone_affine":
            same = [i for i in feas if i.n_resident]
            if same:
                feas = same
        return max(feas, key=lambda i: (i.n_resident, i.resident_bytes()))

    def _arrival_for(self, task: PEFTTask, target_steps: int,
                     backbone: str) -> TaskArrival:
        """The oracle-side footprint of a live task: Eq. 5 bytes of the
        task alone (backbone share subtracted — the sim adds its own,
        per-instance).  The reference instance is one matching the task's
        requested backbone, so the subtraction uses the right copy size."""
        ref = next((i for i in self.instances.values()
                    if i.backbone == backbone),
                   next(iter(self.instances.values())))
        solo = float(ref.service.admission.resident_memory([task]))
        return TaskArrival(
            t_min=float(self.clock), duration_min=float(max(target_steps, 1)),
            backbone=backbone,
            mem_gb=max(solo - ref.backbone_bytes, 0.0) / GB)

    # ------------------------------------------------------------------
    # tenant lifecycle

    def submit(self, spec, **legacy) -> RouteDecision:
        """Route one tenant fleet-wide: place, queue, or reject.  New API:
        ``submit(TenantSpec)`` — the legacy ``submit(task, priority=...,
        backbone=...)`` kwargs form still works for one release.
        ``spec.backbone`` restricts placement to instances carrying that
        label (default: the fleet's default label)."""
        spec = coerce_tenant_spec(spec, legacy, "FleetRouter.submit")
        if spec.backbone is None:
            spec = replace(spec, backbone=self.backbone)
        task = spec.task
        # the resolved spec IS the durable submission record recovery
        # re-creates the tenant from
        self.specs[task.task_id] = spec
        with span("fleet.route", track="fleet",
                  args={"task": task.task_id, "policy": self.policy,
                        "backbone": spec.backbone}):
            arrival = self._arrival_for(task, spec.target_steps,
                                        spec.backbone)
            self._arrivals[task.task_id] = arrival
            oracle = -1
            if self.use_oracle:
                pick = self.sim.lockstep_pick(arrival)
                oracle = -1 if pick is None else pick
            inst = self._pick_instance(task, spec.backbone)
            if inst is not None:
                self._admit(inst, spec, arrival)
                outcome, iid = "admit", inst.iid
            elif len(self.queue) < self.max_queue:
                self._seq += 1
                self.queue.append(_Pending(spec, self._seq))
                outcome, iid = "queue", -1
            else:
                self.rejected.append(task.task_id)
                outcome, iid = "reject", -1
        decision = RouteDecision(self.clock, task.task_id, iid, oracle,
                                 outcome)
        self.decisions.append(decision)
        self.telemetry.counter("fleet.route", policy=self.policy,
                               outcome=outcome).inc()
        if self.use_oracle and outcome != "queue":
            self.telemetry.counter(
                "fleet.oracle",
                agreement=str(iid == oracle).lower()).inc()
        return decision

    def _admit(self, inst: FleetInstance, spec: TenantSpec,
               arrival: TaskArrival) -> TenantRecord:
        rec = inst.service.submit(spec)
        inst.admitted += 1
        self.placements[spec.task_id] = inst.iid
        self.sim.lockstep_admit(spec.task_id, arrival, inst.iid)
        instant("fleet.admit", track="fleet",
                args={"task": spec.task_id, "instance": inst.iid})
        return rec

    def submit_request(self, task_id: str, prompt, **legacy
                       ) -> InferenceRequest:
        """Route an inference request to the tenant's owning instance.  New
        API: ``submit_request(task_id, RequestSpec(...))`` — legacy kwargs
        still work for one release.  The resolved spec (with its assigned
        request id) is logged fleet-side: if the owning instance crashes,
        the request is re-created from that record on the tenant's new
        owner."""
        spec = coerce_request_spec(prompt, legacy,
                                   "FleetRouter.submit_request")
        iid = self.placements.get(task_id)
        if iid is None:
            raise KeyError(f"tenant {task_id} is not placed on any instance")
        req = self.instances[iid].service.submit_request(task_id, spec)
        self._request_specs[req.request_id] = (
            task_id, replace(spec, request_id=req.request_id))
        return req

    def _find_request(self, rid: str) -> Optional[InferenceRequest]:
        for inst in self.instances.values():
            req = inst.service.coserve.requests.get(rid)
            if req is not None:
                return req
        return None

    def _prune_request_log(self) -> None:
        """Drop the specs of requests that reached a terminal state on a
        LIVE instance — only in-flight requests are resurrected by
        recovery (at-least-once semantics)."""
        for rid in list(self._request_specs):
            req = self._find_request(rid)
            if req is not None and req.state in (REQ_DONE, REQ_CANCELLED,
                                                 REQ_REJECTED):
                del self._request_specs[rid]

    def record(self, task_id: str) -> TenantRecord:
        """The tenant's CURRENT record: its live instance while placed,
        otherwise its final record — a MIGRATED or LOST stub (superseded by
        the record on the migration/recovery target) is only returned when
        no other instance holds the tenant."""
        iid = self.placements.get(task_id)
        if iid is not None:
            return self.instances[iid].service.tenants[task_id]
        stub = None
        for inst in (list(self.instances.values()) + self.retired_instances
                     + self.failed_instances):
            rec = inst.service.tenants.get(task_id)
            if rec is None:
                continue
            if rec.state not in (MIGRATED, LOST):
                return rec
            stub = rec
        if stub is not None:
            return stub
        raise KeyError(task_id)

    # ------------------------------------------------------------------
    # migration

    def migrate(self, task_id: str,
                target_iid: Optional[int] = None) -> MigrationReport:
        """Live-migrate one tenant; the target defaults to what the
        placement policy picks among the OTHER instances."""
        src_iid = self.placements[task_id]
        src = self.instances[src_iid]
        task = src.service.tenants[task_id].task
        bb = self._arrivals[task_id].backbone
        if target_iid is None:
            dst = self._pick_instance(task, bb, exclude={src_iid})
            if dst is None:
                raise ValueError(
                    f"no feasible migration target for {task_id}")
        else:
            dst = self.instances[target_iid]
            if dst.backbone != bb:
                raise ValueError(
                    f"migration target {target_iid} runs {dst.backbone!r}; "
                    f"tenant {task_id} needs {bb!r}")
        report = self.migration.migrate(src.service, dst.service, task_id,
                                        source_iid=src_iid,
                                        target_iid=dst.iid)
        self.sim.lockstep_depart(task_id)
        self.sim.lockstep_admit(task_id, self._arrivals[task_id], dst.iid)
        self.placements[task_id] = dst.iid
        src.migrated_out += 1
        dst.migrated_in += 1
        self.migrations.append(report)
        return report

    # ------------------------------------------------------------------
    # fault injection + elastic recovery

    def kill(self, iid: int) -> RecoveryReport:
        """Crash instance ``iid`` mid-run (fault injection): the instance
        is gone WITHOUT drain, checkpoint-out or any other cooperation —
        recovery works from the router's durable records and the tenants'
        latest committed cadence checkpoints alone."""
        inst = self.instances.pop(iid)
        inst.retired = True
        self.failed_instances.append(inst)
        # the crash fence: a dead process writes nothing after it died, but
        # the in-process instance's background checkpoint writers may still
        # run.  Join them before recovery reads the fault directory, so no
        # commit of the dead instance lands after that read (a write that
        # failed is lost with the instance)
        for store in inst.service._fault_stores.values():
            try:
                store.wait()
            except Exception:  # noqa: BLE001 - the crash loses the write
                log.warning("instance %d: a checkpoint write failed at the crash",
                            iid, exc_info=True)
                self.telemetry.counter("fleet.lost_writes").inc()
        orphans = [tid for tid, i in self.placements.items() if i == iid]
        sim_orphans = self.sim.fail_instance(iid)
        assert set(sim_orphans) == set(orphans), \
            "oracle residency out of lockstep at failure"
        for tid in orphans:
            del self.placements[tid]
            rec = inst.service.tenants.get(tid)
            if rec is not None and rec.state in (QUEUED, RUNNING):
                rec.state = LOST
                rec.reason = "instance_failure"
                rec.finish_step = inst.service.clock
        self.telemetry.counter("fleet.failures").inc()
        self.telemetry.gauge("fleet.instances").set(
            float(len(self.instances)))
        instant("fleet.kill", track="fleet",
                args={"instance": iid, "orphans": len(orphans)})
        return self._recover(inst, orphans)

    def _crash_ticket(self, tid: str,
                      fault_root: Optional[str]) -> MigrationTicket:
        """Build the migration ticket WITHOUT a cooperating source: spec
        from the router's submission record; checkpoint directory = the
        tenant's latest committed cadence artifact (falling back to the
        originally requested warm-start dir, or a cold restart); a fresh
        data stream; no drained requests (they are re-created from their
        own specs).  Token accounting restarts — the crash loses it."""
        spec = self.specs[tid]
        ckpt_dir = spec.warm_start_dir
        steps, losses, stack_rank = 0, [], 0
        if fault_root:
            d = os.path.join(fault_root, tid)
            store = CheckpointStore(d)
            if store.latest_step() is not None:
                extra = store.read_extra() or {}
                ckpt_dir = d
                steps = int(extra.get("steps_trained", store.latest_step()))
                losses = [float(x) for x in extra.get("losses", [])]
                stack_rank = int(extra.get("stack_rank", 0))
        return MigrationTicket(
            spec=replace(spec, warm_start_dir=None), ckpt_dir=ckpt_dir,
            steps_trained=steps, tokens=0, effective_tokens=0,
            decode_tokens=0, losses=losses, stream=None, requests=[],
            source_clock=self.clock, stack_rank=stack_rank)

    def _recover(self, failed: FleetInstance,
                 orphans: List[str]) -> RecoveryReport:
        """Re-admit every orphan on the survivors: priority-then-progress
        order (ElasticPlanner), warm start from the latest committed
        artifact, in-flight requests re-created on the new owner.  Orphans
        with no feasible survivor queue for capacity and re-drain every
        fleet step (and on autoscaler scale-up)."""
        fault_root = failed.service.fault_dir
        report = RecoveryReport(instance=failed.iid, orphans=list(orphans))
        with span("fleet.recover", track="fleet",
                  args={"instance": failed.iid, "orphans": len(orphans)}):
            with span("fleet.recover.plan", track="fleet",
                      args={"fault_dir": fault_root or ""}):
                tickets = {tid: self._crash_ticket(tid, fault_root)
                           for tid in orphans}
                for tid in orphans:
                    self._crash_reports[tid] = report
                    if tickets[tid].ckpt_dir is None:
                        report.cold.append(tid)
                meta = [(tid, self.specs[tid].priority,
                         tickets[tid].steps_trained) for tid in orphans]

            def place(tid: str) -> Optional[int]:
                iid = self._try_recover(tid, tickets[tid])
                if iid is None:
                    self._crash_tickets[tid] = tickets[tid]
                    self.recovery_queue.append(tid)
                    report.queued.append(tid)
                    decision = RouteDecision(self.clock, tid, -1, -1,
                                             "recover_queue")
                    self.decisions.append(decision)
                    self.telemetry.counter("fleet.route", policy=self.policy,
                                           outcome="recover_queue").inc()
                return iid

            self.elastic.plan_recovery(meta, place)
        self.recoveries.append(report)
        return report

    def _try_recover(self, tid: str,
                     ticket: MigrationTicket) -> Optional[int]:
        """One recovery placement attempt: policy pick among survivors,
        ``migrate_in`` warm start, request re-creation, lockstep mirror.
        Returns the instance id, or None when nothing is feasible (no
        decision recorded — the caller queues or retries)."""
        spec = self.specs[tid]
        arrival = self._arrivals[tid]
        inst = self._pick_instance(spec.task, spec.backbone or self.backbone)
        if inst is None:
            return None
        oracle = -1
        if self.use_oracle:
            pick = self.sim.lockstep_pick(arrival)
            oracle = -1 if pick is None else pick
        with span("fleet.recover.warm_start", track="fleet",
                  args={"task": tid, "instance": inst.iid,
                        "from_step": ticket.steps_trained,
                        "cold": ticket.ckpt_dir is None}):
            inst.service.migrate_in(ticket)
        inst.recovered += 1
        self.placements[tid] = inst.iid
        self.sim.lockstep_admit(tid, arrival, inst.iid)
        rids = self._requeue_requests(tid, inst)
        rep = self._crash_reports.get(tid)
        if rep is not None:
            rep.placed[tid] = inst.iid
            if tid in rep.queued:
                rep.queued.remove(tid)
            rep.requeued_requests.extend(rids)
        decision = RouteDecision(self.clock, tid, inst.iid, oracle,
                                 "recover")
        self.decisions.append(decision)
        self.telemetry.counter("fleet.route", policy=self.policy,
                               outcome="recover").inc()
        if self.use_oracle:
            self.telemetry.counter(
                "fleet.oracle",
                agreement=str(inst.iid == oracle).lower()).inc()
        self.telemetry.counter("tenant.recovered",
                               cold=str(ticket.ckpt_dir is None).lower()
                               ).inc()
        instant("tenant.recovered", track=f"tenant:{tid}",
                args={"instance": inst.iid,
                      "from_step": ticket.steps_trained})
        return inst.iid

    def _requeue_requests(self, tid: str,
                          inst: FleetInstance) -> List[str]:
        """Re-create the tenant's logged in-flight requests on its new
        owner (original submit order, same request ids): the pool-
        generation recovery path re-prefills and regenerates with seeded
        sampling, so the tokens match the lost instance's exactly and no
        request is cancelled."""
        rids = [rid for rid, (t, _) in self._request_specs.items()
                if t == tid]
        if not rids:
            return []
        with span("fleet.recover.requeue", track="fleet",
                  args={"task": tid, "requests": len(rids)}):
            for rid in rids:
                inst.service.submit_request(tid, self._request_specs[rid][1])
        return rids

    def _drain_recovery(self) -> None:
        """Retry queued recovery placements (planner order preserved)."""
        if not self.recovery_queue:
            return
        still: List[str] = []
        for tid in self.recovery_queue:
            iid = self._try_recover(tid, self._crash_tickets[tid])
            if iid is None:
                still.append(tid)
            else:
                del self._crash_tickets[tid]
        self.recovery_queue = still

    # ------------------------------------------------------------------
    # fleet step loop

    def step(self) -> None:
        """One fleet tick: step every instance, reconcile departures with
        the oracle, re-drain the fleet queue, let the autoscaler act."""
        with span("fleet.step", track="fleet",
                  args={"clock": self.clock,
                        "instances": len(self.instances)}):
            for iid in sorted(self.instances):
                self.instances[iid].service.step()
            self.clock += 1
            self._reconcile_departures()
            self._prune_request_log()
            self._drain_recovery()
            self._drain_queue()
            if self.autoscaler is not None:
                self.autoscaler.tick(self)

    def _reconcile_departures(self) -> None:
        for tid, iid in list(self.placements.items()):
            inst = self.instances.get(iid)
            rec = inst.service.tenants.get(tid) if inst else None
            if rec is not None and rec.state in (COMPLETED, CANCELLED,
                                                 REJECTED):
                del self.placements[tid]
                self.sim.lockstep_depart(tid)
                self.telemetry.counter("fleet.departures",
                                       state=rec.state).inc()

    def _drain_queue(self) -> None:
        """Re-route queued tenants, highest priority first (FIFO within a
        class); each successful placement is recorded as a fresh decision."""
        if not self.queue:
            return
        still: List[_Pending] = []
        for p in sorted(self.queue, key=lambda p: (-p.priority, p.seq)):
            inst = self._pick_instance(
                p.task, self._arrivals[p.task.task_id].backbone)
            if inst is None:
                still.append(p)
                continue
            arrival = self._arrivals[p.task.task_id]
            oracle = -1
            if self.use_oracle:
                pick = self.sim.lockstep_pick(arrival)
                oracle = -1 if pick is None else pick
            self._admit(inst, p.spec, arrival)
            decision = RouteDecision(self.clock, p.task.task_id, inst.iid,
                                     oracle, "admit")
            self.decisions.append(decision)
            self.telemetry.counter("fleet.route", policy=self.policy,
                                   outcome="drain_admit").inc()
            if self.use_oracle:
                self.telemetry.counter(
                    "fleet.oracle",
                    agreement=str(inst.iid == oracle).lower()).inc()
        still.sort(key=lambda p: p.seq)
        self.queue = still

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.recovery_queue) or any(
            inst.service.resident or len(inst.service.queue)
            for inst in self.instances.values())

    def run(self, max_iters: int = 512) -> int:
        """Step until the fleet is idle (or ``max_iters``); returns the
        number of steps taken."""
        n = 0
        while self.has_work() and n < max_iters:
            self.step()
            n += 1
        return n

    # ------------------------------------------------------------------
    # accounting

    def oracle_agreement(self) -> float:
        placed = [d for d in self.decisions
                  if d.outcome not in ("queue", "recover_queue")]
        if not placed:
            return 1.0
        agree = sum(1 for d in placed if d.instance == d.oracle)
        return agree / len(placed)

    def accounting(self) -> Dict[str, Any]:
        return {
            "clock": self.clock,
            "policy": self.policy,
            "instances": {str(i.iid): i.summary()
                          for i in self.instances.values()},
            "retired_instances": [i.summary()
                                  for i in self.retired_instances],
            "failed_instances": [i.summary()
                                 for i in self.failed_instances],
            "placements": dict(self.placements),
            "queued": len(self.queue),
            "recovery_queued": list(self.recovery_queue),
            "rejected": list(self.rejected),
            "decisions": [d.summary() for d in self.decisions],
            "oracle_agreement": self.oracle_agreement(),
            "migrations": [m.summary() for m in self.migrations],
            "recoveries": [r.summary() for r in self.recoveries],
            "autoscaler": (self.autoscaler.accounting()
                           if self.autoscaler else None),
        }

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Fleet registry + every instance's registry (incl. retired and
        failed)."""
        per_inst = {
            str(i.iid): i.service.telemetry.snapshot()
            for i in (list(self.instances.values()) + self.retired_instances
                      + self.failed_instances)
        }
        return {"fleet": self.telemetry.snapshot(), "instances": per_inst}
