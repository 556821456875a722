"""Trace-driven serving driver: replay a ``TaskArrival`` trace through the
REAL service (§5.4 validation path; port of ``repro.serve.replay``).

The cluster simulator replays arrival traces against an abstract cost
model; this driver replays the SAME trace through a live ``MuxTuneService``
on a toy config — real planner, real engine, real kernels — and emits
per-tenant accounting (queue wait, tokens trained, effective-token ratio,
makespan) next to the simulator's per-arrival predictions, so the abstract
model can be validated task-by-task against real execution.

Time mapping: one simulated minute == ``iters_per_min`` engine iterations;
an arrival's solo ``duration_min`` becomes its training target in
iterations.  The driver ticks minute-by-minute: submit due arrivals, run
one service step per iteration, drain after the horizon.

Runs as a module (on the card; ``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python -m repro_torch.serve.replay --json replay.json \
        --trace-out trace.json --metrics-out metrics.json
    PYTHONPATH=src python -m repro_torch.serve.replay --device cpu \
        --instances 2 --force-migration --kill-instance --ckpt-cadence 2

``--trace-out`` installs a ``SpanTracer`` and saves the run as Chrome
trace-event JSON (open in Perfetto / ``chrome://tracing``); per-tenant
lifecycle events land on ``tenant:<task_id>`` swimlanes.  ``--metrics-out``
saves the service's telemetry registry snapshot.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.simulator import ClusterSim, TaskArrival, philly_style_trace
from repro_torch.configs import smoke_config
from repro_torch.core.task import ParallelismSpec, PEFTTask
from repro_torch.data.synthetic import make_task
from repro_torch.obs.log import get_logger
from repro_torch.obs.tracing import SpanTracer, set_tracer
from repro_torch.peft.methods import AdapterConfig
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.service import COMPLETED, RUNNING, MuxTuneService
from repro_torch.serve.spec import RequestSpec, TenantSpec

_DATASETS = ("sst2", "qa", "rte")
# the PEFT kinds the arrivals cycle through (the ``peft.methods`` names)
LORA, ADAPTER_TUNING = "lora", "adapter"
log = get_logger("replay")


def arrival_to_task(arr: TaskArrival, index: int) -> PEFTTask:
    """Deterministically materialize an abstract arrival as a PEFT task: the
    dataset (seq-length profile) scales with the arrival's memory footprint,
    adapter kind/rank cycle for heterogeneity."""
    ds = _DATASETS[min(int(arr.mem_gb), len(_DATASETS) - 1)]
    kind = LORA if index % 3 else ADAPTER_TUNING
    rank = 4 if index % 2 else 8
    return make_task(f"tenant{index}", ds, micro_batch=1,
                     adapter=AdapterConfig(kind, rank=rank), seed=index)


def tiny_trace(n: int = 4, gap_min: float = 2.0, dur_min: float = 4.0,
               seed: int = 0) -> List[TaskArrival]:
    """A small deterministic trace for smoke runs and tests."""
    rng = np.random.RandomState(seed)
    return [
        TaskArrival(t_min=i * gap_min,
                    duration_min=dur_min + float(rng.randint(0, 3)),
                    mem_gb=float(rng.uniform(0.5, 2.0)))
        for i in range(n)
    ]


def replay_trace(
    trace: Sequence[TaskArrival],
    cfg=None,
    parallelism: Optional[ParallelismSpec] = None,
    iters_per_min: float = 1.0,
    max_drain_iters: int = 256,
    admission: Optional[AdmissionConfig] = None,
    ckpt_dir: Optional[str] = None,
    seed: int = 0,
    requests_per_min: int = 0,
    device="cuda",
) -> Dict:
    """Replay ``trace`` through a real MuxTuneService AND the cluster
    simulator; return both sides' accounting for validation.  The service
    runs on ``device``.

    ``requests_per_min`` > 0 additionally injects that many inference
    requests per simulated minute against the resident tenants (round-robin,
    cycling SLO classes), exercising the token-level co-serving path so the
    exported trace carries decode bind/micro-step spans."""
    cfg = cfg or smoke_config("llama3.2-3b")
    par = parallelism or ParallelismSpec()
    service = MuxTuneService(cfg, par, admission=admission, ckpt_dir=ckpt_dir,
                             seed=seed, reserve_slots=4, device=device)

    # --- abstract side: one simulator instance mirrors the one service
    sim = ClusterSim(n_chips=par.total_chips, chips_per_instance=par.total_chips,
                     max_colocate=service.admission_config.max_tenants,
                     policy="fcfs")
    sim_metrics = sim.run(trace)

    # --- real side: tick the service through the trace
    arrivals = sorted(trace, key=lambda a: a.t_min)
    pending = list(enumerate(arrivals))
    horizon = max((a.t_min for a in arrivals), default=0.0) + 1.0
    req_rng = np.random.RandomState(seed + 1)
    injected = 0
    t = 0.0
    while t <= horizon:
        while pending and pending[0][1].t_min <= t:
            idx, arr = pending.pop(0)
            target = max(1, int(round(arr.duration_min * iters_per_min)))
            service.submit(TenantSpec(arrival_to_task(arr, idx),
                                      target_steps=target))
        resident = [r.task_id for r in service.resident]
        for i in range(requests_per_min if resident else 0):
            tid = resident[(injected + i) % len(resident)]
            prompt = req_rng.randint(1, 64,
                                     size=int(req_rng.randint(3, 9)))
            service.submit_request(tid, RequestSpec(
                prompt, max_new_tokens=4, slo_class=(injected + i) % 2))
        injected += requests_per_min if resident else 0
        for _ in range(max(1, int(round(iters_per_min)))):
            service.step()
        t += 1.0
    # drain: finish whatever is still resident/queued
    for _ in range(max_drain_iters):
        if not service.resident and not len(service.queue):
            break
        service.step()

    acct = service.accounting()
    completed = [r for r in service.tenants.values() if r.state == COMPLETED]
    makespans = [r.makespan for r in completed if r.makespan >= 0]
    out = {
        "real": acct,
        "real_summary": {
            "completed": len(completed),
            "mean_makespan_iters": float(np.mean(makespans)) if makespans else 0.0,
            "mean_queue_wait_iters": acct["mean_queue_wait"],
            "mean_effective_token_ratio": float(np.mean(
                [r.effective_token_ratio for r in completed])) if completed else 0.0,
            "total_effective_tokens": int(sum(
                r.effective_tokens for r in service.tenants.values())),
            "injected_requests": injected,
            "slo_attainment_pct":
                acct["coserve"]["slo_attainment_pct"],
        },
        "sim": sim_metrics,
        # live registry handle (for --metrics-out); NOT JSON-serializable —
        # callers that dump the report must pop it first
        "_telemetry": service.telemetry,
        "sim_records": [
            {"index": r.index, "admitted": r.admitted,
             "t_arrive": r.t_arrive, "t_end": r.t_end, "colocated": r.colocated}
            for r in sim.records
        ],
    }
    # head-to-head validation: admission parity between model and reality
    real_admitted = sum(1 for r in service.tenants.values()
                        if r.admit_step >= 0)
    out["validation"] = {
        "sim_admitted": int(sim_metrics["completed"]),
        "real_admitted": int(real_admitted),
        "admission_agreement": float(
            min(sim_metrics["completed"], real_admitted)
            / max(sim_metrics["completed"], real_admitted, 1)),
    }
    return out


def _try_force_migration(fleet, spawn_if_needed=False):
    """Best-effort forced migration for smoke runs: pick a RUNNING tenant
    with enough training left that any in-flight decode request finishes
    after the move, and migrate it wherever the policy allows.

    ``spawn_if_needed`` is the drain-loop last resort: if the autoscaler
    already shrank the fleet to one instance, spawn a target — the point
    of the hook is to guarantee migration coverage.  The mid-replay call
    site keeps it off so the spawn never masks the autoscaler's own
    queue-pressure scale-up."""
    if len(fleet.instances) < 2:
        if not spawn_if_needed:
            return None
        fleet.spawn()
    for tid in sorted(fleet.placements):
        rec = fleet.record(tid)
        if rec.state != RUNNING or rec.target_steps - rec.steps_trained <= 4:
            continue
        try:
            return fleet.migrate(tid)
        except ValueError:
            continue
    return None


def replay_fleet(
    trace: Sequence[TaskArrival],
    cfg=None,
    parallelism: Optional[ParallelismSpec] = None,
    iters_per_min: float = 1.0,
    max_drain_iters: int = 256,
    admission: Optional[AdmissionConfig] = None,
    seed: int = 0,
    requests_per_min: int = 0,
    n_instances: int = 2,
    policy: str = "best_fit",
    autoscale: bool = False,
    autoscaler_config=None,
    force_migration: bool = False,
    kill_instance: bool = False,
    ckpt_cadence: int = 0,
    device="cuda",
) -> Dict:
    """Replay ``trace`` through an N-instance fleet: the ``FleetRouter``
    places arrivals with ``policy`` against live admission state (the
    ``ClusterSim`` oracle in lockstep), inference requests route to each
    tenant's owning instance, and — optionally — the autoscaler provisions
    and retires instances while ``force_migration`` guarantees at least one
    live migration lands in the trace (smoke-run determinism).

    Fault injection: ``ckpt_cadence`` > 0 turns on per-tenant
    async cadence checkpoints (every instance shares one fault directory);
    ``kill_instance`` crashes the most-loaded instance once, mid-replay —
    its tenants recover onto survivors from their latest committed
    checkpoints and their in-flight requests are re-created there.

    Fusion stays off fleet-wide so a migrated tenant's data stream (and
    therefore its loss trajectory) is exactly its solo trajectory.  Every
    instance runs on ``device``."""
    from repro_torch.fleet import Autoscaler, FleetRouter

    cfg = cfg or smoke_config("llama3.2-3b")
    par = parallelism or ParallelismSpec()
    fault_dir = (tempfile.mkdtemp(prefix="muxtune-fault-")
                 if kill_instance or ckpt_cadence > 0 else None)

    def factory(iid: int) -> MuxTuneService:
        return MuxTuneService(cfg, par, admission=admission, seed=seed,
                              reserve_slots=4, enable_fusion=False,
                              fault_dir=fault_dir,
                              ckpt_cadence=ckpt_cadence, device=device)

    fleet = FleetRouter(factory, n_instances=n_instances, policy=policy)
    if autoscale:
        fleet.autoscaler = Autoscaler(autoscaler_config)

    arrivals = sorted(trace, key=lambda a: a.t_min)
    pending = list(enumerate(arrivals))
    horizon = max((a.t_min for a in arrivals), default=0.0) + 1.0
    req_rng = np.random.RandomState(seed + 1)
    injected = 0
    forced: List = []
    kills: List = []
    t = 0.0
    while t <= horizon:
        while pending and pending[0][1].t_min <= t:
            idx, arr = pending.pop(0)
            target = max(1, int(round(arr.duration_min * iters_per_min)))
            fleet.submit(TenantSpec(arrival_to_task(arr, idx),
                                    target_steps=target))
        placed = sorted(fleet.placements)
        for i in range(requests_per_min if placed else 0):
            tid = placed[(injected + i) % len(placed)]
            prompt = req_rng.randint(1, 64, size=int(req_rng.randint(3, 9)))
            fleet.submit_request(tid, RequestSpec(
                prompt, max_new_tokens=4, slo_class=(injected + i) % 2))
        injected += requests_per_min if placed else 0
        if (kill_instance and not kills and t >= horizon / 2
                and len(fleet.instances) >= 2):
            victim = max(fleet.instances.values(),
                         key=lambda i: (i.n_resident, i.iid))
            kills.append(fleet.kill(victim.iid))
        if force_migration and not forced and t >= horizon / 2:
            rep = _try_force_migration(fleet)
            if rep is not None:
                forced.append(rep)
        for _ in range(max(1, int(round(iters_per_min)))):
            fleet.step()
        t += 1.0
    for _ in range(max_drain_iters):
        if not fleet.has_work():
            break
        if force_migration and not forced:
            rep = _try_force_migration(fleet, spawn_if_needed=True)
            if rep is not None:
                forced.append(rep)
        fleet.step()
    if autoscale:
        # a few idle ticks so the utilization floor can retire instances
        # the drain loop (which exits on no-work) never reaches
        extra = fleet.autoscaler.config.cooldown_ticks + 3
        for _ in range(extra):
            fleet.step()

    acct = fleet.accounting()
    # survivors carry the authoritative post-recovery records; failed
    # instances only contribute tenants that COMPLETED before the crash
    survivors = list(fleet.instances.values()) + fleet.retired_instances
    all_insts = survivors + fleet.failed_instances
    completed = {
        tid: rec
        for inst in all_insts
        for tid, rec in inst.service.tenants.items()
        if rec.state == COMPLETED
    }
    # zero-drop guarantee: every request a migration moved OR a recovery
    # re-created must have completed (or still be live) on SOME surviving
    # instance — never cancelled, never vanished
    moved_ids = {rid for m in fleet.migrations for rid in m.request_ids}
    recovered_ids = {rid for r in fleet.recoveries
                     for rid in r.requeued_requests}
    dropped = []
    for inst in survivors:
        for rid, req in inst.service.coserve.requests.items():
            if rid in (moved_ids | recovered_ids) and req.state == "cancelled":
                dropped.append(rid)
    for rid in sorted(recovered_ids):
        if not any(rid in inst.service.coserve.requests
                   for inst in survivors):
            dropped.append(rid)
    makespans = [r.makespan for r in completed.values() if r.makespan >= 0]
    out = {
        "fleet": acct,
        "real_summary": {
            "instances": n_instances,
            "live_instances": len(fleet.instances),
            "retired_instances": len(fleet.retired_instances),
            "policy": policy,
            "completed": len(completed),
            "mean_makespan_iters": float(np.mean(makespans)) if makespans else 0.0,
            "injected_requests": injected,
            "migrations": len(fleet.migrations),
            "forced_migrations": len(forced),
            "requests_moved": sum(m.requests_moved for m in fleet.migrations),
            "dropped_moved_requests": dropped,
            "failures": len(fleet.failed_instances),
            "recovered_tenants": sorted(
                tid for r in fleet.recoveries for tid in r.placed),
            "cold_restarts": sorted(
                tid for r in fleet.recoveries for tid in r.cold),
            "requeued_requests": sorted(recovered_ids),
            "recovery_queued": list(fleet.recovery_queue),
            "oracle_agreement": acct["oracle_agreement"],
            "scale_ups": (fleet.autoscaler.accounting()["scale_ups"]
                          if autoscale else 0),
            "scale_downs": (fleet.autoscaler.accounting()["scale_downs"]
                            if autoscale else 0),
            # per-instance breakdown: fleet replays debuggable from the
            # metrics JSON alone
            "per_instance": {
                str(i.iid): {"admitted": i.admitted,
                             "migrated_in": i.migrated_in,
                             "migrated_out": i.migrated_out,
                             "recovered": i.recovered,
                             "retired": i.retired,
                             "failed": i in fleet.failed_instances,
                             "completed": sum(
                                 1 for r in i.service.tenants.values()
                                 if r.state == COMPLETED)}
                for i in all_insts
            },
        },
        # live router handle (for --metrics-out); NOT JSON-serializable
        "_fleet": fleet,
    }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the replay report as JSON")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--philly", action="store_true",
                    help="use a (scaled-down) Philly-style random trace")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="save the run as Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="save the telemetry registry snapshot as JSON")
    ap.add_argument("--requests-per-min", type=int, default=2,
                    help="inference requests injected per simulated minute "
                         "against resident tenants (0 disables co-serving)")
    ap.add_argument("--instances", type=int, default=1,
                    help="fleet size; > 1 replays through the FleetRouter "
                         "(1 keeps the single-instance driver unchanged)")
    ap.add_argument("--policy", default="best_fit",
                    choices=["fcfs", "best_fit", "backbone_affine"],
                    help="fleet placement policy (--instances > 1)")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the cost-model-driven autoscaler "
                         "(--instances > 1)")
    ap.add_argument("--force-migration", action="store_true",
                    help="guarantee >= 1 live migration during the replay "
                         "(--instances > 1; smoke-run determinism)")
    ap.add_argument("--kill-instance", action="store_true",
                    help="fault injection: crash the most-loaded instance "
                         "mid-replay; its tenants recover onto survivors "
                         "(--instances > 1)")
    ap.add_argument("--ckpt-cadence", type=int, default=0,
                    help="async per-tenant cadence checkpoints every N "
                         "trained steps (0 disables; enables the warm "
                         "recovery path under --kill-instance)")
    ap.add_argument("--device", default="cuda",
                    help="device of every service instance (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.philly:
        trace = philly_style_trace(horizon_min=args.tenants * 2.0,
                                   rate_per_min=0.5, mean_dur_min=5.0)
    elif args.instances > 1:
        # longer-lived tenants: a mid-replay forced migration needs a
        # candidate with enough training left to survive the move
        trace = tiny_trace(args.tenants, gap_min=1.0, dur_min=6.0)
    else:
        trace = tiny_trace(args.tenants)
    tracer = prev = None
    if args.trace_out:
        tracer = SpanTracer()
        prev = set_tracer(tracer)
    try:
        if args.instances > 1:
            report = replay_fleet(trace,
                                  requests_per_min=args.requests_per_min,
                                  n_instances=args.instances,
                                  policy=args.policy,
                                  autoscale=args.autoscale,
                                  force_migration=args.force_migration,
                                  kill_instance=args.kill_instance,
                                  ckpt_cadence=args.ckpt_cadence,
                                  device=args.device)
        else:
            report = replay_trace(trace,
                                  requests_per_min=args.requests_per_min,
                                  device=args.device)
    finally:
        if tracer is not None:
            set_tracer(prev)
    head = {"real_summary": report["real_summary"]}
    for k in ("sim", "validation"):
        if k in report:
            head[k] = report[k]
    print(json.dumps(head, indent=2))
    if tracer is not None:
        tracer.save(args.trace_out)
        log.info("wrote trace %s (%d events)", args.trace_out,
                 len(tracer.events))
    if args.metrics_out:
        fleet = report.get("_fleet")
        if fleet is not None:
            with open(args.metrics_out, "w") as f:
                json.dump(fleet.metrics_snapshot(), f, indent=2,
                          default=float)
        else:
            report["_telemetry"].save_snapshot(args.metrics_out)
        log.info("wrote metrics snapshot %s", args.metrics_out)
    if args.json:
        report.pop("_telemetry", None)
        report.pop("_fleet", None)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=float)
        log.info("wrote %s", args.json)


if __name__ == "__main__":
    main()
