"""Live tenant migration between MuxTuneService instances (port of
``repro.fleet.migration``).

Five-phase protocol, every phase a ``fleet.migrate.<phase>`` span under one
``fleet.migrate`` parent so a Perfetto trace shows the downtime anatomy:

  drain           pull the tenant's in-flight decode requests out of the
                  source scheduler (pool-generation recovery semantics —
                  rows freed, nothing cancelled);
  checkpoint_out  atomic adapter checkpoint on the source, optimizer
                  moments + per-slot step count included;
  release         detach from the source (state MIGRATED) and bundle the
                  live token-stream generator + accounting into a
                  ``MigrationTicket``;
  warm_start      admit on the target with the full optimizer state, so
                  the post-migration loss trajectory is exactly the solo
                  trajectory (AdamW bias correction continues from the
                  migrated per-slot step count);
  rebind          adopt the drained inference requests on the target:
                  this phase only queues them (host bookkeeping, no device
                  work); their re-prefill runs at the target's next bind,
                  and the seeded sampler regenerates the same tokens.

Each phase's seconds end after a device synchronize of both instances'
devices (``torch.cuda.synchronize`` on a CUDA service), so on the card they
time finished device work, not queued launches.

The protocol is all-or-nothing up to ``release``: failures before the
source detaches leave the tenant running where it was.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.telemetry import TelemetryRegistry
from repro_torch.obs.tracing import span

PHASES = ("drain", "checkpoint_out", "release", "warm_start", "rebind")


@dataclass
class MigrationReport:
    task_id: str
    source: int
    target: int
    checkpoint_path: str
    requests_moved: int
    request_ids: List[str]
    steps_trained: int
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    wall_seconds: float = 0.0

    def summary(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id,
            "source": self.source,
            "target": self.target,
            "requests_moved": self.requests_moved,
            "steps_trained": self.steps_trained,
            "wall_seconds": self.wall_seconds,
            "phase_seconds": dict(self.phase_seconds),
        }


class MigrationProtocol:
    """Drives the five-phase live migration between two service instances.

    ``ckpt_root`` holds one directory per migration (monotonic sequence
    suffix, so a tenant migrated twice never collides with its own earlier
    artifact); defaults to a fresh temp directory per protocol instance.
    """

    def __init__(self, ckpt_root: Optional[str] = None,
                 telemetry: Optional[TelemetryRegistry] = None):
        self.ckpt_root = ckpt_root or tempfile.mkdtemp(prefix="fleet_migrate_")
        self.telemetry = telemetry or TelemetryRegistry(enabled=False)
        self.reports: List[MigrationReport] = []
        self._seq = 0

    def migrate(self, source, target, task_id: str,
                source_iid: int = -1, target_iid: int = -1) -> MigrationReport:
        """Move ``task_id`` from ``source`` to ``target`` (both
        ``MuxTuneService``).  Raises without detaching the source if the
        target cannot admit or the warm start fails."""
        self._seq += 1
        ckpt_dir = os.path.join(self.ckpt_root,
                                f"{task_id}.m{self._seq:04d}")
        report = MigrationReport(task_id, source_iid, target_iid, "", 0, [],
                                 0)
        t_start = time.perf_counter()
        with span("fleet.migrate", track="fleet",
                  args={"task": task_id, "source": source_iid,
                        "target": target_iid}):
            devices = {source.device, target.device}

            def timed(phase):
                return _PhaseTimer(report, phase, devices)

            with timed("drain"), span("fleet.migrate.drain", track="fleet",
                                      args={"task": task_id}):
                requests = source.drain_tenant(task_id)
            with timed("checkpoint_out"), span("fleet.migrate.checkpoint_out",
                                               track="fleet",
                                               args={"task": task_id}):
                report.checkpoint_path = source.checkpoint_out_tenant(
                    task_id, ckpt_dir, include_optimizer=True)
            with timed("release"), span("fleet.migrate.release",
                                        track="fleet",
                                        args={"task": task_id}):
                ticket = source.release_tenant(task_id, ckpt_dir,
                                               requests=requests)
            with timed("warm_start"), span("fleet.migrate.warm_start",
                                           track="fleet",
                                           args={"task": task_id}):
                rec = target.migrate_in(ticket)
            with timed("rebind"), span("fleet.migrate.rebind", track="fleet",
                                       args={"task": task_id,
                                             "requests": len(ticket.requests)}):
                target.adopt_requests(ticket.requests)
        report.requests_moved = len(ticket.requests)
        report.request_ids = [r.request_id for r in ticket.requests]
        report.steps_trained = rec.steps_trained
        report.wall_seconds = time.perf_counter() - t_start
        self.reports.append(report)
        self.telemetry.counter("fleet.migrations").inc()
        self.telemetry.histogram("fleet.migration_seconds").observe(
            report.wall_seconds)
        return report


class _PhaseTimer:
    """Seconds of one phase, ended by a synchronize of every CUDA device
    the two instances run on (so the time covers the phase's device work)."""

    def __init__(self, report: MigrationReport, phase: str, devices):
        self.report, self.phase = report, phase
        self.cuda = [d for d in devices if d.type == "cuda"]

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for d in self.cuda:
            torch.cuda.synchronize(d)
        self.report.phase_seconds[self.phase] = (
            time.perf_counter() - self.t0)
        return False
