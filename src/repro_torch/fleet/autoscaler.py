"""Cost-model-driven fleet autoscaling (port of ``repro.fleet.autoscaler``).

Utilization is PREDICTED, not sampled: each instance's calibrated cost
model already prices its current plan (``predicted_iteration_seconds``)
and its decode traffic (the ``__decode__`` calibration channel feeding
``decode_token_latency``), so the autoscaler sees load before wall-clock
degradation does.  An instance's utilization is the predicted seconds of
one iteration — training plus the decode backlog it still owes — over the
co-serve SLO target; the fleet utilization is the mean over live
instances.

Scale-up: fleet utilization crosses the knee (or tenants are stuck in the
fleet queue with no feasible instance) -> spawn one instance and re-drain
the queue.  Scale-down: fleet utilization falls below the floor with an
idle queue -> drain-and-retire the emptiest instance (its tenants are
live-migrated by the router's placement policy first).  Both directions
respect a cooldown and the [min_instances, max_instances] band, and land
in the trace as ``fleet.scale_up`` / ``fleet.scale_down`` spans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.obs.tracing import span


@dataclass(frozen=True)
class AutoscalerConfig:
    min_instances: int = 1
    max_instances: int = 4
    scale_up_util: float = 0.8     # knee: predicted seconds / SLO target
    scale_down_util: float = 0.25  # floor
    # per-iteration seconds target; None = each instance's co-serve SLO
    target_seconds: Optional[float] = None
    cooldown_ticks: int = 2        # fleet steps between scaling actions
    queue_pressure: bool = True    # queued-with-no-feasible-target => up


class Autoscaler:
    """Attach with ``fleet.autoscaler = Autoscaler(cfg)``; the router then
    calls ``tick`` at the end of every fleet step."""

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self.events: List[Dict[str, Any]] = []
        self._last_scale_clock = -10 ** 9

    # ------------------------------------------------------------------

    def instance_utilization(self, inst) -> float:
        """Predicted seconds of the instance's next iteration (training +
        owed decode backlog) over its SLO target."""
        svc = inst.service
        target = self.config.target_seconds or svc.coserve.config.slo_seconds
        predicted = svc.predicted_iteration_seconds()
        backlog = len(svc.coserve.queue)
        if backlog and svc.plan is not None:
            c = svc.coserve.config
            per_step = svc._cost_model().decode_token_latency(
                c.decode_slots, c.decode_max_len // 2)
            predicted += backlog * per_step
        return predicted / max(target, 1e-9)

    def fleet_utilization(self, fleet) -> float:
        if not fleet.instances:
            return 0.0
        utils = [self.instance_utilization(i)
                 for i in fleet.instances.values()]
        return sum(utils) / len(utils)

    # ------------------------------------------------------------------

    def tick(self, fleet) -> None:
        c = self.config
        util = self.fleet_utilization(fleet)
        fleet.telemetry.gauge("fleet.utilization").set(util)
        if fleet.clock - self._last_scale_clock < c.cooldown_ticks:
            return
        n = len(fleet.instances)
        # recovery-queued orphans (crash survivors with no feasible target)
        # count as queue pressure: scale-up is how a shrunken fleet gets
        # its capacity back
        pressure = c.queue_pressure and bool(fleet.queue
                                             or fleet.recovery_queue)
        if n < c.max_instances and (util > c.scale_up_util or pressure):
            with span("fleet.scale_up", track="fleet",
                      args={"utilization": util, "instances": n,
                            "queue_pressure": pressure}):
                inst = fleet.spawn()
                fleet._drain_recovery()
                fleet._drain_queue()
            self._record(fleet, "up", inst.iid, util)
            return
        if n > c.min_instances and util < c.scale_down_util and not pressure:
            victim = min(fleet.instances.values(),
                         key=lambda i: (i.n_resident, i.resident_bytes()))
            with span("fleet.scale_down", track="fleet",
                      args={"utilization": util, "instance": victim.iid,
                            "resident": victim.n_resident}):
                ok = fleet.drain_and_retire(victim.iid)
            if ok:
                self._record(fleet, "down", victim.iid, util)

    def _record(self, fleet, direction: str, iid: int, util: float) -> None:
        self._last_scale_clock = fleet.clock
        self.events.append({"clock": fleet.clock, "direction": direction,
                            "instance": iid, "utilization": util})
        fleet.telemetry.counter("fleet.autoscale",
                                direction=direction).inc()

    # ------------------------------------------------------------------

    def accounting(self) -> Dict[str, Any]:
        ups = sum(1 for e in self.events if e["direction"] == "up")
        return {
            "events": list(self.events),
            "scale_ups": ups,
            "scale_downs": len(self.events) - ups,
        }
