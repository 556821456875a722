"""Fleet tier: multi-instance router, live tenant migration, autoscaling
(port of ``repro.fleet``).

The control plane over N in-process ``MuxTuneService`` instances — the
cluster simulator's placement policies made real, with the simulator kept
in lockstep as the placement oracle.
"""
from repro_torch.fleet.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.fleet.migration import MigrationProtocol, MigrationReport, PHASES
from repro_torch.fleet.router import FleetInstance, FleetRouter, RecoveryReport, RouteDecision

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "FleetInstance",
    "FleetRouter",
    "MigrationProtocol",
    "MigrationReport",
    "PHASES",
    "RecoveryReport",
    "RouteDecision",
]
