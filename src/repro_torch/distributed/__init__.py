"""Checkpointing and fault tolerance (port of ``repro.distributed``: the
store, the training supervisor, the straggler mitigator and the elastic
planner) and the multi-device tier (``sharding``, ``collectives``,
``pipeline``).

The checkpoint and fault-tolerance names resolve on first use, so that the
model code can import ``collectives`` and ``sharding`` without importing the
engine (``fault_tolerance`` imports ``core``, which imports the models)."""
import importlib

_EXPORTS = {
    "AsyncCheckpointer": "checkpoint", "CheckpointStore": "checkpoint",
    "latest_step": "checkpoint", "prune_checkpoints": "checkpoint",
    "restore_checkpoint": "checkpoint", "restore_latest": "checkpoint",
    "save_checkpoint": "checkpoint",
    "ElasticPlanner": "fault_tolerance", "HostStat": "fault_tolerance",
    "RecoveryAction": "fault_tolerance", "StragglerMitigator": "fault_tolerance",
    "SupervisorConfig": "fault_tolerance", "TrainSupervisor": "fault_tolerance",
    "elastic_respec": "fault_tolerance", "simulated_failure": "fault_tolerance",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
