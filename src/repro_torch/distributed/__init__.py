"""Checkpointing and fault tolerance (port of ``repro.distributed``, one
device: the store, the training supervisor, the straggler mitigator and the
elastic planner)."""
from repro_torch.distributed.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointStore,
    latest_step,
    prune_checkpoints,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ElasticPlanner,
    HostStat,
    RecoveryAction,
    StragglerMitigator,
    SupervisorConfig,
    TrainSupervisor,
    elastic_respec,
    simulated_failure,
)
