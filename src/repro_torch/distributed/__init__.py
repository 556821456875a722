"""Checkpointing and restart supervision (port of ``repro.distributed``,
one device: the store and the training supervisor)."""
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
    SupervisorConfig,
    TrainSupervisor,
    simulated_failure,
)
