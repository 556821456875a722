"""Online multi-tenant serving layer (port of ``repro.serve``): live tenant
arrival and departure against a running PEFTEngine — admission (Eq. 5
memory + saturation gate), a bounded priority wait queue, incremental
re-planning with step reuse, the adapter lifecycle (hot-attach,
checkpoint-out, warm-start), and SLO-aware token-level co-serving of
inference decode traffic next to fine-tuning, and the trace replay through
one service or a fleet (``replay``)."""
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    AdmissionDecision,
    WaitQueue,
)
from repro_torch.serve.service import (  # noqa: F401
    CANCELLED,
    COMPLETED,
    LOST,
    MIGRATED,
    MigrationTicket,
    MuxTuneService,
    QUEUED,
    REJECTED,
    RUNNING,
    TenantRecord,
)
from repro_torch.serve.spec import (  # noqa: F401
    RequestSpec,
    TenantSpec,
)
from repro_torch.serve.inference import (  # noqa: F401
    CoServeConfig,
    DecodeScheduler,
    InferenceRequest,
)
from repro_torch.serve.replay import (  # noqa: F401
    arrival_to_task,
    replay_fleet,
    replay_trace,
    tiny_trace,
)
