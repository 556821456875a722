"""Planning and execution of multi-task PEFT on a shared backbone (port of
``repro.core``): task fusion -> bucket grouping -> pipeline template ->
subgraph schedule, the model generator and the engine."""
from repro_torch.core.task import Bucket, HTask, ParallelismSpec, PEFTTask  # noqa: F401
from repro_torch.core.cost_model import CostModel, HardwareProfile  # noqa: F401
from repro_torch.core.fusion import FusionResult, build_htask, fuse_tasks  # noqa: F401
from repro_torch.core.grouping import balance_buckets, make_buckets  # noqa: F401
from repro_torch.core.pipeline_template import (  # noqa: F401
    PipelineTemplate,
    best_template,
    generate_template,
    simulate,
)
from repro_torch.core.alignment import AlignmentPlan, align_tasks, chunk_size_for  # noqa: F401
from repro_torch.core.planner import ExecutionPlan, ExecutionPlanner  # noqa: F401
from repro_torch.core.registry import ModelGenerator, RegisteredTasks  # noqa: F401
from repro_torch.core.engine import PEFTEngine, StepMetrics  # noqa: F401
