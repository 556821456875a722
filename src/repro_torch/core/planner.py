"""ExecutionPlanner: fuse -> group -> template -> subgraph schedule (§3.1).

The hierarchical co-scheduler.  Given the dispatched task set, the planner:
 1. aligns per-task data (chunk grid, §3.5),
 2. fuses tasks into hTasks with the Eq. 6 DP over the Eq. 3-5 cost model,
 3. groups hTasks into buckets (Eq. 7) and picks P by simulating the
    structured 1F1B template for every candidate,
 4. emits per-stage subgraph launch schedules (Alg. 1).

Total planning is pure host-side arithmetic — the paper's <10 s overhead
budget holds by construction (no device work).

Port of ``repro.core.planner``: the same numpy code over the port's types.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import ArchConfig
from repro_torch.core.alignment import AlignmentPlan
from repro_torch.core.cost_model import CostModel, HardwareProfile, HBM_BYTES
from repro_torch.core.fusion import FusionResult, fuse_tasks
from repro_torch.core.grouping import make_buckets
from repro_torch.core.pipeline_template import (
    PipelineTemplate,
    SimResult,
    best_template,
    generate_template,
    simulate,
)
from repro_torch.core.subgraph import (
    build_stage_dag,
    fuse_adapters,
    schedule_subgraphs,
    segment_dag,
    simulate_overlap,
)
from repro_torch.core.task import Bucket, HTask, ParallelismSpec, PEFTTask
from repro_torch.peft.multitask import TaskSegments


@dataclass
class ExecutionPlan:
    tasks: List[PEFTTask]
    htasks: List[HTask]
    alignment: List[AlignmentPlan]
    buckets: List[Bucket]
    template: PipelineTemplate
    sim: SimResult
    subgraph_schedules: Dict[int, list]   # bucket idx -> launch schedule
    overlap: Dict[int, object]            # bucket idx -> OverlapResult
    planning_seconds: float
    fusion: FusionResult

    def segments_for(self, htask_idx: int) -> TaskSegments:
        plan = self.alignment[htask_idx]
        return TaskSegments(tuple(r.task for r in plan.rows), len(self.tasks))

    def summary(self) -> Dict[str, float]:
        eff = sum(h.effective_tokens for h in self.htasks)
        tot = sum(h.tokens for h in self.htasks)
        return {
            "n_tasks": len(self.tasks),
            "n_htasks": len(self.htasks),
            "n_buckets": len(self.buckets),
            "est_latency": self.sim.latency,
            "bubble_frac": self.sim.bubble_frac,
            "last_stage_bubble_frac": self.sim.last_stage_bubble_frac,
            "effective_token_frac": eff / tot if tot else 0.0,
            "planning_seconds": self.planning_seconds,
        }


class ExecutionPlanner:
    def __init__(
        self,
        cfg: ArchConfig,
        parallelism: ParallelismSpec,
        hw: Optional[HardwareProfile] = None,
        memory_budget: float = HBM_BYTES,
    ):
        self.cfg = cfg
        self.parallelism = parallelism
        self.hw = hw or HardwareProfile()
        self.memory_budget = memory_budget

    def cost_model(self, tasks: Sequence[PEFTTask],
                   enable_orchestration: bool = True) -> CostModel:
        """The Eq. 3-5 cost/memory model for a prospective task set — shared
        by planning and by the serving layer's admission gate, so a tenant is
        admitted under exactly the model the plan will be costed with."""
        return CostModel(self.cfg, list(tasks), self.parallelism, self.hw,
                         comm_overlapped=enable_orchestration)

    def replan(
        self,
        tasks: Sequence[PEFTTask],
        prev: Optional["ExecutionPlan"] = None,
        **kw,
    ) -> "ExecutionPlan":
        """Re-plan after tenant arrival/departure (online path).

        Planning is pure host arithmetic, so a full re-plan is cheap; the
        expensive asset is COMPILED steps, and those are preserved by the
        engine's hTask-signature cache — an hTask whose fused geometry
        survives the census change lowers to an identical signature and
        reuses its executable.  When the task census is unchanged (e.g. a
        queued tenant cancelled before admission) the previous plan is
        returned as-is."""
        if prev is not None and [t.task_id for t in prev.tasks] == [
                t.task_id for t in tasks]:
            return prev
        return self.plan(tasks, **kw)

    def plan(
        self,
        tasks: Sequence[PEFTTask],
        n_micro: int = 4,
        alignment_mode: str = "chunked",
        enable_fusion: bool = True,
        enable_orchestration: bool = True,
    ) -> ExecutionPlan:
        t0 = time.perf_counter()
        tasks = list(tasks)
        cm = CostModel(self.cfg, tasks, self.parallelism, self.hw,
                       comm_overlapped=enable_orchestration)

        if enable_fusion:
            fusion = fuse_tasks(tasks, cm, n_micro=n_micro,
                                alignment_mode=alignment_mode,
                                memory_budget=self.memory_budget)
        else:
            # ablation: every task its own hTask (temporal-only multiplexing)
            from repro_torch.core.fusion import build_htask

            hs, ps = [], []
            for i in range(len(tasks)):
                h, p = build_htask(tasks, [i], alignment_mode)
                hs.append(h)
                ps.append(p)
            fusion = FusionResult(hs, ps, list(range(len(tasks))), 0.0, len(tasks))

        groupings = make_buckets(fusion.htasks, cm)
        if enable_orchestration and groupings:
            template, sim, _ = best_template(
                groupings, n_micro, self.parallelism.num_stages
            )
        else:
            # naive: one bucket per hTask, arrival order, no sorting
            buckets = groupings[-1] if groupings else []
            template = generate_template(
                buckets, n_micro, self.parallelism.num_stages, order="given"
            )
            sim = simulate(template)

        schedules: Dict[int, list] = {}
        overlaps: Dict[int, object] = {}
        for bi, bucket in enumerate(template.buckets):
            dags = []
            for u, hid in enumerate(bucket.htask_ids):
                nodes = build_stage_dag(self.cfg, fusion.htasks[hid], hid, cm,
                                        layers=1, uid_start=u * 10_000)
                dags.append(segment_dag(nodes, sid_start=u * 1_000))
            dags = fuse_adapters(dags)
            sched = schedule_subgraphs(dags)
            schedules[bi] = sched
            overlaps[bi] = simulate_overlap(sched)

        return ExecutionPlan(
            tasks=tasks,
            htasks=fusion.htasks,
            alignment=fusion.plans,
            buckets=list(template.buckets),
            template=template,
            sim=sim,
            subgraph_schedules=schedules,
            overlap=overlaps,
            planning_seconds=time.perf_counter() - t0,
            fusion=fusion,
        )
