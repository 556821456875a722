"""Admission control for the online serving layer (§3.3 / §5.4 online path)
(port of ``repro.serve.admission``; the memory budget defaults to the
H100's device memory, ``core.cost_model.HBM_BYTES``).

A tenant is admitted onto a running instance iff:
  1. the Eq. 5 memory model says the post-admission fused working set fits
     the per-stage HBM budget (the same ``CostModel.stage_memory`` the
     planner prunes fusion candidates with — admission and planning can
     never disagree about feasibility);
  2. the cost model's saturation curve says co-location stays profitable:
     below tensor-core saturation the fused stage latency grows sub-linearly in the
     number of co-located tenants (Fig. 9b), so the latency-inflation ratio
     vs the slowest solo tenant stays small; past saturation it approaches
     linear and the ``saturation_cap`` gate closes;
  3. the instance has a free tenant slot (``max_tenants``).

Tenants that fail the gate wait in a BOUNDED priority queue: highest
priority first, FIFO within a priority class, rejected outright when the
queue is full.  Departures re-drain the queue in priority order.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs import ArchConfig
from repro_torch.core.cost_model import CostModel, HardwareProfile, HBM_BYTES
from repro_torch.core.fusion import build_htask
from repro_torch.core.task import ParallelismSpec, PEFTTask


@dataclass(frozen=True)
class AdmissionConfig:
    memory_budget: float = HBM_BYTES
    max_tenants: int = 8
    max_queue: int = 16
    # admit while fused-stage latency <= cap * slowest solo-tenant latency
    saturation_cap: float = 4.0
    alignment_mode: str = "chunked"


@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str
    stage_memory_bytes: float = 0.0
    memory_budget: float = 0.0
    saturation: float = 0.0

    def __bool__(self) -> bool:  # truthiness == admitted
        return self.admitted


class AdmissionController:
    def __init__(
        self,
        cfg: ArchConfig,
        parallelism: ParallelismSpec,
        hw: Optional[HardwareProfile] = None,
        config: Optional[AdmissionConfig] = None,
        cost_model_fn=None,
    ):
        """``cost_model_fn(tasks) -> CostModel`` lets the owning service
        inject the PLANNER's model factory so admission gates tenants under
        exactly the model their plan will be costed with (any divergence
        would let admission accept sets the planner then deems infeasible)."""
        self.cfg = cfg
        self.parallelism = parallelism
        self.hw = hw or HardwareProfile()
        self.config = config or AdmissionConfig()
        self._cost_model_fn = cost_model_fn

    # ------------------------------------------------------------------

    def _cost_model(self, tasks: Sequence[PEFTTask]) -> CostModel:
        if self._cost_model_fn is not None:
            return self._cost_model_fn(tasks)
        return CostModel(self.cfg, list(tasks), self.parallelism, self.hw)

    def check(self, resident: Sequence[PEFTTask],
              candidate: PEFTTask) -> AdmissionDecision:
        """Gate ``candidate`` against the residents (Eq. 5 + saturation)."""
        c = self.config
        if len(resident) >= c.max_tenants:
            return AdmissionDecision(False, "tenant_cap")
        tasks = list(resident) + [candidate]
        cm = self._cost_model(tasks)
        mode = c.alignment_mode
        singles = [build_htask(tasks, [i], mode)[0] for i in range(len(tasks))]
        mem = cm.stage_memory(singles)
        if mem > c.memory_budget:
            return AdmissionDecision(False, "memory", mem, c.memory_budget)
        saturation = 1.0
        if resident:
            fused, _ = build_htask(tasks, list(range(len(tasks))), mode)
            lat_all = cm.stage_latency(fused)
            lat_solo = max(cm.stage_latency(h) for h in singles)
            saturation = lat_all / max(lat_solo, 1e-12)
            if saturation > c.saturation_cap:
                return AdmissionDecision(False, "saturated", mem,
                                         c.memory_budget, saturation)
        return AdmissionDecision(True, "ok", mem, c.memory_budget, saturation)

    def resident_memory(self, resident: Sequence[PEFTTask]) -> float:
        """Eq. 5 per-stage bytes of the current resident set (accounting)."""
        if not resident:
            return 0.0
        tasks = list(resident)
        cm = self._cost_model(tasks)
        singles = [build_htask(tasks, [i], self.config.alignment_mode)[0]
                   for i in range(len(tasks))]
        return cm.stage_memory(singles)


class WaitQueue:
    """Bounded priority wait queue: higher priority first, FIFO within a
    class.  ``push`` returns False when the queue is full (hard reject)."""

    def __init__(self, max_queue: int):
        self.max_queue = max_queue
        self._heap: List[Tuple[int, int, object]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, item: object, priority: int = 0) -> bool:
        if len(self._heap) >= self.max_queue:
            return False
        heapq.heappush(self._heap, (-priority, next(self._seq), item))
        return True

    def pop(self) -> Optional[object]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[object]:
        return self._heap[0][2] if self._heap else None

    def remove(self, pred) -> List[object]:
        """Remove (and return) queued items matching ``pred`` — cancellation
        of a tenant that never got admitted."""
        hit = [e for e in self._heap if pred(e[2])]
        if hit:
            self._heap = [e for e in self._heap if not pred(e[2])]
            heapq.heapify(self._heap)
        return [e[2] for e in hit]

    def items(self) -> List[object]:
        return [e[2] for e in sorted(self._heap)]
