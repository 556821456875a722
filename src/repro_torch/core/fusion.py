"""Task fusion: bin-packing M tasks into N hTasks with the DP of Eq. (6).

Tasks are sorted by token count ascending (latency correlates with input
size — backbone homogeneity, §2.1).  ``F(m, n)`` = minimal end-to-end
latency of packing the first m tasks into n hTasks; transitions add the
candidate hTask's average per-stage pipeline latency L(H)/S.  Memory
feasibility (Eq. 5) prunes candidates.  The optimal plan is
``min_N F(M, N)`` with the partition recovered by backtracking.

Port of ``repro.core.fusion``: the same numpy code over the port's types.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.alignment import AlignmentPlan, align_tasks
from repro_torch.core.cost_model import CostModel, HBM_BYTES
from repro_torch.core.task import HTask, ParallelismSpec, PEFTTask


@dataclass
class FusionResult:
    htasks: List[HTask]
    plans: List[AlignmentPlan]          # alignment layout per hTask
    order: List[int]                    # sorted task order used by the DP
    latency_estimate: float
    n_candidates: int                   # DP work (for overhead reporting)


def build_htask(
    tasks: Sequence[PEFTTask],
    member_ids: Sequence[int],
    alignment_mode: str = "chunked",
    min_chunk: int = 64,
) -> Tuple[HTask, AlignmentPlan]:
    plan = align_tasks(tasks, member_ids, mode=alignment_mode, min_chunk=min_chunk)
    h = HTask(
        task_ids=tuple(member_ids),
        tokens=plan.total_tokens,
        rows=len(plan.rows),
        row_len=plan.row_len,
        chunk=plan.chunk,
        effective_tokens=plan.effective_tokens,
        intertask_pad=plan.intertask_pad,
        intratask_pad=plan.intratask_pad,
    )
    return h, plan


def fuse_tasks(
    tasks: Sequence[PEFTTask],
    cost_model: CostModel,
    n_micro: int = 4,
    alignment_mode: str = "chunked",
    memory_budget: float = HBM_BYTES,
    max_htasks: Optional[int] = None,
) -> FusionResult:
    M = len(tasks)
    if M == 0:
        return FusionResult([], [], [], 0.0, 0)
    S = cost_model.parallelism.num_stages
    order = sorted(range(M), key=lambda i: tasks[i].tokens_per_microbatch())
    N_max = max_htasks or M

    # Precompute candidate hTask costs for every contiguous run [i, j] of the
    # sorted order (the DP only ever fuses contiguous runs).
    cand_cost: Dict[Tuple[int, int], float] = {}
    cand_obj: Dict[Tuple[int, int], Tuple[HTask, AlignmentPlan]] = {}
    n_cand = 0
    for i in range(M):
        for j in range(i, M):
            ids = [order[k] for k in range(i, j + 1)]
            h, plan = build_htask(tasks, ids, alignment_mode)
            n_cand += 1
            if not cost_model.fits_memory([h], memory_budget):
                cand_cost[(i, j)] = math.inf
                continue
            cand_cost[(i, j)] = cost_model.pipeline_latency(h, n_micro) / S
            cand_obj[(i, j)] = (h, plan)

    INF = math.inf
    F = np.full((M + 1, N_max + 1), INF)
    arg = np.full((M + 1, N_max + 1), -1, np.int64)
    F[0, 0] = 0.0
    for m in range(1, M + 1):
        for n in range(1, min(m, N_max) + 1):
            best, besti = INF, -1
            for i in range(n - 1, m):
                c = cand_cost[(i, m - 1)]
                if F[i, n - 1] + c < best:
                    best, besti = F[i, n - 1] + c, i
            F[m, n] = best
            arg[m, n] = besti

    best_n = int(np.argmin(F[M, 1 : N_max + 1])) + 1
    assert np.isfinite(F[M, best_n]), "no memory-feasible fusion plan"

    # backtrack
    bounds: List[Tuple[int, int]] = []
    m, n = M, best_n
    while n > 0:
        i = int(arg[m, n])
        bounds.append((i, m - 1))
        m, n = i, n - 1
    bounds.reverse()

    htasks, plans = [], []
    for i, j in bounds:
        h, plan = cand_obj[(i, j)]
        htasks.append(h)
        plans.append(plan)
    return FusionResult(htasks, plans, order, float(F[M, best_n]), n_cand)


def fuse_exhaustive(
    tasks: Sequence[PEFTTask],
    cost_model: CostModel,
    n_micro: int = 4,
    alignment_mode: str = "chunked",
) -> Tuple[List[List[int]], float]:
    """Brute-force contiguous-partition search (small M) — DP optimality oracle."""
    M = len(tasks)
    order = sorted(range(M), key=lambda i: tasks[i].tokens_per_microbatch())
    S = cost_model.parallelism.num_stages
    best: Tuple[float, List[List[int]]] = (math.inf, [])

    def rec(start: int, parts: List[List[int]], acc: float):
        nonlocal best
        if acc >= best[0]:
            return
        if start == M:
            best = (acc, [list(p) for p in parts])
            return
        for end in range(start, M):
            ids = [order[k] for k in range(start, end + 1)]
            h, _ = build_htask(tasks, ids, alignment_mode)
            c = cost_model.pipeline_latency(h, n_micro) / S
            rec(end + 1, parts + [ids], acc + c)

    rec(0, [], 0.0)
    return best[1], best[0]
