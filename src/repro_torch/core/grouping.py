"""Workload-balanced hTask grouping (Eq. 7) + P selection by simulation.

For each candidate bucket count P, partition hTasks to minimize inter-bucket
variance of first-stage latencies (balanced workloads -> fewer internal
bubbles), then score each P with the structured-pipeline simulator and keep
the best.  LPT greedy + pairwise-swap refinement solves the min-variance
partition (NP-hard in general; swaps close the gap at these sizes).

Port of ``repro.core.grouping``: the same numpy code over the port's types.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.task import Bucket, HTask


def _bucket_loads(latencies: Sequence[float], assign: Sequence[int], P: int) -> np.ndarray:
    loads = np.zeros(P)
    for h, b in enumerate(assign):
        loads[b] += latencies[h]
    return loads


def balance_buckets(latencies: Sequence[float], P: int) -> List[List[int]]:
    """Variance-minimizing partition of hTasks into P buckets (Eq. 7)."""
    N = len(latencies)
    order = sorted(range(N), key=lambda i: -latencies[i])
    assign = [0] * N
    loads = np.zeros(P)
    for h in order:  # LPT greedy
        b = int(np.argmin(loads))
        assign[h] = b
        loads[b] += latencies[h]

    def var(a):
        return float(np.var(_bucket_loads(latencies, a, P)))

    improved = True
    while improved:
        improved = False
        for i in range(N):
            for j in range(i + 1, N):
                if assign[i] == assign[j]:
                    continue
                a2 = list(assign)
                a2[i], a2[j] = a2[j], a2[i]
                if var(a2) + 1e-18 < var(assign):
                    assign = a2
                    improved = True
    buckets: List[List[int]] = [[] for _ in range(P)]
    for h, b in enumerate(assign):
        buckets[b].append(h)
    return [b for b in buckets if b]


def make_buckets(
    htasks: Sequence[HTask],
    cost_model: CostModel,
) -> List[List[Bucket]]:
    """All candidate groupings G(P) for P = 1..N (planner picks by simulation)."""
    lat = [cost_model.stage_latency(h) for h in htasks]
    out: List[List[Bucket]] = []
    for P in range(1, len(htasks) + 1):
        groups = balance_buckets(lat, P)
        buckets = []
        for g in groups:
            per_stage = np.zeros(cost_model.parallelism.num_stages)
            for h in g:
                per_stage += np.asarray(cost_model.stage_latencies(htasks[h]))
            buckets.append(Bucket(tuple(g), tuple(float(x) for x in per_stage)))
        out.append(buckets)
    return out
