"""Structured 1F1B pipeline template (§3.4.1 + Appendix A) and its simulator.

Template rules:
 (1) buckets sorted by first-stage latency, DESCENDING — later (shorter)
     buckets fill the drain bubbles of earlier ones (Fig. 10b / Lemma 3);
 (2) micro-batches of one bucket stay consecutive (latency-matched);
 (3) micro-batches launch eagerly up to the memory-model in-flight limit.

The simulator executes the template against per-(bucket, stage) latencies
with exact 1F1B dependencies (fwd(m,s) after fwd(m,s-1); bwd(m,s) after
bwd(m,s+1); bwd ready after last-stage fwd; per-stage in-order issue) and
reports end-to-end latency plus per-stage bubble time — the quantity
Appendix A proves is ~zero at the last stage for this template.
PEFT symmetry (bwd == fwd latency per stage) is assumed, as in the paper.

Port of ``repro.core.pipeline_template``: the same numpy code over the port's types.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.task import Bucket


@dataclass(frozen=True)
class MicroBatch:
    bucket: int   # bucket index (into the template's bucket list)
    index: int    # micro-batch number within the bucket


@dataclass
class PipelineTemplate:
    buckets: List[Bucket]            # in launch order (sorted rule 1)
    micro_order: List[MicroBatch]    # global launch order (rule 2)
    num_stages: int
    max_inflight: int                # rule 3 (memory-model limit)

    @property
    def n_micro(self) -> int:
        return len(self.micro_order)


def generate_template(
    buckets: Sequence[Bucket],
    n_micro_per_bucket: int,
    num_stages: int,
    max_inflight: Optional[int] = None,
    order: str = "desc",  # desc (ours) | asc | given  (Fig. 22 comparisons)
) -> PipelineTemplate:
    idx = list(range(len(buckets)))
    if order == "desc":
        idx.sort(key=lambda i: -buckets[i].first_stage_latency)
    elif order == "asc":
        idx.sort(key=lambda i: buckets[i].first_stage_latency)
    ordered = [buckets[i] for i in idx]
    micro = [
        MicroBatch(b, m)
        for b, _ in enumerate(ordered)
        for m in range(n_micro_per_bucket)
    ]
    return PipelineTemplate(
        buckets=ordered,
        micro_order=micro,
        num_stages=num_stages,
        max_inflight=max_inflight or num_stages,
    )


@dataclass
class SimResult:
    latency: float
    stage_busy: List[float]
    stage_bubble: List[float]
    per_stage_spans: List[List[Tuple[float, float, str]]]  # (start, end, tag)

    @property
    def last_stage_bubble_frac(self) -> float:
        s = self.stage_busy[-1] + self.stage_bubble[-1]
        return self.stage_bubble[-1] / s if s else 0.0

    @property
    def bubble_frac(self) -> float:
        busy = sum(self.stage_busy)
        tot = busy + sum(self.stage_bubble)
        return 1.0 - busy / tot if tot else 0.0


def simulate(template: PipelineTemplate, record_spans: bool = False) -> SimResult:
    """Event simulation of the multi-bucket 1F1B schedule."""
    S = template.num_stages
    M = template.n_micro
    micro = template.micro_order

    def f_lat(m: MicroBatch, s: int) -> float:
        lat = template.buckets[m.bucket].stage_latency
        return lat[s] if s < len(lat) else lat[-1]

    # per-stage instruction streams in classic 1F1B order with eager warmup
    instr: List[List[Tuple[str, int]]] = []
    for s in range(S):
        warm = min(S - s - 1 + (template.max_inflight - S), M)
        warm = max(min(warm, M), min(S - s - 1, M))
        seq: List[Tuple[str, int]] = [("F", i) for i in range(warm)]
        nf, nb = warm, 0
        while nb < M:
            if nf < M:
                seq.append(("F", nf))
                nf += 1
            seq.append(("B", nb))
            nb += 1
        instr.append(seq)

    f_done = np.full((M, S), math.inf)
    b_done = np.full((M, S), math.inf)
    stage_t = np.zeros(S)
    busy = np.zeros(S)
    spans: List[List[Tuple[float, float, str]]] = [[] for _ in range(S)]
    ptr = [0] * S

    # iterate until all instruction streams are drained; each pass executes
    # any head-of-queue instruction whose dependency is satisfied
    remaining = sum(len(q) for q in instr)
    guard = 0
    while remaining > 0:
        progressed = False
        for s in range(S):
            while ptr[s] < len(instr[s]):
                phase, i = instr[s][ptr[s]]
                m = micro[i]
                if phase == "F":
                    dep = 0.0 if s == 0 else f_done[i, s - 1]
                else:
                    dep = f_done[i, S - 1] if s == S - 1 else b_done[i, s + 1]
                if not math.isfinite(dep):
                    break  # dependency not scheduled yet
                start = max(stage_t[s], dep)
                dur = f_lat(m, s)  # PEFT: bwd == fwd per stage
                end = start + dur
                if phase == "F":
                    f_done[i, s] = end
                else:
                    b_done[i, s] = end
                stage_t[s] = end
                busy[s] += dur
                if record_spans:
                    spans[s].append((start, end, f"{phase}{m.bucket}.{m.index}"))
                ptr[s] += 1
                remaining -= 1
                progressed = True
        guard += 1
        if not progressed:
            raise RuntimeError("pipeline simulation deadlock (bad template)")
        if guard > 100 * (remaining + 1) + 10_000:
            raise RuntimeError("pipeline simulation did not converge")

    latency = float(np.max(stage_t))
    first_start = 0.0
    bubbles = [latency - first_start - busy[s] for s in range(S)]
    return SimResult(latency, [float(b) for b in busy], [float(x) for x in bubbles], spans)


def best_template(
    groupings: Sequence[Sequence[Bucket]],
    n_micro_per_bucket: int,
    num_stages: int,
    max_inflight: Optional[int] = None,
) -> Tuple[PipelineTemplate, SimResult, int]:
    """Pick G*(P): simulate each candidate grouping, minimal latency wins."""
    best: Optional[Tuple[PipelineTemplate, SimResult, int]] = None
    for P_idx, buckets in enumerate(groupings):
        t = generate_template(buckets, n_micro_per_bucket, num_stages, max_inflight)
        r = simulate(t)
        if best is None or r.latency < best[1].latency:
            best = (t, r, P_idx)
    assert best is not None
    return best
