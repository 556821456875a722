"""Task-level abstractions: PEFTTask, HTask (hybrid task), Bucket (§3.3/§3.4).

A ``PEFTTask`` is one tenant's fine-tuning job: an adapter config + a data
profile (sequence-length distribution, micro-batch size).  ``HTask`` fuses a
contiguous run of (token-sorted) tasks for spatial batching; ``Bucket``
groups hTasks that interleave within one pipeline clock (intra-stage);
buckets interleave across clocks (inter-stage).

Port of ``repro.core.task``: the same numpy code over the port's types.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.peft.methods import AdapterConfig


@dataclass(frozen=True)
class PEFTTask:
    task_id: str
    adapter: AdapterConfig
    seq_lengths: Tuple[int, ...]  # sampled per-example lengths of the corpus
    micro_batch: int              # rows per micro-batch for this task
    pad_len: int = 0              # 0 -> derived: max(seq_lengths)

    @property
    def max_len(self) -> int:
        return self.pad_len or (max(self.seq_lengths) if self.seq_lengths else 0)

    def tokens_per_microbatch(self) -> int:
        """n_i in the paper: padded token count per micro-batch."""
        return self.micro_batch * self.max_len

    def mean_true_len(self) -> float:
        return float(np.mean(self.seq_lengths)) if self.seq_lengths else 0.0


@dataclass(frozen=True)
class HTask:
    """Tasks [lo, hi) of the sorted task list, spatially fused (§3.3)."""

    task_ids: Tuple[int, ...]          # indices into the planner's task list
    tokens: int                        # sum of n_k over member tasks
    rows: int                          # fused micro-batch rows
    row_len: int                       # aligned row length (chunk multiple)
    chunk: int                         # alignment chunk size (§3.5)
    effective_tokens: int = 0          # non-padding tokens
    intertask_pad: int = 0             # system-side ineffective tokens
    intratask_pad: int = 0             # user-billed padding

    @property
    def n_tasks(self) -> int:
        return len(self.task_ids)


@dataclass(frozen=True)
class Bucket:
    """hTasks interleaved within a pipeline clock (§3.4)."""

    htask_ids: Tuple[int, ...]
    stage_latency: Tuple[float, ...] = ()  # per-stage latency of one micro-batch

    @property
    def first_stage_latency(self) -> float:
        return self.stage_latency[0] if self.stage_latency else 0.0


@dataclass(frozen=True)
class ParallelismSpec:
    """Deployment shape for one instance (S stages x N_g GPUs/chips each)."""

    num_stages: int = 1
    chips_per_stage: int = 1
    tp: int = 1          # tensor-parallel degree within a stage
    dp: int = 1          # data-parallel degree within a stage

    @property
    def total_chips(self) -> int:
        return self.num_stages * self.chips_per_stage
