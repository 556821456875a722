"""Chunk-based data alignment (§3.5): pack -> chunk -> fused-row layout.

Two steps, exactly as the paper:
 1. per-task sequence packing within a global batch (no convergence impact:
    packing never crosses tasks and attention is segment-masked);
 2. uniform chunk partitioning — chunk = greatest power-of-2 divisor of all
    (task) sequence lengths, min threshold 64 — each sequence occupies a
    whole number of chunks (intra-chunk padding, Fig. 13), rows are filled
    with chunks, and chunks of one sequence stay consecutive with a
    carry-dependency (KV reuse for attention; recurrent-state carry for SSM
    blocks — DESIGN.md §Arch-applicability).

TPU adaptation (static shapes): chunks of one packed sequence stay in the
*same row*; causality across them is enforced by segment ids + per-segment
positions, and SSM state carry by the ``reset`` vector.  The chunk grid is
also the contract that keeps ``row_task`` block-constant for the grouped
LoRA kernel.

Token accounting follows the paper's billing split: intra-task padding
(pad-to-task-max / chunk rounding) is user-billed; inter-task padding from
co-scheduling is system overhead and is what `effective_throughput` excludes.

Port of ``repro.core.alignment``: the same numpy code over the port's types.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.task import PEFTTask


def pow2_divisor(n: int) -> int:
    return n & (-n)


def chunk_size_for(lengths: Sequence[int], min_chunk: int = 64) -> int:
    """Greatest power-of-2 divisor of all lengths, clamped to >= min_chunk."""
    if not lengths:
        return min_chunk
    g = 0
    for l in lengths:
        g = math.gcd(g, int(l))
    c = pow2_divisor(g) if g else min_chunk
    return max(c, min_chunk)


@dataclass(frozen=True)
class Segment:
    """One original sequence placed in a fused row."""

    task: int       # planner task index
    seq_index: int  # index within the task's batch
    start: int      # token offset within the row
    length: int     # true (effective) length
    padded: int     # chunk-rounded footprint


@dataclass
class RowLayout:
    task: int
    segments: List[Segment] = field(default_factory=list)

    def used(self) -> int:
        return sum(s.padded for s in self.segments)


@dataclass
class AlignmentPlan:
    mode: str
    chunk: int
    row_len: int
    rows: List[RowLayout]
    effective_tokens: int
    intratask_pad: int
    intertask_pad: int

    @property
    def total_tokens(self) -> int:
        return len(self.rows) * self.row_len

    @property
    def rows_per_task(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for r in self.rows:
            out[r.task] = out.get(r.task, 0) + 1
        return out

    def arrays(self) -> Dict[str, np.ndarray]:
        """segment_ids / positions / loss_mask / reset for the fused batch."""
        B, L = len(self.rows), self.row_len
        seg = np.zeros((B, L), np.int32)
        pos = np.zeros((B, L), np.int32)
        mask = np.zeros((B, L), np.float32)
        reset = np.zeros((B, L), np.float32)
        for b, row in enumerate(self.rows):
            for j, s in enumerate(row.segments):
                sl = slice(s.start, s.start + s.padded)
                seg[b, sl] = j + 1
                pos[b, s.start:s.start + s.length] = np.arange(s.length)
                mask[b, s.start:s.start + s.length] = 1.0
                reset[b, s.start] = 1.0
        return {"segment_ids": seg, "positions": pos, "loss_mask": mask, "reset": reset}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _task_lengths(task: PEFTTask) -> List[int]:
    """micro_batch sequence lengths drawn (cyclically) from the profile."""
    src = task.seq_lengths or (task.max_len,)
    return [min(int(src[i % len(src)]), task.max_len) for i in range(task.micro_batch)]


def align_tasks(
    tasks: Sequence[PEFTTask],
    member_ids: Sequence[int],
    mode: str = "chunked",
    min_chunk: int = 64,
    row_len: Optional[int] = None,
) -> AlignmentPlan:
    """Fused micro-batch layout for the member tasks of one hTask."""
    members = [(i, tasks[i]) for i in member_ids]
    pad_lens = [t.max_len for _, t in members]

    if mode == "zero_pad":
        # SLoRA-style: every sequence -> one row padded to the global max.
        L = row_len or max(pad_lens)
        rows: List[RowLayout] = []
        eff = intra = inter = 0
        for ti, t in members:
            for si, l in enumerate(_task_lengths(t)):
                rows.append(RowLayout(ti, [Segment(ti, si, 0, l, L)]))
                eff += l
                intra += t.max_len - l          # billed to the user (API pad)
                inter += L - t.max_len          # system padding to global max
        return AlignmentPlan(mode, L, L, rows, eff, intra, inter)

    if mode == "pack_only":
        # industrial packing into long rows; no chunk grid (baseline in Fig 12b)
        L = row_len or max(pad_lens)
        chunk = 1
    else:
        chunk = chunk_size_for(pad_lens, min_chunk)
        L = row_len or _round_up(max(pad_lens), chunk)

    rows = []
    eff = intra = inter = 0
    for ti, t in members:
        lens = sorted(_task_lengths(t), reverse=True)  # FFD
        open_rows: List[RowLayout] = []
        for si, l in enumerate(lens):
            footprint = _round_up(l, chunk)
            placed = False
            for row in open_rows:
                if row.used() + footprint <= L:
                    row.segments.append(Segment(ti, si, row.used(), l, footprint))
                    placed = True
                    break
            if not placed:
                r = RowLayout(ti, [Segment(ti, si, 0, l, footprint)])
                open_rows.append(r)
            eff += l
            intra += footprint - l  # intra-chunk padding (Fig. 13)
        for row in open_rows:
            inter += L - row.used()  # row-remainder chunks: inter-task waste
        rows.extend(open_rows)
    return AlignmentPlan(mode, chunk, L, rows, eff, intra, inter)


def htask_token_count(plan: AlignmentPlan) -> int:
    return plan.total_tokens
