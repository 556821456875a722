"""Streaming loader: materializes fused hTask batches from alignment plans.

Batches are produced in the exact layout the planner committed to (static
shapes per bucket, §3.4.1(i)): tokens/labels/loss_mask/segment_ids/positions
/reset arrays match ``AlignmentPlan.arrays()``; token contents stream from
per-task generators.

Port of ``repro.data.loader``: the same numpy code over the port's types.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.alignment import AlignmentPlan
from repro_torch.core.task import PEFTTask
from repro_torch.data.synthetic import token_stream


class HTaskLoader:
    def __init__(
        self,
        tasks: Sequence[PEFTTask],
        plan: AlignmentPlan,
        vocab: int,
        seed: int = 0,
        streams: Optional[Dict[int, Iterator[int]]] = None,
    ):
        """``streams`` (keyed by GLOBAL task index) lets a serving controller
        hand in per-tenant generators that PERSIST across re-plans: when the
        task census changes and loaders are rebuilt, each surviving tenant
        resumes its corpus where it left off instead of restarting — the data
        a tenant sees is invariant to other tenants' arrival/departure."""
        self.tasks = list(tasks)
        self.plan = plan
        self.vocab = vocab
        self._streams = streams if streams is not None else {
            i: token_stream(t.task_id, vocab, seed) for i, t in enumerate(self.tasks)
        }
        self._layout = plan.arrays()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, L = len(self.plan.rows), self.plan.row_len
        tokens = np.zeros((B, L), np.int32)
        for b, row in enumerate(self.plan.rows):
            stream = self._streams[row.task]
            for s in row.segments:
                for j in range(s.length):
                    tokens[b, s.start + j] = next(stream)
        labels = np.roll(tokens, -1, axis=1)
        mask = self._layout["loss_mask"].copy()
        # never predict across a segment boundary: drop last token of each seg
        seg = self._layout["segment_ids"]
        boundary = np.zeros_like(mask)
        boundary[:, :-1] = (seg[:, 1:] != seg[:, :-1]).astype(np.float32)
        boundary[:, -1] = 1.0
        mask = mask * (1.0 - boundary)
        return {
            "tokens": tokens,
            "labels": labels,
            "loss_mask": mask.astype(np.float32),
            "segment_ids": seg,
            "positions": self._layout["positions"],
            "reset": self._layout["reset"],
        }
