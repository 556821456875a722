"""Synthetic PEFT corpora with the paper's dataset length profiles (§5.1).

SST2 -> pad 64, OpenBookQA -> 128, RTE -> 256, with realistic within-dataset
length variance (sequences are shorter than the pad cap — that gap is what
packing/chunking recovers).  Token ids are deterministic per (dataset, seed)
so runs are reproducible.

Port of ``repro.data.synthetic``: the same numpy code over the port's types.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.task import PEFTTask
from repro_torch.peft.methods import AdapterConfig


@dataclass(frozen=True)
class DatasetProfile:
    name: str
    pad_len: int
    mean_frac: float   # mean true length as a fraction of pad_len
    std_frac: float


DATASETS: Dict[str, DatasetProfile] = {
    "sst2": DatasetProfile("sst2", 64, 0.55, 0.25),
    "qa": DatasetProfile("qa", 128, 0.60, 0.22),
    "rte": DatasetProfile("rte", 256, 0.50, 0.25),
}


def sample_lengths(dataset: str, n: int, seed: int = 0) -> Tuple[int, ...]:
    prof = DATASETS[dataset]
    rng = np.random.RandomState(seed)
    raw = rng.normal(prof.mean_frac, prof.std_frac, n) * prof.pad_len
    lens = np.clip(np.round(raw), 8, prof.pad_len).astype(int)
    return tuple(int(x) for x in lens)


def make_task(
    task_id: str,
    dataset: str,
    micro_batch: int,
    adapter: Optional[AdapterConfig] = None,
    seed: int = 0,
    n_samples: int = 64,
) -> PEFTTask:
    prof = DATASETS[dataset]
    return PEFTTask(
        task_id=task_id,
        adapter=adapter or AdapterConfig(),
        seq_lengths=sample_lengths(dataset, n_samples, seed),
        micro_batch=micro_batch,
        pad_len=prof.pad_len,
    )


def token_stream(task_id: str, vocab: int, seed: int = 0):
    """Infinite deterministic token generator for a task.

    Learnable structure: a per-task affine recurrence with occasional noise
    tokens — next-token loss decreases under training (the task's "domain"),
    while tasks differ (per-task multiplier), so per-tenant adapter progress
    is observable and distinguishable."""
    h = abs(hash((task_id, seed))) % (2**31)
    rng = np.random.RandomState(h)
    v = max(vocab - 2, 2)
    a = 3 + 2 * (h % 11)      # per-task odd multiplier
    c = 1 + (h % 97)
    x = rng.randint(1, v)
    while True:
        if rng.rand() < 0.1:  # 10% noise keeps entropy > 0
            x = int(rng.randint(1, v))
        else:
            x = int((a * x + c) % v) or 1
        yield x
