"""Synthetic PEFT corpora and the hTask batch loader (port of ``repro.data``)."""
from repro_torch.data.synthetic import DATASETS, make_task, sample_lengths  # noqa: F401
from repro_torch.data.loader import HTaskLoader  # noqa: F401
