"""The ``PEFTMethod`` protocol (port of ``repro.peft.methods.base``): what a
method declares so that it can be multiplexed against a shared backbone.

A method declares its attach sites and stacked parameter specs, its
Dispatch/Aggregate rule over a fused batch, its per-task footprint for the
planner (``param_count``, ``flops_per_token``), its slot scale, and which
leaves carry no task axis (``shared_params``: frozen and shared by every
tenant of the kind).  The checkpoint schema comes with the checkpoint store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import ParamSpec

SiteDims = Dict[str, Tuple[int, int]]  # site name -> (d_in, d_out)


@dataclass
class ApplyContext:
    """Per-site Dispatch context for one fused batch (batch-row indexed)."""

    slots: torch.Tensor            # [B] int32 slot in this kind's stack; -1 = none
    gate: torch.Tensor             # [B] f32: 1.0 where slots >= 0
    scale: torch.Tensor            # [capacity] f32 per-slot aggregate scale

    @property
    def rows(self) -> torch.Tensor:
        """Gather-safe slot index per batch row (clamped; mask via gate)."""
        return self.slots.clamp_min(0).long()


class PEFTMethod:
    """Base class / protocol for a PEFT method plugin."""

    name: str = ""
    #: adapter leaf names WITHOUT a task axis (frozen, shared by the kind)
    shared_params: frozenset = frozenset()
    #: True if the method injects learned k/v rows into attention
    uses_attention_prefix: bool = False

    def sites(self, targets: Sequence[str], dims: SiteDims,
              attention: bool = True) -> SiteDims:
        """Attach at every requested target the architecture has."""
        return {n: dims[n] for n in targets if n in dims}

    def param_specs(self, rank: int, d_in: int, d_out: int,
                    capacity: int) -> Dict[str, ParamSpec]:
        raise NotImplementedError

    def param_count(self, rank: int, d_in: int, d_out: int) -> int:
        """Trainable params per task per site (drives Eq. 5 memory)."""
        raise NotImplementedError

    def shared_param_count(self, rank: int, d_in: int, d_out: int) -> int:
        """Params of the ``shared_params`` leaves per site, paid once per
        kind stack."""
        return 0

    def flops_per_token(self, rank: int, d_in: int, d_out: int) -> float:
        """Forward FLOPs per token of one adapter application."""
        raise NotImplementedError

    def slot_scale(self, adapter: Any) -> float:
        return 1.0

    def apply(self, p: Dict[str, torch.Tensor], x: torch.Tensor, base_out: torch.Tensor,
              ctx: ApplyContext) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Returns ``(add, mul)`` over x [B, S, d_in] / base_out [B, S, d_out]:
        an additive f32 delta (or None) and a multiplicative factor (or
        None), both identity on rows whose gate is 0."""
        raise NotImplementedError
