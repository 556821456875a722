"""The ``PEFTMethod`` protocol (port of ``repro.peft.methods.base``): what a
method declares so that it can be multiplexed against a shared backbone.

The port carries the parts the serving path reads: attach sites, stacked
parameter specs, the slot scale and the Dispatch/Aggregate rule.  The
planner's cost hooks and the checkpoint schema come with the training slice.
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


class PEFTMethod:
    """Base class / protocol for a PEFT method plugin."""

    name: str = ""
    #: True if the method injects learned k/v rows into attention
    uses_attention_prefix: bool = False

    def sites(self, targets: Sequence[str], dims: SiteDims) -> SiteDims:
        """Attach at every requested target the architecture has."""
        return {n: dims[n] for n in targets if n in dims}

    def param_specs(self, rank: int, d_in: int, d_out: int,
                    capacity: int) -> Dict[str, ParamSpec]:
        raise NotImplementedError

    def slot_scale(self, adapter: Any) -> float:
        return 1.0

    def apply(self, p: Dict[str, torch.Tensor], x: torch.Tensor, base_out: torch.Tensor,
              ctx: ApplyContext) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Returns ``(add, mul)`` over x [B, S, d_in] / base_out [B, S, d_out]:
        an additive f32 delta (or None) and a multiplicative factor (or
        None), both identity on rows whose gate is 0."""
        raise NotImplementedError
