"""LoRA [Hu et al.] — reparameterized: y += (x A) B * alpha/r.

Dispatch/Aggregate runs through the grouped kernel (``kernels.ops.
grouped_lora``): one launch covers every co-batched LoRA task, with per-row
slot routing and per-slot scales.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class LoRA(PEFTMethod):
    name = "lora"

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {
            "a": ParamSpec(t + (d_in, rank), scale=0.02),
            "b": ParamSpec(t + (rank, d_out), init="zeros"),
        }

    def param_count(self, rank, d_in, d_out) -> int:
        return d_in * rank + rank * d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return 2.0 * rank * (d_in + d_out)

    def slot_scale(self, adapter) -> float:
        return adapter.scale

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        add = kops.grouped_lora(x, p["a"], p["b"], ctx.slots, ctx.scale)
        return add.float(), None
