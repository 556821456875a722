"""IA3 [Liu et al.] — multiplicative rescaling: y *= (1 + s)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class IA3(PEFTMethod):
    name = "ia3"
    category = "additive"

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        return {"s": ParamSpec((capacity, d_out), init="zeros", axes=(None, None))}

    def param_count(self, rank, d_in, d_out) -> int:
        return d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return float(d_out)

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        s = p["s"][ctx.rows].float()  # [B, d_out]
        mul = 1.0 + s[:, None, :] * ctx.gate[:, None, None]
        return None, mul
