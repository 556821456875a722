"""BitFit [Ben Zaken et al.] — bias-only tuning: y += b, one per-task bias
vector per site (additive)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class BitFit(PEFTMethod):
    name = "bitfit"
    category = "additive"

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        return {"b": ParamSpec((capacity, d_out), init="zeros")}

    def param_count(self, rank, d_in, d_out) -> int:
        return d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return float(d_out)

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        b = p["b"][ctx.rows].float()  # [B, d_out]
        return b[:, None, :] * ctx.gate[:, None, None], None
