"""Adapter-Tuning [Houlsby et al.] — additive: y += U(gelu(D(y)))."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class AdapterTuning(PEFTMethod):
    name = "adapter"

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {
            "down": ParamSpec(t + (d_out, rank), scale=0.02),
            "up": ParamSpec(t + (rank, d_out), init="zeros"),
        }

    def param_count(self, rank, d_in, d_out) -> int:
        return 2 * rank * d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return 4.0 * rank * d_out

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        t = ctx.rows
        dwn = p["down"][t].float()  # [B, d_out, r]
        up = p["up"][t].float()     # [B, r, d_out]
        h = torch.einsum("bso,bor->bsr", base_out.float(), dwn)
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
        add = torch.einsum("bsr,bro->bso", h, up)
        return add * ctx.gate[:, None, None], None
