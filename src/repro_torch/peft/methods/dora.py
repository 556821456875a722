"""DoRA [Liu et al., 2024] — magnitude-decomposed LoRA (reparameterized).

W' = m . (W + s*BA) / ||W + s*BA||_col : the direction update is a LoRA
delta through the same grouped kernel (``kernels.ops.grouped_lora``), the
magnitude a learned per-column vector relative to the frozen weight's
column norms, m = ||W||_col * (1 + dm) with dm init zero, so a fresh slot
is the identity.  The op's weight reaches ``apply`` as
``ApplyContext.base_weight`` (``reads_base_weight``; on an int8 backbone it
is dequantized at DoRA's sites only).

Column norms of W + s*BA are computed without forming BA per task:
||.||^2_col = ||W||^2 + 2 s <W, AB>_col + s^2 ||AB||^2_col.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class DoRA(PEFTMethod):
    name = "dora"
    category = "reparameterized"
    reads_base_weight = True

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {
            "a": ParamSpec(t + (d_in, rank), scale=0.02, axes=(None, "embed", None)),
            "b": ParamSpec(t + (rank, d_out), init="zeros", axes=(None, None, None)),
            # relative magnitude: effective m = ||W||_col * (1 + dm)
            "dm": ParamSpec(t + (d_out,), init="zeros", axes=(None, None)),
        }

    def param_count(self, rank, d_in, d_out) -> int:
        return d_in * rank + rank * d_out + d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return 2.0 * rank * (d_in + d_out) + 6.0 * d_out

    def slot_scale(self, adapter) -> float:
        return adapter.scale

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        add = kops.grouped_lora(x, p["a"], p["b"], ctx.slots, ctx.scale).float()
        if ctx.base_weight is None:
            return add, None  # no weight in scope: plain LoRA
        w = ctx.base_weight.float()                      # [d_in, d_out]
        af, bf = p["a"].float(), p["b"].float()          # [T, d_in, r], [T, r, d_out]
        s = ctx.scale.float()                            # [T]
        wcol2 = (w * w).sum(dim=0)                       # [d_out]
        wta = torch.einsum("io,tir->tor", w, af)         # [T, d_out, r]
        cross = torch.einsum("tor,tro->to", wta, bf)     # <W, AB>_col
        gram = torch.einsum("tir,tip->trp", af, af)      # [T, r, r]
        ab2 = torch.einsum("trp,tro,tpo->to", gram, bf, bf)
        c2 = wcol2[None] + 2.0 * s[:, None] * cross + (s * s)[:, None] * ab2
        c = c2.clamp_min(1e-12).sqrt()                   # ||W + s*BA||_col
        mag = wcol2.clamp_min(1e-12).sqrt()[None] * (1.0 + p["dm"].float())
        ratio = (mag / c)[ctx.rows]                      # [B, d_out]
        mul = 1.0 + (ratio - 1.0) * ctx.gate[:, None]
        return add, mul[:, None, :]
