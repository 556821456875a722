"""Prefix-Tuning [Li & Liang] — soft prompt: learned per-task k/v prefixes.

Each task owns ``rank`` learned key/value rows per layer that enter packed
attention as extra leading key rows (post-RoPE key space), seen by every
query of the owning task's batch rows and by no other row (segment -1 /
-2 in ``kernels.ops.packed_attention``).  The attach site is the
pseudo-target ``attn_prefix`` (one per attention layer), declared only
when the backbone has softmax attention.  Serving a prefix tenant needs
the rows folded into the decode cache at bind, which the port's decode
pool does not do yet: it refuses such a tenant.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod, SiteDims

SITE = "attn_prefix"


class PrefixTuning(PEFTMethod):
    name = "prefix"
    category = "soft_prompt"
    uses_attention_prefix = True

    def sites(self, targets: Sequence[str], dims: SiteDims,
              attention: bool = True) -> SiteDims:
        if not attention or "attn_k" not in dims:
            return {}
        kv_dim = dims["attn_k"][1]
        return {SITE: (kv_dim, kv_dim)}

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {"pk": ParamSpec(t + (rank, d_out), scale=0.02),
                "pv": ParamSpec(t + (rank, d_out), scale=0.02)}

    def param_count(self, rank, d_in, d_out) -> int:
        return 2 * rank * d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        # score (q . pk) + weighted pv sum over the `rank` prefix positions
        return 4.0 * rank * d_out

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        return None, None  # never called: ``attn_prefix`` is not a BaseOp name

    def attn_prefix(self, p, ctx: ApplyContext
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        t = ctx.rows
        return p["pk"][t], p["pv"][t]  # [B, P, kv_dim] each
