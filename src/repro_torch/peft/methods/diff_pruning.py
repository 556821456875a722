"""Diff-Pruning [Guo et al.], structured-row variant — selective:
y += x[:, rows] @ delta with a fixed per-task row mask and a learned delta.

``rows`` is an int32 leaf: it takes no gradient and no optimizer update,
and ``post_init`` rebuilds it from a seed of the site's identity, so every
stack build (in either package) gives the same masks.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod


class DiffPruning(PEFTMethod):
    name = "diff"
    category = "selective"

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {
            # fixed structured mask: ``rows`` selects rank input rows of W
            "rows": ParamSpec(t + (rank,), init="zeros", dtype=torch.int32),
            "delta": ParamSpec(t + (rank, d_out), init="zeros"),
        }

    def post_init(self, params, site, d_in, d_out):
        """Per-slot row subsets from ``np.random.RandomState`` seeded by the
        crc32 of the site's identity (the JAX package's draws, bit for bit)."""
        leaf = params["rows"]
        shape = tuple(leaf.shape)  # [..., capacity, rank]
        rank = shape[-1]
        n = int(np.prod(shape[:-1]))
        seed = zlib.crc32(f"diff:{site}:{d_in}x{d_out}".encode()) % (2**31)
        rng = np.random.RandomState(seed)
        rows = np.stack([rng.choice(d_in, size=rank, replace=d_in < rank)
                         for _ in range(n)]).reshape(shape)
        return dict(params, rows=torch.as_tensor(rows, dtype=torch.int32, device=leaf.device))

    def param_count(self, rank, d_in, d_out) -> int:
        return rank * d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return 2.0 * rank * d_out

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        t = ctx.rows
        idx = p["rows"][t].long().clamp_max(ctx.d_in - 1)  # [B, rank]
        x_sel = torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))  # [B, S, rank]
        delta = p["delta"][t]  # [B, rank, d_out]
        add = torch.einsum("bsr,bro->bso", x_sel.float(), delta.float())
        return add * ctx.gate[:, None, None], None
