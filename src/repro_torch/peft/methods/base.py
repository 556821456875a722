"""The ``PEFTMethod`` protocol (port of ``repro.peft.methods.base``): what a
method declares so that it can be multiplexed against a shared backbone.

A method declares its attach sites and stacked parameter specs, its
deterministic post-init fixups (``post_init``), its Dispatch/Aggregate rule
over a fused batch (``apply``, and ``attn_prefix`` for soft prompts), its
per-task footprint for the planner (``param_count``, ``flops_per_token``),
its slot scale, which leaves carry no task axis (``shared_params``: frozen
and shared by every tenant of the kind, ``trainable`` False), and the
per-task layout of a checkpointed artifact (``checkpoint_schema``).

Categories follow the PEFT survey's extension axis (Han et al., 2024):
``reparameterized`` (LoRA, DoRA, VeRA), ``additive`` (Adapter-Tuning,
BitFit), ``selective`` (Diff-Pruning), ``soft_prompt`` (Prefix-Tuning).
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
    d_in: int = 0
    d_out: int = 0
    #: the op's [d_in, d_out] weight, given only where a resident kind reads
    #: it (``PEFTMethod.reads_base_weight``)
    base_weight: Optional[torch.Tensor] = None

    @property
    def rows(self) -> torch.Tensor:
        """Gather-safe slot index per batch row (clamped; mask via gate)."""
        return self.slots.clamp_min(0).long()


class PEFTMethod:
    """Base class / protocol for a PEFT method plugin."""

    name: str = ""
    category: str = ""                       # survey axis (see module doc)
    #: adapter leaf names WITHOUT a task axis (frozen, shared by the kind)
    shared_params: frozenset = frozenset()
    #: True if the method injects learned k/v rows into attention
    uses_attention_prefix: bool = False
    #: True if ``apply`` reads ``ApplyContext.base_weight``: on an int8
    #: backbone the op's weight is dequantized at such a site, and only there
    reads_base_weight: bool = False

    def sites(self, targets: Sequence[str], dims: SiteDims,
              attention: bool = True) -> SiteDims:
        """Attach at every requested target the architecture has."""
        return {n: dims[n] for n in targets if n in dims}

    def param_specs(self, rank: int, d_in: int, d_out: int,
                    capacity: int) -> Dict[str, ParamSpec]:
        raise NotImplementedError

    def post_init(self, params: Dict[str, torch.Tensor], site: str, d_in: int,
                  d_out: int) -> Dict[str, torch.Tensor]:
        """Deterministic post-init fixups (structural masks, shared frozen
        matrices).  A pure function of (site, dims): it re-runs on every
        stack build, and shared or structural leaves must come back
        bit-identical (and equal to the JAX package's)."""
        return params

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

    def trainable(self, leaf: str) -> bool:
        return leaf not in self.shared_params

    def apply(self, p: Dict[str, torch.Tensor], x: torch.Tensor, base_out: torch.Tensor,
              ctx: ApplyContext) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Returns ``(add, mul)`` over x [B, S, d_in] / base_out [B, S, d_out]:
        an additive f32 delta (or None) and a multiplicative factor (or
        None), both identity on rows whose gate is 0."""
        raise NotImplementedError

    def attn_prefix(self, p: Dict[str, torch.Tensor], ctx: ApplyContext
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-row learned k/v prefixes ([B, P, kv_dim] pair) for methods
        with ``uses_attention_prefix``; None otherwise."""
        return None

    def checkpoint_schema(self, rank: int, d_in: int, d_out: int) -> Dict[str, Dict[str, Any]]:
        """Per-leaf layout of one task's checkpointed artifact at one site
        (before layer stacking): shape, dtype name and whether the leaf is
        shared (frozen, deterministically rebuilt)."""
        out: Dict[str, Dict[str, Any]] = {}
        for leaf, spec in self.param_specs(rank, d_in, d_out, 1).items():
            shared = leaf in self.shared_params
            dtype = spec.dtype or torch.bfloat16
            out[leaf] = {"shape": spec.shape if shared else spec.shape[1:],
                         "dtype": str(dtype).removeprefix("torch."), "shared": shared}
        return out
