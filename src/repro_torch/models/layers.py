"""Shared layer primitives (port of ``repro.models.layers``): parameter
specs with seeded init, RMSNorm, RoPE, the gated MLP, embed / unembed.

Rounding follows the JAX package: norms and RoPE compute in f32 and cast
back; SiLU runs in f32, is cast to the working type, then multiplied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape and init rule (the JAX ``ParamSpec``
    without its sharding axes).  Leaves are bf16 at init; ``dtype`` names a
    leaf stored in a type of its own (the int8 tier's ``q`` and ``scale``),
    which a conversion keeps whatever type it is asked for."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: Optional[torch.dtype] = None


def materialize(spec_tree: Any, generator: torch.Generator, device: torch.device) -> Any:
    """Initialise a parameter tree (nested dicts) from a ParamSpec tree with
    an explicit generator.  Leaves are drawn in sorted key order, so a seed
    gives one tree."""
    if isinstance(spec_tree, ParamSpec):
        dt = torch.bfloat16
        if spec_tree.init == "zeros":
            return torch.zeros(spec_tree.shape, dtype=dt, device=device)
        if spec_tree.init == "ones":
            return torch.ones(spec_tree.shape, dtype=dt, device=device)
        w = torch.randn(spec_tree.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * spec_tree.scale).to(dt)
    return {k: materialize(spec_tree[k], generator, device)
            for k in sorted(spec_tree)}


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions broadcastable to [..., S].  Half-split
    convention: the first and second halves of dh form the rotated pairs."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].float() * inv      # [..., S, dh/2]
    ang = ang[..., None, :]                       # [..., S, 1, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d: int, ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d, ff)),
        "w_up": ParamSpec((d, ff)),
        "w_down": ParamSpec((ff, d)),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated (SwiGLU) MLP over x [B, S, d]; every projection is a BaseOp."""
    from repro_torch.peft.hooks import apply_base_op

    g = apply_base_op("mlp_gate", x, p["w_gate"], "bsd,df->bsf")
    u = apply_base_op("mlp_up", x, p["w_up"], "bsd,df->bsf")
    h = F.silu(g.float()).to(x.dtype) * u
    return apply_base_op("mlp_down", h, p["w_down"], "bsf,fd->bsd")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embed_spec(vocab: int, d: int, tie: bool = True) -> Dict[str, ParamSpec]:
    """Embedding table; untied configs add the unembedding ``unembed``
    [d, vocab], tied ones read the table in both directions."""
    s = {"tok": ParamSpec((vocab, d), scale=0.01)}
    if not tie:
        s["unembed"] = ParamSpec((d, vocab), scale=0.01)
    return s


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return torch.einsum("bsd,dv->bsv", x, p["unembed"])
    return torch.einsum("bsd,vd->bsv", x, p["tok"])
