"""Shared layer primitives (port of ``repro.models.layers``): parameter
specs with seeded init, RMSNorm, RoPE, the gated and the plain (GELU) MLP,
embed / unembed.

Rounding follows the JAX package: norms and RoPE compute in f32 and cast
back; SiLU and GELU run in f32, are cast to the working type, then used.
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
    init: str = "normal"  # normal | zeros | ones | const (filled with ``scale``)
    scale: float = 0.02
    dtype: Optional[torch.dtype] = None


#: a normal leaf of more elements than this is drawn one slice of its leading
#: axis at a time (yi-34b's [60, 7168, 20480] MLP stacks): the whole leaf's f32
#: draw would not fit beside the rest of the backbone on one 80 GB card.  The
#: largest leaf of every other config (deepseek-moe-16b's expert stacks, 5.17 G
#: elements) keeps the whole-leaf draw, so its weights from a seed are as before.
SLICED_DRAW_ELEMENTS = 6 * 2 ** 30


def _draw_normal(spec: ParamSpec, generator: torch.Generator, device, dt) -> torch.Tensor:
    """``N(0, 1) * scale`` in f32, cast to ``dt``; scaled in place, which
    gives the bits of ``w * scale``.  Above ``SLICED_DRAW_ELEMENTS`` each
    slice of the leading axis is drawn in turn from the same generator."""
    numel = 1
    for n in spec.shape:
        numel *= n
    if numel <= SLICED_DRAW_ELEMENTS:
        w = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(spec.scale).to(dt)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    for i in range(spec.shape[0]):
        w = torch.randn(spec.shape[1:], generator=generator, device=device,
                        dtype=torch.float32)
        out[i] = w.mul_(spec.scale)
        del w
    return out


def materialize(spec_tree: Any, generator: torch.Generator, device: torch.device) -> Any:
    """Initialise a parameter tree (nested dicts) from a ParamSpec tree with
    an explicit generator.  Leaves are drawn in sorted key order, so a seed
    gives one tree."""
    if isinstance(spec_tree, ParamSpec):
        dt = spec_tree.dtype or torch.bfloat16
        if spec_tree.init == "zeros":
            return torch.zeros(spec_tree.shape, dtype=dt, device=device)
        if spec_tree.init == "ones":
            return torch.ones(spec_tree.shape, dtype=dt, device=device)
        if spec_tree.init == "const":
            return torch.full(spec_tree.shape, spec_tree.scale, dtype=dt, device=device)
        return _draw_normal(spec_tree, generator, device, dt)
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


def mlp_spec(d: int, ff: int, gated: bool = True, bias: bool = False) -> Dict[str, ParamSpec]:
    """The gated MLP's gate / up / down, or the plain MLP's fc1 / fc2 (with
    zero-initialised biases where ``bias``: the JAX package gives them to
    the audio family only)."""
    if gated:
        return {
            "w_gate": ParamSpec((d, ff)),
            "w_up": ParamSpec((d, ff)),
            "w_down": ParamSpec((ff, d)),
        }
    s = {"w_fc1": ParamSpec((d, ff)), "w_fc2": ParamSpec((ff, d))}
    if bias:
        s["b_fc1"] = ParamSpec((ff,), init="zeros")
        s["b_fc2"] = ParamSpec((d,), init="zeros")
    return s


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, gated: bool = True,
              prefix: str = "mlp") -> torch.Tensor:
    """The MLP over x [B, S, d]: gated (SwiGLU), or fc1, tanh-approximate
    GELU (``jax.nn.gelu``'s default) in f32 cast to x's type, fc2.  Every
    projection is a BaseOp, named ``{prefix}_gate`` / ``_up`` / ``_down``
    or ``{prefix}_fc1`` / ``_fc2`` (the MoE family's shared experts are
    ``shared_mlp_*``)."""
    from repro_torch.peft.hooks import apply_base_op

    if gated:
        g = apply_base_op(f"{prefix}_gate", x, p["w_gate"], "bsd,df->bsf")
        u = apply_base_op(f"{prefix}_up", x, p["w_up"], "bsd,df->bsf")
        h = F.silu(g.float()).to(x.dtype) * u
        return apply_base_op(f"{prefix}_down", h, p["w_down"], "bsf,fd->bsd")
    h = apply_base_op(f"{prefix}_fc1", x, p["w_fc1"], "bsd,df->bsf", bias=p.get("b_fc1"))
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return apply_base_op(f"{prefix}_fc2", h, p["w_fc2"], "bsf,fd->bsd", bias=p.get("b_fc2"))


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
