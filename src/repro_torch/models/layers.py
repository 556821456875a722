"""Shared layer primitives (port of ``repro.models.layers``): parameter
specs with seeded init, RMSNorm and LayerNorm, RoPE, qwen2-vl's M-RoPE,
whisper's sinusoidal position table, the gated and the plain (GELU) MLP,
embed / unembed.

Rounding follows the JAX package: norms, RoPE and M-RoPE compute in f32 and
cast back; SiLU and GELU run in f32, are cast to the working type, then used.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, init rule and logical axes (the JAX
    ``ParamSpec``).  Leaves are bf16 at init; ``dtype`` names a leaf stored
    in a type of its own (the int8 tier's ``q`` and ``scale``), which a
    conversion keeps whatever type it is asked for.  ``axes`` names each
    dim's logical axis (``None``: replicated), from which
    ``repro_torch.launch.steps`` derives a rank's block of the leaf."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | const (filled with ``scale``)
    scale: float = 0.02
    dtype: Optional[torch.dtype] = None
    axes: Optional[Tuple[Optional[str], ...]] = None  # None: every dim replicated

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"ParamSpec: {len(self.axes)} logical axes for shape {self.shape}")

    def logical_axes(self) -> Tuple[Optional[str], ...]:
        return self.axes if self.axes is not None else (None,) * len(self.shape)


def spec_logical_axes(spec_tree: Any) -> Any:
    """The tree of each leaf's logical axes (a tuple per leaf)."""
    if isinstance(spec_tree, ParamSpec):
        return spec_tree.logical_axes()
    return {k: spec_logical_axes(v) for k, v in spec_tree.items()}


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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance, as ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE over x [..., S, H, dh]: the dh/2
    frequency slots split into (t, h, w) ``sections``, each rotated by its
    own channel of ``positions`` [3, ..., S].  With the three channels
    equal (text only) it is :func:`apply_rope`."""
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim / 2 = {half}")
    inv = rope_freqs(dh, theta, x.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device))
    pos = torch.movedim(positions, 0, -1).float()  # [..., S, 3]
    ang = pos[..., sec_id] * inv                   # [..., S, dh/2]
    ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal table [length, dim] f32: sines then cosines."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d: int, ff: int, gated: bool = True, bias: bool = False) -> Dict[str, ParamSpec]:
    """The gated MLP's gate / up / down, or the plain MLP's fc1 / fc2 (with
    zero-initialised biases where ``bias``: the JAX package gives them to
    the audio family only, whisper's encoder and decoder)."""
    if gated:
        return {
            "w_gate": ParamSpec((d, ff), axes=("embed", "ff")),
            "w_up": ParamSpec((d, ff), axes=("embed", "ff")),
            "w_down": ParamSpec((ff, d), axes=("ff", "embed")),
        }
    s = {"w_fc1": ParamSpec((d, ff), axes=("embed", "ff")),
         "w_fc2": ParamSpec((ff, d), axes=("ff", "embed"))}
    if bias:
        s["b_fc1"] = ParamSpec((ff,), init="zeros", axes=("ff",))
        s["b_fc2"] = ParamSpec((d,), init="zeros", axes=("embed",))
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
    s = {"tok": ParamSpec((vocab, d), scale=0.01, axes=("vocab", "embed"))}
    if not tie:
        s["unembed"] = ParamSpec((d, vocab), scale=0.01, axes=("embed", "vocab"))
    return s


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return torch.einsum("bsd,dv->bsv", x, p["unembed"])
    return torch.einsum("bsd,vd->bsv", x, p["tok"])
