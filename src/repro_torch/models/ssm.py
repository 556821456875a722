"""The Mamba2 block of the hybrid family and the mLSTM / sLSTM blocks of the
``ssm`` family (port of ``repro.models.ssm``: the training branch and the
decode branch of each).

The block's in-projection gives ``[z, x, B, C, dt]``; x, B and C pass a
causal depthwise convolution and SiLU; the chunked SSD scan
(:func:`repro_torch.kernels.ops.mamba_scan`) runs per head with decay
``exp(dt * -exp(a_log))``, input gate ``dt`` and C / B as the scan's q / k,
broadcast over the heads; a skip ``d_skip * x``, the ``silu(z)`` gate and an
RMSNorm precede the out-projection.  Both projections are BaseOps
(``ssm_in``, ``ssm_out``), so adapters attach there.

Rounding follows the JAX package: SiLU of the convolution, the softplus of
dt and the skip run in f32 and are cast back to the working type.

The convolution ignores ``reset`` (as the JAX package's does): a packed
sequence's first three tokens see conv inputs of the row's previous
segment; only the scan is cut at segment starts.

Decode (``state`` given, one token a row): the conv runs over a rolling
window of the last three inputs (``state["conv"]``), its four taps summed
with one ``sum`` as the JAX decode branch does (the training branch adds
them one by one, so the two branches round apart); the scan is one
recurrent step in f32 (:func:`gla_decode_step`, no kernel: the JAX package
has none either).  The state is updated in place.  The window must be in
the block's working type: an f32 run widens the bf16 window of
:func:`mamba2_init_state` first (``Model.decode_step`` does), as the JAX
package's concatenation widens it.

The mLSTM block (xlstm's matrix memory) runs the same scan with the block's
own q / k / v projections (BaseOps ``attn_q`` / ``attn_k`` / ``attn_v`` on
the inner width), sigmoid gates from ``w_gates`` (``log_sigmoid`` in f32)
and its normalizer as an extra ones-column of v (dv = head width + 1);
``y / max(|n|, 1)``, an RMSNorm and the ``silu(z)`` gate precede the
down-projection.  As in the JAX package, k is divided by sqrt(head width)
after its BaseOp, which widens it to f32 (a bf16 array over a numpy
float64 there); ``ops.mamba_scan`` hands the kernels k in q's type.  Decode
is one :func:`gla_decode_step` on the block's [B, H, hd, hd + 1] f32 state.

The sLSTM block (scalar memory) is a strict time recurrence over S: a plain
f32 loop (the JAX ``lax.scan``), with per-head recurrent matrices ``r`` and
the exponential gating's stabiliser ``m``.  It takes no ``reset``: a packed
row's sLSTM state runs on across its segments, as in the JAX package.  Its
out-projection is the BaseOp ``ssm_out``, whose adapters the JAX package
declares at the mLSTM's width (d_in, d); an ``ssm_out`` tenant therefore
cannot run on an sLSTM block, and the port raises naming the site.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.peft.hooks import active_context, apply_base_op

CONV_W = 4


def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(inner width, heads, state size)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_state


def mamba2_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, nh, st = mamba2_dims(cfg)
    # in-proj: [z (d_in), x (d_in), B (st), C (st), dt (nh)]
    return {
        "w_in": ParamSpec((d, 2 * d_in + 2 * st + nh), axes=("embed", "ssm_inner")),
        "conv": ParamSpec((CONV_W, d_in + 2 * st), scale=0.1, axes=(None, "ssm_inner")),
        "dt_bias": ParamSpec((nh,), init="zeros", axes=(None,)),
        "a_log": ParamSpec((nh,), init="ones", scale=1.0, axes=(None,)),
        "d_skip": ParamSpec((nh,), init="ones", axes=(None,)),
        "norm": ParamSpec((d_in,), init="ones", axes=("ssm_inner",)),
        "w_out": ParamSpec((d_in, d), axes=("ssm_inner", "embed")),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [W, C] -> causal depthwise conv, taps summed in order."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, log_input: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step of the gated linear attention, in f32: q / k
    [B, 1, H, dk], v [B, 1, H, dv], the log gates [B, 1, H], h [B, H, dk,
    dv] f32.  ``h' = exp(la) h + exp(li) k v^T``, ``y = q h'`` cast to q's
    type; returns (y [B, 1, H, dv], h')."""
    a = torch.exp(log_decay.float())[:, 0, :, None, None]
    b = torch.exp(log_input.float())[:, 0, :, None, None]
    kv = torch.einsum("bhd,bhv->bhdv", k[:, 0].float(), v[:, 0].float())
    h_new = a * h + b * kv
    y = torch.einsum("bhd,bhdv->bhv", q[:, 0].float(), h_new)
    return y[:, None].to(q.dtype), h_new


def mamba2_init_state(cfg: ArchConfig, batch: int, device, dtype=torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """One Mamba2 block's zero decode state: ``h`` [B, nh, st, hd] f32 and
    the conv window ``conv`` [B, CONV_W - 1, d_in + 2 st] in ``dtype``
    (bf16, as the JAX package's, whatever the KV cache's type)."""
    d_in, nh, st = mamba2_dims(cfg)
    return {
        "h": torch.zeros((batch, nh, st, cfg.ssm_head_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d_in + 2 * st), dtype=dtype, device=device),
    }


def _decode_conv(conv_in: torch.Tensor, w: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The decode branch's conv over ``cat(window, conv_in)``: the taps'
    products in the working type, one f32 ``sum`` over them cast back (the
    JAX ``sum`` of a bf16 array), then the window rolled by one row in
    place.  The window must be in ``conv_in``'s type."""
    if state["conv"].dtype != conv_in.dtype:
        raise ValueError(f"the conv window is {state['conv'].dtype}, the block runs in "
                         f"{conv_in.dtype}: widen the window first, as Model.decode_step does")
    buf = torch.cat([state["conv"], conv_in], dim=1)
    prod = buf[:, -CONV_W:, :] * w[None]
    out = prod.float().sum(dim=1, keepdim=True).to(prod.dtype)
    state["conv"].copy_(buf[:, 1:, :])
    return out


def mamba2_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                 reset: Optional[torch.Tensor] = None,
                 state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One Mamba2 block over x [B, S, d]: the training / prefill branch, where
    ``reset`` [B, S] cuts the scan at packed-segment starts; or, with the
    block's decode ``state`` ({"h", "conv"}, updated in place), one decode
    token a row (S = 1)."""
    B, S, _ = x.shape
    d_in, nh, st = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim

    proj = apply_base_op("ssm_in", x, p["w_in"], "bsd,de->bse")
    z, xin, bmat, cmat, dt_raw = torch.split(proj, [d_in, d_in, st, st, nh], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    if state is None:
        conv_out = _causal_depthwise_conv(conv_in, p["conv"])
    else:
        conv_out = _decode_conv(conv_in, p["conv"], state)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, bmat, cmat = torch.split(conv_out, [d_in, st, st], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # [nh] < 0
    log_decay = dt * a
    log_input = torch.log(torch.clamp(dt, min=1e-9))

    v = xin.reshape(B, S, nh, hd)
    k = bmat[:, :, None, :].expand(B, S, nh, st)
    q = cmat[:, :, None, :].expand(B, S, nh, st)
    if state is None:
        y, _ = kops.mamba_scan(q, k, v, log_decay, log_input, chunk=cfg.ssm_chunk, reset=reset)
    else:
        y, h_new = gla_decode_step(q, k, v, log_decay, log_input, state["h"])
        state["h"].copy_(h_new)

    y = y + p["d_skip"].float()[None, None, :, None] * v.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return apply_base_op("ssm_out", y, p["w_out"], "bse,ed->bsd")


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory; normalizer via v-augmentation)
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head width)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def mlstm_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, nh, _ = mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * d_in), axes=("embed", "ssm_inner")),
        "w_q": ParamSpec((d_in, d_in), axes=("ssm_inner", None)),
        "w_k": ParamSpec((d_in, d_in), axes=("ssm_inner", None)),
        "w_v": ParamSpec((d_in, d_in), axes=("ssm_inner", None)),
        "w_gates": ParamSpec((d_in, 2 * nh), scale=0.01, axes=("ssm_inner", None)),
        "gate_bias": ParamSpec((2 * nh,), init="zeros", axes=(None,)),
        "norm": ParamSpec((d_in,), init="ones", axes=("ssm_inner",)),
        "w_down": ParamSpec((d_in, d), axes=("ssm_inner", "embed")),
    }


def mlstm_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                reset: Optional[torch.Tensor] = None,
                state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One mLSTM block over x [B, S, d]: the chunked scan over the row,
    cut where ``reset`` [B, S] > 0; or, with the block's decode ``state``
    ({"h"} [B, H, hd, hd + 1] f32, updated in place), one token a row."""
    B, S, _ = x.shape
    d_in, nh, hd = mlstm_dims(cfg)
    up = apply_base_op("ssm_in", x, p["w_up"], "bsd,de->bse")
    xin, z = torch.chunk(up, 2, dim=-1)
    q = apply_base_op("attn_q", xin, p["w_q"], "bse,ef->bsf").reshape(B, S, nh, hd)
    k = apply_base_op("attn_k", xin, p["w_k"], "bse,ef->bsf").reshape(B, S, nh, hd)
    k = k.float() / math.sqrt(hd)  # f32, as the JAX package's bf16 / np.sqrt(hd)
    v = apply_base_op("attn_v", xin, p["w_v"], "bse,ef->bsf").reshape(B, S, nh, hd)
    gates = torch.einsum("bse,eg->bsg", xin, p["w_gates"]) + p["gate_bias"]
    f_pre, i_pre = torch.chunk(gates.float(), 2, dim=-1)  # [B, S, nh]
    log_decay = F.logsigmoid(f_pre)
    log_input = F.logsigmoid(i_pre)
    # the normalizer state rides along as an extra ones-column of v
    v_aug = torch.cat([v, torch.ones((B, S, nh, 1), dtype=v.dtype, device=v.device)], dim=-1)
    if state is None:
        y_aug, _ = kops.mamba_scan(q, k, v_aug, log_decay, log_input, chunk=cfg.ssm_chunk,
                                   reset=reset)
    else:
        y_aug, h_new = gla_decode_step(q, k, v_aug, log_decay, log_input, state["h"])
        state["h"].copy_(h_new)
    y, nrm = y_aug[..., :hd], y_aug[..., hd:]
    y = y.float() / torch.clamp(torch.abs(nrm.float()), min=1.0)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return apply_base_op("ssm_out", y, p["w_down"], "bse,ed->bsd")


def mlstm_init_state(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    """One mLSTM block's zero decode state: ``h`` [B, H, hd, hd + 1] f32."""
    _, nh, hd = mlstm_dims(cfg)
    return {"h": torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, strict recurrence)
# ---------------------------------------------------------------------------


SLSTM_STATE = ("c", "n", "m", "h")


def slstm_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    return {
        "w_in": ParamSpec((d, 4 * d), axes=("embed", None)),
        "r": ParamSpec((nh, hd, 4 * hd), scale=0.01, axes=(None, None, None)),
        "norm": ParamSpec((d,), init="ones", axes=("embed",)),
        "w_out": ParamSpec((d, d), axes=("embed", None)),
    }


def slstm_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One sLSTM block over x [B, S, d]: the recurrence over S from zeros,
    or from the block's decode ``state`` (``SLSTM_STATE``, each [B, H, hd]
    f32, updated in place).  No reset: the state runs across a packed row's
    segments, as in the JAX package."""
    ctx = active_context()
    if ctx is not None and ctx.has("ssm_out"):
        raise ValueError(
            "an ssm_out adapter cannot run on an sLSTM block: the site is declared at the "
            f"mLSTM's width ({cfg.ssm_expand * cfg.d_model}, {cfg.d_model}) and the sLSTM's "
            f"w_out is ({cfg.d_model}, {cfg.d_model}) (the JAX package fails there too); "
            "target ssm_in, attn_q, attn_k or attn_v on the ssm family")
    B, S, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    pre = apply_base_op("ssm_in", x, p["w_in"], "bsd,de->bse")
    pre = pre.reshape(B, S, nh, 4 * hd).float()
    if state is None:
        c, n, m, h = (torch.zeros((B, nh, hd), dtype=torch.float32, device=x.device)
                      for _ in SLSTM_STATE)
    else:
        c, n, m, h = (state[k] for k in SLSTM_STATE)
    r = p["r"].float()
    ys = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, r)
        zt, it, ft, ot = torch.split(pre[:, t] + rec, hd, dim=-1)
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * torch.tanh(zt)
        n = f_p * n + i_p
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    if state is not None:
        for k, t in zip(SLSTM_STATE, (c, n, m, h)):
            state[k].copy_(t)
    y = torch.stack(ys, dim=1).reshape(B, S, d).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return apply_base_op("ssm_out", y, p["w_out"], "bsd,de->bse")


def slstm_init_state(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    """One sLSTM block's zero decode state: ``c``, ``n``, ``m``, ``h``
    [B, H, d / H] f32."""
    nh = cfg.num_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device) for k in SLSTM_STATE}
