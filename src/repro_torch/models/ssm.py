"""The Mamba2 block of the hybrid family (port of ``repro.models.ssm``,
training branch).

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
segment; only the scan is cut at segment starts.  The decode branch
(``gla_decode_step`` and the conv window state) and the xLSTM blocks are not
ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.peft.hooks import apply_base_op

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
        "w_in": ParamSpec((d, 2 * d_in + 2 * st + nh)),
        "conv": ParamSpec((CONV_W, d_in + 2 * st), scale=0.1),
        "dt_bias": ParamSpec((nh,), init="zeros"),
        "a_log": ParamSpec((nh,), init="ones", scale=1.0),
        "d_skip": ParamSpec((nh,), init="ones"),
        "norm": ParamSpec((d_in,), init="ones"),
        "w_out": ParamSpec((d_in, d)),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [W, C] -> causal depthwise conv, taps summed in order."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def mamba2_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                 reset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Mamba2 block over x [B, S, d] (the training / prefill branch);
    ``reset`` [B, S] cuts the scan at packed-segment starts."""
    B, S, _ = x.shape
    d_in, nh, st = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim

    proj = apply_base_op("ssm_in", x, p["w_in"], "bsd,de->bse")
    z, xin, bmat, cmat, dt_raw = torch.split(proj, [d_in, d_in, st, st, nh], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = _causal_depthwise_conv(conv_in, p["conv"])
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, bmat, cmat = torch.split(conv_out, [d_in, st, st], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # [nh] < 0
    log_decay = dt * a
    log_input = torch.log(torch.clamp(dt, min=1e-9))

    v = xin.reshape(B, S, nh, hd)
    k = bmat[:, :, None, :].expand(B, S, nh, st)
    q = cmat[:, :, None, :].expand(B, S, nh, st)
    y, _ = kops.mamba_scan(q, k, v, log_decay, log_input, chunk=cfg.ssm_chunk, reset=reset)

    y = y + p["d_skip"].float()[None, None, :, None] * v.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return apply_base_op("ssm_out", y, p["w_out"], "bse,ed->bsd")
