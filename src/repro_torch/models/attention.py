"""GQA attention with RoPE: prefill through packed attention, decode through
split-KV decode attention (port of ``repro.models.attention``, ``pairs``
mode only, single device).

The decode path updates the KV cache in place, where the JAX package
returns a new cache: ``attention_decode_apply`` writes the new token's k/v
into the cache tensors it was given and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamSpec, apply_rope
from repro_torch.peft.hooks import apply_base_op


def attention_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    return {
        "w_q": ParamSpec((d, h, dh)),
        "w_k": ParamSpec((d, hkv, dh)),
        "w_v": ParamSpec((d, hkv, dh)),
        "w_o": ParamSpec((h, dh, d)),
    }


def _project_qkv(p, x, cfg: ArchConfig, positions):
    q = apply_base_op("attn_q", x, p["w_q"], "bsd,dhk->bshk")
    k = apply_base_op("attn_k", x, p["w_k"], "bsd,dhk->bshk")
    v = apply_base_op("attn_v", x, p["w_v"], "bsd,dhk->bshk")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Causal self-attention over x [B, S, d] (the JAX ``pairs`` mode).
    ``return_kv=True`` also returns the post-RoPE (k, v) rows, which the
    prefill captures into the decode KV cache."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = kops.packed_attention(q, k, v, segment_ids=segment_ids, positions=positions,
                                block_q=cfg.attn_q_block)
    y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd")
    if return_kv:
        return y, (k, v)
    return y


def attention_decode_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                           cfg: ArchConfig, cache: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode token x [B, 1, d] over a per-row KV cache.

    Cache keys (each [B] int32): ``len`` the next write index, ``t`` the real
    token count (the RoPE position; ``len`` minus the prefix region), ``lo``
    the start of the row's valid window.  The new k/v row is written in
    place at ``min(len, Smax - 1)``; the returned dict holds the same cache
    tensors with ``len`` and ``t`` advanced.  (The JAX package also keeps a
    lockstep layout with scalar ``len``; the port's pool is per-row only.)"""
    pos, t, lo = cache["len"], cache["t"], cache["lo"]
    q, k_new, v_new = _project_qkv(p, x, cfg, t.reshape(-1, 1).to(torch.int32))
    kc, vc = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    wr = pos.clamp_max(kc.shape[1] - 1).long()
    kc[rows, wr] = k_new[:, 0].to(kc.dtype)
    vc[rows, wr] = v_new[:, 0].to(vc.dtype)
    out = kops.decode_attention(q, kc, vc, pos + 1, cache_start=lo)
    y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd")
    return y, dict(cache, len=pos + 1, t=t + 1)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
                  dtype=torch.bfloat16, prefix_reserve: int = 0) -> Dict[str, torch.Tensor]:
    """ONE layer's per-row KV cache in the dict contract
    ``attention_decode_apply`` reads: ``len`` the next write index
    (pre-offset by the prefix region), ``t`` the real token count, ``lo``
    the window start.  ``Model.init_decode_state`` builds the stacked
    [L, ...] serving state; this is the single-layer reference layout."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    shape = (batch, prefix_reserve + max_len, hkv, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.full((batch,), prefix_reserve, dtype=torch.int32, device=device),
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
        "lo": torch.full((batch,), prefix_reserve, dtype=torch.int32, device=device),
    }
