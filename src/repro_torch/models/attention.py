"""GQA attention with RoPE: prefill through packed attention, decode through
split-KV decode attention (port of ``repro.models.attention``).  A config
with ``attention_bias`` (starcoder2, qwen2-vl, whisper) adds ``b_q`` /
``b_k`` / ``b_v`` / ``b_o``, each added at its BaseOp before the adapters
apply.

qwen2-vl's M-RoPE replaces RoPE where the config has ``mrope`` and the
caller passes ``mrope_positions`` [3, B, S]; otherwise RoPE applies (its
training batches carry none).  Whisper's encoder attends non-causally
(``causal=False``), and its cross-attention takes the encoder's k/v rows
(``kv_override``).  The JAX package runs the cross-attention through
``flash_attention_kvscan``, an XLA function, not a Pallas kernel; the port
routes it through the packed-attention op (``kops.cross_attention``:
non-causal, every key visible, f32 softmax, the same function), so on the
card it is the packed-attention kernel (forward, dq, dk/dv) at S query rows
over Sk encoder rows.  As in the JAX package, q is rotated by RoPE in every
attention of whisper, the cross-attention's too, while the encoder's k rows
of a cross-attention are not.

Three modes, as in the JAX package, picked by the sharding plan
(``repro_torch.launch.rules.attn_mode_for``): ``pairs`` (head-sharded or one
rank: the packed-attention op, the kernels on the card), ``kvscan`` (q
stays sequence-sharded, k / v are all-gathered over the rules' ``seq`` axis
when a mesh is active; :func:`flash_attention_kvscan`, plain PyTorch as the
JAX version is an XLA function) and ``striped_cp`` (the striped
load-balanced CP attention of ``repro_torch.models.cp_attention``; the
batch carries each token's global position).  On one rank ``kvscan`` gives
what ``pairs`` gives.

The decode path updates the KV cache in place, where the JAX package
returns a new cache: ``attention_decode_apply`` writes the new token's k/v
into the cache tensors it was given and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import active_rules
from repro_torch.kernels import ops as kops
from repro_torch.models.cp_attention import NEG_INF, prefix_carry, striped_cp_attention
from repro_torch.models.layers import ParamSpec, apply_mrope, apply_rope, rms_norm
from repro_torch.peft.hooks import active_context, apply_base_op


def attention_spec(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    s = {
        "w_q": ParamSpec((d, h, dh), axes=("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d, hkv, dh), axes=("embed", "kv_heads", "head_dim")),
        "w_v": ParamSpec((d, hkv, dh), axes=("embed", "kv_heads", "head_dim")),
        "w_o": ParamSpec((h, dh, d), axes=("heads", "head_dim", "embed")),
    }
    if cfg.attention_bias:  # zeros at init, as in the JAX package
        s["b_q"] = ParamSpec((h, dh), init="zeros", axes=("heads", "head_dim"))
        s["b_k"] = ParamSpec((hkv, dh), init="zeros", axes=("kv_heads", "head_dim"))
        s["b_v"] = ParamSpec((hkv, dh), init="zeros", axes=("kv_heads", "head_dim"))
        s["b_o"] = ParamSpec((d,), init="zeros", axes=("embed",))
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), init="ones", axes=("head_dim",))
        s["k_norm"] = ParamSpec((dh,), init="ones", axes=("head_dim",))
    return s


def _project_qkv(p, x, cfg: ArchConfig, positions, mrope_positions=None, kv: bool = True):
    """q, k, v over x with RoPE (M-RoPE where the config has it and
    ``mrope_positions`` are given).  ``kv=False`` projects q alone and
    returns (q, None, None): whisper's cross-attention, whose k/v rows come
    from the encoder."""
    q = apply_base_op("attn_q", x, p["w_q"], "bsd,dhk->bshk", bias=p.get("b_q"))
    k = v = None
    if kv:
        k = apply_base_op("attn_k", x, p["w_k"], "bsd,dhk->bshk", bias=p.get("b_k"))
        v = apply_base_op("attn_v", x, p["w_v"], "bsd,dhk->bshk", bias=p.get("b_v"))
    if cfg.qk_norm:  # qwen3: per-head RMSNorm over dh, before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps) if kv else None
    def rope(t):
        if cfg.mrope and mrope_positions is not None:
            return apply_mrope(t, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        return apply_rope(t, positions, cfg.rope_theta)
    return rope(q), (rope(k) if kv else None), v


def _fit_block(S: int, want: int) -> int:
    """The largest divisor of S that is at most ``want``."""
    want = max(1, min(want, S))
    if S % want == 0:
        return want
    return max(d for d in range(1, want + 1) if S % d == 0)


def flash_attention_kvscan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           kv_block: int, causal: bool = True,
                           segment_ids: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None,
                           kv_segment_ids: Optional[torch.Tensor] = None,
                           kv_positions: Optional[torch.Tensor] = None,
                           kv_prefix=None) -> torch.Tensor:
    """q [B, S, H, dh] over k / v [B, Sk, Hkv, dh], a scan over kv blocks
    that updates every q row with an f32 online softmax (JAX
    ``flash_attention_kvscan``).  Without positions q and k count from 0;
    with them, k takes ``kv_positions`` (default: q's, self-attention) and
    ``kv_segment_ids`` (default: q's).  ``kv_prefix = (pk, pv, keep)`` seeds
    the carry with the learned prefix rows."""
    B, S, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    blk = _fit_block(Sk, kv_block)
    n = Sk // blk
    scale = 1.0 / float(np.sqrt(dh))
    dev = q.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=dev).expand(B, Sk)
    elif kv_positions is None:
        assert S == Sk, "packed positions require self-attention (S == Sk)"
        kv_positions = positions
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    q5 = q.reshape(B, S, Hkv, G, dh).float()
    if kv_prefix is not None:
        o, m, l = prefix_carry(q5, kv_prefix, scale)
    else:
        o = q.new_zeros((B, S, Hkv, G, dh), dtype=torch.float32)
        m = q.new_full((B, S, Hkv, G), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((B, S, Hkv, G), dtype=torch.float32)
    for j in range(n):
        sl = slice(j * blk, (j + 1) * blk)
        s = torch.einsum("bqkgd,bpkd->bqkgp", q5, k[:, sl].float()) * scale
        mask = torch.ones((B, S, blk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (positions[:, :, None] >= kv_positions[:, sl][:, None, :])
        if segment_ids is not None:
            mask = mask & (segment_ids[:, :, None] == kv_segment_ids[:, sl][:, None, :])
        s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bqkgp,bpkd->bqkgd", p, v[:, sl].float())
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, S, H, dh).to(q.dtype)


def _seq_mesh():
    """(mesh, the rules' ``seq`` axes) when an active mesh shards the
    sequence over more than one rank, else (mesh or None, None)."""
    mesh, rules = active_rules()
    axes = rules.lookup("seq") if (mesh is not None and rules is not None) else None
    if axes is None or mesh.axis_size(axes) == 1:
        return mesh, None
    return mesh, axes


def _kvscan_mode(q, k, v, cfg: ArchConfig, causal, positions, segment_ids, prefix):
    """``kvscan``: under an active mesh whose rules shard ``seq``, q stays
    this rank's contiguous block and k / v (with their positions and
    segments) are all-gathered over the ``seq`` axes; else one rank."""
    mesh, axes = _seq_mesh()
    kw = dict(kv_block=cfg.attn_kv_block, causal=causal, segment_ids=segment_ids,
              positions=positions, kv_prefix=prefix)
    if axes is None:
        return flash_attention_kvscan(q, k, v, **kw)
    with torch.no_grad():
        kw["kv_positions"] = collectives._all_gather(positions.to(torch.int32).contiguous(),
                                                     axes, mesh, 1)
        if segment_ids is not None:
            kw["kv_segment_ids"] = collectives._all_gather(
                segment_ids.to(torch.int32).contiguous(), axes, mesh, 1)
    if prefix is not None:
        pk, pv, keep = prefix
        kw["kv_prefix"] = (collectives.fan_out(pk, axes, mesh),
                           collectives.fan_out(pv, axes, mesh), keep)
    kg = collectives.all_gather(k, axes, 1, mesh)
    vg = collectives.all_gather(v, axes, 1, mesh)
    return flash_attention_kvscan(q, kg, vg, **kw)


def _cp_degree(mesh) -> int:
    """The CP degree: the size of ``mesh``'s "model" axis (1 without one)."""
    return mesh.shape["model"] if (mesh is not None and "model" in mesh.axis_names) else 1


def _striped_cp_mode(q, k, v, cfg: ArchConfig, positions, segment_ids, prefix):
    """``striped_cp``: the JAX block rule (at least four kv chunks a rank)
    over the CP axis ``model`` of the active mesh, or one rank."""
    mesh, _ = active_rules()
    P_sz = _cp_degree(mesh)
    S = q.shape[1] * P_sz
    blk = max(min(cfg.attn_q_block, 256, S // (4 * P_sz)), 16)
    return striped_cp_attention(q, k, v, positions, segment_ids, mesh, axis="model",
                                block=blk, kv_prefix=prefix)


def attention_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig, *,
                    mode: str = "pairs",
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    mrope_positions: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    return_kv: bool = False):
    """Self-attention over x [B, S, d] in ``mode`` (``pairs``, ``kvscan`` or
    ``striped_cp``), causal unless ``causal=False`` (positions then play no
    part in the mask).  Under ``kvscan`` / ``striped_cp`` with an active mesh,
    x is this rank's block of the sequence (striped for ``striped_cp``, whose
    ``positions`` are the tokens' global ones).  The
    active adapter context's soft-prompt rows (``attn_prefix``), if any,
    enter as learned prefix k/v rows.  ``kv_override = (k, v)`` [B, Sk,
    Hkv, dh] makes it a cross-attention: q alone is projected (the JAX
    package also projects x's k/v there and drops them, which changes no
    output) and attends to every row of the given k/v
    (``kops.cross_attention``).  ``return_kv=True`` also returns the
    post-RoPE (k, v) rows, which the prefill captures into the decode KV
    cache."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        mesh, axes = _seq_mesh() if mode == "kvscan" else (None, None)
        if axes is not None:  # this rank's contiguous block of the sequence
            positions = positions + mesh.axis_index(axes) * S
        elif mode == "striped_cp" and _cp_degree(active_rules()[0]) > 1:
            raise ValueError("striped_cp over a mesh needs the tokens' global positions")
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions, kv=kv_override is None)
    if kv_override is not None:
        k, v = kv_override
        out = kops.cross_attention(q, k, v)
        y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd", bias=p.get("b_o"))
        return (y, (k, v)) if return_kv else y
    ctx = active_context()
    prefix = ctx.attn_prefix() if ctx is not None else None
    prefix_kv = prefix_keep = None
    if prefix is not None:
        pk, pv, prefix_keep = prefix  # [B, P, kv_dim] pair + [B, P] row gate
        shape = (B, pk.shape[1], cfg.num_kv_heads, cfg.resolved_head_dim())
        prefix_kv = (pk.reshape(shape).to(k.dtype), pv.reshape(shape).to(v.dtype))
    full_prefix = prefix_kv + (prefix_keep,) if prefix_kv is not None else None
    if mode == "striped_cp":
        out = _striped_cp_mode(q, k, v, cfg, positions, segment_ids, full_prefix)
    elif mode == "kvscan":
        out = _kvscan_mode(q, k, v, cfg, causal, positions, segment_ids, full_prefix)
    elif mode == "pairs":
        out = kops.packed_attention(q, k, v, segment_ids=segment_ids,
                                    positions=positions if causal else None, causal=causal,
                                    prefix_kv=prefix_kv, prefix_keep=prefix_keep,
                                    block_q=cfg.attn_q_block)
    else:
        raise ValueError(f"attention mode {mode!r}: pairs, kvscan or striped_cp")
    y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd", bias=p.get("b_o"))
    if return_kv:
        return y, (k, v)
    return y


def attention_decode_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                           cfg: ArchConfig, cache: Dict[str, torch.Tensor], *,
                           mrope_positions: Optional[torch.Tensor] = None,
                           update_cache: bool = True
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode token x [B, 1, d] over a per-row KV cache.

    Cache keys (each [B] int32): ``len`` the next write index, ``t`` the real
    token count (the RoPE position; ``len`` minus the prefix region), ``lo``
    the start of the row's valid window.  The new k/v row is written in
    place at ``min(len, Smax - 1)``; the returned dict holds the same cache
    tensors with ``len`` and ``t`` advanced.  (The JAX package also keeps a
    lockstep layout with scalar ``len``; the port's pool is per-row only.)
    ``mrope_positions`` [3, B, 1]: qwen2-vl's M-RoPE channels of the token.

    ``update_cache=False`` reads a fixed cache (whisper's cross-attention
    over the encoder's rows): the window is ``[lo, len)`` and nothing is
    written or advanced.  The JAX package projects the token's k/v there
    and drops them; the port projects q alone, which gives the same output
    and skips two products a layer.  q takes RoPE at ``t`` (the JAX cross
    cache has no ``t``, so it is ``len``, the encoder's row count)."""
    pos, t, lo = cache["len"], cache["t"], cache["lo"]
    positions = t.reshape(-1, 1).to(torch.int32)
    if not update_cache:
        q, _, _ = _project_qkv(p, x, cfg, positions, mrope_positions, kv=False)
        out = kops.decode_attention(q, cache["k"], cache["v"], pos, cache_start=lo)
        y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd", bias=p.get("b_o"))
        return y, cache
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, mrope_positions)
    kc, vc = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    wr = pos.clamp_max(kc.shape[1] - 1).long()
    kc[rows, wr] = k_new[:, 0].to(kc.dtype)
    vc[rows, wr] = v_new[:, 0].to(vc.dtype)
    out = kops.decode_attention(q, kc, vc, pos + 1, cache_start=lo)
    y = apply_base_op("attn_o", out, p["w_o"], "bshk,hkd->bsd", bias=p.get("b_o"))
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
