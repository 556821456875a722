"""Packed (segment-masked) flash attention forward: Hopper kernel + plain version.

Replaces the Pallas kernel ``_fwd_kernel`` / ``_tile_mask`` / ``_fwd_call``
of ``repro/kernels/packed_attention.py`` (forward; the logsumexp output waits
for the backward).  A key ``k`` is visible to a query ``s`` of the same batch
row when ``(not causal or qpos[s] >= kpos[k])`` and ``(qseg[s] == kseg[k] or
kseg[k] == -1)``: ``kseg == -1`` marks a wildcard row (a learned prefix) seen
by every query, and ``-2`` a row seen by none.  GQA reads kv head
``h // (H // Hkv)``.  ``Sk >= S``: the ``Sk - S`` leading key rows are
prefix rows.

A query that sees no key gives 0 here, in both versions.  (The Pallas kernel
gives the mean of v over the key tiles it visited for such a row: its p is
not masked again after exp.  No row of the serving path is fully masked.)

The CUDA kernel (``csrc/packed_attention.cu``) is bound by its f32 products
on the H100 at the prefill shape; see the source's header.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launch_count = 0  # launches of the CUDA kernel (plain calls are not counted)

NEG_INF = -1e30


def packed_attention_plain(q, k, v, positions, segment_ids, k_positions,
                           k_segment_ids, causal: bool = True) -> torch.Tensor:
    """q [B, S, H, dh], k/v [B, Sk, Hkv, dh], positions/segment_ids [B, S],
    k_positions/k_segment_ids [B, Sk] -> [B, S, H, dh] in q's type (f32 math)."""
    B, S, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q5 = q.float().reshape(B, S, Hkv, G, dh)
    s = torch.einsum("bqkgd,bpkd->bqkgp", q5, k.float()) * (1.0 / math.sqrt(dh))
    mask = (segment_ids[:, :, None] == k_segment_ids[:, None, :]) | \
        (k_segment_ids[:, None, :] == -1)
    if causal:
        mask &= positions[:, :, None] >= k_positions[:, None, :]
    mask = mask[:, :, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    o = torch.einsum("bqkgp,bpkd->bqkgd", p, v.float())
    o = o / p.sum(dim=-1).clamp_min(1e-20)[..., None]
    return o.reshape(B, S, H, dh).to(q.dtype)


def _check(q, k, v, ints):
    if not q.is_cuda:
        raise ValueError("packed_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("packed_attention kernel takes q [B,S,H,dh], k/v [B,Sk,Hkv,dh]")
    B, S, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or Sk < S or H % Hkv:
        raise ValueError(f"packed_attention: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if dh not in (64, 128):
        raise ValueError(f"packed_attention kernel takes head_dim 64 or 128, got {dh}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"packed_attention kernel takes bf16 q/k/v, got {t.dtype}")
    for name, t, n in zip(("positions", "segment_ids", "k_positions", "k_segment_ids"),
                          ints, (S, S, Sk, Sk)):
        if t.dtype != torch.int32 or t.shape != (B, n):
            raise ValueError(f"packed_attention: {name} must be int32 [{B}, {n}]")
    for t in (q, k, v, *ints):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("packed_attention kernel takes contiguous tensors on one card")


def packed_attention_cuda(q, k, v, positions, segment_ids, k_positions,
                          k_segment_ids, causal: bool = True) -> torch.Tensor:
    """The CUDA kernel on the same arguments as :func:`packed_attention_plain`
    (bf16 q/k/v, int32 row ids, all contiguous on one card)."""
    global launch_count
    ints = (positions, segment_ids, k_positions, k_segment_ids)
    _check(q, k, v, ints)
    B, S, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    fn = _build.function("packed_attention", "packed_attention_fwd",
                         [_build.P] * 8 + [_build.I] * 7 + [_build.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
             segment_ids.data_ptr(), k_positions.data_ptr(), k_segment_ids.data_ptr(),
             o.data_ptr(), B, S, Sk, H, Hkv, dh, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("packed_attention", err)
    launch_count += 1
    return o
