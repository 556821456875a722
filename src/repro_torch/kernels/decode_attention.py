"""Split-KV decode attention (forward only): Hopper kernel + plain versions.

Replaces the Pallas kernel ``_stage1_kernel`` / ``decode_attention_pallas``
of ``repro/kernels/decode_attention.py``.  One query token per row attends
over its cache window ``[cache_start, cache_len)``; an empty window gives
finite zeros (the denominator is clamped at 1e-20).

The CUDA kernel (``csrc/decode_attention.cu``) is bound by the bytes of the
cache rows inside the windows.  It is one launch: the splits of ``SPLIT``
cache rows (the last one masked, so any ``Smax`` works, unlike the Pallas
wrapper's divisor search; widened so that a row's splits are at most 8) of
one (row, kv head) form a thread-block cluster, and the cluster's first
block combines their partial softmaxes through distributed shared memory.

``decode_attention_plain`` is ``repro.kernels.ref.decode_attention_ref``;
``decode_attention_split_plain`` is the Pallas kernel's own order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launch_counts = {"decode_attention": 0}  # CUDA launches (plain calls are not counted)

SPLIT = 128  # cache rows per split (one block of the kernel's cluster)


def decode_attention_plain(q, k_cache, v_cache, cache_len, cache_start) -> torch.Tensor:
    """q [B, 1, H, dh], caches [B, Smax, Hkv, dh], cache_len/cache_start [B]
    int -> [B, 1, H, dh] in q's type (f32 math)."""
    B, _, H, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    q5 = q.float().reshape(B, Hkv, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", q5, k_cache.float()) * (1.0 / math.sqrt(dh))
    pos = torch.arange(Smax, device=q.device)
    valid = (pos[None, :] < cache_len.reshape(-1, 1)) & \
        (pos[None, :] >= cache_start.reshape(-1, 1))
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / p.sum(dim=-1).clamp_min(1e-20)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def decode_attention_split_plain(q, k_cache, v_cache, cache_len, cache_start,
                                 split: int = SPLIT) -> torch.Tensor:
    """The Pallas kernel's own order in plain PyTorch: per ``split`` cache
    rows a masked f32 partial softmax (per-split max, exp masked again,
    partial o and l; ``_stage1_kernel``), then the online-softmax combine
    with l clamped at 1e-20 (the wrapper's stage 2).  The last split is
    masked, so any ``Smax`` works.  The same function as
    :func:`decode_attention_plain`, with its f32 sums in another order: a
    second right answer for the comparisons on the card, on no main path."""
    B, _, H, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    n = -(-Smax // split)
    pad = (0, 0, 0, 0, 0, n * split - Smax)
    k = torch.nn.functional.pad(k_cache.float(), pad).reshape(B, n, split, Hkv, dh)
    v = torch.nn.functional.pad(v_cache.float(), pad).reshape(B, n, split, Hkv, dh)
    q5 = q.float().reshape(B, Hkv, G, dh)
    s = torch.einsum("bkgd,bnskd->bkgns", q5, k) * (1.0 / math.sqrt(dh))
    pos = torch.arange(n * split, device=q.device).reshape(n, split)
    valid = (pos < Smax) & (pos < cache_len.reshape(-1, 1, 1)) & \
        (pos >= cache_start.reshape(-1, 1, 1))
    valid = valid[:, None, None]                                  # [B, 1, 1, n, split]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                                            # [B, Hkv, G, n]
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgns,bnskd->bkgnd", p, v)
    alpha = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = (o * alpha[..., None]).sum(dim=3)
    out = out / (l * alpha).sum(dim=-1).clamp_min(1e-20)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _check(q, k_cache, v_cache, cache_len, cache_start):
    if not q.is_cuda:
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention kernel takes q [B,1,H,dh], caches [B,Smax,Hkv,dh]")
    B, _, H, dh = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != dh or H % k_cache.shape[2] \
            or H // k_cache.shape[2] > 16 or dh > 128:
        raise ValueError(f"decode_attention: unsupported shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)}")
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bf16 q/caches, got {t.dtype}")
    for name, t in (("cache_len", cache_len), ("cache_start", cache_start)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"decode_attention: {name} must be int32 [{B}]")
    for t in (q, k_cache, v_cache, cache_len, cache_start):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention kernel takes contiguous tensors on one card")


def decode_attention_cuda(q, k_cache, v_cache, cache_len, cache_start) -> torch.Tensor:
    """The CUDA kernel on the same arguments as :func:`decode_attention_plain`
    (bf16 q/caches, int32 [B] window bounds, all contiguous on one card; q
    and the caches 16-byte aligned for the kernel's 16-byte copies, else it
    takes plain loads).  One launch; allocates only the output."""
    _check(q, k_cache, v_cache, cache_len, cache_start)
    B, _, H, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "decode_attention_fwd",
                         [_build.P] * 6 + [_build.I] * 6 + [_build.P])
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
             cache_start.data_ptr(), out.data_ptr(), B, Smax, H, Hkv, dh, SPLIT,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    launch_counts["decode_attention"] += 1
    return out
