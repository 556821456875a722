"""Packed (segment-masked) flash attention: Hopper kernels + plain version.

Replaces the Pallas kernels of ``repro/kernels/packed_attention.py``: the
forward ``_fwd_kernel`` / ``_tile_mask`` / ``_fwd_call`` (with
``save_lse``), and the backward ``_dq_kernel`` and ``_dkv_kernel``
(``_bwd_call``).  A key ``kk`` is visible to a query ``s`` of the same
batch row when (:func:`visible_mask`)

* ``qseg[s] == kseg[kk]`` or ``kseg[kk] == -1``, and, when causal,
* ``qpos[s] >= kpos[kk]`` and
* ``(kk // bk) * bk <= (s // bq + 1) * bq - 1 + (Sk - S)``.

The last is the Pallas kernel's tile rule: it runs a key tile only when the
tile starts at or before the query tile's last index, with its tiles
``bq = gcd(S, min(block_q, S))`` and ``bk = gcd(Sk, min(block_k, Sk))``
(:func:`tile_sizes`).  Where positions rise with the index (serving) the
rule removes nothing; in a packed training batch a segment's padding sits at
position 0, and the rule decides which of those keys its real queries see.
``kseg == -1`` marks a wildcard row (a learned prefix) seen by every query,
and ``-2`` a row seen by none.  GQA reads kv head ``h // (H // Hkv)``.
``Sk >= S``: the ``Sk - S`` leading key rows are prefix rows.

A query that sees no key gives 0 here, in both versions, and its logsumexp
is the sentinel 1e30.  (The Pallas kernel gives the mean of v over the key
tiles it visited for such a row: its p is not masked again after exp.  No
row of the serving or training path is fully masked.)

The CUDA forward, dq and dk/dv kernels (``csrc/packed_attention.cu``) run
their products on the H100's tensor cores (``mma.sync`` on bf16 tiles that
``cp.async`` copies into shared memory, f32 accumulators).  See the
source's header.  The kernels take 16-byte aligned q, k, v, o and do;
``ops.packed_attention`` hands them aligned copies where a caller's are not.
:class:`PackedAttentionFunction` makes them one differentiable op.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernels (plain calls are not counted)
launch_counts = {"packed_attention": 0, "packed_attention_dq": 0, "packed_attention_dkv": 0}

NEG_INF = -1e30


def tile_sizes(S: int, Sk: int, block_q: int = 128, block_k: int = 128):
    """The tile rule's (bq, bk): the Pallas wrapper's block sizes."""
    return math.gcd(S, min(block_q, S)), math.gcd(Sk, min(block_k, Sk))


def visible_mask(positions, segment_ids, k_positions, k_segment_ids, causal: bool,
                 bq: int, bk: int) -> torch.Tensor:
    """[B, S, Sk] bool: which keys each query sees (the module's rule)."""
    S, Sk = positions.shape[1], k_positions.shape[1]
    mask = (segment_ids[:, :, None] == k_segment_ids[:, None, :]) | \
        (k_segment_ids[:, None, :] == -1)
    if causal:
        mask &= positions[:, :, None] >= k_positions[:, None, :]
        dev = positions.device
        key_tile = torch.arange(Sk, device=dev) // bk * bk
        frontier = (torch.arange(S, device=dev) // bq + 1) * bq - 1 + (Sk - S)
        mask &= (key_tile[None, :] <= frontier[:, None])[None]
    return mask


def packed_attention_plain(q, k, v, positions, segment_ids, k_positions,
                           k_segment_ids, causal: bool = True, bq: int = 128,
                           bk: int = 128) -> torch.Tensor:
    """q [B, S, H, dh], k/v [B, Sk, Hkv, dh], positions/segment_ids [B, S],
    k_positions/k_segment_ids [B, Sk] -> [B, S, H, dh] in q's type (f32 math;
    autograd differentiates it)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    q5 = q.float().reshape(B, S, Hkv, G, dh)
    s = torch.einsum("bqkgd,bpkd->bqkgp", q5, k.float()) * (1.0 / math.sqrt(dh))
    mask = visible_mask(positions, segment_ids, k_positions, k_segment_ids, causal,
                        bq, bk)[:, :, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    # the max only steadies exp; it carries no gradient
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    o = torch.einsum("bqkgp,bpkd->bqkgd", p, v.float())
    o = o / p.sum(dim=-1).clamp_min(1e-20)[..., None]
    return o.reshape(B, S, H, dh).to(q.dtype)


# the stored-o path's forward, bound here: a caller may put
# packed_attention_stored_o_plain in packed_attention_plain's place
_plain_forward = packed_attention_plain


class _StoredOPlainFunction(torch.autograd.Function):
    """The plain forward, and a plain backward that takes D = rowsum(do * o)
    from the forward's stored output ``o`` (in q's type), as the Pallas
    ``_dq_kernel`` / ``_dkv_kernel`` and the CUDA kernels do, where autograd
    of :func:`packed_attention_plain` differentiates its f32 o."""

    @staticmethod
    def forward(ctx, q, k, v, positions, segment_ids, k_positions, k_segment_ids, causal,
                bq, bk):
        ints = (positions, segment_ids, k_positions, k_segment_ids)
        o = _plain_forward(q, k, v, *ints, causal, bq, bk)
        ctx.save_for_backward(q, k, v, *ints, o)
        ctx.rule = (causal, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, positions, segment_ids, k_positions, k_segment_ids, o = ctx.saved_tensors
        B, S, H, dh = q.shape
        Hkv = k.shape[2]
        G = H // Hkv
        scale = 1.0 / math.sqrt(dh)
        q5 = q.float().reshape(B, S, Hkv, G, dh)
        kf, vf = k.float(), v.float()
        mask = visible_mask(positions, segment_ids, k_positions, k_segment_ids,
                            *ctx.rule)[:, :, None, None, :]
        s = torch.einsum("bqkgd,bpkd->bqkgp", q5, kf) * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        do5 = do.float().reshape(B, S, Hkv, G, dh)
        d = (do5 * o.float().reshape(B, S, Hkv, G, dh)).sum(dim=-1, keepdim=True)
        ds = p * (torch.einsum("bqkgd,bpkd->bqkgp", do5, vf) - d) * scale
        dq = torch.einsum("bqkgp,bpkd->bqkgd", ds, kf).reshape(B, S, H, dh)
        dk = torch.einsum("bqkgp,bqkgd->bpkd", ds, q5)
        dv = torch.einsum("bqkgp,bqkgd->bpkd", p, do5)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def packed_attention_stored_o_plain(q, k, v, positions, segment_ids, k_positions,
                                    k_segment_ids, causal: bool = True, bq: int = 128,
                                    bk: int = 128) -> torch.Tensor:
    """:func:`packed_attention_plain` whose backward reads D = rowsum(do * o)
    from the stored o in q's type (the Pallas backward's choice): a second
    plain path, with no kernel, for the noise floor of the training checks."""
    return _StoredOPlainFunction.apply(q, k, v, positions, segment_ids, k_positions,
                                       k_segment_ids, causal, bq, bk)


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
    if dh not in (64, 80, 128):
        raise ValueError(f"packed_attention kernel takes head_dim 64, 80 or 128, got {dh}")
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
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("packed_attention kernel takes 16-byte aligned q/k/v (cp.async)")


def _check_bwd(q, o, lse, do):
    B, S, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"packed_attention backward: {name} must be contiguous like q")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"packed_attention backward: lse must be contiguous f32 [{B}, {H}, {S}]")
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("packed_attention backward takes 16-byte aligned o and do (cp.async)")


def _dims(q, k, causal, bq, bk):
    B, S, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    # the current stream's handle, without building a Stream object
    return [B, S, Sk, H, Hkv, dh, int(causal), int(bq), int(bk),
            torch._C._cuda_getCurrentRawStream(q.device.index)]


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def packed_attention_cuda(q, k, v, positions, segment_ids, k_positions, k_segment_ids,
                          causal: bool = True, bq: int = 128, bk: int = 128,
                          save_lse: bool = False):
    """The CUDA forward on the same arguments as :func:`packed_attention_plain`
    (bf16 q/k/v, int32 row ids, all contiguous on one card).  ``save_lse``
    also returns the logsumexp [B, H, S] f32 (1e30 on rows that see no key)."""
    ints = (positions, segment_ids, k_positions, k_segment_ids)
    _check(q, k, v, ints)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if save_lse else None
    fn = _build.function("packed_attention", "packed_attention_fwd",
                         [_build.P] * 9 + [_build.I] * 9 + [_build.P])
    err = fn(*_ptrs(q, k, v, *ints, o), lse.data_ptr() if save_lse else None,
             *_dims(q, k, causal, bq, bk))
    _build.check("packed_attention", err)
    launch_counts["packed_attention"] += 1
    return (o, lse) if save_lse else o


def packed_attention_dq_cuda(q, k, v, positions, segment_ids, k_positions, k_segment_ids,
                             o, lse, do, causal: bool = True, bq: int = 128, bk: int = 128):
    """dq [B, S, H, dh] from the forward's inputs, its output ``o`` and
    ``lse``, and the output gradient ``do``."""
    ints = (positions, segment_ids, k_positions, k_segment_ids)
    _check(q, k, v, ints)
    _check_bwd(q, o, lse, do)
    dq = torch.empty_like(q)
    fn = _build.function("packed_attention", "packed_attention_dq",
                         [_build.P] * 11 + [_build.I] * 9 + [_build.P])
    err = fn(*_ptrs(q, k, v, *ints, o, lse, do, dq), *_dims(q, k, causal, bq, bk))
    _build.check("packed_attention", err)
    launch_counts["packed_attention_dq"] += 1
    return dq


def packed_attention_dkv_cuda(q, k, v, positions, segment_ids, k_positions, k_segment_ids,
                              o, lse, do, causal: bool = True, bq: int = 128, bk: int = 128):
    """(dk, dv) [B, Sk, Hkv, dh], each summed over the G query heads of its
    kv head, from the same arguments as :func:`packed_attention_dq_cuda`."""
    ints = (positions, segment_ids, k_positions, k_segment_ids)
    _check(q, k, v, ints)
    _check_bwd(q, o, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("packed_attention", "packed_attention_dkv",
                         [_build.P] * 12 + [_build.I] * 9 + [_build.P])
    err = fn(*_ptrs(q, k, v, *ints, o, lse, do, dk, dv), *_dims(q, k, causal, bq, bk))
    _build.check("packed_attention", err)
    launch_counts["packed_attention_dkv"] += 1
    return dk, dv


class PackedAttentionFunction(torch.autograd.Function):
    """The forward (saving lse) and the dq and dk/dv kernels as one
    differentiable op over (q, k, v); the row ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, positions, segment_ids, k_positions, k_segment_ids,
                causal, bq, bk):
        o, lse = packed_attention_cuda(q, k, v, positions, segment_ids, k_positions,
                                       k_segment_ids, causal, bq, bk, save_lse=True)
        ctx.save_for_backward(q, k, v, positions, segment_ids, k_positions, k_segment_ids,
                              o, lse)
        ctx.rule = (causal, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.ops import aligned

        saved = ctx.saved_tensors
        do = aligned(do)
        dq = packed_attention_dq_cuda(*saved, do, *ctx.rule)
        dk, dv = packed_attention_dkv_cuda(*saved, do, *ctx.rule)
        return dq, dk, dv, None, None, None, None, None, None, None
