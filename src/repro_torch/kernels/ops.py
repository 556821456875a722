"""Dispatch of the hot-path ops by the tensor's device (port of
``repro.kernels.ops``).

A tensor on the CPU goes to the op's plain PyTorch version, which autograd
differentiates.  A tensor on a CUDA device goes to the hand-written
kernels: through the op's ``torch.autograd.Function`` (forward kernel
saving what the backward kernels need) when a gradient is to be taken, to
the forward-only kernel otherwise.  A failed build or launch raises,
nothing falls back.  :func:`force_plain` runs the plain versions on the
card as well, for every kernel family or for the families it is given; it
exists only for the comparison of each kernel with its plain version, and
nothing on the serving or training path uses it.

The signatures follow the JAX package's ops: ``grouped_lora`` takes
``x [B, S, d_in]`` with one task per batch row, ``packed_attention`` builds
the prefix key rows with the Pallas tier's padding (``ops.py:181-214``
there) and takes the Pallas wrapper's ``block_q`` / ``block_k``, which set
its tile-visibility rule, ``decode_attention`` takes
scalar or per-row window bounds, ``quant_matmul`` takes a BaseOp site's
einsum against an int8 weight, ``mamba_scan`` takes ``q/k/v``, the log
decay and input gates, ``chunk`` and optional ``h0`` / ``reset``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import grouped_lora as _gl
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import packed_attention as _pa
from repro_torch.kernels import quant_matmul as _qm

_KERNELS = (_gl, _pa, _da, _qm, _ms)
# the kernel families force_plain takes, each as the parts it runs plain
FAMILIES = {"grouped_lora": ("grouped_lora",),
            "packed_attention": ("packed_attention_fwd", "packed_attention_bwd"),
            "packed_attention_fwd": ("packed_attention_fwd",),
            "packed_attention_bwd": ("packed_attention_bwd",),
            "decode_attention": ("decode_attention",),
            "quant_matmul": ("quant_matmul",),
            "mamba_scan": ("mamba_scan",)}
_plain: frozenset = frozenset()


@contextlib.contextmanager
def force_plain(families=None):
    """Run the plain versions on CUDA tensors too (kernel comparisons only):
    of every family, or of those named in ``families`` (keys of
    ``FAMILIES``), the others staying on their kernels.
    ``packed_attention_fwd`` runs packed attention's forward plain and its
    backward on the kernels, ``packed_attention_bwd`` the reverse.  An
    unknown name raises; a kernel that runs still raises on a failed build
    or launch."""
    global _plain
    names = FAMILIES if families is None else families
    if isinstance(names, str):
        raise TypeError("force_plain takes a collection of family names")
    unknown = sorted(set(names) - set(FAMILIES))
    if unknown:
        raise ValueError(f"force_plain: unknown kernel families {unknown}; "
                         f"known: {sorted(FAMILIES)}")
    prev = _plain
    _plain = prev.union(*(FAMILIES[n] for n in names))
    try:
        yield
    finally:
        _plain = prev


def _use_kernel(t: torch.Tensor, part: str) -> bool:
    return t.is_cuda and part not in _plain


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous and 16-byte aligned, else a
    contiguous copy in a fresh allocation (which the allocator aligns).
    The kernels' ``cp.async`` and vector loads read 16 bytes at a time; a
    contiguous view at an odd storage offset passes ``.contiguous()``
    unchanged and would be refused by the wrappers' alignment checks."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel wrapper since the last reset."""
    return {name: n for mod in _KERNELS for name, n in mod.launch_counts.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS:
        for name in mod.launch_counts:
            mod.launch_counts[name] = 0


# ---------------------------------------------------------------------------
# grouped LoRA
# ---------------------------------------------------------------------------


def grouped_lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 row_task: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, S, d_in], a [T, d_in, r], b [T, r, d_out], row_task [B] (-1 = no
    adapter), scale [T] -> [B, S, d_out] in x's type."""
    B, S, d_in = x.shape
    x2 = x.reshape(B * S, d_in)
    rows = row_task.to(torch.int32).repeat_interleave(S)
    if _use_kernel(x, "grouped_lora"):
        args = (x2.contiguous(), a.contiguous(), b.contiguous(), rows, scale.float())
        if _needs_grad(x, a, b):
            y = _gl.GroupedLoRAFunction.apply(*args)
        else:
            y = _gl.grouped_lora_cuda(*args)
    else:
        y = _gl.grouped_lora_plain(x2, a, b, rows, scale)
    return y.reshape(B, S, -1)


# ---------------------------------------------------------------------------
# packed (segment-masked) flash attention
# ---------------------------------------------------------------------------


def padded_prefix_rows(S: int, P: int, block_k: int = 128) -> int:
    """The prefix row count packed attention runs for ``P`` learned rows
    before ``S`` keys: the Pallas tier pads P up to a multiple of
    ``unit = gcd(gcd(S, block_k), 64)`` where S + P would cut the key tile
    (gcd(S + P, block_k)) below min(unit, 32).  The padding moves the tile
    rule's key tiles, so the port pads as it does (S = 256, P = 16 -> 64)."""
    unit = math.gcd(math.gcd(S, block_k), 64)
    if math.gcd(S + P, block_k) < min(unit, 32):
        return P + (-P) % unit
    return P


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     segment_ids: Optional[torch.Tensor] = None,
                     positions: Optional[torch.Tensor] = None,
                     causal: bool = True, *,
                     prefix_kv: Optional[tuple] = None,
                     prefix_keep: Optional[torch.Tensor] = None,
                     block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Segment-masked attention over q [B, S, H, dh] and k/v [B, S, Hkv, dh];
    optionally with learned prefix k/v rows ``prefix_kv = (pk, pv)``
    [B, P, Hkv, dh] that every query of a batch row sees when
    ``prefix_keep`` [B, P] gates them on (default: all on), padded with
    gated-off rows to :func:`padded_prefix_rows`.  ``block_q`` /
    ``block_k`` give the tile rule's tiles (``packed_attention.tile_sizes``)."""
    B, S = q.shape[0], q.shape[1]
    dev = q.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if segment_ids is None:
        segment_ids = torch.zeros((B, S), dtype=torch.int32, device=dev)
    positions = positions.to(torch.int32).contiguous()
    segment_ids = segment_ids.to(torch.int32).contiguous()
    k_positions, k_segment_ids = positions, segment_ids
    if prefix_kv is not None:
        pk, pv = prefix_kv
        P = pk.shape[1]
        keep = prefix_keep if prefix_keep is not None else torch.ones((B, P), device=dev)
        pad = padded_prefix_rows(S, P, block_k) - P
        if pad:  # gated-off rows
            pk = F.pad(pk, (0, 0, 0, 0, 0, pad))
            pv = F.pad(pv, (0, 0, 0, 0, 0, pad))
            keep = F.pad(keep, (0, pad))
            P += pad
        # prefix rows: position -1 (always causally visible), segment -1
        # where the row owns the prefix (wildcard) and -2 where it does not
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)
        k_positions = torch.cat(
            [torch.full((B, P), -1, dtype=torch.int32, device=dev), positions], dim=1)
        k_segment_ids = torch.cat(
            [torch.where(keep > 0, -1, -2).to(torch.int32), segment_ids], dim=1)
    bq, bk = _pa.tile_sizes(S, k.shape[1], block_q, block_k)
    return _packed(q, k, v, positions, segment_ids, k_positions.contiguous(),
                   k_segment_ids.contiguous(), causal, bq, bk)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of q [B, S, H, dh] over every row of k/v
    [B, Sk, Hkv, dh] (whisper's cross-attention; the JAX package's
    ``flash_attention_kvscan(causal=False)``): packed attention with one
    segment a row and no position rule.  The kernels take ``Sk >= S``
    (whisper: at most 448 decoder tokens over 1500 frames)."""
    B, S, Sk = q.shape[0], q.shape[1], k.shape[1]
    zq = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    zk = torch.zeros((B, Sk), dtype=torch.int32, device=q.device)
    bq, bk = _pa.tile_sizes(S, Sk)
    return _packed(q, k, v, zq, zq, zk, zk, False, bq, bk)


def _packed(q, k, v, positions, segment_ids, k_positions, k_segment_ids, causal, bq, bk):
    """Packed attention's dispatch: the kernels on a CUDA tensor (the
    autograd Function when a gradient is to be taken), else the plain
    version."""
    fwd, bwd = _use_kernel(q, "packed_attention_fwd"), _use_kernel(q, "packed_attention_bwd")
    if fwd or bwd:
        args = (aligned(q), aligned(k), aligned(v), positions, segment_ids,
                k_positions, k_segment_ids, causal, bq, bk)
        if _needs_grad(q, k, v):
            if fwd and bwd:
                return _pa.PackedAttentionFunction.apply(*args)
            return _pa.HalfPlainFunction.apply(*args, not fwd)
        if fwd:
            return _pa.packed_attention_cuda(*args)
    return _pa.packed_attention_plain(q, k, v, positions, segment_ids, k_positions,
                                      k_segment_ids, causal, bq, bk)


# ---------------------------------------------------------------------------
# split-KV decode attention
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor,
                     cache_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention of q [B, 1, H, dh] over each row's cache window
    ``[cache_start, cache_len)`` ([] or [B] int each; start defaults to 0).
    Empty windows give zeros."""
    B = q.shape[0]
    dev = q.device
    cache_len = torch.as_tensor(cache_len, device=dev).to(torch.int32).reshape(-1).expand(B)
    if cache_start is None:
        cache_start = torch.zeros((B,), dtype=torch.int32, device=dev)
    cache_start = torch.as_tensor(cache_start, device=dev).to(torch.int32).reshape(-1).expand(B)
    if _use_kernel(q, "decode_attention"):
        return _da.decode_attention_cuda(aligned(q), aligned(k_cache), aligned(v_cache),
                                         cache_len.contiguous(), cache_start.contiguous())
    return _da.decode_attention_plain(q, k_cache, v_cache, cache_len, cache_start)


# ---------------------------------------------------------------------------
# int8 backbone matmul (the int8 tier)
# ---------------------------------------------------------------------------


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 einsum_str: str) -> torch.Tensor:
    """The BaseOp einsum ``einsum_str`` (e.g. ``"bsd,dhk->bshk"``) against an
    int8 weight: x [*batch, *contract], q [*contract, *out] int8, scale the
    per-output-channel f32 scale, keepdims over the contracted axes.  Every
    BaseOp site contracts x's trailing axes against q's leading axes, so the
    op is one [M, K] @ [K, N] problem.  Output in x's type; gradients flow
    to x only."""
    lhs, out_sub = einsum_str.split("->")
    xs, ws = lhs.split(",")
    contract = [c for c in xs if c in ws]
    batch = [c for c in xs if c not in ws]
    wout = [c for c in ws if c not in xs]
    assert xs == "".join(batch + contract), einsum_str
    assert ws == "".join(contract + wout), einsum_str
    assert out_sub == "".join(batch + wout), einsum_str
    nb, nc = len(batch), len(contract)
    batch_shape, out_shape = x.shape[:nb], q.shape[nc:]
    M, K, N = math.prod(batch_shape), math.prod(x.shape[nb:]), math.prod(out_shape)
    x2, q2, s2 = x.reshape(M, K), q.reshape(K, N), scale.reshape(N)
    if _use_kernel(x, "quant_matmul"):
        # (TMA, which feeds the kernel above 64 rows, reads aligned operands)
        args = (aligned(x2), aligned(q2), aligned(s2))
        if _needs_grad(x):
            y = _qm.QuantMatmulFunction.apply(*args)
        else:
            y = _qm.quant_matmul_cuda(*args)
    else:
        y = _qm.quant_matmul_plain(x2, q2, s2)
    return y.reshape(*batch_shape, *out_shape)


# ---------------------------------------------------------------------------
# chunked SSD / GLA scan (the hybrid family's Mamba2 blocks, xlstm's mLSTM)
# ---------------------------------------------------------------------------


def tile_padded(scan, q, k, v, la, li, r, h0, chunk: int):
    """``scan`` (the tiled kernel, the autograd Function over the tiled
    kernels, or a plain version) over q / k and v padded with zero columns
    to multiples of ``mamba_scan.TILE`` (xlstm's dv = 1025 to 1088) and h0
    with zero rows and columns, then y and the final state sliced back to
    (dk, dv).  Exact: a zero column of v gives zero columns of y and of the
    state, and a zero column of q / k adds nothing to a score and keeps its
    state row at zero.  Under autograd the slice's backward pads dy and the
    final state's gradient with zero columns, and the pad's backward slices
    the padded operands' gradients back."""
    dk, dv = q.shape[-1], v.shape[-1]
    pk, pv = -dk % _ms.TILE, -dv % _ms.TILE
    if pk:
        q, k = F.pad(q, (0, pk)), F.pad(k, (0, pk))
    if pv:
        v = F.pad(v, (0, pv))
    if pk or pv:
        h0 = F.pad(h0, (0, pv, 0, pk))
    y, h = scan(aligned(q), aligned(k), aligned(v), la, li, r, h0.contiguous(), chunk)
    return y[..., :dv], h[:, :, :dk, :dv]


def mamba_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
               log_input: torch.Tensor, *, chunk: int = 256, h0: Optional[torch.Tensor] = None,
               reset: Optional[torch.Tensor] = None):
    """Chunked scan over q, k [B, S, H, dk], v [B, S, H, dv], log_decay and
    log_input [B, S, H], from state ``h0`` [B, H, dk, dv] (zeros when None),
    cut at the rows where ``reset`` [B, S] > 0 -> (y [B, S, H, dv] in q's
    type, final state [B, H, dk, dv] f32).  The chunk is ``min(chunk, S)``.
    A reset position's own decay is zeroed here, outside the op, so its
    ``log_decay`` gradient is 0 (``mamba_scan.py:446-449`` of the JAX
    package).  On the card (dk, dv) = (64, 64) runs the three kernels (the
    forward, or with a gradient to take the autograd Function); any other
    (dk, dv) runs their tiled versions through :func:`tile_padded` (the
    tiled forward, or with a gradient the autograd Function, whose pad and
    slice autograd carries across).  The plain version takes q / k / v in
    any types (mLSTM hands it an f32 k, as the JAX package does)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"mamba_scan: chunk {Q} does not divide S = {S}")
    if h0 is None:
        h0 = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    la = log_decay.float()
    r = None
    if reset is not None:
        la = torch.where(reset[:, :, None] > 0, torch.zeros_like(la), la)
        r = (reset > 0).to(torch.int32)
    li, h0 = log_input.float(), h0.float()
    if _use_kernel(q, "mamba_scan"):
        # the kernels take q / k / v in one type: mLSTM's k / sqrt(hd) is f32
        # (exact in bf16 when hd is a power of 4, as xlstm-1.3b's 1024)
        k = k.to(q.dtype)
        r = r.contiguous() if r is not None else None
        grad = _needs_grad(q, k, v, la, li, h0)
        if (dk, dv) not in _ms._DIMS:
            scan = _ms.MambaScanFunction.apply if grad else _ms.mamba_scan_tiled_cuda
            return tile_padded(scan, q, k, v, la.contiguous(), li.contiguous(), r, h0, Q)
        args = (aligned(q), aligned(k), aligned(v), la.contiguous(), li.contiguous(), r,
                h0.contiguous(), Q)
        if grad:
            return _ms.MambaScanFunction.apply(*args)
        return _ms.mamba_scan_cuda(*args)
    return _ms.mamba_scan_plain(q, k, v, la, li, r, h0, Q)
