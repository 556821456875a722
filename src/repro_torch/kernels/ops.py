"""Dispatch of the hot-path ops by the tensor's device (port of
``repro.kernels.ops``).

A tensor on the CPU goes to the op's plain PyTorch version, which autograd
differentiates.  A tensor on a CUDA device goes to the hand-written
kernels: through the op's ``torch.autograd.Function`` (forward kernel
saving what the backward kernels need) when a gradient is to be taken, to
the forward-only kernel otherwise.  A failed build or launch raises,
nothing falls back.  :func:`force_plain` runs the plain versions on the
card as well; it exists only for the comparison of each kernel with its
plain version, and nothing on the serving or training path uses it.

The signatures follow the JAX package's ops: ``grouped_lora`` takes
``x [B, S, d_in]`` with one task per batch row, ``packed_attention`` builds
the prefix key rows (``ops.py:181-214`` there, without the tile padding
that existed for the TPU) and takes the Pallas wrapper's ``block_q`` /
``block_k``, which set its tile-visibility rule, ``decode_attention`` takes
scalar or per-row window bounds, ``quant_matmul`` takes a BaseOp site's
einsum against an int8 weight, ``mamba_scan`` takes ``q/k/v``, the log
decay and input gates, ``chunk`` and optional ``h0`` / ``reset``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import grouped_lora as _gl
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import packed_attention as _pa
from repro_torch.kernels import quant_matmul as _qm

_KERNELS = (_gl, _pa, _da, _qm, _ms)
_force_plain = False


@contextlib.contextmanager
def force_plain():
    """Run the plain versions on CUDA tensors too (kernel comparisons only)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _use_kernel(t: torch.Tensor) -> bool:
    return t.is_cuda and not _force_plain


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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
    if _use_kernel(x):
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
    ``prefix_keep`` [B, P] gates them on (default: all on).  ``block_q`` /
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
        # prefix rows: position -1 (always causally visible), segment -1
        # where the row owns the prefix (wildcard) and -2 where it does not
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)
        k_positions = torch.cat(
            [torch.full((B, P), -1, dtype=torch.int32, device=dev), positions], dim=1)
        k_segment_ids = torch.cat(
            [torch.where(keep > 0, -1, -2).to(torch.int32), segment_ids], dim=1)
    bq, bk = _pa.tile_sizes(S, k.shape[1], block_q, block_k)
    if _use_kernel(q):
        args = (q.contiguous(), k.contiguous(), v.contiguous(), positions, segment_ids,
                k_positions.contiguous(), k_segment_ids.contiguous(), causal, bq, bk)
        if _needs_grad(q, k, v):
            return _pa.PackedAttentionFunction.apply(*args)
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
    if _use_kernel(q):
        return _da.decode_attention_cuda(q.contiguous(), k_cache, v_cache,
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
    if _use_kernel(x):
        args = (x2.contiguous(), q2.contiguous(), s2.contiguous())
        if _needs_grad(x):
            y = _qm.QuantMatmulFunction.apply(*args)
        else:
            y = _qm.quant_matmul_cuda(*args)
    else:
        y = _qm.quant_matmul_plain(x2, q2, s2)
    return y.reshape(*batch_shape, *out_shape)


# ---------------------------------------------------------------------------
# chunked SSD / GLA scan (the hybrid family's Mamba2 blocks)
# ---------------------------------------------------------------------------


def mamba_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
               log_input: torch.Tensor, *, chunk: int = 256, h0: Optional[torch.Tensor] = None,
               reset: Optional[torch.Tensor] = None):
    """Chunked scan over q, k [B, S, H, dk], v [B, S, H, dv], log_decay and
    log_input [B, S, H], from state ``h0`` [B, H, dk, dv] (zeros when None),
    cut at the rows where ``reset`` [B, S] > 0 -> (y [B, S, H, dv] in q's
    type, final state [B, H, dk, dv] f32).  The chunk is ``min(chunk, S)``.
    A reset position's own decay is zeroed here, outside the op, so its
    ``log_decay`` gradient is 0 (``mamba_scan.py:446-449`` of the JAX
    package)."""
    B, S, H, dk = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"mamba_scan: chunk {Q} does not divide S = {S}")
    if h0 is None:
        h0 = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float32, device=q.device)
    la = log_decay.float()
    r = None
    if reset is not None:
        la = torch.where(reset[:, :, None] > 0, torch.zeros_like(la), la)
        r = (reset > 0).to(torch.int32)
    li, h0 = log_input.float(), h0.float()
    if _use_kernel(q):
        args = (q.contiguous(), k.contiguous(), v.contiguous(), la.contiguous(),
                li.contiguous(), r.contiguous() if r is not None else None, h0.contiguous(), Q)
        if _needs_grad(q, k, v, la, li, h0):
            return _ms.MambaScanFunction.apply(*args)
        return _ms.mamba_scan_cuda(*args)
    return _ms.mamba_scan_plain(q, k, v, la, li, r, h0, Q)
