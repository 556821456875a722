"""Chunked SSD / gated-linear-attention scan: Hopper kernels + plain version.

Replaces the Pallas kernels of ``repro/kernels/mamba_scan.py``: the forward
``_kernel`` / ``_fwd_call`` (with ``save_states``), the reverse adjoint-state
kernel ``_bwd_state_kernel`` and the transposed block-product kernel
``_bwd_chunk_kernel`` (``_bwd_call``).  Per head the recurrence

    H_t = exp(la_t) H_{t-1} + exp(li_t) k_t (x) v_t ;   y_t = q_t . H_t

runs chunk-parallel: within a chunk of Q positions through a decay-masked
block product, across chunks through a carried [dk, dv] f32 state.  Segment
``reset`` rows cut it with exact within-chunk reset-count gates (pair,
entry, exit, carry; never a -1e9 log-decay sentinel), and the reset
position's own decay is excluded: :func:`repro_torch.kernels.ops.mamba_scan`
zeroes ``la`` there before the op, so that its gradient is 0 by autograd.

``mamba_scan_plain`` is a straight PyTorch transcription of the JAX
package's ``chunked_gla`` (``repro/models/ssm.py``) on those inputs: the CPU
path, and the reference on the card; autograd differentiates it.

The CUDA kernels (``csrc/mamba_scan.cu``): the forward and the state
backward run one block per (batch row, head) with a loop over its chunks,
where the Pallas grid carried the state across sequential grid steps; the
chunk backward runs one block per (chunk, batch row, head).  All three run
their products on the tensor cores (``mma.sync`` on bf16 tiles, the f32
factors as three bf16 terms, f32 accumulators; see the source's header).
:class:`MambaScanFunction` makes them one differentiable op over (q, k, v,
la, li, h0); the ``dla`` of the telescoping identity (a segment-bounded
reverse cumsum of the kernel's per-position rows, plus the final-state term
``<dH_f, H_f>`` at the last position) is taken here in PyTorch, outside the
kernels, as the JAX package takes it outside its Pallas kernels.

The three kernels are built for (dk, dv) = (64, 64) (zamba2's heads).  A
larger state (xlstm's mLSTM: (1024, 1025), padded by ``ops.tile_padded``
to (1024, 1088)), which the Pallas kernels hold in a ``VMEM((dk, dv),
f32)`` scratch of any size, runs the tiled kernels, which keep the Pallas
bodies' order (each chunk's scores once, over the whole state width) and
cut the state and the outputs' columns into 64 x 64 tiles:
:func:`mamba_scan_tiled_cuda` (the chunks' decay-masked scores once, the
state tile by tile -- the update is an outer product, so each tile is
exact alone -- then y by 64-wide column tile),
:func:`mamba_scan_bwd_state_tiled_cuda` (the (64, 64) state backward on its
tile of G) and :func:`mamba_scan_bwd_chunk_tiled_cuda` (both chunks'
scores once, then dq, dk and dv by 64-wide column tile with their state
terms over the whole other dimension, and dcum and dli from the rows'
per-tile shares summed in order).  :class:`MambaScanFunction` takes either
set by the shape.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# calls of the CUDA kernels (plain calls are not counted); a
# ``mamba_scan_tiled`` call is three launches on its stream (scores, states,
# outputs), a ``mamba_scan_bwd_chunk_tiled`` call three (scores with the
# states' flags, outputs, rows)
launch_counts = {"mamba_scan": 0, "mamba_scan_bwd_state": 0, "mamba_scan_bwd_chunk": 0,
                 "mamba_scan_tiled": 0, "mamba_scan_bwd_state_tiled": 0,
                 "mamba_scan_bwd_chunk_tiled": 0}

_QMAX = 256          # largest chunk the kernels take
_DIMS = ((64, 64),)  # (dk, dv) of the three kernels; the tiled ones take multiples of
TILE = 64            # TILE x TILE tiles of the state
_MAX_TILES = 64      # dv / TILE of the tiled kernels (the width of their tile flags' masks)


def _gates(rc: torch.Tensor):
    """Within-chunk reset-count gates of chunk rows ``rc`` [B, Q] int:
    (pair [B, Q, Q], entry [B, Q], exit [B, Q], carry [B]) as f32."""
    seg = torch.cumsum(rc, dim=1)
    pair = (seg[:, :, None] == seg[:, None, :]).float()
    entry = (seg == 0).float()
    exit_ = (seg == seg[:, -1:]).float()
    carry = (seg[:, -1] == 0).float()
    return pair, entry, exit_, carry


def mamba_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, la: torch.Tensor,
                     li: torch.Tensor, r: Optional[torch.Tensor], h0: torch.Tensor,
                     chunk: int, save_states: bool = False):
    """q, k [B, S, H, dk], v [B, S, H, dv], la / li [B, S, H] (la already 0
    at reset positions), r [B, S] int reset rows or None (no gates),
    h0 [B, H, dk, dv] f32, chunk Q dividing S -> (y [B, S, H, dv] in q's type,
    final state [B, H, dk, dv] f32) and, with ``save_states``, each chunk's
    entry state [B * H, n, dk, dv] f32 (the forward kernel's ``hin``)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Q = chunk
    n = S // Q
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.float32, device=q.device))
    cmask = causal[None, :, :, None]
    h = h0.float()
    ys, states = [], []
    for c in range(n):
        sl = slice(c * Q, (c + 1) * Q)
        qi, ki, vi = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        cum = torch.cumsum(la[:, sl].float(), dim=1)  # [B, Q, H]
        gain = torch.exp(li[:, sl].float())
        dec = cum[:, :, None, :] - cum[:, None, :, :]
        dec = torch.exp(dec * cmask) * cmask * gain[:, None, :, :]
        qd = qi * torch.exp(cum)[..., None]
        total = cum[:, -1:, :]
        w = torch.exp(total - cum) * gain
        hscale = torch.exp(total[:, 0, :])  # [B, H]
        if r is not None:
            pair, entry, exit_, carry = _gates(r[:, sl])
            dec = dec * pair[..., None]
            qd = qd * entry[:, :, None, None]
            w = w * exit_[..., None]
            hscale = hscale * carry[:, None]
        if save_states:
            states.append(h)
        s = torch.einsum("bihd,bjhd->bijh", qi, ki)
        y_intra = torch.einsum("bijh,bjhv->bihv", s * dec, vi)
        y_inter = torch.einsum("bihd,bhdv->bihv", qd, h)
        kd = ki * w[..., None]
        h = hscale[:, :, None, None] * h + torch.einsum("bjhd,bjhv->bhdv", kd, vi)
        ys.append((y_intra + y_inter).to(q.dtype))
    y = torch.cat(ys, dim=1)
    if save_states:
        return y, h, torch.stack(states, dim=2).reshape(B * H, n, dk, dv)
    return y, h


def seg_rev_cumsum(dcum: torch.Tensor, r: Optional[torch.Tensor]) -> torch.Tensor:
    """dla_t = sum over i >= t of the same segment of dcum_i ([B, S, H]): the
    plain reverse cumsum minus its value at the next segment's start
    (``_seg_rev_cumsum`` of the JAX package; exactly bounded)."""
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])
    if r is None:
        return rev
    B, S, H = dcum.shape
    seg = torch.cumsum(r.long(), dim=1)  # [B, S] global segment index
    starts = torch.zeros((B, S + 2, H), dtype=dcum.dtype, device=dcum.device)
    idx = torch.where(r > 0, seg, torch.full_like(seg, S + 1))
    starts.scatter_add_(1, idx[..., None].expand(B, S, H), rev * (r > 0)[..., None].to(rev.dtype))
    nxt = torch.clamp(seg + 1, max=S + 1)
    return rev - torch.gather(starts, 1, nxt[..., None].expand(B, S, H))


def _chunk_terms(la, li, r, Q: int):
    """Per chunk of ``la`` / ``li`` [B, Q, H] (and reset rows [B, Q] or None):
    (dec [B, Q, Q, H], ec [B, Q, H], w [B, Q, H], cdec [B, H]) as the
    kernels form them: dec(i, j) = exp(cum_i - cum_j) gain_j on live pairs,
    ec = exp(cum) on rows the entry state reaches, w = exp(cum_last - cum)
    gain on rows that feed the exit state, cdec = exp(cum_last) where the
    entry state survives."""
    cum = torch.cumsum(la.float(), dim=1)
    gain = torch.exp(li.float()) if li is not None else None
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=la.device))
    live = causal[None, :, :, None]
    ec, cdec = torch.exp(cum), torch.exp(cum[:, -1])
    w = torch.exp(cum[:, -1:] - cum) * gain if gain is not None else None
    if r is not None:
        pair, entry, exit_, carry = _gates(r)
        live = live & (pair[..., None] > 0)
        ec = ec * entry[..., None]
        w = w * exit_[..., None] if w is not None else None
        cdec = cdec * carry[:, None]
    dec = None
    if gain is not None:
        diff = torch.where(live, cum[:, :, None, :] - cum[:, None, :, :], torch.zeros((), device=la.device))
        dec = torch.where(live, torch.exp(diff) * gain[:, None, :, :], torch.zeros((), device=la.device))
    return dec, ec, w, cdec


def mamba_scan_bwd_state_plain(q, la, r, dy, dhf, chunk: int, want_dh0: bool = True):
    """Plain version of the reverse adjoint-state kernel: per chunk, last to
    first, ``gexit[c] = G`` then ``G = cdec G + sum_i ec_i q_i (x) dy_i``
    from ``G = dhf``; ``dh0`` is the last G (f32 throughout), or None
    without ``want_dh0``, the first chunk's update then skipped."""
    B, S, H, dk = q.shape
    n = S // chunk
    g = dhf.float()
    gexit = []
    for c in reversed(range(n)):
        gexit.append(g)
        if c == 0 and not want_dh0:
            g = None
            break
        sl = slice(c * chunk, (c + 1) * chunk)
        _, ec, _, cdec = _chunk_terms(la[:, sl], None, None if r is None else r[:, sl], chunk)
        g = cdec[:, :, None, None] * g + torch.einsum(
            "bihd,bihv->bhdv", q[:, sl].float() * ec[..., None], dy[:, sl].float())
    gexit = torch.stack(gexit[::-1], dim=2).reshape(B * H, n, dk, dy.shape[-1])
    return gexit, g


def mamba_scan_bwd_chunk_plain(q, k, v, la, li, r, dy, hin, gexit, chunk: int):
    """Plain version of the transposed block-product kernel, chunk by chunk:
    ``(dq, dk, dv)`` in q's type and the rows ``dcum = q.dq - k.dk``,
    ``dli = k.dk`` [B, S, H] f32, from the entry states ``hin`` and the
    exit adjoints ``gexit`` ([B * H, n, dk, dv] f32)."""
    B, S, H, dk = q.shape
    dv_ = v.shape[-1]
    n = S // chunk
    hin = hin.reshape(B, H, n, dk, dv_)
    gexit = gexit.reshape(B, H, n, dk, dv_)
    outs = {name: [] for name in ("dq", "dk", "dv", "dcum", "dli")}
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        dec, ec, w, _ = _chunk_terms(la[:, sl], li[:, sl], None if r is None else r[:, sl],
                                     chunk)
        qc, kc, vc, gc = (t[:, sl].float() for t in (q, k, v, dy))
        p = torch.einsum("bihv,bjhv->bijh", gc, vc) * dec     # dec (dy_i . v_j)
        s = torch.einsum("bihd,bjhd->bijh", qc, kc) * dec     # dec (q_i . k_j)
        dq = torch.einsum("bijh,bjhd->bihd", p, kc) + ec[..., None] * torch.einsum(
            "bihv,bhdv->bihd", gc, hin[:, :, c])
        dkk = torch.einsum("bijh,bihd->bjhd", p, qc) + w[..., None] * torch.einsum(
            "bjhv,bhdv->bjhd", vc, gexit[:, :, c])
        dvv = torch.einsum("bijh,bihv->bjhv", s, gc) + w[..., None] * torch.einsum(
            "bjhd,bhdv->bjhv", kc, gexit[:, :, c])
        kdk = (kc * dkk).sum(-1)
        outs["dq"].append(dq)
        outs["dk"].append(dkk)
        outs["dv"].append(dvv)
        outs["dcum"].append((qc * dq).sum(-1) - kdk)
        outs["dli"].append(kdk)
    cat = {name: torch.cat(ts, dim=1) for name, ts in outs.items()}
    return (cat["dq"].to(q.dtype), cat["dk"].to(k.dtype), cat["dv"].to(v.dtype),
            cat["dcum"], cat["dli"])


def _backward(state_fn, chunk_fn, q, k, v, la, li, r, hin, hfin, dy, dhf, chunk: int,
              want_dh0: bool = True):
    """The op's backward (``_bwd_call``): the state pass, the chunk pass,
    then dla as the segment-bounded reverse cumsum of dcum with
    ``<dhf, hfin>`` added at the last position -> (dq, dk, dv, dla, dli, dh0),
    dh0 None without ``want_dh0``."""
    gexit, dh0 = state_fn(q, la, r, dy, dhf, chunk, want_dh0)
    dq, dkk, dvv, dcum, dli = chunk_fn(q, k, v, la, li, r, dy, hin, gexit, chunk)
    dcum[:, -1, :] += torch.einsum("bhkv,bhkv->bh", dhf, hfin)
    return dq, dkk, dvv, seg_rev_cumsum(dcum, r), dli, dh0


def mamba_scan_backward_plain(q, k, v, la, li, r, hin, hfin, dy, dhf, chunk: int,
                              want_dh0: bool = True):
    """The backward on the two kernels' plain versions."""
    return _backward(mamba_scan_bwd_state_plain, mamba_scan_bwd_chunk_plain, q, k, v, la, li,
                     r, hin, hfin, dy, dhf, chunk, want_dh0)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


# the C source's kernel kinds (``mamba_scan_occupancy``): the four (64, 64)
# bodies, then the tiled forward's and the tiled chunk backward's launches
_KINDS = {"mamba_scan_fwd": 0, "mamba_scan_bwd_state": 1, "mamba_scan_bwd_chunk": 2,
          "mamba_scan_scores": 3, "mamba_scan_bwd_state_tiled": 4, "mamba_scan_states": 5,
          "mamba_scan_outputs": 6, "mamba_scan_bwd_scores": 7, "mamba_scan_bwd_outputs": 8,
          "mamba_scan_bwd_rows": 9}


def smem_bytes(kernel: str, chunk: int) -> int:
    """Dynamic shared memory of one block of ``kernel`` (a key of
    ``_KINDS``) at chunk length ``chunk``, as the C source sizes it (fixed
    layouts, the same at any chunk).  The four (64, 64) bodies (the tiled
    state backward among them) share one: a ring of three stages of two
    64 x 72 bf16 tiles, the state's three bf16 terms (3 x 64 x 72; the state
    backward's f32 output stage, 4 x 16 x 72, in their room), a 16 x 72
    stage for each of 4 warps, six per-row vectors of 256 and 40 ints.  The
    tiled kernels keep the chunk's vectors (four of 256 floats, 256 + 40
    ints) after: the scores a ring of four 64 x 64 bf16 tiles in the
    128-byte swizzle and 1024 bytes to align them, the states the bodies'
    ring, the outputs five 64 x 72 bf16 tiles and the state's three terms
    (the warps' stage in their room); the rows kernel none."""
    if kernel not in _KINDS or not 1 <= chunk <= _QMAX:
        raise ValueError(f"smem_bytes: kernel in {sorted(_KINDS)} and chunk 1..{_QMAX}; got "
                         f"{kernel!r}, {chunk}")
    tile = 64 * 72 * 2
    vectors = 4 * _QMAX * 4 + _QMAX * 4 + 40 * 4
    if kernel in ("mamba_scan_scores", "mamba_scan_bwd_scores"):
        return 1024 + 4 * 64 * 64 * 2 + vectors
    if kernel == "mamba_scan_states":
        return 3 * 2 * tile + vectors
    if kernel in ("mamba_scan_outputs", "mamba_scan_bwd_outputs"):
        return (_QMAX // 64 + 1) * tile + 3 * tile + vectors
    if kernel == "mamba_scan_bwd_rows":
        return 0
    return 3 * 2 * tile + 3 * tile + 4 * 16 * 72 * 2 + 6 * _QMAX * 4 + 40 * 4


def occupancy(kernel: str, chunk: int) -> dict:
    """On the card: a block's dynamic shared memory and how many blocks of
    ``kernel`` an SM holds at chunk length ``chunk`` (the C entry
    ``mamba_scan_occupancy``: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with the launch's attributes set)."""
    smem_bytes(kernel, chunk)  # refuses what the kernels do not take
    out = ctypes.POINTER(ctypes.c_int)
    fn = _build.function("mamba_scan", "mamba_scan_occupancy", [_build.I, _build.I, out, out])
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    _build.check("mamba_scan", fn(_KINDS[kernel], chunk, ctypes.byref(smem), ctypes.byref(blocks)))
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def _check(q, k, v, la, li, r, chunk, state=None, tiled=False):
    """Raise on what the kernels do not take; ``state`` is an f32
    [B, H, dk, dv] operand (h0 or dhf) when the kernel reads one; ``tiled``:
    the tiled kernels' (dk, dv), multiples of ``TILE``."""
    if not q.is_cuda:
        raise ValueError("mamba_scan_cuda takes CUDA tensors")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mamba_scan kernel takes q/k [B,S,H,dk], v [B,S,H,dv]; got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if tiled and (dk % TILE or dv % TILE or dv > _MAX_TILES * TILE or B * H > 65535):
        raise ValueError(f"the tiled mamba_scan kernel takes dk, dv multiples of {TILE}, dv <= "
                         f"{_MAX_TILES * TILE} and B * H <= 65535; got (dk, dv) = {(dk, dv)}, "
                         f"B * H = {B * H}")
    if not tiled and (dk, dv) not in _DIMS:
        raise ValueError(f"mamba_scan kernel takes (dk, dv) in {_DIMS}, got {(dk, dv)}")
    if not (1 <= chunk <= _QMAX and S % chunk == 0):
        raise ValueError(f"mamba_scan kernel takes a chunk of 1..{_QMAX} dividing S; "
                         f"got chunk {chunk}, S {S}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mamba_scan kernel takes bf16 q/k/v ({name} is {t.dtype})")
    for name, t in (("la", la), ("li", li)):
        if t.dtype != torch.float32 or t.shape != (B, S, H):
            raise ValueError(f"mamba_scan: {name} must be f32 [{B}, {S}, {H}]")
    if r is not None and (r.dtype != torch.int32 or r.shape != (B, S)):
        raise ValueError(f"mamba_scan: reset rows must be int32 [{B}, {S}]")
    if state is not None and (state.dtype != torch.float32 or state.shape != (B, H, dk, dv)):
        raise ValueError(f"mamba_scan: h0 / dhf must be f32 [{B}, {H}, {dk}, {dv}]")
    for t in (q, k, v, la, li, r, state):
        if t is None:
            continue
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("mamba_scan kernel takes contiguous tensors on one card")
    for t in (q, k, v):  # the tiles load 16 bytes at a time
        if t.data_ptr() % 16:
            raise ValueError("mamba_scan kernel takes 16-byte aligned q/k/v")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rptr(r):
    return r.data_ptr() if r is not None else None


def mamba_scan_cuda(q, k, v, la, li, r, h0, chunk: int, save_states: bool = False):
    """The CUDA forward on the arguments of :func:`mamba_scan_plain` (bf16
    q/k/v, f32 la/li/h0, int32 r or None, all contiguous on one card; dk =
    dv = 64, chunk <= 256)."""
    _check(q, k, v, la, li, r, chunk, h0)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    n = S // chunk
    y = torch.empty_like(v)
    hout = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    hin = torch.empty((B * H, n, dk, dv), dtype=torch.float32, device=q.device) \
        if save_states else None
    fn = _build.function("mamba_scan", "mamba_scan_fwd",
                         [_build.P] * 10 + [_build.I] * 6 + [_build.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), li.data_ptr(),
             _rptr(r), h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
             hin.data_ptr() if save_states else None, B, S, H, dk, dv, chunk, _stream(q))
    _build.check("mamba_scan", err)
    launch_counts["mamba_scan"] += 1
    return (y, hout, hin) if save_states else (y, hout)


def _scores(planes: int, B: int, H: int, n: int, chunk: int, device) -> torch.Tensor:
    """The tiled kernels' scratch of chunk scores, [planes, B * H, n, Qp, Qp]
    f32 (Qp: the chunk rounded up to ``TILE``)."""
    qp = -(-chunk // TILE) * TILE
    return torch.empty((planes, B * H, n, qp, qp), dtype=torch.float32, device=device)


def _flags(planes: int, B: int, H: int, n: int, dk: int, dv: int, device) -> torch.Tensor:
    """Whether each ``TILE`` x ``TILE`` tile of a chunk's state is not 0:
    [planes, B * H, n, dk / TILE, dv / TILE] int32."""
    return torch.empty((planes, B * H, n, dk // TILE, dv // TILE), dtype=torch.int32,
                       device=device)


def mamba_scan_tiled_cuda(q, k, v, la, li, r, h0, chunk: int, save_states: bool = False):
    """The forward at a large state, on the arguments of
    :func:`mamba_scan_plain` with dk and dv multiples of ``TILE``
    (``ops.mamba_scan`` pads xlstm's dv = 1025 to 1088).  Three launches:
    each chunk's decay-masked scores q k^T once over the whole dk, into a
    [B * H, n, Qp, Qp] f32 scratch (a block per 64 x 64 tile of them); the
    state, a block per (``TILE`` x ``TILE`` tile, batch row, head) carrying
    that tile over the chunks, writing the entry states (``hin``; a scratch
    of them when more than one chunk and not ``save_states``), a flag per
    tile that is not 0 and the final state; y by 64-wide column tile and
    64-row tile, its state term over the whole dk, rounded once to bf16."""
    _check(q, k, v, la, li, r, chunk, h0, tiled=True)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    n = S // chunk
    y = torch.empty_like(v)
    hout = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    hin = torch.empty((B * H, n, dk, dv), dtype=torch.float32, device=q.device) \
        if save_states or n > 1 else None
    scores = _scores(1, B, H, n, chunk, q.device)
    flags = _flags(1, B, H, n, dk, dv, q.device)
    fn = _build.function("mamba_scan", "mamba_scan_fwd_tiled",
                         [_build.P] * 12 + [_build.I] * 6 + [_build.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), li.data_ptr(),
             _rptr(r), h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
             hin.data_ptr() if hin is not None else None, scores.data_ptr(), flags.data_ptr(),
             B, S, H, dk, dv, chunk, _stream(q))
    _build.check("mamba_scan", err)
    launch_counts["mamba_scan_tiled"] += 1
    return (y, hout, hin) if save_states else (y, hout)


def _state_args(q, la, r, dy, dhf, chunk, want_dh0, tiled):
    """The state backward's checks and outputs, and its C arguments."""
    B, S, H, dk = q.shape
    dv = dy.shape[-1]
    _check(q, q, dy, la, la, r, chunk, dhf, tiled=tiled)
    n = S // chunk
    gexit = torch.empty((B * H, n, dk, dv), dtype=torch.float32, device=q.device)
    dh0 = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device) \
        if want_dh0 else None
    args = (q.data_ptr(), la.data_ptr(), _rptr(r), dy.data_ptr(), dhf.data_ptr(),
            gexit.data_ptr(), dh0.data_ptr() if want_dh0 else None, B, S, H, dk, dv, chunk,
            int(want_dh0), _stream(q))
    return gexit, dh0, args


def mamba_scan_bwd_state_cuda(q, la, r, dy, dhf, chunk: int, want_dh0: bool = True):
    """The reverse adjoint-state kernel: ``(gexit [B*H, n, dk, dv], dh0
    [B, H, dk, dv])``, both f32, from q, la, r, the output gradient dy (q's
    type) and the final-state gradient dhf (f32).  Without ``want_dh0``
    dh0 is None and the first chunk's products, which feed only it, are
    skipped."""
    gexit, dh0, args = _state_args(q, la, r, dy, dhf, chunk, want_dh0, False)
    fn = _build.function("mamba_scan", "mamba_scan_bwd_state",
                         [_build.P] * 7 + [_build.I] * 7 + [_build.P])
    _build.check("mamba_scan", fn(*args))
    launch_counts["mamba_scan_bwd_state"] += 1
    return gexit, dh0


def mamba_scan_bwd_state_tiled_cuda(q, la, r, dy, dhf, chunk: int, want_dh0: bool = True):
    """:func:`mamba_scan_bwd_state_cuda` at a large state, dk and dv
    multiples of ``TILE`` (dy padded like v): one launch, a block per
    (``TILE`` x ``TILE`` tile of G, batch row, head) running the (64, 64)
    kernel's chunk loop on its dk columns of q and dv columns of dy from its
    tile of dhf; each tile of gexit and dh0 is written by its own block."""
    gexit, dh0, args = _state_args(q, la, r, dy, dhf, chunk, want_dh0, True)
    fn = _build.function("mamba_scan", "mamba_scan_bwd_state_tiled",
                         [_build.P] * 7 + [_build.I] * 7 + [_build.P])
    _build.check("mamba_scan", fn(*args))
    launch_counts["mamba_scan_bwd_state_tiled"] += 1
    return gexit, dh0


def _chunk_outputs(q, k, v, la, li, r, dy, hin, gexit, chunk, tiled):
    """The chunk backward's checks and outputs (dq, dk, dv, dcum, dli)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    _check(q, k, v, la, li, r, chunk, tiled=tiled)
    n = S // chunk
    for name, t in (("hin", hin), ("gexit", gexit)):
        if t.dtype != torch.float32 or t.shape != (B * H, n, dk, dv) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"mamba_scan backward: {name} must be contiguous f32 "
                             f"[{B * H}, {n}, {dk}, {dv}]")
    if dy.shape != v.shape or dy.dtype != q.dtype or not dy.is_contiguous() \
            or dy.data_ptr() % 16:
        raise ValueError("mamba_scan backward: dy must be contiguous and 16-byte aligned like v "
                         "in q's type")
    dcum = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), dcum, \
        torch.empty_like(dcum)


def mamba_scan_bwd_chunk_cuda(q, k, v, la, li, r, dy, hin, gexit, chunk: int):
    """The transposed block-product kernel: ``(dq, dk, dv, dcum, dli)`` with
    dq/dk/dv in q's type and the per-position rows dcum = q.dq - k.dk and
    dli = k.dk [B, S, H] f32, from the forward's inputs, dy, the saved entry
    states ``hin`` and the chunk-exit adjoints ``gexit``."""
    outs = _chunk_outputs(q, k, v, la, li, r, dy, hin, gexit, chunk, False)
    B, S, H, dk = q.shape
    fn = _build.function("mamba_scan", "mamba_scan_bwd_chunk",
                         [_build.P] * 14 + [_build.I] * 6 + [_build.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), li.data_ptr(),
             _rptr(r), dy.data_ptr(), hin.data_ptr(), gexit.data_ptr(),
             *(t.data_ptr() for t in outs), B, S, H, dk, v.shape[-1], chunk, _stream(q))
    _build.check("mamba_scan", err)
    launch_counts["mamba_scan_bwd_chunk"] += 1
    return outs


def mamba_scan_bwd_chunk_tiled_cuda(q, k, v, la, li, r, dy, hin, gexit, chunk: int):
    """:func:`mamba_scan_bwd_chunk_cuda` at a large state, dk and dv
    multiples of ``TILE`` (v and dy padded to dv).  Three launches: both
    chunk scores, dec (x) q k^T and dec (x) dy v^T, once over the whole dk
    and dv into a [2, B * H, n, Qp, Qp] f32 scratch, with a flag per
    ``TILE`` x ``TILE`` tile of H_in and G_exit that is not 0; dq, dk and dv
    by 64-wide column tile and 64-row tile (each rounded once to q's type;
    the state terms over the whole other dimension, skipping tiles flagged
    0), with the rows' q . dq and k . dk over each dk tile's columns into a
    [2, dk / TILE, B, S, H] f32 scratch; then dcum and dli from those shares
    summed over the tiles in order."""
    outs = _chunk_outputs(q, k, v, la, li, r, dy, hin, gexit, chunk, True)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    n = S // chunk
    scores = _scores(2, B, H, n, chunk, q.device)
    flags = _flags(2, B, H, n, dk, dv, q.device)
    rowpart = torch.empty((2, dk // TILE, B, S, H), dtype=torch.float32, device=q.device)
    fn = _build.function("mamba_scan", "mamba_scan_bwd_chunk_tiled",
                         [_build.P] * 17 + [_build.I] * 6 + [_build.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), li.data_ptr(),
             _rptr(r), dy.data_ptr(), hin.data_ptr(), gexit.data_ptr(),
             *(t.data_ptr() for t in outs), scores.data_ptr(), flags.data_ptr(),
             rowpart.data_ptr(), B, S, H, dk, dv, chunk, _stream(q))
    _build.check("mamba_scan", err)
    launch_counts["mamba_scan_bwd_chunk_tiled"] += 1
    return outs


def _tiled(q, v) -> bool:
    return (q.shape[-1], v.shape[-1]) not in _DIMS


def mamba_scan_backward_cuda(q, k, v, la, li, r, hin, hfin, dy, dhf, chunk: int,
                             want_dh0: bool = True):
    """The backward on the two kernels (``dla`` in PyTorch): the (64, 64)
    ones, or their tiled versions at any other (dk, dv).  The kernels are
    looked up here, at each call."""
    fns = (mamba_scan_bwd_state_tiled_cuda, mamba_scan_bwd_chunk_tiled_cuda) if _tiled(q, v) \
        else (mamba_scan_bwd_state_cuda, mamba_scan_bwd_chunk_cuda)
    return _backward(*fns, q, k, v, la, li, r, hin, hfin, dy, dhf, chunk, want_dh0)


class MambaScanFunction(torch.autograd.Function):
    """The forward (saving the chunk entry states) and the two backward
    kernels as one differentiable op over (q, k, v, la, li, h0); the reset
    rows get no gradient.  At (dk, dv) = (64, 64) the three kernels, at any
    other multiples of ``TILE`` their tiled versions (``ops.tile_padded``
    pads xlstm's dv = 1025 to 1088 around this op, and autograd's pad and
    slice carry the gradients across).  ``dy`` is cast to q's type and ``dh``
    to f32 before the kernels, as the Pallas vjp does.  Where h0 takes no
    gradient (training's zero state) the state kernel skips dh0."""

    @staticmethod
    def forward(ctx, q, k, v, la, li, r, h0, chunk):
        fwd = mamba_scan_tiled_cuda if _tiled(q, v) else mamba_scan_cuda
        y, h, hin = fwd(q, k, v, la, li, r, h0, chunk, save_states=True)
        ctx.save_for_backward(q, k, v, la, li, r, hin, h)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.kernels.ops import aligned

        q, k, v, la, li, r, hin, hfin = ctx.saved_tensors
        dq, dkk, dvv, dla, dli, dh0 = mamba_scan_backward_cuda(
            q, k, v, la, li, r, hin, hfin, aligned(dy.to(q.dtype)),
            dh.float().contiguous(), ctx.chunk, ctx.needs_input_grad[6])
        return dq, dkk, dvv, dla, dli, None, dh0, None
