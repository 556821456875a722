"""Striped context-parallel attention (port of ``repro.models.cp_attention``).

The sequence is laid out in *stripes*: global block ``g`` (of ``block``
tokens) lives on rank ``g % P`` of the CP axis, so every rank's causal work
is the same, and positions and segment ids travel with the data (RoPE, the
causal mask and packing do not see the layout).  Each rank all-gathers k,
v, positions and segments over the axis (small under GQA), re-chunks them
by global block (chunks of ``P`` blocks), and runs a static lower-triangular
(q-block, kv-chunk) pair list with an f32 online softmax: only the masked
tail of each diagonal chunk is computed past the causal triangle.

The JAX version is an XLA function, not a Pallas kernel, and so is this one:
plain PyTorch.  The gradient comes from autograd; the gathered k / v take a
reduce-scatter backward (``collectives.all_gather``), the prefix rows, the
same on every rank of the axis, a psum (``collectives.fan_out``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import collectives

NEG_INF = -1e30


def stripe_permutation(S: int, block: int, P_sz: int) -> np.ndarray:
    """Indices taking contiguous token order to the striped layout
    (``x_striped = x[..., perm, ...]``): block ``g`` of ``S / block`` goes to
    rank ``g % P`` at local slot ``g // P``, the ranks' slices concatenated."""
    n = S // block
    assert n % P_sz == 0, (n, P_sz)
    order = []
    for r in range(P_sz):
        for j in range(n // P_sz):
            g = j * P_sz + r
            order.extend(range(g * block, (g + 1) * block))
    return np.asarray(order, np.int64)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def prefix_carry(q5: torch.Tensor, kv_prefix, scale: float):
    """The online-softmax carry (o, m, l) after the learned prefix k / v
    rows (JAX ``attention._prefix_carry``): every query sees the rows its
    batch row keeps, whatever its position or segment.  q5 [B, S, Hkv, G, dh];
    ``kv_prefix = (pk, pv, keep)``, pk / pv [B, P, Hkv, dh], keep [B, P]."""
    pk, pv, keep = kv_prefix
    s = torch.einsum("bskgd,bpkd->bskgp", q5.float(), pk.float()) * scale
    live = (keep > 0)[:, None, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m0 = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m0[..., None]), torch.zeros_like(s))
    l0 = p.sum(dim=-1)
    o0 = torch.einsum("bskgp,bpkd->bskgd", p, pv.float())
    return o0, m0, l0


def _flash_ragged_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor,
                        qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
                        kv_prefix=None) -> torch.Tensor:
    """q [B, nq, blk, Hkv, G, dh] (local striped q blocks), k / v
    [B, nc, cblk, Hkv, dh] (gathered kv chunks), positions / segments
    [B, nq, blk] and [B, nc, cblk]: the pairs (i, t) for t <= i, in the JAX
    scan's order (i major), with an f32 online softmax; returns
    [B, nq, blk, Hkv, G, dh] f32.  Each q block's carry is kept apart (the
    JAX scan's dynamic updates of one block at a time)."""
    B, nq, blk, Hkv, G, dh = q.shape
    scale = 1.0 / float(np.sqrt(dh))
    if kv_prefix is not None:
        o0, m0, l0 = prefix_carry(q.reshape(B, nq * blk, Hkv, G, dh), kv_prefix, scale)
        o0 = o0.reshape(B, nq, blk, Hkv, G, dh)
        m0 = m0.reshape(B, nq, blk, Hkv, G)
        l0 = l0.reshape(B, nq, blk, Hkv, G)
    outs = []
    for i in range(nq):
        if kv_prefix is not None:
            o, m, l = o0[:, i], m0[:, i], l0[:, i]
        else:
            o = q.new_zeros((B, blk, Hkv, G, dh), dtype=torch.float32)
            m = q.new_full((B, blk, Hkv, G), NEG_INF, dtype=torch.float32)
            l = q.new_zeros((B, blk, Hkv, G), dtype=torch.float32)
        qi = q[:, i]
        for t in range(i + 1):
            s = torch.einsum("bqkgd,bpkd->bqkgp", qi.float(), k[:, t].float()) * scale
            mask = qpos[:, i][:, :, None] >= kpos[:, t][:, None, :]
            if qseg is not None:
                mask = mask & (qseg[:, i][:, :, None] == kseg[:, t][:, None, :])
            s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bqkgp,bpkd->bqkgd", p, v[:, t].float())
            m = m_new
        outs.append(o / torch.clamp(l[..., None], min=1e-20))
    return torch.stack(outs, dim=1)


def striped_cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, segment_ids: Optional[torch.Tensor],
                         mesh=None, axis: str = "model", block: int = 256,
                         kv_prefix=None) -> torch.Tensor:
    """Exact-causal, load-balanced CP attention over mesh axis ``axis``.

    With no mesh, or one without ``axis``, the arguments are whole:
    q [B, S, H, dh], k / v [B, S, Hkv, dh], positions / segments [B, S], in
    the striped layout (the JAX single-device branch).  Under a mesh they
    are this rank's blocks of the striped sequence (``S / P`` rows; the
    batch is this rank's too where the mesh has data axes), and the output
    is this rank's block.  ``kv_prefix = (pk, pv, keep)`` holds soft-prompt
    PEFT's learned rows, the same on every rank of the axis, folded into
    each local q block's carry before the chunk pairs."""
    B, S_l, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    seg = segment_ids if segment_ids is not None else torch.zeros(
        (B, S_l), dtype=torch.int32, device=q.device)
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        n = S_l // block
        qs = seg.reshape(B, n, block)
        qp = positions.reshape(B, n, block)
        o = _flash_ragged_pairs(q.reshape(B, n, block, Hkv, G, dh),
                                k.reshape(B, n, block, Hkv, dh), v.reshape(B, n, block, Hkv, dh),
                                qp, qp, qs, qs, kv_prefix=kv_prefix)
        return o.reshape(B, S_l, H, dh).to(q.dtype)
    P_sz = mesh.shape[axis]
    S = S_l * P_sz
    nq = S_l // block
    kg = collectives.all_gather(k, axis, 1, mesh)      # [B, S, Hkv, dh], rank-major
    vg = collectives.all_gather(v, axis, 1, mesh)
    with torch.no_grad():
        pg = collectives._all_gather(positions.contiguous(), axis, mesh, 1)
        sg = collectives._all_gather(seg.contiguous(), axis, mesh, 1)
    # re-chunk by global block: block g sits on rank g % P at local slot g // P
    n = S // block
    gather_idx = torch.from_numpy(np.concatenate([
        np.arange(block) + (g % P_sz) * S_l + (g // P_sz) * block for g in range(n)
    ])).to(q.device)
    kg, vg, pg, sg = (t.index_select(1, gather_idx) for t in (kg, vg, pg, sg))
    nc, cblk = n // P_sz, P_sz * block
    if kv_prefix is not None:
        pk, pv, keep = kv_prefix
        kv_prefix = (collectives.fan_out(pk, axis, mesh), collectives.fan_out(pv, axis, mesh),
                     keep)
    o = _flash_ragged_pairs(q.reshape(B, nq, block, Hkv, G, dh),
                            kg.reshape(B, nc, cblk, Hkv, dh), vg.reshape(B, nc, cblk, Hkv, dh),
                            positions.reshape(B, nq, block), pg.reshape(B, nc, cblk),
                            seg.reshape(B, nq, block), sg.reshape(B, nc, cblk),
                            kv_prefix=kv_prefix)
    return o.reshape(B, S_l, H, dh).to(q.dtype)
