"""Gradients of the port's kernel ops (plain versions under autograd, CPU)
against ``jax.grad`` through the JAX package: the Pallas kernels' custom
VJPs in interpret mode, its xla tier, and ``repro.kernels.ref``.

Each case takes the gradient of ``sum(op(...) * w)`` for a seeded cotangent
``w``.  Inputs come from a numpy seed; f32 throughout, compared at
rtol/atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alignment import align_tasks
from repro.data import make_task
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.grouped_lora import grouped_lora_pallas
from repro.kernels.packed_attention import packed_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_lora import grouped_lora_plain

F32 = dict(rtol=1e-5, atol=1e-5)


def _grads_torch(fn, arrays, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (fn(*ts) * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _grads_jax(fn, arrays, w):
    return [np.asarray(g) for g in
            jax.grad(lambda *xs: (fn(*xs) * w).sum(), argnums=tuple(range(len(arrays))))(
                *[jnp.asarray(a) for a in arrays])]


# ---------------------------------------------------------------------------
# grouped LoRA
# ---------------------------------------------------------------------------


def _lora_case(rs, M, d_in, d_out, ranks, r):
    """T = len(ranks) slots at stack rank r; each tenant's rows past its own
    rank start at zero in B, as a padded stack does; B is non-zero."""
    T = len(ranks)
    x = rs.randn(M, d_in).astype(np.float32)
    a = (rs.randn(T, d_in, r) * 0.1).astype(np.float32)
    b = (rs.randn(T, r, d_out) * 0.1).astype(np.float32)
    for t, rk in enumerate(ranks):
        b[t, rk:] = 0.0
    scale = np.asarray([16.0 / rk for rk in ranks], np.float32)
    w = rs.randn(M, d_out).astype(np.float32)
    return x, a, b, scale, w


@pytest.mark.parametrize("case", ["task_per_row", "blocks_with_idle_rows"])
def test_grouped_lora_grads_match_pallas_and_ref(case):
    rs = np.random.RandomState(11)
    if case == "task_per_row":  # every row its own task, -1 rows among them
        M, block_m = 12, 1
        rt = np.asarray([0, 2, -1, 1, 1, 0, -1, 2, 0, 1, 2, -1], np.int32)
    else:
        M, block_m = 48, 8
        rt = np.repeat(np.asarray([1, -1, 0, 2, 2, -1], np.int32), 8)
    x, a, b, scale, w = _lora_case(rs, M, 24, 40, (4, 8, 16), 16)

    def port(x_, a_, b_):
        return grouped_lora_plain(x_, a_, b_, torch.from_numpy(rt), torch.from_numpy(scale))

    def pallas(x_, a_, b_):
        return grouped_lora_pallas(x_, a_, b_, rt, scale, block_m=block_m, block_k=8,
                                   interpret=True)

    def ref(x_, a_, b_):
        return jref.grouped_lora_ref(x_, a_, b_, rt, scale)

    got = _grads_torch(port, (x, a, b), w)
    for name, fn in (("pallas_interpret", pallas), ("ref", ref)):
        want = _grads_jax(fn, (x, a, b), w)
        for leaf, g, wg in zip(("dx", "dA", "dB"), got, want):
            np.testing.assert_allclose(g, wg, err_msg=f"{name} {leaf}", **F32)
    assert np.all(got[0][rt < 0] == 0.0)  # no-adapter rows pass no gradient


def test_grouped_lora_op_grads_match_both_tiers():
    """ops.grouped_lora over [B, S, d_in] (one task per batch row, T = 3 at
    the stack rank) against jax.grad of kops.grouped_lora on both tiers."""
    rs = np.random.RandomState(12)
    B, S = 4, 8
    x, a, b, scale, _ = _lora_case(rs, B * S, 16, 24, (2, 8, 4), 8)
    x = x.reshape(B, S, 16)
    w = rs.randn(B, S, 24).astype(np.float32)
    rt = np.asarray([2, -1, 0, 1], np.int32)
    got = _grads_torch(lambda *t: ops.grouped_lora(*t, torch.from_numpy(rt),
                                                   torch.from_numpy(scale)), (x, a, b), w)
    for impl in ("xla", "pallas_interpret"):
        jops.set_impl(impl)
        try:
            want = _grads_jax(lambda *t: jops.grouped_lora(*t, rt, scale), (x, a, b), w)
        finally:
            jops.set_impl("xla")
        for leaf, g, wg in zip(("dx", "dA", "dB"), got, want):
            np.testing.assert_allclose(g, wg, err_msg=f"{impl} {leaf}", **F32)


# ---------------------------------------------------------------------------
# packed attention
# ---------------------------------------------------------------------------


def _loader_rows(S, datasets, rows):
    tasks = [make_task(f"t{i}", ds, 4, seed=i) for i, ds in enumerate(datasets)]
    arr = align_tasks(tasks, list(range(len(tasks))), "chunked", row_len=S).arrays()
    return arr["segment_ids"][rows], arr["positions"][rows]


def _attn_case(rs, B, S, H, Hkv, dh):
    q = rs.randn(B, S, H, dh).astype(np.float32)
    k = rs.randn(B, S, Hkv, dh).astype(np.float32)
    v = rs.randn(B, S, Hkv, dh).astype(np.float32)
    w = rs.randn(B, S, H, dh).astype(np.float32)
    return q, k, v, w


def test_packed_attention_grads_on_loader_layout():
    """dq, dk, dv on loader rows whose segment padding crosses the 128
    boundary, with GQA (H = 4, Hkv = 2), against the Pallas kernels' VJP in
    interpret mode and the xla tier (both cut tiles at 128 here)."""
    seg, pos = _loader_rows(256, ("sst2", "qa", "rte", "sst2"), [0, 2, 5])
    crosses = [(np.diff(p[:129]) < 0).any() and (p[128:] == 0).any() for p in pos]
    assert any(crosses)  # some segment's position-0 padding spans index 128
    rs = np.random.RandomState(13)
    q, k, v, w = _attn_case(rs, len(seg), 256, 4, 2, 16)
    got = _grads_torch(lambda *t: ops.packed_attention(
        *t, segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos)), (q, k, v), w)

    def pallas(q_, k_, v_):
        return packed_attention_pallas(q_, k_, v_, segment_ids=seg, positions=pos,
                                       block_q=128, block_k=128, interpret=True)

    def xla(q_, k_, v_):
        return jops.packed_attention(q_, k_, v_, segment_ids=seg, positions=pos)

    for name, fn in (("pallas_interpret", pallas), ("xla", xla)):
        want = _grads_jax(fn, (q, k, v), w)
        for leaf, g, wg in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, wg, err_msg=f"{name} {leaf}", **F32)


def test_packed_attention_grads_match_ref_on_monotone_rows():
    """Two packed segments whose positions rise within each: the tile rule
    removes nothing, so ``ref.py`` is the oracle (dq, dk, dv, GQA)."""
    rs = np.random.RandomState(14)
    B, S = 2, 64
    seg = np.repeat(np.asarray([[0, 1], [0, 1]], np.int32), [24, 40], axis=1)
    pos = np.concatenate([np.arange(24), np.arange(40)])[None].repeat(B, 0).astype(np.int32)
    q, k, v, w = _attn_case(rs, B, S, 4, 2, 16)
    got = _grads_torch(lambda *t: ops.packed_attention(
        *t, segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos),
        block_q=16, block_k=16), (q, k, v), w)
    want = _grads_jax(lambda *t: jref.packed_attention_ref(*t, segment_ids=seg, positions=pos),
                      (q, k, v), w)
    for leaf, g, wg in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, wg, err_msg=leaf, **F32)


@pytest.mark.parametrize("dh", [64, 80, 128])
def test_packed_attention_plain_grads_match_pallas_at_kernel_widths(dh):
    """dq, dk, dv of the plain version (what the card holds the backward
    kernels to) at the CUDA kernels' head widths, on a ragged layout: S = 40
    rows in two packed segments behind a 16-row prefix of wildcard (-1) and
    unseen (-2) rows (Sk = 56), tiles of 8, GQA (G = 3), against the Pallas
    kernels' VJP in interpret mode."""
    from repro_torch.kernels.packed_attention import packed_attention_plain, tile_sizes

    rs = np.random.RandomState(30 + dh)
    B, S, P, H, Hkv = 2, 40, 16, 6, 2
    cut = S // 3
    seg = np.repeat(np.asarray([[0, 1]] * B, np.int32), [cut, S - cut], axis=1)
    pos = np.concatenate([np.arange(cut), np.arange(S - cut)])[None].repeat(B, 0)
    pos = pos.astype(np.int32)
    pseg = np.full((B, P), -2, np.int32)
    pseg[0, ::2] = -1
    pseg[1, :5] = -1
    kpos = np.concatenate([np.full((B, P), -1, np.int32), pos], 1)
    kseg = np.concatenate([pseg, seg], 1)
    q = rs.randn(B, S, H, dh).astype(np.float32)
    k = rs.randn(B, S + P, Hkv, dh).astype(np.float32)
    v = rs.randn(B, S + P, Hkv, dh).astype(np.float32)
    w = rs.randn(B, S, H, dh).astype(np.float32)
    bq, bk = tile_sizes(S, S + P, 8, 8)
    ints = [torch.from_numpy(a) for a in (pos, seg, kpos, kseg)]
    got = _grads_torch(lambda *t: packed_attention_plain(*t, *ints, True, bq, bk), (q, k, v), w)
    want = _grads_jax(lambda *t: packed_attention_pallas(
        *t, segment_ids=seg, positions=pos, k_segment_ids=kseg, k_positions=kpos,
        block_q=8, block_k=8, interpret=True), (q, k, v), w)
    for leaf, g, wg in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, wg, err_msg=leaf, **F32)
