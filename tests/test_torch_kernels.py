"""The port's three kernel ops (plain versions, CPU) against the JAX package:
``repro.kernels.ref`` and the Pallas kernels in interpret mode.

Inputs come from a numpy seed and go through both frameworks as numpy.
f32 cases compare at rtol/atol 1e-5; one bf16 case per op at atol 4e-2.
On CPU tensors the ops never launch a CUDA kernel: the launch counters stay 0.

Packed attention's tile-visibility rule is checked on layouts the loader
makes (``align_tasks``, chunked): a packed segment's padding sits at
position 0 with the segment's id, so which of those keys a real query sees
depends on the Pallas kernel's key-tile cut.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alignment import align_tasks
from repro.data import make_task
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.grouped_lora import grouped_lora_pallas
from repro.kernels.packed_attention import packed_attention_pallas
from repro_torch.kernels import ops

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-2, atol=4e-2)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.float().numpy()


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {
        "grouped_lora": 0, "grouped_lora_bwd": 0, "packed_attention": 0,
        "packed_attention_dq": 0, "packed_attention_dkv": 0, "decode_attention": 0,
        "quant_matmul": 0, "mamba_scan": 0, "mamba_scan_bwd_state": 0,
        "mamba_scan_bwd_chunk": 0}


# ---------------------------------------------------------------------------
# grouped LoRA
# ---------------------------------------------------------------------------


def _lora_inputs(rs, M, d_in, d_out, T, r):
    x = rs.randn(M, d_in).astype(np.float32)
    a = (rs.randn(T, d_in, r) * 0.1).astype(np.float32)
    b = (rs.randn(T, r, d_out) * 0.1).astype(np.float32)
    scale = rs.uniform(0.5, 2.0, T).astype(np.float32)
    return x, a, b, scale


@pytest.mark.parametrize("case", ["blocks_with_idle_rows", "task_per_row"])
def test_grouped_lora_matches_ref_and_pallas(case):
    from repro_torch.kernels.grouped_lora import grouped_lora_plain

    rs = np.random.RandomState(0)
    if case == "blocks_with_idle_rows":
        M, block_m = 64, 16
        rt = np.repeat(np.asarray([0, -1, 2, 1], np.int32), 16)
    else:  # decode: S = 1, so every row may carry its own task
        M, block_m = 8, 1
        rt = np.asarray([0, 1, 2, -1, 1, 0, 2, -1], np.int32)
    x, a, b, scale = _lora_inputs(rs, M, 32, 48, 3, 8)
    out = _np(grouped_lora_plain(_t(x), _t(a), _t(b), _t(rt), _t(scale)))
    ref = np.asarray(jref.grouped_lora_ref(x, a, b, rt, scale))
    pal = np.asarray(grouped_lora_pallas(x, a, b, rt, scale, block_m=block_m,
                                         block_k=16, interpret=True))
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, pal, **F32)
    assert np.all(out[rt < 0] == 0.0)


def test_grouped_lora_op_three_tasks_at_stack_rank():
    """ops.grouped_lora over [B, S, d_in] with T = 3 slots at the stack rank
    (the largest tenant rank; smaller tenants use the same padded slot
    width), against both JAX tiers of kops.grouped_lora."""
    rs = np.random.RandomState(1)
    B, S, d_in, d_out, T, r = 4, 8, 32, 24, 3, 16
    x = rs.randn(B, S, d_in).astype(np.float32)
    _, a, b, scale = _lora_inputs(rs, 1, d_in, d_out, T, r)
    rt = np.asarray([2, -1, 0, 1], np.int32)
    out = _np(ops.grouped_lora(_t(x), _t(a), _t(b), _t(rt), _t(scale)))
    for impl in ("xla", "pallas_interpret"):
        jops.set_impl(impl)
        try:
            want = np.asarray(jops.grouped_lora(x, a, b, rt, scale))
        finally:
            jops.set_impl("xla")
        np.testing.assert_allclose(out, want, err_msg=impl, **F32)


def test_grouped_lora_bf16():
    from repro_torch.kernels.grouped_lora import grouped_lora_plain

    rs = np.random.RandomState(2)
    x, a, b, scale = _lora_inputs(rs, 16, 64, 32, 2, 8)
    rt = np.asarray([0] * 8 + [1] * 4 + [-1] * 4, np.int32)
    out = _np(grouped_lora_plain(_t(x, torch.bfloat16), _t(a, torch.bfloat16),
                                 _t(b, torch.bfloat16), _t(rt), _t(scale)))
    pal = grouped_lora_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16), rt, scale, block_m=4,
                              block_k=32, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal, np.float32), **BF16)


# ---------------------------------------------------------------------------
# packed attention
# ---------------------------------------------------------------------------


def _attn_inputs(rs, B, S, Sk, H, Hkv, dh):
    q = rs.randn(B, S, H, dh).astype(np.float32)
    k = rs.randn(B, Sk, Hkv, dh).astype(np.float32)
    v = rs.randn(B, Sk, Hkv, dh).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["causal", "packed_segments", "gqa", "not_causal"])
def test_packed_attention_matches_ref_and_pallas(case):
    rs = np.random.RandomState(3)
    B, S, dh = 2, 32, 16
    H, Hkv = (4, 2) if case == "gqa" else (2, 2)
    q, k, v = _attn_inputs(rs, B, S, S, H, Hkv, dh)
    seg = pos = None
    if case == "packed_segments":  # two sequences packed per row, positions restart
        seg = np.repeat(np.asarray([[0, 1], [0, 1]], np.int32), [12, 20], axis=1)
        pos = np.concatenate([np.arange(12), np.arange(20)])[None].repeat(B, 0).astype(np.int32)
    causal = case != "not_causal"
    out = _np(ops.packed_attention(_t(q), _t(k), _t(v),
                                   segment_ids=None if seg is None else _t(seg),
                                   positions=None if pos is None else _t(pos), causal=causal))
    ref = np.asarray(jref.packed_attention_ref(q, k, v, segment_ids=seg, positions=pos,
                                               causal=causal))
    pal = np.asarray(packed_attention_pallas(q, k, v, segment_ids=seg, positions=pos,
                                             causal=causal, block_q=8, block_k=8,
                                             interpret=True))
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, pal, **F32)


def test_packed_attention_prefix_rows():
    """Wildcard (-1) and gated-off (-2) prefix key rows, Sk > S, against the
    Pallas tier of kops.packed_attention (which builds the same rows)."""
    rs = np.random.RandomState(4)
    B, S, P, H, Hkv, dh = 2, 16, 4, 4, 2, 16
    q, k, v = _attn_inputs(rs, B, S, S, H, Hkv, dh)
    pk = rs.randn(B, P, Hkv, dh).astype(np.float32)
    pv = rs.randn(B, P, Hkv, dh).astype(np.float32)
    keep = np.asarray([[1.0] * P, [0.0] * P], np.float32)  # row 1 owns no prefix
    out = _np(ops.packed_attention(_t(q), _t(k), _t(v), prefix_kv=(_t(pk), _t(pv)),
                                   prefix_keep=_t(keep)))
    jops.set_impl("pallas_interpret")
    try:
        pal = np.asarray(jops.packed_attention(q, k, v, prefix_kv=(pk, pv),
                                               prefix_keep=keep, block_q=8, block_k=8))
    finally:
        jops.set_impl("xla")
    np.testing.assert_allclose(out, pal, **F32)
    bare = _np(ops.packed_attention(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(out[1], bare[1], **F32)  # -2 rows are invisible
    assert np.abs(out[0] - bare[0]).max() > 1e-3        # -1 rows are seen


def test_packed_attention_fully_masked_row_gives_zero():
    """A query that sees no key gives 0 in the port.  The Pallas kernel gives
    the mean of v over the key tiles it visited for such a row (p is not
    masked again after exp); every other row matches it."""
    from repro_torch.kernels.packed_attention import packed_attention_plain

    rs = np.random.RandomState(5)
    B, S, P, H, Hkv, dh = 1, 8, 4, 2, 1, 16
    q, k, v = _attn_inputs(rs, B, S, S + P, H, Hkv, dh)
    pos = np.arange(S, dtype=np.int32)[None]
    seg = np.zeros((B, S), np.int32)
    seg[0, 3] = 7  # no key carries segment 7
    kpos = np.concatenate([np.full((B, P), -1, np.int32), pos], 1)
    kseg = np.concatenate([np.full((B, P), -2, np.int32), np.zeros((B, S), np.int32)], 1)
    out = _np(packed_attention_plain(_t(q), _t(k), _t(v), _t(pos), _t(seg), _t(kpos),
                                     _t(kseg), causal=True))
    pal = np.asarray(packed_attention_pallas(q, k, v, segment_ids=seg, positions=pos,
                                             k_segment_ids=kseg, k_positions=kpos,
                                             block_q=4, block_k=4, interpret=True))
    assert np.all(out[0, 3] == 0.0)
    live = np.ones(S, bool)
    live[3] = False
    np.testing.assert_allclose(out[:, live], pal[:, live], **F32)
    np.testing.assert_allclose(pal[0, 3, 0], v[0, :8, 0].mean(0), rtol=1e-5, atol=1e-5)


def _ragged_prefix_layout(B, S, P):
    """Two packed segments per row (positions restart in the second) behind
    P prefix key rows: wildcard (-1) or unseen (-2), mixed per row."""
    cut = S // 3
    seg = np.repeat(np.asarray([[0, 1]] * B, np.int32), [cut, S - cut], axis=1)
    pos = np.concatenate([np.arange(cut), np.arange(S - cut)])[None].repeat(B, 0)
    pos = pos.astype(np.int32)
    pseg = np.full((B, P), -2, np.int32)
    pseg[0, ::2] = -1
    pseg[1, :5] = -1
    kpos = np.concatenate([np.full((B, P), -1, np.int32), pos], 1)
    kseg = np.concatenate([pseg, seg], 1)
    return pos, seg, kpos, kseg


@pytest.mark.parametrize("dh", [64, 80, 128])
def test_packed_attention_plain_matches_pallas_at_kernel_widths(dh):
    """The plain version, which the CUDA kernels are held to on the card, at
    the head widths they are built for, on a ragged layout (S = 40 rows, a
    16-row prefix, Sk = 56, tiles of 8) against the Pallas kernel."""
    from repro_torch.kernels.packed_attention import packed_attention_plain, tile_sizes

    rs = np.random.RandomState(20 + dh)
    B, S, P, H, Hkv = 2, 40, 16, 6, 2
    q, k, v = _attn_inputs(rs, B, S, S + P, H, Hkv, dh)
    pos, seg, kpos, kseg = _ragged_prefix_layout(B, S, P)
    bq, bk = tile_sizes(S, S + P, 8, 8)
    out = _np(packed_attention_plain(_t(q), _t(k), _t(v), _t(pos), _t(seg), _t(kpos),
                                     _t(kseg), True, bq, bk))
    pal = np.asarray(packed_attention_pallas(q, k, v, segment_ids=seg, positions=pos,
                                             k_segment_ids=kseg, k_positions=kpos,
                                             block_q=8, block_k=8, interpret=True))
    np.testing.assert_allclose(out, pal, **F32)


def loader_layout(S, datasets, micro_batch=4):
    """segment_ids / positions of one fused hTask batch of row length S."""
    tasks = [make_task(f"t{i}", ds, micro_batch, seed=i) for i, ds in enumerate(datasets)]
    arr = align_tasks(tasks, list(range(len(tasks))), "chunked", row_len=S).arrays()
    return arr["segment_ids"], arr["positions"]


def test_packed_attention_tile_rule_on_loader_layout():
    """S = 256: the port, the JAX xla tier and the Pallas-interpret tier
    agree (tiles of 128 on both sides), and all differ from ``ref.py``'s
    plain position/segment mask on real tokens."""
    seg, pos = loader_layout(256, ("sst2", "qa", "rte", "sst2"))
    rs = np.random.RandomState(9)
    q, k, v = _attn_inputs(rs, seg.shape[0], 256, 256, 4, 2, 16)
    out = _np(ops.packed_attention(_t(q), _t(k), _t(v), segment_ids=_t(seg), positions=_t(pos)))
    for impl in ("xla", "pallas_interpret"):
        jops.set_impl(impl)
        try:
            want = np.asarray(jops.packed_attention(q, k, v, segment_ids=seg, positions=pos))
        finally:
            jops.set_impl("xla")
        np.testing.assert_allclose(out, want, err_msg=impl, **F32)
    ref = np.asarray(jref.packed_attention_ref(q, k, v, segment_ids=seg, positions=pos))
    assert np.abs(out - ref).max() > 0.1  # the tile rule is live on this layout


def test_packed_attention_tile_rule_follows_pallas_at_192():
    """S = 192: the JAX tiers disagree (the xla tier cuts at _fit_block's 96,
    the Pallas kernel at gcd(192, 128) = 64).  The port follows the Pallas
    tier: its kernels replace the Pallas kernels, and its plain version is
    held to them."""
    seg, pos = loader_layout(192, ("sst2", "qa", "qa"))
    rs = np.random.RandomState(10)
    q, k, v = _attn_inputs(rs, seg.shape[0], 192, 192, 4, 2, 16)
    out = _np(ops.packed_attention(_t(q), _t(k), _t(v), segment_ids=_t(seg), positions=_t(pos)))
    jops.set_impl("pallas_interpret")
    try:
        pal = np.asarray(jops.packed_attention(q, k, v, segment_ids=seg, positions=pos))
    finally:
        jops.set_impl("xla")
    np.testing.assert_allclose(out, pal, **F32)
    xla = np.asarray(jops.packed_attention(q, k, v, segment_ids=seg, positions=pos))
    assert np.abs(out - xla).max() > 0.1  # the tiers' disagreement is live here


def test_packed_attention_bf16():
    rs = np.random.RandomState(6)
    q, k, v = _attn_inputs(rs, 2, 32, 32, 4, 2, 16)
    out = _np(ops.packed_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                   _t(v, torch.bfloat16)))
    pal = packed_attention_pallas(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                  block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal, np.float32), **BF16)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(rs, B, Smax, H, Hkv, dh):
    q = rs.randn(B, 1, H, dh).astype(np.float32)
    kc = rs.randn(B, Smax, Hkv, dh).astype(np.float32)
    vc = rs.randn(B, Smax, Hkv, dh).astype(np.float32)
    return q, kc, vc


def test_decode_attention_matches_ref_and_pallas():
    """Per-row windows, lo > 0, an empty window, GQA, and Smax = 40, which
    the kernel's 128-row split does not divide."""
    rs = np.random.RandomState(7)
    B, Smax, H, Hkv, dh = 4, 40, 4, 2, 16
    q, kc, vc = _decode_inputs(rs, B, Smax, H, Hkv, dh)
    end = np.asarray([40, 17, 30, 5], np.int32)
    start = np.asarray([0, 3, 12, 5], np.int32)  # row 3: empty window
    out = _np(ops.decode_attention(_t(q), _t(kc), _t(vc), _t(end), _t(start)))
    ref = np.asarray(jref.decode_attention_ref(q, kc, vc, end, start))
    pal = np.asarray(decode_attention_pallas(q, kc, vc, end, start, split_k=16,
                                             interpret=True))
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, pal, **F32)
    assert np.all(np.isfinite(out)) and np.all(out[3] == 0.0)


def test_decode_attention_bf16():
    rs = np.random.RandomState(8)
    q, kc, vc = _decode_inputs(rs, 2, 32, 4, 2, 16)
    end = np.asarray([32, 9], np.int32)
    out = _np(ops.decode_attention(_t(q, torch.bfloat16), _t(kc, torch.bfloat16),
                                   _t(vc, torch.bfloat16), _t(end)))
    pal = decode_attention_pallas(*(jnp.asarray(t, jnp.bfloat16) for t in (q, kc, vc)),
                                  end, split_k=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal, np.float32), **BF16)


@pytest.mark.parametrize("name", ["grouped_lora", "grouped_lora_bwd", "packed_attention",
                                  "packed_attention_dq", "packed_attention_dkv",
                                  "decode_attention", "quant_matmul"])
def test_cuda_wrapper_refuses_cpu_tensors(name):
    """The kernel wrappers take CUDA tensors only; the CPU path is ops'."""
    import importlib

    x = torch.zeros((2, 4, 2, 16))
    lora = (torch.zeros(4, 8), torch.zeros(1, 8, 2), torch.zeros(1, 2, 8),
            torch.zeros(4, dtype=torch.int32), torch.ones(1))
    attn = (x, x, x) + (torch.zeros(2, 4, dtype=torch.int32),) * 4
    module, args = {
        "grouped_lora": ("grouped_lora", lora),
        "grouped_lora_bwd": ("grouped_lora", lora + (torch.zeros(4, 2), torch.zeros(4, 8))),
        "packed_attention": ("packed_attention", attn),
        "packed_attention_dq": ("packed_attention", attn + (x, torch.zeros(2, 2, 4), x)),
        "packed_attention_dkv": ("packed_attention", attn + (x, torch.zeros(2, 2, 4), x)),
        "decode_attention": ("decode_attention", (x[:, :1], x, x, torch.ones(2, dtype=torch.int32),
                                                  torch.zeros(2, dtype=torch.int32))),
        "quant_matmul": ("quant_matmul", (torch.zeros(4, 8, dtype=torch.bfloat16),
                                          torch.zeros(8, 16, dtype=torch.int8),
                                          torch.ones(16))),
    }[name]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, f"{name}_cuda")(*args)
