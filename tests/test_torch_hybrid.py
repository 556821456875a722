"""The port's hybrid family (zamba2-2.7b: Mamba2 blocks and one weight-shared
attention+MLP block) against the JAX package, on the CPU.

* ``mamba_scan``'s plain version: values (y, final state) and the six
  gradients of ``sum(y * w) + sum(h * w2)`` against the Pallas kernel in
  interpret mode, the JAX xla tier (``chunked_gla``) and a segment-sliced
  ``ref.mamba_scan_ref``, at rtol/atol 1e-5, with n = 4 chunks.
* One Mamba2 block through ``apply_base_op`` with LoRA on ``ssm_in`` /
  ``ssm_out``, the hybrid ``Model.forward``, and two ``run_iteration``s
  against the JAX engine on its xla tier, on ``smoke_config("zamba2-2.7b")``
  with weights carried across by ``repro_torch.convert`` (f32).  Both sides
  use ``attn_q_block = 128`` (ROADMAP Queue 3: the tiers' tile rules agree
  there).
* The tiled kernels' arithmetic in plain PyTorch at (dk, dv) = (128, 129)
  (64 x 64 tiles, dv padded with zero columns): the forward and the state
  and chunk backward, each against the plain version over the whole state
  within 1e-5; ``ops.tile_padded``; the card branch of ``ops.mamba_scan``
  (forced on CPU tensors, the tiled entry points replaced by recording
  plain stand-ins) routing a gradient at (64, 65) through the tiled op,
  equal to autograd of the unpadded plain scan, and raising when a tiled
  kernel fails.
* The planner and the cost model's Eq. 5 at full size, ``convert`` of hybrid
  trees, the CLI, the refusals, and two reference quirks the port follows.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import ExecutionPlanner as JaxPlanner
from repro.core import ModelGenerator as JaxGenerator
from repro.core import ParallelismSpec as JaxParallelism
from repro.core import PEFTEngine as JaxEngine
from repro.core import cost_model as jax_cost_model
from repro.data import HTaskLoader as JaxLoader
from repro.data import make_task as jax_make_task
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.launch.train import scaled_config as jax_scaled_config
from repro.models import ssm as jssm
from repro.models.transformer import build_model
from repro.peft.hooks import adapter_scope as jax_adapter_scope
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.peft.multitask import TaskSegments as JaxTaskSegments
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.core.cost_model import CostModel
from repro_torch.data import HTaskLoader, make_task
from repro_torch.kernels import ops
from repro_torch.launch.train import scaled_config
from repro_torch.models import ssm
from repro_torch.models.transformer import Model
from repro_torch.peft.hooks import adapter_scope
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters, TaskSegments
from repro_torch.train.optimizer import adamw_init

ROOT = Path(__file__).resolve().parent.parent
ARCH = "zamba2-2.7b"
TARGETS = ("ssm_in", "ssm_out", "attn_q", "attn_v")
TENANTS = (("sst2", "lora", 8), ("qa", "lora", 16), ("rte", "adapter", 4), ("sst2", "ia3", 8))
MICRO_BATCH = 2
LR = 1e-3
F32 = dict(rtol=1e-5, atol=1e-5)
FILLED = ("b", "up", "s")  # the adapter leaves that start at zero
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    """{path: float32 numpy leaf} of a nested dict of numpy or torch leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v.detach().float().numpy() if torch.is_tensor(v) \
                else np.asarray(v, np.float32)
    return out


def _fill_zero_leaves(tree, rs):
    """LoRA B, Adapter up and IA3 s start at 0; fill them so every gradient
    is live."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_zero_leaves(v, rs)
        elif k in FILLED:
            tree[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)


def _tasks(make, config_cls):
    return [make(f"task{i}-{ds}", ds, MICRO_BATCH, config_cls(kind, rank=rank, targets=TARGETS),
                 seed=i)
            for i, (ds, kind, rank) in enumerate(TENANTS)]


# ---------------------------------------------------------------------------
# mamba_scan: plain version against the Pallas kernel, the xla tier and ref
# ---------------------------------------------------------------------------

B_, S_, H_, D_, Q_ = 2, 64, 2, 8, 16  # n = 4 chunks
# xlstm_resets_h0: resets_h0 with the mLSTM's shape, dv = dk + 1 (the
# normalizer column of v)
SCAN_CASES = ("resets_h0", "no_reset_h0", "no_reset", "xlstm_resets_h0")


def _scan_inputs(case):
    """Inputs drawn as the JAX package's own mamba_scan gradient test draws
    them (``test_kernel_grads.py``: k and the state cotangent scaled by 0.3,
    h0 by 0.5, Mamba-like gates), from a numpy seed."""
    rs = np.random.RandomState(5)
    dv = D_ + 1 if case.startswith("xlstm_") else D_
    case = case.removeprefix("xlstm_")

    def softplus(x):
        return np.log1p(np.exp(x))

    q = rs.randn(B_, S_, H_, D_).astype(np.float32)
    k = (rs.randn(B_, S_, H_, D_) * 0.3).astype(np.float32)
    v = rs.randn(B_, S_, H_, dv).astype(np.float32)
    la = (-softplus(rs.randn(B_, S_, H_))).astype(np.float32)
    li = np.log(softplus(rs.randn(B_, S_, H_)) + 1e-3).astype(np.float32)
    h0 = (rs.randn(B_, H_, D_, dv) * 0.5).astype(np.float32)
    w = rs.randn(B_, S_, H_, dv).astype(np.float32)
    w2 = (rs.randn(B_, H_, D_, dv) * 0.3).astype(np.float32)
    reset = None
    if case == "resets_h0":
        # chunk starts (16, 32), inside chunks (5, 21, 40, 63), position 0
        reset = np.zeros((B_, S_), np.float32)
        reset[0, [0, 16, 21, 40]] = 1.0
        reset[1, [5, 32, 33, 63]] = 1.0
    if case == "no_reset":
        h0 = None
    return (q, k, v, la, li, h0), reset, w, w2


def _sliced_ref(q, k, v, la, li, h0, reset):
    """The sequential oracle run per segment: the first segment of a row
    starts from h0, every later one from zeros."""
    if reset is None:
        return jref.mamba_scan_ref(q, k, v, la, li, h0=h0)
    ys, hs = [], []
    for b in range(B_):
        starts = [0] + [t for t in range(1, S_) if reset[b, t] > 0] + [S_]
        h = h0[b:b + 1] if reset[b, 0] == 0 else jnp.zeros_like(h0[b:b + 1])
        yb = []
        for s0, s1 in zip(starts[:-1], starts[1:]):
            if s0 > 0:
                h = jnp.zeros_like(h)
            y, h = jref.mamba_scan_ref(*(t[b:b + 1, s0:s1] for t in (q, k, v, la, li)), h0=h)
            yb.append(y)
        ys.append(jnp.concatenate(yb, axis=1))
        hs.append(h)
    return jnp.concatenate(ys, axis=0), jnp.concatenate(hs, axis=0)


def _jax_scan(ref, reset):
    r = None if reset is None else jnp.asarray(reset)
    if ref == "pallas_interpret":
        return lambda *a: mamba_scan_pallas(*a[:5], chunk=Q_, h0=a[5], reset=r, interpret=True)
    if ref == "xla":
        def xla(*a):
            prev = jops.get_impl()
            jops.set_impl("xla")
            try:
                return jops.mamba_scan(*a[:5], chunk=Q_, h0=a[5], reset=r)
            finally:
                jops.set_impl(prev)
        return xla
    return lambda *a: _sliced_ref(*a, reset)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla", "ref"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_mamba_scan_plain_matches_jax(case, ref):
    arrays, reset, w, w2 = _scan_inputs(case)
    fn = _jax_scan(ref, reset)
    h0_given = arrays[5] is not None
    jarr = [jnp.asarray(a) if a is not None else jnp.zeros(w2.shape, jnp.float32)
            for a in arrays]

    def jloss(*xs):
        y, h = fn(*xs)
        return (y * w).sum() + (h * w2).sum()

    y_j, h_j = jax.jit(fn)(*jarr)
    g_j = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*jarr)

    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in jarr]
    y, h = ops.mamba_scan(*ts[:5], chunk=Q_, h0=ts[5] if h0_given else None,
                          reset=None if reset is None else torch.from_numpy(reset))
    ((y * torch.from_numpy(w)).sum() + (h * torch.from_numpy(w2)).sum()).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **F32)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), **F32)
    names = ("dq", "dk", "dv", "dla", "dli", "dh0")
    for name, t, g in zip(names, ts, g_j):
        if name == "dh0" and not h0_given:
            assert t.grad is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **F32)
    if reset is not None:  # a reset position's own decay gets no gradient
        assert np.all(ts[3].grad.numpy()[reset > 0] == 0.0)


@pytest.mark.parametrize("case", ["resets_h0", "no_reset_h0", "resets_h0_no_dh0"])
def test_mamba_scan_backward_kernels_plain_match_autograd(case):
    """The backward as ``MambaScanFunction`` composes it (the state kernel,
    the chunk kernel, then dla as a segment-bounded reverse cumsum with
    ``<dhf, hfin>`` at the last position), on the kernels' plain versions,
    against autograd of the plain forward; the forward's saved entry states
    against the states the scan passes through.  ``_no_dh0``: the backward
    without ``want_dh0`` (h0 taking no gradient) gives the same gexit and
    dq, dk, dv, dla, dli bits and no dh0."""
    from repro_torch.kernels import mamba_scan as ms

    want_dh0 = not case.endswith("_no_dh0")
    arrays, reset, w, w2 = _scan_inputs(case.removesuffix("_no_dh0"))
    a = [torch.from_numpy(x) for x in arrays]
    r = None if reset is None else torch.from_numpy(reset).to(torch.int32)
    if r is not None:
        a[3] = torch.where(r[:, :, None] > 0, torch.zeros_like(a[3]), a[3])
    ts = [t.clone().requires_grad_(True) for t in a]
    y, h, hin = ms.mamba_scan_plain(*ts[:5], r, ts[5], Q_, save_states=True)
    wt, w2t = torch.from_numpy(w), torch.from_numpy(w2)
    ref = torch.autograd.grad((y * wt).sum() + (h * w2t).sum(), ts)
    got = ms.mamba_scan_backward_plain(*a[:5], r, hin.detach(), h.detach(), wt, w2t, Q_)
    for name, g1, g2 in zip(("dq", "dk", "dv", "dla", "dli", "dh0"), got, ref):
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), err_msg=name, **F32)
    if not want_dh0:
        part = ms.mamba_scan_backward_plain(*a[:5], r, hin.detach(), h.detach(), wt, w2t, Q_,
                                            want_dh0=False)
        assert part[5] is None
        for name, g1, g2 in zip(("dq", "dk", "dv", "dla", "dli"), part, got):
            assert torch.equal(g1, g2), name
        gexit, dh0 = ms.mamba_scan_bwd_state_plain(a[0], a[3], r, wt, w2t, Q_, want_dh0=False)
        assert dh0 is None
        assert torch.equal(gexit, ms.mamba_scan_bwd_state_plain(a[0], a[3], r, wt, w2t, Q_)[0])
    y1, h1 = ms.mamba_scan_plain(*a[:5], r, a[5], Q_)  # chunk c starts from hin[:, c]
    for c in range(S_ // Q_):
        y2, _ = ms.mamba_scan_plain(*(t[:, c * Q_:(c + 1) * Q_] for t in a[:5]),
                                    None if r is None else r[:, c * Q_:(c + 1) * Q_],
                                    hin[:, c].detach().reshape(B_, H_, D_, D_), Q_)
        np.testing.assert_allclose(y2.numpy(), y1[:, c * Q_:(c + 1) * Q_].numpy(), **F32)


def _tiled_inputs(dk, dv, h0=True):
    """A two-chunk scan at (dk, dv) with resets and a non-zero h0, f32."""
    rs = np.random.RandomState(11)
    B, S, H = 2, 32, 2
    q = torch.from_numpy(rs.randn(B, S, H, dk).astype(np.float32))
    k = torch.from_numpy((rs.randn(B, S, H, dk) * 0.3).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, S, H, dv).astype(np.float32))
    la = torch.from_numpy((-np.log1p(np.exp(rs.randn(B, S, H)))).astype(np.float32))
    li = torch.from_numpy((rs.randn(B, S, H) * 0.3).astype(np.float32))
    r = torch.zeros((B, S), dtype=torch.int32)
    r[0, [0, 7, 16]] = 1
    r[1, 21] = 1
    la = torch.where(r[:, :, None] > 0, torch.zeros_like(la), la)
    h0_ = torch.from_numpy((rs.randn(B, H, dk, dv) * 0.5).astype(np.float32)) if h0 \
        else torch.zeros((B, H, dk, dv))
    return q, k, v, la, li, r, h0_


def test_tiled_scan_decomposition_equals_the_plain_scan():
    """What the tiled forward kernel computes, in plain PyTorch at (dk, dv)
    = (128, 129): v and h0 padded with zero columns to 192 = 3 x 64, one
    scan per (64-wide dk tile, 64-wide dv tile) from that tile of h0, the
    f32 y of each dk tile summed over the dk tiles in order, the tiles'
    final states side by side; y and the final state within f32 rounding
    (1e-5 of the largest |value|) of ``mamba_scan_plain`` over the whole
    state, the padded columns exactly 0."""
    from repro_torch.kernels import mamba_scan as ms

    T = ms.TILE
    q, k, v, la, li, r, h0 = _tiled_inputs(128, 129)
    y_ref, h_ref = ms.mamba_scan_plain(q, k, v, la, li, r, h0, 16)
    vp = torch.nn.functional.pad(v, (0, 192 - 129))
    h0p = torch.nn.functional.pad(h0, (0, 192 - 129))
    y = torch.zeros(vp.shape)
    h = torch.zeros(h0p.shape)
    for kd in range(128 // T):
        ks = slice(kd * T, (kd + 1) * T)
        for vd in range(192 // T):
            vs = slice(vd * T, (vd + 1) * T)
            y_t, h_t = ms.mamba_scan_plain(q[..., ks], k[..., ks], vp[..., vs], la, li, r,
                                           h0p[:, :, ks, vs].contiguous(), 16)
            y[..., vs] += y_t  # f32 (q is f32): the tile sum's order, kd = 0, 1
            h[:, :, ks, vs] = h_t
    assert torch.count_nonzero(y[..., 129:]) == 0 and torch.count_nonzero(h[..., 129:]) == 0
    for name, got, want in (("y", y[..., :129], y_ref), ("h", h[..., :129], h_ref)):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("dims", [(64, 65), (32, 33)])
def test_tile_padded_equals_the_unpadded_scan_bit_for_bit(dims):
    """``ops.tile_padded`` (what ``ops.mamba_scan`` wraps the tiled kernel in
    on the card) on the plain version: dv (and dk, below 64) padded with
    zero columns to multiples of 64 and y and the final state sliced back
    give the unpadded scan's bits, in f32 and in bf16."""
    from repro_torch.kernels import mamba_scan as ms

    q, k, v, la, li, r, h0 = _tiled_inputs(*dims)
    for dt in (torch.float32, torch.bfloat16):
        a = [t.to(dt) for t in (q, k, v)]
        y1, h1 = ms.mamba_scan_plain(*a, la, li, r, h0, 16)
        y2, h2 = ops.tile_padded(ms.mamba_scan_plain, *a, la, li, r, h0, 16)
        assert y2.shape == y1.shape and h2.shape == h1.shape
        assert torch.equal(y1, y2) and torch.equal(h1, h2), dt


@pytest.mark.parametrize("want_dh0", [True, False])
def test_tiled_backward_decomposition_equals_the_plain_backward(want_dh0):
    """What the tiled backward kernels compute, in plain PyTorch at (dk, dv)
    = (128, 129), dv padded with zero columns to 192 = 3 x 64 (v, dy, the
    final state's gradient, the saved states): the state backward per
    (64-wide dk tile, 64-wide dv tile) from that tile of dhf, alone (its
    update is an outer product); the chunk backward per tile from its tiles
    of hin and gexit, dq and dk summed over the dv tiles in order, dv over
    the dk tiles, then dcum and dli from the f32 sums over the whole dk and
    dla as ``_backward`` takes it.  Every output within f32 rounding (1e-5 of
    the largest |value|) of ``mamba_scan_backward_plain`` over the whole
    state, two chunks with resets and a non-zero h0 and dhf; the padded
    columns exactly 0."""
    from repro_torch.kernels import mamba_scan as ms

    T, Q, pad = ms.TILE, 16, 192 - 129
    q, k, v, la, li, r, h0 = _tiled_inputs(128, 129)
    rs = np.random.RandomState(12)
    dy = torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
    dhf = torch.from_numpy((rs.randn(*h0.shape) * 0.3).astype(np.float32))
    y, h, hin = ms.mamba_scan_plain(q, k, v, la, li, r, h0, Q, save_states=True)
    ref = ms.mamba_scan_backward_plain(q, k, v, la, li, r, hin, h, dy, dhf, Q, want_dh0)
    vp, dyp, dhfp, hinp, hp = (torch.nn.functional.pad(t, (0, pad))
                               for t in (v, dy, dhf, hin, h))
    gexit = torch.zeros(hinp.shape)
    dh0 = torch.zeros(dhfp.shape) if want_dh0 else None
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(vp.shape)
    tiles = [(slice(kd * T, (kd + 1) * T), slice(vd * T, (vd + 1) * T))
             for kd in range(128 // T) for vd in range(192 // T)]  # kd-major: dv tiles in order
    for ks, vs in tiles:
        g_t, d_t = ms.mamba_scan_bwd_state_plain(q[..., ks], la, r, dyp[..., vs],
                                                 dhfp[:, :, ks, vs].contiguous(), Q, want_dh0)
        gexit[:, :, ks, vs] = g_t
        if want_dh0:
            dh0[:, :, ks, vs] = d_t
    for vd in range(192 // T):  # dq and dk: the dv tiles in order, vd = 0, 1, 2
        for ks, vs in tiles[vd::192 // T]:
            dq_t, dk_t, _, _, _ = ms.mamba_scan_bwd_chunk_plain(
                q[..., ks], k[..., ks], vp[..., vs], la, li, r, dyp[..., vs],
                hinp[:, :, ks, vs].contiguous(), gexit[:, :, ks, vs].contiguous(), Q)
            dq[..., ks] += dq_t
            dk[..., ks] += dk_t
    for ks, vs in tiles:  # dv: the dk tiles in order, kd = 0, 1
        dv[..., vs] += ms.mamba_scan_bwd_chunk_plain(
            q[..., ks], k[..., ks], vp[..., vs], la, li, r, dyp[..., vs],
            hinp[:, :, ks, vs].contiguous(), gexit[:, :, ks, vs].contiguous(), Q)[2]
    dli = (k * dk).sum(-1)
    dcum = (q * dq).sum(-1) - dli
    dcum[:, -1, :] += torch.einsum("bhkv,bhkv->bh", dhfp, hp)
    dla = ms.seg_rev_cumsum(dcum, r)
    zero = [dv[..., 129:], gexit[..., 129:]] + ([dh0[..., 129:]] if want_dh0 else [])
    assert all(torch.count_nonzero(t) == 0 for t in zero)
    got = (dq, dk, dv[..., :129], dla, dli, dh0[..., :129] if want_dh0 else None)
    for name, g1, g2 in zip(("dq", "dk", "dv", "dla", "dli", "dh0"), got, ref):
        if name == "dh0" and not want_dh0:
            assert g1 is None and g2 is None
            continue
        err = (g1 - g2).abs().max().item()
        assert err <= 1e-5 * g2.abs().max().item(), (name, err)


def _tiled_stand_ins(monkeypatch, calls, state=None):
    """The card's branch of ``ops.mamba_scan`` on CPU tensors: the tiled
    CUDA entry points replaced by stand-ins that record their call and run
    the plain version (``state`` replaces the state backward's), the
    (64, 64) ones by a refusal."""
    from repro_torch.kernels import mamba_scan as ms

    def record(name, plain):
        def fn(*a, **kw):
            calls.append(name)
            return plain(*a, **kw)
        return fn

    def refuse(*a, **kw):
        raise AssertionError("a (64, 64) kernel ran")

    monkeypatch.setattr(ops, "_use_kernel", lambda t, part: part not in ops._plain)
    monkeypatch.setattr(ms, "mamba_scan_tiled_cuda", record("fwd", ms.mamba_scan_plain))
    monkeypatch.setattr(ms, "mamba_scan_bwd_state_tiled_cuda",
                        state or record("state", ms.mamba_scan_bwd_state_plain))
    monkeypatch.setattr(ms, "mamba_scan_bwd_chunk_tiled_cuda",
                        record("chunk", ms.mamba_scan_bwd_chunk_plain))
    for name in ("mamba_scan_cuda", "mamba_scan_bwd_state_cuda", "mamba_scan_bwd_chunk_cuda"):
        monkeypatch.setattr(ms, name, refuse)


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_gradient_off_64_runs_the_tiled_op_on_the_card(monkeypatch, with_h0):
    """On the card ``ops.mamba_scan`` takes a gradient at any (dk, dv) but
    (64, 64) through ``MambaScanFunction`` on the tiled kernels, wrapped in
    ``tile_padded``: at (64, 65) (dv padded to 128) one tiled forward saving
    the states, one tiled state backward and one tiled chunk backward, no
    (64, 64) kernel and no plain fallback; y, the final state and the
    gradients of q, k, v, the gates (and h0, when given: dh0 wanted) equal
    autograd of the unpadded plain scan (``ops.mamba_scan`` on the CPU)
    within 1e-5 of the largest |value|.  Without a gradient only the tiled
    forward runs.  (The card's branch is taken here on CPU tensors, the
    tiled entry points replaced by recording plain stand-ins.)"""
    q, k, v, la, li, r, h0 = _tiled_inputs(64, 65)
    rs = np.random.RandomState(13)
    w = torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
    w2 = torch.from_numpy((rs.randn(*h0.shape) * 0.3).astype(np.float32))

    def run():
        ts = [t.clone().requires_grad_(True) for t in (q, k, v, la, li, h0)]
        y, h = ops.mamba_scan(*ts[:5], chunk=16, reset=r, h0=ts[5] if with_h0 else None)
        grads = torch.autograd.grad((y * w).sum() + (h * w2).sum(),
                                    ts if with_h0 else ts[:5])
        return [y.detach(), h.detach(), *grads]

    want = run()
    calls = []
    _tiled_stand_ins(monkeypatch, calls)
    got = run()
    assert calls == ["fwd", "state", "chunk"]
    names = ("y", "h", "dq", "dk", "dv", "dla", "dli", "dh0")
    for name, g1, g2 in zip(names, got, want):
        assert g1.shape == g2.shape, name
        err = (g1 - g2).abs().max().item()
        assert err <= 1e-5 * g2.abs().max().item(), (name, err)
    calls.clear()
    with torch.no_grad():
        y, h = ops.mamba_scan(q, k, v, la, li, chunk=16, reset=r)
    assert calls == ["fwd"] and y.shape == v.shape


def test_mamba_scan_tiled_backward_failure_raises(monkeypatch):
    """A tiled backward kernel that fails raises out of the backward:
    nothing falls back to the plain version."""
    def fail(*a, **kw):
        raise RuntimeError("mamba_scan: launch failed")

    calls = []
    _tiled_stand_ins(monkeypatch, calls, state=fail)
    q, k, v, la, li, r, _ = _tiled_inputs(64, 65, h0=False)
    q = q.clone().requires_grad_(True)
    y, _ = ops.mamba_scan(q, k, v, la, li, chunk=16, reset=r)
    with pytest.raises(RuntimeError, match="launch failed"):
        y.sum().backward()
    assert calls == ["fwd"] and q.grad is None


@pytest.mark.parametrize("kernel", ["mamba_scan_fwd", "mamba_scan_bwd_state",
                                    "mamba_scan_bwd_chunk", "mamba_scan_fwd_tiled",
                                    "mamba_scan_bwd_state_tiled", "mamba_scan_bwd_chunk_tiled"])
def test_mamba_scan_smem_bytes_follow_the_cuda_source(kernel):
    """``smem_bytes`` (which chip_smoke holds the card's own report,
    ``occupancy``, to) against the C source: the constants its formula
    assumes are the source's; the six kernels (the tiled ones at a large
    state among them: the (64, 64) bodies on one 64 x 64 tile, kinds 3-5
    of ``mamba_scan_occupancy``) share one layout of 98,464
    bytes at any chunk, so two blocks share an H100 SM (233,472 bytes, 1 KB
    reserved a block), and the state backward's f32 output stages fit in
    the room of the state's three bf16 terms.  Bad arguments are refused
    here, before any build."""
    import re

    from repro_torch.kernels import mamba_scan as ms

    src = (Path(ms.__file__).parent.parent / "csrc" / "mamba_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert {k: consts[k] for k in ("D", "MMA_THREADS", "TR", "DP", "STAGES", "QMAX",
                                   "MAX_ITEMS")} == {
        "D": "64", "MMA_THREADS": "128", "TR": "64", "DP": "D + 8", "STAGES": "3",
        "QMAX": "256", "MAX_ITEMS": "32"}
    assert "TP" not in consts and "SB" not in consts  # the CUDA-core kernel's tiles are gone
    assert ms.TILE == int(consts["D"]) and ms._KINDS[kernel] <= 5
    assert "kind < 0 || kind > 5" in src and kernel + "_kernel" in src
    assert "static_assert(4 * 16 * (D + 8) * sizeof(float) <= kSplitBytes" in src
    assert 4 * 16 * (64 + 8) * 4 <= 3 * 64 * 72 * 2
    got = {Q: ms.smem_bytes(kernel, Q) for Q in (1, 40, 64, 65, 256)}
    assert set(got.values()) == {98464}
    assert 2 * (98464 + 1024) <= 233472 < 3 * (98464 + 1024)
    for bad in ((kernel, 0), (kernel, 257), ("mamba_scan", 64)):
        with pytest.raises(ValueError):
            ms.smem_bytes(*bad)
        with pytest.raises(ValueError):
            ms.occupancy(*bad)


# ---------------------------------------------------------------------------
# The Mamba2 block and the hybrid model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """JAX and port model, backbone, adapters (LoRA 8 / 16, Adapter 4, IA3 on
    the four sites) and one loader batch with resets, on the smoke zamba2."""
    cfg = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
    jt = _tasks(jax_make_task, JaxAdapterConfig)
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_zero_leaves(ad_np, np.random.RandomState(0))
    batch_np = next(JaxLoader(jt, jplan.alignment[0], cfg.vocab_size))
    cfg_t = smoke_config(ARCH).with_overrides(attn_q_block=128)
    pt = _tasks(make_task, AdapterConfig)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(pt)
    return {
        "cfg": cfg, "cfg_t": cfg_t, "jmodel": build_model(cfg), "jmta": jgen.registered.mta,
        "jplan": jplan, "bb_np": bb_np, "ad_np": ad_np, "batch_np": batch_np,
        "model_t": gen.model, "mta_t": reg.mta,
        "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
        "ad_t": adapters_from_numpy(ad_np, reg.mta, "cpu"),
    }


def test_hybrid_trees_have_the_jax_layout(pair):
    cfg_t = pair["cfg_t"]
    n_super, per = cfg_t.num_layers // cfg_t.hybrid_period, cfg_t.hybrid_period - 1
    assert sorted(pair["bb_np"]) == ["blocks", "embed", "final_norm", "shared_attn"]
    assert pair["bb_t"]["blocks"]["mamba"]["mamba"]["w_in"].shape[:2] == (n_super, per)
    assert sorted(pair["ad_t"]) == ["mamba", "shared_attn"]
    # the shared group sits at task-axis depth 0, the Mamba2 group at 2
    assert pair["ad_t"]["shared_attn"]["lora"]["attn_q"]["a"].shape[0] == 2
    assert pair["ad_t"]["mamba"]["lora"]["ssm_in"]["a"].shape[:3] == (n_super, per, 2)
    assert set(pair["ad_t"]["mamba"]["lora"]) == {"ssm_in", "ssm_out"}
    assert set(pair["ad_t"]["shared_attn"]["lora"]) == {"attn_q", "attn_v"}


def _block_case(pair):
    """Layer (0, 0)'s Mamba2 weights and LoRA slices, x and the batch resets."""
    cfg = pair["cfg"]
    reset = pair["batch_np"]["reset"]
    B, S = reset.shape
    x = (np.random.RandomState(3).randn(B, S, cfg.d_model) * 0.5).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0, 0]), pair["bb_np"]["blocks"]["mamba"]["mamba"])
    jad = jax.tree.map(lambda a: jnp.asarray(a[0, 0]), {"lora": pair["ad_np"]["mamba"]["lora"]})
    pp = {k: v[0, 0] for k, v in pair["bb_t"]["blocks"]["mamba"]["mamba"].items()}
    pad = {"lora": {s: {leaf: t[0, 0].clone() for leaf, t in leaves.items()}
                    for s, leaves in pair["ad_t"]["mamba"]["lora"].items()}}
    row_task = pair["jplan"].segments_for(0).row_task
    return x, reset, jp, jad, pp, pad, row_task


def _jax_block(pair, jp, reset, row_task):
    cfg, jmta = pair["cfg"], pair["jmta"]
    factory = jmta.ctx_factory(JaxTaskSegments(tuple(row_task), len(TENANTS)))

    def run(x, ad):
        with jax_adapter_scope(factory(ad)):
            y, _ = jssm.mamba2_apply(jp, x, cfg, reset=jnp.asarray(reset))
        return y
    return run


def _port_block(pair, pp, reset, row_task):
    factory = pair["mta_t"].ctx_factory(TaskSegments(tuple(row_task), len(TENANTS)))

    def run(x, ad):
        with adapter_scope(factory(ad)):
            return ssm.mamba2_apply(pp, x, pair["cfg_t"], reset=torch.from_numpy(reset))
    return run


def test_mamba2_block_matches_jax(pair):
    x, reset, jp, jad, pp, pad, row_task = _block_case(pair)
    assert reset.sum() > x.shape[0]  # resets inside rows, not only at their starts
    w = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jrun = _jax_block(pair, jp, reset, row_task)
    y_j = jax.jit(jrun)(jnp.asarray(x), jad)
    gx_j, gad_j = jax.jit(jax.grad(lambda x_, ad: (jrun(x_, ad) * w).sum(), argnums=(0, 1)))(
        jnp.asarray(x), jad)
    prun = _port_block(pair, pp, reset, row_task)
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {s: {k: t.requires_grad_(True) for k, t in lv.items()}
              for s, lv in pad["lora"].items()}
    y = prun(xt, {"lora": leaves})
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-5)
    for site, lv in leaves.items():
        for leaf, t in lv.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gad_j["lora"][site][leaf]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{site}.{leaf}")


def test_conv_ignores_reset_as_jax_does(pair):
    """Reference quirk, followed: the depthwise conv is not cut at segment
    starts, so a segment's first output moves with the previous segment's
    last input (ROADMAP Queue 3)."""
    x, reset, jp, jad, pp, pad, row_task = _block_case(pair)
    b, t = next((b, t) for b, t in zip(*np.nonzero(reset)) if t > 0)
    x2 = x.copy()
    x2[b, t - 1] += 1.0
    jrun = _jax_block(pair, jp, reset, row_task)
    prun = _port_block(pair, pp, reset, row_task)
    with torch.no_grad():
        y1, y2 = (prun(torch.from_numpy(a), pad).numpy() for a in (x, x2))
    j1, j2 = (np.asarray(jrun(jnp.asarray(a), jad)) for a in (x, x2))
    assert np.abs(y2[b, t] - y1[b, t]).max() > 1e-3
    np.testing.assert_allclose(y2[b, t] - y1[b, t], j2[b, t] - j1[b, t], rtol=1e-3, atol=1e-5)


def test_hybrid_forward_matches_jax(pair):
    cfg, batch = pair["cfg"], pair["batch_np"]
    row_task = pair["jplan"].segments_for(0).row_task
    jf = pair["jmta"].ctx_factory(JaxTaskSegments(tuple(row_task), len(TENANTS)))
    jout = jax.jit(lambda bb, b, ad: pair["jmodel"].forward(
        bb, b, adapters=ad, ctx_factory=jf, return_logits=True))(
        jax.tree.map(jnp.asarray, pair["bb_np"]), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.tree.map(jnp.asarray, pair["ad_np"]))
    pf = pair["mta_t"].ctx_factory(TaskSegments(tuple(row_task), len(TENANTS)))
    with torch.no_grad():
        pout = pair["model_t"].forward(pair["bb_t"],
                                       {k: torch.from_numpy(np.asarray(v)) for k, v in
                                        batch.items()},
                                       adapters=pair["ad_t"], ctx_factory=pf,
                                       return_logits=True)
    vocab = cfg.vocab_size
    np.testing.assert_allclose(pout["logits"].numpy()[..., :vocab],
                               np.asarray(jout["logits"])[..., :vocab], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pout["per_token_loss"].numpy(), np.asarray(jout["per_token_loss"]),
                               rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(pout["logits"].numpy()))


def test_hybrid_refuses_serving_as_jax_does(pair):
    """``prefill`` (the bind's prefill-into-cache) refuses the hybrid family
    in both packages; a hybrid prompt goes through ``decode_step``, which
    serves it (``test_torch_hybrid_decode.py`` holds it to JAX), as does the
    int8 tier."""
    model = pair["model_t"]
    state = model.init_decode_state(1, 16)
    with pytest.raises(NotImplementedError, match="hybrid"):
        model.prefill(pair["bb_t"], {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, state)
    with pytest.raises(NotImplementedError, match="hybrid"):
        pair["jmodel"].prefill(None, {"tokens": jnp.zeros((1, 8), jnp.int32)}, None)
    logits, state = model.decode_step(pair["bb_t"], state, torch.zeros((1, 1), dtype=torch.int32))
    assert logits.shape == (1, 1, model.vocab_padded) and state["pos"].tolist() == [1]
    gen = ModelGenerator(pair["cfg_t"].with_overrides(backbone_dtype="int8"), device="cpu")
    assert gen.init_backbone()["blocks"]["mamba"]["mamba"]["w_in"]["q"].dtype == torch.int8


# ---------------------------------------------------------------------------
# Training: two run_iterations against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
    jt = _tasks(jax_make_task, JaxAdapterConfig)
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_zero_leaves(ad_np, np.random.RandomState(1))
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=LR)

    cfg_t = smoke_config(ARCH).with_overrides(attn_q_block=128)
    pt = _tasks(make_task, AdapterConfig)
    pplan = ExecutionPlanner(cfg_t, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=LR, device="cpu")
    jl = {i: JaxLoader(jt, jplan.alignment[i], cfg.vocab_size) for i in range(len(jplan.htasks))}
    pl = {i: HTaskLoader(pt, pplan.alignment[i], cfg.vocab_size)
          for i in range(len(pplan.htasks))}
    return jeng, jl, peng, pl


def test_run_iteration_matches_jax(engines):
    jeng, jl, peng, pl = engines
    assert len(peng.plan.htasks) == 1
    for it in range(2):
        jm = jeng.run_iteration(jl)
        pm = peng.run_iteration(pl)
        np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4,
                                   err_msg=f"iteration {it}")
        np.testing.assert_allclose(pm.loss, jm.loss, rtol=2e-4)
        assert (pm.tokens, pm.effective_tokens) == (jm.tokens, jm.effective_tokens)
        for name, jtree, ptree in (
                ("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
            jf, pf = _flat(jtree), _flat(ptree)
            assert sorted(jf) == sorted(pf)
            assert {p[0] for p in pf} == {"mamba", "shared_attn"}
            for path in jf:
                np.testing.assert_allclose(pf[path], jf[path],
                                           err_msg=f"iteration {it} {name} {path}", **F32)
        for kind, v in jeng._slot_steps.items():
            np.testing.assert_array_equal(peng._slot_steps[kind].numpy(), np.asarray(v))
    # every group trained: the shared block's leaves moved too
    assert float(peng.reg.opt_state.m["shared_attn"]["lora"]["attn_q"]["a"].abs().max()) > 0


# ---------------------------------------------------------------------------
# Planner, cost model, convert, CLI, configs
# ---------------------------------------------------------------------------


def test_plan_and_eq5_memory_equal_jax_at_full_size():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    jt = [dataclasses.replace(t, micro_batch=8) for t in _tasks(jax_make_task, JaxAdapterConfig)]
    pt = [dataclasses.replace(t, micro_batch=8) for t in _tasks(make_task, AdapterConfig)]
    jplan = JaxPlanner(jcfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    pplan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    js, ps = jplan.summary(), pplan.summary()
    del js["planning_seconds"], ps["planning_seconds"]
    assert ps == js
    fields = ("task_ids", "rows", "row_len", "tokens", "effective_tokens")
    assert [tuple(getattr(h, f) for f in fields) for h in pplan.htasks] == \
        [tuple(getattr(h, f) for f in fields) for h in jplan.htasks]
    jcm = jax_cost_model.CostModel(jcfg, jt, JaxParallelism())
    pcm = CostModel(cfg, pt, ParallelismSpec(), hw=HardwareProfile(**JAX_HW))
    assert pcm.stage_memory(pplan.htasks) == jcm.stage_memory(jplan.htasks)
    assert pcm.stage_latency(pplan.htasks[0]) == pytest.approx(
        jcm.stage_latency(jplan.htasks[0]), rel=1e-12)


def test_convert_hybrid_trees_raises_on_missing_or_unused_leaves(pair):
    cfg_t, bb_np, ad_np = pair["cfg_t"], pair["bb_np"], pair["ad_np"]
    np.testing.assert_array_equal(pair["bb_t"]["embed"]["unembed"].numpy(),
                                  bb_np["embed"]["unembed"])
    np.testing.assert_array_equal(pair["ad_t"]["shared_attn"]["adapter"]["attn_v"]["up"].numpy(),
                                  ad_np["shared_attn"]["adapter"]["attn_v"]["up"])
    bad = jax.tree.map(lambda a: a, bb_np)
    del bad["blocks"]["mamba"]["mamba"]["a_log"]
    with pytest.raises(KeyError, match="missing"):
        backbone_from_numpy(bad, cfg_t, "cpu", torch.float32)
    bad = jax.tree.map(lambda a: a, bb_np)
    bad["shared_attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        backbone_from_numpy(bad, cfg_t, "cpu", torch.float32)
    bad = jax.tree.map(lambda a: a, ad_np)
    del bad["shared_attn"]["ia3"]
    with pytest.raises(KeyError, match="missing"):
        adapters_from_numpy(bad, pair["mta_t"], "cpu")
    bad = jax.tree.map(lambda a: a, ad_np)
    bad["mamba"]["lora"]["attn_q"] = bad["shared_attn"]["lora"]["attn_q"]
    with pytest.raises(KeyError, match="unused"):
        adapters_from_numpy(bad, pair["mta_t"], "cpu")


def test_scaled_config_quirk_gives_no_super_block_below_0_112():
    """Reference quirk, followed: the JAX entry point's ``scaled_config``
    keeps ``hybrid_period`` = 6 while it scales the depth, so at scale 0.1
    (5 layers) a hybrid config has no super-block (ROADMAP Queue 3)."""
    for scale, n_super in ((0.1, 0), (0.25, 2)):
        jc, pc = jax_scaled_config(ARCH, scale), scaled_config(ARCH, scale)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "hybrid_period", "ssm_state", "ssm_chunk"):
            assert getattr(pc, f) == getattr(jc, f), f
        assert pc.num_layers // pc.hybrid_period == n_super
        spec = Model(pc, device="cpu").spec()
        assert spec["blocks"]["mamba"]["mamba"]["w_in"].shape[0] == n_super


def test_cli_trains_zamba2_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--arch", ARCH, "--scale", "0.25", "--steps", "2", "--stages", "1",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == f"done; checkpoints in {tmp_path}"
    assert "arch=zamba2-2.7b d=640 L=13" in lines[0]


def test_smoke_config_matches_jax():
    pc, jc = smoke_config(ARCH), jax_smoke_config(ARCH)
    for f in dataclasses.fields(pc):
        if hasattr(jc, f.name):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
