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
SCAN_CASES = ("resets_h0", "no_reset_h0", "no_reset")


def _scan_inputs(case):
    """Inputs drawn as the JAX package's own mamba_scan gradient test draws
    them (``test_kernel_grads.py``: k and the state cotangent scaled by 0.3,
    h0 by 0.5, Mamba-like gates), from a numpy seed."""
    rs = np.random.RandomState(5)

    def softplus(x):
        return np.log1p(np.exp(x))

    q = rs.randn(B_, S_, H_, D_).astype(np.float32)
    k = (rs.randn(B_, S_, H_, D_) * 0.3).astype(np.float32)
    v = rs.randn(B_, S_, H_, D_).astype(np.float32)
    la = (-softplus(rs.randn(B_, S_, H_))).astype(np.float32)
    li = np.log(softplus(rs.randn(B_, S_, H_)) + 1e-3).astype(np.float32)
    h0 = (rs.randn(B_, H_, D_, D_) * 0.5).astype(np.float32)
    w = rs.randn(B_, S_, H_, D_).astype(np.float32)
    w2 = (rs.randn(B_, H_, D_, D_) * 0.3).astype(np.float32)
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
    jarr = [jnp.asarray(a) if a is not None else jnp.zeros((B_, H_, D_, D_), jnp.float32)
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


@pytest.mark.parametrize("case", ["resets_h0", "no_reset_h0"])
def test_mamba_scan_backward_kernels_plain_match_autograd(case):
    """The backward as ``MambaScanFunction`` composes it (the state kernel,
    the chunk kernel, then dla as a segment-bounded reverse cumsum with
    ``<dhf, hfin>`` at the last position), on the kernels' plain versions,
    against autograd of the plain forward; the forward's saved entry states
    against the states the scan passes through."""
    from repro_torch.kernels import mamba_scan as ms

    arrays, reset, w, w2 = _scan_inputs(case)
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
    y1, h1 = ms.mamba_scan_plain(*a[:5], r, a[5], Q_)  # chunk c starts from hin[:, c]
    for c in range(S_ // Q_):
        y2, _ = ms.mamba_scan_plain(*(t[:, c * Q_:(c + 1) * Q_] for t in a[:5]),
                                    None if r is None else r[:, c * Q_:(c + 1) * Q_],
                                    hin[:, c].detach().reshape(B_, H_, D_, D_), Q_)
        np.testing.assert_allclose(y2.numpy(), y1[:, c * Q_:(c + 1) * Q_].numpy(), **F32)


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
    model = pair["model_t"]
    state = {"pos": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="hybrid"):
        model.prefill(pair["bb_t"], {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, state)
    with pytest.raises(NotImplementedError, match="hybrid"):
        model.decode_step(pair["bb_t"], state, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="hybrid"):
        pair["jmodel"].prefill(None, {"tokens": jnp.zeros((1, 8), jnp.int32)}, None)
    gen = ModelGenerator(pair["cfg_t"].with_overrides(backbone_dtype="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        gen.init_backbone()


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


def test_cli_trains_zamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--arch", ARCH, "--scale", "0.25", "--steps", "2", "--stages", "1"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "done"
    assert "arch=zamba2-2.7b d=640 L=13" in lines[0]


def test_smoke_config_matches_jax():
    pc, jc = smoke_config(ARCH), jax_smoke_config(ARCH)
    for f in dataclasses.fields(pc):
        if hasattr(jc, f.name):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
