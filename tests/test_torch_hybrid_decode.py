"""The port's hybrid decode and the int8 tier on the hybrid family
(zamba2-2.7b) against the JAX package, on the CPU, at
``smoke_config("zamba2-2.7b")`` (4 layers: 2 super-blocks of one Mamba2
block and the shared attention+MLP block).

* ``gla_decode_step`` and ``mamba2_apply``'s state branch over several
  steps (the recurrent state and the rolling conv window included), in f32
  within 2e-4 of the largest |value| and in bf16 within 2 bf16 units.
* ``Model.decode_step``: 8 steps of five rows (LoRA 8 / 16, Adapter and IA3
  tenants on ``ssm_in``, ``ssm_out``, ``attn_q``, ``attn_v`` and one free
  row) through a ctx factory over per-row slots, logits and the whole
  state against the JAX ``decode_step``; decode against the training
  forward, as ``tests/test_decode_parity.py`` holds the JAX package.
* The int8 walk: ``q`` / ``scale`` bit for bit with the JAX walk, on the
  stacked Mamba2 leaves ``[n_super, per, ...]`` and the shared block's
  unstacked ones, the rest dense; ``quantized_spec`` and
  ``quantized_param_count`` (JAX's clamp).  On the int8 backbone (the JAX
  generator's quantized tree, other leaves widened to f32): the forward,
  one ``run_iteration`` and decode steps against the JAX package.

Weights cross through ``repro_torch.convert`` (bf16 widened to f32); the
JAX side runs once per module fixture.
"""
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
from repro.models import quantize as jquant
from repro.models import ssm as jssm
from repro.peft.hooks import adapter_scope as jax_adapter_scope
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.data import HTaskLoader, make_task
from repro_torch.models import quantize, ssm
from repro_torch.models.transformer import Model
from repro_torch.peft.hooks import adapter_scope
from repro_torch.peft.methods import AdapterConfig
from repro_torch.train.optimizer import adamw_init

ARCH = "zamba2-2.7b"
TARGETS = ("ssm_in", "ssm_out", "attn_q", "attn_v")
TENANTS = (("sst2", "lora", 8), ("qa", "lora", 16), ("rte", "adapter", 4), ("sst2", "ia3", 8))
ROW_TASK = np.asarray([0, 1, 2, 3, -1], np.int32)  # one row per tenant and a free row
STEPS, MAX_LEN = 8, 12
FILLED = ("b", "up", "s")  # the adapter leaves that start at zero
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)


def _bf16_units(n, want):
    """``n`` bf16 units in the last place of the largest |want|, as a share
    of it (for ``_close``)."""
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7) / top


def _np_tree(tree):
    """A JAX tree as numpy: int8 leaves as they are, the rest widened to f32."""
    return jax.tree.map(lambda a: np.asarray(a) if a.dtype == jnp.int8
                        else np.asarray(a, np.float32), tree)


def _flat(tree, prefix=(), numpy=True):
    """{path: leaf} of a nested dict of numpy or torch leaves, as numpy (bf16
    widened to f32) unless ``numpy`` is False."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,), numpy))
        elif not numpy:
            out[prefix + (k,)] = v
        elif torch.is_tensor(v):
            v = v.detach()
            out[prefix + (k,)] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _close(got, want, rel=2e-4, what=""):
    """|got - want| within ``rel`` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _fill_zero_leaves(tree, rs):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_zero_leaves(v, rs)
        elif k in FILLED:
            tree[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)


def _tasks(make, config_cls):
    return [make(f"task{i}-{ds}", ds, 2, config_cls(kind, rank=rank, targets=TARGETS), seed=i)
            for i, (ds, kind, rank) in enumerate(TENANTS)]


def _jslots(mta):
    return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(ROW_TASK).items()}


def _tslots(mta):
    return {k: torch.from_numpy(v) for k, v in mta.decode_row_slots(ROW_TASK).items()}


def _jax_decode(model, bb, ad, factory, tokens):
    """Logits of each step and the final state of the JAX ``decode_step``
    (per-row layout, f32 caches)."""
    step = jax.jit(lambda p, st, tok, a: model.decode_step(p, st, tok, adapters=a,
                                                           ctx_factory=factory))
    st = model.init_decode_state(None, len(ROW_TASK), MAX_LEN, cache_dtype=jnp.float32,
                                 per_row=True)
    logits = []
    for t in range(tokens.shape[1]):
        lg, st = step(bb, st, jnp.asarray(tokens[:, t:t + 1]), ad)
        logits.append(np.asarray(lg[:, 0], np.float32))
    return logits, jax.tree.map(np.asarray, st)


def _port_decode(model, bb, ad, factory, tokens):
    st = model.init_decode_state(len(ROW_TASK), MAX_LEN, cache_dtype=torch.float32)
    logits = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, st = model.decode_step(bb, st, torch.from_numpy(tokens[:, t:t + 1]),
                                       adapters=ad, ctx_factory=factory)
            logits.append(lg[:, 0].float().numpy())
    return logits, st


@pytest.fixture(scope="module")
def zam():
    """Both packages' zamba2 smoke models on one backbone and one adapter
    set (bf16 values widened to f32 on the port's side; the JAX side as its
    generator made them), the JAX decode trajectory, and the JAX int8 tree."""
    cfg = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(_tasks(jax_make_task, JaxAdapterConfig))
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_zero_leaves(ad_np, np.random.RandomState(0))
    jmta = jgen.registered.mta
    tokens = np.random.RandomState(1).randint(1, cfg.vocab_size, (len(ROW_TASK), STEPS))
    tokens = tokens.astype(np.int32)
    jbb, jad = jax.tree.map(jnp.asarray, bb_np), jax.tree.map(jnp.asarray, ad_np)
    jfactory = jmta.ctx_factory_from_slots(_jslots(jmta))
    jlogits, jstate = _jax_decode(jgen.model, jbb, jad, jfactory, tokens)

    cfg_t = smoke_config(ARCH).with_overrides(attn_q_block=128)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(_tasks(make_task, AdapterConfig))
    jgen8 = JaxGenerator(cfg.with_overrides(backbone_dtype="int8"), seed=0)
    jgen8.register_tasks(_tasks(jax_make_task, JaxAdapterConfig))  # the same key splits
    return {"cfg": cfg, "cfg_t": cfg_t, "jmodel": jgen.model, "jmta": jmta, "bb_np": bb_np,
            "ad_np": ad_np, "tokens": tokens, "jbb": jbb, "jad": jad, "jfactory": jfactory,
            "jlogits": jlogits, "jstate": jstate, "model_t": gen.model, "mta_t": reg.mta,
            "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, reg.mta, "cpu"),
            "jbb8_np": _np_tree(jgen8.init_backbone())}


# ---------------------------------------------------------------------------
# the Mamba2 decode branch
# ---------------------------------------------------------------------------


def test_gla_decode_step_matches_jax():
    """Three chained steps from a non-zero state: y in q's type and the f32
    state, against the JAX step, f32 and bf16 inputs."""
    rs = np.random.RandomState(2)
    B, H, dk, dv = 3, 4, 8, 16
    h_np = (rs.randn(B, H, dk, dv) * 0.5).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        hj, ht = jnp.asarray(h_np), torch.from_numpy(h_np)
        for step in range(3):
            q, k = (rs.randn(B, 1, H, dk).astype(np.float32) for _ in range(2))
            v = rs.randn(B, 1, H, dv).astype(np.float32)
            la = -np.log1p(np.exp(rs.randn(B, 1, H))).astype(np.float32)
            li = rs.randn(B, 1, H).astype(np.float32) * 0.3
            jargs = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(la),
                                                                 jnp.asarray(li)]
            yj, hj = jssm.gla_decode_step(*jargs, hj)
            targs = [torch.from_numpy(np.array(a, np.float32)) for a in jargs]
            tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
            yt, ht = ssm.gla_decode_step(*(t.to(tdt) for t in targs[:3]), *targs[3:], ht)
            assert yt.dtype == tdt and ht.dtype == torch.float32
            tol = 2e-4 if dtype == jnp.float32 else _bf16_units(2, yj)
            _close(yt.float().numpy(), yj, tol, f"y {dtype} step {step}")
            _close(ht.numpy(), hj, 2e-4, f"h {dtype} step {step}")


def _block_state_run(s, dtype):
    """Five decode steps of Mamba2 block (0, 0) with its LoRA / Adapter /
    IA3 slices through both packages' state branch, in ``dtype``."""
    cfg, cfg_t = s["cfg"], s["cfg_t"]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    rs = np.random.RandomState(4)
    xs = (rs.randn(5, len(ROW_TASK), 1, cfg.d_model) * 0.5).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0, 0], jdt), s["bb_np"]["blocks"]["mamba"]["mamba"])
    jad = jax.tree.map(lambda a: jnp.asarray(a[0, 0], jdt), s["ad_np"]["mamba"])
    pp = {k: v[0, 0].to(tdt) for k, v in s["bb_t"]["blocks"]["mamba"]["mamba"].items()}
    pad = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(tdt),
                       jax.tree.map(np.asarray, jad))
    jf = s["jmta"].ctx_factory_from_slots(_jslots(s["jmta"]))
    tf = s["mta_t"].ctx_factory_from_slots(_tslots(s["mta_t"]))
    jstep = jax.jit(lambda x, st: _jax_block(jp, x, st, cfg, jf, jad))
    jst = jssm.mamba2_init_state(cfg, len(ROW_TASK))
    tst = ssm.mamba2_init_state(cfg_t, len(ROW_TASK), "cpu")
    # an f32 run widens the bf16 window first, as Model.decode_step does
    tst["conv"] = tst["conv"].to(torch.promote_types(tst["conv"].dtype, tdt))
    out = []
    for x in xs:
        yj, jst = jstep(jnp.asarray(x, jdt), jst)
        with torch.no_grad(), adapter_scope(tf(pad)):
            yt = ssm.mamba2_apply(pp, torch.from_numpy(x).to(tdt), cfg_t, state=tst)
        out.append((yj, jst, yt, {k: v.clone() for k, v in tst.items()}))
    return out


def _jax_block(jp, x, st, cfg, jf, jad):
    with jax_adapter_scope(jf(jad)):
        return jssm.mamba2_apply(jp, x, cfg, state=st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_state_branch_matches_jax(zam, dtype):
    """The block's output, recurrent state and conv window at every step
    (the window rolls past its three rows by step four).  In bf16 the JAX
    window stays bf16 and so does the port's; in f32 the JAX concatenation
    widens the bf16 zero window, and the port's is widened before the first
    step, as Model.decode_step widens it."""
    f32 = dtype == "float32"
    for i, (yj, jst, yt, tst) in enumerate(_block_state_run(zam, dtype)):
        assert yt.dtype == (torch.float32 if f32 else torch.bfloat16)
        for what, got, want in (("y", yt, yj), ("h", tst["h"], jst["h"]),
                                ("conv", tst["conv"], jst["conv"])):
            _close(got.float().numpy(), want, 2e-4 if f32 else _bf16_units(2, want),
                   f"{what} step {i}")
        assert str(tst["conv"].dtype).split(".")[-1] == str(jst["conv"].dtype)


def test_decode_conv_sums_the_taps_at_once():
    """The decode branch's conv: the four taps' products summed by one f32
    ``sum`` (cast back), not the training branch's sequential adds; the
    window keeps the last three inputs, and must be in the block's type."""
    rs = np.random.RandomState(6)
    C = 16
    w = torch.from_numpy(rs.randn(4, C).astype(np.float32)).to(torch.bfloat16)
    state = {"conv": torch.from_numpy(rs.randn(2, 3, C).astype(np.float32)).to(torch.bfloat16)}
    x = torch.from_numpy(rs.randn(2, 1, C).astype(np.float32)).to(torch.bfloat16)
    buf = torch.cat([state["conv"], x], 1)
    want = (buf * w[None]).float().sum(1, keepdim=True).to(torch.bfloat16)
    got = ssm._decode_conv(x, w, state)
    assert torch.equal(got, want)
    assert torch.equal(state["conv"], buf[:, 1:])
    with pytest.raises(ValueError, match="widen the window"):  # an f32 block, a bf16 window
        ssm._decode_conv(x.float(), w.float(), state)


# ---------------------------------------------------------------------------
# Model.decode_step
# ---------------------------------------------------------------------------


def test_decode_state_has_the_jax_layout(zam):
    cfg = zam["cfg_t"]
    n_super, per = cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period - 1
    st = zam["model_t"].init_decode_state(len(ROW_TASK), MAX_LEN, prefix_reserve=2)
    js = zam["jmodel"].init_decode_state(None, len(ROW_TASK), MAX_LEN, prefix_reserve=2,
                                         per_row=True)
    flat = _flat(st, numpy=False)
    for path, leaf in _flat(js, numpy=False).items():
        got = flat[path]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf, np.float32))
    assert st["mamba"]["h"].shape[:2] == (n_super, per)
    assert st["kv"]["k"].shape[0] == n_super
    assert st["mamba"]["conv"].dtype == torch.bfloat16  # whatever cache_dtype is
    assert st["mamba"]["h"].dtype == torch.float32


def test_decode_step_matches_jax(zam):
    """Eight steps: every step's logits, then the whole state (Mamba2 h and
    conv windows, the shared block's caches, pos and lo)."""
    pf = zam["mta_t"].ctx_factory_from_slots(_tslots(zam["mta_t"]))
    logits, st = _port_decode(zam["model_t"], zam["bb_t"], zam["ad_t"], pf, zam["tokens"])
    vocab = zam["cfg"].vocab_size
    for t, (got, want) in enumerate(zip(logits, zam["jlogits"])):
        _close(got[:, :vocab], want[:, :vocab], what=f"logits step {t}")
    jst = _flat(zam["jstate"])
    got = _flat(st)
    assert sorted(got) == sorted(jst)
    for path, want in jst.items():
        assert got[path].shape == want.shape, path
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got[path], want, err_msg=str(path))
        else:
            _close(got[path], want, what=str(path))
    assert got[("pos",)].tolist() == [STEPS] * len(ROW_TASK)


def test_decode_matches_forward(zam):
    """The decode path reproduces the training forward token by token
    (tests/test_decode_parity.py's check on the JAX package), with the
    tenants' adapters: in f32 within 2e-4 of the largest logit, and on the
    bf16 backbone at the JAX test's bounds (softmax within 0.08, argmax
    agreeing on more than 85% of positions)."""
    model, mta = zam["model_t"], zam["mta_t"]
    factory = mta.ctx_factory_from_slots(_tslots(mta))
    tokens = zam["tokens"]
    vocab = zam["cfg"].vocab_size
    bb16 = jax.tree.map(lambda t: t.to(torch.bfloat16), zam["bb_t"])
    ad16 = jax.tree.map(lambda t: t.to(torch.bfloat16), zam["ad_t"])
    for bb, ad in ((zam["bb_t"], zam["ad_t"]), (bb16, ad16)):
        with torch.no_grad():
            fwd = model.forward(bb, {"tokens": torch.from_numpy(tokens)}, adapters=ad,
                                ctx_factory=factory, return_logits=True)["logits"]
        st = model.init_decode_state(len(ROW_TASK), MAX_LEN, cache_dtype=fwd.dtype)
        dec = []
        with torch.no_grad():
            for t in range(STEPS):
                lg, st = model.decode_step(bb, st, torch.from_numpy(tokens[:, t:t + 1]),
                                           adapters=ad, ctx_factory=factory)
                dec.append(lg[:, 0])
        f = fwd.float().numpy()[..., :vocab]
        d = torch.stack(dec, 1).float().numpy()[..., :vocab]
        if fwd.dtype == torch.float32:
            _close(d, f, what="f32 decode vs forward")
        else:
            pf, pd = (torch.softmax(torch.from_numpy(a), -1).numpy() for a in (f, d))
            assert float(np.abs(pf - pd).max()) < 0.08
            assert float(np.mean(f.argmax(-1) == d.argmax(-1))) > 0.85


def test_hybrid_prefill_and_service_keep_refusing(zam):
    """As in the JAX package: ``prefill`` stays dense / MoE only (a hybrid
    prompt goes through ``decode_step``), and the service rejects hybrid
    requests."""
    from repro_torch.serve import MuxTuneService, RequestSpec

    with pytest.raises(NotImplementedError, match="decode_step"):
        zam["model_t"].prefill(zam["bb_t"], {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                               zam["model_t"].init_decode_state(1, 8))
    svc = MuxTuneService(zam["cfg_t"], ParallelismSpec(), device="cpu")
    assert svc.submit_request("t", RequestSpec([3, 5], max_new_tokens=2)).reason == \
        "family_unsupported"


# ---------------------------------------------------------------------------
# the int8 tier on the hybrid family
# ---------------------------------------------------------------------------


def test_hybrid_int8_walk_matches_jax(zam):
    """The port's walk over the JAX generator's bf16 weights gives the JAX
    walk's nodes bit for bit: the stacked Mamba2 projections keep both stack
    axes in q and scale, the shared block's seven BaseOps quantize once,
    conv / dt_bias / a_log / d_skip / the norms and the embedding stay
    dense; ``backbone_from_numpy`` of the JAX tree gives the same nodes."""
    cfg8 = zam["cfg_t"].with_overrides(backbone_dtype="int8")
    bf16 = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), zam["bb_np"])
    got = _flat(quantize.quantize_backbone(bf16, cfg8), numpy=False)
    want = _flat(zam["jbb8_np"])
    assert sorted(got) == sorted(want)
    n_super, per = cfg8.num_layers // cfg8.hybrid_period, cfg8.hybrid_period - 1
    for path, w in want.items():
        g = got[path].float().numpy() if path[-1] not in ("q", "scale") else got[path].numpy()
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    quantized = {p[:-1] for p in got if p[-1] == "q"}
    assert quantized == {("blocks", "mamba", "mamba", "w_in"), ("blocks", "mamba", "mamba", "w_out"),
                         *{("shared_attn", "attn", w) for w in ("w_q", "w_k", "w_v", "w_o")},
                         *{("shared_attn", "mlp", w) for w in ("w_gate", "w_up", "w_down")}}
    w_in = got[("blocks", "mamba", "mamba", "w_in", "scale")]
    assert w_in.shape == (n_super, per, 1, want[("blocks", "mamba", "mamba", "w_in", "q")].shape[-1])
    assert got[("shared_attn", "attn", "w_o", "scale")].shape == (1, 1, cfg8.d_model)
    for leaf in ("conv", "dt_bias", "a_log", "d_skip", "norm"):
        assert got[("blocks", "mamba", "mamba", leaf)].dtype == torch.bfloat16
    spec = _flat(quantize.quantized_spec(Model(cfg8, device="cpu").spec()), numpy=False)
    assert sorted(spec) == sorted(got)
    for path, ps in spec.items():
        assert tuple(ps.shape) == tuple(got[path].shape), path
        assert (ps.dtype or torch.bfloat16) == got[path].dtype, path
    conv = _flat(backbone_from_numpy(zam["jbb8_np"], cfg8, "cpu", torch.float32), numpy=False)
    for path in want:
        if path[-1] in ("q", "scale"):
            assert torch.equal(conv[path], got[path]), path


def test_hybrid_quantized_param_count_is_the_jax_clamp():
    """JAX's ``quantized_param_count`` counts the shared block's and the
    Mamba2 sites in every layer, so on zamba2 it clamps to ``param_count``
    (Eq. 5 then prices the whole backbone at one byte); the port keeps it."""
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert quantize.quantized_param_count(cfg) == jquant.quantized_param_count(jcfg)
    from repro_torch.peft.methods import base_op_dims

    full = get_config(ARCH)
    unclamped = sum(a * b for a, b in base_op_dims(full).values()) * full.num_layers
    assert unclamped > 3 * full.param_count()
    assert quantize.quantized_param_count(full) == full.param_count()
    # Eq. 5's backbone term on the int8 tier: the whole backbone at one byte
    from repro_torch.core.cost_model import CostModel

    cfg8, jcfg8 = (c.with_overrides(backbone_dtype="int8") for c in (full, jax_get_config(ARCH)))
    eq5 = CostModel(cfg8, [], ParallelismSpec(), hw=HardwareProfile(**JAX_HW)).stage_memory([])
    assert eq5 == jax_cost_model.CostModel(jcfg8, [], JaxParallelism()).stage_memory([])
    assert eq5 == full.param_count()


@pytest.fixture(scope="module")
def int8_engines(zam):
    """JAX and port engines on the int8 zamba2 backbone (the JAX generator's
    quantized tree, the other leaves widened to f32) and the filled
    adapters."""
    cfg8 = zam["cfg"].with_overrides(backbone_dtype="int8")
    jt = _tasks(jax_make_task, JaxAdapterConfig)
    jplan = JaxPlanner(cfg8, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg8, seed=0)
    jgen.register_tasks(jt)
    jgen.backbone_params = jax.tree.map(jnp.asarray, zam["jbb8_np"])
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, zam["ad_np"])
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=1e-3)
    cfg8_t = zam["cfg_t"].with_overrides(backbone_dtype="int8")
    pt = _tasks(make_task, AdapterConfig)
    pplan = ExecutionPlanner(cfg8_t, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg8_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(zam["jbb8_np"], cfg8_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(zam["ad_np"], reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=1e-3, device="cpu")
    return {"jgen": jgen, "jeng": jeng, "jplan": jplan, "jt": jt, "gen": gen, "peng": peng,
            "pplan": pplan, "pt": pt}


def test_hybrid_int8_forward_matches_jax(zam, int8_engines):
    e = int8_engines
    batch = next(JaxLoader(e["jt"], e["jplan"].alignment[0], zam["cfg"].vocab_size))
    seg = e["jplan"].segments_for(0)
    jf = e["jgen"].registered.mta.ctx_factory(seg)
    jout = jax.jit(lambda bb, b, ad: e["jgen"].model.forward(
        bb, b, adapters=ad, ctx_factory=jf, return_logits=True))(
        e["jgen"].backbone_params, {k: jnp.asarray(v) for k, v in batch.items()},
        e["jgen"].registered.adapter_params)
    pf = e["peng"].reg.mta.ctx_factory(seg)
    with torch.no_grad():
        pout = e["gen"].model.forward(e["gen"].backbone_params,
                                      {k: torch.from_numpy(np.asarray(v)) for k, v in
                                       batch.items()},
                                      adapters=e["peng"].reg.adapter_params, ctx_factory=pf,
                                      return_logits=True)
    vocab = zam["cfg"].vocab_size
    _close(pout["logits"].numpy()[..., :vocab], np.asarray(jout["logits"])[..., :vocab],
           what="int8 forward logits")
    np.testing.assert_allclose(pout["per_token_loss"].numpy(),
                               np.asarray(jout["per_token_loss"]), rtol=2e-4, atol=2e-4)


def test_hybrid_int8_run_iteration_matches_jax(zam, int8_engines):
    e = int8_engines
    jl = {i: JaxLoader(e["jt"], e["jplan"].alignment[i], zam["cfg"].vocab_size)
          for i in range(len(e["jplan"].htasks))}
    pl = {i: HTaskLoader(e["pt"], e["pplan"].alignment[i], zam["cfg"].vocab_size)
          for i in range(len(e["pplan"].htasks))}
    jm = e["jeng"].run_iteration(jl)
    pm = e["peng"].run_iteration(pl)
    np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4)
    for name, jtree, ptree in (
            ("params", e["jeng"].reg.adapter_params, e["peng"].reg.adapter_params),
            ("m", e["jeng"].reg.opt_state.m, e["peng"].reg.opt_state.m)):
        jf, pf = _flat(jtree), _flat(ptree)
        assert sorted(jf) == sorted(pf)
        for path in jf:
            np.testing.assert_allclose(pf[path], np.asarray(jf[path], np.float32),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{name} {path}")
    assert e["gen"].backbone_params["blocks"]["mamba"]["mamba"]["w_in"]["q"].dtype == torch.int8


def test_hybrid_int8_decode_matches_jax(zam):
    """Decode steps on the int8 backbone against the JAX ``decode_step`` on
    the same quantized tree."""
    cfg8 = zam["cfg"].with_overrides(backbone_dtype="int8")
    cfg8_t = zam["cfg_t"].with_overrides(backbone_dtype="int8")
    tokens = zam["tokens"][:, :4]
    jlogits, _ = _jax_decode(zam["jmodel"].__class__(cfg8), jax.tree.map(jnp.asarray,
                                                                         zam["jbb8_np"]),
                             zam["jad"], zam["jfactory"], tokens)
    model = Model(cfg8_t, device="cpu")
    bb = backbone_from_numpy(zam["jbb8_np"], cfg8_t, "cpu", torch.float32)
    pf = zam["mta_t"].ctx_factory_from_slots(_tslots(zam["mta_t"]))
    logits, st = _port_decode(model, bb, zam["ad_t"], pf, tokens)
    vocab = zam["cfg"].vocab_size
    for t, (got, want) in enumerate(zip(logits, jlogits)):
        _close(got[:, :vocab], want[:, :vocab], what=f"int8 logits step {t}")
    assert bb["shared_attn"]["attn"]["w_q"]["q"].dtype == torch.int8
