"""The port's ``ssm`` family (xlstm-1.3b: mLSTM and sLSTM blocks) against the
JAX package, on the CPU, at ``smoke_config("xlstm-1.3b")`` (d = 64, H = 4,
4 blocks: 2 super-blocks of one mLSTM block and one sLSTM block, chunk 16;
the mLSTM's dk = 32, dv = 33).

* ``mlstm_apply`` and ``slstm_apply`` with LoRA slices on their sites: the
  training branch (the mLSTM cut at resets) and the decode branch over
  three steps from a non-zero state, output and state, in f32 within 1e-4
  of the largest |value|.
* ``Model.forward`` with resets and three LoRA tenants on ``ssm_in``,
  ``attn_q`` and ``attn_v`` (rows routed by ``TaskSegments``): logits and
  per-token losses within 1e-4 (rtol and atol, as the hybrid forward's).
* ``Model.decode_step``: eight steps of four rows (three tenants and a free
  row) through ``ctx_factory_from_slots``, logits and the whole state
  against the JAX ``decode_step`` within 2e-4 of the largest |value|, the
  state's layout equal to JAX's, and decode against the forward as
  ``tests/test_decode_parity.py`` holds the JAX package (f32 within 2e-4;
  bf16 softmax within 0.08, argmax agreeing on more than 85%).
* Two ``PEFTEngine.run_iteration``s (LoRA 8 / 16, Adapter 4 and IA3
  tenants on ``ssm_in``, ``attn_q``, ``attn_v``) against the JAX engine:
  per-task losses, adapters and both AdamW moments within rtol = atol =
  1e-5, both adapter groups (``mlstm``, ``slstm``) trained.
* The plan and Eq. 5 at full size, ``convert`` of xlstm trees,
  ``param_count`` and the reference quirks the
  port follows: the formula's 1,011,550,208 parameters against the tree's
  3,530,119,504; an ``ssm_out`` tenant fails on the sLSTM block; the sLSTM
  state runs across packed segments; no prefill, and the service refuses
  the family.

Weights cross through ``repro_torch.convert`` (bf16 widened to f32); the
JAX side runs once per module fixture, on its xla tier.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import ModelGenerator as JaxGenerator
from repro.models import ssm as jssm
from repro.models.transformer import build_model
from repro.peft.hooks import adapter_scope as jax_adapter_scope
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import TaskSegments as JaxTaskSegments
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ModelGenerator, ParallelismSpec, PEFTTask
from repro_torch.models import ssm
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import Model
from repro_torch.peft.hooks import adapter_scope
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import TaskSegments

ARCH = "xlstm-1.3b"
TARGETS = ("ssm_in", "attn_q", "attn_v")
RANKS = (4, 8, 16)
ROW_TASK = (0, 1, 2, 0)  # the forward's rows
SLOT_ROWS = np.asarray([0, 1, 2, -1], np.int32)  # the decode's rows: a free row last
B, S, STEPS = 4, 32, 8  # S = 2 chunks of 16
RESETS = {0: (10,), 1: (16,), 2: (5, 20), 3: ()}  # inside rows, on a chunk start, none


def _tasks(config_cls, targets=TARGETS):
    from repro.core.task import PEFTTask as JaxPEFTTask

    cls = PEFTTask if config_cls is AdapterConfig else JaxPEFTTask
    return [cls(f"t{i}", config_cls("lora", rank=r, targets=targets), (S,), 1)
            for i, r in enumerate(RANKS)]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _fill_b(tree, rs):
    """LoRA's B starts at 0: fill it so every adapter acts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_b(v, rs)
        elif k == "b":
            tree[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _close(got, want, rel, what=""):
    """|got - want| within ``rel`` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _batch():
    rs = np.random.RandomState(1)
    tokens = rs.randint(1, 256, (B, S)).astype(np.int32)
    reset = np.zeros((B, S), np.float32)
    reset[:, 0] = 1.0
    for b, ts in RESETS.items():
        reset[b, list(ts)] = 1.0
    labels = rs.randint(1, 256, (B, S)).astype(np.int32)
    return {"tokens": tokens, "reset": reset, "labels": labels}


def _jax_decode(model, bb, ad, factory, tokens):
    step = jax.jit(lambda p, st, tok, a: model.decode_step(p, st, tok, adapters=a,
                                                           ctx_factory=factory))
    st = model.init_decode_state(None, len(SLOT_ROWS), STEPS, per_row=True)
    logits = []
    for t in range(tokens.shape[1]):
        lg, st = step(bb, st, jnp.asarray(tokens[:, t:t + 1]), ad)
        logits.append(np.asarray(lg[:, 0], np.float32))
    return logits, jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def xl():
    """Both packages' xlstm smoke models on one backbone and one LoRA set (f32
    on both sides), the JAX forward over a batch with resets, and the JAX
    decode trajectory."""
    cfg = jax_smoke_config(ARCH)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(_tasks(JaxAdapterConfig))
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_b(ad_np, np.random.RandomState(0))
    jmta = jgen.registered.mta
    jmodel = build_model(cfg)
    jbb, jad = jax.tree.map(jnp.asarray, bb_np), jax.tree.map(jnp.asarray, ad_np)
    batch = _batch()
    jf = jmta.ctx_factory(JaxTaskSegments(ROW_TASK, len(RANKS)))
    jout = jax.jit(lambda bb, b, ad: jmodel.forward(bb, b, adapters=ad, ctx_factory=jf,
                                                    return_logits=True))(
        jbb, {k: jnp.asarray(v) for k, v in batch.items()}, jad)
    tokens = batch["tokens"][:, :STEPS]
    jslots = {k: jnp.asarray(v) for k, v in jmta.decode_row_slots(SLOT_ROWS).items()}
    jlogits, jstate = _jax_decode(jmodel, jbb, jad, jmta.ctx_factory_from_slots(jslots), tokens)

    cfg_t = smoke_config(ARCH)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(_tasks(AdapterConfig))
    return {"cfg": cfg, "cfg_t": cfg_t, "jmodel": jmodel, "jmta": jmta, "bb_np": bb_np,
            "ad_np": ad_np, "jbb": jbb, "jad": jad, "batch": batch, "jout": jout,
            "tokens": tokens, "jlogits": jlogits, "jstate": jstate,
            "model_t": gen.model, "mta_t": reg.mta,
            "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, reg.mta, "cpu")}


def _tslots(mta):
    return {k: torch.from_numpy(v) for k, v in mta.decode_row_slots(SLOT_ROWS).items()}


# ---------------------------------------------------------------------------
# layouts, configs, convert
# ---------------------------------------------------------------------------


def test_xlstm_trees_have_the_jax_layout(xl):
    cfg = xl["cfg_t"]
    n_super, per = cfg.num_layers // cfg.slstm_period, cfg.slstm_period - 1
    assert sorted(xl["bb_np"]) == ["blocks", "embed", "final_norm"]
    assert sorted(xl["bb_np"]["blocks"]) == ["mlstm", "slstm"]
    assert xl["bb_t"]["blocks"]["mlstm"]["mlstm"]["w_q"].shape == (n_super, per, 128, 128)
    assert xl["bb_t"]["blocks"]["slstm"]["slstm"]["r"].shape == (n_super, 4, 16, 64)
    assert sorted(xl["ad_t"]) == ["mlstm", "slstm"]
    assert set(xl["ad_t"]["mlstm"]["lora"]) == set(TARGETS)
    assert set(xl["ad_t"]["slstm"]["lora"]) == {"ssm_in"}
    # the mLSTM group sits at task-axis depth 2, the sLSTM group at 1
    cap = xl["mta_t"].kind_capacity["lora"]
    assert xl["ad_t"]["mlstm"]["lora"]["attn_q"]["a"].shape[:3] == (n_super, per, cap)
    assert xl["ad_t"]["slstm"]["lora"]["ssm_in"]["a"].shape[:2] == (n_super, cap)
    spec = _flat(Model(cfg, device="cpu").spec())
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: v.shape for k, v in _flat(xl["bb_np"]).items()}


def test_decode_state_has_the_jax_layout(xl):
    st = xl["model_t"].init_decode_state(len(SLOT_ROWS), STEPS, prefix_reserve=2)
    js = xl["jmodel"].init_decode_state(None, len(SLOT_ROWS), STEPS, prefix_reserve=2,
                                        per_row=True)
    got, want = _flat(st), _flat(js)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))
    cfg = xl["cfg_t"]
    assert st["mlstm"]["h"].shape == (2, 1, len(SLOT_ROWS), 4, 32, 33)
    assert "kv" not in st


def test_convert_xlstm_trees_raises_on_missing_or_unused_leaves(xl):
    cfg_t, bb_np, ad_np = xl["cfg_t"], xl["bb_np"], xl["ad_np"]
    np.testing.assert_array_equal(xl["bb_t"]["blocks"]["slstm"]["slstm"]["r"].numpy(),
                                  bb_np["blocks"]["slstm"]["slstm"]["r"])
    np.testing.assert_array_equal(xl["ad_t"]["slstm"]["lora"]["ssm_in"]["b"].numpy(),
                                  ad_np["slstm"]["lora"]["ssm_in"]["b"])
    bad = jax.tree.map(lambda a: a, bb_np)
    del bad["blocks"]["mlstm"]["mlstm"]["gate_bias"]
    with pytest.raises(KeyError, match="missing"):
        backbone_from_numpy(bad, cfg_t, "cpu", torch.float32)
    bad = jax.tree.map(lambda a: a, bb_np)
    bad["blocks"]["slstm"]["slstm"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        backbone_from_numpy(bad, cfg_t, "cpu", torch.float32)
    bad = jax.tree.map(lambda a: a, ad_np)
    del bad["slstm"]["lora"]["ssm_in"]
    with pytest.raises(KeyError, match="missing"):
        adapters_from_numpy(bad, xl["mta_t"], "cpu")
    bad = jax.tree.map(lambda a: a, ad_np)
    bad["slstm"]["lora"]["attn_q"] = bad["mlstm"]["lora"]["attn_q"]
    with pytest.raises(KeyError, match="unused"):
        adapters_from_numpy(bad, xl["mta_t"], "cpu")


def _leaf_count(spec, is_leaf):
    return sum(int(np.prod(v.shape)) for v in jax.tree.leaves(spec, is_leaf=is_leaf))


def test_param_count_is_the_formula_not_the_tree():
    """Reference quirk, followed: ``param_count`` of the ``ssm`` family is
    the formula's attention and norms per block (1,011,550,208 on
    xlstm-1.3b), while the tree holds 3,530,119,504 values (the mLSTM
    blocks 3,172,528,464, the sLSTM blocks 151,019,520): both packages."""
    from repro.models.layers import ParamSpec as JaxParamSpec

    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 1_011_550_208
    port = _leaf_count(Model(cfg, device="cpu").spec(), lambda x: isinstance(x, ParamSpec))
    jspec = build_model(jcfg).spec()
    assert port == _leaf_count(jspec, lambda x: isinstance(x, JaxParamSpec)) == 3_530_119_504
    blocks = Model(cfg, device="cpu").spec()["blocks"]
    assert _leaf_count(blocks["mlstm"], lambda x: isinstance(x, ParamSpec)) == 3_172_528_464
    assert _leaf_count(blocks["slstm"], lambda x: isinstance(x, ParamSpec)) == 151_019_520


def test_plan_and_eq5_memory_equal_jax_at_full_size():
    """``ExecutionPlanner`` and the cost model build xlstm-1.3b's plan as
    the JAX package does (three LoRA tenants on the three sites, micro
    batch 8): the summary, Eq. 5's stage memory and the stage latency."""
    import dataclasses

    from repro.core import ExecutionPlanner as JaxPlanner
    from repro.core import ParallelismSpec as JaxParallelism
    from repro.core import cost_model as jax_cost_model
    from repro_torch.core import ExecutionPlanner, HardwareProfile
    from repro_torch.core.cost_model import CostModel

    hw = HardwareProfile(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
                         ici_bw=jax_cost_model.ICI_BW)
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jt = [dataclasses.replace(t, micro_batch=8) for t in _tasks(JaxAdapterConfig)]
    pt = [dataclasses.replace(t, micro_batch=8) for t in _tasks(AdapterConfig)]
    jplan = JaxPlanner(jcfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    pplan = ExecutionPlanner(cfg, ParallelismSpec(num_stages=1), hw=hw,
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    js, ps = jplan.summary(), pplan.summary()
    del js["planning_seconds"], ps["planning_seconds"]
    assert ps == js
    jcm = jax_cost_model.CostModel(jcfg, jt, JaxParallelism())
    pcm = CostModel(cfg, pt, ParallelismSpec(), hw=hw)
    assert pcm.stage_memory(pplan.htasks) == jcm.stage_memory(jplan.htasks)
    assert pcm.stage_latency(pplan.htasks[0]) == pytest.approx(
        jcm.stage_latency(jplan.htasks[0]), rel=1e-12)


def test_mlstm_dims_on_the_card_path():
    """xlstm-1.3b's mLSTM hands the scan dk = 1024 and dv = 1025 (the
    normalizer column) at 4 heads, the tiled kernel's shape."""
    cfg = get_config(ARCH)
    d_in, nh, hd = ssm.mlstm_dims(cfg)
    assert (d_in, nh, hd) == (4096, 4, 1024)
    st = ssm.mlstm_init_state(cfg.with_overrides(), 1, "meta")
    assert st["h"].shape == (1, 4, 1024, 1025) and st["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block_slices(xl, group, kind, j=None):
    """Super-block 0's block of ``group`` (its mLSTM block ``j``): JAX and
    port weights and LoRA slices."""
    def sl(a):
        return a[0] if j is None else a[0, j]
    jp = jax.tree.map(lambda a: jnp.asarray(sl(a)), xl["bb_np"]["blocks"][group][kind])
    jad = jax.tree.map(lambda a: jnp.asarray(sl(a)), {"lora": xl["ad_np"][group]["lora"]})
    pp = jax.tree.map(lambda t: sl(t), xl["bb_t"]["blocks"][group][kind])
    pad = {"lora": jax.tree.map(lambda t: sl(t).clone(), xl["ad_t"][group]["lora"])}
    return jp, jad, pp, pad


def _factories(xl):
    jf = xl["jmta"].ctx_factory(JaxTaskSegments(ROW_TASK, len(RANKS)))
    pf = xl["mta_t"].ctx_factory(TaskSegments(ROW_TASK, len(RANKS)))
    return jf, pf


@pytest.mark.parametrize("branch", ["train", "decode"])
def test_mlstm_apply_matches_jax(xl, branch):
    """The training branch over a row with resets, or three decode steps from
    a non-zero state: the block's output and its state, in f32 within 1e-4
    of the largest |value|."""
    cfg, cfg_t = xl["cfg"], xl["cfg_t"]
    jp, jad, pp, pad = _block_slices(xl, "mlstm", "mlstm", 0)
    jf, pf = _factories(xl)
    rs = np.random.RandomState(3)
    if branch == "train":
        x = (rs.randn(B, S, cfg.d_model) * 0.5).astype(np.float32)
        reset = xl["batch"]["reset"]
        with jax_adapter_scope(jf(jad)):
            yj, _ = jssm.mlstm_apply(jp, jnp.asarray(x), cfg, reset=jnp.asarray(reset))
        with torch.no_grad(), adapter_scope(pf(pad)):
            yt = ssm.mlstm_apply(pp, torch.from_numpy(x), cfg_t, reset=torch.from_numpy(reset))
        _close(yt.numpy(), yj, 1e-4, "mlstm train y")
        return
    h0 = (rs.randn(B, 4, 32, 33) * 0.3).astype(np.float32)
    jst = {"h": jnp.asarray(h0)}
    tst = {"h": torch.from_numpy(h0.copy())}
    for step in range(3):
        x = (rs.randn(B, 1, cfg.d_model) * 0.5).astype(np.float32)
        with jax_adapter_scope(jf(jad)):
            yj, jst = jssm.mlstm_apply(jp, jnp.asarray(x), cfg, state=jst)
        with torch.no_grad(), adapter_scope(pf(pad)):
            yt = ssm.mlstm_apply(pp, torch.from_numpy(x), cfg_t, state=tst)
        _close(yt.numpy(), yj, 1e-4, f"mlstm decode y step {step}")
        _close(tst["h"].numpy(), jst["h"], 1e-4, f"mlstm decode h step {step}")


@pytest.mark.parametrize("branch", ["train", "decode"])
def test_slstm_apply_matches_jax(xl, branch):
    """The recurrence over a row from zeros, or three decode steps from a
    non-zero state (c, n, m, h), with LoRA on ssm_in: in f32 within 1e-4."""
    cfg, cfg_t = xl["cfg"], xl["cfg_t"]
    jp, jad, pp, pad = _block_slices(xl, "slstm", "slstm")
    jf, pf = _factories(xl)
    rs = np.random.RandomState(4)
    if branch == "train":
        x = (rs.randn(B, S, cfg.d_model) * 0.5).astype(np.float32)
        with jax_adapter_scope(jf(jad)):
            yj, _ = jssm.slstm_apply(jp, jnp.asarray(x), cfg)
        with torch.no_grad(), adapter_scope(pf(pad)):
            yt = ssm.slstm_apply(pp, torch.from_numpy(x), cfg_t)
        _close(yt.numpy(), yj, 1e-4, "slstm train y")
        return
    init = {k: (rs.randn(B, 4, 16) * 0.3).astype(np.float32) for k in ssm.SLSTM_STATE}
    init["n"] = np.abs(init["n"]) + 0.5
    jst = {k: jnp.asarray(v) for k, v in init.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    for step in range(3):
        x = (rs.randn(B, 1, cfg.d_model) * 0.5).astype(np.float32)
        with jax_adapter_scope(jf(jad)):
            yj, jst = jssm.slstm_apply(jp, jnp.asarray(x), cfg, state=jst)
        with torch.no_grad(), adapter_scope(pf(pad)):
            yt = ssm.slstm_apply(pp, torch.from_numpy(x), cfg_t, state=tst)
        _close(yt.numpy(), yj, 1e-4, f"slstm decode y step {step}")
        for k in ssm.SLSTM_STATE:
            _close(tst[k].numpy(), jst[k], 1e-4, f"slstm decode {k} step {step}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _port_forward(xl, batch, bb=None, ad=None):
    _, pf = _factories(xl)
    with torch.no_grad():
        return xl["model_t"].forward(bb or xl["bb_t"],
                                     {k: torch.from_numpy(v) for k, v in batch.items()},
                                     adapters=ad or xl["ad_t"], ctx_factory=pf,
                                     return_logits=True)


def test_xlstm_forward_matches_jax(xl):
    """Logits and per-token losses over a batch with resets inside rows and
    three LoRA tenants, within 1e-4 (rtol and atol)."""
    pout = _port_forward(xl, xl["batch"])
    vocab = xl["cfg"].vocab_size
    np.testing.assert_allclose(pout["logits"].numpy()[..., :vocab],
                               np.asarray(xl["jout"]["logits"])[..., :vocab],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pout["per_token_loss"].numpy(),
                               np.asarray(xl["jout"]["per_token_loss"]), rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(pout["logits"].numpy()))


def test_slstm_state_runs_across_segments_as_jax_does(xl):
    """Reference quirk, followed: the sLSTM block takes no reset, so a
    packed row's next segment sees its previous one through the sLSTM
    state (the mLSTM scan is cut there).  A token changed before row 0's
    reset at 10 moves the logits after it, in both packages alike."""
    batch2 = {k: v.copy() for k, v in xl["batch"].items()}
    batch2["tokens"][0, 8] = (batch2["tokens"][0, 8] + 7) % 256
    pa, pb = (_port_forward(xl, b)["logits"].numpy() for b in (xl["batch"], batch2))
    jf, _ = _factories(xl)
    jb = jax.jit(lambda bb, b, ad: xl["jmodel"].forward(bb, b, adapters=ad, ctx_factory=jf,
                                                        return_logits=True))(
        xl["jbb"], {k: jnp.asarray(v) for k, v in batch2.items()}, xl["jad"])
    d_port = pb[0, 10:] - pa[0, 10:]
    d_jax = np.asarray(jb["logits"])[0, 10:] - np.asarray(xl["jout"]["logits"])[0, 10:]
    assert np.abs(d_port).max() > 1e-3
    vocab = xl["cfg"].vocab_size
    np.testing.assert_allclose(d_port[..., :vocab], d_jax[..., :vocab], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(pb[1:], pa[1:])  # the other rows do not move


def _port_decode(xl, bb, ad, tokens):
    model = xl["model_t"]
    factory = xl["mta_t"].ctx_factory_from_slots(_tslots(xl["mta_t"]))
    st = model.init_decode_state(len(SLOT_ROWS), STEPS)
    logits = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, st = model.decode_step(bb, st, torch.from_numpy(tokens[:, t:t + 1]),
                                       adapters=ad, ctx_factory=factory)
            logits.append(lg[:, 0])
    return logits, st


def test_decode_step_matches_jax(xl):
    """Eight steps: every step's logits, then the whole state (the mLSTM h
    [n_super, per, B, H, 32, 33], the sLSTM c, n, m, h, pos and lo) within
    2e-4 of the largest |value|."""
    logits, st = _port_decode(xl, xl["bb_t"], xl["ad_t"], xl["tokens"])
    vocab = xl["cfg"].vocab_size
    for t, (got, want) in enumerate(zip(logits, xl["jlogits"])):
        _close(got.numpy()[:, :vocab], want[:, :vocab], 2e-4, f"logits step {t}")
    got, want = _flat(st), _flat(xl["jstate"])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        if w.dtype == np.int32:
            np.testing.assert_array_equal(got[path].numpy(), w, err_msg=str(path))
        else:
            _close(got[path].numpy(), w, 2e-4, str(path))
    assert got[("pos",)].tolist() == [STEPS] * len(SLOT_ROWS)


def test_decode_matches_forward(xl):
    """The decode path reproduces the forward token by token, with the
    tenants' adapters (``tests/test_decode_parity.py``'s check on the JAX
    package): in f32 within 2e-4 of the largest logit; on the bf16
    backbone softmax within 0.08 and argmax agreeing on more than 85%."""
    model = xl["model_t"]
    factory = xl["mta_t"].ctx_factory_from_slots(_tslots(xl["mta_t"]))
    tokens = xl["tokens"]
    vocab = xl["cfg"].vocab_size
    bb16 = jax.tree.map(lambda t: t.to(torch.bfloat16), xl["bb_t"])
    ad16 = jax.tree.map(lambda t: t.to(torch.bfloat16), xl["ad_t"])
    for bb, ad in ((xl["bb_t"], xl["ad_t"]), (bb16, ad16)):
        with torch.no_grad():
            fwd = model.forward(bb, {"tokens": torch.from_numpy(tokens)}, adapters=ad,
                                ctx_factory=factory, return_logits=True)["logits"]
        dec, _ = _port_decode(xl, bb, ad, tokens)
        f = fwd.float().numpy()[..., :vocab]
        d = torch.stack(dec, 1).float().numpy()[..., :vocab]
        if fwd.dtype == torch.float32:
            _close(d, f, 2e-4, "f32 decode vs forward")
        else:
            pf, pd = (torch.softmax(torch.from_numpy(a), -1).numpy() for a in (f, d))
            assert float(np.abs(pf - pd).max()) < 0.08
            assert float(np.mean(f.argmax(-1) == d.argmax(-1))) > 0.85


# ---------------------------------------------------------------------------
# refusals and quirks
# ---------------------------------------------------------------------------


def test_ssm_out_tenant_fails_on_the_slstm_block_in_both_packages():
    """Reference quirk, followed: ``ssm_out`` is declared at the mLSTM's
    width (d_in, d) = (128, 64) here, (4096, 2048) at full size, and the
    sLSTM's w_out is (d, d): JAX fails there on the shapes, the port raises
    naming the site."""
    targets = ("ssm_in", "ssm_out")
    cfg = jax_smoke_config(ARCH)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(_tasks(JaxAdapterConfig, targets)[:1])
    jmta = jgen.registered.mta
    jad = jax.tree.map(lambda a: a[0], jgen.registered.adapter_params["slstm"])
    jp = jax.tree.map(lambda a: a[0], jgen.init_backbone()["blocks"]["slstm"]["slstm"])
    x = jnp.ones((1, 4, cfg.d_model), jnp.bfloat16)
    with pytest.raises(ValueError, match="Size of label 'd'"):  # the LoRA A product's shapes
        with jax_adapter_scope(jmta.ctx_factory(JaxTaskSegments((0,), 1))(jad)):
            jssm.slstm_apply(jp, x, cfg)
    gen = ModelGenerator(smoke_config(ARCH), device="cpu")
    reg = gen.register_tasks(_tasks(AdapterConfig, targets)[:1])
    bb = gen.init_backbone()
    assert set(reg.adapter_params["slstm"]["lora"]) == set(targets)
    factory = reg.mta.ctx_factory(TaskSegments((0,), 1))
    with pytest.raises(ValueError, match="ssm_out"):
        with torch.no_grad():
            gen.model.forward(bb, {"tokens": torch.ones((1, 4), dtype=torch.int32)},
                              adapters=reg.adapter_params, ctx_factory=factory)


def test_xlstm_prefill_and_service_keep_refusing(xl):
    """As in the JAX package: ``prefill`` refuses the ssm family (a prompt
    goes through ``decode_step``), and the service rejects its requests."""
    from repro_torch.serve import MuxTuneService, RequestSpec

    model = xl["model_t"]
    with pytest.raises(NotImplementedError, match="decode_step"):
        model.prefill(xl["bb_t"], {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                      model.init_decode_state(1, 8))
    with pytest.raises(NotImplementedError, match="ssm"):
        xl["jmodel"].prefill(None, {"tokens": jnp.zeros((1, 4), jnp.int32)}, None)
    svc = MuxTuneService(xl["cfg_t"], ParallelismSpec(), device="cpu")
    assert svc.submit_request("t", RequestSpec([3, 5], max_new_tokens=2)).reason == \
        "family_unsupported"


# ---------------------------------------------------------------------------
# Training: two run_iterations against the JAX engine
# ---------------------------------------------------------------------------

TRAIN_TENANTS = (("sst2", "lora", 8), ("qa", "lora", 16), ("rte", "adapter", 4),
                 ("sst2", "ia3", 8))
TRAIN_FILLED = ("b", "up", "s")  # LoRA B, Adapter up and IA3 s start at 0


def _train_tasks(make, config_cls):
    return [make(f"task{i}-{ds}", ds, 2, config_cls(kind, rank=rank, targets=TARGETS), seed=i)
            for i, (ds, kind, rank) in enumerate(TRAIN_TENANTS)]


def _fill_zero_leaves(tree, rs):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_zero_leaves(v, rs)
        elif k in TRAIN_FILLED:
            tree[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    """Both packages' PEFTEngine on the smoke xlstm: LoRA 8 / 16, Adapter 4
    and IA3 tenants on ssm_in, attn_q and attn_v, one backbone and adapter
    state (f32, the zero-started leaves filled), one plan, loaders over the
    same synthetic corpora; the JAX engine on its xla tier."""
    from repro.core import ExecutionPlanner as JaxPlanner
    from repro.core import ParallelismSpec as JaxParallelism
    from repro.core import PEFTEngine as JaxEngine
    from repro.core import cost_model as jax_cost_model
    from repro.data import HTaskLoader as JaxLoader
    from repro.data import make_task as jax_make_task
    from repro.train.optimizer import adamw_init as jax_adamw_init
    from repro_torch.core import ExecutionPlanner, HardwareProfile, PEFTEngine
    from repro_torch.data import HTaskLoader, make_task
    from repro_torch.train.optimizer import adamw_init

    cfg = jax_smoke_config(ARCH)
    jt = _train_tasks(jax_make_task, JaxAdapterConfig)
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_zero_leaves(ad_np, np.random.RandomState(1))
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=1e-3)

    cfg_t = smoke_config(ARCH)
    pt = _train_tasks(make_task, AdapterConfig)
    hw = HardwareProfile(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
                         ici_bw=jax_cost_model.ICI_BW)
    pplan = ExecutionPlanner(cfg_t, ParallelismSpec(num_stages=1), hw=hw,
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=1e-3, device="cpu")
    jl = {i: JaxLoader(jt, jplan.alignment[i], cfg.vocab_size) for i in range(len(jplan.htasks))}
    pl = {i: HTaskLoader(pt, pplan.alignment[i], cfg.vocab_size)
          for i in range(len(pplan.htasks))}
    return jeng, jl, peng, pl


def _flat_np(tree):
    return {k: v.detach().float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
            for k, v in _flat(tree).items()}


def test_run_iteration_matches_jax(engines):
    """Two ``PEFTEngine.run_iteration``s (forward, backward through the
    mLSTM's chunked scan and the sLSTM's recurrence, member-masked AdamW)
    against the JAX engine's: per-task losses, adapter parameters and both
    AdamW moments within rtol = atol = 1e-5 after each; both adapter groups
    (``mlstm``, ``slstm``) train."""
    jeng, jl, peng, pl = engines
    start = {k: v.copy() for k, v in _flat_np(peng.reg.adapter_params).items()}
    for it in range(2):
        jm = jeng.run_iteration(jl)
        pm = peng.run_iteration(pl)
        np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=1e-5, atol=1e-5,
                                   err_msg=f"iteration {it}")
        np.testing.assert_allclose(pm.loss, jm.loss, rtol=1e-5, atol=1e-5)
        assert (pm.tokens, pm.effective_tokens) == (jm.tokens, jm.effective_tokens)
        for name, jtree, ptree in (
                ("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
            jf, pf = _flat_np(jtree), _flat_np(ptree)
            assert sorted(jf) == sorted(pf)
            assert {p[0] for p in pf} == {"mlstm", "slstm"}
            for path in jf:
                np.testing.assert_allclose(pf[path], jf[path], rtol=1e-5, atol=1e-5,
                                           err_msg=f"iteration {it} {name} {path}")
    end = _flat_np(peng.reg.adapter_params)
    for group in ("mlstm", "slstm"):
        moved = max(float(np.abs(end[p] - start[p]).max()) for p in end if p[0] == group)
        assert moved > 0, group
