"""The int8 backbone tier on the port's ``ssm`` family (xlstm-1.3b) against
the JAX package, on the CPU, at ``smoke_config("xlstm-1.3b")`` (d = 64,
4 blocks: 2 super-blocks of one mLSTM block and one sLSTM block), and the
port's ``ArchConfig.param_dtype``.

* The walk: ``q`` / ``scale`` bit for bit with the JAX walk over the same
  bf16 weights: the mLSTM's ``w_up``, ``w_q``, ``w_k``, ``w_v`` and
  ``w_down`` (stacked ``[n_super, per, ...]``) and the sLSTM's ``w_in`` and
  ``w_out`` (``[n_super, ...]``) quantized, their scales keepdims over the
  contracted axis; ``r``, ``w_gates``, ``gate_bias``, the norms and the
  embedding dense.  ``quantized_spec`` against the walk, and
  ``convert.backbone_from_numpy`` of the JAX generator's int8 tree.
* On that int8 tree (its dense leaves widened to f32, on both sides), with
  LoRA 8 / 16, Adapter 4 and IA3 tenants on the mLSTM's ``ssm_in``, q and v
  and the sLSTM's ``ssm_in`` and tokens from numpy seeds: the forward over
  one planned batch with resets (logits within 2e-4 of the largest, the
  per-token losses within rtol = atol = 2e-4); one
  ``PEFTEngine.run_iteration`` (per-task losses, adapter parameters and
  AdamW's m within rtol = atol = 1e-5); four ``decode_step``s of five rows
  (the four tenants and a free row; logits within 2e-4 of the largest).
  The two int8 products differ in the scale's place only (the JAX xla
  tier scales the weight before the sum, the port's plain version the sum
  after it), a few f32 units.
* A reference quirk, followed, at full size from the specs alone: JAX's
  ``quantized_param_count`` clamps to ``param_count``, so Eq. 5 prices the
  int8 backbone at 1,011,550,208 bytes while its tree holds 3,767,546,528.
* ``param_dtype``, inert in both packages, admits bf16 only in the port.

The JAX side runs once, in a module fixture, on its xla tier.
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
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.core.cost_model import CostModel
from repro_torch.data import HTaskLoader, make_task
from repro_torch.models import quantize
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.train.optimizer import adamw_init

ARCH = "xlstm-1.3b"
TARGETS = ("ssm_in", "attn_q", "attn_v")
TENANTS = (("sst2", "lora", 8), ("qa", "lora", 16), ("rte", "adapter", 4), ("sst2", "ia3", 8))
ROW_TASK = np.asarray([0, 1, 2, 3, -1], np.int32)  # the decode's rows: a free row last
STEPS = 4
FILLED = ("b", "up", "s")  # the adapter leaves that start at zero
MLSTM = ("blocks", "mlstm", "mlstm")
SLSTM = ("blocks", "slstm", "slstm")
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)


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


def _close(got, want, rel, what=""):
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


def _streams(vocab):
    """Each task's tokens from a numpy seed (the synthetic corpora seed from
    Python's salted ``hash``)."""
    def stream(seed):
        rs = np.random.RandomState(seed)
        while True:
            yield int(rs.randint(1, vocab))
    return {i: stream(100 + i) for i in range(len(TENANTS))}


@pytest.fixture(scope="module")
def x8():
    """The JAX generator's bf16 and int8 xlstm smoke trees (one key, so the
    same weights), the filled adapters, and the JAX results on the int8
    tree: the forward over the plan's first batch, four decode steps, then
    one ``run_iteration``; the port's engine on the converted tree."""
    cfg = jax_smoke_config(ARCH)
    cfg8 = cfg.with_overrides(backbone_dtype="int8")
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(_tasks(jax_make_task, JaxAdapterConfig))
    bb_np = _np_tree(jgen.init_backbone())
    jt = _tasks(jax_make_task, JaxAdapterConfig)
    jplan = JaxPlanner(cfg8, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen8 = JaxGenerator(cfg8, seed=0)
    jgen8.register_tasks(jt)  # the same key splits as above
    bb8_np = _np_tree(jgen8.init_backbone())
    ad_np = _np_tree(jgen8.registered.adapter_params)
    _fill_zero_leaves(ad_np, np.random.RandomState(0))
    jgen8.backbone_params = jax.tree.map(jnp.asarray, bb8_np)
    jgen8.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen8.registered.opt_state = jax_adamw_init(jgen8.registered.adapter_params)
    jmta = jgen8.registered.mta
    vocab = cfg.vocab_size
    batch = next(JaxLoader(jt, jplan.alignment[0], vocab, streams=_streams(vocab)))
    jf = jmta.ctx_factory(jplan.segments_for(0))
    jout = jax.jit(lambda bb, b, ad: jgen8.model.forward(bb, b, adapters=ad, ctx_factory=jf,
                                                         return_logits=True))(
        jgen8.backbone_params, {k: jnp.asarray(v) for k, v in batch.items()},
        jgen8.registered.adapter_params)
    jout = {k: np.asarray(jout[k], np.float32) for k in ("logits", "per_token_loss")}

    jmodel = build_model(cfg8)
    tokens = np.random.RandomState(1).randint(1, vocab, (len(ROW_TASK), STEPS)).astype(np.int32)
    jslots = {k: jnp.asarray(v) for k, v in jmta.decode_row_slots(ROW_TASK).items()}
    step = jax.jit(lambda p, st, tok, a: jmodel.decode_step(
        p, st, tok, adapters=a, ctx_factory=jmta.ctx_factory_from_slots(jslots)))
    st = jmodel.init_decode_state(None, len(ROW_TASK), STEPS, per_row=True)
    jlogits = []
    for t in range(STEPS):
        lg, st = step(jgen8.backbone_params, st, jnp.asarray(tokens[:, t:t + 1]),
                      jgen8.registered.adapter_params)
        jlogits.append(np.asarray(lg[:, 0], np.float32))

    jeng = JaxEngine(jgen8, jplan, lr=1e-3)
    jl = {i: JaxLoader(jt, jplan.alignment[i], vocab, streams=_streams(vocab))
          for i in range(len(jplan.htasks))}
    jm = jeng.run_iteration(jl)
    jtrain = {"loss": np.asarray(jm.per_task_loss),
              "params": _flat(_np_tree(jeng.reg.adapter_params)),
              "m": _flat(_np_tree(jeng.reg.opt_state.m))}

    cfg8_t = smoke_config(ARCH).with_overrides(backbone_dtype="int8")
    pt = _tasks(make_task, AdapterConfig)
    pplan = ExecutionPlanner(cfg8_t, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg8_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb8_np, cfg8_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    return {"cfg8_t": cfg8_t, "bb_np": bb_np, "bb8_np": bb8_np, "ad_np": ad_np,
            "batch": batch, "segments": jplan.segments_for(0), "jout": jout,
            "tokens": tokens, "jlogits": jlogits, "jtrain": jtrain, "gen": gen,
            "mta": reg.mta, "peng": PEFTEngine(gen, pplan, lr=1e-3, device="cpu"),
            "pplan": pplan, "pt": pt}


# ---------------------------------------------------------------------------
# the walk, the spec, the conversion
# ---------------------------------------------------------------------------


def test_xlstm_int8_walk_matches_jax(x8):
    """The port's walk over the JAX generator's bf16 weights gives the JAX
    walk's nodes bit for bit: the seven BaseOp leaves quantize (the mLSTM's
    keep both stack axes in q and scale, the sLSTM's its one), everything
    else stays dense and equal."""
    cfg8 = x8["cfg8_t"]
    n_super, per = cfg8.num_layers // cfg8.slstm_period, cfg8.slstm_period - 1
    bf16 = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), x8["bb_np"])
    got = _flat(quantize.quantize_backbone(bf16, cfg8), numpy=False)
    want = _flat(x8["bb8_np"])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy() if path[-1] in ("q", "scale") else got[path].float().numpy()
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    quantized = {p[:-1] for p in got if p[-1] == "q"}
    assert quantized == {*((*MLSTM, w) for w in ("w_up", "w_q", "w_k", "w_v", "w_down")),
                         (*SLSTM, "w_in"), (*SLSTM, "w_out")}
    for w in ("w_up", "w_q", "w_k", "w_v", "w_down"):
        q = got[(*MLSTM, w, "q")]
        assert q.dtype == torch.int8 and q.shape[:2] == (n_super, per)
        assert got[(*MLSTM, w, "scale")].shape == (n_super, per, 1, q.shape[-1])
    for w in ("w_in", "w_out"):
        q = got[(*SLSTM, w, "q")]
        assert got[(*SLSTM, w, "scale")].shape == (n_super, 1, q.shape[-1])
    dense = {p for p in got if p[-1] not in ("q", "scale")}
    assert dense == {("embed", "tok"), ("embed", "unembed"), ("final_norm", "w"),
                     ("blocks", "mlstm", "ln", "w"), ("blocks", "slstm", "ln", "w"),
                     *((*MLSTM, w) for w in ("w_gates", "gate_bias", "norm")),
                     (*SLSTM, "r"), (*SLSTM, "norm")}
    assert all(got[p].dtype == torch.bfloat16 for p in dense)


def test_xlstm_quantized_spec_matches_the_walk(x8):
    """``quantized_spec`` of the model's spec: every leaf of the walk's
    tree, with its shape and type."""
    cfg8 = x8["cfg8_t"]
    bf16 = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), x8["bb_np"])
    got = _flat(quantize.quantize_backbone(bf16, cfg8), numpy=False)
    spec = _flat(quantize.quantized_spec(Model(cfg8, device="cpu").spec()), numpy=False)
    assert sorted(spec) == sorted(got)
    for path, ps in spec.items():
        assert tuple(ps.shape) == tuple(got[path].shape), path
        assert (ps.dtype or torch.bfloat16) == got[path].dtype, path


def test_xlstm_int8_convert_matches_jax(x8):
    """``backbone_from_numpy`` of the JAX generator's int8 tree: the int8
    ``q`` and f32 ``scale`` keep their types and bits, the dense leaves
    their values."""
    conv = _flat(backbone_from_numpy(x8["bb8_np"], x8["cfg8_t"], "cpu", torch.float32),
                 numpy=False)
    want = _flat(x8["bb8_np"])
    assert sorted(conv) == sorted(want)
    for path, w in want.items():
        assert conv[path].dtype == (torch.int8 if path[-1] == "q" else torch.float32), path
        np.testing.assert_array_equal(conv[path].numpy(), w, err_msg=str(path))


# ---------------------------------------------------------------------------
# the forward, run_iteration and decode on the int8 tree
# ---------------------------------------------------------------------------


def test_xlstm_int8_forward_matches_jax(x8):
    """The forward over the plan's first batch (packed rows with resets)
    with the four tenants: logits within 2e-4 of the largest, per-token
    losses within rtol = atol = 2e-4."""
    bb = backbone_from_numpy(x8["bb8_np"], x8["cfg8_t"], "cpu", torch.float32)
    ad = adapters_from_numpy(x8["ad_np"], x8["mta"], "cpu")
    pf = x8["mta"].ctx_factory(x8["segments"])
    assert x8["batch"]["reset"][:, 1:].any()  # a row holds more than one segment
    with torch.no_grad():
        pout = x8["gen"].model.forward(bb, {k: torch.from_numpy(np.asarray(v))
                                            for k, v in x8["batch"].items()},
                                       adapters=ad, ctx_factory=pf, return_logits=True)
    vocab = x8["cfg8_t"].vocab_size
    _close(pout["logits"].numpy()[..., :vocab], x8["jout"]["logits"][..., :vocab], 2e-4,
           "int8 forward logits")
    np.testing.assert_allclose(pout["per_token_loss"].numpy(), x8["jout"]["per_token_loss"],
                               rtol=2e-4, atol=2e-4)


def test_xlstm_int8_run_iteration_matches_jax(x8):
    """One ``run_iteration`` (forward, backward through the int8 products'
    dx, the mLSTM's chunked scan and the sLSTM's recurrence, AdamW):
    per-task losses, adapter parameters and AdamW's m within rtol = atol =
    1e-5; both adapter groups move."""
    peng, vocab = x8["peng"], x8["cfg8_t"].vocab_size
    start = {k: v.copy() for k, v in _flat(peng.reg.adapter_params).items()}
    pl = {i: HTaskLoader(x8["pt"], x8["pplan"].alignment[i], vocab, streams=_streams(vocab))
          for i in range(len(x8["pplan"].htasks))}
    pm = peng.run_iteration(pl)
    jt = x8["jtrain"]
    np.testing.assert_allclose(pm.per_task_loss, jt["loss"], rtol=1e-5, atol=1e-5)
    for name, ptree in (("params", peng.reg.adapter_params), ("m", peng.reg.opt_state.m)):
        pf = _flat(ptree)
        assert sorted(pf) == sorted(jt[name])
        for path, w in jt[name].items():
            np.testing.assert_allclose(pf[path], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {path}")
    end = _flat(peng.reg.adapter_params)
    for group in ("mlstm", "slstm"):
        assert max(float(np.abs(end[p] - start[p]).max()) for p in end if p[0] == group) > 0
    assert x8["gen"].backbone_params["blocks"]["mlstm"]["mlstm"]["w_q"]["q"].dtype == torch.int8


def test_xlstm_int8_decode_matches_jax(x8):
    """Four decode steps of five rows (the four tenants, a free row) on the
    int8 tree: every step's logits within 2e-4 of the largest."""
    cfg8 = x8["cfg8_t"]
    model = Model(cfg8, device="cpu")
    bb = backbone_from_numpy(x8["bb8_np"], cfg8, "cpu", torch.float32)
    ad = adapters_from_numpy(x8["ad_np"], x8["mta"], "cpu")
    slots = {k: torch.from_numpy(v) for k, v in x8["mta"].decode_row_slots(ROW_TASK).items()}
    factory = x8["mta"].ctx_factory_from_slots(slots)
    st = model.init_decode_state(len(ROW_TASK), STEPS)
    vocab = cfg8.vocab_size
    with torch.no_grad():
        for t in range(STEPS):
            lg, st = model.decode_step(bb, st, torch.from_numpy(x8["tokens"][:, t:t + 1]),
                                       adapters=ad, ctx_factory=factory)
            _close(lg[:, 0].numpy()[:, :vocab], x8["jlogits"][t][:, :vocab], 2e-4,
                   f"int8 decode logits step {t}")


# ---------------------------------------------------------------------------
# Eq. 5 at full size, param_dtype
# ---------------------------------------------------------------------------


def _spec_bytes(spec):
    total = 0
    for ps in _flat(spec, numpy=False).values():
        dtype = ps.dtype or torch.bfloat16
        total += int(np.prod(ps.shape)) * torch.empty((), dtype=dtype).element_size()
    return total


def test_xlstm_quantized_param_count_is_the_jax_clamp():
    """Reference quirk, followed: JAX's ``quantized_param_count`` counts the
    BaseOp sites of every block (3,623,878,656 values at full size) and
    clamps to ``param_count``'s formula, so Eq. 5 prices xlstm-1.3b's int8
    backbone at 1,011,550,208 bytes, while the int8 tree holds
    3,767,546,528 (3,296,722,944 int8 values, the f32 scales and the bf16
    leaves): 3.7x.  Both packages, from the specs alone."""
    from repro_torch.peft.methods import base_op_dims

    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert quantize.quantized_param_count(cfg) == jquant.quantized_param_count(jcfg)
    full = get_config(ARCH)
    unclamped = sum(a * b for a, b in base_op_dims(full).values()) * full.num_layers
    assert unclamped == 3_623_878_656 > full.param_count()
    assert quantize.quantized_param_count(full) == full.param_count() == 1_011_550_208
    cfg8, jcfg8 = (c.with_overrides(backbone_dtype="int8") for c in (full, jax_get_config(ARCH)))
    eq5 = CostModel(cfg8, [], ParallelismSpec(), hw=HardwareProfile(**JAX_HW)).stage_memory([])
    assert eq5 == jax_cost_model.CostModel(jcfg8, [], JaxParallelism()).stage_memory([])
    assert eq5 == 1_011_550_208
    spec8 = quantize.quantized_spec(Model(cfg8, device="cpu").spec())
    held = _spec_bytes(spec8)
    assert held == 3_767_546_528
    q_values = sum(int(np.prod(ps.shape)) for p, ps in _flat(spec8, numpy=False).items()
                   if p[-1] == "q")
    assert q_values == 3_296_722_944
    assert _spec_bytes(Model(full, device="cpu").spec()) == 7_060_239_008


def test_param_dtype_admits_bf16_only():
    """``param_dtype`` is read in neither package (the backbone's parameters
    are bf16 whatever it says), so the port refuses any other value instead
    of ignoring it.  Its equality with JAX's on every registered config is
    ``test_torch_vlm.py::test_config_fields_and_param_count_equal_jax``'s."""
    cfg = smoke_config(ARCH)
    assert cfg.param_dtype == "bfloat16"
    assert cfg.with_overrides(param_dtype="bfloat16") == cfg
    with pytest.raises(ValueError, match="param_dtype 'float32'"):
        cfg.with_overrides(param_dtype="float32")
