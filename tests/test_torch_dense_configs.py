"""The port's two other dense configs against the JAX package, on the CPU:
starcoder2-7b (the plain GELU fc1 / fc2 MLP, q/k/v/o biases) and yi-34b
(llama-architecture GQA at 7 query heads per k/v head).

* starcoder2 at ``smoke_config`` with random non-zero biases (both packages
  initialise them to zeros, which would hide the add and its place): the
  forward's logits; one ``run_iteration`` with LoRA on ``mlp_fc1`` /
  ``mlp_fc2`` and DoRA on ``attn_o`` (DoRA's re-norm reads ``base_out``,
  so it pins the bias added before the adapter's ``apply``); the decode
  pool's batched bind and micro steps (greedy tokens, caches) against the
  JAX engine's steps.
* Attention and its per-row decode at 9 query heads on one k/v head.
* yi-34b at ``smoke_config``: forward and decode.
* ``param_count`` and ``base_op_dims`` of both full configs equal JAX's.
* ``materialize``: a leaf under the sliced-draw threshold draws the bits it
  drew before; above it (the module constant patched small) each slice of
  the leading axis is drawn in turn from the generator, deterministically.

Everything runs in f32 (weights carried across by ``repro_torch.convert``)
and is held within 2e-4 of the largest |value| (losses at rtol 2e-4,
adapter leaves and moments at 1e-5); the JAX side runs on its xla tier.
"""
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
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.methods import base_op_dims as jax_base_op_dims
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.data import HTaskLoader, make_task
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import Model
from repro_torch.peft import hooks
from repro_torch.peft.methods import AdapterConfig, base_op_dims
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import adamw_init

ROOT = Path(__file__).resolve().parent.parent
SC2, YI = "starcoder2-7b", "yi-34b"
SC2_SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_fc1", "mlp_fc2")
FILLED = ("b", "up", "s", "dm")  # the adapter leaves that start at zero
BIASES = ("b_q", "b_k", "b_v", "b_o")
JAX_HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
              ici_bw=jax_cost_model.ICI_BW)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v.detach().float().numpy() if torch.is_tensor(v) \
                else np.asarray(v, np.float32)
    return out


def _close(got, want, rel=2e-4, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _fill_biases(tree, rs):
    """Random non-zero q/k/v/o biases (zeros at init in both packages)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_biases(v, rs)
        elif k in BIASES:
            tree[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)


def _fill_adapters(tree, rs):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_adapters(v, rs)
        elif k in FILLED:
            tree[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)


# ---------------------------------------------------------------------------
# starcoder2: forward, one training iteration, the decode pool
# ---------------------------------------------------------------------------

TRAIN_TENANTS = (("sst2", JaxAdapterConfig, AdapterConfig, "lora", 8, ("mlp_fc1", "mlp_fc2")),
                 ("qa", JaxAdapterConfig, AdapterConfig, "dora", 4, ("attn_o",)))


def _train_tasks(make, which):
    return [make(f"task{i}-{ds}", ds, 2, (jc if which == "jax" else pc)(kind, rank=r,
                                                                         targets=tg), seed=i)
            for i, (ds, jc, pc, kind, r, tg) in enumerate(TRAIN_TENANTS)]


@pytest.fixture(scope="module")
def sc2():
    """JAX and port engines on starcoder2's smoke config with random biases
    and filled adapters, one loader each."""
    cfg = jax_smoke_config(SC2).with_overrides(attn_q_block=128)
    jt = _train_tasks(jax_make_task, "jax")
    jplan = JaxPlanner(cfg, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(cfg, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    _fill_biases(bb_np, np.random.RandomState(0))
    ad_np = _np_tree(jgen.registered.adapter_params)
    _fill_adapters(ad_np, np.random.RandomState(1))
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=1e-3)

    cfg_t = smoke_config(SC2).with_overrides(attn_q_block=128)
    pt = _train_tasks(make_task, "port")
    pplan = ExecutionPlanner(cfg_t, ParallelismSpec(num_stages=1), hw=HardwareProfile(**JAX_HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=1e-3, device="cpu")
    return {"cfg": cfg, "cfg_t": cfg_t, "jt": jt, "pt": pt, "jplan": jplan, "pplan": pplan,
            "jgen": jgen, "gen": gen, "jeng": jeng, "peng": peng, "bb_np": bb_np,
            "ad_np": ad_np}


def test_starcoder2_trees_have_the_jax_layout(sc2):
    layer = sc2["gen"].backbone_params["layers"]
    assert sorted(layer["mlp"]) == ["w_fc1", "w_fc2"]  # no MLP bias, as in the JAX package
    assert {k for k in layer["attn"] if k.startswith("b_")} == set(BIASES)
    assert layer["attn"]["b_q"].shape[1:] == (sc2["cfg_t"].num_heads,
                                              sc2["cfg_t"].resolved_head_dim())
    assert float(layer["attn"]["b_o"].abs().max()) > 0  # filled
    spec = Model(sc2["cfg_t"], device="cpu").spec()["layers"]["attn"]
    assert all(spec[b].init == "zeros" for b in BIASES)
    assert set(sc2["peng"].reg.adapter_params["lora"]) == {"mlp_fc1", "mlp_fc2"}
    assert set(sc2["peng"].reg.adapter_params["dora"]) == {"attn_o"}


def test_starcoder2_forward_matches_jax(sc2):
    batch = next(JaxLoader(sc2["jt"], sc2["jplan"].alignment[0], sc2["cfg"].vocab_size))
    seg = sc2["jplan"].segments_for(0)
    jf = sc2["jgen"].registered.mta.ctx_factory(seg)
    jout = jax.jit(lambda bb, b, ad: sc2["jgen"].model.forward(
        bb, b, adapters=ad, ctx_factory=jf, return_logits=True))(
        sc2["jgen"].backbone_params, {k: jnp.asarray(v) for k, v in batch.items()},
        sc2["jgen"].registered.adapter_params)
    pf = sc2["peng"].reg.mta.ctx_factory(seg)
    with torch.no_grad():
        pout = sc2["gen"].model.forward(sc2["gen"].backbone_params,
                                        {k: torch.from_numpy(np.asarray(v))
                                         for k, v in batch.items()},
                                        adapters=sc2["peng"].reg.adapter_params,
                                        ctx_factory=pf, return_logits=True)
    vocab = sc2["cfg"].vocab_size
    _close(pout["logits"].numpy()[..., :vocab], np.asarray(jout["logits"])[..., :vocab],
           what="logits")
    np.testing.assert_allclose(pout["per_token_loss"].numpy(),
                               np.asarray(jout["per_token_loss"]), rtol=2e-4, atol=2e-4)


def test_starcoder2_run_iteration_matches_jax(sc2):
    """LoRA on fc1 / fc2 and DoRA on o: losses, every adapter leaf and both
    AdamW moments after one iteration."""
    jl = {0: JaxLoader(sc2["jt"], sc2["jplan"].alignment[0], sc2["cfg"].vocab_size, seed=3)}
    pl = {0: HTaskLoader(sc2["pt"], sc2["pplan"].alignment[0], sc2["cfg"].vocab_size, seed=3)}
    jm = sc2["jeng"].run_iteration(jl)
    pm = sc2["peng"].run_iteration(pl)
    np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4)
    for name, jtree, ptree in (
            ("params", sc2["jeng"].reg.adapter_params, sc2["peng"].reg.adapter_params),
            ("m", sc2["jeng"].reg.opt_state.m, sc2["peng"].reg.opt_state.m),
            ("v", sc2["jeng"].reg.opt_state.v, sc2["peng"].reg.opt_state.v)):
        jf, pf = _flat(jtree), _flat(ptree)
        assert sorted(jf) == sorted(pf)
        for path in jf:
            np.testing.assert_allclose(pf[path], jf[path], err_msg=f"{name} {path}", **TOL)


class _Recorder(hooks.AdapterContext):
    """An adapter context that records the ``base_out`` its apply sees."""

    def __init__(self):
        self.seen = {}

    def has(self, name):
        return True

    def apply(self, name, x, base_out, w=None):
        self.seen[name] = base_out.clone()
        return base_out * 2.0


def test_bias_is_added_before_the_adapter_apply():
    """The JAX order (``peft/hooks.py``): the base product, then the bias,
    then the adapter's apply, on a dense and on an int8 weight."""
    from repro_torch.models.quantize import quantize_weight

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 8), generator=g)
    w = torch.randn((8, 5), generator=g)
    b = torch.randn((5,), generator=g)
    for weight, base in ((w, torch.einsum("bsd,df->bsf", x, w)),
                         (quantize_weight(w, (-2,)), None)):
        rec = _Recorder()
        with hooks.adapter_scope(rec):
            out = hooks.apply_base_op("mlp_fc1", x, weight, "bsd,df->bsf", bias=b)
        if base is None:
            base = hooks.apply_base_op("mlp_fc1", x, weight, "bsd,df->bsf")
        assert torch.equal(rec.seen["mlp_fc1"], base + b)
        assert torch.equal(out, (base + b) * 2.0)


POOL_TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))
ROWS, MAX_LEN, CAP, LP = 4, 24, 6, 8
BIND_ROWS = np.asarray([0, 1, 3], np.int32)
BIND_TASKS = np.asarray([2, 0, 1], np.int32)
POOL_TASKS = np.asarray([2, 0, -1, 1], np.int32)
LENGTHS = np.asarray([8, 5, 3], np.int32)
MAX_NEW = np.asarray([6, 3, 5], np.int32)


def test_starcoder2_decode_pool_matches_jax(sc2):
    """Three LoRA tenants on all six sites, the biases random: the batched
    bind and the micro steps give JAX's greedy tokens, counters and caches."""
    cfg, cfg_t, bb_np = sc2["cfg"], sc2["cfg_t"], sc2["bb_np"]
    model = build_model(cfg)
    mta = JaxMultiTaskAdapters(cfg, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=SC2_SITES)
                                     for r, a in POOL_TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(2)
    for site in ad_np["lora"].values():
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)
    tokens = np.zeros((len(LENGTHS), LP), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rs.randint(1, cfg.vocab_size, n)
    jbb, jad = jax.tree.map(jnp.asarray, bb_np), jax.tree.map(jnp.asarray, ad_np)
    scales = {k: jnp.asarray(mta.scales(k)) for k in mta.kind_tasks}

    def jslots(tasks):
        return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(tasks).items()}

    pool = jsteps.init_decode_pool(model, ROWS, MAX_LEN, CAP, cache_dtype=jnp.float32)
    bind = jsteps.build_decode_batched_bind_step(model, mta, MAX_LEN)
    micro = jsteps.build_decode_micro_step(model, mta)
    pool = bind(jbb, jad, pool, jnp.asarray(BIND_ROWS), jnp.asarray(tokens),
                jnp.asarray(LENGTHS), jslots(BIND_TASKS), scales, jnp.asarray(MAX_NEW),
                jsteps.greedy_sampling(len(BIND_ROWS)))
    for _ in range(CAP - 1):
        pool = micro(jbb, jad, pool, jslots(POOL_TASKS), scales)

    model_t = Model(cfg_t, device="cpu")
    mta_t = MultiTaskAdapters(cfg_t, [AdapterConfig("lora", rank=r, alpha=a, targets=SC2_SITES)
                                      for r, a in POOL_TENANTS], device="cpu")
    bb_t = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    ad_t = adapters_from_numpy(ad_np, mta_t, "cpu")
    scales_t = {k: torch.from_numpy(mta_t.scales(k)) for k in mta_t.kind_tasks}

    def tslots(tasks):
        return {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(tasks).items()}

    tpool = steps.init_decode_pool(model_t, ROWS, MAX_LEN, CAP, cache_dtype=torch.float32)
    tbind = steps.build_decode_batched_bind_step(model_t, mta_t, MAX_LEN)
    tpool = tbind(bb_t, ad_t, tpool, torch.from_numpy(BIND_ROWS), torch.from_numpy(tokens),
                  torch.from_numpy(LENGTHS), tslots(BIND_TASKS), scales_t,
                  torch.from_numpy(MAX_NEW), steps.greedy_sampling(3, "cpu"), [])
    tmicro = steps.build_decode_micro_step(model_t, mta_t)
    for _ in range(CAP - 1):
        tpool = tmicro(bb_t, ad_t, tpool, tslots(POOL_TASKS), scales_t, [])
    np.testing.assert_array_equal(tpool["out"].numpy(), np.asarray(pool["out"]))
    for key in ("n_out", "active"):
        np.testing.assert_array_equal(tpool[key].numpy(), np.asarray(pool[key]), err_msg=key)
    np.testing.assert_array_equal(tpool["state"]["pos"].numpy(),
                                  np.asarray(pool["state"]["pos"]))
    assert list(tpool["n_out"].numpy()) == [6, 3, 0, 5]
    for key in ("k", "v"):
        _close(tpool["state"]["kv"][key].numpy(), pool["state"]["kv"][key], what=key)


# ---------------------------------------------------------------------------
# attention at 9 query heads per k/v head; yi-34b
# ---------------------------------------------------------------------------


def test_attention_and_decode_at_nine_heads_per_kv_head():
    """``attention_apply`` over a packed layout (two segments a row) and
    four per-row decode steps at H = 9, Hkv = 1, with random biases."""
    cfg = jax_smoke_config(SC2).with_overrides(num_heads=9, num_kv_heads=1, attn_q_block=128)
    cfg_t = smoke_config(SC2).with_overrides(num_heads=9, num_kv_heads=1, attn_q_block=128)
    rs = np.random.RandomState(5)
    spec = Model(cfg_t, device="cpu").spec()["layers"]["attn"]
    p_np = {k: (rs.randn(*s.shape[1:]) * (0.1 if k.startswith("b_") else 0.05)).astype(
        np.float32) for k, s in spec.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v) for k, v in p_np.items()}
    B, S = 2, 16
    x = rs.randn(B, S, cfg.d_model).astype(np.float32)
    seg = np.repeat(np.asarray([[0] * 10 + [1] * 6, [0] * 16]), 1, 0).astype(np.int32)
    pos = np.asarray([list(range(10)) + list(range(6)), list(range(16))], np.int32)
    want = jattn.attention_apply(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))
    got = attn.attention_apply(tp, torch.from_numpy(x), cfg_t, positions=torch.from_numpy(pos),
                               segment_ids=torch.from_numpy(seg))
    _close(got.numpy(), want, what="attention_apply")
    jc = jattn.init_kv_cache(cfg, B, 8, dtype=jnp.float32, per_row=True)
    tc = attn.init_kv_cache(cfg_t, B, 8, device="cpu", dtype=torch.float32)
    for step in range(4):
        xd = rs.randn(B, 1, cfg.d_model).astype(np.float32)
        yj, jc = jattn.attention_decode_apply(jp, jnp.asarray(xd), cfg, jc)
        yt, tc = attn.attention_decode_apply(tp, torch.from_numpy(xd), cfg_t, tc)
        _close(yt.numpy(), yj, what=f"decode step {step}")
    _close(tc["k"].numpy(), jc["k"], what="k cache")
    _close(tc["v"].numpy(), jc["v"], what="v cache")


def test_yi_forward_and_decode_match_jax():
    """yi-34b's smoke config (its 7:1 grouping cut to the smoke 2:1): the
    forward's logits, then six decode steps, against the JAX model."""
    cfg, cfg_t = jax_smoke_config(YI), smoke_config(YI)
    model = build_model(cfg)
    bb_np = _np_tree(model.init(jax.random.PRNGKey(0)))
    jbb = jax.tree.map(jnp.asarray, bb_np)
    model_t = Model(cfg_t, device="cpu")
    bb_t = backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32)
    tokens = np.random.RandomState(6).randint(1, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = model.forward(jbb, {"tokens": jnp.asarray(tokens)}, return_logits=True)["logits"]
    with torch.no_grad():
        got = model_t.forward(bb_t, {"tokens": torch.from_numpy(tokens)},
                              return_logits=True)["logits"]
    vocab = cfg.vocab_size
    _close(got.numpy()[..., :vocab], np.asarray(want)[..., :vocab], what="forward")
    jst = model.init_decode_state(None, 3, 8, cache_dtype=jnp.float32, per_row=True)
    tst = model_t.init_decode_state(3, 8, cache_dtype=torch.float32)
    step = jax.jit(model.decode_step)
    for t in range(tokens.shape[1]):
        lj, jst = step(jbb, jst, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            lt, tst = model_t.decode_step(bb_t, tst, torch.from_numpy(tokens[:, t:t + 1]))
        _close(lt.numpy()[..., :vocab], np.asarray(lj)[..., :vocab], what=f"decode {t}")
        _close(lt.numpy()[:, 0, :vocab], np.asarray(want)[:, t, :vocab], rel=1e-3,
               what=f"decode {t} vs forward")


# ---------------------------------------------------------------------------
# counts, sites, the CLI, materialize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [SC2, YI])
def test_param_count_and_sites_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert base_op_dims(cfg) == jax_base_op_dims(jcfg)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "rope_theta", "gated_mlp", "attention_bias", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(smoke_config(arch), f) == getattr(jax_smoke_config(arch), f), f
    # the JAX count has no bias; the spec's leaves add exactly the biases
    model = Model(cfg, device="cpu")
    spec = model.spec()
    n_bias = sum(int(np.prod(s.shape)) for s in _spec_leaves(spec["layers"]["attn"])
                 if s.init == "zeros")
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    assert sum(int(np.prod(s.shape)) for s in _spec_leaves(spec)) == \
        cfg.param_count() + n_bias + pad
    assert (n_bias > 0) == (arch == SC2)


def _spec_leaves(tree):
    if isinstance(tree, ParamSpec):
        return [tree]
    return [leaf for v in tree.values() for leaf in _spec_leaves(v)]


@pytest.mark.parametrize("arch", [SC2, YI])
def test_cli_trains_on_cpu(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--arch", arch, "--scale", "0.05", "--steps", "2", "--stages", "1",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == f"done; checkpoints in {tmp_path}"
    assert f"arch={arch}" in lines[0]


def test_materialize_keeps_whole_leaf_draws_and_slices_big_ones(monkeypatch):
    spec = {"a": ParamSpec((3, 4, 5), scale=0.02), "b": ParamSpec((6, 7), scale=0.5),
            "z": ParamSpec((4,), init="zeros")}
    g = torch.Generator().manual_seed(11)
    want_a = (torch.randn((3, 4, 5), generator=g) * 0.02).to(torch.bfloat16)
    want_b = (torch.randn((6, 7), generator=g) * 0.5).to(torch.bfloat16)
    got = layers.materialize(spec, torch.Generator().manual_seed(11), "cpu")
    assert torch.equal(got["a"], want_a) and torch.equal(got["b"], want_b)
    assert got["z"].abs().max() == 0
    monkeypatch.setattr(layers, "SLICED_DRAW_ELEMENTS", 50)  # "a" (60) by slices, "b" (42) whole
    g = torch.Generator().manual_seed(11)
    slices = [(torch.randn((4, 5), generator=g) * 0.02).to(torch.bfloat16) for _ in range(3)]
    want_b = (torch.randn((6, 7), generator=g) * 0.5).to(torch.bfloat16)
    got = layers.materialize(spec, torch.Generator().manual_seed(11), "cpu")
    again = layers.materialize(spec, torch.Generator().manual_seed(11), "cpu")
    assert torch.equal(got["a"], torch.stack(slices)) and torch.equal(got["b"], want_b)
    assert all(torch.equal(got[k], again[k]) for k in spec)
    assert got["a"].dtype == torch.bfloat16 and got["a"].shape == (3, 4, 5)
