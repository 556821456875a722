"""The vlm family (qwen2-vl-7b) against the JAX package, on the CPU.

* ``apply_mrope`` with three different position channels, at qwen2-vl's
  sections (16, 24, 24) / dh = 128 and at the smoke sections (2, 3, 3) /
  dh = 16; with the three channels equal it is ``apply_rope``.
* The M-RoPE branch of ``attention_apply`` and of the per-row
  ``attention_decode_apply`` (random q/k/v/o biases, different channels).
* qwen2-vl's forward at ``smoke_config`` with random biases, with and
  without ``mrope_positions``; one ``PEFTEngine.run_iteration`` (LoRA /
  Adapter / IA3 on q, v, up, down; training batches carry no M-RoPE
  channels, so training runs RoPE in both packages); the decode pool's
  bind (which builds the three channels) and micro steps; a
  ``MuxTuneService`` that admits a vlm tenant and serves its request.
* Every config the port registers has JAX's ``ArchConfig`` values on the
  fields both packages have, and JAX's ``param_count``.

Everything runs in f32 (weights carried across by ``repro_torch.convert``)
and is held within 2e-4 of the largest |value| (losses at rtol 2e-4); the
JAX side runs on its xla tier, both at ``attn_q_block=128``.
"""
import dataclasses

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
from repro.launch.train import parse_tasks as jax_parse_tasks
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import ARCH_NAMES, ArchConfig, get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.data import HTaskLoader
from repro_torch.launch import steps
from repro_torch.launch.train import parse_tasks
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import adamw_init
from test_torch_service import f32_adapters, record_registrations, replay_registrations

ARCH = "qwen2-vl-7b"
JCFG = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
PCFG = smoke_config(ARCH).with_overrides(attn_q_block=128)
SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3"
TRAIN_TARGETS = ("attn_q", "attn_v", "mlp_up", "mlp_down")
TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))
BIASES = ("b_q", "b_k", "b_v", "b_o")
HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
          ici_bw=jax_cost_model.ICI_BW)
REL = 2e-4  # of the largest |value|


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


def _close(got, want, rel=REL, what=""):
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


def _mrope_positions(rs, B, S):
    """Three different channels: a temporal id that holds for 3 tokens, and
    height / width ids of a 4-wide grid, offset per row."""
    s = np.arange(S)
    pos = np.stack([s // 3, s // 4 + 1, s % 4 + 2])[:, None, :] + rs.randint(0, 5, (1, B, 1))
    return pos.astype(np.int32)


# ---------------------------------------------------------------------------
# apply_mrope, attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,dh", [((16, 24, 24), 128), ((2, 3, 3), 16)])
def test_apply_mrope_matches_jax(sections, dh):
    rs = np.random.RandomState(0)
    B, S, H = 2, 12, 3
    x = rs.randn(B, S, H, dh).astype(np.float32)
    pos = _mrope_positions(rs, B, S)
    assert len({tuple(c.ravel()) for c in pos}) == 3  # the channels differ
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    _close(got.numpy(), want, rel=1e-5, what="apply_mrope")
    # text only: three equal channels are RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6, sections)
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6)
    _close(got.numpy(), rope.numpy(), rel=1e-6, what="mrope vs rope")
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (1, 1, 1))


def test_mrope_attention_and_decode_match_jax():
    """``attention_apply`` over three different M-RoPE channels, then four
    per-row decode steps each rotated by its own channels, biases random."""
    rs = np.random.RandomState(5)
    spec = Model(PCFG, device="cpu").spec()["layers"]["attn"]
    p_np = {k: (rs.randn(*s.shape[1:]) * (0.1 if k.startswith("b_") else 0.05)).astype(
        np.float32) for k, s in spec.items()}
    assert set(BIASES) <= set(p_np)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v) for k, v in p_np.items()}
    B, S = 2, 16
    x = rs.randn(B, S, PCFG.d_model).astype(np.float32)
    mpos = _mrope_positions(rs, B, S)
    want = jattn.attention_apply(jp, jnp.asarray(x), JCFG, mrope_positions=jnp.asarray(mpos))
    got = attn.attention_apply(tp, torch.from_numpy(x), PCFG,
                               mrope_positions=torch.from_numpy(mpos))
    _close(got.numpy(), want, what="attention_apply (mrope)")
    plain = attn.attention_apply(tp, torch.from_numpy(x), PCFG)
    assert float((plain - got).abs().max()) > 1e-3  # the channels matter
    jc = jattn.init_kv_cache(JCFG, B, 8, dtype=jnp.float32, per_row=True)
    tc = attn.init_kv_cache(PCFG, B, 8, device="cpu", dtype=torch.float32)
    for step in range(4):
        xd = rs.randn(B, 1, PCFG.d_model).astype(np.float32)
        md = rs.randint(0, 9, (3, B, 1)).astype(np.int32)
        yj, jc = jattn.attention_decode_apply(jp, jnp.asarray(xd), JCFG, jc,
                                              mrope_positions=jnp.asarray(md))
        yt, tc = attn.attention_decode_apply(tp, torch.from_numpy(xd), PCFG, tc,
                                             mrope_positions=torch.from_numpy(md))
        _close(yt.numpy(), yj, what=f"decode step {step}")
    _close(tc["k"].numpy(), jc["k"], what="k cache")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


# ---------------------------------------------------------------------------
# the model: forward, one training iteration, the decode pool, the service
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """JAX and port models on one f32 backbone (biases random) and one LoRA
    set of three tenants on the seven sites (B filled)."""
    model = build_model(JCFG)
    bb_np = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0)))
    _fill_biases(bb_np, np.random.RandomState(0))
    mta = JaxMultiTaskAdapters(JCFG, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                      for r, a in TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(2)
    for site in ad_np["lora"].values():
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)
    mta_t = MultiTaskAdapters(PCFG, [AdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                     for r, a in TENANTS], device="cpu")
    return {"model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
            "ad": jax.tree.map(jnp.asarray, ad_np), "bb_np": bb_np,
            "model_t": Model(PCFG, device="cpu"), "mta_t": mta_t,
            "bb_t": backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu")}


def test_forward_matches_jax(pair):
    """Logits with and without three-channel M-RoPE positions, the LoRA
    rows of three tenants in place; with equal channels the forward is the
    RoPE forward."""
    rs = np.random.RandomState(4)
    B, S = 3, 12
    tokens = rs.randint(1, JCFG.vocab_size, (B, S)).astype(np.int32)
    mpos = _mrope_positions(rs, B, S)
    from repro.peft.multitask import TaskSegments as JaxSegments
    from repro_torch.peft.multitask import TaskSegments

    jf = pair["mta"].ctx_factory(JaxSegments.contiguous([1, 1, 1]))
    pf = pair["mta_t"].ctx_factory(TaskSegments.contiguous([1, 1, 1]))
    vocab = JCFG.vocab_size
    outs = {}
    for name, extra in (("rope", {}), ("mrope", {"mrope_positions": mpos}),
                        ("equal", {"mrope_positions": np.broadcast_to(
                            np.arange(S, dtype=np.int32), (3, B, S)).copy()})):
        batch = {"tokens": tokens, **extra}
        want = jax.jit(lambda bb, b, ad: pair["model"].forward(
            bb, b, adapters=ad, ctx_factory=jf, return_logits=True)["logits"])(
            pair["bb"], {k: jnp.asarray(v) for k, v in batch.items()}, pair["ad"])
        with torch.no_grad():
            got = pair["model_t"].forward(pair["bb_t"], {k: torch.from_numpy(v)
                                                         for k, v in batch.items()},
                                          adapters=pair["ad_t"], ctx_factory=pf,
                                          return_logits=True)["logits"]
        _close(got.numpy()[..., :vocab], np.asarray(want)[..., :vocab], what=name)
        outs[name] = got.numpy()[..., :vocab]
    _close(outs["equal"], outs["rope"], rel=1e-5, what="equal channels vs rope")
    assert np.abs(outs["mrope"] - outs["rope"]).max() > 1e-4


def _engines():
    jt = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=TRAIN_TARGETS))
          for t in jax_parse_tasks(TRAIN_TASKS, 2)]
    jplan = JaxPlanner(JCFG, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(JCFG, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
    _fill_biases(bb_np, np.random.RandomState(1))
    ad_np = _np_tree(jgen.registered.adapter_params)
    rs = np.random.RandomState(0)
    for kind in ad_np.values():
        for site in kind.values():
            for leaf in ("b", "up", "s"):
                if leaf in site:
                    site[leaf] = (rs.randn(*site[leaf].shape) * 0.05).astype(np.float32)
    jgen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
    jgen.registered.adapter_params = jax.tree.map(jnp.asarray, ad_np)
    jgen.registered.opt_state = jax_adamw_init(jgen.registered.adapter_params)
    jeng = JaxEngine(jgen, jplan, lr=1e-3)

    pt = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=TRAIN_TARGETS))
          for t in parse_tasks(TRAIN_TASKS, 2)]
    pplan = ExecutionPlanner(PCFG, ParallelismSpec(num_stages=1), hw=HardwareProfile(**HW),
                             memory_budget=jax_cost_model.HBM_BYTES).plan(pt, n_micro=1)
    gen = ModelGenerator(PCFG, device="cpu")
    reg = gen.register_tasks(pt)
    gen.backbone_params = backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    reg.opt_state = adamw_init(reg.adapter_params)
    peng = PEFTEngine(gen, pplan, lr=1e-3, device="cpu")
    loaders = ({i: JaxLoader(jt, jplan.alignment[i], JCFG.vocab_size, seed=3)
                for i in range(len(jplan.htasks))},
               {i: HTaskLoader(pt, pplan.alignment[i], PCFG.vocab_size, seed=3)
                for i in range(len(pplan.htasks))})
    return jeng, peng, loaders


def test_run_iteration_matches_jax():
    """Losses, the updated adapters and both AdamW moments (the first holds
    the gradient) after one iteration of LoRA / Adapter / IA3 tenants."""
    jeng, peng, (jl, pl) = _engines()
    assert sorted(peng.reg.adapter_params["lora"]) == sorted(TRAIN_TARGETS)
    jm = jeng.run_iteration(jl)
    pm = peng.run_iteration(pl)
    np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4)
    for name, jtree, ptree in (("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                               ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                               ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
        jf, pf = _flat(jtree), _flat(ptree)
        assert sorted(jf) == sorted(pf)
        for path in jf:
            np.testing.assert_allclose(pf[path], jf[path], rtol=2e-4,
                                       atol=2e-4 * max(np.abs(jf[path]).max(), 1e-12),
                                       err_msg=f"{name} {path}")


ROWS, MAX_LEN, CAP, LP = 4, 24, 6, 8
BIND_ROWS = np.asarray([0, 1, 3], np.int32)
BIND_TASKS = np.asarray([2, 0, 1], np.int32)
POOL_TASKS = np.asarray([2, 0, -1, 1], np.int32)
LENGTHS = np.asarray([8, 5, 3], np.int32)
MAX_NEW = np.asarray([6, 3, 5], np.int32)


def test_decode_pool_matches_jax(pair):
    """The batched bind (its prefill with three-channel M-RoPE positions)
    and the micro steps (M-RoPE from ``pos``): greedy tokens, counters and
    caches equal JAX's."""
    rs = np.random.RandomState(7)
    tokens = np.zeros((len(LENGTHS), LP), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rs.randint(1, JCFG.vocab_size, n)
    model, mta = pair["model"], pair["mta"]
    scales = {k: jnp.asarray(mta.scales(k)) for k in mta.kind_tasks}

    def jslots(tasks):
        return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(tasks).items()}

    from repro.launch import steps as jsteps

    pool = jsteps.init_decode_pool(model, ROWS, MAX_LEN, CAP, cache_dtype=jnp.float32)
    bind = jsteps.build_decode_batched_bind_step(model, mta, MAX_LEN)
    micro = jsteps.build_decode_micro_step(model, mta)
    pool = bind(pair["bb"], pair["ad"], pool, jnp.asarray(BIND_ROWS), jnp.asarray(tokens),
                jnp.asarray(LENGTHS), jslots(BIND_TASKS), scales, jnp.asarray(MAX_NEW),
                jsteps.greedy_sampling(len(BIND_ROWS)))
    for _ in range(CAP - 1):
        pool = micro(pair["bb"], pair["ad"], pool, jslots(POOL_TASKS), scales)

    model_t, mta_t = pair["model_t"], pair["mta_t"]
    scales_t = {k: torch.from_numpy(mta_t.scales(k)) for k in mta_t.kind_tasks}

    def tslots(tasks):
        return {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(tasks).items()}

    batch = steps.prefill_batch(PCFG, torch.from_numpy(tokens))
    assert batch["mrope_positions"].shape == (3, len(LENGTHS), LP)
    tpool = steps.init_decode_pool(model_t, ROWS, MAX_LEN, CAP, cache_dtype=torch.float32)
    tbind = steps.build_decode_batched_bind_step(model_t, mta_t, MAX_LEN)
    tpool = tbind(pair["bb_t"], pair["ad_t"], tpool, torch.from_numpy(BIND_ROWS),
                  torch.from_numpy(tokens), torch.from_numpy(LENGTHS), tslots(BIND_TASKS),
                  scales_t, torch.from_numpy(MAX_NEW), steps.greedy_sampling(3, "cpu"), [])
    tmicro = steps.build_decode_micro_step(model_t, mta_t)
    for _ in range(CAP - 1):
        tpool = tmicro(pair["bb_t"], pair["ad_t"], tpool, tslots(POOL_TASKS), scales_t, [])
    np.testing.assert_array_equal(tpool["out"].numpy(), np.asarray(pool["out"]))
    for key in ("n_out", "active"):
        np.testing.assert_array_equal(tpool[key].numpy(), np.asarray(pool[key]), err_msg=key)
    np.testing.assert_array_equal(tpool["state"]["pos"].numpy(),
                                  np.asarray(pool["state"]["pos"]))
    assert list(tpool["n_out"].numpy()) == [6, 3, 0, 5]
    for key in ("k", "v"):
        _close(tpool["state"]["kv"][key].numpy(), pool["state"]["kv"][key], what=key)


def test_service_admits_and_serves_vlm_as_jax(tmp_path):
    """MuxTuneService on qwen2-vl: a LoRA tenant trains while its decode
    request is served; the service admits the vlm request (as JAX's does)
    and its tokens equal the JAX service's."""
    from repro import serve as jserve
    from repro.data.synthetic import make_task as jax_make_task
    from repro_torch import serve as pserve
    from repro_torch.data.synthetic import make_task

    def run(mod, mk, adapter_cls, svc):
        task = mk("a", "sst2", 2, adapter_cls("lora", rank=4, targets=SITES), seed=0)
        svc.submit(mod.TenantSpec(task, target_steps=2))
        req = svc.submit_request("a", mod.RequestSpec(
            np.random.RandomState(3).randint(1, 200, 9), max_new_tokens=4))
        for _ in range(2):
            svc.step()
        return req

    args = dict(lr=5e-3, n_micro=1, enable_fusion=False, reserve_slots=2, seed=0,
                auto_recalibrate=False)
    with f32_adapters():
        jsvc = jserve.MuxTuneService(
            JCFG, JaxParallelism(), ckpt_dir=str(tmp_path / "jax"),
            coserve=jserve.CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8),
            **args)
        bb_np = _np_tree(jsvc.gen.init_backbone())
        _fill_biases(bb_np, np.random.RandomState(2))
        jsvc.gen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
        snaps = record_registrations(jsvc.gen)
        jr = run(jserve, jax_make_task, JaxAdapterConfig, jsvc)
        psvc = pserve.MuxTuneService(
            PCFG, ParallelismSpec(), hw=HardwareProfile(**HW), device="cpu",
            ckpt_dir=str(tmp_path / "port"),
            coserve=pserve.CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8),
            **args)
        psvc.gen.backbone_params = backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32)
        replay_registrations(psvc.gen, snaps)
        pr = run(pserve, make_task, AdapterConfig, psvc)
    assert jr.state == pr.state == "done"
    assert len(pr.tokens_out) == 4
    np.testing.assert_array_equal(pr.tokens_out, jr.tokens_out)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_fields_and_param_count_equal_jax(arch):
    """Every field the two ``ArchConfig`` classes share, on the full config
    and on ``smoke_config``, and ``param_count``."""
    shared = [f.name for f in dataclasses.fields(ArchConfig)]
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        for f in shared:
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.param_count(active_only=True) == jcfg.param_count(active_only=True)
    assert get_config("qwen2-vl-7b").param_count() == 7_615_487_488
