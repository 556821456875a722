"""The port's MoE family (deepseek-moe-16b, qwen3-moe's qk-norm) against the
JAX package at ``smoke_config`` size on the CPU.

* ``moe_apply`` in f32: outputs, gates, expert ids, the load-balance loss and
  the busiest expert's share, at a capacity where tokens are dropped and at
  an exact tie between two experts' probabilities (the lower index wins, as
  ``jax.lax.top_k``); in bf16 within 2 bf16 units; the gradient of the
  outputs and of the load-balance loss; the combine giving the same bits on
  two calls.
* deepseek-moe's forward (logits and the summed aux losses), the gradient
  of the load-balance loss with respect to the adapters, one
  ``PEFTEngine.run_iteration`` with LoRA, Adapter and IA3 tenants on the
  attention and shared-MLP sites (the engine adds ``aux_coef`` times the
  load-balance loss), the decode pool's greedy generation and
  teacher-forced prefill + ``decode_step``, and ``MuxTuneService``'s greedy
  tokens.
* The int8 tier on MoE: the ``moe`` subtree stays dense, q / scale are
  bit-identical, ``quantized_param_count``, the int8 forward.
* qwen3-moe's ``qk_norm`` forward and decode; ``param_count`` and the cost
  model's MoE terms equal to JAX's.

Weights and adapters go across through ``repro_torch.convert`` in f32;
batches come from numpy seeds.  ``attn_q_block`` is 128 on both sides
(ROADMAP Queue 3).
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
from repro.models import moe as jmoe
from repro.models import quantize as jquant
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import ExecutionPlanner, HardwareProfile, ModelGenerator, ParallelismSpec
from repro_torch.core import PEFTEngine
from repro_torch.core import cost_model as port_cost_model
from repro_torch.data import HTaskLoader
from repro_torch.launch.train import parse_tasks
from repro_torch.models import moe as pmoe
from repro_torch.models import quantize as pquant
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.train.optimizer import adamw_init
from test_torch_serve import _jax_generate, _port_generate, BIND_TASKS, LENGTHS, LP, MAX_LEN
from test_torch_service import f32_adapters, record_registrations, replay_registrations

ARCH = "deepseek-moe-16b"
JCFG = jax_smoke_config(ARCH).with_overrides(attn_q_block=128)
PCFG = smoke_config(ARCH).with_overrides(attn_q_block=128)
SITES = ("attn_q", "attn_k", "attn_v", "attn_o",
         "shared_mlp_gate", "shared_mlp_up", "shared_mlp_down")
TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))
TRAIN_TASKS = "sst2:lora:8,qa:lora:16,rte:adapter:4,sst2:ia3"
TRAIN_TARGETS = ("attn_q", "attn_v", "shared_mlp_up", "shared_mlp_down")
HW = dict(peak_flops=jax_cost_model.PEAK_FLOPS, hbm_bw=jax_cost_model.HBM_BW,
          ici_bw=jax_cost_model.ICI_BW)


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


def _slots(mta, rows, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return mta.ctx_factory_from_slots({k: conv(v) for k, v in mta.decode_row_slots(rows).items()})


def _build_pair(cfg, cfg_t, sites, seed=0):
    """JAX and port models on one f32 backbone and one LoRA adapter set (B
    filled from a numpy seed)."""
    model = build_model(cfg)
    bb_np = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(seed)))
    mta = JaxMultiTaskAdapters(cfg, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=sites)
                                     for r, a in TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(seed + 1)))
    rs = np.random.RandomState(seed)
    for site in ad_np["lora"].values():
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)
    mta_t = MultiTaskAdapters(cfg_t, [AdapterConfig("lora", rank=r, alpha=a, targets=sites)
                                      for r, a in TENANTS], device="cpu")
    return {"model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
            "ad": jax.tree.map(jnp.asarray, ad_np), "bb_np": bb_np, "ad_np": ad_np,
            "model_t": Model(cfg_t, device="cpu"), "mta_t": mta_t,
            "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu")}


@pytest.fixture(scope="module")
def pair():
    s = _build_pair(JCFG, PCFG, SITES)
    rs = np.random.RandomState(3)
    s["tokens"] = np.zeros((len(LENGTHS), LP), np.int32)
    for i, n in enumerate(LENGTHS):
        s["tokens"][i, :n] = rs.randint(1, 256, n)
    return s


# ---------------------------------------------------------------------------
# moe_apply


def _moe_inputs(seed=0, T=96):
    cfg = JCFG
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    rs = np.random.RandomState(seed)
    p = {"router": rs.randn(d, E).astype(np.float32) * 0.3,
         "w_gate": rs.randn(E, d, f).astype(np.float32) * 0.1,
         "w_up": rs.randn(E, d, f).astype(np.float32) * 0.1,
         "w_down": rs.randn(E, f, d).astype(np.float32) * 0.1}
    x = rs.randn(2, T // 2, d).astype(np.float32)
    return p, x


def _both(p, x, cf, dtype=None):
    """(jax out, port out) of moe_apply and of _route at capacity factor cf."""
    jcfg, pcfg = JCFG.with_overrides(capacity_factor=cf), PCFG.with_overrides(capacity_factor=cf)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in p.items()}
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    jy, jaux = jax.jit(lambda pp, xx: jmoe.moe_apply(pp, xx, jcfg))(jp, jx)
    ty, taux = pmoe.moe_apply(tp, tx, pcfg)
    d = x.shape[-1]
    jr = jmoe._route(jx.reshape(-1, d), jp["router"], jcfg.top_k)
    tr = pmoe._route(tx.reshape(-1, d), tp["router"], pcfg.top_k)
    return (jy, jaux, jr), (ty, taux, tr)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_matches_jax_f32(cf):
    """Routing, gates, capacity drops, the combine and the aux losses; at
    cf 0.5 tokens are dropped, at 1.25 none are."""
    p, x = _moe_inputs()
    (jy, jaux, (jids, jg, jprobs)), (ty, taux, (tids, tg, tprobs)) = _both(p, x, cf)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-5, atol=1e-7)
    cap = pmoe._capacity(x.shape[0] * x.shape[1], JCFG.top_k, JCFG.num_experts, cf)
    assert cap == jmoe._capacity(x.shape[0] * x.shape[1], JCFG.top_k, JCFG.num_experts, cf)
    dropped = pmoe.dropped_tokens(tids, JCFG.num_experts, cap)
    assert (dropped > 0) == (cf < 1.0), dropped
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for key in ("moe_load_balance", "moe_max_frac"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)
    if dropped:  # a dropped assignment leaves its token's output short of it
        full, _ = pmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), PCFG.with_overrides(capacity_factor=8.0))
        assert (full - ty).abs().max().item() > 1e-3


def test_moe_tie_breaks_toward_lower_expert():
    """Experts 0 and 3 have the same router column, so every token's
    probabilities tie there at the second place: both packages pick 0."""
    p, x = _moe_inputs(seed=1)
    rs = np.random.RandomState(2)
    v = np.abs(rs.randn(JCFG.d_model)).astype(np.float32) * 0.1
    p["router"] = np.stack([2 * v, 3 * v, -v, 2 * v], axis=1)
    x = np.abs(x)
    (jy, _, (jids, jg, _)), (ty, _, (tids, tg, tprobs)) = _both(p, x, 1.25)
    assert torch.equal(tprobs[:, 0], tprobs[:, 3])
    np.testing.assert_array_equal(np.asarray(jids), np.tile([1, 0], (x.shape[0] * x.shape[1], 1)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)


def test_moe_apply_bf16_within_two_units():
    p, x = _moe_inputs(seed=4)
    (jy, jaux, (jids, _, _)), (ty, taux, (tids, _, _)) = _both(p, x, 1.25, "bf16")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    want = np.asarray(jy.astype(jnp.float32))
    assert ty.dtype == torch.bfloat16
    err = np.abs(ty.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(want).max(), err
    np.testing.assert_allclose(float(taux["moe_load_balance"]),
                               float(jaux["moe_load_balance"]), rtol=1e-5)


def test_moe_apply_gradients_match_jax():
    """d(sum(y * gy) + 0.1 lb) / dx and / d router: the gates' and the load
    balance's gradient through the probabilities, with tokens dropped."""
    p, x = _moe_inputs(seed=5)
    gy = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    cf = 0.5

    def jloss(xx, router):
        jp = dict({k: jnp.asarray(v) for k, v in p.items()}, router=router)
        y, aux = jmoe.moe_apply(jp, xx, JCFG.with_overrides(capacity_factor=cf))
        return (y * gy).sum() + 0.1 * aux["moe_load_balance"]

    jgx, jgr = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                         jnp.asarray(p["router"]))
    tx = torch.from_numpy(x).requires_grad_(True)
    tr = torch.from_numpy(p["router"]).requires_grad_(True)
    tp = dict({k: torch.from_numpy(v) for k, v in p.items()}, router=tr)
    y, aux = pmoe.moe_apply(tp, tx, PCFG.with_overrides(capacity_factor=cf))
    ((y * torch.from_numpy(gy)).sum() + 0.1 * aux["moe_load_balance"]).backward()
    for got, want in ((tx.grad, jgx), (tr.grad, jgr)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_combine_gives_the_same_bits_twice():
    p, x = _moe_inputs(seed=7, T=192)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    cfg = PCFG.with_overrides(capacity_factor=0.5)
    outs = []
    for _ in range(2):
        y, aux = pmoe.moe_apply(tp, tx, cfg)
        g, = torch.autograd.grad((y.float() ** 2).sum() + aux["moe_load_balance"], [tx])
        outs.append((y, g))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# the model


def test_port_spec_matches_jax_trees(pair):
    assert {k: v.shape for k, v in _flat(pair["bb_t"]).items()} == \
        {k: v.shape for k, v in _flat(pair["bb_np"]).items()}
    assert ("layers", "moe", "router") in _flat(pair["bb_np"])
    assert ("layers", "shared_mlp", "w_up") in _flat(pair["bb_np"])
    assert sorted(pair["ad_t"]["lora"]) == sorted(SITES)


def test_forward_and_aux_match_jax(pair):
    tokens = np.random.RandomState(1).randint(1, 256, (4, 16)).astype(np.int32)
    rows = np.asarray([0, 1, 2, -1], np.int32)
    ctxf = _slots(pair["mta"], rows, "jax")
    want = jax.jit(lambda bb, ad, tok: pair["model"].forward(
        bb, {"tokens": tok}, adapters=ad, ctx_factory=ctxf, return_logits=True))(
        pair["bb"], pair["ad"], jnp.asarray(tokens))
    got = pair["model_t"].forward(pair["bb_t"], {"tokens": torch.from_numpy(tokens)},
                                  adapters=pair["ad_t"],
                                  ctx_factory=_slots(pair["mta_t"], rows, "torch"),
                                  return_logits=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    assert sorted(got["aux"]) == sorted(want["aux"]) == ["moe_load_balance", "moe_max_frac"]
    for k in want["aux"]:
        np.testing.assert_allclose(float(got["aux"][k]), float(want["aux"][k]), rtol=1e-5)


def test_load_balance_gradient_reaches_adapters_as_in_jax(pair):
    """The load-balance loss alone, differentiated with respect to every
    LoRA leaf: layer 0's adapters get a gradient through layer 1's router."""
    tokens = np.random.RandomState(2).randint(1, 256, (3, 16)).astype(np.int32)
    rows = np.asarray([0, 1, 2], np.int32)
    model, mta = pair["model"], pair["mta"]

    def jlb(ad):
        out = model.forward(pair["bb"], {"tokens": jnp.asarray(tokens)}, adapters=ad,
                            ctx_factory=_slots(mta, rows, "jax"))
        return out["aux"]["moe_load_balance"]

    jg = _flat(jax.jit(jax.grad(jlb))(pair["ad"]))
    ad_t = jax.tree.map(lambda a: a, pair["ad_t"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in _flat_t(ad_t).items()}
    tree = _unflat(leaves)
    out = pair["model_t"].forward(pair["bb_t"], {"tokens": torch.from_numpy(tokens)},
                                  adapters=tree, ctx_factory=_slots(pair["mta_t"], rows, "torch"))
    grads = torch.autograd.grad(out["aux"]["moe_load_balance"], list(leaves.values()))
    assert any(np.abs(jg[("lora", s, "a")][0]).max() > 0 for s in SITES)
    for path, g in zip(leaves, grads):
        want = jg[path]
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=str(path))


def _flat_t(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _engines():
    jt = [dataclasses.replace(t, adapter=dataclasses.replace(t.adapter, targets=TRAIN_TARGETS))
          for t in jax_parse_tasks(TRAIN_TASKS, 2)]
    jplan = JaxPlanner(JCFG, JaxParallelism(num_stages=1)).plan(jt, n_micro=1)
    jgen = JaxGenerator(JCFG, seed=0)
    jgen.register_tasks(jt)
    bb_np = _np_tree(jgen.init_backbone())
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
    loaders = ({i: JaxLoader(jt, jplan.alignment[i], JCFG.vocab_size)
                for i in range(len(jplan.htasks))},
               {i: HTaskLoader(pt, pplan.alignment[i], PCFG.vocab_size)
                for i in range(len(pplan.htasks))})
    return jeng, peng, loaders


def test_run_iteration_matches_jax():
    """Losses (with the aux term), the updated adapters and both AdamW
    moments (the first holds the gradient) after one iteration."""
    jeng, peng, (jl, pl) = _engines()
    assert sorted(peng.reg.adapter_params["lora"]) == sorted(TRAIN_TARGETS)
    jm = jeng.run_iteration(jl)
    pm = peng.run_iteration(pl)
    np.testing.assert_allclose(pm.per_task_loss, jm.per_task_loss, rtol=2e-4)
    np.testing.assert_allclose(pm.loss, jm.loss, rtol=2e-4)
    for name, jtree, ptree in (("params", jeng.reg.adapter_params, peng.reg.adapter_params),
                               ("m", jeng.reg.opt_state.m, peng.reg.opt_state.m),
                               ("v", jeng.reg.opt_state.v, peng.reg.opt_state.v)):
        jf, pf = _flat(jtree), _flat(ptree)
        assert sorted(jf) == sorted(pf)
        for path in jf:
            np.testing.assert_allclose(pf[path], jf[path], rtol=2e-4,
                                       atol=2e-4 * max(np.abs(jf[path]).max(), 1e-12),
                                       err_msg=f"{name} {path}")


# ---------------------------------------------------------------------------
# decode


def test_pool_generation_matches_jax(pair):
    """The decode pool's batched bind and micro steps (every pool row, free
    ones too, routes through each MoE layer): greedy tokens and counters."""
    j, p = _jax_generate(pair), _port_generate(pair, batched=True)
    np.testing.assert_array_equal(p["out"], j["out"])
    for key in ("n_out", "active", "pos", "lo"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    np.testing.assert_allclose(p["k"], j["k"], rtol=1e-4, atol=1e-4)


def _teacher_forced(s, lib, steps=3):
    """Prefill of the three prompts, then ``steps`` decode steps fed fixed
    tokens: the logits of each (the JAX side jitted)."""
    tokens = s["tokens"]
    follow = np.random.RandomState(9).randint(1, 256, (steps, len(LENGTHS), 1)).astype(np.int32)
    ctxf = _slots(s["mta"] if lib == "jax" else s["mta_t"], BIND_TASKS, lib)
    if lib == "jax":
        model, conv = s["model"], jnp.asarray
        st = model.init_decode_state(None, len(LENGTHS), MAX_LEN, cache_dtype=jnp.float32,
                                     per_row=True)
        prefill = jax.jit(lambda bb, ad, st, tok, n: model.prefill(
            bb, {"tokens": tok}, st, adapters=ad, ctx_factory=ctxf, lengths=n))
        decode = jax.jit(lambda bb, ad, st, tok: model.decode_step(
            bb, st, tok, adapters=ad, ctx_factory=ctxf))
        bb, ad = s["bb"], s["ad"]
    else:
        model, conv = s["model_t"], torch.from_numpy
        st = model.init_decode_state(len(LENGTHS), MAX_LEN, cache_dtype=torch.float32)
        prefill = lambda bb, ad, st, tok, n: model.prefill(  # noqa: E731
            bb, {"tokens": tok}, st, adapters=ad, ctx_factory=ctxf, lengths=n)
        decode = lambda bb, ad, st, tok: model.decode_step(  # noqa: E731
            bb, st, tok, adapters=ad, ctx_factory=ctxf)
        bb, ad = s["bb_t"], s["ad_t"]
    lg, st = prefill(bb, ad, st, conv(tokens), conv(LENGTHS))
    out = [np.asarray(lg)]
    for i in range(steps):
        lg, st = decode(bb, ad, st, conv(follow[i]))
        out.append(np.asarray(lg))
    return out


def test_teacher_forced_decode_matches_jax(pair):
    for i, (got, want) in enumerate(zip(_teacher_forced(pair, "torch"),
                                        _teacher_forced(pair, "jax"))):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")


def test_service_greedy_tokens_match_jax(tmp_path):
    """MuxTuneService on MoE: two LoRA tenants train while decode requests
    to both are served; the tokens equal the JAX service's."""
    from repro import serve as jserve
    from repro_torch import serve as pserve
    from repro.data.synthetic import make_task as jax_make_task
    from repro_torch.data.synthetic import make_task

    def run(mod, mk, adapter_cls, svc):
        for tid, ds, seed in (("a", "sst2", 0), ("b", "qa", 1)):
            task = mk(tid, ds, 2, adapter_cls("lora", rank=4, targets=SITES), seed=seed)
            svc.submit(mod.TenantSpec(task, target_steps=2))
        reqs = [svc.submit_request(tid, mod.RequestSpec(
                    np.random.RandomState(i).randint(1, 200, n), max_new_tokens=4))
                for i, (tid, n) in enumerate((("a", 7), ("b", 12)))]
        for _ in range(2):
            svc.step()
        return reqs

    args = dict(lr=5e-3, n_micro=1, enable_fusion=False, reserve_slots=2, seed=0,
                auto_recalibrate=False)
    with f32_adapters():
        jsvc = jserve.MuxTuneService(
            JCFG, JaxParallelism(), ckpt_dir=str(tmp_path / "jax"),
            coserve=jserve.CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8),
            **args)
        bb_np = _np_tree(jsvc.gen.init_backbone())
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
    done = [(p, j) for p, j in zip(pr, jr) if j.state == "done"]
    assert [p.state for p in pr] == [j.state for j in jr] and len(done) == 2
    for p, j in done:
        assert len(p.tokens_out) == 4
        np.testing.assert_array_equal(p.tokens_out, j.tokens_out)


def test_serving_admits_moe_and_refuses_hybrid():
    """The bind's prefill stays dense / MoE only; the hybrid family decodes
    through ``decode_step`` alone (``test_torch_hybrid_decode.py``), so the
    service rejects its requests."""
    z = Model(smoke_config("zamba2-2.7b"), device="cpu")
    with pytest.raises(NotImplementedError, match="dense and MoE"):
        z.prefill(None, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, {})
    from repro_torch.serve import MuxTuneService, RequestSpec

    svc = MuxTuneService(smoke_config("zamba2-2.7b"), ParallelismSpec(), device="cpu")
    r = svc.submit_request("t", RequestSpec([3, 5, 7], max_new_tokens=2))
    assert r.reason == "family_unsupported"


# ---------------------------------------------------------------------------
# the int8 tier, qwen3-moe's qk-norm, the counts


def test_int8_moe_backbone_matches_jax(pair):
    """The JAX walk and the port's quantize the same leaves to the same
    bits, leave ``moe`` dense, and the int8 forwards agree in f32."""
    jcfg8, pcfg8 = JCFG.with_overrides(backbone_dtype="int8"), \
        PCFG.with_overrides(backbone_dtype="int8")
    jq = jax.tree.map(np.asarray, jquant.quantize_backbone(pair["bb"], jcfg8))
    pq = pquant.quantize_backbone(backbone_from_numpy(pair["bb_np"], PCFG, "cpu",
                                                      torch.float32), pcfg8)
    assert not pquant.is_quantized(pq["layers"]["moe"]["w_up"])
    assert all(torch.is_tensor(v) for v in pq["layers"]["moe"].values())
    jflat = jax.tree_util.tree_flatten_with_path(jq)[0]
    pflat = _flat_t(pq)
    assert len(jflat) == len(pflat)
    for path, leaf in jflat:
        key = tuple(getattr(k, "key", k) for k in path)
        got = pflat[key]
        if key[-1] in ("q", "scale"):
            np.testing.assert_array_equal(got.numpy(), leaf, err_msg=str(key))
        else:
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf, np.float32))
    # the JAX int8 tree converts across as it is
    for key, leaf in _flat_t(backbone_from_numpy(jq, pcfg8, "cpu", torch.float32)).items():
        assert leaf.dtype == pflat[key].dtype and torch.equal(leaf, pflat[key]), key
    n = jquant.quantized_param_count(jax_get_config(ARCH))
    assert pquant.quantized_param_count(get_config(ARCH)) == n == 954_204_160
    tokens = np.random.RandomState(4).randint(1, 256, (3, 16)).astype(np.int32)
    rows = np.asarray([0, 2, 1], np.int32)
    ctxf = _slots(pair["mta"], rows, "jax")
    want = jax.jit(lambda bb, ad, tok: build_model(jcfg8).forward(
        bb, {"tokens": tok}, adapters=ad, ctx_factory=ctxf, return_logits=True)["logits"])(
        jax.tree.map(jnp.asarray, jq), pair["ad"], jnp.asarray(tokens))
    got = Model(pcfg8, device="cpu").forward(pq, {"tokens": torch.from_numpy(tokens)},
                                             adapters=pair["ad_t"],
                                             ctx_factory=_slots(pair["mta_t"], rows, "torch"),
                                             return_logits=True)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def qwen3():
    name = "qwen3-moe-235b-a22b"
    s = _build_pair(jax_smoke_config(name).with_overrides(attn_q_block=128),
                    smoke_config(name).with_overrides(attn_q_block=128),
                    ("attn_q", "attn_k", "attn_v", "attn_o"), seed=2)
    # q_norm / k_norm start at 1: make them matter
    rs = np.random.RandomState(8)
    for leaf in ("q_norm", "k_norm"):
        s["bb_np"]["layers"]["attn"][leaf] = (
            1.0 + 0.5 * rs.randn(*s["bb_np"]["layers"]["attn"][leaf].shape)).astype(np.float32)
    s["bb"] = jax.tree.map(jnp.asarray, s["bb_np"])
    s["bb_t"] = backbone_from_numpy(s["bb_np"], s["model_t"].cfg, "cpu", torch.float32)
    s["tokens"] = np.random.RandomState(5).randint(1, 256, (len(LENGTHS), LP)).astype(np.int32)
    return s


def test_qwen3_qk_norm_forward_and_decode_match_jax(qwen3):
    cfg_t = qwen3["model_t"].cfg
    assert cfg_t.qk_norm and cfg_t.num_shared_experts == 0
    assert "shared_mlp" not in qwen3["bb_t"]["layers"]
    assert qwen3["bb_t"]["layers"]["attn"]["q_norm"].shape == (cfg_t.num_layers, 16)
    for i, (got, want) in enumerate(zip(_teacher_forced(qwen3, "torch"),
                                        _teacher_forced(qwen3, "jax"))):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    # without the norm the logits move
    bb = dict(qwen3["bb_t"], layers=dict(qwen3["bb_t"]["layers"], attn={
        k: (torch.ones_like(v) if k.endswith("_norm") else v)
        for k, v in qwen3["bb_t"]["layers"]["attn"].items()}))
    tok = torch.from_numpy(qwen3["tokens"][:1, :8])
    a = qwen3["model_t"].forward(qwen3["bb_t"], {"tokens": tok}, return_logits=True)["logits"]
    b = qwen3["model_t"].forward(bb, {"tokens": tok}, return_logits=True)["logits"]
    assert (a - b).abs().max().item() > 1e-4


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_param_count_and_cost_terms_match_jax(arch):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    for active in (False, True):
        assert pcfg.param_count(active_only=active) == jcfg.param_count(active_only=active)
    if arch == ARCH:
        assert pcfg.param_count() == 16_879_568_896
    for dtype, wb in ((2, None), (2, 1)):
        jops = jax_cost_model.backbone_ops(jcfg, dtype, wb)
        pops = port_cost_model.backbone_ops(pcfg, dtype, wb)
        assert [dataclasses.astuple(o) for o in pops] == [dataclasses.astuple(o) for o in jops]
    assert [o.name for o in pops][-2:] == ["moe_experts", "router"]
    for backbone_dtype in ("bfloat16", "int8"):
        jm = jax_cost_model.CostModel(jcfg.with_overrides(backbone_dtype=backbone_dtype), [],
                                      JaxParallelism()).stage_memory([])
        pm = port_cost_model.CostModel(pcfg.with_overrides(backbone_dtype=backbone_dtype), [],
                                       ParallelismSpec()).stage_memory([])
        assert pm == pytest.approx(jm, rel=1e-12)
