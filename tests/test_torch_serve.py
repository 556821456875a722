"""The port's decode pool against the JAX package's
``build_decode_batched_bind_step`` / ``build_decode_micro_step``.

Three LoRA tenants (non-zero B) on four pool rows, one of them idle; three
prompts of different true lengths in one bucket; greedy decoding; float32
weights and caches.  The generated tokens must be identical to JAX's and the
pool counters equal; the bind's prefill logits agree at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMultiTaskAdapters
from repro_torch.configs import smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core import (
    ExecutionPlanner,
    ModelGenerator,
    ParallelismSpec,
    PEFTEngine,
    PEFTTask,
)
from repro_torch.launch import steps
from repro_torch.models.transformer import Model
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters

SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down")
TENANTS = ((4, 8.0), (8, 4.0), (2, 6.0))
ROWS, MAX_LEN, CAP, LP = 4, 24, 6, 8
BIND_ROWS = np.asarray([0, 1, 3], np.int32)     # row 2 stays idle
BIND_TASKS = np.asarray([2, 0, 1], np.int32)
POOL_TASKS = np.asarray([2, 0, -1, 1], np.int32)
LENGTHS = np.asarray([8, 5, 3], np.int32)
MAX_NEW = np.asarray([6, 3, 5], np.int32)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _prompts():
    rs = np.random.RandomState(3)
    tokens = np.zeros((len(LENGTHS), LP), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rs.randint(1, 256, n)
    return tokens


@pytest.fixture(scope="module")
def setup():
    cfg = jax_smoke_config("llama3.2-3b")
    model = build_model(cfg)
    bb_np = _np_tree(model.init(jax.random.PRNGKey(0)))
    mta = JaxMultiTaskAdapters(cfg, [JaxAdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                     for r, a in TENANTS])
    ad_np = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(0)
    for site in ad_np["lora"].values():
        site["b"] = (rs.randn(*site["b"].shape) * 0.1).astype(np.float32)
    cfg_t = smoke_config("llama3.2-3b")
    mta_t = MultiTaskAdapters(cfg_t, [AdapterConfig("lora", rank=r, alpha=a, targets=SITES)
                                      for r, a in TENANTS], device="cpu")
    s = {"model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb_np),
         "ad": jax.tree.map(jnp.asarray, ad_np),
         "model_t": Model(cfg_t, device="cpu"), "mta_t": mta_t,
         "bb_t": backbone_from_numpy(bb_np, cfg_t, "cpu", torch.float32),
         "ad_t": adapters_from_numpy(ad_np, mta_t, "cpu"), "tokens": _prompts()}
    s["jax_pool"] = _jax_generate(s)
    s["port_pool"] = _port_generate(s, batched=True)
    return s


def _jax_generate(s):
    model, mta = s["model"], s["mta"]
    pool = jsteps.init_decode_pool(model, ROWS, MAX_LEN, CAP, cache_dtype=jnp.float32)
    bind = jsteps.build_decode_batched_bind_step(model, mta, MAX_LEN)
    micro = jsteps.build_decode_micro_step(model, mta)
    scales = {k: jnp.asarray(mta.scales(k)) for k in mta.kind_tasks}

    def slots(tasks):
        return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(tasks).items()}

    pool = bind(s["bb"], s["ad"], pool, jnp.asarray(BIND_ROWS), jnp.asarray(s["tokens"]),
                jnp.asarray(LENGTHS), slots(BIND_TASKS), scales, jnp.asarray(MAX_NEW),
                jsteps.greedy_sampling(len(BIND_ROWS)))
    for _ in range(CAP - 1):
        pool = micro(s["bb"], s["ad"], pool, slots(POOL_TASKS), scales)
    return jax.tree.map(np.asarray, {"out": pool["out"], "n_out": pool["n_out"],
                                     "active": pool["active"], "pos": pool["state"]["pos"],
                                     "lo": pool["state"]["lo"],
                                     "k": pool["state"]["kv"]["k"]})


def _port_generate(s, batched: bool):
    model, mta = s["model_t"], s["mta_t"]
    pool = steps.init_decode_pool(model, ROWS, MAX_LEN, CAP, cache_dtype=torch.float32)
    scales = {k: torch.from_numpy(mta.scales(k)) for k in mta.kind_tasks}

    def slots(tasks):
        return {k: torch.from_numpy(v) for k, v in mta.decode_row_slots(tasks).items()}

    tokens = torch.from_numpy(s["tokens"])
    if batched:
        bind = steps.build_decode_batched_bind_step(model, mta, MAX_LEN)
        pool = bind(s["bb_t"], s["ad_t"], pool, torch.from_numpy(BIND_ROWS), tokens,
                    torch.from_numpy(LENGTHS), slots(BIND_TASKS), scales,
                    torch.from_numpy(MAX_NEW), steps.greedy_sampling(len(BIND_ROWS), "cpu"))
    else:
        bind = steps.build_decode_bind_step(model, mta, MAX_LEN)
        for i, row in enumerate(BIND_ROWS):
            pool = bind(s["bb_t"], s["ad_t"], pool, int(row), tokens[i:i + 1],
                        int(LENGTHS[i]), slots(BIND_TASKS[i:i + 1]), scales, int(MAX_NEW[i]))
    micro = steps.build_decode_micro_step(model, mta)
    for _ in range(CAP - 1):
        pool = micro(s["bb_t"], s["ad_t"], pool, slots(POOL_TASKS), scales)
    return {"out": pool["out"].numpy(), "n_out": pool["n_out"].numpy(),
            "active": pool["active"].numpy(), "pos": pool["state"]["pos"].numpy(),
            "lo": pool["state"]["lo"].numpy(), "k": pool["state"]["kv"]["k"].numpy()}


def test_pool_generation_matches_jax(setup):
    j, p = setup["jax_pool"], setup["port_pool"]
    np.testing.assert_array_equal(p["out"], j["out"])
    for key in ("n_out", "active", "pos", "lo"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert list(p["n_out"]) == [6, 3, 0, 5] and not p["active"].any()
    np.testing.assert_allclose(p["k"], j["k"], rtol=1e-4, atol=1e-4)


def test_bind_prefill_logits_match_jax(setup):
    s = setup
    mta, mta_t = s["mta"], s["mta_t"]
    st = s["model"].init_decode_state(None, 3, MAX_LEN, cache_dtype=jnp.float32)
    ctxf = mta.ctx_factory_from_slots(
        {k: jnp.asarray(v) for k, v in mta.decode_row_slots(BIND_TASKS).items()})
    want, _ = s["model"].prefill(s["bb"], {"tokens": jnp.asarray(s["tokens"])}, st,
                                 adapters=s["ad"], ctx_factory=ctxf,
                                 lengths=jnp.asarray(LENGTHS))
    st_t = s["model_t"].init_decode_state(3, MAX_LEN, cache_dtype=torch.float32)
    ctxf_t = mta_t.ctx_factory_from_slots(
        {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(BIND_TASKS).items()})
    got, st_t = s["model_t"].prefill(s["bb_t"], {"tokens": torch.from_numpy(s["tokens"])},
                                     st_t, adapters=s["ad_t"], ctx_factory=ctxf_t,
                                     lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(st_t["pos"].numpy(), LENGTHS)


def test_pool_generation_matches_own_forward_greedy(setup):
    """Each row's generation is the greedy continuation of the port's own
    training-path forward over prompt + generated tokens."""
    s, p = setup, setup["port_pool"]
    for i, row in enumerate(BIND_ROWS):
        n, gen = LENGTHS[i], p["out"][row, :MAX_NEW[i]]
        seq = np.concatenate([s["tokens"][i, :n], gen[:-1]])[None]
        slot = s["mta_t"].decode_row_slots([BIND_TASKS[i]])
        ctxf = s["mta_t"].ctx_factory_from_slots(
            {k: torch.from_numpy(v) for k, v in slot.items()})
        logits = s["model_t"].forward(s["bb_t"], {"tokens": torch.from_numpy(seq)},
                                      adapters=s["ad_t"], ctx_factory=ctxf,
                                      return_logits=True)["logits"]
        np.testing.assert_array_equal(gen, logits[0, n - 1:].argmax(-1).numpy(),
                                      err_msg=f"row {row}")


def test_batched_bind_equals_single_binds(setup):
    single = _port_generate(setup, batched=False)
    batched = setup["port_pool"]
    np.testing.assert_array_equal(single["out"], batched["out"])
    for key in ("n_out", "active", "pos", "lo"):
        np.testing.assert_array_equal(single[key], batched[key], err_msg=key)
    np.testing.assert_allclose(single["k"], batched["k"], rtol=1e-5, atol=1e-5)


def test_engine_entry_points_serve_the_pool(setup):
    """PEFTEngine, built through the ModelGenerator (bf16 caches, as it
    allocates them), binds and generates to completion; its outputs match
    the steps it wraps on the same pool.  Three LoRA tenants get a stack of
    four slots (capacity doubles 1 -> 2 -> 4); the fourth is never routed."""
    s = setup
    cfg_t = smoke_config("llama3.2-3b")
    tasks = [PEFTTask(f"t{i}", AdapterConfig("lora", rank=r, alpha=a, targets=SITES), (LP,), 1)
             for i, (r, a) in enumerate(TENANTS)]
    gen = ModelGenerator(cfg_t, device="cpu")
    reg = gen.register_tasks(tasks)
    assert reg.mta.kind_capacity == {"lora": 4}
    gen.backbone_params = s["bb_t"]
    ad_np = jax.tree.map(lambda a: np.asarray(a, np.float32), s["ad"])
    for site in ad_np["lora"].values():  # pad the JAX stack of 3 to 4 slots
        for leaf, a in site.items():
            site[leaf] = np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)
    reg.adapter_params = adapters_from_numpy(ad_np, reg.mta, "cpu")
    plan = ExecutionPlanner(cfg_t, ParallelismSpec()).plan(tasks)
    eng = PEFTEngine(gen, plan, device="cpu")
    eng.ensure_decode_pool(ROWS, MAX_LEN, CAP)
    assert eng.decode_pool_gen == 1 and eng.decode_prefix_reserve() == 0
    slots, scales = eng.decode_row_ctx(BIND_TASKS)
    eng.dispatch_decode_bind_batched(BIND_ROWS, s["tokens"], LENGTHS, slots, scales, MAX_NEW)
    pool_slots, _ = eng.decode_row_ctx(POOL_TASKS)
    acct = eng.decode_accounting()
    n_steps = 0
    while acct["active"].any():
        eng.dispatch_decode_micro(pool_slots, scales)
        acct = eng.decode_accounting()
        n_steps += 1
    assert n_steps == CAP - 1
    np.testing.assert_array_equal(acct["n_out"], [6, 3, 0, 5])
    np.testing.assert_array_equal(acct["pos"], s["jax_pool"]["pos"])
    ref = steps.init_decode_pool(s["model_t"], ROWS, MAX_LEN, CAP)
    bind = steps.build_decode_batched_bind_step(s["model_t"], s["mta_t"], MAX_LEN)
    micro = steps.build_decode_micro_step(s["model_t"], s["mta_t"])
    ref = bind(s["bb_t"], s["ad_t"], ref, torch.from_numpy(BIND_ROWS),
               torch.from_numpy(s["tokens"]), torch.from_numpy(LENGTHS), slots, scales,
               torch.from_numpy(MAX_NEW), steps.greedy_sampling(3, "cpu"))
    for _ in range(CAP - 1):
        ref = micro(s["bb_t"], s["ad_t"], ref, pool_slots, scales)
    for row in range(ROWS):
        np.testing.assert_array_equal(eng.decode_outputs(row), ref["out"][row].numpy())


def test_sample_tokens_greedy_and_seeded_replay():
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    temp = torch.tensor([0.0, 0.8, 1.2, 0.7])
    top_k = torch.tensor([5, 0, 10, 1], dtype=torch.int32)
    top_p = torch.tensor([0.5, 0.9, 1.0, 1.0])
    rng = torch.tensor([11, 22, 33, 44], dtype=torch.int64)
    tok, rng2 = steps.sample_tokens(logits, temp, top_k, top_p, rng)
    argmax = logits.argmax(-1).to(torch.int32)
    assert tok[0] == argmax[0] and rng2[0] == rng[0]   # temp 0: exact argmax, no draw
    assert tok[3] == argmax[3]                         # top_k 1 keeps only the argmax
    assert torch.all(rng2[1:] != rng[1:])              # sampled rows advance their seed
    tok_b, rng_b = steps.sample_tokens(logits, temp, top_k, top_p, rng)
    assert torch.equal(tok, tok_b) and torch.equal(rng2, rng_b)  # a fixed seed replays
    # greedy everywhere: exact argmax, seeds untouched
    tok_g, rng_g = steps.sample_tokens(logits, torch.zeros(4), top_k, top_p, rng)
    assert torch.equal(tok_g, argmax) and torch.equal(rng_g, rng)
    # a tiny top-p keeps only the most likely token, whatever the seed
    draws = {int(steps.sample_tokens(logits[1:2], temp[1:2], torch.tensor([0], dtype=torch.int32),
                                     torch.tensor([1e-6]), torch.tensor([s]))[0][0])
             for s in range(8)}
    assert draws == {int(argmax[1])}


def test_single_layer_cache_layout_matches_jax():
    """``init_kv_cache`` + ``attention_decode_apply`` (one layer, token by
    token, LoRA-free) against the JAX pair on the same per-row layout, with
    a prefix region reserved and one row's window opened into it."""
    from repro.models import attention as jattn
    from repro.models.layers import materialize
    from repro_torch.models import attention as attn

    cfg = jax_smoke_config("llama3.2-3b")
    p_np = _np_tree(materialize(jattn.attention_spec(cfg), jax.random.PRNGKey(4)))
    p_t = {k: torch.from_numpy(v) for k, v in p_np.items()}
    B, S, pres = 2, 5, 3
    x = np.random.RandomState(6).randn(B, S, cfg.d_model).astype(np.float32)
    pk = np.random.RandomState(7).randn(2, cfg.num_kv_heads, cfg.resolved_head_dim())
    cache = jattn.init_kv_cache(cfg, B, S, dtype=jnp.float32, prefix_reserve=pres,
                                per_row=True)
    cache["k"] = cache["k"].at[0, pres - 2:pres].set(pk.astype(np.float32))
    cache["lo"] = cache["lo"].at[0].set(pres - 2)
    cache_t = attn.init_kv_cache(smoke_config("llama3.2-3b"), B, S, device="cpu",
                                 dtype=torch.float32, prefix_reserve=pres)
    cache_t["k"][0, pres - 2:pres] = torch.from_numpy(pk.astype(np.float32))
    cache_t["lo"][0] = pres - 2
    for s in range(S):
        y, cache = jattn.attention_decode_apply(p_np, jnp.asarray(x[:, s:s + 1]), cfg, cache)
        y_t, cache_t = attn.attention_decode_apply(p_t, torch.from_numpy(x[:, s:s + 1]),
                                                   smoke_config("llama3.2-3b"), cache_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)
    for key in ("len", "t", "lo"):
        np.testing.assert_array_equal(cache_t[key].numpy(), np.asarray(cache[key]))
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache["k"]), rtol=1e-5,
                               atol=1e-5)
