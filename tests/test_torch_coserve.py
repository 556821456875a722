"""Co-serving decode of all eight PEFT kinds in the port, against the JAX
package, and the port's decode scheduler inside the service, on the CPU.

* Fused teacher-forced decode (one pool row per kind, Prefix-Tuning's k/v
  rows folded into the cache's prefix region) gives the JAX package's
  logits at rtol / atol 2e-4, as JAX ``tests/test_coserve.py`` builds it.
* The batched bind (prefill, soft-prompt fold, first token, scatter into
  the pool) and the micro steps after it give JAX ``bind_n``'s cache,
  ``pos``, ``lo``, ``cur`` and ``out``: on the xla tier at
  ``attn_q_block = 128``, and against the Pallas tier in interpret mode at
  ``attn_q_block = 32``, where the prefix padding moves key tiles.
* In the service: training losses with decode traffic equal those without,
  requests live and die with their tenants, a prefix tenant's arrival
  re-allocates the pool and re-binds the requests it held, SLO classes
  preempt, the iteration keeps one host read with decode interleaved, and
  an int8 pool dequantizes only DoRA's sites at decode.

Both sides run float32 weights and caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.models.transformer import build_model
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.methods import get_method as jax_get_method
from repro.peft.methods import method_names as jax_method_names
from repro.peft.multitask import MultiTaskAdapters as JaxMTA
from repro_torch.configs import smoke_config
from repro_torch.convert import adapters_from_numpy, backbone_from_numpy
from repro_torch.core.task import ParallelismSpec
from repro_torch.data.synthetic import make_task
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.transformer import Model
from repro_torch.peft import hooks
from repro_torch.peft.methods import AdapterConfig, method_names
from repro_torch.peft.multitask import MultiTaskAdapters
from repro_torch.serve import CoServeConfig, MuxTuneService, RequestSpec, TenantSpec

KINDS = method_names()
FILLED = ("b", "up", "s", "delta", "dm")  # the leaves that start at zero
S_TF = 5                                   # teacher-forced decode steps
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a) if jnp.issubdtype(a.dtype, jnp.integer)
                        else np.asarray(a, np.float32), tree)


def _pair(q_block):
    """The eight kinds (rank 4, one tenant each) on both sides, f32, with
    every zero-init leaf filled from a numpy seed."""
    cfg = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=q_block)
    model = build_model(cfg)
    bb = _np_tree(model.init(jax.random.PRNGKey(0)))
    mta = JaxMTA(cfg, [JaxAdapterConfig(k, rank=4) for k in KINDS])
    ad = _np_tree(mta.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(0)
    for kind in ad.values():
        for site in kind.values():
            for leaf in FILLED:
                if leaf in site:
                    site[leaf] = (rs.randn(*site[leaf].shape) * 0.05).astype(np.float32)
    cfg_t = smoke_config("llama3.2-3b").with_overrides(attn_q_block=q_block)
    mta_t = MultiTaskAdapters(cfg_t, [AdapterConfig(k, rank=4) for k in KINDS], device="cpu")
    return {"cfg": cfg, "model": model, "mta": mta, "bb": jax.tree.map(jnp.asarray, bb),
            "ad": jax.tree.map(jnp.asarray, ad), "cfg_t": cfg_t,
            "model_t": Model(cfg_t, device="cpu"), "mta_t": mta_t,
            "bb_t": backbone_from_numpy(bb, cfg_t, "cpu", torch.float32),
            "ad_t": adapters_from_numpy(ad, mta_t, "cpu"),
            "pres": jsteps.decode_prefix_reserve(mta)}


@pytest.fixture(scope="module")
def pair():
    return _pair(128)


def _jax_fold(cfg, mta, params, state, row, task, pres):
    """The JAX test's mirror of the bind's fold, for one row (the port's
    side runs ``steps.fold_soft_prompts``)."""
    kind = mta.task_cfgs[task].kind
    if not jax_get_method(kind).uses_attention_prefix:
        return state
    slot = int(mta.task_slot[task])
    pk = params[kind]["attn_prefix"]["pk"][:, slot]
    pv = params[kind]["attn_prefix"]["pv"][:, slot]
    L, P, _ = pk.shape
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    state = dict(state)
    state["kv"] = {"k": state["kv"]["k"].at[:, row, pres - P:pres].set(pk.reshape(L, P, hkv, dh)),
                   "v": state["kv"]["v"].at[:, row, pres - P:pres].set(pv.reshape(L, P, hkv, dh))}
    state["lo"] = state["lo"].at[row].set(pres - P)
    return state


@pytest.fixture(scope="module")
def teacher_forced(pair):
    """[B, S, V] logits of one fused pool (row r = kind r), each side."""
    p, n, pres = pair, len(KINDS), pair["pres"]
    tokens = np.random.RandomState(7).randint(1, p["cfg"].vocab_size, S_TF).astype(np.int32)
    rt = list(range(n))
    st = p["model"].init_decode_state(None, n, S_TF + 1, cache_dtype=jnp.float32,
                                      prefix_reserve=pres, per_row=True)
    for r in rt:
        st = _jax_fold(p["cfg"], p["mta"], p["ad"], st, r, r, pres)
    ctxf = p["mta"].ctx_factory_from_slots(
        {k: jnp.asarray(v) for k, v in p["mta"].decode_row_slots(rt).items()})

    @jax.jit
    def jstep(st, tok):
        return p["model"].decode_step(p["bb"], st, tok, adapters=p["ad"], ctx_factory=ctxf,
                                      prefix_reserve=pres)

    want = []
    for s in range(S_TF):
        lg, st = jstep(st, jnp.broadcast_to(jnp.asarray(tokens[s]), (n, 1)))
        want.append(np.asarray(lg[:, 0], np.float32))
    pst = p["model_t"].init_decode_state(n, S_TF + 1, cache_dtype=torch.float32,
                                         prefix_reserve=pres)
    slots = {k: torch.from_numpy(v) for k, v in p["mta_t"].decode_row_slots(rt).items()}
    steps.fold_soft_prompts(p["model_t"], p["mta_t"], p["ad_t"], slots, pst, pres)
    pctxf = p["mta_t"].ctx_factory_from_slots(slots)
    got = []
    with torch.no_grad():
        for s in range(S_TF):
            lg, pst = p["model_t"].decode_step(
                p["bb_t"], pst, torch.full((n, 1), int(tokens[s]), dtype=torch.int32),
                adapters=p["ad_t"], ctx_factory=pctxf, prefix_reserve=pres)
            got.append(lg[:, 0].numpy())
    return np.stack(want, 1), np.stack(got, 1)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_decode_matches_jax(teacher_forced, kind):
    assert KINDS == jax_method_names()
    want, got = teacher_forced
    r = KINDS.index(kind)
    np.testing.assert_allclose(got[r], want[r], err_msg=kind, **TOL)
    # each kind's adapter moved its row off the bare backbone's logits
    others = [got[i] for i in range(len(KINDS)) if i != r]
    assert all(np.abs(got[r] - o).max() > 1e-4 for o in others)


def _bind_both(p, tier):
    """Bind R = 8 requests (one per kind, true lengths 3..16 in one
    16-token bucket, 8 rows) into an f32 pool and run 3 micro steps, on
    each side."""
    n, pres, ML, CAP, LP = len(KINDS), p["pres"], 32, 6, 16
    rs = np.random.RandomState(3)
    lengths = rs.randint(3, LP + 1, n).astype(np.int32)
    lengths[KINDS.index("prefix")] = 5
    tokens = np.zeros((n, LP), np.int32)
    for i, m in enumerate(lengths):
        tokens[i, :m] = rs.randint(1, p["cfg"].vocab_size, m)
    rows = np.asarray([3, 0, 7, 1, 6, 2, 5, 4], np.int32)  # request i -> pool row
    tasks = np.arange(n, dtype=np.int32)
    pool_tasks = np.empty(n, np.int32)
    pool_tasks[rows] = tasks
    max_new = np.full((n,), CAP, np.int32)
    mta, mta_t = p["mta"], p["mta_t"]
    prev = jops.get_impl()
    jops.set_impl(tier)
    try:
        pool = jsteps.init_decode_pool(p["model"], n, ML, CAP, prefix_reserve=pres,
                                       cache_dtype=jnp.float32)
        bind = jsteps.build_decode_batched_bind_step(p["model"], mta, ML, pres)
        micro = jsteps.build_decode_micro_step(p["model"], mta, pres)
        scales = {k: jnp.asarray(mta.scales(k)) for k in mta.kind_tasks}

        def js(t):
            return {k: jnp.asarray(v) for k, v in mta.decode_row_slots(t).items()}

        pool = bind(p["bb"], p["ad"], pool, jnp.asarray(rows), jnp.asarray(tokens),
                    jnp.asarray(lengths), js(tasks), scales, jnp.asarray(max_new),
                    jsteps.greedy_sampling(n))
        jb = jax.tree.map(np.asarray, pool)
        for _ in range(3):
            pool = micro(p["bb"], p["ad"], pool, js(pool_tasks), scales)
        jm = jax.tree.map(np.asarray, pool)
    finally:
        jops.set_impl(prev)
    ppool = steps.init_decode_pool(p["model_t"], n, ML, CAP, prefix_reserve=pres,
                                   cache_dtype=torch.float32)
    pbind = steps.build_decode_batched_bind_step(p["model_t"], mta_t, ML, pres)
    pmicro = steps.build_decode_micro_step(p["model_t"], mta_t, pres)
    pscales = {k: torch.from_numpy(mta_t.scales(k)) for k in mta_t.kind_tasks}

    def ps(t):
        return {k: torch.from_numpy(v) for k, v in mta_t.decode_row_slots(t).items()}

    with torch.no_grad():
        ppool = pbind(p["bb_t"], p["ad_t"], ppool, torch.from_numpy(rows),
                      torch.from_numpy(tokens), torch.from_numpy(lengths), ps(tasks), pscales,
                      torch.from_numpy(max_new), steps.greedy_sampling(n, "cpu"), [])
        pb = _pool_np(ppool)
        for _ in range(3):
            ppool = pmicro(p["bb_t"], p["ad_t"], ppool, ps(pool_tasks), pscales, [])
    return jb, pb, jm, _pool_np(ppool), rows


def _pool_np(pool):
    return {"state": {"kv": {k: v.numpy().copy() for k, v in pool["state"]["kv"].items()},
                      "pos": pool["state"]["pos"].numpy().copy(),
                      "lo": pool["state"]["lo"].numpy().copy()},
            **{k: pool[k].numpy().copy() for k in ("cur", "out", "n_out", "active")}}


@pytest.mark.parametrize("tier,q_block", [("xla", 128), ("pallas_interpret", 32)])
def test_batched_bind_and_micro_steps_match_jax(tier, q_block):
    p = _pair(q_block)
    jb, pb, jm, pm, rows = _bind_both(p, tier)
    pres = p["pres"]
    P = 4  # the prefix tenant's rank: its soft-prompt rows
    prow = rows[KINDS.index("prefix")]
    want_lo = np.full(len(KINDS), pres, np.int32)
    want_lo[prow] = pres - P
    for name, j, g in (("bind", jb, pb), ("micro", jm, pm)):
        np.testing.assert_array_equal(g["state"]["lo"], want_lo, err_msg=name)
        for key in ("cur", "out", "n_out", "active"):
            np.testing.assert_array_equal(g[key], j[key], err_msg=f"{name} {key}")
        for key in ("pos", "lo"):
            np.testing.assert_array_equal(g["state"][key], j["state"][key],
                                          err_msg=f"{name} {key}")
        for key in ("k", "v"):
            np.testing.assert_allclose(g["state"]["kv"][key], j["state"]["kv"][key],
                                       err_msg=f"{name} {key}", **TOL)
    assert list(pm["n_out"]) == [4] * len(KINDS)
    # the prefix row's region holds its pk / pv rows; the others' stays 0
    pk = p["ad_t"]["prefix"]["attn_prefix"]["pk"][:, 0].numpy()
    L = pk.shape[0]
    np.testing.assert_array_equal(pb["state"]["kv"]["k"][:, prow, pres - P:pres].reshape(L, P, -1),
                                  pk)
    others = [r for r in range(len(KINDS)) if r != prow]
    assert not pb["state"]["kv"]["k"][:, others, :pres].any()


# ---------------------------------------------------------------------------
# the decode scheduler in the service (the port alone)

CFG = smoke_config("llama3.2-3b")


def _service(**kw):
    kw.setdefault("lr", 5e-3)
    kw.setdefault("n_micro", 1)
    kw.setdefault("enable_fusion", False)
    kw.setdefault("reserve_slots", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("auto_recalibrate", False)
    kw.setdefault("coserve", CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8,
                                           slo_seconds=1.0))
    return MuxTuneService(CFG, ParallelismSpec(), device="cpu", **kw)


def _task(tid, ds, kind, seed, rank=4):
    return make_task(tid, ds, 2, AdapterConfig(kind, rank=rank), seed=seed)


def test_service_coserve_training_loss_parity():
    """Interleaved decode traffic leaves training untouched: the per-task
    losses equal the traffic-free run's (rtol 2e-4), every request
    completes with its tokens, and p50 / p99 and billing are recorded."""
    def run(with_traffic):
        svc = _service()
        svc.submit(TenantSpec(_task("a", "sst2", "lora", 0), target_steps=5))
        svc.submit(TenantSpec(_task("b", "qa", "prefix", 1), target_steps=5))
        if with_traffic:
            svc.submit_request("a", RequestSpec([3, 5, 7], max_new_tokens=5))
            svc.submit_request("b", RequestSpec([2, 4, 6, 8], max_new_tokens=4))
        losses, dec = [], 0
        for _ in range(5):
            m = svc.step()
            losses.append(np.asarray(m.per_task_loss))
            dec += m.decode_tokens
        return svc, np.asarray(losses), dec

    _, ref_losses, ref_dec = run(False)
    svc, losses, dec = run(True)
    assert ref_dec == 0 and dec == 9
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-4)
    acc = svc.accounting()["coserve"]
    assert acc["completed_requests"] == 2
    assert acc["decode_p99_s"] >= acc["decode_p50_s"] > 0.0
    for req in svc.coserve.requests.values():
        assert req.state == "done" and len(req.tokens_out) == req.max_new_tokens
    assert svc.record("a").decode_tokens == 5 and svc.record("b").decode_tokens == 4


def test_service_coserve_request_lifecycle_on_churn():
    """Requests of a departing tenant are cancelled; one for a tenant not
    yet resident waits without blocking ready traffic; the last tenant out
    drops the engine and a new one serves from a fresh pool."""
    svc = _service()
    svc.submit(TenantSpec(_task("a", "sst2", "lora", 0), target_steps=8))
    r_ghost = svc.submit_request("ghost", RequestSpec([1, 2], max_new_tokens=2))
    r_a = svc.submit_request("a", RequestSpec([3, 5], max_new_tokens=3))
    svc.step()
    assert r_a.state in ("decoding", "done") and r_ghost.state == "pending"
    svc.step()
    assert r_a.state == "done"
    r_b = svc.submit_request("a", RequestSpec([4, 4], max_new_tokens=100))
    assert r_b.state == "rejected" and r_b.reason == "length_caps"
    r_c = svc.submit_request("a", RequestSpec([9, 9], max_new_tokens=2))
    svc.cancel("a")
    assert r_c.state == "cancelled" and r_c.reason == "tenant_departed"
    assert svc.engine is None
    svc.submit(TenantSpec(_task("c", "sst2", "dora", 3), target_steps=8))
    r_d = svc.submit_request("c", RequestSpec([5, 6], max_new_tokens=2))
    svc.step()
    svc.step()
    assert r_d.state == "done" and len(r_d.tokens_out) == 2


def test_prefix_arrival_reallocates_the_pool_and_rebinds():
    """A request in flight on a LoRA tenant's row; a prefix tenant attaches
    and widens the prefix region: the pool is re-allocated
    (``decode_pool_gen``), the request is re-queued and bound again, and
    its greedy tokens equal those of a run without the arrival."""
    def run(arrive):
        svc = _service(coserve=CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8,
                                             slo_seconds=1.0, max_tokens_per_iter=2))
        svc.submit(TenantSpec(_task("a", "sst2", "lora", 0), target_steps=8))
        req = svc.submit_request("a", RequestSpec([3, 1, 4, 1, 5], max_new_tokens=8))
        svc.step()
        gen0 = svc.engine.decode_pool_gen
        assert req.state == "decoding"
        if arrive:
            svc.submit(TenantSpec(_task("b", "qa", "prefix", 1, rank=6), target_steps=8))
        for _ in range(5):
            svc.step()
        return req, gen0, svc

    ref, _, _ = run(False)
    req, gen0, svc = run(True)
    assert svc.engine.decode_pool_gen == gen0 + 1
    assert svc.engine.decode_prefix_reserve() == 6
    assert req.state == ref.state == "done"
    np.testing.assert_array_equal(req.tokens_out, ref.tokens_out)
    assert req.bind_clock == 1  # bound again after the re-allocation


def test_slo_class_preemption():
    """A strictly higher-class request queued with no free row evicts the
    lowest-class in-flight row, which re-queues and completes later."""
    svc = _service(coserve=CoServeConfig(decode_slots=1, decode_max_len=32, max_new_cap=8,
                                         slo_seconds=1.0, max_tokens_per_iter=2))
    svc.submit(TenantSpec(_task("a", "sst2", "lora", 0), target_steps=12))
    low = svc.submit_request("a", RequestSpec([3, 1, 4], max_new_tokens=8, slo_class=2))
    svc.step()
    assert low.state == "decoding"
    high = svc.submit_request("a", RequestSpec([2, 7], max_new_tokens=2, slo_class=0))
    svc.step()
    assert svc.coserve.preemptions == 1 and high.state == "done"
    for _ in range(6):
        svc.step()
    assert low.state == "done" and len(low.tokens_out) == 8
    assert low.bind_clock == 2  # bound again after the eviction
    att = svc.coserve.slo_attainment()
    assert att["slo_met"] + att["slo_missed"] == 2


def test_hybrid_family_rejects_requests():
    svc = MuxTuneService(smoke_config("zamba2-2.7b"), ParallelismSpec(), device="cpu",
                         enable_fusion=False, coserve=CoServeConfig())
    r = svc.submit_request("a", RequestSpec([1, 2, 3], max_new_tokens=2))
    assert r.state == "rejected" and r.reason == "family_unsupported"


def test_iteration_keeps_one_host_read_with_decode_interleaved(monkeypatch):
    """With bound rows generating between the training micro steps, the
    engine's iteration reads from its device once (the loss read), and each
    greedy micro step reads nothing: the host mirror of the sampled rows
    stands in for ``temp``."""
    svc = _service(coserve=CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8,
                                         slo_seconds=1.0))
    svc.submit(TenantSpec(_task("a", "sst2", "lora", 0), target_steps=8))
    svc.submit(TenantSpec(_task("b", "qa", "lora", 1), target_steps=8))
    svc.submit_request("a", RequestSpec([3, 5, 7], max_new_tokens=2))
    svc.step()  # warm: the micro step has run once
    svc.submit_request("a", RequestSpec([4, 4, 4], max_new_tokens=8))
    svc.submit_request("b", RequestSpec([1, 2], max_new_tokens=8))
    reads = []
    for name in ("cpu", "item", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _n=name, _r=real, **k: reads.append(_n)
                            or _r(self, *a, **k))
    real_iter = svc.engine.run_iteration
    counted = {}

    def run_iteration(*a, **k):
        reads.clear()
        out = real_iter(*a, **k)
        counted["iteration"] = list(reads)
        return out

    monkeypatch.setattr(svc.engine, "run_iteration", run_iteration)
    svc.step()
    monkeypatch.undo()
    assert svc.coserve.mid_iteration_binds + svc.coserve.last_bind_count >= 1
    # one read: the accumulated losses at the iteration's end (``.cpu()``
    # then ``.numpy()`` of that one tensor)
    assert counted["iteration"] == ["cpu", "numpy"]


def test_int8_dora_dequantizes_its_sites_only_at_decode(monkeypatch):
    """An int8 pool with a DoRA tenant on attn_q and a LoRA tenant on attn_v
    / attn_o: the bind and each decode micro step build the dense weight
    once per layer at DoRA's site (w_q), never at another site."""
    cfg = smoke_config("llama3.2-3b").with_overrides(backbone_dtype="int8")
    tasks = [make_task("d", "sst2", 2, AdapterConfig("dora", rank=4, targets=("attn_q",))),
             make_task("l", "qa", 2, AdapterConfig("lora", rank=4,
                                                   targets=("attn_v", "attn_o")))]
    from repro_torch.core import ExecutionPlanner, ModelGenerator, PEFTEngine

    gen = ModelGenerator(cfg, device="cpu")
    gen.register_tasks(tasks)
    eng = PEFTEngine(gen, ExecutionPlanner(cfg, ParallelismSpec()).plan(tasks), device="cpu")
    eng.ensure_decode_pool(2, 24, 4)
    built = []
    real = hooks.dequantize
    monkeypatch.setattr(hooks, "dequantize",
                        lambda w, dtype: built.append(tuple(w["q"].shape)) or real(w, dtype))
    slots, scales = eng.decode_row_ctx([0, 1])
    with torch.no_grad():
        eng.dispatch_decode_bind_batched(np.arange(2), np.ones((2, 8), np.int32),
                                         np.asarray([8, 5]), slots, scales, np.asarray([4, 4]))
        d, h, dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim()
        assert built == [(d, h, dh)] * cfg.num_layers
        for _ in range(3):
            built.clear()
            eng.dispatch_decode_micro(slots, scales)
            assert built == [(d, h, dh)] * cfg.num_layers
    assert list(eng.decode_accounting()["n_out"]) == [4, 4]
