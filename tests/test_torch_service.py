"""The port's online service (``repro_torch.serve``) and tenant churn against
the JAX package, at smoke size on the CPU.

* The registry's churn (``register_tasks`` on a registered instance,
  ``deregister_tasks``, ``compact``) gives the JAX package's slots, stack
  capacities and stack ranks, and migrates the survivors' adapter values
  and AdamW moments as it does.
* ``slice_task_tree`` / ``load_task_tree`` artifacts cross between the
  packages bit for bit.
* The churn scenario of the JAX ``tests/test_service.py``, widened to three
  PEFT kinds (LoRA A stays; a Prefix-Tuning tenant B completes and is
  checkpointed out, then comes back warm-started; a second LoRA tenant C is
  cancelled; a VeRA tenant D waits in the queue under the memory budget
  until B is gone), with decode requests to every tenant: A's losses equal
  a solo run's, every tenant's per-iteration losses equal the JAX
  service's (rtol 2e-4) with JAX's fresh slots carried across after every
  registration change, the greedy tokens equal JAX's, and step closures
  are reused across re-plans.
* Admission decisions, the wait queue, the decode-token cost term and the
  profile calibration equal the JAX package's.

Both sides run float32 adapters and backbone: the adapter stacks' init is
widened to f32 in both packages for these tests (their own stacks are
bf16), and the backbone is the JAX service's, widened and carried across.
The JAX side runs the ``xla`` tier at ``attn_q_block = 128``, where its
prefix carry and the port's padded prefix rows see the same keys.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import cost_model as jcm
from repro.core.fusion import build_htask as jax_build_htask
from repro.core.registry import ModelGenerator as JaxGenerator
from repro.core.registry import load_task_tree as jax_load_task_tree
from repro.core.registry import slice_task_tree as jax_slice_task_tree
from repro.core.task import ParallelismSpec as JaxParallelism
from repro.data.synthetic import make_task as jax_make_task
from repro.distributed.checkpoint import CheckpointStore as JaxStore
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro.peft.multitask import MultiTaskAdapters as JaxMTA
from repro import serve as jserve
from repro_torch.configs import smoke_config
from repro_torch.convert import backbone_from_numpy, registration_from_numpy
from repro_torch.core import cost_model as pcm
from repro_torch.core.fusion import build_htask
from repro_torch.core.registry import ModelGenerator, load_task_tree, slice_task_tree
from repro_torch.core.task import ParallelismSpec
from repro_torch.data.synthetic import make_task
from repro_torch.distributed.checkpoint import CheckpointStore
from repro_torch.peft.methods import AdapterConfig
from repro_torch.peft.multitask import MultiTaskAdapters as PortMTA
from repro_torch import serve as pserve
from repro_torch.train.optimizer import tree_map

Q_BLOCK = 128
JCFG = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=Q_BLOCK)
PCFG = smoke_config("llama3.2-3b").with_overrides(attn_q_block=Q_BLOCK)
JAX_HW = pcm.HardwareProfile(peak_flops=jcm.PEAK_FLOPS, hbm_bw=jcm.HBM_BW, ici_bw=jcm.ICI_BW)
LOSS_RTOL = 2e-4

JAX_NS = types.SimpleNamespace(
    make_task=jax_make_task, AdapterConfig=JaxAdapterConfig, TenantSpec=jserve.TenantSpec,
    RequestSpec=jserve.RequestSpec, CoServeConfig=jserve.CoServeConfig,
    AdmissionConfig=jserve.AdmissionConfig)
PORT_NS = types.SimpleNamespace(
    make_task=make_task, AdapterConfig=AdapterConfig, TenantSpec=pserve.TenantSpec,
    RequestSpec=pserve.RequestSpec, CoServeConfig=pserve.CoServeConfig,
    AdmissionConfig=pserve.AdmissionConfig)


def np_tree(tree):
    """A JAX tree as numpy: integer leaves as they are, the rest f32."""
    return jax.tree.map(lambda a: np.asarray(a) if jnp.issubdtype(a.dtype, jnp.integer)
                        else np.asarray(a, np.float32), tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v
    return out


def as_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@contextlib.contextmanager
def f32_adapters():
    """Both packages' fresh adapter stacks in f32 (their own are bf16)."""
    mp = pytest.MonkeyPatch()
    jinit, pinit = JaxMTA.init, PortMTA.init
    mp.setattr(JaxMTA, "init", lambda self, key: jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jinit(self, key)))
    mp.setattr(PortMTA, "init", lambda self, g: tree_map(
        lambda t: t.float() if t.is_floating_point() else t, pinit(self, g)))
    try:
        yield
    finally:
        mp.undo()


def record_registrations(jgen):
    """Wrap a JAX generator's rebuild: every registration it makes (after a
    register, deregister or compact) is appended as numpy to the list
    returned."""
    snaps, orig = [], jgen._rebuild

    def rebuild(tasks, old, compact=False):
        reg = orig(tasks, old, compact)
        snaps.append({"ids": [t.task_id for t in reg.tasks],
                      "slot": np.asarray(reg.mta.task_slot),
                      "caps": dict(reg.mta.kind_capacity), "ranks": dict(reg.mta.kind_rank),
                      "params": np_tree(reg.adapter_params), "m": np_tree(reg.opt_state.m),
                      "v": np_tree(reg.opt_state.v)})
        return reg

    jgen._rebuild = rebuild
    return snaps


def replay_registrations(pgen, snaps):
    """Wrap the port generator's rebuild: after each of its registrations,
    check it against the JAX one of the same index (tasks, slots,
    capacities, stack ranks) and write JAX's fresh tenants' slots into it
    (the survivors keep what the port migrated)."""
    orig, seen = pgen._rebuild, []

    def rebuild(tasks, old, compact=False):
        old_ids = {t.task_id for t in old.tasks} if old else set()
        reg = orig(tasks, old, compact)
        snap = snaps[len(seen)]
        seen.append(snap)
        assert [t.task_id for t in reg.tasks] == snap["ids"]
        np.testing.assert_array_equal(reg.mta.task_slot, snap["slot"])
        assert reg.mta.kind_capacity == snap["caps"] and reg.mta.kind_rank == snap["ranks"]
        fresh = [t.task_id for t in reg.tasks if t.task_id not in old_ids]
        registration_from_numpy(reg, snap["params"], snap["m"], snap["v"], snap["slot"],
                                task_ids=fresh)
        return reg

    pgen._rebuild = rebuild
    return seen


# ---------------------------------------------------------------------------
# the churn scenario, on either package


def tenants(ns):
    def t(tid, ds, kind, rank, seed, mb=2):
        return ns.make_task(tid, ds, mb, ns.AdapterConfig(kind, rank=rank), seed=seed)

    return {"a": t("a", "sst2", "lora", 4, 0), "b": t("b", "qa", "prefix", 4, 1),
            "c": t("c", "rte", "lora", 4, 2), "d": t("d", "sst2", "vera", 8, 3, mb=8)}


def churn_budget(ns, admission_cls):
    """Eq. 5 bytes of {A, B, C}: C is admitted beside A and B; D (a larger
    micro-batch) waits while B is resident, and fits beside A alone."""
    t = tenants(ns)
    probe = admission_cls(JCFG if ns is JAX_NS else PCFG,
                          JaxParallelism() if ns is JAX_NS else ParallelismSpec())
    m = probe.resident_memory
    abc, abd, ad = m([t["a"], t["b"], t["c"]]), m([t["a"], t["b"], t["d"]]), m([t["a"], t["d"]])
    assert abd > abc >= ad
    return abc


def run_churn(svc, ns, ckpt_dir, requests=True):
    """A (5 steps) and B (3) at clock 0; C (50, a second LoRA tenant, which
    lands in A's reserved slot, so that A's and B's steps are reused) and D
    (1, queued) at clock 1; C cancelled at clock 2; B completes at clock 3
    and D is admitted; B is resubmitted (1 step) to warm-start from its
    artifact and waits for room; D completes at clock 4, B is admitted, and
    A and B complete at clock 5.  Decode requests go to A and B at clock 0,
    to C and D at clock 1 and to the warm-started B at clock 3.  Returns the per-iteration per-task
    losses, the records of the events and the requests."""
    t = tenants(ns)
    S, R = ns.TenantSpec, ns.RequestSpec
    losses, reqs, notes = [], {}, {}

    def tick():
        ids = [x.task_id for x in svc.plan.tasks]
        m = svc.step()
        losses.append({tid: float(m.per_task_loss[i]) for i, tid in enumerate(ids)})

    def ask(tid, n, new, seed):
        if requests:
            prompt = np.random.RandomState(seed).randint(1, 200, n)
            r = svc.submit_request(tid, R(prompt, max_new_tokens=new))
            reqs[r.request_id] = r

    svc.submit(S(t["a"], target_steps=5))
    svc.submit(S(t["b"], target_steps=3))
    ask("a", 7, 5, 0)
    ask("b", 12, 4, 1)
    tick()
    svc.submit(S(t["c"], target_steps=50))
    notes["d_at_submit"] = svc.submit(S(t["d"], target_steps=1)).state
    ask("c", 5, 3, 2)
    ask("d", 9, 4, 3)
    tick()
    svc.cancel("c")
    notes["d_after_cancel"] = svc.record("d").state
    tick()
    notes["b_done"] = (svc.record("b").state, svc.record("b").checkpoint_path)
    notes["d_after_b"] = svc.record("d").state
    notes["resident_after_b"] = list(svc.resident_ids)
    notes["b_again"] = svc.submit(S(t["b"], target_steps=1,
                                    warm_start_dir=f"{ckpt_dir}/b")).state
    ask("b", 6, 3, 4)
    tick()
    notes["b_after_d"] = svc.record("b").state
    tick()
    return losses, reqs, notes


def make_service(mod, ns, ckpt_dir, budget, **kw):
    args = dict(lr=5e-3, n_micro=1, enable_fusion=False, reserve_slots=2, seed=0,
                auto_recalibrate=False, ckpt_dir=ckpt_dir,
                admission=ns.AdmissionConfig(memory_budget=budget),
                coserve=ns.CoServeConfig(decode_slots=2, decode_max_len=32, max_new_cap=8,
                                         slo_seconds=1.0))
    args.update(kw)
    if mod is pserve:
        return mod.MuxTuneService(PCFG, ParallelismSpec(), hw=JAX_HW, device="cpu", **args)
    return mod.MuxTuneService(JCFG, JaxParallelism(), **args)


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    """The scenario once on the JAX service and once on the port's, from
    the same backbone and the same fresh slots."""
    root = tmp_path_factory.mktemp("churn")
    with f32_adapters():
        jsvc = make_service(jserve, JAX_NS, str(root / "jax"),
                            churn_budget(JAX_NS, jserve.AdmissionController))
        bb_np = np_tree(jsvc.gen.init_backbone())
        jsvc.gen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
        snaps = record_registrations(jsvc.gen)
        jres = run_churn(jsvc, JAX_NS, str(root / "jax"))

        psvc = make_service(pserve, PORT_NS, str(root / "port"),
                            churn_budget(PORT_NS, pserve.AdmissionController))
        psvc.gen.backbone_params = backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32)
        seen = replay_registrations(psvc.gen, snaps)
        pres = run_churn(psvc, PORT_NS, str(root / "port"))
    return {"jax": jres, "port": pres, "jsvc": jsvc, "psvc": psvc, "snaps": snaps,
            "seen": seen, "bb_np": bb_np, "root": root}


def test_churn_events_as_in_jax(churn):
    (_, _, jn), (_, _, pn) = churn["jax"], churn["port"]
    assert pn["d_at_submit"] == jn["d_at_submit"] == "queued"
    assert pn["d_after_cancel"] == "queued" and pn["d_after_b"] == "running"
    assert pn["b_done"][0] == jn["b_done"][0] == "completed"
    assert pn["resident_after_b"] == jn["resident_after_b"] == ["a", "d"]
    assert pn["b_again"] == jn["b_again"] == "queued"
    assert pn["b_after_d"] == jn["b_after_d"] == "running"
    assert len(churn["seen"]) == len(churn["snaps"]) >= 6
    psvc = churn["psvc"]
    assert psvc.record("c").state == "cancelled"
    # the warm start found its artifact (the reason is the queue's)
    assert psvc.record("b").state == "completed" and psvc.record("b").reason == "memory"
    assert [r.state for r in psvc.retired] == ["completed"]
    assert psvc.engine is None and psvc.accounting()["completed"] == 4


def test_churn_losses_match_jax_service(churn):
    (jl, _, _), (pl, _, _) = churn["jax"], churn["port"]
    assert [sorted(x) for x in pl] == [sorted(x) for x in jl] == [
        ["a", "b"], ["a", "b", "c"], ["a", "b"], ["a", "d"], ["a", "b"]]
    for it, (p, j) in enumerate(zip(pl, jl)):
        for tid in j:
            np.testing.assert_allclose(p[tid], j[tid], rtol=LOSS_RTOL,
                                       err_msg=f"iteration {it} tenant {tid}")


def test_churn_greedy_tokens_match_jax_service(churn):
    (_, jr, _), (_, pr, _) = churn["jax"], churn["port"]
    assert sorted(pr) == sorted(jr)
    states = {rid: (r.state, r.reason) for rid, r in pr.items()}
    assert states == {rid: (r.state, r.reason) for rid, r in jr.items()}
    done = [rid for rid, (s, _) in states.items() if s == "done"]
    assert len(done) >= 4
    for rid in done:
        assert len(pr[rid].tokens_out) == pr[rid].max_new_tokens
        np.testing.assert_array_equal(pr[rid].tokens_out, jr[rid].tokens_out, err_msg=rid)
    # the warm-started B's request was served by its reloaded adapter
    assert any(r.task_id == "b" and r.submit_clock == 3 and r.state == "done"
               for r in pr.values())


def test_churn_resident_tenant_matches_solo_run(churn, tmp_path):
    """A trains as a solo A-only service does, across every re-plan."""
    with f32_adapters():
        solo = make_service(pserve, PORT_NS, str(tmp_path), 1e18)
        solo.gen.backbone_params = backbone_from_numpy(churn["bb_np"], PCFG, "cpu",
                                                       torch.float32)
        first, last = churn["snaps"][0], churn["snaps"][-1]
        assert first["ids"] == ["a"] and last["ids"] == []
        replay_registrations(solo.gen, [first, last])
        solo.submit(pserve.TenantSpec(tenants(PORT_NS)["a"], target_steps=5))
        solo_losses = [solo.step().per_task_loss[0] for _ in range(5)]
    churn_losses = [x["a"] for x in churn["port"][0]]
    np.testing.assert_allclose(churn_losses, solo_losses, rtol=LOSS_RTOL)


def test_churn_reuses_steps_and_accounts(churn):
    acct = churn["psvc"].accounting()
    jacct = churn["jsvc"].accounting()
    assert acct["cache_hits"] > 0 and acct["replans"] >= 4
    assert acct["replans"] == jacct["replans"]
    by_id = {r["task_id"]: r for r in acct["tenants"]}
    jby_id = {r["task_id"]: r for r in jacct["tenants"]}
    for tid in ("a", "c", "d"):
        for key in ("state", "queue_wait", "steps_trained", "tokens", "effective_tokens",
                    "makespan"):
            assert by_id[tid][key] == jby_id[tid][key], (tid, key)
    co = acct["coserve"]
    assert co["decode_p99_s"] >= co["decode_p50_s"] > 0
    assert max(churn["psvc"].memory_trace) <= churn["psvc"].admission_config.memory_budget


def test_checkpoint_out_artifact_and_warm_start(churn):
    """B's completion artifact holds exactly the adapter slice it trained
    (read back against the JAX artifact), and the warm-started B begins
    from it."""
    root = churn["root"]
    jstore, pstore = JaxStore(str(root / "jax" / "b")), CheckpointStore(str(root / "port" / "b"))
    assert pstore.latest_step() == jstore.latest_step() == 3
    assert pstore.read_extra()["steps_trained"] == 3
    jmta = JaxMTA(JCFG, [JaxAdapterConfig("prefix", rank=4)])
    pmta = PortMTA(PCFG, [AdapterConfig("prefix", rank=4)], device="cpu")
    like_p = slice_task_tree(PCFG, pmta, pmta.init(torch.Generator().manual_seed(0)), 0)
    _, got, _ = pstore.restore(like_p)
    like_j = jax_slice_task_tree(JCFG, jmta, np_tree(jmta.init(jax.random.PRNGKey(0))), 0)
    _, want, _ = jstore.restore(like_j)
    gf, wf = flat(got), flat(np_tree(want))
    assert sorted(gf) == sorted(wf) == [("prefix", "attn_prefix", "pk"),
                                        ("prefix", "attn_prefix", "pv")]
    for k in gf:
        np.testing.assert_allclose(as_np(gf[k]), wf[k], rtol=1e-4, atol=1e-5)
    assert churn["psvc"].record("b").warm_start_dir.endswith("/b")


# ---------------------------------------------------------------------------
# the registry's churn


def _random_state(jreg, rs):
    """Random adapter values and moments in the JAX registration (numpy),
    integer and shared leaves kept."""
    def fill(tree, pos):
        def leaf(path, a):
            if a is None or np.issubdtype(a.dtype, np.integer) or path[-1].key in ("A", "B"):
                return a
            x = rs.randn(*a.shape).astype(np.float32)
            return np.abs(x) if pos else x * 0.05
        return jax.tree_util.tree_map_with_path(leaf, tree)

    return fill(np_tree(jreg.adapter_params), False), fill(np_tree(jreg.opt_state.m), False), \
        fill(np_tree(jreg.opt_state.v), True)


def test_registry_churn_matches_jax():
    """Register, register more (a stack rank grows, a capacity doubles),
    deregister, register into the freed slot, compact: after each, the same
    slots, capacities and stack ranks as the JAX generator, and the
    survivors' migrated values and moments equal JAX's."""
    def tasks(ns, spec):
        return [ns.make_task(tid, "sst2", 2, ns.AdapterConfig(kind, rank=r), seed=i)
                for i, (tid, kind, r) in enumerate(spec)]

    ops = [("register", [("t0", "lora", 4), ("t1", "prefix", 8), ("t2", "lora", 8)]),
           ("register", [("t3", "dora", 4), ("t4", "lora", 16), ("t5", "vera", 8)]),
           ("deregister", ["t0", "t3"]),
           ("register", [("t6", "lora", 4), ("t7", "dora", 8)]),
           ("compact", None)]
    rs = np.random.RandomState(0)
    with f32_adapters():
        jgen, pgen = JaxGenerator(JCFG, seed=0), ModelGenerator(PCFG, device="cpu")
        for op, arg in ops:
            before = {}
            if pgen.registered is not None:
                # both start the op from the same random state
                p, m, v = _random_state(jgen.registered, rs)
                jreg = jgen.registered
                jreg.adapter_params = jax.tree.map(jnp.asarray, p)
                jreg.opt_state = jreg.opt_state._replace(m=jax.tree.map(jnp.asarray, m),
                                                         v=jax.tree.map(jnp.asarray, v))
                registration_from_numpy(pgen.registered, p, m, v, jreg.mta.task_slot)
                before = {t.task_id: i for i, t in enumerate(jreg.tasks)}
                pre = {(name, t.task_id): flat(np_tree(jax_slice_task_tree(JCFG, jreg.mta, jt, i)))
                       for name, jt in (("params", jreg.adapter_params), ("m", jreg.opt_state.m),
                                        ("v", jreg.opt_state.v))
                       for i, t in enumerate(jreg.tasks)}
            if op == "register":
                jgen.register_tasks(tasks(JAX_NS, arg))
                pgen.register_tasks(tasks(PORT_NS, arg))
            elif op == "deregister":
                jgen.deregister_tasks(arg)
                pgen.deregister_tasks(arg)
            else:
                jgen.compact()
                pgen.compact()
            jreg, preg = jgen.registered, pgen.registered
            assert [t.task_id for t in preg.tasks] == [t.task_id for t in jreg.tasks]
            np.testing.assert_array_equal(preg.mta.task_slot, jreg.mta.task_slot, err_msg=op)
            assert preg.mta.kind_capacity == jreg.mta.kind_capacity, op
            assert preg.mta.kind_rank == jreg.mta.kind_rank, op
            assert pgen._kind_capacity == jgen._kind_capacity
            survivors = [i for i, t in enumerate(jreg.tasks) if t.task_id in before]
            for name, jt, pt in (("params", jreg.adapter_params, preg.adapter_params),
                                 ("m", jreg.opt_state.m, preg.opt_state.m),
                                 ("v", jreg.opt_state.v, preg.opt_state.v)):
                for i in survivors:
                    # the survivor's values before the op, in the leading
                    # slice where the stack rank grew: the same bits on both
                    js = flat(np_tree(jax_slice_task_tree(JCFG, jreg.mta, jt, i)))
                    ps = flat(slice_task_tree(PCFG, preg.mta, pt, i))
                    old = pre[(name, jreg.tasks[i].task_id)]
                    assert sorted(js) == sorted(ps) == sorted(old), (op, name)
                    for k, o in old.items():
                        lead = tuple(slice(0, n) for n in o.shape)
                        np.testing.assert_array_equal(js[k][lead], o)
                        np.testing.assert_array_equal(as_np(ps[k])[lead], o,
                                                      err_msg=f"{op} {name} {i} {k}")


# ---------------------------------------------------------------------------
# artifacts crossing between the packages


def _zero_moments(tree):
    return jax.tree.map(lambda a: None if np.issubdtype(a.dtype, np.integer)
                        else np.zeros_like(a), tree)


@pytest.mark.parametrize("kind", ["lora", "adapter", "ia3", "prefix", "diff", "dora", "vera",
                                  "bitfit"])
def test_task_tree_artifacts_cross_bit_for_bit(kind, tmp_path):
    """Two tenants of ``kind`` (stack rank 8 from the wider one) on the same
    state in both packages: the narrower tenant's ``slice_task_tree`` is the
    same bits in both, survives a save by either package and a restore by
    the other, and ``load_task_tree`` of it into a fresh stack (rank 8, and
    a stack of rank 16 that pads it) gives the same trees in both."""
    adapters = [(kind, 8), (kind, 4)]
    jmta = JaxMTA(JCFG, [JaxAdapterConfig(k, rank=r) for k, r in adapters])
    pmta = PortMTA(PCFG, [AdapterConfig(k, rank=r) for k, r in adapters], device="cpu")
    state = np_tree(jmta.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: a if np.issubdtype(a.dtype, np.integer) or p[-1].key in ("A", "B")
        else (rs.randn(*a.shape) * 0.05).astype(np.float32), state)
    jtree = jax.tree.map(jnp.asarray, state)
    reg = types.SimpleNamespace(mta=pmta, tasks=[None, None], adapter_params=None,
                                opt_state=types.SimpleNamespace(step=None))
    registration_from_numpy(reg, state, _zero_moments(state), _zero_moments(state),
                            jmta.task_slot)
    ptree = reg.adapter_params
    js = jax_slice_task_tree(JCFG, jmta, jtree, 1)
    ps = slice_task_tree(PCFG, pmta, ptree, 1)
    jf, pf = flat(np_tree(js)), flat(ps)
    assert sorted(jf) == sorted(pf)
    for k in jf:
        np.testing.assert_array_equal(as_np(pf[k]), jf[k], err_msg=str(k))
    CheckpointStore(str(tmp_path / "port")).save(3, ps)
    JaxStore(str(tmp_path / "jax")).save(3, js)
    _, from_jax, _ = CheckpointStore(str(tmp_path / "jax")).restore(ps)
    _, from_port, _ = JaxStore(str(tmp_path / "port")).restore(js)
    for k in jf:
        np.testing.assert_array_equal(as_np(flat(from_jax)[k]), jf[k], err_msg=str(k))
        np.testing.assert_array_equal(flat(np_tree(from_port))[k], jf[k], err_msg=str(k))
    for rank in (8, 16):
        jm2 = JaxMTA(JCFG, [JaxAdapterConfig(kind, rank=rank)])
        pm2 = PortMTA(PCFG, [AdapterConfig(kind, rank=rank)], device="cpu")
        fresh = np_tree(jm2.init(jax.random.PRNGKey(2)))
        reg2 = types.SimpleNamespace(mta=pm2, tasks=[None], adapter_params=None,
                                     opt_state=types.SimpleNamespace(step=None))
        registration_from_numpy(reg2, fresh, _zero_moments(fresh), _zero_moments(fresh),
                                jm2.task_slot)
        want = jax_load_task_tree(JCFG, jm2, jax.tree.map(jnp.asarray, fresh), 0, js,
                                  strict=True)
        got = load_task_tree(PCFG, pm2, reg2.adapter_params, 0, from_jax, strict=True)
        wf, gf = flat(np_tree(want)), flat(got)
        assert sorted(wf) == sorted(gf)
        for k in wf:
            np.testing.assert_array_equal(as_np(gf[k]), wf[k], err_msg=f"rank {rank} {k}")


# ---------------------------------------------------------------------------
# admission, the wait queue and the cost model's serving terms


def test_admission_decisions_and_wait_queue_match_jax():
    jt, pt = tenants(JAX_NS), tenants(PORT_NS)
    budget = churn_budget(PORT_NS, pserve.AdmissionController)
    assert budget == churn_budget(JAX_NS, jserve.AdmissionController)
    for cfg_kw in ({"memory_budget": budget}, {"memory_budget": 1e18, "max_tenants": 2},
                   {"memory_budget": 1e18, "saturation_cap": 1.05}):
        ja = jserve.AdmissionController(JCFG, JaxParallelism(),
                                        config=jserve.AdmissionConfig(**cfg_kw))
        pa = pserve.AdmissionController(PCFG, ParallelismSpec(), hw=JAX_HW,
                                        config=pserve.AdmissionConfig(**cfg_kw))
        for resident, cand in (([], "a"), (["a"], "b"), (["a", "b"], "c"),
                               (["a", "b", "c"], "d"), (["a", "b"], "d"), (["a"], "d")):
            jd = ja.check([jt[r] for r in resident], jt[cand])
            pd = pa.check([pt[r] for r in resident], pt[cand])
            assert (pd.admitted, pd.reason) == (jd.admitted, jd.reason), (cfg_kw, resident, cand)
            np.testing.assert_allclose([pd.stage_memory_bytes, pd.saturation],
                                       [jd.stage_memory_bytes, jd.saturation], rtol=1e-12)
    jq, pq = jserve.WaitQueue(4), pserve.WaitQueue(4)
    for item, prio in (("x", 0), ("y", 2), ("z", 0), ("w", 2), ("v", 1), ("u", 5)):
        assert pq.push(item, prio) == jq.push(item, prio)
    assert pq.items() == jq.items() == ["y", "w", "x", "z"]
    assert pq.remove(lambda s: s == "w") == jq.remove(lambda s: s == "w") == ["w"]
    assert [pq.pop() for _ in range(4)] == [jq.pop() for _ in range(4)] == ["y", "x", "z", None]


def test_decode_token_latency_and_calibration_match_jax():
    """In f64: the decode-token term of the cost model over pool sizes and
    context lengths, and ``calibrate_profile`` (knee, wall scale, decode
    scale) on the same samples, equal the JAX package's."""
    jt, pt = list(tenants(JAX_NS).values()), list(tenants(PORT_NS).values())
    jm = jcm.CostModel(JCFG, jt, JaxParallelism())
    pm = pcm.CostModel(PCFG, pt, ParallelismSpec(), JAX_HW)
    for rows in (1, 2, 8):
        for ctx in (1, 64, 1024):
            np.testing.assert_allclose(pm.decode_token_latency(rows, ctx),
                                       jm.decode_token_latency(rows, ctx), rtol=1e-12)
    rs = np.random.RandomState(0)
    jsamples, psamples = [], []
    for members, n in (([0], 1), ([0, 1], 2), ([1, 2, 3], 1), ([0, 1, 2, 3], 3)):
        jh, _ = jax_build_htask(jt, members)
        ph, _ = build_htask(pt, members)
        wall = float(rs.uniform(0.01, 0.5))
        jsamples.append((jt, [(jh, n)], wall))
        psamples.append((pt, [(ph, n)], wall))
    dec = [(2, 32.0, 0.004), (8, 512.0, 0.011), (4, 100.0, 0.006)]
    jp = jcm.calibrate_profile(JCFG, JaxParallelism(), jsamples, decode_samples=dec)
    pp = pcm.calibrate_profile(PCFG, ParallelismSpec(), psamples, base_hw=JAX_HW,
                               decode_samples=dec)
    np.testing.assert_allclose(pp.util_x_half, jp.util_x_half, rtol=1e-12)
    assert sorted(pp.calibration) == sorted(jp.calibration) == ["__decode__", "__wall__"]
    for k in jp.calibration:
        np.testing.assert_allclose(pp.calibration[k], jp.calibration[k], rtol=1e-12)
    only_dec = pcm.calibrate_profile(PCFG, ParallelismSpec(), [], base_hw=JAX_HW,
                                     decode_samples=dec)
    assert only_dec.calibration["__decode__"] == pytest.approx(
        jcm.calibrate_profile(JCFG, JaxParallelism(), [], decode_samples=dec)
        .calibration["__decode__"], rel=1e-12)
    assert pcm.calibrate_profile(PCFG, ParallelismSpec(), [], base_hw=JAX_HW) is JAX_HW
