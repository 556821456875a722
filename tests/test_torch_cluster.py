"""The port's cluster simulator, elastic planner and straggler mitigator
(``repro_torch.cluster``, ``repro_torch.distributed.fault_tolerance``)
against the JAX package's, and the fleet router's placement decisions and
the trace replay's validation against the JAX package's, on the CPU.

* The simulator, the planner and the mitigator are host arithmetic: on the
  same inputs the port's copies give the JAX package's outputs exactly
  (traces, metrics, per-arrival records, lockstep state, recovery orders,
  parallelism specs, straggler sets and re-balanced tables).
* The invariants of ``tests/test_cluster_sim.py`` hold for the port's
  simulator: no over-admission past the memory bound, backbone
  homogeneity, the co-location cap, the best-fit and affinity picks, the
  sublinear multiplexed slowdown and the lockstep surface.
* One submission sequence through a ``FleetRouter`` of each package (no
  training step) gives the same routing decisions; ``replay_trace`` on
  ``tiny_trace(4)`` gives the JAX replay's validation and accounting.  Both
  sides run ``auto_recalibrate=False`` and the JAX package's hardware
  profile, so the admission gates price the same cost model.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.cluster import simulator as jsim
from repro.configs import smoke_config as jax_smoke_config
from repro.core import cost_model as jcm
from repro.core.task import ParallelismSpec as JaxParallelism
from repro.data.synthetic import make_task as jax_make_task
from repro.distributed import fault_tolerance as jft
from repro.fleet import FleetRouter as JaxRouter
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro import serve as jserve
from repro.serve import replay as jreplay
from repro_torch.cluster import simulator as psim
from repro_torch.cluster.simulator import ClusterSim, Instance, TaskArrival, philly_style_trace
from repro_torch.configs import smoke_config
from repro_torch.core import cost_model as pcm
from repro_torch.core.task import ParallelismSpec
from repro_torch.data.synthetic import make_task
from repro_torch.distributed import fault_tolerance as pft
from repro_torch.fleet import FleetRouter
from repro_torch.peft.methods import AdapterConfig
from repro_torch import serve as pserve
from repro_torch.serve import replay as preplay

POLICIES = ("fcfs", "best_fit", "backbone_affine")
JAX_HW = pcm.HardwareProfile(peak_flops=jcm.PEAK_FLOPS, hbm_bw=jcm.HBM_BW, ici_bw=jcm.ICI_BW)


def astuple(x):
    return dataclasses.astuple(x)


def mixed_trace(mod, seed):
    """A Philly-style trace with two backbone labels (every third arrival on
    the second), so that backbone_affine's filter and the homogeneity rule
    act."""
    base = mod.philly_style_trace(horizon_min=300, rate_per_min=1.2, mean_dur_min=90, seed=seed)
    return [dataclasses.replace(a, backbone="qwen7b" if i % 3 == 0 else "llama7b")
            for i, a in enumerate(base)]


def sim_state(sim):
    return [(i.iid, i.chips, i.backbone, i.hbm_gb, i.backbone_gb, list(i.active), i.retired,
             i.pinned) for i in sim.instances]


# ---------------------------------------------------------------------------
# the port's copies against the JAX package


@pytest.mark.parametrize("seed", [0, 7])
def test_philly_trace_matches_jax(seed):
    for kw in ({}, {"horizon_min": 240, "rate_per_min": 1.5, "mean_dur_min": 120.0}):
        want = jsim.philly_style_trace(seed=seed, **kw)
        got = psim.philly_style_trace(seed=seed, **kw)
        assert len(got) == len(want) > 0
        assert [astuple(a) for a in got] == [astuple(a) for a in want]


@pytest.mark.parametrize("multiplexed", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_sim_run_matches_jax(policy, multiplexed):
    kw = dict(n_chips=16, chips_per_instance=4, max_colocate=3, multiplexed=multiplexed,
              policy=policy, hbm_gb=24.0, backbone_gb=14.0)
    jrun, prun = jsim.ClusterSim(**kw), psim.ClusterSim(**kw)
    want = jrun.run(mixed_trace(jsim, 3))
    got = prun.run(mixed_trace(psim, 3))
    assert got == want
    assert [astuple(r) for r in prun.records] == [astuple(r) for r in jrun.records]
    assert sim_state(prun) == sim_state(jrun)
    assert 0 < got["completed"] and got["dropped"] > 0


def _lockstep_script(mod):
    """The lockstep surface driven through admits, a pinned scale-up, a
    crash with residents, departures and a retire; returns every answer and
    the state after each operation."""
    sim = mod.ClusterSim(n_chips=8, chips_per_instance=4, max_colocate=2, policy="best_fit",
                         hbm_gb=18.0, backbone_gb=14.0)
    A = mod.TaskArrival
    tasks = [A(0.0, 10.0, mem_gb=m) for m in (1.0, 1.5, 0.5, 2.0)]
    out = []

    def note(tag, value=None):
        out.append((tag, value, sim_state(sim)))

    for i, t in enumerate(tasks):
        pick = sim.lockstep_pick(t)
        note(f"pick{i}", pick)
        if pick is not None:
            sim.lockstep_admit(f"t{i}", t, pick)
            note(f"admit{i}")
    try:
        sim.lockstep_admit("t0", tasks[0], 0)
    except ValueError as e:
        note("duplicate", str(e))
    iid = sim.add_instance(backbone="llama:int8", backbone_gb=7.0, pinned=True)
    note("add", iid)
    note("pick_int8", sim.lockstep_pick(A(0.0, 1.0, backbone="llama:int8", mem_gb=1.0)))
    try:
        sim.lockstep_admit("x", tasks[0], iid)
    except ValueError as e:
        note("pinned_mismatch", str(e))
    note("fail", sorted(sim.fail_instance(0)))
    note("pick_after_fail", sim.lockstep_pick(tasks[3]))
    try:
        sim.remove_instance(1)
    except ValueError as e:
        note("remove_busy", str(e))
    for tid in [t for t, (i, _) in sim._lockstep.items() if i == 1]:
        sim.lockstep_depart(tid)
        note("depart", tid)
    sim.remove_instance(1)
    note("removed")
    note("pick_last", sim.lockstep_pick(tasks[2]))
    return out


def test_lockstep_api_matches_jax():
    got, want = _lockstep_script(psim), _lockstep_script(jsim)
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    tags = dict((t, v) for t, v, _ in got)
    assert tags["fail"] and tags["pick_int8"] == 2


def test_elastic_planner_matches_jax():
    orphans = [("a", 0, 3), ("b", 2, 1), ("c", 0, 7), ("d", 2, 1), ("e", 1, 0), ("f", 0, 7)]
    for mod in (pft, jft):
        assert mod.ElasticPlanner().recovery_order(orphans) == ["b", "d", "e", "c", "f", "a"]

    def plan(mod, capacity):
        left = dict(capacity)

        def place(tid):
            for iid in sorted(left):
                if left[iid] > 0:
                    left[iid] -= 1
                    return iid
            return None
        return [astuple(a) for a in mod.ElasticPlanner().plan_recovery(orphans, place)]

    for capacity in ({}, {3: 1}, {1: 2, 4: 1}, {0: 9}):
        assert plan(pft, capacity) == plan(jft, capacity), capacity
    for stages, chips, tp, dp in ((1, 1, 1, 1), (4, 2, 2, 1), (2, 4, 1, 4), (3, 4, 2, 2)):
        for total in (1, 2, 3, 4, 6, 8, 12, 16, 24):
            for prefer in (1, 2, 4):
                old_p = ParallelismSpec(stages, chips, tp, dp)
                old_j = JaxParallelism(stages, chips, tp, dp)
                got = pft.ElasticPlanner(prefer).respec(old_p, total)
                want = jft.ElasticPlanner(prefer).respec(old_j, total)
                assert astuple(got) == astuple(want), (stages, total, prefer)
                assert astuple(pft.elastic_respec(old_p, total, prefer)) == astuple(want)


def test_straggler_mitigator_matches_jax():
    rs = np.random.RandomState(5)
    hosts = 6
    port, jax_ = pft.StragglerMitigator(hosts, threshold=1.4), jft.StragglerMitigator(
        hosts, threshold=1.4)
    assert port.stragglers() == jax_.stragglers() == []
    table = {h: [(b, m) for b in range(3) for m in range(h + 2)] for h in range(hosts)}
    for step in range(12):
        for h in range(hosts - 1 if step < 4 else hosts):
            t = float(rs.uniform(0.9, 1.1)) * (2.5 if h in (1, 4) else 1.0)
            port.observe(h, t)
            jax_.observe(h, t)
        assert [astuple(s) for s in port.stats] == [astuple(s) for s in jax_.stats]
        assert port.stragglers() == jax_.stragglers()
        assert port.rebalance(table) == jax_.rebalance(table)
    assert port.stragglers() == [1, 4]
    moved = port.rebalance(table)
    assert sum(map(len, moved.values())) == sum(map(len, table.values()))
    assert len(moved[1]) < len(table[1]) and len(moved[4]) < len(table[4])


# ---------------------------------------------------------------------------
# the invariants of tests/test_cluster_sim.py on the port's simulator


def _replay_instance_state(trace, sim):
    """Per-instance resident sets at each admission, rebuilt from the
    simulator's per-arrival records: (record, task, [(mem, backbone, end)])."""
    order = sorted(trace, key=lambda a: a.t_min)
    admitted = []
    for rec in sim.records:
        if not rec.admitted:
            continue
        task = order[rec.index]
        live = [(m, b, e) for (i, e, m, b) in admitted if i == rec.instance and e > rec.t_arrive]
        yield rec, task, live
        admitted.append((rec.instance, rec.t_end, task.mem_gb, task.backbone))


@pytest.mark.parametrize("policy", POLICIES)
def test_no_memory_over_admission(policy):
    trace = philly_style_trace(horizon_min=240, rate_per_min=1.0, mean_dur_min=120, seed=3)
    sim = ClusterSim(n_chips=16, chips_per_instance=4, policy=policy)
    sim.run(trace)
    hbm, backbone = sim.instances[0].hbm_gb, sim.instances[0].backbone_gb
    checked = 0
    for rec, task, live in _replay_instance_state(trace, sim):
        assert backbone + sum(m for m, _, _ in live) + task.mem_gb <= hbm + 1e-9, rec
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_backbone_homogeneity(policy):
    rng = np.random.RandomState(0)
    trace = [TaskArrival(t_min=float(i), duration_min=30.0,
                         backbone="llama7b" if i % 2 else "qwen7b",
                         mem_gb=float(rng.uniform(0.5, 1.5))) for i in range(40)]
    sim = ClusterSim(n_chips=16, chips_per_instance=4, policy=policy)
    sim.run(trace)
    for rec, task, live in _replay_instance_state(trace, sim):
        assert all(b == task.backbone for _, b, _ in live), (rec, live)


@pytest.mark.parametrize("policy", POLICIES)
def test_colocate_cap_and_conservation(policy):
    trace = philly_style_trace(horizon_min=120, rate_per_min=2.0, seed=1)
    sim = ClusterSim(n_chips=8, chips_per_instance=4, max_colocate=3, policy=policy)
    out = sim.run(trace)
    assert out["completed"] + out["dropped"] == len(trace)
    assert 0.0 < out["admission_rate"] <= 1.0
    for _, _, live in _replay_instance_state(trace, sim):
        assert len(live) < 3
    assert len(sim.records) == len(trace)


def test_best_fit_packs_fullest_feasible():
    sim = ClusterSim(n_chips=12, chips_per_instance=4, policy="best_fit")
    a, b, _ = sim.instances
    a.backbone = b.backbone = "llama7b"
    a.active = [(100.0, 1.0)]
    b.active = [(100.0, 1.0), (100.0, 1.0)]
    task = TaskArrival(t_min=0.0, duration_min=10.0, mem_gb=1.0)
    assert sim._pick(task) is b
    b.active = [(100.0, 25.0), (100.0, 25.0)]  # 14 + 50 + 1 > 64
    assert sim._pick(task) is a


def test_backbone_affine_prefers_warm_instance():
    sim = ClusterSim(n_chips=12, chips_per_instance=4, policy="backbone_affine")
    a, b, _ = sim.instances
    a.backbone = "qwen7b"
    a.active = [(100.0, 1.0), (100.0, 1.0)]
    b.backbone = "llama7b"
    b.active = [(100.0, 1.0)]
    assert sim._pick(TaskArrival(t_min=0.0, duration_min=10.0, backbone="llama7b")) is b


def test_multiplexed_slowdown_sublinear():
    inst = Instance(0, 4)
    for k in (2, 4, 8):
        assert inst.slowdown(k, multiplexed=True) < k
        assert inst.slowdown(k, multiplexed=False) == float(k)
    s = [inst.slowdown(k, True) for k in (1, 2, 4, 8)]
    assert s == sorted(s)


def test_multiplexing_beats_time_slicing_on_saturated_trace():
    trace = philly_style_trace(horizon_min=240, rate_per_min=1.5, seed=7)
    mux = ClusterSim(n_chips=16, chips_per_instance=4, multiplexed=True).run(trace)
    sliced = ClusterSim(n_chips=16, chips_per_instance=4, multiplexed=False).run(trace)
    assert mux["completed"] >= sliced["completed"]
    assert mux["served_task_min"] >= sliced["served_task_min"]


def test_lockstep_placement_api():
    sim = ClusterSim(n_chips=8, chips_per_instance=4, policy="best_fit", hbm_gb=16.0,
                     backbone_gb=14.0)
    task = TaskArrival(t_min=0.0, duration_min=10.0, mem_gb=1.0)
    iid = sim.lockstep_pick(task)
    assert iid == sim.lockstep_pick(task)
    sim.lockstep_admit("t0", task, iid)
    with pytest.raises(ValueError):
        sim.lockstep_admit("t0", task, iid)
    assert sim.lockstep_pick(task) == iid
    assert sim.instances[iid].active
    new_iid = sim.add_instance()
    assert new_iid == len(sim.instances) - 1
    with pytest.raises(ValueError):
        sim.remove_instance(iid)
    sim.lockstep_depart("t0")
    sim.remove_instance(iid)
    assert sim.instances[iid].retired
    assert sim.lockstep_pick(task) != iid
    assert [i.iid for i in sim.instances] == list(range(len(sim.instances)))


def test_lockstep_pick_exhausts_to_none():
    sim = ClusterSim(n_chips=4, chips_per_instance=4, max_colocate=1, policy="fcfs")
    task = TaskArrival(t_min=0.0, duration_min=10.0, mem_gb=1.0)
    sim.lockstep_admit("t0", task, sim.lockstep_pick(task))
    assert sim.lockstep_pick(task) is None


def test_fail_instance_orphans_and_retires():
    sim = ClusterSim(n_chips=8, chips_per_instance=4, max_colocate=4, policy="fcfs",
                     hbm_gb=32.0, backbone_gb=14.0)
    task = TaskArrival(t_min=0.0, duration_min=10.0, mem_gb=1.0)
    for tid in ("a", "b", "c"):
        sim.lockstep_admit(tid, task, 0)
    sim.lockstep_admit("d", task, 1)
    assert sorted(sim.fail_instance(0)) == ["a", "b", "c"]
    assert sim.instances[0].retired and not sim.instances[0].active
    assert sim.lockstep_pick(task) == 1
    sim.lockstep_depart("d")
    assert not sim.instances[1].active


# ---------------------------------------------------------------------------
# routing decisions and the trace replay against the JAX package

JCFG = jax_smoke_config("llama3.2-3b")
PCFG = smoke_config("llama3.2-3b")
BUDGET = 16e9


def _routing_tasks(make, adapter_cls):
    """Five tenants of two kinds, three datasets and two ranks: their Eq. 5
    bytes differ, so best_fit's byte key decides among equally full
    instances."""
    spec = (("t0", "sst2", "lora", 4), ("t1", "qa", "adapter", 8), ("t2", "rte", "lora", 8),
            ("t3", "qa", "lora", 4), ("t4", "sst2", "adapter", 4))
    return [make(tid, ds, 1, adapter_cls(kind, rank=r), seed=i)
            for i, (tid, ds, kind, r) in enumerate(spec)]


def _route(router_cls, factory, tasks, tenant_spec):
    """Two instances that hold two tenants each: t0-t3 placed, t4 queued;
    then t0 and t2 cancelled on their instances, and the departures
    reconciled and the queue re-drained as a fleet step does after its
    iteration (no training step runs), which re-routes t4.  Returns the
    decisions' summaries, the oracle agreement and the placements."""
    fleet = router_cls(factory, n_instances=2, policy="best_fit")
    for t in tasks:
        fleet.submit(tenant_spec(t, target_steps=3))
    for tid in ("t0", "t2"):
        fleet.instances[fleet.placements[tid]].service.cancel(tid)
    fleet._reconcile_departures()
    fleet._drain_queue()
    return [d.summary() for d in fleet.decisions], fleet.oracle_agreement(), dict(fleet.placements)


def test_router_decisions_match_jax_router():
    def jfactory(iid):
        return jserve.MuxTuneService(
            JCFG, JaxParallelism(), enable_fusion=False, reserve_slots=4, seed=0,
            auto_recalibrate=False,
            admission=jserve.AdmissionConfig(memory_budget=BUDGET, max_tenants=2))

    def pfactory(iid):
        return pserve.MuxTuneService(
            PCFG, ParallelismSpec(), enable_fusion=False, reserve_slots=4, seed=0,
            auto_recalibrate=False, hw=JAX_HW, device="cpu",
            admission=pserve.AdmissionConfig(memory_budget=BUDGET, max_tenants=2))

    want = _route(JaxRouter, jfactory, _routing_tasks(jax_make_task, JaxAdapterConfig),
                  jserve.TenantSpec)
    got = _route(FleetRouter, pfactory, _routing_tasks(make_task, AdapterConfig),
                 pserve.TenantSpec)
    assert got == want
    outcomes = [d["outcome"] for d in got[0]]
    assert outcomes == ["admit"] * 4 + ["queue", "admit"]
    assert got[1] == 1.0 and all(d["oracle_agrees"] for d in got[0] if d["outcome"] != "queue")


def test_replay_trace_matches_jax(monkeypatch):
    """``replay_trace`` through one service on ``tiny_trace(4)``: the
    simulator's side, the validation and each tenant's accounting equal
    the JAX replay's."""
    monkeypatch.setattr(jreplay, "MuxTuneService", functools.partial(
        jserve.MuxTuneService, auto_recalibrate=False))
    monkeypatch.setattr(preplay, "MuxTuneService", functools.partial(
        pserve.MuxTuneService, auto_recalibrate=False, hw=JAX_HW))
    adm = dict(memory_budget=BUDGET, max_tenants=2)
    want = jreplay.replay_trace(jreplay.tiny_trace(4), admission=jserve.AdmissionConfig(**adm))
    got = preplay.replay_trace(preplay.tiny_trace(4), admission=pserve.AdmissionConfig(**adm),
                               device="cpu")
    assert [astuple(a) for a in preplay.tiny_trace(4)] == [astuple(a)
                                                           for a in jreplay.tiny_trace(4)]
    for key in ("validation", "sim", "sim_records"):
        assert got[key] == want[key], key
    assert got["validation"]["real_admitted"] == 4
    by_id = {r["task_id"]: r for r in got["real"]["tenants"]}
    jby_id = {r["task_id"]: r for r in want["real"]["tenants"]}
    assert sorted(by_id) == sorted(jby_id) == [f"tenant{i}" for i in range(4)]
    for tid in jby_id:
        for key in ("state", "queue_wait", "steps_trained", "tokens", "effective_tokens",
                    "makespan"):
            assert by_id[tid][key] == jby_id[tid][key], (tid, key)
    for key in ("completed", "mean_makespan_iters", "mean_queue_wait_iters",
                "total_effective_tokens"):
        assert got["real_summary"][key] == want["real_summary"][key], key
