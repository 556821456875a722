"""The port's fleet tier (``repro_torch.fleet``, ``repro_torch.serve.replay``)
at smoke size on the CPU: routing against the lockstep oracle, live
migration, crash recovery from cadence checkpoints, the autoscaler and the
fleet replay.

* Migration against the JAX fleet, once, in a module fixture: two LoRA
  tenants train three iterations on one instance, one is live-migrated
  (drain, checkpoint-out, release, warm start, rebind) with a greedy
  request in flight, and both finish.  The port's per-iteration losses
  equal the JAX fleet's (rtol 2e-4) with JAX's backbone and JAX's fresh
  slots carried across into each instance, the moved request's greedy
  tokens equal JAX's, and the migrated tenant's losses equal a solo
  service's (port against port, rtol 2e-4).  Both sides run f32 adapters
  and backbone (as ``tests/test_torch_service.py`` does).
* Routing: every ``FleetRouter`` placement equals its ``ClusterSim``
  oracle's for each policy.
* Decode survival, port against port at lr = 0: an in-flight request with
  seeded sampling survives a migration and an instance kill with the
  tokens of a no-move control.  (The port's seeded sampler is its own, so
  these tokens are not compared with JAX's.)
* Kill and recovery: a tenant killed after 5 steps with cadence 2 resumes
  from its step-4 artifact on a survivor, its dead record is LOST, and its
  losses equal a solo service warm-started from that artifact (rtol 2e-4);
  orphans with no capacity queue and recover after a spawn; the kill joins
  the dead instance's checkpoint writers before recovery reads.
* The autoscaler's floor and cooldown, the fleet replay's acceptance, the
  heterogeneous f32 + int8 fleet, and ``python -m repro_torch.serve.replay``
  run in-process.
"""
import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.registry import ModelGenerator as JaxGenerator
from repro.core.task import ParallelismSpec as JaxParallelism
from repro.data.synthetic import make_task as jax_make_task
from repro.fleet import FleetRouter as JaxRouter
from repro.peft.methods import AdapterConfig as JaxAdapterConfig
from repro import serve as jserve
from repro_torch.configs import smoke_config
from repro_torch.convert import backbone_from_numpy
from repro_torch.core.task import ParallelismSpec
from repro_torch.data.synthetic import make_task
from repro_torch.distributed.checkpoint import CheckpointStore
from repro_torch.fleet import PHASES, Autoscaler, AutoscalerConfig, FleetRouter
from repro_torch.obs.tracing import SpanTracer, set_tracer, validate_chrome_trace
from repro_torch.peft.methods import AdapterConfig
from repro_torch import serve as pserve
from repro_torch.serve import replay as preplay
from repro_torch.serve import (COMPLETED, LOST, MIGRATED, CoServeConfig, MuxTuneService,
                               RequestSpec, TenantSpec)
from test_torch_service import f32_adapters, np_tree, record_registrations, replay_registrations

Q_BLOCK = 128
JCFG = jax_smoke_config("llama3.2-3b").with_overrides(attn_q_block=Q_BLOCK)
PCFG = smoke_config("llama3.2-3b").with_overrides(attn_q_block=Q_BLOCK)
CFG = smoke_config("llama3.2-3b")
LOSS_RTOL = 2e-4


def _task(tid, dataset="sst2", rank=4, seed=0, kind="lora", **adapter_kw):
    return make_task(tid, dataset, 1, AdapterConfig(kind, rank=rank, **adapter_kw), seed=seed)


def _service(fault_dir=None, cadence=0, coserve=None, lr=5e-3, cfg=CFG, **kw):
    return MuxTuneService(cfg, ParallelismSpec(), lr=lr, n_micro=1, enable_fusion=False,
                          reserve_slots=4, seed=0, coserve=coserve, fault_dir=fault_dir,
                          ckpt_cadence=cadence, device="cpu", **kw)


def _factory(**kw):
    return lambda iid: _service(**kw)


# ---------------------------------------------------------------------------
# live migration against the JAX fleet (the one JAX fleet scenario here)


def migration_scenario(router_cls, factory, ns):
    """mig0 and stay1 (LoRA rank 4) pack onto instance 0; a greedy request
    r0 on mig0 at clock 2; after three iterations mig0 moves with r0 in
    flight; the fleet runs to the end.  Returns what the checks read."""
    fleet = router_cls(factory, n_instances=2, policy="best_fit")
    for tid, ds, seed in (("mig0", "sst2", 0), ("stay1", "qa", 1)):
        fleet.submit(ns.TenantSpec(ns.make_task(tid, ds, 1, ns.AdapterConfig("lora", rank=4),
                                                seed=seed), target_steps=6))
    fleet.step()
    fleet.step()
    prompt = np.random.RandomState(3).randint(1, 200, 9)
    req = fleet.submit_request("mig0", ns.RequestSpec(prompt, max_new_tokens=6,
                                                      request_id="r0"))
    fleet.step()
    in_flight = req.state
    source = fleet.placements["mig0"]
    rep = fleet.migrate("mig0")
    fleet.run(max_iters=32)
    moved = fleet.instances[fleet.placements.get("mig0", rep.target)].service
    return {"fleet": fleet, "report": rep, "source": source, "in_flight": in_flight,
            "request": moved.coserve.requests["r0"],
            "losses": {t: list(fleet.record(t).losses) for t in ("mig0", "stay1")},
            "decisions": [d.summary() for d in fleet.decisions]}


@pytest.fixture(scope="module")
def migration():
    import types

    jns = types.SimpleNamespace(make_task=jax_make_task, AdapterConfig=JaxAdapterConfig,
                                TenantSpec=jserve.TenantSpec, RequestSpec=jserve.RequestSpec)
    pns = types.SimpleNamespace(make_task=make_task, AdapterConfig=AdapterConfig,
                                TenantSpec=pserve.TenantSpec, RequestSpec=pserve.RequestSpec)
    coserve = dict(max_tokens_per_iter=1)
    with f32_adapters():
        bb_np = np_tree(JaxGenerator(JCFG, seed=0).init_backbone())
        snaps = {}

        def jfactory(iid):
            svc = jserve.MuxTuneService(JCFG, JaxParallelism(), lr=5e-3, n_micro=1,
                                        enable_fusion=False, reserve_slots=4, seed=0,
                                        coserve=jserve.CoServeConfig(**coserve))
            svc.gen.backbone_params = jax.tree.map(jnp.asarray, bb_np)
            snaps[iid] = record_registrations(svc.gen)
            return svc

        def pfactory(iid):
            svc = _service(cfg=PCFG, coserve=CoServeConfig(**coserve))
            svc.gen.backbone_params = backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32)
            replay_registrations(svc.gen, snaps[iid])
            return svc

        jres = migration_scenario(JaxRouter, jfactory, jns)
        pres = migration_scenario(FleetRouter, pfactory, pns)
        # the solo control: mig0 alone, from the same fresh slot
        solo = _service(cfg=PCFG, coserve=CoServeConfig(**coserve))
        solo.gen.backbone_params = backbone_from_numpy(bb_np, PCFG, "cpu", torch.float32)
        first = snaps[0][0]
        last = next(s for s in reversed(snaps[0]) if s["ids"] == [])
        assert first["ids"] == ["mig0"]
        replay_registrations(solo.gen, [first, last])
        solo.submit(pserve.TenantSpec(make_task("mig0", "sst2", 1, AdapterConfig("lora", rank=4),
                                                seed=0), target_steps=6))
        solo_losses = [float(solo.step().per_task_loss[0]) for _ in range(6)]
    return {"jax": jres, "port": pres, "solo": solo_losses}


def test_migration_losses_match_jax_fleet(migration):
    j, p = migration["jax"], migration["port"]
    assert p["decisions"] == j["decisions"]
    assert [d["instance"] for d in p["decisions"]] == [0, 0]
    for tid in ("mig0", "stay1"):
        assert len(p["losses"][tid]) == len(j["losses"][tid]) == 6
        np.testing.assert_allclose(p["losses"][tid], j["losses"][tid], rtol=LOSS_RTOL,
                                   err_msg=tid)


def test_migration_report_and_records(migration):
    p, j = migration["port"], migration["jax"]
    rep, fleet = p["report"], p["fleet"]
    assert set(rep.phase_seconds) == set(PHASES) == set(j["report"].phase_seconds)
    assert all(s >= 0 for s in rep.phase_seconds.values())
    assert (rep.source, rep.target, rep.steps_trained) == (0, 1, 3)
    assert (rep.source, rep.target, rep.steps_trained) == (
        j["report"].source, j["report"].target, j["report"].steps_trained)
    assert os.path.isdir(rep.checkpoint_path)
    assert fleet.instances[p["source"]].service.tenants["mig0"].state == MIGRATED
    assert fleet.record("mig0").state == COMPLETED
    assert fleet.record("mig0").steps_trained == 6
    assert fleet.oracle_agreement() == 1.0
    assert fleet.accounting()["migrations"][0]["requests_moved"] == 1


def test_migrated_request_greedy_tokens_match_jax(migration):
    p, j = migration["port"], migration["jax"]
    assert p["in_flight"] == j["in_flight"] == "decoding"
    assert p["report"].request_ids == j["report"].request_ids == ["r0"]
    req, jreq = p["request"], j["request"]
    assert req.state == jreq.state == "done" and req.reason != "tenant_departed"
    assert len(req.tokens_out) == 6
    np.testing.assert_array_equal(req.tokens_out, jreq.tokens_out)


def test_migrated_tenant_matches_solo_run(migration):
    np.testing.assert_allclose(migration["port"]["losses"]["mig0"], migration["solo"],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# routing against the lockstep oracle


@pytest.mark.parametrize("policy", ("fcfs", "best_fit", "backbone_affine"))
def test_router_placements_match_cluster_sim(policy):
    fleet = FleetRouter(_factory(), n_instances=3, policy=policy)
    for i in range(5):
        d = fleet.submit(TenantSpec(_task(f"t{i}", ("sst2", "qa", "rte")[i % 3],
                                          rank=(4, 8)[i % 2], seed=i), target_steps=2))
        assert d.outcome in ("admit", "queue")
        if d.outcome == "admit":
            assert d.oracle == d.instance, d.summary()
    fleet.run(max_iters=64)
    assert fleet.oracle_agreement() == 1.0
    assert len([d for d in fleet.decisions if d.outcome == "admit"]) == 5
    for i in range(5):
        assert fleet.record(f"t{i}").state == COMPLETED
    assert not fleet.sim._lockstep


# ---------------------------------------------------------------------------
# decode survival (port against port, lr = 0, seeded sampling)


def _decode_survival(move):
    rspec = RequestSpec(np.arange(1, 6), max_new_tokens=6, temperature=0.7, top_k=5, seed=11,
                        request_id="r0")
    fleet = FleetRouter(_factory(coserve=CoServeConfig(max_tokens_per_iter=1), lr=0.0),
                        n_instances=2, policy="fcfs")
    fleet.submit(TenantSpec(_task("t0", lr=0.0), target_steps=10))
    req = fleet.submit_request("t0", rspec)
    fleet.step()
    assert req.state == "decoding" and len(req.tokens_out or ()) < 6
    if move == "migrate":
        assert fleet.migrate("t0").request_ids == ["r0"]
    elif move == "kill":
        assert fleet.kill(fleet.placements["t0"]).requeued_requests == ["r0"]
    for _ in range(24):
        fleet.step()
        for inst in fleet.instances.values():
            live = inst.service.coserve.requests.get("r0")
            if live is not None:
                req = live
        if req.state == "done":
            break
    return req


@pytest.mark.parametrize("move", ["migrate", "kill"])
def test_inflight_request_survives(move):
    control, moved = _decode_survival(None), _decode_survival(move)
    assert control.state == moved.state == "done"
    assert moved.reason != "tenant_departed"
    assert len(moved.tokens_out) == 6
    np.testing.assert_array_equal(control.tokens_out, moved.tokens_out)


# ---------------------------------------------------------------------------
# kill and recovery


def test_killed_instance_recovers_with_loss_parity(tmp_path):
    """Killed after 5 steps with cadence 2: the tenant resumes from its
    step-4 artifact (one step lost), completes, and its post-recovery
    losses equal a solo service warm-started from that artifact."""
    fault = tmp_path / "fault"
    fleet = FleetRouter(_factory(fault_dir=str(fault), cadence=2), n_instances=2,
                        policy="fcfs")
    fleet.submit(TenantSpec(_task("t0"), target_steps=8))
    for _ in range(5):
        fleet.step()
    src = fleet.placements["t0"]
    assert fleet.record("t0").steps_trained == 5
    for st in fleet.instances[src].service._fault_stores.values():
        st.wait()
    # the artifact recovery reads, kept apart: the recovered tenant goes on
    # committing cadence steps into the same directory
    snap = tmp_path / "step4"
    shutil.copytree(fault / "t0" / "step_00000004", snap / "step_00000004")
    tracer = SpanTracer()
    prev = set_tracer(tracer)
    try:
        report = fleet.kill(src)
    finally:
        set_tracer(prev)
    assert report.orphans == ["t0"] and report.placed["t0"] != src
    assert report.cold == [] and report.queued == []
    stats = validate_chrome_trace(tracer.chrome_trace(), require_phases=[
        "fleet.recover", "fleet.recover.plan", "fleet.recover.warm_start"])
    assert stats["phases"]["fleet.recover.warm_start"] == 1
    rec = fleet.record("t0")
    assert rec.steps_trained == 4
    assert 0 < 5 - rec.steps_trained <= 2
    dead = fleet.failed_instances[0].service.tenants["t0"]
    assert dead.state == LOST and dead.reason == "instance_failure"
    assert fleet.decisions[-1].outcome == "recover" and fleet.oracle_agreement() == 1.0
    fleet.run(max_iters=32)
    rec = fleet.record("t0")
    assert rec.state == COMPLETED and rec.steps_trained == 8
    solo = _service()
    solo.submit(TenantSpec(_task("t0"), target_steps=4, warm_start_dir=str(snap)))
    for _ in range(8):
        solo.step()
    srec = solo.tenants["t0"]
    assert srec.state == COMPLETED and srec.steps_trained == 4
    np.testing.assert_allclose(rec.losses[-4:], srec.losses, rtol=LOSS_RTOL)


def test_kill_joins_inflight_checkpoint_writes(tmp_path):
    """Killed right after a cadence step, with its write not waited on:
    recovery reads the directory only after the dead instance's writers
    have ended, so it resumes from that step."""
    fleet = FleetRouter(_factory(fault_dir=str(tmp_path), cadence=2), n_instances=2,
                        policy="fcfs")
    fleet.submit(TenantSpec(_task("t0"), target_steps=8))
    for _ in range(4):
        fleet.step()
    fleet.kill(fleet.placements["t0"])
    assert fleet.record("t0").steps_trained == 4
    assert CheckpointStore(str(tmp_path / "t0")).latest_step() == 4


def test_recovery_queues_without_capacity_then_drains(tmp_path):
    fleet = FleetRouter(_factory(fault_dir=str(tmp_path), cadence=2), n_instances=1,
                        policy="fcfs")
    fleet.submit(TenantSpec(_task("t0"), target_steps=6))
    for _ in range(3):
        fleet.step()
    report = fleet.kill(fleet.placements["t0"])
    assert report.placed == {} and report.queued == ["t0"]
    assert fleet.recovery_queue == ["t0"] and fleet.has_work()
    assert fleet.decisions[-1].outcome == "recover_queue"
    fleet.spawn()
    fleet.step()
    assert fleet.recovery_queue == [] and "t0" in fleet.placements
    assert fleet.record("t0").steps_trained == 2
    fleet.run(max_iters=32)
    assert fleet.record("t0").state == COMPLETED


# ---------------------------------------------------------------------------
# the autoscaler and the fleet replay


def test_autoscaler_respects_floor_and_cooldown():
    fleet = FleetRouter(_factory(), n_instances=1, policy="best_fit")
    fleet.autoscaler = Autoscaler(AutoscalerConfig(min_instances=1, max_instances=2,
                                                   cooldown_ticks=3))
    for _ in range(6):
        fleet.step()
    assert len([i for i in fleet.instances.values() if not i.retired]) == 1
    assert fleet.autoscaler.accounting()["scale_downs"] == 0


def test_retire_refuses_nonempty_instance():
    fleet = FleetRouter(_factory(), n_instances=2, policy="fcfs")
    fleet.submit(TenantSpec(_task("t0"), target_steps=4))
    with pytest.raises(ValueError, match="resident"):
        fleet.retire(fleet.placements["t0"])


def test_fleet_replay_acceptance():
    tracer = SpanTracer()
    prev = set_tracer(tracer)
    try:
        report = preplay.replay_fleet(
            preplay.tiny_trace(4, gap_min=1.0, dur_min=6.0),
            admission=pserve.AdmissionConfig(max_tenants=2), requests_per_min=1,
            n_instances=1, policy="best_fit", autoscale=True,
            autoscaler_config=AutoscalerConfig(min_instances=1, max_instances=3,
                                               cooldown_ticks=1),
            force_migration=True, device="cpu")
    finally:
        set_tracer(prev)
    rs = report["real_summary"]
    assert rs["completed"] == 4
    assert rs["migrations"] >= 1 and rs["forced_migrations"] >= 1
    assert rs["dropped_moved_requests"] == []
    assert rs["scale_ups"] >= 1 and rs["scale_downs"] >= 1
    assert rs["oracle_agreement"] == 1.0 and rs["live_instances"] >= 1
    stats = validate_chrome_trace(tracer.chrome_trace(), require_phases=[
        "fleet.route", "fleet.migrate", "fleet.scale_up", "fleet.scale_down", "fleet.step"])
    assert stats["phases"]["fleet.migrate"] >= 1


def test_heterogeneous_fleet_f32_and_int8_instances():
    cfg32 = CFG.with_overrides(backbone_dtype="float32")
    cfg8 = CFG.with_overrides(backbone_dtype="int8")
    fleet = FleetRouter(lambda iid: _service(cfg=cfg32 if iid % 2 == 0 else cfg8),
                        n_instances=2, policy="backbone_affine")
    labels = {iid: inst.backbone for iid, inst in fleet.instances.items()}
    assert labels[0].endswith(":float32") and labels[1].endswith(":int8")
    assert fleet.instances[1].backbone_bytes < fleet.instances[0].backbone_bytes
    sub = []
    for i in range(4):
        want = labels[i % 2]
        d = fleet.submit(TenantSpec(make_task(f"h{i}", ("sst2", "qa")[i % 2], 2,
                                              AdapterConfig("lora", rank=4), seed=i),
                                    target_steps=2, backbone=want))
        sub.append((d, want))
    for d, want in sub:
        assert d.outcome == "admit", d.summary()
        assert fleet.instances[d.instance].backbone == want
        assert d.oracle == d.instance, d.summary()
    fleet.run(max_iters=32)
    assert fleet.oracle_agreement() == 1.0
    for i in range(4):
        assert fleet.record(f"h{i}").state == COMPLETED


def test_replay_main_runs_a_fleet_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        preplay.main(["--device", "cpu", "--instances", "2", "--force-migration",
                      "--kill-instance", "--ckpt-cadence", "2", "--json",
                      str(tmp_path / "replay.json")])
    head = json.loads(out.getvalue())
    rs = head["real_summary"]
    assert rs["completed"] == 4 and rs["failures"] == 1
    assert rs["migrations"] >= 1 and rs["dropped_moved_requests"] == []
    assert rs["oracle_agreement"] == 1.0 and rs["recovery_queued"] == []
    assert json.load(open(tmp_path / "replay.json"))["real_summary"] == rs
