"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and inside a live service run on the CPU.

Both packages' telemetry and tracing are host-side Python: driven through
the same calls they must give the same rings, snapshots, expositions and
trace validation verdicts.  The port's own guarantees: with tracing off
every span site is one shared no-op that allocates nothing; with it on each
span is also a ``torch.profiler.record_function`` range; a service run's
chrome trace passes ``validate_chrome_trace`` and its rings stay bounded
under churn.
"""
import json
import logging
import subprocess
import sys
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import telemetry as jtel
from repro.obs import tracing as jtr
from repro_torch.obs import log as plog
from repro_torch.obs import telemetry as ptel
from repro_torch.obs import tracing as ptr

ROOT = Path(__file__).resolve().parent.parent


def _drive_registry(tel):
    reg = tel.TelemetryRegistry(ring_cap=4)
    reg.counter("service.admission", decision="admit", reason="ok").inc()
    reg.counter("service.admission", decision="admit", reason="ok").inc(2)
    reg.counter("service.admission", decision="reject", reason="memory").inc()
    reg.gauge("service.memory_bytes").set(1234.5)
    reg.gauge("tenant.eq5_bytes", task="a").set(100.0)
    reg.gauge("tenant.eq5_bytes", task="b").set(200.0)
    for v in (0.1, 0.2, 0.3, 0.4, 0.7, 0.9):
        reg.histogram("decode.token_seconds", slo_class="0").observe(v)
    reg.histogram("tenant.loss", task="a").observe(1.0)
    for i in range(11):
        reg.series("service.calibration").append(i)
    return reg


def test_registry_snapshot_and_exposition_equal_jax():
    j, p = _drive_registry(jtel), _drive_registry(ptel)
    assert p.exposition() == j.exposition()
    sj, sp = j.snapshot(), p.snapshot()
    assert sp == sj
    assert json.loads(json.dumps(sp)) == sp
    parsed = ptel.parse_exposition(p.exposition())
    assert parsed == jtel.parse_exposition(j.exposition())
    assert parsed["service_admission_total{decision=admit,reason=ok}"] == 3.0
    assert sp["series"]["service.calibration"] == {"len": 4, "cap": 4, "total": 11}
    assert p.tenant_view("a") == j.tenant_view("a")
    assert p.detach_tenant("a") == j.detach_tenant("a") == 2
    assert p.snapshot() == j.snapshot()
    assert p.gauge("tenant.eq5_bytes", task="a").value == 0.0


@pytest.mark.parametrize("cap", [1, 16])
def test_ring_bounded_as_jax(cap):
    rp, rj = ptel.Ring(cap), jtel.Ring(cap)
    for i in range(200):
        rp.append(i)
        rj.append(i)
        assert len(rp) == len(rj) <= cap
    assert list(rp) == list(rj) == list(range(200 - cap, 200))
    assert rp.total == rj.total == 200
    assert rp[-3:] == rj[-3:] and rp[0] == rj[0]
    with pytest.raises(IndexError):
        rp[cap]
    with pytest.raises(ValueError):
        ptel.Ring(0)


def test_disabled_registry_hands_out_shared_null():
    reg = ptel.TelemetryRegistry(enabled=False)
    c = reg.counter("x", task="a")
    assert c is ptel._NULL is reg.gauge("y") is reg.histogram("z") is reg.series("w")
    c.inc()
    reg.series("w").append(5)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}, "series": {}}


def _drive_tracer(tr_mod):
    tr = tr_mod.SpanTracer(cap=64)
    with tr.span("service.step", track="service"):
        with tr.span("engine.iteration", track="engine", args={"micros": 2}):
            with tr.span("engine.micro_step", track="engine"):
                pass
        tr.instant("tenant.attach", track="tenant:alice")
        with tr.span("decode.bind", track="tenant:alice"):
            pass
    tr.instant("tenant.attach", track="tenant:bob")
    return tr


def _strip_ts(doc):
    return [{k: v for k, v in e.items() if k != "ts"} for e in doc["traceEvents"]]


def test_chrome_trace_and_validation_equal_jax():
    tj, tp = _drive_tracer(jtr), _drive_tracer(ptr)
    dj, dp = tj.chrome_trace(), tp.chrome_trace()
    assert _strip_ts(dp) == _strip_ts(dj)
    phases = ["service.step", "engine.iteration", "engine.micro_step", "decode.bind"]
    sp = ptr.validate_chrome_trace(json.loads(json.dumps(dp)), require_phases=phases)
    assert sp == jtr.validate_chrome_trace(dj, require_phases=phases)
    assert sp["spans"] == 4 and set(sp["tenant_tids"]) == {"tenant:alice", "tenant:bob"}


@pytest.mark.parametrize("fault", ["unbalanced", "nesting", "no completed span"])
def test_trace_validation_rejects_malformed_as_jax(fault):
    docs = []
    for mod in (jtr, ptr):
        tr = mod.SpanTracer()
        tid = tr.tid_for("host")
        if fault == "unbalanced":
            tr._record("B", "dangling", tid, None)
        elif fault == "nesting":
            for ph, name in (("B", "outer"), ("B", "inner"), ("E", "outer"), ("E", "inner")):
                tr._record(ph, name, tid, None)
        else:
            with tr.span("present.phase"):
                pass
        docs.append(tr.chrome_trace())
    errors = []
    for mod, doc in zip((jtr, ptr), docs):
        with pytest.raises(ValueError, match=fault) as e:
            mod.validate_chrome_trace(doc, require_phases=["missing.phase"])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_tracer_ring_caps_events():
    tr = ptr.SpanTracer(cap=8)
    for _ in range(50):
        with tr.span("s"):
            pass
    assert len(tr.events) == 8 and tr.events.total == 100
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 92


def test_tracer_off_allocates_nothing():
    """Off (the default), every span site returns the one shared no-op and
    a loop of span / instant calls allocates no memory block."""
    assert not ptr.get_tracer().enabled
    assert ptr.span("engine.micro_step", track="engine") is ptr._NULL_SPAN
    assert ptr.span("x", args={"k": 1}) is ptr._NULL_SPAN

    def loop(n):
        for _ in range(n):
            with ptr.span("engine.micro_step", track="engine"):
                pass
            ptr.instant("request.bind", track="tenant:t")

    loop(10)
    before = sys.getallocatedblocks()
    loop(20000)
    assert sys.getallocatedblocks() - before <= 2


def test_tracer_on_records_profiler_ranges():
    """On, each span is also a profiler range: a torch profile of the
    traced region holds the span names."""
    tr = ptr.SpanTracer()
    prev = ptr.set_tracer(tr)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with ptr.span("engine.iteration", track="engine"):
                with ptr.span("engine.micro_step", track="engine"):
                    torch.ones(4).sum()
    finally:
        assert ptr.set_tracer(prev) is tr
    names = {e.key for e in prof.key_averages()}
    assert {"engine.iteration", "engine.micro_step"} <= names
    assert ptr.validate_chrome_trace(tr.chrome_trace())["spans"] == 2


def test_validate_cli(tmp_path):
    tr = _drive_tracer(ptr)
    path = tmp_path / "trace.json"
    tr.save(str(path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", str(path),
                         "--require-phase", "engine.iteration", "--require-tenants", "2"],
                        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["spans"] == 4
    bad = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", str(path),
                          "--require-phase", "decode.micro_step"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "TRACE INVALID" in bad.stderr


def test_log_rate_limit_and_configure(monkeypatch):
    f = plog.RateLimitFilter(interval=3600.0, burst=2)

    def rec(msg):
        return logging.LogRecord("repro_torch.obs.t", logging.INFO, __file__, 1, msg, None, None)

    assert [f.filter(rec("same %d")) for _ in range(5)] == [True, True, False, False, False]
    assert f.filter(rec("different"))
    f._state[("same %d", logging.INFO)][0] -= 7200.0
    r = rec("same %d")
    assert f.filter(r) and str(r.msg).startswith("[3 similar suppressed]")
    monkeypatch.setenv("REPRO_LOG", "warning")
    lg = plog.configure()
    n = len(lg.handlers)
    assert plog.configure() is lg and len(lg.handlers) == n
    assert lg.level == logging.WARNING
    assert plog.get_logger("serve").name == "repro_torch.obs.serve"


def test_service_run_traces_and_stays_bounded():
    """A co-serving service run on the CPU with churn, traced: the chrome
    trace validates with every engine, decode and service phase, each
    tenant keeps one lane, every ring stays within its cap, and a departed
    tenant's instruments are dropped."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.task import ParallelismSpec
    from repro_torch.data.synthetic import make_task
    from repro_torch.peft.methods import AdapterConfig
    from repro_torch.serve import CoServeConfig, MuxTuneService, RequestSpec, TenantSpec

    telemetry = ptel.TelemetryRegistry(ring_cap=8)
    tracer = ptr.SpanTracer()
    prev = ptr.set_tracer(tracer)
    try:
        svc = MuxTuneService(smoke_config("llama3.2-3b"), ParallelismSpec(),
                             enable_fusion=False, reserve_slots=2, auto_recalibrate=False,
                             telemetry=telemetry, device="cpu",
                             coserve=CoServeConfig(decode_slots=2, decode_max_len=48,
                                                   max_new_cap=8, slo_seconds=2.0))
        svc.submit(TenantSpec(make_task("a", "sst2", 2, AdapterConfig("lora", rank=4), seed=0),
                              target_steps=14))
        svc.submit(TenantSpec(make_task("b", "qa", 2, AdapterConfig("prefix", rank=4), seed=1),
                              target_steps=3))
        n_req = 0
        for it in range(12):
            if it == 5:  # churn: c arrives after b completed
                svc.submit(TenantSpec(make_task("c", "rte", 2, AdapterConfig("dora", rank=4),
                                                seed=2), target_steps=3))
            live = [t for t in ("a", "b", "c") if t in svc.resident_ids]
            while n_req < 24 and sum(r.state in ("pending", "decoding")
                                     for r in svc.coserve.requests.values()) < 2:
                svc.submit_request(live[n_req % len(live)],
                                   RequestSpec(np.arange(1, 7), max_new_tokens=2,
                                               slo_class=n_req % 2))
                n_req += 1
            svc.step()
    finally:
        ptr.set_tracer(prev)
    stats = ptr.validate_chrome_trace(tracer.chrome_trace(), require_phases=[
        "service.step", "service.replan", "engine.iteration", "engine.prefetch",
        "engine.micro_step", "engine.sync", "decode.bind", "decode.micro_step",
        "decode.accounting_sync"])
    assert set(stats["tenant_tids"]) == {"tenant:a", "tenant:b", "tenant:c"}
    assert stats["phases"]["service.step"] == 12
    assert svc.record("b").state == svc.record("c").state == "completed"
    snap = telemetry.snapshot()
    assert snap["counters"]["service.admission{decision=admit,reason=ok}"] == 3.0
    assert any(k.startswith("decode.token_seconds") for k in snap["histograms"])
    for name, meta in snap["series"].items():
        assert meta["len"] <= 8, name
    for h in telemetry._histograms.values():
        assert len(h.window) <= 8
    # more observations landed than a window keeps
    assert max(h.count for h in telemetry._histograms.values()) > 8
    # b and c departed: their labeled instruments went with them
    assert not any("task=b" in k or "task=c" in k for k in snap["gauges"])
    assert snap["gauges"]["tenant.eq5_bytes{task=a}"] > 0
