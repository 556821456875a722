"""Host-side span tracing with Chrome trace-event export (opens in Perfetto)
(port of ``repro.obs.tracing``).

``SpanTracer`` records begin/end ("B"/"E") events into a bounded ring and
exports the Chrome trace-event JSON format, so a replay run's multi-tenant
timeline (`--trace-out trace.json`) drops straight into Perfetto / chrome://
tracing.  Tracks map to trace *threads*: ``tid_for("tenant:alice")`` hands
out a stable tid per track and emits ``thread_name`` metadata, so every
tenant gets its own named swimlane and per-request spans line up under it.

Each host span also enters a ``torch.profiler.record_function`` range
while the tracer is enabled: when a device profile is being captured
(``torch.profiler.profile``), the host spans appear on the profiler
timeline and the CUDA kernels they launch line up under them.

OFF is the default and costs nothing: the module-level ``span(...)`` helper
returns a shared no-op context manager without allocating, so instrumented
hot loops (the engine's micro-step dispatch) stay stall-free and
allocation-free.  ON costs two ring appends per span.  Recording never
touches device values — tracing cannot add a host-device sync.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.telemetry import Ring

import torch

DEFAULT_EVENT_CAP = 262144
HOST_TRACK = "host"


class _NullSpan:
    """Shared no-op context manager: the OFF path of every span site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """RAII for one B/E pair (+ a profiler range while entered)."""

    __slots__ = ("_tracer", "_name", "_tid", "_args", "_ta")

    def __init__(self, tracer: "SpanTracer", name: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args
        self._ta = None

    def __enter__(self):
        self._tracer._record("B", self._name, self._tid, self._args)
        self._ta = torch.profiler.record_function(self._name)
        self._ta.__enter__()
        return self

    def __exit__(self, *exc):
        self._ta.__exit__(*exc)
        self._tracer._record("E", self._name, self._tid, None)
        return False


class SpanTracer:
    """Bounded host-side span recorder with Chrome trace-event export."""

    def __init__(self, enabled: bool = True, cap: int = DEFAULT_EVENT_CAP,
                 pid: int = 1, process_name: str = "muxtune"):
        self.enabled = enabled
        self.pid = pid
        self.process_name = process_name
        self.events = Ring(cap)
        self._t0 = time.perf_counter_ns()
        self._tids: Dict[str, int] = {}

    # -- tracks ----------------------------------------------------------

    def tid_for(self, track: str) -> int:
        """Stable tid for a track label (``tenant:<id>``, ``engine``, ...).
        First use allocates the next tid; the mapping never changes for the
        tracer's lifetime, so a tenant keeps one swimlane across churn."""
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
        return tid

    # -- recording -------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _record(self, ph: str, name: str, tid: int,
                args: Optional[Dict[str, Any]]) -> None:
        self.events.append((ph, name, self._now_us(), tid, args))

    def span(self, name: str, track: str = HOST_TRACK,
             args: Optional[Dict[str, Any]] = None):
        """Context manager for one span.  ``track`` picks the swimlane;
        ``args`` (small JSON-able dict) shows in the Perfetto detail pane."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, self.tid_for(track), args)

    def instant(self, name: str, track: str = HOST_TRACK,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Zero-duration marker event (tenant submit / attach / retire)."""
        if not self.enabled:
            return
        self._record("i", name, self.tid_for(track), args)

    # -- export ----------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON document (dict form)."""
        ev: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            ev.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                       "tid": tid, "args": {"name": track}})
        for ph, name, ts, tid, args in self.events:
            e: Dict[str, Any] = {"name": name, "ph": ph, "ts": ts,
                                 "pid": self.pid, "tid": tid}
            if ph == "i":
                e["s"] = "t"  # instant scope: thread
            if args:
                e["args"] = dict(args)
            ev.append(e)
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": max(
                    self.events.total - len(self.events), 0)}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ---------------------------------------------------------------------------
# Module-level current tracer (the instrumentation sites' indirection)
# ---------------------------------------------------------------------------

_TRACER = SpanTracer(enabled=False, cap=1)  # default: off, records nothing


def get_tracer() -> SpanTracer:
    return _TRACER


def set_tracer(tracer: SpanTracer) -> SpanTracer:
    """Install ``tracer`` as the current tracer; returns the previous one
    (restore it in tests / after a traced replay)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def span(name: str, track: str = HOST_TRACK,
         args: Optional[Dict[str, Any]] = None):
    """``with span("engine.micro_step", track="engine"): ...`` — records on
    the current tracer; a shared no-op when tracing is off."""
    t = _TRACER
    if not t.enabled:
        return _NULL_SPAN
    return t.span(name, track, args)


def instant(name: str, track: str = HOST_TRACK,
            args: Optional[Dict[str, Any]] = None) -> None:
    t = _TRACER
    if t.enabled:
        t.instant(name, track, args)


# ---------------------------------------------------------------------------
# Schema validation (tests + the CI trace-artifact gate)
# ---------------------------------------------------------------------------


def validate_chrome_trace(doc: Dict[str, Any],
                          require_phases: Optional[List[str]] = None
                          ) -> Dict[str, Any]:
    """Validate a Chrome trace-event document structurally.

    Checks: ``traceEvents`` is a list of dicts with the required fields;
    "B"/"E" events balance into properly nested spans per ``(pid, tid)``;
    timestamps are non-negative and non-decreasing per thread; thread_name
    metadata maps each named track to exactly one tid (stable per-tenant
    tids).  ``require_phases`` additionally asserts >= 1 completed span per
    named phase.  Returns summary stats; raises ``ValueError`` on the first
    violation.
    """
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents missing or empty")
    stacks: Dict[Tuple[int, int], List[str]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    track_tids: Dict[str, set] = {}
    tid_tracks: Dict[Tuple[int, int], set] = {}
    completed: Dict[str, int] = {}
    n_spans = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object: {e!r}")
        ph = e.get("ph")
        if ph is None or "pid" not in e or "tid" not in e:
            raise ValueError(f"event {i} missing ph/pid/tid: {e!r}")
        key = (e["pid"], e["tid"])
        if ph == "M":
            if e.get("name") == "thread_name":
                track = e.get("args", {}).get("name", "")
                track_tids.setdefault(track, set()).add(e["tid"])
                tid_tracks.setdefault(key, set()).add(track)
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} bad ts: {e!r}")
        if ts < last_ts.get(key, 0.0):
            raise ValueError(
                f"event {i} ts regressed on tid {key}: {ts} < {last_ts[key]}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(e.get("name", ""))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E without open B on tid {key}")
            name = stack.pop()
            if e.get("name") not in (None, name):
                raise ValueError(
                    f"event {i}: E {e.get('name')!r} closes B {name!r} "
                    f"(improper nesting on tid {key})")
            completed[name] = completed.get(name, 0) + 1
            n_spans += 1
        elif ph not in ("i", "I", "X", "C"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"unbalanced B events on tid {key}: {stack}")
    for track, tids in track_tids.items():
        if len(tids) != 1:
            raise ValueError(f"track {track!r} mapped to multiple tids: {tids}")
    for key, tracks in tid_tracks.items():
        if len(tracks) != 1:
            raise ValueError(f"tid {key} named by multiple tracks: {tracks}")
    missing = [p for p in (require_phases or []) if completed.get(p, 0) < 1]
    if missing:
        raise ValueError(
            f"required phases with no completed span: {missing}; "
            f"present: {sorted(completed)}")
    tenant_tids = {t: sorted(v)[0] for t, v in track_tids.items()
                   if t.startswith("tenant:")}
    return {"events": len(events), "spans": n_spans,
            "phases": dict(sorted(completed.items())),
            "tenant_tids": tenant_tids}
