"""Telemetry registry: labeled counters / gauges / histograms / series
(port of ``repro.obs.telemetry``, pure Python as there).

The fleet tier's sensor layer (ROADMAP): every placement, preemption and
autoscaling policy needs per-tenant latency, queue-wait and footprint
signals to act on, and both FlexLLM and MuxServe justify their multiplexing
decisions with exactly this kind of per-request / per-phase evidence.  This
module gives the serving stack one place to put those signals:

  * ``Counter`` / ``Gauge`` / ``Histogram`` — labeled instruments, cheap
    enough for the serving control loop (a histogram observation is one
    ring-buffer append; nothing allocates per observation);
  * ``Ring`` — a bounded append-only buffer with a list-like read API,
    used both inside histograms and as raw bounded *series* (the service's
    ``memory_trace`` / ``calibration_trace`` / ``decode_trace`` are rings:
    long replays no longer grow host memory without bound);
  * per-tenant views keyed by the ``task`` label (and ``slo_class`` for
    decode latency): ``tenant_view`` collects one tenant's instruments,
    ``detach_tenant`` drops them on churn so a departed tenant leaks no
    series;
  * ``snapshot()`` — one JSON-able dict of everything (CI uploads it), and
    ``exposition()`` — Prometheus-style text format, with
    ``parse_exposition`` as the round-trip used by schema tests.

Zero-overhead-when-off: a disabled registry hands out shared null
instruments whose methods do nothing, so instrumented call sites never
branch.  Instruments are host-side only — recording NEVER touches a device
value (callers pass floats they already had), so telemetry can't add a
host-device sync to the engine's stall-free iteration loop.
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

DEFAULT_RING_CAP = 512


class Ring:
    """Bounded append-only ring buffer with a list-like read window.

    Supports ``append``, ``len``, int / slice ``[]`` (negative indices
    included), iteration and truthiness — a drop-in for the unbounded
    Python lists the serving layer used to hoard.  ``total`` counts
    lifetime appends (so boundedness is provable: ``total`` grows without
    bound while ``len`` never exceeds ``cap``).
    """

    __slots__ = ("cap", "total", "_buf", "_start")

    def __init__(self, cap: int = DEFAULT_RING_CAP):
        if cap < 1:
            raise ValueError(f"ring cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.total = 0
        self._buf: List[Any] = []
        self._start = 0

    def append(self, item: Any) -> None:
        if len(self._buf) < self.cap:
            self._buf.append(item)
        else:
            self._buf[self._start] = item
            self._start = (self._start + 1) % self.cap
        self.total += 1

    def clear(self) -> None:
        self._buf = []
        self._start = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __getitem__(self, idx):
        n = len(self._buf)
        if isinstance(idx, slice):
            return [self._at(i) for i in range(*idx.indices(n))]
        i = idx + n if idx < 0 else idx
        if not 0 <= i < n:
            raise IndexError(f"ring index {idx} out of range (len {n})")
        return self._at(i)

    def _at(self, i: int) -> Any:
        return self._buf[(self._start + i) % len(self._buf)]

    def __iter__(self) -> Iterator[Any]:
        return (self._at(i) for i in range(len(self._buf)))

    def __repr__(self) -> str:
        return f"Ring(cap={self.cap}, len={len(self)}, total={self.total})"


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic labeled counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins labeled gauge."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Labeled histogram over a bounded observation ring.

    ``count`` / ``sum`` are lifetime; percentiles are over the retained
    window (the same windowed-percentile convention the decode scheduler's
    p50/p99 already uses).
    """

    __slots__ = ("name", "labels", "count", "sum", "window")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 cap: int = DEFAULT_RING_CAP):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.window = Ring(cap)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.window.append(v)

    def percentile(self, q: float) -> float:
        if not self.window:
            return 0.0
        return float(np.percentile(np.asarray(list(self.window), np.float64), q))

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / max(self.count, 1),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class _Null:
    """Shared no-op instrument handed out by a disabled registry."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0
    total = 0
    cap = 0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def append(self, item: Any) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0, "p99": 0.0}

    def __len__(self) -> int:
        return 0

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return []
        raise IndexError("null instrument is empty")


_NULL = _Null()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class TelemetryRegistry:
    """One instrument namespace for a service instance.

    Instruments are created on first use and cached by ``(name, labels)``;
    the hot path therefore costs one dict lookup plus the instrument's own
    O(1) update.  ``ring_cap`` bounds every histogram window and every raw
    series the registry hands out.
    """

    def __init__(self, enabled: bool = True, ring_cap: int = DEFAULT_RING_CAP):
        self.enabled = enabled
        self.ring_cap = int(ring_cap)
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}
        self._series: Dict[str, Ring] = {}
        self.created_unix = time.time()

    # -- instrument accessors -------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        if not self.enabled:
            return _NULL
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(name, key[1]))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        if not self.enabled:
            return _NULL
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(name, key[1]))
        return g

    def histogram(self, name: str, cap: Optional[int] = None, **labels) -> Histogram:
        if not self.enabled:
            return _NULL
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(name, key[1], cap or self.ring_cap))
        return h

    def series(self, name: str, cap: Optional[int] = None) -> Ring:
        """A raw bounded series (arbitrary payloads, no exposition) — the
        replacement for the service's ad-hoc unbounded trace lists."""
        if not self.enabled:
            return _NULL
        r = self._series.get(name)
        if r is None:
            with self._lock:
                r = self._series.setdefault(name, Ring(cap or self.ring_cap))
        return r

    # -- per-tenant views / churn ---------------------------------------

    def tenant_view(self, task_id: str) -> Dict[str, Dict[str, Any]]:
        """Every instrument labeled ``task=<task_id>`` — the per-tenant
        slice a router / migration policy consumes."""
        tid = str(task_id)
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {},
                                          "histograms": {}}
        for (name, labels), c in self._counters.items():
            if ("task", tid) in labels:
                out["counters"][_flat(name, labels)] = c.value
        for (name, labels), g in self._gauges.items():
            if ("task", tid) in labels:
                out["gauges"][_flat(name, labels)] = g.value
        for (name, labels), h in self._histograms.items():
            if ("task", tid) in labels:
                out["histograms"][_flat(name, labels)] = h.summary()
        return out

    def detach_tenant(self, task_id: str) -> int:
        """Drop every instrument labeled with the departing tenant's task
        id.  Returns the number of instruments dropped — per-tenant series
        must not outlive the tenant (metric isolation under churn)."""
        tid = str(task_id)
        dropped = 0
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                dead = [k for k in table if ("task", tid) in k[1]]
                for k in dead:
                    del table[k]
                dropped += len(dead)
        return dropped

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict of every instrument (CI artifact / debugging)."""
        return {
            "counters": {_flat(n, l): c.value
                         for (n, l), c in sorted(self._counters.items())},
            "gauges": {_flat(n, l): g.value
                       for (n, l), g in sorted(self._gauges.items())},
            "histograms": {_flat(n, l): h.summary()
                           for (n, l), h in sorted(self._histograms.items())},
            "series": {n: {"len": len(r), "cap": r.cap, "total": r.total}
                       for n, r in sorted(self._series.items())},
        }

    def exposition(self) -> str:
        """Prometheus-style text exposition of counters / gauges /
        histogram summaries.  Metric names are sanitized to the Prometheus
        charset; histograms expose ``_count`` / ``_sum`` plus windowed
        ``p50`` / ``p99`` quantile gauges."""
        lines: List[str] = []

        def emit(name: str, labels, value: float, mtype: str,
                 extra_label: Optional[Tuple[str, str]] = None) -> None:
            pname = _prom_name(name)
            if not any(l.startswith(f"# TYPE {pname} ") for l in lines):
                lines.append(f"# TYPE {pname} {mtype}")
            lab = sorted(list(labels) + ([extra_label] if extra_label else []))
            body = ",".join(f'{k}="{_escape(v)}"' for k, v in lab)
            lines.append(f"{pname}{{{body}}} {value!r}" if body
                         else f"{pname} {value!r}")

        for (name, labels), c in sorted(self._counters.items()):
            emit(name + "_total", labels, c.value, "counter")
        for (name, labels), g in sorted(self._gauges.items()):
            emit(name, labels, g.value, "gauge")
        for (name, labels), h in sorted(self._histograms.items()):
            emit(name + "_count", labels, float(h.count), "counter")
            emit(name + "_sum", labels, h.sum, "counter")
            for q in (50, 99):
                emit(name, labels, h.percentile(q), "gauge",
                     extra_label=("quantile", f"0.{q}"))
        return "\n".join(lines) + "\n"

    def save_snapshot(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True, default=float)


def _flat(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[str, float]:
    """Parse Prometheus exposition text back to ``{flat_key: value}`` —
    the snapshot/exposition round-trip checked by the schema tests."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = ""
        if m.group("labels"):
            pairs = sorted(_LABEL_RE.findall(m.group("labels")))
            labels = "{" + ",".join(
                f"{k}={v.encode().decode('unicode_escape')}"
                for k, v in pairs) + "}"
        out[m.group("name") + labels] = float(m.group("value"))
    return out
