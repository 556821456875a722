"""Token-level SLO co-serving: inference decode traffic next to fine-tuning
(port of ``repro.serve.inference``).

MuxTune's serving tier (FlexLLM-style): the same multiplexed backbone that
fine-tunes N tenants also answers their inference requests.  Decode tokens
are packed into each training iteration under a latency SLO — the scheduler
sizes the per-iteration decode micro-batch from the calibrated cost model's
decode-token term (falling back to measured per-token latency once samples
exist), so training throughput degrades by at most the SLO headroom and
decode latency stays bounded while fine-tuning runs at full tilt.

Data plane: ONE fused decode pool (``launch.steps``) with ``decode_slots``
rows; each row binds to a request serving some resident tenant's adapter
stack (any of the eight PEFT kinds — the decode path routes through the same
``ApplyContext`` Dispatch/Aggregate as training, and prefix-tuning's
learned k/v rows are folded into the row's KV cache at bind time).
Row->task routing enters the steps as per-row slot tensors, so binding,
unbinding and tenant churn rebuild nothing.

Dispatch discipline: request BINDS (batched multi-row chunked prefill) are
dispatched through the engine's ``interleave`` hook — their device work is
queued on the stream between the training iteration's micro steps — and
the iteration's decode micro-batch runs as one timed segment after the
iteration's single sync point.  A latency sample is a wall time taken only
once the work it times has finished on the device (the segment ends with
the pool's accounting read, and binds flushed just before it are waited
for before its clock starts), so p50/p99 time device work, not launches.

Continuous batching: the interleave hook does more than drain the binds
staged at iteration start — between training micro-steps it also binds
NEWLY queued requests onto free pool rows (highest-priority SLO class
first) and keeps bound rows generating with resumable decode micro-steps,
so a request submitted mid-iteration begins decoding before the
iteration's final micro-step instead of waiting for the next ``prepare``.
Tokens generated mid-iteration are separated from the timed end-of-
iteration segment by one extra small accounting sync, keeping the recorded
per-token latency honest.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.telemetry import TelemetryRegistry
from repro_torch.obs.tracing import instant

PENDING = "pending"
DECODING = "decoding"
DONE = "done"
CANCELLED = "cancelled"
REJECTED = "rejected"


@dataclass(frozen=True)
class CoServeConfig:
    decode_slots: int = 2        # fused pool rows (concurrent requests)
    decode_max_len: int = 64     # per-row context cap (prompt + generation)
    max_new_cap: int = 16        # generation buffer rows
    prompt_bucket: int = 16      # prompts pad up to a bucket (one bind shape)
    slo_seconds: float = 0.5     # per-iteration latency target (train + decode)
    min_tokens: int = 1          # decode floor per iteration when traffic waits
    max_tokens_per_iter: int = 64
    latency_window: int = 512    # per-token latency samples kept for p50/p99
    # SLO-class preemption: when a strictly higher-class (lower number)
    # request is queued and no pool row is free, evict the lowest-class
    # in-flight row and requeue it via the pool-generation recovery path
    preempt: bool = True
    # per-request completion deadline in service ITERATIONS from submit,
    # indexed by SLO class (the last entry covers higher classes).  A DONE
    # request whose makespan beat its class deadline counts as SLO-met;
    # ``slo_attainment()`` reports the attainment percentage per class —
    # the signal MuxServe/FlexLLM-style placement policies optimize for.
    slo_deadline_iters: tuple = (2, 4, 8)


@dataclass
class InferenceRequest:
    request_id: str
    task_id: str                 # tenant whose adapter serves this request
    prompt: np.ndarray           # [Lp] int32
    max_new_tokens: int
    state: str = PENDING
    reason: str = ""
    submit_clock: int = 0
    bind_clock: int = -1
    finish_clock: int = -1
    row: int = -1
    tokens_out: Optional[np.ndarray] = None
    # per-request sampling params (0-temperature = greedy; 0/1.0 = filters
    # off) — pool state on the device, set at bind
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # SLO class: lower = higher priority; pool rows are granted to the
    # lowest class first (FIFO by submit order within a class)
    slo_class: int = 0
    # set at retirement: did the request complete within its class deadline?
    slo_met: Optional[bool] = None

    @classmethod
    def from_spec(cls, spec, task_id: str, request_id: str,
                  submit_clock: int = 0) -> "InferenceRequest":
        """Build a request from a :class:`repro_torch.serve.spec.RequestSpec` —
        the durable record crash recovery re-creates requests from."""
        return cls(
            request_id=request_id,
            task_id=task_id,
            prompt=spec.prompt_array(),
            max_new_tokens=int(spec.max_new_tokens),
            submit_clock=int(submit_clock),
            temperature=float(spec.temperature),
            top_k=int(spec.top_k),
            top_p=float(spec.top_p),
            seed=int(spec.seed),
            slo_class=int(spec.slo_class),
        )

    @property
    def queue_wait(self) -> int:
        return self.bind_clock - self.submit_clock if self.bind_clock >= 0 else -1

    def accounting(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "task_id": self.task_id,
            "state": self.state,
            "reason": self.reason,
            "queue_wait": self.queue_wait,
            "prompt_tokens": int(len(self.prompt)),
            "generated": 0 if self.tokens_out is None else int(len(self.tokens_out)),
            "makespan": (self.finish_clock - self.submit_clock
                         if self.finish_clock >= 0 else -1),
            "slo_class": self.slo_class,
            "slo_met": self.slo_met,
        }

    def sampling_arrays(self) -> Dict[str, np.ndarray]:
        """[1]-row sampling state for the bind launch (``rng`` is the row's
        generator seed, so fixed seeds replay exactly)."""
        return {
            "temp": np.asarray([self.temperature], np.float32),
            "top_k": np.asarray([self.top_k], np.int32),
            "top_p": np.asarray([self.top_p], np.float32),
            "rng": np.asarray([self.seed], np.int64),
        }


class DecodeScheduler:
    """Owns the decode pool bindings and the SLO token-packing policy."""

    def __init__(self, config: Optional[CoServeConfig] = None,
                 telemetry: Optional[TelemetryRegistry] = None):
        self.config = config or CoServeConfig()
        # a scheduler without an owning service records into a disabled
        # registry (null instruments — zero overhead, no behavior change)
        self.telemetry = telemetry or TelemetryRegistry(enabled=False)
        # deadline-met/missed per SLO class (kept as plain dicts so the
        # accounting works even with telemetry off)
        self.slo_met: Dict[int, int] = {}
        self.slo_missed: Dict[int, int] = {}
        self.requests: Dict[str, InferenceRequest] = {}
        self.queue: deque = deque()   # request ids awaiting a pool row
        self.rows: List[Optional[str]] = [None] * self.config.decode_slots
        self._pool_gen = -1
        self._prev_n_out = np.zeros((self.config.decode_slots,), np.int64)
        self._pending_binds: List[tuple] = []
        # binds flushed after the iteration's sync: the timed decode segment
        # waits for them before its clock starts
        self._flushed = False
        #: binds assigned for the current iteration — their prefill (and
        #: first launch) rides the training dispatch queue, so the
        #: service excludes such iterations from the calibration trace
        self.last_bind_count = 0
        self._row_ctx = None          # (row_slots, scales) for this iteration
        self._task_index: Optional[Dict[str, int]] = None  # staged by prepare
        self._clock = 0
        self.token_seconds: deque = deque(maxlen=self.config.latency_window)
        # per fused MICRO-STEP wall samples — the budget unit (one micro-step
        # yields one token on EVERY active row, so per-token and per-step
        # latency differ by the active-row factor)
        self.step_seconds: deque = deque(maxlen=self.config.latency_window)
        self._cold_token_seconds: deque = deque(maxlen=8)  # first-launch-polluted
        self.total_tokens = 0
        # continuous batching: binds dispatched mid-iteration (cumulative)
        # and resumable decode micro-steps interleaved into the current /
        # last iteration's training dispatch queue
        self.mid_iteration_binds = 0
        self._mid_micros = 0
        self.last_mid_micros = 0
        # decode calibration channel: the last warm timed segment's
        # per-micro-step seconds and decoding-row count (DecodeSample feed)
        self.last_step_seconds: Optional[float] = None
        self.last_step_rows = 0
        # SLO-class preemptions performed (victim rows requeued, not lost)
        self.preemptions = 0

    # ------------------------------------------------------------------
    # request lifecycle

    def submit(self, request: InferenceRequest) -> InferenceRequest:
        c = self.config
        if request.request_id in self.requests and \
                self.requests[request.request_id].state in (PENDING, DECODING):
            raise ValueError(f"request {request.request_id} already live")
        if (len(request.prompt) + request.max_new_tokens > c.decode_max_len
                or request.max_new_tokens > c.max_new_cap
                or len(request.prompt) < 1):
            return self.reject(request, "length_caps")
        self.requests[request.request_id] = request
        self.queue.append(request.request_id)
        instant("request.submit", track=f"tenant:{request.task_id}",
                args={"request": request.request_id,
                      "slo_class": request.slo_class})
        return request

    def reject(self, request: InferenceRequest, reason: str) -> InferenceRequest:
        request.state, request.reason = REJECTED, reason
        self.requests[request.request_id] = request
        return request

    def cancel(self, request_id: str, clock: int, reason: str = "") -> None:
        req = self.requests[request_id]
        if req.state not in (PENDING, DECODING):
            return
        if req.state == DECODING and req.row >= 0:
            self.rows[req.row] = None  # device row decays outside any window
        if request_id in self.queue:
            self.queue.remove(request_id)
        req.state, req.reason, req.finish_clock = CANCELLED, reason, clock

    def drop_task(self, task_id: str, clock: int) -> None:
        """A tenant departed: cancel its queued AND in-flight requests."""
        for rid, req in list(self.requests.items()):
            if req.task_id == task_id and req.state in (PENDING, DECODING):
                self.cancel(rid, clock, reason="tenant_departed")

    def drain_task(self, task_id: str) -> List[InferenceRequest]:
        """Live migration: remove a tenant's queued and in-flight requests
        from this scheduler WITHOUT cancelling them.  In-flight rows are
        freed via the same reset the pool-generation recovery path uses;
        the returned request objects are re-submitted on the target
        instance (``adopt``), where the bind re-prefills the prompt and the
        seeded sampler replays the same token sequence."""
        drained: List[InferenceRequest] = []
        for rid, req in list(self.requests.items()):
            if req.task_id != task_id or req.state not in (PENDING, DECODING):
                continue
            if req.state == DECODING and req.row >= 0:
                self.rows[req.row] = None
            if rid in self.queue:
                self.queue.remove(rid)
            req.state, req.row, req.bind_clock = PENDING, -1, -1
            req.tokens_out = None
            del self.requests[rid]
            drained.append(req)
            instant("request.drain", track=f"tenant:{task_id}",
                    args={"request": rid})
        if drained:
            ids = {r.request_id for r in drained}
            self._pending_binds = [
                (row, req) for row, req in self._pending_binds
                if req.request_id not in ids]
        return drained

    def adopt(self, request: InferenceRequest) -> InferenceRequest:
        """Live migration: accept a request drained from another instance.
        It queues like a fresh submission (length caps were validated at
        original submit; the pool geometry is config-identical fleet-wide)."""
        if request.request_id in self.requests and \
                self.requests[request.request_id].state in (PENDING, DECODING):
            raise ValueError(f"request {request.request_id} already live")
        self.requests[request.request_id] = request
        self.queue.append(request.request_id)
        instant("request.adopt", track=f"tenant:{request.task_id}",
                args={"request": request.request_id})
        return request

    def has_traffic(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.rows)

    def has_actionable(self, task_index: Dict[str, int]) -> bool:
        """True when this iteration has decode work to run: a bound row, or
        a queued request whose tenant is resident.  Queued traffic for
        never-resident tenants must NOT allocate the pool or add the
        per-iteration decode sync."""
        return any(r is not None for r in self.rows) or any(
            self.requests[q].task_id in task_index for q in self.queue)

    # ------------------------------------------------------------------
    # per-iteration protocol (driven by MuxTuneService.step)

    def prepare(self, engine, task_index: Dict[str, int], clock: int) -> None:
        """Ensure the pool exists, recover from pool re-allocations, assign
        queued requests to free rows, and stage this iteration's row->slot
        routing vectors."""
        c = self.config
        engine.ensure_decode_pool(c.decode_slots, c.decode_max_len,
                                  c.max_new_cap)
        pool_key = (id(engine), engine.decode_pool_gen)
        if pool_key != self._pool_gen:
            # pool re-allocated (first use, or prefix-region growth): every
            # in-flight binding was lost — re-queue those requests up front
            for r, rid in enumerate(self.rows):
                if rid is not None:
                    req = self.requests[rid]
                    req.state, req.row = PENDING, -1
                    self.queue.appendleft(rid)
            self.rows = [None] * c.decode_slots
            self._prev_n_out[:] = 0
            self._pool_gen = pool_key
        # bind queued requests onto free rows (dispatch via interleave hook)
        self._task_index = dict(task_index)
        self._clock = clock
        self._mid_micros = 0
        self._pending_binds = []
        for r in range(c.decode_slots):
            if self.rows[r] is not None:
                continue
            rid = self._next_candidate()
            if rid is None:
                break
            self._claim(rid, r)
            self._pending_binds.append((r, self.requests[rid]))
        if c.preempt:
            self._preempt_for_priority()
        self.last_bind_count = len(self._pending_binds)
        self._refresh_row_ctx(engine)

    def _preempt_for_priority(self) -> None:
        """SLO-class preemption: while a strictly higher-class request is
        queued with no free row, evict the LOWEST-class in-flight row and
        requeue its request via the pool-generation recovery reset (state
        back to PENDING, row -1, front of queue — on rebind the prompt
        re-prefills and the seeded sampler regenerates identically).  Rows
        claimed by this iteration's staged binds are never victims."""
        while True:
            rid = self._next_candidate()
            if rid is None or any(r is None for r in self.rows):
                return
            cand = self.requests[rid]
            staged = {req.request_id for _, req in self._pending_binds}
            victims = [
                (self.requests[h].slo_class, self.requests[h].submit_clock, r)
                for r, h in enumerate(self.rows)
                if h is not None and h not in staged
                and self.requests[h].state == DECODING
            ]
            if not victims:
                return
            vcls, _, vrow = max(victims)
            if vcls <= cand.slo_class:
                return  # no strictly lower-class victim: nothing to evict
            victim = self.requests[self.rows[vrow]]
            victim.state, victim.row, victim.bind_clock = PENDING, -1, -1
            victim.tokens_out = None
            self.queue.appendleft(victim.request_id)
            self.rows[vrow] = None
            self.preemptions += 1
            self.telemetry.counter(
                "decode.preemptions", slo_class=str(victim.slo_class)).inc()
            instant("request.preempt", track=f"tenant:{victim.task_id}",
                    args={"request": victim.request_id,
                          "by": cand.request_id,
                          "victim_class": victim.slo_class,
                          "winner_class": cand.slo_class})
            self._claim(rid, vrow)
            self._pending_binds.append((vrow, cand))

    def _next_candidate(self) -> Optional[str]:
        """Highest-priority queued request whose tenant is resident: lowest
        SLO class first, FIFO by submit order within a class.  Non-resident
        (or lower-priority) heads never block ready traffic behind them."""
        best = None
        for i, q in enumerate(self.queue):
            req = self.requests[q]
            if req.task_id not in (self._task_index or {}):
                continue
            key = (req.slo_class, req.submit_clock, i)
            if best is None or key < best[0]:
                best = (key, q)
        return None if best is None else best[1]

    def _claim(self, rid: str, row: int) -> None:
        self.queue.remove(rid)
        req = self.requests[rid]
        self.rows[row] = rid
        req.state, req.row, req.bind_clock = DECODING, row, self._clock
        self.telemetry.histogram("decode.queue_wait_iters",
                                 slo_class=str(req.slo_class)).observe(
            float(req.queue_wait))
        instant("request.bind", track=f"tenant:{req.task_id}",
                args={"request": rid, "row": row,
                      "queue_wait": req.queue_wait})

    def _refresh_row_ctx(self, engine) -> None:
        row_task = [
            (self._task_index or {}).get(self.requests[rid].task_id, -1)
            if rid else -1
            for rid in self.rows
        ]
        self._row_ctx = engine.decode_row_ctx(row_task)

    def interleave_fn(self, engine):
        """Callable for ``PEFTEngine.run_iteration(interleave=...)``: each
        invocation dispatches one unit of decode work into the training
        iteration's queue — a pending BIND (prefill), a CONTINUOUS-BATCHING
        bind of a request queued after ``prepare`` onto a free row, or one
        resumable decode micro-step for the bound rows."""
        def cb() -> None:
            if self._pending_binds:
                row, req = self._pending_binds.pop(0)
                self._dispatch_bind_group(
                    engine, self._bucket(len(req.prompt)), [(row, req)])
                return
            if self._bind_free_rows(engine):
                return
            if (any(r is not None for r in self.rows)
                    and engine.decode_micro_ready()
                    and self._mid_micros < self.config.max_tokens_per_iter):
                row_slots, scales = self._row_ctx
                engine.dispatch_decode_micro(row_slots, scales)
                self._mid_micros += 1
        return cb

    def _bind_free_rows(self, engine) -> bool:
        """Continuous batching: bind the highest-priority queued resident
        request onto a free pool row MID-iteration (between training
        micro-steps) instead of waiting for the next ``prepare``.  Returns
        True when a bind was dispatched."""
        if self._task_index is None or self._row_ctx is None:
            return False
        free = next((r for r, rid in enumerate(self.rows) if rid is None),
                    None)
        if free is None:
            return False
        rid = self._next_candidate()
        if rid is None:
            return False
        self._claim(rid, free)
        req = self.requests[rid]
        # routing must reflect the new binding before its bind / any
        # subsequent micro-step is dispatched
        self._refresh_row_ctx(engine)
        self._dispatch_bind_group(
            engine, self._bucket(len(req.prompt)), [(free, req)])
        self.mid_iteration_binds += 1
        # bind prefills ride the training queue: exclude this
        # iteration from the training-side calibration trace too
        self.last_bind_count += 1
        return True

    def flush_binds(self, engine) -> None:
        # batched-bind plumbing: remaining same-bucket binds go out in ONE
        # multi-row prefill launch each
        groups: Dict[int, List[tuple]] = {}
        for row, req in self._pending_binds:
            groups.setdefault(self._bucket(len(req.prompt)), []).append(
                (row, req))
        self._pending_binds = []
        for bucket in sorted(groups):
            self._dispatch_bind_group(engine, bucket, groups[bucket])
            self._flushed = True

    def _bucket(self, Lp: int) -> int:
        # round up to the prompt bucket, but never past the cache length —
        # submit() guarantees Lp <= decode_max_len, so the clamp always fits
        c = self.config
        return min(-(-Lp // c.prompt_bucket) * c.prompt_bucket,
                   c.decode_max_len)

    def _dispatch_bind_group(self, engine, bucket: int, items: List[tuple]) -> None:
        """Dispatch ``len(items)`` same-bucket binds as one batched
        multi-row prefill launch with per-request sampling params."""
        R = len(items)
        tokens = np.zeros((R, bucket), np.int32)
        rows = np.zeros((R,), np.int32)
        lengths = np.zeros((R,), np.int32)
        max_new = np.zeros((R,), np.int32)
        sampling = {
            "temp": np.zeros((R,), np.float32),
            "top_k": np.zeros((R,), np.int32),
            "top_p": np.ones((R,), np.float32),
            "rng": np.zeros((R,), np.int64),
        }
        for i, (row, req) in enumerate(items):
            Lp = len(req.prompt)
            tokens[i, :Lp] = req.prompt
            rows[i], lengths[i], max_new[i] = row, Lp, req.max_new_tokens
            s1 = req.sampling_arrays()
            for k in sampling:
                sampling[k][i] = s1[k][0]
        row_slots, scales = self._row_ctx
        s = {k: v[rows] for k, v in row_slots.items()}
        engine.dispatch_decode_bind_batched(rows, tokens, lengths, s, scales,
                                            max_new, sampling)
        self._prev_n_out[rows] = 0

    # ------------------------------------------------------------------
    # SLO token packing

    def measured_step_seconds(self) -> Optional[float]:
        if not self.step_seconds:
            return None
        return float(np.median(self.step_seconds))

    def token_budget(self, cost_model, mean_ctx: float,
                     predicted_train_seconds: float) -> int:
        """Fused decode MICRO-STEPS to pack into this iteration: fill the
        SLO headroom left by the (calibrated) training-iteration prediction.
        Both estimator paths are per micro-step — the measured median and
        the cost model's ``decode_token_latency`` (the wall of one fused
        step over all pool rows) — so the budget unit matches what
        ``run_tokens`` dispatches."""
        c = self.config
        if not (any(self.rows) or self._pending_binds):
            return 0
        step = self.measured_step_seconds()
        if step is None:
            step = cost_model.decode_token_latency(c.decode_slots,
                                                   int(max(mean_ctx, 1)))
        headroom = max(c.slo_seconds - predicted_train_seconds, 0.0)
        k = int(headroom / max(step, 1e-9))
        return max(min(k, c.max_tokens_per_iter), c.min_tokens)

    # ------------------------------------------------------------------
    # decode segment + retirement

    def run_tokens(self, engine, k: int, clock: int) -> tuple:
        """Dispatch ``k`` fused decode micro-steps, sync the pool's small
        accounting counters ONCE, record per-token latency samples and
        retire finished requests.  Returns ``(tokens_decoded, wall_seconds,
        per_task_tokens)`` — the last bills each tenant for the decode
        tokens its requests consumed this iteration.

        Tokens generated by MID-iteration micro-steps (continuous batching)
        are split off by one extra small sync before the timed segment:
        they are counted and billed, but their wall time is hidden inside
        the training dispatch queue, so they must not enter the per-token
        latency window."""
        if self._row_ctx is None:
            return 0, 0.0, {}

        per_task: Dict[str, int] = {}

        def attribute(delta: np.ndarray) -> int:
            n = 0
            for r, rid in enumerate(self.rows):
                if rid is None:
                    continue
                tid = self.requests[rid].task_id
                n += int(delta[r])
                per_task[tid] = per_task.get(tid, 0) + int(delta[r])
            return n

        mid_decoded = 0
        self.last_mid_micros = self._mid_micros
        if self._mid_micros > 0:
            pre = engine.decode_accounting()
            n_pre = np.asarray(pre["n_out"], np.int64)
            mid_decoded = attribute(np.maximum(n_pre - self._prev_n_out, 0))
            self._prev_n_out = n_pre.copy()
            self._mid_micros = 0
        seg_rows = sum(1 for rid in self.rows if rid is not None)
        row_slots, scales = self._row_ctx
        warm = engine.decode_micro_ready()  # cold first call = the kernels' build
        if self._flushed and engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)  # the flushed binds' prefill
        self._flushed = False
        t0 = time.perf_counter()
        for _ in range(max(k, 0)):
            engine.dispatch_decode_micro(row_slots, scales)
        acct = engine.decode_accounting()  # the decode segment's one sync
        wall = time.perf_counter() - t0
        n_out = np.asarray(acct["n_out"], np.int64)
        delta = np.maximum(n_out - self._prev_n_out, 0)
        self._prev_n_out = n_out.copy()
        decoded = attribute(delta)
        self.last_step_seconds = None
        self.last_step_rows = 0
        if decoded > 0:
            per_tok = wall / decoded
            if warm:
                self.token_seconds.extend([per_tok] * min(decoded, 64))
                # decode token latency per SLO class: one observation per
                # class active in this warm timed segment (the fused step's
                # wall is shared across rows, so per-class windows share the
                # sample but diverge as class mixes shift across segments)
                for cls in {self.requests[rid].slo_class
                            for rid in self.rows if rid is not None}:
                    self.telemetry.histogram(
                        "decode.token_seconds",
                        slo_class=str(cls)).observe(per_tok)
                if k > 0:
                    self.step_seconds.append(wall / k)
                    # decode calibration channel: one DecodeSample per warm
                    # timed segment
                    self.last_step_seconds = wall / k
                    self.last_step_rows = seg_rows
            else:
                # cold-start segments time the micro step's first launch (on
                # the card, the kernels' build), not decode — keep them out
                # of the SLO p50/p99 window and the budget estimator
                # (reported only until warm samples exist)
                self._cold_token_seconds.append(per_tok)
        self.total_tokens += decoded + mid_decoded
        for r, rid in enumerate(self.rows):
            if rid is None:
                continue
            req = self.requests[rid]
            if acct["active"][r] == 0 and req.state == DECODING:
                req.tokens_out = engine.decode_outputs(r)[: int(n_out[r])]
                self._retire(req, clock)
                self.rows[r] = None
        return decoded + mid_decoded, wall, per_task

    def _retire(self, req: InferenceRequest, clock: int) -> None:
        """Mark a request DONE and score it against its class deadline."""
        req.state, req.finish_clock = DONE, clock
        d = self.config.slo_deadline_iters
        deadline = d[min(req.slo_class, len(d) - 1)]
        req.slo_met = (req.finish_clock - req.submit_clock) <= deadline
        bucket = self.slo_met if req.slo_met else self.slo_missed
        bucket[req.slo_class] = bucket.get(req.slo_class, 0) + 1
        self.telemetry.counter(
            "decode.slo", outcome="met" if req.slo_met else "missed",
            slo_class=str(req.slo_class)).inc()
        instant("request.done", track=f"tenant:{req.task_id}",
                args={"request": req.request_id, "slo_met": req.slo_met,
                      "makespan": req.finish_clock - req.submit_clock})

    # ------------------------------------------------------------------
    # metrics

    def latency_percentiles(self) -> Dict[str, float]:
        samples = self.token_seconds or self._cold_token_seconds
        if not samples:
            return {"decode_p50_s": 0.0, "decode_p99_s": 0.0}
        arr = np.asarray(samples, np.float64)
        return {
            "decode_p50_s": float(np.percentile(arr, 50)),
            "decode_p99_s": float(np.percentile(arr, 99)),
        }

    def slo_attainment(self) -> Dict[str, Any]:
        """Deadline attainment of retired (DONE) requests, overall and per
        SLO class.  Cancelled/rejected requests are excluded — they never
        raced a deadline."""
        met = sum(self.slo_met.values())
        missed = sum(self.slo_missed.values())
        per_class = {
            c: 100.0 * self.slo_met.get(c, 0)
            / max(self.slo_met.get(c, 0) + self.slo_missed.get(c, 0), 1)
            for c in sorted(set(self.slo_met) | set(self.slo_missed))
        }
        return {
            "slo_attainment_pct": 100.0 * met / max(met + missed, 1),
            "slo_met": met,
            "slo_missed": missed,
            "slo_attainment_by_class": per_class,
        }

    def accounting(self) -> Dict[str, Any]:
        reqs = [r.accounting() for r in self.requests.values()]
        done = [r for r in self.requests.values() if r.state == DONE]
        out = {
            "requests": reqs,
            "completed_requests": len(done),
            "decode_tokens": self.total_tokens,
            "queued_requests": len(self.queue),
            "mid_iteration_binds": self.mid_iteration_binds,
            "preemptions": self.preemptions,
        }
        out.update(self.latency_percentiles())
        out.update(self.slo_attainment())
        return out
