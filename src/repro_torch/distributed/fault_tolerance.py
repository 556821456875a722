"""Fault tolerance: restart supervision, straggler mitigation, elasticity
(port of ``repro.distributed.fault_tolerance``; host Python).

* ``TrainSupervisor`` wraps a step loop: periodic asynchronous checkpoints
  through :class:`CheckpointStore`, and on a failure a restart from the
  latest committed checkpoint (``resume()``), up to ``max_restarts``
  times.  Tests inject failures through ``failure_hook``.
* ``StragglerMitigator`` keeps a per-host step-time EWMA; hosts slower than
  ``threshold`` x the median get their micro-batches re-dispatched to the
  fastest hosts.  With static bucket templates that is a permutation of the
  (host, micro-batch) table: shapes and built steps are untouched.
* ``ElasticPlanner`` recomputes the ParallelismSpec for a changed chip
  count and, for the fleet tier, orders and drives the re-admission of the
  tenants a lost instance orphaned onto the surviving capacity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.task import ParallelismSpec
from repro_torch.distributed.checkpoint import CheckpointStore, latest_step, restore_checkpoint


@dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3


class TrainSupervisor:
    """Checkpoint/restart harness around a step function.

    ``step_fn(state, step_idx) -> state`` must be pure in ``state``.
    ``failure_hook(step_idx)`` may raise :func:`simulated_failure` to
    simulate a node failure."""

    def __init__(self, cfg: SupervisorConfig,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.ckpt = CheckpointStore(cfg.ckpt_dir, keep=cfg.keep)
        self.failure_hook = failure_hook
        self.restarts = 0

    def resume(self, init_state: Any, shardings: Any = None) -> Tuple[Any, int]:
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return init_state, 0
        state, extra = restore_checkpoint(self.cfg.ckpt_dir, step, init_state, shardings)
        return state, int(extra.get("next_step", step + 1))

    def run(self, init_state: Any, step_fn: Callable[[Any, int], Any], n_steps: int,
            shardings: Any = None) -> Any:
        state, start = self.resume(init_state, shardings)
        i = start
        while i < n_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(i)
                state = step_fn(state, i)
                i += 1
                if i % self.cfg.ckpt_every == 0 or i == n_steps:
                    self.ckpt.save_async(i, state, extra={"next_step": i})
            except _SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                state, i = self.resume(init_state, shardings)
        self.ckpt.wait()
        return state


class _SimulatedFailure(RuntimeError):
    pass


def simulated_failure() -> BaseException:
    return _SimulatedFailure("injected node failure")


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------


@dataclass
class HostStat:
    ewma: float = 0.0
    n: int = 0


class StragglerMitigator:
    """Detects slow hosts and re-balances their micro-batch assignment.

    The assignment is a table host -> list of (bucket, micro) ids; shapes
    are bucket-static so moving a micro-batch between hosts needs no
    recompilation (the compiled step is shared)."""

    def __init__(self, n_hosts: int, threshold: float = 1.5, alpha: float = 0.3):
        self.stats = [HostStat() for _ in range(n_hosts)]
        self.threshold = threshold
        self.alpha = alpha

    def observe(self, host: int, step_seconds: float) -> None:
        s = self.stats[host]
        s.ewma = step_seconds if s.n == 0 else (1 - self.alpha) * s.ewma + self.alpha * step_seconds
        s.n += 1

    def stragglers(self) -> List[int]:
        times = [s.ewma for s in self.stats if s.n > 0]
        if len(times) < 2:
            return []
        med = float(np.median(times))
        return [i for i, s in enumerate(self.stats)
                if s.n > 0 and s.ewma > self.threshold * med]

    def rebalance(self, assignment: Dict[int, List[Any]]) -> Dict[int, List[Any]]:
        """Move work from stragglers to the fastest hosts, proportionally."""
        slow = set(self.stragglers())
        if not slow:
            return assignment
        fast = sorted(
            (h for h in assignment if h not in slow),
            key=lambda h: self.stats[h].ewma if self.stats[h].n else math.inf,
        )
        if not fast:
            return assignment
        out = {h: list(v) for h, v in assignment.items()}
        for h in slow:
            med = float(np.median([s.ewma for s in self.stats if s.n > 0]))
            excess_frac = 1.0 - med / self.stats[h].ewma
            n_move = int(len(out[h]) * excess_frac)
            for k in range(n_move):
                if out[h]:
                    out[fast[k % len(fast)]].append(out[h].pop())
        return out


# ---------------------------------------------------------------------------
# Elastic scaling
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RecoveryAction:
    """One planned step of elastic recovery after an instance loss."""

    tenant_id: str
    action: str                  # "readmit" | "queue"
    target: Optional[int] = None  # instance the tenant landed on (readmit)


class ElasticPlanner:
    """Decides how training continues when capacity shrinks.

    Two consumers:

    * the single-engine world asks :meth:`respec` for the ParallelismSpec of
      a changed chip count (checkpoint restore handles the data move);
    * the fleet router asks :meth:`plan_recovery` to drive re-admission of
      the tenants orphaned by a hard instance loss onto survivors — highest
      priority first, then most training progress (when not everyone fits,
      the tenants with the most sunk work are placed before the shrunk
      capacity runs out), leftovers explicitly queued rather than dropped.
    """

    def __init__(self, prefer_tp: int = 1):
        self.prefer_tp = prefer_tp

    def respec(self, old: ParallelismSpec,
               new_total_chips: int) -> ParallelismSpec:
        return elastic_respec(old, new_total_chips, self.prefer_tp)

    def recovery_order(
        self, orphans: Sequence[Tuple[str, int, int]]) -> List[str]:
        """Re-admission order for ``(tenant_id, priority, steps_trained)``
        triples: priority desc, steps trained desc, id for determinism."""
        return [tid for tid, _, _ in
                sorted(orphans, key=lambda o: (-o[1], -o[2], o[0]))]

    def plan_recovery(
        self,
        orphans: Sequence[Tuple[str, int, int]],
        place: Callable[[str], Optional[int]],
    ) -> List[RecoveryAction]:
        """Drive recovery: call ``place(tenant_id)`` for each orphan in
        recovery order.  ``place`` performs the actual re-admission and
        returns the landing instance id, or None when nothing feasible is
        left (the caller queues the tenant).  Placement mutates capacity,
        so the callback runs strictly in plan order."""
        out: List[RecoveryAction] = []
        for tid in self.recovery_order(orphans):
            target = place(tid)
            out.append(RecoveryAction(
                tid, "readmit" if target is not None else "queue", target))
        return out


def elastic_respec(
    old: ParallelismSpec, new_total_chips: int, prefer_tp: int
) -> ParallelismSpec:
    """Recompute the parallelism spec for a changed chip count.

    Keeps TP at ``prefer_tp`` when divisible (weights reshard cheaply along
    unchanged axes); folds the rest into stages/data."""
    tp = prefer_tp if new_total_chips % prefer_tp == 0 else math.gcd(new_total_chips, prefer_tp)
    rest = new_total_chips // tp
    stages = min(old.num_stages, rest)
    while rest % stages:
        stages -= 1
    return ParallelismSpec(
        num_stages=stages,
        chips_per_stage=new_total_chips // stages,
        tp=tp,
        dp=rest // stages,
    )
