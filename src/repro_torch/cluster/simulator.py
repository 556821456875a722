"""Cluster-level discrete-event simulator (§5.4 / §6; port of
``repro.cluster.simulator``, which it equals output for output: host
arithmetic and a numpy ``RandomState``, so traces are the same bits).

Replays a task-arrival trace against a cluster of fine-tuning instances
under pluggable scheduling policies, with MuxTune-aware co-location: an
instance admits a new tenant iff the Eq. 5 memory model says the fused
working set fits, and its throughput follows the cost model's saturation
curve (co-located tasks slow each other sub-linearly below saturation —
the Fig. 9b shape).

Policies:
  * ``fcfs``        — first-come-first-served, first instance with a slot;
  * ``best_fit``    — co-locate onto the instance whose post-admission
                      utilization is highest but feasible (packs tighter);
  * ``backbone_affine`` — like best_fit but only onto instances already
                      running the same backbone type (§6: tasks with
                      different backbones go to different instances).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TaskArrival:
    t_min: float          # arrival time (minutes)
    duration_min: float   # solo duration
    backbone: str = "llama7b"
    mem_gb: float = 1.0   # adapter+activation footprint


@dataclass(frozen=True)
class SimRecord:
    """Per-arrival outcome — lets trace replays (``repro_torch.serve.replay``)
    validate the abstract model against real execution task-by-task."""

    index: int            # position in the (time-sorted) trace
    t_arrive: float
    admitted: bool
    instance: int = -1
    t_end: float = 0.0    # predicted completion (co-location slowdown applied)
    colocated: int = 0    # tenants resident on the instance at admission


@dataclass
class Instance:
    iid: int
    chips: int
    backbone: Optional[str] = None
    hbm_gb: float = 64.0
    backbone_gb: float = 14.0
    active: List[Tuple[float, float]] = field(default_factory=list)  # (end, mem)
    retired: bool = False  # fleet lockstep: drained + scaled down
    # A pinned instance's backbone is fixed at provision time (fleet
    # lockstep: the live service was BUILT with that backbone config, e.g.
    # an int8-quantized copy) — it rejects mismatched tasks even while
    # empty, and admissions never relabel it.  Trace-replay instances stay
    # unpinned: they adopt whatever backbone lands first.
    pinned: bool = False

    def gc(self, now: float) -> None:
        self.active = [(e, m) for (e, m) in self.active if e > now]

    def mem_used(self) -> float:
        base = self.backbone_gb if self.active else 0.0
        return base + sum(m for _, m in self.active)

    def can_admit(self, task: TaskArrival, max_colocate: int) -> bool:
        if self.retired:
            return False
        if (self.pinned or self.active) and self.backbone != task.backbone:
            return False
        if len(self.active) >= max_colocate:
            return False
        base = self.backbone_gb  # one shared backbone copy (MuxTune)
        return base + sum(m for _, m in self.active) + task.mem_gb <= self.hbm_gb

    def slowdown(self, k: int, multiplexed: bool) -> float:
        """Co-location slowdown: sub-linear below saturation (Fig. 9b)."""
        if not multiplexed:
            return float(k)  # time-sliced: k tasks -> k x duration
        return k ** 0.15


def philly_style_trace(
    horizon_min: float = 24 * 60,
    rate_per_min: float = 2.59,
    mean_dur_min: float = 372.6,
    seed: int = 0,
) -> List[TaskArrival]:
    """Philly-like arrivals: Poisson arrivals, heavy-tailed lognormal
    durations calibrated to the paper's mean/std (372.6 / 612.9 min)."""
    rng = np.random.RandomState(seed)
    # lognormal with mean m, std s: sigma^2 = ln(1+(s/m)^2)
    s_over_m = 612.9 / mean_dur_min
    sigma = math.sqrt(math.log(1 + s_over_m ** 2))
    mu = math.log(mean_dur_min) - sigma ** 2 / 2
    out: List[TaskArrival] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_per_min)
        if t >= horizon_min:
            break
        dur = float(np.clip(rng.lognormal(mu, sigma), 5, 7 * 24 * 60))
        out.append(TaskArrival(t, dur, mem_gb=float(rng.uniform(0.5, 2.0))))
    return out


class ClusterSim:
    def __init__(
        self,
        n_chips: int = 128,
        chips_per_instance: int = 4,
        max_colocate: int = 8,
        multiplexed: bool = True,
        policy: str = "fcfs",
        hbm_gb: float = 64.0,
        backbone_gb: float = 14.0,
    ):
        self.chips_per_instance = chips_per_instance
        self.hbm_gb = hbm_gb
        self.backbone_gb = backbone_gb
        self.instances = [
            Instance(i, chips_per_instance, hbm_gb=hbm_gb,
                     backbone_gb=backbone_gb)
            for i in range(n_chips // chips_per_instance)
        ]
        self.max_colocate = max_colocate
        self.multiplexed = multiplexed
        self.policy = policy
        self.served_min = 0.0
        self.queued_drops = 0
        self.completed = 0
        self.records: List[SimRecord] = []
        # fleet lockstep: open-ended residencies keyed by tenant id
        self._lockstep: Dict[str, Tuple[int, Tuple[float, float]]] = {}

    def _pick(self, task: TaskArrival) -> Optional[Instance]:
        feas = [i for i in self.instances if i.can_admit(task, self.max_colocate)]
        if not feas:
            return None
        if self.policy == "fcfs":
            return feas[0]
        if self.policy in ("best_fit", "backbone_affine"):
            if self.policy == "backbone_affine":
                same = [i for i in feas if i.backbone == task.backbone and i.active]
                if same:
                    feas = same
            return max(feas, key=lambda i: (len(i.active), i.mem_used()))
        raise ValueError(self.policy)

    # ------------------------------------------------------------------
    # fleet lockstep oracle (repro_torch.fleet.FleetRouter mirrors live decisions)
    #
    # Unlike ``run``'s trace replay, fleet tenants have no predicted end
    # time — residencies are open-ended (end = +inf) and are closed by an
    # explicit ``lockstep_depart`` when the live tenant completes, migrates
    # or cancels.  ``gc`` never reaps an open-ended entry.

    def lockstep_pick(self, task: TaskArrival) -> Optional[int]:
        """Placement the policy WOULD choose right now (no state change).
        Returns the instance id, or None when nothing is feasible."""
        inst = self._pick(task)
        return None if inst is None else inst.iid

    def lockstep_admit(self, tenant_id: str, task: TaskArrival,
                       iid: int) -> None:
        """Mirror a live admission onto instance ``iid``."""
        if tenant_id in self._lockstep:
            raise ValueError(f"tenant {tenant_id} already resident in oracle")
        inst = self.instances[iid]
        entry = (math.inf, task.mem_gb)
        if inst.pinned:
            if inst.backbone != task.backbone:
                raise ValueError(
                    f"lockstep: task backbone {task.backbone!r} does not "
                    f"match pinned instance {iid} ({inst.backbone!r})")
        else:
            inst.backbone = task.backbone
        inst.active.append(entry)
        self._lockstep[tenant_id] = (iid, entry)

    def lockstep_depart(self, tenant_id: str) -> None:
        """Mirror a live departure (completion, cancel, or migration-out)."""
        iid, entry = self._lockstep.pop(tenant_id)
        self.instances[iid].active.remove(entry)

    def add_instance(self, chips: Optional[int] = None,
                     backbone: Optional[str] = None,
                     backbone_gb: Optional[float] = None,
                     pinned: bool = False) -> int:
        """Mirror a fleet scale-up.  Keeps the iid == list-index invariant
        the lockstep bookkeeping relies on.  Heterogeneous fleets pass a
        per-instance ``backbone`` label + ``backbone_gb`` footprint (an int8
        copy is smaller than an fp32 one) with ``pinned=True`` so the oracle
        prices and constrains each instance like its live counterpart."""
        iid = len(self.instances)
        self.instances.append(Instance(
            iid, chips or self.chips_per_instance, backbone=backbone,
            hbm_gb=self.hbm_gb,
            backbone_gb=(self.backbone_gb if backbone_gb is None
                         else backbone_gb),
            pinned=pinned))
        return iid

    def fail_instance(self, iid: int) -> List[str]:
        """Mirror an instance CRASH: unlike :meth:`remove_instance` the
        instance may (and usually does) still host tenants — their open-
        ended residencies are force-departed and the orphaned tenant ids
        returned so the router can replay recovery placements through
        ``lockstep_pick``/``lockstep_admit`` on the survivors."""
        inst = self.instances[iid]
        orphans = [tid for tid, (i, _) in self._lockstep.items() if i == iid]
        for tid in orphans:
            self.lockstep_depart(tid)
        inst.active.clear()
        inst.retired = True
        return orphans

    def remove_instance(self, iid: int) -> None:
        """Mirror a fleet drain-and-retire: the instance must be empty.
        It stays in the list (iid == index invariant) but is marked retired
        so no policy will place onto it again."""
        inst = self.instances[iid]
        if inst.active:
            raise ValueError(f"instance {iid} still has resident tenants")
        inst.retired = True

    def run(self, trace: Sequence[TaskArrival]) -> Dict[str, float]:
        for idx, task in enumerate(sorted(trace, key=lambda a: a.t_min)):
            now = task.t_min
            for inst in self.instances:
                inst.gc(now)
            inst = self._pick(task)
            if inst is None:
                self.queued_drops += 1
                self.records.append(SimRecord(idx, now, False))
                continue
            k = len(inst.active) + 1
            # slowdown() already returns the per-task wall-time inflation
            # (k for time-slicing, k^0.15 multiplexed) — apply it directly
            dur = task.duration_min * inst.slowdown(k, self.multiplexed)
            if not inst.pinned:
                inst.backbone = task.backbone
            inst.active.append((now + dur, task.mem_gb))
            self.served_min += task.duration_min
            self.completed += 1
            self.records.append(SimRecord(idx, now, True, inst.iid,
                                          now + dur, k - 1))
        return {
            "served_task_min": self.served_min,
            "completed": float(self.completed),
            "dropped": float(self.queued_drops),
            "admission_rate": self.completed / max(len(trace), 1),
        }
