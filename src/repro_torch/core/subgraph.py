"""Intra-stage orchestration (§3.4.2): dependency-aware subgraphs + Alg. 1.

Each hTask's stage program is a DAG of compute and communication operators.
Segmentation clusters consecutive compute ops, appends each communication op
to the subgraph of its dependent operator, and isolates small adapters as
their own subgraphs (so they can fill comm gaps of *other* tasks).  Priority
= topological depth.  Algorithm 1 (multi-DAG, latency-aware Kahn) emits the
launch schedule; the two-resource simulator (compute stream + interconnect)
reports stage latency and overlap efficiency — the Fig. 18 analogue.

On TPU, the *execution* of the overlap is XLA's latency-hiding scheduler;
this schedule decides program order (which is what XLA can and cannot
overlap) and validates the cost model's ``comm_overlapped`` assumption.
Adapter-fusion legality (§3.4.3) is enforced structurally: adapters fuse
across tasks only when their subgraphs carry no pending communication edge
between them (rule 2), never across buckets (rule 3).

Port of ``repro.core.subgraph``: the same numpy code over the port's types.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.core.cost_model import CostModel, HardwareProfile
from repro_torch.core.task import HTask, ParallelismSpec
from repro_torch.peft.methods import base_op_dims


@dataclass
class OpNode:
    uid: int
    name: str
    kind: str          # compute | comm | adapter
    latency: float
    task: int          # owning hTask index
    deps: Tuple[int, ...] = ()

    @property
    def is_comm(self) -> bool:
        return self.kind in ("comm",)

    @property
    def is_adapter(self) -> bool:
        return self.kind in ("adapter",)


@dataclass
class Subgraph:
    sid: int
    task: int
    nodes: List[OpNode]
    priority: int = 0          # topological depth (lower = earlier)
    fused_with: Tuple[int, ...] = ()

    @property
    def latency(self) -> float:
        return sum(n.latency for n in self.nodes)

    @property
    def comm_latency(self) -> float:
        return sum(n.latency for n in self.nodes if n.is_comm)

    @property
    def compute_latency(self) -> float:
        return self.latency - self.comm_latency

    @property
    def has_comm(self) -> bool:
        return any(n.is_comm for n in self.nodes)


def build_stage_dag(
    cfg: ArchConfig,
    htask: HTask,
    task_index: int,
    cost_model: CostModel,
    layers: int = 1,
    uid_start: int = 0,
) -> List[OpNode]:
    """Operator DAG of one pipeline-stage program for one hTask."""
    hw = cost_model.hw
    p = cost_model.parallelism
    n_tok = htask.tokens
    d = cfg.d_model
    dims = base_op_dims(cfg)
    nodes: List[OpNode] = []
    uid = itertools.count(uid_start)
    prev: Optional[int] = None

    def add(name: str, kind: str, lat: float, deps: Tuple[int, ...]):
        nonlocal prev
        n = OpNode(next(uid), name, kind, lat, task_index, deps)
        nodes.append(n)
        prev = n.uid
        return n.uid

    def t_op(flops, byts):
        return hw.op_latency(flops / p.tp, byts / p.tp)

    comm_bytes = n_tok * d * 2 * (p.tp - 1) / max(p.tp, 1)
    t_comm = comm_bytes / hw.ici_bw if p.tp > 1 else 0.0

    for l in range(layers):
        deps = (prev,) if prev is not None else ()
        qkv_flops = 2.0 * d * (dims.get("attn_q", (d, d))[1] + 2 * dims.get("attn_k", (d, d))[1]) * n_tok
        a = add(f"L{l}.qkv", "compute", t_op(qkv_flops, 3 * n_tok * d * 2), deps)
        # small per-task adapters on qkv (isolated subgraphs)
        ad = add(f"L{l}.adapter_qkv", "adapter",
                 _adapter_latency(cfg, htask, cost_model), (a,))
        att = add(f"L{l}.attn", "compute",
                  t_op(4.0 * cfg.num_heads * cfg.resolved_head_dim() * (htask.row_len / 2) * n_tok,
                       n_tok * d * 2), (a, ad))
        o = add(f"L{l}.out_proj", "compute", t_op(2.0 * d * d * n_tok, n_tok * d * 2), (att,))
        c1 = add(f"L{l}.attn_allreduce", "comm", t_comm, (o,))
        up_f = 2.0 * d * cfg.d_ff * 3 * n_tok if cfg.d_ff else 2.0 * d * d * n_tok  # gated MLP
        up = add(f"L{l}.mlp_up", "compute", t_op(up_f, n_tok * d * 2), (c1,))
        ad2 = add(f"L{l}.adapter_mlp", "adapter",
                  _adapter_latency(cfg, htask, cost_model), (up,))
        down = add(f"L{l}.mlp_down", "compute",
                   t_op(2.0 * d * (cfg.d_ff or d) * n_tok, n_tok * d * 2), (up, ad2))
        add(f"L{l}.mlp_allreduce", "comm", t_comm, (down,))
    return nodes


def _adapter_latency(cfg: ArchConfig, htask: HTask, cm: CostModel) -> float:
    lat = 0.0
    for k in htask.task_ids:
        t = cm.tasks[k]
        for _site, din, dout, fl_tok, _params in cm.task_sites(t):
            lat += cm.hw.op_latency(fl_tok * t.tokens_per_microbatch(),
                                    t.tokens_per_microbatch() * (din + dout) * 2)
    return lat


def segment_dag(nodes: Sequence[OpNode], sid_start: int = 0) -> List[Subgraph]:
    """Cluster consecutive compute ops; append comm to its dependency's
    subgraph boundary; isolate adapters (§3.4.2 construction)."""
    subs: List[Subgraph] = []
    cur: List[OpNode] = []
    sid = itertools.count(sid_start)

    def flush():
        nonlocal cur
        if cur:
            subs.append(Subgraph(next(sid), cur[0].task, cur))
            cur = []

    for n in nodes:
        if n.is_adapter:
            flush()
            subs.append(Subgraph(next(sid), n.task, [n]))
        elif n.is_comm:
            # a comm op closes the subgraph of its dependent compute run
            cur.append(n)
            flush()
        else:
            cur.append(n)
    flush()
    # topological depth as priority
    node_sub: Dict[int, int] = {}
    for s in subs:
        for n in s.nodes:
            node_sub[n.uid] = s.sid
    depth: Dict[int, int] = {}
    for s in subs:
        dmax = 0
        for n in s.nodes:
            for dep in n.deps:
                ds = node_sub.get(dep)
                if ds is not None and ds != s.sid:
                    dmax = max(dmax, depth.get(ds, 0) + 1)
        depth[s.sid] = max(depth.get(s.sid, 0), dmax)
        s.priority = depth[s.sid]
    return subs


def fuse_adapters(subgraphs_per_task: Sequence[List[Subgraph]]) -> List[List[Subgraph]]:
    """§3.4.3 horizontal fusion across hTasks of one bucket: adapters at the
    same position fuse iff neither side has a comm op in its subgraph."""
    out = [list(s) for s in subgraphs_per_task]
    if len(out) < 2:
        return out
    base = out[0]
    for i, s in enumerate(base):
        if len(s.nodes) == 1 and s.nodes[0].is_adapter and not s.has_comm:
            partners = []
            for other in out[1:]:
                if i < len(other):
                    o = other[i]
                    if len(o.nodes) == 1 and o.nodes[0].is_adapter and not o.has_comm:
                        partners.append(o.sid)
            s.fused_with = tuple(partners)
    return out


def schedule_subgraphs(dags: Sequence[List[Subgraph]]) -> List[Tuple[Subgraph, float]]:
    """Algorithm 1: priority-based multi-DAG scheduling (latency-aware Kahn)."""
    # Build per-DAG remaining-dependency structure: within a DAG, subgraphs
    # are sequential (model execution is sequential); cross-DAG independent.
    ready: List[Tuple[int, float, int, int]] = []  # (priority, -latency, dag, idx)
    ptr = [0] * len(dags)
    for d, subs in enumerate(dags):
        if subs:
            s = subs[0]
            heapq.heappush(ready, (s.priority, -s.latency, d, 0))
    schedule: List[Tuple[Subgraph, float]] = []
    t = 0.0
    while ready:
        # among highest-priority (lowest depth) pick longest cumulative latency
        prio, neglat, d, i = heapq.heappop(ready)
        s = dags[d][i]
        schedule.append((s, t))
        t += s.latency
        if i + 1 < len(dags[d]):
            nxt = dags[d][i + 1]
            heapq.heappush(ready, (nxt.priority, -nxt.latency, d, i + 1))
    return schedule


@dataclass
class OverlapResult:
    latency: float
    compute_busy: float
    comm_busy: float
    serialized_latency: float

    @property
    def compute_utilization(self) -> float:
        return self.compute_busy / self.latency if self.latency else 0.0

    @property
    def speedup(self) -> float:
        return self.serialized_latency / self.latency if self.latency else 1.0


def simulate_overlap(schedule: Sequence[Tuple[Subgraph, float]]) -> OverlapResult:
    """Two-resource replay: comm of one subgraph overlaps compute of later
    independent subgraphs from *other* DAGs (cross-task overlap, Fig. 11)."""
    t_comp = 0.0
    t_comm = 0.0
    dag_free: Dict[int, float] = {}
    serial = 0.0
    for s, _ in schedule:
        start = max(t_comp, dag_free.get(s.task, 0.0))
        end_comp = start + s.compute_latency
        t_comp = end_comp
        serial += s.latency
        if s.comm_latency > 0:
            comm_start = max(end_comp, t_comm)
            t_comm = comm_start + s.comm_latency
            dag_free[s.task] = t_comm  # same task must wait for its comm
        else:
            dag_free[s.task] = end_comp
    latency = max(t_comp, t_comm)
    comm_busy = sum(s.comm_latency for s, _ in schedule)
    comp_busy = sum(s.compute_latency for s, _ in schedule)
    return OverlapResult(latency, comp_busy, comm_busy, serial)
