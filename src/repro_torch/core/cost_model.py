"""Cost model (Eq. 3-5): per-stage latency and per-stage memory for hTasks
(port of ``repro.core.cost_model``, dense and hybrid families).

The "profile" is an analytic roofline of the target device: each operator's
latency is ``max(flops / (peak * util(x)), bytes / hbm_bw)`` with a
saturation curve ``util(x) = x / (x + x_half)`` capturing the paper's §2.2
small-operator underutilization (the curve is what makes spatial batching
pay off below saturation and plateau above it — Fig. 9b).  The defaults are
the NVIDIA H100 SXM's spec-sheet values; a caller passes another
``HardwareProfile`` (and the planner another memory budget) to plan for
other hardware.  Fitting the profile to measured step times (the JAX
package's ``calibrate_profile``) and the decode-token term of the serving
scheduler are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import ArchConfig
from repro_torch.core.task import HTask, ParallelismSpec, PEFTTask
from repro_torch.models.quantize import quantized_param_count
from repro_torch.peft.methods import base_op_dims, supports_attention_prefix
from repro_torch.peft.methods import adapter_shared_params, adapter_sites

# NVIDIA H100 SXM spec-sheet values (one card).
PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # device memory bytes/s
ICI_BW = 450e9            # NVLink bytes/s each way to the host's other cards
HBM_BYTES = 80e9          # device memory bytes


@dataclass(frozen=True)
class OpCost:
    name: str
    flops_per_token: float
    bytes_fixed: float       # weight traffic (read once per op invocation)
    bytes_per_token: float   # activation traffic
    kind: str = "compute"    # compute | comm
    x_half: float = 64e9     # FLOPs at which utilization reaches 50%


@dataclass
class HardwareProfile:
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    util_x_half: float = 2.0e9  # FLOPs per op at 50% utilization
    calibration: Dict[str, float] = field(default_factory=dict)

    def utilization(self, flops: float) -> float:
        """Saturation curve: small ops underutilize the tensor cores (§2.2)."""
        return flops / (flops + self.util_x_half)

    def op_latency(self, flops: float, bytes_moved: float) -> float:
        u = max(self.utilization(flops), 1e-3)
        return max(flops / (self.peak_flops * u), bytes_moved / self.hbm_bw)

    def wall_scale(self) -> float:
        return self.calibration.get("__wall__", 1.0)


def backbone_ops(cfg: ArchConfig, dtype_bytes: int = 2,
                 weight_bytes: Optional[int] = None) -> List[OpCost]:
    """Per-layer BaseOp inventory with analytic FLOPs/bytes per token.

    ``dtype_bytes`` prices activation traffic; ``weight_bytes`` prices the
    resident-weight reads (``bytes_fixed``) and defaults to the activation
    precision.  Attention score+pv FLOPs depend on the context length and
    are added at the call sites (:func:`attention_flops_per_token`).
    """
    wb = dtype_bytes if weight_bytes is None else weight_bytes
    ops: List[OpCost] = []
    dims = base_op_dims(cfg)
    for name, (din, dout) in dims.items():
        ops.append(OpCost(
            name=name,
            flops_per_token=2.0 * din * dout,
            bytes_fixed=din * dout * wb,
            bytes_per_token=(din + dout) * dtype_bytes,
        ))
    return ops


def attention_flops_per_token(cfg: ArchConfig, ctx_len: int) -> float:
    """Score + pv FLOPs per token over a mean causal context of ctx_len / 2;
    without attention, the chunked scan's O(chunk * dk + dk * dv) per
    token per head (the JAX package's terms)."""
    if cfg.attention == "none":
        d_in = cfg.ssm_expand * cfg.d_model
        return 4.0 * d_in * (cfg.ssm_chunk + cfg.ssm_state)
    dh = cfg.resolved_head_dim()
    return 4.0 * cfg.num_heads * dh * (ctx_len / 2.0)


@dataclass
class CostModel:
    cfg: ArchConfig
    tasks: Sequence[PEFTTask]
    parallelism: ParallelismSpec
    hw: HardwareProfile = field(default_factory=HardwareProfile)
    dtype_bytes: int = 2  # activation / compute precision
    # Resident-backbone-weight precision.  None -> resolved from
    # ``cfg.backbone_dtype_bytes()``, so an int8 backbone reprices Eq. 5
    # memory and the weight-read latency terms, and the planner sees it.
    weight_bytes: Optional[int] = None
    comm_overlapped: bool = True  # §3.4.2 orchestration hides intra-stage comm

    def __post_init__(self) -> None:
        if self.weight_bytes is None:
            self.weight_bytes = self.cfg.backbone_dtype_bytes()
        self._ops = backbone_ops(self.cfg, self.dtype_bytes, self.weight_bytes)
        self._dims = base_op_dims(self.cfg)
        self._attention_ok = supports_attention_prefix(self.cfg)
        self._layers_per_stage = max(self.cfg.num_layers // self.parallelism.num_stages, 1)

    def task_sites(self, task: PEFTTask):
        """The task's method-declared attach sites with per-site footprint:
        (site, d_in, d_out, flops_per_token, trainable_params)."""
        return adapter_sites(task.adapter, self._dims,
                             attention=self._attention_ok)

    # ------------------------------------------------------------- Eq. (3)
    def stage_latency(self, htask: HTask, stage: int = 0) -> float:
        """Forward latency of one micro-batch of ``htask`` on one stage."""
        p = self.parallelism
        n_tokens = htask.tokens  # sum_k n_k (padded token count)
        lat = 0.0
        # --- BaseOps: batched over all member tasks, sharded over N_g chips
        for op in self._ops:
            flops = op.flops_per_token * n_tokens
            bytes_moved = op.bytes_fixed + op.bytes_per_token * n_tokens
            cal = self.hw.calibration.get(op.name, 1.0)
            lat += cal * self.hw.op_latency(flops / p.tp, bytes_moved / p.tp)
        # attention mixing term
        att = attention_flops_per_token(self.cfg, htask.row_len) * n_tokens
        lat += self.hw.op_latency(att / p.tp, n_tokens * self.cfg.d_model * self.dtype_bytes / p.tp)
        # --- Adapters: fused horizontally (§3.4.3); weighted-sum vs max bound
        fused_sum = 0.0
        per_task_max = 0.0
        for k in htask.task_ids:
            t = self.tasks[k]
            n_k = t.tokens_per_microbatch()
            a_lat = 0.0
            for _site, din, dout, fl_tok, _params in self.task_sites(t):
                fl = fl_tok * n_k
                u = self.hw.utilization(fl)
                site_lat = self.hw.op_latency(fl, n_k * (din + dout) * self.dtype_bytes)
                a_lat += site_lat
                fused_sum += u * site_lat
            per_task_max = max(per_task_max, a_lat)
        lat += max(fused_sum, per_task_max)
        # --- intra-stage comm (TP): all-reduce/rs+ag of activations per layer
        if p.tp > 1 and not self.comm_overlapped:
            comm_bytes = 2.0 * n_tokens * self.cfg.d_model * self.dtype_bytes * (p.tp - 1) / p.tp
            lat += 2 * comm_bytes / self.hw.ici_bw  # attn + mlp
        return lat * self._layers_per_stage * self.hw.wall_scale()

    def stage_latencies(self, htask: HTask) -> List[float]:
        base = self.stage_latency(htask, 0)
        # homogeneous decoder stack: stages share latency; first/last carry
        # the embedding/unembedding extra
        extra = self.hw.op_latency(
            2.0 * htask.tokens * self.cfg.d_model * 2, htask.tokens * self.cfg.d_model * 2
        ) * self.hw.wall_scale()
        out = [base] * self.parallelism.num_stages
        out[-1] += extra
        return out

    # ------------------------------------------------------------- Eq. (4)
    def pipeline_latency(self, htask: HTask, n_micro: int) -> float:
        ls = self.stage_latencies(htask)
        warm_drain = 2.0 * sum(ls[:-1])
        steady = 2.0 * n_micro * max(ls)
        return warm_drain + steady

    # ------------------------------------------------------------- Eq. (5)
    def stage_memory(self, htasks: Sequence[HTask], cache_backbone: bool = True) -> float:
        """Peak per-stage bytes for co-located hTasks (1F1B accumulation)."""
        p = self.parallelism
        S = p.num_stages
        # Backbone residency splits by precision: the quantizable BaseOp
        # params sit at ``weight_bytes`` (1 for int8), the remainder (norms,
        # embedding) at activation precision, as quantize_backbone converts.
        n_quant = quantized_param_count(self.cfg)
        m_backbone = (n_quant * self.weight_bytes
                      + (self.cfg.param_count() - n_quant) * self.dtype_bytes) / p.tp
        m_grad = 0.0  # input grads reuse activation buffers (paper: M_g ~ M_a reuse)
        m_act = 0.0
        # shared (task-axis-free) adapter leaves — e.g. VeRA's frozen A/B —
        # are real HBM paid ONCE per (kind, site) stack, not per tenant and
        # not per stage (added outside the m_act * S term below)
        shared: Dict[Tuple[str, str], float] = {}
        for h in htasks:
            for k in h.task_ids:
                t = self.tasks[k]
                for site, params in adapter_shared_params(
                        t.adapter, self._dims,
                        attention=self._attention_ok).items():
                    shared[(t.adapter.kind, site)] = params * 4.0
        for h in htasks:
            # activation bytes per micro-batch per stage (flash attention: O(S*d))
            act = h.rows * h.row_len * self.cfg.d_model * self.dtype_bytes
            act *= self._layers_per_stage * (2 if not self.cfg.remat else 1)
            adapters = 0.0
            for k in h.task_ids:
                t = self.tasks[k]
                for _site, _din, _dout, _fl, params in self.task_sites(t):
                    adapters += params * 4  # f32 optim moments (Eq. 5)
            m_act += act * min(S, 1 + 1) + adapters  # <= S in-flight copies; 1F1B steady ~ S
        return (m_backbone + m_grad) / 1.0 + m_act * S + sum(shared.values())

    def fits_memory(self, htasks: Sequence[HTask], budget: float = HBM_BYTES) -> bool:
        return self.stage_memory(htasks) <= budget

    def schedule_latency(self, htask_counts: Sequence[Tuple[HTask, int]]) -> float:
        """Predicted wall time of one engine iteration: the scheduled
        hTask micro-steps run back-to-back over all stages (the engine's
        sequential dispatch on one host)."""
        return sum(n * sum(self.stage_latencies(h)) for h, n in htask_counts)

