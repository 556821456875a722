"""Per-task adapter hyperparameters and the BaseOp dim inventory (port of
``repro.peft.methods.config``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs import ArchConfig

DEFAULT_TARGETS = ("attn_q", "attn_k", "attn_v", "attn_o")


@dataclass(frozen=True)
class AdapterConfig:
    kind: str = "lora"
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    lr: float = 1e-4         # per-task learning rate (per-task optimizer isolation)

    def __post_init__(self):
        from repro_torch.peft.methods import resolve_kind
        object.__setattr__(self, "kind", resolve_kind(self.kind))

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)


def supports_attention_prefix(cfg: ArchConfig) -> bool:
    """Whether the backbone has softmax attention that learned prefix k/v
    rows can enter (the hybrid family's shared block has)."""
    return cfg.attention != "none"


def base_op_dims(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of every adapter-capable BaseOp of a backbone:
    attention q/k/v/o (on audio the decoder's self- and cross-attention
    share them); the gated MLP (gate / up / down) or the plain one (fc1 /
    fc2), or in the MoE family the shared experts' MLP (its routed experts
    are direct products, no BaseOp); in the hybrid family the Mamba2
    in-projection (to [z, x, B, C, dt]) and out-projection; in the ``ssm``
    family the mLSTM's q / k / v on the inner width d_in = ssm_expand * d,
    its up-projection ``ssm_in`` (d, 2 d_in) and down-projection
    ``ssm_out`` (d_in, d) (and, as in the JAX package, the MLP's sites where
    a config has a d_ff: xlstm-1.3b has none, its ``smoke_config`` has).
    The sLSTM block's projections share those two
    names: its w_in (d, 4 d) matches ``ssm_in``, its w_out (d, d) does not
    match ``ssm_out`` (the JAX package's declaration; see
    ``repro_torch.models.ssm.slstm_apply``)."""
    d, d_in = cfg.d_model, cfg.ssm_expand * cfg.d_model
    dims: Dict[str, Tuple[int, int]] = {}
    if cfg.family == "ssm":
        dims.update({"attn_q": (d_in, d_in), "attn_k": (d_in, d_in), "attn_v": (d_in, d_in)})
    elif cfg.attention != "none":
        qd, kvd = cfg.q_dim, cfg.kv_dim
        dims.update({"attn_q": (d, qd), "attn_k": (d, kvd), "attn_v": (d, kvd),
                     "attn_o": (qd, d)})
    if cfg.family == "moe":
        if cfg.num_shared_experts:
            ffs = cfg.num_shared_experts * cfg.expert_d_ff
            dims.update({"shared_mlp_gate": (d, ffs), "shared_mlp_up": (d, ffs),
                         "shared_mlp_down": (ffs, d)})
    elif cfg.d_ff and cfg.gated_mlp:
        dims.update({"mlp_gate": (d, cfg.d_ff), "mlp_up": (d, cfg.d_ff),
                     "mlp_down": (cfg.d_ff, d)})
    elif cfg.d_ff:  # the plain GELU MLP (starcoder2, whisper)
        dims.update({"mlp_fc1": (d, cfg.d_ff), "mlp_fc2": (cfg.d_ff, d)})
    if cfg.family == "hybrid":
        nh = d_in // cfg.ssm_head_dim
        dims.update({"ssm_in": (d, 2 * d_in + 2 * cfg.ssm_state + nh), "ssm_out": (d_in, d)})
    if cfg.family == "ssm":
        dims.update({"ssm_in": (d, 2 * d_in), "ssm_out": (d_in, d)})
    return dims
