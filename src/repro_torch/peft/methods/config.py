"""Per-task adapter hyperparameters and the BaseOp dim inventory (port of
``repro.peft.methods.config``, dense and hybrid families)."""
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
    """(d_in, d_out) of every adapter-capable BaseOp of a dense or hybrid
    backbone: attention q/k/v/o, the gated MLP and, in the hybrid family,
    the Mamba2 in-projection (to [z, x, B, C, dt]) and out-projection."""
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(f"the port runs the dense and hybrid families, not "
                                  f"{cfg.family}")
    d = cfg.d_model
    dims: Dict[str, Tuple[int, int]] = {}
    if cfg.attention != "none":
        qd, kvd = cfg.q_dim, cfg.kv_dim
        dims.update({"attn_q": (d, qd), "attn_k": (d, kvd), "attn_v": (d, kvd),
                     "attn_o": (qd, d)})
    if cfg.d_ff:
        dims.update({"mlp_gate": (d, cfg.d_ff), "mlp_up": (d, cfg.d_ff),
                     "mlp_down": (cfg.d_ff, d)})
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        dims.update({"ssm_in": (d, 2 * d_in + 2 * cfg.ssm_state + nh), "ssm_out": (d_in, d)})
    return dims
