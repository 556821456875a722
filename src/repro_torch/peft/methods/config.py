"""Per-task adapter hyperparameters and the BaseOp dim inventory (port of
``repro.peft.methods.config``, dense family)."""
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
    rows can enter: every family the port runs (dense) has."""
    return cfg.family == "dense"


def base_op_dims(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of every adapter-capable BaseOp of a dense backbone."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port runs the dense family, not {cfg.family}")
    d = cfg.d_model
    qd, kvd = cfg.q_dim, cfg.kv_dim
    dims = {"attn_q": (d, qd), "attn_k": (d, kvd), "attn_v": (d, kvd), "attn_o": (qd, d)}
    dims.update({"mlp_gate": (d, cfg.d_ff), "mlp_up": (d, cfg.d_ff),
                 "mlp_down": (cfg.d_ff, d)})
    return dims
