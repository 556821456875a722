"""Architecture configs (port of ``repro.configs``).

The port keeps its own copy of ``ArchConfig`` so it never imports the JAX
package.  The registry lists only the configurations whose family the port
runs (dense and hybrid); ``get_config`` raises on every other name.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

@dataclass(frozen=True)
class ArchConfig:
    """A backbone architecture: the fields of the JAX package's
    ``ArchConfig`` that the dense and hybrid families and the planner read
    (the MoE, xLSTM, audio and TPU execution fields come with the families
    and tiers that use them)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid: layers per super-block; the last of each is the attention block
    hybrid_period: int = 0
    shared_attention: bool = False  # zamba2-style weight-shared attn block
    gated_mlp: bool = True  # SwiGLU-style (gate/up/down); the port runs only this
    # attention kind: "full" | "none" (pure recurrent)
    attention: str = "full"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # the cost model's activation-memory assumption (Eq. 5): True counts one
    # activation copy per layer, as with rematerialisation
    remat: bool = True
    # query block of packed attention: its tile-visibility rule uses
    # gcd(S, min(attn_q_block, S)) as the JAX package's model does
    attn_q_block: int = 512
    # frozen-backbone storage ("bfloat16" | "float32" | "int8"): "int8"
    # quantizes every adapter-capable BaseOp weight at model build
    # (symmetric, per-output-channel scale), read by the quant_matmul kernel
    # (``repro_torch.models.quantize``, ``kernels/quant_matmul.py``)
    backbone_dtype: str = "bfloat16"

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def backbone_dtype_bytes(self) -> int:
        """Bytes per resident backbone weight: the precision axis of the
        cost model (Eq. 5 and the weight-read terms)."""
        return {"int8": 1, "float8": 1, "bfloat16": 2, "float16": 2,
                "float32": 4}[self.backbone_dtype]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim()

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim()

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Backbone parameter count (the JAX package's formula for the dense
        and hybrid families; the cost model's Eq. 5 reads it)."""
        d = self.d_model
        n_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        n_mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        n_norms = 2 * d
        if self.family == "hybrid":
            # the JAX formula, not the spec's leaf count: in-proj of x and z,
            # B/C and dt rows, out-proj; one attention+MLP copy when shared
            d_in = self.ssm_expand * d
            n_ssm = d * 2 * d_in + d_in * 2 * self.ssm_state + d_in + d_in * d
            n_attn_layers = self.num_layers // self.hybrid_period if self.hybrid_period else 0
            attn_copies = 1 if self.shared_attention else n_attn_layers
            total = ((self.num_layers - n_attn_layers) * (n_ssm + n_norms)
                     + attn_copies * (n_attn + n_mlp + n_norms))
        else:
            total = self.num_layers * (n_attn + n_mlp + n_norms)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + embed + d  # final norm


# Only the configurations of the families the port runs (dense, hybrid).
_REGISTRY = {
    "llama3.2-3b": "llama3_2_3b",
    "smollm-360m": "smollm_360m",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"configuration {name!r} is not ported to repro_torch yet; "
            f"ported: {', '.join(ARCH_NAMES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """A reduced config of the same family for CPU tests (the JAX package's
    ``smoke_config`` overrides for the dense and hybrid families)."""
    cfg = get_config(name)
    over = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_q_block=32,
        remat=False,
    )
    if cfg.family == "hybrid":
        over.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16, num_layers=4,
                    hybrid_period=2)
    return cfg.with_overrides(**over)
