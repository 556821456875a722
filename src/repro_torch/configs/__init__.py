"""Architecture configs (port of ``repro.configs``).

The port keeps its own copy of ``ArchConfig`` so it never imports the JAX
package.  The registry lists every configuration of the JAX package's: the
dense, vlm, audio, hybrid, MoE and ``ssm`` (xlstm-1.3b) families.
``SHAPES`` holds the assigned input shapes (shared by every LM arch), which
the sharding rules of ``repro_torch.launch.rules`` are chosen for.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape: ``kind`` is the step it feeds (``train``:
    forward, adapter backward and optimizer; ``prefill``: forward and
    logits; ``decode``: one new token over a KV cache of ``seq_len``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """A backbone architecture: the fields of the JAX package's
    ``ArchConfig`` that its families and the planner read, and its
    ``param_dtype`` (the TPU execution fields are not ported)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid: layers per super-block; the last of each is the attention block
    hybrid_period: int = 0
    shared_attention: bool = False  # zamba2-style weight-shared attn block
    # xLSTM: blocks per super-block, the last of each the sLSTM (0 = none)
    slstm_period: int = 0
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    max_source_positions: int = 0  # whisper: 1500 frames
    gated_mlp: bool = True  # SwiGLU-style (gate/up/down); False -> GELU fc1/fc2
    # q/k/v/o biases (starcoder2); the JAX package initialises them to zeros
    attention_bias: bool = False
    # attention kind: "full" | "none" (pure recurrent)
    attention: str = "full"
    rope_theta: float = 10_000.0
    mrope: bool = False  # qwen2-vl's three-section multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t / h / w slots of dh / 2
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q / k before RoPE
    # the cost model's activation-memory assumption (Eq. 5): True counts one
    # activation copy per layer, as with rematerialisation
    remat: bool = True
    # query block of packed attention: its tile-visibility rule uses
    # gcd(S, min(attn_q_block, S)) as the JAX package's model does
    attn_q_block: int = 512
    # kv block of the ``kvscan`` attention mode's scan (``models.attention``)
    attn_kv_block: int = 1024
    # the JAX package's parameter type, declared there and read nowhere (its
    # backbones take each ParamSpec's type, bf16): here it may only be that,
    # so no config can ask for a parameter type it would not get
    param_dtype: str = "bfloat16"
    # frozen-backbone storage ("bfloat16" | "float32" | "int8"): "int8"
    # quantizes every adapter-capable BaseOp weight at model build
    # (symmetric, per-output-channel scale), read by the quant_matmul kernel
    # (``repro_torch.models.quantize``, ``kernels/quant_matmul.py``)
    backbone_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.param_dtype != "bfloat16":
            raise ValueError(f"{self.name}: param_dtype {self.param_dtype!r}: the "
                             "backbone's parameters are bf16 (the field is inert, "
                             "as in the JAX package)")

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

    def param_count(self, active_only: bool = False) -> int:
        """Backbone parameter count (the JAX package's formula; the cost
        model's Eq. 5 reads it).  ``active_only`` counts an MoE layer's
        top-k routed experts only.  Like the JAX formula it counts no bias
        (starcoder2's and qwen2-vl's q/k/v/o, whisper's), and on the audio
        family each norm's weight only: the decoder layer's two attentions,
        MLP and three norms, the encoder layer's one attention, MLP and two
        norms.  On the ``ssm`` family it is the formula's attention and
        norms per block, not the mLSTM / sLSTM tree (xlstm-1.3b: 1,011,550,208
        against 3,530,119,504 leaves' values), as in the JAX package."""
        d = self.d_model
        n_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.qk_norm:
            n_attn += 2 * self.resolved_head_dim()
        per_ff = 3 if self.gated_mlp else 2
        n_mlp = per_ff * d * self.d_ff
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
        elif self.family == "ssm":  # the JAX formula: no d_ff MLP, no block weights
            total = self.num_layers * (n_attn + n_norms)
        elif self.family == "moe":
            routed = self.top_k if active_only else self.num_experts
            experts = (routed + self.num_shared_experts) * per_ff * d * self.expert_d_ff
            total = self.num_layers * (n_attn + experts + d * self.num_experts + n_norms)
        elif self.family == "audio":
            enc = self.num_encoder_layers * (n_attn + n_mlp + n_norms)
            total = enc + self.num_layers * (2 * n_attn + n_mlp + 3 * d)
        else:
            total = self.num_layers * (n_attn + n_mlp + n_norms)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + embed + d  # final norm


_REGISTRY = {
    "llama3.2-3b": "llama3_2_3b",
    "smollm-360m": "smollm_360m",
    "zamba2-2.7b": "zamba2_2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "starcoder2-7b": "starcoder2_7b",
    "yi-34b": "yi_34b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown configuration {name!r}; known: {', '.join(ARCH_NAMES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """A reduced config of the same family for CPU tests (the JAX package's
    ``smoke_config`` overrides)."""
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
        attn_kv_block=32,
        remat=False,
    )
    if cfg.family == "moe":
        over.update(num_experts=4, top_k=2, expert_d_ff=32,
                    num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family in ("hybrid", "ssm"):
        over.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16, num_layers=4)
        if cfg.hybrid_period:
            over.update(hybrid_period=2)
        if cfg.slstm_period:
            over.update(slstm_period=2)
    if cfg.is_encoder_decoder:
        over.update(num_encoder_layers=2, max_source_positions=16)
    if cfg.family == "vlm":
        over.update(mrope_sections=(2, 3, 3))  # sums to head_dim / 2 = 8
    return cfg.with_overrides(**over)


def dryrun_cells(arch: str) -> list:
    """The shapes a configuration is planned for: train, prefill and decode,
    and ``long_500k`` on the families with sub-quadratic sequence mixing
    (``ssm`` and ``hybrid``)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        cells.append("long_500k")
    return cells
