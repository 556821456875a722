"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert
    expert_d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_shared_experts=0,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
