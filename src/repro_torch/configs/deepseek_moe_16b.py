"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=128,
    d_ff=1408,  # per-expert (fine-grained)
    expert_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    rope_theta=10_000.0,
)
