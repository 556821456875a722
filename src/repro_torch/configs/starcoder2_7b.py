"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1_000_000.0,
    gated_mlp=False,  # starcoder2 uses plain GELU fc1/fc2
    attention_bias=True,
)
