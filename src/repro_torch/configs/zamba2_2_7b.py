"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

54 layers in super-blocks of ``hybrid_period``: 5 Mamba2 blocks followed by
one application of a single weight-shared attention+MLP block (zamba2's
shared transformer block).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,  # MHA in the shared block
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_period=6,  # every 6th layer = shared attention block
    shared_attention=True,
    rope_theta=10_000.0,
)
