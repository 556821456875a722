"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only; the vision patch-embed frontend is a stub (as in the JAX
package): batches carry token ids and, at bind and decode, the three
(temporal / height / width) M-RoPE position channels.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),  # temporal / height / width (per rotated half)
    attention_bias=True,  # qwen2 uses qkv bias
)
