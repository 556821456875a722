"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

Also the backbone of ``repro_torch.launch.train``'s default run.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
