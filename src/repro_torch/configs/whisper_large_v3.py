"""whisper-large-v3 [audio] — encoder-decoder, conv frontend (stub)
[arXiv:2212.04356].

The conv1d / mel frontend is a stub (as in the JAX package): batches carry
precomputed frame embeddings ``audio_embed`` [batch, 1500, d_model].  The
decoder decodes with a growing self-attention KV cache beside the fixed
1500-frame cross-attention k/v.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,  # decoder layers
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    max_source_positions=1500,
    gated_mlp=False,  # GELU fc1 / fc2
    attention_bias=True,
    tie_embeddings=True,
)
