"""xlstm-1.3b [ssm] -- sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]
(port of ``repro.configs.xlstm_1_3b``).

48 blocks as 6 super-blocks of ``slstm_period`` = 8: 7 mLSTM blocks
(matrix memory, the chunked gated linear attention with its normalizer as
an extra column of v: dk = 1024, dv = 1025 at 4 heads of the 4096-wide
inner dim), then one sLSTM block (scalar memory, a strict time
recurrence).  d_ff = 0: the blocks carry their own up / down projections.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    ssm_state=512,  # mLSTM matrix memory dim == head_dim
    ssm_head_dim=512,
    ssm_expand=2,
    ssm_chunk=256,
    slstm_period=8,  # one sLSTM per 8 blocks
    attention="none",
)
