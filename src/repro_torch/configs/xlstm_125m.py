"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (1 sLSTM per 4). 12L d_model=768
4H (kv=4) d_ff=0 (block-internal up-projection) vocab=50304
[arXiv:2405.04517; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304,
    slstm_every=4, proj_factor=2.0,
    microbatches=2,
)
