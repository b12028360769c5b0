"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 40 experts top-8 (the spec line is taken as
authoritative over the prose's "32 experts")
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, experts_per_tok=8, tie_embeddings=True,
    remat_groups=4, microbatches=4,
)
