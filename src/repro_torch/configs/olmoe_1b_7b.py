"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    n_experts=64, experts_per_tok=8,
    remat_groups=4, microbatches=4,
)
