"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    remat_groups=8, microbatches=16,
    opt_moment_dtype="bfloat16", grad_dtype="bfloat16",
)
