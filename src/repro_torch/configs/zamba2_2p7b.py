"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]. 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. The shared attention+MLP block (weight-tied, per-site LoRA) is
applied every 6 mamba layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="mamba_hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    shared_attn_every=6, shared_lora_rank=128,
    microbatches=2,
)
