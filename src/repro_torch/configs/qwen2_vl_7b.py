"""qwen2-vl-7b [vlm]: M-RoPE, dynamic resolution; the vision tower is a STUB
(input_specs supplies precomputed patch embeddings). 28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, qkv_bias=True,
    patch_dim=1176, img_token_frac=0.25, mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    remat_groups=4, microbatches=4,
)
