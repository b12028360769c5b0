"""Model / shape configuration dataclasses (a copy of ``repro.configs.base``).

One ``ModelConfig`` per assigned architecture (exact numbers from the task
spec, see per-arch files); ``reduced()`` derives the CPU test variant of the
same family (small widths/layers/experts, tiny vocab), equal to the
reference's for the same arguments. ``chip_smoke.py`` serves and trains
the full ``zamba2-2.7b`` and ``smollm-360m`` configs on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

Family = Literal["dense", "moe", "mamba_hybrid", "xlstm", "encdec", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # -------- MoE --------
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # -------- mamba / hybrid (zamba2) --------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0         # zamba2: shared block cadence
    shared_lora_rank: int = 0
    # -------- xlstm --------
    slstm_every: int = 0               # 1 sLSTM per N blocks (rest mLSTM)
    proj_factor: float = 2.0           # mLSTM up-projection
    # -------- enc-dec (whisper) --------
    n_enc_layers: int = 0
    # -------- vlm (qwen2-vl) --------
    patch_dim: int = 0                 # precomputed patch-embedding dim (stub)
    img_token_frac: float = 0.25       # fraction of sequence that is image
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # -------- numerics / structure --------
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: bool = True
    remat_groups: int = 0      # 0 = flat scan; G>0 = scan-of-scans (outer G
                               # groups, inner L/G layers, both checkpointed)
    microbatches: int = 1      # grad-accumulation microbatches in train_step
    opt_moment_dtype: str = "float32"   # Adam m dtype (bf16 at 100B+ scale)
    grad_dtype: str = "float32"         # gradient reduction dtype
    use_pallas: bool = False           # Pallas kernels (interpret on CPU)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:          # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def params_dense(self) -> int:
        """Rough total parameter count (reporting/6ND roofline)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = 3 * d * self.d_ff
            return L * (attn + mlp) + emb
        if self.family == "moe":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            moe = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
            return L * (attn + moe) + emb
        if self.family == "mamba_hybrid":
            di = self.d_inner
            mamba = d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) + di * d \
                + di * self.ssm_conv
            shared = 0
            if self.shared_attn_every:
                shared = 4 * d * d + 3 * d * self.d_ff
                shared += (L // self.shared_attn_every) * self.shared_lora_rank * 2 * d
            return L * mamba + shared + emb
        if self.family == "xlstm":
            dk = self.d_model
            up = int(self.proj_factor * d)
            mlstm = d * up * 2 + up * d + 3 * dk * d
            return L * mlstm + emb
        if self.family == "encdec":
            enc = self.n_enc_layers * (4 * d * d + 2 * d * self.d_ff)
            dec = L * (8 * d * d + 2 * d * self.d_ff)
            return enc + dec + emb
        return emb

    def params_active(self) -> int:
        if self.family != "moe":
            return self.params_dense()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        moe = 3 * d * self.d_ff * self.experts_per_tok + d * self.n_experts
        return L * (attn + moe) + self.vocab * d * 2


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# families with O(1)/sub-quadratic decode state can run long_500k
SUBQUADRATIC_FAMILIES = ("mamba_hybrid", "xlstm")


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 128, d_ff: int | None = None,
            n_experts: int | None = None) -> ModelConfig:
    """Same-family tiny variant for CPU smoke tests."""
    heads = max(2, min(4, cfg.n_heads))
    kv = max(1, min(heads, cfg.n_kv_heads if cfg.n_kv_heads else heads))
    while heads % kv:
        kv -= 1
    updates = dict(
        name=cfg.name + "-reduced",
        n_layers=max(layers, 2),
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=d_ff if d_ff is not None else (2 * d_model if cfg.d_ff else 0),
        vocab=vocab,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        remat_groups=0,
        microbatches=1,
    )
    if cfg.n_experts:
        updates["n_experts"] = n_experts or 8
        updates["experts_per_tok"] = min(2, n_experts or 8)
        updates["d_ff"] = d_model // 2
    if cfg.ssm_state:
        updates["ssm_state"] = 16
        updates["ssm_head_dim"] = 16
    if cfg.shared_attn_every:
        updates["shared_attn_every"] = 2
        updates["shared_lora_rank"] = 4
        updates["n_layers"] = 4
    if cfg.slstm_every:
        updates["slstm_every"] = 2
        updates["n_layers"] = 4
    if cfg.n_enc_layers:
        updates["n_enc_layers"] = 2
    if cfg.patch_dim:
        updates["patch_dim"] = 32
        half = (d_model // heads) // 2
        s2 = half * 3 // 8
        updates["mrope_sections"] = (half - 2 * s2, s2, s2)
    return replace(cfg, **updates)
