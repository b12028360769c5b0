"""Plain-torch version of flash attention (kernel B2).

    o[r] = sum_c softmax(s[r])[c] v[c],   s[r, c] = (q[r] * scale) . k[c]

over the keys c that are valid for row r: ``c < kv_len`` and, when causal,
``c <= r + kv_offset`` (the end-aligned mask: ``kv_offset = Skv - Sq`` by
default). A row with no valid key gives 0, as the kernel's ``l == 0`` guard
does; the reference's jnp ``attention_ref`` gives NaN there. GQA maps query
head h to kv head ``h // (Hq // Hkv)``.

This is the path a CPU tensor takes in ``ops.flash_attention``, the plain
version the kernel is held to on the card, and the function whose autograd
gives the kernel's backward. It computes in float32 (two passes: the row
max over the valid keys, then the sums) and returns q's dtype. Masked
scores are replaced before ``exp`` and their weights zeroed, so neither the
output nor its gradient ever sees an inf or a NaN.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30                       # the reference kernel's NEG_INF


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None, kv_len: int | None = None,
                  kv_offset: int | None = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q's dtype."""
    Sq, D = q.shape[2], q.shape[3]
    Hq, Hkv, Skv = q.shape[1], k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kv_len = Skv if kv_len is None else kv_len
    kv_offset = Skv - Sq if kv_offset is None else kv_offset
    qf = q.float() * sm_scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    ki = torch.arange(Skv, device=q.device)
    valid = (ki < kv_len)[None, :]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + kv_offset
        valid = valid & (qi >= ki[None, :])
    s = s.masked_fill(~valid, NEG)                   # mask BEFORE exp
    m = s.amax(dim=-1, keepdim=True).detach()        # softmax is shift-free
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return (o / torch.where(den == 0, 1.0, den)).to(q.dtype)
