"""Plain-torch version of flash attention (kernel B2).

    o[r] = sum_c softmax(s[r])[c] v[c],   s[r, c] = (q[r] * scale) . k[c]

over the keys c that are valid for row r: ``c < kv_len`` and, when causal,
``c <= r + kv_offset`` (the end-aligned mask: ``kv_offset = Skv - Sq`` by
default). A row with no valid key gives 0, as the kernel's ``l == 0`` guard
does; the reference's jnp ``attention_ref`` gives NaN there. GQA maps query
head h to kv head ``h // (Hq // Hkv)``.

This is the path a CPU tensor takes in ``ops.flash_attention``, the plain
version the kernel is held to on the card, and the function whose autograd
gives the kernel's backward. It computes in float32 (float64 inputs, the
CPU's float64 parity runs, in float64; two passes: the row max over the
valid keys, then the sums) and returns q's dtype. Masked scores are
replaced before ``exp`` and their weights zeroed, so neither the output nor
its gradient ever sees an inf or a NaN. With ``return_lse`` it also
returns each row's log-sum-exp, ``lse = ln sum_c exp(s[r, c])`` over the
valid c (-inf where there is none, with a gradient of 0 there), in the
compute dtype: what a merge of attentions over several key shards needs
(``models/attention.py::merge_partials``).

``attention_online`` is the bf16 kernel's arithmetic in plain torch, for
the tests: 64-key tiles, S = q . k in f32 then scaled, the online softmax in
the log2 domain, and P rounded where the kernel rounds it before P V (as a
bf16 hi + lo pair, or, with ``p_pairs=False``, as one bf16 value). No path
of the port runs it.
"""
from __future__ import annotations

import math

import torch

from ..hilo import through_pair

NEG = -1e30                       # the reference kernel's NEG_INF


def _wide(t):
    """``t`` in the compute dtype: float32, or float64 for float64."""
    return t if t.dtype == torch.float64 else t.float()


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None, kv_len: int | None = None,
                  kv_offset: int | None = None, return_lse: bool = False):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), Hq % Hkv == 0.
    Returns o (B, Hq, Sq, D) in q's dtype; with ``return_lse``, (o, lse),
    lse (B, Hq, Sq)."""
    Sq, D = q.shape[2], q.shape[3]
    Hq, Hkv, Skv = q.shape[1], k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kv_len = Skv if kv_len is None else kv_len
    kv_offset = Skv - Sq if kv_offset is None else kv_offset
    qf = _wide(q) * sm_scale
    kf = _wide(k).repeat_interleave(g, dim=1)
    vf = _wide(v).repeat_interleave(g, dim=1)
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
    empty = den == 0                                 # no valid key
    den = torch.where(empty, 1.0, den)
    o = (o / den).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(empty, -math.inf, m + torch.log(den))
    return o, lse[..., 0]


def attention_online(q, k, v, *, causal: bool = True,
                     sm_scale: float | None = None, kv_len: int | None = None,
                     kv_offset: int | None = None, block_k: int = 64,
                     p_pairs: bool = True):
    """The same function as ``attention_ref``, computed as the bf16 kernel
    computes it (see the module note). Returns (B, Hq, Sq, D) in q's
    dtype: pass f32 copies of bf16 inputs to see the output before its
    rounding to bf16."""
    Sq, D = q.shape[2], q.shape[3]
    Hq, Hkv, Skv = q.shape[1], k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    kv_len = Skv if kv_len is None else kv_len
    kv_offset = Skv - Sq if kv_offset is None else kv_offset
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    rows = torch.arange(Sq, device=q.device)[:, None]
    m = qf.new_full(qf.shape[:3], NEG)
    l = qf.new_zeros(qf.shape[:3])
    o = qf.new_zeros(qf.shape)
    for k0 in range(0, Skv, block_k):
        keys = torch.arange(k0, min(k0 + block_k, Skv), device=q.device)
        valid = (keys < kv_len)[None, :]
        if causal:
            valid = valid & (keys[None, :] <= rows + kv_offset)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, keys]) * scale_log2
        s = s.masked_fill(~valid, NEG)                   # mask BEFORE exp
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None]).masked_fill(~valid, 0.0)
        l = alpha * l + p.sum(dim=-1)
        pv = through_pair(p) if p_pairs else p.to(torch.bfloat16).float()
        o = alpha[..., None] * o + torch.einsum("bhqk,bhkd->bhqd", pv,
                                                vf[:, :, keys])
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
