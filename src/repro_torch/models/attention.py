"""GQA attention with RoPE and a KV cache (the port of
``repro.models.attention``):

  * ``attend_train``   — causal self-attention, no cache; kernel B2 behind
    ``cfg.use_pallas``
  * ``attend_prefill`` — causal self-attention; returns the K/V it computed
  * ``attend_decode``  — 1-token step against a fixed-size cache, written in
    place
  * ``attend_cross``   — queries against precomputed encoder K/V
    (``cross_kv``), no mask (the encoder-decoder family)

The reference computes serving attention with jnp einsums outside any Pallas
kernel (its flash kernel is reached only by ``attend_train``), so ``_sdpa``
is plain torch: products of operands in the activation dtype, accumulated in
float32, and a float32 softmax, as the reference's ``_sdpa_block``. The
products of two bf16 values are exact in float32, so the operands are
widened to float32 and multiplied there; the port keeps float32 matmuls off
TF32 (torch's default for matmuls).
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.attention import flash_attention
from ..sharding.context import (constrain, current_ctx, on_mesh,
                                product_on_shards)
from .common import (EMBED, HEAD_DIM, HEADS, KV_HEADS, ParamSpec, apply_rope,
                     f32)


def attn_specs(cfg) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, H, Dh), (EMBED, HEADS, HEAD_DIM)),
        "wk": ParamSpec((d, Hkv, Dh), (EMBED, KV_HEADS, HEAD_DIM)),
        "wv": ParamSpec((d, Hkv, Dh), (EMBED, KV_HEADS, HEAD_DIM)),
        "wo": ParamSpec((H, Dh, d), (HEADS, HEAD_DIM, EMBED)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, Dh), (HEADS, HEAD_DIM), init="zeros")
        specs["bk"] = ParamSpec((Hkv, Dh), (KV_HEADS, HEAD_DIM), init="zeros")
        specs["bv"] = ParamSpec((Hkv, Dh), (KV_HEADS, HEAD_DIM), init="zeros")
    return specs


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads; on
    a mesh, on each rank's shards (the heads may be sharded unevenly for
    DTensor's view of the flattened product)."""
    if isinstance(w, DTensor):
        return product_on_shards(_proj, x, w)
    d, H, Dh = w.shape
    return (x @ w.reshape(d, H * Dh).to(x.dtype)).reshape(*x.shape[:2], H, Dh)


def _qkv(cfg, p, x):
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None))
    kv_axes = ("act_batch", "act_seq", "act_kv_heads", None)
    ctx = current_ctx()
    if ctx is not None:
        # the reference's context-parallel fallback: when neither the q-
        # nor the kv-head count divides the model axis, shard the KV
        # sequence instead of head_dim
        msize = dict(zip(ctx[0].mesh_dim_names, ctx[0].shape)).get("model", 1)
        if (msize > 1 and cfg.n_kv_heads % msize and cfg.n_heads % msize
                and k.shape[1] % msize == 0):
            kv_axes = ("act_batch", "act_kv_seq", "act_kv_heads", None)
    k = constrain(k, kv_axes)
    v = constrain(v, kv_axes)
    return q, k, v


def _out(o, wo):
    """einsum("bshk,hkd->bsd"); on a mesh, on each rank's shards."""
    if isinstance(wo, DTensor):
        return product_on_shards(_out, o, wo, contract=2)
    H, Dh, d = wo.shape
    return o.reshape(*o.shape[:2], H * Dh) @ wo.reshape(H * Dh, d).to(o.dtype)


Q_CHUNK = 512   # query-chunked attention: caps the f32 score buffer at
                # (B, Hkv, g, Q_CHUNK, Skv) instead of the full S^2


def _sdpa_block(qg, k, v, *, causal: bool, q_offset: int, kv_valid_len,
                scale: float):
    """qg (B,qc,Hkv,g,Dh); k/v (B,Skv,Hkv,Dh), all in the compute dtype.
    Products accumulate in f32; softmax and masking in f32."""
    Skv = k.shape[1]
    qc = qg.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", f32(qg), f32(k)) * scale
    if causal:
        qi = torch.arange(qc, device=s.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=s.device)[None, :]
        s = torch.where(qi >= ki, s, -1e30)
    if kv_valid_len is not None:
        ki = torch.arange(Skv, device=s.device)
        s = torch.where(ki < kv_valid_len, s, -1e30)
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", f32(pr.to(v.dtype)), f32(v))


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0, kv_valid_len=None):
    """q (B,Sq,H,Dh); k/v (B,Skv,Hkv,Dh). Grouped attention; queries
    processed in chunks of Q_CHUNK (exact: softmax is per query over the
    full key range) so the score buffer never holds S^2."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    # the reference's f32 scale: 1/sqrt(Dh) rounded to float32
    scale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32))
    qg = q.reshape(B, Sq, Hkv, g, Dh).to(k.dtype)
    if Sq <= Q_CHUNK or Sq % Q_CHUNK != 0:
        o = _sdpa_block(qg, k, v, causal=causal, q_offset=q_offset,
                        kv_valid_len=kv_valid_len, scale=scale)
    else:
        o = torch.cat([
            _sdpa_block(qg[:, i:i + Q_CHUNK], k, v, causal=causal,
                        q_offset=q_offset + i, kv_valid_len=kv_valid_len,
                        scale=scale)
            for i in range(0, Sq, Q_CHUNK)], dim=1)
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def _attend_core(cfg, q, k, v, cos, sin):
    """Rotary embedding, then causal attention: kernel B2
    (``flash_attention``, the Hopper kernel on a CUDA tensor) under
    ``cfg.use_pallas``, fed transposed views of q, k and v, so no
    (B, H, S, D) copy is made; otherwise the plain ``_sdpa``."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.use_pallas:
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    return _sdpa(q, k, v, causal=True)


def _core_on_shards(core, q, k, v, *tables, n_out: int = 1):
    """(``core`` as a ``local_map`` over the mesh, its DTensor arguments).
    The kernels launch on ``data_ptr``, so no DTensor may reach them: each
    rank runs ``core`` on its shards, the reference's ``shard_map``. The
    shards keep q's batch sharding, and its head sharding where the KV
    heads shard on the same mesh dimension (a local q head then meets its
    own KV head); heads (or ``head_dim``, the fallback) sharded any other
    way are gathered first: attention cannot run on a ``head_dim`` shard.
    The ``tables`` (rotary cos and sin, (B, S, ...)) follow the batch
    sharding; ``core`` returns ``n_out`` tensors shaped as q or k."""
    mesh = q.device_mesh
    qkv_pl = []
    for a, b in zip(q.placements, k.placements):
        if a == Shard(0) or (a == Shard(2) and b == Shard(2)):
            qkv_pl.append(a)
        else:
            qkv_pl.append(Replicate())
    rope_pl = [p if p == Shard(0) else Replicate() for p in qkv_pl]
    q, k, v = (t.redistribute(mesh, qkv_pl) for t in (q, k, v))
    tables = tuple(on_mesh(t, mesh).redistribute(mesh, rope_pl)
                   for t in tables)
    fn = local_map(core,
                   out_placements=qkv_pl if n_out == 1 else (qkv_pl,) * n_out,
                   in_placements=(qkv_pl,) * 3 + (rope_pl,) * len(tables),
                   device_mesh=mesh)
    return fn, (q, k, v, *tables)


def attend_train(cfg, p, x, cos, sin):
    """Causal self-attention over the whole sequence, no cache
    (``_attend_core``; on a mesh, on each rank's shards)."""
    q, k, v = _qkv(cfg, p, x)
    core = partial(_attend_core, cfg)
    args = (q, k, v, cos, sin)
    if isinstance(q, DTensor):
        core, args = _core_on_shards(core, *args)
    out = _out(core(*args), p["wo"])
    return constrain(out, ("act_batch", "act_seq", "act_embed"))


def _prefill_core(q, k, v, cos, sin):
    """Rotary embedding, then the plain causal ``_sdpa``; returns (out, the
    rotated k)."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return _sdpa(q, k, v, causal=True), k


def attend_prefill(cfg, p, x, cos, sin):
    """Returns (out, (k, v)): the K/V of these S positions, in the
    activation dtype; on a mesh the attention runs on each rank's shards
    (``_core_on_shards``)."""
    q, k, v = _qkv(cfg, p, x)
    core, args = _prefill_core, (q, k, v, cos, sin)
    if isinstance(q, DTensor):
        core, args = _core_on_shards(core, *args, n_out=2)
    o, k = core(*args)
    return _out(o, p["wo"]), (k, v)


def attend_decode(cfg, p, x, cos, sin, cache, pos: int):
    """x (B,1,d); cache (k, v) each (B,Smax,Hkv,Dh); pos: the position of
    this token. Writes its K/V into the cache at ``pos`` IN PLACE (the
    reference returns an updated copy) and returns (out, cache); on a mesh
    on each rank's shards of the cache (``_decode_on_shards``)."""
    k_cache, v_cache = cache
    q, k, v = _qkv(cfg, p, x)
    if isinstance(k_cache, DTensor):
        return _out(_decode_on_shards(q, k, v, k_cache, v_cache, cos, sin,
                                      pos), p["wo"]), cache
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    o = _sdpa(q, k_cache, v_cache, causal=False, kv_valid_len=pos + 1)
    return _out(o, p["wo"]), (k_cache, v_cache)


def _decode_local(pos, start, seq_groups, q, k, v, k_cache, v_cache, cos,
                  sin):
    """One rank's decode step against its shard of the KV cache, which
    holds positions ``start`` onwards: the rank that holds ``pos`` writes
    the token's K/V there in place. Without ``seq_groups`` this is the
    one-device step; with them (the cache's sequence sharded over those
    process groups) each rank attends over its own positions and the
    softmax's maximum, sum and weighted values are all-reduced over the
    groups."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    n = k_cache.shape[1]
    if start <= pos < start + n:
        k_cache[:, pos - start] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos - start] = v[:, 0].to(v_cache.dtype)
    if not seq_groups:
        return _sdpa(q, k_cache, v_cache, causal=False, kv_valid_len=pos + 1)
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op):
        for g in seq_groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
        return t
    B, _, H, Dh = q.shape
    Hkv = k_cache.shape[2]
    scale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32))
    qg = q.reshape(B, 1, Hkv, H // Hkv, Dh).to(k_cache.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", f32(qg), f32(k_cache)) * scale
    ki = torch.arange(start, start + n, device=s.device)
    s = torch.where(ki <= pos, s, -1e30)
    m = reduce(s.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(s - m)
    total = reduce(e.sum(dim=-1, keepdim=True), "sum")
    o = reduce(torch.einsum("bhgqk,bkhd->bqhgd", f32(e.to(v_cache.dtype)),
                            f32(v_cache)), "sum")
    o = o / total.permute(0, 3, 1, 2, 4)
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def _decode_on_shards(q, k, v, k_cache, v_cache, cos, sin, pos: int):
    """``_decode_local`` on each rank's shards. The cache keeps its own
    placements, so each rank writes into its own shard in place; q, k and
    v follow the cache's batch and KV-head shards and are whole wherever
    it shards the sequence; the rotary tables follow the batch."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = k_cache.device_mesh
    qkv_pl, seq_groups = [], []
    for i, a in enumerate(k_cache.placements):
        if a in (Shard(0), Shard(2)):
            qkv_pl.append(a)
        elif a == Shard(1):
            qkv_pl.append(Replicate())
            seq_groups.append(mesh.get_group(i))
        elif a == Replicate():
            qkv_pl.append(a)
        else:
            raise ValueError(f"a decode step on a KV cache placed "
                             f"{tuple(k_cache.placements)}")
    rope_pl = [a if a == Shard(0) else Replicate() for a in qkv_pl]
    _, offset = compute_local_shape_and_global_offset(
        k_cache.shape, mesh, k_cache.placements)
    v_cache = v_cache.redistribute(mesh, k_cache.placements)
    fn = local_map(partial(_decode_local, pos, offset[1], seq_groups),
                   out_placements=qkv_pl,
                   in_placements=(qkv_pl,) * 3
                   + (tuple(k_cache.placements),) * 2 + (rope_pl,) * 2,
                   device_mesh=mesh)
    return fn(*(t.redistribute(mesh, qkv_pl) for t in (q, k, v)), k_cache,
              v_cache, *(on_mesh(t, mesh).redistribute(mesh, rope_pl)
                         for t in (cos, sin)))


def attend_full(q, k, v):
    """Attention with no mask (``_sdpa``); on a mesh, on each rank's
    shards."""
    core, args = partial(_sdpa, causal=False), (q, k, v)
    if isinstance(q, DTensor):
        core, args = _core_on_shards(core, *args)
    return core(*args)


def attend_cross(cfg, p, x, kv_cache):
    """Cross-attention of x (B,S,d) against precomputed encoder K/V
    ``(k, v)`` each (B,S_enc,Hkv,Dh): every query sees every key."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    k, v = kv_cache
    return _out(attend_full(q, k, v), p["wo"])


def cross_kv(cfg, p, enc_out):
    """The encoder output's K/V for ``attend_cross``."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v


def kv_cache_shape(cfg, batch: int, max_len: int):
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return (batch, max_len, Hkv, Dh)
