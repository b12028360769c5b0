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

Context-parallel attention: on a mesh whose model axis divides neither
head count, ``_qkv`` shards K and V over the sequence (the reference's
fallback), and ``attend_train`` and ``attend_prefill`` run on each rank's
own key shard (``_on_key_shards``): every query of the rank's batch shard
against S/m keys, through B2 or ``_sdpa`` with the causal mask shifted to
the shard's start, each returning its rows' log-sum-exp; the ranks' partial
softmaxes are then merged (``merge_partials``), and nothing gathers K/V.
The decode step on a sequence-sharded KV cache merges the same way.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.attention import flash_attention
from ..sharding.context import (all_reduced, constrain, current_ctx,
                                on_mesh, product_on_shards, reduced,
                                takes_grad)
from .common import (EMBED, HEAD_DIM, HEADS, KV_HEADS, ParamSpec, apply_rope,
                     f32, remat, row_chunk)


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


def _kv_seq_fallback(cfg, seq: int) -> bool:
    """The reference's context-parallel fallback: inside a scope whose
    model axis divides neither the q- nor the kv-head count (and does
    divide the sequence), K/V shard the sequence instead of head_dim."""
    ctx = current_ctx()
    if ctx is None:
        return False
    msize = dict(zip(ctx[0].mesh_dim_names, ctx[0].shape)).get("model", 1)
    return bool(msize > 1 and cfg.n_kv_heads % msize and cfg.n_heads % msize
                and seq % msize == 0)


def _qkv(cfg, p, x):
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None))
    kv_axes = ("act_batch", "act_seq", "act_kv_heads", None)
    if _kv_seq_fallback(cfg, k.shape[1]):
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
LEAN_CHUNK = 128    # the same on a rank's shards without a gradient


def _sdpa_block(qg, k, v, *, causal: bool, q_offset: int, kv_valid_len,
                scale: float, return_lse: bool = False):
    """qg (B,qc,Hkv,g,Dh); k/v (B,Skv,Hkv,Dh), all in the compute dtype.
    Products accumulate in f32; softmax and masking in f32. With
    ``return_lse`` also each row's log-sum-exp over its valid keys,
    (B,qc,Hkv,g), -inf where it has none."""
    Skv = k.shape[1]
    qc = qg.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", f32(qg), f32(k)) * scale
    valid = None
    if causal:
        qi = torch.arange(qc, device=s.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=s.device)[None, :]
        valid = qi >= ki
    if kv_valid_len is not None:
        keep = torch.arange(Skv, device=s.device) < kv_valid_len
        valid = keep if valid is None else valid & keep
    if valid is not None:
        s = torch.where(valid, s, -1e30)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    # each buffer dropped once used: the chunk's float32 scores, then its
    # probabilities, are not kept beside what is made of them
    pr = torch.softmax(s, dim=-1)
    del s
    pr = f32(pr.to(v.dtype))
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, f32(v))
    if not return_lse:
        return o
    if valid is not None:                    # rows that see no key
        lse = torch.where(valid.any(-1), lse, -math.inf)
    return o, lse.permute(0, 3, 1, 2)


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0, kv_valid_len=None,
          return_lse: bool = False, lean: bool = False):
    """q (B,Sq,H,Dh); k/v (B,Skv,Hkv,Dh). Grouped attention; queries
    processed in chunks of Q_CHUNK (exact: softmax is per query over the
    full key range) so the score buffer never holds S^2, each chunk
    checkpointed where a gradient is taken. Query row r sees
    the keys c <= r + q_offset (causal) and c < kv_valid_len. With
    ``return_lse``, (o, lse): lse (B,Sq,H) float32, each row's log-sum-exp
    of its scaled scores, -inf where it sees no key. ``lean`` (a rank's
    shards on a mesh, where no gradient is taken: ``_sdpa_lean``) holds
    less of the same work at once."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    # the reference's f32 scale: 1/sqrt(Dh) rounded to float32
    scale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32))
    qg = q.reshape(B, Sq, Hkv, g, Dh).to(k.dtype)
    block = partial(_sdpa_block, causal=causal, kv_valid_len=kv_valid_len,
                    scale=scale, return_lse=return_lse)
    if lean and not takes_grad(q, k, v):
        return _sdpa_lean(block, q, qg, k, v, q_offset, return_lse)
    starts = ([0] if Sq <= Q_CHUNK or Sq % Q_CHUNK != 0
              else range(0, Sq, Q_CHUNK))
    qc = Sq if len(starts) == 1 else Q_CHUNK
    # where a gradient is taken over several chunks, each chunk is
    # checkpointed (the reference's jax.checkpoint of its scan body): the
    # backward recomputes one chunk's scores at a time instead of keeping
    # every chunk's
    ckpt = len(starts) > 1 and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    parts = [remat(ckpt, partial(block, q_offset=q_offset + i),
                   qg[:, i:i + qc], k, v)
             for i in starts]
    if not return_lse:
        return torch.cat(parts, dim=1).reshape(B, Sq, H, Dh).to(q.dtype)
    o, lse = (torch.cat(t, dim=1) for t in zip(*parts))
    return o.reshape(B, Sq, H, Dh).to(q.dtype), lse.reshape(B, Sq, H)


def _sdpa_lean(block, q, qg, k, v, q_offset: int, return_lse: bool):
    """``_sdpa``'s chunks without a gradient, in chunks of LEAN_CHUNK
    queries (where they divide Sq), each chunk's output written into one
    output of q's dtype as it is made: neither every chunk's float32
    output nor a chunk's scores at Q_CHUNK rows are live. Each query row
    is computed as in ``_sdpa``."""
    B, Sq, H, Dh = q.shape
    qc = LEAN_CHUNK if Sq > LEAN_CHUNK and Sq % LEAN_CHUNK == 0 else Sq
    out = torch.empty_like(qg, dtype=q.dtype)
    # float32, as the block's; float64 in the float64 runs
    lse = qg.new_empty(qg.shape[:-1], dtype=torch.promote_types(
        qg.dtype, torch.float32)) if return_lse else None
    for i in range(0, Sq, qc):
        r = block(qg[:, i:i + qc], k, v, q_offset=q_offset + i)
        if return_lse:
            out[:, i:i + qc], lse[:, i:i + qc] = r
        else:
            out[:, i:i + qc] = r
    out = out.reshape(B, Sq, H, Dh)
    return (out, lse.reshape(B, Sq, H)) if return_lse else out


def merge_partials(o, lse, reduce):
    """Attention over the union of several sets of keys, from each set's
    own: ``o`` (..., Dh) the attention over one set, ``lse`` (...) each
    row's log-sum-exp of its scaled scores over that set (-inf where it
    sees none of its keys); ``reduce(t, op)`` combines a tensor over the
    sets with ``op`` "max" or "sum": over a stacked dimension on one device
    (``stacked``), over the ranks that hold the sets on a mesh. Every row
    must see a key in some set. Returns o in its own dtype:

        M = max_r lse_r           (held constant: softmax is shift-free)
        w_r = exp(lse_r - M)      (0 where lse_r = -inf)
        o = sum_r w_r o_r / sum_r w_r

    Its gradient runs through both sums and through each lse_r."""
    m = reduce(lse.detach(), "max")
    w = torch.exp(lse - m)
    return (reduce(w[..., None] * o, "sum")
            / reduce(w, "sum")[..., None]).to(o.dtype)


def merge_in_rows(o, lse, reduce):
    """``merge_partials`` of one set's o (B, S, H, Dh) and lse (B, S, H)
    where no gradient is taken, over chunks of S: the (B, S, H) maximum and
    sum whole, each chunk's float32 weighted output reduced and written
    into one output in o's dtype. Each row's numbers are the whole
    merge's; only a chunk of the float32 product is live (``row_chunk``),
    not the product of the whole output and its sum."""
    m = reduce(lse, "max")
    w = torch.exp(lse - m)
    den = reduce(w, "sum")
    out = torch.empty_like(o)
    n = row_chunk(o.shape[1], o[:, :1].numel())
    for i in range(0, o.shape[1], n):
        j = slice(i, i + n)
        out[:, j] = (reduce(w[:, j, ..., None] * o[:, j], "sum")
                     / den[:, j, ..., None]).to(o.dtype)
    return out


def stacked(t, op: str):
    """``merge_partials``'s ``reduce`` over dimension 0, the key sets
    stacked on one device (on a mesh, that dimension sharded over the
    ranks)."""
    return t.amax(0) if op == "max" else t.sum(0)


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
    own KV head). Where q shards its heads and the KV heads do not (fewer
    KV heads than the mesh dimension, as GQA has), q keeps its head shard
    and each rank takes the KV heads its q heads read, out of K/V whole
    there (``_kv_heads``), as GSPMD partitions the reference's grouped
    einsum; their gradients are then partial sums there. Heads (or
    ``head_dim``, the fallback) sharded any other way are gathered first:
    attention cannot run on a ``head_dim`` shard. The ``tables`` (rotary
    cos and sin, (B, S, ...)) follow the batch sharding; ``core`` returns
    ``n_out`` tensors shaped as q or k (with two, the second is k rotated
    by the tables)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    qkv_pl, kv_pl, kv_grad = [], [], []
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        if a == Shard(0) or (a == Shard(2) and b == Shard(2)):
            qkv_pl.append(a), kv_pl.append(a), kv_grad.append(a)
        elif a == Shard(2) and _kv_heads_follow(H, Hkv, mesh.size(i)):
            qkv_pl.append(a), kv_pl.append(Replicate())
            kv_grad.append(Partial())
        else:
            qkv_pl.append(Replicate()), kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    rope_pl = [p if p == Shard(0) else Replicate() for p in qkv_pl]
    q = q.redistribute(mesh, qkv_pl)
    k, v = (t.redistribute(mesh, kv_pl) for t in (k, v))
    tables = tuple(on_mesh(t, mesh).redistribute(mesh, rope_pl)
                   for t in tables)
    if kv_pl != qkv_pl:
        local, offset = compute_local_shape_and_global_offset(q.shape, mesh,
                                                              qkv_pl)
        core = partial(_kv_heads, core, H // Hkv, offset[2], local[2],
                       n_out)
    out_pl = qkv_pl if n_out == 1 else (qkv_pl, kv_pl)
    fn = local_map(core, out_placements=out_pl,
                   in_placements=(qkv_pl, kv_pl, kv_pl)
                   + (rope_pl,) * len(tables),
                   in_grad_placements=(qkv_pl, kv_grad, kv_grad)
                   + (rope_pl,) * len(tables),
                   device_mesh=mesh)
    return fn, (q, k, v, *tables)


def _kv_heads_follow(H: int, Hkv: int, m: int) -> bool:
    """Whether m ranks that each hold H / m of H q heads can each read a
    whole run of the Hkv KV heads: H / m a multiple of the group H / Hkv,
    or a divisor of it."""
    if H % m or H % Hkv:
        return False
    hq, g = H // m, H // Hkv
    return hq % g == 0 or g % hq == 0


def _kv_heads(core, g: int, q0: int, hq: int, n_out: int, q, k, v,
              *tables):
    """``core`` of a rank's q heads q0 ... q0 + hq - 1 against the KV heads
    they read (group size g) out of the whole k and v; with two outputs,
    the second is the whole k rotated (``_prefill_core``'s)."""
    kv0, n = q0 // g, max(1, hq // g)
    out = core(q, k[:, :, kv0:kv0 + n], v[:, :, kv0:kv0 + n], *tables)
    if n_out == 1:
        return out
    return out[0], apply_rope(k, *tables)


def _key_part(kernel: bool, start: int, q, k, v, cos_q, sin_q, cos_k, sin_k):
    """One rank's share of context-parallel attention: every query (q, the
    whole sequence) against this rank's keys, which start at position
    ``start``. Each is rotated by its own positions' rows of the tables,
    then B2 (``kernel``) or the plain ``_sdpa`` runs with the causal mask
    shifted by ``start`` (the queries before it see none of these keys).
    Returns (o, lse) with a leading dimension of 1, the stack that
    ``merge_partials`` reduces, and the rotated k."""
    q = apply_rope(q, cos_q, sin_q)
    k = apply_rope(k, cos_k, sin_k)
    if kernel:
        o, lse = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 kv_offset=-start, return_lse=True)
        o, lse = o.transpose(1, 2), lse.transpose(1, 2)
    else:
        o, lse = _sdpa(q, k, v, causal=True, q_offset=-start,
                       return_lse=True, lean=True)
    return o[None], lse[None], k


def _on_key_shards(kernel: bool, q, k, v, cos, sin):
    """Causal attention of the DTensors q, k and v whose K/V shard the
    sequence over some mesh dimension (``_kv_seq_fallback``), as the
    reference's GSPMD partitions it: each rank runs ``_key_part`` on its own
    key shard and every query of its batch shard (``local_map``), and the
    ranks' partial softmaxes are merged (``merge_partials``, two all-reduces
    of (B, S, H) and one of (B, S, H, Dh) over that dimension). K/V keep
    their shard; q is replicated there (under ``sp`` its sequence is
    gathered, the reference's trade), and its gradient there is a partial
    sum. Every other mesh dimension keeps the batch shard or replicates.
    Where no gradient is taken, each rank merges its rows in chunks
    instead (``_merged_part``), so no rank holds a float32 product of the
    whole output. Returns (o, the rotated k placed as k)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = q.device_mesh
    q_pl, kv_pl, q_grad, rope_q, rope_k, stack_pl = ([] for _ in range(6))
    for a, b in zip(q.placements, k.placements):
        if b == Shard(1):                    # the keys' sequence
            pl = (Replicate(), b, Partial(), Replicate(), b, Shard(0))
        elif a == Shard(0):                  # the batch
            pl = (a, a, a, a, a, Shard(1))
        else:
            pl = (Replicate(),) * 6
        for dst, x in zip((q_pl, kv_pl, q_grad, rope_q, rope_k, stack_pl),
                          pl):
            dst.append(x)
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    tables = [on_mesh(t, mesh) for t in (cos, sin)]
    args = (q.redistribute(mesh, q_pl), k.redistribute(mesh, kv_pl),
            v.redistribute(mesh, kv_pl),
            *(t.redistribute(mesh, rope_q) for t in tables),
            *(t.redistribute(mesh, rope_k) for t in tables))
    if not takes_grad(q, k, v):
        groups = [mesh.get_group(i) for i, b in enumerate(kv_pl)
                  if b == Shard(1)]
        return local_map(partial(_merged_part, kernel, offset[1], groups),
                         out_placements=(q_pl, kv_pl),
                         in_placements=(q_pl, kv_pl, kv_pl) + (rope_q,) * 2
                         + (rope_k,) * 2, device_mesh=mesh)(*args)
    fn = local_map(partial(_key_part, kernel, offset[1]),
                   out_placements=(stack_pl, stack_pl, kv_pl),
                   in_placements=(q_pl, kv_pl, kv_pl) + (rope_q,) * 2
                   + (rope_k,) * 2,
                   in_grad_placements=(q_grad, kv_pl, kv_pl) + (rope_q,) * 2
                   + (rope_k,) * 2, device_mesh=mesh)
    o, lse, k = fn(*args)
    return merge_partials(o, lse, lambda t, op: reduced(stacked(t, op))), k


def _merged_part(kernel: bool, start: int, groups, *args):
    """``_key_part`` of one rank, its partial softmax then merged with the
    other ranks' over ``groups`` (``merge_in_rows``); returns (o, the
    rotated k)."""
    o, lse, k = _key_part(kernel, start, *args)
    return merge_in_rows(o[0], lse[0],
                         lambda t, op: all_reduced(t, op, groups)), k


def attend_train(cfg, p, x, cos, sin):
    """Causal self-attention over the whole sequence, no cache
    (``_attend_core``; on a mesh, on each rank's shards, and on each rank's
    key shard under the context-parallel fallback)."""
    q, k, v = _qkv(cfg, p, x)
    if isinstance(q, DTensor) and _kv_seq_fallback(cfg, k.shape[1]):
        o, _ = _on_key_shards(cfg.use_pallas, q, k, v, cos, sin)
    else:
        core = partial(_attend_core, cfg)
        args = (q, k, v, cos, sin)
        if isinstance(q, DTensor):
            core, args = _core_on_shards(core, *args)
        o = core(*args)
    out = _out(o, p["wo"])
    return constrain(out, ("act_batch", "act_seq", "act_embed"))


def _prefill_core(q, k, v, cos, sin, lean: bool = False):
    """Rotary embedding, then the plain causal ``_sdpa`` (``lean`` on a
    rank's shards); returns (out, the rotated k)."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return _sdpa(q, k, v, causal=True, lean=lean), k


def attend_prefill(cfg, p, x, cos, sin):
    """Returns (out, (k, v)): the K/V of these S positions, in the
    activation dtype; on a mesh the attention runs on each rank's shards
    (``_core_on_shards``), or on each rank's key shard under the
    context-parallel fallback, whose K/V then keep their sequence shard
    (the KV cache's ``cache_seq`` layout)."""
    q, k, v = _qkv(cfg, p, x)
    if isinstance(q, DTensor) and _kv_seq_fallback(cfg, k.shape[1]):
        o, k = _on_key_shards(False, q, k, v, cos, sin)
        return _out(o, p["wo"]), (k, v)
    core, args = _prefill_core, (q, k, v, cos, sin)
    if isinstance(q, DTensor):
        core, args = _core_on_shards(partial(core, lean=True), *args,
                                     n_out=2)
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
    process groups) each rank attends over its own positions and the ranks'
    partial softmaxes are merged by all-reduces over the groups
    (``merge_partials``)."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    n = k_cache.shape[1]
    if start <= pos < start + n:
        k_cache[:, pos - start] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos - start] = v[:, 0].to(v_cache.dtype)
    if not seq_groups:
        return _sdpa(q, k_cache, v_cache, causal=False, kv_valid_len=pos + 1)
    # this rank's positions start onwards: those up to pos are valid
    o, lse = _sdpa(q, k_cache, v_cache, causal=False,
                   kv_valid_len=pos + 1 - start, return_lse=True)
    return merge_partials(o, lse, lambda t, op: all_reduced(t, op,
                                                            seq_groups))


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
    shards, and, where no gradient is taken, on each rank's own keys where
    K/V shard their sequence (``_full_on_key_shards``: the enc-dec's cross
    cache in decode; its merge derives no gradient placements, so a
    training step gathers the keys, ``_core_on_shards``)."""
    if (isinstance(k, DTensor) and Shard(1) in k.placements
            and not takes_grad(q, k, v)):
        return _full_on_key_shards(q, k, v)
    core, args = partial(_sdpa, causal=False), (q, k, v)
    if isinstance(q, DTensor):
        core, args = _core_on_shards(partial(core, lean=True), *args)
    return core(*args)


def _full_local(seq_groups, q, k, v):
    """One rank's unmasked attention over its own keys, the ranks' partial
    softmaxes merged over ``seq_groups`` (``merge_partials``)."""
    o, lse = _sdpa(q, k, v, causal=False, return_lse=True, lean=True)
    return merge_partials(o, lse, lambda t, op: all_reduced(t, op,
                                                            seq_groups))


def _full_on_key_shards(q, k, v):
    """``attend_full`` of K/V (B, Skv, Hkv, Dh) whose sequence is sharded
    over some mesh dimensions, as ``_decode_on_shards`` attends a KV cache:
    K/V keep their placements (no rank gathers the keys); q follows their
    batch and head shards and is whole where they shard the sequence, and
    each rank's partial softmax over its keys is merged over those
    dimensions. Heads that only q shards are gathered."""
    mesh = k.device_mesh
    v = v.redistribute(mesh, k.placements)
    q_pl, seq_groups = [], []
    for i, a in enumerate(k.placements):
        if a in (Shard(0), Shard(2)):
            q_pl.append(a)
        elif a == Shard(1):
            q_pl.append(Replicate())
            seq_groups.append(mesh.get_group(i))
        elif a == Replicate():
            q_pl.append(a)
        else:
            raise ValueError(f"attention over K/V placed "
                             f"{tuple(k.placements)}")
    fn = local_map(partial(_full_local, seq_groups), out_placements=q_pl,
                   in_placements=(q_pl, tuple(k.placements),
                                  tuple(k.placements)), device_mesh=mesh)
    return fn(q.redistribute(mesh, q_pl), k, v)


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
