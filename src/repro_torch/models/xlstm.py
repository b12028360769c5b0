"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential), the port of ``repro.models.xlstm``.

mLSTM runs in the chunkwise form: within a chunk the stabilized parallel
(attention-like) form; across chunks a carried (C, n, m) matrix state, so
the work is O(S·L) and the decode step is the O(1) recurrence.

Stabilization follows the paper: log-gates with a running max ``m``;
normalizer ``max(|n^T q|, exp(-m))``.

sLSTM keeps per-head scalar memories with block-diagonal recurrent weights
and exponential gating; it is sequential by nature.

Both recurrences are the reference's ``lax.scan``s: ``torch._higher_order_
ops.scan``'s op (``_scan``), each inside a ``torch.autograd.Function``
whose backward is a reverse scan of the body's VJP, written out by hand
(``_SLSTMScan`` over time, ``_MLSTMScan`` over chunks in segments). The
backward recomputes each step (chunk) from the carry that entered it, so
the forward keeps only those carries, where autograd through a Python
loop kept every step's intermediates; a traced step keeps each loop as one
``scan`` node (``core/features.py`` weighs its body by its trips), and the
cost counter counts it by its first two trips (``core/hlo_analysis.py``).
Only the one-token decode step calls the cell or the O(1) recurrence
directly.

On a mesh both recurrences run on each rank's shards (``local_map``): the
batch shard, and the heads over a mesh dimension that divides them;
anything else is gathered first. No loop steps over DTensors: DTensor's
dispatch on each op of each of S steps would dwarf the work. A carried
state (a prefill's, for decode) goes onto the same batch and head shards
and enters the ``local_map`` beside the gates; without one each rank
starts from zeros. A decode step runs the O(1) recurrence on the shards.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch._higher_order_ops.scan import scan_op
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..sharding.context import product_on_shards, project, reduced
from .common import (EMBED, HEAD_DIM, HEADS, INNER, ParamSpec, f32, rms_norm,
                     silu)

LOG_EPS = -30.0


# ------------------------------------------------------------------- mLSTM

def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    up = int(cfg.proj_factor * d)
    H = cfg.n_heads
    Dh = up // H
    return {
        "w_up": ParamSpec((d, up), (EMBED, INNER)),
        "w_gate": ParamSpec((d, up), (EMBED, INNER)),
        "wq": ParamSpec((up, H, Dh), (INNER, HEADS, HEAD_DIM)),
        "wk": ParamSpec((up, H, Dh), (INNER, HEADS, HEAD_DIM)),
        "wv": ParamSpec((up, H, Dh), (INNER, HEADS, HEAD_DIM)),
        "w_i": ParamSpec((up, H), (INNER, HEADS), scale=0.02),
        "b_i": ParamSpec((H,), (HEADS,), init="zeros"),
        "w_f": ParamSpec((up, H), (INNER, HEADS), scale=0.02),
        "b_f": ParamSpec((H,), (HEADS,), init="ones", ),
        "out_norm": ParamSpec((up,), (INNER,), init="ones"),
        "w_down": ParamSpec((up, d), (INNER, EMBED)),
    }


def _f32_scale(dh: int) -> float:
    """1/sqrt(dh) rounded to float32, as the reference computes it."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def mlstm_chunk_scan(q, k, v, logi, logf, state, chunk: int):
    """q/k/v: (B,S,H,Dh), in the model's dtype or f32 (widened chunk by
    chunk); logi/logf: (B,S,H) f32;
    state: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)).
    Returns (y (B,S,H,Dh), new_state). The sequence is padded to whole
    chunks (input gate LOG_EPS, forget gate 0: the padding adds nothing)
    and scanned chunk by chunk (``_MLSTMScan``)."""
    S = q.shape[1]
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=LOG_EPS)
        logf = F.pad(logf, (0, 0, 0, pad))
    y, *state = _MLSTMScan.apply(_wants_grad(q, k, v, logi, logf, *state),
                                 q, k, v, logi, logf, *state, chunk)
    return y[:, :S], tuple(state)


def _mlstm_carry(C, n, m, kt, vt, li, cs):
    """The carry update of a chunk (cs the cumulative log forget gates):
    the next (C, n, m) and the intermediates its VJP reads."""
    total = cs[:, -1, :]                                        # (B,H)
    dec_t = total[:, None, :] - cs + li                         # (B,L,H)
    a_c = total + m
    dec_max = dec_t.amax(dim=1)
    m_next = torch.maximum(a_c, dec_max)
    wC = torch.exp(dec_t - m_next[:, None, :])                  # (B,L,H)
    decay = torch.exp(a_c - m_next)
    C1 = decay[:, :, None, None] * C + torch.einsum(
        "blh,blhd,blhe->bhde", wC, kt, vt)
    n1 = decay[:, :, None] * n + torch.einsum("blh,blhd->bhd", wC, kt)
    return (C1, n1, m_next), dict(dec_t=dec_t, a_c=a_c, dec_max=dec_max,
                                  wC=wC, decay=decay)


def _mlstm_chunk(C, n, m, qt, kt, vt, li, lf):
    """One chunk of the scan (the reference's scan body; q/k/v cast to
    float32 here): the chunk's outputs from the carried (C, n, m), and the
    next carry; returns (y, (C, n, m)) and the intermediates its VJP
    reads."""
    qt, kt, vt = f32(qt), f32(kt), f32(vt)
    L, Dh = qt.shape[1], qt.shape[-1]
    scale = _f32_scale(Dh)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=qt.device))[None, :, :, None]
    cs = torch.cumsum(lf, dim=1)                                # (B,L,H)
    # intra-chunk log decay matrix
    logD = (cs[:, :, None, :] - cs[:, None, :, :]) + li[:, None, :, :]
    logD = torch.where(tri, logD, -math.inf)
    m_intra = logD.amax(dim=2)                                  # (B,L,H)
    b_inter = cs + m[:, None, :]                                # (B,L,H)
    m_max = torch.maximum(m_intra, b_inter)
    m_new = m_max.clamp_min(-1e30)
    D = torch.exp(logD - m_new[:, :, None, :])                  # (B,L,L,H)
    P = torch.einsum("blhd,bthd->blth", qt, kt) * scale
    Sm = P * D
    w_inter = torch.exp(b_inter - m_new)                        # (B,L,H)
    qs = qt * scale
    qC = torch.einsum("blhd,bhde->blhe", qs, C)
    qn = torch.einsum("blhd,bhd->blh", qs, n)
    y_num = torch.einsum("blth,bthd->blhd", Sm, vt) + w_inter[..., None] * qC
    norm = Sm.sum(dim=2) + w_inter * qn
    e_m = torch.exp(-m_new)
    den = torch.maximum(norm.abs(), e_m)
    y = y_num / den[..., None].clamp_min(1e-30)
    carry, saved = _mlstm_carry(C, n, m, kt, vt, li, cs)
    saved.update(scale=scale, logD=logD, m_intra=m_intra, b_inter=b_inter,
                 m_max=m_max, m_new=m_new, D=D, P=P, Sm=Sm, w=w_inter,
                 qs=qs, qC=qC, qn=qn, y_num=y_num, norm=norm, e_m=e_m,
                 den=den, qt=qt, kt=kt, vt=vt)
    return y, carry, saved


def _max_vjp(a, b, g):
    """torch.maximum(a, b)'s gradient: all to the larger, halved at a
    tie."""
    half = torch.where(a == b, g * 0.5, g)
    return half.masked_fill(a < b, 0.0), half.masked_fill(a > b, 0.0)


def _amax_vjp(x, mx, g, dim: int):
    """x.amax(dim)'s gradient: shared evenly among the maxima."""
    hit = (x == mx.unsqueeze(dim)).to(g.dtype)
    return hit * (g / hit.sum(dim)).unsqueeze(dim)


def _mlstm_chunk_vjp(C, n, m, qt, kt, vt, li, lf, gy, gC1, gn1, gm1):
    """The chunk's VJP: the chunk recomputed from its carry, then the
    gradients of (y, C, n, m) out taken back to its inputs and carry in.
    Returns (gq, gk, gv, gli, glf) and (gC, gn, gm)."""
    _, _, s = _mlstm_chunk(C, n, m, qt, kt, vt, li, lf)
    qt, kt, vt = s["qt"], s["kt"], s["vt"]
    L = qt.shape[1]
    scale, w, D, P, Sm, wC, decay = (s[k] for k in (
        "scale", "w", "D", "P", "Sm", "wC", "decay"))
    # the carry update
    gC = decay[:, :, None, None] * gC1
    gn = decay[:, :, None] * gn1
    g_decay = (gC1 * C).sum((-2, -1)) + (gn1 * n).sum(-1)
    gCv = torch.einsum("bhde,blhe->blhd", gC1, vt)
    g_wC = (torch.einsum("blhd,blhd->blh", gCv, kt)
            + torch.einsum("bhd,blhd->blh", gn1, kt))
    gk = wC[..., None] * (gCv + gn1[:, None])
    gv = wC[..., None] * torch.einsum("bhde,blhd->blhe", gC1, kt)
    t_wC = g_wC * wC                                # to dec_t - m_next
    t_dec = g_decay * decay                         # to a_c - m_next
    g_ac, g_dmax = _max_vjp(s["a_c"], s["dec_max"],
                            gm1 - t_wC.sum(1) - t_dec)
    g_ac = g_ac + t_dec
    g_dec = t_wC + _amax_vjp(s["dec_t"], s["dec_max"], g_dmax, 1)
    gm = g_ac
    gli = g_dec
    gcs = F.pad((g_ac + g_dec.sum(1))[:, None], (0, 0, L - 1, 0)) - g_dec
    # the output
    denc = s["den"].clamp_min(1e-30)
    g_ynum = gy / denc[..., None]
    g_den = -(gy * s["y_num"]).sum(-1) / (denc * denc)
    g_den = g_den.masked_fill(s["den"] < 1e-30, 0.0)
    norm = s["norm"]
    g_abs, g_e = _max_vjp(norm.abs(), s["e_m"], g_den)
    g_norm = g_abs * torch.sign(norm)
    g_mnew = -g_e * s["e_m"]
    g_w = g_norm * s["qn"] + (g_ynum * s["qC"]).sum(-1)
    g_qn = g_norm * w
    g_qC = g_ynum * w[..., None]
    gSm = g_norm[:, :, None] + torch.einsum("blhd,bthd->blth", g_ynum, vt)
    gv = gv + torch.einsum("blth,blhd->bthd", Sm, g_ynum)
    g_qs = (torch.einsum("blhe,bhde->blhd", g_qC, C)
            + g_qn[..., None] * n[:, None])
    gC = gC + torch.einsum("blhd,blhe->bhde", s["qs"], g_qC)
    gn = gn + torch.einsum("blh,blhd->bhd", g_qn, s["qs"])
    t_w = g_w * w                                   # to b_inter - m_new
    gP = gSm * D
    t_D = gSm * P * D                               # to logD - m_new
    g_mnew = g_mnew - t_w - t_D.sum(2)
    gq = (torch.einsum("blth,bthd->blhd", gP, kt) + g_qs) * scale
    gk = gk + torch.einsum("blth,blhd->bthd", gP, qt) * scale
    g_max = g_mnew.masked_fill(s["m_max"] < -1e30, 0.0)
    g_intra, g_b = _max_vjp(s["m_intra"], s["b_inter"], g_max)
    g_b = g_b + t_w
    g_logD = t_D + _amax_vjp(s["logD"], s["m_intra"], g_intra, 2)
    gm = gm + g_b.sum(1)
    gcs = gcs + g_b + g_logD.sum(2) - g_logD.sum(1)
    gli = gli + g_logD.sum(1)
    glf = torch.flip(torch.cumsum(torch.flip(gcs, (1,)), 1), (1,))
    return (gq, gk, gv, gli, glf), (gC, gn, gm)


def _scan(body, init, xs, extra=()):
    """``torch._higher_order_ops.scan``'s op over dim 0 of ``xs``:
    ``body(*carry, *x slices, *extra)`` returns the next carry, then the
    trip's outputs; returns (carry, the outputs stacked). The op is called
    directly: eagerly it loops (no compile), under ``make_fx`` it is one
    ``scan`` node with the body as a subgraph, and the cost counter counts
    it (``core/hlo_analysis.py``). The body closes over no tensor (each
    comes in ``xs`` or ``extra``) and returns no input or tensor twice; its
    carries are contiguous, as the inits are made (a traced scan holds each
    carry to its init's strides)."""
    n = len(init)
    out = scan_op(body, [t.contiguous() for t in init], list(xs),
                  tuple(extra))
    return tuple(out[:n]), tuple(out[n:])


def _wants_grad(*tensors) -> bool:
    """Whether autograd will take a gradient through a Function of
    ``tensors``: its forward then keeps what its backward reads."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _take(t, i):
    """Slice ``i`` (a 0-d index tensor) of ``t``'s dim 0."""
    return t.index_select(0, i.reshape(1)).squeeze(0)


def _segment(n_chunks: int) -> int:
    """Chunks a segment: the divisor of ``n_chunks`` nearest above its
    square root."""
    return next(k for k in range(math.isqrt(n_chunks), n_chunks + 1)
                if k and n_chunks % k == 0) if n_chunks > 1 else 1


def _mlstm_chunk_body(C, n, m, qt, kt, vt, li, lf):
    y, carry, _ = _mlstm_chunk(C, n, m, qt, kt, vt, li, lf)
    return (*carry, y)


def _mlstm_segment_body(C, n, m, q, k, v, li, lf):
    """A segment's chunks, scanned; the segment's entering carry kept."""
    carry, (y,) = _scan(_mlstm_chunk_body, (C, n, m), (q, k, v, li, lf))
    return (*carry, y, C.clone(), n.clone(), m.clone())


def _mlstm_carry_body(C, n, m, kt, vt, li, lf):
    carry, _ = _mlstm_carry(C, n, m, f32(kt), f32(vt), li,
                            torch.cumsum(lf, dim=1))
    return (*carry, C.clone(), n.clone(), m.clone())


def _mlstm_chunk_bwd_body(gC, gn, gm, i, C, n, m, q, k, v, li, lf, gy):
    at = [_take(t, i) for t in (C, n, m, q, k, v, li, lf, gy)]
    grads, carry = _mlstm_chunk_vjp(*at, gC, gn, gm)
    return (*carry, *(g.to(t.dtype) for g, t in zip(grads, (q, k, v))),
            *grads[3:])


def _mlstm_segment_bwd_body(gC, gn, gm, s, C0, n0, m0, q, k, v, li, lf, gy):
    """A segment's VJP: its chunks' entering carries recomputed from the
    segment's, then its chunks in reverse."""
    q, k, v, li, lf, gy = (_take(t, s) for t in (q, k, v, li, lf, gy))
    _, states = _scan(_mlstm_carry_body, (_take(C0, s), _take(n0, s),
                                          _take(m0, s)), (k, v, li, lf))
    rev = torch.arange(q.shape[0] - 1, -1, -1, device=q.device)
    carry, grads = _scan(_mlstm_chunk_bwd_body, (gC, gn, gm), (rev,),
                         (*states, q, k, v, li, lf, gy))
    return (*carry, *(g.index_select(0, rev) for g in grads))


class _MLSTMScan(torch.autograd.Function):
    """The mLSTM over whole chunks as a scan (the reference's ``lax.scan``
    over chunks), in segments of about the square root of the chunk count
    (``_segment``) where a gradient is wanted: forward a scan over the
    segments, each a scan of the chunk body from the carried (C, n, m),
    each segment's entering carry kept (without a gradient, one scan of the
    chunk body over the chunks); backward a scan over the segments in
    reverse, each recomputing its chunks' entering carries (a scan of the
    carry update) and then scanning its chunks in reverse through the
    body's VJP (``_mlstm_chunk_vjp``), which recomputes the chunk and
    carries the gradients of (C, n, m). So the backward holds the carries
    of two segments' worth of chunks, not of every chunk. q/k/v come in
    the model's dtype and are widened chunk by chunk; their gradients go
    back in it."""

    @staticmethod
    def forward(ctx, keep, q, k, v, logi, logf, C, n, m, chunk):
        B, Sp, H, Dh = q.shape
        nc = Sp // chunk
        state = (C.detach(), n.detach(), m.detach())
        if not keep:        # no backward: one scan over the chunks
            xs = [a.detach().unflatten(1, (nc, chunk)).movedim(1, 0)
                  for a in (q, k, v, logi, logf)]
            carry, (ys,) = _scan(_mlstm_chunk_body, state, xs)
            return (ys.movedim(0, 1).reshape(B, Sp, H, Dh), *carry)
        K = _segment(nc)
        xs = [a.detach().unflatten(1, (nc // K, K, chunk)).movedim((1, 2),
                                                                    (0, 1))
              for a in (q, k, v, logi, logf)]
        carry, (ys, *states) = _scan(_mlstm_segment_body, state, xs)
        ctx.save_for_backward(*xs, *states)
        return (ys.movedim((0, 1), (1, 2)).reshape(B, Sp, H, Dh), *carry)

    @staticmethod
    def backward(ctx, gy, gC, gn, gm):
        xs = ctx.saved_tensors
        n_seg, K, B, L, H, Dh = xs[0].shape
        rev = torch.arange(n_seg - 1, -1, -1, device=gy.device)
        gy = gy.unflatten(1, (n_seg, K, L)).movedim((1, 2), (0, 1))
        carry, grads = _scan(_mlstm_segment_bwd_body, (gC, gn, gm), (rev,),
                             (*xs[5:], *xs[:5], gy))
        # back in order, batch first: one copy at a time, each stacked
        # gradient dropped once copied
        grads, out = list(grads), []
        while grads:
            out.append(grads.pop(0).movedim((0, 1), (1, 2))
                       .index_select(1, rev).flatten(1, 3))
        return (None, *out, *carry, None)


def _head_shards(t, dim: int) -> list:
    """Per mesh dimension, the shard a recurrence over ``t`` (B, S, ...,
    heads at ``dim``, ...) keeps: ``t``'s batch shard, else the heads where
    that mesh dimension divides what is left of them, else none."""
    out, left = [], t.shape[dim]
    for a, n in zip(t.placements, t.device_mesh.shape):
        if a == Shard(0):
            out.append(a)
        elif left % n == 0 and n > 1:
            out.append(Shard(dim))
            left //= n
        else:
            out.append(Replicate())
    return out


def _mlstm_step(q, k, v, logi, logf, state):
    """The O(1) recurrence of one position: q/k/v (B,1,H,Dh), logi/logf
    (B,1,H) f32, state (C, n, m). Returns (y (B,1,H,Dh), new state)."""
    C, n, m = state
    scale = _f32_scale(q.shape[-1])
    li, lf = logi[:, 0], logf[:, 0]                             # (B,H)
    m_new = torch.maximum(lf + m, li)
    f_w = torch.exp(lf + m - m_new)
    i_w = torch.exp(li - m_new)
    C = f_w[:, :, None, None] * C + i_w[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k[:, 0], v[:, 0])
    n = f_w[:, :, None] * n + i_w[:, :, None] * k[:, 0]
    qs = q[:, 0] * scale
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(),
                        torch.exp(-m_new))
    return (num / den[..., None].clamp_min(1e-30))[:, None], (C, n, m_new)


def _cell_local(chunk, q, k, v, logi, f_pre, *state):
    """The mLSTM on plain tensors (one device's, or one rank's shards): the
    chunk scan, or the decode step when ``chunk`` is None, from ``state``
    or else from zeros; the forget gates come before their log-sigmoid. y
    has its heads flattened, (B, S, H * Dh) (DTensor cannot view a
    gradient sharded over them back into heads that the mesh does not
    divide)."""
    B, S, H, Dh = q.shape
    state = state or (logi.new_zeros((B, H, Dh, Dh)),
                      logi.new_zeros((B, H, Dh)), logi.new_zeros((B, H)))
    logf = F.logsigmoid(f_pre)
    if chunk is None:
        y, state = _mlstm_step(q, k, v, logi, logf, state)
    else:
        y, state = mlstm_chunk_scan(q, k, v, logi, logf, state, chunk)
    return y.reshape(B, S, H * Dh), state


def _cell_on_shards(q, k, v, logi, f_pre, state, chunk):
    """``_cell_local`` on each rank's shards; a carried (C, n, m) goes onto
    the gates' batch and head shards. A carried DTensor state (a decode
    step's cache) keeps its own: the recurrence takes its batch and head
    shards, so the new state goes back into the cache as it is, where a
    head shard over a mesh dimension that the cache replicates would have
    it gathered there."""
    mesh = q.device_mesh
    pl = _head_shards(q, 2)
    if state is not None and isinstance(state[0], DTensor):
        pl = [Shard(2) if a == Shard(1) else a if a == Shard(0)
              else Replicate() for a in state[0].placements]
    st = [Shard(1) if a == Shard(2) else a for a in pl]
    state = () if state is None else tuple(state)
    fn = local_map(partial(_cell_local, chunk),
                   out_placements=(pl, st, st, st),
                   in_placements=(pl,) * 5 + (st,) * len(state),
                   device_mesh=mesh)
    return fn(*(t.redistribute(mesh, pl) for t in (q, k, v, logi, f_pre)),
              *(t.redistribute(mesh, st) for t in state))


def mlstm_init_state(cfg, batch: int, device=None, dtype=torch.float32):
    up = int(cfg.proj_factor * cfg.d_model)
    H = cfg.n_heads
    Dh = up // H
    return (torch.zeros((batch, H, Dh, Dh), device=device, dtype=dtype),
            torch.zeros((batch, H, Dh), device=device, dtype=dtype),
            torch.zeros((batch, H), device=device, dtype=dtype))


def _heads(h, w):
    """einsum("bsu,uhd->bshd") as one matmul over the flattened heads; on a
    mesh, on each rank's shards."""
    if isinstance(w, DTensor):
        return product_on_shards(_heads, h, w)
    u, H, Dh = w.shape
    return (h @ w.reshape(u, H * Dh).to(h.dtype)).reshape(*h.shape[:2], H, Dh)


def mlstm_apply(cfg, p, x, state=None, *, decode: bool = False):
    """x (B,S,d). Returns (out, state); ``decode`` (S = 1) takes the O(1)
    recurrence, otherwise the chunk scan (chunks of min(64, max(8, S))),
    on a mesh on each rank's shards."""
    B, S, d = x.shape
    if decode and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    dt = x.dtype
    h = project(x, p["w_up"])                                   # (B,S,up)
    gate = silu(project(x, p["w_gate"]))
    q, k, v = (_heads(h, p[w]) for w in ("wq", "wk", "wv"))
    if decode:
        q, k, v = f32(q), f32(k), f32(v)
    hf = f32(h)
    logi = reduced(project(hf, p["w_i"])) + f32(p["b_i"])
    f_pre = reduced(project(hf, p["w_f"])) + f32(p["b_f"])
    chunk = None if decode else min(64, max(8, S))

    if isinstance(q, DTensor):
        # the log-sigmoid runs on the shards (DTensor has no rule for its
        # backward)
        y, state = _cell_on_shards(q, k, v, logi, f_pre, state, chunk)
    else:
        y, state = _cell_local(chunk, q, k, v, logi, f_pre, *(
            state or mlstm_init_state(cfg, B, x.device, logi.dtype)))

    y = y.reshape(B, S, -1).to(dt)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * gate
    return project(y, p["w_down"]), state


# ------------------------------------------------------------------- sLSTM

def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    return {
        "w_in": ParamSpec((d, 4, H, Dh), (EMBED, None, HEADS, HEAD_DIM)),
        "r": ParamSpec((H, Dh, 4, Dh), (HEADS, HEAD_DIM, None, None), scale=0.02),
        "b": ParamSpec((4, H, Dh), (None, HEADS, HEAD_DIM), init="zeros"),
        "out_norm": ParamSpec((d,), (EMBED,), init="ones"),
        "w_out": ParamSpec((d, d), (EMBED, EMBED)),
    }


def slstm_init_state(cfg, batch: int, device=None, dtype=torch.float32):
    """(c, n, h, m), each (B, H, Dh) f32 zeros."""
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return tuple(torch.zeros((batch, H, Dh), device=device, dtype=dtype)
                 for _ in range(4))


def _slstm_cell(r, b, x_t, state):
    """x_t (B,4,H,Dh) pre-projected gates; r, b the recurrent weights and
    bias in f32; state (c, n, h, m)."""
    return _slstm_parts(r, b, x_t, state)[0]


def _slstm_parts(r, b, x_t, state):
    """The cell's new state and the intermediates its VJP reads."""
    c, n, h, m = state
    rec = torch.einsum("bhd,hdge->bghe", h, r)
    g = f32(x_t) + rec + b[None]
    zi, ii, fi, oi = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(logf + m - m_new)
    tz = torch.tanh(zi)
    c = f_p * c + i_p * tz
    n = f_p * n + i_p
    o = torch.sigmoid(oi)
    nc = n.clamp_min(1e-6)
    h = o * c / nc
    return (c, n, h, m_new), (fi, logf, ii, i_p, f_p, tz, c, n, o, nc)


def _slstm_cell_vjp(r, b, x_t, state, grads):
    """The cell's VJP: the step recomputed from its entering ``state``,
    then the gradients of (c, n, h, m) out taken back. Returns (the gates'
    gradient in f32 (B,4,H,Dh), the entering state's gradients, r's and
    b's of this step)."""
    c, n, h, m = state
    dc1, dn1, dh1, dm1 = grads
    _, (fi, logf, ii, i_p, f_p, tz, c1, n1, o, nc) = _slstm_parts(
        r, b, x_t, state)
    a = logf + m
    q = c1 / nc                                     # h = o * q
    d_oi = dh1 * q * o * (1 - o)
    dq = dh1 * o
    dc1 = dc1 + dq / nc
    dn1 = dn1 + (-dq * q / nc).masked_fill(n1 < 1e-6, 0.0)
    t_i = (dc1 * tz + dn1) * i_p                    # to ii - m_new
    t_f = (dc1 * c + dn1 * n) * f_p                 # to a - m_new
    d_zi = dc1 * i_p * (1 - tz * tz)
    da, d_im = _max_vjp(a, ii, dm1 - t_i - t_f)
    da = da + t_f
    dg = torch.stack((d_zi, t_i + d_im, da * torch.sigmoid(-fi), d_oi), 1)
    dh = torch.einsum("bghe,hdge->bhd", dg, r).contiguous()   # a carry
    dr = torch.einsum("bhd,bghe->hdge", h, dg)
    return dg, (dc1 * f_p, dn1 * f_p, dh, da), dr, dg.sum(0)


def _slstm_fwd_body(keep, c, n, h, m, x_t, r, b):
    """A step; with ``keep`` its entering state kept."""
    new = _slstm_cell(r, b, x_t, (c, n, h, m))
    return (*new, new[2].clone(), *((c.clone(), n.clone(), h.clone(),
                                     m.clone()) if keep else ()))


def _slstm_bwd_body(dc, dn, dh, dm, dr, db, i, gates, cs, ns, hs, ms, gy,
                    r, b):
    x_t, c, n, h, m, g_t = (_take(t, i) for t in (gates, cs, ns, hs, ms, gy))
    dg, d_state, dr_t, db_t = _slstm_cell_vjp(
        r, b, x_t, (c, n, h, m), (dc, dn, dh + g_t, dm))
    return (*d_state, dr + dr_t, db + db_t, dg.to(gates.dtype))


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM stepped over time as a scan (the reference's ``lax.scan``
    over time): forward the cell from the carried (c, n, h, m), each
    step's entering state kept where a gradient is wanted; backward a scan
    over the steps in reverse of the cell's VJP (``_slstm_cell_vjp``),
    carrying the state's gradients and summing r's and b's."""

    @staticmethod
    def forward(ctx, keep, gates, r, b, c, n, h, m):
        xs = gates.detach().movedim(1, 0)
        r, b = r.detach(), b.detach()
        carry, (hs_out, *prev) = _scan(
            partial(_slstm_fwd_body, keep),
            (c.detach(), n.detach(), h.detach(), m.detach()), (xs,), (r, b))
        if keep:
            ctx.save_for_backward(xs, r, b, *prev)
        return (hs_out.movedim(0, 1).flatten(2), *carry)

    @staticmethod
    def backward(ctx, gy, dc, dn, dh, dm):
        xs, r, b, *prev = ctx.saved_tensors
        S, B, _, H, Dh = xs.shape
        rev = torch.arange(S - 1, -1, -1, device=xs.device)
        gy = gy.unflatten(2, (H, Dh)).movedim(1, 0)
        carry, (dg,) = _scan(
            _slstm_bwd_body, (dc, dn, dh, dm, torch.zeros_like(r),
                              torch.zeros_like(b)), (rev,),
            (xs, *prev, gy, r, b))
        dc, dn, dh, dm, dr, db = carry
        # back in order, batch first (one copy)
        return (None, dg.movedim(0, 1).index_select(1, rev), dr, db, dc, dn,
                dh, dm)


def _gates(x, w):
    """einsum("bsd,dghk->bsghk"), the four gates' pre-activations, as one
    matmul; on a mesh, on each rank's shards."""
    if isinstance(w, DTensor):
        return product_on_shards(_gates, x, w)
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).reshape(
        *x.shape[:2], *w.shape[1:])


def _slstm_steps(decode, gates, r, b, state):
    """The cell stepped over the S positions of gates (B,S,4,H,Dh) from
    ``state`` (``_SLSTMScan``; a ``decode`` step calls the cell once);
    returns (h of every step, its heads flattened (B,S,H*Dh), the last
    state)."""
    if decode:
        state = _slstm_cell(r, b, gates[:, 0], tuple(state))
        return torch.stack([state[2]], dim=1).flatten(2), state
    y, *state = _SLSTMScan.apply(_wants_grad(gates, r, b, *state), gates,
                                 r, b, *state)
    return y, tuple(state)


def _steps_local(decode, gates, r, b, *state):
    """``_slstm_steps`` of one rank's shards from ``state``, or else from
    zeros."""
    B, _, _, H, Dh = gates.shape
    state = state or tuple(gates.new_zeros((B, H, Dh), dtype=r.dtype)
                           for _ in range(4))
    return _slstm_steps(decode, gates, r, b, state)


def _steps_on_shards(gates, r, b, state, decode):
    """``_steps_local`` on each rank's shards: the batch and the heads
    (gates' dimension 3); r and b follow the heads, and their gradients
    are partial sums over the batch shards; a carried (c, n, h, m) goes
    onto the gates' batch and head shards."""
    mesh = gates.device_mesh
    g_pl = _head_shards(gates, 3)
    heads = [a == Shard(3) for a in g_pl]
    r_pl = [Shard(0) if h else Replicate() for h in heads]
    b_pl = [Shard(1) if h else Replicate() for h in heads]
    grad = [Partial() if a == Shard(0) else Replicate() for a in g_pl]
    r_grad = [p if h else g for h, p, g in zip(heads, r_pl, grad)]
    b_grad = [p if h else g for h, p, g in zip(heads, b_pl, grad)]
    y_pl = [Shard(2) if h else a for h, a in zip(heads, g_pl)]
    st = [Shard(1) if h else a for h, a in zip(heads, g_pl)]
    state = () if state is None else tuple(state)
    carried = (st,) * len(state)
    fn = local_map(partial(_steps_local, decode),
                   out_placements=(y_pl,) + (st,) * 4,
                   in_placements=(g_pl, r_pl, b_pl) + carried,
                   in_grad_placements=(g_pl, r_grad, b_grad) + carried,
                   device_mesh=mesh)
    return fn(gates.redistribute(mesh, g_pl), r.redistribute(mesh, r_pl),
              b.redistribute(mesh, b_pl),
              *(t.redistribute(mesh, st) for t in state))


def slstm_apply(cfg, p, x, state=None, *, decode: bool = False):
    """x (B,S,d). Returns (out, state): the cell stepped over the S
    positions one by one (one step when ``decode``); on a mesh on each
    rank's shards."""
    B, S, d = x.shape
    if decode and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    dt = x.dtype
    gates = _gates(x, p["w_in"])
    r, b = f32(p["r"]), f32(p["b"])
    if isinstance(gates, DTensor):
        y, state = _steps_on_shards(gates, r, b, state, decode)
    else:
        if state is None:
            state = slstm_init_state(cfg, B, x.device, r.dtype)
        y, state = _slstm_steps(decode, gates, r, b, state)
    y = y.reshape(B, S, d).to(dt)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return project(y, p["w_out"]), state
