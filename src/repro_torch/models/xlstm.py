"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential), the port of ``repro.models.xlstm``.

mLSTM runs in the chunkwise form: within a chunk the stabilized parallel
(attention-like) form; across chunks a carried (C, n, m) matrix state, so
the work is O(S·L) and the decode step is the O(1) recurrence. The
reference's ``lax.scan`` over chunks is a Python loop over them here.

Stabilization follows the paper: log-gates with a running max ``m``;
normalizer ``max(|n^T q|, exp(-m))``.

sLSTM keeps per-head scalar memories with block-diagonal recurrent weights
and exponential gating; it is sequential by nature, so it steps over time
in a Python loop (the reference's ``lax.scan`` over time).

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
    """q/k/v: (B,S,H,Dh) f32; logi/logf: (B,S,H) f32;
    state: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)).
    Returns (y (B,S,H,Dh), new_state). The sequence is padded to whole
    chunks (input gate LOG_EPS, forget gate 0: the padding adds nothing)."""
    B, S, H, Dh = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=LOG_EPS)
        logf = F.pad(logf, (0, 0, 0, pad))
    scale = _f32_scale(Dh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    C, n, m = state
    ys = []
    for c0 in range(0, q.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        qt, kt, vt, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], logf[:, sl]
        cs = torch.cumsum(lf, dim=1)                            # (B,L,H)
        # intra-chunk log decay matrix
        logD = (cs[:, :, None, :] - cs[:, None, :, :]) + li[:, None, :, :]
        logD = torch.where(tri, logD, -math.inf)
        m_intra = logD.amax(dim=2)                              # (B,L,H)
        b_inter = cs + m[:, None, :]                            # (B,L,H)
        m_new = torch.maximum(m_intra, b_inter).clamp_min(-1e30)
        D = torch.exp(logD - m_new[:, :, None, :])              # (B,L,L,H)
        Sm = torch.einsum("blhd,bthd->blth", qt, kt) * scale * D
        y_num = torch.einsum("blth,bthd->blhd", Sm, vt)
        norm = Sm.sum(dim=2)                                    # (B,L,H)
        w_inter = torch.exp(b_inter - m_new)                    # (B,L,H)
        qs = qt * scale
        y_num = y_num + w_inter[..., None] * torch.einsum(
            "blhd,bhde->blhe", qs, C)
        norm = norm + w_inter * torch.einsum("blhd,bhd->blh", qs, n)
        denom = torch.maximum(norm.abs(), torch.exp(-m_new))
        ys.append(y_num / denom[..., None].clamp_min(1e-30))

        # carry update
        total = cs[:, -1, :]                                    # (B,H)
        dec_t = total[:, None, :] - cs + li                     # (B,L,H)
        m_next = torch.maximum(total + m, dec_t.amax(dim=1))
        wC = torch.exp(dec_t - m_next[:, None, :])              # (B,L,H)
        decay = torch.exp(total + m - m_next)
        C = decay[:, :, None, None] * C + torch.einsum(
            "blh,blhd,blhe->bhde", wC, kt, vt)
        n = decay[:, :, None] * n + torch.einsum("blh,blhd->bhd", wC, kt)
        m = m_next
    return torch.cat(ys, dim=1)[:, :S], (C, n, m)


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
    state = state or (q.new_zeros((B, H, Dh, Dh)), q.new_zeros((B, H, Dh)),
                      q.new_zeros((B, H)))
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
    q, k, v = (f32(_heads(h, p[w])) for w in ("wq", "wk", "wv"))
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
            state or mlstm_init_state(cfg, B, x.device, q.dtype)))

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
    c, n, h, m = state
    rec = torch.einsum("bhd,hdge->bghe", h, r)
    g = f32(x_t) + rec + b[None]
    zi, ii, fi, oi = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * torch.tanh(zi)
    n = f_p * n + i_p
    h = torch.sigmoid(oi) * c / n.clamp_min(1e-6)
    return (c, n, h, m_new)


def _gates(x, w):
    """einsum("bsd,dghk->bsghk"), the four gates' pre-activations, as one
    matmul; on a mesh, on each rank's shards."""
    if isinstance(w, DTensor):
        return product_on_shards(_gates, x, w)
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).reshape(
        *x.shape[:2], *w.shape[1:])


def _slstm_steps(gates, r, b, state):
    """The cell stepped over the S positions of gates (B,S,4,H,Dh) from
    ``state``; returns (h of every step, its heads flattened (B,S,H*Dh),
    the last state)."""
    hs = []
    for t in range(gates.shape[1]):
        state = _slstm_cell(r, b, gates[:, t], state)
        hs.append(state[2])
    return torch.stack(hs, dim=1).flatten(2), state


def _steps_local(gates, r, b, *state):
    """``_slstm_steps`` of one rank's shards from ``state``, or else from
    zeros."""
    B, _, _, H, Dh = gates.shape
    state = state or tuple(gates.new_zeros((B, H, Dh), dtype=r.dtype)
                           for _ in range(4))
    return _slstm_steps(gates, r, b, state)


def _steps_on_shards(gates, r, b, state):
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
    fn = local_map(_steps_local, out_placements=(y_pl,) + (st,) * 4,
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
        y, state = _steps_on_shards(gates, r, b, state)
    else:
        if state is None:
            state = slstm_init_state(cfg, B, x.device, r.dtype)
        y, state = _slstm_steps(gates, r, b, state)
    y = y.reshape(B, S, d).to(dt)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return project(y, p["w_out"]), state
