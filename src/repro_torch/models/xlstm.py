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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import EMBED, HEAD_DIM, HEADS, INNER, ParamSpec, rms_norm, silu

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


def mlstm_init_state(cfg, batch: int, device=None):
    up = int(cfg.proj_factor * cfg.d_model)
    H = cfg.n_heads
    Dh = up // H
    return (torch.zeros((batch, H, Dh, Dh), device=device),
            torch.zeros((batch, H, Dh), device=device),
            torch.zeros((batch, H), device=device))


def _heads(h, w):
    """einsum("bsu,uhd->bshd") as one matmul over the flattened heads."""
    u, H, Dh = w.shape
    return (h @ w.reshape(u, H * Dh).to(h.dtype)).reshape(*h.shape[:2], H, Dh)


def mlstm_apply(cfg, p, x, state=None, *, decode: bool = False):
    """x (B,S,d). Returns (out, state); ``decode`` (S = 1) takes the O(1)
    recurrence, otherwise the chunk scan (chunks of min(64, max(8, S)))."""
    B, S, d = x.shape
    dt = x.dtype
    h = x @ p["w_up"].to(dt)                                    # (B,S,up)
    gate = silu(x @ p["w_gate"].to(dt))
    q, k, v = (_heads(h, p[w]).float() for w in ("wq", "wk", "wv"))
    hf = h.float()
    logi = hf @ p["w_i"].float() + p["b_i"].float()
    logf = F.logsigmoid(hf @ p["w_f"].float() + p["b_f"].float())

    if state is None:
        state = mlstm_init_state(cfg, B, x.device)

    if decode:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        C, n, m = state
        scale = _f32_scale(q.shape[-1])
        li, lf = logi[:, 0], logf[:, 0]                         # (B,H)
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
        y = (num / den[..., None].clamp_min(1e-30))[:, None]   # (B,1,H,Dh)
        state = (C, n, m_new)
    else:
        y, state = mlstm_chunk_scan(q, k, v, logi, logf, state,
                                    chunk=min(64, max(8, S)))

    y = y.reshape(B, S, -1).to(dt)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * gate
    return y @ p["w_down"].to(dt), state


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


def slstm_init_state(cfg, batch: int, device=None):
    """(c, n, h, m), each (B, H, Dh) f32 zeros."""
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return tuple(torch.zeros((batch, H, Dh), device=device) for _ in range(4))


def _slstm_cell(r, b, x_t, state):
    """x_t (B,4,H,Dh) pre-projected gates; r, b the recurrent weights and
    bias in f32; state (c, n, h, m)."""
    c, n, h, m = state
    rec = torch.einsum("bhd,hdge->bghe", h, r)
    g = x_t.float() + rec + b[None]
    zi, ii, fi, oi = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * torch.tanh(zi)
    n = f_p * n + i_p
    h = torch.sigmoid(oi) * c / n.clamp_min(1e-6)
    return (c, n, h, m_new)


def slstm_apply(cfg, p, x, state=None, *, decode: bool = False):
    """x (B,S,d). Returns (out, state): the cell stepped over the S
    positions one by one (one step when ``decode``)."""
    B, S, d = x.shape
    dt = x.dtype
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    w = p["w_in"]
    gates = (x @ w.reshape(d, -1).to(dt)).reshape(B, S, *w.shape[1:])
    r, b = p["r"].float(), p["b"].float()
    if decode and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    hs = []
    for t in range(S):
        state = _slstm_cell(r, b, gates[:, t], state)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(dt)      # (B,S,H,Dh)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"].to(dt), state
