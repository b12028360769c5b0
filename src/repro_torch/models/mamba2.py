"""Mamba2 block (SSD): gated selective state space with conv1d frontend (the
port of ``repro.models.mamba2``).

Layout follows the Mamba2 paper: in_proj emits (z, x, B, C, dt); a causal
depthwise conv1d(width=ssm_conv) over the (x, B, C) channels; the SSD
recurrence h_t = exp(dt*A) h_{t-1} + dt*B_t x_t with per-head scalar A; gated
output norm and out_proj.

Sequence mixing outside decode, as in the reference:
  * ``cfg.use_pallas``: ``kernels.mamba.ssd_scan``, which on a CUDA tensor
    is the hand-written Hopper kernel (``csrc/ssd.cu``);
  * otherwise the plain chunked SSD (``kernels.mamba.ref.ssd_chunked``).
Decode is the O(1) recurrence against (conv_state, ssm_state) caches, in
plain torch (the reference has no kernel there).
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.mamba import ops
from ..kernels.mamba.ref import ssd_chunked
from ..sharding.context import constrain, project
from .common import CONV, EMBED, HEADS, INNER, ParamSpec, rms_norm, silu, softplus


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.n_ssm_heads
    W = cfg.ssm_conv
    conv_ch = di + 2 * N
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * N + H), (EMBED, INNER)),
        "conv_w": ParamSpec((W, conv_ch), (CONV, INNER), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), (INNER,), init="zeros"),
        "a_log": ParamSpec((H,), (HEADS,), init="zeros"),       # A = -exp(a_log)
        "dt_bias": ParamSpec((H,), (HEADS,), init="zeros"),
        "d_skip": ParamSpec((H,), (HEADS,), init="ones"),
        "out_norm": ParamSpec((di,), (INNER,), init="ones"),
        "out_proj": ParamSpec((di, d), (INNER, EMBED)),
    }


def _split_proj(cfg, proj):
    di, N = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    return z, xbc, dt


def _causal_conv(p, xbc, conv_state=None):
    """Depthwise causal conv over time. xbc (B, S, C).
    With conv_state (B, W-1, C) supplied, runs the streaming update. Returns
    (out, new_state): the last W-1 inputs, the next call's state."""
    W = p["conv_w"].shape[0]
    dt = xbc.dtype
    if conv_state is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (W - 1,) + xbc.shape[2:])
    else:
        pad = conv_state.to(dt)
    full = torch.cat([pad, xbc], dim=1)                         # (B, S+W-1, C)
    S = xbc.shape[1]
    out = sum(full[:, i:i + S] * p["conv_w"][i].to(dt) for i in range(W))
    out = silu(out + p["conv_b"].to(dt))
    new_state = full[:, -(W - 1):] if W > 1 else torch.zeros_like(pad)
    return out, new_state


def mamba_mix(cfg, p, u, ssm_state=None, conv_state=None, *, decode=False):
    """u: (B, S, d). Returns (out, (conv_state, ssm_state))."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    dtp = u.dtype
    proj = project(u, p["in_proj"])                             # (B,S,2di+2N+H)
    proj = constrain(proj, ("act_batch", "act_seq", "act_inner"))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(p, xbc, conv_state if decode else None)
    x = xbc[..., :di]
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())                          # (H,)
    alog = dt * A                                                # (B,S,H)
    Bsz, S = x.shape[:2]
    xh = x.reshape(Bsz, S, H, P)
    # dt scales the input (discretization): x_t <- dt_t * x_t
    xin = xh * dt[..., None].to(dtp)

    if decode:
        if S != 1:
            raise ValueError(f"decode takes one token per call, got {S}")
        h0 = ssm_state.float()                                  # (B,H,N,P)
        a = torch.exp(alog[:, 0])                               # (B,H)
        h = a[:, :, None, None] * h0 + torch.einsum(
            "bn,bhp->bhnp", Bm[:, 0].float(), xin[:, 0].float())
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
        y = y[:, None].to(dtp)                                  # (B,1,H,P)
        new_ssm = h
    else:
        scan = _ssd if ssm_state is None else partial(_ssd, h0=ssm_state)
        args = (cfg, xin, alog, Bm, Cm)
        if isinstance(xin, DTensor):
            scan, args = _ssd_on_shards(scan, *args)
        y, new_ssm = scan(*args)

    y = y + xh * p["d_skip"].to(dtp)[None, None, :, None]
    y = y.reshape(Bsz, S, di)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * silu(z)
    out = project(y, p["out_proj"])
    out = constrain(out, ("act_batch", "act_seq", "act_embed"))
    return out, (new_conv, new_ssm)


def _ssd(cfg, xin, alog, Bm, Cm, h0=None):
    """The SSD scan: kernel B3 (``ops.ssd_scan``) under ``cfg.use_pallas``,
    else the plain chunked SSD."""
    if cfg.use_pallas:
        return ops.ssd_scan(xin, alog, Bm, Cm, h0=h0)
    return ssd_chunked(xin, alog, Bm, Cm, h0=h0, chunk=min(128, xin.shape[1]))


def _ssd_on_shards(scan, cfg, xin, alog, Bm, Cm):
    """(``scan`` as a ``local_map`` over the mesh, its DTensor arguments):
    each rank scans its shards, no DTensor reaching the kernel. The shards
    keep xin's batch sharding and its head sharding (the recurrence is per
    head); anything else is gathered first. B and C are shared by the
    heads, so they are gathered over a head-sharded mesh dimension, and
    their gradients there are partial sums, one per rank's heads."""
    mesh = xin.device_mesh
    x_pl = [a if a in (Shard(0), Shard(2)) else Replicate()
            for a in xin.placements]
    bc_pl = [a if a == Shard(0) else Replicate() for a in x_pl]
    bc_grad = [Partial() if a == Shard(2) else b for a, b in zip(x_pl, bc_pl)]
    h_pl = [Shard(1) if a == Shard(2) else a for a in x_pl]
    xin = xin.redistribute(mesh, x_pl)
    alog = alog.redistribute(mesh, x_pl)
    Bm, Cm = (t.redistribute(mesh, bc_pl) for t in (Bm, Cm))
    fn = local_map(partial(scan, cfg), out_placements=(x_pl, h_pl),
                   in_placements=(x_pl, x_pl, bc_pl, bc_pl),
                   in_grad_placements=(x_pl, x_pl, bc_grad, bc_grad),
                   device_mesh=mesh)
    return fn, (xin, alog, Bm, Cm)


def mamba_cache_shapes(cfg, batch: int):
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv
    return dict(conv=(batch, W - 1, di + 2 * N), ssm=(batch, H, N, P))
