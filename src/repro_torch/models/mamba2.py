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

On a mesh the mixer runs on each rank's shards up to its gated norm
(``_mix_on_shards``, a ``local_map``): the sequence whole (the conv and the
recurrence run along it), the batch as the rules shard it, and the inner
dimension by whole heads where the rules shard ``act_inner``. Each rank
gathers the (small) in-projection and conv weights, takes its own column
ranges of them (its heads' z, x and dt, and B and C whole, shared by every
head) and scans its own heads; so no rank holds another rank's slice of
the inner dimension (fault F11). The weights' gradients are partial sums
over the ranks' rows and heads, reduce-scattered to the parameters' own
placements in the backward of their gathers. The norm's sum over the inner
dimension and the out-projection's partial sum are DTensor's.

Where no gradient is taken (serving) and it moves fewer bytes, the
in-projection keeps its shard instead: ``project`` makes the projection
on its shards (its columns sharded as the weight's) and the projection,
gathered over its columns, goes to the mixer in place of u and the
weight, as GSPMD moves the reference's activations there; a decode step
projects one token a row, and the weight is (d_model, 2 d_inner + ...).
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.mamba import ops
from ..kernels.mamba.ref import ssd_chunked
from ..sharding.context import (constrain, current_ctx, gather_bytes,
                                local_bytes, moves_activation, project,
                                takes_grad)
from ..sharding.rules import placements, spec_for_axes
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


def _split_proj(di: int, N: int, proj):
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
    """u: (B, S, d). Returns (out, (conv_state, ssm_state)); on a mesh the
    conv state only where no gradient is taken (serving)."""
    if isinstance(u, DTensor):
        y, z, new_conv, new_ssm = _mix_on_shards(cfg, p, u, ssm_state,
                                                 conv_state, decode)
    else:
        y, z, new_conv, new_ssm = _mix(cfg, p, u, ssm_state, conv_state,
                                       decode)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * silu(z)
    out = project(y, p["out_proj"])
    out = constrain(out, ("act_batch", "act_seq", "act_embed"))
    return out, (new_conv, new_ssm)


def _mix(cfg, p, u, ssm_state=None, conv_state=None, decode=False,
         proj=None):
    """The mixer of plain tensors up to its gated norm: (y (B, S, di) with
    the skip added, z, the conv state, the SSM state). The head count, and
    with it di, is ``a_log``'s length: on a mesh, a rank's own heads, with
    ``in_proj``, ``conv_w`` and ``conv_b`` their columns in the same
    layout. ``proj``, where given, is ``u``'s in-projection in that layout
    (u and ``in_proj`` are then not read)."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = p["a_log"].shape[0]
    di = H * P
    if proj is None:
        proj = u @ p["in_proj"].to(u.dtype)                     # (B,S,2di+2N+H)
    dtp = proj.dtype
    z, xbc, dt_raw = _split_proj(di, N, proj)
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
        y, new_ssm = _ssd(cfg, xin, alog, Bm, Cm, h0=ssm_state)

    y = y + xh * p["d_skip"].to(dtp)[None, None, :, None]
    return y.reshape(Bsz, S, di), z, new_conv, new_ssm


def _ssd(cfg, xin, alog, Bm, Cm, h0=None):
    """The SSD scan: kernel B3 (``ops.ssd_scan``) under ``cfg.use_pallas``,
    else the plain chunked SSD."""
    if cfg.use_pallas:
        return ops.ssd_scan(xin, alog, Bm, Cm, h0=h0)
    return ssd_chunked(xin, alog, Bm, Cm, h0=h0, chunk=min(128, xin.shape[1]))


def _columns(cfg, H: int, h0: int, h: int, device) -> tuple:
    """(in_proj's columns, conv's channels) of heads h0 ... h0 + h - 1 of
    H, in the layout ``_mix`` reads: z, x and dt of those heads, B and C
    whole; None where they are every head."""
    if h == H:
        return None, None
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    di = H * P
    x = torch.arange(h0 * P, (h0 + h) * P, device=device)
    bc = torch.arange(di, di + 2 * N, device=device)
    conv = torch.cat([x, bc])
    cols = torch.cat([x, di + conv, 2 * di + 2 * N + h0
                      + torch.arange(h, device=device)])
    return cols, conv


def _mix_local(cfg, H: int, h0: int, decode: bool, u, in_proj, conv_w,
               conv_b, a_log, dt_bias, d_skip, ssm_state=None,
               conv_state=None):
    """``_mix`` on one rank's local tensors: heads h0 ... of H (the length
    of its ``a_log``) against the gathered in-projection and conv weights
    and the gathered conv state (``in_proj`` None: u is its projection,
    every column); returns (y, z, the conv state's x
    channels and its B and C channels, the SSM state)."""
    cols, conv = _columns(cfg, H, h0, a_log.shape[0], u.device)
    p = {"in_proj": in_proj, "conv_w": conv_w, "conv_b": conv_b,
         "a_log": a_log, "dt_bias": dt_bias, "d_skip": d_skip}
    proj = u if in_proj is None else None       # u is the projection
    if cols is not None:
        if proj is None:
            p["in_proj"] = in_proj.index_select(1, cols)
        else:
            proj = proj.index_select(-1, cols)
        p.update(conv_w=conv_w.index_select(1, conv),
                 conv_b=conv_b.index_select(0, conv))
        if conv_state is not None:
            conv_state = conv_state.index_select(2, conv)
    y, z, new_conv, new_ssm = _mix(cfg, p, u, ssm_state, conv_state, decode,
                                   proj=proj)
    di = y.shape[-1]
    return y, z, new_conv[..., :di], new_conv[..., di:], new_ssm


def _mix_on_shards(cfg, p, u, ssm_state, conv_state, decode):
    """``_mix`` of the DTensor u on each rank's shards (``local_map``; the
    module docstring says how they are cut). Returns y and z (B, S, di)
    sharded by heads, the conv state (gathered over the heads; None where
    u takes a gradient: training reads no cache) and the SSM state
    (B, H, N, P) sharded by heads."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = u.device_mesh
    ctx = current_ctx()
    Bsz, S = u.shape[:2]
    H = cfg.n_ssm_heads
    if ctx is None:
        pl = [a if a == Shard(0) else Replicate() for a in u.placements]
    else:
        pl = list(placements(spec_for_axes(("act_batch", None, "act_inner"),
                                           ctx[1], mesh, (Bsz, S, H)), mesh))
    rows = [a if a == Shard(0) else Replicate() for a in pl]
    heads = [Shard(0) if a == Shard(2) else Replicate() for a in pl]
    state = [a if a == Shard(0) else Shard(1) if a == Shard(2)
             else Replicate() for a in pl]
    summed = [Partial() if isinstance(a, Shard) else Replicate() for a in pl]
    u_grad = [a if a == Shard(0) else Partial() if a == Shard(2)
              else Replicate() for a in pl]
    head_grad = [Partial() if a == Shard(0) else b
                 for a, b in zip(pl, heads)]
    whole = [Replicate()] * mesh.ndim
    _, offset = compute_local_shape_and_global_offset((Bsz, S, H), mesh, pl)
    dtp = u.dtype
    in_proj = p["in_proj"].to(dtp)
    if _projects_first(u, in_proj, rows):
        first = [project(u, in_proj).redistribute(mesh, rows), None]
    else:
        first = [u.redistribute(mesh, rows),
                 in_proj.redistribute(mesh, whole)]
    args = [*first,
            p["conv_w"].to(dtp).redistribute(mesh, whole),
            p["conv_b"].to(dtp).redistribute(mesh, whole),
            *(p[k].redistribute(mesh, heads)
              for k in ("a_log", "dt_bias", "d_skip"))]
    w_pl = None if first[1] is None else whole
    in_pl = [rows, w_pl, whole, whole, heads, heads, heads]
    grad_pl = [u_grad, w_pl and summed, summed, summed] + [head_grad] * 3
    for t, t_pl in ((ssm_state, state), (conv_state, rows)):
        t_pl = None if t is None else t_pl
        args.append(None if t is None else t.redistribute(mesh, t_pl))
        in_pl.append(t_pl)
        grad_pl.append(t_pl)
    fn = local_map(partial(_mix_local, cfg, H, offset[2], decode),
                   out_placements=(pl, pl, pl, rows, state),
                   in_placements=tuple(in_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=mesh)
    y, z, conv_x, conv_bc, new_ssm = fn(*args)
    new_conv = None
    if not u.requires_grad:
        new_conv = torch.cat([conv_x.redistribute(mesh, rows), conv_bc], -1)
    return y, z, new_conv, new_ssm


def _projects_first(u, in_proj, rows) -> bool:
    """Whether the mixer of a serving step takes u's in-projection made on
    the weight's shards (``project``) and gathered over its columns to
    ``rows``, because that moves fewer bytes than gathering the weight
    whole (``moves_activation``; the move costed at no more than the
    projection's and u's shards on ``rows``); a step that takes a gradient
    never does."""
    if takes_grad(u, in_proj):
        return False
    mesh = u.device_mesh
    isz = u.element_size()
    gather = gather_bytes(in_proj.shape, in_proj.placements, mesh, isz)
    shape = (*u.shape[:-1], in_proj.shape[1])
    moved = local_bytes(shape, rows, mesh, isz) + local_bytes(
        u.shape, rows, mesh, isz)
    return moves_activation(moved, gather)


def mamba_cache_shapes(cfg, batch: int):
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv
    return dict(conv=(batch, W - 1, di + 2 * N), ssm=(batch, H, N, P))
