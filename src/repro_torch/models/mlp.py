"""Gated (SwiGLU) MLP (the port of ``repro.models.mlp``; the plain-GELU MLP
comes with the families that use it)."""
from __future__ import annotations

from .common import EMBED, MLP, ParamSpec, silu


def swiglu_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), (EMBED, MLP)),
        "wi_up": ParamSpec((d, f), (EMBED, MLP)),
        "wo": ParamSpec((f, d), (MLP, EMBED)),
    }


def swiglu(p, x):
    dt = x.dtype
    h = silu(x @ p["wi_gate"].to(dt)) * (x @ p["wi_up"].to(dt))
    return h @ p["wo"].to(dt)
