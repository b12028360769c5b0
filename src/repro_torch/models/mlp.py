"""Gated (SwiGLU) and plain-GELU MLPs (the port of ``repro.models.mlp``)."""
from __future__ import annotations

from ..sharding.context import constrain, project
from .common import EMBED, MLP, ParamSpec, gelu, silu


def swiglu_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), (EMBED, MLP)),
        "wi_up": ParamSpec((d, f), (EMBED, MLP)),
        "wo": ParamSpec((f, d), (MLP, EMBED)),
    }


def swiglu(p, x):
    h = silu(project(x, p["wi_gate"])) * project(x, p["wi_up"])
    h = constrain(h, ("act_batch", "act_seq", "act_mlp"))
    return project(h, p["wo"])


def gelu_mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec((d, f), (EMBED, MLP)),
        "bi": ParamSpec((f,), (MLP,), init="zeros"),
        "wo": ParamSpec((f, d), (MLP, EMBED)),
        "bo": ParamSpec((d,), (EMBED,), init="zeros"),
    }


def gelu_mlp(p, x):
    dt = x.dtype
    h = gelu(project(x, p["wi"]) + p["bi"].to(dt))
    h = constrain(h, ("act_batch", "act_seq", "act_mlp"))
    return project(h, p["wo"]) + p["bo"].to(dt)
