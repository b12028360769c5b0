"""xLSTM language model (the port of ``repro.models.xlstm_lm``): groups of
``slstm_every - 1`` mLSTM layers followed by one sLSTM layer.

Parameters are stacked as in the reference, (G, M, ...) for the mLSTM
layers and (G, ...) for the sLSTM ones; the reference's nested scans are
two Python loops here. Under ``cfg.remat`` training checkpoints each group,
and each mLSTM layer again inside it, as the reference nests its
``jax.checkpoint``s. Prefill returns the recurrent states and decode
updates them IN PLACE: their size does not depend on the sequence length
(O(1) decode).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..sharding.context import constrain, embedding_rows
from .common import (BATCH, EMBED, VOCAB, ParamSpec, cross_entropy_loss,
                     remat, rms_norm, stack_specs, unstack)
from .xlstm import mlstm_apply, mlstm_specs, slstm_apply, slstm_specs


def _mlstm_layer_specs(cfg):
    return {"ln": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
            "cell": mlstm_specs(cfg)}


def _slstm_layer_specs(cfg):
    return {"ln": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
            "cell": slstm_specs(cfg)}


def xlstm_specs(cfg) -> dict:
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {cfg.slstm_every}")
    G = cfg.n_layers // cfg.slstm_every
    M = cfg.slstm_every - 1                      # mLSTM layers per group
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (VOCAB, EMBED),
                           init="embed", scale=0.02),
        "mlstm": stack_specs(stack_specs(_mlstm_layer_specs(cfg), M), G),
        "slstm": stack_specs(_slstm_layer_specs(cfg), G),
        "ln_f": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), (EMBED, VOCAB)),
    }


def _m_train(cfg, lp, x):
    out, _ = mlstm_apply(cfg, lp["cell"], rms_norm(x, lp["ln"], cfg.norm_eps))
    return x + out


def _train_group(cfg, m_layers, sp, x):
    for lp in m_layers:
        x = remat(cfg.remat, _m_train, cfg, lp, x)
    out, _ = slstm_apply(cfg, sp["cell"], rms_norm(x, sp["ln"], cfg.norm_eps))
    return x + out


def _write(dst: tuple, src: tuple) -> None:
    """Copy each state of ``src`` into the cache slice of ``dst`` in place;
    on a mesh each takes its slice's placements first."""
    for d, s in zip(dst, src):
        if isinstance(s, DTensor):
            s = s.redistribute(s.device_mesh, d.placements)
        d.copy_(s)


def _forward(cfg, params, x, mode, states=None):
    """Training returns (x, None). Prefill returns (x, fresh states
    {"m": (C, n, m) each (G, M, B, ...), "s": (c, n, h, m) each (G, B,
    ...)}); decode updates ``states`` in place and returns them."""
    groups = [unstack(g) for g in unstack(params["mlstm"])]
    slstms = unstack(params["slstm"])
    if mode == "train":
        for m_layers, sp in zip(groups, slstms):
            x = remat(cfg.remat, _train_group, cfg, m_layers, sp, x)
        return x, None
    decode = mode == "decode"
    m_out, s_out = [], []
    for g, (m_layers, sp) in enumerate(zip(groups, slstms)):
        for e, lp in enumerate(m_layers):
            st = tuple(a[g, e] for a in states["m"]) if decode else None
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            out, new = mlstm_apply(cfg, lp["cell"], h, state=st, decode=decode)
            x = x + out
            if decode:
                _write(st, new)
            else:
                m_out.append(new)
        st = tuple(a[g] for a in states["s"]) if decode else None
        h = rms_norm(x, sp["ln"], cfg.norm_eps)
        out, new = slstm_apply(cfg, sp["cell"], h, state=st, decode=decode)
        x = x + out
        if decode:
            _write(st, new)
        else:
            s_out.append(new)
    if decode:
        return x, states
    G, M = len(groups), len(groups[0])
    return x, {"m": tuple(torch.stack(parts).unflatten(0, (G, M))
                          for parts in zip(*m_out)),
               "s": tuple(torch.stack(parts) for parts in zip(*s_out))}


def _embed(cfg, params, tokens):
    x = embedding_rows(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    return constrain(x, ("act_batch", "act_seq", "act_embed"))


def xlstm_loss(cfg, params, batch_dict):
    x, _ = _forward(cfg, params, _embed(cfg, params, batch_dict["tokens"]),
                    "train")
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return cross_entropy_loss(logits, batch_dict["labels"]), {}


def xlstm_prefill(cfg, params, batch_dict):
    """Logits of the last position (B, 1, V) and the prompt's states."""
    x, states = _forward(cfg, params,
                         _embed(cfg, params, batch_dict["tokens"]), "prefill")
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), states


def xlstm_decode(cfg, params, batch_dict, states):
    """One token per row; updates ``states`` in place (``pos`` is not
    needed: the states carry the history)."""
    x, states = _forward(cfg, params,
                         _embed(cfg, params, batch_dict["tokens"]), "decode",
                         states=states)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), states


def xlstm_cache_spec(cfg, batch: int, max_len: int):
    """State caches (independent of the sequence length: O(1) decode), as
    ({"m": 3 x (shape, dtype), "s": 4 x (shape, dtype)}, their axes)."""
    G = cfg.n_layers // cfg.slstm_every
    M = cfg.slstm_every - 1
    up = int(cfg.proj_factor * cfg.d_model)
    H = cfg.n_heads
    Dh_m = up // H
    Dh_s = cfg.d_model // H
    f32 = torch.float32
    shapes = {
        "m": (((G, M, batch, H, Dh_m, Dh_m), f32),
              ((G, M, batch, H, Dh_m), f32),
              ((G, M, batch, H), f32)),
        "s": tuple(((G, batch, H, Dh_s), f32) for _ in range(4)),
    }
    ax_m = (("layers", "layers", BATCH, "heads", None, None),
            ("layers", "layers", BATCH, "heads", None),
            ("layers", "layers", BATCH, "heads"))
    ax_s = tuple(("layers", BATCH, "heads", None) for _ in range(4))
    return shapes, {"m": ax_m, "s": ax_s}
