"""Decoder-only LM: the dense (llama/mistral/qwen-style), MoE and VLM
variants (the port of ``repro.models.lm``).

One block = pre-RMSNorm GQA attention + pre-RMSNorm SwiGLU MLP (or MoE).
Layers are stored stacked (a leading ``layers`` axis) as in the reference;
the reference's scan over them is a loop over their ``unstack`` slices
here, each slice cast to the activation dtype once per layer
(``_cast_block``). The reference's sharding constraints are ``constrain``
calls at the same sites (no-ops off a mesh); its optimization barriers only
steer XLA and have no counterpart.

Training (``lm_loss``) runs each attention through kernel B2 under
``cfg.use_pallas``; serving keeps the reference's plain attention. Under
``cfg.remat`` training checkpoints each layer (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``), and with ``cfg.remat_groups = G``
(``n_layers % G == 0``, ``G < n_layers``) each group of ``n_layers / G``
layers is checkpointed with each layer checkpointed again inside it, as the
reference nests its checkpoints: in the backward pass each layer's own
checkpoint runs it once more, and the group's recomputation runs every
layer of the group but its last (torch's non-reentrant checkpoint stops
recomputing once it holds every tensor the backward needs).

The VLM variant (qwen2-vl) prepends projected patch embeddings (the vision
tower is a stub: ``make_batch`` supplies the patches), drives attention
with M-RoPE 3-channel position ids and takes the loss on text positions
only.
"""
from __future__ import annotations

import math

import torch

from ..sharding.context import (constrain, constrain_tree, current_ctx,
                                embedding_rows)
from .attention import (attend_decode, attend_prefill, attend_train,
                        attn_specs, kv_cache_shape)
from .common import (BATCH, EMBED, HEAD_DIM, KV_HEADS, VOCAB, ParamSpec,
                     cross_entropy_loss, gelu, logical_axes, mrope_cos_sin,
                     remat, rms_norm, rope_cos_sin, stack_specs, tree_map,
                     unstack)
from .mlp import swiglu, swiglu_specs
from .moe import moe_apply, moe_specs


def block_specs(cfg) -> dict:
    d = cfg.d_model
    s = {
        "ln1": ParamSpec((d,), (EMBED,), init="ones"),
        "attn": attn_specs(cfg),
        "ln2": ParamSpec((d,), (EMBED,), init="ones"),
    }
    if cfg.n_experts:
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = swiglu_specs(cfg)
    return s


def lm_specs(cfg) -> dict:
    d, V = cfg.d_model, cfg.vocab
    s = {
        "embed": ParamSpec((V, d), (VOCAB, EMBED), init="embed", scale=0.02),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "ln_f": ParamSpec((d,), (EMBED,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, V), (EMBED, VOCAB))
    if cfg.family == "vlm":
        s["patch_proj"] = {
            "w1": ParamSpec((cfg.patch_dim, d), (None, EMBED)),
            "w2": ParamSpec((d, d), (EMBED, EMBED)),
        }
    return s


def _cast_block(cfg, layer):
    """A layer's f32 master weights in the activation dtype, cast once per
    layer (the reference's ``cast_block``). On a mesh the slices are first
    pinned to their parameter placements (``constrain_tree``), so the cast
    runs on the shards."""
    dt = getattr(torch, cfg.dtype)
    if current_ctx() is not None:
        layer = constrain_tree(layer, logical_axes(block_specs(cfg)))
    return tree_map(lambda _, a: a.to(dt) if a.is_floating_point() else a,
                    layer)


def _block_apply(cfg, p, x, cos, sin, mode, cache=None, pos=None):
    """One block on x (B,S,d); returns (x, the layer's (k, v), aux)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = None
    if mode == "train":
        a = attend_train(cfg, p["attn"], h, cos, sin)
    elif mode == "prefill":
        a, new_cache = attend_prefill(cfg, p["attn"], h, cos, sin)
    elif mode == "decode":
        a, new_cache = attend_decode(cfg, p["attn"], h, cos, sin, cache, pos)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        m, aux = moe_apply(cfg, p["moe"], h)
    else:
        m, aux = swiglu(p["mlp"], h), torch.zeros((), device=x.device)
    return x + m, new_cache, aux


def _train_layer(cfg, lp, x, cos, sin):
    x, _, aux = _block_apply(cfg, _cast_block(cfg, lp), x, cos, sin, "train")
    return constrain(x, ("act_batch", "act_seq", "act_embed")), aux


def _train_layers(cfg, layers, x, cos, sin):
    """Layers in training, each checkpointed under ``cfg.remat``; returns
    (x, the sum of their aux losses)."""
    auxs = []
    for lp in layers:
        x, aux = remat(cfg.remat, _train_layer, cfg, lp, x, cos, sin)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def remat_grouped(cfg) -> bool:
    """Whether training nests each layer's checkpoint in its group's."""
    G = cfg.remat_groups
    return bool(cfg.remat and G and cfg.n_layers % G == 0
                and G < cfg.n_layers)


def _run_blocks(cfg, params, x, cos, sin, mode, caches=None, pos=None):
    """The stacked layers on x; returns (x, caches, aux_sum). Prefill
    returns fresh caches (k, v), each (L, B, S, Hkv, Dh); decode writes its
    K/V into ``caches`` IN PLACE at ``pos`` and returns them; training
    returns no caches."""
    layers = unstack(params["blocks"])
    if mode == "train":
        if remat_grouped(cfg):
            inner = cfg.n_layers // cfg.remat_groups
            auxs = []
            for g in range(cfg.remat_groups):
                x, aux = remat(True, _train_layers, cfg,
                               layers[g * inner:(g + 1) * inner], x, cos, sin)
                auxs.append(aux)
            return x, None, torch.stack(auxs).sum()
        x, aux = _train_layers(cfg, layers, x, cos, sin)
        return x, None, aux
    ks, vs = [], []
    for i, lp in enumerate(layers):
        cache = (caches[0][i], caches[1][i]) if mode == "decode" else None
        x, (k, v), _ = _block_apply(cfg, _cast_block(cfg, lp), x, cos, sin,
                                    mode, cache=cache, pos=pos)
        ks.append(k)
        vs.append(v)
    if mode == "decode":
        return x, caches, None
    return x, (torch.stack(ks), torch.stack(vs)), None


def mrope_positions(s_img: int, s_text: int, device=None):
    """Synthetic M-RoPE ids (S, 3): image tokens on a (t=0, h, w) grid of
    width g = ceil(sqrt(s_img)), text tokens sequential on all three
    channels from g on."""
    g = max(int(math.ceil(math.sqrt(max(s_img, 1)))), 1)
    i = torch.arange(s_img, device=device)
    img = torch.stack([torch.zeros_like(i), i // g, i % g], dim=-1)
    t = torch.arange(s_text, device=device) + g
    txt = torch.stack([t, t, t], dim=-1)
    return torch.cat([img, txt], dim=0)


def _cos_sin(cfg, positions, batch: int):
    Dh = cfg.resolved_head_dim
    pos = positions[None].expand(batch, *positions.shape)
    if cfg.family == "vlm":
        return mrope_cos_sin(pos, Dh, cfg.rope_theta, cfg.mrope_sections)
    return rope_cos_sin(pos, Dh, cfg.rope_theta)


def _embed_inputs(cfg, params, batch_dict):
    """Token embeddings, with the projected patches in front for the VLM;
    returns (x (B, s_img + S, d), s_img)."""
    dt = getattr(torch, cfg.dtype)
    x = embedding_rows(params["embed"], batch_dict["tokens"]).to(dt)
    s_img = 0
    if cfg.family == "vlm" and "patch_embeds" in batch_dict:
        pp = params["patch_proj"]
        pe = batch_dict["patch_embeds"].to(dt)
        img = gelu(pe @ pp["w1"].to(dt)) @ pp["w2"].to(dt)
        x = torch.cat([img, x], dim=1)
        s_img = pe.shape[1]
    return constrain(x, ("act_batch", "act_seq", "act_embed")), s_img


def _positions(cfg, x, s_img: int, s_text: int):
    if cfg.family == "vlm":
        return mrope_positions(s_img, s_text, x.device)
    return torch.arange(x.shape[1], device=x.device)


def _logits(cfg, params, x):
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head.to(x.dtype),
                     ("act_batch", "act_seq", "act_vocab"))


def lm_loss(cfg, params, batch_dict):
    """(loss, {"aux_loss"}) of a batch {"tokens", "labels"} (and, for the
    VLM, "patch_embeds"): the f32 cross entropy with z-loss on the text
    positions, plus 0.01 x the MoE's load-balance loss."""
    x, s_img = _embed_inputs(cfg, params, batch_dict)
    cos, sin = _cos_sin(cfg, _positions(cfg, x, s_img,
                                        batch_dict["tokens"].shape[1]),
                        x.shape[0])
    x, _, aux = _run_blocks(cfg, params, x, cos, sin, "train")
    logits = _logits(cfg, params, x)
    if cfg.family == "vlm":
        logits = logits[:, s_img:]                       # loss on text only
    loss = cross_entropy_loss(logits, batch_dict["labels"])
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss, {"aux_loss": aux}


def lm_prefill(cfg, params, batch_dict):
    """Logits of the last position (B, 1, V) and the prompt's caches (k, v),
    each (L, B, s_img + S, Hkv, Dh)."""
    x, s_img = _embed_inputs(cfg, params, batch_dict)
    cos, sin = _cos_sin(cfg, _positions(cfg, x, s_img,
                                        batch_dict["tokens"].shape[1]),
                        x.shape[0])
    x, caches, _ = _run_blocks(cfg, params, x, cos, sin, "prefill")
    return _logits(cfg, params, x[:, -1:]), caches


def lm_decode(cfg, params, batch_dict, caches):
    """batch_dict: {"tokens": (B, 1), "pos": the cache position of this
    token} (and for the VLM "mrope_delta", default 0: the M-RoPE position
    is pos + mrope_delta). Writes the token's K/V into ``caches`` in place;
    returns (logits (B, 1, V), caches)."""
    dt = getattr(torch, cfg.dtype)
    x = embedding_rows(params["embed"], batch_dict["tokens"]).to(dt)
    B = x.shape[0]
    pos = int(batch_dict["pos"])
    if cfg.family == "vlm":
        rp = pos + int(batch_dict.get("mrope_delta", 0))
        p3 = torch.full((B, 1, 3), rp, dtype=torch.int32, device=x.device)
        cos, sin = mrope_cos_sin(p3, cfg.resolved_head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
    else:
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_cos_sin(posv, cfg.resolved_head_dim, cfg.rope_theta)
    x, caches, _ = _run_blocks(cfg, params, x, cos, sin, "decode",
                               caches=caches, pos=pos)
    return _logits(cfg, params, x), caches


def lm_cache_spec(cfg, batch: int, max_len: int):
    """((k, v) as (shape, torch dtype) each, their logical axes): the
    stacked KV caches."""
    shape = (cfg.n_layers,) + kv_cache_shape(cfg, batch, max_len)
    dt = getattr(torch, cfg.dtype)
    axes = ("layers", BATCH, "cache_seq", KV_HEADS, HEAD_DIM)
    return ((shape, dt), (shape, dt)), (axes, axes)
