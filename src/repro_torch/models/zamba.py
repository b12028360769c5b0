"""zamba2: Mamba2 backbone with a weight-SHARED attention+MLP block applied
every ``cfg.shared_attn_every`` layers, specialized per call site by LoRA
adapters (arXiv:2411.15242). The port of ``repro.models.zamba``.

Structure: L mamba layers in G = L / every groups; each group runs its
mamba layers, then the shared transformer block with that group's LoRA
(q-projection and MLP-gate adapters). Parameters are stacked as in the
reference, (G, every, ...) for mamba and (G, ...) for LoRA; the reference's
two nested scans are two Python loops over those stacks here. Training
(``zamba_loss``) runs the shared block's attention through kernel B2 and
every Mamba layer's scan through kernel B3 under ``cfg.use_pallas``.
"""
from __future__ import annotations

import torch

from ..sharding.context import (LayerStack, batch_tables, constrain,
                                embedding_rows, project, residual)
from .attention import (attend_decode, attend_prefill, attend_train,
                        attn_specs, kv_cache_shape)
from .common import (BATCH, EMBED, HEAD_DIM, HEADS, KV_HEADS, LORA, VOCAB,
                     ParamSpec, cross_entropy_loss, remat, rms_norm,
                     rope_cos_sin, stack_specs, unstack)
from .mamba2 import mamba_cache_shapes, mamba_mix, mamba_specs
from .mlp import swiglu, swiglu_specs


def _mamba_layer_specs(cfg) -> dict:
    return {
        "ln": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
        "mix": mamba_specs(cfg),
    }


def _shared_block_specs(cfg) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
        "attn": attn_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
        "mlp": swiglu_specs(cfg),
    }


def _lora_specs(cfg) -> dict:
    d, r = cfg.d_model, cfg.shared_lora_rank
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    return {
        "q_a": ParamSpec((d, r), (EMBED, LORA), scale=0.02),
        "q_b": ParamSpec((r, H, Dh), (LORA, HEADS, HEAD_DIM), init="zeros"),
        "gate_a": ParamSpec((d, r), (EMBED, LORA), scale=0.02),
        "gate_b": ParamSpec((r, cfg.d_ff), (LORA, None), init="zeros"),
    }


def zamba_specs(cfg) -> dict:
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {cfg.shared_attn_every}")
    groups = cfg.n_layers // cfg.shared_attn_every
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (VOCAB, EMBED),
                           init="embed", scale=0.02),
        "mamba": stack_specs(stack_specs(_mamba_layer_specs(cfg),
                                         cfg.shared_attn_every), groups),
        "shared": _shared_block_specs(cfg),
        "lora": stack_specs(_lora_specs(cfg), groups),
        "ln_f": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), (EMBED, VOCAB)),
    }


def _shared_block(cfg, shared, lora, x, cos, sin, mode, kv_cache=None,
                  pos=None):
    h = rms_norm(x, shared["ln1"], cfg.norm_eps)
    # LoRA-specialized q projection: wq_eff = wq + q_a @ q_b
    attn_p = dict(shared["attn"])
    attn_p["wq"] = attn_p["wq"] + torch.einsum(
        "dr,rhk->dhk", lora["q_a"], lora["q_b"]).to(attn_p["wq"].dtype)
    new_cache = None
    if mode == "train":
        a = attend_train(cfg, attn_p, h, cos, sin)
    elif mode == "prefill":
        a, new_cache = attend_prefill(cfg, attn_p, h, cos, sin)
    elif mode == "decode":
        a, new_cache = attend_decode(cfg, attn_p, h, cos, sin, kv_cache, pos)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = residual(x, a)
    del a, h                  # not kept beside the MLP's activations
    h = rms_norm(x, shared["ln2"], cfg.norm_eps)
    mlp_p = dict(shared["mlp"])
    mlp_p["wi_gate"] = mlp_p["wi_gate"] + (
        lora["gate_a"] @ lora["gate_b"]).to(mlp_p["wi_gate"].dtype)
    # on a mesh the MLP's out-projection leaves a partial sum over its
    # sharded width: reduced here, once, not in the next norm and again in
    # the head's product
    x = constrain(x + swiglu(mlp_p, h), ("act_batch", "act_seq", "act_embed"))
    return x, new_cache


def _train_layer(cfg, lp, x):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    out, _ = mamba_mix(cfg, lp["mix"], h)
    return x + out


def _train_group(cfg, shared, layers, lora, x, cos, sin):
    """One group in training: its Mamba layers, each checkpointed under
    ``cfg.remat``, then the shared block."""
    for lp in layers:
        x = remat(cfg.remat, _train_layer, cfg, lp, x)
    x, _ = _shared_block(cfg, shared, lora, x, cos, sin, "train")
    return x


def _forward(cfg, params, x, mode, caches=None, pos=None):
    """Training returns (x, None); under ``cfg.remat`` each group and,
    inside it, each Mamba layer is checkpointed, as the reference nests its
    ``jax.checkpoint``s. Prefill returns fresh caches {"conv": (G,E,...),
    "ssm": (G,E,...), "kv": ((G,B,S,...), (G,B,S,...))}. Decode updates
    ``caches`` (with kv at their full length) IN PLACE and returns them."""
    B, S = x.shape[:2]
    decode = mode == "decode"
    if decode:
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim,
                                cfg.rope_theta)
    else:
        cos, sin = batch_tables(lambda n: rope_cos_sin(
            torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
                n, S), cfg.resolved_head_dim, cfg.rope_theta), x)
    groups = [unstack(g) for g in unstack(params["mamba"])]
    loras = unstack(params["lora"])

    if mode == "train":
        for layers, lora in zip(groups, loras):
            args = (cfg, params["shared"], layers, lora, x, cos, sin)
            x = remat(cfg.remat, _train_group, *args)
        return x, None

    G, E = len(groups), len(groups[0])
    _, axes = zamba_cache_spec(cfg, B, S)
    convs, ssms = (LayerStack((G, E), axes[n][2:]) for n in ("conv", "ssm"))
    ks, vs = (LayerStack((G,), a[1:]) for a in axes["kv"])
    for g, (layers, lora) in enumerate(zip(groups, loras)):
        for e, lp in enumerate(layers):
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            if decode:
                out, (nc, ns) = mamba_mix(
                    cfg, lp["mix"], h, ssm_state=caches["ssm"][g, e],
                    conv_state=caches["conv"][g, e], decode=True)
                caches["conv"][g, e].copy_(nc)
                caches["ssm"][g, e].copy_(ns)
            else:
                out, (nc, ns) = mamba_mix(cfg, lp["mix"], h)
                convs.put(nc)
                ssms.put(ns)
            x = x + out
            del h, out        # not kept beside the next layer's
        kv = (caches["kv"][0][g], caches["kv"][1][g]) if decode else None
        x, (k, v) = _shared_block(cfg, params["shared"], lora, x, cos, sin,
                                  mode, kv_cache=kv, pos=pos)
        if not decode:
            ks.put(k)
            vs.put(v)
    if decode:
        return x, caches
    new_caches = {
        "conv": convs.result(),
        "ssm": ssms.result(),
        "kv": (ks.result(), vs.result()),
    }
    return x, new_caches


def _embed(cfg, params, tokens):
    x = embedding_rows(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    return constrain(x, ("act_batch", "act_seq", "act_embed"))


def zamba_loss(cfg, params, batch_dict):
    """(loss, metrics) of a batch {"tokens", "labels"} (B, S): the model in
    its training mode, then the f32 cross entropy with z-loss."""
    x = _embed(cfg, params, batch_dict["tokens"])
    x, _ = _forward(cfg, params, x, "train")
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = project(x, params["lm_head"])
    return cross_entropy_loss(logits, batch_dict["labels"]), {}


def zamba_prefill(cfg, params, batch_dict):
    """Logits of the last position (B, 1, V) and the caches of the prompt.
    The embedding goes straight to the layers, bound to no name here, so
    it is freed once the first layer has made its output."""
    x, caches = _forward(cfg, params, _embed(cfg, params,
                                             batch_dict["tokens"]),
                         "prefill")
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return project(x, params["lm_head"]), caches


def zamba_decode(cfg, params, batch_dict, caches):
    """One token per row at position ``batch_dict["pos"]``; updates
    ``caches`` in place and returns (logits (B, 1, V), caches)."""
    x = _embed(cfg, params, batch_dict["tokens"])
    x, caches = _forward(cfg, params, x, "decode", caches=caches,
                         pos=int(batch_dict["pos"]))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return project(x, params["lm_head"]), caches


def zamba_cache_spec(cfg, batch: int, max_len: int):
    """({name: (shape, torch dtype)} with "kv" a pair, {name: logical
    axes})."""
    G = cfg.n_layers // cfg.shared_attn_every
    E = cfg.shared_attn_every
    ms = mamba_cache_shapes(cfg, batch)
    dt = getattr(torch, cfg.dtype)
    kv_shape = (G,) + kv_cache_shape(cfg, batch, max_len)
    shapes = {
        "conv": ((G, E) + ms["conv"], dt),
        "ssm": ((G, E) + ms["ssm"], torch.float32),
        "kv": ((kv_shape, dt), (kv_shape, dt)),
    }
    axes = {
        "conv": ("layers", "layers", BATCH, None, "inner"),
        "ssm": ("layers", "layers", BATCH, "heads", None, None),
        "kv": (("layers", BATCH, "cache_seq", KV_HEADS, HEAD_DIM),
               ("layers", BATCH, "cache_seq", KV_HEADS, HEAD_DIM)),
    }
    return shapes, axes
