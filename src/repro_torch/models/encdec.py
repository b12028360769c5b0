"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the port of
``repro.models.encdec``.

The conv audio frontend is a stub: ``make_batch`` supplies precomputed
frame embeddings (B, S_enc, d_model). Positions are sinusoidal on both
sides (the reference's documented choice, so the cache length does not
depend on a learned table). Blocks are pre-LayerNorm (with bias) with GELU
MLPs; the decoder adds cross-attention against encoder K/V computed once
at prefill. The decoder's self-attention rotates by the identity
(``_zero_rope``), and in training it is kernel B2 under ``cfg.use_pallas``;
the encoder's attention (no mask) and the cross-attention stay plain, as in
the reference. Layers are stored stacked and run in Python loops (the
reference's scans); under ``cfg.remat`` training checkpoints each encoder
and each decoder layer. The output projection is the embedding, tied.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..sharding.context import embedding_rows, on_mesh
from .attention import (_out, _qkv, attend_cross, attend_decode,
                        attend_full, attend_prefill, attend_train,
                        attn_specs, cross_kv, kv_cache_shape)
from .common import (BATCH, EMBED, HEAD_DIM, KV_HEADS, VOCAB, ParamSpec,
                     cross_entropy_loss, layer_norm, remat, stack_specs,
                     unstack)
from .mlp import gelu_mlp, gelu_mlp_specs


def _ln(cfg):
    return {"w": ParamSpec((cfg.d_model,), (EMBED,), init="ones"),
            "b": ParamSpec((cfg.d_model,), (EMBED,), init="zeros")}


def _enc_block_specs(cfg):
    return {"ln1": _ln(cfg), "attn": attn_specs(cfg),
            "ln2": _ln(cfg), "mlp": gelu_mlp_specs(cfg)}


def _dec_block_specs(cfg):
    return {"ln1": _ln(cfg), "self_attn": attn_specs(cfg),
            "ln2": _ln(cfg), "cross_attn": attn_specs(cfg),
            "ln3": _ln(cfg), "mlp": gelu_mlp_specs(cfg)}


def encdec_specs(cfg) -> dict:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (VOCAB, EMBED),
                           init="embed", scale=0.02),
        "enc": stack_specs(_enc_block_specs(cfg), cfg.n_enc_layers),
        "dec": stack_specs(_dec_block_specs(cfg), cfg.n_layers),
        "ln_enc": _ln(cfg),
        "ln_dec": _ln(cfg),
    }


def _norm(p, x, cfg):
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def sinusoid(S: int, d: int, dtype, offset: int = 0, device=None):
    """(S, d) positions offset..offset+S-1: sin of the d/2 angles, then
    cos, computed in float32 and cast to ``dtype``."""
    pos = torch.arange(S, device=device)[:, None] + offset
    i = torch.arange(d // 2, device=device)[None, :]
    ang = pos.float() / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _like(table, x):
    """A position table made alike on every rank, on ``x``'s mesh when
    ``x`` is a DTensor."""
    return on_mesh(table, x.device_mesh) if isinstance(x, DTensor) else table


def _zero_rope(cfg, B, S, device):
    """cos = 1, sin = 0: the identity rotation."""
    half = cfg.resolved_head_dim // 2
    return (torch.ones((B, S, half), device=device),
            torch.zeros((B, S, half), device=device))


def _enc_layer(cfg, p, x):
    """An encoder block: bidirectional self-attention (no mask, no
    rotation), then the GELU MLP."""
    h = _norm(p["ln1"], x, cfg)
    q, k, v = _qkv(cfg, p["attn"], h)
    x = x + _out(attend_full(q, k, v), p["attn"]["wo"])
    return x + gelu_mlp(p["mlp"], _norm(p["ln2"], x, cfg))


def encode(cfg, params, frames, train: bool = False):
    """frames: (B, S_enc, d_model) precomputed embeddings (stub frontend).
    ``train``: each layer checkpointed under ``cfg.remat``."""
    dt = getattr(torch, cfg.dtype)
    S = frames.shape[1]
    x = frames.to(dt)
    x = x + _like(sinusoid(S, cfg.d_model, dt, device=x.device)[None], x)
    for p in unstack(params["enc"]):
        x = remat(train and cfg.remat, _enc_layer, cfg, p, x)
    return _norm(params["ln_enc"], x, cfg)


def _dec_layer(cfg, p, x, cos, sin, mode, kv=None, enc_out=None,
               self_cache=None, pos=None):
    """A decoder block; returns (x, its cross K/V, its self K/V). The cross
    K/V come from ``enc_out`` when ``kv`` is None."""
    h = _norm(p["ln1"], x, cfg)
    new_self = None
    if mode == "train":
        a = attend_train(cfg, p["self_attn"], h, cos, sin)
    elif mode == "prefill":
        a, new_self = attend_prefill(cfg, p["self_attn"], h, cos, sin)
    elif mode == "decode":
        a, new_self = attend_decode(cfg, p["self_attn"], h, cos, sin,
                                    self_cache, pos)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + a
    h = _norm(p["ln2"], x, cfg)
    if kv is None:
        kv = cross_kv(cfg, p["cross_attn"], enc_out)
    x = x + attend_cross(cfg, p["cross_attn"], h, kv)
    x = x + gelu_mlp(p["mlp"], _norm(p["ln3"], x, cfg))
    return x, kv, new_self


def _train_dec_layer(cfg, p, x, cos, sin, enc_out):
    return _dec_layer(cfg, p, x, cos, sin, "train", enc_out=enc_out)[0]


def _dec_blocks(cfg, params, x, mode, caches=None, enc_out=None, pos=None):
    """The decoder layers. Training returns (x, None); prefill (x, fresh
    caches {"cross": (k, v), "self": (k, v)}, each (L, B, S, Hkv, Dh));
    decode writes its K/V into ``caches["self"]`` in place at ``pos`` and
    returns (x, caches)."""
    B, S = x.shape[:2]
    cos, sin = _zero_rope(cfg, B, S, x.device)
    layers = unstack(params["dec"])
    if mode == "train":
        for p in layers:
            x = remat(cfg.remat, _train_dec_layer, cfg, p, x, cos, sin,
                      enc_out)
        return x, None
    if mode == "decode":
        (ck, cv), (sk, sv) = caches["cross"], caches["self"]
        for i, p in enumerate(layers):
            x, _, _ = _dec_layer(cfg, p, x, cos, sin, mode, kv=(ck[i], cv[i]),
                                 self_cache=(sk[i], sv[i]), pos=pos)
        return x, caches
    cross, selfs = [], []
    for p in layers:
        x, kv, new_self = _dec_layer(cfg, p, x, cos, sin, mode,
                                     enc_out=enc_out)
        cross.append(kv)
        selfs.append(new_self)
    return x, {"cross": _stack_pairs(cross), "self": _stack_pairs(selfs)}


def _stack_pairs(pairs) -> tuple:
    """Per-layer (k, v) pairs as one (k, v) pair stacked over the layers."""
    return tuple(torch.stack(t) for t in zip(*pairs))


def _embed(cfg, params, tokens, offset: int = 0):
    dt = getattr(torch, cfg.dtype)
    x = embedding_rows(params["embed"], tokens).to(dt)
    return x + _like(sinusoid(x.shape[1], cfg.d_model, dt, offset=offset,
                              device=x.device)[None], x)


def _logits(cfg, params, x):
    x = _norm(params["ln_dec"], x, cfg)
    return x @ params["embed"].T.to(x.dtype)


def encdec_loss(cfg, params, batch_dict):
    """(loss, {}) of a batch {"tokens", "labels", "frames"}."""
    enc_out = encode(cfg, params, batch_dict["frames"], train=True)
    x, _ = _dec_blocks(cfg, params, _embed(cfg, params, batch_dict["tokens"]),
                       "train", enc_out=enc_out)
    return cross_entropy_loss(_logits(cfg, params, x),
                              batch_dict["labels"]), {}


def encdec_prefill(cfg, params, batch_dict):
    """Logits of the last position (B, 1, V) and the caches: "cross" the
    encoder's K/V (as long as the frames), "self" the prompt's K/V."""
    enc_out = encode(cfg, params, batch_dict["frames"])
    x, caches = _dec_blocks(cfg, params,
                            _embed(cfg, params, batch_dict["tokens"]),
                            "prefill", enc_out=enc_out)
    return _logits(cfg, params, x[:, -1:]), caches


def encdec_decode(cfg, params, batch_dict, caches):
    """One token per row at position ``batch_dict["pos"]``, against the
    cross cache as given; writes into the self cache in place and returns
    (logits (B, 1, V), caches)."""
    pos = int(batch_dict["pos"])
    x, caches = _dec_blocks(cfg, params,
                            _embed(cfg, params, batch_dict["tokens"], pos),
                            "decode", caches=caches, pos=pos)
    return _logits(cfg, params, x), caches


def encdec_cache_spec(cfg, batch: int, max_len: int, enc_len: int):
    """({"cross": (k, v), "self": (k, v)} as (shape, dtype) each, axes)."""
    dt = getattr(torch, cfg.dtype)
    L = cfg.n_layers
    self_shape = (L,) + kv_cache_shape(cfg, batch, max_len)
    cross_shape = (L, batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    axes_kv = ("layers", BATCH, "cache_seq", KV_HEADS, HEAD_DIM)
    shapes = {"cross": ((cross_shape, dt), (cross_shape, dt)),
              "self": ((self_shape, dt), (self_shape, dt))}
    axes = {"cross": (axes_kv, axes_kv), "self": (axes_kv, axes_kv)}
    return shapes, axes
