"""Model registry: one ``ModelBundle`` per architecture family, the port of
``repro.models.registry``:

    init(seed, device)                  -> params (nested dict of tensors)
    loss(params, batch)                 -> (scalar loss, metrics)
    prefill(params, batch)              -> (logits, caches)
    decode(params, batch, caches)       -> (logits, caches)   caches in place
    make_batch(shape, seed, device)     -> batch of the reference's numbers
    cache_spec(batch, max_len)          -> (tree of (shape, dtype), axes)
    init_cache(batch, max_len, device)  -> zero caches
    param_axes() / input_axes(shape) / cache_axes(batch, max_len)
                                        -> logical axes for the sharding rules
    abstract(dtype) / abstract_inputs(shape) / abstract_cache(batch, max_len)
                                        -> the same trees on the meta device

Every family of the reference is ported: dense, moe and vlm
(``models/lm.py``), mamba_hybrid (``models/zamba.py``), xlstm
(``models/xlstm_lm.py``) and encdec (``models/encdec.py``). A cache tree is
the family's own: a (k, v) pair (dense, moe, vlm), a dict of tensors and
pairs (zamba2: "conv", "ssm", "kv"; encdec: "cross", "self"), or a dict of
tuples (xlstm: "m" (C, n, m), "s" (c, n, h, m)).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.forest_torch import resolve_device
from .common import BATCH, init_params, leaves, logical_axes, tree_map
from . import encdec, lm, xlstm_lm, zamba


@dataclass
class ModelBundle:
    cfg: ModelConfig
    specs: dict
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable

    # ------------------------------------------------ params
    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> dict:
        return init_params(self.specs, seed, device)

    def abstract(self, dtype: str | None = None) -> dict:
        """The params as tensors on the ``meta`` device (shapes and dtypes,
        no storage); ``dtype`` overrides the float leaves (bf16 serving
        weights carry no f32 masters)."""
        def meta(_, s):
            dt = getattr(torch, s.dtype)
            if dtype is not None and dt.is_floating_point:
                dt = getattr(torch, dtype)
            return torch.empty(s.shape, dtype=dt, device="meta")
        return tree_map(meta, self.specs)

    def param_axes(self) -> dict:
        return logical_axes(self.specs)

    def n_params(self) -> int:
        return int(sum(np.prod(s.shape) for s in leaves(self.specs)))

    # ------------------------------------------------ inputs
    def _seq_split(self, shape: ShapeConfig) -> tuple[int, int]:
        """(aux_len, text_len): the image patches and text tokens of a VLM
        sequence, the encoder frames and decoder tokens of an enc-dec one."""
        if self.cfg.family == "vlm":
            s_img = int(shape.seq_len * self.cfg.img_token_frac)
            return s_img, shape.seq_len - s_img
        if self.cfg.family == "encdec":
            return shape.seq_len, shape.seq_len     # enc frames + dec tokens
        return 0, shape.seq_len

    def input_specs(self, shape: ShapeConfig) -> dict:
        """{name: (shape, dtype name)} of a batch, in the reference's
        ``input_specs`` order."""
        B = shape.global_batch
        fam = self.cfg.family
        aux_len, text_len = self._seq_split(shape)
        if shape.kind == "decode":
            d = {"tokens": ((B, 1), "int32"), "pos": ((), "int32")}
            if fam == "vlm":
                d["mrope_delta"] = ((), "int32")
            return d
        d = {"tokens": ((B, text_len), "int32")}
        if shape.kind == "train":
            d["labels"] = ((B, text_len), "int32")
        if fam == "vlm":
            d["patch_embeds"] = ((B, aux_len, self.cfg.patch_dim),
                                 self.cfg.dtype)
        if fam == "encdec":
            d["frames"] = ((B, aux_len, self.cfg.d_model), self.cfg.dtype)
        return d

    def input_axes(self, shape: ShapeConfig) -> dict:
        """Logical axes of a batch: ``batch`` on the leading dim, the rest
        replicated; () for a scalar."""
        return {name: () if not shp else (BATCH,) + (None,) * (len(shp) - 1)
                for name, (shp, _) in self.input_specs(shape).items()}

    def abstract_inputs(self, shape: ShapeConfig) -> dict:
        """``input_specs`` as tensors on the ``meta`` device."""
        return {name: torch.empty(shp, dtype=getattr(torch, dt),
                                  device="meta")
                for name, (shp, dt) in self.input_specs(shape).items()}

    def make_batch(self, shape: ShapeConfig, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
        """Concrete random batch: the same numpy draws, in the same order,
        as the reference's ``make_batch``, so the tokens and the float32
        inputs are equal (a float input is 0.1 x a normal draw, rounded to
        float32 and then to its dtype; an int32 one, ``mrope_delta``,
        truncates its draw toward 0 as the reference's cast does)."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        out = {}
        for name, (shp, dt) in self.input_specs(shape).items():
            if name in ("tokens", "labels"):
                out[name] = torch.as_tensor(
                    rng.integers(0, self.cfg.vocab, size=shp),
                    dtype=torch.int32, device=device)
            elif name == "pos":
                out[name] = torch.tensor(0, dtype=torch.int32, device=device)
            else:
                a = np.asarray(rng.normal(size=shp) * 0.1)
                a = a.astype(np.int32 if dt == "int32" else np.float32)
                out[name] = torch.as_tensor(a, device=device).to(
                    getattr(torch, dt))
        return out

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda"):
        """Zero caches of the family's cache tree (``cache_spec``)."""
        shapes, _ = self.cache_spec(batch, max_len)
        device = resolve_device(device)

        def zeros(spec):
            if isinstance(spec, dict):
                return {k: zeros(v) for k, v in spec.items()}
            if len(spec) == 2 and isinstance(spec[1], torch.dtype):
                return torch.zeros(spec[0], dtype=spec[1], device=device)
            return tuple(zeros(s) for s in spec)
        return zeros(shapes)

    def abstract_cache(self, batch: int, max_len: int):
        """The cache tree on the ``meta`` device."""
        return self.init_cache(batch, max_len, device="meta")

    def cache_axes(self, batch: int, max_len: int):
        return self.cache_spec(batch, max_len)[1]


def build_model(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelBundle(
            cfg=cfg, specs=lm.lm_specs(cfg),
            loss=partial(lm.lm_loss, cfg),
            prefill=partial(lm.lm_prefill, cfg),
            decode=partial(lm.lm_decode, cfg),
            cache_spec=partial(lm.lm_cache_spec, cfg))
    if fam == "mamba_hybrid":
        return ModelBundle(
            cfg=cfg, specs=zamba.zamba_specs(cfg),
            loss=partial(zamba.zamba_loss, cfg),
            prefill=partial(zamba.zamba_prefill, cfg),
            decode=partial(zamba.zamba_decode, cfg),
            cache_spec=partial(zamba.zamba_cache_spec, cfg))
    if fam == "xlstm":
        return ModelBundle(
            cfg=cfg, specs=xlstm_lm.xlstm_specs(cfg),
            loss=partial(xlstm_lm.xlstm_loss, cfg),
            prefill=partial(xlstm_lm.xlstm_prefill, cfg),
            decode=partial(xlstm_lm.xlstm_decode, cfg),
            cache_spec=partial(xlstm_lm.xlstm_cache_spec, cfg))
    if fam == "encdec":
        # the cross cache's spec is max_len long, as the reference's
        # registry has it; a prefill's cross cache is as long as its frames
        return ModelBundle(
            cfg=cfg, specs=encdec.encdec_specs(cfg),
            loss=partial(encdec.encdec_loss, cfg),
            prefill=partial(encdec.encdec_prefill, cfg),
            decode=partial(encdec.encdec_decode, cfg),
            cache_spec=lambda batch, max_len: encdec.encdec_cache_spec(
                cfg, batch, max_len, enc_len=max_len))
    raise ValueError(f"unknown family {fam!r}")
