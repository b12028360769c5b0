"""Model registry: one ``ModelBundle`` per architecture family, the port of
``repro.models.registry``:

    init(seed, device)                  -> params (nested dict of tensors)
    loss(params, batch)                 -> (scalar loss, metrics)
    prefill(params, batch)              -> (logits, caches)
    decode(params, batch, caches)       -> (logits, caches)   caches in place
    make_batch(shape, seed, device)     -> batch of the reference's numbers
    cache_spec(batch, max_len)          -> ({name: (shape, dtype)}, axes)
    init_cache(batch, max_len, device)  -> zero caches

Only the ``mamba_hybrid`` family (zamba2) is ported; ``build_model`` names
the ROADMAP item that brings each other family.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.forest_torch import resolve_device
from .common import init_params, leaves
from . import zamba

#: Where each family not yet ported is queued (ROADMAP.md, queue 1).
_NOT_PORTED = {
    "dense": "ROADMAP item 11.4 (models/lm.py)",
    "moe": "ROADMAP item 11.4 (models/moe.py, models/lm.py)",
    "vlm": "ROADMAP item 11.4 (models/lm.py, M-RoPE)",
    "xlstm": "ROADMAP item 11.4 (models/xlstm.py, models/xlstm_lm.py)",
    "encdec": "ROADMAP item 11.4 (models/encdec.py)",
}


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

    def n_params(self) -> int:
        return int(sum(np.prod(s.shape) for s in leaves(self.specs)))

    # ------------------------------------------------ inputs
    def input_specs(self, shape: ShapeConfig) -> dict:
        """{name: (shape, dtype name)} of a batch, as the reference's
        ``input_specs`` for a text-only family."""
        B = shape.global_batch
        if shape.kind == "decode":
            return {"tokens": ((B, 1), "int32"), "pos": ((), "int32")}
        d = {"tokens": ((B, shape.seq_len), "int32")}
        if shape.kind == "train":
            d["labels"] = ((B, shape.seq_len), "int32")
        return d

    def make_batch(self, shape: ShapeConfig, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
        """Concrete random batch: the same numpy draws, in the same order,
        as the reference's ``make_batch``, so the tokens are equal."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        out = {}
        for name, (shp, _) in self.input_specs(shape).items():
            if name == "pos":
                out[name] = torch.tensor(0, dtype=torch.int32, device=device)
            else:                                   # tokens, labels
                out[name] = torch.as_tensor(
                    rng.integers(0, self.cfg.vocab, size=shp),
                    dtype=torch.int32, device=device)
        return out

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        shapes, _ = self.cache_spec(batch, max_len)
        device = resolve_device(device)

        def zeros(spec):
            if not isinstance(spec[1], torch.dtype):
                return tuple(zeros(s) for s in spec)        # the (k, v) pair
            shp, dt = spec
            return torch.zeros(shp, dtype=dt, device=device)
        return {name: zeros(spec) for name, spec in shapes.items()}


def build_model(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam == "mamba_hybrid":
        return ModelBundle(
            cfg=cfg, specs=zamba.zamba_specs(cfg),
            loss=partial(zamba.zamba_loss, cfg),
            prefill=partial(zamba.zamba_prefill, cfg),
            decode=partial(zamba.zamba_decode, cfg),
            cache_spec=partial(zamba.zamba_cache_spec, cfg))
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"family {fam!r} is not ported yet: "
                                  f"{_NOT_PORTED[fam]}")
    raise ValueError(f"unknown family {fam!r}")
