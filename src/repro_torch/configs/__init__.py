"""Architecture registry: the 10 assigned configs + shapes (40 cells), copied
as data from ``repro.configs``; every family has a model in the port
(``models/registry.py``)."""
from . import (granite_moe_3b_a800m, mistral_large_123b, olmoe_1b_7b,
               qwen1p5_110b, qwen2_vl_7b, qwen2p5_14b, smollm_360m,
               whisper_medium, xlstm_125m, zamba2_2p7b)
from .base import (LONG_500K, SHAPES, ModelConfig, ShapeConfig, reduced,
                   supports_shape)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (zamba2_2p7b, mistral_large_123b, qwen1p5_110b, smollm_360m,
              qwen2p5_14b, whisper_medium, olmoe_1b_7b, granite_moe_3b_a800m,
              qwen2_vl_7b, xlstm_125m)
}

# paper's own "architecture": the predictor itself has no NN architecture;
# the framework arch used in the end-to-end example is smollm-360m.


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells (long_500k on pure
    full-attention archs) are yielded with skip=True when requested."""
    for name, cfg in ARCHS.items():
        for shape in SHAPES.values():
            ok = supports_shape(cfg, shape)
            if ok or include_skipped:
                yield cfg, shape, (not ok)
