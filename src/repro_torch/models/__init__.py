"""The port's LM framework (``repro.models``), serving half: ``common``,
``mlp``, ``mamba2``, ``attention`` (prefill/decode), ``zamba`` and
``registry``. Only the ``mamba_hybrid`` family (zamba2) is ported."""
from .registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
