"""The port's LM framework (``repro.models``): ``common``, ``mlp``,
``mamba2``, ``attention``, ``zamba`` and ``registry``, for training and
serving. Only the ``mamba_hybrid`` family (zamba2) is ported."""
from .registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
