"""Prediction-serving layer: one API over every forest inference path.

``backend`` — PredictorBackend protocol + build_backends, per device
``engine``  — ForestEngine (micro-batching, cache, hot-swap) and the
              MultiDeviceEngine pricing frontend
``refresh`` — EngineRefresher: refit-on-snapshot + atomic hot-swap
"""
from .backend import (BACKENDS, PredictorBackend, ServingEngine,
                      build_backends, supports_deadline)
from .engine import EngineConfig, EngineStats, ForestEngine, MultiDeviceEngine
from .refresh import EngineRefresher, RefreshStats, single_device_fit_fn

__all__ = ["BACKENDS", "EngineConfig", "EngineStats", "EngineRefresher",
           "ForestEngine", "MultiDeviceEngine", "PredictorBackend",
           "RefreshStats", "ServingEngine", "build_backends",
           "single_device_fit_fn", "supports_deadline"]
