"""Prediction-serving layer: one API over every forest inference path.

``backend`` — PredictorBackend protocol + build_backends, per device
``engine``  — ForestEngine (micro-batching, cache, hot-swap) and the
              MultiDeviceEngine pricing frontend
"""
from .backend import (BACKENDS, PredictorBackend, ServingEngine,
                      build_backends, supports_deadline)
from .engine import EngineConfig, EngineStats, ForestEngine, MultiDeviceEngine

__all__ = ["BACKENDS", "EngineConfig", "EngineStats", "ForestEngine",
           "MultiDeviceEngine", "PredictorBackend", "ServingEngine",
           "build_backends", "supports_deadline"]
