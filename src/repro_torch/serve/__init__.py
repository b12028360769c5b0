"""Prediction-serving layer: one API over every forest inference path
(counterpart of ``repro.serve``).

``backend``  — PredictorBackend protocol + build_backends, per device, + the
               cold-start transfer-engine builder (``core.transfer``)
``engine``   — ForestEngine (micro-batching, cache, hot-swap) and the
               MultiDeviceEngine pricing frontend
``sharded``  — ShardedForestEngine: tree-axis partitioning across devices
``refresh``  — EngineRefresher: refit-on-snapshot + atomic hot-swap
``supervise``— TransferSupervisor: self-managing cold-start tier (live
               feedback, auto-graduation, probe budgeting, re-targeting)
"""
from .backend import (BACKENDS, DeadlineAwarePredictor, PredictorBackend,
                      ServingEngine, build_backends, build_transfer_engine,
                      supports_deadline)
from .engine import EngineConfig, EngineStats, ForestEngine, MultiDeviceEngine
from .refresh import EngineRefresher, RefreshStats, single_device_fit_fn
from .sharded import ShardedForestEngine, ShardedForestPredictor
from .supervise import (PAPER_ENVELOPE_PCT, GraduatedEngine,
                        SupervisorConfig, SupervisorStats, TransferSupervisor)

__all__ = ["BACKENDS", "DeadlineAwarePredictor", "EngineConfig",
           "EngineStats", "EngineRefresher", "ForestEngine",
           "GraduatedEngine", "MultiDeviceEngine", "PAPER_ENVELOPE_PCT",
           "PredictorBackend", "RefreshStats", "ServingEngine",
           "ShardedForestEngine", "ShardedForestPredictor",
           "SupervisorConfig", "SupervisorStats", "TransferSupervisor",
           "build_backends", "build_transfer_engine", "single_device_fit_fn",
           "supports_deadline"]
