"""Unified batched prediction-serving engine over the fitted forest
(counterpart of ``repro.serve.engine``).

The paper's deployment story (§6.1/§7.1) hinges on per-prediction latency:
15–108 ms single predictions on a Xeon bound which schedulers the model can
drive. The port carries five inference paths for the same fitted
``ExtraTreesRegressor`` (tree-walk, flat-numpy, flat-torch, dense-torch,
hopper); the ``ForestEngine`` puts ONE serving API in front of them:

  * ``engine.predict(X)``        — batched, cache-aware, returns (B,) float64
  * ``engine.predict_async(x)``  — single-sample future; requests are
    micro-batched (flushed by size or deadline) into one batched forest call
  * LRU result cache keyed on the feature-vector bytes. The paper's
    portability property (§3.1: features are hardware-independent and
    recorded once per kernel) means a kernel's prediction under a fixed
    model never changes — repeat queries from a scheduler loop are pure
    cache hits.
  * the device: ``EngineConfig.device`` defaults to ``"cuda"``, where the
    engine serves through the CUDA forest kernel (``backend="hopper"``); a
    kernel that fails raises, nothing falls back to the host. On
    ``device="cpu"`` the default is backend auto-selection: a short
    self-calibration pass (``core/latency.py``) times every path on a
    flush-sized batch and picks the fastest for THIS host.
  * hot-swap: ``engine.swap_estimator(new_est)`` atomically replaces the
    fitted forest without dropping in-flight or cached requests. Every
    answered batch is generation-uniform: all rows of one ``predict`` /
    micro-batch flush come from a single model generation (cache entries are
    invalidated on swap, and writes from a superseded generation are
    discarded). The streaming refresher (``serve/refresh.py``) drives this.

``MultiDeviceEngine`` is the scheduler-facing frontend: one engine per
(device-type, target) pair, pricing a whole (kernels × device-types) matrix
in one batched call per engine — the §7.1 "orders of magnitude shorter than
execution" requirement.

Backend construction lives in ``serve/backend.py`` (the PredictorBackend
protocol); tree-axis partitioning lives in ``serve/sharded.py``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from ..core.forest import ExtraTreesRegressor
from ..core.forest_torch import resolve_device
from ..core.latency import calibrate_backends
from .backend import (BACKENDS, PredictorBackend, build_backends,
                      calibration_rows)

__all__ = ["BACKENDS", "EngineConfig", "EngineStats", "ForestEngine",
           "MultiDeviceEngine", "build_backends"]


# -------------------------------------------------------------------- engine

@dataclass
class EngineConfig:
    backend: str | None = None     # one of BACKENDS, "auto", or None: "hopper"
                                   # on a CUDA device, "auto" on the CPU
    backends: tuple | None = None  # candidate subset for auto (None = all
                                   # the device serves)
    dense_depth: int = 10
    max_batch: int = 64            # flush when this many singles are pending
    max_delay_ms: float = 2.0      # ... or when the oldest single is this old
    cache_size: int = 4096         # LRU entries; 0 disables caching
    calibration_iters: int = 3
    device: str = "cuda"           # "cpu" only when the caller asks for it


@dataclass
class EngineStats:
    requests: int = 0              # single-sample async requests
    predictions: int = 0           # rows answered (batch + async)
    cache_hits: int = 0
    cache_misses: int = 0
    backend_rows: int = 0          # rows actually sent to the backend
    batches: int = 0               # backend calls
    flushes_size: int = 0
    flushes_deadline: int = 0
    flushes_manual: int = 0
    generation: int = 0            # current model generation (bumps on swap)
    swaps: int = 0                 # completed hot-swaps
    shard_drops: int = 0           # dead shards dropped (sharded engines)
    trees_lost: int = 0            # trees lost to dropped shards (accuracy
                                   # degradation: the mean renormalizes over
                                   # the survivors; a swap restores the full
                                   # forest and resets this to 0)

    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


@dataclass
class _Pending:
    key: bytes
    x: np.ndarray
    future: Future
    t: float


class ForestEngine:
    """One fitted forest behind one serving API (see module docstring)."""

    def __init__(self, est: ExtraTreesRegressor, config: EngineConfig | None = None,
                 *, calibration_X: np.ndarray | None = None, **overrides):
        cfg = config or EngineConfig()
        if overrides:
            cfg = EngineConfig(**{**cfg.__dict__, **overrides})
        if not est.trees_:
            raise ValueError("estimator is not fitted")
        self.config = cfg
        self.device = resolve_device(cfg.device)
        # the card serves through the kernel; the host picks by calibration
        self._choice = cfg.backend or (
            "hopper" if self.device.type == "cuda" else "auto")
        self.est = est
        self.n_features = est.n_features_
        self.stats = EngineStats()
        self.calibration: dict[str, float] = {}

        self._backends = self._build(est)
        if not self._backends:
            raise RuntimeError("no backend could be built")
        self.backend = self._select(self._backends, calibration_X)
        self._predict_fn = self._backends[self.backend]

        self._generation = 0
        self._cache: OrderedDict[bytes, float] = OrderedDict()
        self._cond = threading.Condition()
        self._pending: list[_Pending] = []
        self._worker: threading.Thread | None = None
        self._closed = False

    # ---------------------------------------------------------- construction

    def _build(self, est: ExtraTreesRegressor) -> dict[str, PredictorBackend]:
        """Build the backend table for one estimator. Subclasses override
        this single hook (``ShardedForestEngine`` returns its partitioned
        path) — both __init__ and swap_estimator route through it."""
        cfg = self.config
        only = cfg.backends
        if self._choice != "auto":
            only = (self._choice,)
        return build_backends(est, dense_depth=cfg.dense_depth, only=only,
                              device=self.device)

    def _select(self, backends: dict[str, PredictorBackend],
                calibration_X) -> str:
        cfg = self.config
        if self._choice != "auto" and self._choice in backends:
            return self._choice
        if len(backends) == 1:
            return next(iter(backends))
        if calibration_X is None:
            calibration_X = calibration_rows(cfg.max_batch, self.n_features)
        xb = np.ascontiguousarray(calibration_X, dtype=np.float32)
        self.calibration = calibrate_backends(
            backends, xb, iters=cfg.calibration_iters, device=self.device)
        best = min(self.calibration, key=self.calibration.get)
        if not np.isfinite(self.calibration[best]):
            raise RuntimeError(f"no usable backend: {self.calibration}")
        return best

    # -------------------------------------------------------------- hot-swap

    @property
    def generation(self) -> int:
        return self._generation

    def swap_estimator(self, est: ExtraTreesRegressor, *,
                       calibration_X: np.ndarray | None = None) -> int:
        """Atomically replace the fitted forest; returns the new generation.

        Safe to call while ``predict`` / ``predict_async`` traffic is in
        flight: requests already snapshotted keep the OLD model (their whole
        batch is uniformly old-generation); requests arriving after the swap
        see the new one. The feature cache is invalidated, and any in-flight
        batch of the superseded generation is barred from writing back.

        Backend construction (flattening/densifying the new forest) happens
        OUTSIDE the engine lock — serving never stalls on a refit. The
        current backend choice is kept when the new forest supports it;
        otherwise selection reruns over the new backend table.
        """
        if not est.trees_:
            raise ValueError("estimator is not fitted")
        if est.n_features_ != self.n_features:
            raise ValueError(
                f"feature-space mismatch: engine serves {self.n_features} "
                f"features, new estimator has {est.n_features_}")
        backends = self._build(est)
        if not backends:
            raise RuntimeError("no backend could be built")
        name = (self.backend if self.backend in backends
                else self._select(backends, calibration_X))
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            self.est = est
            self._backends = backends
            self.backend = name
            self._predict_fn = backends[name]
            self._cache.clear()
            self._generation += 1
            self.stats.generation = self._generation
            self.stats.swaps += 1
            self.stats.trees_lost = 0   # a swap serves a full fresh forest
            return self._generation

    # ------------------------------------------------------------ sync batch

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Cache-aware batched prediction. (B, F) -> (B,) float64.

        Generation-uniform: every row of the returned batch is answered by
        the SAME model generation (the one current when the call entered),
        even if a hot-swap lands mid-call.
        """
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        B = X.shape[0]
        out = np.empty(B, dtype=np.float64)
        if B == 0:
            return out
        use_cache = self.config.cache_size > 0

        miss_rows: dict[bytes, list[int]] = {}
        with self._cond:
            # snapshot (generation, backend) under the same lock that guards
            # cache reads: cache entries always belong to the snapshot
            # generation (swap clears the cache while holding this lock).
            gen = self._generation
            predict_fn = self._predict_fn
            for i in range(B):
                key = X[i].tobytes()
                if use_cache and key in self._cache:
                    self._cache.move_to_end(key)
                    out[i] = self._cache[key]
                    self.stats.cache_hits += 1
                else:
                    # duplicate uncached rows in one batch share one
                    # backend row (portability: same features, same answer)
                    miss_rows.setdefault(key, []).append(i)
                    self.stats.cache_misses += 1
            self.stats.predictions += B

        if miss_rows:
            rows = [idxs[0] for idxs in miss_rows.values()]
            y = np.asarray(predict_fn(X[rows]), dtype=np.float64)
            with self._cond:
                self.stats.batches += 1
                self.stats.backend_rows += len(rows)
                # a swap may have landed while the backend ran: the answers
                # are still served (uniformly from the OLD generation), but
                # must not repopulate the new generation's cache.
                write_cache = use_cache and gen == self._generation
                for (key, idxs), yi in zip(miss_rows.items(), y):
                    out[idxs] = yi
                    if write_cache:
                        self._cache[key] = float(yi)
                        self._cache.move_to_end(key)
                while write_cache and len(self._cache) > self.config.cache_size:
                    self._cache.popitem(last=False)
        return out

    # ----------------------------------------------------------- async single

    def predict_async(self, x: np.ndarray) -> Future:
        """Enqueue one feature vector; resolves to float. Cache hits resolve
        immediately; misses ride the next micro-batch flush."""
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
        if x.shape[0] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, "
                             f"got {x.shape[0]}")
        key = x.tobytes()
        fut: Future = Future()
        flush_now = False
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            self.stats.requests += 1
            if self.config.cache_size > 0 and key in self._cache:
                self._cache.move_to_end(key)
                self.stats.cache_hits += 1
                self.stats.predictions += 1
                fut.set_result(self._cache[key])
                return fut
            self._pending.append(_Pending(key, x, fut, time.monotonic()))
            if len(self._pending) >= self.config.max_batch:
                flush_now = True
            else:
                self._ensure_worker()
                self._cond.notify()
        if flush_now:
            self._flush("size")
        return fut

    def flush(self) -> int:
        """Force pending requests out now; returns how many were flushed."""
        return self._flush("manual")

    def _flush(self, reason: str) -> int:
        with self._cond:
            batch, self._pending = self._pending, []
            if not batch:
                return 0
            self.stats.__dict__[f"flushes_{reason}"] += 1
        X = np.stack([p.x for p in batch])
        try:
            y = self.predict(X)          # cache-aware, generation-uniform
        except Exception as exc:         # propagate to every waiter
            for p in batch:
                p.future.set_exception(exc)
            return len(batch)
        for p, yi in zip(batch, y):
            p.future.set_result(float(yi))
        return len(batch)

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="forest-engine-flush",
                daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        delay = self.config.max_delay_ms / 1e3
        while True:
            with self._cond:
                if self._closed:
                    return
                if not self._pending:
                    # no poll needed: predict_async notifies on every append
                    # and close() notifies all
                    self._cond.wait()
                    continue
                remaining = self._pending[0].t + delay - time.monotonic()
                if remaining > 0:
                    self._cond.wait(timeout=remaining)
                    continue
            self._flush("deadline")

    # --------------------------------------------------------- observability

    def stats_snapshot(self) -> EngineStats:
        """Atomic copy of the stats under the engine lock.  Fields are
        mutated one at a time during predict/flush, so field-by-field
        reads from another thread can see torn totals; this is the
        consistent read (``EngineStats`` holds only scalars, so a shallow
        dataclass copy is a deep one)."""
        with self._cond:
            return EngineStats(**self.stats.__dict__)

    def register_metrics(self, registry, **labels: str) -> None:
        """Expose the engine through an ``obs.MetricsRegistry``.  All lazy
        callbacks (scrape-time reads of the stats object) — the predict
        hot path is untouched.  ``labels`` (e.g. ``replica="r0"``) keep
        multiple engines distinct in one registry."""
        for name in ("requests", "predictions", "cache_hits",
                     "cache_misses", "backend_rows", "batches",
                     "flushes_size", "flushes_deadline", "flushes_manual",
                     "swaps", "shard_drops", "trees_lost"):
            registry.register_fn(f"engine.{name}",
                                 lambda n=name: getattr(self.stats, n),
                                 kind="counter", **labels)
        registry.register_fn("engine.generation",
                             lambda: self.stats.generation, **labels)
        registry.register_fn("engine.hit_rate",
                             lambda: self.stats.hit_rate(), **labels)
        registry.register_fn("engine.cache_len", self.cache_len, **labels)

    # ------------------------------------------------------------- lifecycle

    def cache_len(self) -> int:
        with self._cond:
            return len(self._cache)

    def cache_clear(self) -> None:
        with self._cond:
            self._cache.clear()

    def close(self) -> None:
        """Shut down. Idempotent, and safe to race with ``predict_async``:
        a request either lands before the close (and is flushed here) or
        observes ``_closed`` under the lock and raises. The flush worker is
        joined with a bounded wait; if it is mid-flush on a slow backend it
        finishes resolving that batch's futures and exits on its own (it is
        a daemon and can enqueue no new work once ``_closed`` is set)."""
        with self._cond:
            first = not self._closed
            self._closed = True
            worker, self._worker = self._worker, None
            self._cond.notify_all()
        if first:
            self._flush("manual")
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout=5.0)

    def __enter__(self) -> "ForestEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------- multi-device frontend

class MultiDeviceEngine:
    """Per-(device-type, target) engines behind one pricing call.

    ``engines`` maps device name -> {"time_us": ForestEngine,
    "power_w": ForestEngine | None}; ``price(X)`` returns the full
    (n_kernels, n_devices) time and power matrices using one batched engine
    call per (device, target) — the features are device-independent, so the
    SAME X prices every device.

    ``freq_scales`` (device name -> relative DVFS operating point, 1.0 =
    the clock the forests were trained at) PINS a device to one frequency;
    ``freq_grids`` (device name -> discrete frequency tuple, e.g.
    ``DeviceModel.freq_grid``) instead offers the scheduler a grid to
    choose from per assignment, and ``power_splits`` (device name ->
    ``core.power.PowerSplit``) replaces the assumed-cubic power scaling
    with the fitted idle/dynamic split. Pricing the full
    (kernels × devices × frequencies) tensor still costs ONE batched
    backend call per (device, target): operating points are transforms of
    the nominal prediction (see ``core/scheduler.predict_operating_points``).
    """

    TIME, POWER = "time_us", "power_w"

    def __init__(self, engines: dict[str, dict], *, log_time: bool = True,
                 counts: dict[str, int] | None = None,
                 freq_scales: dict[str, float] | None = None,
                 freq_grids: dict[str, tuple] | None = None,
                 power_splits: dict[str, object] | None = None):
        if not engines:
            raise ValueError("no device engines")
        self.engines = engines
        self.log_time = log_time
        self.counts = counts or {}
        self.freq_scales = freq_scales or {}
        self.freq_grids = freq_grids or {}
        self.power_splits = power_splits or {}

    @classmethod
    def from_fits(cls, fits: dict[str, tuple], *, log_time: bool = True,
                  counts: dict[str, int] | None = None,
                  freq_scales: dict[str, float] | None = None,
                  freq_grids: dict[str, tuple] | None = None,
                  power_splits: dict[str, object] | None = None,
                  config: EngineConfig | None = None) -> "MultiDeviceEngine":
        """``fits``: device name -> (time_estimator, power_estimator|None)."""
        engines = {}
        for name, (est_t, est_p) in fits.items():
            engines[name] = {
                cls.TIME: ForestEngine(est_t, config),
                cls.POWER: ForestEngine(est_p, config) if est_p else None,
            }
        return cls(engines, log_time=log_time, counts=counts,
                   freq_scales=freq_scales, freq_grids=freq_grids,
                   power_splits=power_splits)

    @property
    def device_names(self) -> list[str]:
        return list(self.engines)

    def price(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(n_kernels, n_devices) predicted time_us and power_w at each
        device's pinned operating point — the same matrix the scheduler
        builds (single source of pricing semantics)."""
        from ..core.scheduler import predict_matrix
        X = np.ascontiguousarray(X, dtype=np.float32)
        return predict_matrix(X, self.to_device_predictors())

    def price_operating_points(self, X: np.ndarray, *,
                               deadline_s: float | None = None):
        """The full (kernels × devices × frequencies) pricing tensor plus
        per-device grids — what per-assignment frequency selection
        consumes. Returns ``(T, P, grids)`` (see
        ``core/scheduler.predict_operating_points``)."""
        from ..core.scheduler import predict_operating_points
        X = np.ascontiguousarray(X, dtype=np.float32)
        return predict_operating_points(X, self.to_device_predictors(),
                                        deadline_s=deadline_s)

    def to_device_predictors(self) -> list:
        """Adapt to the scheduler's DevicePredictor list (engines plug in
        wherever a callable predictor was expected)."""
        from ..core.scheduler import DevicePredictor
        return [
            DevicePredictor(name, per[self.TIME], per.get(self.POWER),
                            log_time=self.log_time,
                            count=self.counts.get(name, 1),
                            freq_scale=self.freq_scales.get(name, 1.0),
                            freq_grid=self.freq_grids.get(name),
                            power_split=self.power_splits.get(name))
            for name, per in self.engines.items()
        ]

    # -------------------------------------------------------------- hot-swap

    def add_device(self, name: str, time_engine, power_engine=None, *,
                   count: int = 1, freq_scale: float | None = None,
                   freq_grid: tuple | None = None,
                   power_split=None) -> None:
        """Admit a NEW device type into the pricing matrix mid-serve.

        This is the graduation endpoint: a device that arrived unseen and
        was served behind the frontend by the cold-start transfer tier
        enters the scheduler's (kernels × devices) matrix here, priced by
        its freshly fitted engines. ``time_engine`` must produce log-time
        when the frontend runs ``log_time=True`` (a graduated
        ``TransferPredictor.to_forest()`` fit does).

        Lock-free swap discipline: the engine/count/grid tables are
        REPLACED (copy + rebind), never mutated in place, so a concurrent
        ``price``/``to_device_predictors`` iterating the old tables sees a
        consistent pre-admission matrix and the next call sees the device.
        """
        if name in self.engines:
            raise ValueError(f"device {name!r} already priced "
                             f"(have {self.device_names})")
        self.engines = {**self.engines,
                        name: {self.TIME: time_engine,
                               self.POWER: power_engine}}
        if count != 1:
            self.counts = {**self.counts, name: int(count)}
        if freq_scale is not None:
            self.freq_scales = {**self.freq_scales, name: float(freq_scale)}
        if freq_grid is not None:
            self.freq_grids = {**self.freq_grids, name: tuple(freq_grid)}
        if power_split is not None:
            self.power_splits = {**self.power_splits, name: power_split}

    def swap_fits(self, fits: dict[str, tuple]) -> dict[str, int]:
        """Hot-swap refreshed forests into the live per-device engines.

        ``fits``: device name -> (time_estimator, power_estimator|None);
        devices absent from ``fits`` keep serving their current forests.
        Returns {device: new time-engine generation}.

        Every (device, estimator) pair is validated BEFORE any engine is
        touched, so a bad fit rejects the whole batch and no device is left
        serving a different generation than its peers.
        """
        for name, (est_t, est_p) in fits.items():
            per = self.engines.get(name)
            if per is None:
                raise KeyError(f"unknown device {name!r} "
                               f"(have {self.device_names})")
            for est, eng in ((est_t, per[self.TIME]),
                             (est_p, per.get(self.POWER))):
                if est is None or eng is None:
                    continue
                if not est.trees_:
                    raise ValueError(f"estimator for {name!r} is not fitted")
                if est.n_features_ != eng.n_features:
                    raise ValueError(
                        f"feature-space mismatch for {name!r}: engine "
                        f"serves {eng.n_features}, got {est.n_features_}")
        gens: dict[str, int] = {}
        for name, (est_t, est_p) in fits.items():
            per = self.engines[name]
            gens[name] = per[self.TIME].swap_estimator(est_t)
            if est_p is not None and per.get(self.POWER) is not None:
                per[self.POWER].swap_estimator(est_p)
        return gens

    def generations(self) -> dict[str, int]:
        return {name: per[self.TIME].generation
                for name, per in self.engines.items()}

    def close(self) -> None:
        for per in self.engines.values():
            for eng in per.values():
                if eng is not None:
                    eng.close()
