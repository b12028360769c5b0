"""Background forest refresher: streaming measurements in, hot-swaps out
(a copy of ``repro.serve.refresh`` over the port's engines).

Closes the loop the papers argue for — Stevens & Klöckner (1904.09538):
cross-machine models stay accurate only when retrained against fresh
measurements; Wang & Chu (1701.05308): predictions must track the device's
operating state. The one-shot ``collect() -> fit() -> ForestEngine(est)``
flow cannot ingest new ground truth; this refresher can, while serving:

    DatasetStore (versioned, fed by workloads/stream.StreamingCollector)
        └─ EngineRefresher: on each NEW snapshot version
             1. refit forests on the capped snapshot (off the serving lock),
             2. atomically ``swap_estimator`` / ``swap_fits`` them into the
                live ForestEngine / MultiDeviceEngine (generation bump,
                cache invalidation; in-flight batches stay uniform).

``refresh_once()`` is the synchronous unit (used directly by tests and by
anyone running their own loop); ``start()`` runs it on a poll thread.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..core.dataset import Dataset, DatasetStore

__all__ = ["EngineRefresher", "RefreshStats"]


@dataclass
class RefreshStats:
    refreshes: int = 0             # completed refit + swap cycles
    skipped: int = 0               # polls with no new version / too few rows
    drift_skipped: int = 0         # new version, but calibration in envelope
    drift_refreshes: int = 0       # refreshes triggered while drifted
    errors: int = 0
    last_version: int = -1         # store version of the serving forests
    failed_version: int = -1       # store version whose refit/swap raised
    generations: dict = field(default_factory=dict)


class EngineRefresher:
    """Refit-on-snapshot + atomic hot-swap for a live engine.

    ``engine`` is a ``ForestEngine`` (incl. ``ShardedForestEngine``) or a
    ``MultiDeviceEngine``; ``fit_fn(dataset)`` returns whatever the engine's
    swap hook takes — a fitted estimator for a single engine, or a
    ``{device: (time_est, power_est|None)}`` dict for the multi-device
    frontend. The fit runs on the refresher thread; the engine keeps serving
    the old generation until the swap instant.

    ``drift_signal`` (optional) is a zero-arg callable — typically
    ``obs.CalibrationMonitor.drift_signal(threshold_pct)`` — that gates
    refits on OBSERVED model error: while live MAPE stays inside the
    calibrated envelope, new store versions are skipped (counted in
    ``stats.drift_skipped``) instead of churning refit + swap on every
    append; once the signal fires, the next new version refits as usual
    (``stats.drift_refreshes``). Without it, behavior is unchanged:
    every new version refits.
    """

    def __init__(self, store: DatasetStore, engine, fit_fn, *,
                 min_samples: int = 2, poll_s: float = 0.05,
                 drift_signal=None):
        self.store = store
        self.engine = engine
        self.fit_fn = fit_fn
        self.min_samples = min_samples
        self.poll_s = poll_s
        self.drift_signal = drift_signal
        self.stats = RefreshStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def register_metrics(self, registry) -> None:
        """Expose refresher counters through an ``obs.MetricsRegistry``
        (lazy scrape-time reads; the refit loop is untouched).

        Every ``register_fn`` call PINS its ``kind`` explicitly: version
        marks start at -1 and reset on restart, so they must scrape as
        gauges — a counter-typed series would be rejected by rate() and
        misread on reset. ``tests/test_supervise.py`` renders the
        Prometheus exposition and asserts the TYPE line of every refresh
        metric, so a kind regression fails CI, not a dashboard."""
        for name in ("refreshes", "skipped", "drift_skipped",
                     "drift_refreshes", "errors"):
            registry.register_fn(f"refresh.{name}",
                                 lambda n=name: getattr(self.stats, n),
                                 kind="counter")
        for name in ("last_version", "failed_version"):
            registry.register_fn(f"refresh.{name}",
                                 lambda n=name: getattr(self.stats, n),
                                 kind="gauge")

    # ------------------------------------------------------------ one cycle

    def refresh_once(self) -> int | None:
        """Refit + swap if the store advanced; returns the new store version
        served, or None if nothing changed (or not enough samples yet).
        Exceptions from the refit/swap propagate to the caller; the version
        that raised is remembered and NOT retried until the store advances
        (a deterministically bad snapshot must not become a refit hot-loop)."""
        if self.store.version in (self.stats.last_version,
                                  self.stats.failed_version):
            self.stats.skipped += 1
            return None
        drifted = None
        if self.drift_signal is not None:
            drifted = bool(self.drift_signal())
            if not drifted:
                # new data, but the live model is still inside its error
                # envelope: don't churn a refit + swap for every append
                self.stats.drift_skipped += 1
                return None
        snap = self.store.snapshot()
        if len(snap.dataset) < self.min_samples:
            self.stats.skipped += 1
            return None
        try:
            fits = self.fit_fn(snap.dataset)
            swap_fits = getattr(self.engine, "swap_fits", None)
            if swap_fits is not None:
                self.stats.generations = swap_fits(fits)
            else:
                gen = self.engine.swap_estimator(fits)
                self.stats.generations = {"engine": gen}
        except Exception:
            self.stats.errors += 1
            self.stats.failed_version = snap.version
            raise
        self.stats.last_version = snap.version
        self.stats.refreshes += 1
        if drifted:
            self.stats.drift_refreshes += 1
        return snap.version

    # ------------------------------------------------------------ background

    def start(self) -> "EngineRefresher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="engine-refresher", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh_once()
            except Exception:
                # a bad refit must never take the serving path down: the
                # engine keeps answering from the last good generation, and
                # refresh_once blacklists the failed version so this is not
                # a refit hot-loop (stats.errors counts the failures)
                pass
            self._stop.wait(self.poll_s)

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "EngineRefresher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def single_device_fit_fn(device: str, *, target: str = "time_us",
                         log_target: bool = True, n_estimators: int = 32,
                         seed: int = 0):
    """Convenience ``fit_fn`` for one (device, target) ForestEngine."""
    import numpy as np

    from ..core.forest import ExtraTreesRegressor

    def fit(ds: Dataset):
        X, y, _ = ds.matrix(device, target)
        if X.shape[0] == 0:
            raise ValueError(f"no samples for {device}/{target}")
        y = np.log(np.maximum(y, 1e-12)) if log_target else y
        return ExtraTreesRegressor(n_estimators=n_estimators, seed=seed).fit(
            X.astype(np.float32), y)
    return fit
