"""Live calibration monitoring: the paper's MAPE, measured on real traffic.

The source paper reports 8.86-52% execution-time MAPE and 1.84-2.94%
power MAPE (Tables 4/5) from *offline* cross-validation.  In production
the question is "what is the model's error *right now*, on *this*
traffic?" — so :class:`CalibrationMonitor` folds every
(predicted, measured) pair into rolling per-``(device, target)`` EWMA
MAPE gauges, with a per-kernel breakdown, and exposes a *drift signal*
that ``EngineRefresher`` polls to trigger a refit when live error leaves
the calibrated envelope.

The EWMA is the same smoothing ``runtime/monitor.py`` uses for straggler
detection (:class:`repro_torch.obs.registry.Ewma` is the shared
implementation), so one alpha convention covers both.

A copy of ``repro.obs.calibration``.
"""
from __future__ import annotations

import threading
from typing import Callable

from .registry import Ewma, MetricsRegistry

__all__ = ["CalibrationMonitor"]


class CalibrationMonitor:
    """Rolling MAPE per (device, target) with per-kernel breakdown.

    ``record(device, target, predicted, measured)`` folds one
    absolute-percentage-error sample into the EWMA for that series and
    mirrors it into registry gauges::

        calibration.mape{device=..., target=time|power}   (percent)
        calibration.samples{device=..., target=...}       (counter)

    ``drift_signal(threshold)`` returns a zero-argument callable for
    ``EngineRefresher(drift_signal=...)``: True when any series' rolling
    MAPE exceeds ``threshold`` percent (after ``min_samples`` samples, so
    one unlucky first request can't force a refit).
    """

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 alpha: float = 0.1, min_samples: int = 8,
                 eps: float = 1e-12) -> None:
        self.registry = registry
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.eps = float(eps)
        self._series: dict[tuple[str, str], Ewma] = {}
        self._by_kernel: dict[tuple[str, str], dict[str, Ewma]] = {}
        self._lock = threading.Lock()

    def record(self, device: str, target: str, predicted: float,
               measured: float, *, kernel: str | None = None) -> float:
        """Fold one sample; returns the updated rolling MAPE (percent)."""
        measured = float(measured)
        ape = 100.0 * abs(float(predicted) - measured) / max(
            abs(measured), self.eps)
        key = (str(device), str(target))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = Ewma(self.alpha)
                self._by_kernel[key] = {}
            mape = series.update(ape)
            if kernel is not None:
                per_k = self._by_kernel[key]
                ew = per_k.get(kernel)
                if ew is None:
                    ew = per_k[kernel] = Ewma(self.alpha)
                ew.update(ape)
        if self.registry is not None:
            self.registry.gauge("calibration.mape", device=key[0],
                                target=key[1]).set(mape)
            self.registry.counter("calibration.samples", device=key[0],
                                  target=key[1]).inc()
        return mape

    # ---------------------------------------------------------- queries

    def mape(self, device: str, target: str) -> float | None:
        """Rolling MAPE (percent) for one series, None before any sample."""
        with self._lock:
            series = self._series.get((str(device), str(target)))
            return None if series is None else series.value

    def mape_by_kernel(self, device: str, target: str) -> dict[str, float]:
        with self._lock:
            per_k = self._by_kernel.get((str(device), str(target)), {})
            return {k: ew.value for k, ew in per_k.items()
                    if ew.value is not None}

    def series(self) -> dict[tuple[str, str], tuple[float, int]]:
        """All series as ``(device, target) -> (mape_percent, n)``."""
        with self._lock:
            return {k: (ew.value, ew.n) for k, ew in self._series.items()
                    if ew.value is not None}

    def over_threshold(self, thresholds: dict[str, float]
                       ) -> list[tuple[str, str, float]]:
        """Series whose rolling MAPE exceeds the per-TARGET threshold —
        ``thresholds`` maps target name (``time_us``/``power_w``) to a
        percent ceiling, e.g. the paper's offline envelope upper bounds
        (52 % time, 2.94 % power). Only series past ``min_samples`` count,
        mirroring :meth:`drifted`. Returns ``(device, target, mape)``
        sorted worst-first — the alert feed ``serve.supervise`` emits."""
        with self._lock:
            out = [(dev, tgt, ew.value)
                   for (dev, tgt), ew in self._series.items()
                   if tgt in thresholds and ew.n >= self.min_samples
                   and ew.value is not None and ew.value > thresholds[tgt]]
        return sorted(out, key=lambda row: -row[2])

    def drifted(self, threshold_pct: float) -> bool:
        """True when any series with enough samples exceeds the MAPE
        threshold — the condition the refresher polls."""
        with self._lock:
            return any(
                ew.n >= self.min_samples and ew.value is not None
                and ew.value > threshold_pct
                for ew in self._series.values())

    def drift_signal(self, threshold_pct: float) -> Callable[[], bool]:
        """A zero-arg callable for ``EngineRefresher(drift_signal=...)``."""
        return lambda: self.drifted(threshold_pct)
