"""Lock-cheap metrics registry: counters, gauges, fixed-bucket histograms.

One process-wide (or per-server) :class:`MetricsRegistry` that every serving
layer registers into.  Three cost tiers, cheapest first:

* ``register_fn`` **lazy metrics** — a callable evaluated only at scrape
  time.  Zero hot-path cost; this is how per-component stats objects
  (``FrontendStats``, ``EngineStats``, ``PoolStats``...) are exposed
  without adding a single instruction to dispatch.
* **counters / gauges** — one short ``threading.Lock`` acquire per update.
* **histograms** — fixed log-spaced buckets; ``observe`` is a ``bisect``
  plus two adds under the metric's own lock.  Percentiles (p50/p95/p99)
  are *estimated* by linear interpolation inside the bucket, the classic
  Prometheus ``histogram_quantile`` scheme.

A :class:`Reservoir` (Algorithm R, seeded) complements histograms where
exact whole-run-representative percentiles are wanted from bounded memory
(``ClusterFrontend.latency_summary``).

Metric names follow the bench-row convention already used across the repo
(``latency.*`` rows): lowercase dotted paths, e.g. ``frontend.served`` or
``engine.cache_hits``.  Labels are a small dict (``device=...``,
``tenant=...``); the (name, labels) pair is the registry key.

A copy of ``repro.obs.registry``: the same updates give the same
Prometheus exposition, byte for byte (the ``repro_`` name prefix included).
"""
from __future__ import annotations

import math
import random
import threading
from bisect import bisect_right, insort
from dataclasses import dataclass, field
from typing import Callable, Iterable

__all__ = [
    "Counter", "Gauge", "Histogram", "Reservoir", "Ewma",
    "MetricsRegistry", "DEFAULT_LATENCY_BUCKETS_S",
]

#: Log-spaced seconds buckets, 10us .. ~100s — covers everything from the
#: 3.3us/row wire overhead to saturated queue waits.
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = tuple(
    10.0 ** (e / 2.0) for e in range(-10, 5)
)


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` is one lock acquire + add."""

    kind = "counter"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile estimation.

    ``buckets`` are upper bounds (ascending); an implicit +inf bucket
    catches the tail.  ``percentile`` walks the cumulative counts to the
    target rank and interpolates linearly inside the landing bucket —
    exact enough for p50/p95/p99 monitoring, constant memory regardless
    of traffic.
    """

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_S):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +1: overflow
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        i = bisect_right(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Estimated ``p``-th percentile (p in [0, 100])."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile out of range: {p}")
        with self._lock:
            n = self._n
            counts = list(self._counts)
        if n == 0:
            return float("nan")
        rank = p / 100.0 * n
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])   # clamp +inf tail to top edge
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._n
        row = {"count": n, "sum": s,
               "buckets": {str(b): c
                           for b, c in zip(self.buckets, counts)},
               "overflow": counts[-1]}
        for p in (50.0, 95.0, 99.0):
            row[f"p{p:g}"] = self.percentile(p)
        return row


class Reservoir:
    """Algorithm-R reservoir: a bounded, uniformly-representative sample
    of everything ever offered, with exact percentiles over the sample.

    Unlike a sliding window (last-N), the reservoir stays representative
    of the *whole run*, so reported percentiles are stable on long runs
    instead of tracking the most recent burst.  Seeded for reproducible
    tests; memory is O(capacity) forever.
    """

    def __init__(self, capacity: int = 2048, seed: int = 0) -> None:
        if capacity <= 0:
            raise ValueError("reservoir capacity must be positive")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._sample: list[float] = []
        self._sorted: list[float] = []
        self._n_seen = 0
        self._lock = threading.Lock()

    def offer(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._n_seen += 1
            if len(self._sample) < self.capacity:
                self._sample.append(v)
                insort(self._sorted, v)
                return
            j = self._rng.randrange(self._n_seen)
            if j < self.capacity:
                old = self._sample[j]
                self._sample[j] = v
                # keep the sorted mirror in lockstep: O(capacity) but only
                # capacity/n of offers land here once the reservoir is full
                k = bisect_right(self._sorted, old) - 1
                self._sorted.pop(k)
                insort(self._sorted, v)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sample)

    @property
    def n_seen(self) -> int:
        with self._lock:
            return self._n_seen

    def values(self) -> list[float]:
        with self._lock:
            return list(self._sample)

    def percentile(self, p: float) -> float:
        """Exact percentile over the current sample (p in [0, 100]),
        linear interpolation between closest ranks (numpy default)."""
        with self._lock:
            srt = self._sorted
            if not srt:
                return float("nan")
            if len(srt) == 1:
                return srt[0]
            rank = p / 100.0 * (len(srt) - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(srt) - 1)
            frac = rank - lo
            return srt[lo] * (1.0 - frac) + srt[hi] * frac


class Ewma:
    """Exponentially-weighted moving average (the StepMonitor smoothing,
    factored out so calibration MAPE and straggler detection share it)."""

    def __init__(self, alpha: float = 0.1) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha out of (0, 1]: {alpha}")
        self.alpha = float(alpha)
        self.value: float | None = None
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else (
            self.alpha * x + (1.0 - self.alpha) * self.value)
        self.n += 1
        return self.value


@dataclass
class _LazyMetric:
    fn: Callable[[], float]
    kind: str = "gauge"


@dataclass
class MetricsRegistry:
    """Get-or-create registry keyed on (name, labels).

    ``register_fn`` metrics are evaluated lazily at ``snapshot``/render
    time — a callable that raises is reported as NaN rather than taking
    the scrape down with it.
    """

    _metrics: dict[tuple[str, tuple[tuple[str, str], ...]],
                   Counter | Gauge | Histogram | _LazyMetric] = field(
        default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _get_or_create(self, name: str, labels: dict[str, str],
                       factory: Callable[[], object], cls: type):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m       # type: ignore[assignment]
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(labels)!r} already registered "
                    f"as {type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(name, labels, Counter, Counter)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get_or_create(name, labels, Gauge, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_S,
                  **labels: str) -> Histogram:
        return self._get_or_create(
            name, labels, lambda: Histogram(buckets), Histogram)

    def register_fn(self, name: str, fn: Callable[[], float], *,
                    kind: str = "gauge", **labels: str) -> None:
        """Register a zero-cost lazy metric: ``fn`` runs at scrape time
        only.  Re-registering the same (name, labels) replaces the
        callable (components may be re-created, e.g. engine hot-swap)."""
        key = (name, _label_key(labels))
        with self._lock:
            self._metrics[key] = _LazyMetric(fn, kind)

    def unregister(self, name: str, **labels: str) -> None:
        with self._lock:
            self._metrics.pop((name, _label_key(labels)), None)

    # ------------------------------------------------------- exposition

    def snapshot(self) -> list[dict]:
        """Stable-ordered list of ``{"name", "labels", "kind", ...}``
        rows — the payload behind ``op="metrics"`` and ``--stats``."""
        with self._lock:
            items = sorted(self._metrics.items())
        rows: list[dict] = []
        for (name, lkey), m in items:
            row: dict = {"name": name, "labels": dict(lkey)}
            if isinstance(m, Histogram):
                row["kind"] = "histogram"
                row.update(m.snapshot())
            elif isinstance(m, _LazyMetric):
                row["kind"] = m.kind
                try:
                    row["value"] = float(m.fn())
                except Exception:
                    row["value"] = float("nan")
            else:
                row["kind"] = m.kind
                row["value"] = m.value
            rows.append(row)
        return rows

    def render_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4).  Dots become underscores;
        histograms emit ``_bucket``/``_sum``/``_count`` plus estimated
        quantile gauges so dashboards get p50/p95/p99 without PromQL."""
        lines: list[str] = []
        seen_types: set[str] = set()

        def base(name: str) -> str:
            return "repro_" + name.replace(".", "_").replace("-", "_")

        def fmt_labels(labels: dict[str, str],
                       extra: dict[str, str] | None = None) -> str:
            merged = dict(labels)
            if extra:
                merged.update(extra)
            if not merged:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
            return "{" + inner + "}"

        for row in self.snapshot():
            name, labels = base(row["name"]), row["labels"]
            if row["kind"] == "histogram":
                if name not in seen_types:
                    lines.append(f"# TYPE {name} histogram")
                    seen_types.add(name)
                cum = 0
                for b, c in row["buckets"].items():
                    cum += c
                    lines.append(f"{name}_bucket"
                                 f"{fmt_labels(labels, {'le': b})} {cum}")
                cum += row["overflow"]
                lines.append(f"{name}_bucket"
                             f"{fmt_labels(labels, {'le': '+Inf'})} {cum}")
                lines.append(f"{name}_sum{fmt_labels(labels)} "
                             f"{row['sum']:.9g}")
                lines.append(f"{name}_count{fmt_labels(labels)} "
                             f"{row['count']}")
                for p in ("p50", "p95", "p99"):
                    q = row[p]
                    if q == q:   # skip NaN quantiles on empty histograms
                        lines.append(f"{name}_{p}{fmt_labels(labels)} "
                                     f"{q:.9g}")
            else:
                if name not in seen_types:
                    lines.append(f"# TYPE {name} {row['kind']}")
                    seen_types.add(name)
                lines.append(f"{name}{fmt_labels(labels)} "
                             f"{row['value']:.9g}")
        return "\n".join(lines) + "\n"
