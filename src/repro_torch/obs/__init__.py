"""repro_torch.obs — unified observability for the serving stack.

Three pillars, one bundle:

* :class:`MetricsRegistry` — lock-cheap counters/gauges/histograms plus
  zero-hot-path-cost lazy metrics (``register_fn``), rendered as a JSON
  snapshot (``op="metrics"``) or Prometheus text.
* :class:`Tracer` — distributed request tracing; trace context rides the
  existing v2/v3 frame meta (no protocol bump), server spans ship back in
  the reply so the client reconstructs the full cross-process tree.
* :class:`CalibrationMonitor` — live per-(device, target) MAPE with a
  drift signal ``EngineRefresher`` polls to trigger refits.

``Observability.default()`` builds the bundle most callers want; every
instrumented component takes ``obs=None`` and costs nothing when unset.

A copy of ``repro.obs``, its imports pointed at the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .calibration import CalibrationMonitor
from .registry import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Ewma,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
)
from .tracing import (
    Span,
    TraceContext,
    Tracer,
    ctx_from_meta,
    ctx_to_meta,
    new_span_id,
    new_trace_id,
)

__all__ = [
    "Observability",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Reservoir",
    "Ewma", "DEFAULT_LATENCY_BUCKETS_S",
    "Tracer", "Span", "TraceContext", "ctx_to_meta", "ctx_from_meta",
    "new_trace_id", "new_span_id",
    "CalibrationMonitor",
]


@dataclass
class Observability:
    """The bundle a server/frontend/example threads through its layers."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = field(default_factory=Tracer)
    calibration: CalibrationMonitor | None = None

    @classmethod
    def default(cls, *, slow_threshold_s: float | None = 0.25,
                alpha: float = 0.1) -> "Observability":
        registry = MetricsRegistry()
        return cls(
            registry=registry,
            tracer=Tracer(slow_threshold_s=slow_threshold_s),
            calibration=CalibrationMonitor(registry, alpha=alpha),
        )
