"""Step-time monitoring and straggler detection (the port of
``repro.runtime.monitor``): the paper's predictor used operationally.

``StepMonitor`` keeps an EWMA of measured step times and compares each step
with the smaller of two references: the predicted step time, where one is
given, and the EWMA itself. A run of ``patience`` steps slower than
``straggler_factor`` times that reference flags a straggler and calls
``on_straggler``. Detection is O(1) per step and adds no device work. The
reference's optional metrics-registry gauges come with the ``obs`` slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


class Ewma:
    """Exponentially weighted moving average (the reference's
    ``repro.obs.registry.Ewma``)."""

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
class StepMonitor:
    predicted_s: float | None = None      # predicted time of one step
    alpha: float = 0.1                    # EWMA coefficient
    straggler_factor: float = 2.0
    patience: int = 3                     # consecutive slow steps to flag
    on_straggler: Callable | None = None
    history: list = field(default_factory=list)
    _slow_streak: int = 0
    flagged: list = field(default_factory=list)
    _ewma: Ewma | None = None

    @property
    def ewma_s(self) -> float | None:
        return None if self._ewma is None else self._ewma.value

    def observe(self, step: int, seconds: float) -> dict:
        self.history.append((step, seconds))
        if self._ewma is None:
            self._ewma = Ewma(self.alpha)
        ewma = self._ewma.update(seconds)
        ref = min(x for x in (self.predicted_s, ewma) if x is not None)
        slow = seconds > self.straggler_factor * ref
        self._slow_streak = self._slow_streak + 1 if slow else 0
        event = None
        if self._slow_streak >= self.patience:
            event = {"step": step, "seconds": seconds, "reference_s": ref,
                     "ratio": seconds / ref}
            self.flagged.append(event)
            self._slow_streak = 0
            if self.on_straggler is not None:
                self.on_straggler(event)
        return {"step_s": seconds, "ewma_s": ewma,
                "predicted_s": self.predicted_s, "straggler": event}


class Timer:
    """Host clock around a ``with`` block; the block synchronises with the
    card itself where it must (e.g. by reading the loss)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
