"""Prediction-latency measurement (paper §6.1/§6.2, Tables 4 & 5).

The paper measures 15–108 ms per single prediction on a Xeon E5-2667v3 and
argues (§7.1) this bounds the schedulers the model can serve. This module
measures the same quantity for every inference path of the port:

  * ``tree-walk``   : per-tree numpy traversal (the paper's deployment path)
  * ``flat-numpy``  : vectorized flattened-forest numpy
  * ``flat-torch``  : exact gather traversal in torch
  * ``dense-torch`` : complete-tree layout, plain torch (the kernel's oracle)
  * ``hopper``      : the CUDA forest kernel (``kernels/forest``)

On a CUDA device every timing synchronises the card before it reads the
host clock, so a time covers the device's work and not just its enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

#: Paths that run on the host whatever the engine's device. When one of
#: them fails, calibration scores it +inf; any other path that fails
#: raises, so a CUDA engine never scores its kernel away.
HOST_PATHS = ("tree-walk", "flat-numpy")


@dataclass
class LatencyResult:
    name: str
    single_ms: float          # one sample, one prediction (paper's metric)
    batch_us_per_sample: float
    batch_size: int


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, x, warmup: int = 1, iters: int = 3, device=None) -> float:
    """Seconds per ``fn(x)`` call; synchronises ``device`` when it is CUDA."""
    for _ in range(warmup):
        fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def calibrate_backends(fns: dict, x_batch: np.ndarray, warmup: int = 1,
                       iters: int = 3, device=None) -> dict[str, float]:
    """Self-calibration pass for the serving engine: time every candidate
    inference path on one flush-sized batch (the engine's unit of work) and
    return {name: seconds}. A host path (``HOST_PATHS``) that fails scores
    +inf; a failure of any other path raises."""
    scores: dict[str, float] = {}
    for name, fn in fns.items():
        try:
            scores[name] = time_call(fn, x_batch, warmup=warmup, iters=iters,
                                     device=device)
        except Exception:
            if name not in HOST_PATHS:
                raise
            scores[name] = float("inf")
    return scores


def _bench(fn, x_single, x_batch, device, warmup: int = 3,
           iters: int = 20) -> tuple[float, float]:
    single_ms = time_call(fn, x_single, warmup, iters, device) * 1e3
    batch_us = (time_call(fn, x_batch, 2, iters, device)
                / x_batch.shape[0] * 1e6)
    return single_ms, batch_us


def measure_paths(est, X: np.ndarray, batch: int = 256,
                  dense_depth: int = 10, device="cuda",
                  ) -> list[LatencyResult]:
    """Single-prediction and batched latency of every path an engine on
    ``device`` can serve (the host paths run on the host either way)."""
    from ..serve.backend import build_backends

    rng = np.random.default_rng(0)
    x1 = X[:1]
    xb = X[rng.integers(0, X.shape[0], size=batch)]
    fns = build_backends(est, dense_depth=dense_depth, device=device)
    out: list[LatencyResult] = []
    for name, fn in fns.items():
        s, b = _bench(fn, x1, xb, device)
        out.append(LatencyResult(name, s, b, batch))
    return out
