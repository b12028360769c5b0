"""Backend layer of the serving stack: the ``PredictorBackend`` protocol and
``build_backends``, which turns one fitted forest into concrete inference
callables (counterpart of ``repro.serve.backend``).

  * ``PredictorBackend`` — a callable ``(B, F) float32 -> (B,) float64`` over
    a FIXED fitted forest. Backends are pure w.r.t. the model: the same X
    under the same backend instance always yields the same y (this is what
    makes the engine's feature-vector cache and the hot-swap generation
    logic sound). The CUDA kernel's reduction is deterministic for this
    reason.
  * ``build_backends`` — constructs the paths for one estimator on one
    device. On ``device="cuda"`` that is ``tree-walk`` and ``flat-numpy``
    (host numpy) and ``hopper`` (the CUDA kernel); the plain torch paths
    ``flat-torch`` and ``dense-torch`` are built only for ``device="cpu"``,
    where ``hopper`` takes the kernel's plain version.
  * ``ServingEngine`` — the engine-level contract the scheduler and the
    refresher duck-type against (predict / predict_async / swap_estimator /
    close / stats). ``cluster.remote.RemoteReplica`` satisfies it too: a
    pool member may live in another process or on another machine.
  * ``DeadlineAwarePredictor`` / ``supports_deadline`` — the optional
    extension for serving tiers: ``predict(X, deadline_s=..., priority=...)``
    lets a caller's remaining deadline slack order the admission queue
    (``core.scheduler.slack_priority``). The scheduler probes for it with
    ``supports_deadline`` and falls back to the plain call.
  * ``build_transfer_engine`` — the cold-start transfer tier
    (``core.transfer``) for a device the forests never trained on.
"""
from __future__ import annotations

import inspect
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..core.forest import ExtraTreesRegressor, predict_flat
from ..core.forest_torch import (DenseForestTorch, FlatForestTorch,
                                 resolve_device, to_dense)

BACKENDS = ("tree-walk", "flat-numpy", "flat-torch", "dense-torch", "hopper")

#: The plain torch paths, which an engine serves only on the CPU.
PLAIN_TORCH = ("flat-torch", "dense-torch")


@runtime_checkable
class PredictorBackend(Protocol):
    """One inference path over one fixed fitted forest."""

    def __call__(self, X: np.ndarray) -> np.ndarray:  # (B, F) -> (B,)
        ...


@runtime_checkable
class ServingEngine(Protocol):
    """What the scheduler / refresher / benchmarks require of an engine."""

    def predict(self, X: np.ndarray) -> np.ndarray: ...

    def swap_estimator(self, est: ExtraTreesRegressor) -> int: ...

    def close(self) -> None: ...


@runtime_checkable
class DeadlineAwarePredictor(Protocol):
    """A predictor whose serving tier can honor urgency: the remaining
    deadline budget rides along with the call (and over the wire as
    ``deadline_ms`` — see ``cluster/transport.py``), and ``priority=None``
    means "derive it from my slack" (``core.scheduler.slack_priority``)."""

    def predict(self, X: np.ndarray, *, deadline_s: float | None = ...,
                priority: int | None = ...) -> np.ndarray: ...


def supports_deadline(fn) -> bool:
    """True when ``fn`` (a ``predict`` method or bare callable) accepts a
    ``deadline_s`` keyword — how ``core.scheduler._predict`` decides whether
    to thread its remaining slack through. Signature inspection, not
    try/except: a TypeError raised INSIDE a predictor must surface, not be
    mistaken for an unsupported keyword."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False                  # builtins/ufuncs: no visible signature
    params = sig.parameters
    if "deadline_s" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def calibration_rows(n_rows: int, n_features: int,
                     seed: int = 0) -> np.ndarray:
    """Feature-shaped rows for timing backends / probing replicas: the
    features are non-negative and heavy-tailed (§3.1); for pure timing the
    distribution is irrelevant, only the shapes are. One definition so the
    engine's auto-calibration and the cluster tier's health probes can
    never drift apart."""
    rng = np.random.default_rng(seed)
    return rng.lognormal(1.0, 1.5,
                         size=(n_rows, n_features)).astype(np.float32)


def _numpy_io(fn, device: torch.device) -> PredictorBackend:
    """Serve a torch path: rows go to ``device``, answers come back as
    float64 numpy (the copy back waits for the device)."""
    def run(X):
        x = torch.as_tensor(np.ascontiguousarray(X, dtype=np.float32),
                            device=device)
        return fn(x).cpu().numpy().astype(np.float64)
    return run


def build_transfer_engine(device, *, target: str = "time_us", monitor=None,
                          config=None, log_output: bool = False):
    """Serve a device the forests never trained on, IMMEDIATELY.

    Returns a ``core.transfer.TransferPredictor`` — the cold-start hybrid
    (spec-sheet analytical prior, least-squares-refitted per observation,
    with a forest on its log-residuals once ≥ ``config.min_forest_samples``
    probes accumulate). It duck-types the serving surface (``predict`` /
    ``close`` / ``n_features`` / ``stats_snapshot``), so it can:

      * sit in a ``ReplicaPool`` behind ``ClusterFrontend`` like any engine
        (health probes use :func:`calibration_rows`, which it prices fine),
      * fill a device slot in ``MultiDeviceEngine`` — pass
        ``log_output=True`` there, matching ``log_time=True`` forests,
      * graduate into a ``ForestEngine`` later:
        ``engine.swap_estimator(predictor.to_forest())`` once the device
        has enough samples for a full per-device forest.

    ``monitor=`` (a ``CalibrationMonitor``) makes every ``observe(x, y)``
    record the pre-update prediction, so ``calibration.mape{device}`` is
    the live convergence gauge for the new device.

    ``device`` may be a ``DeviceModel``, a known device name, or an UNKNOWN
    name (the generic mid-range prior is used until ``calibrate(device=...)``
    re-targets it).
    """
    from ..core.transfer import TransferPredictor
    return TransferPredictor(device, target=target, config=config,
                             monitor=monitor, log_output=log_output)


def build_backends(est: ExtraTreesRegressor, *, dense_depth: int = 10,
                   only=None, device: str | torch.device = "cuda",
                   ) -> dict[str, PredictorBackend]:
    """{name: fn(X float32 (B,F)) -> (B,) float64} for every requested path.

    ``only=None`` builds every path the device serves. ``dense_depth`` caps
    the dense/kernel embedding depth; when the fitted trees are shallower
    the actual max depth is used, making those paths exact rather than
    truncated. Any path that fails to build raises.
    """
    dev = resolve_device(device)
    if only is None:
        names = BACKENDS if dev.type == "cpu" else tuple(
            n for n in BACKENDS if n not in PLAIN_TORCH)
    else:
        names = tuple(only)
    for n in names:
        if n not in BACKENDS:
            raise ValueError(f"unknown backend {n!r} (have {BACKENDS})")
        if n in PLAIN_TORCH and dev.type != "cpu":
            raise ValueError(f"{n!r} is a plain path, served only on the "
                             f"CPU; on {dev} the kernel serves ('hopper')")
    out: dict = {}

    if "tree-walk" in names:
        out["tree-walk"] = lambda X: est.predict(X)

    if "flat-numpy" in names or "flat-torch" in names:
        flat = est.to_flat()
        if "flat-numpy" in names:
            out["flat-numpy"] = lambda X: predict_flat(flat, X)
        if "flat-torch" in names:
            out["flat-torch"] = _numpy_io(FlatForestTorch(flat, dev), dev)

    if "dense-torch" in names or "hopper" in names:
        eff_depth = min(dense_depth,
                        max((t.depth() for t in est.trees_), default=0))
        dense = to_dense(est, depth=max(eff_depth, 1))
        if "dense-torch" in names:
            out["dense-torch"] = _numpy_io(DenseForestTorch(dense, dev), dev)
        if "hopper" in names:
            out["hopper"] = _hopper(dense, dev)
    return out


def _hopper(dense, dev: torch.device) -> PredictorBackend:
    """The kernel path: the tables are checked and packed on ``dev`` once
    (``pack_tables``); each call checks and moves only the rows and the
    answers."""
    from ..kernels.forest.ops import forest_predict_packed, pack_tables

    packed = pack_tables(
        torch.as_tensor(dense.feature, dtype=torch.int32, device=dev),
        torch.as_tensor(dense.threshold, dtype=torch.float32, device=dev),
        torch.as_tensor(dense.value, dtype=torch.float32, device=dev),
        depth=dense.depth, n_features=dense.n_features)
    return _numpy_io(lambda x: forest_predict_packed(x, packed), dev)
