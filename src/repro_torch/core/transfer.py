"""Cold-start portability tier: price a device the forests never trained on.

The paper's headline is portability — one hardware-independent feature set
prices kernels across five GPUs — but the forests still need per-device
training data. Production means a NEW device type shows up and must be priced
immediately. This module is the transfer path, after Stevens & Klöckner's
unified cross-GPU models (arXiv 1604.04997 / 1904.09538): a parametrized
analytical model calibrated per device, with a learned model correcting its
residual.

Three pieces:

  * :class:`FittedAnalyticalModel` — ``core.simulate.AnalyticalBaseline``
    with its hardware constants turned into FITTED coefficients. The basis is
    the roofline decomposition (launch overhead, compute term, memory term)
    plus two occupancy terms (per-work-item compute/memory penalties — the
    ``utilization`` curve the simulator applies that the static baseline
    ignores). Coefficients are ridge-fitted in RELATIVE error (targets span
    ~8 orders of magnitude, paper Eq. 1) and regularized toward the device's
    SPEC-SHEET prior, so zero samples reproduce the static roofline and a
    handful of probes bend it toward the measured hardware.
  * :func:`select_probes` — which kernels to measure first: deterministic
    farthest-point traversal in standardized log feature space, so a small
    probe budget covers the feature space instead of re-measuring near
    duplicates. Independent of ``PYTHONHASHSEED`` (numpy only, ties by
    lowest index).
  * :class:`TransferPredictor` — the serving object: hybrid
    analytical-prior + forest-residual. ``calibrate(probes)`` bulk-fits,
    ``observe(x, y)`` incrementally refits as measurements stream in
    (``workloads.stream.StreamingCollector`` → ``ingest_store``), and
    ``predict(X)`` multiplies the fitted analytical estimate by the
    shrunk exponential of a forest fitted on LOG-residuals. Accuracy
    converges from "analytical prior only" (day zero) toward full-forest
    MAPE as samples accumulate — the learning curve is benchmarked in
    ``benchmarks/bench_portability.py`` (``portability.coldstart.*``).

Serving integration lives in ``serve.backend.build_transfer_engine``; the
docs page is ``docs/portability.md``.

A copy of ``repro.core.transfer`` (numpy on the host), its imports
pointed at the port: the same probes give bitwise-equal priors, refits and
``to_forest()`` fits under both packages.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from .dataset import DatasetStore, Sample
from .devices import DEVICE_MODELS, SIMULATED_DEVICES, DeviceModel
from .features import N_FEATURES
from .forest import ExtraTreesRegressor
from .simulate import utilization_saturation, roofline_columns

__all__ = [
    "FittedAnalyticalModel", "TransferConfig", "TransferPredictor",
    "TransferStats", "generic_device_prior", "select_probes",
]

# basis column names, in order (docs + stats refer to these)
BASIS_TERMS = ("launch_overhead", "compute", "memory",
               "compute_occupancy", "memory_occupancy")
N_BASIS = len(BASIS_TERMS)


def generic_device_prior(name: str = "unknown-device") -> DeviceModel:
    """A mid-range prior for a device we know NOTHING about: the geometric
    mean of the simulated zoo's spec numbers. Day-zero predictions for an
    unrecognized device name start here and are corrected by the first
    probes."""
    devs = SIMULATED_DEVICES

    def gmean(vals):
        return float(np.exp(np.mean(np.log(np.asarray(vals, dtype=np.float64)))))

    return DeviceModel(
        name=name, clazz="unknown",
        peak_flops=gmean([d.peak_flops for d in devs]),
        hbm_bw=gmean([d.hbm_bw for d in devs]),
        ici_bw=gmean([d.ici_bw for d in devs]),
        vmem_bytes=devs[0].vmem_bytes, hbm_bytes=devs[0].hbm_bytes,
        idle_w=gmean([d.idle_w for d in devs]),
        peak_w=gmean([d.peak_w for d in devs]),
        latency_floor_us=gmean([d.latency_floor_us for d in devs]),
        freq_jitter=0.0, sample_hz=devs[0].sample_hz)


def _resolve_device(device: DeviceModel | str) -> DeviceModel:
    if isinstance(device, DeviceModel):
        return device
    known = DEVICE_MODELS.get(str(device))
    return known if known is not None else generic_device_prior(str(device))


class FittedAnalyticalModel:
    """Roofline + occupancy basis with per-device least-squares coefficients.

    Coefficients are kept as multipliers ``beta`` over the spec-sheet prior
    ``theta0`` (``beta = 1`` everywhere at day zero), which conditions the
    ridge system: the raw coefficients span ~15 orders of magnitude
    (launch-overhead µs vs. seconds-per-FLOP), the multipliers are O(1).
    The fit minimizes RELATIVE squared error (rows are divided by the
    measured time — paper Eq. 1's rationale) with an L2 pull toward
    ``beta = 1`` worth ``ridge`` pseudo-observations, and non-negativity is
    enforced by active-set elimination (a negative rate coefficient would
    predict negative times on unseen kernels).
    """

    # occupancy penalty cap: the utilization curve floors at 2 % of peak
    # (``simulate.utilization``), so no kernel pays more than a ~50x
    # derate — the linearized ``sat/work`` ratio must saturate with it,
    # or tiny kernels would extrapolate absurd penalties
    MAX_OCCUPANCY_PENALTY = 49.0

    def __init__(self, device: DeviceModel | str, *, ridge: float = 1.0):
        self.device = _resolve_device(device)
        self.ridge = float(ridge)
        self.sat = utilization_saturation(self.device)
        self.theta0 = self._prior_theta(self.device)
        self.beta = np.ones(N_BASIS, dtype=np.float64)
        self.n_fitted = 0

    @staticmethod
    def _prior_theta(device: DeviceModel) -> np.ndarray:
        """Spec-sheet coefficients: what the static roofline would use.

        The occupancy priors come from the utilization curve
        (``simulate.utilization``): a kernel with ``w`` work items runs at
        ``~w/(w+sat)`` of peak, i.e. its compute term carries an extra
        ``~sat/w`` (capped at the 2 %-of-peak floor); the memory penalty
        tops out at ~0.8x the roofline term."""
        c_comp = 1e6 / device.peak_flops         # µs per effective FLOP
        c_mem = 1e6 / device.hbm_bw              # µs per HBM byte
        return np.array([
            device.latency_floor_us,
            c_comp,
            c_mem,
            c_comp,                              # x occupancy-penalty column
            0.8 * c_mem,
        ], dtype=np.float64)

    def basis(self, X: np.ndarray) -> np.ndarray:
        """(B, N_BASIS) basis columns from the 12 portable features.

        Device-aware through the utilization saturation constant only (it
        scales the occupancy ratio); the FEATURES stay hardware-independent
        — the same rows feed every device's model."""
        c = roofline_columns(X)
        eff = c["arith"] + 8.0 * c["special"] + 4.0 * c["control"]
        work = np.maximum(c["work"], 1.0)
        penalty = np.minimum(self.sat / work, self.MAX_OCCUPANCY_PENALTY)
        return np.stack([
            np.ones_like(eff),
            eff,
            c["gvol"],
            eff * penalty,
            c["gvol"] * (penalty / self.MAX_OCCUPANCY_PENALTY),
        ], axis=1)

    @property
    def theta(self) -> np.ndarray:
        """Fitted coefficients in physical units (µs per basis unit)."""
        return self.beta * self.theta0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "FittedAnalyticalModel":
        """Weighted ridge refit from ALL samples seen so far (cheap: the
        normal system is N_BASIS x N_BASIS)."""
        y = np.asarray(y, dtype=np.float64)
        keep = y > 0
        X = np.asarray(X, dtype=np.float64)[keep]
        y = y[keep]
        if not len(y):
            return self
        # relative-error design: rows scaled by 1/y, columns by the prior
        A = self.basis(X) * self.theta0[None, :] / y[:, None]
        t = np.ones(len(y))
        lam = self.ridge
        ata = A.T @ A + lam * np.eye(N_BASIS)
        atb = A.T @ t + lam * np.ones(N_BASIS)
        active = np.ones(N_BASIS, dtype=bool)
        beta = np.ones(N_BASIS, dtype=np.float64)
        for _ in range(N_BASIS):
            idx = np.flatnonzero(active)
            sol = np.linalg.solve(ata[np.ix_(idx, idx)], atb[idx])
            if (sol >= 0).all():
                beta[:] = 0.0
                beta[idx] = sol
                break
            active[idx[sol < 0]] = False
            if not active.any():
                beta[:] = 0.0
                break
        self.beta = beta
        self.n_fitted = int(len(y))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        t = self.basis(X) @ self.theta
        # fitted coefficients can zero the floor term; never price below a
        # fraction of the prior launch overhead (or 1 ns)
        return np.maximum(t, max(0.05 * self.theta0[0], 1e-3))


def select_probes(X: np.ndarray, budget: int) -> np.ndarray:
    """Probe-kernel selection by feature-space coverage.

    Returns ``min(budget, len(X))`` row indices: the kernel nearest the
    centroid first (the single most representative probe), then greedy
    farthest-point traversal in standardized ``log1p`` feature space, so
    every additional probe maximizes the minimum distance to the ones
    already measured. The ORDER is the streaming schedule — truncating the
    result is the best smaller probe set.

    Deterministic and ``PYTHONHASHSEED``-independent: pure numpy, ties
    resolved to the lowest index (``argmin``/``argmax`` first-hit).
    """
    X = np.asarray(X, dtype=np.float64)
    n = len(X)
    k = int(min(budget, n))
    if k <= 0:
        return np.zeros(0, dtype=np.int64)
    Z = np.log1p(np.abs(X))
    std = Z.std(axis=0)
    Z = (Z - Z.mean(axis=0)) / np.where(std > 1e-12, std, 1.0)
    order = np.empty(k, dtype=np.int64)
    order[0] = int(np.argmin(((Z - Z.mean(axis=0)) ** 2).sum(axis=1)))
    d = ((Z - Z[order[0]]) ** 2).sum(axis=1)
    for j in range(1, k):
        d[order[:j]] = -1.0          # chosen points never re-selected
        order[j] = int(np.argmax(d))
        d = np.minimum(d, ((Z - Z[order[j]]) ** 2).sum(axis=1))
    return order


@dataclass(frozen=True)
class TransferConfig:
    """Knobs for the hybrid tier. Defaults favor fast convergence on small
    probe budgets (tens of samples), not asymptotic accuracy — once a device
    has hundreds of samples, graduate it to a full forest
    (:meth:`TransferPredictor.to_forest` + ``EngineRefresher``)."""
    ridge: float = 1.0                 # prior pseudo-observations (analytical)
    min_forest_samples: int = 8        # residual forest activates here
    forest_refit_every: int = 4        # refit cadence after activation
    n_estimators: int = 48
    min_samples_leaf: int = 2
    seed: int = 0
    shrinkage: float = 8.0             # residual weight = n / (n + shrinkage)


@dataclass
class TransferStats:
    """Atomic snapshot of one predictor's calibration state."""
    device: str
    target: str
    mode: str                          # "prior" | "fitted" | "hybrid"
    n_observed: int
    analytical_refits: int
    forest_refits: int
    generation: int
    beta: list[float] = field(default_factory=list)
    ingested: int = 0                  # store samples consumed (incl. skips)
    ingest_errors: int = 0             # poisoned samples skipped by ingest

    def as_dict(self) -> dict:
        return dict(device=self.device, target=self.target, mode=self.mode,
                    n_observed=self.n_observed,
                    analytical_refits=self.analytical_refits,
                    forest_refits=self.forest_refits,
                    generation=self.generation, beta=list(self.beta),
                    ingested=self.ingested,
                    ingest_errors=self.ingest_errors)


class TransferPredictor:
    """Hybrid analytical-prior + forest-residual predictor for one device.

    Day zero (no samples): predictions are the spec-sheet roofline —
    available IMMEDIATELY for any ``DeviceModel`` (or an unknown name, via
    :func:`generic_device_prior`). Every ``observe(x, y)`` refits the
    analytical coefficients; once ``min_forest_samples`` accumulate, an
    extra-trees forest is fitted on the analytical model's LOG-residuals
    ``log(y) - log(t_analytical(x))`` and its (shrunk) correction
    multiplies the analytical estimate. Shrinkage ``n/(n+k)`` keeps a
    barely-trained forest from dominating the well-conditioned prior.

    Duck-types the serving-engine surface (``predict`` / ``close`` /
    ``n_features`` / ``stats_snapshot``), so it drops straight into
    ``ReplicaPool`` / ``ClusterFrontend`` / ``MultiDeviceEngine`` — see
    ``serve.backend.build_transfer_engine``. With ``monitor=`` set, every
    observation records the PRE-update prediction into
    ``CalibrationMonitor`` → the ``calibration.mape{device,target}`` gauge
    is the live convergence curve.

    Thread-safe: refits build new model objects and publish them under a
    lock; ``predict`` reads a consistent (analytical, forest, n) triple.
    Mutators (``observe`` / ``calibrate`` / ``ingest_store``) additionally
    serialize on a re-entrant observation lock, so each call's
    record -> extend -> refit sequence is atomic: the generation a caller
    gets back always includes its own samples, and two concurrent
    observers can never interleave a refit between one call's monitor
    record and its row append. ``predict`` never takes the observation
    lock — serving latency is unaffected by a concurrent refit.
    """

    def __init__(self, device: DeviceModel | str, *, target: str = "time_us",
                 config: TransferConfig | None = None, monitor=None,
                 log_output: bool = False, n_features: int = N_FEATURES):
        self.device = _resolve_device(device)
        self.target = str(target)
        self.config = config or TransferConfig()
        self.monitor = monitor
        self.log_output = bool(log_output)
        self.n_features = int(n_features)
        self._lock = threading.Lock()
        # serializes whole observe/calibrate/ingest calls (RLock: calibrate
        # folds probes in through observe on the same thread)
        self._observe_lock = threading.RLock()
        self._analytical = FittedAnalyticalModel(
            self.device, ridge=self.config.ridge)
        self._forest: ExtraTreesRegressor | None = None
        self._forest_n = 0
        self._X: list[np.ndarray] = []
        self._y: list[float] = []
        self._analytical_refits = 0
        self._forest_refits = 0
        self._generation = 0
        self._ingested = 0             # ingest_store high-water mark
        self._ingest_errors = 0        # poisoned samples skipped by ingest

    # ------------------------------------------------------------ serving

    @property
    def mode(self) -> str:
        with self._lock:
            if self._forest is not None:
                return "hybrid"
            return "fitted" if self._analytical.n_fitted else "prior"

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            analytical, forest, n = self._analytical, self._forest, self._forest_n
        t = analytical.predict(X)
        if forest is not None:
            r = forest.predict(X.astype(np.float32))
            w = n / (n + self.config.shrinkage)
            t = t * np.exp(w * np.clip(r, -20.0, 20.0))
        return np.log(t) if self.log_output else t

    def close(self) -> None:
        pass

    def stats_snapshot(self) -> TransferStats:
        with self._lock:
            return TransferStats(
                device=self.device.name, target=self.target, mode=(
                    "hybrid" if self._forest is not None else
                    "fitted" if self._analytical.n_fitted else "prior"),
                n_observed=len(self._y),
                analytical_refits=self._analytical_refits,
                forest_refits=self._forest_refits,
                generation=self._generation,
                beta=[float(b) for b in self._analytical.beta],
                ingested=self._ingested,
                ingest_errors=self._ingest_errors)

    # -------------------------------------------------------- calibration

    def observe(self, x: np.ndarray, y: float | np.ndarray, *,
                kernel: str | None = None) -> int:
        """Fold measured samples in; returns the new generation.

        ``x``: one feature row ``(F,)`` or a batch ``(B, F)``; ``y``
        matches. Records the PRE-update prediction against the measurement
        in the attached ``CalibrationMonitor`` (the gauge tracks how wrong
        the model was BEFORE it learned from the sample), then refits the
        analytical stage and, past the activation threshold, the residual
        forest. The record -> extend -> refit sequence holds the
        observation lock for the whole call, so the returned generation is
        guaranteed to include THIS call's samples and concurrent observers
        cannot interleave."""
        X = np.atleast_2d(np.asarray(x, dtype=np.float64))
        ys = np.atleast_1d(np.asarray(y, dtype=np.float64))
        if len(X) != len(ys):
            raise ValueError(f"{len(X)} rows vs {len(ys)} targets")
        # reject BEFORE mutating: a wrong-width or non-finite sample must
        # fail this call alone, not poison _X/_y for every later observe
        # (ingest_store counts the rejection and moves on)
        if X.shape[1] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, "
                             f"got {X.shape[1]}")
        if not (np.isfinite(X).all() and np.isfinite(ys).all()
                and (ys > 0).all()):
            raise ValueError("features must be finite and targets finite "
                             "positive")
        with self._observe_lock:
            if self.monitor is not None:
                pred = self.predict(X)
                if self.log_output:
                    pred = np.exp(pred)
                for p, m in zip(pred, ys):
                    self.monitor.record(self.device.name, self.target,
                                        float(p), float(m), kernel=kernel)
            with self._lock:
                self._X.extend(np.asarray(r, dtype=np.float64) for r in X)
                self._y.extend(float(v) for v in ys)
            return self._refit()

    def observe_sample(self, sample: Sample) -> int | None:
        """Fold one collector :class:`Sample` (uses this predictor's device
        + target; returns None when the sample lacks that measurement)."""
        t = sample.targets.get(self.device.name, {})
        if self.target not in t:
            return None
        return self.observe(sample.features, t[self.target],
                            kernel=sample.group)

    def calibrate(self, probes, *, device: DeviceModel | str | None = None,
                  ) -> TransferStats:
        """Bulk calibration from probe measurements.

        ``probes`` is either a list of :class:`Sample` (targets for this
        predictor's device are extracted) or an ``(X, y)`` pair. Passing
        ``device=`` re-targets the predictor (e.g. generic prior → the real
        spec sheet once it is known) and refits from scratch — including
        the ``ingest_store`` high-water mark, so a follow-up
        ``ingest_store`` replays the store's FULL history onto the new
        device model instead of refitting from nothing."""
        with self._observe_lock:
            if device is not None:
                with self._lock:
                    self.device = _resolve_device(device)
                    self._analytical = FittedAnalyticalModel(
                        self.device, ridge=self.config.ridge)
                    self._forest = None
                    self._forest_n = 0
                    self._X, self._y = [], []
                    self._ingested = 0
            if isinstance(probes, tuple):
                X, y = probes
                self.observe(np.asarray(X), np.asarray(y))
            else:
                for s in probes:
                    self.observe_sample(s)
            return self.stats_snapshot()

    def ingest_store(self, store: DatasetStore) -> int:
        """Fold every NEW sample from a ``DatasetStore`` (the streaming
        collector's sink) carrying this device's target; returns how many
        were ingested. Tracks the store position, so polling is idempotent —
        wire a ``StreamingCollector(on_chunk=lambda *_: p.ingest_store(store))``
        to calibrate live off the probe stream.

        The high-water mark advances PER SAMPLE as each one is folded in
        (never wholesale up front), and a sample whose ``observe`` raises
        is skipped and counted in ``stats_snapshot().ingest_errors``
        rather than aborting the batch — a single poisoned measurement
        must cost exactly itself, not the unprocessed tail behind it."""
        with self._observe_lock:
            samples, _version = store.raw()
            n = 0
            for i in range(self._ingested, len(samples)):
                try:
                    if self.observe_sample(samples[i]) is not None:
                        n += 1
                except Exception:
                    with self._lock:
                        self._ingest_errors += 1
                with self._lock:
                    self._ingested = i + 1
            return n

    def to_forest(self) -> ExtraTreesRegressor:
        """Graduate: a standalone forest fitted on everything observed
        (log target), ready for ``ForestEngine(est)`` /
        ``ForestEngine.swap_estimator`` once the device has outgrown the
        transfer tier."""
        with self._lock:
            if not self._y:
                raise ValueError("no observations to graduate from")
            X = np.stack(self._X).astype(np.float32)
            y = np.log(np.maximum(np.asarray(self._y), 1e-9))
        cfg = self.config
        est = ExtraTreesRegressor(
            n_estimators=cfg.n_estimators,
            min_samples_leaf=cfg.min_samples_leaf, seed=cfg.seed)
        est.fit(X, y.astype(np.float32))
        return est

    # ---------------------------------------------------------- internals

    def _refit(self) -> int:
        cfg = self.config
        with self._lock:
            X = np.stack(self._X)
            y = np.asarray(self._y, dtype=np.float64)
            have_forest, forest_n = self._forest is not None, self._forest_n
        analytical = FittedAnalyticalModel(self.device, ridge=cfg.ridge)
        analytical.fit(X, y)
        forest = None
        n = len(y)
        refit_forest = n >= cfg.min_forest_samples and (
            not have_forest or n - forest_n >= cfg.forest_refit_every)
        if refit_forest:
            resid = np.log(np.maximum(y, 1e-9)) \
                - np.log(analytical.predict(X))
            forest = ExtraTreesRegressor(
                n_estimators=cfg.n_estimators,
                min_samples_leaf=cfg.min_samples_leaf, seed=cfg.seed)
            forest.fit(X.astype(np.float32), resid.astype(np.float32))
        with self._lock:
            self._analytical = analytical
            self._analytical_refits += 1
            if forest is not None:
                self._forest = forest
                self._forest_n = n
                self._forest_refits += 1
            self._generation += 1
            return self._generation


def transfer_learning_curve(
        predictor: TransferPredictor, X_probe: np.ndarray,
        y_probe: np.ndarray, X_eval: np.ndarray, y_eval: np.ndarray,
        checkpoints: list[int]) -> list[tuple[int, float]]:
    """Feed probes one at a time; return ``(n_seen, eval MAPE)`` at each
    checkpoint. Shared by the bench and the example so the learning curve
    they report is the same computation."""
    from .metrics import mape

    def eval_mape() -> float:
        pred = predictor.predict(X_eval)
        if predictor.log_output:
            pred = np.exp(pred)
        return mape(y_eval, pred)

    out: list[tuple[int, float]] = []
    if 0 in checkpoints:
        out.append((0, eval_mape()))
    for i in range(len(y_probe)):
        predictor.observe(X_probe[i], float(y_probe[i]))
        if (i + 1) in checkpoints:
            out.append((i + 1, eval_mape()))
    return out
