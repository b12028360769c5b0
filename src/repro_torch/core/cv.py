"""Nested cross-validation, hyperparameter search and LOO (paper §3.3, §5):
a numpy copy of ``repro.core.cv``, over the port's copies of ``forest``,
``metrics`` and ``split``, so its results equal the reference's bit for bit.

The paper's grid:
  * max_features in {max, log2, sqrt}
  * split criterion in {MSE, MAE}
  * n_estimators in {128, 256, 512, 1024}

``n_estimators`` is scored via the fit-once / score-prefixes trick (see
``ExtraTreesRegressor.predict``): one fit with max(n_estimators) trees scores
the whole n_estimators axis, cutting nested-CV cost 4x with statistically
identical results (trees are i.i.d.).

Targets spanning many orders of magnitude (time) are log-transformed before
fitting (paper §4.2.1); predictions are exponentiated back before scoring, so
all scores are MAPE in the original unit.
"""
from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field

import numpy as np

from .forest import ExtraTreesRegressor
from .metrics import mape
from .split import Fold, loo_folds, plain_kfold, time_stratified_kfold

PAPER_GRID: dict[str, list] = {
    "criterion": ["mse", "mae"],
    "max_features": ["max", "log2", "sqrt"],
    "n_estimators": [128, 256, 512, 1024],
}

FAST_GRID: dict[str, list] = {
    "criterion": ["mse", "mae"],
    "max_features": ["max", "log2", "sqrt"],
    "n_estimators": [32, 64, 128],
}


@dataclass(frozen=True)
class CVConfig:
    grid: dict = field(default_factory=lambda: dict(FAST_GRID))
    outer_folds: int = 4
    inner_folds: int = 3
    iterations: int = 3
    log_target: bool = True            # paper: log-transform execution time
    time_split: bool = True            # paper's custom stratified split
    seed: int = 0


@dataclass
class FoldResult:
    iteration: int
    fold: int
    best_params: dict
    score: float                        # MAPE (%) on the outer test fold
    n_train: int
    n_test: int


@dataclass
class NestedCVResult:
    folds: list[FoldResult]
    fit_seconds: float

    @property
    def scores(self) -> np.ndarray:
        return np.asarray([f.score for f in self.folds])

    def summary(self) -> dict:
        s = self.scores
        return {
            "median_mape": float(np.median(s)),
            "mean_mape": float(np.mean(s)),
            "q1": float(np.percentile(s, 25)),
            "q3": float(np.percentile(s, 75)),
            "min": float(np.min(s)),
            "max": float(np.max(s)),
            "n_folds": len(self.folds),
            "fit_seconds": self.fit_seconds,
        }

    def best_params_mode(self) -> dict:
        """Most frequently selected hyperparameters (paper Tables 4/5)."""
        from collections import Counter
        c = Counter(tuple(sorted(f.best_params.items())) for f in self.folds)
        return dict(c.most_common(1)[0][0])


def _tx(y: np.ndarray, log: bool) -> np.ndarray:
    return np.log(np.maximum(y, 1e-12)) if log else y


def _itx(y: np.ndarray, log: bool) -> np.ndarray:
    return np.exp(y) if log else y


def _make_folds(y_us: np.ndarray, k: int, rng: np.random.Generator,
                time_split: bool) -> list[Fold]:
    if time_split:
        return time_stratified_kfold(y_us, k, rng)
    return plain_kfold(y_us.shape[0], k, rng)


def _combo_fits(grid: dict) -> list[dict]:
    """Hyperparameter combos that need a separate FIT (n_estimators folded
    into prefix scoring)."""
    keys = [k for k in grid if k != "n_estimators"]
    out = []
    for vals in itertools.product(*(grid[k] for k in keys)):
        out.append(dict(zip(keys, vals)))
    return out


def grid_search(
    X: np.ndarray, y: np.ndarray, folds: list[Fold], grid: dict,
    log_target: bool, seed: int,
) -> tuple[dict, float]:
    """Inner CV: returns (best_params, best_mean_mape)."""
    n_est_grid = sorted(grid.get("n_estimators", [256]))
    n_max = n_est_grid[-1]
    scores: dict[tuple, list[float]] = {}
    for fit_params in _combo_fits(grid):
        for fi, fold in enumerate(folds):
            est = ExtraTreesRegressor(n_estimators=n_max, seed=seed + fi,
                                      **fit_params)
            est.fit(X[fold.train], _tx(y[fold.train], log_target))
            for n_est in n_est_grid:
                pred = _itx(est.predict(X[fold.test], n_trees=n_est), log_target)
                key = tuple(sorted({**fit_params, "n_estimators": n_est}.items()))
                scores.setdefault(key, []).append(mape(y[fold.test], pred))
    mean_scores = {k: float(np.mean(v)) for k, v in scores.items()}
    best_key = min(mean_scores, key=mean_scores.get)
    return dict(best_key), mean_scores[best_key]


def nested_cv(X: np.ndarray, y: np.ndarray, cfg: CVConfig) -> NestedCVResult:
    """Paper §3.3: per iteration, a fresh random outer split; per outer fold,
    an inner grid search selects hyperparameters which are then refit on the
    outer-train set and scored on the untouched outer-test fold."""
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float64)
    t0 = _time.perf_counter()
    results: list[FoldResult] = []
    for it in range(cfg.iterations):
        rng = np.random.default_rng(cfg.seed + 1000 * it)
        outer = _make_folds(y, cfg.outer_folds, rng, cfg.time_split)
        for fi, fold in enumerate(outer):
            inner = _make_folds(y[fold.train], cfg.inner_folds, rng, cfg.time_split)
            best, _ = grid_search(X[fold.train], y[fold.train], inner,
                                  cfg.grid, cfg.log_target,
                                  seed=cfg.seed + 7 * it + fi)
            est = ExtraTreesRegressor(seed=cfg.seed + 13 * it + fi, **best)
            est.fit(X[fold.train], _tx(y[fold.train], cfg.log_target))
            pred = _itx(est.predict(X[fold.test]), cfg.log_target)
            results.append(FoldResult(
                iteration=it, fold=fi, best_params=best,
                score=mape(y[fold.test], pred),
                n_train=len(fold.train), n_test=len(fold.test)))
    return NestedCVResult(folds=results, fit_seconds=_time.perf_counter() - t0)


def leave_one_out(
    X: np.ndarray, y: np.ndarray, params: dict, log_target: bool = True,
    time_split_guard: bool = True, seed: int = 0,
    max_samples: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """LOO predictions with the best hyperparameters (paper §5.1/§5.2).

    Returns (indices, predictions). The five longest samples are kept in
    training (never predicted) when ``time_split_guard`` — mirroring the
    custom-split rationale. ``max_samples`` subsamples LOO rounds to bound
    runtime (documented deviation for the fast profile)."""
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float64)
    forced = np.argsort(y)[-5:] if time_split_guard else None
    folds = loo_folds(y.shape[0], forced)
    if max_samples is not None and len(folds) > max_samples:
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(folds), size=max_samples, replace=False)
        folds = [folds[i] for i in sorted(pick)]
    idx, preds = [], []
    for i, fold in enumerate(folds):
        est = ExtraTreesRegressor(seed=seed + i, **params)
        est.fit(X[fold.train], _tx(y[fold.train], log_target))
        p = _itx(est.predict(X[fold.test]), log_target)
        idx.append(int(fold.test[0]))
        preds.append(float(p[0]))
    return np.asarray(idx), np.asarray(preds)
