"""Train/test splitting (paper §3.3).

The paper's custom split for *time* prediction:
  * the five samples with the longest execution time are always placed in
    the training set (random forests cannot extrapolate beyond the training
    range),
  * each fold holds roughly the same number of short (<1,000 us), medium
    (1,000..100,000 us) and long (>100,000 us) kernels.

For *power* prediction a plain shuffled K-fold is used (the paper applies the
custom split only to time).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SHORT_US = 1_000.0
LONG_US = 100_000.0


@dataclass(frozen=True)
class Fold:
    train: np.ndarray
    test: np.ndarray


def duration_strata(y_us: np.ndarray) -> np.ndarray:
    """0 = short, 1 = medium, 2 = long (paper thresholds)."""
    y_us = np.asarray(y_us, dtype=np.float64)
    return np.digitize(y_us, [SHORT_US, LONG_US]).astype(np.int32)


def plain_kfold(n: int, k: int, rng: np.random.Generator) -> list[Fold]:
    idx = rng.permutation(n)
    parts = np.array_split(idx, k)
    folds = []
    for i in range(k):
        test = np.sort(parts[i])
        train = np.sort(np.concatenate([parts[j] for j in range(k) if j != i]))
        folds.append(Fold(train=train, test=test))
    return folds


def time_stratified_kfold(
    y_us: np.ndarray,
    k: int,
    rng: np.random.Generator,
    n_force_train: int = 5,
) -> list[Fold]:
    """The paper's custom split (time prediction).

    The ``n_force_train`` longest-running samples never appear in any test
    fold; within each duration stratum samples are dealt round-robin so every
    fold sees a comparable mix of short/medium/long kernels.
    """
    y_us = np.asarray(y_us, dtype=np.float64)
    n = y_us.shape[0]
    if k < 2:
        raise ValueError("k must be >= 2")
    order = np.argsort(y_us)
    forced = set(order[-min(n_force_train, n):].tolist()) if n_force_train else set()

    strata = duration_strata(y_us)
    fold_test: list[list[int]] = [[] for _ in range(k)]
    for s in range(3):
        members = [i for i in np.flatnonzero(strata == s).tolist() if i not in forced]
        members = [members[j] for j in rng.permutation(len(members))]
        # round-robin deal, rotating the starting fold per stratum
        start = int(rng.integers(k))
        for j, i in enumerate(members):
            fold_test[(start + j) % k].append(i)

    folds = []
    all_idx = np.arange(n)
    for i in range(k):
        test = np.sort(np.asarray(fold_test[i], dtype=np.int64))
        mask = np.ones(n, dtype=bool)
        mask[test] = False
        folds.append(Fold(train=all_idx[mask], test=test))
    return folds


def loo_folds(n: int, forced_train: np.ndarray | None = None) -> list[Fold]:
    """Leave-one-out folds (paper §5); ``forced_train`` samples are skipped
    as test candidates (they must stay in training)."""
    skip = set() if forced_train is None else set(np.asarray(forced_train).tolist())
    folds = []
    all_idx = np.arange(n)
    for i in range(n):
        if i in skip:
            continue
        mask = np.ones(n, dtype=bool)
        mask[i] = False
        folds.append(Fold(train=all_idx[mask], test=np.asarray([i])))
    return folds
