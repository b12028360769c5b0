"""Scoring functions (paper §3, Eq. 1).

The paper uses MAPE as the scoring function because kernel execution times
span ~8 orders of magnitude; absolute-value errors (MAE/MSE) overweight long
kernels. We implement MAPE plus the auxiliary metrics used by the paper's
related-work table for the baseline comparisons.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "mape", "median_ape", "ape", "mae", "mse", "rmse", "smape",
    "error_buckets",
]


def ape(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """Per-sample absolute percentage error (in percent)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    denom = np.where(np.abs(y_true) > 0, np.abs(y_true), 1.0)
    return 100.0 * np.abs(y_true - y_pred) / denom


def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean Absolute Percentage Error (paper Eq. 1)."""
    return float(np.mean(ape(y_true, y_pred)))


def median_ape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.median(ape(y_true, y_pred)))


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def mse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    d = np.asarray(y_true, dtype=np.float64) - np.asarray(y_pred, dtype=np.float64)
    return float(np.mean(d * d))


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(mse(y_true, y_pred)))


def smape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    denom = (np.abs(y_true) + np.abs(y_pred)) / 2.0
    denom = np.where(denom > 0, denom, 1.0)
    return float(100.0 * np.mean(np.abs(y_true - y_pred) / denom))


def error_buckets(y_true: np.ndarray, y_pred: np.ndarray,
                  edges=(10.0, 25.0, 50.0, 100.0)) -> dict[str, float]:
    """Fraction of samples per APE bucket (paper Fig. 6/7 right panels).

    Returns a dict like ``{"<=10%": 0.82, "10-25%": 0.08, ...}`` with
    fractions summing to 1.
    """
    e = ape(y_true, y_pred)
    out: dict[str, float] = {}
    lo = 0.0
    for hi in edges:
        out[f"{lo:g}-{hi:g}%"] = float(np.mean((e > lo) & (e <= hi)))
        lo = hi
    out[f">{lo:g}%"] = float(np.mean(e > lo))
    out[f"0-{edges[0]:g}%"] = float(np.mean(e <= edges[0]))
    return out
