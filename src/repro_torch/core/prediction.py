"""Arrival predictors and mis-prediction models (paper §5.1-§5.2.2).

The paper evaluates POTUS under five imperfect one-step predictors — Kalman
filter, empirical-distribution sampling (Distr), Prophet, moving average (MA)
and EWMA — plus two analytic extremes: All-True-Negative (nothing predicted)
and False-Positive(x) (perfect prediction plus x phantom tuples/slot on
average). Facebook Prophet is not installable offline; ``ProphetLike`` fits
the same decomposition (linear trend + periodic seasonality) by least squares
on a sliding window, which is the component structure Prophet uses.

All predictors are causal: the prediction for slot t uses arrivals < t.
``predict_series`` vectorizes a predictor over every (instance, component)
stream of an arrival tensor.

A numpy copy of ``repro.core.prediction``, kept in the port so that it imports nothing of the
JAX package; it must stay ``np.array_equal`` to the reference from the same seed
(``tests/test_torch_numpy_copies.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "kalman_predict",
    "distr_predict",
    "prophet_like_predict",
    "ma_predict",
    "ewma_predict",
    "predict_series",
    "all_true_negative",
    "false_positive",
    "predictor_scenarios",
    "misprediction_scenarios",
    "PREDICTORS",
    "mse",
]


def ma_predict(series: np.ndarray, k: int = 8) -> np.ndarray:
    """One-step-ahead moving average."""
    T = len(series)
    pred = np.zeros(T)
    csum = np.concatenate([[0.0], np.cumsum(series)])
    for t in range(1, T):
        lo = max(0, t - k)
        pred[t] = (csum[t] - csum[lo]) / (t - lo)
    return pred


def ewma_predict(series: np.ndarray, alpha: float = 0.3) -> np.ndarray:
    T = len(series)
    pred = np.zeros(T)
    level = 0.0
    for t in range(1, T):
        level = alpha * series[t - 1] + (1 - alpha) * level if t > 1 else series[0]
        pred[t] = level
    return pred


def kalman_predict(series: np.ndarray, q: float = 1.0, r: float = 4.0) -> np.ndarray:
    """Local-level (random-walk + noise) Kalman filter, one-step-ahead."""
    T = len(series)
    pred = np.zeros(T)
    x, p = 0.0, 1.0
    for t in range(1, T):
        # update with observation t-1
        z = series[t - 1]
        p = p + q
        k = p / (p + r)
        x = x + k * (z - x)
        p = (1 - k) * p
        pred[t] = x
    return pred


def distr_predict(series: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Sample from the empirical distribution of past arrivals."""
    T = len(series)
    pred = np.zeros(T)
    for t in range(1, T):
        j = rng.integers(0, t)
        pred[t] = series[j]
    return pred


def prophet_like_predict(series: np.ndarray, window: int = 64, period: int = 20) -> np.ndarray:
    """Trend + seasonality least-squares fit on a sliding window."""
    T = len(series)
    pred = np.zeros(T)
    for t in range(1, T):
        lo = max(0, t - window)
        y = series[lo:t]
        n = len(y)
        if n < 4:
            pred[t] = y.mean() if n else 0.0
            continue
        tt = np.arange(lo, t, dtype=np.float64)
        X = np.stack(
            [np.ones(n), tt, np.sin(2 * np.pi * tt / period), np.cos(2 * np.pi * tt / period)],
            axis=1,
        )
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        xt = np.array([1.0, t, np.sin(2 * np.pi * t / period), np.cos(2 * np.pi * t / period)])
        pred[t] = float(xt @ coef)
    return np.maximum(pred, 0.0)


PREDICTORS = {
    "kalman": lambda s, rng: kalman_predict(s),
    "distr": distr_predict,
    "prophet": lambda s, rng: prophet_like_predict(s),
    "ma": lambda s, rng: ma_predict(s),
    "ewma": lambda s, rng: ewma_predict(s),
}


def predict_series(
    name: str, arrivals: np.ndarray, rng: np.random.Generator, nonneg_round: bool = True
) -> np.ndarray:
    """Apply predictor to every stream of ``arrivals`` (T, I, C)."""
    fn = PREDICTORS[name]
    T, I, C = arrivals.shape
    pred = np.zeros_like(arrivals, dtype=np.float64)
    for i in range(I):
        for c in range(C):
            s = arrivals[:, i, c]
            if s.any():
                pred[:, i, c] = fn(s.astype(np.float64), rng)
    if nonneg_round:
        pred = np.maximum(np.rint(pred), 0.0)
    return pred.astype(np.float32)


def all_true_negative(arrivals: np.ndarray) -> np.ndarray:
    """Extreme 1 (Fig. 6c): no tuple is ever predicted."""
    return np.zeros_like(arrivals)


def false_positive(
    arrivals: np.ndarray, x: float, rng: np.random.Generator
) -> np.ndarray:
    """Extreme 2 (Fig. 6c): perfect prediction of actual arrivals plus an
    average of ``x`` phantom tuples per slot, spread over active streams."""
    active = arrivals.sum(axis=0) > 0  # (I, C)
    n_active = max(int(active.sum()), 1)
    phantom = rng.poisson(x / n_active, size=arrivals.shape).astype(np.float32)
    phantom *= active[None, :, :]
    return arrivals + phantom


def predictor_scenarios(
    arrivals: np.ndarray,
    names: tuple[str, ...] = ("kalman", "distr", "prophet", "ma", "ewma"),
    seed: int = 5,
    include_perfect: bool = True,
    include_none: bool = True,
) -> dict[str, np.ndarray | None]:
    """Named (actual, predicted) arrival scenarios for a sweep (DESIGN.md §6).

    One entry per imperfect predictor (Fig. 6a,b), keyed by predictor name;
    values are predicted-arrival tensors shaped like ``arrivals`` (``None``
    means perfect prediction). A single RNG is threaded through in ``names``
    order so the grid is reproducible from ``seed`` alone.
    """
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray | None] = {}
    if include_perfect:
        out["perfect"] = None
    for name in names:
        out[name] = predict_series(name, arrivals, rng)
    if include_none:
        out["none"] = all_true_negative(arrivals)
    return out


def misprediction_scenarios(
    arrivals: np.ndarray,
    fp_levels: tuple[float, ...] = (10.0, 20.0, 30.0),
    include_perfect: bool = True,
) -> dict[str, np.ndarray | None]:
    """The Fig. 6c analytic extremes as named sweep scenarios: perfect,
    All-True-Negative, and False-Positive(x) for each level in ``fp_levels``
    (each level seeded by its own value, matching the paper benchmark)."""
    out: dict[str, np.ndarray | None] = {}
    if include_perfect:
        out["perfect"] = None
    out["all-true-negative"] = all_true_negative(arrivals)
    for x in fp_levels:
        # integer levels keep the historical seed x; fractional levels get a
        # distinct seed instead of colliding on int(x)
        seed = int(x) if float(x).is_integer() else int(round(float(x) * 1e6))
        out[f"false-positive-{x:g}"] = false_positive(
            arrivals, x, np.random.default_rng(seed)
        )
    return out


def mse(pred: np.ndarray, actual: np.ndarray) -> float:
    m = actual.sum(axis=0) > 0
    if not m.any():
        return 0.0
    return float(((pred - actual) ** 2)[:, m].mean())
