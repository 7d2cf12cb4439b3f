"""Time-series helpers (JAX counterpart
deeplearning4j_tpu/util/time_series.py, the port's own copy; reference
util/TimeSeriesUtils.java — movingAverage:39,
reshapeTimeSeriesMaskToVector:53)."""

from __future__ import annotations

import numpy as np


def moving_average(to_avg, n: int) -> np.ndarray:
    """Simple moving average with window n; output length len-n+1
    (TimeSeriesUtils.movingAverage — cumsum formulation)."""
    arr = np.asarray(to_avg, dtype=np.float64).ravel()
    if n <= 0 or n > arr.size:
        raise ValueError("window out of range")
    c = np.concatenate([[0.0], np.cumsum(arr)])
    return (c[n:] - c[:-n]) / n


def reshape_time_series_mask_to_vector(mask) -> np.ndarray:
    """[batch, time] mask → flat [batch*time] vector, batch-major
    (TimeSeriesUtils.reshapeTimeSeriesMaskToVector)."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError("expected [batch, time] mask")
    return mask.reshape(-1)
