"""Numerically-tolerant math helpers (JAX counterpart
deeplearning4j_tpu/util/sloppy_math.py, the port's own copy; reference
berkeley/SloppyMath.java).

The reference vendors Berkeley NLP's scalar helpers (logAdd with a
truncation tolerance, logNormalize, nChooseK, ...). Here they are thin
vectorized numpy forms — anything heavier already lives in numpy or
torch, so only the semantics the reference actually exposes are kept.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np

ArrayLike = Union[float, Sequence[float], np.ndarray]

# logAdd treats summands more than this many nats below the max as zero
# (reference SloppyMath.LOGTOLERANCE = 30.0)
LOG_TOLERANCE = 30.0


def is_dangerous(d: float) -> bool:
    """NaN, infinite, or exactly zero (reference isDangerous)."""
    return math.isnan(d) or math.isinf(d) or d == 0.0


def is_very_dangerous(d: float) -> bool:
    return math.isnan(d) or math.isinf(d)


def relative_difference(a: float, b: float) -> float:
    absolute = abs(a - b)
    scale = max(abs(a), abs(b))
    return absolute / scale if scale > 0 else absolute


def is_discrete_prob(d: float, tol: float = 1e-6) -> bool:
    return abs(1.0 - d) < tol


def log_add(lx: ArrayLike, ly: float = None) -> float:
    """log(exp(lx) + exp(ly)) — or over a vector when ly is omitted —
    truncating summands > LOG_TOLERANCE nats below the max, exactly the
    reference's speed/robustness trade (SloppyMath.logAdd:246-358)."""
    if ly is not None:
        v = np.array([lx, ly], dtype=np.float64)
    else:
        v = np.asarray(lx, dtype=np.float64)
    if v.size == 0:
        return float("-inf")
    m = float(np.max(v))
    if math.isinf(m):
        return m
    keep = v >= m - LOG_TOLERANCE
    return m + math.log(float(np.sum(np.exp(v[keep] - m))))


def log_subtract(lx: float, ly: float) -> float:
    """log(exp(lx) - exp(ly)); requires lx >= ly."""
    if ly > lx:
        raise ValueError("log_subtract requires lx >= ly")
    if lx == ly:
        return float("-inf")
    return lx + math.log1p(-math.exp(ly - lx))


def log_normalize(log_v: ArrayLike) -> np.ndarray:
    """Shift log-weights so they sum (in probability space) to 1
    (reference logNormalize mutates in place; here a new array returns)."""
    v = np.asarray(log_v, dtype=np.float64)
    return v - log_add(v)


def add_exp(log_v: ArrayLike) -> float:
    """sum(exp(v)) computed via the shifted form (reference addExp)."""
    return math.exp(log_add(log_v))


def n_choose_k(n: int, k: int) -> int:
    return math.comb(n, k)


def int_pow(b: Union[int, float], e: int) -> Union[int, float]:
    """b**e by squaring for non-negative integer e (reference intPow)."""
    if e < 0:
        raise ValueError("int_pow requires e >= 0")
    result = 1
    base = b
    while e:
        if e & 1:
            result = result * base
        base = base * base
        e >>= 1
    return result


def approx_log(x: float) -> float:
    """The reference ships bit-twiddling approx exp/log for JVM speed;
    numpy's exact forms are faster here, so approx == exact."""
    return math.log(x)


def approx_exp(x: float) -> float:
    return math.exp(x)


def sloppy_max(*xs: float) -> float:
    return max(xs)


def sloppy_min(*xs: float) -> float:
    return min(xs)
