"""Regression evaluation (JAX counterpart
deeplearning4j_tpu/eval/regression.py; reference eval/RegressionEvaluation.java:
MSE/MAE/RMSE/relative squared error/R^2 per output column)."""

from __future__ import annotations

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: int | None = None, column_names=None):
        self.column_names = column_names
        self._n = n_columns
        self._sum_sq = None
        self._sum_abs = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._count = 0

    def _ensure(self, n):
        if self._sum_sq is None:
            self._n = n
            self._sum_sq = np.zeros(n)
            self._sum_abs = np.zeros(n)
            self._sum_label = np.zeros(n)
            self._sum_label_sq = np.zeros(n)
            self._sum_pred = np.zeros(n)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        err = labels - predictions
        self._sum_sq += (err**2).sum(axis=0)
        self._sum_abs += np.abs(err).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels**2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._count += labels.shape[0]

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq[col] / self._count)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._count)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        mean = self._sum_label[col] / self._count
        ss_tot = self._sum_label_sq[col] - self._count * mean**2
        return float(1.0 - self._sum_sq[col] / max(ss_tot, 1e-12))

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_sq / self._count))

    def stats(self) -> str:
        lines = ["column,MSE,MAE,RMSE,R^2"]
        for c in range(self._n):
            name = self.column_names[c] if self.column_names else str(c)
            lines.append(
                f"{name},{self.mean_squared_error(c):.6f},"
                f"{self.mean_absolute_error(c):.6f},"
                f"{self.root_mean_squared_error(c):.6f},{self.r_squared(c):.6f}"
            )
        return "\n".join(lines)
