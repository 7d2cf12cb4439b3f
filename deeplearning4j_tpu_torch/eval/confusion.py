"""Confusion matrix (JAX counterpart deeplearning4j_tpu/eval/confusion.py;
reference eval/ConfusionMatrix.java)."""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, classes):
        self.classes = list(classes)
        n = len(self.classes)
        self.matrix = np.zeros((n, n), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_matrix(self, other: "ConfusionMatrix"):
        self.matrix += other.matrix

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def get_actual_total(self, actual: int) -> int:
        return int(self.matrix[actual].sum())

    def get_predicted_total(self, predicted: int) -> int:
        return int(self.matrix[:, predicted].sum())

    def to_csv(self) -> str:
        header = "," + ",".join(str(c) for c in self.classes)
        rows = [header]
        for i, c in enumerate(self.classes):
            rows.append(str(c) + "," + ",".join(str(v) for v in self.matrix[i]))
        return "\n".join(rows)

    def __str__(self):
        return self.to_csv()
