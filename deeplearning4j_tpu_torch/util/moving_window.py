"""Sliding 2-D windows over a matrix (JAX counterpart
deeplearning4j_tpu/util/moving_window.py, the port's own copy;
reference util/MovingWindowMatrix.java — windows(boolean flattened),
optional 90° rotations via addRotate).

Vectorised with stride tricks — no per-window copies until the caller asks
for the list."""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    """All windowRowSize×windowColumnSize sub-matrices, stride 1
    (MovingWindowMatrix.java:55)."""

    def __init__(self, to_slice: np.ndarray, window_row_size: int,
                 window_column_size: int, add_rotate: bool = False):
        self.arr = np.asarray(to_slice)
        if self.arr.ndim != 2:
            raise ValueError("expected a 2-D matrix")
        if (window_row_size > self.arr.shape[0]
                or window_column_size > self.arr.shape[1]):
            raise ValueError("window larger than matrix")
        self.rows = window_row_size
        self.cols = window_column_size
        self.add_rotate = add_rotate

    def windows(self, flattened: bool = False) -> List[np.ndarray]:
        view = np.lib.stride_tricks.sliding_window_view(
            self.arr, (self.rows, self.cols))
        out: List[np.ndarray] = []
        for i in range(view.shape[0]):
            for j in range(view.shape[1]):
                w = view[i, j]
                variants = [w]
                if self.add_rotate:
                    # three extra 90° rotations (reference addRotate)
                    variants += [np.rot90(w, k) for k in (1, 2, 3)]
                for v in variants:
                    out.append(v.ravel().copy() if flattened else v.copy())
        return out
