"""Viterbi label-sequence smoothing (JAX counterpart
deeplearning4j_tpu/util/viterbi.py, the port's own copy; reference
util/Viterbi.java — decodes the most likely true label chain from noisy
per-frame classifier outputs under a sticky transition model:
metaStability 0.9 self-transition, pCorrect 0.99 emission).

The reference's DP never fills its backpointer matrix (Viterbi.java:77-110
writes `pointers` nowhere), so its backtrace returns zeros; this
implementation keeps the same model and API shape but does the standard
correct backtrace. Vectorised over states per frame — sequence decode is
tiny host work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Viterbi:
    """decode(labels) → (log-likelihood, most-likely state sequence)."""

    def __init__(self, possible_labels, meta_stability: float = 0.9,
                 p_correct: float = 0.99):
        self.possible_labels = np.asarray(possible_labels)
        self.states = int(len(self.possible_labels))
        if self.states < 2:
            raise ValueError("need >= 2 states")
        self.meta_stability = meta_stability
        self.p_correct = p_correct

    def _log_trans(self) -> np.ndarray:
        off = (1.0 - self.meta_stability) / (self.states - 1)
        t = np.full((self.states, self.states), np.log(off))
        np.fill_diagonal(t, np.log(self.meta_stability))
        return t

    def _log_emit(self, obs: np.ndarray) -> np.ndarray:
        """[frames, states] log P(observed label | true state)."""
        off = (1.0 - self.p_correct) / (self.states - 1)
        e = np.full((len(obs), self.states), np.log(off))
        e[np.arange(len(obs)), obs] = np.log(self.p_correct)
        return e

    def decode(self, labels, binary_label_matrix: bool = None) -> Tuple[float, np.ndarray]:
        """labels: int sequence of observed outcomes, or a one-hot
        [frames, states] matrix (reference decode(labels, true))."""
        labels = np.asarray(labels)
        if binary_label_matrix is None:
            binary_label_matrix = labels.ndim == 2
        obs = (np.argmax(labels, axis=1) if binary_label_matrix
               else labels.astype(int).ravel())
        frames = len(obs)
        if frames == 0:
            return 0.0, np.array([], dtype=int)
        log_t = self._log_trans()
        log_e = self._log_emit(obs)

        v = np.full((frames, self.states), -np.inf)
        ptr = np.zeros((frames, self.states), dtype=int)
        v[0] = -np.log(self.states) + log_e[0]
        for t in range(1, frames):
            scores = v[t - 1][:, None] + log_t          # [from, to]
            ptr[t] = np.argmax(scores, axis=0)
            v[t] = scores[ptr[t], np.arange(self.states)] + log_e[t]

        path = np.zeros(frames, dtype=int)
        path[-1] = int(np.argmax(v[-1]))
        for t in range(frames - 2, -1, -1):
            path[t] = ptr[t + 1][path[t + 1]]
        return float(v[-1].max()), path
