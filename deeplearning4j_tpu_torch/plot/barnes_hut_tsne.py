"""Barnes-Hut t-SNE (reference: plot/BarnesHutTsne.java — implements Model;
sparse input affinities via k-NN + per-row beta search, SpTree-accelerated
gradient :310, fit():435-474).

Host-side by design: Barnes-Hut's pruned tree traversal is irregular,
data-dependent control flow that XLA cannot tile — the same reason the
reference keeps it on the CPU heap. The O(N·u) k-NN affinity construction is
vectorised NumPy; use the exact `Tsne` class when N is small enough to
prefer the all-pairs on-device path.

The port's copy of the JAX package's plot/barnes_hut_tsne.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree


def _knn_affinities(x: np.ndarray, perplexity: float, k: int,
                    tol: float = 1e-5, iters: int = 50):
    """Sparse conditional affinities over each row's k nearest neighbours
    (BarnesHutTsne.computeGaussianPerplexity). Returns CSR (rows, cols,
    vals).

    k-NN runs in row blocks with argpartition so peak memory is
    O(block * N), never a full dense [N, N] matrix — the whole point of the
    Barnes-Hut path is N too large for the exact all-pairs code.
    """
    n = x.shape[0]
    sum_x = np.sum(x * x, axis=1)
    block = max(1, min(n, (1 << 26) // max(n, 1)))       # ~512MB f64 cap
    nbr = np.empty((n, k), dtype=np.int64)
    nd2 = np.empty((n, k), dtype=np.float64)
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = np.maximum(sum_x[s:e, None] + sum_x[None, :]
                        - 2.0 * x[s:e] @ x.T, 0.0)       # [b, N]
        d2[np.arange(e - s), np.arange(s, e)] = np.inf
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd2 = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd2, axis=1)
        nbr[s:e] = np.take_along_axis(part, order, axis=1)
        nd2[s:e] = np.take_along_axis(pd2, order, axis=1)

    log_u = np.log(perplexity)
    beta = np.ones(n)
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    for _ in range(iters):
        logits = -nd2 * beta[:, None]
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        p = e / e.sum(axis=1, keepdims=True)
        h = -np.sum(np.where(p > 0, p * np.log(p + 1e-30), 0.0), axis=1)
        diff = h - log_u
        if np.all(np.abs(diff) < tol):
            break
        too_high = diff > 0
        lo = np.where(too_high, beta, lo)
        hi = np.where(too_high, hi, beta)
        beta = np.where(
            too_high,
            np.where(np.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            (lo + beta) / 2.0,
        )
    logits = -nd2 * beta[:, None]
    logits -= logits.max(axis=1, keepdims=True)
    e = np.exp(logits)
    p = e / e.sum(axis=1, keepdims=True)

    rows = np.arange(0, n * k + 1, k)
    return rows, nbr.reshape(-1), p.reshape(-1)


def _symmetrize_csr(rows, cols, vals, n):
    """P = (P + Pᵀ) / (2N) on the sparse structure
    (BarnesHutTsne symmetrized affinity). Edges are bucketed per row so the
    whole pass is O(N·k), not a global-dict scan per row."""
    per_row: list[dict] = [{} for _ in range(n)]
    for i in range(n):
        for idx in range(rows[i], rows[i + 1]):
            j = int(cols[idx])
            v = float(vals[idx])
            per_row[i][j] = per_row[i].get(j, 0.0) + v
            per_row[j][i] = per_row[j].get(i, 0.0) + v
    total = 2.0 * n
    out_rows = [0]
    out_cols: list[int] = []
    out_vals: list[float] = []
    for i in range(n):
        for j in sorted(per_row[i]):
            out_cols.append(j)
            out_vals.append(per_row[i][j] / total)
        out_rows.append(len(out_cols))
    return (np.asarray(out_rows), np.asarray(out_cols),
            np.asarray(out_vals, dtype=np.float64))


class BarnesHutTsne:
    """θ-approximate t-SNE (plot/BarnesHutTsne.java: theta default 0.5,
    fit():435; gradient():310 = edge forces − non-edge forces / sumQ)."""

    def __init__(self, max_iter: int = 1000, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250,
                 stop_lying_iteration: int = 250, exaggeration: float = 12.0,
                 min_gain: float = 0.01, seed: int = 0):
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.min_gain = min_gain
        self.seed = seed
        self.y: Optional[np.ndarray] = None
        self.kl_divergences: list[float] = []

    def _gradient(self, y, rows, cols, vals):
        tree = SpTree(y)
        pos_f = tree.compute_edge_forces(rows, cols, vals)
        neg_f = np.zeros_like(y)
        sum_q = 0.0
        for i in range(len(y)):
            f = np.zeros(y.shape[1])
            sum_q += tree.compute_non_edge_forces(i, self.theta, f)
            neg_f[i] = f
        return pos_f - neg_f / max(sum_q, 1e-12)

    def fit(self, x, target_dimensions: int = 2) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        rows, cols, vals = _knn_affinities(x, self.perplexity, k)
        rows, cols, vals = _symmetrize_csr(rows, cols, vals, n)

        rng = np.random.default_rng(self.seed)
        y = rng.normal(scale=1e-4, size=(n, target_dimensions))
        iy = np.zeros_like(y)
        gains = np.ones_like(y)

        self.kl_divergences = []
        for i in range(self.max_iter):
            lying = i < self.stop_lying_iteration
            v = vals * self.exaggeration if lying else vals
            dy = self._gradient(y, rows, cols, v)
            momentum = (self.initial_momentum if i < self.momentum_switch
                        else self.final_momentum)
            same_sign = np.sign(dy) == np.sign(iy)
            gains = np.where(same_sign, gains * 0.8, gains + 0.2)
            gains = np.maximum(gains, self.min_gain)
            iy = momentum * iy - self.learning_rate * (gains * dy)
            y = y + iy
            y -= y.mean(axis=0, keepdims=True)
        self.y = y
        return y

    # reference naming (BarnesHutTsne implements Model → getData)
    def get_data(self) -> Optional[np.ndarray]:
        return self.y
