"""Vantage-point tree (reference: clustering/vptree/VPTree.java — backs the
UI nearest-neighbors view and WordVectors.wordsNearest TreeModelUtils).

Host-side metric tree for exact k-NN in general metric spaces. Built once
over an [N, D] matrix (optionally with string labels, the word2vec use-case),
then queried with `search`. Distances within a node are computed vectorised
over NumPy; the tree walk itself is host logic.

The port's copy of the JAX package's clustering/vptree.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _distances(metric: str, items: np.ndarray, point: np.ndarray) -> np.ndarray:
    if metric == "euclidean":
        return np.linalg.norm(items - point[None, :], axis=1)
    if metric == "cosine":
        # sqrt(2·(1−cos)) = euclidean distance between the normalised
        # vectors: a true metric (1−cos violates the triangle inequality and
        # would invalidate the VP prune bounds), monotone in cosine
        # similarity so rankings match cosine nearest-neighbour queries.
        denom = (np.linalg.norm(items, axis=1) * np.linalg.norm(point) + 1e-12)
        cos = np.clip((items @ point) / denom, -1.0, 1.0)
        return np.sqrt(np.maximum(2.0 * (1.0 - cos), 0.0))
    raise ValueError(f"unknown metric {metric}")


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """VP-tree over row vectors (VPTree.java: `new VPTree(items)`,
    `search(target, k, results, distances)`)."""

    def __init__(self, items: np.ndarray,
                 labels: Optional[Sequence[str]] = None,
                 metric: str = "euclidean", seed: int = 0):
        self.items = np.asarray(items, dtype=np.float64)
        if self.items.ndim != 2:
            raise ValueError("items must be [N, D]")
        self.labels = list(labels) if labels is not None else None
        if self.labels is not None and len(self.labels) != len(self.items):
            raise ValueError("labels length mismatch")
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.items))))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[int(self._rng.integers(len(idxs)))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        d = _distances(self.metric, self.items[rest], self.items[vp])
        # Split at the median *rank*, not the median value: ties (duplicate
        # rows are common in embedding matrices) would otherwise all land on
        # one side and stall the recursion. Rank-splitting guarantees both
        # halves shrink, so depth is O(log N). Correctness holds because
        # inside ⊆ {d <= threshold} and outside ⊆ {d >= threshold}.
        order = np.argsort(d, kind="stable")
        mid = len(rest) // 2
        node.threshold = float(d[order[mid]]) if mid < len(rest) else float(d[order[-1]])
        inside = [rest[i] for i in order[:mid]]
        outside = [rest[i] for i in order[mid:]]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def search(self, target, k: int) -> List[Tuple[float, int]]:
        """k nearest as (distance, row-index), nearest first."""
        target = np.asarray(target, dtype=np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [np.inf]

        def visit(node: Optional[_VPNode]) -> None:
            if node is None:
                return
            d = float(_distances(self.metric, self.items[node.index][None, :],
                                 target)[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        out = [(-negd, idx) for negd, idx in heap]
        out.sort(key=lambda t: t[0])
        return out

    def words_nearest(self, target, k: int) -> List[str]:
        """Label view of `search` (TreeModelUtils.wordsNearest)."""
        if self.labels is None:
            raise ValueError("tree built without labels")
        return [self.labels[i] for _, i in self.search(target, k)]
