"""KD-tree (reference: clustering/kdtree/{KDTree, HyperRect}.java).

Host-side structure: axis-cycling binary tree supporting insert, delete,
nearest-neighbour and range (hyper-rectangle) queries. Used by the reference
for spatial lookups; kept in NumPy — pointer-chasing tree walks are host
work, not TPU work.

The port's copy of the JAX package's clustering/kdtree.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class HyperRect:
    """Axis-aligned box with per-dim [lower, upper] intervals
    (kdtree/HyperRect.java)."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)

    @staticmethod
    def infinite(dims: int) -> "HyperRect":
        return HyperRect(np.full(dims, -np.inf), np.full(dims, np.inf))

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(point >= self.lower) and np.all(point <= self.upper))

    def min_distance(self, point: np.ndarray) -> float:
        """Distance from point to the nearest face of the box (0 if inside)."""
        clipped = np.clip(point, self.lower, self.upper)
        return float(np.linalg.norm(point - clipped))

    def get_lower(self, point: np.ndarray, dim: int) -> "HyperRect":
        upper = self.upper.copy()
        upper[dim] = point[dim]
        return HyperRect(self.lower.copy(), upper)

    def get_upper(self, point: np.ndarray, dim: int) -> "HyperRect":
        lower = self.lower.copy()
        lower[dim] = point[dim]
        return HyperRect(lower, self.upper.copy())


class _Node:
    __slots__ = ("point", "left", "right")

    def __init__(self, point: np.ndarray):
        self.point = point
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    """Axis-cycling kd-tree (kdtree/KDTree.java: insert, delete, nn, knn)."""

    def __init__(self, dims: int):
        self.dims = int(dims)
        self.root: Optional[_Node] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, dtype=np.float64)
        if point.shape != (self.dims,):
            raise ValueError(f"expected {self.dims}-d point")
        self.size += 1
        if self.root is None:
            self.root = _Node(point)
            return
        node, depth = self.root, 0
        while True:
            dim = depth % self.dims
            if point[dim] < node.point[dim]:
                if node.left is None:
                    node.left = _Node(point)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = _Node(point)
                    return
                node = node.right
            depth += 1

    def delete(self, point) -> bool:
        """Remove one node holding `point`. Rebuilds the subtree rooted at
        the removed node from its surviving points (median-split, so the
        rebuilt subtree is balanced) — simpler and more robust than the
        classic find-min replacement dance, and the reference's delete is a
        rarely-hot path."""
        point = np.asarray(point, dtype=np.float64)
        parent: Optional[_Node] = None
        node, depth, from_left = self.root, 0, False
        while node is not None and not np.array_equal(node.point, point):
            parent = node
            dim = depth % self.dims
            from_left = point[dim] < node.point[dim]
            node = node.left if from_left else node.right
            depth += 1
        if node is None:
            return False
        # collect the subtree's points minus the deleted node, iteratively
        pts: List[np.ndarray] = []
        stack = [c for c in (node.left, node.right) if c is not None]
        while stack:
            cur = stack.pop()
            pts.append(cur.point)
            stack.extend(c for c in (cur.left, cur.right) if c is not None)
        rebuilt = self._build_balanced(pts, depth)
        if parent is None:
            self.root = rebuilt
        elif from_left:
            parent.left = rebuilt
        else:
            parent.right = rebuilt
        self.size -= 1
        return True

    def _build_balanced(self, pts: List[np.ndarray], depth: int) -> Optional[_Node]:
        if not pts:
            return None
        dim = depth % self.dims
        pts = sorted(pts, key=lambda p: p[dim])
        mid = len(pts) // 2
        # descent invariant: strictly-less goes left, >= goes right — shift
        # the split to the first duplicate so no equal value lands left
        while mid > 0 and pts[mid - 1][dim] == pts[mid][dim]:
            mid -= 1
        node = _Node(pts[mid])
        node.left = self._build_balanced(pts[:mid], depth + 1)
        node.right = self._build_balanced(pts[mid + 1:], depth + 1)
        return node

    def nn(self, point) -> Tuple[float, Optional[np.ndarray]]:
        """Nearest neighbour: (distance, point)."""
        res = self.knn(point, 1)
        return res[0] if res else (np.inf, None)

    def knn(self, point, k: int) -> List[Tuple[float, np.ndarray]]:
        """k nearest neighbours as (distance, point), nearest first."""
        point = np.asarray(point, dtype=np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap via -dist
        counter = 0
        # Explicit stack instead of recursion: unbalanced inserts (sorted
        # input) can make the tree O(N) deep, which would blow the Python
        # recursion limit. Entries are (node, depth, is_far_child, parent
        # plane distance); far children re-check the prune bound at pop time
        # because tau may have tightened since they were pushed.
        stack: List[Tuple[_Node, int, bool, float]] = [(self.root, 0, False, 0.0)] if self.root else []
        while stack:
            node, depth, is_far, plane_dist = stack.pop()
            if is_far and len(heap) == k and plane_dist >= -heap[0][0]:
                continue
            d = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, counter, node.point))
                counter += 1
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, counter, node.point))
                counter += 1
            dim = depth % self.dims
            diff = point[dim] - node.point[dim]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            # push far first so near is explored first (LIFO)
            if far is not None:
                stack.append((far, depth + 1, True, abs(diff)))
            if near is not None:
                stack.append((near, depth + 1, False, 0.0))
        out = [(-negd, pt) for negd, _, pt in heap]
        out.sort(key=lambda t: t[0])
        return out

    def range(self, rect: HyperRect) -> List[np.ndarray]:
        """All points inside the hyper-rectangle."""
        out: List[np.ndarray] = []
        stack: List[Tuple[_Node, int]] = [(self.root, 0)] if self.root else []
        while stack:
            node, depth = stack.pop()
            if rect.contains(node.point):
                out.append(node.point)
            dim = depth % self.dims
            if node.left is not None and rect.lower[dim] < node.point[dim]:
                stack.append((node.left, depth + 1))
            if node.right is not None and rect.upper[dim] >= node.point[dim]:
                stack.append((node.right, depth + 1))
        return out
