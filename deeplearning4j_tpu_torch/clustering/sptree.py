"""Space-partitioning tree for Barnes-Hut t-SNE (reference: clustering/
sptree/{SpTree, Cell, DataPoint}.java — computeNonEdgeForces /
computeEdgeForces feed plot/BarnesHutTsne.java:310).

An n-dimensional tree with 2^d children per cell, storing center-of-mass and
cumulative size per subtree. Host-side: Barnes-Hut's data-dependent pruned
traversal is irregular host work; the O(N·logN) force sums it produces are
small and feed the t-SNE update step.

The port's copy of the JAX package's clustering/sptree.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Cell:
    """Axis-aligned cell: center `corner` + half-width `width` per dim
    (sptree/Cell.java)."""

    __slots__ = ("corner", "width")

    def __init__(self, corner: np.ndarray, width: np.ndarray):
        self.corner = corner
        self.width = width

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(point - self.corner) <= self.width + 1e-12))


class SpTree:
    """Barnes-Hut space-partitioning tree (sptree/SpTree.java).

    Build over data [N, D]; query with `compute_non_edge_forces` (repulsive
    term, theta-pruned) and `compute_edge_forces` (attractive term over the
    sparse P matrix).
    """

    QT_NODE_CAPACITY = 1  # leaf capacity, as in the reference

    def __init__(self, data: np.ndarray, cell: Optional[Cell] = None,
                 indices: Optional[List[int]] = None):
        data = np.asarray(data, dtype=np.float64)
        self.data = data
        self.dims = data.shape[1]
        self.n_children = 2 ** self.dims
        if cell is None:
            mins = data.min(axis=0)
            maxs = data.max(axis=0)
            center = (mins + maxs) / 2.0
            width = (maxs - mins) / 2.0 + 1e-5
            cell = Cell(center, width)
        self.cell = cell
        self.center_of_mass = np.zeros(self.dims)
        self.cum_size = 0
        self.point_index: Optional[int] = None  # leaf payload
        self.children: List[Optional[SpTree]] = [None] * self.n_children
        self.is_leaf = True
        for i in (indices if indices is not None else range(len(data))):
            self.insert(int(i))

    def insert(self, index: int) -> bool:
        point = self.data[index]
        if not self.cell.contains(point):
            return False
        self.cum_size += 1
        mult1 = (self.cum_size - 1) / self.cum_size
        self.center_of_mass = self.center_of_mass * mult1 + point / self.cum_size

        if self.is_leaf and self.point_index is None:
            self.point_index = index
            return True
        # duplicate point: just accounted for in center-of-mass/cum_size
        if self.point_index is not None and np.allclose(point, self.data[self.point_index]):
            return True
        if self.is_leaf:
            self._subdivide()
        for child in self.children:
            if child is not None and child.insert(index):
                return True
        return False  # pragma: no cover - cell geometry guarantees insertion

    def _subdivide(self) -> None:
        half = self.cell.width / 2.0
        for c in range(self.n_children):
            offset = np.array([(1 if (c >> d) & 1 else -1) for d in range(self.dims)],
                              dtype=np.float64)
            corner = self.cell.corner + offset * half
            self.children[c] = SpTree(self.data, Cell(corner, half.copy()),
                                      indices=[])
        moved = self.point_index
        # this leaf may hold duplicates (cum_size counts them; the insert
        # that triggered subdivision already bumped cum_size for the NEW
        # point, which insert() will place afterwards) — re-insert the moved
        # point once per absorbed copy so no mass is dropped
        multiplicity = self.cum_size - 1
        self.point_index = None
        self.is_leaf = False
        if moved is not None:
            for _ in range(max(1, multiplicity)):
                for child in self.children:
                    if child.insert(moved):
                        break

    def compute_non_edge_forces(self, point_index: int, theta: float,
                                neg_f: np.ndarray) -> float:
        """Accumulate repulsive forces on `neg_f` [D]; returns this subtree's
        contribution to sum_Q (SpTree.computeNonEdgeForces)."""
        if self.cum_size == 0:
            return 0.0
        if self.is_leaf and self.point_index == point_index and self.cum_size == 1:
            return 0.0
        point = self.data[point_index]
        diff = point - self.center_of_mass
        d2 = float(diff @ diff)
        max_width = float(self.cell.width.max() * 2.0)
        # Barnes-Hut criterion: treat cell as one body if compact enough
        if self.is_leaf or (max_width * max_width) < (theta * theta) * d2:
            if self.is_leaf and (
                    self.point_index == point_index
                    or np.allclose(self.data[self.point_index], point)):
                # leaf holding (a duplicate of) the query point: exclude only
                # the query point itself. Remaining collapsed copies still
                # count toward sum_Q (cum_size-1 bodies at d2=0 → q=1, zero
                # net force) — the reference only short-circuits on size==1.
                return float(self.cum_size - 1)
            q = 1.0 / (1.0 + d2)
            mult = self.cum_size * q
            sum_q = mult
            neg_f += mult * q * diff
            return sum_q
        sum_q = 0.0
        for child in self.children:
            if child is not None:
                sum_q += child.compute_non_edge_forces(point_index, theta, neg_f)
        return sum_q

    def compute_edge_forces(self, rows: np.ndarray, cols: np.ndarray,
                            vals: np.ndarray) -> np.ndarray:
        """Attractive forces for all points given CSR-style (rows, cols,
        vals) of the symmetrised P matrix (SpTree.computeEdgeForces).
        Vectorised over all edges. Returns pos_f [N, D]."""
        n = len(self.data)
        pos_f = np.zeros_like(self.data)
        for i in range(n):
            start, end = rows[i], rows[i + 1]
            if start == end:
                continue
            js = cols[start:end]
            diff = self.data[i][None, :] - self.data[js]       # [E, D]
            d2 = 1.0 + np.sum(diff * diff, axis=1)             # [E]
            w = (vals[start:end] / d2)[:, None]
            pos_f[i] = np.sum(w * diff, axis=0)
        return pos_f

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max((c.depth() for c in self.children if c is not None),
                       default=0)
