"""Cluster model objects (reference: clustering/cluster/{Point, Cluster,
ClusterSet, PointClassification}.java).

Thin host-side containers over NumPy arrays. The heavy math (assignment,
center updates) lives in `kmeans.py` as jitted batch ops; these classes are
the user-facing result/aggregate view the reference exposes.

The port's copy of the JAX package's clustering/cluster.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Point:
    """A single point with an optional id/label (cluster/Point.java)."""

    array: np.ndarray
    id: Optional[str] = None
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix: np.ndarray) -> List["Point"]:
        return [Point(np.asarray(row), id=str(i)) for i, row in enumerate(matrix)]


@dataclass
class PointClassification:
    """Result of classifying one point into a ClusterSet
    (cluster/PointClassification.java)."""

    cluster: "Cluster"
    distance: float
    new_location: bool


@dataclass
class Cluster:
    """One cluster: a center plus its member points (cluster/Cluster.java)."""

    center: np.ndarray
    points: List[Point] = field(default_factory=list)
    id: Optional[str] = None
    label: Optional[str] = None

    def add_point(self, point: Point) -> None:
        self.points.append(point)

    def remove_points(self) -> None:
        self.points = []

    def distance_to_center(self, point: Point) -> float:
        return float(np.linalg.norm(point.array - self.center))

    def is_empty(self) -> bool:
        return not self.points


class ClusterSet:
    """A set of clusters + assignment API (cluster/ClusterSet.java).

    `classify_point` returns the nearest cluster; `classify_points` does the
    batch variant in one vectorised distance computation.
    """

    def __init__(self, clusters: Optional[Sequence[Cluster]] = None):
        self.clusters: List[Cluster] = list(clusters or [])

    @property
    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def add_cluster(self, cluster: Cluster) -> None:
        self.clusters.append(cluster)

    def cluster_count(self) -> int:
        return len(self.clusters)

    def get_cluster(self, idx: int) -> Cluster:
        return self.clusters[idx]

    def remove_points(self) -> None:
        for c in self.clusters:
            c.remove_points()

    def classify_point(self, point: Point, move: bool = True) -> PointClassification:
        centers = self.centers
        d = np.linalg.norm(centers - point.array[None, :], axis=1)
        idx = int(np.argmin(d))
        cluster = self.clusters[idx]
        previously = any(p is point for p in cluster.points)
        if move and not previously:
            # move semantics: a point belongs to exactly one cluster
            for other in self.clusters:
                other.points = [p for p in other.points if p is not point]
            cluster.add_point(point)
        return PointClassification(cluster, float(d[idx]), not previously)

    def classify_points(self, points: Sequence[Point], move: bool = True) -> List[PointClassification]:
        """Batch classify: one [N, K] distance computation, then the same
        move semantics as classify_point."""
        if not points:
            return []
        centers = self.centers
        pts = np.stack([p.array for p in points])
        d = np.linalg.norm(pts[:, None, :] - centers[None, :, :], axis=2)
        idxs = np.argmin(d, axis=1)
        out = []
        moving: List[Point] = []
        for p, di, idx in zip(points, d, idxs):
            cluster = self.clusters[int(idx)]
            previously = any(q is p for q in cluster.points)
            if move and not previously:
                moving.append(p)
            out.append(PointClassification(cluster, float(di[idx]), not previously))
        if moving:
            # strip all moving points in ONE pass per cluster, then append
            # each to its target — the per-point variant would rebuild every
            # cluster list N times
            moving_ids = {id(p) for p in moving}
            for c in self.clusters:
                c.points = [q for q in c.points if id(q) not in moving_ids]
            for p, idx in zip(points, idxs):
                if id(p) in moving_ids:
                    self.clusters[int(idx)].add_point(p)
        return out

    def inertia(self) -> float:
        """Sum of squared member→center distances (distortion cost)."""
        total = 0.0
        for c in self.clusters:
            if c.points:
                pts = np.stack([p.array for p in c.points])
                total += float(((pts - c.center[None, :]) ** 2).sum())
        return total
