"""KMeans clustering on the card (JAX counterpart
deeplearning4j_tpu/clustering/kmeans.py; reference clustering/kmeans/
KMeansClustering.java + algorithm/BaseClusteringAlgorithm.java with its
FixedClusterCountStrategy, FixedIterationCountCondition and
VarianceVariationCondition).

One Lloyd iteration is a handful of PyTorch calls on the points' device:
the [N, K] squared distances as ||x||^2 + ||c||^2 - 2 X C^T (one
product), the assignment as an argmin (ties to the lowest cluster, as
`jnp.argmin`), and the new centers from per-cluster sums and counts
(`index_add_`, the counterpart of `segment_sum`). On the card
`index_add_` sums with atomics, so its f32 rounding differs from the
CPU's and from XLA's; a point at a near-tie between two centers may then
change cluster. The convergence conditions run on the host between
steps, reading one distortion a step.

The k-means++ seeding draws from numpy in the JAX package's order, so a
seed picks the same initial centers in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.clustering.cluster import (Cluster, ClusterSet,
                                                         Point)


def _lloyd_step(points, centers, k):
    """One Lloyd iteration. points [N, D], centers [K, D] (one device, f32)
    -> (new_centers, assignments [N] int64, distortion (0-d tensor))."""
    x2 = (points * points).sum(1, keepdim=True)                   # [N, 1]
    c2 = (centers * centers).sum(1)[None, :]                       # [1, K]
    d2 = x2 + c2 - 2.0 * points @ centers.T                        # [N, K]
    best, assign = d2.min(1)
    distortion = best.clamp_min(0.0).sum()
    sums = torch.zeros_like(centers).index_add_(0, assign, points)
    counts = torch.zeros(k, dtype=points.dtype,
                         device=points.device).index_add_(
        0, assign, torch.ones_like(best))
    # empty clusters keep their previous center (the reference keeps the
    # cluster alive rather than dropping it)
    new_centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
    return new_centers, assign, distortion


class KMeansClustering:
    """Fixed-cluster-count KMeans (kmeans/KMeansClustering.java:setup).

    Termination mirrors the reference's two conditions: a fixed
    iteration count (`max_iterations`) and a variance-variation
    condition (`variation_tolerance` on the relative distortion change).
    Runs on `device` (CUDA unless the caller names another).
    """

    def __init__(self, cluster_count: int, max_iterations: int = 100,
                 variation_tolerance: float = 1e-4, seed: int = 0,
                 init: str = "k-means++", device=None):
        if cluster_count < 1:
            raise ValueError("cluster_count must be >= 1")
        self.k = int(cluster_count)
        self.max_iterations = int(max_iterations)
        self.variation_tolerance = float(variation_tolerance)
        self.seed = seed
        self.init = init
        self.device = resolve_device(device)
        self.iteration_count = 0
        self.distortion_history: list[float] = []
        self.centers = None
        self.assignments = None

    @staticmethod
    def setup(cluster_count: int, max_iterations: int = 100,
              distance_function: str = "euclidean", seed: int = 0,
              device=None) -> "KMeansClustering":
        """Reference-parity factory (KMeansClustering.java `setup`). Only
        the euclidean distance maps to the distance product."""
        if distance_function not in ("euclidean", "sqeuclidean"):
            raise ValueError(f"unsupported distance: {distance_function}")
        return KMeansClustering(cluster_count, max_iterations, seed=seed,
                                device=device)

    def _init_centers(self, matrix: np.ndarray) -> np.ndarray:
        """Row indices of the initial centers, drawn on the host from
        numpy in the JAX package's order."""
        n = matrix.shape[0]
        rng = np.random.default_rng(self.seed)
        if self.init == "random" or self.k == 1:
            return np.asarray(rng.choice(n, size=self.k, replace=False))
        # k-means++: sample proportional to the distance to the nearest
        # chosen center, with a running min
        np_pts = np.asarray(matrix, dtype=np.float64)
        chosen = [int(rng.integers(n))]
        d2 = np.sum((np_pts - np_pts[chosen[0]][None, :]) ** 2, axis=1)
        for _ in range(1, self.k):
            total = d2.sum()
            if total <= 0:
                remaining = [i for i in range(n) if i not in chosen]
                chosen.append(int(rng.choice(remaining)))
            else:
                chosen.append(int(rng.choice(n, p=d2 / total)))
            d2 = np.minimum(
                d2, np.sum((np_pts - np_pts[chosen[-1]][None, :]) ** 2,
                           axis=1))
        return np.asarray(chosen)

    def apply_to(self, points) -> ClusterSet:
        """Run Lloyd iterations to convergence; returns a populated
        ClusterSet (BaseClusteringAlgorithm.applyTo). `points`: a list of
        Point, or an [N, D] array or tensor. The final centers and
        memberships also stay on the object (`centers`, `assignments`,
        tensors on the device)."""
        if isinstance(points, (list, tuple)) and points \
                and isinstance(points[0], Point):
            matrix = np.stack([p.array for p in points]).astype(np.float32)
            point_objs = list(points)
        else:
            if isinstance(points, torch.Tensor):
                points = points.detach().float().cpu().numpy()
            matrix = np.asarray(points, dtype=np.float32)
            point_objs = Point.to_points(matrix)
        if matrix.ndim != 2:
            raise ValueError("points must be [N, D]")
        if matrix.shape[0] < self.k:
            raise ValueError(f"need >= {self.k} points, got "
                             f"{matrix.shape[0]}")

        pts = torch.from_numpy(matrix).to(self.device)
        centers = pts[torch.from_numpy(self._init_centers(matrix)).to(
            self.device)]
        self.distortion_history = []
        prev = None
        for i in range(self.max_iterations):
            centers, _, distortion = _lloyd_step(pts, centers, self.k)
            distortion = float(distortion)
            self.distortion_history.append(distortion)
            self.iteration_count = i + 1
            if prev is not None:
                denom = max(prev, 1e-12)
                if abs(prev - distortion) / denom < self.variation_tolerance:
                    break
            prev = distortion
        # the final assignment against the FINAL centers (the in-loop one
        # is against the centers before the update)
        _, assign, _ = _lloyd_step(pts, centers, self.k)
        self.centers, self.assignments = centers, assign

        centers_np = centers.cpu().numpy()
        assign_np = assign.cpu().numpy()
        clusters = [Cluster(center=centers_np[j], id=str(j))
                    for j in range(self.k)]
        for pi, ci in enumerate(assign_np):
            clusters[int(ci)].add_point(point_objs[pi])
        return ClusterSet(clusters)
