"""Clustering and spatial-index algorithms (JAX counterpart
deeplearning4j_tpu/clustering; reference deeplearning4j-core
`org/deeplearning4j/clustering/`: kmeans, kdtree, vptree, quadtree,
sptree).

KMeans's Lloyd steps run on the card (kmeans.py: the distances as one
product); the spatial trees are host-side numpy structures for
nearest-neighbour queries and Barnes-Hut t-SNE, copies of the JAX
package's, since irregular tree walks are host work in both.
"""

from deeplearning4j_tpu_torch.clustering.cluster import (  # noqa: F401
    Cluster,
    ClusterSet,
    Point,
    PointClassification,
)
from deeplearning4j_tpu_torch.clustering.kdtree import (  # noqa: F401
    HyperRect,
    KDTree,
)
from deeplearning4j_tpu_torch.clustering.kmeans import (  # noqa: F401
    KMeansClustering,
)
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.sptree import SpTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401

__all__ = [
    "Cluster",
    "ClusterSet",
    "Point",
    "PointClassification",
    "KMeansClustering",
    "KDTree",
    "HyperRect",
    "VPTree",
    "QuadTree",
    "SpTree",
]
