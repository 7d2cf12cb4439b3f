"""Quad-tree — the 2-D space-partitioning tree (reference: clustering/
quadtree/{QuadTree, Cell}.java).

The reference maintains QuadTree separately from SpTree with the same
Barnes-Hut role specialised to 2-D (the t-SNE output dimensionality). Here it
wraps SpTree with a 2-D check plus the quadrant-named accessors the 2-D API
exposes.

The port's copy of the JAX package's clustering/quadtree.py (numpy on the
host, the same results on the same input); the port imports nothing of that
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree


class QuadTree(SpTree):
    """2-D Barnes-Hut tree (quadtree/QuadTree.java)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float64)
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError("QuadTree requires [N, 2] data")
        super().__init__(data)

    # quadrant-named child accessors (QuadTree.java north-west etc.);
    # child index bit d set ⇔ on the + side of dim d.
    @property
    def south_west(self) -> Optional["SpTree"]:
        return self.children[0b00] if not self.is_leaf else None

    @property
    def south_east(self) -> Optional["SpTree"]:
        return self.children[0b01] if not self.is_leaf else None

    @property
    def north_west(self) -> Optional["SpTree"]:
        return self.children[0b10] if not self.is_leaf else None

    @property
    def north_east(self) -> Optional["SpTree"]:
        return self.children[0b11] if not self.is_leaf else None
