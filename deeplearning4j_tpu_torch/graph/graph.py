"""In-memory adjacency-list graph (reference: graph/graph/Graph.java —
addEdge, getVertexDegree, getConnectedVertexIndices, getEdgesOut; JAX
counterpart deeplearning4j_tpu/graph/graph.py, host code kept as the
port's own copy).

Adjacency is stored as per-vertex NumPy arrays (neighbour indices +
weights) so walk generation samples with vectorised RNG calls rather than
per-edge object traversal.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from .api import Edge, Vertex


class Graph:
    """Adjacency-list graph over `num_vertices` integer-indexed vertices."""

    def __init__(self, num_vertices: int, allow_multiple_edges: bool = True,
                 vertices: Optional[Sequence[Vertex]] = None):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self.num_vertices_ = int(num_vertices)
        self.allow_multiple_edges = allow_multiple_edges
        self.vertices: List[Vertex] = (
            list(vertices) if vertices is not None
            else [Vertex(i) for i in range(num_vertices)])
        if len(self.vertices) != num_vertices:
            raise ValueError("vertices length mismatch")
        self._adj: List[List[int]] = [[] for _ in range(num_vertices)]
        self._w: List[List[float]] = [[] for _ in range(num_vertices)]
        self._edges: List[Edge] = []
        self._frozen_adj: Optional[List[np.ndarray]] = None
        self._frozen_w: Optional[List[np.ndarray]] = None

    # ------------------------------------------------------------ mutation
    def add_edge(self, edge_or_src, dst: Optional[int] = None,
                 weight: float = 1.0, directed: bool = False) -> None:
        e = (edge_or_src if isinstance(edge_or_src, Edge)
             else Edge(int(edge_or_src), int(dst), weight, directed))
        for v in (e.src, e.dst):
            if not (0 <= v < self.num_vertices_):
                raise ValueError(f"vertex index {v} out of range")
        if not self.allow_multiple_edges and e.dst in self._adj[e.src]:
            return
        self._edges.append(e)
        self._adj[e.src].append(e.dst)
        self._w[e.src].append(e.weight)
        if not e.directed and e.src != e.dst:
            self._adj[e.dst].append(e.src)
            self._w[e.dst].append(e.weight)
        self._frozen_adj = self._frozen_w = None

    # ------------------------------------------------------------- queries
    def num_vertices(self) -> int:
        return self.num_vertices_

    def num_edges(self) -> int:
        return len(self._edges)

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def get_connected_vertex_indices(self, idx: int) -> np.ndarray:
        self._freeze()
        return self._frozen_adj[idx]

    def get_edge_weights(self, idx: int) -> np.ndarray:
        self._freeze()
        return self._frozen_w[idx]

    def get_edges_out(self, idx: int) -> List[Edge]:
        """Edges leaving `idx`, always oriented src=idx → dst=neighbour
        (undirected edges stored as (a, idx) are returned reoriented)."""
        out = []
        for e in self._edges:
            if e.src == idx:
                out.append(e)
            elif not e.directed and e.dst == idx:
                out.append(Edge(idx, e.src, e.weight, e.directed, e.value))
        return out

    def edges(self) -> Iterable[Edge]:
        return iter(self._edges)

    def degrees(self) -> np.ndarray:
        return np.array([len(a) for a in self._adj])

    def _freeze(self) -> None:
        if self._frozen_adj is None:
            self._frozen_adj = [np.asarray(a, dtype=np.int64) for a in self._adj]
            self._frozen_w = [np.asarray(w, dtype=np.float64) for w in self._w]
