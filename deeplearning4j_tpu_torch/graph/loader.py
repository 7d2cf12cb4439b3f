"""Graph loading from edge-list files (reference: deeplearning4j-graph
data/GraphLoader.java + edge/vertex line processors: loadUndirectedGraphEdgeListFile,
loadWeightedEdgeListFile; JAX counterpart deeplearning4j_tpu/graph/loader.py,
host code kept as the port's own copy)."""

from __future__ import annotations

from typing import Optional

from .graph import Graph


class GraphLoader:
    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, num_vertices: int,
                                             delimiter: Optional[str] = None) -> Graph:
        """Each line: `src dst` (GraphLoader.loadUndirectedGraphEdgeListFile)."""
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                g.add_edge(int(parts[0]), int(parts[1]))
        return g

    @staticmethod
    def load_weighted_edge_list_file(path: str, num_vertices: int,
                                     delimiter: Optional[str] = None,
                                     directed: bool = False) -> Graph:
        """Each line: `src dst weight` (GraphLoader.loadWeightedEdgeListFile)."""
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                g.add_edge(int(parts[0]), int(parts[1]),
                           weight=float(parts[2]), directed=directed)
        return g

    @staticmethod
    def load_adjacency_list_file(path: str, num_vertices: int,
                                 delimiter: Optional[str] = None) -> Graph:
        """Each line: `v n1 n2 ...` — directed edges v→ni
        (GraphLoader adjacency list variant)."""
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                v = int(parts[0])
                for n in parts[1:]:
                    g.add_edge(v, int(n), directed=True)
        return g
