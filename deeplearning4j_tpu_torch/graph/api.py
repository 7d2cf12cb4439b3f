"""Graph primitives (reference: deeplearning4j-graph
graph/api/{Vertex, Edge}.java; JAX counterpart
deeplearning4j_tpu/graph/api.py, host code kept as the port's own
copy)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Vertex:
    """A vertex: integer index + optional payload (api/Vertex.java)."""

    idx: int
    value: Any = None


@dataclass(frozen=True)
class Edge:
    """An edge between vertex indices, optionally weighted/directed
    (api/Edge.java)."""

    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False
    value: Optional[Any] = None
