"""Graph embeddings (reference: deeplearning4j-graph module — SURVEY.md
§2.5: graph/api/{IGraph,Vertex,Edge}, graph/graph/Graph.java,
data/GraphLoader.java, iterator walkers, models/deepwalk/DeepWalk.java;
JAX counterpart deeplearning4j_tpu/graph).

Host-side graph storage + walk generation (numpy, the JAX package's
walks exactly) feeding the port's SequenceVectors (walks are token
sequences of vertex ids), so DeepWalk trains with the same batched
skip-gram device steps as Word2Vec.
"""

from .api import Edge, Vertex
from .graph import Graph
from .loader import GraphLoader
from .walkers import (
    NoEdgeHandling,
    PopularityWalker,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from .deepwalk import DeepWalk, GraphVectorSerializer

__all__ = [
    "Edge",
    "Vertex",
    "Graph",
    "GraphLoader",
    "NoEdgeHandling",
    "RandomWalkIterator",
    "WeightedRandomWalkIterator",
    "PopularityWalker",
    "DeepWalk",
    "GraphVectorSerializer",
]
