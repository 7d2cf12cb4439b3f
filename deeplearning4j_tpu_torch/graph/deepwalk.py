"""DeepWalk node embeddings (reference: deeplearning4j-graph
models/deepwalk/DeepWalk.java — skip-gram with hierarchical softmax over
random walks, GraphHuffman coding; embeddings/InMemoryGraphLookupTable.java;
GraphVectorSerializer.java; JAX counterpart
deeplearning4j_tpu/graph/deepwalk.py).

Walks are generated on the host and fed to the port's SequenceVectors,
so training is the same batched skip-gram step as Word2Vec: hierarchical
softmax (as the reference) through the embedding engine's `hs_step`
(row-sharded at `engine_ep` > 1, see `Builder.use_engine`), with the
tables on `device` (CUDA unless the caller names another).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors

from .graph import Graph
from .walkers import RandomWalkIterator, WeightedRandomWalkIterator, walk_sequences


class DeepWalk:
    """DeepWalk trainer (DeepWalk.java Builder: vectorSize, windowSize,
    learningRate; fit(graph, walkLength))."""

    class Builder:
        def __init__(self):
            self._kw = dict(vector_size=100, window_size=5,
                            learning_rate=0.025, seed=0)

        def device(self, device):
            """Where the tables live and the steps run (default CUDA)."""
            self._kw["device"] = device
            return self

        def vector_size(self, n: int):
            self._kw["vector_size"] = n
            return self

        def window_size(self, n: int):
            self._kw["window_size"] = n
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def use_engine(self, flag=True, ep: int = 1, dp: int = 1):
            """Embedding-engine training (on by default), row-sharded
            over ep and batch-split over dp over the process group of
            ep * dp ranks — see Word2Vec.Builder.use_engine."""
            self._kw["use_engine"] = flag
            self._kw["engine_ep"] = int(ep)
            self._kw["engine_dp"] = int(dp)
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    @staticmethod
    def builder() -> "DeepWalk.Builder":
        return DeepWalk.Builder()

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, seed: int = 0,
                 use_engine: bool = True, engine_ep: int = 1,
                 engine_dp: int = 1, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        # DeepWalk is a thin front-end over the embedding engine
        # (embedding/engine.py): its HS step is the legacy dense step's
        # math, row-sharded at ep > 1
        self.use_engine = use_engine
        self.engine_ep = engine_ep
        self.engine_dp = engine_dp
        self.device = device
        self.vectors: Optional[SequenceVectors] = None
        self.num_vertices = 0

    def fit(self, graph_or_walker, walk_length: int = 40,
            walks_per_vertex: int = 1, epochs: int = 1,
            weighted: bool = False,
            no_edge_handling: str | None = None) -> "DeepWalk":
        """Generate walks and train (DeepWalk.fit(IGraph, walkLength)).
        Accepts a Graph (builds the walker) or a walk iterator. The walker
        default raises on dead-end vertices (reference parity); pass
        no_edge_handling=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED for graphs
        with sinks."""
        if isinstance(graph_or_walker, Graph):
            cls = WeightedRandomWalkIterator if weighted else RandomWalkIterator
            kw = ({} if no_edge_handling is None
                  else {"no_edge_handling": no_edge_handling})
            walker = cls(graph_or_walker, walk_length, seed=self.seed, **kw)
            self.num_vertices = graph_or_walker.num_vertices()
        else:
            walker = graph_or_walker
            self.num_vertices = walker.graph.num_vertices()
        seqs = walk_sequences(walker, walks_per_vertex)
        # hierarchical softmax over vertex frequency, as the reference's
        # GraphHuffman; every vertex is kept regardless of frequency
        self.vectors = SequenceVectors(
            layer_size=self.vector_size, window_size=self.window_size,
            min_word_frequency=1, epochs=epochs,
            learning_rate=self.learning_rate, negative=0, use_hs=True,
            seed=self.seed, use_engine=self.use_engine,
            engine_ep=self.engine_ep, engine_dp=self.engine_dp,
            device=self.device)
        self.vectors.fit(seqs)
        return self

    # ------------------------------------------------------------- queries
    def get_vertex_vector(self, idx: int) -> np.ndarray:
        vec = self.vectors.get_word_vector(str(idx))
        if vec is None:
            raise KeyError(f"vertex {idx} not in model")
        return vec

    def similarity(self, a: int, b: int) -> float:
        return self.vectors.similarity(str(a), str(b))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.vectors.words_nearest(str(idx), top_n)]


class GraphVectorSerializer:
    """Text format: one line per vertex `idx\tv0\tv1...`
    (models/deepwalk/GraphVectorSerializer.writeGraphVectors)."""

    @staticmethod
    def write_graph_vectors(model: DeepWalk, path: str) -> None:
        with open(path, "w") as f:
            for i in range(model.num_vertices):
                vec = model.vectors.get_word_vector(str(i))
                if vec is None:
                    continue
                f.write(str(i) + "\t" + "\t".join(f"{v:.8g}" for v in vec)
                        + "\n")

    @staticmethod
    def load_txt_vectors(path: str) -> dict:
        out = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                out[int(parts[0])] = np.array([float(v) for v in parts[1:]],
                                              dtype=np.float32)
        return out
