"""Random-walk generation (reference: deeplearning4j-graph
iterator/{RandomWalkIterator, WeightedRandomWalkIterator}.java and
nlp models/sequencevectors/graph/walkers/{RandomWalker, WeightedWalker,
PopularityWalker}; JAX counterpart deeplearning4j_tpu/graph/walkers.py, host
code kept as the port's own copy: the walks draw from numpy Generators,
so they equal the JAX package's walks exactly).

Walks are produced as int arrays; `walks()` yields them and
`walk_sequences()` yields vertex-id *strings* ready for the
SequenceVectors engine.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .graph import Graph


class NoEdgeHandling:
    """What to do at a dead-end vertex (reference NoEdgeHandling enum)."""

    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"
    CUTOFF_ON_DISCONNECTED = "cutoff"
    RESTART_ON_DISCONNECTED = "restart"


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (iterator/RandomWalkIterator.java)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: str = NoEdgeHandling.EXCEPTION_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.no_edge_handling = no_edge_handling
        self._rng = np.random.default_rng(seed)
        self._position = 0

    def reset(self) -> None:
        self._position = 0

    def has_next(self) -> bool:
        return self._position < self.graph.num_vertices()

    def next(self) -> np.ndarray:
        if not self.has_next():
            raise StopIteration
        start = self._position
        self._position += 1
        return self._walk_from(start)

    def __iter__(self) -> Iterator[np.ndarray]:
        self.reset()
        while self.has_next():
            yield self.next()

    def _choose(self, nbrs: np.ndarray, weights: Optional[np.ndarray]) -> int:
        return int(nbrs[self._rng.integers(len(nbrs))])

    def _walk_from(self, start: int) -> np.ndarray:
        walk = np.empty(self.walk_length + 1, dtype=np.int64)
        walk[0] = start
        cur = start
        for i in range(1, self.walk_length + 1):
            nbrs = self.graph.get_connected_vertex_indices(cur)
            if len(nbrs) == 0:
                mode = self.no_edge_handling
                if mode == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                    raise RuntimeError(
                        f"vertex {cur} has no edges "
                        "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)")
                if mode == NoEdgeHandling.CUTOFF_ON_DISCONNECTED:
                    return walk[:i].copy()
                if mode == NoEdgeHandling.RESTART_ON_DISCONNECTED:
                    cur = start
                # SELF_LOOP: stay put
                walk[i] = cur
                continue
            cur = self._choose(nbrs, self.graph.get_edge_weights(cur))
            walk[i] = cur
        return walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (iterator/WeightedRandomWalkIterator.java)."""

    def _choose(self, nbrs: np.ndarray, weights: Optional[np.ndarray]) -> int:
        total = weights.sum()
        if total <= 0:
            return int(nbrs[self._rng.integers(len(nbrs))])
        return int(nbrs[self._rng.choice(len(nbrs), p=weights / total)])


class PopularityWalker(RandomWalkIterator):
    """Degree-biased walks: next hop proportional to neighbour degree
    (nlp sequencevectors/graph/walkers/PopularityWalker.java)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 spread: int = 10, **kw):
        super().__init__(graph, walk_length, seed, **kw)
        self.spread = spread
        self._degrees = graph.degrees().astype(np.float64)

    def _choose(self, nbrs: np.ndarray, weights: Optional[np.ndarray]) -> int:
        cand = nbrs
        if len(cand) > self.spread:
            cand = cand[self._rng.choice(len(cand), self.spread, replace=False)]
        pop = self._degrees[cand]
        total = pop.sum()
        if total <= 0:
            return int(cand[self._rng.integers(len(cand))])
        return int(cand[self._rng.choice(len(cand), p=pop / total)])


def walk_sequences(walker: RandomWalkIterator, walks_per_vertex: int = 1):
    """All walks as vertex-id string sequences for SequenceVectors."""
    out = []
    for _ in range(walks_per_vertex):
        for walk in walker:
            out.append([str(v) for v in walk])
    return out
