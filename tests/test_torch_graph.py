"""The port's graph package (deeplearning4j_tpu_torch/graph) against the
JAX package's on the CPU.

Graph storage, the loaders and the walkers are host code drawing from
numpy Generators: the port's walks equal the JAX package's walks exactly,
for every walker and every NoEdgeHandling mode. DeepWalk trains through
the port's SequenceVectors and embedding engine (HS at ep = 1); the JAX
package's engine needs its `shard_map` shim, which fails under some jax
versions (its own TestDeepWalk fails there), so the JAX DeepWalk anchors
these tests on its legacy dense path (`use_engine=False`), which its
engine claims to equal at ep = 1. The two packages draw their initial
tables from different generators, so the JAX initial tables are copied
into the port first. Tolerances: walks, vocab and files exact; a whole
DeepWalk fit compounds f32 sum-order differences: 1e-5 (losses
relative, vectors absolute).
"""

import numpy as np
import pytest

from deeplearning4j_tpu import graph as jg
from deeplearning4j_tpu.nlp.lookup import InMemoryLookupTable as JaxTable
from deeplearning4j_tpu_torch import graph as tg
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.weights_io import TABLES, tables_from_jax

pytestmark = pytest.mark.port


def _two_cliques(mod, n=6):
    g = mod.Graph(2 * n)
    for base in (0, n):
        for i in range(n):
            for j in range(i + 1, n):
                g.add_edge(base + i, base + j)
    g.add_edge(0, n)
    return g


def _sparse(mod, weighted=False):
    """A graph with a sink (vertex 7 has no out-edges) and weights."""
    g = mod.Graph(8)
    rng = np.random.default_rng(0)
    for a, b in ((0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (4, 5), (5, 6)):
        g.add_edge(a, b, weight=float(rng.random() + 0.1))
    g.add_edge(6, 7, directed=True)
    return g


# ------------------------------------------------------------ host code

def test_graph_structure_and_loaders_equal_jax(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1\n1 2\n2 0\n3 1\n")
    pw = tmp_path / "weighted.txt"
    pw.write_text("0,1,0.5\n1,2,2.5\n2,3,1.0\n")
    pa = tmp_path / "adj.txt"
    pa.write_text("0 1 2\n2 3\n")
    for load, args in (
            ("load_undirected_graph_edge_list_file", (str(p), 4)),
            ("load_weighted_edge_list_file", (str(pw), 4, ",")),
            ("load_adjacency_list_file", (str(pa), 4))):
        jgr = getattr(jg.GraphLoader, load)(*args)
        tgr = getattr(tg.GraphLoader, load)(*args)
        assert tgr.num_edges() == jgr.num_edges()
        np.testing.assert_array_equal(tgr.degrees(), jgr.degrees())
        for v in range(4):
            np.testing.assert_array_equal(
                tgr.get_connected_vertex_indices(v),
                jgr.get_connected_vertex_indices(v))
            np.testing.assert_array_equal(tgr.get_edge_weights(v),
                                          jgr.get_edge_weights(v))
            assert [(e.src, e.dst, e.weight) for e in tgr.get_edges_out(v)] \
                == [(e.src, e.dst, e.weight) for e in jgr.get_edges_out(v)]
    with pytest.raises(ValueError):
        tg.Graph(2).add_edge(0, 5)


@pytest.mark.parametrize("walker", ["RandomWalkIterator",
                                    "WeightedRandomWalkIterator",
                                    "PopularityWalker"])
@pytest.mark.parametrize("mode", ["SELF_LOOP_ON_DISCONNECTED",
                                  "CUTOFF_ON_DISCONNECTED",
                                  "RESTART_ON_DISCONNECTED"])
def test_walks_equal_jax(walker, mode):
    """Two passes of every walker over a graph with a sink, in every
    dead-end mode that walks on: the same walks, element for element."""
    walks = []
    for mod in (jg, tg):
        kw = {"spread": 2} if walker == "PopularityWalker" else {}
        it = getattr(mod, walker)(
            _sparse(mod), 12, seed=3,
            no_edge_handling=getattr(mod.NoEdgeHandling, mode), **kw)
        walks.append(mod.walkers.walk_sequences(it, 2))
    assert walks[1] == walks[0]
    assert len(walks[1]) == 16


def test_dead_end_raises_by_default():
    g = _sparse(tg)
    with pytest.raises(RuntimeError, match="no edges"):
        list(tg.RandomWalkIterator(g, 12, seed=0))


# ----------------------------------------------------------- DeepWalk

def _inject_jax_init(monkeypatch, seed):
    """Give the port's SequenceVectors the initial tables the JAX legacy
    path draws for the same vocab size and seed."""
    real = SequenceVectors._init_from_vocab

    def init(self):
        real(self)
        jt = JaxTable(self.vocab.num_words(), self.layer_size, seed=seed,
                      use_hs=True, negative=0)
        arrays = {n: np.asarray(getattr(jt, n)) for n in TABLES}
        for name, t in tables_from_jax(arrays, "cpu").items():
            setattr(self.lookup_table, name, t)

    monkeypatch.setattr(SequenceVectors, "_init_from_vocab", init)


def _pair(monkeypatch, n=5, **fit):
    jdw = (jg.DeepWalk.builder().vector_size(16).window_size(3)
           .learning_rate(0.05).seed(7).use_engine(False).build())
    tdw = (tg.DeepWalk.builder().vector_size(16).window_size(3)
           .learning_rate(0.05).seed(7).device("cpu").build())
    jdw.fit(_two_cliques(jg, n), **fit)
    _inject_jax_init(monkeypatch, 7)
    tdw.fit(_two_cliques(tg, n), **fit)
    return jdw, tdw


def test_deepwalk_matches_jax_legacy_path(monkeypatch):
    """The port's DeepWalk (engine on, HS) against the JAX DeepWalk on
    its legacy dense path from the same initial tables: the same
    vocab, losses within 1e-5 relative, vectors within 1e-5, the same
    neighbours."""
    jdw, tdw = _pair(monkeypatch, walk_length=20, walks_per_vertex=8,
                     epochs=3)
    assert tdw.vectors._engine is not None and tdw.vectors.use_hs
    assert tdw.vectors.vocab.words() == jdw.vectors.vocab.words()
    jl, tl = jdw.vectors.loss_history, tdw.vectors.loss_history
    assert len(tl) == len(jl) >= 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for v in range(10):
        np.testing.assert_allclose(tdw.get_vertex_vector(v),
                                   jdw.get_vertex_vector(v), rtol=0,
                                   atol=1e-5)
    assert tdw.vertices_nearest(0, 4) == jdw.vertices_nearest(0, 4)
    assert tdw.similarity(1, 2) == pytest.approx(jdw.similarity(1, 2),
                                                 abs=1e-5)


def test_deepwalk_embeddings_cluster_by_clique():
    """The JAX TestDeepWalk check on the port's own draws."""
    dw = (tg.DeepWalk.builder().vector_size(16).window_size(3)
          .learning_rate(0.05).seed(7).device("cpu").build())
    dw.fit(_two_cliques(tg, 5), walk_length=20, walks_per_vertex=8, epochs=3)
    same = np.mean([dw.similarity(i, j)
                    for i in range(5) for j in range(i + 1, 5)])
    cross = np.mean([dw.similarity(i, 5 + j)
                     for i in range(1, 5) for j in range(1, 5)])
    assert same > cross
    assert dw.get_vertex_vector(0).shape == (16,)
    assert len(dw.vertices_nearest(0, 3)) == 3
    with pytest.raises(KeyError):
        dw.get_vertex_vector(99)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_graph_vector_serializer_cross_reads(monkeypatch, tmp_path,
                                             direction):
    jdw, tdw = _pair(monkeypatch, n=3, walk_length=8, walks_per_vertex=2)
    path = str(tmp_path / "gv.txt")
    if direction == "port_to_jax":
        tg.GraphVectorSerializer.write_graph_vectors(tdw, path)
        loaded, src = jg.GraphVectorSerializer.load_txt_vectors(path), tdw
    else:
        jg.GraphVectorSerializer.write_graph_vectors(jdw, path)
        loaded, src = tg.GraphVectorSerializer.load_txt_vectors(path), jdw
    assert set(loaded) == set(range(6))
    for v in range(6):
        np.testing.assert_allclose(loaded[v], src.get_vertex_vector(v),
                                   rtol=1e-6)
