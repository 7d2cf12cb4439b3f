"""The port stands alone: no file of deeplearning4j_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, the whole package imports
with jax made unimportable, and an entry point called without a device
asks for CUDA (no silent CPU fallback)."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.transformer import transformer_lm

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['deeplearning4j_tpu'] = None\n"
        "import deeplearning4j_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    missing = {f"deeplearning4j_tpu_torch.{m}"
               for m in NN_SLICE + EMBEDDINGS_SLICE} - names
    assert not missing, missing


# the rest of nn/ and what trains through it (ROADMAP A6)
NN_SLICE = ("nn.tree", "nn.layers.recurrent", "nn.layers.moe",
            "nn.layers.nested", "optimize.listeners", "optimize.solvers",
            "earlystopping.core", "gradientcheck.gradient_check_util")
# the rest of embeddings and NLP (ROADMAP A8)
EMBEDDINGS_SLICE = (
    "nlp.device_pipeline", "nlp.paragraph_vectors", "nlp.glove",
    "nlp.bagofwords", "nlp.invertedindex", "nlp.movingwindow",
    "nlp.sentiment", "nlp.treeparser", "nlp.annotation", "embedding.ann",
    "embedding.serving", "graph", "graph.api", "graph.graph", "graph.loader",
    "graph.walkers", "graph.deepwalk")


def test_entry_point_defaults_to_cuda():
    net = transformer_lm(vocab_size=32, d_model=64, n_heads=1, n_layers=1,
                         d_ff=64, max_length=64)
    assert net.device == torch.device("cuda")
    if torch.cuda.is_available():
        net.init(0)
        assert all(t.is_cuda for p in net.params.values()
                   for t in p.values())
    else:
        # no card: the first allocation fails instead of carrying on
        # on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            net.init(0)


def _word2vec():
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    model = Word2Vec.builder().layer_size(8).build()
    assert model.device == torch.device("cuda")
    model.build_vocab([["a", "b", "c"], ["b", "c", "d"]])
    return [model.lookup_table.syn0, model.lookup_table.syn1neg]


def _engine():
    from deeplearning4j_tpu_torch.embedding.engine import (
        ShardedEmbeddingEngine,
    )

    eng = ShardedEmbeddingEngine(16, 8)
    return [eng.syn0, eng.syn1, eng.syn1neg]


def _lookup_table():
    from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable

    t = InMemoryLookupTable(16, 8)
    return [t.syn0, t.syn1, t.syn1neg]


@pytest.mark.parametrize("make", [_word2vec, _engine, _lookup_table],
                         ids=["Word2Vec", "ShardedEmbeddingEngine",
                              "InMemoryLookupTable"])
def test_embedding_entry_points_default_to_cuda(make):
    """The same rule as test_entry_point_defaults_to_cuda for the
    Word2Vec slice: with no device named, the tables go to CUDA."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in make())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def _generation_engine():
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    net = transformer_lm(vocab_size=32, d_model=32, n_heads=2, n_layers=1,
                         d_ff=32, max_length=32)
    assert net.device == torch.device("cuda")
    eng = GenerationEngine(net, BucketLattice((1,), seq_lens=(8,)),
                           slots=1, max_new_tokens=4, page_size=4,
                           kv_dtype="int8")
    return [t for entry in eng._workers[0].cache.values()
            for t in entry.values()]


def _gumbel_noise():
    from deeplearning4j_tpu_torch.ops.fused_sampling import gumbel_noise

    gen = torch.Generator(device="cuda" if torch.cuda.is_available()
                          else "cpu")
    return [gumbel_noise(gen, 2, 8)]


def _inference_engine():
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  InferenceEngine)

    net = transformer_lm(vocab_size=32, d_model=32, n_heads=2, n_layers=1,
                         d_ff=32, max_length=32)
    assert net.device == torch.device("cuda")
    eng = InferenceEngine(net, BucketLattice((1,), seq_lens=(8,)),
                          sequence=True)
    return [t for p in eng.weights.current.params.values()
            for t in p.values()]


def _checkpoint_restore():
    import tempfile

    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    def lm(device=None):
        return transformer_lm(vocab_size=32, d_model=32, n_heads=2,
                              n_layers=1, d_ff=32, max_length=32,
                              device=device)

    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(lm("cpu").init(0), 1)
        net = lm()
        assert net.device == torch.device("cuda")
        assert net.resume_from(d) == 1
    return [t for p in net.params.values() for t in p.values()]


@pytest.mark.parametrize("make", [_generation_engine, _gumbel_noise,
                                  _inference_engine, _checkpoint_restore],
                         ids=["GenerationEngine", "gumbel_noise",
                              "InferenceEngine", "Checkpointer"])
def test_serving_entry_points_default_to_cuda(make):
    """The same rule for the serving slices: with no device named, the
    engines' cache and params, the sampling noise and a restored
    checkpoint go to CUDA."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in make())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


@pytest.mark.parametrize("name", ["lenet5", "vgg16", "resnet20"])
def test_image_model_entry_points_default_to_cuda(name):
    """The same rule for the image models: with no device named, the
    net is a CUDA net, and its params and batch-norm state go there."""
    from deeplearning4j_tpu_torch import models

    net = getattr(models, name)()
    assert net.device == torch.device("cuda")
    if torch.cuda.is_available():
        net.init()
        assert all(t.is_cuda for tree in (net.params, net.state)
                   for p in tree.values() for t in p.values())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            net.init()


def _clustered_rows(v=64, d=8):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, d))[rng.integers(0, 4, v)]
            + 0.1 * rng.normal(size=(v, d))).astype(np.float32)


def _pipeline_word2vec():
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    model = (Word2Vec.builder().layer_size(8).window_size(2)
             .use_device_pipeline(True).build())
    assert model.device == torch.device("cuda")
    model.fit([["a", "b", "c"], ["b", "c", "d"]] * 40)
    return [model.lookup_table.syn0, model.lookup_table.syn1neg]


def _ann_index():
    from deeplearning4j_tpu_torch.embedding.ann import DeviceANNIndex

    idx = DeviceANNIndex.build(_clustered_rows(), n_partitions=4)
    return [idx.centroids, idx.part_vecs, idx.part_ids]


def _embedding_serving():
    from deeplearning4j_tpu_torch.embedding.serving import (
        EmbeddingServingEngine,
    )

    eng = EmbeddingServingEngine(_clustered_rows(), n_partitions=4,
                                 nprobe=2)
    assert eng.device == torch.device("cuda")
    return [eng.index.part_vecs]


def _deepwalk():
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph

    g = Graph(4)
    for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
        g.add_edge(a, b)
    dw = DeepWalk(vector_size=8, window_size=2)
    dw.fit(g, walk_length=6)
    return [dw.vectors.lookup_table.syn0]


def _paragraph_vectors():
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )

    pv = ParagraphVectors(layer_size=8)
    assert pv.device == torch.device("cuda")
    pv.fit(["a b c", "b c d"], ["x", "y"])
    return [pv.lookup_table.syn0, pv.lookup_table.syn1neg]


def _glove():
    from deeplearning4j_tpu_torch.nlp.glove import Glove

    g = Glove(layer_size=8, epochs=1, batch_size=16)
    assert g.device == torch.device("cuda")
    g.fit([["a", "b", "c"], ["b", "c", "d"]])
    return list(g.state.values())


@pytest.mark.parametrize("make", [_pipeline_word2vec, _ann_index,
                                  _embedding_serving, _deepwalk,
                                  _paragraph_vectors, _glove],
                         ids=["Word2Vec-pipeline", "DeviceANNIndex",
                              "EmbeddingServingEngine", "DeepWalk",
                              "ParagraphVectors", "Glove"])
def test_embeddings_slice_entry_points_default_to_cuda(make):
    """The same rule for the rest of embeddings and NLP: with no device
    named, the pipeline's tables, the ANN index, the serving engine's
    index, DeepWalk's, ParagraphVectors' and GloVe's tables go to CUDA."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in make())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()
