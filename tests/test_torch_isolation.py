"""The port stands alone: no file of deeplearning4j_tpu_torch/, nor
chip_smoke.py, nor any file under port_tools/ (the sweep, the trace,
traffic and benchdiff tools among them) or examples/torch/ imports jax
or the JAX package, the whole
package imports with jax made unimportable, and an entry point called
without a device asks for CUDA (no silent CPU fallback)."""

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
    ROOT / "chip_smoke.py"] + sorted((ROOT / "port_tools").rglob("*.py")) \
    + sorted((ROOT / "examples" / "torch").glob("*.py")) \
    + sorted(p for p in (ROOT / "tests").glob("torch_*.py")
             if p.name != "torch_zip_fixture.py")
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
               for m in NN_SLICE + EMBEDDINGS_SLICE + PARALLEL_SLICE
               + PLACEMENT_SLICE + PIPELINE_SLICE + ELASTIC_SLICE
               + TELEMETRY_SLICE + TUNING_UI_SLICE + TRACING_SLICE
               + DATA_UTIL_SLICE + COMPOSE_SLICE + ANALYSIS_SLICE} - names
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


# data and sequence parallelism and the process layer (ROADMAP A7)
PARALLEL_SLICE = (
    "parallel", "parallel.mesh", "ops.shard_scope", "parallel.overlap",
    "parallel.placement", "parallel.data_parallel", "parallel.ring_attention",
    "parallel.sequence_parallel", "distributed.bootstrap",
    "distributed.launcher", "distributed.global_mesh", "data.sharding",
    "data.pipeline", "data.bench_worker")
# graph vertices, decode of both containers, tensor and expert
# parallelism, ZeRO-1 (ROADMAP A10, A7.1, A7.2)
PLACEMENT_SLICE = (
    "nn.conf.graph_conf", "nn.conf.preprocessors", "nn.decode",
    "ops.shard_comm", "parallel.tensor_parallel", "parallel.expert_parallel",
    "nn.training")
# pipeline parallelism and the resharding engine with placement search
# (ROADMAP A7.3, A7.4)
PIPELINE_SLICE = (
    "parallel.pipeline", "reshard", "reshard.planner", "reshard.search",
    "reshard.executor", "reshard.bench_arm")
# the elastic fleet and its control plane, the sharded embedding engine
# and the data meshes of NLP (ROADMAP A7.5, A7.6)
ELASTIC_SLICE = (
    "distributed.faults", "distributed.elastic", "parallel.cluster",
    "telemetry.trace", "telemetry.recorder", "util.checkpoint",
    "nlp.distributed_vocab", "embedding.engine", "nlp.sequencevectors",
    "nlp.word2vec")


# the cost and memory telemetry, ModelSerializer zips, the records and
# the CLI (ROADMAP A9, first part)
TELEMETRY_SLICE = (
    "telemetry.memstat", "telemetry.costbook", "telemetry.listener",
    "ops.opcount", "util.model_serializer", "datasets.records",
    "datasets.cloud", "cli", "cli.driver", "cli.__main__")


# kernel autotuning, clustering with t-SNE and the training UI (ROADMAP
# A9, second part)
TUNING_UI_SLICE = (
    "ops.autotune", "clustering", "clustering.cluster", "clustering.kdtree",
    "clustering.vptree", "clustering.quadtree", "clustering.sptree",
    "clustering.kmeans", "plot", "plot.tsne", "plot.barnes_hut_tsne",
    "plot.filters", "ui", "ui.storage", "ui.components", "ui.standalone",
    "ui.views", "ui.listeners", "ui.server")


# the profiler, the registered event schema and the native IO core
# (ROADMAP A9.10, A9.6)
TRACING_SLICE = ("util.profiler", "telemetry.recorder", "native",
                 "datasets.records")


# the rest of datasets/ and util/ (ROADMAP A9.4, A9.5)
DATA_UTIL_SLICE = (
    "datasets", "datasets.iterators", "datasets.async_iterator",
    "datasets.iris", "datasets.curves", "datasets.image_records",
    "datasets.lfw", "datasets.vectorizer", "datasets.rearrange",
    "util.image_loader", "util.disk_queue", "util.moving_window",
    "util.sloppy_math", "util.string_grid", "util.time_series",
    "util.viterbi")


# the rest of A7: "seq" with "model" and "pipe", the split net's decode,
# the Solver under a mesh, resume_from into a placement (ROADMAP A7)
COMPOSE_SLICE = (
    "nn.layers.attention", "nn.layers.feedforward", "nn.layers.moe",
    "nn.decode", "nn.graph", "nn.multilayer", "ops.shard_comm",
    "ops.shard_scope", "optimize.solvers", "parallel.pipeline",
    "parallel.placement", "parallel.sequence_parallel",
    "parallel.tensor_parallel", "util.checkpoint", "distributed.elastic")


def test_compose_slice_files_are_covered():
    """Every module the slice touched, chip_smoke.py and the rank
    programs the slice's fleets run are among the files held to no JAX
    import above, and each imports none."""
    paths = [ROOT / "deeplearning4j_tpu_torch" / (m.replace(".", "/")
                                                  + ".py")
             for m in COMPOSE_SLICE] + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_worker.py",
        ROOT / "tests" / "torch_fleet_worker.py"]
    for path in paths:
        assert path in PORT_FILES, path
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)


def test_data_util_slice_leaves_no_sklearn_or_jax():
    """Importing the datasets package and every new util module leaves
    neither scikit-learn nor jax (nor the JAX package) in sys.modules:
    Iris reads the port's own CSV, and Pillow is the image loader's only
    optional import."""
    mods = " ".join(f"deeplearning4j_tpu_torch.{m}" for m in DATA_UTIL_SLICE)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}.split():\n"
            "    importlib.import_module(m)\n"
            "from deeplearning4j_tpu_torch.datasets import "
            "IrisDataSetIterator\n"
            "assert IrisDataSetIterator().next().features.shape == (150, 4)\n"
            "print(sorted(m for m in ('sklearn', 'jax', 'deeplearning4j_tpu')"
            " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[]", out.stdout
    for mod in DATA_UTIL_SLICE:
        path = ROOT / "deeplearning4j_tpu_torch" / (
            mod.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        assert path in PORT_FILES, mod
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in FORBIDDEN + ("sklearn",)]
        assert not bad, (mod, bad)
    assert (ROOT / "deeplearning4j_tpu_torch/datasets/iris.csv").exists()


def test_tracing_slice_files_are_covered():
    """The slice's files, the two tools under port_tools/ included, are
    among the files held to no JAX import above, and the native core's
    C++ source is the port's own copy."""
    for rel in ("deeplearning4j_tpu_torch/util/profiler.py",
                "deeplearning4j_tpu_torch/native/__init__.py",
                "port_tools/tracetool.py", "port_tools/trafficreplay.py"):
        assert ROOT / rel in PORT_FILES, rel
    assert (ROOT / "deeplearning4j_tpu_torch/native/io_core.cpp").exists()


def test_benchdiff_and_example_twins_are_covered():
    """The port's benchdiff and every example twin are among the files
    held to no JAX import above."""
    twins = [f"examples/torch/{p.name}"
             for p in sorted((ROOT / "examples").glob("*.py"))]
    assert len(twins) == 8
    for rel in ["port_tools/benchdiff.py"] + twins:
        assert ROOT / rel in PORT_FILES, rel


def test_elastic_slice_imports_nothing_of_jax():
    """The stdlib-only modules the slice copies from the JAX package
    (its cluster protocol, fault grammar and trace tools) are the
    port's own copies: each names its JAX counterpart and imports none
    of it."""
    for mod in (ELASTIC_SLICE + TELEMETRY_SLICE + TUNING_UI_SLICE
                + TRACING_SLICE):
        path = ROOT / "deeplearning4j_tpu_torch" / (
            mod.replace(".", "/") + ".py")
        if not path.exists():  # a package: its __init__.py
            path = path.with_suffix("") / "__init__.py"
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in FORBIDDEN]
        assert not bad, (mod, bad)


def test_rank_programs_import_without_jax():
    """The multi-rank tests' rank programs (tests/torch_*.py, the fleets'
    tests/torch_fleet_worker.py among them) import with jax and the JAX
    package made unimportable, as the ranks run them."""
    workers = sorted((ROOT / "tests").glob("torch_*.py"))
    assert ROOT / "tests" / "torch_fleet_worker.py" in workers
    # the fixture maker imports the JAX package only inside make()
    for path in workers:
        code = ("import sys, runpy\n"
                "sys.modules['jax'] = None\n"
                "sys.modules['deeplearning4j_tpu'] = None\n"
                f"runpy.run_path({str(path)!r}, run_name='imported')\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             env={"PYTHONPATH": str(ROOT), "PATH": ""})
        assert out.returncode == 0, out.stderr


def test_parallel_slice_defaults_to_cuda():
    """With no device named, a process of the fleet binds a CUDA device
    (NCCL), the launcher hands process i `cuda:i`, and a mesh built
    without a process group brings one up on CUDA: on a machine without
    a card that fails rather than carrying on over gloo on the CPU."""
    from deeplearning4j_tpu_torch.distributed import bootstrap, launcher
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    assert bootstrap._resolve_process_device(None, 0).type == "cuda"
    lines = launcher.launch_plan(["x"], 2, coordinator="127.0.0.1:1")
    assert f"{bootstrap.ENV_DEVICE}=cuda:1" in lines[1]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            make_mesh({"data": 1})
        assert not bootstrap.is_initialized()


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


def _kmeans():
    from deeplearning4j_tpu_torch.clustering import KMeansClustering

    km = KMeansClustering(2, max_iterations=2)
    assert km.device == torch.device("cuda")
    km.apply_to(np.random.default_rng(0).normal(size=(8, 3)))
    return [km.centers, km.assignments]


def _tsne():
    from deeplearning4j_tpu_torch.plot import Tsne

    ts = Tsne(max_iter=2, perplexity=2.0)
    assert ts.device == torch.device("cuda")
    ts.calculate(np.random.default_rng(0).normal(size=(8, 3)))
    return [torch.zeros(1, device="cuda")]


@pytest.mark.parametrize("make", [_kmeans, _tsne],
                         ids=["KMeansClustering", "Tsne"])
def test_clustering_entry_points_default_to_cuda(make):
    """The same rule for KMeans and exact t-SNE: with no device named
    they run on CUDA, and without a card they fail rather than carrying
    on on the CPU."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in make())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


# graftlint for the port (ROADMAP A9.11): the analysis stages, the op
# audit and the trace halves of stages 3 and 5
ANALYSIS_SLICE = (
    "analysis", "analysis.core", "analysis.ast_pass", "analysis.ast_rules",
    "analysis.spmd_rules", "analysis.concurrency_rules",
    "analysis.precision_rules", "analysis.lock_audit", "analysis.op_audit",
    "analysis.collective_audit", "analysis.precision_audit")
