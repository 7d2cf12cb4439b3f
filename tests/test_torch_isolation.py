"""The port stands alone: no file of deeplearning4j_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, the whole package imports
with jax made unimportable, and an entry point called without a device
asks for CUDA (no silent CPU fallback)."""

import ast
import subprocess
import sys
from pathlib import Path

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
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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


@pytest.mark.parametrize("make", [_generation_engine, _gumbel_noise],
                         ids=["GenerationEngine", "gumbel_noise"])
def test_serving_entry_points_default_to_cuda(make):
    """The same rule for the speculative and int8 serving slice: with no
    device named, the engine's cache and the sampling noise go to CUDA."""
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
