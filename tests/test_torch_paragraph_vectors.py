"""The port's ParagraphVectors (deeplearning4j_tpu_torch/nlp/
paragraph_vectors.py), its label-aware iterators (nlp/text.py) and the
inference steps (nlp/lookup.infer_sgns_step / infer_hs_step) against the
JAX package's on the CPU.

Both packages train ParagraphVectors through their host loops, which
draw windows and negatives from one seeded numpy Generator in the same
order, so from the same initial tables (the JAX table's draw, copied
into the port) they take the same steps. `infer_vector` starts from
`np.random.default_rng(seed)` in both. Tolerances: iterators, labels and
vocab exact; one inference step 1e-6 of the largest entry; a whole fit
(and the 20 steps of infer_vector after it) compounds f32 sum-order
differences: 1e-5 (losses relative, vectors absolute).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp.lookup import InMemoryLookupTable as JaxTable
from deeplearning4j_tpu.nlp.paragraph_vectors import (
    ParagraphVectors as JaxPV,
)
from deeplearning4j_tpu_torch.nlp import lookup as tlookup
from deeplearning4j_tpu_torch.nlp import text as ttext
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.weights_io import (
    TABLES,
    paragraph_vectors_from_jax,
    tables_from_jax,
)

pytestmark = pytest.mark.port


def _corpus(rng, n=120):
    animals = ["cat", "dog", "mouse", "horse", "cow", "sheep"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    sents, labels = [], []
    for _ in range(n):
        is_animal = rng.random() < 0.5
        sents.append(" ".join(rng.choice(animals if is_animal else tech,
                                         size=8)))
        labels.append("animal" if is_animal else "tech")
    return sents, labels


def _close(a, ref, tol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------ iterators

def test_label_aware_iterators_equal_jax(tmp_path):
    for label, docs in (("pos", ["good film", "great cast"]),
                        ("neg", ["bad plot"])):
        (tmp_path / label).mkdir()
        for i, d in enumerate(docs):
            (tmp_path / label / f"{i}.txt").write_text(d)
    (tmp_path / "stray.txt").write_text("not a label dir")
    pairs = ((jtext.FileLabelAwareIterator(str(tmp_path)),
              ttext.FileLabelAwareIterator(str(tmp_path))),
             (jtext.LabelAwareListSentenceIterator(["a b", "c"], ["x", "y"]),
              ttext.LabelAwareListSentenceIterator(["a b", "c"], ["x", "y"])),
             (jtext.LabelAwareListSentenceIterator(["a", "b", "c"]),
              ttext.LabelAwareListSentenceIterator(["a", "b", "c"])))
    for jit, tit in pairs:
        for _ in range(2):  # __iter__ resets
            assert [(d.content, d.labels) for d in tit] == [
                (d.content, d.labels) for d in jit]
        assert tit.get_labels_source().get_labels() == \
            jit.get_labels_source().get_labels()
    src = ttext.LabelsSource("D%d")
    assert [src.next_label(), src.next_label()] == ["D0", "D1"]
    src.store_label("D0")
    assert src.get_labels() == ["D0", "D1"]


# ------------------------------------------------------ inference steps

def test_infer_steps_match_jax():
    rng = np.random.default_rng(1)
    V, D, B, K, L = 30, 16, 12, 4, 5
    syn1 = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    vec = ((rng.random(D) - 0.5) / D).astype(np.float32)
    ctx = rng.integers(0, V, B)
    negs = rng.integers(0, V, (B, K))
    codes = rng.integers(0, 2, (B, L)).astype(np.int8)
    points = rng.integers(0, V, (B, L))
    mask = rng.random((B, L)) < 0.7
    jv, jl = jlookup.infer_sgns_step(vec, syn1, ctx, negs, 0.1)
    tv, tl = tlookup.infer_sgns_step(torch.from_numpy(vec),
                                     torch.from_numpy(syn1), ctx, negs, 0.1)
    _close(tv.numpy(), np.asarray(jv), 1e-6)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    jv, jl = jlookup.infer_hs_step(vec, syn1, codes, points, mask, 0.1)
    tv, tl = tlookup.infer_hs_step(torch.from_numpy(vec),
                                   torch.from_numpy(syn1), codes, points,
                                   mask, 0.1)
    _close(tv.numpy(), np.asarray(jv), 1e-6)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)


# -------------------------------------------------------- whole models

def _inject_jax_init(monkeypatch, seed):
    """The port's tables start from the JAX legacy table's draw."""
    real = SequenceVectors._init_from_vocab

    def init(self):
        real(self)
        t = self.lookup_table
        jt = JaxTable(t.vocab_size, self.layer_size, seed=seed,
                      use_hs=self.use_hs, negative=self.negative)
        arrays = {n: np.asarray(getattr(jt, n)) for n in TABLES}
        for name, tensor in tables_from_jax(arrays, "cpu").items():
            setattr(t, name, tensor)

    monkeypatch.setattr(SequenceVectors, "_init_from_vocab", init)


KW = dict(layer_size=16, window_size=3, epochs=2, seed=5, batch_size=128)


@pytest.mark.parametrize("algo,negative", [("dbow", 5), ("dm", 5),
                                           ("dbow", 0)],
                         ids=["dbow", "dm", "dbow_hs"])
def test_paragraph_vectors_match_jax(monkeypatch, algo, negative):
    """DBOW, DM and DBOW with hierarchical softmax from the same initial
    tables: loss histories, word and label rows, infer_vector,
    nearest_labels and similarity_to_label agree."""
    sents, labels = _corpus(np.random.default_rng(2))
    jm = JaxPV(sequence_learning_algorithm=algo, negative=negative, **KW)
    jm.fit(sents, labels)
    _inject_jax_init(monkeypatch, KW["seed"])
    tm = ParagraphVectors(sequence_learning_algorithm=algo,
                          negative=negative, device="cpu", **KW)
    tm.fit(sents, labels)
    assert tm.labels == jm.labels == ["animal", "tech"]
    assert tm.vocab.words() == jm.vocab.words()
    assert len(tm.loss_history) == len(jm.loss_history) > 4
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-5)
    _close(tm.lookup_table.vectors(), np.asarray(jm.lookup_table.syn0), 1e-5)
    for label in ("animal", "tech"):
        _close(tm.get_label_vector(label), jm.get_label_vector(label), 1e-5)
    text = "cat dog horse cow"
    _close(tm.infer_vector(text), jm.infer_vector(text), 1e-5)
    assert tm.nearest_labels(text, 2) == jm.nearest_labels(text, 2)
    assert tm.similarity_to_label(["cat", "dog"], "animal") == pytest.approx(
        jm.similarity_to_label(["cat", "dog"], "animal"), abs=1e-5)
    assert tm.words_nearest("cat", 3) == jm.words_nearest("cat", 3)


@pytest.mark.parametrize("negative", [5, 0], ids=["sgns", "hs"])
def test_infer_on_carried_tables_matches_jax(negative):
    """A trained JAX model's tables and labels carried into the port
    (`weights_io.paragraph_vectors_from_jax`): infer_vector and
    nearest_labels of unseen text agree."""
    sents, labels = _corpus(np.random.default_rng(3))
    jm = JaxPV(negative=negative, **KW)
    jm.fit(sents, labels)
    tm = ParagraphVectors(negative=negative, device="cpu", **KW)
    tm.build_vocab([s.split() for s in sents])
    paragraph_vectors_from_jax(jm, tm)
    for text in ("cat dog mouse", "gpu ram disk cache", "unknown words"):
        _close(tm.infer_vector(text), jm.infer_vector(text), 1e-5)
        assert tm.nearest_labels(text, 1) == jm.nearest_labels(text, 1)
    assert not tm.infer_vector("zzz").any()


def test_builder_and_refusals():
    sents, labels = _corpus(np.random.default_rng(4), 40)
    it = ttext.LabelAwareListSentenceIterator(sents, labels)
    pv = (ParagraphVectors.builder().layer_size(8).window_size(2)
          .epochs(1).seed(1).sequence_learning_algorithm("PV-DM")
          .label_aware_iterator(it).device("cpu").build())
    assert pv.sequence_algorithm == "dm" and pv.algorithm == "cbow"
    pv.fit()
    assert pv.labels == ["animal", "tech"]
    assert pv.get_label_vector("nope") is None
    assert ParagraphVectors(layer_size=8, train_words=False).train_words \
        is False
    with pytest.raises(ValueError, match="label"):
        ParagraphVectors(use_device_pipeline=True, device="cpu").fit(
            sents, labels)
