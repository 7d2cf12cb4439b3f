"""The port's NLP periphery (deeplearning4j_tpu_torch/nlp/{bagofwords,
invertedindex, movingwindow, sentiment, treeparser, annotation}.py, host
code kept as the port's own copies) against the JAX package's modules on
the inputs of the JAX package's own tests (tests/test_nlp.py,
tests/test_nlp_periphery.py, tests/test_annotation.py,
tests/test_small_utils.py, tests/test_util_extras.py). Host code with
the same inputs: every output is compared exactly.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import annotation as jann
from deeplearning4j_tpu.nlp import bagofwords as jbow
from deeplearning4j_tpu.nlp import invertedindex as jinv
from deeplearning4j_tpu.nlp import movingwindow as jmw
from deeplearning4j_tpu.nlp import sentiment as jsent
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp import treeparser as jtree
from deeplearning4j_tpu_torch.nlp import annotation as tann
from deeplearning4j_tpu_torch.nlp import bagofwords as tbow
from deeplearning4j_tpu_torch.nlp import invertedindex as tinv
from deeplearning4j_tpu_torch.nlp import movingwindow as tmw
from deeplearning4j_tpu_torch.nlp import sentiment as tsent
from deeplearning4j_tpu_torch.nlp import text as ttext
from deeplearning4j_tpu_torch.nlp import treeparser as ttree

pytestmark = pytest.mark.port

DOCS = ["the cat sat", "the dog ran", "the cat ran home"]


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_equal_jax(cls):
    jv, tv = (getattr(m, cls)().fit(DOCS) for m in (jbow, tbow))
    assert tv.vocab.words() == jv.vocab.words()
    for text in ("cat cat dog", "the cat", "unseen words"):
        np.testing.assert_array_equal(tv.transform(text), jv.transform(text))
    jd, td = jv.vectorize(DOCS, ["a", "b", "a"]), tv.vectorize(
        DOCS, ["a", "b", "a"])
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels, jd.labels)
    if cls == "TfidfVectorizer":
        assert tv.tfidf_word("cat", "the cat") == jv.tfidf_word(
            "cat", "the cat")


def _index(mod):
    ix = mod.InvertedIndex(seed=1)
    ix.add_doc("the cat sat on the mat".split(), labels=["animals"])
    ix.add_doc("the dog sat".split(), labels=["animals"])
    ix.add_doc("stocks fell sharply".split(), labels=["finance"])
    ix.add_words_to_doc(1, ["dog", "barked"])
    return ix


def test_inverted_index_equals_jax():
    j, t = _index(jinv), _index(tinv)
    assert t.num_documents() == j.num_documents()
    assert t.all_docs() == j.all_docs() and list(t.docs()) == list(j.docs())
    for w in ("sat", "the", "dog", "nope"):
        assert t.documents(w) == j.documents(w)
    assert t.search("the", "sat") == j.search("the", "sat")
    assert t.tfidf_search("cat", "sat") == j.tfidf_search("cat", "sat")
    assert list(t.mini_batches(2)) == list(j.mini_batches(2))
    assert [t.sample() for _ in range(5)] == [j.sample() for _ in range(5)]
    assert t.document_with_labels(2) == j.document_with_labels(2)


def test_moving_window_equals_jax():
    text = "the <LOC> new york </LOC> subway is <ADJ> loud </ADJ> today"
    assert tmw.string_with_labels(text) == jmw.string_with_labels(text)
    for bad in ("<A> oops </B>", "stray </A> end", "<A> unclosed"):
        with pytest.raises(ValueError):
            tmw.string_with_labels(bad)

    class FakeVec:
        layer_size = 4

        def word_vector(self, w):
            if w == "<none>":
                return None
            return np.full((4,), float(len(w)), np.float32)

    toks = ["a", "bb", "ccc", "dddd"]
    jw, tw = jtext.windows(toks, window_size=3), ttext.windows(toks, 3)
    for normalize in (False, True):
        np.testing.assert_array_equal(
            tmw.WindowConverter.as_example_matrix(tw, FakeVec(), normalize),
            jmw.WindowConverter.as_example_matrix(jw, FakeVec(), normalize))


def test_sentiment_equals_jax(tmp_path):
    p = tmp_path / "swn.txt"
    p.write_text("# SentiWordNet\na\t1\t0.75\t0.0\tcool#1\n"
                 "a\t2\t0.0\t0.0\tcool#2\nv\t3\t0.0\t0.5\tstink#1\n")
    words = ["the", "dog", "ran", "quickly", "is", "happiness", "excellent",
             "terrible", "unknownword", "good", "bad"]
    assert tsent.pos_tag(words) == jsent.pos_tag(words)
    for path in (None, str(p)):
        js, ts = jsent.SentiWordNet(path), tsent.SentiWordNet(path)
        for w in words + ["cool", "stink"]:
            assert ts.classify(w) == js.classify(w)
        for text in ("a wonderful great movie", "a terrible awful movie",
                     "a good movie", "a bad movie"):
            tags = jsent.pos_tag(text.split())
            assert ts.score_tokens(tags) == js.score_tokens(tags)
        for x in (0.3, -0.3, 0.1, 0.0, 0.9):
            assert ts.classify_score(x) == js.classify_score(x)
    text = "The dog runs happily"
    assert tsent.PosAwareTokenizerFactory().create(text).get_tokens() == \
        jsent.PosAwareTokenizerFactory().create(text).get_tokens()


SENT = ("(S (NP (DT the) (NN cat)) (VP (VBD sat) (PP (IN on) (NP (DT the) "
        "(NN mat)))))")


@pytest.mark.parametrize("text", [SENT, "(X (A a) (B b) (C c) (D d))",
                                  "(S (VP (NP (NN dog))))"])
def test_treeparser_equals_jax(text):
    jt, tt = jtree.TreeParser.parse(text), ttree.TreeParser.parse(text)
    assert tt.to_string() == jt.to_string()
    assert tt.yield_words() == jt.yield_words() and tt.depth() == jt.depth()
    assert ttree.binarize(tt).to_string() == jtree.binarize(jt).to_string()
    assert ttree.collapse_unaries(tt).to_string() == \
        jtree.collapse_unaries(jt).to_string()
    assert ttree.HeadWordFinder.find_head(tt) == \
        jtree.HeadWordFinder.find_head(jt)
    table = {w: np.full(4, float(len(w)), np.float32)
             for w in tt.yield_words()}
    got = ttree.TreeVectorizer(table.get, dim=4).vectorize_all(tt)
    want = jtree.TreeVectorizer(table.get, dim=4).vectorize_all(jt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[1] if isinstance(
            g, tuple) else g), np.asarray(w[1] if isinstance(w, tuple)
                                          else w))


def test_annotation_equals_jax():
    text = ("Deep learning works. Does it scale? It does! "
            "Dr. No was here. The quick dog runs quickly.")
    je, te = jann.LexiconAnnotationEngine(), tann.LexiconAnnotationEngine()
    assert te.sentences(text) == je.sentences(text)
    assert te.tokenize(text) == je.tokenize(text)
    toks = ["the", "quickly", "running", "goodness", "dog"]
    assert te.pos_tags(toks) == je.pos_tags(toks)
    assert te.annotate("Cats sleep. Dogs bark.") == je.annotate(
        "Cats sleep. Dogs bark.")
    assert isinstance(tann.get_annotation_engine(),
                      tann.LexiconAnnotationEngine)
    assert tann.SentenceDetector().detect("A b. C d.") == \
        jann.SentenceDetector().detect("A b. C d.")
    assert tann.AnnotationTokenizerFactory().create(
        "good dog").get_tokens() == jann.AnnotationTokenizerFactory().create(
        "good dog").get_tokens()


def test_annotation_engine_seam_and_spacy_gate():
    class XEngine(tann.LexiconAnnotationEngine):
        def pos_tags(self, tokens):
            return [(t, "x") for t in tokens]

    tann.set_annotation_engine(XEngine())
    try:
        assert tsent.PosAwareTokenizerFactory().create(
            "good dog").get_tokens() == ["good#x", "dog#x"]
    finally:
        tann.set_annotation_engine(None)
    assert tsent.PosAwareTokenizerFactory().create(
        "good dog").get_tokens() == ["good#a", "dog#n"]
    # spaCy is optional and gated: construction raises ImportError when
    # it is missing, in both packages
    assert tann.SpacyAnnotationEngine.available() == \
        jann.SpacyAnnotationEngine.available()
    if not tann.SpacyAnnotationEngine.available():
        with pytest.raises(ImportError):
            tann.SpacyAnnotationEngine()
    base = tann.AnnotationEngine()
    for call in (lambda: base.sentences("x"), lambda: base.tokenize("x"),
                 lambda: base.pos_tags(["x"])):
        with pytest.raises(NotImplementedError):
            call()
