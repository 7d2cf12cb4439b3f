"""The port's native IO core (deeplearning4j_tpu_torch/native) against the
JAX package's (deeplearning4j_tpu/native) on the CPU: the same arrays from
the same files and corpora, non-numeric cells, empty values, ragged
lines, blank lines and OOV words included; the record iterators' whole-
file path against their per-record path; a raw-string Word2Vec corpus
encoded as the pre-tokenized one; and a build failure that is not
silent. Both cores are built by g++ at first use (seconds)."""

import csv
import warnings

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.records import (
    CSVRecordReader,
    RecordReaderDataSetIterator,
    SVMLightRecordReader,
)

pytestmark = pytest.mark.port

CSV_CASES = {
    "numeric": "0.5,1.25,-3,2\n4,5.5,6,0\n7e-3,8,9,1\n",
    "header": "a,b,c\n1,2,3\n4,5,6\n",
    "non_numeric": "1.0,hello,3\n4,5,6\n",
    "empty_cell": "1,,3\n4,5,6\n",
    "ragged": "1,2,3\n9,9,9,9\n4,5,6\n",
    "blank_lines": "1,2,3\n\n4,5,6\n\n",
    "crlf": "1,2\r\n3,4\r\n",
    "semicolon": "1;2;3\n4;5;6\n",
}
SVM_CASES = {
    "plain": "1 1:0.5 3:2.0\n0 2:1.5\n",
    "comments_and_blanks": "1 1:0.5 3:2.0\n# comment\n\n0 2:1.5\n",
    "empty_value": "1 2: \n5 1:7\n",
    "out_of_range": "1 9:1.0\n0 1:2\n",
}


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_the_core_builds_into_the_package():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    lib = native.BUILD_DIR.glob("io_core-*.so")
    assert any(lib)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_load_csv_matches_the_jax_core(case, tmp_path):
    p = tmp_path / f"{case}.csv"
    p.write_bytes(CSV_CASES[case].encode())
    skip = 1 if case == "header" else 0
    delim = ";" if case == "semicolon" else ","
    _same(native.load_csv(str(p), skip, delim),
          jnative.load_csv(str(p), skip, delim))
    if case in ("non_numeric", "empty_cell"):
        assert native.load_csv(str(p), skip, delim) is None


@pytest.mark.parametrize("case", sorted(SVM_CASES))
def test_load_svmlight_matches_the_jax_core(case, tmp_path):
    p = tmp_path / f"{case}.txt"
    p.write_text(SVM_CASES[case])
    _same(native.load_svmlight(str(p), 4), jnative.load_svmlight(str(p), 4))


CORPORA = {
    "oov": (["alpha beta gamma", "beta nope alpha", "zeta"],
            ["alpha", "beta", "gamma"]),
    "blank_lines": (["a b", "", "   ", "b a a"], ["a", "b"]),
    "embedded_newline": (["a b\nc", "c\tb  a "], ["a", "b", "c"]),
    "big_vocab": ([" ".join(f"w{(i * 7 + j) % 6000}" for j in range(25))
                   for i in range(300)], [f"w{i}" for i in range(5000)]),
}


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_encoders_match_the_jax_core(case):
    lines, vocab = CORPORA[case]
    _same(native.encode_corpus(lines, vocab),
          jnative.encode_corpus(lines, vocab))
    text = "\n".join(lines)
    _same(native.encode_tokens(text, vocab),
          jnative.encode_tokens(text, vocab))
    # and the Python split gives the same ids
    index = {w: i for i, w in enumerate(vocab)}
    ids, sent = native.encode_corpus(lines, vocab)
    want = [(index.get(w, -1), si) for si, line in enumerate(lines)
            for w in line.split()]
    assert list(zip(ids.tolist(), sent.tolist())) == want


def _batches(it):
    out = []
    it.reset()
    while it.has_next():
        out.append(it.next())
    return out


class _PerRecord:
    """A reader with the per-record path only (no `to_matrix`)."""

    def __init__(self, reader):
        self.reader = reader

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.reader)


@pytest.mark.parametrize("kind", ["csv", "svmlight"])
def test_record_iterators_whole_file_path_equals_per_record(kind, tmp_path):
    from deeplearning4j_tpu.datasets.records import (
        CSVRecordReader as JCSVReader,
    )
    from deeplearning4j_tpu.datasets.records import (
        RecordReaderDataSetIterator as JIterator,
    )
    from deeplearning4j_tpu.datasets.records import (
        SVMLightRecordReader as JSVMReader,
    )

    rng = np.random.default_rng(0)
    if kind == "csv":
        data = rng.random((50, 5)).astype(np.float32)
        data[:, -1] = rng.integers(0, 3, 50)
        p = tmp_path / "d.csv"
        with open(p, "w", newline="") as f:
            csv.writer(f).writerows([[f"{v:.6f}" for v in row]
                                     for row in data])
        reader, jreader = CSVRecordReader(str(p)), JCSVReader(str(p))
    else:
        p = tmp_path / "d.txt"
        p.write_text("".join(
            f"{i % 3} {1 + i % 4}:{i / 7:.4f} 5:{i % 5}\n" for i in range(50)))
        reader, jreader = (SVMLightRecordReader(str(p), 5),
                           JSVMReader(str(p), 5))
    fast = RecordReaderDataSetIterator(reader, 16, num_classes=3)
    assert fast._matrix is not None
    slow = RecordReaderDataSetIterator(_PerRecord(reader), 16,
                                       num_classes=3)
    assert slow._matrix is None
    jfast = JIterator(jreader, 16, num_classes=3)
    for a, b, c in zip(_batches(fast), _batches(slow), _batches(jfast)):
        for name in ("features", "labels"):
            x, y, z = (np.asarray(getattr(d, name)) for d in (a, b, c))
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_a_raw_string_corpus_encodes_as_the_tokenized_one():
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    rng = np.random.default_rng(3)
    words = [f"t{i}" for i in range(40)]
    toks = [[words[j] for j in rng.integers(0, 40, 12)] for _ in range(80)]
    toks[5] = ["unseen"] + toks[5]
    raw = [" ".join(t) for t in toks]
    fits = []
    for corpus in (raw, toks):
        w = (Word2Vec.builder().layer_size(16).window_size(2)
             .min_word_frequency(2).negative_sample(2).epochs(1).seed(1)
             .use_device_pipeline(True).device("cpu").build())
        w.pipeline_chunk = 64
        w.build_vocab(toks)
        fits.append(w)
    ids = [w._corpus_flat_indices(c) for w, c in zip(fits, (raw, toks))]
    for a, b in zip(*ids):
        np.testing.assert_array_equal(a, b)
    assert 5 in ids[0][1] and len(ids[0][0]) < sum(len(t) for t in toks)
    for w, c in zip(fits, (raw, toks)):
        w.fit(c)
    np.testing.assert_array_equal(fits[0].lookup_table.syn0.numpy(),
                                  fits[1].lookup_table.syn0.numpy())
    assert fits[0].loss_history == fits[1].loss_history


def test_a_failed_build_warns_and_reports(tmp_path, monkeypatch):
    bad = tmp_path / "io_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert native.load_csv(str(bad)) is None
    assert not native.available()
    assert "g++ exit" in native.build_error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once
        assert native.encode_tokens("a", ["a"]) is None
