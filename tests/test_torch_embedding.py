"""The port's Word2Vec slice (deeplearning4j_tpu_torch/nlp,
deeplearning4j_tpu_torch/embedding, ops/fused_neg_softmax.py — the K13
wrapper over csrc/neg_softmax.cu) against the JAX package on the CPU.

The JAX package's own engine cannot anchor these tests: under some jax
versions its `shard_map` shim rejects `check_rep`, so it fails in one
environment and passes in another. Its documented contract anchors them
instead: at ep=1 the engine equals the legacy dense path
(`nlp/lookup.sgns_step` / `sg_hs_step`), and `Word2Vec(...,
use_engine=False)` runs that path. The port's engine (on by default) is
held against it. The two packages draw their initial tables from
different generators, so each comparison copies the JAX tables into the
port (`weights_io.tables_from_jax`) before training.

Tolerances: host code (vocab, Huffman, negatives, pairs) is exact. One
f32 step sums in another order than XLA on the CPU: 1e-6 of the largest
entry. Ten steps, and a whole Word2Vec fit, compound those differences:
1e-5 (loss histories relative, tables absolute). bf16 scores: the same
bf16 inputs on both sides, rounded to bf16 once at the end, so one
bf16 ulp of a value below 1 (2^-8) -> 8e-3 (two ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp.serializer import (
    WordVectorSerializer as JaxSerializer,
)
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxWord2Vec
from deeplearning4j_tpu.ops.fused_neg_softmax import (
    _score_body as jax_score_body,
    neg_softmax_scores as jax_scores,
    supports as jax_supports,
)
from deeplearning4j_tpu_torch.embedding.corpus import (
    prefetched,
    sequence_pair_batches,
    walk_pair_batches,
    with_negatives,
)
from deeplearning4j_tpu_torch.embedding.engine import ShardedEmbeddingEngine
from deeplearning4j_tpu_torch.nlp import distributed_vocab as tdv
from deeplearning4j_tpu_torch.nlp import lookup as tlookup
from deeplearning4j_tpu_torch.nlp import text as ttext
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.ops import fused_neg_softmax as tns
from deeplearning4j_tpu_torch.weights_io import (
    TABLES,
    tables_from_jax,
    tables_to_numpy,
)

pytestmark = pytest.mark.port


def topic_corpus(rng, vocab, n_words, sent_len, n_topics=20):
    """bench.py `_topic_corpus`: zipf-frequency words with planted
    topics (word i belongs to topic i % n_topics)."""
    words = [f"w{i}" for i in range(vocab)]
    per = vocab // n_topics
    zipf = 1.0 / np.arange(1, per + 1)
    p = zipf / zipf.sum()
    n_sents = n_words // sent_len
    topics = rng.integers(0, n_topics, n_sents)
    ranks = rng.choice(per, size=(n_sents, sent_len), p=p)
    ids = ranks * n_topics + topics[:, None]
    return [[words[j] for j in row] for row in ids]


@pytest.fixture(scope="module")
def sents():
    return topic_corpus(np.random.default_rng(0), 400, 5000, 25)


def _close(a, ref, tol):
    """|a - ref| <= tol * max|ref|, elementwise."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------- (a) host code, exact

@pytest.mark.parametrize("limit", [None, 150])
def test_vocab_and_huffman_equal_jax(sents, limit):
    """Words, counts, indices and Huffman codes/points of the joint
    vocabulary, and its padded arrays, equal the JAX package's."""
    caches = []
    for mod in (jvocab, tvocab):
        ctor = mod.VocabConstructor(min_word_frequency=2, limit=limit)
        caches.append(ctor.add_source(sents).build_joint_vocabulary())
    jc, tc = caches
    assert tc.words() == jc.words()
    assert tc.total_word_occurrences == jc.total_word_occurrences
    for jw, tw in zip(jc.vocab_words(), tc.vocab_words()):
        assert (tw.word, tw.count, tw.index, tw.code, tw.points) == (
            jw.word, jw.count, jw.index, jw.code, jw.points)
    for ja, ta in zip(jvocab.Huffman(jc.vocab_words()).padded_arrays(),
                      tvocab.Huffman(tc.vocab_words()).padded_arrays()):
        np.testing.assert_array_equal(ta, ja)


def test_negatives_and_subsampling_equal_jax(sents):
    """unigram_table, sample_negatives, keep_probabilities and
    subsample_mask from the same numpy Generator state are identical."""
    jc = jvocab.VocabConstructor().add_source(sents).build_joint_vocabulary()
    tc = tvocab.VocabConstructor().add_source(sents).build_joint_vocabulary()
    jt, tt = jvocab.unigram_table(jc), tvocab.unigram_table(tc)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(
        tvocab.sample_negatives(tt, (64, 5), np.random.default_rng(3)),
        jvocab.sample_negatives(jt, (64, 5), np.random.default_rng(3)))
    jk, tk = (m.keep_probabilities(c, 1e-3)
              for m, c in ((jvocab, jc), (tvocab, tc)))
    np.testing.assert_array_equal(tk, jk)
    idx = np.arange(tc.num_words(), dtype=np.int32)
    np.testing.assert_array_equal(
        tvocab.subsample_mask(idx, tk, np.random.default_rng(4)),
        jvocab.subsample_mask(idx, jk, np.random.default_rng(4)))


def test_parallel_count_equals_serial(sents):
    """Counting in two spawned workers gives the serial counts."""
    serial = tdv.parallel_count(sents, n_workers=1)
    par = tdv.parallel_count(sents, n_workers=2, chunk_size=50)
    assert par == serial


def test_text_pipeline_equals_jax():
    """Tokenizers, preprocessors, stop words, windows and the sentence
    transformer give the JAX package's tokens."""
    lines = ["The Quick brown fox, jumped!", "over the lazy dogs 42 times",
             "a", "running quickly and jumped"]
    out = []
    for mod in (jtext, ttext):
        fac = mod.DefaultTokenizerFactory()
        fac.set_token_pre_processor(mod.StemmingPreprocessor())
        it = mod.CollectionSentenceIterator(lines)
        toks = list(mod.SentenceTransformer(it, fac, mod.get_stop_words()))
        grams = mod.NGramTokenizerFactory(1, 3).create(lines[0]).get_tokens()
        wins = [(w.words, w.begin, w.end)
                for w in mod.windows(lines[1].split(), 5)]
        pre = list(mod.PrefetchingSentenceIterator(
            mod.CollectionSentenceIterator(lines), buffer_size=2))
        out.append((toks, grams, wins, pre,
                    mod.input_homogenization("Café, Noël!")))
    assert out[1] == out[0]


# ------------------------------------------------------------- (b) K13

@pytest.mark.parametrize("D", [128, 64], ids=["pallas", "jnp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neg_softmax_matches_jax(D, dtype):
    """K13's plain version (what the port computes on CPU tensors, and
    the kernel on the card) against the JAX neg_softmax_scores: the
    Pallas kernel in interpret mode inside its envelope (D=128), the
    jnp body outside it (D=64). f32: 1e-6; bf16: 8e-3. In bf16 the
    reference is the JAX kernel's math body `_score_body` (what both of
    its branches run): the Pallas kernel's bf16 store of its f32 scores
    is refused in interpret mode under current jax ("Invalid dtype for
    `swap`")."""
    B, K = 16, 5
    assert jax_supports(B, K, D) == (D == 128)
    rng = np.random.default_rng(D)
    c, pos = (0.3 * rng.standard_normal((B, D))).astype(np.float32), \
        (0.3 * rng.standard_normal((B, D))).astype(np.float32)
    neg = (0.3 * rng.standard_normal((B, K, D))).astype(np.float32)
    ref = jax_scores if dtype == "float32" else jax_score_body
    jp, jn = ref(*(jnp.asarray(a, dtype) for a in (c, pos, neg)))
    tdt = getattr(torch, dtype)
    tp, tn = tns.neg_softmax_scores(*(torch.from_numpy(a).to(tdt)
                                      for a in (c, pos, neg)))
    assert tp.dtype == tdt and tp.shape == (B,) and tn.shape == (B, K)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for t, j in ((tp, jp), (tn, jn)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=0,
                                   atol=tol)
    assert tns.LAUNCHES["K13"] == 0  # CPU tensors never launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neg_softmax_strided_views_match_jax(dtype):
    """Fault C2: c and pos two columns of one [B, 2, D] buffer and neg the
    first K of K + 2 rows a triple (strided views) score as the JAX
    package scores the same rows, at the tolerances above."""
    B, K, D = 16, 5, 128
    rng = np.random.default_rng(3)
    both = (0.3 * rng.standard_normal((B, 2, D))).astype(np.float32)
    wide = (0.3 * rng.standard_normal((B, K + 2, D))).astype(np.float32)
    ref = jax_scores if dtype == "float32" else jax_score_body
    jp, jn = ref(*(jnp.asarray(a, dtype) for a in (
        both[:, 0], both[:, 1], wide[:, :K])))
    tdt = getattr(torch, dtype)
    c, pos = torch.from_numpy(both).to(tdt).unbind(1)
    neg = torch.from_numpy(wide).to(tdt)[:, :K]
    assert not any(t.is_contiguous() for t in (c, pos, neg))
    tp, tn = tns.neg_softmax_scores(c, pos, neg)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for t, j in ((tp, jp), (tn, jn)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=0,
                                   atol=tol)


def test_neg_softmax_cuda_tensor_never_falls_back(monkeypatch):
    """On a CUDA tensor the wrapper checks and launches; a tensor it
    does not take raises instead of computing the plain version."""
    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float64
        shape = (4, 8)
        ndim = 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tns._check(FakeCuda(), FakeCuda(), FakeCuda())


# ---------------------------------------------------- (c) the lookup steps

def _tables(rng, V, D):
    return {"syn0": (rng.random((V, D), np.float32) - 0.5) / D,
            "syn1": (0.1 * rng.standard_normal((V, D))).astype(np.float32),
            "syn1neg": (0.1 * rng.standard_normal((V, D))).astype(
                np.float32)}


@pytest.mark.parametrize("lr", [0.025, 2.0], ids=["lr", "capped"])
@pytest.mark.parametrize("step", ["sgns", "hs", "cbow"])
def test_lookup_steps_match_jax(step, lr):
    """One step of sgns_step / sg_hs_step / cbow_ns_step on the same
    tables and batch (a 40-row vocab, so rows repeat in the batch; at
    lr=2 the per-row step cap binds), 1e-6 of the largest entry."""
    rng = np.random.default_rng(7)
    V, D, B, K, L, W = 40, 32, 64, 5, 6, 6
    tab = _tables(rng, V, D)
    center = rng.integers(0, V, B).astype(np.int32)
    context = rng.integers(0, V, B).astype(np.int32)
    negs = rng.integers(0, V, (B, K)).astype(np.int32)
    codes = rng.integers(0, 2, (B, L)).astype(np.int8)
    points = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.7
    ctx = rng.integers(0, V, (B, W)).astype(np.int32)
    cmask = rng.random((B, W)) < 0.6
    out_name = {"sgns": "syn1neg", "hs": "syn1", "cbow": "syn1neg"}[step]
    j0, j1 = jnp.asarray(tab["syn0"]), jnp.asarray(tab[out_name])
    t0, t1 = (torch.from_numpy(tab[n].copy()) for n in ("syn0", out_name))
    if step == "sgns":
        jr = jlookup.sgns_step(j0, j1, center, context, negs, lr)
        tr = tlookup.sgns_step(t0, t1, center, context, negs, lr)
    elif step == "hs":
        jr = jlookup.sg_hs_step(j0, j1, center, codes, points, mask, lr)
        tr = tlookup.sg_hs_step(t0, t1, center, codes, points, mask, lr)
    else:
        jr = jlookup.cbow_ns_step(j0, j1, ctx, cmask, center, negs, lr)
        tr = tlookup.cbow_ns_step(t0, t1, ctx, cmask, center, negs, lr)
    for t, j in zip(tr, jr):
        _close(t.numpy(), np.asarray(j), 1e-6)
    if lr > 1:  # the cap binds: some row moved by exactly MAX_ROW_STEP
        moved = np.linalg.norm(tr[0].numpy() - tab["syn0"], axis=1)
        assert np.isclose(moved.max(), tlookup.MAX_ROW_STEP, rtol=1e-4)


# ------------------------------------------------ (d) the engine's steps

@pytest.mark.parametrize("kind", ["sgns", "hs"])
def test_engine_matches_legacy_dense_path(kind):
    """The port's ShardedEmbeddingEngine over 10 steps against the JAX
    lookup.sgns_step / sg_hs_step (the JAX engine's ep=1 contract) from
    the same tables: losses and tables within 1e-5."""
    rng = np.random.default_rng(11)
    V, D, B, K, L = 300, 64, 128, 5, 8
    tab = _tables(rng, V, D)
    eng = ShardedEmbeddingEngine(V, D, negative=K, use_hs=kind == "hs",
                                 device="cpu")
    for name, t in tables_from_jax(tab, "cpu").items():
        setattr(eng, name, t)
    j = {n: jnp.asarray(a) for n, a in tab.items()}
    jl = []
    for s in range(10):
        center = rng.integers(0, V, B).astype(np.int32)
        lr = 0.025 * (1 - s / 10)
        if kind == "sgns":
            context = rng.integers(0, V, B).astype(np.int32)
            negs = rng.integers(0, V, (B, K)).astype(np.int32)
            j["syn0"], j["syn1neg"], loss = jlookup.sgns_step(
                j["syn0"], j["syn1neg"], center, context, negs, lr)
            eng.sgns_step(center, context, negs, lr)
        else:
            codes = rng.integers(0, 2, (B, L)).astype(np.int8)
            points = rng.integers(0, V, (B, L)).astype(np.int32)
            mask = rng.random((B, L)) < 0.8
            j["syn0"], j["syn1"], loss = jlookup.sg_hs_step(
                j["syn0"], j["syn1"], center, codes, points, mask, lr)
            eng.hs_step(center, codes, points, mask, lr)
        jl.append(float(loss))
    np.testing.assert_allclose([float(x) for x in eng.loss_history], jl,
                               rtol=1e-5)
    got = tables_to_numpy(eng)
    for name in TABLES:
        _close(got[name], np.asarray(j[name]), 1e-5)
    assert eng.table_bytes_per_device() == 3 * V * D * 4


def test_engine_refuses_sharding():
    """ep or dp > 1 runs one shard a rank over a process group, or every
    shard in this process when the caller asks (in_process=True:
    tests/test_torch_embedding_sharded.py); with neither it raises."""
    for kw in ({"ep": 2}, {"dp": 2}):
        with pytest.raises(ValueError, match="in_process=True"):
            ShardedEmbeddingEngine(16, 8, device="cpu", **kw)
        eng = ShardedEmbeddingEngine(16, 8, device="cpu", in_process=True,
                                     **kw)
        assert (eng.ep, eng.dp) == (kw.get("ep", 1), kw.get("dp", 1))


# ----------------------------------------------------- (e) the whole slice

def _jax_w2v(sents, algo, batch=256):
    b = (JaxWord2Vec.builder().layer_size(128).window_size(5)
         .min_word_frequency(1).epochs(1).seed(1).batch_size(batch)
         .use_engine(False))
    return _configure(b, algo).build()


def _port_w2v(sents, algo, batch=256):
    b = (Word2Vec.builder().layer_size(128).window_size(5)
         .min_word_frequency(1).epochs(1).seed(1).batch_size(batch)
         .device("cpu"))
    return _configure(b, algo).build()


def _configure(b, algo):
    if algo == "hs":
        return b.use_hierarchic_softmax(True)
    b = b.negative_sample(5)
    return b.elements_learning_algorithm("cbow") if algo == "cbow" else b


def _trained_pair(sents, algo):
    jm, tm = _jax_w2v(sents, algo), _port_w2v(sents, algo)
    jm.build_vocab(sents)
    tm.build_vocab(sents)
    arrays = {n: np.asarray(getattr(jm.lookup_table, n)) for n in TABLES}
    for name, t in tables_from_jax(arrays, "cpu").items():
        setattr(tm.lookup_table, name, t)
    jm.fit(sents)
    tm.fit(sents)
    return jm, tm


@pytest.mark.parametrize("algo", ["sgns", "hs", "cbow"])
def test_word2vec_matches_jax(sents, algo):
    """The port's Word2Vec (engine on for skip-gram) against the JAX
    package's Word2Vec on the legacy dense path, from the same tables:
    loss histories at 1e-5 relative, final syn0 at 1e-5 absolute, and
    the same 5 nearest words for three words."""
    jm, tm = _trained_pair(sents, algo)
    assert (tm._engine is not None) == (algo != "cbow")
    assert tm.vocab.words() == jm.vocab.words()
    assert len(tm.loss_history) == len(jm.loss_history) > 10
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-5)
    if algo != "hs":
        assert tm.loss_history[0] == pytest.approx(6 * np.log(2), abs=1e-5)
    np.testing.assert_allclose(tm.lookup_table.vectors(),
                               np.asarray(jm.lookup_table.syn0), rtol=0,
                               atol=1e-5)
    for w in ("w0", "w1", "w7"):
        assert tm.words_nearest(w, 5) == jm.words_nearest(w, 5)
    assert tm.similarity("w0", "w20") == pytest.approx(
        jm.similarity("w0", "w20"), abs=1e-5)
    a = tm.words_nearest_sum(["w0", "w20"], ["w1"], 5)
    assert a == jm.words_nearest_sum(["w0", "w20"], ["w1"], 5)


def test_device_pipeline_raises(sents):
    """The pipeline trains (tests/test_torch_device_pipeline.py); it
    raises only where the JAX package refuses too: hierarchical softmax,
    and a chunk group that does not divide over the mesh's "data" axis
    (the mesh itself trains: tests/test_torch_embedding_sharded.py)."""
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    m = (Word2Vec.builder().use_device_pipeline().use_hierarchic_softmax()
         .device("cpu").build())
    with pytest.raises(ValueError, match="negative sampling"):
        m.fit(sents[:20])
    m = (Word2Vec.builder().device_mesh(InProcessShards(2), group=3)
         .device("cpu").build())
    with pytest.raises(ValueError, match="pipeline_group=3 does not divide"):
        m.fit(sents[:20])


# ------------------------------------------------------ the engine's feed

def test_pair_feed_is_fixed_shape_and_deterministic():
    """sequence_pair_batches + with_negatives through the prefetch
    channel: fixed [batch] shapes, every pair inside the window, the
    tail padded, and the same seeds give the same batches."""
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 50, 25) for _ in range(30)]
    cum = np.arange(1, 51, dtype=np.float64) / 50

    def feed():
        return list(prefetched(with_negatives(
            sequence_pair_batches(seqs, batch_size=128, window=5, seed=5),
            cum, 5, seed=7), depth=2))

    a, b = feed(), feed()
    pairs = sum(2 * 5 * 25 - 5 * 6 for _ in seqs)
    assert len(a) == -(-pairs // 128)
    for (c, x, n), (c2, x2, n2) in zip(a, b):
        assert c.shape == x.shape == (128,) and n.shape == (128, 5)
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(n, n2)


def test_walk_pairs_match_sequence_pairs():
    """Walks through the bucketer and the pair extractor give the same
    multiset of (center, context) pairs as the full-window sequence
    feed."""
    rng = np.random.default_rng(4)
    walks = [rng.integers(0, 30, n) for n in (5, 9, 16, 3, 12)]
    got = np.concatenate([np.stack(b, 1) for b in walk_pair_batches(
        walks, batch_size=8, window=2, walk_batch=4, device="cpu")])
    want = np.concatenate([np.stack(b, 1) for b in sequence_pair_batches(
        walks, batch_size=8, window=2)])
    n_pairs = sum(2 * 2 * n - 2 * 3 for n in (5, 9, 16, 3, 12))
    assert sorted(map(tuple, got[:n_pairs])) == sorted(
        map(tuple, want[:n_pairs]))


# ------------------------------------------------------ (f) the serializer

def _write(model, fmt, path, serializer):
    if fmt == "text":
        serializer.write_word_vectors(model, path)
    elif fmt == "binary":
        serializer.write_binary(model, path)
    else:
        serializer.write_full_model(model, path)


def _read(fmt, path, serializer, **kw):
    if fmt == "text":
        return serializer.load_txt_vectors(path, **kw)
    if fmt == "binary":
        return serializer.load_google_model(path, binary=True, **kw)
    return serializer.read_full_model(path, **kw)


@pytest.fixture(scope="module")
def trained(sents):
    return _trained_pair(sents[:60], "sgns")


@pytest.mark.parametrize("fmt", ["text", "binary", "zip"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_serializer_cross_reads(trained, tmp_path, fmt, direction):
    """A file written by one package reads back in the other: the same
    words in the same order and the same vectors (the text format keeps
    6 decimals)."""
    jm, tm = trained
    path = str(tmp_path / f"vectors.{fmt}")
    if direction == "port_to_jax":
        src, words = tm, tm.vocab.words()
        _write(tm, fmt, path, WordVectorSerializer)
        back = _read(fmt, path, JaxSerializer)
    else:
        src, words = jm, jm.vocab.words()
        _write(jm, fmt, path, JaxSerializer)
        back = _read(fmt, path, WordVectorSerializer, device="cpu")
    assert back.vocab.words() == words
    want = np.asarray(src.lookup_table.vectors())
    got = np.asarray(back.lookup_table.vectors())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if fmt == "text" else 0)
    if fmt == "zip":
        for name in TABLES:
            np.testing.assert_array_equal(
                np.asarray(getattr(back.lookup_table, name)),
                np.asarray(getattr(src.lookup_table, name)))
        assert [w.code for w in back.vocab.vocab_words()] == \
            [w.code for w in src.vocab.vocab_words()]
