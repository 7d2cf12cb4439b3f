"""The port's whole-epoch Word2Vec pipeline
(deeplearning4j_tpu_torch/nlp/device_pipeline.py, SequenceVectors'
`use_device_pipeline`) against the JAX package's on the CPU.

The JAX epoch draws its window shrinks and negatives inside its jitted
scan from `fold_in(key, u * group + g)`; the port draws them from a
torch.Generator through `device_pipeline.draw_update`. The parity tests
replace `draw_update` with the JAX draws, recomputed from the same keys
with `jax.random` and the JAX `_alias_sample`, so both packages train on
the same pairs and negatives. The port's own sampler is held to the
unigram^0.75 distribution by a chi-square bound instead.

Tolerances: host code (alias tables, packing) is exact. One chunk's
gradient pieces sum in another order than XLA on the CPU: 1e-6 of the
largest entry. Three updates, and a whole Word2Vec fit, compound that:
1e-5 (tables absolute, losses relative).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import device_pipeline as jdp
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxWord2Vec
from deeplearning4j_tpu_torch.nlp import device_pipeline as tdp
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.weights_io import tables_from_jax

pytestmark = pytest.mark.port

V, D, W, K = 60, 16, 3, 4
JIT_STATIC = ("start", "chunk", "window", "K", "share_negatives",
              "neg_oversample")


def _close(a, ref, tol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _probs(rng, n=V):
    p = rng.random(n) ** 3 + 1e-3
    return p / p.sum()


def _corpus(rng, n_tokens):
    """Packed tokens with sentences of 3..12 tokens and 5 padding
    positions at the end (sent id -1)."""
    toks = rng.integers(0, V, n_tokens).astype(np.int32)
    lengths = rng.integers(3, 13, n_tokens)
    sent = np.repeat(np.arange(n_tokens), lengths)[:n_tokens].astype(
        np.int32)
    sent[-5:] = -1
    return toks, sent


def _tables(rng):
    return ((rng.random((V, D), np.float32) - 0.5) / D,
            (0.3 * rng.standard_normal((V, D))).astype(np.float32))


@partial(jax.jit, static_argnames=("chunk", "window", "neg_shape"))
def _jax_draws_jit(key, J, q, *, chunk, window, neg_shape):
    kb, kn = jax.random.split(key)
    b = jax.random.randint(kb, (chunk,), 1, window + 1)
    return b, jdp._alias_sample(kn, J, q, (chunk, *neg_shape))


def _jax_draws(key, J, q, *, chunk, window, neg_shape):
    """The draws the JAX chunk function makes from `key`: b from the
    first split, the alias negatives from the second."""
    b, negs = _jax_draws_jit(key, jnp.asarray(J), jnp.asarray(q),
                             chunk=chunk, window=window,
                             neg_shape=tuple(neg_shape))
    return (torch.from_numpy(np.array(b)).long(),
            torch.from_numpy(np.array(negs)).long())


def _inject_jax_draws(monkeypatch, key):
    """Replace the port's draw_update with the JAX epoch's draws from
    `key` (the fold_in of u * group + g per chunk)."""
    def draws(gen, u, J, q, *, chunk, group, window, neg_shape):
        parts = [_jax_draws(jax.random.fold_in(key, u * group + g),
                            J.numpy(), q.numpy(), chunk=chunk,
                            window=window, neg_shape=neg_shape)
                 for g in range(group)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    monkeypatch.setattr(tdp, "draw_update", draws)


# ------------------------------------------------------------ host code

def test_alias_table_equals_jax():
    p = _probs(np.random.default_rng(0), 500)
    for got, want in zip(tdp.build_alias_table(p), jdp.build_alias_table(p)):
        np.testing.assert_array_equal(got, want)


def test_alias_sampler_follows_unigram():
    """200k draws of the port's sampler against unigram^0.75 over a
    200-word vocab of Zipf counts (count ~ 1/rank, so every bin expects
    over 300 draws and the chi-square approximation holds): the
    statistic below dof + 6 sqrt(2 dof) (a 6-sigma bound of its normal
    approximation)."""
    counts = 1e6 / np.arange(1, 201)
    p = counts ** 0.75 / (counts ** 0.75).sum()
    J, q = (torch.from_numpy(a) for a in tdp.build_alias_table(p))
    gen = torch.Generator().manual_seed(3)
    n = 200_000
    draws = tdp.alias_sample(gen, J, q, (n,)).numpy()
    obs = np.bincount(draws, minlength=200)
    exp = n * p
    chi2 = ((obs - exp) ** 2 / exp).sum()
    dof = 199
    assert chi2 < dof + 6 * np.sqrt(2 * dof), chi2


def test_pack_corpus_equals_jax():
    seqs = [np.array([1, 2, 3]), np.array([], np.int32), np.array([4, 5])]
    for got, want in zip(tdp.pack_corpus(seqs, 8), jdp.pack_corpus(seqs, 8)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tdp.pack_corpus([np.array([], np.int32)], 8)


# ------------------------------------------------------ one chunk's grads

@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_pair"])
def test_chunk_pair_grads_match_jax(share):
    rng = np.random.default_rng(2)
    syn0, syn1 = _tables(rng)
    toks, sent = _corpus(rng, 200)
    J, q = jdp.build_alias_table(_probs(rng))
    chunk, start, key = 64, 128, jax.random.PRNGKey(5)
    want = jax.jit(jdp._chunk_pair_grads, static_argnames=JIT_STATIC)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(toks),
        jnp.asarray(sent), jnp.asarray(J), jnp.asarray(q), start, key,
        chunk=chunk, window=W, K=K, share_negatives=share,
        neg_oversample=1.5)
    neg_shape = (6,) if share else (2 * W, K)
    b, negs = _jax_draws(key, J, q, chunk=chunk, window=W,
                         neg_shape=neg_shape)
    got = tdp._chunk_pair_grads(
        torch.from_numpy(syn0), torch.from_numpy(syn1),
        torch.from_numpy(toks), torch.from_numpy(sent), start, b, negs,
        window=W, K=K, share_negatives=share)
    for g, w in zip(got, want):
        if np.asarray(w).dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.numpy(), np.asarray(w), 1e-6)
    assert float(got[-1]) > 0  # valid pairs exist


def test_chunk_cbow_grads_match_jax():
    rng = np.random.default_rng(3)
    syn0, syn1 = _tables(rng)
    toks, sent = _corpus(rng, 200)
    J, q = jdp.build_alias_table(_probs(rng))
    chunk, start, key = 64, 136, jax.random.PRNGKey(6)
    want = jax.jit(jdp._chunk_cbow_grads, static_argnames=JIT_STATIC[:4])(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(toks),
        jnp.asarray(sent), jnp.asarray(J), jnp.asarray(q), start, key,
        chunk=chunk, window=W, K=K)
    b, negs = _jax_draws(key, J, q, chunk=chunk, window=W, neg_shape=(K,))
    got = tdp._chunk_cbow_grads(
        torch.from_numpy(syn0), torch.from_numpy(syn1),
        torch.from_numpy(toks), torch.from_numpy(sent), start, b, negs,
        window=W, K=K)
    for g, w in zip(got, want):
        if np.asarray(w).dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.numpy(), np.asarray(w), 1e-6)


# ----------------------------------------------------------- the epochs

@pytest.mark.parametrize("algo", ["sgns", "sgns_per_pair", "cbow"])
def test_three_update_epoch_matches_jax(algo, monkeypatch):
    """3 updates of 2 chunks of 32 centers at lr 0.5 -> 0.2 (the trust
    region binds on some rows) from the same tables and draws: tables
    and per-update losses and counts within 1e-5."""
    rng = np.random.default_rng(4)
    syn0, syn1 = _tables(rng)
    chunk, group = 32, 2
    toks, sent = _corpus(rng, 3 * chunk * group)
    J, q = jdp.build_alias_table(_probs(rng))
    key = jax.random.PRNGKey(9)
    kw = dict(window=W, negative=K, chunk=chunk, group=group)
    if algo == "cbow":
        jfn, tfn = jdp.make_cbow_epoch(**kw), tdp.make_cbow_epoch(**kw)
    else:
        share = algo == "sgns"
        jfn = jdp.make_sgns_epoch(share_negatives=share, **kw)
        tfn = tdp.make_sgns_epoch(share_negatives=share, **kw)
    want = jfn(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(toks),
               jnp.asarray(sent), jnp.asarray(J), jnp.asarray(q), key,
               0.5, 0.2)
    _inject_jax_draws(monkeypatch, key)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    got = tfn(t0, t1, torch.from_numpy(toks), torch.from_numpy(sent),
              torch.from_numpy(J), torch.from_numpy(q), None, 0.5, 0.2)
    assert got[0] is t0 and got[1] is t1  # in place
    assert got[2].shape == (3,)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-5)
    # the trust region binds: a row moved past one capped step, and no
    # row moved more than three (MAX_ROW_STEP = 0.1 per update)
    moved = np.linalg.norm(t0.numpy() - syn0, axis=1)
    assert 0.1 < moved.max() <= 0.3 + 1e-5


def test_lr_ramp_is_f32():
    got = tdp._ramp(0.025, 0.001, 7)
    u = jnp.arange(7)
    want = 0.025 + (0.001 - 0.025) * (u.astype(jnp.float32) / 7)
    np.testing.assert_array_equal(np.float32(got), np.asarray(want))


def test_draw_update_shapes_and_range():
    J, q = (torch.from_numpy(a) for a in tdp.build_alias_table(
        _probs(np.random.default_rng(5))))
    gen = torch.Generator().manual_seed(0)
    b, negs = tdp.draw_update(gen, 0, J, q, chunk=16, group=3, window=W,
                              neg_shape=(2 * W, K))
    assert b.shape == (48,) and negs.shape == (48, 2 * W, K)
    assert int(b.min()) >= 1 and int(b.max()) <= W
    assert 0 <= int(negs.min()) and int(negs.max()) < V


# ------------------------------------------------------ the whole slice

def _topic_sents(rng, n_sents=120, vocab=200, n_topics=10, sent_len=12):
    per = vocab // n_topics
    p = 1.0 / np.arange(1, per + 1)
    p /= p.sum()
    topics = rng.integers(0, n_topics, n_sents)
    ranks = rng.choice(per, size=(n_sents, sent_len), p=p)
    return [[f"w{j}" for j in row]
            for row in ranks * n_topics + topics[:, None]]


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_word2vec_pipeline_matches_jax(algo, monkeypatch):
    """Word2Vec.builder()...use_device_pipeline(True) in both packages,
    tables copied across and the JAX draws injected (its epoch key is
    PRNGKey(seed + words done)): loss histories and syn0 within 1e-5."""
    sents = _topic_sents(np.random.default_rng(6))

    def build(builder):
        b = (builder().layer_size(D).window_size(W).min_word_frequency(1)
             .negative_sample(K).epochs(2).seed(3)
             .elements_learning_algorithm(algo).use_device_pipeline(True))
        m = b.build()
        m.pipeline_chunk, m.pipeline_group = 64, 2
        return m

    jm = build(JaxWord2Vec.builder)
    tm = build(lambda: Word2Vec.builder().device("cpu"))
    jm.build_vocab(sents)
    tm.build_vocab(sents)
    arrays = {n: np.asarray(getattr(jm.lookup_table, n))
              for n in ("syn0", "syn1neg")}
    for name, t in tables_from_jax(arrays, "cpu").items():
        setattr(tm.lookup_table, name, t)
    assert tm._engine is None  # the pipeline keeps the dense tables
    # two epochs of 1440 tokens padded to 1536: the JAX fit keys its
    # epochs PRNGKey(seed + tokens done)
    keys = iter([jax.random.PRNGKey(3), jax.random.PRNGKey(3 + 1536)])
    real_build = tdp._build_epoch

    def build_epoch(*a, **kw):
        inner = real_build(*a, **kw)

        def epoch(*args):
            _inject_jax_draws(monkeypatch, next(keys))
            return inner(*args)

        return epoch

    monkeypatch.setattr(tdp, "_build_epoch", build_epoch)
    jm.fit(sents)
    tm.fit(sents)
    assert len(tm.loss_history) == len(jm.loss_history) == 2 * 12
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-5)
    _close(tm.lookup_table.vectors(), np.asarray(jm.lookup_table.syn0), 1e-5)
    assert tm.words_nearest("w0", 5) == jm.words_nearest("w0", 5)


def test_device_pipeline_learns_and_stays_finite():
    """The port's own draws: both arms and CBOW train to finite losses
    that fall from the first update to the last."""
    sents = _topic_sents(np.random.default_rng(7), n_sents=400)
    for kw in ({}, {"share_negatives": False}, {"cbow": True}):
        b = (Word2Vec.builder().layer_size(D).window_size(W)
             .negative_sample(K).epochs(3).seed(1).learning_rate(0.05)
             .use_device_pipeline(True).device("cpu"))
        if kw.get("cbow"):
            b = b.elements_learning_algorithm("cbow")
        if "share_negatives" in kw:
            b = b.share_negatives(False)
        m = b.build()
        m.fit(sents)
        ls = m.loss_history
        assert all(np.isfinite(ls)) and ls[-1] < ls[0], (kw, ls)


def test_device_pipeline_refuses_what_jax_refuses():
    sents = _topic_sents(np.random.default_rng(8), n_sents=20)
    for b in (Word2Vec.builder().use_hierarchic_softmax(True),
              Word2Vec.builder().negative_sample(0)):
        m = b.use_device_pipeline(True).device("cpu").build()
        with pytest.raises(ValueError, match="negative sampling"):
            m.fit(sents)
    # a mesh whose "data" axis does not divide the chunk group: both
    # packages refuse it with the same words
    from types import SimpleNamespace

    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    m = (Word2Vec.builder().device_mesh(InProcessShards(3), group=4)
         .device("cpu").build())
    with pytest.raises(ValueError, match="does not divide over the 3-way"):
        m.fit(sents)
    for make, mesh in ((tdp.make_cbow_epoch, InProcessShards(3)),
                       (jdp.make_cbow_epoch,
                        SimpleNamespace(shape={"data": 3}))):
        with pytest.raises(ValueError, match="group=4 not divisible by mesh "
                                             "data axis size 3"):
            make(window=2, negative=2, group=4, mesh=mesh)
    with pytest.raises(ValueError, match="'data' axis"):
        tdp.make_cbow_epoch(window=2, negative=2, mesh=object())
