"""The port's GloVe (deeplearning4j_tpu_torch/nlp/glove.py) against the
JAX package's on the CPU.

The JAX epoch shuffles with `jax.random.permutation` and initialises W
and W̃ with `jax.random.uniform`; the port draws both from torch
generators. So the tests carry the JAX init across
(`weights_io.glove_state_from_jax`) and replace the port's
`draw_permutation` with the JAX permutation. Duplicate rows in a batch
sum through `index_add_` (`.at[].add` in JAX), and every AdaGrad
accumulator update lands before a row update reads it, in both.
Tolerances: co-occurrence counts exact; one epoch 1e-6 of the largest
entry; a 3-epoch fit compounds sum-order differences: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.weights_io import (
    glove_state_from_jax,
    glove_state_to_numpy,
)

pytestmark = pytest.mark.port

STATE = tglove.GLOVE_STATE


def _close(a, ref, tol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _corpus(rng, n=80):
    words = [f"w{i}" for i in range(40)]
    return [list(rng.choice(words[:20] if rng.random() < 0.5 else words[20:],
                            size=10)) for _ in range(n)]


def _state(rng, V, D):
    return {"W": ((rng.random((V, D)) - 0.5) / D).astype(np.float32),
            "Wc": ((rng.random((V, D)) - 0.5) / D).astype(np.float32),
            "b": (0.1 * rng.standard_normal(V)).astype(np.float32),
            "bc": (0.1 * rng.standard_normal(V)).astype(np.float32),
            "hW": np.full((V, D), 1e-8, np.float32),
            "hWc": np.full((V, D), 1e-8, np.float32),
            "hb": np.full(V, 1e-8, np.float32),
            "hbc": np.full(V, 1e-8, np.float32)}


def _triples(rng, V, n, batch):
    """n triples over a V-word vocab (rows repeat within a batch),
    padded with fx = 0 to a multiple of batch."""
    ii, jj = rng.integers(0, V, n), rng.integers(0, V, n)
    x = rng.random(n) * 20 + 0.5
    logx, fx = np.log(x), np.minimum(1.0, (x / 10) ** 0.75)
    pad = (-n) % batch
    return tuple(np.concatenate([a, np.zeros(pad)]).astype(dt)
                 for a, dt in ((ii, np.int32), (jj, np.int32),
                               (logx, np.float32), (fx, np.float32)))


def test_cooccurrences_equal_jax():
    seq = np.random.default_rng(0).integers(0, 12, 40)
    for symmetric in (True, False):
        jc = jglove.AbstractCoOccurrences(4, symmetric)
        tc = tglove.AbstractCoOccurrences(4, symmetric)
        jc.accumulate(seq)
        tc.accumulate(seq)
        for got, want in zip(tc.arrays(), jc.arrays()):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["unshuffled", "jax_permutation"])
def test_one_epoch_matches_jax(shuffle, monkeypatch):
    """One epoch of 6 batches of 64 triples over a 24-word vocab at
    lr 0.05, from the same state (and the same permutation)."""
    rng = np.random.default_rng(1)
    V, D, B = 24, 8, 64
    st = _state(rng, V, D)
    ii, jj, logx, fx = _triples(rng, V, 350, B)
    key = jax.random.PRNGKey(4)
    out = jglove.make_glove_epoch(B, shuffle)(
        *(jnp.asarray(st[n]) for n in STATE), jnp.asarray(ii),
        jnp.asarray(jj), jnp.asarray(logx), jnp.asarray(fx), key, 0.05)
    if shuffle:
        perm = torch.from_numpy(np.array(
            jax.random.permutation(key, ii.shape[0])))
        monkeypatch.setattr(tglove, "draw_permutation",
                            lambda gen, n, device: perm)
    state = glove_state_from_jax(st, "cpu")
    losses = tglove.make_glove_epoch(B, shuffle)(
        state, *(torch.from_numpy(a).long() if a.dtype == np.int32
                 else torch.from_numpy(a) for a in (ii, jj, logx, fx)),
        None, 0.05)
    got = glove_state_to_numpy(state)
    for name, want in zip(STATE, out[:8]):
        _close(got[name], np.asarray(want), 1e-6)
    _close(losses.numpy(), np.asarray(out[8]), 1e-6)


def test_glove_fit_matches_jax(monkeypatch):
    """A 3-epoch Glove fit in both packages: the JAX init carried in, the
    JAX epoch permutations injected; losses and vectors within 1e-5."""
    sents = _corpus(np.random.default_rng(2))
    kw = dict(layer_size=8, window_size=4, epochs=3, seed=3, batch_size=256)
    jm = jglove.Glove(**kw)
    jm.fit(sents)
    tm = tglove.Glove(device="cpu", **kw)
    tm.build_vocab(sents)
    V, D = tm.vocab.num_words(), 8
    key, k1, k2 = jax.random.split(jax.random.PRNGKey(3), 3)
    scale = 0.5 / D
    init = _state(np.random.default_rng(0), V, D)
    init["W"] = np.asarray((jax.random.uniform(k1, (V, D)) - 0.5) * 2 * scale)
    init["Wc"] = np.asarray((jax.random.uniform(k2, (V, D)) - 0.5)
                            * 2 * scale)
    init["b"][:] = 0
    init["bc"][:] = 0
    subs = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        subs.append(sub)
    perms = iter(subs)
    monkeypatch.setattr(
        tglove, "draw_permutation", lambda gen, n, device: torch.from_numpy(
            np.array(jax.random.permutation(next(perms), n))))
    tm.fit(sents, init_state=glove_state_from_jax(init, "cpu"))
    assert tm.vocab.words() == jm.vocab.words()
    assert len(tm.loss_history) == len(jm.loss_history)
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-5)
    _close(tm.lookup_table.vectors(), np.asarray(jm.lookup_table.syn0), 1e-5)
    assert tm.words_nearest("w0", 5) == jm.words_nearest("w0", 5)
    assert tm.cooccurrence_seconds > 0
    assert set(tm.state) == set(STATE)


def test_glove_learns_on_its_own_draws():
    """The port's own init and shuffles: the loss falls epoch over epoch
    and same-cluster words end closer than cross-cluster ones."""
    sents = _corpus(np.random.default_rng(5), 200)
    g = tglove.Glove(layer_size=16, window_size=5, epochs=8, seed=11,
                     batch_size=512, device="cpu")
    g.fit(sents)
    per_epoch = np.reshape(g.loss_history, (8, -1)).sum(1)
    assert (np.diff(per_epoch) < 0).all(), per_epoch
    assert g.similarity("w1", "w2") > g.similarity("w1", "w30")


def test_glove_mesh_raises():
    """A device mesh trains (tests/test_torch_embedding_sharded.py); what
    raises is a mesh without a "data" axis and a batch that does not
    split over it."""
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    with pytest.raises(ValueError, match="'data' axis"):
        tglove.make_glove_epoch(64, True, mesh=object())
    with pytest.raises(ValueError, match="batch=64 not divisible"):
        tglove.make_glove_epoch(64, True, mesh=InProcessShards(3))
    g = tglove.Glove(layer_size=4, epochs=1, device_mesh=object(),
                     device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        g.fit(_corpus(np.random.default_rng(6), 10))
