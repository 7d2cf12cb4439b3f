"""The decode steps of a MultiLayerNetwork transformer stack
(nn/multilayer.py `incremental_decode_fn`, `prefill_fn`,
`verify_decode_fn`, `init_kv_cache`; nn/decode.py `_plan` over a layer
list) against the JAX package on the CPU, on the stack of the JAX
package's tests/test_generation.py
`test_incremental_decode_matches_full_forward_mln`, its params copied
across with `params_from_jax`.

The contract: prefill plus single-token steps give the greedy tokens of
the full forward, in the port and in the JAX package alike; the prefill
and verify steps give the JAX package's probabilities; the stack serves
through `GenerationEngine` to the same tokens. Tolerance: float32 on
both sides, summed in another order: 1e-5 absolute on probabilities.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nn import conf as jax_conf
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.nn import conf as torch_conf
from deeplearning4j_tpu_torch.nn.conf import layers as torch_layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import GenerationEngine
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

ATOL = 1e-5
VOCAB, D, CAP = 32, 16, 16
# each package's conf builder and layer classes in one namespace
jconf = SimpleNamespace(**{**vars(jax_layers), **vars(jax_conf)})
tconf = SimpleNamespace(**{**vars(torch_layers), **vars(torch_conf)})


def _conf(c, extra=()):
    """Embedding -> positional encoding -> causal attention -> layer
    norm (-> `extra`) -> softmax head, from either package's conf
    module."""
    b = c.NeuralNetConfiguration.builder().seed(9).list()
    b.layer(c.EmbeddingLayer(n_in=VOCAB, n_out=D, activation="identity",
                             has_bias=False))
    b.layer(c.PositionalEncodingLayer(max_length=32, n_features=D))
    b.layer(c.SelfAttentionLayer(n_in=D, n_out=D, n_heads=2, causal=True,
                                 activation="identity"))
    b.layer(c.LayerNormalization(n_in=D, n_out=D))
    for lc in extra:
        b.layer(lc(c))
    b.layer(c.RnnOutputLayer(n_in=D, n_out=VOCAB, activation="softmax",
                             loss_function="mcxent"))
    return b.build()


def _pair(extra=()):
    jnet = JaxMLN(_conf(jconf, extra)).init()
    tnet = MultiLayerNetwork(_conf(tconf, extra), device="cpu").init()
    tnet.params = {**{k: {} for k in tnet.params}, **params_from_jax(
        jax.tree.map(np.asarray, jnet.params), "cpu")}
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair()


def _prompt(seed=5, n=5):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(
        np.int32)


def _greedy_full(output, prompt, k):
    toks, out = [int(t) for t in prompt], []
    for _ in range(k):
        probs = np.asarray(output(np.asarray(toks, np.int32)[None, :]))
        out.append(int(np.argmax(probs[0, -1])))
        toks.append(out[-1])
    return out


def _greedy_incremental(net, prompt, k, bucket=8):
    """One prefill then k-1 single-token steps (the JAX test's driver,
    without jit)."""
    prefill, step = net.prefill_fn(), net.incremental_decode_fn()
    cache = net.init_kv_cache(1, CAP)
    L = len(prompt)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :L] = prompt
    kmask = np.zeros((1, bucket), np.float32)
    kmask[0, :L] = 1.0
    probs, cache = prefill(net.params, net.state, cache, tokens, kmask,
                           np.array([0], np.int32), np.array([0], np.int32),
                           np.array([L - 1], np.int32))
    out = [int(np.argmax(np.asarray(probs)[0]))]
    pos = L
    while len(out) < k:
        probs, cache = step(net.params, net.state, cache,
                            np.array([out[-1]], np.int32),
                            np.array([pos], np.int32))
        out.append(int(np.argmax(np.asarray(probs)[0])))
        pos += 1
    return out


def test_incremental_tokens_equal_full_forward_and_jax(nets):
    jnet, tnet = nets
    prompt = _prompt()
    port_full = _greedy_full(lambda x: tnet.output(x).numpy(), prompt, 4)
    assert _greedy_incremental(tnet, prompt, 4) == port_full
    assert port_full == _greedy_full(jnet.output, prompt, 4)
    assert _greedy_incremental(jnet, prompt, 4) == port_full


def test_prefill_and_verify_probabilities_match_jax(nets):
    """A prefill of 5 tokens into row 1 of 2, then a verify window of 3
    tokens: each step's probabilities, and the cache, as the JAX
    package's."""
    jnet, tnet = nets
    prompt = _prompt(6)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :5] = prompt
    kmask = (np.arange(8) < 5).astype(np.float32)[None]
    args = (tokens, kmask, np.array([1], np.int32), np.array([0], np.int32),
            np.array([4], np.int32))
    jcache, tcache = jnet.init_kv_cache(2, CAP), tnet.init_kv_cache(2, CAP)
    jp, jcache = jax.jit(jnet.prefill_fn())(jnet.params, jnet.state, jcache,
                                            *args)
    tp, tcache = tnet.prefill_fn()(tnet.params, tnet.state, tcache, *args)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    window = np.array([[3, 7, 1], [int(np.argmax(np.asarray(jp)[0])), 9, 2]],
                      np.int32)
    pos = np.array([CAP - 3, 5], np.int32)  # row 0: past the prompt-free row
    jv, jcache = jax.jit(jnet.verify_decode_fn())(jnet.params, jnet.state,
                                                  jcache, window, pos)
    tv, tcache = tnet.verify_decode_fn()(tnet.params, tnet.state, tcache,
                                         window, pos)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    for layer in jcache:
        for kv in ("k", "v"):
            np.testing.assert_allclose(tcache[layer][kv].numpy(),
                                       np.asarray(jcache[layer][kv]),
                                       atol=ATOL, rtol=0)


def test_stack_serves_through_generation_engine(nets):
    """GenerationEngine over the MultiLayerNetwork: each prompt's tokens
    are the greedy tokens of its full forward."""
    _, tnet = nets
    engine = GenerationEngine(tnet, BucketLattice((1,), seq_lens=(8, 16)),
                              slots=2, max_new_tokens=4, page_size=8,
                              prefill_chunk=8)
    prompts = [_prompt(7, 5), _prompt(8, 3)]
    engine.warmup()
    engine.start()
    try:
        reqs = [engine.submit_generate(p, 4) for p in prompts]
        for r in reqs:
            assert r.wait(120) and r.error is None, r.error
    finally:
        engine.drain()
    for p, r in zip(prompts, reqs):
        assert list(r.emitted) == _greedy_full(
            lambda x: tnet.output(x).numpy(), p, 4)


def test_pointwise_layers_ride_along_and_others_are_refused():
    """Activation and dropout layers decode (dropout is the identity at
    inference) with the same tokens as the full forward; a recurrent
    layer is refused at build time, named."""
    extra = (lambda c: c.ActivationLayer(activation="tanh"),
             lambda c: c.DropoutLayer(dropout=0.5))
    jnet, tnet = _pair(extra)
    prompt = _prompt(9)
    want = _greedy_full(jnet.output, prompt, 3)
    assert _greedy_incremental(tnet, prompt, 3) == want
    lstm = MultiLayerNetwork(_conf(tconf, (
        lambda c: c.LSTM(n_in=D, n_out=D),)), device="cpu").init()
    with pytest.raises(ValueError, match=r"layer_4 \(LSTM\)"):
        lstm.incremental_decode_fn()
