"""The port's speculative decoding and int8 paged KV cache against the
JAX package on the CPU: the int8 codec and cache update
(ops/decode_attention.py), the verify step (nn/decode.make_verify_fn),
the n-gram proposer and acceptance mask (serving/speculative.py), the
cache byte accounting (serving/kvcache.py) and the `GenerationEngine` in
its four arms — f32, speculative k=4, int8, int8 + speculative — on the
replay's tiny LM with the JAX net's params copied across.

Tolerances: int8 codes are integers and must be equal; scales are one
f32 division of the same maxabs (rtol 1e-6); attention outputs and lse
are f32 sums in another order (1e-5); verify probabilities against the
JAX step 1e-5, and against the port's own sequential decode steps 1e-6
(the same f32 math at other matrix shapes). Token streams are greedy
argmaxes and must be equal request for request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.ops import decode_attention as jda
from deeplearning4j_tpu.serving import kvcache as jkv
from deeplearning4j_tpu.serving import replay as jreplay
from deeplearning4j_tpu.serving.buckets import BucketLattice as JaxLattice
from deeplearning4j_tpu.serving.engine import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.serving.speculative import (
    NgramProposer as JaxNgramProposer,
)
from deeplearning4j_tpu.telemetry import Recorder as JaxRecorder
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.nn.decode import attention_specs
from deeplearning4j_tpu_torch.ops import decode_attention as tda
from deeplearning4j_tpu_torch.serving import kvcache as tkv
from deeplearning4j_tpu_torch.serving import replay as treplay
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import GenerationEngine
from deeplearning4j_tpu_torch.serving.speculative import (NgramProposer,
                                                          accept_greedy)
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

B, S, H, D, PS = 3, 32, 2, 8, 8


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- proposer

def test_ngram_proposer_matches_jax_cases():
    """The JAX package's proposer cases (tests/test_speculative.py), on
    both proposers."""
    for p in (NgramProposer(max_order=3), JaxNgramProposer(max_order=3)):
        assert p.propose([7, 8, 9, 5, 6, 1, 2, 3, 5, 6], 3) == [1, 2, 3]
        assert p.propose([1, 2, 3, 1, 2, 3], 5) == [1, 2, 3, 1, 2]
        assert p.propose([4, 9, 2], 3) == [2, 2, 2]
        assert p.propose([], 2) == [0, 0]
        assert p.propose([5], 0) == []
        assert p.propose([1, 2, 7, 7, 1, 2, 9, 9, 1, 2], 2) == [9, 9]
    with pytest.raises(ValueError):
        NgramProposer(max_order=0)


def test_accept_greedy_mask():
    assert accept_greedy([5, 6, 7], [5, 6, 7, 8]) == (3, [5, 6, 7, 8])
    assert accept_greedy([9, 6, 7], [5, 6, 7, 8]) == (0, [5])
    assert accept_greedy([5, 0, 7], [5, 6, 7, 8]) == (1, [5, 6])
    with pytest.raises(ValueError):
        accept_greedy([1, 2], [1, 2])


# ---------------------------------------------------- int8 paged cache

def _cache_values(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    x[:, :PS] *= 100.0   # pages of very different magnitude
    x[:, PS:2 * PS] *= 1e-3
    return x


def test_quantize_pages_matches_jax():
    x = _cache_values(0)
    jc, js = jda.quantize_pages(jnp.asarray(x), PS)
    tc, ts = tda.quantize_pages(_t(x), PS)
    assert tc.dtype == torch.int8 and ts.shape == (B, S // PS, H)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    back = tda.dequantize_pages(tc, ts, PS).numpy()
    np.testing.assert_allclose(back, np.asarray(
        jda.dequantize_pages(jc, js, PS)), rtol=1e-6, atol=0)
    # the round-trip bound: |x - dequant(quant(x))| <= scale / 2
    err = np.abs(x - back).reshape(B, S // PS, PS, H, D)
    assert np.all(err <= ts.numpy()[:, :, None, :, None] / 2 + 1e-7)


UPDATES = {
    # one prompt chunk of 12 into row 1 from position 5
    "prefill_chunk": (np.array([1]), 5 + np.arange(12)[None]),
    # a k=4 verify window per row; rows 0 and 1 run past capacity 32
    "verify_past_capacity": (np.arange(3),
                             np.array([[29], [30], [10]]) + np.arange(4)),
    # a decode step with the inactive rows on the scratch position
    "decode_scratch": (np.arange(3), np.array([[31], [31], [4]])),
    # row 2 reused: a fresh 8-token prompt from 0 over a longer tenancy,
    # whose stale values past the write head must not set the scales
    "row_reused": (np.array([2]), np.arange(8)[None]),
}


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_quantized_cache_update_matches_jax(case):
    rows, positions = UPDATES[case]
    codes, scales = tda.quantize_pages(_t(_cache_values(1)), PS)
    new = np.random.default_rng(2).normal(
        0, 3, positions.shape + (H, D)).astype(np.float32)
    jc, js = jda.quantize_pages(jnp.asarray(_cache_values(1)), PS)
    jc, js = jda.quantized_cache_update(jc, js, jnp.asarray(new),
                                        jnp.asarray(rows),
                                        jnp.asarray(positions), PS)
    tc, ts = tda.quantized_cache_update(codes.clone(), scales.clone(),
                                        _t(new), _t(rows), _t(positions), PS)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # the write landed (within the page's rounding) where it was in range
    back = tda.dequantize_pages(tc, ts, PS).numpy()
    for i, r in enumerate(rows):
        for j, p in enumerate(positions[i]):
            if p < S:
                page_scale = ts.numpy()[r, p // PS]
                assert np.all(np.abs(back[r, p] - new[i, j])
                              <= page_scale[:, None] / 2 + 1e-6)


def test_cache_attention_q8_matches_jax():
    rng = np.random.default_rng(3)
    codes_k, sk = tda.quantize_pages(_t(_cache_values(4)), PS)
    codes_v, sv = tda.quantize_pages(_t(_cache_values(5)), PS)
    q = rng.normal(size=(B, H, 4, D)).astype(np.float32)
    limit = np.array([[1, 2, 3, 4], [9, 10, 11, 12], [29, 30, 31, 32]])
    to, tl = tda.cache_attention_q8(_t(q), codes_k, codes_v, sk, sv,
                                    _t(limit), PS)
    jo, jl = jda.cache_attention_q8(
        jnp.asarray(q), jnp.asarray(codes_k.numpy()),
        jnp.asarray(codes_v.numpy()), jnp.asarray(sk.numpy()),
        jnp.asarray(sv.numpy()), jnp.asarray(limit), PS)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------- verify

VERIFY_CAP = 32


@pytest.fixture(scope="module")
def small_nets():
    """(JAX net, port net) of the replay's tiny LM width holding the
    same params."""
    jnet = jax_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                  d_ff=64, max_length=64).init()
    tnet = transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_length=64, device="cpu")
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.state = {name: {} for name in tnet.params}
    return jnet, tnet


def _prefilled(jnet, tnet, prompts):
    """Both caches after prefilling prompt i into row i (one chunk of 16
    each)."""
    jcache = jnet.init_kv_cache(len(prompts), VERIFY_CAP)
    tcache = tnet.init_kv_cache(len(prompts), VERIFY_CAP)
    jpre, tpre = jax.jit(jnet.prefill_fn()), tnet.prefill_fn()
    for row, p in enumerate(prompts):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        km = np.zeros((1, 16), np.float32)
        km[0, :len(p)] = 1
        args = (toks, km, np.array([row]), np.array([0]),
                np.array([len(p) - 1]))
        _, jcache = jpre(jnet.params, jnet.state, jcache, *args)
        _, tcache = tpre(tnet.params, tnet.state, tcache, *args)
    return jcache, tcache


@pytest.mark.parametrize("near_end", (False, True),
                         ids=("inside", "past_capacity"))
def test_verify_matches_jax_and_sequential_decode(small_nets, near_end):
    jnet, tnet = small_nets
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, n) for n in (5, 11)]
    jcache, tcache = _prefilled(jnet, tnet, prompts)
    K = 4
    pos = np.array([len(p) for p in prompts])
    if near_end:  # the last window rows fall past the capacity
        pos = np.array([VERIFY_CAP - 2, VERIFY_CAP - 1])
    window = rng.integers(0, 64, (2, K))
    jprobs, _ = jax.jit(jnet.verify_decode_fn())(
        jnet.params, jnet.state, jcache, window.astype(np.int32),
        pos.astype(np.int32))
    seq_cache = {n: {k: t.clone() for k, t in e.items()}
                 for n, e in tcache.items()}
    tprobs, _ = tnet.verify_decode_fn()(tnet.params, tnet.state, tcache,
                                        window, pos)
    assert tprobs.shape == (2, K, 64)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=1e-5)
    if near_end:
        return
    step = tnet.incremental_decode_fn()
    for i in range(K):
        probs, seq_cache = step(tnet.params, tnet.state, seq_cache,
                                window[:, i], pos + i)
        np.testing.assert_allclose(tprobs[:, i].numpy(), probs.numpy(),
                                   atol=1e-6)


def test_int8_cache_layout_matches_jax(small_nets):
    jnet, tnet = small_nets
    jc = jnet.init_kv_cache(2, 32, "int8", 8)
    tc = tnet.init_kv_cache(2, 32, "int8", 8)
    assert sorted(jc) == sorted(tc)
    for name in tc:
        assert sorted(jc[name]) == sorted(tc[name])
        for k, t in tc[name].items():
            assert tuple(t.shape) == jc[name][k].shape
            assert str(t.dtype).split(".")[-1] == str(jc[name][k].dtype)
    with pytest.raises(ValueError, match="page-quantized"):
        tnet.init_kv_cache(2, 30, "int8", 8)


# ------------------------------------------------------- byte accounting

def test_bytes_per_slot_matches_jax(small_nets):
    _, tnet = small_nets
    specs = attention_specs(tnet)
    for cap, ps in ((48, 16), (1088, 16), (32, 8)):
        for dt in ("f32", "int8"):
            assert tkv.bytes_per_slot(cap, specs, dt, ps) == \
                jkv.bytes_per_slot(cap, specs, dt, ps)
        tp, jp = (m.CachePlan(32, 16, 4, ps, kv_dtype="int8")
                  for m in (tkv, jkv))
        assert tp.bytes_per_slot(specs) == jp.bytes_per_slot(specs)
        assert tp.describe() == jp.describe()
    # the speculative replay's plan: prompts <= 32, outputs <= 16, page 16
    plan = tkv.CachePlan(32, 16, n_slots=4, page_size=16)
    ratio = (tkv.bytes_per_slot(plan.capacity, specs, "f32", 16)
             / tkv.bytes_per_slot(plan.capacity, specs, "int8", 16))
    assert round(ratio, 4) == 3.9385
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.validate_kv_dtype("int4")


# --------------------------------------------- engine against the JAX one

_PROMPT_MIX = ((3, 2), (8, 5), (11, 1), (16, 8), (5, 3),
               (1, 4), (13, 2), (16, 1), (2, 6), (7, 8))
ARMS = {"f32": (0, "f32"), "spec4": (4, "f32"), "int8": (0, "int8"),
        "int8_spec4": (4, "int8")}


def _serve_mix(eng, rec):
    """Warm up, serve the prompt mix one request at a time, and check the
    zero-retrace and page-return contracts on the way."""
    eng.warmup()
    traced = eng.trace_count
    eng.start()
    rng = np.random.default_rng(11)
    outs = []
    for plen, olen in _PROMPT_MIX:
        out = eng.generate(rng.integers(0, 64, plen).astype(np.int32), olen,
                           timeout=60)
        assert len(out) == olen
        outs.append([int(t) for t in out])
    assert eng.trace_count == traced, "a step shape escaped warmup"
    pools = [e for e in rec.events if e.get("event") == "page_pool"]
    assert pools and pools[-1]["pages_in_use"] == 0
    assert max(p["pages_in_use"] for p in pools) > 0
    stats = eng.stats()
    eng.drain()
    return outs, stats, rec


@pytest.fixture(scope="module")
def tiny_nets():
    jnet = jreplay._tiny_lm(24)
    tnet = treplay._tiny_lm(24, device="cpu")
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.state = {name: {} for name in tnet.params}
    return jnet, tnet


@pytest.fixture(scope="module")
def engine_runs(tiny_nets):
    """{arm: (port run, JAX run)}, each run (token streams, stats,
    recorder), computed on first use."""
    jnet, tnet = tiny_nets
    runs = {}

    def get(arm):
        if arm not in runs:
            k, dt = ARMS[arm]
            kw = dict(slots=2, max_new_tokens=8, page_size=8,
                      speculative_k=k, kv_dtype=dt)
            trec, jrec = Recorder(path=None), JaxRecorder(path=None)
            runs[arm] = (
                _serve_mix(GenerationEngine(
                    tnet, BucketLattice((1,), seq_lens=(8, 16)),
                    recorder=trec, **kw), trec),
                _serve_mix(JaxGenerationEngine(
                    jnet, JaxLattice((1,), seq_lens=(8, 16)),
                    recorder=jrec, **kw), jrec))
        return runs[arm]
    return get


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_streams_match_jax_engine(engine_runs, arm):
    (t_out, t_stats, trec), (j_out, j_stats, _) = engine_runs(arm)
    assert t_out == j_out
    # the stats() contract is the JAX package's shape
    assert set(t_stats) == set(j_stats)
    assert set(t_stats["fleet"][0]) == set(j_stats["fleet"][0])
    assert set(t_stats["speculative"]) == set(j_stats["speculative"])
    assert t_stats["page_pools"] == j_stats["page_pools"]
    assert t_stats["cache"] == j_stats["cache"]
    assert t_stats["trace_count"] == j_stats["trace_count"]
    k = ARMS[arm][0]
    if k:
        sp = t_stats["speculative"]
        assert sp["enabled"] and sp["k"] == k and sp["verify_steps"] > 0
        assert sp["accepted_tokens_per_step"] > 1.0
        assert sp["accepted_tokens_per_step"] == \
            j_stats["speculative"]["accepted_tokens_per_step"]
        drafts = [e for e in trec.events if e.get("event") == "draft"]
        assert drafts and all(e["k"] == k for e in drafts)
    else:
        assert t_stats["speculative"] == {"enabled": False, "k": 0}


@pytest.mark.parametrize("arm", ("spec4", "int8", "int8_spec4"))
def test_engine_arms_equal_plain_greedy(engine_runs, arm):
    assert engine_runs(arm)[0][0] == engine_runs("f32")[0][0]


def test_engine_events_carry_the_jax_fields(engine_runs):
    (_, _, trec), (_, _, jrec) = engine_runs("spec4")

    def shape(rec):
        out = {}
        for e in rec.events:
            key = (e["event"], e.get("name"))
            out.setdefault(key, set()).update(
                k for k in e if k not in ("ts", "run", "seq"))
        return out

    t, j = shape(trec), shape(jrec)
    for key in (("request", None), ("page_pool", None), ("draft", None),
                ("span", "prefill_chunk"), ("span", "verify_step"),
                ("span", "compile"), ("meta", None)):
        assert t[key] == j[key], key


def test_engine_refuses_bad_arguments(tiny_nets, tmp_path):
    _, tnet = tiny_nets
    lat = BucketLattice((1,), seq_lens=(8, 16))
    for k in (1, -1):
        with pytest.raises(ValueError, match="speculative_k"):
            GenerationEngine(tnet, lat, max_new_tokens=8, speculative_k=k)
    with pytest.raises(ValueError, match="exceeds max_new_tokens"):
        GenerationEngine(tnet, lat, max_new_tokens=4, speculative_k=6)
    with pytest.raises(ValueError, match="kv_dtype"):
        GenerationEngine(tnet, lat, kv_dtype="int4")
    # the fleet hooks: a chaos spec serving cannot run is refused; a
    # checkpoint directory with no committed step is a cold start
    for spec in ("r0:explode@decode3", "p1:kill@step3"):
        with pytest.raises(ValueError, match="fault spec"):
            GenerationEngine(tnet, lat, faults=spec)
    assert GenerationEngine(tnet, lat, checkpoint=str(tmp_path),
                            faults="r0:kill@decode3").restored_step == 0
