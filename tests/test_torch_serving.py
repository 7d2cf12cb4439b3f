"""The port's GenerationEngine (deeplearning4j_tpu_torch/serving) on the
CPU: it emits exactly the JAX package's greedy tokens for the same
prompts and params, it agrees with argmax over its own full forwards,
and page-pool exhaustion queues requests instead of crashing.

One small `transformer_lm` (d_model 128, one head of 128, 2 layers,
vocab 64) whose params are copied across with `params_from_jax`. The
lattice (16, 512) with a 512 prefill chunk sends the 300-token prompt
through the flash route of chunked prefill (the JAX package's Pallas
kernel in interpret mode, the port's plain version of its CUDA kernel)
and the short prompts through the dense route. Greedy tokens must be
identical: both sides compute in float32.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.serving.buckets import BucketLattice as JaxLattice
from deeplearning4j_tpu.serving import kvcache as jkv
from deeplearning4j_tpu.serving.engine import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.telemetry import Recorder
from deeplearning4j_tpu_torch.serving import kvcache as tkv
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.serving import (
    BucketLattice,
    GenerationEngine,
    QueueFullError,
)
from deeplearning4j_tpu_torch.telemetry import Recorder as PortRecorder
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

CFG = dict(vocab_size=64, d_model=128, n_heads=1, n_layers=2, d_ff=256,
           max_length=1024)
SEQ_LENS = (16, 512)
PROMPT_LENS = (5, 13, 300)
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net) holding the same params."""
    jnet = jax_lm(**CFG).init()
    tnet = transformer_lm(**CFG, device="cpu")
    tnet.params = params_from_jax(
        jax.tree.map(np.asarray, jnet.params), "cpu")
    tnet.state = {name: {} for name in tnet.params}
    return jnet, tnet


def _prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(0, CFG["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts):
    """Warm up, submit every prompt at once (so prefill chunks interleave
    with the running decode batch), and return each request's tokens."""
    engine.warmup()
    engine.start()
    reqs = [engine.submit_generate(p, NEW_TOKENS) for p in prompts]
    for r in reqs:
        assert r.wait(300), f"request {r.request_id} timed out"
        assert r.error is None, r.error
    engine.drain()
    return [list(r.emitted) for r in reqs]


@pytest.fixture(scope="module")
def port_tokens(nets):
    _, tnet = nets
    rec = PortRecorder(path=None)
    engine = GenerationEngine(tnet, BucketLattice((1,), seq_lens=SEQ_LENS),
                              slots=2, max_new_tokens=8, page_size=16,
                              prefill_chunk=512, recorder=rec)
    return _serve(engine, _prompts()), engine.stats(), rec


def test_engine_tokens_match_jax_engine(nets, port_tokens):
    jnet, _ = nets
    engine = JaxGenerationEngine(
        jnet, JaxLattice((1,), seq_lens=SEQ_LENS), slots=2,
        max_new_tokens=8, page_size=16, prefill_chunk=512,
        recorder=Recorder(path=None))
    assert port_tokens[0] == _serve(engine, _prompts())


def test_engine_tokens_match_full_forward_argmax(nets, port_tokens):
    """The serving contract of tests/test_generation.py held by the port:
    each generated token is the argmax of the full forward over the
    prompt plus the tokens before it."""
    _, tnet = nets
    for prompt, emitted in zip(_prompts(), port_tokens[0]):
        seq = list(prompt)
        for tok in emitted:
            probs = tnet.output(np.asarray(seq)[None])
            assert int(probs[0, -1].argmax()) == tok
            seq.append(tok)


def test_engine_stats_account_every_token(port_tokens):
    _, stats, rec = port_tokens
    assert stats["served"] == len(PROMPT_LENS) and stats["failed"] == 0
    assert stats["tokens_out"] == len(PROMPT_LENS) * NEW_TOKENS
    # the 300-token prompt is one 512 chunk, the short ones one 16 chunk
    chunks = [e for e in rec.events if e.get("event") == "span"
              and e.get("name") == "prefill_chunk"]
    assert len(chunks) == len(PROMPT_LENS)
    assert sorted(e["bucket"][1] for e in chunks) == [16, 16, 512]
    (pool,) = stats["page_pools"]
    assert pool["pages_in_use"] == 0 and pool["pages_peak"] > 0
    assert stats["fleet"][0]["decode_steps_run"] > 0


def test_page_accounting_matches_jax():
    """Page math, cache geometry and the pool's reserve/release/peak
    bookkeeping give the JAX package's answers on the same inputs."""
    for n in (0, 1, 16, 17, 100):
        assert tkv.pages_for(n, 16) == jkv.pages_for(n, 16)
        assert tkv.quantize(n, 16) == jkv.quantize(n, 16)
    for args in ((32, 16, 4, 16), (1024, 64, 4, 16), (16, 8, 1, 8, 1)):
        tp, jp = tkv.CachePlan(*args), jkv.CachePlan(*args)
        assert (tp.capacity, tp.pages_per_slot, tp.pool_pages) == (
            jp.capacity, jp.pages_per_slot, jp.pool_pages)
        assert tp.request_pages(8, 4) == jp.request_pages(8, 4)
    pools = (tkv.PagePool(4, page_size=8), jkv.PagePool(4, page_size=8))
    for p in pools:
        assert [p.try_reserve(3), p.try_reserve(2), p.try_reserve(1)] == [
            True, False, True]
        assert p.occupancy == 1.0 and p.peak_occupancy == 1.0
        p.release(3)
        assert p.in_use == 1 and p.peak_in_use == 4
        with pytest.raises(ValueError, match="double release"):
            p.release(2)
    assert pools[0].describe() == {k: pools[1].describe()[k]
                                   for k in pools[0].describe()}


def test_pool_exhaustion_queues_never_crashes(nets):
    """A saturated page pool queues admissions; a full queue is a
    graceful QueueFullError; every accepted request completes once the
    pool frees; a request that can never fit is refused outright."""
    _, tnet = nets
    lat = BucketLattice((1,), seq_lens=(16,))
    engine = GenerationEngine(tnet, lat, slots=1, max_new_tokens=8,
                              page_size=8, max_queue=2)
    engine.warmup()
    prompts = [p[:5] for p in _prompts()] * 2
    accepted, refused = [], 0
    for p in prompts:  # not started: the queue can only grow
        try:
            accepted.append(engine.submit_generate(p, 4))
        except QueueFullError:
            refused += 1
    assert len(accepted) == 2 and refused == 4
    engine.start()
    for req in accepted:
        assert req.wait(60), "accepted request starved after exhaustion"
        assert req.error is None and len(req.emitted) == 4
    engine.drain()
    big = GenerationEngine(tnet, lat, slots=1, max_new_tokens=8,
                           page_size=8, pool_pages=1)
    with pytest.raises(ValueError, match="exceed the cache geometry"):
        big.submit_generate(prompts[0], 8)


def test_tight_pool_serializes_requests(nets):
    """Two slots but pages for one request: the second waits in the
    queue until the first releases its pages, then completes; the pool
    never holds more than its budget."""
    _, tnet = nets
    lat = BucketLattice((1,), seq_lens=(16,))
    engine = GenerationEngine(tnet, lat, slots=2, max_new_tokens=8,
                              page_size=8, pool_pages=3)
    engine.warmup()
    engine.start()
    reqs = [engine.submit_generate(p[:5], 8) for p in _prompts()[:2]]
    for r in reqs:
        assert r.wait(60) and r.error is None and len(r.emitted) == 8
    engine.drain()
    (pool,) = engine.stats()["page_pools"]
    assert pool["pages_peak"] == 3 and pool["pages_in_use"] == 0
    # the second request was admitted only after the first finished
    assert reqs[1].t_admitted >= reqs[0].t_done
