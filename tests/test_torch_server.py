"""The port's HTTP `ServingServer` (deeplearning4j_tpu_torch/serving/
server.py), its /metrics surface and the generation traffic replays
(serving/replay.py) on the CPU, against the JAX package's names and
scoreboard.

* Streaming /generate gives the tokens `generate` gives; a too-long
  prompt is a 400, a draining server a 503 with Retry-After, /predict a
  404 naming the engine it needs.
* /metrics registers the JAX package's metric families: the JAX
  `ServingMetrics`, run over the same port engine, renders the same
  family and series names.
* `run_speculative_replay(n_requests=6, repeats=1)` serves its three arms
  with zero parity mismatches and emits the JAX package's metric names;
  the port's and the JAX package's `reconstruct_generation` read its
  telemetry into the same scoreboard.
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.serving import replay as jreplay
from deeplearning4j_tpu.serving.server import ServingMetrics as JaxMetrics
from deeplearning4j_tpu_torch.serving import replay as treplay
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import GenerationEngine
from deeplearning4j_tpu_torch.serving.server import ServingServer
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition

pytestmark = pytest.mark.port


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _engine(**kw):
    net = treplay._tiny_lm(24, device="cpu")
    rec = Recorder(path=None)
    eng = GenerationEngine(net, BucketLattice((1,), seq_lens=(8, 16)),
                           slots=2, max_new_tokens=8, page_size=8,
                           recorder=rec, **kw)
    eng.warmup()
    return eng, rec


@pytest.fixture(scope="module")
def served():
    eng, rec = _engine(speculative_k=4, kv_dtype="int8")
    server = ServingServer(eng, port=0).start()
    yield server, eng, rec
    server.stop()


def test_streamed_tokens_equal_generate(served):
    server, eng, _ = served
    prompt = np.random.default_rng(4).integers(0, 64, 11)
    with _post(f"{server.url}/generate",
               {"tokens": prompt.tolist(), "max_new_tokens": 7,
                "id": "s1"}) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(l) for l in resp.read().splitlines() if l]
    *tokens, summary = lines
    assert [t["i"] for t in tokens] == list(range(7))
    assert summary["done"] and summary["id"] == "s1"
    assert summary["tokens"] == [t["token"] for t in tokens]
    assert summary["timing"]["ttft_s"] > 0
    assert summary["tokens"] == eng.generate(prompt, 7)


def test_client_errors_and_unported_routes(served):
    server, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{server.url}/generate", {"tokens": list(range(17))})
    assert err.value.code == 400
    assert "exceeds lattice max" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{server.url}/generate", {"prompt": [1, 2]})
    assert err.value.code == 400
    for route, engine_name in (("/predict", "InferenceEngine"),
                               ("/embed", "EmbeddingServingEngine"),
                               ("/search", "EmbeddingServingEngine")):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{server.url}{route}", {"features": [1.0]})
        assert err.value.code == 404
        assert engine_name in json.loads(err.value.read())["error"]
    with urllib.request.urlopen(f"{server.url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "serving" and health["generate"]
    assert health["speculative"]["k"] == 4
    assert health["cache"]["kv_dtype"] == "int8"


def _families(text):
    """(registered families from # TYPE lines, series names without
    labels) of an exposition."""
    types = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    series = {re.sub(r"\{.*\}$", "", k) for k in parse_exposition(text)}
    return types, series


def test_metrics_hold_the_jax_families(served):
    server, eng, _ = served
    eng.generate([1, 2, 3], 4)  # a request on the record
    with urllib.request.urlopen(f"{server.url}/metrics", timeout=30) as r:
        text = r.read().decode()
    types, series = _families(text)
    jax_types, jax_series = _families(JaxMetrics(eng).render())
    assert types == jax_types
    # the live histograms the JAX registry fed no event show as empty
    # series there; every series it renders, the port renders
    assert jax_series <= series
    for name in ("serving_requests_total", "serving_ttft_seconds_count",
                 "serving_page_pool_pages",
                 "serving_speculative_accepted_tokens_per_step",
                 "serving_trace_count", "serving_replica_up"):
        assert name in series, name


def test_drain_refuses_with_retry_after():
    eng, _ = _engine()
    server = ServingServer(eng, port=0).start()
    try:
        with _post(f"{server.url}/drain", {}) as resp:
            assert json.loads(resp.read())["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{server.url}/generate", {"tokens": [1, 2, 3]})
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "5"
    finally:
        server.stop()


@pytest.fixture(scope="module")
def spec_replay(tmp_path_factory):
    path = tmp_path_factory.mktemp("replay") / "tel.jsonl"
    return treplay.run_speculative_replay(
        n_requests=6, repeats=1, telemetry_path=str(path), device="cpu")


def test_speculative_replay_parity_and_names(spec_replay):
    rows = {line["metric"]: line for line in spec_replay["lines"]}
    assert rows["serving_speculative_parity_mismatches"]["value"] == 0
    assert rows["serving_quantized_parity_mismatches"]["value"] == 0
    assert rows["serving_quantized_slots_per_hbm_byte_x"]["value"] == 3.9385
    assert rows["serving_sample_us"]["value"] > 0
    assert rows["serving_speculative_accepted_tokens_per_step"]["value"] \
        > 1.0
    for arm in ("baseline", "speculative", "quantized"):
        sb = spec_replay["arms"][arm]
        assert sb["n_ok"] == 6 and sb["n_failed"] == 0
        assert sb["recompiles_after_warmup"] == 0
    # the JAX package's metric names: its `generation_metric_lines` over
    # the same scoreboards, plus the four rows run_speculative_replay
    # appends
    want = [line["metric"]
            for arm, prefix in (("baseline", "serving_generate"),
                                ("speculative", "serving_speculative"),
                                ("quantized", "serving_quantized"))
            for line in jreplay.generation_metric_lines(
                spec_replay["arms"][arm], prefix=prefix)]
    want += ["serving_quantized_slots_per_hbm_byte_x", "serving_sample_us",
             "serving_speculative_parity_mismatches",
             "serving_quantized_parity_mismatches"]
    assert [line["metric"] for line in spec_replay["lines"]] == want


@pytest.mark.parametrize("arm", ("baseline", "speculative", "quantized"))
def test_reconstruct_matches_jax(spec_replay, arm):
    path = spec_replay["arms"][arm]["telemetry"]
    assert treplay.reconstruct_generation(path) == \
        jreplay.reconstruct_generation(path)


def test_generation_replay_over_two_replicas(tmp_path):
    sb = treplay.run_generation_replay(
        n_requests=8, replicas=2, telemetry_path=str(tmp_path / "t.jsonl"),
        artifact_path=str(tmp_path / "serve.json"), device="cpu")
    assert sb["n_ok"] == 8 and sb["n_failed"] == 0
    assert sb["client"]["failed"] == 0
    assert sb["recompiles_after_warmup"] == 0
    # warmup ran every prefill bucket and the decode step on each replica
    assert sb["warmed_shapes"] == 2 * (3 + 1)
    summary = json.loads(open(tmp_path / "serve.json").read()
                         .splitlines()[-1])
    assert summary["metric"] == "summary"
