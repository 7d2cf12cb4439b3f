"""The port's embedding serving (deeplearning4j_tpu_torch/embedding/
serving.py, `/embed` and `/search` in serving/server.py) against the
JAX package's on the CPU, one snapshot served by both packages' servers.

The JAX serving engine over a snapshot array runs under jit without a
mesh, so it anchors these tests directly (the JAX package's engine-
backed mode needs its `shard_map` shim, which fails under some jax
versions). The port serves the JAX engine's index, carried across with
`weights_io.ann_index_from_jax`, at the JAX engine's calibrated nprobe.
Tolerances: ids, rows and HTTP codes exact; scores 1e-6 (cosines).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.embedding.serving import (
    EmbeddingServingEngine as JaxServing,
)
from deeplearning4j_tpu.serving.buckets import BucketLattice as JaxLattice
from deeplearning4j_tpu.serving.server import ServingServer as JaxServer
from deeplearning4j_tpu.telemetry import Recorder as JaxRecorder
from deeplearning4j_tpu_torch.embedding.engine import (
    EngineLookupView,
    ShardedEmbeddingEngine,
)
from deeplearning4j_tpu_torch.embedding.serving import EmbeddingServingEngine
from deeplearning4j_tpu_torch.serving import BucketLattice
from deeplearning4j_tpu_torch.serving.fleet import FleetSupervisor
from deeplearning4j_tpu_torch.serving.server import ServingServer
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition
from deeplearning4j_tpu_torch.weights_io import ann_index_from_jax

pytestmark = pytest.mark.port


def _clustered(rng, v=256, d=16, nc=16):
    centers = rng.normal(size=(nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, v)]
            + 0.1 * rng.normal(size=(v, d))).astype(np.float32)


def _post(url, route, payload):
    req = urllib.request.Request(
        f"{url}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _code(url, route, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, route, payload)
    return e.value.code


@pytest.fixture(scope="module")
def stacks():
    vecs = _clustered(np.random.default_rng(9))
    kw = dict(k_grid=(5,), recall_floor=0.9, calibration_queries=16, seed=0)
    jeng = JaxServing(vecs, n_partitions=16,
                      lattice=JaxLattice(batch_sizes=(1, 4, 8)),
                      recorder=JaxRecorder(), **kw).start()
    rec = Recorder()
    teng = EmbeddingServingEngine(
        vecs, index=ann_index_from_jax(jeng.index, "cpu", recorder=rec),
        lattice=BucketLattice(batch_sizes=(1, 4, 8)), recorder=rec,
        device="cpu", **kw).start()
    jserver = JaxServer(jeng, port=0).start()
    tserver = ServingServer(teng, port=0).start()
    yield vecs, jeng, teng, jserver, tserver
    for s in (tserver, jserver):
        s.stop()


def test_calibration_matches_jax(stacks):
    _, jeng, teng, _, _ = stacks
    assert (teng.nprobe, teng.calibrated_recall) == (
        jeng.nprobe, jeng.calibrated_recall)
    assert teng.calibrated_recall >= 0.9


def test_embed_route_matches_jax(stacks):
    vecs, _, _, jserver, tserver = stacks
    ids = [3, 7, 200]
    got = _post(tserver.url, "/embed", {"ids": ids, "id": "e1"})
    want = _post(jserver.url, "/embed", {"ids": ids, "id": "e1"})
    assert got["id"] == want["id"] == "e1"
    assert set(got) == set(want) and got["timing"]["total_s"] >= 0
    np.testing.assert_array_equal(np.float32(got["vectors"]), vecs[ids])
    np.testing.assert_array_equal(got["vectors"], want["vectors"])


@pytest.mark.parametrize("n", [1, 3, 8])
def test_search_route_matches_jax(stacks, n):
    """n random queries (padded to the lattice) through both servers:
    the same ids, scores within 1e-6; a corpus row finds itself."""
    vecs, _, _, jserver, tserver = stacks
    q = np.random.default_rng(n).normal(size=(n, 16)).tolist()
    got = _post(tserver.url, "/search", {"vectors": q, "k": 5})
    want = _post(jserver.url, "/search", {"vectors": q, "k": 5})
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-6)
    self_hit = _post(tserver.url, "/search", {"vector": vecs[42].tolist()})
    assert self_hit["ids"][0][0] == 42 and len(self_hit["ids"][0]) == 5


def test_error_envelope_matches_jax(stacks):
    """400 on a foreign k, an out-of-range id, a batch over the lattice
    max and a missing field, in both packages."""
    vecs, _, _, jserver, tserver = stacks
    bad = (("/search", {"vector": vecs[0].tolist(), "k": 7}),
           ("/embed", {"ids": [999999]}),
           ("/embed", {"ids": list(range(64))}),
           ("/search", {"k": 5}),
           ("/embed", {}))
    for route, payload in bad:
        assert _code(tserver.url, route, payload) == _code(
            jserver.url, route, payload) == 400


def test_zero_retrace_after_warmup_and_stats(stacks):
    _, _, teng, _, tserver = stacks
    tc = teng.trace_count
    rng = np.random.default_rng(10)
    for n in (1, 3, 4, 8, 2):
        _post(tserver.url, "/search",
              {"vectors": rng.normal(size=(n, 16)).tolist()})
        _post(tserver.url, "/embed", {"ids": rng.integers(0, 256, n).tolist()})
    assert teng.trace_count == tc
    stats = teng.stats()
    assert stats["trace_count"] == tc and stats["failed"] == 0
    assert stats["served"] >= 10 and stats["ann"]["nprobe"] >= 1


def test_metrics_export_embedding_spans(stacks):
    _, _, _, _, tserver = stacks
    _post(tserver.url, "/embed", {"ids": [1]})
    _post(tserver.url, "/search", {"vector": [0.5] * 16})
    with urllib.request.urlopen(f"{tserver.url}/metrics", timeout=10) as r:
        parsed = parse_exposition(r.read().decode())
    assert parsed["serving_embedding_gather_seconds_count"] >= 1
    assert parsed["serving_embedding_ann_probe_seconds_count"] >= 1
    assert parsed['serving_embedding_bytes_total{span="gather"}'] > 0
    assert parsed['serving_embedding_bytes_total{span="ann_probe"}'] > 0


def test_fleet_supervisor_reaps_and_respawns(stacks):
    _, _, teng, _, _ = stacks
    sup = FleetSupervisor(teng)
    sup.poll()
    snap = teng.fleet_snapshot()
    assert snap["n_replicas"] == 1 and snap["n_serving"] == 1
    (w,) = teng.fleet_workers()
    row = w.describe(time.monotonic())
    assert row["state"] == "serving" and row["alive"]
    assert teng.fleet_reap(w, "test") == 0 and w.lifecycle == "dead"
    teng.fleet_respawn(w)
    req = teng.submit_embed([2])
    assert req.wait(10) and req.error is None


def test_engine_backed_serving_and_drain():
    """Serving a port engine through its lookup view: /embed reads the
    engine's live table; after drain the engine refuses requests and the
    server answers 503."""
    rng = np.random.default_rng(11)
    eng = ShardedEmbeddingEngine(128, 16, seed=3, device="cpu")
    vecs = _clustered(rng, v=128)
    view = EngineLookupView(eng)
    view.set_vectors(vecs)
    serve = EmbeddingServingEngine(
        view, n_partitions=8, lattice=BucketLattice(batch_sizes=(1, 4)),
        k_grid=(3,), nprobe=8, seed=0)
    assert serve.device == torch.device("cpu")
    server = ServingServer(serve).start()
    try:
        got = _post(server.url, "/embed", {"ids": [0, 5, 127]})
        np.testing.assert_array_equal(np.float32(got["vectors"]),
                                      vecs[[0, 5, 127]])
        hit = _post(server.url, "/search", {"vector": vecs[9].tolist()})
        assert hit["ids"][0][0] == 9
        assert serve.stats()["memory"]["table_bytes_per_device"] == \
            3 * 128 * 16 * 4
        server.begin_drain()
        assert _code(server.url, "/embed", {"ids": [0]}) == 503
    finally:
        server.stop()
    with pytest.raises(RuntimeError, match="draining"):
        serve.submit_embed([0])


def test_embed_bench_smoke_mirror():
    """The JAX package's embed bench smoke (`bench._embed_run` at toy
    sizes; its engine needs the `shard_map` shim) on the port at ep = 1:
    the engine trained through the prefetched pair feed, a clustered
    snapshot published into it and served. /embed rows exact, recall@10
    at the floor, no new shape after warmup, and the calibration and
    search ids equal to the JAX snapshot engine's on the same table."""
    from deeplearning4j_tpu_torch.embedding.ann import (
        brute_force_topk,
        recall_at_k,
    )
    from deeplearning4j_tpu_torch.embedding.corpus import (
        prefetched,
        sequence_pair_batches,
        with_negatives,
    )

    v, d, batch, steps, q, k = 2048, 32, 256, 3, 16, 10
    rng = np.random.default_rng(0)
    eng = ShardedEmbeddingEngine(v, d, negative=5, seed=3, device="cpu")
    pairs_per_seq = 2 * 5 * 25 - 5 * 6
    seqs = [rng.integers(0, v, size=25)
            for _ in range((steps + 2) * batch // pairs_per_seq + 3)]
    feed = prefetched(with_negatives(
        sequence_pair_batches(seqs, batch_size=batch, window=5, seed=6),
        np.arange(1, v + 1, dtype=np.float64) / v, 5, seed=8), depth=4)
    try:
        for _ in range(steps + 1):
            eng.sgns_step(*next(feed), 0.025)
    finally:
        feed.close()
    assert np.isfinite([float(x) for x in eng.loss_history]).all()
    centers = rng.normal(size=(64, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 64, v)]
            + 0.15 * rng.normal(size=(v, d))).astype(np.float32)
    view = EngineLookupView(eng)
    view.set_vectors(vecs)
    kw = dict(n_partitions=64, k_grid=(k,), recall_floor=0.95,
              calibration_queries=q, seed=1)
    serve = EmbeddingServingEngine(
        view, lattice=BucketLattice(batch_sizes=(1, 4, 16)),
        recorder=Recorder(), **kw).start()
    jserve = JaxServing(vecs, lattice=JaxLattice(batch_sizes=(1, 4, 16)),
                        recorder=JaxRecorder(), **kw).start()
    try:
        tc = serve.trace_count
        ids = rng.choice(v, size=16, replace=False)
        req = serve.submit_embed(ids)
        assert req.wait(30) and req.error is None
        np.testing.assert_array_equal(req.result["vectors"], vecs[ids])
        queries = vecs[np.random.default_rng(17).choice(v, q, replace=False)]
        for _ in range(3):
            req = serve.submit_search(queries, k)
            assert req.wait(30) and req.error is None
        jreq = jserve.submit_search(queries, k)
        assert jreq.wait(30) and jreq.error is None
        exact, _ = brute_force_topk(vecs, queries, k, device="cpu")
        assert recall_at_k(req.result["ids"], exact.numpy()) >= 0.95
        assert serve.trace_count == tc
        assert (serve.nprobe, serve.calibrated_recall) == (
            jserve.nprobe, jserve.calibrated_recall)
        np.testing.assert_array_equal(req.result["ids"], jreq.result["ids"])
    finally:
        serve.drain(10.0)
        jserve.drain(10.0)
