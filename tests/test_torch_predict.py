"""The port's predict path (deeplearning4j_tpu_torch/serving: the
dynamic batcher, `InferenceEngine`, POST /predict and the predict
traffic replay) on the CPU, against the JAX package.

* The batcher's decisions and arrays: `plan_batch` over a table of FIFO
  states and `assemble`'s padded features and masks equal the JAX
  package's exactly; so do `make_trace` for seeds 0-3, and `reconstruct`
  / `metric_lines` read one telemetry file into the same scoreboard.
* Outputs, params copied with `params_from_jax`, against the JAX
  `InferenceEngine` on the same requests: the tiny LM (vocab 64, d 32, 2
  heads, 2 layers, d_ff 64, f32) within 1e-5; the tiny MLP within 1e-6;
  a 2-layer LM at head dim 128 in a (4, 512) bucket — the packed flash
  route, whose plain version runs here, with one all-masked padding row
  — within 2e-5.
* Behaviour: padding rows and a padded tail change no real row (atol
  0), zero new first sights across mixed lengths, a worker dying
  mid-batch fails only that batch, and /predict's round trip, 400, 503
  with Retry-After and /healthz rows.

Every threaded wait has a deadline.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.serving import batcher as jbatcher
from deeplearning4j_tpu.serving import replay as jreplay
from deeplearning4j_tpu.serving.buckets import BucketLattice as JaxLattice
from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu.telemetry import Recorder as JaxRecorder
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.serving import batcher as tbatcher
from deeplearning4j_tpu_torch.serving import replay
from deeplearning4j_tpu_torch.serving.batcher import (Batcher, assemble,
                                                      plan_batch)
from deeplearning4j_tpu_torch.serving.buckets import Bucket, BucketLattice
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.server import ServingServer
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

DEADLINE_S = 60.0
TINY_LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def _copy_params(jnet, tnet):
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    if hasattr(tnet, "layer_vertices"):  # the transformer graph: no state
        tnet.state = {name: {} for name in tnet.params}
    return tnet


def _mlp_pair():
    jnet = jreplay._tiny_mlp()
    return jnet, _copy_params(jnet, replay._tiny_mlp(device="cpu"))


def _lm_pair(max_seq=16, **cfg):
    cfg = dict(TINY_LM, **cfg)
    jnet = jax_lm(**cfg, max_length=max_seq).init()
    tnet = transformer_lm(**cfg, max_length=max_seq, device="cpu")
    return jnet, _copy_params(jnet, tnet)


def _reqs(mod, shapes_times, dtype=np.float32, masks=None):
    out = []
    for i, (shape, t) in enumerate(shapes_times):
        feats = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
        mask = None if masks is None else masks[i]
        out.append(mod.PendingRequest(features=feats, mask=mask,
                                      t_enqueue=t))
    return out


# ------------------------------------------------------------- lattice

def test_bucket_selection_matches_jax():
    lat = BucketLattice(batch_sizes=(1, 2, 4, 8), seq_lens=(8, 16, 32))
    jlat = JaxLattice(batch_sizes=(1, 2, 4, 8), seq_lens=(8, 16, 32))
    for n in range(1, 9):
        for t in (1, 8, 9, 16, 17, 32):
            assert lat.select(n, t).key() == jlat.select(n, t).key()
    assert lat.select(3, 11) == Bucket(4, 16)
    assert [b.key() for b in lat.shapes()] == \
        [b.key() for b in jlat.shapes()]
    fixed = BucketLattice(batch_sizes=(1, 2))
    assert [b.key() for b in fixed.shapes()] == [(1, None), (2, None)]


def test_lattice_rejects_out_of_envelope():
    lat = BucketLattice(batch_sizes=(1, 2), seq_lens=(8,))
    with pytest.raises(ValueError, match="exceeds lattice max"):
        lat.seq_bucket(9)
    with pytest.raises(ValueError, match="exceeds lattice max"):
        lat.batch_bucket(3)
    with pytest.raises(ValueError, match="no seq dimension"):
        BucketLattice(batch_sizes=(1, 2)).seq_bucket(4)


# ---------------------------------------------- batcher (fake clock)

# (FIFO [(feature shape, enqueue time)], now, max_wait_s, closed,
# sequence, the cut the JAX planner makes)
PLANS = {
    "waits_under_deadline": ([((3,), 0.0)], 0.001, 0.005, False, False, 0),
    "deadline_not_yet": ([((3,), 0.0), ((3,), 0.004)], 0.0049, 0.005,
                         False, False, 0),
    "cuts_on_deadline": ([((3,), 0.0), ((3,), 0.004)], 0.005, 0.005,
                         False, False, 2),
    "full_bucket_never_waits": ([((3,), 0.0)] * 6, 0.0, 0.005, False,
                                False, 4),
    "drain_flushes": ([((3,), 0.0)], 0.0, 10.0, True, False, 1),
    "incompatible_ends_group": ([((3,), 0.0), ((5,), 0.0), ((3,), 0.0)],
                                1.0, 0.005, False, False, 1),
    "sequence_lengths_share": ([((5, 2), 0.0), ((11, 2), 0.0),
                                ((7, 3), 0.0)], 1.0, 0.005, False, True, 2),
    "empty": ([], 1.0, 0.005, True, False, 0),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_batch_matches_jax(name):
    """Exact: the port's cut decision equals the JAX planner's on the
    same FIFO, clock and lattice."""
    fifo, now, wait, closed, seq, expect = PLANS[name]
    lat = BucketLattice(batch_sizes=(1, 2, 4))
    jlat = JaxLattice(batch_sizes=(1, 2, 4))
    got = plan_batch(_reqs(tbatcher, fifo), now, wait, lat, sequence=seq,
                     closed=closed)
    ref = jbatcher.plan_batch(_reqs(jbatcher, fifo), now, wait, jlat,
                              sequence=seq, closed=closed)
    assert got == ref == expect


def test_batcher_live_coalescing_without_sleeps():
    """The threaded Batcher on a manual clock: deadline expiry is
    simulated by advancing the clock, not by sleeping."""
    now = {"t": 0.0}
    b = Batcher(BucketLattice(batch_sizes=(1, 2, 4)), max_wait_ms=5.0,
                clock=lambda: now["t"])
    b.submit(np.zeros(3, np.float32))
    b.submit(np.ones(3, np.float32))
    assert b.next_batch(timeout=0.0) is None  # deadline not reached
    now["t"] = 0.006
    batch = b.next_batch(timeout=0.5)
    assert batch is not None and batch.n_real == 2
    assert batch.bucket == Bucket(2, None)
    b.close()
    assert b.next_batch(timeout=0.0) is None
    with pytest.raises(RuntimeError, match="draining"):
        b.submit(np.zeros(3, np.float32))


ASSEMBLIES = {
    "sequence_int": (True, [((5,), 0.0), ((11,), 0.0)], np.int64, None),
    "sequence_masked": (True, [((5,), 0.0), ((3,), 0.0), ((16,), 0.0)],
                        np.int64,
                        [np.array([1, 1, 0, 1, 1], np.float32), None,
                         np.ones(16, np.float32)]),
    "sequence_features": (True, [((4, 3), 0.0), ((9, 3), 0.0)],
                          np.float32, None),
    "fixed": (False, [((8,), 0.0), ((8,), 0.0), ((8,), 0.0)], np.float32,
              None),
}


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_assemble_matches_jax(name):
    """Exact: bucket, zero-padded features and the [B, T] f32 mask
    (padding rows all zero) equal the JAX package's."""
    seq, group, dtype, masks = ASSEMBLIES[name]
    lat = BucketLattice(batch_sizes=(1, 2, 4), seq_lens=(8, 16))
    jlat = JaxLattice(batch_sizes=(1, 2, 4), seq_lens=(8, 16))
    if not seq:
        lat = BucketLattice(batch_sizes=(1, 2, 4))
        jlat = JaxLattice(batch_sizes=(1, 2, 4))
    got = assemble(_reqs(tbatcher, group, dtype, masks), lat, sequence=seq)
    ref = jbatcher.assemble(_reqs(jbatcher, group, dtype, masks), jlat,
                            sequence=seq)
    assert got.bucket.key() == ref.bucket.key()
    np.testing.assert_array_equal(got.features, ref.features)
    assert got.features.dtype == ref.features.dtype
    if seq:
        np.testing.assert_array_equal(got.mask, ref.mask)
        assert got.mask.dtype == np.float32
        assert not got.mask[len(group):].any()  # padding rows all zero
    else:
        assert got.mask is None and ref.mask is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_trace_matches_jax(seed):
    kw = dict(burst=4, mean_gap_s=0.004, lengths=(100, 128, 400, 512))
    assert replay.make_trace(seed, 48, **kw) == \
        jreplay.make_trace(seed, 48, **kw)
    trace = replay.make_trace(seed, 40, burst=4, lengths=(8, 16, 32))
    offsets = [t for t, _ in trace]
    assert offsets == sorted(offsets)
    assert offsets[0] == offsets[1] == offsets[2] == offsets[3]
    assert replay.trace_stats(trace) == jreplay.trace_stats(trace)


def test_reconstruct_and_metric_lines_match_jax(tmp_path):
    """The scoreboard math on a synthesized JSONL with known latencies,
    and the JAX package's reconstruct on the same file."""
    path = str(tmp_path / "t.jsonl")
    lat_ms = [10.0, 20.0, 30.0, 40.0, 1000.0]
    with open(path, "w") as fh:
        for i, ms in enumerate(lat_ms):
            fh.write(json.dumps({
                "event": "request", "id": f"r{i}", "ok": True,
                "ts": 100.0 + i, "total_s": ms / 1000.0}) + "\n")
        fh.write(json.dumps({"event": "request", "id": "bad",
                             "ok": False, "ts": 105.0,
                             "total_s": 0.5}) + "\n")
        fh.write("not json\n")
        fh.write(json.dumps({"event": "span", "name": "compile",
                             "warmup": True, "seconds": 1.0}) + "\n")
        fh.write(json.dumps({"event": "span", "name": "compile",
                             "seconds": 1.0}) + "\n")
    sb = replay.reconstruct(path)
    assert sb == jreplay.reconstruct(path)
    assert sb["n_requests"] == 6 and sb["n_ok"] == 5 and sb["n_failed"] == 1
    assert sb["p50_ms"] == 30.0 and sb["p99_ms"] == 1000.0
    assert sb["recompiles_after_warmup"] == 1
    assert replay.metric_lines(sb) == jreplay.metric_lines(sb)


# ------------------------------------------------- padding correctness

def test_padded_rows_do_not_change_real_rows_atol0_mlp():
    """With the same bucket shape, garbage in the padding rows leaves the
    real rows' outputs bit-identical (inference is row-independent)."""
    _, net = _mlp_pair()
    fwd = net.inference_fn()
    rng = np.random.default_rng(0)
    real = rng.normal(size=(2, 8)).astype(np.float32)
    zeros = np.concatenate([real, np.zeros((2, 8), np.float32)])
    garbage = np.concatenate(
        [real, 1e6 * rng.normal(size=(2, 8)).astype(np.float32)])
    y_zero = fwd(net.params, net.state, zeros).numpy()
    y_garb = fwd(net.params, net.state, garbage).numpy()
    np.testing.assert_array_equal(y_zero[:2], y_garb[:2])


def test_padded_rows_and_tail_do_not_change_real_outputs_atol0_lm():
    """Garbage token ids in the padded ROWS and in the padded TAIL of a
    real row (mask unchanged) leave the real row's real positions
    bit-identical; the mask is the batcher's numpy array."""
    _, net = _lm_pair(16)
    fwd = net.inference_fn()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, 10)
    mask = np.zeros((2, 16), np.float32)
    mask[0, :10] = 1.0

    def batch_with(pad_fill):
        feats = np.zeros((2, 16), np.int64)
        feats[0, :10] = toks
        feats[0, 10:] = pad_fill[0]
        feats[1, :] = pad_fill[1]
        return feats

    y_a = fwd(net.params, net.state, batch_with((0, 0)), mask).numpy()
    y_b = fwd(net.params, net.state,
              batch_with((rng.integers(1, 64), rng.integers(1, 64))),
              mask).numpy()
    np.testing.assert_array_equal(y_a[0, :10], y_b[0, :10])


def test_inference_fn_builds_no_autograd_graph_on_a_worker_thread():
    """Grad mode is per thread: the returned forward enters no_grad
    itself, for the MLP and the graph alike."""
    _, mlp = _mlp_pair()
    _, lm = _lm_pair(16)
    out = {}

    def work():
        out["mlp"] = mlp.inference_fn()(mlp.params, mlp.state,
                                        np.zeros((2, 8), np.float32))
        out["lm"] = lm.inference_fn()(lm.params, lm.state,
                                      np.zeros((2, 8), np.int64),
                                      np.ones((2, 8), np.float32))

    for t in (mlp, lm):
        for p in t.params.values():
            for v in p.values():
                v.requires_grad_(True)
    th = threading.Thread(target=work)
    th.start()
    th.join(DEADLINE_S)
    assert not th.is_alive()
    assert out["mlp"].grad_fn is None and out["lm"].grad_fn is None


# ------------------------------------------- engines against the JAX one

def _serve_both(jnet, tnet, lattice_kw, requests, *, sequence,
                tdtype=None):
    """Submit every request to each engine BEFORE it starts (so both cut
    the same batches), then start, wait and drain. Returns (JAX outputs,
    port outputs, port engine)."""
    jeng = JaxEngine(jnet, JaxLattice(**lattice_kw), max_wait_ms=1.0,
                     sequence=sequence, recorder=JaxRecorder(path=None))
    teng = InferenceEngine(tnet, BucketLattice(**lattice_kw),
                           max_wait_ms=1.0, sequence=sequence,
                           recorder=Recorder(path=None))
    outs = []
    for eng, cast in ((jeng, None), (teng, tdtype)):
        eng.warmup(requests[0] if cast is None else
                   requests[0].astype(cast))
        reqs = [eng.submit(r) for r in requests]
        eng.start()
        for r in reqs:
            assert r.wait(DEADLINE_S), "request missed its deadline"
            assert r.error is None, r.error
        eng.drain(DEADLINE_S)
        outs.append([np.asarray(r.result) for r in reqs])
    return outs[0], outs[1], teng


def test_tiny_lm_engine_matches_jax_within_1e5():
    jnet, tnet = _lm_pair(32)
    rng = np.random.default_rng(3)
    requests = [rng.integers(0, 64, n).astype(np.int32)
                for n in (32, 5, 17, 8)]
    jout, tout, _ = _serve_both(
        jnet, tnet, dict(batch_sizes=(1, 2, 4), seq_lens=(8, 16, 32)),
        requests, sequence=True, tdtype=np.int64)
    for j, t, r in zip(jout, tout, requests):
        assert t.shape == (len(r), 64)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_tiny_mlp_engine_matches_jax_within_1e6():
    jnet, tnet = _mlp_pair()
    rng = np.random.default_rng(4)
    requests = list(rng.normal(size=(6, 8)).astype(np.float32))
    jout, tout, _ = _serve_both(jnet, tnet, dict(batch_sizes=(1, 2, 4)),
                                requests, sequence=False)
    for j, t in zip(jout, tout):
        assert t.shape == (4,)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_flash_bucket_lm_engine_matches_jax_within_2e5():
    """Head dim 128 in a (4, 512) bucket: three requests cut into one
    batch with an all-masked padding row, through the packed flash
    route (the plain version of K2 here)."""
    jnet, tnet = _lm_pair(512, d_model=256, n_heads=2, d_ff=256)
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, 64, n).astype(np.int32)
                for n in (300, 512, 130)]
    jout, tout, teng = _serve_both(
        jnet, tnet, dict(batch_sizes=(4,), seq_lens=(512,)), requests,
        sequence=True, tdtype=np.int64)
    assert teng.served == 3
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5)


# ------------------------------------------------- zero-retrace promise

def test_zero_new_first_sights_across_mixed_lengths():
    """Warm the lattice once; a mixed-length stream then adds no first
    sight — the trace count and the compile-span count stay frozen — and
    every request event carries the JAX package's fields."""
    _, net = _lm_pair(16)
    rec = Recorder(path=None)
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1, 2),
                                                seq_lens=(8, 16)),
                             max_wait_ms=1.0, sequence=True, recorder=rec)
    assert engine.warmup(np.zeros(16, np.int64)) == 4
    assert engine.trace_count == 4

    def compile_spans():
        return [e for e in rec.events
                if e.get("event") == "span" and e.get("name") == "compile"]

    assert len(compile_spans()) == 4
    assert all(e.get("warmup") for e in compile_spans())
    engine.start()
    rng = np.random.default_rng(5)
    for seq_len in (3, 8, 11, 16, 5, 1, 13, 16, 2, 7):
        # int32 on the wire: submit casts to the warmup template's dtype
        out = engine.predict(rng.integers(0, 64, seq_len).astype(np.int32),
                             timeout=DEADLINE_S)
        assert out.shape == (seq_len, 64)
    assert engine.trace_count == 4, "a request escaped the bucket lattice"
    assert len(compile_spans()) == 4
    reqs = [e for e in rec.events if e.get("event") == "request"]
    assert len(reqs) == 10
    for ev in reqs:
        assert ev["ok"] and ev["total_s"] >= 0 and ev["weight_gen"] == 0
        assert {"queue_s", "batch_assemble_s", "forward_s", "bucket",
                "seq_len", "padded_seq", "trace_id"} <= set(ev)
    engine.drain(DEADLINE_S)


def test_worker_dying_mid_batch_fails_requests_not_replica():
    _, net = _mlp_pair()
    rec = Recorder(path=None)
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1, 2)),
                             max_wait_ms=1.0, recorder=rec)
    engine.warmup(np.zeros(8, np.float32))
    replica = engine.fleet_workers()[0]
    orig = replica._fwd
    bombs = {"n": 1}

    def flaky(*args):
        if bombs["n"]:
            bombs["n"] -= 1
            raise RuntimeError("injected worker death")
        return orig(*args)

    replica._fwd = flaky
    engine.start()
    x = np.zeros(8, np.float32)
    with pytest.raises(RuntimeError, match="injected worker death"):
        engine.predict(x, timeout=DEADLINE_S)
    assert engine.predict(x, timeout=DEADLINE_S).shape == (4,)
    errors = [e for e in rec.events if e.get("event") == "error"]
    assert any("injected worker death" in e.get("error", "")
               for e in errors)
    failed = [e for e in rec.events
              if e.get("event") == "request" and not e.get("ok")]
    assert len(failed) == 1 and "injected worker death" in failed[0]["error"]
    assert engine.stats()["failed"] == 1 and engine.stats()["served"] == 1
    engine.drain(DEADLINE_S)


# ------------------------------------------------------ HTTP /predict

@pytest.fixture(scope="module")
def mlp_stack():
    _, net = _mlp_pair()
    rec = Recorder(path=None)
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1, 2, 4)),
                             max_wait_ms=2.0, recorder=rec)
    engine.warmup(np.zeros(8, np.float32))
    server = ServingServer(engine, port=0).start()
    yield net, engine, server, rec
    server.stop()


def _post(url, payload, route="/predict"):
    req = urllib.request.Request(
        f"{url}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
        return json.loads(resp.read())


def test_predict_round_trip_matches_direct_output(mlp_stack):
    net, _, server, _ = mlp_stack
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    direct = net.output(x).numpy()
    for i in range(5):
        resp = _post(server.url, {"features": x[i].tolist(),
                                  "id": f"q{i}"})
        assert resp["id"] == f"q{i}"
        assert resp["prediction"] == int(direct[i].argmax())
        np.testing.assert_allclose(np.asarray(resp["output"]), direct[i],
                                   atol=1e-6)
        assert resp["timing"]["total_s"] >= resp["timing"]["queue_s"] >= 0


def test_predict_rejects_malformed_and_oversized(mlp_stack):
    _, _, server, _ = mlp_stack
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url, {"nope": 1})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url, {"features": "not numbers"})
    assert e.value.code == 400


def test_predict_400_on_a_prompt_past_the_lattice():
    _, net = _lm_pair(16)
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1,),
                                                seq_lens=(8, 16)),
                             max_wait_ms=1.0, sequence=True,
                             recorder=Recorder(path=None))
    engine.warmup(np.zeros(16, np.int64))
    server = ServingServer(engine, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, {"features": list(range(17))})
        assert e.value.code == 400
        assert "exceeds lattice max" in json.loads(e.value.read())["error"]
        resp = _post(server.url, {"features": list(range(9))})
        assert np.asarray(resp["output"]).shape == (9, 64)
        assert len(resp["prediction"]) == 9
    finally:
        server.stop()


def test_healthz_stats_and_metrics_carry_the_predict_fleet(mlp_stack):
    from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition

    _, engine, server, _ = mlp_stack
    for _ in range(3):
        _post(server.url, {"features": [0.5] * 8})
    with urllib.request.urlopen(f"{server.url}/healthz",
                                timeout=DEADLINE_S) as r:
        health = json.loads(r.read())
    assert health["status"] == "serving"
    assert health["replicas"] == 1
    assert health["lattice"]["batch_sizes"] == [1, 2, 4]
    assert health["fleet"][0]["state"] == "serving"
    assert health["fleet"][0]["alive"]
    assert "last_beat_age_s" in health["fleet"][0]
    assert health["weights"]["generation"] == 0
    assert health["memory"] is None and health["peak_flops"] == 0.0
    with urllib.request.urlopen(f"{server.url}/metrics",
                                timeout=DEADLINE_S) as r:
        parsed = parse_exposition(r.read().decode())
    assert parsed['serving_requests_total{kind="predict",outcome="ok"}'] \
        >= 3
    assert parsed['serving_replica_up{replica="0"}'] == 1.0
    assert parsed["serving_trace_count"] == engine.trace_count == 3


def test_predict_503_with_retry_after_while_draining():
    _, net = _mlp_pair()
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1,)),
                             max_wait_ms=1.0, recorder=Recorder(path=None))
    engine.warmup(np.zeros(8, np.float32))
    server = ServingServer(engine, port=0).start()
    try:
        urllib.request.urlopen(
            urllib.request.Request(f"{server.url}/drain", data=b""),
            timeout=DEADLINE_S).read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url, {"features": [0.0] * 8})
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "5"
    finally:
        server.stop()


# --------------------------------------------------------- the replay

@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_run_replay_scoreboard_reads_alike_in_both_packages(tmp_path, model):
    """The end-to-end predict replay at a small size: every request
    served, zero recompiles, the JAX metric names, and the JAX package's
    `reconstruct` reads the port's telemetry into the same scoreboard."""
    tpath = str(tmp_path / "telemetry.jsonl")
    apath = str(tmp_path / "SERVE.json")
    sb = replay.run_replay(model=model, seed=0, n_requests=16, replicas=2,
                           telemetry_path=tpath, artifact_path=apath,
                           device="cpu")
    assert sb["n_ok"] == 16 and sb["client"]["failed"] == 0
    assert sb["recompiles_after_warmup"] == 0
    assert sb["warmed_buckets"] == (18 if model == "lm" else 6)
    assert sb["qps"] > 0 and sb["p99_ms"] >= sb["p50_ms"] > 0
    assert jreplay.reconstruct(tpath) == replay.reconstruct(tpath)
    assert [l["metric"] for l in sb["lines"]] == [
        "serving_replay_qps", "serving_replay_p50_ms",
        "serving_replay_p99_ms", "serving_replay_recompiles_after_warmup"]
    with open(apath) as fh:
        rows = [json.loads(l) for l in fh]
    assert rows[-1]["metric"] == "summary"


def test_graph_inference_fn_rejects_multi_output_graphs():
    """Serving dispatches one padded input/output pair."""
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = (NeuralNetConfiguration.builder().seed(1).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=4), "in")
            .add_layer("o1", OutputLayer(n_in=4, n_out=2,
                                         activation="softmax"), "d")
            .add_layer("o2", OutputLayer(n_in=4, n_out=2,
                                         activation="softmax"), "d")
            .set_outputs("o1", "o2").build())
    with pytest.raises(ValueError, match="single-input/single-output"):
        ComputationGraph(conf, device="cpu").inference_fn()
    assert torch.is_grad_enabled()


def test_flash_launch_counts_survive_concurrent_replicas():
    """Replica threads launch flash kernels concurrently; the launch
    table is read for exact counts, so no increment may be lost (a short
    switch interval makes a lost read-modify-write likely)."""
    import sys

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    before = fa.LAUNCHES["K2"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fa._count("K2") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        n = fa.LAUNCHES["K2"] - before
        fa.LAUNCHES["K2"] = before
    assert n == 16 * 2000


def test_front_door_holds_a_burst_of_connections():
    """The listen backlog holds as many pending connections as the replay
    client opens at once: with the accept loop not yet running, every
    connect of the burst completes (at the socketserver default of 5 the
    kernel drops the rest, and each client waits out a SYN retransmit)."""
    import socket

    _, net = _mlp_pair()
    engine = InferenceEngine(net, BucketLattice(batch_sizes=(1,)),
                             recorder=Recorder(path=None))
    server = ServingServer(engine, port=0)  # not started: nothing accepts
    socks = []
    try:
        for _ in range(replay._CLIENT_WORKERS):
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=2.0)
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        server._httpd.server_close()
    assert len(socks) == replay._CLIENT_WORKERS
