"""The port's fleet operations (deeplearning4j_tpu_torch/serving/fleet.py
and the engines' fleet hooks) on the CPU, against the JAX package.

* Exact agreement with the JAX functions: the replica fault-spec parse,
  `autoscale_decision` and `RespawnBackoff` (jitter 0) over tables,
  `recent_p99_ms`, and `reconstruct_fleet` / `fleet_metric_lines` on one
  telemetry file.
* Behaviour, from the telemetry JSONL where the JAX tests read it: a
  mid-traffic hot-swap with zero failed requests and the generation flip
  visible in `request` events; mismatched and truncated checkpoints
  rejected with the old weights serving; the checkpoint watcher; kill
  and hang chaos reaped and respawned with no new first sight; a
  generation worker killed mid-decode (pages released, respawned);
  add/retire replica; the supervisor autoscaling on fake clocks; and the
  small two-arm fleet replay.

Every spawned-thread wait carries DEADLINE_S; no sleep loops.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.distributed import faults as jfaults
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving import replay as jreplay
from deeplearning4j_tpu_torch.distributed import faults as tfaults
from deeplearning4j_tpu_torch.serving import fleet, replay
from deeplearning4j_tpu_torch.serving.batcher import (Batcher, PendingRequest,
                                                      assemble)
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import (GenerationEngine,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.serving.fleet import (AutoscalePolicy,
                                                    AutoscaleState,
                                                    CheckpointWatcher,
                                                    FleetSupervisor,
                                                    ReplicaFaultInjector,
                                                    ReplicaKilled,
                                                    RespawnBackoff,
                                                    WeightStore,
                                                    WeightSwapError,
                                                    autoscale_decision)
from deeplearning4j_tpu_torch.serving.server import ServingServer
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

pytestmark = pytest.mark.port

DEADLINE_S = 30.0


def _mlp(**kw):
    return replay._tiny_mlp(device="cpu", **kw)


def _events(path, kind):
    with open(path) as fh:
        rows = [json.loads(l) for l in fh if l.startswith("{")]
    return [e for e in rows if e.get("event") == kind]


def _publish(net, step, tmp_path, *, bump=0.5):
    """A training job publishing a step: the net's params shifted by
    `bump`, saved at `step`."""
    pub = net.clone()
    for p in pub.params.values():
        for t in p.values():
            t.add_(bump)
    pub.iteration_count = step
    ckdir = str(tmp_path / f"publish_{step}")
    Checkpointer(ckdir).save(pub)
    return ckdir


def _engine(rec=None, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    engine = InferenceEngine(_mlp(), BucketLattice(batch_sizes=(1, 2)),
                             recorder=rec or Recorder(path=None), **kw)
    engine.warmup(np.zeros(8, np.float32))
    return engine


# ---------------------------------------------- pure: against the JAX package

FAULT_SPECS = ["r0:kill@batch4", "r1:hang@batch2", "r0:kill@decode5",
               "r3:hang@decode12", "r0:kill@batch1;r1:hang@decode2"]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_parse_matches_jax(spec):
    got = tfaults.FaultSchedule.parse(spec)
    ref = jfaults.FaultSchedule.parse(spec)
    assert [vars(f) for f in got] == [vars(f) for f in ref]
    assert [f.spec() for f in got] == [f.spec() for f in ref]
    assert got.to_env() == ref.to_env() == spec
    for i in range(4):
        assert [f.spec() for f in got.for_replica(i)] == \
            [f.spec() for f in ref.for_replica(i)]


@pytest.mark.parametrize("spec", ["r0:kill", "r0:delay-connect:1.5",
                                  "r0:kill@step3", "x1:kill@batch2",
                                  "r0:kill@batchX", "p1:kill@step3"])
def test_fault_spec_rejects_what_serving_cannot_run(spec):
    """Specs the JAX grammar refuses for a replica are refused here too;
    process-scoped specs (valid in the JAX package) wait for the
    multi-process slice and are refused by name."""
    with pytest.raises(ValueError) as err:
        tfaults.parse_fault(spec)
    if spec.startswith("p"):
        jfaults.parse_fault(spec)  # a process fault in the JAX package
        assert "A7" in str(err.value)
    else:
        with pytest.raises(ValueError):
            jfaults.parse_fault(spec)


# (policy kwargs, [(queue_depth, p99_ms, n_replicas, now, headroom)])
AUTOSCALE_TABLES = {
    "up_on_depth_with_cooldown": (
        dict(min_replicas=1, max_replicas=3, up_queue_depth=8,
             down_queue_depth=1, cooldown_up_s=1.0, cooldown_down_s=5.0),
        [(10, 0.0, 1, 0.0, None), (50, 0.0, 2, 0.5, None),
         (50, 0.0, 2, 1.1, None), (50, 0.0, 3, 9.0, None)]),
    "down_hysteresis_and_floor": (
        dict(min_replicas=1, max_replicas=3, up_queue_depth=8,
             down_queue_depth=1, cooldown_up_s=0.5, cooldown_down_s=4.0),
        [(10, 0.0, 1, 0.0, None), (0, 0.0, 2, 1.0, None),
         (4, 0.0, 2, 10.0, None), (0, 0.0, 2, 10.0, None),
         (0, 0.0, 2, 11.0, None), (0, 0.0, 1, 99.0, None)]),
    "p99_trigger": (
        dict(max_replicas=2, up_queue_depth=10 ** 9, up_p99_ms=50.0,
             down_p99_ms=10.0, cooldown_up_s=0.0, cooldown_down_s=1.0),
        [(0, 80.0, 1, 0.0, None), (0, 30.0, 2, 5.0, None),
         (0, 5.0, 2, 6.0, None)]),
    "headroom_veto_and_drain": (
        dict(max_replicas=3, up_queue_depth=2, min_headroom=0.2,
             cooldown_up_s=0.0, cooldown_down_s=1.0),
        [(9, 0.0, 2, 0.0, 0.1), (9, 0.0, 1, 0.5, 0.1),
         (9, 0.0, 1, 2.0, 0.5), (9, 0.0, 2, 2.5, None)]),
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE_TABLES))
def test_autoscale_decision_matches_jax(name):
    kw, rows = AUTOSCALE_TABLES[name]
    tp, jp = AutoscalePolicy(**kw), jfleet.AutoscalePolicy(**kw)
    ts, js = AutoscaleState(), jfleet.AutoscaleState()
    got, ref = [], []
    for depth, p99, n, now, headroom in rows:
        args = dict(queue_depth=depth, p99_ms=p99, n_replicas=n, now=now,
                    headroom=headroom)
        got.append(autoscale_decision(tp, ts, **args))
        ref.append(jfleet.autoscale_decision(jp, js, **args))
        assert (ts.last_up_t, ts.last_down_t) == \
            (js.last_up_t, js.last_down_t)
    assert got == ref
    assert any(got), "a table that never scales tests nothing"


@pytest.mark.parametrize("kw", [
    dict(base_s=0.1, factor=2.0, cap_s=0.8, jitter_frac=0.0),
    dict(base_s=0.01, factor=3.0, cap_s=1.0, jitter_frac=0.0),
    dict(base_s=0.1, factor=2.0, cap_s=0.8, jitter_frac=0.25, seed=7)])
def test_respawn_backoff_matches_jax(kw):
    b, j = RespawnBackoff(**kw), jfleet.RespawnBackoff(**kw)
    got = [b.next() for _ in range(8)]
    assert got == [j.next() for _ in range(8)]
    cap = kw["cap_s"] * (1 + kw["jitter_frac"])
    assert max(got) <= cap + 1e-12
    b.reset()
    assert b.next() <= kw["base_s"] * (1 + kw["jitter_frac"]) + 1e-12
    with pytest.raises(ValueError, match="jitter_frac"):
        RespawnBackoff(jitter_frac=1.5)


def test_recent_p99_and_headroom_match_jax():
    rec = Recorder(path=None)
    assert fleet.recent_p99_ms(rec) == 0.0
    rng = np.random.default_rng(0)
    for i in range(100):
        rec.request(f"r{i}", ok=bool(i % 7), total_s=float(rng.random()))
    assert fleet.recent_p99_ms(rec) == jfleet.recent_p99_ms(rec)
    assert fleet.recent_p99_ms(rec, 8) == jfleet.recent_p99_ms(rec, 8)
    # no `memory` event on the record: no signal
    assert fleet.recent_headroom(rec) is None
    rec.event("memory", devices={"0": {"bytes_limit": 100,
                                       "bytes_in_use": 75}})
    assert fleet.recent_headroom(rec) == jfleet.recent_headroom(rec) == 0.25


# ------------------------------------------------- pure: store, injector

def test_weight_store_flip_ordering_and_immutability():
    store = WeightStore({"w": 1}, {"s": 1}, step=3)
    before = store.current
    assert (before.generation, before.step) == (0, 3)
    new = store.publish({"w": 2}, {"s": 2}, step=9)
    assert store.current is new
    assert (new.generation, new.step) == (1, 9)
    assert before.params == {"w": 1} and before.generation == 0
    assert store.last_swap_ts is not None
    with pytest.raises(Exception):
        new.params = {}


def test_weight_store_concurrent_readers_see_whole_generations():
    store = WeightStore({"w": 0}, None, step=0)
    seen = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            ws = store.current
            seen.append((ws.generation, ws.step, ws.params["w"]))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for g in range(1, 50):
        store.publish({"w": g}, None, step=g * 10)
    stop.set()
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "reader missed its deadline"
    for gen, step, w in seen:
        assert step == gen * 10 and w == gen, "torn read across the flip"


def test_replica_fault_injector_fires_once_and_records():
    rec = Recorder(path=None)
    inj = ReplicaFaultInjector("r1:kill@batch3", recorder=rec)
    inj.check(0, "batch", 3)
    inj.check(1, "batch", 2)
    inj.check(1, "decode", 3)
    with pytest.raises(ReplicaKilled):
        inj.check(1, "batch", 3)
    inj.check(1, "batch", 3)  # one-shot
    faults = [e for e in rec.events if e.get("event") == "fault"]
    assert len(faults) == 1
    assert faults[0]["kind"] == "replica-kill"
    assert faults[0]["spec"] == "r1:kill@batch3"


def test_batcher_requeue_puts_requests_back_at_fifo_head():
    now = {"t": 0.0}
    b = Batcher(BucketLattice(batch_sizes=(1, 2, 4)), max_wait_ms=5.0,
                clock=lambda: now["t"])
    first = b.submit(np.zeros(3, np.float32))
    second = b.submit(np.ones(3, np.float32))
    now["t"] = 0.006
    batch = b.next_batch(timeout=0.5)
    assert batch.n_real == 2 and b.depth == 0
    b.requeue(batch.requests)
    assert b.depth == 2
    again = b.next_batch(timeout=0.5)
    assert again.requests[0] is first and again.requests[1] is second
    b.close()
    b.requeue([first])
    assert b.next_batch(timeout=0.0).requests == [first]


def test_validate_swap_names_shape_dtype_and_device_mismatches():
    import torch

    cur = {"l": {"W": torch.zeros(2, 3)}}
    fleet.validate_swap(cur, {"l": {"W": torch.ones(2, 3)}})
    for bad, what in (({"l": {"W": torch.zeros(3, 2)}}, "mismatch"),
                      ({"l": {"W": torch.zeros(2, 3, dtype=torch.float64)}},
                       "mismatch"),
                      ({"l": {"W": torch.zeros(2, 3), "b": torch.zeros(3)}},
                       "tree mismatch"),
                      ({"l": {"W": torch.zeros(2, 3, device="meta")}},
                       "is on meta")):
        with pytest.raises(WeightSwapError, match=what):
            fleet.validate_swap(cur, bad)


# ----------------------------------------------------- live hot-swap

def test_hot_swap_mid_traffic_zero_failed_from_telemetry(tmp_path):
    tpath = str(tmp_path / "telemetry.jsonl")
    rec = Recorder(tpath)
    engine = _engine(rec)
    engine.start()
    ckdir = _publish(engine.net, 5, tmp_path)
    x = np.ones(8, np.float32)
    outs = []
    done_half, swap_done, finished = (threading.Event(), threading.Event(),
                                      threading.Event())

    def traffic():
        for i in range(20):
            outs.append(engine.predict(x, timeout=DEADLINE_S))
            if i == 9:
                done_half.set()
                swap_done.wait(DEADLINE_S)
        finished.set()

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    assert done_half.wait(DEADLINE_S), "traffic missed its deadline"
    swap = fleet.hot_swap(engine, ckdir)
    swap_done.set()
    assert swap["step"] == 5 and swap["generation"] == 1
    assert finished.wait(DEADLINE_S), "traffic missed its deadline"
    t.join(DEADLINE_S)
    engine.drain(DEADLINE_S)
    rec.close()
    reqs = _events(tpath, "request")
    assert len(reqs) == 20 and all(e["ok"] for e in reqs)
    gens = [e["weight_gen"] for e in reqs]
    assert set(gens) == {0, 1} and gens == sorted(gens)
    swaps = _events(tpath, "weight_swap")
    assert len(swaps) == 1 and swaps[0]["ok"]
    assert swaps[0]["step"] == 5 and swaps[0]["restore_ms"] > 0
    assert not np.allclose(outs[0], outs[-1])
    # the new generation serves the published net's outputs exactly
    pub = _mlp()
    pub.resume_from(ckdir)
    np.testing.assert_array_equal(outs[-1], pub.output(x[None]).numpy()[0])


def test_hot_swap_rejects_mismatched_and_truncated_checkpoints(tmp_path):
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    tpath = str(tmp_path / "telemetry.jsonl")
    rec = Recorder(tpath)
    engine = _engine(rec)
    engine.start()
    x = np.ones(8, np.float32)
    before = engine.predict(x, timeout=DEADLINE_S)
    # (a) another output width
    bad_dir = str(tmp_path / "wrong_arch")
    Checkpointer(bad_dir).save(_mlp(n_out=7), 3)
    with pytest.raises(WeightSwapError, match="mismatch"):
        fleet.hot_swap(engine, bad_dir)
    # (a') another HIDDEN width
    narrow = MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(1).list()
         .layer(DenseLayer(n_in=8, n_out=5, activation="relu"))
         .layer(OutputLayer(n_in=5, n_out=4, activation="softmax",
                            loss_function="mcxent")).build()),
        device="cpu").init()
    narrow_dir = str(tmp_path / "wrong_hidden")
    Checkpointer(narrow_dir).save(narrow, 3)
    with pytest.raises(WeightSwapError, match="mismatch"):
        fleet.hot_swap(engine, narrow_dir)
    # (b) a committed-looking step whose model file is cut short
    ckdir = _publish(engine.net, 4, tmp_path)
    model = tmp_path / "publish_4" / "step_4" / "model.pt"
    model.write_bytes(model.read_bytes()[:100])
    with pytest.raises(WeightSwapError, match="truncated"):
        fleet.hot_swap(engine, ckdir)
    # (c) nothing committed
    with pytest.raises(WeightSwapError, match="no committed"):
        fleet.hot_swap(engine, str(tmp_path / "empty"))
    after = engine.predict(x, timeout=DEADLINE_S)
    np.testing.assert_array_equal(before, after)
    assert engine.weights.generation == 0
    engine.drain(DEADLINE_S)
    rec.close()
    swaps = _events(tpath, "weight_swap")
    assert len(swaps) == 4 and not any(s["ok"] for s in swaps)
    assert all(e["ok"] for e in _events(tpath, "request"))


def test_checkpoint_watcher_follows_publishes_and_skips_rejects(tmp_path):
    engine = InferenceEngine(_mlp(), BucketLattice(batch_sizes=(1,)),
                             max_wait_ms=1.0, recorder=Recorder(path=None))
    engine.warmup(np.zeros(8, np.float32))
    ckdir = _publish(engine.net, 2, tmp_path)
    watcher = CheckpointWatcher(engine, ckdir, interval_s=0.01)
    out = watcher.poll_once()
    assert out["ok"] and out["step"] == 2
    assert engine.weights.generation == 1
    assert watcher.poll_once() is None
    pub = engine.net.clone()
    pub.iteration_count = 6
    Checkpointer(ckdir).save(pub)
    (tmp_path / "publish_2" / "step_6" / "model.pt").unlink()
    out = watcher.poll_once()
    assert out is not None and not out["ok"] and out["step"] == 6
    assert engine.weights.generation == 1
    assert watcher.poll_once() is None


def test_hot_swap_refuses_generation_engines():
    engine = GenerationEngine(
        replay._tiny_lm(16, device="cpu"),
        BucketLattice(batch_sizes=(1,), seq_lens=(8, 16)),
        slots=2, max_new_tokens=4, recorder=Recorder(path=None))
    with pytest.raises(WeightSwapError, match="KV cache"):
        fleet.hot_swap(engine, "/nonexistent")


# ------------------------------------------------- replica chaos healing

def test_replica_kill_chaos_only_inflight_batch_fails(tmp_path):
    tpath = str(tmp_path / "telemetry.jsonl")
    rec = Recorder(tpath)
    engine = _engine(rec, faults="r0:kill@batch2")
    frozen = engine.trace_count
    engine.start()
    supervisor = FleetSupervisor(
        engine, death_after_s=1.0,
        backoff=RespawnBackoff(base_s=0.0, jitter_frac=0.0), recorder=rec)
    x = np.ones(8, np.float32)
    ok_before = engine.predict(x, timeout=DEADLINE_S)
    with pytest.raises(RuntimeError, match="ReplicaKilled"):
        engine.predict(x, timeout=DEADLINE_S)
    actions = supervisor.poll()
    assert actions["reaped"] == [0] and actions["respawned"] == [0]
    np.testing.assert_array_equal(ok_before,
                                  engine.predict(x, timeout=DEADLINE_S))
    assert engine.trace_count == frozen, "respawn saw a new shape"
    engine.drain(DEADLINE_S)
    rec.close()
    reqs = _events(tpath, "request")
    failed = [e for e in reqs if not e["ok"]]
    assert len(failed) == 1 and "ReplicaKilled" in failed[0]["error"]
    assert [e["ok"] for e in reqs].count(True) == 2
    assert [e["kind"] for e in _events(tpath, "fault")] == \
        ["replica-kill", "replica-dead", "replica-respawn"]
    assert _events(tpath, "fault")[-1]["respawn_ms"] >= 0
    compiles = [e for e in _events(tpath, "span")
                if e.get("name") == "compile"]
    assert compiles and all(e.get("warmup") for e in compiles)


def test_replica_hang_reaped_by_heartbeat_and_queue_drains_back():
    rec = Recorder(path=None)
    engine = InferenceEngine(_mlp(), BucketLattice(batch_sizes=(1,)),
                             max_wait_ms=0.5, recorder=rec,
                             faults="r0:hang@batch1")
    engine.warmup(np.zeros(8, np.float32))
    engine.start()
    supervisor = FleetSupervisor(
        engine, death_after_s=2.0,
        backoff=RespawnBackoff(base_s=0.0, jitter_frac=0.0), recorder=rec)
    x = np.ones(8, np.float32)
    hung = engine.submit(x)
    queued = engine.submit(x)
    replica = engine.fleet_workers()[0]
    tick = threading.Event()
    for _ in range(int(DEADLINE_S / 0.01)):
        if replica.current_batch is not None:
            break
        tick.wait(0.01)
    assert replica.current_batch is not None, "hang never engaged"
    actions = supervisor.poll(now=engine._clock() + 10.0)
    assert actions["reaped"] == [0] and actions["respawned"] == [0]
    assert hung.wait(DEADLINE_S) and "reaped" in hung.error
    assert queued.wait(DEADLINE_S), "requeued batch missed its deadline"
    assert queued.error is None and queued.result.shape == (4,)
    engine.drain(2.0)


def test_gen_worker_kill_mid_decode_releases_pages_and_respawns(tmp_path):
    tpath = str(tmp_path / "telemetry.jsonl")
    rec = Recorder(tpath)
    engine = GenerationEngine(
        replay._tiny_lm(24, device="cpu"),
        BucketLattice(batch_sizes=(1,), seq_lens=(8,)),
        slots=2, max_new_tokens=8, page_size=4, recorder=rec,
        faults="r0:kill@decode2")
    engine.warmup()
    frozen = engine.trace_count
    engine.start()
    supervisor = FleetSupervisor(
        engine, death_after_s=1.0,
        backoff=RespawnBackoff(base_s=0.0, jitter_frac=0.0), recorder=rec)
    prompt = np.arange(8)
    req = engine.submit_generate(prompt, max_new_tokens=6)
    assert req.wait(DEADLINE_S), "killed generation missed its deadline"
    assert req.error is not None and "ReplicaKilled" in req.error
    worker = engine.fleet_workers()[0]
    assert worker.lifecycle == "dead"
    assert worker.pool.describe()["pages_in_use"] == 0, \
        "a dead slot leaked its pages"
    assert engine.fleet_snapshot()["n_serving"] == 0
    assert supervisor.poll()["respawned"] == [0]
    assert len(engine.generate(prompt, max_new_tokens=6,
                               timeout=DEADLINE_S)) == 6
    assert engine.trace_count == frozen, "respawn saw a new shape"
    engine.drain(DEADLINE_S)
    rec.close()
    assert [e["kind"] for e in _events(tpath, "fault")] == \
        ["replica-kill", "replica-dead", "replica-respawn"]


def test_gen_worker_reap_fails_occupied_slots_and_frees_pages():
    engine = GenerationEngine(
        replay._tiny_lm(24, device="cpu"),
        BucketLattice(batch_sizes=(1,), seq_lens=(8,)),
        slots=2, max_new_tokens=8, page_size=4,
        recorder=Recorder(path=None))
    engine.warmup()
    worker = engine.fleet_workers()[0]
    # admit without a running thread: the slot stays occupied
    req = engine.submit_generate(np.arange(8), max_new_tokens=4)
    worker._admit(engine._clock)
    assert worker.pool.describe()["pages_in_use"] > 0
    assert engine.fleet_reap(worker, "heartbeat-stale") == 0
    assert req.wait(DEADLINE_S) and "reaped" in req.error
    assert worker.pool.describe()["pages_in_use"] == 0
    engine.fleet_respawn(worker)
    assert worker.lifecycle == "serving" and worker.alive
    assert len(engine.generate(np.arange(5), 3, timeout=DEADLINE_S)) == 3
    engine.drain(DEADLINE_S)


# --------------------------------------------- scale up / drain down

def test_add_replica_serves_and_keeps_warmup_accounting(tmp_path):
    tpath = str(tmp_path / "telemetry.jsonl")
    rec = Recorder(tpath)
    engine = _engine(rec, max_wait_ms=0.5)
    engine.start()
    assert engine.fleet_snapshot()["n_serving"] == 1
    engine.add_replica()
    assert engine.fleet_snapshot()["n_serving"] == 2
    for _ in range(6):
        engine.predict(np.ones(8, np.float32), timeout=DEADLINE_S)
    engine.drain(DEADLINE_S)
    rec.close()
    compiles = [e for e in _events(tpath, "span")
                if e.get("name") == "compile"]
    assert len(compiles) == 4 and all(e.get("warmup") for e in compiles)
    reqs = _events(tpath, "request")
    assert all(e["ok"] for e in reqs)


def test_retire_replica_drains_queued_work_and_keeps_last():
    engine = _engine(max_wait_ms=0.5)
    engine.start()
    second = engine.add_replica()
    req = PendingRequest(features=np.ones(8, np.float32),
                         t_enqueue=engine._clock())
    batch = assemble([req], engine.lattice)
    batch.t_cut = engine._clock()
    req.t_assembled = batch.t_cut
    second.queue.put(batch)
    assert engine.retire_replica() is second
    assert req.wait(DEADLINE_S), "queued work dropped on scale-down"
    assert req.error is None
    assert engine.fleet_snapshot()["n_serving"] == 1
    assert engine.predict(np.ones(8, np.float32),
                          timeout=DEADLINE_S).shape == (4,)
    assert engine.retire_replica() is None
    engine.drain(DEADLINE_S)
    assert second.lifecycle == "retired"


def test_supervisor_autoscales_live_engine_up_and_down():
    rec = Recorder(path=None)
    engine = _engine(rec, max_wait_ms=0.5)
    supervisor = FleetSupervisor(
        engine, policy=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                       up_queue_depth=4, down_queue_depth=0,
                                       cooldown_up_s=0.0,
                                       cooldown_down_s=1.0),
        recorder=rec)
    reqs = [PendingRequest(features=np.ones(8, np.float32),
                           t_enqueue=engine._clock()) for _ in range(8)]
    engine.batcher.requeue(reqs)
    assert supervisor.poll(now=100.0)["scale"] == 1
    assert engine.fleet_snapshot()["n_replicas"] == 2
    engine.start()
    for r in reqs:
        assert r.wait(DEADLINE_S), "parked request missed its deadline"
    assert engine.batcher.depth == 0
    assert supervisor.poll(now=200.0)["scale"] == -1
    assert engine.fleet_snapshot()["n_serving"] == 1
    auto = [e for e in rec.events if e.get("event") == "autoscale"]
    assert [e["action"] for e in auto] == [1, -1]
    assert all(e["max_replicas"] == 2 for e in auto)
    engine.drain(DEADLINE_S)


# --------------------------------------------------- server fleet state

def test_healthz_reports_fleet_state_and_drain_retry_after(tmp_path):
    engine = _engine()
    ckdir = _publish(engine.net, 11, tmp_path)
    server = ServingServer(engine, port=0).start()
    try:
        fleet.hot_swap(engine, ckdir)
        with urllib.request.urlopen(f"{server.url}/healthz",
                                    timeout=DEADLINE_S) as r:
            health = json.loads(r.read())
        assert health["status"] == "serving"
        assert health["weights"]["generation"] == 1
        assert health["weights"]["step"] == 11
        assert health["weights"]["last_swap_ts"] is not None
        assert health["fleet"][0]["state"] == "serving"
        urllib.request.urlopen(
            urllib.request.Request(f"{server.url}/drain", data=b""),
            timeout=DEADLINE_S).read()
        req = urllib.request.Request(
            f"{server.url}/predict",
            data=json.dumps({"features": [0.0] * 8}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=DEADLINE_S)
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "5"
    finally:
        server.stop()


# ------------------------------------------------------ the fleet replay

def test_fleet_replay_bounded_failures_and_jax_scoreboard(tmp_path):
    """Both arms complete, the chaos kill's failures stay bounded, zero
    retraces, the swap and respawn are on the record; the JAX package's
    `reconstruct_fleet` and `fleet_metric_lines` read the same files
    into the same rows."""
    tpath = str(tmp_path / "t.jsonl")
    out = replay.run_fleet_replay(
        seed=3, n_requests=24, burst=4, mean_gap_s=0.01,
        autoscale_max=2, chaos="r0:kill@batch3", hot_swap_after=6,
        telemetry_path=tpath, artifact_path=str(tmp_path / "SERVE.json"),
        device="cpu")
    fixed, auto = out["fixed"], out["autoscale"]
    assert fixed["n_failed"] == 0 and fixed["n_ok"] == 24
    assert auto["n_ok"] >= 20
    assert 1 <= auto["n_failed"] <= 4, "chaos failures not bounded"
    assert auto["n_respawns"] >= 1 and auto["respawn_ms"] >= 0
    assert auto["n_swaps"] == 1 and auto["swap_ms"] > 0
    assert auto["weight_generations"][0] == 0
    assert set(auto["weight_generations"]) <= {0, 1}
    assert auto["recompiles_after_warmup"] == 0
    assert fixed["recompiles_after_warmup"] == 0
    assert 0 < auto["autoscale_occupancy"] <= 1.0
    strip = ("client", "telemetry")
    for arm in (fixed, auto):
        ref = jreplay.reconstruct_fleet(arm["telemetry"])
        assert {k: v for k, v in arm.items() if k not in strip} == ref
    assert out["lines"] == jreplay.fleet_metric_lines(fixed, auto)
