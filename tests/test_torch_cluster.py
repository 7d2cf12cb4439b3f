"""The port's multi-process control plane (parallel/cluster.py) against
the JAX package's: the cases of tests/test_cluster.py (registration,
heartbeat dead-worker removal, config registry, averaging rounds,
snapshots, slot claims, rank adoption, the drop-heartbeat fault, the
elastic training loop in true multi-PROCESS runs, kill-and-resume) on
the port's coordinator and clients, `build_vocab_distributed`, and the
wire between the packages: a port client averaging with a JAX client
through either package's coordinator, and the bytes of both protocols
compared.

The worker processes run tests/torch_fleet_worker.py (no JAX) from the
JAX net's initial params. Tolerances: replicas that average every step
agree to 1e-6; two workers on half batches against the JAX package's
single-process full-batch SGD agree to 5e-4 (gradient linearity up to
f32 order, the JAX package's bound in tests/test_cluster.py).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import cluster as jcluster
from deeplearning4j_tpu_torch.parallel import cluster as tcluster
from deeplearning4j_tpu_torch.parallel.cluster import (
    ClusterClient,
    ClusterCoordinator,
)

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fleet_worker.py")
PROC_TIMEOUT = 120


def jax_param_arrays(net) -> dict:
    """`params/<layer>/<name>` numpy arrays of a JAX net's params."""
    return {f"params/{layer}/{name}": np.asarray(v)
            for layer, leaves in net.params.items()
            for name, v in leaves.items()}


@pytest.fixture()
def coord():
    c = ClusterCoordinator(heartbeat_timeout=2.0).start()
    yield c
    c.shutdown()


def test_register_ranks_and_config(coord):
    a = ClusterClient(coord.address, "wA")
    b = ClusterClient(coord.address, "wB")
    assert {a.rank, b.rank} == {0, 1}
    assert a.workers() == ["wA", "wB"]
    a.set_config("training", {"lr": 0.1, "layers": [4, 3]})
    assert b.get_config("training") == {"lr": 0.1, "layers": [4, 3]}
    assert b.get_config("missing") is None
    assert b.get_config("missing", 7) == 7
    a.close()
    b.close()


def test_dead_worker_removed_after_heartbeat_timeout(coord):
    a = ClusterClient(coord.address, "wA", heartbeat_interval=0.2)
    b = ClusterClient(coord.address, "wB", heartbeat_interval=0.2)
    assert sorted(coord.alive_workers()) == ["wA", "wB"]
    b._hb_stop.set()  # b stops heartbeating (a crash)
    time.sleep(2.5)
    assert sorted(coord.alive_workers()) == ["wA"]
    a.close()


def _average_pair(a, b, step, va, vb):
    out = {}

    def go(client, vec):
        out[client.worker_id] = client.average(step,
                                               np.asarray(vec, np.float32))

    ts = [threading.Thread(target=go, args=(a, va)),
          threading.Thread(target=go, args=(b, vb))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts), "round never completed"
    return out


def test_average_round_means_contributions(coord):
    a = ClusterClient(coord.address, "wA")
    b = ClusterClient(coord.address, "wB")
    out = _average_pair(a, b, 1, [1.0, 3.0], [3.0, 5.0])
    np.testing.assert_allclose(out["wA"], [2.0, 4.0])
    np.testing.assert_allclose(out["wB"], [2.0, 4.0])
    a.close()
    b.close()


def test_average_completes_elastically_when_worker_dies(coord):
    a = ClusterClient(coord.address, "wA", heartbeat_interval=0.2)
    b = ClusterClient(coord.address, "wB", heartbeat_interval=0.2)
    b._hb_stop.set()  # b is declared dead mid-round
    result = {}

    def go():
        result["avg"] = a.average(5, np.asarray([2.0, 2.0], np.float32))

    t = threading.Thread(target=go)
    t.start()
    t.join(timeout=15)
    assert not t.is_alive(), "round never completed after worker death"
    np.testing.assert_allclose(result["avg"], [2.0, 2.0])
    a.close()


# --------------------------------------------------------------- processes

def _inputs(tmp_path, kind="mln"):
    from tests.cluster_worker import build_net, full_data

    x, y = full_data()
    path = tmp_path / f"inputs_{kind}.npz"
    np.savez(path, x=x, y=y, **jax_param_arrays(build_net(kind).init()))
    return str(path)


def _spawn(inputs, address, wid, shard, out, ckpt="-", crash_at="none",
           kind="mln"):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, WORKER, "cluster", inputs, address, wid, shard,
         ckpt, crash_at, kind, str(out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _wait(p):
    try:
        _, err = p.communicate(timeout=PROC_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    return err.decode()[-3000:]


def _jax_fit(kind="mln"):
    """The JAX package's single-process reference: full batch, STEPS
    steps of plain SGD."""
    from deeplearning4j_tpu.datasets.api import DataSet
    from tests.cluster_worker import STEPS, build_net, full_data

    x, y = full_data()
    ref = build_net(kind).init()
    for _ in range(STEPS):
        ref.fit(DataSet(x, y))
    return np.asarray(ref.params_flat())


@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_two_process_training_matches_single_process(tmp_path, kind):
    """2 workers x half batch with per-step averaging == the JAX package's
    1 process x full batch, for plain SGD (gradient linearity); the
    replicas stay in sync. The MultiLayerNetwork and the graph."""
    inputs = _inputs(tmp_path, kind)
    coord = ClusterCoordinator(heartbeat_timeout=30.0).start()
    # both workers are in the alive set before either starts: a round
    # completes with whoever is alive, so a worker still importing torch
    # when the other averages would otherwise miss round 1
    for w in ("w0", "w1"):
        coord.register(w)
    try:
        procs = [_spawn(inputs, coord.address, f"w{i}", str(i),
                        tmp_path / f"w{i}.npz",
                        ckpt=str(tmp_path / f"ck{i}"), kind=kind)
                 for i in range(2)]
        for p in procs:
            err = _wait(p)
            assert p.returncode == 0, err
    finally:
        coord.shutdown()
    flat0 = np.load(tmp_path / "w0.npz")["params"]
    flat1 = np.load(tmp_path / "w1.npz")["params"]
    np.testing.assert_allclose(flat0, flat1, atol=1e-6)
    np.testing.assert_allclose(flat0, _jax_fit(kind), atol=5e-4)


def _zip_step(path):
    """The step counter of a ModelSerializer zip (its meta.json)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))["iteration"]


def test_kill_one_worker_then_resume_from_checkpoint(tmp_path):
    """One worker crashes after 2 syncs; the survivor finishes its rounds
    elastically; the crashed worker restarts from its checkpoint (a
    ModelSerializer zip) at the checkpointed step and completes the
    remaining steps."""
    inputs = _inputs(tmp_path)
    coord = ClusterCoordinator(heartbeat_timeout=3.0).start()
    ckpt = str(tmp_path / "ck1")
    try:
        pa = _spawn(inputs, coord.address, "w0", "0", tmp_path / "w0.npz",
                    ckpt=str(tmp_path / "ck0"))
        pb = _spawn(inputs, coord.address, "w1", "1", tmp_path / "w1.npz",
                    ckpt=ckpt, crash_at="2")
        _wait(pb)
        assert pb.returncode == 1  # crashed as scripted
        assert _zip_step(ckpt) == 2, "no checkpoint of step 2"
        err = _wait(pa)
        assert pa.returncode == 0, err
        pb2 = _spawn(inputs, coord.address, "w1", "1", tmp_path / "w1.npz",
                     ckpt=ckpt)
        err = _wait(pb2)
        assert pb2.returncode == 0, err
        out = np.load(tmp_path / "w1.npz")
        assert int(out["iteration"]) == 6  # resumed at 2, trained 3..6
        assert np.isfinite(out["params"]).all()
        assert _zip_step(ckpt) == 6
    finally:
        coord.shutdown()


def test_one_worker_run_equals_plain_fit(tmp_path):
    """Averaging through the coordinator at one worker is the identity:
    the worker's params equal a plain fit of the same batches bit for
    bit (the port's run_elastic_worker against the port's fit)."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from tests.torch_fleet_worker import build_net

    inputs = np.load(_inputs(tmp_path))
    x, y = inputs["x"][:16], inputs["y"][:16]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    coord = ClusterCoordinator(heartbeat_timeout=10.0).start()
    try:
        plain = build_net(inputs)
        for _ in range(3):
            plain.fit(DataSet(x, y))
        net = tcluster.run_elastic_worker(
            coord.address, "solo", build_net(inputs),
            [DataSet(x, y)] * 3, sync_every=1,
            checkpoint_path=str(tmp_path / "ck"))
    finally:
        coord.shutdown()
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(net.params_flat(), plain.params_flat())
    assert net.iteration_count == 3


def test_coordinator_snapshot_roundtrip(tmp_path):
    snap = str(tmp_path / "coord.json")
    c1 = ClusterCoordinator(heartbeat_timeout=5.0, snapshot_path=snap).start()
    try:
        a = ClusterClient(c1.address, "wA", heartbeat_interval=0.2)
        b = ClusterClient(c1.address, "wB", heartbeat_interval=0.2)
        a.set_config("training", {"lr": 0.1})
        sa, sb = a.claim_slot(2), b.claim_slot(2)
        assert {sa, sb} == {0, 1}
        a.close(deregister=False)
        b.close(deregister=False)
    finally:
        c1.shutdown()
    data = json.load(open(snap))
    assert data["ranks"] == {"wA": 0, "wB": 1}
    assert data["configs"]["training"] == {"lr": 0.1}
    assert data["configs"][f"shard_owner/{sa}"] == "wA"
    assert sorted(data["workers"]) == ["wA", "wB"]

    c2 = ClusterCoordinator(heartbeat_timeout=5.0, snapshot_path=snap).start()
    try:
        a2 = ClusterClient(c2.address, "wA", heartbeat_interval=0.2)
        assert a2.rank == 0
        assert a2.get_config("training") == {"lr": 0.1}
        assert a2.claim_slot(2) == sa
        c = ClusterClient(c2.address, "wC", heartbeat_interval=0.2)
        assert c.claim_slot(2) is None
        a2.close()
        c.close()
    finally:
        c2.shutdown()


def test_kill_coordinator_and_restart_preserves_claims(tmp_path):
    snap = str(tmp_path / "coord.json")
    c1 = ClusterCoordinator(heartbeat_timeout=5.0, round_timeout=10.0,
                            snapshot_path=snap).start()
    port = c1.port
    a = ClusterClient(c1.address, "wA", heartbeat_interval=0.2,
                      reconnect_timeout=30.0)
    b = ClusterClient(c1.address, "wB", heartbeat_interval=0.2,
                      reconnect_timeout=30.0)
    sa, sb = a.claim_slot(2), b.claim_slot(2)
    assert {sa, sb} == {0, 1}
    rank_a, rank_b = a.rank, b.rank
    c1.shutdown()
    time.sleep(0.5)
    c2 = ClusterCoordinator(port=port, heartbeat_timeout=5.0,
                            round_timeout=10.0, snapshot_path=snap).start()
    try:
        assert a.claim_slot(2) == sa
        assert b.claim_slot(2) == sb
        assert (a.rank, b.rank) == (rank_a, rank_b)
        out = _average_pair(a, b, 1, [1.0, 3.0], [3.0, 5.0])
        np.testing.assert_allclose(out["wA"], [2.0, 4.0])
        np.testing.assert_allclose(out["wB"], [2.0, 4.0])
        a.close()
        b.close()
    finally:
        c2.shutdown()


def test_claim_slot_atomic_and_elastic(coord):
    a = ClusterClient(coord.address, "wA", heartbeat_interval=0.2)
    b = ClusterClient(coord.address, "wB", heartbeat_interval=0.2)
    sa, sb = a.claim_slot(2), b.claim_slot(2)
    assert {sa, sb} == {0, 1}
    assert a.claim_slot(2) == sa
    c = ClusterClient(coord.address, "wC", heartbeat_interval=0.2)
    assert c.claim_slot(2) is None
    b.close(deregister=False)
    assert c.claim_slot(2) is None
    time.sleep(2.5)  # > the heartbeat timeout
    assert c.claim_slot(2) == sb
    a.close()
    c.close()


def test_replacement_worker_adopts_dead_rank(coord):
    a = ClusterClient(coord.address, "wA", heartbeat_interval=0.2)
    b = ClusterClient(coord.address, "wB", heartbeat_interval=0.2)
    assert (a.rank, b.rank) == (0, 1)
    b.close(deregister=False)
    rejoin = ClusterClient(coord.address, "wB", heartbeat_interval=0.2,
                           replace_dead=True)
    assert rejoin.rank == 1 and rejoin.reassigned_from is None
    rejoin.close(deregister=True)
    replacement = ClusterClient(coord.address, "wC",
                                heartbeat_interval=0.2, replace_dead=True)
    assert replacement.rank == 1 and replacement.reassigned_from == "wB"
    fresh = ClusterClient(coord.address, "wD", heartbeat_interval=0.2)
    assert fresh.rank == 2
    a.close()
    replacement.close()
    fresh.close()


def test_rank_reassignment_persists_in_snapshot(tmp_path):
    snap = str(tmp_path / "coord.json")
    c1 = ClusterCoordinator(heartbeat_timeout=1.0,
                            snapshot_path=snap).start()
    port = c1.port
    try:
        a = ClusterClient(c1.address, "wA", heartbeat_interval=0.2)
        b = ClusterClient(c1.address, "wB", heartbeat_interval=0.2)
        b.close(deregister=True)
        c = ClusterClient(c1.address, "wC", heartbeat_interval=0.2,
                          replace_dead=True)
        assert c.rank == 1 and c.reassigned_from == "wB"
        a.close()
        c.close()
    finally:
        c1.shutdown()
    c2 = ClusterCoordinator(port=port, heartbeat_timeout=1.0,
                            snapshot_path=snap).start()
    try:
        assert c2._ranks == {"wA": 0, "wC": 1}
    finally:
        c2.shutdown()


def test_drop_heartbeat_fault_silences_worker(coord, monkeypatch):
    """The injected drop-heartbeat fault (distributed/faults.py): the
    process stays alive but goes silent, the coordinator reaps it after
    heartbeat_timeout, and its claim becomes stealable."""
    from deeplearning4j_tpu_torch.distributed import bootstrap

    monkeypatch.setenv(bootstrap.ENV_FAULTS, "p1:drop-heartbeat")
    monkeypatch.setenv(bootstrap.ENV_PROCESS_ID, "0")
    healthy = ClusterClient(coord.address, "wA", heartbeat_interval=0.2)
    slot = healthy.claim_slot(2)
    monkeypatch.setenv(bootstrap.ENV_PROCESS_ID, "1")
    silent = ClusterClient(coord.address, "wSilent", heartbeat_interval=0.2)
    silent_slot = silent.claim_slot(2)
    monkeypatch.setenv(bootstrap.ENV_PROCESS_ID, "0")
    assert {slot, silent_slot} == {0, 1}
    assert sorted(coord.alive_workers()) == ["wA", "wSilent"]
    time.sleep(2.5)
    assert sorted(coord.alive_workers()) == ["wA"]
    taker = ClusterClient(coord.address, "wB", heartbeat_interval=0.2)
    assert taker.claim_slot(2) == silent_slot
    healthy.close()
    taker.close()
    silent.close(deregister=False)


# ----------------------------------------------------------- vocabulary

def test_build_vocab_distributed_identical_across_workers():
    """Every worker ends with the same cache from disjoint corpus shards
    (counts, index order, Huffman codes), equal to a single-host build
    over the full corpus and to the JAX package's."""
    from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JaxVC
    from deeplearning4j_tpu_torch.nlp.distributed_vocab import (
        build_vocab_distributed,
    )
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    rng = np.random.default_rng(0)
    sents = [[f"w{int(i)}" for i in rng.integers(0, 200, 12)]
             for _ in range(2000)]
    shards = [sents[0::2], sents[1::2]]
    coord = ClusterCoordinator(heartbeat_timeout=10.0).start()
    clients = [ClusterClient(coord.address, w) for w in ("wA", "wB")]
    results = {}

    def worker(client, shard):
        results[client.worker_id] = build_vocab_distributed(
            client, shard, min_word_frequency=2, build_huffman=True)

    try:
        ts = [threading.Thread(target=worker, args=(c, s))
              for c, s in zip(clients, shards)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        for c in clients:
            c.close()
        coord.shutdown()
    ref = (VocabConstructor(min_word_frequency=2, build_huffman=True)
           .add_source(sents).build_joint_vocabulary())
    jref = (JaxVC(min_word_frequency=2, build_huffman=True)
            .add_source(sents).build_joint_vocabulary())
    assert set(results) == {"wA", "wB"}
    assert ref.words() == jref.words()
    for cache in results.values():
        assert cache.words() == ref.words()
        assert cache.n_sequences == len(sents)
        for w in ref.words():
            got, want = cache.word_for(w), jref.word_for(w)
            assert got.count == want.count
            assert getattr(got, "codes", None) == getattr(want, "codes", None)
            assert getattr(got, "points", None) == getattr(want, "points",
                                                           None)


# ------------------------------------------------- across the two packages

@pytest.mark.parametrize("coordinator", ["jax", "port"])
def test_port_and_jax_clients_average_through_either_coordinator(coordinator):
    """A port client and a JAX client register with one coordinator (the
    JAX package's or the port's), share a config and average a vector
    together."""
    mod = jcluster if coordinator == "jax" else tcluster
    coord = mod.ClusterCoordinator(heartbeat_timeout=10.0).start()
    try:
        a = tcluster.ClusterClient(coord.address, "port")
        b = jcluster.ClusterClient(coord.address, "jax")
        assert {a.rank, b.rank} == {0, 1}
        a.set_config("k", {"v": [1, 2]})
        assert b.get_config("k") == {"v": [1, 2]}
        vec_a = np.arange(1000, dtype=np.float32)
        vec_b = -np.arange(1000, dtype=np.float32) * 3
        out = _average_pair(a, b, 1, vec_a, vec_b)
        np.testing.assert_array_equal(out["port"], out["jax"])
        np.testing.assert_array_equal(out["port"],
                                      np.mean([vec_a, vec_b], axis=0))
        a.close()
        b.close()
    finally:
        coord.shutdown()


def _transcript(mod, requests):
    """The raw bytes a coordinator of `mod` replies to `requests` (each
    a JSON header dict and an optional payload), sent by the other
    package's `_send_msg`."""
    other = tcluster if mod is jcluster else jcluster
    coord = mod.ClusterCoordinator(heartbeat_timeout=10.0).start()
    host, port = coord.address.rsplit(":", 1)
    replies = []
    try:
        with socket.create_connection((host, int(port)), timeout=30) as s:
            f = s.makefile("rb")
            for header, payload in requests:
                other._send_msg(s, header, payload)
                line = f.readline()
                n = json.loads(line).get("payload_bytes")
                replies.append(line + (f.read(n) if n else b""))
    finally:
        coord.shutdown()
    return replies


def test_wire_protocols_agree_byte_for_byte():
    """Both packages frame a message into the same bytes, and the two
    coordinators reply to the same requests with the same bytes."""
    vec = np.linspace(-1, 1, 37, dtype=np.float32)
    requests = [
        ({"op": "register", "worker": "w0"}, None),
        ({"op": "set_config", "key": "a", "value": [1, {"b": 2}],
          "worker": "w0"}, None),
        ({"op": "get_config", "key": "a", "worker": "w0"}, None),
        ({"op": "get_config", "key": "nope", "worker": "w0"}, None),
        ({"op": "claim_slot", "n_slots": 3, "worker": "w0"}, None),
        ({"op": "workers", "worker": "w0"}, None),
        ({"op": "average", "step": 1, "worker": "w0"},
         tcluster._to_bytes(vec)),
        ({"op": "barrier", "name": "b", "worker": "w0"}, None),
        ({"op": "bogus", "worker": "w0"}, None),
        ({"op": "deregister", "worker": "w0"}, None),
    ]
    for header, payload in requests:
        a, b = socket.socketpair()
        try:
            tcluster._send_msg(a, header, payload)
            jcluster._send_msg(a, header, payload)
            a.shutdown(socket.SHUT_WR)
            data = b.makefile("rb").read()
        finally:
            a.close()
            b.close()
        assert data[:len(data) // 2] == data[len(data) // 2:]
    assert _transcript(tcluster, requests) == _transcript(jcluster, requests)
    assert tcluster.MAX_FRAME_BYTES == jcluster.MAX_FRAME_BYTES
