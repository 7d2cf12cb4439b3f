"""The port's sharded input pipeline (data/sharding.py, data/pipeline.py,
data/bench_worker.py) against the JAX package's on the CPU.

The shard assignment is pure numpy in both packages: the same
(n_examples, global_batch, process, seed, epoch, step) must name the
same rows, exactly, at 1, 2 and 4 processes. The pipelined `fit` must
leave the params bit for bit where the synchronous one does (one
intra-op thread: the CPU's threaded reductions do not repeat bit for
bit). The bench worker runs at 2 gloo ranks under the launcher's
deadline.
"""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import pipeline as jpipe
from deeplearning4j_tpu.data import sharding as jshard
from deeplearning4j_tpu_torch.data import pipeline, sharding
from deeplearning4j_tpu_torch.data.pipeline import (
    ShardedDataSetIterator,
    iter_prefetched,
    prefetch_depth,
    set_prefetch_depth,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.distributed.launcher import launch_local
from deeplearning4j_tpu_torch.telemetry import Recorder

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


def _datasets(n, seed=0, rows=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.standard_normal((rows, 3)).astype(np.float32)
        x[0, 0] = float(i)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)]
        out.append(DataSet(x, y))
    return out


# -------------------------------------------------------------- sharding

@pytest.mark.parametrize("n_procs", [1, 2, 4])
def test_shard_assignment_equals_jax(n_procs):
    """Global windows, local rows and the N -> N' view of each process,
    over two epochs, equal to the JAX package's."""
    for n_examples, batch, seed in ((96, 16, 5), (50, 8, 1)):
        for p in range(n_procs):
            a = sharding.ShardAssignment(n_examples, batch, process_index=p,
                                         process_count=n_procs, seed=seed)
            j = jshard.ShardAssignment(n_examples, batch, process_index=p,
                                       process_count=n_procs, seed=seed)
            assert a.steps_per_epoch == j.steps_per_epoch
            for epoch in (0, 1):
                for step in range(a.steps_per_epoch):
                    np.testing.assert_array_equal(
                        a.global_indices(epoch, step),
                        j.global_indices(epoch, step))
                    np.testing.assert_array_equal(
                        a.local_indices(epoch, step),
                        j.local_indices(epoch, step))
            np.testing.assert_array_equal(
                a.for_process(0, 1).local_indices(1, 0),
                j.for_process(0, 1).local_indices(1, 0))
    np.testing.assert_array_equal(sharding.epoch_permutation(100, 3, 11),
                                  jshard.epoch_permutation(100, 3, 11))
    x = np.arange(24).reshape(8, 3)
    for p in range(n_procs) if 8 % n_procs == 0 else ():
        np.testing.assert_array_equal(sharding.local_rows(x, p, n_procs),
                                      jshard.local_rows(x, p, n_procs))
        assert (sharding.process_slice(8, p, n_procs)
                == jshard.process_slice(8, p, n_procs))


@pytest.mark.parametrize("call,match", [
    (lambda m: m.process_slice(9, 0, 2), "do not split"),
    (lambda m: m.process_slice(8, 2, 2), "out of range"),
    (lambda m: m.ShardAssignment(8, 16), "exceeds"),
    (lambda m: m.ShardAssignment(32, 9, process_index=0, process_count=2),
     "do not split"),
    (lambda m: m.ShardAssignment(32, 0), "must be >= 1"),
])
def test_sharding_errors_equal_jax(call, match):
    msgs = []
    for mod in (sharding, jshard):
        with pytest.raises(ValueError, match=match) as info:
            call(mod)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n_procs", [1, 2, 4])
def test_sharded_iterator_equals_jax(n_procs):
    """Each process's ShardedDataSetIterator yields the rows the JAX
    package's yields, step by step; reset() replays the epoch and
    set_epoch re-keys it; the batches are process-local at N > 1."""
    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    y = np.eye(2, dtype=np.float32)[np.arange(32) % 2]
    for p in range(n_procs):
        it = ShardedDataSetIterator(x, y, 8, process_index=p,
                                    process_count=n_procs, seed=3)
        jt = jpipe.ShardedDataSetIterator(x, y, 8, process_index=p,
                                          process_count=n_procs, seed=3)
        assert it.process_local == (n_procs > 1)
        assert (it.batch(), it.total_examples()) == (jt.batch(),
                                                     jt.total_examples())
        for epoch in (0, 1):
            it.set_epoch(epoch)
            jt.set_epoch(epoch)
            while jt.has_next():
                assert it.has_next()
                a, b = it.next(), jt.next()
                np.testing.assert_array_equal(a.features, b.features)
                np.testing.assert_array_equal(a.labels, b.labels)
            assert not it.has_next()
        it.reset()
        jt.reset()
        np.testing.assert_array_equal(it.next().features,
                                      jt.next().features)


# ------------------------------------------------------- iter_prefetched

def test_iter_prefetched_preserves_order_and_converts_off_thread():
    data = _datasets(5)
    threads = []

    def convert(ds):
        threads.append(threading.current_thread())
        return float(ds.features[0, 0])

    out = [b for _ds, b in iter_prefetched(ListDataSetIterator(data),
                                           convert, depth=2)]
    assert out == [float(d.features[0, 0]) for d in data]
    assert all(t is not threading.main_thread() for t in threads)
    threads.clear()
    out = list(iter_prefetched(ListDataSetIterator(data), convert, depth=0))
    assert len(out) == 5
    assert all(t is threading.main_thread() for t in threads)
    it = ListDataSetIterator(data)
    it.async_supported = lambda: False
    threads.clear()
    assert len(list(iter_prefetched(it, convert, depth=4))) == 5
    assert all(t is threading.main_thread() for t in threads)


def test_iter_prefetched_reraises_producer_error():
    """A conversion error reaches the step loop where its batch would
    have, after the batches before it; the producer thread is gone."""
    def convert(ds):
        if float(ds.features[0, 0]) >= 2.0:
            raise RuntimeError("decode failed")
        return ds

    consumed = 0
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="decode failed"):
        for _ds, _b in iter_prefetched(ListDataSetIterator(_datasets(4)),
                                       convert, depth=2):
            consumed += 1
    assert consumed == 2
    assert threading.active_count() <= before


def test_iter_prefetched_records_input_wait_spans():
    rec = Recorder(path=None)
    list(iter_prefetched(ListDataSetIterator(_datasets(4)), lambda ds: ds,
                         depth=2, recorder=rec))
    spans = [e for e in rec.events
             if e.get("event") == "span" and e.get("name") == "input_wait"]
    assert len(spans) == 5  # one a dequeue, the end-of-stream one too
    assert all(s["pipelined"] and "buffered" in s for s in spans)
    sync = Recorder(path=None)
    list(iter_prefetched(ListDataSetIterator(_datasets(4)), lambda ds: ds,
                         depth=0, recorder=sync))
    spans = [e for e in sync.events
             if e.get("event") == "span" and e.get("name") == "input_wait"]
    assert len(spans) == 4 and not any(s["pipelined"] for s in spans)


def test_prefetch_depth_resolution_chain(monkeypatch):
    assert pipeline.DEFAULT_DEPTH == jpipe.DEFAULT_DEPTH
    assert pipeline.ENV_DEPTH == jpipe.ENV_DEPTH
    assert prefetch_depth(5) == 5
    prev = set_prefetch_depth(3)
    try:
        assert prefetch_depth() == 3 and prefetch_depth(1) == 1
    finally:
        set_prefetch_depth(prev)
    monkeypatch.setenv("DL4J_TPU_PREFETCH_DEPTH", "7")
    assert prefetch_depth() == 7
    monkeypatch.setenv("DL4J_TPU_PREFETCH_DEPTH", "nope")
    with pytest.raises(ValueError, match="not an integer"):
        prefetch_depth()


# ------------------------------------------------------------- fit

def _mln():
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(13).learning_rate(0.05)
            .list()
            .layer(DenseLayer(n_in=3, n_out=8, activation="tanh",
                              dropout=0.2))
            .layer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                               loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _lm():
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    return transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_length=16, dropout=0.1,
                          device="cpu").init(2)


def _token_sets(n):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 64, (4, 16)).astype(np.int32)
        out.append(DataSet(toks, np.roll(toks, -1, axis=1)))
    return out


@pytest.mark.parametrize("build,data", [(_mln, lambda: _datasets(6, 1)),
                                        (_lm, lambda: _token_sets(4))],
                         ids=["multilayer", "graph-lm"])
def test_pipelined_fit_bit_identical_to_sync(build, data):
    """Pipelined fit (depth 2: conversion on the producer thread) and
    synchronous fit (depth 0) of the same net over the same batches,
    with dropout drawing from the net's generator: the same params bit
    for bit, the same step count."""
    batches = data()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = set_prefetch_depth(0)
    try:
        sync_net = build()
        sync_net.fit(ListDataSetIterator(list(batches)), epochs=3)
        set_prefetch_depth(2)
        pipe_net = build()
        pipe_net.fit(ListDataSetIterator(list(batches)), epochs=3)
    finally:
        set_prefetch_depth(prev)
        torch.set_num_threads(threads)
    assert sync_net.params_flat().tobytes() == pipe_net.params_flat().tobytes()
    assert sync_net.iteration_count == pipe_net.iteration_count
    assert sync_net.iteration_count == 3 * len(batches)


def test_fit_surfaces_producer_error():
    """An iterator that fails mid-epoch: fit raises its error after the
    batches before it trained."""
    class Failing(ListDataSetIterator):
        def next(self, num=None):
            if self._i == 2:
                raise RuntimeError("record decode failed")
            return super().next(num)

    net = _mln()
    with pytest.raises(RuntimeError, match="record decode failed"):
        net.fit(Failing(_datasets(6, 3)), epochs=1)
    assert net.iteration_count == 2


# ------------------------------------------------------- bench worker

def test_bench_worker_single_process():
    """The input-pipeline bench core in this process: both workloads,
    both arms through the stock fit path, every headline field, the
    steady-state wait percentiles from the expected span count."""
    from deeplearning4j_tpu_torch.data.bench_worker import run_bench

    r = run_bench(device="cpu", steps=3, repeats=1, input_bound_passes=1,
                  input_bound_io_s=0.002, compute_bound_passes=1,
                  compute_bound_io_s=0.0)
    assert r["n_processes"] == 1 and r["depth"] == 2
    for workload in ("input_bound", "compute_bound"):
        w = r[workload]
        assert w["speedup"] > 0
        assert w["ratio_spread"][0] <= w["speedup"] <= w["ratio_spread"][1]
        assert w["input_wait_p99_ms"] >= w["input_wait_p50_ms"] >= 0
        assert w["n_wait_spans"] == 3


def test_bench_worker_at_two_ranks():
    """The bench worker as a 2-rank gloo fleet under the launcher
    (deadline 120 s): both ranks exit clean, rank 0 alone prints the
    RESULT line, with every headline field, for the global batch of 32
    the ranks split (no timing is held here: a CPU's times say nothing
    of the card's)."""
    overrides = json.dumps({"steps": 4, "repeats": 1, "device": "cpu",
                            "input_bound_io_s": 0.02})
    res = launch_local(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.data.bench_worker",
         overrides], 2, device="cpu", timeout=120.0, death_grace=5.0,
        cwd=ROOT, extra_env={"PYTHONPATH": str(ROOT),
                             "OMP_NUM_THREADS": "1"})
    assert all(r.exit_class == "clean" for r in res), res[0].output
    payload = next(json.loads(line[len("RESULT "):])
                   for line in res[0].lines if line.startswith("RESULT "))
    assert not any(line.startswith("RESULT ") for line in res[1].lines)
    assert payload["n_processes"] == 2 and payload["global_batch"] == 32
    for workload in ("input_bound", "compute_bound"):
        w = payload[workload]
        assert w["speedup"] > 0 and w["n_wait_spans"] == 4
        assert w["input_wait_p99_ms"] >= w["input_wait_p50_ms"] >= 0
