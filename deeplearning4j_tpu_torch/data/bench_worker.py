"""Fleet worker for the input-pipeline bench (JAX counterpart
deeplearning4j_tpu/data/bench_worker.py, bench.py's `input_pipeline`
mode).

Run under `distributed/launcher.launch_local` (one device a process) or
standalone as one process: every process trains the SAME small MLP
through the stock `fit()` path over its `ShardedDataSetIterator` shard
(a data mesh over the fleet), alternating two arms —

- **sync**: prefetch depth 0 — batch decode and conversion run inline
  in the step loop;
- **pipelined**: a depth-k bounded queue — decode, conversion and the
  copy to the device on the prefetch thread, overlapping the step.

Two workloads bracket the regimes. The record-fetch stand-in has an
IO-latency wait (the blocking read a real record reader pays, which
holds no core) plus numpy decode passes:

- **input-bound**: the fetch costs more than the step; the headline is
  the pipelined/sync wall ratio;
- **compute-bound**: a trivial fetch; the obligation is a steady-state
  `input_wait` p99 of about 0, read from the in-memory telemetry
  `input_wait` spans alone.

Arms are interleaved (sync, pipelined, sync, ...) per repeat so drift
hits both equally; the headline is the MEDIAN of per-repeat ratios.
Process 0 prints one ``RESULT {json}`` line.

    python -m deeplearning4j_tpu_torch.data.bench_worker ['{json}']

The optional json overrides `run_bench` keywords (``device`` among
them: CUDA unless it says ``cpu``).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np


def _percentile(vals, q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def _build_net(device, seed: int = 5):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(0.01)
        .updater(Updater.SGD)
        .list()
        .layer(DenseLayer(n_in=64, n_out=128, activation="tanh"))
        .layer(DenseLayer(n_in=128, n_out=128, activation="tanh"))
        .layer(OutputLayer(n_in=128, n_out=10, activation="softmax",
                           loss_function="mcxent"))
        .build()
    )
    return MultiLayerNetwork(conf, device=device).init()


def _decode_preprocessor(passes: int, io_s: float, seed: int = 17):
    """The record fetch+decode stand-in: a blocking wait of ``io_s``
    seconds then ``passes`` numpy decode passes over the batch features,
    in place. Runs wherever the iterator's `next()` runs — the step
    thread in the sync arm, the prefetch thread in the pipelined arm."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((64, 64)).astype(np.float32) * 0.1

    def pre(ds):
        if io_s > 0:
            time.sleep(io_s)
        f = ds.features
        for _ in range(passes):
            f = np.tanh(f @ mix)
            f = (f - f.mean()) / (f.std() + 1e-6)
        ds.features = f.astype(np.float32)

    return pre


def _make_iterator(global_batch, steps, decode_passes, io_s, *,
                   process_index, process_count, seed):
    from deeplearning4j_tpu_torch.data.pipeline import ShardedDataSetIterator

    n = global_batch * steps
    rng = np.random.default_rng(seed)
    x = rng.random((n, 64), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    it = ShardedDataSetIterator(x, y, global_batch,
                                process_index=process_index,
                                process_count=process_count, seed=seed)
    it.set_pre_processor(_decode_preprocessor(decode_passes, io_s))
    return it


def _timed_fit(net, it) -> float:
    import torch

    t0 = time.perf_counter()
    net.fit(it, epochs=1)
    if net.device.type == "cuda":
        torch.cuda.synchronize(net.device)
    return time.perf_counter() - t0


def run_bench(*, process_index: int = 0, process_count: int = 1,
              mesh=None, device=None, steps: int = 12, repeats: int = 3,
              global_batch: int = 32, depth: int = 2,
              input_bound_passes: int = 8, input_bound_io_s: float = 0.075,
              compute_bound_passes: int = 1,
              compute_bound_io_s: float = 0.0002, seed: int = 23) -> dict:
    """Both workloads, both arms, interleaved. Returns the result dict
    (every process computes it — the fleet must run the identical step
    sequence to keep its collectives in lockstep)."""
    from deeplearning4j_tpu_torch.data.pipeline import set_prefetch_depth
    from deeplearning4j_tpu_torch.telemetry.recorder import (
        Recorder,
        set_default,
    )

    net = _build_net(device if mesh is None else mesh.device)
    if mesh is not None:
        net.set_mesh(mesh)

    def fresh_it(passes, io_s=0.0):
        return _make_iterator(global_batch, steps, passes, io_s,
                              process_index=process_index,
                              process_count=process_count, seed=seed)

    # a local recorder for this run's input_wait spans
    rec = Recorder(path=None, keep=16384)
    prev_rec = set_default(rec)
    result = {"process_id": process_index, "n_processes": process_count,
              "steps": steps, "repeats": repeats, "depth": depth,
              "global_batch": global_batch, "device": str(net.device)}
    prev = set_prefetch_depth(0)
    try:
        net.fit(fresh_it(1), epochs=1)  # warmup, outside every timing
        for name, passes, io_s in (
                ("input_bound", input_bound_passes, input_bound_io_s),
                ("compute_bound", compute_bound_passes,
                 compute_bound_io_s)):
            sync_s, pipe_s = [], []
            wait_events = []
            for _ in range(repeats):
                set_prefetch_depth(0)
                sync_s.append(_timed_fit(net, fresh_it(passes, io_s)))
                set_prefetch_depth(depth)
                n0 = len(rec.events)
                pipe_s.append(_timed_fit(net, fresh_it(passes, io_s)))
                wait_events.extend(
                    e for e in list(rec.events)[n0:]
                    if e.get("event") == "span"
                    and e.get("name") == "input_wait"
                    and e.get("pipelined"))
            ratios = sorted(s / p for s, p in zip(sync_s, pipe_s))
            # steady state: drop each repeat's FIRST dequeue (the cold
            # fill before the producer gets ahead)
            waits = [e["seconds"] for i, e in enumerate(wait_events)
                     if i % (steps + 1) != 0]
            result[name] = {
                "sync_s": [round(s, 4) for s in sync_s],
                "pipelined_s": [round(s, 4) for s in pipe_s],
                "speedup": round(statistics.median(ratios), 4),
                "ratio_spread": [round(ratios[0], 4),
                                 round(ratios[-1], 4)],
                "sync_step_ms": round(
                    1000 * statistics.median(sync_s) / steps, 3),
                "pipelined_step_ms": round(
                    1000 * statistics.median(pipe_s) / steps, 3),
                "input_wait_p50_ms": round(
                    1000 * _percentile(waits, 0.50), 3),
                "input_wait_p99_ms": round(
                    1000 * _percentile(waits, 0.99), 3),
                "n_wait_spans": len(waits),
            }
    finally:
        set_prefetch_depth(prev)
        set_default(prev_rec)
    return result


def main(argv=None) -> int:
    """Run the bench as one process of a fleet (the launcher's env
    contract present: a data mesh over every rank) or alone."""
    from deeplearning4j_tpu_torch.distributed import bootstrap

    argv = sys.argv[1:] if argv is None else argv
    overrides = json.loads(argv[0]) if argv else {}
    process_index, process_count, mesh = 0, 1, None
    if bootstrap.env_contract_present():
        info = bootstrap.initialize(device=overrides.get("device"))
        process_index = info["process_id"]
        process_count = info["num_processes"]
        from deeplearning4j_tpu_torch.distributed.global_mesh import (
            make_global_mesh,
        )

        mesh = make_global_mesh({"data": -1})
    try:
        result = run_bench(process_index=process_index,
                           process_count=process_count, mesh=mesh,
                           **overrides)
    finally:
        bootstrap.shutdown()
    if process_index == 0:
        print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
