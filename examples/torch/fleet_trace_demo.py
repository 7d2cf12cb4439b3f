"""Fleet trace timeline end to end (the port's twin of
examples/fleet_trace_demo.py): launch a fleet, merge its per-process
telemetry shards, print per-span statistics, run the anomaly detector,
and export a Perfetto-openable timeline.

Each worker writes its own `<path>.pN` shard (the launcher's process-id
env makes telemetry/recorder.py suffix the shared path), emitting the
registered span/event schema: a `compile` span around the first fit,
one `step` event per global step (every process stamps step N with the
SAME `step-<n>` trace id, which the straggler detector joins on) and
pipelined `input_wait` spans from the data/ prefetch channel.

On the card the fleet is one process (one card); with `--device cpu`
it is 2 ranks over gloo:

    python examples/torch/fleet_trace_demo.py [telemetry_path] [--device cpu]

Then explore the same shards by hand:

    python3 port_tools/tracetool.py stats  <telemetry_path>
    python3 port_tools/tracetool.py check  <telemetry_path>
    python3 port_tools/tracetool.py export <telemetry_path> --perfetto
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "fleet_trace_demo.jsonl")


def worker() -> None:
    """One fleet member: a tiny MLP on this process's device (the
    launcher's `DL4J_TPU_DEVICE`) trained with the elastic-style
    global-step loop, batches dequeued through the prefetch channel."""
    import numpy as np

    from deeplearning4j_tpu_torch.data.pipeline import iter_prefetched
    from deeplearning4j_tpu_torch.datasets.api import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.distributed.bootstrap import ENV_DEVICE
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.training import fit_steps
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default

    rec = get_default()
    rec.meta(role="fleet-trace-demo-worker")
    rng = np.random.default_rng(0)

    def batch(i: int) -> DataSet:
        x = rng.normal(size=(8, 12)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        return DataSet(x, y)

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device=os.environ[ENV_DEVICE]).init()
    # the first fit is the first dispatch: span-named so the merged
    # timeline shows each process's warm-up cost
    with rec.span("compile", what="first_fit"):
        net.fit(batch(0))
    fit_steps(net, batch, total_steps=8)
    # a short prefetched pass puts pipelined input_wait spans on the
    # record, the starve-proof signal the spike detector watches
    data = [batch(i) for i in range(6)]
    for _ds, _row in iter_prefetched(ListDataSetIterator(data),
                                     lambda ds: ds, depth=2,
                                     recorder=rec):
        pass
    rec.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("telemetry_path", nargs="?", default=DEFAULT_PATH)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    tpath = args.telemetry_path
    from deeplearning4j_tpu_torch.distributed.launcher import launch_local
    from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

    results = launch_local(
        [sys.executable, os.path.abspath(__file__), "--worker"],
        n_processes=1 if args.device == "cuda" else 2, device=args.device,
        timeout=300.0, extra_env={"DL4J_TPU_TELEMETRY": tpath})
    bad = [r for r in results if r.returncode != 0]
    if bad:
        for r in bad:
            print(f"[p{r.process_id}] rc={r.returncode}\n" + r.output[-2000:])
        return 1
    timeline = trace_mod.load_timeline(tpath)
    print(f"merged {len(timeline.events)} events from "
          f"{timeline.processes}")
    for (proc, name), row in sorted(trace_mod.span_stats(timeline).items()):
        print(f"  {proc:<6} {name:<14} n={row['count']:<3} "
              f"p50={row['p50_ms']:.3f}ms p99={row['p99_ms']:.3f}ms")
    findings = trace_mod.detect_anomalies(timeline)
    print(f"anomalies: {len(findings)}")
    for f in findings:
        print("  " + json.dumps(f))
    out = tpath + ".perfetto.json"
    with open(out, "w") as fh:
        json.dump(trace_mod.to_perfetto(timeline), fh)
    print(f"perfetto timeline -> {out} (open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        sys.exit(main())
