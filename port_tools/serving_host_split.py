#!/usr/bin/env python3
"""Where a predict request's time goes for the replays' tiny models (the
MLP and the LM of `serving/replay.py`) on one card: the model alone, the
engine without HTTP, one HTTP round trip at a time, and the replay at
bench.py's `serving_replay` settings with one and with two replicas.

    python3 port_tools/serving_host_split.py

Prints, for each model: the median time of the inference forward plus
the fetch of its rows for a 4-row batch (synchronous; 100 calls);
`InferenceEngine.predict` one request at a time (max wait 0; 100
requests); one POST /predict at a time through `ServingServer` (50
requests); then `run_replay` (120 requests, burst 4, 2 ms gaps, max wait
4 ms) with 1 and 2 replicas: p50, p99, QPS, the client's wall clock, and
the median `forward` span and `queue_s` from its telemetry. The replay's
client threads run in the same interpreter as the server and the
replicas, so the gap between the forward alone and the forward span
under the replay is the host's share. Needs CUDA; run from the root of a
checkout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _ms(xs):
    return round(statistics.median(xs) * 1e3, 3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serving_host_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  InferenceEngine,
                                                  ServingServer)
    from deeplearning4j_tpu_torch.serving.replay import (_tiny_lm, _tiny_mlp,
                                                         run_replay)
    from deeplearning4j_tpu_torch.telemetry import Recorder

    models = (
        ("mlp", lambda: _tiny_mlp(device="cuda"), np.zeros(8, np.float32),
         BucketLattice((1, 2, 4))),
        ("lm", lambda: _tiny_lm(32, device="cuda"), np.zeros(32, np.int64),
         BucketLattice((1, 2, 4), seq_lens=(8, 16, 32))))
    for name, make, example, lattice in models:
        net = make()
        fwd = net.inference_fn()
        x = np.stack([example] * 4)
        mask = None if name == "mlp" else np.ones((4, 32), np.float32)
        alone = []
        for _ in range(100):
            t0 = time.perf_counter()
            fwd(net.params, net.state, x, mask).float().cpu().numpy()
            alone.append(time.perf_counter() - t0)
        engine = InferenceEngine(net, lattice, max_wait_ms=0.0,
                                 sequence=name == "lm",
                                 recorder=Recorder(None))
        engine.warmup(example)
        engine.start()
        predict = []
        for _ in range(100):
            t0 = time.perf_counter()
            engine.predict(example)
            predict.append(time.perf_counter() - t0)
        server = ServingServer(engine, port=0).start()
        body = json.dumps({"features": example.tolist()}).encode()
        http = []
        for _ in range(50):
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"{server.url}/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                resp.read()
            http.append(time.perf_counter() - t0)
        server.stop()
        print(f"{name}: forward+fetch {_ms(alone)} ms; engine.predict "
              f"{_ms(predict)} ms; HTTP round trip {_ms(http)} ms",
              flush=True)
    for model in ("mlp", "lm"):
        for replicas in (1, 2):
            tpath = Path(tempfile.mkdtemp(prefix="host_split_")) / "t.jsonl"
            sb = run_replay(model=model, seed=0, n_requests=120, burst=4,
                            mean_gap_s=0.002, lengths=(8, 16, 32),
                            batch_sizes=(1, 2, 4), max_wait_ms=4.0,
                            replicas=replicas, telemetry_path=str(tpath),
                            device="cuda")
            events = [json.loads(l) for l in tpath.read_text().splitlines()
                      if l.startswith("{")]
            spans = [e["seconds"] for e in events if e.get("event") == "span"
                     and e.get("name") == "forward"]
            queue = [e["queue_s"] for e in events
                     if e.get("event") == "request"]
            print(f"replay {model} replicas={replicas}: p50 {sb['p50_ms']} "
                  f"p99 {sb['p99_ms']} qps {sb['qps']} wall "
                  f"{sb['client']['wall_s']} s; forward span median "
                  f"{_ms(spans)} ms over {len(spans)}; queue_s median "
                  f"{_ms(queue)} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
