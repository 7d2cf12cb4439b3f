"""One measured arm of a placement: a searched (or given) `Placement`
fed to `set_mesh` unmodified, then timed training steps of the
transformer LM, in a process of its own (JAX counterpart
deeplearning4j_tpu/reshard/bench_arm.py):

    python -m deeplearning4j_tpu_torch.reshard.bench_arm '<spec json>'

The spec names the placement (JSON), the LM's dims (`dims`, the builtin
"lm" profile's by default), `dtype`, `batch`, `seed`, `warm` and
`repeats` steps and the `device` ("cuda" by default). The placement's
mesh spans the process group's ranks; run alone, the process forms a
fleet of one (so a placement of one device). The arm takes `warm`
steps, then times each of `repeats` steps (the card synchronized before
and after), and prints one `RESULT {json}` line: {"placement",
"devices", "ms_per_step", "times_ms", "loss", "measured_bytes"}; the
median is `ms_per_step`. `measured_bytes` is the card's peak allocated
bytes (off the card, the net's params and optimizer state). A spec
with `predicted_bytes` (the search's winner) also reconciles that
prediction against the measurement: a `cost_drift` event on the
process recorder (telemetry/costbook.py), and `predicted_bytes` in the
result. Where the JAX arm timed the forward (its container could
not run tensor-parallel train steps), this one times the train step,
which is what the port runs.
"""

from __future__ import annotations

import json
import sys
import time


def run_arm(spec: dict) -> dict:
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.reshard.planner import Placement
    from deeplearning4j_tpu_torch.reshard.search import (
        _LM_D,
        _LM_FF,
        _LM_H,
        _LM_L,
        _LM_T,
        _LM_V,
    )

    placement = Placement.from_json(spec["placement"])
    dims = spec.get("dims") or dict(
        vocab_size=_LM_V, d_model=_LM_D, n_heads=_LM_H, n_layers=_LM_L,
        d_ff=_LM_FF, max_length=_LM_T)
    device = spec.get("device", "cuda")
    batch = int(spec.get("batch", 48))
    warm, repeats = int(spec.get("warm", 2)), int(spec.get("repeats", 8))
    net = transformer_lm(**dims, dtype=spec.get("dtype", "float32"),
                         device=device).init(int(spec.get("seed", 0)))
    net.set_mesh(placement)  # the searched winner's consumption contract
    rng = np.random.default_rng(int(spec.get("seed", 0)))
    toks = rng.integers(0, dims["vocab_size"], (batch, dims["max_length"]))
    toks = toks.astype(np.int32)
    ds = DataSet(toks, np.roll(toks, -1, axis=1))

    def sync():
        if net.device.type == "cuda":
            torch.cuda.synchronize()

    try:
        for _ in range(warm):
            net.fit(ds)
        times = []
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            net.fit(ds)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        loss = float(net.score_value)
        from deeplearning4j_tpu_torch.telemetry import costbook, get_default
        from deeplearning4j_tpu_torch.telemetry.memstat import (
            MemoryLedger,
        )

        ledger = MemoryLedger()
        ledger.register("params", lambda: net.params)
        ledger.register("opt_state", lambda: net.opt_state)
        measured = costbook.measured_peak_bytes(ledger)
    finally:
        bootstrap.shutdown()
    ordered = sorted(times)
    result = {"placement": placement.describe(),
              "devices": placement.n_devices,
              "ms_per_step": ordered[len(ordered) // 2],
              "times_ms": times, "loss": loss,
              "measured_bytes": int(measured)}
    predicted = float(spec.get("predicted_bytes") or 0.0)
    if predicted > 0:
        # the winner arm only: the search's predicted per-device bytes
        # against this arm's measured peak
        costbook.reconcile(get_default(), int(predicted),
                           measured_bytes=measured, source="placement")
        result["predicted_bytes"] = predicted
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.stderr.write("usage: bench_arm '<spec json>'\n")
        return 2
    result = run_arm(json.loads(argv[0]))
    print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
