"""Run telemetry (JAX counterpart deeplearning4j_tpu/telemetry):

* `recorder.py` — the typed JSONL event recorder (`Recorder`,
  `NullRecorder`, the process default from `$DL4J_TPU_TELEMETRY`);
* `metrics.py`  — the Prometheus /metrics registry (copied, stdlib);
* `artifact.py` — bench-artifact parsing and the summary line (copied,
  stdlib);
* `trace.py`    — the fleet timeline: shard merge, span statistics, the
  anomaly detectors, `StragglerWatch` / `MemoryWatch` (copied, stdlib).

The cost book, the memory ledger and sampler and the training listener
wait for the port's telemetry slice.
"""

from deeplearning4j_tpu_torch.telemetry.recorder import (  # noqa: F401
    ENV_VAR,
    NullRecorder,
    Recorder,
    get_default,
    set_default,
)
