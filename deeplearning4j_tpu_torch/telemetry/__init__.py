"""Run telemetry (JAX counterpart deeplearning4j_tpu/telemetry):

* `recorder.py` — the typed JSONL event recorder (`Recorder`,
  `NullRecorder`, the process default from `$DL4J_TPU_TELEMETRY`) and
  the registered schema (`EVENT_KINDS`, `SPAN_NAMES`);
* `metrics.py`  — the Prometheus /metrics registry (copied, stdlib);
* `artifact.py` — bench-artifact parsing and the summary line (copied,
  stdlib);
* `trace.py`    — the fleet timeline: shard merge, span statistics, the
  anomaly detectors, `StragglerWatch` / `MemoryWatch` (copied, stdlib);
* `memstat.py`  — `MemoryLedger` and `MemorySampler`, the `memory`
  events from the card's allocator;
* `costbook.py` — `CostBook`, the counted flops and peak temporary bytes
  of each warmed step (`cost` events), MFU and `cost_drift`;
* `listener.py` — `TelemetryListener`, `step` events from fit().

The last five resolve lazily, as in the JAX package.
"""

from deeplearning4j_tpu_torch.telemetry.recorder import (  # noqa: F401
    ENV_VAR,
    EVENT_KINDS,
    SPAN_NAMES,
    NullRecorder,
    Recorder,
    get_default,
    set_default,
)


def __getattr__(name):
    if name == "TelemetryListener":
        from deeplearning4j_tpu_torch.telemetry.listener import (
            TelemetryListener,
        )
        return TelemetryListener
    if name in ("MemoryLedger", "MemorySampler"):
        from deeplearning4j_tpu_torch.telemetry import memstat
        return getattr(memstat, name)
    if name == "CostBook":
        from deeplearning4j_tpu_torch.telemetry.costbook import CostBook
        return CostBook
    if name in ("trace", "metrics", "memstat", "costbook", "listener"):
        import importlib
        return importlib.import_module(
            f"deeplearning4j_tpu_torch.telemetry.{name}")
    raise AttributeError(name)
