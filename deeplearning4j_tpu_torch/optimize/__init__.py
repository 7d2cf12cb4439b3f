"""Optimization: iteration listeners and the line-search and
second-order solvers (JAX counterpart deeplearning4j_tpu/optimize;
reference optimize/)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener,
    ComposableIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
)


# the run-telemetry feed is a listener like the rest, importable from
# here; it lives in telemetry/ and resolves lazily (telemetry.listener
# imports this package for IterationListener)
def __getattr__(name):
    if name == "TelemetryListener":
        from deeplearning4j_tpu_torch.telemetry.listener import (
            TelemetryListener,
        )
        return TelemetryListener
    raise AttributeError(name)
