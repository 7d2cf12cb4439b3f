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
