"""Iteration listeners (JAX counterpart
deeplearning4j_tpu/optimize/listeners.py; reference
optimize/api/IterationListener.java `iterationDone(Model, int)`,
listeners/ScoreIterationListener.java,
ParamAndGradientIterationListener.java).

Both containers fire `iteration_done(net, iteration)` after every
optimizer step of `fit` (each TBPTT segment is a step), once per
minibatch on the Solver path, and once per epoch with the epoch's mean
score from `fit_scanned`. A solver's own listeners get the optimizer
instead, once per line-searched iteration.
"""

from __future__ import annotations

import logging
import time

from deeplearning4j_tpu_torch.nn.tree import leaves

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10, printer=None):
        self.n = max(1, print_iterations)
        self.printer = printer or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration):
        if iteration % self.n == 0:
            self.printer(f"Score at iteration {iteration} is {model.score_value}")


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs in memory (reference
    CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class PerformanceListener(IterationListener):
    """Iterations/s between reports, and with `examples_per_iteration`
    examples/s; with `flops_per_example` and the card's `peak_flops`
    also the MFU. Reading the score synchronizes with the card, so a
    report costs one sync. The last report's numbers are kept on
    `last_stats`."""

    def __init__(self, frequency: int = 10, printer=None,
                 examples_per_iteration: int = 0,
                 flops_per_example: float = 0.0, peak_flops: float = 0.0):
        self.frequency = max(1, frequency)
        self.printer = printer or (lambda s: logger.info(s))
        self.examples_per_iteration = examples_per_iteration
        self.flops_per_example = flops_per_example
        self.peak_flops = peak_flops
        self.last_stats = {}
        self._last_time = None
        self._last_iter = 0

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            its = iteration - self._last_iter
            if dt > 0 and its > 0:
                ips = its / dt
                msg = f"iter {iteration}: {ips:.2f} it/s"
                stats = {"iterations_per_sec": ips,
                         "score": float(model.score_value)}
                if self.examples_per_iteration:
                    eps = ips * self.examples_per_iteration
                    stats["examples_per_sec"] = eps
                    msg += f", {eps:.1f} ex/s"
                    if self.flops_per_example and self.peak_flops:
                        mfu = eps * self.flops_per_example / self.peak_flops
                        stats["mfu"] = mfu
                        msg += f", MFU {mfu:.1%}"
                self.printer(msg + f", score {model.score_value:.5f}")
                self.last_stats = stats
            self._last_time, self._last_iter = now, iteration
        elif self._last_time is None:
            self._last_time, self._last_iter = now, iteration


class ParamAndGradientIterationListener(IterationListener):
    """Parameter statistics per iteration (reference
    ParamAndGradientIterationListener; the gradients live inside the
    step, so this reports each parameter's mean, largest magnitude and
    L2 norm)."""

    def __init__(self, frequency: int = 1, printer=None):
        self.frequency = max(1, frequency)
        self.printer = printer or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration):
        if iteration % self.frequency:
            return
        for path, t in leaves(model.params or {}):
            a = t.detach().double()
            self.printer(
                f"iter {iteration} {'/'.join(path)}: "
                f"mean {float(a.mean()):.3e} "
                f"absmax {float(a.abs().max()):.3e} "
                f"l2 {float(a.norm()):.3e}")


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners):
        self.listeners = listeners

    def iteration_done(self, model, iteration):
        for lst in self.listeners:
            lst.iteration_done(model, iteration)
