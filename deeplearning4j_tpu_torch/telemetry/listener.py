"""TelemetryListener: feeds the run recorder from fit() without a host
sync a step (JAX counterpart deeplearning4j_tpu/telemetry/listener.py).

A container's `score_value` converts the step's device scalar to a
float, which waits for the card. This listener keeps the raw scalar
(`model._score_raw`, no conversion) each iteration and converts the
whole window in one pass every `frequency` steps: one wait a window,
for scalars that are `frequency` steps old and long since computed.
"""

from __future__ import annotations

import time

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.telemetry.recorder import Recorder, get_default


class TelemetryListener(IterationListener):
    """A `step` event per iteration, buffered and flushed every
    `frequency` iterations (plus a `memory` snapshot a flush with
    `snapshot_memory`). Attach with `net.set_listeners(
    TelemetryListener())`; `close()` flushes the last partial window."""

    def __init__(self, recorder: Recorder | None = None,
                 frequency: int = 50, snapshot_memory: bool = False):
        self.recorder = recorder
        self.frequency = max(1, frequency)
        self.snapshot_memory = snapshot_memory
        self._pending: list[tuple[int, object, float]] = []

    def _rec(self) -> Recorder:
        return self.recorder if self.recorder is not None else get_default()

    def iteration_done(self, model, iteration):
        # the raw device scalar, not model.score_value (whose float() is
        # the per-step sync this listener avoids)
        raw = getattr(model, "_score_raw", None)
        self._pending.append((iteration, raw, time.perf_counter()))
        if len(self._pending) >= self.frequency:
            self.flush()

    def flush(self) -> None:
        """Convert the buffered window: one `step` event per iteration,
        the window's iterations a second on its last."""
        if not self._pending:
            return
        rec = self._rec()
        window, self._pending = self._pending, []
        t_first, t_last = window[0][2], window[-1][2]
        its_per_sec = None
        if len(window) > 1 and t_last > t_first:
            its_per_sec = round((len(window) - 1) / (t_last - t_first), 4)
        for i, (iteration, raw, _t) in enumerate(window):
            score = None
            if raw is not None:
                try:
                    score = float(raw)
                except (TypeError, ValueError):
                    score = None
            fields = {}
            if i == len(window) - 1 and its_per_sec is not None:
                fields["iterations_per_sec"] = its_per_sec
            rec.step(iteration, score=score, **fields)
        if self.snapshot_memory:
            rec.memory(iteration=window[-1][0])

    def close(self) -> None:
        self.flush()
