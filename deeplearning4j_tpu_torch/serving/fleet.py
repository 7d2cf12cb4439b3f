"""The published-weights store (JAX counterpart
deeplearning4j_tpu/serving/fleet.py `WeightSet`, `WeightStore`). The
engine's workers read their params through it once per step, and
`stats()["weights"]` reports it. The rest of the JAX module — hot-swap,
the supervisor's reap/respawn, fault injection and autoscaling — waits
for the port's fleet slice.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class WeightSet:
    """One immutable published param set: a worker that read it serves
    all of it."""

    generation: int
    step: int
    params: Any
    state: Any


class WeightStore:
    """The double buffer behind live hot-swap. `current` is one attribute
    read of an immutable `WeightSet`; `publish` builds the new set
    completely before the one-reference flip, so a reader sees the old
    or the new generation, never a mix. Publishers serialize on a lock;
    readers never lock."""

    def __init__(self, params, state, step: int = 0):
        self._current = WeightSet(0, int(step), params, state)
        self._lock = threading.Lock()
        self.last_swap_ts: Optional[float] = None

    @property
    def current(self) -> WeightSet:
        return self._current

    @property
    def generation(self) -> int:
        return self._current.generation

    @property
    def step(self) -> int:
        return self._current.step

    def publish(self, params, state, step: int) -> WeightSet:
        """Flip to a new generation; the assignment is the swap."""
        with self._lock:
            new = WeightSet(self._current.generation + 1, int(step),
                            params, state)
            self._current = new
            self.last_swap_ts = time.time()
            return new

    def describe(self) -> dict:
        return {"generation": self.generation, "step": self.step,
                "last_swap_ts": self.last_swap_ts}
