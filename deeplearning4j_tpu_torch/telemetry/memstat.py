"""Device-memory ledger and sampler: the `memory` event's producer (JAX
counterpart deeplearning4j_tpu/telemetry/memstat.py).

* `MemoryLedger` attributes live device bytes to subsystems — params,
  optimizer state, KV-cache pages, prefetch buffers — by walking the
  tensor trees each subsystem registers (a zero-arg callable returning
  the current tree, so hot-swapped weights and respawned caches stay
  attributed). What the registered trees do not cover is the activation
  envelope: the residual between the live total and the attributed sum.
* `MemorySampler` reads the card's allocator (`torch.cuda.memory_stats`,
  `max_memory_allocated`, `mem_get_info`) and emits one ledger-annotated
  `memory` event. Off the card there are no device stats, and the live
  total is the ledger's attributed bytes, as the JAX module's is
  live-array accounting off the TPU. Sampling happens at batch
  boundaries (the fit loops' `on_step`, the serving engines' stats tick)
  or on the sampler's own daemon thread, never inside a step.

Cadence: the fit loops call `on_step(iteration)` every batch and the env
`DL4J_TPU_MEM_EVERY` (int, 0/unset = off) names the step cadence, so the
default loop pays one modulo a batch. The stats tick and the sampler
thread rate-limit through `maybe_sample` (a minimum interval on a
monotonic clock).

"The card" is CUDA once this process has initialised it: a CPU run on a
machine with a card reads no device stats and starts no CUDA context.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.telemetry.recorder import NullRecorder, Recorder

ENV_MEM_EVERY = "DL4J_TPU_MEM_EVERY"

# the ledger's closed subsystem vocabulary ("activations" is the
# residual; "other" when an explicit activation source is registered)
SUBSYSTEMS = ("params", "opt_state", "kv_pages", "prefetch",
              "activations", "other")


def _nbytes(leaf) -> int:
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, np.ndarray):
        return int(leaf.nbytes)
    return int(getattr(leaf, "nbytes", 0) or 0)


def tree_bytes(tree) -> int:
    """Total bytes over the tensors (and numpy arrays) of a nest of
    dicts, lists and tuples: attribute reads only, no device sync."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if tree is None:
        return 0
    return _nbytes(tree)


def _tree_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_count(v) for v in tree)
    return 0 if tree is None or _nbytes(tree) == 0 else 1


def on_card() -> bool:
    """True when this process has initialised CUDA (so reading the
    allocator starts nothing)."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def live_array_totals(ledger: "MemoryLedger | None" = None) \
        -> tuple[int, int]:
    """(bytes, count) live on the device: on the card the allocator's
    allocated bytes and active blocks over every device; off it the
    ledger's attributed bytes and tensors ((0, 0) without a ledger)."""
    import torch

    if on_card():
        total = count = 0
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            total += int(stats.get("allocated_bytes.all.current", 0))
            count += int(stats.get("active.all.current", 0))
        return total, count
    if ledger is None:
        return 0, 0
    return ledger.attributed_total(), ledger.attributed_count()


def device_memory_stats() -> dict:
    """{device id: {bytes_in_use, peak_bytes_in_use, bytes_limit}} on the
    card (allocated bytes, the allocator's peak since its last reset, the
    card's total memory); {} off it."""
    import torch

    if not on_card():
        return {}
    devices = {}
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        _free, total = torch.cuda.mem_get_info(d)
        devices[str(d)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_limit": int(total)}
    return devices


class MemoryLedger:
    """Attributes live device bytes to subsystems by walking registered
    tensor-tree sources at snapshot time."""

    def __init__(self):
        self._sources: dict[str, list] = {}
        self._mu = threading.Lock()

    def register(self, subsystem: str, source) -> "MemoryLedger":
        """Register a byte source under a subsystem name: a zero-arg
        callable returning a tree (tracks replacement) or a tree."""
        if subsystem not in SUBSYSTEMS:
            raise ValueError(f"unknown ledger subsystem {subsystem!r}; "
                             f"one of {SUBSYSTEMS}")
        fn = source if callable(source) else (lambda t=source: t)
        with self._mu:
            self._sources.setdefault(subsystem, []).append(fn)
        return self

    def _walk(self, measure) -> dict:
        with self._mu:
            sources = {k: list(v) for k, v in self._sources.items()}
        out = {}
        for subsystem, fns in sources.items():
            total = 0
            for fn in fns:
                try:
                    total += measure(fn())
                except Exception:
                    pass  # a failing source counts 0, never breaks a sample
            out[subsystem] = total
        return out

    def attributed(self) -> dict:
        """Per-subsystem byte totals over the registered sources."""
        return self._walk(tree_bytes)

    def attributed_total(self) -> int:
        return int(sum(self.attributed().values()))

    def attributed_count(self) -> int:
        return int(sum(self._walk(_tree_count).values()))

    def breakdown(self, live_total_bytes: int) -> dict:
        """The ledger map of one snapshot: the registered subsystems plus
        the residual, under "activations" (or "other" when an explicit
        "activations" source is registered)."""
        out = self.attributed()
        residual = max(0, int(live_total_bytes) - sum(out.values()))
        key = "other" if "activations" in out else "activations"
        out[key] = out.get(key, 0) + residual
        return out


class MemorySampler:
    """Emits ledger-annotated `memory` events at batch boundaries
    (`on_step`), on rate-limited ticks (`maybe_sample`) or on its own
    daemon thread (`start` / `stop`)."""

    def __init__(self, recorder: Recorder, ledger: MemoryLedger | None = None,
                 min_interval_s: float = 2.0,
                 mem_every: int | None = None):
        self.recorder = recorder
        self.ledger = ledger or MemoryLedger()
        self.min_interval_s = float(min_interval_s)
        if mem_every is None:
            try:
                mem_every = int(os.environ.get(ENV_MEM_EVERY, "0") or 0)
            except ValueError:
                mem_every = 0
        self.mem_every = max(0, int(mem_every))
        # guards the rate-limit clock and the peak only, never held
        # across the allocator reads or the recorder's emit
        self._mu = threading.Lock()
        self._last_mono = float("-inf")
        self._last_event: dict = {}
        self._peak_live_bytes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def enabled(self) -> bool:
        """False under a NullRecorder: nothing is read."""
        return not isinstance(self.recorder, NullRecorder)

    @property
    def peak_live_bytes(self) -> int:
        with self._mu:
            return self._peak_live_bytes

    @property
    def last(self) -> dict:
        """The latest snapshot's payload: what the engines' stats() and
        /metrics read, so a scrape never forces a walk."""
        with self._mu:
            return dict(self._last_event)

    def sample(self, source: str, **fields) -> dict:
        """One snapshot now, emitted as one `memory` event."""
        if not self.enabled:
            return {}
        live_bytes, count = live_array_totals(self.ledger)
        devices = device_memory_stats()
        ledger = self.ledger.breakdown(live_bytes)
        payload = dict(live_array_bytes=int(live_bytes),
                       live_array_count=count, devices=devices,
                       ledger=ledger,
                       ledger_total_bytes=int(sum(ledger.values())),
                       source=source)
        with self._mu:
            self._peak_live_bytes = max(self._peak_live_bytes, live_bytes)
            self._last_mono = time.monotonic()
            self._last_event = dict(payload)
        return self.recorder.event("memory", **payload, **fields)

    def maybe_sample(self, source: str, **fields) -> dict:
        """A snapshot unless one was taken within `min_interval_s`."""
        if not self.enabled:
            return {}
        with self._mu:
            due = time.monotonic() - self._last_mono >= self.min_interval_s
        return self.sample(source, **fields) if due else {}

    def on_step(self, iteration: int, **fields) -> dict:
        """The fit loops' batch-boundary hook: samples when the
        `DL4J_TPU_MEM_EVERY` cadence divides the iteration."""
        if self.mem_every <= 0 or not self.enabled:
            return {}
        if int(iteration) % self.mem_every != 0:
            return {}
        return self.sample("fit", iteration=int(iteration), **fields)

    def start(self, interval_s: float = 10.0) -> "MemorySampler":
        """A daemon thread sampling every `interval_s` (long-running
        processes with no batch boundary); `stop` ends it."""
        if self._thread is not None or not self.enabled:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(float(interval_s)):
                try:
                    self.sample("sampler")
                except Exception:
                    pass  # sampling never kills the process

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mem-sampler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


def sampler_for_net(net, recorder) -> MemorySampler:
    """The fit loops' per-net sampler: params and optimizer state on the
    ledger through late-bound callables (a restore or re-init swaps the
    trees). Rebuilt only when the process recorder changed."""
    sampler = getattr(net, "_mem_sampler", None)
    if sampler is not None and sampler.recorder is recorder:
        return sampler
    ledger = MemoryLedger()
    ledger.register("params", lambda: getattr(net, "params", None))
    ledger.register("opt_state", lambda: getattr(net, "opt_state", None))
    sampler = MemorySampler(recorder, ledger)
    try:
        net._mem_sampler = sampler
    except Exception:
        pass  # a slotted container still gets a working sampler
    return sampler
