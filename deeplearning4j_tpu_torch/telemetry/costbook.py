"""The cost book: per-(entry, shape) operation counts and peak temporary
bytes as typed `cost` events (JAX counterpart
deeplearning4j_tpu/telemetry/costbook.py).

**The count is not XLA's.** The JAX book lowers a warmed jit and reads
XLA's `cost_analysis()`, which also counts elementwise work and may
count a loop's body once; its figure is no yardstick for this one. The
port has no jit, so the book counts ONE warm call of the step itself
(`CostBook.count`, or `record` for a call it makes):

* `torch.utils.flop_counter.FlopCounterMode` counts the plain torch
  products (mm, bmm, addmm, baddbmm, convolutions, SDPA): 2·m·n·k a
  product, forward and backward. Elementwise work, reductions, norms
  and the optimizer's update count nothing.
* The hand-written kernels K1–K13 are launched through `ctypes` and the
  counter does not see them, so each wrapper adds its own analytic
  count (ops/opcount.py, the operation counts behind the kernels'
  bounds in `chip_smoke.py`) and hides its body from the counter. The
  count is therefore the same on the CPU, where the wrappers run their
  plain versions, and on the card.

`flops` is their sum; the event also carries `torch_flops`,
`kernel_flops` (by kernel), `argument_bytes`, `output_bytes` and, on
the card, `peak_temp_bytes`: the allocator's peak during the counted
call above its start (the call resets the peak counter). The count runs
once per (entry, shape), at warmup or on a fit's first dispatch, and
never in the steady state.

The book is the denominator store for MFU (`mfu`: counted flops over
the measured seconds and the device's peak, `peak_flops`) and the
measured side of the placement cost model's calibration loop:
`reconcile` emits a `cost_drift` event naming the search's predicted
per-device bytes, the measured peak and their ratio; outside
`DEFAULT_DRIFT_FACTOR` in either direction is an anomaly
(telemetry/trace.py `detect_cost_drift`).
"""

from __future__ import annotations

import contextlib
import threading

from deeplearning4j_tpu_torch.ops import opcount
from deeplearning4j_tpu_torch.telemetry.recorder import NullRecorder, Recorder

DEFAULT_DRIFT_FACTOR = 8.0

# Peak dense bf16 FLOP/s per device kind, the MFU denominator: the H100
# SXM's 989e12 at 700 W (NVIDIA's data sheet). Other devices get the
# fallback, which keeps their MFU informational (a small number), never
# a failure.
PEAK_BF16_FLOPS = {
    "H100": 989e12,
}
DEFAULT_PEAK_FLOPS = 1e12


def peak_flops(device_kind: str | None) -> float:
    """Peak FLOP/s for a device kind string (a substring match, so
    "NVIDIA H100 80GB HBM3" finds the H100)."""
    kind = device_kind or ""
    for name, peak in PEAK_BF16_FLOPS.items():
        if name in kind:
            return peak
    return DEFAULT_PEAK_FLOPS


def device_kind(device) -> str:
    """The name of a net's device: the card's name on CUDA, else the
    device type ("cpu")."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _tree_bytes(tree) -> int:
    from deeplearning4j_tpu_torch.telemetry.memstat import tree_bytes

    return tree_bytes(tree)


class _Count:
    """One counted call: the flop counter's mode and the kernels' analytic
    counts (added by ops/opcount.kernel from any thread the mode is on)."""

    def __init__(self, mode):
        self.mode = mode
        self.kernel_flops: dict = {}
        self._mu = threading.Lock()

    def add_kernel(self, label: str, ops: int) -> None:
        with self._mu:
            self.kernel_flops[label] = self.kernel_flops.get(label, 0) + ops


@contextlib.contextmanager
def count_call(device=None):
    """Count the work of the calls in the block: yields a dict that, on
    exit, holds `flops`, `torch_flops`, `kernel_flops` and (on a CUDA
    `device`) `peak_temp_bytes`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    mode = FlopCounterMode(display=False)
    count = _Count(mode)
    out: dict = {}
    opcount.begin(count)
    try:
        with mode:
            yield out
    finally:
        opcount.end(count)
    torch_flops = int(mode.get_total_flops())
    kernels = dict(sorted(count.kernel_flops.items()))
    out.update(flops=torch_flops + sum(kernels.values()),
               torch_flops=torch_flops, kernel_flops=kernels)
    if cuda:
        torch.cuda.synchronize(device)
        out["peak_temp_bytes"] = int(
            torch.cuda.max_memory_allocated(device) - start)


class CostBook:
    """Per-(entry, shape) counted costs and the `cost` event emitter. One
    book per engine or net; an (entry, shape) is counted once, so a
    re-warmed replica counts and emits nothing."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder
        # (entry, shape key) -> counted fields; `_mu` guards the dict only
        self._book: dict = {}
        self._mu = threading.Lock()

    @property
    def enabled(self) -> bool:
        return not isinstance(self.recorder, NullRecorder)

    @staticmethod
    def _key(entry: str, shape) -> tuple:
        def freeze(v):
            if isinstance(v, (list, tuple)):
                return tuple(freeze(x) for x in v)
            return v

        frozen = freeze(shape) if isinstance(shape, (list, tuple)) \
            else (shape,)
        return (entry, frozen)

    def wants(self, entry: str, shape) -> bool:
        """Whether (entry, shape) is still to be counted."""
        if not self.enabled:
            return False
        with self._mu:
            return self._key(entry, shape) not in self._book

    @contextlib.contextmanager
    def count(self, entry: str, shape, *, device=None, args=(),
              scale: int = 1, **extra):
        """Count the call in the block as (entry, shape) and emit its
        `cost` event, once: a no-op when disabled or already recorded.
        `args` are the call's inputs (their bytes are `argument_bytes`);
        the block may set `out["output"]` to its result for
        `output_bytes`. `scale` multiplies the counted flops for an entry
        that runs the counted call `scale` times (`fit_scanned`: one step
        counted, every step the same shape); the event then also carries
        `step_flops`."""
        if not self.wants(entry, shape):
            yield {}
            return
        with count_call(device) as out:
            yield out
        fields = {"flops": out["flops"] * int(scale),
                  "torch_flops": out["torch_flops"] * int(scale),
                  "kernel_flops": {k: v * int(scale) for k, v in
                                   out["kernel_flops"].items()},
                  "argument_bytes": _tree_bytes(list(args))}
        if scale != 1:
            fields["step_flops"] = out["flops"]
        if "output" in out:
            fields["output_bytes"] = _tree_bytes(out.pop("output"))
        if "peak_temp_bytes" in out:
            fields["peak_temp_bytes"] = out["peak_temp_bytes"]
        key = self._key(entry, shape)
        with self._mu:
            if key in self._book:  # lost a warmup race: keep the first
                return
            self._book[key] = dict(fields)
        self.recorder.cost(entry, list(shape) if isinstance(
            shape, (list, tuple)) else [shape], **fields, **extra)

    def record(self, entry: str, shape, fn, args, kwargs=None, *,
               device=None, **extra) -> dict:
        """Run `fn(*args, **kwargs)` once, counted as (entry, shape), and
        emit its `cost` event. Returns the event's fields ({} when
        disabled or already recorded; `fn` then does not run)."""
        if not self.wants(entry, shape):
            return {}
        with self.count(entry, shape, device=device, args=args,
                        **extra) as out:
            out["output"] = fn(*args, **(kwargs or {}))
        return self.entries().get(self._key(entry, shape), {})

    # ------------------------------------------------------------- lookups
    def entries(self) -> dict:
        with self._mu:
            return {k: dict(v) for k, v in self._book.items()}

    def flops(self, entry: str | None = None, shape=None) -> float:
        """Counted flops: of one (entry, shape), of every shape of one
        entry, or of the whole book."""
        with self._mu:
            items = list(self._book.items())
        total = 0.0
        for (name, frozen), fields in items:
            if entry is not None and name != entry:
                continue
            if shape is not None and frozen != self._key(name, shape)[1]:
                continue
            total += float(fields.get("flops", 0.0) or 0.0)
        return total

    def peak_temp_bytes(self) -> int:
        """The largest peak-temporary figure over the book (0 off the
        card)."""
        with self._mu:
            vals = [int(f.get("peak_temp_bytes", 0) or 0)
                    for f in self._book.values()]
        return max(vals) if vals else 0

    @staticmethod
    def mfu(flops: float, seconds: float, peak: float) -> float:
        """Model FLOPs utilization of one executed step: achieved FLOP/s
        over the device peak, clamped to [0, 1]."""
        if seconds <= 0 or peak <= 0 or flops <= 0:
            return 0.0
        return max(0.0, min(1.0, (flops / seconds) / peak))


def measured_peak_bytes(ledger=None) -> int:
    """The measured side of the calibration loop: the largest per-device
    `peak_bytes_in_use` on the card, else (off the card) the live total
    as memstat gives it: `ledger`'s attributed bytes, or 0 without
    one."""
    from deeplearning4j_tpu_torch.telemetry.memstat import (
        device_memory_stats,
        live_array_totals,
    )

    peaks = [int(d.get("peak_bytes_in_use", 0) or 0)
             for d in device_memory_stats().values()]
    peak = max(peaks) if peaks else 0
    if peak > 0:
        return peak
    return live_array_totals(ledger)[0]


def reconcile(recorder: Recorder, predicted_bytes: int, *,
              measured_bytes: int | None = None,
              factor: float = DEFAULT_DRIFT_FACTOR,
              source: str = "placement", **fields) -> dict:
    """Predicted per-device bytes (the placement search's
    `winner_memory_bytes`) against a measured peak, as a `cost_drift`
    event. Run it after the first real step. Returns the event; {} under
    a NullRecorder or a non-positive prediction."""
    if isinstance(recorder, NullRecorder):
        return {}
    predicted = int(predicted_bytes or 0)
    if predicted <= 0:
        return {}
    if measured_bytes is None:
        measured_bytes = measured_peak_bytes()
    return recorder.cost_drift(predicted_bytes=predicted,
                               measured_bytes=int(measured_bytes),
                               factor=float(factor), source=source,
                               **fields)
