"""Profiling helpers (JAX counterpart deeplearning4j_tpu/util/profiler.py,
which runs jax.profiler).

`trace(logdir)` wraps a region in a `torch.profiler` session and writes
its Chrome trace (it loads in https://ui.perfetto.dev or
chrome://tracing: host ops and, on the card, every kernel with its
device time) into `logdir`. `ProfilerIterationListener` starts a session
at a given iteration of `fit()` and stops it N iterations later, so a
steady-state window is profiled without changing the training loop.
Both leave a `span` event named `profiler_trace` with the JAX package's
fields (`logdir`, `seconds`; the listener also `start_iteration`) in the
run-telemetry log, so each window's wall clock survives even when nobody
opens the trace.

The activities are the CPU's, and CUDA's whenever the work runs on the
card: the net's device for the listener, `torch.cuda.is_available()`
for `trace`. A process holds
one `torch.profiler` session at a time; starting a second while one is
live raises torch's RuntimeError.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.telemetry.recorder import get_default

_windows = itertools.count()


def _start(logdir: str, cuda: bool):
    """A started `torch.profiler.profile` over the CPU (and CUDA)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof, logdir: str, cuda: bool) -> str:
    """Stop `prof` and write its Chrome trace into `logdir`; returns the
    file's path."""
    import torch

    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(
        logdir, f"profiler_trace.{os.getpid()}.{next(_windows)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager: a `torch.profiler` session over the enclosed
    region, its Chrome trace written into `logdir` at exit (also when the
    region raises). Yields `logdir`."""
    import torch

    cuda = torch.cuda.is_available()
    prof = _start(logdir, cuda)
    t0 = time.perf_counter()
    try:
        yield logdir
    finally:
        _stop(prof, logdir, cuda)
        get_default().event(
            "span", name="profiler_trace", logdir=logdir,
            seconds=round(time.perf_counter() - t0, 6))


class ProfilerIterationListener(IterationListener):
    """Profile a steady-state window of fit(): the session starts at the
    first `iteration_done` at or past `start_iteration` and stops at the
    first at or past `n_iterations` later. `trace_path` names the Chrome
    trace the window wrote."""

    def __init__(self, logdir: str, start_iteration: int = 10,
                 n_iterations: int = 5, recorder=None):
        self.logdir = logdir
        self.start_iteration = start_iteration
        self.n_iterations = n_iterations
        self.recorder = recorder
        self.trace_path = None
        self._active = False
        self._prof = None
        self._cuda = False
        self.done = False

    def iteration_done(self, model, iteration):
        if (not self._active and not self.done
                and iteration >= self.start_iteration):
            device = getattr(model, "device", None)
            self._cuda = getattr(device, "type", None) == "cuda"
            self._prof = _start(self.logdir, self._cuda)
            self._active = True
            self._t0 = time.perf_counter()
            self._start_iter = iteration
            self._stop_at = iteration + self.n_iterations
        elif self._active and iteration >= self._stop_at:
            self.close()

    def close(self):
        """Flush an open window. Call after fit() if training might end
        inside the window: an unstopped session writes no trace and keeps
        the process's profiler busy, so a later window could not start."""
        if self._active:
            self._active = False
            self.done = True
            prof, self._prof = self._prof, None
            self.trace_path = _stop(prof, self.logdir, self._cuda)
            rec = self.recorder if self.recorder is not None \
                else get_default()
            rec.event("span", name="profiler_trace", logdir=self.logdir,
                      start_iteration=self._start_iter,
                      seconds=round(time.perf_counter() - self._t0, 6))

    def __del__(self):  # best-effort flush
        try:
            self.close()
        except Exception:
            pass
