"""util/profiler.py of the port (JAX counterpart tests/test_profiler.py,
which fakes jax.profiler): the same window arithmetic and close /
unstopped-window semantics, here on a real CPU `torch.profiler`. Every
window writes a Chrome trace that loads as JSON and leaves one
`profiler_trace` span with the JAX package's fields; a window left open
is flushed by `close()` or `__del__`, after which another window in the
same process starts. A net on the card profiles CUDA too."""

import json
import os

import pytest
import torch

from deeplearning4j_tpu_torch.telemetry import Recorder, set_default
from deeplearning4j_tpu_torch.util import profiler
from deeplearning4j_tpu_torch.util.profiler import (
    ProfilerIterationListener,
    trace,
)

pytestmark = pytest.mark.port


class _Net:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)


def _work():
    torch.randn(32, 32) @ torch.randn(32, 32)


def _spans(rec):
    return [e for e in rec.events
            if e["event"] == "span" and e["name"] == "profiler_trace"]


def test_listener_traces_exactly_the_window(tmp_path):
    rec = Recorder()
    lst = ProfilerIterationListener(str(tmp_path), start_iteration=2,
                                    n_iterations=3, recorder=rec)
    opened = []
    for it in range(8):
        lst.iteration_done(_Net(), it)
        opened.append(lst._active)
        _work()
    # open after iteration 2's call, closed by iteration 5's
    assert opened == [False, False, True, True, True, False, False, False]
    assert lst.done and not lst._active
    (span,) = _spans(rec)
    assert span["start_iteration"] == 2 and span["seconds"] >= 0
    assert span["logdir"] == str(tmp_path)
    with open(lst.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # done: the window never reopens
    for it in range(8, 16):
        lst.iteration_done(_Net(), it)
    assert len(_spans(rec)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(lst.trace_path)]


def test_close_flushes_an_unstopped_window_and_a_second_one_starts(
        tmp_path):
    rec = Recorder()
    lst = ProfilerIterationListener(str(tmp_path / "a"), start_iteration=1,
                                    n_iterations=100, recorder=rec)
    for it in range(3):
        lst.iteration_done(_Net(), it)
    assert lst._active and not lst.done and lst.trace_path is None
    lst.close()
    assert lst.done and not lst._active and os.path.exists(lst.trace_path)
    assert len(_spans(rec)) == 1
    lst.close()  # idempotent: no second stop, no second span
    assert len(_spans(rec)) == 1
    second = ProfilerIterationListener(str(tmp_path / "b"),
                                       start_iteration=0, n_iterations=1,
                                       recorder=rec)
    second.iteration_done(_Net(), 0)
    _work()
    second.iteration_done(_Net(), 1)
    assert second.done and os.path.exists(second.trace_path)
    assert second.trace_path != lst.trace_path


def test_close_is_a_noop_before_the_window_opens(tmp_path):
    lst = ProfilerIterationListener(str(tmp_path), start_iteration=10)
    lst.iteration_done(_Net(), 1)
    lst.close()
    assert not lst.done and lst.trace_path is None
    assert not os.path.exists(tmp_path / "x")


def test_del_flushes_best_effort(tmp_path):
    rec = Recorder()
    lst = ProfilerIterationListener(str(tmp_path), start_iteration=0,
                                    n_iterations=100, recorder=rec)
    lst.iteration_done(_Net(), 0)
    lst.__del__()
    assert lst.done and os.path.exists(lst.trace_path)
    assert len(_spans(rec)) == 1


def test_trace_context_manager_stops_on_exception(tmp_path):
    rec = Recorder()
    prev = set_default(rec)
    try:
        with pytest.raises(RuntimeError):
            with trace(str(tmp_path)) as d:
                assert d == str(tmp_path)
                _work()
                raise RuntimeError("mid-trace")
    finally:
        set_default(prev)
    (span,) = _spans(rec)
    assert span["logdir"] == str(tmp_path) and "start_iteration" not in span
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        json.load(f)
    with trace(str(tmp_path)):  # the profiler was released
        _work()


def test_a_net_on_the_card_profiles_cuda(tmp_path, monkeypatch):
    seen = []

    class _Prof:
        def stop(self):
            pass

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    monkeypatch.setattr(profiler, "_start",
                        lambda logdir, cuda: seen.append(cuda) or _Prof())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    for device in ("cuda", "cpu"):
        lst = ProfilerIterationListener(str(tmp_path), start_iteration=0,
                                        n_iterations=1, recorder=Recorder())
        lst.iteration_done(_Net(device), 0)
        lst.iteration_done(_Net(device), 1)
        assert lst.done
    assert seen == [True, False]
