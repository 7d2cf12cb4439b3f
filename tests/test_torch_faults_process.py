"""The process half of the port's fault injection
(distributed/faults.py, the launcher's `faults=`, bootstrap's
delay-connect and bounded process-group timeout) against the JAX
package's.

The grammar and the seeded schedules give the JAX package's spec
strings; `FaultRuntime`'s hooks emit the JAX package's `fault` events
(compared field by field, the clocks aside); in child processes (bare
interpreters that import the port, never jax) `check_step` kills and
hangs, the launcher classifies the exits, a delay-connect fault holds
back the rendezvous, and a gloo peer's death surfaces in the survivor
as an exception within the process group's timeout.
"""

import os
import signal
import sys
import time

import pytest

from deeplearning4j_tpu.distributed import faults as jfaults
from deeplearning4j_tpu.telemetry.recorder import Recorder as JaxRecorder
from deeplearning4j_tpu.telemetry.recorder import set_default as jax_set
from deeplearning4j_tpu_torch.distributed import bootstrap
from deeplearning4j_tpu_torch.distributed import faults as tfaults
from deeplearning4j_tpu_torch.distributed.launcher import launch_local
from deeplearning4j_tpu_torch.telemetry.recorder import Recorder, set_default

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROCESS_SPECS = ["p1:kill@step3", "p2:hang@step4", "p0:delay-connect:1.5",
                 "p1:drop-heartbeat", "p3:delay-connect:0.25",
                 "p1:kill@step3;p0:delay-connect:0.5",
                 "p1:kill@step3;r1:kill@batch2;p2:drop-heartbeat"]
BAD_SPECS = ["kill@step3", "p1:kill", "p1:delay-connect", "p1:oom@step2",
             "px:kill@step1", "p1:kill@stepX", "r1:drop-heartbeat",
             "r1:delay-connect:1", "r1:kill@step3", "p1:kill@batch3",
             "r1:kill"]


@pytest.mark.parametrize("spec", PROCESS_SPECS)
def test_process_specs_parse_as_jax(spec):
    got = tfaults.FaultSchedule.parse(spec)
    ref = jfaults.FaultSchedule.parse(spec)
    assert [vars(f) for f in got] == [vars(f) for f in ref]
    assert got.to_env() == ref.to_env() == spec
    for i in range(4):
        assert [f.spec() for f in got.for_process(i)] == \
            [f.spec() for f in ref.for_process(i)]
        assert [f.spec() for f in got.for_replica(i)] == \
            [f.spec() for f in ref.for_replica(i)]
        assert got.kill_scheduled(i) == ref.kill_scheduled(i)


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_malformed_specs_are_refused_by_both(bad):
    with pytest.raises(ValueError) as got:
        tfaults.parse_fault(bad)
    with pytest.raises(ValueError) as ref:
        jfaults.parse_fault(bad)
    assert str(got.value) == str(ref.value)


def test_seeded_schedules_equal_jax():
    for seed in range(40):
        for n, steps, kinds in ((3, 5, ("kill", "hang")), (4, 9, ("kill",)),
                                (2, 3, ("hang", "kill"))):
            assert tfaults.FaultSchedule.seeded(
                seed, n, steps, kinds).to_env() == \
                jfaults.FaultSchedule.seeded(seed, n, steps, kinds).to_env()


def test_active_faults_filters_by_process_and_reparses(monkeypatch):
    monkeypatch.setenv(bootstrap.ENV_FAULTS, "p1:kill@step3")
    monkeypatch.setenv(bootstrap.ENV_PROCESS_ID, "0")
    assert tfaults.active_faults().faults == []
    monkeypatch.setenv(bootstrap.ENV_PROCESS_ID, "1")
    assert [f.spec() for f in tfaults.active_faults().faults] == \
        [f.spec() for f in jfaults.active_faults().faults] == \
        ["p1:kill@step3"]
    monkeypatch.delenv(bootstrap.ENV_FAULTS)
    assert tfaults.active_faults().faults == []


def _fault_events(pkg):
    """The `fault` events the package's FaultRuntime emits for a kill at
    step 3, a hang at step 2 (stopped after two sleeps) and a
    delay-connect of 0.75 s, the clocks aside."""
    mod, rec, set_rec = ((tfaults, Recorder(), set_default) if pkg == "port"
                         else (jfaults, JaxRecorder(), jax_set))
    prev = set_rec(rec)
    kills, sleeps = [], []

    class Stop(Exception):
        pass

    def sleep(s):
        sleeps.append(s)
        if s == 3600.0 and sleeps.count(3600.0) >= 2:
            raise Stop

    try:
        rt = mod.FaultRuntime(
            [mod.Fault(1, "kill", step=3), mod.Fault(1, "hang", step=2),
             mod.Fault(1, "delay-connect", seconds=0.75)],
            process_id=1, sleep=sleep,
            kill=lambda pid, sig: kills.append((pid, sig)))
        assert rt.delay_connect() == 0.75
        rt.check_step(1)
        with pytest.raises(Stop):
            rt.check_step(2)
        rt.check_step(3)
    finally:
        set_rec(prev)
    assert kills == [(os.getpid(), signal.SIGKILL)]
    assert sleeps == [0.75, 3600.0, 3600.0]
    return [{k: v for k, v in e.items() if k not in ("ts", "run", "seq")}
            for e in rec.events if e["event"] == "fault"]


def test_fault_runtime_events_match_jax():
    got, ref = _fault_events("port"), _fault_events("jax")
    assert got == ref
    assert [e["kind"] for e in got] == ["delay-connect", "hang", "kill"]


_STEP_LOOP = (
    "import sys\n"
    "sys.path.insert(0, {root!r})\n"
    "from deeplearning4j_tpu_torch.distributed.faults import active_faults\n"
    "rt = active_faults()\n"
    "for step in range(1, 6):\n"
    "    print('step', step, flush=True)\n"
    "    rt.check_step(step)\n"
    "print('done', 'jax' in sys.modules, flush=True)\n")


def test_launcher_applies_faults_and_classifies_exits(tmp_path):
    """Bare interpreters running a 5-step loop: p0 finishes clean, p1
    dies by its injected kill at step 3, p2 hangs at step 4 until the
    deadline reaps it; the launcher classifies all three and the
    telemetry holds the injected faults, the victim's firing and every
    observed exit. `on_poll` runs while the fleet does."""
    tpath = str(tmp_path / "fleet.jsonl")
    rec = Recorder(str(tmp_path / "sup.jsonl"))
    prev = set_default(rec)
    polls = []
    try:
        results = launch_local(
            [sys.executable, "-c", _STEP_LOOP.format(root=ROOT)],
            n_processes=3, device="cpu", timeout=25.0, grace=2.0,
            faults="p1:kill@step3;p2:hang@step4",
            extra_env={"DL4J_TPU_TELEMETRY": tpath},
            on_poll=lambda: polls.append(1))
    finally:
        set_default(prev)
    assert [r.exit_class for r in results] == [
        tfaults.EXIT_CLEAN, tfaults.EXIT_INJECTED_KILL,
        tfaults.EXIT_DEADLINE]
    assert "done False" in results[0].output  # the port, without jax
    assert "step 3" in results[1].output and "done" not in results[1].output
    assert "step 4" in results[2].output and "done" not in results[2].output
    assert polls
    faults = [e for e in rec.events if e["event"] == "fault"]
    assert {(e["kind"], e["process_id"]) for e in faults
            if e.get("injected")} == {("kill", 1), ("hang", 2)}
    assert {e["process_id"]: e["kind"] for e in faults
            if e.get("observed_exit")} == {
        0: tfaults.EXIT_CLEAN, 1: tfaults.EXIT_INJECTED_KILL,
        2: tfaults.EXIT_DEADLINE}
    # no `error` event for an injected kill
    assert not [e for e in rec.events if e["event"] == "error"
                and e.get("process_id") == 1]
    import json

    fired = [json.loads(line) for line in open(tpath + ".p1")]
    assert [(e["kind"], e["step"], e["fired"]) for e in fired
            if e["event"] == "fault"] == [("kill", 3, True)]
    hung = [json.loads(line) for line in open(tpath + ".p2")]
    assert [(e["kind"], e["step"]) for e in hung
            if e["event"] == "fault"] == [("hang", 4)]


def test_broken_on_poll_is_recorded_once(tmp_path):
    """A watch that raises on every pass leaves the launch running and
    puts one `error` event (where `on_poll`) on the record per distinct
    failure."""
    rec = Recorder(str(tmp_path / "sup.jsonl"))
    prev = set_default(rec)
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("watch broke")

    try:
        results = launch_local(
            [sys.executable, "-c", "import time; time.sleep(0.5)"],
            n_processes=1, device="cpu", timeout=25.0, on_poll=broken)
    finally:
        set_default(prev)
    assert [r.exit_class for r in results] == [tfaults.EXIT_CLEAN]
    assert len(calls) > 1
    errors = [e for e in rec.events if e["event"] == "error"]
    assert [e["where"] for e in errors] == ["on_poll"]
    assert "watch broke" in errors[0]["error"]


def test_sigkill_without_schedule_is_an_error():
    results = launch_local(
        [sys.executable, "-c",
         "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"],
        n_processes=1, device="cpu", timeout=15.0)
    assert results[0].exit_class == tfaults.EXIT_ERROR


_RANK = (
    "import os, sys, time\n"
    "sys.path.insert(0, {root!r})\n"
    "import torch\n"
    "import torch.distributed as dist\n"
    "from deeplearning4j_tpu_torch.distributed import bootstrap\n"
    "t0 = time.monotonic()\n"
    "info = bootstrap.initialize(device='cpu', init_timeout={timeout})\n"
    "print('joined after', round(time.monotonic() - t0, 3), flush=True)\n"
    "t = torch.ones(4)\n"
    "dist.all_reduce(t)\n"
    "print('sum', float(t[0]), flush=True)\n"
    "if info['process_id'] == 1:\n"
    "    os._exit(3)\n"
    "try:\n"
    "    t0 = time.monotonic()\n"
    "    dist.all_reduce(t)\n"
    "    dist.all_reduce(t)\n"
    "    print('no error', flush=True)\n"
    "except Exception as exc:\n"
    "    print('peer loss after', round(time.monotonic() - t0, 1),\n"
    "          type(exc).__name__, flush=True)\n"
    "    os._exit(75)\n")


def test_delay_connect_and_peer_loss_surface_in_time():
    """p0's delay-connect fault holds its rendezvous back (its record
    shows the fault before the join), and after p1 dies the survivor's
    next collective raises within the process group's timeout instead
    of hanging: it exits resumable."""
    t0 = time.monotonic()
    results = launch_local(
        [sys.executable, "-c", _RANK.format(root=ROOT, timeout=10.0)],
        n_processes=2, device="cpu", timeout=60.0, grace=2.0,
        faults="p0:delay-connect:1.5",
        extra_env={"OMP_NUM_THREADS": "1"})
    assert time.monotonic() - t0 < 45.0
    out0 = results[0].output
    assert "sum 2.0" in out0 and "peer loss after" in out0, out0
    joined = float(out0.split("joined after")[1].split()[0])
    assert joined >= 1.5
    assert results[0].exit_class == tfaults.EXIT_RESUMABLE
    assert results[1].returncode == 3
    assert bootstrap.PROCESS_GROUP_TIMEOUT_S <= 300.0
