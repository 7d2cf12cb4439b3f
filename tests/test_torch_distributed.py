"""The port's process layer (distributed/bootstrap.py, launcher.py,
global_mesh.py, parallel/mesh.py) against the JAX package's on the CPU.

The pure parts (the env contract, the full-jitter backoff, exit
classification, the launch plan) take the same inputs in both packages
and must give the same answers; the port's launcher is driven for real
(deadlines, log streaming, a two-rank gloo rendezvous), every launch
under a deadline of at most 60 s.
"""

import random
import signal
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.distributed import bootstrap as jboot
from deeplearning4j_tpu.distributed import launcher as jlaunch
from deeplearning4j_tpu_torch.distributed import bootstrap, launcher
from deeplearning4j_tpu_torch.distributed import faults

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.slept = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def test_env_contract_matches_jax():
    """The same spellings and the same parse in both packages."""
    for name in ("ENV_COORDINATOR", "ENV_PROCESS_ID", "ENV_NUM_PROCESSES",
                 "ENV_LOCAL_DEVICE_COUNT", "ENV_FAULTS"):
        assert getattr(bootstrap, name) == getattr(jboot, name)
    for args in (("10.0.0.1:8476", 3, 8, 4), ("127.0.0.1:1", 0, 1, None)):
        env = bootstrap.rendezvous_env(*args)
        assert env == jboot.rendezvous_env(*args)
        assert bootstrap.contract_from_env(env) == jboot.contract_from_env(
            env)
        assert bootstrap.env_contract_present(env)
    assert not bootstrap.env_contract_present({})
    assert bootstrap.contract_from_env({}) == jboot.contract_from_env({})


def test_backoff_matches_jax():
    """Same rng seed, same fake clock: the same jittered delays, the
    same give-up point and the same attempt count."""
    runs = []
    for mod in (bootstrap, jboot):
        clk = FakeClock()
        b = mod.Backoff(base=0.25, cap=2.0, max_elapsed=10.0,
                        rng=random.Random(7), clock=clk.clock,
                        sleep=clk.sleep)
        while b.pause():
            pass
        runs.append((clk.slept, b.attempts, b.next_delay()))
    assert runs[0] == runs[1]
    slept = runs[0][0]
    assert sum(slept) <= 10.0 + 1e-9 and runs[0][2] is None
    assert all(d <= 2.0 for d in slept)


@pytest.mark.parametrize("args", [
    (0, False), (None, True), (1, False), (75, False),
    (-signal.SIGKILL, False), (-signal.SIGKILL, True),
    (-signal.SIGABRT, False), (0, True), (-signal.SIGTERM, False),
])
def test_classify_exit_matches_jax(args):
    assert launcher.classify_exit(*args) == jlaunch.classify_exit(*args)


def test_exit_classes_match_jax():
    from deeplearning4j_tpu.distributed import faults as jfaults

    for name in ("EXIT_CLEAN", "EXIT_SIGABRT", "EXIT_DEADLINE",
                 "EXIT_INJECTED_KILL", "EXIT_RESUMABLE", "EXIT_ERROR",
                 "RESUMABLE_EXIT_CODE"):
        assert getattr(faults, name) == getattr(jfaults, name)


def test_launch_plan_matches_jax():
    """The same rendezvous lines as the JAX package's plan (no virtual
    devices there); each process's device in the port's."""
    argv = ["python", "train.py"]
    coord = "127.0.0.1:5555"
    port = launcher.launch_plan(argv, 3, device="cuda", coordinator=coord)
    jax_lines = jlaunch.launch_plan(argv, 3, local_device_count=None,
                                    coordinator=coord)
    assert len(port) == len(jax_lines) == 4 and port[-1] == "wait"
    for i, (p, j) in enumerate(zip(port[:-1], jax_lines[:-1])):
        dev = f"{bootstrap.ENV_DEVICE}=cuda:{i} "
        assert dev in p
        assert p.replace(dev, "") == j
    cpu = launcher.launch_plan(argv, 2, device="cpu", coordinator=coord)
    assert all(f"{bootstrap.ENV_DEVICE}=cpu" in line for line in cpu[:-1])


def test_launcher_deadline_kills_a_hung_rank():
    """A rank that never exits is terminated (then killed) at the
    deadline while its peer exits clean; neither holds the launch past
    it."""
    import time

    script = ("import os, time; print('up', flush=True); "
              "time.sleep(600 if os.environ['DL4J_TPU_PROCESS_ID'] == '1' "
              "else 0)")
    t0 = time.monotonic()
    res = launcher.launch_local([sys.executable, "-c", script], 2,
                                device="cpu", timeout=8.0, grace=2.0)
    assert time.monotonic() - t0 < 20.0
    assert [r.exit_class for r in res] == ["clean", "deadline-reaped"]
    assert not res[0].timed_out and res[1].timed_out
    assert res[1].lines[0] == "up"
    assert res[1].lines[-1].startswith("-- exit: deadline-reaped")


def test_launcher_death_grace_reaps_survivors():
    """Once a rank dies, its peers get `death_grace` seconds, then are
    reaped: a dead peer never leaves the rest waiting for the deadline."""
    import time

    script = ("import os, sys, time; "
              "sys.exit(3) if os.environ['DL4J_TPU_PROCESS_ID'] == '0' "
              "else time.sleep(600)")
    t0 = time.monotonic()
    res = launcher.launch_local([sys.executable, "-c", script], 2,
                                device="cpu", timeout=60.0, grace=2.0,
                                death_grace=1.0)
    assert time.monotonic() - t0 < 15.0
    assert [r.exit_class for r in res] == ["error", "deadline-reaped"]


def test_launcher_streams_prefixed_logs_and_env_contract():
    """Each rank's lines are captured and echoed with a [pN] prefix; the
    env contract and the rank's device reach every child."""
    echoed = []
    script = ("import os; print(os.environ['DL4J_TPU_PROCESS_ID'], "
              "os.environ['DL4J_TPU_NUM_PROCESSES'], "
              "os.environ['DL4J_TPU_COORDINATOR'], "
              "os.environ['DL4J_TPU_DEVICE'], flush=True)")
    res = launcher.launch_local([sys.executable, "-c", script], 3,
                                device="cuda", timeout=60.0,
                                echo=echoed.append)
    assert [r.returncode for r in res] == [0, 0, 0]
    for i, r in enumerate(res):
        pid, n, coord, dev = r.lines[0].split()
        assert (pid, n, dev) == (str(i), "3", f"cuda:{i}")
        assert coord.startswith("127.0.0.1:")
    assert any(line.startswith("[p2] ") for line in echoed)


RENDEZVOUS = """
import json, sys
import torch, torch.distributed as dist
from deeplearning4j_tpu_torch.distributed import bootstrap, global_mesh
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, replicate
info = bootstrap.initialize(connect_timeout=30.0)
mesh = make_mesh({"data": 2, "seq": -1})
t = torch.full((3,), float(info["process_id"] + 1))
dist.all_reduce(t, group=mesh.group("seq"))
x = torch.full((2,), float(info["process_id"]))
replicate(x, mesh)
rows = global_mesh.local_shard(__import__("numpy").arange(8))
print(json.dumps({"info": info, "coords": [mesh.axis_index("data"),
      mesh.axis_index("seq")], "seq_sum": t.tolist(), "x": x.tolist(),
      "rows": rows.tolist(), "spans": global_mesh.spans_processes(mesh)}),
      flush=True)
bootstrap.shutdown()
"""


def test_gloo_rendezvous_and_mesh_groups():
    """Four CPU ranks bring up gloo through `initialize` (env contract),
    lay a data x seq = 2 x 2 mesh over the ranks row-major, reduce over a
    seq group, broadcast from rank 0 (`replicate`) and split host rows
    process-major (`local_shard`)."""
    import json

    res = launcher.launch_local(
        [sys.executable, "-c", RENDEZVOUS], 4, device="cpu", timeout=60.0,
        death_grace=5.0, cwd=ROOT,
        extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert all(r.exit_class == "clean" for r in res), res[0].output
    outs = [json.loads(next(line for line in r.lines
                            if line.startswith("{"))) for r in res]
    for r, out in enumerate(outs):
        assert out["info"]["process_id"] == r
        assert out["info"]["num_processes"] == 4
        assert out["info"]["backend"] == "gloo"
        assert out["info"]["device"] == "cpu"
        assert out["coords"] == [r // 2, r % 2]
        # seq groups are {0, 1} and {2, 3}: the sum of their ids + 1
        assert out["seq_sum"] == [float(2 * (r // 2) * 2 + 3)] * 3
        assert out["x"] == [0.0, 0.0]
        assert out["rows"] == list(range(2 * r, 2 * r + 2))
        assert out["spans"]


def test_single_rank_mesh_and_shard_batch():
    """A fleet of one (no env contract): `make_mesh` brings up gloo
    itself; the mesh does not span processes; `shard_batch` of a
    one-rank data axis is the whole batch, `globalize_full` too."""
    from deeplearning4j_tpu_torch.distributed import global_mesh
    from deeplearning4j_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        spans_processes,
    )

    mesh = make_mesh(device="cpu")
    try:
        assert mesh.shape == {"data": 1} and not spans_processes(mesh)
        b = {"x": np.arange(6).reshape(3, 2), "m": [np.ones(3), None]}
        out = shard_batch(b, mesh)
        np.testing.assert_array_equal(out["x"].numpy(), b["x"])
        assert out["m"][1] is None
        np.testing.assert_array_equal(
            global_mesh.globalize_full(b["x"], mesh).numpy(), b["x"])
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_mesh({"data": 2})
    finally:
        bootstrap.shutdown()
    assert not bootstrap.is_initialized()
