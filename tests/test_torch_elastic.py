"""The port's elastic fault-tolerant training (distributed/elastic.py)
against the JAX package, on gloo fleets on the CPU.

The arc: launch N = 3 processes of tests/torch_fleet_worker.py, inject
`p1:kill@step3`, and the supervisor re-forms the fleet at N' = 2, which
resumes from the step-3 checkpoint with a continuous step counter. The
reference is the JAX package's meshless fit of
`tests/cluster_worker.build_net` over `tests/elastic_worker.
batch_for_step` (one process, the full global batch each step), from
the same initial params. Tolerance: the fleets average gradients over
equal batch shards where the reference takes the full batch, so the two
agree up to f32 reduction order — 1e-5 on the flat params, the JAX
package's own bound in tests/test_elastic.py. The whole fault ->
recovery timeline is read back from the telemetry JSONL alone.

A 1 -> 1 run (the one worker killed, a replacement adopting its rank
through the supervisor's coordinator) equals the uninterrupted port run
bit for bit. Every fleet runs under the launcher's deadline.
"""

import json
import os
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.distributed import elastic as jelastic
from deeplearning4j_tpu.reshard import search as jsearch
from deeplearning4j_tpu_torch.distributed import elastic
from deeplearning4j_tpu_torch.distributed import faults as faults_mod
from deeplearning4j_tpu_torch.reshard import search as tsearch
from deeplearning4j_tpu_torch.telemetry.recorder import Recorder, set_default

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fleet_worker.py")
TOTAL_STEPS = 6
GEN_TIMEOUT = 120.0


def _events(path):
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _jax_net():
    from tests.cluster_worker import build_net

    return build_net().init()


def _inputs(path):
    """The JAX net's initial params and every step's global batch."""
    from tests.elastic_worker import batch_for_step
    from tests.test_torch_cluster import jax_param_arrays

    arrays = jax_param_arrays(_jax_net())
    for step in range(1, TOTAL_STEPS + 1):
        arrays[f"x{step}"], arrays[f"y{step}"] = batch_for_step(step)
    np.savez(path, **arrays)
    return str(path)


def _reference_params():
    """The uninterrupted run: the JAX package, one process, full global
    batches, TOTAL_STEPS steps."""
    from deeplearning4j_tpu.datasets.api import DataSet
    from tests.elastic_worker import batch_for_step

    net = _jax_net()
    for step in range(1, TOTAL_STEPS + 1):
        net.fit(DataSet(*batch_for_step(step)))
    return np.asarray(net.params_flat())


def _supervise(tmp_path, tag, inputs, **kw):
    """An ElasticSupervisor run of the worker; returns (result,
    supervisor, paths). The supervisor's own record goes to sup.jsonl,
    the fleet's to fleet.jsonl.p<N>."""
    d = tmp_path / tag
    ckpt, out = d / "ckpt", d / "out"
    ckpt.mkdir(parents=True)
    out.mkdir()
    paths = {"ckpt": str(ckpt), "out": out,
             "sup": str(d / "sup.jsonl"), "fleet": str(d / "fleet.jsonl")}
    rec = Recorder(paths["sup"])
    prev = set_default(rec)
    sup = elastic.ElasticSupervisor(
        [sys.executable, WORKER, "elastic", inputs, str(ckpt), str(out)],
        device="cpu", total_steps=TOTAL_STEPS, checkpoint_dir=str(ckpt),
        gen_timeout=GEN_TIMEOUT, death_grace=15.0,
        snapshot_path=str(d / "coord.json"),
        extra_env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
                   "DL4J_TPU_TELEMETRY": paths["fleet"]},
        cwd=ROOT, **kw)
    try:
        result = sup.run()
    finally:
        set_default(prev)
        rec.close()
        sup.close()
    return result, sup, paths


def test_kill_one_worker_fleet_reforms_and_resumes(tmp_path):
    inputs = _inputs(tmp_path / "inputs.npz")
    result, sup, p = _supervise(tmp_path, "fleet", inputs, n_processes=3,
                                min_processes=2, max_reforms=2,
                                faults="p1:kill@step3")

    # --- the generational shape: N=3 with the injected death, then a
    # clean re-form at N'=2 of the two survivors
    assert [g.n_processes for g in result.generations] == [3, 2]
    gen0, gen1 = result.generations
    assert gen0.results[1].exit_class == faults_mod.EXIT_INJECTED_KILL
    assert gen0.dead == [1] and not gen0.clean
    assert gen1.clean, [r.output[-2000:] for r in gen1.results]
    assert gen1.members == ["w0", "w2"]

    # --- continuous step counter + parity with the JAX reference
    done = (p["out"] / "done.txt").read_text()
    assert f"steps={TOTAL_STEPS}" in done and "n_processes=2" in done
    final = np.load(str(p["out"] / "final_params.npy"))
    np.testing.assert_allclose(final, _reference_params(), atol=1e-5)

    # --- the checkpoint trail: one writer, the last step committed with
    # the continuous counter
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    ck = Checkpointer(p["ckpt"])
    assert ck.steps()[-1] == TOTAL_STEPS
    assert ck.read_meta(TOTAL_STEPS)["iteration"] == TOTAL_STEPS
    assert not [f for f in os.listdir(ck.step_dir(TOTAL_STEPS))
                if f.endswith(".tmp")]

    # --- the durable coordinator journaled both generations
    assert int(sup.coordinator.read_config(elastic.GEN_KEY)) == 1
    assert sup.coordinator.read_config("elastic/members/0")[
        "exit_classes"][1] == faults_mod.EXIT_INJECTED_KILL
    assert sup.coordinator.read_config("elastic/members/1")[
        "members"] == ["w0", "w2"]

    # ---------------- timeline from telemetry JSONL alone ----------------
    sup_events = _events(p["sup"])
    injected = [e for e in sup_events if e["event"] == "fault"
                and e.get("injected")]
    assert [(e["kind"], e["process_id"], e["step"])
            for e in injected] == [("kill", 1, 3)]
    reform = [e for e in sup_events if e["event"] == "fault"
              and e["kind"] == "reform"]
    assert len(reform) == 1 and reform[0]["n_processes"] == 2 \
        and reform[0]["dead"] == [1] and reform[0]["replacements"] == 0
    cut = sup_events.index(reform[0])
    observed = {e["process_id"]: e["kind"] for e in sup_events[:cut]
                if e["event"] == "fault" and e.get("observed_exit")}
    assert observed == {0: faults_mod.EXIT_RESUMABLE,
                        1: faults_mod.EXIT_INJECTED_KILL,
                        2: faults_mod.EXIT_RESUMABLE}
    gen1_observed = {e["process_id"]: e["kind"] for e in sup_events[cut:]
                     if e["event"] == "fault" and e.get("observed_exit")}
    assert gen1_observed == {0: faults_mod.EXIT_CLEAN,
                             1: faults_mod.EXIT_CLEAN}
    # the victim's own log ends with the fault firing at step 3
    fired = [e for e in _events(p["fleet"] + ".p1")
             if e["event"] == "fault" and e.get("fired")]
    assert [(e["kind"], e["step"]) for e in fired] == [("kill", 3)]
    # worker 0: steps 1..6 once each across two runs, resumed at 3; the
    # survivors took the rescue path
    p0 = _events(p["fleet"] + ".p0")
    assert [e["iteration"] for e in p0 if e["event"] == "step"] == \
        list(range(1, TOTAL_STEPS + 1))
    resumes = [e for e in p0 if e["event"] == "span"
               and e.get("name") == "elastic_resume"]
    assert [r["start_step"] for r in resumes] == [0, 3]
    assert [r["worker"] for r in resumes] == ["w0", "w0"]
    assert resumes[-1]["num_processes"] == 2
    assert len({e["run"] for e in p0}) == 2
    assert [e for e in p0 if e["event"] == "fault"
            and e["kind"] == "peer-loss-exit"]
    # every generation searched its placement; the supervisor re-planned
    # before the relaunch and journaled the winner
    searches = [e for e in p0 if e["event"] == "placement_search"]
    assert [(e["path"], e["fleet"]) for e in searches] == \
        [("elastic", "3x1"), ("elastic", "2x1")]
    sup_searches = [e for e in sup_events
                    if e["event"] == "placement_search"]
    assert [(e["path"], e["gen"]) for e in sup_searches] == [("reform", 1)]
    assert sup_events.index(sup_searches[0]) < cut
    assert reform[0]["placement"] == sup_searches[0]["winner"]
    journaled = sup.coordinator.read_config("elastic/placement/1")
    assert journaled["process_count"] == 2


def test_replacement_run_equals_uninterrupted_run(tmp_path):
    """One worker, killed after step 3: the next generation is one
    replacement that adopts its rank 0 through the supervisor's
    coordinator, restores step 3 and trains 4..6 — bit for bit the
    uninterrupted run."""
    inputs = _inputs(tmp_path / "inputs.npz")
    whole, _, pw = _supervise(tmp_path, "whole", inputs, n_processes=1)
    assert len(whole.generations) == 1 and whole.generations[0].clean
    result, sup, p = _supervise(tmp_path, "killed", inputs, n_processes=1,
                                faults="p0:kill@step3")
    assert [g.exit_classes for g in result.generations] == \
        [[faults_mod.EXIT_INJECTED_KILL], [faults_mod.EXIT_CLEAN]]
    assert [g.members for g in result.generations] == [["w0"], ["w1"]]
    np.testing.assert_array_equal(
        np.load(str(p["out"] / "final_params.npy")),
        np.load(str(pw["out"] / "final_params.npy")))
    resumes = [e for e in _events(p["fleet"] + ".p0")
               if e["event"] == "span" and e.get("name") == "elastic_resume"]
    assert [(r["worker"], r["start_step"], r["coordinator_rank"],
             r["reassigned_from"]) for r in resumes] == \
        [("w0", 0, 0, None), ("w1", 3, 0, "w0")]
    reform = [e for e in _events(p["sup"]) if e["event"] == "fault"
              and e["kind"] == "reform"]
    assert reform[0]["replacement_workers"] == ["w1"]


def test_checkpoint_under_spanning_mesh_restores_on_one_process(tmp_path):
    """Params saved by a 2-process fleet (rank 0 the one writer) restore
    onto ONE process bit-identically."""
    inputs = _inputs(tmp_path / "inputs.npz")
    result, _, p = _supervise(tmp_path, "two", inputs, n_processes=2,
                              min_processes=2, max_reforms=0)
    assert len(result.generations) == 1 and result.generations[0].clean
    from tests.torch_fleet_worker import build_net

    net = build_net(np.load(inputs))
    assert net.resume_from(p["ckpt"]) == TOTAL_STEPS
    np.testing.assert_array_equal(
        net.params_flat(), np.load(str(p["out"] / "final_params.npy")))


@pytest.mark.parametrize("shared", [True, False])
def test_one_writer_of_a_shared_checkpoint(tmp_path, shared):
    """Under a 2-rank mesh, ranks that save into one directory leave one
    writer (rank 0) and a committed step; ranks that name directories of
    their own each write theirs. (With every rank writing the shared
    files, one rank's rename of the shared meta file raced the other's.)"""
    from deeplearning4j_tpu_torch.distributed.launcher import launch_local
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    inputs = _inputs(tmp_path / "inputs.npz")
    ckpt = tmp_path / "ckpt"
    results = launch_local(
        [sys.executable, WORKER, "save", inputs, str(ckpt), str(tmp_path),
         "1" if shared else "0"], 2, device="cpu", timeout=60.0,
        death_grace=5.0, cwd=ROOT,
        extra_env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert [r.exit_class for r in results] == ["clean", "clean"], \
        [r.output[-2000:] for r in results]
    writes = [(tmp_path / f"writes{r}.txt").read_text().split()
              for r in (0, 1)]
    if shared:
        assert [len(w) for w in writes] == [2, 0]
        assert Checkpointer(str(ckpt)).steps() == [2]
    else:
        assert [len(w) for w in writes] == [2, 2]
        for r in (0, 1):
            assert Checkpointer(str(ckpt / f"rank{r}")).steps() == [2]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_search_winner_equals_jax_search(tmp_path, n):
    """The re-plan of a fleet of n one-device processes picks what the
    JAX package's search picks for the same FleetShape, for the worker's
    net and for the supervisor's generic profile."""
    from tests.torch_fleet_worker import GLOBAL_BATCH, build_net

    jnet = _jax_net()
    tnet = build_net(np.load(_inputs(tmp_path / "inputs.npz")))
    jres = jsearch.search_placement(
        jsearch.profile_net(jnet), jsearch.FleetShape(n, 1),
        objective=jsearch.Objective(global_batch=GLOBAL_BATCH))
    tres = tsearch.search_placement(
        tsearch.profile_net(tnet), tsearch.FleetShape(n, 1),
        objective=tsearch.Objective(global_batch=GLOBAL_BATCH))
    assert tres.winner.describe() == jres.winner.describe()
    assert tres.winner.to_json() == jres.winner.to_json()
    jg = jelastic._search_with_batch_fallback(
        jsearch.GENERIC_PROFILE, jsearch.FleetShape(n, 1), None)
    tg = elastic._search_with_batch_fallback(tsearch.GENERIC_PROFILE,
                                             tsearch.FleetShape(n, 1), None)
    assert tg.winner.describe() == jg.winner.describe()

