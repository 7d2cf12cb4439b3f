"""The port's stage 4 (deeplearning4j_tpu_torch/analysis/
concurrency_rules.py, lock_audit.py) held to the JAX package's exactly:
the same G025-G028 findings on every on-disk fixture, the same inferred
guard maps and lock-order edges over the whole JAX tree, D001 on the
inverted-lock fixture (CLI exit 1), D002 on the sink fan-out; then the
port's own guard maps pinned for its runtime classes, its lock graph
frozen and acyclic, and the stage run with torch unimportable."""

import glob
import json
import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu.analysis import concurrency_rules as jax_conc
from deeplearning4j_tpu.analysis import lint_source as jax_lint_source
from deeplearning4j_tpu.analysis import lock_audit as jax_locks
from deeplearning4j_tpu_torch.analysis import (guard_map_for_file,
                                               lint_source, lock_audit)
from deeplearning4j_tpu_torch.analysis.concurrency_rules import (
    CONC_RULE_IDS,
    guard_map,
)

pytestmark = [pytest.mark.port, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "deeplearning4j_tpu")
PKG = os.path.join(ROOT, "deeplearning4j_tpu_torch")
FIX = os.path.join(ROOT, "tests", "fixtures")
CLI = os.path.join(ROOT, "port_tools", "graftlint.py")

FIXTURES = sorted(
    os.path.relpath(p, FIX).replace(os.sep, "/")
    for p in glob.glob(os.path.join(FIX, "conc_*.py"))
    + glob.glob(os.path.join(FIX, "serving", "conc_*.py")))


def _conc(findings):
    return sorted((f.rule, f.line, f.col, f.message, f.fixit, f.snippet)
                  for f in findings if f.rule in CONC_RULE_IDS)


@pytest.mark.parametrize("rel", FIXTURES)
def test_same_findings_as_jax_on_fixture(rel):
    with open(os.path.join(FIX, rel), encoding="utf-8") as fh:
        src = fh.read()
    for path in (f"tests/fixtures/{rel}",
                 f"deeplearning4j_tpu_torch/telemetry/{rel}"):
        assert _conc(lint_source(src, path)) == \
            _conc(jax_lint_source(src, path)), (rel, path)


def test_fixture_findings_are_not_empty():
    """The comparison above has teeth: the positive fixtures fire."""
    fired = set()
    for rel in FIXTURES:
        with open(os.path.join(FIX, rel), encoding="utf-8") as fh:
            fired |= {f.rule for f in lint_source(
                fh.read(), f"tests/fixtures/{rel}")}
    assert CONC_RULE_IDS <= fired


def _threaded(pkg):
    """(path, source) of the package's files that use `threading`: a
    lock group needs a threading constructor, so every other file's
    guard map is empty and it holds no lock in both analyzers."""
    out = []
    for path in sorted(glob.glob(os.path.join(pkg, "**", "*.py"),
                                 recursive=True)):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        if "threading" in src:
            out.append((path, src))
    return out


def test_same_guard_maps_as_jax_over_the_jax_tree():
    n_maps = 0
    for path, src in _threaded(JAX_PKG):
        ours = guard_map(src)
        assert ours == jax_conc.guard_map(src), path
        n_maps += len(ours)
    assert n_maps >= 10


def test_same_lock_edges_as_jax_over_the_jax_tree():
    """Both analyzers over the JAX tree's threaded files give one edge
    set, and it is the JAX package's frozen one (its whole-tree graph)."""
    files = [p for p, _ in _threaded(JAX_PKG)]
    ours, _ = lock_audit._build(files, ROOT)
    jax_edges, _ = jax_locks._build(files, ROOT)
    assert lock_audit._edge_strs(ours) == jax_locks._edge_strs(jax_edges) \
        == jax_locks.load_locks()


def test_lock_inversion_fixture_trips_d001_and_cli_exits_one():
    path = os.path.join(FIX, "conc_lock_inversion.py")
    findings, edges = lock_audit.audit_paths([path])
    assert any(f.rule == "D001" for f in findings)
    jax_findings, jax_edges = jax_locks.audit_paths([path])
    assert edges == jax_edges
    assert [f.format() for f in findings] == \
        [f.format() for f in jax_findings]
    proc = subprocess.run([sys.executable, CLI, "--stage", "concurrency",
                           path], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "D001" in proc.stdout and "lock-order cycle" in proc.stdout


def test_sink_fanout_fixture_trips_d002():
    path = os.path.join(FIX, "conc_sink_fanout.py")
    findings, _ = lock_audit.audit_paths([path])
    assert [f.rule for f in findings] == ["D002"]
    assert [f.format() for f in findings] == \
        [f.format() for f in jax_locks.audit_paths([path])[0]]


def test_torch_syncs_block_under_a_lock():
    """G026's blocking set is torch's: a scalar read, a host copy and
    torch.cuda.synchronize under a held lock on a request path."""
    src = ("import threading\nimport torch\n\nclass W:\n"
           "    def __init__(self):\n        self._lock = threading.Lock()\n"
           "    def f(self, t, e):\n        with self._lock:\n"
           "            t.item()\n            t.cpu()\n"
           "            torch.cuda.synchronize()\n            e.synchronize()\n")
    lines = sorted(f.line for f in lint_source(
        src, "deeplearning4j_tpu_torch/serving/w.py") if f.rule == "G026")
    assert lines == [9, 10, 11, 12]


# ------------------------------------------------- the port's own maps


def _guards(rel):
    return guard_map_for_file(os.path.join(PKG, rel))


def test_port_guard_map_pagepool_weightstore_channel():
    assert _guards("serving/kvcache.py")["PagePool"] == {
        "_in_use": "_lock", "peak_in_use": "_lock"}
    assert _guards("serving/fleet.py")["WeightStore"] == {
        "_current": "_lock", "last_swap_ts": "_lock"}
    assert _guards("data/prefetcher.py")["Channel"] == {
        "_buf": "_not_empty|_not_full",
        "_closed": "_not_empty|_not_full",
        "_error": "_not_empty|_not_full",
        "_stopped": "_not_empty|_not_full",
    }


def test_port_guard_map_engine_workers():
    maps = _guards("serving/engine.py")
    assert maps["_Replica"] == {
        "batches_run": "_mu", "failed": "_mu", "served": "_mu",
        "trace_count": "_mu"}
    gw = maps["_GenWorker"]
    assert gw["pending"] == "_cv" and gw["_closed"] == "_cv"
    for counter in ("served", "failed", "trace_count", "tokens_out",
                    "decode_steps_run", "verify_steps_run",
                    "accepted_tokens", "drafted_tokens", "slot_steps",
                    "draft_overhead_s"):
        assert gw[counter] == "_mu", counter


def test_port_guard_map_telemetry():
    assert _guards("telemetry/recorder.py")["Recorder"] == {
        "_seq": "_lock", "_sinks": "_lock", "_span_seq": "_lock",
        "events": "_lock"}
    assert _guards("telemetry/metrics.py")["MetricsRegistry"] == {
        "_collectors": "_lock", "_metrics": "_lock"}


def test_port_guard_maps_match_jax_where_the_classes_match():
    """Every file but the five whose classes differ by design (shape
    sets where JAX has jit caches, the port's round-robin lock) infers
    the JAX twin's map."""
    differ = {"embedding/ann.py", "embedding/engine.py", "embedding/walks.py",
              "serving/engine.py", "telemetry/costbook.py"}
    rels = {os.path.relpath(p, base).replace(os.sep, "/")
            for base in (PKG, JAX_PKG) for p, _ in _threaded(base)}
    same = 0
    for rel in sorted(rels - differ):
        path, twin = os.path.join(PKG, rel), os.path.join(JAX_PKG, rel)
        if not (os.path.exists(path) and os.path.exists(twin)):
            continue
        assert guard_map_for_file(path) == \
            jax_conc.guard_map_for_file(twin), rel
        same += 1
    assert same >= 15


def test_concurrency_stage_runs_without_torch_and_graph_is_frozen():
    """The CLI's stage 4 over the port with torch, jax and the JAX
    package unimportable: exit 0, no finding, the two frozen edges."""
    code = ("import runpy, sys\n"
            "for m in ('torch', 'jax', 'deeplearning4j_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = {[CLI, '--check', '--stage', 'concurrency', '--json']!r}\n"
            f"runpy.run_path({CLI!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["findings"] == []
    assert out["lock_order_edges"] == lock_audit.load_locks() == [
        "deeplearning4j_tpu_torch/serving/engine.py:_GenWorker._cv -> "
        "deeplearning4j_tpu_torch/serving/kvcache.py:PagePool._lock",
        "deeplearning4j_tpu_torch/serving/engine.py:_GenWorker._cv -> "
        "deeplearning4j_tpu_torch/telemetry/recorder.py:Recorder._lock"]
