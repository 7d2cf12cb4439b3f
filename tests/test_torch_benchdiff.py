"""A11: port_tools/benchdiff.py, the port's twin of tools/benchdiff.py,
gives the JAX tool's verdict, exit code and named metrics on the same
pairs of artifacts, and reads them without JAX. Both tools run as
processes of their own, as a user runs them."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "benchdiff.py")
PORT_TOOL = os.path.join(ROOT, "port_tools", "benchdiff.py")
PORT_TABLE = os.path.join(ROOT, "deeplearning4j_tpu_torch", "ops",
                          "tuning_table.json")


def _run(tool, *args):
    proc = subprocess.run([sys.executable, tool, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout, proc.stderr


def _both(*args):
    """(rc, stdout) of each tool, after checking they agree: the same
    exit code, and with --json the same result, row for row."""
    jax_rc, jax_out, _ = _run(JAX_TOOL, *args)
    port_rc, port_out, port_err = _run(PORT_TOOL, *args)
    assert port_rc == jax_rc, port_err
    if "--json" in args and jax_rc != 2:
        assert json.loads(port_out) == json.loads(jax_out)
    else:
        assert port_out == jax_out
    return port_rc, port_out


def _named(result):
    return sorted((r["metric"], r["field"]) for r in result["regressions"])


def test_committed_r04_vs_r05_names_the_dp_regression():
    old, new = (os.path.join(ROOT, f"BENCH_r0{i}.json") for i in (4, 5))
    rc, out = _both(old, new, "--json")
    assert rc == 1
    result = json.loads(out)
    assert _named(result) == [
        ("resnet20_dp_allreduce_vs_paramavg_speedup", "value")]
    rc, out = _both(old, new)
    assert ("REGRESSED resnet20_dp_allreduce_vs_paramavg_speedup.value: "
            "1.2067 -> 0.9597 (-20.5%)") in out
    # a tighter threshold names more, the same in both
    rc, out = _both(old, new, "--threshold", "0.01", "--json")
    assert rc == 1 and len(json.loads(out)["regressions"]) >= 1


def test_committed_serve_r04_self_diff_is_clean():
    path = os.path.join(ROOT, "SERVE_r04.json")
    rc, out = _both(path, path, "--json")
    assert rc == 0
    assert json.loads(out)["regressions"] == []


def test_missing_file_and_mixed_kinds_are_usage_errors(tmp_path):
    rc, _ = _both(str(tmp_path / "nope.json"),
                  os.path.join(ROOT, "SERVE_r04.json"))
    assert rc == 2
    rc, _ = _both(PORT_TABLE, os.path.join(ROOT, "SERVE_r04.json"))
    assert rc == 2


def _tables(tmp_path, old):
    """OLD and three edits of it: a changed entry, a timing regression
    past the threshold, and a match-or-beat violation."""
    paths = {"old": old}
    key = sorted(old["entries"])[0]
    other = sorted(old["entries"])[-1]
    changed = copy.deepcopy(old)
    entry = changed["entries"][key]
    entry["best_us"] = entry["best_us"] * 0.95
    param = next(k for k in entry if k not in ("best_us", "default_us",
                                               "candidates", "source"))
    entry[param] = entry[param] * 2
    changed["entries"]["added|T1|D1|c0|d0|m0"] = {"best_us": 1.0,
                                                   "default_us": 1.0}
    paths["changed"] = changed
    slower = copy.deepcopy(old)
    slower["entries"][key]["best_us"] *= 1.5
    paths["slower"] = slower
    violated = copy.deepcopy(old)
    e = violated["entries"][other]
    e["best_us"] = e["default_us"] * 1.2
    paths["violated"] = violated
    for name, table in paths.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(table))
    return key, other, {n: str(tmp_path / f"{n}.json") for n in paths}


@pytest.mark.parametrize("table", ["port", "jax_style"])
def test_tuning_tables_diff_entry_by_entry(tmp_path, table):
    if table == "port":
        with open(PORT_TABLE) as fh:
            old = json.load(fh)
    else:  # the JAX test's tables (tests/test_autotune.py)
        old = {"version": 1, "provenance": {"date": "a"}, "entries": {
            "flash_fwd|T512|D64|c1|d0|m0":
                {"block_q": 512, "block_k": 512, "g": 8,
                 "best_us": 129, "default_us": 263},
            "softmax_xent|T10240|D256|c0|d0|m0":
                {"block_n": 1024, "block_v": 2048,
                 "best_us": 100, "default_us": 100}}}
    key, other, p = _tables(tmp_path, old)
    rc, out = _both(p["old"], p["changed"], "--json")
    result = json.loads(out)
    assert rc == 0 and result["regressions"] == []
    assert (key, "params") in {(r["metric"], r["field"])
                               for r in result["changes"]}
    assert (key, "best_us") in {(r["metric"], r["field"])
                                for r in result["changes"]}
    assert result["added"] == ["added|T1|D1|c0|d0|m0"]
    rc, out = _both(p["old"], p["slower"], "--json")
    result = json.loads(out)
    assert rc == 1 and set(_named(result)) == {(key, "best_us")}
    assert any("lower-is-better" in r["reason"]
               for r in result["regressions"])
    rc, out = _both(p["old"], p["violated"], "--json")
    result = json.loads(out)
    assert rc == 1
    assert any(r["metric"] == other and "match-or-beat" in r["reason"]
               for r in result["regressions"])
    rc, out = _both(p["old"], p["old"])
    assert rc == 0


def test_port_tool_reads_a_recorder_log_and_a_truncated_serve(tmp_path):
    """The port's own artifacts: a recorder JSONL of `metric` events and
    a SERVE artifact cut to its summary line, diffed by both tools."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_artifact", os.path.join(ROOT, "deeplearning4j_tpu_torch",
                                      "telemetry", "artifact.py"))
    artifact = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(artifact)  # pure stdlib: no package import
    build_summary = artifact.build_summary

    def log(p99, qps):
        lines = [{"metric": "serving_p99_ms", "value": p99,
                  "lower_is_better": True},
                 {"metric": "serving_qps", "value": qps}]
        events = [dict(line, event="metric", ts=1.0) for line in lines]
        return events, build_summary(lines)

    for name, (p99, qps) in {"a": (10.0, 100.0), "b": (12.0, 95.0)}.items():
        events, summary = log(p99, qps)
        (tmp_path / f"{name}.jsonl").write_text(
            "".join(json.dumps(e) + "\n" for e in events))
        (tmp_path / f"{name}_cut.json").write_text(
            json.dumps({"tail": json.dumps(summary)}))
    for a, b in (("a.jsonl", "b.jsonl"), ("a_cut.json", "b_cut.json")):
        rc, out = _both(str(tmp_path / a), str(tmp_path / b), "--json")
        assert rc == 1
        assert _named(json.loads(out)) == [("serving_p99_ms", "value")]
