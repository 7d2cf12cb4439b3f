"""Tracing the port without the JAX package: port_tools/tracetool.py
against tools/tracetool.py, port_tools/trafficreplay.py, and the
registered event schema (telemetry/recorder.py EVENT_KINDS, SPAN_NAMES),
on the CPU.

* Both tracetools, run over the same JSONL (a hand-written set of two
  process shards with steps, a straggler, a retrace, a request tree,
  memory and cost events; and the log of the port's 2-layer LM `fit`
  with a `Recorder`), print the same bytes for `stats`, `check`, `tree`
  and `mem` (plain and `--json`) and write the same files for `merge`,
  `export --perfetto` and `stats --artifact`, with the same exit codes.
* The port's tools leave no `jax` in `sys.modules`; tracetool does not
  import torch either.
* `trafficreplay --device cpu` serves a predict and a generation replay
  of the port (`n_ok` > 0); without `--device` on a machine with no card
  it exits 2.
* Every string-literal `event("...")` / `span("...")` in the port's
  package names a registered kind or span (the port's counterpart of the JAX
  package's graftlint G023), and the sets are the JAX package's.
"""

import ast
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.telemetry import recorder as jrecorder
from deeplearning4j_tpu_torch.telemetry import EVENT_KINDS, SPAN_NAMES

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _load("tools/tracetool.py", "jax_tracetool")
PORT_TOOL = _load("port_tools/tracetool.py", "port_tracetool")
REPLAY = _load("port_tools/trafficreplay.py", "port_trafficreplay")


def _run(tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    return rc, out.getvalue()


def _ev(ts, seq, event, **kw):
    return {"event": event, "ts": ts, "run": "r", "seq": seq, **kw}


def _hand_written(tmp_path):
    """Two process shards of one run: p1 a straggler with a retrace after
    warmup; a request span tree; memory, cost and cost_drift events."""
    base = tmp_path / "fleet.jsonl"
    shards = {0: [], 1: []}
    for p, lag in ((0, 0.0), (1, 3.0)):
        ev = shards[p]
        ev.append(_ev(100.0, 0, "meta", process_id=p, role="worker"))
        for i in range(6):
            t = 100.0 + i + (lag if i >= 3 else 0.0)
            ev.append(_ev(t, 1 + 2 * i, "span", name="step_scan",
                          seconds=0.25 + 0.01 * i, span_id=f"s{p}{i}",
                          trace_id=f"step-{i + 1}"))
            ev.append(_ev(t + 0.01, 2 + 2 * i, "step", iteration=i + 1,
                          trace_id=f"step-{i + 1}"))
        ev.append(_ev(110.0, 20, "memory", live_array_bytes=1000 + p,
                      live_array_count=3, devices={"0": {
                          "bytes_in_use": 1000, "bytes_limit": 4096}},
                      ledger={"params": 600, "opt_state": 400},
                      ledger_total_bytes=1000, source="fit"))
        ev.append(_ev(111.0, 21, "memory", live_array_bytes=2000 + p,
                      live_array_count=4, devices={"0": {
                          "bytes_in_use": 4000, "bytes_limit": 4096}},
                      ledger={"params": 600, "opt_state": 1400},
                      ledger_total_bytes=2000, source="fit"))
    ev = shards[1]
    ev.append(_ev(104.5, 30, "span", name="compile", seconds=0.5,
                  warmup=False, span_id="c1"))
    ev += [_ev(105.0, 31, "span", name="queue", seconds=0.01,
               trace_id="req-1", span_id="q", parent_id="f"),
           _ev(105.1, 32, "span", name="forward", seconds=0.05,
               trace_id="req-1", span_id="f"),
           _ev(105.2, 33, "request", id="req-1", ok=True, total_s=0.07,
               trace_id="req-1"),
           _ev(106.0, 34, "cost", entry="step", shape=[4, 8], flops=1e9,
               peak_temp_bytes=2048),
           _ev(106.1, 35, "cost_drift", predicted_bytes=100,
               measured_bytes=5000, ratio=50.0, factor=8.0,
               source="fit")]
    for p, ev in shards.items():
        with open(f"{base}.p{p}", "w") as f:
            for e in ev:
                f.write(json.dumps(e) + "\n")
    return str(base)


def _port_fit_log(tmp_path):
    """The telemetry of the port's 2-layer LM fit with a Recorder."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.telemetry import (
        Recorder,
        TelemetryListener,
        set_default,
    )

    path = str(tmp_path / "fit.jsonl")
    rec = Recorder(path)
    prev = set_default(rec)
    try:
        net = transformer_lm(vocab_size=64, d_model=32, n_heads=2,
                             n_layers=2, d_ff=64, max_length=16,
                             device="cpu").init(0)
        net.set_listeners(TelemetryListener(rec))
        rng = np.random.default_rng(0)
        for _ in range(3):
            x = rng.integers(0, 64, (4, 16)).astype(np.int32)
            net.fit(DataSet(x, np.roll(x, -1, 1)))
        with rec.span("forward", rows=4):
            net.output(x)
    finally:
        set_default(prev)
        rec.close()
    return path


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traces")
    return {"hand": _hand_written(tmp), "fit": _port_fit_log(tmp)}


TEXT_COMMANDS = [["stats"], ["stats", "--json"], ["check"],
                 ["check", "--json"], ["check", "--fail-on", "retrace"],
                 ["check", "--skew-ms", "10", "--drift-factor", "100"],
                 ["tree"], ["tree", "--trace", "req-1"],
                 ["tree", "--trace", "missing"], ["mem"], ["mem", "--json"]]


@pytest.mark.parametrize("which", ["hand", "fit"])
@pytest.mark.parametrize("cmd", TEXT_COMMANDS, ids=" ".join)
def test_the_port_tool_prints_what_the_jax_tool_prints(logs, which, cmd):
    argv = [cmd[0], logs[which], *cmd[1:]]
    want = _run(JAX_TOOL, argv)
    got = _run(PORT_TOOL, argv)
    assert got == want
    if which == "hand" and cmd == ["check"]:
        assert want[0] == 1 and "straggler" in want[1]


@pytest.mark.parametrize("which", ["hand", "fit"])
@pytest.mark.parametrize("cmd", [["merge", "-o"], ["export", "--perfetto",
                                                   "-o"],
                                 ["stats", "--artifact"]], ids=" ".join)
def test_the_port_tool_writes_what_the_jax_tool_writes(logs, which, cmd,
                                                       tmp_path):
    outs = []
    for tool, name in ((JAX_TOOL, "jax"), (PORT_TOOL, "port")):
        path = str(tmp_path / f"{name}.out")
        rc, text = _run(tool, [cmd[0], logs[which], *cmd[1:], path])
        outs.append((rc, text.replace(path, "OUT"),
                     Path(path).read_bytes()))
    assert outs[0] == outs[1]
    if cmd[0] == "export":
        doc = json.loads(outs[1][2])
        assert doc["traceEvents"]


def test_the_port_tools_import_no_jax(logs, tmp_path):
    code = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('t', sys.argv[1])\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "rc = mod.main(sys.argv[2:])\n"
        "print(json.dumps({'rc': rc, 'jax': 'jax' in sys.modules,\n"
        "  'jax_pkg': 'deeplearning4j_tpu' in sys.modules,\n"
        "  'torch': 'torch' in sys.modules}))\n")
    env = {"PATH": "", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    runs = {
        "tracetool": [str(ROOT / "port_tools/tracetool.py"), "stats",
                      logs["hand"]],
        "trafficreplay": [str(ROOT / "port_tools/trafficreplay.py"),
                          "--model", "mlp", "--requests", "3", "--device",
                          "cpu", "--telemetry",
                          str(tmp_path / "replay.jsonl")],
    }
    for name, argv in runs.items():
        out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode == 0, out.stderr
        flags = json.loads(out.stdout.strip().splitlines()[-1])
        assert flags["rc"] == 0 and not flags["jax"] \
            and not flags["jax_pkg"], (name, flags)
        if name == "tracetool":
            assert not flags["torch"]
    # the replay's telemetry reads back through the port's tracetool
    rc, text = _run(PORT_TOOL, ["check", str(tmp_path / "replay.jsonl")])
    assert rc == 0, text


@pytest.mark.parametrize("mode", [["--generate"], ["--model", "lm"]],
                         ids=["generate", "predict"])
def test_trafficreplay_serves_on_the_cpu(mode, tmp_path):
    tel = str(tmp_path / "t.jsonl")
    rc, text = _run(REPLAY, [*mode, "--requests", "4", "--device", "cpu",
                             "--telemetry", tel])
    assert rc == 0
    summary = json.loads(text.strip().splitlines()[-1])
    assert summary["metric"] == "summary" and summary["telemetry"] == tel
    rc, _ = _run(PORT_TOOL, ["check", tel])
    assert rc == 0


def test_trafficreplay_asks_for_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert REPLAY.main(["--requests", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_the_schema_is_the_jax_packages():
    assert EVENT_KINDS == jrecorder.EVENT_KINDS
    assert SPAN_NAMES == jrecorder.SPAN_NAMES


def _literal(node):
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def test_every_literal_event_and_span_is_registered():
    """Over every .py of the port's package and of port_tools/ (the
    sweep, the trace and traffic tools), as the JAX package's G023 lints
    its own package."""
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) \
        + sorted((ROOT / "port_tools").glob("*.py"))
    assert ROOT / "port_tools" / "kerneltune.py" in files
    bad, seen = [], 0
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("event", "span") and node.args):
                continue
            lit = _literal(node.args[0])
            if lit is None:
                continue
            seen += 1
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            if node.func.attr == "span":
                if lit not in SPAN_NAMES:
                    bad.append((where, "span", lit))
                continue
            if lit not in EVENT_KINDS:
                bad.append((where, "event", lit))
            elif lit == "span":
                for kw in node.keywords:
                    name = _literal(kw.value) if kw.arg == "name" else None
                    if name is not None and name not in SPAN_NAMES:
                        bad.append((where, "span name", name))
    assert seen > 20
    assert not bad, bad
