"""The port's graftlint (deeplearning4j_tpu_torch/analysis/,
port_tools/graftlint.py) against the JAX package's: every JAX rule ID is
either a port rule proven on a torch-spelled positive AND negative fixture
(tests/fixtures/torch_port/lint/) or on the documented list of rules with
no counterpart; the Finding, suppression and baseline contracts are the
JAX package's; the CLI keeps its flags and exit codes; the AST stage runs
with torch, jax and the JAX package unimportable; and the port's own tree
checks clean against its committed baseline."""

import json
import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu.analysis import RULE_DOCS as JAX_RULE_DOCS
from deeplearning4j_tpu.analysis import core as jax_core
from deeplearning4j_tpu_torch.analysis import (NO_COUNTERPART, RULE_DOCS,
                                               STAGES, lint_source,
                                               load_baseline,
                                               split_baselined,
                                               write_baseline)
from deeplearning4j_tpu_torch.analysis.core import Finding

pytestmark = [pytest.mark.port, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deeplearning4j_tpu_torch")
FIX = os.path.join(ROOT, "tests", "fixtures", "torch_port", "lint")
JAX_FIX = os.path.join(ROOT, "tests", "fixtures")
CLI = os.path.join(ROOT, "port_tools", "graftlint.py")

# the threading rules read threading, not torch: their fixtures are the
# JAX package's own, linted at the same paths
SHARED_FIXTURES = {
    "G025": ("conc_race_pos.py", "conc_race_neg.py"),
    "G027": ("serving/conc_wait_pos.py", "serving/conc_wait_neg.py"),
    "G028": ("conc_thread_pos.py", "conc_thread_neg.py"),
}


def _fixture(rule, kind):
    """(source, lint path) of a rule's on-disk fixture; a torch fixture
    names its lint path on its first line."""
    if rule in SHARED_FIXTURES:
        rel = SHARED_FIXTURES[rule][kind == "neg"]
        with open(os.path.join(JAX_FIX, rel), encoding="utf-8") as fh:
            return fh.read(), f"tests/fixtures/{rel}"
    with open(os.path.join(FIX, f"{rule.lower()}_{kind}.py"),
              encoding="utf-8") as fh:
        src = fh.read()
    return src, src.splitlines()[0].split("lint-path:")[1].strip()


def _rules(src, path):
    return {f.rule for f in lint_source(src, path)}


PORT_RULES = sorted(set(RULE_DOCS) - NO_COUNTERPART)


@pytest.mark.parametrize("rule", PORT_RULES)
def test_rule_fires_on_positive_not_negative(rule):
    pos, pos_path = _fixture(rule, "pos")
    neg, neg_path = _fixture(rule, "neg")
    assert rule in _rules(pos, pos_path), f"{rule} missed its positive"
    assert rule not in _rules(neg, neg_path), f"{rule} false-positive"


def test_every_jax_rule_is_ported_or_documented():
    """Each JAX rule ID is a port rule with a fixture pair, or a rule the
    port keeps with no counterpart (its RULE_DOCS line says why)."""
    assert set(JAX_RULE_DOCS) == set(RULE_DOCS)
    torch_pairs = {f[:4].upper() for f in os.listdir(FIX)
                   if f.endswith("_pos.py")}
    for rule in sorted(JAX_RULE_DOCS):
        if rule in NO_COUNTERPART:
            assert RULE_DOCS[rule].startswith("no counterpart: "), rule
            assert not os.path.exists(
                os.path.join(FIX, f"{rule.lower()}_pos.py")), rule
        else:
            assert rule in torch_pairs or rule in SHARED_FIXTURES, rule
            assert os.path.exists(os.path.join(
                FIX, f"{rule.lower()}_neg.py")) or rule in SHARED_FIXTURES
    assert NO_COUNTERPART == {"G006", "G007", "G012"}


@pytest.mark.parametrize("rule", sorted(NO_COUNTERPART))
def test_rules_without_counterpart_find_nothing(rule):
    """G006 (shard_map arity), G007 (util/compat.py) and G012 (collective
    axis names) keep their IDs and stay silent on what JAX flags."""
    src = ("from jax.experimental.shard_map import shard_map\n"
           "import jax\n"
           "def f(x):\n"
           "    return jax.lax.psum(x, 'nowhere')\n"
           "g = shard_map(f, mesh=None, in_specs=(1, 2), out_specs=1)\n")
    path = "deeplearning4j_tpu_torch/parallel/_fixture.py"
    assert rule not in _rules(src, path)


# ----------------------------------------------------- rule scopes


def _scoped(rule, src, paths_firing, paths_quiet):
    for p in paths_firing:
        assert rule in _rules(src, p), (rule, p)
    for p in paths_quiet:
        assert rule not in _rules(src, p), (rule, p)


def test_scopes_and_blessed_paths():
    pkg = "deeplearning4j_tpu_torch"
    _scoped("G002", "def f(x):\n    return x.item()\n",
            [f"{pkg}/ops/a.py", f"{pkg}/nn/layers/a.py"],
            [f"{pkg}/serving/a.py", f"{pkg}/util/a.py"])
    _scoped("G009", "import torch.distributed as dist\n"
            "dist.init_process_group('gloo')\n",
            [f"{pkg}/parallel/a.py"], [f"{pkg}/distributed/bootstrap.py"])
    _scoped("G016", "BLOCK_Q = 512\n", [f"{pkg}/ops/flash.py"],
            [f"{pkg}/ops/autotune.py", f"{pkg}/nn/a.py"])
    _scoped("G021", "def f(e, p):\n    e.params = p\n",
            [f"{pkg}/serving/engine.py"], [f"{pkg}/serving/fleet.py"])
    _scoped("G030", "def f(syn0, i):\n    return syn0[i]\n",
            [f"{pkg}/nlp/glove.py"],
            [f"{pkg}/embedding/engine.py", f"{pkg}/nlp/lookup.py"])
    _scoped("G031", "def f(a, b):\n    return a @ b\n",
            [f"{pkg}/ops/a.py", f"{pkg}/embedding/a.py"],
            [f"{pkg}/nn/a.py"])
    _scoped("G032", "import torch\n\ndef f(x):\n"
            "    return x.to(torch.float64)\n",
            [f"{pkg}/nn/a.py"], [f"{pkg}/gradientcheck/a.py"])
    _scoped("G015", "import torch.distributed as dist\n\ndef f(grads):\n"
            "    dist.all_reduce(grads)\n",
            [f"{pkg}/nn/layers/a.py"],
            [f"{pkg}/parallel/overlap.py", f"{pkg}/nn/training.py"])
    _scoped("G029", "import torch\n\ndef f(reqs):\n    for r in reqs:\n"
            "        torch.cuda.memory_stats()\n",
            [f"{pkg}/serving/a.py"], [f"{pkg}/telemetry/memstat.py"])


def test_telemetry_names_follow_the_port_registry():
    """G023 reads the port's EVENT_KINDS/SPAN_NAMES (parsed, not
    imported): every registered name is quiet, telemetry/ is exempt."""
    from deeplearning4j_tpu_torch.telemetry.recorder import (EVENT_KINDS,
                                                             SPAN_NAMES)
    src = "".join(f"rec.event({k!r})\n" for k in sorted(EVENT_KINDS)) + \
        "".join(f"rec.span({n!r})\n" for n in sorted(SPAN_NAMES))
    assert "G023" not in _rules(src, "deeplearning4j_tpu_torch/nn/a.py")
    bad = "rec.event('made_up')\n"
    assert "G023" in _rules(bad, "deeplearning4j_tpu_torch/nn/a.py")
    assert "G023" not in _rules(
        bad, "deeplearning4j_tpu_torch/telemetry/a.py")


def test_rank_guard_follows_the_bootstrap_env_contract():
    """G010's rank test reads the port's ENV_PROCESS_ID spelling."""
    from deeplearning4j_tpu_torch.distributed.bootstrap import (
        ENV_PROCESS_ID)
    src = ("import os\nimport torch.distributed as dist\n\ndef f(t):\n"
           f"    if os.environ[{ENV_PROCESS_ID!r}] == '0':\n"
           "        dist.broadcast(t, 0)\n")
    assert "G010" in _rules(src, "deeplearning4j_tpu_torch/nn/a.py")


# ----------------------------------------------------- contracts


def test_finding_suppression_and_baseline_contracts_match_jax(tmp_path):
    src = ("import numpy as np\n\ndef f(x):\n"
           "    return x.item()  # graftlint: disable=G002 — host value\n"
           "\ndef g(x):\n    return np.asarray(x)\n")
    path = "deeplearning4j_tpu_torch/ops/_fixture.py"
    found = lint_source(src, path)
    assert [(f.rule, f.line) for f in found] == [("G002", 7)]
    f = found[0]
    assert f.fixit and f.stage == "ast"
    assert f.key == f"G002:{path}:return np.asarray(x)"
    twin = jax_core.Finding(**{k: v for k, v in f.to_json().items()})
    assert twin.key == f.key and twin.format() == f.format()
    base = tmp_path / "baseline.json"
    write_baseline(str(base), found)
    assert json.loads(base.read_text())["findings"] == [f.key]
    new, old = split_baselined(found, load_baseline(str(base)))
    assert new == [] and old == found
    assert STAGES == ("ast", "ops", "spmd", "concurrency", "precision")


def test_syntax_error_is_a_finding():
    found = lint_source("def f(:\n", "deeplearning4j_tpu_torch/a.py")
    assert [f.rule for f in found] == ["G000"]
    assert isinstance(found[0], Finding)


def test_fixed_recorder_reads_the_one_env_spelling(monkeypatch):
    """Queue C, C11: the recorder's per-process log name follows
    distributed/bootstrap.py's ENV_PROCESS_ID (G009 found a second
    literal spelling of the contract in telemetry/recorder.py)."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.telemetry import recorder
    assert not hasattr(recorder, "ENV_PROCESS_ID")
    monkeypatch.setattr(bootstrap, "ENV_PROCESS_ID", "DL4J_TEST_PID")
    monkeypatch.setenv("DL4J_TEST_PID", "3")
    assert recorder._process_scoped("log.jsonl") == "log.jsonl.p3"
    monkeypatch.delenv("DL4J_TEST_PID")
    assert recorder._process_scoped("log.jsonl") == "log.jsonl"


# ----------------------------------------------------- the CLI


def _cli(*args, poison=False):
    """Run the port's CLI; with `poison`, torch, jax and the JAX package
    are made unimportable first."""
    if poison:
        code = ("import runpy, sys\n"
                "for m in ('torch', 'jax', 'deeplearning4j_tpu'):\n"
                "    sys.modules[m] = None\n"
                f"sys.argv = {[CLI, *args]!r}\n"
                f"runpy.run_path({CLI!r}, run_name='__main__')\n")
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable, CLI, *args]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_cli_checks_the_port_clean_without_torch():
    """The port's tree exits 0 against the committed baseline, through
    the AST stage with torch, jax and the JAX package unimportable; the
    JSON labels every grandfathered finding with its stage."""
    proc = _cli("--check", "--json", PKG, poison=True)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["findings"] == []
    assert out["grandfathered"]
    assert {f["stage"] for f in out["grandfathered"]} <= {"ast",
                                                          "precision"}


def test_cli_check_fails_on_findings_and_stages_filter(tmp_path):
    pos = os.path.join(FIX, "g010_pos.py")
    bad = tmp_path / "deeplearning4j_tpu_torch" / "parallel" / "bad.py"
    bad.parent.mkdir(parents=True)
    with open(pos, encoding="utf-8") as fh:
        bad.write_text(fh.read())
    empty = tmp_path / "baseline.json"
    proc = _cli("--check", "--stage", "spmd", "--baseline", str(empty),
                "--json", str(bad))
    assert proc.returncode == 1, proc.stderr
    rules = {f["rule"] for f in json.loads(proc.stdout)["findings"]}
    assert rules == {"G010"}
    # without --check the findings are reported, exit 0
    assert _cli("--stage", "spmd", "--baseline", str(empty),
                str(bad)).returncode == 0
    proc = _cli("--check", "--stage", "precision", "--baseline",
                str(empty), str(bad))
    assert proc.returncode == 0, proc.stdout


@pytest.mark.parametrize("flag,stage", [("--update-collectives", "3"),
                                        ("--update-precision", "5")])
def test_cli_unported_trace_halves_exit_two(flag, stage, tmp_path,
                                            monkeypatch, capsys):
    """The trace halves of stages 3 and 5 are ported (they exited 2
    before): each update flag records its stage's entries (here one
    cheap entry each) and writes its frozen file, at a temporary path,
    and exits 0."""
    import importlib.util

    from deeplearning4j_tpu_torch.analysis import (collective_audit,
                                                   precision_audit)
    mod, entry, args = {
        "3": (collective_audit, "ring_attention/seq4", [flag]),
        "5": (precision_audit, "fused_neg_softmax/scores",
              [flag, "--device", "cpu"])}[stage]
    path = tmp_path / f"stage{stage}.json"
    monkeypatch.setattr(mod, "BUDGET_PATH", str(path))
    monkeypatch.setattr(mod, "entry_names", lambda: [entry])
    spec = importlib.util.spec_from_file_location("_port_cli", CLI)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(args) == 0
    assert "froze" in capsys.readouterr().out
    frozen = (mod.load_budget(str(path)) if stage == "3"
              else mod.load_budget(str(path), "cpu"))
    assert list(frozen) == [entry] and frozen[entry]


def test_cli_rules_inventory_lists_every_stage():
    proc = _cli("--rules", poison=True)
    assert proc.returncode == 0, proc.stderr
    for stage in ("ast", "ops", "spmd", "concurrency", "precision"):
        assert f"stage {stage}:" in proc.stdout
    for rid in ("G001", "G034", "J001", "J004", "D001", "G012"):
        assert f"  {rid}  " in proc.stdout


def test_cli_ops_stage_needs_a_card_or_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--stage", "ops")
    assert proc.returncode == 2 and "--device cpu" in proc.stderr
