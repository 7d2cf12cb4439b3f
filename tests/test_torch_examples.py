"""A12: each script of examples/ has a twin under examples/torch/ that
imports the same public names from deeplearning4j_tpu_torch, under the
same module paths, and nothing of jax or the JAX package; the cheapest
twin runs to its end on the CPU. The card runs all eight
(chip_smoke.py phase 32)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = sorted((ROOT / "examples").glob("*.py"))
TWINS = ROOT / "examples" / "torch"
# names a JAX script imports that its twin does without, and why
NOT_TWINNED = {
    "ensure_cpu_devices": "builds the JAX virtual 8-device mesh; a port "
                          "process holds one device (util/virtual_devices "
                          "has no twin)",
    ("moe_expert_parallel.py", "Placement"):
        "on one card the experts split over shards held in the process "
        "(tensor_parallel.place_in_process), not over a process group",
}


def _imports(path: Path, pkg: str) -> dict:
    """{name: module path below `pkg`} of the names `path` imports from
    `pkg`, and the top-level modules it imports at all."""
    names, modules = {}, set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            modules.add(node.module)
            if node.module.split(".")[0] == pkg:
                for a in node.names:
                    names[a.name] = node.module[len(pkg):]
        elif isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
    return names, modules


def test_every_example_has_a_twin_with_its_public_names():
    assert len(JAX_EXAMPLES) == 8
    for jax_script in JAX_EXAMPLES:
        twin = TWINS / jax_script.name
        assert twin.exists(), f"{jax_script.name} has no port twin"
        want, _ = _imports(jax_script, "deeplearning4j_tpu")
        got, _ = _imports(twin, "deeplearning4j_tpu_torch")
        missing = sorted(
            n for n, mod in want.items() if got.get(n) != mod
            and n not in NOT_TWINNED
            and (jax_script.name, n) not in NOT_TWINNED)
        assert not missing, f"{twin.name} lacks {missing}"


@pytest.mark.parametrize("twin", sorted(TWINS.glob("*.py")),
                         ids=lambda p: p.name)
def test_twin_imports_no_jax(twin):
    _, modules = _imports(twin, "deeplearning4j_tpu_torch")
    bad = sorted(m for m in modules
                 if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
    assert not bad, f"{twin.name} imports {bad}"


def test_the_cheapest_twin_runs_on_the_cpu():
    """moe_expert_parallel.py, its experts split over 4 shards in the
    process: 5 epochs to the output, with the loss falling."""
    proc = subprocess.run(
        [sys.executable, str(TWINS / "moe_expert_parallel.py"), "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    losses = [float(line.split()[-1]) for line in lines
              if line.startswith("epoch")]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert lines[-1] == "output: (64, 512)"
    assert "expert shards: 4" in proc.stdout
