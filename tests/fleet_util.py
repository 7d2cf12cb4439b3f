"""Shared helpers of the port's multi-rank CPU tests: a case's JAX net
and inputs, the gloo fleet that runs tests/torch_parallel_worker.py on
them, and the comparison of what the ranks trained with the JAX net.

A case is a dict: `name`, the worker's `kind`, `model` ("lm", "moe",
"mlp", "bn" or "resnet") with its `cfg`, the updater settings
(torch_parallel_worker.set_updater) and `batches` [(x, y, labels mask or
None[, features mask])]. The ranks start from the JAX net's initial params (copied with
`weights_io`) and write their results under `<case name>/`.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

from deeplearning4j_tpu.models.resnet import resnet20 as jax_resnet20
from deeplearning4j_tpu.models.transformer import (
    transformer_lm as jax_lm,
    transformer_moe_lm as jax_moe_lm,
)
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.distributed.launcher import launch_local
from torch_parallel_worker import (
    bn_graph_conf,
    flatten,
    mlp_conf,
    set_updater,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
LAUNCH_TIMEOUT = 120.0


def jax_net(case):
    """The case's JAX net, its updater set as the case says, initialized
    from the model's seed (every call gives the same params)."""
    if case["model"] == "lm":
        net = jax_lm(**case["cfg"])
    elif case["model"] == "moe":
        net = jax_moe_lm(**case["cfg"])
    elif case["model"] == "mlp":
        net = JaxMLN(mlp_conf(jconf))
    elif case["model"] == "bn":
        net = JaxGraph(bn_graph_conf(jconf))
    else:
        net = jax_resnet20()
    return set_updater(net, case).init()


def fleet_inputs(case):
    """What the ranks read: the JAX net's initial params (and state),
    the batches."""
    net = jax_net(case)
    arrays = {f"params/{k}": v for k, v in flatten(
        jax.tree.map(np.asarray, net.params)).items()}
    arrays.update({f"state/{k}": v for k, v in flatten(
        jax.tree.map(np.asarray, net.state)).items()})
    for i, (x, y, m, *fm) in enumerate(case["batches"]):
        arrays[f"x{i}"], arrays[f"y{i}"] = x, y
        if m is not None:
            arrays[f"lmask{i}"] = m
        if fm and fm[0] is not None:
            arrays[f"fmask{i}"] = fm[0]
    if "eval" in case:
        arrays["x"], arrays["y"] = case["eval"]
    return arrays


def run_fleet(tmp_path, n, cases):
    """Write the cases' inputs, run the worker on n gloo ranks under the
    launcher's deadline, and return each rank's outputs."""
    spec = []
    for case in cases:
        np.savez(tmp_path / f"{case['name']}.npz", **fleet_inputs(case))
        spec.append({k: v for k, v in case.items()
                     if k not in ("batches", "eval")})
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps({"dir": str(tmp_path), "cases": spec}))
    results = launch_local(
        [sys.executable, str(WORKER), str(spec_path)], n_processes=n,
        device="cpu", timeout=LAUNCH_TIMEOUT, death_grace=5.0, cwd=ROOT,
        extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    for r in results:
        assert r.exit_class == "clean", "\n".join(r.lines[-60:])
    return [dict(np.load(tmp_path / f"out_rank{i}.npz")) for i in range(n)]


def assert_trained_close(outs, name, jnet, tol, score_rtol=1e-5):
    """Every rank holds the same params; they (within `tol` of the
    largest JAX param), the batch-norm state and the score (within
    `score_rtol`) match the JAX net's."""
    ref = flatten(jax.tree.map(np.asarray, jnet.params))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    for key, want in ref.items():
        got = outs[0][f"{name}/params/{key}"]
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"{name}/params/{key}"],
                                          got, err_msg=key)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (name, key, err, scale)
    for key, want in flatten(jax.tree.map(np.asarray, jnet.state)).items():
        got = outs[0][f"{name}/state/{key}"]
        if np.issubdtype(want.dtype, np.floating):
            err = float(np.abs(got - want).max())
            assert err <= tol * max(float(np.abs(want).max()), 1e-12), (
                name, key, err)
    np.testing.assert_allclose(float(outs[0][f"{name}/score"]),
                               float(jnet.score_value), rtol=score_rtol)
