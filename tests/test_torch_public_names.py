"""C15: every top-level public name of a JAX-package module resolves in
its twin under deeplearning4j_tpu_torch/, or stands on ALLOWLIST with
the reason the port does without it. C16: the audits' entry points run
on the card unless the caller names the CPU.

The name walk reads both trees by AST: it imports neither package.
"""

from __future__ import annotations

import ast
import functools
import inspect
import os

import pytest

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "deeplearning4j_tpu", "deeplearning4j_tpu_torch"

_COMPAT = "a jax shim (util/compat.py, which has no twin)"
_PALLAS = ("a Pallas block constant; the port's CUDA tiles are fixed at "
           "compile time")
_VMEM = ("a Pallas VMEM block param; the port's knobs are its own "
         "(ops/autotune.py validate_table refuses these families)")
_JIT = "a jit helper; the port runs its steps eagerly (nn/training.py)"
_FLAT = ("the JAX flat updater layout; the port maps it in "
         "upgrade_flat_layout / unflatten_flat")
_SHARDING = "builds jax shardings; the port places leaves with set_mesh"
_READER = ("reads a jaxpr or HLO; the port's audits read the op "
           "recorder's graph")
_TUNE = ("the autotune module handle for a Pallas block; this port "
         "module has no tuned param")

# "path in the package:name" -> why the port has no such name
ALLOWLIST = {
    **{f"ops/autotune.py:{n}": _VMEM for n in (
        "BLOCK", "DEFAULT_BLOCK_K_MAX", "DEFAULT_BLOCK_Q_MAX",
        "DEFAULT_DECODE_BLOCK_K", "DEFAULT_LN_ROW_BLOCK",
        "DEFAULT_NEG_SOFTMAX_ROW_BLOCK", "DEFAULT_SAMPLE_ROW_BLOCK",
        "DEFAULT_XENT_BLOCK_N", "DEFAULT_XENT_BLOCK_V", "decode_block",
        "decode_block_q8", "flash_blocks", "flash_g", "ln_rows",
        "neg_softmax_rows", "sample_rows", "xent_blocks")},
    **{f"ops/fused_softmax_xent.py:{n}": _PALLAS
       for n in ("BLOCK_N", "BLOCK_V", "LANES")},
    **{f"ops/flash_attention.py:{n}": _PALLAS
       for n in ("BLOCK_K_MAX", "LANES")},
    "ops/fused_softmax_xent.py:tpu_compiler_params":
        "Mosaic compiler params of a pallas_call",
    "ops/flash_attention.py:tpu_compiler_params":
        "Mosaic compiler params of a pallas_call",
    "ops/flash_attention.py:pick_block":
        "picks a Pallas block; the port's flash tiles are fixed at "
        "compile time (ops/autotune.py pick_block sizes the chunk tile)",
    "ops/flash_attention.py:traced_tile_calls":
        "counts the pallas_calls one jaxpr traces; the port's chunk loop "
        "is not traced (chunk_pairs counts its launches)",
    "ops/decode_attention.py:autotune":
        _TUNE + " (the decode cache attention is plain PyTorch)",
    "ops/fused_neg_softmax.py:autotune":
        _TUNE + " (K13 takes no tuned param)",
    **{f"nn/training.py:{n}": _JIT for n in (
        "make_eval_step", "make_scanned_fit", "stack_batches")},
    "nn/training.py:mesh_shardings": _SHARDING,
    "nn/training.py:pad_batch_to_multiple":
        "pads a jit batch; the port pads in parallel/placement.py "
        "sharded_forward",
    **{f"nn/updater.py:{n}": _FLAT for n in (
        "FLAT_LAYOUT_VERSION", "flat_state_size", "flatten_transform",
        "rebuild_other_layout", "unflatten_state_like")},
    "nn/updater.py:FlatViewTransform":
        "the fused flat optimizer step; ROADMAP A1 ports it",
    "telemetry/costbook.py:harvest":
        "reads XLA's cost analysis; the port counts its own flops",
    "parallel/tensor_parallel.py:param_shardings": _SHARDING,
    "parallel/placement.py:exit_pipeline":
        "the port's is leave_placement",
    "parallel/pipeline.py:pcast_varying": _COMPAT,
    "parallel/pipeline.py:shard_map": _COMPAT,
    "parallel/expert_parallel.py:shard_map": _COMPAT,
    "embedding/engine.py:shard_map": _COMPAT,
    **{f"reshard/executor.py:{n}": _SHARDING for n in (
        "SpecBox", "live_identity", "live_transfer",
        "replicated_spec_tree", "shardings_from_specs")},
    **{f"analysis/collective_audit.py:{n}": _READER for n in (
        "HLO_COLLECTIVES", "JAXPR_COLLECTIVES", "hlo_collectives",
        "jaxpr_collectives", "trace_signature")},
    "analysis/collective_audit.py:simulated_process_index":
        "patches jax.process_index; the port's twin is "
        "simulated_process_group",
    **{f"analysis/precision_audit.py:{n}": _READER
       for n in ("profile_closed", "trace_closed", "trace_profile")},
    "analysis/ast_rules.py:g001_traced_bool":
        "the port's rule is g001_tensor_bool (a tensor's truth value)",
    "analysis/ast_rules.py:g005_retrace_hazards":
        "the port's rule is g005_recompile_hazards",
}


def _targets(node):
    for e in ast.walk(node):
        if isinstance(e, ast.Name):
            yield e.id


def _top_level(body):
    """Statements at module level, those under if / try included."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers
                                     for s in h.body])


def public_names(path: str, pkg: str, *, port: bool) -> set[str]:
    """The module's top-level public names: defs, classes, assignments
    and imported names. Of the JAX side only names imported from inside
    its package count (`import jax` is not a name a caller looks for);
    of the port every import counts, with the keys of a `_LAZY` table
    (names a PEP 562 `__getattr__` resolves)."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                out.update(_targets(t))
            if port and any(isinstance(t, ast.Name) and t.id == "_LAZY"
                            for t in node.targets):
                out.update(k.value for k in node.value.keys)
        elif isinstance(node, ast.AnnAssign):
            out.update(_targets(node.target))
        elif isinstance(node, ast.ImportFrom):
            inside = node.level > 0 or \
                (node.module or "").split(".")[0] == pkg
            if port or inside:
                out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import) and port:
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_") or n == "__version__"}


@functools.lru_cache(maxsize=None)
def _names(path: str, pkg: str, port: bool) -> frozenset:
    return frozenset(public_names(path, pkg, port=port))


@functools.lru_cache(maxsize=None)
def twin_pairs():
    """{path in the package: (JAX file, port file)} of every module
    whose twin sits under the same path."""
    out = {}
    jax_root = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(jax_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            jax_file = os.path.join(dirpath, f)
            rel = os.path.relpath(jax_file, jax_root).replace(os.sep, "/")
            port_file = os.path.join(ROOT, PORT_PKG, rel)
            if os.path.exists(port_file):
                out[rel] = (jax_file, port_file)
    return out


def missing_names(pairs=None) -> dict[str, set[str]]:
    """{path: JAX public names its port twin lacks}."""
    out = {}
    for rel, (jax_file, port_file) in sorted((pairs or twin_pairs())
                                             .items()):
        gone = _names(jax_file, JAX_PKG, False) \
            - _names(port_file, PORT_PKG, True)
        if gone:
            out[rel] = gone
    return out


def test_every_jax_public_name_resolves_in_the_port_or_is_allowlisted():
    pairs = twin_pairs()
    assert len(pairs) > 150, "the twin walk found too few pairs"
    unlisted = sorted(f"{rel}:{n}" for rel, names in
                      missing_names(pairs).items() for n in names
                      if f"{rel}:{n}" not in ALLOWLIST)
    assert not unlisted, (
        "public names of the JAX package that the port lacks (port them, "
        f"or allowlist them with a reason): {unlisted}")


def test_allowlist_entries_have_a_reason_and_name_a_missing_name():
    pairs = twin_pairs()
    missing = missing_names(pairs)
    stale = []
    for key, reason in ALLOWLIST.items():
        rel, name = key.rsplit(":", 1)
        assert isinstance(reason, str) and reason.strip(), \
            f"{key}: an allowlist entry needs its reason"
        if name not in missing.get(rel, ()):
            stale.append(key)
    assert not stale, ("allowlist entries whose name the JAX module no "
                       f"longer has, or the port now has: {stale}")


def test_the_walk_sees_a_missing_name(tmp_path):
    """A name the port drops is found, and one it gains is not."""
    (tmp_path / "j.py").write_text(
        "from deeplearning4j_tpu.x import A\nimport jax\n"
        "def f(): pass\nB = 1\n_c = 2\n")
    (tmp_path / "p.py").write_text(
        "from deeplearning4j_tpu_torch.x import A\nimport torch\n"
        "_LAZY = {'B': 'm'}\n")
    got = missing_names({"m.py": (str(tmp_path / "j.py"),
                                  str(tmp_path / "p.py"))})
    assert got == {"m.py": {"f"}}


def test_root_names_resolve_lazily():
    """`import deeplearning4j_tpu_torch` loads none of nn/; the root's
    container and configuration names resolve at first use."""
    import subprocess
    import sys

    code = (
        "import sys, deeplearning4j_tpu_torch as d\n"
        "assert 'deeplearning4j_tpu_torch.nn.multilayer' not in "
        "sys.modules\n"
        "from deeplearning4j_tpu_torch import MultiLayerNetwork, "
        "ComputationGraph, NeuralNetConfiguration, "
        "MultiLayerConfiguration, ComputationGraphConfiguration, "
        "__version__\n"
        "from deeplearning4j_tpu_torch.nn.multilayer import "
        "MultiLayerNetwork as M\n"
        "assert MultiLayerNetwork is M and __version__ == '0.1.0'\n"
        "assert 'MultiLayerNetwork' in dir(d)\n"
        "try:\n    d.NoSuchName\nexcept AttributeError:\n    pass\n"
        "else:\n    raise SystemExit('no AttributeError')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_supports_answer_for_the_cuda_kernels():
    import torch

    from deeplearning4j_tpu_torch.ops import fused_layernorm, \
        fused_neg_softmax

    # ragged rows and widths the Pallas envelope refuses
    assert fused_layernorm.supports((3, 5, 7))
    assert fused_layernorm.supports((3, 7), torch.bfloat16)
    assert not fused_layernorm.supports((3, 7), torch.float16)
    assert not fused_layernorm.supports((7,))
    assert not fused_layernorm.supports((0, 7))
    assert fused_neg_softmax.supports(3, 200, 7)
    assert not fused_neg_softmax.supports(4, 0, 64)


def _audit_entries():
    from deeplearning4j_tpu_torch.analysis import (
        collective_audit as ca,
        precision_audit as pa,
    )
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.reshard import executor

    build = lambda: (lambda: None, ())  # noqa: E731
    return {
        "precision_audit.build_extra":
            lambda: pa.build_extra("fused_sampling/k12"),
        "precision_audit.record": lambda: pa.record("toy", build=build),
        "precision_audit.load_budget": lambda: pa.load_budget(),
        "precision_audit.audit": lambda: pa.audit([]),
        "precision_audit.audit_paths": lambda: pa.audit_paths([]),
        "precision_audit.check_rank_independence":
            lambda: pa.check_rank_independence("toy", build),
        "collective_audit.record_signature":
            lambda: ca.record_signature(build, 0, 2),
        "collective_audit.check_divergence":
            lambda: ca.check_divergence("toy", build),
        "collective_audit.check_moves":
            lambda: ca.check_moves("toy", lambda r: build, 2),
        "collective_audit.audit": lambda: ca.audit([]),
        "collective_audit.audit_paths": lambda: ca.audit_paths([]),
        "collective_audit.simulated_process_group":
            lambda: ca.simulated_process_group(0, 2).__enter__(),
        "bootstrap.simulated_group":
            lambda: bootstrap.simulated_group(0, 2).__enter__(),
        "executor.virtual_mesh": lambda: executor.virtual_mesh({"a": 1}),
    }


@pytest.mark.parametrize("entry", sorted(_audit_entries()))
def test_audit_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, each entry point first asks the
    package's `resolve_device` (CUDA unless named), and its signature's
    default is None."""
    import deeplearning4j_tpu_torch as root
    from deeplearning4j_tpu_torch.reshard import executor

    class Asked(Exception):
        pass

    def spy(device=None):
        assert device is None
        raise Asked

    monkeypatch.setattr(root, "resolve_device", spy)
    monkeypatch.setattr(executor, "resolve_device", spy)
    with pytest.raises(Asked):
        _audit_entries()[entry]()
    mod, name = entry.split(".")
    fn = {"precision_audit": "deeplearning4j_tpu_torch.analysis."
                             "precision_audit",
          "collective_audit": "deeplearning4j_tpu_torch.analysis."
                              "collective_audit",
          "bootstrap": "deeplearning4j_tpu_torch.distributed.bootstrap",
          "executor": "deeplearning4j_tpu_torch.reshard.executor"}[mod]
    import importlib

    target = getattr(importlib.import_module(fn), name)
    target = getattr(target, "__wrapped__", target)
    assert inspect.signature(target).parameters["device"].default is None
