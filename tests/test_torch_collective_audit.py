"""Stage 3 of the port's graftlint: the collective audit
(deeplearning4j_tpu_torch/analysis/collective_audit.py), the counterpart
of the JAX package's collective audit, with the cases of
tests/test_spmd_lint.py. Every entry's ordered c10d signature, recorded
as simulated ranks of torch's fake process group, matches the frozen
analysis/collective_budget.json with no C003; drift trips C001 and a CLI
exit of 1, a missing entry C002; a rank-conditional collective, rank-
divergent op counts and an unmatched point-to-point move trip C003; the
simulation restores the environment and the process group; the torch
fixture exits non-zero with G010 and C003 and a clean tree gives
labelled JSON. Each entry's signature is also held to the JAX package's
frozen one (its collective_budget.json, read as data), with the relation
that entry keeps."""

import contextlib
import importlib.util
import io
import json
import os
import re

import pytest
import torch

from deeplearning4j_tpu_torch.analysis import collective_audit

pytestmark = [pytest.mark.port, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(ROOT, "port_tools", "graftlint.py")
ANALYSIS = os.path.join(ROOT, "deeplearning4j_tpu_torch", "analysis")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "spmd_divergent_entry.py")
JAX_BUDGET = os.path.join(ROOT, "deeplearning4j_tpu", "analysis",
                          "collective_budget.json")


def _cli_main():
    spec = importlib.util.spec_from_file_location("_port_graftlint_cli",
                                                  CLI)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _run_cli(*args):
    """(exit code, stdout) of the port's CLI run in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _cli_main()(list(args))
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def clean_tree():
    """`--check --stage spmd --json` over the port, run once: the AST
    rules and the collective audit of every entry."""
    rc, out = _run_cli("--check", "--stage", "spmd", "--json")
    return rc, json.loads(out)


def _jax_signatures():
    with open(JAX_BUDGET) as fh:
        return json.load(fh)["signatures"]


def _shape(item):
    """'float32[2,2,4,4]' of a signature item (either package's)."""
    dtype, dims = re.search(r"(\w+)\[([\d,]*)\]\s*$", item).groups()
    return dtype, tuple(int(d) for d in dims.split(",") if d)


# ------------------------------------------------ the shipped entry set

@pytest.mark.parametrize("entry", collective_audit.entry_names())
def test_entry_matches_frozen_signature_and_never_diverges(entry,
                                                           clean_tree):
    rc, payload = clean_tree
    assert rc == 0, payload["findings"]
    assert [f for f in payload["findings"] if f["path"] == entry] == []
    assert payload["collective_signatures"][entry] == \
        collective_audit.load_budget()[entry]


def test_frozen_file_covers_every_entry_nonempty():
    frozen = collective_audit.load_budget()
    assert set(frozen) == set(collective_audit.entry_names())
    assert all(frozen.values())
    assert all(item.startswith("allreduce_@8 ")
               for item in frozen["distributed/allreduce_step_2x4"])


# ---------------------------------------------- parity with JAX's files

def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


@pytest.mark.parametrize("entry", collective_audit.entry_names())
def test_signature_relates_to_the_jax_one(entry):
    """One relation an entry, against the JAX package's frozen file:

    - overlap: the same buckets in the same order, [27, 8, 48] elements,
      then the loss. The port reduces the loss as a one-element vector
      (float32[1]) where JAX psums a scalar (float32[]).
    - allreduce: the port reduces one flat vector where GSPMD reduces
      each param: its elements total JAX's 48 + 8 + 24 + 3 = 83, then the
      loss (float32[1] against float32[]).
    - ring and SP: every hop (send and recv) moves JAX's ppermute shape;
      the port's ring ends with an all-gather of the output, which JAX
      leaves sharded.
    - reshard: the port moves point-to-point pieces where GSPMD
      all-gathers; the pieces this rank receives, with what it holds,
      fill its destination shards, whose shapes are the destination
      layout's (w [4, 8], its rows over "model" of {data 4, model 2}; b
      [8], replicated)."""
    port = collective_audit.load_budget()[entry]
    jax = _jax_signatures()[entry]
    if entry == "distributed/overlap_step_2x4":
        assert [_numel(_shape(i)[1]) for i in port] == \
            [_numel(_shape(i)[1]) for i in jax] == [27, 8, 48, 1]
        assert _shape(port[-1]) == ("float32", (1,))
        assert _shape(jax[-1]) == ("float32", ())
    elif entry == "distributed/allreduce_step_2x4":
        grads = [_numel(_shape(i)[1]) for i in jax[:-1]]
        assert grads == [48, 8, 24, 3]
        assert [_shape(i) for i in port] == [("float32", (sum(grads),)),
                                             ("float32", (1,))]
    elif entry in ("ring_attention/seq4",
                   "sequence_parallel/sp_step_seq2"):
        hop = {_shape(i) for i in jax if i.startswith("ppermute")}
        assert len(hop) == 1
        moves = [i for i in port if i.startswith(("send@", "recv_@"))]
        assert moves and {_shape(i) for i in moves} == hop
    else:
        assert [i.split()[0] for i in jax] == ["hlo:all-gather"] * 2
        with collective_audit.simulated_process_group(0, 8, "cpu"):
            fn, args = collective_audit._builder(entry, "cpu", 0)()
            out, _ = fn(*args)
        shapes = {k[-1]: tuple(t.shape) for k, t in out[0].items()}
        assert shapes == {("w",): (4, 8), ("b",): (8,)}
        got = sum(_numel(_shape(i)[1]) for i in port
                  if i.startswith("recv_"))
        # rank 0 holds w's columns 0-1 and b's 0-1; it needs w's rows 0-3
        # and all of b
        assert got == (4 * 8 - 4 * 2) + (8 - 2)


# ------------------------------------------------------ drift tripping

def test_signature_drift_trips_named_finding_and_cli_exit(tmp_path,
                                                          monkeypatch):
    frozen = collective_audit.load_budget()
    mutated = dict(frozen)
    mutated["ring_attention/seq4"] = ["allreduce_@4 float32[2]"]
    bad = tmp_path / "collective_budget.json"
    bad.write_text(json.dumps({"signatures": mutated}))

    findings, _ = collective_audit.audit(
        ["ring_attention/seq4"], budget_path=str(bad), divergence=False,
        device="cpu")
    assert [f.rule for f in findings] == ["C001"]
    assert findings[0].path == "ring_attention/seq4"
    assert findings[0].stage == "spmd"
    assert "signature drift" in findings[0].message
    assert "allreduce_@4 float32[2]" in findings[0].message

    monkeypatch.setattr(collective_audit, "BUDGET_PATH", str(bad))
    monkeypatch.setattr(collective_audit, "entry_names",
                        lambda: ["ring_attention/seq4"])
    # the AST half over one small directory; the trace half as usual
    rc, out = _run_cli("--check", "--stage", "spmd", ANALYSIS)
    assert rc == 1
    assert "C001" in out and "ring_attention/seq4" in out


def test_missing_signature_is_a_finding(tmp_path):
    empty = tmp_path / "collective_budget.json"
    empty.write_text(json.dumps({"signatures": {}}))
    findings, _ = collective_audit.audit(
        ["ring_attention/seq4"], budget_path=str(empty), divergence=False,
        device="cpu")
    assert [f.rule for f in findings] == ["C002"]
    assert "--update-collectives" in findings[0].fixit


# ------------------------------------------------- divergence/deadlock

def test_rank_conditional_collective_is_a_deadlock_finding():
    findings, sigs = collective_audit.audit_paths([FIXTURE], "cpu")
    assert [f.rule for f in findings] == ["C003"]
    msg = findings[0].message
    assert "DEADLOCK" in msg
    assert "process 0 issues ['allreduce_@2 float32[4]']" in msg
    assert "process 1 issues []" in msg
    assert findings[0].stage == "spmd"
    assert sigs["demo/rank_conditional_all_reduce"] == [
        "allreduce_@2 float32[4]"]


def test_rank_divergent_op_count_is_the_same_class():
    """A rank-dependent value steering the program (no collective in
    sight) still desyncs the replicas: C003 through the op counts."""
    import torch.distributed as dist

    def build():
        def fn(x):
            if dist.get_rank() == 0:
                return x + 1.0
            return (x * 2.0) + (x * 3.0)

        return fn, (torch.ones(2),)

    findings = collective_audit.check_divergence("toy/op_count", build,
                                                device="cpu")
    assert [f.rule for f in findings] == ["C003"]
    assert "aten ops" in findings[0].message
    # a program allowed to differ by rank (a causal ring) is held to its
    # collectives only
    assert collective_audit.check_divergence("toy/op_count", build,
                                             same_program=False,
                                             device="cpu") == []


def test_unmatched_point_to_point_move_is_a_deadlock_finding():
    """The reshard entry's ranks send and receive different pieces by
    design: C003 there is a send r -> s with no matching recv on s."""
    sigs = {0: ["send@+1 float32[4,2]", "recv_@+1 float32[2]"],
            1: ["recv_@+1 float32[4,2]", "send@+1 float32[2]"]}
    assert collective_audit.unmatched_moves(sigs, 2) == []
    sigs[1] = ["recv_@+1 float32[2,4]", "send@+1 float32[2]"]
    bad = collective_audit.unmatched_moves(sigs, 2)
    assert bad == ["0->1: sends ['float32[4,2]'] but recvs ['float32[2,4]']"]

    def build_at(rank):
        def build():
            import torch.distributed as dist

            def fn(x):
                if rank == 0:   # rank 1 never posts the matching recv
                    dist.send(x, 1)
            return fn, (torch.ones(3),)
        return build

    findings = collective_audit.check_moves("toy/moves", build_at, 2, "cpu")
    assert [f.rule for f in findings] == ["C003"]
    assert "0->1" in findings[0].message


def test_simulated_process_group_restores_state():
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.distributed import bootstrap

    before_env = {v: os.environ.get(v) for v in (
        bootstrap.ENV_PROCESS_ID, bootstrap.ENV_NUM_PROCESSES)}
    before_dev = bootstrap._device
    with collective_audit.simulated_process_group(3, 4, "cpu"):
        assert dist.get_rank() == 3 and dist.get_world_size() == 4
        assert os.environ[bootstrap.ENV_PROCESS_ID] == "3"
        assert os.environ[bootstrap.ENV_NUM_PROCESSES] == "4"
        assert bootstrap.process_device() == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no process group"):
            with collective_audit.simulated_process_group(0, 2, "cpu"):
                pass
    assert not dist.is_initialized()
    assert bootstrap._device is before_dev
    assert {v: os.environ.get(v) for v in before_env} == before_env
    # an exception inside tears it down as well
    with pytest.raises(ValueError):
        with collective_audit.simulated_process_group(1, 2, "cpu"):
            raise ValueError("boom")
    assert not dist.is_initialized()


# --------------------------------------------------------------- CLI

def test_cli_spmd_demo_exits_nonzero_with_both_finding_classes():
    """`--stage spmd` on the divergent fixture exits non-zero with the
    G010 AST finding and the C003 deadlock finding naming both
    sequences (the CLI's main, in this process)."""
    rc, out = _run_cli("--check", "--stage", "spmd", FIXTURE)
    assert rc == 1, out
    assert "G010" in out and "C003" in out
    assert "DEADLOCK" in out
    assert "process 0 issues" in out


def test_cli_spmd_clean_tree_emits_labeled_json(clean_tree):
    rc, payload = clean_tree
    assert rc == 0
    assert payload["findings"] == []
    sigs = payload["collective_signatures"]
    assert set(sigs) == set(collective_audit.entry_names())
    assert sigs["distributed/allreduce_step_2x4"]
