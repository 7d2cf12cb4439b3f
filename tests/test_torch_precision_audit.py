"""Stage 5 of the port's graftlint: the precision audit
(deeplearning4j_tpu_torch/analysis/precision_audit.py), the counterpart
of the JAX package's precision audit, with the cases of
tests/test_precision_lint.py. Every entry's dtype profile (one recorded
call of the op audit's recorder) matches the "cpu" section of the frozen
analysis/precision_budget.json with zero findings; drift trips PB01 and
a CLI exit of 1, a missing entry PB01; each P rule fires on a small
positive call and stays silent on its disciplined twin (P001's chain,
loop carry and cumulative forms and its backward exemption, P002's two
forms, P003, P004); a rank-branching dtype is P005; the torch fixture
exits non-zero with P001 and a clean tree gives labelled JSON. The int8
tallies and the products' dtypes are held to the JAX package's frozen
profiles (its precision_budget.json, read as data)."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import op_audit, precision_audit

pytestmark = [pytest.mark.port, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(ROOT, "port_tools", "graftlint.py")
ANALYSIS = os.path.join(ROOT, "deeplearning4j_tpu_torch", "analysis")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "precision_bf16_entry.py")
JAX_BUDGET = os.path.join(ROOT, "deeplearning4j_tpu", "analysis",
                          "precision_budget.json")
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The entries' ops are small: one intra-op thread runs them without
    contending with the other test workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def clean_tree(one_intra_op_thread):
    """`--check --stage precision --device cpu --json` over the port,
    run once: the AST rules and the precision audit of every entry."""
    rc, out = _run_cli("--check", "--stage", "precision", "--device",
                       "cpu", "--json")
    return rc, json.loads(out)


def _jax_profiles():
    with open(JAX_BUDGET) as fh:
        return json.load(fh)["entries"]


def _findings(fn, *args):
    """(profile, P findings) of one recorded call of fn(*args)."""
    rec = op_audit.record_call("unit", lambda: fn(*args), "cpu")
    return rec.profile, rec.precision


def _rules(findings):
    return {f.rule for f in findings}


def _t(*shape, dtype=torch.float32, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)).to(dtype)


# ------------------------------------------------ the shipped entry set

@pytest.mark.parametrize("entry", precision_audit.entry_names())
def test_entry_matches_frozen_profile_with_zero_findings(entry, clean_tree):
    rc, payload = clean_tree
    assert rc == 0, payload["findings"]
    assert [f for f in payload["findings"] if f["path"] == entry] == []
    assert payload["precision_profiles"][entry] == \
        precision_audit.load_budget(device="cpu")[entry]


def test_manifest_covers_every_entry_on_both_devices():
    """Both sections name the 21 entries; the int8 decode, sampling and
    neg-softmax entries froze non-empty profiles, and on the card the
    extras launch K12 and K13 (op_audit.EXPECTED_KERNELS)."""
    names = set(precision_audit.entry_names())
    assert len(names) == 21
    cpu = precision_audit.load_budget(device="cpu")
    cuda = precision_audit.load_budget(device="cuda")
    assert set(cpu) == set(cuda) == names
    assert cpu["decode_attention/q8"]["q8"]["dequantize"] == 2
    assert cpu["fused_sampling/sample"]["reductions"]
    assert cpu["fused_neg_softmax/scores"]["dots"]
    assert all(p["launches"] == {} for p in cpu.values())
    assert cuda["fused_sampling/sample"]["launches"] == {"K12": 1}
    assert cuda["fused_neg_softmax/scores"]["launches"] == {"K13": 1}
    assert op_audit.EXPECTED_KERNELS["fused_sampling/sample"] == ({"K12"},)
    assert all(sum(p["dots"].values()) > 0 for n, p in cpu.items()
               if n.startswith("lm_step/"))


# ---------------------------------------------- parity with JAX's files

def test_q8_tallies_equal_the_jax_ones():
    """The int8 path quantizes and dequantizes as often as JAX's: two
    dequantizes (k and v codes) in a q8 read, one of each in an update."""
    jax = _jax_profiles()
    port = precision_audit.load_budget(device="cpu")
    for entry in ("decode_attention/q8", "decode_attention/q8_update",
                  "decode_attention/cached"):
        assert port[entry]["q8"] == jax[entry]["q8"], entry


def test_product_dtypes_are_a_subset_of_the_jax_ones():
    """For the 13 entries that are not LM steps, every product dtype key
    of the port's CPU profile is one of JAX's for the entry (the bf16 LM
    steps are held so on the card, chip_smoke.py phase 30e)."""
    jax = _jax_profiles()
    port = precision_audit.load_budget(device="cpu")
    entries = [n for n in precision_audit.entry_names()
               if not n.startswith("lm_step/")]
    assert len(entries) == 13
    for entry in entries:
        assert set(port[entry]["dots"]) <= set(jax[entry]["dots"]), entry


# ------------------------------------------------------ drift tripping

def test_profile_drift_trips_named_finding_and_cli_exit(tmp_path,
                                                        monkeypatch):
    doctored = dict(precision_audit.load_budget(device="cpu"))
    doctored["fused_neg_softmax/scores"] = dict(
        doctored["fused_neg_softmax/scores"],
        dots={"bfloat16,bfloat16->bfloat16": 2})
    bad = tmp_path / "precision_budget.json"
    bad.write_text(json.dumps({"entries": {"cpu": doctored}}))

    findings, _ = precision_audit.audit(
        ["fused_neg_softmax/scores"], budget_path=str(bad),
        divergence=False, device="cpu")
    assert [f.rule for f in findings] == ["PB01"]
    assert findings[0].path == "fused_neg_softmax/scores"
    assert findings[0].stage == "precision"
    assert "drift" in findings[0].message and "dots" in findings[0].message

    monkeypatch.setattr(precision_audit, "BUDGET_PATH", str(bad))
    monkeypatch.setattr(precision_audit, "entry_names",
                        lambda: ["fused_neg_softmax/scores"])
    # the AST half over one small directory; the trace half as usual
    rc, out = _run_cli("--check", "--stage", "precision", "--device", "cpu",
                       ANALYSIS)
    assert rc == 1
    assert "PB01" in out and "fused_neg_softmax/scores" in out


def test_missing_profile_is_a_finding(tmp_path):
    empty = tmp_path / "precision_budget.json"
    empty.write_text(json.dumps({"entries": {"cpu": {}}}))
    findings, _ = precision_audit.audit(
        ["fused_neg_softmax/scores"], budget_path=str(empty),
        divergence=False, device="cpu")
    assert [f.rule for f in findings] == ["PB01"]
    assert "--update-precision" in findings[0].fixit


def test_budget_sections_keep_the_other_device(tmp_path):
    path = str(tmp_path / "budget.json")
    precision_audit.write_budget({"a": {"dots": {}}}, "cuda", path)
    precision_audit.write_budget({"a": {"dots": {"x": 1}}}, "cpu", path)
    assert precision_audit.load_budget(path, "cuda") == {"a": {"dots": {}}}
    assert precision_audit.load_budget(path, "cpu") == {
        "a": {"dots": {"x": 1}}}


# ------------------------------------------------- rank independence

def test_rank_branching_dtype_is_a_deadlock_finding():
    """A dtype decision branching on the rank runs different
    mixed-precision programs per replica: P005, stage 3's C003 class."""
    import torch.distributed as dist

    def build():
        def fn(x):
            if dist.get_rank() == 0:
                return torch.sum(x.float())
            return torch.sum(x)

        return fn, (_t(4, dtype=BF16),)

    findings = precision_audit.check_rank_independence("toy/dtype", build,
                                                       "cpu")
    assert [f.rule for f in findings] == ["P005"]
    assert "DEADLOCK" in findings[0].message
    assert findings[0].stage == "precision"


def test_rank_invariant_entry_is_clean():
    assert precision_audit.check_rank_independence(
        "decode_attention/q8", device="cpu") == []


# ------------------------------------------------ the rules, one by one

def test_p001_fires_on_bf16_chain_not_on_f32_accumulation():
    x, w = _t(16, 16, dtype=BF16), _t(16, 16, dtype=BF16, seed=1)
    _, found = _findings(lambda: torch.sum(x @ w))
    assert _rules(found) == {"P001"}
    assert "chained reduction" in found[0].message
    _, found = _findings(lambda: (x.float() @ w.float()).sum().to(BF16))
    assert found == []
    _, found = _findings(lambda: (x @ w).sum(dtype=torch.float32))
    assert found == []


def test_p001_fires_on_a_bf16_loop_carry_not_on_f32_or_residuals():
    rows = _t(8, 4, dtype=BF16)

    def running(dtype):
        def fn():
            acc = torch.zeros(4, dtype=dtype)
            for r in rows:
                acc = acc + r.to(dtype)
            return acc
        return fn

    _, found = _findings(running(BF16))
    assert _rules(found) == {"P001"}
    assert "loop carry" in found[0].message and "8 chained" in \
        found[0].message
    _, found = _findings(running(torch.float32))
    assert found == []
    # a residual stream (x + f(x), each add's other operand reads the
    # carried value) is no loop carry
    w = _t(4, 4, dtype=BF16, seed=1)

    def residual():
        h = rows[0]
        for _ in range(6):
            h = h + torch.tanh(h @ w)
        return h

    _, found = _findings(residual)
    assert found == []

    # the same stream through a kernel: its launch does not dispatch, so
    # the recorder sees an output buffer no op fills (a mode-free copy
    # stands in for the launch), which may depend on the stream
    from torch.utils._python_dispatch import _disable_current_modes

    def kernel(h):
        out = torch.empty_like(rows[0])
        with _disable_current_modes():
            out.copy_(torch.tanh(h @ w))
        return out

    def residual_through_kernel():
        h = rows[0]
        for _ in range(6):
            h = h + kernel(h)
        return h

    _, found = _findings(residual_through_kernel)
    assert found == []


def test_p001_fires_on_bf16_cumsum():
    _, found = _findings(lambda: torch.cumsum(_t(64, dtype=BF16), 0))
    assert _rules(found) == {"P001"}
    assert "cumulative" in found[0].message
    _, found = _findings(lambda: torch.cumsum(_t(64), 0))
    assert found == []


def test_p001_backward_is_exempt():
    """bf16 training calls are full of autograd's bias-grad sums over
    products; ops recorded in the backward are exempt, as the JAX audit
    exempts scopes holding add_any. The bias grad below IS a bf16 sum
    over a product: only the exemption keeps it quiet."""
    x = _t(16, 16, dtype=BF16).requires_grad_(True)
    w = _t(16, 16, dtype=BF16, seed=1).requires_grad_(True)
    b = _t(16, dtype=BF16, seed=2).requires_grad_(True)

    def grads():
        y = x @ w + b[None, :]
        z = y @ w
        return torch.autograd.grad((z * z).float().sum(), (x, w, b))

    rec = op_audit.record_call("unit", grads, "cpu")
    assert rec.backward_ops > 0
    assert rec.profile["reductions"].get("sum:bfloat16", 0) >= 1
    assert rec.precision == []
    # the same sum in the forward fires
    _, found = _findings(lambda: (x.detach() @ w.detach()).sum(0))
    assert _rules(found) == {"P001"}


def test_p002_raw_code_read_fires_scaled_read_does_not():
    codes = torch.as_tensor(np.random.default_rng(0).integers(
        -127, 128, (8, 64), np.int8))
    scale = _t(8, 1).abs()
    _, found = _findings(lambda: codes.float().sum(1))
    assert _rules(found) == {"P002"}
    assert "raw-code read" in found[0].message
    _, found = _findings(lambda: (codes.float() * scale).sum(1))
    assert found == []


def test_p002_unmasked_requantize_fires_masked_does_not():
    codes = torch.as_tensor(np.random.default_rng(0).integers(
        -127, 128, (8, 64), np.int8))
    scale, new = _t(8, 1).abs(), _t(8, 64, seed=1)
    pos = torch.arange(64).expand(8, 64)

    def rmw(masked):
        def fn():
            vals = codes.float() * scale
            vals = (torch.where(pos < 4, new, vals) if masked
                    else vals + new)
            amax = vals.abs().amax(-1, keepdim=True)
            return torch.round(vals / (amax / 127.0)).to(torch.int8)
        return fn

    _, found = _findings(rmw(False))
    assert _rules(found) == {"P002"}
    assert "write head" in found[0].message
    _, found = _findings(rmw(True))
    assert found == []


def test_p003_round_trip_churn_fires_consumed_intermediate_does_not():
    x = _t(16, dtype=BF16)
    profile, found = _findings(lambda: x.float().to(BF16) * 2.0)
    assert _rules(found) == {"P003"}
    assert profile["convert_round_trips"] == 1

    def real_value():
        up = x.float()
        return up.to(BF16) * 2.0, up.sum()

    _, found = _findings(real_value)
    assert found == []


def test_p004_widening_collective_fires_width_preserving_does_not():
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.analysis.collective_audit import (
        simulated_process_group,
    )

    def reduced(x, up):
        def fn():
            v = x.float() if up else x.clone()
            dist.all_reduce(v)
            return v
        return fn

    with simulated_process_group(0, 2, "cpu"):
        _, found = _findings(reduced(_t(4, 8, dtype=BF16), True))
        assert _rules(found) == {"P004"}
        assert "wire" in found[0].message
        _, found = _findings(reduced(_t(4, 8), False))
        assert found == []
        # a bf16 all-reduce is the other failure: a sub-f32 sum
        _, found = _findings(reduced(_t(4, 8, dtype=BF16), False))
        assert _rules(found) == {"P001"}
        assert "across ranks" in found[0].message


# --------------------------------------------------------------- CLI

def test_cli_precision_demo_exits_nonzero_with_p001():
    """`--stage precision` on the bf16 fixture exits non-zero with the
    P001 finding (the CLI's main, in this process)."""
    rc, out = _run_cli("--check", "--stage", "precision", "--device", "cpu",
                       FIXTURE)
    assert rc == 1, out
    assert "P001" in out
    assert "demo/bf16_sum_over_mm" in out


def test_fixture_audit_in_process():
    findings, profiles = precision_audit.audit_paths([FIXTURE], "cpu")
    assert [f.rule for f in findings] == ["P001"]
    assert "loop carry" in findings[0].message
    prof = profiles["demo/bf16_sum_over_mm"]
    assert prof["dots"] == {"bfloat16,bfloat16->bfloat16": 1}


def test_cli_precision_clean_tree_emits_labeled_json(clean_tree):
    rc, payload = clean_tree
    assert rc == 0
    assert payload["findings"] == []
    profiles = payload["precision_profiles"]
    assert set(profiles) == set(precision_audit.entry_names())
    assert profiles["decode_attention/q8"]["q8"]["dequantize"] == 2
