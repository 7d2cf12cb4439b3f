"""The op audit (deeplearning4j_tpu_torch/analysis/op_audit.py), the
port's counterpart of the JAX package's jaxpr audit: the same 16 entry
points (the keys of the JAX jaxpr_budget.json), the port's copy of
bench.py's LM_MODE_DIMS, every entry run on the CPU against the "cpu"
budget (J001 syncs, J002 bound, J003 float64, J004 missing; a gradient
entry's backward seen), the rules catching an `.item()` and a float64
planted in a fixture entry, and the Queue C items the audit found."""

import json
import os

import numpy as np
import pytest
import torch

import bench
from deeplearning4j_tpu.analysis import jaxpr_audit
from deeplearning4j_tpu_torch.analysis import op_audit, precision_audit

pytestmark = [pytest.mark.port, pytest.mark.lint]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The entries' ops are small: one intra-op thread runs them without
    contending with the other test workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_mode_dims_are_bench_dims():
    assert op_audit.LM_MODE_DIMS == bench.LM_MODE_DIMS
    assert op_audit.VOCAB_LM == bench.VOCAB_LM


def test_entries_are_the_jax_audit_entries():
    with open(jaxpr_audit.BUDGET_PATH) as fh:
        jax_keys = set(json.load(fh)["ops"])
    assert op_audit.entry_names() == jaxpr_audit.entry_names()
    assert set(op_audit.entry_names()) == jax_keys
    # EXPECTED_KERNELS also names the precision audit's five extras
    assert set(op_audit.EXPECTED_KERNELS) == jax_keys | set(
        precision_audit.PRECISION_EXTRA)
    budget = op_audit.load_budget()
    assert set(budget["ops"]["cpu"]) == set(budget["ops"]["cuda"]) == \
        jax_keys


@pytest.mark.parametrize("name", op_audit.entry_names())
def test_entry_passes_the_cpu_budget(name):
    torch.manual_seed(0)
    rec = op_audit.record_entry(name, "cpu")
    findings = op_audit.check_entry(rec, op_audit.budget_for("cpu").get(name),
                                    op_audit.known_syncs("cpu").get(name,
                                                                    []))
    assert findings == [], [f.format() for f in findings]
    assert rec.ops > 0 and rec.launches == {} and rec.dense_routes == 0
    if name == "flash_attention/grad" or name.startswith("lm_step/"):
        assert rec.backward_ops > 0


@pytest.fixture
def x():
    return torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4, 8), dtype=np.float32))


def test_j001_catches_a_planted_item(x):
    rec = op_audit.record_call("fixture/item", lambda: x.sum().item(), "cpu")
    assert [op for op, _ in rec.syncs] == ["aten::_local_scalar_dense"]
    found = op_audit.check_entry(rec, 100, [])
    assert [f.rule for f in found] == ["J001"]
    assert "test_torch_op_audit.py" in found[0].message
    # a sync listed under known_syncs is reported apart, not a finding
    frame = op_audit.frame_key(rec.syncs[0][1])
    assert op_audit.check_entry(rec, 100, [frame]) == []


def test_j001_catches_nonzero_boolean_masks_and_host_copies(x):
    rec = op_audit.record_call(
        "fixture/masks", lambda: (x[x > 0], torch.nonzero(x)), "cpu")
    assert sorted(op for op, _ in rec.syncs) == [
        "aten::index (boolean mask)", "aten::nonzero"]


def test_j003_catches_a_planted_float64(x):
    rec = op_audit.record_call("fixture/f64",
                               lambda: (x.double() * 2).float(), "cpu")
    found = op_audit.check_entry(rec, 100, [])
    assert {f.rule for f in found} == {"J003"}
    assert any("aten.mul.Tensor" in f.message for f in found)


def test_j002_and_j004_bounds(x):
    rec = op_audit.record_call("fixture/ops", lambda: x * 2 + 1, "cpu")
    assert rec.count == 2
    assert [f.rule for f in op_audit.check_entry(rec, 1, [])] == ["J002"]
    assert [f.rule for f in op_audit.check_entry(rec, None, [])] == ["J004"]
    assert op_audit.check_entry(rec, 2, []) == []


def test_unseen_backward_is_an_error(x):
    """A gradient entry whose backward records no op fails J002."""
    rec = op_audit.record_call("flash_attention/grad", lambda: x * 2, "cpu")
    assert rec.backward_ops == 0
    found = op_audit.check_entry(rec, 100, [])
    assert [f.snippet for f in found] == ["backward-unseen"]


def test_budget_keeps_the_other_device(tmp_path):
    path = str(tmp_path / "budget.json")
    op_audit.write_budget({"a": 100}, "cuda", path)
    op_audit.write_budget({"a": 10}, "cpu", path)
    assert op_audit.budget_for("cuda", path) == {"a": 125}
    assert op_audit.budget_for("cpu", path) == {"a": 25}
    assert op_audit.known_syncs("cuda", path) == {}


# ------------------------------------------------------ Queue C items


def test_sinusoidal_makes_no_tensor_from_host_data():
    """Queue C, C10: the positional encoding built its frequency base
    with torch.tensor(10000.0, device=...), a host->device copy that
    synced the host once a forward on the card (phase 30's first run:
    every lm_step entry). The base is now filled on the device, with the
    same values."""
    from deeplearning4j_tpu_torch.nn.layers.attention import sinusoidal
    rec = op_audit.record_call(
        "fixture/sinusoidal",
        lambda: sinusoidal(torch.arange(0, 16), 32, torch.float32), "cpu")
    with op_audit._recorder_class()() as mode:
        pe = sinusoidal(torch.arange(0, 16), 32, torch.float32)
    assert "aten.lift_fresh.default" not in mode.ops
    assert "aten.full.default" in mode.ops and rec.syncs == []
    dim = torch.arange(0, 32, 2, dtype=torch.float32)
    inv = 1.0 / torch.pow(torch.tensor(10000.0), dim / 32)
    angle = torch.arange(0, 16).to(torch.float32)[:, None] * inv
    assert torch.equal(pe[:, 0::2], torch.sin(angle))
    assert torch.equal(pe[:, 1::2], torch.cos(angle))


def test_keep_scale_rounds_on_the_host():
    """Queue C, C12: keep_scale read a scalar tensor back
    (`_local_scalar_dense`, J001 in flash_attention/dropout on the CPU);
    it now rounds to float32 with struct, to the same value."""
    from deeplearning4j_tpu_torch.ops.flash_attention import keep_scale
    rates = np.random.default_rng(0).uniform(0.0, 0.95, 2000).tolist()
    for rate in rates + [0.1, 0.2, 0.5, 1 / 3]:
        assert keep_scale(rate) == float(
            torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    rec = op_audit.record_call("fixture/keep_scale",
                               lambda: keep_scale(0.1), "cpu")
    assert rec.ops == 0


def test_shard_generator_makes_no_sync():
    """Queue C, C13 (fixed): a mesh step whose shards draw dropout apart
    seeded each shard's generator from one draw read back to the host, a
    sync the JAX package's fold_in does not make. The seed is now a hash
    of the parent's host-held state (`get_state()`, a CPU byte tensor for
    a CUDA generator too) and the shard's indices, and the parent
    advances by one draw that is never read."""
    from deeplearning4j_tpu_torch.ops.shard_scope import (shard_generator,
                                                          shard_seed)
    gen = torch.Generator().manual_seed(0)
    rec = op_audit.record_call("fixture/shard_generator",
                               lambda: shard_generator(gen, (1,), 2), "cpu")
    assert rec.syncs == []
    assert shard_generator(gen, (0,), 1) is gen
    # the same (state, indices) gives the same seed; other indices others
    state = gen.get_state()
    assert shard_seed(state, (1,)) == shard_seed(state.clone(), (1,))
    seeds = {shard_seed(state, idx) for idx in
             [(), (0,), (1,), (0, 1), (1, 0), (1, 1)]}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)
    # two parents seeded alike advance alike (every rank's step draws
    # the same next seed), each step a new one
    a, b = (torch.Generator().manual_seed(7) for _ in range(2))
    first = [torch.rand(4, generator=shard_generator(g, (1,), 2))
             for g in (a, b)]
    second = [torch.rand(4, generator=shard_generator(g, (1,), 2))
              for g in (a, b)]
    assert torch.equal(*first) and torch.equal(*second)
    assert not torch.equal(first[0], second[0])
    assert torch.equal(a.get_state(), b.get_state())
