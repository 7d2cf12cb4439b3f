"""The port's tuning layer (deeplearning4j_tpu_torch/ops/autotune.py),
its table and its sweep (port_tools/kerneltune.py) on the CPU, against
the JAX package's ops/autotune.py where the two share a contract.

* Key strings and `parse_key` equal JAX's; `validate_table` rejects what
  JAX's rejects (schema, unknown family, bad params) and the JAX-only
  families; the checked-in table is valid, names the card it was
  measured on, and each entry matches or beats its default.
* `override` beats the table; the table is off on the CPU and forced or
  switched off by DL4J_TPU_TUNING; a tuned entry reaches each wrapper's
  resolution, and an invalid one falls back with a warning and a
  `kernel_tune` event of role "rejected".
* `chunk_tile` and `max_tile_for_dim` equal JAX's over a grid of (T, D,
  causal, dropout, masked); with the table off every resolution is the
  heuristic the wrappers launched before the table existed.
* `kerneltune.py --dry-run` lists configs and candidates, and the sweep
  refuses to run without a card; `Recorder.kernel_tune` gives JAX's
  event keys.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from deeplearning4j_tpu.ops import autotune as jat
from deeplearning4j_tpu.telemetry import Recorder as JRecorder
from deeplearning4j_tpu_torch.ops import autotune as tat
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import fused_layernorm as tln
from deeplearning4j_tpu_torch.ops import fused_sampling as tsm
from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
KERNELTUNE = ROOT / "port_tools" / "kerneltune.py"


@pytest.fixture
def table_file(tmp_path, monkeypatch):
    """Write a table, make it the module's, force it on; restore after."""
    def make(entries, provenance=None):
        path = tmp_path / "table.json"
        path.write_text(json.dumps({"version": 1,
                                    "provenance": provenance or {},
                                    "entries": entries}))
        monkeypatch.setattr(tat, "TABLE_PATH", str(path))
        tat.reload_table(str(path))
        return path

    monkeypatch.setenv(tat.ENV_TUNING, "force")
    yield make
    monkeypatch.undo()
    tat.reload_table(tat.TABLE_PATH)
    tat._rejected.clear()


# ------------------------------------------------------------ the schema

@pytest.mark.parametrize("kernel,T,D,kw", [
    ("flash_chunk", 32768, 128, dict(causal=True, dropout=True,
                                     masked=True)),
    ("softmax_xent", 10000, 256, {}),
    ("fused_layer_norm", 16384, 256, {}),
    ("sample", 4, 10000, dict(causal=False, dropout=False, masked=False)),
])
def test_keys_and_parse_equal_jax(kernel, T, D, kw):
    key = tat.config_key(kernel, T, D, **kw)
    assert key == jat.config_key(kernel, T, D, **kw)
    assert tat.parse_key(key) == jat.parse_key(key)
    with pytest.raises(ValueError, match="malformed"):
        tat.parse_key(key.replace("|T", "|X"))


def test_validate_table_rejects_what_jax_rejects():
    cases = {
        "version": {"version": 99, "entries": {}},
        "malformed": {"version": 1, "entries": {"nonsense": {}}},
        "unknown kernel": {"version": 1,
                           "entries": {"warp_drive|T1|D1|c0|d0|m0": {}}},
        "not tunable": {"version": 1, "entries": {
            "flash_chunk|T32768|D128|c1|d0|m0": {"rows": 8}}},
        "positive int": {"version": 1, "entries": {
            "flash_chunk|T32768|D128|c1|d0|m0": {"chunk": -4}}},
    }
    for word, table in cases.items():
        assert any(word in p for p in tat.validate_table(table)), word
        assert any(word in p for p in jat.validate_table(table)), word
    assert tat.validate_table("no") == jat.validate_table("no")
    assert tat.validate_table({"version": 1}) == \
        jat.validate_table({"version": 1})
    good = {"version": 1, "provenance": {}, "entries": {
        "softmax_xent|T10000|D256|c0|d0|m0": {"slices": 6, "best_us": 1.5,
                                              "default_us": 2.0},
        "fused_layer_norm|T16384|D256|c0|d0|m0": {"blocks": 132},
        "sample|T4|D10000|c0|d0|m0": {"threads": 128, "cluster": 4},
        "flash_chunk|T32768|D128|c1|d1|m1": {"chunk": 4096},
    }}
    assert tat.validate_table(good) == []
    # JAX's VMEM blocks of the families both packages have are not knobs
    # of the port's launches
    for key, params in (("fused_layer_norm|T1024|D512|c0|d0|m0",
                         {"rows": 256}),
                        ("softmax_xent|T10240|D256|c0|d0|m0",
                         {"block_n": 1024}),
                        ("sample|T256|D8192|c0|d0|m0", {"rows": 128})):
        table = {"version": 1, "entries": {key: params}}
        assert jat.validate_table(table) == []
        assert "not tunable" in tat.validate_table(table)[0]


@pytest.mark.parametrize("family", sorted(tat.JAX_ONLY_FAMILIES))
def test_validate_table_rejects_the_jax_only_families(family):
    """JAX's families whose knob the port's launches do not take: a
    valid JAX entry is a problem here."""
    assert family in jat.KERNEL_PARAMS
    param = jat.KERNEL_PARAMS[family][0]
    table = {"version": 1, "entries": {
        f"{family}|T512|D64|c1|d0|m0": {param: 128}}}
    assert jat.validate_table(table) == []
    problems = tat.validate_table(table)
    assert len(problems) == 1 and "no launch knob" in problems[0]


def test_a_broken_table_fails_at_load(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text(json.dumps({"version": 1, "entries": {
        "sample|T4|D10000|c0|d0|m0": {"rows": 8}}}))
    with pytest.raises(ValueError, match="invalid tuning table"):
        tat.load_table(str(path))
    tat.reload_table(tat.TABLE_PATH)


def test_checked_in_table_is_the_sweeps_on_the_card():
    """ops/tuning_table.json: valid, written by port_tools/kerneltune.py
    on a card whose name and power limit it records, each entry at most
    its default's time."""
    table = tat.reload_table(tat.TABLE_PATH)
    assert Path(tat.TABLE_PATH).exists()
    assert tat.validate_table(table) == []
    prov = table["provenance"]
    assert prov["tool"] == "port_tools/kerneltune.py"
    assert prov["device_kind"] and prov["device_kind"] in prov["nvidia_smi"]
    assert " W" in prov["nvidia_smi"] and not prov["quick"]
    assert table["entries"]
    for key, e in table["entries"].items():
        assert e["best_us"] <= e["default_us"], key


# ------------------------------------------------------------ resolution

def test_table_is_off_on_the_cpu(monkeypatch):
    monkeypatch.delenv(tat.ENV_TUNING, raising=False)
    tat.reload_table(tat.TABLE_PATH)
    assert not tat.table_active()
    assert tat.lookup("sample", 4, 10000) is None


def test_env_force_and_off(table_file, monkeypatch):
    table_file({"sample|T4|D10000|c0|d0|m0": {"threads": 128,
                                              "cluster": 4}})
    assert tat.table_active()
    assert tsm._plan(4, 10000) == (128, 4)
    monkeypatch.setenv(tat.ENV_TUNING, "off")
    assert not tat.table_active()
    assert tsm._plan(4, 10000) == (256, 8)


def test_table_applies_only_on_its_card(table_file, monkeypatch):
    """Unforced, the table needs CUDA and a card of its device_kind."""
    table_file({"sample|T4|D10000|c0|d0|m0": {"threads": 128,
                                              "cluster": 4}},
               provenance={"device_kind": "NVIDIA H100 80GB HBM3"})
    monkeypatch.delenv(tat.ENV_TUNING)
    tat.reload_table(tat.TABLE_PATH)
    assert not tat.table_active()
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    tat.reload_table(tat.TABLE_PATH)
    assert tat.table_active() and tsm._plan(4, 10000) == (128, 4)
    monkeypatch.setattr("torch.cuda.get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    tat.reload_table(tat.TABLE_PATH)
    assert not tat.table_active() and tsm._plan(4, 10000) == (256, 8)


def test_override_beats_the_table(table_file):
    table_file({"fused_layer_norm|T16384|D256|c0|d0|m0": {"blocks": 132}})
    assert tln.bwd_blocks(16384, 256) == 132
    with tat.override({"fused_layer_norm": {"blocks": 528}}):
        assert tln.bwd_blocks(16384, 256) == 528
        key = tat.config_key("fused_layer_norm", 16384, 256)
        with tat.override({key: {"blocks": 66}}):
            assert tln.bwd_blocks(16384, 256) == 66
    assert tln.bwd_blocks(16384, 256) == 132
    assert tln.bwd_blocks(2048, 256) == 256  # no entry: the heuristic


def test_tuned_entries_reach_every_wrapper(table_file):
    table_file({
        "softmax_xent|T10000|D256|c0|d0|m0": {"slices": 40},
        "fused_layer_norm|T16384|D256|c0|d0|m0": {"blocks": 132},
        "sample|T8|D128|c0|d0|m0": {"threads": 256, "cluster": 2},
        "flash_chunk|T32768|D128|c1|d1|m1": {"chunk": 4096},
    })
    # K9: a target clamped to the call's row blocks
    assert tat.xent_slices(16384, 256, 10000, 5, 256) == 40
    assert tat.xent_slices(2048, 256, 10000, 5, 32) == 32
    assert tat.xent_slices(2048, 256, 4096, 5, 32) == 5
    ptrs = (0, 16, 32, 48)
    assert tln._bwd_plan(16384, 256, 2, ptrs) == (1, 132)
    assert tln._bwd_plan(16384, 256, 2, (1,) + ptrs[1:]) == (0, 256)
    assert tsm._plan(8, 128) == (256, 2)
    assert tfa.resolve_chunk(32768, 128, True, True, True) == 4096
    assert tfa.resolve_chunk(32768, 128, True, False, False) == 8192


@pytest.mark.parametrize("entry,resolve,want", [
    ({"sample|T4|D10000|c0|d0|m0": {"threads": 512, "cluster": 4}},
     lambda: tsm._plan(4, 10000), (256, 8)),
    ({"sample|T4|D10000|c0|d0|m0": {"threads": 128, "cluster": 16}},
     lambda: tsm._plan(4, 10000), (256, 8)),
    ({"sample|T8|D4|c0|d0|m0": {"threads": 128, "cluster": 8}},
     lambda: tsm._plan(8, 4), (128, 1)),
    ({"fused_layer_norm|T64|D256|c0|d0|m0": {"blocks": 9}},
     lambda: tln.bwd_blocks(64, 256), 8),
    ({"flash_chunk|T32768|D128|c1|d0|m0": {"chunk": 1024}},
     lambda: tfa.resolve_chunk(32768, 128, True), 8192),
    ({"flash_chunk|T32768|D256|c1|d0|m0": {"chunk": 8192}},
     lambda: tfa.resolve_chunk(32768, 256, True), 4096),
    ({"flash_chunk|T32768|D128|c1|d0|m0": {"chunk": 3000}},
     lambda: tfa.resolve_chunk(32768, 128, True), 8192),
], ids=["threads", "cluster>8", "cluster>V", "blocks>rows", "pairs",
        "head-dim", "not-a-tile"])
def test_an_invalid_entry_falls_back_loudly(table_file, entry, resolve,
                                            want):
    """Past its kernel's limits an entry is rejected: the heuristic's
    value, a RuntimeWarning and one `kernel_tune` event of role
    "rejected" (not repeated at the next launch)."""
    table_file(entry)
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        with pytest.warns(RuntimeWarning, match="rejected"):
            assert resolve() == want
        assert resolve() == want
    finally:
        set_default(prev)
    events = [e for e in rec.events if e["event"] == "kernel_tune"]
    assert len(events) == 1 and events[0]["role"] == "rejected"
    assert events[0]["key"] == next(iter(entry))


def test_a_valid_xent_target_is_never_rejected(table_file):
    """slices is a target: any positive count resolves (clamped)."""
    table_file({"softmax_xent|T10000|D256|c0|d0|m0": {"slices": 10**6}})
    assert tat.xent_slices(300, 256, 10000, 3, 5) == 5


# ------------------------------------------- the chunk envelope and JAX

@pytest.mark.parametrize("D", [None, 32, 64, 96, 128, 256, 512, 1024])
def test_max_tile_for_dim_equals_jax(D):
    assert tat.max_tile_for_dim(D) == jat.max_tile_for_dim(D)
    assert tfa.max_tile_for_dim(D) == jat.max_tile_for_dim(D)
    assert tat.CHUNK_TILES == jat.CHUNK_TILES == tfa.CHUNK_TILES
    assert tat.TILE_ELEM_BUDGET == jat.TILE_ELEM_BUDGET


@pytest.mark.parametrize("causal,dropout,masked", [
    (True, False, False), (True, True, True), (False, False, True),
    (False, True, False)])
def test_chunk_tile_equals_jax(monkeypatch, causal, dropout, masked):
    """Over T in 8k..128k and D in 64..512, each tile of CHUNK_TILES as
    the entry: both packages accept and reject the same (T, D, chunk)
    with the same `fits` (the port's loop predicate), and with no entry
    (the table off, as on the CPU) both give None."""
    monkeypatch.delenv(tat.ENV_TUNING, raising=False)
    monkeypatch.delenv(jat.ENV_TUNING, raising=False)
    grid = [(T, D) for T in (8192 + 4096, 16384, 32768, 65536, 131072)
            for D in (64, 128, 256, 512)]
    for T, D in grid:
        fits = lambda c, T=T, D=D: tfa._chunk_fits(c, T, D, causal)
        kw = dict(causal=causal, dropout=dropout, masked=masked, fits=fits)
        for c in tat.CHUNK_TILES + (3072, 0):
            entry = {"flash_chunk": {"chunk": c}}
            with tat.override(entry), jat.override(entry), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                ours = tat.chunk_tile(T, D, **kw)
                theirs = jat.chunk_tile(T, D, **kw)
            assert ours == theirs, (T, D, c)
        assert tat.chunk_tile(T, D, **kw) is None


# ----------------------------------------- with the table off: the parent

def _parent_ln_blocks(N):
    return min(264, -(-N // 8))


def _parent_plan(batch, vocab):
    cluster = min(8, max(1, -(-vocab // (128 * 8))))
    wide = cluster == 8 and batch * cluster <= 132
    return (256 if wide else 128), cluster


@pytest.mark.parametrize("env", ["off", "unset"])
def test_every_resolution_is_the_heuristic_with_the_table_off(
        table_file, monkeypatch, env):
    """A table holding an entry for every swept key, switched off (or on
    the CPU, unforced): K9's slices, K11's blocks, K12's plan and the
    chunk tile are what the wrappers launched before the table."""
    table_file({
        "softmax_xent|T10000|D256|c0|d0|m0": {"slices": 7},
        "fused_layer_norm|T16384|D256|c0|d0|m0": {"blocks": 132},
        "sample|T4|D10000|c0|d0|m0": {"threads": 128, "cluster": 4},
        "sample|T8|D128|c0|d0|m0": {"threads": 256, "cluster": 2},
        "flash_chunk|T32768|D128|c1|d0|m0": {"chunk": 4096},
        "flash_chunk|T32768|D128|c1|d1|m1": {"chunk": 2048},
    }, provenance={"device_kind": "NVIDIA H100 80GB HBM3"})
    if env == "off":
        monkeypatch.setenv(tat.ENV_TUNING, "off")
    else:
        monkeypatch.delenv(tat.ENV_TUNING)
    assert not tat.table_active()
    for N in (16384, 2048, 300):
        assert tat.xent_slices(N, 256, 10000, 5, -(-N // 64)) == 5
    for N, C in ((16384, 256), (2048, 512), (100, 256)):
        assert tln.bwd_blocks(N, C) == _parent_ln_blocks(N)
    for B in (1, 4, 8, 16, 32, 64):
        for V in (128, 1000, 4099, 10000, 99999):
            assert tsm._plan(B, V) == _parent_plan(B, V)
    for T in (16384, 32768, 65536):
        for D in (64, 128, 256):
            for drop, mask in ((False, False), (True, True)):
                assert tfa.resolve_chunk(T, D, True, drop, mask) == \
                    tfa.pick_chunk(T, True, head_dim=D)


# ------------------------------------------------ the sweep and the event

def _run_tool(*args):
    return subprocess.run([sys.executable, str(KERNELTUNE), *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_kerneltune_dry_run_lists_configs_and_candidates():
    out = _run_tool("--dry-run")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    keys = [line.split(":")[0] for line in lines]
    assert keys == [
        "softmax_xent|T10000|D256|c0|d0|m0",
        "fused_layer_norm|T16384|D256|c0|d0|m0",
        "sample|T4|D10000|c0|d0|m0", "sample|T8|D128|c0|d0|m0",
        "flash_chunk|T32768|D128|c1|d0|m0",
        "flash_chunk|T32768|D128|c1|d1|m1"]
    assert "default [{'blocks': 264}], 7 candidates" in lines[1]
    assert "default [{'threads': 256, 'cluster': 8}], 15 candidates" \
        in lines[2]
    assert "default [{'chunk': 8192}], 2 candidates [{'chunk': 4096}, " \
        "{'chunk': 2048}]" in lines[4]
    quick = _run_tool("--dry-run", "--quick", "--configs", "sample")
    assert quick.returncode == 0 and quick.stdout.startswith("sample|T4|")
    assert _run_tool("--dry-run", "--configs", "warp").returncode == 2


def test_kerneltune_refuses_to_run_without_a_card():
    out = _run_tool("--quick", "--out", os.devnull)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr


def test_kernel_tune_event_has_jax_keys():
    kw = dict(seconds=1.25e-5, role="chosen", default_seconds=1.5e-5)
    ours = Recorder(path=None).kernel_tune(
        "sample", "sample|T4|D10000|c0|d0|m0", {"threads": 128}, **kw)
    theirs = JRecorder(path=None).kernel_tune(
        "sample", "sample|T4|D10000|c0|d0|m0", {"threads": 128}, **kw)
    assert set(ours) - {"ts", "run", "seq"} == \
        set(theirs) - {"ts", "run", "seq"}
    for k in ("event", "kernel", "key", "params", "seconds", "role",
              "default_seconds"):
        assert ours[k] == theirs[k], k
