"""The port's memory ledger and sampler (deeplearning4j_tpu_torch/
telemetry/memstat.py) on the CPU, against the JAX package's
(deeplearning4j_tpu/telemetry/memstat.py), and the `memory` events on
the port's paths.

* The ledger: tree bytes, subsystem attribution, the activation
  residual, sources that track replacement, failing sources counted 0;
  the same maps as the JAX ledger's over the same trees.
* The sampler: disabled under a NullRecorder, ledger-annotated `memory`
  events with the JAX sampler's keys, the `DL4J_TPU_MEM_EVERY` cadence,
  the rate limit, the daemon thread, `sampler_for_net`. Off the card the
  live total is the ledger's attributed bytes and no device stats come
  back, as the JAX module reports off the TPU.
* The paths: `fit` samples at the cadence, `fit_scanned` once after its
  dispatch, both engines' `stats()["memory"]` after warmup, the server's
  memory gauges; `recent_headroom` and `MemoryWatch` read the events.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.telemetry import Recorder as JRecorder
from deeplearning4j_tpu.telemetry import memstat as jmemstat
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.serving import fleet
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import (GenerationEngine,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.telemetry import (NullRecorder, Recorder,
                                                set_default)
from deeplearning4j_tpu_torch.telemetry import memstat
from deeplearning4j_tpu_torch.telemetry.memstat import (MemoryLedger,
                                                        MemorySampler,
                                                        sampler_for_net)

pytestmark = pytest.mark.port

TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_length=64)


def _tokens(b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


# ------------------------------------------------------------------ ledger

def test_tree_bytes_sums_tensor_and_array_leaves():
    tree = {"w": torch.zeros(4, 8), "b": np.zeros(8, np.float32),
            "h": torch.zeros(3, dtype=torch.bfloat16),
            "nest": [{"m": torch.zeros(2, dtype=torch.float64)}],
            "meta": "not-an-array", "count": 3, "none": None}
    assert memstat.tree_bytes(tree) == 4 * 8 * 4 + 8 * 4 + 3 * 2 + 2 * 8


def test_ledger_rejects_unknown_subsystem():
    with pytest.raises(ValueError, match="unknown ledger subsystem"):
        MemoryLedger().register("heap", lambda: {})


@pytest.mark.parametrize("live", [1000, 300])
def test_ledger_attribution_and_residual_match_jax(live):
    def both(fn):
        return (fn(MemoryLedger(), torch.zeros), fn(jmemstat.MemoryLedger(),
                                                     np.zeros))

    def build(ledger, zeros):
        params = {"w": zeros(100, dtype=_f32(zeros))}
        opt = {"m": zeros(25, dtype=_f32(zeros))}
        return (ledger.register("params", lambda: params)
                .register("opt_state", opt)).breakdown(live)

    ours, theirs = both(build)
    assert ours == theirs
    assert ours["activations"] == max(0, live - 500)


def _f32(zeros):
    return torch.float32 if zeros is torch.zeros else np.float32


def test_ledger_residual_moves_to_other_when_activations_registered():
    acts = {"a": torch.zeros(10)}
    out = MemoryLedger().register("activations", lambda: acts) \
        .breakdown(100)
    assert out == {"activations": 40, "other": 60}


def test_ledger_source_tracks_replacement_and_failure_is_zero():
    box = {"tree": torch.zeros(10)}
    ledger = MemoryLedger().register("params", lambda: box["tree"])
    assert ledger.attributed()["params"] == 40
    box["tree"] = torch.zeros(20)  # a hot-swap: no re-register
    assert ledger.attributed()["params"] == 80

    def boom():
        raise RuntimeError("source died")

    ledger.register("kv_pages", boom)
    assert ledger.attributed() == {"params": 80, "kv_pages": 0}
    assert ledger.attributed_total() == 80 and ledger.attributed_count() == 1


# ----------------------------------------------------------------- sampler

def test_sampler_disabled_under_null_recorder():
    s = MemorySampler(NullRecorder(), mem_every=1)
    assert not s.enabled
    assert s.sample("x") == {}
    assert s.on_step(0) == {}
    assert s.maybe_sample("x") == {}


def test_sample_emits_the_jax_samplers_keys_off_the_card():
    rec = Recorder()
    keep = torch.zeros(16, 16)
    ledger = MemoryLedger().register("params", lambda: keep)
    ev = MemorySampler(rec, ledger, mem_every=1).sample("test", iteration=7)
    jev = jmemstat.MemorySampler(JRecorder(), jmemstat.MemoryLedger()
                                 .register("params", np.zeros((16, 16),
                                                              np.float32)),
                                 mem_every=1).sample("test", iteration=7)
    assert set(ev) == set(jev)
    assert ev["event"] == "memory" and ev["source"] == "test"
    assert ev["iteration"] == 7 and ev["devices"] == {}
    # off the card the live total is the ledger's
    assert ev["live_array_bytes"] == keep.numel() * 4 == \
        ev["ledger"]["params"] == ev["ledger_total_bytes"]
    assert ev["live_array_count"] == 1
    assert ev["ledger"]["activations"] == 0


def test_sampler_caches_last_snapshot_and_peak():
    rec = Recorder()
    box = {"t": torch.zeros(8)}
    s = MemorySampler(rec, MemoryLedger().register("params",
                                                   lambda: box["t"]),
                      mem_every=1)
    assert s.last == {} and s.peak_live_bytes == 0
    s.sample("a")
    box["t"] = torch.zeros(2)
    ev = s.sample("b")
    assert s.last["live_array_bytes"] == ev["live_array_bytes"] == 8
    assert s.peak_live_bytes == 32


def test_on_step_cadence_is_modulo_mem_every():
    rec = Recorder()
    s = MemorySampler(rec, mem_every=3)
    hits = [i for i in range(7) if s.on_step(i)]
    assert hits == [0, 3, 6]
    assert all(e["source"] == "fit" for e in rec.events
               if e["event"] == "memory")
    off = MemorySampler(rec, mem_every=0)
    assert off.on_step(0) == {} and off.on_step(3) == {}


@pytest.mark.parametrize("value,want", [("5", 5), ("banana", 0), (None, 0)])
def test_mem_every_reads_env_and_tolerates_garbage(monkeypatch, value,
                                                   want):
    if value is None:
        monkeypatch.delenv(memstat.ENV_MEM_EVERY, raising=False)
    else:
        monkeypatch.setenv(memstat.ENV_MEM_EVERY, value)
    assert MemorySampler(Recorder()).mem_every == want == \
        jmemstat.MemorySampler(JRecorder()).mem_every


def test_maybe_sample_rate_limits_scrape_storms():
    rec = Recorder()
    s = MemorySampler(rec, min_interval_s=3600.0, mem_every=1)
    assert s.maybe_sample("stats_tick")
    assert s.maybe_sample("stats_tick") == {}
    assert sum(1 for e in rec.events if e["event"] == "memory") == 1
    eager = MemorySampler(rec, min_interval_s=0.0, mem_every=1)
    assert eager.maybe_sample("t1") and eager.maybe_sample("t2")


def test_sampler_thread_starts_and_stops_cleanly():
    s = MemorySampler(Recorder(), mem_every=1)
    s.start(interval_s=3600.0)
    thread = s._thread
    assert thread is not None and thread.daemon
    s.stop()
    assert s._thread is None and not thread.is_alive()
    null = MemorySampler(NullRecorder()).start(interval_s=0.001)
    assert null._thread is None


def test_sampler_for_net_caches_per_recorder():
    class Net:
        params = {"w": torch.zeros(8)}
        opt_state = {"adam": {"mu": [torch.zeros(2)], "count": 3,
                              "keys": [["w"]]}}

    net = Net()
    rec = Recorder()
    s1 = sampler_for_net(net, rec)
    assert sampler_for_net(net, rec) is s1
    assert s1.ledger.attributed() == {"params": 32, "opt_state": 8}
    rec2 = Recorder()
    s2 = sampler_for_net(net, rec2)
    assert s2 is not s1 and s2.recorder is rec2


def test_device_stats_are_empty_off_the_card():
    assert memstat.device_memory_stats() == {}
    assert memstat.live_array_totals() == (0, 0)
    assert not memstat.on_card()


# --------------------------------------------------------------- the paths

def test_fit_samples_at_the_cadence_and_fit_scanned_after_its_dispatch(
        monkeypatch):
    monkeypatch.setenv(memstat.ENV_MEM_EVERY, "2")
    rec = Recorder()
    prev = set_default(rec)
    try:
        net = transformer_lm(**TINY, device="cpu").init(0)
        toks = _tokens()
        ds = DataSet(toks, np.roll(toks, -1, 1))
        for _ in range(4):
            net.fit(ds)
        net.fit_scanned([ds, ds], epochs=1)
    finally:
        set_default(prev)
    mem = [e for e in rec.events if e["event"] == "memory"]
    assert [(e["source"], e["iteration"]) for e in mem] == [
        ("fit", 2), ("fit", 4), ("fit", 6)]
    params = memstat.tree_bytes(net.params)
    assert all(e["ledger"]["params"] == params for e in mem)
    assert mem[-1]["ledger"]["opt_state"] == memstat.tree_bytes(
        net.opt_state) == 2 * params


def test_fit_under_null_recorder_samples_nothing(monkeypatch):
    monkeypatch.setenv(memstat.ENV_MEM_EVERY, "1")
    net = transformer_lm(**TINY, device="cpu").init(0)
    toks = _tokens()
    net.fit(DataSet(toks, np.roll(toks, -1, 1)))
    assert net._mem_sampler.recorder is not None
    assert not net._mem_sampler.enabled


def test_engines_report_memory_after_warmup():
    rec = Recorder()
    net = transformer_lm(**TINY, device="cpu").init(0)
    gen = GenerationEngine(net, BucketLattice((1,), seq_lens=(8, 16)),
                           slots=2, max_new_tokens=8, recorder=rec)
    gen.warmup()
    mem = gen.stats()["memory"]
    caches = memstat.tree_bytes([w.cache for w in gen._workers])
    assert mem["source"] == "warmup"
    warm = [e for e in rec.events if e["event"] == "memory"]
    assert [e["peak_flops"] for e in warm] == [1e12]
    assert mem["ledger"]["params"] == memstat.tree_bytes(net.params)
    assert mem["ledger"]["kv_pages"] == caches > 0
    assert gen.stats()["peak_flops"] == 1e12
    pred = InferenceEngine(net, BucketLattice((1, 2), seq_lens=(16,)),
                           sequence=True, recorder=rec)
    # before warmup the stats tick samples (rate-limited), as in JAX
    assert pred.stats()["memory"]["source"] == "stats_tick"
    pred.warmup(np.zeros(16, np.int32))
    assert pred.stats()["memory"]["ledger"]["params"] == \
        memstat.tree_bytes(net.params)


def test_recent_headroom_reads_memory_events_with_device_limits():
    rec = Recorder()
    assert fleet.recent_headroom(rec) is None
    MemorySampler(rec, mem_every=1).sample("warmup")  # off the card
    assert fleet.recent_headroom(rec) is None  # no devices: no signal
    rec.event("memory", devices={"0": {"bytes_in_use": 60,
                                       "bytes_limit": 100}})
    assert fleet.recent_headroom(rec) == pytest.approx(0.4)


def test_memory_watch_finds_a_leak_in_a_port_log(tmp_path):
    """The port's `memory` events through the JAX-schema detectors: a
    process whose live bytes grow step after step is a leak finding."""
    from deeplearning4j_tpu_torch.telemetry.trace import MemoryWatch

    path = tmp_path / "t.jsonl"
    rec = Recorder(path=str(path))
    box = {"t": torch.zeros(1)}
    s = MemorySampler(rec, MemoryLedger().register("params",
                                                   lambda: box["t"]),
                      mem_every=1)
    for i in range(1, 13):
        box["t"] = torch.zeros(1 << (10 + i))  # doubling live bytes
        s.on_step(i)
    rec.close()
    assert all(json.loads(line)["event"] == "memory"
               for line in path.read_text().splitlines())
    out = Recorder()
    found = MemoryWatch(str(path), recorder=out, min_interval_s=0.0).poll()
    kinds = {f["anomaly"] for f in found}
    assert "leak" in kinds, found
    assert any(e["event"] == "anomaly" and e["kind"] == "leak"
               for e in out.events)
