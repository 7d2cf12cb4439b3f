"""The port's cost book and recorder events (deeplearning4j_tpu_torch/
telemetry/{costbook,recorder,listener}.py, ops/opcount.py) on the CPU,
against the JAX package's.

* The `memory`, `cost`, `cost_drift`, `metric` and `eval` events carry
  the JAX recorder's keys; so does `kernel_tune` (ops/autotune.py).
* The flop count of a 2-layer LM's forward and training step equals the
  analytic count exactly: 2mnk a torch product (forward, dx and dW) plus
  the kernels' own counts (K3/K7 packed flash at head dim 64, K8/K9 the
  fused head), the same on the CPU as on the card. XLA's count of the
  JAX step is printed beside it and gates nothing: it also counts
  elementwise work.
* Each kernel wrapper adds its analytic count and hides its plain
  version from the flop counter; outside a count it adds nothing.
* The book: once per (entry, shape), disabled under a NullRecorder,
  lookups, MFU, the peak table, `reconcile`'s `cost_drift`; the serving
  engines' entries at warmup, `fit`'s and `fit_scanned`'s entries, the
  bench arm's measurement and `cost_drift`; the TelemetryListener.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.telemetry import Recorder as JRecorder
from deeplearning4j_tpu.telemetry import costbook as jcostbook
from deeplearning4j_tpu.telemetry.listener import (
    TelemetryListener as JTelemetryListener,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx
from deeplearning4j_tpu_torch.ops import opcount
from deeplearning4j_tpu_torch.ops.fused_layernorm import fused_layer_norm
from deeplearning4j_tpu_torch.ops.fused_neg_softmax import neg_softmax_scores
from deeplearning4j_tpu_torch.ops.fused_sampling import fused_sample
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import (GenerationEngine,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.telemetry import NullRecorder, Recorder
from deeplearning4j_tpu_torch.telemetry import costbook
from deeplearning4j_tpu_torch.telemetry.costbook import CostBook, count_call
from deeplearning4j_tpu_torch.telemetry.listener import TelemetryListener

pytestmark = pytest.mark.port

# the LM of the count tests: head dim 64 with an even head count takes
# the packed flash route (K3 / K7), T = 512 the flash envelope's least,
# and a vocab of 2048 the fused head's least
LM = dict(vocab_size=2048, d_model=128, n_heads=2, n_layers=2, d_ff=256,
          max_length=512)
B, T = 2, 512


def analytic_flops(c, B, T, train):
    """The book's count of the LM: the QKV, output and two FF products
    of each block (2mnk each; dx and dW again in the backward), the
    packed flash forward 4·B·H·P·Dh over P = T(T+1)/2 causal pairs and
    its backward 10·B·H·P·Dh, and the head: a [N, d] x [d, V] product in
    inference, K8's 2·N·d·V and K9's 6·N·d·V in training."""
    N, d, F, V = B * T, c["d_model"], c["d_ff"], c["vocab_size"]
    H, L = c["n_heads"], c["n_layers"]
    P, Dh = T * (T + 1) // 2, d // H
    mm = L * (2 * N * d * 3 * d + 2 * N * d * d + 2 * 2 * N * d * F)
    attn = L * 4 * B * H * P * Dh
    if not train:
        return mm + attn + 2 * N * d * V
    return 3 * mm + attn + L * 10 * B * H * P * Dh + 8 * N * d * V


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, LM["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture
def fused_head(monkeypatch):
    # the fused head's route on the CPU, as the card takes it
    monkeypatch.setattr(fsx, "FORCE_FUSED", True)


# ------------------------------------------------------------ the events

def _keys(ev):
    return set(ev) - {"ts", "run", "seq"}


@pytest.mark.parametrize("kind", ["memory", "cost", "cost_drift", "metric",
                                  "eval_dict", "eval_object"])
def test_event_schemas_match_the_jax_recorder(kind):
    class Ev:  # an Evaluation-like object, one summary method failing
        def accuracy(self):
            return 0.75

        def f1(self):
            raise ZeroDivisionError

    calls = {
        "memory": lambda r: r.memory(iteration=3),
        "cost": lambda r: r.cost("forward", [1, 64], flops=12.0,
                                 argument_bytes=8),
        "cost_drift": lambda r: r.cost_drift(predicted_bytes=100,
                                             measured_bytes=250,
                                             factor=8.0),
        "metric": lambda r: r.metric({"metric": "m", "value": 1.5}),
        "eval_dict": lambda r: r.eval({"accuracy": 0.5}, epoch=1),
        "eval_object": lambda r: r.eval(Ev()),
    }
    ours, theirs = calls[kind](Recorder()), calls[kind](JRecorder())
    assert _keys(ours) == _keys(theirs)
    assert ours["event"] == theirs["event"]
    for k in _keys(ours) - {"devices", "live_array_bytes",
                            "live_array_count"}:
        assert ours[k] == theirs[k], k
    if kind == "memory":  # off the card: no device stats, nothing live
        assert ours["devices"] == {} and ours["live_array_bytes"] == 0


def test_null_recorder_skips_eval_and_memory_and_kernel_tune_raises():
    """The null recorder records no eval, memory or kernel_tune event;
    `Recorder.kernel_tune` no longer raises (the name is kept from when
    it did): it emits the JAX recorder's event."""
    null = NullRecorder()
    assert null.eval({"accuracy": 1.0}) == {} and null.memory() == {}
    assert null.kernel_tune("sample", "k", {"threads": 128}) == {}
    ours = Recorder().kernel_tune("sample", "k", {"threads": 128},
                                  seconds=1e-5, role="default")
    theirs = JRecorder().kernel_tune("sample", "k", {"threads": 128},
                                     seconds=1e-5, role="default")
    assert _keys(ours) == _keys(theirs)
    for k in ("event", "kernel", "key", "params", "role", "seconds"):
        assert ours[k] == theirs[k], k


# ------------------------------------------------------------- the count

@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
def test_lm_count_equals_the_analytic_count(train, fused_head):
    net = transformer_lm(**LM, device="cpu").init(0)
    toks = _tokens()
    with count_call() as out:
        if train:
            net.fit(DataSet(toks, np.roll(toks, -1, 1)))
        else:
            net.output(toks)
    assert out["flops"] == analytic_flops(LM, B, T, train)
    kernels = ({"K3": 2 * 4 * B * 2 * (T * (T + 1) // 2) * 64}
               if not train else
               {"K3", "K7", "K8", "K9"})
    if train:
        assert set(out["kernel_flops"]) == kernels
        assert out["kernel_flops"]["K9"] == 3 * out["kernel_flops"]["K8"]
    else:
        assert out["kernel_flops"] == kernels
    assert "peak_temp_bytes" not in out  # off the card


def test_jax_costbook_figure_is_printed_beside_the_count(fused_head):
    """XLA's flops of the JAX training step of the same LM, beside the
    port's count: no gate (XLA also counts elementwise work and softmax,
    so the two conventions differ)."""
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.models.transformer import (
        transformer_lm as jtransformer_lm,
    )
    from deeplearning4j_tpu.telemetry import set_default as jset_default

    toks = _tokens()
    rec = JRecorder()
    prev = jset_default(rec)
    try:
        jnet = jtransformer_lm(**LM).init()
        jnet.fit_scanned(JDataSet(toks, np.roll(toks, -1, 1)), epochs=1)
    finally:
        jset_default(prev)
    xla = [e.get("flops") for e in rec.events if e["event"] == "cost"]
    ours = analytic_flops(LM, B, T, True)
    print(f"port count {ours} flops a step; XLA's cost_analysis of the "
          f"JAX step {xla}")
    assert ours > 0


def test_each_wrapper_adds_its_analytic_count_and_hides_its_plain_version():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=g)
    gamma, beta = torch.ones(32), torch.zeros(32)
    c, pos = torch.randn(4, 16, generator=g), torch.randn(4, 16, generator=g)
    neg = torch.randn(4, 5, 16, generator=g)
    logits, noise = torch.randn(3, 50, generator=g), torch.rand(3, 50)
    with count_call() as out:
        y = fused_layer_norm(x.requires_grad_(), gamma, beta)
        y.sum().backward()
        neg_softmax_scores(c, pos, neg)
        fused_sample(logits, noise, temperature=0.8, top_k=8, top_p=0.9)
        fused_sample(logits, noise, temperature=0.0)  # argmax: no kernel
    assert out["kernel_flops"] == {
        "K10": 8 * 6 * 32, "K11": 12 * 6 * 32, "K13": 2 * 6 * 4 * 16,
        "K12": opcount.sample_ops(3, 50, 8, 0.9)}
    assert out["torch_flops"] == 0  # the plain versions' bmm is hidden
    assert opcount.sample_ops(3, 50, 8, 0.9) == 3 * 50 * (3 + 2 * 48 + 1)


def test_counts_outside_a_count_add_nothing_and_other_threads_are_apart():
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    seen = {}

    def other():
        # a thread without the counter's mode: its kernels are not counted
        with opcount.kernel("K13", 1000):
            seen["other"] = True

    with count_call() as out:
        a @ b
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == {"other": True}
    assert out["flops"] == out["torch_flops"] == 2 * 8 * 8 * 8
    assert out["kernel_flops"] == {} and opcount._ACTIVE == []


# -------------------------------------------------------------- the book

def test_costbook_records_once_per_entry_shape_and_lookups():
    rec = Recorder()
    book = CostBook(rec)
    a = torch.randn(4, 8)
    w = torch.randn(8, 3)
    first = book.record("forward", [4, 8], torch.matmul, (a, w))
    again = book.record("forward", [4, 8], torch.matmul, (a, w))
    book.record("forward", [2, 8], torch.matmul, (a[:2], w))
    assert first["flops"] == 2 * 4 * 8 * 3 and again == {}
    assert first["argument_bytes"] == (32 + 24) * 4
    assert first["output_bytes"] == 12 * 4
    assert book.flops("forward", [4, 8]) == 192
    assert book.flops("forward") == 192 + 96 == book.flops()
    assert book.peak_temp_bytes() == 0  # off the card
    costs = [e for e in rec.events if e["event"] == "cost"]
    assert [(e["entry"], e["shape"]) for e in costs] == [
        ("forward", [4, 8]), ("forward", [2, 8])]


def test_costbook_disabled_under_null_recorder_runs_nothing():
    book = CostBook(NullRecorder())
    ran = []
    assert book.record("forward", [1], lambda: ran.append(1), ()) == {}
    with book.count("fit", [1]) as out:
        pass
    assert ran == [] and out == {} and book.entries() == {}


def test_costbook_record_is_thread_safe_single_emit():
    rec = Recorder()
    book = CostBook(rec)
    a = torch.randn(16, 16)
    barrier = threading.Barrier(4)

    def warm():
        barrier.wait()
        book.record("decode", [4, 64], torch.matmul, (a, a))

    threads = [threading.Thread(target=warm) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len([e for e in rec.events if e["event"] == "cost"]) == 1


@pytest.mark.parametrize("args", [(1e12, 1.0, 2e12), (5e12, 1.0, 1e12),
                                  (1.0, 0.0, 1e12), (0.0, 1.0, 1e12),
                                  (1.0, 1.0, 0.0)])
def test_mfu_is_clamped_and_guarded_as_in_jax(args):
    assert CostBook.mfu(*args) == jcostbook.CostBook.mfu(*args)


def test_peak_flops_names_the_h100_and_keeps_the_fallback():
    assert costbook.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert costbook.peak_flops("cpu") == costbook.DEFAULT_PEAK_FLOPS == \
        jcostbook.DEFAULT_PEAK_FLOPS
    assert costbook.peak_flops(None) == 1e12
    assert not any("TPU" in k for k in costbook.PEAK_BF16_FLOPS)
    assert costbook.device_kind("cpu") == "cpu"


def test_reconcile_emits_cost_drift_as_jax_does():
    ours, theirs = Recorder(), JRecorder()
    a = costbook.reconcile(ours, 1000, measured_bytes=9000)
    b = jcostbook.reconcile(theirs, 1000, measured_bytes=9000)
    assert _keys(a) == _keys(b)
    assert (a["ratio"], a["factor"], a["source"]) == (9.0, 8.0, "placement")
    assert costbook.reconcile(NullRecorder(), 1000) == {}
    assert costbook.reconcile(ours, 0) == {}
    # off the card the measurement is the ledger's attributed bytes
    from deeplearning4j_tpu_torch.telemetry.memstat import MemoryLedger

    ledger = MemoryLedger().register("params", {"w": torch.zeros(250)})
    assert costbook.measured_peak_bytes(ledger) == 1000
    assert costbook.measured_peak_bytes() == 0
    ev = costbook.reconcile(ours, 500, measured_bytes=1000)
    assert ev["ratio"] == 2.0


# ----------------------------------------------------- on the main paths

def test_inference_engine_counts_each_bucket_at_warmup(fused_head):
    rec = Recorder()
    net = transformer_lm(**LM, device="cpu").init(0)
    engine = InferenceEngine(net, BucketLattice((1, 2), seq_lens=(T,)),
                             sequence=True, recorder=rec)
    engine.warmup(np.zeros(T, np.int32))
    costs = {tuple(e["shape"]): e for e in rec.events
             if e["event"] == "cost"}
    assert set(costs) == {(1, T), (2, T)}
    for b in (1, 2):
        assert costs[(b, T)]["flops"] == analytic_flops(LM, b, T, False)
        assert engine.costbook.flops("forward", [b, T]) == \
            costs[(b, T)]["flops"]
    assert engine.peak_flops == 1e12  # the off-card fallback
    assert engine.warmup(np.zeros(T, np.int32)) == 0  # nothing new
    assert len([e for e in rec.events if e["event"] == "cost"]) == 2


def test_generation_engine_counts_prefill_and_decode_at_warmup():
    rec = Recorder()
    net = transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_length=64, device="cpu").init(0)
    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(8, 16)),
                              slots=2, max_new_tokens=8, recorder=rec)
    engine.warmup()
    entries = sorted((e["entry"], tuple(e["shape"])) for e in rec.events
                     if e["event"] == "cost")
    cap = engine.plan.capacity
    assert entries == [("decode", (2, cap)), ("prefill", (1, 8)),
                       ("prefill", (1, 16))]
    assert all(e["flops"] > 0 for e in rec.events if e["event"] == "cost")


def test_fit_counts_each_batch_shape_once_and_fit_scanned_its_dispatch(
        fused_head):
    from deeplearning4j_tpu_torch.telemetry import set_default

    rec = Recorder()
    prev = set_default(rec)
    try:
        net = transformer_lm(**LM, device="cpu").init(0)
        toks = _tokens()
        ds = DataSet(toks, np.roll(toks, -1, 1))
        net.fit(ds)
        net.fit(ds)
        net.fit_scanned([ds, ds], epochs=2)
    finally:
        set_default(prev)
    costs = [e for e in rec.events if e["event"] == "cost"]
    assert [e["entry"] for e in costs] == ["fit", "fit_scanned"]
    step = analytic_flops(LM, B, T, True)
    assert costs[0]["flops"] == step
    assert costs[0]["shape"] == [[B, T], [B, T]]
    assert costs[1]["shape"] == [2, 2]
    assert costs[1]["step_flops"] == step
    assert costs[1]["flops"] == 4 * step
    assert net.iteration_count == 6


# ------------------------------------------------------------ the listener

class _Model:
    def __init__(self):
        self._score_raw = None


@pytest.mark.parametrize("frequency,n", [(3, 7), (1, 2), (5, 5)])
def test_listener_windows_match_the_jax_listener(frequency, n):
    ours_rec, theirs_rec = Recorder(), JRecorder()
    ours = TelemetryListener(ours_rec, frequency=frequency,
                             snapshot_memory=True)
    theirs = JTelemetryListener(theirs_rec, frequency=frequency,
                                snapshot_memory=True)
    m = _Model()
    for i in range(1, n + 1):
        m._score_raw = torch.tensor(float(i) / 2)
        ours.iteration_done(m, i)
        m._score_raw = jax.numpy.asarray(float(i) / 2)
        theirs.iteration_done(m, i)
    ours.close()
    theirs.close()

    def rows(rec):
        return [(e["event"], e.get("iteration"), e.get("score"),
                 "iterations_per_sec" in e) for e in rec.events]

    assert rows(ours_rec) == rows(theirs_rec)


def test_listener_is_importable_from_optimize_and_telemetry():
    from deeplearning4j_tpu_torch import optimize, telemetry

    assert optimize.TelemetryListener is TelemetryListener
    assert telemetry.TelemetryListener is TelemetryListener
    assert telemetry.CostBook is CostBook
    from deeplearning4j_tpu_torch.telemetry import memstat

    assert telemetry.MemorySampler is memstat.MemorySampler
    with pytest.raises(AttributeError):
        telemetry.NoSuchThing  # noqa: B018


def test_bench_arm_measures_and_reconciles_the_winners_prediction():
    from deeplearning4j_tpu_torch.reshard import bench_arm
    from deeplearning4j_tpu_torch.reshard.planner import Placement
    from deeplearning4j_tpu_torch.telemetry import set_default

    rec = Recorder()
    prev = set_default(rec)
    try:
        result = bench_arm.run_arm({
            "placement": Placement.solo().to_json(), "device": "cpu",
            "dims": dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1,
                         d_ff=64, max_length=16),
            "batch": 2, "warm": 1, "repeats": 1, "predicted_bytes": 1000})
    finally:
        set_default(prev)
    # off the card the measurement is the net's params and Adam moments
    assert result["measured_bytes"] > 0
    assert result["measured_bytes"] % 12 == 0  # f32 params x 3
    assert result["predicted_bytes"] == 1000
    drift = [e for e in rec.events if e["event"] == "cost_drift"]
    assert len(drift) == 1 and drift[0]["predicted_bytes"] == 1000
    assert drift[0]["measured_bytes"] == result["measured_bytes"]
    assert drift[0]["source"] == "placement"


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_evaluate_records_the_jax_eval_event(container):
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.telemetry import set_default as jset_default
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.nn.multilayer import (
        MultiLayerNetwork as TNet,
    )
    from deeplearning4j_tpu_torch.telemetry import set_default
    from deeplearning4j_tpu_torch.weights_io import params_from_jax

    def build(pkg, graph):
        b = pkg.NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
        out = pkg.OutputLayer(n_in=4, n_out=3, activation="softmax")
        if not graph:
            return b.list().layer(out).build()
        return (b.graph_builder().add_inputs("in").add_layer("out", out, "in")
                .set_outputs("out").build())

    graph = container == "graph"
    jnet = (JGraph if graph else JNet)(build(jconf, graph)).init()
    tnet = (TGraph if graph else TNet)(build(tconf, graph),
                                       device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    rng = np.random.default_rng(0)
    x = rng.random((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    ours, theirs = Recorder(), JRecorder()
    prev, jprev = set_default(ours), jset_default(theirs)
    try:
        tnet.evaluate(DataSet(x, y))
        jnet.evaluate(JDataSet(x, y))
    finally:
        set_default(prev)
        jset_default(jprev)
    (a,) = [e for e in ours.events if e["event"] == "eval"]
    (b,) = [e for e in theirs.events if e["event"] == "eval"]
    assert _keys(a) == _keys(b) and a["top_n"] == b["top_n"] == 1
    assert set(a["stats"]) == set(b["stats"]) >= {"accuracy", "f1"}
    for k in a["stats"]:
        assert a["stats"][k] == pytest.approx(b["stats"][k], abs=1e-6)
