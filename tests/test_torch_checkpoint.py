"""The port's checkpoint format (deeplearning4j_tpu_torch/util/
checkpoint.py) and `resume_from` on both containers, on the CPU.

* Round trip: params, layer state (batch norm's running statistics),
  optimizer state and the step counter come back equal bit for bit, for
  a MultiLayerNetwork, a ComputationGraph (the transformer LM) and a
  bf16 net; training resumed from a checkpoint takes the same next step
  as training that never stopped.
* The commit rule: a step without meta.json is invisible; `keep` prunes.
* `resume_from` returns 0 on an empty directory and raises on a missing
  named step; a checkpoint of another architecture is refused before any
  array is read; the manifest records every leaf.
* Engines: `InferenceEngine(checkpoint=...)` and
  `GenerationEngine(checkpoint=...)` report the restored step and serve
  the checkpoint's weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.serving import replay
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.engine import (GenerationEngine,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.serving.fleet import (
    WeightSwapError,
    latest_step,
    validate_checkpoint_shapes,
)
from deeplearning4j_tpu_torch.telemetry import Recorder
from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer, tensor_leaves

pytestmark = pytest.mark.port

DEADLINE_S = 30.0


def _mlp_data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return DataSet(x, y)


def _trained_mlp(steps=2):
    net = replay._tiny_mlp(device="cpu")
    for _ in range(steps):
        net.fit(_mlp_data())
    return net


def _adam_mlp():
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss_function="mcxent")).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _lm(dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_length=16, device="cpu", **kw).init()


def _assert_trees_equal(a, b):
    la, lb = tensor_leaves(a, "t"), tensor_leaves(b, "t")
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, path
        assert torch.equal(x, y), path


def _image_net():
    from deeplearning4j_tpu_torch.models import lenet5

    return lenet5(device="cpu").init()


@pytest.mark.parametrize("make", [_trained_mlp, _lm, _image_net],
                         ids=["mlp", "transformer_graph", "lenet5_bn"])
def test_round_trip_is_bit_exact(tmp_path, make):
    net = make()
    net.iteration_count = 7
    d = Checkpointer(str(tmp_path)).save(net)
    assert os.path.basename(d) == "step_7"
    assert sorted(os.listdir(d)) == ["config.json", "meta.json", "model.pt"]
    fresh = type(net)(net.conf, device="cpu")
    assert fresh.resume_from(str(tmp_path)) == 7
    assert fresh.iteration_count == 7
    for tree in ("params", "state", "opt_state"):
        _assert_trees_equal(getattr(net, tree), getattr(fresh, tree))


def test_bf16_round_trip_keeps_dtype_and_bits(tmp_path):
    net = _lm("bfloat16")
    Checkpointer(str(tmp_path)).save(net, 3)
    fresh = _lm("bfloat16")
    fresh.resume_from(str(tmp_path))
    _assert_trees_equal(net.params, fresh.params)
    x = np.arange(12).reshape(1, 12)
    assert torch.equal(net.output(x), fresh.output(x))


def test_resumed_training_takes_the_same_next_step(tmp_path):
    """The optimizer state (Adam's moments and count) comes back too:
    one more step after a restore equals one more step of the net that
    never stopped."""
    net = _adam_mlp()
    for i in range(3):
        net.fit(_mlp_data(seed=i))
    Checkpointer(str(tmp_path)).save(net)
    resumed = type(net)(net.conf, device="cpu")
    assert resumed.resume_from(str(tmp_path)) == net.iteration_count
    net.fit(_mlp_data(seed=9))
    resumed.fit(_mlp_data(seed=9))
    _assert_trees_equal(net.params, resumed.params)
    assert net.iteration_count == resumed.iteration_count


def test_manifest_records_every_leaf_and_the_model_size(tmp_path):
    net = _adam_mlp()
    net.fit(_mlp_data())
    net.fit(_mlp_data())
    d = Checkpointer(str(tmp_path)).save(net, 2)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "MultiLayerNetwork" and meta["iteration"] == 2
    assert meta["model_bytes"] == os.path.getsize(
        os.path.join(d, "model.pt"))
    for tree in ("params", "state", "opt_state"):
        rows = meta["leaves"][tree]
        leaves = tensor_leaves(getattr(net, tree), tree)
        assert [r["path"] for r in rows] == [p for p, _ in leaves]
        for r, (_, t) in zip(rows, leaves):
            assert r["shape"] == list(t.shape)
            assert r["dtype"] == str(t.dtype).split(".")[-1]
    assert {r["path"] for r in meta["leaves"]["params"]} == {
        "params/layer_0/W", "params/layer_0/b", "params/layer_1/W",
        "params/layer_1/b"}
    assert meta["leaves"]["opt_state"], "optimizer leaves missing"
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)  # the configuration, as JSON


def test_uncommitted_step_is_invisible_and_keep_prunes(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    net = _trained_mlp(1)
    for step in (1, 2, 3):
        net.iteration_count = step
        ck.save(net)
    assert ck.steps() == [2, 3]  # keep=2 pruned step 1
    assert not os.path.exists(ck.step_dir(1))
    os.makedirs(ck.step_dir(9))  # a save cut off before its meta.json
    assert ck.steps() == [2, 3] and latest_step(str(tmp_path)) == 3
    fresh = replay._tiny_mlp(device="cpu")
    assert fresh.resume_from(str(tmp_path)) == 3


def test_empty_directory_and_missing_named_step(tmp_path):
    for net in (replay._tiny_mlp(device="cpu"), _lm()):
        assert net.resume_from(str(tmp_path / "nothing_here")) == 0
        assert net.resume_from(str(tmp_path)) == 0
    assert latest_step(str(tmp_path / "nothing_here")) is None
    net = _trained_mlp(1)
    net.iteration_count = 4
    Checkpointer(str(tmp_path)).save(net)
    with pytest.raises(FileNotFoundError, match="step 5"):
        replay._tiny_mlp(device="cpu").resume_from(str(tmp_path), step=5)
    assert replay._tiny_mlp(device="cpu").resume_from(str(tmp_path),
                                                      step=4) == 4


def test_other_architecture_refused_before_any_read(tmp_path):
    Checkpointer(str(tmp_path)).save(replay._tiny_mlp(n_out=7,
                                                      device="cpu"), 1)
    # gut the arrays: the refusal must come from the manifest alone
    os.remove(os.path.join(str(tmp_path), "step_1", "model.pt"))
    net = replay._tiny_mlp(device="cpu")
    before = {k: {n: t.clone() for n, t in p.items()}
              for k, p in net.params.items()}
    with pytest.raises(ValueError, match="do not match"):
        net.resume_from(str(tmp_path))
    _assert_trees_equal(before, net.params)
    with pytest.raises(WeightSwapError, match="mismatch"):
        validate_checkpoint_shapes(net.params, str(tmp_path), 1)


def test_truncated_model_file_fails_the_pre_restore_gate(tmp_path):
    net = _trained_mlp(1)
    d = Checkpointer(str(tmp_path)).save(net, 1)
    validate_checkpoint_shapes(net.params, str(tmp_path), 1)  # whole: ok
    path = os.path.join(d, "model.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(WeightSwapError, match="truncated"):
        validate_checkpoint_shapes(net.params, str(tmp_path), 1)
    os.remove(os.path.join(d, "meta.json"))
    os.makedirs(os.path.join(str(tmp_path), "step_2"))
    with open(os.path.join(str(tmp_path), "step_2", "meta.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(WeightSwapError, match="unreadable"):
        validate_checkpoint_shapes(net.params, str(tmp_path), 2)


def test_inference_engine_serves_the_restored_step(tmp_path):
    saved = _trained_mlp(3)
    Checkpointer(str(tmp_path)).save(saved)
    engine = InferenceEngine(replay._tiny_mlp(device="cpu"),
                             BucketLattice(batch_sizes=(1, 2)),
                             max_wait_ms=1.0, checkpoint=str(tmp_path),
                             recorder=Recorder(path=None))
    assert engine.restored_step == saved.iteration_count == 3
    assert engine.stats()["restored_step"] == 3
    assert engine.weights.step == 3
    engine.warmup(np.zeros(8, np.float32))
    engine.start()
    x = np.random.default_rng(1).normal(size=8).astype(np.float32)
    out = engine.predict(x, timeout=DEADLINE_S)
    np.testing.assert_array_equal(out, saved.output(x[None]).numpy()[0])
    engine.drain(DEADLINE_S)


def test_generation_engine_restores_before_warmup(tmp_path):
    saved = _lm()
    saved.iteration_count = 12
    Checkpointer(str(tmp_path)).save(saved)
    engine = GenerationEngine(_lm(), BucketLattice((1,), seq_lens=(8,)),
                              slots=1, max_new_tokens=4, page_size=4,
                              checkpoint=str(tmp_path),
                              recorder=Recorder(path=None))
    assert engine.restored_step == 12 and engine.weights.step == 12
    _assert_trees_equal(saved.params, engine.net.params)
    engine.warmup()
    engine.start()
    toks = engine.generate(np.arange(6), 4, timeout=DEADLINE_S)
    engine.drain(DEADLINE_S)
    # greedy tokens of the saved net's own forward
    seq = list(range(6))
    for _ in range(4):
        seq.append(int(saved.output(np.asarray([seq]))[0, -1].argmax()))
    assert toks == seq[6:]


def _nested_nets():
    """A bidirectional-LSTM MultiLayerNetwork ({"fwd": {...}, "bwd":
    {...}} params) and a graph with an MLP inside a NetworkLayer (its
    params the inner net's whole tree), on the CPU."""
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.nested import NetworkLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    bi = (tconf.NeuralNetConfiguration.builder().seed(1).updater("adam")
          .weight_init("xavier").list()
          .layer(tconf.GravesBidirectionalLSTM(n_in=3, n_out=4,
                                               activation="tanh"))
          .layer(tconf.RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                                      loss_function="mcxent"))
          .build())
    inner = (tconf.NeuralNetConfiguration.builder().seed(2).list()
             .layer(tconf.DenseLayer(n_in=3, n_out=5, activation="tanh",
                                     weight_init="xavier")).build())
    g = (tconf.NeuralNetConfiguration.builder().seed(3).updater("adam")
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("mlp", NetworkLayer(conf=inner), "in")
         .add_layer("out", tconf.OutputLayer(n_in=5, n_out=2,
                                             activation="softmax",
                                             loss_function="mcxent"), "mlp")
         .set_outputs("out").build())
    rng = np.random.default_rng(0)
    seq = DataSet(rng.standard_normal((2, 5, 3)).astype(np.float32),
                  np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 5))])
    flat = DataSet(rng.standard_normal((4, 3)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)])
    return ((MultiLayerNetwork(bi, device="cpu"), seq),
            (ComputationGraph(g, device="cpu"), flat))


def test_nested_params_round_trip_weights_io_and_checkpoints(tmp_path):
    """Nested params go through weights_io (to numpy and back) and
    through a Checkpointer save, restore and `load_network` unchanged,
    optimizer state included, and the restored nets train on."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.util.checkpoint import load_network
    from deeplearning4j_tpu_torch.weights_io import (params_from_jax,
                                                     params_to_numpy)

    for i, (net, ds) in enumerate(_nested_nets()):
        net.init()
        net.fit(ds)
        paths = [p for p, _ in tree.leaves(net.params)]
        assert max(len(p) for p in paths) == 3
        back = params_from_jax(params_to_numpy(net.params), "cpu")
        assert [p for p, _ in tree.leaves(back)] == paths
        for (_, a), (_, b) in zip(tree.leaves(back), tree.leaves(net.params)):
            assert torch.equal(a, b)
        d = str(tmp_path / f"net{i}")
        Checkpointer(d).save(net)
        for other in (type(net)(net.conf, device="cpu").init(9),
                      load_network(d, device="cpu")):
            Checkpointer(d).restore(other)
            for (_, a), (_, b) in zip(tree.leaves(other.params),
                                      tree.leaves(net.params)):
                assert torch.equal(a, b)
            assert other.iteration_count == net.iteration_count
            other.fit(ds)
            net_copy_score = other.score_value
            assert np.isfinite(net_copy_score)
