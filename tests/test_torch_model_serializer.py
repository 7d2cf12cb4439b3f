"""The port's ModelSerializer zips (deeplearning4j_tpu_torch/util/
model_serializer.py) against the JAX package's on the CPU.

* A zip the JAX package wrote restores in the port, and a zip the port
  wrote restores in the JAX package, with the same outputs (within f32
  rounding: the two packages compute the same function in another
  summation order) — a dense MultiLayerNetwork, one with batch norm's
  running statistics in `state.npz`, a GravesLSTM graph and a 2-layer
  Transformer LM graph. Both packages write the same leaves in the same
  order for the same weights.
* A port zip resumes training in the port bit for bit: 3 Adam steps,
  save, restore, 3 more steps on each equal exactly.
* A JAX zip's `updater.npz` is mapped into the port's optimizer state
  (`updater_restored` True, no warning; the mapping's own parity cases
  are tests/test_torch_updater_map.py); a zip without an updater
  restores a fresh one silently. The wrong-kind restores raise
  ValueError, as in JAX.
* `LocalFileModelSaver` writes zips the JAX package restores.
"""

import io
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import (
    transformer_lm as jtransformer_lm,
)
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.earlystopping import core as tes
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.weights_io import params_to_numpy

pytestmark = pytest.mark.port

# f32 outputs of the two packages for the same weights
RTOL, ATOL = 1e-5, 1e-6
LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_length=16)


def _mln(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(11).learning_rate(0.05)
            .updater("adam").list()
            .layer(pkg.DenseLayer(n_in=5, n_out=9, activation="relu"))
            .layer(pkg.OutputLayer(n_in=9, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
            .build())


def _bn(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(12).learning_rate(0.05)
            .updater("adam").list()
            .layer(pkg.DenseLayer(n_in=5, n_out=8, activation="identity"))
            .layer(pkg.BatchNormalization(n_in=8, n_out=8))
            .layer(pkg.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
            .build())


def _lstm(pkg):
    g = (pkg.NeuralNetConfiguration.builder().seed(5).learning_rate(0.05)
         .updater("rmsprop").graph_builder().add_inputs("in"))
    g.add_layer("lstm", pkg.GravesLSTM(n_in=4, n_out=6, activation="tanh"),
                "in")
    g.add_layer("out", pkg.RnnOutputLayer(n_in=6, n_out=2,
                                          activation="softmax",
                                          loss_function="mcxent"), "lstm")
    g.set_outputs("out")
    return g.build()


def _data(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lstm":
        x = rng.random((4, 7, 4), dtype=np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 7))]
    elif kind == "lm":
        x = rng.integers(0, LM["vocab_size"], (4, 16)).astype(np.int32)
        y = np.roll(x, -1, 1)
    else:
        x = rng.random((16, 5), dtype=np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def _jax_net(kind):
    if kind == "lm":
        return jtransformer_lm(**LM).init()
    conf = {"mln": _mln, "bn": _bn, "lstm": _lstm}[kind](jconf)
    return (JGraph(conf) if kind == "lstm" else JNet(conf)).init()


def _port_net(kind):
    if kind == "lm":
        return transformer_lm(**LM, device="cpu").init(0)
    conf = {"mln": _mln, "bn": _bn, "lstm": _lstm}[kind](tconf)
    return (TGraph(conf, device="cpu") if kind == "lstm"
            else TNet(conf, device="cpu")).init()


def _out(y):
    return (y.float().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y, np.float32))


KINDS = ["mln", "bn", "lstm", "lm"]


@pytest.mark.parametrize("kind", KINDS)
def test_a_jax_zip_restores_in_the_port_with_the_same_outputs(kind,
                                                              tmp_path):
    jnet = _jax_net(kind)
    jnet.fit(JDataSet(*_data(kind)))
    path = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        net = ModelSerializer.restore(path, device="cpu")
    assert type(net).__name__ == type(jnet).__name__
    assert net.updater_restored is True
    assert net.iteration_count == jnet.iteration_count == 1
    assert getattr(net, "epoch_count", 1) == getattr(jnet, "epoch_count", 1)
    x, _ = _data(kind, 1)
    np.testing.assert_allclose(_out(net.output(x)), _out(jnet.output(x)),
                               rtol=RTOL, atol=ATOL)
    # the port trains on with the restored updater state
    net.fit(TDataSet(*_data(kind, 2)))
    assert np.isfinite(net.score_value)


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_zip_restores_in_jax_with_the_same_outputs(kind, tmp_path):
    net = _port_net(kind)
    net.fit(TDataSet(*_data(kind)))
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    with zipfile.ZipFile(path) as zf:
        assert set(zf.namelist()) == {"configuration.json", "params.npz",
                                      "state.npz", "port_updater.pt",
                                      "meta.json"}
    jnet = JSerializer.restore(path)
    assert type(jnet).__name__ == type(net).__name__
    assert jnet.iteration_count == net.iteration_count == 1
    x, _ = _data(kind, 1)
    np.testing.assert_allclose(_out(jnet.output(x)), _out(net.output(x)),
                               rtol=RTOL, atol=ATOL)
    # the JAX net trains on with a fresh optax state
    jnet.fit(JDataSet(*_data(kind, 2)))
    assert np.isfinite(float(jnet.score_value))


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_write_the_same_leaves_in_the_same_order(kind,
                                                               tmp_path):
    jnet = _jax_net(kind)
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    JSerializer.write_model(jnet, jpath)
    net = ModelSerializer.restore(jpath, device="cpu")
    ModelSerializer.write_model(net, tpath)
    for name in ("params.npz", "state.npz"):
        with zipfile.ZipFile(jpath) as a, zipfile.ZipFile(tpath) as b:
            ja = np.load(io.BytesIO(a.read(name)))
            ta = np.load(io.BytesIO(b.read(name)))
            assert ja.files == ta.files
            for k in ja.files:
                np.testing.assert_array_equal(ta[k], ja[k])
    leaves = jax.tree.leaves(jax.tree.map(np.asarray, jnet.params))
    assert len(leaves) == len(np.load(io.BytesIO(
        zipfile.ZipFile(tpath).read("params.npz"))).files)


@pytest.mark.parametrize("kind", ["mln", "bn", "lm"])
def test_a_port_zip_resumes_training_bit_for_bit(kind, tmp_path):
    torch.manual_seed(0)
    net = _port_net(kind)
    for i in range(3):  # 3 Adam steps
        net.fit(TDataSet(*_data(kind, i)))
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(net, path)
    restored = ModelSerializer.restore(path, device="cpu")
    assert restored.updater_restored is True
    assert restored.iteration_count == net.iteration_count == 3
    for i in range(3, 6):
        net.fit(TDataSet(*_data(kind, i)))
        restored.fit(TDataSet(*_data(kind, i)))
    a, b = params_to_numpy(net), params_to_numpy(restored)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(a):
        other = b
        for k in path_:
            other = other[k.key]
        np.testing.assert_array_equal(other, leaf)
    x, _ = _data(kind, 9)
    assert torch.equal(net.output(x), restored.output(x))


def test_a_zip_without_updater_restores_a_fresh_one_silently(tmp_path):
    net = _port_net("mln")
    net.fit(TDataSet(*_data("mln")))
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(net, path, save_updater=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = ModelSerializer.restore(path, device="cpu")
    assert restored.updater_restored is False
    x, _ = _data("mln", 2)
    np.testing.assert_allclose(_out(restored.output(x)), _out(net.output(x)),
                               rtol=0, atol=0)


def test_kind_specific_restores_reject_wrong_kind(tmp_path):
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(_port_net("mln"), path)
    with pytest.raises(ValueError, match="not a ComputationGraph"):
        ModelSerializer.restore_computation_graph(path, device="cpu")
    assert isinstance(ModelSerializer.restore_multi_layer_network(
        path, device="cpu"), TNet)
    gpath = str(tmp_path / "g.zip")
    ModelSerializer.write_model(_port_net("lstm"), gpath)
    with pytest.raises(ValueError, match="not a MultiLayerNetwork"):
        ModelSerializer.restore_multi_layer_network(gpath, device="cpu")
    assert isinstance(ModelSerializer.restore_computation_graph(
        gpath, device="cpu"), TGraph)


def test_a_restored_net_lands_on_the_device_asked_for(tmp_path):
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(_port_net("mln"), path)
    net = ModelSerializer.restore(path, device="cpu")
    assert net.device.type == "cpu"
    assert all(t.device.type == "cpu" for layer in net.params.values()
               for t in layer.values())


def test_local_file_model_saver_writes_zips_jax_restores(tmp_path):
    net = _port_net("mln")
    x, y = _data("mln")
    net.fit(TDataSet(x, y))
    saver = tes.LocalFileModelSaver(str(tmp_path), device="cpu")
    saver.save_best_model(net, 0.5)
    saver.save_latest_model(net, 0.5)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bestModel.zip", "latestModel.zip"]
    best = saver.get_best_model()
    assert torch.equal(best.output(x), net.output(x))
    jnet = JSerializer.restore(str(tmp_path / "bestModel.zip"))
    np.testing.assert_allclose(_out(jnet.output(x)), _out(net.output(x)),
                               rtol=RTOL, atol=ATOL)
