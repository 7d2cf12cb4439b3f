"""The port's early stopping (deeplearning4j_tpu_torch/earlystopping/core.py)
against the JAX package's on the CPU: the same nets (SGD, params copied
from the JAX net) on the same numpy-seeded data give the same score per
epoch (1e-5 relative), the same best epoch and the same termination;
the best model comes back from both savers bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JIt
from deeplearning4j_tpu.earlystopping import core as jes
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator as TIt
from deeplearning4j_tpu_torch.earlystopping import core as tes
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.weights_io import params_from_jax, params_to_numpy

pytestmark = pytest.mark.port

SCORE_RTOL = 1e-5


def _data(seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4), dtype=np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 2.0).astype(int)]
    return x, y


def _mln(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(3).learning_rate(0.5)
            .updater("sgd").weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_in=4, n_out=12, activation="tanh"))
            .layer(pkg.OutputLayer(n_in=12, n_out=2, activation="softmax",
                                   loss_function="mcxent"))
            .build())


def _graph(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(4).learning_rate(0.5)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("d", pkg.DenseLayer(n_in=4, n_out=8,
                                           activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_in=8, n_out=2,
                                              activation="softmax",
                                              loss_function="mcxent"), "d")
            .set_outputs("out").build())


def _pair(kind):
    if kind == "graph":
        jnet, tnet = JGraph(_graph(jconf)).init(), TGraph(
            _graph(tconf), device="cpu").init()
    else:
        jnet, tnet = JNet(_mln(jconf)).init(), TNet(_mln(tconf),
                                                    device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    return jnet, tnet


class _Both(tes.ModelSaver):
    """Saves to an InMemoryModelSaver and a LocalFileModelSaver at once."""

    def __init__(self, directory):
        self.mem = tes.InMemoryModelSaver()
        self.disk = tes.LocalFileModelSaver(directory)

    def save_best_model(self, net, score):
        self.mem.save_best_model(net, score)
        self.disk.save_best_model(net, score)

    def save_latest_model(self, net, score):
        self.mem.save_latest_model(net, score)
        self.disk.save_latest_model(net, score)

    def get_best_model(self):
        return self.mem.get_best_model()


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_trainer_matches_jax_and_both_savers_restore_the_best(kind, tmp_path):
    jnet, tnet = _pair(kind)
    train, val = _data(0), _data(1)
    jcfg = jes.EarlyStoppingConfiguration(
        score_calculator=jes.DataSetLossCalculator(JIt([JDataSet(*val)])),
        epoch_terminations=[jes.MaxEpochsTerminationCondition(4)],
        save_last_model=True)
    saver = _Both(str(tmp_path))
    tcfg = tes.EarlyStoppingConfiguration(
        score_calculator=tes.DataSetLossCalculator(TIt([TDataSet(*val)])),
        model_saver=saver,
        epoch_terminations=[tes.MaxEpochsTerminationCondition(4)],
        save_last_model=True)
    jcls, tcls = ((jes.EarlyStoppingGraphTrainer, tes.EarlyStoppingGraphTrainer)
                  if kind == "graph" else
                  (jes.EarlyStoppingTrainer, tes.EarlyStoppingTrainer))
    jr = jcls(jcfg, jnet, JIt([JDataSet(*train)])).fit()
    tr = tcls(tcfg, tnet, TIt([TDataSet(*train)])).fit()
    assert (tr.termination_reason, tr.termination_details, tr.total_epochs,
            tr.best_model_epoch) == (jr.termination_reason,
                                     jr.termination_details, jr.total_epochs,
                                     jr.best_model_epoch)
    np.testing.assert_allclose(
        [tr.score_vs_epoch[e] for e in sorted(tr.score_vs_epoch)],
        [jr.score_vs_epoch[e] for e in sorted(jr.score_vs_epoch)],
        rtol=SCORE_RTOL)
    best_mem = params_to_numpy(tr.best_model.params)
    best_disk = saver.disk.get_best_model()
    assert type(best_disk) is type(tnet)
    for path, a in jax.tree_util.tree_leaves_with_path(best_mem):
        b = params_to_numpy(best_disk.params)
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(b, a)
    x, _ = _data(1)
    np.testing.assert_array_equal(best_disk.output(x).numpy(),
                                  tr.best_model.output(x).numpy())
    latest = tes.LocalFileModelSaver(str(tmp_path), device="cpu")
    assert latest.get_best_model().iteration_count == best_disk.iteration_count


def test_score_improvement_and_iteration_terminations_match_jax():
    for make in (
            lambda es: dict(epoch_terminations=[
                es.ScoreImprovementEpochTerminationCondition(1, 1.0),
                es.MaxEpochsTerminationCondition(50)]),
            lambda es: dict(iteration_terminations=[
                es.MaxScoreIterationTerminationCondition(1e-9)],
                epoch_terminations=[es.MaxEpochsTerminationCondition(5)]),
            lambda es: dict(epoch_terminations=[
                es.BestScoreEpochTerminationCondition(10.0)])):
        jnet, tnet = _pair("multilayer")
        train = _data(2)
        jr = jes.EarlyStoppingTrainer(
            jes.EarlyStoppingConfiguration(**make(jes)), jnet,
            JIt([JDataSet(*train)])).fit()
        tr = tes.EarlyStoppingTrainer(
            tes.EarlyStoppingConfiguration(**make(tes)), tnet,
            TIt([TDataSet(*train)])).fit()
        assert (tr.termination_reason, tr.termination_details,
                tr.total_epochs) == (jr.termination_reason,
                                     jr.termination_details, jr.total_epochs)


def test_invalid_score_stops_and_the_in_memory_snapshot_is_a_copy():
    _, tnet = _pair("multilayer")
    saver = tes.InMemoryModelSaver()
    saver.save_best_model(tnet, 1.0)
    snap = saver.get_best_model()
    before = params_to_numpy(snap.params)
    tnet.fit(TDataSet(*_data(3)))
    after = params_to_numpy(snap.params)
    for layer in before:
        for name in before[layer]:
            np.testing.assert_array_equal(after[layer][name],
                                          before[layer][name])
    cond = tes.InvalidScoreIterationTerminationCondition()
    assert cond.terminate(float("nan")) and cond.terminate(float("inf"))
    assert not cond.terminate(torch.tensor(1.0).item())
