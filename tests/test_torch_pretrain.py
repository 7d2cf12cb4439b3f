"""The port's pretrain layers (AutoEncoder, RBM in
deeplearning4j_tpu_torch/nn/layers/feedforward.py), layerwise
pretraining in both containers, and nested networks
(nn/layers/nested.py `NetworkLayer`) against the JAX package on the
CPU, the JAX params copied across.

The two packages draw corruption masks and Gibbs samples from different
RNGs, so the comparisons take the pieces that are deterministic:
corruption 0, the free energy, the CD loss for a given negative sample,
and rectified hidden with linear visible units (mean-field, no draw).
Tolerances, float32: losses to 1e-5 relative, gradients and params to
2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import get_impl as jimpl
from deeplearning4j_tpu.nn.layers.nested import NetworkLayer as JNetworkLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.layers import get_impl as timpl
from deeplearning4j_tpu_torch.nn.layers.nested import NetworkLayer as TNetworkLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.weights_io import params_from_jax, params_to_numpy

pytestmark = pytest.mark.port

LOSS_RTOL = 1e-5
ATOL = 2e-5


def _init(pkg_layer_pair, seed=0):
    jl, tl = pkg_layer_pair
    jp, _ = jimpl(jl).init(jl, jax.random.PRNGKey(seed), jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    return jl, tl, jp, params_from_jax(jp, "cpu")


def _both(cls_name, **kw):
    kw = dict(n_in=12, n_out=7, weight_init="xavier", **kw)
    return getattr(jconf, cls_name)(**kw), getattr(tconf, cls_name)(**kw)


def _x(seed, n=16, d=12, binary=False):
    x = np.random.default_rng(seed).random((n, d)).astype(np.float32)
    return (x > 0.5).astype(np.float32) if binary else x


def _loss_and_grads_match(jf, tf, jp, tp):
    jl, jg = jax.value_and_grad(jf)(jax.tree.map(jnp.asarray, jp))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tl = tf(leaves)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for k in jg:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("sparsity", [0.0, 0.1])
def test_autoencoder_matches_jax_without_corruption(sparsity):
    jl, tl, jp, tp = _init(_both("AutoEncoder", activation="sigmoid",
                                 corruption_level=0.0, sparsity=sparsity))
    x = _x(1)
    ji, ti = jimpl(jl), timpl(tl)
    _loss_and_grads_match(
        lambda p: ji.pretrain_loss(jl, p, jnp.asarray(x), None),
        lambda p: ti.pretrain_loss(tl, p, torch.from_numpy(x), None), jp, tp)
    y, _ = ti.apply(tl, tp, {}, torch.from_numpy(x))
    jy, _ = ji.apply(jl, jax.tree.map(jnp.asarray, jp), {}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


def test_autoencoder_corruption_zeroes_about_its_level():
    _, tl, _, tp = _init(_both("AutoEncoder", activation="sigmoid",
                               corruption_level=0.3))
    x = torch.ones(200, 12)
    g = torch.Generator().manual_seed(0)
    seen = {}
    orig = timpl(tl).encode

    def spy(conf, params, xx):
        seen["x"] = xx
        return orig(conf, params, xx)

    impl = timpl(tl)
    impl.encode = spy
    try:
        impl.pretrain_loss(tl, tp, x, g)
    finally:
        del impl.encode
    assert abs(float((seen["x"] == 0).float().mean()) - 0.3) < 0.03


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_free_energy_and_cd_loss_for_a_given_sample_match_jax(visible):
    jl, tl, jp, tp = _init(_both("RBM", visible_unit=visible))
    x = _x(2, binary=visible == "binary")
    v_neg = _x(3, binary=visible == "binary")
    ji, ti = jimpl(jl), timpl(tl)
    np.testing.assert_allclose(
        ti.free_energy(tl, tp, torch.from_numpy(x)).numpy(),
        np.asarray(ji.free_energy(jl, jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x))), atol=ATOL)
    _loss_and_grads_match(
        lambda p: jnp.mean(ji.free_energy(jl, p, jnp.asarray(x))
                           - ji.free_energy(jl, p, jnp.asarray(v_neg))),
        lambda p: ti.cd_loss(tl, p, torch.from_numpy(x),
                             torch.from_numpy(v_neg)), jp, tp)


def test_rbm_mean_field_pretrain_loss_matches_jax():
    """Rectified hidden and linear visible units draw nothing: the whole
    CD-2 loss and its gradient are deterministic in both packages."""
    jl, tl, jp, tp = _init(_both("RBM", hidden_unit="rectified",
                                 visible_unit="linear", k=2))
    x = _x(4)
    ji, ti = jimpl(jl), timpl(tl)
    _loss_and_grads_match(
        lambda p: ji.pretrain_loss(jl, p, jnp.asarray(x),
                                   jax.random.PRNGKey(0)),
        lambda p: ti.pretrain_loss(tl, p, torch.from_numpy(x),
                                   torch.Generator().manual_seed(0)), jp, tp)


def test_rbm_binary_sample_is_detached_and_binary():
    _, tl, _, tp = _init(_both("RBM"))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    v = timpl(tl).negative_sample(tl, tp, torch.from_numpy(_x(5)),
                                  torch.Generator().manual_seed(1))
    assert not v.requires_grad
    assert set(torch.unique(v).tolist()) <= {0.0, 1.0}


def _stack(pkg, pretrain=True, backprop=False):
    return (pkg.NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").list()
            .layer(pkg.AutoEncoder(n_in=12, n_out=8, activation="sigmoid",
                                   corruption_level=0.0))
            .layer(pkg.RBM(n_in=8, n_out=6, hidden_unit="rectified",
                           visible_unit="linear"))
            .layer(pkg.OutputLayer(n_in=6, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
            .pretrain(pretrain).backprop(backprop).build())


def _copy(jnet, tnet):
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)


def _assert_params(jnet, tnet):
    jp, tp = jax.tree.map(np.asarray, jnet.params), params_to_numpy(tnet.params)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        b = tp
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(b, a, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_multilayer_pretrain_matches_jax_and_fit_runs_it():
    """Greedy pretraining of an AutoEncoder (corruption 0) then a
    mean-field RBM stacked under a classifier, two batches and two
    epochs; then fit() with pretrain and backprop both on."""
    jnet, tnet = JNet(_stack(jconf)).init(), TNet(_stack(tconf),
                                                  device="cpu").init()
    _copy(jnet, tnet)
    rng = np.random.default_rng(6)
    sets = [(rng.random((16, 12)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
            for _ in range(2)]
    from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JIt
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator as TIt,
    )

    jnet.pretrain(JIt([JDataSet(*s) for s in sets]), epochs=2)
    tnet.pretrain(TIt([TDataSet(*s) for s in sets]), epochs=2)
    _assert_params(jnet, tnet)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=LOSS_RTOL)
    net = TNet(_stack(tconf, backprop=True), device="cpu").init()
    before = params_to_numpy(net.params)
    net.fit(TDataSet(*sets[0]))
    after = params_to_numpy(net.params)
    for layer in ("layer_0", "layer_1", "layer_2"):
        assert not np.array_equal(before[layer]["W"], after[layer]["W"])


def _graph(pkg, pretrain=True):
    return (pkg.NeuralNetConfiguration.builder().seed(8).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("ae", pkg.AutoEncoder(n_in=12, n_out=8,
                                             activation="tanh",
                                             corruption_level=0.0), "in")
            .add_layer("out", pkg.OutputLayer(n_in=8, n_out=3,
                                              activation="softmax",
                                              loss_function="mcxent"), "ae")
            .set_outputs("out").pretrain(pretrain).backprop(False).build())


def test_graph_pretrain_matches_jax():
    jnet, tnet = JGraph(_graph(jconf)).init(), TGraph(_graph(tconf),
                                                      device="cpu").init()
    _copy(jnet, tnet)
    x = _x(9)
    y = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    _assert_params(jnet, tnet)


def _inner(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(11).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(pkg.DenseLayer(n_in=8, n_out=6, activation="relu"))
            .build())


def _nested_graph(pkg, NetworkLayer):
    return (pkg.NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("mlp", NetworkLayer(conf=_inner(pkg)), "in")
            .add_layer("out", pkg.OutputLayer(n_in=6, n_out=3,
                                              activation="softmax",
                                              loss_function="mcxent"), "mlp")
            .set_outputs("out").build())


def _nested_mln(pkg, NetworkLayer):
    return (pkg.NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("sgd").list()
            .layer(NetworkLayer(conf=_inner(pkg)))
            .layer(pkg.OutputLayer(n_in=6, n_out=3, activation="softmax",
                                   loss_function="mcxent", weight_init="xavier"))
            .build())


@pytest.mark.parametrize("container", ["graph", "multilayer"])
def test_network_layer_trains_as_jax(container):
    """An MLP wrapped in a NetworkLayer inside a graph (and inside a
    MultiLayerNetwork): the inner params are the layer's subtree, the
    forward matches, and three SGD steps move every param as in JAX."""
    if container == "graph":
        jnet = JGraph(_nested_graph(jconf, JNetworkLayer)).init()
        tnet = TGraph(_nested_graph(tconf, TNetworkLayer), device="cpu").init()
        inner = "mlp"
    else:
        jnet = JNet(_nested_mln(jconf, JNetworkLayer)).init()
        tnet = TNet(_nested_mln(tconf, TNetworkLayer), device="cpu").init()
        inner = "layer_0"
    assert set(tnet.params[inner]) == {"layer_0", "layer_1"}
    _copy(jnet, tnet)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    _assert_params(jnet, tnet)
