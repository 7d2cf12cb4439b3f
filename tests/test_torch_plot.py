"""The port's plot package (deeplearning4j_tpu_torch/plot/) on the CPU
against the JAX package's, on the same numpy data.

* `_x2p` (the lock-step perplexity bisection, 50 steps): P within 1e-4
  of its largest entry (f32 softmax and log in another order).
* `_tsne_step` from a JAX run's state after 100 iterations: one step's
  y within 1e-5 of its scale and the gains equal; after 50 steps the KL
  within 5% (2.8% apart here) and at least 95% of each point's 5
  nearest neighbours in the embedding from its own cluster, in both
  (t-SNE is chaotic: the gains' sign tests amplify the last bits, so 50
  steps are held by KL and neighbourhoods, not by coordinates, which
  drift a quarter of their scale apart here).
* The whole run from JAX's y0 (`calculate(..., y0=...)`) on five
  well-separated clusters: the final KL within 5% of JAX's and each
  point's 5 nearest neighbours in the embedding from its own cluster
  for at least 95% of them, in both. (On data without such structure,
  two correct runs whose first step agrees to 4e-7 end up to 12% apart
  in KL, so the whole run is held where the minimum is stable.)
* Barnes-Hut t-SNE and the filter plots are numpy copies: equal to
  JAX's bit for bit; the filter listener on a port net equals JAX's on a
  JAX net whose params were carried across with `weights_io`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.plot import barnes_hut_tsne as jbh
from deeplearning4j_tpu.plot import filters as jfl
from deeplearning4j_tpu.plot import tsne as jts
from deeplearning4j_tpu_torch.plot import barnes_hut_tsne as tbh
from deeplearning4j_tpu_torch.plot import filters as tfl
from deeplearning4j_tpu_torch.plot import tsne as tts
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

P_TOL = 1e-4
STEP_TOL = 1e-5
STEPS50_KL_RTOL = 5e-2
RUN_KL_RTOL = 5e-2
KNN_MIN = 0.95


def _clusters(k=5, per=20, dim=10, seed=1):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(per, dim))
                        + 6 * rng.normal(size=dim) for _ in range(k)])
    return x.astype(np.float32), np.repeat(np.arange(k), per)


def _jax_y0(n, dims=2, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (n, dims)) * 1e-4)


def _knn_same_cluster(y, labels, k=5):
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, 1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


@pytest.mark.parametrize("perplexity", [5.0, 10.0, 30.0])
def test_x2p_equals_jax(perplexity):
    x, _ = _clusters(k=4, per=20)
    pj = np.asarray(jts._x2p(jnp.asarray(x), perplexity))
    pt = tts._x2p(torch.from_numpy(x), perplexity).numpy()
    assert np.abs(pt - pj).max() <= P_TOL * pj.max()
    np.testing.assert_allclose(pt.sum(1), 1.0, atol=1e-5)


def _jax_state(x, iters=100, lr=100.0):
    n = len(x)
    pj = np.asarray(jts._x2p(jnp.asarray(x), 10.0))
    P = np.maximum((pj + pj.T) / (2 * n), 1e-12).astype(np.float32)
    y, iy, g = jnp.asarray(_jax_y0(n)), jnp.zeros((n, 2)), jnp.ones((n, 2))
    for i in range(iters):
        y, iy, g, _ = jts._tsne_step(y, iy, g, jnp.asarray(P) * 4.0,
                                     jnp.asarray(P), 0.5 if i < 20 else 0.8,
                                     0.01, lr)
    return P, [np.asarray(t) for t in (y, iy, g)]


@pytest.mark.parametrize("steps", [1, 50])
def test_tsne_steps_from_jax_state(steps):
    x, labels = _clusters(k=2, per=40)
    P, state = _jax_state(x)
    j = [jnp.asarray(t) for t in state]
    t = [torch.from_numpy(a.copy()) for a in state]
    for _ in range(steps):
        *j, klj = jts._tsne_step(*j, jnp.asarray(P), jnp.asarray(P), 0.8,
                                 0.01, 100.0)
        *t, klt = tts._tsne_step(*t, torch.from_numpy(P),
                                 torch.from_numpy(P), 0.8, 0.01, 100.0)
    yj = np.asarray(j[0])
    err = np.abs(t[0].numpy() - yj).max() / np.abs(yj).max()
    if steps == 1:
        assert err <= STEP_TOL
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        assert float(klt) == pytest.approx(float(klj), rel=1e-5)
    else:
        assert float(klt) == pytest.approx(float(klj), rel=STEPS50_KL_RTOL)
        assert _knn_same_cluster(t[0].numpy(), labels) >= KNN_MIN
        assert _knn_same_cluster(yj, labels) >= KNN_MIN


def test_whole_run_from_jax_y0():
    x, labels = _clusters()
    kw = dict(max_iter=800, perplexity=10.0, learning_rate=100.0, seed=0)
    J = jts.Tsne(**kw)
    yj = J.calculate(x)
    T = tts.Tsne(device="cpu", **kw)
    yt = T.calculate(x, y0=_jax_y0(len(x)))
    assert yt.shape == (len(x), 2) and np.isfinite(yt).all()
    assert len(T.kl_history) == len(J.kl_history) == 16
    assert T.kl_history[-1] == pytest.approx(J.kl_history[-1],
                                             rel=RUN_KL_RTOL)
    assert T.kl_history[-1] < T.kl_history[5]  # falls after exaggeration
    assert _knn_same_cluster(yt, labels) >= KNN_MIN
    assert _knn_same_cluster(yj, labels) >= KNN_MIN


def test_tsne_start_and_device():
    t = tts.Tsne(seed=3, device="cpu")
    a, b = t.initial_y(50), tts.Tsne(seed=3, device="cpu").initial_y(50)
    assert torch.equal(a, b) and a.shape == (50, 2)
    assert float(a.abs().max()) < 1e-3
    assert tts.Tsne().device.type == "cuda"
    x, _ = _clusters(k=2, per=10)
    y = tts.Tsne(max_iter=60, perplexity=5.0, learning_rate=50.0,
                 device="cpu").calculate(torch.from_numpy(x))
    assert y.shape == (20, 2) and np.isfinite(y).all()


def test_barnes_hut_equals_jax():
    x, _ = _clusters(k=2, per=16, dim=8)
    kw = dict(max_iter=120, perplexity=5.0, theta=0.5, learning_rate=100.0,
              stop_lying_iteration=50, momentum_switch=50, seed=0)
    ours, theirs = tbh.BarnesHutTsne(**kw), jbh.BarnesHutTsne(**kw)
    yt, yj = ours.fit(x, 2), theirs.fit(x, 2)
    np.testing.assert_array_equal(yt, yj)
    assert ours.kl_divergences == theirs.kl_divergences
    assert ours.get_data() is yt


def test_plot_filters_equal_jax():
    rng = np.random.default_rng(4)
    for arr, tile, image in ((rng.normal(size=(12, 25)), (3, 4), (5, 5)),
                             (rng.normal(size=(6, 4, 4, 3)), (2, 3), None)):
        a = tfl.PlotFilters(arr, tile, (1, 1), image).plot()
        b = jfl.PlotFilters(arr, tile, (1, 1), image).plot()
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="image_shape"):
        tfl.PlotFilters(rng.normal(size=(4, 9)), (2, 2))
    with pytest.raises(RuntimeError):
        tfl.PlotFilters(rng.normal(size=(4, 9)), (2, 2),
                        image_shape=(3, 3)).get_plot()


def _dense_pair(n_in=16, n_out=9):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def build(conf_cls, dense, out):
        return (conf_cls.builder().seed(1).learning_rate(0.1).list()
                .layer(dense(n_in=n_in, n_out=n_out, activation="relu"))
                .layer(out(n_in=n_out, n_out=2, activation="softmax",
                           loss_function="negativeloglikelihood"))
                .build())

    jnet = JNet(build(JConf, JDense, JOut)).init()
    tnet = MultiLayerNetwork(build(NeuralNetConfiguration, DenseLayer,
                                   OutputLayer), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    return jnet, tnet


def test_filter_listener_equals_jax_on_carried_params(tmp_path):
    jnet, tnet = _dense_pair()
    name = tnet.layer_names[0]
    ours = tfl.PlotFiltersIterationListener(
        name, (3, 3), frequency=2, output_path=str(tmp_path / "f.npy"))
    theirs = jfl.PlotFiltersIterationListener(name, (3, 3), frequency=2)
    for it in range(3):
        ours.iteration_done(tnet, it)
        theirs.iteration_done(jnet, it)
    assert ours.invoked == theirs.invoked == 2
    np.testing.assert_array_equal(ours.last_plot, theirs.last_plot)
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"),
                                  ours.last_plot)
