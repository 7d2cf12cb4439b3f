"""The port's solvers (deeplearning4j_tpu_torch/optimize/solvers.py) and
listeners (optimize/listeners.py) against the JAX package on the CPU.

The solvers run over the same float32 vectors and the same losses in
both packages: the line search returns the same step; three iterations
of line gradient descent, CG and L-BFGS land on the same point to 1e-5
absolute (the Armijo test compares host floats in the port, float32
arrays in JAX: a comparison within rounding could branch differently,
and these problems keep every one clear); a network fit through the
Solver path gives the same score to 1e-5 relative from the same params.
HessianFree's Hessian-vector products are double backward passes in
the port (jax.jvp of the gradient in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import solvers as js
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.optimize import listeners as tl
from deeplearning4j_tpu_torch.optimize import solvers as ts
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

X_ATOL = 1e-5
SCORE_RTOL = 1e-5


def _scales(n, lib):
    return lib.linspace(1.0, 100.0, n)


def jquad(x):
    return 0.5 * jnp.sum(_scales(x.shape[0], jnp) * x * x)


def tquad(x):
    return 0.5 * (_scales(x.shape[0], torch) * x * x).sum()


def jrosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def trosen(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def test_line_search_matches_jax():
    x = np.linspace(-1, 1, 6).astype(np.float32)
    f0, g = jax.value_and_grad(jquad)(jnp.asarray(x))
    jt, jf = js.backtrack_line_search(jquad, jnp.asarray(x), f0, g, -g)
    tx = torch.from_numpy(x)
    tg = torch.from_numpy(np.array(g))
    tt, tf = ts.backtrack_line_search(tquad, tx, float(f0), tg, -tg)
    assert tt == float(jt) > 0
    np.testing.assert_allclose(tf, float(jf), rtol=1e-6)


@pytest.mark.parametrize("name", ["LineGradientDescent", "ConjugateGradient",
                                  "LBFGS"])
@pytest.mark.parametrize("problem", ["quad", "rosen"])
def test_three_iterations_match_jax(name, problem):
    jf, tf, x0 = ((jquad, tquad, np.ones(10, np.float32)) if problem == "quad"
                  else (jrosen, trosen, np.full(6, 0.5, np.float32)))
    jr = getattr(js, name)(jf, max_iterations=3,
                           terminations=[]).optimize(jnp.asarray(x0))
    tr = getattr(ts, name)(tf, max_iterations=3,
                           terminations=[]).optimize(torch.from_numpy(x0))
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=X_ATOL)
    np.testing.assert_allclose(tr.score, jr.score, rtol=SCORE_RTOL)


@pytest.mark.parametrize("cls,iters,tol", [
    (ts.LineGradientDescent, 200, 1e-3),
    (ts.ConjugateGradient, 60, 1e-4),
    (ts.LBFGS, 40, 1e-5),
])
def test_quadratic_convergence(cls, iters, tol):
    """The JAX package's own convergence bounds (tests/test_solvers.py)."""
    res = cls(tquad, max_iterations=iters,
              terminations=[ts.EpsTermination(1e-10, 1e-12)]).optimize(
                  torch.ones(10))
    assert res.score < tol


def test_lbfgs_rosenbrock_and_sgd_solver():
    res = ts.LBFGS(trosen, max_iterations=300, m=10,
                   terminations=[ts.EpsTermination(1e-12, 1e-14)]).optimize(
                       torch.zeros(8))
    assert res.score < 1e-3
    sgd = ts.StochasticGradientDescent(tquad, max_iterations=50, lr=0.005)
    assert sgd.optimize(torch.ones(10)).score < float(tquad(torch.ones(10)))


def test_hessian_free_quadratic_and_rosenbrock():
    A = torch.tensor([[3.0, 0.5], [0.5, 1.0]])
    b = torch.tensor([1.0, -2.0])
    res = ts.HessianFree(lambda x: 0.5 * x @ A @ x - b @ x, max_iterations=8,
                         cg_iterations=16, initial_lambda=1e-3).optimize(
                             torch.zeros(2))
    np.testing.assert_allclose(res.x.numpy(),
                               torch.linalg.solve(A, b).numpy(), atol=1e-3)

    def rosen2(x):
        return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    res = ts.HessianFree(rosen2, max_iterations=60,
                         cg_iterations=20).optimize(torch.tensor([-1.2, 1.0]))
    assert res.score < 1e-2


def _net_conf(pkg, algo, iterations=3):
    return (pkg.NeuralNetConfiguration.builder().seed(12345)
            .optimization_algo(algo).iterations(iterations)
            .weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(pkg.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
            .build())


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent", "hessian_free"])
def test_network_fit_with_solver_matches_jax(algo):
    """The Solver path of fit(): from the same params, the same score
    after a minibatch in both packages, and the score falls."""
    x, y = _data()
    jnet = JNet(_net_conf(jconf, algo)).init()
    tnet = TNet(_net_conf(tconf, algo), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    before = tnet.score(TDataSet(x, y))
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    assert tnet.score(TDataSet(x, y)) < before
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=SCORE_RTOL)
    assert tnet.iteration_count == jnet.iteration_count


def _graph_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(3)
            .optimization_algo("lbfgs").iterations(4).weight_init("xavier")
            .graph_builder().add_inputs("in")
            .add_layer("d", pkg.DenseLayer(n_in=4, n_out=6,
                                           activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_in=6, n_out=3,
                                              activation="softmax",
                                              loss_function="mcxent"), "d")
            .set_outputs("out").build())


def test_graph_fit_with_solver_matches_jax():
    x, y = _data()
    jnet = JGraph(_graph_conf(jconf)).init()
    tnet = TGraph(_graph_conf(tconf), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=SCORE_RTOL)


def test_solver_listeners_get_the_optimizer_and_solver_sets_params():
    x, y = _data()
    net = TNet(_net_conf(tconf, "lbfgs", iterations=5), device="cpu").init()
    solver = ts.Solver(net, listeners=[tl.CollectScoresIterationListener()])
    batch = net._batch_dict(TDataSet(x, y))
    res = solver.optimize(batch)
    seen = solver.listeners[0].scores
    assert [i for i, _ in seen] == list(range(1, res.iterations + 1))
    assert seen[-1][1] == res.score == net.score_value
    np.testing.assert_allclose(net.params_flat(), res.x.numpy())


def test_listeners_fire_from_every_fit_path():
    """fit: once a step (TBPTT: once a segment); the Solver path: once a
    minibatch; fit_scanned: once an epoch with the epoch's mean."""
    x, y = _data()
    lines = []
    collect = tl.CollectScoresIterationListener()
    perf = tl.PerformanceListener(frequency=1, printer=lines.append,
                                  examples_per_iteration=32)
    net = TNet(_net_conf(tconf, "stochastic_gradient_descent", iterations=1),
               device="cpu").init()
    net.set_listeners(tl.ComposableIterationListener(collect, perf),
                      tl.ScoreIterationListener(2, printer=lines.append),
                      tl.ParamAndGradientIterationListener(
                          frequency=3, printer=lines.append))
    for _ in range(3):
        net.fit(TDataSet(x, y))
    assert [i for i, _ in collect.scores] == [1, 2, 3]
    assert any(line.startswith("Score at iteration 2") for line in lines)
    assert any("layer_0/W" in line for line in lines)
    assert perf.last_stats["examples_per_sec"] > 0
    net.fit_scanned(TDataSet(x, y), epochs=2)
    assert [i for i, _ in collect.scores] == [1, 2, 3, 4, 5]
    solver_net = TNet(_net_conf(tconf, "lbfgs"), device="cpu").init()
    solver_net.set_listeners(collect)
    solver_net.fit(TDataSet(x, y))
    assert collect.scores[-1][0] == solver_net.iteration_count
