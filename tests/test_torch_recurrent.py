"""The port's recurrent layers (deeplearning4j_tpu_torch/nn/layers/recurrent.py),
TBPTT and rnn_time_step against the JAX package on the CPU: the same
numpy-seeded inputs, the JAX layer's params copied across.

Tolerances, float32 on both sides: forwards, carries and one-step
streaming to 2e-6 absolute, input and param gradients to 1e-5; three
TBPTT steps of a 2-layer GravesLSTM net (SGD): losses to 1e-5 relative,
params to 2e-5 absolute. The port's own chunked `rnn_time_step` against
its full forward: 1e-6.
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
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.layers import get_impl as timpl
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.weights_io import params_from_jax, params_to_numpy

pytestmark = pytest.mark.port

FWD_ATOL = 2e-6
GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
KINDS = ("GravesLSTM", "LSTM", "GRU", "GravesBidirectionalLSTM")


def _layer(kind, n_in=3, n_out=5, **kw):
    kw = dict(n_in=n_in, n_out=n_out, activation="tanh", weight_init="xavier",
              **kw)
    return getattr(jconf, kind)(**kw), getattr(tconf, kind)(**kw)


def _init(kind, seed=0, **kw):
    jl, tl = _layer(kind, **kw)
    jp, _ = jimpl(jl).init(jl, jax.random.PRNGKey(seed), jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    return jl, tl, jp, params_from_jax(jp, "cpu")


def _seq(seed, B=3, T=7, n=3, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, n)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 5:] = 0
        mask[1, 2] = 0  # a hole: the carried h is emitted there
    return x, mask


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_gradients_match_jax(kind, masked):
    jl, tl, jp, tp = _init(kind)
    x, mask = _seq(1, masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jy, _ = jimpl(jl).apply(jl, jax.tree.map(jnp.asarray, jp), {},
                            jnp.asarray(x), mask=jm)
    tx = torch.from_numpy(x).requires_grad_()
    leaves = jax.tree.map(lambda t: t.requires_grad_(), tp)
    ty, _ = timpl(tl).apply(tl, leaves, {}, tx, mask=tm)
    _close(ty, jy, FWD_ATOL)
    w = np.random.default_rng(2).standard_normal(np.shape(jy)).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jimpl(jl).apply(jl, p, {}, xx, mask=jm)
        return jnp.sum(y * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    (ty * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx, GRAD_ATOL)
    for path, g in jax.tree_util.tree_leaves_with_path(jgp):
        keys = [k.key for k in path]
        t = leaves
        for k in keys:
            t = t[k]
        _close(t.grad, g, GRAD_ATOL)


@pytest.mark.parametrize("kind", ["GravesLSTM", "LSTM", "GRU"])
def test_carry_and_step_match_jax(kind):
    """A window from a given carry returns the JAX layer's last carry, and
    `step` advances one timestep as the JAX `step` does."""
    jl, tl, jp, tp = _init(kind, seed=3)
    x, _ = _seq(4)
    ji, ti = jimpl(jl), timpl(tl)
    jc = ji.initial_carry(jl, 3)
    jc = jax.tree.map(lambda a: a + 0.1, jc)
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)
    jy, _, jc2 = ji.apply(jl, jax.tree.map(jnp.asarray, jp), {},
                          jnp.asarray(x), initial_carry=jc, return_carry=True)
    ty, _, tc2 = ti.apply(tl, tp, {}, torch.from_numpy(x), initial_carry=tc,
                          return_carry=True)
    _close(ty, jy, FWD_ATOL)
    for a, b in zip(jax.tree.leaves(tc2), jax.tree.leaves(jc2)):
        _close(a, b, FWD_ATOL)
    jc3, jh = ji.step(jl, jax.tree.map(jnp.asarray, jp), jc2,
                      jnp.asarray(x[:, 0]))
    tc3, th = ti.step(tl, tp, tc2, torch.from_numpy(x[:, 0]))
    _close(th, jh, FWD_ATOL)
    for a, b in zip(jax.tree.leaves(tc3), jax.tree.leaves(jc3)):
        _close(a, b, FWD_ATOL)


def _char_net(pkg, T=None, tbptt=4, updater="sgd", kind="GravesLSTM"):
    b = (pkg.NeuralNetConfiguration.builder().seed(12345)
         .learning_rate(0.1).updater(updater).weight_init("xavier").list()
         .layer(getattr(pkg, kind)(n_in=6, n_out=8, activation="tanh"))
         .layer(getattr(pkg, kind)(n_in=8, n_out=8, activation="tanh"))
         .layer(pkg.RnnOutputLayer(n_in=8, n_out=6, activation="softmax",
                                   loss_function="mcxent")))
    if tbptt:
        b = (b.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
             .t_bptt_backward_length(tbptt))
    return b.build()


def _char_data(seed, B=2, T=12, V=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]]


def _pair_nets(**kw):
    jnet = JNet(_char_net(jconf, **kw)).init()
    tnet = TNet(_char_net(tconf, **kw), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    return jnet, tnet


def _assert_params(jnet, tnet):
    jp, tp = jax.tree.map(np.asarray, jnet.params), params_to_numpy(tnet.params)
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_allclose(tp[layer][name], jp[layer][name],
                                       atol=PARAM_ATOL,
                                       err_msg=f"{layer}.{name}")


def test_tbptt_three_steps_match_jax():
    """A 2-layer GravesLSTM net on a sequence of 12 with a window of 4:
    three optimizer steps, the carries flowing between windows."""
    jnet, tnet = _pair_nets()
    x, y = _char_data(5)
    jscores, tscores = [], []
    for net, out, ds in ((jnet, jscores, JDataSet(x, y)),
                         (tnet, tscores, TDataSet(x, y))):
        net.set_listeners(_Collect(out))
        net.fit(ds)
    assert len(tscores) == 3 and tnet.iteration_count == 3
    np.testing.assert_allclose(tscores, jscores, rtol=LOSS_RTOL)
    _assert_params(jnet, tnet)


class _Collect:
    def __init__(self, out):
        self.out = out

    def iteration_done(self, model, iteration):
        self.out.append(model.score_value)


def test_tbptt_refuses_per_sequence_labels():
    _, tnet = _pair_nets()
    x, _ = _char_data(6)
    with pytest.raises(ValueError, match="time-distributed labels"):
        tnet.fit(TDataSet(x, np.zeros((2, 6), np.float32)))


@pytest.mark.parametrize("kind", ["GravesLSTM", "GRU"])
def test_rnn_time_step_matches_jax_and_the_full_forward(kind):
    """Streaming in chunks of 5, 1 (a [B, n_in] step) and 6 equals the
    full forward, and the JAX package's stream."""
    jnet, tnet = _pair_nets(tbptt=0, kind=kind)
    x, _ = _char_data(7)
    full = tnet.output(x)
    parts = [tnet.rnn_time_step(x[:, :5]), tnet.rnn_time_step(x[:, 5])[:, None],
             tnet.rnn_time_step(x[:, 6:])]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(),
                               atol=1e-6)
    jparts = [jnet.rnn_time_step(x[:, :5]), jnet.rnn_time_step(x[:, 5])[:, None],
              jnet.rnn_time_step(x[:, 6:])]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(),
                               np.concatenate(jparts, 1), atol=FWD_ATOL)
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :5]).numpy(),
                               full[:, :5].numpy(), atol=1e-6)
    acts = tnet.rnn_activate_using_stored_state(x[:, 5:])
    np.testing.assert_allclose(acts[-1].numpy(), full[:, 5:].numpy(),
                               atol=1e-6)


def test_bidirectional_cannot_stream():
    conf = (tconf.NeuralNetConfiguration.builder().list()
            .layer(tconf.GravesBidirectionalLSTM(n_in=3, n_out=4,
                                                 weight_init="xavier"))
            .layer(tconf.RnnOutputLayer(n_in=4, n_out=2)).build())
    net = TNet(conf, device="cpu").init()
    with pytest.raises(ValueError, match="cannot stream causally"):
        net.rnn_time_step(np.zeros((1, 3), np.float32))


def _graph(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("lstm", pkg.GravesLSTM(n_in=6, n_out=8,
                                              activation="tanh"), "in")
            .add_layer("gru", pkg.GRU(n_in=8, n_out=8, activation="tanh"),
                       "lstm")
            .add_layer("out", pkg.RnnOutputLayer(n_in=8, n_out=6,
                                                 activation="softmax",
                                                 loss_function="mcxent"),
                       "gru")
            .set_outputs("out")
            .backprop_type("truncated_bptt").t_bptt_forward_length(4)
            .build())


def test_graph_tbptt_and_rnn_time_step_match_jax():
    jnet = JGraph(_graph(jconf)).init()
    tnet = TGraph(_graph(tconf), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    x, y = _char_data(8)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    assert tnet.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    _assert_params(jnet, tnet)
    a = torch.cat([tnet.rnn_time_step(x[:, :7]), tnet.rnn_time_step(x[:, 7:])],
                  1)
    b = np.concatenate([jnet.rnn_time_step(x[:, :7]),
                        jnet.rnn_time_step(x[:, 7:])], 1)
    np.testing.assert_allclose(a.numpy(), b, atol=FWD_ATOL)


@pytest.mark.parametrize("kind", KINDS + ("AutoEncoder", "RBM"))
def test_configs_round_trip_through_both_packages_serde(kind):
    """The recurrent and pretrain layer configs (the RBM with its unit
    enums) as JSON: the JAX package's loads in the port as the port's
    own, and back."""
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu_torch.nn.conf import serde as tserde

    kw = dict(n_in=3, n_out=5, name="l", l2=1e-3)
    if kind == "RBM":
        kw.update(hidden_unit="rectified", visible_unit="gaussian", k=2)
    jl, tl = getattr(jconf, kind)(**kw), getattr(tconf, kind)(**kw)
    assert tserde.from_json(jserde.to_json(jl)) == tl
    assert jserde.from_json(tserde.to_json(tl)) == jl
    assert tserde.from_json(tserde.to_json(tl)).is_pretrain_layer() == (
        kind in ("AutoEncoder", "RBM"))
