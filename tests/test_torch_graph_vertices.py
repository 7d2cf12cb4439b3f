"""The graph vertices and input preprocessors of the port
(nn/conf/graph_conf.py, nn/conf/preprocessors.py, nn/graph.py
`vertex_forward`, `ComputationGraph.predict`) against the JAX package on
the CPU.

Each vertex runs through the port's `vertex_forward` and the JAX
package's `ComputationGraph._vertex_forward` on the same inputs, made
from a seed with numpy; the gradients of a fixed random projection of
the output are `jax.vjp` against autograd. The preprocessors likewise
(`pre_process`). A graph that uses Merge, Subset, Scale, LastTimeStep
(with a padding mask) and DuplicateToTimeSeries trains three SGD steps
in both packages from the same params (`weights_io`), and a
PreprocessorVertex and Stack/Unstack pair run its forward. The JAX
package's JSON of such graphs loads in the port and writes back the
same.

Tolerances: the vertices are slices, concatenations and products of
f32 values: forward and gradients equal to 1e-6 absolute. The trained
graph: f32 params after three SGD steps 1e-5 of the largest entry, the
loss 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.conf import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.conf import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.serde import (
    from_json as torch_from_json,
    to_dict as torch_to_dict,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import vertex_forward
from deeplearning4j_tpu_torch.weights_io import (
    params_from_jax,
    params_to_numpy,
)
from torch_parallel_worker import flatten

pytestmark = pytest.mark.port

ATOL = 1e-6
TRAIN_TOL = 1e-5
B, T, F = 3, 5, 4


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask():
    lengths = np.array([5, 2, 3])
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def _jax_vertex(vconf, inputs, masks, acts):
    # the method reads no instance state for non-layer vertices
    return JGraph._vertex_forward(None, "v", vconf, inputs, {}, {}, False,
                                  None, masks, acts)


# (name, JAX vertex, port vertex, input shapes)
VERTICES = [
    ("merge-ff", jgc.MergeVertexConf(), tgc.MergeVertexConf(),
     [(B, 3), (B, 5)]),
    ("merge-rnn", jgc.MergeVertexConf(), tgc.MergeVertexConf(),
     [(B, T, 3), (B, T, 2), (B, T, 4)]),
    ("subset", jgc.SubsetVertexConf(from_idx=1, to_idx=3),
     tgc.SubsetVertexConf(from_idx=1, to_idx=3), [(B, T, 6)]),
    ("scale", jgc.ScaleVertexConf(scale=-2.5),
     tgc.ScaleVertexConf(scale=-2.5), [(B, T, F)]),
    ("last-step", jgc.LastTimeStepVertexConf(),
     tgc.LastTimeStepVertexConf(), [(B, T, F)]),
    ("last-step-masked", jgc.LastTimeStepVertexConf(mask_input="in"),
     tgc.LastTimeStepVertexConf(mask_input="in"), [(B, T, F)]),
    ("duplicate", jgc.DuplicateToTimeSeriesVertexConf(reference_input="ref"),
     tgc.DuplicateToTimeSeriesVertexConf(reference_input="ref"), [(B, F)]),
    ("stack", jgc.StackVertexConf(), tgc.StackVertexConf(),
     [(B, F), (B, F), (B, F)]),
    ("unstack", jgc.UnstackVertexConf(from_idx=1, stack_size=3),
     tgc.UnstackVertexConf(from_idx=1, stack_size=3), [(6, F)]),
    ("preprocessor", jgc.PreprocessorVertexConf(
        preprocessor=jpp.ReshapePreProcessor(shape=(T * F,))),
     tgc.PreprocessorVertexConf(
         preprocessor=tpp.ReshapePreProcessor(shape=(T * F,))),
     [(B, T, F)]),
] + [(f"elementwise-{op}", jgc.ElementWiseVertexConf(op=op),
      tgc.ElementWiseVertexConf(op=op), [(B, F), (B, F), (B, F)])
     for op in ("add", "subtract", "product", "average", "max")]


@pytest.mark.parametrize("name,jv,tv,shapes", VERTICES,
                         ids=[v[0] for v in VERTICES])
def test_vertex_forward_and_gradient_match_jax(name, jv, tv, shapes):
    xs = [_arr(i, s) for i, s in enumerate(shapes)]
    mask = _mask()
    ref_act = _arr(99, (B, T + 2, 1))
    jmasks = {"in": jnp.asarray(mask)}
    jacts = {"ref": jnp.asarray(ref_act)}

    def jfn(*ins):
        return _jax_vertex(jv, list(ins), jmasks, jacts)

    jy, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in xs))
    cot = _arr(7, jy.shape)
    jgrads = vjp(jnp.asarray(cot))

    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    ty = vertex_forward(tv, ts, {"in": torch.from_numpy(mask)},
                        {"ref": torch.from_numpy(ref_act)})
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    tgrads = torch.autograd.grad(ty, ts, torch.from_numpy(cot))
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL,
                                   rtol=0)


def test_vertex_output_types_match_jax():
    """get_output_type of every vertex kind, for feed-forward, recurrent
    and convolutional inputs."""
    ff, rnn = jconf.InputType.feed_forward(6), jconf.InputType.recurrent(6, T)
    cnn = jconf.InputType.convolutional(4, 4, 3)
    tff, trnn = tconf.InputType.feed_forward(6), tconf.InputType.recurrent(6,
                                                                          T)
    tcnn = tconf.InputType.convolutional(4, 4, 3)
    cases = [
        (jgc.MergeVertexConf(), tgc.MergeVertexConf(), (ff, ff), (tff, tff)),
        (jgc.MergeVertexConf(), tgc.MergeVertexConf(), (rnn, rnn),
         (trnn, trnn)),
        (jgc.MergeVertexConf(), tgc.MergeVertexConf(), (cnn, cnn),
         (tcnn, tcnn)),
        (jgc.SubsetVertexConf(from_idx=1, to_idx=2),
         tgc.SubsetVertexConf(from_idx=1, to_idx=2), (rnn,), (trnn,)),
        (jgc.LastTimeStepVertexConf(), tgc.LastTimeStepVertexConf(), (rnn,),
         (trnn,)),
        (jgc.DuplicateToTimeSeriesVertexConf(),
         tgc.DuplicateToTimeSeriesVertexConf(), (ff,), (tff,)),
        (jgc.ScaleVertexConf(), tgc.ScaleVertexConf(), (rnn,), (trnn,)),
        (jgc.PreprocessorVertexConf(preprocessor=jpp.CnnToRnnPreProcessor()),
         tgc.PreprocessorVertexConf(preprocessor=tpp.CnnToRnnPreProcessor()),
         (cnn,), (tcnn,)),
    ]
    for jv, tv, jt, tt in cases:
        assert (vars(tv.get_output_type(*tt))
                == vars(jv.get_output_type(*jt))), type(tv).__name__


# (name, JAX preprocessor, port preprocessor, input shape)
PREPROCESSORS = [
    ("cnn-to-rnn", jpp.CnnToRnnPreProcessor(), tpp.CnnToRnnPreProcessor(),
     (B, 2, 3, 4)),
    ("rnn-to-cnn", jpp.RnnToCnnPreProcessor(height=2, width=3, channels=2),
     tpp.RnnToCnnPreProcessor(height=2, width=3, channels=2), (B, T, 12)),
    ("reshape", jpp.ReshapePreProcessor(shape=(2, 10)),
     tpp.ReshapePreProcessor(shape=(2, 10)), (B, T, F)),
    ("composable", jpp.ComposableInputPreProcessor(processors=[
        jpp.CnnToRnnPreProcessor(), jpp.RnnToFeedForwardPreProcessor()]),
     tpp.ComposableInputPreProcessor(processors=[
         tpp.CnnToRnnPreProcessor(), tpp.RnnToFeedForwardPreProcessor()]),
     (B, 2, 3, 4)),
    ("binomial", jpp.BinomialSamplingPreProcessor(),
     tpp.BinomialSamplingPreProcessor(), (B, T, F)),
]


@pytest.mark.parametrize("name,jp,tp,shape", PREPROCESSORS,
                         ids=[p[0] for p in PREPROCESSORS])
def test_preprocessor_forward_and_gradient_match_jax(name, jp, tp, shape):
    """The inference forward (`pre_process`) and its gradient; the
    output type where the preprocessor declares one."""
    x = _arr(3, shape)
    jy, vjp = jax.vjp(jp.pre_process, jnp.asarray(x))
    cot = _arr(4, jy.shape)
    t = torch.from_numpy(x).requires_grad_()
    ty = tp.pre_process(t)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    (tg,) = torch.autograd.grad(ty, [t], torch.from_numpy(cot))
    np.testing.assert_allclose(tg.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               atol=ATOL, rtol=0)
    it = jconf.InputType.convolutional(2, 3, 4)
    tit = tconf.InputType.convolutional(2, 3, 4)
    if name in ("cnn-to-rnn", "composable"):
        assert vars(tp.get_output_type(tit)) == vars(jp.get_output_type(it))


def test_binomial_sampling_draws_around_the_jax_value():
    """While training with a generator the binomial preprocessor draws
    Bernoulli(clip(x, 0, 1)): inputs of 0 and 1 (and beyond) give the
    JAX package's clip exactly; the mean over many draws of an interior
    value is within 5 standard errors of it; inference (and training
    without a generator) is the clip."""
    x = np.array([[-1.0, 0.0, 1.0, 2.0, 0.25, 0.5, 0.9]], np.float32)
    want = np.asarray(jpp.BinomialSamplingPreProcessor().pre_process(
        jnp.asarray(x)))
    tp = tpp.BinomialSamplingPreProcessor()
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tp.pre_process(t).numpy(), want)
    np.testing.assert_array_equal(tp.pre_process_train(t).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    n = 20000
    draws = tp.pre_process_train(t.expand(n, -1), gen).numpy()
    assert set(np.unique(draws)) <= {0.0, 1.0}
    np.testing.assert_array_equal(draws[:, :4], np.broadcast_to(want[:, :4],
                                                                (n, 4)))
    p = want[0, 4:]
    err = np.abs(draws[:, 4:].mean(0) - p)
    assert (err <= 5 * np.sqrt(p * (1 - p) / n)).all(), err


# --------------------------------------------------------------- a graph

V_IN, HID = 6, 8


def _graph_conf(c):
    """tokens' features [B, T, V_IN] -> dense -> (dense | scale) ->
    merge -> subset -> last time step (the input's mask) -> duplicate
    over the input's T -> dense -> last step -> softmax output; built
    with either package's conf module."""
    g = (c.NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
         .updater(c.Updater.SGD).graph_builder())
    g.add_inputs("in")
    g.add_layer("d1", c.DenseLayer(n_in=V_IN, n_out=HID, activation="tanh"),
                "in")
    g.add_layer("d2", c.DenseLayer(n_in=HID, n_out=HID, activation="relu"),
                "d1")
    g.add_vertex("scaled", c.ScaleVertexConf(scale=0.5), "d1")
    g.add_vertex("merge", c.MergeVertexConf(), "d2", "scaled")
    g.add_vertex("sub", c.SubsetVertexConf(from_idx=2, to_idx=11), "merge")
    g.add_vertex("last", c.LastTimeStepVertexConf(mask_input="in"), "sub")
    g.add_vertex("dup", c.DuplicateToTimeSeriesVertexConf(
        reference_input="in"), "last")
    g.add_layer("d3", c.DenseLayer(n_in=10, n_out=HID, activation="tanh"),
                "dup")
    g.add_vertex("last2", c.LastTimeStepVertexConf(), "d3")
    g.add_layer("out", c.OutputLayer(n_in=HID, n_out=3, activation="softmax",
                                     loss_function="mcxent"), "last2")
    g.set_outputs("out")
    return g.build()


def _graph_batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):
        x = rng.standard_normal((B, T, V_IN)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph) from the same params."""
    jnet = JGraph(_graph_conf(jconf)).init()
    tnet = TGraph(_graph_conf(tconf), device="cpu").init()
    tnet.params = {**{k: {} for k in tnet.params}, **params_from_jax(
        jax.tree.map(np.asarray, jnet.params), "cpu")}
    tnet.opt_state = tnet.tx.init(tnet.params)
    return jnet, tnet


def test_graph_json_round_trips_through_port_serde(graphs):
    """The JAX package's JSON of the graph (every vertex kind it uses, a
    PreprocessorVertex and Stack/Unstack included) loads in the port,
    and the port writes back what the JAX package wrote."""
    jnet, _ = graphs
    g = jnet.conf
    g.vertices["pre"] = jgc.PreprocessorVertexConf(
        preprocessor=jpp.ComposableInputPreProcessor(processors=[
            jpp.ReshapePreProcessor(shape=(T, V_IN)),
            jpp.BinomialSamplingPreProcessor()]))
    g.vertices["stack"] = jgc.StackVertexConf()
    g.vertices["unstack"] = jgc.UnstackVertexConf(from_idx=1, stack_size=2)
    try:
        text = g.to_json()
        port = torch_from_json(text)
        assert isinstance(port.vertices["unstack"], tgc.UnstackVertexConf)
        from deeplearning4j_tpu.nn.conf.serde import to_dict as jax_to_dict

        assert torch_to_dict(port) == jax_to_dict(g)
        assert torch_to_dict(torch_from_json(port.to_json())) == \
            jax_to_dict(g)
    finally:
        for k in ("pre", "stack", "unstack"):
            del g.vertices[k]


def test_graph_trains_like_jax(graphs):
    """Three SGD steps on masked batches: params and loss as the JAX
    package's; then `output` and `predict` on the trained nets."""
    jnet, tnet = graphs
    mask = _mask()
    for x, y in _graph_batches():
        jnet.fit(_jds(x, y, mask))
        tnet.fit(DataSet(x, y, features_mask=mask))
    ref = flatten(jax.tree.map(np.asarray, jnet.params))
    got = flatten(params_to_numpy(tnet.params))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    for key, want in ref.items():
        err = float(np.abs(got[key] - want).max())
        assert err <= TRAIN_TOL * scale, (key, err)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=TRAIN_TOL)
    x = _graph_batches()[0][0]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))


def _jds(x, y, mask):
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet

    return JDataSet(x, y, features_mask=mask)


def test_predict_of_several_outputs_matches_jax():
    """A graph of two output heads: `predict` gives one array a head,
    the argmax of each output, as the JAX package's does."""
    def conf(c):
        g = (c.NeuralNetConfiguration.builder().seed(5).graph_builder())
        g.add_inputs("in")
        g.add_layer("h", c.DenseLayer(n_in=4, n_out=6, activation="tanh"),
                    "in")
        g.add_layer("a", c.OutputLayer(n_in=6, n_out=3,
                                       activation="softmax"), "h")
        g.add_layer("b", c.OutputLayer(n_in=6, n_out=5,
                                       activation="softmax"), "h")
        g.set_outputs("a", "b")
        return g.build()

    jnet = JGraph(conf(jconf)).init()
    tnet = TGraph(conf(tconf), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    x = _arr(8, (7, 4))
    got, want = tnet.predict(x), jnet.predict(x)
    assert isinstance(got, list) and len(got) == 2
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


def test_set_inputs_replaces_the_inputs():
    g = tconf.NeuralNetConfiguration.builder().graph_builder()
    g.add_inputs("a", "b").set_inputs(["c"])
    g.add_layer("o", tconf.OutputLayer(n_in=2, n_out=2), "c")
    assert g.set_outputs("o").build().network_inputs == ["c"]


def test_unknown_vertex_still_raises():
    with pytest.raises(ValueError, match="unhandled vertex"):
        vertex_forward(tgc.GraphVertexConf(), [torch.ones(1)])
