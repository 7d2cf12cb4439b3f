"""The port's gradient checks (deeplearning4j_tpu_torch/gradientcheck/) over
the layer list of the JAX package's tests/test_gradientcheck.py: central
finite differences against autograd in float64 on the CPU, eps 1e-6,
maxRelError 1e-3 (the reference's tolerances), the same nets, inputs
and seeds, each held to the JAX test's verdict (pass). The JAX checks
themselves run in that file; `test_same_params_same_verdict` runs one
net through both packages' checks with the same params and holds the
analytic gradients to each other (1e-9).
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu_torch.gradientcheck import (
    check_gradients,
    check_gradients_graph,
)
from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import (
    AutoEncoder,
    BatchNormalization,
    ComputationGraphConfiguration,  # noqa: F401  (graph config built via builder)
    ConvolutionLayer,
    DenseLayer,
    EmbeddingLayer,
    GravesLSTM,
    GravesBidirectionalLSTM,
    GRU,
    InputType,
    LocalResponseNormalization,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertexConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as _Graph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as _Net

pytestmark = pytest.mark.port


def MultiLayerNetwork(conf):
    return _Net(conf, device="cpu")


def ComputationGraph(conf):
    return _Graph(conf, device="cpu")

EPS = 1e-6
MAX_REL = 1e-3


def _builder(l1=0.0, l2=0.0):
    b = (NeuralNetConfiguration.builder()
         .seed(12345)
         .dtype("float64")
         .param_dtype("float64")
         .learning_rate(1.0))
    if l1 or l2:
        b = b.l1(l1).l2(l2).regularization(True)
    return b


def _iris_like(rng, n=6, n_in=4, n_out=3):
    x = rng.standard_normal((n, n_in))
    y = np.eye(n_out)[rng.integers(0, n_out, n)]
    return DataSet(x, y)


# ---------------------------------------------------------------- MLP sweeps
@pytest.mark.parametrize("hidden_act", ["sigmoid", "tanh", "relu"])
@pytest.mark.parametrize("out_act,loss", [
    ("softmax", "mcxent"),
    ("identity", "mse"),
    ("tanh", "mse"),
])
def test_mlp_activation_loss_grid(rng, hidden_act, out_act, loss):
    """Reference GradientCheckTests.java: activation x loss grid on an
    Iris-sized MLP."""
    conf = (_builder().list()
            .layer(DenseLayer(n_in=4, n_out=5, activation=hidden_act))
            .layer(OutputLayer(n_in=5, n_out=3, activation=out_act,
                               loss_function=loss))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _iris_like(rng), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


def test_mlp_l1_l2(rng):
    """Regularization terms differentiate correctly (reference checks
    l1/l2 on every grid point)."""
    conf = (_builder(l1=0.01, l2=0.02).list()
            .layer(DenseLayer(n_in=4, n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _iris_like(rng), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


# --------------------------------------------------------------------- CNN
@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_cnn_conv_subsampling(rng, pooling):
    """Reference CNNGradientCheckTest: conv + pooling + dense head."""
    conf = (_builder().list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3), stride=(1, 1),
                                    activation="tanh"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type=pooling))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 2))
            .build())
    net = MultiLayerNetwork(conf).init()
    x = rng.standard_normal((4, 6, 6, 2))
    y = np.eye(3)[rng.integers(0, 3, 4)]
    assert check_gradients(net, DataSet(x, y), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


def test_batchnorm(rng):
    """Reference BNGradientCheckTest: BN gamma/beta + upstream weights."""
    conf = (_builder().list()
            .layer(DenseLayer(n_in=4, n_out=6, activation="identity"))
            .layer(BatchNormalization(n_in=6, n_out=6))
            .layer(OutputLayer(n_in=6, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _iris_like(rng, n=8), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


def test_lrn(rng):
    """LocalResponseNormalization backward (reference
    CNNGradientCheckTest#testCnnWithLRN)."""
    conf = (_builder().list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(2, 2), stride=(1, 1),
                                    activation="tanh"))
            .layer(LocalResponseNormalization())
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss_function="mcxent"))
            .set_input_type(InputType.convolutional(5, 5, 1))
            .build())
    net = MultiLayerNetwork(conf).init()
    x = rng.standard_normal((3, 5, 5, 1))
    y = np.eye(2)[rng.integers(0, 2, 3)]
    assert check_gradients(net, DataSet(x, y), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


# --------------------------------------------------------------- embedding
def test_embedding(rng):
    """Gather-based embedding lookup: grads are scatter-adds (reference
    GradientCheckTests#testEmbeddingLayerSimple)."""
    conf = (_builder().list()
            .layer(EmbeddingLayer(n_in=7, n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    x = rng.integers(0, 7, (6, 1)).astype(np.int32)
    y = np.eye(3)[rng.integers(0, 3, 6)]
    assert check_gradients(net, DataSet(x, y), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


def test_autoencoder_as_layer(rng):
    """AutoEncoder used inside a supervised stack (encode path)."""
    conf = (_builder().list()
            .layer(AutoEncoder(n_in=4, n_out=5, activation="sigmoid"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _iris_like(rng), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


# -------------------------------------------------------------------- RNNs
def _seq_data(rng, b=2, t=4, n_in=3, n_out=2, mask=False):
    x = rng.standard_normal((b, t, n_in))
    y = np.eye(n_out)[rng.integers(0, n_out, (b, t))]
    lm = None
    if mask:
        lm = np.ones((b, t))
        lm[0, t - 1] = 0  # variable-length: first sequence ends early
        lm[1, 0] = 0
    return DataSet(x, y, labels_mask=lm)


@pytest.mark.parametrize("layer_cls", [GravesLSTM, GravesBidirectionalLSTM, GRU])
def test_recurrent_layers(rng, layer_cls):
    """Scan-based LSTM/BiLSTM/GRU backward through time (reference
    GradientCheckTests#testGradientLSTMFull etc.)."""
    conf = (_builder().list()
            .layer(layer_cls(n_in=3, n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _seq_data(rng), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True,
                           subset=120)


def test_rnn_label_masking(rng):
    """Masked timesteps contribute zero gradient (reference
    GradientCheckTestsMasking)."""
    conf = (_builder().list()
            .layer(GravesLSTM(n_in=3, n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _seq_data(rng, mask=True), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True,
                           subset=120)


# --------------------------------------------------------------- DAG graph
def test_computation_graph_vertices(rng):
    """Merge + elementwise-add DAG (reference
    GradientCheckTestsComputationGraph#testBasicIrisWithMerging &
    #testBasicIrisWithElementWiseNode)."""
    g = (_builder()
         .graph_builder()
         .add_inputs("in")
         .add_layer("d1", DenseLayer(n_in=4, n_out=5, activation="tanh"), "in")
         .add_layer("d2", DenseLayer(n_in=4, n_out=5, activation="sigmoid"), "in")
         .add_vertex("add", ElementWiseVertexConf(op="add"), "d1", "d2")
         .add_layer("out", OutputLayer(n_in=5, n_out=3, activation="softmax",
                                       loss_function="mcxent"), "add")
         .set_outputs("out")
         .build())
    net = ComputationGraph(g).init()
    ds = _iris_like(rng)
    assert check_gradients_graph(net, MultiDataSet([ds.features], [ds.labels]),
                                 epsilon=EPS, max_rel_error=MAX_REL,
                                 print_results=True)


def test_moe_layer_gradients(rng):
    """Mixture-of-Experts: top-k gated expert FFNs (the gate top_k mask is
    piecewise-constant, so finite differences remain valid away from
    routing boundaries — tanh-bounded inputs keep logits well-separated).
    FD runs against the smooth dense oracle; the routed path's analytic
    gradients are checked against the dense path's in test_pipeline_moe."""
    from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExpertsLayer

    conf = (_builder().list()
            .layer(MixtureOfExpertsLayer(n_in=4, n_out=5, n_experts=3,
                                         top_k=2, d_hidden=6,
                                         activation="tanh", routing="dense"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert check_gradients(net, _iris_like(rng), epsilon=EPS,
                           max_rel_error=MAX_REL, print_results=True)


def test_same_params_same_verdict(rng):
    """The port's GravesLSTM net and the JAX package's, the same f64
    params (copied from the port's) and data: both checks pass, and the
    analytic gradients they check agree to 1e-9."""
    import jax.numpy as jnp
    import torch

    from deeplearning4j_tpu.gradientcheck import check_gradients as jcheck
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.training import loss_and_grads
    from deeplearning4j_tpu_torch.weights_io import params_to_numpy

    def conf(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(12345)
                .dtype("float64").param_dtype("float64").learning_rate(1.0)
                .list()
                .layer(pkg.GravesLSTM(n_in=3, n_out=4, activation="tanh"))
                .layer(pkg.RnnOutputLayer(n_in=4, n_out=2,
                                          activation="softmax",
                                          loss_function="mcxent"))
                .build())

    ds = _seq_data(rng)
    tnet = MultiLayerNetwork(conf(tconf)).init()
    jax.config.update("jax_enable_x64", True)
    try:
        jnet = JNet(conf(jconf)).init()
        jnet.params = jax.tree.map(jnp.asarray, params_to_numpy(tnet.params))
        jds = JDataSet(ds.features, ds.labels)
        assert jcheck(jnet, jds, epsilon=EPS, max_rel_error=MAX_REL,
                      subset=60)
        jb = jnet._batch_dict(jds)
        jg = jax.grad(lambda p: jnet._loss(p, jnet.state, None, jb)[0])(
            jnet.params)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert check_gradients(tnet, ds, epsilon=EPS, max_rel_error=MAX_REL,
                           subset=60)
    _, _, tg = loss_and_grads(tnet._loss, tnet.params, tnet.state, None,
                              tnet._batch_dict(ds))
    for layer in jg:
        for name in jg[layer]:
            np.testing.assert_allclose(tg[layer][name].numpy(),
                                       np.asarray(jg[layer][name]),
                                       atol=1e-9, err_msg=f"{layer}.{name}")
    assert tg["layer_0"]["W"].dtype == torch.float64
