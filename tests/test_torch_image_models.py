"""The image-model slice of the port (convolution, pooling, batch norm,
LRN, the CNN preprocessors, MultiLayerNetwork, LeNet-5, VGG-16 and
ResNet-20, the MNIST and CIFAR-10 iterators) against the JAX package on
the CPU.

Both packages get the same numpy inputs, made from a seed, and the same
params and batch-norm state (copied with `weights_io.params_from_jax` /
`state_from_jax`). The layers are NHWC with HWIO weights in both, so
every array compares as it is.

Tolerances, each relative to the largest entry of the reference array:
- f32 forward and gradients of one layer: 1e-5 (sums taken in another
  order: cuDNN-free CPU convolutions, PyTorch's and XLA's reductions);
- f32 networks: forward and loss 1e-4 and 1e-5; after Adam steps, each
  layer's params to 1e-4 of the largest entry of that layer's params
  (a bias or beta that starts at 0 has moved by about lr a step, and
  its gradient, a sum that the batch norm after it nearly cancels, is
  good to about 1e-4 of itself in f32, so its own largest entry is no
  scale for it), except a param whose JAX gradient is zero to rounding
  at a step (|g| <= 1e-4 of the largest |g| of its layer; a convolution's
  bias before a batch norm, whose gradient the normalization cancels:
  in ResNet-20 these read 1.7e-7 to 1.3e-5 of their layer's largest,
  every other bias 0.3 or more):
  Adam moves such a weight by up to lr a step whatever the size of its
  gradient, so there the two packages' rounding steers it differently,
  and those entries are held to 2 · lr · steps, the most two such moves
  can differ; the batch-norm state to 1e-4 of each array's largest
  entry, the running mean also to (1 − decay) · 2 · lr · steps more,
  what such a bias of the convolution before it moves it by;
- bf16 batch norm: 2e-2 for y and dx (one bf16 rounding can flip);
  6e-2 for dgamma and dbeta, sums over the batch of 120 bf16 products
  that XLA adds in bf16 and PyTorch in f32 (about sqrt(120) roundings of
  2^-9 apart); its running statistics, taken in f32 from the same bf16
  input: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import cifar as jcifar
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.lenet import lenet5 as jax_lenet5
from deeplearning4j_tpu.models.resnet import resnet20 as jax_resnet20
from deeplearning4j_tpu.models.vgg import vgg16 as jax_vgg16
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import get_impl as jax_impl
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets import cifar as tcifar
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.models import lenet5, resnet20, vgg16
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.layers import get_impl as torch_impl
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.weights_io import (
    params_from_jax,
    params_to_numpy,
    state_from_jax,
    state_to_numpy,
)

pytestmark = pytest.mark.port

LAYER_TOL = 1e-5
NET_TOL = 1e-4
BF16_TOL = 2e-2
BF16_SUM_TOL = 6e-2
ZERO_GRAD_RTOL = 1e-4
ADAM_LR = 1e-3
# the JAX package's LeNet-5 on the synthetic MNIST at the steps of
# `test_lenet5_learns_synthetic_mnist` (batch 64, 16 steps of fit_scanned
# and 16 of fit, f32, CPU) reaches LENET_JAX_ACC on the first 2048 of the
# synthetic test split (from its own random init: the two packages draw
# different weights); the port must clear LENET_MIN_ACC there
LENET_JAX_ACC = 1.0
LENET_MIN_ACC = 0.98


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max rel err {err:.3e} > {tol}"


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- layers

def _layer_pair(name, **kw):
    """The same layer config in both packages, resolved as a builder
    would (activation identity unless given)."""
    kw.setdefault("activation", "identity")
    return getattr(jconf, name)(**kw), getattr(tconf, name)(**kw)


def _run_layer(jc, tc, x, params=None, state=None, train=False, cot=None,
               dtype="float32"):
    """(JAX y, port y, JAX grads, port grads, JAX state, port state) of
    one layer on numpy x with numpy params/state; the grads are of
    sum(y * cot) with respect to x and each param."""
    params = params or {}
    state = state or {}
    jimpl, timpl = jax_impl(jc), torch_impl(tc)
    jx = jnp.asarray(x, dtype)
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}

    def jf(x_, p_):
        return jimpl.apply(jc, p_, js, x_, train=train, rng=None)

    jy, jstate = jf(jx, jp)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.asarray(x)).to(tdt).requires_grad_()
    tp = {k: torch.from_numpy(np.asarray(v)).to(tdt).requires_grad_()
          for k, v in params.items()}
    ts = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    ty, tstate = timpl.apply(tc, tp, ts, tx, train=train)
    out = dict(jy=np.asarray(jy, np.float32), ty=_np(ty), jstate=jstate,
               tstate=tstate)
    if cot is not None:
        _, vjp = jax.vjp(lambda x_, p_: jf(x_, p_)[0], jx, jp)
        jgx, jgp = vjp(jnp.asarray(cot, dtype))
        tg = torch.autograd.grad(ty, [tx, *tp.values()],
                                 torch.from_numpy(cot).to(tdt))
        out["jgrads"] = [np.asarray(jgx, np.float32)] + [
            np.asarray(jgp[k], np.float32) for k in tp]
        out["tgrads"] = [_np(g) for g in tg]
    return out


def _check(out, tol=LAYER_TOL, what=""):
    _close(out["ty"], out["jy"], tol, f"{what} y")
    for i, (g, w) in enumerate(zip(out.get("tgrads", ()),
                                   out.get("jgrads", ()))):
        _close(g, w, tol, f"{what} grad {i}")


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 3), convolution_mode="valid"),
    dict(kernel_size=(3, 3), convolution_mode="same"),
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(1, 1), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(4, 4), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(3, 2), stride=(1, 2), padding=(2, 1)),
    dict(kernel_size=(3, 3), dilation=(2, 2), convolution_mode="same"),
    dict(kernel_size=(3, 3), dilation=(2, 1), convolution_mode="valid"),
], ids=["valid", "same", "same-s2", "same-1x1-s2", "same-4x4-s2",
        "explicit-pad", "same-dilated", "valid-dilated"])
def test_convolution_matches_jax(kw):
    """Forward and gradients (x, W, b) of the convolution, SAME padding
    at stride 2 included: XLA pads (0, 1) for a 3x3 window on 10 and 9
    rows, which PyTorch's symmetric padding cannot express."""
    rng = np.random.default_rng(1)
    jc, tc = _layer_pair("ConvolutionLayer", n_in=3, n_out=5, **kw)
    kh, kw_ = kw["kernel_size"]
    x = rng.standard_normal((2, 10, 9, 3)).astype(np.float32)
    p = {"W": rng.standard_normal((kh, kw_, 3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    out = _run_layer(jc, tc, x, p)
    cot = rng.standard_normal(out["jy"].shape).astype(np.float32)
    out = _run_layer(jc, tc, x, p, cot=cot)
    assert out["ty"].shape == tuple(
        [2, *tconf.layers._conv_out_hw(10, 9, kw["kernel_size"],
                                       kw.get("stride", (1, 1)),
                                       kw.get("padding", (0, 0)),
                                       kw.get("convolution_mode", "strict"),
                                       kw.get("dilation", (1, 1))), 5])
    _check(out, what=str(kw))


def test_convolution_relu_activation_matches_jax():
    rng = np.random.default_rng(2)
    jc, tc = _layer_pair("ConvolutionLayer", n_in=2, n_out=4,
                         kernel_size=(5, 5), activation="relu")
    x = rng.standard_normal((3, 12, 12, 2)).astype(np.float32)
    p = {"W": rng.standard_normal((5, 5, 2, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    cot = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    _check(_run_layer(jc, tc, x, p, cot=cot))


@pytest.mark.parametrize("pooling,kw", [
    ("max", dict(kernel_size=(2, 2), stride=(2, 2))),
    ("max", dict(kernel_size=(3, 3), stride=(2, 2))),
    ("max", dict(kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="same")),
    ("max", dict(kernel_size=(2, 2), stride=(1, 1), padding=(1, 1))),
    ("avg", dict(kernel_size=(2, 2), stride=(2, 2))),
    ("avg", dict(kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="same")),
    ("avg", dict(kernel_size=(3, 3), stride=(1, 1), padding=(1, 1))),
    ("sum", dict(kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="same")),
    ("pnorm", dict(kernel_size=(2, 2), stride=(2, 2), pnorm=3)),
    ("none", dict(kernel_size=(2, 2), stride=(2, 2))),
], ids=["max-tiled", "max-overlap", "max-same", "max-padded", "avg-tiled",
        "avg-same", "avg-padded", "sum-same", "pnorm", "none"])
def test_pooling_matches_jax(pooling, kw):
    """Every pooling type, forward and gradient. Average pooling divides
    by the unpadded elements of a window, as the reference does."""
    rng = np.random.default_rng(3)
    jc, tc = _layer_pair("SubsamplingLayer", pooling_type=pooling, **kw)
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    if pooling == "pnorm":
        x = np.abs(x) + 0.1
    y = _run_layer(jc, tc, x)["jy"]
    cot = rng.standard_normal(y.shape).astype(np.float32)
    _check(_run_layer(jc, tc, x, cot=cot), what=pooling)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_max_pool_splits_the_gradient_over_ties(dtype):
    """The tiled max pool's custom VJP: x of small integers (many windows
    with tied maxima) gets dy / ties at every tied maximum, as the JAX
    package's equality mask gives it, where F.max_pool2d's own backward
    would credit one of them."""
    rng = np.random.default_rng(4)
    jc, tc = _layer_pair("SubsamplingLayer", kernel_size=(2, 2),
                         stride=(2, 2))
    x = rng.integers(0, 3, (2, 6, 8, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    out = _run_layer(jc, tc, x, cot=cot, dtype=dtype)
    np.testing.assert_array_equal(out["ty"], out["jy"])
    np.testing.assert_array_equal(out["tgrads"][0], out["jgrads"][0])
    x6 = x.reshape(2, 3, 2, 4, 2, 3)
    ties = (x6 == x6.max(axis=(2, 4), keepdims=True)).sum(axis=(2, 4))
    assert (ties > 1).mean() > 0.2  # the input really has ties


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (8, 7)],
                         ids=["nhwc", "dense"])
def test_batch_norm_matches_jax(shape, train, dtype):
    """Batch norm in train and eval mode, f32 and bf16 (whose statistics
    are one-pass sums in f32), per channel of NHWC input and per feature
    of 2-D input: y, gradients through the batch mean and variance, and
    the new running state decay·old + (1 − decay)·batch with the biased
    variance."""
    rng = np.random.default_rng(5)
    C = shape[-1]
    jc, tc = _layer_pair("BatchNormalization", n_in=C, n_out=C, decay=0.8,
                         activation="relu")
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    p = {"gamma": (1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
         "beta": (0.2 * rng.standard_normal(C)).astype(np.float32)}
    s = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
         "var": (1 + 0.5 * rng.random(C)).astype(np.float32),
         "count": np.asarray(3.0, np.float32)}
    cot = rng.standard_normal(shape).astype(np.float32)
    out = _run_layer(jc, tc, x, p, s, train=train, cot=cot, dtype=dtype)
    if dtype == "float32":
        _check(out, LAYER_TOL, "bn")
    else:
        _close(out["ty"], out["jy"], BF16_TOL, "bn y")
        _close(out["tgrads"][0], out["jgrads"][0], BF16_TOL, "bn dx")
        for g, w in zip(out["tgrads"][1:], out["jgrads"][1:]):
            _close(g, w, BF16_SUM_TOL, "bn dgamma/dbeta")
    for k in ("mean", "var", "count"):
        _close(_np(out["tstate"][k]), np.asarray(out["jstate"][k]),
               LAYER_TOL, f"state {k}")
        assert out["tstate"][k].dtype == torch.float32
        assert not out["tstate"][k].requires_grad
    if train:
        assert float(out["tstate"]["count"]) == 4.0


def test_batch_norm_locked_gamma_beta_and_init_match_jax():
    """init: gamma/beta filled from the config (absent when locked); f32
    state of zeros, ones and a zero count."""
    jc, tc = _layer_pair("BatchNormalization", n_in=6, n_out=6, gamma=0.5,
                         beta=0.25)
    jp, js = jax_impl(jc).init(jc, jax.random.PRNGKey(0), jnp.float32)
    tp, ts = torch_impl(tc).init(tc, torch.Generator(), torch.float32)
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
    for k in js:
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]))
    jc.lock_gamma_beta = tc.lock_gamma_beta = True
    assert torch_impl(tc).init(tc, torch.Generator(), torch.float32)[0] == {}


@pytest.mark.parametrize("n", [5.0, 4.0, 3.0])
def test_lrn_matches_jax(n):
    """Cross-channel LRN with the window padded (n // 2, n − 1 − n // 2)."""
    rng = np.random.default_rng(6)
    jc, tc = _layer_pair("LocalResponseNormalization", n=n, k=2.0,
                         alpha=1e-2, beta=0.75)
    x = rng.standard_normal((2, 4, 5, 7)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    _check(_run_layer(jc, tc, x, cot=cot), what="lrn")


@pytest.mark.parametrize("kind", ["ActivationLayer", "DropoutLayer"])
def test_activation_and_dropout_layers_match_jax(kind):
    """Outside training, dropout is the identity in both packages."""
    rng = np.random.default_rng(7)
    kw = dict(activation="tanh") if kind == "ActivationLayer" else dict(
        dropout=0.5)
    jc, tc = getattr(jconf, kind)(**kw), getattr(tconf, kind)(**kw)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    _check(_run_layer(jc, tc, x, cot=cot), what=kind)


def test_dropout_layer_drops_from_the_generator_in_training():
    tc = tconf.DropoutLayer(dropout=0.5)
    x = torch.ones(64, 64)
    gen = torch.Generator().manual_seed(0)
    y, _ = torch_impl(tc).apply(tc, {}, {}, x, train=True, generator=gen)
    kept = y != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))


@pytest.mark.parametrize("proc", ["CnnToFeedForwardPreProcessor",
                                  "FeedForwardToCnnPreProcessor"])
def test_cnn_preprocessors_match_jax(proc):
    """The CNN adapters flatten and unflatten in NHWC order, so the rows
    of the next dense W line up with the JAX package's."""
    rng = np.random.default_rng(8)
    kw = dict(height=3, width=4, channels=5)
    jp, tp = getattr(jconf.preprocessors, proc)(**kw), getattr(
        tconf.preprocessors, proc)(**kw)
    shape = (2, 60) if proc.startswith("FeedForward") else (2, 3, 4, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(tp.pre_process(torch.from_numpy(x)).numpy(),
                                  np.asarray(jp.pre_process(jnp.asarray(x))))
    assert tconf.serde.to_dict(tp.get_output_type(
        tconf.InputType.convolutional(3, 4, 5))) == jconf.serde.to_dict(
            jp.get_output_type(jconf.InputType.convolutional(3, 4, 5)))


# ----------------------------------------------------------- containers

def _copy_params(jnet, tnet):
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.state = state_from_jax(jax.tree.map(np.asarray, jnet.state), "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    return tnet


def _zero_grads(jnet, jds, graph):
    """{layer: {name: bool}}: where the JAX gradient of this batch's
    loss at the current params is zero to rounding (against the largest
    gradient entry of the layer)."""
    if graph:
        batch = jnet._batch_dict(jnet._to_mds(jds))
    else:
        batch = jnet._batch_dict(jds)
    grads = jax.grad(lambda p: jnet._loss(p, jnet.state, None, batch)[0])(
        jnet.params)
    out = {}
    for layer, leaves in grads.items():
        leaves = {k: np.abs(np.asarray(g)) for k, g in leaves.items()}
        top = max((float(g.max()) for g in leaves.values()), default=0.0)
        out[layer] = {k: g <= ZERO_GRAD_RTOL * top
                      for k, g in leaves.items()}
    return out


def _train_both(jnet, tnet, batches, graph=False):
    """One fit() call per (x, y) batch in both; returns the per-step
    losses and where the JAX gradient was zero to rounding at any
    step."""
    jl, tl, zero = [], [], None
    for x, y in batches:
        jds = JDataSet(x, y)
        z = _zero_grads(jnet, jds, graph)
        zero = z if zero is None else jax.tree.map(np.logical_or, zero, z)
        jnet.fit(jds)
        tnet.fit(TDataSet(x, y))
        jl.append(jnet.score_value)
        tl.append(tnet.score_value)
    return np.array(jl), np.array(tl), zero


def _assert_nets_close(jnet, tnet, zero, steps):
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    assert jp.keys() == tp.keys()
    for layer in jp:
        assert jp[layer].keys() == tp[layer].keys(), layer
        scale = max((float(np.abs(a).max()) for a in jp[layer].values()),
                    default=0.0)
        for name in jp[layer]:
            want, got = jp[layer][name], tp[layer][name]
            z = zero[layer][name]
            diff = np.abs(got - want)
            assert float(diff[~z].max(initial=0.0)) <= NET_TOL * scale, (
                layer, name, float(diff[~z].max(initial=0.0)), scale)
            assert float(diff[z].max(initial=0.0)) <= 2 * steps * ADAM_LR, (
                layer, name)
    js = jax.tree.map(np.asarray, jnet.state)
    ts = state_to_numpy(tnet.state)
    assert js.keys() == ts.keys()
    for layer in js:
        for name in js[layer]:
            want, got = js[layer][name], ts[layer][name]
            tol = NET_TOL * float(np.abs(want).max())
            if name == "mean":
                tol += (1 - 0.9) * 2 * ADAM_LR * steps
            assert float(np.abs(got - want).max()) <= tol, (layer, name)


def _images(seed, B, hw, c, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.random((B, hw, hw, c), dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]
    return x, y


@pytest.fixture(scope="module")
def lenet_pair():
    jnet = jax_lenet5().init()
    tnet = _copy_params(jnet, lenet5(device="cpu").init())
    return jnet, tnet


def test_lenet5_builds_as_the_jax_package_does(lenet_pair):
    """The same layer names, param shapes, preprocessors (a CNN-to-dense
    adapter before layer 4) and inferred n_in; the entry point takes
    `device`."""
    jnet, tnet = lenet_pair
    assert tnet.device == torch.device("cpu")
    assert tnet.layer_names == jnet.layer_names
    assert tconf.serde.to_dict(tnet.conf) == jconf.serde.to_dict(jnet.conf)
    assert tnet.num_params() == jnet.num_params() == 431080
    assert isinstance(tnet.conf.get_preprocessor(4),
                      tconf.CnnToFeedForwardPreProcessor)


def test_lenet5_forward_loss_and_inference_api_match_jax(lenet_pair):
    jnet, tnet = lenet_pair
    x, y = _images(10, 6, 28, 1)
    _close(_np(tnet.output(x)), np.asarray(jnet.output(x)), NET_TOL,
           "output")
    for ta, ja in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        _close(_np(ta), np.asarray(ja), NET_TOL, "feed_forward")
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    _close(tnet.score(TDataSet(x, y)), jnet.score(JDataSet(x, y)), 1e-5,
           "score")
    _close(tnet.score_examples(TDataSet(x, y)),
           jnet.score_examples(JDataSet(x, y)), 1e-5, "score_examples")
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    ev_t = tnet.evaluate(TDataSet(x, y))
    ev_j = jnet.evaluate(JDataSet(x, y))
    np.testing.assert_array_equal(ev_t.confusion.matrix,
                                  ev_j.confusion.matrix)


def test_lenet5_three_adam_steps_match_jax():
    """Loss at each of 3 fit() steps and the params after them."""
    jnet = jax_lenet5().init()
    tnet = _copy_params(jnet, lenet5(device="cpu").init())
    batches = [_images(20 + i, 16, 28, 1) for i in range(3)]
    jl, tl, zero = _train_both(jnet, tnet, batches)
    _close(tl, jl, 1e-5, "losses")
    _assert_nets_close(jnet, tnet, zero, 3)


def test_fit_scanned_equals_fit_and_updates_counters():
    """fit_scanned (nn/training.fused_fit) runs the same steps as fit on
    uniform batches: the same params bit for bit, and the iteration and
    epoch counters."""
    a, b = (lenet5(device="cpu").init() for _ in range(2))
    data = [TDataSet(*_images(30 + i, 8, 28, 1)) for i in range(3)]
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    a.fit(ListDataSetIterator(data), epochs=2)
    b.fit_scanned(ListDataSetIterator(data), epochs=2)
    assert a.iteration_count == b.iteration_count == 6
    assert a.epoch_count == b.epoch_count == 2
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert a.score_value == b.score_value


def test_multilayer_params_plumbing_and_clone():
    net = lenet5(device="cpu").init()
    flat = net.params_flat()
    assert flat.shape == (net.num_params(),)
    net.set_params_flat(flat * 0.5)
    np.testing.assert_allclose(net.params_flat(), flat * 0.5)
    twin = net.clone()
    np.testing.assert_array_equal(twin.params_flat(), net.params_flat())
    x, y = _images(40, 4, 28, 1)
    net.fit(x, y)
    assert not np.array_equal(twin.params_flat(), net.params_flat())


def test_multilayer_raises_for_what_the_slice_does_not_carry(tmp_path):
    """Meshes still cite A7, and `resume_from` of a directory with no
    checkpoint is a cold start while a missing named step raises. What
    once cited A6 now runs on LeNet-5: `pretrain` is a no-op without a
    pretrain layer, `rnn_time_step` of a net with no recurrent layer is
    its forward, the Solver path (L-BFGS) lowers the score, remat
    trains, and fit_scanned refuses TBPTT with the JAX package's
    ValueError."""
    x, y = _images(41, 2, 28, 1)
    net = lenet5(device="cpu").init()
    with pytest.raises(NotImplementedError, match="A7"):
        net.set_mesh(None)
    assert net.resume_from(str(tmp_path)) == 0
    with pytest.raises(FileNotFoundError):
        net.resume_from(str(tmp_path), step=3)
    before = net.params_flat()
    assert net.pretrain(TDataSet(x, y)) is net
    np.testing.assert_array_equal(net.params_flat(), before)
    torch.testing.assert_close(net.rnn_time_step(x), net.output(x),
                               rtol=0, atol=0)
    ds = TDataSet(x, y)
    net = lenet5(device="cpu")
    net.conf.conf.optimization_algo = "lbfgs"
    net.init()
    s0 = net.score(ds)
    net.fit(ds)
    assert net.score(ds) < s0
    net = lenet5(device="cpu")
    net.conf.conf.remat = True
    net.fit(x, y)
    assert np.isfinite(net.score_value)
    net = lenet5(device="cpu")
    net.conf.backprop_type = "truncated_bptt"
    with pytest.raises(ValueError, match="TBPTT"):
        net.fit_scanned(x, y)


def test_lenet5_learns_synthetic_mnist():
    """LeNet-5 on the synthetic MNIST (batch 64, 16 steps of fit_scanned,
    then 16 of fit, f32): the loss falls and the accuracy on the
    synthetic test split clears LENET_MIN_ACC, set below the JAX
    package's LENET_JAX_ACC at the same steps."""
    train = tmnist.MnistDataSetIterator(64, num_examples=1024,
                                        reshape_images=True)
    test = tmnist.MnistDataSetIterator(512, num_examples=2048, train=False,
                                       reshape_images=True)
    assert train.synthetic and test.synthetic
    net = lenet5(device="cpu").init()
    net.fit_scanned(train)
    first = float(net._step_losses[0, 0])
    net.fit(train)
    assert net.score_value < first
    assert net.evaluate(test).accuracy() >= LENET_MIN_ACC


def _train_mode_outputs(jnet, tnet, x):
    """(port, JAX) graph outputs for x in train mode (batch statistics),
    without updating either net."""
    ty = tnet._forward(tnet.params, tnet.state, {"input": x}, train=True)
    jy, _, _ = jnet._forward(jnet.params, jnet.state, {"input": x},
                             train=True, rng=None)
    return _np(ty[0]), np.asarray(jy[0])


def _graph_pair(builder):
    jnet = builder(jconf, JGraph).init()
    tnet = _copy_params(jnet, builder(tconf, TGraph).init())
    return jnet, tnet


def _narrow_vgg(conf, Graph):
    """A VGG-style graph at narrow widths, built with vgg16's builder
    calls: SAME 3x3 convolutions with batch norm, tiled max pools, a
    dense layer after a pool (a CNN-to-dense adapter), a softmax output."""
    g = (conf.NeuralNetConfiguration.builder().seed(7).learning_rate(ADAM_LR)
         .updater(conf.Updater.ADAM).weight_init("relu").graph_builder()
         .add_inputs("input"))
    prev = "input"
    for i, v in enumerate([8, 8, "M", 16, "M"]):
        if v == "M":
            name = f"pool{i}"
            g.add_layer(name, conf.SubsamplingLayer(kernel_size=(2, 2),
                                                    stride=(2, 2)), prev)
        else:
            name = f"conv{i}"
            g.add_layer(name, conf.ConvolutionLayer(
                n_out=v, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), prev)
            g.add_layer(f"bn{i}", conf.BatchNormalization(), name)
            name = f"bn{i}"
        prev = name
    g.add_layer("fc1", conf.DenseLayer(n_out=32, activation="relu"), prev)
    g.add_layer("out", conf.OutputLayer(n_out=10, activation="softmax",
                                        loss_function="mcxent"), "fc1")
    g.set_outputs("out")
    g.set_input_types(input=conf.InputType.convolutional(12, 12, 3))
    kw = {} if Graph is JGraph else {"device": "cpu"}
    return Graph(g.build(), **kw)


def test_narrow_vgg_graph_matches_jax():
    """Forward (eval mode), then 2 Adam steps: losses, params and the
    batch-norm running state; then the train-mode forward (batch
    statistics: the inference forward carries the noise-steered
    convolution biases into the output) and `evaluate` on the trained
    nets."""
    jnet, tnet = _graph_pair(_narrow_vgg)
    assert isinstance(tnet.conf.vertices["fc1"].preprocessor,
                      tconf.CnnToFeedForwardPreProcessor)
    x, y = _images(50, 6, 12, 3)
    _close(_np(tnet.output(x)), np.asarray(jnet.output(x)), NET_TOL,
           "output")
    batches = [_images(51 + i, 8, 12, 3) for i in range(2)]
    jl, tl, zero = _train_both(jnet, tnet, batches, graph=True)
    _close(tl, jl, 1e-5, "losses")
    _assert_nets_close(jnet, tnet, zero, 2)
    _close(*_train_mode_outputs(jnet, tnet, x), NET_TOL,
           "train-mode output after training")
    np.testing.assert_array_equal(
        tnet.evaluate(TDataSet(x, y)).confusion.matrix,
        jnet.evaluate(JDataSet(x, y)).confusion.matrix)


def test_resnet20_matches_jax():
    """ResNet-20 at batch 2: forward (eval mode; SAME 3x3 stride-2
    convolutions pad (0, 1) at the stage boundaries), 2 Adam steps
    (losses, params, the batch-norm state), and the train-mode forward
    after."""
    jnet = jax_resnet20().init()
    tnet = _copy_params(jnet, resnet20(device="cpu").init())
    x, _ = _images(60, 2, 32, 3)
    _close(_np(tnet.output(x)), np.asarray(jnet.output(x)), NET_TOL,
           "output")
    batches = [_images(61 + i, 2, 32, 3) for i in range(2)]
    jl, tl, zero = _train_both(jnet, tnet, batches, graph=True)
    _close(tl, jl, 1e-5, "losses")
    _assert_nets_close(jnet, tnet, zero, 2)
    _close(*_train_mode_outputs(jnet, tnet, x), NET_TOL,
           "train-mode output after training")


def test_vgg16_and_resnet20_build_as_the_jax_package_does():
    """Full-width configs: the same vertices, param shapes and inferred
    adapters as the JAX package's, without running them."""
    for tb, jb in ((vgg16, jax_vgg16), (resnet20, jax_resnet20)):
        tnet, jnet = tb(device="cpu"), jb()
        assert tconf.serde.to_dict(tnet.conf) == jconf.serde.to_dict(
            jnet.conf)
    assert vgg16(device="cpu").init().params["conv0"]["W"].shape == (
        3, 3, 3, 64)


def test_vgg16_forward_matches_jax():
    """The full-size VGG-16 forward (eval mode) at batch 2."""
    jnet = jax_vgg16().init()
    tnet = _copy_params(jnet, vgg16(device="cpu").init())
    x, _ = _images(70, 2, 32, 3)
    _close(_np(tnet.output(x)), np.asarray(jnet.output(x)), NET_TOL,
           "output")


# ---------------------------------------------------------- configs, data

def test_multilayer_configuration_json_round_trips_across_packages():
    """The port's MultiLayerConfiguration round-trips through JSON, and
    the JAX package's JSON loads in the port as the same config."""
    tc = lenet5(device="cpu").conf
    back = tconf.MultiLayerConfiguration.from_json(tc.to_json())
    assert tconf.serde.to_dict(back) == tconf.serde.to_dict(tc)
    jc = jax_lenet5().conf
    cross = tconf.MultiLayerConfiguration.from_json(jc.to_json())
    assert isinstance(cross, tconf.MultiLayerConfiguration)
    assert tconf.serde.to_dict(cross) == jconf.serde.to_dict(jc)
    assert isinstance(cross.layers[0], tconf.ConvolutionLayer)
    assert MultiLayerNetwork(cross, device="cpu").init().num_params() == \
        431080


def test_list_builder_validates_as_the_jax_package_does():
    b = tconf.NeuralNetConfiguration.builder().list()
    b.layer(1, tconf.OutputLayer(n_in=4, n_out=2))
    with pytest.raises(ValueError, match="gaps"):
        b.build()
    with pytest.raises(ValueError, match="layer 0"):
        (tconf.NeuralNetConfiguration.builder().list()
         .layer(tconf.DenseLayer(n_in=3, n_out=3, activation="relux"))
         .build())
    with pytest.raises(ValueError, match="Cannot infer CNN shape"):
        (tconf.NeuralNetConfiguration.builder().list()
         .layer(tconf.ConvolutionLayer(n_out=3))
         .set_input_type(tconf.InputType.feed_forward(9)).build())


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_synthetic_mnist_equals_jax_bit_for_bit(train):
    ti, tl = tmnist._synthetic_mnist(300, 123, train)
    ji, jl = jmnist._synthetic_mnist(300, 123, train)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    t = tmnist.MnistDataSetIterator(50, num_examples=200, train=train,
                                    shuffle=True, reshape_images=True,
                                    data_dir="/nonexistent")
    assert t.synthetic
    ds = t.next()
    assert ds.features.shape == (50, 28, 28, 1)
    assert ds.labels.shape == (50, 10)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_synthetic_cifar_equals_jax_bit_for_bit(train):
    tx, ty = tcifar._synthetic_cifar(200, 5, train)
    jx, jy = jcifar._synthetic_cifar(200, 5, train)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    t = tcifar.CifarDataSetIterator(64, num_examples=128, train=train,
                                    data_dir="/nonexistent")
    assert t.synthetic and t.next().features.shape == (64, 32, 32, 3)


def test_mnist_reads_local_idx_files(tmp_path):
    """Local idx files (gzipped) are parsed as the reference's
    MnistDbFile reads them, the same arrays the JAX package reads."""
    import gzip
    import struct

    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (7, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 7, dtype=np.uint8)
    for split in ("train", "t10k"):
        with gzip.open(tmp_path / f"{split}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 0x803, 7, 28, 28) + imgs.tobytes())
        with gzip.open(tmp_path / f"{split}-labels-idx1-ubyte.gz", "wb") as f:
            f.write(struct.pack(">II", 0x801, 7) + labels.tobytes())
    t = tmnist.MnistDataFetcher(data_dir=str(tmp_path))
    j = jmnist.MnistDataFetcher(data_dir=str(tmp_path))
    assert not t.synthetic and not j.synthetic
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
