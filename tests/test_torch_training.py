"""Training `transformer_lm` through the port's `ComputationGraph.fit`
and `fit_scanned` against the JAX package on the CPU.

Both packages start from the same params (copied with
`params_from_jax`) and see the same token batches, made with numpy from
a seed. The fused softmax-xent head is forced on in both
(`FORCE_FUSED = True`, restored afterwards): the JAX package runs its
Pallas kernels in interpret mode, the port the plain versions of its
CUDA kernels. At T = 512 and head_dim 128 the attention takes the
packed flash route (forward K2, backward K6); at T = 128 the dense one.

Tolerances: float32 on both sides, summed in another order. Per-step
losses agree to 1e-5 relative. After three Adam steps at lr = 3e-4
every param entry agrees to 2e-5 absolute, except where the JAX
gradient is zero to rounding at every step (|g| <= 1e-6 of its
tensor's largest |g|; in this model, the key slice of bqkv, to which
softmax is invariant): Adam moves a weight by about lr per step whatever
the size of its gradient, so there the two packages' rounding noise
steers each step differently, and those entries are held to 3 * lr =
9e-4, the most three steps can move a weight.
"""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops.fused_softmax_xent as jfsx
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_lm as torch_lm,
)
from deeplearning4j_tpu_torch.nn.training import fit_steps, tree_cast
from deeplearning4j_tpu_torch.ops import fused_softmax_xent as tfsx
from deeplearning4j_tpu_torch.weights_io import (
    params_from_jax,
    params_to_numpy,
)

pytestmark = pytest.mark.port

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
ZERO_GRAD_RTOL = 1e-6
ADAM_LR = 3e-4
CFG = dict(vocab_size=2048, d_model=256, n_heads=2, n_layers=2, d_ff=512)


@pytest.fixture
def fused_on():
    jfsx.FORCE_FUSED = True
    tfsx.FORCE_FUSED = True
    try:
        yield
    finally:
        jfsx.FORCE_FUSED = None
        tfsx.FORCE_FUSED = None


def _tokens(seed, B, T, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    mask = None
    if masked:
        lengths = rng.integers(T // 2, T + 1, B)
        mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return toks, np.roll(toks, -1, axis=1), mask


def _pair(T, **kw):
    """(JAX net, port net) with the same params and fresh Adam state."""
    jnet = jax_lm(**CFG, max_length=T, **kw).init()
    tnet = torch_lm(**CFG, max_length=T, device="cpu", **kw).init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    return jnet, tnet


def _zero_grads(jnet, ds):
    """{layer: {name: bool array}}: where the JAX gradient of this
    batch's loss at the current params is zero to rounding."""
    batch = jnet._batch_dict(jnet._to_mds(ds))
    grads = jax.grad(lambda p: jnet._loss(p, jnet.state, None, batch)[0])(
        jnet.params)
    out = {}
    for layer, leaves in grads.items():
        out[layer] = {}
        for name, g in leaves.items():
            g = np.abs(np.asarray(g))
            out[layer][name] = g <= ZERO_GRAD_RTOL * g.max()
    return out


def _train(jnet, tnet, batches):
    """One fit() call per batch in both. Returns the per-step losses and
    where the JAX gradient was zero to rounding at every step."""
    jl, tl, zero = [], [], None
    for toks, labels, mask in batches:
        jds = JDataSet(toks, labels, features_mask=mask)
        z = _zero_grads(jnet, jds)
        zero = z if zero is None else jax.tree.map(np.logical_and, zero, z)
        jnet.fit(jds)
        tnet.fit(TDataSet(toks, labels, features_mask=mask))
        jl.append(jnet.score_value)
        tl.append(tnet.score_value)
    return np.array(jl), np.array(tl), zero


def _assert_params_close(jnet, tnet, zero):
    """Every entry to PARAM_ATOL, and those whose gradient was zero to
    rounding to 3 * lr; the latter must be the key slice of bqkv."""
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    assert jp.keys() == tp.keys()
    for layer in jp:
        for name in jp[layer]:
            diff = np.abs(tp[layer][name] - jp[layer][name])
            z = zero[layer][name]
            assert diff[~z].max(initial=0) <= PARAM_ATOL, (layer, name)
            assert diff[z].max(initial=0) <= 3 * ADAM_LR * 1.001, (layer,
                                                                   name)
            if name == "bqkv":
                n = z.shape[0] // 3
                assert z[n:2 * n].all() and not z[:n].any() \
                    and not z[2 * n:].any(), layer
            elif name != "W" or layer != "embed":
                # the embedding rows of unseen tokens get no gradient
                # (and no update) in either package
                assert not z.any(), (layer, name)


def test_fit_flash_and_fused_head_matches_jax(fused_on):
    """3 Adam steps at T = 512: packed flash (K2/K6) and the fused head
    (K8/K9) in both packages."""
    jnet, tnet = _pair(512)
    batches = [_tokens(s, 2, 512) for s in range(3)]
    jl, tl, zero = _train(jnet, tnet, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    _assert_params_close(jnet, tnet, zero)


def test_fit_masked_dense_route_matches_jax():
    """T = 128 with a ragged padding mask: the dense attention route and
    the dense mcxent loss (vocab 2048 is fused only when forced)."""
    jnet, tnet = _pair(128)
    batches = [_tokens(10 + s, 2, 128, masked=True) for s in range(3)]
    jl, tl, zero = _train(jnet, tnet, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    _assert_params_close(jnet, tnet, zero)


def test_fit_scanned_matches_fit():
    """fit_scanned over the batches gives the losses and params that
    one fit() call per batch gives."""
    batches = [TDataSet(t, lab) for t, lab, _ in
               (_tokens(20 + s, 2, 128) for s in range(3))]
    a = torch_lm(**CFG, max_length=128, device="cpu").init(3)
    b = torch_lm(**CFG, max_length=128, device="cpu").init(3)
    losses = []
    for ds in batches:
        a.fit(ds)
        losses.append(a.score_value)
    b.fit_scanned(batches)
    np.testing.assert_allclose(b._step_losses.numpy()[0], losses,
                               rtol=1e-6, atol=0)
    assert b.iteration_count == a.iteration_count == 3
    pa, pb = params_to_numpy(a.params), params_to_numpy(b.params)
    for layer in pa:
        for name in pa[layer]:
            np.testing.assert_allclose(pb[layer][name], pa[layer][name],
                                       rtol=0, atol=1e-6)


def test_score_matches_jax(fused_on):
    """score() (the loss without an update) and score_examples() agree
    with the JAX package on the same params."""
    jnet, tnet = _pair(512)
    toks, labels, _ = _tokens(30, 2, 512)
    np.testing.assert_allclose(tnet.score(TDataSet(toks, labels)),
                               jnet.score(JDataSet(toks, labels)),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        tnet.score_examples(TDataSet(toks, labels)),
        np.asarray(jnet.score_examples(JDataSet(toks, labels))),
        rtol=LOSS_RTOL)


def test_attention_dropout_on_flash_route_raises():
    """Attention dropout on the flash route (packed, T = 512) runs in the
    kernels from the net's generator: fit trains, the same seed gives the
    same loss and dropout changes it. Called without a generator, the
    layer raises instead of training without dropout."""
    toks, labels, _ = _tokens(40, 2, 512)

    def loss(rate):
        net = torch_lm(**CFG, max_length=512, attention_dropout=rate,
                       device="cpu").init(5)
        net.fit(TDataSet(toks, labels))
        return net, net.score_value

    (net, a), (_, b), (_, c) = loss(0.1), loss(0.1), loss(None)
    assert np.isfinite(a) and a == b and a != c
    attn = net.layer_vertices["blk0_attn"].layer
    impl = net.impls["blk0_attn"]
    x = torch.zeros(2, 512, CFG["d_model"])
    with pytest.raises(ValueError, match="dropout > 0 requires a generator"):
        impl.apply(attn, net.params["blk0_attn"], {}, x, train=True)


def test_dropout_dense_route_trains_and_is_seeded():
    """Dropout on the dense route draws from the net's generator: the
    same seed gives the same losses, and inference ignores it."""
    toks, labels, _ = _tokens(50, 2, 128)

    def run():
        net = torch_lm(**CFG, max_length=128, dropout=0.1,
                       device="cpu").init(7)
        net.fit(TDataSet(toks, labels))
        net.fit(TDataSet(toks, labels))
        return net

    a, b = run(), run()
    assert a.score_value == b.score_value
    assert np.isfinite(a.score_value)
    assert a.score(TDataSet(toks, labels)) == b.score(TDataSet(toks, labels))


def test_untrainable_modes_raise():
    """The Solver path, once refused, trains the LM: one L-BFGS
    iteration (its line search included) lowers the score at T = 128
    (the dense attention route). HessianFree needs second derivatives,
    which the flash Function of the T = 512 packed route does not have:
    it raises SecondDerivativeError, not a silent fallback."""
    from deeplearning4j_tpu_torch.ops import SecondDerivativeError

    net = torch_lm(**CFG, max_length=128, device="cpu").init()
    toks, labels, _ = _tokens(60, 2, 128)
    ds = TDataSet(toks, labels)
    net.conf.conf.optimization_algo = "lbfgs"
    before = net.score(ds)
    net.fit(ds)
    assert net.score(ds) < before
    assert net.iteration_count >= 1
    net = torch_lm(**CFG, max_length=512, device="cpu").init()
    toks, labels, _ = _tokens(62, 1, 512)
    net.conf.conf.optimization_algo = "hessian_free"
    with pytest.raises(SecondDerivativeError, match="_FlashQkvCore"):
        net.fit(TDataSet(toks, labels))


def test_remat_and_mesh_raise():
    """set_mesh(None) returns the net, as in the JAX package; "seq" with
    "pipe" (once refused) places a net built for sequence parallelism
    on a world of one and takes a step. remat, once refused,
    trains:
    with dropout 0.1 on the packed flash route (T = 512) two fit()
    steps with remat leave every param bit for bit where the same steps
    without it do, the recompute drawing the forward's keep masks; and
    fit_scanned takes it too. One intra-op thread: the CPU's threaded
    reductions are not bitwise repeatable from run to run."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    net = torch_lm(**CFG, max_length=128, device="cpu").init()
    assert net.set_mesh(None) is net
    sp = torch_lm(**CFG, max_length=128, seq_parallel_axis="seq",
                  device="cpu").init()
    try:
        sp.set_mesh(make_mesh({"pipe": 1, "seq": 1}, device="cpu"),
                    axes={"seq": "seq", "pipe": "pipe"})
        assert sp._pipe.seq_axis == "seq"
        toks, labels, _ = _tokens(60, 2, 128)
        sp.fit(TDataSet(toks, labels))
        assert np.isfinite(sp.score_value)
    finally:
        bootstrap.shutdown()
    toks, labels, _ = _tokens(61, 2, 512)
    ds = TDataSet(toks, labels)

    def run(remat):
        net = torch_lm(**CFG, max_length=512, dropout=0.1, remat=remat,
                       device="cpu").init(3)
        net.fit(ds)
        net.fit(ds)
        return net

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain, remat = run(False), run(True)
    finally:
        torch.set_num_threads(threads)
    assert remat.conf.conf.remat and not plain.conf.conf.remat
    assert plain.score_value == remat.score_value
    pp, rp = params_to_numpy(plain.params), params_to_numpy(remat.params)
    for layer in pp:
        for name in pp[layer]:
            np.testing.assert_array_equal(rp[layer][name], pp[layer][name],
                                          err_msg=f"{layer}.{name}")
    remat.fit_scanned(ds)
    assert np.isfinite(remat.score_value)


def test_fit_steps_counts_global_steps():
    """fit_steps runs to the global step count, one DataSet per step,
    and resumes from the counter."""
    net = torch_lm(**CFG, max_length=128, device="cpu").init()
    seen = []

    def batch(step):
        toks, labels, _ = _tokens(70 + step, 2, 128)
        return TDataSet(toks, labels)

    fit_steps(net, batch, 2, on_step=seen.append)
    fit_steps(net, batch, 3, on_step=seen.append)
    assert seen == [1, 2, 3] and net.iteration_count == 3


def test_tree_cast_casts_floating_leaves_only():
    tree = {"a": {"W": torch.ones(2, dtype=torch.float32),
                  "i": torch.ones(2, dtype=torch.int32)}}
    out = tree_cast(tree, torch.bfloat16)
    assert out["a"]["W"].dtype == torch.bfloat16
    assert out["a"]["i"].dtype == torch.int32


@pytest.mark.parametrize("kind", ["list", "list_batched", "array",
                                  "existing"])
def test_iterators_match_jax(kind):
    """The port's numpy copies of datasets/iterators.py yield the JAX
    package's batches."""
    from deeplearning4j_tpu.datasets import iterators as jit_
    from deeplearning4j_tpu_torch.datasets import iterators as tit

    rng = np.random.default_rng(80)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = rng.standard_normal((10, 2)).astype(np.float32)

    def make(mod, DS):
        if kind == "list":
            return mod.ListDataSetIterator([DS(x[:4], y[:4]),
                                            DS(x[4:], y[4:])])
        if kind == "list_batched":
            return mod.ListDataSetIterator(DS(x, y), batch_size=3)
        if kind == "array":
            return mod.ArrayDataSetIterator(x, y, 4)
        return mod.ExistingDataSetIterator([DS(x[:5], y[:5]),
                                            DS(x[5:], y[5:])])

    jb = [(d.features, d.labels) for d in make(jit_, JDataSet)]
    tb = [(d.features, d.labels) for d in make(tit, TDataSet)]
    assert len(jb) == len(tb) > 1
    for (jf, jl), (tf, tl) in zip(jb, tb):
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tl, jl)
