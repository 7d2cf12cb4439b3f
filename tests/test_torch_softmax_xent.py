"""The port's fused softmax cross-entropy head (deeplearning4j_tpu_torch/
ops/fused_softmax_xent.py, the K8/K9 wrappers over csrc/softmax_xent.cu)
and its loss functions (ops/losses.py) against the JAX package on the
CPU.

The JAX head runs its Pallas kernels in interpret mode; on CPU tensors
the port computes `_xent_fwd_reference` / `_xent_bwd_reference`, the
functions its CUDA kernels compute on the card (chip_smoke.py holds the
two together there). Shapes are ragged: N = 200 rows (the JAX wrapper
pads to 128-row blocks) and V = 2500 (not a multiple of its 2048-wide
vocab chunk).

Tolerance: float32 on both sides, summed in another order: 1e-5
relative on the loss and 1e-4 relative (1e-6 absolute) on the
gradients, as the JAX package's own head tests state. In bfloat16 both
round G to bf16 before the two products (the JAX kernels' `g.astype`)
and the results once at the end, so a gradient entry may differ by one
bf16 rounding (2^-8 of the largest entry) where an f32 sum differs in
its last bit, on at most 1% of the entries; without the rounding of G
about a quarter of dx differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.ops.fused_softmax_xent import (
    softmax_xent_head as jax_head,
)
from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputImpl
from deeplearning4j_tpu_torch.ops import fused_softmax_xent as tfsx
from deeplearning4j_tpu_torch.ops import losses as tlosses

pytestmark = pytest.mark.port


@pytest.fixture
def head():
    rng = np.random.default_rng(11)
    N, d, V = 200, 128, 2500
    x = rng.standard_normal((N, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((d, V))).astype(np.float32)
    b = (0.01 * rng.standard_normal(V)).astype(np.float32)
    lab = rng.integers(0, V, N).astype(np.int32)
    g = rng.random(N).astype(np.float32)
    return x, w, b, lab, g


def _port_grads(x, w, b, lab, g, fn):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    loss = fn(*ts, torch.from_numpy(lab))
    loss.backward(torch.from_numpy(g).reshape(loss.shape))
    return loss.detach().numpy(), [t.grad.numpy() for t in ts]


def test_head_matches_jax(head):
    """Loss and dx, dW, db of the fused head against the JAX package's
    fused head (interpret mode), at ragged N and V."""
    x, w, b, lab, g = head
    jl, vjp = jax.vjp(lambda x, w, b: jax_head(x, w, b, jnp.asarray(lab)),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jg = vjp(jnp.asarray(g))
    tl, tg = _port_grads(x, w, b, lab, g, tfsx.softmax_xent_head)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=0)
    for a, r in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6)


def test_head_matches_jax_bf16(head):
    """bf16 x, W, b: loss and dx, dW, db of the fused head against the
    JAX package's fused head (interpret mode), where both round G to
    bf16 for the products."""
    x, w, b, lab, g = head
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b)]
    jl, vjp = jax.vjp(lambda x, w, b: jax_head(x, w, b, jnp.asarray(lab)),
                      *jb)
    jg = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(torch.bfloat16).requires_grad_() for a in jb]
    loss = tfsx.softmax_xent_head(*ts, torch.from_numpy(lab))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=0)
    for t, r in zip(ts, jg):
        assert t.grad.dtype == torch.bfloat16
        got = t.grad.float().numpy()
        want = np.asarray(r.astype(jnp.float32))
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()
        assert (got != want).mean() <= 0.01


def test_head_matches_dense_loss(head):
    """The fused head computes what the dense route computes: the
    sparse-label mcxent of compute_loss on the logits, per token."""
    x, w, b, lab, g = head

    def dense(x, w, b, lab):
        z = x @ w + b
        return tlosses.compute_loss("mcxent", lab, torch.softmax(z, -1),
                                    logits=z, reduce=False)

    fl, fg = _port_grads(x, w, b, lab, g, tfsx.softmax_xent_head)
    dl, dg = _port_grads(x, w, b, lab, g, dense)
    np.testing.assert_allclose(fl, dl, rtol=1e-5, atol=0)
    for a, r in zip(fg, dg):
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-6)


def test_3d_head_matches_flat(head):
    """[B, T, d] features and [B, T] labels score as the flattened
    tokens do."""
    x, w, b, lab, _ = head
    t = [torch.from_numpy(a) for a in (x, w, b, lab)]
    flat = tfsx.softmax_xent_head(*t)
    three = tfsx.softmax_xent_head(t[0].reshape(8, 25, -1), t[1], t[2],
                                   t[3].reshape(8, 25))
    assert three.shape == (8, 25)
    np.testing.assert_allclose(three.reshape(-1).numpy(), flat.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("force,d,V,labels_int,want", [
    (None, 128, 2500, True, False),   # CPU tensors: dense unless forced
    (True, 128, 2500, True, True),
    (False, 128, 2500, True, False),
    (True, 96, 2500, True, False),    # d not a multiple of 128
    (True, 128, 1000, True, False),   # vocab below MIN_FUSED_VOCAB
    (True, 128, 2500, False, False),  # one-hot labels
])
def test_fused_head_gate(force, d, V, labels_int, want):
    """OutputImpl._use_fused_head: the JAX package's gate with the
    tensor's device (cuda) in place of its `backend == "tpu"`."""
    conf = RnnOutputLayer(n_in=d, n_out=V, activation="softmax",
                          loss_function="mcxent")
    x = torch.zeros(2, 4, d)
    labels = (torch.zeros(2, 4, dtype=torch.int32) if labels_int
              else torch.zeros(2, 4, V))
    old = tfsx.FORCE_FUSED
    tfsx.FORCE_FUSED = force
    try:
        got = OutputImpl._use_fused_head(conf, {"W": torch.zeros(d, V)}, x,
                                         labels, "softmax")
    finally:
        tfsx.FORCE_FUSED = old
    assert got is want


def test_kernel_wrappers_refuse_cpu_tensors(head):
    """The K8 and K9 kernel wrappers take CUDA tensors only: handed CPU
    tensors they raise before loading the library; nothing falls
    back."""
    x, w, b, lab, g = (torch.from_numpy(a) for a in head)
    lse = torch.zeros(x.shape[0])
    with pytest.raises(ValueError, match="CUDA device"):
        tfsx._xent_fwd(x, w, b, lab)
    with pytest.raises(ValueError, match="CUDA device"):
        tfsx._xent_dx(x, w, b, lab, lse, g)
    with pytest.raises(ValueError, match="CUDA device"):
        tfsx._xent_dwdb(x, w, b, lab, lse, g)


@pytest.mark.parametrize("name,ptr", [("x", 0x7f0000000008),
                                      ("W", 0x7f0000000004)])
def test_bf16_kernels_refuse_misaligned_base_pointers(name, ptr):
    """The bf16 kernels copy x and W 16 bytes at a time: a base pointer
    off a 16-byte boundary raises a ValueError that names the operand;
    aligned ones pass."""
    tfsx._check_alignment({"x": 0x7f0000000000, "W": 0x7f0000000100})
    with pytest.raises(ValueError, match=f"base pointer of {name} "):
        tfsx._check_alignment({name: ptr})


@pytest.mark.parametrize("name", ["x", "W"])
def test_bf16_forward_refuses_misaligned_base_pointers(name, monkeypatch):
    """K8's bf16 kernel copies x and W 16 bytes at a time too: its
    wrapper raises a ValueError naming the operand whose base pointer is
    off a 16-byte boundary, before any launch (the device check is
    stubbed so that CPU tensors reach the alignment guard)."""
    monkeypatch.setattr(tfsx, "_check", lambda *a: None)
    N, d, V = 4, 32, 24

    def operand(shape, skew):
        flat = torch.zeros(shape[0] * shape[1] + 8, dtype=torch.bfloat16)
        base = (-flat.data_ptr() // 2) % 8  # elements to a 16-byte boundary
        return flat[base + skew:base + skew + shape[0] * shape[1]].view(
            shape)

    x = operand((N, d), 1 if name == "x" else 0)
    w = operand((d, V), 1 if name == "W" else 0)
    assert (x.data_ptr() % 16 != 0) == (name == "x")
    assert (w.data_ptr() % 16 != 0) == (name == "W")
    with pytest.raises(ValueError, match=f"base pointer of {name} "):
        tfsx._xent_fwd(x, w, torch.zeros(V, dtype=torch.bfloat16),
                       torch.zeros(N, dtype=torch.int32))


_LOSSES = sorted(jlosses.KNOWN_LOSSES)


@pytest.mark.parametrize("name", _LOSSES)
@pytest.mark.parametrize("masked", [False, True])
def test_compute_loss_matches_jax(name, masked):
    """Every loss of ops/losses.py against the JAX package's, on the
    activated output (and the logits where the loss fuses with its
    activation), with and without a per-example mask; reduced and per
    example."""
    rng = np.random.default_rng(len(name))
    z = rng.standard_normal((4, 6, 5)).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood"):
        out = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
        labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 6))]
        logits = z
    elif name in ("xent", "rmse_xent", "reconstruction_crossentropy"):
        out = 1.0 / (1.0 + np.exp(-z))
        labels = (rng.random(z.shape) > 0.5).astype(np.float32)
        logits = z if name == "xent" else None
    else:
        out = np.abs(z) if name in ("expll", "poisson",
                                    "kl_divergence") else z
        labels = np.abs(rng.standard_normal(z.shape)).astype(np.float32)
        logits = None
    mask = ((rng.random((4, 6)) > 0.3).astype(np.float32) if masked
            else None)
    for reduce in (True, False):
        want = jlosses.compute_loss(
            name, jnp.asarray(labels), jnp.asarray(out),
            None if mask is None else jnp.asarray(mask),
            logits=None if logits is None else jnp.asarray(logits),
            reduce=reduce)
        got = tlosses.compute_loss(
            name, torch.from_numpy(labels), torch.from_numpy(out),
            None if mask is None else torch.from_numpy(mask),
            logits=None if logits is None else torch.from_numpy(logits),
            reduce=reduce)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_sparse_labels_match_one_hot():
    """Integer labels take the gather path and give the one-hot loss."""
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((3, 7, 9)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (3, 7)))
    sparse = tlosses.compute_loss("mcxent", idx, torch.softmax(z, -1),
                                  logits=z)
    dense = tlosses.compute_loss("mcxent", torch.eye(9)[idx],
                                 torch.softmax(z, -1), logits=z)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.validate_loss("mcxnet")
