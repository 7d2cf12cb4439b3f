"""The port's fused LayerNorm (deeplearning4j_tpu_torch/ops/
fused_layernorm.py, the K10/K11 wrappers over csrc/layernorm.cu)
against the JAX package on the CPU.

Inside the TPU envelope (C % 128 == 0, N % 8 == 0) the reference is the
JAX `fused_layer_norm` (its Pallas kernels in interpret mode) and its
custom VJP; at a ragged shape, which the TPU kernels do not take but the
CUDA kernels do, it is the plain jnp form of the JAX package's
`LayerNormImpl` (nn/layers/attention.py) and `jax.vjp` through it. On
CPU tensors the port computes `_ln_fwd_reference` / `_ln_bwd_reference`,
the functions its kernels compute on the card (chip_smoke.py holds the
two together there).

Tolerance: float32 on both sides, summed in another order: 1e-5 of the
largest entry, for y, dx, dgamma and dbeta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.fused_layernorm import (
    fused_layer_norm as jax_fused_layer_norm,
    supports as jax_supports,
)
from deeplearning4j_tpu_torch.ops import fused_layernorm as tln

pytestmark = pytest.mark.port

EPS = 1e-5


def _plain_jax_ln(x, gamma, beta):
    """The JAX package's LayerNormImpl.apply form."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    xn = (x - mu) * jax.lax.rsqrt(var + EPS)
    return xn * gamma + beta


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, dy


def _port(x, gamma, beta, dy):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y = tln.fused_layer_norm(*ts, eps=EPS)
    y.backward(torch.from_numpy(dy))
    return [y.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax(fn, x, gamma, beta, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(gamma),
                     jnp.asarray(beta))
    return [np.asarray(y)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("shape", [(64, 128), (4, 16, 256)],
                         ids=["N64_C128", "B4_T16_C256"])
def test_fused_layer_norm_matches_jax_kernel(shape):
    """y, dx, dgamma, dbeta against the JAX fused_layer_norm (Pallas in
    interpret mode) inside its envelope."""
    assert jax_supports(shape)
    args = _inputs(shape, 1)
    got = _port(*args)
    want = _jax(lambda x, g, b: jax_fused_layer_norm(x, g, b, EPS), *args)
    _close(got, want)
    assert tln.LAUNCHES == {"K10": 0, "K11": 0}  # CPU tensors never launch


@pytest.mark.parametrize("shape", [(50, 200), (3, 7)],
                         ids=["N50_C200", "N3_C7"])
def test_fused_layer_norm_ragged_matches_plain_jax(shape):
    """At shapes outside the TPU envelope: against the JAX package's
    plain LayerNorm form and its autodiff gradients."""
    assert not jax_supports(shape)
    args = _inputs(shape, 2)
    _close(_port(*args), _jax(_plain_jax_ln, *args))


def test_reference_statistics_are_f32_and_dtype_kept():
    """K10 returns y in x's dtype and f32 mu/rstd; K11 returns dx in x's
    dtype and f32 dgamma/dbeta, which the autograd Function casts to
    gamma's dtype."""
    x, gamma, beta, dy = (torch.from_numpy(a).to(torch.bfloat16)
                          for a in _inputs((16, 64), 3))
    y, mu, rstd = tln._ln_fwd(x, gamma, beta, EPS)
    assert y.dtype == torch.bfloat16
    assert mu.dtype == rstd.dtype == torch.float32 and mu.shape == (16,)
    dx, dg, db = tln._ln_bwd(x, gamma, mu, rstd, dy)
    assert dx.dtype == torch.bfloat16 and dg.dtype == db.dtype == \
        torch.float32
    xs = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    tln.fused_layer_norm(*xs).backward(dy)
    assert all(t.grad.dtype == torch.bfloat16 for t in xs)


def _fwd_ptrs(x, gamma, beta):
    y = torch.empty_like(x)
    return tuple(t.data_ptr() for t in (x, gamma, beta, y))


@pytest.mark.parametrize("C,dtype,want", [
    (256, torch.bfloat16, 1), (256, torch.float32, 2),
    (512, torch.bfloat16, 2), (1024, torch.bfloat16, 4),
    (512, torch.float32, 4), (128, torch.float32, 1),
    (2048, torch.bfloat16, 0), (1024, torch.float32, 0),
    (200, torch.bfloat16, 0), (200, torch.float32, 0), (7, torch.float32, 0),
    (384, torch.bfloat16, 0)])
def test_fwd_plan_picks_the_instantiation_by_shape(C, dtype, want):
    """K10's dispatch by shape: the one-pass vector kernel when a warp's
    32 lanes cover the row in whole 16-byte vectors, 1 to
    MAX_VEC_PER_LANE of them (256 bf16 or 128 f32 columns each), else
    the general kernel (0)."""
    x = torch.zeros(8, C, dtype=dtype)
    g, b = torch.ones(C, dtype=dtype), torch.zeros(C, dtype=dtype)
    assert tln._fwd_plan(C, x.element_size(), _fwd_ptrs(x, g, b)) == want


@pytest.mark.parametrize("which", ["x", "gamma", "beta"])
def test_fwd_plan_sends_an_unaligned_tensor_to_the_general_kernel(which):
    """A contiguous [N, 256] bf16 view one element into a flat buffer
    (2 bytes past a 16-byte boundary), as x, gamma or beta: the general
    kernel, never a 16-byte load from an unaligned address."""
    N, C = 4, 256
    t = {"x": (N, C), "gamma": (C,), "beta": (C,)}
    ts = {k: torch.zeros(*shape, dtype=torch.bfloat16)
          for k, shape in t.items()}
    flat = torch.zeros(N * C + 1, dtype=torch.bfloat16)
    ts[which] = flat[1:1 + ts[which].numel()].view(t[which])
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16
    aligned = {k: v for k, v in ts.items() if k != which}
    assert all(v.data_ptr() % 16 == 0 for v in aligned.values())
    assert tln._fwd_plan(C, 2, _fwd_ptrs(ts["x"], ts["gamma"],
                                         ts["beta"])) == 0


def _bwd_ptrs(x, gamma, dy):
    dx = torch.empty_like(x)
    return tuple(t.data_ptr() for t in (x, gamma, dy, dx))


@pytest.mark.parametrize("N,C,dtype,want", [
    (16384, 256, torch.bfloat16, (1, 264)), (16384, 256, torch.float32,
                                             (2, 264)),
    (16384, 512, torch.bfloat16, (2, 264)), (16384, 512, torch.float32,
                                             (0, 256)),
    (16384, 128, torch.float32, (1, 264)), (40, 256, torch.bfloat16, (1, 5)),
    (1, 256, torch.bfloat16, (1, 1)), (2112, 256, torch.bfloat16, (1, 264)),
    (2105, 256, torch.bfloat16, (1, 264)),
    (16384, 1024, torch.bfloat16, (0, 256)),
    (16384, 768, torch.float32, (0, 256)),
    (1000, 200, torch.bfloat16, (0, 16)), (13, 7, torch.float32, (0, 1)),
    (100, 384, torch.bfloat16, (0, 2))])
def test_bwd_plan_picks_the_instantiation_by_shape(N, C, dtype, want):
    """K11's dispatch by shape: the one-pass vector kernel when a warp's
    32 lanes cover the row in 1 to MAX_BWD_VEC_PER_LANE whole 16-byte
    vectors each (C = 256 or 512 in bf16, 128 or 256 in f32), on
    min(BWD_BLOCKS, ceil(N / 8)) blocks; else the general path with
    ceil(N / PARTIAL_ROWS) column partials (nv = 0)."""
    x = torch.zeros(4, C, dtype=dtype)
    g = torch.ones(C, dtype=dtype)
    assert tln._bwd_plan(N, C, x.element_size(),
                         _bwd_ptrs(x, g, torch.zeros_like(x))) == want


@pytest.mark.parametrize("which", ["x", "gamma", "dy"])
def test_bwd_plan_sends_an_unaligned_tensor_to_the_general_path(which):
    """A contiguous [N, 256] bf16 view one element into a flat buffer
    as x, gamma or dy: the general path, never a 16-byte load from an
    unaligned address."""
    N, C = 4, 256
    t = {"x": (N, C), "gamma": (C,), "dy": (N, C)}
    ts = {k: torch.zeros(*shape, dtype=torch.bfloat16)
          for k, shape in t.items()}
    flat = torch.zeros(N * C + 1, dtype=torch.bfloat16)
    ts[which] = flat[1:1 + ts[which].numel()].view(t[which])
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16
    assert tln._bwd_plan(N, C, 2, _bwd_ptrs(ts["x"], ts["gamma"],
                                            ts["dy"])) == (0, 1)


def test_launch_check_names_what_the_kernels_do_not_take():
    """The lean launch path's checks build their text only when they
    raise, and still name the fault: CPU tensors, which no kernel takes,
    as the forward's and as the backward's arguments."""
    x, gamma, beta, dy = (torch.from_numpy(a) for a in _inputs((8, 64), 4))
    assert not tln._ok(x, (gamma, beta))
    with pytest.raises(ValueError, match="CUDA device"):
        tln._check(x, (gamma, beta))
    with pytest.raises(ValueError, match="CUDA device"):
        tln._check(x, (gamma,), (dy,), (x[:, 0].contiguous(),) * 2)
    assert tln.LAUNCHES == {"K10": 0, "K11": 0}


@pytest.mark.parametrize("shape", [(64, 128), (16, 256)],
                         ids=["N64_C128", "N16_C256"])
def test_bf16_x_with_f32_gamma_matches_jax_kernel(shape):
    """Fault C2: bf16 x with f32 gamma and beta, which the JAX kernels
    take (they cast gamma and beta to f32 inside). y and dx in bf16 equal
    the JAX kernel's (interpret mode) within one bf16 rounding of 1e-2
    relative to the largest entry, dgamma and dbeta in f32 within 1e-5;
    y is computed with the f32 gamma, not one rounded to bf16."""
    assert jax_supports(shape)
    x, gamma, beta, dy = _inputs(shape, 5)
    jx, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, dy))
    jy, vjp = jax.vjp(lambda a, g, b: jax_fused_layer_norm(a, g, b, EPS),
                      jx, jnp.asarray(gamma), jnp.asarray(beta))
    want = [np.asarray(jy, np.float32)] + [np.asarray(g, np.float32)
                                           for g in vjp(jdy)]
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    y = tln.fused_layer_norm(tx, tg, tb, eps=EPS)
    y.backward(torch.from_numpy(dy).bfloat16())
    assert y.dtype == tx.grad.dtype == torch.bfloat16
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    got = [t.float().numpy() for t in (y.detach(), tx.grad, tg.grad,
                                       tb.grad)]
    _close(got[:2], want[:2], tol=1e-2)
    _close(got[2:], want[2:])
    rounded = tln.fused_layer_norm(tx.detach(), tg.detach().bfloat16(),
                                   tb.detach().bfloat16(), eps=EPS)
    assert (y.detach() != torch.from_numpy(want[0]).bfloat16()).sum() < (
        rounded != torch.from_numpy(want[0]).bfloat16()).sum()
    assert tln.LAUNCHES == {"K10": 0, "K11": 0}


def test_f32_params_beside_bf16_x_take_one_vector_a_lane():
    """K11's vector kernel holds an f32 gamma in twice the registers, so
    beside bf16 x it takes one 16-byte vector a lane (C = 256); wider
    rows go to the general path. The forward's plan does not change."""
    ptrs = (0, 16, 32, 48)
    assert tln._bwd_plan(1024, 256, 2, ptrs, True) == (1, 128)
    assert tln._bwd_plan(1024, 512, 2, ptrs, True) == (0, 16)
    assert tln._bwd_plan(1024, 512, 2, ptrs) == (2, 128)
    assert tln._param_dtype_ok(torch.bfloat16, torch.float32)
    assert not tln._param_dtype_ok(torch.float32, torch.bfloat16)
