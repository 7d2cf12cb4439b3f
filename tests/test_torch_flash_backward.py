"""The port's flash-attention backward (deeplearning4j_tpu_torch/ops/
flash_attention.py, the K4-K7 wrappers over csrc/flash_bwd.cu) against
the JAX package's Pallas backward kernels on the CPU: `jax.vjp` through
`flash_attention_qkv` / `flash_attention` against torch autograd
through the port's, on the same inputs and the same output cotangent.

The JAX kernels run in interpret mode, as the JAX package's own tests
run them; `autotune.override` forces the JAX package's split dq/dkv
route (K5) at T = 512, where it would otherwise take the single-block
kernel (K4). On CPU tensors the port computes `_flash_bwd_reference`,
the function its CUDA kernel computes on the card (chip_smoke.py holds
the two together there).

Tolerance: float32 on both sides, summed in another order: 2e-5
absolute on gradients whose entries are O(1). In bfloat16 the JAX split
kernels round P and dS to bf16 before the second products, and so does
the port: a gradient entry may then differ by one bf16 rounding (2^-8
of the largest entry) where an f32 sum differs in its last bit, on at
most 1% of the entries; without the rounding 12-20% differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import autotune
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.port

ATOL = 2e-5


def _ragged_mask(rng, rows, T):
    """[rows, T] key mask: ragged valid prefixes, the last row all
    zero."""
    m = np.zeros((rows, T), np.float32)
    for r in range(rows - 1):
        m[r, :rng.integers(T // 4, T)] = 1.0
    return m


def _torch_grads(fn, inputs, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,D,masked", [(1, 128, False), (1, 128, True),
                                        (2, 64, False), (2, 64, True)])
def test_packed_backward_matches_jax(H, D, masked):
    """K6 (D = 128) and K7 (D = 64, the JAX package's head-pair kernel):
    dqkv of the packed route, read and written as [B, T, 3n]."""
    rng = np.random.default_rng(100 + D + masked)
    B, T = 2, 512
    n = H * D
    qkv = rng.standard_normal((B, T, 3 * n)).astype(np.float32)
    cot = rng.standard_normal((B, T, n)).astype(np.float32)
    mask = _ragged_mask(rng, B, T) if masked else None
    jo, (jg,) = _jax_grads(
        lambda x: jfa.flash_attention_qkv(
            x, H, mask=None if mask is None else jnp.asarray(mask)),
        [qkv], cot)
    to, (tg,) = _torch_grads(
        lambda x: tfa.flash_attention_qkv(
            x, H, mask=None if mask is None else torch.from_numpy(mask)),
        [qkv], cot)
    _close([to, tg], [jo, jg])
    if masked:  # the all-masked row: no gradient reaches it
        assert np.all(tg[-1] == 0.0)


@pytest.mark.parametrize("T,split", [(512, False), (512, True),
                                     (1024, True)])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_backward_matches_jax(T, split, masked):
    """The flat route's backward: at T = 512 against the JAX package's
    single-block kernel (K4) and, forced, its dq/dkv split (K5); at
    T = 1024 against the split, which the port's K5 wrapper serves."""
    rng = np.random.default_rng(T + 10 * split + masked)
    B, H, D = 1, 2, 128
    q, k, v, cot = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                    for _ in range(4))
    mask = _ragged_mask(rng, B + 1, T)[:B] if masked else None

    def jfn(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=True,
            mask=None if mask is None else jnp.asarray(mask))

    ov = {"flash_bwd": {"block_q": 128, "block_k": 128}} if split else {}
    with autotune.override(ov):
        jo, jg = _jax_grads(jfn, [q, k, v], cot)
    to, tg = _torch_grads(
        lambda q, k, v: tfa.flash_attention(
            q, k, v, causal=True,
            mask=None if mask is None else torch.from_numpy(mask)),
        [q, k, v], cot)
    _close([to] + tg, [jo] + jg)


@pytest.mark.parametrize("D,masked", [(128, False), (128, True),
                                      (64, True)])
def test_split_backward_bf16_matches_jax(D, masked):
    """bf16 operands: the port's flat backward (`_flash_bwd_impl`, K5's
    wrapper) against the JAX package's dq/dkv split kernels (interpret
    mode, forced by `autotune.override`) on the same q, k, v, o, lse and
    do, where both round P and dS to bf16."""
    rng = np.random.default_rng(40 + D + masked)
    BH, T = 2, 256
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, T, D))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    km = _ragged_mask(rng, BH, T) if masked else None
    tkm = None if km is None else torch.from_numpy(km)
    scale = D ** -0.5
    o, lse = tfa._flash_fwd_reference(q, k, v, tkm, scale, True)

    def jx(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    with autotune.override({"flash_bwd": {"block_q": 128, "block_k": 128}}):
        want = jfa._flash_bwd_impl(
            jx(q), jx(k), jx(v), jx(o), jx(lse), jx(do),
            None if km is None else jnp.asarray(km)[:, None, :], scale, True)
    got = tfa._flash_bwd_impl(q, k, v, o, lse, do,
                              None if tkm is None else tkm[:, None, :], scale,
                              True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max()
        assert (g != w).mean() <= 0.01
        if masked:  # the all-masked row: no gradient reaches it
            assert np.all(g[-1] == 0.0)


@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_head_dims_32_and_256_backward_matches_jax(D, masked):
    """The flat route's gradients at the head dims the CUDA kernels took
    last (fault C1): 8 heads of 32 or 2 heads of 256 at T = 512, in f32
    to 1e-5 (the JAX package's single-block backward, K4's
    counterpart)."""
    rng = np.random.default_rng(70 + D + masked)
    B, T = 1, 512
    H = 8 if D == 32 else 2
    q, k, v, cot = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                    for _ in range(4))
    mask = _ragged_mask(rng, B + 1, T)[:B] if masked else None
    jo, jg = _jax_grads(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, causal=True,
            mask=None if mask is None else jnp.asarray(mask)),
        [q, k, v], cot)
    to, tg = _torch_grads(
        lambda q, k, v: tfa.flash_attention(
            q, k, v, causal=True,
            mask=None if mask is None else torch.from_numpy(mask)),
        [q, k, v], cot)
    for g, w in zip([to] + tg, [jo] + jg):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_all_masked_rows_get_zero_gradients():
    """A batch row whose keys are all masked: its queries see no keys,
    so o = 0 there and no gradient reaches q, k or v of that row — in
    both packages."""
    rng = np.random.default_rng(7)
    B, H, T, D = 2, 1, 512, 128
    q, k, v, cot = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                    for _ in range(4))
    mask = np.ones((B, T), np.float32)
    mask[1] = 0.0
    jo, jg = _jax_grads(
        lambda q, k, v: jfa.flash_attention(q, k, v, mask=jnp.asarray(mask)),
        [q, k, v], cot)
    to, tg = _torch_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v,
                                            mask=torch.from_numpy(mask)),
        [q, k, v], cot)
    _close([to] + tg, [jo] + jg)
    for g in tg:
        assert np.all(g[1] == 0.0) and np.all(np.isfinite(g))


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """`_flash_bwd_reference` (written out: ds = p * (dp - delta)) equals
    autograd through the plain forward `_flash_fwd_reference`."""
    rng = np.random.default_rng(3)
    BH, T, D = 2, 256, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, T, D))
                                    .astype(np.float32)) for _ in range(4))
    km = torch.from_numpy(_ragged_mask(rng, BH, T))
    scale = D ** -0.5
    o, lse = tfa._flash_fwd_reference(q, k, v, km, scale, True)
    got = tfa._flash_bwd_reference(q, k, v, o, lse, do, km, scale, True)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa._flash_fwd_reference(*ts, km, scale, True)[0].backward(do)
    for g, t in zip(got, ts):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=0)


def test_dropout_on_flash_raises():
    """A nonzero dropout rate on a flash entry point with no generator to
    draw its step seed from raises instead of being ignored, as the JAX
    package's raises without `dropout_rng`; with one it runs in the
    kernels (tests/test_torch_flash_dropout.py)."""
    x = torch.zeros(1, 512, 3 * 128)
    with pytest.raises(ValueError, match="dropout > 0 requires a generator"):
        tfa.flash_attention_qkv(x, 1, dropout=0.1)
    q = torch.zeros(1, 1, 512, 128)
    with pytest.raises(ValueError, match="dropout > 0 requires a generator"):
        tfa.flash_attention(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match="requires dropout_rng"):
        jfa.flash_attention(jnp.zeros((1, 1, 512, 128)), jnp.zeros(
            (1, 1, 512, 128)), jnp.zeros((1, 1, 512, 128)), dropout=0.1)


def test_backward_launch_refuses_cpu_tensors():
    """The backward launcher takes CUDA tensors only: handed CPU tensors
    it raises before loading the library, and nothing falls back."""
    B, H, T, D = 1, 1, 128, 128
    t = torch.zeros(B, H, T, D)
    lse = torch.zeros(B * H, T)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._launch_bwd(t, t, t, t, t, lse, None, t.clone(), t.clone(),
                        t.clone(), 1.0, True)


def _layout(ptr=0x7f0000000000, shape=(2, 2, 512, 128),
            strides=(512 * 768, 128, 768, 1), size=2):
    """A [B, H, T, D] bf16 view as `_check_alignment` takes it: by
    default a head of the packed [B, T, 3n] projection (n = 256)."""
    return ptr, shape, strides, size


@pytest.mark.parametrize("view,match", [
    (_layout(ptr=0x7f0000000008), "base pointer of q "),
    (_layout(strides=(512 * 772, 128, 772, 1)), "stride 772 in dimension 2"),
    (_layout(strides=(512 * 768 + 4, 128, 768, 1)),
     "stride 393220 in dimension 0"),
    (_layout(strides=(512 * 768, 132, 768, 1)), "stride 132 in dimension 1"),
])
def test_bf16_backward_refuses_misaligned_views(view, match):
    """The bf16 backward copies rows 16 bytes at a time: a base pointer
    or a batch, head or token stride off a 16-byte boundary raises a
    ValueError that names it. A packed projection's head views pass, and
    so does any stride of a dimension of size 1 (the flat route's
    [BH, 1, T, D] views)."""
    tfa._check_alignment({"q": _layout(), "k": _layout(ptr=0x7f0000000200),
                          "lse": (0x7f0000010000, (4, 512), (512, 1), 4)})
    tfa._check_alignment({"q": _layout(shape=(4, 1, 512, 64),
                                       strides=(512 * 64, 3, 64, 1))})
    with pytest.raises(ValueError, match=match):
        tfa._check_alignment({"q": view})
