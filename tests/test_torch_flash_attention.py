"""The port's flash-attention forward (deeplearning4j_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernels, run on
the CPU in interpret mode as the JAX package's own tests run them.

On a CPU tensor each port wrapper computes its plain PyTorch version
(`_flash_fwd_reference`), the same function the CUDA kernel computes on
the card; chip_smoke.py holds the kernel against it there. Tolerance:
both sides compute in float32, summing in another order, so outputs and
lse agree to 2e-5 absolute (1e-5 at head dims 32 and 256, T = 512). The
bf16 case has its own tolerance, stated in its test.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.port

ATOL = 2e-5


def _ragged_mask(rng, rows, T):
    """[rows, T] key mask: ragged valid prefixes, the last row all zero."""
    m = np.zeros((rows, T), np.float32)
    for r in range(rows - 1):
        m[r, :rng.integers(T // 4, T)] = 1.0
    return m


@pytest.mark.parametrize("T", [512, 1024])
def test_lse_masked_matches_jax(T):
    """K1 as chunked prefill calls it: causal, a [BH, 1, T] key mask with
    ragged rows and one all-zero row (o = 0, lse at the -1e20 floor)."""
    rng = np.random.default_rng(T)
    BH, D = 2, 128
    q, k, v = (rng.standard_normal((BH, T, D)).astype(np.float32)
               for _ in range(3))
    km = _ragged_mask(rng, BH, T)[:, None, :]
    scale = 1.0 / D ** 0.5
    jo, jl = jfa.flash_attention_lse_masked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
        scale, True)
    to, tl = tfa.flash_attention_lse_masked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(km), scale, True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    assert np.all(to.numpy()[-1] == 0.0)
    assert np.all(tl.numpy()[-1] < -1e19)


@pytest.mark.parametrize("T,causal,masked", [(1024, True, True),
                                             (512, False, False)])
def test_flash_attention_matches_jax(T, causal, masked):
    """K1 through the [B, H, T, D] entry point that SelfAttention's flat
    rung calls, with and without a [B, T] key mask."""
    rng = np.random.default_rng(T + 1)
    B, H, D = 1, 2, 128
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    mask = _ragged_mask(rng, B + 1, T)[:B] if masked else None
    jo = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask))
    to = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("H,D,masked", [(1, 128, False), (1, 128, True),
                                        (2, 64, True)])
def test_flash_attention_qkv_matches_jax(H, D, masked):
    """K2: the packed [B, T, 3n] projection read in place. At D = 64 the
    JAX package takes its head-pair kernel (K3); the port computes the
    same function through the same kernel as D = 128."""
    rng = np.random.default_rng(D + H)
    B, T = 2, 512
    n = H * D
    qkv = rng.standard_normal((B, T, 3 * n)).astype(np.float32)
    mask = _ragged_mask(rng, B, T) if masked else None
    jo = jfa.flash_attention_qkv(
        jnp.asarray(qkv), H, causal=True,
        mask=None if mask is None else jnp.asarray(mask))
    to = tfa.flash_attention_qkv(
        torch.from_numpy(qkv), H, causal=True,
        mask=None if mask is None else torch.from_numpy(mask))
    assert to.shape == (B, T, n)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("T", [128, 256, 512, 640, 1024, 8192, 8320])
@pytest.mark.parametrize("n,H", [(256, 2), (256, 4), (192, 3), (128, 1)])
def test_envelopes_match_jax(T, n, H):
    """The dispatch envelopes are the JAX package's, so both packages
    route every shape to the same rung of the attention ladder."""
    D = n // H
    assert (tfa.supports((1, H, T, D), causal=True, dropout=0.0, mask=None)
            == jfa.supports((1, H, T, D), causal=True, dropout=0.0,
                            mask=None))
    assert (tfa.supports_qkv(2, T, n, H, dropout=0.0)
            == jfa.supports_qkv(2, T, n, H, dropout=0.0))


def test_kernel_launch_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: handed CPU tensors it raises
    before loading the library, and nothing falls back."""
    B, H, T, D = 1, 1, 128, 128
    q = torch.zeros(B, H, T, D)
    lse = torch.zeros(B * H, T)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._launch(q, q, q, None, torch.empty_like(q), lse, 1.0, True)


@pytest.mark.parametrize("D,masked", [(64, False), (128, True)])
def test_bf16_forward_matches_jax_blocked_kernel(D, masked):
    """bf16 operands at T = 1024, where the JAX package's `_flash_fwd`
    runs its blocked branch (two 512-key blocks): both round p to bf16
    for P.V and sum l from the unrounded p. The JAX kernel rounds p
    taken against the running max, the plain version p taken against the
    row's final max, so a rounding can differ where the first block did
    not hold the row's max: o agrees within 2^-9 of the largest |o| (one
    bf16 ulp of an entry at most half the largest), on all but at most
    10% of the entries bit for bit; lse (f32) to 2e-5. Without p rounded
    20-40% of the entries differ, by up to 2^-7."""
    rng = np.random.default_rng(50 + D + masked)
    BH, T = 2, 1024
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, T, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    km = _ragged_mask(rng, BH, T) if masked else None
    scale = D ** -0.5

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jo, jl = jfa._flash_fwd(jx(q), jx(k), jx(v),
                            None if km is None else jnp.asarray(km)[:, None],
                            scale, True)
    to, tl = tfa._flash_fwd_reference(
        q, k, v, None if km is None else torch.from_numpy(km), scale, True)
    assert to.dtype == torch.bfloat16
    jo = np.asarray(jo.astype(jnp.float32))
    diff = np.abs(to.float().numpy() - jo)
    assert diff.max() <= 2.0 ** -9 * np.abs(jo).max()
    assert (diff > 0).mean() <= 0.10
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_head_dims_32_and_256_match_jax(D, masked):
    """K1 at the head dims the CUDA kernels took last (fault C1): 8
    heads of 32 or 2 heads of 256, as SelfAttention's flat rung calls
    them, in f32 to 1e-5."""
    rng = np.random.default_rng(60 + D + masked)
    B, T = 1, 512
    H = 8 if D == 32 else 2
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    mask = _ragged_mask(rng, B + 1, T)[:B] if masked else None
    jo = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        mask=None if mask is None else jnp.asarray(mask))
    to = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)


def test_envelopes_differ_only_outside_kernel_head_dims():
    """The one place the two envelopes differ: a head dim outside
    KERNEL_HEAD_DIMS, here 96, takes the dense path in the port and the
    flash kernels in the JAX package; the attention they return agrees
    to 2e-5. Every head dim the kernels take routes as in the JAX
    package (`test_envelopes_match_jax` covers the packed shapes)."""
    B, H, T, D = 1, 2, 512, 96
    assert jfa.supports((B, H, T, D), causal=True, dropout=0.0, mask=None)
    assert not tfa.supports((B, H, T, D), causal=True, dropout=0.0,
                            mask=None)
    for d in tfa.KERNEL_HEAD_DIMS:
        assert tfa.supports((B, H, T, d), causal=True, dropout=0.0,
                            mask=None) == jfa.supports(
            (B, H, T, d), causal=True, dropout=0.0, mask=None)
    # packed: 384 is a multiple of 128 past the kernels' 256
    assert jfa.supports_qkv(2, T, 768, 2, dropout=0.0)
    assert not tfa.supports_qkv(2, T, 768, 2, dropout=0.0)
    assert tfa.supports_qkv(2, T, 512, 2, dropout=0.0) \
        == jfa.supports_qkv(2, T, 512, 2, dropout=0.0)

    from deeplearning4j_tpu_torch.nn.layers.attention import (
        dot_product_attention)
    rng = np.random.default_rng(96)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, sm_scale=1.0 / math.sqrt(D))
    to = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)


def test_dense_head_dim_route_is_counted_on_cuda(monkeypatch):
    """A CUDA call inside the JAX envelope whose head dim no kernel takes
    is counted and warned of once; a CPU call, a kernel head dim, or a
    shape outside the envelope is not. Only the device's type is read, so
    this runs without a card."""
    monkeypatch.setitem(tfa.DENSE_ROUTES, "head_dim", 0)
    monkeypatch.setattr(tfa, "_dense_warned", False)
    cuda = torch.device("cuda")
    kw = dict(causal=True, dropout=0.0, mask=None)
    assert not tfa.supports((1, 2, 512, 96), device=torch.device("cpu"),
                            **kw)
    assert tfa.supports((1, 2, 512, 128), device=cuda, **kw)
    assert not tfa.supports((1, 2, 256, 96), device=cuda, **kw)
    assert tfa.DENSE_ROUTES["head_dim"] == 0
    with pytest.warns(UserWarning, match="head dim 96"):
        assert not tfa.supports((1, 2, 512, 96), device=cuda, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not tfa.supports((1, 2, 1024, 384), device=cuda, **kw)
    assert tfa.DENSE_ROUTES["head_dim"] == 2


def _bf16_views(T=64, D=32, row=None, offset=0, dtype=torch.bfloat16):
    """A [1, 1, T, D] view into a flat buffer: rows `row` elements apart
    (default D), starting `offset` elements in."""
    row = D if row is None else row
    buf = torch.zeros(offset + T * row, dtype=dtype)
    return buf[offset:].as_strided((1, 1, T, D), (T * row, T * row, row, 1))


@pytest.mark.parametrize("name,match", [
    ("q", "base pointer of q "),
    ("k", "k's stride 36 in dimension 2"),
    ("o", "base pointer of o "),
    ("lse", "base pointer of lse "),
    ("kmask", "base pointer of kmask "),
])
def test_bf16_forward_refuses_misaligned_views(monkeypatch, name, match):
    """The bf16 forward copies rows into shared memory 16 bytes at a
    time, so its wrapper runs the backward's alignment check on q, k, v,
    o, lse and the key mask before it loads the kernel: a base pointer or
    stride off a 16-byte boundary raises a ValueError that names it. The
    f32 forward reads element by element and takes the same views. (The
    device check is stubbed so the CPU tensors reach the alignment
    check.)"""
    monkeypatch.setattr(tfa, "_check_launch", lambda *args: None)
    monkeypatch.setattr(tfa, "_kernel", lambda *args: pytest.fail(
        "the kernel was loaded"))
    T, D = 64, 32
    t = {"q": _bf16_views(), "k": _bf16_views(), "v": _bf16_views(),
         "o": _bf16_views(), "lse": torch.zeros(1, T),
         "kmask": torch.zeros(1, T)}
    if name in ("q", "o"):
        t[name] = _bf16_views(offset=1)
    elif name == "k":
        t[name] = _bf16_views(row=36)
    else:
        t[name] = torch.zeros(T + 1)[1:].view(1, T)
    with pytest.raises(ValueError, match=match):
        tfa._launch(t["q"], t["k"], t["v"], t["kmask"], t["o"], t["lse"],
                    1.0, True)
    f32 = _bf16_views(offset=1, row=33, dtype=torch.float32)
    tfa._check_bf16_alignment({"q": f32, "o": f32}, t["lse"], t["kmask"])
