"""The port's flash-attention forward (deeplearning4j_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernels, run on
the CPU in interpret mode as the JAX package's own tests run them.

On a CPU tensor each port wrapper computes its plain PyTorch version
(`_flash_fwd_reference`), the same function the CUDA kernel computes on
the card; chip_smoke.py holds the kernel against it there. Tolerance:
both sides compute in float32, summing in another order, so outputs and
lse agree to 2e-5 absolute.
"""

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
