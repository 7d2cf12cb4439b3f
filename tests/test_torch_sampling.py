"""The port's fused sampling (deeplearning4j_tpu_torch/ops/fused_sampling.py,
K12) against the JAX package's `fused_sample` on the CPU.

The same seeded numpy logits and Gumbel noise go to both. At [8, 128]
and [8, 256] the JAX call runs its Pallas kernel in interpret mode
(inside its `supports()` envelope); at [4, 10000] (the flagship's slots x
vocab) and [5, 100] it runs `_select_body` in jnp. The port runs its
plain version, the function its CUDA kernel computes on the card
(chip_smoke.py holds the kernel against it there). Tolerance: token ids
equal — both sides run the same f32 operations, and only the top-p mass
is a sum in another order, which moves a kept set only where a row's
nucleus mass lies within an ulp of top_p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_sampling as jfs
from deeplearning4j_tpu_torch.ops import fused_sampling as tfs

pytestmark = pytest.mark.port

SHAPES = ((8, 128), (8, 256), (4, 10000), (5, 100))
MODES = (
    dict(temperature=1.0),
    dict(temperature=0.8, top_k=8),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=1.0, top_k=8, top_p=0.9),
    dict(temperature=1.0, top_k=1000, top_p=0.5),
    dict(temperature=0.0),
)


def _inputs(B, V):
    rng = np.random.default_rng(B * 100003 + V)
    logits = (3.0 * rng.normal(size=(B, V))).astype(np.float32)
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    return logits, noise


@pytest.mark.parametrize("mode", MODES,
                         ids=lambda m: "-".join(f"{k}{v}"
                                                for k, v in m.items()))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_version_matches_jax(shape, dtype, mode):
    B, V = shape
    logits, noise = _inputs(B, V)
    want = np.asarray(jfs.fused_sample(
        jnp.asarray(logits).astype(dtype), jnp.asarray(noise), **mode))
    got = tfs.fused_sample(torch.from_numpy(logits).to(getattr(torch,
                                                               dtype)),
                           torch.from_numpy(noise), **mode)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_zero_is_argmax_and_launches_nothing():
    logits, noise = _inputs(4, 10000)
    before = dict(tfs.LAUNCHES)
    got = tfs.fused_sample(torch.from_numpy(logits), None, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    assert got.dtype == torch.int32 and tfs.LAUNCHES == before


def test_filters_keep_what_they_promise():
    """With a very cold temperature the noise cannot move the argmax off
    the kept set's top; with top_k=1 every draw is the row maximum; with
    a nucleus that one token fills, too."""
    logits, _ = _inputs(8, 256)
    t = torch.from_numpy(logits)
    gen = torch.Generator().manual_seed(3)
    top = logits.argmax(-1)
    for _ in range(5):
        noise = tfs.gumbel_noise(gen, 8, 256, "cpu")
        k1 = tfs.fused_sample(t, noise, temperature=1.0, top_k=1)
        np.testing.assert_array_equal(k1.numpy(), top)
        p_tiny = tfs.fused_sample(t, noise, temperature=1.0, top_p=1e-6)
        np.testing.assert_array_equal(p_tiny.numpy(), top)
        k8 = tfs.fused_sample(t, noise, temperature=1.0, top_k=8).numpy()
        ranks = (logits > logits[np.arange(8), k8][:, None]).sum(-1)
        assert (ranks < 8).all()


def test_gumbel_noise_draws_from_the_generator():
    a = tfs.gumbel_noise(torch.Generator().manual_seed(5), 64, 1000, "cpu")
    b = tfs.gumbel_noise(torch.Generator().manual_seed(5), 64, 1000, "cpu")
    c = tfs.gumbel_noise(torch.Generator().manual_seed(6), 64, 1000, "cpu")
    assert a.shape == (64, 1000) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())
    # the standard Gumbel: mean Euler's gamma, variance pi^2 / 6;
    # 64000 draws put the sample mean within 0.02 (4 standard errors)
    assert abs(float(a.mean()) - 0.5772) < 0.02
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.1


def test_supports_any_nonempty_shape():
    assert tfs.supports(1, 1) and tfs.supports(4, 10000)
    assert tfs.supports(8, 128) == jfs.supports(8, 128)
    assert not tfs.supports(0, 128) and not tfs.supports(4, 0)
