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


def _binary_walk(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The two bisection loops of `_select_reference`, as written there,
    returning the final lo of each: the thresholds the plain version
    keeps (0 where a filter is off)."""
    k, p_top = tfs._modes(logits, top_k, top_p)
    lf = logits.float()
    B, V = lf.shape
    t = torch.full((1, 1), float(temperature), dtype=torch.float32)
    z = torch.div(lf - lf.amax(-1, keepdim=True), t)
    thr_k = thr_p = torch.zeros(B)
    if k:
        lo = z.amin(-1) - 1.0
        hi = torch.full((B,), 1e-6, dtype=torch.float32)
        for _ in range(tfs.BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            cnt = (z >= mid[:, None]).sum(-1)
            ge = cnt >= k
            lo = torch.where(ge, mid, lo)
            hi = torch.where(ge, hi, mid)
        thr_k = lo
    if p_top < 1.0:
        e = torch.exp(z)
        p = torch.div(e, e.sum(-1, keepdim=True))
        lo = torch.zeros(B, dtype=torch.float32)
        hi = p.amax(-1) + 1e-6
        top = torch.full((B,), p_top, dtype=torch.float32)
        for _ in range(tfs.BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            mass = torch.where(p >= mid[:, None], p, 0.0).sum(-1)
            ge = mass >= top
            lo = torch.where(ge, mid, lo)
            hi = torch.where(ge, hi, mid)
        thr_p = lo
    return thr_k, thr_p


WALK_MODES = [m for m in MODES if m.get("top_k") or m.get("top_p")]


@pytest.mark.parametrize("mode", WALK_MODES,
                         ids=lambda m: "-".join(f"{k}{v}"
                                                for k, v in m.items()))
def test_tree_walk_gives_the_plain_thresholds(mode):
    """K12 walks the bisections 4 levels a round: `_tree_bisect` (the
    plain model of that walk) at levels = 4 reaches `_select_reference`'s
    top-k and top-p thresholds bit for bit over 300 seeded rows."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy((3.0 * rng.normal(size=(300, 1000)))
                              .astype(np.float32))
    want = _binary_walk(logits, **mode)
    got = tfs._thresholds_reference(logits, levels=tfs.LEVELS, **mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(tfs._thresholds_reference(logits, levels=1, **mode)[0],
                       want[0])


@pytest.mark.parametrize("mode", WALK_MODES,
                         ids=lambda m: "-".join(f"{k}{v}"
                                                for k, v in m.items()))
@pytest.mark.parametrize("shape", [(300, 1000), (12, 10000), (20, 100)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_walk_model_gives_the_plain_thresholds(shape, mode):
    """The plain model of the kernel's whole walk (`_walk_model`: rounds
    of 4 levels while more than CAP = 128 elements lie in [lo, hi), then
    the last levels from the k-th largest z, or from where the running
    top-p sum reaches top_p) against `_select_reference`'s loops: the
    top-k thresholds bit for bit, and on these seeded rows the top-p ones
    too (they may part only where a mass lies within an ulp of top_p),
    at V = 1000 and 10000 (rounds, then the finish) and V = 100 (no
    round: at most CAP elements from the start)."""
    B, V = shape
    rng = np.random.default_rng(B + V)
    logits = torch.from_numpy((3.0 * rng.normal(size=shape))
                              .astype(np.float32))
    want = _binary_walk(logits, **mode)
    got = tfs._walk_model(logits, **mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plan_spreads_a_row_over_a_cluster():
    """8 blocks a row at the flagship's V = 10000, of 256 threads while
    every block of the launch has an SM of its own ([4, 10000]) and of
    128 beyond ([32, 10000]); one block of 128 up to V = 1024, about 8
    elements a thread in between."""
    assert tfs._plan(8, 128) == (128, 1) and tfs._plan(4, 1024) == (128, 1)
    assert tfs._plan(2, 4099) == (128, 5)
    assert tfs._plan(4, 10000) == (256, 8)
    assert tfs._plan(16, 10000) == (256, 8)
    assert tfs._plan(32, 10000) == (128, 8)
    assert tfs._plan(1, 1 << 20) == (256, tfs.MAX_CLUSTER)
    assert all(t in tfs.PLAN_THREADS for t, _ in (
        tfs._plan(b, v) for b in (1, 64) for v in (1, 5000, 99999)))


def test_launch_check_names_what_the_kernel_does_not_take():
    """The launch path's check builds its text only when it raises; on
    tensors the kernel does not take it still names the fault."""
    logits, noise = (torch.from_numpy(a) for a in _inputs(4, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        tfs._check(logits, noise)
    assert tfs.LAUNCHES["K12"] == 0
