"""The port's chunked long-context tier (deeplearning4j_tpu_torch/ops/
flash_attention.py `chunked_flash_attention[_lse]`, `lse_combine` and
the envelope) against the JAX package on the CPU; the JAX kernels run
in interpret mode (under `jax.jit`, which compiles the tile loop once).

Forward, lse and gradients through (o, lse) with random cotangents of
both, so the lse cotangent (`dlse`) reaches every tile's backward, at
T = 640 in tiles of 128 (5 chunks: 15 causal tile pairs or 25
non-causal ones), with and without a padding mask and dropout, the
dropout seed handed to both as the same int32: f32 on both sides,
summed in another order and merged tile by tile, to 2e-5 absolute on
entries of O(1) (the JAX package's own chunked-vs-monolithic
tolerance). The envelope functions must equal the JAX package's over a
grid of lengths, head dims and causality, but for head dims outside
the port's kernels (`KERNEL_HEAD_DIMS`), which the port's chunked and
monolithic-fallback tiers refuse; the bucket lattice must accept and
refuse what the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn.layers.attention as tattn
from deeplearning4j_tpu.ops import autotune
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu.serving.buckets import BucketLattice as JaxLattice
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice

pytestmark = pytest.mark.port

ATOL = 2e-5
RATE = 0.1


def _ragged_mask(rng, rows, T):
    m = np.zeros((rows, T), np.float32)
    for r in range(rows - 1):
        m[r, :rng.integers(T // 4, T)] = 1.0
    return m


@pytest.mark.parametrize("causal,masked,dropout", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)])
def test_chunked_lse_matches_jax(causal, masked, dropout):
    """`chunked_flash_attention_lse` at T = 640, chunk = 128: o, lse and
    the gradients of <o, do> + <lse, dlse>; the dropout cases hash at
    window origin (128, 128) of a sequence of 1024, as a ring hop's
    tile would."""
    rng = np.random.default_rng(10 * causal + 2 * masked + dropout)
    BH, T, D = 2, 640, 32
    q, k, v, do = (rng.standard_normal((BH, T, D)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((BH, T)).astype(np.float32)
    km = _ragged_mask(rng, BH, T)[:, None, :] if masked else None
    scale = D ** -0.5
    seed = int(rng.integers(0, 2**31 - 1))
    kw = dict(chunk=128, dropout=RATE if dropout else 0.0)
    if dropout:
        kw.update(q_origin=128, k_origin=128, hash_t=1024)

    @jax.jit
    def jrun(q, k, v):
        (o, lse), vjp = jax.vjp(
            lambda q, k, v: jfa.chunked_flash_attention_lse(
                q, k, v, scale, causal,
                kmask=None if km is None else jnp.asarray(km),
                seed=jnp.asarray([[seed]], jnp.int32) if dropout else None,
                **kw),
            q, k, v)
        return (o, lse) + vjp((jnp.asarray(do), jnp.asarray(dlse)))

    want = [np.asarray(x) for x in jrun(q, k, v)]
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.chunked_flash_attention_lse(
        *ts, scale, causal, kmask=None if km is None else torch.from_numpy(km),
        seed=torch.tensor([seed], dtype=torch.int32) if dropout else None,
        **kw)
    torch.autograd.backward([o, lse], [torch.from_numpy(do),
                                       torch.from_numpy(dlse)])
    got = [o.detach().numpy(), lse.detach().numpy()] + [t.grad.numpy()
                                                        for t in ts]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_chunked_dropout_is_chunk_invariant_and_equals_the_whole_kernel():
    """One seed: tiles of 128 and of 256, and the whole-sequence kernel
    (`flash_attention` at T = 512), drop the same elements."""
    rng = np.random.default_rng(3)
    B, H, T, D = 1, 2, 512, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.ones(B, T)
    mask[0, 400:] = 0
    outs = [tfa.chunked_flash_attention(
        q, k, v, chunk=c, mask=mask, dropout=0.25,
        generator=torch.Generator().manual_seed(13)) for c in (128, 256)]
    whole = tfa.flash_attention(q, k, v, mask=mask, dropout=0.25,
                                generator=torch.Generator().manual_seed(13))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=ATOL,
                                   rtol=0)


def test_chunked_refuses_what_the_jax_package_refuses():
    q = torch.zeros(2, 640, 32)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.chunked_flash_attention_lse(q, q, q, 1.0, True, chunk=256)
    with pytest.raises(ValueError, match="requires a generator"):
        tfa.chunked_flash_attention(q[None], q[None], q[None], chunk=128,
                                    dropout=0.1)


LENGTHS = (512, 8192, 8320, 9216, 10240, 12288, 14336, 14464, 16384,
           24576, 32768, 65536, 131072, 139264, 262144)
HEAD_DIMS = (32, 64, 96, 128, 256, 512)


@pytest.mark.parametrize("causal", [True, False])
def test_envelope_matches_jax(causal):
    """pick_chunk, max_chunks, chunk_pairs, supports_chunked,
    supports_monolithic_fallback, servable_seq and
    chunked_unsupported_reason against the JAX package's; the port
    refuses a head dim outside KERNEL_HEAD_DIMS in the two tiers past
    MAX_FLASH_T and says why."""
    kw = dict(causal=causal, dropout=0.1, mask=None)
    assert tfa.max_chunks(causal) == jfa.max_chunks(causal)
    for n in range(1, 20):
        assert tfa.chunk_pairs(n, causal) == jfa.chunk_pairs(n, causal)
    for D in HEAD_DIMS + (None,):
        assert tfa.max_tile_for_dim(D) == autotune.max_tile_for_dim(D)
    for T in LENGTHS:
        for D in HEAD_DIMS:
            shape = (1, 2, T, D)
            assert (tfa.pick_chunk(T, causal, head_dim=D)
                    == jfa.pick_chunk(T, causal, head_dim=D))
            ported = D in tfa.KERNEL_HEAD_DIMS
            for fn in ("supports_chunked", "supports_monolithic_fallback"):
                want = getattr(jfa, fn)(shape, **kw) and ported
                assert getattr(tfa, fn)(shape, **kw) == want, (fn, T, D)
            want = jfa.servable_seq(T, D, causal=causal) and (
                ported or T <= tfa.MAX_FLASH_T)
            assert tfa.servable_seq(T, D, causal=causal) == want, (T, D)
            reason = tfa.chunked_unsupported_reason(
                T, dropout=0.1, mask=None, causal=causal, head_dim=D)
            jreason = jfa.chunked_unsupported_reason(
                T, dropout=0.1, mask=None, causal=causal, head_dim=D)
            if ported:
                assert reason == jreason
            else:
                assert f"take head dims {tfa.KERNEL_HEAD_DIMS}" in reason
        assert tfa.chunked_unsupported_reason(
            T, dropout=0.0, mask=None, causal=causal) \
            == jfa.chunked_unsupported_reason(T, dropout=0.0, mask=None,
                                              causal=causal)


def test_bucket_lattice_validates_as_the_jax_package():
    """Buckets 16384 and 32768 validate (the chunked tier takes them);
    14464, past the monolithic fallback and not tileable, raises the
    JAX package's message."""
    seq_lens = (512, 8192, 16384, 32768)
    for lattice in (BucketLattice((1,), seq_lens=seq_lens),
                    JaxLattice((1,), seq_lens=seq_lens)):
        lattice.validate_attention(128)
        lattice.validate_attention(64, causal=False, dropout=True)
    msgs = []
    for cls in (BucketLattice, JaxLattice):
        with pytest.raises(ValueError) as err:
            cls((1,), seq_lens=(512, 14464)).validate_attention(128)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "seq bucket 14464 is outside the attention dispatch" in msgs[0]


def _attention(T, D=32, H=2, **kw):
    """A SelfAttention layer's impl, conf and params at width H * D."""
    n = H * D
    conf = SelfAttentionLayer(n_in=n, n_out=n, n_heads=H, causal=True,
                              weight_init="xavier", **kw)
    impl = tattn.SelfAttentionImpl()
    params, state = impl.init(conf, torch.Generator().manual_seed(0),
                              torch.float32)
    return impl, conf, params, state


def test_layer_dispatch_ladder_past_max_flash_t(monkeypatch):
    """With MAX_FLASH_T lowered to 256 and the chunk tiles to (256,):
    T = 512 takes the chunked tier, with dropout from the layer's
    generator (and raises without one); T = 384 (no tiling, a multiple
    of 128 within the monolithic ceiling) the whole-sequence kernels; a
    head dim outside the kernels' raises the envelope's reason instead
    of taking the dense path."""
    for mod in (tfa, tattn):
        monkeypatch.setattr(mod, "MAX_FLASH_T", 256)
    monkeypatch.setattr(tfa, "CHUNK_TILES", (256,))
    routes = []
    for name in ("chunked_flash_attention", "flash_attention"):
        real = getattr(tattn, name)
        monkeypatch.setattr(
            tattn, name,
            lambda *a, _n=name, _f=real, **kw: routes.append(_n) or _f(*a,
                                                                     **kw))
    impl, conf, params, state = _attention(512, attention_dropout=0.1)
    x = torch.randn(1, 512, 64, generator=torch.Generator().manual_seed(1))
    out, _ = impl.apply(conf, params, state, x, train=True,
                        generator=torch.Generator().manual_seed(2))
    assert routes == ["chunked_flash_attention"]
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="requires a generator"):
        impl.apply(conf, params, state, x, train=True)
    out, _ = impl.apply(conf, params, state, x[:, :384])
    assert routes[-1] == "flash_attention" and out.shape == (1, 384, 64)
    impl, conf, params, state = _attention(512, D=48)
    with pytest.raises(ValueError, match="cannot be tiled"):
        impl.apply(conf, params, state, torch.zeros(1, 512, 96))
