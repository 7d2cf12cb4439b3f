"""The port's model, full forward, cache attention, chunked prefill and
decode (deeplearning4j_tpu_torch/nn, ops/decode_attention.py) against
the JAX package on the CPU, on one small `transformer_lm` whose params
are copied across with `params_from_jax`.

Chunk 512 takes the flash route for the within-chunk attention (the JAX
package's Pallas kernel in interpret mode, the port's plain version of
its CUDA kernel); chunk 16 takes the dense route. Tolerance: float32 on
both sides, summed in another order: 1e-5 absolute on probabilities,
attention outputs and the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import (
    transformer_flops_per_token as jax_flops,
    transformer_lm as jax_lm,
)
from deeplearning4j_tpu.nn.conf.serde import to_dict as jax_to_dict
from deeplearning4j_tpu.ops.decode_attention import (
    cache_attention as jax_cache_attention,
)
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_flops_per_token as torch_flops,
    transformer_lm as torch_lm,
)
from deeplearning4j_tpu_torch.nn.conf.serde import (
    from_json as torch_from_json,
    to_dict as torch_to_dict,
)
from deeplearning4j_tpu_torch.ops.decode_attention import (
    cache_attention as torch_cache_attention,
)
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

ATOL = 1e-5
CFG = dict(vocab_size=64, d_model=128, n_heads=1, n_layers=2, d_ff=256,
           max_length=1024)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net) holding the same params."""
    jnet = jax_lm(**CFG).init()
    tnet = torch_lm(**CFG, device="cpu")
    tnet.params = params_from_jax(
        jax.tree.map(np.asarray, jnet.params), "cpu")
    tnet.state = {name: {} for name in tnet.params}
    return jnet, tnet


def _np(t):
    return t.detach().cpu().float().numpy()


def test_config_matches_jax():
    """Same vertices, layer fields and `@type` names as the JAX package's
    config, and the JAX package's JSON loads in the port unchanged."""
    jconf = jax_lm(**CFG).conf
    assert (torch_to_dict(torch_lm(**CFG, device="cpu").conf)
            == jax_to_dict(jconf))
    assert torch_to_dict(torch_from_json(jconf.to_json())) == jax_to_dict(
        jconf)
    assert (torch_flops(10000, 256, 6, 1024, 512)
            == jax_flops(10000, 256, 6, 1024, 512))


def test_init_shapes_and_scale_match_jax():
    """Init parity is distributional (the two packages' RNGs differ):
    the same params with the same shapes, and the xavier draws at the
    same scale."""
    jp = jax_lm(**CFG).init().params
    tp = torch_lm(**CFG, device="cpu").init(7).params
    assert sorted(jp) == sorted(tp)
    for layer in jp:
        assert sorted(jp[layer]) == sorted(tp[layer])
        for name in jp[layer]:
            assert tuple(jp[layer][name].shape) == tuple(
                tp[layer][name].shape)
    for layer, name in (("blk0_ff1", "W"), ("blk1_attn", "Wqkv"),
                        ("out", "W")):
        js, ts = float(np.std(jp[layer][name])), float(tp[layer][name].std())
        assert abs(js - ts) < 0.05 * js


@pytest.mark.parametrize("T", [512, 1024])
def test_full_forward_matches_jax(nets, T):
    """`output` at T = 512 takes the packed kernel (K2) and at T = 1024
    the flat kernel (K1) in both packages."""
    jnet, tnet = nets
    rng = np.random.default_rng(T)
    x = rng.integers(0, CFG["vocab_size"], (1, T)).astype(np.int32)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL,
                               rtol=0)


def test_cache_attention_matches_jax():
    """Per-query key limits, including a query that sees no key (its lse
    sits at the floor, which the prefill merge weighs to zero)."""
    rng = np.random.default_rng(0)
    B, H, Tq, S, D = 2, 2, 3, 48, 16
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    limit = np.array([[0, 5, 48], [17, 1, 33]], np.int64)
    jo, jl = jax_cache_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 jnp.asarray(limit, jnp.int32))
    to, tl = torch_cache_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(limit))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


def _chunks(L, chunk):
    """(start, n_real, padded length) of each prompt chunk: full chunks,
    then the remainder padded to a power of two (at least 16)."""
    out = []
    for s in range(0, L, chunk):
        n = min(chunk, L - s)
        out.append((s, n, chunk if n == chunk
                    else max(16, 1 << (n - 1).bit_length())))
    return out


@pytest.mark.parametrize("L,chunk", [(700, 512), (40, 16)])
def test_prefill_and_decode_match_jax(nets, L, chunk):
    """Chunked prefill into cache row 1 of 2, then three decode steps
    over both rows: the returned probs after every call and the final
    cache agree with the JAX package."""
    jnet, tnet = nets
    rng = np.random.default_rng(L)
    prompt = rng.integers(0, CFG["vocab_size"], L)
    capacity = 784
    jpre, jstep = jax.jit(jnet.prefill_fn()), jax.jit(
        jnet.incremental_decode_fn())
    tpre, tstep = tnet.prefill_fn(), tnet.incremental_decode_fn()
    jcache = jnet.init_kv_cache(2, capacity)
    tcache = tnet.init_kv_cache(2, capacity)
    row = np.array([1], np.int32)
    for s, n, Tb in _chunks(L, chunk):
        tokens = np.zeros((1, Tb), np.int32)
        tokens[0, :n] = prompt[s:s + n]
        kmask = np.zeros((1, Tb), np.float32)
        kmask[0, :n] = 1.0
        args = (tokens, kmask, row, np.array([s], np.int32),
                np.array([n - 1], np.int32))
        jp, jcache = jpre(jnet.params, jnet.state, jcache, *args)
        tp, tcache = tpre(tnet.params, tnet.state, tcache, *args)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=ATOL,
                                   rtol=0)
    tok = np.array([0, int(np.argmax(np.asarray(jp)[0]))], np.int32)
    pos = np.array([capacity - 1, L], np.int32)  # row 0: the scratch slot
    for _ in range(3):
        jp, jcache = jstep(jnet.params, jnet.state, jcache, tok, pos)
        tp, tcache = tstep(tnet.params, tnet.state, tcache, tok, pos)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jp, -1), np.int32)
        pos[1] += 1
    for layer in jcache:
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[layer][kv]),
                                       np.asarray(jcache[layer][kv]),
                                       atol=ATOL, rtol=0)


def test_all_masked_flash_prefill_is_finite(nets):
    """The engine's warmup prefills with an all-zero key mask. On the
    flash route both halves of the cross-chunk merge then sit at the
    lse floor; they must merge to zeros, not NaN."""
    _, tnet = nets
    T = 512
    cache = tnet.init_kv_cache(1, T + 16)
    probs, cache = tnet.prefill_fn()(
        tnet.params, tnet.state, cache, np.zeros((1, T), np.int32),
        np.zeros((1, T), np.float32), np.zeros(1, np.int32),
        np.zeros(1, np.int32), np.array([T - 1], np.int32))
    assert torch.isfinite(probs).all()
    assert all(float(e[kv].abs().max()) == 0.0
               for e in cache.values() for kv in ("k", "v"))
