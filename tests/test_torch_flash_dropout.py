"""In-kernel attention dropout of the port's flash kernels
(deeplearning4j_tpu_torch/ops/flash_attention.py, csrc/dropout.cuh)
against the JAX package's Pallas kernels on the CPU, run in interpret
mode as the JAX package's own tests run them.

The keep mask is a counter hash of each score element's global
coordinates and an int32 step seed: the port's `_keep_mask` (int64
arithmetic) must equal the JAX package's `_keep_mask` and its host
oracle `dropout_keep_mask_host` bit for bit, at nonzero window origins
and with the packed layout's b*H + h slice numbering. With the same
seed (handed to both as an int32), the dropout forward and gradients
then agree as the undropped ones do: f32 on both sides, summed in
another order, to 1e-5 absolute on entries of O(1). In bf16 the split
backward rounds P and dS to bf16 in both, so an entry may differ by one
bf16 rounding (2^-8 of the largest entry) on at most 1% of the entries,
as in tests/test_torch_flash_backward.py.

The 2-layer LM trains 3 Adam steps through the chunked tier with
dropout and a padding mask in both packages: MAX_FLASH_T and the chunk
tiles are lowered by monkeypatch so that T = 512 takes that tier at a
CPU size, and both packages' step-seed functions are patched to hand
out the same seed to each layer's attention call. After three steps
every param agrees to 2e-5, the key slice of bqkv (which gets no
gradient; see tests/test_torch_training.py) to 3 * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers.attention as jattn
import deeplearning4j_tpu_torch.nn.layers.attention as tattn
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.ops import autotune
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_lm as torch_lm,
)
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.weights_io import (
    params_from_jax,
    params_to_numpy,
)

pytestmark = pytest.mark.port

ATOL = 1e-5
RATE = 0.1


def _ragged_mask(rng, rows, T):
    """[rows, T] key mask: ragged valid prefixes, the last row all
    zero."""
    m = np.zeros((rows, T), np.float32)
    for r in range(rows - 1):
        m[r, :rng.integers(T // 4, T)] = 1.0
    return m


def _seeds(seed):
    """The same int32 step seed as the JAX [1, 1] operand and the port's
    one-element tensor."""
    return (jnp.asarray([[seed]], jnp.int32),
            torch.tensor([seed], dtype=torch.int32))


@pytest.mark.parametrize("seed,rate,T", [(987654321, 0.3, 640),
                                         (0, 0.1, 256),
                                         (2**31 - 2, 0.5, 384)])
def test_keep_mask_matches_jax_bit_for_bit(seed, rate, T):
    """Whole slices against the host oracle, and windows at nonzero
    (even u32-wrapping) origins with G = 2 slices a stride apart (the
    packed layout's b*H + h numbering) against the kernels' own
    `_keep_mask`."""
    for bh in (0, 5, 65599):
        np.testing.assert_array_equal(
            tfa.dropout_keep_mask_host(seed, bh, T, rate).numpy(),
            jfa.dropout_keep_mask_host(seed, bh, T, rate))
    jseed, tseed = _seeds(seed)
    for bh0, stride, q0, k0, bq, bk, hash_t in (
            (0, 1, 0, 0, 128, 128, T),
            (3, 4, 13952, 640, 64, 128, 16384),
            (7, 2, 8192, 0, 128, 64, 32768),
            (1, 3, 100000, 70000, 32, 96, 131071)):
        want = np.asarray(jfa._keep_mask(jseed[0, 0], bh0, stride, 2, q0, k0,
                                         bq, bk, hash_t, rate))
        got = tfa._keep_mask(tseed, torch.tensor([bh0, bh0 + stride]), q0,
                             k0, bq, bk, hash_t, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_keep_threshold_and_scale_are_the_references():
    for rate in (0.1, 0.15, 0.3, 1e-9):
        assert tfa.keep_threshold(rate) == min(
            int((1.0 - rate) * 4294967296.0), 4294967295)
        assert tfa.keep_scale(rate) == float(
            np.float32(1.0) * (1.0 / (1.0 - rate)))
        assert np.float32(tfa.keep_scale(rate)) == tfa.keep_scale(rate)


def _jax_vjp(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_vjp(fn, inputs, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("T,D,masked", [(512, 64, True), (640, 128, False),
                                        (640, 64, True)])
def test_flat_dropout_matches_jax(T, D, masked):
    """K1 forward and K4/K5 backward with the keep mask: `_flash_core_drop`
    against `_FlashCore` with the same seed, at T = 512 (the JAX
    package's single-block kernels) and T = 640 (its blocked loop and
    dq/dkv split)."""
    rng = np.random.default_rng(T + D + masked)
    BH = 3
    q, k, v, cot = (rng.standard_normal((BH, T, D)).astype(np.float32)
                    for _ in range(4))
    km = (_ragged_mask(rng, BH, T) if masked
          else np.ones((BH, T), np.float32))[:, None, :]
    scale = D ** -0.5
    jseed, tseed = _seeds(int(rng.integers(0, 2**31 - 1)))
    ctx = jfa._drop_ctx(jseed)
    jo, jg = _jax_vjp(
        lambda q, k, v: jfa._flash_core_drop(q, k, v, jnp.asarray(km), ctx,
                                             scale, True, RATE),
        [q, k, v], cot)
    to, tg = _torch_vjp(
        lambda q, k, v: tfa._FlashCore.apply(
            q, k, v, torch.from_numpy(km) if masked else None, scale, True,
            tfa._Drop(tseed, RATE)),
        [q, k, v], cot)
    for got, want in zip([to] + tg, [jo] + jg):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if masked:  # the all-masked row: zero output and gradients
        assert np.all(to[-1] == 0.0) and all(np.all(g[-1] == 0.0)
                                             for g in tg)


@pytest.mark.parametrize("H,D,masked", [(1, 128, True), (2, 64, False),
                                        (2, 64, True)])
def test_packed_dropout_matches_jax(H, D, masked):
    """K2/K6 (D = 128) and K3/K7 (D = 64, the JAX package's head-pair
    kernels) with the keep mask: `_flash_qkv_core_drop` against
    `_FlashQkvCore` at T = 512; slice b*H + h hashes as bh in both."""
    rng = np.random.default_rng(200 + D + masked)
    B, T = 2, 512
    n = H * D
    qkv = rng.standard_normal((B, T, 3 * n)).astype(np.float32)
    cot = rng.standard_normal((B, T, n)).astype(np.float32)
    km = (_ragged_mask(rng, B, T) if masked
          else np.ones((B, T), np.float32))[:, None, :]
    scale = D ** -0.5
    jseed, tseed = _seeds(int(rng.integers(0, 2**31 - 1)))
    jo, (jg,) = _jax_vjp(
        lambda x: jfa._flash_qkv_core_drop(x, jnp.asarray(km),
                                           jfa._drop_ctx(jseed), H, scale,
                                           True, RATE),
        [qkv], cot)
    to, (tg,) = _torch_vjp(
        lambda x: tfa._FlashQkvCore.apply(
            x, torch.from_numpy(km) if masked else None, H, scale, True,
            tfa._Drop(tseed, RATE)),
        [qkv], cot)
    for got, want in ((to, jo), (tg, jg)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_split_backward_dropout_bf16_matches_jax():
    """bf16 operands with the keep mask at window origin (256, 0) of a
    sequence of 1024: the port's `_flash_bwd_impl` against the JAX
    package's dq/dkv split kernels (forced by `autotune.override`) on
    the same q, k, v, o, lse and do, where both round P (dropped) and dS
    to bf16."""
    rng = np.random.default_rng(41)
    BH, T, D = 2, 256, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, T, D))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = D ** -0.5
    jseed, tseed = _seeds(123456789)
    drop = tfa._Drop(tseed, RATE, 256, 0, 1024)
    o, lse = tfa._flash_fwd_reference(q, k, v, None, scale, True, drop)

    def jx(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    with autotune.override({"flash_bwd": {"block_q": 128, "block_k": 128}}):
        want = jfa._flash_bwd_impl(
            jx(q), jx(k), jx(v), jx(o), jx(lse), jx(do), None, scale, True,
            dropout=RATE, seed=jfa._drop_ctx(jseed, 256, 0), hash_t=1024)
    got = tfa._flash_bwd_impl(q, k, v, o, lse, do, None, scale, True,
                              drop=drop)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max()
        assert (g != w).mean() <= 0.01


def test_flat_and_packed_layouts_drop_the_same_elements():
    """One generator seed: the packed entry point and the flat one give
    the same attention, and a second draw from the generator another
    mask."""
    rng = np.random.default_rng(5)
    B, H, T, D = 2, 2, 512, 64
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D))
                           .astype(np.float32))
    qh, kh, vh = (t.unflatten(-1, (H, D)).transpose(1, 2)
                  for t in qkv.split(H * D, dim=-1))
    packed = tfa.flash_attention_qkv(
        qkv, H, dropout=RATE, generator=torch.Generator().manual_seed(3))
    flat = tfa.flash_attention(
        qh, kh, vh, dropout=RATE, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(packed.numpy(),
                               flat.transpose(1, 2).reshape(B, T, -1).numpy(),
                               atol=ATOL, rtol=0)
    gen = torch.Generator().manual_seed(3)
    first = tfa.flash_attention(qh, kh, vh, dropout=RATE, generator=gen)
    second = tfa.flash_attention(qh, kh, vh, dropout=RATE, generator=gen)
    assert not torch.equal(first, second)


def test_step_seed_is_an_int32_drawn_from_the_generator():
    a = tfa._step_seed(torch.Generator().manual_seed(9))
    b = tfa._step_seed(torch.Generator().manual_seed(9))
    assert a.dtype == torch.int32 and a.shape == (1,)
    assert torch.equal(a, b) and 0 <= int(a) < 2**31 - 1


# ----------------------------------------- 3 steps through the chunked tier

CFG = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128)
SEEDS = (1234567, 2**31 - 5)  # one a layer, the same every step
ADAM_LR = 3e-4
PARAM_ATOL = 2e-5


def test_fit_chunked_dropout_route_matches_jax(monkeypatch):
    """transformer_lm (2 layers, 2 heads of 32) at T = 512 with
    attention dropout 0.1 and a ragged padding mask, MAX_FLASH_T lowered
    to 256 and the chunk tiles to (256, 128) in both packages: each
    attention call takes the chunked tier (2 chunks, 3 causal tile
    pairs), with the same seed in both packages."""
    for mod in (jfa, tfa, jattn, tattn):
        monkeypatch.setattr(mod, "MAX_FLASH_T", 256)
    for mod in (jfa, tfa):
        monkeypatch.setattr(mod, "CHUNK_TILES", (256, 128))
    calls = {"jax": 0, "torch": 0}

    def jax_seed(rng):
        calls["jax"] += 1
        return jnp.asarray([[SEEDS[(calls["jax"] - 1) % 2]]], jnp.int32)

    def torch_seed(generator):
        calls["torch"] += 1
        return torch.tensor([SEEDS[(calls["torch"] - 1) % 2]],
                            dtype=torch.int32)

    monkeypatch.setattr(jfa, "_step_seed", jax_seed)
    monkeypatch.setattr(tfa, "_step_seed", torch_seed)
    chunked = []
    real = tattn.chunked_flash_attention
    monkeypatch.setattr(tattn, "chunked_flash_attention",
                        lambda *a, **kw: chunked.append(1) or real(*a, **kw))

    T = 512
    jnet = jax_lm(**CFG, max_length=T, attention_dropout=0.1).init()
    tnet = torch_lm(**CFG, max_length=T, attention_dropout=0.1,
                    device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    jl, tl = [], []
    for step in range(3):
        rng = np.random.default_rng(50 + step)
        toks = rng.integers(0, CFG["vocab_size"], (2, T)).astype(np.int32)
        mask = (np.arange(T)[None, :]
                < np.array([[T], [T // 2 + 77]])).astype(np.float32)
        labels = np.roll(toks, -1, axis=1)
        jnet.fit(JDataSet(toks, labels, features_mask=mask))
        tnet.fit(TDataSet(toks, labels, features_mask=mask))
        jl.append(jnet.score_value)
        tl.append(tnet.score_value)
    assert len(chunked) == 3 * CFG["n_layers"]
    assert calls["torch"] == 3 * CFG["n_layers"] and calls["jax"] >= 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    for layer in jp:
        for name in jp[layer]:
            diff = np.abs(tp[layer][name] - jp[layer][name])
            if name == "bqkv":  # the key slice: no gradient in either
                n = diff.shape[0] // 3
                assert diff[n:2 * n].max() <= 3 * ADAM_LR * 1.001
                diff = np.concatenate([diff[:n], diff[2 * n:]])
            assert diff.max() <= PARAM_ATOL, (layer, name, diff.max())
