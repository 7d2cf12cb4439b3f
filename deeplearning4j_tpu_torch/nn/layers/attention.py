"""Transformer building blocks: LayerNormalization, PositionalEncoding,
SelfAttention (JAX counterpart deeplearning4j_tpu/nn/layers/attention.py).

Forward for inference and training, differentiable by autograd.
SelfAttention keeps the JAX package's dispatch ladder: the
packed-projection flash kernels when `supports_qkv`, the flat flash
kernels when `supports`, the chunked flash tier past MAX_FLASH_T when
`supports_chunked`, the whole-sequence kernels for the lengths of
`supports_monolithic_fallback`, a ValueError for any other length past
MAX_FLASH_T, and the dense f32-softmax attention otherwise; the flash
routes carry their hand-written backward kernels
(ops/flash_attention.py). Dropout on the layer input and on the
attention weights draws from the caller's `torch.Generator`: on the
flash routes inside the kernels, from one step seed a call. Still to
come with later slices: sequence parallelism and ring attention.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerNormalization,
    PositionalEncodingLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.flash_attention import (
    MAX_FLASH_T,
    chunked_flash_attention,
    chunked_unsupported_reason,
    flash_attention,
    flash_attention_qkv,
    supports as flash_supports,
    supports_chunked as flash_supports_chunked,
    supports_monolithic_fallback as flash_supports_monolithic_fallback,
    supports_qkv as flash_supports_qkv,
)

NEG_INF = -1e30


@register_impl(LayerNormalization)
class LayerNormImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        n = conf.n_out or conf.n_in
        return {"gamma": torch.ones(n, dtype=dtype),
                "beta": torch.zeros(n, dtype=dtype)}, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        # jnp.var is the population variance
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        xn = (x - mu) * torch.rsqrt(var + conf.eps)
        return xn * params["gamma"] + params["beta"], state


def sinusoidal(positions, d, dtype):
    """Sinusoidal encodings at integer positions [...] -> [..., d], in
    f32 and cast at the end: the JAX package's `_sinusoidal` (full
    forward) and `_sinusoidal_at` (decode) in one function.

    The angle is the position times the reciprocal frequency, not the
    position over the frequency: that is what XLA compiles the JAX
    package's division by a constant into, and at positions near 1000
    the two roundings of the f32 angle move sin/cos by up to 6e-5."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    inv_freq = 1.0 / torch.pow(torch.tensor(10000.0, device=pos.device),
                               dim / d)
    angle = pos * inv_freq
    pe = torch.zeros(positions.shape + (d,), dtype=torch.float32,
                     device=pos.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle[..., : d // 2])
    return pe.to(dtype)


@register_impl(PositionalEncodingLayer)
class PositionalEncodingImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        if conf.learned:
            pe = 0.02 * torch.randn((conf.max_length, conf.n_features),
                                    generator=gen, dtype=dtype)
            return {"pe": pe}, {}
        return {}, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        T, d = x.shape[1], x.shape[2]
        if conf.learned:
            pe = params["pe"][:T]
        else:
            pe = sinusoidal(torch.arange(T, device=x.device), d, x.dtype)
        return x + pe, state


def dot_product_attention(q, k, v, *, causal, mask=None, dropout=0.0,
                          generator=None, train=False):
    """q, k, v: [B, H, T, D] -> [B, H, T, D]. Scores and softmax in f32,
    the weights cast to v's dtype for the product (the JAX package's
    `dot_product_attention`); attention-weight dropout while training."""
    d = q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) / (float(d) ** 0.5)
    T = q.shape[2]
    if causal:
        cm = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~cm, NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :].bool(), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if dropout and train and generator is not None:
        w = apply_dropout(w, dropout, generator, train=True)
    return (w.to(v.dtype) @ v).to(q.dtype)


@register_impl(SelfAttentionLayer)
class SelfAttentionImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        n_in, n = conf.n_in, conf.n_out
        return {
            "Wqkv": init_weights(gen, (n_in, 3 * n), conf.weight_init,
                                 conf.dist, dtype, fan_in=n_in, fan_out=n),
            "bqkv": torch.zeros(3 * n, dtype=dtype),
            "Wo": init_weights(gen, (n, n), conf.weight_init, conf.dist,
                               dtype),
            "bo": torch.zeros(n, dtype=dtype),
        }, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        B, T, _ = x.shape
        H = conf.n_heads
        n = conf.n_out
        D = n // H
        qkv = x @ params["Wqkv"] + params["bqkv"]              # [B, T, 3n]
        drop_attn = conf.attention_dropout if train else 0.0
        use_flash = conf.use_flash
        act = get_activation(conf.activation or "identity")
        if use_flash and flash_supports_qkv(B, T, n, H, dropout=drop_attn):
            # packed path: the kernels read each head's column slice of
            # the projection in place, no [B,T,H,D] relayout either way;
            # attention dropout runs in the kernels
            out = flash_attention_qkv(qkv, H, causal=conf.causal, mask=mask,
                                      dropout=drop_attn, generator=generator)
            return act(out @ params["Wo"] + params["bo"]), state
        qh, kh, vh = (t.unflatten(-1, (H, D)).transpose(1, 2)
                      for t in qkv.split(n, dim=-1))
        flash_kw = dict(causal=conf.causal, mask=mask, dropout=drop_attn,
                        generator=generator)
        if use_flash and flash_supports(qh.shape, causal=conf.causal,
                                        dropout=drop_attn, mask=mask,
                                        device=qh.device):
            out = flash_attention(qh, kh, vh, **flash_kw)
        elif use_flash and flash_supports_chunked(
                qh.shape, causal=conf.causal, dropout=drop_attn, mask=mask):
            # T beyond the whole-sequence envelope: chunk-length tiles
            # merged by their lse; masks and dropout ride the tiles
            out = chunked_flash_attention(qh, kh, vh, **flash_kw)
        elif (use_flash and T > MAX_FLASH_T
              and flash_supports_monolithic_fallback(
                  qh.shape, causal=conf.causal, dropout=drop_attn,
                  mask=mask)):
            # a length no tiling takes, at D <= 128: the whole-sequence
            # kernels
            out = flash_attention(qh, kh, vh, **flash_kw)
        elif use_flash and T > MAX_FLASH_T:
            # dense [T, T] scores at these lengths would exhaust device
            # memory: fail with the reason instead
            raise ValueError(chunked_unsupported_reason(
                T, dropout=drop_attn, mask=mask, causal=conf.causal,
                head_dim=D))
        else:
            out = dot_product_attention(
                qh, kh, vh, causal=conf.causal, mask=mask,
                dropout=conf.attention_dropout, generator=generator,
                train=train)
        out = out.transpose(1, 2).reshape(B, T, n)
        return act(out @ params["Wo"] + params["bo"]), state
