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
flash routes inside the kernels, from one step seed a call.

Inside a sequence-parallel step (ops/shard_scope.py: a `SeqShard` on the
conf's `seq_parallel_axis`) x is this shard's block of the sequence:
the positional encoding encodes its global positions and attention runs
the ring over the shard's transport (parallel/ring_attention.py), its
dropout step seeds from the generator the seq shards share. A layer a
"model" placement split (ops/shard_scope.py `layer_shard`) runs its
heads' share on each shard (`attention_shards`).
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
from deeplearning4j_tpu_torch.ops.shard_scope import (
    fold_slices,
    layer_shard,
    seq_shard,
    shard_generator,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    MAX_FLASH_T,
    _step_seed,
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
    # the base filled on the device: a tensor made from host data would
    # be a host->device copy, which syncs the host on every call
    inv_freq = 1.0 / torch.pow(torch.full((), 10000.0, device=pos.device),
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
        offset = 0
        seq = seq_shard(conf.seq_parallel_axis)
        if seq is not None:
            # x is this shard's block: encode its global positions (a
            # slice past the learned table would come back short)
            if conf.learned and seq.size * T > conf.max_length:
                raise ValueError(
                    f"global sequence {seq.size}x{T} exceeds learned "
                    f"positional table max_length={conf.max_length}")
            offset = seq.index * T
        if conf.learned:
            pe = params["pe"][offset:offset + T]
        else:
            pe = sinusoidal(torch.arange(offset, offset + T,
                                         device=x.device), d, x.dtype)
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
        shard = layer_shard(conf)
        if shard is not None:
            ps = shard.transport.pieces(params, shard.split, conf.n_heads)
            return attention_shards(conf, ps, x, shard.transport,
                                    train=train, generator=generator,
                                    mask=mask), state
        qkv = x @ params["Wqkv"] + params["bqkv"]              # [B, T, 3n]
        out = _attend(conf, qkv, conf.n_heads, train=train,
                      generator=generator, mask=mask)
        act = get_activation(conf.activation or "identity")
        return act(out @ params["Wo"] + params["bo"]), state


def _attend(conf, qkv, H, *, train, generator, mask, ring_seed=None):
    """Attention over H heads of the packed projection qkv [B, T, 3·H·D]
    (q | k | v, each head's D columns in a row): [B, T, H·D], the heads'
    outputs side by side, by the layer's dispatch ladder. `ring_seed`:
    the ring's dropout step seed under a sequence shard (drawn from the
    shard's ring generator when None)."""
    B, T, _ = qkv.shape
    D = conf.n_out // conf.n_heads
    n = H * D
    drop_attn = conf.attention_dropout if train else 0.0
    use_flash = conf.use_flash
    seq = seq_shard(conf.seq_parallel_axis)
    if (use_flash and seq is None
            and flash_supports_qkv(B, T, n, H, dropout=drop_attn)):
        # packed path: the kernels read each head's column slice of
        # the projection in place, no [B,T,H,D] relayout either way;
        # attention dropout runs in the kernels
        return flash_attention_qkv(qkv, H, causal=conf.causal, mask=mask,
                                   dropout=drop_attn, generator=generator)
    qh, kh, vh = (t.unflatten(-1, (H, D)).transpose(1, 2)
                  for t in qkv.split(n, dim=-1))
    flash_kw = dict(causal=conf.causal, mask=mask, dropout=drop_attn,
                    generator=generator)
    if seq is not None:
        # this shard's queries against the K/V blocks going round
        # the ring; no [T, T] scores anywhere
        if mask is not None:
            raise ValueError(
                "sequence-parallel attention does not support padding "
                "masks — pad to full length")
        from deeplearning4j_tpu_torch.parallel.ring_attention import (
            ring_attention_blocks,
        )

        ring = seq.transport
        # a ring of one block a rank, or an in-process ring whose n
        # blocks this call holds side by side along time
        blocks = len(ring.shards)
        outs = ring_attention_blocks(
            *(t.chunk(blocks, dim=2) for t in (qh, kh, vh)), ring,
            causal=conf.causal, dropout=drop_attn,
            generator=seq.ring_generator or generator, seed=ring_seed)
        out = outs[0] if blocks == 1 else torch.cat(outs, dim=2)
    elif use_flash and flash_supports(qh.shape, causal=conf.causal,
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
    return out.transpose(1, 2).reshape(B, T, n)


def attention_shards(conf, ps, x, transport, *, train=False, generator=None,
                     mask=None):
    """Self-attention with its heads split over the shards of
    `transport` (ops/shard_comm.py): ps[j] holds shard
    `transport.shards[j]`'s params — the q, k and v columns of its heads
    in Wqkv and bqkv (parallel/tensor_parallel.qkv_columns), their rows
    of Wo, and bo whole. x is the replicated input (its dropout drawn);
    each shard projects it, attends over its heads with the layer's
    kernels and multiplies by its rows of Wo; the partial products sum
    over the shards (Megatron's column- then row-parallel block). The
    attention dropout of shard j draws from `generator` folded with j
    (`shard_generator`). Under a sequence shard each shard's heads run
    the ring, whose keep masks hash global coordinates: one step seed
    from the ring generator (common to the seq shards of a sequence),
    folded for shard j past the slices of shards 0..j-1 (j·B·H_j,
    `fold_slices`), so no two heads of the layer share a mask and the
    seq shards of one head agree."""
    D = conf.n_out // conf.n_heads
    drop = train and conf.attention_dropout
    seq = seq_shard(conf.seq_parallel_axis)
    base = None
    if drop and seq is not None:
        base = _step_seed(seq.ring_generator or generator)
    parts = []
    for j, p, xj in zip(transport.shards, ps, transport.copy(x)):
        qkv = xj @ p["Wqkv"] + p["bqkv"]
        Hj = p["Wqkv"].shape[-1] // (3 * D)
        gen = (shard_generator(generator, (j,), transport.n)
               if drop and seq is None else generator)
        seed = (None if base is None
                else fold_slices(base, j * qkv.shape[0] * Hj))
        out = _attend(conf, qkv, Hj, train=train, generator=gen,
                      mask=mask, ring_seed=seed)
        parts.append(out @ p["Wo"])
    act = get_activation(conf.activation or "identity")
    return act(transport.reduce(parts) + ps[0]["bo"])
