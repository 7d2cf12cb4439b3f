"""Attention against a KV cache: the decode-side ops (JAX counterpart
deeplearning4j_tpu/ops/decode_attention.py).

* `cache_attention` — multi-query attention over a cache with a
  per-query visible-key bound; also the cross-chunk half of chunked
  prefill (nn/decode.py), which merges its (out, lse) with the
  within-chunk flash result.
* `decode_attention` — the single-query form a decode step runs.

The JAX package computes these with a blocked `lax.scan` at the XLA
level, not with a Pallas kernel, so the port's version is plain PyTorch:
one pass over the whole cache row, scores and softmax in f32 whatever
the cache dtype. The int8 paged cache (`cache_attention_q8`,
`quantized_cache_update`) comes with a later slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def cache_attention(q, k, v, key_limit):
    """q [B, H, Tq, D]; k, v [B, S, H, D] (cache layout: key position on
    axis 1); key_limit [B, Tq] — key j is visible to query (b, t) iff
    j < key_limit[b, t]. Returns (out [B, H, Tq, D] in q's dtype,
    lse [B, H, Tq] f32).

    Same arithmetic as the JAX scan: masked scores sit at -1e30 with no
    floor on the running max, so a row that sees no key at all averages
    the cache row uniformly and reports lse = -1e30 + log(S). Its lse is
    what matters: the prefill merge weighs such a part to exactly zero."""
    S, D = k.shape[1], k.shape[3]
    qf = q.float()
    kf = k.float().permute(0, 2, 3, 1)                     # [B, H, D, S]
    vf = v.float().transpose(1, 2)                         # [B, H, S, D]
    s = (qf @ kf) * (1.0 / float(D) ** 0.5)                # [B, H, Tq, S]
    idx = torch.arange(S, device=q.device)
    visible = idx[None, None, None, :] < key_limit[:, None, :, None]
    s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    out = (p @ vf) / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), m + torch.log(l.clamp_min(1e-30))


def decode_attention(q, k, v, pos):
    """Single-query decode attention: q [B, H, D] is the new token's
    query at position pos [B] per cache row; its own K/V must already be
    written at `pos`, so keys j <= pos are visible. Returns [B, H, D] in
    q's dtype."""
    out, _ = cache_attention(q[:, :, None, :], k, v, (pos + 1)[:, None])
    return out[:, :, 0, :]
