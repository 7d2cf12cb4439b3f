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
the cache dtype.

The int8 paged cache stores int8 codes plus one f32 scale per (row,
page, head), scale = maxabs / 127 (per-page symmetric quantization, the
JAX package's `*_q8` twins, also plain `lax` code there):

* `quantize_pages` / `dequantize_pages` — the codec; rounding is half to
  even on both sides (`torch.round` as `jnp.round`);
* `quantized_cache_update` — a write: gather the page-aligned window
  covering the new positions, dequantize, insert, zero past the write
  head (stale values of an earlier tenancy must not set the fresh page's
  scale), rescale and requantize, scatter back. Out-of-range positions
  (the inactive rows' scratch, a verify window running past capacity)
  are dropped, as JAX's scatter drops them, through a padding column and
  without a host sync;
* `cache_attention_q8` — `cache_attention` over the dequantized rows.
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


# ----------------------------------------------------- int8 paged cache

def quantize_pages(x, page_size: int):
    """Per-page symmetric int8 quantization of a cache tensor x [B, S, H,
    D] (S a page multiple) -> (codes int8 [B, S, H, D], scales f32
    [B, S // page_size, H]), scale = max(maxabs, 1e-8) / 127 per (row,
    page, head)."""
    B, S, H, D = x.shape
    xp = x.float().reshape(B, S // page_size, page_size, H, D)
    amax = xp.abs().amax(dim=(2, 4))
    scales = amax.clamp_min(1e-8) / 127.0
    codes = torch.round(xp / scales[:, :, None, :, None]).clamp(-127, 127)
    return codes.to(torch.int8).reshape(B, S, H, D), scales


def dequantize_pages(codes, scales, page_size: int):
    """Inverse of `quantize_pages` up to the rounding: codes int8 [B, S,
    H, D] times the per-page scales [B, S // page_size, H] -> f32."""
    B, S, H, D = codes.shape
    cp = codes.float().reshape(B, S // page_size, page_size, H, D)
    return (cp * scales[:, :, None, :, None]).reshape(B, S, H, D)


def quantized_cache_update(codes, scales, new_vals, rows, positions,
                           page_size: int):
    """Write new K (or V) values into an int8 paged cache, in place.

    codes [B, S, H, D] int8, scales [B, S // ps, H] f32; new_vals [b, T,
    H, D]; rows [b] (distinct cache rows); positions [b, T] (contiguous
    per row: a prefill chunk or a verify window). Positions past the
    capacity are dropped. Returns (codes, scales), the same tensors."""
    B, S, H, D = codes.shape
    b, T = positions.shape
    ps = page_size
    W = min(((T + ps - 1) // ps + 1) * ps, S)
    nw = W // ps
    dev = codes.device
    w0 = (positions.amin(1) // ps * ps).clamp(0, S - W)
    widx = w0[:, None] + torch.arange(W, device=dev)             # [b, W]
    pidx = (w0 // ps)[:, None] + torch.arange(nw, device=dev)    # [b, nw]
    r = rows[:, None]
    wvals = codes[r, widx].float() * scales[r, pidx].repeat_interleave(
        ps, dim=1)[..., None]                                    # [b, W, H, D]
    local = positions - w0[:, None]
    valid = (positions < S) & (local >= 0) & (local < W)
    # invalid entries land in a padding column W, cut off after the
    # scatter: JAX's scatter drops them, PyTorch's indexing would raise
    padded = torch.cat([wvals, wvals.new_zeros(b, 1, H, D)], dim=1)
    local = torch.where(valid, local, W)
    padded[torch.arange(b, device=dev)[:, None], local] = new_vals.float()
    wvals = padded[:, :W]
    # zero past this row's write head: those positions are invisible until
    # overwritten (key_limit), and stale values there would inflate the
    # page's maxabs and crush the fresh values' precision
    pos_max = torch.where(valid, positions, -1).amax(1)
    wvals = torch.where((widx > pos_max[:, None])[:, :, None, None], 0.0,
                        wvals)
    wq = wvals.reshape(b, nw, ps, H, D)
    new_scales = wq.abs().amax(dim=(2, 4)).clamp_min(1e-8) / 127.0
    qcodes = torch.round(wq / new_scales[:, :, None, :, None]).clamp(
        -127, 127).to(torch.int8).reshape(b, W, H, D)
    codes[r, widx] = qcodes
    scales[r, pidx] = new_scales
    return codes, scales


def cache_attention_q8(q, k_codes, v_codes, k_scale, v_scale, key_limit,
                       page_size: int):
    """Multi-query attention over an int8 paged cache: `cache_attention`
    on the rows dequantized (code times its page's scale, f32). Shapes as
    `cache_attention`, with the [B, S // page_size, H] scales beside the
    codes."""
    return cache_attention(q, dequantize_pages(k_codes, k_scale, page_size),
                           dequantize_pages(v_codes, v_scale, page_size),
                           key_limit)
