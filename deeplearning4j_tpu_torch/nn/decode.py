"""Incremental autoregressive decode with an explicit KV cache (JAX
counterpart deeplearning4j_tpu/nn/decode.py).

* ``make_decode_fn(net)`` — ``step(params, state, cache, token, pos) ->
  (probs, cache)``: one new token per cache row at its own position,
  single-query attention against the cache (ops/decode_attention.py).
* ``make_prefill_fn(net)`` — ``prefill(params, state, cache, tokens,
  kmask, rows, start, last_idx) -> (probs_last, cache)``: fills cache
  rows with a prompt chunk's K/V and returns the last real token's output
  row. Within-chunk attention goes through the flash kernel
  (`flash_attention_lse_masked`) when the chunk is inside its envelope,
  else `_dense_lse`; the cross-chunk half (chunk queries against the
  cache prefix written by earlier chunks) runs through `cache_attention`,
  and the two merge by the two-way lse combine.
* ``init_cache(net, batch, capacity)`` — zeroed per-attention-layer K/V
  ``{layer: {"k": [B, S, H, D], "v": ...}}`` in the net's compute dtype
  (the JAX package's "f32" cache kind, as opposed to its int8 cache,
  which comes with a later slice together with ``make_verify_fn``).

Unlike the JAX functions, which are pure, both steps write the cache in
place and return the same dict: the cache is the largest tensor serving
holds, and a copy per step would double its traffic.

Supported graphs: single-input/single-output stacks of time-pointwise
layers (dense / embedding / layernorm / output heads) plus causal
SelfAttention and PositionalEncoding; elementwise vertices ride along.
Anything else raises at build time, naming the layer.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertexConf,
    LayerVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    DenseLayer,
    EmbeddingLayer,
    LayerNormalization,
    PositionalEncodingLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.graph import cast_params, vertex_forward
from deeplearning4j_tpu_torch.nn.layers.attention import sinusoidal
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.decode_attention import cache_attention

_POINTWISE = (DenseLayer, EmbeddingLayer, LayerNormalization,
              BaseOutputLayer)

_NEG_INF = -1e30


# ------------------------------------------------------------- model plan

class _Op:
    """One traversal step: a layer or a non-layer vertex."""

    __slots__ = ("kind", "name", "conf", "impl", "preproc", "inputs")

    def __init__(self, kind, name, conf, impl, preproc, inputs):
        self.kind = kind
        self.name = name
        self.conf = conf
        self.impl = impl
        self.preproc = preproc
        self.inputs = inputs


def _plan(net):
    """-> (input_name, output_name, [_Op]), validating that every layer
    and vertex can decode one token at a time."""
    problems, ops = [], []
    ins, outs = net.conf.network_inputs, net.conf.network_outputs
    if len(ins) != 1 or len(outs) != 1:
        raise ValueError(
            "incremental decode needs a single-input/single-output graph; "
            f"this one has inputs {list(ins)} and outputs {list(outs)}")
    for name in net.topo:
        if name in ins:
            continue
        vconf = net.conf.vertices[name]
        inputs = list(net.conf.vertex_inputs[name])
        if isinstance(vconf, LayerVertexConf):
            lc = vconf.layer
            if not _decodable_layer(lc):
                problems.append(f"{name} ({type(lc).__name__})")
            ops.append(_Op("layer", name, lc, net.impls[name],
                           vconf.preprocessor, inputs))
        elif isinstance(vconf, ElementWiseVertexConf):
            ops.append(_Op("vertex", name, vconf, None, None, inputs))
        else:
            problems.append(f"{name} ({type(vconf).__name__})")
    if problems:
        raise ValueError(
            "incremental decode supports transformer stacks (pointwise "
            "layers + causal SelfAttention + PositionalEncoding); these "
            "cannot stream one token at a time: " + ", ".join(problems))
    return ins[0], outs[0], ops


def _decodable_layer(lc) -> bool:
    if isinstance(lc, SelfAttentionLayer):
        return bool(lc.causal)  # non-causal attention reads the future
    if isinstance(lc, PositionalEncodingLayer):
        return True
    return isinstance(lc, _POINTWISE)


def attention_specs(net):
    """[(layer_name, n_heads, head_dim)] for every attention layer — the
    cache layout contract init_cache allocates by."""
    _, _, ops = _plan(net)
    return [(op.name, op.conf.n_heads, op.conf.n_out // op.conf.n_heads)
            for op in ops
            if op.kind == "layer" and isinstance(op.conf,
                                                 SelfAttentionLayer)]


def init_cache(net, batch: int, capacity: int):
    """Zeroed KV cache {layer: {"k": [batch, capacity, H, D], "v": ...}}
    in the net's compute dtype, on the net's device. `capacity` is the
    per-row key budget (prompt + generated, page-quantized by the
    serving layer)."""
    dtype = net.compute_dtype
    return {name: {"k": torch.zeros((batch, capacity, H, D), dtype=dtype,
                                    device=net.device),
                   "v": torch.zeros((batch, capacity, H, D), dtype=dtype,
                                    device=net.device)}
            for name, H, D in attention_specs(net)}


def _cache_write(entry, k_new, v_new, rows, positions):
    """Write k_new/v_new [b, T, H, D] at (rows x positions [b, T]), in
    place. Positions past the cache's capacity are dropped, as the JAX
    scatter drops out-of-bounds indices."""
    S = entry["k"].shape[1]
    r = rows[:, None].expand_as(positions)
    keep = positions < S
    if not bool(keep.all()):
        r, positions = r[keep], positions[keep]
        k_new, v_new = k_new[keep], v_new[keep]
    entry["k"][r, positions] = k_new.to(entry["k"].dtype)
    entry["v"][r, positions] = v_new.to(entry["v"].dtype)


def _cache_attend(entry, qh, key_limit, rows=None):
    """Attend qh [b, H, Tq, D] against a cache entry with per-query
    visible-key bounds; `rows` gathers a row subset first (the prefill
    cross-chunk path)."""
    k, v = entry["k"], entry["v"]
    if rows is not None:
        k, v = k[rows], v[rows]
    return cache_attention(qh, k, v, key_limit)


# ------------------------------------------------------------ shared math

def _dense_lse(qh, kh, vh, kmask):
    """Within-chunk causal attention with (out, lse) for chunk shapes
    outside the flash envelope. qh/kh/vh [b, H, T, D]; kmask [b, T]. f32
    softmax like every other attention path."""
    D, T = qh.shape[-1], qh.shape[2]
    s = (qh.float() @ kh.float().transpose(-1, -2)) / (float(D) ** 0.5)
    cm = torch.ones(T, T, dtype=torch.bool, device=qh.device).tril()
    s = s.masked_fill(~cm, _NEG_INF)
    s = s.masked_fill(~kmask[:, None, None, :].bool(), _NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = (p @ vh.float()) / l.clamp_min(1e-30)[..., None]
    return o.to(qh.dtype), m + torch.log(l.clamp_min(1e-30))


def _chunk_self_lse(qh, kh, vh, kmask):
    """Within-chunk causal attention (out, lse), through the flash
    kernel when the chunk is inside its envelope."""
    b, H, T, D = qh.shape
    if fa.supports(qh.shape, causal=True, dropout=0.0, mask=kmask):
        # the flat [b*H, T, D] layout is b-major, so the key mask repeats
        # per head within each batch row
        km = kmask.float().repeat_interleave(H, dim=0)[:, None, :]
        o, lse = fa.flash_attention_lse_masked(
            qh.reshape(b * H, T, D), kh.reshape(b * H, T, D),
            vh.reshape(b * H, T, D), km, 1.0 / float(D) ** 0.5, True)
        return o.reshape(b, H, T, D), lse.reshape(b, H, T).float()
    return _dense_lse(qh, kh, vh, kmask)


def _merge_lse(o1, lse1, o2, lse2):
    """Two-way blockwise softmax merge: each part carries its own lse;
    a fully masked part (lse at the mask floor) weighs to zero. When
    both parts sit at the floor (the warmup's all-zero key mask) the
    weights are finite and the result is 0, not NaN."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = (w1 + w2).clamp_min(1e-30)[..., None]
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / denom
    return o.to(o1.dtype)


# -------------------------------------------------------------- the walk

def _walk(net, ops, in_name, out_name, params, state, x0, attn, posenc):
    """Topo traversal with inference semantics, attention and positional
    encoding routed to the supplied handlers. The containers' dtype
    policy: float inputs and per-layer params cast to the compute
    dtype."""
    cdtype = net.compute_dtype
    if x0.is_floating_point():
        x0 = x0.to(cdtype)
    acts = {in_name: x0}
    for op in ops:
        inputs = [acts[i] for i in op.inputs]
        if op.kind == "layer":
            x = inputs[0]
            if op.preproc is not None:
                x = op.preproc.pre_process(x)
            p = params.get(op.name, {})
            if cdtype != net.param_dtype:
                p = cast_params(p, cdtype)
            if isinstance(op.conf, SelfAttentionLayer):
                y = attn(op.name, op.conf, p, x)
            elif isinstance(op.conf, PositionalEncodingLayer):
                y = posenc(op.name, op.conf, p, x)
            else:
                y, _ = op.impl.apply(op.conf, p, state.get(op.name, {}), x)
            acts[op.name] = y
        else:
            acts[op.name] = vertex_forward(op.conf, inputs)
    return acts[out_name]


def _split_heads(t, H):
    b, T, n = t.shape
    return t.reshape(b, T, H, n // H)


def _as_seq(x):
    """Re-expand [B, d] to [B, 1, d]. EmbeddingImpl squeezes a [B, 1]
    index column to [B], so a single-token walk's activations can arrive
    2-D; adding a [B, 1, d] positional term to a 2-D [B, d] would
    broadcast to [B, B, d] and hand every row past 0 row 0's features.
    Every handler that mixes x with per-row position data goes through
    this first. The squeeze (nn/layers/feedforward.py) and this function
    change together."""
    return x[:, None, :] if x.ndim == 2 else x


def _positional(conf, p, x, positions):
    """The positional term at explicit positions [b, T] -> [b, T, d]."""
    if conf.learned:
        return p["pe"][positions]
    return sinusoidal(positions, x.shape[-1], x.dtype)


def _as_tensor(x, net, dtype=None):
    return torch.as_tensor(x, dtype=dtype, device=net.device)


# ------------------------------------------------------------ entry fns

def make_decode_fn(net):
    """-> ``step(params, state, cache, token, pos) -> (probs, cache)``.
    token [B] int; pos [B] int is the position the token OCCUPIES
    (0-based: a row whose prompt filled [0, L) decodes its first
    generated token at pos=L). probs [B, V] is the output layer's row for
    that token; the cache comes back with the token's K/V written at
    (row, pos)."""
    in_name, out_name, ops = _plan(net)

    @torch.no_grad()
    def step(params, state, cache, token, pos):
        token = _as_tensor(token, net, torch.long)
        pos = _as_tensor(pos, net, torch.long)
        B = token.shape[0]
        rows = torch.arange(B, device=net.device)
        positions = pos[:, None]                            # [B, 1]

        def attn(name, conf, p, x):
            H, n = conf.n_heads, conf.n_out
            Dh = n // H
            x = _as_seq(x)
            qkv = x[:, 0, :] @ p["Wqkv"] + p["bqkv"]        # [B, 3n]
            q, k_new, v_new = qkv.split(n, dim=-1)
            entry = cache[name]
            _cache_write(entry, k_new.reshape(B, 1, H, Dh),
                         v_new.reshape(B, 1, H, Dh), rows, positions)
            o, _ = _cache_attend(entry, q.reshape(B, H, 1, Dh),
                                 (pos + 1)[:, None])
            y = o[:, :, 0, :].reshape(B, n) @ p["Wo"] + p["bo"]
            return get_activation(conf.activation or "identity")(
                y)[:, None, :]

        def posenc(name, conf, p, x):
            x = _as_seq(x)
            return x + _positional(conf, p, x, positions)

        probs = _as_seq(_walk(net, ops, in_name, out_name, params, state,
                              token[:, None], attn, posenc))
        return probs[:, 0, :], cache

    return step


def make_prefill_fn(net):
    """-> ``prefill(params, state, cache, tokens, kmask, rows, start,
    last_idx) -> (probs_last, cache)``. tokens [b, Tc] int (a
    bucket-shaped prompt chunk, zero-padded); kmask [b, Tc] (1 = real
    token); rows [b] — which cache rows this chunk fills; start [b] —
    the global position of the chunk's first token (later chunks of a
    long prompt attend the cache prefix they already wrote); last_idx
    [b] — the LOCAL index of the last real token in this chunk, whose
    output row is returned. Padded positions write zero K/V and are
    overwritten as decode advances."""
    in_name, out_name, ops = _plan(net)

    @torch.no_grad()
    def prefill(params, state, cache, tokens, kmask, rows, start,
                last_idx):
        tokens = _as_tensor(tokens, net, torch.long)
        kmask = _as_tensor(kmask, net, torch.float32)
        rows = _as_tensor(rows, net, torch.long)
        start = _as_tensor(start, net, torch.long)
        last_idx = _as_tensor(last_idx, net, torch.long)
        b, Tc = tokens.shape
        local = torch.arange(Tc, device=net.device)
        positions = start[:, None] + local[None, :]         # [b, Tc]

        def attn(name, conf, p, x):
            H, n = conf.n_heads, conf.n_out
            x = _as_seq(x)
            qkv = x @ p["Wqkv"] + p["bqkv"]                 # [b, Tc, 3n]
            q, k, v = qkv.split(n, dim=-1)
            keep = kmask[..., None, None].to(k.dtype)
            entry = cache[name]
            _cache_write(entry, _split_heads(k, H) * keep,
                         _split_heads(v, H) * keep, rows, positions)
            qh = _split_heads(q, H).transpose(1, 2)         # [b, H, Tc, Dh]
            kh = _split_heads(k, H).transpose(1, 2)
            vh = _split_heads(v, H).transpose(1, 2)
            o1, lse1 = _chunk_self_lse(qh, kh, vh, kmask)
            # cross-chunk half: queries against the cache prefix this row
            # wrote before `start` (empty on the first chunk: its lse
            # sits at the floor and merges to weight zero)
            limit = start[:, None].expand(b, Tc)
            o2, lse2 = _cache_attend(entry, qh, limit, rows=rows)
            o = _merge_lse(o1, lse1, o2, lse2)
            y = o.transpose(1, 2).reshape(b, Tc, n)
            y = y @ p["Wo"] + p["bo"]
            return get_activation(conf.activation or "identity")(y)

        def posenc(name, conf, p, x):
            x = _as_seq(x)
            return x + _positional(conf, p, x, positions)

        probs = _as_seq(_walk(net, ops, in_name, out_name, params, state,
                              tokens, attn, posenc))
        return probs[torch.arange(b, device=net.device), last_idx, :], cache

    return prefill
