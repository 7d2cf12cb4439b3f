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
* ``make_verify_fn(net)`` — ``verify(params, state, cache, tokens, pos)
  -> (probs, cache)``, the speculative verification step: K tokens per
  row at positions ``pos..pos+K-1`` in one fixed-shape call. All K keys
  are written before attending and query row i attends with ``key_limit
  = pos+i+1`` (causal, self included), so row i equals what i+1
  sequential decode steps give on the same inputs. A rejected draft's
  stale K/V stays invisible (key_limit) until the next window, which
  starts at or before it, overwrites it.
* ``init_cache(net, batch, capacity)`` — zeroed per-attention-layer K/V
  ``{layer: {"k": [B, S, H, D], "v": ...}}`` in the net's compute dtype.

Every entry fn and ``init_cache`` take ``kv_dtype`` ("f32" | "int8") and
``page_size``: the int8 paged cache stores codes plus per-(row, page,
head) f32 scales (``{"k", "k_scale", "v", "v_scale"}`` entries), writes
through ops/decode_attention.quantized_cache_update and attends through
`cache_attention_q8`.

Unlike the JAX functions, which are pure, the steps write the cache in
place and return the same dict: the cache is the largest tensor serving
holds, and a copy per step would double its traffic. Positions past the
cache's capacity (the inactive rows' scratch never is; a verify window
near the end of a row can be) are dropped, as JAX's scatter drops them.
Which writes survive is worked out once per step on the host, from the
positions the caller passes, so no layer waits on the device for it.

Supported nets, either container: single-input/single-output stacks of
time-pointwise layers (dense / embedding / layernorm / output heads /
activation / dropout) plus causal SelfAttention and PositionalEncoding;
elementwise, merge, scale and subset vertices ride along. Anything else
raises at build time, naming the layer (a MoE layer too, as in the JAX
package).

A net whose layers a "model" placement split (set_mesh, one shard a
rank; or `parallel.tensor_parallel.place_in_process`, n shards in this
process) decodes split: the dense layers, the embedding and the head run
their split forms (nn/layers/feedforward.py), and a split attention
layer runs each held shard's heads on that shard's q, k and v columns
against a cache entry of its own — `init_cache` gives such a layer one
entry a held shard, [B, S, H/n, D] each, so a shard's cache holds its
heads only — then multiplies by the shard's rows of Wo and sums the
partial products over the shards (the row-parallel reduction), once a
layer a step.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertexConf,
    LayerVertexConf,
    MergeVertexConf,
    ScaleVertexConf,
    SubsetVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BaseOutputLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    LayerNormalization,
    PositionalEncodingLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.graph import cast_params, vertex_forward
from deeplearning4j_tpu_torch.nn.layers.attention import sinusoidal
from deeplearning4j_tpu_torch.nn.training import tree_cast  # noqa: F401
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.shard_scope import layer_shard
from deeplearning4j_tpu_torch.ops.decode_attention import (
    cache_attention,
    cache_attention_q8,
    quantized_cache_update,
)

_POINTWISE = (DenseLayer, EmbeddingLayer, LayerNormalization,
              BaseOutputLayer, ActivationLayer, DropoutLayer)

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
    """-> (input_name, output_name, [_Op]) for either container,
    validating that every layer and vertex can decode one token at a
    time."""
    problems, ops = [], []
    if hasattr(net, "layer_vertices"):
        ins, outs = net.conf.network_inputs, net.conf.network_outputs
        if len(ins) != 1 or len(outs) != 1:
            raise ValueError(
                "incremental decode needs a single-input/single-output "
                f"graph; this one has inputs {list(ins)} and outputs "
                f"{list(outs)}")
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
            elif isinstance(vconf, (ElementWiseVertexConf, MergeVertexConf,
                                    ScaleVertexConf, SubsetVertexConf)):
                ops.append(_Op("vertex", name, vconf, None, None, inputs))
            else:
                problems.append(f"{name} ({type(vconf).__name__})")
        in_name, out_name = ins[0], outs[0]
    else:
        prev = "__input__"
        for i, (name, lc, impl) in enumerate(zip(
                net.layer_names, net.layer_confs, net.impls)):
            if not _decodable_layer(lc):
                problems.append(f"{name} ({type(lc).__name__})")
            ops.append(_Op("layer", name, lc, impl,
                           net.conf.get_preprocessor(i), [prev]))
            prev = name
        in_name, out_name = "__input__", prev
    if problems:
        raise ValueError(
            "incremental decode supports transformer stacks (pointwise "
            "layers + causal SelfAttention + PositionalEncoding); these "
            "cannot stream one token at a time: " + ", ".join(problems))
    return in_name, out_name, ops


def _decodable_layer(lc) -> bool:
    if isinstance(lc, SelfAttentionLayer):
        return bool(lc.causal)  # non-causal attention reads the future
    if isinstance(lc, PositionalEncodingLayer):
        return True
    return isinstance(lc, _POINTWISE)


def _cache_layout(net):
    """[(layer_name, n_heads, heads of each cache entry or None,
    head_dim)] for every attention layer: None for a whole layer (one
    entry of all its heads), else the heads of each shard this process
    holds of a split one."""
    _, _, ops = _plan(net)
    out = []
    for op in ops:
        if op.kind != "layer" or not isinstance(op.conf, SelfAttentionLayer):
            continue
        H, D = op.conf.n_heads, op.conf.n_out // op.conf.n_heads
        shard = layer_shard(op.conf)
        split = (None if shard is None else
                 [H // shard.transport.n] * len(shard.transport.shards))
        out.append((op.name, H, split, D))
    return out


def attention_specs(net):
    """[(layer_name, n_heads, head_dim)] for every attention layer — the
    cache layout contract init_cache allocates by; a split layer counts
    the heads of the shards this process holds."""
    return [(name, sum(split) if split else H, D)
            for name, H, split, D in _cache_layout(net)]


def init_cache(net, batch: int, capacity: int, kv_dtype: str = "f32",
               page_size: int = 16):
    """Zeroed KV cache {layer: {"k": [batch, capacity, H, D], "v": ...}}
    in the net's compute dtype, on the net's device (a split layer: a
    list of such entries, one a held shard, of its heads). `capacity` is
    the per-row key budget (prompt + generated, page-quantized by the
    serving layer). kv_dtype="int8" stores int8 codes plus per-(row,
    page, head) f32 scales ({"k", "k_scale", "v", "v_scale"}); capacity
    must then sit on the page grid."""
    dev = net.device
    if kv_dtype == "int8" and capacity % page_size != 0:
        raise ValueError(
            f"int8 cache needs page-quantized capacity; {capacity} "
            f"is not a multiple of page_size {page_size}")

    def entry(H, D):
        if kv_dtype == "int8":
            n_pages = capacity // page_size
            return {
                "k": torch.zeros((batch, capacity, H, D), dtype=torch.int8,
                                 device=dev),
                "k_scale": torch.zeros((batch, n_pages, H), device=dev),
                "v": torch.zeros((batch, capacity, H, D), dtype=torch.int8,
                                 device=dev),
                "v_scale": torch.zeros((batch, n_pages, H), device=dev)}
        dtype = net.compute_dtype
        return {"k": torch.zeros((batch, capacity, H, D), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((batch, capacity, H, D), dtype=dtype,
                                 device=dev)}

    return {name: (entry(H, D) if split is None
                   else [entry(h, D) for h in split])
            for name, H, split, D in _cache_layout(net)}


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


class _Writes:
    """Where one step's new K/V rows go: `rows` [b] and `positions`
    [b, T] on the device (the int8 update takes them as they are and
    drops out-of-range positions itself), and the flat (row, position)
    pairs that survive the capacity, with `sel` picking their values out
    of the flattened [b * T] new rows (None: all survive). Built on the
    host from host positions, once per step."""

    __slots__ = ("rows", "positions", "flat_rows", "flat_pos", "sel")

    def __init__(self, rows, positions, capacity: int, device):
        rows, positions = _host(rows), _host(positions)
        r = np.repeat(rows, positions.shape[1])
        p = positions.reshape(-1)
        keep = p < capacity
        self.sel = None
        if not keep.all():
            self.sel = torch.as_tensor(np.flatnonzero(keep), device=device)
            r, p = r[keep], p[keep]
        self.rows = torch.as_tensor(rows, dtype=torch.long, device=device)
        self.positions = torch.as_tensor(positions, dtype=torch.long,
                                         device=device)
        self.flat_rows = torch.as_tensor(r, dtype=torch.long, device=device)
        self.flat_pos = torch.as_tensor(p, dtype=torch.long, device=device)


def _capacity(cache) -> int:
    entry = next(iter(cache.values()))
    return (entry[0] if isinstance(entry, list) else entry)["k"].shape[1]


def _head_groups(conf, p, entry, x):
    """The shards an attention layer computes in this process: [(params,
    cache entry, heads, input)] — the whole layer, or each held shard of
    a split one (its q, k, v columns and Wo rows, its cache entry) — and
    the transport whose `reduce` sums the shards' partial products (None
    for a whole layer)."""
    shard = layer_shard(conf)
    if shard is None:
        return [(p, entry, conf.n_heads, x)], None
    tr = shard.transport
    ps = tr.pieces(p, shard.split, conf.n_heads)
    H = conf.n_heads // tr.n
    return [(pj, ej, H, xj)
            for pj, ej, xj in zip(ps, entry, tr.copy(x))], tr


def _out_proj(conf, p, ys, tr):
    """Each shard's attention rows [..., H_j·D] through its rows of Wo,
    summed over the shards, then bo and the activation."""
    parts = [y @ pj["Wo"] for y, pj in ys]
    y = (parts[0] if tr is None else tr.reduce(parts)) + p["bo"]
    return get_activation(conf.activation or "identity")(y)


def _cache_write(entry, k_new, v_new, writes: _Writes, kv_dtype,
                 page_size):
    """Write k_new/v_new [b, T, H, D] at `writes`, in place —
    dtype-dispatched. Positions past the capacity are dropped on both
    paths."""
    if kv_dtype == "int8":
        quantized_cache_update(entry["k"], entry["k_scale"], k_new,
                               writes.rows, writes.positions, page_size)
        quantized_cache_update(entry["v"], entry["v_scale"], v_new,
                               writes.rows, writes.positions, page_size)
        return
    for key, new in (("k", k_new), ("v", v_new)):
        flat = new.reshape(-1, *new.shape[2:])
        if writes.sel is not None:
            flat = flat[writes.sel]
        entry[key][writes.flat_rows, writes.flat_pos] = flat.to(
            entry[key].dtype)


def _cache_attend(entry, qh, key_limit, kv_dtype, page_size, rows=None):
    """Attend qh [b, H, Tq, D] against a cache entry with per-query
    visible-key bounds — dtype-dispatched; `rows` gathers a row subset
    first (the prefill cross-chunk path)."""
    k, v = entry["k"], entry["v"]
    if kv_dtype == "int8":
        ks, vs = entry["k_scale"], entry["v_scale"]
        if rows is not None:
            k, v, ks, vs = k[rows], v[rows], ks[rows], vs[rows]
        return cache_attention_q8(qh, k, v, ks, vs, key_limit, page_size)
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
    if fa.supports(qh.shape, causal=True, dropout=0.0, mask=kmask,
                   device=qh.device):
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

def make_decode_fn(net, kv_dtype: str = "f32", page_size: int = 16):
    """-> ``step(params, state, cache, token, pos) -> (probs, cache)``.
    token [B] int; pos [B] int is the position the token OCCUPIES
    (0-based: a row whose prompt filled [0, L) decodes its first
    generated token at pos=L). probs [B, V] is the output layer's row for
    that token; the cache comes back with the token's K/V written at
    (row, pos)."""
    in_name, out_name, ops = _plan(net)

    @torch.no_grad()
    def step(params, state, cache, token, pos):
        B = len(token)
        pos_h = _host(pos)
        writes = _Writes(np.arange(B), pos_h[:, None], _capacity(cache),
                         net.device)
        token = _as_tensor(token, net, torch.long)
        positions = writes.positions                        # [B, 1]

        def attn(name, conf, p, x):
            Dh = conf.n_out // conf.n_heads
            groups, tr = _head_groups(conf, p, cache[name], _as_seq(x))
            ys = []
            for pj, entry, H, xj in groups:
                n = H * Dh
                qkv = xj[:, 0, :] @ pj["Wqkv"] + pj["bqkv"]  # [B, 3n]
                q, k_new, v_new = qkv.split(n, dim=-1)
                _cache_write(entry, k_new.reshape(B, 1, H, Dh),
                             v_new.reshape(B, 1, H, Dh), writes, kv_dtype,
                             page_size)
                o, _ = _cache_attend(entry, q.reshape(B, H, 1, Dh),
                                     positions + 1, kv_dtype, page_size)
                ys.append((o[:, :, 0, :].reshape(B, n), pj))
            return _out_proj(conf, p, ys, tr)[:, None, :]

        def posenc(name, conf, p, x):
            x = _as_seq(x)
            return x + _positional(conf, p, x, positions)

        probs = _as_seq(_walk(net, ops, in_name, out_name, params, state,
                              token[:, None], attn, posenc))
        return probs[:, 0, :], cache

    return step


def make_prefill_fn(net, kv_dtype: str = "f32", page_size: int = 16):
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
        b, Tc = np.shape(tokens)
        start_h = _host(start)
        writes = _Writes(_host(rows), start_h[:, None] + np.arange(Tc),
                         _capacity(cache), net.device)
        tokens = _as_tensor(tokens, net, torch.long)
        kmask = _as_tensor(kmask, net, torch.float32)
        rows = writes.rows
        positions = writes.positions                        # [b, Tc]
        start = positions[:, 0]
        last_idx = _as_tensor(last_idx, net, torch.long)

        def attn(name, conf, p, x):
            Dh = conf.n_out // conf.n_heads
            groups, tr = _head_groups(conf, p, cache[name], _as_seq(x))
            ys = []
            for pj, entry, H, xj in groups:
                n = H * Dh
                qkv = xj @ pj["Wqkv"] + pj["bqkv"]           # [b, Tc, 3n]
                q, k, v = qkv.split(n, dim=-1)
                keep = kmask[..., None, None].to(k.dtype)
                _cache_write(entry, _split_heads(k, H) * keep,
                             _split_heads(v, H) * keep, writes, kv_dtype,
                             page_size)
                qh = _split_heads(q, H).transpose(1, 2)     # [b, H, Tc, Dh]
                kh = _split_heads(k, H).transpose(1, 2)
                vh = _split_heads(v, H).transpose(1, 2)
                o1, lse1 = _chunk_self_lse(qh, kh, vh, kmask)
                # cross-chunk half: queries against the cache prefix this
                # row wrote before `start` (empty on the first chunk: its
                # lse sits at the floor and merges to weight zero)
                limit = start[:, None].expand(b, Tc)
                o2, lse2 = _cache_attend(entry, qh, limit, kv_dtype,
                                         page_size, rows=rows)
                o = _merge_lse(o1, lse1, o2, lse2)
                ys.append((o.transpose(1, 2).reshape(b, Tc, n), pj))
            return _out_proj(conf, p, ys, tr)

        def posenc(name, conf, p, x):
            x = _as_seq(x)
            return x + _positional(conf, p, x, positions)

        probs = _as_seq(_walk(net, ops, in_name, out_name, params, state,
                              tokens, attn, posenc))
        return probs[torch.arange(b, device=net.device), last_idx, :], cache

    return prefill


def make_verify_fn(net, kv_dtype: str = "f32", page_size: int = 16):
    """-> ``verify(params, state, cache, tokens, pos) -> (probs, cache)``,
    the speculative verification step. tokens [B, K] int is each row's
    candidate window (its true last token, then K-1 drafts); pos [B] is
    the position the FIRST token occupies. probs [B, K, V]: row i is the
    output after consuming tokens[:, :i+1] — what i+1 sequential
    `make_decode_fn` steps give, because all K K/Vs are written first and
    query row i attends with key_limit pos+i+1. Positions past the
    capacity are dropped; their rows' outputs are never accepted."""
    in_name, out_name, ops = _plan(net)

    @torch.no_grad()
    def verify(params, state, cache, tokens, pos):
        B, K = np.shape(tokens)
        writes = _Writes(np.arange(B), _host(pos)[:, None] + np.arange(K),
                         _capacity(cache), net.device)
        tokens = _as_tensor(tokens, net, torch.long)
        positions = writes.positions                        # [B, K]

        def attn(name, conf, p, x):
            Dh = conf.n_out // conf.n_heads
            groups, tr = _head_groups(conf, p, cache[name], _as_seq(x))
            ys = []
            for pj, entry, H, xj in groups:
                n = H * Dh
                qkv = xj @ pj["Wqkv"] + pj["bqkv"]           # [B, K, 3n]
                q, k, v = qkv.split(n, dim=-1)
                _cache_write(entry, _split_heads(k, H), _split_heads(v, H),
                             writes, kv_dtype, page_size)
                qh = _split_heads(q, H).transpose(1, 2)     # [B, H, K, Dh]
                o, _ = _cache_attend(entry, qh, positions + 1, kv_dtype,
                                     page_size)
                ys.append((o.transpose(1, 2).reshape(B, K, n), pj))
            return _out_proj(conf, p, ys, tr)

        def posenc(name, conf, p, x):
            x = _as_seq(x)
            return x + _positional(conf, p, x, positions)

        probs = _walk(net, ops, in_name, out_name, params, state, tokens,
                      attn, posenc)
        return probs, cache

    return verify
