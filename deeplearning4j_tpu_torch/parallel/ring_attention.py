"""Ring attention — sequence parallelism (JAX counterpart
deeplearning4j_tpu/parallel/ring_attention.py).

The sequence is cut into n blocks along time, one a shard. K/V blocks
travel around the ring while each shard accumulates its queries' output
over the visiting blocks with the log-sum-exp merge (`lse_combine`), so
the full [T, T] score matrix never exists. Each hop runs the port's
flash kernels on the local Q against the visiting K/V block:
`flash_attention_lse` (forward K1; its backward `_FlashLse` -> K5 with
the lse cotangent, or K4 at Tl <= BLOCK_Q_MAX), or the chunked tier
past MAX_FLASH_T (`chunked_flash_attention_lse`, `hop_chunk`). Under
causal attention a hop takes the full, the diagonal or no case by its
source block; a skipped hop launches nothing. Local blocks whose length
is not a multiple of 128, and on CUDA head dims the kernels are not
built for at the blocks' dtype (`kernel_head_dims`: 16 in f32 besides
`KERNEL_HEAD_DIMS`), run the f32 einsum ring instead (`ring_route`).

Dropout hashes GLOBAL coordinates: every hop keys its window at origin
(idx*Tl, src*Tl) with hash_t = n*Tl, so the ring drops exactly what one
kernel over the whole sequence drops for the same step seed.

The per-shard function takes its ring **transport** as an argument:

- `ProcessGroupRing`: one block a rank, the K/V blocks passed on by
  `torch.distributed.batch_isend_irecv` (the JAX package's
  `lax.ppermute`), differentiably (the cotangents travel back the other
  way);
- `InProcessRing`: n blocks in one process, one device — the
  counterpart of XLA's n shards in one program: each hop runs every
  shard's block in turn and the ring shift is a rotation of the list.
  Nothing picks it unless the caller passes it.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops.flash_attention import (
    MAX_FLASH_T,
    MONOLITHIC_COMPILE_MAX,
    NEG_INF,
    _drop_ctx,
    _keep_mask,
    _step_seed,
    _tiles_str,
    chunked_flash_attention_lse,
    flash_attention_lse,
    flash_attention_lse_drop,
    keep_scale,
    kernel_head_dims,
    lse_combine,
    max_chunks,
    pick_chunk,
)


class InProcessRing:
    """The ring of `n` shards held by this process: block j of the lists
    the ring functions take is shard j; a shift hands every shard its
    predecessor's blocks (a list rotation, no copy)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shards = tuple(range(self.n))

    def shift(self, ks, vs):
        return [ks[-1]] + ks[:-1], [vs[-1]] + vs[:-1]


class _Shift(torch.autograd.Function):
    """Send (k, v) to the next rank of the ring and receive the previous
    rank's; the backward sends the cotangents the other way."""

    @staticmethod
    def forward(ctx, k, v, ring):
        ctx.ring = ring
        return ring.exchange(k, v, +1)

    @staticmethod
    def backward(ctx, dk, dv):
        dk = torch.zeros_like(dk) if dk is None else dk
        dv = torch.zeros_like(dv) if dv is None else dv
        return (*ctx.ring.exchange(dk, dv, -1), None)


class ProcessGroupRing:
    """The ring over a process group: this rank is shard `index` of
    `size`, holding one block; a shift passes (k, v) one rank on."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.n = int(size)
        self.index = int(index)
        self.shards = (self.index,)

    def exchange(self, k, v, direction):
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(self.group)
        dst = ranks[(self.index + direction) % self.n]
        src = ranks[(self.index - direction) % self.n]
        k, v = k.contiguous(), v.contiguous()
        k_in, v_in = torch.empty_like(k), torch.empty_like(v)
        ops = [dist.P2POp(dist.isend, k, dst, self.group),
               dist.P2POp(dist.isend, v, dst, self.group),
               dist.P2POp(dist.irecv, k_in, src, self.group),
               dist.P2POp(dist.irecv, v_in, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return k_in, v_in

    def shift(self, ks, vs):
        k, v = _Shift.apply(ks[0], vs[0], self)
        return [k], [v]


class _Depend(torch.autograd.Function):
    """o, made to depend on `extra` with a zero cotangent: a rank whose
    causal hops skip a visiting block must still run that block's shift
    backward, the exchange its ring neighbours wait in."""

    @staticmethod
    def forward(ctx, o, *extra):
        ctx.like = [(e.shape, e.dtype, e.device) for e in extra]
        return o.clone()

    @staticmethod
    def backward(ctx, do):
        return (do, *(torch.zeros(s, dtype=d, device=dev)
                      for s, d, dev in ctx.like))


def _hop_fn(Tl, D, n, hop_chunk, dropout, seed):
    """The per-hop (o, lse) function for local blocks of Tl x D: the
    chunked tier when `hop_chunk` is given or Tl is past MAX_FLASH_T and
    tiles; the whole-block kernels up to MAX_FLASH_T (or to
    MONOLITHIC_COMPILE_MAX at head dims up to 128)."""
    T_global = n * Tl
    if hop_chunk or (Tl > MAX_FLASH_T and pick_chunk(Tl, False,
                                                     head_dim=D) > 0):
        def hop(qf, kf, vf, scale, causal, q0, k0):
            if dropout:
                return chunked_flash_attention_lse(
                    qf, kf, vf, scale, causal, chunk=hop_chunk,
                    dropout=dropout, seed=seed, q_origin=q0, k_origin=k0,
                    hash_t=T_global)
            return chunked_flash_attention_lse(qf, kf, vf, scale, causal,
                                               chunk=hop_chunk)
        return hop
    if Tl <= MAX_FLASH_T or (Tl <= MONOLITHIC_COMPILE_MAX and D <= 128):
        def hop(qf, kf, vf, scale, causal, q0, k0):
            if dropout:
                return flash_attention_lse_drop(
                    qf, kf, vf, None, _drop_ctx(seed, q0, k0), scale,
                    causal, float(dropout), T_global)
            return flash_attention_lse(qf, kf, vf, scale, causal)
        return hop
    raise ValueError(
        f"ring attention local block Tl={Tl} (head_dim {D}) is neither "
        f"tileable (2-{max_chunks(False)} tiles of {_tiles_str(D)}) nor "
        f"within the whole-block kernels' envelope (Tl <= "
        f"{MONOLITHIC_COMPILE_MAX} at head_dim <= 128) — use more 'seq' "
        "shards or pad T so the per-shard block is tileable")


def _ring_flash(qs, ks, vs, transport, causal, hop_chunk, dropout, seed):
    """The kernel ring over this process's blocks (lists aligned with
    `transport.shards`): n hops, each merging every local block's
    visiting hop, then one shift (none after the last hop)."""
    n = transport.n
    B, H, Tl, D = qs[0].shape
    scale = 1.0 / math.sqrt(D)
    hop_lse = _hop_fn(Tl, D, n, hop_chunk, dropout, seed)
    qf = [q.reshape(B * H, Tl, D) for q in qs]
    acc = [None] * len(qs)
    skipped = [[] for _ in qs]
    for i in range(n):
        for j, idx in enumerate(transport.shards):
            src = (idx - i) % n
            if causal and src > idx:
                # a block wholly in the future: no contribution
                skipped[j] += [ks[j], vs[j]] if i else []
                continue
            o_hop, lse_hop = hop_lse(
                qf[j], ks[j].reshape(B * H, Tl, D),
                vs[j].reshape(B * H, Tl, D), scale,
                bool(causal and src == idx), idx * Tl, src * Tl)
            if acc[j] is None:
                acc[j] = (o_hop.float(), lse_hop)
            else:
                acc[j] = lse_combine(*acc[j], o_hop, lse_hop)
        if i < n - 1:
            ks, vs = transport.shift(ks, vs)
    outs = [o.reshape(B, H, Tl, D).to(q.dtype)
            for (o, _), q in zip(acc, qs)]
    if isinstance(transport, ProcessGroupRing) and torch.is_grad_enabled():
        outs = [_Depend.apply(o, *sk) if sk else o
                for o, sk in zip(outs, skipped)]
    return outs


def _ring_einsum(qs, ks, vs, transport, causal, dropout, seed):
    """The f32 einsum ring (blocks of any length): the online-softmax
    recurrence over the visiting blocks; the normalizer accumulates the
    undropped weights and the keep mask is the kernels' global-coordinate
    hash."""
    n = transport.n
    B, H, Tl, D = qs[0].shape
    scale = 1.0 / math.sqrt(D)
    dev = qs[0].device
    q32 = [q.float() for q in qs]
    state = [(torch.zeros_like(q), torch.full_like(q[..., 0], NEG_INF),
              torch.zeros_like(q[..., 0])) for q in q32]
    for i in range(n):
        for j, idx in enumerate(transport.shards):
            src = (idx - i) % n
            o, m, l = state[j]
            s = (q32[j] @ ks[j].float().transpose(-1, -2)) * scale
            if causal:
                qp = idx * Tl + torch.arange(Tl, device=dev)
                kp = src * Tl + torch.arange(Tl, device=dev)
                s = s.masked_fill(~(qp[:, None] >= kp[None, :]), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(-1)
            if dropout:
                keep = _keep_mask(seed, torch.arange(B * H, device=dev),
                                  idx * Tl, src * Tl, Tl, Tl, n * Tl,
                                  dropout)
                p = p * (keep.reshape(B, H, Tl, Tl).float()
                         * keep_scale(dropout))
            o_new = o * corr[..., None] + p @ vs[j].float()
            state[j] = (o_new, m_new, l_new)
        if i < n - 1:
            ks, vs = transport.shift(ks, vs)
    return [(o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
            for (o, _, l), q in zip(state, qs)]


def ring_route(Tl: int, D: int, device_type: str, dtype=None) -> str:
    """Which ring runs local blocks of Tl x D on a device of
    `device_type`: "flash" (the kernel hops, `_ring_flash`) when Tl is a
    multiple of 128 and, on CUDA, D is a head dim the kernels are built
    for at the blocks' `dtype` (`kernel_head_dims`; None: at every
    dtype); "einsum" (the f32 ring, `_ring_einsum`, any D) otherwise. On
    the CPU the hops run the kernels' plain versions, which take any D."""
    if Tl % 128:
        return "einsum"
    if device_type == "cuda" and D not in kernel_head_dims(dtype):
        return "einsum"
    return "flash"


def ring_attention_blocks(qs, ks, vs, transport, *, causal: bool = True,
                          hop_chunk=None, dropout: float = 0.0,
                          generator=None, seed=None):
    """Ring attention over this process's blocks: qs, ks, vs lists of
    [B, H, Tl, D] blocks, one per shard of `transport.shards`. Returns
    the output blocks. Kernel hops or the f32 einsum ring as `ring_route`
    picks. dropout: one step seed for the whole ring (`seed`, a
    one-element int32 tensor, else drawn from `generator`), hashed on
    global coordinates."""
    if dropout and seed is None:
        if generator is None:
            raise ValueError("dropout > 0 requires a generator or a seed")
        seed = _step_seed(generator)
    _, _, Tl, D = qs[0].shape
    if ring_route(Tl, D, qs[0].device.type, qs[0].dtype) == "flash":
        return _ring_flash(list(qs), list(ks), list(vs), transport, causal,
                           hop_chunk, dropout, seed)
    return _ring_einsum(list(qs), list(ks), list(vs), transport, causal,
                        dropout, seed)


def ring_attention(q, k, v, *, transport, causal: bool = True,
                   hop_chunk=None, dropout: float = 0.0, generator=None,
                   seed=None):
    """Per-shard ring attention: q, k, v [B, H, Tl, D], this rank's block
    of a sequence sharded over `transport` (a `ProcessGroupRing`).
    Returns [B, H, Tl, D], differentiable."""
    return ring_attention_blocks([q], [k], [v], transport, causal=causal,
                                 hop_chunk=hop_chunk, dropout=dropout,
                                 generator=generator, seed=seed)[0]


class _GatherSeq(torch.autograd.Function):
    """All-gather of the ring's output blocks along time; each rank then
    holds the whole (replicated) output, whose cotangent's own block is
    this rank's."""

    @staticmethod
    def forward(ctx, o, ring):
        import torch.distributed as dist

        parts = [torch.empty_like(o) for _ in range(ring.n)]
        dist.all_gather(parts, o.contiguous(), group=ring.group)
        ctx.index, ctx.Tl = ring.index, o.shape[2]
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, do):
        t0 = ctx.index * ctx.Tl
        return do[:, :, t0:t0 + ctx.Tl], None


def ring_self_attention(q, k, v, mesh=None, *, causal: bool = True,
                        seq_axis: str = "seq", n_shards=None,
                        hop_chunk=None, dropout: float = 0.0,
                        generator=None, seed=None):
    """Whole-sequence entry point: q, k, v [B, H, T, D] (T divisible by
    the shard count) -> [B, H, T, D]. With a `mesh`, the ring runs over
    its `seq_axis` process group: every rank passes the whole sequence,
    runs its block and gets the whole output back. With `n_shards`
    instead, the n-shard ring runs in this process (`InProcessRing`)."""
    if mesh is not None:
        ring = ProcessGroupRing(mesh.group(seq_axis),
                                mesh.axis_size(seq_axis),
                                mesh.axis_index(seq_axis))
        Tl = q.shape[2] // ring.n
        sl = slice(ring.index * Tl, (ring.index + 1) * Tl)
        o = ring_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                           transport=ring, causal=causal,
                           hop_chunk=hop_chunk, dropout=dropout,
                           generator=generator, seed=seed)
        return _GatherSeq.apply(o, ring)
    if not n_shards:
        raise ValueError("ring_self_attention needs a mesh or n_shards")
    ring = InProcessRing(n_shards)
    split = [t.chunk(ring.n, dim=2) for t in (q, k, v)]
    outs = ring_attention_blocks(*split, ring, causal=causal,
                                 hop_chunk=hop_chunk, dropout=dropout,
                                 generator=generator, seed=seed)
    return torch.cat(outs, dim=2)


def sequence_sharded_attention_reference(q, k, v, *, causal: bool = True):
    """Unsharded reference for tests: plain softmax attention in f32."""
    D = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(float(D))
    if causal:
        T = q.shape[2]
        tril = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tril, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return (w @ v.float()).to(q.dtype)
