"""Fused (flash) attention — the port of the JAX package's
ops/flash_attention.py on two hand-written CUDA sources:
csrc/flash_fwd.cu (forward) and csrc/flash_bwd.cu (backward).

Forward (csrc/flash_fwd.cu):

* K1 — `_flash_fwd` -> `_fwd_kernel` (flat [BH, T, D] layout, optional
  [BH, 1, T] key mask). Callers: `flash_attention`,
  `flash_attention_lse_masked` (chunked prefill, nn/decode.py), the
  flat rung of SelfAttention's dispatch ladder (512 < T <= 8192) and
  every tile of the chunked tier (T > 8192).
* K2 — `_flash_fwd_qkv` -> `_fwd_kernel(packed_heads=True)`: the same
  attention read as head column slices of the packed [B, T, 3n]
  projection, written back as [B, T, n] — no per-head relayout.
* K3 — the packed route at head_dim 64, which the TPU runs on a
  head-pair kernel (`_flash_fwd_qkv_pair`) for its 128-lane tile; here
  `_flash_fwd_qkv` on the same kernel, instantiated at D = 64.

Both sources take head dims 32, 64, 128 and 256 (`KERNEL_HEAD_DIMS`).
`supports` and `supports_qkv` keep the JAX package's envelope but for
one difference: they send every other head dim to the dense path, where
the JAX package would run its flash kernels. On CUDA tensors `supports`
counts each such call in `DENSE_ROUTES` and warns the first time.

Backward (csrc/flash_bwd.cu, one source for all four TPU kernels):

* K4 — `_flash_bwd_impl` at T <= 512 (the TPU's single-block
  `_flash_bwd_fused`),
* K5 — `_flash_bwd_impl` past one block (the TPU's dq/dkv split),
* K6 — `_flash_bwd_qkv` (packed, D = 128; writes dq|dk|dv into one
  [B, T, 3n] gradient in place),
* K7 — `_flash_bwd_qkv` at D = 64 (the TPU's `_flash_bwd_qkv_pair`).

`_FlashCore`, `_FlashQkvCore` and `_FlashLse` are the
`torch.autograd.Function`s of the JAX package's custom VJPs
(`_flash_core[_masked|_drop]`, `_flash_qkv_core[_masked|_drop]` and
`flash_attention_lse[_masked|_drop]`): the forward saves (q, k, v or
qkv, o, lse and the mask), the backward runs the kernels above, and the
mask gets no gradient. `_FlashLse` returns (o, lse), and its backward
takes the lse cotangent too (`dlse`, folded into delta: the chunked
tier's logsumexp merge sends it back through every tile).

Attention dropout runs inside every kernel, forward and backward, as a
counter hash of each score element's global coordinates and a step seed
(`_keep_mask`, csrc/dropout.cuh): the JAX package's `_keep_mask`, bit
for bit. `flash_attention`, `flash_attention_qkv` and
`chunked_flash_attention` draw one int32 step seed a call from the
caller's `torch.Generator` (`_step_seed`, the counterpart of the JAX
package's `dropout_rng`), as a device tensor: no host sync.

Past T = 8192 the chunked tier (`chunked_flash_attention[_lse]`) runs
the same kernels over chunk-length tiles of [BH, T, D] views (no tile
is copied) and merges them with `lse_combine`, as the JAX package does;
its envelope (`pick_chunk`, `supports_chunked`,
`supports_monolithic_fallback`, `servable_seq`,
`chunked_unsupported_reason`) is the JAX package's, but for head dims
outside `KERNEL_HEAD_DIMS`, which it refuses.

The kernels take strides, so the wrappers hand them views: the packed
route never copies q, k or v out of the projection, and the flat route
reads any [BH, T, D] view whose last dimension is contiguous.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes its plain PyTorch version (`_flash_fwd_reference`,
`_flash_bwd_reference`: f32 softmax math, the backward written out as
ds = p * (dp - delta), with p (forward and backward) and ds rounded to
the operand dtype where the JAX kernels round them; with dropout the
keep mask from `_keep_mask` in int64) — this is what the CPU tests
run. On a CUDA tensor it launches the kernel or raises;
nothing falls back. The wrappers count kernel launches in `LAUNCHES`
(one entry per TPU kernel, K1-K7) so a run can show that its main path
went through the kernels.

What bounds the kernels on the H100 and what their design does about
it: see the notes at the top of csrc/flash_fwd.cu and csrc/flash_bwd.cu.
"""

from __future__ import annotations

import ctypes
import math
import threading
import warnings
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build, refuse_double_backward

NEG_INF = -1e30
BLOCK = 128
BLOCK_Q_MAX = 512

# the dispatch envelope of the JAX package (ops/flash_attention.py),
# kept identical so both packages route the same shapes to flash
MIN_FLASH_SEQ = 512
MAX_FLASH_T = 8192

# what the CUDA kernels take (csrc/flash_fwd.cu, csrc/flash_bwd.cu): head
# dims they are instantiated for, their query/key tile, and the element
# types
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
KERNEL_TILE = 64
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernels copy tiles into shared memory 16 bytes at a time
_ALIGN = 16

_MASK_FLOOR = -1e20
_L_FLOOR = 1e-30

# The long-context tier: the JAX package's envelope (ops/flash_attention.py
# and ops/autotune.py). T in (MAX_FLASH_T, MONOLITHIC_COMPILE_MAX] that no
# tiling takes runs the monolithic kernels at D <= 128; chunk loops are
# capped at MAX_CHUNKS chunks (MAX_CHUNK_PAIRS causal tile pairs); the
# tile lengths are CHUNK_TILES, shorter past head dim 128
# (`max_tile_for_dim`).
MONOLITHIC_COMPILE_MAX = 14336
MAX_CHUNKS = 16
MAX_CHUNK_PAIRS = MAX_CHUNKS * (MAX_CHUNKS + 1) // 2
CHUNK_TILES = (8192, 4096, 2048, 1024, 512)
_LANES = 128
_TILE_ELEM_BUDGET = CHUNK_TILES[0] * _LANES

# calls on CUDA tensors inside the JAX package's flash envelope whose
# head dim no kernel is instantiated for: they take the dense path
DENSE_ROUTES = {"head_dim": 0}
_dense_warned = False


def supports(q_shape, *, causal, dropout, mask, device=None) -> bool:
    """Whether the flat fused kernel handles this case. q_shape is
    [B, H, T, D] — T at index 2. The JAX package's envelope, but for a
    head dim outside `KERNEL_HEAD_DIMS`, which takes the dense path: on a
    CUDA `device` that call is counted in `DENSE_ROUTES` and warned of
    once. The packed route's misses fall through to this check, so each
    attention call is counted at most once."""
    global _dense_warned
    _, _, T, D = q_shape
    if not (MIN_FLASH_SEQ <= T <= MAX_FLASH_T and T % BLOCK == 0):
        return False
    if D in KERNEL_HEAD_DIMS:
        return True
    if device is not None and torch.device(device).type == "cuda":
        DENSE_ROUTES["head_dim"] += 1
        if not _dense_warned:
            _dense_warned = True
            warnings.warn(
                f"flash attention: no kernel takes head dim {D} (only "
                f"{KERNEL_HEAD_DIMS}); these calls take the dense path, "
                "counted in DENSE_ROUTES", stacklevel=2)
    return False


def supports_qkv(B, T, n, H, *, dropout) -> bool:
    """Envelope of the packed no-relayout path: head_dim a multiple of
    128, or exactly 64 with an even head count, and a single-block
    sequence length. The JAX package's envelope, but for a head dim
    outside `KERNEL_HEAD_DIMS` (a multiple of 128 past 256), which takes
    the dense path."""
    if n % H:
        return False
    D = n // H
    dim_ok = D % 128 == 0 or (D == 64 and H % 2 == 0)
    return (dim_ok and D in KERNEL_HEAD_DIMS
            and MIN_FLASH_SEQ <= T <= BLOCK_Q_MAX and T % BLOCK == 0)


# ---------------------------------------------- the dropout keep mask

_U32 = 0xFFFFFFFF


def _mul32(x, c):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a u32 int c, without
    leaving int64 (the CPU build of torch has few uint32 operations)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _fmix32(x):
    """murmur3's finalizer on int64 x in [0, 2^32): the JAX package's
    `_fmix32`."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate) -> int:
    """The u32 keep threshold of a dropout rate: an element is kept where
    its hash is below it."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def keep_scale(rate) -> float:
    """1 / (1 - rate), computed in double and rounded to float32, as the
    JAX package's weak-typed product rounds it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _keep_mask(seed, bh, q0, k0, rows, cols, hash_t, rate):
    """[len(bh), rows, cols] bool keep mask: the JAX package's
    `_keep_mask` in int64. seed: an int tensor of one element; bh: int64
    tensor of absolute b*H + h slice numbers; q0, k0: the GLOBAL row and
    column of element (0, 0); hash_t: the GLOBAL sequence length, the
    row stride of the hashed coordinate. Keyed on global coordinates, a
    tile at (q0, k0) drops what the whole sequence's kernel drops
    there."""
    dev = bh.device
    key = _fmix32((seed.reshape(1).long() + _mul32(bh, 0x9E3779B9)) & _U32)
    gq = (q0 + torch.arange(rows, device=dev)) & _U32
    gk = (k0 + torch.arange(cols, device=dev)) & _U32
    h = (key[:, None, None] + _mul32(gq, hash_t & _U32)[:, None]
         + gk[None, :]) & _U32
    h = _mul32(h, 0xCC9E2D51)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x1B873593)
    h = h ^ (h >> 13)
    return h < keep_threshold(rate)


def dropout_keep_mask_host(seed, bh, T, rate):
    """[T, T] bool keep mask of one bh slice at origin 0 (the JAX
    package's host oracle of the same name)."""
    return _keep_mask(torch.tensor([seed]), torch.tensor([bh]), 0, 0, T, T,
                      T, rate)[0]


class _Drop(NamedTuple):
    """Attention dropout of one kernel call: `seed` the int32 step seed
    (a one-element tensor on the operands' device), `rate`, the GLOBAL
    origin of the call's window and the GLOBAL sequence length (None:
    the call's own T)."""
    seed: torch.Tensor
    rate: float
    q_origin: int = 0
    k_origin: int = 0
    hash_t: int | None = None

    def keep_scale_tensor(self, BH, T, device):
        """f32 [BH, T, T] keep * 1/(1 - rate) of slices 0 .. BH-1."""
        keep = _keep_mask(self.seed, torch.arange(BH, device=device),
                          self.q_origin, self.k_origin, T, T,
                          self.hash_t or T, self.rate)
        return keep.float() * keep_scale(self.rate)

    def launch_args(self, T):
        """(seed, q_origin, k_origin, hash_t, thr, keep_scale) as the C
        entry points take them."""
        return (self.seed.data_ptr(), self.q_origin & _U32,
                self.k_origin & _U32, (self.hash_t or T) & _U32,
                keep_threshold(self.rate), keep_scale(self.rate))


_NO_DROP_ARGS = (None, 0, 0, 0, 0, 0.0)


def _step_seed(generator):
    """One int32 step seed in [0, 2^31 - 1) from `generator`, as a
    one-element tensor on its device (no host sync): the JAX package's
    `_step_seed`."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _drop_ctx(seed, q_origin=0, k_origin=0):
    """The dropout context of one call: (step seed, global q origin,
    global k origin), the JAX package's `_drop_ctx` operand."""
    return seed, int(q_origin), int(k_origin)


def _call_drop(dropout, generator, T):
    """The `_Drop` of a public call at rate `dropout` (None at 0): one
    step seed from `generator`, origin 0, hash_t = T."""
    if not dropout:
        return None
    if generator is None:
        raise ValueError("dropout > 0 requires a generator")
    return _Drop(_step_seed(generator), float(dropout), 0, 0, T)


# ------------------------------------------------------- plain version

def _scores(q, k, kmask, sm_scale, causal):
    """f32 scores sm_scale * q.k^T [BH, T, T] with NEG_INF where the key
    is in the future (causal) or masked out (kmask [BH, T], > 0 =
    visible)."""
    T = q.shape[1]
    s = sm_scale * (q.float() @ k.float().transpose(-1, -2))
    if causal:
        tri = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    if kmask is not None:
        s = s.masked_fill(~(kmask[:, None, :] > 0), NEG_INF)
    return s


def _flash_fwd_reference(q, k, v, kmask, sm_scale, causal, drop=None):
    """Plain PyTorch version of the forward kernel's function. q, k, v
    [BH, T, D]; kmask [BH, T] (> 0 = visible key) or None; drop a
    `_Drop` or None. Returns (o [BH, T, D] in q's dtype, lse [BH, T]
    f32). Scores, softmax and the P.V sums are f32, with p (times the
    keep mask and 1/(1 - rate) under dropout) rounded to the operand
    dtype for P.V (the identity in f32) where the JAX blocked kernel
    rounds it, and l summed from the unrounded, undropped p; a fully
    masked row gives o = 0 and lse ~= -1e20, as the kernel and the JAX
    package do."""
    BH, T, _ = q.shape
    s = _scores(q, k, kmask, sm_scale, causal)
    m = s.amax(-1)
    if kmask is not None:
        m = m.clamp_min(_MASK_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(_L_FLOOR)
    if drop is not None:
        p = p * drop.keep_scale_tensor(BH, T, q.device)
    o = (p.to(v.dtype).float() @ v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _flash_bwd_reference(q, k, v, o, lse, do, kmask, sm_scale, causal,
                         dlse=None, drop=None):
    """Plain PyTorch version of the backward kernel's function, written
    out (not autograd): q, k, v, o, do [BH, T, D]; lse [BH, T] from the
    forward; kmask [BH, T] or None; dlse [BH, T] (the lse cotangent) or
    None; drop a `_Drop` or None. In f32: p = exp(s - lse), delta =
    rowsum(do * o) - dlse, dp = do.v (times keep * 1/(1 - rate) under
    dropout), ds = p * (dp - delta) * sm_scale; p (dropped) and ds
    rounded to the operand dtype, then dq = ds.k, dk = ds^T.q, dv =
    p^T.do (f32 sums) in the dtypes of q, k, v — the JAX package's
    `_dq_kernel` and `_dkv_kernel`."""
    BH, T, _ = q.shape
    qf, kf, gf = q.float(), k.float(), do.float()
    p = torch.exp(_scores(q, k, kmask, sm_scale, causal) - lse[..., None])
    delta = (gf * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dp = gf @ v.float().transpose(-1, -2)
    pd = p
    if drop is not None:
        ks = drop.keep_scale_tensor(BH, T, q.device)
        pd, dp = p * ks, dp * ks
    ds = p * (dp - delta[..., None]) * sm_scale
    # P and dS rounded to the operand dtype for the second products, as
    # the JAX split kernels round them (`_dq_kernel`, `_dkv_kernel`);
    # the identity in f32
    pd, ds = pd.to(q.dtype).float(), ds.to(q.dtype).float()
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(k.dtype),
            (pd.transpose(-1, -2) @ gf).to(v.dtype))


def _heads(t, H):
    """[B, T, H*D] view -> [B, H, T, D] view (no copy)."""
    return t.unflatten(-1, (H, t.shape[-1] // H)).transpose(1, 2)


def _flat_heads(t, H):
    """[B, T, H*D] -> [B*H, T, D]."""
    B, T, n = t.shape
    return _heads(t, H).reshape(B * H, T, n // H)


def _unflat_heads(t, B):
    """[B*H, T, D] -> [B, T, H*D]."""
    BH, T, D = t.shape
    return t.reshape(B, BH // B, T, D).transpose(1, 2).reshape(B, T, -1)


def _flash_fwd_qkv_reference(qkv, H, kmask, sm_scale, causal, drop=None):
    """Plain PyTorch version of the packed route: qkv [B, T, 3n], kmask
    [B, T] or None -> (o [B, T, n], lse [B, H, 1, T] f32). Slice b*H + h
    of the flat layout is head h of batch row b, the kernels' dropout
    numbering."""
    B, T, three_n = qkv.shape
    flat = [_flat_heads(t, H) for t in qkv.split(three_n // 3, dim=-1)]
    o, lse = _flash_fwd_reference(
        *flat, None if kmask is None else kmask.repeat_interleave(H, 0),
        sm_scale, causal, drop)
    return _unflat_heads(o, B), lse.reshape(B, H, 1, T)


def _flash_bwd_qkv_reference(qkv, o, lse, do, H, kmask, sm_scale, causal,
                             drop=None):
    """Plain PyTorch version of the packed backward: qkv [B, T, 3n]; o,
    do [B, T, n]; lse [B, H, 1, T]; kmask [B, T] or None -> dqkv
    [B, T, 3n]."""
    B, T, three_n = qkv.shape
    flat = [_flat_heads(t, H) for t in qkv.split(three_n // 3, dim=-1)]
    grads = _flash_bwd_reference(
        *flat, _flat_heads(o, H), lse.reshape(B * H, T), _flat_heads(do, H),
        None if kmask is None else kmask.repeat_interleave(H, 0), sm_scale,
        causal, drop=drop)
    return torch.cat([_unflat_heads(g, B) for g in grads], dim=-1)


# --------------------------------------------------------- the launches

# the dropout arguments of both entry points: the seed's device pointer,
# q_origin, k_origin, hash_t, thr (u32) and the keep scale
_DROP_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_uint32] * 4
                  + [ctypes.c_float])
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int]
                 + _DROP_ARGTYPES + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p] + _DROP_ARGTYPES + [ctypes.c_void_p])


def _kernel(name, argtypes):
    """The C entry point `name` of csrc/<name>.cu, built on first use."""
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _check_launch(views, lse, kmask, dlse=None, drop=None):
    """Raise on what the kernels do not take. views: {name: [B, H, T, D]
    view} (any strides, last dimension contiguous), the first one q;
    lse and dlse (or None): [B*H, T] f32 contiguous; kmask: [B, T] f32
    contiguous or None; drop: a `_Drop` whose seed is one int32 or
    None."""
    q = next(iter(views.values()))
    B, H, T, D = q.shape
    tensors = list(views.values()) + [t for t in (lse, kmask, dlse)
                                      if t is not None]
    if drop is not None:
        tensors.append(drop.seed)
        if drop.seed.dtype != torch.int32 or drop.seed.numel() != 1:
            raise ValueError("flash kernel: the dropout seed must be one "
                             f"int32; got {drop.seed.dtype} "
                             f"{tuple(drop.seed.shape)}")
        if not 0.0 < drop.rate < 1.0:
            raise ValueError(f"flash kernel: dropout rate {drop.rate} is "
                             "not in (0, 1)")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash kernel: every tensor must be on the same "
                         f"CUDA device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in views.values()):
        raise ValueError("flash kernel takes float32 or bfloat16 operands "
                         "of one dtype; got "
                         f"{ {k: str(t.dtype) for k, t in views.items()} }")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIMS}; got {D}")
    if T % KERNEL_TILE:
        raise ValueError(f"flash kernel needs T % {KERNEL_TILE} == 0; "
                         f"got T={T}")
    for name, t in views.items():
        if t.shape != (B, H, T, D) or t.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name} must be a [B, H, T, D] "
                             f"= {(B, H, T, D)} view with a contiguous last "
                             f"dim; got shape {tuple(t.shape)}, strides "
                             f"{t.stride()}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (t.shape != (B * H, T)
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"flash kernel: {name} must be [B*H, T] f32 "
                             "contiguous")
    if kmask is not None and (kmask.shape != (B, T)
                              or kmask.dtype != torch.float32
                              or not kmask.is_contiguous()):
        raise ValueError("flash kernel: kmask must be [B, T] f32 contiguous")


def _check_alignment(views):
    """Raise on what the bf16 kernels cannot copy 16 bytes at a time.
    views: {name: (data_ptr, shape, element strides, element size)}; a
    base pointer must be 16-byte aligned, and so must the stride of every
    dimension but the last of more than one element."""
    for name, (ptr, shape, strides, size) in views.items():
        if ptr % _ALIGN:
            raise ValueError(f"flash kernel: the base pointer of {name} "
                             f"({ptr:#x}) is not {_ALIGN}-byte aligned")
        for dim, (n, st) in enumerate(zip(shape[:-1], strides[:-1])):
            if n > 1 and (st * size) % _ALIGN:
                raise ValueError(f"flash kernel: {name}'s stride {st} in "
                                 f"dimension {dim} is {st * size} bytes, "
                                 f"not a multiple of {_ALIGN}")


def _layout(t):
    """(data_ptr, shape, strides, element size) of a tensor, as
    `_check_alignment` takes it."""
    return t.data_ptr(), tuple(t.shape), t.stride(), t.element_size()


def _bht(t):
    """Element strides of the b, h and t dimensions of a [B, H, T, D]
    view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(fn, q, *args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return fn(*args, stream)


def _check_bf16_alignment(views, lse, kmask):
    """`_check_alignment` on the [B, H, T, D] views, lse and the key
    mask of a bf16 launch (the f32 kernels read element by element)."""
    if next(iter(views.values())).dtype != torch.bfloat16:
        return
    extra = {"lse": lse} if kmask is None else {"lse": lse, "kmask": kmask}
    _check_alignment({name: _layout(t)
                      for name, t in {**views, **extra}.items()})


def _drop_args(drop, T):
    return _NO_DROP_ARGS if drop is None else drop.launch_args(T)


def _launch(q, k, v, kmask, o, lse, sm_scale, causal, drop=None):
    """Launch csrc/flash_fwd.cu on [B, H, T, D] views (any strides, last
    dimension contiguous). kmask: [B, T] f32 contiguous or None; o: a
    [B, H, T, D] view to write; lse: [B*H, T] f32 contiguous; drop: a
    `_Drop` (slice b*H + h hashes as bh) or None."""
    views = {"q": q, "k": k, "v": v, "o": o}
    _check_launch(views, lse, kmask, None, drop)
    _check_bf16_alignment(views, lse, kmask)
    B, H, T, D = q.shape
    rc = _call(_kernel("flash_fwd", _FWD_ARGTYPES), q,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kmask),
               o.data_ptr(), lse.data_ptr(), _KERNEL_DTYPES[q.dtype], D, B,
               H, T, *_bht(q), *_bht(k), *_bht(v), *_bht(o),
               float(sm_scale), int(bool(causal)), *_drop_args(drop, T))
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (code {rc}) at "
                           f"B={B} H={H} T={T} D={D} dtype={q.dtype}")


def _launch_bwd(q, k, v, o, do, lse, kmask, dq, dk, dv, sm_scale, causal,
                dlse=None, drop=None):
    """Launch csrc/flash_bwd.cu on [B, H, T, D] views: reads q, k, v, o,
    do, lse, kmask ([B, T] or None) and dlse ([B*H, T] or None), writes
    dq, dk, dv. The kernel's delta = rowsum(do * o) - dlse goes to a
    [B*H, T] f32 scratch allocated here."""
    views = {"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq, "dk": dk,
             "dv": dv}
    _check_launch(views, lse, kmask, dlse, drop)
    _check_bf16_alignment(views, lse, kmask)
    B, H, T, D = q.shape
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in views.values() for s in _bht(t)])
    rc = _call(_kernel("flash_bwd", _BWD_ARGTYPES), q,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               do.data_ptr(), lse.data_ptr(), _ptr(kmask), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               _KERNEL_DTYPES[q.dtype], D, B, H, T, strides,
               float(sm_scale), int(bool(causal)), _ptr(dlse),
               *_drop_args(drop, T))
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed (code {rc}) at "
                           f"B={B} H={H} T={T} D={D} dtype={q.dtype}")


# ------------------------------------------------------------ wrappers

# Launches of each TPU kernel's counterpart, counted where the wrapper
# launches the CUDA kernel and nowhere else (a CPU tensor runs the plain
# version and counts nothing). One wrapper serves each layout and
# direction; which TPU kernel a launch stands for follows the JAX
# package's own dispatch: head_dim 64 on the packed layout is its
# head-pair kernel (K3, K7), and the flat backward past one block is its
# dq/dkv split (K5).
LAUNCHES = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7"), 0)
# serving replicas launch from several threads: a bare `+=` on the table
# is a read-modify-write that can lose a count between them
_LAUNCH_LOCK = threading.Lock()


def _count(kernel: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[kernel] += 1


def _kmask_rows(kmask, rows, T):
    """[rows, 1, T] key mask operand -> [rows, T] f32 contiguous, or
    None."""
    return None if kmask is None else (kmask.reshape(rows, T)
                                       .to(torch.float32).contiguous())


def _rows(t):
    """t with a contiguous last dimension, as the kernels read it."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _flash_fwd(q, k, v, kmask, sm_scale, causal, drop=None):
    """K1. q, k, v [BH, T, D] (views of any strides); kmask [BH, 1, T]
    (> 0 = visible key) or None; drop a `_Drop` or None. Returns (o
    [BH, T, D] in q's dtype, lse [BH, T] f32)."""
    BH, T, D = q.shape
    km = _kmask_rows(kmask, BH, T)
    if q.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, km, sm_scale, causal, drop)
    o = torch.empty((BH, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    _launch(*(_rows(t)[:, None] for t in (q, k, v)), km, o[:, None], lse,
            sm_scale, causal, drop)
    _count("K1")
    return o, lse


def _flash_fwd_qkv(qkv, H, kmask, sm_scale, causal, drop=None):
    """K2, and K3 at head_dim 64. qkv [B, T, 3n] (the x @ Wqkv output,
    q|k|v each n = H*D wide); kmask [B, 1, T] or None; drop a `_Drop`
    (slice b*H + h hashes as bh, the flat layout's numbering) or None.
    Returns (o [B, T, n] in qkv's dtype, lse [B, H, 1, T] f32). The
    kernel reads each head's column slices in place and writes o in
    [B, T, n]."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    km = _kmask_rows(kmask, B, T)
    if qkv.device.type == "cpu":
        return _flash_fwd_qkv_reference(qkv, H, km, sm_scale, causal, drop)
    q, k, v = (_heads(t, H) for t in qkv.split(n, dim=-1))
    o = torch.empty((B, T, n), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=qkv.device)
    _launch(q, k, v, km, _heads(o, H), lse, sm_scale, causal, drop)
    _count("K3" if n // H == 64 else "K2")
    return o, lse.reshape(B, H, 1, T)


def _flash_bwd_impl(q, k, v, o, lse, do, kmask, sm_scale, causal,
                    dlse=None, drop=None):
    """K4 at T <= BLOCK_Q_MAX (the TPU's single-block body), else K5
    (its dq/dkv split); one kernel either way. q, k, v, o, do
    [BH, T, D]; lse [BH, T]; kmask [BH, 1, T] or None; dlse [BH, T] (the
    lse cotangent, folded into delta) or None; drop a `_Drop` or None.
    Returns (dq, dk, dv)."""
    BH, T, D = q.shape
    km = _kmask_rows(kmask, BH, T)
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, o, lse, do, km, sm_scale,
                                    causal, dlse, drop)
    grads = [torch.empty((BH, T, D), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    _launch_bwd(*(_rows(t)[:, None] for t in (q, k, v, o, do)),
                lse.contiguous(), km, *(g[:, None] for g in grads),
                sm_scale, causal,
                None if dlse is None else dlse.float().contiguous(), drop)
    _count("K4" if T <= BLOCK_Q_MAX else "K5")
    return tuple(grads)


def _flash_bwd_qkv(qkv, o, lse, do, H, kmask, sm_scale, causal, drop=None):
    """K6, and K7 at head_dim 64. qkv [B, T, 3n]; o, do [B, T, n]; lse
    [B, H, 1, T]; kmask [B, 1, T] or None; drop a `_Drop` or None.
    Returns dqkv [B, T, 3n]: the kernel reads each head's column slices
    of qkv, o and do in place and writes dq|dk|dv straight into the one
    gradient."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    km = _kmask_rows(kmask, B, T)
    if qkv.device.type == "cpu":
        return _flash_bwd_qkv_reference(qkv, o, lse, do, H, km, sm_scale,
                                        causal, drop)
    q, k, v = (_heads(t, H) for t in qkv.split(n, dim=-1))
    dqkv = torch.empty((B, T, three_n), dtype=qkv.dtype, device=qkv.device)
    dq, dk, dv = (_heads(t, H) for t in dqkv.split(n, dim=-1))
    _launch_bwd(q, k, v, _heads(_rows(o), H), _heads(_rows(do), H),
                lse.reshape(B * H, T).contiguous(), km, dq, dk, dv,
                sm_scale, causal, drop=drop)
    _count("K7" if n // H == 64 else "K6")
    return dqkv


# ------------------------------------------------- autograd and public

class _FlashCore(torch.autograd.Function):
    """`_flash_core` / `_flash_core_masked` / `_flash_core_drop`: q, k, v
    [BH, T, D], kmask [BH, 1, T] or None, drop a `_Drop` or None ->
    o [BH, T, D]."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, sm_scale, causal, drop):
        o, lse = _flash_fwd(q, k, v, kmask, sm_scale, causal, drop)
        ctx.save_for_backward(q, k, v, o, lse, kmask)
        ctx.sm_scale, ctx.causal, ctx.drop = sm_scale, causal, drop
        return o

    @staticmethod
    def backward(ctx, do):
        refuse_double_backward("_FlashCore")
        q, k, v, o, lse, kmask = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, o, lse, do.to(o.dtype), kmask,
                                     ctx.sm_scale, ctx.causal, drop=ctx.drop)
        return dq, dk, dv, None, None, None, None


class _FlashLse(torch.autograd.Function):
    """`flash_attention_lse[_masked|_drop]`: q, k, v [BH, T, D], kmask
    [BH, 1, T] or None, drop a `_Drop` or None -> (o [BH, T, D], lse
    [BH, T]), differentiable in both: the backward takes the cotangents
    of o and lse (an unused one arrives as None; a None dlse launches
    with a null pointer)."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, sm_scale, causal, drop):
        o, lse = _flash_fwd(q, k, v, kmask, sm_scale, causal, drop)
        ctx.save_for_backward(q, k, v, o, lse, kmask)
        ctx.sm_scale, ctx.causal, ctx.drop = sm_scale, causal, drop
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        refuse_double_backward("_FlashLse")
        q, k, v, o, lse, kmask = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(o.dtype)
        dq, dk, dv = _flash_bwd_impl(q, k, v, o, lse, do, kmask,
                                     ctx.sm_scale, ctx.causal, dlse,
                                     ctx.drop)
        return dq, dk, dv, None, None, None, None


class _FlashQkvCore(torch.autograd.Function):
    """`_flash_qkv_core` / `_flash_qkv_core_masked` /
    `_flash_qkv_core_drop`: qkv [B, T, 3n], kmask [B, 1, T] or None,
    drop a `_Drop` or None -> o [B, T, n]."""

    @staticmethod
    def forward(ctx, qkv, kmask, H, sm_scale, causal, drop):
        o, lse = _flash_fwd_qkv(qkv, H, kmask, sm_scale, causal, drop)
        ctx.save_for_backward(qkv, o, lse, kmask)
        ctx.H, ctx.sm_scale, ctx.causal, ctx.drop = H, sm_scale, causal, drop
        return o

    @staticmethod
    def backward(ctx, do):
        refuse_double_backward("_FlashQkvCore")
        qkv, o, lse, kmask = ctx.saved_tensors
        dqkv = _flash_bwd_qkv(qkv, o, lse, do.to(o.dtype), ctx.H, kmask,
                              ctx.sm_scale, ctx.causal, ctx.drop)
        return dqkv, None, None, None, None, None


def flash_attention_lse(q, k, v, sm_scale, causal):
    """Flat-layout flash returning (o [BH, T, D], lse [BH, T]),
    differentiable in o AND lse: the per-tile primitive of the chunked
    tier, whose lse merge needs d(lse) to flow."""
    return _FlashLse.apply(q, k, v, None, sm_scale, causal, None)


def flash_attention_lse_masked(q, k, v, kmask, sm_scale, causal):
    """`flash_attention_lse` with a [BH, 1, T] key padding mask — the
    per-tile primitive of the masked chunk loop and of chunked prefill
    (nn/decode.py, under no_grad). A fully masked row emits lse ~ -1e20
    and a zero row, which the lse merge weighs away."""
    return _FlashLse.apply(q, k, v, kmask, sm_scale, causal, None)


def flash_attention_lse_drop(q, k, v, kmask, ctx, sm_scale, causal,
                             dropout, hash_t):
    """`flash_attention_lse_masked` with in-kernel dropout keyed on
    GLOBAL coordinates: ctx is `_drop_ctx(seed, q_origin, k_origin)`
    (the step seed and this tile's window origin) and hash_t the GLOBAL
    sequence length, so a tile at origin (q0, k0) drops exactly the
    elements the whole sequence's kernel at T = hash_t would. kmask may
    be None (unpadded)."""
    seed, q_origin, k_origin = ctx
    drop = _Drop(seed, float(dropout), q_origin, k_origin, int(hash_t))
    return _FlashLse.apply(q, k, v, kmask, sm_scale, causal, drop)


def _broadcast_kmask(mask, B, H, T):
    """[B, T] key padding mask -> the flat kernels' [B*H, 1, T] operand."""
    return (mask.to(torch.float32)[:, None, :].expand(B, H, T)
            .reshape(B * H, 1, T))


def flash_attention(q, k, v, *, causal=True, sm_scale=None, mask=None,
                    dropout=0.0, generator=None):
    """q, k, v: [B, H, T, D] -> [B, H, T, D]; differentiable. mask:
    optional [B, T] key padding mask (1 = valid key), the dense path's
    semantics — masked keys get no probability mass and zero dk/dv.
    dropout: attention-weight dropout inside the kernels, from one step
    seed drawn from `generator` (required when dropout > 0)."""
    B, H, T, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    drop = _call_drop(dropout, generator, T)
    kmask = None if mask is None else _broadcast_kmask(mask, B, H, T)
    o = _FlashCore.apply(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                         v.reshape(B * H, T, D), kmask, sm_scale,
                         bool(causal), drop)
    return o.reshape(B, H, T, D)


def flash_attention_qkv(qkv, n_heads, *, causal=True, sm_scale=None,
                        mask=None, dropout=0.0, generator=None):
    """Packed-projection attention: qkv [B, T, 3n] -> out [B, T, n],
    never materializing a [B, H, T, D] relayout; differentiable (the
    gradient is written into one [B, T, 3n] tensor). Check
    `supports_qkv` first. mask: optional [B, T] key padding mask.
    dropout: as `flash_attention`, hashed with the flat layout's b*H + h
    numbering, so both layouts drop the same elements for one seed."""
    B, T, three_n = qkv.shape
    D = three_n // 3 // n_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    drop = _call_drop(dropout, generator, T)
    kmask = None if mask is None else mask.to(torch.float32)[:, None, :]
    return _FlashQkvCore.apply(qkv, kmask, n_heads, sm_scale, bool(causal),
                               drop)


# ------------------------------------------------- the chunked tier

def max_tile_for_dim(D) -> int:
    """Largest chunk tile for a head dim: tile * max(D, 128) <=
    8192 * 128 (the JAX package's `autotune.max_tile_for_dim`); None
    means D <= 128."""
    if not D or D <= _LANES:
        return CHUNK_TILES[0]
    for c in CHUNK_TILES:
        if c * D <= _TILE_ELEM_BUDGET:
            return c
    return 0


def chunk_pairs(n: int, causal: bool) -> int:
    """Tile-pair kernel calls of an n-chunk loop a direction."""
    return n * (n + 1) // 2 if causal else n * n


def _fits_unroll(n: int, causal: bool) -> bool:
    if causal:
        return chunk_pairs(n, causal) <= MAX_CHUNK_PAIRS
    return n <= MAX_CHUNKS


def max_chunks(causal: bool) -> int:
    """Largest chunk count within the loop's budget (16 both ways)."""
    n = MAX_CHUNKS
    while n > 1 and not _fits_unroll(n, causal):
        n -= 1
    return n


def pick_chunk(T: int, causal: bool = True, head_dim: int | None = None) \
        -> int:
    """Largest tile in CHUNK_TILES (within the head-dim bound when
    `head_dim` is given) that divides T into 2+ chunks within the
    budget; 0 when none does. The JAX package's `chunk_tile` reads a
    tuning table only on a TPU, so both packages take this choice."""
    cap = max_tile_for_dim(head_dim)
    for c in CHUNK_TILES:
        if c > cap:
            continue
        if T % c == 0 and 2 <= T // c and _fits_unroll(T // c, causal):
            return c
    return 0


def _tiles_str(head_dim=None) -> str:
    cap = max_tile_for_dim(head_dim)
    return "/".join(str(c) for c in reversed(CHUNK_TILES) if c <= cap)


def supports_chunked(q_shape, *, causal, dropout, mask) -> bool:
    """Envelope of the chunked tier: T beyond MAX_FLASH_T, divisible
    into tiles of `pick_chunk`. Padding masks and dropout ride it. The
    JAX package's envelope, but for a head dim outside
    `KERNEL_HEAD_DIMS`, which no kernel takes."""
    T, D = q_shape[2], q_shape[3]
    return (D in KERNEL_HEAD_DIMS and T > MAX_FLASH_T
            and pick_chunk(T, causal, head_dim=D) > 0)


def supports_monolithic_fallback(q_shape, *, causal, dropout, mask) -> bool:
    """T in (MAX_FLASH_T, MONOLITHIC_COMPILE_MAX] that no tiling takes
    runs the whole-sequence kernels at D <= 128 (the JAX package's
    fallback tier), for a head dim in `KERNEL_HEAD_DIMS`."""
    T, D = q_shape[2], q_shape[3]
    return (MAX_FLASH_T < T <= MONOLITHIC_COMPILE_MAX and T % BLOCK == 0
            and D <= 128 and D in KERNEL_HEAD_DIMS)


def servable_seq(T: int, head_dim: int, *, causal: bool = True,
                 dropout: bool = False, mask: bool = True) -> bool:
    """Whether a [*, H, T, head_dim] attention shape has a path: T at or
    below MAX_FLASH_T always does (flash where the shape qualifies,
    dense otherwise); beyond it the chunked or the monolithic-fallback
    tier must take it, else the attention layer raises
    `chunked_unsupported_reason`. The serving lattice validates its
    buckets against this (serving/buckets.py)."""
    if T <= MAX_FLASH_T:
        return True
    shape = (1, 1, T, head_dim)
    return (supports_chunked(shape, causal=causal, dropout=dropout,
                             mask=mask)
            or supports_monolithic_fallback(shape, causal=causal,
                                            dropout=dropout, mask=mask))


def chunked_unsupported_reason(T, *, dropout, mask, causal=True,
                               head_dim=None) -> str:
    """Why a long-T shape has no fused path: the JAX package's message,
    and, for a head dim outside `KERNEL_HEAD_DIMS`, that no kernel of
    this port takes it."""
    nmax = max_chunks(causal)
    cap = max_tile_for_dim(head_dim)
    msg = (f"attention at T={T} cannot be tiled: the chunked flash path "
           f"needs T divisible into 2-{nmax} "
           f"{'causal' if causal else 'non-causal'} tiles of "
           f"{_tiles_str(head_dim)}")
    if head_dim and head_dim > 128:
        msg += (f" (head_dim={head_dim} caps tiles at {cap}: the "
                "backward's VMEM working set scales with head_dim)")
    msg += (f" (causal trace budget {MAX_CHUNK_PAIRS} unrolled tile "
            f"pairs, non-causal kv tiles scan at {MAX_CHUNKS} chunks "
            f"max; max single-chip T here = {nmax * cap})")
    if T <= MONOLITHIC_COMPILE_MAX:
        msg += (f", and the monolithic fallback (T <= "
                f"{MONOLITHIC_COMPILE_MAX}) requires head_dim <= 128"
                + (f" — got head_dim={head_dim}" if head_dim else ""))
    if head_dim and head_dim not in KERNEL_HEAD_DIMS:
        msg += (f"; this port's flash kernels take head dims "
                f"{KERNEL_HEAD_DIMS} only, got {head_dim}")
    return msg + (" — pad T to a tile-divisible length or shard T over a "
                  "'seq' mesh axis (ring attention)")


def lse_combine(o, lse, o_hop, lse_hop):
    """Two-way logsumexp merge of normalized attention partials: the
    carry (o [.., T, D] f32, lse [.., T]) absorbs a hop's (o_hop,
    lse_hop); f32 throughout, 1e-30 denominator floor. Differentiable by
    autograd, which sends d(lse_hop) back into each tile."""
    m = torch.maximum(lse, lse_hop)
    a, b = torch.exp(lse - m), torch.exp(lse_hop - m)
    denom = torch.clamp_min(a + b, 1e-30)
    o = (o * a[..., None]
         + o_hop.float() * b[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def chunked_flash_attention(q, k, v, *, causal=True, sm_scale=None,
                            mask=None, chunk=None, dropout=0.0,
                            generator=None):
    """Single-card long-context attention: q, k, v [B, H, T, D] ->
    [B, H, T, D], differentiable. Q and KV are cut into chunk-length
    tiles, each (q_i, kv_j) pair runs the flash kernels (j < i full,
    j == i causal, j > i skipped when causal) and the partials merge with
    `lse_combine`, so no [T, T] tensor exists. mask: optional [B, T] key
    padding mask, sliced per kv tile. dropout: one step seed from
    `generator` for the whole call; each tile hashes its global
    coordinates, so the keep mask is the one the whole sequence's kernel
    would draw, whatever the chunk. `chunk` defaults to `pick_chunk`."""
    B, H, T, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kmask = None if mask is None else _broadcast_kmask(mask, B, H, T)
    seed = None
    if dropout:
        if generator is None:
            raise ValueError("dropout > 0 requires a generator")
        seed = _step_seed(generator)
    o, _ = chunked_flash_attention_lse(
        q.reshape(B * H, T, D), k.reshape(B * H, T, D),
        v.reshape(B * H, T, D), sm_scale, causal, kmask=kmask, chunk=chunk,
        dropout=dropout, seed=seed)
    return o.reshape(B, H, T, D)


def chunked_flash_attention_lse(q, k, v, sm_scale, causal, kmask=None,
                                chunk=None, dropout=0.0, seed=None,
                                q_origin=0, k_origin=0, hash_t=None):
    """Flat-layout chunked attention returning (o [BH, T, D], lse
    [BH, T]), differentiable in both. Each tile is a view of q, k, v (no
    copy). kmask: optional [BH, 1, T] key padding mask, sliced per kv
    tile. dropout/seed: in-kernel dropout from the int32 step seed whose
    keep mask hashes GLOBAL coordinates: q_origin/k_origin are this
    call's window offsets in the full sequence and hash_t its length
    (default T). Causal loops run the tile pairs one by one; non-causal
    ones merge every kv tile into a (0, NEG_INF) carry in the same j
    order, as the JAX package's scan does."""
    BH, T, D = q.shape

    def _fits(cand):
        return (isinstance(cand, int) and cand > 0 and T % cand == 0
                and cand % BLOCK == 0 and cand <= max_tile_for_dim(D)
                and T // cand >= 2 and _fits_unroll(T // cand, causal))

    c = chunk or pick_chunk(T, causal, head_dim=D)
    n = T // c if c else 0
    if not _fits(c):
        raise ValueError(
            f"T={T} not divisible into 2-{max_chunks(causal)} kernel tiles"
            + (f" of {chunk}" if chunk else "")
            + (f" ({chunk_pairs(n, causal)} unrolled tile pairs exceed "
               f"the {MAX_CHUNK_PAIRS} budget)"
               if n >= 2 and not _fits_unroll(n, causal) else "")
            + (f" (head_dim={D} caps tiles at {max_tile_for_dim(D)})"
               if c and c % BLOCK == 0 and n >= 2
               and c > max_tile_for_dim(D) else ""))
    ht = hash_t if hash_t is not None else T

    def hop(i, j, tile_causal):
        qi = q[:, i * c:(i + 1) * c]
        kj, vj = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
        kmj = None if kmask is None else kmask[:, :, j * c:(j + 1) * c]
        if dropout:
            ctx = _drop_ctx(seed, q_origin + i * c, k_origin + j * c)
            return flash_attention_lse_drop(qi, kj, vj, kmj, ctx, sm_scale,
                                            tile_causal, float(dropout), ht)
        return _FlashLse.apply(qi, kj, vj, kmj, sm_scale, tile_causal, None)

    outs, lses = [], []
    for i in range(n):
        if causal:
            o = lse = None
            for j in range(i + 1):
                o_hop, lse_hop = hop(i, j, j == i)
                if o is None:
                    # a single-hop row stays in the kernel dtype
                    o, lse = o_hop, lse_hop
                else:
                    o, lse = lse_combine(o.float(), lse, o_hop, lse_hop)
        else:
            o = torch.zeros((BH, c, D), dtype=torch.float32, device=q.device)
            lse = torch.full((BH, c), NEG_INF, dtype=torch.float32,
                             device=q.device)
            for j in range(n):
                o, lse = lse_combine(o, lse, *hop(i, j, False))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)
