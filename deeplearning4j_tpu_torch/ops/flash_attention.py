"""Fused (flash) attention — the port of the JAX package's
ops/flash_attention.py on two hand-written CUDA sources:
csrc/flash_fwd.cu (forward) and csrc/flash_bwd.cu (backward).

Forward (csrc/flash_fwd.cu):

* K1 — `_flash_fwd` -> `_fwd_kernel` (flat [BH, T, D] layout, optional
  [BH, 1, T] key mask). Callers: `flash_attention`,
  `flash_attention_lse_masked` (chunked prefill, nn/decode.py) and the
  flat rung of SelfAttention's dispatch ladder (512 < T <= 8192).
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

`_FlashCore` and `_FlashQkvCore` are the `torch.autograd.Function`s of
the JAX package's custom VJPs (`_flash_core[_masked]`,
`_flash_qkv_core[_masked]`): the forward saves (q, k, v or qkv, o, lse
and the mask), the backward runs the kernels above, and the mask gets
no gradient. In-kernel attention dropout is not ported yet: a nonzero
`dropout` raises.

The kernels take strides, so the wrappers hand them views: the packed
route never copies q, k or v out of the projection, and the flat route
reads any [BH, T, D] view whose last dimension is contiguous.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes its plain PyTorch version (`_flash_fwd_reference`,
`_flash_bwd_reference`: f32 softmax math, the backward written out as
ds = p * (dp - delta), with p (forward and backward) and ds rounded to
the operand dtype where the JAX kernels round them) — this is what the
CPU tests run. On a CUDA tensor it launches the kernel or raises;
nothing falls back. The wrappers count kernel launches in `LAUNCHES`
(one entry per TPU kernel, K1-K7) so a run can show that its main path
went through the kernels.

What bounds the kernels on the H100 and what their design does about
it: see the notes at the top of csrc/flash_fwd.cu and csrc/flash_bwd.cu.
"""

from __future__ import annotations

import ctypes
import math
import warnings

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

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


def _flash_fwd_reference(q, k, v, kmask, sm_scale, causal):
    """Plain PyTorch version of the forward kernel's function. q, k, v
    [BH, T, D]; kmask [BH, T] (> 0 = visible key) or None. Returns
    (o [BH, T, D] in q's dtype, lse [BH, T] f32). Scores, softmax and
    the P.V sums are f32, with p rounded to the operand dtype for P.V
    (the identity in f32) where the JAX blocked kernel rounds it, and l
    summed from the unrounded p; a fully masked row gives o = 0 and
    lse ~= -1e20, as the kernel and the JAX package do."""
    s = _scores(q, k, kmask, sm_scale, causal)
    m = s.amax(-1)
    if kmask is not None:
        m = m.clamp_min(_MASK_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(_L_FLOOR)
    o = (p.to(v.dtype).float() @ v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _flash_bwd_reference(q, k, v, o, lse, do, kmask, sm_scale, causal):
    """Plain PyTorch version of the backward kernel's function, written
    out (not autograd): q, k, v, o, do [BH, T, D]; lse [BH, T] from the
    forward; kmask [BH, T] or None. In f32: p = exp(s - lse), delta =
    rowsum(do * o), ds = p * (dp - delta) * sm_scale; p and ds rounded to
    the operand dtype, then dq = ds.k, dk = ds^T.q, dv = p^T.do (f32
    sums) in the dtypes of q, k, v."""
    qf, kf, gf = q.float(), k.float(), do.float()
    p = torch.exp(_scores(q, k, kmask, sm_scale, causal) - lse[..., None])
    delta = (gf * o.float()).sum(-1)
    dp = gf @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sm_scale
    # P and dS rounded to the operand dtype for the second products, as
    # the JAX split kernels round them (`_dq_kernel`, `_dkv_kernel`);
    # the identity in f32
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(k.dtype),
            (p.transpose(-1, -2) @ gf).to(v.dtype))


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


def _flash_fwd_qkv_reference(qkv, H, kmask, sm_scale, causal):
    """Plain PyTorch version of the packed route: qkv [B, T, 3n], kmask
    [B, T] or None -> (o [B, T, n], lse [B, H, 1, T] f32)."""
    B, T, three_n = qkv.shape
    flat = [_flat_heads(t, H) for t in qkv.split(three_n // 3, dim=-1)]
    o, lse = _flash_fwd_reference(
        *flat, None if kmask is None else kmask.repeat_interleave(H, 0),
        sm_scale, causal)
    return _unflat_heads(o, B), lse.reshape(B, H, 1, T)


def _flash_bwd_qkv_reference(qkv, o, lse, do, H, kmask, sm_scale, causal):
    """Plain PyTorch version of the packed backward: qkv [B, T, 3n]; o,
    do [B, T, n]; lse [B, H, 1, T]; kmask [B, T] or None -> dqkv
    [B, T, 3n]."""
    B, T, three_n = qkv.shape
    flat = [_flat_heads(t, H) for t in qkv.split(three_n // 3, dim=-1)]
    grads = _flash_bwd_reference(
        *flat, _flat_heads(o, H), lse.reshape(B * H, T), _flat_heads(do, H),
        None if kmask is None else kmask.repeat_interleave(H, 0), sm_scale,
        causal)
    return torch.cat([_unflat_heads(g, B) for g in grads], dim=-1)


# --------------------------------------------------------- the launches

_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p])


def _kernel(name, argtypes):
    """The C entry point `name` of csrc/<name>.cu, built on first use."""
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _check_launch(views, lse, kmask):
    """Raise on what the kernels do not take. views: {name: [B, H, T, D]
    view} (any strides, last dimension contiguous), the first one q;
    lse: [B*H, T] f32 contiguous; kmask: [B, T] f32 contiguous or
    None."""
    q = next(iter(views.values()))
    B, H, T, D = q.shape
    tensors = list(views.values()) + [lse] + ([] if kmask is None
                                              else [kmask])
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
    if lse.shape != (B * H, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash kernel: lse must be [B*H, T] f32 contiguous")
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


def _launch(q, k, v, kmask, o, lse, sm_scale, causal):
    """Launch csrc/flash_fwd.cu on [B, H, T, D] views (any strides, last
    dimension contiguous). kmask: [B, T] f32 contiguous or None; o: a
    [B, H, T, D] view to write; lse: [B*H, T] f32 contiguous."""
    views = {"q": q, "k": k, "v": v, "o": o}
    _check_launch(views, lse, kmask)
    _check_bf16_alignment(views, lse, kmask)
    B, H, T, D = q.shape
    rc = _call(_kernel("flash_fwd", _FWD_ARGTYPES), q,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kmask),
               o.data_ptr(), lse.data_ptr(), _KERNEL_DTYPES[q.dtype], D, B,
               H, T, *_bht(q), *_bht(k), *_bht(v), *_bht(o),
               float(sm_scale), int(bool(causal)))
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (code {rc}) at "
                           f"B={B} H={H} T={T} D={D} dtype={q.dtype}")


def _launch_bwd(q, k, v, o, do, lse, kmask, dq, dk, dv, sm_scale, causal):
    """Launch csrc/flash_bwd.cu on [B, H, T, D] views: reads q, k, v, o,
    do, lse and kmask ([B, T] or None), writes dq, dk, dv. The kernel's
    delta = rowsum(do * o) goes to a [B*H, T] f32 scratch allocated
    here."""
    views = {"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq, "dk": dk,
             "dv": dv}
    _check_launch(views, lse, kmask)
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
               float(sm_scale), int(bool(causal)))
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


def _kmask_rows(kmask, rows, T):
    """[rows, 1, T] key mask operand -> [rows, T] f32 contiguous, or
    None."""
    return None if kmask is None else (kmask.reshape(rows, T)
                                       .to(torch.float32).contiguous())


def _rows(t):
    """t with a contiguous last dimension, as the kernels read it."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _flash_fwd(q, k, v, kmask, sm_scale, causal):
    """K1. q, k, v [BH, T, D]; kmask [BH, 1, T] (> 0 = visible key) or
    None. Returns (o [BH, T, D] in q's dtype, lse [BH, T] f32)."""
    BH, T, D = q.shape
    km = _kmask_rows(kmask, BH, T)
    if q.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, km, sm_scale, causal)
    o = torch.empty((BH, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    _launch(q[:, None], k[:, None], v[:, None], km, o[:, None], lse,
            sm_scale, causal)
    LAUNCHES["K1"] += 1
    return o, lse


def _flash_fwd_qkv(qkv, H, kmask, sm_scale, causal):
    """K2, and K3 at head_dim 64. qkv [B, T, 3n] (the x @ Wqkv output,
    q|k|v each n = H*D wide); kmask [B, 1, T] or None. Returns (o
    [B, T, n] in qkv's dtype, lse [B, H, 1, T] f32). The kernel reads
    each head's column slices in place and writes o in [B, T, n]."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    km = _kmask_rows(kmask, B, T)
    if qkv.device.type == "cpu":
        return _flash_fwd_qkv_reference(qkv, H, km, sm_scale, causal)
    q, k, v = (_heads(t, H) for t in qkv.split(n, dim=-1))
    o = torch.empty((B, T, n), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=qkv.device)
    _launch(q, k, v, km, _heads(o, H), lse, sm_scale, causal)
    LAUNCHES["K3" if n // H == 64 else "K2"] += 1
    return o, lse.reshape(B, H, 1, T)


def flash_attention_lse_masked(q, k, v, kmask, sm_scale, causal):
    """Flat-layout flash returning (o [BH, T, D], lse [BH, T]) with a
    [BH, 1, T] key padding mask — the within-chunk primitive of chunked
    prefill (nn/decode.py; inference only). A fully masked row emits
    lse ~ -1e20 and a zero row, which the lse merge weighs away."""
    return _flash_fwd(q, k, v, kmask, sm_scale, causal)


def _flash_bwd_impl(q, k, v, o, lse, do, kmask, sm_scale, causal):
    """K4 at T <= BLOCK_Q_MAX (the TPU's single-block body), else K5
    (its dq/dkv split); one kernel either way. q, k, v, o, do
    [BH, T, D]; lse [BH, T]; kmask [BH, 1, T] or None. Returns (dq, dk,
    dv)."""
    BH, T, D = q.shape
    km = _kmask_rows(kmask, BH, T)
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, o, lse, do, km, sm_scale,
                                    causal)
    grads = [torch.empty((BH, T, D), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    _launch_bwd(*(_rows(t)[:, None] for t in (q, k, v, o, do)),
                lse.contiguous(), km, *(g[:, None] for g in grads),
                sm_scale, causal)
    LAUNCHES["K4" if T <= BLOCK_Q_MAX else "K5"] += 1
    return tuple(grads)


def _flash_bwd_qkv(qkv, o, lse, do, H, kmask, sm_scale, causal):
    """K6, and K7 at head_dim 64. qkv [B, T, 3n]; o, do [B, T, n]; lse
    [B, H, 1, T]; kmask [B, 1, T] or None. Returns dqkv [B, T, 3n]: the
    kernel reads each head's column slices of qkv, o and do in place and
    writes dq|dk|dv straight into the one gradient."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    km = _kmask_rows(kmask, B, T)
    if qkv.device.type == "cpu":
        return _flash_bwd_qkv_reference(qkv, o, lse, do, H, km, sm_scale,
                                        causal)
    q, k, v = (_heads(t, H) for t in qkv.split(n, dim=-1))
    dqkv = torch.empty((B, T, three_n), dtype=qkv.dtype, device=qkv.device)
    dq, dk, dv = (_heads(t, H) for t in dqkv.split(n, dim=-1))
    _launch_bwd(q, k, v, _heads(_rows(o), H), _heads(_rows(do), H),
                lse.reshape(B * H, T).contiguous(), km, dq, dk, dv,
                sm_scale, causal)
    LAUNCHES["K7" if n // H == 64 else "K6"] += 1
    return dqkv


# ------------------------------------------------- autograd and public

class _FlashCore(torch.autograd.Function):
    """`_flash_core` / `_flash_core_masked`: q, k, v [BH, T, D], kmask
    [BH, 1, T] or None -> o [BH, T, D]."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, sm_scale, causal):
        o, lse = _flash_fwd(q, k, v, kmask, sm_scale, causal)
        ctx.save_for_backward(q, k, v, o, lse, kmask)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kmask = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, o, lse, do.to(o.dtype), kmask,
                                     ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None, None


class _FlashQkvCore(torch.autograd.Function):
    """`_flash_qkv_core` / `_flash_qkv_core_masked`: qkv [B, T, 3n],
    kmask [B, 1, T] or None -> o [B, T, n]."""

    @staticmethod
    def forward(ctx, qkv, kmask, H, sm_scale, causal):
        o, lse = _flash_fwd_qkv(qkv, H, kmask, sm_scale, causal)
        ctx.save_for_backward(qkv, o, lse, kmask)
        ctx.H, ctx.sm_scale, ctx.causal = H, sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, kmask = ctx.saved_tensors
        dqkv = _flash_bwd_qkv(qkv, o, lse, do.to(o.dtype), ctx.H, kmask,
                              ctx.sm_scale, ctx.causal)
        return dqkv, None, None, None, None


def _no_dropout(dropout):
    if dropout:
        raise NotImplementedError(
            f"attention dropout {dropout} on a flash route: the in-kernel "
            "dropout hash (the JAX package's `_keep_mask`) is not ported "
            "yet; it comes with a later slice of the port (ROADMAP Queue "
            "A item 2). Train with attention_dropout=0, or with "
            "use_flash=False for the dense route, which drops attention "
            "weights")


def _broadcast_kmask(mask, B, H, T):
    """[B, T] key padding mask -> the flat kernels' [B*H, 1, T] operand."""
    return (mask.to(torch.float32)[:, None, :].expand(B, H, T)
            .reshape(B * H, 1, T))


def flash_attention(q, k, v, *, causal=True, sm_scale=None, mask=None,
                    dropout=0.0):
    """q, k, v: [B, H, T, D] -> [B, H, T, D]; differentiable. mask:
    optional [B, T] key padding mask (1 = valid key), the dense path's
    semantics — masked keys get no probability mass and zero dk/dv.
    dropout must be 0 (see `_no_dropout`)."""
    _no_dropout(dropout)
    B, H, T, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kmask = None if mask is None else _broadcast_kmask(mask, B, H, T)
    o = _FlashCore.apply(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                         v.reshape(B * H, T, D), kmask, sm_scale,
                         bool(causal))
    return o.reshape(B, H, T, D)


def flash_attention_qkv(qkv, n_heads, *, causal=True, sm_scale=None,
                        mask=None, dropout=0.0):
    """Packed-projection attention: qkv [B, T, 3n] -> out [B, T, n],
    never materializing a [B, H, T, D] relayout; differentiable (the
    gradient is written into one [B, T, 3n] tensor). Check
    `supports_qkv` first. mask: optional [B, T] key padding mask.
    dropout must be 0 (see `_no_dropout`)."""
    _no_dropout(dropout)
    B, T, three_n = qkv.shape
    D = three_n // 3 // n_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kmask = None if mask is None else mask.to(torch.float32)[:, None, :]
    return _FlashQkvCore.apply(qkv, kmask, n_heads, sm_scale, bool(causal))
