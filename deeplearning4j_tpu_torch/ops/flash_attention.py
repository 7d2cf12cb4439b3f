"""Fused (flash) attention forward — the port of the JAX package's
ops/flash_attention.py forward entry points, on one hand-written CUDA
kernel (csrc/flash_fwd.cu).

Two TPU kernels map onto it:

* K1 — `_flash_fwd` -> `_fwd_kernel` (flat [BH, T, D] layout, optional
  [BH, 1, T] key mask). Callers: `flash_attention`,
  `flash_attention_lse_masked` (chunked prefill, nn/decode.py) and the
  flat rung of SelfAttention's dispatch ladder (512 < T <= 8192).
* K2 — `_flash_fwd_qkv` -> `_fwd_kernel(packed_heads=True)`: the same
  attention read as head column slices of the packed [B, T, 3n]
  projection, written back as [B, T, n] — no per-head relayout. At
  head_dim 64 (even H) the same kernel computes the forward function of
  the TPU head-pair kernel `_flash_fwd_qkv_pair` (K3).

The kernel takes strides, so both wrappers hand it views: the packed
route never copies q, k or v out of the projection, and the flat route
reads any [BH, T, D] view whose last dimension is contiguous.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes `_flash_fwd_reference`, the plain PyTorch version of the same
function (f32 softmax math) — this is what the CPU tests run. On a CUDA
tensor it launches the kernel or raises; nothing falls back. Each
wrapper counts its kernel launches in a plain int attribute
(`_flash_fwd.launches`, `_flash_fwd_qkv.launches`) so a run can show
that its main path went through the kernel.

What bounds the kernel on the H100 and what its design does about it:
see the note at the top of csrc/flash_fwd.cu. Forward only: the
autograd Function and the backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

NEG_INF = -1e30
BLOCK = 128
BLOCK_Q_MAX = 512

# the dispatch envelope of the JAX package (ops/flash_attention.py),
# kept identical so both packages route the same shapes to flash
MIN_FLASH_SEQ = 512
MAX_FLASH_T = 8192

# what the CUDA kernel takes (csrc/flash_fwd.cu): head dims it is
# instantiated for, its query/key tile, and the element types
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_TILE = 64
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_MASK_FLOOR = -1e20
_L_FLOOR = 1e-30


def supports(q_shape, *, causal, dropout, mask) -> bool:
    """Whether the flat fused kernel handles this case. q_shape is
    [B, H, T, D] — T at index 2. Same envelope as the JAX package."""
    T = q_shape[2]
    return MIN_FLASH_SEQ <= T <= MAX_FLASH_T and T % BLOCK == 0


def supports_qkv(B, T, n, H, *, dropout) -> bool:
    """Envelope of the packed no-relayout path: head_dim a multiple of
    128, or exactly 64 with an even head count, and a single-block
    sequence length. Same envelope as the JAX package."""
    if n % H:
        return False
    D = n // H
    dim_ok = D % 128 == 0 or (D == 64 and H % 2 == 0)
    return dim_ok and MIN_FLASH_SEQ <= T <= BLOCK_Q_MAX and T % BLOCK == 0


# ------------------------------------------------------- plain version

def _flash_fwd_reference(q, k, v, kmask, sm_scale, causal):
    """Plain PyTorch version of the kernel's function. q, k, v
    [BH, T, D]; kmask [BH, T] (> 0 = visible key) or None. Returns
    (o [BH, T, D] in q's dtype, lse [BH, T] f32). Scores, softmax and
    the P.V product are f32; a fully masked row gives o = 0 and
    lse ~= -1e20, as the kernel and the JAX package do."""
    T = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = sm_scale * (qf @ kf.transpose(-1, -2))
    if causal:
        tri = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    if kmask is not None:
        s = s.masked_fill(~(kmask[:, None, :] > 0), NEG_INF)
    m = s.amax(-1)
    if kmask is not None:
        m = m.clamp_min(_MASK_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(_L_FLOOR)
    o = (p @ vf) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _flash_fwd_qkv_reference(qkv, H, kmask, sm_scale, causal):
    """Plain PyTorch version of the packed route: qkv [B, T, 3n], kmask
    [B, T] or None -> (o [B, T, n], lse [B, H, 1, T] f32)."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    D = n // H
    flat = [_heads(t, H).reshape(B * H, T, D) for t in qkv.split(n, dim=-1)]
    o, lse = _flash_fwd_reference(
        *flat, None if kmask is None else kmask.repeat_interleave(H, 0),
        sm_scale, causal)
    return (o.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, n),
            lse.reshape(B, H, 1, T))


# --------------------------------------------------------- the launch

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _kernel():
    """The C entry point of csrc/flash_fwd.cu, built on first use."""
    fn = cuda_build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    return fn


def _launch(q, k, v, kmask, o, lse, sm_scale, causal):
    """Launch csrc/flash_fwd.cu on [B, H, T, D] views (any strides, last
    dimension contiguous). kmask: [B, T] f32 contiguous or None; o: a
    [B, H, T, D] view to write; lse: [B*H, T] f32 contiguous."""
    B, H, T, D = q.shape
    tensors = [q, k, v, o, lse] + ([] if kmask is None else [kmask])
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash kernel: every tensor must be on the same "
                         f"CUDA device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, o)):
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, k, v, o "
                         f"of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {o.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIMS}; got {D}")
    if T % KERNEL_TILE:
        raise ValueError(f"flash kernel needs T % {KERNEL_TILE} == 0; "
                         f"got T={T}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
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
    fn = _kernel()

    def bht(t):  # element strides of the b, h and t dimensions
        return t.stride(0), t.stride(1), t.stride(2)

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(),k.data_ptr(), v.data_ptr(),
                None if kmask is None else kmask.data_ptr(),
                o.data_ptr(), lse.data_ptr(), _KERNEL_DTYPES[q.dtype], D, B,
                H, T, *bht(q), *bht(k), *bht(v), *bht(o), float(sm_scale),
                int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (code {rc}) at "
                           f"B={B} H={H} T={T} D={D} dtype={q.dtype}")


# ------------------------------------------------------------ wrappers

def _flash_fwd(q, k, v, kmask, sm_scale, causal):
    """K1. q, k, v [BH, T, D]; kmask [BH, 1, T] (> 0 = visible key) or
    None. Returns (o [BH, T, D] in q's dtype, lse [BH, T] f32)."""
    BH, T, D = q.shape
    km = None if kmask is None else kmask.reshape(BH, T).to(torch.float32)
    if q.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, km, sm_scale, causal)
    o = torch.empty((BH, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    _launch(q[:, None], k[:, None], v[:, None],
            None if km is None else km.contiguous(), o[:, None], lse,
            sm_scale, causal)
    _flash_fwd.launches += 1
    return o, lse


_flash_fwd.launches = 0


def _heads(t, H):
    """[B, T, H*D] view -> [B, H, T, D] view (no copy)."""
    return t.unflatten(-1, (H, t.shape[-1] // H)).transpose(1, 2)


def _flash_fwd_qkv(qkv, H, kmask, sm_scale, causal):
    """K2. qkv [B, T, 3n] (the x @ Wqkv output, q|k|v each n = H*D
    wide); kmask [B, 1, T] or None. Returns (o [B, T, n] in qkv's dtype,
    lse [B, H, 1, T] f32). The kernel reads each head's column slice in
    place and writes o in [B, T, n] — no relayout either way."""
    B, T, three_n = qkv.shape
    n = three_n // 3
    km = None if kmask is None else kmask.reshape(B, T).to(torch.float32)
    if qkv.device.type == "cpu":
        return _flash_fwd_qkv_reference(qkv, H, km, sm_scale, causal)
    q, k, v = (_heads(t, H) for t in qkv.split(n, dim=-1))
    o = torch.empty((B, T, n), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=qkv.device)
    _launch(q, k, v, None if km is None else km.contiguous(), _heads(o, H),
            lse, sm_scale, causal)
    _flash_fwd_qkv.launches += 1
    return o, lse.reshape(B, H, 1, T)


_flash_fwd_qkv.launches = 0


def flash_attention_lse_masked(q, k, v, kmask, sm_scale, causal):
    """Flat-layout flash returning (o [BH, T, D], lse [BH, T]) with a
    [BH, 1, T] key padding mask — the within-chunk primitive of chunked
    prefill (nn/decode.py). A fully masked row emits lse ~ -1e20 and a
    zero row, which the lse merge weighs away."""
    return _flash_fwd(q, k, v, kmask, sm_scale, causal)


def _broadcast_kmask(mask, B, H, T):
    """[B, T] key padding mask -> the flat kernels' [B*H, 1, T] operand."""
    return (mask.to(torch.float32)[:, None, :].expand(B, H, T)
            .reshape(B * H, 1, T))


def flash_attention(q, k, v, *, causal=True, sm_scale=None, mask=None):
    """q, k, v: [B, H, T, D] -> [B, H, T, D]. mask: optional [B, T] key
    padding mask (1 = valid key), the dense path's semantics."""
    B, H, T, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kmask = None if mask is None else _broadcast_kmask(mask, B, H, T)
    o, _ = _flash_fwd(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                      v.reshape(B * H, T, D), kmask, sm_scale, causal)
    return o.reshape(B, H, T, D)


def flash_attention_qkv(qkv, n_heads, *, causal=True, sm_scale=None,
                        mask=None):
    """Packed-projection attention: qkv [B, T, 3n] -> out [B, T, n],
    never materializing a [B, H, T, D] relayout. Check `supports_qkv`
    first. mask: optional [B, T] key padding mask."""
    B, T, three_n = qkv.shape
    D = three_n // 3 // n_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kmask = None if mask is None else mask.to(torch.float32)[:, None, :]
    o, _ = _flash_fwd_qkv(qkv, n_heads, kmask, sm_scale, causal)
    return o
