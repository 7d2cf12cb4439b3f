"""Fused LayerNorm — the port of the JAX package's ops/fused_layernorm.py
on hand-written CUDA kernels (csrc/layernorm.cu). An op, not the
default: the port's `LayerNormImpl` (nn/layers/attention.py) stays in
plain PyTorch, as the JAX package's stays in jnp, so no path of either
package runs these kernels.

* K10 — `_ln_fwd` (TPU `_ln_fwd` -> `_fwd_kernel`): y in x's dtype, and
  the per-row mu and rstd in f32.
* K11 — `_ln_bwd` (TPU `_ln_bwd` -> `_bwd_kernel`): dx in x's dtype and
  f32 dgamma/dbeta. The kernels write per-block partials and sum them
  on the card in the same C entry (the TPU wrapper sums its partials
  outside its kernel); no PyTorch kernel runs in a call.

`fused_layer_norm` is a `torch.autograd.Function` over the two (the JAX
package's custom VJP). The kernels take any N and C; the TPU envelope
(C % 128 == 0, N % 8 == 0) does not bind them. gamma and beta are of x's
dtype or, beside bf16 x, f32: the JAX kernels cast them to f32 inside, so
an f32 gamma is read as it is (never rounded to bf16); the Function
widens a gamma or beta of another dtype than x's to f32 (`_params`),
which is exact from bf16.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes its plain PyTorch version (`_ln_fwd_reference`,
`_ln_bwd_reference`), which is what the CPU tests run. On a CUDA tensor
it launches its kernel or raises; nothing falls back. Launches are
counted in `LAUNCHES` ("K10", "K11"). On the card each direction has
two instantiations, a one-pass vector kernel with the row in registers
and a general path; `_fwd_plan` and `_bwd_plan` pick by shape and
alignment before the launch.

The launch path is lean, since at these sizes the host's time per call
exceeds the kernel's: the checks build text only when they raise, the
typed C entry is cached (`cuda_build.entry`), the stream handle is read
raw (`cuda_build.stream_handle`), no device context is entered when x
is on the current device, mu and rstd are one allocation, and so are
dgamma, dbeta and the backward's partials.

What bounds the kernels on the H100 and what their design does about
it: see the note at the top of csrc/layernorm.cu.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import (autotune, cuda_build, opcount,
                                          refuse_double_backward)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# rows summed into one dgamma/dbeta partial by the backward's general
# column pass
PARTIAL_ROWS = 64
# the backward's vector kernel: warps a block, and blocks (each one
# partial): 2 blocks on each of an H100's 132 SMs, a constant so that the
# sums' order, and so their bits, do not depend on the card (a tuning
# table's `blocks`, ops/autotune.py, applies only on the card it names)
BWD_WARPS = 8
BWD_BLOCKS = 264
# its most 16-byte vectors a lane (csrc/layernorm.cu lnv::MAX_BWD_NV): C
# up to 512 in bf16, 256 in f32; wider rows take the general path
MAX_BWD_VEC_PER_LANE = 2

# launches counted where a wrapper launches its kernel, and nowhere else
LAUNCHES = {"K10": 0, "K11": 0}


# ------------------------------------------------------ plain versions

def _ln_fwd_reference(x2d, gamma, beta, eps):
    """Plain version of K10: x [N, C] -> (y [N, C] in x's dtype, mu [N]
    f32, rstd [N] f32), the TPU kernel's math."""
    x = x2d.float()
    mu = x.mean(1)
    xc = x - mu[:, None]
    rstd = torch.rsqrt((xc * xc).mean(1) + eps)
    y = xc * rstd[:, None] * gamma.float()[None] + beta.float()[None]
    return y.to(x2d.dtype), mu, rstd


def _ln_bwd_reference(x2d, gamma, mu, rstd, dy):
    """Plain version of K11: (dx [N, C] in x's dtype, dgamma [C] f32,
    dbeta [C] f32)."""
    x, g = x2d.float(), dy.float()
    xn = (x - mu[:, None]) * rstd[:, None]
    wdy = g * gamma.float()[None]
    m1 = wdy.mean(1, keepdim=True)
    m2 = (wdy * xn).mean(1, keepdim=True)
    dx = rstd[:, None] * (wdy - m1 - xn * m2)
    return dx.to(x2d.dtype), (g * xn).sum(0), g.sum(0)


# --------------------------------------------------------- the launches

_FN_ARGTYPES = {
    "ln_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    "ln_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}

# the vector forward's most 16-byte vectors a lane (csrc/layernorm.cu
# lnv::MAX_NV): C up to 1024 in bf16, 512 in f32
MAX_VEC_PER_LANE = 4


def _fwd_plan(C, elem_bytes, ptrs):
    """K10's instantiation for a row of C elements of `elem_bytes` bytes
    and the data pointers of x, gamma, beta and y: the vector kernel's
    16-byte vectors a lane (1 to MAX_VEC_PER_LANE), when a warp's lanes
    cover the row in whole vectors and every pointer is 16-byte aligned;
    else 0, the general kernel. Dispatch by shape: both instantiations
    compute the same function, and a launch that fails raises."""
    nv, rem = divmod(C, 32 * (16 // elem_bytes))
    if rem or not 1 <= nv <= MAX_VEC_PER_LANE:
        return 0
    for ptr in ptrs:
        if ptr & 15:
            return 0
    return nv


def _bwd_plan(N, C, elem_bytes, ptrs, wide_params=False):
    """K11's instantiation for N rows of C elements of `elem_bytes` bytes
    and the data pointers of x, gamma, dy and dx: (nv, blocks). The
    vector kernel (nv its 16-byte vectors a lane) when a warp's lanes
    cover the row in 1 to MAX_BWD_VEC_PER_LANE whole vectors each (1
    with `wide_params`, an f32 gamma beside bf16 x, whose registers
    double) and every pointer is 16-byte aligned, on a grid of
    `bwd_blocks(N, C)` blocks; else (0, the general column pass's
    partials, ceil(N / PARTIAL_ROWS)). Each block or chunk writes one
    partial; the C entry sums them."""
    nv, rem = divmod(C, 32 * (16 // elem_bytes))
    most = 1 if wide_params else MAX_BWD_VEC_PER_LANE
    if rem or not 1 <= nv <= most or any(ptr & 15 for ptr in ptrs):
        return 0, -(-N // PARTIAL_ROWS)
    return nv, bwd_blocks(N, C)


def bwd_blocks(N, C):
    """The vector backward's grid for N rows of C: min(BWD_BLOCKS,
    ceil(N / BWD_WARPS)), or the tuning table's `blocks` for (N, C)
    (ops/autotune.py `ln_bwd_blocks`, from 1 to ceil(N / BWD_WARPS))."""
    rows = -(-N // BWD_WARPS)
    return autotune.ln_bwd_blocks(N, C, min(BWD_BLOCKS, rows), rows)


def _param_dtype_ok(x_dtype, p_dtype):
    """Whether the kernels take gamma/beta of `p_dtype` beside x of
    `x_dtype`: the same dtype, or f32 beside bf16."""
    return p_dtype == x_dtype or (x_dtype == torch.bfloat16
                                  and p_dtype == torch.float32)


def supports(shape, dtype=None) -> bool:
    """Whether K10/K11 (csrc/layernorm.cu) take an x of `shape` and
    `dtype` (None: either kernel dtype): float32 or bfloat16, at least
    two dims, every dim >= 1, and the rows N (the leading dims' product)
    and width C in int32. This is the CUDA kernels' envelope, not the
    Pallas one of the JAX `supports` (C % 128 == 0, N % 8 == 0): the
    kernels take ragged rows and any width."""
    if len(shape) < 2 or min(shape) < 1:
        return False
    if dtype is not None and dtype not in _KERNEL_DTYPES:
        return False
    return math.prod(shape[:-1]) < 2 ** 31 and shape[-1] < 2 ** 31


def _ok(x2d, vectors, mats=(), stats=()):
    """Whether the kernels take these tensors: CUDA tensors on x's
    device, x [N, C] float32/bfloat16 with N, C >= 1, `vectors` [C] of
    one dtype that `_param_dtype_ok` takes, `mats` [N, C] of x's dtype,
    `stats` f32 [N], all contiguous."""
    if x2d.dim() != 2:
        return False
    N, C = x2d.shape
    dev, dt = x2d.get_device(), x2d.dtype
    if dev < 0 or dt not in _KERNEL_DTYPES or N < 1 or C < 1 \
            or not x2d.is_contiguous():
        return False
    pdt = vectors[0].dtype
    if not _param_dtype_ok(dt, pdt):
        return False
    for ts, dtype, shape in ((vectors, pdt, (C,)), (mats, dt, (N, C)),
                             (stats, torch.float32, (N,))):
        for t in ts:
            if t.dtype != dtype or t.get_device() != dev \
                    or t.shape != shape or not t.is_contiguous():
                return False
    return True


def _check(x2d, vectors, mats=(), stats=()):
    """Raise, naming what is wrong, unless `_ok`."""
    if _ok(x2d, vectors, mats, stats):
        return
    tensors = (x2d,) + tuple(vectors) + tuple(mats) + tuple(stats)
    if any(t.device.type != "cuda" or t.device != x2d.device
           for t in tensors):
        raise ValueError("layernorm kernel: every tensor must be on the "
                         "same CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    same = (x2d,) + tuple(vectors) + tuple(mats)
    if x2d.dtype not in _KERNEL_DTYPES \
            or any(t.dtype != x2d.dtype for t in mats) \
            or any(t.dtype != vectors[0].dtype for t in vectors) \
            or not _param_dtype_ok(x2d.dtype, vectors[0].dtype):
        raise ValueError("layernorm kernel takes float32 or bfloat16 x and "
                         "dy of one dtype, and gamma, beta of x's dtype or "
                         "f32 beside bf16 x; got "
                         f"{[t.dtype for t in same]}")
    if any(t.dtype != torch.float32 for t in stats):
        raise ValueError("layernorm kernel: mu and rstd must be f32 [N]")
    raise ValueError(f"layernorm kernel: shapes x {tuple(x2d.shape)}, "
                     f"{[tuple(t.shape) for t in same[1:] + tuple(stats)]} "
                     "disagree, or a tensor is empty or not contiguous")


def _run(name, x, *args):
    """Launch `name` with `args` on x's device and current stream; raise
    if the C entry refuses or the launch fails."""
    fn = cuda_build.entry("layernorm", name, _FN_ARGTYPES[name])
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        rc = fn(*args, cuda_build.stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, cuda_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc}) at "
                           f"x {tuple(x.shape)} dtype={x.dtype}")


def _ln_fwd(x2d, gamma, beta, eps):
    """K10. x [N, C], gamma/beta [C] -> (y, mu f32 [N], rstd f32 [N]);
    mu and rstd are the two rows of one [2, N] tensor."""
    with opcount.kernel("K10", 8 * x2d.numel()):
        return _ln_fwd_dispatch(x2d, gamma, beta, eps)


def _ln_fwd_dispatch(x2d, gamma, beta, eps):
    if x2d.is_cpu:
        return _ln_fwd_reference(x2d, gamma, beta, eps)
    _check(x2d, (gamma, beta))
    N, C = x2d.shape
    y = torch.empty_like(x2d)
    stats = torch.empty((2, N), dtype=torch.float32, device=x2d.device)
    xp, gp, bp, yp = (x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr())
    _run("ln_fwd", x2d, xp, gp, bp, yp, stats.data_ptr(),
         _KERNEL_DTYPES[x2d.dtype], _KERNEL_DTYPES[gamma.dtype],
         _fwd_plan(C, x2d.element_size(), (xp, gp, bp, yp)), N, C,
         float(eps))
    LAUNCHES["K10"] += 1
    mu, rstd = stats.unbind(0)
    return y, mu, rstd


def _ln_bwd(x2d, gamma, mu, rstd, dy):
    """K11. -> (dx in x's dtype, dgamma f32 [C], dbeta f32 [C]); dgamma
    and dbeta are the two rows of one tensor that also holds the
    kernels' partials."""
    with opcount.kernel("K11", 12 * x2d.numel()):
        return _ln_bwd_dispatch(x2d, gamma, mu, rstd, dy)


def _ln_bwd_dispatch(x2d, gamma, mu, rstd, dy):
    if x2d.is_cpu:
        return _ln_bwd_reference(x2d, gamma, mu, rstd, dy)
    _check(x2d, (gamma,), (dy,), (mu, rstd))
    N, C = x2d.shape
    dx = torch.empty_like(x2d)
    xp, gp, dyp, dxp = (x2d.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                        dx.data_ptr())
    nv, blocks = _bwd_plan(N, C, x2d.element_size(), (xp, gp, dyp, dxp),
                           gamma.dtype != x2d.dtype)
    dgdb = torch.empty((1 + blocks, 2, C), dtype=torch.float32,
                       device=x2d.device)
    _run("ln_bwd", x2d, xp, gp, mu.data_ptr(), rstd.data_ptr(), dyp, dxp,
         dgdb.data_ptr(), _KERNEL_DTYPES[x2d.dtype],
         _KERNEL_DTYPES[gamma.dtype], nv, blocks, N, C)
    LAUNCHES["K11"] += 1
    dg, db = dgdb[0].unbind(0)
    return dx, dg, db


def _params(x, gamma, beta):
    """gamma and beta as the kernels take them beside x: contiguous, and
    of x's dtype or, where either differs from x's, both widened to f32
    (exact from bf16; the JAX kernels compute with them in f32)."""
    if gamma.dtype != x.dtype or beta.dtype != x.dtype:
        gamma, beta = gamma.float(), beta.float()
    return gamma.contiguous(), beta.contiguous()


class _FusedLayerNorm(torch.autograd.Function):
    """The custom VJP of the JAX package's `fused_layer_norm`: the
    forward saves (x, gamma, mu, rstd), the backward is K11; dgamma and
    dbeta come back in gamma's and beta's own dtypes."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1]).contiguous()
        g, b = _params(x, gamma, beta)
        y, mu, rstd = _ln_fwd(x2d, g, b, eps)
        ctx.save_for_backward(x2d, g, mu, rstd)
        ctx.dtypes = gamma.dtype, beta.dtype
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        refuse_double_backward("_FusedLayerNorm")
        x2d, g, mu, rstd = ctx.saved_tensors
        shape = dy.shape
        dx, dg, db = _ln_bwd(x2d, g, mu, rstd,
                             dy.reshape(-1, shape[-1]).contiguous())
        return (dx.reshape(shape), dg.to(ctx.dtypes[0]),
                db.to(ctx.dtypes[1]), None)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the LAST axis of x (any leading shape), fused.
    Returns y with x's dtype; statistics and normalization math in f32."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)
