"""Fused LayerNorm — the port of the JAX package's ops/fused_layernorm.py
on hand-written CUDA kernels (csrc/layernorm.cu). An op, not the
default: the port's `LayerNormImpl` (nn/layers/attention.py) stays in
plain PyTorch, as the JAX package's stays in jnp, so no path of either
package runs these kernels.

* K10 — `_ln_fwd` (TPU `_ln_fwd` -> `_fwd_kernel`): y in x's dtype, and
  the per-row mu and rstd in f32.
* K11 — `_ln_bwd` (TPU `_ln_bwd` -> `_bwd_kernel`): dx in x's dtype and
  f32 per-block dgamma/dbeta partials, summed here as the TPU wrapper
  sums its partials outside its kernel.

`fused_layer_norm` is a `torch.autograd.Function` over the two (the JAX
package's custom VJP). The kernels take any N and C; the TPU envelope
(C % 128 == 0, N % 8 == 0) does not bind them.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes its plain PyTorch version (`_ln_fwd_reference`,
`_ln_bwd_reference`), which is what the CPU tests run. On a CUDA tensor
it launches its kernel or raises; nothing falls back. Launches are
counted in `LAUNCHES` ("K10", "K11").

What bounds the kernels on the H100 and what their design does about
it: see the note at the top of csrc/layernorm.cu.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# rows summed into one dgamma/dbeta partial by the backward kernel
PARTIAL_ROWS = 64

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
    "ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    "ln_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def _kernel(name):
    """A C entry point of csrc/layernorm.cu, built on first use."""
    fn = getattr(cuda_build.load("layernorm"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _FN_ARGTYPES[name]
    return fn


def _check(x2d, gamma, *others, stats=()):
    """Raise on what the kernels do not take: CUDA tensors on one device,
    x [N, C] (and dy, beta) of x's float32/bfloat16 dtype, gamma [C],
    f32 statistics [N], all contiguous."""
    tensors = (x2d, gamma) + others + tuple(stats)
    if any(t.device.type != "cuda" or t.device != x2d.device
           for t in tensors):
        raise ValueError("layernorm kernel: every tensor must be on the "
                         "same CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    N, C = x2d.shape
    if x2d.dtype not in _KERNEL_DTYPES or any(
            t.dtype != x2d.dtype for t in (gamma,) + others):
        raise ValueError("layernorm kernel takes float32 or bfloat16 x, "
                         "gamma, beta, dy of one dtype; got "
                         f"{[t.dtype for t in (x2d, gamma) + others]}")
    if gamma.shape != (C,) or any(
            t.shape not in ((C,), (N, C)) for t in others):
        raise ValueError(f"layernorm kernel: shapes x {tuple(x2d.shape)}, "
                         f"{[tuple(t.shape) for t in (gamma,) + others]} "
                         "disagree")
    if any(t.dtype != torch.float32 or t.shape != (N,) for t in stats):
        raise ValueError("layernorm kernel: mu and rstd must be f32 [N]")
    if N < 1 or C < 1 or not all(t.is_contiguous() for t in tensors):
        raise ValueError("layernorm kernel: tensors must be non-empty and "
                         "contiguous")


def _run(name, args, x):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc}) at "
                           f"x {tuple(x.shape)} dtype={x.dtype}")


def _ln_fwd(x2d, gamma, beta, eps):
    """K10. x [N, C], gamma/beta [C] -> (y, mu f32 [N], rstd f32 [N])."""
    if x2d.device.type == "cpu":
        return _ln_fwd_reference(x2d, gamma, beta, eps)
    _check(x2d, gamma, beta)
    N, C = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty(N, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(N, dtype=torch.float32, device=x2d.device)
    _run("ln_fwd", [x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                    _KERNEL_DTYPES[x2d.dtype], N, C, float(eps)], x2d)
    LAUNCHES["K10"] += 1
    return y, mu, rstd


def _ln_bwd(x2d, gamma, mu, rstd, dy):
    """K11. -> (dx in x's dtype, dgamma f32 [C], dbeta f32 [C])."""
    if x2d.device.type == "cpu":
        return _ln_bwd_reference(x2d, gamma, mu, rstd, dy)
    _check(x2d, gamma, dy, stats=(mu, rstd))
    N, C = x2d.shape
    dx = torch.empty_like(x2d)
    parts = -(-N // PARTIAL_ROWS)
    dgp = torch.empty(parts, C, dtype=torch.float32, device=x2d.device)
    dbp = torch.empty(parts, C, dtype=torch.float32, device=x2d.device)
    _run("ln_bwd", [x2d.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    dgp.data_ptr(), dbp.data_ptr(),
                    _KERNEL_DTYPES[x2d.dtype], N, C, PARTIAL_ROWS], x2d)
    LAUNCHES["K11"] += 1
    return dx, dgp.sum(0), dbp.sum(0)


class _FusedLayerNorm(torch.autograd.Function):
    """The custom VJP of the JAX package's `fused_layer_norm`: the
    forward saves (x, gamma, mu, rstd), the backward is K11."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1]).contiguous()
        y, mu, rstd = _ln_fwd(x2d, gamma.contiguous(), beta.contiguous(),
                              eps)
        ctx.save_for_backward(x2d, gamma, mu, rstd)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mu, rstd = ctx.saved_tensors
        shape = dy.shape
        dx, dg, db = _ln_bwd(x2d, gamma.contiguous(), mu, rstd,
                             dy.reshape(-1, shape[-1]).contiguous())
        return (dx.reshape(shape), dg.to(gamma.dtype), db.to(gamma.dtype),
                None)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the LAST axis of x (any leading shape), fused.
    Returns y with x's dtype; statistics and normalization math in f32."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)
