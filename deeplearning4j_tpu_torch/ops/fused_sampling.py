"""Fused sampling — temperature, top-k and top-p in one pass per row:
the port of the JAX package's ops/fused_sampling.py on a hand-written
CUDA kernel (csrc/sampling.cu).

* K12 — `fused_sample` (TPU `_sample_pallas` -> `_sample_kernel`, whose
  body is `_select_body`): per row of logits [B, V], centre and scale by
  the temperature, keep the top k by a 24-step threshold bisection over
  counts, keep the nucleus by a 24-step bisection over probability mass,
  and take the Gumbel-perturbed argmax over the kept set (ties to the
  lowest index). Returns the [B] token ids as int32.

The sample is reparameterised: the caller passes Gumbel noise [B, V]
(`gumbel_noise`, drawn from an explicit `torch.Generator`), so the op is
a deterministic function of (logits, noise) and the kernel draws no
random bits. `temperature <= 0` is greedy: `argmax(logits, -1)` as int32,
and nothing is launched.

The TPU kernel runs only inside its tiling envelope (V % 128 == 0,
B % 8 == 0) and the JAX package computes the same math in jnp outside
it; the CUDA kernel takes any B >= 1 and V >= 1 (`supports`), so on a
CUDA tensor the wrapper launches it at every shape.

Dispatch is by the tensor's device only. On a CPU tensor the wrapper
computes its plain PyTorch version (`_select_reference`, `_select_body`'s
arithmetic step for step), which is what the CPU tests run. On a CUDA
tensor it launches its kernel or raises; nothing falls back. Launches
are counted in `LAUNCHES["K12"]`.

What bounds the kernel on the H100 and what its design does about it:
see the note at the top of csrc/sampling.cu.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.ops import cuda_build

NEG_INF = -1e30
BISECT_STEPS = 24

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches counted where the wrapper launches its kernel, and nowhere else
LAUNCHES = {"K12": 0}


def supports(batch: int, vocab: int) -> bool:
    """Whether the CUDA kernel takes a [batch, vocab] logits block: any
    non-empty one. (The JAX package's `supports` is the TPU's (8, 128)
    tiling envelope, which does not bind this kernel.)"""
    return batch >= 1 and vocab >= 1


def _modes(logits, top_k, top_p):
    """(top_k, top_p) as the kernel and the plain version take them: a
    bisection runs only where the JAX package runs it (`top_k and top_k
    < V`, `top_p and top_p < 1.0`); 0 and 1.0 switch it off."""
    V = logits.shape[-1]
    k = int(top_k or 0)
    p = float(top_p or 1.0)
    return (k if 0 < k < V else 0), (p if 0.0 < p < 1.0 else 1.0)


def _select_reference(logits, noise, temperature=1.0, top_k=0, top_p=1.0):
    """Plain version of K12: `_select_body`'s math, f32 throughout.
    logits [B, V] (f32 or bf16), noise [B, V] -> [B] int32.

    Every division is a true division by a tensor on the logits' device
    (a division by a Python scalar multiplies by its reciprocal on
    CUDA), so on the card the z values, and with them the top-k counts,
    are the kernel's bit for bit."""
    k, p_top = _modes(logits, top_k, top_p)
    lf = logits.float()
    B, V = lf.shape
    dev = lf.device
    m = lf.amax(-1, keepdim=True)
    t = torch.full((1, 1), float(temperature), dtype=torch.float32,
                   device=dev)
    z = torch.div(lf - m, t)                       # max row value: 0
    keep = torch.ones(z.shape, dtype=torch.bool, device=dev)
    if k:
        # largest threshold t with count(z >= t) >= k
        lo = z.amin(-1) - 1.0
        hi = torch.full((B,), 1e-6, dtype=torch.float32, device=dev)
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            cnt = (z >= mid[:, None]).sum(-1)
            ge = cnt >= k
            lo = torch.where(ge, mid, lo)
            hi = torch.where(ge, hi, mid)
        keep &= z >= lo[:, None]
    if p_top < 1.0:
        e = torch.exp(z)
        p = torch.div(e, e.sum(-1, keepdim=True))
        # largest cutoff u with mass({p >= u}) >= top_p
        lo = torch.zeros(B, dtype=torch.float32, device=dev)
        hi = p.amax(-1) + 1e-6
        top = torch.full((B,), p_top, dtype=torch.float32, device=dev)
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            mass = torch.where(p >= mid[:, None], p, 0.0).sum(-1)
            ge = mass >= top
            lo = torch.where(ge, mid, lo)
            hi = torch.where(ge, hi, mid)
        keep &= p >= lo[:, None]
    score = torch.where(keep, z + noise.float(), NEG_INF)
    best = score.amax(-1, keepdim=True)
    # first-match argmax: ties break to the lowest index
    idx = torch.arange(V, device=dev).expand(B, V)
    hit = torch.where(score >= best, idx, V)
    return hit.amin(-1).to(torch.int32)


def _kernel():
    """The C entry point of csrc/sampling.cu, built on first use."""
    fn = cuda_build.load("sampling").fused_sample
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
    return fn


def _check(logits, noise):
    """Raise on what the kernel does not take: CUDA tensors on one
    device, logits [B, V] float32/bfloat16, noise [B, V] float32, both
    contiguous."""
    if noise.device != logits.device:
        raise ValueError("sampling kernel: logits and noise must be on the "
                         f"same CUDA device; got {logits.device}, "
                         f"{noise.device}")
    if logits.dtype not in _KERNEL_DTYPES or noise.dtype != torch.float32:
        raise ValueError("sampling kernel takes float32 or bfloat16 logits "
                         f"and float32 noise; got {logits.dtype}, "
                         f"{noise.dtype}")
    if logits.ndim != 2 or noise.shape != logits.shape \
            or not supports(*logits.shape):
        raise ValueError(f"sampling kernel: logits {tuple(logits.shape)} "
                         f"and noise {tuple(noise.shape)} must be one "
                         "non-empty [B, V] shape")
    if not (logits.is_contiguous() and noise.is_contiguous()):
        raise ValueError("sampling kernel: tensors must be contiguous")


def fused_sample(logits, noise, *, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0):
    """K12. One token id per row of logits [B, V]: the Gumbel argmax over
    the top-k / top-p kept set of the temperature-scaled logits. noise
    [B, V] f32 is the caller's Gumbel noise (`gumbel_noise`). Returns
    [B] int32. `temperature <= 0` ignores the noise and returns
    `argmax(logits, -1)`."""
    if temperature is None or float(temperature) <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    if logits.device.type == "cpu":
        return _select_reference(logits, noise, temperature, top_k, top_p)
    _check(logits, noise)
    k, p = _modes(logits, top_k, top_p)
    B, V = logits.shape
    out = torch.empty(B, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = _kernel()(logits.data_ptr(), noise.data_ptr(), out.data_ptr(),
                       _KERNEL_DTYPES[logits.dtype], B, V,
                       float(temperature), k, p, stream)
    if rc != 0:
        raise RuntimeError(f"sampling kernel launch failed (code {rc}) at "
                           f"B={B} V={V} dtype={logits.dtype}")
    LAUNCHES["K12"] += 1
    return out


def gumbel_noise(generator: torch.Generator, batch: int, vocab: int,
                 device=None):
    """Gumbel noise [batch, vocab] f32 for `fused_sample`, -log(-log(U))
    with U uniform on [tiny, 1) from `generator` (which must live on
    `device`; CUDA unless the caller names another)."""
    u = torch.rand((batch, vocab), generator=generator, dtype=torch.float32,
                   device=resolve_device(device))
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
