"""Skip-gram negative-sampling scores in one pass over the gathered
embedding rows — the port of the JAX package's ops/fused_neg_softmax.py
on a hand-written CUDA kernel (csrc/neg_softmax.cu).

The embedding engine's SGNS step (embedding/engine.py) scores a [B, D]
center strip against its [B, D] positive rows and [B, K, D] negative
block:

    pos_score[b]    = sigmoid(c[b] . pos[b])
    neg_score[b, k] = sigmoid(c[b] . neg[b, k])

* K13 — `neg_softmax_scores` (TPU `_neg_softmax_pallas` ->
  `_neg_softmax_kernel`): both contractions and the sigmoids, summed in
  f32, each result in c's dtype.

The TPU kernel runs only inside a lane-tile envelope (D % 128 == 0,
B % 8 == 0, K <= 128) and the JAX package computes the same math in jnp
outside it. The CUDA kernel takes any B, K and D, so on a CUDA tensor
the wrapper launches it at every shape.

Dispatch is by the tensor's device only. On a CPU tensor the wrapper
computes its plain PyTorch version (`_neg_softmax_reference`), which is
what the CPU tests run. On a CUDA tensor it launches its kernel or
raises; nothing falls back. Launches are counted in `LAUNCHES["K13"]`.

What bounds the kernel on the H100 and what its design does about it:
see the note at the top of csrc/neg_softmax.cu.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import cuda_build, opcount

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches counted where the wrapper launches its kernel, and nowhere else
LAUNCHES = {"K13": 0}


def _neg_softmax_reference(c, pos, neg):
    """Plain version of K13: c/pos [B, D], neg [B, K, D] -> (pos_score
    [B], neg_score [B, K]) in c's dtype, summed and squashed in f32."""
    cf = c.float()
    pos_score = torch.sigmoid(torch.einsum("bd,bd->b", cf, pos.float()))
    neg_score = torch.sigmoid(torch.einsum("bd,bkd->bk", cf, neg.float()))
    return pos_score.to(c.dtype), neg_score.to(c.dtype)


def _kernel():
    """The C entry point of csrc/neg_softmax.cu, built on first use."""
    fn = cuda_build.load("neg_softmax").neg_softmax
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def supports(batch: int, k: int, dim: int) -> bool:
    """Whether K13 (csrc/neg_softmax.cu) takes a (c [batch, dim], pos
    [batch, dim], neg [batch, k, dim]) triple: every size >= 1 and the
    elements of neg in int32. This is the CUDA kernel's envelope, not the
    Pallas one of the JAX `supports` (dim a lane multiple, batch % 8 ==
    0, k within one lane tile): the kernel takes any of them, in float32
    or bfloat16."""
    return min(batch, k, dim) >= 1 and batch * k * dim < 2 ** 31


def _check(c, pos, neg):
    """Raise on what the kernel does not take: CUDA tensors on one
    device, c/pos [B, D] and neg [B, K, D] of one float32/bfloat16
    dtype, B, K, D >= 1, all contiguous."""
    tensors = (c, pos, neg)
    if any(t.device.type != "cuda" or t.device != c.device for t in tensors):
        raise ValueError("neg-softmax kernel: every tensor must be on the "
                         "same CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if c.dtype not in _KERNEL_DTYPES or pos.dtype != c.dtype \
            or neg.dtype != c.dtype:
        raise ValueError("neg-softmax kernel takes float32 or bfloat16 c, "
                         f"pos, neg of one dtype; got {c.dtype}, "
                         f"{pos.dtype}, {neg.dtype}")
    if c.ndim != 2 or pos.shape != c.shape or neg.ndim != 3 \
            or neg.shape[0] != c.shape[0] or neg.shape[2] != c.shape[1] \
            or min(neg.shape) < 1:
        raise ValueError(f"neg-softmax kernel: shapes c {tuple(c.shape)}, "
                         f"pos {tuple(pos.shape)}, neg {tuple(neg.shape)} "
                         "disagree")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("neg-softmax kernel: tensors must be contiguous")


def neg_softmax_scores(c, pos, neg):
    """K13. Sigmoid'd SGNS scores for a batch of (center, positive,
    K-negatives) triples: c/pos [B, D], neg [B, K, D] -> (pos_score
    [B], neg_score [B, K]), in c's dtype. Strided views (rows gathered
    into a wider buffer) are copied to the rows the kernel reads."""
    B, K, D = neg.shape
    with opcount.kernel("K13", 2 * (K + 1) * B * D):
        return _scores_dispatch(c, pos, neg)


def _scores_dispatch(c, pos, neg):
    if c.device.type == "cpu":
        return _neg_softmax_reference(c, pos, neg)
    c, pos, neg = c.contiguous(), pos.contiguous(), neg.contiguous()
    _check(c, pos, neg)
    B, K, D = neg.shape
    pos_score = torch.empty(B, dtype=c.dtype, device=c.device)
    neg_score = torch.empty(B, K, dtype=c.dtype, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = _kernel()(c.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                       pos_score.data_ptr(), neg_score.data_ptr(),
                       _KERNEL_DTYPES[c.dtype], B, K, D, stream)
    if rc != 0:
        raise RuntimeError(f"neg_softmax kernel launch failed (code {rc}) "
                           f"at B={B} K={K} D={D} dtype={c.dtype}")
    LAUNCHES["K13"] += 1
    return pos_score, neg_score
