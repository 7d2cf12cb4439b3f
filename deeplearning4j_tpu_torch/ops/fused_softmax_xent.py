"""Fused softmax cross-entropy head for large vocabularies — the port of
the JAX package's ops/fused_softmax_xent.py on hand-written CUDA kernels
(csrc/softmax_xent.cu).

    loss[n] = logsumexp_v(x[n] @ W + b) - (x[n] @ W + b)[labels[n]]

computed without writing the [N, V] logits to device memory:

* K8 — `_fused_fwd` (TPU `_fused_fwd` -> `_fwd_kernel`): per-token loss
  and lse, online over vocab chunks (`_xent_fwd`).
* K9 — `_fused_bwd` (TPU `_fused_bwd` -> `_dx_kernel`, `_dwdb_kernel`):
  dx, dW and db recomputed chunk by chunk from (x, W, b, lse), two
  kernels as on the TPU (`_xent_dx`, `_xent_dwdb`).

`softmax_xent_head` is a `torch.autograd.Function` over the two. The
kernels take any N and V and mask the ragged tails themselves; the TPU
wrapper's padded copy of W (to a whole number of vocab chunks) has no
counterpart here.

Dispatch is by the tensor's device only. On a CPU tensor each wrapper
computes its plain PyTorch version (`_xent_fwd_reference`,
`_xent_bwd_reference`: f32 softmax math, G rounded to the operand
dtype for the products as the JAX kernels round it), which is what the
CPU tests run. On a CUDA tensor it launches its kernel or raises;
nothing falls back. The wrappers count their launches in `LAUNCHES` ("K8" the
forward, "K9" the dx kernel, "K9 dW" the dW/db kernel; in bf16 the
latter splits N into slices whose f32 partials, in a workspace allocated
here, a second small kernel sums in a fixed order).

What bounds the kernels on the H100 and what their design does about
it: see the note at the top of csrc/softmax_xent.cu.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import cuda_build, refuse_double_backward

NEG_INF = -1e30

# Use the fused head only where the dense path's [N, V] logits hurt;
# same envelope as the JAX package.
MIN_FUSED_VOCAB = 2048
MAX_FUSED_D = 1024

# Dispatch override: None = auto (CUDA tensors only), True = always
# (plain versions on the CPU — used by the tests), False = never.
FORCE_FUSED = None

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_D_MULTIPLE = 32

# launches counted where a wrapper launches its kernel, and nowhere else
LAUNCHES = {"K8": 0, "K9": 0, "K9 dW": 0}


def supports(n: int, d: int, v: int) -> bool:
    """Whether the fused head handles this shape (else: dense path).
    Ragged row counts are fine, so `n` does not gate the dispatch."""
    del n
    return v >= MIN_FUSED_VOCAB and d % 128 == 0 and d <= MAX_FUSED_D


# ------------------------------------------------------ plain versions

def _logits_f32(x, w, b):
    return x.float() @ w.float() + b.float()


def _xent_fwd_reference(x, w, b, labels):
    """Plain version of K8: x [N, d], w [d, V], b [V], labels [N] ->
    (loss [N], lse [N]), both f32."""
    z = _logits_f32(x, w, b)
    lse = torch.logsumexp(z, dim=-1)
    return lse - z.gather(-1, labels.long()[:, None])[:, 0], lse


def _xent_bwd_reference(x, w, b, labels, lse, g):
    """Plain version of K9: G = (softmax(x @ W + b) - onehot) * g in f32,
    rounded to the operand dtype for the two products as the JAX kernels
    round it (`g.astype(w.dtype)` in `_dx_kernel`, `g.astype(x.dtype)` in
    `_dwdb_kernel`; the identity in f32); then dx = G @ W^T (x's dtype),
    dW = x^T @ G (W's dtype) and db = column sums of the f32 G."""
    z = _logits_f32(x, w, b)
    G = torch.exp(z - lse[:, None])
    G[torch.arange(G.shape[0], device=G.device), labels.long()] -= 1.0
    G = G * g.float()[:, None]
    Gr = G.to(x.dtype).float()
    dx = (Gr @ w.float().t()).to(x.dtype)
    dw = (x.float().t() @ Gr).to(w.dtype)
    return dx, dw, G.sum(0)


# --------------------------------------------------------- the launches

_FN_ARGTYPES = {
    "xent_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "xent_bwd_dx": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "xent_bwd_dwdb": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "xent_dw_slices": [ctypes.c_int] * 3,
}

# the bf16 kernels (K8 and both of K9) copy x and W into shared memory
# 16 bytes at a time (narrower copies of W where V % 8 != 0, in the same
# kernel)
_ALIGN = 16


def _kernel(name):
    """A C entry point of csrc/softmax_xent.cu, built on first use."""
    fn = getattr(cuda_build.load("softmax_xent"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _FN_ARGTYPES[name]
    return fn


def _check(x, w, b, labels, *rows):
    """Raise on what the kernels do not take: CUDA tensors on one device,
    x [N, d], w [d, V], b [V] of one float32/bfloat16 dtype, int32
    labels and f32 row vectors [N], all contiguous."""
    N, d = x.shape
    tensors = (x, w, b, labels) + rows
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("softmax-xent kernel: every tensor must be on the "
                         "same CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise ValueError(f"softmax-xent kernel takes float32 or bfloat16 x, "
                         f"W, b of one dtype; got {x.dtype}, {w.dtype}, "
                         f"{b.dtype}")
    if w.ndim != 2 or w.shape[0] != d or b.shape != (w.shape[1],):
        raise ValueError(f"softmax-xent kernel: shapes x {tuple(x.shape)}, "
                         f"W {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    if d % _KERNEL_D_MULTIPLE:
        raise ValueError(f"softmax-xent kernel needs d % "
                         f"{_KERNEL_D_MULTIPLE} == 0; got d={d}")
    if labels.dtype != torch.int32 or labels.shape != (N,):
        raise ValueError("softmax-xent kernel: labels must be int32 [N]")
    if any(r.dtype != torch.float32 or r.shape != (N,) for r in rows):
        raise ValueError("softmax-xent kernel: lse and g must be f32 [N]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("softmax-xent kernel: tensors must be contiguous")


def _check_alignment(pointers):
    """Raise on a base pointer that the bf16 kernels cannot copy 16 bytes
    at a time. pointers: {name: data_ptr}."""
    for name, ptr in pointers.items():
        if ptr % _ALIGN:
            raise ValueError(f"softmax-xent kernel: the base pointer of "
                             f"{name} ({ptr:#x}) is not {_ALIGN}-byte "
                             "aligned")


def _run(name, args, x):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc}) at "
                           f"x {tuple(x.shape)} dtype={x.dtype}")


def _fused_fwd(x, w, b, labels):
    """K8. x [N, d], w [d, V], b [V], labels int32 [N] -> (loss [N],
    lse [N]) f32."""
    if x.device.type == "cpu":
        return _xent_fwd_reference(x, w, b, labels)
    return _xent_fwd(x, w, b, labels)


def _xent_fwd(x, w, b, labels):
    """K8's kernel: (loss [N], lse [N]) f32."""
    _check(x, w, b, labels)
    if x.dtype == torch.bfloat16:
        _check_alignment({"x": x.data_ptr(), "W": w.data_ptr()})
    N, d = x.shape
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    _run("xent_fwd", [x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                      _KERNEL_DTYPES[x.dtype], N, d, w.shape[1]], x)
    LAUNCHES["K8"] += 1
    return loss, lse


def _xent_dx(x, w, b, labels, lse, g):
    """K9, first kernel: dx [N, d] in x's dtype."""
    _check(x, w, b, labels, lse, g)
    if x.dtype == torch.bfloat16:
        _check_alignment({"x": x.data_ptr(), "W": w.data_ptr()})
    N, d = x.shape
    dx = torch.empty_like(x)
    _run("xent_bwd_dx", [x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                         dx.data_ptr(), _KERNEL_DTYPES[x.dtype], N, d,
                         w.shape[1]], x)
    LAUNCHES["K9"] += 1
    return dx


def _dw_workspace(x, V):
    """The bf16 dW/db kernel's f32 workspace: one [d + 1, Vw] partial
    (dW, then db) per slice of the N reduction, which its reduce kernel
    sums in a fixed order. Returns (workspace, slices); (None, 0) for
    f32, whose kernel needs none."""
    if x.dtype != torch.bfloat16:
        return None, 0
    N, d = x.shape
    with torch.cuda.device(x.device):
        slices = _kernel("xent_dw_slices")(N, d, V)
    if slices < 1:
        raise RuntimeError(f"xent_dw_slices refused N={N} d={d} V={V}")
    vw = -(-V // 64) * 64
    return (torch.empty(slices * (d + 1) * vw, dtype=torch.float32,
                        device=x.device), slices)


def _xent_dwdb(x, w, b, labels, lse, g):
    """K9, second kernel: (dW [d, V] in W's dtype, db [V] f32)."""
    _check(x, w, b, labels, lse, g)
    if x.dtype == torch.bfloat16:
        _check_alignment({"x": x.data_ptr(), "W": w.data_ptr()})
    N, d = x.shape
    dw = torch.empty_like(w)
    db = torch.empty(w.shape[1], dtype=torch.float32, device=x.device)
    work, slices = _dw_workspace(x, w.shape[1])
    _run("xent_bwd_dwdb", [x.data_ptr(), w.data_ptr(), b.data_ptr(),
                           labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                           dw.data_ptr(), db.data_ptr(),
                           None if work is None else work.data_ptr(),
                           slices, _KERNEL_DTYPES[x.dtype], N, d,
                           w.shape[1]], x)
    LAUNCHES["K9 dW"] += 1
    return dw, db


def _fused_bwd(x, w, b, labels, lse, g):
    """K9. g: the loss cotangent [N] f32. Returns (dx, dW, db f32)."""
    if x.device.type == "cpu":
        return _xent_bwd_reference(x, w, b, labels, lse, g)
    dx = _xent_dx(x, w, b, labels, lse, g)
    dw, db = _xent_dwdb(x, w, b, labels, lse, g)
    return dx, dw, db


class _FusedHead(torch.autograd.Function):
    """The custom VJP of the JAX package's `_fused_head`: the forward
    saves lse, the backward recomputes the logits chunk by chunk."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        loss, lse = _fused_fwd(x, w, b, labels)
        ctx.save_for_backward(x, w, b, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        refuse_double_backward("_FusedHead")
        x, w, b, labels, lse = ctx.saved_tensors
        dx, dw, db = _fused_bwd(x, w, b, labels, lse,
                                dloss.float().contiguous())
        return dx, dw, db.to(b.dtype), None


def softmax_xent_head(x, w, b, labels):
    """Per-token softmax cross-entropy of a dense head, fused.

    x: [..., d] features; w: [d, V]; b: [V]; labels: int [...] in
    [0, V). Returns the per-token loss [...] (f32). Labels must be in
    range — mask ignored positions with the loss mask, not an ignore
    index."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    lf = labels.reshape(-1).to(torch.int32).contiguous()
    loss = _FusedHead.apply(xf, w.contiguous(), b.contiguous(), lf)
    return loss.reshape(lead)
