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

On the card a row is spread over a cluster of blocks (`_plan`); each
bisection walks 4 of its 24 levels a round while more than CAP elements
lie in its [lo, hi), then one warp finishes it from those elements.
`_tree_bisect` is the plain model of a round's walk, `_walk_model` of the
whole, and `_thresholds_reference` gives the thresholds the plain version
walks to, which `_launch(..., thresholds=True)` reads back from the
kernel. The launch path is lean: the checks build text only when they
raise, the typed C entry is cached and the stream handle read raw
(`cuda_build`).

What bounds the kernel on the H100 and what its design does about it:
see the note at the top of csrc/sampling.cu.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.ops import autotune, cuda_build, opcount

NEG_INF = -1e30
BISECT_STEPS = 24
# bisection levels the kernel walks a round (csrc/sampling.cu LEVELS)
LEVELS = 4

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


def _tree_bisect(reaches, lo, hi, steps=BISECT_STEPS, levels=LEVELS):
    """The plain model of K12's bisection walk: `steps` steps of the
    binary walk (mid = 0.5 (lo + hi); reaches(mid) ? lo = mid : hi = mid)
    taken `levels` at a time. Each round forms the 2^levels - 1 mids of
    the next `levels` steps under (lo, hi) in heap order (node n's
    children split [its lo, mid n] and [mid n, its hi]), asks
    `reaches` of all of them at once, and walks the subtree on the
    answers, so lo and hi come out as the binary walk's bit for bit.
    lo, hi: [B] f32; reaches: candidates [B, n] -> bool [B, n]. Returns
    the final (lo, hi). levels = 1 is the binary walk itself."""
    if steps % levels:
        raise ValueError(f"{steps} steps do not split into rounds of "
                         f"{levels}")
    nodes = 2 ** levels - 1
    for _ in range(steps // levels):
        a, b, c = {1: lo}, {1: hi}, {}
        for n in range(1, nodes + 1):
            c[n] = 0.5 * (a[n] + b[n])
            if 2 * n <= nodes:
                a[2 * n], b[2 * n] = a[n], c[n]
                a[2 * n + 1], b[2 * n + 1] = c[n], b[n]
        cand = torch.stack([c[n] for n in range(1, nodes + 1)], -1)
        votes = reaches(cand)
        node = torch.ones_like(lo, dtype=torch.long)
        for _ in range(levels):
            at = (node - 1)[:, None]
            mid = cand.gather(-1, at)[:, 0]
            go = votes.gather(-1, at)[:, 0]
            lo = torch.where(go, mid, lo)
            hi = torch.where(go, hi, mid)
            node = 2 * node + go.long()
    return lo, hi


def _thresholds_reference(logits, temperature=1.0, top_k=0, top_p=1.0,
                          levels=1):
    """The top-k and top-p thresholds (lo after the walk) of each row,
    [B] f32 each, 0 for a filter that is off: z and P as
    `_select_reference` forms them, the walk taken `levels` at a time
    (`_tree_bisect`), each candidate's count and mass summed as
    `_select_reference` sums them at its mid. What K12 writes to its
    `thr` output; levels = LEVELS is the kernel's walk."""
    k, p_top = _modes(logits, top_k, top_p)
    lf = logits.float()
    B, _ = lf.shape
    dev = lf.device
    t = torch.full((1, 1), float(temperature), dtype=torch.float32,
                   device=dev)
    z = torch.div(lf - lf.amax(-1, keepdim=True), t)
    thr_k = torch.zeros(B, dtype=torch.float32, device=dev)
    thr_p = torch.zeros(B, dtype=torch.float32, device=dev)
    if k:
        thr_k, _ = _tree_bisect(
            lambda cand: torch.stack(
                [(z >= cand[:, i, None]).sum(-1) >= k
                 for i in range(cand.shape[1])], -1),
            z.amin(-1) - 1.0,
            torch.full((B,), 1e-6, dtype=torch.float32, device=dev),
            levels=levels)
    if p_top < 1.0:
        e = torch.exp(z)
        p = torch.div(e, e.sum(-1, keepdim=True))
        top = torch.full((B,), p_top, dtype=torch.float32, device=dev)
        thr_p, _ = _tree_bisect(
            lambda cand: torch.stack(
                [torch.where(p >= cand[:, i, None], p, 0.0).sum(-1) >= top
                 for i in range(cand.shape[1])], -1),
            torch.zeros(B, dtype=torch.float32, device=dev),
            p.amax(-1) + 1e-6, levels=levels)
    return thr_k, thr_p


# the kernel finishes a walk in one warp once at most CAP elements lie in
# its [lo, hi) (csrc/sampling.cu CAP)
CAP = 128


def _finish_reference(lo, hi, levels, bound):
    """The last levels of a walk (from `levels` to BISECT_STEPS) whose
    decision is known: mid = 0.5 (lo + hi); lo = mid where mid <= bound,
    else hi = mid. lo, hi, bound: f32 scalars (0-dim tensors); returns
    lo."""
    for _ in range(BISECT_STEPS - levels):
        mid = 0.5 * (lo + hi)
        if mid <= bound:
            lo = mid
        else:
            hi = mid
    return lo


def _walk_model(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The plain model of K12's walks, row by row: rounds of LEVELS
    levels (`_tree_bisect`) while more than CAP elements lie in a walk's
    [lo, hi) (for top-p, as counted when the round began), then the last
    levels at once (`_finish_reference`): top-k's from the (k - #{z >=
    hi})-th largest z in [lo, hi), as count(z >= mid) >= k exactly when
    mid is at most the k-th largest z; top-p's from the P in [lo, hi)
    where the running sum, largest first, from the mass at or above hi,
    first reaches top_p. Returns the [B] top-k and top-p thresholds as
    `_thresholds_reference` does: top-k's equal its bit for bit, top-p's
    wherever no mass lies within an ulp of top_p."""
    k, p_top = _modes(logits, top_k, top_p)
    lf = logits.float()
    B, V = lf.shape
    t = torch.full((1, 1), float(temperature), dtype=torch.float32)
    z = torch.div(lf - lf.amax(-1, keepdim=True), t)
    e = torch.exp(z)
    p = torch.div(e, e.sum(-1, keepdim=True))
    inf = torch.tensor(float("inf"))
    thr = torch.zeros(2, B, dtype=torch.float32)
    for b in range(B):
        for f, on in enumerate((k > 0, p_top < 1.0)):
            if not on:
                continue
            x = (z if f == 0 else p)[b:b + 1]
            if f == 0:
                lo, hi = x.amin(-1) - 1.0, torch.full((1,), 1e-6)

                def reaches(c, x=x):
                    return torch.stack([(x >= c[:, i, None]).sum(-1) >= k
                                        for i in range(c.shape[1])], -1)
            else:
                lo, hi = torch.zeros(1), x.amax(-1) + 1e-6

                def reaches(c, x=x):
                    return torch.stack(
                        [torch.where(x >= c[:, i, None], x, 0.0).sum(-1)
                         >= p_top for i in range(c.shape[1])], -1)
            levels, live = 0, V
            while levels < BISECT_STEPS and live > CAP:
                if f == 1:  # top-p counts its live elements as a round begins
                    live = int(((x >= lo) & (x < hi)).sum())
                lo, hi = _tree_bisect(reaches, lo, hi, steps=LEVELS)
                levels += LEVELS
                if f == 0:
                    live = int(((x >= lo) & (x < hi)).sum())
            if levels == BISECT_STEPS:
                thr[f, b] = lo
                continue
            vals = x[(x >= lo) & (x < hi)].sort(descending=True).values
            if f == 0:
                at = min(max(k - int((x >= hi).sum()), 1), vals.numel())
                bound = vals[at - 1]
            else:
                running = torch.where(x >= hi, x, 0.0).sum()
                bound = inf if running >= p_top else -inf
                for v in vals:
                    running = running + v
                    if bound == -inf and running >= p_top:
                        bound = v
            thr[f, b] = _finish_reference(lo[0], hi[0], levels, bound)
    return thr[0], thr[1]


# ------------------------------------------------------------ the launch

_FN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# the plan of a launch (csrc/sampling.cu): a cluster of blocks per row,
# enough that each of a block's THREADS threads holds about
# ELEMS_PER_THREAD elements of the row, at most MAX_CLUSTER (the portable
# cluster size); blocks of WIDE_THREADS threads instead when the row takes
# the most blocks and every block of the launch finds an SM of its own
# (SMS, an H100's), which measured faster there (chip_smoke.py phase 13's
# plan lines)
THREADS = 128
WIDE_THREADS = 256
ELEMS_PER_THREAD = 8
MAX_CLUSTER = 8
SMS = 132
PLAN_THREADS = (THREADS, WIDE_THREADS)  # the kernel's instantiations


def _plan(batch: int, vocab: int):
    """(threads a block, blocks in a row's cluster) for [batch, vocab]
    logits: the tuning table's plan for (batch, vocab) where it has one
    (ops/autotune.py `sample_plan`), else the heuristic: 8 blocks of 256
    threads at [4, 10000], of 128 at [32, 10000]; one block of 128 up to
    V = 1024."""
    cluster = min(MAX_CLUSTER,
                  max(1, -(-vocab // (THREADS * ELEMS_PER_THREAD))))
    wide = cluster == MAX_CLUSTER and batch * cluster <= SMS
    return autotune.sample_plan(batch, vocab,
                                ((WIDE_THREADS if wide else THREADS),
                                 cluster), PLAN_THREADS, MAX_CLUSTER)


def _check(logits, noise):
    """Raise on what the kernel does not take: CUDA tensors on one
    device, logits [B, V] float32/bfloat16, noise [B, V] float32, both
    contiguous. Builds its text only when it raises."""
    if (noise.get_device() == logits.get_device() >= 0
            and logits.dtype in _KERNEL_DTYPES
            and noise.dtype == torch.float32 and logits.dim() == 2
            and noise.shape == logits.shape and supports(*logits.shape)
            and logits.is_contiguous() and noise.is_contiguous()):
        return
    if noise.device != logits.device or logits.device.type != "cuda":
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
    raise ValueError("sampling kernel: tensors must be contiguous")


def _launch(logits, noise, temperature, top_k, top_p, plan=None,
            thresholds=False):
    """Launch K12 on CUDA logits [B, V] and noise [B, V] with the filters
    as `_modes` gives them; `plan` (threads, cluster) defaults to
    `_plan(B, V)`. Returns the [B] int32 ids, and with `thresholds` also
    the [B, 2] f32 top-k and top-p thresholds the kernel walked to."""
    _check(logits, noise)
    B, V = logits.shape
    threads, cluster = _plan(B, V) if plan is None else plan
    out = torch.empty(B, dtype=torch.int32, device=logits.device)
    thr = (torch.empty((B, 2), dtype=torch.float32, device=logits.device)
           if thresholds else None)
    fn = cuda_build.entry("sampling", "fused_sample", _FN_ARGTYPES)
    args = (logits.data_ptr(), noise.data_ptr(), out.data_ptr(),
            None if thr is None else thr.data_ptr(),
            _KERNEL_DTYPES[logits.dtype], B, V, float(temperature), top_k,
            top_p, threads, cluster)
    dev = logits.get_device()
    if dev == torch.cuda.current_device():
        rc = fn(*args, cuda_build.stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, cuda_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"sampling kernel launch failed (code {rc}) at "
                           f"B={B} V={V} dtype={logits.dtype} plan "
                           f"{(threads, cluster)}")
    LAUNCHES["K12"] += 1
    return out if thr is None else (out, thr)


def fused_sample(logits, noise, *, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0):
    """K12. One token id per row of logits [B, V]: the Gumbel argmax over
    the top-k / top-p kept set of the temperature-scaled logits. noise
    [B, V] f32 is the caller's Gumbel noise (`gumbel_noise`). Either may
    be a strided view. Returns [B] int32. `temperature <= 0` ignores the
    noise and returns `argmax(logits, -1)`."""
    if temperature is None or float(temperature) <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    B, V = logits.shape
    with opcount.kernel("K12", opcount.sample_ops(
            B, V, *_modes(logits, top_k, top_p))):
        return _sample_dispatch(logits, noise, temperature, top_k, top_p)


def _sample_dispatch(logits, noise, temperature, top_k, top_p):
    if logits.device.type == "cpu":
        return _select_reference(logits, noise, temperature, top_k, top_p)
    # a strided view (the last position of a [B, T, V] output) is copied
    # to the rows the kernel reads
    logits, noise = logits.contiguous(), noise.contiguous()
    k, p = _modes(logits, top_k, top_p)
    return _launch(logits, noise, temperature, k, p)


def gumbel_noise(generator: torch.Generator, batch: int, vocab: int,
                 device=None):
    """Gumbel noise [batch, vocab] f32 for `fused_sample`, -log(-log(U))
    with U uniform on [tiny, 1) from `generator` (which must live on
    `device`; CUDA unless the caller names another)."""
    u = torch.rand((batch, vocab), generator=generator, dtype=torch.float32,
                   device=resolve_device(device))
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
