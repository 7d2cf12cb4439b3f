#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch/) on one
NVIDIA GPU (written for the H100): serving and training the flagship
Transformer LM, and training Word2Vec through the embedding engine,
through the port's hand-written kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. Environment: CUDA and nvcc versions, the card, its power limit; TF32
   off for matrix products and convolutions. Builds every kernel source
   in deeplearning4j_tpu_torch/csrc/ with nvcc (one process per source,
   started together).
2. Forward kernels vs plain version: the flash-forward kernel as K1
   (flat, masked), K2 (packed qkv) and K3 (packed, head_dim 64) at the
   shapes serving, the full forward and training give it (K1 at
   BH=2 T<=1024, BH=96 T=512 D=64 and BH=8 T=4096; K2/K3 at B=8 and
   B=32), in float32 and bfloat16, against `_flash_fwd_reference` on
   the same inputs; the kernel, the plain version and
   `scaled_dot_product_attention` (the library yardstick, which the
   port never calls) are timed with CUDA events.
2b. Training kernels vs plain version, f32 and bf16: the flash backward
   (K6 packed B=32 T=512 H=2 D=128, K7 packed H=4 D=64, K4 flat T=512
   at BH=96 D=64 and BH=8 D=128, K5 flat BH=8 at T=2048 and T=4096,
   the flat cases masked with one all-masked row) against
   `_flash_bwd_reference`, timed against the backward of
   `scaled_dot_product_attention`; the softmax-xent head (K8 forward,
   K9 backward) at N=16384 d=256 V=10000 and a ragged N=300 V=2100
   against `_xent_fwd_reference` / `_xent_bwd_reference`, timed against
   `F.cross_entropy(x @ W + b)` forward and backward.
3. Serving: `transformer_lm` at the repo's flagship width (vocab 10000,
   d_model 256, 2 heads of 128, 6 layers, d_ff 1024, bf16) answers 8
   requests through `GenerationEngine`; every request must complete with
   in-vocabulary tokens and K1 must have launched during prefill.
4. Oracle: the same params in float32; greedy tokens from the engine
   must equal the argmax of `ComputationGraph.output` over the prompt
   plus the tokens so far (prompts of 505 and 1017 tokens, so the last
   full forwards run K2 at T = 512 and K1 at T = 1024).
5. Step times (one 1024-token prefill chunk, one 4-slot decode step)
   and a profile of the serving loop (torch.profiler), when the
   profiler reports device time.
6. Flagship training (bench.py mode "transformer": the same model,
   T=512, batch 32, bf16, random tokens from numpy seed 0, labels
   shifted by one): `fit_scanned` for 20 steps; the loss is finite at
   every step and falls; launches exactly K2 = K6 = 6 x 20 and K8 =
   K9 = 20; step time, tokens/s, MFU, peak memory and a profile of one
   step.
7. The other training routes at 2 layers and 2 steps: "transformer_d64"
   (K3/K7), the flat route at T=512 with 3 heads of 64 (K1/K4) and
   "longcontext" T=4096 batch 4 with the padding mask (K1/K5).
8. f32 gradient oracle: one step's gradients of a 2-layer flagship-width
   LM through the kernels and through the plain versions (called
   directly) agree.
9. Word2Vec and LayerNorm kernels vs plain version, f32 and bf16: K13
   (csrc/neg_softmax.cu) at B=2048 K=5 D=128 (the Word2Vec path),
   B=1024 K=5 D=64 (the engine feed) and a ragged B=1000 K=7 D=100
   against `_neg_softmax_reference`, timed against sigmoid(bmm); K10/K11
   (csrc/layernorm.cu) through the `fused_layer_norm` autograd Function
   at N=16384 C=256 and a ragged N=1000 C=200 against
   `_ln_fwd_reference` / `_ln_bwd_reference`, timed against
   F.layer_norm forward and backward.
10. Word2Vec at the repo's config (bench.py `_quality_w2v`: layer 128,
   window 5, negative 5, one epoch, seed 1, batch 2048) on the first
   8000 sentences of bench.py's topic corpus (vocab 10000, 1,000,000
   words, sentences of 25, numpy seed 0): vocab 9878, 531 steps and
   exactly 531 K13 launches, first loss 6 ln 2, last loss within 5% of
   2.1863, topic separation >= 0.50; words/s, steps/s, the host's
   share in pair generation and a profiled window's device idle share.
11. The embedding engine driven directly (bench.py's embed training at
   ep=1: 131072 x 64 tables, batch 1024, window 5, sequences of 25,
   through the prefetched pair feed): 1 + 20 steps, exactly 21 K13
   launches, finite losses; pairs/s and table bytes.
12. f32 oracle: 50 engine steps through K13 and 50 through the plain
   version, from the same tables and batches, agree within 1e-4 of the
   largest table entry.

The last lines are a `{"kernels": [...]}` JSON line (K1-K11, K13), the
card's name and power limit as nvidia-smi gives them, and `{"ok": true,
"device": ...}`. With no CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# the flagship LM (bench.py LM_MODE_DIMS["transformer"], VOCAB_LM)
LM = dict(vocab_size=10000, d_model=256, n_heads=2, n_layers=6, d_ff=1024,
          max_length=1024)

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel vs plain version. f32: both compute the same f32 softmax and
# differ only in summation order -> 1e-4. bf16: o is rounded to bf16 at
# the end by both, and one f32 difference can flip a rounding, which is
# one bf16 ulp (1.6e-2 for |o| in [2, 4)) -> 2e-2; lse stays f32 in
# both -> 1e-2.
TOL = {"float32": {"o": 1e-4, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-2}}


def log(*parts):
    print(*parts, flush=True)


class PhaseFailed(SystemExit):
    def __init__(self, phase, msg):
        super().__init__(f"chip_smoke: phase {phase} FAILED: {msg}")


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def time_ms(torch, fn, windows=5, per_window=20):
    """Median over `windows` of the mean CUDA-event time of
    `per_window` back-to-back calls, after a warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_window)
    return statistics.median(samples)


def flash_bound_ms(BH, T, D, elem_bytes, causal, masked, peak_flops):
    """Least time for the function: q, k, v read and o written once (lse
    written, the key mask read) over the memory rate, against the
    operations the kernel executes over the peak rate: QK^T and PV on
    every 64 x 64 tile up to the causal bound."""
    tiles = T // 64
    pairs = tiles * (tiles + 1) // 2 if causal else tiles * tiles
    flops = BH * pairs * 64 * 64 * D * 4
    nbytes = BH * T * D * elem_bytes * 4 + BH * T * 4 * (2 if masked else 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phase 2

def check_kernels(torch, fa):
    """Each case in both dtypes: the kernel against the plain version on
    the same inputs, then (bf16, the serving dtype) the timings.
    Returns per-kernel lists of records for the kernels line."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def ragged_mask(rows, T):
        m = torch.zeros(rows, T)
        for r in range(rows - 1):  # the last row stays all zero
            m[r, :int(torch.randint(T // 4, T, (1,), generator=gen))] = 1
        return m.to(dev)

    records = {"K1": [], "K2": [], "K3": []}
    cases = []
    for T in (512, 1024):  # chunked prefill: masked, causal, BH = 1 * 2
        cases.append(("K1", f"flat masked causal BH=2 T={T} D=128",
                      dict(BH=2, T=T, D=128, masked=True)))
    cases.append(("K1", "flat unmasked causal BH=2 T=1024 D=128",
                  dict(BH=2, T=1024, D=128, masked=False)))
    # training: the flat route at T = 512 (batch 32, 3 heads of 64; the
    # masked case adds the all-masked row) and long context (batch 4 x 2
    # heads, T = 4096, padding mask)
    for masked in (False, True):
        cases.append(("K1", f"flat {'masked' if masked else 'unmasked'} "
                            "causal BH=96 T=512 D=64",
                      dict(BH=96, T=512, D=64, masked=masked)))
    cases.append(("K1", "flat masked causal BH=8 T=4096 D=128",
                  dict(BH=8, T=4096, D=128, masked=True)))
    # packed: B = 8, and the training batch B = 32
    for B in (8, 32):
        cases.append(("K2", f"packed B={B} T=512 H=2 D=128",
                      dict(B=B, T=512, H=2, D=128)))
        cases.append(("K3", f"packed B={B} T=512 H=4 D=64",
                      dict(B=B, T=512, H=4, D=64)))

    for kern, label, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            D, T = c["D"], c["T"]
            scale = D ** -0.5
            if kern == "K1":
                BH = c["BH"]
                q, k, v = (rand(BH, T, D).to(dtype) for _ in range(3))
                km = ragged_mask(BH, T) if c["masked"] else None
                km3 = None if km is None else km[:, None, :]
                o, lse = fa.flash_attention_lse_masked(q, k, v, km3, scale,
                                                       True)
                ro, rlse = fa._flash_fwd_reference(q, k, v, km, scale, True)
                run = lambda: fa.flash_attention_lse_masked(  # noqa: E731
                    q, k, v, km3, scale, True)
                plain = lambda: fa._flash_fwd_reference(  # noqa: E731
                    q, k, v, km, scale, True)
                if km is None:
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q, k, v, is_causal=True)
                else:
                    allowed = torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()[None] \
                        & (km[:, None, :] > 0)
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q, k, v, attn_mask=allowed)
                bh, masked = BH, km is not None
            else:
                B, H = c["B"], c["H"]
                n = H * D
                qkv = rand(B, T, 3 * n).to(dtype)
                o, lse = fa._flash_fwd_qkv(qkv, H, None, scale, True)
                ro, rlse = fa._flash_fwd_qkv_reference(qkv, H, None, scale,
                                                       True)
                run = lambda: fa.flash_attention_qkv(qkv, H)  # noqa: E731
                plain = lambda: fa._flash_fwd_qkv_reference(  # noqa: E731
                    qkv, H, None, scale, True)
                qh, kh, vh = (t.unflatten(-1, (H, D)).transpose(1, 2)
                              for t in qkv.split(n, dim=-1))
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, is_causal=True)
                bh, masked = B * H, False
            torch.cuda.synchronize()
            err_o = float((o.float() - ro.float()).abs().max())
            err_l = float((lse - rlse).abs().max())
            tol = TOL[dname]
            ok = (err_o <= tol["o"] and err_l <= tol["lse"]
                  and bool(torch.isfinite(o.float()).all()))
            if km is not None and kern == "K1":
                # the all-zero mask row: o = 0, lse at the -1e20 floor
                ok = ok and bool((o[-1] == 0).all()) \
                    and float(lse[-1].max()) < -1e19
            log(f"check {kern} {label} {dname}: max|o-plain|={err_o:.3e} "
                f"max|lse-plain|={err_l:.3e} tol o<={tol['o']} "
                f"lse<={tol['lse']} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(2, f"{kern} {label} {dname} disagrees "
                                     "with its plain version")
            if dtype is not torch.bfloat16:
                continue
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain)
            lib_ms = time_ms(torch, lib)
            bound_ms, bound_by = flash_bound_ms(bh, T, D, 2, True, masked,
                                                PEAK_BF16_FLOPS)
            log(f"time  {kern} {label} bf16: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
            records[kern].append(dict(label=label, err=err_o, ms=ms,
                                      plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=bound_ms, bound_by=bound_by))
    return records


# ------------------------------------------------------------ phase 2b

# kernel vs plain version for the training kernels, relative to the
# largest |plain| entry. f32: the same f32 math summed in another order
# -> 1e-4. bf16: both read the same bf16 inputs and compute in f32; the
# gradients are rounded to bf16 once at the end, which is up to one bf16
# ulp (2^-8 = 3.9e-3 of the value) -> 2e-2.
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def errs(x, ref):
    """(max |x - ref|, that over max |ref|)."""
    ref = ref.float()
    err = float((x.float() - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def grad_ms(torch, out, inputs, cot):
    """CUDA-event time of one backward through an autograd graph kept
    alive (retain_graph), for a library yardstick."""
    return time_ms(torch, lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True))


def flash_bwd_bound_ms(BH, T, D, elem_bytes, masked, B):
    """Least time for the backward function: q, k, v, o, do read and dq,
    dk, dv written once (lse read; the key mask read) over the memory
    rate, against its five causal T x T x D products (s, dp, dv, dk, dq
    on every 64 x 64 tile up to the diagonal) over the bf16 peak."""
    tiles = T // 64
    pairs = tiles * (tiles + 1) // 2
    flops = BH * pairs * 64 * 64 * D * 2 * 5
    nbytes = BH * T * D * elem_bytes * 8 + BH * T * 4 + (B * T * 4
                                                          if masked else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash_backward(torch, fa):
    """The backward kernel (csrc/flash_bwd.cu) through its K4-K7
    wrappers against `_flash_bwd_reference` on the same inputs, f32 and
    bf16; o and lse come from the plain forward. bf16 cases are timed
    against the backward of scaled_dot_product_attention."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 10)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # the flagship (K6) and D = 64 (K7) training batches; the flat route
    # at T = 512 (batch 32 x 3 heads of 64, K4) and long context (batch 4
    # x 2 heads, T = 4096, K5), masked with one all-masked row; K4 at
    # D = 128 and K5 at T = 2048 besides
    cases = [("K6", "packed B=32 T=512 H=2 D=128", dict(B=32, T=512, H=2,
                                                         D=128)),
             ("K7", "packed B=32 T=512 H=4 D=64", dict(B=32, T=512, H=4,
                                                        D=64)),
             ("K4", "flat masked BH=96 T=512 D=64", dict(BH=96, T=512,
                                                          D=64)),
             ("K4", "flat masked BH=8 T=512 D=128", dict(BH=8, T=512,
                                                          D=128)),
             ("K5", "flat masked BH=8 T=2048 D=128", dict(BH=8, T=2048,
                                                           D=128)),
             ("K5", "flat masked BH=8 T=4096 D=128", dict(BH=8, T=4096,
                                                           D=128))]
    records, worst = {}, {}
    for kern, label, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            T, D = c["T"], c["D"]
            scale = D ** -0.5
            if "B" in c:
                B, H = c["B"], c["H"]
                n = H * D
                qkv = rand(B, T, 3 * n).to(dtype)
                do = rand(B, T, n).to(dtype)
                o, lse = fa._flash_fwd_qkv_reference(qkv, H, None, scale,
                                                     True)
                grads = [fa._flash_bwd_qkv(qkv, o, lse, do, H, None, scale,
                                           True)]
                refs = [fa._flash_bwd_qkv_reference(qkv, o, lse, do, H,
                                                    None, scale, True)]
                run = lambda: fa._flash_bwd_qkv(  # noqa: E731
                    qkv, o, lse, do, H, None, scale, True)
                plain = lambda: fa._flash_bwd_qkv_reference(  # noqa: E731
                    qkv, o, lse, do, H, None, scale, True)
                lib_q, lib_k, lib_v = (
                    t.unflatten(-1, (H, D)).transpose(1, 2).contiguous()
                    .requires_grad_() for t in qkv.split(n, dim=-1))
                lib_out = F.scaled_dot_product_attention(
                    lib_q, lib_k, lib_v, is_causal=True)
                lib_do = do.unflatten(-1, (H, D)).transpose(1, 2)
                bh, masked, nb = B * H, False, B
            else:
                BH = c["BH"]
                q, k, v, do = (rand(BH, T, D).to(dtype) for _ in range(4))
                km = torch.zeros(BH, T, device=dev)
                for r in range(BH - 1):  # the last row stays all masked
                    km[r, :int(torch.randint(T // 4, T, (1,),
                                             generator=gen))] = 1
                km3 = km[:, None, :]
                o, lse = fa._flash_fwd_reference(q, k, v, km, scale, True)
                grads = list(fa._flash_bwd_impl(q, k, v, o, lse, do, km3,
                                                scale, True))
                refs = list(fa._flash_bwd_reference(q, k, v, o, lse, do, km,
                                                    scale, True))
                run = lambda: fa._flash_bwd_impl(  # noqa: E731
                    q, k, v, o, lse, do, km3, scale, True)
                plain = lambda: fa._flash_bwd_reference(  # noqa: E731
                    q, k, v, o, lse, do, km, scale, True)
                lib_q, lib_k, lib_v = (t[None].clone().requires_grad_()
                                       for t in (q, k, v))
                allowed = (torch.ones(T, T, dtype=torch.bool, device=dev)
                           .tril()[None] & (km[:, None, :] > 0))
                lib_out = F.scaled_dot_product_attention(
                    lib_q, lib_k, lib_v, attn_mask=allowed[None])
                lib_do = do[None]
                bh, masked, nb = BH, True, BH
            torch.cuda.synchronize()
            err_abs, err = (max(e) for e in zip(
                *(errs(g, r) for g, r in zip(grads, refs))))
            worst[kern] = max(worst.get(kern, 0.0), err_abs)
            ok = err <= REL_TOL[dname] and all(
                bool(torch.isfinite(g.float()).all()) for g in grads)
            if masked:  # the all-masked row gets zero gradients
                ok = ok and all(bool((g[-1] == 0).all()) for g in grads)
            log(f"check {kern} flash bwd {label} {dname}: max rel err "
                f"{err:.3e} (tol {REL_TOL[dname]}) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed("2b", f"{kern} {label} {dname} disagrees "
                                        "with its plain version")
            if dtype is not torch.bfloat16:
                continue
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain)
            lib_ms = grad_ms(torch, lib_out, (lib_q, lib_k, lib_v), lib_do)
            bound_ms, bound_by = flash_bwd_bound_ms(bh, T, D, 2, masked, nb)
            log(f"time  {kern} flash bwd {label} bf16: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
            records.setdefault(kern, []).append(dict(
                label=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by))
    for kern, recs in records.items():
        for rec in recs:
            rec["err"] = worst[kern]
    return records


def xent_bound_ms(N, d, V, elem_bytes, backward):
    """Least time for the head's function. Forward: x, W, b, labels read
    and loss, lse written once, against 2*N*d*V FLOPs (the logits).
    Backward: x, W, b, labels, lse, g read and dx, dW, db written once,
    against 6*N*d*V FLOPs (the logits once, then G @ W^T and x^T @ G)."""
    nbytes = (N * d + d * V + V) * elem_bytes + N * 4
    if backward:
        nbytes += N * 8 + (N * d + d * V) * elem_bytes + V * 4
        flops = 6 * N * d * V
    else:
        nbytes += N * 8
        flops = 2 * N * d * V
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_xent(torch, fsx):
    """K8 and K9 (csrc/softmax_xent.cu) against `_xent_fwd_reference`
    and `_xent_bwd_reference` at the flagship head (N = 32 x 512 tokens,
    d = 256, V = 10000) and at a ragged N = 300, V = 2100, in f32 and
    bf16. The flagship bf16 case is timed against F.cross_entropy on
    x @ W + b (forward, and its backward through autograd)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 20)
    records, worst = {}, {"K8": 0.0, "K9": 0.0}
    for label, (N, d, V) in (("flagship N=16384 d=256 V=10000",
                              (16384, 256, 10000)),
                             ("ragged N=300 d=256 V=2100", (300, 256, 2100))):
        x32 = torch.randn(N, d, generator=gen).to(dev)
        w32 = (0.05 * torch.randn(d, V, generator=gen)).to(dev)
        b32 = (0.01 * torch.randn(V, generator=gen)).to(dev)
        labels = torch.randint(0, V, (N,), generator=gen).to(
            dev, torch.int32)
        g = (torch.rand(N, generator=gen) / N).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, w, b = (t.to(dtype) for t in (x32, w32, b32))
            loss, lse = fsx._fused_fwd(x, w, b, labels)
            rloss, rlse = fsx._xent_fwd_reference(x, w, b, labels)
            grads = fsx._fused_bwd(x, w, b, labels, rlse, g)
            refs = fsx._xent_bwd_reference(x, w, b, labels, rlse, g)
            torch.cuda.synchronize()
            abs_f, err_f = (max(e) for e in zip(errs(loss, rloss),
                                                errs(lse, rlse)))
            abs_b, err_b = (max(e) for e in zip(
                *(errs(a, r) for a, r in zip(grads, refs))))
            worst["K8"] = max(worst["K8"], abs_f)
            worst["K9"] = max(worst["K9"], abs_b)
            ok = (err_f <= REL_TOL[dname] and err_b <= REL_TOL[dname]
                  and bool(torch.isfinite(loss).all()))
            log(f"check K8/K9 xent {label} {dname}: max rel err loss/lse "
                f"{err_f:.3e}, dx/dW/db {err_b:.3e} (tol {REL_TOL[dname]}) "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed("2b", f"K8/K9 {label} {dname} disagrees "
                                        "with its plain version")
            if dtype is not torch.bfloat16 or N != 16384:
                continue
            fwd_ms = time_ms(torch, lambda: fsx._fused_fwd(x, w, b, labels))
            fwd_plain = time_ms(torch, lambda: fsx._xent_fwd_reference(
                x, w, b, labels))
            lab64 = labels.long()
            fwd_lib = time_ms(torch, lambda: F.cross_entropy(
                x @ w + b, lab64, reduction="none"))
            bwd_ms = time_ms(torch, lambda: fsx._fused_bwd(
                x, w, b, labels, rlse, g), windows=3, per_window=5)
            bwd_plain = time_ms(torch, lambda: fsx._xent_bwd_reference(
                x, w, b, labels, rlse, g), windows=3, per_window=5)
            lx, lw, lb = (t.clone().requires_grad_() for t in (x, w, b))
            lib_loss = F.cross_entropy(lx @ lw + lb, lab64, reduction="none")
            bwd_lib = grad_ms(torch, lib_loss, (lx, lw, lb), g)
            for kern, ms, plain_ms, lib_ms, backward in (
                    ("K8", fwd_ms, fwd_plain, fwd_lib, False),
                    ("K9", bwd_ms, bwd_plain, bwd_lib, True)):
                bound_ms, bound_by = xent_bound_ms(N, d, V, 2, backward)
                log(f"time  {kern} xent {label} bf16: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, F.cross_entropy "
                    f"{'bwd' if backward else 'fwd'} {lib_ms:.4f} ms, bound "
                    f"{bound_ms:.5f} ms ({bound_by})")
                records[kern] = [dict(label=label, ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)]
    for kern in ("K8", "K9"):
        records[kern][0]["err"] = worst[kern]
    return records


# ------------------------------------------------------------- phase 3

def serve_flagship(torch, counters, transformer_lm, GenerationEngine,
                   BucketLattice, card):
    net = transformer_lm(**LM, dtype="bfloat16", device="cuda").init(SEED)
    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(64, 512,
                                                                 1024)),
                              slots=4, max_new_tokens=64, page_size=16,
                              prefill_chunk=1024)
    t0 = time.perf_counter()
    warm = engine.warmup()
    torch.cuda.synchronize()
    log(f"serve: warmup {warm} calls in {time.perf_counter() - t0:.3f} s")
    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in (40, 300, 700, 1000) * 2]
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    engine.start()
    t0 = time.perf_counter()
    reqs = [engine.submit_generate(p, 32) for p in prompts]
    for r in reqs:
        if not r.wait(600):
            raise PhaseFailed(3, f"request {r.request_id} timed out")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    engine.drain()
    stats = engine.stats()
    for r in reqs:
        if r.error is not None:
            raise PhaseFailed(3, f"request {r.request_id}: {r.error}")
        if len(r.emitted) != 32 or not all(0 <= t < LM["vocab_size"]
                                           for t in r.emitted):
            raise PhaseFailed(3, f"request {r.request_id} emitted "
                                 f"{r.emitted}")
    if launches["K1"] == 0:
        raise PhaseFailed(3, "prefill never launched the K1 kernel")
    tokens = sum(len(r.emitted) for r in reqs)
    ttft = sorted(r.t_first_token - r.t_enqueue for r in reqs)
    # mean gap between a request's output tokens after its first
    gaps = sorted((r.t_done - r.t_first_token) / (len(r.emitted) - 1)
                  for r in reqs)
    pool = stats["page_pool"]
    log(f"serve: {len(reqs)} requests, {tokens} tokens in {wall:.4f} s -> "
        f"{tokens / wall:.2f} tokens/s; TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.2f} ms, max "
        f"{ttft[-1] * 1e3:.2f} ms; per-request mean token gap p50 "
        f"{statistics.median(gaps) * 1e3:.2f} ms, max "
        f"{gaps[-1] * 1e3:.2f} ms; peak KV pages {pool['pages_peak']}/"
        f"{pool['pages_total']} "
        f"({pool['pages_peak'] / pool['pages_total']:.4f}); "
        f"prefill chunks {stats['prefill_chunks']}, decode steps "
        f"{stats['decode_steps']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
        f"during serving {launches}; card {card}")
    return net, engine, prompts, launches


# ------------------------------------------------------------- phase 4

def oracle_f32(torch, counters, net, transformer_lm, GenerationEngine,
               BucketLattice):
    net32 = transformer_lm(**LM, dtype="float32", device="cuda")
    net32.params = {layer: {k: t.float() for k, t in p.items()}
                    for layer, p in net.params.items()}
    net32.state = net.state
    engine = GenerationEngine(net32, BucketLattice((1,), seq_lens=(512,
                                                                   1024)),
                              slots=2, max_new_tokens=8, page_size=16,
                              prefill_chunk=1024)
    engine.warmup()
    rng = torch.Generator().manual_seed(SEED + 2)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in (505, 1017)]
    counters.reset()
    engine.start()
    emitted = [engine.generate(p, 8, timeout=600) for p in prompts]
    engine.drain()
    for prompt, toks in zip(prompts, emitted):
        seq = list(prompt)
        for i, tok in enumerate(toks):
            probs = net32.output(torch.tensor(seq)[None].numpy())
            ref = int(probs[0, -1].argmax())
            if ref != tok:
                raise PhaseFailed(4, f"prompt of {len(prompt)}: token {i} "
                                     f"is {tok}, full forward gives {ref}")
            seq.append(tok)
    torch.cuda.synchronize()
    launches = counters.read()
    if not (launches["K1"] and launches["K2"]):
        raise PhaseFailed(4, f"the oracle did not drive both kernels: "
                             f"{launches}")
    log(f"oracle: f32 greedy tokens equal full-forward argmax for prompts "
        f"of {[len(p) for p in prompts]} ({sum(map(len, emitted))} tokens)"
        f"; launches {launches}")
    return launches


# ------------------------------------------------------------- phase 5

def time_steps(torch, net):
    """Host-clock time of one 1024-token prefill chunk and of one decode
    step over 4 slots, each ended by a synchronize (median of 10)."""
    cache = net.init_kv_cache(4, 1088)
    prefill, step = net.prefill_fn(), net.incremental_decode_fn()
    T = 1024
    tokens = torch.randint(0, LM["vocab_size"], (1, T),
                           generator=torch.Generator().manual_seed(SEED))
    ones, zero = torch.ones(1, T), torch.zeros(1, dtype=torch.long)

    def host_ms(fn):
        for _ in range(2):
            fn()
        samples = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    pre_ms = host_ms(lambda: prefill(net.params, net.state, cache, tokens,
                                     ones, zero, zero,
                                     torch.tensor([T - 1])))
    dec_ms = host_ms(lambda: step(net.params, net.state, cache,
                                  tokens[0, :4], torch.arange(4) + T))
    log(f"steps: prefill chunk T={T} {pre_ms:.3f} ms, decode step over 4 "
        f"slots {dec_ms:.3f} ms (host clock to synchronize, median of 10)")


def profile_serving(torch, net, GenerationEngine, BucketLattice, prompts):
    """Device time by kernel over two requests (a 1000- and a 300-token
    prompt, 32 tokens each) through a fresh engine on the same net."""
    from torch.profiler import ProfilerActivity, profile

    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(64, 512,
                                                                 1024)),
                              slots=4, max_new_tokens=64, page_size=16,
                              prefill_chunk=1024)
    engine.warmup()
    engine.start()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit_generate(p, 32) for p in (prompts[3],
                                                        prompts[1])]
        for r in reqs:
            if not r.wait(600) or r.error is not None:
                raise PhaseFailed(5, f"profiled request failed: {r.error}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.drain()
    device_profile(torch, prof, wall, "profile")


# ------------------------------------------------------------ phase 6+

# bench.py LM_MODE_DIMS: the flagship training config and the reduced
# other paths (depth and steps cut to fit the time limit)
TRAIN = dict(vocab_size=10000, d_model=256, n_heads=2, n_layers=6,
             d_ff=1024, seq=512, batch=32)
TRAIN_STEPS = 20


def lm_batch(DataSet, vocab, batch, seq, masked=False):
    """Random tokens from numpy seed 0, labels the tokens shifted by one
    (bench.py lm_mode_net_ds); with `masked`, the padding mask of the
    "masked" mode (valid lengths uniform in [seq/2, seq])."""
    rng = np.random.default_rng(SEED)
    toks = np.asarray(rng.integers(0, vocab, (batch, seq)), np.int32)
    kw = {}
    if masked:
        lengths = rng.integers(seq // 2, seq + 1, batch)
        kw["features_mask"] = (np.arange(seq)[None, :]
                               < lengths[:, None]).astype(np.float32)
    return DataSet(toks, np.roll(toks, -1, axis=1), **kw)


class Counters:
    """The launch counts of the kernel wrappers (the LAUNCHES tables of
    ops/flash_attention.py, ops/fused_softmax_xent.py,
    ops/fused_neg_softmax.py and ops/fused_layernorm.py): reset() sets
    every one to 0, read() returns them."""

    def __init__(self, *modules):
        self.tables = tuple(m.LAUNCHES for m in modules)

    def reset(self):
        for table in self.tables:
            for k in table:
                table[k] = 0

    def read(self):
        return {k: n for table in self.tables for k, n in table.items()}


def device_profile(torch, prof, wall, tag, top=12):
    """Log the device busy time (sum of kernel times), the idle share of
    the window and the top kernels by device time; return (idle share,
    rows) or (None, []) when the profiler reported no device time."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # kernels only: a host op that launches a ctypes kernel (the
        # autograd Functions) also reports that kernel's time as its own
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        log(f"{tag}: the profiler reported no device time (not measured)")
        return None, []
    busy = sum(r[0] for r in rows) / 1e6
    idle = 1 - busy / wall
    log(f"{tag}: window {wall:.4f} s, device busy {busy:.4f} s "
        f"(sum of kernel times; idle share {idle:.4f})")
    rows.sort(reverse=True)
    for dev_us, count, key in rows[:top]:
        log(f"{tag}:   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")
    return idle, rows


def train_flagship(torch, counters, transformer_lm, DataSet, flops, card):
    """fit_scanned of the flagship LM for TRAIN_STEPS steps on one batch;
    exact launch counts; step time, tokens/s, MFU, memory, profile."""
    from torch.profiler import ProfilerActivity, profile

    c = TRAIN
    net = transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                         n_heads=c["n_heads"], n_layers=c["n_layers"],
                         d_ff=c["d_ff"], max_length=c["seq"],
                         dtype="bfloat16", device="cuda").init(SEED)
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    net.fit_scanned(ds, epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    losses = net._step_losses.float().flatten().cpu().tolist()
    S, L = TRAIN_STEPS, c["n_layers"]
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K13": 0}
    log(f"train: fit_scanned {S} steps in {wall:.3f} s (first steps "
        f"included); losses {[round(x, 4) for x in losses]}; launches "
        f"{launches}; peak device memory {peak_mib:.1f} MiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise PhaseFailed(6, f"the loss is not finite and falling: {losses}")
    if launches != want:
        raise PhaseFailed(6, f"launches {launches}, expected {want}")

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    step_s = statistics.median(one_step() for _ in range(7))
    tokens = c["batch"] * c["seq"]
    fpt, fpt_exec = flops
    tok_s = tokens / step_s
    log(f"train: step {step_s * 1e3:.3f} ms (host clock to synchronize, "
        f"median of 7 fit() calls) -> {tok_s:.1f} tokens/s; model FLOPs "
        f"per token {fpt} (executed {fpt_exec}); MFU "
        f"{fpt * tok_s / PEAK_BF16_FLOPS:.5f} (executed "
        f"{fpt_exec * tok_s / PEAK_BF16_FLOPS:.5f}) against "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; card {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, rows = device_profile(torch, prof, wall, "train profile (one step)",
                             top=15)
    if rows:
        # the profiler's host cost stretches the profiled window; against
        # the unprofiled median step the same kernel time leaves this idle
        busy = sum(r[0] for r in rows) / 1e6
        log(f"train: device idle share of the unprofiled median step "
            f"{1 - busy / step_s:.4f} (kernel time {busy * 1e3:.3f} ms of "
            f"{step_s * 1e3:.3f} ms)")
    return launches


def train_other_paths(torch, counters, transformer_lm, DataSet):
    """The other attention routes at reduced depth (2 layers, 2 steps):
    packed head_dim 64 (K3/K7), the flat route at T = 512 with an odd
    head count (K1/K4), and long context T = 4096 with the padding mask
    (K1/K5)."""
    # (label, config, launches each must show over 2 layers x 2 steps);
    # d_model 192 is not a multiple of 128, so that run scores on the
    # dense head and launches no K8/K9
    runs = [
        ("transformer_d64", dict(d_model=256, n_heads=4, seq=512, batch=32,
                                 masked=False),
         {"K3": 4, "K7": 4, "K8": 2, "K9": 2}),
        ("flat T=512 (3 heads of 64)", dict(d_model=192, n_heads=3, seq=512,
                                            batch=32, masked=False),
         {"K1": 4, "K4": 4}),
        ("longcontext masked", dict(d_model=256, n_heads=2, seq=4096,
                                    batch=4, masked=True),
         {"K1": 4, "K5": 4, "K8": 2, "K9": 2}),
    ]
    totals = {}
    for label, c, want in runs:
        net = transformer_lm(vocab_size=TRAIN["vocab_size"],
                             d_model=c["d_model"], n_heads=c["n_heads"],
                             n_layers=2, d_ff=TRAIN["d_ff"],
                             max_length=c["seq"], dtype="bfloat16",
                             device="cuda").init(SEED)
        ds = lm_batch(DataSet, TRAIN["vocab_size"], c["batch"], c["seq"],
                      masked=c["masked"])
        counters.reset()
        t0 = time.perf_counter()
        net.fit_scanned(ds, epochs=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        losses = net._step_losses.float().flatten().cpu().tolist()
        log(f"train {label}: 2 layers, 2 steps in {wall:.3f} s; losses "
            f"{[round(x, 4) for x in losses]}; launches {launches}")
        if not all(np.isfinite(losses)):
            raise PhaseFailed(7, f"{label}: loss not finite: {losses}")
        for k, n in want.items():
            if launches[k] != n:
                raise PhaseFailed(7, f"{label}: {k} launched "
                                     f"{launches[k]} times, expected {n}")
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
    return totals


def _plain_flash_qkv(torch, fa):
    """flash_attention_qkv (causal, unmasked) over the plain versions,
    called directly."""
    class F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, H, scale):
            o, lse = fa._flash_fwd_qkv_reference(qkv, H, None, scale, True)
            ctx.save_for_backward(qkv, o, lse)
            ctx.H, ctx.scale = H, scale
            return o

        @staticmethod
        def backward(ctx, do):
            qkv, o, lse = ctx.saved_tensors
            return (fa._flash_bwd_qkv_reference(qkv, o, lse, do, ctx.H, None,
                                                ctx.scale, True),
                    None, None)

    def flash_attention_qkv(qkv, H, *, causal=True, mask=None, dropout=0.0):
        if not causal or mask is not None or dropout:
            raise ValueError("the oracle runs causal, unmasked attention")
        return F.apply(qkv, H, (qkv.shape[-1] // 3 // H) ** -0.5)

    return flash_attention_qkv


def _plain_head(torch, fsx):
    """softmax_xent_head over the plain versions, called directly."""
    class F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b, labels):
            loss, lse = fsx._xent_fwd_reference(x, w, b, labels)
            ctx.save_for_backward(x, w, b, labels, lse)
            return loss

        @staticmethod
        def backward(ctx, g):
            x, w, b, labels, lse = ctx.saved_tensors
            dx, dw, db = fsx._xent_bwd_reference(x, w, b, labels, lse,
                                                 g.float())
            return dx, dw, db.to(b.dtype), None

    def softmax_xent_head(x, w, b, labels):
        lead = x.shape[:-1]
        return F.apply(x.reshape(-1, x.shape[-1]), w, b,
                       labels.reshape(-1)).reshape(lead)

    return softmax_xent_head


# f32 gradients through the kernels against the same gradients through
# the plain versions, relative to the largest |plain| entry of each
# parameter's gradient: both are f32 throughout but sum in other orders,
# and the differences compound through two layers of backward -> 1e-3.
GRAD_REL_TOL = 1e-3


def grad_oracle(torch, counters, transformer_lm, DataSet, fa, fsx):
    """One step's f32 gradients of a 2-layer flagship-width LM with the
    fused routes (packed flash K2/K6, head K8/K9), through the kernels
    and through the plain versions, on the card."""
    import deeplearning4j_tpu_torch.nn.layers.attention as attn

    net = transformer_lm(vocab_size=TRAIN["vocab_size"],
                         d_model=TRAIN["d_model"], n_heads=TRAIN["n_heads"],
                         n_layers=2, d_ff=TRAIN["d_ff"], max_length=512,
                         dtype="float32", device="cuda").init(SEED)
    batch = net._batch_dict(net._to_mds(lm_batch(
        DataSet, TRAIN["vocab_size"], 8, 512)))

    def grads():
        leaves = {lay: {n: t.detach().requires_grad_() for n, t in p.items()}
                  for lay, p in net.params.items()}
        loss, _ = net._loss(leaves, net.state, None, batch, train=False)
        keys = [(lay, n) for lay in leaves for n in leaves[lay]]
        gs = torch.autograd.grad(loss, [leaves[k][n] for k, n in keys])
        return float(loss.detach()), dict(zip(keys, gs))

    counters.reset()
    k_loss, k_grads = grads()
    kernel_launches = counters.read()
    saved = attn.flash_attention_qkv, fsx.softmax_xent_head
    attn.flash_attention_qkv = _plain_flash_qkv(torch, fa)
    fsx.softmax_xent_head = _plain_head(torch, fsx)
    try:
        counters.reset()
        p_loss, p_grads = grads()
        plain_launches = counters.read()
    finally:
        attn.flash_attention_qkv, fsx.softmax_xent_head = saved
    torch.cuda.synchronize()
    worst = max(errs(k_grads[k], p_grads[k])[1] for k in p_grads)
    log(f"grad oracle: f32 loss kernels {k_loss:.6f} plain {p_loss:.6f}; "
        f"max gradient error {worst:.3e} of the largest entry (tol "
        f"{GRAD_REL_TOL}); launches with kernels {kernel_launches}, with "
        f"plain versions {plain_launches}")
    if not (kernel_launches["K2"] and kernel_launches["K6"]
            and kernel_launches["K8"] and kernel_launches["K9"]):
        raise PhaseFailed(8, "the kernel run did not launch K2/K6/K8/K9")
    if any(plain_launches.values()):
        raise PhaseFailed(8, "the plain run launched a kernel")
    if worst > GRAD_REL_TOL or abs(k_loss - p_loss) > 1e-4 * abs(p_loss):
        raise PhaseFailed(8, "kernel gradients disagree with the plain "
                             "versions'")


# ------------------------------------------------------------- phase 9

# K13, K10, K11 against their plain versions, relative to the largest
# |plain| entry. f32: the same f32 math summed in another order -> 1e-5.
# bf16: both read the same bf16 inputs, compute in f32 and round once;
# one f32 difference can flip a rounding. K13's scores lie in (0, 1), so
# one bf16 ulp is at most 2^-8 = 3.9e-3 -> 8e-3 (two ulps); LayerNorm's
# outputs and gradients exceed 1 -> 2e-2, as for the flash kernels.
K13_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
LN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the card's peak for the arithmetic a kernel runs: f32 on the CUDA
# cores for f32 inputs, the bf16 tensor-core rate for bf16 inputs
PEAK_FLOPS = {"float32": 67e12, "bfloat16": PEAK_BF16_FLOPS}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def kernel_device_ms(torch, fn, calls=20):
    """Mean device time per call of the kernels `fn` launches (the sum
    of their times over `calls` calls, from torch.profiler), or None
    when the profiler reports no device time. At these sizes the CUDA
    event time of back-to-back calls is bounded by the host's launch
    path; this is the kernels' own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    return total_us / calls / 1e3 if total_us else None


def bound(nbytes, flops, dname):
    """(least ms, what bounds it) for `nbytes` moved and `flops` done."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_neg_softmax(torch, fns):
    """K13 (csrc/neg_softmax.cu) against `_neg_softmax_reference` at the
    Word2Vec path's shape, the engine feed's and a ragged one, f32 and
    bf16; each f32 case (the paths' dtype) timed against one
    sigmoid(bmm) over the same rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 30)
    records, worst = [], 0.0
    for label, (B, K, D) in (("word2vec B=2048 K=5 D=128", (2048, 5, 128)),
                             ("engine feed B=1024 K=5 D=64", (1024, 5, 64)),
                             ("ragged B=1000 K=7 D=100", (1000, 7, 100))):
        c32, pos32 = ((0.3 * torch.randn(B, D, generator=gen)).to(dev)
                      for _ in range(2))
        neg32 = (0.3 * torch.randn(B, K, D, generator=gen)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            c, pos, neg = (t.to(dtype) for t in (c32, pos32, neg32))
            got = fns.neg_softmax_scores(c, pos, neg)
            ref = fns._neg_softmax_reference(c, pos, neg)
            torch.cuda.synchronize()
            abs_err, err = (max(e) for e in zip(
                *(errs(g, r) for g, r in zip(got, ref))))
            worst = max(worst, abs_err)
            ok = err <= K13_TOL[dname] and all(
                g.dtype == dtype and bool(torch.isfinite(g.float()).all())
                for g in got)
            log(f"check K13 neg_softmax {label} {dname}: max rel err "
                f"{err:.3e} (tol {K13_TOL[dname]}) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(9, f"K13 {label} {dname} disagrees with "
                                     "its plain version")
            if dtype is not torch.float32:
                continue
            run = lambda: fns.neg_softmax_scores(c, pos, neg)  # noqa: E731
            ms = time_ms(torch, run)
            dev_ms = kernel_device_ms(torch, run)
            plain_ms = time_ms(torch, lambda: fns._neg_softmax_reference(
                c, pos, neg))
            lib_ms = time_ms(torch, lambda: torch.sigmoid(torch.bmm(
                torch.cat([pos[:, None], neg], 1), c[..., None])))
            # c, pos, neg read and both scores written once; 2 (K+1) D
            # FLOPs per row
            bound_ms, bound_by = bound((2 * B * D + B * K * D + B * (K + 1))
                                       * 4, 2 * (K + 1) * B * D, dname)
            log(f"time  K13 neg_softmax {label} f32: kernel {ms:.4f} ms "
                f"(device time {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
                f"sigmoid(bmm) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by})")
            records.append(dict(label=label, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
    for rec in records:
        rec["err"] = worst
    return {"K13": records}


def check_layernorm(torch, fln):
    """K10 and K11 (csrc/layernorm.cu) through the `fused_layer_norm`
    autograd Function against `_ln_fwd_reference` / `_ln_bwd_reference`
    at the flagship LM's LayerNorm input (N = 32 x 512 tokens, C = 256)
    and a ragged N=1000 C=200, f32 and bf16; the flagship bf16 case
    timed against F.layer_norm forward and backward."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 40)
    eps = 1e-5
    records, worst = {"K10": [], "K11": []}, {"K10": 0.0, "K11": 0.0}
    for label, (N, C) in (("flagship N=16384 C=256", (16384, 256)),
                          ("ragged N=1000 C=200", (1000, 200))):
        x32 = (1.5 * torch.randn(N, C, generator=gen) + 0.3).to(dev)
        g32 = (1 + 0.2 * torch.randn(C, generator=gen)).to(dev)
        b32 = (0.1 * torch.randn(C, generator=gen)).to(dev)
        dy32 = torch.randn(N, C, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, g, b, dy = (t.to(dtype) for t in (x32, g32, b32, dy32))
            leaves = [t.clone().requires_grad_() for t in (x, g, b)]
            y = fln.fused_layer_norm(*leaves, eps=eps)
            grads = torch.autograd.grad(y, leaves, dy)
            ry, mu, rstd = fln._ln_fwd_reference(x, g, b, eps)
            rdx, rdg, rdb = fln._ln_bwd_reference(x, g, mu, rstd, dy)
            refs = (rdx, rdg.to(dtype), rdb.to(dtype))
            torch.cuda.synchronize()
            abs_f, err_f = errs(y.detach(), ry)
            abs_b, err_b = (max(e) for e in zip(
                *(errs(a, r) for a, r in zip(grads, refs))))
            worst["K10"] = max(worst["K10"], abs_f)
            worst["K11"] = max(worst["K11"], abs_b)
            ok = (err_f <= LN_TOL[dname] and err_b <= LN_TOL[dname]
                  and y.dtype == dtype
                  and bool(torch.isfinite(y.float()).all()))
            log(f"check K10/K11 layernorm {label} {dname}: max rel err y "
                f"{err_f:.3e}, dx/dgamma/dbeta {err_b:.3e} (tol "
                f"{LN_TOL[dname]}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(9, f"K10/K11 {label} {dname} disagrees "
                                     "with its plain version")
            if dtype is not torch.bfloat16 or N != 16384:
                continue
            fwd = lambda: fln._ln_fwd(x, g, b, eps)  # noqa: E731
            bwd = lambda: fln._ln_bwd(x, g, mu, rstd, dy)  # noqa: E731
            fwd_ms = time_ms(torch, fwd)
            fwd_plain = time_ms(torch, lambda: fln._ln_fwd_reference(
                x, g, b, eps))
            fwd_lib = time_ms(torch, lambda: F.layer_norm(x, (C,), g, b,
                                                          eps))
            bwd_ms = time_ms(torch, bwd)
            bwd_plain = time_ms(torch, lambda: fln._ln_bwd_reference(
                x, g, mu, rstd, dy))
            lx, lg, lb = (t.clone().requires_grad_() for t in (x, g, b))
            bwd_lib = grad_ms(torch, F.layer_norm(lx, (C,), lg, lb, eps),
                              (lx, lg, lb), dy)
            e = 2
            # forward: x, gamma, beta read, y, mu, rstd written once,
            # about 8 FLOPs per element; backward: x, dy, gamma, mu,
            # rstd read, dx, dgamma, dbeta written once, about 12
            for kern, fn, ms, plain_ms, lib_ms, nbytes, flops in (
                    ("K10", fwd, fwd_ms, fwd_plain, fwd_lib,
                     2 * N * C * e + 2 * C * e + 8 * N, 8 * N * C),
                    ("K11", bwd, bwd_ms, bwd_plain, bwd_lib,
                     3 * N * C * e + 3 * C * e + 8 * N, 12 * N * C)):
                bound_ms, bound_by = bound(nbytes, flops, dname)
                dev_ms = kernel_device_ms(torch, fn)
                log(f"time  {kern} layernorm {label} bf16: kernel "
                    f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), plain "
                    f"{plain_ms:.4f} ms, F.layer_norm "
                    f"{'bwd' if kern == 'K11' else 'fwd'} {lib_ms:.4f} ms, "
                    f"bound {bound_ms:.5f} ms ({bound_by})")
                records[kern].append(dict(
                    label=label, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
    for kern, recs in records.items():
        for rec in recs:
            rec["err"] = worst[kern]
    return records


# ------------------------------------------------------------ phase 10

# bench.py `_quality_w2v` on the first 8000 sentences of its topic
# corpus: the numbers the JAX package's reference path gives there
# (vocab, steps, the first loss 6 ln 2 that a zero syn1neg fixes, the
# last loss) and the quality floor of this phase
W2V_SENTENCES = 8000
W2V_VOCAB = 9878
W2V_STEPS = 531
W2V_LAST_LOSS = 2.1863
W2V_MIN_SEPARATION = 0.50


def topic_corpus(rng, vocab, n_words, sent_len, n_topics=20):
    """bench.py `_topic_corpus`: zipf-frequency corpus with planted
    topic structure (word i belongs to topic i % n_topics; each sentence
    draws from one topic's word slice)."""
    words = [f"w{i}" for i in range(vocab)]
    per = vocab // n_topics
    zipf = 1.0 / np.arange(1, per + 1)
    p = zipf / zipf.sum()
    n_sents = n_words // sent_len
    topics = rng.integers(0, n_topics, n_sents)
    ranks = rng.choice(per, size=(n_sents, sent_len), p=p)
    ids = ranks * n_topics + topics[:, None]
    return [[words[j] for j in row] for row in ids]


def topic_separation(w2v, n_topics=20, top_ranks=10):
    """bench.py `_topic_separation`: mean within-topic cosine minus mean
    across-topic cosine over the most frequent words of each topic
    (random vectors score about 0)."""
    vecs = {}
    for t in range(n_topics):
        rows = []
        for r in range(top_ranks):
            v = w2v.word_vector(f"w{r * n_topics + t}")
            if v is not None:
                v = np.asarray(v, np.float64)
                n = np.linalg.norm(v)
                if n > 0:
                    rows.append(v / n)
        vecs[t] = np.stack(rows)
    within, across = [], []
    for t in range(n_topics):
        sim = vecs[t] @ vecs[t].T
        iu = np.triu_indices(len(vecs[t]), 1)
        within.append(sim[iu].mean())
        u = (t + 1) % n_topics
        across.append((vecs[t] @ vecs[u].T).mean())
    return float(np.mean(within) - np.mean(across))


def _timed(fn, acc):
    """fn, adding its wall time to acc[0] on every call."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
    return wrapped


def train_word2vec(torch, counters, Word2Vec, card):
    """The call bench.py `_quality_w2v(sub, use_device_pipeline=False)`
    makes, on CUDA through the port's engine; the checks of phase 10."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000,
                         25)[:W2V_SENTENCES]
    w2v = (Word2Vec.builder().layer_size(128).window_size(5)
           .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
           .device("cuda").build())
    w2v.build_vocab(sents)
    log(f"word2vec: corpus and vocab in {time.perf_counter() - t0:.3f} s")
    pair_s, flush_s = [0.0], [0.0]
    w2v._pairs_for_sequence = _timed(w2v._pairs_for_sequence, pair_s)
    w2v._flush_sg = _timed(w2v._flush_sg, flush_s)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    w2v.fit(sents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    losses = w2v.loss_history
    vocab = w2v.vocab.num_words()
    words = w2v.vocab.total_word_occurrences
    sep = topic_separation(w2v)
    near = w2v.words_nearest("w0", 10)
    log(f"word2vec: vocab {vocab}, {len(losses)} steps in {wall:.4f} s -> "
        f"{words / wall:.1f} words/s, {len(losses) / wall:.2f} steps/s; "
        f"host time in pair generation {pair_s[0]:.4f} s "
        f"({pair_s[0] / wall:.4f} of the fit), in the step calls "
        f"(negative draws, copies, enqueue) {flush_s[0]:.4f} s "
        f"({flush_s[0] / wall:.4f}); loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; topic separation {sep:.4f}; nearest to w0 "
        f"{near}; launches {launches}; card {card}")
    failures = []
    if vocab != W2V_VOCAB:
        failures.append(f"vocab {vocab} != {W2V_VOCAB}")
    if not len(losses) == launches["K13"] == W2V_STEPS:
        failures.append(f"{len(losses)} steps and {launches['K13']} K13 "
                        f"launches, expected {W2V_STEPS} of each")
    if any(n for k, n in launches.items() if k != "K13"):
        failures.append(f"another kernel launched: {launches}")
    if not abs(losses[0] - 6 * np.log(2)) <= 1e-5:
        failures.append(f"first loss {losses[0]} != 6 ln 2")
    if not abs(losses[-1] - W2V_LAST_LOSS) <= 0.05 * W2V_LAST_LOSS:
        failures.append(f"last loss {losses[-1]} not within 5% of "
                        f"{W2V_LAST_LOSS}")
    if not sep >= W2V_MIN_SEPARATION:
        failures.append(f"topic separation {sep} < {W2V_MIN_SEPARATION}")
    if len(near) != 10 or not all(w2v.has_word(w) for w in near):
        failures.append(f"words_nearest('w0') gave {near}")
    if failures:
        raise PhaseFailed(10, "; ".join(failures))

    # a profiled window of the same host loop (400 more sentences, so
    # about 30 more steps), for the device idle share
    total = w2v.vocab.total_word_occurrences
    torch.cuda.synchronize()
    n0 = len(w2v.loss_history)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w2v._train_corpus(sents[:400], total, words_done=total)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    device_profile(torch, prof, pwall,
                   f"word2vec profile ({len(w2v.loss_history) - n0} steps)")
    return launches


# ------------------------------------------------------------ phase 11

# bench.py EMBED_DIMS: the engine's training half at ep=1
EMBED = dict(vocab=131072, dim=64, batch=1024, negative=5, window=5,
             seq_len=25, train_steps=20, lr=0.025, seed=0)


def engine_feed(E, steps, seed):
    """bench.py's embed feed: random index sequences through
    sequence_pair_batches + with_negatives (uniform unigram table),
    prefetched; enough sequences for `steps` + 2 batches."""
    from deeplearning4j_tpu_torch.embedding.corpus import (
        prefetched,
        sequence_pair_batches,
        with_negatives,
    )

    v, b, w = E["vocab"], E["batch"], E["window"]
    rng = np.random.default_rng(seed)
    pairs_per_seq = 2 * w * E["seq_len"] - w * (w + 1)
    n_seq = (steps + 2) * b // pairs_per_seq + 3
    seqs = [rng.integers(0, v, size=E["seq_len"]) for _ in range(n_seq)]
    cum = np.arange(1, v + 1, dtype=np.float64) / v
    return prefetched(with_negatives(
        sequence_pair_batches(seqs, batch_size=b, window=w, seed=seed + 5),
        cum, E["negative"], seed=seed + 7), depth=4)


def train_engine(torch, counters, ShardedEmbeddingEngine, card):
    """One warm-up step, then `train_steps` timed steps of the engine
    fed by the prefetched pair feed; exactly 1 + steps K13 launches."""
    E = EMBED
    eng = ShardedEmbeddingEngine(E["vocab"], E["dim"],
                                 negative=E["negative"], seed=3,
                                 device="cuda")
    feed = engine_feed(E, E["train_steps"], E["seed"])
    torch.cuda.synchronize()
    counters.reset()
    try:
        eng.sgns_step(*next(feed), E["lr"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(E["train_steps"]):
            eng.sgns_step(*next(feed), E["lr"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        feed.close()
    launches = counters.read()
    losses = torch.stack(eng.loss_history).cpu().tolist()
    log(f"engine: {E['train_steps']} steps of {E['batch']} pairs in "
        f"{wall:.4f} s -> {E['train_steps'] * E['batch'] / wall:.1f} "
        f"pairs/s; table bytes {eng.table_bytes_per_device()}; losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches {launches}; card "
        f"{card}")
    want = E["train_steps"] + 1
    if launches["K13"] != want:
        raise PhaseFailed(11, f"K13 launched {launches['K13']} times, "
                              f"expected {want}")
    if not all(np.isfinite(losses)):
        raise PhaseFailed(11, f"a loss is not finite: {losses}")
    return launches


# ------------------------------------------------------------ phase 12

# f32 tables after 50 steps through K13 against 50 through the plain
# version, relative to the largest table entry: the scores agree to a
# few f32 ulps, and index_add_'s atomics sum duplicate rows in an order
# that changes from run to run -> 1e-4
ENGINE_ORACLE_TOL = 1e-4
ENGINE_ORACLE_STEPS = 50


def engine_oracle(torch, counters, ShardedEmbeddingEngine, fns):
    """The same batches through two engines from the same init: one
    scored by the kernel, one by `_neg_softmax_reference` called
    directly."""
    import deeplearning4j_tpu_torch.embedding.engine as engine_mod

    E, S = EMBED, ENGINE_ORACLE_STEPS
    feed = engine_feed(E, S, E["seed"] + 100)
    try:
        batches = [next(feed) for _ in range(S)]
    finally:
        feed.close()

    def run():
        eng = ShardedEmbeddingEngine(E["vocab"], E["dim"],
                                     negative=E["negative"], seed=3,
                                     device="cuda")
        counters.reset()
        for batch in batches:
            eng.sgns_step(*batch, E["lr"])
        torch.cuda.synchronize()
        return eng, counters.read()["K13"]

    k_eng, k_launches = run()
    engine_mod.neg_softmax_scores = fns._neg_softmax_reference
    try:
        p_eng, p_launches = run()
    finally:
        engine_mod.neg_softmax_scores = fns.neg_softmax_scores
    worst = max(errs(getattr(k_eng, n), getattr(p_eng, n))[1]
                for n in ("syn0", "syn1neg"))
    log(f"engine oracle: {S} f32 steps, max table error {worst:.3e} of the "
        f"largest entry (tol {ENGINE_ORACLE_TOL}); K13 launches with the "
        f"kernel {k_launches}, with the plain version {p_launches}")
    if k_launches != S or p_launches != 0:
        raise PhaseFailed(12, f"launches {k_launches} / {p_launches}, "
                              f"expected {S} / 0")
    if not worst <= ENGINE_ORACLE_TOL:
        raise PhaseFailed(12, "kernel tables disagree with the plain "
                              "version's")


# ----------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.embedding import ShardedEmbeddingEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_flops_per_token,
        transformer_flops_per_token_executed,
        transformer_lm,
    )
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_neg_softmax as fns
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = nvidia_smi("name,power.limit")
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc '{nvcc}', device {torch.cuda.get_device_name(0)} "
        f"(capability {torch.cuda.get_device_capability(0)}), "
        f"{torch.cuda.device_count()} device(s); nvidia-smi: {name_power}")

    t0 = time.perf_counter()
    outputs = cuda_build.build(verbose=True)
    log(f"build: {sorted(outputs) or 'up to date'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {src}: {line.strip()}")

    records = check_kernels(torch, fa)
    records.update(check_flash_backward(torch, fa))
    records.update(check_xent(torch, fsx))
    records.update(check_neg_softmax(torch, fns))
    records.update(check_layernorm(torch, fln))
    counters = Counters(fa, fsx, fns, fln)
    net, _, prompts, serve_launches = serve_flagship(
        torch, counters, transformer_lm, GenerationEngine, BucketLattice,
        name_power)
    oracle_launches = oracle_f32(torch, counters, net, transformer_lm,
                                 GenerationEngine, BucketLattice)
    time_steps(torch, net)
    profile_serving(torch, net, GenerationEngine, BucketLattice, prompts)
    del net
    flops = tuple(f(TRAIN["vocab_size"], TRAIN["d_model"], TRAIN["n_layers"],
                    TRAIN["d_ff"], TRAIN["seq"])
                  for f in (transformer_flops_per_token,
                            transformer_flops_per_token_executed))
    train_launches = train_flagship(torch, counters, transformer_lm,
                                    DataSet, flops, name_power)
    other_launches = train_other_paths(torch, counters, transformer_lm,
                                       DataSet)
    grad_oracle(torch, counters, transformer_lm, DataSet, fa, fsx)
    w2v_launches = train_word2vec(torch, counters, Word2Vec, name_power)
    engine_launches = train_engine(torch, counters, ShardedEmbeddingEngine,
                                   name_power)
    engine_oracle(torch, counters, ShardedEmbeddingEngine, fns)

    # one entry per TPU kernel, timed at the heaviest shape a path gives
    # it; launches summed over the paths' runs (serving, its f32 oracle,
    # flagship training, the other training paths, Word2Vec and the
    # engine), each counted from 0 just before it and read just after
    runs = (serve_launches, oracle_launches, train_launches, other_launches,
            w2v_launches, engine_launches)
    launches = {k: sum(run.get(k, 0) for run in runs)
                for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                          "K9", "K10", "K11", "K13")}
    picks = {"K1": "flat masked causal BH=8 T=4096 D=128",
             "K2": "packed B=32 T=512 H=2 D=128",
             "K3": "packed B=32 T=512 H=4 D=64",
             "K4": "flat masked BH=96 T=512 D=64",
             "K5": "flat masked BH=8 T=4096 D=128",
             "K6": "packed B=32 T=512 H=2 D=128",
             "K7": "packed B=32 T=512 H=4 D=64",
             "K8": "flagship N=16384 d=256 V=10000",
             "K9": "flagship N=16384 d=256 V=10000",
             "K10": "flagship N=16384 C=256",
             "K11": "flagship N=16384 C=256",
             "K13": "word2vec B=2048 K=5 D=128"}
    fa_src = "deeplearning4j_tpu/ops/flash_attention.py"
    xent_src = "deeplearning4j_tpu/ops/fused_softmax_xent.py"
    ln_src = "deeplearning4j_tpu/ops/fused_layernorm.py"
    table = {
        "K1": ("flash_fwd flat (_flash_fwd -> _fwd_kernel)", "flash_fwd.cu",
               f"{fa_src}:368"),
        "K2": ("flash_fwd packed qkv (_flash_fwd_qkv)", "flash_fwd.cu",
               f"{fa_src}:1077"),
        "K3": ("flash_fwd packed head_dim 64 (_flash_fwd_qkv_pair)",
               "flash_fwd.cu", f"{fa_src}:992"),
        "K4": ("flash_bwd flat single block (_flash_bwd_fused)",
               "flash_bwd.cu", f"{fa_src}:624"),
        "K5": ("flash_bwd flat split (_flash_bwd_impl)", "flash_bwd.cu",
               f"{fa_src}:663"),
        "K6": ("flash_bwd packed qkv (_flash_bwd_qkv)", "flash_bwd.cu",
               f"{fa_src}:1123"),
        "K7": ("flash_bwd packed head_dim 64 (_flash_bwd_qkv_pair)",
               "flash_bwd.cu", f"{fa_src}:1037"),
        "K8": ("softmax_xent fwd (_fused_fwd)", "softmax_xent.cu",
               f"{xent_src}:116"),
        "K9": ("softmax_xent bwd dx + dW/db (_fused_bwd)", "softmax_xent.cu",
               f"{xent_src}:212"),
        "K10": ("layernorm fwd (_ln_fwd)", "layernorm.cu", f"{ln_src}:94"),
        "K11": ("layernorm bwd dx + dgamma/dbeta (_ln_bwd)", "layernorm.cu",
                f"{ln_src}:121"),
        "K13": ("neg_softmax SGNS scores (_neg_softmax_pallas)",
                "neg_softmax.cu", "deeplearning4j_tpu/ops/fused_neg_softmax.py"
                ":76"),
    }
    kernels = []
    for kern, (name, src, replaces) in table.items():
        rec = next(r for r in records[kern] if r["label"] == picks[kern])
        err = max(r["err"] for r in records[kern])
        kernels.append({
            "name": f"{kern} {name}", "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": err, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["label"],
            **({"device_ms": rec["device_ms"]} if "device_ms" in rec
               else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
