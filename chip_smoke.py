#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch/) on one
NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. Environment: CUDA and nvcc versions, the card, its power limit; TF32
   off for matrix products and convolutions. Builds every kernel source
   in deeplearning4j_tpu_torch/csrc/ with nvcc (one process per source,
   started together).
2. Kernel vs plain version: the flash-forward kernel through its K1
   (flat, masked) and K2 (packed qkv) wrappers at the shapes serving and
   the full forward give it, in float32 and bfloat16, against
   `_flash_fwd_reference` on the same inputs; the kernel, the plain
   version and `scaled_dot_product_attention` (the library yardstick,
   which the port never calls) are timed with CUDA events.
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

The last lines are a `{"kernels": [...]}` JSON line, the card's name and
power limit as nvidia-smi gives them, and `{"ok": true, "device": ...}`.
With no CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
    Returns per-kernel records for the kernels line."""
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

    records = {"K1": [], "K2": []}
    cases = []
    for T in (512, 1024):  # chunked prefill: masked, causal, BH = 1 * 2
        cases.append(("K1", f"flat masked causal BH=2 T={T} D=128",
                      dict(BH=2, T=T, D=128, masked=True)))
    cases.append(("K1", "flat unmasked causal BH=2 T=1024 D=128",
                  dict(BH=2, T=1024, D=128, masked=False)))
    cases.append(("K2", "packed B=8 T=512 H=2 D=128",
                  dict(B=8, T=512, H=2, D=128)))
    cases.append(("K2", "packed B=8 T=512 H=4 D=64 (K3's forward)",
                  dict(B=8, T=512, H=4, D=64)))

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


# ------------------------------------------------------------- phase 3

def serve_flagship(torch, fa, transformer_lm, GenerationEngine,
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
    fa._flash_fwd.launches = fa._flash_fwd_qkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    engine.start()
    t0 = time.perf_counter()
    reqs = [engine.submit_generate(p, 32) for p in prompts]
    for r in reqs:
        if not r.wait(600):
            raise PhaseFailed(3, f"request {r.request_id} timed out")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fa._flash_fwd.launches,
                "K2": fa._flash_fwd_qkv.launches}
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

def oracle_f32(torch, fa, net, transformer_lm, GenerationEngine,
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
    fa._flash_fwd.launches = fa._flash_fwd_qkv.launches = 0
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
    launches = {"K1": fa._flash_fwd.launches,
                "K2": fa._flash_fwd_qkv.launches}
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
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        log("profile: the profiler reported no device time (not measured)")
        return
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile: window {wall:.4f} s, device busy {busy:.4f} s "
        f"(sum of kernel times; idle share {1 - busy / wall:.4f})")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"profile:   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")


# ----------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
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
    net, _, prompts, serve_launches = serve_flagship(
        torch, fa, transformer_lm, GenerationEngine, BucketLattice,
        name_power)
    oracle_launches = oracle_f32(torch, fa, net, transformer_lm,
                                 GenerationEngine, BucketLattice)
    time_steps(torch, net)
    profile_serving(torch, net, GenerationEngine, BucketLattice, prompts)

    # one entry per TPU kernel, timed at the main path's heaviest shape:
    # K1 at the 1024 prefill chunk, K2 at the 512 full forward
    picks = {"K1": "flat masked causal BH=2 T=1024 D=128",
             "K2": "packed B=8 T=512 H=2 D=128"}
    replaces = {"K1": "deeplearning4j_tpu/ops/flash_attention.py:368",
                "K2": "deeplearning4j_tpu/ops/flash_attention.py:1077"}
    names = {"K1": "K1 flash_fwd flat (_flash_fwd -> _fwd_kernel)",
             "K2": "K2 flash_fwd packed qkv (_flash_fwd_qkv)"}
    kernels = []
    for kern in ("K1", "K2"):
        rec = next(r for r in records[kern] if r["label"] == picks[kern])
        kernels.append({
            "name": names[kern], "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces[kern],
            "launches": serve_launches[kern] + oracle_launches[kern],
            "max_abs_err": max(r["err"] for r in records[kern]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["label"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
