#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch/) on one
NVIDIA GPU (written for the H100): serving the flagship Transformer LM
(greedy, speculative and over the int8 cache, in process and over HTTP)
and training it (also with attention dropout and at T = 32768 through
the chunked tier), training Word2Vec through the embedding engine, the
speculative traffic replay, through the port's hand-written kernels,
training the image models (LeNet-5, VGG-16, ResNet-20), which run none
of them, the predict path and the serving fleet (InferenceEngine,
/predict, the traffic replays, checkpoints, hot-swap, self-healing), and
the rest of nn/ (the MoE LM, remat, the GravesLSTM char model with TBPTT
and rnn_time_step, LION/LAMB, the solvers, pretraining, nested networks,
early stopping), and the rest of embeddings and NLP (the Word2Vec device
pipeline, ANN serving over /embed and /search, DeepWalk,
ParagraphVectors, GloVe).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

or, to time phase 6 against another checkout (e.g. the parent commit
unpacked by `git archive` into a git-ignored directory) on the same
card, in turns other, this, this, other, each its own process:

    python3 chip_smoke.py --ab OTHER_CHECKOUT

Phases, each of which exits non-zero when it fails:

1. Environment: CUDA and nvcc versions, the card, its power limit; TF32
   off for matrix products and convolutions. Builds every kernel source
   in deeplearning4j_tpu_torch/csrc/ with nvcc (one process per source,
   started together) and logs each kernel's registers and spills; a
   tensor-core kernel (namespaces tcf, tcx), K10's and K11's vector
   kernels and K11's column sum (lnv) or K12 (smp) that spills fails.
2. Forward kernels vs plain version: the flash-forward kernel as K1
   (flat, masked), K2 (packed qkv) and K3 (packed, head_dim 64) at the
   shapes serving, the full forward and training give it (K1 at
   BH=2 T<=1024, BH=96 T=512 D=64 and BH=8 T=4096; K2/K3 at B=8 and
   B=32), at head dims 32 and 256 (K1 BH=16 T=1024 D=32 and BH=4 T=1024
   D=256, masked; K2 B=8 T=512 H=2 D=256), at B*H = 65600 (T=64
   D=32) and, with the predict batcher's key padding mask and one
   all-masked sequence, K2 at B=4 T=512 H=2 D=128 and K3 at B=8 T=512
   H=4 D=64, in float32 and bfloat16, against `_flash_fwd_reference` /
   `_flash_fwd_qkv_reference` on the same inputs (a masked case's
   all-masked row must give o = 0 and lse below -1e19), each also with in-kernel dropout (rate 0.1, a fixed
   seed; K1 at BH=8 T=4096 hashed at window origin (8192, 4096) of a
   sequence of 16384). Each bf16 case runs a second time and must repeat
   bit for bit; the kernel, the plain version and
   `scaled_dot_product_attention` (the library yardstick, which the
   port never calls; with dropout_p=0.1 for the dropout arm) are timed
   with CUDA events, the kernel and SDPA also by their device time per
   launch (torch.profiler), with the achieved TFLOP/s and roofline share
   beside the card's name and power limit, and the dropout arm's device
   time against the no-dropout arm's.
2b. Training kernels vs plain version, f32 and bf16: the flash backward
   (K6 packed B=32 T=512 H=2 D=128, K7 packed H=4 D=64, K4 flat T=512
   at BH=96 D=64 and BH=8 D=128, K5 flat BH=8 at T=2048 and T=4096,
   K5 flat BH=16 T=1024 D=32 and BH=4 T=1024 D=256, K6 packed B=8 T=512
   H=2 D=256, K4 flat BH=65600 T=64 D=32; the flat cases masked with
   one all-masked row) against `_flash_bwd_reference`, each also with
   dropout (as in phase 2) and the flat cases (K4, K5) with an lse
   cotangent (dlse), timed (CUDA events and device time per launch)
   against the backward of `scaled_dot_product_attention` (with
   dropout_p=0.1 for the dropout arm); the softmax-xent head (K8 forward,
   K9 backward) at N=16384 d=256 V=10000 and a ragged N=300 V=2100
   against `_xent_fwd_reference` / `_xent_bwd_reference`, timed against
   `F.cross_entropy(x @ W + b)` forward and backward. Each bf16 kernel
   (K4-K7 at every head dim and in every arm, K8 and K9, on the tensor
   cores) runs a second time and must repeat bit for bit; each timing
   line names the kernels that ran (a scalar kernel in bf16 fails) and
   gives their and the library's device time a launch, the achieved
   TFLOP/s and the roofline share beside the card's name and power
   limit.
2c. The chunked tier (`chunked_flash_attention`) at T=16384 (B=1, H=2,
   D=128), f32 and bf16, without and with the padding mask and dropout:
   forward and gradients against a plain computation in 1024-row query
   blocks with the port's torch keep mask, and tiles of 4096 against
   tiles of 8192 (the same keep mask); then the device time of the long
   modes' tiles (BH=16, c=8192, D=128: the diagonal and a full tile, K1
   and K5 with dlse, without and with dropout) against their bounds.
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
6b. The flagship's bench modes at their own dims (6 layers): "dropout"
   (T=512, batch 32, masked, attention dropout 0.1; 20 steps, exactly
   K2 = K6 = 120 and K8 = K9 = 20), "longcontext_chunked" (T=32768,
   batch 8, 2 steps: tiles of 8192, 10 causal tile pairs a layer, so
   exactly K1 = K5 = 120 and K8 = K9 = 2) and
   "longcontext_chunked_dropout" (the same, masked, dropout 0.1): finite
   losses, no dense route; step time, tokens/s, MFU, peak memory and a
   profile of one step each.
7. The other training routes at 2 layers and 2 steps: "transformer_d64"
   (K3/K7) and the flat route at T=512 with 3 heads of 64 (K1/K4), each
   also with attention dropout 0.1,
   "longcontext" T=4096 batch 4 with the padding mask (K1/K5), and the
   head dims of fault C1 at T=512 batch 32: 8 heads of 32 at d_model
   256 (the flat route, K1/K4) and 2 heads of 256 at d_model 512 (the
   packed route, K2/K6). Every flash launch count is exact, and K8/K9
   launch once a step where the fused head takes the shape.
8. f32 gradient oracle: one step's gradients of a 2-layer flagship-width
   LM through the kernels and through the plain versions (called
   directly) agree.
9. Word2Vec and LayerNorm kernels vs plain version, f32 and bf16: K13
   (csrc/neg_softmax.cu) at B=2048 K=5 D=128 (the Word2Vec path),
   B=1024 K=5 D=64 (the engine feed) and a ragged B=1000 K=7 D=100
   against `_neg_softmax_reference`, timed against sigmoid(bmm); K10/K11
   (csrc/layernorm.cu) through the `fused_layer_norm` autograd Function
   at N=16384 C=256, N=16383 (ragged rows), a ragged N=1000 C=200 and
   an x one element off its 16-byte boundary, against
   `_ln_fwd_reference` / `_ln_bwd_reference`, each run twice to repeat
   bit for bit, through the instantiations `_fwd_plan` and `_bwd_plan`
   must pick (the vector kernels, K11 on 264 blocks at N=16384, or the
   general path for C=200 and the unaligned x), timed against
   F.layer_norm forward and backward (event and device time, K11's by
   kernel; a call that runs any kernel but layernorm.cu's fails), with
   the host microseconds of each part of K10's launch path. Fault C2:
   K13 on strided views of c, pos and neg (equal to the launch on
   contiguous copies bit for bit, and to the plain version), and K10/K11
   with bf16 x and f32 gamma/beta at N=16384 C=256 (the vector kernels)
   and N=1000 C=200 (the general path): within LN_TOL of the plain
   version with the f32 gamma, repeating bit for bit, and nearer to it
   than to the plain version with gamma rounded to bf16.
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
13. Sampling kernel vs plain version (run with the other kernel checks,
   after phase 9): K12 (csrc/sampling.cu) at the replay's [8, 128], the
   flagship's [4, 10000] (slots x vocab), [32, 10000] and, for the top-p
   match rate, [1024, 10000], f32 and bf16 logits, in five modes
   (temperature 1; 0.8 with top_k 8; top_p 0.9; top_k 8 with top_p 0.9;
   top_k 1000 with top_p 0.5) against `_select_reference` on the same
   Gumbel noise: every row equal without top-p, at most 0.1% of rows
   apart with it (the nucleus mass is a float sum in another order);
   every launch run twice (the second writing its thresholds) to repeat
   bit for bit, the top-k thresholds equal to the plain binary walk's bit
   for bit; kernel, device, plain and bound times, the Gumbel argmax
   call's event and device time for the temperature-only mode, and the
   device time of each launch plan (threads, cluster) at [4, 10000] and
   [32, 10000] with both filters. Fault C2: logits the last position of
   a [B, 3, V] output and noise from a wider buffer (strided views) at
   [8, 128] and [4, 10000], f32 and bf16, every mode: equal to the
   launch on contiguous copies, and (without top-p) to the plain
   version.
14. Serving over HTTP (run after phase 5, on the phase-3 LM): the
   flagship behind `ServingServer` in three arms (speculative k=4, the
   int8 cache, both), each serving phase 3's 8 requests over POST
   /generate: tokens/s and TTFT from the arm's telemetry log
   (`reconstruct_generation`), acceptance, bytes per slot, trace_count
   frozen after warmup, the page pool empty at the end, the /metrics
   families present.
15. Speculative oracle (after phase 14): with the phase-3 params in f32,
   the speculative k=4 stream must equal plain greedy except where the
   top-2 log-probability margin at the first difference is below 1e-4;
   the int8 cache's stream against the f32 cache's is reported the same
   way.
16. The speculative traffic replay (`run_speculative_replay`) at
   bench.py's `serving_speculative` settings (24 requests, burst 2, 4 ms
   gaps, prompts 8/16/32, outputs 4/8/16, 4 slots, page 16, k 4, 2
   rounds of 3 arms): every metric line printed, both parity rows 0, and
   exactly 21 K12 launches (the sampling microbench's warm call and 20
   timed ones).
17. The image models at bench.py's sizes: the f32 LeNet-5, VGG-16 and
   ResNet-20 on the card against the same models on the CPU with the
   card's params (8 images, softmax outputs within 1e-4, TF32 off);
   LeNet-5 (batch 512, bf16) trained through `fit_scanned` and `fit` on
   100 batches of the synthetic MNIST, its loss falling and its
   accuracy on the synthetic test split at least 0.99; then LeNet-5,
   VGG-16 (batch 256, bf16) and ResNet-20 (batch 64, f32 and bf16): 5
   fit() steps on one batch (the loss falls, the params stay finite),
   batch norm's running statistics moved and used by `output`, the
   median CUDA-event time of 20 fit() steps, images/s, FLOPs a step
   (2 B Ho Wo Cout Cin kh kw a convolution, times 3), MFU against 989
   TFLOP/s, peak memory and a profiled step's idle share and five
   largest kernels, beside the card's name and power limit. The image
   path launches none of K1-K13: every count reads 0.

18. The predict path and the fleet (after phase 17). 18a: phase 3's
   flagship LM (bf16, seed 0) behind `InferenceEngine` (2 replicas, the
   (1, 2, 4) x (128, 512, 1024) lattice, max wait 4 ms), warmed with a
   1024-token example, serving 48 requests of `make_trace(seed=0,
   n_requests=48, burst=4, mean_gap_s=0.004, lengths=(100, 128, 400,
   512, 900, 1024))` (tokens from numpy seed 1) from a client thread
   pool at their offsets: every output [len, 10000] and finite; trace
   count frozen and `reconstruct`'s recompiles 0; exactly K2 = 6 x the
   forwards at seq 512 and K1 = 6 x those at 1024 (warmup included), no
   K3-K13, no dense route for a head dim; p50/p99/QPS, each bucket's
   median forward span beside the forward on the card and the host
   fetch timed alone, a profiled (4, 1024) batch's idle share. A request
   alone in bucket (4, T) and beside three others equal bit for bit (T =
   512, 1024); a served batch with an all-masked padding row through the
   kernels and through the plain versions within 2e-2 of the largest
   probability; an f32 copy served on the card against each request
   alone on the CPU within 1e-4. 18b: `run_replay` at bench.py's
   `serving_replay` settings, the tiny LM and the tiny MLP, 120 of 120
   each. 18c: `run_fleet_replay` at its defaults: the fixed arm fails
   none; the autoscale arm fails 1-4 (the killed batch), respawns,
   swaps once and names generations 0 and 1; no recompile. 18d: the
   flagship saved and restored by `InferenceEngine(checkpoint=...)`
   (outputs bit for bit); a hot swap to a seed-1 net under 24 requests
   (batch 1, max wait 0; 20 in flight through the swap, 4 sent once it
   has landed: none fails, both generations serve, each equals the
   direct forward of the net its `weight_gen` names); a narrower net's
   checkpoint refused by `validate_checkpoint_shapes` with the old
   weights serving on; phase 3's `GenerationEngine` with
   `r0:kill@decode5` under a `FleetSupervisor`: the killed requests
   fail, the pool empties, the worker respawns with no new shape and the
   later requests complete.
19. The rest of nn/ (after phase 18). 19a: the MoE LM at bench.py's
   `moe` width (vocab 10000, d_model 256, 2 heads, 6 layers, 8 experts
   top-2, d_expert 512, routed at capacity factor 1.25, bf16, seed 0)
   through 5 `fit_scanned` steps on phase 6's batch: the loss finite and
   falling, the params finite, the router's aux loss equal to the
   training score less the inference score, exactly K2 = K6 = 6 and
   K8 = K9 = 1 a step and no other kernel; a [4, 512] forward through
   the kernels against the plain versions within 2e-2 of the largest
   probability; an f32 copy on the card against the CPU within 1e-4; the
   routed layer at capacity factor E / top_k against the dense one
   (blk0's params, 16384 tokens, f32: output within 1e-5, gradients
   within 1e-4 of the largest); the median CUDA-event time of 20 fit()
   steps, tokens/s, MFU, peak memory, a profiled step's idle share and
   five largest kernels, and the dense flagship's step in the same call
   with the ratio (`vs_dense_ratio`, no floor). 19b: one step's
   gradients of the MoE LM with dropout 0.1 with and without remat, bit
   for bit; K2 = 12 with remat (forward and recompute); peak memory of
   each, lower with remat. 19c: the GravesLSTM char model (two
   GravesLSTM(200) over 77 characters, batch 32, sequences of 1000,
   TBPTT 50, RMSProp, f32) on a synthetic Markov character stream from
   numpy seed 0: 3 fit() batches (60 segments), the loss falling; the
   forward against the CPU within 1e-4; `rnn_time_step` in three chunks
   against the full forward within 1e-5; 4 samples of 300 characters;
   the time a segment, characters/s and a profiled segment's idle
   share; GRU and the bidirectional LSTM at 200 units, one forward each
   against the CPU. 19d: 5 LION and 5 LAMB steps of the flagship (phase
   6's batch), LBFGS, CG and line gradient descent on LeNet-5 (batch
   512, f32, 5 iterations), greedy pretraining of an AutoEncoder and an
   RBM (784-500-250, batch 128), an MLP NetworkLayer in a graph (3
   steps), and early stopping of LeNet-5 over 3 epochs with the best
   model from the in-memory and the file saver bit for bit.

20. The rest of embeddings and NLP (after phase 19; each sub-phase
   first runs its path at a tiny size in f32 on the card and on the CPU
   from the same init and draws, within 1e-5 of the largest entry).
   20a: bench.py `bench_word2vec` on the port's device pipeline (layer
   128, window 5, negative 5, seed 1, chunk 2048 x group 4) over the
   topic corpus (1,000,000 words): a warm fit, then a timed fit (words/s
   beside phase 10's host path, the host packing's share, topic
   separation); on the 8000-sentence sub-corpus the pipeline defaults,
   unshared negatives and the host path (the defaults must keep 0.95 of
   the host path's separation, bench.py's gate), a CBOW pipeline fit
   (its loss falls) and a profiled pipeline fit's idle share. 20b:
   bench mode `embed`'s serving half on phase 11's engine: a clustered
   131072 x 64 snapshot published into it, an `EmbeddingServingEngine`
   (1024 partitions, lattice (1, 4, 16, 128), k 10, recall floor 0.95,
   128 calibration queries, seed 1; its build time), 16 /embed rows
   within 1e-6 of the published ones, 20 searches of 128 queries
   (recall@10 against `brute_force_topk` >= 0.95, no new shape after
   warmup), ANN and brute-force queries/s and their ratio (no gate),
   the same over HTTP through `ServingServer` and the
   `serving_embedding_*` series on /metrics. 20c: DeepWalk at
   BlogCatalog's size (a planted-partition graph of 10,312 vertices,
   333,983 edges and 39 groups from numpy seed 0; d 128, walks of 40,
   HS through the engine; cut from the paper: window 5, one walk per
   vertex): walk tokens/s, same-group cosine above cross-group. 20d:
   ParagraphVectors DBOW (negative 5, layer 128, one epoch) on the
   sub-corpus with each sentence labelled by its topic: nearest_labels
   top-1 on 200 held-out sentences at least 0.90 (chance 0.05), one HS
   infer_vector finite. 20e: GloVe (layer 100, window 15, x_max 100,
   alpha 0.75, batch 4096, lr 0.05, 5 epochs, cut from 25) on the
   sub-corpus: the loss falls epoch over epoch, separation above 0,
   triples/s and the host's co-occurrence seconds. The phase launches
   K13 exactly 531 times (20a's host-path model) and no other kernel.

After phases 3-20, no attention call on the card may have taken the
dense path for a head dim no flash kernel takes (`DENSE_ROUTES`).

The last lines are a `{"kernels": [...]}` JSON line (K1-K13; K12 at
[4, 10000] with top_k 8 and top_p 0.9, the replay's [8, 128] and the
temperature-only mode beside it), the
card's name and power limit as nvidia-smi gives them, and `{"ok": true,
"device": ...}`. With no CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

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


def flash_bound_ms(BH, T, D, elem_bytes, causal, masked, peak_flops,
                   mask_rows=None):
    """Least time for the function: q, k, v read and o written once (lse
    written, the key mask read: `mask_rows` rows of T, default one a
    head) over the memory rate, against the function's own operations
    over the peak rate: QK^T and PV over the T(T+1)/2 visible (query,
    key) pairs when causal, all T^2 otherwise, 2D each. Returns (ms,
    what bounds it, the FLOPs counted)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = BH * pairs * D * 4
    rows = BH if mask_rows is None else mask_rows
    nbytes = (BH * T * D * elem_bytes * 4 + BH * T * 4
              + (rows * T * 4 if masked else 0))
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


# the dropout arm of the flash kernels: rate and step seed, and the
# cases hashed at a nonzero window origin (q_origin, k_origin, hash_t),
# as the chunked tier's tile (2, 1) of T = 16384 in tiles of 4096 is
DROP_RATE = 0.1
DROP_SEED = 1234567
DROP_ORIGINS = {"flat masked causal BH=8 T=4096 D=128": (8192, 4096, 16384),
                "flat masked BH=8 T=4096 D=128": (8192, 4096, 16384)}
# integer operations of the keep decision an element (csrc/dropout.cuh:
# an add, two multiplies, two shifts, two xors and a compare), on the
# CUDA cores (67e12 operations/s, the f32 row of the peaks)
HASH_OPS = 8
PEAK_CUDA_CORE_OPS = 67e12


def with_hash_bound(bound_ms, bound_by, elements):
    """A flash bound with the dropout arm's keep hash: the larger of the
    no-dropout bound and the hash's operations on the CUDA cores, which
    run beside the tensor cores."""
    t_hash = elements * HASH_OPS / PEAK_CUDA_CORE_OPS * 1e3
    return (bound_ms, bound_by) if bound_ms >= t_hash else (t_hash,
                                                            "operations")


def drop_for(torch, fa, label, T, dev):
    """The phase's `_Drop` for a case: DROP_SEED as a device int32,
    DROP_RATE, and the window of DROP_ORIGINS or origin 0."""
    qo, ko, ht = DROP_ORIGINS.get(label, (0, 0, T))
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    return fa._Drop(seed, DROP_RATE, qo, ko, ht)


# a ptxas spill line, and the name of a kernel that must not spill,
# demangled or mangled: the tensor-core kernels (namespaces tcf, tcx),
# K10's and K11's vector kernels and K11's column sum (lnv) and K12
# (smp)
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
TC_KERNEL = re.compile(r"\b(?:tc[fx]|lnv|smp)::|\d(?:tc[fx]|lnv|smp)\d")


def build_report(out):
    """`-Xptxas -v` output condensed to one line per kernel: its
    (demangled where c++filt is found) name, registers, shared memory
    and spills."""
    lines, name = [], None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif name and ("registers" in line or "spill" in line):
            lines.append((name, line.split(":", 1)[-1].strip()))
    names = sorted({n for n, _ in lines})
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   timeout=60).stdout.splitlines()
        pretty = dict(zip(names, demangled))
    except (OSError, subprocess.SubprocessError):
        pretty = {}
    return [f"{pretty.get(n, n)}: {info}" for n, info in lines]


# ------------------------------------------------------------- phase 2

def check_kernels(torch, fa, card):
    """Each case in both dtypes, without and with dropout (DROP_RATE,
    DROP_SEED; one case at a nonzero window origin): the kernel against
    the plain version on the same inputs; then, in bf16 (the serving and
    training dtype), a second run that must repeat bit for bit (the
    forward has no atomics) and the timings: CUDA-event time of the
    kernel, the plain version and SDPA (with dropout_p for the dropout
    arm), the device time per launch of the kernel and of SDPA, and the
    achieved rate on the device time. Returns per-kernel lists of records
    for the kernels line (the dropout arm's under "dropout")."""
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
    drop_worst = {}
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
    # packed with the predict batcher's key padding mask (phase 18: a
    # bucket (4, 512) batch whose padding row is all masked), and K3 at
    # the same masking
    cases += [("K2", "packed masked B=4 T=512 H=2 D=128",
               dict(B=4, T=512, H=2, D=128, masked=True)),
              ("K3", "packed masked B=8 T=512 H=4 D=64",
               dict(B=8, T=512, H=4, D=64, masked=True))]
    # head dims 32 and 256 (fault C1), and B*H past the 65535 blocks of a
    # grid's y dimension
    cases += [("K1", "flat masked causal BH=16 T=1024 D=32",
               dict(BH=16, T=1024, D=32, masked=True)),
              ("K1", "flat masked causal BH=4 T=1024 D=256",
               dict(BH=4, T=1024, D=256, masked=True)),
              ("K2", "packed B=8 T=512 H=2 D=256",
               dict(B=8, T=512, H=2, D=256)),
              ("K1", "flat unmasked causal BH=65600 T=64 D=32",
               dict(BH=65600, T=64, D=32, masked=False))]

    for kern, label, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            D, T = c["D"], c["T"]
            scale = D ** -0.5
            drop = drop_for(torch, fa, label, T, dev)
            if kern == "K1":
                BH = c["BH"]
                q, k, v = (rand(BH, T, D).to(dtype) for _ in range(3))
                km = ragged_mask(BH, T) if c["masked"] else None
                km3 = None if km is None else km[:, None, :]
                fwd = lambda: fa.flash_attention_lse_masked(  # noqa: E731
                    q, k, v, km3, scale, True)
                o, lse = fwd()
                ro, rlse = fa._flash_fwd_reference(q, k, v, km, scale, True)
                run = fwd
                plain = lambda: fa._flash_fwd_reference(  # noqa: E731
                    q, k, v, km, scale, True)
                # SDPA on [2, BH/2, T, D] views: no grid dimension of its
                # kernels then meets B*H = 65600
                q4, k4, v4 = (t.view(2, BH // 2, T, D) for t in (q, k, v))
                if km is None:
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q4, k4, v4, is_causal=True)
                else:
                    allowed = torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()[None] \
                        & (km[:, None, :] > 0)
                    allowed = allowed.view(2, BH // 2, T, T)
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q4, k4, v4, attn_mask=allowed)
                fwd_d = lambda: fa._flash_fwd(  # noqa: E731
                    q, k, v, km3, scale, True, drop)
                plain_d = lambda: fa._flash_fwd_reference(  # noqa: E731
                    q, k, v, km, scale, True, drop)
                sdpa_kw = (dict(is_causal=True) if km is None
                           else dict(attn_mask=allowed))
                lib_d = lambda: F.scaled_dot_product_attention(  # noqa
                    q4, k4, v4, dropout_p=DROP_RATE, **sdpa_kw)
                bh, masked = BH, km is not None
            else:
                B, H = c["B"], c["H"]
                n = H * D
                qkv = rand(B, T, 3 * n).to(dtype)
                km = ragged_mask(B, T) if c.get("masked") else None
                km3 = None if km is None else km[:, None, :]
                fwd = lambda: fa._flash_fwd_qkv(  # noqa: E731
                    qkv, H, km3, scale, True)
                o, lse = fwd()
                ro, rlse = fa._flash_fwd_qkv_reference(qkv, H, km, scale,
                                                       True)
                run = lambda: fa.flash_attention_qkv(  # noqa: E731
                    qkv, H, mask=km)
                plain = lambda: fa._flash_fwd_qkv_reference(  # noqa: E731
                    qkv, H, km, scale, True)
                qh, kh, vh = (t.unflatten(-1, (H, D)).transpose(1, 2)
                              for t in qkv.split(n, dim=-1))
                if km is None:
                    sdpa_kw = dict(is_causal=True)
                else:
                    sdpa_kw = dict(attn_mask=torch.ones(
                        T, T, dtype=torch.bool, device=dev).tril()[None, None]
                        & (km[:, None, None, :] > 0))
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, **sdpa_kw)
                fwd_d = lambda: fa._flash_fwd_qkv(  # noqa: E731
                    qkv, H, km3, scale, True, drop)
                plain_d = lambda: fa._flash_fwd_qkv_reference(  # noqa: E731
                    qkv, H, km, scale, True, drop)
                lib_d = lambda: F.scaled_dot_product_attention(  # noqa
                    qh, kh, vh, dropout_p=DROP_RATE, **sdpa_kw)
                bh, masked = B * H, km is not None
            torch.cuda.synchronize()
            err_o = float((o.float() - ro.float()).abs().max())
            err_l = float((lse - rlse).abs().max())
            tol = TOL[dname]
            ok = (err_o <= tol["o"] and err_l <= tol["lse"]
                  and bool(torch.isfinite(o.float()).all()))
            if km is not None:
                # the all-zero mask row (the last sequence): o = 0, lse at
                # the -1e20 floor, for each of its heads
                ok = ok and bool((o[-1] == 0).all()) \
                    and float(lse[-1].max()) < -1e19
            log(f"check {kern} {label} {dname}: max|o-plain|={err_o:.3e} "
                f"max|lse-plain|={err_l:.3e} tol o<={tol['o']} "
                f"lse<={tol['lse']} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(2, f"{kern} {label} {dname} disagrees "
                                     "with its plain version")
            od, lsed = fwd_d()
            rod, rlsed = plain_d()
            torch.cuda.synchronize()
            err_od = float((od.float() - rod.float()).abs().max())
            err_ld = float((lsed - rlsed).abs().max())
            drop_worst[kern] = max(drop_worst.get(kern, 0.0), err_od)
            okd = (err_od <= tol["o"] and err_ld <= tol["lse"]
                   and bool(torch.isfinite(od.float()).all()))
            if km is not None:
                okd = okd and bool((od[-1] == 0).all())
            log(f"check {kern} {label} {dname} dropout {DROP_RATE} "
                f"(origin {drop.q_origin}, {drop.k_origin}; hash_t "
                f"{drop.hash_t}): max|o-plain|={err_od:.3e} "
                f"max|lse-plain|={err_ld:.3e} -> {'ok' if okd else 'FAIL'}")
            if not okd:
                raise PhaseFailed(2, f"{kern} {label} {dname} dropout "
                                     "disagrees with its plain version")
            if dtype is not torch.bfloat16:
                continue
            same = same_bits(torch, (o, lse), fwd())
            log(f"check {kern} {label} bf16: a second run is "
                f"{'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise PhaseFailed(2, f"{kern} {label}: two runs differ")
            ms = time_ms(torch, run)
            dev_ms = kernel_device_ms(torch, run)
            plain_ms = time_ms(torch, plain)
            lib_ms = time_ms(torch, lib)
            lib_dev_ms = kernel_device_ms(torch, lib)
            bound_ms, bound_by, flops = flash_bound_ms(
                bh, T, D, 2, True, masked, PEAK_BF16_FLOPS,
                mask_rows=None if kern == "K1" else c["B"])
            log(f"time  {kern} {label} bf16: kernel {ms:.4f} ms (device "
                f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)}), bound "
                f"{bound_ms:.5f} ms ({bound_by}); "
                f"{rate_on(flops, ms, dev_ms, bound_ms, card)}")
            records[kern].append(dict(
                label=label, err=err_o, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                dropout=drop_arm_record(
                    torch, kern, label, (od, lsed), fwd_d, plain_d, lib_d,
                    dev_ms, with_hash_bound(bound_ms, bound_by,
                                            bh * T * (T + 1) // 2),
                    flops, card)))
    for kern, recs in records.items():
        for rec in recs:
            rec["dropout"]["err"] = drop_worst[kern]
    return records


def drop_arm_record(torch, kern, label, first, run, plain, lib, dev_ms,
                    bound, flops, card, what="fwd"):
    """The dropout arm of a bf16 case: a second run must repeat `first`
    bit for bit; then the CUDA-event and device times of the kernel, of
    the plain version and of the library call with dropout, logged
    beside the no-dropout arm's device time `dev_ms`. Returns the
    record."""
    again = run()
    again = list(again) if isinstance(again, (tuple, list)) else [again]
    first = list(first) if isinstance(first, (tuple, list)) else [first]
    same = same_bits(torch, first, again)
    log(f"check {kern} {what} {label} bf16 dropout: a second run is "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise PhaseFailed(2 if what == "fwd" else "2b",
                          f"{kern} {label} dropout: two runs differ")
    ms = time_ms(torch, run)
    dev = kernel_device_ms(torch, run)
    plain_ms = time_ms(torch, plain)
    lib_ms = time_ms(torch, lib)
    lib_dev = kernel_device_ms(torch, lib)
    bound_ms, bound_by = bound
    ratio = (f"{dev / dev_ms:.3f}x the no-dropout arm's device time"
             if dev and dev_ms else "ratio not measured")
    log(f"time  {kern} {what} {label} bf16 dropout {DROP_RATE}: kernel "
        f"{ms:.4f} ms (device {fmt_ms(dev)}; {ratio}), plain "
        f"{plain_ms:.4f} ms, sdpa dropout_p={DROP_RATE} {lib_ms:.4f} ms "
        f"(device {fmt_ms(lib_dev)}), bound {bound_ms:.5f} ms "
        f"({bound_by}); {rate_on(flops, ms, dev, bound_ms, card)}")
    return dict(label=label, ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev,
                bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------------------ phase 2b

# kernel vs plain version for the training kernels, relative to the
# largest |plain| entry. f32: the same f32 math summed in another order
# -> 1e-4. bf16: both read the same bf16 inputs and compute in f32; the
# gradients are rounded to bf16 once at the end, which is up to one bf16
# ulp (2^-8 = 3.9e-3 of the value) -> 2e-2.
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K8's loss and lse are f32 in both kernel and plain version, from f32
# products of the same operands (a bf16 product is exact in f32) and f32
# softmax math, summed in another order -> 1e-4 in both dtypes. bf16's
# 2e-2 would pass a kernel that dropped the bias (0.01 x randn here,
# about 5e-3 of the largest loss).
XENT_FWD_TOL = 1e-4


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


def flash_bwd_bound_ms(BH, T, D, elem_bytes, masked, B, causal=True):
    """Least time for the backward function: q, k, v, o, do read and dq,
    dk, dv written once (lse read; the key mask read) over the memory
    rate, against its five T x T x D products (s, dp, dv, dk, dq over
    the T(T+1)/2 visible (query, key) pairs when causal, all T^2
    otherwise, 2D each) over the bf16 peak. Returns (ms, what bounds it,
    the FLOPs counted)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = BH * pairs * D * 2 * 5
    nbytes = BH * T * D * elem_bytes * 8 + BH * T * 4 + (B * T * 4
                                                          if masked else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def rate_note(flops, ms, bound_ms, card):
    """The achieved rate of a timed kernel (the bound's own FLOP count
    over its time) and its roofline share (bound over time), against the
    published peaks, with the card's name and power limit."""
    return (f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved, roofline "
            f"share {bound_ms / ms:.4f} (against "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s and "
            f"{PEAK_BYTES / 1e12:.2f} TB/s; {card})")


def rate_on(flops, ms, dev_ms, bound_ms, card):
    """`rate_note` on the device time per launch where the profiler gave
    one, else on the CUDA-event time, saying which."""
    on = "device" if dev_ms else "event"
    return f"on the {on} time: " + rate_note(flops, dev_ms or ms, bound_ms,
                                              card)


def same_bits(torch, first, second):
    """Whether two runs' outputs (sequences of tensors) agree bit for
    bit."""
    ints = {2: torch.int16, 4: torch.int32}
    return all(a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))
        for a, b in zip(first, second))


def check_flash_backward(torch, fa, card):
    """The backward kernel (csrc/flash_bwd.cu) through its K4-K7
    wrappers against `_flash_bwd_reference` on the same inputs, f32 and
    bf16, without and with dropout (DROP_RATE, DROP_SEED; one case at a
    nonzero window origin) and, on the flat layout (K4, K5), with an lse
    cotangent (dlse); o and lse come from the plain forward. bf16 cases
    run twice and must agree bit for bit (the dq pass recomputes instead
    of adding with atomics), and are timed against the backward of
    scaled_dot_product_attention (with dropout_p for the dropout
    arm)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 10)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # the flagship (K6) and D = 64 (K7) training batches; the flat route
    # at T = 512 (batch 32 x 3 heads of 64, K4) and long context (batch 4
    # x 2 heads, T = 4096, K5), masked with one all-masked row; K4 at
    # D = 128 and K5 at T = 2048 besides
    # head dims 32 and 256 (fault C1) on both layouts, and B*H past the
    # 65535 blocks of a grid's y dimension
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
                                                           D=128)),
             ("K5", "flat masked BH=16 T=1024 D=32", dict(BH=16, T=1024,
                                                           D=32)),
             ("K5", "flat masked BH=4 T=1024 D=256", dict(BH=4, T=1024,
                                                           D=256)),
             ("K6", "packed B=8 T=512 H=2 D=256", dict(B=8, T=512, H=2,
                                                        D=256)),
             ("K4", "flat masked BH=65600 T=64 D=32", dict(BH=65600, T=64,
                                                            D=32))]
    records, worst, worst_d, worst_l = {}, {}, {}, {}
    for kern, label, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            T, D = c["T"], c["D"]
            scale = D ** -0.5
            drop = drop_for(torch, fa, label, T, dev)
            arms = {}  # name: (grads, refs, run, plain, lib out)
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
                od, lsed = fa._flash_fwd_qkv_reference(qkv, H, None, scale,
                                                       True, drop)
                run_d = lambda: fa._flash_bwd_qkv(  # noqa: E731
                    qkv, od, lsed, do, H, None, scale, True, drop)
                plain_d = lambda: fa._flash_bwd_qkv_reference(  # noqa
                    qkv, od, lsed, do, H, None, scale, True, drop)
                arms["dropout"] = ([run_d()], [plain_d()], run_d, plain_d,
                                   F.scaled_dot_product_attention(
                                       lib_q, lib_k, lib_v, is_causal=True,
                                       dropout_p=DROP_RATE))
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
                # SDPA on [2, BH/2, T, D] copies (see phase 2)
                lib_q, lib_k, lib_v = (
                    t.view(2, BH // 2, T, D).clone().requires_grad_()
                    for t in (q, k, v))
                allowed = (torch.ones(T, T, dtype=torch.bool, device=dev)
                           .tril()[None] & (km[:, None, :] > 0))
                lib_out = F.scaled_dot_product_attention(
                    lib_q, lib_k, lib_v,
                    attn_mask=allowed.view(2, BH // 2, T, T))
                lib_do = do.view(2, BH // 2, T, D)
                bh, masked, nb = BH, True, BH
                od, lsed = fa._flash_fwd_reference(q, k, v, km, scale, True,
                                                   drop)
                run_d = lambda: fa._flash_bwd_impl(  # noqa: E731
                    q, k, v, od, lsed, do, km3, scale, True, drop=drop)
                plain_d = lambda: fa._flash_bwd_reference(  # noqa: E731
                    q, k, v, od, lsed, do, km, scale, True, drop=drop)
                arms["dropout"] = (
                    list(run_d()), list(plain_d()), run_d, plain_d,
                    F.scaled_dot_product_attention(
                        lib_q, lib_k, lib_v, dropout_p=DROP_RATE,
                        attn_mask=allowed.view(2, BH // 2, T, T)))
                dl = rand(BH, T)
                run_l = lambda: fa._flash_bwd_impl(  # noqa: E731
                    q, k, v, o, lse, do, km3, scale, True, dlse=dl)
                plain_l = lambda: fa._flash_bwd_reference(  # noqa: E731
                    q, k, v, o, lse, do, km, scale, True, dlse=dl)
                arms["dlse"] = (list(run_l()), list(plain_l()), run_l,
                                plain_l, None)
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
            for arm, (a_grads, a_refs, *_rest) in arms.items():
                torch.cuda.synchronize()
                a_abs, a_err = (max(e) for e in zip(
                    *(errs(g, r) for g, r in zip(a_grads, a_refs))))
                table = worst_d if arm == "dropout" else worst_l
                table[kern] = max(table.get(kern, 0.0), a_abs)
                a_ok = a_err <= REL_TOL[dname] and all(
                    bool(torch.isfinite(g.float()).all()) for g in a_grads)
                if masked:
                    a_ok = a_ok and all(bool((g[-1] == 0).all())
                                        for g in a_grads)
                log(f"check {kern} flash bwd {label} {dname} {arm}"
                    + (f" {DROP_RATE} (origin {drop.q_origin}, "
                       f"{drop.k_origin}; hash_t {drop.hash_t})"
                       if arm == "dropout" else "")
                    + f": max rel err {a_err:.3e} -> "
                    f"{'ok' if a_ok else 'FAIL'}")
                if not a_ok:
                    raise PhaseFailed("2b", f"{kern} {label} {dname} {arm} "
                                            "disagrees with its plain "
                                            "version")
            if dtype is not torch.bfloat16:
                continue
            again = run()
            again = list(again) if isinstance(again, tuple) else [again]
            same = same_bits(torch, grads, again)
            log(f"check {kern} flash bwd {label} bf16: a second run is "
                f"{'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise PhaseFailed("2b", f"{kern} {label}: two runs differ")
            ms = time_ms(torch, run)
            names = []
            dev_ms = kernel_device_ms(torch, run, names=names)
            names = sorted({short_name(k) for k in names})
            # bf16 runs on the tensor cores at every head dim: the delta
            # pass and tcf:: kernels only, no scalar pair
            if not names or not all("tcf::" in k or "delta_kernel" in k
                                    for k in names):
                raise PhaseFailed("2b", f"{kern} {label} bf16 launched "
                                        f"{names}")
            plain_ms = time_ms(torch, plain)
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                lib_out, (lib_q, lib_k, lib_v), lib_do, retain_graph=True)
            lib_ms = time_ms(torch, lib_bwd)
            lib_dev_ms = kernel_device_ms(torch, lib_bwd)
            bound_ms, bound_by, flops = flash_bwd_bound_ms(bh, T, D, 2,
                                                           masked, nb)
            log(f"time  {kern} flash bwd {label} bf16 "
                f"({', '.join(names)}): kernel "
                f"{ms:.4f} ms "
                f"(device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa "
                f"bwd {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)}), bound "
                f"{bound_ms:.5f} ms ({bound_by}); "
                f"{rate_on(flops, ms, dev_ms, bound_ms, card)}")
            rec = dict(label=label, ms=ms, device_ms=dev_ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            a_grads, _, run_d, plain_d, lib_out_d = arms["dropout"]
            rec["dropout"] = drop_arm_record(
                torch, kern, label, a_grads, run_d, plain_d,
                lambda: torch.autograd.grad(
                    lib_out_d, (lib_q, lib_k, lib_v), lib_do,
                    retain_graph=True),
                dev_ms, with_hash_bound(bound_ms, bound_by,
                                        bh * T * (T + 1) // 2),
                flops, card, what="flash bwd")
            if "dlse" in arms:
                l_grads, _, run_l, _, _ = arms["dlse"]
                again = list(run_l())
                same = same_bits(torch, l_grads, again)
                l_dev = kernel_device_ms(torch, run_l)
                log(f"check {kern} flash bwd {label} bf16 dlse: a second "
                    f"run is {'bit-identical' if same else 'DIFFERENT'}; "
                    f"device {fmt_ms(l_dev)} (no dlse {fmt_ms(dev_ms)})")
                if not same:
                    raise PhaseFailed("2b", f"{kern} {label} dlse: two runs "
                                            "differ")
                rec["dlse"] = dict(label=label, device_ms=l_dev)
            records.setdefault(kern, []).append(rec)
    for kern, recs in records.items():
        for rec in recs:
            rec["err"] = worst[kern]
            rec["dropout"]["err"] = worst_d[kern]
            if "dlse" in rec:
                rec["dlse"]["err"] = worst_l[kern]
    return records


# ------------------------------------------------------------ phase 2c

# the chunked tier against a plain computation: at T = 16384 (B = 1, H =
# 2, D = 128) the kernels run tiles of 8192 (pick_chunk) and 4096; the
# plain version forms 1024-row query blocks with the port's torch keep
# mask. f32: the same f32 math in another order, merged tile by tile ->
# 1e-4 of the largest entry; bf16: REL_TOL, the tiles' o rounded to bf16
# before their merge.
CHUNK_T = 16384
CHUNK_ROWS = 1024


def plain_attention_blocks(torch, fa, q, k, v, mask, drop, do):
    """Causal attention over [BH, T, D] and its gradients for the output
    cotangent `do`, written out in CHUNK_ROWS-row query blocks (f32 math,
    the operands' rounding points of `_flash_fwd_reference` and
    `_flash_bwd_reference`): returns (o, dq, dk, dv). mask: [BH, T] or
    None; drop: a `_Drop` (origin 0, hash_t T) or None."""
    BH, T, D = q.shape
    scale = D ** -0.5
    dev = q.device
    o = torch.empty_like(q)
    dq = torch.empty_like(q)
    dk = torch.zeros(BH, T, D, device=dev)
    dv = torch.zeros(BH, T, D, device=dev)
    bh = torch.arange(BH, device=dev)
    for r0 in range(0, T, CHUNK_ROWS):
        r1 = r0 + CHUNK_ROWS
        qi, gi = q[:, r0:r1].float(), do[:, r0:r1].float()
        kk, vv = k[:, :r1].float(), v[:, :r1].float()
        s = scale * (qi @ kk.transpose(-1, -2))
        vis = (torch.arange(r1, device=dev)[None, :]
               <= torch.arange(r0, r1, device=dev)[:, None])[None]
        if mask is not None:
            vis = vis & (mask[:, None, :r1] > 0)
        s = s.masked_fill(~vis, fa.NEG_INF)
        m = s.amax(-1)
        if mask is not None:
            m = m.clamp_min(-1e20)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1).clamp_min(1e-30)
        ks = (torch.ones_like(p) if drop is None else
              fa._keep_mask(drop.seed, bh, r0, 0, CHUNK_ROWS, r1, T,
                            drop.rate).float() * fa.keep_scale(drop.rate))
        oi = ((p * ks).to(q.dtype).float() @ vv) / l[..., None]
        o[:, r0:r1] = oi.to(q.dtype)
        lse = m + torch.log(l)
        p = torch.exp(s - lse[..., None])
        delta = (gi * o[:, r0:r1].float()).sum(-1)
        dp = (gi @ vv.transpose(-1, -2)) * ks
        ds = p * (dp - delta[..., None]) * scale
        dsr = ds.to(q.dtype).float()
        dq[:, r0:r1] = (dsr @ kk).to(q.dtype)
        dk[:, :r1] += dsr.transpose(-1, -2) @ qi
        dv[:, :r1] += (p * ks).to(q.dtype).float().transpose(-1, -2) @ gi
    return o, dq, dk.to(q.dtype), dv.to(q.dtype)


def check_chunked(torch, fa, card):
    """`chunked_flash_attention` at T = 16384 (B = 1, H = 2, D = 128), f32
    and bf16, without and with the padding mask and dropout: forward and
    gradients against `plain_attention_blocks` on the card, and tiles of
    4096 against tiles of 8192 (the keep mask must not depend on the
    tiling). Returns the largest gradient error a dtype."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 30)
    B, H, T, D = 1, 2, CHUNK_T, 128
    assert fa.pick_chunk(T, True, head_dim=D) == 8192
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = 1e-4 if dtype == torch.float32 else REL_TOL[dname]
        q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(dev, dtype)
                       for _ in range(4))
        mask = torch.ones(B, T, device=dev)
        mask[:, T - T // 5:] = 0  # the last fifth of the keys padded
        for masked, dropout in ((False, False), (True, False), (False, True),
                                (True, True)):
            mk = mask if masked else None
            outs = []
            chunks = (8192, 4096)
            for chunk in chunks:
                ts = [t.clone().requires_grad_() for t in (q, k, v)]
                gen_d = torch.Generator(device=dev).manual_seed(SEED)
                counts = dict(fa.LAUNCHES)
                out = fa.chunked_flash_attention(
                    *ts, mask=mk, chunk=chunk,
                    dropout=DROP_RATE if dropout else 0.0, generator=gen_d)
                out.backward(do)
                torch.cuda.synchronize()
                n = T // chunk
                want = n * (n + 1) // 2
                if (fa.LAUNCHES["K1"] - counts["K1"] != want
                        or fa.LAUNCHES["K5"] - counts["K5"] != want):
                    raise PhaseFailed("2c", f"chunk {chunk}: K1/K5 "
                                            f"launched other than {want}x")
                outs.append([out.detach()] + [t.grad for t in ts])
            seed = fa._step_seed(torch.Generator(device=dev).manual_seed(
                SEED))
            drop = fa._Drop(seed, DROP_RATE, 0, 0, T) if dropout else None
            flat = [t.reshape(B * H, T, D) for t in (q, k, v, do)]
            refs = plain_attention_blocks(
                torch, fa, *flat[:3],
                None if mk is None else mk.repeat_interleave(H, 0), drop,
                flat[3])
            err = max(errs(g.reshape(B * H, T, D), r)[1]
                      for g, r in zip(outs[0], refs))
            inv = max(errs(a, b)[1] for a, b in zip(outs[1], outs[0]))
            worst[dname] = max(worst.get(dname, 0.0), err)
            ok = (err <= tol and inv <= tol
                  and all(bool(torch.isfinite(g.float()).all())
                          for g in outs[0]))
            log(f"check chunked T={T} BH={B * H} D={D} {dname} "
                f"masked={masked} dropout={DROP_RATE if dropout else 0}: "
                f"o and dq/dk/dv against the plain {CHUNK_ROWS}-row blocks "
                f"max rel err {err:.3e}, tiles of {chunks[1]} against "
                f"{chunks[0]} {inv:.3e} (tol {tol}) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed("2c", f"chunked {dname} masked={masked} "
                                        f"dropout={dropout} disagrees")
    # the tiles of the long modes at their shape (BH = 16, c = 8192,
    # D = 128, bf16, the key mask): the diagonal tile (causal) and a full
    # one, without and with dropout at the tile's origin in T = 32768.
    # Timed by CUDA events: at a millisecond a launch the host's launch
    # path is noise, and the profiler's sum over a few launches of these
    # long kernels read low (less than half of the events' time on an
    # H100)
    BH, c = 16, 8192
    scale = D ** -0.5
    q, k, v, do = (torch.randn(BH, c, D, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    km3 = torch.ones(BH, 1, c, device=dev)
    dl = torch.randn(BH, c, generator=gen).to(dev)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    for causal, origin in ((True, (16384, 16384)), (False, (24576, 8192))):
        times = {}
        for dropping in (False, True):
            drop = (fa._Drop(seed, DROP_RATE, *origin, 4 * c) if dropping
                    else None)
            o, lse = fa._flash_fwd(q, k, v, km3, scale, causal, drop)
            times[dropping] = tuple(
                time_ms(torch, fn, windows=3, per_window=5) for fn in (
                    lambda: fa._flash_fwd(q, k, v, km3, scale, causal, drop),
                    lambda: fa._flash_bwd_impl(q, k, v, o, lse, do, km3,
                                               scale, causal, dl, drop)))
        pairs = c * (c + 1) // 2 if causal else c * c
        fb = flash_bound_ms(BH, c, D, 2, causal, True, PEAK_BF16_FLOPS)[:2]
        bb = flash_bwd_bound_ms(BH, c, D, 2, True, BH, causal)[:2]
        fbd = with_hash_bound(*fb, BH * pairs)
        bbd = with_hash_bound(*bb, BH * pairs)
        log(f"time  chunk tile BH={BH} c={c} D={D} bf16 masked "
            f"{'diagonal (causal)' if causal else 'full'} (CUDA events): K1 "
            f"{fmt_ms(times[False][0])}, with dropout "
            f"{fmt_ms(times[True][0])} (bound {fb[0]:.5f} ms {fb[1]}, "
            f"{fbd[0]:.5f} with the hash); K5 with dlse "
            f"{fmt_ms(times[False][1])}, with dropout "
            f"{fmt_ms(times[True][1])} (bound {bb[0]:.5f} ms {bb[1]}, "
            f"{bbd[0]:.5f} with the hash); card {card}")
    return worst


def xent_bound_ms(N, d, V, elem_bytes, backward):
    """Least time for the head's function. Forward: x, W, b, labels read
    and loss, lse written once, against 2*N*d*V FLOPs (the logits).
    Backward: x, W, b, labels, lse, g read and dx, dW, db written once,
    against 6*N*d*V FLOPs (the logits once, then G @ W^T and x^T @ G).
    Returns (ms, what bounds it, the FLOPs counted)."""
    nbytes = (N * d + d * V + V) * elem_bytes + N * 4
    if backward:
        nbytes += N * 8 + (N * d + d * V) * elem_bytes + V * 4
        flops = 6 * N * d * V
    else:
        nbytes += N * 8
        flops = 2 * N * d * V
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def check_xent(torch, fsx, card):
    """K8 and K9 (csrc/softmax_xent.cu) against `_xent_fwd_reference`
    and `_xent_bwd_reference` at the flagship head (N = 32 x 512 tokens,
    d = 256, V = 10000) and at a ragged N = 300, V = 2100, in f32 and
    bf16. bf16 forward and backward run twice and must agree bit for bit
    (no atomics; dW's slices of N are summed in a fixed order). The
    flagship bf16 case is timed against F.cross_entropy on x @ W + b
    (forward, and its backward through autograd), by CUDA events and by
    device time a launch."""
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
            ok = (err_f <= XENT_FWD_TOL and err_b <= REL_TOL[dname]
                  and bool(torch.isfinite(loss).all()))
            log(f"check K8/K9 xent {label} {dname}: max rel err loss/lse "
                f"{err_f:.3e} (tol {XENT_FWD_TOL}), dx/dW/db {err_b:.3e} "
                f"(tol {REL_TOL[dname]}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed("2b", f"K8/K9 {label} {dname} disagrees "
                                        "with its plain version")
            if dtype is not torch.bfloat16:
                continue
            for kern, first, again in (
                    ("K8", (loss, lse), fsx._fused_fwd(x, w, b, labels)),
                    ("K9", grads, fsx._fused_bwd(x, w, b, labels, rlse,
                                                 g))):
                same = same_bits(torch, first, again)
                log(f"check {kern} xent {label} bf16: a second run is "
                    f"{'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    raise PhaseFailed("2b", f"{kern} {label}: two runs "
                                            "differ")
            if N != 16384:
                continue
            lab64 = labels.long()
            lx, lw, lb = (t.clone().requires_grad_() for t in (x, w, b))
            lib_loss = F.cross_entropy(lx @ lw + lb, lab64, reduction="none")
            fns = {
                "K8": (lambda: fsx._fused_fwd(x, w, b, labels),
                       lambda: fsx._xent_fwd_reference(x, w, b, labels),
                       lambda: F.cross_entropy(x @ w + b, lab64,
                                               reduction="none")),
                "K9": (lambda: fsx._fused_bwd(x, w, b, labels, rlse, g),
                       lambda: fsx._xent_bwd_reference(x, w, b, labels,
                                                       rlse, g),
                       lambda: torch.autograd.grad(
                           lib_loss, (lx, lw, lb), g, retain_graph=True))}
            for kern, (run, plain, lib) in fns.items():
                backward = kern == "K9"
                win = dict(windows=3, per_window=5) if backward else {}
                ms, plain_ms, lib_ms = (time_ms(torch, f, **win)
                                        for f in (run, plain, lib))
                names = []
                dev_ms = kernel_device_ms(torch, run, names=names)
                names = sorted({short_name(k) for k in names})
                if not names or not all("tcx::" in k for k in names):
                    raise PhaseFailed("2b", f"{kern} bf16 launched {names}")
                lib_dev_ms = kernel_device_ms(torch, lib)
                bound_ms, bound_by, flops = xent_bound_ms(N, d, V, 2,
                                                          backward)
                log(f"time  {kern} xent {label} bf16 "
                    f"({', '.join(names)}): kernel "
                    f"{ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
                    f"{plain_ms:.4f} ms, F.cross_entropy "
                    f"{'bwd' if backward else 'fwd'} {lib_ms:.4f} ms "
                    f"(device {fmt_ms(lib_dev_ms)}), bound {bound_ms:.5f} "
                    f"ms ({bound_by}); "
                    f"{rate_on(flops, ms, dev_ms, bound_ms, card)}")
                records[kern] = [dict(label=label, ms=ms, device_ms=dev_ms,
                                      plain_ms=plain_ms, library_ms=lib_ms,
                                      library_device_ms=lib_dev_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)]
    for kern in ("K8", "K9"):
        records[kern][0]["err"] = worst[kern]
    return records


# ------------------------------------------------------------- phase 3

def serve_flagship(torch, counters, transformer_lm, GenerationEngine,
                   BucketLattice, Recorder, card):
    net = transformer_lm(**LM, dtype="bfloat16", device="cuda").init(SEED)
    rec = Recorder(path=None)
    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(64, 512,
                                                                 1024)),
                              slots=4, max_new_tokens=64, page_size=16,
                              prefill_chunk=1024, recorder=rec)
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
    (pool,) = stats["page_pools"]
    chunks = sum(1 for e in rec.events if e.get("event") == "span"
                 and e.get("name") == "prefill_chunk")
    log(f"serve: {len(reqs)} requests, {tokens} tokens in {wall:.4f} s -> "
        f"{tokens / wall:.2f} tokens/s; TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.2f} ms, max "
        f"{ttft[-1] * 1e3:.2f} ms; per-request mean token gap p50 "
        f"{statistics.median(gaps) * 1e3:.2f} ms, max "
        f"{gaps[-1] * 1e3:.2f} ms; peak KV pages {pool['pages_peak']}/"
        f"{pool['pages_total']} "
        f"({pool['pages_peak'] / pool['pages_total']:.4f}); "
        f"prefill chunks {chunks}, decode steps "
        f"{stats['fleet'][0]['decode_steps_run']}; peak device memory "
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
    ops/fused_neg_softmax.py, ops/fused_layernorm.py and
    ops/fused_sampling.py): reset() sets every one to 0, read() returns
    them."""

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
    exact launch counts; step time, tokens/s, MFU, memory, profile.
    Returns the launches and {"step_ms", "kernel_ms", "top"}: the median
    step, the kernel time of the profiled step (None when the profiler
    reports none) and its largest kernels as [name, ms, calls]."""
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
            "K12": 0, "K13": 0}
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
    busy = sum(r[0] for r in rows) / 1e6
    if rows:
        # the profiler's host cost stretches the profiled window; against
        # the unprofiled median step the same kernel time leaves this idle
        log(f"train: device idle share of the unprofiled median step "
            f"{1 - busy / step_s:.4f} (kernel time {busy * 1e3:.3f} ms of "
            f"{step_s * 1e3:.3f} ms)")
    return launches, {
        "step_ms": step_s * 1e3, "kernel_ms": busy * 1e3 if rows else None,
        "top": [[short_name(key)[:60], us / 1e3, count]
                for us, count, key in rows[:8]]}


# bench.py LM_MODE_DIMS: the three modes of this phase, at their own
# dims (6 layers, vocab 10000); steps: fit_scanned's, then the median of
# `timed` fit() calls
BENCH_MODES = {
    "dropout": dict(seq=512, batch=32, steps=TRAIN_STEPS, timed=7,
                    masked=True, attention_dropout=0.1),
    "longcontext_chunked": dict(seq=32768, batch=8, steps=2, timed=3,
                                masked=False, attention_dropout=None),
    "longcontext_chunked_dropout": dict(seq=32768, batch=8, steps=2,
                                        timed=3, masked=True,
                                        attention_dropout=0.1),
}


def train_bench_modes(torch, counters, transformer_lm, DataSet, fa,
                      flops_per_token, card):
    """The flagship's bench modes "dropout" (T = 512, masked, attention
    dropout 0.1: the packed route with the keep mask, K2/K6),
    "longcontext_chunked" and "longcontext_chunked_dropout" (T = 32768,
    batch 8: the chunked tier in tiles of 8192, 10 causal tile pairs a
    layer, K1/K5), each through fit_scanned from lm_batch with exact
    launch counts and finite losses; then the step time (the median of
    fit() calls), tokens/s, MFU, peak memory and the kernel time of one
    profiled step (MFU on `flops_per_token`, the executed causal
    FLOPs). Returns the launches summed over the modes and {mode:
    stats}."""
    from torch.profiler import ProfilerActivity, profile

    c0 = TRAIN
    totals, stats = {}, {}
    for mode, c in BENCH_MODES.items():
        S, L = c["steps"], c0["n_layers"]
        net = transformer_lm(vocab_size=c0["vocab_size"],
                             d_model=c0["d_model"], n_heads=c0["n_heads"],
                             n_layers=L, d_ff=c0["d_ff"], max_length=c["seq"],
                             attention_dropout=c["attention_dropout"],
                             dtype="bfloat16", device="cuda").init(SEED)
        ds = lm_batch(DataSet, c0["vocab_size"], c["batch"], c["seq"],
                      masked=c["masked"])
        if c["seq"] > fa.MAX_FLASH_T:
            n = c["seq"] // fa.pick_chunk(c["seq"], True,
                                          head_dim=c0["d_model"]
                                          // c0["n_heads"])
            attn = {"K1": L * S * n * (n + 1) // 2,
                    "K5": L * S * n * (n + 1) // 2}
        else:
            attn = {"K2": L * S, "K6": L * S}
        want = {**{f"K{i}": 0 for i in range(1, 14)}, "K9 dW": S, **attn,
                "K8": S, "K9": S}
        dense = fa.DENSE_ROUTES["head_dim"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        net.fit_scanned(ds, epochs=S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        losses = net._step_losses.float().flatten().cpu().tolist()
        log(f"train {mode}: fit_scanned {S} steps at batch {c['batch']} x "
            f"T={c['seq']} (masked={c['masked']}, attention dropout "
            f"{c['attention_dropout']}) in {wall:.3f} s; losses "
            f"{[round(x, 4) for x in losses]}; launches {launches}; peak "
            f"device memory {peak_mib:.1f} MiB")
        if not all(np.isfinite(losses)):
            raise PhaseFailed("6b", f"{mode}: loss not finite: {losses}")
        if launches != want:
            raise PhaseFailed("6b", f"{mode}: launches {launches}, "
                                    f"expected {want}")
        if fa.DENSE_ROUTES["head_dim"] != dense:
            raise PhaseFailed("6b", f"{mode}: an attention call took the "
                                    "dense path")
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n

        def one_step():
            torch.cuda.synchronize()
            t = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        step_s = statistics.median(one_step() for _ in range(c["timed"]))
        fpt = flops_per_token(c0["vocab_size"], c0["d_model"], L,
                              c0["d_ff"], c["seq"])
        tok_s = c["batch"] * c["seq"] / step_s
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        _, rows = device_profile(torch, prof, pwall,
                                 f"train {mode} profile (one step)", top=10)
        busy = sum(r[0] for r in rows) / 1e6
        kernel_ms = busy * 1e3 if rows else None
        log(f"train {mode}: step {step_s * 1e3:.3f} ms (host clock to "
            f"synchronize, median of {c['timed']} fit() calls) -> "
            f"{tok_s:.1f} tokens/s; executed model FLOPs per token {fpt}; "
            f"MFU {fpt * tok_s / PEAK_BF16_FLOPS:.5f} against "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; kernels of the profiled "
            f"step {fmt_ms(kernel_ms)}"
            + (f", device idle share of the median step "
               f"{1 - busy / step_s:.4f}" if rows else "")
            + f"; peak device memory {peak_mib:.1f} MiB; card {card}")
        stats[mode] = dict(step_ms=step_s * 1e3, kernel_ms=kernel_ms,
                           peak_mib=peak_mib, tokens_s=tok_s)
        del net
        torch.cuda.empty_cache()
    return totals, stats


def train_other_paths(torch, counters, transformer_lm, DataSet, fsx):
    """The other attention routes at reduced depth (2 layers, 2 steps):
    packed head_dim 64 (K3/K7), the flat route at T = 512 with an odd
    head count (K1/K4), both also with attention dropout 0.1 (the keep
    mask in the kernels), long context T = 4096 with the padding mask
    (K1/K5), and the head dims of fault C1: 8 heads of 32 (the flat
    route, K1/K4) and 2 heads of 256 (the packed route, K2/K6)."""
    # (label, config, launches each must show over 2 layers x 2 steps;
    # every other flash kernel must show none). K8/K9 launch once a step
    # where the fused head takes the shape: d_model 192 is not a multiple
    # of 128, so that run scores on the dense head; the head's `supports`
    # must agree with each run's count
    runs = [
        ("transformer_d64", dict(d_model=256, n_heads=4, seq=512, batch=32,
                                 masked=False),
         {"K3": 4, "K7": 4, "K8": 2, "K9": 2}),
        ("flat T=512 (3 heads of 64)", dict(d_model=192, n_heads=3, seq=512,
                                            batch=32, masked=False),
         {"K1": 4, "K4": 4, "K8": 0, "K9": 0}),
        ("transformer_d64 dropout", dict(d_model=256, n_heads=4, seq=512,
                                         batch=32, masked=False,
                                         attention_dropout=0.1),
         {"K3": 4, "K7": 4, "K8": 2, "K9": 2}),
        ("flat T=512 (3 heads of 64) dropout",
         dict(d_model=192, n_heads=3, seq=512, batch=32, masked=False,
              attention_dropout=0.1),
         {"K1": 4, "K4": 4, "K8": 0, "K9": 0}),
        ("longcontext masked", dict(d_model=256, n_heads=2, seq=4096,
                                    batch=4, masked=True),
         {"K1": 4, "K5": 4, "K8": 2, "K9": 2}),
        ("head dim 32 (8 heads of 32)", dict(d_model=256, n_heads=8,
                                             seq=512, batch=32,
                                             masked=False),
         {"K1": 4, "K4": 4, "K8": 2, "K9": 2}),
        ("head dim 256 (2 heads of 256)", dict(d_model=512, n_heads=2,
                                               seq=512, batch=32,
                                               masked=False),
         {"K2": 4, "K6": 4, "K8": 2, "K9": 2}),
    ]
    totals = {}
    for label, c, want in runs:
        net = transformer_lm(vocab_size=TRAIN["vocab_size"],
                             d_model=c["d_model"], n_heads=c["n_heads"],
                             n_layers=2, d_ff=TRAIN["d_ff"],
                             max_length=c["seq"],
                             attention_dropout=c.get("attention_dropout"),
                             dtype="bfloat16", device="cuda").init(SEED)
        ds = lm_batch(DataSet, TRAIN["vocab_size"], c["batch"], c["seq"],
                      masked=c["masked"])
        fused = fsx.supports(c["batch"] * c["seq"], c["d_model"],
                             TRAIN["vocab_size"])
        if fused != (want["K8"] > 0):
            raise PhaseFailed(7, f"{label}: the fused head's supports says "
                                 f"{fused}, expected {want['K8'] > 0}")
        want = {**{f"K{i}": 0 for i in range(1, 8)}, **want}
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

    def flash_attention_qkv(qkv, H, *, causal=True, mask=None, dropout=0.0,
                            generator=None):
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


def kernel_device_ms(torch, fn, calls=20, names=None, by_name=None):
    """Mean device time per call of the kernels `fn` launches (the sum
    of their times over `calls` calls, from torch.profiler), or None
    when the profiler reports no device time. At these sizes the CUDA
    event time of back-to-back calls is bounded by the host's launch
    path; this is the kernels' own time. `names`, a list, receives the
    names of the kernels that ran; `by_name`, a dict, each one's device
    ms a call under its `short_name`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window the profiler misses is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and getattr(e, "self_device_time_total", 0) > 0]
        if sum(e.count for e in events) >= calls:
            break
    if names is not None:
        names.extend(e.key for e in events)
    if by_name is not None:
        for e in events:
            key = short_name(e.key)
            by_name[key] = (by_name.get(key, 0.0)
                            + e.self_device_time_total / calls / 1e3)
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / calls / 1e3 if total_us else None


def short_name(key):
    """A profiler's kernel name without its return type, its argument
    list and the anonymous namespace."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(", 1)[0]


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
    # fault C2: c and pos two columns of one [B, 2, D] buffer and neg the
    # first K of K + 2 rows a triple, equal to the launch on contiguous
    # copies bit for bit and to the plain version within K13_TOL
    B, K, D = 2048, 5, 128
    both = (0.3 * torch.randn(B, 2, D, generator=gen)).to(dev)
    wide = (0.3 * torch.randn(B, K + 2, D, generator=gen)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        c, pos = both.to(dtype).unbind(1)
        neg = wide.to(dtype)[:, :K]
        got = fns.neg_softmax_scores(c, pos, neg)
        flat = fns.neg_softmax_scores(c.contiguous(), pos.contiguous(),
                                      neg.contiguous())
        ref = fns._neg_softmax_reference(c, pos, neg)
        torch.cuda.synchronize()
        abs_err, err = (max(e) for e in zip(
            *(errs(g, r) for g, r in zip(got, ref))))
        worst = max(worst, abs_err)
        same = same_bits(torch, got, flat)
        ok = (err <= K13_TOL[dname] and same
              and not any(t.is_contiguous() for t in (c, pos, neg)))
        log(f"check K13 neg_softmax strided B={B} K={K} D={D} {dname}: max "
            f"rel err {err:.3e} (tol {K13_TOL[dname]}), "
            f"{'equal' if same else 'NOT equal'} to the contiguous "
            f"launch bit for bit -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed(9, f"K13 on strided views {dname} disagrees")
    for rec in records:
        rec["err"] = worst
    return {"K13": records}


# K10's and K11's cases: the flagship LM's LayerNorm input (N = 32 x 512
# tokens, C = 256), its rows less one (no multiple of a block's 8 rows),
# the ragged C = 200, and x one element past a 16-byte boundary (a view
# of a flat buffer), which `_fwd_plan` and `_bwd_plan` must send to the
# general path
LN_CASES = (("flagship N=16384 C=256", 16384, 256, False),
            ("ragged rows N=16383 C=256", 16383, 256, False),
            ("ragged N=1000 C=200", 1000, 200, False),
            ("misaligned N=1000 C=256", 1000, 256, True))


def ln_host_path(torch, fln, x, g, b, eps, calls=500):
    """Host microseconds a call of each part of K10's launch path
    (`_ln_fwd` on the card), of the whole, of F.layer_norm's forward, and
    of the parts the path no longer takes (the device context, a Stream
    object, the build lock), each the mean of `calls` calls between two
    host clocks (the device queue drained before and after)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import cuda_build

    N, C = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((2, N), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr())
    fn = cuda_build.entry("layernorm", "ln_fwd", fln._FN_ARGTYPES["ln_fwd"])
    dev = x.get_device()
    args = [*ptrs, stats.data_ptr(), fln._KERNEL_DTYPES[x.dtype],
            fln._KERNEL_DTYPES[g.dtype],
            fln._fwd_plan(C, x.element_size(), ptrs), N, C, float(eps),
            cuda_build.stream_handle(dev)]

    def device_context():
        with torch.cuda.device(x.device):
            pass

    parts = {
        "checks": lambda: fln._check(x, (g, b)),
        "allocations": lambda: (torch.empty_like(x), torch.empty(
            (2, N), dtype=torch.float32, device=x.device)),
        "pointers and plan": lambda: fln._fwd_plan(C, x.element_size(), (
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr())),
        "entry lookup": lambda: cuda_build.entry(
            "layernorm", "ln_fwd", fln._FN_ARGTYPES["ln_fwd"]),
        "device and stream": lambda: (
            x.get_device() == torch.cuda.current_device(),
            cuda_build.stream_handle(dev)),
        "ctypes call and launch": lambda: fn(*args),
        "mu, rstd views": lambda: stats.unbind(0),
        "(alternative) allocations by new_empty": lambda: (
            x.new_empty((N, C)), x.new_empty((2, N), dtype=torch.float32)),
        "(alternative) views by index": lambda: (stats[0], stats[1]),
        "whole _ln_fwd": lambda: fln._ln_fwd(x, g, b, eps),
        "F.layer_norm fwd": lambda: F.layer_norm(x, (C,), g, b, eps),
        "(not taken) device context": device_context,
        "(not taken) Stream object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "(not taken) build lock": lambda: cuda_build.load("layernorm"),
    }
    out = {}
    for name, part in parts.items():
        for _ in range(20):
            part()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            part()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def check_layernorm(torch, fln):
    """K10 and K11 (csrc/layernorm.cu) through the `fused_layer_norm`
    autograd Function against `_ln_fwd_reference` / `_ln_bwd_reference`
    at LN_CASES, f32 and bf16, each run twice to repeat bit for bit,
    through the instantiations `_fwd_plan` and `_bwd_plan` must pick (the
    vector kernels at C = 256 when aligned, K11 on min(BWD_BLOCKS, N / 8)
    blocks; the general path otherwise); the flagship bf16 case timed
    against F.layer_norm forward and backward (CUDA events and device
    time, K11's by kernel), where a call may run layernorm.cu's kernels
    and no other, with the host path's parts (`ln_host_path`)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 40)
    eps = 1e-5
    records, worst = {"K10": [], "K11": []}, {"K10": 0.0, "K11": 0.0}
    for label, N, C, misaligned in LN_CASES:
        x32 = (1.5 * torch.randn(N, C, generator=gen) + 0.3).to(dev)
        g32 = (1 + 0.2 * torch.randn(C, generator=gen)).to(dev)
        b32 = (0.1 * torch.randn(C, generator=gen)).to(dev)
        dy32 = torch.randn(N, C, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, g, b, dy = (t.to(dtype) for t in (x32, g32, b32, dy32))
            if misaligned:
                x = torch.empty(N * C + 1, dtype=dtype,
                                device=dev)[1:].view(N, C).copy_(x)
            plan = fln._fwd_plan(C, x.element_size(), (
                x.data_ptr(), g.data_ptr(), b.data_ptr(),
                torch.empty_like(x).data_ptr()))
            bwd_plan = fln._bwd_plan(N, C, x.element_size(), (
                x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                torch.empty_like(x).data_ptr()))
            want_plan = 0 if misaligned or C % 128 else (
                1 if dtype is torch.bfloat16 else 2)
            # K11: 264 blocks of 8 rows, or partials of 64 rows
            want_bwd = (want_plan, min(264, -(-N // 8)) if want_plan
                        else -(-N // 64))
            runs = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_() for t in (x, g, b)]
                if misaligned:
                    leaves[0] = torch.empty(N * C + 1, dtype=dtype,
                                            device=dev)[1:].view(N, C)
                    leaves[0].copy_(x).requires_grad_()
                y = fln.fused_layer_norm(*leaves, eps=eps)
                runs.append((y.detach(),) + torch.autograd.grad(
                    y, leaves, dy))
            ry, mu, rstd = fln._ln_fwd_reference(x, g, b, eps)
            rdx, rdg, rdb = fln._ln_bwd_reference(x, g, mu, rstd, dy)
            refs = (rdx, rdg.to(dtype), rdb.to(dtype))
            torch.cuda.synchronize()
            y, grads = runs[0][0], runs[0][1:]
            abs_f, err_f = errs(y, ry)
            abs_b, err_b = (max(e) for e in zip(
                *(errs(a, r) for a, r in zip(grads, refs))))
            worst["K10"] = max(worst["K10"], abs_f)
            worst["K11"] = max(worst["K11"], abs_b)
            repeat = same_bits(torch, runs[0], runs[1])
            ok = (err_f <= LN_TOL[dname] and err_b <= LN_TOL[dname]
                  and y.dtype == dtype and plan == want_plan
                  and bwd_plan == want_bwd and repeat
                  and bool(torch.isfinite(y.float()).all()))
            bwd_kind = (f"vector nv={bwd_plan[0]}" if bwd_plan[0]
                        else "general")
            log(f"check K10/K11 layernorm {label} {dname}: K10 "
                f"{'vector nv=' + str(plan) if plan else 'general'} "
                f"kernel, K11 {bwd_kind} path with {bwd_plan[1]} "
                f"partials, max rel err y "
                f"{err_f:.3e}, dx/dgamma/dbeta {err_b:.3e} (tol "
                f"{LN_TOL[dname]}), two runs "
                f"{'equal bit for bit' if repeat else 'DIFFER'} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(9, f"K10/K11 {label} {dname} disagrees "
                                     "with its plain version, takes the "
                                     f"wrong kernel ({plan}, {bwd_plan}) or "
                                     "does not repeat")
            if dtype is not torch.bfloat16 or N != 16384:
                continue
            fwd = lambda: fln._ln_fwd(x, g, b, eps)  # noqa: E731
            bwd = lambda: fln._ln_bwd(x, g, mu, rstd, dy)  # noqa: E731
            lib_fwd = lambda: F.layer_norm(x, (C,), g, b, eps)  # noqa: E731
            lx, lg, lb = (t.clone().requires_grad_() for t in (x, g, b))
            lout = F.layer_norm(lx, (C,), lg, lb, eps)
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                lout, (lx, lg, lb), dy, retain_graph=True)
            e = 2
            # forward: x, gamma, beta read, y, mu, rstd written once,
            # about 8 FLOPs per element; backward: x, dy, gamma, mu,
            # rstd read, dx, dgamma, dbeta written once, about 12
            for kern, fn, lib, nbytes, flops in (
                    ("K10", fwd, lib_fwd,
                     2 * N * C * e + 2 * C * e + 8 * N, 8 * N * C),
                    ("K11", bwd, lib_bwd,
                     3 * N * C * e + 3 * C * e + 8 * N, 12 * N * C)):
                ms = time_ms(torch, fn)
                plain_ms = time_ms(torch, (lambda: fln._ln_fwd_reference(
                    x, g, b, eps)) if kern == "K10" else (
                    lambda: fln._ln_bwd_reference(x, g, mu, rstd, dy)))
                lib_ms = time_ms(torch, lib)
                bound_ms, bound_by = bound(nbytes, flops, dname)
                by_name = {}
                dev_ms = kernel_device_ms(torch, fn, by_name=by_name)
                lib_dev = kernel_device_ms(torch, lib)
                log(f"time  {kern} layernorm {label} bf16: kernel "
                    f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}; by kernel "
                    + ", ".join(f"{k} {v:.5f}" for k, v in
                                sorted(by_name.items()))
                    + f"), plain {plain_ms:.4f} ms, F.layer_norm "
                    f"{'bwd' if kern == 'K11' else 'fwd'} {lib_ms:.4f} ms "
                    f"(device time {fmt_ms(lib_dev)}), bound "
                    f"{bound_ms:.5f} ms ({bound_by})")
                # a call runs the planned layernorm.cu kernels and nothing
                # else (no PyTorch kernel around them)
                want = ({"lnv::bwd_vec", "lnv::colsum"} if kern == "K11"
                        else {"lnv::fwd_vec"})
                ran = {k.split("<", 1)[0] for k in by_name}
                if by_name and ran != want:
                    raise PhaseFailed(9, f"{kern} ran {sorted(by_name)}, not "
                                         f"only {sorted(want)}")
                records[kern].append(dict(
                    label=label, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, library_device_ms=lib_dev,
                    bound_ms=bound_ms, bound_by=bound_by,
                    device_ms_by_kernel=by_name))
            host = ln_host_path(torch, fln, x, g, b, eps)
            log("time  K10 host path, microseconds a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in host.items()))
            records["K10"][-1]["host_us"] = host
    for kern, err in check_layernorm_f32_params(torch, fln, gen).items():
        worst[kern] = max(worst[kern], err)
    for kern, recs in records.items():
        for rec in recs:
            rec["err"] = worst[kern]
    return records


def check_layernorm_f32_params(torch, fln, gen):
    """Fault C2: bf16 x with f32 gamma and beta (the kernels' second
    parameter type) through `fused_layer_norm` at the flagship's N =
    16384, C = 256 (both vector kernels, K11 on 264 blocks) and the
    ragged N = 1000, C = 200 (the general path), run twice to repeat bit
    for bit, against the plain versions with the f32 gamma within
    LN_TOL; dgamma and dbeta come back in f32. gamma is read in f32, not
    rounded to bf16: y differs from the plain version's in fewer
    elements than from the plain version's with gamma and beta rounded
    to bf16. Returns the largest absolute errors {"K10", "K11"}."""
    dev, eps, tol = torch.device("cuda"), 1e-5, LN_TOL["bfloat16"]
    worst = {"K10": 0.0, "K11": 0.0}
    for label, N, C in (("flagship N=16384 C=256", 16384, 256),
                        ("ragged N=1000 C=200", 1000, 200)):
        x = (1.5 * torch.randn(N, C, generator=gen) + 0.3).to(dev).bfloat16()
        g = (1 + 0.2 * torch.randn(C, generator=gen)).to(dev)
        b = (0.1 * torch.randn(C, generator=gen)).to(dev)
        dy = torch.randn(N, C, generator=gen).to(dev).bfloat16()
        out = torch.empty_like(x).data_ptr()
        plan = fln._fwd_plan(C, 2, (x.data_ptr(), g.data_ptr(),
                                    b.data_ptr(), out))
        bwd_plan = fln._bwd_plan(N, C, 2, (x.data_ptr(), g.data_ptr(),
                                           dy.data_ptr(), out), True)
        want = (1, (1, 264)) if C == 256 else (0, (0, -(-N // 64)))
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (x, g, b)]
            y = fln.fused_layer_norm(*leaves, eps=eps)
            runs.append((y.detach(),) + torch.autograd.grad(y, leaves, dy))
        ry, mu, rstd = fln._ln_fwd_reference(x, g, b, eps)
        refs = fln._ln_bwd_reference(x, g, mu, rstd, dy)
        rounded, _, _ = fln._ln_fwd_reference(x, g.bfloat16(), b.bfloat16(),
                                              eps)
        torch.cuda.synchronize()
        y, grads = runs[0][0], runs[0][1:]
        abs_f, err_f = errs(y, ry)
        abs_b, err_b = (max(e) for e in zip(
            *(errs(a, r) for a, r in zip(grads, refs))))
        worst["K10"], worst["K11"] = (max(worst["K10"], abs_f),
                                      max(worst["K11"], abs_b))
        off, off_rounded = (float((y != r).float().mean())
                            for r in (ry, rounded))
        repeat = same_bits(torch, runs[0], runs[1])
        ok = (err_f <= tol and err_b <= tol and repeat
              and y.dtype == torch.bfloat16
              and grads[1].dtype == grads[2].dtype == torch.float32
              and (plan, bwd_plan) == want and off < off_rounded
              and bool(torch.isfinite(y.float()).all()))
        log(f"check K10/K11 layernorm {label} bf16 x, f32 gamma/beta: plans "
            f"{plan}, {bwd_plan}, max rel err y {err_f:.3e}, dx/dgamma/dbeta "
            f"{err_b:.3e} (tol {tol}); y differs from the plain version in "
            f"{off:.5f} of its elements, from the plain version with gamma "
            f"rounded to bf16 in {off_rounded:.5f}; two runs "
            f"{'equal bit for bit' if repeat else 'DIFFER'} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed(9, f"K10/K11 {label} with f32 gamma/beta "
                                 "disagrees, takes the wrong kernel or does "
                                 "not repeat")
        if C != 256:
            continue
        # device time a call against the same shape with bf16 gamma/beta
        g16, b16 = g.bfloat16(), b.bfloat16()
        times = {}
        for kind, gg, bb in (("f32", g, b), ("bf16", g16, b16)):
            times[kind] = (
                kernel_device_ms(torch, lambda: fln._ln_fwd(x, gg, bb, eps)),
                kernel_device_ms(torch, lambda: fln._ln_bwd(x, gg, mu, rstd,
                                                            dy)))
        log(f"time  K10/K11 layernorm {label} bf16 x: device time a call "
            f"with f32 gamma/beta K10 {fmt_ms(times['f32'][0])}, K11 "
            f"{fmt_ms(times['f32'][1])}; with bf16 gamma/beta K10 "
            f"{fmt_ms(times['bf16'][0])}, K11 {fmt_ms(times['bf16'][1])}")
    return worst


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
    rate = words / wall
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
    return launches, rate


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
    return launches, eng


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


# ------------------------------------------------------------ phase 13

# K12 against its plain version: greedy-free modes whose kept set is a
# count (temperature only, top-k only) are the same f32 operations in
# both and must agree on every row; modes with a top-p nucleus sum the
# mass in another order, so a row whose nucleus mass lies within an ulp
# of top_p can keep one boundary token more or less -> at most 0.1% of
# their rows may differ
SAMPLE_MODES = (
    ("T=1.0", dict(temperature=1.0)),
    ("T=0.8 top_k=8", dict(temperature=0.8, top_k=8)),
    ("T=1.0 top_p=0.9", dict(temperature=1.0, top_p=0.9)),
    ("T=1.0 top_k=8 top_p=0.9", dict(temperature=1.0, top_k=8,
                                       top_p=0.9)),
    ("T=1.0 top_k=1000 top_p=0.5", dict(temperature=1.0, top_k=1000,
                                          top_p=0.5)),
)
# the replay's microbench block, the flagship's slots x vocab, a 32-row
# batch, and 1024 rows that give the top-p match rate its resolution
SAMPLE_SHAPES = ((8, 128), (4, 10000), (32, 10000), (1024, 10000))
SAMPLE_TIMED = SAMPLE_SHAPES[:3]
SAMPLE_TOP_P_MAX_RATE = 1e-3


def sample_bound(B, V, elem_bytes, mode):
    """Least time for K12's function: logits and noise read and the ids
    written once, against the per-element work at the f32 CUDA-core rate:
    3 operations for z and the score, a compare and an add per bisection
    pass (24 each for top-k and top-p, when on) and one exp for top-p."""
    k = 0 < mode.get("top_k", 0) < V
    p = mode.get("top_p", 1.0) < 1.0
    passes = 24 * (k + p)
    ops = B * V * (3 + 2 * passes + (1 if p else 0))
    return bound(B * V * (elem_bytes + 4) + B * 4, ops, "float32")


# launch plans (threads a block, blocks a row's cluster) timed against
# `_plan`'s at the flagship's slots and at 32 rows, in these modes
SAMPLE_PLANS = ((128, 1), (128, 2), (128, 4), (128, 8), (256, 1), (256, 2),
                (256, 4), (256, 8))
SAMPLE_PLAN_MODES = ("T=0.8 top_k=8", "T=1.0 top_k=8 top_p=0.9")


def check_sampling(torch, fsm):
    """K12 (csrc/sampling.cu) against `_select_reference` on the card at
    every shape and mode above, f32 and bf16 logits, the same Gumbel
    noise; each launch run a second time (with the thresholds written
    out) and must repeat bit for bit, its top-k thresholds equal to the
    plain version's binary walk (`_thresholds_reference`) bit for bit;
    kernel ms (CUDA events), device ms (profiler), plain ms and the
    bound at the timed shapes, the Gumbel argmax call's event and device
    time for the temperature-only mode, and the device time of each
    launch plan in SAMPLE_PLANS in the SAMPLE_PLAN_MODES."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    records, rows_off, rows_all, worst = [], {}, {}, 0.0
    for B, V in SAMPLE_SHAPES:
        logits32 = 3.0 * torch.randn(B, V, generator=gen, device=dev)
        noise = fsm.gumbel_noise(gen, B, V, dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            logits = logits32.to(dtype)
            for mlabel, mode in SAMPLE_MODES:
                got = fsm.fused_sample(logits, noise, **mode)
                k, p = fsm._modes(logits, mode.get("top_k", 0),
                                  mode.get("top_p", 1.0))
                again, thr = fsm._launch(logits, noise, mode["temperature"],
                                         k, p, thresholds=True)
                ref = fsm._select_reference(logits, noise, **mode)
                ref_k, _ = fsm._thresholds_reference(
                    logits, mode["temperature"], k, p)
                torch.cuda.synchronize()
                diff = int((got != ref).sum())
                err = float((got.long() - ref.long()).abs().max())
                worst = max(worst, err)
                rows_off[mlabel] = rows_off.get(mlabel, 0) + diff
                rows_all[mlabel] = rows_all.get(mlabel, 0) + B
                repeat = bool(torch.equal(got, again))
                same_k = same_bits(torch, (thr[:, 0],), (ref_k,))
                ok = (got.dtype == torch.int32 and repeat and same_k
                      and bool(((got >= 0) & (got < V)).all()))
                if "top_p" not in mode:
                    ok = ok and diff == 0
                log(f"check K12 sample [{B},{V}] {dname} {mlabel}: "
                    f"{diff} of {B} rows differ from the plain version, "
                    f"two runs {'equal' if repeat else 'DIFFER'}, top-k "
                    f"thresholds {'equal' if same_k else 'DIFFER'} bit for "
                    f"bit -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailed(13, f"K12 [{B},{V}] {dname} {mlabel} "
                                          "disagrees with its plain version "
                                          "or does not repeat")
                if (B, V) not in SAMPLE_TIMED:
                    continue
                run = lambda: fsm.fused_sample(  # noqa: E731
                    logits, noise, **mode)
                ms = time_ms(torch, run)
                dev_ms = kernel_device_ms(torch, run)
                plain_ms = time_ms(torch, lambda: fsm._select_reference(
                    logits, noise, **mode), windows=3, per_window=5)
                lib_ms = lib_dev = None
                if list(mode) == ["temperature"]:
                    # the nearest single call: the Gumbel argmax of the
                    # scaled logits, no filters
                    t = mode["temperature"]
                    lib = lambda: torch.argmax(  # noqa: E731
                        (logits.float() - logits.float().amax(
                            -1, keepdim=True)) / t + noise, -1)
                    lib_ms = time_ms(torch, lib)
                    lib_dev = kernel_device_ms(torch, lib)
                bound_ms, bound_by = sample_bound(
                    B, V, logits.element_size(), mode)
                log(f"time  K12 sample [{B},{V}] {dname} {mlabel}: kernel "
                    f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), plain "
                    f"{plain_ms:.4f} ms, argmax call {fmt_ms(lib_ms)} "
                    f"(device time {fmt_ms(lib_dev)}), bound "
                    f"{bound_ms:.6f} ms ({bound_by})")
                records.append(dict(
                    label=f"[{B},{V}] {dname} {mlabel}", ms=ms,
                    device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev, bound_ms=bound_ms,
                    bound_by=bound_by))
            if dtype is not torch.float32 or V != 10000 or B > 32:
                continue
            for mlabel in SAMPLE_PLAN_MODES:
                mode = dict(SAMPLE_MODES)[mlabel]
                k, p = fsm._modes(logits, mode.get("top_k", 0),
                                  mode.get("top_p", 1.0))
                timings = []
                for plan in SAMPLE_PLANS:
                    plan_ms = kernel_device_ms(torch, lambda: fsm._launch(
                        logits, noise, mode["temperature"], k, p, plan))
                    timings.append(f"{plan} {fmt_ms(plan_ms)}")
                log(f"time  K12 plans [{B},{V}] f32 {mlabel} (threads, "
                    f"cluster): device time {'; '.join(timings)}; `_plan` "
                    f"takes {fsm._plan(B, V)}")
    check_sampling_strided(torch, fsm, gen)
    for mlabel, _ in SAMPLE_MODES:
        rate = rows_off[mlabel] / rows_all[mlabel]
        log(f"check K12 {mlabel}: {rows_off[mlabel]} of {rows_all[mlabel]} "
            f"rows differ over every shape and dtype (rate {rate:.5f})")
        if rate > SAMPLE_TOP_P_MAX_RATE:
            raise PhaseFailed(13, f"K12 {mlabel}: {rows_off[mlabel]} rows "
                                  "differ, above the top-p allowance")
    for rec in records:
        rec["err"] = worst
    return {"K12": records}


def check_sampling_strided(torch, fsm, gen):
    """Fault C2: K12 on strided views, the last position of a [B, 3, V]
    output and noise taken from a wider buffer, at [8, 128] and
    [4, 10000], f32 and bf16, in every mode: equal to the kernel on
    contiguous copies of the same rows, and (without top-p) to
    `_select_reference`."""
    dev = torch.device("cuda")
    for B, V in SAMPLE_TIMED[:2]:
        out32 = 3.0 * torch.randn(B, 3, V, generator=gen, device=dev)
        noise = fsm.gumbel_noise(gen, 2 * B, V, dev).view(B, 2, V)[:, 1]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            logits = out32.to(dtype)[:, -1, :]
            for mlabel, mode in SAMPLE_MODES:
                got = fsm.fused_sample(logits, noise, **mode)
                flat = fsm.fused_sample(logits.contiguous(),
                                        noise.contiguous(), **mode)
                ref = fsm._select_reference(logits, noise, **mode)
                torch.cuda.synchronize()
                ok = (not logits.is_contiguous() and not noise.is_contiguous()
                      and torch.equal(got, flat)
                      and ("top_p" in mode or torch.equal(got, ref)))
                log(f"check K12 sample strided [{B},{V}] {dname} {mlabel}: "
                    f"{int((got != flat).sum())} rows differ from the "
                    f"contiguous rows' launch, {int((got != ref).sum())} "
                    f"from the plain version -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailed(13, f"K12 on strided logits [{B},{V}] "
                                          f"{dname} {mlabel} disagrees")


# ------------------------------------------------------------ phase 14

SERVE_PROMPTS = (40, 300, 700, 1000) * 2
SERVE_NEW = 32
METRIC_FAMILIES = ("serving_requests_total",
                   "serving_request_latency_seconds", "serving_ttft_seconds",
                   "serving_queue_depth", "serving_page_pool_pages",
                   "serving_page_occupancy_ratio", "serving_trace_count",
                   "serving_replica_up", "serving_weight_generation",
                   "serving_speculative_accepted_tokens_per_step",
                   "serving_speculative_acceptance_rate",
                   "serving_hbm_live_bytes", "serving_mfu_live")


def serve_http_arms(torch, counters, net, GenerationEngine, BucketLattice,
                    card):
    """The phase-3 LM and lattice behind ServingServer in three arms
    (speculative k=4; the int8 cache; both), each serving phase 3's 8
    requests over POST /generate; the scoreboard from each arm's own
    telemetry log."""
    import re
    import tempfile
    import urllib.request

    from deeplearning4j_tpu_torch.nn.decode import attention_specs
    from deeplearning4j_tpu_torch.serving import replay
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder

    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in SERVE_PROMPTS]
    trace = [(0.0, len(p), SERVE_NEW) for p in prompts]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    totals, byte_rows = {}, {}
    for arm, k, kv in (("speculative k=4", 4, "f32"),
                       ("int8 cache", 0, "int8"),
                       ("int8 + speculative k=4", 4, "int8")):
        tpath = tmp / f"{kv}_k{k}.jsonl"
        rec = Recorder(str(tpath))
        engine = GenerationEngine(
            net, BucketLattice((1,), seq_lens=(64, 512, 1024)), slots=4,
            max_new_tokens=64, page_size=16, prefill_chunk=1024,
            speculative_k=k, kv_dtype=kv, recorder=rec)
        engine.warmup()
        torch.cuda.synchronize()
        traced = engine.trace_count
        server = ServingServer(engine, port=0).start()
        counters.reset()
        try:
            client = replay.replay_generate_http(
                server.url, trace, make_prompt=lambda i, n: prompts[i],
                timeout_s=600, collect_tokens=True)
            with urllib.request.urlopen(f"{server.url}/metrics",
                                        timeout=60) as resp:
                metrics = resp.read().decode()
            torch.cuda.synchronize()
            launches = counters.read()
        finally:
            server.stop()
            rec.close()
        stats = engine.stats()
        sb = replay.reconstruct_generation(str(tpath))
        families = set(re.findall(r"^# TYPE (\S+) ", metrics, re.M))
        missing = [f for f in METRIC_FAMILIES if f not in families]
        spec = stats["speculative"]
        bps = engine.plan.bytes_per_slot(attention_specs(net))
        byte_rows[kv] = bps
        (pool,) = stats["page_pools"]
        log(f"serve http {arm}: {client['ok']} of {client['sent']} "
            f"requests, {sb['total_tokens']} tokens, {sb['tokens_per_sec']} "
            f"tokens/s, TTFT p50 {sb['ttft_p50_ms']} ms p99 "
            f"{sb['ttft_p99_ms']} ms, accepted_tokens_per_step "
            f"{spec.get('accepted_tokens_per_step', 'off')}, "
            f"draft_acceptance_rate "
            f"{spec.get('draft_acceptance_rate', 'off')}, verify steps "
            f"{spec.get('verify_steps', 0)}, decode steps "
            f"{stats['fleet'][0]['decode_steps_run']}; bytes per slot "
            f"{bps}; trace_count {traced} -> {stats['trace_count']}; "
            f"recompiles after warmup {sb['recompiles_after_warmup']}; "
            f"pool {pool}; /metrics families {len(families)} (missing "
            f"{missing}); launches {launches}; card {card}")
        failures = []
        if client["ok"] != len(prompts) or sb["n_ok"] != len(prompts):
            failures.append(f"served {client['ok']} / {sb['n_ok']} of "
                            f"{len(prompts)}: {client['errors']}")
        if any(len(t) != SERVE_NEW or not all(
                0 <= x < LM["vocab_size"] for x in t)
                for t in client.get("tokens", {}).values()):
            failures.append("a stream is not 32 in-vocabulary tokens")
        if stats["trace_count"] != traced or sb["recompiles_after_warmup"]:
            failures.append("a step shape escaped warmup")
        if pool["pages_in_use"] != 0:
            failures.append(f"pages left in the pool: {pool}")
        if missing:
            failures.append(f"/metrics lacks {missing}")
        if k and not spec.get("verify_steps"):
            failures.append("no verify step ran")
        if launches["K1"] == 0:
            failures.append("prefill never launched K1")
        if failures:
            raise PhaseFailed(14, f"{arm}: " + "; ".join(failures))
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
    plan_f32 = byte_rows["f32"]
    log(f"serve http: bytes per slot (6 layers, capacity 1088) f32-kind "
        f"(bf16 compute dtype) {plan_f32}, int8 {byte_rows['int8']} -> "
        f"{plan_f32 / byte_rows['int8']:.4f}x slots per device byte")
    return totals


# ------------------------------------------------------------ phase 15

ORACLE_MARGIN_TOL = 1e-4


def speculative_oracle(torch, net, transformer_lm, GenerationEngine,
                       BucketLattice):
    """f32 params of the phase-3 LM: the plain greedy stream against the
    speculative k=4 stream, and the int8 cache's against the f32 cache's;
    at a first difference, the top-2 log-probability margin there (the
    full forward over the plain stream's prefix)."""
    net32 = transformer_lm(**LM, dtype="float32", device="cuda")
    net32.params = {layer: {k: t.float() for k, t in p.items()}
                    for layer, p in net.params.items()}
    net32.state = net.state
    rng = torch.Generator().manual_seed(SEED + 3)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in (40, 300, 700, 1000)]

    def streams(k, kv):
        engine = GenerationEngine(
            net32, BucketLattice((1,), seq_lens=(64, 512, 1024)), slots=4,
            max_new_tokens=32, page_size=16, prefill_chunk=1024,
            speculative_k=k, kv_dtype=kv)
        engine.warmup()
        engine.start()
        reqs = [engine.submit_generate(p, SERVE_NEW) for p in prompts]
        out = []
        for r in reqs:
            if not r.wait(600) or r.error is not None:
                raise PhaseFailed(15, f"request failed: {r.error}")
            out.append(list(r.emitted))
        engine.drain()
        return out

    def first_difference(a, b):
        """[(request, position, top-2 margin)] where streams a and b
        first part."""
        found = []
        for i, (x, y) in enumerate(zip(a, b)):
            pos = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v),
                       None)
            if pos is None:
                continue
            seq = np.concatenate([prompts[i], np.asarray(x[:pos])])
            probs = net32.output(seq[None])[0, -1].float()
            top2 = torch.topk(torch.log(probs), 2).values
            found.append((i, pos, float(top2[0] - top2[1])))
        return found

    plain = streams(0, "f32")
    results = {}
    for label, k, kv in (("speculative k=4", 4, "f32"),
                         ("int8 cache", 0, "int8")):
        diffs = first_difference(plain, streams(k, kv))
        results[label] = diffs
        log(f"oracle {label} vs plain greedy (f32 params): "
            + ("streams equal" if not diffs else
               "; ".join(f"request {i} (prompt {len(prompts[i])}) first "
                         f"differs at token {pos}, top-2 log-prob margin "
                         f"there {m:.3e}" for i, pos, m in diffs)))
    bad = [d for d in results["speculative k=4"]
           if not d[2] < ORACLE_MARGIN_TOL]
    if bad:
        raise PhaseFailed(15, f"the speculative stream leaves plain greedy "
                              f"where the top-2 margin is {bad} (>= "
                              f"{ORACLE_MARGIN_TOL})")
    return results


# ------------------------------------------------------------ phase 16

# bench.py `serving_speculative` (run_speculative_replay's settings there)
SPEC_REPLAY = dict(seed=0, n_requests=24, burst=2, mean_gap_s=0.004,
                   prompt_lengths=(8, 16, 32), output_lengths=(4, 8, 16),
                   slots=4, page_size=16, speculative_k=4, repeats=2)
# one warm call and 20 timed ones in `_sample_microbench_us`
SPEC_REPLAY_K12 = 21


def speculative_replay(torch, counters, card):
    """run_speculative_replay at bench.py's own settings on the card:
    every metric line printed; both parity rows 0; exactly 21 K12
    launches."""
    import tempfile

    from deeplearning4j_tpu_torch.serving.replay import (
        run_speculative_replay,
    )

    tpath = Path(tempfile.mkdtemp(prefix="chip_smoke_spec_")) / "t.jsonl"
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    out = run_speculative_replay(telemetry_path=str(tpath), device="cuda",
                                 **SPEC_REPLAY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    for line in out["lines"]:
        log(f"replay: {json.dumps(line)}")
    rows = {line["metric"]: line["value"] for line in out["lines"]}
    log(f"replay: 3 arms x {SPEC_REPLAY['repeats']} rounds of "
        f"{SPEC_REPLAY['n_requests']} requests in {wall:.3f} s; launches "
        f"{launches}; card {card}")
    failures = []
    for row in ("serving_speculative_parity_mismatches",
                "serving_quantized_parity_mismatches"):
        if rows[row] != 0:
            failures.append(f"{row} = {rows[row]}")
    if launches["K12"] != SPEC_REPLAY_K12:
        failures.append(f"K12 launched {launches['K12']} times, expected "
                        f"{SPEC_REPLAY_K12}")
    n_ok = out["n_ok"]  # each arm's log holds every round
    want = 3 * SPEC_REPLAY["repeats"] * SPEC_REPLAY["n_requests"]
    if n_ok != want:
        failures.append(f"{n_ok} of {want} requests served")
    if failures:
        raise PhaseFailed(16, "; ".join(failures))
    return launches


# ------------------------------------------------------------ phase 17

# the image models at bench.py's sizes on the TPU: LeNet-5 batch 512 bf16
# (bench.py:357-384) on the synthetic MNIST, VGG-16 batch 256 bf16
# (:387-416) and ResNet-20 batch 64 (the single-card arm of :619-700), in
# f32 and bf16, on the synthetic CIFAR-10
IMAGE_MODELS = (("lenet5", "bfloat16", 512), ("vgg16", "bfloat16", 256),
                ("resnet20", "float32", 64), ("resnet20", "bfloat16", 64))
# LeNet-5's training: fit_scanned over LENET_BATCHES batches, then fit
# over the same; the JAX package's LeNet-5 reaches accuracy 1.0 on the
# synthetic test split at these steps (f32 and bf16, CPU), so the port
# must clear LENET_MIN_ACC
LENET_BATCHES = 100
LENET_MIN_ACC = 0.99
# train steps on one repeated batch (the loss must fall), warm-up steps,
# timed steps
IMAGE_REPEAT = 5
IMAGE_WARM = 5
IMAGE_TIMED = 20
# the f32 forward on the card against the same port model on the CPU
# with the same params, 8 images, TF32 off: convolutions summed in
# another order by cuDNN, so the softmax outputs agree to 1e-4
IMAGE_F32_TOL = 1e-4
IMAGE_F32_BATCH = 8


def image_flops(net, x):
    """Analytic FLOPs of one training step on x: 2·B·Ho·Wo·Cout·Cin·kh·kw
    for each convolution forward and 2·B·n_in·n_out for each dense or
    output layer, times 3 (forward, and the two products of the
    backward); the output shapes read from an inference forward of one
    image."""
    from deeplearning4j_tpu_torch.nn.conf import (ConvolutionLayer,
                                                  FeedForwardLayer,
                                                  BatchNormalization)

    one = x[:1]
    if hasattr(net, "layer_confs"):  # MultiLayerNetwork
        acts, _ = net._forward(net.params, net.state, one, collect=True)
        pairs = zip(net.layer_confs, acts)
    else:
        acts, _ = net._forward(net.params, net.state, {"input": one},
                               collect=True)
        pairs = ((v.layer, acts[n]) for n, v in net.layer_vertices.items())
    fwd = 0
    for lc, y in pairs:
        if isinstance(lc, ConvolutionLayer):
            kh, kw = lc.kernel_size
            fwd += 2 * y.shape[1] * y.shape[2] * lc.n_out * lc.n_in * kh * kw
        elif isinstance(lc, FeedForwardLayer) and not isinstance(
                lc, BatchNormalization):
            fwd += 2 * lc.n_in * lc.n_out
    return 3 * fwd * x.shape[0]


def image_data(name, batch, n_batches=None, train=True):
    """The synthetic MNIST (NHWC 28x28x1) or CIFAR-10 (32x32x3) iterator
    of `n_batches` batches (default: the whole split)."""
    from deeplearning4j_tpu_torch.datasets import (CifarDataSetIterator,
                                                   MnistDataSetIterator)

    n = None if n_batches is None else batch * n_batches
    if name == "lenet5":
        it = MnistDataSetIterator(batch, num_examples=n, train=train,
                                  reshape_images=True)
    else:
        it = CifarDataSetIterator(batch, num_examples=n, train=train)
    if not it.synthetic:
        raise PhaseFailed(17, f"{name}: expected the synthetic set")
    return it


def check_image_f32(torch, models, name):
    """The f32 model on the card against the same port model on the CPU
    with the card's params and state: the softmax outputs of
    IMAGE_F32_BATCH images within IMAGE_F32_TOL. Returns the error."""
    build = getattr(models, name)
    card = build(dtype="float32", device="cuda").init(SEED)
    host = build(dtype="float32", device="cpu").init(SEED)
    host.params = {k: {n: t.cpu() for n, t in p.items()}
                   for k, p in card.params.items()}
    host.state = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in card.state.items()}
    x = image_data(name, IMAGE_F32_BATCH, 1).next().features
    got = card.output(x)
    want = host.output(x)
    err = float((got.cpu() - want).abs().max())
    ok = got.is_cuda and got.shape == want.shape and err <= IMAGE_F32_TOL
    log(f"image {name} f32: output on the card against the CPU, "
        f"{IMAGE_F32_BATCH} images, max abs err {err:.3e} (tol "
        f"{IMAGE_F32_TOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(17, f"{name}: the f32 forward on the card "
                              "disagrees with the CPU")
    return err


def check_batch_norm_state(torch, net, name, x, steps):
    """Batch norm's running statistics moved in training (count = steps,
    mean and var off their initial 0 and 1) and `output` uses them: the
    output changes when they are reset."""
    bn = {k: s for k, s in net.state.items() if s}
    if not bn:
        return
    moved = all(float(s["count"]) == steps and bool(s["mean"].abs().sum())
                and bool((s["var"] - 1).abs().sum()) for s in bn.values())
    out = net.output(x)
    kept = net.state
    net.state = {k: ({"mean": torch.zeros_like(s["mean"]),
                      "var": torch.ones_like(s["var"]),
                      "count": torch.zeros_like(s["count"])} if s else s)
                 for k, s in kept.items()}
    reset = net.output(x)
    net.state = kept
    used = float((out.float() - reset.float()).abs().max())
    ok = moved and used > 1e-3
    log(f"image {name}: {len(bn)} batch norms, running statistics "
        f"{'moved' if moved else 'NOT moved'} over {steps} steps; output "
        f"with them against reset ones: max abs difference {used:.4f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(17, f"{name}: batch norm's running statistics do "
                              "not move or are not used by output()")


def train_image_model(torch, models, name, dtype, batch, card):
    """One image model on the card: LeNet-5 through fit_scanned and fit
    on the synthetic MNIST, then `evaluate` on its test split; every
    model then IMAGE_REPEAT fit() steps on one repeated batch (the loss
    falls), batch norm's state checked, IMAGE_TIMED timed fit() steps
    after IMAGE_WARM warm-up ones (CUDA events a step), peak memory, and
    one profiled step. Returns its record."""
    from torch.profiler import ProfilerActivity, profile

    tag = f"image {name} {dtype} B={batch}"
    net = getattr(models, name)(dtype=dtype, device="cuda").init(SEED)
    if not all(t.is_cuda for p in net.params.values() for t in p.values()):
        raise PhaseFailed(17, f"{tag}: params not on the card")
    rec = {"model": name, "dtype": dtype, "batch": batch}
    if name == "lenet5":
        it = image_data(name, batch, LENET_BATCHES)
        t0 = time.perf_counter()
        net.fit_scanned(it)
        first = float(net._step_losses[0, 0])
        net.fit(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        test = image_data(name, 512, train=False)
        acc = net.evaluate(test).accuracy()
        last = net.score_value
        ok = np.isfinite(last) and last < first and acc >= LENET_MIN_ACC
        log(f"{tag}: fit_scanned {LENET_BATCHES} steps then fit "
            f"{LENET_BATCHES} steps in {wall:.2f} s; loss {first:.4f} -> "
            f"{last:.6f}; accuracy on {test.total_examples()} synthetic "
            f"test images {acc:.4f} (min {LENET_MIN_ACC}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed(17, f"{tag}: the loss did not fall or the "
                                  "accuracy is below its minimum")
        rec["accuracy"] = acc
        net = getattr(models, name)(dtype=dtype, device="cuda").init(SEED)
    ds = image_data(name, batch, 1).next()
    losses = []
    for _ in range(IMAGE_REPEAT):
        net.fit(ds)
        losses.append(net.score_value)
    params_ok = all(bool(torch.isfinite(t).all()) for p in net.params.values()
                    for t in p.values())
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0] and params_ok
    log(f"{tag}: {IMAGE_REPEAT} fit() steps on one batch, losses "
        f"{[round(x, 4) for x in losses]}, params finite {params_ok} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(17, f"{tag}: the loss is not finite and falling")
    if name != "lenet5":
        check_batch_norm_state(torch, net, name, ds.features, IMAGE_REPEAT)
    for _ in range(IMAGE_WARM):
        net.fit(ds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(IMAGE_TIMED)]
    t0 = time.perf_counter()
    for a, b in events:
        a.record()
        net.fit(ds)
        b.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / IMAGE_TIMED * 1e3
    step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if not np.isfinite(net.score_value):
        raise PhaseFailed(17, f"{tag}: a timed step's loss is not finite")
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit_scanned(ListDataSetIterator([ds]), epochs=IMAGE_TIMED)
    torch.cuda.synchronize()
    scanned_ms = (time.perf_counter() - t0) / IMAGE_TIMED * 1e3
    flops = image_flops(net, torch.as_tensor(ds.features))
    ips = batch / (step_ms / 1e3)
    mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, rows = device_profile(torch, prof, wall, f"{tag} profile (one "
                                f"step)", top=5)
    busy_ms = sum(r[0] for r in rows) / 1e3 if rows else None
    log(f"{tag}: step {step_ms:.3f} ms (median CUDA-event time of "
        f"{IMAGE_TIMED} fit() steps; host clock {host_ms:.3f} ms a step; "
        f"fit_scanned of the batch staged once {scanned_ms:.3f} ms a step) "
        f"-> {ips:.1f} images/s; {flops / 1e9:.3f} GFLOP a step; MFU "
        f"{mfu:.5f} against {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s"
        + (f" ({flops / (step_ms / 1e3) / PEAK_FLOPS['float32']:.5f} "
           f"against the f32 CUDA-core 67 TFLOP/s)"
           if dtype == "float32" else "")
        + f"; peak device memory {peak_mib:.1f} MiB; device idle share of "
        f"the profiled step {'not measured' if idle is None else f'{idle:.4f}'}"
        + (f", of the median step {1 - busy_ms / step_ms:.4f}"
           if busy_ms is not None else "") + f"; card {card}")
    rec.update(step_ms=step_ms, host_ms=host_ms, scanned_ms=scanned_ms,
               images_per_s=ips,
               gflop_per_step=flops / 1e9, mfu=mfu, peak_mib=peak_mib,
               idle_profiled=idle, kernel_ms=busy_ms,
               idle_median=(None if busy_ms is None
                            else 1 - busy_ms / step_ms),
               top5=[[short_name(key)[:70], us / 1e3, count]
                     for us, count, key in rows[:5]])
    return rec


def train_image_models(torch, counters, card):
    """Phase 17: the f32 forward of each model on the card against the
    CPU, then each model of IMAGE_MODELS trained on the card
    (`train_image_model`). The image path runs none of K1-K13: the
    JAX image models reach no Pallas kernel (their convolutions and
    pooling are XLA's), so the port's are cuDNN's and plain PyTorch;
    every launch count must read 0."""
    from deeplearning4j_tpu_torch import models

    t0 = time.perf_counter()
    errs_f32 = {name: check_image_f32(torch, models, name)
                for name in ("lenet5", "vgg16", "resnet20")}
    counters.reset()
    records = [train_image_model(torch, models, name, dtype, batch, card)
               for name, dtype, batch in IMAGE_MODELS]
    launches = counters.read()
    log(f"image models: launches of K1-K13 {launches}")
    if any(launches.values()):
        raise PhaseFailed(17, f"the image path launched a kernel of K1-K13: "
                              f"{launches}")
    log("image_models: " + json.dumps({"card": card, "f32_forward_err":
                                       errs_f32, "runs": records}))
    log(f"image models: phase 17 in {time.perf_counter() - t0:.1f} s")
    return records


# ------------------------------------------------------------ phase 18

# the predict path at the flagship's width (18a): K2 runs at the 512
# bucket, K1 at 1024, the dense route at 128
PREDICT_LATTICE = dict(batch_sizes=(1, 2, 4), seq_lens=(128, 512, 1024))
PREDICT_TRACE = dict(seed=0, n_requests=48, burst=4, mean_gap_s=0.004,
                     lengths=(100, 128, 400, 512, 900, 1024))
# bench.py `serving_replay` (bench.py:1255-1282), for both models (18b)
SERVING_REPLAY = dict(seed=0, n_requests=120, burst=4, mean_gap_s=0.002,
                      lengths=(8, 16, 32), batch_sizes=(1, 2, 4),
                      max_wait_ms=4.0, replicas=2)
# f32 on the card against f32 on the CPU, on probabilities: the same f32
# forward (TF32 off) summed in other orders
PREDICT_ORACLE_TOL = 1e-4
# kernels against their plain versions on a served bf16 batch, on
# probabilities relative to the batch's largest: the bf16 tolerance of
# the kernel checks (TOL), one bf16 rounding flip of an attention output
# carried through the later layers
PREDICT_PLAIN_TOL = TOL["bfloat16"]["o"]
# a request's output against the direct forward of the weights its
# weight_gen names, relative to the largest probability: bit for bit is
# expected; any difference is reported and held to this
SWAP_TOL = 1e-3


def _plain_attention(torch, fa):
    """The attention layer's two flash routes (inference only) over the
    plain versions of K1 and K2/K3, called directly."""
    def flash_attention_qkv(qkv, H, *, causal=True, sm_scale=None,
                            mask=None, dropout=0.0, generator=None):
        D = qkv.shape[-1] // 3 // H
        km = None if mask is None else mask.float()
        o, _ = fa._flash_fwd_qkv_reference(qkv, H, km, D ** -0.5, causal)
        return o

    def flash_attention(q, k, v, *, causal=True, sm_scale=None, mask=None,
                        dropout=0.0, generator=None):
        B, H, T, D = q.shape
        km = (None if mask is None else mask.float()[:, None, :]
              .expand(B, H, T).reshape(B * H, T))
        o, _ = fa._flash_fwd_reference(
            *(t.reshape(B * H, T, D) for t in (q, k, v)), km, D ** -0.5,
            causal)
        return o.reshape(B, H, T, D)

    return {"flash_attention": flash_attention,
            "flash_attention_qkv": flash_attention_qkv}


def _with_plain_attention(torch, fa, fn):
    """fn() with the attention layer's flash routes swapped for the plain
    versions; restored after."""
    from deeplearning4j_tpu_torch.nn.layers import attention

    saved = {k: getattr(attention, k) for k in ("flash_attention",
                                                "flash_attention_qkv")}
    try:
        for k, f in _plain_attention(torch, fa).items():
            setattr(attention, k, f)
        return fn()
    finally:
        for k, f in saved.items():
            setattr(attention, k, f)


def _rel_err(a, b):
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _submit_trace(engine, trace, make_features, timeout=600):
    """Submit each trace entry at its arrival offset from a client
    thread pool (as an HTTP front end would), wait for every request;
    returns the requests in trace order."""
    import concurrent.futures

    t_start = time.monotonic()

    def one(entry):
        i, (offset, seq_len) = entry
        delay = offset - (time.monotonic() - t_start)
        if delay > 0:
            time.sleep(delay)
        req = engine.submit(make_features(i, seq_len),
                            request_id=f"trace-{i}")
        req.wait(timeout)
        return req

    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        return list(pool.map(one, enumerate(trace)))


def predict_flagship(torch, counters, fa, card):
    """18a: the flagship LM (phase 3's, bf16, seed 0) behind
    `InferenceEngine` with 2 replicas over the (1, 2, 4) x (128, 512,
    1024) lattice, 48 requests of a seeded bursty trace; padding
    invariance, the kernels against their plain versions on served
    batches, the f32 oracle against the CPU, exact launch counts, the
    latency scoreboard, the per-bucket forward/fetch split and a profiled
    (4, 1024) batch's idle share. Returns the traffic window's launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.serving import replay
    from deeplearning4j_tpu_torch.serving.batcher import (PendingRequest,
                                                          assemble)
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.telemetry import Recorder

    V = LM["vocab_size"]
    net = transformer_lm(**LM, dtype="bfloat16", device="cuda").init(SEED)
    tpath = Path(tempfile.mkdtemp(prefix="chip_smoke_predict_")) / "t.jsonl"
    rec = Recorder(str(tpath))
    engine = InferenceEngine(net, BucketLattice(**PREDICT_LATTICE),
                             replicas=2, max_wait_ms=4.0, sequence=True,
                             recorder=rec)
    tokens = np.random.default_rng(1).integers(0, V, (
        PREDICT_TRACE["n_requests"], max(PREDICT_TRACE["lengths"])))
    trace = replay.make_trace(**PREDICT_TRACE)
    torch.cuda.synchronize()
    counters.reset()
    dense0 = fa.DENSE_ROUTES["head_dim"]
    t0 = time.perf_counter()
    warm = engine.warmup(tokens[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    traced = engine.trace_count
    engine.start()
    reqs = _submit_trace(engine, trace, lambda i, n: tokens[i, :n])
    engine.drain(600)
    torch.cuda.synchronize()
    launches = counters.read()
    rec.close()
    failures = []
    for r, (_, n) in zip(reqs, trace):
        if r.error is not None or r.result is None:
            failures.append(f"{r.request_id}: {r.error}")
        elif r.result.shape != (n, V) or not np.isfinite(r.result).all():
            failures.append(f"{r.request_id}: output {r.result.shape}")
    del reqs
    sb = replay.reconstruct(str(tpath))
    events = [json.loads(l) for l in tpath.read_text().splitlines()
              if l.startswith("{")]
    spans = {}  # bucket -> forward spans (warmup compiles included)
    for e in events:
        if e.get("event") != "span":
            continue
        if e.get("name") == "forward" or (e.get("name") == "compile"
                                          and e.get("warmup")):
            spans.setdefault(tuple(e["bucket"]), []).append(e["seconds"])
    n_at = {T: sum(len(v) for b, v in spans.items() if b[1] == T)
            for T in PREDICT_LATTICE["seq_lens"]}
    want = {"K2": 6 * n_at[512], "K1": 6 * n_at[1024]}
    others = {k: n for k, n in launches.items() if k not in ("K1", "K2")}
    log(f"predict: {sb['n_ok']} of {len(trace)} requests, p50 "
        f"{sb['p50_ms']} ms, p99 {sb['p99_ms']} ms, {sb['qps']} QPS over "
        f"{sb['span_s']} s; warmup {warm} shapes in {warm_s:.3f} s; "
        f"trace_count {traced} -> {engine.trace_count}; recompiles after "
        f"warmup {sb['recompiles_after_warmup']}; forwards (warmup "
        f"included) at seq 128/512/1024 {n_at[128]}/{n_at[512]}/"
        f"{n_at[1024]}; launches {launches}; card {card}")
    if sb["n_ok"] != len(trace) or sb["n_failed"]:
        failures.append(f"{sb['n_ok']} ok, {sb['n_failed']} failed")
    if engine.trace_count != traced or sb["recompiles_after_warmup"]:
        failures.append("a shape escaped warmup")
    for k, n in want.items():
        if launches[k] != n:
            failures.append(f"{k} launched {launches[k]} times, expected {n}")
    if any(others.values()):
        failures.append(f"K3-K13 launched: {others}")
    if fa.DENSE_ROUTES["head_dim"] != dense0:
        failures.append("an attention call took the dense path for its "
                        "head dim")
    if failures:
        raise PhaseFailed("18a", "; ".join(failures[:8]))

    # the forward span split: the forward on the card (host clock to a
    # synchronize) and the fetch of the f32 rows, each bucket
    replica = engine.fleet_workers()[0]
    ws = engine.weights.current
    lat = BucketLattice(**PREDICT_LATTICE)
    for b in lat.shapes():
        x = torch.as_tensor(tokens[:b.batch, :b.seq], device="cuda")
        m = torch.ones(b.batch, b.seq, device="cuda")
        fwd, fetch = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = replica._fwd(ws.params, ws.state, x, m)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = y.float().cpu().numpy()
            fwd.append(t1 - t0)
            fetch.append(time.perf_counter() - t1)
        med = statistics.median(spans.get(b.key(), [0.0]))
        log(f"predict: bucket {b.key()}: forward_s median "
            f"{med * 1e3:.3f} ms over {len(spans.get(b.key(), []))} spans; "
            f"alone: forward on the card {statistics.median(fwd[1:]) * 1e3:.3f}"
            f" ms, fetch of {rows.nbytes / 1e6:.1f} MB "
            f"{statistics.median(fetch[1:]) * 1e3:.3f} ms; card {card}")
    x = torch.as_tensor(tokens[:4, :1024], device="cuda")
    m = torch.ones(4, 1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replica.forward(ws, x, m)
        wall = time.perf_counter() - t0
    _, rows = device_profile(torch, prof, wall, "predict (4, 1024) batch",
                             top=6)
    # the device busy time above counts the fetch's copy engine: the
    # compute's own share leaves copies out
    kernels = sum(r[0] for r in rows if not r[2].startswith("Memcpy")) / 1e6
    if rows:
        log(f"predict (4, 1024) batch: kernels alone {kernels * 1e3:.3f} ms "
            f"of {wall * 1e3:.3f} ms (compute idle share "
            f"{1 - kernels / wall:.4f}); card {card}")

    # padding invariance and the kernels against their plain versions, on
    # batches assembled as the batcher does, through the replica's forward
    lat4 = BucketLattice(batch_sizes=(4,),
                         seq_lens=PREDICT_LATTICE["seq_lens"])

    def batch_of(lengths, offset=0):
        return assemble([PendingRequest(features=tokens[offset + i, :n])
                         for i, n in enumerate(lengths)], lat4,
                        sequence=True)

    for T, lengths in ((512, (400, 512, 130)), (1024, (900, 1024, 600))):
        alone = batch_of(lengths[:1])
        full = batch_of(lengths[:1] + (T - 7, T - 50, T // 2), offset=0)
        counters.reset()
        a = replica.forward(ws, alone.features, alone.mask)
        f = replica.forward(ws, full.features, full.mask)
        n = lengths[0]
        same = np.array_equal(a[0, :n], f[0, :n])
        served = batch_of(lengths)  # one all-masked padding row
        k = replica.forward(ws, served.features, served.mask)
        kern = counters.read()
        p = _with_plain_attention(torch, fa, lambda: replica.forward(
            ws, served.features, served.mask))
        errs = [_rel_err(k[i, :L], p[i, :L]) for i, L in enumerate(lengths)]
        log(f"predict: bucket (4, {T}): a request alone and beside three "
            f"others {'bit-identical' if same else 'DIFFERENT'}; kernels "
            f"{ {k_: v for k_, v in kern.items() if v} } against the plain "
            f"versions on a served batch of {lengths} + an all-masked row: "
            f"max rel err {max(errs):.3e} (tol {PREDICT_PLAIN_TOL}), "
            f"finite {bool(np.isfinite(k).all())}")
        if not same:
            raise PhaseFailed("18a", f"padding changed a real row at T={T}")
        if max(errs) > PREDICT_PLAIN_TOL or not np.isfinite(k).all():
            raise PhaseFailed("18a", f"kernels disagree with the plain "
                                     f"versions at T={T}: {errs}")
        if not kern["K2" if T == 512 else "K1"]:
            raise PhaseFailed("18a", f"no flash kernel ran at T={T}")

    # the f32 oracle: an f32 copy served on the card against the CPU's
    # output of each request alone, unpadded, with the card's params
    net32 = transformer_lm(**LM, dtype="float32", device="cuda")
    net32.params = {layer: {k_: t.float() for k_, t in p_.items()}
                    for layer, p_ in net.params.items()}
    net32.state = net.state
    cpu = transformer_lm(**LM, dtype="float32", device="cpu")
    cpu.params = {layer: {k_: t.cpu() for k_, t in p_.items()}
                  for layer, p_ in net32.params.items()}
    cpu.state = {layer: {} for layer in cpu.params}
    eng32 = InferenceEngine(net32, BucketLattice(**PREDICT_LATTICE),
                            max_wait_ms=4.0, sequence=True,
                            recorder=Recorder(path=None))
    eng32.warmup(tokens[0])
    lengths = PREDICT_TRACE["lengths"]
    reqs = [eng32.submit(tokens[i, :n]) for i, n in enumerate(lengths)]
    eng32.start()
    for r in reqs:
        if not r.wait(600) or r.error is not None:
            raise PhaseFailed("18a", f"f32 request failed: {r.error}")
    eng32.drain(600)
    worst = 0.0
    for r, n in zip(reqs, lengths):
        ref = cpu.output(r.features[None])[0].numpy()
        worst = max(worst, float(np.abs(r.result - ref).max()))
    log(f"predict: f32 oracle, {len(lengths)} requests {lengths} batched "
        f"with padding on the card against each alone on the CPU: max "
        f"|p - p_cpu| {worst:.3e} (tol {PREDICT_ORACLE_TOL})")
    if worst > PREDICT_ORACLE_TOL:
        raise PhaseFailed("18a", f"the f32 oracle differs by {worst:.3e}")
    return launches


def predict_replays(card):
    """18b: `run_replay` at bench.py's `serving_replay` settings over
    HTTP, the tiny LM and then the tiny MLP (the full-width LM is not
    served over HTTP: one [1000, 10000] reply is about 200 MB of JSON)."""
    import tempfile

    from deeplearning4j_tpu_torch.serving.replay import run_replay

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_replay_"))
    for model in ("lm", "mlp"):
        t0 = time.perf_counter()
        sb = run_replay(model=model, telemetry_path=str(tmp / f"{model}.jsonl"),
                        device="cuda", **SERVING_REPLAY)
        for line in sb["lines"]:
            log(f"predict replay {model}: {json.dumps(line)}")
        log(f"predict replay {model}: {sb['n_ok']} ok, client "
            f"{sb['client']['ok']}/{sb['client']['sent']} in "
            f"{time.perf_counter() - t0:.3f} s, warmed buckets "
            f"{sb['warmed_buckets']}; card {card}")
        n = SERVING_REPLAY["n_requests"]
        if (sb["n_ok"] != n or sb["client"]["failed"]
                or sb["recompiles_after_warmup"]):
            raise PhaseFailed("18b", f"{model}: {sb['n_ok']} of {n} ok, "
                                     f"client errors {sb['client']['errors']},"
                                     f" recompiles "
                                     f"{sb['recompiles_after_warmup']}")


def fleet_replay(card):
    """18c: `run_fleet_replay` at its defaults (120 requests, burst 8, 4
    ms gaps, max wait 3 ms, autoscale up to 3 replicas, chaos
    r0:kill@batch4, a hot swap after 60 requests)."""
    import tempfile

    from deeplearning4j_tpu_torch.serving.replay import run_fleet_replay

    tpath = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_")) / "t.jsonl"
    t0 = time.perf_counter()
    out = run_fleet_replay(telemetry_path=str(tpath), device="cuda")
    for line in out["lines"]:
        log(f"fleet replay: {json.dumps(line)}")
    fixed, auto = out["fixed"], out["autoscale"]
    log(f"fleet replay: both arms in {time.perf_counter() - t0:.3f} s; "
        f"autoscale arm: {auto['n_ok']} ok, {auto['n_failed']} failed, "
        f"{auto['n_respawns']} respawns, {auto['n_swaps']} swaps, weight "
        f"generations {auto['weight_generations']}, scale ups "
        f"{auto['scale_ups']} downs {auto['scale_downs']}; card {card}")
    failures = []
    if fixed["n_failed"] or fixed["n_ok"] != 120:
        failures.append(f"fixed arm {fixed['n_ok']} ok, "
                        f"{fixed['n_failed']} failed")
    if not 1 <= auto["n_failed"] <= 4:
        failures.append(f"autoscale arm failed {auto['n_failed']}")
    if auto["n_respawns"] < 1 or auto["n_swaps"] != 1:
        failures.append(f"respawns {auto['n_respawns']}, swaps "
                        f"{auto['n_swaps']}")
    if auto["weight_generations"] != [0, 1]:
        failures.append(f"generations {auto['weight_generations']}")
    if fixed["recompiles_after_warmup"] or auto["recompiles_after_warmup"]:
        failures.append("a shape escaped warmup")
    if failures:
        raise PhaseFailed("18c", "; ".join(failures))


def fleet_flagship(torch, counters, card):
    """18d: checkpoints and hot-swap at the flagship's width (round trip
    bit for bit; a hot swap under 24 requests in flight, each matching
    the net its weight_gen names; a narrower net's checkpoint refused
    before any read), then phase 3's GenerationEngine killed at decode
    step 5 and healed by a FleetSupervisor. Returns the launches of the
    serving windows."""
    import concurrent.futures
    import tempfile

    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.serving import fleet
    from deeplearning4j_tpu_torch.serving.batcher import (PendingRequest,
                                                          assemble)
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import (GenerationEngine,
                                                         InferenceEngine)
    from deeplearning4j_tpu_torch.telemetry import Recorder
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    V = LM["vocab_size"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    tokens = np.random.default_rng(2).integers(0, V, (24, 1024))
    lattice = dict(batch_sizes=(1,), seq_lens=(512, 1024))

    def lm(seed=None, **kw):
        net = transformer_lm(**dict(LM, **kw), dtype="bfloat16",
                             device="cuda")
        return net if seed is None else net.init(seed)

    def engine_on(net, **kw):
        eng = InferenceEngine(net, BucketLattice(**lattice), sequence=True,
                              recorder=kw.pop("recorder", Recorder(None)),
                              **kw)
        eng.warmup(tokens[0])
        return eng.start()

    # round trip
    saving = lm(SEED)
    saving.iteration_count = 100
    Checkpointer(str(tmp / "a")).save(saving)
    totals = {}
    counters.reset()
    ref_eng = engine_on(saving)
    got_eng = engine_on(lm(), checkpoint=str(tmp / "a"))
    lengths = (400, 512, 1000)
    outs = [(ref_eng.predict(tokens[i, :n], timeout=600),
             got_eng.predict(tokens[i, :n], timeout=600))
            for i, n in enumerate(lengths)]
    ref_eng.drain(600)
    got_eng.drain(600)
    same = all(np.array_equal(a, b) for a, b in outs)
    log(f"fleet: round trip of the flagship (step 100): restored_step "
        f"{got_eng.restored_step}, outputs for {lengths} "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if got_eng.restored_step != 100 or not same:
        raise PhaseFailed("18d", "the checkpoint round trip differs")

    # hot swap under traffic
    Checkpointer(str(tmp / "b")).save(lm(1), 200)
    rec = Recorder(path=None)
    eng = engine_on(lm(SEED), max_wait_ms=0.0, replicas=2, recorder=rec)
    lens = [int(n) for n in np.random.default_rng(3).choice(
        (300, 512, 700, 1024), 24)]

    # the last 4 requests arrive once the flip has landed, so the new
    # weights serve some whatever the restore takes (it took 566-1063
    # ms on the card, past the 92 ms over which the first 20 arrive)
    swapped = threading.Event()

    def one(i):
        if i < 20:
            time.sleep(0.004 * i)
        else:
            swapped.wait(600)
        req = eng.submit(tokens[i, :lens[i]], request_id=f"swap-{i}")
        req.wait(600)
        return req

    with concurrent.futures.ThreadPoolExecutor(24) as pool:
        futs = [pool.submit(one, i) for i in range(24)]
        while eng.served < 8 and not all(f.done() for f in futs[:20]):
            time.sleep(0.001)
        try:
            swap = fleet.hot_swap(eng, str(tmp / "b"))
        finally:
            swapped.set()
        reqs = [f.result() for f in futs]
    eng.drain(600)
    totals = counters.read()
    gens = {e["id"]: e["weight_gen"] for e in rec.events
            if e.get("event") == "request"}
    new = eng.weights.current
    failed = [r.request_id for r in reqs if r.error is not None]
    lat = BucketLattice(**lattice)
    worst, apart, n_diff = 0.0, float("inf"), 0
    fwd = eng.net.inference_fn()
    weights = {0: (eng.net.params, eng.net.state),
               1: (new.params, new.state)}
    for r in reqs:
        if r.error is not None:
            continue
        b = assemble([PendingRequest(features=r.features)], lat,
                     sequence=True)
        rows = {}
        for g in (0, 1):
            p, s = weights[g]
            rows[g] = fwd(p, s, torch.as_tensor(b.features, device="cuda"),
                          torch.as_tensor(b.mask, device="cuda")) \
                .float().cpu().numpy()[0, :len(r.features)]
        g = gens[r.request_id]
        err = _rel_err(r.result, rows[g])
        n_diff += err > 0
        worst = max(worst, err)
        apart = min(apart, _rel_err(rows[1 - g], rows[g]))
    log(f"fleet: hot swap at {swap['restore_ms']} ms under 24 requests in "
        f"flight: generations {sorted(set(gens.values()))} "
        f"({sum(1 for g in gens.values() if g == 1)} on the new one), "
        f"{len(failed)} failed; against the direct forward of the named "
        f"net: {n_diff} differ, max rel err {worst:.3e} (tol {SWAP_TOL}); "
        f"the two nets differ by at least {apart:.3e}; launches {totals}")
    if failed or sorted(set(gens.values())) != [0, 1]:
        raise PhaseFailed("18d", f"swap: failed {failed}, generations "
                                 f"{sorted(set(gens.values()))}")
    if worst > SWAP_TOL or apart <= 100 * SWAP_TOL:
        raise PhaseFailed("18d", f"swap outputs: max rel err {worst:.3e}, "
                                 f"nets apart by {apart:.3e}")

    # a narrower net's checkpoint: refused before any read
    Checkpointer(str(tmp / "c")).save(lm(2, d_model=128), 300)
    before = eng.weights.generation
    try:
        fleet.validate_checkpoint_shapes(eng.weights.current.params,
                                         str(tmp / "c"), 300)
    except fleet.WeightSwapError as exc:
        refused = str(exc)
    else:
        raise PhaseFailed("18d", "a narrower net's checkpoint passed the "
                                 "pre-restore gate")
    x = tokens[0, :512]
    eng2 = engine_on(eng.net)  # the old weights, served anew
    y0 = eng2.predict(x, timeout=600)
    try:
        fleet.hot_swap(eng2, str(tmp / "c"))
        raise PhaseFailed("18d", "hot_swap took a narrower checkpoint")
    except fleet.WeightSwapError:
        pass
    y1 = eng2.predict(x, timeout=600)
    eng2.drain(600)
    log(f"fleet: narrower checkpoint refused ({refused[:120]}); the old "
        f"weights serve on ({'bit-identical' if np.array_equal(y0, y1) else 'DIFFERENT'}"
        f", generation {eng2.weights.generation})")
    if not np.array_equal(y0, y1) or eng2.weights.generation != 0:
        raise PhaseFailed("18d", "the refused swap changed the weights")

    # phase 3's GenerationEngine, killed mid-decode
    rec = Recorder(path=None)
    gen = GenerationEngine(lm(SEED), BucketLattice((1,), seq_lens=(64, 512,
                                                                   1024)),
                           slots=4, max_new_tokens=64, page_size=16,
                           prefill_chunk=1024, faults="r0:kill@decode5",
                           recorder=rec)
    gen.warmup()
    traced = gen.trace_count
    sup = fleet.FleetSupervisor(gen, death_after_s=5.0,
                                backoff=fleet.RespawnBackoff(
                                    base_s=0.0, jitter_frac=0.0),
                                recorder=rec)
    gen.start()
    first = [gen.submit_generate(tokens[i, :n], 32)
             for i, n in enumerate((40, 300))]
    for r in first:
        if not r.wait(600):
            raise PhaseFailed("18d", "a killed request never completed")
    worker = gen.fleet_workers()[0]
    actions = sup.poll()
    pool = worker.pool.describe()
    later = [gen.submit_generate(tokens[i, :n], 32)
             for i, n in enumerate((700, 1000, 40, 300), start=2)]
    for r in later:
        if not r.wait(600):
            raise PhaseFailed("18d", "a later request timed out")
    gen.drain(600)
    kinds = [e["kind"] for e in rec.events if e.get("event") == "fault"]
    log(f"fleet: generation worker killed at decode 5: first requests "
        f"{[r.error.splitlines()[0][:60] if r.error else 'ok' for r in first]}"
        f"; supervisor {actions}; pool after the reap {pool}; trace_count "
        f"{traced} -> {gen.trace_count}; later requests "
        f"{[len(r.emitted) if r.error is None else r.error for r in later]}; "
        f"fault events {kinds}")
    if not all(r.error for r in first):
        raise PhaseFailed("18d", "a killed slot's request succeeded")
    if pool["pages_in_use"] or actions["respawned"] != [0]:
        raise PhaseFailed("18d", f"pool {pool}, supervisor {actions}")
    if gen.trace_count != traced:
        raise PhaseFailed("18d", "the respawn saw a new shape")
    if any(r.error is not None or len(r.emitted) != 32 for r in later):
        raise PhaseFailed("18d", "a later request failed")
    return totals


def serve_predict_fleet(torch, counters, fa, card):
    """Phase 18: 18a-18d. Returns the launches of the flagship serving
    windows (18a's traffic and 18d's)."""
    t0 = time.perf_counter()
    a = predict_flagship(torch, counters, fa, card)
    predict_replays(card)
    fleet_replay(card)
    d = fleet_flagship(torch, counters, card)
    log(f"predict and fleet: phase 18 in {time.perf_counter() - t0:.1f} s")
    return {k: a.get(k, 0) + d.get(k, 0) for k in set(a) | set(d)}


# ------------------------------------------------------------ phase 19

# bench.py mode "moe" (`:1104-1107`): the flagship's width with each
# block's FF an 8-expert top-2 MoE (d_expert 512), routed at capacity
# factor 1.25, batch 32 x 512 (phase 6's)
MOE_LM = dict(vocab_size=10000, d_model=256, n_heads=2, n_layers=6,
              n_experts=8, top_k=2, d_expert_hidden=512)
MOE_STEPS = 5
MOE_TIMED = 20
# the routed path against the dense oracle at capacity factor E / top_k:
# the JAX package's contract (tests/test_pipeline_moe.py:73, atol 1e-5)
MOE_ROUTED_ATOL = 1e-5
# GravesLSTMCharModellingExample (dl4j 0.4 examples): two GravesLSTM(200)
# over 77 characters, batch 32, sequences of 1000, TBPTT 50, RMSProp lr
# 0.1 (decay 0.95), l2 1e-3, Xavier, seed 12345; 4 samples of 300
CHAR = dict(vocab=77, hidden=200, batch=32, seq=1000, tbptt=50, batches=3,
            samples=4, sample_len=300)
CHARSET = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
           "!&()?-'\",.:; \n\t")
# rnn_time_step in chunks against the full forward on the card: the same
# f32 ops on the same inputs, one launch shape apart -> 1e-5
STREAM_TOL = 1e-5


def cuda_steps(torch, fn, n):
    """(median CUDA-event ms of `n` calls of fn after 2 warm-up calls,
    peak device MiB over them)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b in events),
            torch.cuda.max_memory_allocated() / 2**20)


def profiled(torch, fn, tag, top=5):
    """fn() once under the profiler: (idle share, kernel ms, top rows as
    [name, ms, calls])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, rows = device_profile(torch, prof, wall, tag, top=top)
    busy = sum(r[0] for r in rows) / 1e3 if rows else None
    return idle, busy, [[short_name(key)[:60], us / 1e3, count]
                        for us, count, key in rows[:top]]


def finite_params(torch, net):
    from deeplearning4j_tpu_torch.nn import tree

    return all(bool(torch.isfinite(t).all()) for _, t in
               tree.leaves(net.params))


class pinned_routing:
    """Within the block, `moe.moe_topk_from_logits` records the experts
    each MoE call chooses (`ids`, in call order); after `replay()` the
    calls take the recorded experts in the same order instead, with the
    gates the renormalized softmax of their own logits at those experts.
    Two forwards that differ by rounding (bf16 kernels against plain
    versions, the card against the CPU) can send a token whose top-2 and
    third logits nearly tie to another expert, a jump no tolerance
    covers; held to one routing, the rest of the function is
    continuous."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.ids = torch, moe, []
        self._orig, self._replaying = moe.moe_topk_from_logits, None

    def __enter__(self):
        def topk(logits, k):
            if self._replaying is None:
                out = self._orig(logits, k)
                self.ids.append(out[1].detach().cpu())
                return out
            ids = self._replaying.pop(0).to(logits.device)
            probs = self.torch.softmax(logits.gather(-1, ids), dim=-1)
            return (self.torch.zeros_like(logits).scatter(-1, ids, probs),
                    ids, probs)

        self.moe.moe_topk_from_logits = topk
        return self

    def replay(self):
        self._replaying = list(self.ids)

    def __exit__(self, *exc):
        self.moe.moe_topk_from_logits = self._orig


def routing_differences(torch, a, b):
    """(token, k) expert choices that differ between two recordings."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def moe_lm(models, dtype="bfloat16", device="cuda", **kw):
    return models.transformer_moe_lm(**MOE_LM, max_length=TRAIN["seq"],
                                     dtype=dtype, device=device, **kw)


def train_moe(torch, counters, fa, DataSet, card):
    """19a: the MoE LM at bench width through fit_scanned (exact
    launches, falling loss, the aux loss in the training loss), its
    forward through the kernels against the plain versions, an f32 copy
    against the CPU, the routed path against the dense one, then its
    step time, MFU, memory and profile beside the dense flagship's step
    in this call. Returns (launches, record)."""
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_moe_flops_per_token,
    )
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.layers import moe
    from deeplearning4j_tpu_torch.nn.layers.base import AUX_LOSS_KEY

    c, m = TRAIN, MOE_LM
    net = moe_lm(models).init(SEED)
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    torch.cuda.synchronize()
    counters.reset()
    net.fit_scanned(ds, epochs=MOE_STEPS)
    torch.cuda.synchronize()
    launches = counters.read()
    losses = net._step_losses.float().flatten().cpu().tolist()
    S, L = MOE_STEPS, m["n_layers"]
    want = {k: 0 for k in launches}
    want.update({"K2": L * S, "K6": L * S, "K8": S, "K9": S, "K9 dW": S})
    batch = net._batch_dict(net._to_mds(ds))
    with torch.no_grad():
        _, st, _ = net._walk(net.params, net.state,
                             {"tokens": batch["features"][0]}, train=True)
    aux = sum(float(s[AUX_LOSS_KEY]) for s in st.values()
              if AUX_LOSS_KEY in s)
    train_loss, eval_loss = net.score(ds, training=True), net.score(ds)
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and finite_params(torch, net) and launches == want
          and aux > 0 and abs(train_loss - eval_loss - aux) < 1e-4)
    log(f"moe: fit_scanned {S} steps, losses {[round(x, 4) for x in losses]}"
        f"; launches {launches} (expected {want}); aux loss {aux:.6f} = "
        f"training score {train_loss:.6f} - inference score "
        f"{eval_loss:.6f}; params finite -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19a", "the MoE LM's training check failed")

    x4 = ds.features[:4]
    counters.reset()
    with pinned_routing(torch, moe) as pin:
        y_k = net.output(x4).float()
        fwd_launches = counters.read()
        pin.replay()
        y_p = _with_plain_attention(torch, fa,
                                    lambda: net.output(x4)).float()
    err = float((y_k - y_p).abs().max() / y_p.abs().max())
    with pinned_routing(torch, moe) as free:
        _with_plain_attention(torch, fa, lambda: net.output(x4))
    flips = routing_differences(torch, pin.ids, free.ids)
    ok = err <= TOL["bfloat16"]["o"] and fwd_launches["K2"] == L
    log(f"moe: [4, 512] forward through the kernels against the plain "
        f"versions, the experts each token takes held to the kernel run's "
        f"choice: {err:.3e} of the largest probability (tol "
        f"{TOL['bfloat16']['o']}); K2 {fwd_launches['K2']}; left free, "
        f"the plain run routes {flips} of "
        f"{sum(int(i.numel()) for i in pin.ids)} (token, k) choices to "
        f"another expert (bf16 near-ties) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19a", "the MoE forward's kernels disagree with "
                                 "the plain versions")

    f32 = moe_lm(models, dtype="float32").init(SEED)
    f32.params = tree.clone(net.params)
    cpu = moe_lm(models, dtype="float32", device="cpu").init(SEED)
    cpu.params = tree.tree_map(lambda t: t.cpu(), net.params)
    with pinned_routing(torch, moe) as pin:
        y_card = f32.output(x4[:2]).cpu()
        pin.replay()
        y_cpu = cpu.output(x4[:2])
    cpu_err = float((y_card - y_cpu).abs().max())
    with pinned_routing(torch, moe) as free:
        cpu.output(x4[:2])
    flips = routing_differences(torch, pin.ids, free.ids)
    log(f"moe: f32 forward on the card against the CPU, [2, 512], the "
        f"experts held to the card's choice: {cpu_err:.3e} (tol 1e-4); "
        f"left free, the CPU routes {flips} (token, k) choices otherwise "
        f"-> {'ok' if cpu_err <= 1e-4 else 'FAIL'}")
    if not cpu_err <= 1e-4:
        raise PhaseFailed("19a", "the f32 MoE LM on the card disagrees with "
                                 "the CPU")
    p = {k: v.detach().float().requires_grad_()
         for k, v in net.params["blk0_moe"].items()}
    x = torch.randn(c["batch"] * c["seq"], m["d_model"], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    kw = dict(top_k=m["top_k"], activation="gelu")
    routed = moe.moe_apply_routed(
        p, x, capacity_factor=m["n_experts"] / m["top_k"], **kw)
    dense = moe.moe_apply_dense(p, x, **kw)
    g_r = torch.autograd.grad((routed ** 2).sum(), list(p.values()))
    g_d = torch.autograd.grad((dense ** 2).sum(), list(p.values()))
    r_err = float((routed - dense).detach().abs().max())
    g_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(g_r, g_d))
    ok = r_err <= MOE_ROUTED_ATOL and g_err <= 1e-4
    log(f"moe: routed (capacity factor {m['n_experts'] / m['top_k']}) "
        f"against dense, blk0's params, N={x.shape[0]} f32: output "
        f"{r_err:.3e} (atol {MOE_ROUTED_ATOL}), gradients {g_err:.3e} of "
        f"the largest (tol 1e-4) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19a", "the routed MoE disagrees with the dense "
                                 "oracle at ample capacity")
    del f32, cpu, p, x, routed, dense, g_r, g_d

    step_ms, peak = cuda_steps(torch, lambda: net.fit(ds), MOE_TIMED)
    idle, busy, top = profiled(torch, lambda: net.fit(ds),
                               "moe profile (one step)")
    dense_net = models.transformer_lm(
        vocab_size=c["vocab_size"], d_model=c["d_model"],
        n_heads=c["n_heads"], n_layers=c["n_layers"], d_ff=c["d_ff"],
        max_length=c["seq"], dtype="bfloat16", device="cuda").init(SEED)
    dense_ms, dense_peak = cuda_steps(torch, lambda: dense_net.fit(ds),
                                      MOE_TIMED)
    del dense_net
    fpt = transformer_moe_flops_per_token(
        m["vocab_size"], m["d_model"], m["n_layers"], m["n_experts"],
        m["top_k"], m["d_expert_hidden"], c["seq"])
    tok_s = c["batch"] * c["seq"] / (step_ms / 1e3)
    rec = {"step_ms": step_ms, "tokens_per_s": tok_s,
           "mfu": fpt * tok_s / PEAK_BF16_FLOPS, "peak_mib": peak,
           "idle_profiled": idle, "kernel_ms": busy,
           "idle_median": None if busy is None else 1 - busy / step_ms,
           "top5": top, "dense_step_ms": dense_ms,
           "dense_peak_mib": dense_peak, "vs_dense_ratio": step_ms / dense_ms,
           "flops_per_token": fpt}
    log(f"moe: step {step_ms:.3f} ms (median CUDA-event time of "
        f"{MOE_TIMED} fit() steps) -> {tok_s:.1f} tokens/s; MFU "
        f"{rec['mfu']:.5f} ({fpt} FLOPs a token against "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); peak device memory "
        f"{peak:.1f} MiB; device idle share of the profiled step "
        f"{'not measured' if idle is None else f'{idle:.4f}'}"
        + ("" if busy is None else f", of the median step "
           f"{rec['idle_median']:.4f}") + f"; the dense flagship's step in "
        f"this call {dense_ms:.3f} ms ({dense_peak:.1f} MiB): "
        f"vs_dense_ratio {rec['vs_dense_ratio']:.4f}; card {card}")
    return launches, rec


def remat_check(torch, counters, DataSet, card):
    """19b: one step's gradients of the MoE LM with dropout 0.1 (input,
    attention and expert) with remat and without, from the same seeds:
    bit for bit; K2 = 12 with remat (the forward and its recompute);
    peak memory of each."""
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.training import loss_and_grads

    c, L = TRAIN, MOE_LM["n_layers"]
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    out = {}
    for remat in (False, True):
        net = moe_lm(models, dropout=0.1, remat=remat).init(SEED)
        batch = net._batch_dict(net._to_mds(ds))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counters.reset()
        loss, _, grads = loss_and_grads(net._loss, net.params, net.state,
                                        net._generator, batch)
        torch.cuda.synchronize()
        out[remat] = dict(loss=loss.detach(), grads=grads,
                          launches=counters.read(),
                          peak=(torch.cuda.max_memory_allocated() - base)
                          / 2**20)
        # a second step, timed: the first paid for imports and warm-up
        t0 = time.perf_counter()
        loss_and_grads(net._loss, net.params, net.state, net._generator,
                       batch)
        torch.cuda.synchronize()
        out[remat]["ms"] = (time.perf_counter() - t0) * 1e3
        del net, batch
    a, b = out[False], out[True]
    diff = [k for (k, g), (_, h) in zip(tree.leaves(a["grads"]),
                                         tree.leaves(b["grads"]))
            if not torch.equal(g, h)]
    same = torch.equal(a["loss"], b["loss"]) and not diff
    want = {"K2": 2 * L, "K6": L, "K8": 1, "K9": 1}
    got = {k: b["launches"][k] for k in want}
    ok = same and got == want and b["peak"] < a["peak"]
    log(f"remat: loss {float(a['loss']):.6f} / {float(b['loss']):.6f}, "
        f"gradients bit for bit {same} (differ: {diff[:4]}); launches "
        f"with remat {got} (expected {want}), without "
        f"{ {k: a['launches'][k] for k in want} }; peak device memory "
        f"above the step's start {a['peak']:.1f} MiB without, "
        f"{b['peak']:.1f} MiB with ({1 - b['peak'] / a['peak']:.4f} "
        f"saved); host clock of a second step {a['ms']:.3f} / "
        f"{b['ms']:.3f} ms; card {card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19b", "remat's gradients, launches or memory")
    return b["launches"], {"peak_mib": a["peak"], "remat_peak_mib": b["peak"],
                           "ms": a["ms"], "remat_ms": b["ms"]}


def char_stream(rng, rows, length, V):
    """`rows` sequences of `length` symbols from a first-order Markov
    chain over V symbols with sparse (Dirichlet 0.05) transition rows,
    drawn with numpy: text with something to learn, in place of the
    example's corpus."""
    cum = np.cumsum(rng.dirichlet(np.full(V, 0.05), size=V), axis=1)
    out = np.empty((rows, length), np.int64)
    out[:, 0] = rng.integers(0, V, rows)
    u = rng.random((rows, length))
    for t in range(1, length):
        nxt = (u[:, t, None] > cum[out[:, t - 1]]).sum(1)
        out[:, t] = np.minimum(nxt, V - 1)
    return out


def char_conf(conf, layer="GravesLSTM", n_layers=2):
    b = (conf.NeuralNetConfiguration.builder().seed(12345).learning_rate(0.1)
         .updater("rmsprop").rms_decay(0.95).l2(1e-3).weight_init("xavier")
         .list())
    n_in = CHAR["vocab"]
    for _ in range(n_layers):
        b = b.layer(getattr(conf, layer)(n_in=n_in, n_out=CHAR["hidden"],
                                         activation="tanh"))
        n_in = CHAR["hidden"]
    b = b.layer(conf.RnnOutputLayer(n_in=n_in, n_out=CHAR["vocab"],
                                    activation="softmax",
                                    loss_function="mcxent"))
    return (b.backprop_type("truncated_bptt")
            .t_bptt_forward_length(CHAR["tbptt"])
            .t_bptt_backward_length(CHAR["tbptt"]).build())


def _cpu_twin(torch, net):
    """The same network on the CPU with the card's params."""
    from deeplearning4j_tpu_torch.nn import tree

    twin = type(net)(net.conf, device="cpu").init()
    twin.params = tree.tree_map(lambda t: t.cpu(), net.params)
    return twin


def train_char_model(torch, DataSet, card):
    """19c: the GravesLSTM character model at the example's width:
    3 fit() batches (60 TBPTT segments), the f32 forward against the
    CPU, rnn_time_step in three chunks against the full forward, 4
    samples of 300 characters, the time a segment and a profiled
    segment's idle share; GRU and the bidirectional LSTM at 200 units,
    one forward each against the CPU."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    V, B, T = CHAR["vocab"], CHAR["batch"], CHAR["seq"]
    rng = np.random.default_rng(SEED)
    eye = np.eye(V, dtype=np.float32)
    seqs = char_stream(rng, B * (CHAR["batches"] + 1), T + 1, V)
    sets = [DataSet(eye[s[:, :-1]], eye[s[:, 1:]])
            for s in np.split(seqs, CHAR["batches"] + 1)]
    net = MultiLayerNetwork(char_conf(conf), device="cuda").init()
    stamps = []

    class Segments:
        def iteration_done(self, model, iteration):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            stamps.append((e, model._score_raw))

    net.set_listeners(Segments())
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(sets[:CHAR["batches"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(s) for _, s in stamps]
    n_seg = CHAR["batches"] * T // CHAR["tbptt"]
    seg_ms = statistics.median(a.elapsed_time(b) for (a, _), (b, _) in
                               zip(stamps[1:], stamps[2:]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = (len(losses) == n_seg and net.iteration_count == n_seg
          and all(np.isfinite(losses)) and last < first
          and finite_params(torch, net))
    log(f"char: {CHAR['batches']} fit() batches of [{B}, {T}], {len(losses)}"
        f" TBPTT segments of {CHAR['tbptt']} in {wall:.2f} s; mean loss of "
        f"the first 5 segments {first:.4f}, of the last 5 {last:.4f}; "
        f"params finite; card {card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19c", "the char model's training check failed")
    net.set_listeners()
    x = sets[-1].features[:4, :300]
    full = net.output(x)
    cpu_err = float((full[:, :200].cpu()
                     - _cpu_twin(torch, net).output(x[:, :200])).abs().max())
    net.rnn_clear_previous_state()
    parts = torch.cat([net.rnn_time_step(x[:, :100]),
                       net.rnn_time_step(x[:, 100])[:, None],
                       net.rnn_time_step(x[:, 101:])], dim=1)
    stream_err = float((parts - full).abs().max())
    ok = cpu_err <= 1e-4 and stream_err <= STREAM_TOL
    log(f"char: f32 forward on the card against the CPU ([4, 200]) "
        f"{cpu_err:.3e} (tol 1e-4); rnn_time_step in chunks of 100, 1 and "
        f"199 against the full forward {stream_err:.3e} (tol {STREAM_TOL})"
        f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19c", "the char model's forward or stream "
                                 "disagrees")
    samples = sample_chars(torch, net, rng)
    for i, s in enumerate(samples):
        log(f"char: sample {i}: {s!r}")
    ok = (len(samples) == CHAR["samples"]
          and all(len(s) == CHAR["sample_len"] for s in samples))
    if not ok:
        raise PhaseFailed("19c", "sampling did not give 4 x 300 characters")
    seg = DataSet(sets[-1].features[:, :CHAR["tbptt"]],
                  sets[-1].labels[:, :CHAR["tbptt"]])
    idle, busy, top = profiled(torch, lambda: net.fit(seg),
                               "char profile (one segment)")
    chars_s = B * CHAR["tbptt"] / (seg_ms / 1e3)
    log(f"char: {seg_ms:.3f} ms a TBPTT segment (median CUDA-event time "
        f"between segments) -> {chars_s:.1f} characters/s; device idle "
        f"share of a profiled segment "
        f"{'not measured' if idle is None else f'{idle:.4f}'}; card {card}")
    errs_other = {}
    for layer in ("GRU", "GravesBidirectionalLSTM"):
        other = MultiLayerNetwork(char_conf(conf, layer, 1),
                                  device="cuda").init()
        errs_other[layer] = float((other.output(x[:, :200]).cpu()
                                   - _cpu_twin(torch, other).output(
                                       x[:, :200])).abs().max())
    ok = all(e <= 1e-4 for e in errs_other.values())
    log(f"char: one forward at 200 units against the CPU {errs_other} (tol "
        f"1e-4) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19c", "GRU or the bidirectional LSTM disagrees "
                                 "with the CPU")
    return {"segment_ms": seg_ms, "chars_per_s": chars_s,
            "idle_profiled": idle, "kernel_ms": busy, "top5": top,
            "first_loss": first, "last_loss": last,
            "cpu_err": cpu_err, "stream_err": stream_err}


def sample_chars(torch, net, rng):
    """The example's sampling: a random first character a sample, then
    one rnn_time_step a character, each drawn from the output
    distribution with numpy."""
    V, n = CHAR["vocab"], CHAR["samples"]
    eye = np.eye(V, dtype=np.float32)
    cur = rng.integers(0, V, n)
    out = [[] for _ in range(n)]
    net.rnn_clear_previous_state()
    for _ in range(CHAR["sample_len"]):
        probs = net.rnn_time_step(eye[cur]).double().cpu().numpy()
        cum = np.cumsum(probs / probs.sum(1, keepdims=True), axis=1)
        cur = np.minimum((rng.random(n)[:, None] > cum).sum(1), V - 1)
        for i, ch in enumerate(cur):
            out[i].append(CHARSET[ch])
    net.rnn_clear_previous_state()
    return ["".join(s) for s in out]


def train_rest(torch, DataSet, card):
    """19d: LION and LAMB on the flagship at phase 6's shape, the three
    line-search solvers on LeNet-5, greedy pretraining of an AutoEncoder
    and an RBM, a NetworkLayer in a graph, and early stopping of LeNet-5
    with both savers."""
    import tempfile

    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import core as es
    from deeplearning4j_tpu_torch.nn import conf, tree
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.nested import NetworkLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    rec = {}
    for updater, lr in (("lion", 1e-4), ("lamb", 1e-2)):
        net = models.transformer_lm(
            vocab_size=c["vocab_size"], d_model=c["d_model"],
            n_heads=c["n_heads"], n_layers=c["n_layers"], d_ff=c["d_ff"],
            max_length=c["seq"], dtype="bfloat16", learning_rate=lr,
            device="cuda")
        net.conf.conf.updater = updater
        for v in net.layer_vertices.values():
            v.layer.updater = updater
        net.init(SEED)
        losses = []
        for _ in range(5):
            net.fit(ds)
            losses.append(net.score_value)
        ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
              and finite_params(torch, net))
        rec[updater] = losses
        log(f"rest: {updater} (lr {lr}) 5 fit() steps of the flagship, "
            f"losses {[round(x, 4) for x in losses]} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed("19d", f"{updater} did not lower the loss")

    mnist = image_data("lenet5", 512, 1).next()
    for algo in ("lbfgs", "conjugate_gradient", "line_gradient_descent"):
        net = models.lenet5(dtype="float32", device="cuda")
        net.conf.conf.optimization_algo = algo
        net.conf.conf.iterations = 5
        net.init(SEED)
        s0 = net.score(mnist)
        t0 = time.perf_counter()
        net.fit(mnist)
        torch.cuda.synchronize()
        s1 = net.score(mnist)
        ok = np.isfinite(s1) and s1 < s0
        rec[algo] = [s0, s1]
        log(f"rest: LeNet-5 by {algo}, 5 iterations on a batch of 512 (f32)"
            f": score {s0:.4f} -> {s1:.4f} in {time.perf_counter() - t0:.2f}"
            f" s ({net.iteration_count} iterations); card {card} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed("19d", f"{algo} did not lower the score")

    stack = (conf.NeuralNetConfiguration.builder().seed(SEED)
             .learning_rate(0.1).updater("sgd").weight_init("xavier").list()
             .layer(conf.AutoEncoder(n_in=784, n_out=500,
                                     activation="sigmoid"))
             .layer(conf.RBM(n_in=500, n_out=250))
             .layer(conf.OutputLayer(n_in=250, n_out=10,
                                     activation="softmax",
                                     loss_function="mcxent"))
             .pretrain(True).backprop(False).build())
    net = MultiLayerNetwork(stack, device="cuda").init()
    it = MnistDataSetIterator(128, num_examples=128 * 8)
    x = torch.as_tensor(it.next().features, device="cuda")
    ae, rbm = net.impls[0], net.impls[1]

    def recon():
        with torch.no_grad():
            p0, p1 = net.params["layer_0"], net.params["layer_1"]
            a = float(ae.pretrain_loss(net.layer_confs[0], p0, x, None))
            h = ae.encode(net.layer_confs[0], p0, x)
            v = rbm._prop_down(net.layer_confs[1], p1,
                               rbm._prop_up(net.layer_confs[1], p1, h))
            return a, float(((v - h) ** 2).mean())

    before = recon()
    t0 = time.perf_counter()
    net.fit(it, epochs=1)
    net.pretrain(it, epochs=2)
    after = recon()
    ok = after[0] < before[0] and after[1] < before[1]
    rec["pretrain"] = [before, after]
    log(f"rest: greedy pretraining 784-500-250 (AutoEncoder then RBM CD-1,"
        f" batch 128, 8 batches, 3 epochs) in "
        f"{time.perf_counter() - t0:.2f} s: AutoEncoder reconstruction loss"
        f" {before[0]:.4f} -> {after[0]:.4f}, RBM mean-field reconstruction"
        f" error {before[1]:.5f} -> {after[1]:.5f}; card {card} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19d", "pretraining did not lower the losses")

    inner = (conf.NeuralNetConfiguration.builder().seed(SEED).list()
             .layer(conf.DenseLayer(n_in=784, n_out=256, activation="relu",
                                    weight_init="xavier"))
             .layer(conf.DenseLayer(n_in=256, n_out=128, activation="tanh",
                                    weight_init="xavier"))
             .build())
    g = (conf.NeuralNetConfiguration.builder().seed(SEED).learning_rate(0.1)
         .updater("sgd").weight_init("xavier").graph_builder()
         .add_inputs("in")
         .add_layer("mlp", NetworkLayer(conf=inner), "in")
         .add_layer("out", conf.OutputLayer(n_in=128, n_out=10,
                                            activation="softmax",
                                            loss_function="mcxent"), "mlp")
         .set_outputs("out").build())
    gnet = ComputationGraph(g, device="cuda").init()
    flat = MnistDataSetIterator(512, num_examples=512).next()
    losses = []
    for _ in range(3):
        gnet.fit(flat)
        losses.append(gnet.score_value)
    on_card = all(t.is_cuda for _, t in tree.leaves(gnet.params))
    ok = (on_card and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and set(gnet.params["mlp"]) == {"layer_0", "layer_1"})
    log(f"rest: NetworkLayer (MLP 784-256-128) in a graph, 3 fit() steps, "
        f"losses {[round(v, 4) for v in losses]}, params on the card "
        f"{on_card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed("19d", "the nested network did not train")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_es_") as d:
        mem, disk = es.InMemoryModelSaver(), es.LocalFileModelSaver(d)

        class Both(es.ModelSaver):
            def save_best_model(self, n, score):
                mem.save_best_model(n, score)
                disk.save_best_model(n, score)

            def get_best_model(self):
                return mem.get_best_model()

        net = models.lenet5(dtype="float32", device="cuda").init(SEED)
        cfg = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(
                image_data("lenet5", 512, 1, train=False)),
            model_saver=Both(),
            epoch_terminations=[es.MaxEpochsTerminationCondition(3)])
        res = es.EarlyStoppingTrainer(cfg, net,
                                      image_data("lenet5", 512, 4)).fit()
        best = disk.get_best_model()
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree.leaves(best.params), tree.leaves(res.best_model.params)))
        ok = (same and res.total_epochs == 3
              and len(res.score_vs_epoch) == 3 and best.device.type == "cuda")
        log(f"rest: early stopping of LeNet-5 (4 batches of 512, 3 epochs): "
            f"{res.termination_reason}/{res.termination_details}, scores "
            f"{ {k: round(v, 4) for k, v in res.score_vs_epoch.items()} }, "
            f"best epoch {res.best_model_epoch}; the best model from both "
            f"savers bit for bit {same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed("19d", "early stopping's savers disagree")
    return rec


def train_nn_rest(torch, counters, fa, DataSet, card):
    """Phase 19: the rest of nn/ (19a-19d). Returns the launches of the
    MoE LM's training runs (19a's fit_scanned, 19b's remat step)."""
    t0 = time.perf_counter()
    a, moe_rec = train_moe(torch, counters, fa, DataSet, card)
    b, remat_rec = remat_check(torch, counters, DataSet, card)
    char_rec = train_char_model(torch, DataSet, card)
    rest_rec = train_rest(torch, DataSet, card)
    log("nn_rest: " + json.dumps({"card": card, "moe": moe_rec,
                                  "remat": remat_rec, "char": char_rec,
                                  "rest": rest_rec}))
    log(f"nn rest: phase 19 in {time.perf_counter() - t0:.1f} s")
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


# ----------------------------------------------------------------- main

# ------------------------------------------------------------------ A/B

# ------------------------------------------------------------ phase 20

W2V_PIPELINE = dict(chunk=2048, group=4)
# bench.py W2V_QUALITY_RATIO: the pipeline's separation on the
# sub-corpus must keep this share of the host path's
W2V_QUALITY_RATIO = 0.95
# bench.py EMBED_DIMS: the serving half of bench mode `embed`
EMBED_SERVE = dict(vocab=131072, dim=64, n_partitions=1024, n_clusters=1024,
                   lattice=(1, 4, 16, 128), k=10, recall_floor=0.95,
                   query_batch=128, qps_reps=20, seed=1)
# BlogCatalog (the DeepWalk paper's dataset): 10,312 vertices, 333,983
# edges, 39 groups; a planted-partition graph of that size stands in,
# with the paper's d = 128 and walk length 40 and two cuts for time:
# window 5 (paper 10) and 1 walk per vertex (paper 80)
BLOGCATALOG = dict(vertices=10312, edges=333983, groups=39, p_in=0.8,
                   vector_size=128, walk_length=40, window=5,
                   walks_per_vertex=1)
# ParagraphVectors DBOW on the 8000-sentence sub-corpus, each sentence a
# document labelled by its topic; nearest_labels top-1 over 200 held-out
# sentences (chance 1/20). The floor is set from a CPU run of this same
# configuration (1.0000 there; the card takes the same host draws from
# the same init), with room for the card's other sum order
PV_MIN_ACCURACY = 0.90
PV_HELD_OUT = 200
# GloVe on the same sub-corpus; epochs cut from the JAX default 25 to 5
GLOVE = dict(layer_size=100, window_size=15, x_max=100.0, alpha=0.75,
             batch_size=4096, learning_rate=0.05, epochs=5, seed=1)
# card against CPU at a tiny size, f32: the same inputs and draws; the
# card's index_add_ sums duplicate rows in another order (its atomics),
# and its matmuls round in another order -> 1e-5 of the largest entry
TINY_TOL = 1e-5


def topic_of(sentence):
    """The planted topic of a topic_corpus sentence (word i belongs to
    topic i % 20)."""
    return f"t{int(sentence[0][1:]) % 20}"


def cpu_draws(torch, dp):
    """Patch `dp.draw_update` to draw on a CPU generator seeded like the
    given one and move the draws to the tables' device: the card and
    the CPU then train on the same draws. Returns the restore hook."""
    real = dp.draw_update

    def draws(gen, u, J, q, **kw):
        g = torch.Generator().manual_seed(1000 + u)
        b, negs = real(g, u, J.cpu(), q.cpu(), **kw)
        return b.to(J.device), negs.to(J.device)

    dp.draw_update = draws
    return lambda: setattr(dp, "draw_update", real)


def max_rel(torch, a, b):
    a = torch.as_tensor(np.asarray(a)).double()
    b = torch.as_tensor(np.asarray(b)).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def tiny_word2vec_pipeline(torch, Word2Vec, dp):
    """The pipeline at a tiny size on the card and on the CPU from the
    same tables and draws (SGNS shared, per pair, CBOW)."""
    sents = topic_corpus(np.random.default_rng(5), 400, 6000, 12)
    worst = 0.0
    restore = cpu_draws(torch, dp)
    try:
        for kw in ({}, {"share": False}, {"cbow": True}):
            out = []
            for dev in ("cuda", "cpu"):
                b = (Word2Vec.builder().layer_size(16).window_size(3)
                     .negative_sample(4).epochs(1).seed(2)
                     .use_device_pipeline(True).device(dev))
                if kw.get("cbow"):
                    b = b.elements_learning_algorithm("cbow")
                if "share" in kw:
                    b = b.share_negatives(False)
                m = b.build()
                m.pipeline_chunk, m.pipeline_group = 128, 2
                m.fit(sents)
                out.append((m.lookup_table.vectors(), m.loss_history))
            worst = max(worst, max_rel(torch, out[0][0], out[1][0]),
                        max_rel(torch, out[0][1], out[1][1]))
    finally:
        restore()
    return worst


def word2vec_pipeline(torch, Word2Vec, dp, host_rate, card):
    """20a: bench.py `bench_word2vec` on the port's device pipeline."""
    from torch.profiler import ProfilerActivity, profile

    worst = tiny_word2vec_pipeline(torch, Word2Vec, dp)
    log(f"20a: tiny pipeline card vs CPU (SGNS shared and per pair, CBOW; "
        f"same tables and draws): max error {worst:.3e} of the largest "
        f"entry (tol {TINY_TOL})")
    if not worst <= TINY_TOL:
        raise PhaseFailed("20a", "the pipeline on the card disagrees with "
                                 "the CPU")
    t0 = time.perf_counter()
    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000, 25)
    n_words = sum(len(s) for s in sents)
    w2v = (Word2Vec.builder().layer_size(128).window_size(5)
           .min_word_frequency(1).negative_sample(5)
           .use_device_pipeline(True).epochs(1).seed(1).device("cuda")
           .build())
    w2v.pipeline_chunk = W2V_PIPELINE["chunk"]
    w2v.pipeline_group = W2V_PIPELINE["group"]
    w2v.build_vocab(sents)
    log(f"20a: corpus and vocab in {time.perf_counter() - t0:.3f} s")
    pack_s = [0.0]
    w2v._corpus_flat_indices = _timed(w2v._corpus_flat_indices, pack_s)
    w2v.fit(sents)                       # warm fit
    w2v.word_vector("w0")
    torch.cuda.synchronize()
    pack_s[0] = 0.0
    t0 = time.perf_counter()
    w2v.fit(sents)                       # timed fit: repack + the epoch
    w2v.word_vector("w0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = n_words / wall
    sep = topic_separation(w2v)
    losses = w2v.loss_history
    log(f"20a: pipeline chunk {W2V_PIPELINE['chunk']} x group "
        f"{W2V_PIPELINE['group']}: {n_words} words in {wall:.4f} s -> "
        f"{rate:.1f} words/s ({rate / host_rate:.2f}x phase 10's host "
        f"path at {host_rate:.1f} words/s); host packing "
        f"{pack_s[0]:.4f} s ({pack_s[0] / wall:.4f} of the fit); "
        f"{len(losses) // 2} updates a fit; loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; topic separation after the first timed fit "
        f"{sep:.4f}; card {card}")
    if not all(np.isfinite(losses)):
        raise PhaseFailed("20a", "a pipeline loss is not finite")

    sub = sents[:W2V_SENTENCES]

    def quality(**kw):
        b = (Word2Vec.builder().layer_size(128).window_size(5)
             .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
             .device("cuda"))
        for k, v in kw.items():
            getattr(b, k)(v)
        m = b.build()
        m.build_vocab(sub)
        m.fit(sub)
        return m

    q_dev = topic_separation(quality(use_device_pipeline=True))
    q_unshared = topic_separation(quality(use_device_pipeline=True,
                                          share_negatives=False))
    q_host = topic_separation(quality(use_device_pipeline=False))
    log(f"20a: sub-corpus separation: pipeline defaults (chunk 512, group "
        f"2) {q_dev:.4f}, unshared negatives {q_unshared:.4f}, host path "
        f"{q_host:.4f}; ratio {q_dev / q_host:.4f} (gate "
        f">= {W2V_QUALITY_RATIO})")
    if not q_dev >= W2V_QUALITY_RATIO * q_host:
        raise PhaseFailed("20a", f"pipeline separation {q_dev:.4f} < "
                                 f"{W2V_QUALITY_RATIO} x host {q_host:.4f}")
    cbow = quality(use_device_pipeline=True,
                   elements_learning_algorithm="cbow")
    cl = cbow.loss_history
    log(f"20a: CBOW pipeline: {len(cl)} updates, loss {cl[0]:.6f} -> "
        f"{cl[-1]:.6f}; separation {topic_separation(cbow):.4f}")
    if not (all(np.isfinite(cl)) and cl[-1] < cl[0]):
        raise PhaseFailed("20a", "the CBOW pipeline's loss did not fall")

    m = (Word2Vec.builder().layer_size(128).window_size(5)
         .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
         .use_device_pipeline(True).device("cuda").build())
    m.build_vocab(sub)
    m.fit(sub)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.fit(sub)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    device_profile(torch, prof, pwall,
                   "20a: pipeline profile (sub-corpus fit, defaults)")
    return rate


def embed_clustered_corpus(rng, v, d, n_clusters):
    """bench.py `_embed_clustered_corpus`: a table snapshot with cluster
    structure."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, v)
    noise = 0.15 * rng.normal(size=(v, d))
    return (centers[assign] + noise).astype(np.float32)


def tiny_ann(torch, ann):
    """A small index built and searched on the card and on the CPU:
    the same partitions and ids, scores within TINY_TOL."""
    vecs = embed_clustered_corpus(np.random.default_rng(3), 2048, 32, 32)
    q = vecs[::97]
    out = []
    for dev in ("cuda", "cpu"):
        idx = ann.DeviceANNIndex.build(vecs, n_partitions=32, seed=0,
                                       device=dev)
        ids, scores = idx.search(q, 10, nprobe=4)
        out.append((idx.part_ids.cpu(), ids.cpu(), scores.cpu()))
    same = bool(torch.equal(out[0][0], out[1][0])
                and torch.equal(out[0][1], out[1][1]))
    return same, max_rel(torch, out[0][2], out[1][2])


def serve_embeddings(torch, engine, card):
    """20b: bench mode `embed`'s serving half on phase 11's engine."""
    import json as _json
    import urllib.request

    from deeplearning4j_tpu_torch.embedding import ann
    from deeplearning4j_tpu_torch.embedding.engine import EngineLookupView
    from deeplearning4j_tpu_torch.embedding.serving import (
        EmbeddingServingEngine,
    )
    from deeplearning4j_tpu_torch.serving import BucketLattice
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder
    from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition

    same, err = tiny_ann(torch, ann)
    log(f"20b: tiny index card vs CPU: partitions and ids equal {same}, "
        f"scores max error {err:.3e} (tol {TINY_TOL})")
    if not (same and err <= TINY_TOL):
        raise PhaseFailed("20b", "the index on the card disagrees with the "
                                 "CPU")
    E = EMBED_SERVE
    v, d, q, k = E["vocab"], E["dim"], E["query_batch"], E["k"]
    rng = np.random.default_rng(0)
    vecs = embed_clustered_corpus(rng, v, d, E["n_clusters"])
    view = EngineLookupView(engine)
    view.set_vectors(vecs)
    rec = Recorder()
    t0 = time.perf_counter()
    serve = EmbeddingServingEngine(
        view, n_partitions=E["n_partitions"],
        lattice=BucketLattice(batch_sizes=E["lattice"]), k_grid=(k,),
        recall_floor=E["recall_floor"], calibration_queries=q,
        seed=E["seed"], recorder=rec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serve.start()
    tc0 = serve.trace_count
    log(f"20b: index of {v} x {d} in {serve.index.n_partitions} partitions "
        f"of capacity {serve.index.capacity} built in {build_s:.4f} s; "
        f"nprobe {serve.nprobe} (calibrated recall "
        f"{serve.calibrated_recall:.4f}); warmup {serve.warmup_s} s; "
        f"shapes {tc0}")
    ids = np.asarray(rng.choice(v, size=16, replace=False), np.int64)
    req = serve.submit_embed(ids)
    if not req.wait(60.0) or req.error:
        raise PhaseFailed("20b", f"/embed failed: {req.error}")
    embed_err = float(np.abs(req.result["vectors"] - vecs[ids]).max())
    queries = vecs[np.random.default_rng(17).choice(v, size=q,
                                                    replace=False)]
    t0 = time.perf_counter()
    for _ in range(E["qps_reps"]):
        req = serve.submit_search(queries, k)
        if not req.wait(120.0) or req.error:
            raise PhaseFailed("20b", f"/search failed: {req.error}")
    ann_dt = time.perf_counter() - t0
    ann_qps = E["qps_reps"] * q / ann_dt
    table = torch.from_numpy(vecs).cuda()
    qt = torch.from_numpy(queries).cuda()
    b_ids, _ = ann.brute_force_topk(table, qt, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(E["qps_reps"]):
        b_ids, _ = ann.brute_force_topk(table, qt, k)
    torch.cuda.synchronize()
    brute_qps = E["qps_reps"] * q / (time.perf_counter() - t0)
    recall = ann.recall_at_k(req.result["ids"], b_ids.cpu().numpy())
    new_shapes = serve.trace_count - tc0

    server = ServingServer(serve).start()
    try:
        def post(route, payload):
            r = urllib.request.Request(
                f"{server.url}{route}", data=_json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=60) as resp:
                return _json.loads(resp.read())

        h_embed = post("/embed", {"ids": ids.tolist()})
        h_search = post("/search", {"vectors": queries.tolist(), "k": k})
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=30) as r:
            metrics = parse_exposition(r.read().decode())
    finally:
        server.stop()
    http_embed_err = float(np.abs(np.float32(h_embed["vectors"])
                                  - vecs[ids]).max())
    http_recall = ann.recall_at_k(np.asarray(h_search["ids"]),
                                  b_ids.cpu().numpy())
    series = sorted(m for m in metrics if m.startswith("serving_embedding_")
                    and ("_count" in m or "bytes" in m) and metrics[m] > 0)
    retraces = serve.trace_count - tc0
    log(f"20b: /embed 16 rows max error {embed_err:.3e} (HTTP "
        f"{http_embed_err:.3e}); /search {E['qps_reps']} x {q} queries: "
        f"recall@{k} {recall:.4f} (HTTP {http_recall:.4f}; "
        f"floor {E['recall_floor']}); ANN {ann_qps:.1f} queries/s, brute "
        f"force {brute_qps:.1f} queries/s, ratio {ann_qps / brute_qps:.4f} "
        f"(no gate: bench.py's 5x floor was swept on a virtual CPU mesh); "
        f"new shapes after warmup {new_shapes} in process, {retraces} after "
        f"HTTP; served {serve.served}, failed {serve.failed}; metrics "
        f"{series}; card {card}")
    failures = []
    if not (embed_err <= 1e-6 and http_embed_err <= 1e-6):
        failures.append("/embed rows differ from the published ones")
    if not (recall >= E["recall_floor"]
            and http_recall >= E["recall_floor"]):
        failures.append(f"recall {recall} / {http_recall} below the floor")
    if retraces or serve.failed:
        failures.append(f"{retraces} new shapes, {serve.failed} failures")
    want = {"serving_embedding_gather_seconds_count",
            "serving_embedding_ann_probe_seconds_count",
            'serving_embedding_bytes_total{span="gather"}',
            'serving_embedding_bytes_total{span="ann_probe"}'}
    if not want <= set(series):
        failures.append(f"missing metrics {sorted(want - set(series))}")
    if failures:
        raise PhaseFailed("20b", "; ".join(failures))
    return ann_qps, brute_qps, build_s


def planted_partition(rng, B):
    """A BlogCatalog-sized planted-partition graph: every vertex gets one
    edge to a vertex of its group, then edges join two vertices of one
    group with probability p_in, else two random vertices."""
    from deeplearning4j_tpu_torch.graph import Graph

    n, m = B["vertices"], B["edges"]
    group = rng.integers(0, B["groups"], n)
    members = [np.flatnonzero(group == g) for g in range(B["groups"])]
    src = np.concatenate([np.arange(n), rng.integers(0, n, m - n)])
    inside = np.concatenate([np.ones(n, bool),
                             rng.random(m - n) < B["p_in"]])
    dst = np.empty(m, np.int64)
    for i in range(m):
        if inside[i]:
            pool = members[group[src[i]]]
            dst[i] = pool[rng.integers(len(pool))]
        else:
            dst[i] = rng.integers(n)
    g = Graph(n)
    for a, b in zip(src.tolist(), dst.tolist()):
        if a != b:
            g.add_edge(a, b)
    return g, group


def tiny_deepwalk(torch):
    from deeplearning4j_tpu_torch.graph import DeepWalk

    out = []
    for dev in ("cuda", "cpu"):
        g, _ = planted_partition(np.random.default_rng(4), dict(
            vertices=60, edges=400, groups=3, p_in=0.8))
        dw = DeepWalk(vector_size=16, window_size=3, seed=2, device=dev)
        dw.fit(g, walk_length=10)
        out.append((dw.vectors.lookup_table.vectors(),
                    dw.vectors.loss_history))
    return max(max_rel(torch, out[0][0], out[1][0]),
               max_rel(torch, out[0][1], out[1][1]))


def deepwalk_blogcatalog(torch, card):
    """20c: DeepWalk at BlogCatalog's size through the engine (HS)."""
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.graph import deepwalk as dw_mod

    err = tiny_deepwalk(torch)
    log(f"20c: tiny DeepWalk card vs CPU (same walks and init): max error "
        f"{err:.3e} (tol {TINY_TOL})")
    if not err <= TINY_TOL:
        raise PhaseFailed("20c", "DeepWalk on the card disagrees with the "
                                 "CPU")
    B = BLOGCATALOG
    t0 = time.perf_counter()
    g, group = planted_partition(np.random.default_rng(0), B)
    graph_s = time.perf_counter() - t0
    dw = DeepWalk(vector_size=B["vector_size"], window_size=B["window"],
                  seed=0, device="cuda")
    walk_s = [0.0]
    real_walks = dw_mod.walk_sequences
    dw_mod.walk_sequences = _timed(real_walks, walk_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        dw.fit(g, walk_length=B["walk_length"],
               walks_per_vertex=B["walks_per_vertex"])
        torch.cuda.synchronize()
    finally:
        dw_mod.walk_sequences = real_walks
    fit_s = time.perf_counter() - t0
    tokens = B["vertices"] * (B["walk_length"] + 1) * B["walks_per_vertex"]
    steps = dw.vectors.loss_history
    vecs = dw.vectors.lookup_table.vectors()
    rows = np.array([dw.vectors.vocab.index_of(str(i))
                     for i in range(B["vertices"])])
    x = vecs[rows] / np.linalg.norm(vecs[rows], axis=1, keepdims=True)
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, B["vertices"], (2, 20000))
    cos = (x[a] * x[b]).sum(1)
    same = cos[group[a] == group[b]].mean()
    cross = cos[group[a] != group[b]].mean()
    log(f"20c: graph of {g.num_vertices()} vertices, {g.num_edges()} edges, "
        f"{B['groups']} groups in {graph_s:.3f} s; fit {fit_s:.4f} s "
        f"(the walks of length {B['walk_length']} {walk_s[0]:.4f} s of it; "
        f"HS through the engine, window {B['window']}) -> "
        f"{tokens / fit_s:.1f} walk tokens/s, {len(steps)} steps, loss "
        f"{steps[0]:.6f} -> {steps[-1]:.6f}; same-group cosine "
        f"{same:.4f}, cross-group {cross:.4f}; cuts from the paper: window "
        f"5 (10), 1 walk per vertex (80); card {card}")
    if not (np.isfinite(steps).all() and same > cross):
        raise PhaseFailed("20c", f"same-group cosine {same} <= cross-group "
                                 f"{cross}")


def tiny_paragraph_vectors(torch, ParagraphVectors, sents):
    out = []
    docs = [" ".join(s) for s in sents]
    labels = [topic_of(s) for s in sents]
    for dev in ("cuda", "cpu"):
        pv = ParagraphVectors(layer_size=16, window_size=3, negative=4,
                              seed=2, batch_size=256, device=dev)
        pv.fit(docs, labels)
        out.append((pv.lookup_table.vectors(), pv.loss_history,
                    pv.infer_vector(docs[0])))
    return max(max_rel(torch, a, b) for a, b in zip(*out))


def paragraph_vectors(torch, card):
    """20d: ParagraphVectors DBOW on the sub-corpus, topic labels."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )

    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000, 25)
    err = tiny_paragraph_vectors(torch, ParagraphVectors, sents[:300])
    log(f"20d: tiny DBOW card vs CPU (same init and host draws): max error "
        f"{err:.3e} (tol {TINY_TOL})")
    if not err <= TINY_TOL:
        raise PhaseFailed("20d", "ParagraphVectors on the card disagrees "
                                 "with the CPU")
    sub, held = sents[:W2V_SENTENCES], sents[W2V_SENTENCES:
                                             W2V_SENTENCES + PV_HELD_OUT]
    pv = ParagraphVectors(layer_size=128, window_size=5, negative=5,
                          epochs=1, seed=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pv.fit([" ".join(s) for s in sub], [topic_of(s) for s in sub])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = sum(pv.nearest_labels(" ".join(s), 1)[0] == topic_of(s)
               for s in held)
    infer_s = time.perf_counter() - t0
    acc = hits / len(held)
    hs = ParagraphVectors(layer_size=128, window_size=5, negative=0,
                          epochs=1, seed=1, device="cuda")
    hs.fit([" ".join(s) for s in sub[:1000]],
           [topic_of(s) for s in sub[:1000]])
    vec = hs.infer_vector(" ".join(held[0]))
    log(f"20d: DBOW fit on {len(sub)} documents ({len(pv.labels)} labels) "
        f"in {fit_s:.4f} s ({sum(len(s) for s in sub) / fit_s:.1f} words/s); "
        f"nearest_labels top-1 on {len(held)} held-out sentences "
        f"{acc:.4f} (floor {PV_MIN_ACCURACY}, chance 0.05) in "
        f"{infer_s:.4f} s; HS infer_vector norm "
        f"{float(np.linalg.norm(vec)):.4f}; card {card}")
    if not acc >= PV_MIN_ACCURACY:
        raise PhaseFailed("20d", f"accuracy {acc} < {PV_MIN_ACCURACY}")
    if not (np.isfinite(vec).all() and np.abs(vec).sum() > 0):
        raise PhaseFailed("20d", "HS infer_vector is not a finite vector")


def tiny_glove(torch, gl, sents):
    perm_gen = {}

    def perm(gen, n, device):
        g = perm_gen.setdefault("g", torch.Generator().manual_seed(9))
        return torch.randperm(n, generator=g).to(device)

    real = gl.draw_permutation
    gl.draw_permutation = perm
    out = []
    try:
        for dev in ("cuda", "cpu"):
            perm_gen.clear()
            g = gl.Glove(layer_size=16, window_size=5, epochs=2, seed=2,
                         batch_size=512, device=dev)
            g.fit(sents)
            out.append((g.lookup_table.vectors(), g.loss_history))
    finally:
        gl.draw_permutation = real
    return max(max_rel(torch, a, b) for a, b in zip(*out))


def train_glove(torch, card):
    """20e: GloVe on the sub-corpus, epochs cut from 25 to 5."""
    from deeplearning4j_tpu_torch.nlp import glove as gl

    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000,
                         25)[:W2V_SENTENCES]
    err = tiny_glove(torch, gl, sents[:200])
    log(f"20e: tiny GloVe card vs CPU (same init and permutations): max "
        f"error {err:.3e} (tol {TINY_TOL})")
    if not err <= TINY_TOL:
        raise PhaseFailed("20e", "GloVe on the card disagrees with the CPU")
    G = GLOVE
    g = gl.Glove(device="cuda", **G)
    g.build_vocab(sents)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g.fit(sents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_epoch = np.reshape(g.loss_history, (G["epochs"], -1)).sum(1)
    n_triples = len(g.loss_history) // G["epochs"] * G["batch_size"]
    train_s = wall - g.cooccurrence_seconds
    sep = topic_separation(SimpleNamespace(word_vector=g.get_word_vector))
    log(f"20e: GloVe ({G}) on {len(sents)} sentences: co-occurrence "
        f"counting on the host {g.cooccurrence_seconds:.4f} s, "
        f"{n_triples} padded triples an epoch, {G['epochs']} epochs in "
        f"{train_s:.4f} s -> {G['epochs'] * n_triples / train_s:.1f} "
        f"triples/s; loss by epoch {np.round(per_epoch, 4).tolist()}; "
        f"topic separation {sep:.4f}; cut from the JAX default: 5 epochs "
        f"(25); card {card}")
    if not (np.isfinite(per_epoch).all() and (np.diff(per_epoch) < 0).all()):
        raise PhaseFailed("20e", f"the loss did not fall epoch over epoch: "
                                 f"{per_epoch}")
    if not sep > 0:
        raise PhaseFailed("20e", f"topic separation {sep} <= 0")


def train_embeddings_rest(torch, counters, Word2Vec, engine, host_rate,
                          card):
    """Phase 20: the rest of embeddings and NLP (20a-20e)."""
    from deeplearning4j_tpu_torch.nlp import device_pipeline as dp

    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    word2vec_pipeline(torch, Word2Vec, dp, host_rate, card)
    serve_embeddings(torch, engine, card)
    deepwalk_blogcatalog(torch, card)
    paragraph_vectors(torch, card)
    train_glove(torch, card)
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"phase 20 in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches} (K13 only in 20a's host-path model, as in phase 10)")
    if launches["K13"] != W2V_STEPS or any(
            n for k, n in launches.items() if k != "K13"):
        raise PhaseFailed(20, f"launches {launches}, expected K13 = "
                              f"{W2V_STEPS} and no other kernel")
    return launches


def ab_turn(root):
    """One turn of `--ab`: phase 6 with the port of the checkout at
    `root`, in this process; prints its result as one JSON line."""
    import torch

    sys.path.insert(0, str(root))
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_flops_per_token,
        transformer_flops_per_token_executed,
        transformer_lm,
    )
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_neg_softmax as fns
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    if not Path(fsx.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"chip_smoke: imported {fsx.__file__}, not the "
                         f"port of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build()
    build_s = time.perf_counter() - t0
    card = nvidia_smi("name,power.limit")
    flops = tuple(f(TRAIN["vocab_size"], TRAIN["d_model"], TRAIN["n_layers"],
                    TRAIN["d_ff"], TRAIN["seq"])
                  for f in (transformer_flops_per_token,
                            transformer_flops_per_token_executed))
    _, stats = train_flagship(torch, Counters(fa, fsx, fns, fln, fsm),
                              transformer_lm, DataSet, flops, card)
    print(json.dumps({"root": str(root), "card": card, "build_s": build_s,
                      **stats}), flush=True)


def ab(other):
    """`--ab OTHER`: phase 6 (the flagship training step, its launch
    counts checked) with the port of the checkout at OTHER against this
    checkout's, on one card, in turns: other, this, this, other. Each
    turn is its own process that imports the port from its checkout and
    runs this file's phase 6 on it. Prints each turn's log and JSON
    line, then the step time and kernel time of both checkouts, two
    turns each."""
    turns = []
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--ab-turn",
             str(root)], stdout=subprocess.PIPE, text=True, timeout=900)
        log(proc.stdout.rstrip())
        if proc.returncode:
            log(f"ab: the turn of {root} failed ({proc.returncode})")
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    log(f"ab: card {turns[0]['card']}")
    for key in ("step_ms", "kernel_ms"):
        log(f"ab: {key}: other ({other}) {[turns[0][key], turns[3][key]]}, "
            f"this ({ROOT}) {[turns[1][key], turns[2][key]]}")
    return 0


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] not in ("--ab", "--ab-turn")):
        print("usage: chip_smoke.py [--ab OTHER_CHECKOUT]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if args:
        root = Path(args[1]).resolve()
        if args[0] == "--ab-turn":
            ab_turn(root)
            return 0
        return ab(root)
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
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)
    from deeplearning4j_tpu_torch.telemetry import Recorder

    started = time.perf_counter()
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
    tc_reports = 0
    for src, out in outputs.items():
        for line in build_report(out):
            log(f"build: {src}: {line}")
            spill = SPILL.search(line)
            if TC_KERNEL.search(line) and spill:
                tc_reports += 1
                if any(int(n) for n in spill.groups()):
                    raise PhaseFailed(1, f"a kernel that must not spill "
                                         f"(tcf, tcx, lnv, smp) spills: "
                                         f"{line}")
    if outputs and not tc_reports:
        raise PhaseFailed(1, "the build log reports no tensor-core kernel's "
                             "spills")

    records = check_kernels(torch, fa, name_power)
    records.update(check_flash_backward(torch, fa, name_power))
    chunked_err = check_chunked(torch, fa, name_power)
    records.update(check_xent(torch, fsx, name_power))
    records.update(check_neg_softmax(torch, fns))
    records.update(check_layernorm(torch, fln))
    records.update(check_sampling(torch, fsm))
    counters = Counters(fa, fsx, fns, fln, fsm)
    net, _, prompts, serve_launches = serve_flagship(
        torch, counters, transformer_lm, GenerationEngine, BucketLattice,
        Recorder, name_power)
    oracle_launches = oracle_f32(torch, counters, net, transformer_lm,
                                 GenerationEngine, BucketLattice)
    time_steps(torch, net)
    profile_serving(torch, net, GenerationEngine, BucketLattice, prompts)
    http_launches = serve_http_arms(torch, counters, net, GenerationEngine,
                                    BucketLattice, name_power)
    speculative_oracle(torch, net, transformer_lm, GenerationEngine,
                       BucketLattice)
    del net
    flops = tuple(f(TRAIN["vocab_size"], TRAIN["d_model"], TRAIN["n_layers"],
                    TRAIN["d_ff"], TRAIN["seq"])
                  for f in (transformer_flops_per_token,
                            transformer_flops_per_token_executed))
    train_launches, _ = train_flagship(torch, counters, transformer_lm,
                                       DataSet, flops, name_power)
    mode_launches, _ = train_bench_modes(
        torch, counters, transformer_lm, DataSet, fa,
        transformer_flops_per_token_executed, name_power)
    other_launches = train_other_paths(torch, counters, transformer_lm,
                                       DataSet, fsx)
    grad_oracle(torch, counters, transformer_lm, DataSet, fa, fsx)
    w2v_launches, host_rate = train_word2vec(torch, counters, Word2Vec,
                                             name_power)
    engine_launches, engine = train_engine(torch, counters,
                                           ShardedEmbeddingEngine, name_power)
    engine_oracle(torch, counters, ShardedEmbeddingEngine, fns)
    replay_launches = speculative_replay(torch, counters, name_power)
    train_image_models(torch, counters, name_power)
    predict_launches = serve_predict_fleet(torch, counters, fa, name_power)
    nn_launches = train_nn_rest(torch, counters, fa, DataSet, name_power)
    emb_launches = train_embeddings_rest(torch, counters, Word2Vec, engine,
                                         host_rate, name_power)
    log(f"chip_smoke: phases 1-20 in {time.perf_counter() - started:.1f} s")
    # every path above runs head dims the kernels take: none may have
    # been sent to the dense attention for its head dim
    log(f"dense routes for a head dim no kernel takes: {fa.DENSE_ROUTES}")
    if fa.DENSE_ROUTES["head_dim"]:
        raise PhaseFailed("3-20", f"{fa.DENSE_ROUTES['head_dim']} attention "
                              "calls on the card took the dense path")

    # one entry per TPU kernel, timed at the heaviest shape a path gives
    # it (K12 at the flagship's slots x vocab with both filters, the
    # replay's microbench block beside it); launches summed over the
    # paths' runs (serving, its f32 oracle, the HTTP arms, flagship
    # training, the three bench modes, the other training paths,
    # Word2Vec, the engine, the speculative replay, the predict path's
    # flagship windows, the MoE LM's training runs and phase 20's
    # host-path Word2Vec), each counted from 0 just before it and read
    # just after. K1-K7 carry their dropout
    # arm at the same shape, K4/K5 their dlse arm's device time, K1/K5
    # the chunked check's largest error.
    runs = (serve_launches, oracle_launches, http_launches, train_launches,
            mode_launches, other_launches, w2v_launches, engine_launches,
            replay_launches, predict_launches, nn_launches, emb_launches)
    launches = {k: sum(run.get(k, 0) for run in runs)
                for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                          "K9", "K10", "K11", "K12", "K13")}
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
             "K12": "[4,10000] float32 T=1.0 top_k=8 top_p=0.9",
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
        "K12": ("fused sampling (_sample_pallas -> _sample_kernel)",
                "sampling.cu", "deeplearning4j_tpu/ops/fused_sampling.py"
                ":121"),
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
            **{k: rec[k] for k in ("device_ms", "library_device_ms",
                                   "device_ms_by_kernel") if k in rec},
            **{arm: {"max_abs_err": rec[arm]["err"],
                     **{k: v for k, v in rec[arm].items() if k != "err"}}
               for arm in ("dropout", "dlse") if arm in rec}})
        if kern in ("K1", "K5"):
            kernels[-1]["chunked_max_rel_err"] = chunked_err
        if kern == "K10":
            kernels[-1]["host_us"] = rec["host_us"]
        if kern == "K12":
            # beside the headline: the replay's microbench block, and the
            # temperature-only mode against the Gumbel argmax call
            for key, label in (
                    ("replay_block", "[8,128] float32 T=1.0 top_k=8 "
                                     "top_p=0.9"),
                    ("temperature_only", "[4,10000] float32 T=1.0")):
                other = next(r for r in records[kern] if r["label"] == label)
                kernels[-1][key] = {k: v for k, v in other.items()
                                    if k != "err"}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
