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
early stopping), the rest of embeddings and NLP (the Word2Vec device
pipeline, ANN serving over /embed and /search, DeepWalk,
ParagraphVectors, GloVe), data and sequence parallelism at one rank
(DataParallelTrainer's two arms, ParameterAveragingTrainer, ring
attention, SequenceParallelTrainer, the pipelined fit), and the graph
vertices, the MultiLayerNetwork decode steps, tensor and expert
parallelism and ZeRO-1, pipeline parallelism, resharding and the
placement search, and the elastic fleet (ElasticSupervisor with an
injected kill, parameter averaging through the ClusterCoordinator), the
sharded embedding engine and the data meshes of the device pipeline and
GloVe, the cost and memory telemetry with the CLI (train, test,
predict and serve as processes of their own, ModelSerializer zips), and
kernel autotuning (the tuning table and the kerneltune sweep), KMeans
and t-SNE over word vectors and the training UI, the port's own
trace tools, profiler, JAX zips resuming with their updater, and the
native IO core, and the rest of the data loaders (Iris, LFW, Curves,
image records, the async, multiple-epoch and sampling iterators, the
disk queue) fed into fits, and the rest of the parallel compositions
(sequence parallelism with tensor and with pipeline parallelism,
resuming into another placement, the split net's decode, the solvers
under a mesh).

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
21. Data and sequence parallelism (after phase 20) at world size 1 over
   NCCL on the one card (the card runs one rank: an NCCL communicator
   holds one rank a card). 21a: phase 6's batch through
   `DataParallelTrainer` for 3 steps, the monolithic arm and the overlap
   arm at each bucket size of bench.py's `OVERLAP_BUCKET_SWEEP` (64 KiB,
   256 KiB, 1 GiB) each bit for bit the meshless net's (the mean
   all-reduce of one rank is a copy and a division by 1, the bucket
   mean a lossless f32 round trip) with phase 6's K2/K6/K8/K9 counts for
   3 steps; each arm's bucket count and median CUDA-event step beside
   the meshless step's. 21b: one forward and backward of ResNet-20 in
   f64 as a data shard of one rank (batch-norm sums and the masked
   loss's count all-reduced over NCCL) against the meshless one within
   1e-9 of the largest gradient; then
   bench mode `resnet_dp`'s three arms at one rank on ResNet-20 (batch
   64, f32): monolithic, overlap (256 KiB) and
   ParameterAveragingTrainer(averaging_frequency=1); steps/s and the
   ratios, no gate; every arm's loss falls. 21c: ring attention through
   the in-process transport, q, k, v [4, 2, 4096, 128] bf16 in 4 blocks
   of 1024, forward and backward against the whole-sequence K1/K5
   within TOL["bfloat16"] (gradients within REL_TOL), exactly 10 K1 and
   10 K5 launches (4 diagonal and 6 full hops, 6 skipped); f32 at [1, 2,
   512, 64] within 1e-4; dropout 0.1 with one step seed against the
   whole-sequence kernel with that seed; the process-group ring at world
   size 1 (one diagonal hop); head dim 96 at [1, 4, 2048, 96] bf16,
   which takes the f32 einsum ring and launches no kernel, against
   `sequence_sharded_attention_reference`; the ring's and the
   whole-sequence kernels' forward + backward times. 21d: `SequenceParallelTrainer` on
   the flagship at bench mode `longcontext`'s dims (T 4096, batch 4,
   bf16), 3 steps: the loss falls, and the params and every loss equal
   plain fit's from the same init bit for bit (at T 4096 plain fit runs
   K1/K5 over the whole sequence; a ring of one shard is one diagonal
   hop of the same kernels), the same launches, the step time. 21e: fit
   of the flagship over 5 batches through `iter_prefetched` (depth 2)
   against the synchronous loop, bit for bit, with the input_wait p50
   and p99.
22. The graph vertices, the MultiLayerNetwork decode steps, tensor and
   expert parallelism and ZeRO-1 (after phase 21). 22a: a graph of
   embedding (vocab 10000, d 256), causal self-attention (2 heads of
   128, K2/K6 with a key padding mask), a dense branch merged beside
   it, a Subset across both, LastTimeStep on the input's mask, dense and
   softmax, trained 3 SGD steps at batch 32 x 512 in bf16 against the
   same graph on the CPU through the plain versions from the same init
   and batches (step losses and params within VGRAPH_LOSS_TOL /
   VGRAPH_PARAM_TOL; exactly 3 K2 and 3 K6). 22b: a MultiLayerNetwork
   transformer stack at the flagship's width (6 blocks, f32) served
   through GenerationEngine, 32 greedy tokens for 4 prompts each the
   argmax of the full forward (near-ties under ORACLE_MARGIN_TOL
   excepted), then a sampled run through its prefill and decode steps
   with K12 (exactly 32 launches, every draw in its row's top 8). 22c:
   at world size 1 over NCCL, the flagship under {"data": 1, "model":
   1}, the MoE LM at bench width under {"data": 1, "expert": 1} and the
   flagship under zero1=True, each bit for bit the meshless net after 3
   steps with phase 6's counts. 22d: the flagship's block 0 over 2
   model shards in one process (`InProcessShards`; K2 and K6 on one head
   of 128 a shard, exactly 2 each) and the MoE LM's MoE layer over 2
   and 4 expert shards, each against the whole layer in bf16 with an
   f32 reference: the split arm's largest relative error over the
   output and every gradient at most SPLIT_RATIO times the whole
   arm's; each arm's forward + backward time; K2 and K6 at a shard's
   shape timed beside their bounds.
23. Pipeline parallelism and the resharding engine (after phase 22), at
   world size 1 over NCCL. 23a: phase 6's flagship, 3 steps an arm:
   "pipe" 1 at M = 1 bit for bit with the meshless net and phase 6's
   counts; M = 8 at "pipe" 1 and over 2 and 3 stages in one process
   with exactly 6·M·3 K2 and K6 and M·3 K8 and K9, their f32 twins
   within PIPE_PARITY_TOL of the meshless net; each arm's step, idle
   share and the bubble S cards would idle; K2/K6 (packed B 4) and
   K8/K9 (N 2048) at a microbatch's shape against their plain versions
   in f32 and bf16 at phase 2's tolerances, then timed. 23b: the params
   moved between 2 "model" shards in one process and one, both ways,
   bit for bit, each move's bytes its plan's; a {data, model}
   checkpoint restored into {pipe} reading its plan's bytes, one step
   bit for bit with a twin, then re-placed by set_mesh on the record.
   23c: `search_placement` on FleetShape(1, 1), its winner trained 3
   steps bit for bit, and `reshard/bench_arm` in its own process.

24. The elastic fleet and the sharded embedding engine (after phase
   23). 24a: phase 6's flagship trained 6 steps by ElasticSupervisor at
   world size 1 over NCCL (this file re-invoked as `--elastic-worker`), a
   checkpoint a step, uninterrupted and with `p0:kill@step3`: the killed
   generation's replacement adopts rank 0 through the supervisor's
   coordinator, restores step 3 and ends bit for bit on the uninterrupted
   run's params, the launches summed over the generations equal its
   (6 steps of phase 6's counts), the journal holds both generations and
   the `reform` event; each generation's wall time, the replacement's
   resume_from(target_mesh=...) time (placement included) and its
   restore's record (its `reshard_plan`; where the placement splits a
   leaf, the `reshard` span's seconds and bytes read, the plan's or the
   phase fails; else the whole checkpoint's bytes), the replacement's
   start-to-first-step time. 24b: two
   `run_elastic_worker` processes (`--average-worker`) average the
   flagship through a ClusterCoordinator on the card, 3 rounds on half
   of phase 6's rows each, worker 1 killed at its second round and
   restarted from its checkpoint (a ModelSerializer zip the worker
   rewrites after every round): both end bit for bit equal, worker 0
   bit for bit with two nets averaged in numpy in this process (worker
   1's restored from the checkpoint its restart resumed from), the
   restarted one resumed at its checkpoint's step; one worker through a
   coordinator equals plain fit bit for bit; a round's seconds; two
   processes (`--build-worker`) on an empty kernel cache build
   neg_softmax.cu once (`cuda_build`'s file lock). 24c:
   bench mode `embed`'s train half (131,072 x 64, batch 1024, 20 steps)
   through the engine at ep = 1, ep = 2 and 4 and dp = 2 as shards in
   one process: table bytes a shard 1/ep of ep = 1's, one K13 launch a
   step, tables within ENGINE_SHARD_TOL of ep = 1, pairs/s; an /embed
   round trip over the ep = 2 engine returns its rows exactly; K13 at
   B=1024 K=5 D=64 f32 against its plain version and timed. 24d: 20a's
   device pipeline and 20e's GloVe (one epoch) with "data" = 2 in one
   process within MESH_TOL of their meshless runs, the sub-corpus
   separation at least 0.95 of phase 20a's host path's; words/s and
   triples/s beside phases 20a and 20e.
25. The cost and memory telemetry, ModelSerializer zips and the CLI
   (after phase 24; each `python -m deeplearning4j_tpu_torch.cli` a
   process on the card, its default device). 25a: a synthetic 3-class
   CSV (4096 rows x 64 features, from SEED) through `cli train` with
   DL4J_TPU_TELEMETRY set and DL4J_TPU_MEM_EVERY=1, then `cli test` and
   `cli predict` together: a `memory` event a step with the card's
   bytes_in_use <= peak_bytes_in_use < bytes_limit, a `cost` event,
   test's accuracy at least 0.9, and predict's CSV equal, byte for byte,
   to `ModelSerializer.restore(zip).output` in this process on the card.
   25b: the flagship LM (bf16) written as a zip and served by `cli serve
   --generate-slots 4` on a 1x512 lattice (the prefill's flat flash
   forward, K1): greedy /generate requests equal this process's
   GenerationEngine on the same zip token for token; /metrics'
   serving_mfu_live in (0, 1] and serving_hbm_live_bytes > 0; /stats'
   peak_flops 989e12 and the server's own K1 launches > 0. /generate is
   greedy in both packages, so `cli serve` launches no K12. 25c: the
   cost book's flops of the flagship's forward (one [1, 512] bucket of
   InferenceEngine's warmup) and training step (32 x 512) equal
   `lm_counted_flops`; the forward's and the step's MFU; the step's
   peak_temp_bytes against max_memory_allocated; `reconcile` emits a
   `cost_drift` event with the measured peak. `--phase 25` runs the
   build and this phase alone.
26. Autotuning, clustering and the UI (`tuning_clustering_ui`). 26a:
   `port_tools/kerneltune.py --quick` as a process on the card (its
   table valid, every chosen params a default or a candidate that passed
   its plain-version check, exactly one `chosen` `kernel_tune` event an
   entry in its telemetry file and no unregistered span name); the
   checked-in table's resolved params for K9 at N = 16384 and 2048 (V
   10000, d 256), K11 at 16384 x 256, K12 at [4, 10000] and [8, 128] and the chunk tile at T = 32768 (D 128, causal,
   with and without dropout and the mask), each checked against its
   plain version at phases 2b/9/13/2c's limits and timed against the
   heuristic's params (forced by `autotune.override`) in turns (table,
   default, default, table; CUDA events behind a sleep, L2 warm); with
   DL4J_TPU_TUNING=off every resolution equals the heuristic; one
   flagship training step under the table with exact launch counts.
   26b: the word vectors of phase 20a's host-path model (under `--phase
   26` trained first): KMeansClustering (k = 10) over the whole
   vocabulary on the card (distortion never rising, the memberships
   within KMEANS_MEMBERSHIP_TOL of a CPU run of the port from the same
   start), exact Tsne over 2000 of them (1000 iterations, perplexity
   30: the KL falling, the time a step), BarnesHutTsne over 300 (100
   iterations, host; a spawned process started after phase 20, beside
   phases 21-26, read here) and a VPTree search equal to brute force.
   26c: a
   UiServer; 3 flagship training steps with the histogram, flow and
   activation listeners posting over HTTP; /weights, /flow,
   /activations and /tsne (26b's coordinates posted to /tsne/coords)
   render (200, the SVG renderer and the posted data in the page: the
   SVG is drawn in the browser, as the JAX package's pages do);
   /nearestneighbors/query on 26b's vectors equal to brute force; and
   /timeline over phase 25's telemetry (under `--phase 26`, that of
   26a's flagship step) listing spans. `--phase 26` runs the build and this phase alone.
27. Tracing the port without the JAX package, JAX zips resuming, the
   native IO core (`tracing_and_resume`). 27a: phase 6's flagship
   trained 6 fit() steps with a Recorder under
   `util/profiler.ProfilerIterationListener(start_iteration=2,
   n_iterations=3)`: exact launch counts (K2 = K6 = 36, K8 = K9 = 6),
   exactly one `profiler_trace` span, its Chrome trace holding the
   flash (`tcf::`) and softmax-xent (`tcx::`) kernels; the net saved by
   the Checkpointer; then `port_tools/tracetool.py` stats, check,
   export --perfetto, tree and mem in a process of their own (no jax, no
   torch imported) over that log and over phases 18c's and 24a's (their
   injected faults make stragglers, so `check` gates on retraces there);
   each exits 0 and the Perfetto JSON loads. 27b: `port_tools/
   trafficreplay.py --generate --checkpoint` of 27a's checkpoint (the
   flagship, prompts of 8-32, 16 new tokens) as a process on the card:
   exit 0, requests ok, its telemetry clean under `tracetool check`.
   27c: the committed JAX zip (tests/fixtures/torch_port/, a narrow LM
   at T 512 the JAX package trained 3 Adam steps) restored on the card
   with `updater_restored` True, 3 more steps through K1/K4 (exact
   counts) within ADAM_ATOL of the JAX continuation stored beside it,
   while the same zip with a fresh updater, or unstepped, ends outside
   it; and the flagship written as a zip
   whose updater is the JAX package's flat-view `updater.npz`, restored
   through the mapping with its Adam state bit for bit and stepped 3
   more times bit for bit with the original (K2/K6/K8/K9 exact). 27d:
   `native.available()`; phase 25a's CSV through `to_matrix` equal bit
   for bit to the per-record path; 20a's corpus as raw strings encoded
   by `native.encode_corpus` with the Python split's ids (both timed);
   20a's host-path Word2Vec fit on raw strings, one K13 launch a step.
   `--phase 27` runs the build and this phase alone.
28. The rest of datasets/ and util/ fed into fits
   (`datasets_and_utils`). 28a: `IrisDataSetIterator(150)` (the port's
   own copy of the Iris CSV) feeding a 4-16-3 MLP (tanh, softmax,
   mcxent, Adam) on the card through `MultipleEpochsIterator(200, ...)`,
   and from the same init through `SamplingDataSetIterator(iris, 32,
   150 x 200)`: accuracy on the 150 at least 0.95 in each arm, each
   arm's seconds and steps/s. 28b: LFW at its usual training subset's
   size (62 people; 48 synthetic 64 x 64 x 3 images each through
   `generate_synthetic_lfw`, with Pillow or, without it, the PNM codec,
   which the log names), split 0.8 / 0.2 by
   `LocalUnstructuredDataFormatter` (directory labels), a LeNet-style
   net (conv 20 5x5, pool, conv 50 5x5, pool, dense 500, softmax 62)
   trained 3 epochs at batch 64 through
   `AsyncDataSetIterator(ImageRecordReaderDataSetIterator(
   ImageRecordReader(split/train), shuffle=True))`: the loss smoothed by
   `time_series.moving_average` falls, test accuracy (`eval/`) above
   0.16 (10 x chance), and one test file through
   `ImageVectorizer(...).normalize()` and `net.output` equal to its row
   of the batched output within VECTORIZER_ATOL; seconds to synthesize,
   split, read and train. 28c: phase 6's flagship fed 4 fixed token
   batches (after a `DiskBasedQueue` round trip that must return them
   equal) twice over by `MultipleEpochsIterator(2, AsyncDataSetIterator(
   ListDataSetIterator(batches), queue_size=2))` and, from the same
   init, by a plain `ListDataSetIterator` of the same 8 batches: exactly
   K2 = K6 = 48 and K8 = K9 = 8 in each arm, the final params bit for
   bit, each arm's step median. 28d: `CurvesDataSetIterator(100,
   10000)` (cut from the paper's 20,000) feeding greedy CD-1
   pretraining of the curves RBM stack 784-400-200-100-50-25-6 on the
   card, one epoch a layer: each layer's reconstruction error of its
   input falls from its initial params to its trained ones; the
   synthesis seconds apart from the card's. `--phase 28` runs the build
   and this phase alone.
29. The rest of A7, at world size 1 over NCCL and in one process
   (`compositions`). 29a: the flagship at bench mode longcontext's dims
   (T 4096, batch 4, bf16) under {"seq": 1, "model": 1} bit for bit
   with plain fit and with its launches; block 0's attention over 2
   model shards, each a ring of 4 blocks of 1024 on its head, against
   the whole layer with an f32 reference (exactly 20 K1 and 20 K5).
   29b: {"pipe": 1, "seq": 1} at M = 1 bit for bit with the meshless
   net at the same dims; 2 in-process stages with a ring of 2 blocks in
   each, M = 4, with and without a labels mask: launches stated before
   the run, f32 twins within PIPE_PARITY_TOL of the meshless nets. 29c:
   `resume_from(target_mesh=..., target_axes=...)` of a {"data": 1,
   "model": 1} flagship checkpoint into {"pipe": 1}, and of an MLP's
   into a ZeRO-1 placement: the bytes read are the plan's, one step bit
   for bit with a whole restore then set_mesh (24a's workers restore
   through it too). 29d: the serving flagship split over 2 model shards
   in this process through GenerationEngine, greedy tokens held to the
   whole net's full forward, a sampled run of exactly 32 K12 launches,
   each shard's cache half the whole's. 29e: LeNet-5 by LBFGS under
   {"data": 1} bit for bit with the meshless solve (deterministic
   cuDNN; a failure reports two meshless solves' distance beside the
   difference). `--phase 29` runs the build and this phase alone.
30. The port's graftlint on the card (`graftlint_on_card`): (a)
   `port_tools/graftlint.py --check --stage ast` and `--stage
   concurrency` over the port, each a process of its own that must exit
   0 (`lint_on_card`); (b) every entry of analysis/op_audit.py (the JAX
   audit's 16: the flash variants, the chunked tier at T = 4096, the
   fused LayerNorm and softmax-xent head at the JAX audit's shapes, and
   the train step of each LM bench mode at its full dims in bf16) run
   once to warm and once recorded (`op_audit_on_card`), each printed
   with its aten ops (and those of its backward), launches by kernel,
   host syncs (op and port frame, `torch.cuda.set_sync_debug_mode`'s
   included) and milliseconds; (c) it fails if an entry takes the dense
   attention path, launches none of a group of its expected kernels, or
   breaks J001 (outside the budget's known syncs), J002 (the "cuda"
   bounds of analysis/op_budget.json) or J003; (d) the collective
   audit's five entries (analysis/collective_audit.py) with CUDA tensors
   as simulated ranks of torch's fake process group, each signature the
   frozen one with no C003, and C13's check: a split `shard_generator`
   of a CUDA generator makes no sync (`collectives_on_card`); (e) the
   precision audit's 21 entries (analysis/precision_audit.py: 30b's
   recorded calls and the five extras, which launch K12 and K13) against
   the "cuda" section of analysis/precision_budget.json with no P
   finding, the bf16 LM steps' product dtypes among the JAX package's
   (`precision_on_card`). `--phase 30` runs the build and this phase
   alone.
31. A split net served in lockstep (`lockstep_and_benchdiff`): (a) the
   serving flagship (f32, 29d's net) placed with a "model" role over a
   one-rank NCCL group, served by GenerationEngine in lockstep (each
   step's plan broadcast over the group first, serving/lockstep.py): 29d's
   4 greedy prompts, each token the whole net's full-forward argmax, and
   one sampled request (top-k 8, top-p 0.9) of exactly 32 K12 launches,
   each token among the whole net's 8 most likely at its position;
   the prefill launches K1, the worker retires at the stop plan; tokens/s
   and latencies go into a SERVE artifact; (b) port_tools/benchdiff.py
   over that artifact against itself exits 0, and against a copy with its
   p50 doubled exits 1 naming that row. `--phase 31` runs it alone.
32. The example twins (`examples_on_card`): each script of
   examples/torch/ (the eight of examples/, against the port) as a
   process of its own (`--example-worker SCRIPT OUT`), four at a time on
   the card, to its end, with the envelopes its layers ask wrapped to
   record what they took (`record_envelopes`), after K1 and K4 at the
   sequence-parallel twin's ring hop (f32, head dim 16, which only the
   f32 kernels take) against their plain versions; it fails if one exits
   non-zero, takes the dense attention path or the einsum ring for want
   of a kernel at its head dim, or launches none of the
   flash forward kernels where an envelope took an attention call or a
   ring (the backward kernels where that call ran under autograd), or
   none of K8 (K9) where fused_softmax_xent.supports took its output
   head.
   Each one's seconds and launches by kernel are logged. `--phase 32`
   runs it alone.

After phases 3-24, no attention call on the card may have taken the
dense path for a head dim no flash kernel takes (`DENSE_ROUTES`).

The last lines are a `{"kernels": [...]}` JSON line (K1-K13; K12 at
[4, 10000] with top_k 8 and top_p 0.9, the replay's [8, 128] and the
temperature-only mode beside it; K13's `embed` entry at bench mode
embed's engine shape; K1, K5, K9, K11 and K12 with 26a's `tuned`
launch params against the heuristic's), the
card's name and power limit as nvidia-smi gives them, and `{"ok": true,
"device": ...}`. With no CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
            # the tile the chunked tier resolves (a tuning table's
            # flash_chunk entry, or pick_chunk)
            tile = fa.resolve_chunk(c["seq"], c0["d_model"] // c0["n_heads"],
                                    True, bool(c["attention_dropout"]),
                                    c["masked"])
            log(f"train {mode}: the chunked tier's tile {tile}")
            n = c["seq"] // tile
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
            lib = lambda: torch.sigmoid(torch.bmm(  # noqa: E731
                torch.cat([pos[:, None], neg], 1), c[..., None]))
            lib_ms = time_ms(torch, lib)
            lib_dev_ms = kernel_device_ms(torch, lib)
            # c, pos, neg read and both scores written once; 2 (K+1) D
            # FLOPs per row
            bound_ms, bound_by = bound((2 * B * D + B * K * D + B * (K + 1))
                                       * 4, 2 * (K + 1) * B * D, dname)
            log(f"time  K13 neg_softmax {label} f32: kernel {ms:.4f} ms "
                f"(device time {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
                f"sigmoid(bmm) {lib_ms:.4f} ms (device time "
                f"{fmt_ms(lib_dev_ms)}), bound {bound_ms:.5f} ms "
                f"({bound_by})")
            records.append(dict(label=label, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                library_device_ms=lib_dev_ms,
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
            # K11: min(264, N / 8) blocks of 8-row warps (or the tuning
            # table's blocks), or partials of 64 rows
            want_bwd = (want_plan, fln.bwd_blocks(N, C) if want_plan
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
        want = ((1, (1, fln.bwd_blocks(N, C))) if C == 256
                else (0, (0, -(-N // 64))))
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
    # the autoscaling arm's log (the kill and the hot swap), which phase
    # 27a's tools read
    TRACES["18c fleet replay"] = f"{tpath}.autoscale"
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
# what phase 20 measured that phase 24 reports beside its own: the host
# path's topic separation on the sub-corpus, 20a's words/s, 20e's
# triples/s
PHASE20 = {}
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
    host_model = quality(use_device_pipeline=False)
    q_host = topic_separation(host_model)
    # phase 26b clusters the host-path model's vectors
    PHASE20.update(host_separation=q_host, pipeline_words_s=rate,
                   host_model=host_model)
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
    PHASE20["glove_triples_s"] = G["epochs"] * n_triples / train_s
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


# ------------------------------------------------------------ phase 21

# bench.py OVERLAP_BUCKET_SWEEP: the overlap arm's bucket sizes
OVERLAP_BUCKETS = (64 * 1024, 256 * 1024, 1 << 30)
DP_STEPS = 3
DP_TIMED = 5
# bench.py bench_resnet_dp: batch 64, 8 batches a round; rounds cut to 3
RESNET_DP = dict(batch=64, n_batches=8, rounds=3)
# phase 2's BH = 8, T = 4096 shape as [B, H, T, D], cut into 4 blocks
RING = dict(B=4, H=2, T=4096, D=128, n=4)
RING_F32 = dict(B=1, H=2, T=512, D=64, n=4)
# a head dim no flash kernel is built for (d_model 384 over 4 heads): the
# ring takes the f32 einsum route on the card (ring_route)
RING_D96 = dict(B=1, H=4, T=2048, D=96, n=4)
# bench.py LM_MODE_DIMS["longcontext"]
SP = dict(seq=4096, batch=4, steps=3)
PIPE_STEPS = 5


def log21(card, msg):
    """A phase-21 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def same_params(torch, a, b):
    """Whether two nets' params are equal bit for bit."""
    from deeplearning4j_tpu_torch.nn import tree

    return all(torch.equal(x, tree.get(b.params, p))
               for p, x in tree.leaves(a.params))


def event_ms(torch, fn, n):
    """Median CUDA-event time of `n` calls of fn, after one warm call."""
    fn()
    samples = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def flagship(transformer_lm, **kw):
    c = TRAIN
    return transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                          n_heads=c["n_heads"], n_layers=c["n_layers"],
                          d_ff=c["d_ff"], dtype="bfloat16", device="cuda",
                          **kw)


def dp_flagship(torch, counters, transformer_lm, DataSet, mesh, card):
    """21a: the flagship through DataParallelTrainer at one rank, the
    monolithic arm and the overlap arm at each bucket size bit for bit
    against the meshless net with phase 6's launch counts; each arm's
    step timed beside the meshless step."""
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    L, S = c["n_layers"], DP_STEPS
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    plain = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    arms = {"meshless": (plain, plain.fit)}
    dp = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    arms["monolithic"] = (dp, DataParallelTrainer(dp, mesh).fit)
    for bb in OVERLAP_BUCKETS:
        net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
        arms[f"overlap {bb}"] = (
            net, DataParallelTrainer(net, mesh, overlap=bb).fit)
    runs = {}
    for name, (net, fit) in arms.items():
        torch.cuda.synchronize()
        counters.reset()
        for _ in range(S):
            fit(ds)
        torch.cuda.synchronize()
        runs[name] = counters.read()
    for name, (net, _) in arms.items():
        if name == "meshless":
            continue
        same = same_params(torch, plain, net)
        log21(card, f"21a: {name} arm (DataParallelTrainer, world size 1, "
            f"NCCL{_buckets(net)}) {S} steps: params bit for bit against "
            f"the meshless net's {same}; scores {plain.score_value} / "
            f"{net.score_value}; launches {runs[name]}")
        if not same or plain.score_value != net.score_value:
            raise PhaseFailed("21a", f"the {name} arm at one rank is not "
                                     "the meshless step bit for bit")
    if any(r != want for r in runs.values()):
        raise PhaseFailed("21a", f"launches {runs}, expected {want} each")
    steps = {name: event_ms(torch, lambda fit=fit: fit(ds), DP_TIMED)
             for name, (_, fit) in arms.items()}
    log21(card, f"21a: median step ms (CUDA events, {DP_TIMED} steps after "
        f"one warm) {steps}")
    launches = {k: sum(r[k] for name, r in runs.items()
                       if name != "meshless") for k in want}
    return launches, steps


def _buckets(net):
    plan = net._overlap_plan
    return "" if plan is None else f", {len(plan.buckets)} buckets"


# 21b's shard check runs ResNet-20 in f64: in f32 on the H100 the
# shard's gradients came within 7.7e-5 of the largest entry of the
# meshless ones, against a 1e-4 gate (cuDNN's backward does not repeat
# bit for bit); in f64 the two agree to ~1e-16
SHARD_CHECK_TOL = 1e-9


def resnet_shard_grads(torch, mesh, ds, card):
    """21b: one forward and backward of ResNet-20 in f64 as a data shard
    of one rank (batch-norm sums all-reduced differentiably and the
    masked loss's count all-reduced, over NCCL) against the meshless
    forward and backward: the loss and every gradient within
    SHARD_CHECK_TOL of the largest entry. A second meshless pass gives
    the run-to-run reading beside it."""
    import contextlib

    from deeplearning4j_tpu_torch.models.resnet import resnet20
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.training import loss_and_grads
    from deeplearning4j_tpu_torch.ops.shard_scope import DataShard, sharded

    net = resnet20(dtype="float64", device="cuda").init(SEED)
    batch = net._batch_dict(net._to_mds(ds))
    shard = DataShard(mesh.group("data"), 1, mesh.axis_index("data"))
    got = {}
    for name, ctx in (("meshless", contextlib.nullcontext()),
                      ("again", contextlib.nullcontext()),
                      ("shard", sharded(data=shard))):
        with ctx:
            loss, _, grads = loss_and_grads(net._loss, net.params, net.state,
                                            None, batch)
        got[name] = (loss.detach(), grads)
    l0, g0 = got["meshless"]
    # over the largest gradient entry: the biases of the convolutions
    # before a batch norm have a gradient of 0 up to rounding
    top = max(float(g.abs().max()) for _, g in tree.leaves(g0))
    e = {name: (errs(loss, l0)[1], max(errs(g, tree.get(g0, p))[0]
                                       for p, g in tree.leaves(grads)) / top)
         for name, (loss, grads) in got.items() if name != "meshless"}
    log21(card, f"21b: ResNet-20 f64 forward and backward as a data shard of "
        f"one rank (NCCL collectives) against the meshless one, masked "
        f"loss: loss relative {e['shard'][0]:.3e}, gradients max |shard - "
        f"meshless| over the largest entry {e['shard'][1]:.3e} (tol "
        f"{SHARD_CHECK_TOL}); a second meshless pass {e['again'][0]:.3e} / "
        f"{e['again'][1]:.3e}")
    if not max(e["shard"]) <= SHARD_CHECK_TOL:
        raise PhaseFailed("21b", "the data shard's forward collectives "
                                 "disagree with the meshless step")
    return e


def dp_resnet20(torch, card):
    """21b: bench mode resnet_dp's three arms at one rank on ResNet-20
    (batch 64, f32): monolithic, overlap (256 KiB buckets) and
    ParameterAveragingTrainer(averaging_frequency=1); steps/s and their
    ratios, no gate; every arm's loss falls. Before them, the shard's
    forward collectives held against the meshless step."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.resnet import resnet20
    from deeplearning4j_tpu_torch.parallel import (
        DataParallelTrainer,
        ParameterAveragingTrainer,
        make_mesh,
    )

    c = RESNET_DP
    mesh = make_mesh({"data": 1})
    rng = np.random.default_rng(0)
    x = rng.random((c["batch"], 32, 32, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, c["batch"])]
    ds = DataSet(x, y)
    keep = (rng.random(c["batch"]) < 0.75).astype(np.float32)
    resnet_shard_grads(torch, mesh, DataSet(x, y, labels_mask=keep), card)
    arms = {}
    for name in ("allreduce", "overlap", "paramavg"):
        net = resnet20(device="cuda").init(SEED)
        if name == "paramavg":
            tr = ParameterAveragingTrainer(net, mesh, averaging_frequency=1)
        else:
            tr = DataParallelTrainer(
                net, mesh, overlap=256 * 1024 if name == "overlap" else None)
        arms[name] = (net, tr, [])
    for name, (net, tr, losses) in arms.items():  # warm
        tr.fit(ListDataSetIterator([ds] * 2))
        losses.append(net.score_value)
    rates = {name: [] for name in arms}
    for _ in range(c["rounds"]):
        for name, (net, tr, losses) in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(ListDataSetIterator([ds] * c["n_batches"]))
            torch.cuda.synchronize()
            rates[name].append(c["n_batches"] / (time.perf_counter() - t0))
            losses.append(net.score_value)
    med = {k: statistics.median(v) for k, v in rates.items()}
    log21(card, f"21b: ResNet-20 batch {c['batch']} f32 at one rank, steps/s "
        f"(median of {c['rounds']} rounds of {c['n_batches']}): "
        f"{ {k: round(v, 3) for k, v in med.items()} }; overlap/paramavg "
        f"{med['overlap'] / med['paramavg']:.4f}, allreduce/paramavg "
        f"{med['allreduce'] / med['paramavg']:.4f}, overlap/allreduce "
        f"{med['overlap'] / med['allreduce']:.4f}")
    for name, (_, _, losses) in arms.items():
        log21(card, f"21b: {name} losses {[round(v, 4) for v in losses]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise PhaseFailed("21b", f"{name}: the loss does not fall: "
                                     f"{losses}")
    return med


def ring_on_card(torch, counters, fa, mesh_seq, card):
    """21c: ring attention through the in-process transport on the card:
    4 blocks of 1024 in bf16 against the whole-sequence K1/K5, the f32
    case, exact hop launches, dropout with one step seed against the
    whole-sequence kernel, the process-group ring at one rank, and head
    dim 96 (the f32 einsum ring, no kernel) against
    `sequence_sharded_attention_reference`."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
        sequence_sharded_attention_reference,
    )

    def inputs(c, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn((c["B"], c["H"], c["T"], c["D"]), generator=g,
                            device="cuda", dtype=dtype).requires_grad_()
                for _ in range(4)]

    def whole(q, k, v, drop=None):
        B, H, T, D = q.shape
        flat = [t.reshape(B * H, T, D) for t in (q, k, v)]
        if drop is None:
            o, _ = fa.flash_attention_lse(*flat, 1.0 / D ** 0.5, True)
        else:
            o, _ = fa.flash_attention_lse_drop(
                *flat, None, fa._drop_ctx(drop, 0, 0), 1.0 / D ** 0.5, True,
                DROP_RATE, T)
        return o.reshape(B, H, T, D)

    def fwd_bwd(fn, q, k, v, do):
        o = fn(q, k, v)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return o, dq, dk, dv

    def compare(tag, got, ref, tol_o, tol_g):
        got, ref = ([t.detach() for t in x] for x in (got, ref))
        e_o = errs(got[0], ref[0])[0]
        e_g = max(errs(a, b)[1] for a, b in zip(got[1:], ref[1:]))
        log21(card, f"21c: {tag}: max |o - whole| {e_o:.3e} (tol {tol_o}), "
            f"gradients max relative {e_g:.3e} (tol {tol_g})")
        if not e_o <= tol_o or not e_g <= tol_g:
            raise PhaseFailed("21c", f"{tag} disagrees with the "
                                     "whole-sequence kernels")
        return e_o, e_g

    c, n = RING, RING["n"]
    q, k, v, do = inputs(c, torch.bfloat16, 1)
    ref = fwd_bwd(whole, q, k, v, do)

    def ring(q, k, v, **kw):
        return ring_self_attention(q, k, v, n_shards=n, causal=True, **kw)

    torch.cuda.synchronize()
    counters.reset()
    o = ring(q, k, v)
    torch.cuda.synchronize()
    fwd_launches = counters.read()
    counters.reset()
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    bwd_launches = counters.read()
    log21(card, f"21c: 4-block causal ring, forward launches {fwd_launches}, "
        f"backward {bwd_launches}")
    if fwd_launches["K1"] != 10 or bwd_launches["K5"] != 10 or any(
            n_ for k_, n_ in fwd_launches.items() if k_ != "K1") or any(
            n_ for k_, n_ in bwd_launches.items() if k_ != "K5"):
        raise PhaseFailed("21c", "expected exactly 10 K1 and 10 K5 (4 "
                                 "diagonal + 6 full hops, 6 skipped)")
    errors = {"bf16": compare(f"bf16 [{c['B']}, {c['H']}, {c['T']}, "
                              f"{c['D']}] n={n}", (o, *grads),
                              ref, TOL["bfloat16"]["o"],
                              REL_TOL["bfloat16"])}
    ring_ms = event_ms(torch, lambda: fwd_bwd(ring, q, k, v, do), 5)
    whole_ms = event_ms(torch, lambda: fwd_bwd(whole, q, k, v, do), 5)
    log21(card, f"21c: forward + backward {ring_ms:.3f} ms for the ring, "
        f"{whole_ms:.3f} ms for the whole-sequence K1 + K5 (CUDA events, "
        f"median of 5)")
    c32 = RING_F32
    q32, k32, v32, do32 = inputs(c32, torch.float32, 2)
    errors["f32"] = compare(
        f"f32 [{c32['B']}, {c32['H']}, {c32['T']}, {c32['D']}] "
        f"n={c32['n']}",
        fwd_bwd(lambda a, b, d: ring_self_attention(
            a, b, d, n_shards=c32["n"], causal=True), q32, k32, v32, do32),
        fwd_bwd(whole, q32, k32, v32, do32), 1e-4, 1e-4)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device="cuda")
    errors["dropout"] = compare(
        f"bf16 dropout {DROP_RATE}, one step seed",
        fwd_bwd(lambda a, b, d: ring(a, b, d, dropout=DROP_RATE, seed=seed),
                q, k, v, do),
        fwd_bwd(lambda a, b, d: whole(a, b, d, seed), q, k, v, do),
        TOL["bfloat16"]["o"], REL_TOL["bfloat16"])
    counters.reset()
    pg = fwd_bwd(lambda a, b, d: ring_self_attention(a, b, d, mesh_seq,
                                                     causal=True),
                 q, k, v, do)
    torch.cuda.synchronize()
    pg_launches = counters.read()
    errors["process group"] = compare(
        "process-group ring at world size 1 (one diagonal hop)", pg, ref,
        TOL["bfloat16"]["o"], REL_TOL["bfloat16"])
    if (pg_launches["K1"], pg_launches["K5"]) != (1, 1):
        raise PhaseFailed("21c", f"one-hop ring launched {pg_launches}")
    cd = RING_D96
    qd, kd, vd, dod = inputs(cd, torch.bfloat16, 3)
    counters.reset()
    d96 = fwd_bwd(lambda a, b, d: ring_self_attention(
        a, b, d, n_shards=cd["n"], causal=True), qd, kd, vd, dod)
    torch.cuda.synchronize()
    d96_launches = counters.read()
    errors["D=96"] = compare(
        f"bf16 [{cd['B']}, {cd['H']}, {cd['T']}, {cd['D']}] n={cd['n']} "
        f"(the f32 einsum ring) against the f32 reference",
        d96, fwd_bwd(lambda a, b, d: sequence_sharded_attention_reference(
            a, b, d, causal=True), qd, kd, vd, dod),
        TOL["bfloat16"]["o"], REL_TOL["bfloat16"])
    if any(d96_launches.values()):
        raise PhaseFailed("21c", f"the D = 96 ring launched {d96_launches}; "
                                 "it takes the einsum ring")
    return {"errors": errors, "ring_ms": ring_ms, "whole_ms": whole_ms,
            "launches": {k_: fwd_launches[k_] + bwd_launches[k_]
                         + pg_launches[k_] for k_ in fwd_launches}}


def sp_flagship(torch, counters, transformer_lm, DataSet, mesh_seq, card):
    """21d: SequenceParallelTrainer on the flagship at bench mode
    longcontext's dims (T 4096, batch 4, bf16) at one rank: the loss
    falls, and the params and every step's loss equal plain fit's from
    the same init bit for bit (at T 4096 plain fit runs K1/K5 over the
    whole sequence, and a ring of one shard is one diagonal hop of the
    same kernels)."""
    from deeplearning4j_tpu_torch.parallel import SequenceParallelTrainer

    c = SP
    ds = lm_batch(DataSet, TRAIN["vocab_size"], c["batch"], c["seq"])
    plain = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    sp = flagship(transformer_lm, max_length=c["seq"],
                  seq_parallel_axis="seq").init(SEED)
    trainer = SequenceParallelTrainer(sp, mesh_seq)
    losses = {"plain": [], "sp": []}
    runs = {}
    for name, net, fit in (("sp", sp, trainer.fit),
                           ("plain", plain, plain.fit)):
        torch.cuda.synchronize()
        counters.reset()
        for _ in range(c["steps"]):
            fit(ds)
            losses[name].append(net.score_value)
        torch.cuda.synchronize()
        runs[name] = counters.read()
    launches = runs["sp"]
    L, S = TRAIN["n_layers"], c["steps"]
    same = same_params(torch, plain, sp)
    step_ms = event_ms(torch, lambda: trainer.fit(ds), 3)
    plain_ms = event_ms(torch, lambda: plain.fit(ds), 3)
    log21(card, f"21d: SequenceParallelTrainer (seq axis of 1, NCCL) at T "
        f"{c['seq']} batch {c['batch']} bf16: losses {losses}; params bit "
        f"for bit against plain fit's {same}; launches {runs}; step "
        f"{step_ms:.3f} ms (CUDA events, median of 3) beside plain fit's "
        f"{plain_ms:.3f} ms")
    if not losses["sp"][-1] < losses["sp"][0]:
        raise PhaseFailed("21d", "the SP loss does not fall")
    if not same or losses["sp"] != losses["plain"]:
        raise PhaseFailed("21d", "SP at one rank is not plain fit bit for "
                                 "bit")
    if (launches["K1"], launches["K5"], launches["K2"], launches["K8"]) \
            != (L * S, L * S, 0, S) or launches != runs["plain"]:
        raise PhaseFailed("21d", f"launches {runs}")
    return launches, step_ms


def pipelined_fit(torch, counters, transformer_lm, DataSet, card):
    """21e: fit of the flagship over 5 batches through iter_prefetched
    (depth 2) against the synchronous loop (depth 0), bit for bit, with
    the pipelined run's input_wait p50 and p99."""
    from deeplearning4j_tpu_torch.data.pipeline import set_prefetch_depth
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    c = TRAIN
    rng = np.random.default_rng(SEED + 21)
    batches = []
    for _ in range(PIPE_STEPS):
        toks = rng.integers(0, c["vocab_size"], (c["batch"], c["seq"]))
        toks = toks.astype(np.int32)
        batches.append(DataSet(toks, np.roll(toks, -1, axis=1)))
    nets = {}
    rec = Recorder(path=None)
    prev_rec = set_default(rec)
    prev = set_prefetch_depth(0)
    counters.reset()
    try:
        for depth in (0, 2):
            set_prefetch_depth(depth)
            net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
            net.fit(ListDataSetIterator(list(batches)))
            nets[depth] = net
    finally:
        set_prefetch_depth(prev)
        set_default(prev_rec)
    torch.cuda.synchronize()
    launches = counters.read()
    waits = sorted(e["seconds"] for e in rec.events
                   if e.get("event") == "span"
                   and e.get("name") == "input_wait" and e.get("pipelined"))
    same = same_params(torch, nets[0], nets[2])
    p50 = waits[len(waits) // 2] * 1e3
    p99 = waits[min(len(waits) - 1, int(round(0.99 * (len(waits) - 1))))]
    log21(card, f"21e: pipelined fit (depth 2) against synchronous (depth 0), "
        f"{PIPE_STEPS} steps each: bit for bit {same}; input_wait over "
        f"{len(waits)} dequeues p50 {p50:.3f} ms, p99 {p99 * 1e3:.3f} ms "
        f"(host clock)")
    if not same:
        raise PhaseFailed("21e", "pipelined fit differs from synchronous fit")
    return launches


def train_parallel(torch, counters, fa, transformer_lm, DataSet, card):
    """Phase 21: data and sequence parallelism at world size 1 over NCCL
    on the one card (21a-21e). Returns the launches of its main-path
    runs."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh({"data": 1})
    mesh_seq = make_mesh({"seq": 1})
    info = {"world": mesh.size, "device": str(mesh.device)}
    log21(card, f"21: process group {info}")
    try:
        dp_launches, _ = dp_flagship(torch, counters, transformer_lm,
                                     DataSet, mesh, card)
        dp_resnet20(torch, card)
        ring = ring_on_card(torch, counters, fa, mesh_seq, card)
        sp_launches, _ = sp_flagship(torch, counters, transformer_lm,
                                     DataSet, mesh_seq, card)
        pipe_launches = pipelined_fit(torch, counters, transformer_lm,
                                      DataSet, card)
    finally:
        bootstrap.shutdown()
    runs = (dp_launches, ring["launches"], sp_launches, pipe_launches)
    launches = {k: sum(r.get(k, 0) for r in runs) for k in dp_launches}
    log21(card, f"phase 21 in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    return launches


# ------------------------------------------------------------ phase 22

# 22a: a graph of the vertices A10 ported at the flagship's width:
# tokens -> embedding (d 256) -> causal self-attention (2 heads of 128,
# K2/K6) merged with a dense branch -> a subset across both -> the last
# unmasked step -> dense -> softmax over 16 classes; SGD, batch 32 x 512
VGRAPH = dict(vocab=10000, d=256, heads=2, classes=16, batch=32, seq=512,
              steps=3, lr=0.1)
# the card's bf16 run (kernels) against the CPU's (plain versions), same
# init and batches: the largest step loss apart, relative, and the
# largest param apart over the largest update the CPU run made. Readings
# of the first call (PR 16, call 2): 1.586e-3 and 7.863e-2; the CPU's
# own bf16 run against its f32 run is logged beside them each run
VGRAPH_LOSS_TOL = 1e-2
VGRAPH_PARAM_TOL = 0.25
# 22b: the flagship's width as a MultiLayerNetwork stack (pre-norm
# blocks without residuals), served greedy in f32 and sampled
MLN_LM = dict(vocab=10000, d=256, heads=2, layers=6, d_ff=1024)
MLN_PROMPTS = (40, 300, 700, 1000)
MLN_NEW = 32
MLN_SAMPLED = dict(rows=4, prompt=128, top_k=8, top_p=0.9)
# 22d: the flagship's 2 heads over 2 model shards (K2/K6 at 1 head of
# 128 each); the MoE LM's 8 experts over 2 and 4 expert shards. A split
# arm passes when its largest relative error against an f32 reference is
# at most SPLIT_RATIO times the whole bf16 arm's against the same
# reference: the split adds no more than the bf16 summation order does
TP_SHARDS = 2
EP_SHARDS = (2, 4)
SPLIT_RATIO = 2.0


def log22(card, msg):
    """A phase-22 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def vertex_graph(device, dtype="bfloat16"):
    """22a's graph on `device` (module constants above)."""
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    c = VGRAPH
    d = c["d"]
    g = (C.NeuralNetConfiguration.builder().seed(SEED)
         .learning_rate(c["lr"]).updater(C.Updater.SGD)
         .weight_init("xavier").dtype(dtype).graph_builder())
    g.add_inputs("tokens")
    g.add_layer("embed", L.EmbeddingLayer(n_in=c["vocab"], n_out=d,
                                          activation="identity",
                                          has_bias=False), "tokens")
    g.add_layer("attn", L.SelfAttentionLayer(
        n_in=d, n_out=d, n_heads=c["heads"], causal=True,
        activation="identity"), "embed")
    g.add_layer("side", L.DenseLayer(n_in=d, n_out=d, activation="tanh"),
                "embed")
    g.add_vertex("merge", C.MergeVertexConf(), "attn", "side")
    g.add_vertex("subset", C.SubsetVertexConf(from_idx=d // 2,
                                              to_idx=d // 2 + d - 1),
                 "merge")
    g.add_vertex("last", C.LastTimeStepVertexConf(mask_input="tokens"),
                 "subset")
    g.add_layer("dense", L.DenseLayer(n_in=d, n_out=d, activation="relu"),
                "last")
    g.add_layer("out", L.OutputLayer(n_in=d, n_out=c["classes"],
                                     activation="softmax",
                                     loss_function="mcxent"), "dense")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device=device)


def train_vertex_graph(torch, counters, card):
    """22a: 22a's graph trained 3 SGD steps on the card (bf16; K2 and K6
    with a key padding mask, the last step taken at each row's mask)
    against the same graph on the CPU through the plain versions, from
    the same init and batches: exact launches, the step losses and the
    params within VGRAPH_LOSS_TOL / VGRAPH_PARAM_TOL; the CPU's bf16 run
    against an f32 one logged beside, the bf16 rounding's own size."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import tree

    c = VGRAPH
    rng = np.random.default_rng(SEED + 22)
    batches = []
    for _ in range(c["steps"]):
        toks = rng.integers(0, c["vocab"], (c["batch"], c["seq"]))
        lengths = rng.integers(c["seq"] // 2, c["seq"] + 1, c["batch"])
        mask = np.arange(c["seq"])[None, :] < lengths[:, None]
        y = np.eye(c["classes"], dtype=np.float32)[
            rng.integers(0, c["classes"], c["batch"])]
        batches.append(DataSet(toks.astype(np.int32), y,
                               features_mask=mask.astype(np.float32)))
    card_net = vertex_graph("cuda").init(SEED)
    init = tree.tree_map(lambda t: t.detach().cpu().clone(), card_net.params)
    nets = {"cpu": vertex_graph("cpu"), "cpu f32": vertex_graph(
        "cpu", "float32")}
    for net in nets.values():
        net.init(SEED)
        net.params = tree.tree_map(lambda t: t.clone(), init)
        net.opt_state = net.tx.init(net.params)
    losses = {name: [] for name in ("card", *nets)}
    torch.cuda.synchronize()
    counters.reset()
    for ds in batches:
        card_net.fit(ds)
        losses["card"].append(card_net.score_value)
    torch.cuda.synchronize()
    launches = counters.read()
    t0 = time.perf_counter()
    for name, net in nets.items():
        for ds in batches:
            net.fit(ds)
            losses[name].append(net.score_value)
    cpu_s = time.perf_counter() - t0
    ref = nets["cpu"].params
    update = max(float((tree.get(ref, p) - t).abs().max())
                 for p, t in tree.leaves(init))

    def apart(a, b):
        """(largest step loss apart, relative; the largest param apart
        over the CPU bf16 run's largest update, and the leaf)."""
        loss = max(abs(x - y) / abs(y) for x, y in zip(losses[a],
                                                        losses[b]))
        pa = card_net.params if a == "card" else nets[a].params
        pb = nets[b].params
        per = {"/".join(p): float((tree.get(pa, p).cpu().float()
                                   - t.float()).abs().max()) / update
               for p, t in tree.leaves(pb)}
        worst = max(per, key=per.get)
        return loss, per[worst], worst

    loss_err, param_err, worst = apart("card", "cpu")
    floor = apart("cpu", "cpu f32")
    S = c["steps"]
    want = {k: 0 for k in launches}
    want.update({"K2": S, "K6": S})
    step_ms = event_ms(torch, lambda: card_net.fit(batches[0]), 3)
    log22(card, f"22a: graph (embedding, causal attention 2x128 with a key "
        f"padding mask, Merge, Subset, LastTimeStep on the mask, dense, "
        f"softmax) at batch {c['batch']} x {c['seq']} bf16, {S} SGD steps: "
        f"losses {losses}; card against CPU: loss relative {loss_err:.3e} "
        f"(tol {VGRAPH_LOSS_TOL}), params max |card - CPU| over the "
        f"largest update ({update:.4e}) {param_err:.3e} at {worst} (tol "
        f"{VGRAPH_PARAM_TOL}); the CPU's bf16 run against its f32 run "
        f"{floor[0]:.3e} / {floor[1]:.3e} at {floor[2]}; launches "
        f"{launches}; step {step_ms:.3f} ms (CUDA events, median of 3), "
        f"the CPU's two runs {cpu_s:.2f} s")
    if launches != want:
        raise PhaseFailed("22a", f"launches {launches}, expected {want}")
    if not loss_err <= VGRAPH_LOSS_TOL or not param_err <= VGRAPH_PARAM_TOL:
        raise PhaseFailed("22a", "the graph on the card disagrees with the "
                                 "CPU")
    return launches


def mln_lm(dtype, device):
    """22b's MultiLayerNetwork transformer stack."""
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    m = MLN_LM
    d = m["d"]
    b = C.NeuralNetConfiguration.builder().seed(SEED).dtype(dtype).list()
    b.layer(L.EmbeddingLayer(n_in=m["vocab"], n_out=d, activation="identity",
                             has_bias=False))
    b.layer(L.PositionalEncodingLayer(max_length=2048, n_features=d))
    for _ in range(m["layers"]):
        b.layer(L.LayerNormalization(n_in=d, n_out=d))
        b.layer(L.SelfAttentionLayer(n_in=d, n_out=d, n_heads=m["heads"],
                                     causal=True, activation="identity"))
        b.layer(L.LayerNormalization(n_in=d, n_out=d))
        b.layer(L.DenseLayer(n_in=d, n_out=m["d_ff"], activation="gelu"))
        b.layer(L.DenseLayer(n_in=m["d_ff"], n_out=d, activation="identity"))
    b.layer(L.LayerNormalization(n_in=d, n_out=d))
    b.layer(L.RnnOutputLayer(n_in=d, n_out=m["vocab"], activation="softmax",
                             loss_function="mcxent"))
    return MultiLayerNetwork(b.build(), device=device)


def serve_mln(torch, counters, card):
    """22b: the MultiLayerNetwork stack at the flagship's width served
    through GenerationEngine (f32, f32 cache): 32 greedy tokens for 4
    prompts, each the argmax of the full forward (a difference allowed
    only at a top-2 margin under ORACLE_MARGIN_TOL, where the streams
    then part); then one sampled run through its prefill and decode
    steps, each token drawn by K12 (T 1.0, top-k 8, top-p 0.9) and
    inside its row's top 8. Returns the launches."""
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    net = mln_lm("float32", "cuda").init(SEED)
    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(64, 512,
                                                                 1024)),
                              slots=4, max_new_tokens=MLN_NEW, page_size=16,
                              prefill_chunk=1024)
    engine.warmup()
    rng = torch.Generator().manual_seed(SEED + 22)
    prompts = [torch.randint(0, MLN_LM["vocab"], (n,), generator=rng).numpy()
               for n in MLN_PROMPTS]
    torch.cuda.synchronize()
    counters.reset()
    engine.start()
    t0 = time.perf_counter()
    reqs = [engine.submit_generate(p, MLN_NEW) for p in prompts]
    for r in reqs:
        if not r.wait(600) or r.error is not None:
            raise PhaseFailed("22b", f"request {r.request_id}: {r.error}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    engine.drain()
    checked, parted = 0, []
    for prompt, r in zip(prompts, reqs):
        seq = list(prompt)
        for i, tok in enumerate(r.emitted):
            probs = net.output(np.asarray(seq)[None])[0, -1].float()
            ref = int(probs.argmax())
            if ref != tok:
                top2 = probs.topk(2).values
                margin = float(top2[0] - top2[1])
                if margin >= ORACLE_MARGIN_TOL:
                    raise PhaseFailed("22b", f"prompt of {len(prompt)}: "
                                             f"token {i} is {tok}, the full "
                                             f"forward gives {ref} (top-2 "
                                             f"margin {margin:.3e})")
                parted.append((len(prompt), i, margin))
                break
            checked += 1
            seq.append(tok)
    if launches["K1"] == 0:
        raise PhaseFailed("22b", f"prefill launched no flash kernel: "
                                 f"{launches}")
    s = MLN_SAMPLED
    toks = torch.randint(0, MLN_LM["vocab"], (s["rows"], s["prompt"]),
                         generator=rng).numpy()
    cap = s["prompt"] + MLN_NEW
    cache = net.init_kv_cache(s["rows"], cap)
    prefill, step = net.prefill_fn(), net.incremental_decode_fn()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rows = np.arange(s["rows"])
    counters.reset()
    probs, cache = prefill(net.params, net.state, cache, toks,
                           np.ones_like(toks, np.float32), rows,
                           np.zeros_like(rows), np.full_like(rows,
                                                             s["prompt"] - 1))
    drawn, outside = [], 0
    for pos in range(s["prompt"], s["prompt"] + MLN_NEW):
        logits = probs.float().clamp_min(1e-30).log()
        noise = fsm.gumbel_noise(gen, s["rows"], MLN_LM["vocab"], "cuda")
        tok = fsm.fused_sample(logits, noise, temperature=1.0,
                               top_k=s["top_k"], top_p=s["top_p"])
        top = logits.topk(s["top_k"], dim=-1).indices
        outside += int((top != tok.long()[:, None]).all(dim=-1).sum())
        drawn.append(tok)
        if pos < s["prompt"] + MLN_NEW - 1:
            probs, cache = step(net.params, net.state, cache,
                                tok.cpu().numpy(), np.full_like(rows, pos))
    torch.cuda.synchronize()
    sampled = counters.read()
    log22(card, f"22b: MultiLayerNetwork stack (vocab {MLN_LM['vocab']}, d "
        f"{MLN_LM['d']}, {MLN_LM['heads']} heads, {MLN_LM['layers']} blocks, "
        f"d_ff {MLN_LM['d_ff']}, f32) through GenerationEngine: "
        f"{len(prompts)} prompts of {MLN_PROMPTS}, {MLN_NEW} greedy tokens "
        f"each in {wall:.3f} s; {checked} tokens equal the full forward's "
        f"argmax, streams parted at near-ties {parted}; launches "
        f"{launches}. Sampled run ({s['rows']} rows, T 1.0, top-k "
        f"{s['top_k']}, top-p {s['top_p']}): {len(drawn)} draws, "
        f"{outside} outside the row's top {s['top_k']}; launches {sampled}")
    if checked < len(prompts) * MLN_NEW // 2:
        raise PhaseFailed("22b", f"only {checked} greedy tokens held to "
                                 "the full forward")
    if sampled["K12"] != MLN_NEW or outside:
        raise PhaseFailed("22b", f"the sampled run: K12 {sampled['K12']} "
                                 f"(expected {MLN_NEW}), {outside} draws "
                                 f"outside the top {s['top_k']}")
    return {k: launches[k] + sampled[k] for k in launches}


def canonical_equal(torch, a, b):
    """Whether two nets' canonical params are equal bit for bit."""
    from deeplearning4j_tpu_torch.nn import tree

    pb = b.canonical_params()
    return all(torch.equal(x, tree.get(pb, p))
               for p, x in tree.leaves(a.canonical_params()))


def roles_at_one_rank(torch, counters, transformer_lm, DataSet, mesh, card):
    """22c: at world size 1 over NCCL, the flagship under {"data": 1,
    "model": 1}, the MoE LM at bench width under {"data": 1, "expert":
    1} and the flagship under zero1=True, each against the meshless net
    after 3 steps from the same init: canonical params and scores bit
    for bit, phase 6's launch counts. Each placed arm runs its split
    layers' collectives over a group of one."""
    from deeplearning4j_tpu_torch import models

    c, S, L = TRAIN, DP_STEPS, TRAIN["n_layers"]
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    arms = (
        ("flagship, model", lambda: flagship(transformer_lm,
                                             max_length=c["seq"]),
         dict(axes={"data": "data", "model": "model"})),
        ("MoE LM, expert", lambda: moe_lm(models),
         dict(axes={"data": "data", "expert": "expert"})),
        ("flagship, zero1", lambda: flagship(transformer_lm,
                                             max_length=c["seq"]),
         dict(axes={"data": "data"}, zero1=True)))
    total = {k: 0 for k in want}
    steps = {}
    for name, build, kw in arms:
        plain = build().init(SEED)
        placed = build().init(SEED)
        placed.set_mesh(mesh, **kw)
        runs = {}
        for arm, net in (("meshless", plain), ("placed", placed)):
            torch.cuda.synchronize()
            counters.reset()
            for _ in range(S):
                net.fit(ds)
            torch.cuda.synchronize()
            runs[arm] = counters.read()
        same = canonical_equal(torch, plain, placed)
        split = (sorted(placed._split_plan.layers)[:3]
                 if placed._split_plan is not None else [])
        z1 = 0 if placed._zero1 is None else len(placed._zero1.paths)
        steps[name] = {arm: event_ms(torch, lambda n=net: n.fit(ds), 3)
                       for arm, net in (("meshless", plain),
                                        ("placed", placed))}
        for arm, net in (("meshless", plain), ("placed", placed)):
            profiled(torch, lambda n=net: n.fit(ds),
                     f"22c: {name}, {arm} step", top=6)
        log22(card, f"22c: {name} at world size 1 (NCCL), {S} steps: "
            f"canonical params bit for bit against the meshless net's "
            f"{same}; scores {plain.score_value} / {placed.score_value}; "
            f"split layers {split}..., ZeRO-1 leaves {z1}; launches "
            f"{runs['placed']}; step ms (CUDA events, median of 3) "
            f"{steps[name]}")
        if not same or plain.score_value != placed.score_value:
            raise PhaseFailed("22c", f"{name} at one rank is not the "
                                     "meshless step bit for bit")
        if runs["placed"] != want or runs["meshless"] != want:
            raise PhaseFailed("22c", f"{name}: launches {runs}, expected "
                                     f"{want} each")
        placed.set_mesh(None)
        for k in want:
            total[k] += runs["placed"][k]
    return total, steps


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _split_gate(card, tag, whole, split, ref):
    """The largest relative error over the outputs and gradients of the
    whole and the split bf16 arms against the f32 reference ({name:
    tensor} each); the split passes at SPLIT_RATIO times the whole's."""
    e_w = max(_rel(whole[k], ref[k]) for k in ref)
    e_s = max(_rel(split[k], ref[k]) for k in ref)
    e_ws = max(_rel(split[k], whole[k]) for k in ref)
    worst = max(ref, key=lambda k: _rel(split[k], ref[k]))
    log22(card, f"22d: {tag}: largest relative error against the f32 "
        f"reference, whole bf16 {e_w:.3e}, split bf16 {e_s:.3e} (at "
        f"{worst}; gate {SPLIT_RATIO} x the whole's), split against whole "
        f"{e_ws:.3e}")
    if not e_s <= SPLIT_RATIO * e_w:
        raise PhaseFailed("22d", f"{tag}: the split arm is off its whole "
                                 f"layer beyond bf16 rounding")
    return {"whole": e_w, "split": e_s, "split_vs_whole": e_ws}


def split_block_on_card(torch, counters, fa, transformer_lm, card):
    """22d, "model": the flagship's block 0 (ln1, attention, ln2, ff1,
    ff2, both residuals) at batch 32 x 512 split over TP_SHARDS model
    shards in this process (ops/shard_comm.InProcessShards: each shard's
    attention launches K2 and K6 on its one head of 128) against the
    whole block, in bf16, with an f32 reference; the output and the
    gradients of x and of every param; each arm's forward + backward
    time; then K2 and K6 at the shard's shape timed beside their bounds.
    Returns the split arm's launches."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.layers import get_impl
    from deeplearning4j_tpu_torch.nn.layers.attention import attention_shards
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        dense_columns,
        dense_rows,
    )
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        join_shards,
        shard_slice,
    )

    c, m = TRAIN, TP_SHARDS
    net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    names = ("blk0_ln1", "blk0_attn", "blk0_ln2", "blk0_ff1", "blk0_ff2")
    confs = {n: net.layer_vertices[n].layer for n in names}
    H = confs["blk0_attn"].n_heads
    # the leaves the split cuts: (dim, heads of a packed QKV leaf)
    cut = {("blk0_attn", "Wqkv"): (1, H), ("blk0_attn", "bqkv"): (0, H),
           ("blk0_attn", "Wo"): (0, None), ("blk0_ff1", "W"): (1, None),
           ("blk0_ff1", "b"): (0, None), ("blk0_ff2", "W"): (0, None)}
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    x32 = torch.randn((c["batch"], c["seq"], c["d_model"]), generator=g,
                      device="cuda")
    cot32 = torch.randn(x32.shape, generator=g, device="cuda")

    def layer(n, p, x):
        return get_impl(confs[n]).apply(confs[n], p, {}, x)[0]

    def whole(x, P):
        r = x + layer("blk0_attn", P["blk0_attn"],
                      layer("blk0_ln1", P["blk0_ln1"], x))
        h = layer("blk0_ln2", P["blk0_ln2"], r)
        return r + layer("blk0_ff2", P["blk0_ff2"],
                         layer("blk0_ff1", P["blk0_ff1"], h))

    def split(x, P, S, transport):
        r = x + attention_shards(confs["blk0_attn"], S["blk0_attn"],
                                 layer("blk0_ln1", P["blk0_ln1"], x),
                                 transport)
        h = layer("blk0_ln2", P["blk0_ln2"], r)
        fs = dense_columns(confs["blk0_ff1"], S["blk0_ff1"], h, transport)
        return r + dense_rows(confs["blk0_ff2"], S["blk0_ff2"], fs,
                              transport)

    def run(dtype, shards):
        P = {n: {k: t.detach().to(dtype).requires_grad_()
                 for k, t in net.params[n].items()} for n in names}
        x = x32.to(dtype).requires_grad_()
        names_ = ["x"] + ["/".join(p) for p, _ in tree.leaves(P)]
        if not shards:
            y = whole(x, P)
            grads = torch.autograd.grad(
                y, [x] + [t for _, t in tree.leaves(P)], cot32.to(dtype))
            return y, dict(zip(names_, grads))
        transport = InProcessShards(shards)

        def piece(n, k, t, j):
            if (n, k) not in cut:
                return t  # whole: the shards read the same tensor
            dim, heads = cut[(n, k)]
            return shard_slice(t.detach(), dim, shards, j,
                               heads).requires_grad_()

        S = {n: [{k: piece(n, k, t, j) for k, t in P[n].items()}
                 for j in range(shards)]
             for n in ("blk0_attn", "blk0_ff1", "blk0_ff2")}
        y = split(x, P, S, transport)
        ins = [x] + [t for _, t in tree.leaves(P)] + [
            t for n in S for s in S[n] for k, t in sorted(s.items())
            if (n, k) in cut]
        grads = torch.autograd.grad(y, ins, cot32.to(dtype),
                                    allow_unused=True)
        it = iter(grads)
        got = {name: next(it) for name in names_}
        for n in S:
            for j, s in enumerate(S[n]):
                for k in sorted(s):
                    if (n, k) in cut:
                        got.setdefault(f"{n}/{k}#", []).append(next(it))
        for (n, k), (dim, heads) in cut.items():
            got[f"{n}/{k}"] = join_shards(got.pop(f"{n}/{k}#"), dim, heads)
        return y, got

    def named(y, grads):
        return {"y": y.detach(), **{k: v for k, v in grads.items()}}

    ref = named(*run(torch.float32, 0))
    whole_bf, gw = run(torch.bfloat16, 0)
    torch.cuda.synchronize()
    counters.reset()
    split_bf, gs = run(torch.bfloat16, m)
    torch.cuda.synchronize()
    launches = counters.read()
    errors = _split_gate(card, f"flagship block 0 over {m} model shards "
                               f"(K2/K6 at 1 head of 128 each)",
                         named(whole_bf, gw), named(split_bf, gs), ref)
    want = {k: 0 for k in launches}
    want.update({"K2": m, "K6": m})
    if launches != want:
        raise PhaseFailed("22d", f"the split block launched {launches}, "
                                 f"expected {want}")
    arm_ms = {"whole": event_ms(torch, lambda: run(torch.bfloat16, 0), 3),
              f"{m} shards": event_ms(torch, lambda: run(torch.bfloat16, m),
                                      3)}
    log22(card, f"22d: block forward + backward, bf16, batch {c['batch']} x "
        f"{c['seq']}: ms (CUDA events, median of 3) {arm_ms}; split "
        f"launches {launches}")
    return launches, errors, arm_ms


def shard_kernel_times(torch, fa, card):
    """K2 and K6 at a model shard's shape (B 32, T 512, 1 head of 128,
    bf16): event and device time a launch beside their bounds (for
    PERF.md's kernel table). Timing launches, not counted."""
    c = TRAIN
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    B, T, D = c["batch"], c["seq"], c["d_model"] // c["n_heads"]
    qkv = torch.randn((B, T, 3 * D), generator=g, device="cuda",
                      dtype=torch.bfloat16).requires_grad_()
    do = torch.randn((B, T, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)

    def fwd():
        return fa.flash_attention_qkv(qkv, 1, causal=True)

    out = fwd()
    bound, by, _ = flash_bound_ms(B, T, D, 2, True, False, PEAK_BF16_FLOPS)
    bbound, bby, _ = flash_bwd_bound_ms(B, T, D, 2, False, B)
    rec = {
        "K2": {"shape": f"packed B={B} T={T} H=1 D={D}",
               "ms": time_ms(torch, fwd),
               "device_ms": kernel_device_ms(torch, fwd),
               "bound_ms": bound, "bound_by": by},
        "K6": {"shape": f"packed B={B} T={T} H=1 D={D}",
               "ms": grad_ms(torch, out, (qkv,), do),
               "device_ms": kernel_device_ms(
                   torch, lambda: torch.autograd.grad(out, qkv, do,
                                                      retain_graph=True)),
               "bound_ms": bbound, "bound_by": bby}}
    log22(card, f"22d: a model shard's K2 / K6 (1 head of 128, B {B}, T "
        f"{T}, bf16): {rec}")
    return rec


def split_moe_on_card(torch, card):
    """22d, "expert": block 0's MoE layer of the MoE LM at bench width
    (8 experts, top 2, routed at capacity 1.25) on batch 32 x 512 tokens,
    split over 2 and 4 expert shards in this process against the whole
    layer, bf16, with an f32 reference held to the bf16 whole arm's
    routing (`pinned_routing`: near-tied router logits flip under
    rounding); the output, the aux loss and the gradients of x and of
    every param; each arm's forward + backward time."""
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.nn.layers import moe
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    c = TRAIN
    net = moe_lm(models).init(SEED)
    lc = net.layer_vertices["blk0_moe"].layer
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    x32 = torch.randn((c["batch"] * c["seq"], c["d_model"]), generator=g,
                      device="cuda")
    cot32 = torch.randn(x32.shape, generator=g, device="cuda")
    kw = dict(top_k=lc.top_k, capacity_factor=lc.capacity_factor,
              activation=lc.activation or "gelu",
              group_size=lc.router_group_size, return_aux=True)
    E = lc.n_experts

    def run(dtype, n):
        p = {k: t.detach().to(dtype).requires_grad_()
             for k, t in net.params["blk0_moe"].items()}
        x = x32.to(dtype).requires_grad_()
        experts = None
        if n:
            w = E // n
            experts = (InProcessShards(n), [
                {k: (t[j * w:(j + 1) * w] if k != "Wg" else t)
                 for k, t in p.items()} for j in range(n)])
        y, aux = moe.moe_apply_routed(p, x, experts=experts, **kw)
        grads = torch.autograd.grad((y * cot32.to(dtype)).sum() + aux,
                                    [x] + list(p.values()))
        return {"y": y.detach(), "aux": aux.detach().reshape(1),
                **dict(zip(["x"] + list(p), grads))}

    with pinned_routing(torch, moe) as pin:
        whole = run(torch.bfloat16, 0)
        pin.replay()
        ref = run(torch.float32, 0)
    errors, arm_ms = {}, {"whole": event_ms(torch, lambda: run(
        torch.bfloat16, 0), 3)}
    for n in EP_SHARDS:
        split = run(torch.bfloat16, n)
        if not torch.equal(split["aux"], whole["aux"]):
            raise PhaseFailed("22d", f"{n} expert shards: the aux loss "
                                     "differs from the whole layer's")
        errors[n] = _split_gate(card, f"MoE layer over {n} expert shards",
                                whole, split, ref)
        arm_ms[f"{n} shards"] = event_ms(torch, lambda n=n: run(
            torch.bfloat16, n), 3)
    log22(card, f"22d: MoE layer forward + backward, bf16, "
        f"{x32.shape[0]} tokens: ms (CUDA events, median of 3) {arm_ms}")
    return errors, arm_ms


def train_placements(torch, counters, fa, transformer_lm, DataSet, card):
    """Phase 22: the graph vertices (22a), the MultiLayerNetwork decode
    steps (22b), the "model" and "expert" roles and ZeRO-1 at world size
    1 over NCCL (22c), and the model and expert splits run as several
    shards in one process (22d). Returns the launches of its main-path
    runs and K2's and K6's times at a model shard's shape."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    graph = train_vertex_graph(torch, counters, card)
    mln = serve_mln(torch, counters, card)
    mesh = make_mesh({"data": 1, "model": 1, "expert": 1})
    try:
        roles, _ = roles_at_one_rank(torch, counters, transformer_lm,
                                     DataSet, mesh, card)
    finally:
        bootstrap.shutdown()
    block, _, _ = split_block_on_card(torch, counters, fa, transformer_lm,
                                      card)
    shard_times = shard_kernel_times(torch, fa, card)
    split_moe_on_card(torch, card)
    runs = (graph, mln, roles, block)
    launches = {k: sum(r.get(k, 0) for r in runs) for k in graph}
    log22(card, f"phase 22 in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    return launches, shard_times


# ------------------------------------------------------------ phase 23

# 23a: phase 6's flagship (batch 32 x 512, bf16) pipelined, 3 steps an
# arm; 8 microbatches of 4 rows; the in-process pipeline at 2 and 3
# stages (the 6 blocks divide into 1, 2, 3 and 6)
PIPE = dict(M=8, steps=3, stages=(2, 3), timed=3)
# tests/test_torch_pipeline.py's gate (the JAX package's PP-against-dense
# tolerance), held in f32: in bf16 a gradient's rounding flips Adam's
# step on its near-zero elements, which moves a weight by up to 2·lr a
# step whatever the pipeline does
PIPE_PARITY_TOL = 5e-4


def log23(card, msg):
    """A phase-23 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def pipe_want(M, steps, L):
    """The launches of `steps` pipelined flagship steps of M microbatches:
    K2 and K6 once a block a microbatch, K8 and K9 once a microbatch."""
    want = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                           "K9", "K9 dW", "K10", "K11", "K12", "K13")}
    want.update({"K2": L * M * steps, "K6": L * M * steps,
                 "K8": M * steps, "K9": M * steps, "K9 dW": M * steps})
    return want


def pipe_net(torch, transformer_lm, mesh, arm, dtype="bfloat16"):
    """The flagship from SEED, placed as `arm` says: "meshless", "pipe 1
    M=<m>" (set_mesh over the world-of-one mesh) or "in-process S=<s>"
    (parallel/pipeline.place_in_process, PIPE's M)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import place_in_process

    c = TRAIN
    net = transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                         n_heads=c["n_heads"], n_layers=c["n_layers"],
                         d_ff=c["d_ff"], max_length=c["seq"], dtype=dtype,
                         device="cuda").init(SEED)
    if arm.startswith("pipe 1"):
        net.set_mesh(mesh, axes={"pipe": "pipe"},
                     n_microbatches=int(arm.split("M=")[1]))
    elif arm.startswith("in-process"):
        place_in_process(net, int(arm.split("S=")[1]), PIPE["M"])
    return net


def max_param_diff(torch, a, b):
    from deeplearning4j_tpu_torch.nn import tree

    pb = b.canonical_params()
    return max(float((x.float() - tree.get(pb, p).float()).abs().max())
               for p, x in tree.leaves(a.canonical_params()))


def pipelined_flagship(torch, counters, transformer_lm, DataSet, mesh,
                       card):
    """23a: the flagship pipelined at world size 1 over NCCL: (i) "pipe"
    1 with M = 1 bit for bit with the meshless step and with phase 6's
    launch counts; (ii) M = 8 at "pipe" 1; (iii) S = 2 and S = 3 stages
    through the in-process transport, M = 8. Exact launch counts (K2 =
    K6 = 6·M·3, K8 = K9 = M·3); the canonical params of (ii) and (iii)
    within PIPE_PARITY_TOL of the meshless net's after 3 f32 steps (the
    bf16 arms' distance logged beside); each arm's step time, idle
    share, its time beside the meshless step's and the GPipe bubble S
    cards would idle, (S - 1) / (M + S - 1). Returns the launches of the
    pipelined arms and the step times."""
    c, n, M, L = TRAIN, PIPE["steps"], PIPE["M"], TRAIN["n_layers"]
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    arms = ["meshless", "pipe 1 M=1", f"pipe 1 M={M}"] + [
        f"in-process S={s}" for s in PIPE["stages"]]
    nets, runs, losses = {}, {}, {}
    for arm in arms:
        net = pipe_net(torch, transformer_lm, mesh, arm)
        torch.cuda.synchronize()
        counters.reset()
        losses[arm] = []
        for _ in range(n):
            net.fit(ds)
            losses[arm].append(net._score_raw)
        torch.cuda.synchronize()
        runs[arm] = counters.read()
        losses[arm] = [float(x) for x in losses[arm]]
        nets[arm] = net
    same = (canonical_equal(torch, nets["meshless"], nets["pipe 1 M=1"])
            and losses["meshless"] == losses["pipe 1 M=1"])
    log23(card, f"23a(i): \"pipe\" 1, M = 1 (NCCL, world size 1), {n} "
          f"steps: params and every loss bit for bit with the meshless "
          f"net's {same}; losses {losses['pipe 1 M=1']}; launches "
          f"{runs['pipe 1 M=1']}")
    if not same:
        raise PhaseFailed("23a", "\"pipe\" 1 at M = 1 is not the meshless "
                                 "step bit for bit")
    for arm in arms:
        want = pipe_want(1 if arm in ("meshless", "pipe 1 M=1") else M, n,
                         L)
        if runs[arm] != want:
            raise PhaseFailed("23a", f"{arm}: launches {runs[arm]}, "
                                     f"expected {want}")
    bf16_gap = {arm: max_param_diff(torch, nets["meshless"], nets[arm])
                for arm in arms[2:]}
    f32 = {arm: pipe_net(torch, transformer_lm, mesh, arm, "float32")
           for arm in ["meshless"] + arms[2:]}
    for net in f32.values():
        for _ in range(n):
            net.fit(ds)
    gap = {arm: max_param_diff(torch, f32["meshless"], f32[arm])
           for arm in arms[2:]}
    log23(card, f"23a(ii, iii): M = {M}, {n} steps: launches "
          f"{runs[arms[2]]} each arm (exact); canonical params' largest "
          f"distance from the meshless net's, f32 twins {gap} (gate "
          f"{PIPE_PARITY_TOL}), bf16 arms {bf16_gap}; losses "
          f"{ {a: losses[a] for a in arms[2:]} } against meshless "
          f"{losses['meshless']}")
    bad = {a: g for a, g in gap.items() if not g <= PIPE_PARITY_TOL}
    if bad:
        raise PhaseFailed("23a", f"pipelined params off the meshless net's "
                                 f"by {bad} (f32)")
    del f32
    steps, idle = {}, {}
    for arm in arms:
        net = nets[arm]
        steps[arm] = event_ms(torch, lambda nt=net: nt.fit(ds), PIPE["timed"])
        idle[arm], _, _ = profiled(torch, lambda nt=net: nt.fit(ds),
                                   f"23a: {arm} step", top=5)
    base = steps["meshless"]
    rows = {}
    for arm in arms:
        S = int(arm.split("S=")[1]) if "S=" in arm else 1
        m = 1 if arm in ("meshless", "pipe 1 M=1") else M
        rows[arm] = {"step_ms": steps[arm], "idle_share": idle[arm],
                     "against_meshless": steps[arm] / base,
                     "gpipe_bubble_on_S_cards": (S - 1) / (m + S - 1)}
    log23(card, f"23a: median step ms (CUDA events, {PIPE['timed']} steps "
          f"after one warm), idle share of a profiled step, step against "
          f"the meshless step's, and the bubble S cards would idle: "
          f"{rows}")
    launches = {k: sum(runs[a][k] for a in arms[1:]) for k in runs[arms[0]]}
    return launches, rows


def reshard_on_card(torch, counters, transformer_lm, DataSet, mesh, card):
    """23b: the flagship's params moved live on the card between "model"
    2 in-process shards and one (reshard/executor.reshard_in_process),
    both ways, bit for bit (each shard its tensor_parallel slice); the
    bytes moved beside the plan's and its lower bound, and the reshard
    spans' time. Then a checkpoint written under {"data": 1, "model": 1}
    restored into a net under {"pipe": 1} (M = 2), and one step, bit for
    bit with a twin restored meshless and placed the same way; then that
    net re-placed by set_mesh (reshard_net_live, on the record), its
    params unchanged and its span's bytes the plan's. Returns that
    step's launches."""
    import tempfile

    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        SplitPlan,
        resolve_rules,
        shard_slice,
    )
    from deeplearning4j_tpu_torch.reshard import executor as ex
    from deeplearning4j_tpu_torch.reshard.planner import Placement
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    net = pipe_net(torch, transformer_lm, mesh, "meshless")
    net.fit(ds)
    like = {p: (tuple(t.shape), t.dtype) for p, t in tree.leaves(net.params)}
    vmesh = ex.virtual_mesh({"model": 2}, "cuda")
    split = SplitPlan(net, vmesh, resolve_rules({"model": "model"}))
    one, two = ex.PortLayout(like, 1), ex.PortLayout(like, 2, vmesh, split)
    solo = Placement.solo()
    m2 = Placement.of({"model": 2}, {"model": "model"}, process_count=2)
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        torch.cuda.synchronize()
        out = ex.reshard_in_process({0: net.params}, one, two, src_pl=solo,
                                    dst_pl=m2)
        torch.cuda.synchronize()
        back = ex.reshard_in_process(out[2], two, one, src_pl=m2,
                                     dst_pl=solo)
        torch.cuda.synchronize()
    finally:
        set_default(prev)
    same = all(torch.equal(tree.get(back[2][0], p), t)
               for p, t in tree.leaves(net.params))
    for r in (0, 1):
        for p, t in tree.leaves(net.params):
            if p in split.leaves:
                _, dim, heads = split.leaves[p]
                t = shard_slice(t, dim, 2, r, heads)
            same &= torch.equal(tree.get(out[2][r], p), t)
    spans = [e["seconds"] for e in rec.events
             if e.get("event") == "span" and e.get("name") == "reshard"]
    moves = {"1 -> model 2": out, "model 2 -> 1": back}
    log23(card, "23b: live moves of the flagship's params on the card: "
          + "; ".join(f"{k}: {v[1]} bytes moved, plan {v[0].bytes_moved} "
                      f"(lower bound {v[0].bytes_lower_bound}, actions "
                      f"{v[0].actions()})" for k, v in moves.items())
          + f"; reshard spans {spans} s; bit for bit {same}")
    if not same or len(spans) != 2:
        raise PhaseFailed("23b", "the live moves changed the params")
    if any(v[1] != v[0].bytes_moved for v in moves.values()):
        raise PhaseFailed("23b", "the live moves did not move the plan's "
                                 "bytes")
    with tempfile.TemporaryDirectory() as d:
        src = pipe_net(torch, transformer_lm, mesh, "meshless")
        src.set_mesh(mesh, axes={"data": "data", "model": "model"})
        src.fit(ds)
        Checkpointer(d).save(src)
        placed = pipe_net(torch, transformer_lm, mesh, "pipe 1 M=2")
        rec = Recorder(path=None)
        prev = set_default(rec)
        try:
            Checkpointer(d).restore(placed)
        finally:
            set_default(prev)
        twin = pipe_net(torch, transformer_lm, mesh, "meshless")
        Checkpointer(d).restore(twin)
        twin.set_mesh(mesh, axes={"pipe": "pipe"}, n_microbatches=2)
    plans = [e for e in rec.events if e.get("event") == "reshard_plan"]
    read = [(e["seconds"], e["bytes_moved"], e["bytes_planned"])
            for e in rec.events
            if e.get("event") == "span" and e.get("name") == "reshard"]
    restored = (canonical_equal(torch, placed, src) and len(read) == 1
                and read[0][1] == read[0][2])
    torch.cuda.synchronize()
    counters.reset()
    placed.fit(ds)
    torch.cuda.synchronize()
    launches = counters.read()
    twin.fit(ds)
    stepped = (canonical_equal(torch, placed, twin)
               and placed.score_value == twin.score_value)
    log23(card, f"23b: checkpoint of {{data 1, model 1}} restored into "
          f"{{pipe 1}} (M = 2): canonical params equal the source's "
          f"{restored}, plan "
          f"{[(p['src'], p['dst'], p['bytes_moved']) for p in plans]}, "
          f"reshard span {read} (s, bytes read, planned); "
          f"one step bit for bit with the twin restored meshless and "
          f"placed the same way {stepped}; launches {launches}")
    if not (restored and stepped and plans):
        raise PhaseFailed("23b", "the restore into a placed net is not bit "
                                 "for bit")
    # the placed net re-placed by set_mesh: reshard_net_live, on the record
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        placed.set_mesh(mesh, axes={"data": "data", "model": "model"})
    finally:
        set_default(prev)
    live = [e for e in rec.events if e.get("event") == "span"
            and e.get("name") == "reshard"]
    replaced = (canonical_equal(torch, placed, twin) and len(live) == 1
                and live[0]["bytes_moved"] == live[0]["bytes_planned"])
    spans = [(e["seconds"], e["bytes_moved"], e["bytes_planned"])
             for e in live]
    log23(card, f"23b: set_mesh of the restored net from {{pipe 1}} to "
          f"{{data 1, model 1}} (reshard_net_live): reshard spans {spans} "
          f"(s, bytes moved, planned); params bit for bit {replaced}")
    if not replaced:
        raise PhaseFailed("23b", "set_mesh of a placed net did not move it "
                                 "by its plan")
    for nt in (src, placed, twin):
        nt.set_mesh(None)
    return launches


def search_on_card(torch, counters, transformer_lm, DataSet, mesh, card):
    """23c: search_placement for the flagship on FleetShape(1, 1), its
    winner fed to set_mesh, 3 steps bit for bit with the meshless net's
    and phase 6's launch counts. Returns the launches and the search."""
    from deeplearning4j_tpu_torch.reshard import (
        FleetShape,
        Objective,
        search_placement,
    )
    from deeplearning4j_tpu_torch.reshard.search import emit_search_event
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    c, n = TRAIN, PIPE["steps"]
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    net = pipe_net(torch, transformer_lm, mesh, "meshless")
    plain = pipe_net(torch, transformer_lm, mesh, "meshless")
    t0 = time.perf_counter()
    res = search_placement(net, FleetShape(1, 1),
                           objective=Objective(global_batch=c["batch"]))
    search_ms = (time.perf_counter() - t0) * 1e3
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        emit_search_event(res, path="chip_smoke", search_ms=search_ms)
    finally:
        set_default(prev)
    events = [e for e in rec.events if e.get("event") == "placement_search"]
    net.set_mesh(res.winner)
    runs = {}
    for arm, nt in (("meshless", plain), ("winner", net)):
        torch.cuda.synchronize()
        counters.reset()
        for _ in range(n):
            nt.fit(ds)
        torch.cuda.synchronize()
        runs[arm] = counters.read()
    same = (canonical_equal(torch, plain, net)
            and plain.score_value == net.score_value)
    log23(card, f"23c: search on FleetShape(1, 1): {len(res.candidates)} "
          f"feasible, {len(res.pruned)} pruned, winner "
          f"{res.winner.describe()} (score {float(res.best.score):.0f}), "
          f"{search_ms:.2f} ms (host); placement_search events "
          f"{len(events)}; {n} steps under it bit for bit with the "
          f"meshless net {same}; launches {runs['winner']}")
    if not same or len(events) != 1 or runs["winner"] != pipe_want(1, n,
                                                                   c["n_layers"]):
        raise PhaseFailed("23c", "the searched placement's steps are not "
                                 "the meshless steps")
    net.set_mesh(None)
    return runs["winner"], res


def bench_arm_on_card(search, card):
    """23c: reshard/bench_arm in a process of its own, the search's
    winner at the flagship's dims (bf16, batch 32 x 512): its median
    step time, and its measured peak bytes against the search's
    predicted per-device bytes (the bench arm's `cost_drift`)."""
    c = TRAIN
    spec = {"placement": search.winner.to_json(), "dtype": "bfloat16",
            "dims": dict(vocab_size=c["vocab_size"], d_model=c["d_model"],
                         n_heads=c["n_heads"], n_layers=c["n_layers"],
                         d_ff=c["d_ff"], max_length=c["seq"]),
            "batch": c["batch"], "seed": SEED, "warm": 2, "repeats": 5,
            "device": "cuda",
            "predicted_bytes": float(search.best.memory_bytes)}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.reshard.bench_arm",
         json.dumps(spec)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if out.returncode or not lines:
        raise PhaseFailed("23c", f"bench_arm exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
    result = json.loads(lines[-1][len("RESULT "):])
    log23(card, f"23c: bench_arm (its own process) {result['placement']}: "
          f"median step {result['ms_per_step']:.3f} ms of "
          f"{[round(t, 3) for t in result['times_ms']]} (host clock, the "
          f"card synchronized), loss {result['loss']:.4f}; measured peak "
          f"{result['measured_bytes']} bytes against the search's "
          f"predicted {result['predicted_bytes']:.0f} (ratio "
          f"{result['measured_bytes'] / result['predicted_bytes']:.4f})")
    if not result["measured_bytes"] > 0:
        raise PhaseFailed("23c", f"bench_arm measured {result}")
    return result


def check_microbatch_kernels(torch, fa, fsx, card):
    """K2 and K6 at a microbatch's shape (packed B 4, T 512, 2 heads of
    128) and K8 and K9 at its rows (N = 2048, d 256, V 10000; K9's dW
    slices of N follow N), f32 and bf16, each against its plain version
    on the same inputs at phase 2's tolerances: K2's o and lse within
    TOL, K6's dqkv and K9's dx/dW/db within REL_TOL of their largest
    entry, K8's loss and lse within XENT_FWD_TOL (o and lse from the
    plain forward feed both backwards, as in phase 2). Returns the
    largest absolute errors."""
    c = TRAIN
    B, T, H = c["batch"] // PIPE["M"], c["seq"], c["n_heads"]
    D = c["d_model"] // H
    N, d, V = B * T, c["d_model"], c["vocab_size"]
    scale = D ** -0.5
    gen = torch.Generator(device="cpu").manual_seed(SEED + 25)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        qkv = torch.randn(B, T, 3 * H * D, generator=gen).to("cuda", dtype)
        do = torch.randn(B, T, H * D, generator=gen).to("cuda", dtype)
        x, w, b = (t.to("cuda", dtype) for t in (
            torch.randn(N, d, generator=gen),
            0.05 * torch.randn(d, V, generator=gen),
            0.01 * torch.randn(V, generator=gen)))
        labels = torch.randint(0, V, (N,), generator=gen).to(
            "cuda", torch.int32)
        g = (torch.rand(N, generator=gen) / N).to("cuda")
        o, lse = fa._flash_fwd_qkv(qkv, H, None, scale, True)
        ro, rlse = fa._flash_fwd_qkv_reference(qkv, H, None, scale, True)
        dqkv = fa._flash_bwd_qkv(qkv, ro, rlse, do, H, None, scale, True)
        rdqkv = fa._flash_bwd_qkv_reference(qkv, ro, rlse, do, H, None,
                                            scale, True)
        loss, xlse = fsx._fused_fwd(x, w, b, labels)
        rloss, rxlse = fsx._xent_fwd_reference(x, w, b, labels)
        grads = fsx._fused_bwd(x, w, b, labels, rxlse, g)
        refs = fsx._xent_bwd_reference(x, w, b, labels, rxlse, g)
        torch.cuda.synchronize()
        tol = TOL[dname]
        err_o = float((o.float() - ro.float()).abs().max())
        err_l = float((lse - rlse).abs().max())
        k6_abs, k6 = errs(dqkv, rdqkv)
        k8_abs, k8 = (max(e) for e in zip(errs(loss, rloss),
                                          errs(xlse, rxlse)))
        k9_abs, k9 = (max(e) for e in zip(
            *(errs(a, r) for a, r in zip(grads, refs))))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, dqkv, loss, *grads))
        rows = [("K2", f"o {err_o:.3e}, lse {err_l:.3e} (tol o "
                       f"{tol['o']}, lse {tol['lse']})",
                 err_o <= tol["o"] and err_l <= tol["lse"]),
                ("K6", f"dqkv rel {k6:.3e} (tol {REL_TOL[dname]})",
                 k6 <= REL_TOL[dname]),
                ("K8", f"loss/lse rel {k8:.3e} (tol {XENT_FWD_TOL})",
                 k8 <= XENT_FWD_TOL),
                ("K9", f"dx/dW/db rel {k9:.3e} (tol {REL_TOL[dname]})",
                 k9 <= REL_TOL[dname])]
        for kern, err in (("K2", err_o), ("K6", k6_abs), ("K8", k8_abs),
                          ("K9", k9_abs)):
            worst[kern] = max(worst.get(kern, 0.0), err)
        for kern, what, ok in rows:
            log23(card, f"check {kern} at a microbatch (B={B} T={T} H={H} "
                  f"D={D}; N={N} d={d} V={V}) {dname}: {what}, finite "
                  f"{finite} -> {'ok' if ok and finite else 'FAIL'}")
            if not (ok and finite):
                raise PhaseFailed("23a", f"{kern} at a microbatch's shape "
                                         f"({dname}) disagrees with its "
                                         f"plain version")
    return worst


def microbatch_kernel_times(torch, fa, fsx, card):
    """K2 and K6 at a microbatch's shape (B 4, T 512, 2 heads of 128) and
    K8 and K9 at its rows (N = 2048, d 256, V 10000), bf16: event time,
    device time a launch, the bound and one PyTorch call's time (SDPA,
    F.cross_entropy forward and backward) and the plain version's time,
    for PERF.md's kernel table. Timing launches, not counted."""
    import torch.nn.functional as F

    c = TRAIN
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    B, T, H = c["batch"] // PIPE["M"], c["seq"], c["n_heads"]
    D = c["d_model"] // H
    qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda",
                      dtype=torch.bfloat16).requires_grad_()
    do = torch.randn((B, T, H * D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2).contiguous()
               .requires_grad_() for t in qkv.detach().chunk(3, dim=-1))
    do4 = do.reshape(B, T, H, D).transpose(1, 2).contiguous()

    def fwd():
        return fa.flash_attention_qkv(qkv, H, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    scale = D ** -0.5
    out, lib_out = fwd(), sdpa()
    ro, rlse = fa._flash_fwd_qkv_reference(qkv.detach(), H, None, scale,
                                           True)

    def plain_fwd():
        return fa._flash_fwd_qkv_reference(qkv.detach(), H, None, scale,
                                           True)

    def plain_bwd():
        return fa._flash_bwd_qkv_reference(qkv.detach(), ro, rlse, do, H,
                                           None, scale, True)

    bound, by, _ = flash_bound_ms(B * H, T, D, 2, True, False,
                                  PEAK_BF16_FLOPS)
    bbound, bby, _ = flash_bwd_bound_ms(B * H, T, D, 2, False, B)
    shape = f"packed B={B} T={T} H={H} D={D}"
    rec = {
        "K2": {"shape": shape, "ms": time_ms(torch, fwd),
               "device_ms": kernel_device_ms(torch, fwd),
               "library_ms": time_ms(torch, sdpa), "bound_ms": bound,
               "bound_by": by, "plain_ms": time_ms(torch, plain_fwd)},
        "K6": {"shape": shape,
               "ms": grad_ms(torch, out, (qkv,), do),
               "device_ms": kernel_device_ms(
                   torch, lambda: torch.autograd.grad(out, qkv, do,
                                                      retain_graph=True)),
               "library_ms": grad_ms(torch, lib_out, (q, k, v), do4),
               "bound_ms": bbound, "bound_by": bby,
               "plain_ms": time_ms(torch, plain_bwd)}}
    N, d, V = B * T, c["d_model"], c["vocab_size"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 24)
    x = torch.randn(N, d, generator=gen).to("cuda", torch.bfloat16)
    w = (0.05 * torch.randn(d, V, generator=gen)).to("cuda", torch.bfloat16)
    b = (0.01 * torch.randn(V, generator=gen)).to("cuda", torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen).to("cuda", torch.int32)
    gl = (torch.rand(N, generator=gen) / N).to("cuda")
    _, lse = fsx._fused_fwd(x, w, b, labels)
    lab64 = labels.long()
    lx, lw, lb = (t.clone().requires_grad_() for t in (x, w, b))
    lib_loss = F.cross_entropy(lx @ lw + lb, lab64, reduction="none")
    for kern, run, plain, lib, backward in (
            ("K8", lambda: fsx._fused_fwd(x, w, b, labels),
             lambda: fsx._xent_fwd_reference(x, w, b, labels),
             lambda: F.cross_entropy(x @ w + b, lab64, reduction="none"),
             False),
            ("K9", lambda: fsx._fused_bwd(x, w, b, labels, lse, gl),
             lambda: fsx._xent_bwd_reference(x, w, b, labels, lse, gl),
             lambda: torch.autograd.grad(lib_loss, (lx, lw, lb), gl,
                                         retain_graph=True), True)):
        bms, bby2, _ = xent_bound_ms(N, d, V, 2, backward)
        rec[kern] = {"shape": f"N={N} d={d} V={V}", "ms": time_ms(torch, run),
                     "device_ms": kernel_device_ms(torch, run),
                     "plain_ms": time_ms(torch, plain),
                     "library_ms": time_ms(torch, lib), "bound_ms": bms,
                     "bound_by": bby2}
    log23(card, f"23a: the kernels at a microbatch's shape (bf16): {rec}")
    return rec


def train_pipeline(torch, counters, fa, fsx, transformer_lm, DataSet, card):
    """Phase 23: pipeline parallelism (23a), the resharding engine (23b)
    and the placement search (23c) at world size 1 over NCCL on the one
    card. Returns the launches of its main-path runs and the kernels'
    times at a microbatch's shape."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh({"data": 1, "model": 1, "pipe": 1})
    try:
        pipe_launches, _ = pipelined_flagship(torch, counters,
                                              transformer_lm, DataSet,
                                              mesh, card)
        restore_launches = reshard_on_card(torch, counters, transformer_lm,
                                           DataSet, mesh, card)
        search_launches, search = search_on_card(
            torch, counters, transformer_lm, DataSet, mesh, card)
    finally:
        bootstrap.shutdown()
    bench_arm_on_card(search, card)
    worst = check_microbatch_kernels(torch, fa, fsx, card)
    times = microbatch_kernel_times(torch, fa, fsx, card)
    for kern, err in worst.items():
        times[kern]["max_abs_err"] = err
    runs = (pipe_launches, restore_launches, search_launches)
    launches = {k: sum(r.get(k, 0) for r in runs) for k in pipe_launches}
    log23(card, f"phase 23 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches, times


# ------------------------------------------------------------ phase 24

# 24a: phase 6's flagship trained by ElasticSupervisor at world size 1
# over NCCL: 6 steps, a checkpoint every step, the one worker killed
# after step 3 and replaced
ELASTIC = dict(steps=6, faults="p0:kill@step3", gen_timeout=600.0)
# 24b: run_elastic_worker, two workers on the card averaging through a
# ClusterCoordinator, each on half of phase 6's rows, 3 rounds; worker 1
# dies at its second round and is restarted from its checkpoint
AVERAGING = dict(rounds=3, crash_after=1, heartbeat_timeout=15.0,
                 proc_timeout=600)
# 24c: bench mode `embed`'s train half (EMBED) through the engine at ep =
# 1, at ep = 2 and 4 as shards in one process, and at dp = 2 in one
# process
ENGINE_ARMS = ((1, 1), (2, 1), (4, 1), (1, 2))
# the arms' tables after EMBED["train_steps"] steps against ep = 1's,
# relative to the largest entry: index_add_'s atomics sum duplicate rows
# in an order that changes from run to run (the card's tables stood
# 9.208e-7 from the CPU's after 20 steps on an H100), and dp = 2 joins
# the data shards' pairs in another order -> 1e-5
ENGINE_SHARD_TOL = 1e-5
# 24d: 20a's pipeline and 20e's GloVe with "data" = 2 shards in one
# process against their meshless runs from the same init and draws: the
# shards' sums, and index_add_'s atomics in both runs, add in another
# order over a whole epoch -> 1e-4 of the largest table entry (phase
# 12's bound for 50 engine steps of atomic order); the per-update losses
# 1e-4 relative
MESH_TOL = 1e-4


def log24(card, msg):
    """A phase-24 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def _kernel_modules():
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_neg_softmax as fns
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    return fa, fsx, fns, fln, fsm


def _write_json(path, obj):
    tmp = Path(f"{path}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def elastic_worker(ckpt, out, started):
    """`--elastic-worker CKPT OUT`: one member of 24a's fleet, launched by
    ElasticSupervisor. Restores the latest checkpoint, trains the
    flagship to the supervisor's step budget through
    `run_elastic_steps` on the searched placement of its fleet, and
    writes OUT/<worker>.json after every step (its launch counts; the
    restore's record: its `reshard_plan` and, where the placement
    splits a leaf, its `reshard` span's seconds and the bytes this rank
    read against the plan's, else the whole checkpoint's bytes, which a
    rank that keeps every leaf whole reads; the whole resume_from's
    seconds, placement included; the time from its start to its first
    step) and OUT/<worker>_params.pt at the end."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.distributed import bootstrap, elastic
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.reshard.search import Objective
    from deeplearning4j_tpu_torch.telemetry import get_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = elastic.worker_total_steps()
    info = bootstrap.initialize()
    worker = os.environ[elastic.ENV_MEMBERS].split(",")[info["process_id"]]
    counters = Counters(*_kernel_modules())
    counters.reset()
    c = TRAIN
    net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    mesh, axes, result = elastic.searched_global_mesh(
        net, objective=Objective(global_batch=c["batch"]))
    # the restore through the resharding engine into the searched
    # placement (29c): the net is left placed on the global mesh, and
    # the restore is on the record
    record = []
    get_default().add_sink(lambda ev: record.append(ev) if (
        ev.get("event") == "reshard_plan" or (
            ev.get("event") == "span" and ev.get("name") == "reshard"))
        else None)
    t0 = time.perf_counter()
    start = net.resume_from(ckpt, target_mesh=mesh, target_axes=axes)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    read = [e for e in record if e["event"] == "span"]
    progress = {"worker": worker, "start_step": start,
                "resume_s": resume_s,
                "restore_plans": [(e["src"], e["dst"], e["bytes_moved"])
                                  for e in record
                                  if e["event"] == "reshard_plan"],
                "restore_spans": len(read),
                "first_step_s": None, "steps": [], "launches": {}}
    if read:  # a split placement: each rank reads its part
        progress.update(
            restore_s=sum(e["seconds"] for e in read),
            restore_bytes=sum(e["bytes_moved"] for e in read),
            restore_planned=sum(e["bytes_planned"] for e in read))
    elif start:  # every leaf whole on this rank: the whole file read
        progress.update(restore_s=None, restore_planned=None,
                        restore_bytes=Checkpointer(ckpt).read_meta(start)[
                            "model_bytes"])
    progress["placement"] = result.winner.describe()
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    path = Path(out) / f"{worker}.json"

    def on_event(ev):
        if ev.get("event") != "step":
            return
        if progress["first_step_s"] is None:
            progress["first_step_s"] = time.time() - started
        progress["steps"].append(ev["iteration"])
        progress["launches"] = counters.read()
        _write_json(path, progress)

    get_default().add_sink(on_event)
    elastic.run_elastic_steps(net, lambda step: ds, total,
                              checkpoint_dir=ckpt, checkpoint_every=1)
    torch.cuda.synchronize()
    torch.save(net.canonical_params(), Path(out) / f"{worker}_params.pt")
    bootstrap.shutdown()
    return 0


def _same_trees(torch, a, b):
    """(equal bit for bit, largest absolute difference) of two param
    trees of the same nest."""
    from deeplearning4j_tpu_torch.nn import tree

    worst, same = 0.0, True
    for p, x in tree.leaves(a):
        y = tree.get(b, p)
        same &= bool(torch.equal(x, y))
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return same, worst


def _supervised(torch, tmp, tag, card, faults=None):
    """One ElasticSupervisor run of `--elastic-worker` on the card:
    (result, its journal, the supervisor's events, the workers'
    progress, the fleet's telemetry dir)."""
    from deeplearning4j_tpu_torch.distributed import elastic
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    d = tmp / tag
    ckpt, out = d / "ckpt", d / "out"
    ckpt.mkdir(parents=True)
    out.mkdir()
    rec = Recorder(path=None)
    prev = set_default(rec)
    sup = elastic.ElasticSupervisor(
        elastic.main_argv(str(Path(__file__).resolve()), "--elastic-worker",
                          str(ckpt), str(out)),
        n_processes=1, min_processes=1, max_reforms=2, device="cuda",
        total_steps=ELASTIC["steps"], checkpoint_dir=str(ckpt),
        gen_timeout=ELASTIC["gen_timeout"], death_grace=30.0,
        faults=faults, snapshot_path=str(d / "coord.json"),
        extra_env={"PYTHONPATH": str(ROOT),
                   "DL4J_TPU_TELEMETRY": str(d / "fleet.jsonl")},
        cwd=str(ROOT))
    try:
        result = sup.run()
        journal = {g.gen: sup.coordinator.read_config(
            f"elastic/members/{g.gen}") for g in result.generations}
    finally:
        set_default(prev)
        sup.close()
    progress = {p.stem: json.loads(p.read_text())
                for p in sorted(out.glob("w*.json"))}
    for g in result.generations:
        for r in g.results:
            if r.exit_class not in ("clean", "injected-kill"):
                log("\n".join(r.lines[-40:]))
    return result, journal, rec.events, progress, out, d


def elastic_on_card(torch, card):
    """24a: the flagship under ElasticSupervisor at world size 1 over
    NCCL, uninterrupted and with its worker killed after step 3 and
    replaced; returns the launches of both runs' workers."""
    import tempfile

    from deeplearning4j_tpu_torch.nn import tree

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    whole = _supervised(torch, tmp, "whole", card)
    killed = _supervised(torch, tmp, "killed", card, ELASTIC["faults"])
    S, L = ELASTIC["steps"], TRAIN["n_layers"]
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    failures = []
    w_res, _, _, w_prog, w_out, _ = whole
    k_res, journal, sup_events, k_prog, k_out, k_dir = killed
    # the killed run's shards, which phase 27a's tools read
    TRACES["24a elastic fleet"] = str(k_dir / "fleet.jsonl")
    classes = [g.exit_classes for g in k_res.generations]
    members = [g.members for g in k_res.generations]
    if [g.exit_classes for g in w_res.generations] != [["clean"]]:
        failures.append(f"uninterrupted run {w_res.generations}")
    if classes != [["injected-kill"], ["clean"]] or \
            members != [["w0"], ["w1"]]:
        failures.append(f"generations {classes} of members {members}")
    w_launch = w_prog["w0"]["launches"]
    summed = {k: k_prog["w0"]["launches"].get(k, 0)
              + k_prog.get("w1", {}).get("launches", {}).get(k, 0)
              for k in want}
    if w_launch != want or summed != want:
        failures.append(f"launches uninterrupted {w_launch}, summed over "
                        f"the generations {summed}; expected {want}")
    if k_prog["w0"]["steps"] != [1, 2, 3] or \
            k_prog.get("w1", {}).get("start_step") != 3:
        failures.append(f"steps {k_prog['w0']['steps']}, the replacement "
                        f"resumed at {k_prog.get('w1', {}).get('start_step')}")
    fleet = [json.loads(line) for line in
             (k_dir / "fleet.jsonl.p0").read_text().splitlines()]
    resumes = [(e["worker"], e["start_step"], e["coordinator_rank"],
                e["reassigned_from"]) for e in fleet
               if e.get("name") == "elastic_resume"]
    if resumes != [("w0", 0, 0, None), ("w1", 3, 0, "w0")]:
        failures.append(f"elastic_resume records {resumes}")
    reform = [e for e in sup_events if e["event"] == "fault"
              and e["kind"] == "reform"]
    if len(reform) != 1 or sorted(journal) != [0, 1] or \
            journal[1]["replacements"] != ["w1"]:
        failures.append(f"journal {journal}, reform events {reform}")
    a = torch.load(w_out / "w0_params.pt", map_location="cpu")
    b = torch.load(k_out / "w1_params.pt", map_location="cpu")
    same, dist = _same_trees(torch, a, b)
    n_params = sum(t.numel() for _, t in tree.leaves(a))
    gate = "bit for bit"
    if not same:
        # only a nondeterministic op on the path explains a difference:
        # the gate becomes the distance of two uninterrupted runs
        again = _supervised(torch, tmp, "whole2", card)
        floor = _same_trees(torch, a, torch.load(
            again[4] / "w0_params.pt", map_location="cpu"))[1]
        gate = f"within two uninterrupted runs' distance {floor:.3e}"
        if not (floor > 0 and dist <= floor):
            failures.append(f"params {dist:.3e} from the uninterrupted "
                            f"run's (two uninterrupted runs: {floor:.3e})")
    gen_s = [round(g.seconds, 3) for g in k_res.generations]
    rep = k_prog.get("w1", {})
    if not rep.get("restore_plans") or (
            rep.get("restore_spans")
            and rep.get("restore_bytes") != rep.get("restore_planned")):
        failures.append(f"the replacement's restore: plans "
                        f"{rep.get('restore_plans')}, "
                        f"{rep.get('restore_spans')} reshard spans, "
                        f"{rep.get('restore_bytes')} bytes read, "
                        f"{rep.get('restore_planned')} planned")
    if rep.get("restore_spans"):
        read = (f"its reshard span read {rep.get('restore_bytes')} bytes "
                f"(planned {rep.get('restore_planned')}) in "
                f"{rep.get('restore_s'):.4f} s")
    else:
        read = (f"the placement keeps every leaf whole, so it read the "
                f"whole checkpoint ({rep.get('restore_bytes')} bytes; no "
                f"reshard span)")
    log24(card, f"24a: ElasticSupervisor, flagship ({n_params} params, "
          f"bf16, batch {TRAIN['batch']} x {TRAIN['seq']}), {S} steps, a "
          f"checkpoint a step, faults {ELASTIC['faults']}: generations "
          f"{classes} of members {members}, wall {gen_s} s "
          f"(uninterrupted {[round(g.seconds, 3) for g in w_res.generations]}"
          f" s); placement {rep.get('placement')}; the replacement's "
          f"resume_from(target_mesh=...) of step {rep.get('start_step')} "
          f"took {rep.get('resume_s', 0):.4f} s, placement included, plan "
          f"{rep.get('restore_plans')}; {read}; it took its first step "
          f"{rep.get('first_step_s', 0):.3f} s after its start (host "
          f"clock); resumes {resumes}; final params against the "
          f"uninterrupted run: equal {same}, largest difference "
          f"{dist:.3e} (gate: {gate}); launches {summed} summed over the "
          f"generations, uninterrupted {w_launch}")
    if failures:
        raise PhaseFailed("24a", "; ".join(failures))
    return {k: w_launch[k] + summed[k] for k in want}


def zip_step(path):
    """The step counter a ModelSerializer zip holds (its meta.json)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))["iteration"]


def average_worker(address, worker, shard, ckpt, out, crash_after):
    """`--average-worker ADDRESS WORKER SHARD CKPT OUT CRASH_AFTER`: one
    of 24b's workers. Trains the flagship on its half of phase 6's rows
    through `run_elastic_worker` (averaging every step through the
    coordinator at ADDRESS, a checkpoint after each round); with
    CRASH_AFTER > 0 it dies at that round's next average. Writes
    OUT/<worker>.json and OUT/<worker>_params.pt. CKPT is the worker's
    ModelSerializer zip."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel import cluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    counters = Counters(*_kernel_modules())
    counters.reset()
    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    half = c["batch"] // 2
    rows = slice(0, half) if shard == "0" else slice(half, c["batch"])
    mine = DataSet(ds.features[rows], ds.labels[rows])
    net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    resumed = zip_step(ckpt) if os.path.exists(ckpt) else 0
    rounds, calls = [], [0]
    real = cluster.ClusterClient.average

    def average(self, step, flat):
        calls[0] += 1
        if crash_after and calls[0] > crash_after:
            os._exit(1)
        t = time.perf_counter()
        avg = real(self, step, flat)
        rounds.append([step, time.perf_counter() - t, int(flat.nbytes)])
        return avg

    cluster.ClusterClient.average = average
    net = cluster.run_elastic_worker(
        address, worker, net, [mine] * AVERAGING["rounds"], sync_every=1,
        checkpoint_path=ckpt)
    torch.cuda.synchronize()
    torch.save(net.canonical_params(), Path(out) / f"{worker}_params.pt")
    _write_json(Path(out) / f"{worker}.json",
                {"resumed_at": resumed, "iteration": net.iteration_count,
                 "rounds": rounds, "launches": counters.read()})
    return 0


def averaged_reference(torch, transformer_lm, DataSet, ck_round,
                       contributors):
    """24b's reference, in this process: two flagships from the same
    init, each fit on its half of phase 6's rows, their flat params
    averaged in plain numpy after every step over the workers the
    coordinator counted in that round (`contributors`: step -> worker
    ids); worker 1's net after its crash a fresh one restored from its
    checkpoint zip (`ck_round`), as its restart was. Returns (the final
    params of worker 0's net, the restored net equal to the averaged
    params it left)."""
    from deeplearning4j_tpu_torch.parallel.cluster import restore_zip_into

    A, c = AVERAGING, TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    half = c["batch"] // 2
    shards = [DataSet(ds.features[r], ds.labels[r])
              for r in (slice(0, half), slice(half, c["batch"]))]
    nets = [flagship(transformer_lm, max_length=c["seq"]).init(SEED)
            for _ in shards]
    restored_same = None
    for step in range(1, A["rounds"] + 1):
        if step == A["crash_after"] + 1:
            fresh = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
            restore_zip_into(fresh, str(ck_round))
            restored_same = _same_trees(torch, fresh.canonical_params(),
                                        nets[1].canonical_params())[0]
            nets[1] = fresh
        for net, shard in zip(nets, shards):
            net.fit(shard)
        flats = {f"w{i}": net.params_flat() for i, net in enumerate(nets)}
        avg = np.mean([flats[w] for w in contributors[step]], axis=0)
        for net in nets:
            net.set_params_flat(avg.copy())  # each its own, as a worker's
    torch.cuda.synchronize()
    return nets[0].canonical_params(), restored_same


def averaging_on_card(torch, counters, transformer_lm, DataSet, card):
    """24b: two run_elastic_worker processes averaging through a
    ClusterCoordinator on the card, one killed and restarted, held
    against an in-process reference that averages in plain numpy; then
    one worker in this process against plain fit. Returns the launches
    of the workers and of the in-process runs."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterCoordinator,
        run_elastic_worker,
    )

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_average_"))
    A = AVERAGING
    coord = ClusterCoordinator(
        heartbeat_timeout=A["heartbeat_timeout"]).start()
    # both workers are in the alive set before either starts (a round
    # completes with whoever is alive, and a worker's start on the card
    # takes some 9 s); the heartbeat bound outlasts that start
    for w in ("w0", "w1"):
        coord.register(w)
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def spawn(worker, shard, crash):
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--average-worker", coord.address, worker, shard,
             str(tmp / f"ck_{worker}.zip"), str(tmp), str(crash)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def wait(p):
        try:
            out, _ = p.communicate(timeout=A["proc_timeout"])
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        return out

    failures = []
    t0 = time.perf_counter()
    try:
        p0, p1 = spawn("w0", "0", 0), spawn("w1", "1", A["crash_after"])
        out1 = wait(p1)
        died_s = time.perf_counter() - t0
        ck = tmp / "ck_w1.zip"
        ck_step = zip_step(ck) if ck.exists() else None
        if p1.returncode != 1 or ck_step != A["crash_after"]:
            failures.append(f"worker 1 exit {p1.returncode}, checkpoint "
                            f"of step {ck_step}: {out1[-2000:]}")
        # the zip the restart resumes from (the worker rewrites it every
        # round), for the reference
        shutil.copy(ck, tmp / "ck_w1_crash.zip")
        p1 = spawn("w1", "1", 0)
        outs = [wait(p0), wait(p1)]
        wall = time.perf_counter() - t0
        # the workers each round averaged over (completed rounds stay
        # cached in the coordinator)
        contributors = {step: sorted(rnd.contributions)
                        for step, rnd in coord._avg_rounds.items()}
    finally:
        coord.shutdown()
    for p, out in zip((p0, p1), outs):
        if p.returncode != 0:
            failures.append(f"a worker exited {p.returncode}: {out[-3000:]}")
    if failures:
        raise PhaseFailed("24b", "; ".join(failures))
    info = {w: json.loads((tmp / f"{w}.json").read_text())
            for w in ("w0", "w1")}
    same, dist = _same_trees(
        torch, torch.load(tmp / "w0_params.pt", map_location="cpu"),
        torch.load(tmp / "w1_params.pt", map_location="cpu"))
    if not same:
        failures.append(f"the workers end {dist:.3e} apart")
    if info["w1"]["resumed_at"] != A["crash_after"] or \
            info["w1"]["iteration"] != A["rounds"]:
        failures.append(f"the restarted worker resumed at "
                        f"{info['w1']['resumed_at']} and ended at "
                        f"{info['w1']['iteration']}")
    # the mean the coordinator computed, against two nets averaged here
    ref, restored_same = averaged_reference(
        torch, transformer_lm, DataSet, tmp / "ck_w1_crash.zip",
        contributors)
    torch.save(ref, tmp / "ref_params.pt")
    ref_same, ref_dist = _same_trees(
        torch, torch.load(tmp / "w0_params.pt", map_location="cpu"),
        torch.load(tmp / "ref_params.pt", map_location="cpu"))
    if sorted(contributors) != list(range(1, A["rounds"] + 1)) or \
            not restored_same or not ref_same:
        failures.append(f"against the in-process reference: rounds' "
                        f"workers {contributors}, restored checkpoint equal "
                        f"to the averaged params {restored_same}, worker 0 "
                        f"{ref_dist:.3e} from the reference")
    # one worker through a coordinator against plain fit, in process
    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    solo_coord = ClusterCoordinator().start()
    try:
        torch.cuda.synchronize()
        counters.reset()
        solo = run_elastic_worker(
            solo_coord.address, "solo",
            flagship(transformer_lm, max_length=c["seq"]).init(SEED),
            [ds] * A["rounds"], sync_every=1)
        plain = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
        for _ in range(A["rounds"]):
            plain.fit(ds)
        torch.cuda.synchronize()
        in_process = counters.read()
    finally:
        solo_coord.shutdown()
    solo_same, solo_dist = _same_trees(torch, solo.params, plain.params)
    if not solo_same:
        failures.append(f"one worker through the coordinator is "
                        f"{solo_dist:.3e} from plain fit")
    rounds = [r for w in ("w0", "w1") for r in info[w]["rounds"]]
    log24(card, f"24b: run_elastic_worker x 2 on one card through "
          f"ClusterCoordinator, {A['rounds']} rounds of {c['batch'] // 2} "
          f"rows each, worker 1 died at its round {A['crash_after'] + 1} "
          f"({died_s:.2f} s in) and rejoined from step "
          f"{info['w1']['resumed_at']}: workers equal bit for bit {same}; "
          f"rounds' workers {contributors}; worker 0 against the in-process "
          f"reference (two nets averaged in numpy, worker 1's restored "
          f"from its checkpoint, equal to the averaged params "
          f"{restored_same}): equal bit for bit {ref_same}, largest "
          f"difference {ref_dist:.3e}; "
          f"rounds [step, seconds, vector bytes] w0 {info['w0']['rounds']}, "
          f"w1 restarted {info['w1']['rounds']} (a round waits for the "
          f"other worker's step; the round worker 1 died in, for its "
          f"restart to rejoin or for the {A['heartbeat_timeout']} s "
          f"heartbeat timeout); median round "
          f"{statistics.median(r[1] for r in rounds):.4f} s; wall "
          f"{wall:.2f} s; one worker through a coordinator equals plain "
          f"fit bit for bit {solo_same}; launches w0 "
          f"{info['w0']['launches']}, w1 restarted "
          f"{info['w1']['launches']}, in process {in_process}")
    if failures:
        raise PhaseFailed("24b", "; ".join(failures))
    return {k: info["w0"]["launches"].get(k, 0)
            + info["w1"]["launches"].get(k, 0) + in_process.get(k, 0)
            for k in in_process}


def engine_shards(torch, counters, fns, card):
    """24c: bench mode `embed`'s train half through the engine at ep = 1,
    ep = 2 and 4 in one process and dp = 2 in one process; an /embed
    round trip over the ep = 2 engine; K13 at the arms' shape against
    its plain version and timed. Returns the launches and K13's
    record."""
    import urllib.request

    from deeplearning4j_tpu_torch.embedding.engine import (
        EngineLookupView,
        ShardedEmbeddingEngine,
    )
    from deeplearning4j_tpu_torch.embedding.serving import (
        EmbeddingServingEngine,
    )
    from deeplearning4j_tpu_torch.serving.server import ServingServer

    E = EMBED
    steps = E["train_steps"]
    feed = engine_feed(E, steps, E["seed"] + 200)
    try:
        batches = [next(feed) for _ in range(steps)]
    finally:
        feed.close()

    def arm(ep, dp):
        eng = ShardedEmbeddingEngine(E["vocab"], E["dim"], ep=ep, dp=dp,
                                     negative=E["negative"], seed=3,
                                     device="cuda", in_process=True)
        torch.cuda.synchronize()
        counters.reset()
        eng.sgns_step(*batches[0], E["lr"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            eng.sgns_step(*b, E["lr"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, counters.read(), (steps - 1) * E["batch"] / wall

    arms = {a: arm(*a) for a in ENGINE_ARMS}
    again = arm(1, 1)[0]
    ref = arms[(1, 1)][0]
    full = ref.table_bytes_per_device()

    def table_err(eng):
        return max(errs(getattr(eng, n)[:E["vocab"]],
                        getattr(ref, n)[:E["vocab"]])[1]
                   for n in ("syn0", "syn1neg"))

    failures = []
    launches = {}
    report = []
    for (ep, dp), (eng, got, rate) in arms.items():
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        err = table_err(eng)
        share = eng.table_bytes_per_device() / full
        report.append(f"ep {ep} dp {dp}: {rate:.1f} pairs/s, table bytes "
                      f"{eng.table_bytes_per_device()} ({share:.2f} of ep "
                      f"1), K13 {got['K13']}, tables {err:.3e} from ep 1")
        if got["K13"] != steps or any(n for k, n in got.items()
                                      if k != "K13"):
            failures.append(f"ep {ep} dp {dp} launches {got}")
        if share != 1 / ep:
            failures.append(f"ep {ep} holds {share} of the table bytes")
        if (ep, dp) != (1, 1) and not err <= ENGINE_SHARD_TOL:
            failures.append(f"ep {ep} dp {dp} tables {err:.3e} from ep 1")
    floor = table_err(again)
    eng2 = arms[(2, 1)][0]
    serve = EmbeddingServingEngine(EngineLookupView(eng2),
                                   recall_floor=0.5, calibration_queries=16)
    serve.start()
    server = ServingServer(serve).start()
    ids = np.random.default_rng(5).choice(E["vocab"], 16, replace=False)
    try:
        r = urllib.request.Request(
            f"{server.url}/embed",
            data=json.dumps({"ids": ids.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=60) as resp:
            got_rows = np.float32(json.loads(resp.read())["vectors"])
    finally:
        server.stop()
    want_rows = eng2.syn0[torch.as_tensor(ids, device="cuda")].cpu().numpy()
    exact = bool(np.array_equal(got_rows, want_rows))
    if not exact:
        failures.append("/embed over ep 2 did not return its rows exactly")
    gathers = [e for e in serve.recorder.events if e.get("name") == "gather"]
    rec = k13_embed_shape(torch, fns)
    log24(card, f"24c: engine at bench mode embed ({E['vocab']} x "
          f"{E['dim']}, batch {E['batch']}, negative {E['negative']}, "
          f"{steps} steps, f32): " + "; ".join(report)
          + f"; two ep 1 runs {floor:.3e} apart (gate "
          f"{ENGINE_SHARD_TOL} of the largest entry); /embed over ep 2 "
          f"exact {exact}, gather spans ep "
          f"{sorted({e.get('ep') for e in gathers})}")
    if failures:
        raise PhaseFailed("24c", "; ".join(failures))
    return launches, rec


def k13_embed_shape(torch, fns):
    """K13 at the engine's shape of bench mode `embed` (B = 1024, K = 5,
    D = 64, f32) against its plain version, then timed."""
    B, K, D = EMBED["batch"], EMBED["negative"], EMBED["dim"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 240)
    c, pos = ((0.3 * torch.randn(B, D, generator=gen)).cuda()
              for _ in range(2))
    neg = (0.3 * torch.randn(B, K, D, generator=gen)).cuda()
    got = fns.neg_softmax_scores(c, pos, neg)
    ref = fns._neg_softmax_reference(c, pos, neg)
    torch.cuda.synchronize()
    abs_err, err = (max(e) for e in zip(*(errs(g, r)
                                           for g, r in zip(got, ref))))
    if not err <= K13_TOL["float32"]:
        raise PhaseFailed("24c", f"K13 at B={B} K={K} D={D} is {err:.3e} "
                                 "from its plain version")
    run = lambda: fns.neg_softmax_scores(c, pos, neg)  # noqa: E731
    ms = time_ms(torch, run)
    dev_ms = kernel_device_ms(torch, run)
    plain_ms = time_ms(torch, lambda: fns._neg_softmax_reference(c, pos, neg))
    lib_ms = time_ms(torch, lambda: torch.sigmoid(torch.bmm(
        torch.cat([pos[:, None], neg], 1), c[..., None])))
    bound_ms, bound_by = bound((2 * B * D + B * K * D + B * (K + 1)) * 4,
                               2 * (K + 1) * B * D, "float32")
    log(f"time  K13 neg_softmax embed B={B} K={K} D={D} f32: max rel err "
        f"{err:.3e} (tol {K13_TOL['float32']}); kernel {ms:.4f} ms (device "
        f"time {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sigmoid(bmm) "
        f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    return dict(label=f"embed B={B} K={K} D={D}", max_abs_err=abs_err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def data_meshes(torch, counters, card):
    """24d: 20a's device pipeline and 20e's GloVe (one epoch) with
    "data" = 2 shards in one process against their meshless runs; the
    pipeline's quality on the sub-corpus against phase 20a's host path.
    Returns the launches (none: neither runs a kernel)."""
    from deeplearning4j_tpu_torch.nlp import glove as gl
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000, 25)
    n_words = sum(len(s) for s in sents)
    torch.cuda.synchronize()
    counters.reset()

    def pipeline(mesh):
        b = (Word2Vec.builder().layer_size(128).window_size(5)
             .min_word_frequency(1).negative_sample(5)
             .use_device_pipeline(True).epochs(1).seed(1).device("cuda"))
        if mesh is not None:
            b = b.device_mesh(mesh, chunk=W2V_PIPELINE["chunk"],
                              group=W2V_PIPELINE["group"])
        m = b.build()
        m.pipeline_chunk = W2V_PIPELINE["chunk"]
        m.pipeline_group = W2V_PIPELINE["group"]
        m.build_vocab(sents)
        m.fit(sents)
        torch.cuda.synchronize()
        tables = [m.lookup_table.syn0.clone(), m.lookup_table.syn1neg.clone()]
        losses = list(m.loss_history)
        t0 = time.perf_counter()
        m.fit(sents)                     # timed: repack + the epoch
        m.word_vector("w0")
        torch.cuda.synchronize()
        return tables, losses, n_words / (time.perf_counter() - t0)

    (t_a, l_a, r_a), (t_b, l_b, r_b) = pipeline(None), pipeline(
        InProcessShards(2))
    pipe_err = max(errs(b, a)[1] for a, b in zip(t_a, t_b))
    loss_err = float(np.max(np.abs(np.subtract(l_b, l_a))
                            / np.maximum(np.abs(l_a), 1e-12)))
    sub = sents[:W2V_SENTENCES]
    q = (Word2Vec.builder().layer_size(128).window_size(5)
         .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
         .device_mesh(InProcessShards(2)).device("cuda").build())
    q.build_vocab(sub)
    q.fit(sub)
    sep = topic_separation(q)
    host = PHASE20.get("host_separation")

    def glove(mesh):
        g = gl.Glove(device="cuda", device_mesh=mesh,
                     **dict(GLOVE, epochs=1))
        g.build_vocab(sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.fit(sub)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0 - g.cooccurrence_seconds
        return g, len(g.loss_history) * GLOVE["batch_size"] / train_s

    (g_a, tr_a), (g_b, tr_b) = glove(None), glove(InProcessShards(2))
    glove_err = max(errs(g_b.state[n], g_a.state[n])[1]
                    for n in gl.GLOVE_STATE)
    glove_loss = float(np.max(np.abs(np.subtract(g_b.loss_history,
                                                  g_a.loss_history))
                              / np.maximum(np.abs(g_a.loss_history),
                                           1e-12)))
    torch.cuda.synchronize()
    launches = counters.read()
    log24(card, f"24d: device pipeline (chunk {W2V_PIPELINE['chunk']} x "
          f"group {W2V_PIPELINE['group']}, {n_words} words) with data = 2 "
          f"in one process: tables {pipe_err:.3e} of the largest entry "
          f"from the meshless run's, losses {loss_err:.3e} relative (gate "
          f"{MESH_TOL}); {r_b:.1f} words/s against the meshless "
          f"{r_a:.1f} (phase 20a {PHASE20.get('pipeline_words_s')}); "
          f"sub-corpus separation with data = 2 {sep:.4f} against the host "
          f"path's {host} (gate >= {W2V_QUALITY_RATIO}x); GloVe one epoch "
          f"with data = 2: state {glove_err:.3e} of the largest entry, "
          f"losses {glove_loss:.3e} relative; {tr_b:.1f} triples/s "
          f"against the meshless {tr_a:.1f} (phase 20e "
          f"{PHASE20.get('glove_triples_s')}); launches {launches}")
    failures = []
    if not (pipe_err <= MESH_TOL and loss_err <= MESH_TOL):
        failures.append("the pipeline with data = 2 left the meshless run")
    if not (glove_err <= MESH_TOL and glove_loss <= MESH_TOL):
        failures.append("GloVe with data = 2 left the meshless run")
    if host is None or not sep >= W2V_QUALITY_RATIO * host:
        failures.append(f"separation {sep} against the host path's {host}")
    if any(launches.values()):
        failures.append(f"launches {launches}, expected none")
    if failures:
        raise PhaseFailed("24d", "; ".join(failures))
    return launches


def build_worker(build_dir):
    """`--build-worker DIR`: builds csrc/neg_softmax.cu into DIR (a
    fresh cache) and prints what this process compiled, then loads it."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = Path(build_dir)
    built = sorted(cuda_build.build(["neg_softmax"]))
    cuda_build.load("neg_softmax")
    print(json.dumps({"built": built}), flush=True)
    return 0


def build_lock_on_card(card):
    """24b's build check: two processes that start together on an empty
    kernel cache build it once (`cuda_build`'s file lock): one compiles,
    the other waits and loads the library the first built."""
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_build_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--build-worker", d],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    built = sorted(json.loads(o.strip().splitlines()[-1])["built"]
                   if p.returncode == 0 else None
                   for p, o in zip(procs, outs))
    log24(card, f"24b: two processes on an empty kernel cache built "
          f"{built} in {time.perf_counter() - t0:.2f} s")
    if built != [[], ["neg_softmax"]]:
        raise PhaseFailed("24b", f"the build lock let {built} build: "
                                 f"{[o[-1500:] for o in outs]}")


def train_fleet(torch, counters, fns, transformer_lm, DataSet, card):
    """Phase 24: the elastic fleet (24a), parameter averaging through
    the cluster coordinator (24b), the sharded embedding engine (24c)
    and the data meshes of NLP (24d). Returns the launches of its runs
    and K13's record at the engine's shape."""
    t0 = time.perf_counter()
    runs = [elastic_on_card(torch, card),
            averaging_on_card(torch, counters, transformer_lm, DataSet,
                              card)]
    build_lock_on_card(card)
    engine_launches, k13 = engine_shards(torch, counters, fns, card)
    runs += [engine_launches, data_meshes(torch, counters, card)]
    keys = sorted({k for r in runs for k in r})
    launches = {k: sum(r.get(k, 0) for r in runs) for k in keys}
    log24(card, f"phase 24 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches, k13


# ------------------------------------------------------------------ phase 25
# the cost and memory telemetry, ModelSerializer zips and the CLI: a
# 3-class CSV through `cli train`, `test` and `predict` (25a), the
# flagship LM's zip behind `cli serve` (25b), the cost book's counts of
# the flagship's forward and training step (25c)

CLI_CSV = dict(rows=4096, features=64, classes=3, hidden=128, epochs=3,
               batch=128)
# `cli serve`'s lattice: one 512-token prompt bucket, whose prefill runs
# the flat flash forward (K1: T >= 512); SERVE_PROMPTS greedy requests of
# SERVE_LEN tokens, SERVE_NEW new tokens each
SERVE = dict(buckets="1x512", slots=4, new=16, prompts=3, prompt_len=300)
CLI_TIMEOUT_S = 300


# what later phases read of phase 25: its CLI telemetry path
PHASE25 = {}


def log25(card, msg):
    """A phase-25 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def cli_env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT), **extra)


def run_cli(phase, env, *commands):
    """`python -m deeplearning4j_tpu_torch.cli ...` once for each of
    `commands`, all started together, on the card (the CLI's default
    device); their stdouts, or the phase fails."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *args],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for args in commands]
    outs = []
    for args, p in zip(commands, procs):
        try:
            out, err = p.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise PhaseFailed(phase, f"cli {args[0]} exited {p.returncode}: "
                                     f"{out[-1500:]} {err[-3000:]}")
        outs.append(out)
    return outs


def read_events(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]


def lm_counted_flops(c, B, T, train):
    """The cost book's count of the LM at batch B x T (telemetry/
    costbook.py: 2mnk a torch product, forward and backward, plus the
    kernels' analytic counts, ops/opcount.py): the QKV, output and two FF
    products of each block (their dx and dW in the backward), the packed
    flash forward 4·B·H·P·Dh over P = T(T+1)/2 causal pairs and its
    backward 10·B·H·P·Dh, and the head: a [N, d] x [d, V] product in
    inference, K8's 2·N·d·V and K9's 6·N·d·V in training."""
    N, d, F, V = B * T, c["d_model"], c["d_ff"], c["vocab_size"]
    H, L = c["n_heads"], c["n_layers"]
    P, Dh = T * (T + 1) // 2, d // H
    mm = L * (2 * N * d * 3 * d + 2 * N * d * d + 2 * 2 * N * d * F)
    attn = L * 4 * B * H * P * Dh
    if not train:
        return mm + attn + 2 * N * d * V
    return 3 * mm + attn + L * 10 * B * H * P * Dh + 8 * N * d * V


def cli_train_test_predict(torch, card):
    """25a: a synthetic 3-class CSV through `cli train` (telemetry on,
    memory at every step), `cli test` and `cli predict`, each a process
    on the card; the memory events carry the card's stats, a cost event
    exists, and predict's CSV equals this process's restore of the zip."""
    import tempfile

    from deeplearning4j_tpu_torch.cli.driver import write_predictions
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    c = CLI_CSV
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    x, y = write_cli_csv(tmp)
    PHASE25["csv"] = str(tmp / "train.csv")  # phase 27d reads it
    np.savetxt(tmp / "features.csv", x, delimiter=",", fmt="%.6g")
    conf = (NeuralNetConfiguration.builder().seed(SEED).learning_rate(0.01)
            .updater("adam").list()
            .layer(0, DenseLayer(n_in=c["features"], n_out=c["hidden"],
                                 activation="relu"))
            .layer(1, OutputLayer(n_in=c["hidden"], n_out=c["classes"],
                                  activation="softmax",
                                  loss_function="mcxent")).build())
    (tmp / "conf.json").write_text(conf.to_json())
    tlog, model = tmp / "telemetry.jsonl", str(tmp / "model.zip")
    PHASE25["telemetry"] = str(tlog)  # phase 26c's /timeline reads it
    env = cli_env(DL4J_TPU_TELEMETRY=str(tlog), DL4J_TPU_MEM_EVERY="1")
    common = ["--num-classes", str(c["classes"]), "--batch", str(c["batch"])]
    t0 = time.perf_counter()
    run_cli("25a", env, ["train", "--conf", str(tmp / "conf.json"),
                         "--input", str(tmp / "train.csv"), "--model",
                         model, "--epochs", str(c["epochs"]), *common])
    t_train = time.perf_counter() - t0
    # test and predict read the zip in processes of their own, together
    report, _ = run_cli(
        "25a", env,
        ["test", "--model", model, "--input", str(tmp / "train.csv"),
         *common],
        ["predict", "--model", model, "--input", str(tmp / "features.csv"),
         "--output", str(tmp / "preds.csv"), "--batch", str(c["batch"])])
    wall = time.perf_counter() - t0
    events = read_events(tlog)
    mem = [e for e in events if e["event"] == "memory"
           and e.get("source") == "fit"]
    devs = [e["devices"].get("0", {}) for e in mem]
    costs = [e for e in events if e["event"] == "cost"]
    evals = [e["stats"] for e in events if e["event"] == "eval"]
    steps = (c["rows"] // c["batch"]) * c["epochs"]
    last = devs[-1] if devs else {}
    log25(card, f"25a: cli train ({steps} steps) in {t_train:.2f} s, train + "
          f"test + predict in {wall:.2f} s; {len(mem)} fit memory events, "
          f"the last: bytes_in_use {last.get('bytes_in_use')}, "
          f"peak_bytes_in_use {last.get('peak_bytes_in_use')}, bytes_limit "
          f"{last.get('bytes_limit')}, ledger {mem[-1]['ledger'] if mem else None}; "
          f"cost events {[(e['entry'], e['shape'], e['flops']) for e in costs]}; "
          f"eval {evals}")
    if len(mem) != steps or not all(
            0 < d.get("bytes_in_use", 0) <= d.get("peak_bytes_in_use", 0)
            < d.get("bytes_limit", 0) for d in devs):
        raise PhaseFailed("25a", f"{len(mem)} fit memory events for {steps} "
                                 f"steps, devices {devs[:3]}")
    if not costs or not all(e["flops"] > 0 for e in costs):
        raise PhaseFailed("25a", f"no cost event with flops: {costs}")
    if not evals or evals[-1].get("accuracy", 0) < 0.9:
        raise PhaseFailed("25a", f"cli test: {evals} {report[-800:]}")
    net = ModelSerializer.restore(model, device="cuda")
    feats = np.loadtxt(tmp / "features.csv", delimiter=",",
                       dtype=np.float64).astype(np.float32)
    rows = [net.output(feats[s:s + c["batch"]]).float().cpu().numpy()
            for s in range(0, len(feats), c["batch"])]
    write_predictions(str(tmp / "mine.csv"), np.concatenate(rows))
    theirs = (tmp / "preds.csv").read_text()
    mine = (tmp / "mine.csv").read_text()
    log25(card, f"25a: cli predict's {len(theirs.splitlines())} rows "
          f"{'equal' if theirs == mine else 'DIFFER from'} this process's "
          "restore of the zip on the card")
    if theirs != mine:
        raise PhaseFailed("25a", "cli predict's CSV differs from "
                                 "ModelSerializer.restore(zip).output")


def _read_lines(proc, lines):
    for line in proc.stdout:
        lines.put(line)
    lines.put(None)


def _http(url, payload=None, timeout=120):
    import urllib.request

    if payload is None:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def cli_serve_flagship(torch, counters, transformer_lm, GenerationEngine,
                       BucketLattice, Recorder, card):
    """25b: the flagship LM (bf16) written as a zip and served by `cli
    serve --generate-slots` in a process of its own; greedy /generate
    requests equal this process's GenerationEngine on the same zip; the
    server's /metrics MFU and memory gauges and its /stats peak and
    launches. Returns the launches of both processes' runs."""
    import queue
    import signal
    import tempfile
    import threading

    from deeplearning4j_tpu_torch.distributed.bootstrap import free_port
    from deeplearning4j_tpu_torch.telemetry.costbook import PEAK_BF16_FLOPS
    from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    s = SERVE
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    model = str(tmp / "flagship.zip")
    net = transformer_lm(**LM, dtype="bfloat16", device="cuda").init(SEED)
    ModelSerializer.write_model(net, model)
    del net
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, LM["vocab_size"],
                           (s["prompts"], s["prompt_len"])).tolist()
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "--model", model, "--buckets", s["buckets"], "--generate-slots",
         str(s["slots"]), "--max-new-tokens", str(s["new"]), "--port",
         str(port)],
        cwd=str(ROOT), env=cli_env(DL4J_TPU_TELEMETRY=str(tmp / "t.jsonl")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc, lines),
                     daemon=True).start()
    out, served = [], []
    t0 = time.perf_counter()
    try:
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while True:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            if line is None:
                raise PhaseFailed("25b", f"cli serve exited "
                                         f"{proc.wait()}: {''.join(out)[-3000:]}")
            out.append(line)
            if "serving on" in line:
                break
        t_up = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        for p in prompts:
            body = _http(f"{url}/generate",
                         {"tokens": p, "max_new_tokens": s["new"]})
            done = json.loads(body.strip().splitlines()[-1])
            if not done.get("done") or done.get("error"):
                raise PhaseFailed("25b", f"/generate: {body[-1000:]}")
            served.append(done["tokens"])
        metrics = parse_exposition(_http(f"{url}/metrics"))
        stats = json.loads(_http(f"{url}/stats"))
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    mfu = metrics.get("serving_mfu_live")
    live = metrics.get("serving_hbm_live_bytes")
    sub = stats.get("kernel_launches", {})
    log25(card, f"25b: cli serve up in {t_up:.2f} s; {len(served)} greedy "
          f"requests; serving_mfu_live {mfu}, serving_hbm_live_bytes {live}, "
          f"headroom {metrics.get('serving_hbm_headroom_ratio{device=\"0\"}')}, "
          f"ledger params "
          f"{metrics.get('serving_memory_ledger_bytes{subsystem=\"params\"}')} "
          f"kv_pages "
          f"{metrics.get('serving_memory_ledger_bytes{subsystem=\"kv_pages\"}')}; "
          f"/stats peak_flops {stats.get('peak_flops')}; the server's "
          f"launches {sub}")
    if not (mfu is not None and 0.0 < mfu <= 1.0 and live and live > 0):
        raise PhaseFailed("25b", f"/metrics MFU {mfu}, live bytes {live}")
    if stats.get("peak_flops") != PEAK_BF16_FLOPS["H100"]:
        raise PhaseFailed("25b", f"/stats peak_flops {stats.get('peak_flops')}")
    if not sub.get("K1", 0) > 0:
        raise PhaseFailed("25b", f"the server launched no K1: {sub}")
    counters.reset()
    engine = GenerationEngine(
        ModelSerializer.restore(model, device="cuda"),
        BucketLattice.from_spec(s["buckets"]), slots=s["slots"],
        max_new_tokens=s["new"], recorder=Recorder(path=None))
    engine.warmup()
    engine.start()
    try:
        mine = [engine.generate(p, s["new"]) for p in prompts]
    finally:
        engine.drain()
    here = counters.read()
    log25(card, f"25b: greedy tokens {'equal' if mine == served else 'DIFFER'}"
          f" between cli serve and this process's GenerationEngine on the "
          f"zip; this process's launches {here}")
    if mine != served:
        raise PhaseFailed("25b", f"served {served} != in-process {mine}")
    return {k: here.get(k, 0) + sub.get(k, 0) for k in here}


def costbook_flagship(torch, counters, transformer_lm, DataSet,
                      InferenceEngine, BucketLattice, Recorder, card):
    """25c: the cost book's flops of the flagship's forward (one [1, 512]
    bucket of InferenceEngine's warmup) and of its training step (32 x
    512) against `lm_counted_flops`; the step's and the forward's MFU,
    the book's peak temporary bytes against max_memory_allocated; a
    `cost_drift` event from `reconcile`. Returns the launches."""
    from deeplearning4j_tpu_torch.telemetry.costbook import (
        CostBook,
        device_kind,
        measured_peak_bytes,
        peak_flops,
        reconcile,
    )

    c = TRAIN
    rec = Recorder(path=None)
    counters.reset()
    net = transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                         n_heads=c["n_heads"], n_layers=c["n_layers"],
                         d_ff=c["d_ff"], max_length=c["seq"],
                         dtype="bfloat16", device="cuda").init(SEED)
    peak = peak_flops(device_kind(net.device))
    engine = InferenceEngine(net, BucketLattice((1,), seq_lens=(c["seq"],)),
                             sequence=True, recorder=rec)
    engine.warmup(np.zeros(c["seq"], np.int32))
    fwd = engine.costbook.entries()[("forward", (1, c["seq"]))]
    want_fwd = lm_counted_flops(c, 1, c["seq"], train=False)
    infer = net.inference_fn()
    ws = engine.weights.current
    toks = torch.zeros((1, c["seq"]), dtype=torch.int64, device="cuda")
    mask = torch.ones((1, c["seq"]), device="cuda")
    fwd_ms = time_ms(torch, lambda: infer(ws.params, ws.state, toks, mask),
                     windows=5, per_window=5)
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    net.fit(ds)  # first call: the train step's buffers
    book = CostBook(rec)
    torch.cuda.synchronize()
    step = book.record("fit", [c["batch"], c["seq"]], net.fit, (ds,),
                       device=net.device)
    want_step = lm_counted_flops(c, c["batch"], c["seq"], train=True)
    max_alloc = torch.cuda.max_memory_allocated()

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    step_s = statistics.median(one_step() for _ in range(5))
    measured = measured_peak_bytes()
    drift = reconcile(rec, step["peak_temp_bytes"], source="chip_smoke")
    launches = counters.read()
    log25(card, f"25c: forward [1, {c['seq']}] counted {fwd['flops']} flops "
          f"(torch {fwd['torch_flops']}, kernels {fwd['kernel_flops']}) "
          f"against {want_fwd}; {fwd_ms:.4f} ms -> MFU "
          f"{CostBook.mfu(fwd['flops'], fwd_ms * 1e-3, peak):.5f}")
    log25(card, f"25c: train step [{c['batch']}, {c['seq']}] counted "
          f"{step['flops']} flops (torch {step['torch_flops']}, kernels "
          f"{step['kernel_flops']}) against {want_step}; step "
          f"{step_s * 1e3:.3f} ms (host clock to synchronize, median of 5 "
          f"fit() calls) -> MFU {CostBook.mfu(step['flops'], step_s, peak):.5f} "
          f"against {peak / 1e12:.0f} TFLOP/s; peak_temp_bytes "
          f"{step['peak_temp_bytes']} (the book's {book.peak_temp_bytes()}) "
          f"against max_memory_allocated {max_alloc}; cost_drift {drift}; "
          f"launches {launches}")
    if fwd["flops"] != want_fwd or step["flops"] != want_step:
        raise PhaseFailed("25c", f"counted {fwd['flops']} / {step['flops']},"
                                 f" analytic {want_fwd} / {want_step}")
    if not 0 < step["peak_temp_bytes"] <= max_alloc:
        raise PhaseFailed("25c", f"peak_temp_bytes {step['peak_temp_bytes']}"
                                 f" against max_memory_allocated {max_alloc}")
    if (drift.get("event") != "cost_drift"
            or drift["measured_bytes"] != measured
            or abs(drift["ratio"] - measured / step["peak_temp_bytes"])
            > 1e-6):
        raise PhaseFailed("25c", f"reconcile gave {drift}")
    return launches


def telemetry_and_cli(torch, counters, transformer_lm, DataSet, card):
    """Phase 25. Returns the launches of its runs."""
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine,
                                                  InferenceEngine)
    from deeplearning4j_tpu_torch.telemetry import Recorder

    t0 = time.perf_counter()
    cli_train_test_predict(torch, card)
    runs = [cli_serve_flagship(torch, counters, transformer_lm,
                               GenerationEngine, BucketLattice, Recorder,
                               card),
            costbook_flagship(torch, counters, transformer_lm, DataSet,
                              InferenceEngine, BucketLattice, Recorder,
                              card)]
    keys = sorted({k for r in runs for k in r})
    launches = {k: sum(r.get(k, 0) for r in runs) for k in keys}
    log25(card, f"phase 25 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches


# ------------------------------------------------------------ phase 26

# 26a: repeats of each timing window of the tuned-against-default turns
TUNE_REPEATS = 3
# 26b: the share of the vocabulary that may sit in another cluster on the
# card than in the CPU run from the same initial centers (index_add_ sums
# with atomics on the card, so a word at a near-tie may change cluster),
# and the relative rise of the distortion a Lloyd step may show (f32
# rounding of a converged step; the distortion never rises in exact math)
KMEANS = dict(k=10, max_iterations=100)
KMEANS_MEMBERSHIP_TOL = 0.01
KMEANS_RISE_TOL = 1e-6
# exact t-SNE's learning rate at about N / 10 (the default 500 is for
# larger N; at small N the gains scheme can overshoot into overflow, in
# both packages alike)
TSNE = dict(n=2000, max_iter=1000, perplexity=30.0, learning_rate=200.0)
BH_TSNE = dict(n=300, max_iter=100, perplexity=30.0)
VP_QUERIES, VP_K = 20, 10
# 26c: flagship training steps with the UI listeners, probe rows, and
# the nearest-neighbour queries
UI = dict(steps=3, probe_rows=2, queries=5, k=10)
SVG_RENDERER = "http://www.w3.org/2000/svg"


def log26(card, msg):
    """A phase-26 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def kerneltune_module():
    """port_tools/kerneltune.py as a module (its configs, `Case`,
    `measure` and `default_params`)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kerneltune", ROOT / "port_tools" / "kerneltune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quick_sweep(card):
    """26a: `kerneltune.py --quick` as a process on the card. Its table
    must be valid and agree with its telemetry (`kerneltune.audit`):
    each entry's params the default's or a candidate's that passed its
    plain-version check (never a rejected one), each entry's candidate
    count that of its `candidate` events, exactly one `chosen` event an
    entry (with the config's wall seconds) and no unregistered span
    name. Returns the telemetry path."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_kerneltune_"))
    out, tel = tmp / "quick.json", tmp / "quick.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "port_tools" / "kerneltune.py"),
         "--quick", "--out", str(out), "--telemetry", str(tel)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"26a: kerneltune --quick: {line}")
    if proc.returncode:
        raise PhaseFailed("26a", f"kerneltune --quick exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
    table = json.loads(out.read_text())
    events = read_events(tel)
    tunes = [e for e in events if e["event"] == "kernel_tune"]
    chosen = {e["key"]: e for e in tunes if e["role"] == "chosen"}
    bad = kerneltune_module().audit(table, events)
    if bad:
        raise PhaseFailed("26a", f"the quick sweep's table or telemetry: "
                                 f"{bad}")
    n_rej = sum(e["role"] == "rejected" for e in tunes)
    log26(card, f"26a: kerneltune --quick in {wall:.1f} s: "
          f"{len(table['entries'])} valid entries, {len(tunes)} "
          f"kernel_tune events ({n_rej} candidates rejected by their "
          f"plain-version check, none chosen), one chosen event an entry; "
          f"chosen "
          + "; ".join(f"{k} {e['best_us']} us (default {e['default_us']}; "
                      f"{chosen[k]['wall_seconds']} s swept)"
                      for k, e in sorted(table["entries"].items())))
    return str(tel)


def _parent_launch_params(fsx, fa, cfg):
    """The launch params of the parent commit, before the table existed:
    K9's slices from the C heuristic, K11's min(264, N / 8) blocks, K12's
    plan rule, the chunk tile from `pick_chunk`."""
    fam = cfg["family"]
    if fam == "softmax_xent":
        return [{"slices": fsx._kernel("xent_dw_slices")(N, cfg["d"],
                                                         cfg["V"])}
                for N in cfg["rows"]]
    if fam == "fused_layer_norm":
        return [{"blocks": min(264, -(-cfg["N"] // 8))}]
    if fam == "sample":
        B, V = cfg["B"], cfg["V"]
        cluster = min(8, max(1, -(-V // (128 * 8))))
        wide = cluster == 8 and B * cluster <= 132
        return [{"threads": 256 if wide else 128, "cluster": cluster}]
    return [{"chunk": fa.pick_chunk(cfg["T"], cfg["causal"],
                                    head_dim=cfg["D"])}]


def _resolved(fsx, fln, fsm, fa, cfg):
    """What the dispatch launches for `cfg` now (the table, where one
    applies, else the heuristic)."""
    fam = cfg["family"]
    if fam == "softmax_xent":
        return [{"slices": fsx.dw_slices(N, cfg["d"], cfg["V"])}
                for N in cfg["rows"]]
    if fam == "fused_layer_norm":
        return [{"blocks": fln.bwd_blocks(cfg["N"], cfg["C"])}]
    if fam == "sample":
        t, c = fsm._plan(cfg["B"], cfg["V"])
        return [{"threads": t, "cluster": c}]
    return [{"chunk": fa.resolve_chunk(cfg["T"], cfg["D"], cfg["causal"],
                                       cfg["dropout"], cfg["masked"])}]


# the kernels each tuned family launches, for the kernels line
TUNED_KERNELS = {"softmax_xent": ("K9",), "fused_layer_norm": ("K11",),
                 "sample": ("K12",), "flash_chunk": ("K1", "K5")}


def tuned_launches(torch, card):
    """26a: the checked-in table's params at the main path's shapes,
    each checked against its plain version and timed against the
    heuristic's in turns; with the table off, the parent's params.
    Returns {kernel: [{key, shape, params, us, heuristic_params,
    heuristic_us}]} for the kernels line."""
    from deeplearning4j_tpu_torch.ops import autotune
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    kt = kerneltune_module()
    table = autotune.reload_table(autotune.TABLE_PATH)
    prov = table["provenance"]
    log26(card, f"26a: the checked-in table: {len(table['entries'])} "
          f"entries from {prov.get('tool')} on {prov.get('nvidia_smi')} "
          f"({prov.get('date')}); it applies on this card: "
          f"{autotune.table_active()}")
    prev = os.environ.get(autotune.ENV_TUNING)
    tuned = {}
    for cfg in kt.sweep_configs(False):
        key = kt.config_key(cfg)
        tab = _resolved(fsx, fln, fsm, fa, cfg)
        os.environ[autotune.ENV_TUNING] = "off"
        try:
            off = _resolved(fsx, fln, fsm, fa, cfg)
            dflt = kt.default_params(cfg)
        finally:
            if prev is None:
                os.environ.pop(autotune.ENV_TUNING)
            else:
                os.environ[autotune.ENV_TUNING] = prev
        parent = _parent_launch_params(fsx, fa, cfg)
        if not off == dflt == parent:
            raise PhaseFailed("26a", f"{key}: with DL4J_TPU_TUNING=off the "
                                     f"dispatch resolves {off}, the "
                                     f"heuristic {dflt}, the parent "
                                     f"launched {parent}")
        case = kt.Case(torch, cfg)
        times = {"table": [], "default": []}
        notes = []
        for arm in ("table", "default", "default", "table"):
            ok, t, notes = kt.measure(torch, case,
                                      None if arm == "table" else dflt,
                                      TUNE_REPEATS)
            if not ok:
                raise PhaseFailed("26a", f"{key} ({arm} params): {notes}")
            times[arm].append(t)
        for i, row in enumerate(case.rows):
            tt = min(t[i] for t in times["table"])
            td = min(t[i] for t in times["default"])
            log26(card, f"26a: tuned launch {key} {row['label']}: table "
                  f"{tab[i]} {tt:.3f} us, heuristic {dflt[i]} {td:.3f} us "
                  f"(table/heuristic {tt / td:.4f}; CUDA events, L2 warm, "
                  f"least of {TUNE_REPEATS} windows, best of 2 turns); "
                  f"with DL4J_TPU_TUNING=off {off[i]} = the parent's; "
                  f"against the plain version: {notes[i]}")
            for kern in TUNED_KERNELS[cfg["family"]]:
                tuned.setdefault(kern, []).append(dict(
                    key=key, shape=row["label"], params=tab[i], us=tt,
                    heuristic_params=dflt[i], heuristic_us=td))
        del case
        torch.cuda.empty_cache()
    return tuned


def flagship_step_under_table(torch, counters, transformer_lm, DataSet,
                              card, telemetry=None):
    """26a: one training step of the flagship (phase 6's batch) under the
    checked-in table, its launches exact; with `telemetry`, recorded
    there (its `input_wait` span among the events). Returns them."""
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    c = TRAIN
    net = transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                         n_heads=c["n_heads"], n_layers=c["n_layers"],
                         d_ff=c["d_ff"], max_length=c["seq"],
                         dtype="bfloat16", device="cuda").init(SEED)
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    rec = Recorder(telemetry) if telemetry else None
    prev = set_default(rec) if rec else None
    try:
        torch.cuda.synchronize()
        counters.reset()
        net.fit(ds)
        torch.cuda.synchronize()
        launches = counters.read()
    finally:
        if rec:
            set_default(prev)
            rec.close()
    L = c["n_layers"]
    want = {**{f"K{i}": 0 for i in range(1, 14)}, "K2": L, "K6": L,
            "K8": 1, "K9": 1, "K9 dW": 1}
    log26(card, f"26a: a flagship step under the table: loss "
          f"{float(net.score_value):.5f}, launches {launches}")
    if launches != want or not np.isfinite(float(net.score_value)):
        raise PhaseFailed("26a", f"flagship step launches {launches}, "
                                 f"expected {want}")
    return launches


def host_path_vectors(torch, Word2Vec):
    """Phase 20a's host-path Word2Vec model (trained here when phase 20
    did not run in this process): the sub-corpus of bench.py's topic
    corpus, layer 128. Returns (words, vectors [V, 128] f32 on the
    card)."""
    model = PHASE20.get("host_model")
    if model is None:
        sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000, 25)
        model = (Word2Vec.builder().layer_size(128).window_size(5)
                 .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
                 .device("cuda").build())
        model.build_vocab(sents[:W2V_SENTENCES])
        model.fit(sents[:W2V_SENTENCES])
        PHASE20["host_model"] = model
    return (model.vocab.words(),
            model.lookup_table.syn0.detach().float().contiguous())


def barnes_hut_tsne(x):
    """26b's Barnes-Hut t-SNE of x [m, D] (float64, numpy) on the host,
    in a process of its own (the SpTree walks are Python, about a second
    an iteration at m = 300): (y, KL history, seconds)."""
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne

    bh = BarnesHutTsne(max_iter=BH_TSNE["max_iter"],
                       perplexity=BH_TSNE["perplexity"], seed=SEED)
    t0 = time.perf_counter()
    y = bh.fit(x, 2)
    return y, bh.kl_divergences, time.perf_counter() - t0


def start_barnes_hut(torch, Word2Vec):
    """Start 26b's Barnes-Hut t-SNE of the first BH_TSNE["n"] host-path
    vectors in a spawned process, so it runs beside the phases that
    follow: (pool, future). The pool is shut down where the result is
    read (`tuning_clustering_ui`)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    _, vecs = host_path_vectors(torch, Word2Vec)
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(barnes_hut_tsne, vecs[:BH_TSNE["n"]].cpu()
                             .numpy().astype(np.float64))


def check_barnes_hut(job, card):
    """26b: the Barnes-Hut t-SNE process's result."""
    y, kl, seconds = job.result(timeout=900)
    m = BH_TSNE["n"]
    log26(card, f"26b: Barnes-Hut t-SNE of {m} vectors on the host (its "
          f"own process, started after phase 20), {BH_TSNE['max_iter']} "
          f"iterations: {seconds:.3f} s; KL {[round(k, 4) for k in kl]}")
    if y.shape != (m, 2) or not np.isfinite(y).all():
        raise PhaseFailed("26b", "Barnes-Hut t-SNE: not finite")


def clustering_on_card(torch, words, vecs, card):
    """26b: KMeans over the whole vocabulary and exact t-SNE on the card,
    a VP-tree on the host. Returns (words, vectors [n, 128] numpy, t-SNE
    coordinates [n, 2]) of the t-SNE's n words."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, VPTree
    from deeplearning4j_tpu_torch.plot import Tsne

    V, D = vecs.shape
    km = KMeansClustering(KMEANS["k"], KMEANS["max_iterations"], seed=SEED,
                          device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km.apply_to(vecs)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    cpu = KMeansClustering(KMEANS["k"], KMEANS["max_iterations"], seed=SEED,
                           device="cpu")
    t0 = time.perf_counter()
    cpu.apply_to(vecs.cpu())
    cpu_s = time.perf_counter() - t0
    h = km.distortion_history
    rises = [i for i in range(len(h) - 1)
             if h[i + 1] > h[i] * (1 + KMEANS_RISE_TOL)]
    moved = float((km.assignments.cpu() != cpu.assignments).float().mean())
    sizes = torch.bincount(km.assignments, minlength=KMEANS["k"]).tolist()
    log26(card, f"26b: KMeans k={KMEANS['k']} over {V} words x {D} on the "
          f"card: {km.iteration_count} Lloyd steps in {km_s:.3f} s "
          f"({km_s / km.iteration_count * 1e3:.3f} ms a step, the host's "
          f"k-means++ seeding included), distortion {h[0]:.4f} -> "
          f"{h[-1]:.4f}, cluster sizes {sizes}; the CPU run "
          f"{cpu.iteration_count} steps in {cpu_s:.3f} s, distortion "
          f"{cpu.distortion_history[-1]:.4f}; {moved:.5f} of the words in "
          f"another cluster (tol {KMEANS_MEMBERSHIP_TOL})")
    if rises or moved > KMEANS_MEMBERSHIP_TOL:
        raise PhaseFailed("26b", f"KMeans: distortion rises at steps "
                                 f"{rises} or {moved} of the memberships "
                                 "differ from the CPU's")

    n = TSNE["n"]
    x = vecs[:n]
    ts = Tsne(max_iter=TSNE["max_iter"], perplexity=TSNE["perplexity"],
              learning_rate=TSNE["learning_rate"], seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ts.calculate(x, 2)
    tsne_s = time.perf_counter() - t0
    kl = ts.kl_history
    after_lying = ts.stop_lying_iteration // 50  # the first KL after it
    log26(card, f"26b: exact t-SNE of {n} x {D} on the card, "
          f"{TSNE['max_iter']} iterations, perplexity {TSNE['perplexity']}:"
          f" {tsne_s:.3f} s ({tsne_s / TSNE['max_iter'] * 1e3:.4f} ms a "
          f"step, the perplexity search included); KL every 50 iterations "
          f"{[round(k, 4) for k in kl]}")
    if (y.shape != (n, 2) or not np.isfinite(y).all()
            or not kl[-1] < kl[after_lying]):
        raise PhaseFailed("26b", "exact t-SNE: the coordinates are not "
                                 "finite or the KL did not fall")

    xn = x.cpu().numpy().astype(np.float64)
    tree = VPTree(xn, labels=words[:n], seed=SEED)
    rng = np.random.default_rng(SEED)
    wrong = 0
    for q in rng.choice(n, VP_QUERIES, replace=False):
        got = [i for _, i in tree.search(xn[q], VP_K)]
        want = np.argsort(np.linalg.norm(xn - xn[q], axis=1),
                          kind="stable")[:VP_K].tolist()
        wrong += got != want
    log26(card, f"26b: VPTree over {n} vectors: {VP_QUERIES} {VP_K}-NN "
          f"searches, {wrong} differ from brute force")
    if wrong:
        raise PhaseFailed("26b", "a VPTree search differs from brute force")
    return words[:n], x.cpu().numpy(), y


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read().decode()


def ui_on_card(torch, counters, transformer_lm, DataSet, words, vecs, coords,
               telemetry, card):
    """26c: the UI server over 3 flagship training steps with the three
    listeners posting over HTTP, the rendered views, the t-SNE
    coordinates, the nearest neighbours and the fleet timeline. Returns
    the launches of the steps (and the activation probe's forwards)."""
    from deeplearning4j_tpu_torch.nn.tree import leaves
    from deeplearning4j_tpu_torch.ui import (ActivationMeanIterationListener,
                                             FlowIterationListener,
                                             HistogramIterationListener,
                                             UiServer)

    srv = UiServer(port=0, telemetry_path=telemetry).start()
    try:
        c = TRAIN
        net = transformer_lm(vocab_size=c["vocab_size"],
                             d_model=c["d_model"], n_heads=c["n_heads"],
                             n_layers=c["n_layers"], d_ff=c["d_ff"],
                             max_length=c["seq"], dtype="bfloat16",
                             device="cuda").init(SEED)
        ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
        kw = dict(url=srv.url, session_id="flagship")
        net.set_listeners(
            HistogramIterationListener(**kw), FlowIterationListener(**kw),
            ActivationMeanIterationListener(
                np.asarray(ds.features)[:UI["probe_rows"]], **kw))
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        for _ in range(UI["steps"]):
            net.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        S, L = UI["steps"], c["n_layers"]
        log26(card, f"26c: {S} flagship steps with the histogram, flow and "
              f"activation listeners posting to {srv.url} in {wall:.3f} s; "
              f"launches {launches} (the probe's forwards add K2)")
        if (launches["K6"] != S * L or launches["K2"] < S * L
                or any(launches[k] != S for k in ("K8", "K9", "K9 dW"))):
            raise PhaseFailed("26c", f"launches {launches}")
        weights = json.loads(_get(f"{srv.url}/weights/data?sid=flagship")[1])
        flow = json.loads(_get(f"{srv.url}/flow/data?sid=flagship")[1])
        acts = json.loads(_get(f"{srv.url}/activations/data?sid=flagship")[1])
        n_leaves = len(leaves(net.params))
        _http(f"{srv.url}/tsne/coords?sid=flagship",
              {"coords": np.asarray(coords).tolist(),
               "labels": list(words)})
        pages = {}
        for view, marker in (("weights", "ChartHistogram"),
                             ("flow", "ComponentTable"),
                             ("activations", "ChartLine"),
                             ("tsne", "ChartScatter")):
            status, body = _get(f"{srv.url}/{view}?sid=flagship")
            pages[view] = (status, len(body))
            if status != 200 or SVG_RENDERER not in body \
                    or marker not in body:
                raise PhaseFailed("26c", f"/{view} did not render: status "
                                         f"{status}, {marker} or the SVG "
                                         "renderer missing")
        if (weights.get("iteration") is None
                or len(weights["parameters"]) != n_leaves
                or len(flow["layers"]) != len(net.params)
                or not acts.get("activation_means")):
            raise PhaseFailed("26c", "the listeners' payloads are "
                                     "incomplete")
        _http(f"{srv.url}/nearestneighbors/vectors",
              {"labels": list(words), "vectors": np.asarray(vecs).tolist()})
        v = np.asarray(vecs, np.float32)
        vn = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
        wrong = 0
        for i in range(UI["queries"]):
            got = json.loads(_http(f"{srv.url}/nearestneighbors/query",
                                   {"word": words[i], "k": UI["k"]}))
            sims = vn @ vn[i]
            sims[i] = -np.inf
            want = [words[j] for j in np.argsort(-sims)[:UI["k"]]]
            wrong += got["words"] != want
        status, page = _get(f"{srv.url}/timeline")
        timeline = json.loads(_get(f"{srv.url}/timeline/data")[1])
        log26(card, f"26c: views {pages} (status, bytes); weights payload "
              f"of {len(weights['parameters'])} params at iteration "
              f"{weights['iteration']}, flow {len(flow['layers'])} "
              f"vertices, activation means of "
              f"{len(acts['activation_means'])} vertices; "
              f"{len(coords)} t-SNE points posted; {UI['queries']} "
              f"nearest-neighbour queries, {wrong} differ from brute force;"
              f" /timeline ({status}) over {telemetry}: "
              f"{len(timeline['span_stats'])} span kinds, "
              f"{len(timeline['anomalies'])} anomalies")
        if wrong:
            raise PhaseFailed("26c", "a nearest-neighbour query differs "
                                     "from brute force")
        if status != 200 or not timeline["span_stats"]:
            raise PhaseFailed("26c", f"/timeline over {telemetry} lists no "
                                     "span")
        return launches
    finally:
        srv.stop()


def tuning_clustering_ui(torch, counters, Word2Vec, transformer_lm, DataSet,
                         card, barnes_hut=None):
    """Phase 26. Returns the launches of its runs on the main path (the
    flagship step under the table, the UI's steps and, when phase 20 did
    not run first, the host-path Word2Vec) and 26a's tuned launches
    (`tuned_launches`). `barnes_hut`: `start_barnes_hut`'s (pool,
    future), started here when None."""
    t0 = time.perf_counter()
    counters.reset()
    words, vecs = host_path_vectors(torch, Word2Vec)
    torch.cuda.synchronize()
    runs = [counters.read()]
    pool, bh_job = barnes_hut or start_barnes_hut(torch, Word2Vec)
    try:
        quick_tel = quick_sweep(card)
        tuned = tuned_launches(torch, card)
        # run alone, /timeline reads the step's telemetry: the quick
        # sweep's log holds kernel_tune events and no span
        step_tel = (None if "telemetry" in PHASE25 else
                    str(Path(quick_tel).with_name("step.jsonl")))
        runs.append(flagship_step_under_table(torch, counters,
                                              transformer_lm, DataSet,
                                              card, telemetry=step_tel))
        words, vecs, coords = clustering_on_card(torch, words, vecs, card)
        runs.append(ui_on_card(torch, counters, transformer_lm, DataSet,
                               words, vecs, coords,
                               PHASE25.get("telemetry", step_tel), card))
        check_barnes_hut(bh_job, card)
    finally:
        pool.shutdown()
    keys = sorted({k for r in runs for k in r})
    launches = {k: sum(r.get(k, 0) for r in runs) for k in keys}
    log26(card, f"phase 26 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches, tuned


# ------------------------------------------------------------ phase 27

# 27a: phase 6's flagship trained `steps` steps through fit() under a
# ProfilerIterationListener whose window opens at iteration `start` and
# closes `window` iterations later (steps 3-5)
TRACE_FIT = dict(steps=6, start=2, window=3)
# 27b: trafficreplay --generate over 27a's checkpoint (the flagship)
REPLAY27 = dict(requests=6, prompt_lens="8,16,32", output_lens="16",
                slots=4)
# 27c: the tolerance of the port's Adam parity tests
# (tests/test_torch_tensor_parallel.py ADAM_ATOL), in absolute terms
ADAM_ATOL = 2e-4
FIXTURE_DIR = ROOT / "tests" / "fixtures" / "torch_port"
RESUME_STEPS = 3
TOOL_TIMEOUT_S = 300
# the telemetry logs of phases 18c and 24a, which 27a's tools read
TRACES = {}
# runs a port tool's main() over each argv of a JSON list in this one
# process; prints a JSON line a run (exit code, stdout) and then whether
# jax, the JAX package or torch was imported
TOOL_PROBE = """
import contextlib, importlib.util, io, json, sys
spec = importlib.util.spec_from_file_location("tool", sys.argv[1])
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
for argv in json.loads(sys.argv[2]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    print(json.dumps({"argv": argv, "rc": rc, "out": out.getvalue()}))
print(json.dumps({"jax": "jax" in sys.modules,
                  "jax_package": "deeplearning4j_tpu" in sys.modules,
                  "torch": "torch" in sys.modules}))
"""


def log27(card, msg):
    """Phase 27's log line; the card's name and power limit close it."""
    log(f"{msg}; card {card}")


def profiled_flagship(torch, counters, transformer_lm, DataSet, tmp, card):
    """27a: phase 6's flagship, 6 fit() steps under a Recorder's
    TelemetryListener and a ProfilerIterationListener over steps 3-5,
    then saved by the Checkpointer for 27b. Returns (launches, the
    telemetry path, the checkpoint directory, the profiled window's
    seconds)."""
    from deeplearning4j_tpu_torch.telemetry import (
        Recorder,
        TelemetryListener,
    )
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer
    from deeplearning4j_tpu_torch.util.profiler import (
        ProfilerIterationListener,
    )

    c, t = TRAIN, TRACE_FIT
    tel, ckpt = tmp / "fit.jsonl", tmp / "ckpt"
    rec = Recorder(str(tel))
    net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    prof = ProfilerIterationListener(str(tmp / "profile"),
                                     start_iteration=t["start"],
                                     n_iterations=t["window"], recorder=rec)
    listener = TelemetryListener(rec, frequency=1)
    net.set_listeners(listener, prof)
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    for _ in range(t["steps"]):
        net.fit(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    prof.close()  # a no-op: the window closed at iteration 5
    listener.flush()
    Checkpointer(str(ckpt)).save(net, net.iteration_count)
    rec.close()
    S, L = t["steps"], c["n_layers"]
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    spans = [e for e in map(json.loads, tel.read_text().splitlines())
             if e.get("event") == "span" and e.get("name") == "profiler_trace"]
    failures = []
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if len(spans) != 1 or spans[0].get("start_iteration") != t["start"]:
        failures.append(f"profiler_trace spans {spans}")
    names = set()
    if prof.trace_path is None or not os.path.exists(prof.trace_path):
        failures.append(f"no trace file ({prof.trace_path})")
    else:
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        names = {short_name(e.get("name", "")) for e in events
                 if e.get("cat") == "kernel"}
        need = {"flash forward": lambda k: k.startswith("tcf::fwd_tc"),
                "flash backward": lambda k: k.startswith("tcf::")
                and "fwd" not in k,
                "xent forward": lambda k: k.startswith("tcx::xent_fwd"),
                "xent backward": lambda k: k.startswith("tcx::xent_dx")}
        missing = [what for what, ok in need.items()
                   if not any(ok(k) for k in names)]
        if missing:
            failures.append(f"the trace's kernels lack the {missing} "
                            f"kernels: {sorted(names)[:40]}")
    window_s = spans[0]["seconds"] if spans else None
    log27(card, f"27a: the flagship, {S} fit() steps in {wall:.3f} s under "
          f"ProfilerIterationListener(start_iteration={t['start']}, "
          f"n_iterations={t['window']}): window {window_s} s, trace "
          f"{prof.trace_path} with {len(names)} kernel names "
          f"({sorted(k for k in names if k.startswith(('tcf::', 'tcx::')))}"
          f"); launches {launches}")
    if failures:
        raise PhaseFailed("27a", "; ".join(failures))
    return launches, str(tel), str(ckpt), window_s


def run_tool(rel, argvs, env=None):
    """Each argv of `argvs` through port_tools/<rel>'s main() in one
    process of its own (TOOL_PROBE): ([{argv, rc, out}], modules)."""
    proc = subprocess.run(
        [sys.executable, "-c", TOOL_PROBE, str(ROOT / "port_tools" / rel),
         json.dumps(argvs)], capture_output=True, text=True,
        timeout=TOOL_TIMEOUT_S, cwd=str(ROOT),
        env=env or dict(os.environ, PYTHONPATH=str(ROOT)))
    if proc.returncode != 0:
        raise PhaseFailed("27", f"port_tools/{rel} exited "
                                f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    return lines[:-1], lines[-1]


def trace_tools_on_card(logs, tmp, card):
    """27a: port_tools/tracetool.py's stats, check, export --perfetto,
    tree and mem over each telemetry log, in a process of its own that
    imports neither jax nor torch. `check` exits 0 on 27a's clean run; on
    the chaos and kill runs of phases 18c and 24a, whose stragglers and
    stalls were injected, it gates on retraces only (`--fail-on
    retrace`) and its findings are logged."""
    failures = []
    for tag, (path, fail_on) in logs.items():
        out = str(tmp / f"{tag.split()[0]}.perfetto.json")
        check = ["check", path] + (["--fail-on", fail_on] if fail_on else [])
        argvs = [["stats", path], check,
                 ["export", path, "--perfetto", "-o", out],
                 ["tree", path], ["mem", path]]
        t0 = time.perf_counter()
        runs, mods = run_tool("tracetool.py", argvs)
        secs = time.perf_counter() - t0
        rcs = [r["rc"] for r in runs]
        if any(rcs) or mods["jax"] or mods["jax_package"] or mods["torch"]:
            failures.append(f"{tag}: exit codes {rcs}, modules {mods}: "
                            f"{[r['out'][-1500:] for r in runs if r['rc']]}")
        try:
            with open(out) as f:
                n_events = len(json.load(f)["traceEvents"])
        except (OSError, ValueError, KeyError) as exc:
            failures.append(f"{tag}: the Perfetto JSON does not load: {exc!r}")
            n_events = None
        head = runs[0]["out"].splitlines()[0] if runs[0]["out"] else ""
        findings = runs[1]["out"].strip().splitlines()[-1:]
        log27(card, f"27a: tracetool over {tag} ({path}) in {secs:.2f} s: "
              f"exit codes {rcs}, modules {mods}; stats '{head}'; check "
              f"{findings}; Perfetto {n_events} events")
    if failures:
        raise PhaseFailed("27a", "; ".join(failures))


def replay_checkpoint(ckpt, tmp, card):
    """27b: port_tools/trafficreplay.py --generate --checkpoint over 27a's
    checkpoint (the flagship) on the card, as a process; its telemetry
    through tracetool check. Returns the replay's summary line."""
    r = REPLAY27
    tel = str(tmp / "replay.jsonl")
    t0 = time.perf_counter()
    runs, mods = run_tool("trafficreplay.py", [[
        "--generate", "--checkpoint", ckpt, "--requests",
        str(r["requests"]), "--prompt-lens", r["prompt_lens"],
        "--output-lens", r["output_lens"], "--slots", str(r["slots"]),
        "--telemetry", tel]])
    secs = time.perf_counter() - t0
    (run,) = runs
    lines = [json.loads(x) for x in run["out"].splitlines()
             if x.startswith("{")]
    summary = lines[-1] if lines else {}
    requests = [e for e in map(json.loads, open(tel).read().splitlines())
                if e.get("event") == "request"]
    n_ok = sum(1 for e in requests if e.get("ok"))
    checks, _ = run_tool("tracetool.py", [["check", tel]])
    log27(card, f"27b: trafficreplay --generate --checkpoint (the flagship "
          f"of 27a) in {secs:.2f} s: exit {run['rc']}, {n_ok} of "
          f"{len(requests)} requests ok, modules {mods}; summary "
          f"{json.dumps(summary)}; tracetool check exit {checks[0]['rc']}: "
          f"{checks[0]['out'].strip().splitlines()[-1:]}")
    if run["rc"] != 0 or n_ok == 0 or mods["jax"] or mods["jax_package"] \
            or summary.get("telemetry") != tel or checks[0]["rc"] != 0:
        raise PhaseFailed("27b", f"exit {run['rc']}, {n_ok} ok, modules "
                                 f"{mods}, check {checks[0]}: "
                                 f"{run['out'][-2000:]}")
    return summary


def fixture_differences(got, nxt):
    """(the largest |got - nxt| over the params of the JAX continuation
    `nxt` but the key slices of the packed attention biases, the largest
    over those slices). The key slice's gradient is zero but for rounding
    (softmax ignores a shift shared by every key), and Adam scales that
    noise up to a step of about lr in a direction rounding picks.
    tests/test_torch_updater_map.py uses it on the CPU."""
    worst = key = 0.0
    for k in nxt.files:
        if not k.startswith("params/"):
            continue
        _, layer, name = k.split("/")
        diff = np.abs(got[layer][name] - nxt[k])
        if name == "bqkv":
            d = diff.shape[0] // 3
            key = max(key, float(diff[d:2 * d].max()))
            diff = np.concatenate([diff[:d], diff[2 * d:]])
        worst = max(worst, float(diff.max()))
    return worst, key


def resume_jax_fixture(torch, counters, card):
    """27c: the committed JAX zip (tests/fixtures/torch_port/, made by
    tests/torch_zip_fixture.py with the JAX package on the CPU: 2 layers,
    one head of 32, T 512, vocab 64, Adam at lr 1e-3) restored on the
    card with its Adam state, 3 more steps through the flat flash kernels
    (K1, K4: the packed K2/K6 need head dim 128, or 64 in pairs), the
    params against the JAX continuation stored beside it (read with
    numpy) within ADAM_ATOL. Two controls must end outside it: the zip
    resumed with a fresh updater state (`tx.init`) and the zip left
    unstepped. Returns (the largest difference, the launches of the
    resumed steps)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )
    from deeplearning4j_tpu_torch.weights_io import params_to_numpy

    nxt = np.load(FIXTURE_DIR / "jax_lm_next.npz")
    n_layers = sum(k.endswith("_attn/Wqkv") for k in nxt.files)

    def run(mode):
        net = ModelSerializer.restore(str(FIXTURE_DIR / "jax_lm.zip"),
                                      device="cuda")
        restored = (net.updater_restored, net.iteration_count)
        if mode == "fresh":
            net.opt_state = net.tx.init(net.params)
        if mode != "still":
            for step in range(3, 3 + RESUME_STEPS):
                net.fit(DataSet(nxt[f"x{step}"], nxt[f"y{step}"]))
        torch.cuda.synchronize()
        return restored, fixture_differences(params_to_numpy(net), nxt)

    torch.cuda.synchronize()
    counters.reset()
    restored, (worst, key) = run("resumed")
    launches = counters.read()
    controls = {mode: run(mode)[1][0] for mode in ("fresh", "still")}
    want = {k: 0 for k in launches}
    want.update(K1=n_layers * RESUME_STEPS, K4=n_layers * RESUME_STEPS)
    log27(card, f"27c: the JAX fixture zip restored on the card "
          f"(updater_restored, iteration) {restored}, {RESUME_STEPS} more "
          f"Adam steps: largest param difference from the JAX continuation "
          f"{worst:.3e} (limit {ADAM_ATOL}; key-bias slices {key:.3e}); "
          f"controls: fresh updater {controls['fresh']:.3e}, unstepped "
          f"{controls['still']:.3e}; launches {launches}")
    failures = []
    if restored != (True, 3) or not worst <= ADAM_ATOL:
        failures.append(f"restored {restored}, largest difference {worst} "
                        f"> {ADAM_ATOL}")
    if not all(c > ADAM_ATOL for c in controls.values()):
        failures.append(f"a control ended within the limit: {controls}")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if failures:
        raise PhaseFailed("27c", "; ".join(failures))
    return worst, launches


def jax_flat_updater(torch, net):
    """The leaves the JAX package's ModelSerializer writes to updater.npz
    for `net`'s optimizer state (Adam, no per-layer override) at the
    flagship's size, where it trains through the flat view
    (`FlatViewTransform`): optax's order (nn/updater.py OPTAX_LEAVES), a
    moment one f32 vector over the params in sorted order, lane-hostile
    leaves axis-rotated (layout 2). tests/test_torch_updater_map.py holds
    it to the JAX package's own updater.npz bit for bit on the CPU."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.updater import OPTAX_LEAVES, lane_hostile

    (label, st), = net.opt_state.items()
    keys = [tuple(k) for k in st["keys"]]
    order = [keys.index(p) for p, _ in tree.leaves(net.params)]
    leaves = []
    for field in OPTAX_LEAVES[net.tx.rules[label].kind]:
        if field == "count":
            leaves.append(np.asarray(st["count"], np.int32))
            continue
        parts = []
        for i in order:
            t = st[field][i].detach().float()
            if lane_hostile(tuple(t.shape)):
                t = t.movedim(-1, 0)
            parts.append(t.reshape(-1).cpu().numpy())
        leaves.append(np.concatenate(parts))
    return leaves


def resume_flagship_zip(torch, counters, transformer_lm, DataSet, tmp, card):
    """27c at the flagship's width: phase 6's flagship trained 3 steps,
    written as a zip whose updater is the JAX package's flat-view
    `updater.npz` (`jax_flat_updater`, `flat_layout` 2, no
    port_updater.pt), restored through the mapping on the card; the
    restored optimizer state equals the trained net's bit for bit, and 3
    more steps of both nets end bit for bit equal, launching K2/K6 and
    K8/K9. Returns the launches of the 6 resumed steps."""
    import io
    import zipfile

    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.util.model_serializer import (
        PORT_UPDATER,
        ModelSerializer,
    )

    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
    for _ in range(RESUME_STEPS):
        net.fit(ds)
    path = tmp / "flagship_jax_layout.zip"
    ModelSerializer.write_model(net, str(path))
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist() if n != PORT_UPDATER}
    buf = io.BytesIO()
    np.savez(buf, *jax_flat_updater(torch, net))
    entries["updater.npz"] = buf.getvalue()
    meta = json.loads(entries["meta.json"])
    meta["flat_layout"] = 2
    entries["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for n, data in entries.items():
            zf.writestr(n, data)
    t0 = time.perf_counter()
    twin = ModelSerializer.restore(str(path), device="cuda")
    restore_s = time.perf_counter() - t0
    failures = []
    same_state = twin.updater_restored and all(
        twin.opt_state[label]["count"] == st["count"]
        and all(torch.equal(a, b) for f in ("mu", "nu")
                for a, b in zip(twin.opt_state[label][f], st[f]))
        for label, st in net.opt_state.items())
    torch.cuda.synchronize()
    counters.reset()
    for _ in range(RESUME_STEPS):
        net.fit(ds)
        twin.fit(ds)
    torch.cuda.synchronize()
    launches = counters.read()
    same, worst = _same_trees(torch, net.params, twin.params)
    n, L = 2 * RESUME_STEPS, c["n_layers"]
    want = {"K1": 0, "K2": L * n, "K3": 0, "K4": 0, "K5": 0, "K6": L * n,
            "K7": 0, "K8": n, "K9": n, "K9 dW": n, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    log27(card, f"27c: the flagship ({tree.num_params(net.params)} params) "
          f"as a zip with the JAX package's flat-view updater.npz "
          f"({path.stat().st_size} bytes), restored in {restore_s:.3f} s: "
          f"updater_restored {twin.updater_restored}, optimizer state equal "
          f"bit for bit {same_state}; {RESUME_STEPS} more steps of both: "
          f"params equal bit for bit {same} (largest difference "
          f"{worst:.3e}); launches {launches}")
    if not same_state or not same:
        failures.append(f"state equal {same_state}, params equal {same} "
                        f"({worst})")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if failures:
        raise PhaseFailed("27c", "; ".join(failures))
    return launches


def write_cli_csv(tmp):
    """Phase 25a's synthetic 3-class CSV (from SEED) at tmp/train.csv;
    returns (x, y)."""
    c = CLI_CSV
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(c["rows"], c["features"])).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(c["features"], c["classes"])), 1)
    np.savetxt(tmp / "train.csv", np.column_stack([x, y]), delimiter=",",
               fmt="%.6g")
    return x, y


class _PerRecord:
    """A record reader with the per-record path only."""

    def __init__(self, reader):
        self.reader = reader

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.reader)


def native_io_on_card(torch, counters, Word2Vec, tmp, card):
    """27d: the native IO core built (g++ on the card's machine); phase
    25a's CSV through `to_matrix` equal bit for bit to the per-record
    path; 20a's corpus as raw strings encoded by `native.encode_corpus`
    with the ids of the Python split (both timed); 20a's host-path
    Word2Vec fit on that corpus as raw strings (K13 a step). Returns
    (the launches, the encoder's and the Python path's seconds)."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )

    if not native.available():
        raise PhaseFailed("27d", f"the native IO core did not build: "
                                 f"{native.build_error()}")
    csv_path = PHASE25.get("csv")
    if csv_path is None:
        write_cli_csv(tmp)
        csv_path = str(tmp / "train.csv")
    t0 = time.perf_counter()
    fast = RecordReaderDataSetIterator(CSVRecordReader(csv_path),
                                       CLI_CSV["batch"],
                                       num_classes=CLI_CSV["classes"])
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = RecordReaderDataSetIterator(_PerRecord(CSVRecordReader(csv_path)),
                                       CLI_CSV["batch"],
                                       num_classes=CLI_CSV["classes"])
    n_batches, csv_same = 0, fast._matrix is not None
    while fast.has_next() and slow.has_next():
        a, b = fast.next(), slow.next()
        csv_same &= bool(np.array_equal(a.features, b.features)
                         and np.array_equal(a.labels, b.labels))
        n_batches += 1
    slow_s = time.perf_counter() - t0
    csv_same &= not fast.has_next() and not slow.has_next()
    sents = topic_corpus(np.random.default_rng(0), 10000, 1_000_000,
                         25)[:W2V_SENTENCES]
    raw = [" ".join(s) for s in sents]
    model = (Word2Vec.builder().layer_size(128).window_size(5)
             .min_word_frequency(1).negative_sample(5).epochs(1).seed(1)
             .device("cuda").build())
    model.build_vocab(sents)
    vocab = model.vocab.words()
    t0 = time.perf_counter()
    ids, sent = native.encode_corpus(raw, vocab)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = {w: i for i, w in enumerate(vocab)}
    py_ids = np.fromiter((index.get(w, -1) for line in raw
                          for w in line.split()), np.int32)
    py_sent = np.repeat(np.arange(len(raw)),
                        [len(line.split()) for line in raw])
    python_s = time.perf_counter() - t0
    ids_same = (np.array_equal(ids, py_ids) and np.array_equal(sent, py_sent)
                and int(ids.min()) >= 0)
    torch.cuda.synchronize()
    counters.reset()
    model.fit(raw)
    torch.cuda.synchronize()
    launches = counters.read()
    steps = len(model.loss_history)
    log27(card, f"27d: native core {native.BUILD_DIR}; phase 25a's CSV "
          f"({CLI_CSV['rows']} x {CLI_CSV['features'] + 1}) in {n_batches} "
          f"batches: whole-file path (to_matrix) {fast_s:.4f} s, per-record "
          f"path {slow_s:.4f} s, equal bit for bit {csv_same}; 20a's corpus "
          f"({len(raw)} raw sentences, {len(ids)} words): encode_corpus "
          f"{native_s:.4f} s against the Python split and lookup "
          f"{python_s:.4f} s ({python_s / native_s:.2f}x), ids equal "
          f"{ids_same}; host-path Word2Vec on the raw sentences: "
          f"{steps} steps, loss {model.loss_history[0]:.6f} -> "
          f"{model.loss_history[-1]:.6f}, launches {launches}")
    failures = []
    if not csv_same or not ids_same:
        failures.append(f"CSV paths equal {csv_same}, ids equal {ids_same}")
    if not steps or launches.get("K13") != steps or any(
            n for k, n in launches.items() if k != "K13"):
        failures.append(f"{steps} steps, launches {launches}")
    if not np.isfinite(model.loss_history).all():
        failures.append("a loss is not finite")
    if failures:
        raise PhaseFailed("27d", "; ".join(failures))
    return launches, native_s, python_s


def tracing_and_resume(torch, counters, transformer_lm, DataSet, Word2Vec,
                       card):
    """Phase 27. Returns the launches of its main-path runs (27a's
    profiled steps, 27c's resumed flagship steps and fixture steps, 27d's
    Word2Vec) and its numbers for the record."""
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    runs = []
    launches, tel, ckpt, window_s = profiled_flagship(
        torch, counters, transformer_lm, DataSet, tmp, card)
    runs.append(launches)
    logs = {"27a's fit": (tel, None)}
    for tag, path in TRACES.items():
        logs[tag] = (path, "retrace")
    trace_tools_on_card(logs, tmp, card)
    replay_checkpoint(ckpt, tmp, card)
    worst, fixture_launches = resume_jax_fixture(torch, counters, card)
    runs.append(fixture_launches)
    runs.append(resume_flagship_zip(torch, counters, transformer_lm,
                                    DataSet, tmp, card))
    w2v_launches, native_s, python_s = native_io_on_card(
        torch, counters, Word2Vec, tmp, card)
    runs.append(w2v_launches)
    keys = sorted({k for r in runs for k in r})
    total = {k: sum(r.get(k, 0) for r in runs) for k in keys}
    log27(card, f"phase 27 in {time.perf_counter() - t0:.1f} s; launches "
          f"{total}; profiled window {window_s} s; fixture resume "
          f"{worst:.3e}; encode_corpus {native_s:.4f} s against "
          f"{python_s:.4f} s")
    return total


# ------------------------------------------------------------ phase 28

# 28a: the Iris MLP (4-16-3, tanh, softmax, mcxent, Adam) over the whole
# set 200 times, then fed by the sampling iterator for as many rows
IRIS = dict(epochs=200, hidden=16, lr=0.01, sample_batch=32, min_acc=0.95)
# 28b: LFW at the size of its usual training subset (the people with at
# least 20 images: 62 people, 3,023 images), cut to 64 x 64 synthetic
# pixels; a LeNet-style net, 3 epochs at batch 64; test accuracy above
# 10 x chance (1 / 62); the loss smoothed over `smooth` steps must fall
LFW28 = dict(people=62, per_person=48, size=64, channels=3, train=0.8,
             batch=64, epochs=3, lr=1e-3, min_acc=0.16, smooth=10,
             queue_size=4)
# 28b: one test file through ImageVectorizer and net.output against its
# row of the batched output (softmax outputs in [0, 1], f32: a batch of
# 1 and of 64 may take other cuDNN algorithms)
VECTORIZER_ATOL = 1e-5
# 28c: phase 6's flagship fed 4 fixed batches twice through the new
# iterators (after a DiskBasedQueue round trip), against a plain list
FEED = dict(batches=4, epochs=2, queue_size=2)
# 28d: the curves RBM stack of Hinton and Salakhutdinov (2006),
# 784-400-200-100-50-25-6, greedy CD-1 pretraining one epoch a layer at
# batch 100; cut from the paper's 20,000 training images to 10,000 (the
# synthesis is host numpy, a few ms an image)
CURVES = dict(examples=10000, batch=100,
              sizes=(784, 400, 200, 100, 50, 25, 6), lr=0.1)
# the rows 28d measures each layer's reconstruction on
CURVES_PROBE = 500


def log28(card, msg):
    """Phase 28's log line; the card's name and power limit close it."""
    log(f"{msg}; card {card}")


class StepClock:
    """An iteration listener that times each step on the card: a
    synchronize and a host clock read after every iteration."""

    def __init__(self, torch):
        self.torch, self.stamps = torch, []

    def start(self):
        self.torch.cuda.synchronize()
        self.stamps = [time.perf_counter()]

    def iteration_done(self, model, iteration):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def median_ms(self):
        return statistics.median(
            (b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:]))


def _no_launches(launches):
    return not any(launches.values())


def iris_mlp(conf, MultiLayerNetwork):
    c = IRIS
    cfg = (conf.NeuralNetConfiguration.builder().seed(SEED)
           .learning_rate(c["lr"]).updater("adam").weight_init("xavier")
           .list()
           .layer(conf.DenseLayer(n_in=4, n_out=c["hidden"],
                                  activation="tanh"))
           .layer(conf.OutputLayer(n_in=c["hidden"], n_out=3,
                                   activation="softmax",
                                   loss_function="mcxent"))
           .build())
    return MultiLayerNetwork(cfg, device="cuda").init()


def iris_on_card(torch, counters, card):
    """28a: the Iris MLP on the card, fed by `MultipleEpochsIterator(200,
    IrisDataSetIterator(150))` and, from the same init, by
    `SamplingDataSetIterator(iris, 32, 150 x 200, SEED)`; each arm's
    accuracy on the 150 at least IRIS["min_acc"], no kernel launched (the
    head's shape is not the fused head's). Returns the arms' numbers."""
    from deeplearning4j_tpu_torch.datasets import (
        IrisDataSetIterator,
        MultipleEpochsIterator,
        SamplingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.iris import load_iris_dataset
    from deeplearning4j_tpu_torch.nn import conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    c = IRIS
    iris = load_iris_dataset()
    arms = {
        "multiple_epochs": lambda: MultipleEpochsIterator(
            c["epochs"], IrisDataSetIterator(batch_size=150)),
        "sampling": lambda: SamplingDataSetIterator(
            iris, c["sample_batch"], 150 * c["epochs"], seed=SEED),
    }
    out, failures = {}, []
    for arm, make in arms.items():
        net = iris_mlp(conf, MultiLayerNetwork)
        it = make()
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        net.fit(it)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = counters.read()
        acc = net.evaluate(iris).accuracy()
        steps = net.iteration_count
        out[arm] = dict(accuracy=acc, steps=steps, seconds=secs,
                        steps_per_s=steps / secs)
        log28(card, f"28a: Iris 4-{c['hidden']}-3 by {arm} ({steps} steps) "
              f"in {secs:.3f} s, {steps / secs:.1f} steps/s: accuracy on "
              f"the 150 {acc:.4f} (limit {c['min_acc']}); launches "
              f"{launches}")
        if acc < c["min_acc"] or not _no_launches(launches):
            failures.append(f"{arm}: accuracy {acc}, launches {launches}")
    if failures:
        raise PhaseFailed("28a", "; ".join(failures))
    return out


def lfw_net(conf, MultiLayerNetwork, classes):
    """The LeNet-style net of 28b: conv 20 5x5, pool 2, conv 50 5x5, pool
    2, dense 500, softmax over the people."""
    c = LFW28
    cfg = (conf.NeuralNetConfiguration.builder().seed(SEED)
           .learning_rate(c["lr"]).updater("adam").weight_init("xavier")
           .list()
           .layer(conf.ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu"))
           .layer(conf.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
           .layer(conf.ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu"))
           .layer(conf.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
           .layer(conf.DenseLayer(n_out=500, activation="relu"))
           .layer(conf.OutputLayer(n_out=classes, activation="softmax",
                                   loss_function="mcxent"))
           .set_input_type(conf.InputType.convolutional(
               c["size"], c["size"], c["channels"]))
           .build())
    return MultiLayerNetwork(cfg, device="cuda").init()


def lfw_on_card(torch, counters, card):
    """28b: a synthetic LFW corpus of 62 people x 48 images (64 x 64 x 3)
    split by `LocalUnstructuredDataFormatter` (directory labels, 0.8
    train, SEED), read by `ImageRecordReader` and trained 3 epochs on the
    card through `AsyncDataSetIterator(ImageRecordReaderDataSetIterator
    (..., shuffle=True))`; evaluated on the test split (`eval/`); one
    test file through `ImageVectorizer(...).normalize()` and
    `net.output` against its row of the batched output. Returns its
    numbers."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator,
        ImageRecordReader,
        ImageRecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.lfw import generate_synthetic_lfw
    from deeplearning4j_tpu_torch.datasets.rearrange import (
        LabelingType,
        LocalUnstructuredDataFormatter,
    )
    from deeplearning4j_tpu_torch.datasets.vectorizer import ImageVectorizer
    from deeplearning4j_tpu_torch.nn import conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.util import image_loader
    from deeplearning4j_tpu_torch.util.time_series import moving_average

    c = LFW28
    size, ch = c["size"], c["channels"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lfw_"))
    try:
        corpus = tmp / "lfw"
        t0 = time.perf_counter()
        generate_synthetic_lfw(str(corpus), n_people=c["people"],
                               images_per_person=c["per_person"], size=size,
                               seed=SEED)
        synth_s = time.perf_counter() - t0
        people = sorted(d.name for d in corpus.iterdir() if d.is_dir())
        decoder = ("Pillow (PNG files)" if image_loader._HAVE_PIL else
                   "the PNM codec (PNM bytes under .png names; no Pillow)")
        t0 = time.perf_counter()
        fmt = LocalUnstructuredDataFormatter(
            str(tmp / "out"), str(corpus), LabelingType.DIRECTORY,
            percent_train=c["train"], seed=SEED)
        fmt.rearrange()
        split_s = time.perf_counter() - t0
        # the corpus's people name the classes in both splits (the
        # corpus's marker file lands in a directory of its own)
        train = ImageRecordReader(fmt.get_train(), size, size, ch,
                                  labels=people)
        test = ImageRecordReader(fmt.get_test(), size, size, ch,
                                 labels=people)
        train_it = ImageRecordReaderDataSetIterator(train, c["batch"],
                                                    shuffle=True, seed=SEED)
        t0 = time.perf_counter()
        train_it.reset()  # reads and decodes every training file
        read_s = time.perf_counter() - t0
        net = lfw_net(conf, MultiLayerNetwork, len(people))
        scores = CollectScoresIterationListener(1)
        net.set_listeners(scores)
        feed = AsyncDataSetIterator(train_it, queue_size=c["queue_size"])
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        net.fit(feed, epochs=c["epochs"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counters.read()
        losses = [float(s) for _, s in scores.scores]
        smooth = moving_average(losses, c["smooth"])
        test_it = ImageRecordReaderDataSetIterator(test, c["batch"])
        acc = net.evaluate(test_it).accuracy()
        path, label = test._files[0]
        vec = ImageVectorizer(path, len(people), label).normalize().vectorize()
        test_it.reset()
        first = test_it.next()
        same_x = np.array_equal(vec.features[0], first.features[0])
        same_y = np.array_equal(vec.labels[0], first.labels[0])
        row = net.output(vec.features).float().cpu().numpy()[0]
        batched = net.output(first.features).float().cpu().numpy()[0]
        diff = float(np.abs(row - batched).max())
        steps = net.iteration_count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log28(card, f"28b: LFW {c['people']} people x {c['per_person']} images "
          f"({size} x {size} x {ch}), Pillow present "
          f"{image_loader._HAVE_PIL}, decoded by {decoder}: synthesized in "
          f"{synth_s:.3f} s, split {fmt.num_examples_to_train_on} / "
          f"{fmt.num_test_examples} in {split_s:.3f} s, the training split "
          f"read in {read_s:.3f} s; {c['epochs']} epochs ({steps} steps at "
          f"batch {c['batch']}) through AsyncDataSetIterator in "
          f"{train_s:.3f} s ({steps / train_s:.1f} steps/s); loss smoothed "
          f"over {c['smooth']} steps {smooth[0]:.4f} -> {smooth[-1]:.4f}; "
          f"test accuracy {acc:.4f} (limit {c['min_acc']}); the vectorizer's "
          f"row: features equal {same_x}, label equal {same_y}, output "
          f"within {diff:.3e} of the batched row (limit {VECTORIZER_ATOL}); "
          f"launches {launches}")
    failures = []
    if not smooth[-1] < smooth[0] or not np.isfinite(losses).all():
        failures.append(f"the smoothed loss did not fall ({smooth[0]} -> "
                        f"{smooth[-1]})")
    if acc <= c["min_acc"]:
        failures.append(f"test accuracy {acc}")
    if not (same_x and same_y and diff <= VECTORIZER_ATOL):
        failures.append(f"vectorizer row: features {same_x}, label "
                        f"{same_y}, output {diff}")
    if not _no_launches(launches):
        failures.append(f"launches {launches}")
    if failures:
        raise PhaseFailed("28b", "; ".join(failures))
    return dict(synth_s=synth_s, split_s=split_s, read_s=read_s,
                train_s=train_s, accuracy=acc, pillow=image_loader._HAVE_PIL)


def feed_flagship(torch, counters, transformer_lm, DataSet, card):
    """28c: 4 fixed token batches of phase 6's shape through a
    DiskBasedQueue (polled back equal), then phase 6's flagship from one
    init trained on them twice over by `MultipleEpochsIterator(2,
    AsyncDataSetIterator(ListDataSetIterator(batches), queue_size=2))`
    and by a plain `ListDataSetIterator` of the same 8 batches: exact
    launches in each arm (K2 = K6 = 48, K8 = K9 = 8) and the final params
    bit for bit. Returns (the launches of both arms, the arms' step
    medians)."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator,
        ListDataSetIterator,
        MultipleEpochsIterator,
    )
    from deeplearning4j_tpu_torch.util.disk_queue import DiskBasedQueue

    c, f = TRAIN, FEED
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(f["batches"]):
        toks = np.asarray(rng.integers(0, c["vocab_size"],
                                       (c["batch"], c["seq"])), np.int32)
        batches.append(DataSet(toks, np.roll(toks, -1, axis=1)))
    q = DiskBasedQueue(tempfile.mkdtemp(prefix="chip_smoke_queue_"))
    t0 = time.perf_counter()
    q.add_all(batches)
    polled = [q.poll() for _ in batches]
    queue_s = time.perf_counter() - t0
    same_queue = q.is_empty() and all(
        np.array_equal(a.features, b.features)
        and np.array_equal(a.labels, b.labels)
        for a, b in zip(batches, polled))
    q.close()
    feeds = {
        "iterators": lambda: MultipleEpochsIterator(
            f["epochs"], AsyncDataSetIterator(ListDataSetIterator(polled),
                                              queue_size=f["queue_size"])),
        "list": lambda: ListDataSetIterator(polled * f["epochs"]),
    }
    S, L = f["batches"] * f["epochs"], c["n_layers"]
    want = {"K1": 0, "K2": L * S, "K3": 0, "K4": 0, "K5": 0, "K6": L * S,
            "K7": 0, "K8": S, "K9": S, "K9 dW": S, "K10": 0, "K11": 0,
            "K12": 0, "K13": 0}
    nets, runs, medians, failures = {}, [], {}, []
    for arm, make in feeds.items():
        net = flagship(transformer_lm, max_length=c["seq"]).init(SEED)
        clock = StepClock(torch)
        net.set_listeners(clock)
        it = make()
        counters.reset()
        clock.start()
        net.fit(it)
        torch.cuda.synchronize()
        wall = clock.stamps[-1] - clock.stamps[0]
        launches = counters.read()
        runs.append(launches)
        nets[arm] = net
        medians[arm] = clock.median_ms()
        log28(card, f"28c: the flagship fed by {arm} ({net.iteration_count} "
              f"steps) in {wall:.3f} s, step median {medians[arm]:.3f} ms; "
              f"launches {launches}")
        if launches != want or net.iteration_count != S:
            failures.append(f"{arm}: {net.iteration_count} steps, launches "
                            f"{launches}, expected {want}")
    same, worst = _same_trees(torch, nets["iterators"].params,
                              nets["list"].params)
    log28(card, f"28c: DiskBasedQueue round trip of {len(batches)} batches "
          f"in {queue_s:.3f} s, equal {same_queue}; the two arms' params "
          f"equal bit for bit {same} (largest difference {worst:.3e})")
    if not same_queue:
        failures.append("the queue's polled batches differ from the written")
    if not same:
        failures.append(f"the arms' params differ by up to {worst}")
    if failures:
        raise PhaseFailed("28c", "; ".join(failures))
    return runs, medians


def curves_on_card(torch, counters, card):
    """28d: `CurvesDataSetIterator(100, 10000)` feeding greedy CD-1
    pretraining of the curves RBM stack on the card, one epoch a layer;
    each layer's mean-field reconstruction error of its own input (the
    trained stack below it, CURVES_PROBE rows) falls from its initial
    params to its trained ones. Returns its numbers."""
    from deeplearning4j_tpu_torch.datasets import CurvesDataSetIterator
    from deeplearning4j_tpu_torch.nn import conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    c = CURVES
    t0 = time.perf_counter()
    it = CurvesDataSetIterator(batch_size=c["batch"],
                               num_examples=c["examples"], seed=SEED)
    synth_s = time.perf_counter() - t0
    b = (conf.NeuralNetConfiguration.builder().seed(SEED)
         .learning_rate(c["lr"]).updater("sgd").weight_init("xavier").list())
    for n_in, n_out in zip(c["sizes"], c["sizes"][1:]):
        b = b.layer(conf.RBM(n_in=n_in, n_out=n_out))
    net = MultiLayerNetwork(b.pretrain(True).backprop(False).build(),
                            device="cuda").init()
    start = {k: {n: t.clone() for n, t in p.items()}
             for k, p in net.params.items()}
    x = torch.as_tensor(it.next().features, device="cuda")
    x = torch.cat([x] + [torch.as_tensor(it.next().features, device="cuda")
                         for _ in range(CURVES_PROBE // c["batch"] - 1)])
    it.reset()
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    net.fit(it)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = counters.read()
    rows = []
    with torch.no_grad():
        for i, (name, lc, rbm) in enumerate(zip(
                net.layer_names, net.layer_confs, net.impls)):
            h = net._forward(net.params, net.state, x, to_layer=i)[0]
            errs = []
            for p in (start[name], net.params[name]):
                v = rbm._prop_down(lc, p, rbm._prop_up(lc, p, h))
                errs.append(float(((v - h) ** 2).mean()))
            rows.append((f"{lc.n_in}-{lc.n_out}", *errs))
    log28(card, f"28d: curves {c['examples']} images synthesized in "
          f"{synth_s:.3f} s (host); the RBM stack "
          f"{'-'.join(map(str, c['sizes']))} pretrained one epoch a layer "
          f"({c['examples'] // c['batch']} steps a layer at batch "
          f"{c['batch']}, CD-1) in {device_s:.3f} s on the card; "
          f"reconstruction error (initial -> trained) "
          + ", ".join(f"{k} {a:.5f} -> {t:.5f}" for k, a, t in rows)
          + f"; launches {launches}")
    bad = [k for k, a, t in rows if not (np.isfinite(t) and t < a)]
    if bad or not _no_launches(launches):
        raise PhaseFailed("28d", f"reconstruction did not fall for {bad}; "
                                 f"launches {launches}")
    return dict(synth_s=synth_s, device_s=device_s)


def datasets_and_utils(torch, counters, transformer_lm, DataSet, card):
    """Phase 28. Returns the launches of its main-path runs (28c's two
    arms; 28a, 28b and 28d launch none) and its numbers for the
    record."""
    t0 = time.perf_counter()
    iris = iris_on_card(torch, counters, card)
    lfw = lfw_on_card(torch, counters, card)
    runs, medians = feed_flagship(torch, counters, transformer_lm, DataSet,
                                  card)
    curves = curves_on_card(torch, counters, card)
    keys = sorted({k for r in runs for k in r})
    total = {k: sum(r.get(k, 0) for r in runs) for k in keys}
    log28(card, f"phase 28 in {time.perf_counter() - t0:.1f} s; launches "
          f"{total}; Iris accuracy "
          + ", ".join(f"{a} {r['accuracy']:.4f} ({r['steps_per_s']:.1f} "
                      f"steps/s)" for a, r in iris.items())
          + f"; LFW test accuracy {lfw['accuracy']:.4f} (synthesis "
          f"{lfw['synth_s']:.3f} s, read {lfw['read_s']:.3f} s, train "
          f"{lfw['train_s']:.3f} s, Pillow {lfw['pillow']}); flagship step "
          f"medians {medians}; curves synthesis {curves['synth_s']:.3f} s "
          f"against {curves['device_s']:.3f} s on the card")
    return total


# ------------------------------------------------------------ phase 29

# the compositions of the rest of A7 at world size 1 over NCCL and in one
# process: 29a/29b at bench mode longcontext's dims (T 4096, batch 4),
# where the meshless flagship runs the ring's kernels (K1/K5 over the
# whole sequence: 21d), so a ring of one block is its step bit for bit
COMPOSE = dict(seq=4096, batch=4, steps=2, timed=2, ring_blocks=4,
               shards=2, pipe_M=4, pipe_blocks=2)
# 29d's greedy and sampled tokens
SPLIT_NEW = 32


def log29(card, msg):
    """A phase-29 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def no_launches(counters):
    return {k: 0 for k in counters.read()}


def compose_net(transformer_lm, dtype="bfloat16", seq_axis="", T=None):
    c = TRAIN
    return transformer_lm(vocab_size=c["vocab_size"], d_model=c["d_model"],
                          n_heads=c["n_heads"], n_layers=c["n_layers"],
                          d_ff=c["d_ff"], max_length=T or COMPOSE["seq"],
                          dtype=dtype, device="cuda",
                          seq_parallel_axis=seq_axis).init(SEED)


def labels_masked(DataSet, ds, seed):
    """`ds` with a labels mask (each label kept with probability 0.7,
    the first of a row always: the JAX package's
    test_seq_pipe_masked_loss_matches_dense), so each time block holds
    its own count of valid labels."""
    rng = np.random.default_rng(seed)
    m = (rng.random(ds.labels.shape) < 0.7).astype(np.float32)
    m[:, 0] = 1.0
    return DataSet(ds.features, ds.labels, labels_mask=m)


def seq_model_on_card(torch, counters, transformer_lm, DataSet, mesh,
                      card):
    """29a: "seq" with "model". (i) The flagship at longcontext's dims
    under {"seq": 1, "model": 1} (NCCL, world size 1; set_mesh, the SP
    step over the split layers): COMPOSE's steps bit for bit with plain
    fit and with 21d's launches (K1 = K5 = 6 a step, K8 = K9 = 1). (ii)
    Block 0's attention over 2 model shards in this process, each shard
    (its one head of 128) running the ring over 4 blocks of 1024
    (`attention_shards` under a `SeqShard` of an `InProcessRing`),
    against the whole layer (K1/K5 over the whole sequence) with an f32
    reference: the split's largest relative error over the output and
    every gradient at most SPLIT_RATIO x the whole's; exactly 20 K1 and
    20 K5 (10 of each a shard); each arm's forward + backward time.
    Returns the launches of (i) and of the split arm."""
    from deeplearning4j_tpu_torch.nn.layers import get_impl
    from deeplearning4j_tpu_torch.nn.layers.attention import attention_shards
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
    from deeplearning4j_tpu_torch.ops.shard_scope import SeqShard, sharded
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        InProcessRing,
    )

    c, L = COMPOSE, TRAIN["n_layers"]
    ds = lm_batch(DataSet, TRAIN["vocab_size"], c["batch"], c["seq"])
    plain = compose_net(transformer_lm)
    sm = compose_net(transformer_lm, seq_axis="seq")
    sm.set_mesh(mesh, axes={"seq": "seq", "model": "model"})
    runs, losses = {}, {}
    for name, net in (("seq x model", sm), ("plain", plain)):
        torch.cuda.synchronize()
        counters.reset()
        losses[name] = []
        for _ in range(c["steps"]):
            net.fit(ds)
            losses[name].append(net.score_value)
        torch.cuda.synchronize()
        runs[name] = counters.read()
    same = canonical_equal(torch, plain, sm) and (
        losses["plain"] == losses["seq x model"])
    fit = runs["seq x model"]
    log29(card, f"29a(i): {{seq 1, model 1}} (NCCL, world size 1), T "
          f"{c['seq']} batch {c['batch']} bf16, {c['steps']} steps: "
          f"losses {losses}; params bit for bit with plain fit's {same}; "
          f"launches {runs}")
    if not same:
        raise PhaseFailed("29a", "seq x model at one rank is not plain fit "
                                 "bit for bit")
    if (fit["K1"], fit["K5"], fit["K2"], fit["K8"]) != (
            L * c["steps"], L * c["steps"], 0, c["steps"]) \
            or fit != runs["plain"]:
        raise PhaseFailed("29a", f"launches {runs}")
    sm.set_mesh(None)

    conf = sm.layer_vertices["blk0_attn"].layer
    P = sm.params["blk0_attn"]
    split = {"Wqkv": 1, "bqkv": 0, "Wo": 0}
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    x32 = torch.randn((c["batch"], c["seq"], TRAIN["d_model"]),
                      generator=g, device="cuda")
    cot32 = torch.randn(x32.shape, generator=g, device="cuda")
    names = ["x"] + sorted(P)

    def run(dtype, shards):
        p = {k: t.detach().to(dtype).requires_grad_() for k, t in P.items()}
        x = x32.to(dtype).requires_grad_()
        if shards:
            tr = InProcessShards(shards)
            with sharded(seq=SeqShard(conf.seq_parallel_axis,
                                      InProcessRing(c["ring_blocks"]), 0,
                                      1)):
                y = attention_shards(
                    conf, tr.pieces(p, split, conf.n_heads), x, tr)
        else:
            y = get_impl(conf).apply(conf, p, {}, x)[0]
        grads = torch.autograd.grad(y, [x] + [p[k] for k in sorted(p)],
                                    cot32.to(dtype))
        return {"y": y.detach(), **dict(zip(names, grads))}

    ref = run(torch.float32, 0)
    whole = run(torch.bfloat16, 0)
    torch.cuda.synchronize()
    counters.reset()
    parts = run(torch.bfloat16, c["shards"])
    torch.cuda.synchronize()
    launches = counters.read()
    e_w = max(_rel(whole[k], ref[k]) for k in ref)
    e_s = max(_rel(parts[k], ref[k]) for k in ref)
    per_shard = c["ring_blocks"] * (c["ring_blocks"] + 1) // 2
    want = no_launches(counters)
    want.update({"K1": c["shards"] * per_shard,
                 "K5": c["shards"] * per_shard})
    arm_ms = {"whole": event_ms(torch, lambda: run(torch.bfloat16, 0),
                                c["timed"]),
              f"{c['shards']} shards x ring of {c['ring_blocks']}":
                  event_ms(torch, lambda: run(torch.bfloat16, c["shards"]),
                           c["timed"])}
    log29(card, f"29a(ii): block 0's attention at T {c['seq']} batch "
          f"{c['batch']} over {c['shards']} model shards in this process, "
          f"each a ring of {c['ring_blocks']} blocks of "
          f"{c['seq'] // c['ring_blocks']} on its head of 128: largest "
          f"relative error against the f32 reference, whole bf16 "
          f"{e_w:.3e}, split bf16 {e_s:.3e} (gate {SPLIT_RATIO} x the "
          f"whole's); launches {launches} (expected {want}); forward + "
          f"backward ms (CUDA events, median of {c['timed']}) {arm_ms}")
    if not e_s <= SPLIT_RATIO * e_w:
        raise PhaseFailed("29a", "the split ring is off the whole layer "
                                 "beyond bf16 rounding")
    if launches != want:
        raise PhaseFailed("29a", f"the split ring launched {launches}, "
                                 f"expected {want}")
    return [fit, launches], {"errors": (e_w, e_s), "ms": arm_ms}


def pipe_seq_on_card(torch, counters, transformer_lm, DataSet, mesh, card):
    """29b: "seq" with "pipe" at longcontext's dims. (i) {"pipe": 1,
    "seq": 1} at M = 1 (NCCL, world size 1): COMPOSE's steps bit for bit
    with the meshless net, with its launches. (ii) S = 2 stages in this
    process, each stage's attention the ring over 2 blocks of 2048
    (`place_in_process(..., seq_blocks=2)`), M = 4, without and with a
    labels mask: the launches stated before the run (3 ring hops a block
    a microbatch: K1 = K5 = 3·6·M a step; K8 = K9 = M), and f32 twins
    within PIPE_PARITY_TOL of the meshless f32 nets (the masked arm of
    the masked meshless net). Each arm's step time. Returns the
    launches of the composed arms."""
    from deeplearning4j_tpu_torch.parallel.pipeline import place_in_process

    c, L, M = COMPOSE, TRAIN["n_layers"], COMPOSE["pipe_M"]
    n = c["steps"]
    ds = lm_batch(DataSet, TRAIN["vocab_size"], c["batch"], c["seq"])
    dsm = labels_masked(DataSet, ds, SEED + 29)
    hops = c["pipe_blocks"] * (c["pipe_blocks"] + 1) // 2

    def arm_net(arm, dtype="bfloat16"):
        if arm.startswith("meshless"):
            return compose_net(transformer_lm, dtype)
        net = compose_net(transformer_lm, dtype, seq_axis="seq")
        if arm.startswith("pipe 1"):
            net.set_mesh(mesh, axes={"pipe": "pipe", "seq": "seq"},
                         n_microbatches=1)
        else:
            place_in_process(net, 2, M, seq_blocks=c["pipe_blocks"])
        return net

    arms = {"meshless": ds, "pipe 1 seq 1 M=1": ds,
            "in-process S=2 ring 2": ds, "meshless masked": dsm,
            "in-process S=2 ring 2 masked": dsm}
    want = no_launches(counters)
    want.update({"K1": hops * L * M * n, "K5": hops * L * M * n,
                 "K8": M * n, "K9": M * n, "K9 dW": M * n})
    log29(card, f"29b: expected launches of each in-process arm over {n} "
          f"steps: {want}")
    nets, runs, losses = {}, {}, {}
    for arm, data in arms.items():
        net = arm_net(arm)
        torch.cuda.synchronize()
        counters.reset()
        losses[arm] = []
        for _ in range(n):
            net.fit(data)
            losses[arm].append(float(net._score_raw))
        torch.cuda.synchronize()
        runs[arm] = counters.read()
        nets[arm] = net
    same = (canonical_equal(torch, nets["meshless"],
                            nets["pipe 1 seq 1 M=1"])
            and losses["meshless"] == losses["pipe 1 seq 1 M=1"])
    log29(card, f"29b(i): {{pipe 1, seq 1}} at M = 1 (NCCL, world size 1), "
          f"{n} steps: params and every loss bit for bit with the meshless "
          f"net's {same}; launches {runs['pipe 1 seq 1 M=1']} (meshless "
          f"{runs['meshless']})")
    if not same or runs["pipe 1 seq 1 M=1"] != runs["meshless"]:
        raise PhaseFailed("29b", "pipe x seq at M = 1 is not the meshless "
                                 "step bit for bit")
    for arm in ("in-process S=2 ring 2", "in-process S=2 ring 2 masked"):
        if runs[arm] != want:
            raise PhaseFailed("29b", f"{arm}: launches {runs[arm]}, "
                                     f"expected {want}")
    gap = {}
    for arm, base in (("in-process S=2 ring 2", "meshless"),
                      ("in-process S=2 ring 2 masked", "meshless masked")):
        a, b = arm_net(arm, "float32"), arm_net(base, "float32")
        for _ in range(n):
            a.fit(arms[arm])
            b.fit(arms[base])
        gap[arm] = max_param_diff(torch, b, a)
        del a, b
    steps = {arm: event_ms(torch, lambda nt=nets[arm], d=data: nt.fit(d),
                           c["timed"]) for arm, data in arms.items()}
    log29(card, f"29b(ii): S = 2 in-process stages, a ring of "
          f"{c['pipe_blocks']} blocks of {c['seq'] // c['pipe_blocks']} in "
          f"each, M = {M}, {n} steps: launches {runs['in-process S=2 ring 2']}"
          f" and masked {runs['in-process S=2 ring 2 masked']} (exact); "
          f"the f32 twins' largest param distance from the meshless f32 "
          f"nets {gap} (gate {PIPE_PARITY_TOL}); losses "
          f"{ {a: losses[a] for a in arms} }; step ms (CUDA events, median "
          f"of {c['timed']} after one warm) {steps}")
    bad = {a: g for a, g in gap.items() if not g <= PIPE_PARITY_TOL}
    if bad:
        raise PhaseFailed("29b", f"pipe x seq params off the meshless "
                                 f"net's by {bad} (f32)")
    total = {k: runs["pipe 1 seq 1 M=1"][k]
             + runs["in-process S=2 ring 2"][k]
             + runs["in-process S=2 ring 2 masked"][k] for k in want}
    return total, {"steps_ms": steps, "gap": gap}


def resume_on_card(torch, counters, transformer_lm, DataSet, mesh, card):
    """29c: resume_from(target_mesh=..., target_axes=...) on both
    containers. The flagship's checkpoint written under {"data": 1,
    "model": 1} restored into {"pipe": 1} through the resharding engine:
    the restored params are the source's, the bytes read are the plan's,
    and one step is bit for bit the step of a twin restored whole and
    then placed (23b's restore). A MultiLayerNetwork (an Adam MLP)
    checkpoint under {"data": 1} restored into a ZeRO-1 placement (a
    `reshard.Placement`) likewise. A missing named step raises
    FileNotFoundError; an empty directory resumes from 0. 24a's elastic
    workers restore through it. Returns the graph step's launches."""
    import tempfile

    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.reshard.planner import Placement
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    c = TRAIN
    ds = lm_batch(DataSet, c["vocab_size"], c["batch"], c["seq"])
    rng = np.random.default_rng(SEED + 29)
    xm = rng.standard_normal((256, 4)).astype(np.float32)
    ym = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 256)]
    mlp = DataSet(xm, ym)
    out, launches = {}, None
    for kind in ("graph", "mln"):
        if kind == "graph":
            def make():
                return pipe_net(torch, transformer_lm, mesh, "meshless")
            src_axes, data = {"data": "data", "model": "model"}, ds
            target = dict(target_mesh=mesh, target_axes={"pipe": "pipe"})
        else:
            def make():
                return iris_mlp(C, MultiLayerNetwork)
            src_axes, data = {"data": "data"}, mlp
            target = dict(target_mesh=Placement.of(
                {"data": 1}, {"data": "data"}, zero1=True))
        with tempfile.TemporaryDirectory() as d:
            src = make()
            src.set_mesh(mesh, axes=src_axes)
            src.fit(data)
            Checkpointer(d).save(src)
            placed = make()
            rec = Recorder(path=None)
            prev = set_default(rec)
            try:
                t0 = time.perf_counter()
                start = placed.resume_from(d, **target)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            finally:
                set_default(prev)
            twin = make()
            twin.resume_from(d)
            twin.set_mesh(target["target_mesh"],
                          axes=target.get("target_axes"))
            try:
                make().resume_from(d, 99, **target)
                missing = False
            except FileNotFoundError:
                missing = True
            with tempfile.TemporaryDirectory() as empty:
                cold = make().resume_from(empty, **target)
        plans = [e for e in rec.events if e.get("event") == "reshard_plan"]
        read = [(e["seconds"], e["bytes_moved"], e["bytes_planned"])
                for e in rec.events
                if e.get("event") == "span" and e.get("name") == "reshard"]
        restored = canonical_equal(torch, placed, src) and start == 1
        torch.cuda.synchronize()
        counters.reset()
        placed.fit(data)
        torch.cuda.synchronize()
        if kind == "graph":
            launches = counters.read()
        twin.fit(data)
        stepped = (canonical_equal(torch, placed, twin)
                   and placed.score_value == twin.score_value)
        out[kind] = {"restore_s": restore_s, "read": read}
        log29(card, f"29c: {kind}: checkpoint of {src_axes} restored by "
              f"resume_from({ {k: str(v) for k, v in target.items()} }): "
              f"step {start}, params equal the source's {restored}, plan "
              f"{[(p['src'], p['dst'], p['bytes_moved']) for p in plans]}, "
              f"reshard span {read} (s, bytes read, planned), {restore_s:.3f}"
              f" s; one step bit for bit with the twin restored whole and "
              f"placed {stepped}; a missing step raises FileNotFoundError "
              f"{missing}; an empty directory resumes from {cold}")
        if not (restored and stepped and plans and read and missing
                and cold == 0 and all(r[1] == r[2] for r in read)):
            raise PhaseFailed("29c", f"{kind}: resume_from into a target "
                                     "placement")
        for nt in (src, placed, twin):
            nt.set_mesh(None)
    return launches, out


def greedy_oracle(phase, whole, prompts, reqs):
    """Each served greedy token against the argmax of the whole net's
    full forward over the prompt and the tokens before it; a difference
    is allowed only at a top-2 margin under ORACLE_MARGIN_TOL, where the
    stream then parts. Returns (tokens checked, [(prompt length, index,
    margin)] of the parted streams)."""
    checked, parted = 0, []
    for prompt, r in zip(prompts, reqs):
        seq = list(prompt)
        for i, tok in enumerate(r.emitted):
            probs = whole.output(np.asarray(seq)[None])[0, -1].float()
            ref = int(probs.argmax())
            if ref != tok:
                top2 = probs.topk(2).values
                margin = float(top2[0] - top2[1])
                if margin >= ORACLE_MARGIN_TOL:
                    raise PhaseFailed(phase, f"prompt of {len(prompt)}: "
                                             f"token {i} is {tok}, the "
                                             f"whole net gives {ref} (top-2 "
                                             f"margin {margin:.3e})")
                parted.append((len(prompt), i, margin))
                break
            checked += 1
            seq.append(tok)
    return checked, parted


def split_decode_on_card(torch, counters, transformer_lm, card):
    """29d: the serving flagship (f32, f32 cache) split over 2 "model"
    shards in this process (tensor_parallel.place_in_process), served
    through GenerationEngine: SPLIT_NEW greedy tokens for 4 prompts, each
    the argmax of the whole net's full forward (a difference allowed only
    at a top-2 margin under ORACLE_MARGIN_TOL, where the streams then
    part); the prefill's K1 launches at a shard's one head of 128; one
    sampled run through the split prefill and decode steps with exactly
    SPLIT_NEW K12 launches; each shard's cache bytes half the whole
    net's. The MoE LM's decode raises the JAX package's ValueError
    meshless and split alike (its decode is not supported in either
    package). Returns the launches."""
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_moe_lm,
    )
    from deeplearning4j_tpu_torch.nn.decode import make_decode_fn
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        place_in_process,
    )
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    m = COMPOSE["shards"]
    whole = transformer_lm(**LM, dtype="float32", device="cuda").init(SEED)
    net = transformer_lm(**LM, dtype="float32", device="cuda").init(SEED)
    place_in_process(net, m)
    engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(64, 512,
                                                                 1024)),
                              slots=4, max_new_tokens=SPLIT_NEW,
                              page_size=16, prefill_chunk=1024)
    engine.warmup()
    rng = torch.Generator().manual_seed(SEED + 29)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in MLN_PROMPTS]
    torch.cuda.synchronize()
    counters.reset()
    engine.start()
    t0 = time.perf_counter()
    reqs = [engine.submit_generate(p, SPLIT_NEW) for p in prompts]
    for r in reqs:
        if not r.wait(600) or r.error is not None:
            raise PhaseFailed("29d", f"request {r.request_id}: {r.error}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    engine.drain()
    checked, parted = greedy_oracle("29d", whole, prompts, reqs)
    s = MLN_SAMPLED
    toks = torch.randint(0, LM["vocab_size"], (s["rows"], s["prompt"]),
                         generator=rng).numpy()
    cap = s["prompt"] + SPLIT_NEW
    cache = net.init_kv_cache(s["rows"], cap)
    whole_cache = whole.init_kv_cache(s["rows"], cap)

    def nbytes(entry):
        return sum(t.numel() * t.element_size() for t in entry.values())

    halves = all(nbytes(e) * m == nbytes(whole_cache[name])
                 for name, entries in cache.items() for e in entries)
    shard_bytes = sum(nbytes(e) for e in cache["blk0_attn"][:1])
    prefill, step = net.prefill_fn(), net.incremental_decode_fn()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rows = np.arange(s["rows"])
    counters.reset()
    probs, cache = prefill(net.params, net.state, cache, toks,
                           np.ones_like(toks, np.float32), rows,
                           np.zeros_like(rows),
                           np.full_like(rows, s["prompt"] - 1))
    outside = 0
    for pos in range(s["prompt"], s["prompt"] + SPLIT_NEW):
        logits = probs.float().clamp_min(1e-30).log()
        noise = fsm.gumbel_noise(gen, s["rows"], LM["vocab_size"], "cuda")
        tok = fsm.fused_sample(logits, noise, temperature=1.0,
                               top_k=s["top_k"], top_p=s["top_p"])
        top = logits.topk(s["top_k"], dim=-1).indices
        outside += int((top != tok.long()[:, None]).all(dim=-1).sum())
        if pos < s["prompt"] + SPLIT_NEW - 1:
            probs, cache = step(net.params, net.state, cache,
                                tok.cpu().numpy(), np.full_like(rows, pos))
    torch.cuda.synchronize()
    sampled = counters.read()
    # one decode step of the rows, split and whole, at the same position
    tok_h = tok.cpu().numpy()
    pos_h = np.full_like(rows, s["prompt"] + SPLIT_NEW - 1)
    whole_step = whole.incremental_decode_fn()
    step_ms = {
        "whole": event_ms(torch, lambda: whole_step(
            whole.params, whole.state, whole_cache, tok_h, pos_h), 20),
        f"{m} shards": event_ms(torch, lambda: step(
            net.params, net.state, cache, tok_h, pos_h), 20)}
    moe_refusals = []
    moe = transformer_moe_lm(vocab_size=64, d_model=32, n_heads=2,
                             n_layers=2, n_experts=4, max_length=64,
                             device="cuda").init(SEED)
    for arm in ("meshless", "expert 2 in-process"):
        if arm != "meshless":
            place_in_process(moe, 2, role="expert")
        try:
            make_decode_fn(moe)
        except ValueError as e:
            moe_refusals.append("cannot stream one token" in str(e))
    log29(card, f"29d: the serving flagship (f32) over {m} model shards in "
          f"this process through GenerationEngine: {len(prompts)} prompts "
          f"of {MLN_PROMPTS}, {SPLIT_NEW} greedy tokens each in {wall:.3f} "
          f"s; {checked} tokens equal the whole net's full-forward argmax, "
          f"streams parted at near-ties {parted}; launches {launches} (K1: "
          f"the prefill's chunks at a shard's one head of 128). Sampled "
          f"run ({s['rows']} rows, T 1.0, top-k {s['top_k']}, top-p "
          f"{s['top_p']}): {outside} draws outside the row's top "
          f"{s['top_k']}; launches {sampled}. Cache: each shard's entry "
          f"half the whole layer's {halves} ({shard_bytes} bytes a shard "
          f"of blk0_attn for {s['rows']} rows x {cap}); a decode step of "
          f"the {s['rows']} rows, ms (CUDA events, median of 20) {step_ms}"
          f"; the MoE LM's decode refused meshless and split "
          f"{moe_refusals}")
    if checked < len(prompts) * SPLIT_NEW // 2:
        raise PhaseFailed("29d", f"only {checked} greedy tokens held to the "
                                 "whole net")
    if launches["K1"] == 0 or launches["K2"]:
        raise PhaseFailed("29d", f"the split prefill launched {launches}")
    if sampled["K12"] != SPLIT_NEW or outside:
        raise PhaseFailed("29d", f"the sampled run: K12 {sampled['K12']} "
                                 f"(expected {SPLIT_NEW}), {outside} draws "
                                 f"outside the top {s['top_k']}")
    if not halves or moe_refusals != [True, True]:
        raise PhaseFailed("29d", f"cache halves {halves}, MoE refusals "
                                 f"{moe_refusals}")
    return {k: launches[k] + sampled[k] for k in launches}, step_ms


def solver_on_card(torch, mesh, card):
    """29e: phase 19d's LBFGS on LeNet-5 (5 iterations, a batch of 512,
    f32) under {"data": 1} (NCCL, world size 1; the solve over the
    mesh, optimize/solvers.MeshSpace) against the meshless solve, with
    cuDNN's deterministic convolutions: bit for bit. A second meshless
    solve gives the card's own spread, which a failure reports beside
    the difference."""
    from deeplearning4j_tpu_torch import models

    mnist = image_data("lenet5", 512, 1).next()
    nets, secs = {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arm in ("meshless", "data 1", "meshless again"):
            net = models.lenet5(dtype="float32", device="cuda")
            net.conf.conf.optimization_algo = "lbfgs"
            net.conf.conf.iterations = 5
            net.init(SEED)
            if arm == "data 1":
                net.set_mesh(mesh, axes={"data": "data"})
            t0 = time.perf_counter()
            net.fit(mnist)
            torch.cuda.synchronize()
            secs[arm] = time.perf_counter() - t0
            nets[arm] = net
    finally:
        torch.backends.cudnn.deterministic = prev
    dist = max_param_diff(torch, nets["meshless"], nets["data 1"])
    floor = max_param_diff(torch, nets["meshless"], nets["meshless again"])
    same = (dist == 0.0 and nets["meshless"].score_value
            == nets["data 1"].score_value)
    log29(card, f"29e: LeNet-5 by LBFGS (5 iterations, batch 512, f32, "
          f"deterministic cuDNN) under {{data 1}} (NCCL, world size 1): "
          f"params and score bit for bit with the meshless solve {same} "
          f"(largest difference {dist:.3e}; two meshless solves "
          f"{floor:.3e}); score {nets['data 1'].score_value:.6f}; seconds "
          f"{secs}")
    if not same:
        raise PhaseFailed("29e", f"the solve under a mesh is not the "
                                 f"meshless one: largest difference "
                                 f"{dist:.3e}, two meshless solves "
                                 f"{floor:.3e}")
    nets["data 1"].set_mesh(None)
    return secs


def compositions(torch, counters, transformer_lm, DataSet, card):
    """Phase 29: the rest of A7 — "seq" with "model" (29a) and with
    "pipe" (29b), resume_from into a target placement (29c), the split
    net's decode (29d) and the Solver under a mesh (29e) — at world size
    1 over NCCL and in one process. Returns the launches of its
    main-path runs and its numbers for the record."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1, "pipe": 1})
    rec = {}
    try:
        runs, rec["29a"] = seq_model_on_card(torch, counters,
                                             transformer_lm, DataSet, mesh,
                                             card)
        pipe, rec["29b"] = pipe_seq_on_card(torch, counters, transformer_lm,
                                            DataSet, mesh, card)
        resume, rec["29c"] = resume_on_card(torch, counters, transformer_lm,
                                            DataSet, mesh, card)
        rec["29e"] = solver_on_card(torch, mesh, card)
    finally:
        bootstrap.shutdown()
    decode, rec["29d"] = split_decode_on_card(torch, counters,
                                              transformer_lm, card)
    runs = runs + [pipe, resume, decode]
    launches = {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}
    log29(card, f"phase 29 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches, rec


def log30(card, msg):
    """A phase-30 line, every number in it beside the card's name and
    power limit."""
    log(f"{msg} [{card}]")


def lint_on_card(card):
    """30a: the port's AST and concurrency stages over the port, each a
    process of its own (neither imports torch); both must exit 0."""
    for stage in ("ast", "concurrency"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "port_tools" / "graftlint.py"),
             "--check", "--stage", stage], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        log30(card, f"30a graftlint --stage {stage}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.2f} s; "
              f"{last}")
        if proc.returncode:
            raise PhaseFailed(30, f"graftlint --stage {stage} exited "
                                  f"{proc.returncode}:\n{proc.stdout}"
                                  f"{proc.stderr}")


def op_audit_on_card(torch, card):
    """30b-c: every op-audit entry on the card against the "cuda"
    budget. Returns {entry: EntryRecord}, whose precision profiles 30e
    reads."""
    from deeplearning4j_tpu_torch.analysis import op_audit

    budget = op_audit.budget_for("cuda")
    known = op_audit.known_syncs("cuda")
    failures, records = [], {}
    for name in op_audit.entry_names():
        rec = records[name] = op_audit.record_entry(name, "cuda")
        findings = op_audit.check_entry(rec, budget.get(name),
                                        known.get(name, []))
        missing = [sorted(g) for g in op_audit.EXPECTED_KERNELS[name]
                   if not any(rec.launches.get(k) for k in g)]
        syncs = [f"{op} @ {frame}" for op, frame in rec.syncs]
        log30(card, f"30b {name}: {rec.ops} aten ops ({rec.backward_ops} in "
              f"the backward) + {sum(rec.launches.values())} launches = "
              f"{rec.count} (bound {budget.get(name)}); launches "
              f"{rec.launches}; syncs {syncs or 'none'}; float64 "
              f"{rec.f64 or 'none'}; {rec.ms:.3f} ms a call; top ops "
              f"{rec.top_ops[:4]}")
        for f in findings:
            failures.append(f.format())
        if missing:
            failures.append(f"{name}: none of {missing} launched "
                            f"(launches {rec.launches})")
        if rec.dense_routes:
            failures.append(f"{name}: {rec.dense_routes} attention calls "
                            "took the dense path")
    if failures:
        raise PhaseFailed(30, "op audit:\n" + "\n".join(failures))
    return records


def collectives_on_card(torch, card):
    """30d: the collective audit's five entries with CUDA tensors, each
    run as simulated ranks of torch's fake process group (NCCL holds one
    rank a card and this machine has one): every signature must equal
    the frozen one, with no C003 (rank 0 against rank 1; the reshard
    entry's sends and recvs matched over its 8 ranks). Then C13: a split
    mesh step's `shard_generator` of a CUDA generator makes no sync
    (recorded under the sync debug mode, J001's hook)."""
    from deeplearning4j_tpu_torch.analysis import collective_audit, op_audit
    from deeplearning4j_tpu_torch.ops.shard_scope import shard_generator

    t0 = time.perf_counter()
    findings, sigs = collective_audit.audit(device="cuda")
    for name, sig in sigs.items():
        log30(card, f"30d {name}: {len(sig)} c10d ops "
              f"(world {collective_audit.world_of(name)}): {sig}")
    log30(card, f"30d collective audit in {time.perf_counter() - t0:.2f} s")
    if findings:
        raise PhaseFailed(30, "collective audit on the card:\n"
                          + "\n".join(f.format() for f in findings))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = op_audit.record_call(
        "c13/shard_generator", lambda: shard_generator(gen, (1,), 2),
        "cuda")
    log30(card, f"30d C13: shard_generator(cuda generator, (1,), 2): "
          f"{rec.ops} aten ops, syncs {rec.syncs or 'none'}")
    if rec.syncs:
        raise PhaseFailed(30, f"shard_generator synced on the card: "
                              f"{rec.syncs}")


def precision_on_card(torch, records, card):
    """30e: the precision audit's 21 entries on the card against the
    "cuda" section of analysis/precision_budget.json, with no P finding:
    the op-audit entries' profiles from 30b's recorded calls (the LM
    steps at their full dims in bf16), the five extras recorded here
    (K12 and K13 launched, rank 0 against rank 1 for P005). The bf16 LM
    steps' product dtypes must be among the JAX package's for the step
    (its frozen precision_budget.json, read as data)."""
    from deeplearning4j_tpu_torch.analysis import op_audit, precision_audit

    t0 = time.perf_counter()
    findings, profiles = precision_audit.audit(device="cuda",
                                               records=records)
    failures = [f.format() for f in findings]
    with open(ROOT / "deeplearning4j_tpu" / "analysis"
              / "precision_budget.json") as fh:
        jax = json.load(fh)["entries"]
    for name, prof in profiles.items():
        log30(card, f"30e {name}: products {prof['dots']}; reductions "
              f"{sum(prof['reductions'].values())}; converts "
              f"{sum(prof['converts'].values())}; collectives "
              f"{prof['collectives']}; q8 {prof['q8']}; launches "
              f"{prof['launches']}")
        missing = [sorted(g) for g in op_audit.EXPECTED_KERNELS[name]
                   if not any(prof["launches"].get(k) for k in g)]
        if missing:
            failures.append(f"{name}: none of {missing} launched "
                            f"(launches {prof['launches']})")
        if name.startswith("lm_step/") and \
                not set(prof["dots"]) <= set(jax[name]["dots"]):
            failures.append(f"{name}: products {sorted(prof['dots'])} "
                            f"outside JAX's {sorted(jax[name]['dots'])}")
    log30(card, f"30e precision audit: {len(profiles)} entries, "
          f"{len(findings)} findings, in {time.perf_counter() - t0:.2f} s")
    if failures:
        raise PhaseFailed(30, "precision audit on the card:\n"
                          + "\n".join(failures))


def graftlint_on_card(torch, counters, card):
    """Phase 30: the port's graftlint — the AST and concurrency stages as
    processes (30a), the op audit of every entry on the card (30b-c),
    the collective audit under the simulated group with C13's check
    (30d) and the precision audit (30e). Returns the launches of its
    main-path run (30b-e, counted from 0)."""
    t0 = time.perf_counter()
    lint_on_card(card)
    counters.reset()
    records = op_audit_on_card(torch, card)
    collectives_on_card(torch, card)
    precision_on_card(torch, records, card)
    launches = counters.read()
    log30(card, f"phase 30 in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    return launches


# 31a: the serving flagship (f32, 29d's net) served in lockstep over a
# one-rank "model" group: 29d's greedy prompts, and one sampled request
# whose SPLIT_NEW tokens are each one K12 draw
LOCKSTEP_SAMPLED = dict(temperature=1.0, top_k=8, top_p=0.9)


def log31(card, msg):
    """A phase-31 or -32 line, every number in it beside the card's name
    and power limit."""
    log(f"{msg} [{card}]")


def lockstep_on_card(torch, counters, transformer_lm, card):
    """31a: GenerationEngine over the serving flagship (f32, f32 cache)
    placed with a "model" role over a one-rank NCCL group, in lockstep
    (serving/lockstep.py: every step broadcast as a plan first): 29d's
    greedy prompts, each token the whole net's full-forward argmax
    (`greedy_oracle`), and one sampled request (top-k 8, top-p 0.9) of
    exactly SPLIT_NEW K12 launches, each token among the 8 most likely of
    the whole net's distribution at its position; the prefill launches
    K1; the worker
    stepped a plan for each prefill chunk and decode step and retired at
    the stop plan. The prefill chunks of T >= 512 launch K1 (the cache
    prefill runs the flat kernel, as 29d's). Returns (launches, the numbers of the SERVE artifact,
    the record)."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    whole = transformer_lm(**LM, dtype="float32", device="cuda").init(SEED)
    net = transformer_lm(**LM, dtype="float32", device="cuda").init(SEED)
    rng = torch.Generator().manual_seed(SEED + 29)
    prompts = [torch.randint(0, LM["vocab_size"], (n,), generator=rng)
               .numpy() for n in MLN_PROMPTS]
    try:
        net.set_mesh(make_mesh({"model": 1}), axes={"model": "model"})
        engine = GenerationEngine(
            net, BucketLattice((1,), seq_lens=(64, 512, 1024)), slots=4,
            max_new_tokens=SPLIT_NEW, page_size=16, prefill_chunk=1024)
        (worker,) = engine.fleet_workers()
        if not engine.leader or type(worker).__name__ != "LockstepWorker":
            raise PhaseFailed("31a", "the engine over a one-rank model "
                                     "group does not lead a lockstep worker")
        engine.warmup()
        torch.cuda.synchronize()
        counters.reset()
        engine.start()
        t0 = time.perf_counter()
        reqs = [engine.submit_generate(p, SPLIT_NEW) for p in prompts]
        sampled = engine.submit_generate(prompts[1], SPLIT_NEW,
                                         **LOCKSTEP_SAMPLED)
        for r in reqs + [sampled]:
            if not r.wait(600) or r.error is not None:
                raise PhaseFailed("31a", f"request {r.request_id}: "
                                         f"{r.error}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        engine.drain()
        plans, state = worker.plans, worker.lifecycle
        net.set_mesh(None)
    finally:
        bootstrap.shutdown()
    checked, parted = greedy_oracle("31a", whole, prompts, reqs)
    # each sampled token's rank in the whole net's distribution at its
    # position: top-k 8 keeps only the 8 most likely
    seq, ranks = list(prompts[1]), []
    for tok in sampled.emitted:
        probs = whole.output(np.asarray(seq)[None])[0, -1].float()
        ranks.append(int((probs > probs[tok]).sum()))
        seq.append(tok)
    # a plan a prefill chunk (each prompt fits one chunk of <= 1024) and
    # a decode step a token after each request's first, the steps shared
    # by the slots decoding together
    n_req = len(reqs) + 1
    tokens = sum(len(r.emitted) for r in reqs + [sampled])
    ttft = sorted(1e3 * (r.t_first_token - r.t_enqueue)
                  for r in reqs + [sampled])
    total = sorted(1e3 * (r.t_done - r.t_enqueue) for r in reqs + [sampled])
    in_vocab = all(0 <= t < LM["vocab_size"] for t in sampled.emitted)
    log31(card, f"31a: the serving flagship (f32) placed over a one-rank "
          f"\"model\" group (NCCL) served in lockstep: {len(reqs)} greedy "
          f"prompts of {list(MLN_PROMPTS)} and 1 sampled request "
          f"({LOCKSTEP_SAMPLED}), {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tokens/s); {checked} greedy tokens equal "
          f"the whole net's argmax, streams parted at near-ties {parted}; "
          f"{plans} plans broadcast, worker {state}; the sampled tokens' "
          f"ranks in the whole net's distribution {ranks}; launches "
          f"{launches}")
    if checked < len(reqs) * SPLIT_NEW // 2:
        raise PhaseFailed("31a", f"only {checked} greedy tokens held to the "
                                 "whole net's argmax")
    if (len(sampled.emitted) != SPLIT_NEW or not in_vocab
            or max(ranks) >= LOCKSTEP_SAMPLED["top_k"]):
        raise PhaseFailed("31a", f"the sampled request gave "
                                 f"{sampled.emitted}, of ranks {ranks} in "
                                 "the whole net's distribution")
    if launches["K12"] != SPLIT_NEW or not launches["K1"]:
        raise PhaseFailed("31a", f"expected K12 = {SPLIT_NEW} and K1 > 0, "
                                 f"got {launches}")
    if plans < n_req + SPLIT_NEW - 1 or state != "retired":
        raise PhaseFailed("31a", f"{plans} plans, worker {state}")
    serve = [
        {"metric": "lockstep_tokens_per_sec", "value": tokens / wall},
        {"metric": "lockstep_ttft_p50_ms", "value": ttft[len(ttft) // 2],
         "lower_is_better": True},
        {"metric": "lockstep_request_p50_ms", "value": total[len(total) // 2],
         "lower_is_better": True},
        {"metric": "lockstep_recompiles", "value": 0,
         "lower_is_better": True}]
    return launches, serve, dict(tokens=tokens, seconds=wall, plans=plans,
                                 checked=checked, parted=parted)


def benchdiff_on_card(serve, card):
    """31b: port_tools/benchdiff.py, a process of its own, over this
    run's SERVE artifact (31a's numbers, written by serving/replay.py
    `write_artifact`) against itself: exit 0 and no change; against a
    copy whose p50 latency doubled: exit 1, naming that row."""
    import tempfile

    from deeplearning4j_tpu_torch.serving.replay import write_artifact

    tool = str(ROOT / "port_tools" / "benchdiff.py")
    with tempfile.TemporaryDirectory() as d:
        art, slow = os.path.join(d, "SERVE.json"), os.path.join(d, "slow.json")
        write_artifact(art, serve)
        write_artifact(slow, [dict(line, value=2 * line["value"])
                              if line["metric"] == "lockstep_request_p50_ms"
                              else line for line in serve])
        runs = {}
        for name, other in (("self", art), ("p50 doubled", slow)):
            proc = subprocess.run([sys.executable, tool, art, other,
                                   "--json"], capture_output=True,
                                  text=True, timeout=120)
            runs[name] = (proc.returncode, json.loads(proc.stdout)
                          if proc.stdout.strip() else proc.stderr)
    log31(card, f"31b: port_tools/benchdiff.py over 31a's SERVE artifact "
          f"({len(serve)} rows): against itself exit {runs['self'][0]}, "
          f"against a copy with its p50 doubled exit "
          f"{runs['p50 doubled'][0]} naming "
          f"{[r['metric'] for r in runs['p50 doubled'][1]['regressions']]}")
    rc, res = runs["self"]
    if rc != 0 or res["regressions"] or res["changes"]:
        raise PhaseFailed("31b", f"self diff: exit {rc}, {res}")
    rc, res = runs["p50 doubled"]
    if rc != 1 or [r["metric"] for r in res["regressions"]] != [
            "lockstep_request_p50_ms"]:
        raise PhaseFailed("31b", f"doubled p50: exit {rc}, {res}")


def lockstep_and_benchdiff(torch, counters, transformer_lm, card):
    """Phase 31: a split net served over the ranks of a "model" group in
    lockstep (31a) and the port's benchdiff over this run's SERVE
    artifact (31b). Returns the launches of 31a's run."""
    t0 = time.perf_counter()
    launches, serve, _ = lockstep_on_card(torch, counters, transformer_lm,
                                          card)
    benchdiff_on_card(serve, card)
    log31(card, f"phase 31 in {time.perf_counter() - t0:.1f} s")
    return launches


# phase 32: the example twins (examples/torch/), each run as a process of
# its own on the card to its end. The kernels an example must launch
# follow from what its run asked of the wrappers' own envelopes
# (`record_envelopes`): a flash forward kernel where `supports_qkv`,
# `supports` or `supports_chunked` took an attention call or `ring_route`
# sent a ring to the kernel hops, and a flash backward kernel where that
# call ran under autograd; K8 (and K9 under autograd) where
# fused_softmax_xent.supports took an output head. An attention call
# sent to the dense path for its head dim (`DENSE_ROUTES`), or a ring to
# the einsum ring, fails the phase. The Word2Vec twin trains through
# the device pipeline, which runs no kernel in either package (K13 is the
# host path's).
EXAMPLES_DIR = ROOT / "examples" / "torch"
FLASH_FWD, FLASH_BWD = ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7")
# example processes at a time: each spends most of its seconds starting
# (torch, the CUDA context, the kernels' libraries) on the host's cores
EXAMPLE_WORKERS = 4


def record_envelopes(seen):
    """Wrap the envelopes the port's attention layers, ring and output
    head ask before they pick a route, where those callers look them up,
    so that each call adds to `seen` ({route: [calls taken, taken under
    autograd]}, and the head dims of rings sent to the einsum ring)."""
    import importlib

    import torch

    from deeplearning4j_tpu_torch.nn.layers import attention as att
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    # the package re-exports a function of the module's name
    ra = importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.ring_attention")

    def wrap(mod, name, route):
        fn = getattr(mod, name)

        def recorded(*args, **kw):
            answer = fn(*args, **kw)
            if route == "ring" and answer != "flash":
                Tl, D = args[:2]
                if Tl % 128 == 0:
                    seen["einsum_ring_head_dims"].add(int(D))
            elif answer:
                took = seen.setdefault(
                    "head" if route == "head" else "flash", [0, 0])
                took[0] += 1
                took[1] += torch.is_grad_enabled()
            return answer
        setattr(mod, name, recorded)

    seen["einsum_ring_head_dims"] = set()
    for mod, name, route in (
            (att, "flash_supports_qkv", "flash"),
            (att, "flash_supports", "flash"),
            (att, "flash_supports_chunked", "flash"),
            (fa, "supports", "flash"),  # nn/decode.py's prefill
            (ra, "ring_route", "ring"),
            (fsx, "supports", "head")):
        wrap(mod, name, route)


def example_worker(script, out):
    """`--example-worker SCRIPT OUT`: run one example twin as `__main__`
    in this process, with no arguments (so on the card), then write its
    exit code, seconds, launches by kernel, what it asked of the
    envelopes (`record_envelopes`) and its dense attention routes to
    OUT. The launch tables start at 0 with the process."""
    import runpy

    from deeplearning4j_tpu_torch.ops import launch_counts
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    seen = {}
    record_envelopes(seen)
    sys.argv = [script]
    t0 = time.perf_counter()
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (1 if e.code else 0)
    seen["einsum_ring_head_dims"] = sorted(seen["einsum_ring_head_dims"])
    Path(out).write_text(json.dumps({
        "rc": code, "seconds": time.perf_counter() - t0,
        "launches": {k: n for k, n in launch_counts().items() if n},
        "envelopes": seen, "dense": fa.DENSE_ROUTES["head_dim"]}))
    return code


# the sequence-parallel twin's ring hop: batch 4 x 4 heads of 16, one
# causal block of 256, f32 (the head dim only the f32 kernels take)
RING_D16 = dict(BH=16, T=256, D=16)


def check_head_dim16(torch, card):
    """K1 and K4 at RING_D16 on the card, through `_flash_fwd` and
    `_flash_bwd_impl` with an lse cotangent (the ring's hops), against
    `_flash_fwd_reference` and `_flash_bwd_reference` on the same inputs:
    o and lse within TOL["float32"], each gradient within
    REL_TOL["float32"] of its largest entry."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 32)
    BH, T, D = RING_D16["BH"], RING_D16["T"], RING_D16["D"]
    q, k, v, do = (torch.randn(BH, T, D, generator=gen).to(dev)
                   for _ in range(4))
    dlse = torch.randn(BH, T, generator=gen).to(dev)
    scale = D ** -0.5
    o, lse = fa._flash_fwd(q, k, v, None, scale, True)
    ro, rlse = fa._flash_fwd_reference(q, k, v, None, scale, True)
    grads = fa._flash_bwd_impl(q, k, v, ro, rlse, do, None, scale, True,
                               dlse)
    refs = fa._flash_bwd_reference(q, k, v, ro, rlse, do, None, scale, True,
                                   dlse)
    torch.cuda.synchronize()
    err_o = float((o - ro).abs().max())
    err_l = float((lse - rlse).abs().max())
    err_g = [float((g - r).abs().max() / r.abs().max())
             for g, r in zip(grads, refs)]
    tol = TOL["float32"]
    log31(card, f"32: K1 and K4 at head dim 16 (f32, BH={BH}, T={T}, "
          f"causal, dlse) against their plain versions: o {err_o:.2e}, "
          f"lse {err_l:.2e} (limits {tol['o']}, {tol['lse']}); dq, dk, dv "
          f"{', '.join(f'{e:.2e}' for e in err_g)} of their largest entry "
          f"(limit {REL_TOL['float32']})")
    if (err_o > tol["o"] or err_l > tol["lse"]
            or max(err_g) > REL_TOL["float32"]):
        raise PhaseFailed("32", "the f32 kernels at head dim 16 disagree "
                                "with their plain versions")


def examples_on_card(torch, card):
    """Phase 32: each example twin of examples/torch/ as a process of its
    own (`--example-worker`), EXAMPLE_WORKERS at a time on the one card,
    to its end, writing its files into a temporary directory. Fails if
    one exits non-zero, sends attention to the dense path, or launches
    none of the kernels that its calls the envelopes took need (see
    above). Logs each one's seconds and launches by kernel. Returns the
    launches summed."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    check_head_dim16(torch, card)
    names = sorted(p.stem for p in EXAMPLES_DIR.glob("*.py"))
    total = {}
    with tempfile.TemporaryDirectory() as d:
        def run(name):
            out = os.path.join(d, f"{name}.json")
            started = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--example-worker", str(EXAMPLES_DIR / f"{name}.py"), out],
                capture_output=True, text=True, timeout=600, cwd=d,
                env=dict(os.environ, TMPDIR=d))
            return proc, out, time.perf_counter() - started

        with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
            runs = dict(zip(names, pool.map(run, names)))
        for name in names:
            proc, out, wall = runs[name]
            if proc.returncode or not os.path.exists(out):
                log(proc.stdout[-3000:] + proc.stderr[-3000:])
                raise PhaseFailed("32", f"{name} exited {proc.returncode}")
            res = json.loads(Path(out).read_text())
            got, env = res["launches"], res["envelopes"]
            flash, head = env.get("flash", [0, 0]), env.get("head", [0, 0])
            want = ([FLASH_FWD] * bool(flash[0]) + [FLASH_BWD] * bool(flash[1])
                    + [("K8",)] * bool(head[0]) + [("K9",)] * bool(head[1]))
            missing = [g for g in want if not any(got.get(k) for k in g)]
            log31(card, f"32: examples/torch/{name}.py: exit {res['rc']}, "
                  f"{res['seconds']:.2f} s in the script ({wall:.2f} s with "
                  f"the process; {EXAMPLE_WORKERS} at a time), launches "
                  f"{got}; envelopes took flash {flash} and head {head} "
                  f"calls [all, under autograd]; dense routes "
                  f"{res['dense']}; rings on the einsum ring for want of a "
                  f"kernel at head dim {env['einsum_ring_head_dims']}; "
                  f"last line: "
                  f"{proc.stdout.strip().splitlines()[-1][:160]!r}")
            if res["dense"] or env["einsum_ring_head_dims"] or missing:
                raise PhaseFailed("32", f"{name}: dense routes "
                                        f"{res['dense']}, einsum rings at "
                                        f"head dim "
                                        f"{env['einsum_ring_head_dims']}, "
                                        f"launched none of {missing}")
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
    log31(card, f"phase 32 in {time.perf_counter() - t0:.1f} s; launches "
          f"{total}")
    return total


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


# the worker roles phase 24 re-invokes this file in, and their argument
# counts
ROLES = {"--ab": 1, "--ab-turn": 1, "--elastic-worker": 2,
         "--average-worker": 6, "--build-worker": 1, "--phase": 1,
         "--example-worker": 2}


def only_phase(torch, phase):
    """`chip_smoke.py --phase 25` (or 26-32): the kernels built,
    then that phase alone (a quick check of one phase; the full run is
    the contract). Phase 26 alone trains phase 20a's host-path Word2Vec
    first and reads its flagship step's telemetry at /timeline; phase
    27 alone writes phase 25a's CSV itself and runs the tools over its
    own logs only (phases 18c and 24a leave none)."""
    if phase not in ("25", "26", "27", "28", "29", "30", "31", "32"):
        print(f"chip_smoke: --phase takes 25 to 32, not {phase}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_neg_softmax as fns
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = nvidia_smi("name,power.limit")
    log(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {name_power}")
    t0 = time.perf_counter()
    log(f"build: {sorted(cuda_build.build())} in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = Counters(fa, fsx, fns, fln, fsm)
    if phase == "25":
        telemetry_and_cli(torch, counters, transformer_lm, DataSet,
                          name_power)
    elif phase == "27":
        from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

        tracing_and_resume(torch, counters, transformer_lm, DataSet,
                           Word2Vec, name_power)
    elif phase == "28":
        datasets_and_utils(torch, counters, transformer_lm, DataSet,
                           name_power)
    elif phase == "29":
        compositions(torch, counters, transformer_lm, DataSet, name_power)
    elif phase == "30":
        graftlint_on_card(torch, counters, name_power)
    elif phase == "31":
        lockstep_and_benchdiff(torch, counters, transformer_lm, name_power)
    elif phase == "32":
        examples_on_card(torch, name_power)
    else:
        from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

        tuning_clustering_ui(torch, counters, Word2Vec, transformer_lm,
                             DataSet, name_power)
    return 0


def main() -> int:
    started = time.time()
    import torch

    args = sys.argv[1:]
    if args and (args[0] not in ROLES or len(args) != 1 + ROLES[args[0]]):
        print("usage: chip_smoke.py [--ab OTHER_CHECKOUT]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if args and args[0] in ("--elastic-worker", "--average-worker",
                            "--build-worker", "--example-worker"):
        sys.path.insert(0, str(ROOT))
        if args[0] == "--example-worker":
            return example_worker(*args[1:])
        if args[0] == "--elastic-worker":
            return elastic_worker(*args[1:], started)
        if args[0] == "--build-worker":
            return build_worker(args[1])
        *rest, crash = args[1:]
        return average_worker(*rest, int(crash))
    if args and args[0] == "--phase":
        return only_phase(torch, args[1])
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
    # 26b's Barnes-Hut t-SNE of 20a's vectors (minutes of Python on the
    # host) runs in its own process beside phases 21-26
    barnes_hut = start_barnes_hut(torch, Word2Vec)
    par_launches = train_parallel(torch, counters, fa, transformer_lm,
                                  DataSet, name_power)
    place_launches, shard_times = train_placements(
        torch, counters, fa, transformer_lm, DataSet, name_power)
    pipe_launches, micro_times = train_pipeline(
        torch, counters, fa, fsx, transformer_lm, DataSet, name_power)
    # phase 24's workers share the card with this process
    torch.cuda.empty_cache()
    fleet_launches, k13_embed = train_fleet(
        torch, counters, fns, transformer_lm, DataSet, name_power)
    tel_launches = telemetry_and_cli(torch, counters, transformer_lm,
                                     DataSet, name_power)
    tune_launches, tuned = tuning_clustering_ui(
        torch, counters, Word2Vec, transformer_lm, DataSet, name_power,
        barnes_hut)
    trace_launches = tracing_and_resume(torch, counters, transformer_lm,
                                        DataSet, Word2Vec, name_power)
    data_launches = datasets_and_utils(torch, counters, transformer_lm,
                                       DataSet, name_power)
    compose_launches, _ = compositions(torch, counters, transformer_lm,
                                       DataSet, name_power)
    lint_launches = graftlint_on_card(torch, counters, name_power)
    lockstep_launches = lockstep_and_benchdiff(torch, counters,
                                               transformer_lm, name_power)
    example_launches = examples_on_card(torch, name_power)
    log(f"chip_smoke: phases 1-32 in {time.perf_counter() - started:.1f} s")
    # every path above runs head dims the kernels take: none may have
    # been sent to the dense attention for its head dim
    log(f"dense routes for a head dim no kernel takes: {fa.DENSE_ROUTES}")
    if fa.DENSE_ROUTES["head_dim"]:
        raise PhaseFailed("3-24", f"{fa.DENSE_ROUTES['head_dim']} attention "
                              "calls on the card took the dense path")

    # one entry per TPU kernel, timed at the heaviest shape a path gives
    # it (K12 at the flagship's slots x vocab with both filters, the
    # replay's microbench block beside it); launches summed over the
    # paths' runs (serving, its f32 oracle, the HTTP arms, flagship
    # training, the three bench modes, the other training paths,
    # Word2Vec, the engine, the speculative replay, the predict path's
    # flagship windows, the MoE LM's training runs, phase 20's
    # host-path Word2Vec, phase 21's data-parallel, ring, sequence-
    # parallel and pipelined-fit runs, phase 22's graph, MultiLayer-
    # Network decode, placed-net and split-block runs, phase 23's
    # pipelined, restored and searched-placement runs, and phase 24's
    # elastic fleet's workers, the averaging workers and its in-process
    # twin, the sharded engine's arms and the data meshes, phase 25's
    # CLI server and cost book, phase 26's flagship step under the
    # tuning table and the UI's steps, phase 27's profiled steps, resumed
    # zips and raw-string Word2Vec, phase 28's flagship fed through the
    # async and multiple-epoch iterators and its plain twin, phase 29's
    # seq x model steps and split ring, pipe x seq arms, resumed steps
    # and split net's served and sampled tokens, phase 30's op-audit
    # entries, each warmed, recorded and timed), each counted
    # from 0 just before it and read just after (in the process that
    # ran it). K1-K7 carry their dropout
    # arm at the same shape, K4/K5 their dlse arm's device time, K1/K5
    # the chunked check's largest error.
    runs = (serve_launches, oracle_launches, http_launches, train_launches,
            mode_launches, other_launches, w2v_launches, engine_launches,
            replay_launches, predict_launches, nn_launches, emb_launches,
            par_launches, place_launches, pipe_launches, fleet_launches,
            tel_launches, tune_launches, trace_launches, data_launches,
            compose_launches, lint_launches, lockstep_launches,
            example_launches)
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
        if kern in shard_times:
            # a model shard's shape (22d), beside the row's
            kernels[-1]["model_shard"] = shard_times[kern]
        if kern in micro_times:
            # a pipeline microbatch's shape (23a), beside the row's
            kernels[-1]["microbatch"] = micro_times[kern]
        if kern == "K13":
            # bench mode `embed`'s engine shape (24c), beside the row's
            kernels[-1]["embed"] = k13_embed
        if kern == "K10":
            kernels[-1]["host_us"] = rec["host_us"]
        if kern in tuned:
            # the tuning table's launch params at the main path's shapes
            # against the heuristic's, timed in turns (26a)
            kernels[-1]["tuned"] = tuned[kern]
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
