"""PyTorch + CUDA port of deeplearning4j_tpu on an NVIDIA H100: serving
the Transformer LM through `serving.engine.GenerationEngine` (greedy,
speculative, over an f32 or int8 paged cache, behind the HTTP
`serving.server.ServingServer`, with the telemetry recorder and the
traffic replays); training it through
`ComputationGraph.fit` / `fit_scanned` (nn/graph.py, nn/training.py,
nn/updater.py, ops/losses.py, datasets/); training Word2Vec through
`SequenceVectors` and the embedding engine (nlp/, embedding/, data/);
and training the image models, LeNet-5 through `MultiLayerNetwork`
(nn/multilayer.py) and VGG-16 and ResNet-20 through `ComputationGraph`,
with the CNN layers (nn/layers/convolution.py), `evaluate` (eval/) and
the MNIST and CIFAR-10 iterators; and serving any single-input net
through `serving.engine.InferenceEngine` (the dynamic batcher,
`POST /predict`) with the fleet's hot-swap from the port's checkpoints
(`util/checkpoint.py`), replica self-healing and autoscaling
(`serving/fleet.py`); and the rest of embeddings and NLP: the
whole-epoch Word2Vec pipeline (`nlp/device_pipeline.py`), the ANN index
and the `/embed` + `/search` serving engine (`embedding/ann.py`,
`embedding/serving.py`), DeepWalk and `graph/`, ParagraphVectors, GloVe
and the host-side NLP modules.

The package mirrors the JAX package's module layout and public names
(`nn/conf`, `nn/layers`, `nn/graph.py`, `nn/multilayer.py`,
`nn/decode.py`, `ops/`, `models/`, `serving/`, `telemetry/`,
`datasets/`, `eval/`, `nlp/`, `embedding/`, `graph/`, `data/`, `util/`,
`distributed/`), so
each counterpart is found by path. It imports `torch` and never `jax`,
nor anything of `deeplearning4j_tpu`.

Entry points place tensors on CUDA unless the caller passes
`device="cpu"`. The hand-written kernels, built by nvcc for sm_90a at
first use (ops/cuda_build.py), take the place of the JAX package's
Pallas kernels (K1-K13 in PERF.md):

* csrc/flash_fwd.cu — flash attention forward, flat and packed (K1-K3);
* csrc/flash_bwd.cu — flash attention backward, flat and packed (K4-K7);
* csrc/softmax_xent.cu — the fused softmax cross-entropy head, forward
  and backward (K8, K9);
* csrc/layernorm.cu — fused LayerNorm forward and backward (K10, K11),
  an op on no path (ops/fused_layernorm.py);
* csrc/sampling.cu — fused temperature / top-k / top-p sampling (K12);
* csrc/neg_softmax.cu — the skip-gram negative-sampling scores (K13).

On CPU tensors their wrappers (ops/flash_attention.py,
ops/fused_softmax_xent.py, ops/fused_layernorm.py,
ops/fused_sampling.py, ops/fused_neg_softmax.py) compute the plain
PyTorch versions; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point places tensors on: CUDA unless the
    caller names another. No fallback: asking for CUDA on a machine
    without it fails at the first allocation."""
    return torch.device("cuda" if device is None else device)
