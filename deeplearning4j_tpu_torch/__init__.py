"""PyTorch + CUDA port of deeplearning4j_tpu, slice 1: serving the
Transformer LM through `serving.engine.GenerationEngine` on an NVIDIA
H100.

The package mirrors the JAX package's module layout and public names
(`nn/conf`, `nn/layers`, `nn/graph.py`, `nn/decode.py`, `ops/`,
`models/`, `serving/`), so each counterpart is found by path. It
imports `torch` and never `jax`, nor anything of `deeplearning4j_tpu`.

Entry points place tensors on CUDA unless the caller passes
`device="cpu"`. On CPU tensors the attention wrappers in
`ops/flash_attention.py` compute their plain PyTorch version; on CUDA
tensors they launch the hand-written kernel in `csrc/flash_fwd.cu`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point places tensors on: CUDA unless the
    caller names another. No fallback: asking for CUDA on a machine
    without it fails at the first allocation."""
    return torch.device("cuda" if device is None else device)
