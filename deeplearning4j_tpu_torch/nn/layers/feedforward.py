"""Feed-forward layer implementations: Dense, Output/RnnOutput and
Embedding (JAX counterpart deeplearning4j_tpu/nn/layers/feedforward.py;
reference DenseLayer.java via BaseLayer.java preOutput:361,
EmbeddingLayer.java).

Weights keep the JAX package's [n_in, n_out] layout (`x @ W`). The
output head's forward is dense + activation (softmax over the vocab);
the fused Pallas loss head (`_use_fused_head`) is training-only and
comes with the training slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    DenseLayer,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import get_activation


def _dense_init(conf, gen, dtype):
    W = init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init,
                     conf.dist, dtype)
    b = torch.full((conf.n_out,), float(conf.bias_init or 0.0), dtype=dtype)
    return {"W": W, "b": b}, {}


def _dense_forward(conf, params, x):
    z = x @ params["W"] + params["b"]
    return get_activation(conf.activation)(z)


@register_impl(DenseLayer)
class DenseImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        return _dense_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, mask=None):
        return _dense_forward(conf, params, x), state


@register_impl(BaseOutputLayer)
class OutputImpl(LayerImpl):
    """Output layer forward: dense + activation."""

    def init(self, conf, gen, dtype):
        return _dense_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, mask=None):
        return _dense_forward(conf, params, x), state


@register_impl(EmbeddingLayer)
class EmbeddingImpl(LayerImpl):
    """Index lookup (reference EmbeddingLayer.java selects rows of W).
    Input: int [batch] or [batch, 1] — a [B, 1] index column is squeezed
    to [B] exactly as the JAX package does, and nn/decode.py `_as_seq`
    re-expands the result; the two must change together."""

    def init(self, conf, gen, dtype):
        params, _ = _dense_init(conf, gen, dtype)
        if not conf.has_bias:
            params.pop("b")
        return params, {}

    def apply(self, conf, params, state, x, *, mask=None):
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx]
        if "b" in params:
            z = z + params["b"]
        return get_activation(conf.activation)(z), state
