"""Feed-forward layer implementations: Dense, Output/RnnOutput,
Activation, Dropout and Embedding (JAX counterpart
deeplearning4j_tpu/nn/layers/feedforward.py;
reference DenseLayer.java via BaseLayer.java preOutput:361,
EmbeddingLayer.java).

Weights keep the JAX package's [n_in, n_out] layout (`x @ W`). The
output layer's training loss takes the fused softmax cross-entropy head
(ops/fused_softmax_xent.py, the K8/K9 kernels) for large-vocab sparse
labels on CUDA tensors (`_use_fused_head`), and `compute_loss` on the
preactivation otherwise.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BaseOutputLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropconnect,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.losses import (
    LossFunction,
    _finish,
    _is_index,
    compute_loss,
)


def _dense_init(conf, gen, dtype):
    W = init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init,
                     conf.dist, dtype)
    b = torch.full((conf.n_out,), float(conf.bias_init or 0.0), dtype=dtype)
    return {"W": W, "b": b}, {}


def _dense_forward(conf, params, x, train=False, generator=None):
    """(activation, preactivation) of a dense layer, with dropout on the
    input or DropConnect on W while training."""
    W = params["W"]
    if getattr(conf, "drop_connect", False):
        W = apply_dropconnect(W, conf.dropout, generator, train=train)
    elif conf.dropout:
        x = apply_dropout(x, conf.dropout, generator, train=train)
    z = x @ W + params["b"]
    return get_activation(conf.activation)(z), z


@register_impl(DenseLayer)
class DenseImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        return _dense_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        y, _ = _dense_forward(conf, params, x, train, generator)
        return y, state


@register_impl(BaseOutputLayer)
class OutputImpl(LayerImpl):
    """Output layer: dense + activation; the container computes the loss
    on the preactivation for numeric stability (reference
    BaseOutputLayer computes the softmax/loss delta jointly)."""

    def init(self, conf, gen, dtype):
        return _dense_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        y, _ = _dense_forward(conf, params, x, train, generator)
        return y, state

    def preactivation(self, conf, params, x, *, train=False, generator=None):
        _, z = _dense_forward(conf, params, x, train, generator)
        return z

    def loss(self, conf, params, x, labels, *, train=False, generator=None,
             mask=None, per_example=False):
        """Scalar training loss; ``per_example=True`` returns one score
        per example [B] instead (reference ScoreExamplesFunction)."""
        act = (conf.activation or "").lower()
        if self._use_fused_head(conf, params, x, labels, act):
            if conf.dropout:
                x = apply_dropout(x, conf.dropout, generator, train=train)
            per = fsx.softmax_xent_head(x, params["W"], params["b"], labels)
            return _finish(per, mask, not per_example)
        y, z = _dense_forward(conf, params, x, train, generator)
        logits = z if act in ("softmax", "sigmoid") else None
        return compute_loss(conf.loss_function, labels, y, mask,
                            logits=logits, reduce=not per_example)

    @staticmethod
    def _use_fused_head(conf, params, x, labels, act):
        """Large-vocab sparse-label softmax/mcxent on CUDA tensors: the
        fused head (ops/fused_softmax_xent.py) instead of materializing
        [N, V] logits. The JAX package's gate is `backend == "tpu"`;
        here it is the tensor's device."""
        if fsx.FORCE_FUSED is False:
            return False
        loss_name = conf.loss_function
        if callable(loss_name):
            return False
        if act != "softmax" or str(loss_name).lower() not in (
                LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
            return False
        if not (labels.ndim == x.ndim - 1 and _is_index(labels)):
            return False
        if getattr(conf, "drop_connect", False):
            return False
        n = math.prod(x.shape[:-1])
        if not fsx.supports(n, x.shape[-1], params["W"].shape[-1]):
            return False
        return bool(fsx.FORCE_FUSED) or x.device.type == "cuda"


@register_impl(ActivationLayer)
class ActivationImpl(LayerImpl):
    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        return get_activation(conf.activation)(x), state


@register_impl(DropoutLayer)
class DropoutImpl(LayerImpl):
    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        return apply_dropout(x, conf.dropout, generator, train=train), state


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

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx]
        if "b" in params:
            z = z + params["b"]
        return get_activation(conf.activation)(z), state
