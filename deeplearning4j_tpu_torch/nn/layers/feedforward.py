"""Feed-forward layer implementations: Dense, Output/RnnOutput,
Activation, Dropout, Embedding and the pretrain layers AutoEncoder and
RBM (JAX counterpart deeplearning4j_tpu/nn/layers/feedforward.py;
reference DenseLayer.java via BaseLayer.java preOutput:361,
EmbeddingLayer.java, AutoEncoder.java, RBM.java).

Weights keep the JAX package's [n_in, n_out] layout (`x @ W`). The
output layer's training loss takes the fused softmax cross-entropy head
(ops/fused_softmax_xent.py, the K8/K9 kernels) for large-vocab sparse
labels on CUDA tensors (`_use_fused_head`), and `compute_loss` on the
preactivation otherwise.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import HiddenUnit, VisibleUnit
from deeplearning4j_tpu_torch.nn.conf.layers import (
    RBM,
    ActivationLayer,
    AutoEncoder,
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


def _pretrain_init(conf, gen, dtype):
    params, _ = _dense_init(conf, gen, dtype)
    params["vb"] = torch.full((conf.n_in,), float(conf.visible_bias_init),
                              dtype=dtype)
    return params, {}


def _bernoulli(p, generator):
    return torch.bernoulli(p.float(), generator=generator).to(p.dtype)


@register_impl(AutoEncoder)
class AutoEncoderImpl(LayerImpl):
    """Denoising autoencoder with tied decode weights W^T (reference
    AutoEncoder.java): pretraining minimizes the reconstruction loss of
    the corrupted input; as a layer of the stack it encodes."""

    def init(self, conf, gen, dtype):
        return _pretrain_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        return self.encode(conf, params, x), state

    def encode(self, conf, params, x):
        return get_activation(conf.activation)(x @ params["W"] + params["b"])

    def decode(self, conf, params, h):
        return get_activation(conf.activation)(
            h @ params["W"].T + params["vb"])

    def pretrain_loss(self, conf, params, x, generator):
        """Reconstruction loss of x from its corruption (each input zeroed
        with probability `corruption_level`, drawn from `generator`),
        plus the KL sparsity penalty when `sparsity` is set."""
        corrupted = x
        if conf.corruption_level and generator is not None:
            keep = torch.bernoulli(
                torch.full(x.shape, 1.0 - conf.corruption_level,
                           device=x.device), generator=generator).bool()
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        h = self.encode(conf, params, corrupted)
        loss = compute_loss(conf.loss_function, x,
                            self.decode(conf, params, h))
        if conf.sparsity:
            rho_hat = h.mean(0).clamp(1e-6, 1 - 1e-6)
            rho = conf.sparsity
            loss = loss + (rho * torch.log(rho / rho_hat)
                           + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat))
                           ).sum()
        return loss


@register_impl(RBM)
class RBMImpl(LayerImpl):
    """RBM trained by CD-k (reference RBM.java contrastiveDivergence:101,
    Gibbs chain gibbhVh:149-151, unit types :197-205). The CD-k update is
    the gradient of a surrogate loss, the mean free-energy difference
    between the data and the chain's negative sample, the sample held
    constant (detached). As a layer of the stack it gives the hidden
    mean."""

    def init(self, conf, gen, dtype):
        return _pretrain_init(conf, gen, dtype)

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        return self._prop_up(conf, params, x), state

    def _prop_up(self, conf, params, v):
        z = v @ params["W"] + params["b"]
        hu = conf.hidden_unit
        if hu == HiddenUnit.BINARY:
            return torch.sigmoid(z)
        if hu == HiddenUnit.RECTIFIED:
            return torch.relu(z)
        if hu == HiddenUnit.GAUSSIAN:
            return z
        if hu == HiddenUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(f"hidden unit {hu}")

    def _prop_down(self, conf, params, h):
        z = h @ params["W"].T + params["vb"]
        vu = conf.visible_unit
        if vu == VisibleUnit.BINARY:
            return torch.sigmoid(z)
        if vu in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return z
        if vu == VisibleUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(f"visible unit {vu}")

    @staticmethod
    def _sample(unit, mean, generator):
        """A sample of binary (Bernoulli) or gaussian (unit variance)
        units; the others are mean-field."""
        if unit == "binary":
            return _bernoulli(mean, generator)
        if unit == "gaussian":
            return mean + torch.randn(mean.shape, generator=generator,
                                      device=mean.device, dtype=mean.dtype)
        return mean

    def negative_sample(self, conf, params, x, generator):
        """The end of the k-step Gibbs chain from the data x."""
        v = x
        for _ in range(max(1, conf.k)):
            h = self._sample(conf.hidden_unit,
                             self._prop_up(conf, params, v), generator)
            v = self._sample(conf.visible_unit,
                             self._prop_down(conf, params, h), generator)
        return v.detach()

    def free_energy(self, conf, params, v):
        """F(v) = -v.vb - sum softplus(vW + b) (binary hidden), plus
        |v|^2 / 2 for gaussian visible units."""
        z = v @ params["W"] + params["b"]
        fe = -(v @ params["vb"]) - torch.nn.functional.softplus(z).sum(-1)
        if conf.visible_unit == VisibleUnit.GAUSSIAN:
            fe = fe + 0.5 * (v * v).sum(-1)
        return fe

    def cd_loss(self, conf, params, x, v_neg):
        """The CD-k surrogate for a given negative sample: mean F(x) -
        F(v_neg); its gradient is the CD-k update."""
        return (self.free_energy(conf, params, x)
                - self.free_energy(conf, params, v_neg.detach())).mean()

    def pretrain_loss(self, conf, params, x, generator):
        return self.cd_loss(conf, params, x,
                            self.negative_sample(conf, params, x, generator))
