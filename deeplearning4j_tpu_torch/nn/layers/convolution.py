"""Convolutional layer implementations: Conv2D, Subsampling (pooling),
BatchNormalization, LocalResponseNormalization (JAX counterpart
deeplearning4j_tpu/nn/layers/convolution.py; reference
layers/convolution/ConvolutionLayer.java, subsampling/SubsamplingLayer.java,
normalization/BatchNormalization.java, LocalResponseNormalization.java).

Layout: activations are NHWC and conv weights HWIO at every boundary, as
in the JAX package, so params and activations compare directly. Inside a
layer, `x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is an NCHW
view in channels-last memory, which cuDNN and PyTorch's pooling take as
it is; the NCHW result permuted back is again a contiguous NHWC tensor.

The JAX package computes these layers with XLA's own operations
(`lax.conv_general_dilated`, `lax.reduce_window`), not with Pallas
kernels, so the port computes them with PyTorch's: `F.conv2d` (cuDNN on
the card), `F.max_pool2d` / `F.avg_pool2d`, and plain tensor code for
batch and local response normalization. Backward is autograd, with a
`torch.autograd.Function` where the JAX package has a custom VJP (the
tiled max-pool's equality mask).

Padding follows XLA's rules, not PyTorch's: SAME pads each spatial axis
by total = max((out - 1) * stride + k_eff - in, 0), the low side by
total // 2 and the high side by the rest, which at stride 2 is
asymmetric (3x3 on 32x32: (0, 1)); `_pads` computes it and `_pad` applies
what `F.conv2d`'s symmetric padding cannot express.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.enums import ConvolutionMode, PoolingType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    ConvolutionLayer,
    LocalResponseNormalization,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.shard_scope import data_shard, global_sum


def _pads(conf, h, w, kernel, dilation=(1, 1)):
    """((top, bottom), (left, right)) padding of an NHWC input of h x w
    for `conf`'s convolution mode, stride and padding (XLA's SAME rule,
    none for VALID, the explicit padding on both sides for STRICT)."""
    mode = conf.convolution_mode
    if mode in (ConvolutionMode.SAME, "same"):
        out = []
        for size, k, s, d in zip((h, w), kernel, conf.stride, dilation):
            k_eff = (int(k) - 1) * int(d) + 1
            s = int(s)
            total = max((-(-size // s) - 1) * s + k_eff - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if mode in (ConvolutionMode.VALID, "valid"):
        return (0, 0), (0, 0)
    p = conf.padding
    return (int(p[0]), int(p[0])), (int(p[1]), int(p[1]))


def _nchw(x):
    """NCHW view of an NHWC tensor (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    """NHWC view of an NCHW result."""
    return y.permute(0, 2, 3, 1)


def _pad(xc, pads, value=0.0):
    """(the NCHW view padded where `pads` is asymmetric, the symmetric
    (h, w) padding left for the operation itself)."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return xc, (t, l)
    return F.pad(xc, (l, r, t, b), value=value), (0, 0)


@register_impl(ConvolutionLayer)
class ConvolutionImpl(LayerImpl):
    """y = act(conv(x, W) + b), x NHWC, W [kh, kw, n_in, n_out] (HWIO)."""

    def init(self, conf, gen, dtype):
        kh, kw = (int(k) for k in conf.kernel_size)
        shape = (kh, kw, conf.n_in, conf.n_out)
        W = init_weights(gen, shape, conf.weight_init, conf.dist, dtype,
                         fan_in=conf.n_in * kh * kw,
                         fan_out=conf.n_out * kh * kw)
        b = torch.full((conf.n_out,), float(conf.bias_init or 0.0),
                       dtype=dtype)
        return {"W": W, "b": b}, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        W = params["W"]
        dilation = tuple(int(d) for d in conf.dilation)
        pads = _pads(conf, x.shape[1], x.shape[2], W.shape[:2], dilation)
        xc, padding = _pad(_nchw(x), pads)
        z = F.conv2d(xc, W.permute(3, 2, 0, 1), params["b"],
                     stride=tuple(int(s) for s in conf.stride),
                     padding=padding, dilation=dilation)
        return get_activation(conf.activation)(_nhwc(z)), state


class _MaxPoolTiled(torch.autograd.Function):
    """Non-overlapping max pool (stride == kernel, dims divisible) of an
    NHWC x, with the JAX package's custom VJP: dx = (x == y↑) · dy↑ /
    ties, ↑ the kh x kw tile upsample and `ties` the count of maxima in
    each window, so the gradient is split over tied maxima where
    `F.max_pool2d`'s own backward credits one of them."""

    @staticmethod
    def forward(ctx, x, kh, kw):
        y = _nhwc(F.max_pool2d(_nchw(x), (kh, kw), (kh, kw)))
        ctx.save_for_backward(x, y)
        ctx.tile = kh, kw
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        kh, kw = ctx.tile
        B, Ho, Wo, C = y.shape
        x6 = x.reshape(B, Ho, kh, Wo, kw, C)
        eq = (x6 == y[:, :, None, :, None, :]).to(dy.dtype)
        ties = eq.sum(dim=(2, 4))
        dx = eq * (dy / ties)[:, :, None, :, None, :]
        return dx.reshape(x.shape), None, None


def _window_sum(xc, kernel, stride, pads):
    """Sum over each pooling window of an NCHW view, zero padding."""
    xp, padding = _pad(xc, pads)
    return F.avg_pool2d(xp, kernel, stride, padding,
                        count_include_pad=True, divisor_override=1)


@register_impl(SubsamplingLayer)
class SubsamplingImpl(LayerImpl):
    """Max, average (over the unpadded elements of a window), sum,
    p-norm or no pooling of an NHWC x."""

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        kernel = tuple(int(k) for k in conf.kernel_size)
        stride = tuple(int(s) for s in conf.stride)
        pads = _pads(conf, x.shape[1], x.shape[2], kernel)
        pt = conf.pooling_type
        if pt in (PoolingType.NONE, "none"):
            return x, state
        xc = _nchw(x)
        if pt in (PoolingType.MAX, "max"):
            if (pads == ((0, 0), (0, 0)) and stride == kernel
                    and x.shape[1] % kernel[0] == 0
                    and x.shape[2] % kernel[1] == 0):
                # tiled: SAME and VALID coincide, and the equality-mask
                # backward replaces the general one
                return _MaxPoolTiled.apply(x, *kernel), state
            (t, b), (l, r) = pads
            if t or b or l or r:  # padding takes -inf, as XLA's does
                xc = F.pad(xc, (l, r, t, b), value=-math.inf)
            return _nhwc(F.max_pool2d(xc, kernel, stride)), state
        if pt in (PoolingType.SUM, "sum"):
            return _nhwc(_window_sum(xc, kernel, stride, pads)), state
        if pt in (PoolingType.AVG, "avg"):
            s = _window_sum(xc, kernel, stride, pads)
            if pads != ((0, 0), (0, 0)):
                ones = torch.ones((1, 1) + tuple(x.shape[1:3]),
                                  dtype=x.dtype, device=x.device)
                return _nhwc(s / _window_sum(ones, kernel, stride, pads)), \
                    state
            return _nhwc(s / (kernel[0] * kernel[1])), state
        if pt in (PoolingType.PNORM, "pnorm"):
            p = float(conf.pnorm)
            s = _window_sum(xc.abs() ** p, kernel, stride, pads)
            return _nhwc(s ** (1.0 / p)), state
        raise ValueError(f"pooling type {pt}")


def _global_moments(x, xf, axes):
    """Batch mean and biased variance over the GLOBAL batch of a
    monolithic data-parallel step (ops/shard_scope.py), by the formula
    the one-device forward uses for x's dtype, the sums all-reduced
    differentiably over the data group."""
    n = x.numel() // x.shape[-1] * data_shard().size
    if x.dtype == torch.bfloat16:
        sums = global_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]))
        mean = sums[0] / n
        return mean, (sums[1] / n - mean * mean).clamp_min(0.0)
    mean = global_sum(xf.sum(axes)) / n
    return mean, global_sum(((xf - mean) ** 2).sum(axes)) / n


@register_impl(BatchNormalization)
class BatchNormImpl(LayerImpl):
    """Train: normalize by the batch's statistics and move the running
    ones in `state`, decay·old + (1 − decay)·batch with the biased
    variance, in f32, detached from autograd (gradients flow through the
    batch mean and variance); eval: normalize by the running ones. Per
    channel for NHWC input, per feature for 2-D."""

    def init(self, conf, gen, dtype):
        n = conf.n_out or conf.n_in
        params = {}
        if not conf.lock_gamma_beta:
            params["gamma"] = torch.full((n,), float(conf.gamma), dtype=dtype)
            params["beta"] = torch.full((n,), float(conf.beta), dtype=dtype)
        state = {"mean": torch.zeros(n), "var": torch.ones(n),
                 "count": torch.zeros(())}
        return params, state

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        axes = tuple(range(x.ndim - 1))  # all but channel/feature
        if train:
            # at least f32 for the statistics, never narrower than x
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if data_shard() is not None:
                mean, var = _global_moments(x, xf, axes)
            elif x.dtype == torch.bfloat16:
                # one pass, sum and sum of squares, as the JAX package
                # takes bf16 statistics
                n = x.numel() // x.shape[-1]
                mean = xf.sum(axes) / n
                var = ((xf * xf).sum(axes) / n - mean * mean).clamp_min(0.0)
            else:
                mean = xf.mean(axes)
                var = xf.var(axes, correction=0)
            decay = conf.decay
            new_state = {
                "mean": (decay * state["mean"]
                         + (1 - decay) * mean.detach()).to(
                             state["mean"].dtype),
                "var": (decay * state["var"]
                        + (1 - decay) * var.detach()).to(state["var"].dtype),
                "count": state["count"] + 1,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xn = (x - mean.to(x.dtype)) * torch.rsqrt(var + conf.eps).to(x.dtype)
        if "gamma" in params:
            xn = xn * params["gamma"] + params["beta"]
        return get_activation(conf.activation or "identity")(xn), new_state


@register_impl(LocalResponseNormalization)
class LRNImpl(LayerImpl):
    """Cross-channel LRN on NHWC: y = x / (k + alpha · Σ x²)^beta, the sum
    over a window of n channels padded by (n // 2, n − 1 − n // 2)."""

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        n = int(conf.n)
        half = n // 2
        C = x.shape[-1]
        sq = F.pad(x * x, (half, n - 1 - half))
        ssum = sq[..., 0:C]
        for j in range(1, n):
            ssum = ssum + sq[..., j:j + C]
        return x / (conf.k + conf.alpha * ssum) ** conf.beta, state
