"""Loss functions — ND4J `LossFunctions` equivalents (JAX counterpart
deeplearning4j_tpu/ops/losses.py).

Names follow the reference's LossFunction enum (MSE, XENT, MCXENT,
NEGATIVELOGLIKELIHOOD, EXPLL, RMSE_XENT, SQUARED_LOSS,
RECONSTRUCTION_CROSSENTROPY, CUSTOM). Every loss is a function of
(labels, activated output), differentiable by autograd; the losses that
fuse with their canonical activation (softmax + MCXENT, sigmoid + XENT)
take the preactivation `logits` for the numerically stable form.

All losses take an optional broadcastable `mask` (the reference's
per-timestep label masking).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


class LossFunction:
    """Enum-style constants matching the reference's LossFunctions.LossFunction."""

    MSE = "mse"
    L1 = "l1"
    XENT = "xent"  # binary cross entropy
    MCXENT = "mcxent"  # multi-class cross entropy
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    EXPLL = "expll"  # exponential log likelihood (poisson)
    RMSE_XENT = "rmse_xent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    COSINE_PROXIMITY = "cosine_proximity"
    POISSON = "poisson"
    MEAN_ABSOLUTE_ERROR = "mae"


KNOWN_LOSSES = frozenset(
    v for k, v in vars(LossFunction).items() if not k.startswith("_")
)


def validate_loss(name) -> str:
    """Eagerly validate a loss name (init-time check, for a named error
    before the first step)."""
    if callable(name):
        return name
    low = str(name).lower()
    if low not in KNOWN_LOSSES:
        raise ValueError(
            f"Unknown loss function '{name}'. Known: {sorted(KNOWN_LOSSES)}")
    return low


def _is_index(labels) -> bool:
    return not (labels.is_floating_point() or labels.is_complex()
                or labels.dtype == torch.bool)


def _align_mask(per, mask):
    """Broadcast a loss mask to the per-position loss's shape (rank-pad
    trailing dims, then broadcast), in the loss dtype."""
    mask = torch.as_tensor(mask, device=per.device)
    if mask.ndim == per.ndim:
        mask = mask.broadcast_to(per.shape)
    while mask.ndim < per.ndim:
        mask = mask[..., None]
    return mask.broadcast_to(per.shape).to(per.dtype)


def _masked_mean(per_example, mask):
    """Mean over examples; if mask given, weight rows and renormalize."""
    if mask is None:
        return per_example.mean()
    m = _align_mask(per_example, mask)
    return (per_example * m).sum() / m.sum().clamp_min(1.0)


def _masked_per_example(per, mask):
    """Collapse per-position losses to one score PER EXAMPLE [B]
    (mask-weighted mean over any time/position dims) — the
    scoreExamples reduction."""
    if mask is None:
        if per.ndim <= 1:
            return per
        return per.reshape(per.shape[0], -1).mean(-1)
    m = _align_mask(per, mask)
    num = (per * m).reshape(per.shape[0], -1).sum(-1)
    den = m.reshape(per.shape[0], -1).sum(-1)
    return num / den.clamp_min(1.0)


def _finish(per, mask, reduce):
    return _masked_mean(per, mask) if reduce else _masked_per_example(per, mask)


def _bce(labels, o):
    return -(labels * torch.log(o) + (1 - labels) * torch.log1p(-o))


def compute_loss(name, labels, output, mask=None, *, logits=None,
                 reduce=True):
    """A scalar loss (or per-example losses when ``reduce=False``).

    `output` is the activated output; for softmax/sigmoid output layers
    pass `logits` (the preactivation) as well so the fused stable form
    is used. A callable is the CUSTOM-loss path (reference
    LossFunction.CUSTOM): fn(labels, output) -> per-example loss,
    masked-meaned here.
    """
    if callable(name):
        return _finish(name(labels, output), mask, reduce)
    name = name.lower()
    if name in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        if logits is not None:
            logp = torch.log_softmax(logits, dim=-1)
        else:
            logp = torch.log(output.clamp(_EPS, 1.0))
        if labels.ndim == logp.ndim - 1 and _is_index(labels):
            # sparse integer class labels: a gather, not a one-hot
            # product; labels must be in [0, C) (mask ignored positions)
            per = -logp.gather(-1, labels.long()[..., None])[..., 0]
        else:
            per = -(labels * logp).sum(-1)
        return _finish(per, mask, reduce)
    if name == LossFunction.XENT:
        if logits is not None:
            per = (logits.clamp_min(0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs()))).sum(-1)
        else:
            per = _bce(labels, output.clamp(_EPS, 1.0 - _EPS)).sum(-1)
        return _finish(per, mask, reduce)
    if name in (LossFunction.MSE, LossFunction.SQUARED_LOSS):
        per = ((labels - output) ** 2).sum(-1)
        if name == LossFunction.MSE:
            per = per / output.shape[-1]
        return _finish(per, mask, reduce)
    if name in (LossFunction.L1, LossFunction.MEAN_ABSOLUTE_ERROR):
        per = (labels - output).abs().sum(-1)
        if name == LossFunction.MEAN_ABSOLUTE_ERROR:
            per = per / output.shape[-1]
        return _finish(per, mask, reduce)
    if name == LossFunction.RMSE_XENT:
        xent = _bce(labels, output.clamp(_EPS, 1.0 - _EPS))
        per = torch.sqrt((xent ** 2).sum(-1) + _EPS)
        return _finish(per, mask, reduce)
    if name == LossFunction.RECONSTRUCTION_CROSSENTROPY:
        per = _bce(labels, output.clamp(_EPS, 1.0 - _EPS)).sum(-1)
        return _finish(per, mask, reduce)
    if name in (LossFunction.EXPLL, LossFunction.POISSON):
        o = output.clamp_min(_EPS)
        per = (o - labels * torch.log(o)).sum(-1)
        return _finish(per, mask, reduce)
    if name == LossFunction.HINGE:
        per = (1.0 - labels * output).clamp_min(0.0).sum(-1)
        return _finish(per, mask, reduce)
    if name == LossFunction.SQUARED_HINGE:
        per = ((1.0 - labels * output).clamp_min(0.0) ** 2).sum(-1)
        return _finish(per, mask, reduce)
    if name == LossFunction.KL_DIVERGENCE:
        o = output.clamp(_EPS, 1.0)
        t = labels.clamp(_EPS, 1.0)
        per = (t * (torch.log(t) - torch.log(o))).sum(-1)
        return _finish(per, mask, reduce)
    if name == LossFunction.COSINE_PROXIMITY:
        ln = labels / (labels.norm(dim=-1, keepdim=True) + _EPS)
        on = output / (output.norm(dim=-1, keepdim=True) + _EPS)
        per = -(ln * on).sum(-1)
        return _finish(per, mask, reduce)
    raise ValueError(f"Unknown loss function '{name}'")


def loss_fn(name):
    """Return a closure computing the named loss."""

    def fn(labels, output, mask=None, logits=None):
        return compute_loss(name, labels, output, mask, logits=logits)

    return fn
