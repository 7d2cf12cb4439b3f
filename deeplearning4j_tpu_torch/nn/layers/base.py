"""Layer implementation protocol + registry (JAX counterpart
deeplearning4j_tpu/nn/layers/base.py).

An impl provides, for one layer kind:

- init(conf, gen, dtype)  -> (params dict, state dict)
- apply(conf, params, state, x, *, train=False, generator=None,
        mask=None)         -> (y, new_state)

Params are plain dicts of tensors keyed as in the JAX package
(`W`, `b`, `Wqkv`, ...), so a JAX param pytree copies across by name
(weights_io.py). Backward is autograd through `apply`, with
`torch.autograd.Function`s where the JAX package has custom VJPs (the
flash attention and fused loss kernels). `generator` is the
`torch.Generator` that takes the place of the JAX package's `rng` key:
dropout draws from it when `train` is set.

Dropout/DropConnect (reference util/Dropout.java, inverted dropout on
the layer input) are implemented here once.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.tree import leaves

_IMPL_REGISTRY: dict[type, "LayerImpl"] = {}

# State-channel key for per-batch auxiliary losses: a layer may stash a
# scalar under this key in its returned state during training; the
# container adds every such entry to the training loss and the key never
# persists into the stored state.
AUX_LOSS_KEY = "__aux_loss__"


def pop_aux_losses(state):
    """Sum and REMOVE the `AUX_LOSS_KEY` scalars of a state dict.
    Returns (total, cleaned_state)."""
    total = 0.0
    cleaned = {}
    for name, s in state.items():
        if isinstance(s, dict) and AUX_LOSS_KEY in s:
            total = total + s[AUX_LOSS_KEY]
            cleaned[name] = {k: v for k, v in s.items() if k != AUX_LOSS_KEY}
        else:
            cleaned[name] = s
    return total, cleaned


def register_impl(conf_cls):
    def wrap(impl_cls):
        _IMPL_REGISTRY[conf_cls] = impl_cls()
        return impl_cls

    return wrap


def get_impl(conf) -> "LayerImpl":
    for cls in type(conf).__mro__:
        impl = _IMPL_REGISTRY.get(cls)
        if impl is not None:
            return impl
    raise ValueError(f"No layer implementation registered for {type(conf).__name__}")


class LayerImpl:
    """Stateless singleton holding init/apply for one layer kind."""

    def init(self, conf, gen, dtype):
        return {}, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        raise NotImplementedError

    def pretrain_loss(self, conf, params, x, generator):
        """The layerwise pretraining loss (AutoEncoder, RBM)."""
        raise NotImplementedError(f"{type(self).__name__} is not a pretrain "
                                  "layer")


def _keep_mask(shape, keep, generator, device):
    return torch.bernoulli(
        torch.full(shape, keep, dtype=torch.float32, device=device),
        generator=generator).bool()


def apply_dropout(x, rate, generator, *, train):
    """Inverted dropout on the layer input (reference
    util/Dropout.applyDropout:31)."""
    if not train or rate in (None, 0.0) or generator is None:
        return x
    keep = 1.0 - rate
    m = _keep_mask(x.shape, keep, generator, x.device)
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def apply_dropconnect(w, rate, generator, *, train):
    """DropConnect: drop weights instead of activations (reference
    Dropout.java)."""
    return apply_dropout(w, rate, generator, train=train)


def l1_l2_penalty(conf, params):
    """Per-layer L1/L2 regularization on weight params only (reference
    BaseLayer calcL1/calcL2 — biases excluded). A nested layer's leaves
    are named by their own key."""
    pen = 0.0
    l1 = getattr(conf, "l1", 0.0) or 0.0
    l2 = getattr(conf, "l2", 0.0) or 0.0
    if l1 == 0.0 and l2 == 0.0:
        return 0.0
    for path, p in leaves(params):
        name = path[-1]
        if name.startswith("b") or name in ("gamma", "beta", "mean", "var"):
            continue
        if l1:
            pen = pen + l1 * p.abs().sum()
        if l2:
            pen = pen + 0.5 * l2 * (p * p).sum()
    return pen
