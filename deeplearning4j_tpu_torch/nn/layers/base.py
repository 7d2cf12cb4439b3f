"""Layer implementation protocol + registry (JAX counterpart
deeplearning4j_tpu/nn/layers/base.py).

An impl provides, for one layer kind:

- init(conf, gen, dtype)          -> (params dict, state dict)
- apply(conf, params, state, x, mask=None) -> (y, new_state)

Params are plain dicts of tensors keyed as in the JAX package
(`W`, `b`, `Wqkv`, ...), so a JAX param pytree copies across by name
(weights_io.py). This slice is inference only: `apply` is the
train=False forward, with no dropout and no rng. The training slice
adds both.
"""

from __future__ import annotations

_IMPL_REGISTRY: dict[type, "LayerImpl"] = {}


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

    def apply(self, conf, params, state, x, *, mask=None):
        raise NotImplementedError
