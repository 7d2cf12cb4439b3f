"""Nested parameter dicts (the counterpart of the JAX package's pytree
calls on its param trees: `jax.tree.leaves`, `jax.tree.map`,
`ravel_pytree`).

A network's params, layer state and gradients are dicts keyed by layer
name whose values are dicts of tensors, or dicts of such dicts: the
bidirectional LSTM keeps `{"fwd": {...}, "bwd": {...}}` and a nested
network (`NetworkLayer`) its inner net's whole tree. A leaf is a tensor;
its path is the tuple of keys down to it. Leaves come in the JAX
package's flattening order: keys sorted at every level.
"""

from __future__ import annotations

import numpy as np
import torch


def leaves(tree, prefix=()) -> list:
    """[(path, tensor)] of every tensor of `tree`, keys sorted at every
    level (jax.tree.leaves order for dicts)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves(tree[k], prefix + (k,)))
    return out


def tree_map(fn, tree):
    """The same nest of dicts with `fn` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def put(tree, path, value) -> None:
    """Set the leaf at `path`, making the dicts above it as needed."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_leaves(pairs) -> dict:
    """A nest of dicts from [(path, tensor)]."""
    out = {}
    for path, t in pairs:
        put(out, path, t)
    return out


def num_params(params) -> int:
    return sum(t.numel() for _, t in leaves(params))


def flatten(params) -> torch.Tensor:
    """Every leaf raveled and concatenated in `leaves` order, on the
    params' device: bf16 widens to f32 (exactly), the rest keep their
    dtype under torch's promotion (the JAX package's `ravel_pytree`)."""
    ts = [t.detach().reshape(-1) for _, t in leaves(params)]
    if not ts:
        return torch.zeros(0)
    ts = [t.float() if t.dtype == torch.bfloat16 else t for t in ts]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in ts])


def unflatten(flat, like):
    """The nest of `like` (empty dicts kept) with its leaves cut from
    `flat` in `leaves` order, each in its own dtype and on its own
    device; differentiable in `flat`."""
    off = 0

    def cut(t):
        nonlocal off
        if isinstance(t, torch.Tensor):
            n = t.numel()
            off += n
            return flat[off - n:off].reshape(t.shape).to(device=t.device,
                                                          dtype=t.dtype)
        return {k: cut(t[k]) for k in sorted(t)}

    return cut(like)


def params_flat(params) -> np.ndarray:
    """`flatten` as a numpy array on the host."""
    return flatten(params).cpu().numpy()


def set_params_flat(params, flat):
    """`unflatten` of a numpy or tensor vector into `params`' layout."""
    return unflatten(torch.as_tensor(np.asarray(flat)), params)


def clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)
