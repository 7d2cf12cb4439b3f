"""Parameters across the two packages.

Both packages keep a layer's weights as named tensors in the same layout
(`W` is [n_in, n_out] and layers compute `x @ W`; `Wqkv` is
[n_in, 3n] with q|k|v column blocks), so a JAX net's params become the
port's by a move of dtype and device alone, and both then compute the
same function.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(np_params: dict, device) -> dict:
    """`{layer: {"W", "b", "Wqkv", "bqkv", "Wo", "bo", "gamma", "beta",
    "pe"}}` of numpy arrays (a JAX net's params after `np.asarray`) ->
    the same dict of tensors on `device`, dtypes kept."""
    return {layer: {name: _tensor(a, device) for name, a in p.items()}
            for layer, p in np_params.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's {layer: {name: tensor}} params -> the same dict of
    numpy arrays on the host, for comparing with a JAX net's
    `np.asarray` params. bfloat16 widens to float32 (exactly): numpy has
    no bfloat16."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {layer: {name: arr(t) for name, t in p.items()}
            for layer, p in params.items()}
