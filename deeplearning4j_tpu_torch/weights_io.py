"""Parameters across the two packages.

Both packages keep a layer's weights as named tensors in the same layout
(`W` is [n_in, n_out] and layers compute `x @ W`; `Wqkv` is
[n_in, 3n] with q|k|v column blocks), so a JAX net's params become the
port's by a move of dtype and device alone, and both then compute the
same function. The same holds for an embedding lookup table's `syn0`,
`syn1` and `syn1neg` rows [V, D]. The two packages initialise with
different random bits (jax.random against a torch.Generator), so a
comparison copies the JAX tables or params in first.
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


def _nest_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _nest_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: dict, device) -> dict:
    """`{layer: {"W", "b", "Wqkv", ...}}` of numpy arrays (a JAX net's
    params after `np.asarray`; a convolution's W is HWIO in both
    packages), nested as deep as the layer keeps them (the bidirectional
    LSTM's `{"fwd": {...}, "bwd": {...}}`, a `NetworkLayer`'s inner
    net's tree) -> the same nest of tensors on `device`, dtypes kept."""
    return _nest_map(lambda a: _tensor(a, device), np_params)


def params_to_numpy(params: dict) -> dict:
    """The port's params (a nest of dicts of tensors) -> the same nest
    of numpy arrays on the host, for comparing with a JAX net's
    `np.asarray` params: copies, which the next in-place update leaves as
    they are. bfloat16 widens to float32 (exactly): numpy has no
    bfloat16."""
    def arr(t):
        t = t.detach().cpu()
        return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                        .numpy())

    return _nest_map(arr, params)


def state_from_jax(np_state: dict, device) -> dict:
    """A JAX net's layer state after `np.asarray` (batch norm's running
    `mean`, `var` [C] and `count` [], f32; `{}` for a layer without
    state) -> the same dict of tensors on `device`. Convolution params
    need no such step: both packages keep `W` as [kh, kw, n_in, n_out]
    (HWIO) and `b` as [n_out], so `params_from_jax` moves them as they
    are."""
    return params_from_jax(np_state, device)


def state_to_numpy(state: dict) -> dict:
    """The port's layer state -> the same dict of numpy arrays on the
    host, for comparing with a JAX net's `np.asarray` state."""
    return params_to_numpy(state)


TABLES = ("syn0", "syn1", "syn1neg")


def tables_from_jax(arrays: dict, device) -> dict:
    """`{"syn0", "syn1", "syn1neg"}` numpy arrays (a JAX lookup table's
    rows after `np.asarray`) -> the same dict of tensors on `device`.
    Assign them to an `InMemoryLookupTable`, a `ShardedEmbeddingEngine`
    or an `EngineLookupView` of the port by attribute."""
    return {name: _tensor(a, device) for name, a in arrays.items()}


def tables_to_numpy(table) -> dict:
    """A port lookup table's (or engine's, or view's) `syn0`, `syn1`,
    `syn1neg` -> numpy arrays on the host."""
    return {name: getattr(table, name).detach().to("cpu", copy=True).numpy()
            for name in TABLES}


# ---------------------------------------------- the embeddings slice

def ann_index_from_jax(index, device, recorder=None):
    """A JAX `DeviceANNIndex` -> the port's, over the same centroids,
    partition vectors and partition ids (copied to `device`), so both
    search the same partitions."""
    from deeplearning4j_tpu_torch.embedding.ann import DeviceANNIndex

    return DeviceANNIndex(_tensor(index.centroids, device),
                          _tensor(index.part_vecs, device),
                          _tensor(index.part_ids, device), recorder=recorder)


def glove_state_from_jax(arrays: dict, device) -> dict:
    """GloVe's `W`, `Wc` [V, D], biases `b`, `bc` [V] and AdaGrad
    accumulators `hW`, `hWc`, `hb`, `hbc` as numpy arrays -> tensors on
    `device`, for `Glove.fit(..., init_state=...)` of the port."""
    from deeplearning4j_tpu_torch.nlp.glove import GLOVE_STATE

    return {name: _tensor(arrays[name], device) for name in GLOVE_STATE}


def glove_state_to_numpy(state: dict) -> dict:
    """The port's GloVe state (`Glove.state` after a fit) -> numpy."""
    from deeplearning4j_tpu_torch.nlp.glove import GLOVE_STATE

    return {name: state[name].detach().to("cpu", copy=True).numpy()
            for name in GLOVE_STATE}


def paragraph_vectors_from_jax(jax_model, model) -> None:
    """Carry a trained JAX ParagraphVectors into the port's `model`,
    built over the same vocabulary (`build_vocab` on the same corpus):
    the tables with the label rows [V, V + n_labels) of syn0, and the
    labels with their row indices."""
    model.labels = list(jax_model.labels)
    model._label_index = dict(jax_model._label_index)
    model._max_labels_per_doc = jax_model._max_labels_per_doc
    model._init_from_vocab()
    arrays = {name: np.asarray(getattr(jax_model.lookup_table, name))
              for name in TABLES}
    for name, t in tables_from_jax(arrays, model.device).items():
        setattr(model.lookup_table, name, t)
