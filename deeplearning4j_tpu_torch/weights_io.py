"""Parameters across the two packages.

Both packages keep a layer's weights as named tensors in the same layout
(`W` is [n_in, n_out] and layers compute `x @ W`; `Wqkv` is
[n_in, 3n] with q|k|v column blocks), so a JAX net's params become the
port's by a move of dtype and device alone, and both then compute the
same function. The same holds for an embedding lookup table's `syn0`,
`syn1` and `syn1neg` rows [V, D]. The two packages initialise with
different random bits (jax.random against a torch.Generator), so a
comparison copies the JAX tables or params in first.

An optimizer's state crosses too: `opt_state_from_jax` rebuilds the
port's from the leaves a JAX zip's `updater.npz` holds.
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


def canonical_from_jax(jax_net) -> dict:
    """A JAX net's canonical params as a nest of numpy arrays: the
    per-layer tree, which a pipelined JAX net keeps restacked ({pre,
    stages, post}) and hands back through `_canonical_params()`."""
    if getattr(jax_net, "_pp_plan", None) is not None:
        params = jax_net._canonical_params()
    else:
        params = jax_net.params
    return _nest_map(np.asarray, params)


def params_from_jax_net(jax_net, device) -> dict:
    """`params_from_jax` of a JAX net's canonical params, pipelined or
    not (`canonical_from_jax`)."""
    return params_from_jax(canonical_from_jax(jax_net), device)


def params_to_numpy(params) -> dict:
    """The port's params (a nest of dicts of tensors, or a network, whose
    canonical params — whole under a mesh placement, every pipeline
    stage's included — are taken) -> the
    same nest of numpy arrays on the host, for comparing with a JAX net's
    `np.asarray` params: copies, which the next in-place update leaves as
    they are. bfloat16 widens to float32 (exactly): numpy has no
    bfloat16."""
    if hasattr(params, "canonical_params"):
        params = params.canonical_params()

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


# ------------------------------------------------- the updater's state

class UpdaterMappingError(ValueError):
    """A JAX `updater.npz` whose leaves match none of the layouts the
    net's configuration gives (optax's per-leaf trees, the flat view)."""


def _optax_plan(net, flat: bool):
    """[(label, field, path, shape)] of the leaves optax's state holds
    for the net's configuration, in optax's flatten order: `path` is the
    param a moment leaf belongs to (None for a counter, or under the flat
    view for the whole vector). The JAX package takes per-layer overrides
    through optax.multi_transform over the labels (sorted), each masked
    to its layers' params; without an override, one rule."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.updater import OPTAX_LEAVES

    tx = net.tx
    leaves = tree.leaves(net.params)
    total = sum(t.numel() for _, t in leaves)
    plan = []
    for label in sorted(tx.rules):
        mine = [(p, t) for p, t in leaves if tx._label(p[0]) == label]
        for field in OPTAX_LEAVES[tx.rules[label].kind]:
            if field == "count":
                plan.append((label, field, None, ()))
            elif flat:
                plan.append((label, field, None, (total,)))
            else:
                plan.extend((label, field, p, tuple(t.shape))
                            for p, t in mine)
    return plan


def opt_state_from_jax(net, leaves: list, flat_layout: int = 2,
                       iteration: int = 0) -> dict:
    """The optimizer state of the port's `net` from the leaves of a JAX
    zip's `updater.npz` (numpy arrays, arr_0 .. arr_n), rebuilt from the
    configuration alone: optax's leaf order of each rule
    (nn/updater.py `OPTAX_LEAVES`), under optax.multi_transform where a
    layer overrides the updater or learning rate, in the per-leaf tree
    layout or the JAX package's flat view (one f32 vector a moment; the
    layout is read off the leaves' shapes, a `flat_layout` 1 vector
    reordered first). Counters come from the zip's; a rule without one
    (AdaDelta) takes `iteration`. Leaves that match no layout raise
    UpdaterMappingError naming their count and shapes."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.nn.updater import (
        FLAT_OK,
        Optimizer,
        unflatten_flat,
        upgrade_flat_layout,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import _tensor

    got = [tuple(np.shape(a)) for a in leaves]

    def fail(why):
        raise UpdaterMappingError(
            f"updater.npz holds {len(leaves)} leaves of shapes {got}: "
            f"{why}")

    if not isinstance(net.tx, Optimizer):
        fail(f"the net's optimizer is a custom {type(net.tx).__name__}")
    layouts = [False]
    if len(net.tx.rules) == 1 and net.tx.rules["__default__"].kind in FLAT_OK:
        layouts.append(True)
    for flat in layouts:
        plan = _optax_plan(net, flat)
        if [entry[3] for entry in plan] == got:
            break
    else:
        kinds = {label: str(rule.kind) for label, rule
                 in sorted(net.tx.rules.items())}
        fail(f"no layout of the configuration's rules {kinds} (optax's "
             f"per-leaf trees or the flat view) has these shapes")
    state = net.tx.init(net.params)
    shapes = [tuple(t.shape) for _, t in tree.leaves(net.params)]
    paths = [p for p, _ in tree.leaves(net.params)]
    seen_count = set()
    for (label, field, path, _), arr in zip(plan, leaves):
        st = state.get(label)
        if st is None:
            continue  # a label of no params: optax keeps its counters only
        if field == "count":
            if label not in seen_count:  # the rule's own counter first
                st["count"] = int(np.asarray(arr).reshape(()))
                seen_count.add(label)
            continue
        keys = [tuple(k) for k in st["keys"]]
        if flat:
            vec = np.asarray(arr, np.float32)
            if flat_layout < 2:
                vec = upgrade_flat_layout(vec, shapes)
            pieces = zip(paths, unflatten_flat(vec, shapes))
        else:
            pieces = [(path, arr)]
        for p, a in pieces:
            slot = st[field][keys.index(tuple(p))]
            slot.copy_(_tensor(np.ascontiguousarray(a), slot))
    for label, st in state.items():
        if label not in seen_count:
            st["count"] = int(iteration)
    return state
