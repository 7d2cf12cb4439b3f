"""Tensor parallelism ("model") and the placement of split params (JAX
counterpart deeplearning4j_tpu/parallel/tensor_parallel.py).

The JAX package writes Megatron's split as placement rules — {param-name
regex: PartitionSpec} — puts each param on the mesh with its sharding
and lets GSPMD insert the collectives. The port keeps the rules and the
names (`TRANSFORMER_TP_RULES`, `MOE_EP_RULES`, `resolve_rules`; a spec
is a tuple of axis names and None, the PartitionSpec's entries) and runs
one process per device, so a placement does by hand what XLA did:

- `SplitPlan` resolves, for every param of a net, the mesh axis and the
  dim it is split on and checks that its layer has a split form and
  that the split divides; each rank keeps its slice of each split leaf
  in `net.params` (and of its optimizer state), cut by the resharding
  executor (reshard/executor.py `PortLayout`).
- Each split layer is registered with its collectives' transport
  (ops/shard_scope.py `ModelShard`, ops/shard_comm.py) and computes its
  share: attention over its heads, a column- or row-parallel dense
  layer, an embedding or LM head that gathers its slices, a MoE layer
  over its experts (nn/layers/*).
- The canonical params — whole leaves in the JAX layout, for
  `params_flat`, checkpoints and `weights_io` — are gathered by the
  resharding executor from the ranks' slices (reshard/executor.py, which
  reads this plan's `leaves` and `shapes`).

Where the port parts from the rules' plain reading:

- **The packed QKV projection.** `Wqkv` is [n_in, 3n], q | k | v. The
  rule splits its columns, and GSPMD can take a contiguous split because
  XLA reshards after the reshape into heads; the port's kernels read the
  packed projection as it is, so shard r holds the q, k and v columns of
  ITS heads (`qkv_columns`), and `bqkv` likewise.
- **Heads, hidden units or classes that do not divide.** GSPMD runs any
  split; the port keeps a layer whole where the split does not divide
  (an attention layer where the shard count does not divide its heads,
  a dense layer or a head where it does not divide the split dim): the
  layer then runs replicated on every shard, which is exact. An expert
  count that does not divide raises ValueError, as the JAX package's
  `expert_parallel_apply` does.
- **An axis of size 1** splits into one shard (the JAX package leaves
  such a leaf replicated): the layer runs its split form, its
  collectives over a group of one.
- **The LM head** is split on the vocab, and the fused softmax
  cross-entropy (K8/K9) needs the log-sum-exp over the whole row: the
  head gathers W and b over the shards and every shard computes the
  whole loss, whose gradient it slices back. A vocab-parallel
  cross-entropy is later work.
"""

from __future__ import annotations

import re

import torch

from deeplearning4j_tpu_torch.nn import tree

# {param-name regex -> spec} for the transformer_lm param tree, written
# against the ROLE name "model" (resolve_rules renames it). Column-
# parallel: the output dim split; row-parallel: the input dim split.
TRANSFORMER_TP_RULES = [
    (r".*_attn/Wqkv$", (None, "model")),   # column: heads split
    (r".*_attn/bqkv$", ("model",)),
    (r".*_attn/Wo$", ("model", None)),     # row: the contraction split
    (r".*_attn/bo$", ()),
    (r".*_ff1/W$", (None, "model")),       # column
    (r".*_ff1/b$", ("model",)),
    (r".*_ff2/W$", ("model", None)),       # row
    (r".*_ff2/b$", ()),
    (r"embed/W$", (None, "model")),        # the embedding split on d_model
    (r"out/W$", (None, "model")),          # the LM head split on the vocab
    (r"out/b$", ("model",)),
]

# Expert parallelism (role "expert"): the stacked expert tensors of
# nn/layers/moe.py split their leading expert dim; the router Wg stays
# whole.
MOE_EP_RULES = [
    (r".*/We1$", ("expert", None, None)),
    (r".*/be1$", ("expert", None)),
    (r".*/We2$", ("expert", None, None)),
    (r".*/be2$", ("expert", None)),
]

_ROLE_RULES = {"model": TRANSFORMER_TP_RULES, "expert": MOE_EP_RULES}


def _rename_spec(spec, mapping):
    return tuple(mapping.get(ax, ax) if isinstance(ax, str) else ax
                 for ax in spec)


def resolve_rules(axes: dict, custom_rules=None):
    """The active rule list for a role -> mesh-axis mapping (e.g.
    {"data": "data", "model": "mdl"}): each present role's rules, specs
    renamed to the mapped axis names; `custom_rules` (role-named) come
    first and win."""
    mapping = {role: ax for role, ax in axes.items() if isinstance(ax, str)}
    rules = [(pat, _rename_spec(spec, mapping))
             for pat, spec in (custom_rules or [])]
    for role in ("model", "expert"):
        if role in axes:
            rules.extend((pat, _rename_spec(spec, mapping))
                         for pat, spec in _ROLE_RULES[role])
    return rules


def spec_for(name: str, mesh, rules=None) -> tuple:
    """The spec of the first rule matching `name` ("layer/param"), or ()
    (whole) when none matches or one of its axes is not on the mesh."""
    rules = TRANSFORMER_TP_RULES if rules is None else rules
    for pat, spec in rules:
        if re.match(pat, name):
            if all(ax in mesh.shape for ax in spec if isinstance(ax, str)):
                return tuple(spec)
            break
    return ()


def _split_dim(spec):
    """(axis, dim) of a spec that splits one dim, None for a whole one."""
    dims = [(ax, d) for d, ax in enumerate(spec) if isinstance(ax, str)]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim; the port "
                         "splits a leaf on one")
    return dims[0] if dims else None


def qkv_columns(n: int, n_heads: int, size: int, index: int):
    """The columns of a packed [.., 3n] q | k | v projection that shard
    `index` of `size` holds: the q, k and v columns of its n_heads/size
    heads, in q | k | v order."""
    if n_heads % size:
        raise ValueError(f"{n_heads} heads do not split over {size} "
                         "shards")
    width = n // size
    lo = index * width
    return torch.cat([torch.arange(lo, lo + width) + part * n
                      for part in range(3)])


def shard_slice(t, dim: int, size: int, index: int, n_heads=None):
    """Shard `index` of `size` of `t` along `dim` (a packed QKV leaf by
    heads when `n_heads` is given), a tensor of its own."""
    if n_heads is not None:
        cols = qkv_columns(t.shape[dim] // 3, n_heads, size, index)
        return t.index_select(dim, cols.to(t.device))
    width = t.shape[dim] // size
    return t.narrow(dim, index * width, width).clone()


def join_shards(parts, dim: int, n_heads=None):
    """The whole leaf from its shards in order (`shard_slice`'s
    inverse)."""
    whole = torch.cat(parts, dim=dim)
    if n_heads is None:
        return whole
    n = whole.shape[dim] // 3
    perm = torch.cat([qkv_columns(n, n_heads, len(parts), r)
                      for r in range(len(parts))]).to(whole.device)
    return torch.empty_like(whole).index_copy_(dim, perm, whole)


def sharding_for(name: str, t, mesh, rules=None, *, n_heads=None):
    """This rank's slice of the param `name` ("layer/param") of whole
    value `t` under `rules` (TRANSFORMER_TP_RULES by default): the whole
    `t` when its spec splits nothing. `n_heads`: the attention layer's
    head count for its packed QKV leaves."""
    split = _split_dim(spec_for(name, mesh, rules))
    if split is None:
        return t
    axis, dim = split
    return shard_slice(t, dim, mesh.axis_size(axis), mesh.axis_index(axis),
                       n_heads)


def shard_params(params, mesh, rules=None):
    """This rank's slice of every param of `params` under `rules`
    (TRANSFORMER_TP_RULES by default), in the same tree: the closest
    counterpart of the JAX `shard_params`, which `device_put`s each leaf
    with its rule's sharding and returns the global arrays. A process
    here holds its own slice, which is what this returns (`sharding_for`
    of each leaf). A packed QKV leaf is cut by columns, as GSPMD cuts the
    JAX one; to place a net, with its heads kept whole in each shard and
    the layers' collectives registered, call `net.set_mesh(mesh,
    axes={"model": ...})` or `place_in_process`."""
    def walk(node, prefix=""):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else sharding_for(f"{prefix}{k}", v, mesh, rules)
                for k, v in node.items()}

    return walk(params)


def _split_form(lc, dims):
    """Whether a layer of conf `lc` computes split as {param: dim} says,
    and the layer's kind."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        BaseOutputLayer,
        DenseLayer,
        EmbeddingLayer,
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExpertsLayer

    if isinstance(lc, SelfAttentionLayer):
        return dims == {"Wqkv": 1, "bqkv": 0, "Wo": 0}, "attention"
    if isinstance(lc, MixtureOfExpertsLayer):
        return dims == {"We1": 0, "be1": 0, "We2": 0, "be2": 0}, "experts"
    if isinstance(lc, (BaseOutputLayer, EmbeddingLayer)):
        return (dims.get("W") == 1 and set(dims) <= {"W", "b"}
                and dims.get("b", 0) == 0), "gather"
    if isinstance(lc, DenseLayer):
        return dims in ({"W": 1, "b": 0}, {"W": 0}), "dense"
    return False, type(lc).__name__


class SplitPlan:
    """The leaves of a net that a "model" / "expert" placement splits:
    `leaves` {(layer, param): (axis, dim, n_heads or None)}, `shapes`
    {(layer, param): whole shape}, `layers` {layer: axis}; resolved on
    `params`, the canonical params (the net's by default; only their
    shapes are read)."""

    def __init__(self, net, mesh, rules, params=None):
        from deeplearning4j_tpu_torch.nn.updater import named_layer_confs

        self.mesh = mesh
        self.leaves, self.shapes, self.layers = {}, {}, {}
        self._confs = named_layer_confs(net)
        params = net.params if params is None else params
        for layer, lc in self._confs.items():
            found = {}
            for path, t in tree.leaves(params.get(layer, {})):
                name = "/".join((layer,) + path)
                split = _split_dim(spec_for(name, mesh, rules))
                if split is not None:
                    found[path] = (split, tuple(t.shape))
            if found:
                self._add_layer(layer, lc, found)

    def _add_layer(self, layer, lc, found):
        axes = {axis for (axis, _), _ in found.values()}
        if len(axes) > 1:
            raise ValueError(f"layer '{layer}' is split over several mesh "
                             f"axes {sorted(axes)}; the port splits a "
                             "layer over one")
        (axis,) = axes
        m = self.mesh.axis_size(axis)
        dims = {"/".join(p): d for p, ((_, d), _) in found.items()}
        ok, kind = _split_form(lc, dims)
        if not ok:
            raise ValueError(
                f"layer '{layer}' ({type(lc).__name__}) has no split form "
                f"for {dims}: a placement splits attention heads (Wqkv, "
                "bqkv, Wo), a dense layer's outputs (W, b) or inputs (W), "
                "an embedding's or an output layer's W columns, or a MoE "
                "layer's experts")
        if kind == "experts":
            E = lc.n_experts
            if E % m:
                raise ValueError(f"{E} experts not divisible over {m} "
                                 "devices")
        elif kind == "attention":
            if lc.n_heads % m:
                return  # whole heads: the layer runs replicated
        elif any(shape[d] % m for (_, d), shape in found.values()):
            return  # the split does not divide: the layer runs whole
        heads = lc.n_heads if kind == "attention" else None
        for path, ((_, d), shape) in found.items():
            qkv = heads if path[-1] in ("Wqkv", "bqkv") else None
            self.leaves[(layer,) + path] = (axis, d, qkv)
            self.shapes[(layer,) + path] = shape
        self.layers[layer] = axis

    # ---------------------------------------------------------- layers
    def groups(self):
        """{leaf path: the process group it is split over} (the norms of
        split leaves sum their squares over it)."""
        return {path: self.mesh.group(axis)
                for path, (axis, _, _) in self.leaves.items()}

    def register(self, transport=None):
        """Register every split layer's ModelShard (ops/shard_scope.py),
        its collectives over its axis's process group, or over
        `transport` (every shard in this process: `place_in_process`)."""
        from deeplearning4j_tpu_torch.ops.shard_comm import (
            ProcessGroupShards,
        )
        from deeplearning4j_tpu_torch.ops.shard_scope import (
            ModelShard,
            place,
        )

        transports = {}
        for layer, axis in self.layers.items():
            if axis not in transports:
                transports[axis] = transport or ProcessGroupShards(
                    self.mesh.group(axis), self.mesh.axis_size(axis),
                    self.mesh.axis_index(axis))
            split = {"/".join(p[1:]): d
                     for p, (_, d, _) in self.leaves.items()
                     if p[0] == layer}
            place(self._confs[layer], ModelShard(transports[axis], split))

    def unregister(self):
        from deeplearning4j_tpu_torch.ops.shard_scope import unplace

        for layer in self.layers:
            unplace(self._confs[layer])


def place_in_process(net, n_shards: int, role: str = "model",
                     tp_rules=None):
    """Split `net`'s layers by the rules of `role` ("model" or "expert";
    `tp_rules` first) over `n_shards` shards that this process holds
    (ops/shard_comm `InProcessShards`): the params stay whole in
    `net.params` and each split layer computes every shard's share from
    its slices (`InProcessShards.pieces`) with the collectives summed in
    this process — the split of `set_mesh({role: n})` on one device, for
    the forward, training and the split decode (nn/decode.py: each
    shard's cache holds its own heads). `set_mesh` (None or a mesh) ends
    it. Returns the net."""
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
    from deeplearning4j_tpu_torch.parallel.placement import configure_mesh
    from deeplearning4j_tpu_torch.reshard.executor import virtual_mesh

    configure_mesh(net, None)
    if net.params is None:
        net.init()
    plan = SplitPlan(net, virtual_mesh({role: int(n_shards)}, net.device),
                     resolve_rules({role: role}, tp_rules))
    plan.register(InProcessShards(n_shards))
    net._inproc_split = plan
    net._train_step = None
    return net

