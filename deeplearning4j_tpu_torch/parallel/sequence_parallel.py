"""Sequence-parallel training — shard the TIME dimension over a mesh axis
(JAX counterpart deeplearning4j_tpu/parallel/sequence_parallel.py).

Each rank holds one block of the sequence (and, with a "data" axis, its
rows of the batch); attention runs as the ring over the "seq" process
group (parallel/ring_attention.py) and positional encodings offset by
the block's global position, both read from the `ops.shard_scope`
sequence shard the step enters. Every rank's params stay equal because
the gradients are mean-reduced over the axes before the (deterministic)
update:

    mesh = make_mesh({"seq": 4})
    net = transformer_lm(..., seq_parallel_axis="seq")   # conf-driven
    SequenceParallelTrainer(net, mesh).fit(iterator, epochs=3)

Combined with a "data" axis (batch x sequence mesh): pass
data_axis="data". With a "model" axis (`net.set_mesh(mesh, axes={"seq":
"seq", "model": "model"[, "data": "data"]})`, the JAX package's
GSPMD-auto model axis inside its manual seq/data shard_map) each rank
holds its slice of the split layers (parallel/tensor_parallel.py) and
runs the ring over its own heads; the split layers' collectives run
over the model group in the forward and backward, so a whole leaf's
gradient is already the same on every model shard and a split leaf's is
its shard's; every gradient is then mean-reduced over data and seq
only. Constraints: the global sequence length must divide by the
seq-axis size, no padding masks (pad to full length).
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    DataSet,
    MultiDataSet,
)


def make_sp_train_step(net, mesh, seq_axis: str = "seq",
                       data_axis: Optional[str] = None,
                       model_axis: Optional[str] = None):
    """step(params, opt_state, state, generator, batch) -> (params,
    opt_state, state, loss, {}) where batch holds this rank's block:
    features[0] and labels[0] [B_local, T_local]. Every shard mixes its
    axis indices into its dropout generator (the JAX step's `fold_in`),
    except the ring's step seeds, common to the shards of one sequence
    so the ring drops what one kernel over it would; the loss, the
    gradients and the float layer state are mean-reduced over the axes
    (each shard's loss is a mean over equally many tokens, so the mean
    of means is the global mean). `model_axis`: the mesh axis of a
    "model" placement the net already holds (set_mesh); its shards'
    heads draw apart (nn/layers/attention.py `attention_shards`) and it
    joins no gradient reduction."""
    from deeplearning4j_tpu_torch.nn.training import loss_and_grads
    from deeplearning4j_tpu_torch.nn.updater import apply_updates
    from deeplearning4j_tpu_torch.parallel.overlap import (
        pmean_float_leaves,
        reduce_gradients,
    )
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ProcessGroupRing,
    )
    from deeplearning4j_tpu_torch.ops.shard_scope import (
        SeqShard,
        shard_generator,
        sharded,
    )

    if model_axis is not None and model_axis not in mesh.shape:
        raise ValueError(f"model_axis {model_axis!r} is not a mesh axis "
                         f"(mesh has {mesh.axis_names})")
    axes = ((data_axis,) if data_axis else ()) + (seq_axis,)
    groups = [(mesh.group(a), mesh.axis_size(a)) for a in axes]
    indices = tuple(mesh.axis_index(a) for a in axes)
    size = 1
    for a in axes:
        size *= mesh.axis_size(a)
    ring = ProcessGroupRing(mesh.group(seq_axis), mesh.axis_size(seq_axis),
                            mesh.axis_index(seq_axis))

    def step(params, opt_state, state, generator, batch):
        masks = list(batch.get("features_masks") or []) + list(
            batch.get("labels_masks") or [])
        if any(m is not None for m in masks):
            raise ValueError("masks are not supported under sequence "
                             "parallelism — pad to full length")
        gen = shard_generator(generator, indices, size)
        ring_gen = shard_generator(generator, indices[:-1], size)
        shard = SeqShard(seq_axis, ring, mesh.axis_index(seq_axis),
                         mesh.axis_size(seq_axis), ring_gen)
        with sharded(seq=shard):
            loss, aux, grads = loss_and_grads(
                lambda p, s, g, b: net._loss(p, s, g, b, train=True),
                params, state, gen, batch)
        new_state = aux[0] if isinstance(aux, tuple) else aux
        loss = loss.detach()
        for group, n in groups:
            new_state = pmean_float_leaves(new_state, group, n)
            loss = reduce_gradients({"l": loss}, [(group, n)])["l"]
        grads = reduce_gradients(grads, groups)
        updates, opt_state = net.tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, new_state, loss, {}

    return step


class SequenceParallelTrainer:
    """fit()-style wrapper (API symmetry with DataParallelTrainer): sets
    the net's mesh with the "seq" role (and "data" when `data_axis` is
    given), so every DataSet batch — the global one, on every rank — is
    one SP step over this rank's block."""

    def __init__(self, net, mesh, seq_axis: str = "seq",
                 data_axis: Optional[str] = None):
        self.net = net
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.data_axis = data_axis
        axes = {"seq": seq_axis}
        if data_axis:
            axes["data"] = data_axis
        net.set_mesh(mesh, axes=axes)

    def fit(self, iterator, epochs: int = 1):
        return self.net.fit(iterator, epochs=epochs)
