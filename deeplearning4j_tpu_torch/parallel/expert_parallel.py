"""Expert parallelism (EP): MoE experts split over an "expert" axis (JAX
counterpart deeplearning4j_tpu/parallel/expert_parallel.py).

Each shard holds E/n experts (the stacked expert tensors We1, be1, We2
and be2 split on their leading expert dim); the router runs whole on
every shard; each shard computes the gate-weighted partial output of ITS
experts over all tokens, and one sum over the shards gives the dense
result exactly, since the gates are zero outside the top-k and the
partial sums are disjoint. The backward is its conjugate: the replicated
input and gates collect their gradient from every shard
(ops/shard_comm.py). No capacity factor, no token dropping, no
all-to-all.

`set_mesh(mesh, axes={"expert": ...})` places a net's MoE layers by the
same rules (parallel/tensor_parallel.py `MOE_EP_RULES`), on whichever
routing their conf takes (nn/layers/moe.py); the two functions here are
the JAX package's standalone form over one layer's params.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers.moe import (  # noqa: F401
    moe_apply_dense,
    moe_expert_outputs,
    moe_gates,
)
from deeplearning4j_tpu_torch.ops.shard_comm import (
    InProcessShards,
    ProcessGroupShards,
)

_EXPERT_SHARDED = ("We1", "be1", "We2", "be2")


def shard_expert_params(params, mesh, axis: str = "expert"):
    """This rank's shard of one MoE layer's params: its slice of the
    stacked expert tensors, the router whole."""
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    E = params["We1"].shape[0]
    if E % n:
        raise ValueError(f"{E} experts not divisible over {n} devices")
    w = E // n
    return {k: (v[r * w:(r + 1) * w].clone() if k in _EXPERT_SHARDED
                else v) for k, v in params.items()}


def expert_parallel_apply(params, x, *, top_k, activation="gelu",
                          mesh=None, axis: str = "expert", n_shards=None):
    """MoE forward with the experts split, equal to the dense path.

    With a `mesh`, `params` is this rank's shard (`shard_expert_params`)
    and the partial outputs sum over the `axis` process group; with
    `n_shards` instead, `params` is the whole layer, split into n shards
    that run in this process (`InProcessShards`). x [..., D] replicated;
    returns [..., O], differentiable."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if mesh is not None:
        transport = ProcessGroupShards(mesh.group(axis),
                                       mesh.axis_size(axis),
                                       mesh.axis_index(axis))
        ps = [params]
    else:
        if not n_shards:
            raise ValueError("expert_parallel_apply needs a mesh or "
                             "n_shards")
        E = params["We1"].shape[0]
        if E % n_shards:
            raise ValueError(f"{E} experts not divisible over {n_shards} "
                             "devices")
        transport = InProcessShards(n_shards)
        w = E // n_shards
        ps = [{k: (v[j * w:(j + 1) * w] if k in _EXPERT_SHARDED else v)
               for k, v in params.items()} for j in range(n_shards)]
    y = moe_apply_dense(params, x2d, top_k=top_k, activation=activation,
                        experts=(transport, ps))
    return y.reshape(*shape[:-1], y.shape[-1])
