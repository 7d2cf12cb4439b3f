"""Mixture-of-Experts layer: a top-k router with token-routed dispatch
(JAX counterpart deeplearning4j_tpu/nn/layers/moe.py).

E expert FFNs with a learned router, two execution paths:

- ``routing="routed"`` (default): capacity-factor dispatch. Tokens are
  split into groups of ``router_group_size`` (0: min(N, 256)); within a
  group each token's top-k experts claim a slot in that expert's buffer
  of C = ceil(S * top_k * capacity_factor / E) slots (rounded up to a
  multiple of 8, at most S), in token order. The claimed tokens are
  gathered into [E, G, C, D], the expert FFNs run as batched einsums over
  the E-leading stacked weights, and the results are combined back with
  the renormalized gates. A token over capacity is dropped (zero output;
  the residual around the layer carries it). Two dispatches compute the
  same function: "einsum" (one-hot dispatch and combine tensors, the
  default) and "gather" (index gathers and a scatter of slot indices).
- ``routing="dense"``: every expert on every token, masked by the gates:
  exact and smooth, the oracle for the routed path.

With capacity_factor >= E / top_k the routed path drops nothing and
matches the dense path to float tolerance.

The router's Switch-style load-balance loss (times `router_aux_weight`)
goes into the layer's state under `AUX_LOSS_KEY` while training, and the
containers add it to the training loss (`pop_aux_losses`).

Where the JAX package's routing metadata differs in form: the slot
positions are an exclusive cumulative count in float32 (the JAX package
takes them from a strictly-lower-triangular product accumulated in
float32), so a group of more than 256 tokens cannot mis-slot one in
bf16; the top-k is k passes of argmax-and-mask, the first index winning
a tie, as in the JAX package (torch.topk makes no such promise).

Expert parallelism (the "expert" placement, parallel/expert_parallel.py;
ops/shard_scope.py `layer_shard`): We1, be1, We2 and be2 split on their
leading expert dim, Wg whole. The router and the routing run replicated;
each shard runs its experts on the tokens routed to them (both paths,
both dispatches) and weights them by its slice of the gates, and the
partial outputs sum over the shards (the JAX package's
`expert_parallel_apply`, the combine's psum). In a monolithic
data-parallel step (ops/shard_scope.py `DataShard`) the routed path
routes the global batch's tokens (`global_batch`): the groups, the
capacity and the aux loss are one device's on the global batch, as
under GSPMD; each data rank runs the layer over every rank's tokens and
keeps its rows' outputs. Both functions take the
split as `experts=(transport, shard params)`; without it the layer is
one shard holding every expert, the same code.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import FeedForwardLayer
from deeplearning4j_tpu_torch.nn.conf.serde import register_config
from deeplearning4j_tpu_torch.nn.layers.base import (
    AUX_LOSS_KEY,
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
from deeplearning4j_tpu_torch.ops.shard_scope import (
    global_batch,
    global_rows,
    layer_shard,
)

# the layer whole: one shard holding every expert
_WHOLE = InProcessShards(1)


@register_config
@dataclasses.dataclass
class MixtureOfExpertsLayer(FeedForwardLayer):
    """Top-k gated expert FFNs: y = sum_k gate_k * FFN_{e_k}(x)."""

    n_experts: int = 8
    top_k: int = 2
    d_hidden: int = 0  # defaults to 4*n_in
    routing: str = "routed"  # "routed" (capacity dispatch) | "dense" (oracle)
    capacity_factor: float = 1.25
    router_group_size: int = 0  # tokens per routing group; 0 = auto (256)
    router_aux_weight: float = 0.01  # Switch-style load-balance loss weight

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)


def moe_topk_from_logits(logits, top_k):
    """(gates [N, E], expert ids [N, k], renormalized probs [N, k]): k
    passes of argmax and mask, the first index winning a tie."""
    E = logits.shape[-1]
    x = logits
    lowest = torch.finfo(logits.dtype).min
    onehots, vals, ids = [], [], []
    for _ in range(top_k):
        i = torch.argmax(x, dim=-1)
        oh = torch.nn.functional.one_hot(i, E).to(logits.dtype)
        vals.append(x.gather(-1, i[:, None])[:, 0])
        onehots.append(oh)
        ids.append(i)
        x = x.masked_fill(oh > 0, lowest)
    probs = torch.softmax(torch.stack(vals, -1), dim=-1)     # [N, k]
    gates = sum(oh * probs[:, j:j + 1] for j, oh in enumerate(onehots))
    return gates, torch.stack(ids, -1), probs


def moe_gates_from_logits(logits, top_k):
    """Top-k renormalized softmax gates [N, E] (zeros outside the top-k)."""
    return moe_topk_from_logits(logits, top_k)[0]


def moe_gates(x2d, Wg, top_k):
    """Top-k renormalized softmax gates [N, E] (zeros outside the top-k)."""
    return moe_gates_from_logits(x2d @ Wg, top_k)


def moe_expert_outputs(params, x2d, activation):
    """All experts applied to all tokens: [N, E, n_out] (dense oracle)."""
    act = get_activation(activation)
    h = act(torch.einsum("nd,edh->neh", x2d, params["We1"]) + params["be1"])
    return torch.einsum("neh,eho->neo", h, params["We2"]) + params["be2"]


def _shards(params, experts):
    """(transport, [(first expert, shard params)]) of a split (or whole)
    layer."""
    transport, ps = experts or (_WHOLE, [params])
    return transport, [(j * p["We1"].shape[0], p)
                       for j, p in zip(transport.shards, ps)]


def moe_apply_dense(params, x2d, *, top_k, activation, experts=None):
    """Dense-path MoE forward: every expert, gate-masked combine.
    `experts`: (transport, shard params) of an expert split."""
    gates = moe_gates(x2d, params["Wg"], top_k)            # [N, E]
    transport, shards = _shards(params, experts)
    parts = []
    for (lo, p), xj, gj in zip(shards, transport.copy(x2d),
                               transport.copy(gates)):
        outs = moe_expert_outputs(p, xj, activation)       # [N, El, O]
        parts.append(torch.einsum(
            "ne,neo->no", gj[:, lo:lo + p["We1"].shape[0]], outs))
    return transport.reduce(parts)


def expert_capacity(group_size, top_k, capacity_factor, n_experts):
    """Per-group per-expert capacity, rounded up to a multiple of 8 and
    capped at the group size (a token claims an expert at most once)."""
    c = math.ceil(group_size * top_k * capacity_factor / n_experts)
    c = -(-c // 8) * 8
    return min(c, group_size)


def moe_load_balance_loss(logits, gates, top_k):
    """Switch Transformer aux loss generalized to top-k: E * sum_e f_e *
    P_e, f_e the fraction of routing assignments sent to expert e and P_e
    its mean full-softmax router probability, in float32. 1 at uniform
    routing; the gradient reaches the router only (f is
    piecewise-constant)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    frac = (gates > 0).float().mean(0) / top_k
    return E * (frac * probs.mean(0)).sum()


# "einsum" (one-hot dispatch/combine tensors) or "gather" (index gathers)
DISPATCH = "einsum"


def _experts(params, expert_in, act):
    """The expert FFNs on their buffers [E, G, C, D] -> [E, G, C, O]."""
    h = act(torch.einsum("egcd,edh->egch", expert_in, params["We1"])
            + params["be1"][:, None, None, :])
    return (torch.einsum("egch,eho->egco", h, params["We2"])
            + params["be2"][:, None, None, :])


def moe_apply_routed(params, x2d, *, top_k, capacity_factor, activation,
                     group_size=0, return_aux=False, dispatch=None,
                     experts=None):
    """Token-routed MoE forward by capacity-factor dispatch. Returns y
    [N, O] (and the unweighted load-balance aux loss when `return_aux`).
    Within each group, slots are claimed in token order; a token whose
    expert buffer is full gets a zero output row. `experts`: (transport,
    shard params) of an expert split."""
    N, D = x2d.shape
    E = params["Wg"].shape[-1]
    O = params["We2"].shape[-1]
    transport, shards = _shards(params, experts)
    S = group_size or min(N, 256)
    G = -(-N // S)
    pad = G * S - N

    logits = x2d @ params["Wg"]                            # [N, E]
    gates, top_idx, top_probs = moe_topk_from_logits(logits, top_k)
    aux = moe_load_balance_loss(logits, gates, top_k) if return_aux else None

    pad2 = (0, 0, 0, pad)
    xp = torch.nn.functional.pad(x2d, pad2) if pad else x2d
    gg = (torch.nn.functional.pad(gates, pad2) if pad else gates)
    gg = gg.reshape(G, S, E)
    C = expert_capacity(S, top_k, capacity_factor, E)
    act = get_activation(activation)
    xg = xp.reshape(G, S, D)
    routed = gg > 0                                        # [G, S, E]
    # exclusive count of the earlier tokens routed to each expert: the
    # token's slot, exact in float32 for any group size up to 2^24
    routed32 = routed.float()
    pos = torch.cumsum(routed32, dim=1) - routed32         # [G, S, E]

    if (dispatch or DISPATCH) == "einsum":
        cdt = xp.dtype
        keep_f = (routed & (pos < C)).to(cdt)              # [G, S, E]
        slots = torch.arange(C, dtype=torch.float32, device=xp.device)
        disp = keep_f[..., None] * (pos[..., None] == slots).to(cdt)
        parts = []
        for (lo, p), xj, gj in zip(shards, transport.copy(xg),
                                   transport.copy(gg)):
            hi = lo + p["We1"].shape[0]
            d = disp[:, :, lo:hi]
            combine = d * gj[:, :, lo:hi, None].to(cdt)    # [G, S, El, C]
            expert_in = torch.einsum("gsec,gsd->egcd", d, xj)
            out = _experts(p, expert_in, act)
            parts.append(torch.einsum("gsec,egco->gso", combine,
                                      out).reshape(G * S, O))
        y = transport.reduce(parts)
        y = y[:N] if pad else y
        return (y, aux) if return_aux else y

    # ---- gather dispatch ----
    pos = pos.long()
    keep = routed & (pos < C)
    if pad:
        top_idx = torch.nn.functional.pad(top_idx, pad2)
        top_probs = torch.nn.functional.pad(top_probs, pad2)
    e_k = top_idx.reshape(G, S, top_k)                     # [G, S, k]
    kept_k = keep.gather(2, e_k)                           # [G, S, k]
    slot_k = pos.gather(2, e_k)
    prob_k = top_probs.reshape(G, S, top_k).to(xp.dtype)
    # inverse map (g, e, c) -> source token s (S: the zero row); every
    # kept (expert, slot) pair is claimed by exactly one token
    dev = xp.device
    g_idx = torch.arange(G, device=dev)[:, None, None].expand(G, S, top_k)
    s_idx = torch.arange(S, device=dev)[None, :, None].expand(G, S, top_k)
    idx_buf = torch.full((G * E * C,), S, dtype=torch.long, device=dev)
    flat_slot = (g_idx * E + e_k) * C + slot_k
    idx_buf[flat_slot[kept_k]] = s_idx[kept_k]
    xg_pad = torch.nn.functional.pad(xg, (0, 0, 0, 1))     # [G, S+1, D]
    rows = torch.arange(G, device=dev)[:, None]
    idx3 = idx_buf.reshape(G, E, C)
    parts = []
    for (lo, p), xj, pj in zip(shards, transport.copy(xg_pad),
                               transport.copy(prob_k)):
        El = p["We1"].shape[0]
        expert_in = xj[rows, idx3[:, lo:lo + El].reshape(G, El * C)]
        expert_in = expert_in.reshape(G, El, C, D).movedim(1, 0)
        out = _experts(p, expert_in, act)                  # [El, G, C, O]
        out_pad = torch.nn.functional.pad(
            out.movedim(0, 1).reshape(G, El * C, O), (0, 0, 0, 1))
        mine = kept_k & (e_k >= lo) & (e_k < lo + El)
        flat = torch.where(mine, (e_k - lo) * C + slot_k,
                           torch.full_like(e_k, El * C))   # [G, S, k]
        picked = out_pad[rows, flat.reshape(G, S * top_k)].reshape(
            G, S, top_k, O)
        parts.append(torch.einsum("gsk,gsko->gso", pj,
                                  picked).reshape(G * S, O))
    y = transport.reduce(parts)
    y = y[:N] if pad else y
    return (y, aux) if return_aux else y


@register_impl(MixtureOfExpertsLayer)
class MixtureOfExpertsImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        E = conf.n_experts
        D, O = conf.n_in, conf.n_out or conf.n_in
        H = conf.d_hidden or 4 * D

        def w(shape):
            return init_weights(gen, shape, conf.weight_init, conf.dist,
                                dtype)

        return {
            "Wg": w((D, E)),
            "We1": torch.stack([w((D, H)) for _ in range(E)]),
            "be1": torch.zeros(E, H, dtype=dtype),
            "We2": torch.stack([w((H, O)) for _ in range(E)]),
            "be2": torch.zeros(E, O, dtype=dtype),
        }, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        new_state = {k: v for k, v in state.items() if k != AUX_LOSS_KEY}
        activation = conf.activation or "gelu"
        shard = layer_shard(conf)
        experts = None if shard is None else (
            shard.transport, shard.transport.pieces(params, shard.split))
        if conf.routing == "dense":
            y = moe_apply_dense(params, x2d, top_k=conf.top_k,
                                activation=activation, experts=experts)
        else:
            # in a monolithic data-parallel step the routing groups, the
            # capacity and the aux loss are the global batch's (as one
            # device on it): route every rank's tokens, keep this rank's
            _, rows = global_rows(x2d.shape)
            want_aux = train and conf.router_aux_weight > 0
            out = moe_apply_routed(
                params, global_batch(x2d), top_k=conf.top_k,
                capacity_factor=conf.capacity_factor, activation=activation,
                group_size=conf.router_group_size, return_aux=want_aux,
                experts=experts)
            if want_aux:
                y, aux = out
                new_state[AUX_LOSS_KEY] = conf.router_aux_weight * aux
            else:
                y = out
            if rows is not None:
                y = y[rows]
        return y.reshape(*shape[:-1], y.shape[-1]), new_state
