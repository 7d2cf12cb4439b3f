"""Embedding lookup table + batched training steps (JAX counterpart
deeplearning4j_tpu/nlp/lookup.py).

Reference:
- embeddings/inmemory/InMemoryLookupTable.java:62 — syn0/syn1/syn1Neg,
  init rand(vocab,dim).subi(0.5).divi(dim):133
- embeddings/learning/impl/elements/SkipGram.java:160-229 — per-pair
  hierarchical-softmax dot/axpy + negative sampling
- embeddings/learning/impl/elements/CBOW.java
- embeddings/reader/impl/{BasicModelUtils,FlatModelUtils} — wordsNearest

A whole batch of pairs is one step: gather rows -> dot products ->
sigmoid losses -> closed-form (sigma(x) - label) gradients -> per-row
summed SGD updates with the trust-region cap of `_scatter_update`.
Where the JAX steps donate their tables and return new ones, these
update the tables IN PLACE (no second copy of a table per step) and
return the same tensors. Every row a step reads is gathered before any
table changes, so the order of the updates does not matter.

Index arguments may be numpy arrays or tensors; they are moved to the
table's device. The inference-only steps (`infer_sgns_step`,
`infer_hs_step`) train one free vector against frozen output rows, for
ParagraphVectors.infer_vector.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

MAX_ROW_STEP = 0.1  # trust-region cap on a row's per-batch movement


def to_numpy(t) -> np.ndarray:
    """A host copy of a table or row: the steps update tables in place,
    so an array handed out must not alias one."""
    return t.detach().to("cpu", copy=True).numpy()


def _index(a, device) -> torch.Tensor:
    """An index array as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device).long()


def _scatter_update(table, idx, grads, lr):
    """table -= lr * per-row SUM of gradients, each row's summed step
    L2-capped at MAX_ROW_STEP; rows with no gradient stay unchanged.

    A word seen k times in a batch moves k lr-steps, as sequential SGD
    would, but a degenerate corpus (hundreds of duplicates per batch)
    cannot overshoot: the cap keeps each row's step bounded. Masked or
    padding entries must carry zero grads. idx [N], grads [N, D].
    `index_add_` sums the duplicates; on CUDA its atomics sum them in
    an order that changes from run to run."""
    sums = torch.zeros_like(table).index_add_(0, idx,
                                              grads.to(table.dtype))
    step = lr * sums
    n = torch.linalg.vector_norm(step, dim=1, keepdim=True)
    step = step * torch.clamp(MAX_ROW_STEP / n.clamp_min(1e-12), max=1.0)
    return table.sub_(step)


def _plain_scores(c, pos, neg):
    """The legacy step's scoring: sigmoid(c . pos), sigmoid(c . neg_k)."""
    return (torch.sigmoid(torch.einsum("bd,bd->b", c, pos)),
            torch.sigmoid(torch.einsum("bd,bkd->bk", c, neg)))


def _ns_update(syn1neg, h, pos, neg, target, negatives, lr, scores):
    """The negative-sampling half shared by skip-gram and CBOW: scores
    of the hidden rows h [B, D] against pos [B, D] and neg [B, K, D],
    the syn1neg update, and the loss. Returns (grad_h, loss)."""
    pos_score, neg_score = scores(h, pos, neg)
    g_pos = (pos_score - 1.0)[:, None]           # dL/d(h.pos)
    g_neg = neg_score[:, :, None]                # dL/d(h.neg)
    grad_h = g_pos * pos + torch.einsum("bk,bkd->bd", neg_score, neg)
    B, K = negatives.shape
    out_idx = torch.cat([target, negatives.reshape(B * K)])
    out_grad = torch.cat([g_pos * h, (g_neg * h[:, None, :])
                          .reshape(B * K, -1)])
    _scatter_update(syn1neg, out_idx, out_grad, lr)
    loss = -(torch.log(pos_score + 1e-10).sum()
             + torch.log(1.0 - neg_score + 1e-10).sum())
    return grad_h, loss / B


# --------------------------------------------------------------------------
# Skip-gram with negative sampling — batched
# --------------------------------------------------------------------------
def sgns_step(syn0, syn1neg, center, context, negatives, lr,
              scores=_plain_scores):
    """One SGD step on a batch of skip-gram pairs with K negatives each.

    center [B], context [B], negatives [B,K]; lr scalar. `scores` maps
    (c, pos, neg) to the sigmoid'd scores (the embedding engine passes
    the K13 kernel's wrapper).
    loss = -log sigma(c.v_pos) - sum_k log sigma(-c.v_negk)   (word2vec)
    Returns (syn0, syn1neg, loss) with the tables updated in place."""
    dev = syn0.device
    center, context, negatives = (_index(a, dev)
                                  for a in (center, context, negatives))
    c = syn0[center]                             # [B, D]
    grad_c, loss = _ns_update(syn1neg, c, syn1neg[context],
                              syn1neg[negatives], context, negatives, lr,
                              scores)
    _scatter_update(syn0, center, grad_c, lr)
    return syn0, syn1neg, loss


# --------------------------------------------------------------------------
# Skip-gram with hierarchical softmax — batched
# --------------------------------------------------------------------------
def sg_hs_step(syn0, syn1, center, codes, points, mask, lr):
    """Hierarchical-softmax step (reference SkipGram.iterateSample:181-197).

    center [B]; codes [B,L] (0/1 per tree branch); points [B,L] inner-node
    rows of syn1; mask [B,L] valid-depth mask.
    loss = -sum_d log sigma((1-2*code_d) * c.syn1[point_d])"""
    dev = syn0.device
    center, points = _index(center, dev), _index(points, dev)
    codes = torch.as_tensor(np.asarray(codes), device=dev)
    mask = torch.as_tensor(np.asarray(mask), device=dev).bool()
    c = syn0[center]                             # [B, D]
    nodes = syn1[points]                         # [B, L, D]
    sign = 1.0 - 2.0 * codes.to(c.dtype)         # [B, L]
    p = torch.sigmoid(sign * torch.einsum("bd,bld->bl", c, nodes))
    m = mask.to(c.dtype)
    g = -sign * (1.0 - p) * m                    # dL/dlogit, masked
    grad_c = torch.einsum("bl,bld->bd", g, nodes)
    grad_nodes = g[:, :, None] * c[:, None, :]
    B, L = codes.shape
    _scatter_update(syn0, center, grad_c, lr)
    # masked-out depths carry zero grads; route them to row 0
    flat_pts = torch.where(mask, points, 0).reshape(B * L)
    _scatter_update(syn1, flat_pts,
                    (grad_nodes * m[:, :, None]).reshape(B * L, -1), lr)
    loss = -(torch.log(p + 1e-10) * m).sum()
    return syn0, syn1, loss / B


# --------------------------------------------------------------------------
# CBOW — batched (negative sampling)
# --------------------------------------------------------------------------
def cbow_ns_step(syn0, syn1neg, context, context_mask, target, negatives,
                 lr):
    """CBOW: mean of context vectors predicts the target
    (reference CBOW.java). context [B,W] padded, context_mask [B,W],
    target [B], negatives [B,K]."""
    dev = syn0.device
    context, target, negatives = (_index(a, dev)
                                  for a in (context, target, negatives))
    cmask = torch.as_tensor(np.asarray(context_mask), device=dev).bool()
    ctx = syn0[context]                          # [B, W, D]
    m = cmask.to(ctx.dtype)[:, :, None]
    denom = m.sum(1).clamp_min(1.0)              # [B, 1]
    h = (ctx * m).sum(1) / denom                 # [B, D]
    grad_h, loss = _ns_update(syn1neg, h, syn1neg[target],
                              syn1neg[negatives], target, negatives, lr,
                              _plain_scores)
    grad_ctx = (grad_h[:, None, :] / denom[:, None, :]) * m   # [B, W, D]
    B, W = context.shape
    flat_ctx = torch.where(cmask, context, 0).reshape(B * W)
    _scatter_update(syn0, flat_ctx, grad_ctx.reshape(B * W, -1), lr)
    return syn0, syn1neg, loss


# --------------------------------------------------------------------------
# Inference-only variants (frozen output rows) for
# ParagraphVectors.infer_vector
# --------------------------------------------------------------------------
def infer_sgns_step(vec, syn1neg, context, negatives, lr):
    """Train a single free vector against frozen output weights.
    vec [D]; context [B]; negatives [B, K]. Returns (new vec, loss);
    `vec` itself is left as it was."""
    dev = syn1neg.device
    pos = syn1neg[_index(context, dev)]                  # [B, D]
    neg = syn1neg[_index(negatives, dev)]                # [B, K, D]
    pos_score = torch.sigmoid(pos @ vec)                 # [B]
    neg_score = torch.sigmoid(torch.einsum("bkd,d->bk", neg, vec))
    grad = (((pos_score - 1.0)[:, None] * pos).sum(0)
            + torch.einsum("bk,bkd->d", neg_score, neg))
    loss = -(torch.log(pos_score + 1e-10).sum()
             + torch.log(1.0 - neg_score + 1e-10).sum())
    return vec - lr * grad, loss


def infer_hs_step(vec, syn1, codes, points, mask, lr):
    """Hierarchical-softmax counterpart of infer_sgns_step: one free
    vector against the frozen Huffman inner nodes. codes/points/mask
    [B, L]."""
    dev = syn1.device
    nodes = syn1[_index(points, dev)]                    # [B, L, D]
    codes = torch.as_tensor(np.asarray(codes), device=dev)
    m = torch.as_tensor(np.asarray(mask), device=dev).to(vec.dtype)
    sign = 1.0 - 2.0 * codes.to(vec.dtype)
    p = torch.sigmoid(sign * torch.einsum("d,bld->bl", vec, nodes))
    g = -sign * (1.0 - p) * m
    grad = torch.einsum("bl,bld->d", g, nodes)
    loss = -(torch.log(p + 1e-10) * m).sum()
    return vec - lr * grad, loss


# --------------------------------------------------------------------------
# Queries shared by the lookup table and the engine's view
# --------------------------------------------------------------------------
def nearest_rows(syn0, query_vec, top_n: int = 10, exclude=()) -> list:
    """Brute-force cosine top-n over the rows of syn0 (reference
    BasicModelUtils.wordsNearest): [(index, similarity), ...]."""
    normed = syn0 / torch.linalg.vector_norm(
        syn0, dim=1, keepdim=True).clamp_min(1e-12)
    q = torch.as_tensor(np.asarray(query_vec), dtype=syn0.dtype,
                        device=syn0.device)
    q = q / torch.linalg.vector_norm(q).clamp_min(1e-12)
    sims = (normed @ q).float()
    if exclude:
        sims[list(exclude)] = -float("inf")
    vals, idx = torch.topk(sims, min(top_n, syn0.shape[0]))
    return list(zip(idx.tolist(), vals.tolist()))


def cosine(a, b) -> float:
    denom = torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
    return float(torch.dot(a, b) / denom.clamp_min(1e-12))


# --------------------------------------------------------------------------
# The lookup table object
# --------------------------------------------------------------------------
class InMemoryLookupTable:
    """Embedding storage (reference InMemoryLookupTable.java:62).

    syn0: input embeddings [V, D]; syn1: HS inner nodes; syn1neg: NS output
    embeddings. Tensors on `device` (CUDA unless the caller names
    another); the steps above update them in place."""

    def __init__(self, vocab_size: int, vector_length: int,
                 seed: int = 123, use_hs: bool = False, negative: int = 5,
                 dtype=torch.float32, device=None):
        self.vocab_size = vocab_size
        self.vector_length = vector_length
        self.use_hs = use_hs
        self.negative = negative
        self.dtype = dtype
        self.seed = seed
        self.device = resolve_device(device)
        self.reset_weights()

    def reset_weights(self):
        self.syn0, self.syn1, self.syn1neg = init_tables(
            self.vocab_size, self.vector_length, self.seed, self.dtype,
            self.device)

    # vectors --------------------------------------------------------------
    def vector(self, index: int) -> np.ndarray:
        return to_numpy(self.syn0[index])

    def vectors(self) -> np.ndarray:
        return to_numpy(self.syn0)

    def set_vectors(self, arr: np.ndarray):
        self.syn0 = torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                                    device=self.device).clone()
        self.vocab_size, self.vector_length = arr.shape

    # similarity -----------------------------------------------------------
    def nearest(self, query_vec: np.ndarray, top_n: int = 10,
                exclude=()) -> list:
        return nearest_rows(self.syn0, query_vec, top_n, exclude)

    def similarity(self, i: int, j: int) -> float:
        return cosine(self.syn0[i], self.syn0[j])


def init_tables(rows: int, dim: int, seed: int, dtype, device):
    """(syn0, syn1, syn1neg): syn0 = (rand - 0.5) / dim (reference
    InMemoryLookupTable.java:133) from a torch.Generator seeded with
    `seed` (its bits differ from the JAX package's jax.random draw),
    the other two zero."""
    gen = torch.Generator().manual_seed(seed)
    syn0 = ((torch.rand(rows, dim, generator=gen) - 0.5) / dim).to(
        device=device, dtype=dtype)
    return (syn0, torch.zeros(rows, dim, dtype=dtype, device=device),
            torch.zeros(rows, dim, dtype=dtype, device=device))
