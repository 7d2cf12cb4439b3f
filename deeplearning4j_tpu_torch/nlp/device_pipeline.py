"""Whole-epoch skip-gram and CBOW training on the device (JAX counterpart
deeplearning4j_tpu/nlp/device_pipeline.py).

The reference trains word2vec with host-side per-pair loops
(`embeddings/learning/impl/elements/SkipGram.java:160-229`). Here the
host packs the corpus once per epoch and uploads it; from then on every
update runs on the device with no host round trip:

- dynamic-window pair generation over the packed token stream (pairs
  never cross a sentence id);
- unigram^0.75 negatives from Walker alias tables;
- the SGNS (or CBOW) forward and backward, the per-update gradient sums
  into dense [V, D] tables with `index_add_`, and the trust-region
  update of both tables, in place;
- the linear learning-rate ramp `lr0 + (lr1 - lr0) * u / n_up`, in f32.

One update takes `group * chunk` consecutive centers: the JAX package
vmaps its chunk function over the `group` chunks of one update and sums
their gradients; the chunks of one update are consecutive, so here one
call of the chunk function covers all of them at once. The loop over
updates is a Python loop of eager launches, and the per-update losses
stay on the device until one fetch at the end of the fit.

**Draws.** The JAX epoch draws inside its jitted scan from
`fold_in(key, u * group + g)`; a torch.Generator cannot reproduce those
bits. So the chunk functions take their draws (the window shrink `b`,
the negatives) as tensors, and the epoch takes them from one function,
`draw_update`, fed by a `torch.Generator` on the tables' device. Tests
replace `draw_update` with the JAX package's draws to hold the two
epochs to each other.

Semantics follow the batched host path (`lookup.sgns_step`): per-update
summed gradients with the MAX_ROW_STEP trust region. By default SGNS
shares each center's negatives across its context slots with pair-count
weighting (`share_negatives=True`), drawing `neg_oversample * K` of them
each weighted K/M; `share_negatives=False` draws K per pair.

A device mesh (the JAX package's sharded chunk stream) needs NCCL and
waits for the parallel slice (ROADMAP Queue A item 7): `mesh` raises.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import MAX_ROW_STEP


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "device_pipeline: a device mesh (the sharded chunk stream) "
            "needs NCCL and waits for the parallel slice (ROADMAP Queue A "
            "item 7); the port trains on one device (mesh=None)")


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables (J, q) for O(1) categorical sampling on the
    device: two gathers and a select per draw. Host construction is
    O(V)."""
    p = np.asarray(probs, np.float64)
    p = p / p.sum()
    V = len(p)
    q = p * V
    J = np.zeros(V, np.int32)
    small = [i for i in range(V) if q[i] < 1.0]
    large = [i for i in range(V) if q[i] >= 1.0]
    while small and large:
        s_ = small.pop()
        l_ = large.pop()
        J[s_] = l_
        q[l_] = q[l_] - (1.0 - q[s_])
        (small if q[l_] < 1.0 else large).append(l_)
    for i in small + large:
        q[i] = 1.0
    return J, q.astype(np.float32)


def alias_sample(gen, J: torch.Tensor, q: torch.Tensor, shape):
    """Draws of the alias tables' distribution, `shape` int64 on J's
    device: a uniform bucket, then a uniform coin against its q."""
    i = torch.randint(0, J.shape[0], shape, generator=gen, device=J.device)
    coin = torch.rand(shape, generator=gen, device=J.device)
    return torch.where(coin < q[i], i, J[i].long())


def draw_update(gen, u: int, J, q, *, chunk: int, group: int, window: int,
                neg_shape: tuple):
    """The draws of update `u`: the dynamic window b [group * chunk] in
    1..window and the negatives [group * chunk, *neg_shape]. The one
    place the epoch draws (tests swap in the JAX package's draws)."""
    S = group * chunk
    b = torch.randint(1, window + 1, (S,), generator=gen, device=J.device)
    return b, alias_sample(gen, J, q, (S, *neg_shape))


def pack_corpus_flat(tokens: np.ndarray, sent_ids: np.ndarray,
                     multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an already-flat (tokens, sent_ids) pair to a multiple of
    `multiple`; padding carries sent_id -1 (never pairs). Pairing only
    compares sent ids for equality, so gaps in the numbering (empty or
    all-OOV sentences) are fine."""
    if len(tokens) == 0:
        raise ValueError("empty corpus")
    tokens = np.asarray(tokens, np.int32)
    sent_ids = np.asarray(sent_ids, np.int32)
    pad = (-len(tokens)) % multiple
    if pad:
        tokens = np.concatenate([tokens, np.zeros(pad, np.int32)])
        sent_ids = np.concatenate([sent_ids, np.full(pad, -1, np.int32)])
    return tokens, sent_ids


def pack_corpus(idx_seqs: List[np.ndarray], multiple: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten index sequences into (tokens [N], sent_ids [N]) padded to a
    multiple of `multiple`; padding carries sent_id -1 (never pairs)."""
    seqs = [np.asarray(s, np.int32) for s in idx_seqs if len(s) > 0]
    if not seqs:
        raise ValueError("empty corpus")
    tokens = np.concatenate(seqs)
    sent_ids = np.concatenate(
        [np.full(len(s), i, np.int32) for i, s in enumerate(seqs)])
    return pack_corpus_flat(tokens, sent_ids, multiple)


def _offsets(window: int, device) -> torch.Tensor:
    """[-w..-1, 1..w], made on `device` (a copy from the host would wait
    for the device)."""
    return torch.cat([torch.arange(-window, 0, device=device),
                      torch.arange(1, window + 1, device=device)])


def _window_context(tokens, sent_ids, start: int, b, *, window: int):
    """Dynamic-window context of the len(b) centers from `start`:
    (centers [S], ctx [S, 2w], valid [S, 2w]). A slot is valid when it
    lies in the corpus, in the center's sentence, within the center's
    drawn window b, and the center is not padding."""
    N = tokens.shape[0]
    S = b.shape[0]
    pos = start + torch.arange(S, device=tokens.device)
    centers = tokens[pos].long()
    csent = sent_ids[pos]
    offs = _offsets(window, tokens.device)
    cpos = pos[:, None] + offs[None, :]
    cposc = cpos.clamp(0, N - 1)
    valid = ((cpos >= 0) & (cpos < N)
             & (sent_ids[cposc] == csent[:, None])
             & (offs.abs()[None, :] <= b[:, None])
             & (csent[:, None] >= 0))
    return centers, tokens[cposc].long(), valid


def _chunk_pair_grads(syn0, syn1neg, tokens, sent_ids, start, b, negs, *,
                      window, K, share_negatives=True):
    """SGNS gradient pieces for the len(b) centers from `start`, given
    their window draws b [S] and negatives (`[S, M]` shared, M =
    round(K * neg_oversample) as drawn, each weighted K/M by the
    center's pair count; `[S, 2w, K]` per pair otherwise). Returns (centers, grad_c,
    ctx, grad_pos, negs, grad_neg, loss sum, valid-pair count)."""
    centers, ctx, valid = _window_context(tokens, sent_ids, start, b,
                                          window=window)
    negs = negs.long()
    c = syn0[centers]                                      # [S, D]
    posv = syn1neg[ctx]                                    # [S, 2w, D]
    pos_score = torch.sigmoid(torch.einsum("sd,swd->sw", c, posv))
    vm = valid.to(c.dtype)
    g_pos = (pos_score - 1.0) * vm                         # [S, 2w]
    grad_pos = g_pos[..., None] * c[:, None, :]            # [S, 2w, D]
    eps = 1e-10
    loss = -(torch.log(pos_score + eps) * vm).sum()
    grad_c = torch.einsum("sw,swd->sd", g_pos, posv)
    negv = syn1neg[negs]
    if share_negatives:
        M = negs.shape[1]
        w_neg = K / M
        neg_score = torch.sigmoid(torch.einsum("sd,skd->sk", c, negv))
        weight = w_neg * vm.sum(-1)[:, None]               # [S, 1]
        g_neg = neg_score * weight                         # [S, M]
        grad_c = grad_c + torch.einsum("sk,skd->sd", g_neg, negv)
        grad_neg = g_neg[..., None] * c[:, None, :]        # [S, M, D]
        loss = loss - (torch.log(1.0 - neg_score + eps) * weight).sum()
    else:
        neg_score = torch.sigmoid(torch.einsum("sd,swkd->swk", c, negv))
        g_neg = neg_score * vm[..., None]                  # [S, 2w, K]
        grad_c = grad_c + torch.einsum("swk,swkd->sd", g_neg, negv)
        grad_neg = g_neg[..., None] * c[:, None, None, :]  # [S, 2w, K, D]
        loss = loss - (torch.log(1.0 - neg_score + eps)
                       * vm[..., None]).sum()
    return centers, grad_c, ctx, grad_pos, negs, grad_neg, loss, vm.sum()


def _chunk_cbow_grads(syn0, syn1neg, tokens, sent_ids, start, b, negs, *,
                      window, K):
    """CBOW gradient pieces for the len(b) centers from `start`: the
    mean of the valid context rows predicts the center against its K
    negatives [S, K] (reference CBOW.java, batched). Returns (ctx,
    grad_ctx, centers, grad_tgt, negs, grad_neg, loss sum, count of
    centers with a context)."""
    centers, ctx, valid = _window_context(tokens, sent_ids, start, b,
                                          window=window)
    negs = negs.long()
    vm = valid.to(syn0.dtype)
    cnt = vm.sum(-1, keepdim=True).clamp_min(1.0)          # [S, 1]
    h = (syn0[ctx] * vm[..., None]).sum(1) / cnt           # [S, D]
    has_ctx = (vm.sum(-1) > 0).to(syn0.dtype)
    tgt = syn1neg[centers]                                 # [S, D]
    negv = syn1neg[negs]                                   # [S, K, D]
    pos_score = torch.sigmoid(torch.einsum("sd,sd->s", h, tgt))
    neg_score = torch.sigmoid(torch.einsum("sd,skd->sk", h, negv))
    g_pos = (pos_score - 1.0) * has_ctx                    # [S]
    g_neg = neg_score * has_ctx[:, None]                   # [S, K]
    grad_h = g_pos[:, None] * tgt + torch.einsum("sk,skd->sd", g_neg, negv)
    grad_ctx = grad_h[:, None, :] * (vm / cnt)[..., None]  # [S, 2w, D]
    grad_tgt = g_pos[:, None] * h
    grad_neg = g_neg[..., None] * h[:, None, :]            # [S, K, D]
    eps = 1e-10
    loss = -((torch.log(pos_score + eps) * has_ctx).sum()
             + (torch.log(1.0 - neg_score + eps) * has_ctx[:, None]).sum())
    return ctx, grad_ctx, centers, grad_tgt, negs, grad_neg, loss, \
        has_ctx.sum()


def _trust_region_apply(table, grad, lr):
    """table -= lr * grad, each row's step L2-capped at MAX_ROW_STEP (the
    trust region of lookup._scatter_update), in place."""
    step = lr * grad
    n = torch.linalg.vector_norm(step, dim=1, keepdim=True)
    return table.sub_(step * torch.clamp(MAX_ROW_STEP / n.clamp_min(1e-12),
                                         max=1.0))


def _ramp(lr0: float, lr1: float, n_up: int) -> List[float]:
    """The per-update rates lr0 + (lr1 - lr0) * u / n_up, in f32 as the
    JAX scan computes them, as host floats (no device sync per update)."""
    u = np.arange(n_up, dtype=np.float32)
    lr0, lr1 = np.float32(lr0), np.float32(lr1)
    return (lr0 + (lr1 - lr0) * (u / np.float32(n_up))).astype(
        np.float32).tolist()


def _build_epoch(scatter, *, chunk, group, window, neg_shape):
    """The update loop shared by the SGNS and CBOW epochs: `scatter(s0,
    s1, tokens, sent_ids, start, b, negs, g0, g1)` sums one update's
    gradients into the zeroed g0/g1 and returns its (loss, count)."""
    per_update = chunk * group

    def epoch(syn0, syn1neg, tokens, sent_ids, aJ, aq, gen, lr0, lr1):
        """(syn0, syn1neg, per-update loss sums [U], pair counts [U]);
        the tables are updated in place."""
        n_up = max(tokens.shape[0] // per_update, 1)
        g0, g1 = torch.empty_like(syn0), torch.empty_like(syn1neg)
        losses, counts = [], []
        for u, lr in enumerate(_ramp(lr0, lr1, n_up)):
            b, negs = draw_update(gen, u, aJ, aq, chunk=chunk, group=group,
                                  window=window, neg_shape=neg_shape)
            g0.zero_()
            g1.zero_()
            loss, count = scatter(syn0, syn1neg, tokens, sent_ids,
                                  u * per_update, b, negs, g0, g1)
            _trust_region_apply(syn0, g0, lr)
            _trust_region_apply(syn1neg, g1, lr)
            losses.append(loss)
            counts.append(count)
        return syn0, syn1neg, torch.stack(losses), torch.stack(counts)

    return epoch


def make_sgns_epoch(*, window: int, negative: int, chunk: int = 512,
                    group: int = 4, mesh=None, share_negatives: bool = True,
                    neg_oversample: float = 2.0):
    """The SGNS epoch:

    epoch(syn0, syn1neg, tokens, sent_ids, alias_J, alias_q, gen, lr0,
          lr1) -> (syn0, syn1neg, per_update_loss [U], per_update_pairs [U])

    (tokens / sent_ids from pack_corpus, padded to a multiple of
    chunk * group, on the tables' device; alias_J / alias_q from
    build_alias_table over the unigram^0.75 distribution; gen a
    torch.Generator on that device.) One update = `group` chunks of
    `chunk` centers with summed gradients."""
    _refuse_mesh(mesh)
    K = negative
    neg_shape = ((max(int(round(K * neg_oversample)), 1),) if share_negatives
                 else (2 * window, K))

    def scatter(s0, s1, tokens, sent_ids, start, b, negs, g0, g1):
        (centers, grad_c, ctx, grad_pos, negs, grad_neg, loss, pairs
         ) = _chunk_pair_grads(s0, s1, tokens, sent_ids, start, b, negs,
                               window=window, K=K,
                               share_negatives=share_negatives)
        D = s0.shape[1]
        g0.index_add_(0, centers, grad_c)
        g1.index_add_(0, ctx.reshape(-1), grad_pos.reshape(-1, D))
        g1.index_add_(0, negs.reshape(-1), grad_neg.reshape(-1, D))
        return loss, pairs

    return _build_epoch(scatter, chunk=chunk, group=group, window=window,
                        neg_shape=neg_shape)


def make_cbow_epoch(*, window: int, negative: int, chunk: int = 512,
                    group: int = 4, mesh=None):
    """CBOW analogue of make_sgns_epoch (same signature and contract);
    syn0 receives the context rows' gradients, syn1neg the center's and
    the negatives'."""
    _refuse_mesh(mesh)
    K = negative

    def scatter(s0, s1, tokens, sent_ids, start, b, negs, g0, g1):
        (ctx, grad_ctx, centers, grad_tgt, negs, grad_neg, loss, n
         ) = _chunk_cbow_grads(s0, s1, tokens, sent_ids, start, b, negs,
                               window=window, K=K)
        D = s0.shape[1]
        g0.index_add_(0, ctx.reshape(-1), grad_ctx.reshape(-1, D))
        g1.index_add_(0, centers, grad_tgt)
        g1.index_add_(0, negs.reshape(-1), grad_neg.reshape(-1, D))
        return loss, n

    return _build_epoch(scatter, chunk=chunk, group=group, window=window,
                        neg_shape=(K,))
