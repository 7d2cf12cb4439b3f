"""GloVe — global vectors from co-occurrence statistics (JAX counterpart
deeplearning4j_tpu/nlp/glove.py).

Reference: models/glove/Glove.java + AbstractCoOccurrences.java
(co-occurrence counting with 1/distance weighting, shuffled batches,
AdaGrad per-element updates — SURVEY.md §2.3).

Co-occurrence counting stays on the host (dict accumulation over
windows, as the reference spills binary CoOccurrence files); training is
batched weighted least squares on the device — gather rows, compute
f(X)·(w·w̃ + b + b̃ − log X)², AdaGrad scatter updates with
`index_add_`, in place. Within a batch every accumulator update lands
before any row update reads it back, as in the JAX step. Each epoch is a
Python loop of eager launches over the batches of one permutation of the
triples. The permutation is the epoch's one draw: it comes from
`draw_permutation` and a torch.Generator (tests swap in the JAX
package's permutation). With a device mesh (a `parallel.Mesh` with a
"data" axis, or `ops.shard_comm.InProcessShards(n)`;
`parallel.mesh.data_shards`) each batch's triples split over the "data"
shards: every shard computes the gradients of its triples against the
replicated tables, the shards' (row, gradient) pairs are joined in
shard order (all-gathered over the process group) and every shard
applies the whole batch's summed updates — the JAX package's sharded
triples with psum'd scatter-adds. Final vectors are w + w̃ (standard
GloVe practice).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor  # noqa: F401

GLOVE_STATE = ("W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc")


class AbstractCoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/d weighting
    (reference glove/AbstractCoOccurrences.java)."""

    def __init__(self, window_size: int = 15, symmetric: bool = True):
        self.window_size = window_size
        self.symmetric = symmetric
        self.counts: Dict[Tuple[int, int], float] = defaultdict(float)

    def accumulate(self, idx: np.ndarray):
        n = idx.size
        for i in range(n):
            for j in range(max(0, i - self.window_size), i):
                w = 1.0 / (i - j)
                a, b = int(idx[i]), int(idx[j])
                self.counts[(a, b)] += w
                if self.symmetric:
                    self.counts[(b, a)] += w

    def arrays(self):
        if not self.counts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        ij = np.array(list(self.counts.keys()), np.int32)
        x = np.array(list(self.counts.values()), np.float32)
        return ij[:, 0].copy(), ij[:, 1].copy(), x


def _glove_grads(state: dict, i, j, logx, fx):
    """The gradients of a batch of (i, j, log X_ij, f(X_ij)) triples:
    (gwi, gwj, gb, loss). Padded triples carry fx == 0 (and logx == 0),
    so they contribute neither loss nor updates."""
    W, Wc, b, bc = (state[n] for n in GLOVE_STATE[:4])
    wi, wj = W[i], Wc[j]                                  # [B, D]
    diff = (wi * wj).sum(1) + b[i] + bc[j] - logx
    wdiff = fx * diff                                     # [B]
    loss = 0.5 * (wdiff * diff).sum()
    return wdiff[:, None] * wj, wdiff[:, None] * wi, wdiff, loss


def _glove_apply(state: dict, i, j, gwi, gwj, gb, lr):
    """AdaGrad step of a batch's gradients, in place on `state`: the
    accumulators take every triple's squared gradient, then the rows
    move by their gradients scaled by the accumulators read after the
    whole batch has landed."""
    W, Wc, b, bc, hW, hWc, hb, hbc = (state[n] for n in GLOVE_STATE)
    hW.index_add_(0, i, gwi ** 2)
    hWc.index_add_(0, j, gwj ** 2)
    hb.index_add_(0, i, gb ** 2)
    hbc.index_add_(0, j, gb ** 2)
    W.index_add_(0, i, -lr * gwi / torch.sqrt(hW[i] + 1e-8))
    Wc.index_add_(0, j, -lr * gwj / torch.sqrt(hWc[j] + 1e-8))
    b.index_add_(0, i, -lr * gb / torch.sqrt(hb[i] + 1e-8))
    bc.index_add_(0, j, -lr * gb / torch.sqrt(hbc[j] + 1e-8))


def _glove_update(state: dict, i, j, logx, fx, lr):
    """AdaGrad step on a batch of (i, j, log X_ij, f(X_ij)) triples, in
    place on `state` (the GLOVE_STATE tensors); returns the batch loss."""
    gwi, gwj, gb, loss = _glove_grads(state, i, j, logx, fx)
    _glove_apply(state, i, j, gwi, gwj, gb, lr)
    return loss


def _glove_update_sharded(state: dict, split, i, j, logx, fx, lr):
    """`_glove_update` with the batch's triples split over the "data"
    shards of `split` (`parallel.mesh.data_shards`): each shard's
    gradients, the pairs joined in shard order, the whole batch's
    update on every shard; returns the summed loss."""
    n, shards, pg = split
    per = i.shape[0] // n
    parts, loss = [], None
    for s in shards:
        rows = slice(s * per, (s + 1) * per)
        gwi, gwj, gb, ls = _glove_grads(state, i[rows], j[rows],
                                        logx[rows], fx[rows])
        parts.append((gwi, gwj, gb))
        loss = ls if loss is None else loss + ls
    if pg is None:
        gwi, gwj, gb = (torch.cat([p[k] for p in parts]) for k in range(3))
    else:
        import torch.distributed as dist

        mine = parts[0]
        gathered = []
        for t in mine:
            out = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(out, t.contiguous(), group=pg)
            gathered.append(torch.cat(out))
        gwi, gwj, gb = gathered
        dist.all_reduce(loss, group=pg)
    _glove_apply(state, i, j, gwi, gwj, gb, lr)
    return loss


def draw_permutation(gen, n: int, device):
    """The epoch's shuffle of n triples: the one draw of an epoch."""
    return torch.randperm(n, generator=gen, device=device)


def make_glove_epoch(batch: int, shuffle: bool, mesh=None):
    """One full epoch: a permutation of the triples (or none), then one
    AdaGrad step per batch of `batch` triples.

    epoch(state, ii, jj, logx, fx, gen, lr) -> per-batch losses [n]
    (the triples padded to a multiple of `batch`, on the state's
    device; `state` updated in place). With `mesh` each batch's triples
    split over its "data" shards (module docstring); `batch` must
    divide over them."""
    split = None
    if mesh is not None:
        from deeplearning4j_tpu_torch.parallel.mesh import data_shards

        split = data_shards(mesh)
        if batch % split[0]:
            raise ValueError(f"batch={batch} not divisible by mesh data "
                             f"axis size {split[0]}")

    def epoch(state, ii, jj, logx, fx, gen, lr):
        n = ii.shape[0]
        perm = (draw_permutation(gen, n, ii.device) if shuffle
                else torch.arange(n, device=ii.device))
        xs = [a[perm].reshape(-1, batch) for a in (ii, jj, logx, fx)]
        if split is None:
            return torch.stack([_glove_update(state, *(x[s] for x in xs),
                                              lr)
                                for s in range(xs[0].shape[0])])
        return torch.stack([_glove_update_sharded(
            state, split, *(x[s] for x in xs), lr)
            for s in range(xs[0].shape[0])])

    return epoch


def init_glove_state(V: int, D: int, gen, device) -> dict:
    """W, Wc uniform in ±0.5/D from `gen`; zero biases; accumulators at
    1e-8 (the JAX package's init, with torch.Generator bits)."""
    scale = 0.5 / D
    W = (torch.rand(V, D, generator=gen) - 0.5) * 2 * scale
    Wc = (torch.rand(V, D, generator=gen) - 0.5) * 2 * scale
    state = {"W": W, "Wc": Wc, "b": torch.zeros(V), "bc": torch.zeros(V),
             "hW": torch.full((V, D), 1e-8), "hWc": torch.full((V, D), 1e-8),
             "hb": torch.full((V,), 1e-8), "hbc": torch.full((V,), 1e-8)}
    return {n: t.to(device) for n, t in state.items()}


class Glove(SequenceVectors):
    """GloVe trainer with the SequenceVectors query API (similarity,
    words_nearest). Builder mirrors reference Glove.Builder (xMax, alpha,
    shuffle, symmetric)."""

    def __init__(self, layer_size: int = 100, window_size: int = 15,
                 min_word_frequency: int = 1, epochs: int = 25,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 4096,
                 seed: int = 123, symmetric: bool = True, shuffle: bool = True,
                 vocab_limit: Optional[int] = None, device_mesh=None,
                 device=None):
        super().__init__(layer_size=layer_size, window_size=window_size,
                         min_word_frequency=min_word_frequency, epochs=epochs,
                         learning_rate=learning_rate, batch_size=batch_size,
                         seed=seed, negative=0, use_hs=False,
                         vocab_limit=vocab_limit, device_mesh=device_mesh,
                         device=device)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.shuffle = shuffle
        self.use_hs = False  # glove has no output tree
        self.state: Optional[dict] = None
        self.cooccurrence_seconds = 0.0

    def _init_from_vocab(self):
        V = self.vocab.num_words()
        if V == 0:
            raise ValueError("Empty vocabulary")
        self.lookup_table = InMemoryLookupTable(
            V, self.layer_size, seed=self.seed, negative=0,
            device=self.device)

    def _cooccurrences(self, seq_list) -> Tuple[np.ndarray, ...]:
        """Host counting: (i, j, log X_ij, f(X_ij)) over the corpus."""
        cooc = AbstractCoOccurrences(self.window_size, self.symmetric)
        for tokens in seq_list:
            idx = self._sequence_indices(tokens)
            if idx.size:
                cooc.accumulate(idx)
        ii, jj, xx = cooc.arrays()
        if ii.size == 0:
            raise ValueError("No co-occurrences — corpus too small")
        logx = np.log(xx).astype(np.float32)
        fx = np.minimum(1.0, (xx / self.x_max) ** self.alpha).astype(
            np.float32)
        return ii, jj, logx, fx

    def fit(self, sequences, init_state: Optional[dict] = None):
        """Count co-occurrences, then train `epochs` epochs. `init_state`
        (GLOVE_STATE tensors, e.g. weights_io.glove_state_from_jax) sets
        the starting tables instead of the seeded init; `self.state`
        holds the final ones."""
        seq_list = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seq_list)
        V = self.vocab.num_words()
        D = self.layer_size
        dev = self.device

        t0 = time.perf_counter()
        ii, jj, logx, fx = self._cooccurrences(seq_list)
        self.cooccurrence_seconds = time.perf_counter() - t0
        # pad to whole batches ONCE with weight-zero triples (fx == 0 kills
        # both the loss term and every update; logx == 0 keeps diff finite)
        B = self.batch_size
        pad = (-ii.size) % B
        if pad:
            ii = np.concatenate([ii, np.zeros(pad, np.int32)])
            jj = np.concatenate([jj, np.zeros(pad, np.int32)])
            logx = np.concatenate([logx, np.zeros(pad, np.float32)])
            fx = np.concatenate([fx, np.zeros(pad, np.float32)])

        gen = torch.Generator(device=dev).manual_seed(self.seed)
        if init_state is None:
            state = init_glove_state(
                V, D, torch.Generator().manual_seed(self.seed), dev)
        else:
            state = {n: init_state[n].to(dev).clone() for n in GLOVE_STATE}
        epoch_fn = make_glove_epoch(B, self.shuffle, mesh=self.device_mesh)
        ii_d, jj_d = (torch.from_numpy(a).long().to(dev) for a in (ii, jj))
        logx_d, fx_d = (torch.from_numpy(a).to(dev) for a in (logx, fx))
        epoch_losses = [epoch_fn(state, ii_d, jj_d, logx_d, fx_d, gen,
                                 self.learning_rate)
                        for _ in range(self.epochs)]
        # one host fetch for the whole run
        for losses in epoch_losses:
            self.loss_history.extend((losses.cpu().numpy() / B).tolist())
        self.state = state
        self.lookup_table.set_vectors((state["W"] + state["Wc"]).cpu()
                                      .numpy())
        return self

